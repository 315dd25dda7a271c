"""Kernels of the port on the card: each against its plain version.

Marked ``cuda``: they need an NVIDIA card and ``nvcc``, and skip elsewhere
(the decision is made in the fixture, never at import).  Run them on the
machine with the card with ``python -m pytest tests/test_torch_cuda.py``.
Tolerances: the row gather moves bytes, so it compares exactly; so does
the resident-batch kernel, whose crop/flip selects bytes and whose u8/255
is the same IEEE division as its plain version's (its bfloat16 form rounds
that quotient to nearest even, as the plain version does).  The conv
kernel compares with its plain version on float64 copies of the same
inputs, as a share of max|y|: 1e-4 for float32 (K = 9*Cin products summed
in another order), 2^-7 for bfloat16 (the fp32 sum rounded once to
bfloat16, at most half an ulp, plus room for the sums).  Each conv case
also checks that the counter of the route it should take moved, and only
that one.  The serving engine's CUDA graphs compare exactly with the eager
forward at each bucket: the same kernels on the same shapes, TF32 off.
The data-parallel drill on the card against the CPU holds losses, weights,
BN buffers and momentum at 1e-4, as the smoke's parity phase does, and so
does a narrow streaming epoch.  A streamed batch's ``gather_batch`` equals
its plain version bit for bit, and streamed epochs at prefetch depths 0
and 2 equal each other bit for bit under deterministic mode.  The
strategy flags at world 1 over NCCL compare bit for bit, under
deterministic mode, with the same epochs run without a process group.  A
bfloat16 resident epoch on the card against the CPU holds the CPU parity
test's bfloat16 tolerances (``tests/test_torch_bf16.py``): losses 1e-2
relative, each tensor's change 2^-3 of its largest magnitude (cuDNN's and
the CPU's convolutions round to bfloat16 after sums in other orders).
A DeepNN or ResNet-18 training step on the card and on the CPU is each
held against the float64 step at 1e-4 (the CPU's float32 stem gradient
is no closer to it than the card's).
"""
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ddp_tpu_torch import _build, profile_resident
from ddp_tpu_torch.ops.conv_candidates import (TARGET_SHAPES, _flip_transpose,
                                               _shift9_fwd, conv2d_fused,
                                               conv3x3_fused, conv3x3_route)
from ddp_tpu_torch.ops.conv_probe import VGG_CONV_SHAPES
from ddp_tpu_torch.data.device_augment import make_draws
from ddp_tpu_torch.device import set_tf32
from ddp_tpu_torch.models.vgg import VGG
from ddp_tpu_torch.ops.gather import (gather_batch, gather_batch_plain,
                                      gather_rows, gather_rows_plain)
from ddp_tpu_torch.data import EvalLoader, TrainLoader, synthetic
from ddp_tpu_torch.parallel import dist, drill
from ddp_tpu_torch.serve import DynamicBatcher, ServeEngine
from ddp_tpu_torch.optim import SGDConfig, triangular_lr
from ddp_tpu_torch.data.resident import ResidentData
from ddp_tpu_torch.train.epoch import make_train_epoch
from ddp_tpu_torch.train.evaluate import eval_counts
from ddp_tpu_torch.train.step import (_as_input, init_train_state,
                                      make_eval_apply, micro_from_batch,
                                      to_device)
from ddp_tpu_torch.train.trainer import Trainer
from torch_float64 import float64_trajectory, grads64

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "interpreter)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,dtype", [
    ((1000, 32, 32, 3), torch.uint8),
    ((300, 3072), torch.float32),
    ((500, 105), torch.uint8),
    ((500, 3), torch.float32),
    ((64, 2), torch.int16),
])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_row_gather_equals_plain(cuda, shape, dtype, idx_dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    table = (torch.randn(shape, device=cuda, generator=g).to(dtype)
             if dtype.is_floating_point else
             torch.randint(0, 100, shape, device=cuda, generator=g).to(dtype))
    m = shape[0]
    idx = torch.randint(-5, m + 5, (337,), dtype=idx_dtype, device=cuda,
                        generator=g)
    before = gather_rows.launches
    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_plain(table, idx))


def test_row_gather_rejects_what_the_kernel_does_not_take(cuda):
    table = torch.zeros(10, 4, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        gather_rows(table, torch.zeros(3, dtype=torch.int32))  # idx on CPU
    with pytest.raises(ValueError):
        gather_rows(table, torch.zeros(3, dtype=torch.float32, device=cuda))
    with pytest.raises(ValueError):
        gather_rows(table.t(), torch.zeros(3, dtype=torch.int32,
                                           device=cuda))


def _batch_draws(kind, n, g, device):
    """Crop/flip draws of ``kind``: random, the two extremes of the window
    (offset 0 with every image flipped, offset 8 with none), or None (the
    eval form)."""
    if kind == "eval":
        return None
    if kind == "random":
        return make_draws(g, n, device)
    off = 0 if kind == "corner0_flip" else 8
    full = torch.full((n,), off, dtype=torch.int64, device=device)
    return full, full.clone(), torch.full((n,), off == 0, device=device)


@pytest.mark.parametrize("kind", ["random", "corner0_flip", "corner8_noflip",
                                  "eval"])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [512, 336, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_batch_equals_plain(cuda, n, idx_dtype, kind, dtype):
    """Both output forms, exactly, at the main path's N and ragged ones."""
    g = torch.Generator(device=cuda).manual_seed(n)
    m = 1000
    table = torch.randint(0, 256, (m, 32, 32, 3), dtype=torch.uint8,
                          device=cuda, generator=g)
    labels = torch.randint(0, 10, (m,), device=cuda, generator=g)
    idx = torch.randint(-5, m + 5, (n,), dtype=idx_dtype, device=cuda,
                        generator=g)
    draws = _batch_draws(kind, n, g, cuda)
    before = gather_batch.launches, gather_batch.launches_bf16
    images, got_labels = gather_batch(table, labels, idx, draws, dtype=dtype)
    torch.cuda.synchronize()
    assert (gather_batch.launches, gather_batch.launches_bf16) == \
        (before[0] + 1, before[1] + (dtype == torch.bfloat16))
    want_images, want_labels = gather_batch_plain(table, labels, idx, draws,
                                                  dtype=dtype)
    assert images.shape == (n, 32, 32, 3) and images.dtype == dtype
    assert images.permute(0, 3, 1, 2).is_contiguous()
    assert torch.equal(images, want_images)
    assert torch.equal(got_labels, want_labels)


def test_gather_batch_bf16_every_byte_value_and_no_other_dtype(cuda):
    """All 256 byte values through the kernel's bfloat16 table equal the
    float32 quotient rounded to nearest even; a dtype the kernel has no
    form for raises, on the card as on the CPU."""
    ramp = torch.zeros((1, 32, 32, 3), dtype=torch.uint8, device=cuda)
    ramp.view(-1)[:256] = torch.arange(256, device=cuda)
    zero = torch.zeros(1, dtype=torch.int64, device=cuda)
    images, _ = gather_batch(ramp, zero, zero.int(), dtype=torch.bfloat16)
    want = (torch.arange(256, device=cuda).float() / 255.0).to(
        torch.bfloat16)
    assert torch.equal(images.reshape(-1)[:256].view(torch.int16),
                       want.view(torch.int16))
    assert torch.equal(_as_input(ramp, torch.bfloat16),
                       images.permute(0, 3, 1, 2))
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="dtype"):
            gather_batch(ramp, zero, zero.int(), dtype=dtype)


def test_gather_batch_rejects_what_the_kernel_does_not_take(cuda):
    table = torch.zeros((10, 32, 32, 3), dtype=torch.uint8, device=cuda)
    labels = torch.zeros(10, dtype=torch.int64, device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    draws = make_draws(torch.Generator(device=cuda).manual_seed(0), 4, cuda)
    flat = torch.zeros(10 * 3072 + 1, dtype=torch.uint8, device=cuda)
    before = gather_batch.launches
    for args in (
            (table, labels, idx.cpu(), draws),                # idx on the CPU
            (table, labels.cpu(), idx, None),                 # CPU labels
            (table, labels, idx, (draws[0].cpu(),) + draws[1:]),
            (table.float(), labels, idx, None),               # not uint8
            (table[:, :16], labels, idx, None),               # not 32x32
            (table, labels.int(), idx, None),                 # int32 labels
            (table, labels, idx.float(), None),               # float idx
            (table, labels, idx, draws[:2]),                  # two draws
            (table, labels, idx, (draws[0][:3],) + draws[1:]),  # short ys
            (table, labels, idx, draws[:2] + (draws[2].int(),)),
            (flat[1:].view(10, 32, 32, 3), labels, idx, None),  # misaligned
    ):
        with pytest.raises(ValueError):
            gather_batch(*args)
    assert gather_batch.launches == before


CONV_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
# chip_smoke's shapes: the probe's two targets at batch 512 and every VGG
# conv at batch 8 (Cin = 3, H = 4 among them).
CONV_CASES = [(512,) + s[:3] for s in TARGET_SHAPES] + \
    [(8,) + s[:3] for s in VGG_CONV_SHAPES]


# Edge cases of the redesigned routes: a ragged last tile (3 images of 8x8
# in tiles of two), a box across 8 images (4x4), Cout = 64 (narrower than a
# 128-channel tile) and 16x16 128->256; then Cin and Cout that are
# multiples of 8 but not of 64 or 128.
EDGE_CASES = [(3, 8, 256, 512), (8, 4, 512, 512), (4, 16, 128, 64),
              (8, 16, 128, 256), (2, 8, 40, 24), (5, 32, 64, 72)]
ROUTE_OF = {torch.float32: "ffma_f32", torch.bfloat16: "wgmma_bf16"}


def _rel_err(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


def _launch_counted(a, b, route):
    """``conv3x3_fused(a, b)``, checking that exactly one launch was
    counted, on ``route``."""
    before = (conv3x3_fused.launches, dict(conv3x3_fused.route_launches))
    y = conv3x3_fused(a, b)
    torch.cuda.synchronize()
    assert conv3x3_fused.launches == before[0] + 1
    moved = {k: v - before[1][k]
             for k, v in conv3x3_fused.route_launches.items()}
    assert moved == {k: int(k == route) for k in moved}, moved
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CONV_CASES + EDGE_CASES,
                         ids=lambda c: "n{}h{}_{}to{}".format(*c))
def test_conv3x3_fwd_and_dgrad_equal_plain(cuda, case, dtype):
    n, h, cin, cout = case
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((n, h, h, cin), device=cuda, generator=g).to(dtype)
    w = (torch.randn((3, 3, cin, cout), device=cuda, generator=g)
         * math.sqrt(2.0 / (9 * cin))).to(dtype)
    dy = torch.randn((n, h, h, cout), device=cuda, generator=g).to(dtype)
    wt = _flip_transpose(w).contiguous()
    # Every case but VGG's conv0 (Cin = 3) and its dgrad (Cout = 3) takes
    # the dtype's fast route, forward and dgrad.
    route = "general" if cin == 3 else ROUTE_OF[dtype]
    assert conv3x3_route(n, h, h, cin, cout, dtype) == route
    assert conv3x3_route(n, h, h, cout, cin, dtype) == route
    y = _launch_counted(x, w, route)
    dx = _launch_counted(dy, wt, route)
    assert y.dtype == dx.dtype == dtype and y.is_contiguous()
    assert _rel_err(y, _shift9_fwd(x.double(), w.double())) <= CONV_TOL[dtype]
    assert _rel_err(dx, _shift9_fwd(dy.double(), wt.double())) <= \
        CONV_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_conv3x3_unaligned_input_takes_the_general_route(cuda, dtype):
    """x starting 2 bytes past a 16-byte boundary: neither TMA nor
    cp.async takes it, so the general kernel runs, and agrees."""
    g = torch.Generator(device=cuda).manual_seed(2)
    n, h, cin, cout = 2, 8, 64, 128
    flat = torch.randn(n * h * h * cin + 1, device=cuda,
                       generator=g).to(dtype)
    x = flat[1:].view(n, h, h, cin)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    w = (torch.randn((3, 3, cin, cout), device=cuda, generator=g)
         * 0.05).to(dtype)
    y = _launch_counted(x, w, "general")
    assert _rel_err(y, _shift9_fwd(x.double(), w.double())) <= CONV_TOL[dtype]


def test_conv3x3_library_runs_on_the_tensor_cores(cuda):
    """The built library's SASS holds HGMMA (wgmma) instructions."""
    _build.build_all()
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    sass = subprocess.run(
        [os.path.join(home, "bin", "cuobjdump"), "-sass",
         _build.library_path("conv3x3")], capture_output=True, text=True,
        check=True).stdout
    assert "HGMMA" in sass


def test_conv2d_fused_autograd_equals_plain(cuda):
    """y, dx and dw of the fused candidate (dgrad through the kernel)
    against autograd of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((4, 8, 8, 16), device=cuda, generator=g)
    w = torch.randn((3, 3, 16, 32), device=cuda, generator=g) * 0.1
    outs = []
    for conv in (conv2d_fused, _shift9_fwd):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = conv(xg, wg)
        outs.append((y.detach(),) + torch.autograd.grad(y.sin().sum(),
                                                        (xg, wg)))
    before = conv3x3_fused.launches
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    torch.autograd.grad(conv2d_fused(xg, wg).sum(), (xg, wg))
    assert conv3x3_fused.launches == before + 2  # forward and dgrad
    for got, want in zip(*outs):
        assert _rel_err(got, want.double()) <= 1e-4


def test_conv3x3_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 4, 4, 8), device=cuda)
    w = torch.zeros((3, 3, 8, 16), device=cuda)
    before = conv3x3_fused.launches
    with pytest.raises(ValueError):
        conv3x3_fused(x, w.cpu())  # w on the CPU
    with pytest.raises(ValueError):
        conv3x3_fused(x.permute(0, 2, 1, 3), w)  # a non-contiguous x
    with pytest.raises(ValueError):
        conv3x3_fused(x.half(), w.half())  # a dtype the kernel lacks
    with pytest.raises(ValueError):
        conv3x3_fused(x, w.bfloat16())  # mixed dtypes
    with pytest.raises(ValueError):
        conv3x3_fused(x, torch.zeros((3, 3, 4, 16), device=cuda))  # Cin
    assert conv3x3_fused.launches == before


def test_as_input_of_uint8_equals_gather_batch_bitwise(cuda):
    """Every byte value: ``_as_input`` divides as the kernel does, so a
    uint8 batch fed to the eval forward gets the kernel's bits."""
    ramp = torch.zeros((1, 32, 32, 3), dtype=torch.uint8, device=cuda)
    ramp.view(-1)[:256] = torch.arange(256, device=cuda)
    want, _ = gather_batch(ramp, torch.zeros(1, dtype=torch.int64,
                                             device=cuda),
                           torch.zeros(1, dtype=torch.int32, device=cuda))
    got = _as_input(ramp)
    assert got.is_contiguous() and got.dtype == torch.float32
    assert torch.equal(got, want.permute(0, 3, 1, 2))


NARROW = [8, "M", 16, "M", 512, "M"]


def test_serve_graphs_equal_eager_forward_and_count(cuda):
    """One graph captured per bucket (the wrapper counted at the eager
    warm-up and at capture), each replay equal bit for bit to the eager
    gather_batch + eval forward at that shape, one gather_batch_kernel per
    replay and no call of the wrapper, and the engine's forwards by bucket
    (each one replay) equal to the batches run."""
    set_tf32(False)
    model = VGG(NARROW, generator=torch.Generator().manual_seed(0))
    engine = ServeEngine(model, device=cuda, buckets=(1, 8, 32))
    before = gather_batch.launches
    assert engine.warm() == 3 == engine.stats()["compiled_executables"]
    assert gather_batch.launches == before + 6
    rng = np.random.default_rng(0)
    apply_fn = make_eval_apply(engine.model)
    for b in engine.buckets:
        x = rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
        table = torch.from_numpy(x).to(cuda)
        images, _ = gather_batch(
            table, torch.zeros(b, dtype=torch.int64, device=cuda),
            torch.arange(b, dtype=torch.int32, device=cuda))
        want = apply_fn(images).cpu().numpy()
        np.testing.assert_array_equal(engine.forward(x), want)
        # Fewer rows than the bucket: zero-padded, the same valid rows.
        if b > 1:
            np.testing.assert_array_equal(engine.forward(x[:b - 1]),
                                          want[:b - 1])
    launches = gather_batch.launches
    assert engine.stats()["forward_batches_per_bucket"] == {
        "1": 1, "8": 2, "32": 2}
    x = rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # The profiler can miss the start of a session: a lead-in forward.
        engine.forward(x)
        time.sleep(0.05)
        engine.forward(x)
        torch.cuda.synchronize()
    # The last forward's device records: from after the copy out before it
    # up to and with its own.
    timeline = sorted((e.time_range.start, e.name) for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
    cuts = [i for i, (_, name) in enumerate(timeline)
            if name.startswith("Memcpy DtoH")]
    last = [name for _, name in
            timeline[(cuts[-2] + 1 if len(cuts) > 1 else 0):cuts[-1] + 1]]
    assert last[0].startswith("Memcpy HtoD")
    assert sum("gather_batch_kernel" in name for name in last) == 1
    assert gather_batch.launches == launches
    batcher = DynamicBatcher(engine, max_wait_ms=1.0).start()
    try:
        for n in (1, 3, 8, 9, 17, 32):
            batcher.submit(rng.integers(0, 256, (n, 32, 32, 3),
                                        dtype=np.uint8), timeout=30)
    finally:
        assert batcher.drain(timeout=30)
    assert engine.stats()["forward_batches"] == 7 + batcher.batches
    assert engine.trace_count == 3 and gather_batch.launches == launches


def _drill_spec(device, backend=None):
    train, test = synthetic(n_train=40, n_test=24, seed=1)
    model = VGG(NARROW, generator=torch.Generator().manual_seed(0))
    return drill.spec(NARROW, model.state_dict(), train, test, batch=8,
                      lr=0.05, seed=0, augment=True, device=device,
                      backend=backend)


def test_world1_nccl_runs_the_all_reduces(cuda):
    """multigpu's path on a one-card machine: rank 0 of a world-1 NCCL
    group issues every collective (two a step, the loss sum, the eval
    counters, the start's broadcast) and one gather_batch a step."""
    got, = drill.run(_drill_spec("cuda"), 1, timeout=300)
    assert (got["backend"], got["device"], got["steps"]) == \
        ("nccl", "cuda:0", 5)
    assert got["collectives"] == {"all_reduce": 2 * 5 + 2, "broadcast": 1}
    assert (got["train_launches"], got["eval_launches"]) == (5, 3)
    assert torch.isfinite(got["losses"]).all()


def test_world2_gloo_on_one_card_equals_cpu(cuda):
    """Two ranks on the one card over gloo against two on the CPU, from the
    same weights and crop/flip draws: 1e-4, the card-against-CPU parity
    tolerance (cuDNN and the CPU sum in other orders)."""
    card = drill.run(_drill_spec("cuda", "gloo"), 2, same_device=True,
                     timeout=300)
    cpu = drill.run(_drill_spec("cpu"), 2, timeout=300)
    for got, want in zip(card, cpu):
        assert (got["backend"], got["device"]) == ("gloo", "cuda:0")
        assert (got["train_launches"], got["eval_launches"]) == (3, 2)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4,
                                   atol=1e-4)
        for k, v in want["state_dict"].items():
            np.testing.assert_allclose(got["state_dict"][k], v, rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        for a, b in zip(got["momentum"], want["momentum"]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


_STRATEGY_WORKER = r'''
import sys
import torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.use_deterministic_algorithms(True)
from ddp_tpu_torch.data import ResidentData, synthetic
from ddp_tpu_torch.device import set_tf32
from ddp_tpu_torch.models.vgg import VGG
from ddp_tpu_torch.ops.gather import gather_batch
from ddp_tpu_torch.optim import SGDConfig
from ddp_tpu_torch.parallel import dist
from ddp_tpu_torch.train.epoch import make_train_epoch
from ddp_tpu_torch.train.step import init_train_state
from ddp_tpu_torch.train.zero import list_to_opt_shard, opt_shard_to_list

set_tf32(False)
arch = [8, "M", 16, "M", 512, "M"]
start = VGG(arch, generator=torch.Generator().manual_seed(0)).state_dict()
train, _ = synthetic(n_train=32, n_test=8, seed=1)
dev = torch.device("cuda")
res = ResidentData(train, dev)
groups = torch.arange(32, dtype=torch.int32, device=dev).view(2, 2, 8)


def epoch(accum, zero):
    model = VGG(arch)
    model.load_state_dict(start)
    model.to(dev)
    state = init_train_state(model)
    if zero:
        state.momentum = list_to_opt_shard(state.momentum)
    run = make_train_epoch(model, SGDConfig(lr=0.05), lambda s: 0.05,
                           shard_update=zero)
    launches = gather_batch.launches
    losses = run(state, res.images, res.labels,
                 groups if accum == 2 else groups.view(4, 8))
    momentum = (opt_shard_to_list(list(model.parameters()), state.momentum)
                if zero else state.momentum)
    return {"losses": losses.cpu(), "launches": gather_batch.launches
            - launches, "state": {k: v.cpu() for k, v in
                                  model.state_dict().items()},
            "momentum": [m.cpu() for m in momentum]}


cases = {"plain": (1, False), "accum": (2, False), "zero": (1, True)}
out = {f"nogroup/{k}": epoch(*v) for k, v in cases.items()}
dist.initialize(dev)
try:
    out["backend"] = dist.backend()
    out.update({f"nccl/{k}": epoch(*v) for k, v in cases.items()})
    out["collectives"] = dict(dist.collective_calls)
finally:
    dist.shutdown()
torch.save(out, sys.argv[1])
'''


def test_strategy_flags_world1_nccl_equal_no_group(cuda, tmp_path):
    """``--grad_accum 2`` and ``--shard_update`` at world 1 over NCCL,
    under deterministic mode, against the same epochs without a process
    group (whose collectives are the identity): bit for bit, and the
    sharded update bit for bit the replicated one.  ``gather_batch``
    launches once per micro-batch (4 of 8 images in each epoch)."""
    path = tmp_path / "out.pt"
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    assert dist.launch_local([sys.executable, "-c", _STRATEGY_WORKER,
                              str(path)], 1, env=env, timeout=300) == 0
    out = torch.load(path, weights_only=True)
    assert out["backend"] == "nccl"
    # accum: 2 steps of 2 micro-batches; plain and zero: 4 steps each.
    assert out["collectives"] == {"all_reduce": 2 * 2 + 2 * 4 + 4,
                                  "reduce_scatter": 4, "all_gather": 5}
    for case in ("plain", "accum", "zero"):
        a, b = out[f"nogroup/{case}"], out[f"nccl/{case}"]
        assert a["launches"] == b["launches"] == 4
        assert torch.equal(a["losses"], b["losses"]), case
        assert all(torch.equal(v, b["state"][k])
                   for k, v in a["state"].items()), case
        assert all(torch.equal(x, y)
                   for x, y in zip(a["momentum"], b["momentum"])), case
    plain, zero = out["nccl/plain"], out["nccl/zero"]
    assert torch.equal(plain["losses"], zero["losses"])
    assert all(torch.equal(v, zero["state"][k])
               for k, v in plain["state"].items())
    assert all(torch.equal(x, y)
               for x, y in zip(plain["momentum"], zero["momentum"]))


def test_profile_resident_data_parallel_sees_the_collectives(cuda):
    """``profile_resident --data_parallel``: the steps run as rank 0 of a
    world-1 NCCL group, one gather_batch_kernel a step, and the rendezvous
    is taken out of the environment again."""
    summary = profile_resident.main(["--steps", "2", "--warmup", "1",
                                     "--data_parallel"])
    assert summary["backend"] == "nccl"
    assert summary["gather_batch_kernel_launches"] == 2
    assert "RANK" not in os.environ


def test_bf16_serve_graphs_equal_eager_forward(cuda):
    """The serving engine in bfloat16: one graph a bucket, each replay
    equal bit for bit to the eager bfloat16 forward, the dtype reported."""
    set_tf32(False)
    model = VGG(NARROW, generator=torch.Generator().manual_seed(0))
    engine = ServeEngine(model, device=cuda, buckets=(1, 8),
                         compute_dtype=torch.bfloat16)
    assert engine.warm() == 2
    assert engine.stats()["compute_dtype"] == "bfloat16"
    apply_fn = make_eval_apply(engine.model, torch.bfloat16)
    rng = np.random.default_rng(1)
    for b in engine.buckets:
        x = rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
        images, _ = gather_batch(
            torch.from_numpy(x).to(cuda),
            torch.zeros(b, dtype=torch.int64, device=cuda),
            torch.arange(b, dtype=torch.int32, device=cuda),
            dtype=torch.bfloat16)
        want = apply_fn(images).cpu().numpy()
        assert want.dtype == np.float32
        np.testing.assert_array_equal(engine.forward(x), want)


def test_bf16_resident_steps_on_card_equal_cpu(cuda):
    """Three bfloat16 resident steps (two batches of 8 and the ragged 4) of
    a narrow VGG, crop/flip from the same draws, on the card (the kernel's
    bfloat16 form) against the CPU (its plain version)."""
    set_tf32(False)
    ds, _ = synthetic(n_train=20, n_test=8, seed=1)
    rng = np.random.default_rng(0)
    draws_np = [(rng.integers(0, 9, (2, n)), rng.random(n) < 0.5)
                for n in (8, 8, 4)]
    rows = [np.arange(16, dtype=np.int32).reshape(2, 8),
            np.arange(16, 20, dtype=np.int32)[None]]
    start = VGG(NARROW, generator=torch.Generator().manual_seed(0))
    sched = lambda s: triangular_lr(s, base_lr=0.05, num_epochs=1,
                                    steps_per_epoch=3)
    out = {}
    for device in (cuda, torch.device("cpu")):
        model = VGG(NARROW)
        model.load_state_dict(start.state_dict())
        model.to(device)
        res = ResidentData(ds, device)
        state = init_train_state(model)
        run = make_train_epoch(model, SGDConfig(lr=0.05), sched,
                               device_augment=True,
                               compute_dtype=torch.bfloat16)

        def draws(step, n, micro=0, device=device):
            off, flip = draws_np[step]
            off = torch.from_numpy(off).to(device)
            return off[0], off[1], torch.from_numpy(flip).to(device)

        before = gather_batch.launches
        losses = torch.cat([run(state, res.images, res.labels,
                                torch.from_numpy(r).to(device), draws)
                            for r in rows])
        out[device.type] = (losses.cpu(), {k: v.cpu() for k, v in
                                           model.state_dict().items()},
                            gather_batch.launches - before)
    (lg, sg, ng), (lc, sc, nc) = out["cuda"], out["cpu"]
    assert (ng, nc) == (3, 0)
    assert torch.isfinite(lg).all()
    assert float(((lg - lc).abs() / lc.abs()).max()) <= 1e-2
    sd0 = start.state_dict()
    for k, v in sc.items():
        if k.endswith("num_batches_tracked"):
            continue
        want = v.double() - sd0[k].double()
        got = sg[k].double() - sd0[k].double()
        assert float((got - want).abs().max()) <= \
            2.0 ** -3 * float(want.abs().max()), k


# The streaming path: host batches copied on a side stream.


@pytest.mark.parametrize("device_augment", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_batch_gather_equals_plain(cuda, dtype, device_augment):
    """A host-augmented streamed batch (the ragged 336 rows of a 50,000-row
    epoch's last batch shape, and 512), copied by ``to_device`` on a side
    stream, through ``micro_from_batch``: the kernel's images and labels
    bit for bit against the plain version on the host copy, one launch
    each."""
    train, _ = synthetic(n_train=848, n_test=8, seed=2)
    loader = TrainLoader(train, 512, seed=0, augment=True,
                         local_replicas=[0])
    loader.set_epoch(0)
    copy = torch.cuda.Stream(cuda)
    get = micro_from_batch(device_augment, dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for k in (0, 1):
        host = loader.materialize(k)
        n = len(host["label"])
        draws = make_draws(gen, n, cuda)
        batch = to_device(host, cuda, stream=copy).wait()
        launches = gather_batch.launches
        x, y = get(lambda m: draws, batch)
        assert gather_batch.launches == launches + 1
        want_x, want_y = gather_batch_plain(
            torch.from_numpy(host["image"]), torch.from_numpy(host["label"]),
            torch.arange(n), tuple(d.cpu() for d in draws)
            if device_augment else None, dtype=dtype)
        torch.cuda.synchronize()
        assert x.dtype == dtype and torch.equal(x.cpu(), want_x)
        assert torch.equal(y.cpu(), want_y)


def _streaming_run(device, params_from, train, *, batch=64, seed=0, lr=0.02,
                   depth=2, epochs=1):
    model = VGG(NARROW)
    model.load_state_dict(params_from)
    model.to(device)
    loader = TrainLoader(train, batch, seed=seed, augment=True,
                         local_replicas=[0])
    sched = lambda s: triangular_lr(  # noqa: E731
        s, base_lr=lr, num_epochs=epochs, steps_per_epoch=len(loader))
    tr = Trainer(model, loader, device=device, lr_schedule=sched,
                 sgd_config=SGDConfig(lr=lr), seed=seed, snapshot_path=None,
                 resident=False, prefetch_depth=depth)
    launches = gather_batch.launches
    tr.train(epochs)
    return tr, model, gather_batch.launches - launches


def _float64_streamed(start, train, *, batch, seed, lr):
    """The float64 epoch (``tests/torch_float64.py``) over the host batches
    :func:`_streaming_run` takes, with each step's margins."""
    loader = TrainLoader(train, batch, seed=seed, augment=True)
    loader.set_epoch(0)
    return float64_trajectory(start, [list(loader)], lambda s: triangular_lr(
        s, base_lr=lr, num_epochs=1, steps_per_epoch=len(loader)))


KINK_MARGIN = 1e-6  # as chip_smoke.py's strategy phase requires


def test_streaming_epoch_on_card_equals_cpu(cuda):
    """A narrow streaming epoch at the CLI's lr 0.05 (host crop/flip, the
    prefetch pool, copies on a side stream, one ``gather_batch`` a step) on
    the card against the same epoch on the CPU: losses, weights, BN buffers
    and momentum within 1e-4; then the streaming eval's counters.  64
    images in batches of 16, seed 1: first the float64 epoch on the same
    batches must keep every ReLU input and every max-pool window's top two
    inputs at least ``KINK_MARGIN`` apart at every step, or a float32 run
    may take either side of that decision and move one element's gradient
    whole (``tests/stream_parity_probe.py`` shows it on the next test's
    data)."""
    set_tf32(False)
    train, test = synthetic(n_train=64, n_test=100, seed=1)
    start = VGG(NARROW, generator=torch.Generator().manual_seed(1)
                ).state_dict()
    *_, margins = _float64_streamed(start, train, batch=16, seed=1, lr=0.05)
    assert min(min(m) for m in margins) >= KINK_MARGIN, margins
    kw = dict(batch=16, seed=1, lr=0.05)
    card, card_model, launches = _streaming_run(cuda, start, train, **kw)
    cpu, cpu_model, _ = _streaming_run(torch.device("cpu"), start, train,
                                       **kw)
    assert launches == len(card.loss_history) == 4
    np.testing.assert_allclose(card.loss_history, cpu.loss_history,
                               rtol=1e-4, atol=1e-4)
    for k, v in cpu_model.state_dict().items():
        np.testing.assert_allclose(card_model.state_dict()[k].cpu(), v,
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for a, b in zip(card.state.momentum, cpu.state.momentum):
        np.testing.assert_allclose(a.cpu(), b, rtol=1e-4, atol=1e-4)
    launches = gather_batch.launches
    got = eval_counts(card_model, EvalLoader(test, 64, local_replicas=[0]))
    assert gather_batch.launches == launches + 2
    want = eval_counts(cpu_model, EvalLoader(test, 64, local_replicas=[0]))
    assert float(got[1]) == float(want[1]) == 100.0
    assert abs(float(got[0]) - float(want[0])) <= 1


def test_streaming_epoch_at_lr_005_card_and_cpu_against_float64(cuda):
    """10 steps of 64 on 600 images at lr 0.05: here the float64 epoch
    passes within 2e-9 of a ReLU kink and 2e-8 of a max-pool tie, so the
    card's and the CPU's float32 epochs part by more than 1e-4 (and two
    card runs from each other).  The float64 epoch on the same host batches
    is the referee: each float32 run's distance from it (the largest over
    losses, weights, BN buffers and momentum) is printed, and the card's is
    at most twice the CPU's.  A step fed a wrong or half-copied batch would
    move the card's by the size of a whole batch's gradient."""
    set_tf32(False)
    train, _ = synthetic(n_train=600, n_test=100, seed=1)
    start = VGG(NARROW, generator=torch.Generator().manual_seed(0)
                ).state_dict()
    runs = {d: _streaming_run(torch.device(d), start, train, lr=0.05)
            for d in ("cuda", "cpu")}
    flosses, fstate, fmom, _ = _float64_streamed(start, train, batch=64,
                                                 seed=0, lr=0.05)

    def far(tr, model):
        sd = model.state_dict()
        errs = [float(np.abs(np.array(tr.loss_history) - flosses).max())]
        errs += [float((sd[k].cpu().double() - v).abs().max())
                 for k, v in fstate.items()
                 if not k.endswith("num_batches_tracked")]
        errs += [float((a.cpu().double() - b).abs().max())
                 for a, b in zip(tr.state.momentum, fmom)]
        return max(errs)

    card, cpu = (far(*runs[d][:2]) for d in ("cuda", "cpu"))
    between = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        runs["cuda"][1].state_dict().values(),
        runs["cpu"][1].state_dict().values()))
    print(f"lr 0.05 streamed epoch against float64: card {card:.3e}, CPU "
          f"{cpu:.3e}; card against CPU (weights, buffers) {between:.3e}")
    assert card <= 2 * cpu


_DEPTH_WORKER = r'''
import sys
import torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.use_deterministic_algorithms(True)
from ddp_tpu_torch.data import TrainLoader, synthetic
from ddp_tpu_torch.device import set_tf32
from ddp_tpu_torch.models.vgg import VGG
from ddp_tpu_torch.optim import SGDConfig
from ddp_tpu_torch.train.trainer import Trainer

set_tf32(False)
arch = [64, "M", 128, "M", 512, "M"]
start = VGG(arch, generator=torch.Generator().manual_seed(0)).state_dict()
train, _ = synthetic(n_train=2100, n_test=8, seed=1)
dev = torch.device("cuda")
out = {}
for depth, workers in ((0, 1), (2, 4), (2, 1)):
    model = VGG(arch)
    model.load_state_dict(start)
    model.to(dev)
    loader = TrainLoader(train, 256, seed=0, augment=True, local_replicas=[0])
    tr = Trainer(model, loader, device=dev, lr_schedule=lambda s: 0.02,
                 sgd_config=SGDConfig(lr=0.02), seed=0, snapshot_path=None,
                 resident=False, prefetch_depth=depth,
                 prefetch_workers=workers)
    tr.train(2)
    out[f"{depth}/{workers}"] = {
        "losses": tr.loss_history,
        "state": {k: v.cpu() for k, v in model.state_dict().items()}}
torch.save(out, sys.argv[1])
'''


def test_streaming_depths_bit_equal_in_deterministic_mode(cuda, tmp_path):
    """The copy stream's ordering: in deterministic mode, two streamed
    epochs at prefetch depth 0 (each batch copied and consumed in turn) and
    at depth 2 with 4 and 1 workers (copies enqueued ahead on the side
    stream) give the same losses and weights bit for bit.  A missing wait
    on the copy, or a buffer reused under a running step, would feed a step
    a half-copied batch."""
    path = tmp_path / "out.pt"
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    r = subprocess.run([sys.executable, "-c", _DEPTH_WORKER, str(path)],
                       env=env, timeout=300)
    assert r.returncode == 0
    out = torch.load(path, weights_only=True)
    ref = out["0/1"]
    assert len(ref["losses"]) == 2 * 9  # 8 batches of 256 and 52
    for key in ("2/4", "2/1"):
        assert out[key]["losses"] == ref["losses"], key
        for k, v in ref["state"].items():
            assert torch.equal(out[key]["state"][k], v), (key, k)


# One image of DeepNN and eight of ResNet-18, at the first three data seeds
# from 1 whose float64 forward keeps every ReLU input and max-pool gap at
# least 1e-6 from flipping (``drill.Margins``; DeepNN's some 220,000 ReLU
# inputs an image leave no larger batch that does): (model, images, data
# seed).
MODEL_STEPS = [("deepnn", 1, 16), ("deepnn", 1, 22), ("deepnn", 1, 32),
               ("resnet18", 8, 1), ("resnet18", 8, 5), ("resnet18", 8, 7)]


@pytest.mark.parametrize("name,n,data_seed", MODEL_STEPS)
def test_model_step_on_card_equals_cpu(cuda, name, n, data_seed):
    """One training step's loss and gradients of each model at full width
    on the card and on the CPU, from the same weights, images and dropout
    mask (drawn from a CPU generator, so the same on both), TF32 off, each
    held against the float64 step (``tests/torch_float64.py::grads64``,
    written apart from the port) at 1e-4, the card-against-CPU parity
    tolerance, after the float64 forward shows its decisions at least 1e-6
    from flipping.  The float64 step is the referee: ResNet-18's float32
    stem gradient on the CPU lies 6e-5 to 9e-5 from it on these batches,
    so the card is not held to the CPU's rounding (both distances
    printed)."""
    from ddp_tpu_torch.models import get_model
    from ddp_tpu_torch.ops.layers import keep_mask
    from ddp_tpu_torch.train.step import make_local_grads
    set_tf32(False)
    train, _ = synthetic(n_train=n, n_test=8, seed=data_seed)
    start = get_model(name, generator=torch.Generator().manual_seed(0))
    m64 = get_model(name).double().train()
    m64.load_state_dict(start.state_dict())
    seen = drill.Margins()
    with torch.no_grad(), seen:
        m64(_as_input(torch.from_numpy(train.images)).double(),
            generator=torch.Generator().manual_seed(1))
    assert min(seen.kink, seen.gap) >= 1e-6, (seen.kink, seen.gap)
    mask = keep_mask((n, 512), 0.9, torch.Generator().manual_seed(1),
                     "cpu") if name == "deepnn" else None
    ref_loss, ref = grads64(name, start.state_dict(), train.images,
                            train.labels, mask)
    names = [k for k, _ in start.named_parameters()]
    far = {}
    for device in ("cpu", "cuda"):
        model = get_model(name).to(device)
        model.load_state_dict(start.state_dict())
        loss, grads = make_local_grads(model)(
            torch.from_numpy(train.images).to(device),
            torch.from_numpy(train.labels).long().to(device),
            torch.Generator().manual_seed(1))
        grads = [g.cpu().double() for g in grads]
        far[device] = max((float((g - ref[k]).abs().max()), k)
                          for k, g in zip(names, grads))
        for k, g in zip(names, grads):
            np.testing.assert_allclose(g, ref[k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{device} {k}")
        assert float(loss) == pytest.approx(ref_loss, rel=1e-4,
                                            abs=1e-4), device
    print(f"{name} data seed {data_seed}: gradients from float64, card "
          f"{far['cuda'][0]:.3e} at {far['cuda'][1]}, CPU "
          f"{far['cpu'][0]:.3e} at {far['cpu'][1]}")


def test_dropout_stream_repeats_on_the_card(cuda):
    """The trainer's dropout generator on the card: one seed, step and
    micro-batch give the same mask and the same DeepNN training logits bit
    for bit; another micro-batch another mask; about 9 in 10 kept."""
    from ddp_tpu_torch.models import get_model
    from ddp_tpu_torch.ops.layers import keep_mask
    set_tf32(False)
    train, _ = synthetic(n_train=64, n_test=8, seed=1)
    trainer = Trainer(get_model("deepnn", device=cuda),
                      TrainLoader(train, 64, seed=0), device=cuda,
                      lr_schedule=lambda s: 0.0, seed=7,
                      snapshot_path=None)
    a = keep_mask((512, 512), 0.9, trainer.dropout(3, 1), cuda)
    b = keep_mask((512, 512), 0.9, trainer.dropout(3, 1), cuda)
    c = keep_mask((512, 512), 0.9, trainer.dropout(3, 0), cuda)
    assert a.device.type == "cuda" and torch.equal(a, b)
    assert not torch.equal(a, c) and 0.89 < float(a.float().mean()) < 0.91
    model = trainer.state.model.train()
    x = _as_input(torch.from_numpy(train.images).to(cuda))
    with torch.no_grad():
        first = model(x, generator=trainer.dropout(5))
        again = model(x, generator=trainer.dropout(5))
    assert torch.equal(first, again)


@pytest.mark.parametrize("name", ["deepnn", "resnet18"])
def test_model_serve_graphs_equal_eager_forward(cuda, name):
    """Each model's serving graphs, one per bucket, equal the eager
    gather_batch + eval forward at that shape bit for bit, in float32 and
    bfloat16."""
    from ddp_tpu_torch.models import get_model
    set_tf32(False)
    model = get_model(name, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    for dtype in (None, torch.bfloat16):
        engine = ServeEngine(model, device=cuda, buckets=(1, 8, 32),
                             compute_dtype=dtype)
        assert engine.warm() == 3
        apply_fn = make_eval_apply(engine.model, dtype)
        for b in engine.buckets:
            x = rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
            images, _ = gather_batch(
                torch.from_numpy(x).to(cuda),
                torch.zeros(b, dtype=torch.int64, device=cuda),
                torch.arange(b, dtype=torch.int32, device=cuda),
                dtype=dtype or torch.float32)
            np.testing.assert_array_equal(engine.forward(x),
                                          apply_fn(images).cpu().numpy())


def test_bench_line_on_the_card(cuda, capsys, tmp_path):
    """``python -m ddp_tpu_torch.bench`` on the card: one stdout line with
    every field, the card's name and power limit, an MFU in (0, 1.05]
    against the data sheet's peak for the dtype, and one ``gather_batch``
    launch a train step."""
    import json

    from ddp_tpu_torch import bench
    from ddp_tpu_torch.obs.live import PEAK_TFLOPS
    set_tf32(False)
    path = tmp_path / "bench.json"
    summary = bench.main(["--model", "deepnn", "--steps", "5", "--warmup",
                          "2", "--repeats", "2", "--primary_only",
                          "--result_json", str(path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    f32, bf16 = (json.loads(lines[0]), summary["records"][1])
    for rec, dtype in ((f32, "float32"), (bf16, "bfloat16")):
        assert tuple(rec) == bench.RECORD_FIELDS
        assert rec["device"] == {"name": torch.cuda.get_device_name(0),
                                 "count": 1}
        assert rec["power_limit_w"] > 0
        assert 0 < rec["mfu"] <= 1.05 and rec["value"] > 0
        assert rec["mfu_peak_source"] == (
            "datasheet" if rec["device"]["name"] in PEAK_TFLOPS
            else "probed")
    assert summary["steps"] == {"float32": 12, "bfloat16": 12}
    assert summary["launches"] == {"gather_batch": 24,
                                   "gather_batch_bf16": 12}


def test_live_records_time_the_card_steps(cuda, tmp_path):
    """On the card a streamed run's ``live`` records time each step by
    CUDA events: each record's median step is the median of its window of
    the run's own event times (``step_ms``), not the host loop's enqueue
    time."""
    import json
    import statistics

    from ddp_tpu_torch import cli
    set_tf32(False)
    metrics = tmp_path / "m.jsonl"
    out = cli.main(["2", "1", "--batch_size", "64", "--synthetic",
                    "--synthetic_size", "640", "--metrics_path",
                    str(metrics), "--log_every", "3", "--snapshot_path",
                    str(tmp_path / "c.pt")])
    lives = [r for r in map(json.loads, metrics.read_text().splitlines())
             if r.get("event") == "live"]
    assert [r["step"] for r in lives] == list(range(2, 20, 3))
    assert len(out["step_ms"]) == 20
    for r in lives:
        own = statistics.median(out["step_ms"][max(r["step"] - 99, 0):
                                               r["step"] + 1])
        assert r["step_ms_median"] == pytest.approx(own, abs=1e-3)
        assert r["mfu"] > 0
