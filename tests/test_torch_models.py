"""DeepNN and ResNet-18 in the port (``ddp_tpu_torch/models/deepnn.py``,
``models/resnet.py``) against ``ddp_tpu.models`` at full width, with the
same weights (mapped by ``ddp_tpu_torch.interop``) and the same seeded
numpy images, on the CPU; the dropout op, the initialisers, every interop
mapping, the checkpoint by model, and the buffer average of a model without
buffers.

Tolerances:
- float32 logits and new BatchNorm statistics: rtol/atol 1e-4,
  the VGG tests' bound (convolutions whose sums XLA and PyTorch take in
  other orders; ``-s`` prints the measured errors);
- DeepNN in training runs with the mask JAX drew for the same key, passed
  in (torch's stream is not JAX's threefry);
- gradients: the port within 1e-4 of a float64 gradient written apart
  from both packages (``tests/torch_float64.py``), and of JAX within JAX's
  own distance from it plus 1e-4;
- ``--bf16`` logits within 2^-5 of max|logit|, ``tests/test_torch_bf16.py``'s
  whole-model bound (ResNet-18 in training 2^-3, its step bound; see the
  test);
- the dropout op with a given mask, and every interop and checkpoint
  mapping: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.models import get_model as jget_model
from ddp_tpu.ops import layers as jlayers
from ddp_tpu.ops.losses import cross_entropy_sum_count
from ddp_tpu.optim.sgd import SGDState
from ddp_tpu.train import checkpoint as jckpt
from ddp_tpu.train.step import _as_input as jax_as_input
from ddp_tpu.utils import torch_interop as jinterop
from ddp_tpu_torch import interop
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.ops import initializers as init_lib
from ddp_tpu_torch.ops import layers as tlayers
from ddp_tpu_torch.parallel import dist
from ddp_tpu_torch.train import checkpoint as tckpt
from ddp_tpu_torch.train import step as tstep

import torch_float64 as f64

MODELS = ["deepnn", "resnet18"]
N_PARAMS = {"vgg": 9_228_362, "deepnn": 1_186_986, "resnet18": 11_181_642}
TOL, LOGIT_TOL_BF16 = 1e-4, 2.0 ** -5
KEEP = 0.9  # DeepNN's dropout 0.1


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_start(name, seed):
    return _np_tree(jget_model(name).init(jax.random.key(seed)))


def _port(name, params, stats):
    model = get_model(name)
    model.load_state_dict(interop.state_dict_from_jax(name, params, stats))
    return model


def _images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3),
                                                dtype=np.uint8)


def _labels(n, seed):
    return np.random.default_rng(seed + 100).integers(0, 10, n)


def _jax_input(imgs, dtype=None):
    return jax_as_input(jnp.asarray(imgs), dtype)


@pytest.fixture
def jax_masks(monkeypatch):
    """A queue of masks the port's dropout takes in order, in place of its
    own draws: each must have the shape of the activation it is given."""
    queue = []

    def from_queue(shape, keep, generator, device):
        mask = queue.pop(0)
        assert tuple(mask.shape) == tuple(shape) and keep == KEEP
        return torch.from_numpy(np.asarray(mask)).to(device)

    monkeypatch.setattr(tlayers, "keep_mask", from_queue)
    return queue


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b)).max())


def _assert_trees_close(got, want, tol=TOL):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                                   atol=tol)


def _assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ["vgg"] + MODELS)
def test_parameter_count_and_state_dict_layout(name):
    """The JAX package's count and tree for each model; ResNet-18's keys
    are torchvision's (the JAX export's, less ``num_batches_tracked``) and
    DeepNN's the reference's Sequential slots."""
    model = get_model(name)
    assert sum(p.numel() for p in model.parameters()) == N_PARAMS[name]
    params, stats = _jax_start(name, 0)
    sd = interop.state_dict_from_jax(name, params, stats)
    assert list(sd) == list(model.state_dict())  # the model's own order
    for k, v in model.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    export = {"vgg": lambda: jinterop.vgg_to_torch_state_dict(params, stats),
              "deepnn": lambda: jinterop.deepnn_to_torch_state_dict(params),
              "resnet18": lambda: jinterop.resnet18_to_torch_state_dict(
                  params, stats)}[name]()
    assert set(export) == set(sd)


def test_get_model_names_what_the_port_has():
    with pytest.raises(ValueError, match="vgg, deepnn, resnet18"):
        get_model("transformer")


def test_initializers():
    g = torch.Generator().manual_seed(0)
    w = init_lib.kaiming_normal_fan_out(g, 3, 3, 512, 512)
    assert tuple(w.shape) == (512, 512, 3, 3)
    std = float(w.std())
    assert abs(std / np.sqrt(2.0 / (512 * 9)) - 1) < 0.01
    b = init_lib.conv_bias(g, 3, 3, 64, 32)
    bound = 1 / np.sqrt(64 * 9)
    assert tuple(b.shape) == (32,) and float(b.abs().max()) <= bound
    model = get_model("resnet18", generator=torch.Generator().manual_seed(1))
    assert abs(float(model.fc.weight.abs().max()) * np.sqrt(512) - 1) < 0.01


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_matches_jax_arithmetic(dtype):
    """``where(mask, x / keep, 0)`` divided in ``x``'s dtype, bit for bit
    against JAX's dropout with the mask it drew; the identity in eval."""
    x = np.random.default_rng(0).standard_normal((16, 512)).astype(
        np.float32)
    key = jax.random.key(3)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jlayers.dropout(key, jnp.asarray(x).astype(jdtype), 0.1,
                           train=True)
    mask = np.asarray(jax.random.bernoulli(key, KEEP, x.shape))
    got = tlayers.dropout(torch.from_numpy(x).to(dtype), 0.1, train=True,
                          mask=torch.from_numpy(mask))
    assert got.dtype == dtype
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    xt = torch.from_numpy(x)
    assert tlayers.dropout(xt, 0.1, train=False) is xt
    with pytest.raises(ValueError, match="generator"):
        tlayers.dropout(xt, 0.1, train=True)
    a = tlayers.dropout(xt, 0.1, train=True,
                        generator=torch.Generator().manual_seed(5))
    b = tlayers.dropout(xt, 0.1, train=True,
                        generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and 0.8 < float((a != 0).float().mean()) < 1.0


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(name, train, jax_masks):
    """Eval and train-mode logits at full width, and in training the new
    BatchNorm statistics (ResNet) or the forward with JAX's dropout mask
    (DeepNN)."""
    params, stats = _jax_start(name, 2)
    imgs = _images(6, 1)
    key = jax.random.key(9)
    want, new_stats = jget_model(name).apply(params, stats, _jax_input(imgs),
                                             train=train, rng=key)
    if name == "deepnn" and train:
        jax_masks.append(jax.random.bernoulli(key, KEEP, (6, 512)))
    model = _port(name, params, stats).train(train)
    with torch.no_grad():
        got = model(tstep._as_input(torch.from_numpy(imgs)),
                    generator=torch.Generator())
    print(f"{name} train={train}: logits max|diff| {_err(got, want):.3e}")
    assert not jax_masks and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    if train and name == "resnet18":
        _, port_stats = interop.jax_from_state_dict(name, model.state_dict())
        _assert_trees_close(port_stats, _np_tree(new_stats))


@pytest.mark.parametrize("name,n", [("deepnn", 5), ("resnet18", 16)])
def test_gradients_match_jax_grad(name, n, jax_masks):
    """``make_local_grads`` against ``jax.grad`` of the JAX loss (the
    global-mean cross entropy) and against the float64 gradient: the port
    within 1e-4 of float64, and of JAX wherever JAX is (the distance
    between the two at most JAX's own from float64, plus 1e-4).  On
    ResNet-18 JAX's float32 gradient lies up to 1.6e-2 from float64 below
    layer3 on these 16 images (the port's 1.2e-5): BatchNorm's backward
    over small counts amplifies float32 rounding, and XLA's sums round
    otherwise than PyTorch's."""
    params, stats = _jax_start(name, 4)
    imgs, labels = _images(n, 2), _labels(n, 2)
    key = jax.random.key(11)

    @jax.jit
    def loss_fn(p):
        logits, _ = jget_model(name).apply(p, stats, _jax_input(imgs),
                                           train=True, rng=key)
        ce, count = cross_entropy_sum_count(logits, jnp.asarray(labels))
        return ce / count

    want = jax.grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, params))
    mask = np.asarray(jax.random.bernoulli(key, KEEP, (n, 512)))
    if name == "deepnn":
        jax_masks.append(mask)
    model = _port(name, params, stats)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    loss, grads = tstep.make_local_grads(model)(
        torch.from_numpy(imgs), torch.from_numpy(labels),
        torch.Generator())
    _, ref = f64.grads64(name, sd, imgs, labels,
                         torch.from_numpy(mask) if name == "deepnn"
                         else None)
    names = [k for k, _ in model.named_parameters()]
    port = dict(zip(names, grads))
    jax_named = interop.state_dict_from_jax(name, _np_tree(want), {})
    far = lambda a: max(_err(a[k], ref[k].numpy()) for k in names)
    apart = max(_err(port[k], jax_named[k]) for k in names)
    print(f"{name}: gradients from float64, port {far(port):.3e}, JAX "
          f"{far(jax_named):.3e}; port from JAX {apart:.3e}")
    np.testing.assert_allclose(float(loss), float(loss_fn(params)),
                               rtol=TOL)
    for k in names:
        np.testing.assert_allclose(port[k].numpy(), ref[k].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=k)
    assert apart <= far(jax_named) + TOL


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_bf16_forward_matches_jax(name, train, jax_masks):
    """``compute_dtype=bfloat16`` logits against JAX's with
    ``compute_dtype=jnp.bfloat16``: within 2^-5 of max|logit|, except
    ResNet-18 in training, held to 2^-3, the bound
    ``tests/test_torch_bf16.py`` holds a bf16 step's changes to where
    bfloat16's own effect is as large: through 20 BatchNorm layers on batch
    statistics of bfloat16 activations JAX's own bfloat16 logits lie 4.6e-2
    to 9.8e-2 of max from its float32 ones (printed), and the port's lie
    within twice that of JAX's float32 too.  The logits float32, the
    parameters untouched."""
    params, stats = _jax_start(name, 5)
    imgs = _images(6, 3)
    key = jax.random.key(13)
    apply = jget_model(name).apply
    want, _ = apply(params, stats, _jax_input(imgs, jnp.bfloat16),
                    train=train, rng=key, compute_dtype=jnp.bfloat16)
    want32, _ = apply(params, stats, _jax_input(imgs), train=train, rng=key)
    if name == "deepnn" and train:
        jax_masks.append(jax.random.bernoulli(key, KEEP, (6, 512)))
    model = _port(name, params, stats).train(train)
    with torch.no_grad():
        got = model(tstep._as_input(torch.from_numpy(imgs), torch.bfloat16),
                    compute_dtype=torch.bfloat16,
                    generator=torch.Generator())
    want, want32 = np.asarray(want, np.float32), np.asarray(want32)
    top = float(np.abs(want32).max())
    rel = _err(got, want) / top
    own, port_own = _err(want, want32) / top, _err(got, want32) / top
    print(f"{name} bf16 train={train}: logits {rel:.3e} of max from JAX's; "
          f"JAX's bf16 {own:.3e} and the port's {port_own:.3e} from JAX's "
          f"float32")
    bound = 2.0 ** -3 if train and name == "resnet18" else LOGIT_TOL_BF16
    assert got.dtype == torch.float32 and rel <= bound
    assert port_own <= max(2 * own, LOGIT_TOL_BF16)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _random_state(name, seed):
    """A start with trained-looking BN statistics and a momentum tree."""
    params, stats = _jax_start(name, seed)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: (np.abs(rng.standard_normal(a.shape)) + 0.5).astype(
            np.float32), stats)
    momentum = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    return params, stats, momentum


@pytest.mark.parametrize("name", ["vgg"] + MODELS)
def test_interop_round_trips_bit_for_bit(name):
    """JAX tree -> port state_dict -> JAX tree, momentum tree -> list ->
    tree, and the reference-format export against the JAX package's
    ``*_to_torch_state_dict`` key for key (with a zero
    ``num_batches_tracked`` beside each BatchNorm), which loads back."""
    params, stats, momentum = _random_state(name, 1)
    model = _port(name, params, stats)
    _assert_trees_equal(interop.jax_from_state_dict(name,
                                                    model.state_dict()),
                        (params, stats))
    as_list = interop.momentum_list_from_tree(model, momentum)
    assert [tuple(m.shape) for m in as_list] == \
        [tuple(p.shape) for p in model.parameters()]
    _assert_trees_equal(interop.momentum_tree_from_list(model, as_list),
                        momentum)

    ref = interop.to_reference(name, model.state_dict())
    want = {"vgg": lambda: jinterop.vgg_to_torch_state_dict(params, stats),
            "deepnn": lambda: jinterop.deepnn_to_torch_state_dict(params),
            "resnet18": lambda: jinterop.resnet18_to_torch_state_dict(
                params, stats)}[name]()
    tracked = {k for k in ref if k.endswith(".num_batches_tracked")}
    assert set(ref) - tracked == set(want)
    assert len(tracked) == len(list(model.buffers())) // 2
    assert all(ref[k].dtype == torch.long and int(ref[k]) == 0
               for k in tracked)
    for k, v in want.items():
        np.testing.assert_array_equal(ref[k].numpy(), v)
    back = get_model(name)
    back.load_state_dict(interop.from_reference(name, ref))
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    # JAX's loader reads the port's export into the same trees.
    loader = {"vgg": jinterop.vgg_from_torch_state_dict,
              "deepnn": jinterop.deepnn_from_torch_state_dict,
              "resnet18": jinterop.resnet18_from_torch_state_dict}[name]
    _assert_trees_equal(_np_tree(loader(ref)), (params, stats if stats
                                                else {}))


def test_deepnn_reference_loads_by_order():
    """Any Sequential numbering of DeepNN's reference file loads, by tensor
    rank and order as the JAX loader takes it; a file of another shape is
    refused."""
    model = get_model("deepnn", generator=torch.Generator().manual_seed(3))
    sd = model.state_dict()
    renumbered = {k.replace("features.", "features.1").replace(
        "classifier.", "classifier.9"): v for k, v in sd.items()}
    back = get_model("deepnn")
    back.load_state_dict(interop.from_reference("deepnn", renumbered))
    assert all(torch.equal(back.state_dict()[k], v) for k, v in sd.items())
    with pytest.raises(ValueError, match="DeepNN state_dict"):
        interop.from_reference("deepnn", {k: v for k, v in sd.items()
                                          if "classifier.3" not in k})
    with pytest.raises(ValueError, match="unknown model"):
        interop.to_reference("tinylm", sd)


@pytest.mark.parametrize("name", MODELS)
def test_checkpoint_files_cross_both_ways(name, tmp_path):
    """The port's v1 file read by JAX and JAX's by the port, for each model
    (DeepNN's has no ``batch_stats``), value for value."""
    params, stats, momentum = _random_state(name, 2)
    jpath, tpath = str(tmp_path / "j.pt"), str(tmp_path / "t.pt")
    jckpt.save_checkpoint(jpath, params, stats, SGDState(momentum), step=7,
                          epoch=1)
    ck = tckpt.load_checkpoint(jpath)
    model = get_model(name)
    buffers = [torch.zeros_like(p) for p in model.parameters()]
    tckpt.restore(ck, model, buffers)
    _assert_trees_equal(interop.jax_from_state_dict(name,
                                                    model.state_dict()),
                        (params, stats))
    _assert_trees_equal(interop.momentum_tree_from_list(model, buffers),
                        momentum)

    tckpt.save_checkpoint(tpath, model, buffers, step=7, epoch=1)
    back = jckpt.load_checkpoint(tpath)
    _assert_trees_equal(_np_tree(back.params), params)
    _assert_trees_equal(_np_tree(back.batch_stats), stats)
    _assert_trees_equal(_np_tree(back.opt_state.momentum_buf), momentum)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("saved,into", [("vgg", "resnet18"),
                                        ("resnet18", "deepnn"),
                                        ("deepnn", "vgg")])
def test_checkpoint_of_another_model_is_refused_whole(saved, into,
                                                      tmp_path):
    """A file of another model raises CheckpointError naming both, and
    nothing of it is loaded; so does a narrower VGG."""
    path = str(tmp_path / "c.pt")
    src = get_model(saved, generator=torch.Generator().manual_seed(1))
    tckpt.save_checkpoint(path, src, [torch.ones_like(p) for p in
                                      src.parameters()], step=1, epoch=0)
    model = get_model(into, generator=torch.Generator().manual_seed(2))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    momentum = [torch.zeros_like(p) for p in model.parameters()]
    with pytest.raises(tckpt.CheckpointError,
                       match=f"holds a {saved} tree and the model is {into}"):
        tckpt.restore(tckpt.load_checkpoint(path), model, momentum)
    assert all(torch.equal(v, before[k]) for k, v in
               model.state_dict().items())
    assert all(float(m.abs().max()) == 0 for m in momentum)

    narrow = get_model("vgg", arch=[8, "M", 16, "M", 512, "M"])
    tckpt.save_checkpoint(path, narrow, [torch.ones_like(p) for p in
                                         narrow.parameters()], 1, 0)
    vgg = get_model("vgg")
    with pytest.raises(tckpt.CheckpointError, match="is vgg"):
        tckpt.restore(tckpt.load_checkpoint(path), vgg)


def test_buffer_average_of_a_model_without_buffers_issues_none():
    """In a process group, DeepNN's buffer average issues no collective
    (JAX's ``pmean`` of an empty tree issues none); VGG's issues one."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{dist.free_port()}", rank=0,
        world_size=1)
    try:
        dist.collective_calls.clear()
        dist.average_buffers(get_model("deepnn"))
        assert dict(dist.collective_calls) == {}
        dist.average_buffers(get_model("vgg", arch=[8, "M"]))
        assert dict(dist.collective_calls) == {"all_reduce": 1}
    finally:
        torch.distributed.destroy_process_group()
        dist.collective_calls.clear()
