"""The conv kernel's route rule, weight repack and CPU path, on the CPU.

``conv3x3_fused`` picks one of three kernels of ``csrc/conv3x3.cu`` before
the launch, from the shape and dtype alone (``conv3x3_route``); the kernels
themselves run only on the card (``tests/test_torch_cuda.py``).  Here: which
shapes go where, that the wgmma route's K-major weights are the JAX
package's ``w.reshape(9, cin, cout)`` transposed, exactly, that CPU tensors
still take the plain version bit for bit, and that the build key covers the
shared headers.  Weights and inputs are made from a seed with numpy.
"""
import ast
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.ops import conv_candidates as jcc
from ddp_tpu_torch import _build
from ddp_tpu_torch.ops import conv_candidates as tcc
from ddp_tpu_torch.ops.conv_probe import VGG_CONV_SHAPES

BF16, F32 = torch.bfloat16, torch.float32
# (n, h, cin, cout): the probe's two targets at batch 512 and their dgrads.
TARGETS_AND_DGRADS = [(512, 32, 64, 128), (512, 32, 128, 64),
                      (512, 8, 256, 512), (512, 8, 512, 256)]


def _route(n, h, cin, cout, dtype, aligned=True):
    return tcc.conv3x3_route(n, h, h, cin, cout, dtype, aligned=aligned)


@pytest.mark.parametrize("case", TARGETS_AND_DGRADS,
                         ids=lambda c: "n{}h{}_{}to{}".format(*c))
def test_probe_targets_and_dgrads_take_the_fast_routes(case):
    assert _route(*case, BF16) == "wgmma_bf16"
    assert _route(*case, F32) == "ffma_f32"


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_conv0_and_its_dgrad_take_the_general_route(dtype):
    """VGG's conv0 (Cin = 3) and its dgrad (Cout = 3): TMA needs 16 B
    strides and cp.async 16 B copies, which three channels do not give."""
    assert _route(8, 32, 3, 64, dtype) == "general"
    assert _route(8, 32, 64, 3, dtype) == "general"


@pytest.mark.parametrize("shape", VGG_CONV_SHAPES[1:],
                         ids=lambda s: "h{}_{}to{}".format(*s[:3]))
def test_every_other_vgg_conv_takes_the_fast_routes(shape):
    h, cin, cout, _ = shape
    for a, b in ((cin, cout), (cout, cin)):  # forward and dgrad
        assert _route(8, h, a, b, BF16) == "wgmma_bf16"
        assert _route(8, h, a, b, F32) == "ffma_f32"


def test_route_edges():
    # A ragged last tile (3 images of 64 pixels) and a box across 8 images.
    assert _route(3, 8, 256, 512, BF16) == "wgmma_bf16"
    assert _route(8, 4, 512, 512, BF16) == "wgmma_bf16"
    # 6 x 6 images tile 128 pixels neither by rows nor by whole images.
    assert _route(2, 6, 64, 64, BF16) == "general"
    assert _route(2, 6, 64, 64, F32) == "ffma_f32"
    # Channel counts: multiples of 8 for TMA, of 4 for cp.async.
    assert _route(2, 8, 40, 24, BF16) == "wgmma_bf16"
    assert _route(2, 8, 12, 24, BF16) == "general"
    assert _route(2, 8, 12, 20, F32) == "ffma_f32"
    assert _route(2, 8, 12, 18, F32) == "general"
    # An input that does not start on 16 bytes, and dtypes with no fast
    # route.
    assert _route(512, 32, 64, 128, BF16, aligned=False) == "general"
    assert _route(512, 32, 64, 128, F32, aligned=False) == "general"
    assert _route(512, 32, 64, 128, torch.float16) == "general"


@pytest.mark.parametrize("h,want", [(32, (4, 1)), (16, (8, 1)), (8, (8, 2)),
                                    (4, (4, 8)), (64, (2, 1)), (6, None),
                                    (12, None)])
def test_tc_box_tiles_128_pixels(h, want):
    box = tcc.tc_box(h, h)
    assert box == want
    if box is not None:
        box_h, box_n = box
        assert box_h * h * box_n == 128
        assert (box_n == 1 and h % box_h == 0) or box_h == h


@pytest.mark.parametrize("cin,cout", [(64, 128), (512, 256), (3, 8)])
def test_kmajor_weights_equal_the_jax_reshape_transposed(cin, cout):
    """The wgmma route's B operand is the JAX kernel's ``w.reshape(9, cin,
    cout)`` (``ddp_tpu/ops/conv_candidates.py::_pallas_fwd``) with the
    channel axes swapped: ``[9, Cout, Cin]``, input channels innermost."""
    w = np.random.default_rng(cin + cout).standard_normal(
        (3, 3, cin, cout)).astype(np.float32)
    want = np.transpose(np.asarray(jnp.asarray(w).reshape(9, cin, cout)),
                        (0, 2, 1)).copy()
    for dtype in (F32, BF16):
        wt = torch.from_numpy(w).to(dtype)
        got = tcc.kmajor_weights(wt)
        assert tuple(got.shape) == (9, cout, cin) and got.is_contiguous()
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      torch.from_numpy(want).to(dtype)
                                      .float().numpy())


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_cpu_path_is_still_the_plain_version(dtype):
    """CPU tensors take ``_shift9_fwd`` bit for bit, whatever route the
    shape would take on the card, and count no launch."""
    rng = np.random.default_rng(7)
    for n, h, cin, cout in [(2, 8, 16, 8), (2, 4, 3, 8), (1, 8, 8, 16)]:
        x = torch.from_numpy(rng.standard_normal(
            (n, h, h, cin)).astype(np.float32)).to(dtype)
        w = torch.from_numpy((rng.standard_normal(
            (3, 3, cin, cout)) * 0.1).astype(np.float32)).to(dtype)
        before = (tcc.conv3x3_fused.launches,
                  dict(tcc.conv3x3_fused.route_launches))
        got = tcc.conv3x3_fused(x, w)
        assert (tcc.conv3x3_fused.launches,
                tcc.conv3x3_fused.route_launches) == before
        assert got.dtype == dtype
        assert torch.equal(got, tcc._shift9_fwd(x, w))
    # And it still agrees with the JAX package's Pallas forward's reference
    # arithmetic (nine shifted fp32 dots).
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 16, 8)) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        tcc.conv3x3_fused(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jcc._shift9_fwd(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-4, atol=1e-4)


def test_route_counters():
    assert tcc.ROUTES == ("wgmma_bf16", "ffma_f32", "general")
    counts = tcc.conv3x3_fused.route_launches
    assert list(counts) == list(tcc.ROUTES)
    assert all(isinstance(v, int) for v in counts.values())
    assert isinstance(tcc.conv3x3_fused.launches, int)


def test_no_fallback_between_the_wrapper_and_a_launch():
    """A refused launch raises: the wrapper holds no ``try`` that could move
    on to another route or to the plain version."""
    tree = ast.parse(inspect.getsource(tcc.conv3x3_fused).lstrip())
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (tmp_path / "common.cuh").write_text("// header\n")
    second = _build.library_path("k")
    (tmp_path / "common.cuh").write_text("// header, edited\n")
    third = _build.library_path("k")
    assert len({first, second, third}) == 3
    assert os.path.dirname(third) == _build.BUILD_DIR
    assert _build.sources() == ["k"]
