"""The port's live statistics and metrics stream against the JAX package's:
the FLOP count of a training step against JAX's cost model of
``grad(loss)``, the ``live`` record of :class:`LiveStats` fed the same
durations and prefetch counters, and :class:`MetricsLogger`'s lines."""
import json

import jax
import jax.numpy as jnp
import pytest

from ddp_tpu.analysis.costmodel import cost_of_jaxpr
from ddp_tpu.models import get_model as jax_get_model
from ddp_tpu.obs import aggregate as jaggregate
from ddp_tpu.obs import live as jlive
from ddp_tpu.utils.metrics import MetricsLogger as JMetricsLogger
from ddp_tpu_torch.obs import live
from ddp_tpu_torch.obs.aggregate import phase_medians
from ddp_tpu_torch.obs.tracer import SpanTracer
from ddp_tpu_torch.utils.metrics import MetricsLogger


def _jax_conv_dot_flops(name: str) -> int:
    """JAX's count of one training sample's convolutions and matrix
    products: ``grad(loss)`` with respect to the parameters traced at batch
    1 and walked by ``cost_of_jaxpr``, as ``ddp_tpu/obs/live.py:44-84``
    traces it."""
    model = jax_get_model(name)
    params, stats = jax.eval_shape(model.init, jax.random.key(0))

    def _sds(tree):
        return jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(jnp.shape(x),
                                           jnp.result_type(x)), tree)

    def loss(p, s, x, y, rng):
        logits, _ = model.apply(p, s, x, train=True, rng=rng)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1))

    closed = jax.make_jaxpr(jax.grad(loss))(
        _sds(params), _sds(stats),
        jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32),
        jax.ShapeDtypeStruct((1,), jnp.int32), _sds(jax.random.key(0)))
    by_class = cost_of_jaxpr(closed.jaxpr).by_class
    return by_class["conv"] + by_class["dot"]


# JAX's conv + dot FLOPs a training sample, as the cost model counts them.
EXPECTED = {"vgg": 3_630_987_264, "deepnn": 558_397_440,
            "resnet18": 240_875_520}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_flop_count_equals_jax_conv_and_dot(name):
    jax_flops = _jax_conv_dot_flops(name)
    assert jax_flops == EXPECTED[name]
    assert round(live.train_gflop_per_sample(name) * 1e9) == jax_flops


def test_strided_input_gradient_counted_dense_as_xla_does():
    """ResNet-18's three strided stages: torch's own formula counts the
    input gradient of a stride-2 convolution at a quarter of the dilated
    convolution XLA runs; the port counts XLA's."""
    from torch.utils.flop_counter import conv_backward_flop
    conv_backward_flop = conv_backward_flop.__wrapped__  # shapes, not tensors
    grad_out, x, w = [8, 128, 4, 4], [8, 64, 8, 8], [128, 64, 3, 3]
    args = (grad_out, x, w, None, [2, 2], [1, 1], [1, 1], False, [0, 0], 1,
            [True, False])
    dense = live._conv_backward_flops(*args)
    assert dense == 2 * 8 * 64 * 8 * 8 * 128 * 9
    assert dense == 4 * conv_backward_flop(*args, out_shape=[x, w, None])
    # The weight gradient counts as the forward, as torch counts it.
    args_w = args[:-1] + ([False, True],)
    assert live._conv_backward_flops(*args_w) == \
        conv_backward_flop(*args_w, out_shape=[x, w, None]) == \
        2 * 8 * 128 * 4 * 4 * 64 * 9


def test_peaks_by_dtype_and_probe():
    assert live.mfu_peak("NVIDIA H100 80GB HBM3") == (66.9, "datasheet")
    assert live.mfu_peak("NVIDIA H100 80GB HBM3", "bfloat16") == \
        (989.0, "datasheet")
    peak, source = live.mfu_peak("cpu", "bfloat16")
    assert source == "probed" and peak > 0
    # The CPU is probed in float32 whatever the compute dtype.
    assert live.probed_peak_tflops("cpu") == peak
    assert live.mfu_peak("a card this box does not have") is None


class _Sink:
    def __init__(self):
        self.records = []

    def log_live(self, *, step, **fields):
        self.records.append({"step": step, **fields})


class _Prefetch:
    """The four counters both packages' LiveStats read."""
    wait_s = host_s = h2d_s = 0.0
    batches = 0


def test_live_record_equals_jax(monkeypatch):
    """The same durations and prefetch counters through both LiveStats:
    the same records, with one FLOP count and one stub peak on both sides;
    the port's record adds the compute dtype."""
    gflop = live.train_gflop_per_sample("vgg")
    monkeypatch.setitem(jlive._GFLOP_CACHE, "vgg", gflop)
    monkeypatch.setattr(jlive, "mfu_peak", lambda kind: (100.0, "measured"))
    monkeypatch.setattr(live, "mfu_peak",
                        lambda kind, dtype=None: (100.0, "datasheet"))
    sinks, pfs, stats = [], [], []
    for cls in (live.LiveStats, jlive.LiveStats):
        sinks.append(_Sink())
        pfs.append(_Prefetch())
        stats.append(cls(sinks[-1], global_batch=1024, n_chips=2,
                         log_every=3, window=4, model="vgg",
                         device_kind="x", prefetch_stats=pfs[-1]))
    for step in range(11):
        for pf, st in zip(pfs, stats):
            pf.wait_s += 0.001 * (step % 3)
            pf.host_s += 0.004
            pf.h2d_s += 0.0005
            pf.batches += 1
            st.step(0.05 + 0.01 * ((step * 7) % 5), step=step)
    port, ref = sinks[0].records, sinks[1].records
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        assert p.pop("compute_dtype") == "float32"
        assert p == r and "mfu" in p and "prefetch_occupancy" in p


def test_metrics_lines_equal_jax(tmp_path):
    calls = [("log_step", dict(step=3, epoch=1, loss=2.3456789123,
                               lr=0.123456789)),
             ("log_event", ("ckpt", dict(epoch=1, path="c.pt"))),
             ("log_live", dict(step=4, step_ms_median=1.5, mfu=0.25)),
             ("log_eval", dict(epoch=1, accuracy=55.123456)),
             ("log_eval", dict(epoch=2, accuracy=60.0, final=True))]
    lines = []
    for cls, path in ((MetricsLogger, tmp_path / "port.jsonl"),
                      (JMetricsLogger, tmp_path / "jax.jsonl")):
        with cls(str(path)) as m:
            assert m.active
            for name, kw in calls:
                if name == "log_event":
                    m.log_event(kw[0], **kw[1])
                else:
                    getattr(m, name)(**kw)
            m.fsync()
        recs = [json.loads(line) for line in path.read_text().splitlines()]
        assert all(isinstance(r.pop("wall_s"), float) for r in recs)
        lines.append(recs)
    assert lines[0] == lines[1] and len(lines[0]) == len(calls)
    assert not MetricsLogger(None).active
    assert not MetricsLogger(str(tmp_path / "x.jsonl"), enabled=False).active


def test_tensorboard_dir_refused_without_a_writer(monkeypatch, tmp_path):
    import builtins
    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name == "torch.utils.tensorboard":
            raise ImportError("No module named 'tensorboard'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    with pytest.raises(SystemExit, match="--tensorboard_dir"):
        MetricsLogger(None, tensorboard_dir=str(tmp_path))


def test_phase_medians_over_the_tracer_ring():
    tracer = SpanTracer(ring=8)
    t0 = tracer._t0  # the tracer's clock starts here
    for phase, dur in (("dispatch", 0.010), ("h2d", 0.009)):
        tracer.add_span(phase, t0 - 1.0, dur)  # before the window
    mark = tracer.now()
    for phase, dur in (("dispatch", 0.003), ("dispatch", 0.005),
                       ("dispatch", 0.004), ("h2d", 0.0015)):
        tracer.add_span(phase, t0 + mark + 0.1, dur, overlap=phase == "h2d")
    spans = tracer.spans_since(mark)
    assert len(spans) == 4
    assert phase_medians(spans) == pytest.approx({"dispatch": 4.0,
                                                  "h2d": 1.5})
    assert phase_medians(spans) == jaggregate.phase_medians(spans)
