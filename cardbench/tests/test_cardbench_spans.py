"""``cardbench/spans.py``: device time by the program range that owns it,
on synthetic events (the rule) and on a profiled reduced train step on the
CPU (the profiler's real events: every region and ``.bwd`` range)."""

from __future__ import annotations

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from cardbench import bench, devtrace, inputs, spans
from cardbench.tests.conftest import REDUCED


def _op(t: float, thread: int = 1, dur: float = 1.0, name: str = "k"):
    """A device operation launched at ``t`` on ``thread``, running from
    ``t + 100`` (microseconds)."""
    return (name, t + 100, t + 100 + dur, thread, t)


def _owner(ranges, t, thread=1):
    s = spans.reduce([_op(t, thread)], ranges, (0, 1000))
    return next(iter(s.by_owner))


def test_the_innermost_range_owns_an_operation():
    ranges = [(1, 0, 500, "train.step"), (1, 0, 50, "train.forward"),
              (1, 10, 20, "model.attn"), (1, 12, 14, "model.norm")]
    assert _owner(ranges, 13) == "model.norm"
    assert _owner(ranges, 15) == "model.attn"
    assert _owner(ranges, 30) == "train.forward"      # forward ranges end
    assert _owner(ranges, 60) == "train.step"
    assert _owner(ranges, 600) == spans.NONE
    assert _owner(ranges, 13, thread=2) == spans.NONE  # another thread


def test_work_after_a_bwd_range_closed_belongs_to_it():
    """Autograd's thread: the add after a select's backward, and work of a
    ``.bwd`` range around a recomputed forward."""
    ranges = [(2, 10, 20, "model.layer_slice.bwd"),
              (2, 30, 60, "model.mlp.bwd"), (2, 35, 40, "model.norm")]
    assert _owner(ranges, 15, 2) == "model.layer_slice.bwd"
    assert _owner(ranges, 25, 2) == "model.layer_slice.bwd"
    assert _owner(ranges, 38, 2) == "model.norm"
    assert _owner(ranges, 45, 2) == "model.mlp.bwd"
    assert _owner(ranges, 65, 2) == "model.mlp.bwd"


def test_a_bwd_range_owns_no_work_outside_the_range_it_closed_in():
    """On one thread (the CPU's backward runs on the caller's): a ``.bwd``
    range that closed before the open range began owns nothing in it."""
    ranges = [(1, 0, 100, "train.backward"), (1, 5, 10, "model.ce.bwd"),
              (1, 120, 200, "train.optimizer")]
    assert _owner(ranges, 50) == "model.ce.bwd"
    assert _owner(ranges, 150) == "train.optimizer"
    assert _owner(ranges, 110) == spans.NONE     # train.backward closed last


def test_device_time_is_clipped_to_the_window_and_summed_by_owner():
    ranges = [(1, 0, 50, "model.attn"), (1, 50, 90, "model.mlp")]
    device = [("gemm", 95, 130, 1, 10), ("silu", 130, 140, 1, 60),
              ("lost", 140, 150, None, 140), ("late", 300, 310, 1, 70)]
    s = spans.reduce(device, ranges, (100, 200))
    assert s.by_owner == {"model.attn": 30e-6, "model.mlp": 10e-6,
                          spans.NONE: 10e-6}
    assert s.by_owner_op[("model.attn", "gemm")] == 30e-6
    assert s.device_s == pytest.approx(50e-6) and s.window_s == 100e-6
    assert s.seconds("model.attn", "model.mlp") == pytest.approx(40e-6)
    assert s.share(lambda n: n == "model.attn") == pytest.approx(60.0)
    assert s.ranges == {}                          # both opened before it


class _Event:
    """The accessors of a profiler's ``KinetoEvent`` that ``spans`` reads."""

    def __init__(self, name, device, start, end, corr, link=0, thread=1,
                 annotation=False):
        self._v = (name, device, start * 1000, end * 1000, corr, link, thread,
                   annotation)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def end_ns(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def start_thread_id(self): return self._v[6]
    def is_user_annotation(self): return self._v[7]


def test_from_events_follows_the_correlation_and_leaves_out_annotations():
    """Laid out as torch 2.11 reports a range around a matmul on the card
    and a backward kernel launched on autograd's thread."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _Event(devtrace.WINDOW_RANGE, cpu, 0, 1000, 1, annotation=True),
        _Event("model.attn", cpu, 10, 20, 2, annotation=True),
        _Event("aten::mm", cpu, 11, 19, 4),
        _Event("cudaLaunchKernel", cpu, 12, 13, 11, link=4),
        _Event("gemm", cuda, 100, 140, 11),
        _Event("model.attn", cuda, 100, 140, 2, annotation=True),
        _Event(devtrace.WINDOW_RANGE, cuda, 100, 400, 1, annotation=True),
        _Event("model.attn.bwd", cpu, 200, 220, 519, thread=2,
               annotation=True),
        _Event("cudaLaunchKernel", cpu, 230, 231, 66, link=531, thread=2),
        _Event("add", cuda, 300, 310, 66),
        _Event("orphan", cuda, 320, 330, 77),
    ]
    s = spans.from_events(events)
    assert s.by_owner == {"model.attn": 40e-6, "model.attn.bwd": 10e-6,
                          spans.NONE: 10e-6}
    assert s.device_s == pytest.approx(60e-6)
    assert s.ranges == {"model.attn": 1, "model.attn.bwd": 1}
    with pytest.raises(RuntimeError, match="cardbench.window"):
        spans.from_events(events[1:])


def test_a_profiled_reduced_train_step_holds_every_region():
    """The benchmark's traced window around the reduced granite's donated
    step on the CPU: every region and ``.bwd`` range once a step or more;
    no device operation, so no share."""
    from repro_torch.models.registry import build
    from repro_torch.training import optim
    from repro_torch.training.train_step import TrainConfig, make_train_step

    spec = bench.spec()
    cfg = dict(bench.config(spec, "granite-3-2b"), **REDUCED)
    drv = bench.driver("train")
    bundle = build(drv.port_config(cfg))
    ocfg = optim.OptimConfig(**cfg["optimizer"])
    cpu = torch.device("cpu")
    params = drv.program_params(cfg, bundle, 2**31 + 7, cpu)
    state = {"step": torch.zeros((), dtype=torch.int32), "params": params,
             "opt": optim.opt_init(ocfg, params)}
    step = make_train_step(bundle, TrainConfig(optim=ocfg), donate=True)
    feed = inputs.Feed(2**31 + 7, 2, 64, cfg["vocab_size"], cpu)
    state, _ = step(state, feed.next())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(devtrace.WINDOW_RANGE):
            for _ in range(2):
                state, _ = step(state, feed.next())
    s = spans.from_profiler(prof)
    model = ("model.embed", "model.norm", "model.attn", "model.mlp",
             "model.ce", "model.layer_slice")
    want = {"train.step", "train.forward", "train.backward", "train.own",
            "train.clip", "train.optimizer", *model,
            *(f"{m}.bwd" for m in model)}
    assert set(s.ranges) == want
    assert s.ranges["train.step"] == 2
    assert s.device_s == 0 and s.share(lambda n: True) is None
    assert devtrace.from_profiler(prof, bench.kinds()).launches == 0
