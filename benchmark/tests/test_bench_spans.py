"""The program's spans in a traced slice (cnbench/spans.py): a fake
profiler's events through `trace.reduce`, then the span readers against
values worked out by hand."""
from types import SimpleNamespace

import pytest

from cnbench import manifest, spans, trace


class Event:
    """The part of a kineto event that `trace.reduce` reads."""

    def __init__(self, name, start, dur, device="CPU"):
        self._name, self._start, self._dur, self._device = name, start, dur, device

    def name(self):
        return self._name

    def start_ns(self):
        return round(self._start * 1e9)

    def duration_ns(self):
        return round(self._dur * 1e9)

    def device_type(self):
        return f"DeviceType.{self._device}"


def reduced(events):
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return trace.reduce(prof)


def step_events():
    """One training step over 1 s: the step and optimizer spans, five
    launches (two inside the optimizer's span), their five kernels in
    launch order, and a copy."""
    host = [Event("train.step", 0.0, 1.0), Event("train.optimizer", 0.6, 0.3),
            Event("aten::conv2d", 0.05, 0.3)]
    host += [Event("cudaLaunchKernel", t, 0.005) for t in (0.1, 0.2, 0.65)]
    host += [Event("cuLaunchKernelEx", 0.7, 0.005), Event("cudaLaunchKernel", 0.95, 0.005),
             Event("cudaMemcpyAsync", 0.3, 0.01)]
    device = [Event("conv_fprop", 0.15, 0.2, "CUDA"), Event("mish", 0.35, 0.05, "CUDA"),
              Event("Memcpy HtoD", 0.45, 0.05, "CUDA"), Event("adam_mul", 0.66, 0.04, "CUDA"),
              Event("adam_sqrt", 0.8, 0.05, "CUDA"), Event("fill", 0.96, 0.02, "CUDA")]
    return host + device


def test_spans_are_host_ops_and_no_device_work():
    rec = reduced(step_events())
    assert rec["window_s"] == pytest.approx(1.0)
    assert [k[0] for k in rec["kernels"]] == ["conv_fprop", "mish", "adam_mul",
                                             "adam_sqrt", "fill"]
    assert rec["busy_s"] == pytest.approx(0.2 + 0.05 + 0.05 + 0.04 + 0.05 + 0.02)
    assert spans.intervals(rec, ("train.optimizer",)) == [pytest.approx((0.6, 0.9))]
    assert spans.launches(rec) == pytest.approx([0.1, 0.2, 0.65, 0.7, 0.95])


def test_span_readers_by_hand():
    rec = dict(reduced(step_events()), steps=1)
    opt = ("train.optimizer",)
    # launches at 0.65 and 0.7 lie inside 0.6-0.9
    assert spans.span_kernels_per_step(rec, opt) == pytest.approx(2.0)
    assert spans.span_kernel_share(rec, opt) == pytest.approx(100 * 0.09 / 0.36)
    # 0.3 s of span, of which 0.04 + 0.05 busy
    assert spans.span_idle_share(rec, opt) == pytest.approx(100 * 0.21 / 1.0)
    step = ("train.step",)
    assert spans.span_kernels_per_step(rec, step) == pytest.approx(5.0)
    assert spans.span_kernel_share(rec, step) == pytest.approx(100.0)
    # two steps in the slice halve the count
    assert spans.span_kernels_per_step(dict(rec, steps=2), opt) == pytest.approx(1.0)


def test_union_of_spans_counts_overlaps_once():
    rec = {"window_s": 2.0, "busy_spans": [(0.5, 1.5)], "steps": 1,
           "host_ops": [("api.prepare", 0.0, 1.0), ("api.to_host", 0.8, 1.2),
                        ("api.to_host", 1.8, 2.0)]}
    names = ("api.prepare", "api.to_host")
    assert spans.intervals(rec, names) == [(0.0, 1.2), (1.8, 2.0)]
    # 1.4 s of spans, 0.7 s of it busy
    assert spans.span_idle_share(rec, names) == pytest.approx(100 * 0.7 / 2.0)


def test_no_spans_reads_nothing():
    rec = dict(reduced([e for e in step_events() if not e.name().startswith("train.")]),
               steps=1)
    for read in (spans.span_idle_share, spans.span_kernels_per_step,
                 spans.span_kernel_share):
        assert read(rec, ("train.optimizer",)) is None
    for name in ("api_idle_share.serve", "optimizer_kernels_per_step.train_csp53",
                 "optimizer_idle_share.train_csp53",
                 "optimizer_kernels_per_step.train_r18dcn",
                 "dcn_recompute_share.train_r18dcn"):
        assert manifest.metric_reader(name)(rec) is None


def test_launches_pair_with_kernels_from_the_end():
    # the first launch's kernel missing from the trace: the rest still pair
    events = [e for e in step_events() if e.name() != "conv_fprop"]
    rec = dict(reduced(events), steps=1)
    assert len(rec["kernels"]) == len(spans.launches(rec)) - 1
    assert spans.span_kernel_share(rec, ("train.optimizer",)) == pytest.approx(
        100 * 0.09 / 0.16)
    # a kernel with no launch at all: nothing to pair by
    events = [e for e in step_events() if e.name() != "cuLaunchKernelEx"]
    rec = dict(reduced(events), steps=1)
    assert spans.span_kernel_share(rec, ("train.optimizer",)) is None
    assert spans.span_kernels_per_step(rec, ("train.optimizer",)) == pytest.approx(1.0)


def test_metric_readers_read_their_spans():
    rec = dict(reduced(step_events() + [Event("dcn.recompute", 0.75, 0.1),
                                        Event("api.to_host", 0.9, 0.1)]), steps=1)
    read = manifest.metric_reader
    assert read("optimizer_kernels_per_step.train_csp53")(rec) == pytest.approx(2.0)
    assert read("optimizer_kernels_per_step.train_r18dcn")(rec) == pytest.approx(2.0)
    assert read("optimizer_idle_share.train_csp53")(rec) == pytest.approx(21.0)
    # the launch at 0.95 (a 0.02 s kernel) lies inside 0.9-1.0, busy 0.96-0.98
    assert read("api_idle_share.serve")(rec) == pytest.approx(100 * 0.08 / 1.0)
    # no launch inside 0.75-0.85
    assert read("dcn_recompute_share.train_r18dcn")(rec) == pytest.approx(0.0)
