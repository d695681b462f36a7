"""A program span's device time (``portbench.trace``) and its reader
``map_collect_ms_per_call``: on synthetic kineto events with a span,
device operations launched inside and outside it, and no span at all; and
on the card at the cell's size, against the profiler's own kernel table."""

import pytest
import torch

from portbench import core
from portbench import trace as tr

READER = core.metric_reader(core.HERE, "map_collect_ms_per_call")
MAP_CELL = "bigclique18-map-b4096"


class Ev:
    """What the trace reader asks of one kineto event."""

    def __init__(self, name, kind, start, end, corr=0, device=False):
        self._name, self._kind, self._corr = name, kind, corr
        self._start, self._end, self._device = start, end, device

    def name(self):
        return self._name

    def activity_type(self):
        return self._kind

    def device_type(self):
        return "DeviceType.CUDA" if self._device else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._kind.endswith("user_annotation")

    def correlation_id(self):
        return self._corr

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end


def _launch(t, corr):
    return Ev("cudaLaunchKernel", "cuda_runtime", t, t + 5, corr)


def _device(name, s, t, corr):
    kind = "gpu_memset" if name.startswith("Memset") else "kernel"
    return Ev(name, kind, s, t, corr, device=True)


def _events(with_span=True):
    """Two traced calls (0-1000, 1000-2000 ns) after the profiler's own
    first call (before 0).  Inside ``map.collect`` ranges: a kernel of 300
    ns and a set of 10 (call 1), a kernel of 500 (call 2).  Outside: a
    kernel of 300 (call 1), and the first call's collect."""
    ev = [Ev(tr.MARK, "user_annotation", 0, 1000),
          Ev(tr.MARK, "user_annotation", 1000, 2000),
          Ev("serve.map_assignment_batch", "user_annotation", 50, 950),
          Ev("serve.map_assignment_batch", "user_annotation", 1050, 1950),
          _launch(150, 11), _device("map_collect_kernel<4, 4>", 200, 500, 11),
          Ev("cudaMemsetAsync", "cuda_runtime", 160, 170, 12),
          _device("Memset (Device)", 180, 190, 12),
          # a host operation whose own id collides with a launch's
          Ev("aten::empty", "cpu_op", 300, 310, 13),
          _launch(600, 13), _device("elementwise_kernel", 600, 900, 13),
          _launch(1150, 21), _device("map_collect_kernel<4, 4>", 1200, 1700, 21),
          # the profiler's own first call, outside the window
          _launch(-400, 1), _device("map_collect_kernel<4, 4>", -300, -100, 1)]
    if with_span:
        ev += [Ev("map.collect", "user_annotation", 100, 400),
               Ev("map.collect", "gpu_user_annotation", 200, 500, device=True),
               Ev("map.collect", "user_annotation", 1100, 1300),
               Ev("map.collect", "user_annotation", -500, -200)]
    return ev


def test_a_span_reads_what_it_launched_and_nothing_else():
    t = tr.read_events(_events())
    assert t.calls == 2 and t.window_s == 2000e-9
    assert t.span_device_s["map.collect"] == pytest.approx(810e-9)
    # the root span holds every launch of both calls
    assert t.span_device_s["serve.map_assignment_batch"] == pytest.approx(
        1110e-9)
    run = core.Run(setup_s=0.0, calls=2, trace=t)
    assert READER.read(run) == pytest.approx(1e3 * 810e-9 / 2)


def test_no_span_reads_nothing():
    t = tr.read_events(_events(with_span=False))
    assert "map.collect" not in t.span_device_s
    assert READER.read(core.Run(setup_s=0.0, calls=2, trace=t)) is None
    assert READER.read(core.Run(setup_s=0.0, calls=2)) is None


def test_a_span_that_launched_nothing_on_the_device_reads_nothing():
    # a CPU trace: the spans are there, no launch and no device operation
    ev = [e for e in _events() if not e._device and e._kind != "cuda_runtime"]
    t = tr.read_events(ev)
    assert t.span_device_s == {} and READER.read(
        core.Run(setup_s=0.0, calls=2, trace=t)) is None


def _table_ms(prof, calls):
    """Device milliseconds a call of the collect's kernels and sets by the
    profiler's own table (``key_averages``), found by name."""
    total_us = 0.0
    for e in prof.key_averages():
        if ("map_collect_kernel" in e.key or "map_decode_kernel" in e.key
                or e.key.startswith("Memset")):
            total_us += getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0))
    return total_us / 1e3 / calls


@pytest.mark.cuda
def test_the_reader_agrees_with_the_profilers_table_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: map_collect runs only on the card")
    from torch.profiler import ProfilerActivity, profile, record_function

    import junctiontree_tpu_torch as jt
    from portbench import evidence

    _, cfg, mix = core.cell(core.load_benchmark(), MAP_CELL)
    gen = core.load_module(core.HERE, "models", cfg["generator"])
    surface = core.load_module(core.HERE, "surfaces", mix["surface"])
    dev = torch.device("cuda", 0)
    factors, sizes, values = gen.build(cfg)
    inputs = surface.batches(evidence.pool(2**31 + 5, mix, sizes))
    eng = surface.engine(jt, factors, sizes, values, dev, cfg)
    for b in inputs[:2]:
        surface.call(eng, b)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in inputs:
            with record_function(tr.MARK):
                surface.call(eng, b)
                torch.cuda.synchronize(dev)
    got = READER.read(core.Run(setup_s=0.0, calls=len(inputs),
                               trace=tr.read(prof)))
    want = _table_ms(prof, len(inputs))
    assert want > 0 and got == pytest.approx(want, rel=0.05), (got, want)
