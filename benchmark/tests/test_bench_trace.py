"""The per-layer arithmetic on synthetic data: the idle share from the union
of device intervals, the trace kernels' bytes from their queries (eager and
replayed), and the readers."""
from __future__ import annotations

import types

import pytest
import torch

from benchmark.harness import profile, queries
from benchmark.harness import cell as celllib
from benchmark.tests.helpers import ROOT


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_idle_share_counts_overlapping_kernels_once():
    # a 100 us window; kernels overlap (a graph runs independent ones at
    # once): their summed time is 130 us, their union 70 us
    events = [_span("bench.window", 0, 100), _span("bench.render", 0, 80),
              _span("bench.to_host", 80, 20),
              _kernel("a", 0, 50), _kernel("b", 10, 50), _kernel("c", 20, 20),
              _kernel("copy", 85, 10, cat="gpu_memcpy"),
              _kernel("gpu range", 0, 100, cat="gpu_user_annotation"),
              _kernel("outside", 150, 10)]
    s = profile.summarize(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(70e-6)
    assert 0.0 <= s.idle_share <= 1.0
    assert s.idle_share == pytest.approx(0.3)
    assert sum(s.kernel_s.values()) == pytest.approx(120e-6)     # a + b + c, not the copy
    assert s.idle_by_span == pytest.approx({"bench.render": 20e-6, "bench.to_host": 10e-6})
    assert s.kernel_seconds(["a", "c"]) == pytest.approx(70e-6)


def test_idle_share_stays_in_range_for_any_overlap():
    gen = torch.Generator().manual_seed(5)
    for _ in range(50):
        n = int(torch.randint(1, 40, (1,), generator=gen))
        ts = torch.rand(n, generator=gen) * 900
        dur = torch.rand(n, generator=gen) * 300
        events = [_span("bench.window", 0, 1000)] + [
            _kernel(f"k{i % 3}", float(t), float(d)) for i, (t, d) in enumerate(zip(ts, dur))]
        s = profile.summarize(events)
        assert 0.0 <= s.idle_share <= 1.0
        assert s.busy_s <= s.window_s + 1e-12


def test_union_merges():
    assert profile.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]


class _FakeGraph:
    def replay(self):
        pass


@pytest.fixture
def fake_entry(monkeypatch):
    """A kernel entry `closest(tris, o, d, tmax)` in a module of its own, and
    graphs.capture run without a card."""
    from mitsuba_tpu_torch.utils import graphs

    mod = types.ModuleType("bench_fake_kernel")
    mod.closest = lambda tris, o, d, tmax: None
    monkeypatch.setitem(__import__("sys").modules, "bench_fake_kernel", mod)
    capturing = [False]
    monkeypatch.setattr(queries, "_capturing", lambda args: capturing[0])

    def fake_capture(fn, generators=()):
        capturing[0] = True
        fn()
        capturing[0] = False
        return graphs.Graph(_FakeGraph(), [{}, {}])

    monkeypatch.setattr(graphs, "capture", fake_capture)
    replays = graphs.STATS["replays"]
    yield mod
    graphs.STATS["replays"] = replays


def test_trace_bytes_count_queries_eager_and_replayed(fake_entry):
    from mitsuba_tpu_torch.utils import graphs

    spec = {"module": "bench_fake_kernel", "entry": "closest", "kernel": "fake_kernel",
            "rays": [{"args": [1, 2, 3], "hit_bytes": 8}]}
    tally = queries.Tally([spec], n_tris=32)
    tally.install()
    try:
        n = 1000
        o, d, tmax = torch.zeros(n, 3), torch.ones(n, 3), torch.ones(n)
        per_launch = n * (12 + 12 + 4) + n * 8 + 32 * 36
        fake_entry.closest(None, o, d, tmax)                # eager: counted now
        assert (tally.bytes, tally.launches) == (per_launch, 1)
        g = graphs.capture(lambda: fake_entry.closest(None, o[:10], d[:10], tmax[:10]))
        assert tally.launches == 1                            # a capture runs nothing
        g.replay()
        g.replay()
        captured = 10 * 36 + 32 * 36
        assert (tally.bytes, tally.launches) == (per_launch + 2 * captured, 3)
        tally.reset()
        assert tally.bytes == 0
    finally:
        tally.uninstall()
    assert graphs.capture.__name__ == "fake_capture"


def test_query_bytes_ignore_the_launch_grid():
    # the fused BVH entry: two ray groups; the bytes depend on rays and
    # triangles alone
    spec = next(s for s in celllib.kernel_entries(ROOT) if s["name"] == "bvh_closest_and_any")
    args = (None, torch.zeros(7, 3), torch.zeros(7, 3), torch.zeros(7),
            torch.zeros(5, 3), torch.zeros(5, 3), torch.zeros(5))
    assert queries.query_bytes(spec, args, 100) == 7 * 36 + 5 * 29 + 100 * 36


def _ctx(**kw):
    from benchmark import run

    return run.Context(**{"spans": {}, "counters": {}, **kw})


def test_readers_return_nothing_where_nothing_was_read():
    for name in ("trace_roofline.render", "device_idle.render", "replays_per_image.render",
                 "load_s", "trace_roofline.grad", "device_idle.grad", "backward_s.grad"):
        assert celllib.reader(name, ROOT).read(_ctx()) is None


def test_roofline_reader():
    s = profile.Summary(window_s=1.0, busy_s=0.5, kernel_s={"brute_closest_kernel<2>": 0.002,
                                                            "other": 0.4}, idle_by_span={})
    tally = types.SimpleNamespace(bytes=3.35e9, kernels=["brute_closest_kernel"])
    peaks = {"hbm_bytes_per_s": 3.35e12}
    got = celllib.reader("trace_roofline.render", ROOT).read(
        _ctx(summary=s, tally=tally, peaks=peaks))
    assert got == pytest.approx(50.0)        # 1 ms least time over 2 ms
    tally.bytes = 0
    assert celllib.reader("trace_roofline.render", ROOT).read(
        _ctx(summary=s, tally=tally, peaks=peaks)) is None
    idle = celllib.reader("device_idle.render", ROOT).read(_ctx(summary=s))
    assert idle == pytest.approx(50.0)
