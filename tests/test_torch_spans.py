"""The port's spans and its ray counter on the CPU.

`utils/stats.span` is one shared no-op while no profiler records, and a
`mitsuba.*` range in torch.profiler's trace while one does, nested as the
renderer's layers nest. `benchmark/harness/spans.py` splits a trace's idle
time, kernel time and backward kernel time over those spans: checked here
on a written-out trace with known intervals, and on a real CPU profile of
a gradient step, whose backward nodes it links to their forward ops.
`KERNEL_RAYS` counts the rays handed to the trace kernels' entries, on the
plain twins here (the card's replays: tests/test_torch_jit_card.py).
"""
import collections
import json
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.harness import profile as benchprofile, spans
from mitsuba_tpu_torch.film import film
from mitsuba_tpu_torch.integrators import boundary, common, path
from mitsuba_tpu_torch.ops import brute_kernel, bvh_kernel, trace
from mitsuba_tpu_torch.scene import builtin
from mitsuba_tpu_torch.utils import graphs, stats

CPU = torch.device("cpu")

# the span that may hold each span (None: none holds it), as the layers nest
PARENTS = {
    "mitsuba.grad": {None},
    "mitsuba.grad.edges": {"mitsuba.grad"},
    "mitsuba.grad.splat": {"mitsuba.grad"},
    "mitsuba.film": {None, "mitsuba.grad"},
    "mitsuba.trace": {None, "mitsuba.grad", "mitsuba.grad.edges", "mitsuba.grad.splat"},
    "mitsuba.shading": {None, "mitsuba.grad", "mitsuba.grad.edges", "mitsuba.grad.splat"},
    "mitsuba.sampler": {None, "mitsuba.grad"},
}


def _export(prof, tmp_path):
    out = tmp_path / "trace.json"
    prof.export_chrome_trace(str(out))
    return json.loads(out.read_text())["traceEvents"]


def _grad_scene(width=16):
    scene, cam = builtin.cornell_box(width, width, device=CPU)
    leaves = {"vertices": scene.vertices, "reflectance": scene.materials.reflectance,
              "radiance": scene.emitters.radiance}
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in leaves.items()}
    scene = scene.replace(
        vertices=leaves["vertices"],
        materials=scene.materials.replace(reflectance=leaves["reflectance"]),
        emitters=scene.emitters.replace(radiance=leaves["radiance"]))
    return scene, cam


def _profiled_grad_step(tmp_path):
    scene, cam = _grad_scene()
    cfg = common.RenderConfig(spp=2, max_depth=3, filter=film.FILTER_GAUSSIAN)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(benchprofile.WINDOW):
            img = boundary.render_grad(scene, cam, cfg, boundary.BoundaryConfig(n_primary=256))
            (img ** 2).mean().backward()
    return _export(prof, tmp_path)


def test_span_off_is_one_shared_noop(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert stats.span("trace") is stats.span("render_jit.replay")
    with stats.span("sampler") as entered:
        assert entered is None
    scene, cam = builtin.cornell_box(8, 8, device=CPU)
    common.render_jit(scene, cam, path.li, common.RenderConfig(spp=2, max_depth=3))


def test_spans_nest_as_the_layers(tmp_path):
    scene, cam = builtin.cornell_box(8, 8, device=CPU)
    cfg = common.RenderConfig(spp=2, max_depth=3, filter=film.FILTER_GAUSSIAN)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        common.render(scene, cam, path.li, cfg)
    render_events = _export(prof, tmp_path)
    for events in (render_events, _profiled_grad_step(tmp_path)):
        marks = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                 and e["name"].startswith(spans.PREFIX)]
        seen = collections.Counter()
        for e in marks:
            # the innermost other span around this one's start: its parent
            held = [x for x in marks if x is not e and x["tid"] == e["tid"]
                    and x["ts"] <= e["ts"] and e["ts"] + e["dur"] <= x["ts"] + x["dur"]]
            parent = min(held, key=lambda x: x["dur"])["name"] if held else None
            assert parent in PARENTS[e["name"]], (e["name"], parent)
            seen[e["name"]] += 1
        assert {"mitsuba.sampler", "mitsuba.trace", "mitsuba.shading"} <= set(seen)
        # one film span a chunk, one to develop
        assert seen["mitsuba.film"] == 2
    assert {"mitsuba.grad", "mitsuba.grad.edges", "mitsuba.grad.splat"} <= set(seen)
    assert seen["mitsuba.grad"] == 1 and seen["mitsuba.grad.splat"] == 1
    # the replay walk's edge terms: one a bounce but the last
    assert seen["mitsuba.grad.edges"] == cfg.max_depth - 1


def _x(name, cat, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _synthetic():
    """Host thread 1 holds the window [0, 100) and the spans; thread 2 is
    autograd's engine. Times in microseconds."""
    ua, rt, k = "user_annotation", "cuda_runtime", "kernel"
    node = spans.NODE + "IndexBackward0"
    return [
        _x("bench.window", ua, 1, 0, 100),
        _x("mitsuba.render_jit", ua, 1, 10, 50),
        _x("mitsuba.render_jit.replay", ua, 1, 20, 20),
        _x("mitsuba.trace", ua, 1, 70, 10),
        # launches: a kernel and a graph in the replay, one in trace, one
        # outside every span
        _x("cudaLaunchKernel", rt, 1, 25, 1, correlation=1),
        _x("cudaGraphLaunch", rt, 1, 30, 1, correlation=2),
        _x("cudaLaunchKernel", rt, 1, 75, 1, correlation=3),
        _x("cudaLaunchKernel", rt, 1, 5, 1, correlation=4),
        # the graph's kernel overlaps the first: busy counts the union
        _x("kernel_a", k, 7, 30, 15, correlation=1),
        _x("graph_kernel", k, 7, 40, 10, correlation=2),
        _x("kernel_c", k, 7, 80, 10, correlation=3),
        _x("kernel_d", k, 7, 92, 4, correlation=4),
        # the forward op that made the node: the last of the ops that
        # recorded its sequence number (the first is outside every span)
        _x("aten::clamp_min", "cpu_op", 1, 65, 1, **{"Sequence number": 7}),
        _x("aten::index", "cpu_op", 1, 72, 2, **{"Sequence number": 7, "Fwd thread id": 0}),
        _x(node, "cpu_op", 2, 50, 20, **{"Sequence number": 7, "Fwd thread id": 1}),
        _x("cudaLaunchKernel", rt, 2, 55, 1, correlation=5),
        _x("cudaLaunchKernel", rt, 2, 75, 1, correlation=6),    # outside the node
        _x("indexing_backward_kernel", k, 7, 30, 6, correlation=5),
        _x("add_kernel", k, 7, 82, 2, correlation=6),
    ]


def test_attribution_on_a_written_trace():
    events = _synthetic()
    summary = benchprofile.summarize(events)
    idle = spans.program_idle(events)
    # idle gaps [0, 30), [50, 80), [90, 92), [96, 100)
    assert idle == pytest.approx({"none": 26e-6, "mitsuba.render_jit": 20e-6,
                                  "mitsuba.render_jit.replay": 10e-6, "mitsuba.trace": 10e-6})
    assert sum(idle.values()) == pytest.approx(summary.window_s - summary.busy_s)
    assert spans.program_device(events) == pytest.approx(
        {"mitsuba.render_jit.replay": 25e-6, "mitsuba.trace": 10e-6, "none": 12e-6})
    assert spans.backward_device(events) == pytest.approx(
        {"mitsuba.trace": 6e-6, "unlinked": 2e-6})
    assert spans.backward_device(events, by_node=True) == pytest.approx(
        {"mitsuba.trace IndexBackward0": 6e-6, "unlinked": 2e-6})
    assert spans.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0], ["c", 2.0]]


def test_backward_nodes_link_to_forward_spans(tmp_path):
    """On a real CPU profile of a 16x16 render_grad step, the index
    gathers' backward nodes (PyTorch's own and ops/gather.py's) name
    forward ops under the program's spans."""
    events = _profiled_grad_step(tmp_path)
    tr = spans.ProgramTrace(events)
    linked = collections.Counter()
    nodes = {spans.NODE + "IndexBackward0", spans.NODE + "GatherRowsBackward"}
    for e in events:
        if e.get("ph") == "X" and e.get("name") in nodes:
            linked[tr.forward_span(e).startswith(spans.PREFIX)] += e["dur"]
    assert linked[True] > 0
    assert linked[True] >= 0.99 * (linked[True] + linked[False])


def _rays(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((n, 3), generator=g) * 0.5 + 0.25
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    return o, d, torch.full((n,), 10.0)


def test_kernel_rays_count_the_rays_handed():
    scene, _ = builtin.cornell_box(8, 8, device=CPU)
    brute_kernel.reset_counts()
    o, d, tmax = _rays(37)
    trace.closest_hit(scene, o, d, tmax)
    trace.shadow_blocked(scene, o[:11], d[:11], tmax[:11])
    assert brute_kernel.KERNEL_RAYS == {"closest": 37, "any_hit": 11}
    assert brute_kernel.PLAIN_CALLS == {"closest": 1, "any_hit": 1}

    sphere, _ = builtin.displaced_sphere(8, 8, 8, 8, device=CPU)
    bvh_kernel.reset_counts()
    bvh_kernel.closest_key(sphere.bvh, o, d, tmax)
    bvh_kernel.blocked(sphere.bvh, o[:5], d[:5], tmax[:5])
    bvh_kernel.closest_and_any_key(sphere.bvh, o[:7], d[:7], tmax[:7], o[:3], d[:3], tmax[:3])
    assert bvh_kernel.KERNEL_RAYS == {"closest": 37, "any_hit": 5, "closest_and_any": 10}
    bvh_kernel.reset_counts()
    brute_kernel.reset_counts()
    assert not any(bvh_kernel.KERNEL_RAYS.values()) and not any(brute_kernel.KERNEL_RAYS.values())


def test_kernel_rays_of_a_render():
    """path.li asks one closest hit and one shadow query of every lane a
    bounce: rays per sample = 2 x max_depth."""
    scene, cam = builtin.cornell_box(8, 8, device=CPU)
    cfg = common.RenderConfig(spp=4, spp_chunk=2, max_depth=3)
    brute_kernel.reset_counts()
    common.render_jit(scene, cam, path.li, cfg)
    samples = cam.width * cam.height * cfg.spp
    assert brute_kernel.KERNEL_RAYS == {"closest": 3 * samples, "any_hit": 3 * samples}


def test_replay_adds_the_held_rays(monkeypatch):
    class Replayed:
        def replay(self):
            pass

    monkeypatch.setitem(brute_kernel.KERNEL_LAUNCHES, "closest", 0)
    monkeypatch.setitem(brute_kernel.KERNEL_RAYS, "closest", 0)
    monkeypatch.setitem(bvh_kernel.KERNEL_RAYS, "closest_and_any", 0)
    monkeypatch.setitem(graphs.STATS, "replays", 0)
    g = graphs.Graph(Replayed(), ({"closest": 2}, {}), ({"closest": 1024}, {"closest_and_any": 8}))
    g.replay()
    g.replay()
    assert brute_kernel.KERNEL_LAUNCHES["closest"] == 4
    assert brute_kernel.KERNEL_RAYS["closest"] == 2048
    assert bvh_kernel.KERNEL_RAYS["closest_and_any"] == 16
    assert graphs.STATS["replays"] == 2


def test_attribute_profiles_a_chunk_and_restores_the_spans():
    """benchmark/attribute.py: its eager chunk carries the layers' spans,
    and its span-cost turns (the spans made no-ops in every module) leave
    each module's span as they found it."""
    from benchmark import attribute

    span = stats.span
    scene, cam = builtin.cornell_box(8, 8, device=CPU)
    cfg = common.RenderConfig(spp=4, max_depth=3)
    driver = types.SimpleNamespace(scene=scene, cam=cam, li=path.li, cfg=cfg)
    driver.request = lambda traced=False: common.render_jit(scene, cam, path.li, cfg)
    cost = attribute.span_cost(driver, CPU, 1, benchprofile.WINDOW)
    assert len(cost["on"]["values"]) == len(cost["off"]["values"]) == 1
    assert stats.span is span and path.span is span and trace.span is span
    names = collections.Counter(e["name"] for e in attribute.chunk_events(driver, CPU)
                                if e.get("cat") == "user_annotation")
    assert {"mitsuba.sampler", "mitsuba.trace", "mitsuba.shading"} <= set(names)
    assert names["mitsuba.film"] == 1
