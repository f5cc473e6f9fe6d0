"""CPU tests of the benchmark's harness: the loop's statistics, the
contract of BENCHMARK.json, the imports, the trace reduction.

    python -m pytest portbench/tests -q -o addopts=""
"""

from __future__ import annotations

import ast
import json
import re
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(ROOT))

from harness import loop, spec, tracing  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_rate_and_p95_count_every_texture_and_a_stall():
    clock = FakeClock()
    times = [0.05] * 99 + [2.0] + [0.05] * 100  # one stall of 2 s inside the window

    def send(member):
        clock.t += times[len(sent)]
        sent.append(member)
        return b"x", {}, {}

    sent = []
    window = loop.run_window(send, [0, 1, 2], 9.01, clock)
    # No texture is sent after 9.01 s; the last one sent is counted whole.
    assert window.seconds == pytest.approx(sum(times[: len(sent)]))
    assert len(window.records) == len(sent) == 142
    assert [r.member for r in window.records[:4]] == [0, 1, 2, 0]
    lat = [r.seconds for r in window.done]
    assert max(lat) == pytest.approx(2.0)
    # The rate's window holds the stall; the tail is over all textures.
    assert len(window.done) / window.seconds == pytest.approx(142 / (141 * 0.05 + 2.0))
    assert loop.percentile(lat, 95) == pytest.approx(0.05)
    assert loop.percentile(lat, 99.5) == pytest.approx(2.0)


def test_judged_keeps_the_slowest_and_one_of_each_class_and_drops_the_rest():
    from harness.bench import Judged

    def rec(i, member, seconds):
        return loop.Record(member, 0.0, seconds, True, {}, {}, b"dds%d" % i)

    times = [0.05, 0.06, 0.3, 0.05, 0.07, 0.05, 0.2, 0.05] * 25
    picks = []
    for seed in (1, 2, 3):
        judged = Judged(seed, {0: "alpha", 1: "opaque", 2: "alpha", 3: "opaque"})
        recs = []
        for i, t in enumerate(times):
            r = rec(i, i % 4, t)
            recs.append(r)
            judged.offer(r)
        kept = judged.records()
        assert kept[0].seconds == 0.3 and kept[0] is recs[2]
        assert {judged.classes[r.member] for r in kept[1:]} == {"alpha", "opaque"}
        assert 2 <= len(kept) <= 3 and all(r.data is not None for r in kept)
        # Every other texture's bytes were dropped as it was done.
        assert sum(r.data is not None for r in recs) == len(kept)
        picks.append(tuple(recs.index(r) for r in kept))
    assert len(set(picks)) > 1  # drawn from the seed
    again = Judged(1, {0: "alpha", 1: "opaque", 2: "alpha", 3: "opaque"})
    recs = [rec(i, i % 4, t) for i, t in enumerate(times)]
    for r in recs:
        again.offer(r)
    assert tuple(recs.index(r) for r in again.records()) == picks[0]


def test_percentile_is_nearest_rank():
    values = list(range(1, 101))
    assert loop.percentile(values, 95) == 95
    assert loop.percentile(values, 100) == 100
    assert loop.percentile([3.0], 95) == 3.0


def test_a_failed_texture_is_counted_not_fatal():
    clock = FakeClock()
    calls = []

    def send(member):
        clock.t += 1.0
        calls.append(member)
        if len(calls) == 2:
            raise RuntimeError("boom")
        return b"", {}, {}

    window = loop.run_window(send, [0], 3.5, clock)
    assert len(window.records) == 4
    assert [r.ok for r in window.records] == [True, False, True, True]
    assert "boom" in window.records[1].error


def _names():
    yield from (c["name"] for c in BENCH["configs"])
    for w in BENCH["workloads"]:
        yield w["name"]
        yield w["config"]
        yield w["traffic"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        yield m["name"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert (BENCH_DIR / "metrics" / f"{metric['name']}.py").exists()
    keys = {"name", "unit", "better", "source", "workloads"}
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= keys | {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= keys | {"layer", "moves"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert 1 <= len(w["why"]) <= 200
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()
        e2e = spec.metrics_of(BENCH, w["name"], False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert spec.metrics_of(BENCH, w["name"], True)
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        assert {c2["name"] for c2 in BENCH["workloads"] if c2["config"] == c["name"]} or False
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(cfg["limits"]) == {"head_bytes", "bad_blocks", "gap_mean", "worse_texels", "err_mean",
                                      "fit_ratio_alpha", "fit_ratio_opaque"}


def test_metric_selection_by_cell():
    (cell,) = (w["name"] for w in BENCH["workloads"])
    names = [m["name"] for m in spec.metrics_of(BENCH, cell, True)]
    assert names == [m["name"] for m in BENCH["per_layer"]]
    assert "bc7_hq_roofline" in names
    assert [m["name"] for m in spec.metrics_of(BENCH, cell, False)] == ["mtexels_per_s", "setup_s"]
    other = dict(BENCH, workloads=BENCH["workloads"] + [{"name": "x", "config": "c", "traffic": "t"}])
    assert [m["name"] for m in spec.metrics_of(other, "x", True)] == []
    assert len(spec.metrics_of(other, "x", False)) == 2


FORBIDDEN = {"jax", "jaxlib", "flax", "cuttlefish_tpu"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize(
    "path", sorted(BENCH_DIR.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH_DIR))
)
def test_no_module_imports_jax_or_the_jax_package(path):
    found = _imports(path)
    assert not found & FORBIDDEN, found & FORBIDDEN
    if "reference" in path.parts:
        assert "cuttlefish_tpu_torch" not in found


def test_the_run_check_compares_top_level_names_whole(monkeypatch):
    from harness.bench import forbidden_modules

    before = forbidden_modules()
    monkeypatch.setitem(sys.modules, "cuttlefish_tpu_torch.probe", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    assert forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "cuttlefish_tpu.probe", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert set(forbidden_modules()) - set(before) == {"cuttlefish_tpu", "jax"}


class _Ev:
    def __init__(self, name, s, t, device):
        self._n, self._s, self._t, self._d = name, s, t, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._t

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._d else torch.autograd.DeviceType.CPU


class _Results:
    def __init__(self, events):
        self._e = events

    def events(self):
        return self._e


def test_trace_reduction_busy_idle_and_labels():
    ms = 1_000_000
    ev = [
        _Ev("portbench.window", 0, 100 * ms, False),
        _Ev("portbench.texture", 0, 20 * ms, False),
        _Ev("portbench.convert", 20 * ms, 90 * ms, False),
        _Ev("aten::copy_", 22 * ms, 30 * ms, False),
        _Ev("aten::to", 21 * ms, 31 * ms, False),
        _Ev("portbench.save", 90 * ms, 100 * ms, False),
        _Ev("Memcpy HtoD", 22 * ms, 30 * ms, True),
        _Ev("bc7_hq_kernel", 40 * ms, 70 * ms, True),
        _Ev("bc7_hq_kernel", 65 * ms, 80 * ms, True),  # overlaps: counted once in busy
        _Ev("late", 95 * ms, 120 * ms, True),  # clipped to the window
    ]
    t = tracing.reduce(_Results(ev))
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx((8 + 40 + 5) * 1e-3)
    assert t.device_time("bc7_hq") == pytest.approx(0.045)
    assert t.device_s["late"] == pytest.approx(0.005)
    idle = dict(t.top_idle())
    assert idle["texture:host"] == pytest.approx(0.022)  # 0-22 ms, midpoint in texture
    assert idle["convert:host"] == pytest.approx(0.010 + 0.015)  # 30-40, 80-95
    assert "save:host" not in idle
    assert sum(idle.values()) == pytest.approx(0.1 - t.busy_s)
    assert t.top_device_ops()[0][0] == "bc7_hq_kernel"


def test_trace_leaves_out_the_ranges_mirrored_on_the_device():
    ms = 1_000_000
    ev = [
        _Ev("portbench.window", 0, 10 * ms, False),
        _Ev("portbench.convert", 0, 10 * ms, False),
        _Ev("portbench.convert", 0, 10 * ms, True),  # the device's copy of the range
        _Ev("k", 2 * ms, 3 * ms, True),
    ]
    t = tracing.reduce(_Results(ev))
    assert t.busy_s == pytest.approx(0.001)
    assert set(t.device_s) == {"k"}


def test_a_traced_run_times_its_layers_untraced_and_traces_its_second_half():
    import time

    import torch

    from harness import bench

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cell = spec.cell(BENCH, "bc7_albedo_2048_fused")
        traffic = dict(spec.traffic(cell["traffic"]), size=64, pool=4)
        out = bench.run_cell(BENCH, cell, 2**31 + 21, 3.0, True, "cpu", time.perf_counter(), (), traffic)
    finally:
        torch.set_num_threads(n)
    result = out.result
    # The traced half is about half the window; the check sees both halves.
    assert 1.4 < result["device"]["window_s"] < 2.9
    assert result["attempted"] > len(out.latencies_ms) > 0
    assert {"texture.self_ms", "kernel.ms", "containers.dds_ms"} <= set(result["metrics"])
    assert "mtexels_per_s" not in result["metrics"]
    assert out.numbers is not None and bench.finish(out)[0]
