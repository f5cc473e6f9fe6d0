"""``BENCHMARK.json`` and the files its names lead to."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def load_module(path: Path, name: str):
    """Import a file by path (metric readers and content families have
    dots or dashes in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def content_family(name: str):
    return load_module(BENCH / "content" / f"{name}.py", f"portbench_content_{name}")


def metric_reader(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py", "portbench_metric_" + re.sub(r"\W", "_", name))


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on), in BENCHMARK.json order."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}

    def here(m):
        if "workloads" in m:
            return cell_name in m["workloads"]
        return m["moves"] in reported

    return [m for m in bench["per_layer"] if here(m)]
