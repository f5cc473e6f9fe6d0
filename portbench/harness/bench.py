"""One run of one cell: set-up, the measured window, the check, the
result line.

``main`` is what ``run.py`` calls; ``run_cell`` does the work and is what
the tests drive on the CPU (``device="cpu"``: the program's plain
versions, no trace, no card), with ``patches`` planting a fault or the
control underneath the timed path.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

from harness import check, spec, tracing
from harness.loop import Window, percentile, run_window
from harness.reference.pyramid import full_levels, mip_dims

FORBIDDEN = ("jax", "jaxlib", "flax", "cuttlefish_tpu")


@dataclasses.dataclass
class Outcome:
    """A run's result line (``correct`` not yet decided), the check's
    numbers (None where no texture completed), the configuration, and the
    window's texture times."""

    result: dict
    numbers: dict | None
    config: dict
    latencies_ms: list
    layers_ms: dict  # mean per texture of each span and phase, for standard error


@dataclasses.dataclass
class RunView:
    """What a metric reader reads.  ``window`` is the untraced window (in a
    traced run its first half), which the host-clock and program-span
    readers read; ``traced`` the traced half of a traced run, whose
    textures the device-trace readers count against ``trace``."""

    config: dict
    window: Window
    setup_s: float
    texels: int  # source texels of one texture, every level and face
    blocks: int  # blocks of one texture
    trace: tracing.Trace | None
    traced: Window | None
    window_peak_bytes: int | None

    @property
    def done(self) -> list:
        return self.window.done


class Judged:
    """The textures of the window that the check judges: the slowest, and
    one texture of each class of content (with alpha, opaque) drawn from
    the seed by reservoir sampling.  Every other texture's DDS bytes are
    dropped as soon as it is done, so the window holds a few files at a
    time and not all of them."""

    def __init__(self, seed: int, classes: dict):
        self.rng = np.random.default_rng(seed ^ 0x5EED)
        self.classes = classes  # pool member -> class
        self.seen = collections.Counter()
        self.slowest = None
        self.drawn = {}  # class -> record

    def offer(self, rec) -> None:
        if not rec.ok:
            return
        cls = self.classes[rec.member]
        self.seen[cls] += 1
        kept = self.rng.random() * self.seen[cls] < 1.0
        if kept:
            old, self.drawn[cls] = self.drawn.get(cls), rec
            self._drop(old)
        if self.slowest is None or rec.seconds > self.slowest.seconds:
            old, self.slowest = self.slowest, rec
            self._drop(old)
            kept = True
        if not kept:
            rec.data = None

    def _drop(self, rec) -> None:
        if rec is not None and rec is not self.slowest and all(rec is not r for r in self.drawn.values()):
            rec.data = None

    def records(self) -> list:
        out = []
        for r in [self.slowest, *(self.drawn[c] for c in sorted(self.drawn))]:
            if r is not None and all(r is not o for o in out):
                out.append(r)
        return out


def shape_counts(size: int, faces: int) -> tuple[int, int]:
    """(texels, blocks) of a square texture's full chain over its faces."""
    dims = mip_dims(size, size, full_levels(size, size))
    texels = sum(h * w for h, w in dims) * faces
    blocks = sum(-(-h // 4) * -(-w // 4) for h, w in dims) * faces
    return texels, blocks


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the run must not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def content_class(member: np.ndarray) -> str:
    """'alpha' where any texel's alpha is below 1, else 'opaque'."""
    return "alpha" if bool((member[..., 3] < 1.0).any()) else "opaque"


def run_cell(bench, cell, seed, seconds, trace, device, t_start, patches=(), traffic=None) -> Outcome:
    """Set-up, the window and the check of one run.  ``traffic`` replaces
    the cell's traffic file (the tests' small sizes).  A traced run spends
    the first half of its window untraced, for the host-clock and
    program-span readers, and traces the second half."""
    import torch

    config = spec.config(bench, cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    cuda = torch.device(device).type == "cuda"
    family = spec.content_family(traffic["content"])
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    pool = family.make(traffic, gen, device).cpu().numpy()
    if cuda:
        torch.cuda.empty_cache()
    from harness.system import System

    faces, size = traffic["faces"], traffic["size"]
    system = System(config, faces, size, device)
    images = [system.images(pool[i]) for i in range(pool.shape[0])]
    order = np.random.default_rng(seed).permutation(pool.shape[0]).tolist()
    texels, blocks = shape_counts(size, faces)
    judged = Judged(seed, {m: content_class(pool[m]) for m in range(pool.shape[0])})

    def send(member):
        return system.encode(images[member])

    traced = None
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        send(order[0])  # the warm-up texture, of the cell's shape
        setup_peak = window_peak = None
        if cuda:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        plain_s = seconds / 2 if trace else seconds
        window = run_window(send, order, plain_s, on_done=judged.offer)
        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            prof = stack.enter_context(torch.profiler.profile(activities=acts))
            rest = len(window.records) % len(order)
            with torch.profiler.record_function(tracing.WINDOW):
                traced = run_window(send, order[rest:] + order[:rest], seconds - plain_s, on_done=judged.offer)
        if cuda:
            torch.cuda.synchronize()
            window_peak = torch.cuda.max_memory_allocated()
    reduced = tracing.reduce(prof.profiler.kineto_results) if prof is not None else None
    del prof

    run = RunView(config, window, setup_s, texels, blocks, reduced, traced, window_peak)
    metrics = {}
    for m in spec.metrics_of(bench, cell["name"], trace):
        value = spec.metric_reader(m["name"]).read(run)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    records = window.records + (traced.records if traced else [])
    done = [r for r in records if r.ok]
    result = {
        "correct": False,
        "attempted": len(records),
        "failed": len(records) - len(done),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(torch.device(device)) if cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": max(setup_peak, window_peak) if cuda else 0,
        },
    }
    if reduced is not None:
        result["device"]["busy_s"] = reduced.busy_s
        result["device"]["window_s"] = reduced.window_s
        result["breakdown"] = {"device_ops": reduced.top_device_ops(), "idle_gaps": reduced.top_idle()}
    for r in records:
        if not r.ok:
            print(f"texture of member {r.member} failed: {r.error}", file=sys.stderr)

    # The check, once the window has closed and the peak has been read.
    del images, system
    if cuda:
        torch.cuda.empty_cache()
    per = [check.judge_texture(config, pool[r.member], r.data, device) for r in judged.records()]
    numbers = check.combine(per) if per else None
    layers = {}
    for r in window.done:
        for k, v in {**r.spans, **r.phases}.items():
            layers[k] = layers.get(k, 0.0) + v * 1e3 / len(window.done)
    return Outcome(result, numbers, config, [r.seconds * 1e3 for r in window.done], layers)


def finish(outcome: Outcome) -> tuple[bool, dict]:
    """Decide ``correct`` and append the check to the result."""
    result, numbers, config = outcome.result, outcome.numbers, outcome.config
    if numbers is None:
        shown = {k: {"value": None, "limit": config["limits"][k]} for k in check.NUMBERS}
        ok = False
    else:
        ok, shown = check.verdict(numbers, config["limits"])
    result["correct"] = bool(ok and result["failed"] == 0 and result["attempted"] > 0)
    result["check"] = shown
    return result["correct"], shown


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(
            f"{cell['name']} needs {cell['chips']} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
            file=sys.stderr,
        )
        return 2
    outcome = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the run holds forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 3
    _, shown = finish(outcome)
    result = outcome.result
    lat = outcome.latencies_ms
    if lat:
        q = " ".join(f"p{p} {percentile(lat, p):.2f}" for p in (50, 90, 95, 99))
        print(f"texture ms: min {min(lat):.2f} {q} max {max(lat):.2f}", file=sys.stderr)
    print("layers ms: " + " ".join(f"{k} {v:.2f}" for k, v in outcome.layers_ms.items()), file=sys.stderr)
    done = result["attempted"] - result["failed"]
    print(f"{cell['name']} seed {args.seed}: {done} textures, correct {result['correct']}", file=sys.stderr)
    for k, v in shown.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def set_cache_dirs() -> None:
    """Every build and kernel cache of the program inside the checkout,
    at fixed paths, so that only a checkout's first run builds."""
    os.environ["CUTTLEFISH_TORCH_BUILD_DIR"] = str(spec.ROOT / "cuttlefish_tpu_torch" / "_build")
    os.environ.setdefault("TRITON_CACHE_DIR", str(spec.ROOT / ".portbench_cache" / "triton"))
