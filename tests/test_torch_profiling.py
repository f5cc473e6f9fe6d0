"""The port's spans (``cuttlefish_tpu_torch/profiling.py``): one record a
texture, nested by layer, the convert's phases built from them, and
profiler ranges only where asked for while a profiler runs.  CPU, 64²."""

import pickle
import threading

import numpy as np
import pytest
import torch

import cuttlefish_tpu_torch as cp
from cuttlefish_tpu_torch import profiling

F, T, Q = cp.TextureFormat, cp.TextureType, cp.Quality

FUSED = {"scan", "upload", "pyramid", "kernel", "fetch", "interleave", "fused"}
HOST = {"prepare", "encode", "serialize", "tile", "upload", "kernel", "fetch", "interleave"}
PVRTC = {"prepare", "encode", "serialize", "pad", "upload", "kernel", "fetch", "morton"}


def _texture(seed: int, size: int = 64) -> cp.Texture:
    rng = np.random.default_rng(seed)
    img = cp.Image.from_array(
        rng.random((size, size, 4), dtype=np.float32), cp.ImageFormat.RGBAF, cp.ColorSpace.Linear
    )
    tex = cp.Texture(cp.Dimension.Dim2D, size, size, device="cpu")
    assert tex.set_image(img)
    return tex


def _fused(seed: int, size: int = 64) -> cp.Texture:
    tex = _texture(seed, size)
    assert tex.convert_with_mips(F.BC1_RGB, T.UNorm, Q.Lowest)
    return tex


def test_one_texture_spans_share_its_id_and_nest_by_layer():
    tex = _fused(1)
    result, data = tex.save_to_bytes(cp.FileType.DDS)
    assert result is cp.SaveResult.Success and data
    spans = list(tex.spans)
    assert {s.texture for s in spans} == {tex.spans.texture}
    by_id = {s.id: s for s in spans}
    parent = {s.name: (by_id[s.parent].name if s.parent else None) for s in spans}
    pipeline = ["scan", "upload", "pyramid", "kernel", "fetch", "interleave"]
    assert parent == {
        "texture.set_image": None,
        "texture.convert_with_mips": None,
        **{f"pipeline.{p}": "texture.convert_with_mips" for p in pipeline},
        "texture.save": None,
        "containers.dds": "texture.save",
    }
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent:
            up = by_id[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    # The pipeline's spans run in order, inside the convert.
    starts = [next(s.start_ns for s in spans if s.name == f"pipeline.{p}") for p in pipeline]
    assert starts == sorted(starts)
    # The phases are the convert's child spans, by the last segment of their names.
    phases = tex.last_convert_stats["phases"]
    for p in pipeline:
        assert phases[p] == pytest.approx(
            sum(s.end_ns - s.start_ns for s in spans if s.name == f"pipeline.{p}") * 1e-9
        )


@pytest.mark.parametrize("path", ["fused", "host", "pvrtc"])
def test_convert_phases_keep_their_keys(path):
    if path == "fused":
        tex, want = _fused(2), FUSED
    elif path == "host":
        tex, want = _texture(2), HOST
        assert tex.convert(F.BC1_RGB, T.UNorm, Q.Lowest)
    else:
        tex, want = _texture(2, 16), PVRTC
        assert tex.convert(F.PVRTC1_RGBA_4BPP, T.UNorm, Q.Lowest)
    phases = tex.last_convert_stats["phases"]
    assert set(phases) == want
    assert all(isinstance(v, float) and v >= 0.0 for v in phases.values())
    if path != "fused":
        inner = sum(phases[k] for k in want - {"prepare", "encode", "serialize"})
        assert inner <= phases["encode"]


def test_textures_keep_their_own_records_in_turn_and_on_threads():
    a = _fused(3)
    phases_a = dict(a.last_convert_stats["phases"])
    spans_a = list(a.spans)
    b = _fused(4)
    assert a.last_convert_stats["phases"] == phases_a
    assert list(a.spans) == spans_a
    assert a.spans.texture != b.spans.texture
    assert {s.texture for s in b.spans} == {b.spans.texture}

    out, errors = {}, []

    def work(seed):
        try:
            out[seed] = _fused(seed)
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(s,)) for s in (5, 6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    for tex in out.values():
        assert {s.texture for s in tex.spans} == {tex.spans.texture}
        assert len(tex.spans) == 8  # set_image, the convert and its six phases
        assert set(tex.last_convert_stats["phases"]) == FUSED


def test_record_keeps_the_newest_spans():
    rec = profiling.Record()
    for i in range(profiling.MAX_SPANS + 10):
        with profiling.span(f"s{i}", rec):
            pass
    assert len(rec) == profiling.MAX_SPANS
    assert rec[0].name == "s10" and rec[-1].name == f"s{profiling.MAX_SPANS + 9}"
    with profiling.span("outside"):  # no record: nothing kept
        pass
    assert rec[-1].name == f"s{profiling.MAX_SPANS + 9}"
    copied = pickle.loads(pickle.dumps(rec))  # a Texture stays picklable
    assert list(copied) == list(rec) and copied.texture == rec.texture
    assert copied.maxlen == profiling.MAX_SPANS


def test_summary_totals_and_self_times():
    S = profiling.Span
    spans = [
        S("a.child", 10, 30, 2, 1, 7),
        S("a.child", 40, 50, 3, 1, 7),
        S("a.root", 0, 100, 1, None, 7),
        S("a.root", 200, 210, 4, None, 7),
    ]
    got = profiling.summary(spans)
    assert got == pytest.approx({
        "a.child": 30e-9, "a.child:self": 30e-9,
        "a.root": 110e-9, "a.root:self": 80e-9,
    })


def test_profiler_ranges_only_when_asked_and_a_profiler_runs(monkeypatch):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof, profiling.ranges():
        _fused(7, 16)
    names = {e.name for e in prof.events() if e.name.startswith("cuttlefish.")}
    assert {
        "cuttlefish.texture.set_image",
        "cuttlefish.texture.convert_with_mips",
        "cuttlefish.pipeline.upload",
        "cuttlefish.pipeline.pyramid",
        "cuttlefish.pipeline.kernel",
    } <= names

    opened = []

    class Counting(torch.profiler.record_function):
        def __init__(self, name, *args):
            opened.append(name)
            super().__init__(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    with profiling.ranges():  # asked for, but no profiler runs
        _fused(8, 16)
    with torch.profiler.profile(activities=acts) as prof:  # a profiler, not asked
        _fused(9, 16)
    assert opened == []
    assert not any(e.name.startswith("cuttlefish.") for e in prof.events())
