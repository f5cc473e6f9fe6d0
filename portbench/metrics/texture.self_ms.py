"""The texture layer's own time per texture: the benchmark's spans around
``Texture(...)`` with ``set_image`` and around ``convert_with_mips``,
less the fused pipeline's phases inside it (``set_image``'s copies, the
convert's set-up and its per-level ``bytes``)."""

from harness.layers import mean_ms

PIPELINE = ("scan", "upload", "pyramid", "kernel", "fetch", "interleave")


def read(run):
    return mean_ms(
        run,
        lambda r: r.spans["texture"] + r.spans["convert"] - sum(r.phases.get(p, 0.0) for p in PIPELINE),
    )
