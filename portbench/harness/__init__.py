"""The benchmark of ``cuttlefish_tpu_torch``: a closed loop of whole
textures, level-0 images in memory to DDS bytes in memory, through the
port's ``Texture.convert_with_mips`` and ``save_to_bytes``.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own that the harness finds by its name in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<traffic>.json`` (with its content
family ``content/<family>.py``), ``metrics/<metric>.py``, and the plain
reference's decoder ``harness/reference/<name>.py`` named by the
configuration.
"""
