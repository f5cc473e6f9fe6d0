"""The control and the planted faults that the check must catch.

Each is made from the configuration (``FAULTS[name](config)``) and is a
context manager that breaks the timed path underneath, inside the
program, while the harness runs as it always does:

- ``control_bf16``: the control, the step below the configuration's
  float32 that would tempt a later change: every block that the fused
  pipeline hands the kernel (level 0 and every level of the chain) is
  rounded to bfloat16 first;
- ``stale_answer``: a convert returns the previous texture's blocks (a
  step that returns its state unchanged);
- ``half_batch``: only the first half of the blocks is encoded, the rest
  left as zero words (half of the batch left out);
- ``altered_answer``: one bit of one block's words is flipped where the
  kernel produces them: the highest bit of texel 1's index in the middle
  block, at the position that the configuration's reference module gives
  (``texel1_msb``: texel 1 is an anchor in no mode, so its index has all
  its bits);
- ``quality_high``, ``quality_normal``: every convert runs at
  ``Quality.High`` or ``Quality.Normal`` instead of the configuration's
  quality (a narrower mode search, as a change that trades the search for
  time would make it).

A cell on one card has no exchange between cards to leave out.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def control_bf16(config):
    import torch

    from cuttlefish_tpu_torch.convert import device

    def make(orig):
        def pyramid_blocks(*args, **kwargs):
            return orig(*args, **kwargs).to(torch.bfloat16).to(torch.float32)

        return pyramid_blocks

    return _patched(device, "pyramid_blocks", make)


def _on_words(alter):
    """Patch every fused convert so that its converter's words pass
    through ``alter(words, converter) -> words``."""
    from cuttlefish_tpu_torch.convert.device import BlockConverter

    def make(orig):
        def encode_pyramid(self, *args, **kwargs):
            inner = self.encode_blocks
            self.encode_blocks = lambda blocks, params: alter(inner(blocks, params), self)
            try:
                return orig(self, *args, **kwargs)
            finally:
                del self.encode_blocks

        return encode_pyramid

    return _patched(BlockConverter, "encode_pyramid", make)


def half_batch(config):
    import torch

    def alter(words, converter):
        words = words.clone()
        words.view(torch.int32)[words.shape[0] // 2 :] = 0
        return words

    return _on_words(alter)


def altered_answer(config):
    import torch

    from harness.check import reference

    texel1_msb = reference(config).texel1_msb

    def alter(words, converter):
        words = words.clone()
        w = words.view(torch.int32)
        mid = w.shape[0] // 2
        block = int.from_bytes(w[mid].cpu().numpy().astype("<i4").tobytes(), "little")
        block ^= 1 << texel1_msb(block)
        w[mid] = torch.from_numpy(
            __import__("numpy").frombuffer(block.to_bytes(16, "little"), "<i4").copy()
        ).to(w.device)
        return words

    return _on_words(alter)


def stale_answer(config):
    from cuttlefish_tpu_torch.convert.device import BlockConverter

    last = {}

    def make(orig):
        def encode_pyramid(self, *args, **kwargs):
            out = orig(self, *args, **kwargs)
            prev = last.get("out")
            last["out"] = out
            return out if prev is None else prev

        return encode_pyramid

    return _patched(BlockConverter, "encode_pyramid", make)


def _at_quality(name: str):
    from cuttlefish_tpu_torch.formats import Quality
    from cuttlefish_tpu_torch.texture import Texture

    def make(orig):
        def convert_with_mips(self, fmt, type_, quality, *args, **kwargs):
            return orig(self, fmt, type_, Quality[name], *args, **kwargs)

        return convert_with_mips

    return _patched(Texture, "convert_with_mips", make)


def quality_high(config):
    return _at_quality("High")


def quality_normal(config):
    return _at_quality("Normal")


FAULTS = {
    "stale_answer": stale_answer,
    "half_batch": half_batch,
    "altered_answer": altered_answer,
    "quality_high": quality_high,
    "quality_normal": quality_normal,
}
