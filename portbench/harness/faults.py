"""The control and the planted faults that the check must catch.

Each is a context manager that breaks the timed path underneath, inside
the program, while the harness runs as it always does:

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
  block (texel 1 is an anchor in no mode of BC7, so its index has all its
  bits);
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


def control_bf16():
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


def half_batch():
    import torch

    def alter(words, converter):
        words = words.clone()
        words.view(torch.int32)[words.shape[0] // 2 :] = 0
        return words

    return _on_words(alter)


def _texel1_msb(block: int) -> int:
    """Bit position of the highest bit of texel 1's index in a BC7 block."""
    import torch

    from harness.reference import bc7

    bits = bc7.unpack_bits(torch.tensor(list(block.to_bytes(16, "little")), dtype=torch.uint8)[None])
    m = int(bc7._mode_of(bits)[0])
    ns, pb, rb, ib, cb, ab, pmode, i1b, _ = bc7.MODES[m]
    pbits = {"each": 2 * ns, "shared": ns}.get(pmode, 0)
    start = m + 1 + pb + rb + ib + 6 * ns * cb + 2 * ns * ab + pbits
    return start + 2 * (i1b - 1)


def altered_answer():
    import torch

    def alter(words, converter):
        words = words.clone()
        w = words.view(torch.int32)
        mid = w.shape[0] // 2
        block = int.from_bytes(w[mid].cpu().numpy().astype("<i4").tobytes(), "little")
        block ^= 1 << _texel1_msb(block)
        w[mid] = torch.from_numpy(
            __import__("numpy").frombuffer(block.to_bytes(16, "little"), "<i4").copy()
        ).to(w.device)
        return words

    return _on_words(alter)


def stale_answer():
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


def quality_high():
    return _at_quality("High")


def quality_normal():
    return _at_quality("Normal")


FAULTS = {
    "stale_answer": stale_answer,
    "half_batch": half_batch,
    "altered_answer": altered_answer,
    "quality_high": quality_high,
    "quality_normal": quality_normal,
}
