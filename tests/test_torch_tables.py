"""The port's BC7 tables and constant operands equal the reference's."""

import numpy as np
import pytest
import torch

from cuttlefish_tpu.kernels import bc7_tables as REF
from cuttlefish_tpu_torch.kernels import bc7_tables as PORT
from cuttlefish_tpu_torch.kernels.bc7 import bc7_constants, channel_weights

_TABLES = [
    "PARTITION2", "ANCHOR2", "WEIGHTS2", "WEIGHTS3", "WEIGHTS4",
    "PARTITION3", "ANCHOR3_2", "ANCHOR3_3",
]


@pytest.mark.parametrize("name", _TABLES)
def test_table_equals_reference(name):
    port, ref = getattr(PORT, name), getattr(REF, name)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    assert np.array_equal(port, ref)


def test_no_table_left_out():
    ref = {k for k, v in vars(REF).items() if isinstance(v, np.ndarray)}
    assert ref == set(_TABLES)


@pytest.mark.parametrize("perceptual", [False, True])
def test_bc7_constants_match_pallas_operands(perceptual):
    """bc7_constants carries the operands bc7_pallas.py:1178-1192 builds:
    part2 = PARTITION2 as f32, anchors = ANCHOR2, chw as f32; the kernel's
    uint16 masks hold the same membership bit for bit."""
    chw = (0.55, 1.1, 0.35, 1.0) if perceptual else (1.0, 1.0, 1.0, 1.0)
    c = bc7_constants(REF.PARTITION2, REF.ANCHOR2, chw, torch.device("cpu"))
    assert c.part2.dtype == torch.float32
    assert np.array_equal(c.part2.numpy(), REF.PARTITION2.astype(np.float32))
    assert np.array_equal(c.anchor2.numpy(), REF.ANCHOR2)
    assert np.array_equal(c.anchors, REF.ANCHOR2)
    assert c.masks.dtype == np.uint16 and c.masks.shape == (64,)
    bits = (c.masks[:, None].astype(np.int64) >> np.arange(16)) & 1
    assert np.array_equal(bits, REF.PARTITION2)
    assert np.array_equal(np.float32(c.chw), np.float32(chw))
    assert np.array_equal(np.float32(channel_weights(perceptual)), np.float32(chw))
    # Texel 0 is in subset 0 and every anchor in subset 1, which the
    # kernel's index packing relies on.
    assert not (c.masks & 1).any()
    assert all((int(m) >> int(a)) & 1 for m, a in zip(c.masks, c.anchors))


@pytest.mark.parametrize("name", ["_BC1_4C_W", "_BC1_3C_W", "_BC4_8V_W", "_BC4_6V_W", "_LS_ITERS"])
def test_bc_tables_equal_pallas_kernel(name):
    """The port's BC1-BC5 weight tables and quality ladder are the Pallas
    kernel's (bc_pallas.py:27-32), value for value."""
    from cuttlefish_tpu.kernels import bc_pallas
    from cuttlefish_tpu_torch.kernels import bc

    assert getattr(bc, name) == getattr(bc_pallas, name)
