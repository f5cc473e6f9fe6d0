"""ETC2 punch-through alpha at quality 3 and 4: the port's words against
the JAX package's ``jnp`` path, bit for bit, on the blocks of
``tests/test_torch_etc_a1.py`` (its reference op by op, in a child
interpreter of its own, so that the two files run side by side).  Quality
3 ranks the quant cube and fits the best 6 in full, quality 4 fits its 31
offsets in full and refines planar, T and H."""

import pytest
from test_torch_etc_a1 import check_punched, check_words, port_words, reference


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(["words:3", "words:4"], tmp_path_factory.mktemp("a1_ref_q34"))


@pytest.mark.parametrize("quality", [3, 4])
def test_words_equal_jnp_path(quality, ref):
    words = port_words(quality)
    check_words(words, ref[f"words:{quality}"], quality)
    check_punched(words)
