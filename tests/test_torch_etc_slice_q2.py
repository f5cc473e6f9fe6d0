"""The ETC2 slice at quality 2 (Normal), the default: the port's
``Texture`` on the CPU and ``cuttlefish_tpu.Texture`` give equal KTX bytes
for ETC2_R8G8B8, 40x24 + mips (the reference's ``jnp`` path compiles for
about a minute here; the set-up is ``tests/test_torch_etc_slice.py``'s)."""

import pytest
from test_torch_etc_slice import case_key, check_equal_files, port_file, reference_files

_CASE = ("ETC2_R8G8B8", "UNorm", 2, False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    ref = reference_files([_CASE], tmp_path_factory.mktemp("etc_ref_q2"))
    return port_file(_CASE), ref[case_key(_CASE)]


def test_slice_file_matches_reference_q2(files):
    check_equal_files(_CASE, *files)
