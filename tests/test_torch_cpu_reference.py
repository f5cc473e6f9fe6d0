"""The port's encoders held to the north-star bars of the JAX package.

The JAX package holds its encoders to independent CPU encoders of the same
algorithm class (its ``native/src/*_cpu.cpp``): ``tests/test_cpu_reference.py``,
``tests/test_native.py:150`` (BC7) and ``tests/test_corpus.py`` (real
images).  The same bars here hold the port's public encoders on CPU tensors
(the plain versions, which follow the Pallas kernels) against the port's
own copy of those CPU encoders (``cuttlefish_tpu_torch.native``, one
thread), on the same content, at the same qualities and with the same
tolerances, decoded with the port's decoders (``northstar.py`` computes
each bar's two sides).  Cases the reference marks ``slow`` are marked so
here.  ``chip_smoke.py`` phase 7 holds the hand kernels on the card to the
quality 2 bars.

The content is ``northstar.py``'s copy of the reference's helpers, held
here to the originals statement for statement.
"""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from cuttlefish_tpu_torch import northstar as ns
from cuttlefish_tpu_torch.image.image import Image

_TESTS = Path(__file__).resolve().parent
_FIX = _TESTS / "fixtures" / "corpus"
CPU, ONE = "cpu", 1  # the port on CPU tensors; the CPU encoders on one thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions, and numpy's BLAS, on one thread, as the CPU
    encoders run: small operations lose more to a thread pool than they
    gain (a threaded ``np.linalg.pinv`` of an ASTC grid's infill matrix,
    in the tables of the sized blocks, is far slower than one thread's),
    and the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


# --- the content is the reference's --------------------------------------


def _defs(rel):
    tree = ast.parse((_TESTS / rel).read_text())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    out[f"{node.name}.{sub.name}"] = sub
        elif isinstance(node, ast.FunctionDef):
            out.setdefault(node.name, node)
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = node.value
    return out


def _body(fn, drop_return=False):
    """A function's statements without its docstring (and its last
    ``return``) -> their ast dumps."""
    body = list(fn.body)
    if isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        body = body[1:]
    if drop_return:
        assert isinstance(body[-1], ast.Return)
        body = body[:-1]
    return [ast.dump(s) for s in body]


def _port(name):
    return _defs("../cuttlefish_tpu_torch/northstar.py")[name]


def _between(fn, first: str, last: str):
    """The statements of ``fn`` from the one that assigns ``first`` to the
    one that assigns ``last``."""
    names = [s.targets[0].id if isinstance(s, ast.Assign) else None for s in fn.body]
    return [ast.dump(s) for s in fn.body[names.index(first):names.index(last) + 1]]


def _if_block(fn):
    """The ``rng = ...`` statement and the ``if`` block after it."""
    names = [s.targets[0].id if isinstance(s, ast.Assign) else None for s in fn.body]
    i = names.index("rng")
    assert isinstance(fn.body[i + 1], ast.If)
    return [ast.dump(s) for s in fn.body[i:i + 2]]


_REF = "test_cpu_reference.py"


@pytest.mark.parametrize("copy,original", [
    ("content_blocks", (_REF, "content_blocks")),
    ("bc6h_content", (_REF, "TestBc6hVsCpuReference._content")),
    ("sized_content", (_REF, "_sized_content")),
    ("corpus_blocks", ("test_corpus.py", "_blocks")),
    ("_psnr", (_REF, "_psnr")),
    ("_psnr1", ("test_corpus.py", "_psnr")),
    ("_log_psnr", (_REF, "TestBc6hVsCpuReference._log_psnr")),
    ("_lin_psnr", (_REF, "TestBc6hVsCpuReference._lin_psnr")),
    ("_hdr_log_psnr", (_REF, "TestAstcHdrVsCpuReference._log_psnr")),
])
def test_content_is_the_reference(copy, original):
    assert _body(_port(copy)) == _body(_defs(original[0])[original[1]])


def test_inline_content_is_the_reference():
    r11 = _defs(_REF)["TestEacR11VsCpuReference.test_eac_r11_psnr_not_below_cpu_reference"]
    assert _body(_port("r11_content"), drop_return=True) == _if_block(r11)
    bc7 = _defs("test_native.py")["TestQualityVsCpuReference.test_bc7_psnr_not_below_cpu_reference"]
    assert _body(_port("bc7_content"), drop_return=True) == _between(bc7, "rng", "blocks")
    # The BC6H probe's log PSNR, its decode aside.
    probe = _defs("test_corpus.py")["log_psnr"]
    assert _body(_port("log_psnr"))[1:] == _body(probe)[1:]


def test_constants_are_the_reference():
    ref, corpus = _defs(_REF), _defs("test_corpus.py")
    assert ns.CLASSES == ast.literal_eval(ref["CLASSES"])
    assert ns.TIE_DB == ast.literal_eval(ref["TIE_DB"]) == ast.literal_eval(corpus["TIE_DB"])
    assert ns.FLOORS_Q2 == ast.literal_eval(corpus["FLOORS_Q2"])


# --- tests/test_cpu_reference.py -----------------------------------------

_Q2_OR_SLOW_Q4 = [2, pytest.param(4, marks=pytest.mark.slow)]


@pytest.mark.parametrize("content", ns.CLASSES)
@pytest.mark.parametrize("quality", _Q2_OR_SLOW_Q4)
def test_astc_psnr_not_below_cpu_reference(content, quality):
    p_port, p_cpu = ns.astc4x4(content, quality, CPU, ONE)
    assert p_port >= p_cpu - ns.TIE_DB, (content, quality, p_port, p_cpu)


@pytest.mark.slow
@pytest.mark.parametrize("quality", [2, 4])
def test_astc_mean_margin_nonnegative(quality):
    margins = [np.subtract(*ns.astc4x4(c, quality, CPU, ONE)) for c in ns.CLASSES]
    assert float(np.mean(margins)) >= 0.0, (quality, margins)


@pytest.mark.parametrize("content", ns.CLASSES)
@pytest.mark.parametrize("quality", _Q2_OR_SLOW_Q4)
def test_etc2_psnr_not_below_cpu_reference(content, quality):
    p_port, p_cpu = ns.etc2_rgb(content, quality, CPU, ONE)
    assert p_port >= p_cpu - ns.TIE_DB, (content, quality, p_port, p_cpu)


@pytest.mark.slow
@pytest.mark.parametrize("quality", [2, 4])
def test_etc2_mean_margin_nonnegative(quality):
    margins = [np.subtract(*ns.etc2_rgb(c, quality, CPU, ONE)) for c in ns.CLASSES]
    assert float(np.mean(margins)) >= 0.0, (quality, margins)


@pytest.mark.parametrize("quality", [2, 4])
def test_eac_a8_psnr_not_below_cpu_reference(quality):
    p_port, p_cpu = ns.eac_a8(quality, CPU, ONE)
    assert p_port >= p_cpu - ns.EAC_A8_TOL, (quality, p_port, p_cpu)


@pytest.mark.parametrize("content", ns.CLASSES)
@pytest.mark.parametrize("quality", _Q2_OR_SLOW_Q4)
def test_bc1_psnr_not_below_cpu_reference(content, quality):
    p_port, p_cpu = ns.bc1(content, quality, CPU, ONE)
    assert p_port >= p_cpu - ns.TIE_DB, (content, quality, p_port, p_cpu)


@pytest.mark.parametrize("quality", [2, 4])
def test_bc4_psnr_not_below_cpu_reference(quality):
    p_port, p_cpu = ns.bc4(quality, CPU, ONE)
    assert p_port >= p_cpu - ns.TIE_DB, (quality, p_port, p_cpu)


@pytest.mark.parametrize("content", ["lerp", "noise"])
@pytest.mark.parametrize("quality", [2, 4])
def test_bc6h_code_metric_not_below_cpu(content, quality):
    p_port, p_cpu = ns.bc6h_code(content, quality, CPU, ONE)
    assert p_port >= p_cpu - ns.TIE_DB, (content, quality, p_port, p_cpu)


@pytest.mark.parametrize("quality", [2, 4])
def test_bc6h_value_metric_not_below_cpu_linear(quality):
    p_port, p_cpu = ns.bc6h_value(quality, CPU, ONE)
    assert p_port >= p_cpu - ns.TIE_DB, (quality, p_port, p_cpu)


def test_bc6h_code_metric_ladder_monotone_log():
    ps = ns.bc6h_ladder(CPU)
    assert ps[0] <= ps[1] + 1e-9 and ps[1] <= ps[2] + 1e-9, ps


@pytest.mark.parametrize("quality", [2, 4])
@pytest.mark.parametrize("content", ["ramp", "noise"])
def test_eac_r11_psnr_not_below_cpu_reference(quality, content):
    p_port, p_cpu = ns.eac_r11(content, quality, CPU, ONE)
    assert p_port >= p_cpu - ns.TIE_DB, (content, quality, p_port, p_cpu)


@pytest.mark.parametrize("bw,bh", [(6, 6), (8, 8), (10, 10), (12, 12)])
@pytest.mark.parametrize("content", ["lerp", "pop"])
@pytest.mark.parametrize("quality", _Q2_OR_SLOW_Q4)
def test_sized_psnr_not_below_cpu_reference(bw, bh, content, quality):
    p_port, p_cpu = ns.astc_sized(bw, bh, content, quality, CPU, ONE)
    assert p_port >= p_cpu - ns.TIE_DB, (bw, content, quality, p_port, p_cpu)


# --- tests/test_native.py:150 --------------------------------------------


@pytest.mark.parametrize("quality", _Q2_OR_SLOW_Q4)
def test_bc7_psnr_not_below_cpu_reference(quality):
    p_port, p_cpu = ns.bc7(quality, CPU, ONE)
    assert p_port >= p_cpu - ns.BC7_TOL, (p_port, p_cpu)


# --- tests/test_corpus.py ------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    """(family, image) -> (the port's PSNR at quality 2 on that image, the
    CPU encoder's where a vs-CPU bar asks for it), each image encoded once
    a side for the floor and the vs-CPU bar."""
    memo = {}

    def psnrs(family, image):
        if (family, image) not in memo:
            img = Image(os.path.join(_FIX, f"{image}.png"))
            assert img.valid
            blocks = ns.corpus_blocks(np.asarray(img.rgbaf(), np.float32))
            memo[family, image] = ns.corpus(family, blocks, CPU, ONE,
                                            cpu=image in ns.CORPUS_VS_CPU[family])
        return memo[family, image]

    return psnrs


@pytest.mark.parametrize("family", ["bc7", "astc", "etc2"])
@pytest.mark.parametrize("image", ns.CORPUS_IMAGES)
def test_corpus_floor_q2(family, image, corpus):
    p, _ = corpus(family, image)
    assert p >= ns.FLOORS_Q2[(family, image)], (family, image, p)


@pytest.mark.parametrize("family,image", [(f, i) for f, imgs in ns.CORPUS_VS_CPU.items()
                                          for i in imgs])
def test_corpus_vs_cpu_reference(family, image, corpus):
    p_port, p_cpu = corpus(family, image)
    assert p_port >= p_cpu - ns.TIE_DB, (family, image, p_port, p_cpu)


@pytest.fixture(scope="module")
def probe():
    return ns.probe_blocks(np.load(_FIX / "hdr_probe.npy"))


def test_bc6h_hdr_probe(probe):
    p2, pc2, pc4 = ns.bc6h_probe(probe, CPU)
    assert p2 >= ns.HDR_PROBE_FLOOR, p2
    assert pc4 >= pc2 - 1e-9, (pc2, pc4)


def test_astc_hdr_probe(probe):
    p_port, p_cpu = ns.astc_hdr_probe(probe, CPU, ONE)
    assert p_port >= ns.HDR_PROBE_FLOOR, p_port
    assert p_port >= p_cpu - ns.TIE_DB, (p_port, p_cpu)
