"""The port stands alone: importing ``mitsuba3_tpu_torch`` (every module)
and ``chip_smoke`` loads neither JAX nor the JAX package nor PIL (the
machine with the card has none; the port reads and writes PNG itself),
no source of either imports them, and ``chip_smoke.py`` refuses to run without a card
or outside a checkout, printing no result."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "mitsuba3_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|mitsuba3_tpu|PIL)\b(?!_torch)"
    r"|from\s+(jax|jaxlib|mitsuba3_tpu|PIL)\b(?!_torch))", re.M)

IMPORT_ALL = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import mitsuba3_tpu_torch, chip_smoke
for info in pkgutil.walk_packages(mitsuba3_tpu_torch.__path__,
                                  "mitsuba3_tpu_torch."):
    importlib.import_module(info.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mitsuba3_tpu", "PIL"))
print("LOADED", len([m for m in sys.modules
                     if m.startswith("mitsuba3_tpu_torch")]))
print("FORBIDDEN", bad)
"""


def _run(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_import_loads_no_jax():
    out = _run(["-c", IMPORT_ALL.format(root=str(ROOT))], cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stdout, out.stdout
    n_loaded = int(out.stdout.split("LOADED")[1].split()[0])
    assert n_loaded >= 20


def test_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 25
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert offenders == []
    # the pattern does catch what it forbids
    assert FORBIDDEN.search("import jax.numpy as jnp\n")
    assert FORBIDDEN.search("from mitsuba3_tpu.ops import cellserve\n")
    assert FORBIDDEN.search("    from PIL import Image\n")
    assert not FORBIDDEN.search("from mitsuba3_tpu_torch import ops\n")


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke would run")
    out = _run(["chip_smoke.py"], cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(["chip_smoke.py"], cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


BUILD_AND_USE = """
import sys
from pathlib import Path
sys.path.insert(0, {root!r})
import numpy as np
from mitsuba3_tpu_torch.ops import native
native.BUILD_DIR = Path({build!r})
from mitsuba3_tpu_torch import native as sah
from mitsuba3_tpu_torch.ops import bvh_serve, bvh_tiled
rng = np.random.default_rng(0)
c = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
order = sah.build_bvh(c - 0.01, c + 0.01, 16)[0]
assert sorted(order.tolist()) == list(range(500))
e = rng.normal(0, 0.1, (500, 3)).astype(np.float32)
bvh_tiled.build(c, e, e[::-1].copy(), device="cpu")
bvh_serve.build(c, e, e[::-1].copy(), device="cpu")
print("BUILT", sorted(p.name for p in Path({build!r}).iterdir()))
print("FORBIDDEN", sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "jaxlib",
                                                 "mitsuba3_tpu")))
"""


def test_sah_builder_source_lives_in_the_port():
    """The port compiles its own copy of the SAH builder (csrc/), never
    the JAX package's source or library."""
    from mitsuba3_tpu_torch.ops import native
    src = PORT / "csrc" / "bvh_build.cpp"
    assert "bvh_build.cpp" in native.SOURCES
    body = src.read_text()
    assert "mi_build_bvh" in body
    jax_src = (ROOT / "mitsuba3_tpu" / "native" / "bvh.cpp").read_text()
    assert body.endswith(jax_src)     # a copy, headed by a note
    assert native._source("bvh_build.cpp") == src
    assert native.library_path("bvh_build.cpp").parent == native.BUILD_DIR
    assert native.BUILD_DIR == ROOT / "build" / "kernels"


def test_building_the_sah_builder_leaves_jax_native_untouched(tmp_path):
    """Building and using the port's builder (fresh, into its own build
    directory) keeps mitsuba3_tpu/native/_native.so's bytes and mtime and
    loads nothing of JAX or the JAX package."""
    so = ROOT / "mitsuba3_tpu" / "native" / "_native.so"
    before = (so.read_bytes(), so.stat().st_mtime_ns)
    out = _run(["-c", BUILD_AND_USE.format(root=str(ROOT),
                                           build=str(tmp_path))], cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stdout, out.stdout
    assert "libbvh_build-" in out.stdout
    assert (so.read_bytes(), so.stat().st_mtime_ns) == before


@pytest.mark.parametrize("kernel", ["bvh_serve_cull", "bvh_serve_serve",
                                    "bvh_tiled_mt", "cellserve_serve"])
def test_kernel_variants_refuses_without_a_card(kernel):
    """The variant-timing tool runs only on the card: without one it exits
    with code 2 before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would run")
    out = _run(["-m", "mitsuba3_tpu_torch.tools.kernel_variants",
                kernel, "v=does_not_exist.cu"], cwd=ROOT)
    assert out.returncode == 2, out.stderr
    assert "no CUDA device" in out.stderr
