"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke``'s helpers pulls in neither JAX nor anything of the JAX
package, and every entry point defaults to CUDA and raises without it."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
sys.path.insert(0, {root!r})
import chip_smoke
assert chip_smoke.bound(3.35e9, 0, "float32") == (1.0, "bytes")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
print(len(mods))
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c",
                          _PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def test_port_sources_name_no_jax_import():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (f, s)
            assert not s.startswith(("import repro.", "from repro.",
                                     "from repro import")), (f, s)
            assert s != "import repro", f


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    from repro_torch.core.tiers import make_dynamic_tier, make_static_tier
    from repro_torch.device import get_device
    from repro_torch.embedding.embedder import Embedder
    from repro_torch.launch.serve import build_service
    from repro_torch.configs import smoke_config
    from repro_torch.index.ivf import build_ivf
    from repro_torch.index.segmented import SegmentedIndex
    from repro_torch.serving.engine import LLMEngine
    for call in (lambda: get_device(), lambda: make_dynamic_tier(4, 8),
                 lambda: make_static_tier(np.eye(4), np.arange(4)),
                 lambda: Embedder(),
                 lambda: build_ivf(np.eye(16, dtype=np.float32)),
                 lambda: SegmentedIndex(4, 8),
                 lambda: LLMEngine(smoke_config("qwen3-1.7b")),
                 lambda: build_service(smoke_config("qwen3-1.7b"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert get_device("cpu").type == "cpu"


def test_launcher_rejects_unported_flags(capsys):
    from repro_torch.launch import serve
    for argv in (["--shards", "2"], ["--l1-capacity=8"], ["--bogus"],
                 ["--fused", "--index", "ivf"],
                 ["--fused", "--dyn-index=segmented"]):
        with pytest.raises(SystemExit):
            serve.main(["--device", "cpu", *argv])
    err = capsys.readouterr().err
    assert "does not take yet" in err and "--fused replaces" in err


def test_launcher_serves_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--requests", "24"])
    out = capsys.readouterr().out
    assert "errors                 0" in out and "device cpu" in out


def test_launcher_serves_ivf_segmented_and_fused_on_cpu(capsys):
    from repro_torch.launch import serve
    for argv in (["--index", "ivf", "--dyn-index", "segmented",
                  "--seg-rows", "4", "--compact-every", "2"],
                 ["--fused", "--nprobe", "4"]):
        serve.main(["--device", "cpu", "--requests", "24", *argv])
        out = capsys.readouterr().out
        assert "errors                 0" in out and "device cpu" in out
        assert ("fused-serve(" if "--fused" in argv else "ivf(") in out
