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
assert {{"repro_torch.models.recsys", "repro_torch.launch.workloads",
        "repro_torch.kernels.embedding_bag.kernel",
        "repro_torch.core.simulate", "repro_torch.data.synth_traces",
        "repro_torch.launch.calibrate", "repro_torch.core.freshness",
        "repro_torch.core.promo_wal", "repro_torch.core.adaptive",
        "repro_torch.distributed.checkpoint",
        "repro_torch.serving.persist", "repro_torch.launch.mesh",
        "repro_torch.index.sharded",
        "repro_torch.launch.cache_workload",
        "repro_torch.training.optimizer", "repro_torch.training.train_loop",
        "repro_torch.distributed.overlap",
        "repro_torch.models.moe", "repro_torch.models.gnn",
        "repro_torch.data.graph_data", "repro_torch.data.lm_data",
        "repro_torch.launch.train"}} <= set(mods), mods
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
    from repro_torch.kernels.embedding_bag import kernel as bag_kernel
    from repro_torch.launch.workloads import build_workload
    from repro_torch.models import recsys
    from repro_torch.index.segmented import SegmentedIndex
    from repro_torch.serving.engine import LLMEngine
    from repro_torch.core.simulate import simulate
    from repro_torch.core.tiers import CacheConfig
    from repro_torch.launch import calibrate
    from repro_torch.core.adaptive import _default_shadow_eval
    from repro_torch.serving import persist
    from repro_torch.launch import cache_workload
    from repro_torch.launch.mesh import make_shard_mesh
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.workloads import build_lm
    from repro_torch.configs import get_shape
    lm_cfg = smoke_config("qwen3-1.7b")
    eye = np.eye(4, dtype=np.float32)
    snap = persist.Snapshot(
        step=0, path=ROOT, tree={"ivf": {
            "centroids": eye[:1], "codes": np.ones((1, 4, 4), np.int8),
            "scales": np.ones((1, 4), np.float32),
            "row_ids": np.arange(4, dtype=np.int32)[None]}},
        extra={"ivf": {"nprobe": 1, "n_candidates": 1,
                       "corpus_hash": persist.state_hash(eye)}})
    for call in (lambda: get_device(), lambda: make_dynamic_tier(4, 8),
                 lambda: make_static_tier(np.eye(4), np.arange(4)),
                 lambda: Embedder(),
                 lambda: build_ivf(np.eye(16, dtype=np.float32)),
                 lambda: SegmentedIndex(4, 8),
                 lambda: LLMEngine(smoke_config("qwen3-1.7b")),
                 lambda: build_service(smoke_config("qwen3-1.7b")),
                 lambda: build_service(smoke_config("qwen2-moe-a2.7b")),
                 lambda: recsys.init_params(smoke_config("wide-deep")),
                 lambda: recsys.batch_from_numpy({"x": np.zeros(2)}),
                 lambda: build_workload("wide-deep", "serve_p99"),
                 lambda: build_workload("sasrec", "train_batch"),
                 lambda: simulate(np.eye(4, dtype=np.float32), np.arange(4),
                                  np.eye(4, dtype=np.float32), np.arange(4),
                                  CacheConfig(0.9, 0.9, capacity=4), True),
                 lambda: calibrate.main(["--fixed", "lmarena_like"]),
                 lambda: build_service(smoke_config("qwen3-1.7b"),
                                       l1_capacity=8, rewrite=True),
                 lambda: _default_shadow_eval(
                     eye, np.arange(4), eye, np.arange(4),
                     [CacheConfig(0.9, 0.9, capacity=4)]),
                 lambda: persist.load_static_index(snap, eye),
                 lambda: make_shard_mesh(2),
                 lambda: cache_workload.run_live(n_requests=4),
                 lambda: build_workload("graphsage-reddit", "molecule"),
                 lambda: build_workload("qwen3-1.7b", "train_4k", batch=1),
                 lambda: build_lm(lm_cfg, get_shape(lm_cfg, "decode_32k")),
                 lambda: launch_train.main(["--smoke", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the kernel wrapper takes CUDA tensors only; CPU ones are refused
    with pytest.raises(ValueError, match="CUDA"):
        bag_kernel.embedding_bag(torch.zeros(4, 2),
                                 torch.zeros(1, 1, dtype=torch.int32),
                                 torch.ones(1, 1))
    assert get_device("cpu").type == "cpu"
    # the device-free modules of the operability layer run without a card
    from repro_torch.core import freshness, promo_wal
    from repro_torch.distributed import checkpoint
    assert freshness.classify("price of gold now") == freshness.VOLATILE
    rec = promo_wal.encode_record(eye[1], 0, 1)
    assert np.array_equal(promo_wal.decode_vector(rec), eye[1])
    assert checkpoint._leaf_paths({"b": {"y": eye, "x": 1}, "a": eye})[0][0] \
        == "a"


def test_launcher_rejects_unported_flags(capsys):
    """Every flag of the JAX launcher is taken now: an unknown flag and
    --fused with another lookup option are refused; --l1-capacity and
    --shards, once refused, serve on the CPU."""
    from repro_torch.launch import serve
    for argv in (["--bogus"], ["--fused", "--index", "ivf"],
                 ["--fused", "--dyn-index=segmented"],
                 ["--fused", "--shards", "2"]):
        with pytest.raises(SystemExit):
            serve.main(["--device", "cpu", *argv])
    err = capsys.readouterr().err
    assert "unrecognized arguments: --bogus" in err
    assert "--fused replaces" in err and "does not take yet" not in err
    s = serve.main(["--device", "cpu", "--requests", "24",
                    "--l1-capacity=8"])
    out = capsys.readouterr().out
    assert "errors                 0" in out and "l1 front tier: 8" in out
    assert s["errors"] == 0 and s["l1_puts"] + s["l1_hits"] == 24
    s = serve.main(["--device", "cpu", "--requests", "24", "--shards", "2"])
    out = capsys.readouterr().out
    assert "errors                 0" in out and "shards: 2 on cpu, cpu" in out
    assert s["errors"] == 0 and s["shards"] == 2
    assert len(s["shard_occupancy"]) == 2 and sum(s["shard_occupancy"]) > 0


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
