"""Port isolation: sgnn_tpu_torch, chip_smoke.py, the port's scripts and
its multi-host test worker import neither JAX nor the JAX package, every
port module imports with both blocked, and the entry points run on CUDA
unless the caller asks for the CPU."""

import ast
import dataclasses
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import sgnn_tpu_torch
from sgnn_tpu_torch.cache import EmbeddingCache, FeatureCache
from sgnn_tpu_torch.graph.adjacency import Adjacency
from sgnn_tpu_torch.models.gnn import init_model, params_from_numpy
from sgnn_tpu_torch.ops.probes import (  # noqa: F401 (import checked)
    gat_tile, gather_sum, shuffle, tile_gather, tile_part_args, tile_spmm,
)
from sgnn_tpu_torch.ops.segment import csr_from_numpy
from sgnn_tpu_torch.parallel.mesh import make_group
from sgnn_tpu_torch.config import RunConfig
from sgnn_tpu_torch.sampler.blocks import WeightKind
from sgnn_tpu_torch.sampler.native import build as native_build
from sgnn_tpu_torch.train import FullBatchTrainer, build_trainer, run_engine
from sgnn_tpu_torch.train.inference import (
    InferenceServer, exact_accuracy, layerwise_inference,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "sgnn_tpu_torch"
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "scripts").glob("torch_*.py"))
         + [ROOT / "tests" / "_torch_mh_worker.py"])


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "sgnn_tpu") or top.startswith("jax")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_sgnn_tpu_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_port_module_imports_with_jax_blocked():
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['sgnn_tpu'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
            f"print(len({mods!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) == len(mods) >= 30
    # the training and GAT slices' modules are among them
    assert {"sgnn_tpu_torch.sampler.native", "sgnn_tpu_torch.sampler.host",
            "sgnn_tpu_torch.sampler.device", "sgnn_tpu_torch.ops.aggregate",
            "sgnn_tpu_torch.ops.cuda.gather_agg", "sgnn_tpu_torch.nn.optim",
            "sgnn_tpu_torch.train.trainer", "sgnn_tpu_torch.train.engines",
            "sgnn_tpu_torch.train.device_trainer", "sgnn_tpu_torch.ops.gat",
            "sgnn_tpu_torch.ops.cuda.gat", "sgnn_tpu_torch.ops.reductions",
            "sgnn_tpu_torch.ops.cuda.gat_bwd",
            "sgnn_tpu_torch.train.fullbatch", "sgnn_tpu_torch.ops.probes",
            "sgnn_tpu_torch.ops.cuda.probes", "sgnn_tpu_torch.cache",
            "sgnn_tpu_torch.cache.hotness",
            "sgnn_tpu_torch.cache.embedding_cache",
            "sgnn_tpu_torch.cache.feature_cache",
            "sgnn_tpu_torch.cache.orchestrator",
            "sgnn_tpu_torch.train.device_cached",
            "sgnn_tpu_torch.parallel", "sgnn_tpu_torch.parallel.mesh",
            "sgnn_tpu_torch.parallel.dp",
            "sgnn_tpu_torch.parallel.dp_device",
            "sgnn_tpu_torch.parallel.sharded_features",
            "sgnn_tpu_torch.parallel.multihost",
            "sgnn_tpu_torch.graph.reorder", "sgnn_tpu_torch.data.ogb"} <= set(mods)


def test_native_sampler_builds_inside_the_checkout():
    assert native_build.BUILD_DIR == ROOT / "build" / "native"
    assert native_build.SRC.parent == PORT / "sampler" / "native"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(no_cuda, tiny_ds):
    adj = Adjacency.from_edges(tiny_ds.edges, tiny_ds.num_vertices)
    p = init_model(0, "gcn", [32, 16, 5], device="cpu")
    g = init_model(0, "gat", [32, 16, 5], device="cpu")
    f = tiny_ds.features
    cfg = RunConfig(algorithm="GCNSAMPLEGPU", layer_sizes=[32, 16, 5],
                    fanout=[4, 3], batch_size=64)
    for call in (
        lambda: sgnn_tpu_torch.resolve_device(None),
        lambda: sgnn_tpu_torch.resolve_device("cuda:0"),
        lambda: InferenceServer(p, "gcn", adj, f),
        lambda: InferenceServer(g, "gat", adj, f, heads=4),
        lambda: layerwise_inference(p, "gcn", adj, f),
        lambda: exact_accuracy(p, "gcn", adj, f, tiny_ds.labels,
                               np.arange(4)),
        lambda: init_model(0, "gcn", [32, 16, 5]),
        lambda: params_from_numpy([np.ones((2, 2), np.float32)]),
        lambda: csr_from_numpy(np.array([0, 1]), np.array([0]),
                               np.ones(1), 1),
        lambda: build_trainer(cfg, tiny_ds),
        lambda: run_engine(cfg, tiny_ds, epochs=1),
        lambda: build_trainer(RunConfig(
            algorithm="GSSAMPLEALLGPU", layer_sizes=[32, 16, 5],
            fanout=[4, 3], batch_size=64), tiny_ds),
        lambda: run_engine(RunConfig(
            algorithm="GATSAMPLEALLGPU", layer_sizes=[32, 16, 5],
            fanout=[4, 3], batch_size=64, heads=4), tiny_ds, epochs=1),
        lambda: build_trainer(RunConfig(
            algorithm="GCNFULLBATCH", layer_sizes=[32, 16, 5]), tiny_ds),
        lambda: run_engine(RunConfig(
            algorithm="GATFULLBATCH", layer_sizes=[32, 16, 5], heads=4),
            tiny_ds, epochs=1),
        lambda: FullBatchTrainer(RunConfig(layer_sizes=[32, 16, 5],
                                           aggregator="max"), tiny_ds),
        # the cached engines, both routes, and the caches themselves
        lambda: build_trainer(dataclasses.replace(
            cfg, algorithm="GSSAMPLECACHE"), tiny_ds),
        lambda: run_engine(dataclasses.replace(
            cfg, algorithm="GCNSAMPLEPDCACHE", pd_refresh="host"), tiny_ds,
            epochs=1),
        lambda: build_trainer(dataclasses.replace(
            cfg, feature_cache_rate=0.2, hbm_budget=1000), tiny_ds),
        lambda: EmbeddingCache.build(adj, np.arange(4), WeightKind.GCN),
        lambda: FeatureCache.build(f, np.arange(4)),
        # the *MULTI engines and their process group
        lambda: build_trainer(dataclasses.replace(
            cfg, algorithm="GCNSAMPLEALLMULTI"), tiny_ds),
        lambda: run_engine(dataclasses.replace(
            cfg, algorithm="GCNSAMPLEPCMULTI", pd_refresh="host"), tiny_ds,
            epochs=1),
        lambda: make_group(),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _run_chip_smoke(cwd, env_extra=None):
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_chip_smoke_fails_without_a_card():
    out = _run_chip_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_chip_smoke(tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("script", ["torch_probe_gather.py",
                                    "torch_probe_tile_spmm.py",
                                    "torch_probe_gat_tile.py",
                                    "torch_gat_sampled.py"])
def test_probe_scripts_raise_without_a_card(script):
    import os

    out = subprocess.run([sys.executable, str(ROOT / "scripts" / script)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "ns/" not in out.stdout
