"""Port CLI: `python -m sgnn_tpu_torch cfg` (sgnn_tpu_torch/__main__.py)
against the JAX package's `python -m sgnn_tpu cfg`, on Cora, on the CPU
(`--cpu`).

The train → checkpoint → `--infer` workflow and the exit codes follow
tests/test_aux.py:339-411; `--report-out` writes the JAX report's keys,
which scripts/summarize_runs.py reads from both packages' reports; the
multi-host options of ROADMAP Queue 1 item 6 exit non-zero naming their
item (the *MULTI engines train on a one-rank group); `.estimator_advice`
is the JAX trainer's on the same cfg.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from sgnn_tpu.__main__ import main as j_main
from sgnn_tpu.config import load_cfg as j_load_cfg
from sgnn_tpu.train.engines import build_trainer as j_build_trainer

from sgnn_tpu_torch.__main__ import main
from sgnn_tpu_torch.config import load_cfg
from sgnn_tpu_torch.train import build_trainer
from sgnn_tpu_torch.utils.logging import get_logger

ROOT = os.path.join(os.path.dirname(__file__), "..")
DATA = os.path.join(ROOT, "data")
CONFIGS = os.path.join(ROOT, "configs")


def _cfg_file(tmp_path, name, algorithm, **extra):
    lines = [f"ALGORITHM:{algorithm}", "VERTICES:2708", "LAYERS:1433-32-7",
             "FANOUT:10-5", "BATCH_SIZE:1024", "EPOCHS:2",
             f"EDGE_FILE:{DATA}/cora.2708.edge.self",
             f"FEATURE_FILE:{DATA}/cora.featuretable",
             f"LABEL_FILE:{DATA}/cora.labeltable",
             f"MASK_FILE:{DATA}/cora.mask", "LEARN_RATE:0.01",
             "DROP_RATE:0.0"] + [f"{k}:{v}" for k, v in extra.items()]
    path = tmp_path / name
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture()
def cli_log(caplog):
    """The CLI logger's records (its handler writes to stderr and does not
    propagate)."""
    log = get_logger("sgnn.cli")   # its own handler first, whatever ran
    log.addHandler(caplog.handler)
    yield caplog
    log.removeHandler(caplog.handler)


@pytest.mark.parametrize("algorithm", ["GCNSAMPLEGPU", "GCNFULLBATCH"])
def test_cli_train_checkpoint_then_infer(tmp_path, algorithm):
    extra = {"BATCH_NORM": 1} if algorithm == "GCNFULLBATCH" else {}
    cfg = _cfg_file(tmp_path, "cli.cfg", algorithm, **extra)
    ckpt = tmp_path / "ckpt"
    report = tmp_path / "r.json"
    assert main([cfg, "--cpu", "--checkpoint-dir", str(ckpt),
                 "--report-out", str(report)]) == 0
    assert sorted(os.listdir(ckpt)) == ["step_0", "step_1"]
    assert len(json.loads(report.read_text())["losses"]) == 2
    preds = tmp_path / "preds.npy"
    assert main([cfg, "--cpu", "--infer", str(ckpt),
                 "--predictions-out", str(preds)]) == 0
    logp = np.load(preds)
    assert logp.shape == (2708, 7) and np.isfinite(logp).all()
    np.testing.assert_allclose(np.exp(logp).sum(axis=1), 1.0, atol=1e-3)
    # --infer on an empty directory fails cleanly
    assert main([cfg, "--cpu", "--infer", str(tmp_path / "nope")]) == 1


def test_cli_resume_continues_at_the_next_epoch(tmp_path):
    cfg = _cfg_file(tmp_path, "gs.cfg", "GSSAMPLEALLGPU")
    ckpt, report = str(tmp_path / "ck"), tmp_path / "r.json"
    assert main([cfg, "--cpu", "--epochs", "2", "--checkpoint-dir",
                 ckpt]) == 0
    assert main([cfg, "--cpu", "--epochs", "3", "--checkpoint-dir", ckpt,
                 "--resume", "--report-out", str(report)]) == 0
    rec = json.loads(report.read_text())
    assert len(rec["epoch_times"]) == 1      # epoch 2 (the third) only
    assert os.listdir(ckpt) and "step_2" in os.listdir(ckpt)


def test_cli_report_keys_equal_jax(tmp_path):
    cfg = _cfg_file(tmp_path, "rep.cfg", "GCNSAMPLEGPU", EPOCHS=1)
    mine, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    assert main([cfg, "--cpu", "--report-out", str(mine)]) == 0
    assert j_main([cfg, "--report-out", str(theirs)]) == 0
    a, b = json.loads(mine.read_text()), json.loads(theirs.read_text())
    assert set(a) == set(b)
    assert set(a["phase_totals_s"]) <= set(b["phase_totals_s"]) | {
        "transfer"}
    out = subprocess.run([sys.executable,
                          os.path.join(ROOT, "scripts", "summarize_runs.py"),
                          str(mine), str(theirs)],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    rows = out.stdout.strip().splitlines()
    assert len(rows) == 3 and all("GCNSAMPLEGPU" in r for r in rows[1:])


def test_cli_exact_eval_and_profile(tmp_path, cli_log):
    cfg = _cfg_file(tmp_path, "fb.cfg", "GCNFULLBATCH")
    trace_dir = tmp_path / "trace"
    assert main([cfg, "--cpu", "--exact-eval", "--profile",
                 str(trace_dir)]) == 0
    assert (trace_dir / "trace.json").stat().st_size > 0
    assert any("exact (full-neighborhood) eval" in r.getMessage()
               for r in cli_log.records)
    cfg = _cfg_file(tmp_path, "gat.cfg", "GATSAMPLEALLGPU", HEADS=2,
                    LAYERS="1433-16-7")
    assert main([cfg, "--cpu", "--exact-eval", "--epochs", "1"]) == 0


def test_cli_unported_items_exit_nonzero(tmp_path, cli_log):
    """The PD-cache cfg (item 5) and a *MULTI cfg (item 6a, a one-rank
    group that the call makes and ends) train; so do the multi-host flags
    (item 6c): `--coordinator` joins its one rank over TCP and trains with
    the host-sampled driver (GCNSAMPLEGPU), logging the final loss, and
    `--nprocs` or `--pid` alone are ignored, as in the JAX CLI.  Only bad
    arguments exit nonzero."""
    import socket

    import torch.distributed as dist

    pd = os.path.join(CONFIGS, "gcn_cora_sample.cfg")
    assert main([pd, "--cpu", "--epochs", "1"]) == 0
    multi = _cfg_file(tmp_path, "multi.cfg", "GCNSAMPLEPCMULTI",
                      PIPELINE_NUM=2)
    assert main([multi, "--cpu", "--epochs", "2"]) == 0
    assert not dist.is_initialized()
    assert sum(r.getMessage().startswith("final: train")
               for r in cli_log.records) == 2
    assert not any("item" in r.getMessage() for r in cli_log.records)
    cli_log.clear()
    cfg = _cfg_file(tmp_path, "mh.cfg", "GCNSAMPLEGPU")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert main([cfg, "--cpu", "--coordinator", f"127.0.0.1:{port}",
                 "--nprocs", "1", "--pid", "0"]) == 0
    assert not dist.is_initialized()
    assert sum(r.getMessage().startswith("multihost final loss")
               for r in cli_log.records) == 1
    cli_log.clear()
    for flags in (["--nprocs", "2"], ["--pid", "0"]):
        assert main([cfg, "--cpu", *flags]) == 0
    assert sum(r.getMessage().startswith("final: train")
               for r in cli_log.records) == 2
    assert not any("multihost" in r.getMessage() or "item" in r.getMessage()
                   for r in cli_log.records)
    with pytest.raises(SystemExit) as ei:
        main([cfg, "--epochs", "x"])
    assert ei.value.code == 2


def test_cli_module_runs_without_jax_and_needs_a_card(tmp_path):
    """`python -m sgnn_tpu_torch` in its own process: trains on the CPU
    with --cpu (JAX never imported), and fails without a card otherwise."""
    cfg = _cfg_file(tmp_path, "m.cfg", "GCNSAMPLEGPU", EPOCHS=1)
    code = ("import sys, runpy\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['sgnn_tpu'] = None\n"
            "sys.argv = ['sgnn_tpu_torch', *sys.argv[1:]]\n"
            "runpy.run_module('sgnn_tpu_torch', run_name='__main__')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    ok = subprocess.run([sys.executable, "-c", code, cfg, "--cpu"], cwd=ROOT,
                        capture_output=True, text=True, timeout=300, env=env)
    assert ok.returncode == 0, ok.stderr
    assert "final: train" in ok.stderr
    no_card = subprocess.run([sys.executable, "-m", "sgnn_tpu_torch", cfg],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=300, env=env)
    assert no_card.returncode != 0
    assert "no CUDA device" in no_card.stderr


@pytest.mark.parametrize("name,batch", [("gs_cora_sample.cfg", None),
                                        ("gat_cora_sample.cfg", 8)])
def test_estimator_advice_equals_jax(cora, name, batch):
    path = os.path.join(CONFIGS, name)
    cfg, jcfg = load_cfg(path), j_load_cfg(path)
    if batch:
        cfg.batch_size = jcfg.batch_size = batch
    got = build_trainer(cfg, cora, device="cpu").estimator_advice
    assert got == j_build_trainer(jcfg, cora).estimator_advice
    assert (got is None) == (batch is not None)


def test_npy_io_and_profiling_helpers(tmp_path):
    """utils/io.py's save_npy (the CLI's --predictions-out) reads back with
    numpy and with the JAX package's load_npy; utils/profiling.py's budget
    (a fixed one on the CPU, where no allocator reports free memory)."""
    import torch

    from sgnn_tpu.utils.io import load_npy as j_load_npy

    from sgnn_tpu_torch.utils.io import save_npy
    from sgnn_tpu_torch.utils.profiling import CPU_BUDGET_BYTES, memory_budget

    rng = np.random.default_rng(0)
    for arr in (rng.standard_normal((37, 11)).astype(np.float32),
                rng.integers(-5, 5, size=(64,)).astype(np.int32),
                np.asfortranarray(rng.standard_normal((5, 3)))):
        save_npy(str(tmp_path / "a.npy"), arr)
        np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), arr)
        np.testing.assert_array_equal(j_load_npy(str(tmp_path / "a.npy")),
                                      arr)
    cpu = torch.device("cpu")
    assert memory_budget(cpu) == CPU_BUDGET_BYTES
    assert memory_budget(cpu, 1234) == 1234
