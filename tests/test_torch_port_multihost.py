"""Port parity: multi-host training (parallel/multihost.py) on the CPU.

Processes joined by `initialize_distributed("127.0.0.1:<port>", n, pid,
device="cpu")` over gloo (tests/_torch_mh_worker.py, the JAX worker's data
and configurations: `random_graph_dataset(500, 8, 32, 5, seed=7)`,
32-16-5), every launch started at once by one module fixture:
- (a) the host-sampled driver on 4 processes against the JAX package's own
  worker (tests/_mh_worker.py, launched as is: one process, 4 virtual
  devices) at drop 0 from the JAX initial parameters: per-epoch losses at
  rtol 1e-5 (the batches are the same numpy draws; only summation orders
  differ);
- (b) the whole-graph driver on 2 processes: at drop 0.5, bit for bit the
  port's two-rank `FullBatchTrainer(mesh=...)` run over a FileStore
  (tests/_torch_dp_worker.py `partition_train`); at drop 0, from the JAX
  initial parameters, against the JAX `FullBatchTrainer` on an in-process
  2-device graph mesh at tests/test_torch_port_partition.py's 1e-5;
- (c) the device-sampled driver, without and with SHARD_FEATURES, and (d)
  the *PCMULTI driver on 2 processes, bit for bit the *MULTI engines
  `build_trainer` makes on the same two ranks (PR 11's trainers);
- (e) kill-and-resume of the whole-graph and device-sampled drivers: 2 + 2
  epochs through `multihost_checkpoint_save/restore` equal 4 in one run,
  bit for bit;
- (f) `python -m sgnn_tpu_torch cfg --cpu --coordinator ... --nprocs 1
  --pid 0` exits 0 and logs its final loss.
Every rank reports the same losses.  Then the join's own contract in this
process: no coordinator (one rank), a coordinator without counts, a peer
that never comes (the join fails within its timeout), the checkpoint
pair's files and steps, and `global_mesh`'s layouts.
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sgnn_tpu.config import RunConfig as JRunConfig
from sgnn_tpu.models.gnn import init_model as j_init_model
from sgnn_tpu.parallel.mesh import make_mesh
from sgnn_tpu.sampler.blocks import WeightKind as JWeightKind
from sgnn_tpu.train.fullbatch import FullBatchTrainer as JFullBatchTrainer

from sgnn_tpu_torch.parallel import multihost as mh
from sgnn_tpu_torch.parallel.mesh import DataGroup

from _torch_dp_worker import run_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TORCH_WORKER = os.path.join(HERE, "_torch_mh_worker.py")
JAX_WORKER = os.path.join(HERE, "_mh_worker.py")
RTOL = 1e-5
TIMEOUT_S = 240
FULL_CFG = dict(layer_sizes=[32, 16, 5], fanout=[1, 1], epochs=4,
                learn_rate=0.02, drop_rate=0.5, vertices=500)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="2", **extra)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    return env


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


class _Launch:
    """A process whose output goes to a log file, killed if it outlives
    the fixture's deadline."""

    def __init__(self, argv, log, env):
        self.log = open(log, "w+")
        self.proc = subprocess.Popen(argv, stdout=self.log,
                                     stderr=subprocess.STDOUT, env=env,
                                     cwd=ROOT)

    def wait(self, deadline: float) -> str:
        try:
            self.proc.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.log.seek(0)
        text = self.log.read()
        self.log.close()
        assert self.proc.returncode == 0, text[-4000:]
        return text

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch of the module at once; their results."""
    tmp = tmp_path_factory.mktemp("mh")
    w0 = [np.asarray(w) for w in j_init_model(
        jax.random.PRNGKey(0), "gcn", [32, 16, 5]).weights]
    inp = str(tmp / "inp.npz")
    np.savez(inp, w_n=len(w0), **{f"w{i}": w for i, w in enumerate(w0)})
    launches = {}
    ref_json = str(tmp / "jax_ref.json")
    launches["jax"] = _Launch(
        [sys.executable, JAX_WORKER, "--nprocs", "1", "--pid", "0",
         "--port", str(_free_port()), "--local-devices", "4", "--mode", "dp",
         "--out", ref_json], tmp / "jax.log",
        _env(JAX_PLATFORMS="cpu"))
    outs = {}
    for mode, n in (("dp", 4), ("all", 2)):
        port = _free_port()
        for pid in range(n):
            outs[mode, pid] = str(tmp / mode / f"rank{pid}.npz")
            os.makedirs(os.path.dirname(outs[mode, pid]), exist_ok=True)
            launches[mode, pid] = _Launch(
                [sys.executable, TORCH_WORKER, "--nprocs", str(n), "--pid",
                 str(pid), "--port", str(port), "--mode", mode, "--inp", inp,
                 "--out", outs[mode, pid]], tmp / f"{mode}{pid}.log", _env())
    launches["cli"] = _Launch(
        [sys.executable, "-m", "sgnn_tpu_torch",
         os.path.join(ROOT, "configs", "gcn_cora_fullbatch.cfg"), "--cpu",
         "--epochs", "2", "--coordinator", f"127.0.0.1:{_free_port()}",
         "--nprocs", "1", "--pid", "0"], tmp / "cli.log", _env())
    deadline = time.monotonic() + TIMEOUT_S
    # the FileStore reference of (b) meanwhile, in this process's launcher
    try:
        part = run_ranks("partition_train", {"configs": json.dumps([dict(
            id="full", cfg=FULL_CFG, family="gcn", weight_kind="GCN",
            halo="all_gather", epochs=4)])}, str(tmp), world=2,
            timeout=TIMEOUT_S)
        texts = {k: v.wait(deadline) for k, v in launches.items()}
    finally:   # a failed launch leaves none of the others running
        for launch in launches.values():
            launch.kill()
    return {"w0": w0, "jax_ref": json.load(open(ref_json)),
            "dp": [dict(np.load(outs["dp", r])) for r in range(4)],
            "all": [dict(np.load(outs["all", r])) for r in range(2)],
            "partition": part, "cli_log": texts["cli"]}


def _same_on_every_rank(outs, key):
    for o in outs[1:]:
        np.testing.assert_array_equal(o[key], outs[0][key])


def _weights(out, prefix):
    return [out[f"{prefix}_p{i}"] for i in range(2)]


def test_host_sampled_four_ranks_match_the_jax_driver(runs):
    _same_on_every_rank(runs["dp"], "losses")
    got, ref = runs["dp"][0]["losses"], runs["jax_ref"]
    assert len(got) == len(ref) == 2
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    assert got[-1] < got[0]


def test_fullbatch_two_ranks_are_the_filestore_trainer(runs):
    """Drop 0.5: the driver is bit for bit the two-rank FullBatchTrainer
    run of tests/_torch_dp_worker.py (its per-epoch losses and final
    parameters, each rank)."""
    _same_on_every_rank(runs["all"], "full_losses")
    for rank in range(2):
        out, ref = runs["all"][rank], runs["partition"][rank]
        np.testing.assert_array_equal(out["full_losses"],
                                      ref["full_rows"][:, 0])
        for a, b in zip(_weights(out, "full"), _weights(ref, "full")):
            np.testing.assert_array_equal(a, b)
    losses = runs["all"][0]["full_losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_fullbatch_two_ranks_match_the_jax_graph_mesh(runs):
    """Drop 0, the JAX initial parameters: against the JAX FullBatchTrainer
    on a graph = 2 mesh in this process, 2 epochs."""
    from sgnn_tpu.data.synthetic import random_graph_dataset

    ds = random_graph_dataset(num_vertices=500, avg_degree=8, feature_dim=32,
                              num_classes=5, seed=7)
    mesh = make_mesh(data=1, graph=2, devices=jax.devices()[:2])
    jt = JFullBatchTrainer(JRunConfig(**dict(FULL_CFG, drop_rate=0.0)), ds,
                           family="gcn", weight_kind=JWeightKind.GCN,
                           mesh=mesh, halo="all_gather")
    for a, b in zip(jt.params.weights, runs["w0"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    ref = [jt.train_epoch()[0] for _ in range(2)]
    _same_on_every_rank(runs["all"], "full0_losses")
    out = runs["all"][0]
    assert _rel(out["full0_losses"], ref) <= RTOL
    for a, b in zip(_weights(out, "full0"), jt.params.weights):
        assert _rel(a, b) <= RTOL


def test_fullbatch_kill_and_resume_is_one_run(runs):
    for out in runs["all"]:
        np.testing.assert_array_equal(out["full_resumed_losses"],
                                      out["full_losses"])
        for a, b in zip(_weights(out, "full_resumed"),
                        _weights(out, "full")):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tag", ["device", "device_sf"])
def test_device_dp_is_the_allmulti_engine(runs, tag):
    """The device-sampled driver, replicated and row-sharded features, bit
    for bit the GCNSAMPLEALLMULTI engine on the same two ranks."""
    _same_on_every_rank(runs["all"], f"{tag}_losses")
    for out in runs["all"]:
        assert str(out[f"{tag}_engine_type"]) == "DeviceDataParallelTrainer"
        np.testing.assert_array_equal(out[f"{tag}_losses"],
                                      out[f"{tag}_engine_losses"])
        for a, b in zip(_weights(out, tag), _weights(out, f"{tag}_engine")):
            np.testing.assert_array_equal(a, b)
    losses = runs["all"][0][f"{tag}_losses"]
    assert len(losses) == 4 and losses[-1] < losses[0]


def test_device_dp_kill_and_resume_is_one_run(runs):
    for out in runs["all"]:
        np.testing.assert_array_equal(out["device_resumed_losses"],
                                      out["device_losses"])
        for a, b in zip(_weights(out, "device_resumed"),
                        _weights(out, "device")):
            np.testing.assert_array_equal(a, b)


def test_pcmulti_is_the_pcmulti_engine(runs):
    _same_on_every_rank(runs["all"], "pcmulti_losses")
    for out in runs["all"]:
        assert (str(out["pcmulti_engine_type"])
                == "DeviceCachedDataParallelTrainer")
        np.testing.assert_array_equal(out["pcmulti_losses"],
                                      out["pcmulti_engine_losses"])
        for a, b in zip(_weights(out, "pcmulti"),
                        _weights(out, "pcmulti_engine")):
            np.testing.assert_array_equal(a, b)
        assert 0 < float(out["pcmulti_hit_rate"]) < 1
    losses = runs["all"][0]["pcmulti_losses"]
    assert losses[-1] < losses[0]


def test_cli_coordinator_trains_the_fullbatch_cfg(runs):
    log = runs["cli_log"]
    assert "run_multihost_fullbatch_epochs epoch 1 (1 ranks)" in log
    assert "multihost final loss:" in log


# ------------------------------------------------------ in this process --
@pytest.fixture
def no_group():
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_no_coordinator_joins_one_rank(no_group):
    assert mh.initialize_distributed(device="cpu") == (0, 1)
    # an initialised group is kept
    assert mh.initialize_distributed("127.0.0.1:1", 2, 1,
                                     device="cpu") == (0, 1)
    group = mh.global_mesh(device="cpu")
    assert isinstance(group, DataGroup) and group.world_size == 1
    assert mh.global_mesh(graph=1, data=1, device="cpu").graph == 1
    with pytest.raises(ValueError, match="data=2"):
        mh.global_mesh(data=2, device="cpu")


def test_coordinator_needs_the_counts(no_group):
    with pytest.raises(ValueError, match="num_processes"):
        mh.initialize_distributed("127.0.0.1:1", None, 0, device="cpu")
    assert not dist.is_initialized()


def test_a_missing_peer_fails_the_join(no_group):
    t0 = time.monotonic()
    with pytest.raises(Exception, match="[Tt]imed out"):
        mh.initialize_distributed(f"127.0.0.1:{_free_port()}", 2, 0,
                                  device="cpu", timeout_s=2)
    assert time.monotonic() - t0 < 30
    assert not dist.is_initialized()


def test_checkpoint_files_and_steps(tmp_path):
    assert mh.multihost_checkpoint_restore(str(tmp_path / "none")) is None
    for step in (1, 3):
        path = mh.multihost_checkpoint_save(
            str(tmp_path), step, {"params": {"weights": [torch.full(
                (2, 2), float(step))]}, "kind": "adam", "step": step})
        assert os.path.basename(path) == f"step_{step}.pt"
    got = mh.multihost_checkpoint_restore(str(tmp_path))
    assert got["step"] == 3 and got["state"]["step"] == 3
    assert torch.equal(got["state"]["params"]["weights"][0],
                       torch.full((2, 2), 3.0))
    assert mh.multihost_checkpoint_restore(str(tmp_path), 1)["step"] == 1
    with pytest.raises(FileNotFoundError, match="step 2"):
        mh.multihost_checkpoint_restore(str(tmp_path), 2)
    assert sorted(os.listdir(tmp_path)) == ["step_1.pt", "step_3.pt"]


def test_epoch_seeds_are_the_jax_split():
    """The JAX driver's epoch order and split (sgnn_tpu/parallel/
    multihost.py:163-180): every train id once, shards of np.array_split,
    the shorter shards' last steps empty."""
    nids = np.arange(10, 110, dtype=np.int32)
    per_rank = [mh.multihost_epoch_seeds(0, nids, 8, 1, r, 3)
                for r in range(3)]
    order = np.random.default_rng((0, 11, 1)).permutation(nids)
    shards = np.array_split(order, 3)
    for r, chunks in enumerate(per_rank):
        assert len(chunks) == 5        # ceil(34 / 8) for every rank
        np.testing.assert_array_equal(np.concatenate(chunks), shards[r])
    assert per_rank[2][-1].size == 33 - 32
    a = mh.multihost_step_rng(0, 1, 2, 3).integers(0, 1 << 30, 4)
    b = np.random.default_rng((0, 13, 1, 2, 3)).integers(0, 1 << 30, 4)
    np.testing.assert_array_equal(a, b)
