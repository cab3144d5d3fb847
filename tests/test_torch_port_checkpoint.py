"""Port checkpoints (train/checkpoint.py): one torch-native format, loaded
with `torch.load(weights_only=True)`; the cases of tests/test_aux.py:20-177
and :308-337 on the port's trainers, on the CPU.

A resumed run equals an uninterrupted one bit for bit: the checkpoint
holds the parameters, the optimizer state and every random stream the next
epoch draws from (the host sampler's numpy PCG64, which also permutes the
epoch, the dropout generator, and the device sampler's generator).  The
cached and data-parallel engines of tests/test_aux.py wait for ROADMAP
Queue 1 items 5 and 6.
"""

import os

import numpy as np
import pytest
import torch

from sgnn_tpu.train.checkpoint import encode_np_rng as j_encode_np_rng

from sgnn_tpu_torch.config import RunConfig
from sgnn_tpu_torch.train import build_trainer
from sgnn_tpu_torch.train.checkpoint import (
    STATE_FILE, CheckpointManager, decode_np_rng, encode_np_rng,
    run_with_checkpointing,
)
from sgnn_tpu_torch.train.guard import DivergenceError
from sgnn_tpu_torch.train.trainer import SampleTrainer


def _cfg(ds, **kw):
    return RunConfig(**dict(dict(layer_sizes=[32, 16, 5], fanout=[4, 3],
                                 batch_size=64, epochs=4, drop_rate=0.3,
                                 vertices=ds.num_vertices), **kw))


@pytest.fixture()
def trainer(tiny_ds):
    return SampleTrainer(_cfg(tiny_ds, drop_rate=0.0), tiny_ds,
                         family="gcn", device="cpu")


def test_checkpoint_roundtrip(tmp_path, trainer):
    trainer.train_epoch()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    path = mgr.save(0, trainer)
    assert path == os.path.join(str(tmp_path / "ckpt"), "step_0", STATE_FILE)
    w_before = trainer.params.weights[0].clone()
    trainer.train_epoch()                      # mutate
    assert not torch.equal(trainer.params.weights[0], w_before)
    assert mgr.restore(trainer, 0) == 0
    assert torch.equal(trainer.params.weights[0], w_before)
    with pytest.raises(FileNotFoundError, match="step 7"):
        mgr.restore(trainer, 7)


def test_checkpoint_latest_and_prune(tmp_path, trainer):
    mgr = CheckpointManager(str(tmp_path / "c2"), max_to_keep=2)
    assert mgr.steps() == [] and mgr.restore(trainer) is None
    for s in range(4):
        trainer.train_epoch()
        mgr.save(s, trainer)
    assert mgr.steps() == [2, 3]
    assert sorted(os.listdir(mgr.directory)) == ["step_2", "step_3"]
    assert mgr.restore(trainer) == 3


def test_checkpoint_loads_weights_only(tmp_path, trainer):
    """The file holds tensors, lists, ints and strings only: the safe
    loader reads it, and every tensor is on the CPU."""
    trainer.train_epoch()
    path = CheckpointManager(str(tmp_path)).save(5, trainer)
    state = torch.load(path, map_location="cpu", weights_only=True)
    assert set(state) == {"params", "opt_state", "dropout_rng", "host_rng"}
    assert state["opt_state"]["kind"] == "adam"
    assert state["opt_state"]["step"] == trainer.opt_state.step
    assert state["host_rng"].dtype == torch.uint64
    tensors = [*state["params"]["weights"], *state["opt_state"]["m"],
               *state["opt_state"]["v"], state["dropout_rng"]]
    assert all(t.device.type == "cpu" for t in tensors)


def test_checkpoint_of_another_model_is_refused(tmp_path, tiny_ds, trainer):
    CheckpointManager(str(tmp_path)).save(0, trainer)
    other = SampleTrainer(_cfg(tiny_ds, layer_sizes=[32, 8, 5]), tiny_ds,
                          family="gcn", device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        CheckpointManager(str(tmp_path)).restore(other)


def test_numpy_rng_state_survives():
    """encode/decode are the JAX package's (same six words for the same
    state), and a restored generator draws what the original draws."""
    rng = np.random.default_rng(1234)
    rng.random(7)
    rng.integers(0, 10, dtype=np.uint32)    # leaves a cached uint32
    enc = encode_np_rng(rng)
    np.testing.assert_array_equal(enc, j_encode_np_rng(rng))
    expect = rng.random(5)
    other = np.random.default_rng(0)
    decode_np_rng(other, torch.from_numpy(enc))
    np.testing.assert_array_equal(other.random(5), expect)


def _resume_equivalence(make_trainer, tmp_path):
    """Train 2 epochs, checkpoint, train 2 more; a fresh trainer restored
    from the checkpoint and trained 2 epochs lands on identical params."""
    a = make_trainer()
    a.train_epoch()
    a.train_epoch()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, a)
    a.train_epoch()
    a.train_epoch()
    b = make_trainer()
    assert mgr.restore(b) == 1
    b.train_epoch()
    b.train_epoch()
    pa = getattr(a, "base", a).params.leaves()
    pb = getattr(b, "base", b).params.leaves()
    assert len(pa) == len(pb)
    for x, y in zip(pa, pb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("algo", ["GCNSAMPLEGPU", "GSSAMPLEALLGPU",
                                  "GCNFULLBATCH", "GATSAMPLEALLGPU"])
def test_resume_equivalence(tmp_path, tiny_ds, algo):
    def make():
        return build_trainer(_cfg(tiny_ds, algorithm=algo,
                                  heads=2 if algo.startswith("GAT") else 1),
                             tiny_ds, device="cpu")

    _resume_equivalence(make, tmp_path)


def test_resume_equivalence_int8(tmp_path, tiny_ds):
    """int8 features change nothing in the resumed state."""
    def make():
        return build_trainer(_cfg(tiny_ds, algorithm="GSSAMPLEALLGPU",
                                  feature_dtype="int8"), tiny_ds,
                             device="cpu")

    _resume_equivalence(make, tmp_path)


def test_run_with_checkpointing_resumes(tmp_path, tiny_ds):
    """4 epochs in one call equal 2 epochs, then a resumed call to 4: the
    same parameters and the same losses for epochs 2-3."""
    def make():
        return build_trainer(_cfg(tiny_ds, algorithm="GSSAMPLEALLGPU"),
                             tiny_ds, device="cpu")

    full = run_with_checkpointing(make(), str(tmp_path / "a"), 4)
    assert len(full.losses) == 4 and len(full.val_acc) == 4
    first = run_with_checkpointing(make(), str(tmp_path / "b"), 2)
    b = make()
    rest = run_with_checkpointing(b, str(tmp_path / "b"), 4)
    assert len(first.losses) == 2 and rest.losses == full.losses[2:]
    a = make()
    CheckpointManager(str(tmp_path / "a")).restore(a)
    for x, y in zip(a.params.leaves(), b.params.leaves()):
        assert torch.equal(x, y)
    assert run_with_checkpointing(b, str(tmp_path / "b"), 4).losses == []


def test_divergence_guard_preserves_last_checkpoint(tmp_path, trainer):
    """The guard fires before the save, so a diverged epoch never
    overwrites the last good checkpoint, and the error names it."""
    real = trainer.train_epoch
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] >= 3:   # epochs 0 and 1 fine; epoch 2 diverges
            return float("nan"), 0.0, 0
        return real()

    trainer.train_epoch = flaky
    with pytest.raises(DivergenceError) as ei:
        run_with_checkpointing(trainer, str(tmp_path), epochs=5,
                               resume=False)
    assert ei.value.epoch == 2 and ei.value.last_good_epoch == 1
    assert "resume" in str(ei.value)
    trainer.train_epoch = real
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.steps() == [0, 1] and mgr.restore(trainer) == 1
