"""Port parity, host-sampled data parallelism and its collectives on the CPU.

Two-rank groups are two processes of tests/_torch_dp_worker.py joined by
gloo over a FileStore in tmp_path (no TCP port, so the tests run side by
side under xdist); each worker imports no JAX and is killed after 120 s.

- The grad-sum step, after tests/test_train.py:72-110: two JAX host-sampled
  batches go through JAX `make_dp_step` on a 2-device mesh; the same
  blocks, carried to two port ranks, give the same new parameters at that
  test's tolerance (the sign of Adam's first step on a near-zero summed
  gradient follows the reduction order), and the same per-rank loss (f32
  rtol 1e-5, tests/test_ops.py:47) and (correct, count).
- `DataParallelTrainer` over `SampleTrainer`, and over the host cached
  trainer with one global hot set (GCNSAMPLEPCMULTI under PD_REFRESH:host),
  two port ranks against the JAX wrapper on a 2-device mesh for 2 epochs
  at drop 0 from the same weights: each rank's host sampler draws what the
  JAX device of its rank draws, so the sampled edges and the cache hits
  are equal, and the per-epoch losses agree at rtol 1e-4 (f32 sums in
  another order over two epochs of Adam; test_torch_port_train.py's
  reason).  An uneven split (a dummy step on one rank) finishes and still
  matches.
- `fetch_feature_rows` on 2 ranks against a plain gather, f32 and int8,
  with out-of-range ids and chunk < S.
- A one-rank in-process group: the identity reduction; an NCCL group on a
  CPU device raises.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sgnn_tpu.config import RunConfig as JRunConfig
from sgnn_tpu.parallel.dp import (
    DataParallelTrainer as JDataParallelTrainer, make_dp_step, stack_batches,
)
from sgnn_tpu.parallel.mesh import make_mesh
from sgnn_tpu.train.trainer import SampleTrainer as JSampleTrainer

from sgnn_tpu_torch.parallel.mesh import DataGroup, make_group

from _torch_dp_worker import run_ranks

BLOCK_FIELDS = ("nbr", "weight", "srcs", "seeds", "dst_valid", "src_valid",
                "seed_in_src")


@pytest.fixture
def mesh2():
    return make_mesh(data=2, graph=1, devices=jax.devices()[:2])


def _weights(params):
    leaves = [np.asarray(w) for w in params.weights] + [
        np.asarray(a) for a in params.attn]
    return {"w_n": len(leaves), **{f"w{i}": w for i, w in enumerate(leaves)}}


def _batch_arrays(base, batch):
    """A JAX host batch as numpy, x0 and labels materialized (the port's
    worker builds its SampledBatch from these)."""
    bm = base._materialize(batch, base.dev_features, base.dev_labels)
    out = {"n_blocks": len(bm.blocks), "x0": np.asarray(bm.x0),
           "labels": np.asarray(bm.labels).astype(np.int64),
           "label_valid": np.asarray(bm.label_valid)}
    for h, b in enumerate(bm.blocks):
        for k in BLOCK_FIELDS:
            out[f"b{h}_{k}"] = np.asarray(getattr(b, k))
    return out


def test_grad_sum_step_matches_jax(tiny_ds, mesh2, tmp_path):
    cfg = JRunConfig(layer_sizes=[32, 16, 5], fanout=[4, 3], batch_size=16,
                     drop_rate=0.0, learn_rate=0.01)
    base = JSampleTrainer(cfg, tiny_ds, family="gcn")
    step = make_dp_step("gcn", 0.0, base.optimizer, mesh2,
                        materialize=base._materialize)
    ba, _ = base._make_batch(np.arange(16, dtype=np.int32))
    bb, _ = base._make_batch(np.arange(16, 32, dtype=np.int32))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    new_p, _, loss, acc = step(base.params, base.opt_state,
                               stack_batches([ba, bb]), keys,
                               base.dev_features, base.dev_labels, None,
                               None, None)
    # one launch, two ranks: rank r reads batch r
    w = _weights(base.params)
    both = dict(w)
    for r, batch in enumerate((ba, bb)):
        both.update({f"r{r}_{k}": v
                     for k, v in _batch_arrays(base, batch).items()})
    outs = run_ranks("grad_step", both, str(tmp_path))
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["loss"], np.asarray(loss)[r],
                                   rtol=1e-5)
        np.testing.assert_array_equal(out["acc"], np.asarray(acc)[r])
    for got in outs:
        for i, exp in enumerate(new_p.weights):
            g, e = got[f"p{i}"], np.asarray(exp)
            close = np.isclose(g, e, rtol=2e-2, atol=1e-4)
            assert close.mean() > 0.99, f"only {close.mean():.3f} close"
            assert np.abs(g - e).mean() < 1e-3
    # the parameters stay replicated: both ranks hold the same update
    for i in range(int(w["w_n"])):
        np.testing.assert_array_equal(outs[0][f"p{i}"], outs[1][f"p{i}"])


HOST_CASES = {
    "sample-trainer": dict(algorithm="GCNSAMPLEGPU"),
    "pcmulti-pd-refresh-host": dict(algorithm="GCNSAMPLEPCMULTI",
                                    pd_refresh="host", pipeline_num=2),
    # 65 train vertices at 32 a batch: rank 0 takes 33 (2 steps), rank 1
    # 32 (1 step and a dummy step with no valid label)
    "uneven-dummy-step": dict(algorithm="GCNSAMPLEGPU", n_train=65),
}


def _jax_host_dp(tiny_ds, mesh2, change):
    from sgnn_tpu.cache.orchestrator import CachedSampleTrainer
    from sgnn_tpu.sampler.blocks import WeightKind

    jcfg = dataclasses.replace(
        JRunConfig(layer_sizes=[32, 16, 5], fanout=[4, 3],
                   vertices=tiny_ds.num_vertices),
        batch_size=32, drop_rate=0.0, learn_rate=0.01,
        **{k: v for k, v in change.items() if k != "n_train"})
    if jcfg.algorithm == "GCNSAMPLEPCMULTI":
        base = CachedSampleTrainer(jcfg, tiny_ds, family="gcn",
                                   weight_kind=WeightKind.GCN,
                                   degree_mode="global", per_sb=False)
    else:
        base = JSampleTrainer(jcfg, tiny_ds, family="gcn")
    if "n_train" in change:
        base.train_nids = base.train_nids[: change["n_train"]]
    return JDataParallelTrainer(base, mesh=mesh2)


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_dp_epochs_match_jax(tiny_ds, mesh2, tmp_path, name):
    change = HOST_CASES[name]
    jt = _jax_host_dp(tiny_ds, mesh2, change)
    cfg = {k: v for k, v in change.items() if k != "n_train"}
    cfg.update(batch_size=32, drop_rate=0.0, learn_rate=0.01)
    inputs = {**_weights(jt.base.params), "cfg": json.dumps(cfg),
              "epochs": 2}
    if "n_train" in change:
        inputs["n_train"] = change["n_train"]
        n = len(jt.base.train_nids)
        assert -(-(n - n // 2) // 32) != -(-(n // 2) // 32)
    outs = run_ranks("host_epochs", inputs, str(tmp_path))
    cached = change["algorithm"] == "GCNSAMPLEPCMULTI"
    for ep in range(2):
        jl, jacc, jedges = jt.train_epoch()
        for out in outs:
            loss, acc, edges, hits, lookups = out["rows"][ep]
            assert int(edges) == jedges             # the same blocks
            np.testing.assert_allclose(loss, jl, rtol=1e-4)
            assert abs(acc - jacc) <= 0.02
            if cached:
                assert (int(hits), int(lookups)) == (jt.base.cache_hits,
                                                     jt.base.cache_lookups)
                assert 0 < hits < lookups
    jval = jt.evaluate(jt.base.val_nids)
    for out in outs:
        assert str(out["type"]) == "DataParallelTrainer"
        assert str(out["base_type"]) == type(jt.base).__name__
        # the same evaluation blocks; after the uneven case's 3 steps the
        # log-probs are near ties, whose argmax follows f32 rounding
        if "n_train" not in change:
            assert float(out["val"]) == pytest.approx(jval, abs=0.02)
        for i, exp in enumerate(jt.base.params.weights):
            g, e = out[f"p{i}"], np.asarray(exp)
            close = np.isclose(g, e, rtol=2e-2, atol=1e-4)
            assert close.mean() > 0.99, f"only {close.mean():.3f} close"
            assert np.abs(g - e).mean() < 1e-3
        if cached:
            assert not bool(out["per_sb"])
            assert int(out["w_version"]) == jt.base.w_queue.version
    for i in range(int(_weights(jt.base.params)["w_n"])):
        np.testing.assert_array_equal(outs[0][f"p{i}"], outs[1][f"p{i}"])


def test_fetch_feature_rows_matches_a_gather(tmp_path):
    """Rows from two shards of 19 rows (the second with a pad row) for
    S = 11 requests a rank in chunks of 4, against a plain gather; ids
    outside [0, 38) give zero rows."""
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((37, 5)).astype(np.float32)
    q = rng.integers(-127, 128, (37, 5)).astype(np.int8)
    src = [np.array([0, 36, 18, 19, -3, 37, 38, 100, 5, 5, 20], np.int32),
           np.array([1, 2, 3, 30, 31, 35, -1, 17, 18, 0, 36], np.int32)]
    outs = run_ranks("fetch", {"feats_f32": feats, "feats_int8": q,
                               "src0": src[0], "src1": src[1], "chunk": 4},
                     str(tmp_path))
    for r, out in enumerate(outs):
        ok = (src[r] >= 0) & (src[r] < 37)
        for name, table in (("f32", feats), ("int8", q)):
            want = np.where(ok[:, None], table[np.clip(src[r], 0, 36)], 0)
            assert out[name].dtype == table.dtype
            np.testing.assert_array_equal(out[name], want)


@pytest.fixture
def one_rank():
    group = make_group("cpu")
    yield group
    dist.destroy_process_group()


def test_one_rank_group_is_the_identity(one_rank):
    assert (one_rank.rank, one_rank.world_size, one_rank.backend) == (
        0, 1, "gloo")
    gen = torch.Generator().manual_seed(0)
    grads = [torch.randn(7, 3, generator=gen), torch.randn(5, generator=gen),
             torch.randn(2, 2, 2, generator=gen)]
    got = one_rank.reduce_grads(grads)
    assert [g.shape for g in got] == [g.shape for g in grads]
    assert all(torch.equal(a, b) for a, b in zip(got, grads))
    # the initialised group is joined, not made again
    again = make_group("cpu")
    assert (again.rank, again.world_size) == (0, 1)
    with pytest.raises(ValueError, match="NCCL group needs a CUDA"):
        DataGroup(rank=0, world_size=1, device=torch.device("cpu"),
                  backend="nccl")
    # a graph axis of 2 ranks in a group of one
    with pytest.raises(ValueError, match="graph=2"):
        make_group("cpu", graph=2)
