"""Port parity, sampled training on Cora.

GCNSAMPLEGPU and GCNSAMPLESINGLE: sgnn_tpu_torch's SampleTrainer against
sgnn_tpu's on real Cora for 2 epochs at drop 0, with the JAX package's
initial weights carried across.  Both host samplers draw the same blocks
(the permutation, then the batches, from one numpy generator), so the
per-epoch mean losses agree to within 1e-3 relative.  Not tighter: the
first update of the uncorrected Adam moves each weight by about
lr·3.16·sign(g), so a gradient element near 0 whose sign flips under
another summation order moves its weight by ~2·lr, and later losses
inherit that; the gradients themselves are held to 1e-4 in
test_torch_port_model.py.

GSSAMPLEALLGPU (device sampler, torch draws) is held to the JAX engine
matrix's floor of 0.91 train accuracy in 8 epochs (tests/test_train.py:244)
(GATSAMPLEALLGPU's floor is held in test_torch_port_gat.py), every
option the port does not take yet raises NotImplementedError naming its
ROADMAP item, and every engine builds, the cached ones and the *MULTI ones
too (their parity with the JAX package: test_torch_port_cache*.py and
test_torch_port_dp*.py).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sgnn_tpu.sampler.blocks import WeightKind as JWeightKind
from sgnn_tpu.train.trainer import SampleTrainer as JSampleTrainer

from sgnn_tpu_torch.config import RunConfig, load_cfg
from sgnn_tpu_torch.models.gnn import params_from_numpy
from sgnn_tpu_torch.train import ENGINES, build_trainer, run_engine
from sgnn_tpu_torch.train.trainer import SampleTrainer

CFG = os.path.join(os.path.dirname(__file__), "..", "configs",
                   "gcn_cora_sample.cfg")
PORTED = {"GCNSAMPLESINGLE", "GCNSAMPLEGPU", "GCNSAMPLEALLGPU",
          "GSSAMPLEALLGPU", "GATSAMPLEALLGPU", "GCNFULLBATCH", "GSFULLBATCH",
          "GATFULLBATCH", "GCNSAMPLEPDCACHE", "GSSAMPLECACHE",
          "GSSAMPLEPDCACHE", "GATSAMPLEPDCACHE", "GCNSAMPLEALLMULTI",
          "GATSAMPLEALLMULTI", "GCNSAMPLEPCMULTI", "GSSAMPLEPCMULTI",
          "GATSAMPLEPCMULTI"}


def _cfg(**kw):
    cfg = load_cfg(CFG)
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("algo,bias", [("GCNSAMPLEGPU", False),
                                       ("GCNSAMPLESINGLE", True)])
def test_trainer_losses_match_jax(cora, algo, bias):
    cfg = _cfg(algorithm=algo, drop_rate=0.0, epochs=2)
    jt = JSampleTrainer(cfg, cora, family="gcn", weight_kind=JWeightKind.GCN,
                        degree_mode="global", bias_correction=bias)
    tt = build_trainer(cfg, cora, device="cpu")
    assert isinstance(tt, SampleTrainer) and tt.optimizer.bias_correction == bias
    tt.params = params_from_numpy([np.asarray(w) for w in jt.params.weights],
                                  device="cpu")
    for _ in range(2):
        jl, jacc, jedges = jt.train_epoch()
        tl, tacc, tedges = tt.train_epoch()
        assert tedges == jedges            # the same blocks
        np.testing.assert_allclose(tl, jl, rtol=1e-3)
        assert abs(tacc - jacc) <= 0.02


def test_gs_allgpu_reaches_the_engine_floor(cora):
    report = run_engine(_cfg(algorithm="GSSAMPLEALLGPU", epochs=8), cora,
                        device="cpu")
    assert max(report.train_acc) >= 0.91, report.train_acc
    assert report.losses[-1] < report.losses[0]


def test_host_trainer_runs_with_host_payload(tiny_ds):
    """Features left on the host: each batch ships its gathered rows."""
    cfg = RunConfig(algorithm="GCNSAMPLEGPU", layer_sizes=[32, 16, 5],
                    fanout=[4, 3], batch_size=64, epochs=2, drop_rate=0.5,
                    vertices=tiny_ds.num_vertices, hbm_budget=1000)
    tr = build_trainer(cfg, tiny_ds, device="cpu")
    assert not tr.features_on_device
    report = tr.run()
    assert np.isfinite(report.losses).all() and len(report.val_acc) == 2


def test_sampler_error_reaches_consumer(tiny_ds):
    """A producer-thread exception surfaces on the consumer (no deadlock),
    and the producer thread ends."""
    cfg = RunConfig(layer_sizes=[32, 16, 5], fanout=[4, 3], batch_size=64,
                    epochs=1, drop_rate=0.0, vertices=tiny_ds.num_vertices)
    tr = SampleTrainer(cfg, tiny_ds, family="gcn", device="cpu")

    def boom(seeds):
        raise RuntimeError("src overflow: injected")

    tr._make_batch = boom
    with pytest.raises(RuntimeError, match="src overflow"):
        tr.train_epoch()


def test_consumer_stopping_early_ends_the_producer(tiny_ds):
    import threading

    cfg = RunConfig(layer_sizes=[32, 16, 5], fanout=[4, 3], batch_size=16,
                    epochs=1, drop_rate=0.0, vertices=tiny_ds.num_vertices,
                    pipeline_num=2)
    tr = SampleTrainer(cfg, tiny_ds, family="gcn", device="cpu")
    before = threading.active_count()
    stream = tr._batch_stream(tr.train_nids, shuffle=False)
    next(stream)
    stream.close()
    assert threading.active_count() == before


@pytest.mark.parametrize("algo", sorted(ENGINES))
def test_unported_engines_name_their_item(cora, algo):
    """Every engine either builds its trainer (the ported ones: all 17, the
    *MULTI ones on a one-rank group) or raises NotImplementedError naming
    its ROADMAP item."""
    if algo in PORTED:
        import torch.distributed as dist

        try:
            tr = build_trainer(_cfg(algorithm=algo), cora, device="cpu")
            assert tr.family == ENGINES[algo].family
            assert hasattr(tr, "group") == ENGINES[algo].multi_device
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        build_trainer(_cfg(algorithm=algo), cora, device="cpu")


@pytest.mark.parametrize("change", [
    dict(pushdown=True), dict(estimator_advisor="route"),
    dict(reorder="degree"),
    # a budget under the features (f32 15.5 MB, int8 3.9 MB) that still
    # stages rows: int8 the rate's 541, f32 the budget's 523
    dict(feature_dtype="int8", feature_cache_rate=0.2, hbm_budget=3_000_000),
    dict(feature_cache_rate=0.2, hbm_budget=3_000_000),
], ids=["pushdown", "advisor-route", "reorder", "int8", "feature-cache"])
def test_unported_options_name_their_item(cora, change):
    """Each option once waited for its item and trains now.  REORDER (item
    7): `run_engine` renumbers Cora by in-degree and reports the order.
    PUSHDOWN, ESTIMATOR_ADVISOR:route (Cora's 1024-seed batches reach
    every vertex) and the partial feature cache, with f32 or int8 rows,
    waited for item 5."""
    cfg = _cfg(algorithm="GCNSAMPLEGPU", **change)
    if "reorder" in change:
        from sgnn_tpu_torch.graph import vertex_order

        report = run_engine(cfg, cora, epochs=1, device="cpu")
        np.testing.assert_array_equal(report.vertex_order,
                                      vertex_order(cora, "degree"))
        assert np.isfinite(report.losses[0]) and report.edges_per_epoch[0]
        return
    tr = build_trainer(cfg, cora, device="cpu")
    loss, _, edges = tr.train_epoch()
    assert np.isfinite(loss) and edges > 0
    if "feature_cache_rate" in change:
        assert isinstance(tr, SampleTrainer) and not tr.features_on_device
        int8 = "feature_dtype" in change
        assert tr.feat_cache.hot_ids.size == (541 if int8 else 523)
        assert tr.feat_cache.dev_hot.dtype == (torch.int8 if int8
                                               else torch.float32)
        rate, shipped, full = tr.feature_cache_stats
        assert 0 < rate < 1 and 0 < shipped < full
    else:
        assert type(tr).__name__ == "CachedSampleTrainer"
        assert 0 < tr.cache_hits < tr.cache_lookups


def test_unknown_engine_lists_the_known(cora):
    with pytest.raises(KeyError, match="GSSAMPLEALLGPU"):
        build_trainer(_cfg(algorithm="NOPE"), cora, device="cpu")


def test_checkpoints_wait(tiny_ds):
    """Checkpoints waited for item 4 and work now: the state round-trips
    (resume parity in test_torch_port_checkpoint.py)."""
    cfg = RunConfig(layer_sizes=[32, 16, 5], fanout=[4, 3], batch_size=64,
                    vertices=tiny_ds.num_vertices)
    tr = SampleTrainer(cfg, tiny_ds, device="cpu")
    state = tr.checkpoint_state()
    assert set(state) == {"params", "opt_state", "dropout_rng", "host_rng"}
    tr.load_checkpoint_state(state)
