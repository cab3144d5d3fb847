"""Port parity, the cached trainers and their routing, on Cora on the CPU.

- CachedSampleTrainer (GCNSAMPLEPDCACHE with PD_REFRESH:host) against the
  JAX package's for 2 epochs at drop 0 with its initial weights carried
  across: both host samplers draw the same blocks, so the sampled edges
  and the cache hits are equal and the losses agree within 1e-3 relative
  (the reason for 1e-3 is in test_torch_port_train.py's docstring).  The
  same for the partial feature cache (FEATURE_CACHE_RATE, global and
  per-super-batch plans, f32 and int8 rows) in the plain host trainer and
  in the cached trainer past the device's memory, with equal feature-cache
  hit and byte counters.
- DeviceCachedSampleTrainer: its stacked aggregates and slot maps against
  the JAX trainer's; each super-batch's first step refreshes the cache
  from that step's W0 and the rest reuse it; GCNSAMPLEPDCACHE from the
  shipped cfg reaches the JAX engine matrix's floor of 0.90 train accuracy
  in 8 epochs (tests/test_train.py:241; the device sampler draws from
  torch.Generator, so it is held to the floor, not to the JAX draws).
- build_trainer routes every configuration to the trainer the JAX package
  builds: the four cached engines, PD_REFRESH:host, FeaturesExceedHbm,
  PUSHDOWN on host and device engines, ESTIMATOR_ADVISOR:route on and
  below its threshold; the *PCMULTI engines train an epoch on a one-rank
  group (their parity is tests/test_torch_port_dp_device.py's).
- Past the device, the feature cache's staged rows and the stacked
  aggregates stay within HBM_BUDGET together.
- The device trainer's residency probe counts its stacked aggregates.
- Resume is bit-identical on the CPU for both cached trainers, and the CLI
  trains, checkpoints, serves and exact-evaluates the shipped PD-cache cfg.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from sgnn_tpu.config import load_cfg as j_load_cfg
from sgnn_tpu.train.engines import build_trainer as j_build_trainer

from sgnn_tpu_torch.__main__ import main
from sgnn_tpu_torch.cache.embedding_cache import refresh_rows
from sgnn_tpu_torch.cache.orchestrator import CachedSampleTrainer
from sgnn_tpu_torch.config import RunConfig, load_cfg
from sgnn_tpu_torch.models.gnn import params_from_numpy
from sgnn_tpu_torch.train import build_trainer, run_engine
from sgnn_tpu_torch.train.checkpoint import CheckpointManager
from sgnn_tpu_torch.train.device_cached import DeviceCachedSampleTrainer

CFG = os.path.join(os.path.dirname(__file__), "..", "configs",
                   "gcn_cora_sample.cfg")
# 256-seed batches, 2 a super-batch: Cora's 1605 train vertices make 4
# super-batch plans (the shipped cfg's 4096 make one); no presample file
SMALL = dict(batch_size=256, pipeline_num=2, edge_file="", drop_rate=0.0)
# under the features (f32 15.5 MB, int8 3.9 MB): host features, and a
# feature cache of 523 f32 or 541 int8 rows
BUDGET = 3_000_000


def _cfgs(**kw):
    cfg, jcfg = load_cfg(CFG), j_load_cfg(CFG)
    return dataclasses.replace(cfg, **kw), dataclasses.replace(jcfg, **kw)


def _carry(jt, tt):
    tt.params = params_from_numpy([np.asarray(w) for w in jt.params.weights],
                                  [np.asarray(a) for a in jt.params.attn],
                                  device="cpu")


def _fc_counters(tr):
    caches = (tr._fc_sb_caches if tr._fc_sb_caches is not None
              else [tr.feat_cache])
    return [(c.hits, c.misses, c.bytes_shipped, c.bytes_full)
            for c in caches]


@pytest.mark.parametrize("change", [
    dict(algorithm="GCNSAMPLEPDCACHE", pd_refresh="host"),
    dict(algorithm="GCNSAMPLEGPU", feature_cache_rate=0.2, hbm_budget=BUDGET),
    dict(algorithm="GCNSAMPLEGPU", feature_cache_rate=0.2, hbm_budget=BUDGET,
         feature_cache_plan="per_sb", feature_dtype="int8"),
    # past the device the feature cache shares the budget with the stacked
    # aggregates (the port's probe; the JAX package's counts the features
    # alone): a 27-vertex embedding cache (0.6 MB of aggregates) and a 0.1
    # rate leave both packages staging the rate's 270 rows
    dict(algorithm="GSSAMPLEPDCACHE", feature_cache_rate=0.1, cache_rate=0.01,
         hbm_budget=BUDGET, feature_cache_plan="per_sb"),
], ids=["pd-refresh-host", "feature-cache", "feature-cache-per-sb-int8",
        "beyond-device-per-sb"])
def test_host_trainers_match_jax(cora, change):
    cfg, jcfg = _cfgs(**SMALL, **change)
    jt, tt = j_build_trainer(jcfg, cora), build_trainer(cfg, cora,
                                                         device="cpu")
    assert type(tt).__name__ == type(jt).__name__
    cached = isinstance(tt, CachedSampleTrainer)
    assert cached == (change["algorithm"] != "GCNSAMPLEGPU")
    if cached:
        assert len(tt.sb_caches) == len(jt.sb_caches) == 4
        for tc, jc in zip(tt.sb_caches, jt.sb_caches):
            np.testing.assert_array_equal(tc.cache_ids, jc.cache_ids)
    _carry(jt, tt)
    for _ in range(2):
        jl, jacc, jedges = jt.train_epoch()
        tl, tacc, tedges = tt.train_epoch()
        assert tedges == jedges            # the same blocks
        np.testing.assert_allclose(tl, jl, rtol=1e-3)
        assert abs(tacc - jacc) <= 0.02
        if cached:
            assert (tt.cache_hits, tt.cache_lookups) == (jt.cache_hits,
                                                         jt.cache_lookups)
            assert 0 < tt.cache_hits < tt.cache_lookups
            assert tt.w_queue.version == jt.w_queue.version
        if "feature_cache_rate" in change:
            assert not tt.features_on_device
            if "cache_rate" in change:
                assert tt.feat_cache.hot_ids.size == 270
            assert _fc_counters(tt) == _fc_counters(jt)
            assert tt.feature_cache_stats == jt.feature_cache_stats
    assert tt.evaluate(tt.val_nids) == pytest.approx(
        jt.evaluate(jt.val_nids), abs=0.02)


def test_device_cached_plans_and_refreshes(cora):
    cfg, jcfg = _cfgs(**SMALL, algorithm="GSSAMPLECACHE")
    jt, tt = j_build_trainer(jcfg, cora), build_trainer(cfg, cora,
                                                         device="cpu")
    assert isinstance(tt, DeviceCachedSampleTrainer)
    assert type(tt).__name__ == type(jt).__name__
    np.testing.assert_array_equal(tt.cache_maps.numpy(),
                                  np.asarray(jt.cache_maps))
    got, ref = tt.cache_agg_all.numpy(), np.asarray(jt.cache_agg_all)
    assert got.shape == ref.shape and got.shape[0] == 4
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    # each step's cache rows and W0 as the step saw them
    seen = []
    step = tt.train_step

    def spy(batch, cache_emb=None):
        seen.append((tt.params.weights[0], cache_emb, batch))
        return step(batch, cache_emb)

    tt.train_step = spy
    tt.train_epoch()
    n_steps = -(-tt.train_nids.size // 256)
    assert len(seen) == n_steps and tt.refreshes == -(-n_steps // 2)
    for i, (w0, emb, batch) in enumerate(seen):
        sb = i // 2
        if i % 2 == 0:
            assert torch.equal(emb, refresh_rows(tt.cache_agg_all[sb], w0))
        else:
            assert emb is seen[i - 1][1]
            assert not torch.equal(w0, seen[i - 1][0])   # W0 moved on
        slots = tt.cache_maps[sb][batch.blocks[0].seeds.long()]
        assert torch.equal(batch.cache_mask,
                           (slots >= 0) & batch.blocks[0].dst_valid)
    assert 0 < tt.cache_hits < tt.cache_lookups


def test_pdcache_cfg_reaches_the_engine_floor(cora):
    report = run_engine(dataclasses.replace(load_cfg(CFG), epochs=8), cora,
                        device="cpu")
    assert max(report.train_acc) >= 0.90, report.train_acc
    assert report.losses[-1] < report.losses[0]


ROUTES = {
    "GCNSAMPLEPDCACHE": dict(algorithm="GCNSAMPLEPDCACHE"),
    "GSSAMPLECACHE": dict(algorithm="GSSAMPLECACHE"),
    "GSSAMPLEPDCACHE": dict(algorithm="GSSAMPLEPDCACHE"),
    "GATSAMPLEPDCACHE": dict(algorithm="GATSAMPLEPDCACHE"),
    "pd-refresh-host": dict(algorithm="GCNSAMPLEPDCACHE", pd_refresh="host"),
    "cache-pd-refresh-host": dict(algorithm="GSSAMPLECACHE",
                                  pd_refresh="host"),
    "features-exceed": dict(algorithm="GSSAMPLEPDCACHE", hbm_budget=1 << 20),
    "pushdown-host": dict(algorithm="GCNSAMPLEGPU", pushdown=True),
    "pushdown-device": dict(algorithm="GSSAMPLEALLGPU", pushdown=True),
    "advisor-route": dict(algorithm="GCNSAMPLEALLGPU",
                          estimator_advisor="route"),
    "advisor-below": dict(algorithm="GCNSAMPLEALLGPU",
                          estimator_advisor="route", batch_size=8,
                          fanout=[2, 2]),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_routing_matches_jax(cora, name):
    cfg, jcfg = _cfgs(**ROUTES[name])
    tt, jt = build_trainer(cfg, cora, device="cpu"), j_build_trainer(jcfg,
                                                                    cora)
    assert type(tt).__name__ == type(jt).__name__
    assert tt.family == jt.family
    assert tt.optimizer.bias_correction == jt.optimizer.bias_correction
    assert tt.features_on_device == jt.features_on_device
    assert (type(tt).__name__ in ("CachedSampleTrainer",
                                  "DeviceCachedSampleTrainer")) == (
        name != "advisor-below")


@pytest.mark.parametrize("algo", ["GCNSAMPLEPCMULTI", "GSSAMPLEPCMULTI",
                                  "GATSAMPLEPCMULTI"])
def test_pcmulti_engines_name_item_6(cora, algo):
    """Item 6a is ported: each *PCMULTI engine builds the device-cached
    trainer with one global hot set under the data-parallel wrapper (a
    one-rank group here) and trains an epoch."""
    import torch.distributed as dist

    from sgnn_tpu_torch.parallel.dp_device import (
        DeviceCachedDataParallelTrainer,
    )

    try:
        tr = build_trainer(_cfgs(**SMALL, algorithm=algo)[0], cora,
                           device="cpu")
        assert isinstance(tr, DeviceCachedDataParallelTrainer)
        assert isinstance(tr.base, DeviceCachedSampleTrainer)
        assert len(tr.base.sb_caches) == 1 and not tr.base.per_sb
        loss, acc, edges = tr.train_epoch()
        assert np.isfinite(loss) and 0 < acc <= 1 and edges > 0
        assert 0 < tr.cache_hit_rate < 1
    finally:
        dist.destroy_process_group()


def test_feature_cache_shares_the_budget_with_the_aggregates(cora):
    """The host cached trainer past the device: its staged feature rows
    and its stacked aggregates, counted from the tensors it holds, stay
    within HBM_BUDGET (the capacity probe gives the rows what the
    aggregates leave)."""
    budget = 15_000_000
    cfg = _cfgs(**SMALL, algorithm="GSSAMPLEPDCACHE", feature_cache_rate=0.5,
                hbm_budget=budget)[0]
    tr = build_trainer(cfg, cora, device="cpu")
    assert isinstance(tr, CachedSampleTrainer) and not tr.features_on_device
    aggs = sum(c.cache_agg.numel() * c.cache_agg.element_size()
               for c in tr.sb_caches)
    assert aggs == tr._resident_extra_bytes(cfg, cora) > 0
    rows = tr.feat_cache.dev_hot
    staged = rows.numel() * rows.element_size()
    assert 0 < staged and staged + aggs <= budget


def test_cached_trainers_reject_one_layer(tiny_ds):
    cfg = RunConfig(layer_sizes=[32, 5], fanout=[4], batch_size=64,
                    vertices=tiny_ds.num_vertices)
    for cls in (CachedSampleTrainer, DeviceCachedSampleTrainer):
        with pytest.raises(ValueError, match=">= 2 layers"):
            cls(cfg, tiny_ds, device="cpu")


def test_fit_check_counts_the_stacked_aggregates(cora):
    """Both cached trainers' residency probes count the [n_sb, C, F] f32
    aggregates beside the features, and only the stacked copy stays: a
    budget that holds the f32 features alone, but not int8 features with
    the aggregates, takes the host-refreshed trainer with host features;
    one that holds int8 features with them takes the device trainer at
    int8."""
    cfg = _cfgs(**SMALL, algorithm="GSSAMPLECACHE")[0]
    tr = build_trainer(cfg, cora, device="cpu")
    agg = tr.cache_agg_all.numel() * tr.cache_agg_all.element_size()
    assert tr._resident_extra_bytes(cfg, cora) == agg
    assert tr.cache_agg_all.shape[0] == len(tr.sb_caches) == 4
    assert all(c.cache_agg is None for c in tr.sb_caches)
    f32, i8 = cora.features.size * 4, cora.features.size
    budget = (f32 + i8 + agg) // 2
    assert f32 <= budget < i8 + agg
    tr = build_trainer(dataclasses.replace(cfg, hbm_budget=budget), cora,
                       device="cpu")
    assert isinstance(tr, CachedSampleTrainer) and not tr.features_on_device
    assert tr._resident_extra_bytes(cfg, cora) == agg
    tr = build_trainer(dataclasses.replace(cfg, hbm_budget=i8 + agg), cora,
                       device="cpu")
    assert isinstance(tr, DeviceCachedSampleTrainer)
    assert tr.dev_features.dtype == torch.int8


def _live_rows(tr):
    """The cache rows a trainer's next step would splice in."""
    return (tr.cache_emb if isinstance(tr, DeviceCachedSampleTrainer)
            else tr.cache.cache_emb)


@pytest.mark.parametrize("change", [
    dict(algorithm="GCNSAMPLEPDCACHE", pd_refresh="host"),
    dict(algorithm="GATSAMPLEPDCACHE", heads=2, layer_sizes=[1433, 16, 7]),
], ids=["host", "device"])
def test_resume_is_bit_identical(cora, tmp_path, change):
    cfg = dataclasses.replace(_cfgs(**SMALL, **change)[0], drop_rate=0.5)
    straight = build_trainer(cfg, cora, device="cpu")
    straight.train_epoch()
    straight.train_epoch()
    first = build_trainer(cfg, cora, device="cpu")
    first.train_epoch()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, first)
    resumed = build_trainer(cfg, cora, device="cpu")
    assert mgr.restore(resumed) == 0
    assert torch.equal(_live_rows(resumed), _live_rows(first))
    if isinstance(first, CachedSampleTrainer):
        assert resumed.w_queue.version == first.w_queue.version == 3
        assert torch.equal(resumed.w_queue._w, first.w_queue._w)
    resumed.train_epoch()
    for a, b in zip(straight.params.leaves(), resumed.params.leaves()):
        assert torch.equal(a, b)
    assert torch.equal(_live_rows(straight), _live_rows(resumed))


def test_cli_runs_the_pdcache_cfg(tmp_path):
    ck, rep = str(tmp_path / "ck"), str(tmp_path / "r.json")
    assert main([CFG, "--cpu", "--epochs", "2", "--exact-eval",
                 "--report-out", rep]) == 0
    with open(rep) as f:
        report = json.load(f)
    assert report["algorithm"] == "GCNSAMPLEPDCACHE"
    assert len(report["epoch_times"]) == 2
    assert {"presample", "cache_csr", "cache_aggregate"} <= set(
        report["phase_totals_s"])
    assert main([CFG, "--cpu", "--epochs", "1", "--checkpoint-dir", ck]) == 0
    pred = str(tmp_path / "p.npy")
    assert main([CFG, "--cpu", "--infer", ck, "--predictions-out",
                 pred]) == 0
    logp = np.load(pred)
    assert logp.shape == (2708, 7)
    np.testing.assert_allclose(np.exp(logp).sum(1), 1.0, atol=1e-4)
