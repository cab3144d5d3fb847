"""Engine registry: reference ALGORITHM strings → trainer policies.

The port of sgnn_tpu/train/engines.py.  Reference: toolkits/main.cpp:46-183
dispatches 14 engine classes, one per (model × placement × caching ×
#GPU); here one trainer is parameterised by policy knobs, so every
ALGORITHM string maps to a configuration.  The table is the JAX package's
in full; the port trains GCNSAMPLESINGLE, GCNSAMPLEGPU, GCNSAMPLEALLGPU,
GSSAMPLEALLGPU and GATSAMPLEALLGPU (sampled), GCNSAMPLEPDCACHE,
GSSAMPLECACHE, GSSAMPLEPDCACHE and GATSAMPLEPDCACHE (sampled with the
hot-vertex cache), GCNSAMPLEALLMULTI, GATSAMPLEALLMULTI, GCNSAMPLEPCMULTI,
GSSAMPLEPCMULTI and GATSAMPLEPCMULTI (data-parallel over
`torch.distributed`, parallel/) and GCNFULLBATCH, GSFULLBATCH and
GATFULLBATCH (whole graph, `FullBatchEngine`): all 17, each under every
REORDER value (`run_engine` renumbers the graph first).

Placement: *SAMPLESINGLE → bias-corrected Adam (CPU engines); *SAMPLEGPU →
host sampler; *ALLGPU → device sampler; *PDCACHE / *CACHE → the device
sampler with the in-loop cache refresh (train/device_cached.py), or the
host-refreshed cached trainer (cache/orchestrator.py) under PD_REFRESH:host
or when the features exceed the device; *ALLMULTI / *PCMULTI → the same
trainers under a data-parallel wrapper (gradients summed over the ranks
each step); *FULLBATCH → whole-graph training
(train/fullbatch.py), bias-corrected Adam.  Edge-weight degrees follow
UP_DEGREE for every engine (GraphSegment.cpp:273): false → "global"
full-graph degrees, true → "sampled" degrees.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..config import RunConfig
from ..data.dataset import Dataset
from ..sampler.blocks import WeightKind
from ..utils.logging import get_logger
from ..utils.timing import span


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    name: str                   # reference ALGORITHM string
    family: str                 # gcn | sage | gat
    weight_kind: WeightKind
    use_cache: bool = False     # NeutronOrch hot-vertex embedding cache
    cache_on_device: bool = True  # GS_SAMPLE_CACHE: refresh on accelerator
    multi_device: bool = False  # data-parallel over devices
    bias_correction: bool = False  # CPU engines use bias-corrected Adam
    device_sampling: bool = False  # ALLGPU engines: sample on the device
    fullbatch: bool = False        # whole-graph engine (no sampling)


def _spec(name, family, wk, **kw) -> EngineSpec:
    return EngineSpec(name=name, family=family, weight_kind=wk, **kw)


# One entry per reference engine (toolkits/main.cpp:68-183), as the JAX
# package's table (sgnn_tpu/train/engines.py:51-107).
ENGINES = {
    s.name: s
    for s in [
        _spec("GCNSAMPLESINGLE", "gcn", WeightKind.GCN, bias_correction=True),
        _spec("GCNSAMPLEGPU", "gcn", WeightKind.GCN),
        _spec("GCNSAMPLEALLGPU", "gcn", WeightKind.GCN, device_sampling=True),
        _spec("GCNSAMPLEPDCACHE", "gcn", WeightKind.GCN, use_cache=True,
              cache_on_device=False),
        _spec("GCNSAMPLEALLMULTI", "gcn", WeightKind.GCN, multi_device=True,
              device_sampling=True),
        _spec("GCNSAMPLEPCMULTI", "gcn", WeightKind.GCN, use_cache=True,
              cache_on_device=False, multi_device=True),
        _spec("GSSAMPLEALLGPU", "sage", WeightKind.MEAN, device_sampling=True),
        _spec("GSSAMPLECACHE", "sage", WeightKind.MEAN, use_cache=True,
              cache_on_device=True),
        _spec("GSSAMPLEPDCACHE", "sage", WeightKind.MEAN, use_cache=True,
              cache_on_device=False),
        _spec("GSSAMPLEPCMULTI", "sage", WeightKind.MEAN, use_cache=True,
              cache_on_device=False, multi_device=True),
        _spec("GATSAMPLEALLGPU", "gat", WeightKind.NONE, device_sampling=True,
              bias_correction=True),
        _spec("GATSAMPLEPDCACHE", "gat", WeightKind.NONE, use_cache=True,
              cache_on_device=False, bias_correction=True),
        _spec("GATSAMPLEALLMULTI", "gat", WeightKind.NONE, multi_device=True,
              device_sampling=True, bias_correction=True),
        _spec("GATSAMPLEPCMULTI", "gat", WeightKind.NONE, use_cache=True,
              cache_on_device=False, multi_device=True,
              bias_correction=True),
        _spec("GCNFULLBATCH", "gcn", WeightKind.GCN, fullbatch=True,
              bias_correction=True),
        _spec("GSFULLBATCH", "sage", WeightKind.MEAN, fullbatch=True,
              bias_correction=True),
        _spec("GATFULLBATCH", "gat", WeightKind.NONE, fullbatch=True,
              bias_correction=True),
    ]
}


def engine_from_config(cfg: RunConfig) -> EngineSpec:
    algo = cfg.algorithm.upper()
    if algo not in ENGINES:
        raise KeyError(
            f"unknown ALGORITHM '{cfg.algorithm}'; known: {sorted(ENGINES)}")
    return ENGINES[algo]


def resolve_degree_mode(cfg: RunConfig) -> str:
    """UP_DEGREE → degree source for edge weights (GraphSegment.cpp:273)."""
    return "sampled" if cfg.up_degree else "global"


class FullBatchEngine:
    """Adapter giving FullBatchTrainer the sampled trainers' run() contract
    (sgnn_tpu/train/engines.py:124-192): `run()` returns a TrainReport with
    every epoch's edges = the graph's edge count, and the wrapped trainer
    is on `.base`.

    PARTITION_GRAPH:1 shards the graph over the ranks of this process's
    group (an initialised one, or torchrun's environment: `torchrun
    --nproc_per_node=N -m sgnn_tpu_torch cfg`) when it has more than one,
    as the JAX engine over every visible device
    (sgnn_tpu/train/engines.py:136-160), with HALO and PARTITION_BALANCE;
    with one rank it warns and runs the single-device program, as the JAX
    engine does with one device."""

    def __init__(self, cfg: RunConfig, dataset: Dataset, family: str,
                 weight_kind: WeightKind, device=None) -> None:
        from ..parallel.mesh import make_group, process_world_size
        from .fullbatch import FullBatchTrainer

        mesh = None
        if cfg.partition_graph:
            world = process_world_size()
            if world > 1:
                # `.group`, as every trainer on a group has (checkpoints)
                self.group = mesh = make_group(device, graph=world)
                device = mesh.device
            else:
                get_logger("sgnn.engine").warning(
                    "PARTITION_GRAPH:1 requested but only one device is "
                    "visible — running the single-device program")
        self.cfg = cfg
        self.base = FullBatchTrainer(cfg, dataset, family=family,
                                     weight_kind=weight_kind, halo=cfg.halo,
                                     mesh=mesh, device=device)

    @property
    def family(self) -> str:
        return self.base.family

    @property
    def params(self):
        return self.base.params

    @property
    def adj(self):
        return self.base.adj

    def train_epoch(self):
        """(loss, train accuracy, edges), the sampled trainers' triple."""
        loss, tr, _va, _te = self.base.train_epoch()
        return loss, tr, int(self.base.adj.num_edges)

    def evaluate(self, nids) -> float:
        return self.base.evaluate(nids)

    def checkpoint_state(self) -> dict:
        return self.base.checkpoint_state()

    def load_checkpoint_state(self, state: dict) -> None:
        self.base.load_checkpoint_state(state)

    @property
    def timers(self):
        return self.base.timers

    def run(self, epochs: Optional[int] = None):
        from .trainer import TrainReport

        hist = self.base.run(epochs)
        return TrainReport(
            epoch_times=[h["time"] for h in hist],
            train_acc=[h["train"] for h in hist],
            val_acc=[h["val"] for h in hist],
            test_acc=[h["test"] for h in hist],
            losses=[h["loss"] for h in hist],
            edges_per_epoch=[int(self.base.adj.num_edges)] * len(hist),
            timers=self.base.timers,
            time_skip=self.cfg.time_skip)


def _route_by_advice(cfg: RunConfig, dataset: Dataset,
                     spec: EngineSpec) -> RunConfig:
    """ESTIMATOR_ADVISOR:route: when one batch's bottom hop is expected to
    cover most of the graph, turn the PUSHDOWN bottom-hop composition on
    (train/advisor.py) instead of only warning."""
    from ..data.dataset import MASK_TRAIN
    from ..graph.adjacency import Adjacency
    from .advisor import advise_estimator_regime

    adj = Adjacency.from_edges(dataset.edges, dataset.num_vertices)
    advice = advise_estimator_regime(
        adj, cfg.fanout, cfg.batch_size,
        len(dataset.nids_with_mask(MASK_TRAIN)), mode="warn", remedied=True)
    if advice is None:
        return cfg
    get_logger("sgnn.advisor").warning(
        "estimator regime (coverage %.1f%%): ESTIMATOR_ADVISOR:route "
        "enabling the PUSHDOWN bottom-hop composition for %s",
        100 * advice["bottom_coverage"], spec.name)
    return dataclasses.replace(cfg, pushdown=True)


def build_trainer(cfg: RunConfig, dataset: Dataset, device=None):
    """Construct (without running) the trainer an ALGORITHM string names,
    on `device` (None means CUDA), routed as the JAX package's
    (sgnn_tpu/train/engines.py:196-363).

    A cached engine takes the device-sampled cached trainer when it
    refreshes on the device (GSSAMPLECACHE) and by default (*PDCACHE);
    PD_REFRESH:host takes the host-refreshed one, and so does any cached
    engine whose features exceed the device (FeaturesExceedHbm: the JAX
    package's beyond-device-memory posture, still on the card).
    PUSHDOWN:1 on a plain sampled engine is the cached trainer on that
    engine's sampler; ESTIMATOR_ADVISOR:route turns PUSHDOWN on when the
    advisor fires.  The *MULTI engines join this process's data-parallel
    group (`_build_multi`).  GAT_VARIANT (models/gnn.py's PyG GAT stacks,
    "pyg" and "pyg_v2") is taken by GATSAMPLEALLGPU without a cache alone;
    any other engine raises ValueError naming it.  The build is the `build` span, recorded
    with or without a profiler session (utils/timing.py)."""
    with span("build", always=True):
        return _build_trainer(cfg, dataset, device)


# the one engine that takes GAT_VARIANT (models/gnn.py's "pyg" and
# "pyg_v2" layers)
VARIANT_ENGINE = "GATSAMPLEALLGPU"


def _refuse_variant(cfg: RunConfig, spec: EngineSpec) -> None:
    """GAT_VARIANT only on the device-sampled GAT engine without a cache
    (PUSHDOWN or ESTIMATOR_ADVISOR:route's): ValueError naming the key."""
    if cfg.gat_variant and (spec.name != VARIANT_ENGINE or spec.use_cache):
        raise ValueError(
            f"gat_variant={cfg.gat_variant!r} (the PyG stacks 'pyg' and "
            f"'pyg_v2') is taken by {VARIANT_ENGINE} without a cache alone, "
            f"not by {spec.name}{' with a cache' if spec.use_cache else ''}")


def _build_trainer(cfg: RunConfig, dataset: Dataset, device=None):
    spec = engine_from_config(cfg)
    _refuse_variant(cfg, spec)
    degree_mode = resolve_degree_mode(cfg)
    if spec.fullbatch:
        return FullBatchEngine(cfg, dataset, spec.family, spec.weight_kind,
                               device=device)
    if spec.multi_device:
        return _build_multi(cfg, dataset, spec, degree_mode, device)
    log = get_logger("sgnn.engine")
    if (cfg.estimator_advisor == "route" and not cfg.pushdown
            and not spec.use_cache):
        cfg = _route_by_advice(cfg, dataset, spec)
    pushdown_derived = cfg.pushdown and not spec.use_cache
    if pushdown_derived:
        spec = dataclasses.replace(spec, use_cache=True,
                                   cache_on_device=spec.device_sampling)
        _refuse_variant(cfg, spec)
    kw = dict(family=spec.family, weight_kind=spec.weight_kind,
              degree_mode=degree_mode, bias_correction=spec.bias_correction,
              device=device)
    if spec.use_cache and (spec.cache_on_device or (
            cfg.pd_refresh != "host" and not pushdown_derived)):
        from .device_cached import DeviceCachedSampleTrainer
        from .device_trainer import FeaturesExceedHbm

        try:
            return DeviceCachedSampleTrainer(
                cfg, dataset, family=spec.family,
                weight_kind=spec.weight_kind,
                bias_correction=spec.bias_correction, device=device)
        except FeaturesExceedHbm as exc:
            log.warning("%s: %s — the host-refreshed cached trainer "
                        "instead (beyond-device-memory posture)", spec.name,
                        exc)
    if spec.use_cache:
        from ..cache.orchestrator import CachedSampleTrainer

        return CachedSampleTrainer(cfg, dataset, **kw)
    if spec.device_sampling:
        from .device_trainer import DeviceSampleTrainer, FeaturesExceedHbm

        try:
            return DeviceSampleTrainer(cfg, dataset, **kw)
        except FeaturesExceedHbm as exc:
            # beyond-device-memory graph: degrade to the host-sampled
            # trainer, as the JAX package does
            log.warning("%s: %s — falling back to host sampling", spec.name,
                        exc)
            from .trainer import SampleTrainer

            return SampleTrainer(cfg, dataset, features_on_device=False, **kw)
    from .trainer import SampleTrainer

    return SampleTrainer(cfg, dataset, **kw)


def _build_multi(cfg: RunConfig, dataset: Dataset, spec: EngineSpec,
                 degree_mode: str, device):
    """The *MULTI engines, routed as the JAX package's
    (sgnn_tpu/train/engines.py:270-363) over this process's data-parallel
    group (parallel/mesh.make_group: a one-rank group, or torchrun's
    ranks).  *PCMULTI: the device-cached trainer with one global hot set
    under the data-parallel wrapper; under PD_REFRESH:host, or when the
    features exceed the device, the host-refreshed cached trainer (one
    global hot set) under the host-sampled wrapper.  *ALLMULTI: the
    device trainer under the data-parallel wrapper; past the device's
    memory the host-sampled trainer with host features under the
    host-sampled wrapper.  SHARD_FEATURES row-shards the device
    features."""
    from ..parallel.dp import DataParallelTrainer
    from ..parallel.dp_device import (
        DeviceCachedDataParallelTrainer, DeviceDataParallelTrainer,
    )
    from ..parallel.mesh import make_group
    from .device_trainer import FeaturesExceedHbm

    log = get_logger("sgnn.engine")
    group = make_group(device)
    device = group.device
    if spec.use_cache:
        if cfg.pd_refresh != "host":
            from .device_cached import DeviceCachedSampleTrainer

            try:
                base = DeviceCachedSampleTrainer(
                    cfg, dataset, family=spec.family,
                    weight_kind=spec.weight_kind,
                    bias_correction=spec.bias_correction, device=device,
                    per_sb=False)
                return DeviceCachedDataParallelTrainer(
                    base, group, shard_features=cfg.shard_features)
            except FeaturesExceedHbm as exc:
                log.warning("%s: %s — the host-refreshed cached "
                            "data-parallel composition instead", spec.name,
                            exc)
        from ..cache.orchestrator import CachedSampleTrainer

        # the ranks sample concurrently: one global hot set, as the
        # reference's multi-GPU cache engines keep (ntsDataloador.hpp:735)
        return DataParallelTrainer(CachedSampleTrainer(
            cfg, dataset, family=spec.family, weight_kind=spec.weight_kind,
            degree_mode=degree_mode, bias_correction=spec.bias_correction,
            device=device, per_sb=False), group)
    from .device_trainer import DeviceSampleTrainer
    from .trainer import SampleTrainer

    kw = dict(family=spec.family, weight_kind=spec.weight_kind,
              degree_mode=degree_mode, bias_correction=spec.bias_correction,
              device=device)
    try:
        base = DeviceSampleTrainer(cfg, dataset, **kw)
    except FeaturesExceedHbm as exc:
        log.warning("%s: %s — falling back to host sampling", spec.name, exc)
        return DataParallelTrainer(SampleTrainer(
            cfg, dataset, features_on_device=False, **kw), group)
    return DeviceDataParallelTrainer(base, group,
                                     shard_features=cfg.shard_features)


def run_engine(cfg: RunConfig, dataset: Dataset,
               epochs: Optional[int] = None, device=None):
    """Build and run the trainer an ALGORITHM string names (main.cpp
    parity).  RUNS repeats the whole run with fresh state and returns the
    last run's report.

    REORDER degree or bfs renumbers the vertices first (graph/reorder.py:
    the order, then the remapped dataset, then the trainer, as
    sgnn_tpu/train/engines.py:378-395); the report's per-vertex rows are
    then in the new ids, and `report.vertex_order` (order[new_id] =
    old_id) translates them back.  With none it is None."""
    n_runs = max(getattr(cfg, "runs", 1), 1)
    mode = getattr(cfg, "reorder", "none")
    order = None
    if mode and mode.lower() not in ("none", ""):
        from ..graph.reorder import apply_vertex_order, vertex_order

        order = vertex_order(dataset, mode)
        dataset, _ = apply_vertex_order(dataset, order)
    report = None
    for r in range(n_runs):
        report = build_trainer(cfg, dataset, device=device).run(epochs=epochs)
        report.vertex_order = order
        if n_runs > 1:
            get_logger("sgnn.engine").info(
                "run %d/%d: avg epoch %.4fs (TIME_SKIP=%d)",
                r + 1, n_runs, report.avg_epoch_time, cfg.time_skip)
    return report
