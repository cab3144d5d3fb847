"""Engine registry: reference ALGORITHM strings → trainer policies.

The port of sgnn_tpu/train/engines.py.  Reference: toolkits/main.cpp:46-183
dispatches 14 engine classes, one per (model × placement × caching ×
#GPU); here one trainer is parameterised by policy knobs, so every
ALGORITHM string maps to a configuration.  The table is the JAX package's
in full; the port trains GCNSAMPLESINGLE, GCNSAMPLEGPU, GCNSAMPLEALLGPU,
GSSAMPLEALLGPU and GATSAMPLEALLGPU (sampled) and GCNFULLBATCH, GSFULLBATCH
and GATFULLBATCH (whole graph, `FullBatchEngine`), and every other engine,
and every option the port does not take yet, raises NotImplementedError
naming its ROADMAP item.

Placement: *SAMPLESINGLE → bias-corrected Adam (CPU engines); *SAMPLEGPU →
host sampler; *ALLGPU → device sampler; *FULLBATCH → whole-graph training
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


def _not_ported(spec: EngineSpec, cfg: RunConfig) -> Optional[str]:
    """The ROADMAP item a configuration waits for, or None if the port
    trains it.  PUSHDOWN and the advisor concern sampled engines only: a
    *FULLBATCH engine ignores them, as in the JAX package."""
    reorder = "REORDER: graph/reorder.py (ROADMAP Queue 1 item 7)"
    if spec.fullbatch:
        return reorder if (cfg.reorder or "none").lower() not in (
            "none", "") else None
    if spec.multi_device:
        return f"{spec.name}: data-parallel training (ROADMAP Queue 1 item 6)"
    if spec.use_cache:
        return f"{spec.name}: caches and PD-cache engines (ROADMAP Queue 1 item 5)"
    if cfg.pushdown:
        return "PUSHDOWN: the PD-cache composition (ROADMAP Queue 1 item 5)"
    if getattr(cfg, "estimator_advisor", "warn") == "route":
        return ("ESTIMATOR_ADVISOR:route: the advisor (ROADMAP Queue 1 "
                "item 5)")
    if (cfg.reorder or "none").lower() not in ("none", ""):
        return reorder
    return None


class FullBatchEngine:
    """Adapter giving FullBatchTrainer the sampled trainers' run() contract
    (sgnn_tpu/train/engines.py:124-192): `run()` returns a TrainReport with
    every epoch's edges = the graph's edge count, and the wrapped trainer
    is on `.base`."""

    def __init__(self, cfg: RunConfig, dataset: Dataset, family: str,
                 weight_kind: WeightKind, device=None) -> None:
        from .fullbatch import FullBatchTrainer

        self.cfg = cfg
        self.base = FullBatchTrainer(cfg, dataset, family=family,
                                     weight_kind=weight_kind, halo=cfg.halo,
                                     device=device)

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

    def run(self, epochs: Optional[int] = None):
        from ..utils.timing import PhaseTimer
        from .trainer import TrainReport

        hist = self.base.run(epochs)
        return TrainReport(
            epoch_times=[h["time"] for h in hist],
            train_acc=[h["train"] for h in hist],
            val_acc=[h["val"] for h in hist],
            test_acc=[h["test"] for h in hist],
            losses=[h["loss"] for h in hist],
            edges_per_epoch=[int(self.base.adj.num_edges)] * len(hist),
            timers=PhaseTimer(),
            time_skip=self.cfg.time_skip)


def build_trainer(cfg: RunConfig, dataset: Dataset, device=None):
    """Construct (without running) the trainer an ALGORITHM string names,
    on `device` (None means CUDA)."""
    spec = engine_from_config(cfg)
    missing = _not_ported(spec, cfg)
    if missing is not None:
        raise NotImplementedError(missing)
    degree_mode = resolve_degree_mode(cfg)
    if spec.fullbatch:
        return FullBatchEngine(cfg, dataset, spec.family, spec.weight_kind,
                               device=device)
    kw = dict(family=spec.family, weight_kind=spec.weight_kind,
              degree_mode=degree_mode, bias_correction=spec.bias_correction,
              device=device)
    if spec.device_sampling:
        from .device_trainer import DeviceSampleTrainer, FeaturesExceedHbm

        try:
            return DeviceSampleTrainer(cfg, dataset, **kw)
        except FeaturesExceedHbm as exc:
            # beyond-device-memory graph: degrade to the host-sampled
            # trainer, as the JAX package does
            get_logger("sgnn.engine").warning(
                "%s: %s — falling back to host sampling", spec.name, exc)
            from .trainer import SampleTrainer

            return SampleTrainer(cfg, dataset, features_on_device=False, **kw)
    from .trainer import SampleTrainer

    return SampleTrainer(cfg, dataset, **kw)


def run_engine(cfg: RunConfig, dataset: Dataset,
               epochs: Optional[int] = None, device=None):
    """Build and run the trainer an ALGORITHM string names (main.cpp
    parity).  RUNS repeats the whole run with fresh state and returns the
    last run's report."""
    n_runs = max(getattr(cfg, "runs", 1), 1)
    report = None
    for r in range(n_runs):
        report = build_trainer(cfg, dataset, device=device).run(epochs=epochs)
        if n_runs > 1:
            get_logger("sgnn.engine").info(
                "run %d/%d: avg epoch %.4fs (TIME_SKIP=%d)",
                r + 1, n_runs, report.avg_epoch_time, cfg.time_skip)
    return report
