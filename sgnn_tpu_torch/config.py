"""Config system: `KEY:VALUE` .cfg files, parity with the reference's InputInfo.

The port's own copy of `sgnn_tpu/config.py` (the port imports nothing of
the JAX package): same fields, same defaults, same parser, so one .cfg file
gives equal RunConfigs in both packages.

Reference: core/GraphSegment.cpp:222 (InputInfo::readFromCfgFile) parses a
single cfg file of `KEY:VALUE` lines with `#` comments into ~35 knobs
(fields at core/GraphSegment.h:156-203).  We keep the same file format and
key names so reference cfg files (e.g. gcn_cora_sample.cfg) run unchanged,
and expose the result as a typed dataclass.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional


def _parse_dash_ints(s: str) -> List[int]:
    return [int(x) for x in s.split("-") if x != ""]


@dataclasses.dataclass
class RunConfig:
    """Typed mirror of the reference's InputInfo (core/GraphSegment.h:156)."""

    # model / algorithm selection (reference ALGORITHM string, main.cpp:68-183)
    algorithm: str = "GCNSAMPLEGPU"
    # graph
    vertices: int = 0
    edge_file: str = ""
    feature_file: str = ""
    label_file: str = ""
    mask_file: str = ""
    pre_sample_file: str = ""
    # model shape: e.g. "1433-256-7" → layer_sizes=[1433, 256, 7]
    layer_sizes: List[int] = dataclasses.field(default_factory=list)
    # sampling fanout per hop, seed-batch first: "25-10" → [25, 10]
    # (reference fanout[0] applies to the seed batch, ntsFastSampler.hpp:1003)
    fanout: List[int] = dataclasses.field(default_factory=lambda: [25, 10])
    batch_size: int = 1024
    batch_type: str = "shuffle"  # shuffle|random|sequence|dellow|delhigh
    epochs: int = 10
    # optimizer (reference Parameter, NtsScheduler.hpp:680)
    learn_rate: float = 0.01
    weight_decay: float = 1e-4
    decay_rate: float = 0.97
    decay_epoch: int = 100
    optimizer: str = "adam"          # adam | sgd (Parameter has both)
    adam_epsilon: float = 1e-9       # Adam's ε (the reference's; torch: 1e-8)
    drop_rate: float = 0.5
    heads: int = 1                   # GAT attention heads (1 = reference)
    # GAT layers: "" the reference system's; "pyg" PyG's GATConv stack of
    # examples/ogbn_products_gat.py (heads on every layer, the last
    # averaged, self-loops, biases, linear skips, ELU, dropout); "pyg_v2"
    # that stack with GATv2Conv layers; both taken by GATSAMPLEALLGPU
    # alone (train/engines.py refuses them elsewhere)
    gat_variant: str = ""
    scan_unroll: int = 1             # fused-epoch scan unroll factor
    # pipeline / cache orchestration (NeutronOrch)
    pipeline_num: int = 4
    cache_rate: float = 0.0          # hot-vertex embedding cache fraction
    feature_cache_rate: float = 0.0  # HBM feature cache fraction
    # "global" = one degree-ranked hot set; "per_sb" = per-super-batch hot
    # sets from presampled expected access frequency, swapped at SB
    # boundaries (the reference batch_cache_num discipline applied to the
    # FEATURE cache — raises hit rate when capacity << working set)
    feature_cache_plan: str = "global"
    cache: bool = False
    cache_type: str = "none"
    cache_policy: str = "degree"
    # devices / placement
    gpu_num: int = 1                 # reference GPU count → device count
    process_local: bool = False
    process_overlap: bool = False
    with_cuda: bool = True           # "CUDA" knob → run on accelerator
    # engine details
    lock_free: bool = True
    optim_kernel: bool = True
    up_degree: bool = False          # recompute degrees within sampled subgraph
    pushdown: bool = False           # serve bottom layer from the PD cache
    # PD-cache refresh placement: "auto" = device sampler + in-scan refresh
    # when topology+features fit HBM, host-sampled CPU-helper posture
    # beyond it (the reference pairs cache omission with its FASTEST
    # sampler, sample_gpu_fast_omit ntsFastSampler.hpp:711); "host"/"device"
    # force one side (tests, reference-exact comparisons)
    pd_refresh: str = "auto"
    # PROC_REP: parsed for cfg-file compat only.  The reference also never
    # consumes it — replication_threshold is assigned (main.cpp:65) but used
    # solely inside commented-out code (graph.hpp:3550 etc.).
    repthreshold: int = 0
    mini_pull: int = 0
    runs: int = 1
    time_skip: int = 3
    batch_norm: bool = False
    aggregator: str = "sum"          # sum | min | max (full-batch dst ops)
    shard_features: bool = False     # row-shard features over the mesh
    partition_graph: bool = False    # *FULLBATCH: vertex-shard over all devices
    halo: str = "all_gather"         # all_gather | targeted (sharded full-batch)
    # MXU_SPMM key of the JAX package's one-hot SpMM kernel; parsed for
    # cfg-file parity, the port's CSR SpMM kernel needs no switch
    mxu_spmm: str = "auto"
    # opt-in vertex renumbering for gather locality (graph/reorder.py):
    # none | degree | bfs — Gemini's degree-aware chunk placement analog
    # (core/graph.hpp:694-751); run_engine applies it at dataset load
    reorder: str = "none"
    # vertex-range balancing for sharded full-batch: "degree" = α·V+E cost
    # model (reference tune_chunks, graph.hpp:1837), "equal" = equal ranges
    partition_balance: str = "degree"
    # full-batch per-epoch metrics source: "clean" = an extra dropout-free
    # forward per epoch (exact accuracies; the historical default), "train"
    # = reuse the training forward's output (dropout-active — the
    # REFERENCE's accounting: Train Acc comes from the same X the loss
    # used, GCN_SAMPLE_ALLGPU.hpp:361 getCorrect(X[last]); saves a full
    # forward — ~2 SpMM passes — per epoch)
    metrics: str = "clean"
    # estimator-regime advisor (train/advisor.py): warn (default) logs a
    # structured warning when a batch's bottom hop covers most of the
    # graph (sampled training then redoes near-whole-graph work per step);
    # route additionally enables the PUSHDOWN bottom-hop composition;
    # off silences
    estimator_advisor: str = "warn"
    classes: int = 0
    del_frac: float = 0.0
    # extras (ours)
    remat: bool = False              # sublinear activation memory (ref
    #                                  SubLinearMemCostNNOP analog)
    # device-sampler source-pad sizing: 0 = exact worst-case bounds;
    # >0 (e.g. 1.2) = expected-unique estimate × factor with safe
    # overflow-drop semantics (slight under-sampling, big shape savings)
    src_pad_factor: float = 0.0
    seed: int = 0
    dtype: str = "float32"           # compute dtype for activations
    param_dtype: str = "float32"
    # FEATURE storage dtype: "" follows `dtype`; "int8" stores the feature
    # matrix (device-resident and the beyond-HBM hot cache) per-column
    # quantized — 4x the rows of f32 in the same HBM (data/quant.py)
    feature_dtype: str = ""
    # HBM byte budget for feature residency decisions (0 = probe the live
    # device, utils/profiling.memory_budget).  Mirrors the reference's
    # free-memory probe determine_cache_node_idx (GCN_SAMPLE_PD_CACHE.hpp:
    # 1039); a forced value makes beyond-HBM behavior testable anywhere.
    hbm_budget: int = 0

    @property
    def num_layers(self) -> int:
        return len(self.layer_sizes) - 1

    @property
    def num_classes(self) -> int:
        return self.classes if self.classes > 0 else (self.layer_sizes[-1] if self.layer_sizes else 0)

    def resolve_paths(self, base_dir: str) -> "RunConfig":
        """Make data file paths absolute relative to `base_dir`."""
        out = dataclasses.replace(self)
        for f in ("edge_file", "feature_file", "label_file", "mask_file", "pre_sample_file"):
            p = getattr(out, f)
            if p and not os.path.isabs(p):
                setattr(out, f, os.path.normpath(os.path.join(base_dir, p)))
        return out


# cfg KEY → (field, converter). Key names match GraphSegment.cpp:222-347.
_BOOLS = {"0": False, "1": True, "true": True, "false": False,
          "TRUE": True, "FALSE": False, "True": True, "False": False}


def _to_bool(s: str) -> bool:
    return _BOOLS.get(s.strip(), bool(int(s)))


_KEYMAP = {
    "ALGORITHM": ("algorithm", str),
    "VERTICES": ("vertices", int),
    "EPOCHS": ("epochs", int),
    "ITERATIONS": ("epochs", int),
    "LAYERS": ("layer_sizes", _parse_dash_ints),
    "FANOUT": ("fanout", _parse_dash_ints),
    "BATCH_SIZE": ("batch_size", int),
    "BATCH_TYPE": ("batch_type", str),
    "EDGE_FILE": ("edge_file", str),
    "FEATURE_FILE": ("feature_file", str),
    "LABEL_FILE": ("label_file", str),
    "MASK_FILE": ("mask_file", str),
    "PRE_SAMPLE_FILE": ("pre_sample_file", str),
    "LEARN_RATE": ("learn_rate", float),
    "WEIGHT_DECAY": ("weight_decay", float),
    "DECAY_RATE": ("decay_rate", float),
    "DECAY_EPOCH": ("decay_epoch", int),
    "DROP_RATE": ("drop_rate", float),
    "HEADS": ("heads", int),
    "GAT_VARIANT": ("gat_variant", str),
    "ADAM_EPSILON": ("adam_epsilon", float),
    "SCAN_UNROLL": ("scan_unroll", int),
    "PIPELINE_NUM": ("pipeline_num", int),
    "CACHE_RATE": ("cache_rate", float),
    "FEATURE_CACHE_RATE": ("feature_cache_rate", float),
    "FEATURE_CACHE_PLAN": ("feature_cache_plan", str),
    "CACHE": ("cache", _to_bool),
    "CACHE_TYPE": ("cache_type", str),
    "CACHE_POLICY": ("cache_policy", str),
    "GPU_NUM": ("gpu_num", int),
    "PROC_LOCAL": ("process_local", _to_bool),
    "PROC_OVERLAP": ("process_overlap", _to_bool),
    "PROC_CUDA": ("with_cuda", _to_bool),
    "CUDA": ("with_cuda", _to_bool),
    "LOCK_FREE": ("lock_free", _to_bool),
    "OPTIM_KERNEL": ("optim_kernel", _to_bool),
    "UP_DEGREE": ("up_degree", _to_bool),
    "PUSHDOWN": ("pushdown", _to_bool),
    "PD_REFRESH": ("pd_refresh", str),
    "PROC_REP": ("repthreshold", int),
    "MINI_PULL": ("mini_pull", int),
    "OPTIMIZER": ("optimizer", str),
    "AGGREGATOR": ("aggregator", str),
    "SHARD_FEATURES": ("shard_features", _to_bool),
    "PARTITION_GRAPH": ("partition_graph", _to_bool),
    "HALO": ("halo", str),
    "MXU_SPMM": ("mxu_spmm", str),
    "REORDER": ("reorder", str),
    "METRICS": ("metrics", str),
    "ESTIMATOR_ADVISOR": ("estimator_advisor", str),
    "PARTITION_BALANCE": ("partition_balance", str),
    "RUNS": ("runs", int),
    "TIME_SKIP": ("time_skip", int),
    "BATCH_NORM": ("batch_norm", _to_bool),
    "CLASSES": ("classes", int),
    "DEL_FRAC": ("del_frac", float),
    "SEED": ("seed", int),
    "DTYPE": ("dtype", str),
    "FEATURE_DTYPE": ("feature_dtype", str),
    "REMAT": ("remat", _to_bool),
    "SUBLINEAR": ("remat", _to_bool),
    "SRC_PAD_FACTOR": ("src_pad_factor", float),
    "HBM_BUDGET": ("hbm_budget", int),
}


def parse_cfg_text(text: str) -> RunConfig:
    cfg = RunConfig()
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line or ":" not in line:
            continue
        key, val = line.split(":", 1)
        key, val = key.strip(), val.strip()
        if key in _KEYMAP:
            field, conv = _KEYMAP[key]
            setattr(cfg, field, conv(val))
    return cfg


def load_cfg(path: str) -> RunConfig:
    """Load a reference-format .cfg file; data paths resolved against its dir."""
    with open(path) as f:
        cfg = parse_cfg_text(f.read())
    return cfg.resolve_paths(os.path.dirname(os.path.abspath(path)))
