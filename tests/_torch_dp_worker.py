"""One rank of a CPU data-parallel run of the port (gloo over a FileStore).

    python tests/_torch_dp_worker.py CASE RANK WORLD STORE IN_NPZ OUT_NPZ

Launched by tests/test_torch_port_dp.py, tests/test_torch_port_dp_device.py
and tests/test_torch_port_partition.py (`run_ranks`), one process a rank.
It imports torch, numpy and the port, never JAX: the tests hold what it
writes against the JAX package in their own process.  IN_NPZ carries the
case's inputs, OUT_NPZ receives this rank's results.  Any error exits 1 at
once, so the launcher can stop the other ranks instead of leaving them in
a collective.
"""

import dataclasses
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from sgnn_tpu_torch.config import RunConfig, load_cfg  # noqa: E402
from sgnn_tpu_torch.data.synthetic import random_graph_dataset  # noqa: E402
from sgnn_tpu_torch.models.gnn import params_from_numpy  # noqa: E402
from sgnn_tpu_torch.parallel.mesh import make_group  # noqa: E402

CORA_CFG = os.path.join(ROOT, "configs", "gcn_cora_sample.cfg")


def warm_cpu_exp():
    """One `torch.exp` over all of the process's CPU threads.  The first
    exp of a fresh process can take another code path on the part of a
    tensor that a not-yet-used thread computes, under load (measured: 2260
    of 4530 elements off by up to 1.5e-4 relative, torch 2.13 on the
    CPU; later calls agree bit for bit): a GAT layer's plain version on
    its first call then strays past the f32 tolerance."""
    torch.exp(torch.zeros(1 << 20))


def tiny_ds():
    return random_graph_dataset(num_vertices=500, avg_degree=8,
                                feature_dim=32, num_classes=5, seed=7)


def cora_ds():
    from sgnn_tpu_torch.data.nts_format import load_from_config

    return load_from_config(load_cfg(CORA_CFG))


def load_params(inp, prefix="w"):
    n = int(inp[f"{prefix}_n"])
    return params_from_numpy([inp[f"{prefix}{i}"] for i in range(n)],
                             device="cpu")


def params_out(params, prefix="p"):
    return {f"{prefix}{i}": w.numpy() for i, w in
            enumerate(params.leaves())}


def case_grad_step(inp, group):
    """One data-parallel step on carried blocks: the rank's batch, the
    gradients summed over the ranks, one update."""
    from sgnn_tpu_torch.parallel.dp import DataParallelTrainer
    from sgnn_tpu_torch.sampler.blocks import SampledBatch, SampledBlock
    from sgnn_tpu_torch.train.trainer import SampleTrainer

    cfg = RunConfig(layer_sizes=[32, 16, 5], fanout=[4, 3], batch_size=16,
                    drop_rate=0.0, learn_rate=0.01)
    base = SampleTrainer(cfg, tiny_ds(), family="gcn", device="cpu")
    base.params = load_params(inp)
    DataParallelTrainer(base, group)
    mine = f"r{group.rank}_"

    def t(name):
        return torch.from_numpy(inp[mine + name])

    blocks = [SampledBlock(**{k: t(f"b{h}_{k}") for k in (
        "nbr", "weight", "srcs", "seeds", "dst_valid", "src_valid",
        "seed_in_src")}) for h in range(int(inp[mine + "n_blocks"]))]
    batch = SampledBatch(blocks=blocks, x0=t("x0"), labels=t("labels"),
                         label_valid=t("label_valid"))
    loss, acc = base.train_step(batch)
    return {"loss": loss.numpy(), "acc": acc.numpy(),
            **params_out(base.params)}


def _cfg_from(inp, base_cfg):
    change = json.loads(str(inp["cfg"]))
    return dataclasses.replace(base_cfg, **change)


def case_host_epochs(inp, group):
    """The host-sampled data-parallel trainer for a few epochs from carried
    weights (an optional train-set cut makes the shards uneven)."""
    from sgnn_tpu_torch.parallel.dp import DataParallelTrainer
    from sgnn_tpu_torch.train import build_trainer
    from sgnn_tpu_torch.train.trainer import SampleTrainer

    ds = tiny_ds()
    cfg = _cfg_from(inp, RunConfig(layer_sizes=[32, 16, 5], fanout=[4, 3],
                                   vertices=ds.num_vertices))
    if cfg.algorithm == "GCNSAMPLEGPU":
        tr = DataParallelTrainer(SampleTrainer(cfg, ds, family="gcn",
                                               device="cpu"), group)
    else:
        tr = build_trainer(cfg, ds, device="cpu")
    tr.base.params = load_params(inp)
    if "n_train" in inp:
        tr.base.train_nids = tr.base.train_nids[: int(inp["n_train"])]
    rows = []
    for _ in range(int(inp["epochs"])):
        loss, acc, edges = tr.train_epoch()
        rows.append([loss, acc, edges, getattr(tr, "cache_hits", 0),
                     getattr(tr, "cache_lookups", 0)])
    out = {"rows": np.array(rows, np.float64), "type": type(tr).__name__,
           "base_type": type(tr.base).__name__,
           "val": tr.evaluate(tr.base.val_nids), **params_out(tr.params)}
    if hasattr(tr.base, "w_queue"):
        out["w_version"] = tr.base.w_queue.version
        out["per_sb"] = tr.base.per_sb
    return out


def case_fetch(inp, group):
    """fetch_feature_rows of this rank's request ids from row shards."""
    from sgnn_tpu_torch.parallel.sharded_features import fetch_feature_rows

    out = {}
    for name in ("f32", "int8"):
        feats = torch.from_numpy(inp[f"feats_{name}"])
        rows = -(-feats.shape[0] // group.world_size)
        pad = torch.zeros((rows * group.world_size, feats.shape[1]),
                          dtype=feats.dtype)
        pad[: feats.shape[0]] = feats
        local = pad[group.rank * rows:(group.rank + 1) * rows]
        src = torch.from_numpy(inp[f"src{group.rank}"])
        out[name] = fetch_feature_rows(local, src, group,
                                       chunk=int(inp["chunk"])).numpy()
    return out


def case_learn(inp, group):
    """Each *MULTI engine from the shipped Cora cfg: the best train
    accuracy over its epochs."""
    from sgnn_tpu_torch.train import build_trainer

    ds = cora_ds()
    best = {}
    for algo in json.loads(str(inp["engines"])):
        cfg = dataclasses.replace(load_cfg(CORA_CFG), algorithm=algo,
                                  edge_file="")
        tr = build_trainer(cfg, ds, device="cpu")
        epochs = int(inp["epochs"])
        rep = tr.run(epochs, eval_every=epochs)
        best[algo] = [max(rep.train_acc), rep.losses[0], rep.losses[-1],
                      rep.val_acc[-1]]
    return {"best": json.dumps(best)}


def case_shard(inp, group):
    """GCNSAMPLEALLMULTI with replicated and with row-sharded features from
    the same seed and weights: the final parameters of each."""
    from sgnn_tpu_torch.train import build_trainer

    ds = tiny_ds()
    out = {}
    for dtype in ("float32", "int8"):
        for shard in (False, True):
            cfg = RunConfig(algorithm="GCNSAMPLEALLMULTI",
                            layer_sizes=[32, 16, 5], fanout=[4, 3],
                            batch_size=64, drop_rate=0.0,
                            vertices=ds.num_vertices, feature_dtype=dtype,
                            shard_features=shard)
            tr = build_trainer(cfg, ds, device="cpu")
            assert (tr.base.dev_features is None) == shard
            tag = f"{dtype}_{'shard' if shard else 'rep'}"
            losses = [tr.train_epoch()[0] for _ in range(2)]
            out[f"{tag}_loss"] = np.array(losses)
            out[f"{tag}_val"] = tr.evaluate(tr.base.val_nids)
            out.update(params_out(tr.params, f"{tag}_p"))
    return out


def case_ckpt(inp, group):
    """Checkpoints of the two data-parallel trainers: a run saved after
    its first epoch and resumed for the second against an uninterrupted
    run (both evaluating each epoch), and the number of files this rank
    wrote."""
    from sgnn_tpu_torch.train import build_trainer
    from sgnn_tpu_torch.train.checkpoint import run_with_checkpointing

    ds = tiny_ds()
    out = {}
    for tag, change in (("device", dict(algorithm="GCNSAMPLEALLMULTI")),
                        ("host", dict(algorithm="GCNSAMPLEPCMULTI",
                                      pd_refresh="host"))):
        cfg = RunConfig(layer_sizes=[32, 16, 5], fanout=[4, 3],
                        batch_size=64, pipeline_num=2, drop_rate=0.5,
                        vertices=ds.num_vertices, **change)
        root = os.path.join(str(inp["dir"]), tag)
        straight = build_trainer(cfg, ds, device="cpu")
        run_with_checkpointing(straight, os.path.join(root, "straight"), 2)
        writes = []
        save = torch.save

        def counted(obj, f, *a, **k):
            writes.append(f)
            return save(obj, f, *a, **k)

        torch.save = counted
        try:
            first = build_trainer(cfg, ds, device="cpu")
            run_with_checkpointing(first, os.path.join(root, "ck"), 1)
        finally:
            torch.save = save
        resumed = build_trainer(cfg, ds, device="cpu")
        rep = run_with_checkpointing(resumed, os.path.join(root, "ck"), 2)
        out[f"{tag}_writes"] = len(writes)
        out[f"{tag}_epochs"] = len(rep.epoch_times)
        out[f"{tag}_equal"] = all(
            torch.equal(a, b) for a, b in zip(straight.params.leaves(),
                                              resumed.params.leaves()))
    return out


def _partition_plan(adj, w, n, halo, balance):
    from sgnn_tpu_torch.parallel.halo import build_targeted_halo, shard_graph

    if halo == "targeted":
        return build_targeted_halo(adj, n, w, balance=balance)
    return shard_graph(adj, n, w, balance=balance)


def case_partition_layers(inp, group):
    """The shard-local layers behind both halos on this rank's shard of
    carried slot tables: the exchange against its one-process reference,
    the GCN aggregation's output and input gradient, and the GAT layer's
    output and gradients (h, W, attention: this rank's partials)."""
    from sgnn_tpu_torch.graph.adjacency import Adjacency
    from sgnn_tpu_torch.parallel.halo import (
        exchange_reference, halo_exchange, shard_on_device,
        sharded_aggregate, sharded_aggregate_targeted, sharded_gat_layer,
    )
    from sgnn_tpu_torch.sampler.blocks import WeightKind
    from sgnn_tpu_torch.train.fullbatch import build_coo

    group = make_group("cpu", graph=group.world_size)
    ds = tiny_ds()
    adj = Adjacency.from_edges(ds.edges, ds.num_vertices)
    n, r = group.world_size, group.rank
    out = {}
    for halo in ("all_gather", "targeted"):
        for wk in (WeightKind.GCN, WeightKind.NONE):
            _, _, w = build_coo(adj, wk)
            plan = _partition_plan(adj, w, n, halo, "degree")
            shard = shard_on_device(plan, r, "cpu")
            rows = plan.rows_per_shard
            mine = slice(r * rows, (r + 1) * rows)
            tag = f"{halo}_{wk.name}"
            if wk == WeightKind.GCN:
                x = torch.from_numpy(inp["x"])
                ext = halo_exchange(x[mine].contiguous(), shard, group)
                out[f"{tag}_exchange_equal"] = torch.equal(
                    ext, exchange_reference(plan, r, x))
                agg = (sharded_aggregate_targeted if halo == "targeted"
                       else sharded_aggregate)
                grads = []
                for _ in range(2):   # the second run must repeat bit for bit
                    xs = x[mine].clone().requires_grad_()
                    y = agg(xs, shard, group)
                    (y * torch.from_numpy(inp["c"])[mine]).sum().backward()
                    grads.append(xs.grad)
                out[f"{tag}_out"], out[f"{tag}_dx"] = (
                    y.detach().numpy(), xs.grad.numpy())
                out[f"{tag}_repeat_equal"] = torch.equal(*grads)
                continue
            heads = int(inp["heads"])
            h = torch.from_numpy(inp["h"])[mine].clone().requires_grad_()
            wl = torch.from_numpy(inp["wl"]).requires_grad_()
            attn = torch.from_numpy(inp["attn"]).requires_grad_()
            y = sharded_gat_layer(h @ wl, attn, shard, group, heads)
            (y * torch.from_numpy(inp["c_gat"])[mine]).sum().backward()
            out.update({f"{tag}_out": y.detach().numpy(),
                        f"{tag}_dh": h.grad.numpy(),
                        f"{tag}_dw": wl.grad.numpy(),
                        f"{tag}_da": attn.grad.numpy()})
    return out


def case_partition_train(inp, group):
    """FullBatchTrainer on the graph group for each carried configuration
    (its JAX parameters, or its own at drop > 0): per-epoch (loss, train,
    val, test), the final parameters and predict(); a configuration marked
    `repeat` trains twice and reports whether the two runs' parameters are
    bit-identical.  Then the engine's routing under PARTITION_GRAPH:1."""
    from sgnn_tpu_torch.sampler.blocks import WeightKind
    from sgnn_tpu_torch.train import build_trainer
    from sgnn_tpu_torch.train.fullbatch import FullBatchTrainer

    group = make_group("cpu", graph=group.world_size)
    ds = tiny_ds()
    out = {}

    def train(c):
        tr = FullBatchTrainer(RunConfig(**c["cfg"]), ds, family=c["family"],
                              weight_kind=WeightKind[c["weight_kind"]],
                              mesh=group, halo=c["halo"], device="cpu")
        if f"{c['id']}_w_n" in inp:
            n = int(inp[f"{c['id']}_w_n"])
            leaves = [inp[f"{c['id']}_w{i}"] for i in range(n)]
            nw = len(tr.params.weights)
            tr.params = params_from_numpy(leaves[:nw], leaves[nw:],
                                          device="cpu")
        rows = [tr.train_epoch() for _ in range(int(c["epochs"]))]
        return tr, np.array(rows, np.float64)

    for c in json.loads(str(inp["configs"])):
        tr, rows = train(c)
        out[f"{c['id']}_rows"] = rows
        out[f"{c['id']}_pred"] = tr.predict()
        out.update(params_out(tr.params, f"{c['id']}_p"))
        if c.get("repeat"):
            again, rows2 = train(c)
            out[f"{c['id']}_repeat_equal"] = bool(np.array_equal(
                rows, rows2) and all(torch.equal(a, b) for a, b in zip(
                    tr.params.leaves(), again.params.leaves())))
    eng = build_trainer(RunConfig(algorithm="GCNFULLBATCH",
                                  layer_sizes=[32, 16, 5],
                                  vertices=ds.num_vertices,
                                  partition_graph=True, halo="targeted",
                                  partition_balance="equal"), ds,
                        device="cpu")
    out["engine"] = json.dumps({
        "type": type(eng).__name__, "world": eng.group.world_size,
        "graph": eng.base.group.graph, "rows": eng.base.shard.rows,
        "targeted": eng.base.shard.send_idx is not None,
        "offsets": eng.base.sharded.offsets.tolist()})
    return out


def run_ranks(case, inputs, tmp_path, world=2, timeout=120.0):
    """Run CASE on WORLD ranks, one process each (gloo over a FileStore in
    `tmp_path`: no TCP port), and return each rank's results.  A rank that
    fails stops the others at once; a run past `timeout` seconds is killed
    and fails."""
    import subprocess
    import time

    inp = os.path.join(tmp_path, f"{case}.in.npz")
    np.savez(inp, **inputs)
    store = os.path.join(tmp_path, f"{case}.store")
    outs = [os.path.join(tmp_path, f"{case}.rank{r}.npz")
            for r in range(world)]
    logs = [open(os.path.join(tmp_path, f"{case}.rank{r}.log"), "w+")
            for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r),
         str(world), store, inp, outs[r]], stdout=logs[r],
        stderr=subprocess.STDOUT, env=env) for r in range(world)]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = (f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                          if bad else f"timed out after {timeout} s")
                break
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if failed is None and bad:
            failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r}\n" + f.read()[-4000:])
        f.close()
    if failed is not None:
        raise AssertionError(f"{case}: {failed}\n" + "\n".join(text))
    return [dict(np.load(o, allow_pickle=False)) for o in outs]


CASES = {"grad_step": case_grad_step, "host_epochs": case_host_epochs,
         "fetch": case_fetch, "learn": case_learn, "shard": case_shard,
         "ckpt": case_ckpt, "partition_layers": case_partition_layers,
         "partition_train": case_partition_train}


def main() -> int:
    case, rank, world, store, inp_path, out_path = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.manual_seed(0)
    warm_cpu_exp()
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    group = make_group("cpu")
    assert (group.rank, group.world_size) == (rank, world)
    inp = dict(np.load(inp_path, allow_pickle=False))
    out = CASES[case](inp, group)
    np.savez(out_path, **out)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001 — reported, then a hard exit that
        # stops this rank at once (the launcher then stops the others)
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    sys.exit(code)
