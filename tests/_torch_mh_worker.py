"""One rank of a multi-host run of the port on the CPU (gloo over TCP).

    python tests/_torch_mh_worker.py --nprocs N --pid P --port PORT \
        --mode {dp,all} --inp IN_NPZ --out OUT_NPZ

Launched by tests/test_torch_port_multihost.py, one process a rank, as
tests/_mh_worker.py is for the JAX package; it imports torch, numpy and
the port, never JAX.  Every rank joins through
`initialize_distributed("127.0.0.1:PORT", N, P, device="cpu")` and writes
its own results.  The data and configurations are the JAX worker's
(`random_graph_dataset(500, 8, 32, 5, seed=7)`, 32-16-5,
tests/_mh_worker.py:50-95).  IN_NPZ carries initial parameters made by
the JAX package (`w_n`, `w0`...), RNG not crossing frameworks: the runs
compared with the JAX package start from them (`jax_init`).

- dp: the host-sampled driver, 2 epochs at drop 0, from those parameters.
- all: the whole-graph driver at drop 0.5 for 4 epochs and at drop 0 for
  2 epochs from those parameters; its kill-and-resume, 2 + 2 epochs
  through `multihost_checkpoint_save/restore`; the device-sampled driver,
  without and with SHARD_FEATURES, and the *PCMULTI driver for 4 epochs,
  each beside the *MULTI engine `build_trainer` makes on the same group;
  the device-sampled kill-and-resume.
"""

import argparse
import contextlib
import dataclasses
import os
import sys
import traceback

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from sgnn_tpu_torch.config import RunConfig  # noqa: E402
from sgnn_tpu_torch.data.synthetic import random_graph_dataset  # noqa: E402
from sgnn_tpu_torch.models.gnn import params_from_numpy  # noqa: E402
from sgnn_tpu_torch.parallel import multihost as mh  # noqa: E402

EPOCHS = 4
FULL_CFG = dict(layer_sizes=[32, 16, 5], fanout=[1, 1], epochs=EPOCHS,
                learn_rate=0.02, drop_rate=0.5, vertices=500)
DEVICE_CFG = dict(layer_sizes=[32, 16, 5], fanout=[4, 3], batch_size=32,
                  epochs=EPOCHS, drop_rate=0.0, vertices=500,
                  batch_type="sequence")
PCMULTI_CFG = dict(DEVICE_CFG, pipeline_num=2, cache_rate=0.1,
                   algorithm="GCNSAMPLEPCMULTI")


def tiny_ds():
    return random_graph_dataset(num_vertices=500, avg_degree=8,
                                feature_dim=32, num_classes=5, seed=7)


@contextlib.contextmanager
def jax_init(inp):
    """The port's trainers start from the JAX initial parameters in
    IN_NPZ: their modules' `init_model` returns them meanwhile."""
    import sgnn_tpu_torch.train.fullbatch as fullbatch
    import sgnn_tpu_torch.train.trainer as trainer

    weights = [inp[f"w{i}"] for i in range(int(inp["w_n"]))]

    def init(seed, family, layer_sizes, device=None, **_):
        return params_from_numpy(weights, device=device)

    saved = fullbatch.init_model, trainer.init_model
    fullbatch.init_model = trainer.init_model = init
    try:
        yield
    finally:
        fullbatch.init_model, trainer.init_model = saved


def weights(state, prefix):
    return {f"{prefix}_p{i}": w.numpy()
            for i, w in enumerate(state["params"]["weights"])}


def params_of(tr, prefix):
    return {f"{prefix}_p{i}": w.detach().numpy()
            for i, w in enumerate(tr.params.weights)}


def halves(run, ckpt_dir, **kw):
    """`run` for EPOCHS / 2 epochs, a checkpoint, then a new run resumed
    from it for the rest: (losses, the final state)."""
    half = EPOCHS // 2
    state = {}
    losses = run(epochs=half, state_out=state, **kw)
    mh.multihost_checkpoint_save(ckpt_dir, half, state)
    got = mh.multihost_checkpoint_restore(ckpt_dir)
    assert got is not None and got["step"] == half, got
    state2 = {}
    losses += run(epochs=EPOCHS - half, resume_state=got, state_out=state2,
                  **kw)
    return losses, state2


def mode_dp(inp, ds):
    cfg = RunConfig(layer_sizes=[32, 16, 5], fanout=[4, 3], batch_size=32,
                    epochs=2, drop_rate=0.0, vertices=500)
    with jax_init(inp):
        return {"losses": np.array(mh.run_multihost_dp_epochs(
            cfg, ds, epochs=2, device="cpu"))}


def mode_all(inp, ds, ckpt_root):
    from sgnn_tpu_torch.train import build_trainer

    out = {}
    # whole graph: drop 0.5 straight and resumed, drop 0 from JAX's init
    cfg = RunConfig(**FULL_CFG)
    state = {}
    out["full_losses"] = np.array(mh.run_multihost_fullbatch_epochs(
        cfg, ds, state_out=state, device="cpu"))
    out.update(weights(state, "full"))
    losses, state = halves(
        lambda **kw: mh.run_multihost_fullbatch_epochs(cfg, ds, device="cpu",
                                                       **kw),
        os.path.join(ckpt_root, "full"))
    out["full_resumed_losses"] = np.array(losses)
    out.update(weights(state, "full_resumed"))
    state = {}
    with jax_init(inp):
        out["full0_losses"] = np.array(mh.run_multihost_fullbatch_epochs(
            dataclasses.replace(cfg, drop_rate=0.0), ds, epochs=2,
            state_out=state, device="cpu"))
    out.update(weights(state, "full0"))
    # device-sampled data parallelism beside the *MULTI engines
    for tag, shard in (("device", False), ("device_sf", True)):
        cfg = RunConfig(**DEVICE_CFG, shard_features=shard)
        state = {}
        out[f"{tag}_losses"] = np.array(mh.run_multihost_device_dp_epochs(
            cfg, ds, shard_features=shard, state_out=state, device="cpu"))
        out.update(weights(state, tag))
        eng = build_trainer(dataclasses.replace(
            cfg, algorithm="GCNSAMPLEALLMULTI"), ds, device="cpu")
        out[f"{tag}_engine_type"] = type(eng).__name__
        out[f"{tag}_engine_losses"] = np.array(
            [eng.train_epoch()[0] for _ in range(EPOCHS)])
        out.update(params_of(eng, f"{tag}_engine"))
    cfg = RunConfig(**DEVICE_CFG)
    losses, state = halves(
        lambda **kw: mh.run_multihost_device_dp_epochs(cfg, ds, device="cpu",
                                                       **kw),
        os.path.join(ckpt_root, "device"))
    out["device_resumed_losses"] = np.array(losses)
    out.update(weights(state, "device_resumed"))
    # *PCMULTI beside its engine
    cfg = RunConfig(**PCMULTI_CFG)
    state = {}
    out["pcmulti_losses"] = np.array(mh.run_multihost_pcmulti_epochs(
        cfg, ds, state_out=state, device="cpu"))
    out.update(weights(state, "pcmulti"))
    eng = build_trainer(cfg, ds, device="cpu")
    out["pcmulti_engine_type"] = type(eng).__name__
    out["pcmulti_engine_losses"] = np.array(
        [eng.train_epoch()[0] for _ in range(EPOCHS)])
    out.update(params_of(eng, "pcmulti_engine"))
    out["pcmulti_hit_rate"] = eng.cache_hit_rate
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--mode", choices=["dp", "all"], required=True)
    ap.add_argument("--inp", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    torch.manual_seed(0)
    torch.exp(torch.zeros(1 << 20))   # tests/_torch_dp_worker.warm_cpu_exp
    rank, world = mh.initialize_distributed(
        f"127.0.0.1:{a.port}", a.nprocs, a.pid, device="cpu", timeout_s=120)
    assert (rank, world) == (a.pid, a.nprocs), (rank, world)
    inp = dict(np.load(a.inp, allow_pickle=False))
    ds = tiny_ds()
    if a.mode == "dp":
        out = mode_dp(inp, ds)
    else:
        out = mode_all(inp, ds, os.path.join(os.path.dirname(
            os.path.abspath(a.out)), "ckpt"))
    np.savez(a.out, **out)
    torch.distributed.destroy_process_group()
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
