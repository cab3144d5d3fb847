"""The device trainer's sampler as a CUDA graph (`train/device_trainer.py`
`SampleGraph`, `BatchPack`).

On the CPU: the trainer samples op by op and captures nothing; the choice
between replay and op-by-op sampling is made from what the call sees (the
device, the seed shape, the source bounds, the x0 route, the generator,
`omit_map`), checked with a stand-in graph; and `BatchPack` gives back
every tensor of a batch bit for bit, in buffers of its own.

On the card (marker `cuda`; the file imports nothing of JAX, so
`python -m pytest tests/test_torch_port_sample_graph.py --noconftest -m
cuda -q` runs these alone): replays against op-by-op calls from the same
generator state, bit for bit, at three rank hops, on the identity bottom
hop and with int8 features; an epoch's per-step outputs, kept by
reference, against the op-by-op epoch's; the counters; one graph launch
a call; a checkpoint resume.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sgnn_tpu_torch.config import RunConfig
from sgnn_tpu_torch.data.synthetic import random_graph_dataset
from sgnn_tpu_torch.train import build_trainer
from sgnn_tpu_torch.train import device_trainer as dt
from sgnn_tpu_torch.utils import timing

BLOCK_FIELDS = ("nbr", "weight", "srcs", "seeds", "dst_valid", "src_valid",
                "seed_in_src")
COUNTERS = ("sampler.graph_captures", "sampler.graph_replays",
            "sampler.rank_hops")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph runs only on the card")
    return torch.device("cuda")


def _counts():
    c = timing.RECORDER.counters
    return np.array([c.get(k) for k in COUNTERS])


def _host(batch, x0=True):
    """A batch's tensors on the host: every block field, labels, their
    flags, the overflow count and (with `x0`) x0."""
    out = {f"{h}.{f}": getattr(b, f).cpu().clone()
           for h, b in enumerate(batch.blocks) for f in BLOCK_FIELDS}
    out.update(labels=batch.labels.cpu().clone(),
               label_valid=batch.label_valid.cpu().clone(),
               overflow=batch.overflow.cpu().clone())
    if x0:
        out["x0"] = batch.x0.cpu().clone()
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)


# ------------------------------------------------------------------ CPU ----
SETUPS = {
    # three hops that each build a source set (fanout 10-10-10: 128 ->
    # 1,408 -> 15,488 -> 170,368 sources, under V)
    "rank3": (dict(algorithm="GATSAMPLEALLGPU", layer_sizes=[16, 8, 8, 5],
                   fanout=[10, 10, 10], batch_size=64, heads=2), 200_000),
    # the bottom hop's bound is the whole vertex set: the identity hop
    "identity": (dict(algorithm="GSSAMPLEALLGPU", layer_sizes=[16, 8, 5],
                      fanout=[5, 3], batch_size=128), 1500),
    # int8 features: rows gathered and dequantized, no identity hop
    "int8": (dict(algorithm="GSSAMPLEALLGPU", layer_sizes=[16, 8, 5],
                  fanout=[5, 3], batch_size=128, feature_dtype="int8"),
             1500),
    # two rank hops and 40 steps an epoch, for whole epochs
    "rank2": (dict(algorithm="GATSAMPLEALLGPU", layer_sizes=[16, 8, 5],
                   fanout=[4, 4], batch_size=64, heads=2), 4000),
}
CASES = ("identity", "int8", "rank3")
RANK_HOPS = {"rank3": 3, "identity": 1, "int8": 2}


def _trainer(case, device, **kw):
    cfg_kw, v = SETUPS[case]
    ds = random_graph_dataset(v, 8, 16, 5, seed=3)
    cfg = RunConfig(vertices=v, drop_rate=0.5, **{**cfg_kw, **kw})
    tr = build_trainer(cfg, ds, device=device)
    tr = getattr(tr, "base", tr)
    v_pad = tr.dev_indptr.shape[0] - 1
    identity = tr.src_pads[-1] == v_pad and tr._feat_scale is None
    assert identity == (case == "identity")
    assert (tr._feat_scale is not None) == (case == "int8")
    return tr


@pytest.mark.parametrize("case", CASES)
def test_batch_pack_round_trip(case):
    """`BatchPack` views every tensor of a batch but x0 in one buffer at
    16-byte offsets: a packed copy unpacks bit for bit with the dtypes,
    shapes and sharing of the batch (a block's seeds are the sources of
    the block above), and stays unchanged when the batch is overwritten;
    x0 is the batch's own."""
    tr = _trainer(case, "cpu")
    seeds, valid = next(tr._seed_batches(tr.train_nids, True))
    batch = tr.sample(seeds, valid)
    want = _host(batch)
    pack = dt.BatchPack(batch)
    assert all(o % 16 == 0 for o, *_ in pack.layout)
    got = pack.unpack(pack.pack(batch).clone(), batch)
    assert got.x0 is batch.x0
    for lo, hi in zip(got.blocks, got.blocks[1:]):
        assert lo.seeds is hi.srcs
    assert got.label_valid is got.blocks[-1].dst_valid
    for blk in batch.blocks:
        for f in BLOCK_FIELDS:
            getattr(blk, f).fill_(0)
    batch.overflow.fill_(7)
    _assert_same(_host(got), want)


def test_the_cpu_samples_op_by_op():
    """On the CPU the trainer samples op by op through an epoch and an
    evaluation: no graph, no capture, no replay, and `sampler.rank_hops`
    as before (two a step here: both hops build a source set)."""
    tr = _trainer("rank2", "cpu")
    before = _counts()
    tr.train_epoch()
    steps = len(tr.step_losses)
    tr.evaluate(tr.val_nids)
    evals = -(-tr.val_nids.size // tr.cfg.batch_size)
    assert not tr._sample_graphs
    assert (_counts() - before).tolist() == [0, 0, 2 * (steps + evals)]


class _StandIn:
    """A SampleGraph stand-in on the CPU: records its construction and
    calls, samples op by op."""

    made = []

    def __init__(self, sample, seeds, valid, generator):
        self.sample, self.generator, self.calls = sample, generator, 0
        _StandIn.made.append(self)

    def __call__(self, seeds, valid):
        self.calls += 1
        return self.sample(seeds, valid)


def test_replay_or_op_by_op_by_what_the_call_sees(monkeypatch):
    """On CUDA (a stand-in graph here) `sample` replays one graph a
    (seed shape, source bounds, x0 route, generator): calls with the same
    ones replay the same graph, each new one captures its own; a call
    with `omit_map` samples op by op; the row fetch runs after the
    replay."""
    _StandIn.made = []
    monkeypatch.setattr(dt, "SampleGraph", _StandIn)
    tr = _trainer("rank2", "cpu")
    batches = list(tr._seed_batches(tr.train_nids, False))
    monkeypatch.setattr(tr, "device", torch.device("cuda"))
    seeds, valid = batches[0]
    for s, v in batches[:3]:
        tr.sample(s, v)
    assert [g.calls for g in _StandIn.made] == [3]
    assert _StandIn.made[0].generator is tr.sample_generator
    omit = torch.full((tr.dev_indptr.shape[0] - 1,), -1, dtype=torch.int32)
    batch = tr.sample(seeds, valid, omit_map=omit)
    assert batch.cache_mask is not None and len(_StandIn.made) == 1
    tr.sample(torch.cat([seeds, seeds]),                # another shape
              torch.cat([valid, torch.zeros_like(valid)]))
    saved, tr.src_pads = tr.src_pads, tr.compute_src_pads(200)
    tr.sample(seeds, valid)                             # other bounds
    tr.src_pads = saved
    tr.sample_generator = torch.Generator().manual_seed(5)
    tr.sample(seeds, valid)                             # another generator
    fetched = []
    tr.fetch_x0 = lambda b: fetched.append(b.x0.shape) or b
    tr.sample(seeds, valid)                             # x0 fetched after
    assert fetched == [(1, 1)]
    tr.fetch_x0 = None
    tr.sample(seeds, valid)
    assert [g.calls for g in _StandIn.made] == [3, 1, 1, 2, 1]


# ----------------------------------------------------------------- card ----
@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_replays_match_op_by_op_calls(cuda_device, case):
    """Five replays against five op-by-op calls from the same generator
    state: every block field, x0, the labels and the overflow bit for bit,
    and the generator left in the same state.  The blocks a replay
    returned stay as they were through the later replays.  The counters:
    one capture, one replay a call, `sampler.rank_hops` as op by op.  A
    profiled replay makes one graph launch."""
    from torch.profiler import ProfilerActivity, profile

    tr = _trainer(case, cuda_device)
    pairs = list(tr._seed_batches(tr.train_nids, True))[:5]
    assert len(pairs) == 5
    gen = tr.sample_generator
    state = gen.get_state()
    before = _counts()
    kept, replayed = [], []
    for s, v in pairs:
        batch = tr.sample(s, v)
        kept.append(batch)
        replayed.append(_host(batch))
    graph_counts = _counts() - before
    after = gen.get_state()
    gen.set_state(state)
    before = _counts()
    eager = [_host(tr._sample_batch(s, v)) for s, v in pairs]
    eager_counts = _counts() - before
    assert torch.equal(gen.get_state(), after)
    for r, e, k in zip(replayed, eager, kept):
        _assert_same(r, e)
        e.pop("x0")
        _assert_same(_host(k, x0=False), e)
    assert graph_counts.tolist() == [1, 5, eager_counts[2]]
    assert eager_counts[:2].tolist() == [0, 0]
    assert eager_counts[2] == 5 * RANK_HOPS[case]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.sample(*pairs[0])
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert sum("GraphLaunch" in n for n in names) == 1
    assert sum("LaunchKernel" in n for n in names) <= 2


def _op_by_op(tr):
    """`tr` sampling op by op on the card too."""
    tr.sample = lambda s, v, omit_map=None: tr._sample_batch(s, v, omit_map)
    return tr


def _keeping(tr, kept):
    """`tr.sample` appending each batch's overflow and blocks, by
    reference, to `kept`."""
    orig = tr.sample

    def sample(s, v, omit_map=None):
        batch = orig(s, v, omit_map)
        kept.append(batch)
        return batch

    tr.sample = sample
    return tr


@pytest.mark.cuda
def test_an_epochs_kept_outputs_match_op_by_op(cuda_device):
    """An epoch with replays against one op by op from the same build,
    under source bounds tight enough to overflow: each step's overflow
    count and blocks, held by reference to the epoch's end, the epoch's
    loss, accuracy, edge count and overflow total, and every step's loss,
    bit for bit; one capture, one replay a step."""
    runs = []
    for mode in ("graph", "op_by_op"):
        tr = _trainer("rank2", cuda_device, src_pad_factor=0.3)
        if mode == "op_by_op":
            _op_by_op(tr)
        kept = []
        _keeping(tr, kept)
        before = _counts()
        out = tr.train_epoch()
        runs.append((out, tr.last_overflow, tr.step_losses,
                     [_host(b, x0=False) for b in kept], _counts() - before))
    (out_g, over_g, loss_g, kept_g, n_g), (out_e, over_e, loss_e, kept_e,
                                            n_e) = runs
    steps = len(kept_g)
    assert steps > 2 and over_g > 0
    assert len({int(k["overflow"]) for k in kept_g}) > 1
    for a, b in zip(kept_g, kept_e):
        _assert_same(a, b)
    assert (out_g, over_g, loss_g) == (out_e, over_e, loss_e)
    assert n_g.tolist() == [1, steps, n_e[2]] and n_e[:2].tolist() == [0, 0]


@pytest.mark.cuda
def test_resume_replays_the_straight_runs_draws(cuda_device, tmp_path):
    """Two epochs straight against one, a checkpoint, and one more in a new
    trainer that captures its own graph after the restore: the second
    epoch's blocks, losses and parameters bit for bit."""
    from sgnn_tpu_torch.train.checkpoint import CheckpointManager

    straight, resumed = [], []
    a = _trainer("rank2", cuda_device)
    a.train_epoch()
    _keeping(a, straight)
    a.train_epoch()
    b = _trainer("rank2", cuda_device)
    b.train_epoch()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, b)
    c = _trainer("rank2", cuda_device)
    assert mgr.restore(c) == 0
    _keeping(c, resumed)
    before = _counts()
    c.train_epoch()
    assert (_counts() - before)[:2].tolist() == [1, len(resumed)]
    assert len(straight) == len(resumed)
    for x, y in zip(straight, resumed):
        _assert_same(_host(x, x0=False), _host(y, x0=False))
    assert a.step_losses == c.step_losses
    for x, y in zip(a.params.leaves(), c.params.leaves()):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_sharded_rows_are_fetched_after_the_replay(cuda_device):
    """GATSAMPLEALLMULTI with row-sharded features on a one-rank NCCL
    group: its graph gathers no rows (x0 comes from the fetch after the
    replay), and two epochs equal the single-device engine's bit for
    bit."""
    import torch.distributed as dist

    from sgnn_tpu_torch.parallel.mesh import make_group

    single = _trainer("rank2", cuda_device)
    make_group(cuda_device)
    try:
        dp = build_trainer(dataclasses.replace(
            single.cfg, algorithm="GATSAMPLEALLMULTI", shard_features=True),
            random_graph_dataset(SETUPS["rank2"][1], 8, 16, 5, seed=3),
            device=cuda_device)
        assert dp.base.dev_features is None
        for _ in range(2):
            assert dp.train_epoch() == single.train_epoch()
            assert dp.base.step_losses == single.step_losses
        (key,) = dp.base._sample_graphs
        assert key[2] is False          # the graph leaves x0 to the fetch
    finally:
        dist.destroy_process_group()
