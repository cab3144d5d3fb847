"""The gatv2_products configuration's reference module (`reference/
gatv2_pyg.py`, PyG's ogbn-products GAT with GATv2Conv layers) passes what
the harness asks of an architecture from its own files: its leaves are
the program's, at the published widths 24 of them with 1,162,386
parameters, its FLOPs the counts its docstring writes, its kernel shapes
the layers' (F, H); at uniform attention its attention is the sampled
mean; a tiny copy of the cell (three layers, fan-out 3-3-3) is `correct`
on the CPU and the planted faults and the control are not; the kernel
pair's roofline reader and the attention reader read a trace's kernels
and the program's spans."""

from __future__ import annotations

import io
import json
import math
import types

import pytest
import torch

from benchmark import bounds, correctness, graph, program, readings, run
from benchmark import spans, spec
from benchmark.tests import tiny
from benchmark.tests.test_bench_gat_pyg import _Frozen, _first_half, _span
from benchmark.trace import Event, TraceData

CELL = "gatv2_products.sampled"
TINY_WIDTHS = [24, 16, 16, 5]
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tiny copy of every cell, with this cell three layers deep."""
    bench_file, bench_dir = tiny.make(tmp_path_factory.mktemp("tiny"))
    cfg_path = bench_dir / "configs" / "gatv2_products.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["layer_sizes"] = TINY_WIDTHS
    cfg_path.write_text(json.dumps(cfg))
    traffic_path = bench_dir / "traffic" / "sampled_10x3_b512.json"
    traffic = json.loads(traffic_path.read_text())
    traffic.update(fanout=[3, 3, 3], batch_size=32)
    traffic_path.write_text(json.dumps(traffic))
    return bench_file, bench_dir


def _published():
    return spec.load_cell(CELL)


def test_the_published_widths():
    cell = _published()
    ref, cfg = cell.reference, cell.config
    decl = ref.leaves(cfg)
    assert len(decl) == 24
    assert sum(math.prod(shape) for _, shape, _ in decl) == 1_162_386
    assert ref.kernel_layers(cfg) == [(512, 4), (512, 4), (188, 4)]
    assert ref.reads_own_rows(cfg)
    assert cfg["published"]["parameters"] == 1_162_386
    assert cfg["program"] == {"gat_variant": "pyg_v2", "adam_epsilon": 1e-08}
    same = spec.load_cell("gat_products.sampled").config
    assert cfg["graph"] == same["graph"]
    assert cell.traffic == spec.load_cell("gat_products.sampled").traffic


def test_the_flops_are_the_docstrings_counts():
    cell = _published()
    steps = [(40_000, 5_000, 50_000), (5_000, 512, 5_000), (4_000, 512, 900)]
    fin, cols, out = [100, 512, 512], [512, 512, 188], [512, 512, 47]
    want = sum((3 if l else 2) * 2 * ((sv + dv) * fin[l] * cols[l]
                                      + dv * fin[l] * out[l])
               + 16 * nnz * cols[l]
               for l, (nnz, dv, sv) in enumerate(steps))
    assert cell.reference.step_flops(cell.config, steps) == want
    assert cell.reference.epoch_flops(cell.config, 10, 50) == (
        cell.reference.step_flops(cell.config, [(50, 10, 10)] * 3))


def test_the_pair_work_hand_count():
    ref = _published().reference
    D, K, S, F, H, nnz, dv, sv = 100, 10, 900, 512, 4, 800, 90, 700
    fwd = ref.pair_work(D, K, S, F, H, nnz, dv, sv, False)
    bwd = ref.pair_work(D, K, S, F, H, nnz, dv, sv, True)
    slots = D * (K + 1)
    assert fwd == (slots * 8 + 4 * F * (sv + dv + 1) + 4 * D * F
                   + 4 * slots * H, 6 * nnz * F)
    assert bwd == (slots * 8 + 4 * slots * H + 4 * F * (sv + 2 * dv + 1)
                   + 4 * (S + D + 1) * F, 10 * nnz * F)


def test_uniform_attention_is_the_sampled_mean():
    """att = 0: the reference's layer averages xl over each destination's
    kept sources and its own row, whatever xr holds."""
    ref = _published().reference
    gen = torch.Generator().manual_seed(3)
    layers = [{"dst": torch.tensor([4, 7, 9]),
               "nbr": torch.tensor([[1, 2, -1], [4, 5, 7], [-1, -1, -1]])}]
    edges = ref.layer_edges(layers)
    fin, heads, c = 6, 2, 3
    w = torch.randn(fin, heads * c, generator=gen, dtype=torch.float64)
    bl = torch.randn(heads * c, generator=gen, dtype=torch.float64)
    wr = torch.randn(fin, heads * c, generator=gen, dtype=torch.float64)
    x = torch.randn(10, fin, generator=gen, dtype=torch.float64)
    h = x[edges[0].x_rows]
    xl = (h @ w + bl).view(-1, heads, c)
    xr = (h[edges[0].own] @ wr).view(-1, heads, c)
    e = edges[0]
    score = ref.scores(xl, xr, torch.zeros(heads, c, dtype=torch.float64),
                       e.src, e.dst)
    assert torch.count_nonzero(score) == 0
    alpha = ref._gat.edge_softmax(score, e.dst, e.num_dst)
    agg = ref._gat.weighted_sum(xl, alpha, e.src, e.dst, e.num_dst)
    rows = {4: [1, 2, 4], 7: [4, 5, 7], 9: [9]}   # kept sources, self once
    pos = {int(v): i for i, v in enumerate(edges[0].x_rows)}
    for d, (dst, srcs) in enumerate(rows.items()):
        want = torch.stack([xl[pos[s]] for s in srcs]).mean(0)
        assert torch.allclose(agg[d], want)


def test_the_module_declares_the_programs_leaves(files):
    bench_file, bench_dir = files
    cell = spec.load_cell(CELL, bench_file, bench_dir)
    arrays = graph.load_graph(cell.config["graph"],
                              bench_dir.parent / "graphs")
    trainer = program.build(cell, 5, program.make_dataset(arrays, "t"),
                            "cpu")
    p0 = program.make_weights(cell, 2_147_483_659, "cpu")
    assert len(p0) == 24
    assert [tuple(t.shape) for t in p0] == [
        tuple(t.shape) for t in trainer.params.leaves()]
    assert all(t.abs().max() > 0 for t in p0)
    program.set_weights(trainer, p0)
    assert all(torch.equal(a, b) for a, b in zip(trainer.params.leaves(),
                                                 p0))


@pytest.mark.parametrize("fault", ["none", "state_unchanged", "half_batch"])
def test_the_tiny_cell_is_correct_and_a_planted_fault_is_not(
        files, fault, monkeypatch):
    bench_file, bench_dir = files
    after = None
    if fault == "state_unchanged":
        def after(trainer):
            trainer.optimizer = _Frozen(trainer.optimizer)
    elif fault == "half_batch":
        import sgnn_tpu_torch.train.trainer as trainer_mod

        orig = trainer_mod.nll_loss_masked
        monkeypatch.setattr(
            trainer_mod, "nll_loss_masked",
            lambda logp, labels, valid: orig(logp, labels,
                                             _first_half(valid)))
    out, err = io.StringIO(), io.StringIO()
    rc = run.run(run.parse_args(["--workload", CELL, "--seed", "2147483659",
                                 "--seconds", "0.3", "--trace", "0"]),
                 run.Options(bench_file=bench_file, bench_dir=bench_dir,
                             graph_cache=bench_dir.parent / "graphs",
                             device="cpu", require_chip=False,
                             after_build=after), out, err)
    assert rc == 0, err.getvalue()[-2000:]
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert last["correct"] == (fault == "none"), last["checks"]
    assert set(last["checks"]) == set(correctness.NUMBERS)


def test_the_control_in_the_programs_place_is_not_correct(files):
    bench_file, bench_dir = files
    c = spec.load_cell(CELL, bench_file, bench_dir)
    arrays = graph.load_graph(c.config["graph"], bench_dir.parent / "graphs")
    trainer = program.build(c, 77, program.make_dataset(arrays, "t"), "cpu")
    program.set_weights(trainer, program.make_weights(c, 77, "cpu"))
    cap = program.CAPTURES[c.mode](c, trainer)
    inp = correctness.Inputs(arrays, "cpu", c.reference)
    sound = correctness.checks(correctness.judge(c, inp, cap), c.limits)
    control = correctness.checks(
        correctness.judge(c, inp, cap, as_program="control"), c.limits)
    assert correctness.passed(sound), sound
    assert not correctness.passed(control), control


def _ctx(events, steps, shapes, window=(0, 10**9)):
    win = types.SimpleNamespace(seconds=(window[1] - window[0]) / 1e9,
                                span_ns=window, epochs=[
        types.SimpleNamespace(steps=steps, step_ms=[], edges=0, loss=1.0)])
    return readings.Context(cell=_published(), setup_s=1.0, window=win,
                            device_name=H100, num_vertices=2_449_029,
                            num_edges=124_898_984,
                            trace=TraceData(events, [], window),
                            shapes=shapes)


def test_the_pair_roofline_is_its_bound_over_its_time():
    reader = spec.metric_reader("ops.gatv2_sampled.roofline_pct")
    step = [(600_000, 61_000, 650_000, 61_952, 10, 681_472),
            (55_000, 5_600, 60_000, 5_632, 10, 61_952),
            (5_000, 512, 5_500, 512, 10, 5_632)]
    names = ["void gatv2_sampled_fwd_kernel<4, 1>(...)",
             "void gatv2_sampled_dst_kernel<4, 1>(...)",
             "void sgnn::csr_walk_kernel<Gatv2SrcPolicy<1, 4> >(...)",
             "void block_transpose_count(...)",
             "void cutlass_80_simt_sgemm_128x128(...)"]
    # two steps: each of its kernels 1 ms, three forwards a step
    events = [Event(names[j], t, t + 10**6) for i in range(2)
              for l in range(3) for j in range(5)
              for t in (10**7 * (15 * i + 5 * l + j),)]
    ref = _published().reference
    layers = ref.kernel_layers(_published().config)
    bound = sum(bounds.bound_s(ref.pair_work(D, K, S, F, H, nnz, dv, sv, b),
                               H100)
                for (nnz, dv, sv, D, K, S), (F, H) in zip(step, layers)
                for b in (False, True))
    ctx = _ctx(events, 2, [step])
    # 4 of the 5 names are the pair's: 2 steps x 3 layers x 4 ms
    assert reader.read(ctx) == pytest.approx(100 * 2 * bound / 0.024)
    assert 0 < reader.read(ctx) <= 100
    # another count of forwards than a layer a step: nothing read
    assert reader.read(_ctx(events[5:], 2, [step])) is None
    assert reader.read(_ctx(events, 2, None)) is None


def test_the_attention_reader_sums_a_steps_spans(monkeypatch):
    reader = spec.metric_reader("model.attention_ms_per_step.sampled")
    ctx = _ctx([Event("k", 0, 900)], 2, None, window=(0, 1000))
    monkeypatch.setattr(spans, "recorded", lambda: [
        _span(1, "forward", 0, 400, step=0, ms=9.0),
        *(_span(2 + l, "attention", 100 * l, 100 * l + 50, 1, 0, 0.5 + l)
          for l in range(3)),
        _span(5, "forward", 500, 900, step=1, ms=9.0),
        *(_span(6 + l, "attention", 500 + 100 * l, 550 + 100 * l, 5, 1,
                1.0) for l in range(3))])
    assert reader.read(ctx) == pytest.approx((0.5 + 1.5 + 2.5 + 3.0) / 2)
    monkeypatch.setattr(spans, "recorded", lambda: [
        _span(1, "forward", 0, 400, step=0, ms=9.0)])
    assert reader.read(ctx) is None
