"""The per-layer readers on synthetic traces: a kernel group's share of
its bytes-once bound, cuBLAS's time, the idle share and MFU, and nothing
read where the trace does not show the structure the bound assumes or
where no device ran."""

from __future__ import annotations

import types

import pytest

from benchmark import bounds, readings, spec
from benchmark.tests import tiny
from benchmark.trace import Event, TraceData

H100 = "NVIDIA H100 80GB HBM3"
WHOLE = None
V, E = 232_965, 11_880_013


@pytest.fixture(scope="module", autouse=True)
def _whole(tmp_path_factory):
    global WHOLE
    WHOLE = tiny.whole(tmp_path_factory.mktemp("whole"))


def _ctx(cell_name, events, epochs=2, window=(0, 10**9), steps=1,
         shapes=None):
    cell = spec.load_cell(cell_name, WHOLE)
    win = types.SimpleNamespace(
        seconds=(window[1] - window[0]) / 1e9,
        epochs=[types.SimpleNamespace(steps=steps, step_ms=[], edges=0,
                                      loss=1.0)] * epochs)
    return readings.Context(cell=cell, setup_s=1.0, window=win,
                            device_name=H100, num_vertices=V, num_edges=E,
                            trace=TraceData(events, [], window),
                            shapes=shapes)


def _spmm_bound_s():
    per_epoch = 3 * (bounds.bound_s(bounds.k2(4, V, E, 128), H100)
                     + bounds.bound_s(bounds.k2(4, V, E, 41), H100))
    return 2 * per_epoch


def test_spmm_share_is_its_bound_over_its_time():
    t = 0
    ev = []
    for _ in range(2 * 4):          # 2 epochs x (2 forwards x 2 layers)
        ev.append(Event("spmm_csr_kernel<float>", t, t + 100_000))
        t += 200_000
    for _ in range(2 * 2):          # the backward's walk, 2 a epoch
        ev.append(Event("csr_walk_kernel<SumPolicy<float>>", t, t + 300_000))
        t += 400_000
    ctx = _ctx("gcn_reddit.fullgraph", ev)
    got = readings.roofline_pct(ctx, "spmm", "fullgraph", "spmm_csr_kernel",
                                4)
    busy_s = (8 * 100_000 + 4 * 300_000) / 1e9
    assert got == pytest.approx(100 * _spmm_bound_s() / busy_s)


def test_a_kernel_at_its_bound_reads_100():
    bound_ns = int(round(_spmm_bound_s() * 1e9))
    ev = [Event("spmm_csr_kernel", i * 10, i * 10 + 1) for i in range(8)]
    ev.append(Event("csr_walk_kernel<SumPolicy>", 1000, 1000 + bound_ns - 8))
    ctx = _ctx("gcn_reddit.fullgraph", ev)
    assert readings.roofline_pct(ctx, "spmm", "fullgraph",
                                 "spmm_csr_kernel", 4) == pytest.approx(
        100.0, rel=1e-6)


def test_another_launch_count_reads_nothing():
    ev = [Event("spmm_csr_kernel", i * 10, i * 10 + 5) for i in range(7)]
    ctx = _ctx("gcn_reddit.fullgraph", ev)
    assert readings.roofline_pct(ctx, "spmm", "fullgraph",
                                 "spmm_csr_kernel", 4) is None


def test_products_idle_and_mfu():
    ev = [Event("cutlass_80_simt_sgemm_128x128", 0, 2_000_000),
          Event("sm80_xmma_gemm_f32f32", 1_000_000, 3_000_000),
          Event("spmm_csr_kernel", 5_000_000, 6_000_000)]
    ctx = _ctx("gcn_reddit.fullgraph", ev, epochs=2, window=(0, 10_000_000))
    assert readings.products_ms(ctx, "fullgraph") == pytest.approx(1.5)
    assert readings.idle_pct(ctx, "fullgraph") == pytest.approx(60.0)
    flops = 2 * ctx.cell.reference.epoch_flops(ctx.cell.config, V, E)
    assert readings.mfu_pct(ctx, "fullgraph") == pytest.approx(
        100 * flops / 0.01 / 67e12)
    assert readings.idle_pct(ctx, "sampled") is None


def test_no_device_event_reads_nothing():
    ctx = _ctx("gcn_reddit.fullgraph", [])
    for fn in (readings.idle_pct, readings.mfu_pct, readings.products_ms):
        assert fn(ctx, "fullgraph") is None


def test_sampled_bound_sums_each_steps_shapes():
    step = [(1_000_000, 110_000, 230_000, 233_088, 10, 233_088),
            (240_000, 10_000, 110_000, 10_112, 25, 233_088)]
    ev = [Event("gather_agg_fwd_kernel<float, 4>", i * 10, i * 10 + 5)
          for i in range(4)]
    ev.append(Event("block_transpose_count_kernel", 100, 1_000_100))
    ctx = _ctx("gcn_reddit.sampled", ev, epochs=1, steps=2,
               shapes=[step, step])
    want = 0.0
    for _ in range(2):
        for l, (nnz, _dv, _sv, D, K, S) in enumerate(step):
            F = (128, 41)[l]
            want += 2 * bounds.bound_s(bounds.k1_fwd(4, D, K, S, F, nnz),
                                       H100)
            want += bounds.bound_s(bounds.k1_transpose(D, K, S), H100)
    got = readings.roofline_pct(ctx, "gather_agg", "sampled",
                                "gather_agg_fwd", 2)
    assert got == pytest.approx(100 * want / ((4 * 5 + 1_000_000) / 1e9))


def test_sampled_readings_scale_the_counted_epoch_to_the_window():
    """The shapes come from the untraced warm-up epoch; the window's
    bound and FLOPs are its steps times the counted steps' mean."""
    small = [(1_000_000, 110_000, 230_000, 233_088, 10, 233_088),
             (240_000, 10_000, 110_000, 10_112, 25, 233_088)]
    partial = [(400_000, 60_000, 150_000, 233_088, 10, 233_088),
               (90_000, 3_756, 60_000, 10_112, 25, 233_088)]
    ev = [Event("gather_agg_fwd_kernel<float, 4>", i * 10, i * 10 + 5)
          for i in range(8)]
    ev.append(Event("block_transpose_count_kernel", 100, 1_000_100))
    counted = readings.roofline_pct(
        _ctx("gcn_reddit.sampled", ev, epochs=2, steps=2,
             shapes=[small, partial]), "gather_agg", "sampled",
        "gather_agg_fwd", 2)
    listed = readings.roofline_pct(
        _ctx("gcn_reddit.sampled", ev, epochs=2, steps=2,
             shapes=[small, partial, small, partial]), "gather_agg",
        "sampled", "gather_agg_fwd", 2)
    assert counted == pytest.approx(listed)
    f1 = readings.step_flops_total(_ctx("gcn_reddit.sampled", ev, epochs=2,
                                        steps=2, shapes=[small, partial]))
    cell = spec.load_cell("gcn_reddit.sampled", WHOLE)
    f2 = sum(cell.reference.step_flops(cell.config, [row[:3] for row in s])
             for s in (small, partial, small, partial))
    assert f1 == pytest.approx(f2)
    assert readings.step_flops_total(_ctx("gcn_reddit.sampled", ev)) is None
