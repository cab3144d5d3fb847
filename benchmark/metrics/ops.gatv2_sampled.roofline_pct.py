"""The sampled GATv2 kernel pair (`ops/cuda/gatv2_sampled`: the forward,
the backward's destination pass and att's partial-row sum, its slot
transpose, and the source walk with its fix-up): the bytes-once bound of
each step's launches, from the cell's reference module (`pair_work`, at
each counted step's padded (D, K, S) and valid (nnz, dv, sv) and the
module's (F, H)), over the device time of those kernels.  One forward
launch a layer a step is what the bound assumes; where the trace shows
another count, nothing is read."""

from benchmark import bounds, readings, trace

# the pair's kernels by substrings of their names; `block_transpose` and
# `csr_carry_group` are shared with K1 dx and GS, neither of which runs in
# a cell of this pair
PATTERNS = ("gatv2_sampled_", "Gatv2Src", "block_transpose",
            "csr_carry_group")
ANCHOR = "gatv2_sampled_fwd_kernel"


def read(ctx):
    if not ctx.traced_device or ctx.mode != "sampled":
        return None
    ref, layers = ctx.cell.reference, ctx.kernel_layers
    ev, win = ctx.trace.device, readings.WHOLE_TRACE
    n = trace.count(ev, win, lambda name: ANCHOR in name)
    if n == 0 or n != len(layers) * ctx.steps:
        return None
    ns = trace.time_in(ev, win, lambda name: any(p in name
                                                 for p in PATTERNS))
    if ns == 0:
        return None

    def step_bound(step):
        return sum(bounds.bound_s(ref.pair_work(D, K, S, F, H, nnz, dv, sv,
                                                backward), ctx.device_name)
                   for (nnz, dv, sv, D, K, S), (F, H) in zip(step, layers)
                   for backward in (False, True))

    mean = readings.per_step_mean(ctx, step_bound)
    if mean is None:
        return None
    return 100.0 * ctx.steps * mean / (ns / 1e9)
