"""GNN parameters: the container, its initialisation, and the carry-across.

Model structure (reference toolkits/ engines), the same in both packages:
  GCN/SAGE layer l:  X' = relu(aggregate(X_l) · W_l), log_softmax at the last
  (GCN uses symmetric-norm weights, SAGE mean weights — the only difference
  between the GCN* and GS* engines, GS_SAMPLE_ALLGPU.hpp:296).
  GAT layer l: W_l [in, out] plus an attention vector a_l [2·out, 1].
  GAT variant "pyg" (PyG's GATConv stack of examples/ogbn_products_gat.py):
  every layer has `heads` heads, concatenated on hidden layers and averaged
  on the last, one self edge a destination, a bias b_l and a linear skip
  x_dst·S_l + c_l; hidden layers end in ELU and dropout.
  GAT variant "pyg_v2" (the same stack with PyG's GATv2Conv layers): the
  sources' transform gets a bias (xl = x·W_l + bL_l), the destinations'
  own rows a transform of their own (xr = x_dst·WR_l + bR_l), and the
  score is att_l · leaky_relu(xl[s] + xr[d]) (a_l [H·C, 1]).
  The PyG stacks' parameters are the only ones with biases and skips, and
  GATv2's the only ones with a destination transform, which is how every
  forward tells the three stacks apart (`GNNParams.gatconv`,
  `GNNParams.gatv2`).

The parameters are a plain NamedTuple of tensors, as the JAX package's are a
pytree of arrays, so one layout crosses between them by `params_from_numpy`.
`model_forward` runs the sampled model over a `SampledBatch` (training);
serving runs the whole-graph forward of train/fullbatch.py.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..nn.functional import BN_EPS, dropout, log_softmax
from ..nn.layers import xavier_uniform_init
from ..ops.aggregate import gather_aggregate
from ..ops.gat import pack_score_tables
from ..ops.gat_sampled import gat_sampled_aggregate, own_row_slots
from ..ops.gatv2_sampled import gatv2_sampled_aggregate
from ..sampler.blocks import SampledBatch
from ..utils import timing

MODEL_FAMILIES = ("gcn", "sage", "gat")
# init_model's GAT stacks: "" is the reference system's GAT, "pyg" PyG's
# GATConv stack, "pyg_v2" the same stack with GATv2Conv layers
GAT_VARIANTS = ("", "pyg", "pyg_v2")


class GNNParams(NamedTuple):
    """Per-layer weights; attn is empty for GCN/SAGE, [2F',1]-style for GAT
    ([F', 1] for GATv2); bias, skip_w and skip_b are the PyG GAT stacks'
    ("pyg" and "pyg_v2", else empty), bias_l, weights_r and bias_r the
    "pyg_v2" stack's alone: the parameters name their layer stack,
    `gatconv` and `gatv2`.  The groups appended for GATv2 come last, so
    the other stacks' flat order and checkpoints are as they were."""

    weights: Tuple[torch.Tensor, ...]     # W_l: [in_l, out_l]
    attn: Tuple[torch.Tensor, ...]        # GAT a_l: [2*out_l, 1] (else empty)
    bias: Tuple[torch.Tensor, ...] = ()   # b_l: [width_l]
    skip_w: Tuple[torch.Tensor, ...] = ()  # S_l: [in_l, width_l]
    skip_b: Tuple[torch.Tensor, ...] = ()  # c_l: [width_l]
    bias_l: Tuple[torch.Tensor, ...] = ()     # GATv2 bL_l: [out_l]
    weights_r: Tuple[torch.Tensor, ...] = ()  # GATv2 WR_l: [in_l, out_l]
    bias_r: Tuple[torch.Tensor, ...] = ()     # GATv2 bR_l: [out_l]

    @property
    def gatconv(self) -> bool:
        """A PyG GAT stack (`init_model`'s "pyg" or "pyg_v2" variant), the
        only parameters with biases and skips; else the reference stack."""
        return any(self[2:])

    @property
    def gatv2(self) -> bool:
        """PyG's GATv2Conv stack ("pyg_v2"): the destinations' own
        transform, `weights_r`."""
        return bool(self.weights_r)

    def to(self, device=None, dtype=None) -> "GNNParams":
        return GNNParams(*(tuple(t.to(device=device, dtype=dtype)
                                 for t in group) for group in self))

    def leaves(self) -> List[torch.Tensor]:
        """Weights, attention vectors, biases, skip weights, skip biases:
        the optimizers' flat order."""
        return [t for group in self for t in group]

    def replace_leaves(self, leaves: Sequence[torch.Tensor]) -> "GNNParams":
        groups, i = [], 0
        for group in self:
            groups.append(tuple(leaves[i:i + len(group)]))
            i += len(group)
        return GNNParams(*groups)


def init_model(
    seed: int,
    family: str,
    layer_sizes: Sequence[int],
    dtype: torch.dtype = torch.float32,
    device=None,
    heads: int = 1,
    gat_variant: str = "",
) -> GNNParams:
    """W: xavier-uniform (torch parity), drawn from a CPU `torch.Generator`
    seeded with `seed`, then moved to `device`.  GAT attention vectors
    `a`: zeros, as in the JAX package (gnn.py:79-80) — every layer starts
    at uniform attention.  The PyG GAT variants' last W has `heads`
    blocks of the last width (its heads are averaged), their skip weights
    are xavier-uniform after the W, their biases zeros; "pyg_v2"'s
    attention vectors are [out, 1] and its destination transforms WR_l
    (W_l's shapes) xavier-uniform after the skips.

    Torch's generator draws other numbers than `jax.random` from the same
    seed; to hold the two packages to each other, make the weights once
    (numpy, or the JAX package's `init_model`) and carry them across with
    `params_from_numpy`."""
    if family not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family {family!r}")
    if gat_variant not in GAT_VARIANTS or (gat_variant and family != "gat"):
        raise ValueError(f"gat_variant={gat_variant!r}: the GAT family takes "
                         f"one of {GAT_VARIANTS}, the others only ''; got "
                         f"family {family!r}")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    n = len(layer_sizes) - 1
    pyg, v2 = gat_variant != "", gat_variant == "pyg_v2"
    outs = [layer_sizes[i + 1] * (heads if pyg and i == n - 1 else 1)
            for i in range(n)]
    ws = [xavier_uniform_init(gen, layer_sizes[i], outs[i],
                              dtype=dtype).to(dev) for i in range(n)]
    atts = ([torch.zeros(((1 if v2 else 2) * o, 1), dtype=dtype, device=dev)
             for o in outs] if family == "gat" else [])
    if not pyg:
        return GNNParams(weights=tuple(ws), attn=tuple(atts))
    skips = [xavier_uniform_init(gen, layer_sizes[i], layer_sizes[i + 1],
                                 dtype=dtype).to(dev) for i in range(n)]
    zeros = tuple(torch.zeros(layer_sizes[i + 1], dtype=dtype, device=dev)
                  for i in range(n))
    params = GNNParams(weights=tuple(ws), attn=tuple(atts), bias=zeros,
                       skip_w=tuple(skips),
                       skip_b=tuple(torch.zeros_like(z) for z in zeros))
    if not v2:
        return params
    ws_r = [xavier_uniform_init(gen, layer_sizes[i], outs[i],
                                dtype=dtype).to(dev) for i in range(n)]
    return params._replace(
        bias_l=tuple(torch.zeros(o, dtype=dtype, device=dev) for o in outs),
        weights_r=tuple(ws_r),
        bias_r=tuple(torch.zeros(o, dtype=dtype, device=dev) for o in outs))


def params_from_numpy(weights, attn=(), device=None) -> GNNParams:
    """The JAX package's parameters, given as numpy arrays (or anything
    `np.asarray` takes), as the port's: same layout, same dtype, on
    `device`.  This is the carry-across every parity test uses."""
    dev = resolve_device(device)

    def conv(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return GNNParams(weights=tuple(conv(w) for w in weights),
                     attn=tuple(conv(a) for a in attn))


def _batch_norm(t: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Standardise each column over the VALID rows only (statistics in f32
    even for bf16 compute), batch-stats mode at train and eval alike."""
    t32 = t.float()
    m = valid.float()[:, None]
    cnt = m.sum().clamp_min(1.0)
    mu = (t32 * m).sum(dim=0, keepdim=True) / cnt
    var = ((t32 - mu).square() * m).sum(dim=0, keepdim=True) / cnt
    return ((t32 - mu) * torch.rsqrt(var + BN_EPS)).to(t.dtype)


def check_heads(params: GNNParams, family: str, heads: int) -> None:
    """GAT: raise ValueError unless every layer has its attention vector
    [2·out, 1] ([out, 1] for GATv2) and `heads` >= 1 divides every hidden
    width (the reference stack's last layer is single-head; the PyG
    stacks, `gatconv`, have `heads` on every layer, and their biases,
    skips and GATv2's destination transforms match the widths).  GCN/SAGE
    ignore `heads`, as in the JAX package, and take no biases or skips."""
    pyg, v2 = params.gatconv, params.gatv2
    if family != "gat":
        if pyg:
            raise ValueError("biases and skips are the PyG GAT stacks' "
                             f"parameters, not {family!r}'s")
        return
    n_layers = len(params.weights)
    n_att = 1 if v2 else 2
    if len(params.attn) != n_layers or any(
            tuple(a.shape) != (n_att * w.shape[1], 1)
            for w, a in zip(params.weights, params.attn)):
        raise ValueError(f"GAT needs one attention vector [{n_att}*out, 1] "
                         f"per layer, got "
                         f"{[tuple(a.shape) for a in params.attn]}")
    widths = [int(w.shape[1]) for w in params.weights[:None if pyg else -1]]
    if heads < 1 or any(f % heads for f in widths):
        raise ValueError(f"heads={heads} must divide every "
                         f"{'' if pyg else 'hidden '}width {widths}")
    if not pyg:
        return
    want = [(int(w.shape[0]), int(w.shape[1]) // (heads if l == n_layers - 1
                                                  else 1))
            for l, w in enumerate(params.weights)]
    got = [(tuple(b.shape), tuple(s.shape), tuple(c.shape)) for b, s, c in
           zip(params.bias, params.skip_w, params.skip_b)]
    if got != [((o,), (i, o), (o,)) for i, o in want]:
        raise ValueError(f"the pyg GAT needs a bias [out], a skip weight "
                         f"[in, out] and a skip bias [out] a layer for "
                         f"(in, out) {want}, got {got}")
    cols = [tuple(w.shape) for w in params.weights]
    got = [(tuple(b.shape), tuple(w.shape), tuple(c.shape)) for b, w, c in
           zip(params.bias_l, params.weights_r, params.bias_r)]
    if got != ([((o,), (i, o), (o,)) for i, o in cols] if v2 else []):
        raise ValueError(f"the pyg_v2 GAT needs a source bias [cols], a "
                         f"destination weight [in, cols] and its bias "
                         f"[cols] a layer for W's (in, cols) {cols}, got "
                         f"{got}")


def refuse_gatconv(params: GNNParams, where: str) -> None:
    """Raise ValueError for the PyG GAT stacks (GATConv and GATv2Conv) at
    `where`, a forward that runs the reference stack alone (the
    whole-graph forward and serving)."""
    if params.gatconv:
        raise ValueError(f"{where} runs the reference layer stack alone; "
                         "biases and skips are PyG's GATConv and GATv2Conv "
                         "stacks (the 'pyg' and 'pyg_v2' variants), which "
                         "the sampled trainer runs")


def _agg_linear(w: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
                wgt: torch.Tensor) -> torch.Tensor:
    """agg(X)·W == agg(X·W): when the layer SHRINKS the width (in > out),
    transform first, so the gather moves out-wide rows."""
    if w.shape[0] > w.shape[1]:
        return gather_aggregate(x @ w.to(x.dtype), nbr, wgt)
    return gather_aggregate(x, nbr, wgt) @ w.to(x.dtype)


def _gat_attention(h: torch.Tensor, a: torch.Tensor, nbr: torch.Tensor,
                   wgt: torch.Tensor, seed_in_src: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """GAT's attention aggregation of the transformed rows h [S, F']:
    `heads` > 1 splits the columns into blocks, each with its own
    attention (concat-of-heads; parameter shapes as single-head).  The
    score tables, then one op (ops/gat_sampled.py: no [D, K, F] edge
    tensors), which runs its plain version on the CPU and the
    hand-written kernels on the card."""
    fprime = h.shape[-1]
    ts, td = pack_score_tables(h, a[:fprime, 0].to(h.dtype),
                               a[fprime:, 0].to(h.dtype), heads)
    return gat_sampled_aggregate(h, ts, td, nbr, wgt, seed_in_src, heads)


def _gat_layer(w: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
               nbr: torch.Tensor, wgt: torch.Tensor, seed_in_src: torch.Tensor,
               heads: int = 1) -> torch.Tensor:
    """One sampled GAT layer of the reference stack, pre-activation
    (sgnn_tpu/models/gnn.py:84-125): x·W, then `_gat_attention`."""
    return _gat_attention(x @ w.to(x.dtype), a, nbr, wgt, seed_in_src, heads)


def _pyg_attention(params: GNNParams, l: int, x: torch.Tensor,
                   block, heads: int) -> torch.Tensor:
    """Layer l's attention aggregation [D, heads·C] in a PyG stack, each
    valid destination attending to its own row once and never through a
    sampled slot (the self-loop rule, `own_row_slots`).  GATConv: x·W_l,
    then `_gat_attention`; GATv2Conv (`params.gatv2`): xl = x·W_l + bL_l
    over the sources, xr = x_dst·WR_l + bR_l over the destinations' own
    rows, then `ops/gatv2_sampled.py`'s op.  The attention after the
    transforms is the `attention` span."""
    nbr, wgt = own_row_slots(block.nbr, block.weight, block.seed_in_src,
                             block.dst_valid)
    dt = x.dtype
    if not params.gatv2:
        h = x @ params.weights[l].to(dt)
        with timing.span("attention", h):
            return _gat_attention(h, params.attn[l], nbr, wgt,
                                  block.seed_in_src, heads)
    xl = torch.addmm(params.bias_l[l].to(dt), x, params.weights[l].to(dt))
    xr = torch.addmm(params.bias_r[l].to(dt),
                     x.index_select(0, block.seed_in_src.long()),
                     params.weights_r[l].to(dt))
    with timing.span("attention", xl):
        return gatv2_sampled_aggregate(xl, xr, params.attn[l].view(-1).to(dt),
                                       nbr, wgt, heads)


def model_forward(
    params: GNNParams,
    family: str,
    batch: SampledBatch,
    *,
    drop_rate: float = 0.0,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    cache_emb: Optional[torch.Tensor] = None,
    remat: bool = False,
    heads: int = 1,
    batch_norm: bool = False,
) -> torch.Tensor:
    """Run the L-layer model; returns log-probs [num_seed_pad, C].

    The port of sgnn_tpu/models/gnn.py:128-238: blocks are consumed
    input→output (layer l aggregates over batch.blocks[l]).  GCN/SAGE:
    hidden layers are relu(bn(agg(X)·W)) then dropout (drawn from
    `generator`, on the batch's device); the last layer is log_softmax in
    f32.  GAT: `heads` attention heads on hidden layers, one on the last;
    relu(bn(.)) on hidden layers and relu then log_softmax in f32 on the
    last (the reference's relu at every layer); no dropout, so nothing is
    drawn from `generator`, as the JAX GAT branch draws none.  `batch_norm`
    standardises hidden pre-activations over the hop's valid destination
    rows.  `remat` recomputes a layer in the backward pass
    (torch.utils.checkpoint) instead of storing it: GCN/SAGE's hidden
    aggregations, every GAT layer (as the JAX package's checkpoints).

    Parameters with skips (`GNNParams.gatconv`) are a PyG stack, GATConv
    or, with destination transforms (`GNNParams.gatv2`), GATv2Conv
    (`_pyg_gat_layer`): `heads` on every layer, the self-loop rule,
    biases, linear skips, ELU and dropout on hidden layers, the heads' mean
    then log_softmax in f32 on the last; no batch norm and no cache.

    `cache_emb` ([C, H] hot-vertex rows, cache/embedding_cache.py), with a
    batch carrying `cache_mask`/`cache_slot`, replaces the cached
    destinations' layer-0 pre-activations (GCN/SAGE: agg·W before batch
    norm and relu; GAT: the attention output before batch norm), only when
    the model has more than one layer; the cached rows carry no
    gradient."""
    if family not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family {family!r}")
    n_layers = len(params.weights)
    if batch.num_layers != n_layers:
        raise ValueError(f"{batch.num_layers} blocks for {n_layers} layers")
    check_heads(params, family, heads)
    if params.gatconv:
        if batch_norm or cache_emb is not None:
            raise ValueError("the pyg GAT takes no batch_norm and no "
                             "hot-vertex cache")
        x = batch.x0
        for l, block in enumerate(batch.blocks):
            x = _pyg_gat_layer(params, l, x, block, heads, drop_rate,
                               train, generator, remat)
        return x
    use_cache = (cache_emb is not None and batch.cache_mask is not None
                 and n_layers > 1)
    x = batch.x0
    for l, block in enumerate(batch.blocks):
        is_last = l == n_layers - 1
        if family == "gat":
            fn = functools.partial(_gat_layer, heads=1 if is_last else heads)
            args = (params.weights[l], params.attn[l], x, block.nbr,
                    block.weight, block.seed_in_src)
            pre = (checkpoint(fn, *args, use_reentrant=False) if remat
                   else fn(*args))
            if l == 0 and use_cache:
                pre = _merge_cache(pre, batch, cache_emb)
            if not is_last and batch_norm:
                pre = _batch_norm(pre, block.dst_valid)
            x = torch.relu(pre)
            if is_last:
                x = log_softmax(x.float())
            continue
        args = (params.weights[l], x, block.nbr, block.weight)
        if remat and not is_last:
            y = checkpoint(_agg_linear, *args, use_reentrant=False)
        else:
            y = _agg_linear(*args)
        if l == 0 and use_cache:
            y = _merge_cache(y, batch, cache_emb)
        if is_last:
            # classification head in f32 regardless of compute dtype
            x = log_softmax(y.float())
        else:
            x = torch.relu(_batch_norm(y, block.dst_valid) if batch_norm
                           else y)
            if train and drop_rate > 0.0 and generator is not None:
                x = dropout(generator, x, drop_rate, train)
    return x


def _pyg_gat_layer(params: GNNParams, l: int, x: torch.Tensor, block,
                   heads: int, drop_rate: float, train: bool,
                   generator: Optional[torch.Generator],
                   remat: bool) -> torch.Tensor:
    """Layer l of a PyG variant over its block (PyG's GATConv or
    GATv2Conv with concat on hidden layers, concat=False on the last, then
    the example's skip): `_pyg_attention`, then its epilogue inside the
    `epilogue` span, one piece of code for both stacks: on the last layer
    the mean of the heads; + b_l + x_dst·S_l + c_l (x_dst the
    destinations' own input rows); hidden layers elu, then dropout drawn
    from `generator` (through the module's `dropout`) while training; the
    last log_softmax in f32.  `remat` recomputes the attention in the
    backward pass."""
    last = l == len(params.weights) - 1
    args = (params, l, x, block, heads)
    agg = (checkpoint(_pyg_attention, *args, use_reentrant=False) if remat
           else _pyg_attention(*args))
    with timing.span("epilogue", agg):
        if last:
            agg = agg.view(agg.shape[0], heads, -1).mean(dim=1)
        dt = x.dtype
        x_dst = x.index_select(0, block.seed_in_src.long())
        out = torch.addmm(agg + (params.bias[l] + params.skip_b[l]).to(dt),
                          x_dst, params.skip_w[l].to(dt))
        if last:
            # f32 at least, as the other heads (f64 stays f64)
            return log_softmax(out.to(torch.promote_types(out.dtype,
                                                          torch.float32)))
        out = F.elu(out)
        if train and drop_rate > 0.0 and generator is not None:
            out = dropout(generator, out, drop_rate, train)
    return out


def _merge_cache(pre_act: torch.Tensor, batch: SampledBatch,
                 cache_emb: torch.Tensor) -> torch.Tensor:
    """Overlay the cached hot-vertex pre-activations onto layer 0's output
    (reference load_share_embedding, GCN_SAMPLE_PD_CACHE.hpp:938; kernel
    dev_load_share_embedding, ntsCUDATransferKernel.cuh:344).  The cached
    rows are constants to autograd (reference PushDownOp sets
    requires_grad_(false), ntsPushdownGraphOp.hpp:122)."""
    if cache_emb.shape[0] == 0:
        return pre_act
    rows = cache_emb.detach().index_select(
        0, batch.cache_slot.long()).to(pre_act.dtype)
    return torch.where(batch.cache_mask[:, None], rows, pre_act)
