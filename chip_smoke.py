#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `sgnn_tpu_torch/csrc/` (nvcc, into
`build/torch_kernels/`), then runs these phases, printing one JSON line each:

1. build     — nvcc time per kernel, and the card's name and power limit;
2. kernel    — `spmm_csr` (the kernel) against `spmm_csr_plain` on the same
               CUDA tensors, on skewed random CSR graphs at F in {7, 41, 128,
               256}, f32 and bf16 (hub rows: the edge-balanced sum); then
               the row kernel on rows of 0, 1, 31, 32, 33 and 1000 edges
               at F in {7, 41, 64, 128, 256, 602}, f32 and bf16, x aligned
               and one element off (each case names its layout: vector or
               scalar columns, half-warps on alternate edges or a whole
               warp), bit-identical on repeat; then, at the Reddit-shaped
               serving shapes (F=128 and 41, f32 and bf16), the kernel held
               to the plain version at the same tolerances, bit-identical
               on repeat, timed beside it, one library call
               (`torch.sparse.mm`, timed here only, never called by the
               port) and the bound (bytes once over HBM bandwidth,
               operations over f32 rate: every kernel's bound is
               `sgnn_tpu_torch.utils.roofline.kernel_bound`'s), with its
               layout and its registers and local
               (spill) bytes a thread, read from the loaded kernel;
3. kernel_k1 — K1's three kernels (`gather_agg_fwd`, `_bwd_dx`, `_bwd_dw`)
               against their plain versions at K in {1, 10, 25}, F in {7, 41,
               128, 602}, f32 and bf16, D not a multiple of 8, zero-weight
               slots and hub sources of 10^4 slots each, forward, dx and dw
               bit-identical on repeat; then at the two full-width training
               shapes (GraphSAGE 602-128-41, fanout 25-10, batch 10000: a
               device-sampled batch's blocks), each held to plain and timed
               beside plain, a library call and the bound, dx as called
               (its transpose, `block_transpose`, included) and the
               transpose alone, bit-identical to its plain version; each
               with its share of the bound, dw with its layout, registers
               and local bytes;
4. kernel_k3 — K3 (`gat_aggregate_cuda`) against `gat_aggregate_plain` on
               skewed random CSR graphs (hub rows of 6000 edges, rows with
               no edges, sources != destinations in one case) at (H, F) in
               {(1,7), (1,41), (1,128), (2,256), (4,128), (8,64), (16,256)}
               (the last: column tiles of 8 heads, two per row), f32 and
               bf16, with the score halves of some source rows raised past
               the ±60 clip; bit-identical on repeat; each case names its
               column path (vector: 4 adjacent columns a lane in one load;
               scalar); then at the Reddit-shaped GAT
               serving shapes (F=128 at H=1 and 4, F=41 at H=1, f32 and
               bf16) held to plain and timed beside plain, a composition of
               torch ops (scores, `torch.sparse.mm`, z; H=1, f32: no single
               PyTorch call computes K3) and the bound;
5. serving   — GCN 602-128-41 (seed-0 weights) on `reddit_like_dataset(seed=0,
               scale=1.0)` through `InferenceServer.logprobs()`: f32 pass
               time, two kernel launches per pass, agreement with the port's
               CPU pass, then a bf16 server's pass time, its log-probs held to
               the f32 pass within 0.05 and its argmax agreement; each
               pass's `roofline` reading (`roofline.stage_roofline` as
               bench.py reads its stages: ns per edge and the per-edge
               bytes model's rate, rows in 32-byte sectors, beside the
               same model under the TPU's 128-lane padding);
6. queries   — `query(nids)` for requests of 8, 64 and 512 vertices, each
               held to the whole-graph rows, with p50 latency per size;
7. serving_gat — GAT 602-128-41 (seed-0 weights, seeded nonzero attention
               vectors), heads 1 and 4, on the same graph: f32 pass times,
               exactly 2 K3 and 0 SpMM launches per pass, agreement with the
               port's CPU pass, a bf16 server held to the f32 one within 0.05
               with its argmax agreement, queries of 8/64/512 vertices held
               to the whole-graph rows with 2 K3 launches each, p50 latency,
               and one fanout query;
8. train_host   — GCNSAMPLEGPU (host sampler), GCN 602-128-41, fanout 25-10,
               batch 10000: the first batch's loss and weight gradients on
               the card held to the port's CPU on the same blocks and
               parameters (drop 0), then 3 training steps (drop 0.5), with
               per-step time and sampled edges/s;
9. train_device — GSSAMPLEALLGPU (device sampler) at the same widths: one
               whole epoch (16 steps) and `evaluate` on the validation
               vertices; finite losses, the last 4 steps' mean loss below
               the first step's, K1 launched 2 forward + 2 dx per step and 2
               forward per eval batch; per-step median time, sampled
               edges/s, overflow count and train accuracy; dx's transpose
               launched once per dx; the epoch's `roofline` reading;
10. train_gat — GATSAMPLEALLGPU (device sampler), GAT 602-128-41, heads 4,
               fanout 25-10, batch 10000: the first batch's loss and every
               weight's and attention vector's gradient on the card held to
               the port's CPU in f64 on the same blocks (drop 0, seeded
               nonzero attention; the CPU's f32 readings beside them), then
               one epoch (16 steps, drop 0.5) and
               `evaluate`: finite losses, the loss falling, no K1-K4
               launch, the sampled GAT kernels' (csrc/gat_sampled.cu) a
               forward per layer of each step and eval batch and a
               backward per layer of each step, the layers read from the
               forward's launches; per-step median time, sampled edges/s,
               accuracies, peak memory;
10b. kernel_gat_sampled — `scripts/torch_gat_sampled.py`'s `measure` on
               the same graph: at one device-sampled batch's two layers
               (F=128 H=4, F=41 H=1) the sampled GAT kernels held to their
               plain versions in f64 (1e-5) and bit-identical on repeat,
               timed beside plain, the layer's attention forward +
               backward under autograd through the kernels, and the
               bound; layouts and registers;
10c. kernel_gat_sampled_products — the same script's `measure_products`:
               the kernels at the gat_products cell's three layers ((D, S)
               = (61952, 681472), (5632, 61952), (512, 5632); (F, H) =
               (512, 4), (512, 4), (188, 4); 10 sampled slots and the own
               row's under the self-loop rule) held to plain in f64
               (1e-5), bit-identical on repeat, one forward and one
               backward launch a layer, timed as 10b;
11. kernel_k2_bwd — K2's backward (`spmm_csr_bwd_cuda`: csr_sum.cuh's
               edge-balanced sum over the transposed CSR, counted apart)
               against `spmm_csr_plain` over the same CSR, on skewed random
               graphs
               (hub rows, rows with no edges) at F in {7, 41, 128, 256},
               f32 and bf16, bit-identical on repeat; then at the
               Reddit-shaped graph's transposed CSR (F=128 and 41, f32)
               timed beside plain, `torch.sparse.mm` on the transposed CSR
               and the bound;
12. kernel_k4 — K4's two passes (`gat_bwd_src_cuda` B1, `gat_bwd_dst_cuda`
               B2) against their plain versions on K3's grid (clipped
               edges, rows with no in-edges and sources with no out-edges),
               f32 and bf16 ht, bit-identical on repeat; B2 again on K3's
               grid with rows of 0, 1, 31, 32, 33 and 1000 in-edges, ht
               and Gz aligned and one element off, a source whose raised
               score dominates its destinations (Gz, rz from a cotangent
               through the forward), each case naming its layout (vector
               or scalar columns), bit-identical on repeat; B1 at a
               source of 2·10^5 out-edges with 64, 256 and 1024 edges a
               warp (the chunk printed with the hub's chunk count); then
               at the Reddit shapes (F=128 H=4, F=128 H=1, F=41 H=1,
               f32), bit-identical on repeat, timed beside plain and the
               bound (B2 with its layout, registers and local bytes),
               with the backward of K3's plain version under autograd
               (H=1) timed as a yardstick;
13. train_full — GCNFULLBATCH, GSFULLBATCH and GATFULLBATCH (heads 4),
               602-128-41, lr 0.01: the first epoch's loss and every
               weight's and attention vector's gradient on the card held to
               the port's CPU at drop 0 on `reddit_like_dataset(seed=0,
               scale=0.25)`, the CPU taking the card's side of relu's kink
               where the two differ (counted); then 5 epochs each at drop
               0.5 on scale 1.0:
               finite losses, the last below the first, exactly 4 SpMM
               forward and 2 backward launches an epoch for GCN/GS (4 K3,
               2 B1, 2 B2 for GAT) and 2 forward launches per `predict()`;
               median epoch time after the first, whole-graph edges/s,
               accuracies, peak memory, the transposed CSR's build time;
               the GCNFULLBATCH epoch's `roofline` reading;
14. kernel_probes — the rate probes' four kernels (`ops/probes.py`,
               csrc/probe_gather.cu, probe_tile.cu) against their plain
               versions at the probes' shapes: gather_sum with the table in
               shared memory and in device memory at T=2048 and in device
               memory at T=232,965 and 2^22 (E = 2^20), shuffle at the nine
               shapes, tile_spmm at configuration 0 and each bisect case,
               gat_tile at the probe's tile and at 4096 tiles; all
               bit-identical on repeat, tile_spmm's scatter cases also bit
               for bit `tile_spmm_ordered` (its order of sums); then the path:
               the three `scripts/torch_probe_*.py` timing runs from zeroed
               counts (CUDA-graph replays, their kernel runs counted), each
               kernel beside its plain version and one library call timed
               the same way, the bound (P-T's also beside the slab-row
               bytes a gather reads), P-T's sum kernel's registers and
               local bytes, and P-T's ns/edge beside K2 forward's;
15. row_access_floor — the card's random-row-access floor, the
               counterpart of the TPU figure in sgnn_tpu/utils/roofline.py:
               a random f32 row gather of width 128 from a [V, 128] table
               over the graph's 11,880,013 edge sources in the CSR's order,
               cut to whole 2048-edge tiles (the cut printed), through
               P-G's device-memory gather-sum (`ops/probes.gather_sum`,
               resident=False) and `embedding_bag`, each held to the plain
               version on the leading tiles and timed by CUDA events: ns
               per row of each, the floor (the lesser) beside the module's
               `ROW_ACCESS_FLOOR_NS`;
16. serving_extras — on the same graph, GCN 602-128-41 (seed-0 weights)
               and GAT heads 4 (serving_gat's attention): int8 residency
               (`InferenceServer(dtype="int8")`): its feature bytes (a
               quarter of f32's), pass time beside the f32 pass, exactly 2
               K2 (K3) launches a pass, log-probs held to the port's CPU
               int8 pass at 1e-4, argmax agreement with the f32 pass above
               0.97, queries of 8/64/512 vertices held to the whole-graph
               rows; then chunked `layerwise_inference(whole_graph=False,
               chunk_size=65536)`, 4 chunks: exactly 8 K2 (GCN) or 8 K3
               (GAT) launches, held to the whole-graph pass at 1e-4, pass
               time, host-staging share and peak device memory beside the
               whole-graph pass's (lower); `whole_graph=None` choosing the
               whole-graph pass at this size and the chunked one under a
               budget of half the estimate;
17. train_extras — int8 GSSAMPLEALLGPU (602-128-41 / 25-10 / 10000, drop
               0.5): one epoch and evaluate, finite and falling losses,
               K1's launches as in train_device, median step time beside
               the f32 one, feature bytes; int8 GCNFULLBATCH: the first
               epoch's loss held to the port's CPU at scale 0.25, drop 0
               (1e-5), then 5 epochs at scale 1.0, finite and falling
               losses, exactly 4 K2 forward and 2 backward launches an
               epoch, median epoch time beside the f32 one, the epochs'
               peak device memory above the trainer's state; resume on the
               card (GSSAMPLEALLGPU): 2 epochs straight against 1 epoch,
               save, restore into a new trainer, 1 more, parameters held
               at 1e-4 relative (bit identity printed), the seconds and
               bytes of a save and a restore;
18. train_cache — the hot-vertex cache engines at the training widths
               (602-128-41 / 25-10 / 10000, drop 0.5, CACHE_RATE 0.1,
               PIPELINE_NUM 4: 4 super-batch plans): GSSAMPLECACHE's build
               (presample, the hot CSRs, the PushDown aggregates: exactly 4
               K2 launches), each plan's aggregate held to K2's plain
               version at 1e-5 and bit-identical on repeat, K2 at that
               shape (F=602) timed beside plain, `torch.sparse.mm` and the
               bound, the first cached batch's loss and gradients card vs
               CPU (drop 0, its cache rows), then one epoch and evaluate:
               finite and falling losses, 4 refreshes, K1 as in
               train_device, no K2; GCNSAMPLEPDCACHE (the device route)
               and GATSAMPLEPDCACHE heads 4 (no K1, no K3) the same;
               GCNSAMPLEPDCACHE with PD_REFRESH:host (the host sampler's
               cached trainer) and GSSAMPLEPDCACHE past the card's memory
               (HBM_BUDGET 300 MB: host features, a per-SB feature cache,
               host aggregates, no K2) for 3 steps each; hit rates, step
               times, edges/s beside train_device's, the feature cache's
               bytes shipped against full shipping;
19. train_dp — the *MULTI engines at the training widths on a one-rank
               NCCL group (`parallel.mesh.make_group`; a rank built on the
               CPU with NCCL raises): GCNSAMPLEALLMULTI and
               GATSAMPLEALLMULTI heads 4, one epoch each beside their
               single-device engines (GCNSAMPLEALLGPU, GATSAMPLEALLGPU) from
               the same seed — the same per-step losses, parameters within
               1e-6 relative (0 expected; the GAT pair under torch's
               deterministic algorithms, as its edge ops' backward adds
               with float atomics), the same launches — with median
               step, sampled edges/s and the gradient all-reduce's bytes and
               device time a step; GCNSAMPLEALLMULTI with SHARD_FEATURES:1
               (rows fetched through the collectives), parameters within
               1e-6 of the replicated run's, the fetch's time a step;
               GCNSAMPLEPCMULTI, GSSAMPLEPCMULTI and GATSAMPLEPCMULTI heads
               4 (one global hot set: exactly 1 K2 launch at build, its
               aggregate held to K2's plain version at 1e-5), one epoch
               each: 4 refreshes, hit rate, median step, edges/s; and
               GCNSAMPLEPCMULTI under PD_REFRESH:host through the
               host-sampled wrapper, 3 steps: step seconds;
20. cli      — `python -m sgnn_tpu_torch` in subprocesses on the shipped
               Cora configs: gs_cora_sample.cfg for 2 epochs with
               checkpoints and a report, resumed to 3 (one more epoch),
               then `--infer` (predictions [2708, 7], rows summing to 1);
               gcn_cora_fullbatch.cfg with `--exact-eval --profile` (a
               trace written); gat_cora_sample.cfg with `--exact-eval`;
               gcn_cora_sample.cfg (GCNSAMPLEPDCACHE) trained to its end;
               each run's accuracies and wall time;
21. train_partition — vertex-partitioned whole-graph training
               (parallel/halo.py) at the same widths: (a) on a one-rank
               NCCL graph group (`make_group(graph=1)`), GCNFULLBATCH,
               GSFULLBATCH and GATFULLBATCH heads 4 under HALO:all_gather
               and HALO:targeted, 3 epochs each at drop 0.5, beside the
               single-device trainer from the same seed: per-epoch losses
               and accuracies, final parameters and `predict()` within
               1e-6 relative (0 expected: a rank keeps only its real rows,
               so every product has the single program's shape), exactly
               one whole-graph epoch's launches an epoch and 2 a
               predict(), median epoch beside the single one, each
               collective's calls, bytes and device time an epoch; (b) a
               degree-balanced 4-way partition and both halo plans: each
               shard's rows, edges, rows_per_shard and H_pad, the halo
               bytes a rank receives a layer at F = 128 and 41; each
               shard, in turn on this card, fed what the exchange would
               deliver from the whole table: K2 forward and backward (F =
               128, 41), K3 and K4 (F = 128 H = 4, F = 41 H = 1) held to
               their plain versions (1e-5, GAT gradients at cosine >
               0.999) and to the single-device layer's rows (1e-5), the
               shards' K2 input gradients summed held to the single one,
               each shard's kernel times beside the single-device
               kernel's;
22. train_multihost — parallel/multihost.py's four epoch loops on a
               one-rank NCCL group that `initialize_distributed` joins at a
               TCP coordinator on this machine (NCCL takes one rank a
               card), at 602-128-41: the whole-graph driver (GCN
               all_gather, GAT heads 4 targeted; 3 epochs, drop 0.5)
               against `FullBatchTrainer`, the device-sampled driver with
               and without SHARD_FEATURES against GCNSAMPLEALLGPU, the
               *PCMULTI driver against the GCNSAMPLEPCMULTI engine (one
               epoch each): losses and parameters within 1e-6 relative (0
               expected), exact launches; the host-sampled driver's first
               step (the JAX driver's streams) card vs CPU at train_host's
               tolerances, then its epoch; kill-and-resume of the
               whole-graph (2 + 2 epochs) and device-sampled (1 + 1)
               drivers through the checkpoint pair, bit for bit a straight
               run; the join's seconds, each epoch beside the single
               engine's, each collective's calls, bytes and device time,
               the checkpoint's bytes and seconds; then `python -m
               sgnn_tpu_torch` with `--coordinator --nprocs 1 --pid 0` on
               the Cora fullbatch and (GCNSAMPLEALLGPU) sample configs;
23. reorder  — REORDER on the same graph: `vertex_order` none / degree /
               bfs and `apply_vertex_order`, their host seconds; each
               order's whole-graph build (CSC, the native transpose against
               np.argsort's, held equal); K2 forward and backward (F = 128,
               41), K3, B1 and B2 (H = 4 F = 128, H = 1 F = 41) on each
               order's CSR, timed by CUDA events over 20 calls, held to
               plain and (mapped back) to the original order's rows; K1
               forward and dx at each order's device-sampled batch; the
               engines: GCNFULLBATCH at drop 0 (its first loss within 1e-5
               relative of none's, its log-probs after one epoch mapped
               back within 1e-4), GATFULLBATCH heads 4 through
               `run_engine`'s REORDER (`report.vertex_order` the order),
               GSSAMPLEALLGPU one epoch: epoch and step times, sampled
               edges/s, exact launches; then the OGB data path: a
               planted-community graph at ogbn-arxiv's widths (20,000
               vertices, 128 features, 40 classes) written as an OGB
               directory, `load_ogb_dir`, `export_nts_format`,
               `load_from_config`, and GCNSAMPLEALLGPU trained one epoch
               through the CLI, each step's host seconds;
24. kernels  — one line listing every kernel with its launches on its main
               path (serving for `spmm_csr`, train_device for K1,
               serving_gat for K3, train_full for K2's backward and K4,
               train_gat for the sampled GAT kernels, kernel_probes for
               the probes) and, for K2, K3, K4 and K1, on
               the paths of phases 16-19 and 21-23 (`launches_by_path`),
               its error and its times (`spmm_csr` and `gat_bwd_dst` also
               their layouts and registers and local bytes at the main
               path's shapes; `spmm_csr` also at the PushDown shape).

Every main path (phases 5-10, 13 and 14, the int8 serving, chunked
serving, int8 sampled and int8 whole-graph paths of phases 16-17, each
cached build and run of phase 18, each data-parallel run of phase 19,
each sharded run of phase 21, each multi-host run of phase 22 and each
engine of phase 23) starts
with every launch count set to 0 and reads them all at its end; the CLI
runs in other processes, whose counts this one cannot read.  Then the card's name and power limit as
nvidia-smi prints them, and last `{"ok": true, "device": {...}}`.  Any
failed check raises and the script exits non-zero; nothing falls back to
the CPU or to a plain version.  With no CUDA device it exits 1 and prints
no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time
import types

import numpy as np

# tolerances of the kernel against its plain version, relative max-abs:
# f32 — both sum in f32, the kernel in CSR edge order with FMAs, the plain
# version by index_add_ (atomics on the card, so another order): only
# reassociation differs, a few f32 ulps of the largest partial sum;
# bf16 — the kernel sums in f32 and rounds once to bf16; it is held to
# the plain version's f32 result on the same values widened to f32
# (`exact_ref`), so the difference is that one rounding, at most 2^-8 of
# an element, plus reassociation; the repo's bf16 kernel bound
# (tests/test_mxu_spmm.py:57).  (Holding it to the plain version's own
# bf16 result instead compares two roundings of sums taken in different
# orders, which land one bf16 ulp, up to 2^-7 of an element, apart when
# the sums straddle a rounding boundary: K1's dx read 6.5e-3 so.)
TOL = {"float32": 1e-5, "bfloat16": 5e-3}
# serving, absolute on log-probs: the card's pass against the port's CPU
# pass and query rows against whole-graph rows — f32 throughout with TF32
# off, so only the summation order of matmul and SpMM differs
SERVE_ATOL = 1e-4
# bf16 server against the f32 server, absolute on log-probs: the bf16 pass
# rounds to 8 significant bits (2^-9 relative) at the feature cast, after
# each of the two products and after each of the two aggregations; through
# the relu and the 602- and 128-term sums that compounds to about 1e-2 of
# activations whose log-probs are O(1) (|log-prob| <= ~5 for these random
# weights), and log_softmax at most doubles a logit error.  0.05 is that
# with margin, the bound tests/test_torch_port_serving.py holds bf16 to.
BF16_SERVE_ATOL = 0.05
# training, card against the port's CPU on the same blocks and parameters
# (drop 0, TF32 off): the loss absolutely, each weight's gradient as
# max|Δg| / max|g| — f32 throughout, only summation orders differ (cuBLAS,
# K1's slot order, dx's transposed sum), a few f32 ulps through the 602- and
# 128-term sums
TRAIN_LOSS_ATOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
# the training configuration: the repo's headline stage (bench.py:104-134)
TRAIN_LAYERS, TRAIN_FANOUT, TRAIN_BATCH = [602, 128, 41], [25, 10], 10000
# GAT: scripts/measure_gat_serving.py's serving configuration (heads 1 and
# 4 on the hidden layer) and the training stage above with heads 4.  The
# attention vectors are drawn N(0, 1)·0.1: on these activations the scores
# are then O(1) (init_model's zeros would give uniform attention and leave
# the scores untested)
GAT_SERVE_HEADS, GAT_TRAIN_HEADS, GAT_ATTN_SCALE = (1, 4), 4, 0.1
# K3's check grid: (heads, F).  The scores spread by 2 (the attention
# scale), and one source row in K3_CLIP_EVERY has its score half raised by
# 80, past the ±60 clip: about 1% of the edges, some in every hub row, are
# clipped.  (A spread of 25 on every edge clips too, but with weights
# spanning e^±60 both f32 sums round visibly in the hub rows: kernel
# against plain measured 8.3e-6 at H=8, too close to the 1e-5 bound to
# hold the kernel.)
# (16, 256) has more heads than a column tile of the kernel spans (8), so
# each row is walked once per tile of 8 heads.
K3_GRID = ((1, 7), (1, 41), (1, 128), (2, 256), (4, 128), (8, 64),
           (16, 256))
K3_SCORE_STD, K3_CLIP_EVERY, K3_CLIP_RAISE = 2.0, 97, 80.0
# rows of these lengths reach every tail of a 32-edge window, of the four
# rows in flight and of K2's half-warps on alternate edges; K2's row kernel
# is held to its plain version at these widths (every layout: half-warps
# to F = 64, vector columns where F % 4 == 0 and x is aligned, column
# tiles past 128 or 256)
ROW_LENGTHS = (0, 1, 31, 32, 33, 1000)
K2_ROW_FEATS = (7, 41, 64, 128, 256, 602)
# K4's score-table gradients (dts, dtd) against their plain versions,
# relative max-abs, f32: each sums q_e = u·lrelu'·(t_e − rz), whose two
# terms cancel, so the f32 roundings of t_e (an F-term dot product summed
# in another order by each side) grow by |t_e| / |t_e − rz|
K4_TABLE_TOL = 1e-5
# the whole-graph training stage: the GCN/SAGE/GAT training widths above
# on the Reddit-shaped graph, lr 0.01; exactness at scale 0.25 (the CPU
# reference's passes stay short), speed at scale 1.0, drop 0.5
FULL_ENGINES = (("GCNFULLBATCH", 1), ("GSFULLBATCH", 1),
                ("GATFULLBATCH", GAT_TRAIN_HEADS))
FULL_EXACT_SCALE, FULL_EPOCHS = 0.25, 5
# the probe kernels against their plain versions, relative max-abs: P-G
# and P-T f32 — only the order of the f32 sums differs (a 2048-term sum of
# N(0,1) rows for P-G; products of bf16 values are exact for P-T, whose
# atomics add in a changing order), the repo's f32 rtol
# (tests/test_ops.py:47); P-A's out 5e-3, the repo's bf16 kernel bound
# (tests/test_mxu_spmm.py:57): a one-ulp difference in expf can flip
# bf16(u); its z 1e-5.  P-S moves data and must be bit-identical.
PROBE_F32_TOL, PROBE_BF16_TOL = 1e-5, 5e-3
# row_access_floor: the leading tiles of the gather-sum held to its plain
# version (at PROBE_F32_TOL), and the CUDA-event calls each time averages
FLOOR_CHECK_TILES = 64
FLOOR_REPS = 20
# int8 residency against f32: argmax agreement above the JAX package's
# bound (tests/test_quant.py:241); per-column rounding moves each feature
# by at most half a level, which flips the class of a vertex whose top two
# log-probs lie that close
INT8_ARGMAX_AGREE = 0.97
# chunked layerwise_inference's destination rows a chunk: the JAX
# package's default, four chunks on the Reddit-shaped graph
CHUNK_ROWS = 65536
# the cached engine past the card's memory: a device budget below the int8
# features (140 MB) beside the 4 plans' stacked aggregates (224 MB), so
# FeaturesExceedHbm routes it to the host-refreshed trainer; its feature
# cache then stages the f32 rows the aggregates leave room for, about
# 31,400 (the capacity probe counts both)
BEYOND_BUDGET = 300_000_000
# the one-rank data-parallel engines against their single-device engines
# (and SHARD_FEATURES against replicated features), relative max-abs over
# every parameter after an epoch: the same program on the same draws, so
# 0 is expected; 1e-6 allows one f32 ulp of a reordered sum
DP_PARAM_RTOL = 1e-6
# the sharded whole-graph trainer on a one-rank graph group against the
# single-device trainer (DP_PARAM_RTOL: the same draws, every product over
# the same rows, so 0 is expected): epochs a run
PART_EPOCHS = 3
ROOT = pathlib.Path(__file__).resolve().parent


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError("chip_smoke: " + msg)


def batch_to(batch, device):
    """A SampledBatch with every tensor moved to `device`."""
    def move(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
            if hasattr(getattr(obj, f.name), "to")})
    return dataclasses.replace(move(batch),
                               blocks=[move(b) for b in batch.blocks])


# ---- 21-22. the multi-host drivers and the renumbered graph ---------------
# Both phases take `c`, main()'s context: the Reddit-shaped dataset and its
# Adjacency, the card, the launch counters and main()'s timing helpers.

# the multi-host phase's epochs: the whole-graph drivers against the
# single-device trainer; its resumes (half and half, through a checkpoint)
MH_FULL_EPOCHS, MH_FULL_RESUME, MH_DEVICE_RESUME = 3, (2, 2), (1, 1)
# the renumbered graph: CUDA-event reps a kernel time, epochs a
# whole-graph engine, the widths timed (F) and the GAT shapes (H, F)
REORDER_REPS, REORDER_EPOCHS = 20, 3
REORDER_K2_FEATS, REORDER_GAT_SHAPES = (128, 41), ((4, 128), (1, 41))
# renumbered log-probs mapped back against the original order's:
# absolute, as SERVE_ATOL (only the order of each sum differs)
REORDER_PRED_ATOL = 1e-4
# the OGB data path: ogbn-arxiv's widths (128 features, 40 classes) on a
# graph made here at its mean in-degree, nothing downloaded
OGB_VERTICES, OGB_DEGREE, OGB_FEATS, OGB_CLASSES = 20000, 7, 128, 40


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def relu_sides(fn, branches: list, replay: bool):
    """`fn()` with `torch.relu` recording each call's side of the kink
    (`branches`), or replaying the recorded sides (`replay`): (its
    result, how many elements the replay moved to the recorded side)."""
    import torch

    real_relu, moved, sides = torch.relu, [0], iter(branches)

    def relu(t):
        if not replay:
            branches.append((t > 0).detach().cpu())
            return real_relu(t)
        keep = next(sides).to(t.device)
        moved[0] += int(((t > 0) != keep).sum())
        return torch.where(keep, t, torch.zeros((), dtype=t.dtype,
                                                device=t.device))

    torch.relu = relu
    try:
        return fn(), moved[0]
    finally:
        torch.relu = real_relu


def collective_summary(regions: dict, epochs: int) -> dict:
    """Each timed region's calls, bytes and device ms, per epoch."""
    return {tag: {"calls_an_epoch": len(rows) / epochs,
                  "bytes_an_epoch": sum(b for b, _ in rows) / epochs,
                  "ms_an_epoch": sum(ms for _, ms in rows) / epochs}
            for tag, rows in regions.items()}


def phase_train_multihost(c) -> dict:
    """The multi-host drivers on a one-rank NCCL group joined at a TCP
    coordinator, each against its single-device engine in this run (the
    main path's launches by driver returned)."""
    import torch
    import torch.distributed as dist

    from sgnn_tpu_torch.parallel import multihost as mh
    from sgnn_tpu_torch.train import build_trainer
    from sgnn_tpu_torch.train.engines import engine_from_config
    from sgnn_tpu_torch.train.fullbatch import FullBatchTrainer
    from sgnn_tpu_torch.train.trainer import (
        SampleTrainer, host_batch_to_device, loss_and_grads,
    )

    phase_t0 = time.perf_counter()
    ds, v = c.ds, c.ds.num_vertices
    t0 = time.perf_counter()
    rank, world = mh.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    join_s = time.perf_counter() - t0
    group = mh.global_mesh()
    require((rank, world) == (0, 1) and group.backend == "nccl"
            and group.device.type == "cuda" and group.graph == 1,
            f"the multi-host group is {group}")
    # NCCL makes its communicator at the first collective: timed apart, so
    # that the drivers' collectives are steady ones
    t0 = time.perf_counter()
    group.all_reduce_sum_(torch.ones(1, device=group.device))
    torch.cuda.synchronize()
    first_collective_s = time.perf_counter() - t0
    group.timed = True
    runs, launches = {}, {}

    def params_cmp(state_weights, want):
        """max |Δ| and max relative error of a driver's parameters (its
        state) against a trainer's."""
        got = [t.to(c.dev) for t in state_weights]
        return (max((a - b).abs().max().item() for a, b in zip(got, want)),
                max(c.rel_err(a, b) for a, b in zip(got, want)))

    def leaves_of(state):
        return [*state["params"]["weights"], *state["params"]["attn"]]

    def driver(fn, label, *args, **kw):
        """A driver call from zeroed counts: (losses, state, the launches,
        its epochs' host seconds, the collectives an epoch)."""
        state, times = {}, []
        group.region_times()
        c.reset_counts()
        torch.cuda.synchronize()
        losses = fn(*args, mesh=group, state_out=state, epoch_times=times,
                    **kw)
        got = {n: k for n, k in c.counts().items() if k}
        require(all(np.isfinite(losses)), f"{label}: losses {losses}")
        return (losses, state, got, times,
                collective_summary(group.region_times(), len(losses)))

    # (1) the whole-graph driver against FullBatchTrainer, 3 epochs, drop 0.5
    for algo, heads, halo in (("GCNFULLBATCH", 1, "all_gather"),
                              ("GATFULLBATCH", GAT_TRAIN_HEADS, "targeted")):
        cfg = dataclasses.replace(c.full_cfg(algo, heads, v, 0.5),
                                  epochs=MH_FULL_EPOCHS)
        spec = engine_from_config(cfg)
        single = FullBatchTrainer(cfg, ds, family=spec.family,
                                  weight_kind=spec.weight_kind, adj=c.adj)
        s_times, s_losses = [], []
        for _ in range(MH_FULL_EPOCHS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s_losses.append(single.train_epoch()[0])
            torch.cuda.synchronize()
            s_times.append(time.perf_counter() - t0)
        losses, state, got, times, coll = driver(
            mh.run_multihost_fullbatch_epochs, algo, cfg, ds,
            family=spec.family, halo=halo, weight_kind=spec.weight_kind)
        want = {n: k * MH_FULL_EPOCHS for n, k in c.per_epoch[algo].items()}
        require(got == want, f"{algo} driver launched {got}, expected {want}")
        p_abs, p_rel = params_cmp(leaves_of(state), single.params.leaves())
        l_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, s_losses))
        require(l_rel <= DP_PARAM_RTOL and p_rel <= DP_PARAM_RTOL,
                f"{algo} driver against the single trainer: losses {l_rel}, "
                f"parameters {p_rel}")
        launches[f"fullbatch_{spec.family}"] = got
        runs[f"fullbatch {algo} {halo}"] = {
            "heads": heads, "losses": losses, "single_losses": s_losses,
            "loss_max_rel_diff": l_rel, "params_max_abs_diff": p_abs,
            "params_bit_identical": p_abs == 0.0 and losses == s_losses,
            "epoch_s": times, "single_epoch_s": s_times,
            "epoch_ms_median_after_first": statistics.median(times[1:]) * 1e3,
            "single_epoch_ms_median_after_first":
            statistics.median(s_times[1:]) * 1e3,
            "collectives": coll, "launches": got}
        del single, state
    # (2) the device-sampled driver, replicated and row-sharded features,
    # against GCNSAMPLEALLGPU; (3) the *PCMULTI driver against the
    # GCNSAMPLEPCMULTI engine on this group: one epoch each
    sd_cfg = dataclasses.replace(c.dev_cfg, algorithm="GCNSAMPLEALLGPU")
    pc_cfg = dataclasses.replace(c.dev_cfg, algorithm="GCNSAMPLEPCMULTI")
    for label, fn, cfg, kw, ref_cfg in (
            ("device_dp", mh.run_multihost_device_dp_epochs, sd_cfg,
             dict(shard_features=False), sd_cfg),
            ("device_dp SHARD_FEATURES", mh.run_multihost_device_dp_epochs,
             sd_cfg, dict(shard_features=True), sd_cfg),
            ("pcmulti", mh.run_multihost_pcmulti_epochs, pc_cfg, {},
             pc_cfg)):
        ref = build_trainer(ref_cfg, ds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_loss = ref.train_epoch()[0]
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        ref_base = getattr(ref, "base", ref)
        losses, state, got, times, coll = driver(fn, label, cfg, ds, epochs=1,
                                                 family="gcn", **kw)
        # the *PCMULTI build's one PushDown aggregate, K2
        want = {**c.k1_expect(16, 0),
                **({"spmm_csr": 1} if label == "pcmulti" else {})}
        require(got == want, f"{label} driver launched {got}, expected "
                             f"{want}")
        p_abs, p_rel = params_cmp(leaves_of(state), ref_base.params.leaves())
        l_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
        require(l_rel <= DP_PARAM_RTOL and p_rel <= DP_PARAM_RTOL,
                f"{label} driver against {ref_cfg.algorithm}: loss {l_rel}, "
                f"parameters {p_rel}")
        launches[label.replace(" ", "_").lower()] = got
        runs[label] = {
            "reference": ref_cfg.algorithm, "loss": losses[0],
            "reference_loss": ref_loss, "loss_rel_diff": l_rel,
            "params_max_abs_diff": p_abs,
            "params_bit_identical": p_abs == 0.0 and losses[0] == ref_loss,
            "epoch_s": times[0], "reference_epoch_s": ref_s,
            "reference_step_ms_median_after_first": statistics.median(
                ref_base.step_ms[1:]),
            "collectives": coll, "launches": got}
        del ref, ref_base, state
    # (4) the host-sampled driver: its first step (the JAX driver's streams)
    # on the card against the port's CPU, then one epoch
    host_cfg = dataclasses.replace(c.dev_cfg, algorithm="GCNSAMPLEGPU")
    base = SampleTrainer(host_cfg, ds, family="gcn")
    seeds = mh.multihost_epoch_seeds(host_cfg.seed, base.train_nids,
                                     host_cfg.batch_size, 0, 0, 1)
    base.sampler.rng = mh.multihost_step_rng(host_cfg.seed, 0, 0, 0)
    item = base._make_batch(seeds[0])
    card_batch, _ = base._upload(item)
    cpu_batch = host_batch_to_device(
        item.hb, *item.hb.payload(ds.features, ds.labels), device="cpu")
    # relu's kink: the CPU takes the card's side of every hidden
    # pre-activation (train_full's replay): a few lie within f32 rounding
    # of 0, and one flipped element moves dW0 by ~3e-4 of its largest entry
    branches = []
    card, _ = relu_sides(lambda: loss_and_grads(base.params, "gcn",
                                                card_batch), branches, False)
    cpu, moved = relu_sides(lambda: loss_and_grads(
        base.params.to("cpu"), "gcn", cpu_batch), branches, True)
    loss_diff = abs(card.loss.item() - cpu.loss.item())
    grad_errs = [c.rel_err(a, b) for a, b in zip(card.grads, cpu.grads)]
    require(loss_diff <= TRAIN_LOSS_ATOL and max(grad_errs) <= TRAIN_GRAD_RTOL,
            f"host-sampled driver's first step, card vs CPU: loss "
            f"{loss_diff}, gradients {grad_errs}")
    del base, card, cpu, card_batch, cpu_batch, item
    times = []
    group.region_times()
    c.reset_counts()
    losses = mh.run_multihost_dp_epochs(host_cfg, ds, epochs=1, family="gcn",
                                        mesh=group, epoch_times=times)
    got = {n: k for n, k in c.counts().items() if k}
    want = c.k1_expect(len(seeds), 0)
    require(np.isfinite(losses[0]) and got == want,
            f"host-sampled driver: loss {losses}, launched {got}, expected "
            f"{want}")
    launches["host_dp"] = got
    runs["host_dp"] = {
        "first_step_loss_abs_diff": loss_diff, "loss_atol": TRAIN_LOSS_ATOL,
        "first_step_grad_rel_err": grad_errs, "grad_rtol": TRAIN_GRAD_RTOL,
        "relu_sides_replayed": moved,
        "steps": len(seeds), "loss": losses[0], "epoch_s": times[0],
        "step_s_mean": times[0] / len(seeds),
        "train_host_steps_ms": [s["sample_ms"] + s["upload_train_ms"]
                                for s in c.host_steps],
        "collectives": collective_summary(group.region_times(), 1),
        "launches": got}
    # (5) kill and resume through the checkpoint pair, against a straight run
    ckpt_root = ROOT / "build" / "chip_smoke_mh_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    gcn_full = c.full_cfg("GCNFULLBATCH", 1, v, 0.5)
    resumes = {}
    for label, fn, cfg, split in (
            ("fullbatch GCNFULLBATCH", mh.run_multihost_fullbatch_epochs,
             gcn_full, MH_FULL_RESUME),
            ("device_dp GCNSAMPLEALLGPU", mh.run_multihost_device_dp_epochs,
             sd_cfg, MH_DEVICE_RESUME)):
        directory = str(ckpt_root / label.split()[0])
        straight = {}
        s_losses = fn(cfg, ds, epochs=sum(split), family="gcn", mesh=group,
                      state_out=straight)
        first = {}
        losses = fn(cfg, ds, epochs=split[0], family="gcn", mesh=group,
                    state_out=first)
        t0 = time.perf_counter()
        path = mh.multihost_checkpoint_save(directory, split[0], first)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = mh.multihost_checkpoint_restore(directory)
        restore_s = time.perf_counter() - t0
        require(back is not None and back["step"] == split[0],
                f"{label}: restored {back and back['step']}")
        resumed = {}
        losses += fn(cfg, ds, epochs=split[1], family="gcn", mesh=group,
                     resume_state=back, state_out=resumed)
        bit = losses == s_losses and all(
            torch.equal(a, b) for a, b in zip(leaves_of(resumed),
                                              leaves_of(straight)))
        require(bit, f"{label}: resumed {losses} against straight "
                     f"{s_losses}, parameters bit-identical {bit}")
        resumes[label] = {"split": list(split), "losses": losses,
                          "bit_identical": bit,
                          "checkpoint_bytes": os.path.getsize(path),
                          "save_s": save_s, "restore_s": restore_s}
    shutil.rmtree(ckpt_root, ignore_errors=True)
    dist.destroy_process_group()
    # (6) the CLI's coordinator flags, one rank each, both runs at once
    cli_runs, procs = [], []
    t0 = time.perf_counter()
    for cfg_name, flags in (("gcn_cora_fullbatch.cfg", ()),
                            ("gcn_cora_sample.cfg",
                             ("--algorithm", "GCNSAMPLEALLGPU"))):
        procs.append((cfg_name, flags, subprocess.Popen(
            [sys.executable, "-m", "sgnn_tpu_torch", f"configs/{cfg_name}",
             *flags, "--coordinator", f"127.0.0.1:{free_port()}",
             "--nprocs", "1", "--pid", "0"], cwd=ROOT, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
    try:
        for cfg_name, flags, proc in procs:
            _, err = proc.communicate(timeout=300)
            final = [ln.split("] ", 1)[-1] for ln in err.splitlines()
                     if "multihost final loss" in ln]
            require(proc.returncode == 0 and len(final) == 1,
                    f"CLI {cfg_name} --coordinator exited "
                    f"{proc.returncode}: {err[-2000:]}")
            cli_runs.append({"cfg": cfg_name, "flags": list(flags),
                             "final": final[0],
                             "wall_s": time.perf_counter() - t0})
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    emit({"phase": "train_multihost", "model": "602-128-41",
          "join_s": join_s, "first_collective_s": first_collective_s,
          "group": {"backend": group.backend,
                                      "world_size": world,
                                      "device": str(group.device)},
          "param_rtol": DP_PARAM_RTOL, "runs": runs, "resume": resumes,
          "cli": cli_runs, "phase_s": time.perf_counter() - phase_t0})
    return launches


def write_ogb_dir(root: pathlib.Path, ds) -> None:
    """`ds` as an OGB node-property directory (gzip CSVs, the layout of
    `data/ogb.load_ogb_dir`), without its self-loops, one random split."""
    import gzip

    def csv(path, rows, fmt):
        path.parent.mkdir(parents=True, exist_ok=True)
        with gzip.open(path, "wt", compresslevel=1) as f:
            np.savetxt(f, rows, delimiter=",", fmt=fmt)

    edges = ds.edges[ds.edges[:, 0] != ds.edges[:, 1]]
    csv(root / "raw" / "edge.csv.gz", edges, "%d")
    csv(root / "raw" / "node-feat.csv.gz", ds.features, "%.9g")
    csv(root / "raw" / "node-label.csv.gz", ds.labels[:, None], "%d")
    for name, code in (("train", 0), ("valid", 1), ("test", 2)):
        csv(root / "split" / "random" / f"{name}.csv.gz",
            np.nonzero(ds.masks == code)[0][:, None], "%d")


def phase_reorder(c) -> dict:
    """REORDER on the Reddit-shaped graph: the orders' host cost, K1-K4's
    times on each order's CSR, the engines' times, the exactness of a
    renumbering, the build's host sort, and the OGB data path (the main
    path's launches by order returned)."""
    import torch

    from sgnn_tpu_torch.config import load_cfg
    from sgnn_tpu_torch.data import (
        export_nts_format, load_from_config, load_ogb_dir,
        planted_community_dataset,
    )
    from sgnn_tpu_torch.graph import apply_vertex_order, vertex_order
    from sgnn_tpu_torch.graph.adjacency import Adjacency
    from sgnn_tpu_torch.ops import aggregate as agg
    from sgnn_tpu_torch.ops.cuda import gather_agg as k1
    from sgnn_tpu_torch.ops.cuda.gat import gat_aggregate_cuda
    from sgnn_tpu_torch.ops.cuda.gat_bwd import (
        gat_bwd_dst_cuda, gat_bwd_src_cuda,
    )
    from sgnn_tpu_torch.ops.cuda.spmm import spmm_csr_bwd_cuda, spmm_csr_cuda
    from sgnn_tpu_torch.ops.gat import (
        gat_aggregate_plain, gat_bwd_operands, pack_score_tables,
    )
    from sgnn_tpu_torch.ops.segment import (
        csr_from_numpy, csr_transpose, spmm_csr_plain,
    )
    from sgnn_tpu_torch.sampler.blocks import WeightKind
    from sgnn_tpu_torch.train import build_trainer, run_engine
    from sgnn_tpu_torch.train.fullbatch import build_coo

    phase_t0 = time.perf_counter()
    ds, v, dev = c.ds, c.ds.num_vertices, c.dev
    gen = torch.Generator().manual_seed(13)
    # the inputs in the original ids; each order reads them renumbered
    x_in = {f: torch.randn(v, f, generator=gen) for f in REORDER_K2_FEATS}
    g_in = {f: torch.randn(v, f, generator=gen) for f in REORDER_K2_FEATS}
    a_in = {shape: torch.randn(2 * shape[1], generator=gen) * GAT_ATTN_SCALE
            for shape in REORDER_GAT_SHAPES}
    orders, kernel_rows, engine_rows, build_rows = {}, {}, {}, {}
    launches, ref_rows = {}, {}
    for mode in ("none", "degree", "bfs"):
        t0 = time.perf_counter()
        order = vertex_order(c.adj, mode)
        order_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rds, old_to_new = ((ds, order) if mode == "none"
                           else apply_vertex_order(ds, order))
        apply_s = time.perf_counter() - t0
        orders[mode] = {"order_s": order_s, "apply_s": apply_s}
        # the whole-graph build's host steps: the CSC, the GCN weights, and
        # the transpose by the native sort against np.argsort's
        t0 = time.perf_counter()
        radj = Adjacency.from_edges(rds.edges, v)
        csc_s = time.perf_counter() - t0
        src, _, w = build_coo(radj, WeightKind.GCN)
        t0 = time.perf_counter()
        rowptr_t, col_t, w_t = csr_transpose(radj.indptr, src, w, v)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = np.repeat(np.arange(v, dtype=np.int32), np.diff(radj.indptr))
        perm = np.argsort(src, kind="stable")
        numpy_t = (rows[perm], w[perm])
        numpy_s = time.perf_counter() - t0
        require(np.array_equal(numpy_t[0], col_t)
                and np.array_equal(numpy_t[1], w_t),
                f"{mode}: the native transpose differs from np.argsort's")
        t0 = time.perf_counter()
        radj.transpose()
        adj_t_s = time.perf_counter() - t0
        build_rows[mode] = {"csc_s": csc_s, "csr_transpose_native_s": native_s,
                            "csr_transpose_np_argsort_s": numpy_s,
                            "adjacency_transpose_s": adj_t_s}
        del rows, perm, numpy_t
        # kernel times on this order's CSR and transpose
        perm_t = torch.from_numpy(np.asarray(order, np.int64))
        back_t = torch.from_numpy(np.asarray(old_to_new, np.int64)).to(dev)
        csr = csr_from_numpy(radj.indptr, src, w, v, dev)
        csr_t = csr_from_numpy(rowptr_t, col_t, w_t, v, dev)
        krows = []
        for f in REORDER_K2_FEATS:
            x = x_in[f][perm_t].to(dev)
            g = g_in[f][perm_t].to(dev)
            out = spmm_csr_cuda(x, *csr)
            dx = spmm_csr_bwd_cuda(g, *csr_t)
            torch.cuda.synchronize()
            errs = [c.rel_err(out, spmm_csr_plain(x, *csr)),
                    c.rel_err(dx, spmm_csr_plain(g, *csr_t))]
            if mode == "none":
                ref_rows[f] = (out, dx)
            else:
                errs += [c.rel_err(out[back_t], ref_rows[f][0]),
                         c.rel_err(dx[back_t], ref_rows[f][1])]
            require(max(errs) <= TOL["float32"],
                    f"{mode} K2 F={f}: {errs}")
            krows.append({"kernel": "spmm_csr", "F": f, "rel_err": errs,
                          "ms": c.time_ms(lambda: spmm_csr_cuda(x, *csr),
                                          REORDER_REPS)})
            krows.append({"kernel": "spmm_csr_bwd", "F": f,
                          "ms": c.time_ms(lambda: spmm_csr_bwd_cuda(
                              g, *csr_t), REORDER_REPS)})
            del x, g, out, dx
        for heads, f in REORDER_GAT_SHAPES:
            ht = x_in[f][perm_t].to(dev)
            a = a_in[heads, f].to(dev)
            ts, td = pack_score_tables(ht, a[:f], a[f:], heads)
            h, z = gat_aggregate_cuda(ht, ts, td, csr.rowptr, csr.col, heads)
            ref_h, _ = gat_aggregate_plain(ht, ts, td, csr.rowptr, csr.col,
                                           heads)
            gz, rz = gat_bwd_operands(g_in[f][perm_t].to(dev), h, z, heads)
            b1 = (ht, ts, gz, td, rz, csr_t.rowptr, csr_t.col, heads)
            b2 = (ht, ts, gz, td, rz, csr.rowptr, csr.col, heads)
            dht, _dts = gat_bwd_src_cuda(*b1)
            torch.cuda.synchronize()
            errs = [c.rel_err(h, ref_h)]
            if mode == "none":
                ref_rows[heads, f] = (h, dht)
            else:
                errs += [c.rel_err(h[back_t], ref_rows[heads, f][0]),
                         c.rel_err(dht[back_t], ref_rows[heads, f][1])]
            require(max(errs) <= TOL["float32"],
                    f"{mode} K3/B1 H={heads} F={f}: {errs}")
            for name, fn in (
                    ("gat_aggregate", lambda: gat_aggregate_cuda(
                        ht, ts, td, csr.rowptr, csr.col, heads)),
                    ("gat_bwd_src", lambda: gat_bwd_src_cuda(*b1)),
                    ("gat_bwd_dst", lambda: gat_bwd_dst_cuda(*b2))):
                krows.append({"kernel": name, "H": heads, "F": f,
                              "ms": c.time_ms(fn, REORDER_REPS),
                              **({"rel_err": errs} if name == "gat_aggregate"
                                 else {})})
            del ht, ts, td, h, z, ref_h, gz, rz, b1, b2, dht
        del csr, csr_t, radj, src, w, rowptr_t, col_t, w_t
        # the engines: GCNFULLBATCH at drop 0 (exactness: its first loss,
        # its log-probs after the first epoch mapped back), GATFULLBATCH
        # h4 through run_engine's REORDER, GSSAMPLEALLGPU one epoch
        erows = {}
        cfg = c.full_cfg("GCNFULLBATCH", 1, v, 0.0)
        c.reset_counts()
        eng = build_trainer(cfg, rds)
        hist = []
        for ep in range(REORDER_EPOCHS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hist.append(eng.base.train_epoch()[0])
            torch.cuda.synchronize()
            hist.append(time.perf_counter() - t0)
            if ep == 0:
                pred = eng.base.predict()[np.asarray(old_to_new)]
        gcn_losses, gcn_s = hist[0::2], hist[1::2]
        got = {n: k for n, k in c.counts().items() if k}
        # drop 0: no clean forward; 2 a predict()
        want = {"spmm_csr": 2 * REORDER_EPOCHS + 2,
                "spmm_csr_bwd": 2 * REORDER_EPOCHS}
        require(got == want, f"{mode} GCNFULLBATCH launched {got}")
        launches[f"{mode}_gcnfullbatch"] = got
        if mode == "none":
            ref_rows["loss"], ref_rows["pred"] = gcn_losses[0], pred
        loss_rel = abs(gcn_losses[0] - ref_rows["loss"]) / ref_rows["loss"]
        pred_abs = float(np.abs(pred - ref_rows["pred"]).max())
        require(loss_rel <= 1e-5 and pred_abs <= REORDER_PRED_ATOL,
                f"{mode}: first loss {loss_rel} relative from none's, "
                f"log-probs {pred_abs}")
        erows["GCNFULLBATCH"] = {
            "drop": 0.0, "losses": gcn_losses, "epoch_s": gcn_s,
            "epoch_ms_median_after_first": statistics.median(gcn_s[1:]) * 1e3,
            "first_loss_rel_diff_vs_none": loss_rel,
            "predict_max_abs_diff_vs_none": pred_abs, "launches": got}
        del eng, pred
        cfg = dataclasses.replace(c.full_cfg("GATFULLBATCH", GAT_TRAIN_HEADS,
                                             v, 0.5), reorder=mode,
                                  epochs=REORDER_EPOCHS)
        c.reset_counts()
        rep = run_engine(cfg, ds)
        got = {n: k for n, k in c.counts().items() if k}
        want = {n: k * REORDER_EPOCHS for n, k in
                c.per_epoch["GATFULLBATCH"].items()}
        require(got == want, f"{mode} GATFULLBATCH launched {got}")
        require((rep.vertex_order is None) == (mode == "none")
                and (mode == "none"
                     or np.array_equal(rep.vertex_order, order)),
                f"{mode}: run_engine's vertex_order is not the order")
        require(all(np.isfinite(rep.losses)), f"{mode} GAT {rep.losses}")
        launches[f"{mode}_gatfullbatch"] = got
        erows["GATFULLBATCH h4"] = {
            "drop": 0.5, "losses": rep.losses, "epoch_s": rep.epoch_times,
            "epoch_ms_median_after_first": statistics.median(
                rep.epoch_times[1:]) * 1e3, "launches": got}
        tr = build_trainer(c.dev_cfg, rds)
        # K1 at this order's device-sampled batch shapes
        sample = c.first_batch(tr)
        for layer, f in ((0, TRAIN_LAYERS[1]), (1, TRAIN_LAYERS[2])):
            blk = sample.blocks[layer]
            nbr, bw, s_ = blk.nbr, blk.weight, blk.num_src_pad
            xs = torch.randn(s_, f, generator=gen).to(dev)
            gs = torch.randn(nbr.shape[0], f, generator=gen).to(dev)
            errs = [c.rel_err(k1.gather_agg_fwd_cuda(xs, nbr, bw),
                              agg.gather_aggregate_plain(xs, nbr, bw)),
                    c.rel_err(k1.gather_agg_bwd_dx_cuda(gs, nbr, bw, xs),
                              agg.gather_agg_bwd_dx_plain(gs, nbr, bw, s_,
                                                          xs.dtype))]
            require(max(errs) <= TOL["float32"],
                    f"{mode} K1 layer {layer}: {errs}")
            krows.append({"kernel": "gather_agg_fwd", "layer": layer,
                          "D": nbr.shape[0], "K": nbr.shape[1], "S": s_,
                          "F": f, "rel_err": errs, "ms": c.time_ms(
                              lambda: k1.gather_agg_fwd_cuda(xs, nbr, bw),
                              REORDER_REPS)})
            krows.append({"kernel": "gather_agg_bwd_dx", "layer": layer,
                          "F": f, "ms": c.time_ms(
                              lambda: k1.gather_agg_bwd_dx_cuda(gs, nbr, bw,
                                                                xs),
                              REORDER_REPS)})
            del xs, gs
        del sample
        kernel_rows[mode] = krows
        c.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, edges = tr.train_epoch()
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        got = {n: k for n, k in c.counts().items() if k}
        require(np.isfinite(loss) and got == c.k1_expect(16, 0),
                f"{mode} GSSAMPLEALLGPU: loss {loss}, launched {got}")
        launches[f"{mode}_gssampleallgpu"] = got
        med = statistics.median(tr.step_ms[1:])
        erows["GSSAMPLEALLGPU"] = {
            "drop": 0.5, "loss": loss, "epoch_s": epoch_s,
            "step_ms_median_after_first": med, "edges": edges,
            "sampled_edges_per_s_steady": edges / len(tr.step_ms)
            / (med / 1e3), "launches": got}
        engine_rows[mode] = erows
        del tr, rds, old_to_new, perm_t, back_t
    ref_rows.clear()
    # the OGB data path: write, load, export, read back, train (the CLI)
    ogb_dir = ROOT / "build" / "chip_smoke_ogb"
    shutil.rmtree(ogb_dir, ignore_errors=True)
    steps = {}
    t0 = time.perf_counter()
    made = planted_community_dataset(OGB_VERTICES, OGB_DEGREE, OGB_FEATS,
                                     OGB_CLASSES, seed=0)
    write_ogb_dir(ogb_dir / "ogbn-synth", made)
    steps["write_ogb_dir_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_ogb_dir(str(ogb_dir / "ogbn-synth"), "ogbn-synth")
    steps["load_ogb_dir_s"] = time.perf_counter() - t0
    require(loaded.num_vertices == OGB_VERTICES
            and np.array_equal(loaded.features, made.features)
            and np.array_equal(loaded.labels, made.labels)
            and np.array_equal(loaded.masks, made.masks),
            "the OGB directory did not load back the dataset")
    t0 = time.perf_counter()
    base = export_nts_format(loaded, str(ogb_dir / "nts"), "ogbn-synth")
    steps["export_nts_format_s"] = time.perf_counter() - t0
    cfg_path = ogb_dir / "ogbn-synth.cfg"
    cfg_path.write_text("\n".join([
        "ALGORITHM:GCNSAMPLEALLGPU", f"VERTICES:{OGB_VERTICES}",
        f"LAYERS:{OGB_FEATS}-128-{OGB_CLASSES}",
        "FANOUT:" + "-".join(map(str, TRAIN_FANOUT)), "BATCH_SIZE:1024",
        "EPOCHS:1", "LEARN_RATE:0.01", "DROP_RATE:0.5",
        f"EDGE_FILE:{base}.{OGB_VERTICES}.edge.self",
        f"FEATURE_FILE:{base}.featuretable",
        f"LABEL_FILE:{base}.labeltable", f"MASK_FILE:{base}.mask"]) + "\n")
    t0 = time.perf_counter()
    back = load_from_config(load_cfg(str(cfg_path)))
    steps["load_from_config_s"] = time.perf_counter() - t0
    require(all(np.array_equal(getattr(back, k), getattr(loaded, k))
                for k in ("edges", "features", "labels", "masks")),
            "the NTS export did not read back the OGB dataset")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "sgnn_tpu_torch", str(cfg_path),
         "--report-out", str(ogb_dir / "report.json")], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    steps["cli_train_s"] = time.perf_counter() - t0
    require(out.returncode == 0, f"the OGB cfg's CLI run exited "
                                 f"{out.returncode}: {out.stderr[-2000:]}")
    with open(ogb_dir / "report.json") as f:
        report = json.load(f)
    require(len(report["losses"]) == 1 and np.isfinite(report["losses"][0]),
            f"the OGB cfg trained {report['losses']}")
    shutil.rmtree(ogb_dir, ignore_errors=True)
    emit({"phase": "reorder", "graph": {"V": v, "E": c.adj.num_edges},
          "orders": orders, "build": build_rows, "kernels": kernel_rows,
          "kernel_reps": REORDER_REPS, "engines": engine_rows,
          "ogb": {"V": OGB_VERTICES, "E": int(loaded.num_edges),
                  "F": OGB_FEATS, "classes": OGB_CLASSES, "steps": steps,
                  "cli_loss": report["losses"][0],
                  "cli_epoch_s": report["epoch_times"][0],
                  "cli_train_acc": report["train_acc"][0]},
          "phase_s": time.perf_counter() - phase_t0})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from sgnn_tpu_torch import full_f32_products
    from sgnn_tpu_torch.config import RunConfig
    from sgnn_tpu_torch.data.synthetic import reddit_like_dataset
    from sgnn_tpu_torch.graph.adjacency import Adjacency
    from sgnn_tpu_torch.models.gnn import init_model
    from sgnn_tpu_torch.ops import aggregate as agg
    from sgnn_tpu_torch.ops.cuda import gather_agg as k1
    from sgnn_tpu_torch.ops.cuda.build import build_all
    from sgnn_tpu_torch.ops.cuda import gat_bwd as k4
    from sgnn_tpu_torch.ops.cuda import gat_sampled as gsk
    from sgnn_tpu_torch.ops.cuda.gat import gat_aggregate_cuda, vector_columns
    from sgnn_tpu_torch.ops.cuda.gat_bwd import (
        dst_layout, gat_bwd_dst_cuda, gat_bwd_src_cuda,
    )
    from sgnn_tpu_torch.ops.cuda.spmm import (
        forward_layout, spmm_csr_bwd_cuda, spmm_csr_cuda,
    )
    from sgnn_tpu_torch.ops.gat import (
        ATT_CLIP, F32_TINY, NEG_SLOPE, GatAggregate, gat_aggregate_plain,
        gat_bwd_dst_plain, gat_bwd_operands, gat_bwd_src_plain,
        pack_score_tables,
    )
    from sgnn_tpu_torch.ops import probes as pr
    from sgnn_tpu_torch.ops.cuda import probes as probe_k
    from sgnn_tpu_torch.ops.segment import (
        csr_chunk_edges, csr_from_numpy, csr_transpose, spmm_csr_plain,
    )
    from sgnn_tpu_torch.cache.embedding_cache import refresh_rows
    from sgnn_tpu_torch.cache.orchestrator import CachedSampleTrainer
    from sgnn_tpu_torch.parallel.dp import DataParallelTrainer
    from sgnn_tpu_torch.parallel.dp_device import (
        DeviceCachedDataParallelTrainer, DeviceDataParallelTrainer,
    )
    from sgnn_tpu_torch.parallel.halo import (
        build_targeted_halo, exchange_reference, local_aggregate, local_gat,
        shard_graph, shard_on_device,
    )
    from sgnn_tpu_torch.parallel.mesh import DataGroup, make_group
    from sgnn_tpu_torch.train.device_cached import DeviceCachedSampleTrainer
    from sgnn_tpu_torch.nn.functional import nll_loss_masked
    from sgnn_tpu_torch.train.engines import engine_from_config
    from sgnn_tpu_torch.train.fullbatch import FullBatchTrainer, build_coo
    from sgnn_tpu_torch.sampler.blocks import WeightKind
    from sgnn_tpu_torch.sampler.device import device_sample_batch
    from sgnn_tpu_torch.train import build_trainer
    from sgnn_tpu_torch.train.checkpoint import CheckpointManager
    from sgnn_tpu_torch.train.inference import (
        InferenceServer, layerwise_inference, whole_graph_bytes,
    )
    from sgnn_tpu_torch.utils.profiling import memory_budget
    from sgnn_tpu_torch.train.trainer import (
        host_batch_to_device, loss_and_grads,
    )
    from sgnn_tpu_torch.utils import roofline
    from sgnn_tpu_torch.utils.timing import PhaseTimer, cuda_graph_ms

    dev = torch.device("cuda")
    full_f32_products(dev)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    hbm = roofline.hbm_bytes_per_s(name)

    def bound(kernel, dtype_bytes=4, **shape) -> dict:
        """`kernel`'s bound at `shape` on this card: its bytes once and
        operations, bound_ms, bound_by, and gather_bound_ms (a source row
        read an edge)."""
        return roofline.kernel_bound(kernel, name, dtype_bytes, **shape)

    spmm_models = (roofline.spmm_bytes_model,
                   roofline.lane_padded_spmm_bytes_model)
    sampled_models = (roofline.sampled_bytes_model,
                      roofline.lane_padded_sampled_bytes_model)

    def stage_reading(seconds, edges, models, *args, row_ops, **kw) -> dict:
        """bench.py's roofline field of a stage (`roofline.stage_roofline`,
        rows in 32-byte sectors), with the same bytes model under the TPU
        model's 128-lane padding beside it; `models`: that (sector, lane)
        pair.  Per-edge readings: above 100% of the peak where L2 serves
        repeated rows."""
        sector, lanes = (m(*args, **kw) for m in models)
        return {**roofline.stage_roofline(seconds, edges, sector, row_ops),
                "jax_padded_model_bytes_mb": round(lanes / 2**20, 1),
                "jax_padded_pct_hbm_peak": roofline.stage_roofline(
                    seconds, edges, lanes, row_ops)["pct_hbm_peak"]}

    # ---- 1. build ---------------------------------------------------------
    built = build_all()
    emit({"phase": "build", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "kernels": {n: {"nvcc_s": b.seconds, "lib": b.path.name,
                          "ptxas": [ln.strip() for ln in b.log.splitlines()
                                    if "registers" in ln or "spill" in ln]}
                      for n, b in built.items()}})

    def time_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def rel_err(got, ref) -> float:
        ref = ref.float()
        return ((got.float().to(ref.device) - ref).abs().max()
                / ref.abs().max().clamp_min(1e-30)).item()

    def exact_ref(x, *rest):
        """A kernel's arguments for its plain version, with the first (the
        rows, f32 or bf16) widened to f32: the same values, and the plain
        version then returns its f32 sum unrounded."""
        return (x.float(), *rest)

    def placed(n_rows, feat, dtype, aligned):
        """Random [n_rows, feat] rows of `dtype` on the card, 16-byte
        aligned or a view one element past an aligned address."""
        flat = torch.randn(n_rows * feat + 1, generator=gen).to(dev, dtype)
        return (flat[:-1] if aligned else flat[1:]).view(n_rows, feat)

    def row_tail_csr(v_src):
        """A CSR with 4 rows of each of ROW_LENGTHS edges and 60 of 2-199,
        in random order: (lengths, rowptr, col) on the card."""
        deg = torch.cat([torch.tensor(ROW_LENGTHS).repeat_interleave(4),
                         torch.randint(2, 200, (60,), generator=gen)])
        deg = deg[torch.randperm(deg.numel(), generator=gen)]
        rowptr_ = torch.zeros(deg.numel() + 1, dtype=torch.int64)
        rowptr_[1:] = deg.cumsum(0)
        col_ = torch.randint(0, v_src, (int(rowptr_[-1]),), generator=gen,
                             dtype=torch.int32)
        return deg.to(dev), rowptr_.to(dev), col_.to(dev)

    def k2_layout(x):
        lay = forward_layout(x)
        return lay, (f"{'vector' if lay['vec'] == 4 else 'scalar'} columns, "
                     + ("half-warps on alternate edges" if lay["lanes"] == 16
                        else "a whole warp"))

    def b2_layout(ht, gz, heads):
        lay = dst_layout(ht, gz, heads)
        return lay, (f"{'vector' if lay['vec'] == 4 else 'scalar'} columns, "
                     "one reduction per 4 edges (identity)")

    def resources(name, lay):
        """The kernel instance's registers and local (spill) bytes a
        thread, read from the loaded module in this run."""
        got = {"registers": lay["registers"],
               "local_bytes": lay["local_bytes"]}
        require(got["registers"] > 0, f"{name}: no register count ({got})")
        return got

    # every kernel's launch counter: each main path starts from zeros
    counted = {"spmm_csr": spmm_csr_cuda,
               "gather_agg_fwd": k1.gather_agg_fwd_cuda,
               "gather_agg_bwd_dx": k1.gather_agg_bwd_dx_cuda,
               "gather_agg_bwd_dw": k1.gather_agg_bwd_dw_cuda,
               "block_transpose": k1.block_transpose_cuda,
               "gat_aggregate": gat_aggregate_cuda,
               "spmm_csr_bwd": spmm_csr_bwd_cuda,
               "gat_bwd_src": gat_bwd_src_cuda,
               "gat_bwd_dst": gat_bwd_dst_cuda,
               "probe_gather_sum": probe_k.gather_sum_cuda,
               "probe_shuffle": probe_k.shuffle_cuda,
               "probe_tile_spmm": probe_k.tile_spmm_cuda,
               "probe_gat_tile": probe_k.gat_tile_cuda}

    def reset_counts() -> None:
        for f in counted.values():
            f.launches = 0

    def counts() -> dict:
        return {n: f.launches for n, f in counted.items()}

    def load_script(stem: str):
        spec = importlib.util.spec_from_file_location(
            stem, pathlib.Path(__file__).resolve().parent / "scripts"
            / f"{stem}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def first_batch(trainer, omit_map=None):
        """The first TRAIN_BATCH train vertices of `trainer`, sampled on the
        card with a generator of their own (cache-omitting with
        `omit_map`): the trainer's draws stay untouched."""
        seeds = torch.zeros(trainer.seed_pad, dtype=torch.int32)
        seeds[:TRAIN_BATCH] = torch.from_numpy(trainer.train_nids[
            :TRAIN_BATCH].astype(np.int32))
        return device_sample_batch(
            torch.Generator(device=dev).manual_seed(1), seeds.to(dev),
            (torch.arange(trainer.seed_pad) < TRAIN_BATCH).to(dev),
            trainer.dev_indptr, trainer.dev_indices, trainer.dev_in_deg,
            trainer.dev_out_deg, trainer.dev_features, trainer.dev_labels,
            tuple(TRAIN_FANOUT), trainer.src_pads, trainer.weight_kind,
            degree_mode=trainer.dev_degree_mode, omit_map=omit_map)

    # ---- 2. kernel against its plain version -------------------------------
    gen = torch.Generator().manual_seed(0)
    checks = []
    for feat in (7, 41, 128, 256):
        for dt in (torch.float32, torch.bfloat16):
            v = 20000
            deg = (torch.rand(v, generator=gen) ** 4 * 120).long()
            deg[::13] = 0                 # zero-in-degree rows write zeros
            deg[:4] = 6000                # hub rows
            rowptr = torch.zeros(v + 1, dtype=torch.int64)
            rowptr[1:] = deg.cumsum(0)
            e = int(rowptr[-1])
            col = torch.randint(0, v, (e,), generator=gen, dtype=torch.int32)
            w = torch.randn(e, generator=gen)
            x = torch.randn(v, feat, generator=gen).to(dt)
            args = [t.to(dev) for t in (x, rowptr, col, w)]
            out = spmm_csr_cuda(*args)
            again = spmm_csr_cuda(*args)
            torch.cuda.synchronize()
            ref = spmm_csr_plain(*exact_ref(*args))
            err = rel_err(out, ref)
            key = str(dt).removeprefix("torch.")
            checks.append({"F": feat, "dtype": key, "E": e, "rel_err": err,
                           "tol": TOL[key]})
            require(err <= TOL[key], f"kernel vs plain F={feat} {key}: "
                                     f"{err} > {TOL[key]}")
            require(bool((out[::13][1:] == 0).all()),
                    "zero-in-degree rows are not zero")
            require(torch.equal(out, again), "kernel is not deterministic")

    # the row kernel (every row fits a warp) in each of its layouts, on
    # rows of every length in ROW_LENGTHS
    row_checks = []
    deg, r_rowptr, r_col = row_tail_csr(1500)
    r_w = torch.randn(r_col.numel(), generator=gen).to(dev)
    for feat in K2_ROW_FEATS:
        for dt in (torch.float32, torch.bfloat16):
            for aligned in (True, False):
                x = placed(1500, feat, dt, aligned)
                out = spmm_csr_cuda(x, r_rowptr, r_col, r_w)
                again = spmm_csr_cuda(x, r_rowptr, r_col, r_w)
                torch.cuda.synchronize()
                err = rel_err(out, spmm_csr_plain(x.float(), r_rowptr, r_col,
                                                  r_w))
                key = str(dt).removeprefix("torch.")
                lay, how = k2_layout(x)
                row_checks.append({"F": feat, "dtype": key,
                                   "aligned": aligned, "layout": how,
                                   "rel_err": err, "tol": TOL[key]})
                require(err <= TOL[key], f"row kernel vs plain F={feat} {key} "
                                         f"({how}): {err} > {TOL[key]}")
                require(bool((out[deg == 0] == 0).all()),
                        f"row kernel F={feat} {key}: empty rows not zero")
                require(torch.equal(out, again),
                        f"row kernel F={feat} {key} ({how}) is not "
                        "deterministic")

    t0 = time.perf_counter()
    ds = reddit_like_dataset(seed=0, scale=1.0)
    adj = Adjacency.from_edges(ds.edges, ds.num_vertices)
    data_s = time.perf_counter() - t0
    v, e = adj.num_vertices, adj.num_edges
    params = init_model(0, "gcn", [602, 128, 41], device=dev)
    srv = InferenceServer(params, "gcn", adj, ds.features, device=dev)
    rowptr, col, w = srv.csr
    lib_csr = torch.sparse_csr_tensor(rowptr, col.long(), w, size=(v, v))
    timings = []
    for feat in (128, 41):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(v, feat, generator=gen).to(dev, dt)
            b = x.element_size()
            out = spmm_csr_cuda(x, rowptr, col, w)
            again = spmm_csr_cuda(x, rowptr, col, w)
            ref = spmm_csr_plain(x.float(), rowptr, col, w)
            err_abs = (out.float() - ref.float()).abs().max().item()
            err = rel_err(out, ref)
            key = str(dt).removeprefix("torch.")
            require(err <= TOL[key], f"kernel vs plain at the serving shape "
                                     f"F={feat} {key}: {err} > {TOL[key]}")
            require(torch.equal(out, again), "kernel at the serving shape "
                                             f"F={feat} {key} is not "
                                             "deterministic")
            lay, how = k2_layout(x)
            del ref
            ms = time_ms(lambda: spmm_csr_cuda(x, rowptr, col, w), 20)
            plain_ms = time_ms(lambda: spmm_csr_plain(x, rowptr, col, w), 3)
            # torch.sparse.mm needs values of x's dtype: in bf16 that would
            # round w, another function, so it is timed in f32 only
            library_ms = (time_ms(lambda: torch.sparse.mm(lib_csr, x), 20)
                          if dt == torch.float32 else None)
            k2_bound = bound("k2_fwd", b, V=v, E=e, F=feat)
            timings.append({
                "F": feat, "dtype": key, "V": v, "E": e, "layout": how,
                "registers": resources(f"spmm_csr F={feat} {key}", lay),
                "max_abs_err": err_abs, "rel_err": err, "tol": TOL[key],
                "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                **k2_bound,
                "pct_of_bound": 100.0 * k2_bound["bound_ms"] / ms})
    emit({"phase": "kernel", "checks": checks, "row_checks": row_checks,
          "reddit_shapes": timings,
          "hbm_bytes_per_s": hbm, "data_build_s": data_s})

    # ---- 3. K1 kernels against their plain versions -----------------------
    k1_fns = (k1.gather_agg_fwd_cuda, k1.gather_agg_bwd_dx_cuda,
              k1.gather_agg_bwd_dw_cuda)
    k1_checks = []
    d_chk, s_chk, hubs = 40001, 20000, (3, 777, 19999)  # D % 8 != 0
    for k in (1, 10, 25):
        nbr = torch.randint(0, s_chk, (d_chk, k), generator=gen,
                            dtype=torch.int32)
        flat = nbr.view(-1)
        for i, hub in enumerate(hubs):   # 10^4 slots into each hub source
            flat[i * 10000:(i + 1) * 10000] = hub
        w = torch.rand(d_chk, k, generator=gen)
        w[torch.rand(d_chk, k, generator=gen) < 0.3] = 0.0  # padded slots
        nbr, w = nbr.to(dev), w.to(dev)
        for feat in (7, 41, 128, 602):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(s_chk, feat, generator=gen).to(dev, dt)
                g = torch.randn(d_chk, feat, generator=gen).to(dev, dt)
                out = k1.gather_agg_fwd_cuda(x, nbr, w)
                again = k1.gather_agg_fwd_cuda(x, nbr, w)
                dx = k1.gather_agg_bwd_dx_cuda(g, nbr, w, x)
                dx_again = k1.gather_agg_bwd_dx_cuda(g, nbr, w, x)
                dw = k1.gather_agg_bwd_dw_cuda(g, x, nbr)
                dw_again = k1.gather_agg_bwd_dw_cuda(g, x, nbr)
                torch.cuda.synchronize()
                key = str(dt).removeprefix("torch.")
                errs = {
                    "fwd": rel_err(out, agg.gather_aggregate_plain(
                        x.float(), nbr, w)),
                    "dx": rel_err(dx, agg.gather_agg_bwd_dx_plain(
                        g, nbr, w, s_chk, torch.float32)),
                    "dw": rel_err(dw, agg.gather_agg_bwd_dw_plain(g, x, nbr))}
                k1_checks.append({"K": k, "F": feat, "dtype": key,
                                  "rel_err": errs, "tol": TOL[key],
                                  "dw_layout": k1.dw_layout(g, x, k)})
                for what, err in errs.items():
                    require(err <= TOL[key], f"K1 {what} vs plain K={k} "
                                             f"F={feat} {key}: {err}")
                require(torch.equal(out, again),
                        "K1 forward is not deterministic")
                require(torch.equal(dx, dx_again),
                        "K1 dx is not deterministic")
                require(torch.equal(dw, dw_again),
                        "K1 dw is not deterministic")

    # the full-width training shapes: the blocks of one device-sampled
    # GSSAMPLEALLGPU batch (its own generator: the trainer's draws in
    # phase 7 are untouched)
    dev_cfg = RunConfig(algorithm="GSSAMPLEALLGPU",
                        layer_sizes=TRAIN_LAYERS, fanout=TRAIN_FANOUT,
                        batch_size=TRAIN_BATCH, learn_rate=0.01,
                        drop_rate=0.5, epochs=1, seed=0,
                        vertices=ds.num_vertices)
    dev_trainer = build_trainer(dev_cfg, ds)
    sample = first_batch(dev_trainer)
    k1_shapes = []
    for layer, feat in ((0, TRAIN_LAYERS[1]), (1, TRAIN_LAYERS[2])):
        blk = sample.blocks[layer]
        nbr, w = blk.nbr, blk.weight
        d_, k_ = nbr.shape
        s_ = blk.num_src_pad
        x = torch.randn(s_, feat, generator=gen).to(dev)
        g = torch.randn(d_, feat, generator=gen).to(dev)
        nnz = int((w != 0).sum())
        rows = torch.arange(d_, device=dev).repeat_interleave(k_)
        fwd_csr = torch.sparse_csr_tensor(
            torch.arange(0, d_ * k_ + 1, k_, device=dev),
            nbr.reshape(-1).long(), w.reshape(-1), size=(d_, s_))
        bwd_csr = torch.sparse_coo_tensor(
            torch.stack([nbr.reshape(-1).long(), rows]), w.reshape(-1),
            size=(s_, d_)).coalesce().to_sparse_csr()
        pattern = torch.sparse_csr_tensor(
            fwd_csr.crow_indices(), fwd_csr.col_indices(),
            torch.zeros(d_ * k_, device=dev), size=(d_, s_))
        x_t = x.t().contiguous()

        def sddmm():
            return torch.sparse.sampled_addmm(pattern, g, x_t, beta=0.0)

        try:   # timed only; the port never calls it
            sddmm()
            dw_library = sddmm
        except RuntimeError:
            dw_library = None
        b = x.element_size()
        # dx's transpose: bit-identical to its plain version (torch ops);
        # reads nbr and w, writes rowptr_t, col_t and w_t once
        got = k1.block_transpose_cuda(nbr, w, s_)
        want = agg.block_transpose_plain(nbr, w, s_)
        require(all(torch.equal(a, b_) for a, b_ in zip(got, want)),
                f"block_transpose differs from plain at layer {layer}")
        k1_shapes.append({
            "name": "block_transpose", "layer": layer, "D": d_, "K": k_,
            "S": s_, "F": feat, "nnz": nnz, "dtype": "int32/float32",
            "max_abs_err": 0.0, "bit_identical": True,
            "ms": time_ms(lambda: k1.block_transpose_cuda(nbr, w, s_), 20),
            "plain_ms": time_ms(
                lambda: agg.block_transpose_plain(nbr, w, s_), 3),
            "library_ms": None, **bound("k1_transpose", D=d_, K=k_, S=s_)})
        del got, want
        for kname, fn, plain, lib, work in (
                ("gather_agg_fwd", lambda: k1.gather_agg_fwd_cuda(x, nbr, w),
                 lambda: agg.gather_aggregate_plain(x, nbr, w),
                 lambda: torch.sparse.mm(fwd_csr, x), "k1_fwd"),
                ("gather_agg_bwd_dx",
                 lambda: k1.gather_agg_bwd_dx_cuda(g, nbr, w, x),
                 lambda: agg.gather_agg_bwd_dx_plain(g, nbr, w, s_, x.dtype),
                 lambda: torch.sparse.mm(bwd_csr, g), "k1_dx"),
                ("gather_agg_bwd_dw",
                 lambda: k1.gather_agg_bwd_dw_cuda(g, x, nbr),
                 lambda: agg.gather_agg_bwd_dw_plain(g, x, nbr),
                 dw_library, "k1_dw")):
            got, ref = fn(), plain()
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            require(err <= TOL["float32"], f"K1 {kname} vs plain at the "
                                           f"training shape layer {layer}: "
                                           f"{err}")
            k1_bound = bound(work, b, D=d_, K=k_, S=s_, F=feat, nnz=nnz)
            ms = time_ms(fn, 20)
            k1_shapes.append({
                "name": kname, "layer": layer, "D": d_, "K": k_, "S": s_,
                "F": feat, "nnz": nnz, "dtype": "float32",
                "max_abs_err": (got.float() - ref.float()).abs().max().item(),
                "rel_err": err, "tol": TOL["float32"],
                "ms": ms, "plain_ms": time_ms(plain, 3),
                "library_ms": time_ms(lib, 20) if lib is not None else None,
                **k1_bound,
                "pct_of_bound": 100.0 * k1_bound["bound_ms"] / ms,
                **({"layout": k1.dw_layout(g, x, k_)}
                   if kname == "gather_agg_bwd_dw" else {})})
            del got, ref
    del sample, fwd_csr, bwd_csr, pattern
    emit({"phase": "kernel_k1", "checks": k1_checks,
          "training_shapes": k1_shapes})

    # ---- 4. K3 against its plain version -----------------------------------
    def k3_tables(ht, ht_dst, heads, score_std):
        """Score tables from random attention vectors whose scores have
        spread `score_std` on unit-variance rows."""
        feat = ht.shape[1]
        a = torch.randn(2, feat, generator=gen) * (
            score_std / (feat // heads) ** 0.5)
        a = a.to(ht.device)
        ts, _ = pack_score_tables(ht, a[0], a[1], heads)
        _, td = pack_score_tables(ht_dst, a[0], a[1], heads)
        return ts, td

    k3_checks = []
    for heads, feat in K3_GRID:
        for dt in (torch.float32, torch.bfloat16):
            n_dst = 20000
            # one case gathers from a source set other than the rows
            n_src = 15000 if (heads, feat) == (4, 128) else n_dst
            deg = (torch.rand(n_dst, generator=gen) ** 4 * 120).long()
            deg[::13] = 0                 # rows with no edges write zeros
            deg[:4] = 6000                # hub rows
            k_rowptr = torch.zeros(n_dst + 1, dtype=torch.int64)
            k_rowptr[1:] = deg.cumsum(0)
            n_e = int(k_rowptr[-1])
            k_col = torch.randint(0, n_src, (n_e,), generator=gen,
                                  dtype=torch.int32)
            ht = torch.randn(n_src, feat, generator=gen).to(dev, dt)
            ts, td = k3_tables(ht, torch.randn(n_dst, feat, generator=gen)
                               .to(dev, dt), heads, K3_SCORE_STD)
            ts[::K3_CLIP_EVERY] += K3_CLIP_RAISE
            k_rowptr, k_col = k_rowptr.to(dev), k_col.to(dev)
            raw = (ts.index_select(0, k_col) + td.repeat_interleave(
                k_rowptr.diff(), dim=0))
            clipped = float(((raw > ATT_CLIP)
                             | (NEG_SLOPE * raw < -ATT_CLIP)).float().mean())
            k3 = (ht, ts, td, k_rowptr, k_col, heads)
            h, z = gat_aggregate_cuda(*k3)
            h2, z2 = gat_aggregate_cuda(*k3)
            torch.cuda.synchronize()
            ref_h, ref_z = gat_aggregate_plain(*exact_ref(*k3))
            key = str(dt).removeprefix("torch.")
            # z elementwise: clipped rows' z reach 1e29, so a max-relative
            # error would see nothing in the other rows
            err = rel_err(h, ref_h)
            zerr = ((z - ref_z).abs() / ref_z.abs().clamp_min(F32_TINY)
                    ).max().item()
            k3_checks.append({"H": heads, "F": feat, "dtype": key,
                              "columns": ("vector" if vector_columns(
                                  ht, heads) else "scalar"),
                              "S": n_src, "D": n_dst, "E": n_e,
                              "clipped_share": clipped, "rel_err": err,
                              "z_rel_err": zerr, "tol": TOL[key]})
            require(clipped > 0, f"K3 H={heads} F={feat}: no score clipped")
            require(err <= TOL[key] and zerr <= TOL["float32"],
                    f"K3 vs plain H={heads} F={feat} {key}: {err}, z {zerr}")
            require(bool((h[::13][1:] == 0).all())
                    and bool((z[::13][1:] == 0).all()),
                    "K3: rows with no edges are not zero")
            require(torch.equal(h, h2) and torch.equal(z, z2),
                    "K3 is not deterministic")
            del raw, ref_h, ref_z

    # the serving shapes: the whole Reddit-shaped graph's CSR, H=1 and 4
    g_rowptr, g_col = srv.csr.rowptr, srv.csr.col
    g_col64 = g_col.long()
    rows_e = torch.repeat_interleave(torch.arange(v, device=dev),
                                     g_rowptr.diff())

    def k3_composition(ht, ts, td):
        """K3's function in torch ops (H=1): the scores, u, one
        torch.sparse.mm over a CSR whose values are u, z by index_add_,
        the divide.  Timed as a yardstick only; the port never calls it."""
        s = ts[:, 0].index_select(0, g_col) + td[:, 0].index_select(0, rows_e)
        u = torch.exp(torch.where(s >= 0, s, NEG_SLOPE * s).clamp(
            -ATT_CLIP, ATT_CLIP))
        out = torch.sparse.mm(torch.sparse_csr_tensor(
            g_rowptr, g_col64, u, size=(v, v)), ht)
        z = torch.zeros(v, device=dev).index_add_(0, rows_e, u)
        return out / z.clamp_min(F32_TINY)[:, None]

    k3_shapes = []
    for feat, heads in ((128, 1), (128, 4), (41, 1)):
        for dt in (torch.float32, torch.bfloat16):
            ht = torch.randn(v, feat, generator=gen).to(dev, dt)
            ts, td = k3_tables(ht, ht, heads, 2.0)
            got, _ = gat_aggregate_cuda(ht, ts, td, g_rowptr, g_col, heads)
            ref, _ = gat_aggregate_plain(ht.float(), ts, td, g_rowptr, g_col,
                                         heads)
            torch.cuda.synchronize()
            key = str(dt).removeprefix("torch.")
            err = rel_err(got, ref)
            require(err <= TOL[key], f"K3 vs plain at the serving shape "
                                     f"F={feat} H={heads} {key}: {err}")
            comp_ms = comp_err = None
            if heads == 1 and dt == torch.float32:
                comp_err = rel_err(k3_composition(ht, ts, td), ref)
                require(comp_err <= TOL[key], "the composition does not "
                                              f"compute K3: {comp_err}")
                comp_ms = time_ms(lambda: k3_composition(ht, ts, td), 10)
            k3_shapes.append({
                "F": feat, "H": heads, "dtype": key, "V": v, "E": e,
                "columns": ("vector" if vector_columns(ht, heads)
                            else "scalar"),
                "max_abs_err": (got.float() - ref.float()).abs().max().item(),
                "rel_err": err, "tol": TOL[key],
                "ms": time_ms(lambda: gat_aggregate_cuda(
                    ht, ts, td, g_rowptr, g_col, heads), 20),
                "plain_ms": time_ms(lambda: gat_aggregate_plain(
                    ht, ts, td, g_rowptr, g_col, heads), 3),
                "library_ms": None, "composition_ms": comp_ms,
                "composition_rel_err": comp_err,
                **bound("k3", ht.element_size(), V=v, E=e, F=feat,
                        H=heads)})
            del got, ref
    emit({"phase": "kernel_k3", "checks": k3_checks,
          "serving_shapes": k3_shapes,
          "library": "none: no single PyTorch call computes K3; "
                     "composition_ms times scores + torch.sparse.mm + z "
                     "(H=1, f32) as a yardstick"})

    # ---- 5. serving at full width (main path, counted) ----------------------
    reset_counts()
    pass_s = []
    for _ in range(4):
        before = spmm_csr_cuda.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logp = srv.logprobs(as_numpy=False)
        torch.cuda.synchronize()
        pass_s.append(time.perf_counter() - t0)
        require(spmm_csr_cuda.launches - before == 2,
                "logprobs() did not launch the kernel twice")
    full = logp.cpu().numpy()
    require(full.shape == (v, 41) and bool(np.isfinite(full).all()),
            f"log-probs shape {full.shape} or non-finite values")
    t0 = time.perf_counter()
    cpu = InferenceServer(params.to("cpu"), "gcn", adj, ds.features,
                          device="cpu").logprobs()
    cpu_s = time.perf_counter() - t0
    cpu_err = float(np.abs(full - cpu).max())
    require(cpu_err <= SERVE_ATOL, f"card vs CPU pass: {cpu_err}")
    bsrv = InferenceServer(params, "gcn", adj, ds.features,
                           dtype=torch.bfloat16, device=dev)
    bpass_s = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blogp = bsrv.logprobs(as_numpy=False)
        torch.cuda.synchronize()
        bpass_s.append(time.perf_counter() - t0)
    bfull = blogp.cpu().numpy()
    require(bfull.shape == full.shape and bool(np.isfinite(bfull).all()),
            f"bf16 log-probs shape {bfull.shape} or non-finite values")
    bf16_err = float(np.abs(bfull - full).max())
    require(bf16_err <= BF16_SERVE_ATOL,
            f"bf16 vs f32 pass: {bf16_err} > {BF16_SERVE_ATOL}")
    agree = float(np.mean(bfull.argmax(1) == full.argmax(1)))
    del bsrv, blogp
    serving_pass_ms = statistics.median(pass_s[1:]) * 1e3
    # bench.py:577-584's reading of a pass: two SpMM layers over E edges
    serve_roofline = {
        key: stage_reading(statistics.median(times[1:]), 2 * e, spmm_models,
                           e, v, TRAIN_LAYERS[1:], b, row_ops=2.0)
        for key, times, b in (("f32", pass_s, 4), ("bf16", bpass_s, 2))}
    emit({"phase": "serving", "model": "gcn 602-128-41",
          "graph": {"V": v, "E": e}, "f32_pass_ms": pass_s[0] * 1e3,
          "f32_pass_ms_median_last3": statistics.median(pass_s[1:]) * 1e3,
          "bf16_pass_ms_median_last3": statistics.median(bpass_s[1:]) * 1e3,
          "launches_per_pass": 2, "cpu_pass_max_abs_diff": cpu_err,
          "tol": SERVE_ATOL, "host_cpu_pass_s": cpu_s,
          "bf16_vs_f32_max_abs_diff": bf16_err, "bf16_tol": BF16_SERVE_ATOL,
          "bf16_argmax_agreement": agree, "roofline": serve_roofline})

    # ---- 6. per-request queries (main path, counted) ------------------------
    rng = np.random.default_rng(0)
    lat = {}
    q_err = 0.0
    for size in (8, 64, 512):
        lat[size] = []
        for _ in range(5):
            nids = rng.choice(v, size=size, replace=False)
            before = spmm_csr_cuda.launches
            t0 = time.perf_counter()
            got = srv.query(nids)
            lat[size].append(time.perf_counter() - t0)
            require(spmm_csr_cuda.launches - before == 2,
                    "query() did not launch the kernel twice")
            q_err = max(q_err, float(np.abs(got - full[nids]).max()))
    require(q_err <= SERVE_ATOL, f"query vs whole-graph rows: {q_err}")
    sampled = srv.query(rng.choice(v, size=512, replace=False),
                        fanout=[25, 10], seed=1)
    require(sampled.shape == (512, 41) and bool(np.isfinite(sampled).all()),
            "fanout query shape or values")
    serve_counts = counts()
    launches = serve_counts.pop("spmm_csr")
    require(launches > 0, "the main path never launched spmm_csr")
    require(not any(serve_counts.values()),
            f"GCN serving launched other kernels: {serve_counts}")
    emit({"phase": "queries", "max_abs_diff": q_err, "tol": SERVE_ATOL,
          "p50_ms": {str(s): statistics.median(t) * 1e3
                     for s, t in lat.items()}})
    gcn_full, f32_feature_bytes = full, srv.feature_bytes
    del srv, logp

    # ---- 7. GAT serving at full width (main path, counted) -----------------
    gat_params = init_model(0, "gat", TRAIN_LAYERS, device=dev)
    attn_gen = torch.Generator().manual_seed(2)
    gat_params = gat_params._replace(attn=tuple(
        (torch.randn(a.shape, generator=attn_gen) * GAT_ATTN_SCALE).to(dev)
        for a in gat_params.attn))
    reset_counts()
    gat_serving, gat_fulls, gat_pass_ms = [], {}, {}
    for heads in GAT_SERVE_HEADS:
        gsrv = InferenceServer(gat_params, "gat", adj, ds.features,
                               heads=heads, device=dev)
        pass_s = []
        for _ in range(4):
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logp = gsrv.logprobs(as_numpy=False)
            torch.cuda.synchronize()
            pass_s.append(time.perf_counter() - t0)
            now = counts()
            require(now["gat_aggregate"] - before["gat_aggregate"] == 2
                    and now["spmm_csr"] == before["spmm_csr"],
                    f"GAT logprobs() launched {now} after {before}: "
                    "expected 2 K3 and no SpMM")
        full = gat_fulls[heads] = logp.cpu().numpy()
        require(full.shape == (v, 41) and bool(np.isfinite(full).all()),
                f"GAT log-probs shape {full.shape} or non-finite values")
        t0 = time.perf_counter()
        cpu = InferenceServer(gat_params.to("cpu"), "gat", adj, ds.features,
                              heads=heads, device="cpu").logprobs()
        cpu_s = time.perf_counter() - t0
        cpu_err = float(np.abs(full - cpu).max())
        require(cpu_err <= SERVE_ATOL,
                f"GAT heads {heads} card vs CPU pass: {cpu_err}")
        bsrv = InferenceServer(gat_params, "gat", adj, ds.features,
                               heads=heads, dtype=torch.bfloat16, device=dev)
        bpass_s = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blogp = bsrv.logprobs(as_numpy=False)
            torch.cuda.synchronize()
            bpass_s.append(time.perf_counter() - t0)
        bfull = blogp.cpu().numpy()
        require(bfull.shape == full.shape and bool(np.isfinite(bfull).all()),
                f"GAT bf16 log-probs shape {bfull.shape} or non-finite")
        bf16_err = float(np.abs(bfull - full).max())
        require(bf16_err <= BF16_SERVE_ATOL,
                f"GAT bf16 vs f32 pass: {bf16_err} > {BF16_SERVE_ATOL}")
        del bsrv, blogp
        lat, q_err = {}, 0.0
        for size in (8, 64, 512):
            lat[size] = []
            for _ in range(5):
                nids = rng.choice(v, size=size, replace=False)
                before = counts()["gat_aggregate"]
                t0 = time.perf_counter()
                got = gsrv.query(nids)
                lat[size].append(time.perf_counter() - t0)
                require(counts()["gat_aggregate"] - before == 2,
                        "GAT query() did not launch K3 twice")
                q_err = max(q_err, float(np.abs(got - full[nids]).max()))
        require(q_err <= SERVE_ATOL, f"GAT query vs whole-graph rows: {q_err}")
        sampled = gsrv.query(rng.choice(v, size=512, replace=False),
                             fanout=[25, 10], seed=1)
        require(sampled.shape == (512, 41)
                and bool(np.isfinite(sampled).all()),
                "GAT fanout query shape or values")
        gat_pass_ms[heads] = statistics.median(pass_s[1:]) * 1e3
        gat_serving.append({
            "heads": heads, "f32_pass_ms": pass_s[0] * 1e3,
            "f32_pass_ms_median_last3": statistics.median(pass_s[1:]) * 1e3,
            "bf16_pass_ms_median_last3": statistics.median(bpass_s[1:]) * 1e3,
            "cpu_pass_max_abs_diff": cpu_err, "host_cpu_pass_s": cpu_s,
            "bf16_vs_f32_max_abs_diff": bf16_err,
            "bf16_argmax_agreement": float(np.mean(
                bfull.argmax(1) == full.argmax(1))),
            "query_max_abs_diff": q_err,
            "query_p50_ms": {str(s): statistics.median(t) * 1e3
                             for s, t in lat.items()}})
        del gsrv, logp
    gat_counts = counts()
    gat_launches = gat_counts.pop("gat_aggregate")
    require(gat_launches > 0, "the main path never launched gat_aggregate")
    require(not any(gat_counts.values()),
            f"GAT serving launched other kernels: {gat_counts}")
    emit({"phase": "serving_gat", "model": "gat 602-128-41",
          "graph": {"V": v, "E": e}, "tol": SERVE_ATOL,
          "bf16_tol": BF16_SERVE_ATOL, "launches_per_pass": 2,
          "k3_launches": gat_launches, "by_heads": gat_serving})

    # ---- 8. host-sampled training (main path, counted) ---------------------
    host_cfg = RunConfig(algorithm="GCNSAMPLEGPU", layer_sizes=TRAIN_LAYERS,
                         fanout=TRAIN_FANOUT, batch_size=TRAIN_BATCH,
                         learn_rate=0.01, drop_rate=0.5, epochs=1, seed=0,
                         vertices=ds.num_vertices)
    host_trainer = build_trainer(host_cfg, ds)
    order = host_trainer._epoch_order(host_trainer.train_nids)
    item = host_trainer._make_batch(order[:TRAIN_BATCH])
    card_batch, _ = host_trainer._upload(item)
    cpu_batch = host_batch_to_device(
        item.hb, *item.hb.payload(ds.features, ds.labels), device="cpu")
    card = loss_and_grads(host_trainer.params, "gcn", card_batch)
    t0 = time.perf_counter()
    cpu = loss_and_grads(host_trainer.params.to("cpu"), "gcn", cpu_batch)
    cpu_step_s = time.perf_counter() - t0
    loss_diff = abs(card.loss.item() - cpu.loss.item())
    require(loss_diff <= TRAIN_LOSS_ATOL, f"card vs CPU loss: {loss_diff}")
    grad_errs = [rel_err(a, b) for a, b in zip(card.grads, cpu.grads)]
    require(max(grad_errs) <= TRAIN_GRAD_RTOL,
            f"card vs CPU gradients: {grad_errs}")
    del card, cpu, cpu_batch, card_batch
    reset_counts()
    host_steps = []
    for i in range(1, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        item = host_trainer._make_batch(order[i * TRAIN_BATCH:
                                              (i + 1) * TRAIN_BATCH])
        t1 = time.perf_counter()
        batch, nedges = host_trainer._upload(item)
        loss, _ = host_trainer.train_step(batch)
        loss = loss.item()   # syncs
        t2 = time.perf_counter()
        require(np.isfinite(loss), f"host-sampled step loss {loss}")
        host_steps.append({"sample_ms": (t1 - t0) * 1e3,
                           "upload_train_ms": (t2 - t1) * 1e3,
                           "edges": nedges, "loss": loss,
                           "edges_per_s": nedges / (t2 - t0)})
    host_launches = [f.launches for f in k1_fns]
    require(host_launches == [6, 6, 0] and spmm_csr_cuda.launches == 0
            and k1.block_transpose_cuda.launches == 6
            and gat_aggregate_cuda.launches == 0,
            f"host-sampled steps launched {counts()}, expected 2 K1 "
            "forward + 2 dx per step")
    emit({"phase": "train_host", "engine": "GCNSAMPLEGPU",
          "model": "gcn 602-128-41", "fanout": TRAIN_FANOUT,
          "batch": TRAIN_BATCH, "first_batch_loss_abs_diff": loss_diff,
          "loss_atol": TRAIN_LOSS_ATOL, "grad_rel_err": grad_errs,
          "grad_rtol": TRAIN_GRAD_RTOL, "host_cpu_loss_and_grads_s":
          cpu_step_s, "steps": host_steps,
          "k1_launches": dict(zip(("fwd", "dx", "dw"), host_launches))})
    del host_trainer, batch

    # ---- 9. device-sampled training (main path, counted) -------------------
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr_loss, tr_acc, edges = dev_trainer.train_epoch()
    epoch_s = time.perf_counter() - t0
    train_launches = [f.launches for f in k1_fns]
    val_acc = dev_trainer.evaluate(dev_trainer.val_nids)
    dev_launches = [f.launches for f in k1_fns]
    steps = len(dev_trainer.step_ms)
    eval_batches = -(-dev_trainer.val_nids.size // TRAIN_BATCH)
    losses = dev_trainer.step_losses
    require(all(np.isfinite(losses)) and np.isfinite(tr_loss),
            f"non-finite training loss: {losses}")
    require(steps == 16, f"{steps} steps in the epoch, expected 16")
    require(float(np.mean(losses[-4:])) < losses[0],
            f"loss did not fall: first {losses[0]}, last 4 {losses[-4:]}")
    require(train_launches == [2 * steps, 2 * steps, 0],
            f"training epoch launched K1 {train_launches}")
    require(dev_launches == [2 * steps + 2 * eval_batches, 2 * steps, 0]
            and k1.block_transpose_cuda.launches == 2 * steps
            and spmm_csr_cuda.launches == 0
            and gat_aggregate_cuda.launches == 0,
            f"epoch + evaluate launched {counts()}")
    transpose_launches = k1.block_transpose_cuda.launches
    med_step_ms = f32_step_ms = statistics.median(dev_trainer.step_ms[1:])
    e_bot = int(edges * TRAIN_FANOUT[0] / sum(TRAIN_FANOUT))
    dev_edges_per_s = edges / steps / (med_step_ms / 1e3)
    f32_train_feature_bytes = (dev_trainer.dev_features.numel()
                               * dev_trainer.dev_features.element_size())
    emit({"phase": "train_device", "engine": "GSSAMPLEALLGPU",
          "model": "sage 602-128-41", "fanout": TRAIN_FANOUT,
          "batch": TRAIN_BATCH, "src_pads": list(dev_trainer.src_pads),
          "steps": steps, "step_ms": dev_trainer.step_ms,
          "step_ms_median_after_first": med_step_ms,
          "epoch_s": epoch_s, "edges_per_epoch": edges,
          "sampled_edges_per_s_epoch": edges / epoch_s,
          "sampled_edges_per_s_steady": dev_edges_per_s,
          "overflow": dev_trainer.last_overflow, "losses": losses,
          "train_acc": tr_acc, "val_acc": val_acc,
          "eval_batches": eval_batches,
          "k1_launches": dict(zip(("fwd", "dx", "dw"), dev_launches)),
          "transpose_launches": transpose_launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          # bench.py:143-156's reading of the epoch: the fanout's split of
          # its edges between the bottom (602-wide rows) and the top hop
          "roofline": stage_reading(
              epoch_s, edges, sampled_models,
              [e_bot, edges - e_bot], TRAIN_LAYERS[0], TRAIN_LAYERS[1],
              dtype_bytes=4, row_ops=2.0)})
    del dev_trainer

    # ---- 10. device-sampled GAT training (main path, counted) --------------
    gat_cfg = RunConfig(algorithm="GATSAMPLEALLGPU", layer_sizes=TRAIN_LAYERS,
                        fanout=TRAIN_FANOUT, batch_size=TRAIN_BATCH,
                        learn_rate=0.01, drop_rate=0.5, epochs=1, seed=0,
                        heads=GAT_TRAIN_HEADS, vertices=ds.num_vertices)
    gat_trainer = build_trainer(gat_cfg, ds)
    require(gat_trainer.family == "gat"
            and gat_trainer.weight_kind == WeightKind.NONE
            and gat_trainer.optimizer.bias_correction,
            "GATSAMPLEALLGPU did not build the GAT device trainer")
    # the first batch at drop 0, card against CPU, with seeded nonzero
    # attention vectors (the trainer's own start at zeros, uniform
    # attention, which would leave the scores untested).  The CPU runs its
    # torch ops in f64, the reference: the card's f32 kernels and the CPU's
    # f32 torch ops sum in other orders, and on this draw a1's gradient,
    # a small sum of cancelling terms, differs between them by 3.4e-4 of
    # its largest entry: the card's lies within 9e-6 of f64, the CPU's f32
    # 3.4e-4 off (PERF.md); both f32 readings are kept
    check_params = gat_trainer.params._replace(attn=tuple(
        (torch.randn(a.shape, generator=attn_gen) * GAT_ATTN_SCALE).to(dev)
        for a in gat_trainer.params.attn))
    batch = first_batch(gat_trainer)
    card = loss_and_grads(check_params, "gat", batch, heads=GAT_TRAIN_HEADS)
    t0 = time.perf_counter()
    cpu = loss_and_grads(check_params.to("cpu"), "gat",
                         batch_to(batch, "cpu"), heads=GAT_TRAIN_HEADS)
    cpu_step_s = time.perf_counter() - t0
    ref = loss_and_grads(
        check_params.to("cpu", torch.float64), "gat",
        dataclasses.replace(batch_to(batch, "cpu"),
                            x0=batch.x0.cpu().double()),
        heads=GAT_TRAIN_HEADS)
    loss_diff = abs(card.loss.item() - ref.loss.item())
    require(loss_diff <= TRAIN_LOSS_ATOL,
            f"GAT card vs CPU f64 loss: {loss_diff}")
    grad_errs = [rel_err(a, b) for a, b in zip(card.grads, ref.grads)]
    require(len(grad_errs) == 4 and max(grad_errs) <= TRAIN_GRAD_RTOL,
            f"GAT card vs CPU f64 gradients (W0, W1, a0, a1): {grad_errs}")
    cpu_f32_errs = {
        "cpu_f32_vs_f64": [rel_err(a, b) for a, b in zip(cpu.grads,
                                                         ref.grads)],
        "card_vs_cpu_f32": [rel_err(a, b) for a, b in zip(card.grads,
                                                          cpu.grads)]}
    first_loss = card.loss.item()
    del card, cpu, ref, batch
    reset_counts()
    gsk.gat_sampled_fwd_cuda.launches = gsk.gat_sampled_bwd_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr_loss, tr_acc, edges = gat_trainer.train_epoch()
    epoch_s = time.perf_counter() - t0
    val_acc = gat_trainer.evaluate(gat_trainer.val_nids)
    gat_train_counts = counts()
    gat_evals = -(-gat_trainer.val_nids.size // TRAIN_BATCH)
    # one forward launch a layer: the layers are the forward's launches
    gat_sampled_launches = {
        "fwd": gsk.gat_sampled_fwd_cuda.launches,
        "bwd": gsk.gat_sampled_bwd_cuda.launches,
        "layers": gsk.gat_sampled_fwd_cuda.launches}
    steps = len(gat_trainer.step_ms)
    losses = gat_trainer.step_losses
    require(all(np.isfinite(losses)) and np.isfinite(tr_loss),
            f"non-finite GAT training loss: {losses}")
    require(steps == 16, f"{steps} GAT steps in the epoch, expected 16")
    require(float(np.mean(losses[-4:])) < losses[0],
            f"GAT loss did not fall: first {losses[0]}, last 4 {losses[-4:]}")
    require(not any(gat_train_counts.values()),
            f"sampled GAT launched K1-K4: {gat_train_counts}")
    steps_evals = 2 * (len(gat_trainer.step_ms) + gat_evals)
    require(gat_sampled_launches == {"fwd": steps_evals,
                                     "bwd": 2 * len(gat_trainer.step_ms),
                                     "layers": steps_evals},
            f"sampled GAT kernel launches: {gat_sampled_launches}")
    med_step_ms = statistics.median(gat_trainer.step_ms[1:])
    emit({"phase": "train_gat", "engine": "GATSAMPLEALLGPU",
          "model": "gat 602-128-41", "heads": GAT_TRAIN_HEADS,
          "fanout": TRAIN_FANOUT, "batch": TRAIN_BATCH,
          "src_pads": list(gat_trainer.src_pads),
          "first_batch_loss": first_loss,
          "first_batch_loss_abs_diff": loss_diff, "loss_atol": TRAIN_LOSS_ATOL,
          "grad_rel_err": grad_errs, "grad_rtol": TRAIN_GRAD_RTOL,
          "grad_rel_err_f32": cpu_f32_errs,
          "host_cpu_loss_and_grads_s": cpu_step_s,
          "steps": steps, "step_ms": gat_trainer.step_ms,
          "step_ms_median_after_first": med_step_ms,
          "epoch_s": epoch_s, "edges_per_epoch": edges,
          "sampled_edges_per_s_epoch": edges / epoch_s,
          "sampled_edges_per_s_steady": edges / steps / (med_step_ms / 1e3),
          "overflow": gat_trainer.last_overflow, "losses": losses,
          "train_acc": tr_acc, "val_acc": val_acc,
          "launches": gat_train_counts,
          "gat_sampled_launches": gat_sampled_launches,
          "eval_batches": gat_evals,
          "peak_mem_gb_epoch": torch.cuda.max_memory_allocated() / 1e9})
    del gat_trainer

    # ---- 10b. the sampled GAT kernels at the training shapes ---------------
    gat_sampled = load_script("torch_gat_sampled").measure(dev, ds)
    for row in gat_sampled["layers"]:
        require(max(row["rel_err"].values()) <= 1e-5
                and row["repeat_bit_identical"],
                f"sampled GAT kernels, layer {row['layer']}: "
                f"{row['rel_err']}, repeat {row['repeat_bit_identical']}")
    emit({"phase": "kernel_gat_sampled", **gat_sampled})

    # ---- 10c. the sampled GAT kernels at gat_products' shapes -------------
    gat_products = load_script("torch_gat_sampled").measure_products(dev)
    for row in gat_products["layers"]:
        require(max(row["rel_err"].values()) <= 1e-5
                and row["repeat_bit_identical"]
                and row["launches"] == {"fwd": 1, "bwd": 1},
                f"sampled GAT kernels at gat_products' layer {row['layer']}: "
                f"{row['rel_err']}, repeat {row['repeat_bit_identical']}, "
                f"launches {row['launches']}")
    emit({"phase": "kernel_gat_sampled_products", **gat_products})

    # ---- 11. K2's backward against its plain version -----------------------
    def skewed_rows(n_rows, n_src, no_out_every):
        """A skewed CSR (hub rows, every 13th row without edges) whose
        sources `no_out_every` apart have no out-edges, and whose source 5
        takes every 80th edge: a hub row of the transposed CSR, longer than
        LONG_ROW_EDGES and many of the CSR sum's chunks."""
        deg = (torch.rand(n_rows, generator=gen) ** 4 * 120).long()
        deg[::13] = 0
        deg[:4] = 6000
        rowptr_ = torch.zeros(n_rows + 1, dtype=torch.int64)
        rowptr_[1:] = deg.cumsum(0)
        col_ = torch.randint(0, n_src, (int(rowptr_[-1]),), generator=gen,
                             dtype=torch.int32)
        col_ = torch.where(col_ % no_out_every == 3, col_ - 1, col_)
        col_[::80] = 5
        return rowptr_, col_

    def transposed(rowptr_, col_, w_, n_src):
        return [torch.from_numpy(a).to(dev) for a in csr_transpose(
            rowptr_.cpu().numpy(), col_.cpu().numpy(), w_.cpu().numpy(),
            n_src)]

    k2b_checks = []
    for feat in (7, 41, 128, 256):
        for dt in (torch.float32, torch.bfloat16):
            n_rows = n_src = 20000
            rowptr_, col_ = skewed_rows(n_rows, n_src, 11)
            w_ = torch.randn(col_.numel(), generator=gen)
            csr_t = transposed(rowptr_, col_, w_, n_src)
            g = torch.randn(n_rows, feat, generator=gen).to(dev, dt)
            out = spmm_csr_bwd_cuda(g, *csr_t)
            again = spmm_csr_bwd_cuda(g, *csr_t)
            torch.cuda.synchronize()
            err = rel_err(out, spmm_csr_plain(*exact_ref(g, *csr_t)))
            key = str(dt).removeprefix("torch.")
            k2b_checks.append({"F": feat, "dtype": key,
                               "E": col_.numel(), "rel_err": err,
                               "tol": TOL[key]})
            require(err <= TOL[key], f"K2 bwd vs plain F={feat} {key}: "
                                     f"{err} > {TOL[key]}")
            require(bool((out[3::11] == 0).all()),
                    "K2 bwd: sources with no out-edges are not zero")
            require(torch.equal(out, again), "K2 bwd is not deterministic")

    # the whole Reddit-shaped graph's transposed CSR, GCN weights (the
    # GCNFULLBATCH backward's)
    src_h, _, w_h = build_coo(adj, WeightKind.GCN)
    t0 = time.perf_counter()
    rowptr_th, col_th, w_th = csr_transpose(adj.indptr, src_h, w_h, v)
    transpose_s = time.perf_counter() - t0
    max_row = int(np.diff(rowptr_th).max())
    r_t, c_t, w_t = (torch.from_numpy(a).to(dev)
                     for a in (rowptr_th, col_th, w_th))
    lib_csr_t = torch.sparse_csr_tensor(r_t, c_t.long(), w_t, size=(v, v))
    k2b_shapes = []
    for feat in (128, 41):
        g = torch.randn(v, feat, generator=gen).to(dev)
        out = spmm_csr_bwd_cuda(g, r_t, c_t, w_t)
        ref = spmm_csr_plain(g, r_t, c_t, w_t)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        require(err <= TOL["float32"], f"K2 bwd vs plain at the training "
                                       f"shape F={feat}: {err}")
        k2b_shapes.append({
            "F": feat, "dtype": "float32", "V": v, "E": e,
            "max_row": max_row,
            "max_abs_err": (out - ref).abs().max().item(), "rel_err": err,
            "tol": TOL["float32"],
            "ms": time_ms(lambda: spmm_csr_bwd_cuda(g, r_t, c_t, w_t), 20),
            "plain_ms": time_ms(lambda: spmm_csr_plain(g, r_t, c_t, w_t), 3),
            "library_ms": time_ms(lambda: torch.sparse.mm(lib_csr_t, g), 20),
            **bound("k2_bwd", V=v, E=e, F=feat)})
        del out, ref
    del lib_csr_t
    emit({"phase": "kernel_k2_bwd", "checks": k2b_checks,
          "training_shapes": k2b_shapes, "csr_transpose_s": transpose_s})

    # ---- 12. K4 against its plain versions ---------------------------------
    k4_checks = []
    for heads, feat in K3_GRID:
        for dt in (torch.float32, torch.bfloat16):
            n_dst = 20000
            n_src = 15000 if (heads, feat) == (4, 128) else n_dst
            rowptr_, col_ = skewed_rows(n_dst, n_src, 17)
            ht = torch.randn(n_src, feat, generator=gen).to(dev, dt)
            ts, td = k3_tables(ht, torch.randn(n_dst, feat, generator=gen)
                               .to(dev, dt), heads, K3_SCORE_STD)
            ts[::K3_CLIP_EVERY] += K3_CLIP_RAISE
            gz = torch.randn(n_dst, feat, generator=gen).to(dev)
            rz = torch.randn(n_dst, heads, generator=gen).to(dev)
            rowptr_, col_ = rowptr_.to(dev), col_.to(dev)
            r_t4, c_t4, _ = transposed(rowptr_, col_, torch.ones(
                col_.numel()), n_src)
            b1 = (ht, ts, gz, td, rz, r_t4, c_t4, heads)
            b2 = (ht, ts, gz, td, rz, rowptr_, col_, heads)
            dht, dts = gat_bwd_src_cuda(*b1)
            dtd = gat_bwd_dst_cuda(*b2)
            again = (*gat_bwd_src_cuda(*b1), gat_bwd_dst_cuda(*b2))
            torch.cuda.synchronize()
            ref_dht, ref_dts = gat_bwd_src_plain(*exact_ref(*b1))
            ref_dtd = gat_bwd_dst_plain(*exact_ref(*b2))
            key = str(dt).removeprefix("torch.")
            errs = {"dht_agg": rel_err(dht, ref_dht),
                    "dts": rel_err(dts, ref_dts),
                    "dtd": rel_err(dtd, ref_dtd)}
            k4_checks.append({"H": heads, "F": feat, "dtype": key,
                              "S": n_src, "D": n_dst, "E": col_.numel(),
                              "rel_err": errs, "tol": TOL[key],
                              "table_tol": K4_TABLE_TOL})
            require(errs["dht_agg"] <= TOL[key]
                    and errs["dts"] <= K4_TABLE_TOL
                    and errs["dtd"] <= K4_TABLE_TOL,
                    f"K4 vs plain H={heads} F={feat} {key}: {errs}")
            require(bool((dtd[::13][1:] == 0).all())
                    and bool((dht[3::17] == 0).all())
                    and bool((dts[3::17] == 0).all()),
                    "K4: rows with no edges are not zero")
            require(all(torch.equal(a, b) for a, b in
                        zip((dht, dts, dtd), again)),
                    "K4 is not deterministic")
            del ref_dht, ref_dts, ref_dtd

    # B2 in each of its layouts on rows of every length in ROW_LENGTHS,
    # clipped scores, and a source (11) whose raised score dominates its
    # destinations' attention, so t_e ~ rz[d] there and the identity's two
    # sums nearly cancel; Gz and rz from a cotangent through the forward,
    # as training makes them
    b2_checks = []
    deg, r_rowptr, r_col = row_tail_csr(1500)
    hub_row = int(torch.nonzero(deg == 33)[0])
    r_col[int(r_rowptr[hub_row]):int(r_rowptr[hub_row]) + 3] = 11
    for heads, feat in K3_GRID:
        for dt in (torch.float32, torch.bfloat16):
            for aligned in (True, False):
                ht = placed(1500, feat, dt, aligned)
                ts = (torch.randn(1500, heads, generator=gen) * 2.0).to(dev)
                ts[::K3_CLIP_EVERY] += K3_CLIP_RAISE
                ts[11] = 12.0
                td = (torch.randn(deg.numel(), heads, generator=gen)
                      * 2.0).to(dev)
                h, z = gat_aggregate_plain(ht.float(), ts, td, r_rowptr,
                                           r_col, heads)
                gz, rz = gat_bwd_operands(
                    torch.randn(deg.numel(), feat, generator=gen).to(dev),
                    h, z, heads)
                gz_p = placed(deg.numel(), feat, torch.float32, aligned)
                gz_p.copy_(gz)
                b2 = (ht, ts, gz_p, td, rz, r_rowptr, r_col, heads)
                dtd = gat_bwd_dst_cuda(*b2)
                again = gat_bwd_dst_cuda(*b2)
                torch.cuda.synchronize()
                err = rel_err(dtd, gat_bwd_dst_plain(*exact_ref(*b2)))
                key = str(dt).removeprefix("torch.")
                lay, how = b2_layout(ht, gz_p, heads)
                b2_checks.append({"H": heads, "F": feat, "dtype": key,
                                  "aligned": aligned, "layout": how,
                                  "rel_err": err, "tol": K4_TABLE_TOL})
                require(err <= K4_TABLE_TOL,
                        f"B2 vs plain H={heads} F={feat} {key} ({how}): "
                        f"{err}")
                require(bool((dtd[deg == 0] == 0).all()),
                        f"B2 H={heads} F={feat} {key}: empty rows not zero")
                require(torch.equal(dtd, again), f"B2 H={heads} F={feat} "
                                                 f"{key} ({how}) is not "
                                                 "deterministic")
                del h, z, gz, gz_p, rz, dtd, again

    # B1's walk at 64, 256 and 1024 edges a warp (the wrapper's chunk,
    # ops/segment.csr_chunk_edges, replaced for the case): a source with
    # 2*10^5 out-edges, its pieces in many chunks combined by the fixed
    # tree, against the plain version (f64 over the hub row)
    b1_hub = []
    picked = k4.csr_chunk_edges
    rowptr_, col_ = skewed_rows(20000, 20000, 17)
    col_[torch.randperm(col_.numel(), generator=gen)[:200000]] = 7
    r_h, c_h, _ = transposed(rowptr_, col_, torch.ones(col_.numel()), 20000)
    hub_len = int(r_h.diff().max())
    for heads, feat in ((GAT_TRAIN_HEADS, 128), (1, 41)):
        ht = torch.randn(20000, feat, generator=gen).to(dev)
        ts, td = k3_tables(ht, torch.randn(20000, feat, generator=gen)
                           .to(dev), heads, K3_SCORE_STD)
        ts[::K3_CLIP_EVERY] += K3_CLIP_RAISE
        gz = torch.randn(20000, feat, generator=gen).to(dev)
        rz = torch.randn(20000, heads, generator=gen).to(dev)
        b1 = (ht, ts, gz, td, rz, r_h, c_h, heads)
        ref_dht, ref_dts = gat_bwd_src_plain(*b1)
        for chunk in (64, 256, 1024):
            k4.csr_chunk_edges = lambda _, c=chunk: c
            try:
                dht, dts = gat_bwd_src_cuda(*b1)
                again = gat_bwd_src_cuda(*b1)
                torch.cuda.synchronize()
            finally:
                k4.csr_chunk_edges = picked
            errs = [rel_err(dht, ref_dht), rel_err(dts, ref_dts)]
            b1_hub.append({"H": heads, "F": feat, "chunk_edges": chunk,
                           "E": col_.numel(), "hub_edges": hub_len,
                           "hub_chunks": -(-hub_len // chunk),
                           "rel_err": errs,
                           "tol": [TOL["float32"], K4_TABLE_TOL]})
            require(errs[0] <= TOL["float32"] and errs[1] <= K4_TABLE_TOL,
                    f"B1 vs plain at a {hub_len}-edge hub, {chunk} edges a "
                    f"warp, H={heads} F={feat}: {errs}")
            require(torch.equal(dht, again[0]) and torch.equal(dts, again[1]),
                    "B1 at the hub is not deterministic")
        del ref_dht, ref_dts, dht, dts, again

    k4_shapes = []
    for feat, heads in ((128, 4), (128, 1), (41, 1)):
        ht = torch.randn(v, feat, generator=gen).to(dev)
        ts, td = k3_tables(ht, ht, heads, 2.0)
        gz = torch.randn(v, feat, generator=gen).to(dev)
        rz = torch.randn(v, heads, generator=gen).to(dev)
        b1 = (ht, ts, gz, td, rz, r_t, c_t, heads)
        b2 = (ht, ts, gz, td, rz, g_rowptr, g_col, heads)
        got = (*gat_bwd_src_cuda(*b1), gat_bwd_dst_cuda(*b2))
        again = (*gat_bwd_src_cuda(*b1), gat_bwd_dst_cuda(*b2))
        ref = (*gat_bwd_src_plain(*b1), gat_bwd_dst_plain(*b2))
        torch.cuda.synchronize()
        errs = [rel_err(a, r) for a, r in zip(got, ref)]
        require(errs[0] <= TOL["float32"] and max(errs[1:]) <= K4_TABLE_TOL,
                f"K4 vs plain at the training shape F={feat} H={heads}: "
                f"{errs}")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"K4 at the training shape F={feat} H={heads} is not "
                "deterministic")
        del again
        lay, how = b2_layout(ht, gz, heads)
        comp_ms = None
        if heads == 1:
            # a yardstick only (no single PyTorch call computes K4): the
            # backward of K3's function composed of torch ops under
            # autograd.  Not k3_composition's: the gradient of
            # torch.sparse.mm with respect to the CSR's values asks for a
            # dense [V, V] buffer (202 GiB here); so K3's plain version,
            # edge gathers, exp and index_add_ in chunks
            leaves = [t.detach().requires_grad_() for t in (ht, ts, td)]
            out, _ = gat_aggregate_plain(*leaves, g_rowptr, g_col, heads)
            cot = torch.randn(v, feat, generator=gen).to(dev)
            comp_ms = time_ms(lambda: torch.autograd.grad(
                out, leaves, cot, retain_graph=True), 3)
            del out, leaves, cot
        for kname, fn, plain, work, got_i, ref_i in (
                ("gat_bwd_src", lambda: gat_bwd_src_cuda(*b1),
                 lambda: gat_bwd_src_plain(*b1), "b1", got[:2], ref[:2]),
                ("gat_bwd_dst", lambda: gat_bwd_dst_cuda(*b2),
                 lambda: gat_bwd_dst_plain(*b2), "b2", got[2:], ref[2:])):
            k4_shapes.append({
                "name": kname, "F": feat, "H": heads, "dtype": "float32",
                "V": v, "E": e,
                "layout": how if kname == "gat_bwd_dst" else None,
                "registers": (resources(f"gat_bwd_dst F={feat} H={heads}",
                                        lay)
                              if kname == "gat_bwd_dst" else None),
                "chunk_edges": (csr_chunk_edges(e) if kname == "gat_bwd_src"
                                else None),
                "max_row": max_row,
                "max_abs_err": max((a - r).abs().max().item()
                                   for a, r in zip(got_i, ref_i)),
                "rel_err": [rel_err(a, r) for a, r in zip(got_i, ref_i)],
                "tol": [TOL["float32"], K4_TABLE_TOL],
                "ms": time_ms(fn, 20), "plain_ms": time_ms(plain, 3),
                "library_ms": None,
                "composition_bwd_ms": comp_ms,
                **bound(work, V=v, E=e, F=feat, H=heads)})
        del got, ref
    emit({"phase": "kernel_k4", "checks": k4_checks, "b2_rows": b2_checks,
          "b1_hub": b1_hub,
          "training_shapes": k4_shapes,
          "library": "none: no single PyTorch call computes K4; "
                     "composition_bwd_ms times the backward of K3's plain "
                     "version (torch ops) under autograd (H=1, f32), once "
                     "per shape, beside both passes"})
    del r_t, c_t, w_t

    # ---- 13. whole-graph training (main path, counted) ---------------------
    def full_cfg(algo, heads, n_vertices, drop):
        return RunConfig(algorithm=algo, layer_sizes=TRAIN_LAYERS,
                         learn_rate=0.01, drop_rate=drop, epochs=FULL_EPOCHS,
                         seed=0, heads=heads, vertices=n_vertices)

    def full_loss_and_grads(base, params, branches, replay):
        """The first epoch's loss and gradients.  relu's subgradient jumps
        at 0, and among the ~1e7 hidden pre-activations a few lie within
        f32 rounding of it: the card and the CPU may take its two sides
        there, and one such element moves dW0 by ~1e-4 of its largest
        entry.  So the card's run records the side every torch.relu call
        takes on every element (`branches`), and the CPU's run replays
        those sides (`replay`): both then differentiate the same piecewise
        linear function.  Returns the loss, the gradients and how many
        elements the replay moved to the card's side."""
        real_relu = torch.relu
        moved = [0]
        sides = iter(branches)

        def relu(t):
            if not replay:
                branches.append((t > 0).detach().cpu())
                return real_relu(t)
            keep = next(sides).to(t.device)
            moved[0] += int(((t > 0) != keep).sum())
            return torch.where(keep, t, torch.zeros((), dtype=t.dtype,
                                                    device=t.device))

        leaves = [p.detach().to(base.device).requires_grad_()
                  for p in params.leaves()]
        torch.relu = relu
        try:
            logp = base.forward(params.replace_leaves(leaves), train=True)
        finally:
            torch.relu = real_relu
        loss = nll_loss_masked(logp, base.y, base.masks[0])
        loss.backward()
        return loss.item(), [t.grad for t in leaves], moved[0]

    small = reddit_like_dataset(seed=0, scale=FULL_EXACT_SCALE)
    full_exact = []
    for algo, heads in FULL_ENGINES:
        cfg = full_cfg(algo, heads, small.num_vertices, 0.0)
        card_tr = build_trainer(cfg, small).base
        check_params = card_tr.params._replace(attn=tuple(
            (torch.randn(a.shape, generator=attn_gen) * GAT_ATTN_SCALE)
            .to(dev) for a in card_tr.params.attn))
        branches = []
        card_loss, card_grads, _ = full_loss_and_grads(
            card_tr, check_params, branches, replay=False)
        t0 = time.perf_counter()
        cpu_loss, cpu_grads, moved = full_loss_and_grads(
            build_trainer(cfg, small, device="cpu").base,
            check_params.to("cpu"), branches, replay=True)
        cpu_s = time.perf_counter() - t0
        loss_diff = abs(card_loss - cpu_loss)
        grad_errs = [rel_err(a, b) for a, b in zip(card_grads, cpu_grads)]
        require(loss_diff <= TRAIN_LOSS_ATOL,
                f"{algo} card vs CPU loss: {loss_diff}")
        require(len(grad_errs) == (4 if algo == "GATFULLBATCH" else 2)
                and max(grad_errs) <= TRAIN_GRAD_RTOL,
                f"{algo} card vs CPU gradients: {grad_errs}")
        full_exact.append({"engine": algo, "heads": heads,
                           "V": small.num_vertices,
                           "E": card_tr.adj.num_edges, "loss": card_loss,
                           "loss_abs_diff": loss_diff,
                           "grad_rel_err": grad_errs,
                           "relu_sides_replayed": moved,
                           "relu_elements": sum(b.numel() for b in branches),
                           "host_cpu_loss_and_grads_s": cpu_s})
        del card_tr, card_grads, cpu_grads, branches
    del small

    per_epoch = {"GCNFULLBATCH": {"spmm_csr": 4, "spmm_csr_bwd": 2},
                 "GSFULLBATCH": {"spmm_csr": 4, "spmm_csr_bwd": 2},
                 "GATFULLBATCH": {"gat_aggregate": 4, "gat_bwd_src": 2,
                                  "gat_bwd_dst": 2}}
    per_predict = {"GCNFULLBATCH": {"spmm_csr": 2},
                   "GSFULLBATCH": {"spmm_csr": 2},
                   "GATFULLBATCH": {"gat_aggregate": 2}}
    full_runs = []
    reset_counts()
    for algo, heads in FULL_ENGINES:
        t0 = time.perf_counter()
        base = build_trainer(full_cfg(algo, heads, ds.num_vertices, 0.5),
                             ds).base
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        hist = []
        for _ in range(FULL_EPOCHS):
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, tr_acc, va_acc, te_acc = base.train_epoch()
            torch.cuda.synchronize()
            hist.append({"ms": (time.perf_counter() - t0) * 1e3,
                         "loss": loss, "train": tr_acc, "val": va_acc,
                         "test": te_acc})
            now = counts()
            got = {n: now[n] - before[n] for n in now if now[n] != before[n]}
            require(got == per_epoch[algo],
                    f"{algo} epoch launched {got}, expected {per_epoch[algo]}")
        before = counts()
        pred = base.predict()
        now = counts()
        got = {n: now[n] - before[n] for n in now if now[n] != before[n]}
        require(got == per_predict[algo],
                f"{algo} predict() launched {got}")
        require(pred.shape == (v, 41) and bool(np.isfinite(pred).all()),
                f"{algo} predict() shape {pred.shape} or non-finite values")
        losses = [h["loss"] for h in hist]
        require(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
                f"{algo} losses not finite or not falling: {losses}")
        med_ms = statistics.median(h["ms"] for h in hist[1:])
        full_runs.append({
            "engine": algo, "heads": heads, "V": v,
            "E": base.adj.num_edges, "drop": 0.5, "epochs": hist,
            "epoch_ms_median_after_first": med_ms,
            "edges_per_s": base.adj.num_edges / (med_ms / 1e3),
            "build_s": base.build_s, "csr_transpose_s": base.transpose_s,
            "build_trainer_s": build_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        del base, pred
    full_counts = counts()
    for kname in ("spmm_csr_bwd", "gat_bwd_src", "gat_bwd_dst"):
        require(full_counts[kname] > 0, f"train_full never launched {kname}")
    require(all(full_counts[k] == 0 for k in (
        "gather_agg_fwd", "gather_agg_bwd_dx", "gather_agg_bwd_dw",
        "block_transpose")),
            f"whole-graph training launched K1: {full_counts}")
    # bench.py:413-420's reading of a GCNFULLBATCH epoch: two SpMM layers
    # forward over E edges each, the backward's scatter in the model
    gcn_ms = next(r for r in full_runs if r["engine"] == "GCNFULLBATCH")[
        "epoch_ms_median_after_first"]
    emit({"phase": "train_full", "model": "602-128-41",
          "loss_atol": TRAIN_LOSS_ATOL, "grad_rtol": TRAIN_GRAD_RTOL,
          "exact_scale": FULL_EXACT_SCALE, "exact": full_exact,
          "runs": full_runs, "launches": full_counts,
          "roofline": {"GCNFULLBATCH": stage_reading(
              gcn_ms / 1e3, 2 * e, spmm_models, e, v, TRAIN_LAYERS[1:], 4,
              backward=True, row_ops=3.0)}})

    # ---- 14. rate probes (main path: the probe scripts, counted) ----------
    probe_t0 = time.perf_counter()
    gather_mod = load_script("torch_probe_gather")
    tile_mod = load_script("torch_probe_tile_spmm")
    gat_mod = load_script("torch_probe_gat_tile")

    # each kernel against its plain version on the same CUDA tensors, at
    # the probes' shapes; these launches are not the path's
    probe_checks = {"gather_sum": [], "shuffle": [], "tile_spmm": [],
                    "gat_tile": []}
    gather_cases = list(gather_mod.gather_cases(dev))
    for t_rows, resident, table, idx in gather_cases:
        ref = pr.gather_sum_plain(table, idx)
        got, again = (pr.gather_sum(table, idx, resident) for _ in range(2))
        err = rel_err(got, ref)
        require(err <= PROBE_F32_TOL and torch.equal(got, again),
                f"gather_sum T={t_rows} resident={resident}: rel err {err}, "
                f"repeat equal {torch.equal(got, again)}")
        probe_checks["gather_sum"].append({
            "T": t_rows, "variant": "shared" if resident else "global",
            "rel_err": err, "max_abs_err": (got - ref).abs().max().item()})
    for (m, n), axis in pr.SHUFFLE_SHAPES:
        x = torch.from_numpy(pr.shuffle_input(0, m, n)).to(dev)
        got, again = (pr.shuffle(x, axis) for _ in range(2))
        require(torch.equal(got, pr.shuffle_plain(x, axis))
                and torch.equal(got, again),
                f"shuffle [{m},{n}] axis={axis} differs from plain or repeat")
        probe_checks["shuffle"].append({"m": m, "n": n, "axis": axis,
                                        "bit_identical": True})
    tile_args = tile_mod.config_inputs("0", dev)
    part_args = tile_mod.part_inputs(dev)
    tile_cases = [("config 0", pr.tile_spmm, tile_args)] + [
        (part, *pr.tile_part_args(part, *part_args))
        for part in pr.TILE_PARTS]
    for case, fn, args in tile_cases:
        plain = (pr.tile_gather_plain if fn is pr.tile_gather
                 else pr.tile_spmm_plain)
        got, again, ref = fn(*args), fn(*args), plain(*args)
        err = rel_err(got, ref)
        require(err <= PROBE_F32_TOL, f"tile_spmm {case}: rel err {err}")
        require(torch.equal(got, again), f"tile_spmm {case} is not "
                                         f"bit-identical on repeat")
        if fn is pr.tile_gather:   # plain stores
            require(torch.equal(got, ref),
                    f"tile_gather {case} not bit-identical to plain")
        else:   # sorted by row, each row summed in (step, edge) order
            require(torch.equal(got, pr.tile_spmm_ordered(*args)),
                    f"tile_spmm {case} is not its ordered sum bit for bit")
        probe_checks["tile_spmm"].append({
            "case": case, "rel_err": err,
            "max_abs_err": (got - ref).abs().max().item(),
            "repeat_bit_identical": True})
    for n_tiles in (1, pr.GAT_TILES):
        g_args = gat_mod.tile_args(dev, n_tiles)
        (out, z), again = pr.gat_tile(*g_args), pr.gat_tile(*g_args)
        ref_out, ref_z = pr.gat_tile_plain(*g_args)
        errs = [rel_err(out, ref_out), rel_err(z, ref_z)]
        require(errs[0] <= PROBE_BF16_TOL and errs[1] <= PROBE_F32_TOL
                and torch.equal(out, again[0]) and torch.equal(z, again[1]),
                f"gat_tile {n_tiles} tiles: rel err {errs} or not "
                f"bit-identical on repeat")
        probe_checks["gat_tile"].append({
            "tiles": n_tiles, "rel_err": errs,
            "max_abs_err": max((out - ref_out).abs().max().item(),
                               (z - ref_z).abs().max().item())})
        del out, z, again, ref_out, ref_z
    # the path: the three probe scripts' timed runs, counts from zero (the
    # timing adds its graph replays' kernel runs to them)
    reset_counts()
    p_gather = gather_mod.time_gather(gather_cases)
    p_shuffle = gather_mod.time_shuffle(dev)
    p_tile = [tile_mod.time_config("0", dev)] + tile_mod.time_parts(dev)
    p_gat = gat_mod.time_tiles(dev)
    probe_counts = {k: n for k, n in counts().items()
                    if k.startswith("probe_")}
    # each timed case: a warm-up call, then two replays of REPS calls
    runs = {"probe_gather_sum": len(gather_cases) * (1 + 2 * gather_mod.REPS),
            "probe_shuffle": len(pr.SHUFFLE_SHAPES) * (1 + 2 * gather_mod.REPS),
            "probe_tile_spmm": (1 + len(pr.TILE_PARTS)) * (1 + 2 * tile_mod.REPS),
            "probe_gat_tile": 1 + 2 * gat_mod.REPS}
    require(probe_counts == runs,
            f"kernel_probes launched {probe_counts}, its timing ran {runs}")
    require(sum(counts().values()) == sum(probe_counts.values()),
            f"the probes launched other kernels: {counts()}")
    # beside each: its plain version and one library call, timed as the
    # kernel is (graph replays of the script's REPS calls), and the bound
    gather_rows = []
    for (t_rows, resident, table, idx), rec, chk in zip(
            gather_cases, p_gather, probe_checks["gather_sum"]):
        e_n, feat = idx.numel(), table.shape[1]
        touched = torch.unique(idx).numel()   # the rows this run reads
        gather_rows.append({
            **rec, "rows_touched": touched, "max_abs_err": chk["max_abs_err"],
            "plain_ms": cuda_graph_ms(
                lambda: pr.gather_sum_plain(table, idx), gather_mod.REPS),
            "library_ms": cuda_graph_ms(
                lambda: torch.nn.functional.embedding_bag(
                    idx, table, mode="sum"), gather_mod.REPS),
            **bound("p_g", rows_read=touched, E=e_n, F=feat,
                    tiles=idx.shape[0])})
    shuffle_rows = []
    for rec in p_shuffle:
        m, n, axis = rec["m"], rec["n"], rec["axis"]
        x = torch.from_numpy(pr.shuffle_input(0, m, n)).to(dev)
        every = torch.stack([pr.shuffle_index(m, n, axis, i, dev)
                             for i in range(pr.SHUFFLE_STEPS)])
        stacked = x.expand(pr.SHUFFLE_STEPS, m, n)
        require(torch.equal(torch.gather(stacked, axis + 1, every)[-1],
                            pr.shuffle_plain(x, axis)),
                "the shuffle's library yardstick computes another function")
        shuffle_rows.append({
            **rec, "max_abs_err": 0.0,
            "plain_ms": cuda_graph_ms(lambda: pr.shuffle_plain(x, axis),
                                      gather_mod.REPS),
            "library_ms": cuda_graph_ms(
                lambda: torch.gather(stacked, axis + 1, every),
                gather_mod.REPS),
            **bound("p_s", m=m, n=n)})
        del every, stacked
    tile_rows = []
    for (case, fn, args), rec, chk in zip(tile_cases, p_tile,
                                          probe_checks["tile_spmm"]):
        t_slab, t_src = args[0], args[1]
        e_n, feat = t_src.numel(), t_slab.shape[1]
        slab_f32 = t_slab.float()
        if fn is pr.tile_gather:
            flat = t_src.reshape(-1)
            lib = lambda: torch.index_select(slab_f32, 0, flat)  # noqa: E731
            plain = pr.tile_gather_plain
            t_bound = bound("p_t_gather", 2, slab_rows=t_slab.shape[0],
                            F=feat, E=e_n)
        else:
            _, _, t_dst, t_w, t_r0, d_blk = args
            rows = pr.tile_rows(t_src, t_dst, t_r0).reshape(-1)
            vals = (t_w.reshape(-1).float() if t_w is not None
                    else torch.ones(e_n, device=dev))
            coo = torch.sparse_coo_tensor(
                torch.stack([rows, t_src.reshape(-1).long()]), vals,
                (d_blk, t_slab.shape[0])).coalesce()
            lib = lambda: torch.sparse.mm(coo, slab_f32)  # noqa: E731
            plain = pr.tile_spmm_plain
            t_bound = bound("p_t", 2, slab_rows=t_slab.shape[0], F=feat,
                            E=e_n, windows=t_r0.numel(), out_rows=d_blk,
                            dst=t_dst is not None, weighted=t_w is not None)
        tile_rows.append({
            "case": case, **rec, "max_abs_err": chk["max_abs_err"],
            "plain_ms": cuda_graph_ms(lambda: plain(*args), tile_mod.REPS),
            "library_ms": cuda_graph_ms(lib, tile_mod.REPS),
            # gather_bound_ms: any design reads a slab row an edge (from
            # L1/L2)
            **t_bound,
            "pct_of_bound": 100.0 * t_bound["bound_ms"] / rec["ms"],
            "slab_row_bytes": e_n * feat * 2})
    g_slab, g_ts, g_td, g_src, g_dst, _ = g_args   # the GAT_TILES tiles
    live_d = int((g_dst < pr.GAT_W).sum())
    live_both = int(((g_dst < pr.GAT_W) & (g_src < pr.GAT_S_BLK)).sum())
    g_cols = g_ts.shape[2]
    gat_rows = [{
        **p_gat, "max_abs_err": probe_checks["gat_tile"][-1]["max_abs_err"],
        "plain_ms": cuda_graph_ms(lambda: pr.gat_tile_plain(*g_args),
                                  gat_mod.REPS),
        "library_ms": None,
        **bound("p_a", 2, tiles=g_slab.shape[0], S=g_slab.shape[1],
                W=g_td.shape[1], E=g_src.shape[1], F=g_slab.shape[2],
                cols=g_cols, live_dst=live_d, live_both=live_both)}]
    del g_args, g_slab, g_ts, g_td, g_src, g_dst, gather_cases
    k2_f128 = next(t for t in timings
                   if t["F"] == 128 and t["dtype"] == "float32")
    emit({"phase": "kernel_probes", "checks": probe_checks,
          "tol": {"gather_sum": PROBE_F32_TOL, "shuffle": "exact",
                  "tile_spmm": PROBE_F32_TOL,
                  "gat_tile": [PROBE_BF16_TOL, PROBE_F32_TOL]},
          "gather_sum": gather_rows, "shuffle": shuffle_rows,
          "tile_spmm": tile_rows, "gat_tile": gat_rows,
          "tile_spmm_ns_per_edge": p_tile[0]["ns_per_edge"],
          "tile_sum_resources": probe_k.tile_sum_resources(),
          "k2_fwd_ns_per_edge": k2_f128["ms"] * 1e6 / k2_f128["E"],
          "launches": probe_counts,
          "phase_s": time.perf_counter() - probe_t0,
          "timing": "kernel, plain and library ms alike: device time of "
                    "CUDA-graph replays of the script's REPS calls "
                    "(utils.timing.cuda_graph_ms); launches count the "
                    "replays' kernel runs"})

    # ---- 15. the card's random-row-access floor ----------------------------
    # the counterpart of the TPU figure in sgnn_tpu/utils/roofline.py
    # (measured by scripts/profile_gat_serving2.py:129): a random f32 row
    # gather of width 128 from a table of the graph's V rows, over its edge
    # sources in the CSR's order, through P-G's device-memory gather-sum
    # (the stream cut to whole GATHER_TILE tiles), beside embedding_bag
    floor_t0 = time.perf_counter()
    n_floor = e // pr.GATHER_TILE * pr.GATHER_TILE
    floor_idx = torch.from_numpy(
        adj.indices[:n_floor].astype(np.int32)).to(dev).view(
            -1, pr.GATHER_TILE)
    floor_table = torch.randn(v, pr.PROBE_F, device=dev,
                              generator=torch.Generator(dev).manual_seed(0))
    reset_counts()
    got = pr.gather_sum(floor_table, floor_idx, False)
    ref = pr.gather_sum_plain(floor_table, floor_idx[:FLOOR_CHECK_TILES])
    bag = torch.nn.functional.embedding_bag(
        floor_idx[:FLOOR_CHECK_TILES], floor_table, mode="sum")
    floor_errs = [rel_err(got[:FLOOR_CHECK_TILES], ref), rel_err(bag, ref)]
    require(max(floor_errs) <= PROBE_F32_TOL,
            f"row_access_floor: gather_sum and embedding_bag against plain "
            f"{floor_errs} > {PROBE_F32_TOL}")
    del got, ref, bag
    floor_ms = time_ms(lambda: pr.gather_sum(floor_table, floor_idx, False),
                       FLOOR_REPS)
    bag_ms = time_ms(lambda: torch.nn.functional.embedding_bag(
        floor_idx, floor_table, mode="sum"), FLOOR_REPS)
    floor_counts = counts()
    require(floor_counts["probe_gather_sum"] == FLOOR_REPS + 2
            and sum(floor_counts.values()) == FLOOR_REPS + 2,
            f"row_access_floor launched {floor_counts}, expected "
            f"{FLOOR_REPS + 2} gather_sum")
    floor_ns = {"gather_sum": floor_ms * 1e6 / n_floor,
                "embedding_bag": bag_ms * 1e6 / n_floor}
    emit({"phase": "row_access_floor", "T": v, "F": pr.PROBE_F,
          "dtype": "float32", "edges": e, "edges_timed": n_floor,
          "edges_cut": e - n_floor, "tile": pr.GATHER_TILE,
          "gather_sum_ms": floor_ms, "embedding_bag_ms": bag_ms,
          "ns_per_row": floor_ns,
          "floor_ns_per_row": min(floor_ns.values()),
          "module_row_access_floor_ns": roofline.ROW_ACCESS_FLOOR_NS,
          "row_gb_s": n_floor * pr.PROBE_F * 4 / (floor_ms * 1e-3) / 1e9,
          "rel_err": floor_errs, "checked_tiles": FLOOR_CHECK_TILES,
          "tol": PROBE_F32_TOL, "launches": floor_counts["probe_gather_sum"],
          "nvidia_smi": smi, "phase_s": time.perf_counter() - floor_t0})
    del floor_idx, floor_table

    # ---- 16. serving extras (two main paths, counted) ---------------------
    extras_t0 = time.perf_counter()
    # (a) int8 residency: GCN, and GAT heads 4 with serving_gat's attention
    reset_counts()
    int8_rows = []
    for family, p, heads, f32_full in (
            ("gcn", params, 1, gcn_full),
            ("gat", gat_params, GAT_TRAIN_HEADS, gat_fulls[GAT_TRAIN_HEADS])):
        kname = "gat_aggregate" if family == "gat" else "spmm_csr"
        isrv = InferenceServer(p, family, adj, ds.features, heads=heads,
                               dtype="int8", device=dev)
        require(isrv.feature_bytes * 4 == f32_feature_bytes,
                f"int8 residency holds {isrv.feature_bytes} feature bytes, "
                f"f32 {f32_feature_bytes}")
        pass_s = []
        for _ in range(4):
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logp8 = isrv.logprobs(as_numpy=False)
            torch.cuda.synchronize()
            pass_s.append(time.perf_counter() - t0)
            now = counts()
            got = {n: now[n] - before[n] for n in now if now[n] != before[n]}
            require(got == {kname: 2},
                    f"int8 {family} logprobs() launched {got}")
        full8 = logp8.cpu().numpy()
        require(full8.shape == (v, 41) and bool(np.isfinite(full8).all()),
                f"int8 {family} log-probs shape or non-finite values")
        t0 = time.perf_counter()
        cpu8 = InferenceServer(p.to("cpu"), family, adj, ds.features,
                               heads=heads, dtype="int8",
                               device="cpu").logprobs()
        cpu_s = time.perf_counter() - t0
        cpu_err = float(np.abs(full8 - cpu8).max())
        require(cpu_err <= SERVE_ATOL,
                f"int8 {family} card vs CPU pass: {cpu_err}")
        agree = float(np.mean(full8.argmax(1) == f32_full.argmax(1)))
        require(agree > INT8_ARGMAX_AGREE,
                f"int8 {family} argmax agreement with f32 {agree}")
        q_err = 0.0
        for size in (8, 64, 512):
            for _ in range(3):
                nids = rng.choice(v, size=size, replace=False)
                before = counts()[kname]
                got = isrv.query(nids)
                require(counts()[kname] - before == 2,
                        f"int8 {family} query() did not launch twice")
                q_err = max(q_err, float(np.abs(got - full8[nids]).max()))
        require(q_err <= SERVE_ATOL,
                f"int8 {family} query vs whole-graph rows: {q_err}")
        int8_rows.append({
            "model": f"{family} 602-128-41", "heads": heads,
            "feature_bytes": isrv.feature_bytes,
            "f32_feature_bytes": f32_feature_bytes,
            "pass_ms_median_last3": statistics.median(pass_s[1:]) * 1e3,
            "f32_pass_ms_median_last3": (
                serving_pass_ms if family == "gcn"
                else gat_pass_ms[GAT_TRAIN_HEADS]),
            "cpu_pass_max_abs_diff": cpu_err, "host_cpu_pass_s": cpu_s,
            "argmax_agreement_with_f32": agree,
            "query_max_abs_diff": q_err})
        del isrv, logp8
    int8_serve_counts = counts()
    require(int8_serve_counts["spmm_csr"] > 0
            and int8_serve_counts["gat_aggregate"] > 0
            and sum(int8_serve_counts.values())
            == int8_serve_counts["spmm_csr"]
            + int8_serve_counts["gat_aggregate"],
            f"int8 serving launched {int8_serve_counts}")
    # (b) chunked layerwise_inference against the whole-graph pass
    chunk_rows, chunk_counts = [], {}
    n_chunks = -(-v // CHUNK_ROWS)
    for family, p, heads in (("gcn", params, 1),
                             ("gat", gat_params, GAT_TRAIN_HEADS)):
        kname = "gat_aggregate" if family == "gat" else "spmm_csr"
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        whole = layerwise_inference(p, family, adj, ds.features, heads=heads,
                                    whole_graph=True, device=dev)
        whole_s = time.perf_counter() - t0
        whole_peak = torch.cuda.max_memory_allocated() - base_bytes
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        timers = PhaseTimer()
        t0 = time.perf_counter()
        chunked = layerwise_inference(p, family, adj, ds.features,
                                      heads=heads, whole_graph=False,
                                      chunk_size=CHUNK_ROWS, timers=timers,
                                      device=dev)
        chunk_s = time.perf_counter() - t0
        chunk_peak = torch.cuda.max_memory_allocated() - base_bytes
        got = {n: c for n, c in counts().items() if c}
        chunk_counts[family] = got
        require(got == {kname: 2 * n_chunks},
                f"chunked {family} launched {got}, expected "
                f"{2 * n_chunks} {kname}")
        err = float(np.abs(chunked - whole).max())
        require(chunked.shape == (v, 41) and err <= SERVE_ATOL,
                f"chunked {family} vs whole-graph pass: {err}")
        require(chunk_peak < whole_peak,
                f"chunked {family} peaked at {chunk_peak} bytes, the "
                f"whole-graph pass at {whole_peak}")
        chunk_rows.append({
            "model": f"{family} 602-128-41", "heads": heads,
            "chunk_size": CHUNK_ROWS, "chunks": n_chunks,
            "launches": got, "max_abs_diff_vs_whole": err,
            "pass_s": chunk_s, "whole_graph_pass_s": whole_s,
            "phase_s": dict(timers.totals),
            "host_staging_share": timers.totals["stage"] / chunk_s,
            "peak_bytes_above_base": chunk_peak,
            "whole_graph_peak_bytes_above_base": whole_peak,
            "base_bytes": base_bytes})
        del whole, chunked
    # (c) the automatic choice: whole-graph at this size on the card, chunked
    # under a budget below the estimate
    est = whole_graph_bytes(params, "gcn", adj, ds.features.shape[1])
    auto = {}
    for budget in (None, est // 2):
        reset_counts()
        layerwise_inference(params, "gcn", adj, ds.features,
                            chunk_size=CHUNK_ROWS, hbm_budget_bytes=budget,
                            device=dev)
        auto["card" if budget is None else "half_estimate"] = {
            "budget_bytes": memory_budget(dev, budget),
            "spmm_launches": spmm_csr_cuda.launches}
    require(auto["card"]["spmm_launches"] == 2
            and auto["half_estimate"]["spmm_launches"] == 2 * n_chunks,
            f"whole_graph=None chose {auto} (estimate {est} bytes)")
    emit({"phase": "serving_extras", "int8": int8_rows,
          "int8_launches": int8_serve_counts, "chunked": chunk_rows,
          "auto_choice": {"whole_graph_estimate_bytes": est, **auto},
          "tol": SERVE_ATOL, "argmax_floor": INT8_ARGMAX_AGREE,
          "phase_s": time.perf_counter() - extras_t0})

    # ---- 17. training extras (int8 paths counted; resume) -----------------
    extras_t0 = time.perf_counter()
    # (a) int8 GSSAMPLEALLGPU, one epoch and evaluate
    int8_cfg = dataclasses.replace(dev_cfg, feature_dtype="int8")
    int8_trainer = build_trainer(int8_cfg, ds)
    require(int8_trainer.dev_features.dtype == torch.int8,
            "FEATURE_DTYPE:int8 did not store int8 features")
    int8_feature_bytes = (int8_trainer.dev_features.numel()
                          * int8_trainer.dev_features.element_size())
    require(int8_feature_bytes * 4 == f32_train_feature_bytes,
            f"int8 trainer holds {int8_feature_bytes} feature bytes")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr_loss, tr_acc, edges = int8_trainer.train_epoch()
    epoch_s = time.perf_counter() - t0
    val_acc = int8_trainer.evaluate(int8_trainer.val_nids)
    int8_train_counts = counts()
    steps = len(int8_trainer.step_ms)
    eval_batches = -(-int8_trainer.val_nids.size // TRAIN_BATCH)
    losses = int8_trainer.step_losses
    require(all(np.isfinite(losses)) and np.isfinite(tr_loss),
            f"non-finite int8 training loss: {losses}")
    require(float(np.mean(losses[-4:])) < losses[0],
            f"int8 loss did not fall: first {losses[0]}, last 4 {losses[-4:]}")
    require([int8_train_counts[k] for k in (
        "gather_agg_fwd", "gather_agg_bwd_dx", "gather_agg_bwd_dw",
        "block_transpose")] == [2 * steps + 2 * eval_batches, 2 * steps, 0,
                                2 * steps]
            and sum(int8_train_counts.values()) == 6 * steps
            + 2 * eval_batches,
            f"int8 epoch + evaluate launched {int8_train_counts}")
    int8_train = {
        "engine": "GSSAMPLEALLGPU", "feature_dtype": "int8",
        "model": "sage 602-128-41", "fanout": TRAIN_FANOUT,
        "batch": TRAIN_BATCH, "steps": steps, "losses": losses,
        "step_ms_median_after_first": statistics.median(
            int8_trainer.step_ms[1:]),
        "f32_step_ms_median_after_first": f32_step_ms,
        "epoch_s": epoch_s, "edges_per_epoch": edges,
        "train_acc": tr_acc, "val_acc": val_acc,
        "feature_bytes": int8_feature_bytes,
        "f32_feature_bytes": f32_train_feature_bytes,
        "overflow": int8_trainer.last_overflow,
        "launches": int8_train_counts}
    del int8_trainer
    # (b) int8 GCNFULLBATCH: the first epoch's loss against the CPU at scale
    # 0.25, drop 0; then 5 epochs at scale 1.0, drop 0.5
    small = reddit_like_dataset(seed=0, scale=FULL_EXACT_SCALE)
    cfg8 = dataclasses.replace(
        full_cfg("GCNFULLBATCH", 1, small.num_vertices, 0.0),
        feature_dtype="int8")
    card_loss = build_trainer(cfg8, small).base.train_epoch()[0]
    t0 = time.perf_counter()
    cpu_loss = build_trainer(cfg8, small, device="cpu").base.train_epoch()[0]
    cpu_s = time.perf_counter() - t0
    loss_diff = abs(card_loss - cpu_loss)
    require(loss_diff <= TRAIN_LOSS_ATOL,
            f"int8 GCNFULLBATCH card vs CPU first loss: {loss_diff}")
    del small
    base8 = build_trainer(dataclasses.replace(
        full_cfg("GCNFULLBATCH", 1, ds.num_vertices, 0.5),
        feature_dtype="int8"), ds).base
    require(base8.x.dtype == torch.int8, "int8 GCNFULLBATCH x is not int8")
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hist = []
    for _ in range(FULL_EPOCHS):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, tr_acc, va_acc, te_acc = base8.train_epoch()
        torch.cuda.synchronize()
        hist.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": loss,
                     "train": tr_acc, "val": va_acc, "test": te_acc})
        now = counts()
        got = {n: now[n] - before[n] for n in now if now[n] != before[n]}
        require(got == {"spmm_csr": 4, "spmm_csr_bwd": 2},
                f"int8 GCNFULLBATCH epoch launched {got}")
    int8_full_counts = counts()
    epoch_peak = torch.cuda.max_memory_allocated() - state_bytes
    losses = [h["loss"] for h in hist]
    require(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
            f"int8 GCNFULLBATCH losses not finite or not falling: {losses}")
    int8_full = {
        "engine": "GCNFULLBATCH", "feature_dtype": "int8",
        "model": "gcn 602-128-41", "epochs": hist,
        "epoch_ms_median_after_first": statistics.median(
            h["ms"] for h in hist[1:]),
        "f32_epoch_ms_median_after_first": next(
            r["epoch_ms_median_after_first"] for r in full_runs
            if r["engine"] == "GCNFULLBATCH"),
        "first_loss_card_vs_cpu_abs_diff": loss_diff,
        "exact_scale": FULL_EXACT_SCALE, "loss_atol": TRAIN_LOSS_ATOL,
        "host_cpu_epoch_s": cpu_s,
        "feature_bytes": base8.x.numel() * base8.x.element_size(),
        "epoch_peak_bytes_above_state": epoch_peak,
        "launches": int8_full_counts}
    del base8
    # (c) resume: 2 epochs straight against 1, save, restore, 1
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    straight = build_trainer(dev_cfg, ds)
    straight.train_epoch()
    straight.train_epoch()
    first = build_trainer(dev_cfg, ds)
    first.train_epoch()
    mgr = CheckpointManager(str(ckpt_dir))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = mgr.save(0, first)
    save_s = time.perf_counter() - t0
    save_bytes = os.path.getsize(path)
    del first
    resumed = build_trainer(dev_cfg, ds)
    t0 = time.perf_counter()
    require(mgr.restore(resumed) == 0, "restore found no step 0")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    resumed.train_epoch()
    resume_errs = [rel_err(b, a) for a, b in zip(
        straight.params.leaves(), resumed.params.leaves())]
    require(max(resume_errs) <= TRAIN_GRAD_RTOL,
            f"resumed vs straight parameters: {resume_errs}")
    bit_identical = all(torch.equal(a, b) for a, b in zip(
        straight.params.leaves(), resumed.params.leaves()))
    del straight, resumed
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    emit({"phase": "train_extras", "int8_device_sampled": int8_train,
          "int8_fullbatch": int8_full,
          "resume": {"engine": "GSSAMPLEALLGPU", "epochs": "2 straight vs "
                     "1 + save + restore + 1", "param_rel_err": resume_errs,
                     "tol": TRAIN_GRAD_RTOL, "bit_identical": bit_identical,
                     "save_s": save_s, "restore_s": restore_s,
                     "checkpoint_bytes": save_bytes},
          "phase_s": time.perf_counter() - extras_t0})

    # ---- 18. cached training (main paths, counted) ------------------------
    cache_t0 = time.perf_counter()

    def build_cached(cfg):
        """`cfg`'s trainer built from zeroed counts: (trainer, the build's
        host-clock phases and the device bytes the trainer holds after it,
        the launches the build made)."""
        reset_counts()
        torch.cuda.synchronize()
        held0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tr = build_trainer(cfg, ds)
        torch.cuda.synchronize()
        build = {"total_s": time.perf_counter() - t0,
                 **{f"{k}_s": tr.timers.totals[k] for k in (
                     "presample", "cache_csr", "cache_aggregate")},
                 "resident_bytes": torch.cuda.memory_allocated() - held0}
        if isinstance(tr, DeviceCachedSampleTrainer):
            # one copy of the aggregates on the card: the stacked one
            require(all(c.cache_agg is None for c in tr.sb_caches),
                    "a plan keeps its own aggregate beside the stack")
            build["stacked_agg_bytes"] = (tr.cache_agg_all.numel()
                                          * tr.cache_agg_all.element_size())
        return tr, build, {n: c for n, c in counts().items() if c}

    def plan_checks(tr):
        """Each plan's PushDown aggregate against K2's plain version on the
        same card tensors, and a repeat launch bit-identical to it (these
        launches are outside the counted path)."""
        rows = []
        for k, c in enumerate(tr.sb_caches):
            csr = csr_from_numpy(c.rowptr, c.col, c.w,
                                 tr.dev_features.shape[0], dev)
            again = spmm_csr_cuda(tr.dev_features, *csr)
            ref = spmm_csr_plain(tr.dev_features, *csr)
            agg = tr.cache_agg_all[k]
            err = rel_err(agg, ref)
            require(err <= TOL["float32"], f"plan {k}'s PushDown aggregate "
                                           f"vs plain: {err}")
            require(torch.equal(again, agg),
                    f"plan {k}'s aggregate is not bit-identical on repeat")
            rows.append({"plan": k, "C": c.num_cached, "E": int(c.col.size),
                         "longest_row": int(np.diff(c.rowptr).max()),
                         "rel_err": err, "tol": TOL["float32"],
                         "max_abs_err": (agg - ref).abs().max()
                         .item(), "bit_identical": True})
        return rows

    def k1_expect(steps, eval_batches):
        return {"gather_agg_fwd": 2 * (steps + eval_batches),
                "gather_agg_bwd_dx": 2 * steps,
                "block_transpose": 2 * steps}

    def cached_epoch(tr, k1_on_path):
        """One epoch and `evaluate` from zeroed counts: finite losses, the
        last 4 steps' mean below the first step's, 16 steps, one refresh a
        super-batch, K1's launches as train_device's (none for GAT), no
        K2 after the build."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr_loss, tr_acc, edges = tr.train_epoch()
        epoch_s = time.perf_counter() - t0
        val_acc = tr.evaluate(tr.val_nids)
        got = {n: c for n, c in counts().items() if c}
        steps = len(tr.step_ms)
        eval_batches = -(-tr.val_nids.size // TRAIN_BATCH)
        losses = tr.step_losses
        require(all(np.isfinite(losses)) and np.isfinite(tr_loss),
                f"non-finite cached training loss: {losses}")
        require(steps == 16, f"{steps} cached steps, expected 16")
        require(float(np.mean(losses[-4:])) < losses[0],
                f"cached loss did not fall: first {losses[0]}, last 4 "
                f"{losses[-4:]}")
        require(tr.refreshes == len(tr.sb_caches) == 4,
                f"{tr.refreshes} refreshes for {len(tr.sb_caches)} plans")
        want = k1_expect(steps, eval_batches) if k1_on_path else {}
        require(got == want, f"cached epoch + evaluate launched {got}, "
                             f"expected {want}")
        med = statistics.median(tr.step_ms[1:])
        return got, {
            "steps": steps, "step_ms": tr.step_ms,
            "step_ms_median_after_first": med, "losses": losses,
            "epoch_s": epoch_s, "edges_per_epoch": edges,
            "sampled_edges_per_s_steady": edges / steps / (med / 1e3),
            "hit_rate": tr.cache_hit_rate, "hits": tr.cache_hits,
            "lookups": tr.cache_lookups, "refreshes": tr.refreshes,
            "train_acc": tr_acc, "val_acc": val_acc,
            "eval_batches": eval_batches, "launches": got}

    cache_runs, cache_counts = {}, {}
    # (a) GSSAMPLECACHE: build, plans against plain, K2 at the PushDown
    # shape, the first cached batch card vs CPU, then one epoch
    gs_cfg = dataclasses.replace(dev_cfg, algorithm="GSSAMPLECACHE")
    gs_tr, build, built = build_cached(gs_cfg)
    require(isinstance(gs_tr, DeviceCachedSampleTrainer)
            and len(gs_tr.sb_caches) == 4,
            "GSSAMPLECACHE did not build 4 plans on the device trainer")
    require(built == {"spmm_csr": 4}, f"GSSAMPLECACHE's build launched "
                                      f"{built}, expected 4 K2")
    plans = plan_checks(gs_tr)
    c0 = gs_tr.sb_caches[0]
    x = gs_tr.dev_features
    csr = csr_from_numpy(c0.rowptr, c0.col, c0.w, x.shape[0], dev)
    lay, how = k2_layout(x)
    lib_csr = torch.sparse_csr_tensor(csr.rowptr, csr.col.long(), csr.w,
                                      size=(c0.num_cached, x.shape[0]))
    e0, f0, c_rows = int(c0.col.size), x.shape[1], c0.num_cached
    out = spmm_csr_cuda(x, *csr)
    ref = spmm_csr_plain(x, *csr)
    pd_shape = {
        "name": "spmm_csr", "shape": "PushDown aggregate, plan 0",
        "C": c_rows, "V": x.shape[0], "E": e0, "F": f0, "dtype": "float32",
        "longest_row": plans[0]["longest_row"], "layout": how,
        "registers": resources("spmm_csr PushDown F=602", lay),
        "max_abs_err": (out - ref).abs().max().item(),
        "rel_err": rel_err(out, ref),
        "ms": time_ms(lambda: spmm_csr_cuda(x, *csr), 20),
        "plain_ms": time_ms(lambda: spmm_csr_plain(x, *csr), 3),
        "library_ms": time_ms(lambda: torch.sparse.mm(lib_csr, x), 20),
        **bound("k2_pushdown", x.element_size(), C=c_rows, V=x.shape[0],
                E=e0, F=f0)}
    del out, ref, lib_csr
    # the first cached batch: its loss and every gradient, card vs CPU on
    # the same blocks and cache rows, drop 0
    batch = first_batch(gs_tr, omit_map=gs_tr.cache_maps[0])
    emb = refresh_rows(gs_tr.cache_agg_all[0], gs_tr.params.weights[0])
    require(bool(batch.cache_mask.any()), "the first batch hit no cache row")
    card = loss_and_grads(gs_tr.params, "sage", batch, cache_emb=emb)
    t0 = time.perf_counter()
    cpu = loss_and_grads(gs_tr.params.to("cpu"), "sage",
                         batch_to(batch, "cpu"), cache_emb=emb.cpu())
    cpu_step_s = time.perf_counter() - t0
    loss_diff = abs(card.loss.item() - cpu.loss.item())
    require(loss_diff <= TRAIN_LOSS_ATOL,
            f"cached card vs CPU loss: {loss_diff}")
    grad_errs = [rel_err(a, b) for a, b in zip(card.grads, cpu.grads)]
    require(max(grad_errs) <= TRAIN_GRAD_RTOL,
            f"cached card vs CPU gradients: {grad_errs}")
    first = {"loss_abs_diff": loss_diff, "loss_atol": TRAIN_LOSS_ATOL,
             "grad_rel_err": grad_errs, "grad_rtol": TRAIN_GRAD_RTOL,
             "cache_rows_hit": int(batch.cache_mask.sum()),
             "host_cpu_loss_and_grads_s": cpu_step_s}
    del card, cpu, batch, emb
    got, run = cached_epoch(gs_tr, True)
    cache_counts["gssamplecache"] = got
    cache_runs["GSSAMPLECACHE"] = {
        "model": "sage 602-128-41", "build": build, "build_launches": built,
        "plans": plans, "first_batch": first,
        "train_device_step_ms_median_after_first": f32_step_ms,
        "train_device_sampled_edges_per_s_steady": dev_edges_per_s, **run}
    del gs_tr
    # (b) GCNSAMPLEPDCACHE (the default route: the device trainer) and
    # GATSAMPLEPDCACHE heads 4 (no K1, no K3: sampled GAT has its own)
    for algo, heads, k1_on_path in (("GCNSAMPLEPDCACHE", 1, True),
                                    ("GATSAMPLEPDCACHE", GAT_TRAIN_HEADS,
                                     False)):
        cfg = dataclasses.replace(dev_cfg, algorithm=algo, heads=heads)
        tr, build, built = build_cached(cfg)
        require(isinstance(tr, DeviceCachedSampleTrainer)
                and built == {"spmm_csr": 4},
                f"{algo}: {type(tr).__name__}, build launched {built}")
        plans = plan_checks(tr)
        got, run = cached_epoch(tr, k1_on_path)
        cache_counts[algo.lower()] = got
        cache_runs[algo] = {"heads": heads, "build": build,
                            "build_launches": built, "plans": plans, **run}
        del tr
    # (c) GCNSAMPLEPDCACHE with PD_REFRESH:host: the host sampler's cached
    # trainer, its first 3 steps (one super-batch boundary)
    host_pd, build, built = build_cached(dataclasses.replace(
        dev_cfg, algorithm="GCNSAMPLEPDCACHE", pd_refresh="host"))
    require(isinstance(host_pd, CachedSampleTrainer)
            and host_pd.features_on_device and built == {"spmm_csr": 4},
            f"PD_REFRESH:host: {type(host_pd).__name__}, build launched "
            f"{built}")
    host_pd.train_nids = host_pd.train_nids[:3 * TRAIN_BATCH]
    host_pd.timers = PhaseTimer()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, edges = host_pd.train_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    got = {n: c for n, c in counts().items() if c}
    require(np.isfinite(loss), f"PD_REFRESH:host loss {loss}")
    require(got == k1_expect(3, 0), f"PD_REFRESH:host launched {got}")
    require(host_pd.w_queue.version == 0, "PD_REFRESH:host published "
            f"{host_pd.w_queue.version + 1} weight versions in one SB")
    cache_counts["pd_refresh_host"] = got
    cache_runs["GCNSAMPLEPDCACHE PD_REFRESH:host"] = {
        "steps": 3, "build": build, "build_launches": built,
        "step_s": epoch_s / 3, "loss": loss, "edges": edges,
        "sampled_edges_per_s": edges / epoch_s,
        "hit_rate": host_pd.cache_hit_rate,
        "staleness_queue_version": host_pd.w_queue.version,
        "phase_totals_s": dict(host_pd.timers.totals), "launches": got}
    del host_pd
    # (d) GSSAMPLEPDCACHE past the device's memory: HBM_BUDGET below int8
    # residency beside the aggregates, so FeaturesExceedHbm sends it to the
    # host-refreshed trainer with host features, a per-SB feature cache and
    # host aggregates (no K2); its first 3 steps
    far, build, built = build_cached(dataclasses.replace(
        dev_cfg, algorithm="GSSAMPLEPDCACHE", hbm_budget=BEYOND_BUDGET,
        feature_cache_rate=0.2, feature_cache_plan="per_sb"))
    require(isinstance(far, CachedSampleTrainer)
            and not far.features_on_device and far._fc_sb_caches is not None
            and built == {},
            f"beyond device memory: {type(far).__name__}, on device "
            f"{far.features_on_device}, build launched {built}")
    # the staged feature rows and the aggregates share the budget
    far_aggs = sum(c.cache_agg.numel() * c.cache_agg.element_size()
                   for c in far.sb_caches)
    far_rows = far.feat_cache.dev_hot
    far_staged = far_rows.numel() * far_rows.element_size()
    require(0 < far_staged and far_staged + far_aggs <= BEYOND_BUDGET,
            f"beyond device memory: {far_staged} bytes of feature rows "
            f"beside {far_aggs} of aggregates exceed {BEYOND_BUDGET}")
    far.train_nids = far.train_nids[:3 * TRAIN_BATCH]
    far.timers = PhaseTimer()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, edges = far.train_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    got = {n: c for n, c in counts().items() if c}
    require(np.isfinite(loss), f"beyond-device loss {loss}")
    require(got == k1_expect(3, 0), f"beyond-device steps launched {got}")
    # shipped may equal full: the miss buffer is padded to a power of two
    # times 128 rows, capped at the source axis, which a 10,000-seed
    # batch's bottom hop nearly covers
    fc_rate, shipped, full = far.feature_cache_stats
    require(0 < fc_rate < 1 and 0 < shipped <= full,
            f"feature cache: hit rate {fc_rate}, {shipped} of {full} bytes")
    cache_counts["beyond_device"] = got
    cache_runs["GSSAMPLEPDCACHE beyond device memory"] = {
        "steps": 3, "hbm_budget": BEYOND_BUDGET, "build": build,
        "build_launches": built,
        "feature_cache_rows": int(far.feat_cache.hot_ids.size),
        "feature_cache_bytes": far_staged, "aggregate_bytes": far_aggs,
        "step_s": epoch_s / 3, "loss": loss, "edges": edges,
        "hit_rate": far.cache_hit_rate, "feature_cache_hit_rate": fc_rate,
        "feature_bytes_shipped": shipped, "feature_bytes_full": full,
        "phase_totals_s": dict(far.timers.totals), "launches": got}
    del far
    emit({"phase": "train_cache", "runs": cache_runs,
          "k2_pushdown_shape": pd_shape,
          "phase_s": time.perf_counter() - cache_t0})

    # ---- 19. data-parallel training (main paths, counted) -----------------
    dp_t0 = time.perf_counter()
    group = make_group()
    require(group.backend == "nccl" and group.world_size == 1
            and group.device.type == "cuda",
            f"the data-parallel group is {group}")
    try:
        DataGroup(rank=0, world_size=1, device=torch.device("cpu"),
                  backend="nccl")
    except ValueError:
        pass
    else:
        raise RuntimeError("chip_smoke: an NCCL rank on the CPU did not "
                           "raise")
    dp_runs, dp_counts = {}, {}

    def dp_epoch(tr, label):
        """One epoch from zeroed counts → (the launches, a summary row):
        finite losses, the last 4 steps' mean below the first's, 16
        steps; the gradient all-reduce's and the feature fetch's bytes and
        device time a step."""
        base = getattr(tr, "base", tr)
        tr_group = getattr(tr, "group", None)
        if tr_group is not None:
            tr_group.timed = True
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, acc, edges = tr.train_epoch()
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        got = {n: c for n, c in counts().items() if c}
        losses = base.step_losses
        steps = len(base.step_ms)
        require(all(np.isfinite(losses)) and np.isfinite(loss),
                f"{label}: non-finite loss {losses}")
        require(steps == 16, f"{label}: {steps} steps, expected 16")
        require(float(np.mean(losses[-4:])) < losses[0],
                f"{label}: loss did not fall: {losses}")
        med = statistics.median(base.step_ms[1:])
        row = {"steps": steps, "step_ms": base.step_ms,
               "step_ms_median_after_first": med, "losses": losses,
               "epoch_s": epoch_s, "edges_per_epoch": edges,
               "sampled_edges_per_s_steady": edges / steps / (med / 1e3),
               "train_acc": acc, "launches": got}
        regions = tr_group.region_times() if tr_group is not None else {}
        for tag, rows in regions.items():
            require(len(rows) == steps, f"{label}: {len(rows)} {tag} "
                                        f"regions in {steps} steps")
            row[tag] = {"bytes_a_step": rows[0][0],
                        "ms_a_step_median": statistics.median(
                            ms for _, ms in rows),
                        "ms_total": sum(ms for _, ms in rows)}
        return got, row

    def max_rel(a_params, b_params):
        return max(rel_err(a, b) for a, b in zip(a_params.leaves(),
                                                  b_params.leaves()))

    # (a) *ALLMULTI on the one-rank group against the single-device engine
    # from the same seed: the same per-step losses and parameters.  Sampled
    # GAT's edge ops gather source rows by index, whose backward adds into
    # the rows with float atomics: on the H100 the pair's first steps agree
    # and the second does not, so the GAT pair is compared under torch's
    # deterministic algorithms (a sorted scatter-add, about 44x slower a
    # step there), both sides, and timed again in the default mode
    def dp_pair(multi, single, heads):
        """(the *ALLMULTI trainer's params, its launches and row, the
        single engine's params, launches and row), one epoch each."""
        sd = build_trainer(dataclasses.replace(dev_cfg, algorithm=single,
                                               heads=heads), ds)
        sd_got, sd_row = dp_epoch(sd, single)
        sd_params = sd.params
        del sd
        t0 = time.perf_counter()
        tr = build_trainer(dataclasses.replace(dev_cfg, algorithm=multi,
                                               heads=heads), ds)
        build_s = time.perf_counter() - t0
        require(type(tr) is DeviceDataParallelTrainer
                and tr.group.world_size == 1,
                f"{multi} built {type(tr).__name__}")
        got, row = dp_epoch(tr, multi)
        row["build_s"] = build_s
        return tr.params, got, row, sd_params, sd_got, sd_row

    replicated = None
    for multi, single, heads in (
            ("GCNSAMPLEALLMULTI", "GCNSAMPLEALLGPU", 1),
            ("GATSAMPLEALLMULTI", "GATSAMPLEALLGPU", GAT_TRAIN_HEADS)):
        deterministic = heads > 1
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        params, got, row, sd_params, sd_got, sd_row = dp_pair(multi, single,
                                                              heads)
        torch.use_deterministic_algorithms(False)
        want = k1_expect(16, 0) if heads == 1 else {}
        require(got == want == sd_got,
                f"{multi} launched {got}, {single} {sd_got}, expected {want}")
        require(row["losses"] == sd_row["losses"],
                f"{multi} per-step losses {row['losses']} differ from "
                f"{single}'s {sd_row['losses']}")
        err = max_rel(params, sd_params)
        require(err <= DP_PARAM_RTOL, f"{multi} parameters differ from "
                                      f"{single}'s by {err}")
        bit = all(torch.equal(a, b) for a, b in zip(params.leaves(),
                                                     sd_params.leaves()))
        dp_counts[multi.lower()] = got
        run = {"heads": heads, "deterministic_algorithms": deterministic,
               **row, "params_max_rel_diff": err,
               "params_bit_identical": bit, "single_engine": single,
               "single_step_ms_median_after_first":
               sd_row["step_ms_median_after_first"],
               "single_sampled_edges_per_s_steady":
               sd_row["sampled_edges_per_s_steady"]}
        if deterministic:
            _, got, row, _, sd_got, sd_row = dp_pair(multi, single, heads)
            require(got == sd_got == want,
                    f"{multi} (default mode) launched {got}")
            run["default_mode"] = {
                "step_ms_median_after_first":
                row["step_ms_median_after_first"],
                "sampled_edges_per_s_steady":
                row["sampled_edges_per_s_steady"],
                "single_step_ms_median_after_first":
                sd_row["step_ms_median_after_first"],
                "single_sampled_edges_per_s_steady":
                sd_row["sampled_edges_per_s_steady"],
                "grad_all_reduce": row["grad_all_reduce"]}
        dp_runs[multi] = run
        if heads == 1:
            replicated = params
        del params, sd_params
    # (b) SHARD_FEATURES:1: the rows fetched from their owner rank (here
    # the one rank), the same epoch, the parameters the replicated run's
    t0 = time.perf_counter()
    tr = build_trainer(dataclasses.replace(
        dev_cfg, algorithm="GCNSAMPLEALLMULTI", shard_features=True), ds)
    build_s = time.perf_counter() - t0
    require(tr.base.dev_features is None and tr.feat_local is not None,
            "SHARD_FEATURES kept the replicated features")
    got, row = dp_epoch(tr, "GCNSAMPLEALLMULTI SHARD_FEATURES:1")
    require(got == k1_expect(16, 0) and "feature_fetch" in row,
            f"SHARD_FEATURES launched {got}")
    err = max_rel(tr.params, replicated)
    require(err <= DP_PARAM_RTOL,
            f"SHARD_FEATURES parameters differ from replicated by {err}")
    dp_counts["gcnsampleallmulti_sharded"] = got
    dp_runs["GCNSAMPLEALLMULTI SHARD_FEATURES:1"] = {
        "build_s": build_s, **row, "params_max_rel_diff_vs_replicated": err,
        "params_bit_identical": all(torch.equal(a, b) for a, b in zip(
            tr.params.leaves(), replicated.leaves()))}
    del tr, replicated
    # (c) *PCMULTI: the device-cached trainer with one global hot set (one
    # K2 launch at build), its aggregate against K2's plain version
    for algo, heads, k1_on_path in (
            ("GCNSAMPLEPCMULTI", 1, True), ("GSSAMPLEPCMULTI", 1, True),
            ("GATSAMPLEPCMULTI", GAT_TRAIN_HEADS, False)):
        tr, build, built = build_cached(dataclasses.replace(
            dev_cfg, algorithm=algo, heads=heads))
        require(type(tr) is DeviceCachedDataParallelTrainer
                and len(tr.base.sb_caches) == 1 and built == {"spmm_csr": 1},
                f"{algo}: {type(tr).__name__}, build launched {built}")
        plans = plan_checks(tr.base)
        got, row = dp_epoch(tr, algo)
        want = k1_expect(16, 0) if k1_on_path else {}
        require(got == want, f"{algo} launched {got}, expected {want}")
        require(tr.base.refreshes == 4 and 0 < tr.cache_hit_rate < 1,
                f"{algo}: {tr.base.refreshes} refreshes, hit rate "
                f"{tr.cache_hit_rate}")
        dp_counts[algo.lower()] = got
        dp_runs[algo] = {"heads": heads, "build": build,
                         "build_launches": built, "plans": plans, **row,
                         "hit_rate": tr.cache_hit_rate,
                         "refreshes": tr.base.refreshes}
        del tr
    # (d) GCNSAMPLEPCMULTI under PD_REFRESH:host: the host cached trainer
    # (one global hot set) under the host-sampled data-parallel wrapper,
    # its first 3 steps
    tr, build, built = build_cached(dataclasses.replace(
        dev_cfg, algorithm="GCNSAMPLEPCMULTI", pd_refresh="host"))
    require(type(tr) is DataParallelTrainer
            and isinstance(tr.base, CachedSampleTrainer)
            and not tr.base.per_sb and built == {"spmm_csr": 1},
            f"PCMULTI PD_REFRESH:host: {type(tr).__name__}, build launched "
            f"{built}")
    tr.base.train_nids = tr.base.train_nids[:3 * TRAIN_BATCH]
    tr.group.timed = True
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, edges = tr.train_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    got = {n: c for n, c in counts().items() if c}
    require(np.isfinite(loss) and got == k1_expect(3, 0),
            f"PCMULTI PD_REFRESH:host: loss {loss}, launched {got}")
    reduce_rows = tr.group.region_times()["grad_all_reduce"]
    require(len(reduce_rows) == 3, f"{len(reduce_rows)} all-reduces in 3 "
                                   "steps")
    dp_counts["pcmulti_pd_refresh_host"] = got
    dp_runs["GCNSAMPLEPCMULTI PD_REFRESH:host"] = {
        "steps": 3, "build": build, "build_launches": built,
        "step_s": epoch_s / 3, "loss": loss, "edges": edges,
        "sampled_edges_per_s": edges / epoch_s,
        "hit_rate": tr.cache_hit_rate,
        "grad_all_reduce": {"bytes_a_step": reduce_rows[0][0],
                            "ms_a_step": [ms for _, ms in reduce_rows]},
        "launches": got}
    del tr
    torch.distributed.destroy_process_group()
    emit({"phase": "train_dp", "group": {
        "backend": group.backend, "world_size": group.world_size,
        "device": str(group.device)}, "runs": dp_runs,
        "param_rtol": DP_PARAM_RTOL,
        "phase_s": time.perf_counter() - dp_t0})

    # ---- 20. the CLI on the shipped Cora configs (subprocesses) ------------
    extras_t0 = time.perf_counter()
    cli_dir = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(cli_dir, ignore_errors=True)
    cli_dir.mkdir(parents=True)

    def cli(cfg_name, *flags):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "sgnn_tpu_torch", f"configs/{cfg_name}",
             *flags], cwd=ROOT, capture_output=True, text=True, timeout=300)
        lines = [ln for ln in out.stderr.splitlines()
                 if "accuracy" in ln or "eval:" in ln or "final" in ln]
        return out, {"cfg": cfg_name, "flags": list(flags),
                     "rc": out.returncode,
                     "wall_s": time.perf_counter() - t0,
                     "accuracies": [ln.split("] ", 1)[-1] for ln in lines]}

    def read_report(json_path):
        with open(json_path) as f:
            return json.load(f)

    ck, runs, outs = str(cli_dir / "ckpt"), [], []
    for cfg_name, flags in (
            ("gs_cora_sample.cfg", ("--epochs", "2", "--checkpoint-dir", ck,
                                    "--report-out", str(cli_dir / "r1.json"))),
            ("gs_cora_sample.cfg", ("--epochs", "3", "--checkpoint-dir", ck,
                                    "--resume", "--report-out",
                                    str(cli_dir / "r2.json"))),
            ("gs_cora_sample.cfg", ("--infer", ck, "--predictions-out",
                                    str(cli_dir / "p.npy"))),
            ("gcn_cora_fullbatch.cfg", ("--epochs", "5", "--exact-eval",
                                        "--profile", str(cli_dir / "trace"))),
            ("gat_cora_sample.cfg", ("--epochs", "2", "--exact-eval"))):
        out, row = cli(cfg_name, *flags)
        require(out.returncode == 0, f"CLI {cfg_name} {flags} exited "
                f"{out.returncode}: {out.stderr[-2000:]}")
        outs.append(out)
        runs.append(row)
    require(len(read_report(cli_dir / "r1.json")["epoch_times"]) == 2,
            "the first CLI run did not train 2 epochs")
    require(len(read_report(cli_dir / "r2.json")["epoch_times"]) == 1
            and "resuming at epoch 2 of 3" in outs[1].stderr,
            "the resumed CLI run did not start at the third epoch")
    pred = np.load(cli_dir / "p.npy")
    require(pred.shape == (2708, 7) and float(np.abs(
        np.exp(pred).sum(1) - 1).max()) <= 1e-3,
            f"--infer predictions {pred.shape} do not sum to 1")
    require((cli_dir / "trace" / "trace.json").stat().st_size > 0,
            "--profile wrote no trace")
    out, row = cli("gcn_cora_sample.cfg")
    require(out.returncode == 0 and "final: train" in out.stderr,
            f"the PD-cache cfg exited {out.returncode}: {out.stderr[-2000:]}")
    runs.append(row)
    shutil.rmtree(cli_dir, ignore_errors=True)
    emit({"phase": "cli", "runs": runs,
          "phase_s": time.perf_counter() - extras_t0})

    # ---- 21. vertex-partitioned whole-graph training (main path, counted) --
    # (a) the whole sharded trainer on a one-rank NCCL graph group: each
    # engine under both halos against the single-device trainer from the
    # same seed; (b) the shard-local layers of a 4-way partition, one shard
    # at a time on this one card, against their plain versions and the
    # single-device layer's rows
    part_t0 = time.perf_counter()
    group = make_group(graph=1)
    require(group.backend == "nccl" and group.world_size == 1
            and group.graph == 1 and group.device.type == "cuda",
            f"the graph group is {group}")
    group.timed = True

    def part_epochs(tr, algo):
        """PART_EPOCHS epochs → (their rows, the launches of all of them,
        each collective's (calls, bytes, ms) an epoch); each epoch's
        launches exactly one whole-graph epoch's."""
        hist, regions, total = [], [], dict.fromkeys(counted, 0)
        for _ in range(PART_EPOCHS):
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tr.train_epoch()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            now = counts()
            got = {n: now[n] - before[n] for n in now if now[n] != before[n]}
            require(got == per_epoch[algo],
                    f"{algo} epoch launched {got}, expected {per_epoch[algo]}")
            for n_, c in got.items():
                total[n_] += c
            hist.append({"ms": ms, "loss": out[0], "train": out[1],
                         "val": out[2], "test": out[3]})
            regions.append({tag: (len(rows), sum(b for b, _ in rows),
                                  sum(m for _, m in rows))
                            for tag, rows in group.region_times().items()})
        return hist, total, regions

    def part_summary(hist, regions):
        med = statistics.median(h["ms"] for h in hist[1:])
        coll = {}
        for tag in regions[0]:
            calls, nbytes, _ = regions[0][tag]
            coll[tag] = {"calls_an_epoch": calls, "bytes_an_epoch": nbytes,
                         "ms_an_epoch_median_after_first": statistics.median(
                             r[tag][2] for r in regions[1:]),
                         "ms_an_epoch": [r[tag][2] for r in regions]}
        return med, coll

    part_runs, part_counts = [], dict.fromkeys(counted, 0)
    for algo, heads in FULL_ENGINES:
        cfg = dataclasses.replace(full_cfg(algo, heads, v, 0.5),
                                  epochs=PART_EPOCHS)
        spec = engine_from_config(cfg)
        group.timed = False
        t0 = time.perf_counter()
        single = FullBatchTrainer(cfg, ds, family=spec.family,
                                  weight_kind=spec.weight_kind, adj=adj)
        single_build = time.perf_counter() - t0
        s_hist, _, _ = part_epochs(single, algo)
        group.region_times()
        s_med = statistics.median(h["ms"] for h in s_hist[1:])
        s_params = [p.clone() for p in single.params.leaves()]
        s_pred = single.predict()
        del single
        group.timed = True
        for halo in ("all_gather", "targeted"):
            t0 = time.perf_counter()
            tr = FullBatchTrainer(cfg, ds, family=spec.family,
                                  weight_kind=spec.weight_kind, mesh=group,
                                  halo=halo, adj=adj)
            build_s = time.perf_counter() - t0
            require(tr.shard.rows == tr.sharded.rows_per_shard >= v
                    and tr.owned == v
                    and (tr.shard.send_idx is not None) == (
                        halo == "targeted"),
                    f"{algo} {halo}: shard of {tr.shard.rows} rows")
            group.region_times()
            reset_counts()
            hist, got, regions = part_epochs(tr, algo)
            before = counts()
            pred = tr.predict()
            now = counts()
            pred_got = {n: now[n] - before[n] for n in now
                        if now[n] != before[n]}
            for n_, c in counts().items():
                part_counts[n_] += c
            group.region_times()
            require(pred_got == per_predict[algo],
                    f"{algo} {halo} predict() launched {pred_got}")
            losses = [h["loss"] for h in hist]
            require(bool(np.isfinite(losses).all())
                    and losses[-1] < losses[0],
                    f"{algo} {halo} losses not finite or not falling: "
                    f"{losses}")
            rows_diff = max(abs(h[k] - s[k]) for h, s in zip(hist, s_hist)
                            for k in ("loss", "train", "val", "test"))
            loss_rel = max(abs(h["loss"] - s["loss"]) / abs(s["loss"])
                           for h, s in zip(hist, s_hist))
            p_abs = max((a - b).abs().max().item()
                        for a, b in zip(tr.params.leaves(), s_params))
            p_rel = max(rel_err(a, b) for a, b in zip(tr.params.leaves(),
                                                      s_params))
            pred_abs = float(np.abs(pred - s_pred).max())
            require(loss_rel <= DP_PARAM_RTOL and p_rel <= DP_PARAM_RTOL
                    and pred_abs <= DP_PARAM_RTOL * float(
                        np.abs(s_pred).max()),
                    f"{algo} {halo}: sharded against single: losses "
                    f"{loss_rel}, parameters {p_rel}, predict {pred_abs}")
            med, coll = part_summary(hist, regions)
            part_runs.append({
                "engine": algo, "heads": heads, "halo": halo, "V": v,
                "E": e, "rows": tr.shard.rows, "drop": 0.5,
                "epochs": hist, "epoch_ms_median_after_first": med,
                "single_epoch_ms_median_after_first": s_med,
                "single_epochs": s_hist,
                "max_abs_diff_epoch_rows": rows_diff,
                "loss_max_rel_diff": loss_rel,
                "params_max_abs_diff": p_abs,
                "params_max_rel_diff": p_rel,
                "params_bit_identical": p_abs == 0.0,
                "predict_max_abs_diff": pred_abs,
                "launches": {n_: c for n_, c in got.items() if c},
                "collectives": coll, "build_s": build_s,
                "single_build_s": single_build,
                "shard_transpose_s": tr.transpose_s})
            del tr, pred
        del s_params, s_pred
    torch.distributed.destroy_process_group()
    for kname in ("spmm_csr", "spmm_csr_bwd", "gat_aggregate", "gat_bwd_src",
                  "gat_bwd_dst"):
        require(part_counts[kname] > 0,
                f"the sharded trainer never launched {kname}")

    # (b) a degree-balanced 4-way partition, both halo plans, each shard's
    # layers fed what the exchange would deliver from the whole table
    n_parts = 4
    t0 = time.perf_counter()
    plans = {"all_gather": shard_graph(adj, n_parts, w_h, balance="degree"),
             "targeted": build_targeted_halo(adj, n_parts, w_h,
                                             balance="degree")}
    plan_s = time.perf_counter() - t0
    sg = plans["all_gather"]
    rows_p, h_pad = sg.rows_per_shard, plans["targeted"].halo_pad
    meta = sg.shard_meta
    shards_info = [{"part": p, "owned": int(meta[p, 1]),
                    "start": int(meta[p, 0]), "edges": int(sg.src[p].size),
                    "rows_per_shard": rows_p, "H_pad": h_pad,
                    "targeted_rows_received": int(
                        plans["targeted"].send_cnt[:, p].sum())}
                   for p in range(n_parts)]
    halo_bytes = {f"F={f}": {"all_gather": (n_parts - 1) * rows_p * f * 4,
                             "targeted": (n_parts - 1) * h_pad * f * 4}
                  for f in (128, 41)}
    slots = torch.from_numpy(sg.slot_of_vertex).to(dev)

    def slot_table(full):
        out = torch.zeros((n_parts * rows_p, full.shape[1]),
                          dtype=full.dtype, device=dev)
        out[slots] = full
        return out

    def to_slots(plan, p, grad_ext):
        """A shard's gradient of its exchanged rows added into the slot
        table's rows they came from (the exchange's backward, in one
        process; padding rows carry zeros)."""
        if plan is sg:
            return grad_ext
        idx = [np.arange(p * rows_p, (p + 1) * rows_p)] + [
            q * rows_p + plan.send_idx[q, p].astype(np.int64)
            for q in range(n_parts)]
        idx = torch.from_numpy(np.concatenate(idx)).to(dev)
        return torch.zeros((n_parts * rows_p, grad_ext.shape[1]),
                           device=dev).index_add_(0, idx, grad_ext)

    def rows_of(full, p):
        """Shard p's [rows, ...] block of a whole-graph table."""
        out = torch.zeros((rows_p, *full.shape[1:]), device=dev)
        out[:int(meta[p, 1])] = full[int(meta[p, 0]):int(meta[p, :].sum())]
        return out

    def cosine(x, y):
        x, y = x.double().flatten(), y.double().flatten()
        return float(x @ y / (x.norm() * y.norm()).clamp_min(1e-300))

    # the single-device layers at the same shapes: inputs, outputs, times
    full_csr = csr_from_numpy(adj.indptr, src_h, w_h, v, dev)
    full_csr_t = csr_from_numpy(rowptr_th, col_th, w_th, v, dev)
    k2_in, gat_in = {}, {}
    for feat in (128, 41):
        x_full = torch.randn(v, feat, generator=gen).to(dev)
        g_full = torch.randn(v, feat, generator=gen).to(dev)
        k2_in[feat] = {
            "x": x_full, "g": g_full, "x_slot": slot_table(x_full),
            "out": spmm_csr_cuda(x_full, *full_csr),
            "dx": spmm_csr_bwd_cuda(g_full, *full_csr_t),
            "ms_fwd": time_ms(lambda: spmm_csr_cuda(x_full, *full_csr), 20),
            "ms_bwd": time_ms(lambda: spmm_csr_bwd_cuda(g_full,
                                                        *full_csr_t), 20)}
    for feat, heads in ((128, GAT_TRAIN_HEADS), (41, 1)):
        ht_full = torch.randn(v, feat, generator=gen).to(dev)
        a = (torch.randn(2 * feat, generator=attn_gen)
             * GAT_ATTN_SCALE).to(dev)
        ts_full, td_full = pack_score_tables(ht_full, a[:feat], a[feat:],
                                             heads)
        gg_full = torch.randn(v, feat, generator=gen).to(dev)
        h_full, z_full = gat_aggregate_cuda(ht_full, ts_full, td_full,
                                            full_csr.rowptr, full_csr.col,
                                            heads)
        gz_full, rz_full = gat_bwd_operands(gg_full, h_full, z_full, heads)
        b1 = (ht_full, ts_full, gz_full, td_full, rz_full,
              full_csr_t.rowptr, full_csr_t.col, heads)
        b2 = (ht_full, ts_full, gz_full, td_full, rz_full, full_csr.rowptr,
              full_csr.col, heads)
        gat_in[feat] = {
            "heads": heads, "ht_slot": slot_table(ht_full),
            "ts_slot": slot_table(ts_full), "td": td_full, "g": gg_full,
            "h": h_full,
            "ms_k3": time_ms(lambda: gat_aggregate_cuda(
                ht_full, ts_full, td_full, full_csr.rowptr, full_csr.col,
                heads), 20),
            "ms_b1": time_ms(lambda: gat_bwd_src_cuda(*b1), 20),
            "ms_b2": time_ms(lambda: gat_bwd_dst_cuda(*b2), 20)}
        del ht_full, ts_full, h_full, z_full, gz_full, rz_full, b1, b2
    layer_rows = []
    for halo, plan in plans.items():
        gat_plan = plan._replace(weight=tuple(np.ones_like(x)
                                              for x in plan.weight))
        dx_sum = {feat: 0 for feat in k2_in}
        for p in range(n_parts):
            shard = shard_on_device(plan, p, dev)
            gshard = shard_on_device(gat_plan, p, dev)
            mine = slice(int(meta[p, 0]), int(meta[p, :].sum()))
            size = int(meta[p, 1])
            for feat, k in k2_in.items():
                # K2's forward and backward over the shard's CSRs
                # a leaf of its own (the all_gather halo delivers the
                # table itself)
                ext = exchange_reference(plan, p, k["x_slot"]).detach()
                ext.requires_grad_()
                g = rows_of(k["g"], p)
                out = local_aggregate(ext, shard)
                out.backward(g)
                torch.cuda.synchronize()
                errs = [rel_err(out, spmm_csr_plain(ext.detach(),
                                                    *shard.csr)),
                        rel_err(ext.grad, spmm_csr_plain(g, *shard.csr_t)),
                        rel_err(out[:size], k["out"][mine])]
                require(max(errs) <= TOL["float32"],
                        f"shard {p} {halo} K2 F={feat}: {errs}")
                dx_sum[feat] = dx_sum[feat] + to_slots(plan, p, ext.grad)
                x_ext = ext.detach()
                layer_rows.append({
                    "kernel": "spmm_csr, spmm_csr_bwd", "halo": halo,
                    "part": p, "F": feat, "sources": int(x_ext.shape[0]),
                    "rel_err_plain": errs[:2],
                    "rel_err_single_rows": errs[2],
                    "ms": [time_ms(lambda: spmm_csr_cuda(x_ext, *shard.csr),
                                   20),
                           time_ms(lambda: spmm_csr_bwd_cuda(
                               g, *shard.csr_t), 20)],
                    "single_ms": [k["ms_fwd"], k["ms_bwd"]]})
                del ext, x_ext, out, g
            for feat, k in gat_in.items():
                # K3 forward, K4's B1 and B2 backward over the shard's CSRs
                heads = k["heads"]
                leaves = [exchange_reference(plan, p, k["ht_slot"]).detach(),
                          exchange_reference(plan, p, k["ts_slot"]).detach(),
                          rows_of(k["td"], p)]
                for t in leaves:
                    t.requires_grad_()
                g = rows_of(k["g"], p)
                out = local_gat(*leaves, gshard, heads)
                out.backward(g)
                torch.cuda.synchronize()
                ext, ts_ext, td = (t.detach() for t in leaves)
                ref, z = gat_aggregate_plain(ext, ts_ext, td,
                                             gshard.csr.rowptr,
                                             gshard.csr.col, heads)
                gz, rz = gat_bwd_operands(g, ref, z, heads)
                b1 = (ext, ts_ext, gz, td, rz, gshard.csr_t.rowptr,
                      gshard.csr_t.col, heads)
                b2 = (ext, ts_ext, gz, td, rz, gshard.csr.rowptr,
                      gshard.csr.col, heads)
                ref_grads = (*gat_bwd_src_plain(*b1), gat_bwd_dst_plain(*b2))
                cos = [cosine(t.grad, r) for t, r in zip(leaves, ref_grads)]
                errs = [rel_err(out, ref), rel_err(out[:size], k["h"][mine])]
                require(max(errs) <= TOL["float32"] and min(cos) > 0.999,
                        f"shard {p} {halo} K3/K4 F={feat} H={heads}: "
                        f"{errs}, cosines {cos}")
                layer_rows.append({
                    "kernel": "gat_aggregate, gat_bwd_src, gat_bwd_dst",
                    "halo": halo, "part": p, "F": feat, "H": heads,
                    "sources": int(ext.shape[0]),
                    "rel_err_plain_fwd": errs[0],
                    "rel_err_single_rows": errs[1],
                    "cosine_plain_grads": cos,
                    "rel_err_plain_grads": [rel_err(t.grad, r) for t, r in
                                            zip(leaves, ref_grads)],
                    "ms": [time_ms(lambda: gat_aggregate_cuda(
                               ext, ts_ext, td, gshard.csr.rowptr,
                               gshard.csr.col, heads), 20),
                           time_ms(lambda: gat_bwd_src_cuda(*b1), 20),
                           time_ms(lambda: gat_bwd_dst_cuda(*b2), 20)],
                    "single_ms": [k["ms_k3"], k["ms_b1"], k["ms_b2"]]})
                del leaves, ext, ts_ext, td, out, ref, z, gz, rz, b1, b2
            del shard, gshard
        for feat, k in k2_in.items():
            # the shards' input gradients, summed: the single backward's
            err = rel_err(dx_sum[feat][slots], k["dx"])
            require(err <= TOL["float32"], f"{halo} K2 backward summed over "
                                           f"the shards F={feat}: {err}")
            layer_rows.append({"kernel": "spmm_csr_bwd, summed over the "
                               "shards", "halo": halo, "F": feat,
                               "rel_err_single": err})
    del full_csr, full_csr_t, slots, k2_in, gat_in, dx_sum
    emit({"phase": "train_partition", "model": "602-128-41",
          "param_rtol": DP_PARAM_RTOL,
          "a_one_rank_graph_group": {
              "group": {"backend": group.backend, "world_size": 1,
                        "device": str(group.device)},
              "runs": part_runs, "launches": {
                  n_: c for n_, c in part_counts.items() if c}},
          "b_four_shards_one_card": {
              "balance": "degree", "plan_build_s": plan_s,
              "shards": shards_info,
              "halo_bytes_received_a_rank_a_layer": halo_bytes,
              "layers": layer_rows},
          "phase_s": time.perf_counter() - part_t0})

    # ---- 21-22. the multi-host drivers and the renumbered graph (main
    # paths, counted) -----------------------------------------------------
    ctx = types.SimpleNamespace(
        dev=dev, ds=ds, adj=adj, time_ms=time_ms, rel_err=rel_err,
        reset_counts=reset_counts, counts=counts, first_batch=first_batch,
        full_cfg=full_cfg, per_epoch=per_epoch, k1_expect=k1_expect,
        dev_cfg=dev_cfg, host_steps=host_steps)
    new_paths = {"train_multihost": phase_train_multihost(ctx),
                 "reorder": phase_reorder(ctx)}
    for phase, paths in new_paths.items():
        for kname in ("spmm_csr", "spmm_csr_bwd", "gat_aggregate",
                      "gat_bwd_src", "gat_bwd_dst", "gather_agg_fwd",
                      "gather_agg_bwd_dx", "block_transpose"):
            require(any(got.get(kname, 0) for got in paths.values()),
                    f"{phase} never launched {kname}")
    del ctx

    # ---- 24. kernels -------------------------------------------------------
    # one logprobs() pass's work: the F=128 and the F=41 f32 SpMMs
    per_pass = [t for t in timings if t["dtype"] == "float32"]

    def total(rows, k):
        vals = [t[k] for t in rows]
        return None if None in vals else sum(vals)

    def line(name, rows, source, replaces, n, what):
        ms, bound_ms = total(rows, "ms"), total(rows, "bound_ms")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": max(t["max_abs_err"] for t in rows),
                "ms": ms, "plain_ms": total(rows, "plain_ms"),
                "bound_ms": bound_ms,
                "bound_by": ("bytes" if all(t["bound_by"] == "bytes"
                                            for t in rows) else "operations"),
                "library_ms": total(rows, "library_ms"),
                "pct_of_bound": 100.0 * bound_ms / ms, "shapes": what}

    step_shapes = ("one training step's two layers: (D, K, S, F) = " + ", ".join(
        f"({t['D']}, {t['K']}, {t['S']}, {t['F']})" for t in k1_shapes
        if t["name"] == "gather_agg_fwd"))
    kernels = [line("spmm_csr", per_pass, "sgnn_tpu_torch/csrc/spmm.cu",
                    "sgnn_tpu/ops/pallas/mxu_spmm.py:316", launches,
                    f"one f32 logprobs pass: F=128 + F=41 on the {v}-vertex, "
                    f"{e}-edge graph")]
    kernels[0].update(layouts=[t["layout"] for t in per_pass],
                      registers=[t["registers"] for t in per_pass],
                      pushdown_shape=pd_shape)
    for kname, replaces, n, note in (
            ("gather_agg_fwd", "sgnn_tpu/ops/pallas/gather_agg.py:43",
             dev_launches[0], ""),
            ("gather_agg_bwd_dx", "sgnn_tpu/ops/aggregate.py:60",
             dev_launches[1], "; ms includes building the transpose, "
             "library_ms (torch.sparse.mm on a prebuilt transpose) does not"),
            ("block_transpose", "sgnn_tpu/ops/aggregate.py:60",
             transpose_launches, "; dx's transpose alone, also inside "
             "gather_agg_bwd_dx's ms (library_ms null: no single PyTorch "
             "call builds it)"),
            ("gather_agg_bwd_dw", "sgnn_tpu/ops/aggregate.py:60",
             dev_launches[2], "")):
        kernels.append(line(kname, [t for t in k1_shapes
                                    if t["name"] == kname],
                            "sgnn_tpu_torch/csrc/" + (
                                "csr_sum.cuh" if kname == "gather_agg_bwd_dx"
                                else "gather_agg.cu"), replaces, n,
                            step_shapes + note))
        if kname == "gather_agg_bwd_dw":
            kernels[-1]["layouts"] = [t["layout"] for t in k1_shapes
                                      if t["name"] == kname]
    # one single-head f32 GAT logprobs pass: F=128 + F=41, both at H=1
    k3_pass = [t for t in k3_shapes
               if t["dtype"] == "float32" and t["H"] == 1]
    k3_line = line("gat_aggregate", k3_pass, "sgnn_tpu_torch/csrc/gat.cu",
                   "sgnn_tpu/ops/pallas/mxu_gat.py:182", gat_launches,
                   f"one f32 single-head GAT logprobs pass: F=128 + F=41 on "
                   f"the {v}-vertex, {e}-edge graph (library_ms null: no "
                   f"single PyTorch call computes K3; composition_ms is "
                   f"scores + torch.sparse.mm + z)")
    k3_line["composition_ms"] = total(k3_pass, "composition_ms")
    kernels.append(k3_line)
    kernels.append(line(
        "spmm_csr_bwd", k2b_shapes, "sgnn_tpu_torch/csrc/csr_sum.cuh",
        "sgnn_tpu/ops/pallas/mxu_spmm.py:463", full_counts["spmm_csr_bwd"],
        f"one GCN/GSFULLBATCH epoch's backward: F=128 + F=41 f32 on the "
        f"{v}-vertex, {e}-edge graph's transposed CSR"))
    # one GATFULLBATCH (heads 4) epoch's backward: F=128 H=4 + F=41 H=1
    for kname, replaces in (("gat_bwd_src", "sgnn_tpu/ops/pallas/mxu_gat.py:431"),
                            ("gat_bwd_dst", "sgnn_tpu/ops/pallas/mxu_gat.py:431")):
        rows = [t for t in k4_shapes if t["name"] == kname
                and (t["F"], t["H"]) in ((128, GAT_TRAIN_HEADS), (41, 1))]
        k4_line = line(kname, rows, "sgnn_tpu_torch/csrc/gat_bwd.cu",
                       replaces, full_counts[kname],
                       f"one GATFULLBATCH heads-{GAT_TRAIN_HEADS} epoch's "
                       f"backward: F=128 H={GAT_TRAIN_HEADS} + F=41 H=1 f32 "
                       f"on the {v}-vertex, {e}-edge graph (library_ms "
                       f"null: no single PyTorch call computes K4; "
                       f"composition_ms is the backward of K3's plain "
                       f"version under autograd at F=128 + F=41, H=1)")
        k4_line["composition_ms"] = total(
            [t for t in k4_shapes if t["name"] == kname and t["H"] == 1],
            "composition_bwd_ms")
        if kname == "gat_bwd_dst":
            k4_line.update(layouts=[t["layout"] for t in rows],
                           registers=[t["registers"] for t in rows])
        kernels.append(k4_line)
    # one GATSAMPLEALLGPU heads-4 step's two layers, forward + backward
    gs_rows = [{"ms": t["ms"]["fwd"] + t["ms"]["bwd"],
                "plain_ms": t["ms"]["plain_fwd_bwd"], "library_ms": None,
                "max_abs_err": max(t["rel_err"].values()),
                "bound_ms": sum(b["bound_ms"] for b in t["bound"].values()),
                "bound_by": ("bytes" if all(b["bound_by"] == "bytes"
                                            for b in t["bound"].values())
                             else "operations")}
               for t in gat_sampled["layers"]]
    gs_line = line(
        "gat_sampled", gs_rows, "sgnn_tpu_torch/csrc/gat_sampled.cu",
        "sgnn_tpu/models/gnn.py:84 (XLA einsums, no Pallas kernel)",
        gat_sampled_launches,
        "one GATSAMPLEALLGPU heads-4 step's two layers (D, K, S, F, H) = "
        + ", ".join(f"({t['D']}, {t['K']}, {t['S']}, {t['F']}, {t['H']})"
                    for t in gat_sampled["layers"])
        + ", forward + backward (max_abs_err: relative to f64 plain; "
        "library_ms null: no single PyTorch call computes it; "
        "kernels_layer_ms is the layers' attention through the kernels "
        "under autograd)")
    gs_line.update(
        kernels_layer_ms=gat_sampled["ms_per_step"]["layer_kernels"],
        layouts=[t["layout"] for t in gat_sampled["layers"]])
    kernels.append(gs_line)
    # one gat_products step's three layers, forward + backward
    gp_rows = [{"ms": t["ms"]["fwd"] + t["ms"]["bwd"],
                "plain_ms": t["ms"]["plain_fwd_bwd"], "library_ms": None,
                "max_abs_err": max(t["rel_err"].values()),
                "bound_ms": sum(b["bound_ms"] for b in t["bound"].values()),
                "bound_by": ("bytes" if all(b["bound_by"] == "bytes"
                                            for b in t["bound"].values())
                             else "operations")}
               for t in gat_products["layers"]]
    gp_line = line(
        "gat_sampled.products", gp_rows, "sgnn_tpu_torch/csrc/gat_sampled.cu",
        "sgnn_tpu/models/gnn.py:84 (XLA einsums, no Pallas kernel)",
        {k: sum(t["launches"][k] for t in gat_products["layers"])
         for k in ("fwd", "bwd")},
        "one gat_products step's three layers (D, K, S, F, H) = "
        + ", ".join(f"({t['D']}, {t['K']}, {t['S']}, {t['F']}, {t['H']})"
                    for t in gat_products["layers"])
        + " on random blocks, K the 10 sampled slots and the own row's, "
        "forward + backward (max_abs_err: relative to f64 plain; launches: "
        "the wrappers' one call a layer; library_ms null as above)")
    gp_line.update(
        kernels_layer_ms=gat_products["ms_per_step"]["layer_kernels"],
        layouts=[t["layout"] for t in gat_products["layers"]])
    kernels.append(gp_line)
    for kname, rows, source, replaces, what in (
            ("probe_gather_sum", gather_rows, "probe_gather.cu",
             "scripts/profile_vmem_gather.py:57",
             f"E = 2^20, F = 128 f32: shared-memory table T=2048 + "
             f"device-memory tables T=2048, {pr.GATHER_ROWS[1]} and "
             f"{pr.GATHER_ROWS[2]}; all columns by CUDA-graph replay"),
            ("probe_shuffle", shuffle_rows, "probe_gather.cu",
             "scripts/probe_dyngather_shapes.py:34",
             "one call of 64 steps at each of the probe's nine shapes; "
             "library: torch.gather of all 64 steps at once; all columns "
             "by CUDA-graph replay"),
            ("probe_tile_spmm", tile_rows, "probe_tile.cu",
             "scripts/profile_onehot_spmm.py:101",
             "configuration 0 (2^20 edges) + the six bisect cases "
             "(scripts/probe_onehot_parts.py:55,:93,:146; "
             "probe_onehot_parts2.py:57,:83,:110) at 8192 edges each; "
             "library: torch.sparse.mm (index_select for c1); all "
             "columns by CUDA-graph replay; gather_bound_ms counts a slab "
             "row read an edge, as any design on this card reads it; "
             "launches counts calls: a scatter call launches "
             "tile_group_kernel and tile_bucket_sum_kernel, c1's call "
             "tile_gather_kernel"),
            ("probe_gat_tile", gat_rows, "probe_tile.cu",
             "scripts/probe_gat_kernel_parts.py:98",
             f"{pr.GAT_TILES} independent tiles of the probe's shape "
             f"(library_ms null: no single PyTorch call computes it); "
             f"all columns by CUDA-graph replay")):
        kernels.append(line(kname, rows, f"sgnn_tpu_torch/csrc/{source}",
                            replaces, probe_counts[kname], what))
        if kname == "probe_tile_spmm":
            kernels[-1].update(registers=probe_k.tile_sum_resources(),
                               gather_bound_ms=total(rows, "gather_bound_ms"))
    # the launches of each kernel on the paths of the serving and training
    # extras (each counted from zeros; `launches` stays the main path's)
    by_path = {
        "spmm_csr": {"serving+queries": launches,
                     "int8_serving": int8_serve_counts["spmm_csr"],
                     "chunked_layerwise_gcn": chunk_counts["gcn"]["spmm_csr"],
                     "int8_fullbatch": int8_full_counts["spmm_csr"],
                     **{f"{name}_build": run["build_launches"].get(
                         "spmm_csr", 0) for name, run in (
                         ("gssamplecache", cache_runs["GSSAMPLECACHE"]),
                         ("gcnsamplepdcache", cache_runs["GCNSAMPLEPDCACHE"]),
                         ("gatsamplepdcache", cache_runs["GATSAMPLEPDCACHE"]),
                         ("pd_refresh_host", cache_runs[
                             "GCNSAMPLEPDCACHE PD_REFRESH:host"]),
                         ("beyond_device", cache_runs[
                             "GSSAMPLEPDCACHE beyond device memory"]))},
                     **{f"dp_{name.lower().replace(' ', '_').replace(':', '_')}"
                        f"_build": run["build_launches"].get("spmm_csr", 0)
                        for name, run in dp_runs.items()
                        if "build_launches" in run},
                     "train_partition": part_counts["spmm_csr"]},
        "gat_aggregate": {
            "serving_gat": gat_launches,
            "int8_serving": int8_serve_counts["gat_aggregate"],
            "chunked_layerwise_gat": chunk_counts["gat"]["gat_aggregate"],
            "train_partition": part_counts["gat_aggregate"]},
        "spmm_csr_bwd": {"train_full": full_counts["spmm_csr_bwd"],
                         "int8_fullbatch": int8_full_counts["spmm_csr_bwd"],
                         "train_partition": part_counts["spmm_csr_bwd"]},
        **{kname: {"train_full": full_counts[kname],
                   "train_partition": part_counts[kname]}
           for kname in ("gat_bwd_src", "gat_bwd_dst")}}
    # the multi-host drivers' and the renumbered graph's paths
    for phase, paths in new_paths.items():
        for path, got in paths.items():
            for kname, n in got.items():
                if kname in by_path:
                    by_path[kname][f"{phase}_{path}"] = n
    for k in kernels:
        if k["name"] in by_path:
            k["launches_by_path"] = by_path[k["name"]]
        elif k["name"] in ("gather_agg_fwd", "gather_agg_bwd_dx",
                           "block_transpose"):
            k["launches_by_path"] = {
                "train_device": k["launches"],
                "int8_device_sampled": int8_train_counts[k["name"]],
                **{path: got.get(k["name"], 0)
                   for path, got in cache_counts.items()},
                **{f"dp_{path}": got.get(k["name"], 0)
                   for path, got in dp_counts.items()},
                **{f"{phase}_{path}": got.get(k["name"], 0)
                   for phase, paths in new_paths.items()
                   for path, got in paths.items()
                   if got.get(k["name"], 0)}}
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
