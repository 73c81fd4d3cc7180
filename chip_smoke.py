#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``): builds the
six hand-written kernels, holds each serving kernel against its plain
PyTorch version at the serving path's shapes, serves the full-width packed
``ternary-paper`` model through the continuous-batching engine over the
dense slot cache, then over the paged cache with bf16 pages and with int8
pages under page pressure (prefix sharing, copy-on-write, deferrals and
preemptions), and compares the card's logits with the CPU's plain path and
the paged decode step's logits with the dense one's on the same weights.
B5 (paged decode attention) is also held at long rows (the training
slice's 513 to 1024 tokens, off the path), and at both shapes B5 on a
subset of the rows must give those rows' bits among all rows.
Before serving, B4's rows are held independent of M (the first M rows of
one 8192-row X give the same bits as X alone, M 1 to 8192, gated and
ungated). After it, ``mlp_formats`` drives MLP blocks of other formats at
ternary-paper's MLP width through ``layers.mlp_apply``: ``tiled`` packs
with padded words through B4, ``bitplane`` packs through the chain (B7),
and a full-width prefill of the served model with its MLPs re-packed as
``tiled`` against the dense2bit model's greedy tokens.
Then the ``gemm_formats`` phase drives the paper's sparse-GEMM surface
(``weights.pack`` + ``ops.ternary_gemm``) at the paper's sizes: ``tiled``
packs of 4096 x 4096 with 256 x 128 tiles over the paper's sparsities
through the tile-skipping kernels (B2, B3) and the dense one (B1), a K
sweep over the paper's K range (B3, B2 and B1 again), ``bitplane`` packs
through B7 in both modes, and one ``base3`` pack through its plain
``ref`` row (it has no kernel, in ``repro`` neither); then B2 and B3 at
tiles that end inside a 64-deep step and B7 in both modes at ragged
shapes, against their plain versions.
Then the training slice: ``flash_kernel`` holds B6 (flash attention)
against its plain version at ``repro``'s test shapes, hd 128 at S 1024
and the evaluation's (B*H 128, S 1024, hd 64), times it beside each of
SDPA's backends and times the layout copies of ``_full_sequence``, then
checks it at ragged and unequal lengths and at the head edge; the phase
fails when B6's library has no HGMMA (wgmma) in its SASS, or when ptxas
spilled its registers or serialized its wgmmas; ``gradients`` holds the
kernel rows' gradients
(B1, B3, B7 in both modes, B4: the autograd Functions around the kernels)
against the plain rows'; ``train_step_check`` holds the card's first
full-width train step against the CPU's on the same weights and batch,
both in float32; ``train`` trains full-width ``ternary-paper``
with QAT through ``repro_torch.launch.train`` (24 steps, checkpoints every
8), resumes it to step 32 from its checkpoint, and survives one injected
failure under ``TrainSupervisor``; ``eval`` runs ``examples/
train_ternary_lm.py``'s evaluation on the trained state: the QAT model's
loss on a held-out batch with the plain blockwise attention and with B6,
and the packed model's with B1 + B4 + B6.

The serving runs replay the decode step as a CUDA graph, the engine's
default on the card. ``decode_graph`` then drains each serving workload
(dense, paged bf16, paged int8 under pressure) twice in one process, with
the decode step run eagerly and through the graph: the token streams, the
``"cache"`` metrics and the B1/B4/B5 launches (per run and per decode
step) must be equal and one decode step's logits bitwise equal; it prints
tok/s, TPOT p50 and the decode step's wall time (the engine's
``decode_step`` trace spans) of both. ``trace`` exports the dense graph
run's ``Tracer``, validates it with the port's ``validate_events`` and
checks one ``decode_step`` span per decode step and every request's track
from ``submit`` to ``done``. ``profiler`` takes five ``torch.profiler``
traces (a dense decode step eager and graphed, a paged bf16 decode step
graphed, a prefill at M 1024, a QAT train step at the train phase's
shape) and prints each one's host wall, device busy time (the union of
its device intervals), idle share, kernel count, top device ops and the
host ops under the longest idle gaps (the profiler's own cost inflates
the eager steps' host time, so each is also timed without it); a trace
with no device events fails.

``chunked`` serves the three workloads again with chunked prefill (32
prompt tokens a request a step, SLO admission; every window shape (8
slots, 2^i) captured as a CUDA graph at load()): (a) dense and paged
bf16 streams equal the whole-prompt runs' or part at a near tie, and
go on near-greedily (a prefill of the prompt and the chunked stream,
teacher-forced: both streams' tokens at the split and every later
chunked token within LOGIT_TOL, absolute, of the top logit), int8 pages
give equal streams at chunk sizes 32 and 16, every prompt token is
committed, and each decode step and each window replay launches B1 49,
B4 12 and, paged, B5 12; (b) the chunked dense run eagerly and through
the graphs in one process: equal streams, sched metrics and launches,
and one window's logits bitwise; (c) B1 and B4 at the widest window's M (256)
under the "chunk" phase, and B5 at its 256 flattened rows (lengths pos +
j + 1) against its plain version and against 256 one-row calls,
bitwise; (d) open loop: one seeded Poisson schedule (8 req/s) and one
bursty one through a whole-prompt engine and a chunked one, TTFT, TPOT
and queue wait p50/p99 by SLO class, violations, windows, prefills and
the step-time EWMA; (e) one 8 x 32 window under the profiler, eager and
graphed; (f) the graphed chunked run's trace through validate_events
and scripts/trace_report.py.

``tune`` runs the block-shape tuner on the card (the whole script points
the tuner at a fresh cache file, so every other phase plans with the
model and no file): every B1 and B4 key the served engines' load()
plans, and jamba-v0.1-52b's in_proj and lm head at M 8 and 1024, each
candidate tile bitwise equal to the tile its phase took before the tuner
(``FIXED_TILE``) and timed, ``lookup(..., run=...)`` in measure mode
into a temporary cache file, the model's pick with no cache file (at
most ``TUNE["slack"]`` x the fixed tile's time), cuBLAS and the bound;
B2, B3 and B7 at the served shapes the same way (no slack gate: off the
path); then the dense, paged bf16 and chunked workloads under fixed,
model and measured plans, the streams and last logits bitwise equal.
``--only tune`` builds, serves the dense workload and runs this phase
alone; ``--tune-out FILE`` keeps the measured cache.

``faults`` drives the serving fault model, every decode step and window
graphed: (a) dense, paged bf16 and chunked dense serving workloads under
a pinned chaos schedule (NaN logits in one live slot at steps 4, 12, 30
and 45; two page allocations failing at steps 3, 11 and 27, paged; up to
4 retries): every request done, quarantines = injected NaNs = the
requests' attempts, the pools reclaimed, launches per replay unchanged
(B1 49, B4 12, B5 12 paged) and B5's (chunked: all three kernels') =
those per decode step and window, the streams equal to this process's
fault-free runs or split at near ties (``_split_check``: a replay may
prefill in another admission group, so its eager prefill sums in another
order); (b) no retries with NaN at every step: every request failed with
``nan_logits``; (c) a 1 s deadline against steps slowed by 20 ms: the
late requests failed with ``deadline``, queued or live, the others done;
(d) NaN written into one slot's cache between two graph replays: the
captured guard flags that slot alone; (e) the guarded decode step's p50
(decode_graph), device busy and kernels (profiler), reported.

``spec`` serves with speculative decoding, k 4, every draft round and
verify window replayed from its CUDA graph (max_len + 4): the dense
workload with a ``layer_skip`` draft (6 of 12 layers) and a
``resparsify`` draft (nnz 0.125), paged bf16 and paged int8 under
pressure with ``layer_skip``. Each run: the draft and verify replays'
launches (a draft round B1 5 x (4 x 6 + 1) and B4 5 x 6, or 5 x 49 and 5
x 12; a verify window B1 49, B4 12, B5 12 paged), every budget met, B5 12
per round (paged), the pool reclaimed, the streams against the non-spec
runs' of this process (equal or split at near ties, ``_split_check``),
acceptance, mean accepted length, tok/s, TPOT p50, the draft and verify
span p50 and ``rollback_page_reclaims`` beside the non-spec graphed
run's tok/s and TPOT. Then one verify window against 5 graphed
one-token steps from the same cache state (dense and paged bf16: max |d|,
bitwise or not), op by op (B1 at the verify and the prefill tile, B4,
the dense attention and B5 on 40 rows against 5 calls of 8; both tiles
timed at M 40), draft faults at pinned steps (each a plain decode step,
counted) and an acceptance floor no draft reaches (speculation off after
4 rounds), one profiled round, and B1, B4 and B5 at the verify shape (M
40; B5 over 40 rows bitwise against 40 one-row calls).
``modes`` drives the serving modes of the registries and the static
server: (a) the dense workload at max_len 208 (the paged pool's
gathered width, 13 pages of 16) dense, paged bf16 under
``paged_attn="jax"`` and under ``"auto"``, graphed: B5 launched 0 times
under "jax" and 12 a decode step under "auto", the "jax" streams against
the dense ones (equal, or near-tie splits), and one decode step after
the same prefill on both caches with every attention call recorded: the
prefill's and the step's logits bitwise or the first layer whose
attention output differs (its inputs equal or not), and the decode
attention over the dense cache's own K/V as pages, which must be
bitwise; (b) ``ops.fused_mlp``'s rows "pallas" (one B4) and "chain"
(three B1) at M 8 and 1024 within the kernel bound of each other, timed;
(c) the static server at batch 8 on the dense workload (eager; B1 49 and
B4 12 a forward) against the continuous engine's streams under the
near-tie rule; (d) ``sliding_window=64`` (prompts of 128 roll the
64-position cache) in bshd, opt and flat, each through the graphed
engine (B1 49 and B4 12 a replay) and the static server, the bshd
engine's streams the reference for the other five, the graphed decode
step's p50 beside full attention's; (e) B5 with window 64 at the serving
shape and over 40 verify rows, bf16 and int8 pages, bitwise equal to B5
with no window over the same tokens copied into pages of their own, and
within the kernel bound of its plain version (off the path: paged pools
refuse sliding windows).
``families`` serves the MoE, SSM and hybrid families (``FAMILIES``; each
config with ``quantization="ternary"``, drawn from the seed and packed
layer by layer): jamba-v0.1-52b at full widths, one period of 8 layers
(1 attention and 7 SSM mixers, 4 MoE and 4 MLP FFNs), over the dense
cache and the paged pool with bf16 and with int8 pages; mamba2-130m
whole (24 layers, tied embeddings), dense and paged (its pool holds SSM
rows only); mixtral-8x22b at full widths, 2 layers, dense (paged pools
refuse its sliding window); 16 requests at 8 slots, prompts of 128
tokens. Each run drains with every budget of in-range tokens, B1
launched, B4 iff the model has MLP layers and B5 once per attention
layer and decode step (paged); the prefill's and one decode step's
logits through the kernels lie within LOGIT_TOL of the plain path on the
card (``ternary_kernel="xla"``: B1's plain row and the chain), end to
end for jamba and mixtral, and for mamba2 with every block run on the
plain path's input to it, each block's output within FORCED_LAYER_TOL of
the plain one's (its 24 random SSM layers grow a bf16 ulp to ~0.1 of
max|logit|); the free-running kernel path (nothing pinned or forced) lies
within WITNESS_FACTOR times the distance of the plain path with its first
block's input moved one bf16 ulp (the model's own growth), per-layer
curves of both printed; one decode step is bitwise equal eager and
graphed, with its launches counted (the dense one under the profiler:
port kernels against the rest of the device time); mamba2's paged
streams equal its dense ones exactly; jamba's are counted, and one
decode step from the same prefill on both caches, MoE routing pinned, is
held within LOGIT_TOL (bf16 pages) or INT8_LOGIT_TOL (int8 pages): MoE
capacity is per step, so a teacher-forced prefill is not the decode's
function and ``_split_check`` does not apply; the card time to decode
every packed expert bank once is read. MoE routing is discrete (a gate
an ulp away can swap the token an expert's capacity keeps), so every
kernels-vs-plain and paged-vs-dense logit check of a MoE model replays
the reference pass's routing decisions (``_routing``) and reports the
unpinned distance beside it. Then B1 at each model's projections (SSM
in/out, q, k/v, o, lm head), B4 at jamba's MLP (4096 -> 14336) and B5 at
its GQA shape (32 heads over 8, hd 128, bf16 and int8 pages; the served
rows and, off the path, rows of 1024-4096 tokens), at the decode M and
the first prefill group's M, against their plain versions, timed (rows
of the ``kernels`` line with ``"model"``); and a ``families summary:``
line (tok/s, TPOT p50, decode-step p50, launches a step, the profile,
bank decoding).
``frontends`` serves the encoder-decoder and VLM families (``FRONTENDS``;
each config with ``quantization="ternary"``, drawn from the seed and
packed layer by layer) through the static server, which the continuous
engine leaves them to: seamless-m4t-large-v2 whole (24 encoder and 24
decoder layers, d 1024, ff 8192, biases, vocab 256206) and internvl2-76b
at full width with 4 of its 80 layers (d 8192, 64 heads over 8, ff
28672); 8 requests at batch 8, 2048 encoder frames or 1024 vision rows
and 128 text tokens each, budgets {32, 64}; each under attn_impl "flash"
and "pallas". Each: the prefill's and one decode step's logits through
the kernels against the plain path (``family_plain_check``, B1's plain
row, the chain and, under "pallas", blockwise attention for B6), every
budget of in-range tokens, B1 and B4 launched, B6 ``enc_layers`` times a
prefill under "pallas" (the encoder) and never under "flash", B5 never;
the "pallas" streams against the "flash" ones (equal or near-tie
splits); one prefill's and one decode step's launches, the prefill's
wall and its encoder's share, the decode step's p50 and, from one
profiled step, the cross-attention K/V projections' share of its device
time. Then seamless's new kernel shapes against their plain versions,
timed (B1 at the cross K/V, M 16384 with a bias, and at the lm head's
ragged N 256208, M 8 and 1024; B4 with biases at M 8 and 1024; B6
non-causal at (128, 2048, 64) beside SDPA), three QAT steps of each model
at full width (seamless 2 + 2 layers through the supervisor; internvl2 2
layers with a 32768-token vocabulary, uncheckpointed), and a ``frontends
summary:`` line. ``--only frontends`` builds and runs this phase alone.
``tp`` serves with tensor parallelism on this one card: two ranks, each
a process, sharing cuda:0 over gloo (NCCL refuses two ranks on one
device), so every step runs eagerly (gloo steps cannot be captured, and
``cuda_graph=True`` with a gloo mesh must raise). First gloo's all-reduce
and all-gather of CUDA tensors are checked and an f32 all-reduce of (8,
1024) and (1024, 1024) is timed beside its modelled bytes (host-bound
gloo on one card: correctness, not tensor parallelism's speed); then the
kernels at tp 2's per-shard shapes against their plain versions, timed
(rows of the ``kernels`` line with ``"tp_shard"``): B1 on a q/k/v column
shard (1024 -> 512), on o's row shard (512 -> 1024, the f32 form) and on
the lm head's shard (1024 -> 16384), at M 8 and 1024; B4 on an ff-2048
slice with the f32 partial; B5 over 8 of the 16 heads, bf16 and int8
pages. Then full-width ternary-paper at tp 2 (the leader spawns its
follower rank), dense, paged bf16 and paged int8, the dense workload's
prompts at budgets TP["gen_lens"] (cut from {32, 64} for the script's
time limit when tp_families came): each against a tp-1 engine on the same weights, the first decode step's
logits within LOGIT_TOL of max|logit| and the streams equal or split at
near ties (``_split_check``), every budget met, B1 and B4 launched by
the leader and B5 12 a leader decode step (paged). Last, the router at
dp 2 x tp 1 and dp 2 x tp 2 (four ranks on the card) over paged bf16
pools, two waves of a workload whose even requests share a 64-token
prefix: the placements, affinity hits and spills printed, at least one
affinity hit, and the streams against one engine's under the near-tie
rule. ``--only tp`` builds and runs this phase alone.
``tp_families`` runs tensor parallelism for the other families, two
ranks sharing cuda:0 over gloo, eagerly. Serving: FAMILIES' models
(jamba-v0.1-52b at full width, 8 layers, dense / paged bf16 / paged
int8; mamba2-130m whole, dense / paged; mixtral-8x22b at full width, 2
layers, dense; the families phase's packed weights when the whole script
runs) at tp 2 against tp 1 on the same weights over TP_FAMILIES'
workload: every budget met, B1 (B4 with MLP layers, B5 once per
attention layer and paged decode step) launched, one decode-only step's
launches, wall and collectives (calls, bytes a rank, ms) on the leader,
every rank's MoE capacity picks of a prefill equal (``rank_routes``),
each rank's bank decode time. Each cache mode's tp 2 engine is held
against a tp 1 engine of its own mode: the first decode step within
LOGIT_TOL of max|logit|, or within WITNESS_FACTOR of the one-ulp witness
(a fresh tp 1 engine with every pass's first block input moved one ulp,
``tp_engine_witness``); the streams equal or, without MoE layers, split
at near ties (``_split_check``) within the larger of LOGIT_TOL and
WITNESS_FACTOR times the witness's max|d logit|; a MoE model's streams
are counted (C11). MoE models and mamba2 hold one decode step run on two
threads as the ranks (``tp_pinned_step``) with every MoE top-k
replaying tp 1's indices within LOGIT_TOL, mamba2's layer by layer
(FAMILIES' ``layer_forced``: every block within FORCED_LAYER_TOL) and
free within WITNESS_FACTOR of the one-ulp witness; then B1 (the SSM
in_proj's column set, out_proj's and o's f32 row shards, the heads'
column shards, the lm head's shard), B4 (the MLP's d_ff slice) and B5
(the local heads) at tp 2's per-shard shapes against their plain
versions. Training: every family's first f32 QAT step at tp 2
(``DistTrainer``) against one process by TP_TRAIN_RULE (rank 0's shards
leaf by leaf, the loss and grad norm over both ranks; each bound at
least WITNESS_FACTOR times the reading of one process's step with every
parameter moved one ulp), each model at the first cut of
TP_FAMILIES_TRAIN that the 28-B-a-parameter reckoning fits in
TP_TRAIN_BUDGET_GIB (mamba2 whole), the cuts passed over printed with
why. ``--only tp_families`` builds and runs this phase alone.
``tcsc`` runs the paper's TCSC formats on the card (plain PyTorch: no TPU
kernel computes them) at K = N = 4096, s 1/2 and 1/16, M 8 and 64: each
format's arrays round-trip, each matmul agrees with the plain dense
matmul within 1e-4 of max|ref| and with B1 within the kernel bound, and
is timed beside B1, ``torch.matmul`` on the decoded weights and the plain
dense matmul (``tcsc summary`` line; not kernels of the port, so not in
the ``kernels`` line).
``train_dist`` runs the distributed trainer (``launch.train.
DistTrainer``, one process a rank, all ranks on this card over gloo) on
full-width ternary-paper at TRAIN's batch 8 x 512 and lr, on four meshes:
dp 2, dp 2 with compressed gradients, tp 2 and dp 2 x tp 2. Each first
step runs in f32 from the seed's state and is held to one process's on
this card (the plain step on the global batch; for the compressed mesh,
its stand-in: each half's gradients ternarized, the codes summed, the
scales averaged) by STEP_CHECK's rule, after which the data-parallel
ranks' checksums of every param and AdamW leaf must agree and the
tensor-parallel ranks' gradients of every replicated leaf too; the row
shards' ternary code flips against one process are counted. Then each
takes TRAIN_DIST["steps"] bf16 steps with one failure at step 2 and a
restart from a checkpoint of step 2 (dp 2 x tp 2 under
``TrainSupervisor``; the others save it, lose every rank's state and
restore it): the loss on a held-out batch (EVAL's step) must fall below
one process's at the seed's state and every rank end at the same step
with equal replicas. Step
times, the collectives' calls, bytes and host ms a step (gradient sync
over the data group, f32 or bf16 codes; tensor-parallel collectives),
peak memory per rank and the loss curve are printed. Last, dp 2 x tp 2's
trained state, gathered, goes through ``eval``'s packed evaluation (B1,
B4 and B6 on the card; the packed loss within EVAL["packed_tol"] of the
QAT loss). ``--only train_dist`` builds and runs this phase alone.

Last, ``dryrun`` calibrates the dry run (``repro_torch.launch.dryrun``)
against the card on ``ternary-paper`` on a one-card mesh at three cut
shapes (``DRYRUN``: a QAT train step of 8 x 512, a packed prefill of 8 x
1024, a packed decode step of 8 rows over a 576-token cache): each shape's
cell is traced on ``meta`` tensors (``run_cell``), and the same step runs
on the card with seeded random weights under the cost walker
(``hlo_cost.trace``), whose kernel reading (each B1 / B4 dispatch charged
by its plan) must equal the meta trace's, FLOPs, bytes and op by op; the
modelled peak of live storage must lie within 10% of
``torch.cuda.max_memory_allocated()`` over the step (read after a reset
taken with the arguments resident, less what else was resident then). The
modelled step time (the larger of the kernel reading's FLOPs at the bf16
peak and its bytes at the HBM rate) is printed beside the step's
CUDA-event time (median of 10) and their ratio, not gated, with the card's
name and power limit; the card's memory is held against the dry run's
``HBM_BYTES``. ``--only dryrun`` builds and runs this phase alone.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Needs one CUDA device and nvcc (PATH or /usr/local/cuda/bin). Exits
nonzero, and prints no result line, when no CUDA device is present or when
the repository's sources are not beside this file. Every failed phase
raises; nothing is caught and skipped.

Tolerances (bf16 outputs of f32 sums taken in another order than the
plain version's, so a value can round one bf16 ulp, 2^-8, the other way):
each kernel agrees with its plain version within |d| <= 1e-2*|ref| +
1e-2*max|ref|; the last-position logits of a full-width prefill on the
card (kernels) agree with the CPU's (plain versions) within
5e-2*max|ref| — twelve bf16 layers compound those ulps — and the greedy
token agrees unless the CPU's top-2 logits lie closer than that bound (a
near tie, reported). One decode step after prefilling the same prompts
into a paged pool and into the dense cache gives logits within
5e-2*max|logit| of each other with bf16 pages (the two paths differ only
in sum order on the card; the CPU tests find them bitwise equal) and
within 7e-2*max|logit| with int8 pages: the CPU measures int8 pages at
1.2-1.5% of max|logit| from dense after one step at reduced and at full
width, tests/test_torch_paging.py holds that under 2e-2, and the card's
own rounding gets the 5e-2 above on top. Greedy tokens follow the same
near-tie rule.

In ``mlp_formats`` each block agrees with the plain chain within the
kernel bound, and the tiled-MLP model's last-position logits with the
dense2bit model's within 5e-2*max|logit| under the greedy near-tie rule
(B4 reads the same matrices either way, so they are expected equal).

In ``gemm_formats`` B2, B3 and B1 on the same tiled pack are held equal
with ``torch.equal`` (the skipping kernels run B1's MMA chunks in B1's
order, minus chunks of empty tiles), each kernel against its plain version
within the kernel bound above, and B7's factorized mode against its
plain mode within the same bound.

The kernel checks run B1 and B4 at every M their paths give them:
serving decode (8) and prefill (1024) and the evaluation's forward (8192).
Each is timed through ``ops`` (``ms``) and through its wrapper called
directly (``kernel_ms``, no dispatch). Then each is checked once, untimed,
at ragged shapes across its tiles' edges (M 1, 17, 1000; K and N 1000;
ff 2000), rows marked ``"on_path": false``.

In ``train_step_check`` the loss and grad norm agree within 1e-3
relative, and every AdamW moment within 1e-3 of its leaf's max (the same
sums in another order through 12 layers), except at weights on the
straight-through mask's edge (|w| within an ulp of 2 mean|w|, a mean the
two devices sum in another order), whose gradient is 0 on one side: at
most 1e-6 of the elements. Parameters agree within 1e-3 of their leaf's
max except where |g| is below 1e-4 of its leaf's largest or 0 on one side,
held to 2.01 lr (AdamW's first step is about lr * sign(g)).

In ``gradients`` each kernel row's (gx, gscale, gbias) and the fused
block's (gx, gscales) agree with the plain row's within the kernel bound
(the same cotangent through both; the products are the same, summed in
another order). In ``eval`` the QAT loss under B6 agrees with the plain
blockwise attention's within 1e-2 (bf16 attention outputs through twelve
layers, the mean of 8192 cross-entropies), and the packed model's loss
with the QAT model's within 0.05, the example's own assertion.

Output: progress lines, each serving run's metrics JSON, a ``serving
host/device summary`` JSON line (decode_graph's readings, the trace's
spans, the profiles), one ``{"kernels": ...}`` JSON line (each kernel's launches summed over the
path runs — serving dense, paged bf16 and int8, the chunked runs, the
faults runs, the spec runs, the modes runs, mlp_formats, the tp runs (the leader's
launches), the families
and frontends runs, gemm_formats, train and eval —
with the per-run
counts
under ``runs``,
and its error and times summed over the shapes its path gives
it, with the per-shape detail under ``shapes``; B6's path gives it the
evaluation's shape only, its other shapes are checks). Every time is the
mean of CUDA-event readings, each after an L2 flush, of a call as a
caller makes it, so the host's enqueue time that the flush does not
cover counts; B2, B3, B5 and B6 also give ``device_ms``, the same calls
with the card kept busy while the host enqueues them, their device time
alone, and ``host_ms``, the host's time to issue one call; B6 also
``ops_ms``, through ``flash_attention(...)``. Then the
card's name and
power limit as nvidia-smi prints them, and the final ``{"ok": true,
"device": ...}`` line.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

F32_OPS_PER_S = 67e12           # f32 outside the tensor cores
SLACK_CYCLES = 500_000          # ~0.3 ms of spinning (cuda_ms's spin)
KERNEL_RTOL = 1e-2
LOGIT_TOL = 5e-2
INT8_LOGIT_TOL = 7e-2
SEED = 0

SERVE = dict(requests=16, slots=8, prompt_len=128, gen_lens=(32, 64))
PAGE_SIZE = 16
# 16 requests of 120-token prompts sharing a 64-token prefix, identical in
# pairs. Full occupancy without sharing needs 8 x 12 = 96 pages, but the
# sharing keeps this workload's peak at 56 (the page counts depend only on
# prompts and budgets), so a 64-page pool never defers or preempts: 40
# pages (39 usable) make it do both.
PRESSURE = dict(requests=16, slots=8, prompt_len=120, prefix_len=64,
                gen_lens=(32, 64), n_pages=40)
# paged attention at the serving shape: 8 rows of up to 193 tokens in
# 13 pages of 16 each, 16 heads (no GQA in ternary-paper), hd 64
PAGED = dict(b=8, h=16, kv=16, hd=64, t=13, max_len=193)
# B5 off the path, at long rows: the training slice's sequence lengths
# (512 to 1024) in 64 pages of 16, where a row's split matters
PAGED_LONG = dict(b=8, h=16, kv=16, hd=64, t=64, min_len=513, max_len=1024)
# B1's and B4's shapes: serving decode (M 8) and prefill (M 1024), and the
# evaluation's full-sequence forward (M = batch 8 x seq 1024 = 8192): the
# attention projections and the MLPs at N 1024, the lm head at N 32768
GEMM_SHAPES = [(m, k, n) for m in (8, 1024, 8192)
               for k, n in ((1024, 1024), (1024, 32768))]
MLP_SHAPES = [(m, 1024, 4096, 1024) for m in (8, 1024, 8192)]
# ragged shapes across B1's and B4's tile edges (M 1, 17, 1000 against
# 16- and 128-row / 16- and 64-row tiles; K and N 1000, ff 2000 off the
# 32-, 64- and 128-column tiles and strips), each checked once, not timed
RAGGED_GEMM = [(m, 1000, 1000) for m in (1, 17, 1000)]
RAGGED_MLP = [(m, 1000, 2000, 1000) for m in (1, 17, 1000)]
# B4's rows must not depend on M: the first M rows of one X at
# ternary-paper's MLP width, through the decode and the prefill tile
ROWS_CHECK = dict(m=8192, k=1024, ff=4096, n=1024,
                  ms=(1, 8, 16, 17, 1024, 8192))
# MLPs of other formats at ternary-paper's MLP width: tiled packs (tile_n
# 96 does not divide ff or N, so the words are padded: B4 reads them with
# a row stride above the width) run fused, bitplane packs the chain (B7)
MLP_FORMATS = dict(k=1024, ff=4096, n=1024, ms=(8, 1024), tile_k=256,
                   tile_n=96, prompts=8)
# ragged shapes of the redesigned B2, B3 and B7 (K % 8 != 0, odd N, M 1,
# 17, 1000; then K 1000 and 1024, whose rows B3's tensor copies take) and
# tiles whose tile_k is not a multiple of 64 or tile_n of 32; checked once
# against their plain versions, not timed
RAGGED_FORMATS = dict(shapes=[(1, 1001, 97), (17, 999, 131),
                              (1000, 1003, 301), (17, 1000, 131),
                              (1000, 1024, 301)],
                      tiles=[(48, 16), (80, 48)], sparsity=0.25)
# the paper-size sparse-GEMM surface (benchmarks/kernel_bench.py's
# sparsity_skip acceptance shape and tile)
FORMATS = dict(k=4096, n=4096, tile_k=256, tile_n=128, ms=(8, 1024),
               bitplane_sparsities=(0.5, 0.0625), sweep_m=1024,
               sweep_sparsity=0.125, base3=(8, 1024, 1024))
# B6: repro's tests/test_flash_kernel.py shapes and hd 128 at S 1024 (causal
# and full), then the evaluation's: B 8 x H 16 at S 1024, hd 64, causal
FLASH_CHECKS = [(4, 128, 64), (2, 257, 64), (8, 96, 128), (16, 1024, 128)]
FLASH_EVAL = (128, 1024, 64)
# checked once, causal and full, not timed: ragged query lengths across the
# 128-row tiles, Sq != Skv both ways, BH 1 (bh, sq, skv, hd)
FLASH_RAGGED = [(2, 127, 127, 64), (2, 129, 129, 128), (2, 255, 255, 64),
                (1, 1000, 1000, 64), (1, 1000, 1000, 128), (3, 129, 1000, 64),
                (3, 1000, 129, 128), (1, 1, 1, 64)]
# the head edge: odd heads' K and V hold 1e4, and the even heads must match
# the plain version over their own rows (a box that read past its head's
# last row would bring the next head's 1e4 in) (bh, s, hd)
FLASH_EDGE = [(4, 200, 64), (4, 1000, 128)]
# SDPA's backends timed as B6's yardstick (torch.nn.attention.SDPBackend)
SDPA_BACKENDS = {"flash": "FLASH_ATTENTION",
                 "efficient": "EFFICIENT_ATTENTION",
                 "cudnn": "CUDNN_ATTENTION"}
# training: full-width ternary-paper (12 layers, d 1024, 16 x 64 heads, ff
# 4096, vocab 32768), batch 8 x seq 512, 24 steps with checkpoints every 8,
# resumed to 32; the supervisor run fails once at step 3 of 4
TRAIN = dict(batch=8, seq=512, steps=24, resume_to=32, ckpt_every=8,
             lr=3e-3, sup_steps=4, sup_every=2, fail_at=3)
EVAL = dict(batch=8, seq=1024, step=10_000, qat_tol=1e-2, packed_tol=0.05)
# the card's first full-width train step against the CPU's, both float32:
# the same sums in another order through 12 layers
STEP_CHECK = dict(batch=2, seq=256, rtol=1e-3, max_flip_share=1e-6)
# train_dist: full-width ternary-paper at TRAIN's batch on four meshes of
# ranks sharing this card over gloo (label: data-parallel, model-parallel,
# compressed gradients); the first step in f32 against one process, then
# 3 bf16 steps with a checkpoint at 2 and one injected failure at step 2.
# The schedule is TRAIN's 24-step one (warmup 3) at a peak lr of 3e-4: at
# 1e-3 and 3e-3 the first steps raise the held-out loss
TRAIN_DIST = dict(meshes=(("dp2", 2, 1, False), ("dp2_compress", 2, 1, True),
                          ("tp2", 1, 2, False), ("dp2_tp2", 2, 2, False)),
                  steps=3, ckpt_every=2, fail_at=2, lr=3e-4,
                  schedule_steps=TRAIN["steps"], timeout_s=300.0)
# decode_graph: each serving workload drained eagerly and through the
# captured decode step in one process; the kernels counted per decode step
GRAPH_KERNELS = ("ternary_gemm", "fused_mlp", "paged_decode_attention")
# profiler: the longest gaps between device work, and the device ops, shown
PROFILE = dict(gaps=3, top_ops=5, unprofiled_iters=20)
# chunked: the three serving workloads again with chunked prefill, 32
# prompt tokens a request a step (int8 pages also at 16: chunk-size
# invariance); the window shapes (8 slots x S, S = 1 .. 32) are captured
# at load(); each window replay launches B1 49 (4 projections x 12 layers
# + the lm head), B4 12 and, paged, B5 12
CHUNK = dict(tokens=32, int8_alt=16)
# B5 on the widest window: 8 rows x S 32 = 256 flattened rows, row (b, j)
# reading its slot's 13 pages up to pos[b] + j + 1 (the chunk offsets of
# 128-token prompts)
B5_WINDOW = dict(b=8, s=32, h=16, kv=16, hd=64, t=13,
                 pos=(0, 32, 64, 96, 0, 32, 64, 96))
# open loop: one seeded schedule each (Poisson at repro's serve default of
# 8 req/s, then bursty in bursts of ~8 at the same mean rate), 48 requests
# of 64, 128 or 512 prompt tokens and 32 or 64 output tokens, the default
# interactive/batch classes half and half; driven through a whole-prompt
# engine (SLO admission, chunk_tokens 0) and a chunked one (32), dense,
# 8 slots, max_len 576 (512 + 64)
OPEN_LOOP = dict(requests=48, rate=8.0, prompt_lens=(64, 128, 512),
                 gen_lens=(32, 64), burst_size=8, slots=8, max_len=576,
                 class_weights=(0.5, 0.5))
# faults: the serving workloads under a pinned chaos schedule, graphed
# (NaN logits in one live slot at these steps, two page allocations
# failing at those, paged); as many retries as NaN steps, so every
# request ends done. Then no retries (the first requests, NaN at every
# step from 2), a deadline against slowed steps, and NaN written into one
# slot's cache between two replays.
FAULTS = dict(nan_at=(4, 12, 30, 45), oom_at=(3, 11, 27), oom_burst=2,
              max_retries=4, fail_requests=4, deadline_s=1.0, slow_s=0.02,
              poison_slot=3)
# spec: the serving workloads with speculative decoding, k 4 (repro's
# default), every draft round and verify window graphed: dense with a
# layer_skip draft (6 of 12 layers) and with a resparsify draft (nnz
# 0.125), paged bf16 and paged int8 under pressure with layer_skip; max_len
# grows by k. Then a run with failed draft rounds at these steps and one
# with an acceptance floor no draft reaches (1.1, over 4 rounds); requests
# of 60 tokens for the verify-vs-sequential check and the profiled round.
SPEC = dict(k=4, draft_layers=6, draft_sparsity=0.125,
            draft_fail_at=(3, 9, 20, 33), accept_floor=1.1, floor_window=4,
            check_gen=60)
# B5 over a verify window: 8 slots x 5 rows, each slot's 13 pages read up
# to pos[b] + j + 1 (positions of 128-token prompts 0 to 56 tokens in)
B5_VERIFY = dict(b=8, s=5, h=16, kv=16, hd=64, t=13,
                 pos=(128, 136, 144, 152, 160, 168, 176, 184))
# the serving modes: the paged pool gathers ceil(193 / 16) * 16 = 208
# positions a row, so the paged-vs-dense comparison runs both at 208; the
# sliding window rolls prompts of 128 through a 64-position cache
MODES = dict(paged_max_len=208, window=64)
# the paper's TCSC formats at the paper's size (plain PyTorch on the card;
# M <= 64 keeps the (nnz, M) float32 gather at s 1/2 under 2.2 GB)
TCSC_CHECK = dict(k=4096, n=4096, sparsities=(0.5, 0.0625), ms=(8, 64),
                  block=1024, group=4, iters=10)
# the port's kernels among the device ops, by their CUDA function names
# families: (config overrides, cache modes, workload, checks); each model
# is get_config(name, quantization="ternary", **overrides), packed. Depth
# is cut (jamba to one 8-layer period, mixtral to 2 of 56 layers) because
# every MoE layer decodes its packed banks every step (~66 ms a layer on
# the card), and init + pack at full depth would not fit the time limit;
# jamba's and mixtral's budgets {8, 16} (were {16, 32}: cut for the
# script's time limit when tp_families came, which serves these models
# again at tp 2). layer_forced: the kernels-vs-plain logit gate runs each block on the
# plain path's input (mamba2's 24 random SSM layers grow a bf16 ulp ~3x a
# layer at first, to ~0.1 of max|logit| end to end)
FAMILIES = {
    "jamba-v0.1-52b": dict(overrides=dict(num_layers=8),
                           caches=("dense", "paged_bf16", "paged_int8"),
                           requests=16, slots=8, prompt_len=128,
                           gen_lens=(8, 16), paged_exact=False,
                           layer_forced=False),
    "mamba2-130m": dict(overrides={}, caches=("dense", "paged_bf16"),
                        requests=16, slots=8, prompt_len=128,
                        gen_lens=(32, 64), paged_exact=True,
                        layer_forced=True),
    "mixtral-8x22b": dict(overrides=dict(num_layers=2), caches=("dense",),
                          requests=16, slots=8, prompt_len=128,
                          gen_lens=(8, 16), paged_exact=False,
                          layer_forced=False),
}
# frontends: the encoder-decoder and VLM families through the static server
# (the continuous engine refuses them, as repro's does), each model
# get_config(name, quantization="ternary", **overrides), packed layer by
# layer. seamless whole (24 encoder + 24 decoder layers); internvl2 4 of
# its 80 layers: every layer is the same kind (period 1, ~856 M parameters
# each), cut for init + pack time as mixtral's are. prompt_len counts the
# frontend rows, so the text prompts are 128 tokens after 2048 encoder
# frames or 1024 vision rows (SyntheticLM's text_len); budgets {16, 32}
# (were {32, 64}: cut for the script's time limit when tp_families came).
FRONTENDS = {
    "seamless-m4t-large-v2": dict(overrides={}, requests=8, batch=8,
                                  prompt_len=2048 + 128, gen_lens=(16, 32)),
    "internvl2-76b": dict(overrides=dict(num_layers=4), requests=8, batch=8,
                          prompt_len=1024 + 128, gen_lens=(16, 32)),
}
# the train check: 3 QAT steps of each at full width, batch 2, grad_accum 1
# (the configs' 4 and 8 do not divide 2); internvl2 2 layers with a
# 32768-token vocabulary: at its 128256 (3.8 B parameters) the parameters,
# gradients, AdamW's two moments and the update's new copies of all three
# would pass the card's 80 GB (70.3 GiB peak at 32768); its state is not
# checkpointed (27 GB written in ~60 s of the time limit)
FRONTEND_TRAIN = {
    "seamless-m4t-large-v2": dict(num_layers=2, enc_layers=2,
                                  seq=2048 + 128, checkpoint=True),
    "internvl2-76b": dict(num_layers=2, vocab_size=32768, seq=1024 + 128,
                          checkpoint=False),
}
FRONTEND_STEPS = 10             # decode steps timed for the p50
# a layer-forced block's output through the kernels against the plain
# path's on the same input: within two bf16 ulps of its max (each GEMM
# output rounds at most one ulp the other way; sound runs read 0.0036)
FORCED_LAYER_TOL = 2 ** -7
# the free-running kernel path (nothing forced or pinned) against the plain
# path may lie at most this many times as far as the plain path with its
# first block's input moved one bf16 ulp (the witness of how far the model
# itself carries one rounding), or within LOGIT_TOL; sound runs read 0.32
# (mamba2) to 0.82 (jamba) of the witness
WITNESS_FACTOR = 2.0
# B5 at each family's GQA shape over long page tables too (off the path:
# the served prompts are 128 tokens): rows of 1024 to 4096 tokens
FAMILY_LONG_CONTEXT = (1024, 4096)
PORT_KERNEL_NAMES = ("ternary_gemm", "fused_mlp", "paged_attention",
                     "flash_attention", "bitplane")
# The tiles each serving phase took before the block-shape tuner (B1 and
# B7 (block_m, block_n); B2/B3 the rows; B4 the same (block_m, strip)
# pairs): the tune phase's baseline, against which every candidate tile is
# held bitwise and the model's pick is timed.
# tensor parallelism on the one card (tp_phase): tp 2 ranks sharing cuda:0
# over gloo; the router's workload shares a 64-token prefix on half of its
# requests; the all-reduce shapes (decode rows, a prefill's) and their
# timed iterations
TP = dict(tp=2, requests=16, prefix_len=64, gen_lens=(16, 32),
          allreduce=(((8, 1024), 50), ((1024, 1024), 20)))
# tp_families: FAMILIES' models and cache modes at tp 2 (two ranks on this
# card over gloo, eager) against tp 1 on the same packed weights, over a
# shorter workload than the families phase's (every MoE layer decodes its
# banks each step: jamba's step is ~0.26 s)
TP_FAMILIES = dict(requests=4, slots=4, prompt_len=64, gen_lens=(4, 8))
# its training part: each family's first f32 QAT step at tp 2 against one
# process, at the first cut (deepest first, then width) whose reckoned
# card bytes (tp_train_cut) fit the budget
TP_FAMILIES_TRAIN = {
    "mamba2-130m": ({},),
    "seamless-m4t-large-v2": ({}, dict(num_layers=12, enc_layers=12)),
    "jamba-v0.1-52b": (dict(num_layers=8),
                       dict(num_layers=2, attn_period=2, attn_offset=1),
                       dict(num_layers=2, attn_period=2, attn_offset=1,
                            num_experts=8),
                       dict(num_layers=2, attn_period=2, attn_offset=1,
                            num_experts=4)),
    "internvl2-76b": (dict(num_layers=4), dict(num_layers=2),
                      dict(num_layers=1),
                      dict(num_layers=1, vocab_size=32768)),
    "mixtral-8x22b": (dict(num_layers=2), dict(num_layers=1),
                      dict(num_layers=1, num_experts=4)),
}
# (the reckoning reads ~0.9 of the peaks measured: seamless whole 59.9
# GiB against 57.4 for one process and 66.1 for the two ranks, measured
# on one H100; jamba at 2 layers and 8 experts, 66.1 reckoned, ran out of
# the card's 79.2)
TP_TRAIN_BUDGET_GIB = 60
# the check's rule: STEP_CHECK's, with a leaf's moments held relative to
# at least `floor` of the tree's largest (a leaf whose gradient is ~0
# reads rounding noise: tests/test_torch_family_train.py's rule,
# seamless's cross-attention key), each reading (loss, grad norm, m, v,
# params) within the larger of STEP_CHECK's rtol and WITNESS_FACTOR times
# the one-ulp witness's (one process from the same state with every
# parameter moved one ulp: how far the model itself carries one rounding;
# a row shard's column statistics, summed in another order, flip codes at
# ternarization ties as such a move does), and a parameter whose gradient
# takes another sign on the two sides, or lies below the larger of
# STEP_CHECK's 1e-4 and the moments' measured disagreement of its leaf's
# largest, held to 2.01 lr. mamba2 runs whole: at 24 layers its random
# SSM stack carries f32 rounding to ~1% of a leaf's max in the backward
# (measured on one H100)
TP_TRAIN_RULE = dict(floor=1e-3)
FIXED_TILE = {"decode": (16, 64), "verify": (16, 64), "prefill": (64, 128),
              "chunk": (64, 128)}
# The tune phase: every key the served engines' load() plans, then
# jamba-v0.1-52b's in_proj and lm head at decode and prefill M; B2/B3
# (tiled 256 x 128 packs at occupancy 1/4) and B7 at the served shapes at
# one M a phase; the model's pick may be at most `slack` x the fixed
# tile's card time.
# the dry run's calibration (dryrun_phase): (name, sequence, batch, kind,
# quantization) of ternary-paper on a one-card mesh; cut from the
# production shapes (4096 x 256 train, 32768-token serving) to what one
# card holds and the phase's time: the train phase's 8 x 512, a prefill
# of 8 x 1024, a decode step of 8 rows over the serving runs' 576 tokens
DRYRUN = dict(shapes=(("train_8x512", 512, 8, "train", "ternary"),
                      ("prefill_8x1024", 1024, 8, "prefill",
                       "ternary_packed"),
                      ("decode_8x576", 576, 8, "decode", "ternary_packed")),
              iters=10, peak_rtol=0.10, hbm_rtol=0.03)
TUNE = dict(jamba=((4096, 16544), (4096, 65536)), jamba_ms=(8, 1024),
            side_ms={"decode": 8, "verify": 40, "chunk": 256,
                     "prefill": 1024},
            sparsity=0.25, iters=20, slack=1.05, retimes=3)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, flush, *, spin: bool = False) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` launches, each after a
    write of ``flush`` (larger than the 50 MB L2), so weights come from
    device memory as they do when a model's layers take turns. The host's
    time to enqueue ``fn`` beyond what is left of the write shows as idle
    card time in the reading, as it does for a caller. With ``spin``, the
    card spins ``SLACK_CYCLES`` after the write, so the host's time is
    hidden and the reading is the card's time alone (``device_ms``)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SLACK_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def host_ms(fn, iters: int) -> float:
    """Mean host time to issue one call of ``fn``, calls back to back with
    no synchronization between them: what a call costs the host, whatever
    the card does meanwhile."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def bound_ms(nbytes: float, ops: float, ops_per_s: float = None):
    """The least time of the work: its bytes at the H100's device-memory
    rate or its operations at ``ops_per_s`` (by default the dense bf16
    tensor-core peak), whichever is longer; both rates are the port's
    (repro_torch.kernels.autotune, its single source)."""
    from repro_torch.kernels.autotune import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.kernels.autotune import PEAK_FLOPS as BF16_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (ops_per_s or BF16_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name: str, got, ref) -> float:
    import torch
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    limit = KERNEL_RTOL * ref.abs() + KERNEL_RTOL * ref.abs().max()
    if not bool(torch.isfinite(got).all()) or bool((err > limit).any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: max |d| = {float(err.max()):.4g}, "
                             f"max |ref| = {float(ref.abs().max()):.4g}")
    return float(err.max())


def sass_counts(build, name: str, pattern: str):
    """Opcodes of ``name``'s library (cuobjdump -sass) matching
    ``pattern``, counted; None when cuobjdump cannot read it."""
    import collections
    import re
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([cuobjdump, "-sass", str(build._lib_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"  {name}: no SASS ({e})", flush=True)
        return None
    return dict(sorted(collections.Counter(re.findall(pattern, sass))
                       .items()))


def sass_summary(build):
    """The tensor-core and fused multiply-add opcodes of B1's and B2/B3's
    libraries: B2 == B3 == B1 bit for bit needs the same MMA instruction
    in both (HMMA.16816.F32.BF16, 16-deep chunks) and no FFMA contracting
    an epilogue's scale and bias. Information; equal3 in gemm_formats is
    the check."""
    for name in ("ternary_gemm", "ternary_gemm_skip"):
        ops = sass_counts(build, name, r"\b(HMMA\.[0-9A-Z.]+|FFMA)\b")
        if ops is not None:
            print(f"  {name} SASS: {ops}", flush=True)


def ptxas_report(build, name: str):
    """Registers and spill bytes of each kernel in ``name``'s build log
    (nvcc -Xptxas -v), by mangled entry name."""
    import re
    out, entry = {}, None
    for line in (build.BUILD_DIR / f"{name}.log").read_text().splitlines():
        if "entry function" in line:
            entry = line.split("'")[1]
        elif entry and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[entry] = {"spill_stores": int(st), "spill_loads": int(ld)}
        elif entry and "Used" in line and "registers" in line:
            out[entry]["registers"] = int(re.search(r"Used (\d+) registers",
                                                    line).group(1))
    return out


def _packed_weight(gen, k, n, bias=False):
    """A dense2bit pack of latent weights as LM.init draws them: N(0, 1/k);
    with ``bias``, a random f32 bias inside the container."""
    import torch
    from repro_torch.core import weights
    w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
    b = torch.randn(n, generator=gen, device="cuda") * 0.1 if bias else None
    return weights.pack(w, bias=b)


def _serving_phase(m):
    return "decode" if m <= 16 else "prefill"


def _iters_for(m):
    return 20 if m <= 1024 else 5


def gemm_row(gen, m, k, n, phase, flush, bias=False):
    """B1 through ops under ``phase`` against its plain version, timed:
    through ops (``ms``), its wrapper alone (``kernel_ms``), the plain
    version and cuBLAS on the decoded weights (plus the bias, with
    ``bias``: a pack carrying one)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_gemm as gemm_lib

    w = _packed_weight(gen, k, n, bias)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    with ops.serving_phase(phase):
        got = ops.ternary_gemm(x, w)
        ref = gemm_lib.ternary_gemm_ref(x, w.packed, w.scale, w.bias)
        err = check_close(f"ternary_gemm M={m} K={k} N={n}", got, ref)
        w_eff = w.materialize(torch.float32, with_scale=True).to(
            torch.bfloat16)
        b_eff = None if w.bias is None else w.bias.to(torch.bfloat16)
        iters = _iters_for(m)
        plan = ops.ternary_gemm_plan(w, m)
        row = {
            "m": m, "k": k, "n": n, "phase": phase, "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.ternary_gemm(x, w), iters, flush),
            # the wrapper called directly, without ops' dispatch: the gap
            # to "ms" is host time that the launch waits for
            "kernel_ms": cuda_ms(lambda: gemm_lib.ternary_gemm_cuda(
                x, w.packed, w.scale, w.bias, n=w.n, block_m=plan.block_m,
                block_n=plan.block_n), iters, flush),
            "plain_ms": cuda_ms(lambda: gemm_lib.ternary_gemm_ref(
                x, w.packed, w.scale, w.bias), iters, flush),
            "library_ms": cuda_ms(
                (lambda: torch.matmul(x, w_eff)) if b_eff is None else
                (lambda: torch.addmm(b_eff, x, w_eff)), iters, flush),
        }
    if bias:
        row["bias"] = True
    nbytes = (m * k * 2 + w.packed.numel() * 4 + n * 4 * (1 + bias)
              + m * n * 2)
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2.0 * m * w.nnz)
    print(f"ternary_gemm M={m} K={k} N={n} ({phase}): " + json.dumps(row),
          flush=True)
    return row


def mlp_row(gen, m, k, ff, n, phase, flush, bias=False):
    """B4 through ops under ``phase`` against its plain version, timed as
    ``gemm_row`` times B1 (the library: cuBLAS's SwiGLU chain); with
    ``bias``, each projection's pack carries a bias."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_mlp as fused_lib
    from repro_torch.kernels import ops

    wi, wg, wo = (_packed_weight(gen, a, b, bias)
                  for a, b in ((k, ff), (k, ff), (ff, n)))
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    plain_args = (x, wi.packed, wo.packed, wg.packed, wi.scale, wi.bias,
                  wg.scale, wg.bias, wo.scale, wo.bias)
    with ops.serving_phase(phase):
        got = ops.fused_mlp(x, wi, wo, wg)
        ref = fused_lib.fused_mlp_ref(*plain_args)
        err = check_close(f"fused_mlp M={m} K={k} ff={ff} N={n}", got, ref)
        ei, eg, eo = (c.materialize(torch.float32, with_scale=True).to(
            torch.bfloat16) for c in (wi, wg, wo))
        bi, bg, bo = (torch.zeros(c.n, device="cuda", dtype=torch.bfloat16)
                      if c.bias is None else c.bias.to(torch.bfloat16)
                      for c in (wi, wg, wo))
        iters = _iters_for(m)
        plan = ops.fused_mlp_plan(wi, wo, wg, m=m)
        row = {
            "m": m, "k": k, "ff": ff, "n": n, "phase": phase,
            "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.fused_mlp(x, wi, wo, wg), iters,
                          flush),
            "kernel_ms": cuda_ms(lambda: fused_lib.fused_mlp_cuda(
                x, *plain_args[1:], block_m=plan.block_m,
                strip=plan.block_n1), iters, flush),
            "plain_ms": cuda_ms(lambda: fused_lib.fused_mlp_ref(
                *plain_args), iters, flush),
            # cuBLAS chain over pre-decoded, pre-scaled bf16 weights
            "library_ms": cuda_ms(
                (lambda: (F.silu(x @ eg) * (x @ ei)) @ eo) if not bias else
                (lambda: torch.addmm(bo, F.silu(torch.addmm(bg, x, eg))
                                     * torch.addmm(bi, x, ei), eo)),
                iters, flush),
        }
    if bias:
        row["bias"] = True
    nbytes = (m * k * 2 + (wi.packed.numel() + wg.packed.numel()
                           + wo.packed.numel()) * 4
              + (2 * ff + n) * 4 * (1 + bias) + m * n * 2)
    ops_needed = 2.0 * m * (wi.nnz + wg.nnz + wo.nnz)
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops_needed)
    print(f"fused_mlp M={m} K={k} ff={ff} N={n} ({phase}): "
          + json.dumps(row), flush=True)
    return row


def kernel_phase(flush):
    """Each kernel against its plain version at the serving shapes."""
    import torch
    from repro_torch.kernels import fused_mlp as fused_lib
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_gemm as gemm_lib

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {"ternary_gemm": [], "fused_mlp": []}
    for m, k, n in GEMM_SHAPES:
        results["ternary_gemm"].append(
            gemm_row(gen, m, k, n, _serving_phase(m), flush))
    for m, k, n in RAGGED_GEMM:
        w = _packed_weight(gen, k, n)
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        with ops.serving_phase(_serving_phase(m)):
            got = ops.ternary_gemm(x, w)
        err = check_close(f"ternary_gemm M={m} K={k} N={n}", got,
                          gemm_lib.ternary_gemm_ref(x, w.packed, w.scale))
        results["ternary_gemm"].append({"m": m, "k": k, "n": n,
                                        "max_abs_err": err,
                                        "on_path": False})
        print(f"ternary_gemm M={m} K={k} N={n}: agrees, max_abs_err {err}",
              flush=True)

    for m, k, ff, n in MLP_SHAPES:
        results["fused_mlp"].append(
            mlp_row(gen, m, k, ff, n, _serving_phase(m), flush))
    for m, k, ff, n in RAGGED_MLP:
        wi, wg, wo = (_packed_weight(gen, a, b)
                      for a, b in ((k, ff), (k, ff), (ff, n)))
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        with ops.serving_phase(_serving_phase(m)):
            got = ops.fused_mlp(x, wi, wo, wg)
        err = check_close(f"fused_mlp M={m} K={k} ff={ff} N={n}", got,
                          fused_lib.fused_mlp_ref(
                              x, wi.packed, wo.packed, wg.packed, wi.scale,
                              None, wg.scale, None, wo.scale, None))
        results["fused_mlp"].append({"m": m, "k": k, "ff": ff, "n": n,
                                     "max_abs_err": err, "on_path": False})
        print(f"fused_mlp M={m} K={k} ff={ff} N={n}: agrees, max_abs_err "
              f"{err}", flush=True)
    return results


def row_independence_check():
    """B4's output for a row does not depend on how many rows share the
    call: X of ROWS_CHECK["m"] rows at ternary-paper's MLP width through
    ops.fused_mlp (the decode tile for M <= 16, the prefill tile above),
    B4(X[:M]) == B4(X)[:M] under torch.equal for each M, gated and not."""
    import torch
    from repro_torch.core import weights
    from repro_torch.kernels import fused_mlp as fused_lib
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    k, ff, n = ROWS_CHECK["k"], ROWS_CHECK["ff"], ROWS_CHECK["n"]
    wi, wg, wo = (weights.pack(torch.randn(a, b, generator=gen,
                                           device="cuda") / a ** 0.5)
                  for a, b in ((k, ff), (k, ff), (ff, n)))
    x = torch.randn(ROWS_CHECK["m"], k, generator=gen,
                    device="cuda").to(torch.bfloat16)
    for gate in (wg, None):
        full = ops.fused_mlp(x, wi, wo, gate)
        for m in ROWS_CHECK["ms"]:
            got = ops.fused_mlp(x[:m].contiguous(), wi, wo, gate)
            if not torch.equal(got, full[:m]):
                d = float((got.float() - full[:m].float()).abs().max())
                raise AssertionError(
                    f"B4 rows depend on M: gated={gate is not None} M={m} "
                    f"differs from the first {m} rows of M="
                    f"{ROWS_CHECK['m']} (max |d| = {d})")
    print(f"B4 row independence: B4(X[:M]) == B4(X)[:M] bitwise for M in "
          f"{list(ROWS_CHECK['ms'])}, gated and ungated (chunk width "
          f"{fused_lib.chunk_width(ff)} at every M)", flush=True)


def _paged_inputs(gen, shape, lengths):
    """q and f32 K/V pages for B5, and a table whose entries past each
    length are garbage ids (never read), each row's pages distinct."""
    import torch
    b, h, kv, hd, t = (shape[k] for k in ("b", "h", "kv", "hd", "t"))
    ps, n_pages = PAGE_SIZE, b * t + 1
    q = torch.randn(b, h, hd, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(n_pages, ps, kv, hd, generator=gen, device="cuda")
    v = torch.randn(n_pages, ps, kv, hd, generator=gen, device="cuda")
    lengths = lengths()
    table = torch.randint(0, n_pages, (b, t), generator=gen, device="cuda",
                          dtype=torch.int32)
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
            ).to(torch.int32)
    for row, n in enumerate(lengths.tolist()):
        used = -(-n // ps)
        table[row, :used] = perm[row * t:row * t + used]
    return q, k, v, lengths, table


def paged_rows(name, shape, inputs, flush, *, subsets, on_path,
               read_tokens=None):
    """B5 through ops against its plain version, bf16 and int8 pages, on
    ``inputs`` = (q, f32 K/V pages, lengths, table); B5 on each subset of
    the rows must give those rows' bits among all rows; then timed (ops,
    with the card kept busy, the host's enqueue time, the plain version, and
    SDPA on K/V gathered beforehand). ``read_tokens``: the distinct tokens
    whose K/V the bound counts as read once (default: every row's valid
    tokens; a window's rows share theirs)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.paging import Int8Pages
    from repro_torch.paging import kernels as paged_lib

    q, k, v, lengths, table = inputs
    b, h, hd = q.shape
    kv, t = shape["kv"], table.shape[1]
    valid = int(lengths.sum())
    read = valid if read_tokens is None else read_tokens
    pos = torch.arange(t * PAGE_SIZE, device="cuda")
    mask = (pos < lengths[:, None])[:, None, None, :]       # (B, 1, 1, S)
    rows = []
    for label in ("bf16", "int8"):
        if label == "int8":
            kp, vp = Int8Pages.quantize(k), Int8Pages.quantize(v)
        else:
            kp, vp = k.to(torch.bfloat16), v.to(torch.bfloat16)
        args = (q, kp, vp, table, lengths)
        what = f"paged_decode_attention {name} {label} pages"
        got = ops.paged_decode_attention(*args)
        ref = paged_lib.paged_decode_attention_ref(*args)
        err = check_close(what, got, ref)
        for subset in subsets:
            idx = torch.tensor(subset, device="cuda")
            part = paged_lib.paged_decode_attention_cuda(
                q[idx].contiguous(), kp, vp, table[idx].contiguous(),
                lengths[idx].contiguous())
            if not torch.equal(part, got[idx]):
                raise AssertionError(f"{what}: rows {subset} alone differ "
                                     f"from the same rows among all {b}")
        # yardstick: SDPA over K/V gathered (and dequantized) beforehand
        ks, vs = (paged_lib.gather_pages(pg, table, torch.bfloat16)
                  .transpose(1, 2).contiguous() for pg in (kp, vp))
        qs = q[:, :, None]
        iters = 50
        row = {
            "shape": name, "pages": label, "b": b, "h": h, "kv": kv,
            "hd": hd, "ps": PAGE_SIZE, "t": t, "valid_tokens": valid,
            "split": paged_lib.split_plan(t, PAGE_SIZE).splits,
            "max_abs_err": err, "subsets_equal": True,
            "ms": cuda_ms(lambda: ops.paged_decode_attention(*args),
                          iters, flush),
            "device_ms": cuda_ms(
                lambda: ops.paged_decode_attention(*args), iters, flush,
                spin=True),
            "host_ms": host_ms(
                lambda: ops.paged_decode_attention(*args), 100),
            "plain_ms": cuda_ms(
                lambda: paged_lib.paged_decode_attention_ref(*args),
                iters, flush),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=h != kv), iters,
                flush),
        }
        if not on_path:
            row["on_path"] = False
        # K and V of the tokens read once (+ their scales), q and o, the
        # table and the lengths
        per_token = 2 * kv * (hd + 4 if label == "int8" else 2 * hd)
        nbytes = read * per_token + 2 * b * h * hd * 2 + b * t * 4 + b * 4
        ops_needed = 4.0 * valid * h * hd             # q.k and p.v, f32
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops_needed,
                                                    F32_OPS_PER_S)
        rows.append(row)
        print(f"{what}: subsets equal; " + json.dumps(row), flush=True)
    return rows


def paged_kernel_phase(flush):
    """B5 against its plain version at the serving shape and, off the
    path, at the long rows (PAGED_LONG), bf16 and int8 pages: ragged
    lengths from the seeded generator, each row's pages distinct, table
    entries past each length garbage. At each, B5 on subsets of the rows
    (1, 3 and all 8, permuted) must equal B5 on all rows, bit for bit."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    serving = _paged_inputs(gen, PAGED, lambda: torch.randint(
        1, PAGED["max_len"] + 1, (PAGED["b"],), generator=gen, device="cuda",
        dtype=torch.int32))
    gen_long = torch.Generator(device="cuda").manual_seed(SEED + 12)
    long_rows = _paged_inputs(gen_long, PAGED_LONG, lambda: torch.randint(
        PAGED_LONG["min_len"], PAGED_LONG["max_len"] + 1, (PAGED_LONG["b"],),
        generator=gen_long, device="cuda", dtype=torch.int32))
    subsets = ([3], [0, 5, 7], [6, 1, 4, 0, 7, 2, 5, 3])
    rows = []
    for name, shape, inputs in (("serving", PAGED, serving),
                                ("long", PAGED_LONG, long_rows)):
        rows += paged_rows(name, shape, inputs, flush, subsets=subsets,
                           on_path=name == "serving")
    return rows


def _counters():
    """Kernel name -> (wrapper, attribute holding its launch count)."""
    from repro_torch.kernels import graphs
    return graphs.launch_counters()


def _zero_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _read_counts():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counters().items()}


def serve_run(label, cfg, params, prompts, gens, max_len, **engine_kw):
    """Drain one workload through the continuous engine on the card; the
    launch counters are set to 0 just before the run and read just
    after. Checks every request drained with its full budget of in-range
    token ids."""
    from repro_torch.launch import serve

    engine = _engine(cfg, params, max_len, True, **engine_kw)
    _zero_counts()
    outs, metrics = serve.run_continuous(engine, prompts, gens)
    launches = _read_counts()

    brief = {k: v for k, v in metrics.items() if k != "per_request"}
    print(f"{label} serving metrics: " + json.dumps(brief), flush=True)
    print(f"{label} serving launches: {json.dumps(launches)}", flush=True)
    if metrics["drained"] != len(gens):
        raise AssertionError(f"{label}: drained {metrics['drained']} of "
                             f"{len(gens)} requests")
    for i, (toks, g) in enumerate(zip(outs, gens)):
        if len(toks) != g or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{label}: request {i}: {len(toks)} tokens "
                                 f"for a budget of {g}, or ids out of range")
    for name in ("ternary_gemm", "fused_mlp"):
        if launches[name] <= 0:
            raise AssertionError(f"{label}: {name} kernel never launched")
    b5 = (engine_kw.get("cache") == "paged"
          and engine.cfg.paged_attn_impl != "jax")
    want = cfg.num_layers * metrics["decode_steps"] if b5 else 0
    if launches["paged_decode_attention"] != want:
        raise AssertionError(
            f"{label}: paged_decode_attention launched "
            f"{launches['paged_decode_attention']} times, expected {want} "
            f"({cfg.num_layers} layers x {metrics['decode_steps']} decode "
            f"steps)")
    return outs, metrics, launches


def serve_phase():
    """Full-width packed ternary-paper through the continuous engine; the
    launch counters are zeroed just before the run and read just after."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = get_config("ternary-paper")
    prompts, gens, _ = serve.build_workload(
        cfg, SERVE["requests"], SERVE["prompt_len"], SERVE["gen_lens"],
        seed=SEED)
    t0 = time.perf_counter()
    cfg, params = serve.build_params(cfg, SEED, "cuda", packed=True)
    print(f"init+pack full-width {cfg.name} ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, ff {cfg.d_ff}, vocab {cfg.vocab_size}): "
          f"{serve.count_packed(params)} packed linears in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    max_len = SERVE["prompt_len"] + max(SERVE["gen_lens"]) + 1
    outs, _, launches = serve_run("dense", cfg, params, prompts, gens,
                                  max_len)
    return cfg, params, prompts, gens, max_len, outs, launches


def _tree_to(tree, device):
    import torch
    from repro_torch.core.weights import Dense2Bit
    if isinstance(tree, Dense2Bit):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def model_phase(cfg, params, prompts, max_len):
    """Prefill one prompt with the same weights on the card (kernels) and
    on the CPU (plain versions); compare last-position logits and the
    greedy token."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import LM

    toks = torch.as_tensor(prompts[:1])
    with torch.no_grad(), ops.serving_phase("prefill"):
        _, card = LM(cfg, "cuda").prefill(params, {"tokens": toks.cuda()},
                                          max_len)
    t0 = time.perf_counter()
    with torch.no_grad():
        _, cpu = LM(cfg, "cpu").prefill(_tree_to(params, "cpu"),
                                        {"tokens": toks}, max_len)
    _compare_logits(f"model check, card vs CPU plain path "
                    f"({time.perf_counter() - t0:.1f}s on the CPU)",
                    cpu[:, -1], card[:, -1], LOGIT_TOL)


def _compare_logits(what, ref, got, tol):
    """max |got - ref| <= tol * max|ref| for (B, V) logits, finite, and
    each row's greedy token equal unless ref's top-2 lie within that bound
    (a near tie, reported). Returns the rows whose tokens agree."""
    import torch
    ref, got = ref.float().cpu(), got.float().cpu()
    diff = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    top2 = ref.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    agree = ref.argmax(-1) == got.argmax(-1)
    print(f"{what}: max|d logit| = {diff:.4g} ({diff / scale:.4g} of "
          f"max|logit| {scale:.4g}, bound {tol}); greedy tokens agree on "
          f"{int(agree.sum())}/{len(agree)} rows", flush=True)
    if not bool(torch.isfinite(got).all()) or diff > tol * scale:
        raise AssertionError(f"{what}: logits differ by {diff} > {tol} * "
                             f"{scale}")
    for row in torch.nonzero(~agree).flatten().tolist():
        if float(margin[row]) > tol * scale:
            raise AssertionError(f"{what}: row {row} greedy token differs "
                                 f"with a top-2 margin of "
                                 f"{float(margin[row])}")
        print(f"{what}: row {row} differs on a near tie (margin "
              f"{float(margin[row]):.4g})", flush=True)
    return int(agree.sum())


def paged_step_check(what, cfg, params, prompts, max_len, kv_dtype, tol,
                     pin_routing=False):
    """Prefill the same prompts into the dense cache and into a paged pool
    on the card, run one decode step in each from the same next tokens,
    and compare the logits. ``pin_routing``: the paged pass replays the
    dense pass's MoE routing decisions (``_routing``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.paging import PagePool

    model = LM(cfg, "cuda")
    b, s = prompts.shape
    toks = torch.as_tensor(prompts, device="cuda")
    pos = torch.full((b,), s, dtype=torch.int32, device="cuda")
    book = []
    pin = _routing if pin_routing else (
        lambda mode, book: contextlib.nullcontext())
    with torch.no_grad():
        with pin("record", book):
            with ops.serving_phase("prefill"):
                cache, logits = model.prefill(params, {"tokens": toks},
                                              max_len)
            nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            with ops.serving_phase("decode"):
                dense, _ = model.decode_step(
                    params, {"layers": cache["layers"], "pos": pos}, nxt)
        del cache
        pool = PagePool(model, b, max_len, page_size=PAGE_SIZE,
                        kv_dtype=kv_dtype)
        adms = [pool.admit(p) for p in prompts]
        if [a.slot for a in adms] != list(range(b)):
            raise AssertionError("the pool's slots do not follow the rows")
        with pin("replay", book):
            with ops.serving_phase("prefill"):
                pcache, _ = model.prefill(params, {"tokens": toks},
                                          -(-s // PAGE_SIZE) * PAGE_SIZE)
            pool.insert(adms, pcache["layers"])
            del pcache
            for a in adms:
                if not pool.ensure_append(a.slot, s):
                    raise AssertionError("a default-size pool ran dry")
            table = torch.tensor(pool.table, device="cuda")
            with ops.serving_phase("decode"):
                paged, _ = model.decode_step(
                    params, {"layers": pool.layers, "pos": pos,
                             "block_table": table}, nxt)
    return _compare_logits(what, dense[:, 0], paged[:, 0], tol)


def pressure_workload(cfg):
    """The int8 pressure run's prompts: a 64-token prefix common to all,
    a 56-token tail shared by each adjacent pair (so twins share their
    partial tail page and copy it on their first write); budgets drawn
    from {32, 64}."""
    import numpy as np
    rng = np.random.default_rng(SEED + 3)
    n, plen = PRESSURE["requests"], PRESSURE["prompt_len"]
    common = rng.integers(0, cfg.vocab_size, size=PRESSURE["prefix_len"])
    tails = rng.integers(0, cfg.vocab_size,
                         size=(n // 2, plen - PRESSURE["prefix_len"]))
    prompts = np.stack([np.concatenate([common, tails[i // 2]])
                        for i in range(n)]).astype(np.int32)
    gens = [int(g) for g in rng.choice(PRESSURE["gen_lens"], size=n)]
    return prompts, gens


def paged_phases(cfg, params, workloads, dense_outs):
    """Paged serving with bf16 pages on the dense run's workload, then with
    int8 pages under pressure; each followed by the one-step logit check
    against the dense cache. Returns the per-run launch counts and the
    bf16 and int8 runs' token streams."""
    import numpy as np
    prompts, gens, max_len, kw = workloads["paged_bf16"]
    outs, _, bf16_launches = serve_run("paged bf16", cfg, params, prompts,
                                       gens, max_len, **kw)
    same = sum(np.array_equal(a, b) for a, b in zip(outs, dense_outs))
    print(f"paged bf16: {same}/{len(outs)} token streams equal the dense "
          f"run's (information, not a gate)", flush=True)
    runs = {"paged_bf16": bf16_launches}
    paged_step_check("paged bf16 vs dense, one decode step", cfg, params,
                     prompts[:SERVE["slots"]], max_len, None, LOGIT_TOL)

    p_prompts, p_gens, p_max_len, kw = workloads["paged_int8"]
    p_outs, pm, runs["paged_int8"] = serve_run(
        "paged int8 under pressure", cfg, params, p_prompts, p_gens,
        p_max_len, **kw)
    cache = pm["cache"]
    if not (cache["prefix"]["hits"] > 0 and cache["cow_copies"] > 0
            and cache["deferrals"] + cache["preemptions"] > 0):
        raise AssertionError(f"the pressure run did not share prefixes, "
                             f"copy on write and defer or preempt: {cache}")
    paged_step_check("paged int8 vs dense, one decode step", cfg, params,
                     p_prompts[:SERVE["slots"]], p_max_len, "int8",
                     INT8_LOGIT_TOL)
    return runs, outs, p_outs


def serving_workloads(cfg, prompts, gens, max_len):
    """The three serving workloads (the dense run's prompts and budgets,
    then the int8 pressure run's): label -> (prompts, budgets, max_len,
    engine keywords)."""
    p_prompts, p_gens = pressure_workload(cfg)
    p_max_len = PRESSURE["prompt_len"] + max(PRESSURE["gen_lens"]) + 1
    return {
        "dense": (prompts, gens, max_len, {}),
        "paged_bf16": (prompts, gens, max_len,
                       dict(cache="paged", page_size=PAGE_SIZE)),
        "paged_int8": (p_prompts, p_gens, p_max_len,
                       dict(cache="paged", page_size=PAGE_SIZE,
                            n_pages=PRESSURE["n_pages"], kv_dtype="int8")),
    }


def _engine(cfg, params, max_len, graph, tracer=None, **engine_kw):
    from repro_torch.serving import ContinuousScheduler
    engine = ContinuousScheduler(cfg, max_slots=SERVE["slots"],
                                 max_len=max_len, device="cuda",
                                 tracer=tracer, cuda_graph=graph,
                                 **engine_kw)
    engine.load(params)
    return engine


def _decode_only_step(engine):
    """Step ``engine`` until a step decodes without admitting (so no
    prefill launches land in it); returns that step's launches."""
    import torch
    while True:
        p0 = engine.prefill_steps
        _zero_counts()
        engine.step()
        torch.cuda.synchronize()
        if engine.prefill_steps == p0 and engine.last_logits is not None:
            return _read_counts()


def span_summary(events):
    """Complete spans by name: count, total, p50 and p90 in ms."""
    import numpy as np
    by_name = {}
    for e in events:
        if e["ph"] == "X":
            by_name.setdefault(e["name"], []).append(e["dur"] / 1e3)
    return {name: {"n": len(d), "total_ms": float(np.sum(d)),
                   "p50_ms": float(np.percentile(d, 50)),
                   "p90_ms": float(np.percentile(d, 90))}
            for name, d in sorted(by_name.items())}


def decode_graph_phase(cfg, params, workloads):
    """Each serving workload twice in this process, with the decode step
    run eagerly and replayed as a CUDA graph: equal token streams, equal
    cache metrics, equal B1/B4/B5 launches (per run and per decode step),
    and one decode step's logits bitwise equal. Prints tok/s, TPOT p50 and
    the decode step's wall time (the engine's decode_step spans) of both.
    Returns label -> path -> readings, and the graph runs' tracers."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.obs import Tracer

    out, tracers = {}, {}
    for label, (prompts, gens, max_len, kw) in workloads.items():
        runs = {}
        for path in ("eager", "graph"):
            tracer = Tracer()
            engine = _engine(cfg, params, max_len, path == "graph", tracer,
                             **kw)
            _zero_counts()
            outs, metrics = serve.run_continuous(engine, prompts, gens)
            launches = _read_counts()
            spans = span_summary(tracer.to_dict()["traceEvents"])
            runs[path] = dict(outs=outs, metrics=metrics, launches=launches)
            out.setdefault(label, {})[path] = {
                "tok_per_s": metrics["tok_per_s"],
                "tpot_p50_ms": metrics["latency"]["tpot_s"]["p50"] * 1e3,
                "decode_step_p50_ms": spans["decode_step"]["p50_ms"],
                "decode_step_mean_ms": (spans["decode_step"]["total_ms"]
                                        / spans["decode_step"]["n"]),
                "decode_steps": metrics["decode_steps"],
                "wall_s": metrics["wall_s"],
                "launches": {k: launches[k] for k in GRAPH_KERNELS}}
            if path == "graph":
                tracers[label] = (tracer, metrics)
            del engine
        eager, graph = runs["eager"], runs["graph"]
        for i, (a, b) in enumerate(zip(eager["outs"], graph["outs"])):
            if not np.array_equal(a, b):
                raise AssertionError(f"decode_graph {label}: request {i}'s "
                                     f"tokens differ between eager and graph")
        if eager["metrics"]["cache"] != graph["metrics"]["cache"]:
            raise AssertionError(
                f"decode_graph {label}: cache metrics differ: eager "
                f"{eager['metrics']['cache']}, graph "
                f"{graph['metrics']['cache']}")
        for k in GRAPH_KERNELS:
            if eager["launches"][k] != graph["launches"][k]:
                raise AssertionError(
                    f"decode_graph {label}: {k} launched "
                    f"{eager['launches'][k]} times eagerly, "
                    f"{graph['launches'][k]} through the graph")

        # one decode-only step of fresh engines on the same requests
        steps = {}
        for path in ("eager", "graph"):
            engine = _engine(cfg, params, max_len, path == "graph", **kw)
            for p, g in zip(prompts, gens):
                engine.submit(p, g)
            per_step = _decode_only_step(engine)
            steps[path] = (engine.last_logits.clone(),
                           {k: per_step[k] for k in GRAPH_KERNELS})
            del engine
        (le, ce), (lg, cg) = steps["eager"], steps["graph"]
        if ce != cg:
            raise AssertionError(f"decode_graph {label}: launches per "
                                 f"decode step differ: eager {ce}, graph {cg}")
        if not torch.equal(le, lg):
            diff = float((le.float() - lg.float()).abs().max())
            raise AssertionError(f"decode_graph {label}: one step's logits "
                                 f"differ between eager and graph, max |d| "
                                 f"{diff}")
        out[label]["per_decode_step_launches"] = cg
        print(f"decode_graph {label}: streams, cache metrics and launches "
              f"equal, one step's logits bitwise equal; "
              + json.dumps(out[label]), flush=True)
    return out, tracers


def trace_check(tracer, metrics, label="dense graph"):
    """A graph run's trace: export, validate with the port's
    validate_events and read with scripts/trace_report.py (run as a child
    process: it reads the trace through the reference package, which this
    script never imports); one decode_step span per decode step (and one
    chunk_window span per window), every request's track from submit to
    done; print the spans by name."""
    from repro_torch.obs import load_trace, validate_events
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        path = str(Path(d) / "run.json")
        n_events = tracer.export(path)
        events = load_trace(path)["traceEvents"]
        report = json.loads(subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "trace_report.py"),
             path, "--json"], check=True, capture_output=True, text=True,
            timeout=300).stdout)
    validate_events(events)
    spans = span_summary([e for e in events if e.get("tid") == 0])
    sched = metrics["sched"] or {}
    for name, n in (("decode_step", metrics["decode_steps"]),
                    ("chunk_window", sched.get("chunk_steps", 0))):
        got = spans.get(name, {"n": 0})["n"]
        if got != n or report["step_breakdown"].get(name, {"n": 0})["n"] != n:
            raise AssertionError(f"trace {label}: {got} {name} spans for "
                                 f"{n}")
    if len(report["ttft_waterfall"]) != metrics["drained"]:
        raise AssertionError(f"trace {label}: trace_report's waterfall has "
                             f"{len(report['ttft_waterfall'])} requests")
    # every kernel-phase span carries the warmed plans' modelled roofline,
    # so trace_report's "measured vs modeled" has a row for each
    mvm = report["measured_vs_modeled"]
    for name, n in (("decode_step", metrics["decode_steps"]),
                    ("chunk_window", sched.get("chunk_steps", 0)),
                    ("prefill", metrics["prefill_steps"])):
        if n and mvm.get(name, {}).get("n") != n:
            raise AssertionError(f"trace {label}: measured_vs_modeled has "
                                 f"{mvm.get(name)} for {n} {name} spans")
    tracks = {}
    for e in events:
        if e["ph"] != "M" and e.get("tid", 0) > 0:
            tracks.setdefault(e["tid"], []).append(e["name"])
    if len(tracks) != metrics["drained"] or tracer.dropped:
        raise AssertionError(f"trace {label}: {len(tracks)} request tracks "
                             f"for {metrics['drained']} requests, "
                             f"{tracer.dropped} events dropped")
    for tid, names in tracks.items():
        if names[0] != "submit" or names[-1] != "done" or (
                sched.get("chunked_prefill") and "admit" not in names):
            raise AssertionError(f"trace {label}: request track {tid} runs "
                                 f"{names}")
    print(f"trace: {label} run, {n_events} events, valid, read by "
          f"trace_report (busy {report['interleave']['busy_frac']:.4f}); "
          f"engine spans {json.dumps(spans)}; measured vs modeled "
          f"{json.dumps(mvm)}", flush=True)
    return spans


def _split_check(what, cfg, params, prompt, ref, got, front=None,
                 tol=LOGIT_TOL):
    """Where two greedy streams of one request part, and what ``got`` does
    after: prefill the prompt and ``got``'s tokens (the card's prefill
    path, teacher-forced; ``front``: the request's frontend rows, as
    ``{"vision_embeds" | "enc_embeds": (S_front, d)}``) and read, at
    every position from the split on, how far the token ``got`` chose
    lies below the prefill's top logit (its lag). Fails unless both
    streams' tokens at the split and every later token of ``got`` lag by
    at most ``tol`` (LOGIT_TOL), an absolute bound (near ties only)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import LM

    j = int(np.nonzero(ref != got)[0][0])
    seq = np.concatenate([prompt, got[:-1]]).astype(np.int32)
    batch = {"tokens": torch.as_tensor(seq[None], device="cuda")}
    for k, v in (front or {}).items():
        batch[k] = torch.as_tensor(v[None], device="cuda")
    rows = batch.get("vision_embeds", batch["tokens"][:, :0]).shape[1]
    with torch.no_grad(), ops.serving_phase("prefill"):
        _, logits = LM(cfg, "cuda").prefill(
            params, batch, len(seq) + rows,
            logits_from=len(prompt) - 1 - len(seq))
    rows = logits[0].float()          # row t predicts got[t]
    top = rows.max(dim=-1).values
    idx = torch.as_tensor(got, dtype=torch.long, device=rows.device)
    lag = (top - rows.gather(1, idx[:, None])[:, 0])[j:].cpu()
    top2 = rows[j].topk(2).values
    gap = float(top2[0] - top2[1])
    ref_lag = float(top[j] - rows[j, int(ref[j])])
    split = {"token": j, "gap": gap, "ref_lag": ref_lag,
             "max_lag_after": float(lag.max()),
             "tokens_after": int(len(lag)),
             "off_argmax_after": int((lag > 0).sum())}
    print(f"{what}: streams part at token {j}, top-2 gap {gap:.4g}, lags "
          f"there {ref_lag:.4g} / {float(lag[0]):.4g}; {len(lag)} tokens "
          f"from the split on, {split['off_argmax_after']} off the "
          f"teacher-forced argmax, max lag {split['max_lag_after']:.4g} "
          f"(bound {tol:.4g})", flush=True)
    if max(ref_lag, split["max_lag_after"]) > tol:
        raise AssertionError(f"{what}: from token {j} on a token lies more "
                             f"than {tol} below the top logit "
                             f"({json.dumps(split)})")
    return split


def streams_or_near_ties(what, cfg, params, prompts, ref_outs, got_outs,
                         extras=None, tol=LOGIT_TOL):
    """Equal streams, or each split at a near tie and every later token a
    near-greedy one (``_split_check`` within ``tol``; ``extras``: the
    workload's frontend rows, a request's row with its prompt)."""
    import numpy as np
    splits = {}
    for i, (p, a, b) in enumerate(zip(prompts, ref_outs, got_outs)):
        if len(a) != len(b):
            raise AssertionError(f"{what}: request {i}: {len(b)} tokens "
                                 f"against {len(a)}")
        if not np.array_equal(a, b):
            splits[i] = _split_check(
                f"{what} request {i}", cfg, params, p, a, b,
                {k: v[i] for k, v in (extras or {}).items()}, tol=tol)
    print(f"{what}: {len(prompts) - len(splits)}/{len(prompts)} streams "
          f"equal, {len(splits)} split at near ties", flush=True)
    return splits


def chunked_run(label, cfg, params, prompts, gens, max_len, chunk, *,
                graph=True, tracer=None, **engine_kw):
    """Drain one workload through a chunked engine on the card, the launch
    counters set to 0 just before the run and read just after. Checks every
    request drained with its budget of in-range tokens, no whole-prompt
    prefill, the prompt tokens committed, every captured window's launches
    (B1 49, B4 12, B5 12 paged) and the run's: each decode step and each
    window launches those once."""
    from repro_torch.launch import serve
    from repro_torch.serving import SchedConfig

    engine = _engine(cfg, params, max_len, graph, tracer,
                     sched=SchedConfig(chunk_tokens=chunk), **engine_kw)
    paged = engine_kw.get("cache") == "paged"
    per_step = {"ternary_gemm": 4 * cfg.num_layers + 1,
                "fused_mlp": cfg.num_layers,
                "paged_decode_attention": cfg.num_layers if paged else 0}
    per_window = engine.chunker.launches_per_replay
    if graph and not per_window:
        raise AssertionError(f"{label}: no window was captured")
    for width, counts in per_window.items():
        if {k: counts[k] for k in per_step} != per_step:
            raise AssertionError(f"{label}: the window of width {width} "
                                 f"launches {counts}, expected {per_step}")
    _zero_counts()
    outs, metrics = serve.run_continuous(engine, prompts, gens)
    launches = _read_counts()
    sched = metrics["sched"]
    brief = {k: v for k, v in metrics.items() if k != "per_request"}
    print(f"{label} metrics: " + json.dumps(brief), flush=True)
    print(f"{label} launches: {json.dumps(launches)}", flush=True)
    if metrics["drained"] != len(gens) or metrics["prefill_steps"]:
        raise AssertionError(f"{label}: drained {metrics['drained']} of "
                             f"{len(gens)}, {metrics['prefill_steps']} "
                             f"whole-prompt prefills")
    for i, (toks, g) in enumerate(zip(outs, gens)):
        if len(toks) != g or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{label}: request {i}: {len(toks)} tokens "
                                 f"for a budget of {g}, or ids out of range")
    prompt_tokens = sum(len(p) for p in prompts)
    replays = metrics["cache"].get("preemptions", 0)
    if (sched["chunk_tokens_committed"] < prompt_tokens
            or (not replays
                and sched["chunk_tokens_committed"] != prompt_tokens)):
        raise AssertionError(f"{label}: {sched['chunk_tokens_committed']} "
                             f"prompt tokens committed for {prompt_tokens} "
                             f"({replays} preemptions)")
    steps = metrics["decode_steps"] + sched["chunk_steps"]
    want = {k: v * steps for k, v in per_step.items()}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"{label}: launched {launches}, expected "
                             f"{want} ({metrics['decode_steps']} decode "
                             f"steps + {sched['chunk_steps']} windows)")
    return outs, metrics, launches, per_window


def chunk_kernel_rows():
    """B1 and B4 at the widest window's M (8 x 32 = 256) under the "chunk"
    phase, and B5 at that window's 256 flattened rows (lengths pos + j +
    1, each slot's table repeated 32 times) against its plain version and
    against one-row calls, bit for bit; each timed as the serving shapes
    are."""
    import torch
    from repro_torch.kernels import ops

    w = B5_WINDOW
    m = w["b"] * w["s"]
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    rows = {"ternary_gemm": [gemm_row(gen, m, k, n, "chunk", flush)
                             for k, n in ((1024, 1024), (1024, 32768))],
            "fused_mlp": [mlp_row(gen, m, 1024, 4096, 1024, "chunk", flush)]}
    pos = torch.tensor(w["pos"], dtype=torch.int32, device="cuda")
    q8, k, v, _, table8 = _paged_inputs(gen, w, lambda: pos + w["s"])
    del q8
    q = torch.randn(m, w["h"], w["hd"], generator=gen,
                    device="cuda").to(torch.bfloat16)
    lengths = (pos[:, None] + torch.arange(1, w["s"] + 1, device="cuda",
                                           dtype=torch.int32)).reshape(-1)
    table = table8.repeat_interleave(w["s"], dim=0).contiguous()
    with ops.serving_phase("chunk"):
        rows["paged_decode_attention"] = paged_rows(
            f"window {w['b']} x {w['s']}", w,
            (q, k, v, lengths.contiguous(), table), flush,
            subsets=[[i] for i in range(m)], on_path=True,
            read_tokens=int((pos + w["s"]).sum()))
    for row in rows["paged_decode_attention"]:
        row["phase"] = "chunk"
    del flush
    return rows


def chunked_closed_loop(cfg, params, workloads, whole_outs):
    """(a) The serving workloads with chunked prefill: dense and paged
    bf16 streams against the whole-prompt runs' (equal or split at near
    ties), int8 pages at two chunk sizes against each other (equal).
    Returns the runs' launches, readings and token streams."""
    import numpy as np
    runs, out, streams = {}, {}, {}
    for label in ("dense", "paged_bf16", "paged_int8"):
        prompts, gens, max_len, kw = workloads[label]
        outs, metrics, runs[f"chunked_{label}"], per_window = chunked_run(
            f"chunked {label}", cfg, params, prompts, gens, max_len,
            CHUNK["tokens"], **kw)
        streams[label] = outs
        out[label] = {"sched": metrics["sched"], "tok_per_s":
                      metrics["tok_per_s"], "latency": metrics["latency"],
                      "cache": metrics["cache"],
                      "windows_captured": sorted(per_window)}
        if label == "paged_int8":
            alt, _, runs["chunked_paged_int8_c16"], _ = chunked_run(
                f"chunked {label} at {CHUNK['int8_alt']}", cfg, params,
                prompts, gens, max_len, CHUNK["int8_alt"], **kw)
            for i, (a, b) in enumerate(zip(outs, alt)):
                if not np.array_equal(a, b):
                    raise AssertionError(f"chunked paged int8: request {i} "
                                         f"differs between chunk sizes "
                                         f"{CHUNK['tokens']} and "
                                         f"{CHUNK['int8_alt']}")
            print(f"chunked paged int8: streams equal at chunk sizes "
                  f"{CHUNK['tokens']} and {CHUNK['int8_alt']}", flush=True)
        else:
            out[label]["splits"] = streams_or_near_ties(
                f"chunked {label} vs whole-prompt", cfg, params, prompts,
                whole_outs[label], outs)
    return runs, out, streams


def chunk_graph_check(cfg, params, workloads):
    """(b) The chunked dense workload eagerly and through the captured
    windows in one process: equal streams, sched metrics and launches;
    then one window (the first step of fresh engines) with bitwise equal
    logits and equal launches. Returns both paths' readings and the graph
    run's tracer."""
    import numpy as np
    import torch

    from repro_torch.obs import Tracer
    from repro_torch.serving import SchedConfig

    prompts, gens, max_len, kw = workloads["dense"]
    runs, readings = {}, {}
    for path in ("eager", "graph"):
        tracer = Tracer()
        outs, metrics, launches, _ = chunked_run(
            f"chunked dense {path}", cfg, params, prompts, gens, max_len,
            CHUNK["tokens"], graph=path == "graph", tracer=tracer, **kw)
        spans = span_summary(tracer.to_dict()["traceEvents"])
        runs[path] = (outs, metrics, launches, tracer)
        readings[path] = {
            "tok_per_s": metrics["tok_per_s"],
            "ttft_p50_ms": metrics["latency"]["ttft_s"]["p50"] * 1e3,
            "tpot_p50_ms": metrics["latency"]["tpot_s"]["p50"] * 1e3,
            "chunk_window_p50_ms": spans["chunk_window"]["p50_ms"],
            "decode_step_p50_ms": spans["decode_step"]["p50_ms"],
            "chunk_steps": metrics["sched"]["chunk_steps"]}
    (eo, em, el, _), (go, gm, gl, tracer) = runs["eager"], runs["graph"]
    for i, (a, b) in enumerate(zip(eo, go)):
        if not np.array_equal(a, b):
            raise AssertionError(f"chunk graphs: request {i}'s tokens differ "
                                 f"between eager and graph windows")
    if em["sched"] != gm["sched"] or el != gl:
        raise AssertionError(f"chunk graphs: eager {em['sched']} {el}, "
                             f"graph {gm['sched']} {gl}")
    windows = {}
    for path in ("eager", "graph"):
        engine = _engine(cfg, params, max_len, path == "graph",
                         sched=SchedConfig(chunk_tokens=CHUNK["tokens"]),
                         **kw)
        for p, g in zip(prompts, gens):
            engine.submit(p, g)
        _zero_counts()
        engine.step()                  # admission + the first window
        torch.cuda.synchronize()
        if engine.chunk_steps != 1 or engine.decode_steps:
            raise AssertionError("chunk graphs: the first step ran no "
                                 "window or also decoded")
        windows[path] = (engine.chunker.last_logits.clone(), _read_counts())
        del engine
    (le, ce), (lg, cg) = windows["eager"], windows["graph"]
    if ce != cg:
        raise AssertionError(f"chunk graphs: one window launches {ce} "
                             f"eagerly, {cg} through the graph")
    if not torch.equal(le, lg):
        diff = float((le.float() - lg.float()).abs().max())
        raise AssertionError(f"chunk graphs: one window's logits differ, "
                             f"max |d| {diff}")
    readings["window_logits_shape"] = list(lg.shape)
    print("chunk graphs: streams, sched metrics and launches equal, one "
          "window's logits bitwise equal; " + json.dumps(readings),
          flush=True)
    return readings, (tracer, gm)


def _class_latency(per_request, key):
    from repro_torch.obs.metrics import percentiles
    out = {}
    for name in sorted({r["slo"] for r in per_request}, key=str):
        p = percentiles(r[key] for r in per_request if r["slo"] == name)
        out[str(name)] = (None if p is None else
                          {"p50_ms": p["p50"] * 1e3, "p99_ms": p["p99"] * 1e3,
                           "n": p["n"]})
    return out


def open_loop_phase(cfg, params):
    """(d) One schedule each, Poisson and bursty, through a whole-prompt
    engine (SLO admission) and a chunked one, dense: TTFT and TPOT
    p50/p99 by class, SLO violations, queue wait, windows, prefills and
    the step-time EWMA of each. Returns the readings and launches."""
    import numpy as np
    from repro_torch.serving import (SchedConfig, TrafficConfig,
                                     make_schedule, run_open_loop)
    from repro_torch.serving.sched import DEFAULT_SLO_CLASSES

    ol = OPEN_LOOP
    out, runs = {}, {}
    for kind in ("poisson", "bursty"):
        tc = TrafficConfig(kind=kind, rate=ol["rate"],
                           n_requests=ol["requests"],
                           prompt_lens=ol["prompt_lens"],
                           gen_lens=ol["gen_lens"],
                           burst_size=ol["burst_size"], seed=SEED)
        schedule = make_schedule(tc, cfg.vocab_size,
                                 classes=DEFAULT_SLO_CLASSES,
                                 class_weights=ol["class_weights"])
        streams = {}
        for mode, chunk in (("whole", 0), ("chunked", CHUNK["tokens"])):
            from repro_torch.serving import ContinuousScheduler
            engine = ContinuousScheduler(
                cfg, max_slots=ol["slots"], max_len=ol["max_len"],
                device="cuda", sched=SchedConfig(chunk_tokens=chunk))
            engine.load(params)
            _zero_counts()
            reqs, m = run_open_loop(engine, schedule)
            runs[f"open_loop_{kind}_{mode}"] = _read_counts()
            if m["drained"] != len(schedule) or any(
                    len(r.tokens) != a.max_new
                    for r, a in zip(reqs, schedule)):
                raise AssertionError(f"open loop {kind} {mode}: drained "
                                     f"{m['drained']} of {len(schedule)} "
                                     f"or a budget unmet")
            streams[mode] = [np.asarray(r.tokens) for r in reqs]
            pr = m["per_request"]
            row = {
                "ttft": _class_latency(pr, "ttft_s"),
                "tpot": _class_latency(pr, "tpot_s"),
                "queue_wait": _class_latency(pr, "queue_wait_s"),
                "slo": m["sched"]["slo"],
                "chunk_steps": m["sched"]["chunk_steps"],
                "prefill_steps": m["prefill_steps"],
                "decode_steps": m["decode_steps"],
                "step_time_ewma_ms": engine.metrics.snapshot()
                ["step_time_s"] * 1e3,
                "tok_per_s": m["tok_per_s"], "traffic": m["traffic"]}
            out.setdefault(kind, {})[mode] = row
            print(f"open loop {kind} {mode}: " + json.dumps(row), flush=True)
            del engine
        same = sum(np.array_equal(a, b) for a, b in
                   zip(streams["whole"], streams["chunked"]))
        out[kind]["equal_streams"] = same
        print(f"open loop {kind}: {same}/{len(schedule)} streams equal "
              f"between whole-prompt and chunked (information, not a gate)",
              flush=True)
    return out, runs


def chunk_profile(cfg, params, workloads):
    """(e) One window of 8 rows x 32 on a fresh dense chunked engine,
    eager and through its captured graph, under the profiler."""
    from repro_torch.serving import Request, SchedConfig

    prompts, _, max_len, kw = workloads["dense"]
    rows = {}
    for graph in (False, True):
        engine = _engine(cfg, params, max_len, graph,
                         sched=SchedConfig(chunk_tokens=CHUNK["tokens"]),
                         **kw)
        jobs = [(slot, Request(rid=slot, prompt=prompts[slot], max_new=1),
                 CHUNK["tokens"]) for slot in range(SERVE["slots"])]

        def window():
            engine.chunker.advance(engine.params, engine.pool, jobs,
                                   engine._pos)

        window()
        label = (f"chunk window {SERVE['slots']} x {CHUNK['tokens']} "
                 f"{'graph' if graph else 'eager'}")
        rows[label] = profile_once(
            label, window,
            lambda: _mean_wall(window, PROFILE["unprofiled_iters"]))
        del engine
    return rows


def chunked_phase(cfg, params, workloads, whole_outs):
    """The chunked-prefill slice on the card: (a) closed loop, (b) eager
    against graph windows, (c) the window shapes' kernel rows, (d) open
    loop, (e) profile, (f) a traced chunked run. Returns the kernel rows,
    the runs' launches and the closed-loop runs' token streams."""
    t0 = time.perf_counter()
    runs, closed, streams = chunked_closed_loop(cfg, params, workloads,
                                                whole_outs)
    graph_rows, (tracer, metrics) = chunk_graph_check(cfg, params, workloads)
    trace_spans = trace_check(tracer, metrics, "chunked dense graph")
    del tracer
    kernel_rows = chunk_kernel_rows()
    open_loop, ol_runs = open_loop_phase(cfg, params)
    runs.update(ol_runs)
    profiles = chunk_profile(cfg, params, workloads)
    summary = {"closed_loop": closed, "graphs": graph_rows,
               "trace_spans": trace_spans, "open_loop": open_loop,
               "profiles": profiles}
    print(f"chunked took {time.perf_counter() - t0:.1f}s; summary: "
          + json.dumps(summary), flush=True)
    return kernel_rows, runs, streams


def _per_step_launches(cfg, paged):
    """B1, B4 and B5 launches of one decode step or window replay."""
    return {"ternary_gemm": 4 * cfg.num_layers + 1,
            "fused_mlp": cfg.num_layers,
            "paged_decode_attention": cfg.num_layers if paged else 0}


def faults_run(label, cfg, params, workload, ref_outs, chunk=0):
    """One serving workload under the pinned chaos schedule (``FAULTS``),
    graphed, the launch counters set to 0 just before the run and read
    just after. Checks: every request done, quarantines = injected NaNs >
    0 and = the requests' attempts, the page or slot pool fully reclaimed,
    launches per replay unchanged (B1 49, B4 12, B5 12 paged) and B5's
    launches = 12 per decode step and window, the streams equal to the
    fault-free run's of this process or split at a near tie."""
    import numpy as np
    from repro_torch.serving import FaultConfig, ResilienceConfig, SchedConfig

    prompts, gens, max_len, kw = workload
    f = FAULTS
    paged = kw.get("cache") == "paged"
    extra = dict(sched=SchedConfig(chunk_tokens=chunk)) if chunk else {}
    engine = _engine(cfg, params, max_len, True,
                     faults=FaultConfig(nan_at=f["nan_at"],
                                        oom_at=f["oom_at"],
                                        oom_burst=f["oom_burst"]),
                     resilience=ResilienceConfig(
                         max_retries=f["max_retries"]), **extra, **kw)
    per_step = _per_step_launches(cfg, paged)
    replays = [engine._graph.launches_per_replay]
    if chunk:
        replays += list(engine.chunker.launches_per_replay.values())
    for counts in replays:
        if {k: counts[k] for k in per_step} != per_step:
            raise AssertionError(f"faults {label}: a replay launches "
                                 f"{counts}, expected {per_step}")
    _zero_counts()
    reqs = [engine.submit(p, g) for p, g in zip(prompts, gens)]
    metrics = engine.run()
    launches = _read_counts()
    fm = metrics["faults"]
    steps = metrics["decode_steps"] + (metrics["sched"]["chunk_steps"]
                                       if chunk else 0)
    print(f"faults {label}: faults {json.dumps(fm)}, cache "
          f"{json.dumps(metrics['cache'])}, {steps} decode steps and "
          f"windows, launches {json.dumps(launches)}", flush=True)
    if any(r.state != "done" for r in reqs):
        raise AssertionError(f"faults {label}: not every request is done: "
                             f"{[(r.rid, r.state, r.fail_reason) for r in reqs]}")
    if not (fm["quarantines"] == fm["injected"]["nan_logits"]
            == sum(r.attempts for r in reqs) > 0):
        raise AssertionError(f"faults {label}: quarantines "
                             f"{fm['quarantines']}, injected NaNs "
                             f"{fm['injected']['nan_logits']}, attempts "
                             f"{sum(r.attempts for r in reqs)}")
    if paged and fm["injected"]["page_oom"] != len(f["oom_at"]):
        raise AssertionError(f"faults {label}: {fm['injected']} page OOMs")
    if not (engine.pool.all_reclaimed if paged else engine.pool.all_free):
        raise AssertionError(f"faults {label}: the pool is not reclaimed")
    # whole-prompt prefill launches B1 and B4 too (not B5); a chunked run
    # launches nothing but its decode steps and windows
    want = {k: v * steps for k, v in per_step.items()
            if chunk or k == "paged_decode_attention"}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"faults {label}: launched {launches}, "
                             f"expected {want}")
    outs = [np.asarray(r.tokens, np.int32) for r in reqs]
    splits = streams_or_near_ties(f"faults {label} vs fault-free", cfg,
                                  params, prompts, ref_outs, outs)
    return launches, {"faults": fm, "decode_steps": metrics["decode_steps"],
                      "attempts": [r.attempts for r in reqs],
                      "cache": metrics["cache"], "splits": len(splits),
                      "tok_per_s": metrics["tok_per_s"]}


def faults_terminal_runs(cfg, params, workload):
    """A NaN at every step from step 2 with no retries: every request ends
    failed with nan_logits. Then every step slowed by FAULTS["slow_s"]
    against a FAULTS["deadline_s"] deadline: the requests that cannot
    finish in time end failed with "deadline", queued or live. Both
    graphed dense, counters set to 0 before each and read after."""
    from repro_torch.serving import FaultConfig, ResilienceConfig

    prompts, gens, max_len, kw = workload
    f = FAULTS
    runs, out = {}, {}
    n = f["fail_requests"]
    engine = _engine(cfg, params, max_len, True,
                     faults=FaultConfig(nan_at=tuple(range(2, 1000))),
                     resilience=ResilienceConfig(max_retries=0), **kw)
    _zero_counts()
    reqs = [engine.submit(p, g) for p, g in zip(prompts[:n], gens[:n])]
    fm = engine.run()["faults"]
    runs["faults_no_retries"] = _read_counts()
    if not (all(r.state == "failed" and r.fail_reason == "nan_logits"
                for r in reqs)
            and fm["failed_requests"] == fm["quarantines"] == n
            and engine.pool.all_free):
        raise AssertionError(f"faults, no retries: {fm}, "
                             f"{[(r.state, r.fail_reason) for r in reqs]}")
    out["no_retries"] = fm
    print(f"faults, no retries: all {n} requests failed with nan_logits, "
          f"slots reclaimed; {json.dumps(fm)}", flush=True)
    del engine

    engine = _engine(cfg, params, max_len, True,
                     faults=FaultConfig(slow_at=tuple(range(1, 100_000)),
                                        slow_s=f["slow_s"]),
                     resilience=ResilienceConfig(deadline_s=f["deadline_s"]),
                     **kw)
    _zero_counts()
    reqs = [engine.submit(p, g) for p, g in zip(prompts, gens)]
    fm = engine.run()["faults"]
    runs["faults_deadline"] = _read_counts()
    late = [r for r in reqs if r.fail_reason == "deadline"]
    done = [r for r in reqs if r.state == "done"]
    if not (late and len(late) + len(done) == len(reqs)
            and fm["degradations"]["deadline_cancellations"] == len(late)
            and all(len(r.tokens) == g for r, g in zip(reqs, gens)
                    if r.state == "done")
            and engine.pool.all_free):
        raise AssertionError(f"faults, deadline: {fm}, "
                             f"{[(r.state, r.fail_reason) for r in reqs]}")
    out["deadline"] = {"done": len(done), "deadline": len(late),
                       "cancelled_live": sum(r.first_token_t is not None
                                             for r in late), "faults": fm}
    print(f"faults, deadline {f['deadline_s']} s at {f['slow_s']} s a step: "
          + json.dumps(out["deadline"]), flush=True)
    return runs, out


def poison_check(cfg, params, workload):
    """NaN written into one live slot's K (last layer, position 0) between
    two replays of the captured decode step: the graph's guard flags that
    slot alone, which is quarantined while the others commit."""
    import torch
    prompts, _, max_len, kw = workload
    engine = _engine(cfg, params, max_len, True, **kw)
    for p in prompts[:SERVE["slots"]]:
        engine.submit(p, max_len - len(p))
    _decode_only_step(engine)
    victim = FAULTS["poison_slot"]
    before = {s: len(r.tokens) for s, r in engine._live.items()}
    engine.pool.layers[-1]["k"][victim, 0] = float("nan")
    engine.step()
    torch.cuda.synchronize()
    ok = engine._dev_ok.cpu().tolist()
    finite = torch.isfinite(engine.last_logits).all(dim=-1).cpu().tolist()
    others = [s for s in before if s != victim]
    if not (engine.quarantines == 1 and victim not in engine._live
            and ok == [int(s != victim) for s in range(SERVE["slots"])]
            and finite == [s != victim for s in range(SERVE["slots"])]
            and all(len(engine._live[s].tokens) == before[s] + 1
                    for s in others)):
        raise AssertionError(f"poison: quarantines {engine.quarantines}, "
                             f"guard {ok}, finite rows {finite}")
    print(f"faults poison: NaN in slot {victim}'s cache flagged by the "
          f"captured guard ({ok}), that slot alone quarantined", flush=True)
    return {"slot": victim, "guard": ok}


def faults_phase(cfg, params, workloads, ref_streams, graph_rows,
                 profile_rows):
    """The serving fault model on the card, graphed: dense, paged bf16 and
    chunked dense under the pinned chaos schedule, the terminal runs (no
    retries; deadlines), the cache-poison check, and the guarded decode
    step's readings from decode_graph and the profiler. Returns the runs'
    launches."""
    t0 = time.perf_counter()
    runs, summary = {}, {}
    for label, wl, chunk in (("dense", "dense", 0),
                             ("paged_bf16", "paged_bf16", 0),
                             ("chunked_dense", "dense", CHUNK["tokens"])):
        runs[f"faults_{label}"], summary[label] = faults_run(
            label, cfg, params, workloads[wl], ref_streams[label], chunk)
    term_runs, summary["terminal"] = faults_terminal_runs(
        cfg, params, workloads["dense"])
    runs.update(term_runs)
    summary["poison"] = poison_check(cfg, params, workloads["dense"])
    prof = profile_rows["decode dense graph"]
    summary["guarded_step"] = {
        "decode_step_p50_ms": graph_rows["dense"]["graph"][
            "decode_step_p50_ms"],
        "device_busy_us": prof["device_busy_us"],
        "kernels": prof["kernels"],
        "unprofiled_wall_us": prof.get("unprofiled_wall_us")}
    print(f"faults took {time.perf_counter() - t0:.1f}s; summary: "
          + json.dumps(summary), flush=True)
    return runs


def _spec_config(draft):
    from repro_torch.spec import SpecConfig
    return SpecConfig(draft=draft, k=SPEC["k"],
                      draft_layers=SPEC["draft_layers"],
                      draft_sparsity=SPEC["draft_sparsity"])


def _draft_launches(cfg, draft):
    """B1, B4 and B5 launches of one draft round: k+1 feeds (the re-sync
    and k greedy ones) of the draft's layers and lm head."""
    layers = (SPEC["draft_layers"] if draft == "layer_skip"
              else cfg.num_layers)
    return {"ternary_gemm": (SPEC["k"] + 1) * (4 * layers + 1),
            "fused_mlp": (SPEC["k"] + 1) * layers,
            "paged_decode_attention": 0}


def spec_run(label, cfg, params, workload, draft, ref_outs, **extra):
    """Drain one serving workload through a graphed spec engine (max_len +
    k), traced, the launch counters set to 0 just before the run and read
    just after. Checks the captured draft round's and verify window's
    launches per replay, every request's budget of in-range tokens, B5 =
    12 per round or decode step (paged; 0 dense), a paged pool fully
    reclaimed, and the streams against ``ref_outs`` (the non-spec run's):
    equal or split at near ties. Returns the launches, the readings and
    the requests."""
    import numpy as np
    from repro_torch.obs import Tracer

    prompts, gens, max_len, kw = workload
    paged = kw.get("cache") == "paged"
    tracer = Tracer()
    engine = _engine(cfg, params, max_len + SPEC["k"], True, tracer,
                     spec=_spec_config(draft), **kw, **extra)
    per_replay = {name: g.launches_per_replay
                  for name, g in engine.spec_graphs.items()}
    want = {"draft": _draft_launches(cfg, draft),
            "verify": _per_step_launches(cfg, paged)}
    for name, counts in want.items():
        got = {k: per_replay.get(name, {}).get(k) for k in counts}
        if got != counts:
            raise AssertionError(f"spec {label}: a {name} replay launches "
                                 f"{got}, expected {counts}")
    _zero_counts()
    reqs = [engine.submit(p, g) for p, g in zip(prompts, gens)]
    metrics = engine.run()
    launches = _read_counts()
    s = metrics["spec"]
    brief = {k: v for k, v in s.items() if k != "per_request"}
    outs = [np.asarray(r.tokens, np.int32) for r in reqs]
    if metrics["drained"] != len(gens) or s["rounds"] <= 0:
        raise AssertionError(f"spec {label}: drained {metrics['drained']} "
                             f"of {len(gens)}, {s['rounds']} rounds")
    for i, (toks, g) in enumerate(zip(outs, gens)):
        if len(toks) != g or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"spec {label}: request {i}: {len(toks)} "
                                 f"tokens for a budget of {g}, or ids out "
                                 f"of range")
    b5 = cfg.num_layers * metrics["decode_steps"] if paged else 0
    if launches["paged_decode_attention"] != b5:
        raise AssertionError(f"spec {label}: B5 launched "
                             f"{launches['paged_decode_attention']} times, "
                             f"expected {b5}")
    if not (engine.pool.all_reclaimed if paged else engine.pool.all_free):
        raise AssertionError(f"spec {label}: the pool is not reclaimed")
    spans = span_summary(tracer.to_dict()["traceEvents"])
    row = {"spec": brief, "decode_steps": metrics["decode_steps"],
           "tok_per_s": metrics["tok_per_s"],
           "tpot_p50_ms": metrics["latency"]["tpot_s"]["p50"] * 1e3,
           "ttft_p50_ms": metrics["latency"]["ttft_s"]["p50"] * 1e3,
           "wall_s": metrics["wall_s"], "cache": metrics["cache"],
           "faults": metrics["faults"],
           "launches_per_replay": per_replay,
           "span_p50_ms": {n: spans[n]["p50_ms"]
                           for n in ("draft", "verify", "decode_step")
                           if n in spans}}
    print(f"spec {label}: " + json.dumps(row), flush=True)
    print(f"spec {label} launches: {json.dumps(launches)}", flush=True)
    row["splits"] = len(streams_or_near_ties(
        f"spec {label} vs non-spec", cfg, params, prompts, ref_outs, outs))
    return launches, row, reqs


def _live_spec_engine(cfg, params, workload):
    """A graphed spec engine with the workload's first 8 prompts admitted
    (budgets of SPEC["check_gen"] tokens) and one round run, its host
    state pushed for the next round and, paged, that round's pages
    grown."""
    import torch
    prompts, _, max_len, kw = workload
    engine = _engine(cfg, params, max_len + SPEC["k"], True,
                     spec=_spec_config("layer_skip"), **kw)
    for p in prompts[:SERVE["slots"]]:
        engine.submit(p, SPEC["check_gen"])
    while engine.queue or engine.spec_rounds < 1:
        engine.step()
    if engine.cache_mode == "paged":
        engine._grow_paged(1 + SPEC["k"])
    engine._push_host_state()
    torch.cuda.synchronize()
    if len(engine._live) != SERVE["slots"]:
        raise AssertionError("spec: a check request ended early")
    return engine


def _cache_tensors(layers):
    from repro_torch.paging import Int8Pages
    for layer in layers:
        for t in layer.values():
            if isinstance(t, Int8Pages):
                yield t.codes
                yield t.scales
            else:
                yield t


def verify_vs_sequential(cfg, params, workload, label):
    """One verify window's logits against k + 1 one-token steps from the
    same cache state, both replayed from the engine's graphs: the draft
    round fills the window, the verify graph runs it, the pool's caches
    are restored, then the decode graph runs the window's tokens one at a
    time. Returns max |d| and whether they are bitwise equal (and equal
    greedy tokens) at each window position."""
    import torch
    engine = _live_spec_engine(cfg, params, workload)
    engine._draft_graph.replay()
    saved = [t.clone() for t in _cache_tensors(engine.pool.layers)]
    window = engine._dev_win.clone()
    pos = engine._dev_pos.clone()
    engine._verify_graph.replay()
    win = engine._verify_logits.clone()
    for t, s in zip(_cache_tensors(engine.pool.layers), saved):
        t.copy_(s)
    seq = []
    for j in range(SPEC["k"] + 1):
        engine._dev_tok.copy_(window[:, j])
        engine._dev_pos.copy_(pos + j)
        engine._graph.replay()
        seq.append(engine._step_logits.clone())
    torch.cuda.synchronize()
    seq = torch.stack(seq, dim=1)
    per_pos = [{"bitwise": bool(torch.equal(win[:, j], seq[:, j])),
                "max_abs": float((win[:, j].float() - seq[:, j].float())
                                 .abs().max()),
                "greedy_equal": int((win[:, j].argmax(-1)
                                     == seq[:, j].argmax(-1)).sum())}
               for j in range(SPEC["k"] + 1)]
    out = {"bitwise": all(r["bitwise"] for r in per_pos),
           "max_abs": max(r["max_abs"] for r in per_pos),
           "max_logit": float(seq.float().abs().max()),
           "positions": per_pos}
    print(f"spec verify vs sequential, {label}: " + json.dumps(out),
          flush=True)
    if not bool(torch.isfinite(win).all()) or \
            out["max_abs"] > LOGIT_TOL * out["max_logit"]:
        raise AssertionError(f"spec verify vs sequential {label}: max |d| "
                             f"{out['max_abs']}")
    del engine
    return out


def verify_op_check():
    """Which op of a verify window rounds otherwise than in the one-token
    steps, on the card, op by op at the main path's widths: B1 (q/k/v/o
    width and lm head) and B4 on 40 rows under "verify" against the same
    rows as 5 calls of 8 under "decode", at the verify tile and at the
    prefill tile (each timed at M 40); the dense attention (naive, cuBLAS)
    over 5 query rows against 5 one-row calls; B5 over 40 rows against 5
    calls of 8. Returns op -> bitwise, max |d| (and the tiles' times)."""
    import torch
    from repro_torch.kernels import fused_mlp as fused_lib
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_gemm as gemm_lib
    from repro_torch.models.attention import naive_attention
    from repro_torch.paging import kernels as paged_lib

    b, s = SERVE["slots"], SPEC["k"] + 1
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    out = {}

    def rows_check(name, fn40, fn8):
        y40 = fn40().reshape(b, s, -1)
        y8 = [fn8(j).reshape(b, -1) for j in range(s)]
        out[name] = {
            "bitwise": all(torch.equal(y40[:, j], y8[j]) for j in range(s)),
            "max_abs": max(float((y40[:, j].float() - y8[j].float()).abs()
                                 .max()) for j in range(s))}

    for k, n in ((1024, 1024), (1024, 32768)):
        w = _packed_weight(gen, k, n)
        x = torch.randn(b, s, k, generator=gen, device="cuda").to(
            torch.bfloat16)
        x40 = x.reshape(b * s, k)

        def decode8(j, w=w, x=x):
            return gemm_lib.ternary_gemm_cuda(
                x[:, j].contiguous(), w.packed, w.scale, w.bias, n=w.n,
                block_m=16, block_n=64)
        for tile, (bm, bn) in (("verify", FIXED_TILE["verify"]),
                               ("prefill", FIXED_TILE["prefill"])):
            call = (lambda w=w, bm=bm, bn=bn: gemm_lib.ternary_gemm_cuda(
                x40, w.packed, w.scale, w.bias, n=w.n, block_m=bm,
                block_n=bn))
            rows_check(f"B1 K {k} N {n}, {tile} tile", call, decode8)
            out[f"B1 K {k} N {n}, {tile} tile"]["ms"] = cuda_ms(call, 20,
                                                               flush)
    wi, wg, wo = (_packed_weight(gen, a, c)
                  for a, c in ((1024, 4096), (1024, 4096), (4096, 1024)))
    x = torch.randn(b, s, 1024, generator=gen, device="cuda").to(
        torch.bfloat16)
    args = (wi.packed, wo.packed, wg.packed, wi.scale, None, wg.scale, None,
            wo.scale, None)
    for tile in ("verify", "prefill"):
        call = (lambda t=FIXED_TILE[tile]: fused_lib.fused_mlp_cuda(
            x.reshape(b * s, 1024), *args, block_m=t[0], strip=t[1]))
        rows_check(f"B4, {tile} tile", call,
                   lambda j: fused_lib.fused_mlp_cuda(
                       x[:, j].contiguous(), *args, block_m=16, strip=64))
        out[f"B4, {tile} tile"]["ms"] = cuda_ms(call, 20, flush)
    # dense attention: 16 heads of 64 over a 197-long bf16 cache view
    pos = torch.tensor(B5_VERIFY["pos"], dtype=torch.int32, device="cuda")
    q = torch.randn(b, s, 16, 64, generator=gen, device="cuda").to(
        torch.bfloat16)
    kc, vc = (torch.randn(b, 197, 16, 64, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    rows_check("dense attention (naive, cuBLAS)",
               lambda: naive_attention(q, kc, vc, causal=True, q_offset=pos),
               lambda j: naive_attention(q[:, j:j + 1], kc, vc, causal=False,
                                         q_offset=pos + j,
                                         kv_valid_len=pos + j + 1)[:, 0])
    qp, kp, vp, _, table = _paged_inputs(gen, B5_VERIFY,
                                         lambda: pos + s)
    kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    q40 = torch.randn(b * s, 16, 64, generator=gen, device="cuda").to(
        torch.bfloat16)
    lengths = (pos[:, None] + torch.arange(1, s + 1, device="cuda",
                                           dtype=torch.int32))
    rows_check("B5 (paged attention)",
               lambda: ops.paged_decode_attention(
                   q40, kp, vp, table.repeat_interleave(s, dim=0),
                   lengths.reshape(-1)),
               lambda j: ops.paged_decode_attention(
                   q40.view(b, s, 16, 64)[:, j].contiguous(), kp, vp,
                   table, lengths[:, j].contiguous()))
    del flush
    print("spec verify ops, 40 rows against 5 x 8: " + json.dumps(out),
          flush=True)
    return out


def spec_kernel_rows():
    """B1 at M 40 (q/k/v/o width and lm head) and B4 at M 40 under the
    "verify" phase, and B5 over a verify window's 40 rows (lengths pos +
    j + 1) against its plain version and 40 one-row calls, bit for bit;
    each timed as the serving shapes are."""
    import torch
    from repro_torch.kernels import ops

    w = B5_VERIFY
    m = w["b"] * w["s"]
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    rows = {"ternary_gemm": [gemm_row(gen, m, k, n, "verify", flush)
                             for k, n in ((1024, 1024), (1024, 32768))],
            "fused_mlp": [mlp_row(gen, m, 1024, 4096, 1024, "verify",
                                  flush)]}
    pos = torch.tensor(w["pos"], dtype=torch.int32, device="cuda")
    _, k, v, _, table8 = _paged_inputs(gen, w, lambda: pos + w["s"])
    q = torch.randn(m, w["h"], w["hd"], generator=gen,
                    device="cuda").to(torch.bfloat16)
    lengths = (pos[:, None] + torch.arange(1, w["s"] + 1, device="cuda",
                                           dtype=torch.int32)).reshape(-1)
    table = table8.repeat_interleave(w["s"], dim=0).contiguous()
    with ops.serving_phase("verify"):
        rows["paged_decode_attention"] = paged_rows(
            f"verify {w['b']} x {w['s']}", w,
            (q, k, v, lengths.contiguous(), table), flush,
            subsets=[[i] for i in range(m)], on_path=True,
            read_tokens=int((pos + w["s"]).sum()))
    for row in rows["paged_decode_attention"]:
        row["phase"] = "verify"
    del flush
    return rows


def spec_fault_runs(cfg, params, workload, ref_outs):
    """Dense layer_skip under draft faults at SPEC["draft_fail_at"] (each
    a plain graphed decode step) and under an acceptance floor no draft
    reaches: every request done, the fallbacks and the switch-off counted,
    the streams within the rule. Returns the launches and readings."""
    from repro_torch.serving import FaultConfig, ResilienceConfig

    runs, out = {}, {}
    runs["spec_draft_fail"], out["draft_fail"], reqs = spec_run(
        "dense layer_skip, draft faults", cfg, params, workload,
        "layer_skip", ref_outs,
        faults=FaultConfig(draft_fail_at=SPEC["draft_fail_at"]))
    fb = out["draft_fail"]["spec"]["draft_fallbacks"]
    if fb != len(SPEC["draft_fail_at"]) or any(r.state != "done"
                                               for r in reqs):
        raise AssertionError(f"spec draft faults: {fb} fallbacks for "
                             f"{len(SPEC['draft_fail_at'])} faults")
    runs["spec_floor"], out["floor"], reqs = spec_run(
        f"dense layer_skip, acceptance floor {SPEC['accept_floor']}", cfg,
        params, workload, "layer_skip", ref_outs,
        resilience=ResilienceConfig(spec_accept_floor=SPEC["accept_floor"],
                                    spec_floor_window=SPEC["floor_window"]))
    deg = out["floor"]["faults"]["degradations"]
    if not (deg["spec_disabled"] and deg["spec_disables"] == 1
            and out["floor"]["spec"]["rounds"] == SPEC["floor_window"]):
        raise AssertionError(f"spec floor: {deg}, "
                             f"{out['floor']['spec']['rounds']} rounds")
    return runs, out


def spec_phase(cfg, params, workloads, ref_streams, graph_rows):
    """Speculative decoding on the card, every draft round and verify
    window replayed from its CUDA graph: the serving workloads (dense with
    layer_skip and resparsify drafts, paged bf16 and int8 under pressure
    with layer_skip) against the non-spec runs' streams and numbers, the
    verify window against one-token steps (dense, paged bf16) and op by
    op, the fault runs, one profiled round and the kernels at the verify
    shape. Returns the kernel rows and the runs' launches."""
    import numpy as np
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    runs, summary, streams = {}, {"runs": {}}, {}
    for label, wl, draft in (("dense", "dense", "layer_skip"),
                             ("dense", "dense", "resparsify"),
                             ("paged_bf16", "paged_bf16", "layer_skip"),
                             ("paged_int8", "paged_int8", "layer_skip")):
        t_build = time.perf_counter()
        key = f"{label} {draft}"
        runs[f"spec_{label}_{draft}"], row, reqs = spec_run(
            key, cfg, params, workloads[wl], draft, ref_streams[wl])
        streams[key] = [np.asarray(r.tokens) for r in reqs]
        row["non_spec"] = {k: graph_rows[wl]["graph"][k]
                           for k in ("tok_per_s", "tpot_p50_ms",
                                     "decode_step_p50_ms", "decode_steps")}
        row["phase_s"] = round(time.perf_counter() - t_build, 2)
        summary["runs"][key] = row
    # the dense cache is attended over its whole max_len-wide view: the
    # non-spec engine at the spec runs' max_len tells a split the view's
    # width makes from one the verify window makes
    prompts, gens, max_len, _ = workloads["dense"]
    wide, _ = serve.run_continuous(
        _engine(cfg, params, max_len + SPEC["k"], True), prompts, gens)
    summary["dense_equal_streams_of_16"] = {
        f"non-spec at max_len {max_len + SPEC['k']} vs {max_len}": sum(
            np.array_equal(a, b) for a, b in zip(wide, ref_streams["dense"])),
        **{f"{key} vs non-spec at max_len {max_len + SPEC['k']}": sum(
            np.array_equal(a, b) for a, b in zip(streams[key], wide))
           for key in ("dense layer_skip", "dense resparsify")}}
    print("spec dense streams: " + json.dumps(
        summary["dense_equal_streams_of_16"]), flush=True)
    summary["verify_vs_sequential"] = {
        label: verify_vs_sequential(cfg, params, workloads[label], label)
        for label in ("dense", "paged_bf16")}
    summary["verify_ops"] = verify_op_check()
    fault_runs, summary["faults"] = spec_fault_runs(
        cfg, params, workloads["dense"], ref_streams["dense"])
    runs.update(fault_runs)
    engine = _live_spec_engine(cfg, params, workloads["dense"])
    summary["profile"] = profile_once(
        "spec round dense layer_skip graph", engine.step,
        lambda: _mean_wall(engine.step, 4))
    del engine
    rows = spec_kernel_rows()
    print(f"spec took {time.perf_counter() - t0:.1f}s; summary: "
          + json.dumps(summary), flush=True)
    return rows, runs


# --- serving modes: the registries, the static server, SWA and layouts -------

@contextlib.contextmanager
def _recorded_attention():
    """Record every ``naive_attention`` call of the dense attention layers
    and of the ``"jax"`` paged row: (q, k, v, kv_valid_len, out), in call
    order, on the card."""
    from repro_torch.models import attention
    from repro_torch.paging import kernels as paged_lib
    calls, orig = [], attention.naive_attention

    def recording(q, k, v, **kw):
        out = orig(q, k, v, **kw)
        calls.append((q.clone(), k.clone(), v.clone(),
                      kw.get("kv_valid_len"), out.clone()))
        return out

    attention.naive_attention = paged_lib.naive_attention = recording
    try:
        yield calls
    finally:
        attention.naive_attention = paged_lib.naive_attention = orig


def _first_differing_op(what, dense_calls, paged_calls, valid):
    """Layer by layer, the first attention call whose output differs
    between the dense and the paged run, and whether its inputs (q, and
    K/V over the ``valid`` positions) were equal: equal inputs name the
    attention op itself (cuBLAS over a view of another width or layout),
    unequal ones an op before it."""
    import torch
    for layer, (d, p) in enumerate(zip(dense_calls, paged_calls)):
        if torch.equal(d[4], p[4]):
            continue
        inputs = (torch.equal(d[0], p[0])
                  and all(torch.equal(a[:, :valid], b[:, :valid])
                          for a, b in zip(d[1:3], p[1:3])))
        return {"layer": layer, "inputs_equal": inputs,
                "width": [d[1].shape[1], p[1].shape[1]],
                "max_abs": float((d[4].float() - p[4].float()).abs().max())}
    return None


def paged_jax_logits_check(cfg, params, prompts, max_len):
    """The paged "jax" row against the dense cache on the card, op by op:
    the same prompts prefilled into the dense cache (a max_len-wide view)
    and into a bf16 paged pool (a page-aligned prompt-wide view, as the
    engines prefill), then one decode step each from the same next tokens,
    every attention call recorded. Reports the prefill's first-token
    logits and the decode step's logits bitwise or not, the first
    attention call that differs in each, and the decode attention op on
    identical K/V (the dense cache's own rows copied into pages), which
    must be bitwise."""
    import dataclasses as dc
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.paging import PagePool

    jcfg = dc.replace(cfg, paged_attn_impl="jax")
    model = LM(jcfg, "cuda")
    b, s = prompts.shape
    toks = torch.as_tensor(prompts, device="cuda")
    pos = torch.full((b,), s, dtype=torch.int32, device="cuda")
    out = {}
    with torch.no_grad():
        with _recorded_attention() as dcalls:
            with ops.serving_phase("prefill"):
                cache, dlog = model.prefill(params, {"tokens": toks},
                                            max_len)
            nxt = dlog[:, -1].argmax(-1).to(torch.int32)[:, None]
            with ops.serving_phase("decode"):
                dense, _ = model.decode_step(
                    params, {"layers": cache["layers"], "pos": pos}, nxt)
        pool = PagePool(model, b, max_len, page_size=PAGE_SIZE)
        adms = [pool.admit(p) for p in prompts]
        with _recorded_attention() as pcalls:
            with ops.serving_phase("prefill"):
                pcache, plog = model.prefill(
                    params, {"tokens": toks}, -(-s // PAGE_SIZE) * PAGE_SIZE)
            pool.insert(adms, pcache["layers"])
            for a in adms:
                if not pool.ensure_append(a.slot, s):
                    raise AssertionError("a default-size pool ran dry")
            table = torch.tensor(pool.table, device="cuda")
            with ops.serving_phase("decode"):
                paged, _ = model.decode_step(
                    params, {"layers": pool.layers, "pos": pos,
                             "block_table": table}, nxt)
        n = cfg.num_layers
        out["prefill_logits_bitwise"] = bool(torch.equal(dlog, plog))
        out["prefill_first_diff"] = _first_differing_op(
            "prefill", dcalls[:n], pcalls[:n], s)
        out["decode_logits_bitwise"] = bool(torch.equal(dense, paged))
        out["decode_max_abs"] = float((dense.float() - paged.float())
                                      .abs().max())
        out["decode_first_diff"] = _first_differing_op(
            "decode", dcalls[n:], pcalls[n:], s + 1)
        # the decode op alone: the dense cache's rows as pages
        kc, vc = cache["layers"][0]["k"], cache["layers"][0]["v"]
        t = max_len // PAGE_SIZE
        kp, vp = (torch.cat([torch.zeros_like(c[:1, :PAGE_SIZE]),
                             c.reshape(b * t, PAGE_SIZE, *c.shape[2:])])
                  for c in (kc, vc))
        tbl = (1 + torch.arange(b * t, device="cuda", dtype=torch.int32)
               ).reshape(b, t)
        q = dcalls[n][0][:, 0]
        want = dcalls[n][4][:, 0]
        got = ops.paged_decode_attention(q, kp, vp, tbl, pos + 1,
                                         impl="jax")
        out["decode_op_on_equal_kv_bitwise"] = bool(torch.equal(got, want))
    print("paged jax vs dense at max_len "
          f"{max_len}, op by op: " + json.dumps(out), flush=True)
    if not out["decode_op_on_equal_kv_bitwise"]:
        raise AssertionError("the jax paged row over the dense cache's own "
                             "K/V differs from the dense decode attention")
    if not out["decode_logits_bitwise"] and \
            out["decode_max_abs"] > LOGIT_TOL * float(dense.abs().max()):
        raise AssertionError(f"paged jax vs dense: decode logits differ by "
                             f"{out['decode_max_abs']}")
    return out


def paged_jax_phase(cfg, params, workloads):
    """Dense, paged bf16 under "jax" and under "auto" at max_len
    ``MODES["paged_max_len"]`` (the pool's gathered width), graphed: the
    "jax" streams against the dense ones (equal, or near-tie splits), B5
    launched 0 times under "jax" and 12 a decode step under "auto"; then
    the logits op by op. Returns the runs' launches and the readings."""
    import numpy as np
    prompts, gens, _, _ = workloads["dense"]
    max_len = MODES["paged_max_len"]
    runs, out = {}, {}
    streams = {}
    for label, kw in (("dense", {}),
                      ("paged_jax", dict(cache="paged", page_size=PAGE_SIZE,
                                         paged_attn="jax")),
                      ("paged_auto", dict(cache="paged",
                                          page_size=PAGE_SIZE))):
        key = f"{label}_{max_len}"
        streams[label], metrics, runs[key] = serve_run(
            f"{label} at max_len {max_len}", cfg, params, prompts, gens,
            max_len, **kw)
        out[key] = {"tok_per_s": metrics["tok_per_s"],
                    "decode_steps": metrics["decode_steps"],
                    "b5_launches": runs[key]["paged_decode_attention"]}
    out["jax_equal_dense_of_16"] = sum(
        np.array_equal(a, b) for a, b in zip(streams["dense"],
                                             streams["paged_jax"]))
    out["auto_equal_dense_of_16"] = sum(
        np.array_equal(a, b) for a, b in zip(streams["dense"],
                                             streams["paged_auto"]))
    out["jax_splits"] = streams_or_near_ties(
        f"paged jax vs dense at max_len {max_len}", cfg, params, prompts,
        streams["dense"], streams["paged_jax"])
    out["ops"] = paged_jax_logits_check(cfg, params,
                                        prompts[:SERVE["slots"]], max_len)
    return runs, out


def fused_registry_rows(flush):
    """ops.fused_mlp's two rows at ternary-paper's MLP width, M 8 under
    "decode" and M 1024 under "prefill": "pallas" (B4, one launch) within
    check_close of "chain" (three B1 launches; B4 sums its f32 partials by
    ff chunk, the chain each GEMM whole), both timed."""
    import torch
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    wi, wg, wo = (_packed_weight(gen, a, c)
                  for a, c in ((1024, 4096), (1024, 4096), (4096, 1024)))
    rows, launches = [], {}
    for m, phase in ((8, "decode"), (1024, "prefill")):
        x = torch.randn(m, 1024, generator=gen, device="cuda").to(
            torch.bfloat16)
        with ops.serving_phase(phase):
            got = {}
            for impl in ("pallas", "chain"):
                _zero_counts()
                got[impl] = ops.fused_mlp(x, wi, wo, wg, impl=impl)
                torch.cuda.synchronize()
                launches[f"{impl} M {m}"] = {
                    k: v for k, v in _read_counts().items() if v}
            err = check_close(f"fused_mlp pallas vs chain M={m}",
                              got["pallas"], got["chain"])
            row = {"m": m, "phase": phase, "max_abs_err": err,
                   "bitwise": bool(torch.equal(got["pallas"],
                                               got["chain"])),
                   "pallas_ms": cuda_ms(lambda: ops.fused_mlp(
                       x, wi, wo, wg, impl="pallas"), 20, flush),
                   "chain_ms": cuda_ms(lambda: ops.fused_mlp(
                       x, wi, wo, wg, impl="chain"), 20, flush)}
        rows.append(row)
    want = {"pallas M 8": {"fused_mlp": 1}, "chain M 8": {"ternary_gemm": 3},
            "pallas M 1024": {"fused_mlp": 1},
            "chain M 1024": {"ternary_gemm": 3}}
    if launches != want:
        raise AssertionError(f"fused rows launched {launches}, expected "
                             f"{want}")
    print("fused registry, pallas vs chain: " + json.dumps(rows), flush=True)
    return rows


def static_run(label, cfg, params, prompts, gens, max_len, ref_outs):
    """The static server at batch SERVE["slots"] on the card, eager, the
    launch counters zeroed just before and read just after: every forward
    (a batch's prefill, each decode step) launches B1 4L+1 and B4 L; the
    streams against ``ref_outs`` under the near-tie rule."""
    from repro_torch.launch import serve
    server = serve.BatchedServer(cfg, max_len, "cuda")
    server.load(params)
    _zero_counts()
    outs, metrics = serve.run_static(server, prompts, gens, SERVE["slots"])
    launches = _read_counts()
    forwards = -(-len(prompts) // SERVE["slots"]) + metrics["decode_steps"]
    want = {"ternary_gemm": (4 * cfg.num_layers + 1) * forwards,
            "fused_mlp": cfg.num_layers * forwards,
            "paged_decode_attention": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"static {label}: launched {launches}, "
                             f"expected {want}")
    print(f"static {label} metrics: " + json.dumps(metrics), flush=True)
    splits = streams_or_near_ties(f"static {label}", cfg, params, prompts,
                                  ref_outs, outs)
    return outs, metrics, launches, splits


def swa_phase(cfg, params, workloads, graph_rows):
    """ternary-paper with sliding_window MODES["window"]: prompts of 128
    roll the 64-position cache. bshd, opt and flat, each through the
    graphed dense engine (B1 49 and B4 12 a replay; a run launches those
    per decode step and per prefill) and the static server; the bshd
    engine's streams are the reference for the other five (near-tie rule,
    teacher-forced splits). Prints each graphed decode step's p50 beside
    the full-attention one's."""
    import dataclasses as dc
    from repro_torch.launch import serve
    from repro_torch.obs import Tracer

    prompts, gens, max_len, _ = workloads["dense"]
    runs, out, ref = {}, {}, None
    per_step = {"ternary_gemm": 4 * cfg.num_layers + 1,
                "fused_mlp": cfg.num_layers, "paged_decode_attention": 0}
    for layout, over in (("bshd", {}), ("opt", {"cache_layout": "opt"}),
                         ("flat", {"decode_cache_shard": "flat"})):
        lcfg = dc.replace(cfg, sliding_window=MODES["window"], **over)
        tracer = Tracer()
        engine = _engine(lcfg, params, max_len, True, tracer)
        replay = {k: engine._graph.launches_per_replay[k] for k in per_step}
        if replay != per_step:
            raise AssertionError(f"swa {layout}: a replay launches "
                                 f"{replay}, expected {per_step}")
        _zero_counts()
        outs, metrics = serve.run_continuous(engine, prompts, gens)
        launches = _read_counts()
        forwards = metrics["decode_steps"] + metrics["prefill_steps"]
        if any(launches[k] != v * forwards for k, v in per_step.items()):
            raise AssertionError(f"swa {layout}: launched {launches} for "
                                 f"{forwards} forwards")
        runs[f"swa_{layout}"] = launches
        spans = span_summary(tracer.to_dict()["traceEvents"])
        row = {"tok_per_s": metrics["tok_per_s"],
               "decode_step_p50_ms": spans["decode_step"]["p50_ms"],
               "full_attention_decode_step_p50_ms":
                   graph_rows["dense"]["graph"]["decode_step_p50_ms"],
               "cache_nbytes": metrics["cache"]["nbytes"]}
        del engine
        if ref is None:
            ref = outs
        else:
            row["engine_splits"] = streams_or_near_ties(
                f"swa {layout} engine vs bshd", lcfg, params, prompts, ref,
                outs)
        _, smet, runs[f"swa_{layout}_static"], row["static_splits"] = \
            static_run(f"swa {layout}", lcfg, params, prompts, gens,
                       max_len, ref)
        row["static_tok_per_s"] = smet["tok_per_s"]
        out[layout] = row
        print(f"swa {layout}: " + json.dumps(row), flush=True)
    return runs, out


def _window_pages(pages, table, lengths, window):
    """Each row's last ``min(length, window)`` positions copied, in order,
    into fresh pages of their own (page 0 a zero trash page; positions past
    a row's count repeat its last one and are masked): (pages, table,
    lengths) for the same tokens with no window."""
    import torch
    from repro_torch.paging import Int8Pages
    b = table.shape[0]
    t = -(-window // PAGE_SIZE)
    lo = (lengths - window).clamp(min=0)
    pos = torch.minimum(lo[:, None] + torch.arange(
        t * PAGE_SIZE, device=table.device), lengths[:, None] - 1)
    pids = table.gather(1, (pos // PAGE_SIZE).to(torch.int64))

    def move(a):
        rows = a[pids, pos % PAGE_SIZE].reshape(b * t, PAGE_SIZE,
                                                *a.shape[2:])
        return torch.cat([torch.zeros_like(rows[:1]), rows]).contiguous()

    if isinstance(pages, Int8Pages):
        moved = Int8Pages(move(pages.codes), move(pages.scales))
    else:
        moved = move(pages)
    new_table = (1 + torch.arange(b * t, device=table.device,
                                  dtype=torch.int32)).reshape(b, t)
    return moved, new_table, (lengths - lo).to(torch.int32)


def b5_window_rows(flush):
    """B5 with window MODES["window"] at the serving shape (lengths 1 to
    193) and over a verify window's 40 rows (lengths pos + j + 1), bf16
    and int8 pages: bitwise equal to B5 with no window over the same
    tokens copied into pages of their own (a row's share of its window
    runs the same sums), and within the kernel bound of its plain version
    (whose cuBLAS products sum in another order; max |d| reported). Paged
    pools refuse sliding-window models, so only this check reaches B5's
    window code on the card; the rows are off the path."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.paging import Int8Pages
    from repro_torch.paging import kernels as paged_lib

    window = MODES["window"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    serving = _paged_inputs(gen, PAGED, lambda: torch.randint(
        1, PAGED["max_len"] + 1, (PAGED["b"],), generator=gen, device="cuda",
        dtype=torch.int32))
    w = B5_VERIFY
    pos = torch.tensor(w["pos"], dtype=torch.int32, device="cuda")
    _, k, v, _, table8 = _paged_inputs(gen, w, lambda: pos + w["s"])
    m = w["b"] * w["s"]
    q = torch.randn(m, w["h"], w["hd"], generator=gen,
                    device="cuda").to(torch.bfloat16)
    lengths = (pos[:, None] + torch.arange(1, w["s"] + 1, device="cuda",
                                           dtype=torch.int32)).reshape(-1)
    verify = (q, k, v, lengths.contiguous(),
              table8.repeat_interleave(w["s"], dim=0).contiguous())
    rows = []
    for name, (q, k, v, lens, table) in (("serving", serving),
                                         (f"verify {m} rows", verify)):
        for label in ("bf16", "int8"):
            if label == "int8":
                kp, vp = Int8Pages.quantize(k), Int8Pages.quantize(v)
            else:
                kp, vp = k.to(torch.bfloat16), v.to(torch.bfloat16)
            args = (q, kp, vp, table, lens)
            _zero_counts()
            got = ops.paged_decode_attention(*args, window=window)
            torch.cuda.synchronize()
            if _read_counts()["paged_decode_attention"] != 1:
                raise AssertionError("B5 with a window did not launch")
            what = f"B5 window {window}, {name}, {label} pages"
            kw, tw, lw = _window_pages(kp, table, lens, window)
            vw = _window_pages(vp, table, lens, window)[0]
            if paged_lib.split_plan(table.shape[1], PAGE_SIZE, window) != \
                    paged_lib.split_plan(tw.shape[1], PAGE_SIZE):
                raise AssertionError(f"{what}: the unwindowed copy plans "
                                     f"another split")
            own = ops.paged_decode_attention(q, kw, vw, tw, lw)
            if not torch.equal(got, own):
                d = float((got.float() - own.float()).abs().max())
                raise AssertionError(f"{what}: differs from B5 with no "
                                     f"window over the same tokens, max "
                                     f"|d| {d}")
            ref = paged_lib.paged_decode_attention_ref(*args, window=window)
            err = check_close(what, got, ref)
            row = {"shape": f"{name}, window {window}", "pages": label,
                   "window": window, "max_abs_err": err,
                   "equals_unwindowed_bitwise": True,
                   "split": paged_lib.split_plan(table.shape[1], PAGE_SIZE,
                                                 window).splits,
                   "ms": cuda_ms(lambda: ops.paged_decode_attention(
                       *args, window=window), 20, flush),
                   "on_path": False}
            rows.append(row)
            print(f"{what}: " + json.dumps(row), flush=True)
    return rows


def modes_phase(cfg, params, workloads, dense_outs, graph_rows):
    """The serving modes this slice adds, at full width on the card: the
    paged "jax" row against the dense cache, the fused registry's rows,
    the static server against the continuous engine, sliding-window caches
    in three layouts, and B5 with a window. Returns the kernel rows and
    the runs' launches."""
    import torch
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    summary = {}
    runs, summary["paged_jax"] = paged_jax_phase(cfg, params, workloads)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    summary["fused_rows"] = fused_registry_rows(flush)
    prompts, gens, max_len, _ = workloads["dense"]
    _, smet, runs["static"], splits = static_run(
        "dense", cfg, params, prompts, gens, max_len, dense_outs)
    summary["static"] = {"tok_per_s": smet["tok_per_s"],
                         "continuous_tok_per_s":
                             graph_rows["dense"]["graph"]["tok_per_s"],
                         "splits": splits}
    swa_runs, summary["swa"] = swa_phase(cfg, params, workloads, graph_rows)
    runs.update(swa_runs)
    rows = {"paged_decode_attention": b5_window_rows(flush)}
    del flush
    plans = ops.precompute_fused_plans(params, decode_ms=(SERVE["slots"],))
    summary["fused_plans_decode"] = sorted({(p.impl, p.block_m, p.block_n1)
                                            for p in plans.values()})
    print(f"modes took {time.perf_counter() - t0:.1f}s; summary: "
          + json.dumps(summary), flush=True)
    return rows, runs


def tcsc_phase(flush):
    """The paper's TCSC formats on the card (plain PyTorch: no TPU kernel
    computes them) at K = N = 4096, s 1/2 and 1/16, M 8 and 64: each
    format's arrays round-trip to the matrix; each matmul (f32 in and
    out) agrees with ``ternary_matmul_dense`` within 1e-4 of max|ref| and
    with B1 through ``ops`` on the same bf16 inputs within the kernel
    bound; each timed beside B1, ``torch.matmul`` on the decoded bf16
    weights and the plain dense matmul. Returns the rows."""
    import numpy as np
    import torch
    from repro_torch.core import formats, weights
    from repro_torch.kernels import ops, ref

    tc = TCSC_CHECK
    k, n = tc["k"], tc["n"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    fns = {"tcsc": ref.tcsc_matmul, "blocked": ref.tcsc_matmul_blocked,
           "interleaved": ref.tcsc_matmul_interleaved}
    rows = []
    for s in tc["sparsities"]:
        w = torch.from_numpy(formats.random_ternary(
            np.random.default_rng(SEED + 30), k, n, s)).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fmts = {"tcsc": formats.TCSC.from_dense(w),
                "blocked": formats.BlockedTCSC.from_dense(w, tc["block"]),
                "interleaved": formats.InterleavedTCSC.from_dense(
                    w, tc["group"])}
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        for name, fmt in fmts.items():
            if not torch.equal(fmt.to_dense(), w):
                raise AssertionError(f"tcsc: {name} at s {s} does not "
                                     f"round-trip")
        nnz = int((w != 0).sum())
        w32, w16 = w.float(), w.to(torch.bfloat16)
        packed = weights.pack(w, "dense2bit",
                              scale=torch.ones(n, device="cuda"))
        for m in tc["ms"]:
            x = torch.randn(m, k, generator=gen, device="cuda").to(
                torch.bfloat16)
            x32 = x.float()
            dense = ref.ternary_matmul_dense(x32, w32)
            b1 = ops.ternary_gemm(x, packed)
            common = {
                "sparsity": s, "m": m, "k": k, "n": n, "nnz": nnz,
                "b1_ms": cuda_ms(lambda: ops.ternary_gemm(x, packed),
                                 tc["iters"], flush),
                "library_ms": cuda_ms(lambda: torch.matmul(x, w16),
                                      tc["iters"], flush),
                "plain_ms": cuda_ms(
                    lambda: ref.ternary_matmul_dense(x32, w32),
                    tc["iters"], flush)}
            for name, fn in fns.items():
                fmt = fmts[name]
                y = fn(x32, fmt)
                scale = float(dense.abs().max())
                err = float((y - dense).abs().max())
                if not bool(torch.isfinite(y).all()) or err > 1e-4 * scale:
                    raise AssertionError(f"tcsc {name} s {s} M {m}: max |d| "
                                         f"{err} against the dense matmul "
                                         f"(max |ref| {scale})")
                err_b1 = check_close(f"B1 vs {name} s {s} M {m}", b1, y)
                nbytes = m * k * 4 + fmt.nbytes() + m * n * 4
                row = dict(common, format=name,
                           ms=cuda_ms(lambda: fn(x32, fmt), tc["iters"],
                                      flush),
                           max_abs_err=err, max_abs_err_b1=err_b1,
                           nbytes=fmt.nbytes(), build_s=build_s)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    nbytes, float(m) * nnz, F32_OPS_PER_S)
                rows.append(row)
                print(f"tcsc {name} s {s} M {m}: " + json.dumps(row),
                      flush=True)
        del fmts, w, w32, w16, packed
        torch.cuda.empty_cache()
    return rows


def _union(intervals):
    """Merge (start, end) intervals; returns the sorted disjoint list."""
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def profile_once(label, fn, unprofiled=None):
    """A ``torch.profiler`` trace (CPU and CUDA activities) of ``fn()``
    followed by a synchronize, after one warm-up step of the profiler
    (its buffers are set up there, not in the traced step): host wall,
    device busy (the union of the device's kernel and copy intervals in
    the step), idle share, kernel count, the device time of the port's
    kernels and of the rest, the device ops that take the most time, and
    the host ops the longest idle gaps sit under.
    ``unprofiled()`` returns the same work's wall time without the
    profiler, the wall ``idle_share_unprofiled`` divides by. Fails on a
    trace with no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    window_name = "chip_smoke_window"

    def annotation(e):
        return (getattr(e, "is_user_annotation", False)
                or e.name == window_name or e.name.startswith("ProfilerStep"))

    def run():
        with record_function(window_name):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e6

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        run()
        prof.step()
        wall_us = run()
    events = prof.events()
    window = next(e for e in events if e.name == window_name
                  and e.device_type == DeviceType.CPU)
    w_lo, w_hi = window.time_range.start, window.time_range.end
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not annotation(e)]
    if not device:
        raise AssertionError(f"profile {label}: the trace holds no device "
                             f"events")
    busy = _union((max(e.time_range.start, w_lo), min(e.time_range.end, w_hi))
                  for e in device if e.time_range.end > w_lo
                  and e.time_range.start < w_hi)
    busy_us = sum(hi - lo for lo, hi in busy)
    kernels = [e for e in device
               if not e.name.startswith(("Memcpy", "Memset"))]
    by_name = {}
    for e in device:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    ours = sum(t for name, (_, t) in by_name.items()
               if any(k in name for k in PORT_KERNEL_NAMES))
    edges = [w_lo] + [x for iv in busy for x in iv] + [w_hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)), reverse=True)
    host = [e for e in events if e.device_type == DeviceType.CPU
            and not annotation(e)]
    gap_rows = []
    for length, lo, hi in gaps[:PROFILE["gaps"]]:
        mid = (lo + hi) / 2
        under = sorted((e for e in host
                        if e.time_range.start <= mid <= e.time_range.end),
                       key=lambda e: e.time_range.start)
        gap_rows.append({"us": round(length, 1),
                         "under": [e.name for e in under][-3:] or
                         ["(no op: Python between ops)"]})
    window_us = w_hi - w_lo
    row = {"host_wall_us": round(wall_us, 1),
           "device_busy_us": round(busy_us, 1),
           "idle_share": round(1.0 - busy_us / window_us, 4),
           "window_us": round(window_us, 1),
           "kernels": len(kernels),
           "port_kernels_us": round(ours, 1),
           "other_device_us": round(sum(t for _, t in by_name.values())
                                    - ours, 1),
           "top_device_ops": [{"name": name[:80], "n": n,
                               "us": round(t, 1)}
                              for name, (n, t) in top[:PROFILE["top_ops"]]],
           "longest_gaps": gap_rows}
    if unprofiled is not None:
        wall = unprofiled() * 1e6
        row["unprofiled_wall_us"] = round(wall, 1)
        row["idle_share_unprofiled"] = round(1.0 - busy_us / wall, 4)
    print(f"profile {label}: " + json.dumps(row), flush=True)
    return row


def _mean_wall(fn, iters):
    """Mean host wall time of ``fn()`` followed by a synchronize."""
    import torch
    t = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    return sum(t) / len(t)


def profiler_phase(cfg, params, workloads):
    """Five ``torch.profiler`` traces: one dense decode step eager, one
    dense and one paged bf16 decode step through the graph, one prefill at
    M = slots x prompt (1024), one QAT train step at the train phase's
    shape. Each decode step is one ``engine.step()`` with every slot live
    and no admission."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import LM

    rows = {}
    for label, wl, graph in (("decode dense eager", "dense", False),
                             ("decode dense graph", "dense", True),
                             ("decode paged bf16 graph", "paged_bf16", True)):
        prompts, gens, max_len, kw = workloads[wl]
        engine = _engine(cfg, params, max_len, graph, **kw)
        for p in prompts[:SERVE["slots"]]:
            engine.submit(p, max_len - len(p))
        _decode_only_step(engine)
        rows[label] = profile_once(
            label, engine.step,
            lambda: _mean_wall(engine.step, PROFILE["unprofiled_iters"]))
        del engine

    prompts, _, max_len, _ = workloads["dense"]
    model = LM(cfg, "cuda")
    toks = torch.as_tensor(prompts[:SERVE["slots"]], device="cuda")

    def prefill():
        with torch.no_grad(), ops.serving_phase("prefill"):
            _, logits = model.prefill(params, {"tokens": toks}, max_len)
            logits[:, -1].argmax(-1).cpu()

    prefill()
    label = f"prefill M {toks.numel()}"
    rows[label] = profile_once(label, prefill, lambda: _mean_wall(prefill, 5))

    tcfg = get_config("ternary-paper")
    _, data, step, init = train.build(tcfg, TRAIN["batch"], TRAIN["seq"],
                                      TRAIN["lr"], TRAIN["steps"], "cuda")
    state = init(SEED)
    batch = _tree_to(data.sharded_batch(0), "cuda")
    holder = [state["params"], state["opt"]]

    def train_step():
        holder[0], holder[1], met = step(holder[0], holder[1], batch)
        float(met["loss"])

    train_step()
    label = f"train step {TRAIN['batch']} x {TRAIN['seq']}"
    rows[label] = profile_once(label, train_step,
                               lambda: _mean_wall(train_step, 3))
    del state, holder, batch
    torch.cuda.empty_cache()
    return rows


def _repack_mlps(params, fmt, **opts):
    """A copy of a packed model's param tree whose MLP projections are
    re-packed as ``fmt`` (the same ternary matrices, scales and biases)."""
    import torch
    from repro_torch.core import weights
    layers = []
    for layer in params["layers"]:
        ffn = {name: {"w_packed": weights.pack(
            p["w_packed"].materialize(torch.float32).to(torch.int8), fmt,
            scale=p["w_packed"].scale, bias=p["w_packed"].bias, **opts)}
            for name, p in layer["ffn"].items()}
        layers.append({**layer, "ffn": ffn})
    return {**params, "layers": layers}


def mlp_formats_phase(cfg, params, prompts, max_len):
    """MLP blocks of other formats at ternary-paper's full MLP width, the
    path ``layers.mlp_apply`` takes on the card: tiled packs (padded
    words) fused through B4, bitplane packs through the chain (B7), each
    at M 8 and 1024 against the plain chain (``impl="ref"`` rows on the
    card); then one full-width prefill of the served model with its MLPs
    re-packed as tiled, whose greedy tokens must be the dense2bit model's
    (near-tie rule). Counters zeroed before, read after."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import weights
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.models.layers import mlp_apply

    mf = MLP_FORMATS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    tiles = dict(tile_k=mf["tile_k"], tile_n=mf["tile_n"])

    def block(fmt, **opts):
        return {name: {"w_packed": weights.pack(
            torch.randn(a, b, generator=gen, device="cuda") / a ** 0.5, fmt,
            **opts)} for name, (a, b) in (
                ("in", (mf["k"], mf["ff"])), ("gate", (mf["k"], mf["ff"])),
                ("out", (mf["ff"], mf["n"])))}

    def plain_chain(x, blk):
        w = {name: p["w_packed"] for name, p in blk.items()}
        h = F.silu(ops.ternary_gemm(x, w["gate"], impl="ref")) \
            * ops.ternary_gemm(x, w["in"], impl="ref")
        return ops.ternary_gemm(h, w["out"], impl="ref")

    blocks = {"tiled": block("tiled", **tiles), "bitplane": block("bitplane")}
    pad = blocks["tiled"]["in"]["w_packed"].packed.shape[1]
    xs = {m: torch.randn(1, m, mf["k"], generator=gen, device="cuda").to(
        torch.bfloat16) for m in mf["ms"]}
    toks = torch.as_tensor(prompts[:mf["prompts"]], device="cuda")
    tiled_params = _repack_mlps(params, "tiled", **tiles)
    model = LM(cfg, "cuda")

    _zero_counts()
    out = {}
    with torch.no_grad():
        for fmt, blk in blocks.items():
            for m, x in xs.items():
                out[(fmt, m)] = mlp_apply(blk, x, cfg)
        with ops.serving_phase("prefill"):
            _, dense_logits = model.prefill(params, {"tokens": toks}, max_len)
            _, tiled_logits = model.prefill(tiled_params, {"tokens": toks},
                                            max_len)
        torch.cuda.synchronize()
    launches = _read_counts()
    print(f"mlp_formats launches: {json.dumps(launches)}", flush=True)
    want_b4 = 2 + 2 * cfg.num_layers
    if launches["fused_mlp"] != want_b4:
        raise AssertionError(f"mlp_formats: B4 launched "
                             f"{launches['fused_mlp']} times, expected "
                             f"{want_b4} (two tiled blocks, then one per "
                             f"layer in each prefill)")
    if launches["ternary_gemm_bitplane"] != 3 * len(mf["ms"]):
        raise AssertionError(f"mlp_formats: B7 launched "
                             f"{launches['ternary_gemm_bitplane']} times, "
                             f"expected {3 * len(mf['ms'])} (the bitplane "
                             f"chain's three GEMMs per block)")
    rows = []
    for (fmt, m), y in out.items():
        x2 = xs[m].reshape(m, mf["k"])
        err = check_close(f"{fmt} MLP block M={m}", y.reshape(m, mf["n"]),
                          plain_chain(x2, blocks[fmt]))
        route = (f"B4 fused, words {pad} wide" if fmt == "tiled"
                 else "chain (B7)")
        rows.append({"format": fmt, "m": m, "route": route,
                     "max_abs_err": err})
        print(f"{fmt} MLP block M={m} K={mf['k']} ff={mf['ff']} "
              f"N={mf['n']}: {route}, agrees with the plain chain, "
              f"max_abs_err {err}", flush=True)
    agree = _compare_logits(
        f"full-width prefill, tiled MLPs vs dense2bit MLPs "
        f"({toks.shape[0]} prompts)", dense_logits[:, -1],
        tiled_logits[:, -1], LOGIT_TOL)
    print(f"tiled-MLP model: logits bitwise equal to the dense2bit "
          f"model's: {bool(torch.equal(dense_logits, tiled_logits))} "
          f"(information); greedy tokens agree on {agree}/{toks.shape[0]}",
          flush=True)
    return rows, launches


def _tiled_pack(rng_seed, k, n, sparsity, scale):
    """A tile-structured ``tiled`` pack drawn as kernel_bench draws it,
    packed on the card."""
    import numpy as np
    import torch
    from repro_torch.core import formats, weights
    t = formats.random_tile_ternary(np.random.default_rng(rng_seed), k, n,
                                    FORMATS["tile_k"], FORMATS["tile_n"],
                                    sparsity)
    return weights.pack(torch.from_numpy(t).cuda(), "tiled", scale=scale,
                        tile_k=FORMATS["tile_k"], tile_n=FORMATS["tile_n"])


def _effective(w):
    """Pre-decoded, pre-scaled bf16 weights for the library yardstick."""
    import torch
    return w.materialize(torch.float32, with_scale=True).to(torch.bfloat16)


def gemm_formats_phase(flush):
    """The paper's sparse-GEMM surface at the paper's sizes. First the
    path run: with every launch count set to 0, ``ops.ternary_gemm`` (auto
    and each kernel row) over every pack and M; the counts are read just
    after. Then each output is checked and each kernel timed (launches
    that compare or time do not count). Returns (per-kernel rows,
    launches of the path run)."""
    import numpy as np
    import torch
    from repro_torch.configs.ternary_paper import (PAPER_K_RANGE,
                                                   PAPER_SPARSITIES)
    from repro_torch.core import formats, weights
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_gemm as gemm_lib
    from repro_torch.kernels import ternary_gemm_bitplane as bitplane_lib

    rng = np.random.default_rng(SEED + 4)
    k, n, tk, tn = (FORMATS[key] for key in ("k", "n", "tile_k", "tile_n"))

    def scale_of(cols):
        return torch.from_numpy(rng.random(cols).astype(np.float32)
                                + 0.5).cuda()

    def act(m, kk):
        return torch.from_numpy(rng.standard_normal((m, kk)).astype(
            np.float32)).cuda().to(torch.bfloat16)

    t0 = time.perf_counter()
    tiled = {s: _tiled_pack(0, k, n, s, scale_of(n))
             for s in PAPER_SPARSITIES}
    sweep = {kk: _tiled_pack(kk, kk, n, FORMATS["sweep_sparsity"],
                             scale_of(n)) for kk in PAPER_K_RANGE}
    planes = {s: weights.pack(torch.from_numpy(formats.random_ternary(
        np.random.default_rng(SEED + 5), k, n, s)).cuda(), "bitplane",
        scale=scale_of(n)) for s in FORMATS["bitplane_sparsities"]}
    bm, bk, bn = FORMATS["base3"]
    base3 = weights.pack(torch.from_numpy(formats.random_ternary(
        rng, bk, bn, 0.25)).cuda(), "base3", scale=scale_of(bn))
    xs = {(m, kk): act(m, kk) for m in FORMATS["ms"] + (FORMATS["sweep_m"],)
          for kk in sorted({k, *PAPER_K_RANGE})}
    x_b3 = act(bm, bk)
    alpha_bias = torch.from_numpy(rng.standard_normal(n).astype(
        np.float32)).cuda()
    torch.cuda.synchronize()
    print(f"gemm_formats: packed {len(tiled)} tiled, {len(sweep)} sweep, "
          f"{len(planes)} bitplane and 1 base3 weights on the card in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    # ---- the path run ----
    out = {}
    _zero_counts()
    for s, w in tiled.items():
        for m in FORMATS["ms"]:
            x = xs[(m, k)]
            out[("tiled", s, m, "auto")] = ops.ternary_gemm(x, w)
            for impl in ("skip", "skip_db", "dense"):
                out[("tiled", s, m, impl)] = ops.ternary_gemm(x, w,
                                                              impl=impl)
    # one PReLU case with a bias, through the three 2-bit kernels
    w_pr, x_pr = tiled[0.125], xs[(FORMATS["ms"][0], k)]
    for impl in ("skip", "skip_db", "dense"):
        out[("prelu", impl)] = ops.ternary_gemm(
            x_pr, w_pr, bias=alpha_bias, fuse_prelu=True, impl=impl)
    for kk, w in sweep.items():
        x = xs[(FORMATS["sweep_m"], kk)]
        out[("sweep", kk, "auto")] = ops.ternary_gemm(x, w)
        for impl in ("skip", "dense"):
            out[("sweep", kk, impl)] = ops.ternary_gemm(x, w, impl=impl)
    for s, w in planes.items():
        for m in FORMATS["ms"]:
            x = xs[(m, k)]
            out[("bitplane", s, m, "auto")] = ops.ternary_gemm(x, w)
            out[("bitplane", s, m, "factorized")] = ops.ternary_gemm(
                x, w, impl="bitplane_factorized")
    out["base3"] = ops.ternary_gemm(x_b3, base3)
    torch.cuda.synchronize()
    launches = _read_counts()
    print(f"gemm_formats launches: {json.dumps(launches)}", flush=True)
    for name in ("ternary_gemm_skip", "ternary_gemm_skip_db",
                 "ternary_gemm_bitplane", "ternary_gemm"):
        if launches[name] <= 0:
            raise AssertionError(f"gemm_formats: {name} never launched")

    # ---- checks and times ----
    rows = {"ternary_gemm_skip": [], "ternary_gemm_skip_db": [],
            "ternary_gemm_bitplane": [], "k_sweep": []}

    def skip_plain(x, w, **kw):
        return gemm_lib.ternary_gemm_skip_ref(
            x, w.packed, w.kt_indices, w.kt_counts, w.scale, kw.get("bias"),
            n=w.n, tile_k=w.tile_k, tile_n=w.tile_n,
            fuse_prelu=kw.get("fuse_prelu", False))

    def tiled_bound(x, w, m):
        words = w.occupied_tiles * (w.tile_k // 16) * w.tile_n * 4
        meta = (w.kt_indices.numel() + w.kt_counts.numel()) * 4
        nbytes = (m * w.k * 2 + words + meta + w.n * 4 + m * w.n * 2)
        return bound_ms(nbytes, 2.0 * m * w.nnz)

    def equal3(label, ys):
        for impl in ("skip", "skip_db"):
            if not torch.equal(ys[impl], ys["dense"]):
                d = float((ys[impl].float() - ys["dense"].float()).abs()
                          .max())
                raise AssertionError(f"{label}: {impl} != dense bitwise "
                                     f"(max |d| = {d})")

    for s, w in tiled.items():
        for m in FORMATS["ms"]:
            x = xs[(m, k)]
            label = f"tiled s={s} M={m} K={k} N={n}"
            plan = ops.ternary_gemm_plan(w, m).impl
            want = "dense" if w.occupancy() > ops.SKIP_OCCUPANCY_CUTOFF \
                else "skip_db"
            if plan != want or (s == 0.5) != (plan == "dense"):
                raise AssertionError(f"{label}: auto planned {plan!r}, "
                                     f"occupancy {w.occupancy()}")
            ys = {impl: out[("tiled", s, m, impl)]
                  for impl in ("skip", "skip_db", "dense")}
            equal3(label, ys)
            if not torch.equal(out[("tiled", s, m, "auto")], ys[plan]):
                raise AssertionError(f"{label}: auto != {plan}")
            ref = skip_plain(x, w)
            errs = {impl: check_close(f"{label} {impl}", ys[impl], ref)
                    for impl in ys}
            w_eff = _effective(w)
            iters = 20
            times = {impl: cuda_ms(lambda i=impl: ops.ternary_gemm(
                x, w, impl=i), iters, flush)
                for impl in ("skip", "skip_db", "dense")}
            # the same calls with the host's enqueue time hidden, and the
            # host's time to issue one
            device = {impl: cuda_ms(lambda i=impl: ops.ternary_gemm(
                x, w, impl=i), iters, flush, spin=True)
                for impl in ("skip", "skip_db")}
            host = {impl: host_ms(lambda i=impl: ops.ternary_gemm(
                x, w, impl=i), 100) for impl in ("skip", "skip_db")}
            # the wrappers called directly (no dispatch): kernel time alone
            bm = ops.ternary_gemm_plan(w, m, impl="skip").block_m
            dense_plan = ops.ternary_gemm_plan(w, m, impl="dense")
            kernel = {db: cuda_ms(lambda d=db: gemm_lib.ternary_gemm_skip_cuda(
                x, w.packed, w.kt_indices, w.kt_counts, w.scale, n=w.n,
                tile_k=w.tile_k, tile_n=w.tile_n, block_m=bm, db=d), iters,
                flush) for db in (False, True)}
            dense_kernel_ms = cuda_ms(lambda: gemm_lib.ternary_gemm_cuda(
                x, w.packed, w.scale, n=w.n, block_m=dense_plan.block_m,
                block_n=dense_plan.block_n), iters, flush)
            plain_ms = cuda_ms(lambda: skip_plain(x, w), 5, flush)
            library_ms = cuda_ms(lambda: torch.matmul(x, w_eff), iters,
                                 flush)
            b_ms, b_by = tiled_bound(x, w, m)
            common = {"sparsity": s, "m": m, "k": k, "n": n,
                      "tile": [w.tile_k, w.tile_n], "auto": plan,
                      "occupancy": w.occupancy(),
                      "tiles": {"occupied": w.occupied_tiles,
                                "visited": w.visited_tiles(),
                                "total": w.total_tiles()},
                      "dense_ms": times["dense"],
                      "dense_kernel_ms": dense_kernel_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "dense_equal": True}
            for name, impl, db in (("ternary_gemm_skip", "skip", False),
                                   ("ternary_gemm_skip_db", "skip_db", True)):
                rows[name].append({**common, "ms": times[impl],
                                   "device_ms": device[impl],
                                   "host_ms": host[impl],
                                   "kernel_ms": kernel[db],
                                   "max_abs_err": errs[impl]})
            print(f"{label}: auto={plan} skip==skip_db==dense; "
                  + json.dumps({**common, "skip_ms": times["skip"],
                                "skip_db_ms": times["skip_db"],
                                "max_abs_err": errs}), flush=True)

    ys = {impl: out[("prelu", impl)] for impl in ("skip", "skip_db", "dense")}
    equal3("tiled PReLU+bias", ys)
    err = check_close("tiled PReLU+bias", ys["skip"], skip_plain(
        x_pr, w_pr, bias=alpha_bias, fuse_prelu=True))
    print(f"tiled s=0.125 M={x_pr.shape[0]} with bias and PReLU: "
          f"skip==skip_db==dense, max_abs_err {err}", flush=True)

    for kk, w in sweep.items():
        x = xs[(FORMATS["sweep_m"], kk)]
        label = (f"K sweep K={kk} N={n} M={x.shape[0]} "
                 f"s={FORMATS['sweep_sparsity']}")
        got = out[("sweep", kk, "auto")]
        if ops.ternary_gemm_plan(w, x.shape[0]).impl != "skip_db":
            raise AssertionError(f"{label}: auto did not plan skip_db")
        equal3(label, {"skip_db": got, "skip": out[("sweep", kk, "skip")],
                       "dense": out[("sweep", kk, "dense")]})
        err = check_close(label, got, skip_plain(x, w))
        w_eff = _effective(w)
        iters = 10
        row = {"k": kk, "n": n, "m": x.shape[0],
               "sparsity": FORMATS["sweep_sparsity"],
               "occupancy": w.occupancy(), "max_abs_err": err,
               "skip_db_ms": cuda_ms(lambda: ops.ternary_gemm(x, w), iters,
                                     flush),
               "skip_ms": cuda_ms(lambda: ops.ternary_gemm(
                   x, w, impl="skip"), iters, flush),
               "skip_db_device_ms": cuda_ms(lambda: ops.ternary_gemm(x, w),
                                            iters, flush, spin=True),
               "skip_device_ms": cuda_ms(lambda: ops.ternary_gemm(
                   x, w, impl="skip"), iters, flush, spin=True),
               "dense_ms": cuda_ms(lambda: ops.ternary_gemm(
                   x, w, impl="dense"), iters, flush),
               "library_ms": cuda_ms(lambda: torch.matmul(x, w_eff), iters,
                                     flush)}
        row["bound_ms"], row["bound_by"] = tiled_bound(x, w, x.shape[0])
        rows["k_sweep"].append(row)
        print(f"{label}: skip_db==skip==dense; " + json.dumps(row),
              flush=True)

    for s, w in planes.items():
        for m in FORMATS["ms"]:
            x = xs[(m, k)]
            label = f"bitplane s={s} M={m} K={k} N={n}"
            if ops.ternary_gemm_plan(w, m).impl != "bitplane":
                raise AssertionError(f"{label}: auto did not plan bitplane")
            got = out[("bitplane", s, m, "auto")]
            fact = out[("bitplane", s, m, "factorized")]
            args = (x, w.plus, w.minus, w.scale)
            err = check_close(label, got,
                              bitplane_lib.ternary_gemm_bitplane_ref(*args))
            err_f = check_close(f"{label} factorized", fact,
                                bitplane_lib.ternary_gemm_bitplane_ref(
                                    *args, factorized=True))
            check_close(f"{label} factorized vs plain mode", fact, got)
            w_eff = _effective(w)
            iters = 20
            tiles = {impl: (lambda p: dict(block_m=p.block_m,
                                           block_n=p.block_n))(
                ops.ternary_gemm_plan(w, m, impl=impl))
                for impl in ("bitplane", "bitplane_factorized")}
            row = {"sparsity": s, "m": m, "k": k, "n": n,
                   "max_abs_err": max(err, err_f),
                   "ms": cuda_ms(lambda: ops.ternary_gemm(x, w), iters,
                                 flush),
                   "factorized_ms": cuda_ms(lambda: ops.ternary_gemm(
                       x, w, impl="bitplane_factorized"), iters, flush),
                   # the wrapper called directly: kernel time alone
                   "kernel_ms": cuda_ms(
                       lambda: bitplane_lib.ternary_gemm_bitplane_cuda(
                           x, w.plus, w.minus, w.scale,
                           **tiles["bitplane"]), iters, flush),
                   "factorized_kernel_ms": cuda_ms(
                       lambda: bitplane_lib.ternary_gemm_bitplane_cuda(
                           x, w.plus, w.minus, w.scale, factorized=True,
                           **tiles["bitplane_factorized"]), iters, flush),
                   "plain_ms": cuda_ms(
                       lambda: bitplane_lib.ternary_gemm_bitplane_ref(*args),
                       5, flush),
                   "library_ms": cuda_ms(lambda: torch.matmul(x, w_eff),
                                         iters, flush)}
            nbytes = (m * k * 2 + 2 * w.plus.numel() + n * 4 + m * n * 2)
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes,
                                                        2.0 * m * w.nnz)
            rows["ternary_gemm_bitplane"].append(row)
            print(f"{label}: " + json.dumps(row), flush=True)

    ragged_formats(rows)

    ref = (x_b3.float() @ base3.materialize(torch.float32, with_scale=True)
           ).to(torch.bfloat16)
    err = check_close("base3", out["base3"], ref)
    print(f"base3 M={bm} K={bk} N={bn}: no kernel (ref in repro too); its "
          f"plain ref row ran on the card, max_abs_err {err}", flush=True)
    print(f"gemm_formats took {time.perf_counter() - t0:.1f}s", flush=True)
    return rows, launches


def ragged_formats(rows):
    """B2 and B3 (== B1 bitwise) at tiles whose tile_k is not a multiple
    of 64 or tile_n of 32, and B7 in both modes, at ragged shapes, each
    against its plain version; rows marked ``"on_path": false``. Where
    K % 8 != 0 (K 1001, 999, 1003) B3 and B2 fill their stages with plain
    loads; where K % 8 == 0 (K 1000, 1024) B3's tensor copies fill them,
    and a 64-deep step that runs past its tile's end lands the next
    tile's words, which B3 must zero. Odd N; M 1, 17, 1000."""
    import numpy as np
    import torch
    from repro_torch.core import formats, weights
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_gemm as gemm_lib
    from repro_torch.kernels import ternary_gemm_bitplane as bitplane_lib

    rf = RAGGED_FORMATS
    rng = np.random.default_rng(SEED + 11)

    def cuda(a):
        return torch.from_numpy(a).cuda()

    for m, k, n in rf["shapes"]:
        x = cuda(rng.standard_normal((m, k)).astype(np.float32)).to(
            torch.bfloat16)
        scale = cuda(rng.random(n).astype(np.float32) + 0.5)
        bias = cuda(rng.standard_normal(n).astype(np.float32))
        for tk, tn in rf["tiles"]:
            kp, npad = -(-k // tk) * tk, -(-n // tn) * tn
            t = formats.random_tile_ternary(rng, kp, npad, tk, tn,
                                            rf["sparsity"])[:k, :n]
            w = weights.pack(cuda(t), "tiled", scale=scale, tile_k=tk,
                             tile_n=tn)
            err = 0.0
            for kw in (dict(), dict(bias=bias, fuse_prelu=True)):
                ys = {impl: ops.ternary_gemm(x, w, impl=impl, **kw)
                      for impl in ("skip", "skip_db", "dense")}
                label = (f"ragged tiled M={m} K={k} N={n} tile ({tk}, {tn})"
                         f"{' bias+PReLU' if kw else ''}")
                for impl in ("skip", "skip_db"):
                    if not torch.equal(ys[impl], ys["dense"]):
                        raise AssertionError(f"{label}: {impl} != dense "
                                             f"bitwise")
                err = max(err, check_close(
                    label, ys["skip"], gemm_lib.ternary_gemm_skip_ref(
                        x, w.packed, w.kt_indices, w.kt_counts, w.scale,
                        kw.get("bias"), n=n, tile_k=tk, tile_n=tn,
                        fuse_prelu=kw.get("fuse_prelu", False))))
            for name in ("ternary_gemm_skip", "ternary_gemm_skip_db"):
                rows[name].append(
                    {"m": m, "k": k, "n": n, "tile": [tk, tn],
                     "occupancy": w.occupancy(), "max_abs_err": err,
                     "dense_equal": True, "on_path": False})
            print(f"ragged tiled M={m} K={k} N={n} tile ({tk}, {tn}): "
                  f"skip==skip_db==dense, max_abs_err {err}", flush=True)
        planes = weights.Bitplane.from_dense(
            cuda(formats.random_ternary(rng, k, n, 0.25)), scale=scale,
            bias=bias)
        err = 0.0
        for fact in (False, True):
            impl = "bitplane_factorized" if fact else "bitplane"
            for prelu in (False, True):
                got = ops.ternary_gemm(x, planes, fuse_prelu=prelu,
                                       impl=impl)
                err = max(err, check_close(
                    f"ragged bitplane {impl} M={m} K={k} N={n}", got,
                    bitplane_lib.ternary_gemm_bitplane_ref(
                        x, planes.plus, planes.minus, scale, bias,
                        factorized=fact, fuse_prelu=prelu)))
        rows["ternary_gemm_bitplane"].append(
            {"m": m, "k": k, "n": n, "max_abs_err": err, "on_path": False})
        print(f"ragged bitplane M={m} K={k} N={n}: both modes agree, "
              f"max_abs_err {err}", flush=True)


def _sdpa_ms(q4, k4, v4, causal, iters, flush):
    """SDPA's time under each backend this torch offers (None where the
    backend is missing or refuses the inputs)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for name, attr in SDPA_BACKENDS.items():
        out[name] = None
        backend = getattr(SDPBackend, attr, None)
        if backend is None:
            continue
        with sdpa_kernel(backend):
            try:
                F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"  SDPA {name}: not run ({str(e).splitlines()[0]})",
                      flush=True)
                continue
            out[name] = cuda_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal), iters, flush)
    return out


def _layout_copies(flush):
    """``models.attention._full_sequence`` at the evaluation's shape (B 8,
    S 1024, H 16, hd 64, causal, attn_impl "pallas"): the whole call (q, k
    and v copied to (B*H, S, hd), then B6) and the three copies alone."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    bh, s, hd = FLASH_EVAL
    h = get_config("ternary-paper").num_heads
    cfg = dataclasses.replace(get_config("ternary-paper"), attn_impl="pallas")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    q, k, v = (torch.randn(bh // h, s, h, hd, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))

    def copies():
        return [t.transpose(1, 2).reshape(bh, s, hd).contiguous()
                for t in (q, k, v)]

    with torch.no_grad():
        return {"b": bh // h, "s": s, "h": h, "hd": hd,
                "full_sequence_ms": cuda_ms(
                    lambda: attention._full_sequence(q, k, v, cfg), 20,
                    flush),
                "copies_ms": cuda_ms(copies, 20, flush)}


def flash_kernel_phase(flush, build):
    """B6 against its plain version at repro's test shapes, hd 128 at S
    1024 (causal and full) and the evaluation's shape, each timed beside
    SDPA's backends on the same bf16 (1, B*H, S, hd) tensors; then checked
    once at ragged and unequal lengths and at the head edge. The
    evaluation's row also carries the kernel's registers and spills, its
    HGMMA count and the layout copies' cost in ``_full_sequence``. No
    HGMMA, a spill or a wgmma that ptxas serialized fails the phase.
    Returns the rows."""
    import torch
    from repro_torch.kernels import flash_attention as flash_lib

    hgmma = sass_counts(build, "flash_attention",
                        r"\b(HGMMA\.[0-9A-Za-z.]+)")
    print(f"  flash_attention SASS: {hgmma}", flush=True)
    if not hgmma:
        raise AssertionError("flash_attention: no HGMMA (wgmma) in the "
                             "SASS of its library")
    # ptxas's two known hazards for B6: spilled registers (a spilled build
    # gave wrong results) and wgmmas it serialized (C7520, C7512)
    log = (build.BUILD_DIR / "flash_attention.log").read_text()
    serialized = [line.strip() for line in log.splitlines()
                  if "C7520" in line or "C7512" in line]
    report = ptxas_report(build, "flash_attention")
    spilled = {entry: info for entry, info in report.items()
               if info["spill_stores"] or info["spill_loads"]}
    if serialized or spilled or len(report) != len(flash_lib.TILES):
        raise AssertionError(f"flash_attention: ptxas serialized wgmmas "
                             f"({serialized}), spilled ({spilled}) or built "
                             f"{len(report)} kernels, not "
                             f"{len(flash_lib.TILES)}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)

    def qkv(bh, sq, skv, hd):
        return (torch.randn(bh, n, hd, generator=gen, device="cuda")
                .to(torch.bfloat16) for n in (sq, skv, skv))

    cases = [(shape, causal) for shape in FLASH_CHECKS
             for causal in (True, False)] + [(FLASH_EVAL, True)]
    rows = []
    for (bh, s, hd), causal in cases:
        q, k, v = qkv(bh, s, s, hd)
        label = f"flash_attention BH={bh} S={s} hd={hd} causal={causal}"
        err = check_close(label, flash_lib.flash_attention_cuda(
            q, k, v, causal=causal), flash_lib.flash_attention_ref(
                q, k, v, causal=causal))
        iters = 20
        sdpa = _sdpa_ms(q[None], k[None], v[None], causal, iters, flush)
        fastest = min((n for n in sdpa if sdpa[n] is not None),
                      key=sdpa.get)
        row = {"bh": bh, "s": s, "hd": hd, "causal": causal,
               "on_path": (bh, s, hd) == FLASH_EVAL, "max_abs_err": err,
               "ms": cuda_ms(lambda: flash_lib.flash_attention_cuda(
                   q, k, v, causal=causal), iters, flush),
               "device_ms": cuda_ms(lambda: flash_lib.flash_attention_cuda(
                   q, k, v, causal=causal), iters, flush, spin=True),
               "host_ms": host_ms(lambda: flash_lib.flash_attention_cuda(
                   q, k, v, causal=causal), 100),
               "ops_ms": cuda_ms(lambda: flash_lib.flash_attention(
                   q, k, v, causal=causal), iters, flush),
               "plain_ms": cuda_ms(lambda: flash_lib.flash_attention_ref(
                   q, k, v, causal=causal), iters, flush),
               "library_ms": sdpa[fastest], "library": f"sdpa {fastest}",
               "sdpa_ms": sdpa}
        # q, k, v read once and o written once; QK^T and PV over the
        # causal half (or the whole square)
        nbytes = 4 * bh * s * hd * 2
        ops_needed = (2.0 if causal else 4.0) * bh * s * s * hd
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops_needed)
        if row["on_path"]:
            plan = flash_lib.launch_plan(bh, s, s, hd, causal)
            row["plan"] = {"block_m": plan.block_m, "block_n": plan.block_n,
                           "stages": plan.stages,
                           "blocks_per_sm": plan.blocks_per_sm,
                           "smem_bytes": plan.smem_bytes}
            # the launched tile's registers and spills (nvcc -Xptxas -v)
            tag = (f"flash_attention_kernelILi{hd}ELi{plan.block_n}ELi"
                   f"{plan.stages}ELi{plan.blocks_per_sm}E")
            row["ptxas"] = next(info for entry, info in report.items()
                                if tag in entry)
            row["hgmma"] = hgmma
            row["layout"] = _layout_copies(flush)
        rows.append(row)
        print(f"{label}: " + json.dumps(row), flush=True)
    for bh, sq, skv, hd in FLASH_RAGGED:
        q, k, v = qkv(bh, sq, skv, hd)
        for causal in (True, False):
            label = (f"flash_attention BH={bh} Sq={sq} Skv={skv} hd={hd} "
                     f"causal={causal}")
            err = check_close(label, flash_lib.flash_attention_cuda(
                q, k, v, causal=causal), flash_lib.flash_attention_ref(
                    q, k, v, causal=causal))
            print(f"{label}: max_abs_err {err}", flush=True)
    for bh, s, hd in FLASH_EDGE:
        q, k, v = qkv(bh, s, s, hd)
        k[1::2], v[1::2] = 1e4, 1e4
        for causal in (True, False):
            label = f"flash_attention head edge BH={bh} S={s} hd={hd} " \
                    f"causal={causal}"
            got = flash_lib.flash_attention_cuda(q, k, v, causal=causal)
            err = check_close(label, got[0::2], flash_lib.flash_attention_ref(
                q[0::2], k[0::2], v[0::2], causal=causal))
            print(f"{label}: max_abs_err {err}", flush=True)
    return rows


def _grads_agree(label, make_y, leaves, cot):
    """The kernel row's gradients (``make_y("kernel")``) against the
    plain row's (``make_y("plain")``) for one cotangent."""
    import torch
    got_y = make_y("kernel")
    if got_y.grad_fn is None:
        raise AssertionError(f"{label}: the kernel row's output has no "
                             f"grad_fn (the gradient would be lost)")
    got = torch.autograd.grad(got_y, leaves, cot)
    ref = torch.autograd.grad(make_y("plain"), leaves, cot)
    errs = [check_close(f"{label} grad {i}", g, r)
            for i, (g, r) in enumerate(zip(got, ref))]
    print(f"gradients {label}: (gx, gscale[, gbias]) agree, max |d| "
          f"{[round(e, 6) for e in errs]}", flush=True)


def gradients_phase():
    """The kernel rows' gradients against the plain rows': B1 on dense2bit
    packs at M 8 and 1024 (K = N = 1024, scale and bias, and PReLU at M 8),
    B3 on a tiled s 1/8 pack, B7 in both modes, B4 at M 8."""
    import numpy as np
    import torch
    from repro_torch.core import formats, weights
    from repro_torch.kernels import fused_mlp as fused_lib
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    k = n = 1024

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def gemm_case(label, w, m, plan_impl, prelu=False):
        x = randn(m, k).to(torch.bfloat16).requires_grad_()
        scale = w.scale.clone().requires_grad_()
        bias = randn(n).requires_grad_()
        cot = randn(m, n).to(torch.bfloat16)
        if ops.ternary_gemm_plan(w, m).impl != plan_impl:
            raise AssertionError(f"{label}: auto did not plan {plan_impl}")
        _grads_agree(label, lambda row: ops.ternary_gemm(
            x, w, scale, bias, fuse_prelu=prelu,
            impl="auto" if row == "kernel" else "ref"),
            [x, scale, bias], cot)

    dense = weights.pack(randn(k, n) / k ** 0.5)
    gemm_case("B1 dense2bit M=8", dense, 8, "dense")
    gemm_case("B1 dense2bit M=1024", dense, 1024, "dense")
    gemm_case("B1 dense2bit M=8 PReLU", dense, 8, "dense", prelu=True)
    tiled = _tiled_pack(SEED, k, n, 0.125, torch.rand(
        n, generator=gen, device="cuda") + 0.5)
    gemm_case("B3 tiled s=1/8 M=8", tiled, 8, "skip_db")
    planes = weights.Bitplane.from_dense(
        torch.from_numpy(formats.random_ternary(
            np.random.default_rng(SEED + 8), k, n, 0.25)).cuda(),
        scale=torch.rand(n, generator=gen, device="cuda") + 0.5)
    for impl in ("bitplane", "bitplane_factorized"):
        x = randn(8, k).to(torch.bfloat16).requires_grad_()
        scale = planes.scale.clone().requires_grad_()
        cot = randn(8, n).to(torch.bfloat16)
        _grads_agree(f"B7 {impl} M=8", lambda row, i=impl: ops.ternary_gemm(
            x, planes, scale, impl=i if row == "kernel" else "ref"),
            [x, scale], cot)

    wi, wg = (weights.pack(randn(k, 4096) / k ** 0.5) for _ in range(2))
    wo = weights.pack(randn(4096, n) / 64)
    x = randn(8, k).to(torch.bfloat16).requires_grad_()
    vecs = [wi.scale.requires_grad_(), wg.scale.requires_grad_(),
            wo.scale.requires_grad_()]
    cot = randn(8, n).to(torch.bfloat16)
    _grads_agree("B4 fused_mlp M=8", lambda row: ops.fused_mlp(
        x, wi, wo, wg) if row == "kernel" else fused_lib.fused_mlp_ref(
            x, wi.packed, wo.packed, wg.packed, wi.scale, None, wg.scale,
            None, wo.scale, None), [x] + vecs, cot)


def _leaf_pairs(got, ref, prefix=""):
    """(path, got leaf, ref leaf) over two trees of one structure."""
    if isinstance(ref, dict):
        for k in ref:
            yield from _leaf_pairs(got[k], ref[k], f"{prefix}/{k}")
    elif isinstance(ref, list):
        for i, r in enumerate(ref):
            yield from _leaf_pairs(got[i], r, f"{prefix}/{i}")
    else:
        yield prefix, got, ref


def train_step_check():
    """The card's first full-width train step against the CPU's on the same
    weights and batch, both in float32 (TF32 off): loss, grad norm, every
    AdamW moment and every parameter. Returns the readings."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = dataclasses.replace(get_config("ternary-paper"), dtype="float32")
    b, s, lr = STEP_CHECK["batch"], STEP_CHECK["seq"], TRAIN["lr"]
    _, data, cpu_step, cpu_init = train.build(cfg, b, s, lr, TRAIN["steps"],
                                              "cpu")
    _, _, card_step, _ = train.build(cfg, b, s, lr, TRAIN["steps"], "cuda")
    state = cpu_init(SEED)
    card_params = _tree_to(state["params"], "cuda")
    card_opt = _tree_to(state["opt"], "cuda")
    batch = data.sharded_batch(0)
    t0 = time.perf_counter()
    params, opt, met = cpu_step(state["params"], state["opt"], batch)
    cpu_s = time.perf_counter() - t0
    del state
    gparams, gopt, gmet = card_step(card_params, card_opt,
                                    _tree_to(batch, "cuda"))
    torch.cuda.synchronize()
    step_lr = float(met["lr"])
    out = {"batch": b, "seq": s, "cpu_step_s": cpu_s,
           "loss_cpu": float(met["loss"]), "loss_card": float(gmet["loss"]),
           "grad_norm_cpu": float(met["grad_norm"]),
           "grad_norm_card": float(gmet["grad_norm"]), "lr": step_lr}
    out.update(hold_first_step("train step check", "card", "CPU",
                               (gparams, gopt, gmet), (params, opt, met)))
    print("train step check, card vs CPU, full width in float32: "
          + json.dumps(out), flush=True)
    return out


FIRST_STEP_KEYS = ("loss_rel_err", "grad_norm_rel_err", "m_rel_err",
                   "v_rel_err", "params_rel_err")


def hold_first_step(label, got_name, ref_name, got, ref, floor=0.0,
                    device=None, bounds=None, signs=False):
    """One first train step (params, AdamW state, metrics) held to another
    from the same state by STEP_CHECK's rule. The bounds a family's check
    reads besides: ``floor``: a leaf's moments held relative to the
    larger of its own max and ``floor`` of the tree's largest (a leaf
    whose gradient is ~0, as an encoder-decoder's cross-attention key's,
    reads rounding noise: the one-process family tests' rule);
    ``bounds``: each reading's bound by FIRST_STEP_KEYS (default
    STEP_CHECK's rtol for all; ``{}`` reads only, as for a witness);
    ``signs``: a parameter whose gradient's sign differs from ``ref``'s,
    or whose |g| is below the moments' own disagreement (``m_rel_err``)
    of its leaf's largest, is held to 2.01 lr too (TP_TRAIN_RULE). Each
    pair of leaves is
    compared on ``device`` (default: ``ref``'s), moved there one at a
    time. Returns the readings."""
    import torch
    gparams, gopt, gmet = got
    params, opt, met = ref
    step_lr = float(met["lr"])
    if bounds is None:
        bounds = dict.fromkeys(FIRST_STEP_KEYS, STEP_CHECK["rtol"])

    def pairs(tree_got, tree_ref):
        for path, g, r in _leaf_pairs(tree_got, tree_ref):
            dev = r.device if device is None else device
            yield path, g.to(dev), r.to(dev)

    out = {}
    for key in ("loss", "grad_norm"):
        r, g = float(met[key]), float(gmet[key])
        out[f"{key}_rel_err"] = d = abs(g - r) / abs(r)
        bound = bounds.get(f"{key}_rel_err")
        if bound is not None and d > bound:
            raise AssertionError(f"{label}: the {got_name}'s {key} {g} "
                                 f"differs from the {ref_name}'s {r} by "
                                 f"{d:.3g}, above {bound:.3g}")

    # A weight whose |w| lies within an ulp of its column's 2 mean|w| (the
    # straight-through mask's edge, a mean the two sides sum in another
    # order) gets its gradient on one side and 0 on the other: those
    # elements are counted, and must be few, instead of held to rtol
    flips, flipped_sign = {}, {}
    for path, g, r in pairs(gopt["m"], opt["m"]):
        flips[path] = (g == 0) != (r == 0)
        if signs:
            flipped_sign[path] = torch.sign(g) != torch.sign(r)
    n_elems = sum(int(f.numel()) for f in flips.values())
    out["mask_edge_flips"] = sum(int(f.sum()) for f in flips.values())
    if bounds and out["mask_edge_flips"] \
            > STEP_CHECK["max_flip_share"] * n_elems:
        raise AssertionError(f"{label}: {out['mask_edge_flips']} "
                             f"gradients are 0 on one side only")

    def worst(tree_got, tree_ref, loose, bound, loose_bound=0.0,
              floor=0.0):
        """max over leaves of max|d| / max|ref| off ``loose`` (max|ref| at
        least ``floor`` of the tree's largest), held to ``bound`` (None:
        read only); on ``loose`` each element is held to
        ``loose_bound``."""
        top = 0.0
        tree_max = floor * max(float(r.abs().max()) for _, _, r in
                               _leaf_pairs(tree_ref, tree_ref)) \
            if floor else 0.0
        for path, g, r in pairs(tree_got, tree_ref):
            g, r = g.float(), r.float()
            d = (g - r).abs()
            mask = loose[path]
            if loose_bound > 0 and bool((d[mask] > loose_bound).any()):
                raise AssertionError(f"{label}: {path} moved "
                                     f"more than two steps apart")
            d = torch.where(mask, torch.zeros_like(d), d)
            scale = max(float(r.abs().max()), tree_max, 1e-30)
            rel = float(d.max()) / scale
            if bound is not None and rel > bound:
                i = int(d.flatten().argmax())
                raise AssertionError(
                    f"{label}: {path} differs by {rel:.3g} of its max, "
                    f"above {bound:.3g} ({int((d > bound * scale).sum())}"
                    f" elements; worst {got_name} {float(g.flatten()[i])}, "
                    f"{ref_name} {float(r.flatten()[i])})")
            top = max(top, rel)
        return top

    out["m_rel_err"] = worst(gopt["m"], opt["m"], flips,
                             bounds.get("m_rel_err"), floor=floor)
    out["v_rel_err"] = worst(gopt["v"], opt["v"], flips,
                             bounds.get("v_rel_err"), floor=floor)
    # Parameters: AdamW's first step moves each by lr * g / (|g| + eps),
    # about lr * sign(g), so where |g| is below `edge` of its leaf's
    # largest (or of ``floor`` times the tree's largest, where that is
    # larger) the two signs may differ: 1e-4 (25x the moments'
    # disagreement measured on the card), with ``signs`` at least the
    # moments' own disagreement (no gradient above it can change sign).
    # There, where g is 0 on one side, and (``signs``) where the signs do
    # differ, each element is held to 2.01 lr, the most two such steps
    # (plus the decay's share) differ by
    edge = max(1e-4, out["m_rel_err"]) if signs else 1e-4
    v_floor = floor ** 2 * max(float(r.max()) for _, _, r in
                               _leaf_pairs(opt["v"], opt["v"]))
    loose = {path: flips[path] | flipped_sign.get(path, False)
             | ((r > 0) & (r < edge ** 2 * torch.clamp(r.max(),
                                                        min=v_floor)))
             for path, _, r in pairs(opt["v"], opt["v"])}
    out["params_held_to_2lr"] = sum(int(m.sum()) for m in loose.values())
    out["params_rel_err"] = worst(gparams, params, loose,
                                  bounds.get("params_rel_err"),
                                  2.01 * step_lr)
    return out


def train_phase(ckpt_root):
    """Full-width ternary-paper QAT through the training CLI: 24 steps
    with checkpoints every 8, then a second invocation to 32 steps that
    must resume at 24; then a TrainSupervisor run that fails once. The
    launch counters are zeroed before and read after the CLI runs.
    Returns (trained params from the step-32 checkpoint, launches,
    summary)."""
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch.checkpoint.convert import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = get_config("ternary-paper")
    ckpt_dir = str(Path(ckpt_root) / "train")
    args = ["--arch", "ternary-paper", "--batch", str(TRAIN["batch"]),
            "--seq", str(TRAIN["seq"]), "--lr", str(TRAIN["lr"]),
            "--ckpt-every", str(TRAIN["ckpt_every"]), "--ckpt-dir",
            ckpt_dir, "--log-every", str(TRAIN["ckpt_every"])]
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    first = train.main(args + ["--steps", str(TRAIN["steps"])])
    t1 = time.perf_counter()
    second = train.main(args + ["--steps", str(TRAIN["resume_to"])])
    t2 = time.perf_counter()
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"train: full-width {cfg.name} QAT, batch {TRAIN['batch']} x seq "
          f"{TRAIN['seq']}: {first['steps']} steps in {t1 - t0:.1f}s "
          f"({first['mean_step_s']:.4f}s a step), loss "
          f"{first['first_loss']:.4f} -> {first['last_loss']:.4f}; resumed "
          f"run: {second['steps']} steps in {t2 - t1:.1f}s, loss "
          f"{second['last_loss']:.4f}; peak memory {peak / 2**30:.2f} GiB; "
          f"launches {json.dumps(launches)}", flush=True)
    if not first["last_loss"] < first["first_loss"]:
        raise AssertionError(f"training did not lower the loss: {first}")
    want = TRAIN["resume_to"] - TRAIN["steps"]
    if second["steps"] != want:
        raise AssertionError(f"the second run did {second['steps']} steps, "
                             f"not {want}: it did not resume at step "
                             f"{TRAIN['steps']}")

    failed = []

    def injector(step):
        if step == TRAIN["fail_at"] and not failed:
            failed.append(step)
            raise RuntimeError("injected failure")

    sup, _ = train.make_supervisor(
        cfg, batch=TRAIN["batch"], seq=TRAIN["seq"], lr=TRAIN["lr"],
        steps=TRAIN["sup_steps"], ckpt_dir=str(Path(ckpt_root) / "sup"),
        ckpt_every=TRAIN["sup_every"], device="cuda")
    _, history = sup.run(TRAIN["sup_steps"], failure_injector=injector)
    steps_run = [s for s, _ in history]
    print(f"train: supervisor with one injected failure at step "
          f"{TRAIN['fail_at']}: restarts {sup.restarts}, steps run "
          f"{steps_run}", flush=True)
    if sup.restarts != 1 or steps_run[-1] != TRAIN["sup_steps"] - 1:
        raise AssertionError(f"the supervisor did not restart once and "
                             f"finish: restarts {sup.restarts}, steps "
                             f"{steps_run}")
    shutil.rmtree(Path(ckpt_root) / "sup")

    step, flat = ckpt.restore(ckpt_dir)
    if step != TRAIN["resume_to"]:
        raise AssertionError(f"newest checkpoint is step {step}")
    params = params_from_numpy(ckpt.unflatten(flat)["params"], cfg, "cuda")
    summary = {"steps": first["steps"], "resumed_steps": second["steps"],
               "first_loss": first["first_loss"],
               "last_loss": second["last_loss"],
               "mean_step_s": first["mean_step_s"],
               "resumed_mean_step_s": second["mean_step_s"],
               "peak_memory_bytes": peak,
               "supervisor_restarts": sup.restarts,
               "stragglers": first["stragglers"] + second["stragglers"]}
    return cfg, params, launches, summary


def eval_phase(cfg, params):
    """examples/train_ternary_lm.py's evaluation on the trained state: a
    held-out batch (step 10 000) at batch 8 x seq 1024, the QAT model's
    loss with the plain blockwise attention and with B6, then the packed
    model's (B1 + B4 + B6). Counters zeroed before, read after; B6 must
    launch once per layer per "pallas" forward."""
    import dataclasses
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import LM
    from repro_torch.models.layers import pack_params

    batch = SyntheticLM(cfg, EVAL["batch"], EVAL["seq"]).sharded_batch(
        EVAL["step"], device="cuda")
    flash_cfg = dataclasses.replace(cfg, attn_impl="flash")
    pallas_cfg = dataclasses.replace(cfg, attn_impl="pallas")
    packed_cfg = dataclasses.replace(pallas_cfg,
                                     quantization="ternary_packed")
    with torch.no_grad():
        # information, not a gate: the untrained weights' loss (train.build's
        # init from the same seed); 24-32 steps on this data need not lower
        # a held-out loss
        model = LM(flash_cfg, "cuda")
        loss_init, _ = model.loss(model.init(torch.Generator(
            device="cuda").manual_seed(SEED)), batch)
    t0 = time.perf_counter()
    _zero_counts()
    with torch.no_grad():
        loss_flash, _ = LM(flash_cfg, "cuda").loss(params, batch)
        per_forward = [_read_counts()["flash_attention"]]
        loss_qat, _ = LM(pallas_cfg, "cuda").loss(params, batch)
        per_forward.append(_read_counts()["flash_attention"]
                           - per_forward[0])
        packed = pack_params(params, cfg)
        loss_packed, _ = LM(packed_cfg, "cuda").loss(packed, batch)
        torch.cuda.synchronize()
    launches = _read_counts()
    per_forward.append(launches["flash_attention"] - sum(per_forward))
    out = {"loss_init": float(loss_init),
           "loss_qat_flash": float(loss_flash), "loss_qat": float(loss_qat),
           "loss_packed": float(loss_packed),
           "b6_launches_per_forward": per_forward,
           "seconds": time.perf_counter() - t0}
    print(f"eval: {json.dumps(out)}; launches {json.dumps(launches)}",
          flush=True)
    for name, v in out.items():
        if name.startswith("loss") and not torch.isfinite(
                torch.tensor(v)):
            raise AssertionError(f"eval: {name} is not finite")
    if abs(out["loss_qat"] - out["loss_qat_flash"]) > EVAL["qat_tol"]:
        raise AssertionError(f"eval: B6's QAT loss differs from the plain "
                             f"attention's by more than {EVAL['qat_tol']}")
    if not abs(out["loss_packed"] - out["loss_qat"]) < EVAL["packed_tol"]:
        raise AssertionError(f"eval: the packed loss differs from the QAT "
                             f"loss by {EVAL['packed_tol']} or more")
    layers = cfg.num_layers
    if per_forward != [0, layers, layers]:
        raise AssertionError(f"eval: B6 launched {per_forward} times in the "
                             f"flash/pallas/packed forwards, expected "
                             f"[0, {layers}, {layers}]")
    if launches["fused_mlp"] != layers or launches["ternary_gemm"] <= 0:
        raise AssertionError(f"eval: the packed forward did not go through "
                             f"B1 and B4 ({launches})")
    return out, launches


# ---------------------------------------------------------------------------
# train_dist: the distributed trainer, ranks sharing this card over gloo
# ---------------------------------------------------------------------------

def _compressed_reference(cfg, state, batch, dp, lr):
    """One process's stand-in for the compressed data-parallel step:
    each of the ``dp`` row blocks' gradients ternarized with zero error
    (``compression.ternarize_tree``), the codes and the scales summed as
    the group's all-reduces would, then ``synced_tree``, the clip, the
    schedule and AdamW.
    Returns (params, opt, metrics)."""
    from repro_torch.distributed import compression
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import LM
    from repro_torch.models.transformer import layer_period
    from repro_torch.optim import adamw, clip_by_global_norm, warmup_cosine

    model = LM(cfg, "cuda")
    rows = batch["tokens"].shape[0] // dp
    per_rank = [steps_lib.value_and_grad(
        model, cfg, state["params"],
        {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}, accum=1)
        for r in range(dp)]
    period = layer_period(cfg)
    codes = scales = None
    for _, g in per_rank:
        c, sc, _ = compression.ternarize_tree(
            g, compression.init_error_state(g), period=period)
        codes = c if codes is None else codes + c
        scales = sc if scales is None else scales + sc
    grads = compression.synced_tree(per_rank[0][1], codes, scales, dp,
                                    period)
    grads, gnorm = clip_by_global_norm(grads, 1.0)
    total = TRAIN_DIST["schedule_steps"]
    lr_fn = warmup_cosine(lr, min(100, total // 10 + 1), total)
    _, opt_update = adamw(state_dtype=cfg.opt_state_dtype)
    step_lr = lr_fn(state["opt"]["step"] + 1)
    params, opt = opt_update(grads, state["opt"], state["params"], step_lr)
    loss = sum(m["loss"] for m, _ in per_rank) / dp
    return params, opt, {"loss": loss, "grad_norm": gnorm, "lr": step_lr}


def _ternary_flips(params, tp):
    """Row-split latents whose ternary codes differ between one process
    (the column mean over K at once) and ``tp`` row shards (the shards'
    column sums added, then / K): the elements counted."""
    import torch
    n = 0
    for lp in params["layers"]:
        for w in (lp["mixer"]["o"]["w"], lp["ffn"]["out"]["w"]):
            a = w.float().abs()
            one = a > 0.7 * a.mean(dim=-2, keepdim=True)
            parts = a.chunk(tp, dim=-2)
            total = parts[0].sum(dim=-2, keepdim=True)
            for p in parts[1:]:
                total = total + p.sum(dim=-2, keepdim=True)
            n += int((one != (a > 0.7 * (total / a.shape[-2]))).sum())
    return n


def train_dist_mesh(label, trainer, compress, cfg32, cfg, ref, ckpt_root,
                    held_out_init):
    """One mesh of ``train_dist`` on ``trainer``'s ranks, rebuilt for it:
    its first f32 step from the seed's state held to one process's
    (``ref``), the ranks' states checked equal and (tensor parallelism)
    the replicated leaves' gradients equal across tensor-parallel ranks;
    then bf16 steps with one failure and a restart from a checkpoint
    (``_bf16_restart_run``), after which the loss on a held-out batch
    (EVAL's step) must be below ``held_out_init``, one process's at the
    seed's state: over a few steps the step batches' losses follow the
    batches more than the weights. Returns (the readings, the gathered
    bf16 params for ``dp2_tp2``)."""
    from repro_torch.launch import train

    t0 = time.perf_counter()
    dp, tp = trainer.dp, trainer.tp
    trainer.build(cfg32, batch=TRAIN["batch"], seq=TRAIN["seq"],
                  lr=TRAIN_DIST["lr"],
                  total_steps=TRAIN_DIST["schedule_steps"], timed=True,
                  compress=compress)
    out = {"mesh": {"data": dp, "model": tp}, "compress": compress,
           "ranks_on_card": dp * tp, "backend": "gloo"}
    try:
        trainer.init(SEED)
        t1 = time.perf_counter()
        met = trainer.step(0)
        out["f32_step_s"] = time.perf_counter() - t1
        out["f32_comm"] = trainer.last_comm
        st = trainer.state()
        got = (st["params"], st["opt"], met)
        out["first_step"] = hold_first_step(
            f"train_dist {label} first step", label, "one process", got,
            ref)
        del st, got
        reports = trainer.report(grads_step=1 if tp > 1 else None)
        out["replicas"] = train.check_replicas(reports)
        out["f32_peak_bytes"] = [r["peak_bytes"] for r in reports]

        t2 = time.perf_counter()
        history, restarts, t_hist, comms = _bf16_restart_run(
            label, trainer, cfg, compress, str(Path(ckpt_root) / label))
        out["bf16_run_s"] = time.perf_counter() - t2
        out["held_out_loss_trained"] = trainer.eval_loss(EVAL["step"])
        reports = trainer.report()
        out["after_restart"] = train.check_replicas(reports)
        out["bf16_peak_bytes"] = [r["peak_bytes"] for r in reports]
        steps_run = [s for s, _ in history]
        out["steps_run"] = steps_run
        out["restarts"] = restarts
        out["losses"] = [m["loss"] for _, m in history]
        out["bf16_step_s"] = t_hist
        out["bf16_comm"] = comms
        params = trainer.state(params_only=True)["params"] \
            if label == "dp2_tp2" else None
    finally:
        shutil.rmtree(Path(ckpt_root) / label, ignore_errors=True)
        out["seconds"] = time.perf_counter() - t0
        print(f"train_dist {label}: " + json.dumps(out), flush=True)
    if restarts != 1 or steps_run[-1] != TRAIN_DIST["steps"] - 1 \
            or reports[0]["step"] != TRAIN_DIST["steps"]:
        raise AssertionError(f"train_dist {label}: the run did not restart "
                             f"once and finish")
    if not out["held_out_loss_trained"] < held_out_init:
        raise AssertionError(f"train_dist {label}: the held-out loss did not "
                             f"fall")
    return out, params


def _bf16_restart_run(label, trainer, cfg, compress, ckpt_dir):
    """``train_dist``'s bf16 steps on ``trainer``'s ranks from the seed's
    state, with one failure at TRAIN_DIST["fail_at"] and a restart from a
    checkpoint of that step. ``dp2_tp2`` runs under ``TrainSupervisor``
    (``make_dist_supervisor``: checkpoints every ckpt_every and at the
    end, the newest intact one found and restored on every rank after the
    injected failure); the other meshes save one checkpoint at the
    failure's step, lose every rank's state (a fresh draw from another
    seed) and restore it: the same save and restore, without the
    supervisor's verify pass and final save. Returns (history of (step,
    metrics), restarts, step seconds, collectives by step)."""
    from repro_torch import checkpoint as ckpt_lib
    from repro_torch.launch import train

    comms = []
    if label == "dp2_tp2":
        failed = []

        def injector(step):
            if step == TRAIN_DIST["fail_at"] and not failed:
                failed.append(step)
                raise RuntimeError("injected failure")

        sup, t_hist, _ = train.make_dist_supervisor(
            cfg, data_parallel=trainer.dp, model_parallel=trainer.tp,
            batch=TRAIN["batch"], seq=TRAIN["seq"], lr=TRAIN_DIST["lr"],
            steps=TRAIN_DIST["schedule_steps"], ckpt_dir=ckpt_dir,
            ckpt_every=TRAIN_DIST["ckpt_every"], seed=SEED,
            compress=compress, log_every=TRAIN_DIST["steps"], timed=True,
            trainer=trainer)

        def step_fn(step, state, inner=sup.step_fn):
            state, metrics = inner(step, state)
            comms.append(trainer.last_comm)
            return state, metrics

        sup.step_fn = step_fn
        # the schedule spans schedule_steps; the run stops after steps
        _, history = sup.run(TRAIN_DIST["steps"], failure_injector=injector)
        return history, sup.restarts, t_hist, comms
    trainer.build(cfg, batch=TRAIN["batch"], seq=TRAIN["seq"],
                  lr=TRAIN_DIST["lr"],
                  total_steps=TRAIN_DIST["schedule_steps"], timed=True)
    trainer.init(SEED)
    history, t_hist = [], []
    for step in range(TRAIN_DIST["steps"]):
        if step == TRAIN_DIST["fail_at"]:
            ckpt_lib.save(ckpt_dir, step, trainer.checkpoint_tree())
            trainer.init(SEED + 1)
            if trainer.restore(ckpt_dir) != step:
                raise AssertionError(f"train_dist {label}: restored another "
                                     f"step than {step}")
        t0 = time.perf_counter()
        history.append((step, trainer.step(step)))
        t_hist.append(time.perf_counter() - t0)
        comms.append(trainer.last_comm)
    return history, 1, t_hist, comms


def train_dist_phase():
    """The distributed trainer (module docstring, ``train_dist``). Returns
    (readings, launches of the packed evaluation of dp 2 x tp 2's state)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import compression
    from repro_torch.launch import train
    from repro_torch.models import LM
    from repro_torch.models.transformer import layer_period

    t0 = time.perf_counter()
    cfg = get_config("ternary-paper")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    _, data, step, init = train.build(cfg32, TRAIN["batch"], TRAIN["seq"],
                                      TRAIN_DIST["lr"],
                                      TRAIN_DIST["schedule_steps"], "cuda")
    state = init(SEED)
    batch = data.sharded_batch(0, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plain = step(state["params"], state["opt"], batch)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t1
    flips = _ternary_flips(state["params"], 2)
    summary = {"one_process_f32_step_s": one_s,
               "ternary_code_flips_at_tp2": flips,
               "wire_bytes_f32": compression.wire_bytes(state["params"],
                                                        False),
               "wire_bytes_codes": compression.wire_bytes(
                   state["params"], True, layer_period(cfg))}
    print("train_dist: one-process f32 step at batch "
          f"{TRAIN['batch']} x {TRAIN['seq']}: {one_s:.3f}s; " +
          json.dumps(summary), flush=True)
    comp = _compressed_reference(cfg32, state, batch, 2, TRAIN_DIST["lr"])
    del state
    model = LM(cfg, "cuda")
    with torch.no_grad():
        summary["held_out_loss_init"] = float(model.loss(
            model.init(torch.Generator(device="cuda").manual_seed(SEED)),
            data.sharded_batch(EVAL["step"], device="cuda"))[0])
    del model
    torch.cuda.empty_cache()
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_train_dist_")
    meshes, params, trainer = {}, None, None
    try:
        for label, dp, tp, compress in TRAIN_DIST["meshes"]:
            if trainer is None or (trainer.dp, trainer.tp) != (dp, tp):
                # meshes of one shape share their ranks (processes, groups)
                if trainer is not None:
                    trainer.close()
                t1 = time.perf_counter()
                trainer = train.DistTrainer(
                    cfg32, data_parallel=dp, model_parallel=tp,
                    batch=TRAIN["batch"], seq=TRAIN["seq"],
                    lr=TRAIN_DIST["lr"],
                    total_steps=TRAIN_DIST["schedule_steps"],
                    compress=compress, device="cuda",
                    timeout_s=TRAIN_DIST["timeout_s"], timed=True)
                summary[f"start_s_dp{dp}_tp{tp}"] = time.perf_counter() - t1
            ref = comp if compress else plain
            meshes[label], got = train_dist_mesh(
                label, trainer, compress, cfg32, cfg, ref, ckpt_root,
                summary["held_out_loss_init"])
            params = got if got is not None else params
            torch.cuda.empty_cache()
    finally:
        if trainer is not None:
            trainer.close()
        shutil.rmtree(ckpt_root, ignore_errors=True)
    del plain, comp
    torch.cuda.empty_cache()
    summary["meshes"] = meshes
    eval_out, launches = eval_phase(cfg, params)
    summary["eval_dp2_tp2"] = eval_out
    summary["seconds"] = time.perf_counter() - t0
    print("train_dist summary: " + json.dumps(summary), flush=True)
    return summary, launches


# ---------------------------------------------------------------------------
# families: the MoE, SSM and hybrid decoder families served on the card
# ---------------------------------------------------------------------------

def _family_engine(cfg, params, spec, graph, tracer=None, **engine_kw):
    from repro_torch.serving import ContinuousScheduler
    engine = ContinuousScheduler(cfg, max_slots=spec["slots"],
                                 max_len=spec["max_len"], device="cuda",
                                 tracer=tracer, cuda_graph=graph,
                                 **engine_kw)
    engine.load(params)
    return engine


def _family_cache_kw(mode):
    return {"dense": {},
            "paged_bf16": dict(cache="paged", page_size=PAGE_SIZE),
            "paged_int8": dict(cache="paged", page_size=PAGE_SIZE,
                               kv_dtype="int8")}[mode]


def family_serve(name, cfg, params, spec, prompts, gens, mode):
    """Drain the family's workload through the graphed engine over one
    cache mode; the launch counters are set to 0 just before the run and
    read just after. Checks every request's budget of in-range tokens, B1
    launched, B4 launched iff the model has packed MLP layers, and B5 once
    per attention layer and decode step (paged) or never (dense)."""
    from repro_torch.launch import serve
    from repro_torch.obs import Tracer

    label = f"{name} {mode}"
    tracer = Tracer()
    engine = _family_engine(cfg, params, spec, True, tracer,
                            **_family_cache_kw(mode))
    _zero_counts()
    outs, metrics = serve.run_continuous(engine, prompts, gens)
    launches = _read_counts()
    spans = span_summary(tracer.to_dict()["traceEvents"])
    print(f"families {label} metrics: " + json.dumps(
        {k: v for k, v in metrics.items() if k != "per_request"}),
        flush=True)
    print(f"families {label} launches: {json.dumps(launches)}", flush=True)
    if metrics["drained"] != len(gens):
        raise AssertionError(f"families {label}: drained "
                             f"{metrics['drained']} of {len(gens)}")
    for i, (toks, g) in enumerate(zip(outs, gens)):
        if len(toks) != g or not ((toks >= 0)
                                  & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"families {label}: request {i}: "
                                 f"{len(toks)} tokens for a budget of {g}, "
                                 f"or ids out of range")
    n_attn = sum(k == "attn" for k, _ in engine.model.kinds)
    n_mlp = sum(f == "mlp" for _, f in engine.model.kinds)
    if launches["ternary_gemm"] <= 0:
        raise AssertionError(f"families {label}: ternary_gemm never "
                             f"launched")
    if (launches["fused_mlp"] > 0) != (n_mlp > 0):
        raise AssertionError(f"families {label}: fused_mlp launched "
                             f"{launches['fused_mlp']} times for {n_mlp} "
                             f"MLP layers")
    want = n_attn * metrics["decode_steps"] if mode != "dense" else 0
    if launches["paged_decode_attention"] != want:
        raise AssertionError(
            f"families {label}: paged_decode_attention launched "
            f"{launches['paged_decode_attention']} times, expected {want}")
    row = {"tok_per_s": metrics["tok_per_s"],
           "tpot_p50_ms": metrics["latency"]["tpot_s"]["p50"] * 1e3,
           "decode_step_p50_ms": spans["decode_step"]["p50_ms"],
           "decode_steps": metrics["decode_steps"],
           "prefill_p50_ms": spans["prefill"]["p50_ms"],
           "wall_s": metrics["wall_s"],
           "cache": metrics["cache"]}
    del engine
    return outs, launches, row


def family_step_check(name, cfg, params, spec, prompts, gens, mode,
                      profile=False):
    """One decode-only step of a fresh eager engine and of a fresh graphed
    one on the same requests: the logits bitwise equal and the launches
    per step equal (B5 once per attention layer, paged). With
    ``profile``, the graph's replay under the profiler (port kernels
    against the rest of the device time)."""
    import torch

    steps, prof = {}, None
    for path in ("eager", "graph"):
        engine = _family_engine(cfg, params, spec, path == "graph",
                                **_family_cache_kw(mode))
        for p, g in zip(prompts, gens):
            engine.submit(p, g)
        per_step = _decode_only_step(engine)
        steps[path] = (engine.last_logits.clone(),
                       {k: per_step[k] for k in GRAPH_KERNELS})
        if path == "graph" and profile:
            prof = profile_once(f"families {name} {mode} graphed decode "
                                f"step", engine._graph.replay,
                                lambda: _mean_wall(engine._graph.replay, 5))
        del engine
    (le, ce), (lg, cg) = steps["eager"], steps["graph"]
    if ce != cg:
        raise AssertionError(f"families {name} {mode}: launches per decode "
                             f"step differ: eager {ce}, graph {cg}")
    if not torch.equal(le, lg):
        raise AssertionError(
            f"families {name} {mode}: one step's logits differ between "
            f"eager and graph, max |d| "
            f"{float((le.float() - lg.float()).abs().max())}")
    n_attn = sum(k == "attn" for k, _ in cfg_kinds(cfg))
    if mode != "dense" and cg["paged_decode_attention"] != n_attn:
        raise AssertionError(f"families {name} {mode}: B5 launched "
                             f"{cg['paged_decode_attention']} times a step "
                             f"for {n_attn} attention layers")
    print(f"families {name} {mode}: one step's logits bitwise equal eager "
          f"and graphed; launches a step {json.dumps(cg)}", flush=True)
    return cg, prof


def cfg_kinds(cfg):
    return [(cfg.layer_kind(i), cfg.layer_ffn(i))
            for i in range(cfg.num_layers)]


@contextlib.contextmanager
def _routing(mode, book):
    """Record (``"record"``) the index sets every MoE top-k returns (the
    router's top-k and each expert's capacity top-C) into ``book``, or
    replay them (``"replay"``): each call then takes the recorded indices
    in call order, with its own values at them."""
    from repro_torch.models import moe
    orig = moe.top_k
    calls = iter(list(book))

    def top_k(a, k):
        if mode == "record":
            vals, idx = orig(a, k)
            book.append(idx)
            return vals, idx
        idx = next(calls)
        return a.gather(-1, idx), idx

    moe.top_k = top_k
    try:
        yield book
    finally:
        moe.top_k = orig


def _one_ulp(x, gen):
    """``x`` with every element moved one ulp of its dtype, up or down as
    drawn from ``gen`` (zeros move away from zero)."""
    import torch
    ity = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
           torch.float32: torch.int32}[x.dtype]
    bits = x.contiguous().view(ity)
    step = torch.randint(0, 2, bits.shape, generator=gen, device=x.device,
                         dtype=ity) * 2 - 1
    step = torch.where((bits & torch.iinfo(ity).max) == 0,
                       torch.ones_like(step), step)
    return (bits + step).view(x.dtype)


@contextlib.contextmanager
def _layer_inputs(mode, book, nudge=None):
    """Record (``"record"``) every decoder block's input hidden state into
    ``book["in"]``, or replay them (``"replay"``): each block then runs on
    the recorded input, in call order (teacher forcing, layer by layer).
    Every block's output is kept in ``book["out"]`` for the per-layer
    distances. ``nudge`` = (generator, layers): recording, the first
    block's input of every pass is moved one ulp (``_one_ulp``)."""
    from repro_torch.models import transformer
    orig = transformer.LM._apply_block
    calls = iter(list(book["in"]))
    count = [0]

    def block(self, bp, x, kind, ffn, **kw):
        if mode == "replay":
            x = next(calls)
        else:
            if nudge is not None and count[0] % nudge[1] == 0:
                x = _one_ulp(x, nudge[0])
            count[0] += 1
            book["in"].append(x.clone())
        out = orig(self, bp, x, kind, ffn, **kw)
        book["out"].append(out[0].float().clone())
        return out

    transformer.LM._apply_block = block
    try:
        yield book
    finally:
        transformer.LM._apply_block = orig


def _layer_rel_d(got, ref):
    """max|got - ref| / max|ref| of each recorded block output."""
    return [float((g - r).abs().max() / r.abs().max())
            for g, r in zip(got, ref)]


def family_plain_check(name, cfg, params, prompts, max_len, forced,
                       extras=None, tag="families"):
    """The prefill's last-position logits and one decode step's logits
    through the kernels against the plain path on the card (the same
    weights and inputs with ``ternary_kernel="xla"``: B1's plain row, the
    MLP chain of plain GEMMs), within LOGIT_TOL. MoE routing is discrete:
    a gate that moves by an ulp can swap which token an expert's capacity
    keeps, and so move a whole expert's output; the kernel path therefore
    replays the plain path's routing decisions (each top-k's indices, its
    own gate values). With ``forced`` the kernel path also runs every
    block on the plain path's input to it (teacher forcing layer by layer:
    a model that amplifies an ulp at every layer is held at each layer's
    own error), and every block's output must lie within FORCED_LAYER_TOL
    of the plain one's. Then the free-running kernel path (nothing pinned
    or forced) and a witness: the plain path with the first block's input
    moved one bf16 ulp (``_one_ulp``), free-running too. The free path's
    logits must lie within WITNESS_FACTOR times the witness's distance (or
    LOGIT_TOL): what the model itself makes of one rounding bounds what
    the kernels' roundings may do. Both per-layer distance curves over
    the prefill's blocks are reported. ``extras``: the prompts' frontend
    rows (a VLM's vision rows, an encoder-decoder's frames; its encoder
    blocks count among the prefill's blocks); ``tag`` heads the lines."""
    import dataclasses
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import LM

    # the plain path: B1's plain row and the MLP chain, and under
    # attn_impl "pallas" the blockwise attention in B6's place
    plain = dataclasses.replace(
        cfg, ternary_kernel="xla",
        attn_impl="flash" if cfg.attn_impl == "pallas" else cfg.attn_impl)
    batch = {"tokens": torch.as_tensor(prompts, device="cuda")}
    for k, v in (extras or {}).items():
        batch[k] = torch.as_tensor(v, device="cuda")
    b = prompts.shape[0]
    n = cfg.num_layers + cfg.enc_layers      # a prefill's blocks
    out, routes, layers, nxt = {}, {}, {}, None
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    with torch.no_grad():
        for label, c, mode in (("plain", plain, "record"),
                               ("kernels", cfg, "replay"),
                               ("free", cfg, "record"),
                               ("witness", plain, "record")):
            model = LM(c, "cuda")
            route = routes["plain"] if mode == "replay" else []
            replay = mode == "replay" and forced
            book = {"in": layers["plain"]["in"] if replay else [], "out": []}
            nudge = (gen, n) if label == "witness" else None
            force = _layer_inputs("replay" if replay else "record", book,
                                  nudge)
            with _routing(mode, route), force:
                with ops.serving_phase("prefill"):
                    cache, logits = model.prefill(params, batch, max_len)
                if nxt is None:
                    nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
                pos = cache["pos"].expand(b).contiguous()
                with ops.serving_phase("decode"):
                    step, _ = model.decode_step(params, dict(cache, pos=pos),
                                                nxt)
            routes.setdefault(label, route)
            layers[label] = book
            out[label] = (logits[:, -1].clone(), step[:, 0].clone())
            del cache
    ref = out["plain"]
    how = "layer-forced, " if forced else ""
    _compare_logits(f"{tag} {name}: prefill, kernels vs plain path on "
                    f"the card ({how}routing pinned)", ref[0],
                    out["kernels"][0], LOGIT_TOL)
    _compare_logits(f"{tag} {name}: one decode step, kernels vs plain "
                    f"path on the card ({how}routing pinned)", ref[1],
                    out["kernels"][1], LOGIT_TOL)

    def moved(label):
        # index sets, not orders: an expert's kept tokens in another order
        # compute the same thing
        return sum(int((x.sort(-1).values != y.sort(-1).values).any(-1)
                       .sum()) for x, y in zip(routes["plain"],
                                               routes[label]))

    def max_d(label, i):
        return float((out[label][i].float() - ref[i].float()).abs().max())

    scale = float(ref[0].float().abs().max())
    report = {"gate": ("layer_forced" if forced else "end_to_end")
              + ", routing pinned",
              "routing_calls": len(routes["plain"]),
              "routing_rows_differing_free": moved("free"),
              "routing_rows_differing_witness": moved("witness"),
              "free_prefill_max_d": max_d("free", 0),
              "free_step_max_d": max_d("free", 1),
              "witness_prefill_max_d": max_d("witness", 0),
              "witness_step_max_d": max_d("witness", 1),
              "max_logit": scale,
              "free_layer_rel_d": _layer_rel_d(
                  layers["free"]["out"][:n], layers["plain"]["out"][:n]),
              "witness_layer_rel_d": _layer_rel_d(
                  layers["witness"]["out"][:n], layers["plain"]["out"][:n])}
    if forced:
        per_layer = _layer_rel_d(layers["kernels"]["out"],
                                 layers["plain"]["out"])
        report["forced_layer_rel_d"] = per_layer[:n]
        report["forced_layer_max_rel_d"] = max(per_layer)
    print(f"{tag} {name}: kernels vs plain, free-running, and the "
          f"one-ulp witness: " + json.dumps(report), flush=True)
    if forced and report["forced_layer_max_rel_d"] > FORCED_LAYER_TOL:
        raise AssertionError(
            f"{tag} {name}: a layer-forced block's output through the "
            f"kernels lies {report['forced_layer_max_rel_d']} of its max "
            f"from the plain path's (bound {FORCED_LAYER_TOL})")
    for i, what in enumerate(("prefill", "step")):
        free, witness = max_d("free", i), max_d("witness", i)
        bound = max(LOGIT_TOL * scale, WITNESS_FACTOR * witness)
        if free > bound:
            raise AssertionError(
                f"{tag} {name}: the free-running {what} logits through "
                f"the kernels lie {free} from the plain path's, more than "
                f"{WITNESS_FACTOR} x the one-ulp witness's {witness} and "
                f"LOGIT_TOL x max|logit| ({LOGIT_TOL * scale})")
    return report


def bank_materialize_ms(params, flush):
    """Card time to decode and scale every packed expert bank of the model
    once (what each MoE layer does every call), summed over the layers."""
    import torch
    from repro_torch.core.weights import TernaryWeight
    banks = [lay["ffn"][n] for lay in params["layers"]
             for n in ("w_in", "w_gate", "w_out")
             if isinstance(lay.get("ffn", {}).get(n), TernaryWeight)]
    if not banks:
        return None
    per_layer = banks[:3]
    ms = cuda_ms(lambda: [w.materialize(torch.bfloat16, with_scale=True)
                          for w in per_layer], 5, flush)
    return {"banks": len(banks), "ms_per_layer": ms,
            "ms_per_step": ms * len(banks) / 3,
            "bytes_per_layer": sum(w.n * w.k * w.packed.shape[0] * 2
                                   for w in per_layer)}


def family_kernel_rows(name, cfg, spec, flush):
    """B1 at the model's packed projections, B4 at its MLP and B5 at its
    attention (GQA, paged), each at the decode M (slots) and the first
    prefill group's M (slots x prompt length), against their plain
    versions, timed; rows ``"on_path": true`` with the model's name. B5
    also over rows of FAMILY_LONG_CONTEXT tokens (``"on_path": false``)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    d, hd = cfg.d_model, cfg.head_dim
    ms = (spec["slots"], spec["slots"] * spec["prompt_len"])
    gemm = []
    if any(k == "ssm" for k, _ in cfg_kinds(cfg)):
        d_proj = 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state \
            + cfg.ssm_heads
        gemm += [("in_proj", d, d_proj), ("out_proj", cfg.d_inner, d)]
    if any(k == "attn" for k, _ in cfg_kinds(cfg)):
        gemm += [("q", d, cfg.num_heads * hd),
                 ("k/v", d, cfg.num_kv_heads * hd),
                 ("o", cfg.num_heads * hd, d)]
    if not cfg.tie_embeddings:
        gemm.append(("lm_head", d, cfg.padded_vocab()))
    rows = {"ternary_gemm": [], "fused_mlp": [],
            "paged_decode_attention": []}
    for what, k, n in gemm:
        for m in ms:
            row = gemm_row(gen, m, k, n, _serving_phase(m), flush)
            rows["ternary_gemm"].append(dict(row, model=name, proj=what))
    if any(f == "mlp" for _, f in cfg_kinds(cfg)):
        for m in ms:
            row = mlp_row(gen, m, d, cfg.d_ff, d, _serving_phase(m), flush)
            rows["fused_mlp"].append(dict(row, model=name))
    if "paged_bf16" in spec["caches"] and any(k == "attn"
                                              for k, _ in cfg_kinds(cfg)):
        shape = dict(b=spec["slots"], h=cfg.num_heads, kv=cfg.num_kv_heads,
                     hd=hd, t=-(-spec["max_len"] // PAGE_SIZE))
        inputs = _paged_inputs(gen, shape, lambda: torch.randint(
            spec["prompt_len"], spec["max_len"] + 1, (shape["b"],),
            generator=gen, device="cuda", dtype=torch.int32))
        subsets = ([shape["b"] - 1], list(range(shape["b"]))[::-2])
        for row in paged_rows(f"{name} GQA", shape, inputs, flush,
                              subsets=subsets, on_path=True):
            rows["paged_decode_attention"].append(dict(row, model=name))
        lo, hi = FAMILY_LONG_CONTEXT
        shape = dict(shape, t=hi // PAGE_SIZE)
        inputs = _paged_inputs(gen, shape, lambda: torch.randint(
            lo, hi + 1, (shape["b"],), generator=gen, device="cuda",
            dtype=torch.int32))
        for row in paged_rows(f"{name} GQA {lo}-{hi} tokens", shape, inputs,
                              flush, subsets=subsets, on_path=False):
            rows["paged_decode_attention"].append(dict(row, model=name))
    return rows


def family_phase(name, spec, flush, keep=None):
    """One family's model at full widths (cut in depth where ``spec``
    says), ternarized and packed layer by layer as it is drawn, served
    over each cache mode of ``spec``; then the checks of ``families_phase``.
    Returns (kernel rows, runs' launches, summary)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = get_config(name, quantization="ternary", **spec["overrides"])
    t0 = time.perf_counter()
    cfg, params = serve.build_params(cfg, SEED, "cuda", packed=True)
    torch.cuda.synchronize()
    kinds = cfg_kinds(cfg)
    print(f"families {name}: init+pack {cfg.num_layers} layers (d "
          f"{cfg.d_model}, {sum(k == 'attn' for k, _ in kinds)} attention, "
          f"{sum(k == 'ssm' for k, _ in kinds)} SSM, "
          f"{sum(f == 'moe' for _, f in kinds)} MoE, "
          f"{sum(f == 'mlp' for _, f in kinds)} MLP, vocab "
          f"{cfg.vocab_size}): {serve.count_packed(params)} packed "
          f"containers in {time.perf_counter() - t0:.2f}s, "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB peak",
          flush=True)
    prompts, gens, _ = serve.build_workload(cfg, spec["requests"],
                                         spec["prompt_len"],
                                         spec["gen_lens"], seed=SEED)
    spec = dict(spec, max_len=spec["prompt_len"] + max(spec["gen_lens"]) + 1)
    outs, runs, summary = {}, {}, {}
    summary["plain_check"] = family_plain_check(
        name, cfg, params, prompts[:spec["slots"]], spec["max_len"],
        spec["layer_forced"])
    for mode in spec["caches"]:
        outs[mode], runs[f"families {name} {mode}"], summary[mode] = \
            family_serve(name, cfg, params, spec, prompts, gens, mode)
        per_step, prof = family_step_check(
            name, cfg, params, spec, prompts, gens, mode,
            profile=mode == "dense")
        summary[mode]["per_decode_step_launches"] = per_step
        if prof is not None:
            summary[mode]["decode_step_profile"] = prof
    for mode in spec["caches"]:
        if mode == "dense":
            continue
        same = sum(np.array_equal(a, b)
                   for a, b in zip(outs["dense"], outs[mode]))
        summary[mode]["streams_equal_dense"] = f"{same}/{len(gens)}"
        print(f"families {name} {mode}: {same}/{len(gens)} streams equal "
              f"the dense run's", flush=True)
        if spec["paged_exact"]:
            if same != len(gens):
                raise AssertionError(f"families {name} {mode}: streams "
                                     f"differ from the dense run's")
            continue
        # MoE capacity is per step (1 token an expert at 4 slots, more in a
        # teacher-forced prefill), so the near-tie rule reads one decode
        # step on both caches from the same prefill, routing pinned
        int8 = mode == "paged_int8"
        paged_step_check(f"families {name} {mode} vs dense, one decode "
                         f"step, routing pinned", cfg, params,
                         prompts[:spec["slots"]], spec["max_len"],
                         "int8" if int8 else None,
                         INT8_LOGIT_TOL if int8 else LOGIT_TOL,
                         pin_routing=True)
    summary["bank_materialize"] = bank_materialize_ms(params, flush)
    if keep is not None:
        keep[name] = (cfg, params)
    del params
    torch.cuda.empty_cache()
    return family_kernel_rows(name, cfg, spec, flush), runs, summary


def families_phase(flush, keep=None):
    """The MoE, SSM and hybrid families through the engine on the card
    (FAMILIES): jamba-v0.1-52b at full widths, one period of 8 layers,
    dense and paged with bf16 and int8 pages; mamba2-130m whole, dense
    and paged (its pool holds SSM rows only); mixtral-8x22b at full widths,
    2 layers, dense (paged pools refuse its sliding window). Each: the
    requests drain with their budgets of in-range tokens, the prefill's
    and one decode step's logits through the kernels lie within LOGIT_TOL
    of the plain path on the card (mamba2 layer-forced, each block within
    FORCED_LAYER_TOL), the free-running kernel path within WITNESS_FACTOR
    of the one-ulp witness, a decode step's logits are bitwise equal
    eager and graphed, the launches a decode step are counted, the paged
    streams equal the dense ones (mamba2 exactly; jamba's are counted, and
    one decode step from the same prefill on both caches, MoE routing
    pinned, is held within LOGIT_TOL with bf16 pages and INT8_LOGIT_TOL
    with int8 ones), and B1/B4/B5 run at the model's shapes against their
    plain versions.
    Prints the ``families summary:`` line."""
    rows = {"ternary_gemm": [], "fused_mlp": [],
            "paged_decode_attention": []}
    runs, summary = {}, {}
    for name, spec in FAMILIES.items():
        t0 = time.perf_counter()
        fam_rows, fam_runs, summary[name] = family_phase(name, spec, flush,
                                                         keep)
        summary[name]["phase_s"] = round(time.perf_counter() - t0, 1)
        runs.update(fam_runs)
        for k, v in fam_rows.items():
            rows[k] += v
    print("families summary: " + json.dumps(summary), flush=True)
    return rows, runs


# ---------------------------------------------------------------------------
# tp_families: tensor parallelism for the MoE, SSM, hybrid, encoder-decoder
# and VLM families on the card
# ---------------------------------------------------------------------------

def _tp_family_drive(engine, prompts, gens, group):
    """``_tp_drive`` for a tensor-parallel family engine whose slots take
    every request at once: submit, take the first step's decode logits
    (the prefill and one decode step), time the next step (a decode-only
    step: launches, host wall ms, the group's collectives: calls, bytes a
    rank, ms), drain; the launch counters zeroed just before and read
    just after, the timed step's included. Returns (streams, metrics,
    the first step's logits, launches, the timed step's (launches, ms,
    collectives))."""
    import numpy as np
    import torch
    reqs = [engine.submit(p, g) for p, g in zip(prompts, gens)]
    _zero_counts()
    engine.step()
    first = engine.last_logits.float().clone()
    before = _read_counts()
    p0 = engine.prefill_steps
    group.timed = True
    c0, b0, s0 = group.calls, group.bytes, group.seconds
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    group.timed = False
    per_step = _read_counts()
    if engine.prefill_steps != p0:
        raise AssertionError("a tensor-parallel family engine admitted a "
                             "request after its first step")
    comm = {"calls": group.calls - c0, "bytes": group.bytes - b0,
            "ms": (group.seconds - s0) * 1e3}
    _zero_counts()
    metrics = engine.run()
    after = _read_counts()
    launches = {k: before[k] + per_step[k] + after[k] for k in after}
    return ([np.asarray(r.tokens, np.int32) for r in reqs], metrics, first,
            launches, (per_step, wall, comm))


def tp_pinned_step(what, cfg, params, prompts, max_len, forced):
    """A prefill of ``prompts`` and one decode step on the card, at tp 1
    and at tp 2 (two threads of this process as the ranks, each with its
    own gloo group on cuda:0), every MoE top-k of the tp 2 ranks replaying
    the tp 1 pass's indices (``_routing``'s book, per thread). The ranks'
    decode-step logits (all-gathered) must be equal, and within LOGIT_TOL
    of max|logit| of tp 1's. With ``forced`` (a model that amplifies an
    ulp at every layer: FAMILIES' ``layer_forced``) that holds for a pass
    whose every block runs on tp 1's input to it (each block's output
    within FORCED_LAYER_TOL of tp 1's), while the free pass is held
    within WITNESS_FACTOR of what one ulp at the first block's input does
    to tp 1 (the witness). Returns the readings."""
    import threading
    import torch
    from repro_torch.distributed import tp as tp_lib
    from repro_torch.kernels import ops
    from repro_torch.models import LM, moe, transformer
    from repro_torch.models.transformer import param_specs

    b, s = prompts.shape
    toks = torch.as_tensor(prompts, device="cuda")
    pos = torch.full((b,), s, dtype=torch.int32, device="cuda")

    def run(model, p, nxt=None):
        with torch.no_grad():
            with ops.serving_phase("prefill"):
                cache, logits = model.prefill(p, {"tokens": toks}, max_len)
            if nxt is None:
                nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            with ops.serving_phase("decode"):
                out, _ = model.decode_step(
                    p, {"layers": cache["layers"], "pos": pos}, nxt)
        return nxt, out[:, 0].float()

    def rel(got, ref):
        return float((got - ref).abs().max() / ref.abs().max())

    routes, blocks = [], {"in": [], "out": []}
    with _routing("record", routes), _layer_inputs("record", blocks):
        nxt, ref = run(LM(cfg, "cuda"), params)
    out = {}
    if forced:
        wbook = {"in": [], "out": []}
        gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
        with _routing("replay", routes), _layer_inputs(
                "record", wbook, nudge=(gen, cfg.num_layers)):
            out["witness"] = rel(run(LM(cfg, "cuda"), params, nxt)[1], ref)
        del wbook
    shards = [tp_lib.shard_params(params, param_specs(cfg, params),
                                  {"model": TP["tp"]}, rank=r, cfg=cfg)
              for r in range(TP["tp"])]
    local = threading.local()
    orig_top_k, orig_block = moe.top_k, transformer.LM._apply_block

    def top_k(a, k):
        idx = next(local.calls)
        return a.gather(-1, idx), idx

    def block(self, bp, x, kind, ffn, **kw):
        if local.force:
            x = next(local.inputs)
        res = orig_block(self, bp, x, kind, ffn, **kw)
        local.outs.append(res[0].float().clone())
        return res

    def rank(r, force, store, results, errors):
        try:
            torch.cuda.set_device(0)
            group = tp_lib.Group.join(store, r, TP["tp"], "gloo",
                                      TRAIN_DIST["timeout_s"])
            model = LM(tp_lib.local_config(cfg, TP["tp"]), "cuda")
            model.comm = group
            local.calls, local.force = iter(routes), force
            local.inputs, local.outs = iter(blocks["in"]), []
            results[r] = (run(model, shards[r], nxt)[1], local.outs)
            if next(local.calls, None) is not None:
                raise AssertionError("the rank made fewer MoE top-k calls "
                                     "than tp 1")
        except BaseException as e:          # reported by the caller
            errors[r] = e

    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_pinned_"))
    moe.top_k, transformer.LM._apply_block = top_k, block
    try:
        for force in ((True, False) if forced else (False,)):
            results, errors = {}, {}
            store = str(workdir / f"store_{force}")
            threads = [threading.Thread(target=rank, args=(
                r, force, store, results, errors))
                for r in range(TP["tp"])]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            label = f"{what}{', layer-forced' if force else ''}"
            if errors:
                raise AssertionError(f"{label}: a rank failed: {errors}")
            (got, outs), (other, _) = results[0], results[1]
            if not torch.equal(got, other):
                raise AssertionError(f"{label}: the ranks' logits differ")
            if force:
                per = [rel(g, r) for g, r in zip(outs, blocks["out"])]
                out["forced_block_rel_d_max"] = max(per)
                out["forced_logits_rel_d"] = rel(got, ref)
                print(f"{label}: per-block max|d| / max|tp 1| up to "
                      f"{max(per):.4g} (bound {FORCED_LAYER_TOL:.4g})",
                      flush=True)
                if max(per) > FORCED_LAYER_TOL:
                    raise AssertionError(f"{label}: a block lies "
                                         f"{max(per)} from tp 1's")
                _compare_logits(label, ref, got, LOGIT_TOL)
            elif forced:
                out["free_logits_rel_d"] = d = rel(got, ref)
                bound = max(LOGIT_TOL, WITNESS_FACTOR * out["witness"])
                print(f"{label}: free-running logits {d:.4g} of max|logit| "
                      f"from tp 1's; the one-ulp witness {out['witness']:.4g}"
                      f" (bound {bound:.4g})", flush=True)
                if d > bound:
                    raise AssertionError(f"{label}: {d} beyond {bound}")
            else:
                _compare_logits(label, ref, got, LOGIT_TOL)
                out["logits_rel_d"] = rel(got, ref)
    finally:
        moe.top_k, transformer.LM._apply_block = orig_top_k, orig_block
        shutil.rmtree(workdir, ignore_errors=True)
    return out


def tp_engine_witness(cfg, params, kw, max_len, prompts, gens, r_outs,
                      r_first):
    """The one-ulp witness of a tp 1 engine run: the same workload through
    a fresh tp 1 engine (eager, the same cache mode ``kw``) with every
    pass's first block input moved one ulp (``_layer_inputs``' nudge).
    Returns (the first decode step's max|d| / max|tp 1| over the rows
    whose first tokens agree (all rows where none do), that max|d|
    absolute, the witness's streams equal to tp 1's)."""
    import numpy as np
    import torch
    from repro_torch.serving import ContinuousScheduler

    eng = ContinuousScheduler(cfg, max_slots=TP_FAMILIES["slots"],
                              max_len=max_len, device="cuda",
                              cuda_graph=False, **kw)
    eng.load(params)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
    with _layer_inputs("record", {"in": [], "out": []},
                       nudge=(gen, cfg.num_layers)):
        w_outs, _, w_first, _ = _tp_drive(eng, prompts, gens)
    del eng
    torch.cuda.empty_cache()
    rows = [i for i in range(len(w_first)) if w_outs[i][0] == r_outs[i][0]] \
        or list(range(len(w_first)))
    d = float((w_first[rows].float() - r_first[rows].float()).abs().max())
    rel = d / float(r_first[rows].float().abs().max())
    return rel, d, sum(np.array_equal(a, b) for a, b in zip(r_outs, w_outs))


def tp_family_serve(name, cfg, params, flush):
    """One family's packed model at tp 2 (two ranks sharing cuda:0 over
    gloo, eager) against tp 1 (eager) on the same weights, each of
    FAMILIES' cache modes against its own tp 1 run, TP_FAMILIES'
    workload: every request drains with its budget; the first decode
    step's logits within the larger of LOGIT_TOL and WITNESS_FACTOR times
    the one-ulp witness of max|logit| (``tp_engine_witness``, run where
    LOGIT_TOL alone does not hold); the streams equal, or (no MoE layers)
    split at near ties (``_split_check``) within the larger of LOGIT_TOL
    and WITNESS_FACTOR times the witness's max|d logit|: a MoE model's
    streams are counted (C11: capacity is per step, and the near-tie
    rule's teacher-forced prefill routes over the whole sequence), and
    one step of it held with the routing pinned (``tp_pinned_step``,
    layer by layer where FAMILIES says so); B1 launched (B4 iff the model
    has MLP layers, B5 once per attention layer and decode step paged,
    never dense), one decode-only step's launches, wall and collectives
    on the leader, and (MoE) every rank's capacity pick of a prefill
    equal (``ContinuousScheduler.rank_routes``). Returns (runs'
    launches, summary)."""
    import numpy as np
    import torch
    from repro_torch.distributed import tp as tp_lib
    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousScheduler

    spec = TP_FAMILIES
    prompts, gens, _ = serve.build_workload(
        cfg, spec["requests"], spec["prompt_len"], spec["gen_lens"],
        seed=SEED + 29)
    max_len = spec["prompt_len"] + max(spec["gen_lens"]) + 1
    mesh = tp_lib.replica_meshes(1, TP["tp"], ["cuda:0"] * TP["tp"])[0]
    kinds = cfg_kinds(cfg)
    n_attn = sum(k == "attn" for k, _ in kinds)
    has_mlp = any(f == "mlp" for _, f in kinds)
    has_moe = any(f == "moe" for _, f in kinds)
    forced = FAMILIES[name]["layer_forced"]
    runs, summary = {}, {"placement": {
        "attention": tp_lib.attention_split(cfg, TP["tp"]) and n_attn > 0,
        "ssm": tp_lib.ssm_split(cfg, TP["tp"]),
        "moe": tp_lib.moe_split(cfg, TP["tp"]) if has_moe else None}}
    for k, mode in enumerate(FAMILIES[name]["caches"]):
        kw = _family_cache_kw(mode)
        what = f"tp_families {name} {mode}"
        first_mode = k == 0
        ref = ContinuousScheduler(cfg, max_slots=spec["slots"],
                                  max_len=max_len, device="cuda",
                                  cuda_graph=False, **kw)
        ref.load(params)
        r_outs, _, r_first, _ = _tp_drive(ref, prompts, gens)
        r_routes = ref.rank_routes(prompts[:spec["slots"]]) \
            if has_moe and first_mode else None
        del ref
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        eng = ContinuousScheduler(cfg, max_slots=spec["slots"],
                                  max_len=max_len, cuda_graph=False,
                                  mesh=mesh, **kw)
        eng.load(params)
        t_load = time.perf_counter() - t0
        try:
            outs, metrics, first, launches, (per_step, step_ms, comm) = \
                _tp_family_drive(eng, prompts, gens, eng._group)
            drive_steps = eng.decode_steps
            routes = eng.rank_routes(prompts[:spec["slots"]]) \
                if has_moe and first_mode else None
            banks = bank_materialize_ms(eng.params, flush) \
                if first_mode else None
            peak = torch.cuda.max_memory_allocated()
        finally:
            eng.close()
        for i, (toks, g) in enumerate(zip(outs, gens)):
            if len(toks) != g or not ((toks >= 0)
                                      & (toks < cfg.vocab_size)).all():
                raise AssertionError(f"{what}: request {i}: {len(toks)} "
                                     f"tokens for a budget of {g}, or ids "
                                     f"out of range")
        if launches["ternary_gemm"] <= 0 or per_step["ternary_gemm"] <= 0:
            raise AssertionError(f"{what}: ternary_gemm not launched")
        if (launches["fused_mlp"] > 0) != has_mlp \
                or (per_step["fused_mlp"] > 0) != has_mlp:
            raise AssertionError(f"{what}: fused_mlp launched "
                                 f"{launches['fused_mlp']} times")
        want = n_attn * drive_steps if mode != "dense" else 0
        if launches["paged_decode_attention"] != want \
                or per_step["paged_decode_attention"] != (
                    n_attn if mode != "dense" else 0):
            raise AssertionError(
                f"{what}: paged_decode_attention launched "
                f"{launches['paged_decode_attention']} times (expected "
                f"{want}), {per_step['paged_decode_attention']} a step")
        live = [i for i in range(spec["slots"])
                if outs[i][0] == r_outs[i][0]]
        d = float((first[live].float() - r_first[live].float()).abs().max()
                  / r_first[live].float().abs().max())
        equal = sum(np.array_equal(a, b) for a, b in zip(r_outs, outs))
        # the witness runs where LOGIT_TOL alone does not hold the first
        # step, or where the streams of a model without MoE layers part
        wit = None
        if d > LOGIT_TOL or (equal < len(gens) and not has_moe):
            w_rel, w_abs, w_equal = tp_engine_witness(
                cfg, params, kw, max_len, prompts, gens, r_outs, r_first)
            wit = {"first_step_rel_d": w_rel, "first_step_max_d": w_abs,
                   "streams_equal": w_equal}
        bound = max(LOGIT_TOL, WITNESS_FACTOR * wit["first_step_rel_d"]) \
            if wit else LOGIT_TOL
        print(f"{what}: the first decode step lies {d:.4g} of max|logit| "
              f"from tp 1's (rows {live}); the one-ulp witness "
              f"{json.dumps(wit)} (bound {bound:.4g})", flush=True)
        if d > bound:
            raise AssertionError(f"{what}: the first decode step lies {d} "
                                 f"of max|logit| from tp 1's, above "
                                 f"{bound}")
        if has_moe:
            print(f"{what}: {equal}/{len(gens)} streams equal tp 1's "
                  f"(counted: a MoE layer's capacity is per step, C11)",
                  flush=True)
            splits = {}
        else:
            tol = max(LOGIT_TOL, WITNESS_FACTOR * wit["first_step_max_d"]) \
                if wit else LOGIT_TOL
            splits = streams_or_near_ties(what + " vs tp 1", cfg, params,
                                          prompts, r_outs, outs, tol=tol)
        if (has_moe or forced) and first_mode:
            summary["pinned_step"] = tp_pinned_step(
                f"tp_families {name} tp 2 vs tp 1, one decode step, "
                f"routing pinned", cfg, params, prompts[:spec["slots"]],
                max_len, forced)
        row = {"load_s": t_load, "tok_per_s": metrics["tok_per_s"],
               "tpot_p50_ms": metrics["latency"]["tpot_s"]["p50"] * 1e3,
               "decode_steps": metrics["decode_steps"],
               "first_step_logit_rel_d": d, "first_step_bound": bound,
               "witness": wit, "streams_equal": equal,
               "splits": len(splits),
               "rank_step_ms": step_ms, "launches_per_step": per_step,
               "collectives_per_step": comm,
               "bank_decode": banks, "leader_peak_gib": peak / 2**30}
        if routes is not None:
            picks = [sum(int(a.size) for a in r) for r in routes]
            if any(len(r) != len(routes[0]) or not all(
                    np.array_equal(a, b) for a, b in zip(r, routes[0]))
                    for r in routes[1:]):
                raise AssertionError(f"{what}: the ranks' MoE capacity "
                                     f"picks differ")
            row["routes"] = {
                "ranks_equal": True, "moe_layers": len(routes[0]),
                "picks_a_rank": picks[0],
                "equal_tp1": sum(np.array_equal(a, b) for a, b in zip(
                    routes[0], r_routes[0]))}
        print(f"{what}: " + json.dumps(row), flush=True)
        runs[what] = launches
        summary[mode] = row
    return runs, summary


def tp_family_kernel_rows(name, cfg, flush):
    """B1, B4 and B5 at one rank's shapes of ``name`` at tp 2 (the split
    SSM in_proj's column set, out_proj's and o's row shards in the f32
    form, the attention heads' column shards, the lm head's shard; B4 on
    the MLP's d_ff slice; B5 at the local heads over TP_FAMILIES' pages),
    at the decode M (slots) and the prefill M (slots x prompt length),
    each against its plain version, timed; rows ``"on_path": true``."""
    import torch
    from repro_torch.distributed import tp as tp_lib

    tp, spec = TP["tp"], TP_FAMILIES
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    ms = (spec["slots"], spec["slots"] * spec["prompt_len"])
    d, hd = cfg.d_model, cfg.head_dim
    kinds = cfg_kinds(cfg)
    shards = []
    if tp_lib.ssm_split(cfg, tp):
        n_in = (2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
                + cfg.ssm_heads)
        n_local = 2 * cfg.d_inner // tp + 2 * cfg.ssm_groups * cfg.ssm_state \
            + cfg.ssm_heads // tp
        shards += [(f"in_proj columns ({n_local} of {n_in})", d, n_local,
                    None), ("out_proj rows (f32)", cfg.d_inner, d, "k")]
    if any(k == "attn" for k, _ in kinds) and tp_lib.attention_split(cfg,
                                                                      tp):
        shards += [("q heads", d, cfg.num_heads * hd, "n"),
                   ("k/v heads", d, cfg.num_kv_heads * hd, "n"),
                   ("o rows (f32)", cfg.num_heads * hd, d, "k")]
    if not cfg.tie_embeddings:
        shards.append(("lm head shard", d, cfg.padded_vocab(), "n"))
    gemm = tp_gemm_rows(gen, shards, ms, flush, prefix=f"tp_families {name}")
    mlp = (tp_mlp_rows(gen, d, cfg.d_ff, ms, flush,
                       prefix=f"tp_families {name}")
           if any(f == "mlp" for _, f in kinds) else [])
    paged = []
    if "paged_bf16" in FAMILIES[name]["caches"] and any(
            k == "attn" for k, _ in kinds):
        max_len = spec["prompt_len"] + max(spec["gen_lens"]) + 1
        shape = dict(b=spec["slots"], h=cfg.num_heads // tp,
                     kv=cfg.num_kv_heads // tp, hd=hd,
                     t=-(-max_len // PAGE_SIZE))
        inputs = _paged_inputs(gen, shape, lambda: torch.randint(
            spec["prompt_len"], max_len + 1, (shape["b"],), generator=gen,
            device="cuda", dtype=torch.int32))
        paged = paged_rows(f"tp_families {name} {shape['h']} heads", shape,
                           inputs, flush, subsets=([shape["b"] - 1],
                                                   [1, 0, 3, 2]),
                           on_path=True)
    out = {"ternary_gemm": gemm, "fused_mlp": mlp,
           "paged_decode_attention": paged}
    for rows in out.values():
        for r in rows:
            r.update(model=name, tp_family=True)
    return out


def tp_train_cut(name):
    """The first of TP_FAMILIES_TRAIN[name]'s cuts (deepest first, width
    last) whose reckoned card bytes fit TP_TRAIN_BUDGET_GIB. A first f32
    step holds 28 B a parameter at its peak (the state's params and both
    AdamW moments, the gradients, the new state): the one process's, whose
    state then waits on the host, and then the two ranks' over their
    shards, plus 28 B for each parameter the second rank holds again (the
    embedding table). Returns (overrides, params, GiB, the cuts passed
    over with why)."""
    from repro_torch.configs import get_config
    skipped = []
    for cut in TP_FAMILIES_TRAIN[name]:
        cfg = get_config(name, **cut)
        n = cfg.param_count()
        gib = 28 * (n + cfg.padded_vocab() * cfg.d_model) / 2**30
        if gib <= TP_TRAIN_BUDGET_GIB:
            return cut, n, gib, skipped
        skipped.append({"cut": cut, "params": n, "gib": round(gib, 1),
                        "why": f"28 B a parameter (the table twice) > "
                               f"{TP_TRAIN_BUDGET_GIB} GiB"})
    raise AssertionError(f"tp_families: no cut of {name} fits")


def tp_family_train_phase():
    """The training part of ``tp_families``: for each family, the model
    cut to fit (``tp_train_cut``), its first f32 QAT step from the seed's
    weights on one process, again on one process with every parameter
    moved one ulp (the witness, read against the first), and at tp 2
    (``launch.train.DistTrainer``, two ranks sharing cuda:0 over gloo);
    rank 0's shards (params, AdamW moments) and the step's loss and grad
    norm (over both ranks) held to the one process's by TP_TRAIN_RULE
    (STEP_CHECK's rule, each bound at least WITNESS_FACTOR times the
    witness's reading); every rank's peak memory and the model group's
    collectives a step. Every family runs before a failure is raised.
    Returns the summary."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import tp as tp_lib
    from repro_torch.launch import train
    from repro_torch.optim.optimizers import tree_map

    out, failed, trainer = {}, {}, None
    lr, total = TRAIN_DIST["lr"], TRAIN_DIST["schedule_steps"]
    batch, seq = STEP_CHECK["batch"], STEP_CHECK["seq"]

    def to_cpu(tree):
        return tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor)
                        else t, tree)

    try:
        for name in TP_FAMILIES_TRAIN:
            t0 = time.perf_counter()
            cut, n, gib, skipped = tp_train_cut(name)
            cfg = get_config(name, quantization="ternary", **cut)
            cfg32 = dataclasses.replace(cfg, dtype="float32", grad_accum=1)
            if trainer is None:
                trainer = train.DistTrainer(
                    cfg32, data_parallel=1, model_parallel=TP["tp"],
                    batch=batch, seq=seq, lr=lr, total_steps=total,
                    device="cuda", timeout_s=TRAIN_DIST["timeout_s"],
                    timed=True)
            else:
                trainer.build(cfg32, batch=batch, seq=seq, lr=lr,
                              total_steps=total, timed=True)
            _, data, step, init = train.build(cfg32, batch, seq, lr, total,
                                              "cuda")
            state = init(SEED)
            batch0 = data.sharded_batch(0, device="cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ref = step(state["params"], state["opt"], batch0)
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t1
            ref_peak = torch.cuda.max_memory_allocated()
            ref = to_cpu(list(ref))
            torch.cuda.empty_cache()
            gen = torch.Generator(device="cuda").manual_seed(SEED + 47)
            moved = tree_map(lambda t: _one_ulp(t, gen)
                             if t.is_floating_point() else t,
                             state["params"])
            del state["params"]
            wit = step(moved, state["opt"], batch0)
            del state, moved
            label = f"tp_families train {name} first step"
            seen = hold_first_step(label, "witness", "one process", wit,
                                   ref, floor=TP_TRAIN_RULE["floor"],
                                   device="cuda", bounds={}, signs=True)
            del wit
            bounds = {k: max(STEP_CHECK["rtol"], WITNESS_FACTOR * seen[k])
                      for k in FIRST_STEP_KEYS}
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            trainer.init(SEED)
            t1 = time.perf_counter()
            met = trainer.step(0)
            tp_s = time.perf_counter() - t1
            comm = trainer.last_comm
            me = trainer.me
            ref_opt = dict(ref[1], **{k: tp_lib.shard_tree(
                ref[1][k], me.marks, me.m, TP["tp"]) for k in ("m", "v")})
            try:
                held = hold_first_step(
                    label, "tp 2 rank 0", "one process",
                    (me.params, me.opt, met),
                    (tp_lib.shard_tree(ref[0], me.marks, me.m, TP["tp"]),
                     ref_opt, ref[2]), floor=TP_TRAIN_RULE["floor"],
                    device="cuda", bounds=bounds, signs=True)
            except AssertionError as e:
                held = {"failed": str(e)}
                failed[name] = str(e)
            del ref, ref_opt
            reports = trainer.report()
            train.check_replicas(reports)
            kinds = cfg_kinds(cfg)
            row = {"cut": cut, "params": n, "reckoned_gib": round(gib, 1),
                   "passed_over": skipped,
                   "layers": {"attn": sum(k == "attn" for k, _ in kinds),
                              "ssm": sum(k == "ssm" for k, _ in kinds),
                              "moe": sum(f == "moe" for _, f in kinds),
                              "mlp": sum(f == "mlp" for _, f in kinds),
                              "enc": cfg.enc_layers},
                   "placement": {"ssm": tp_lib.ssm_split(cfg, TP["tp"]),
                                 "moe": tp_lib.moe_split(cfg, TP["tp"]),
                                 "attention": tp_lib.attention_split(
                                     cfg, TP["tp"])},
                   "first_step": held, "witness": seen, "bounds": bounds,
                   "one_process_step_s": one_s,
                   "one_process_peak_gib": ref_peak / 2**30,
                   "tp2_step_s": tp_s, "collectives_a_step": comm,
                   "peak_gib_a_rank": [r["peak_bytes"] / 2**30
                                       for r in reports],
                   "seconds": time.perf_counter() - t0}
            print(f"tp_families train {name}: " + json.dumps(row),
                  flush=True)
            out[name] = row
            torch.cuda.empty_cache()
    finally:
        if trainer is not None:
            trainer.close()
    if failed:
        raise AssertionError(f"tp_families train: {json.dumps(failed)}")
    return out


def tp_families_phase(flush, built=None):
    """Tensor parallelism for the MoE, SSM, hybrid, encoder-decoder and
    VLM families on this card (module docstring, ``tp_families``): each
    FAMILIES model (``built``: name -> (cfg, packed params) from the
    families phase, else built here) served at tp 2 against tp 1
    (``tp_family_serve``), its kernels at tp 2's per-shard shapes, then
    the training part (``tp_family_train_phase``). Prints the
    ``tp_families summary:`` line. Returns (kernel rows by name, runs'
    launches)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    rows = {"ternary_gemm": [], "fused_mlp": [],
            "paged_decode_attention": []}
    runs, summary = {}, {}
    for name, spec in FAMILIES.items():
        t1 = time.perf_counter()
        if built is not None and name in built:
            cfg, params = built.pop(name)
        else:
            cfg = get_config(name, quantization="ternary",
                             **spec["overrides"])
            cfg, params = serve.build_params(cfg, SEED, "cuda", packed=True)
        fam_runs, summary[name] = tp_family_serve(name, cfg, params, flush)
        del params
        torch.cuda.empty_cache()
        for k, v in tp_family_kernel_rows(name, cfg, flush).items():
            rows[k] += v
        runs.update(fam_runs)
        summary[name]["seconds"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    summary["train"] = tp_family_train_phase()
    summary["train_s"] = time.perf_counter() - t1
    summary["seconds"] = time.perf_counter() - t0
    print("tp_families summary: " + json.dumps(summary), flush=True)
    print(f"tp_families phase took {summary['seconds']:.1f}s", flush=True)
    return rows, runs


def _frontend_batch(prompts, extras):
    """The prefill batch of ``prompts`` and their frontend rows, on the
    card."""
    import torch
    batch = {"tokens": torch.as_tensor(prompts, device="cuda")}
    for k, v in extras.items():
        batch[k] = torch.as_tensor(v, device="cuda")
    return batch


def frontend_static_run(name, cfg, params, prompts, gens, extras, max_len,
                        batch):
    """Drain the workload through the static server on the card (the
    continuous engine refuses these families); the launch counters set to
    0 just before the run and read just after. Checks every request's
    budget of in-range tokens, B1 and B4 launched, B5 never, and B6
    ``enc_layers`` times a prefill under ``attn_impl="pallas"`` (the
    encoder's non-causal attention; serving's decoder attends its cache
    view, never B6), else never."""
    from repro_torch.launch import serve

    label = f"frontends {name} {cfg.attn_impl}"
    server = serve.BatchedServer(cfg, max_len, "cuda")
    server.load(params)
    _zero_counts()
    outs, metrics = serve.run_static(server, prompts, gens, batch, extras)
    launches = _read_counts()
    print(f"{label} static metrics: {json.dumps(metrics)}", flush=True)
    print(f"{label} launches: {json.dumps(launches)}", flush=True)
    if metrics["drained"] != len(gens):
        raise AssertionError(f"{label}: drained {metrics['drained']} of "
                             f"{len(gens)}")
    for i, (toks, g) in enumerate(zip(outs, gens)):
        if len(toks) != g or not ((toks >= 0)
                                  & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{label}: request {i}: {len(toks)} tokens "
                                 f"for a budget of {g}, or ids out of range")
    prefills = -(-len(gens) // batch)
    want = {"ternary_gemm": None, "fused_mlp": None,
            "paged_decode_attention": 0,
            "flash_attention": (cfg.enc_layers * prefills
                                if cfg.attn_impl == "pallas" else 0)}
    for kernel, n in want.items():
        if (n is None and launches[kernel] <= 0) or (
                n is not None and launches[kernel] != n):
            raise AssertionError(f"{label}: {kernel} launched "
                                 f"{launches[kernel]} times, expected "
                                 f"{'some' if n is None else n}")
    return outs, metrics, launches


def cross_kv_profile(model, params, cache, tok, flush):
    """One decode step under ``torch.profiler`` with every cross-attention
    K/V projection (B1 over ``enc_out``, M = B x S_enc) inside a
    ``cross_kv`` range: the step's device time (its kernels summed), the
    ranges' device time (the device-side spans of the ``cross_kv``
    annotations) and its share, the top device ops; and the same share
    from CUDA events (the step against its cross K/V GEMMs alone on the
    same inputs)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    from repro_torch.kernels import ops
    from repro_torch.models import layers as layers_lib

    cross = {id(lay["cross"][n]) for lay in params["layers"]
             for n in ("k", "v")}
    orig = layers_lib.linear_apply

    def linear_apply(p, x, cfg):
        if id(p) in cross:
            with record_function("cross_kv"):
                return orig(p, x, cfg)
        return orig(p, x, cfg)

    def step():
        with torch.no_grad(), ops.serving_phase("decode"):
            model.decode_step(params, cache, tok)

    layers_lib.linear_apply = linear_apply
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            step()
            torch.cuda.synchronize()
            prof.step()
            step()
            torch.cuda.synchronize()
    finally:
        layers_lib.linear_apply = orig
    events = prof.events()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    spans = [e for e in on_device if e.name == "cross_kv"]
    kernels = [e for e in on_device if e.name != "cross_kv"
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("ProfilerStep")]
    if not kernels:
        raise AssertionError("cross_kv_profile: the trace holds no device "
                             "events")
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    step_us = sum(t for _, t in by_name.values())
    kv_us = sum(e.time_range.elapsed_us() for e in spans)
    enc_out = cache["enc_out"]
    with torch.no_grad(), ops.serving_phase("decode"):
        step_ms = cuda_ms(step, 3, flush)
        kv_ms = cuda_ms(lambda: [orig(lay["cross"][n], enc_out, model.cfg)
                                 for lay in params["layers"]
                                 for n in ("k", "v")], 3, flush)
    return {"step_device_us": round(step_us, 1),
            "kernels": len(kernels),
            "cross_kv_spans": len(spans),
            "cross_kv_device_us": round(kv_us, 1),
            "cross_kv_share": round(kv_us / step_us, 4),
            "top_device_ops": [
                {"name": name[:80], "n": n, "us": round(t, 1)}
                for name, (n, t) in sorted(by_name.items(),
                                           key=lambda kv: -kv[1][1])[:6]],
            "step_ms_events": step_ms, "cross_kv_ms_events": kv_ms,
            "cross_kv_share_events": round(kv_ms / step_ms, 4)}


def frontend_step_readings(name, cfg, params, prompts, extras, max_len,
                           flush):
    """One batch's prefill and decode steps on the card: the launches of a
    prefill and of a decode step (counters zeroed before each), the
    prefill's host wall and the encoder's share of it, the decode step's
    p50 over FRONTEND_STEPS steps, and for an encoder-decoder the cross
    K/V GEMMs' share of a step (``cross_kv_profile``)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import LM

    model = LM(cfg, "cuda")
    batch = _frontend_batch(prompts, extras)
    out = {}
    with torch.no_grad():
        _zero_counts()
        with ops.serving_phase("prefill"):
            cache, logits = model.prefill(params, batch, max_len)
        torch.cuda.synchronize()
        out["prefill_launches"] = _read_counts()
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        _zero_counts()
        with ops.serving_phase("decode"):
            model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        out["decode_step_launches"] = _read_counts()
        with ops.serving_phase("prefill"):
            out["prefill_ms"] = _mean_wall(
                lambda: model.prefill(params, batch, max_len), 2) * 1e3
            if cfg.is_encdec:
                enc = batch["enc_embeds"].to(torch.bfloat16)
                out["encoder_ms"] = _mean_wall(
                    lambda: model._run_encoder(params, enc), 2) * 1e3
                out["encoder_share"] = out["encoder_ms"] / out["prefill_ms"]
        walls = []
        with ops.serving_phase("decode"):
            for _ in range(FRONTEND_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = model.decode_step(params, cache, tok)
                tok = logits.argmax(-1).to(torch.int32)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        out["decode_step_p50_ms"] = float(np.percentile(walls, 50))
        if cfg.is_encdec:
            out["cross_kv"] = cross_kv_profile(model, params, cache, tok,
                                               flush)
    print(f"frontends {name} {cfg.attn_impl}: one batch's steps "
          + json.dumps(out), flush=True)
    return out


def flash_row(gen, bh, s, hd, causal, flush):
    """B6 against its plain version at (BH, S, hd), timed beside SDPA's
    fastest backend (rows as ``flash_kernel_phase``'s)."""
    import torch
    from repro_torch.kernels import flash_attention as flash_lib

    q, k, v = (torch.randn(bh, s, hd, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    label = f"flash_attention BH={bh} S={s} hd={hd} causal={causal}"
    err = check_close(label, flash_lib.flash_attention_cuda(
        q, k, v, causal=causal), flash_lib.flash_attention_ref(
            q, k, v, causal=causal))
    iters = 20
    sdpa = _sdpa_ms(q[None], k[None], v[None], causal, iters, flush)
    fastest = min((n for n in sdpa if sdpa[n] is not None), key=sdpa.get)
    row = {"bh": bh, "s": s, "hd": hd, "causal": causal,
           "max_abs_err": err,
           "ms": cuda_ms(lambda: flash_lib.flash_attention(
               q, k, v, causal=causal), iters, flush),
           "device_ms": cuda_ms(lambda: flash_lib.flash_attention_cuda(
               q, k, v, causal=causal), iters, flush, spin=True),
           "plain_ms": cuda_ms(lambda: flash_lib.flash_attention_ref(
               q, k, v, causal=causal), iters, flush),
           "library_ms": sdpa[fastest], "library": f"sdpa {fastest}",
           "sdpa_ms": sdpa}
    nbytes = 4 * bh * s * hd * 2
    ops_needed = (2.0 if causal else 4.0) * bh * s * s * hd
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops_needed)
    print(f"{label}: " + json.dumps(row), flush=True)
    return row


def frontend_kernel_rows(name, cfg, spec, flush):
    """seamless's new kernel shapes against their plain versions, timed
    (rows with the model's name): B1 at the cross K/V projections (M =
    batch x S_enc, K = N = d, with a bias) under "decode", and at the lm
    head's ragged N (padded vocabulary 256208 = 64 x 4003 + 16) at M 8
    and 1024; B4 with biases at M 8 and 1024; B6 non-causal at the
    encoder's (B x H, S_enc, hd)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    d, b = cfg.d_model, spec["batch"]
    m_enc = b * cfg.frontend_seq
    rows = {"ternary_gemm": [], "fused_mlp": [], "flash_attention": []}
    for what, m, n, phase, bias in (
            ("cross_kv", m_enc, cfg.num_kv_heads * cfg.head_dim, "decode",
             cfg.use_bias),
            ("lm_head", b, cfg.padded_vocab(), "decode", False),
            ("lm_head", 1024, cfg.padded_vocab(), "prefill", False)):
        row = gemm_row(gen, m, d, n, phase, flush, bias=bias)
        rows["ternary_gemm"].append(dict(row, model=name, proj=what))
    for m, phase in ((b, "decode"), (1024, "prefill")):
        row = mlp_row(gen, m, d, cfg.d_ff, d, phase, flush,
                      bias=cfg.use_bias)
        rows["fused_mlp"].append(dict(row, model=name))
    row = flash_row(gen, b * cfg.num_heads, cfg.frontend_seq, cfg.head_dim,
                    False, flush)
    rows["flash_attention"].append(dict(row, model=name))
    return rows


def frontend_phase(name, spec, flush):
    """One model of FRONTENDS, ternarized and packed layer by layer as it
    is drawn, served by the static server under attn_impl "flash" and
    "pallas"; then the checks of ``frontends_phase``. Returns (kernel
    rows, runs' launches, summary)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = get_config(name, quantization="ternary", **spec["overrides"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = serve.build_params(cfg, SEED, "cuda", packed=True)
    torch.cuda.synchronize()
    summary = {"init_pack_s": round(time.perf_counter() - t0, 2)}
    print(f"frontends {name}: init+pack {cfg.num_layers} decoder and "
          f"{cfg.enc_layers} encoder layers (d {cfg.d_model}, ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}): "
          f"{serve.count_packed(params)} packed linears in "
          f"{summary['init_pack_s']}s", flush=True)
    prompts, gens, extras = serve.build_workload(
        cfg, spec["requests"], spec["prompt_len"], spec["gen_lens"],
        seed=SEED)
    front = cfg.frontend_seq if cfg.family == "vlm" else 0
    max_len = prompts.shape[1] + max(gens) + 1 + front
    b = spec["batch"]
    first = {k: v[:b] for k, v in extras.items()}
    summary.update(text_len=int(prompts.shape[1]),
                   frontend_rows=cfg.frontend_seq, max_len=max_len)
    outs, runs, cfgs = {}, {}, {}
    for impl in ("flash", "pallas"):
        cfgs[impl] = c = dataclasses.replace(cfg, attn_impl=impl)
        plain = family_plain_check(name, c, params, prompts[:b], max_len,
                                   False, first, tag=f"frontends {impl}")
        outs[impl], metrics, runs[f"frontends {name} {impl}"] = \
            frontend_static_run(name, c, params, prompts, gens, extras,
                                max_len, b)
        summary[impl] = dict(
            {k: metrics[k] for k in ("tok_per_s", "wall_s",
                                     "decode_steps")},
            plain_check=plain,
            **frontend_step_readings(name, c, params, prompts[:b], first,
                                     max_len, flush))
    summary["pallas_vs_flash_splits"] = streams_or_near_ties(
        f"frontends {name} pallas vs flash", cfgs["pallas"], params,
        prompts, outs["flash"], outs["pallas"], extras)
    summary["peak_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 2)
    del params
    torch.cuda.empty_cache()
    rows = (frontend_kernel_rows(name, cfg, spec, flush) if cfg.is_encdec
            else {})
    return rows, runs, summary


def _train_steps(cfg, seq, steps, ckpt):
    """``steps`` QAT steps of ``cfg`` on the card, batch 2: with ``ckpt``
    through ``train.make_supervisor`` (``train.main``'s loop, whose history
    holds the grad norms; its last step checkpoints into a temporary
    directory, removed after), else through ``train.build``'s data and
    train step alone (the same step the supervisor runs, no checkpoint).
    Returns (history of (step, metrics), per-step seconds)."""
    import torch
    from repro_torch.launch import train

    if not ckpt:
        _, data, train_step, init_state = train.build(
            cfg, 2, seq, 3e-4, steps, "cuda")
        state, history, t_hist = init_state(SEED), [], []
        for step in range(steps):
            t0 = time.perf_counter()
            params, opt, metrics = train_step(
                state["params"], state["opt"],
                data.sharded_batch(step, device="cuda"))
            state = {"params": params, "opt": opt}
            history.append((step, {k: float(v)
                                   for k, v in metrics.items()}))
            t_hist.append(time.perf_counter() - t0)
        return history, t_hist
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_frontend_train_")
    try:
        sup, t_hist = train.make_supervisor(
            cfg, batch=2, seq=seq, lr=3e-4, steps=steps, ckpt_dir=ckpt_dir,
            ckpt_every=100, seed=SEED, device="cuda", log_every=100)
        _, history = sup.run(steps)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    return history, t_hist


def frontend_train_check():
    """FRONTEND_TRAIN: three QAT steps of each model on the card, batch 2
    with their frontend rows (``_train_steps``: seamless through the
    supervisor with its checkpoint; internvl2's 27 GB of parameters and
    moments are not checkpointed, which would take ~60 s); the loss and
    grad norm of every step finite."""
    import math
    import torch
    from repro_torch.configs import get_config

    out = {}
    for name, spec in FRONTEND_TRAIN.items():
        over = {k: v for k, v in spec.items()
                if k not in ("seq", "checkpoint")}
        cfg = get_config(name, quantization="ternary", grad_accum=1, **over)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        history, t_hist = _train_steps(cfg, spec["seq"], 3,
                                       spec["checkpoint"])
        row = {"layers": [cfg.num_layers, cfg.enc_layers],
               "checkpoint": spec["checkpoint"],
               "vocab": cfg.vocab_size, "seq": spec["seq"],
               "loss": [m["loss"] for _, m in history],
               "grad_norm": [m["grad_norm"] for _, m in history],
               "step_s": [round(t, 3) for t in t_hist],
               "wall_s": round(time.perf_counter() - t0, 1),
               "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30,
                                 2)}
        print(f"frontends train {name}: " + json.dumps(row), flush=True)
        if len(history) != 3 or not all(
                math.isfinite(x) for x in row["loss"] + row["grad_norm"]):
            raise AssertionError(f"frontends train {name}: {len(history)} "
                                 f"steps, loss {row['loss']}, grad norm "
                                 f"{row['grad_norm']}")
        out[name] = row
        torch.cuda.empty_cache()
    return out


def frontends_phase(flush):
    """The encoder-decoder and VLM families on the card (FRONTENDS):
    seamless-m4t-large-v2 whole and internvl2-76b at full width with 4
    of its 80 layers, each drawn, packed and served by the static server
    (batch 8, each request with its frontend rows) under
    attn_impl="flash" and "pallas". Each: the prefill's and one decode
    step's logits through the kernels against the plain path on the card
    (``family_plain_check``: within LOGIT_TOL, the free-running path
    within WITNESS_FACTOR of the one-ulp witness; under "pallas" the
    plain path attends blockwise where the kernels run B6); every budget of
    in-range tokens, B1 and B4 launched, B6 ``enc_layers`` times a
    prefill under "pallas" and never under "flash"; the "pallas" streams
    equal the "flash" ones or split at near ties; the launches of one
    prefill and one decode step, the prefill's wall and encoder share,
    the decode step's p50 and the cross K/V GEMMs' share of it. Then
    seamless's new kernel shapes (``frontend_kernel_rows``) and the train
    check (``frontend_train_check``). Prints the ``frontends summary:``
    line; returns (kernel rows, runs' launches)."""
    rows = {"ternary_gemm": [], "fused_mlp": [], "flash_attention": []}
    runs, summary = {}, {}
    for name, spec in FRONTENDS.items():
        t0 = time.perf_counter()
        model_rows, model_runs, summary[name] = frontend_phase(name, spec,
                                                               flush)
        summary[name]["phase_s"] = round(time.perf_counter() - t0, 1)
        runs.update(model_runs)
        for k, v in model_rows.items():
            rows[k] += v
    t0 = time.perf_counter()
    summary["train"] = frontend_train_check()
    summary["train_s"] = round(time.perf_counter() - t0, 1)
    print("frontends summary: " + json.dumps(summary), flush=True)
    return rows, runs


def _fixed_tuner(path):
    """A tuner whose one candidate at every key is ``FIXED_TILE``'s tile
    for the key's phase (outside one, M <= 16 decode-shaped): the plans
    the port made before the tuner."""
    from repro_torch.kernels import autotune

    class FixedTiles(autotune.Autotuner):
        def candidates(self, m, k, n, fixed_n=None, fixed_k=None,
                       phase=None, impl="dense"):
            bm, bn = FIXED_TILE[phase or ("decode" if m <= 16
                                          else "prefill")]
            return [autotune.BlockConfig(bm, fixed_n or bn, fixed_k or 64)]

    return FixedTiles(path=path, mode="model")


@contextlib.contextmanager
def _with_tuner(tuner):
    """``tuner`` as the process-wide tuner in this scope (the ops' plan
    memos key on it, so plans follow it)."""
    from repro_torch.kernels import autotune
    saved = autotune._GLOBAL
    autotune._GLOBAL = tuner
    try:
        yield tuner
    finally:
        autotune._GLOBAL = saved


def _engine_plan_keys(cfg, params, max_len):
    """The GEMM keys (k, n, m, phase) and fused keys (k, ff, n, m, phase)
    that load() plans on the card for the served model, whole-prompt,
    chunked and speculative (one M per tuner bucket: the first planned)."""
    from repro_torch.kernels import autotune
    from repro_torch.serving import ContinuousScheduler, SchedConfig
    gemm, fused = {}, {}
    for kw in ({}, dict(sched=SchedConfig(chunk_tokens=CHUNK["tokens"])),
               dict(spec=_spec_config("layer_skip"))):
        engine = ContinuousScheduler(
            cfg, max_slots=SERVE["slots"],
            max_len=max_len + (SPEC["k"] if "spec" in kw else 0),
            device="cuda", **kw)
        engine._plan(params)
        for (_, m, phase), p in engine.gemm_plans.items():
            gemm.setdefault((phase, p.k, p.n, autotune._pow2_bucket(m)), m)
        for (_, m, phase), p in engine.fused_plans.items():
            fused.setdefault((phase, p.k, p.ff, p.n,
                              autotune._pow2_bucket(m)), m)
        del engine
    order = {ph: i for i, ph in enumerate(("decode", "verify", "chunk",
                                           "prefill"))}
    return ([(k, n, m, ph) for (ph, k, n, _), m in
             sorted(gemm.items(), key=lambda e: (order[e[0][0]], e[0][1:]))],
            [(k, ff, n, m, ph) for (ph, k, ff, n, _), m in
             sorted(fused.items(), key=lambda e: (order[e[0][0]],
                                                  e[0][1:]))])


def _timed_tiles(label, call, tiles, fixed, flush):
    """Each tile's output bitwise equal to the fixed tile's, and each
    tile's card time (``cuda_ms`` with the spin: the card alone)."""
    import torch
    ref = call(fixed)
    ms = {}
    for t in dict.fromkeys(list(tiles) + [fixed]):
        y = call(t)
        torch.cuda.synchronize()
        if not torch.equal(y, ref):
            d = float((y.float() - ref.float()).abs().max())
            raise AssertionError(f"tune {label}: tile {t} differs from the "
                                 f"fixed tile {fixed}, max |d| {d}")
        ms[t] = cuda_ms(lambda t=t: call(t), TUNE["iters"], flush, spin=True)
    return ms


def _slack_check(label, call, ms, model, fixed, flush):
    """The model's pick within ``TUNE["slack"]`` of the fixed tile's card
    time: when the first reading says otherwise, both are timed again in
    turns and the best of each decides."""
    if model == fixed or ms[model] <= TUNE["slack"] * ms[fixed]:
        return ms[model] / ms[fixed]
    best = {model: ms[model], fixed: ms[fixed]}
    for _ in range(TUNE["retimes"]):
        for t in (model, fixed):
            best[t] = min(best[t], cuda_ms(lambda t=t: call(t), TUNE["iters"],
                                           flush, spin=True))
    ratio = best[model] / best[fixed]
    if ratio > TUNE["slack"]:
        raise AssertionError(f"tune {label}: the model's tile {model} takes "
                             f"{best[model]:.5f} ms, {ratio:.3f}x the fixed "
                             f"tile {fixed}'s {best[fixed]:.5f} ms")
    return ratio


def _tune_gemm(tuners, gen, w, m, phase, flush, label):
    """One B1 key: every candidate bitwise equal to the fixed tile and
    timed, the measured tuner's winner, the model's pick with no cache
    file, cuBLAS on the decoded weights and the bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_gemm as gemm_lib
    k, n = w.k, w.n
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)

    def call(t):
        return gemm_lib.ternary_gemm_cuda(x, w.packed, w.scale, w.bias, n=n,
                                          block_m=t[0], block_n=t[1])

    cands = [(c.block_m, c.block_n) for c in tuners["measured"].candidates(
        m, k, n, phase=phase, impl="dense")]
    fixed = FIXED_TILE[phase]
    ms = _timed_tiles(label, call, cands, fixed, flush)
    won = tuners["measured"].lookup(m, k, n, impl="dense", phase=phase,
                                    run=lambda c: call((c.block_m,
                                                        c.block_n)))
    with _with_tuner(tuners["model"]):
        plan = ops.ternary_gemm_plan(w, m, phase=phase)
    model = (plan.block_m, plan.block_n)
    ratio = _slack_check(label, call, ms, model, fixed, flush)
    w_eff = w.materialize(torch.float32, with_scale=True).to(torch.bfloat16)
    nbytes = m * k * 2 + w.packed.numel() * 4 + n * 4 + m * n * 2
    b_ms, b_by = bound_ms(nbytes, 2.0 * m * w.nnz)
    row = {"key": label, "kernel": "B1", "m": m, "k": k, "n": n,
           "phase": phase, "fixed": list(fixed), "fixed_ms": ms[fixed],
           "measured": [won.block_m, won.block_n],
           "measured_ms": ms[(won.block_m, won.block_n)],
           "best": list(min(ms, key=ms.get)), "best_ms": min(ms.values()),
           "model": list(model), "model_ms": ms[model],
           "model_vs_fixed": ratio,
           "cublas_ms": cuda_ms(lambda: torch.matmul(x, w_eff),
                                TUNE["iters"], flush, spin=True),
           "bound_ms": b_ms, "bound_by": b_by,
           "candidates_ms": {f"{a}x{b}": v for (a, b), v in ms.items()}}
    print(f"tune {label}: " + json.dumps(row), flush=True)
    return row


def _tune_fused(tuners, gen, blk, m, phase, flush, label):
    """One B4 key: both tiles bitwise equal to the fixed one and timed; the
    measured tuner's two sub-keys of the fused entry timed on B4 through
    the tile each ``block_m`` names, then its plan; the model's plan; the
    cuBLAS SwiGLU chain and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_mlp as fused_lib
    from repro_torch.kernels import ops
    wi, wg, wo = blk
    x = torch.randn(m, wi.k, generator=gen, device="cuda").to(torch.bfloat16)
    args = (wi.packed, wo.packed, wg.packed, wi.scale, None, wg.scale, None,
            wo.scale, None)

    def call(t):
        return fused_lib.fused_mlp_cuda(x, *args, block_m=t[0], strip=t[1])

    fixed = FIXED_TILE[phase]
    ms = _timed_tiles(label, call, fused_lib.TILES, fixed, flush)
    tuner = tuners["measured"]

    def run(c):
        return call(fused_lib.tile_for(c.block_m))

    with _with_tuner(tuner):
        for w in (wi, wo):
            p = ops.ternary_gemm_plan(w, m, phase=phase)
            tuner.lookup(m, w.k, w.n, sparsity=w.occupancy(), impl="skip",
                         fixed_n=p.block_n, fixed_k=p.block_k, phase=phase,
                         run=run)
        won = ops.fused_mlp_plan(wi, wo, wg, m=m, phase=phase)
    with _with_tuner(tuners["model"]):
        plan = ops.fused_mlp_plan(wi, wo, wg, m=m, phase=phase)
    model = (plan.block_m, plan.block_n1)
    ratio = _slack_check(label, call, ms, model, fixed, flush)
    ei, eg, eo = (c.materialize(torch.float32, with_scale=True).to(
        torch.bfloat16) for c in (wi, wg, wo))
    nbytes = (m * wi.k * 2 + (wi.packed.numel() + wg.packed.numel()
                              + wo.packed.numel()) * 4
              + (2 * wi.n + wo.n) * 4 + m * wo.n * 2)
    b_ms, b_by = bound_ms(nbytes, 2.0 * m * (wi.nnz + wg.nnz + wo.nnz))
    row = {"key": label, "kernel": "B4", "m": m, "k": wi.k, "ff": wi.n,
           "n": wo.n, "phase": phase, "fixed": list(fixed),
           "fixed_ms": ms[fixed],
           "measured": [won.block_m, won.block_n1],
           "measured_ms": ms[(won.block_m, won.block_n1)],
           "best": list(min(ms, key=ms.get)), "best_ms": min(ms.values()),
           "model": list(model), "model_ms": ms[model],
           "model_vs_fixed": ratio,
           "cublas_ms": cuda_ms(lambda: (F.silu(x @ eg) * (x @ ei)) @ eo,
                                TUNE["iters"], flush, spin=True),
           "bound_ms": b_ms, "bound_by": b_by,
           "candidates_ms": {f"{a}x{b}": v for (a, b), v in ms.items()}}
    print(f"tune {label}: " + json.dumps(row), flush=True)
    return row


def _tune_side(tuners, gen, shapes, flush):
    """B2, B3 (a ``tiled`` pack of each served shape) and B7 (a
    ``bitplane`` pack, both modes) at one M a phase: every candidate tile
    bitwise equal to the phase's fixed tile and timed, each key measured
    into the tuner, beside the model's pick."""
    import numpy as np
    import torch
    from repro_torch.core import formats, weights
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_gemm as gemm_lib
    from repro_torch.kernels import ternary_gemm_bitplane as bitplane_lib
    rows = []
    for i, (k, n) in enumerate(shapes):
        scale = torch.rand(n, generator=gen, device="cuda") + 0.5
        wt = _tiled_pack(SEED + 60 + i, k, n, TUNE["sparsity"], scale)
        t = formats.random_ternary(np.random.default_rng(SEED + 70 + i), k,
                                   n, 0.5)
        bp = weights.pack(torch.from_numpy(t).cuda(), "bitplane",
                          scale=scale)
        for phase, m in TUNE["side_ms"].items():
            x = torch.randn(m, k, generator=gen, device="cuda").to(
                torch.bfloat16)
            for impl, db in (("skip", False), ("skip_db", True)):
                def skip(tile, db=db):
                    return gemm_lib.ternary_gemm_skip_cuda(
                        x, wt.packed, wt.kt_indices, wt.kt_counts, wt.scale,
                        n=n, tile_k=wt.tile_k, tile_n=wt.tile_n,
                        block_m=tile[0], db=db)
                pins = dict(fixed_n=wt.tile_n, fixed_k=wt.tile_k,
                            phase=phase, impl=impl)
                cands = [(c.block_m, c.block_n) for c in
                         tuners["measured"].candidates(m, k, n, **pins)]
                fixed = (FIXED_TILE[phase][0], wt.tile_n)
                rows.append(_side_row(
                    tuners, f"{impl} {k}x{n} M {m} {phase}", skip, cands,
                    fixed, flush, lambda: ops.ternary_gemm_plan(
                        wt, m, impl=impl, phase=phase),
                    lambda run: tuners["measured"].lookup(
                        m, k, n, sparsity=wt.occupancy(), run=run, **pins)))
            for impl, fact in (("bitplane", False),
                               ("bitplane_factorized", True)):
                def b7(tile, fact=fact):
                    return bitplane_lib.ternary_gemm_bitplane_cuda(
                        x, bp.plus, bp.minus, bp.scale, factorized=fact,
                        block_m=tile[0], block_n=tile[1])
                rows.append(_side_row(
                    tuners, f"{impl} {k}x{n} M {m} {phase}", b7,
                    bitplane_lib.TILES, FIXED_TILE[phase], flush,
                    lambda: ops.ternary_gemm_plan(bp, m, impl=impl,
                                                  phase=phase),
                    lambda run: tuners["measured"].lookup(
                        m, k, n, impl=impl, phase=phase, run=run)))
    return rows


def _side_row(tuners, label, call, tiles, fixed, flush, plan, measure):
    ms = _timed_tiles(label, call, tiles, fixed, flush)
    won = measure(lambda c: call((c.block_m, c.block_n)))
    with _with_tuner(tuners["model"]):
        p = plan()
    row = {"key": label, "fixed": list(fixed), "fixed_ms": ms[fixed],
           "measured": [won.block_m, won.block_n],
           "model": [p.block_m, p.block_n],
           "candidates_ms": {f"{a}x{b}": v for (a, b), v in ms.items()}}
    print(f"tune {label}: " + json.dumps(row), flush=True)
    return row


def _tune_serving(cfg, params, prompts, gens, max_len, tuners):
    """The dense, paged bf16 and chunked workloads served under the fixed
    tiles, the model's plans (no cache file) and the measured cache: the
    model's and the measured streams and last decode step's logits
    bitwise equal to the fixed tiles'. Returns tok/s, TPOT and the decode
    step's p50 per (plans, workload)."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.obs import Tracer
    from repro_torch.serving import SchedConfig
    workloads = {"dense": {},
                 "paged_bf16": dict(cache="paged", page_size=PAGE_SIZE),
                 "chunked": dict(sched=SchedConfig(
                     chunk_tokens=CHUNK["tokens"]))}
    runs, out = {}, {}
    for name in ("fixed", "model", "measured"):
        with _with_tuner(tuners[name]):
            for label, kw in workloads.items():
                tracer = Tracer()
                engine = _engine(cfg, params, max_len, True, tracer, **kw)
                outs, metrics = serve.run_continuous(engine, prompts, gens)
                torch.cuda.synchronize()
                runs[(name, label)] = (outs, engine.last_logits.clone())
                spans = span_summary(tracer.to_dict()["traceEvents"])
                out[f"{name} {label}"] = {
                    "tok_per_s": metrics["tok_per_s"],
                    "tpot_p50_ms": metrics["latency"]["tpot_s"]["p50"] * 1e3,
                    "decode_step_p50_ms": spans["decode_step"]["p50_ms"]}
                del engine, tracer
    for label in workloads:
        ref_outs, ref_logits = runs[("fixed", label)]
        for name in ("model", "measured"):
            outs, logits = runs[(name, label)]
            same = [bool(np.array_equal(a, b))
                    for a, b in zip(ref_outs, outs)]
            if not all(same) or not torch.equal(logits, ref_logits):
                raise AssertionError(
                    f"tune serving {label}: {name} plans' streams equal on "
                    f"{sum(same)}/{len(same)}, last logits bitwise "
                    f"{bool(torch.equal(logits, ref_logits))}")
    print("tune serving: model and measured plans' streams and last "
          "logits bitwise equal to the fixed tiles' (dense, paged bf16, "
          "chunked); " + json.dumps(out), flush=True)
    return out


def tune_phase(cfg, params, prompts, gens, max_len, tune_out=None):
    """The block-shape tuner on the card. Every key the served engines'
    load() plans (B1 at q/k/v/o, gate/up, down and the lm head; B4's
    fused keys) and jamba's in_proj and lm head at M 8 and 1024: each
    candidate tile bitwise equal to the tile the phase took before the
    tuner and timed, ``lookup(..., run=...)`` in measure mode into a cache
    file in a temporary directory, the model's pick with no cache file
    (within ``TUNE["slack"]`` of the fixed tile's time), cuBLAS and the
    bound; B2, B3 and B7 at the served shapes the same way; then the
    served workloads under fixed, model and measured plans
    (``_tune_serving``). ``tune_out``: where to copy the measured cache."""
    import torch
    from repro_torch.kernels import autotune
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as d:
        tuners = {"measured": autotune.Autotuner(
                      path=str(Path(d) / "measured.json"), mode="measure"),
                  "model": autotune.Autotuner(
                      path=str(Path(d) / "model.json"), mode="model"),
                  "fixed": _fixed_tuner(str(Path(d) / "fixed.json"))}
        gemm_keys, fused_keys = _engine_plan_keys(cfg, params, max_len)
        weights_by_shape = {}
        rows = []
        for k, n, m, phase in gemm_keys:
            if (k, n) not in weights_by_shape:
                weights_by_shape[(k, n)] = _packed_weight(gen, k, n)
            rows.append(_tune_gemm(tuners, gen, weights_by_shape[(k, n)], m,
                                   phase, flush, f"B1 {k}x{n} M {m} {phase}"))
        blocks = {}
        for k, ff, n, m, phase in fused_keys:
            if (k, ff, n) not in blocks:
                blocks[(k, ff, n)] = (weights_by_shape[(k, ff)],
                                      _packed_weight(gen, k, ff),
                                      weights_by_shape[(ff, n)])
            rows.append(_tune_fused(tuners, gen, blocks[(k, ff, n)], m,
                                    phase, flush,
                                    f"B4 {k}x{ff}x{n} M {m} {phase}"))
        del weights_by_shape, blocks
        for k, n in TUNE["jamba"]:
            w = _packed_weight(gen, k, n)
            for m in TUNE["jamba_ms"]:
                phase = "decode" if m <= 16 else "prefill"
                rows.append(_tune_gemm(tuners, gen, w, m, phase, flush,
                                       f"B1 jamba {k}x{n} M {m} {phase}"))
            del w
        torch.cuda.empty_cache()
        served_shapes = sorted({(r["k"], r["n"]) for r in rows
                                if r["kernel"] == "B1"
                                and "jamba" not in r["key"]})
        side = _tune_side(tuners, gen, served_shapes, flush)
        del flush
        measured_keys = set(tuners["measured"].entries())
        serving = _tune_serving(cfg, params, prompts, gens, max_len, tuners)
        grown = sorted(set(tuners["measured"].entries()) - measured_keys)
        if tune_out:
            Path(tune_out).parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(tuners["measured"].path, tune_out)
    faster = [r for r in rows if r["measured_ms"] < r["fixed_ms"] / 1.05]
    summary = {
        "keys": len(rows), "side_keys": len(side),
        "model_is_fixed": sum(r["model"] == r["fixed"] for r in rows),
        "measured_is_fixed": sum(r["measured"] == r["fixed"] for r in rows),
        "worst_model_vs_fixed": max(r["model_vs_fixed"] for r in rows),
        "measured_beats_fixed_by_5pct": [
            {k: r[k] for k in ("key", "fixed", "fixed_ms", "measured",
                               "measured_ms", "cublas_ms")}
            for r in faster],
        "keys_planned_unmeasured_while_serving": grown,
        "serving": serving,
        "seconds": time.perf_counter() - t0}
    print("tune summary: " + json.dumps(summary), flush=True)
    return rows, side


def _tp_drive(engine, prompts, gens, waves=1):
    """Submit ``prompts`` (in ``waves`` equal waves, each drained before the
    next: a router's later wave meets the prefixes the first one cached),
    take the first step's decode logits (the first wave's prefill and one
    decode step), drain; the launch counters zeroed just before and read
    just after. Returns (streams, metrics of the last wave, the first
    step's logits, launches)."""
    import numpy as np
    _zero_counts()
    n = len(prompts)
    per = -(-n // waves)
    reqs, first, metrics = [], None, None
    for w in range(waves):
        reqs += [engine.submit(p, g) for p, g in
                 zip(prompts[w * per:(w + 1) * per],
                     gens[w * per:(w + 1) * per])]
        if first is None and hasattr(engine, "step"):
            engine.step()
            first = engine.last_logits.float().clone()
        metrics = engine.run()
    launches = _read_counts()
    return ([np.asarray(r.tokens, np.int32) for r in reqs], metrics, first,
            launches)


def _tp_check_run(label, cfg, outs, gens, launches, decode_steps):
    """Every budget of in-range tokens, B1 and B4 launched on the leader,
    and, paged (``decode_steps``: the leaders' decode steps, else None),
    B5 once per layer and decode step."""
    for i, (toks, g) in enumerate(zip(outs, gens)):
        if len(toks) != g or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{label}: request {i}: {len(toks)} tokens "
                                 f"for a budget of {g}, or ids out of range")
    for name in ("ternary_gemm", "fused_mlp"):
        if launches[name] <= 0:
            raise AssertionError(f"{label}: {name} kernel never launched")
    want = 0 if decode_steps is None else cfg.num_layers * decode_steps
    if launches["paged_decode_attention"] != want:
        raise AssertionError(f"{label}: paged_decode_attention launched "
                             f"{launches['paged_decode_attention']} times, "
                             f"expected {want}")


def tp_prefix_workload(cfg):
    """The router's workload: TP["requests"] prompts of SERVE's length,
    the even-numbered half sharing a TP["prefix_len"]-token prefix."""
    import numpy as np
    rng = np.random.default_rng(SEED + 27)
    n, plen = TP["requests"], SERVE["prompt_len"]
    prompts = rng.integers(0, cfg.vocab_size, size=(n, plen)).astype(
        np.int32)
    common = rng.integers(0, cfg.vocab_size, size=TP["prefix_len"])
    prompts[::2, :TP["prefix_len"]] = common
    gens = [int(g) for g in rng.choice(TP["gen_lens"], size=n)]
    return prompts, gens


def _allreduce_peer(store: str) -> int:
    """The second rank of ``tp_collectives``: join, then take part in the
    same sequence of collectives on cuda:0."""
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.distributed import tp as tp_lib
    group = tp_lib.Group.join(store, 1, 2, "gloo", 300.0)
    for shape, iters in TP["allreduce"]:
        t = torch.ones(shape, device="cuda")
        for _ in range(iters + 3):
            group.all_reduce(t)
    group.all_gather(torch.full((8, 16), 1.0, dtype=torch.bfloat16,
                                device="cuda"))
    torch.cuda.synchronize()
    return 0


def tp_collectives():
    """Two ranks on this card over gloo (a second process): one f32
    all-reduce and one bf16 all-gather of CUDA tensors checked, then the
    time of an f32 all-reduce of each TP["allreduce"] shape (the median of
    the iterations; host-bound gloo through host copies on one card, not
    NVLink and not tensor parallelism's speed) beside the plans' modelled
    collective bytes, 2 (tp - 1) / tp * m * n * 4."""
    import torch
    from repro_torch.distributed import tp as tp_lib
    workdir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    store = os.path.join(workdir, "store")
    peer = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--allreduce-peer", store])
    rows = []
    try:
        group = tp_lib.Group.join(store, 0, 2, "gloo", 300.0)
        for shape, iters in TP["allreduce"]:
            t = torch.full(shape, 2.0, device="cuda")
            got = group.all_reduce(t.clone())
            if got.device.type != "cuda" or not bool((got == 3.0).all()):
                raise AssertionError(f"gloo all-reduce of a CUDA tensor "
                                     f"{shape}: wrong sum or device")
            times = []
            for _ in range(iters + 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                group.all_reduce(t)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            times = sorted(times[2:])
            m, n = shape
            rows.append({"shape": list(shape), "dtype": "float32",
                         "backend": "gloo", "ranks_on_card": 2,
                         "ms_p50": times[len(times) // 2],
                         "ms_min": times[0],
                         "modelled_bytes": 2.0 * (2 - 1) / 2 * m * n * 4})
        got = group.all_gather(torch.zeros((8, 16), dtype=torch.bfloat16,
                                           device="cuda"))
        if tuple(got.shape) != (8, 32) or got.device.type != "cuda" or \
                not bool((got[:, :16] == 0).all() & (got[:, 16:] == 1).all()):
            raise AssertionError("gloo all-gather of a CUDA bf16 tensor: "
                                 "wrong result")
        torch.cuda.synchronize()
        if peer.wait(60) != 0:
            raise AssertionError("the all-reduce peer failed")
    finally:
        if peer.poll() is None:
            peer.kill()
        shutil.rmtree(workdir, ignore_errors=True)
    print("tp collectives (gloo, 2 ranks on one card): " + json.dumps(rows),
          flush=True)
    return rows


def tp_gemm_rows(gen, shards, ms, flush, prefix="tp kernel"):
    """B1 at tp 2's per-shard shapes, each through ops as the rank's
    forward calls it, against its plain version, timed: ``shards`` lists
    (label, K, N, part) of the whole weight, ``part`` "n" a column shard
    (bf16 out) or "k" a row shard (the f32 form: scale, no bias). The
    library time of an f32 form is cuBLAS's bf16 product of the same
    shape (a bf16 output)."""
    import torch
    from repro_torch.core import weights
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_gemm as gemm_lib

    rows = []
    for label, k, n, part in shards:
        w = _packed_weight(gen, k, n)
        if part is not None:
            w = weights.shard_weight(w, part, 0, TP["tp"])
        for m in ms:
            phase = _serving_phase(m)
            x = torch.randn(m, w.k, generator=gen, device="cuda").to(
                torch.bfloat16)
            f32 = part == "k"
            kw = dict(partition="k", tp=TP["tp"]) if f32 else {}
            with ops.serving_phase(phase):
                got = ops.ternary_gemm(x, w, **kw)
                ref = gemm_lib.ternary_gemm_ref(
                    x, w.packed, w.scale, None if f32 else w.bias,
                    out_dtype=torch.float32 if f32 else None)
                if got.dtype != ref.dtype:
                    raise AssertionError(f"{label}: {got.dtype} against "
                                         f"{ref.dtype}")
                err = check_close(f"ternary_gemm {label} M={m}", got, ref)
                w_eff = w.materialize(torch.float32, with_scale=True).to(
                    torch.bfloat16)
                iters = _iters_for(m)
                row = {"tp_shard": label, "m": m, "k": w.k, "n": w.n,
                       "phase": phase, "out": "float32" if f32 else
                       "bfloat16", "max_abs_err": err,
                       "ms": cuda_ms(lambda: ops.ternary_gemm(x, w, **kw),
                                     iters, flush),
                       "plain_ms": cuda_ms(lambda: gemm_lib.ternary_gemm_ref(
                           x, w.packed, w.scale, None, out_dtype=(
                               torch.float32 if f32 else None)), iters,
                           flush),
                       "library_ms": cuda_ms(lambda: torch.matmul(x, w_eff),
                                             iters, flush)}
            nbytes = (m * w.k * 2 + w.packed.numel() * 4 + w.n * 4
                      + m * w.n * (4 if f32 else 2))
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes,
                                                        2.0 * m * w.nnz)
            print(f"{prefix} {label} M={m}: " + json.dumps(row), flush=True)
            rows.append(row)
            del x, w_eff
    return rows


def tp_mlp_rows(gen, d, ff, ms, flush, prefix="tp kernel"):
    """B4 on one rank's d_ff slice (ff / tp columns of up and gate, the
    rows of down) with the f32 partial, against its plain version,
    timed."""
    import torch
    from repro_torch.core import weights
    from repro_torch.kernels import fused_mlp as fused_lib
    from repro_torch.kernels import ops

    wi, wg = (weights.shard_weight(_packed_weight(gen, d, ff), "n", 0,
                                   TP["tp"]) for _ in range(2))
    wo = weights.shard_weight(_packed_weight(gen, ff, d), "k", 0, TP["tp"])
    rows = []
    for m in ms:
        phase = _serving_phase(m)
        x = torch.randn(m, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        args = (x, wi.packed, wo.packed, wg.packed, wi.scale, None,
                wg.scale, None, wo.scale, None)
        with ops.serving_phase(phase):
            got = ops.fused_mlp(x, wi, wo, wg, tp=TP["tp"])
            ref = fused_lib.fused_mlp_ref(*args, out_dtype=torch.float32)
            err = check_close(f"fused_mlp ff-{wi.n} slice M={m}", got, ref)
            ei, eg, eo = (c.materialize(torch.float32, with_scale=True).to(
                torch.bfloat16) for c in (wi, wg, wo))
            iters = _iters_for(m)
            row = {"tp_shard": "ff slice (f32 partial)", "m": m, "k": d,
                   "ff": wi.n, "n": d, "phase": phase,
                   "out": "float32", "max_abs_err": err,
                   "ms": cuda_ms(lambda: ops.fused_mlp(x, wi, wo, wg,
                                                       tp=TP["tp"]),
                                 iters, flush),
                   "plain_ms": cuda_ms(lambda: fused_lib.fused_mlp_ref(
                       *args, out_dtype=torch.float32), iters, flush),
                   "library_ms": cuda_ms(
                       lambda: (torch.nn.functional.silu(x @ eg) * (x @ ei))
                       @ eo, iters, flush)}
            del ei, eg, eo
        nbytes = (m * d * 2 + (wi.packed.numel() + wg.packed.numel()
                               + wo.packed.numel()) * 4
                  + (2 * wi.n + d) * 4 + m * d * 4)
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, 2.0 * m * (wi.nnz + wg.nnz + wo.nnz))
        print(f"{prefix} fused_mlp ff {wi.n} M={m}: " + json.dumps(row),
              flush=True)
        rows.append(row)
    return rows


def tp_kernel_rows(flush):
    """The kernels at tp 2's per-shard shapes of full-width ternary-paper,
    each through ops as the rank's forward calls it, against its plain
    version, timed: B1 on a column shard (q/k/v 1024 -> 512) and a row
    shard (o, 512 -> 1024, the f32 form: scale, no bias), the lm head's
    shard (1024 -> 16384), at M 8 and 1024; B4 on an ff-2048 slice with
    the f32 partial; B5 over 8 of the 16 heads (serving shape)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 27)
    gemm = tp_gemm_rows(gen, (("column shard q/k/v", 1024, 1024, "n"),
                              ("row shard o (f32)", 1024, 1024, "k"),
                              ("lm head shard", 1024, 32768, "n")),
                        (8, 1024), flush)
    mlp = tp_mlp_rows(gen, 1024, 4096, (8, 1024), flush)
    shape = dict(PAGED, h=PAGED["h"] // TP["tp"], kv=PAGED["kv"] // TP["tp"])
    gen_p = torch.Generator(device="cuda").manual_seed(SEED + 28)
    inputs = _paged_inputs(gen_p, shape, lambda: torch.randint(
        1, shape["max_len"] + 1, (shape["b"],), generator=gen_p,
        device="cuda", dtype=torch.int32))
    paged = paged_rows("tp 8 heads", shape, inputs, flush,
                       subsets=([3], [6, 1, 4, 0, 7, 2, 5, 3]), on_path=True)
    for r in paged:
        r["tp_shard"] = "8 of 16 heads"
    return {"ternary_gemm": gemm, "fused_mlp": mlp,
            "paged_decode_attention": paged}


def tp_phase(flush, cfg=None, params=None):
    """Tensor-parallel serving on this card (module docstring, ``tp``):
    gloo's CUDA collectives and their times, the per-shard kernel rows,
    then full-width ternary-paper at tp 2 (two ranks sharing cuda:0 over
    gloo, eager) dense, paged bf16 and paged int8 against tp 1, and the
    router at dp 2 x tp 1 and dp 2 x tp 2 against one engine. Returns
    (kernel rows by name, launch counts by run, a summary)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import router as router_lib
    from repro_torch.distributed import tp as tp_lib
    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousScheduler

    summary = {"collectives": tp_collectives()}
    rows = tp_kernel_rows(flush)
    if params is None:
        cfg = get_config("ternary-paper")
        cfg, params = serve.build_params(cfg, SEED, "cuda", packed=True)
    prompts, gens, _ = serve.build_workload(
        cfg, SERVE["requests"], SERVE["prompt_len"], TP["gen_lens"],
        seed=SEED)
    max_len = SERVE["prompt_len"] + max(TP["gen_lens"]) + 1
    devices = ["cuda:0"] * (2 * TP["tp"])
    mesh = tp_lib.replica_meshes(1, TP["tp"], devices[:TP["tp"]])[0]
    try:
        ContinuousScheduler(cfg, max_slots=SERVE["slots"], max_len=max_len,
                            mesh=mesh)
    except ValueError as e:
        print(f"tp: cuda_graph=True over gloo raises: {e}", flush=True)
    else:
        raise AssertionError("a gloo tensor-parallel engine with "
                             "cuda_graph=True did not raise")
    runs, steps = {}, {}
    modes = (("dense", {}),
             ("paged_bf16", dict(cache="paged", page_size=PAGE_SIZE)),
             ("paged_int8", dict(cache="paged", page_size=PAGE_SIZE,
                                 kv_dtype="int8")))
    for label, kw in modes:
        ref = _engine(cfg, params, max_len, True, **kw)
        r_outs, _, r_first, _ = _tp_drive(ref, prompts, gens)
        del ref
        t0 = time.perf_counter()
        eng = ContinuousScheduler(cfg, max_slots=SERVE["slots"],
                                  max_len=max_len, cuda_graph=False,
                                  mesh=mesh, **kw)
        eng.load(params)
        t_load = time.perf_counter() - t0
        try:
            outs, metrics, first, launches = _tp_drive(eng, prompts, gens)
        finally:
            eng.close()
        what = f"tp 2 {label}"
        _tp_check_run(what, cfg, outs, gens, launches,
                      None if label == "dense" else eng.decode_steps)
        live = [i for i in range(SERVE["slots"])
                if outs[i][0] == r_outs[i][0]]
        _compare_logits(f"{what} first decode step vs tp 1 (rows {live})",
                        r_first[live], first[live], LOGIT_TOL)
        splits = streams_or_near_ties(what + " vs tp 1", cfg, params,
                                      prompts, r_outs, outs)
        brief = {k: v for k, v in metrics.items() if k != "per_request"}
        print(f"{what} serving metrics: " + json.dumps(brief), flush=True)
        print(f"{what} serving launches (leader): " + json.dumps(launches),
              flush=True)
        runs[f"tp2_{label}"] = launches
        steps[label] = {"load_s": t_load, "tok_per_s": metrics["tok_per_s"],
                        "tpot_p50_s": metrics["latency"]["tpot_s"]["p50"],
                        "decode_steps": metrics["decode_steps"],
                        "splits": len(splits), "mesh": metrics["mesh"]}
    summary["tp2"] = steps

    p_prompts, p_gens = tp_prefix_workload(cfg)
    kw = dict(cache="paged", page_size=PAGE_SIZE)
    ref = _engine(cfg, params, max_len, True, **kw)
    r_outs, _, _, _ = _tp_drive(ref, p_prompts, p_gens, waves=2)
    del ref
    routers = {}
    for dp, tp in ((2, 1), (2, TP["tp"])):
        label = f"router dp {dp} x tp {tp}"
        meshes = tp_lib.replica_meshes(dp, tp, devices[:dp * tp])
        engines = []
        try:
            for m in meshes:
                e = ContinuousScheduler(cfg, max_slots=SERVE["slots"],
                                        max_len=max_len, cuda_graph=tp == 1,
                                        mesh=m, **kw)
                e.load(params)
                engines.append(e)
            front = router_lib.Router(engines)
            outs, metrics, _, launches = _tp_drive(front, p_prompts, p_gens,
                                                   waves=2)
        finally:
            for e in engines:
                e.close()
        _tp_check_run(label, cfg, outs, p_gens, launches,
                      sum(e.decode_steps for e in engines))
        splits = streams_or_near_ties(label + " vs one engine", cfg, params,
                                      p_prompts, r_outs, outs)
        if front.affinity_hits <= 0:
            raise AssertionError(f"{label}: no prefix-affinity placement")
        info = {"placements": front.placements,
                "affinity": {"candidates": front.affinity_candidates,
                             "hits": front.affinity_hits},
                "spills": front.spills, "splits": len(splits),
                "tok_per_s": metrics["tok_per_s"],
                "per_replica": metrics["per_replica"]}
        print(f"{label}: " + json.dumps(info), flush=True)
        runs[f"router_dp{dp}_tp{tp}"] = launches
        routers[label] = info
    summary["router"] = routers
    print("tp summary: " + json.dumps(summary), flush=True)
    return rows, runs, summary


def dryrun_phase():
    """The dry run's calibration on the card (module docstring,
    ``dryrun``). Returns its readings."""
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, hlo_cost, serve
    from repro_torch.models import LM

    t_phase = time.perf_counter()
    card = card_line()
    total = torch.cuda.get_device_properties(0).total_memory
    hbm_err = abs(total - dryrun.HBM_BYTES) / dryrun.HBM_BYTES
    print(f"dryrun: card {card}; total_memory {total} B against HBM_BYTES "
          f"{dryrun.HBM_BYTES} B ({hbm_err:.4f} apart)", flush=True)
    if hbm_err > DRYRUN["hbm_rtol"]:
        raise AssertionError(f"dryrun: the card holds {total} B, "
                             f"HBM_BYTES says {dryrun.HBM_BYTES}")
    mesh = dryrun.parse_mesh("1x1")
    rows = []
    for name, seq, batch, kind, quant in DRYRUN["shapes"]:
        shape = ShapeConfig(name, seq, batch, kind)
        t0 = time.perf_counter()
        rec = dryrun.run_cell("ternary-paper", name, quant=quant, mesh=mesh,
                              shape=shape)
        cfg = get_config("ternary-paper", quantization=quant)
        step, args, _ = dryrun.rank_step(cfg, shape, mesh)
        meta = hlo_cost.trace(step, *args)
        del step, args
        t_meta = time.perf_counter() - t0
        if kind == "train":
            params = LM(cfg, "cuda").init(
                torch.Generator(device="cuda").manual_seed(SEED))
        else:
            _, params = serve.build_params(
                get_config("ternary-paper"), SEED, "cuda", packed=True)
        step, args, _ = dryrun.rank_step(cfg, shape, mesh, params=params,
                                         device="cuda")
        del params
        out = step(*args)                       # builds, warms the pools
        del out
        torch.cuda.synchronize()
        on_card = hlo_cost.trace(step, *args)
        on_card.result = None
        for what, a, b in (("flops", on_card.kernel.flops, meta.kernel.flops),
                           ("bytes", on_card.kernel.bytes, meta.kernel.bytes)):
            if a != b:
                raise AssertionError(f"dryrun {name}: kernel-charged {what} "
                                     f"on the card {a} != meta {b}")
        if on_card.kernel.by_op != meta.kernel.by_op:
            diff = {k: (on_card.kernel.by_op.get(k),
                        meta.kernel.by_op.get(k))
                    for k in set(on_card.kernel.by_op) | set(
                        meta.kernel.by_op)
                    if on_card.kernel.by_op.get(k) != meta.kernel.by_op.get(k)}
            raise AssertionError(f"dryrun {name}: kernel-charged ops differ "
                                 f"(card, meta): {diff}")
        torch.cuda.synchronize()
        arg_bytes = on_card.argument_bytes
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = step(*args)
        torch.cuda.synchronize()
        del out
        peak = torch.cuda.max_memory_allocated() - (resident - arg_bytes)
        peak_err = abs(meta.peak_bytes - peak) / peak
        times = []
        for _ in range(DRYRUN["iters"]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(*args)
            end.record()
            end.synchronize()
            del out
            times.append(start.elapsed_time(end) / 1e3)
        measured = statistics.median(times)
        modelled = max(rec["kernel_t_compute_s"], rec["kernel_t_memory_s"])
        row = {"shape": name, "kind": kind, "quant": quant,
               "kernel_flops": meta.kernel.flops,
               "kernel_bytes": meta.kernel.bytes,
               "plain_flops": meta.plain.flops,
               "plain_bytes": meta.plain.bytes,
               "modelled_s": modelled,
               "modelled_plain_s": max(rec["t_compute_s"],
                                       rec["t_memory_s"]),
               "measured_s": measured, "measured_over_modelled":
                   measured / modelled,
               "peak_bytes_modelled": meta.peak_bytes,
               "peak_bytes_measured": peak, "peak_rel_err": peak_err,
               "argument_bytes": arg_bytes, "resident_else":
                   resident - arg_bytes,
               "trace_meta_s": t_meta, "card": card}
        print(f"dryrun {name}: " + json.dumps(row), flush=True)
        if peak_err > DRYRUN["peak_rtol"]:
            raise AssertionError(
                f"dryrun {name}: modelled peak {meta.peak_bytes} B is "
                f"{peak_err:.3f} from the card's {peak} B")
        rows.append(row)
        del step, args
        torch.cuda.empty_cache()
    print(f"dryrun phase took {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return rows


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("tune", "frontends", "tp",
                                       "train_dist", "tp_families",
                                       "dryrun"),
                    help="build and run this phase alone (tune: after the "
                         "dense serve it plans from; no kernels line)")
    ap.add_argument("--tune-out", help="copy the tune phase's measured "
                    "block-shape cache to this file")
    ap.add_argument("--allreduce-peer", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    start = time.perf_counter()
    import torch
    if args.allreduce_peer:
        return _allreduce_peer(args.allreduce_peer)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch sources under {SRC}; run it from "
              f"a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import autotune, build
    # every plan of the run comes from the tuner's model with no cache file
    # (a fresh one, removed at the end): the same plans in every checkout
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    os.environ[autotune.CACHE_ENV] = str(Path(tune_dir) / "model.json")
    try:
        return _main(args, start, torch, build)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def _main(args, start, torch, build) -> int:

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    per_source = build.build()
    print(f"built {sorted(per_source)} in {time.perf_counter() - t0:.2f}s "
          f"(parallel nvcc; per source "
          f"{ {k: round(v, 2) for k, v in per_source.items()} })", flush=True)
    for name in build.SOURCES:
        log = (build.BUILD_DIR / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "entry function" in line:
                    entry = line.split("'")[1]
                    print(f"  {name}: {entry}", flush=True)
                elif "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}", flush=True)
    sass_summary(build)

    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    if args.only == "frontends":
        frontends_phase(flush)
        print(f"chip_smoke --only frontends took "
              f"{time.perf_counter() - start:.1f}s", flush=True)
        return 0
    if args.only == "tp":
        tp_phase(flush)
        print(f"chip_smoke --only tp took "
              f"{time.perf_counter() - start:.1f}s", flush=True)
        return 0
    if args.only == "tp_families":
        tp_families_phase(flush)
        print(f"chip_smoke --only tp_families took "
              f"{time.perf_counter() - start:.1f}s", flush=True)
        return 0
    if args.only == "dryrun":
        del flush
        dryrun_phase()
        print(f"chip_smoke --only dryrun took "
              f"{time.perf_counter() - start:.1f}s", flush=True)
        return 0
    if args.only == "train_dist":
        del flush
        train_dist_phase()
        print(f"chip_smoke --only train_dist took "
              f"{time.perf_counter() - start:.1f}s", flush=True)
        return 0
    shapes = kernel_phase(flush)
    shapes["paged_decode_attention"] = paged_kernel_phase(flush)
    del flush
    row_independence_check()
    torch.cuda.empty_cache()
    cfg, params, prompts, gens, max_len, dense_outs, launches = serve_phase()
    if args.only == "tune":
        tune_phase(cfg, params, prompts, gens, max_len, args.tune_out)
        print(f"chip_smoke --only tune took "
              f"{time.perf_counter() - start:.1f}s", flush=True)
        return 0
    model_phase(cfg, params, prompts, max_len)
    runs = {"dense": launches}
    workloads = serving_workloads(cfg, prompts, gens, max_len)
    paged_runs, bf16_outs, int8_outs = paged_phases(cfg, params, workloads,
                                                    dense_outs)
    runs.update(paged_runs)
    graph_rows, tracers = decode_graph_phase(cfg, params, workloads)
    trace_spans = trace_check(*tracers["dense"])
    del tracers
    profile_rows = profiler_phase(cfg, params, workloads)
    print("serving host/device summary: " + json.dumps(
        {"decode_graph": graph_rows, "trace_spans": trace_spans,
         "profiles": profile_rows}), flush=True)
    chunk_rows, chunk_runs, chunk_streams = chunked_phase(
        cfg, params, workloads,
        {"dense": dense_outs, "paged_bf16": bf16_outs})
    runs.update(chunk_runs)
    runs.update(faults_phase(
        cfg, params, workloads,
        {"dense": dense_outs, "paged_bf16": bf16_outs,
         "chunked_dense": chunk_streams["dense"]}, graph_rows, profile_rows))
    for name, rows in chunk_rows.items():
        shapes[name] += rows
    tune_rows, tune_side_rows = tune_phase(cfg, params, prompts, gens,
                                           max_len, args.tune_out)
    spec_rows, spec_runs = spec_phase(
        cfg, params, workloads,
        {"dense": dense_outs, "paged_bf16": bf16_outs,
         "paged_int8": int8_outs}, graph_rows)
    runs.update(spec_runs)
    for name, rows in spec_rows.items():
        shapes[name] += rows
    mode_rows, mode_runs = modes_phase(cfg, params, workloads, dense_outs,
                                       graph_rows)
    runs.update(mode_runs)
    for name, rows in mode_rows.items():
        shapes[name] += rows
    mlp_rows, runs["mlp_formats"] = mlp_formats_phase(cfg, params, prompts,
                                                      max_len)
    torch.cuda.empty_cache()
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    tp_rows, tp_runs, _ = tp_phase(flush, cfg, params)
    del flush
    runs.update(tp_runs)
    for name, rows in tp_rows.items():
        shapes[name] += rows
    del params
    torch.cuda.empty_cache()
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    built = {}
    family_rows, family_runs = families_phase(flush, keep=built)
    runs.update(family_runs)
    for name, rows in family_rows.items():
        shapes[name] += rows
    tpf_rows, tpf_runs = tp_families_phase(flush, built)
    del built
    runs.update(tpf_runs)
    for name, rows in tpf_rows.items():
        shapes[name] += rows
    torch.cuda.empty_cache()
    frontend_rows, frontend_runs = frontends_phase(flush)
    runs.update(frontend_runs)
    torch.cuda.empty_cache()
    format_rows, runs["gemm_formats"] = gemm_formats_phase(flush)
    k_sweep = format_rows.pop("k_sweep")
    shapes.update(format_rows)
    print("tcsc summary: " + json.dumps(tcsc_phase(flush)), flush=True)
    shapes["flash_attention"] = flash_kernel_phase(flush, build)
    for name, rows in frontend_rows.items():
        shapes[name] += rows
    del flush
    torch.cuda.empty_cache()
    gradients_phase()
    step_check = train_step_check()
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        cfg, params, runs["train"], train_summary = train_phase(ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    eval_out, runs["eval"] = eval_phase(cfg, params)
    del params
    print("train/eval summary: " + json.dumps(
        {"train_step_check": step_check, "train": train_summary,
         "eval": eval_out}), flush=True)
    torch.cuda.empty_cache()
    _, runs["train_dist_eval"] = train_dist_phase()
    torch.cuda.empty_cache()
    print("dryrun summary: " + json.dumps(dryrun_phase()), flush=True)

    meta = {
        "ternary_gemm": ("src/repro_torch/kernels/csrc/ternary_gemm.cu",
                         "src/repro/kernels/ternary_gemm.py:148"),
        "fused_mlp": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                      "src/repro/kernels/fused_mlp.py:187"),
        "paged_decode_attention": (
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/paging/kernels.py:189"),
        "ternary_gemm_skip": (
            "src/repro_torch/kernels/csrc/ternary_gemm_skip.cu",
            "src/repro/kernels/ternary_gemm.py:251"),
        "ternary_gemm_skip_db": (
            "src/repro_torch/kernels/csrc/ternary_gemm_skip.cu",
            "src/repro/kernels/ternary_gemm.py:413"),
        "ternary_gemm_bitplane": (
            "src/repro_torch/kernels/csrc/ternary_gemm_bitplane.cu",
            "src/repro/kernels/ternary_gemm_bitplane.py:85"),
        "flash_attention": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:83"),
    }
    kernels = []
    for name, rows in shapes.items():
        path_rows = [r for r in rows if r.get("on_path", True)]
        total = {key: sum(r[key] for r in path_rows)
                 for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        entry = {
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": sum(run[name] for run in runs.values()),
            "runs": {label: run[name] for label, run in runs.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            # the kind of bound of the shape that dominates the summed bound
            "bound_by": max(path_rows,
                            key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": total["library_ms"],
            "shapes": rows,
        }
        if all("device_ms" in r for r in path_rows):
            entry["device_ms"] = sum(r["device_ms"] for r in path_rows)
        if name == "ternary_gemm_skip_db":
            entry["k_sweep"] = k_sweep
        if name == "fused_mlp":
            entry["mlp_formats"] = mlp_rows
        kernels.append(entry)
    print(f"chip_smoke took {time.perf_counter() - start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
