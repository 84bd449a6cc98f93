#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each fails loudly, with a non-zero exit).  After phase 2 four
worker processes (``Workers``; ``python3 chip_smoke.py --worker NAME
OUT``, one group of ``WORKERS`` each) run beside this one on the same
card: ``cv`` phases 6, 7, 12 and 24, ``selection`` 9, 10, 13, 15 and
21's part (x), ``serving`` 11 and 16-18, ``lm`` 21 and 22, while this
process runs 3-5, 8, 14, 19 and 20 with the audits.  Each worker's
output is printed when it ends.  Every kernel timing runs alone on the card: the ``cv`` worker's
checks at the examples' inputs and the ``lm`` worker's curve checks, one
after the other, once the other processes are idle, then phase 19's
sharded checks and phase 23 here after every worker has ended.  Other times
printed by phases 3-22 are taken with the other processes running.

1. Environment: the card's name and power limit (as ``nvidia-smi`` gives
   them), torch and CUDA versions, TF32 flags (turned off and checked).
2. Build: the five CUDA kernels are compiled from ``src/repro_torch/
   kernels/csrc`` into ``build/repro_torch/`` (at first use).
3. Main path: the paper's Table 1, Synthetic 1 (N=250, p=10 000, 1000
   groups of 10, alpha = tan 45 deg, 100 lambdas, tol 1e-6, safety 1e-6,
   max_iter 6000, check_every 50) through ``SGLSession.path`` in float32 on
   the card, with the kernels' launch counters reset just before and read
   just after.  Every FISTA solve of the float32 path replays captured
   CUDA graphs of its ``check_every`` block (``fista_sgl_graphed``): no
   eager solve runs, ``sgl_prox`` launches once per FISTA iteration (the
   engine's ``stats.fista_iters``; a replay counts the launches its
   capture recorded), and solve time per iteration is printed.  The same path in float64 (no
   kernels, eager) as the reference; the f32 screen's discards checked
   against the f64 solution; a warm second call that must pay no new
   compilation and capture no graph; one more warm call traced (CUPTI's
   records of the card, ``DeviceTrace``; the screen's torch functions by
   a function mode, ``ScreenRanges``) for the device's busy time and idle
   share, whose
   ``sgl_prox`` kernels on the card must equal the launch count, whose
   ``screen_norms`` kernels must equal both the launch count and
   ``n_pallas_screens``, and in which no operator may take a tensor of the
   padded (., G, n_max) layout (the screen reads its GEMM's output through
   the spec, unpadded); the longest solve of the path rerun eagerly and graphed (equal iteration
   counts, betas within 1e-6 relative, bitwise equality printed).
4. Ragged path: the paper's Table 2 shape (N=747, p=100 000, ADNI-like
   ragged groups, n_max=9, Frobenius group norms, 8 lambdas), counters as
   in phase 3, graphed as in phase 3.
5. Nonnegative-Lasso path: the paper's Table 3, Synthetic 1 (N=250,
   p=10 000, 100 lambdas, tol 1e-6, safety 1e-6) through
   ``SGLSession(Problem.nn_lasso(...)).path`` in float32 on the card
   (counters as in phase 3; the certification GEMV is its only kernel) and
   in float64 as the reference; the f32 DPC screen's discards checked
   against the f64 solution.
6. SGL cross-validation: Synthetic 1 of phase 3 at full width, K = 5
   folds, 100 lambdas, tol 3e-6, safety 1e-5, elastic schedule, through
   ``SGLSession.cv`` in float32, cold then warm (0 new compilations); every
   stacked screen through ``screen_norms_folds``; a float64 CV on the same
   folds and grid as the reference; one more float32 call with per-fold
   centering (20 lambdas), whose rows must all be certified.  The float32
   calls replay graphed blocks as in phase 3; one more warm call under
   ``DeviceTrace`` for the idle share.
7. Nonnegative-Lasso cross-validation: the Table-3 data of phase 5, the
   plan of phase 6; every stacked screen through ``dpc_screen_folds``; a
   float64 reference.
8. Gap-Safe SGL path: phase 3's data and plan with ``screen='gapsafe'``
   in float32 (two ``screen_norms`` launches a screen, TLFre's grid and
   the Gap-Safe center row; ``sgl_prox`` once per FISTA iteration; ``xtv``
   once per row solved), warm, profiled (2 x ``n_pallas_screens`` fused
   screen kernels) and in float64; Gap-Safe keeps no more features than
   TLFre on any row of the sequential screen.
9. Adaptive weights on phase 3's data (``uniform(0.5, 2.0)``, seed 20):
   group and feature weights under TLFre and Gap-Safe (``xtv`` once per
   row solved and no other kernel: the fused prox and screen statistics
   take one l1 threshold), and group weights alone under TLFre (the
   kernel route of phase 3), float32; each against its float64 twin at
   20 lambdas (a float32 call on the same plan).
10. Gap-Safe nonnegative-Lasso path: phase 5's data and plan (``xtv``).
11. Gap-Safe SGL CV: phase 6's plan (100 lambdas), cold and warm (two
    ``screen_norms_folds`` launches a stacked screen); float64 against
    float32 at 20 lambdas.
12. Gap-Safe nonnegative-Lasso CV: phase 7's plan, cold and warm;
    float64 against float32 at 20 lambdas.
13. Sparse-group logistic path: ``loss_logistic_bench`` of
    ``benchmarks/paper_tables.py`` at full size, ``screen='gapsafe'``
    against ``'none'``, float32 (graphed ``sgl_prox`` blocks, ``xtv``
    once per row solved, one ``screen_norms`` launch a Gap-Safe screen)
    and float64 (the unscreened float64 path, held only against the
    screened one, at 20 lambdas).
    Phases 8-13 hold the bars of phases 3-7 (every accepted row
    certified, float32 against float64, no float32 discard nonzero in
    float64) and print their seconds and the float32 ``n_rejected``.
14. The paper's per-lambda driver, ``Plan(engine='legacy')``, on the data
    and plans of phases 3 and 5, float32 and float64: the float32 SGL
    path launches ``xtv`` once a screen and once a solved row,
    ``screen_norms`` once a screen (the one-ball (1, p) row) and
    ``sgl_prox`` once a FISTA iteration (graphed blocks); the
    nonnegative Lasso ``xtv`` alone, as often; float64 no kernel, on
    every fifth point of the grid (20 lambdas).  A warm second float32
    call captures no graph; on those 20 points float32 against float64 as
    in phase 3 and the float64 legacy betas within 1e-2 * max|beta| of the
    float64 batched paths of phases 3 and 5.  Wall, solve us per FISTA
    iteration, iterations and summed kept features are printed.
15. Warm two-stage refinement, ``benchmarks/paper_tables.py:session_bench``
    at full size (Synthetic 1 with 0.5 std(y) of noise, K = 5, 100
    lambdas, tol 3e-6, float32): ``cv``, ``refine(factor=10)`` and, at
    check_every 10, ``refine(factor=3)``, each against a cold ``cv`` over
    its refined grid (betas within 1e-2 * max|beta|, selection within one
    step; the FISTA iterations of both printed), a warm repeat of ``cv``
    and both refinements (no compilation, no capture); float64 ``cv`` + ``refine`` at 20 lambdas against float32's
    on the same grids (the CV bars of phase 6); the nonnegative-Lasso
    ``refine`` on the Table-3 data at 20 lambdas.  Each stacked screen one
    ``screen_norms_folds`` (``dpc_screen_folds``) launch, every FISTA
    iteration a graphed ``sgl_prox`` launch, ``xtv``.
16. Stability selection at the ``stability_selection`` shim's defaults
    (Synthetic 1, 50 half-row subsamples in batches of 10, 30 lambdas,
    float32): the kernels of phase 15, every row certified, a warm repeat
    that compiles and captures nothing; float64 at 10 subsamples and 10
    lambdas on the same masks and grid: an activity decision differs only
    where float64's |beta| is within 1e-2 * max|beta| of ``active_tol``.
17. The estimators of ``repro_torch.api`` at float32: ``SGLCV`` (K = 5,
    20 lambdas, Synthetic 1 + 3) and its ``session_.refine``,
    ``SGLRegressor`` at its ``lambda_`` (within 1e-2 * max|coef|),
    ``NNLassoCV`` (Table 3; coef >= 0), ``SGLClassifier``
    (``loss_logistic_bench``'s data at 0.3 lambda_max; objective within its
    certified gap of float64's).  Each route's launches are printed and
    checked.
18. Serving: ``SGLServer`` with 2 designs at Synthetic-1 width and 3
    responses each, 5 folds, 20 lambdas, float32, drained cold and warm:
    no job error, one fold-stacked engine call per design, no compilation
    when warm, each job against a solo CV and refit (the CV bars); latency
    per job printed.
    Phases 15-18 print their seconds, float32 ``n_rejected`` and launches
    by kernel.
19. Feature sharding, ``Plan(feature_shards=8)``, through the stacked
    executor (every block on the card): phase 3's Synthetic-1 path in
    float32, cold, warm (no compilation, no capture) and profiled (idle
    share), held to phase 3's bars against its float64 path, every row
    certified; ``xtv`` = 8 x rows certified (the setup's GEMVs are plain),
    ``screen_norms`` = 8 x screens, ``sgl_prox`` = FISTA iterations.  A
    float64 twin at 20 lambdas: kept sets equal to the unsharded float64
    path's, betas within 1e-12, no kernel.  Table 2's shape with its last
    7 groups dropped (18 184 groups, 8 blocks of unequal width, each
    padded), 4 lambdas, sharded against unsharded (betas within 1e-2 *
    max|beta|).  SGL CV, NN CV (K 5) and the NN path at 20 lambdas,
    against their unsharded twins: ``screen_norms_folds`` /
    ``dpc_screen_folds`` = 8 x stacked screens, NN path ``xtv`` = 8 x rows
    certified.  Then two ``gloo`` ranks on the one card run the
    Synthetic-1 path at 20 lambdas with ``feature_shards=2``, one block
    each: both ranks' betas equal each other's and the stacked run's bit
    for bit.  Each pair prints the card's peak allocation above what was
    allocated before the call.  Each kernel is then held against its plain
    version at the sharded route's own inputs (phase 23's tolerances):
    ``xtv`` on a Synthetic-1 block and Table 2's widest block,
    ``screen_norms`` at the recorded screen shapes on a Synthetic-1 local
    spec and on the Table-2 block with the most pad columns (no group owns
    them; 1e30 and NaN are poisoned into them), ``screen_norms_folds`` and
    ``dpc_screen_folds`` at the sharded CVs' first per-block screen shapes.
20. The fold mesh, ``Plan(mesh=...)``, at Synthetic 1's full width
    (float32, 20 lambdas unless said): ``make_fold_mesh(5)`` in one
    process is a mesh of one, and SGL CV at K 5 under it equals
    ``mesh=None`` bit for bit (per-fold betas, ``mean_mse``,
    ``best_index``, ``EngineStats``, launches; ``shard_over_folds``
    returns the sweep itself).  Two ``gloo`` ranks on the one card run
    ``make_fold_mesh(4)``: SGL CV at K 4 (elastic) and NN CV at K 4 (10
    lambdas); four run ``make_fold_feature_mesh(2, 2)``: SGL CV at K 4 (10
    lambdas) with ``feature_shards=2``, one block a rank.  Every rank's
    betas, MSE, selection and ``EngineStats`` equal the unsplit run's
    (in this process; the stacked executor for the feature shards) bit for
    bit; the mesh's tally has a split launch, split + unsplit launches =
    launches and one gather a split launch; summed over the ranks of a
    fold group, ``sgl_prox`` = FISTA iterations and ``xtv`` = the unsplit
    run's (where a launch ran unsplit, which each rank of the group runs
    whole, between once and d times these); each rank launches one screen
    kernel a stacked screen.  Then the audits:
    every session of phases 3-20 pays only sweep-shape keys and FISTA
    graphs that ``repro_torch.analysis.compile_audit`` predicts for its
    plans (each process and each rank audits its own), and, in this
    process after this phase, the five kernels hold under 1e30
    poison against their plain versions (``kernel_check.mask_coverage``),
    and the float64 gate refuses the kernels.
21. The LM zoo (``repro_torch.models``, float32,
    TF32 off): (a) the example's ``gemma2-100m`` (12 layers, d 512, 8 / 4 heads,
    d_ff 2048, vocabulary 32 768, window 256; B 8, S 256, lr 1e-3, SGL
    lambda 3e-4) through ``python -m repro_torch.examples.sgl_pruned_lm``'s
    ``main`` for ``LM_STEPS`` steps: the loss falls, the FFN channels' and
    heads' group stats are printed, the train step's ms (the step alone),
    tokens/s and the peak device memory; its pruning-threshold curve (``X =
    eye(2048)``, 24 lambdas, tol 1e-8) in float32 launches ``xtv`` once a
    row certified, ``screen_norms`` once a screen (``n_pallas_screens``) and
    ``sgl_prox`` once a FISTA iteration through graphed blocks; its float64
    twin (no kernel) keeps the same channels on every row.  (b)
    ``gemma2-2b`` at its published width and depth (about 2.6 B
    parameters) through ``repro_torch.launch.train.main``, 3 steps at B 2,
    S 256, the SGL prox on: finite losses, exact zeros in the prox's
    groups and none in ``wk``, step ms and peak memory printed.  (c)
    ``repro_torch.launch.serve.main`` on ``gemma2-2b`` (batch 4, prompt 16,
    gen 32, cache 128): warm p50 / p99 ms a step and tokens/s; then decode
    against the full forward on the example's config at T 300 > window 256
    with a 512-slot cache (the local ring wraps), within 2e-2 and 1e-4.
    (d) The example's run to step 2 with a checkpoint, resumed to step 4:
    the losses of steps 3-4 within 1e-5 relative of (a)'s.  (e)
    ``granite-moe-1b-a400m`` (MoE, 32 experts top 8; 1.33 B parameters) at
    its published width and depth through ``train.main``, 4 steps at B 4,
    S 256, the SGL prox on: finite losses and aux, exact zeros in the head
    groups of ``wq`` and the expert groups of ``w_in``, step ms, tokens/s
    and peak memory printed.  (f) The pruning curve of (e)'s trained expert
    channels (G = 512) with (a)'s curve's gates.  (g)
    ``serve.main`` on ``minicpm3-4b`` (MLA; 4.26 B parameters) at full
    width, as in (c), peak memory printed; then its absorbed decode of 16
    tokens against the expanded full forward (B 1), within 1e-3 *
    max|logits|.  (h) ``deepseek-v2-236b`` ``reduced()`` (a dense prologue
    layer, MLA, routed and shared experts): 3 train steps (finite, aux >
    0), decode of 48 tokens within 1e-4 of the full forward at lossless
    dispatch, and the MoE layer twice on one input bit for bit.  (i)
    ``zamba2-2.7b`` (Mamba2 + two shared attention blocks; 2.53 B
    parameters) at its published width and depth through ``train.main``,
    3 steps at B 2, S 256 (one full Mamba2 chunk of 256, where the
    reference's gradient is NaN), no prox: finite losses, step ms,
    tokens/s and peak memory printed.  (j) ``serve.main`` on
    ``zamba2-2.7b`` as in (c), peak memory printed; then decode of 32
    tokens against the full forward (B 1): the conv ring, the SSM state
    and the shared blocks' KV caches, within 1e-4 * max|logits|.  (k) One
    Mamba2 layer of ``zamba2-2.7b`` at full width, B 2, S 300 (a full
    chunk and a padded ragged tail): the chunked forward against the
    token-by-token decode within 1e-4 * max|y|; the gradient of
    ``sum(y**2)`` through the chunked form finite everywhere and within
    1e-3 relative L2 of the gradient through the decode recurrence, leaf
    by leaf.  (l) ``xlstm-350m`` at its published width and depth through
    ``train.main``, 3 steps at B 4, S 256 (the sLSTM's two checkpointed
    chunks of 128): finite losses; ``serve.main`` as in (c); decode of 32
    tokens against the full forward (B 1) within 1e-4 * max|logits|.  (m)
    ``seamless-m4t-medium`` (enc-dec, 12 + 12 layers, d 1 024, V 256 206;
    877 M parameters) at its published width and depth through
    ``steps.make_train_step``, 3 steps at B 4, S 256, remat none, the
    batch drawn by hand from a seeded numpy generator (frames from a
    normal, tokens and labels from ``integers``; the reference's
    ``train.main`` has no frames): finite losses, step ms, decoder
    tokens/s and peak memory printed.  (n) ``serve.main`` on it as in (c)
    (the reference's loop, over a zero ``enc_out``); the encoder once over
    frames (1, 32, 1 024) into a cache of 32, then 32 tokens decoded
    against the full ``encdec_forward`` within 1e-4 * max|logits|;
    ``make_prefill_step`` at B 4, frames 128, tokens 16 (p50 of 5 warm
    calls).  (o) ``llava-next-mistral-7b`` (7.24 B parameters) at its
    published width and depth: ``serve.main`` and decode against the full
    forward as in (j); ``make_prefill_step`` with 576 patches and 16
    tokens at B 4; ``forward_train``'s masked loss at B 1, 576 patches and
    64 tokens within 1e-5 relative of a cross-entropy by hand over the
    text positions.  (p) ``llava-next-mistral-7b`` at full width on 8 of
    its 32 layers (2.01 B parameters; a ``dataclasses.replace`` here, not
    registered), 3 steps at B 2 with 576 patches and 256 tokens, the SGL
    prox after each: finite losses, exact zeros in the prox's groups.
    (q) The pruning curve of (p)'s 14 336 FFN channels with (a)'s gates.
    Parts (r)-(v), after (f): one spawn of two ``gloo`` ranks sharing the
    card runs (r) ``granite-moe-1b-a400m`` at full width and depth through
    ``train.main`` on ``make_local_mesh()`` = (data 2, model 1), ZeRO-3,
    (e)'s argv for ``ZERO_STEPS`` steps: every rank's loss, ce and aux
    within 1e-5 relative of (e)'s and the prox's exact zeros equal to
    (e)'s after each step; each rank's state bytes, peak, step ms and its
    seconds in collectives printed; (s) one MoE layer of it on (data 1,
    model 2), 16 experts a rank, B 4, S 256, at capacity factors 1.25 and
    0.05: output and gradients (x, ``w_in``, router) within 1e-5 x
    max|.| of the emulation (each shard's experts through
    ``moe_ffn_local`` at the per-shard capacity, summed) in the same rank,
    the pairs each dispatch keeps counted inside ``moe_ffn_local``: the
    rank's equal to the emulation's shard, all 8 192 in windows of 5 120
    at 1.25 and fewer in windows of 205 at 0.05 (the unsharded layer's
    windows 320 and 13); (t)'s rank half: (d)'s step-2 checkpoint resumed
    on the ranks to step 4, within 1e-5 relative of (a), writing a step-4
    checkpoint; (u) the example on (data 1, model 2) through
    ``make_train_step(seq_shard=True, remat="full")``, 2 steps on (a)'s
    batches within 1e-5 relative of (a)'s, the stack's bytes saved for
    backward (``saved_tensors_hooks``) exactly half of those without
    ``seq_shard``.  Then this process resumes the ranks' step-4
    checkpoint with no mesh to step 6 (within 1e-5 of (a)), and (v)
    ``compress_tree`` / ``decompress_tree`` over random normal gradients
    of granite's tree (1.33 B values): every element within its block's
    max|.| / 127, the error feedback to 1e-7, ``wire_bytes`` the padded
    payload plus its scales exactly; the calls' ms printed.
    Part (w), after (v): tensor-parallel serving over 'model'.  In this
    process, one after the other, the twins: (w1) ``gemma2-2b`` at full
    width with float32 parameters and (w2) ``gemma3-12b`` at full width
    with bf16 parameters, float32 compute, serving batch 4, prompt 16
    teacher-forced then 32 greedy tokens through ``forward_decode`` into a
    float32 cache of 128, and ``make_prefill_step`` at B 4, S 16.  Then one
    spawn of two ``gloo`` ranks on ``lm_mesh({"data": 1, "model": 2})``
    runs both parts: each rank draws its blocks by ``sharding.
    serving_pspecs`` (``init_params(shardings=...)``: each leaf whole in
    the twin's order, then cut), decodes the twin's tokens and prefills
    under ``tp=True``; every step's logits and the prefill's within 1e-4 x
    max|logits| of the twin's; each rank's parameter bytes (its storages
    at the allocator's grain) equal to the dry run's ``tp_decode_bf16``
    cell at (data 1, model 2), B 4, cache 128 (run in a thread here
    meanwhile); the draw's peak within one leaf of the blocks; 2
    all-reduces a layer, one for the embedding and one all-gather of the
    logits a step; each rank's peaks beside the dry run's predicted peak
    and its p50 beside the twin's, with the card's name and power limit.
    Part (x), in the ``selection`` worker after phase 15 (the group that
    ends first; its peak, about 17 GB for (x3)'s twin, then two ranks of
    about 8 GB, sits beside the ``lm`` worker's 47 GiB): (w)'s harness and
    bars for the MLA and MoE configs, each at its published width: (x1)
    ``minicpm3-4b`` with bf16 parameters (MLA, its heads split), (x2)
    ``granite-moe-1b-a400m`` in float32 (GQA, 16 experts a rank) and (x3)
    ``deepseek-v2-236b`` with bf16 parameters, cut to its dense prologue
    layer and one MoE layer (5.36 B parameters; MLA over 64 heads a rank,
    80 routed experts a rank, the shared experts' channels split; its 60
    layers, 472 GB in bf16, fit no card).  The
    collectives a step are ``tp_collectives``' count from the config's
    dims (a MoE layer's routed and shared partials share one all-reduce;
    granite's odd vocabulary stays whole, so it has no embedding
    all-reduce and no all-gather).  A MoE part's twin prefills at the
    ranks' per-shard capacity (``_shard_capacity_moe``), the reference's
    ``shard_map`` window.
    Then ``xtv``, ``screen_norms`` and ``sgl_prox`` against their plain
    versions at each curve's shapes (X G x G, C (32, G) with n_max 1, the
    busiest prox bucket).  Every phase and part prints its seconds beside
    the summed walls of the calls it timed.
22. The port's audits (``repro_torch.analysis``; in the ``lm`` worker
    after phase 21): (a) ``run_layers`` on all five layers on the card
    (the trace lint's 23 entries on CUDA tensors, the AST rules, the
    compile-key audit, the kernels under 1e30 poison, the resource cards on
    fake CUDA tensors with their collective plans on fake process groups)
    against the committed ``baseline.json`` and ``budgets.json``: no new
    finding.  (b) Phase 3's float32 Synthetic-1 path and phase 6's 5-fold
    SGL CV on one session, the allocator's peak above what was allocated
    before against ``resource_audit.session_envelope`` for the keys and
    graphs the calls paid (each verified against the compile audit's
    universes): measured <= predicted, the ratio printed.  (c) In a child
    process (``python3 chip_smoke.py --capacity OUT``):
    ``capacity_max_p`` for the SGL path (N 250, groups of 10, 8 lambdas
    on the default grid, solve buckets screened to 16 384 features) at 4
    GB and at the card's memory; the path then runs at 0.95 of the 4 GB
    answer with ``set_per_process_memory_fraction`` at 4 GB: it completes
    with its peak within the budget and within the audit's envelope of
    the keys and graphs it paid (verified against the compile audit's
    universes); the planner's screened price at that p is printed beside
    with whether the run stayed in the screened regime.  (d) The dry run
    (``repro_torch.launch.dryrun.run_cell``, fake tensors, a process of
    its own) of the example's train step against phase 21 (a)'s measured
    peak: predicted >= measured, with the measured less the state, the
    step and the previous step's metrics printed beside the workspace
    bound.  (e) The dry run of (r)'s granite ZeRO-3
    cell on a fake (data 2, model 1) world, printed beside (r)'s measured
    peaks (no gate).
23. Each kernel against its plain PyTorch version on the card, at the
   shapes the paths give it, ragged shapes with 1e30 poisoned into every
   masked slot (``screen_norms``: 1e30 and NaN in two extra columns of C
   that the masked slots point at, ``cinf`` exact; ``sgl_prox``: into an
   uncovered column every masked slot points at, and every uncovered
   column must come out 0; at a real
   Synthetic-1 bucket, Table 2's full spec and a real bucket of it,
   n_max = 1 and n_max = 50; ``dpc_screen_folds`` exactly, also on inputs
   that land on 1.0 within one ulp); timed with CUDA events beside its
   bound, its plain version, the launch floor (a 1-element ``zero_()`` in
   the same graph harness) and, for ``xtv``, ``torch.mv`` at both X
   shapes, L2-warm and L2-cold (``screen_norms`` too, L2-warm and cold).
   Also the Synthetic-1 group-statistics step as the path runs it
   (``_grid_group_stats(spec, C, True)``) beside the gather and mask that
   the unfused screen ran, and ``screen_norms`` at the SGL CV's first
   stacked screen shape beside that screen's own step, and
   ``screen_norms`` on the legacy screen's (1, p) row.  Then the
   reference's padded entry points (``ops.screen_norms``,
   ``screen_norms_batched``, ``sgl_prox_padded``) on Synthetic 1's and
   Table 2's padded layouts, 1e30 and NaN in the masked slots, against
   their plain versions, each call one launch of its kernel.
24. The six root examples (``python -m repro_torch.examples.<name>``'s
   ``main`` with ``--device cuda``, at the reference scripts' sizes):
   ``quickstart``, ``nonneg_lasso_dpc``, ``cv_model_selection``,
   ``session_refinement``, ``sgl_logistic`` and ``serve_batched``.  Each
   returns (its exit), prints its walls, and launches each kernel its
   float32 route reaches (``EXAMPLE_KERNELS``; counted by path as
   ``example-<name>``); each SGL or NN example's ``run`` again in float64
   on the card, launching no kernel, holds the float32 results: every
   path's, CV's, estimator's and served job's betas within 1e-2 *
   max|beta|, every selection within one step.  Then, alone on the card,
   each kernel that an example launched against its plain version (phase
   23's checks and tolerances) at the inputs that example gave it:
   ``xtv`` on its largest X, ``screen_norms`` at its first screen's C and
   layout, ``screen_norms_folds`` at its first stacked screen,
   ``sgl_prox`` on its largest prox vector's layout and on the problem's
   whole layout (rows ``example_<name>`` of the kernels line).
25. One JSON line ``{"kernels": [...]}``, then the last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA card, or without the repository around it, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
import weakref
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory
F32_OPS_PER_S = 67e12             # H100 SXM float32 outside the tensor cores
EPS32 = float(np.finfo(np.float32).eps)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)

SOURCES = {
    "xtv": ("src/repro_torch/kernels/csrc/xtv.cu",
            "src/repro/kernels/xtv.py:53"),
    "screen_norms": ("src/repro_torch/kernels/csrc/screen_norms.cu",
                     "src/repro/kernels/screen_norms.py:41"),
    "sgl_prox": ("src/repro_torch/kernels/csrc/sgl_prox.cu",
                 "src/repro/kernels/sgl_prox.py:46"),
    "screen_norms_folds": ("src/repro_torch/kernels/csrc/screen_norms_folds.cu",
                           "src/repro/kernels/screen_norms.py:101"),
    "dpc_screen_folds": ("src/repro_torch/kernels/csrc/dpc_screen_folds.cu",
                         "src/repro/kernels/screen_norms.py:158"),
}
PATH_KERNELS = ("xtv", "screen_norms", "sgl_prox")


def say(*parts):
    print(*parts, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# phase 1-2: environment and build
# ---------------------------------------------------------------------------

def environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices "
        f"{torch.cuda.device_count()} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    return card


def build_kernels():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path = build.library_path()
    build.load()
    built = build.last_build_seconds
    say(f"[build] {path.relative_to(ROOT)} ready in "
        f"{time.perf_counter() - t0:.3f} s "
        f"({'built' if built is not None else 'cached'}"
        f"{f', nvcc {built:.3f} s' if built is not None else ''})")
    t0 = time.perf_counter()
    lib = DeviceTrace.library()
    say(f"[build] {Path(lib._name).relative_to(ROOT)} (the CUPTI collector, "
        f"on {DeviceTrace.libcupti()}) ready in "
        f"{time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# phase 3-4: the paths
# ---------------------------------------------------------------------------

class GraphedSolves:
    """Wraps ``path_engine.fista_sgl_graphed`` inside the block: sums the
    iterations of the graphed solves, and keeps the arguments of the
    longest one (a real segment's row) and, of the buckets they met, the
    spec of the one that ran the most iterations (the prox's busiest
    shape).  A solve that bypasses the hook only lowers the sum, which
    ``require_graph_route`` then refuses.  It also counts the SGL rows
    solved by the eager ``fista_sgl`` (``eager_solves``), so ``rows``
    counts every SGL row run."""

    def __init__(self):
        self.iters = 0
        self.solves = 0              # graphed solves: one per row run
        self.eager_solves = 0        # eager SGL solves: one per row run
        self.longest = None          # (iters, args, kwargs)
        self.by_bucket = {}          # (p_b, g_b) -> [iterations, spec]

    @property
    def rows(self):
        return self.solves + self.eager_solves

    def __enter__(self):
        from repro_torch.core import path_engine
        self.mod = path_engine
        self.orig = orig = path_engine.fista_sgl_graphed
        self.orig_eager = eager = path_engine.fista_sgl

        def counted(*args, **kw):
            self.eager_solves += 1
            return eager(*args, **kw)

        def recorded(*args, **kw):
            res = orig(*args, **kw)
            self.iters += res.iters
            self.solves += 1
            if self.longest is None or res.iters > self.longest[0]:
                self.longest = (res.iters, args, kw)
            spec = args[2]
            row = self.by_bucket.setdefault(
                (spec.num_features, spec.num_groups), [0, spec])
            row[0] += res.iters
            return res

        path_engine.fista_sgl_graphed = recorded
        path_engine.fista_sgl = counted
        return self

    def __exit__(self, *exc):
        self.mod.fista_sgl_graphed = self.orig
        self.mod.fista_sgl = self.orig_eager

    @property
    def busiest_spec(self):
        return max(self.by_bucket.values(), key=lambda r: r[0])[1]


def run_path(torch, sess, plan, label):
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with GraphedSolves() as calls:
        t0 = time.perf_counter()
        res = sess.path(plan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    note_wall(wall)
    counts = ops.launch_counts()
    st = res.stats
    say(f"[{label}] wall {wall:.3f} s = setup {res.setup_time:.3f} + screen "
        f"{res.screen_time:.3f} + solve {res.solve_time:.3f} s; "
        f"n_segments {st.n_segments} n_screens {st.n_screens} "
        f"n_pallas_screens {st.n_pallas_screens} n_compilations "
        f"{st.n_compilations} n_rejected {st.n_rejected} iters "
        f"{int(res.iters.sum())} (accepted rows) fista iterations run "
        f"{st.fista_iters} (graphed {calls.iters}); solve "
        f"{1e6 * res.solve_time / max(st.fista_iters, 1):.2f} us per "
        f"iteration; kept features (solver columns, summed over rows) "
        f"{int(res.kept_features.sum())}; graphs captured "
        f"{len(sess.fista_graphs)} (in the session); launches "
        f"{json.dumps(counts)}")
    require(np.isfinite(res.betas).all(), f"{label}: non-finite betas")
    return res, counts, wall, calls


def require_graph_route(res, counts, calls, label):
    """On the card's float32 kernel route every SGL solve replays graphed
    blocks, and each FISTA iteration is one ``sgl_prox`` launch."""
    st = res.stats
    require(counts["sgl_prox"] == st.fista_iters == calls.iters > 0,
            f"{label}: sgl_prox launches {counts['sgl_prox']}, FISTA "
            f"iterations {st.fista_iters}, graphed {calls.iters}: not all "
            f"equal")


def require_kernel_route(res, counts, label, kernels=PATH_KERNELS):
    for name in kernels:
        require(counts[name] > 0, f"{label}: kernel {name} was not launched")
    require(res.stats.n_pallas_screens == res.stats.n_screens > 0,
            f"{label}: not every screen went through the kernels")


def screen_discards_are_zero(torch, T, prob32, res32, betas64, alpha,
                             safety, *, spec=None, screen="tlfre",
                             kept=None):
    """Sequential f32 screen at every lambda from the f32 path's certified
    dual at the previous lambda; every discarded feature must be zero
    (|beta| <= 1e-6) in the float64 solution.  ``spec`` (default: the
    problem's) carries a plan's adaptive weights; ``screen='gapsafe'``
    intersects the TLFre rule with the Gap-Safe ball around that dual (the
    ball alone for a non-squared loss), routed as the path routes it (the
    screen statistics' kernel whenever there are no feature weights).
    ``kept``,
    a list, receives per row (features TLFre keeps, features the Gap-Safe
    ball alone keeps, features kept); a rule not run keeps all p."""
    from repro_torch.core.screening import (gap_safe_grid_radii,
                                            gap_safe_grid_radii_loss,
                                            gap_safe_screen_grid,
                                            tlfre_screen_grid)
    X, y = prob32.X, prob32.y
    spec = prob32.spec if spec is None else spec
    loss = T.get_loss(prob32.loss)
    squared = loss.name == "squared"
    kernels = spec.feature_weights is None
    r0 = loss.residual_at_zero(y)
    xty = X.T @ r0
    lam_max_t, g_star = T.lambda_max_sgl(spec, xty, alpha)
    lam_max = float(lam_max_t)
    col_n, gspec = T.column_norms(X), T.group_spectral_norms(X, spec)
    lambdas = res32.lambdas
    worst, n_discarded = 0.0, 0
    for j in range(1, len(lambdas)):
        lam_bar = float(lambdas[j - 1])
        beta = torch.as_tensor(res32.betas[j - 1], dtype=X.dtype,
                               device=X.device)
        if lam_bar >= lam_max * (1.0 - 1e-12):
            theta = r0 / lam_max
            beta = torch.zeros_like(beta)
        else:
            rho = loss.residual(y, X @ beta) / lam_bar
            theta = T.dual_scaling_sgl(spec, X.T @ rho, alpha) * rho
        lam = torch.as_tensor([lambdas[j]], dtype=X.dtype, device=X.device)
        keep = torch.ones(X.shape[1], dtype=torch.bool, device=X.device)
        if squared:
            n_vec = T.normal_vector_sgl(X, y, spec, lam_bar, lam_max, theta,
                                        g_star)
            _, fk, _ = tlfre_screen_grid(X, y, spec, alpha, lam, lam_bar,
                                         theta, n_vec, col_n, gspec,
                                         safety=safety, use_kernels=kernels)
            keep = fk[0]
        n_tlfre, n_ball = int(keep.sum()), X.shape[1]
        if screen == "gapsafe":
            fit = X @ beta
            resid = loss.residual(y, fit)
            pen = T.sgl_penalty(spec, beta, alpha)
            radii = (gap_safe_grid_radii(y, lam, theta, resid, pen) if squared
                     else gap_safe_grid_radii_loss(loss, y, lam, theta, fit,
                                                   resid, pen))
            _, fk = gap_safe_screen_grid(spec, alpha, X.T @ theta,
                                         radii * (1.0 + safety), col_n,
                                         gspec, use_kernels=kernels)
            n_ball = int(fk[0].sum())
            keep = keep & fk[0]
        if kept is not None:
            kept.append((n_tlfre, n_ball, int(keep.sum())))
        dropped = ~keep.cpu().numpy()
        n_discarded += int(dropped.sum())
        if dropped.any():
            worst = max(worst, float(np.abs(betas64[j][dropped]).max()))
    return worst, n_discarded


class DeviceTrace:
    """The card's kernels, copies and sets between ``__enter__`` and
    ``__exit__``: CUPTI's activity records, summed by name in C
    (``tools/device_trace.cpp``, built with ``nvcc`` at first use into
    ``build/device_trace/``): microseconds and count by (demangled) name.
    One stream, so the card's busy time is their sum.  ``torch.profiler``'s
    stop and a walk of its events cost some 20 us a device record (10^6
    records in one SGL CV call); this costs milliseconds after the call.
    It opens the libcupti that torch holds, so the two share one CUPTI.
    Trace before any ``torch.profiler`` run with CUDA activity in the
    process: that run leaves its own timestamp source with CUPTI, and
    durations read after it come out too long."""

    _lib = None

    @staticmethod
    def libcupti() -> str:
        """The libcupti torch loaded when it was imported."""
        with open("/proc/self/maps") as maps:
            for line in maps:
                if "libcupti.so" in line:
                    return line.split()[-1]
        raise SmokeFailure("torch has loaded no libcupti")

    @classmethod
    def library(cls):
        """Builds (once, keyed by the source and CUPTI's headers) and loads
        the collector."""
        if cls._lib is not None:
            return cls._lib
        import ctypes
        import hashlib
        from repro_torch.kernels import build
        cupti = Path(cls.libcupti()).resolve()
        heads = [cupti.parents[1] / "include",
                 Path("/usr/local/cuda/extras/CUPTI/include"),
                 Path("/usr/local/cuda/include")]
        inc = next((h for h in heads if (h / "cupti.h").exists()), None)
        require(inc is not None, f"cupti.h not found in {heads}")
        src = ROOT / "tools" / "device_trace.cpp"
        key = hashlib.sha256(src.read_bytes() + str(inc).encode())
        out = ROOT / "build" / "device_trace" / key.hexdigest()[:16]
        so = out / "libdevice_trace.so"
        if not so.exists():
            out.mkdir(parents=True, exist_ok=True)
            cmd = [build._nvcc(), "-shared", "-O2", "-std=c++17",
                   "-cudart", "none", "-Xcompiler", "-fPIC", f"-I{inc}",
                   str(src), "-o", str(so) + ".tmp", "-ldl"]
            done = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            require(done.returncode == 0, f"building {src.name} failed: "
                    f"{done.stdout}{done.stderr}")
            Path(str(so) + ".tmp").rename(so)
        lib = ctypes.CDLL(str(so))
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.repro_trace_start.argtypes = [ctypes.c_char_p]
        lib.repro_trace_lost.restype = ctypes.c_uint64
        lib.repro_trace_entry.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                          ctypes.c_size_t, u64p, u64p]
        lib.repro_trace_entry.restype = None
        cls._lib = lib
        return lib

    def __init__(self, torch):
        self.torch = torch
        self.us, self.count = {}, {}

    def __enter__(self):
        self.torch.cuda.synchronize()
        rc = self.library().repro_trace_start(self.libcupti().encode())
        require(rc == 0, f"the CUPTI collector did not start (code {rc})")
        return self

    def __exit__(self, *exc):
        import ctypes
        self.torch.cuda.synchronize()
        lib = self.library()
        n = lib.repro_trace_stop()
        require(n >= 0 and lib.repro_trace_lost() == 0,
                f"the CUPTI collector lost records (names {n}, lost "
                f"{lib.repro_trace_lost()})")
        name = ctypes.create_string_buffer(8192)
        count, ns = ctypes.c_uint64(), ctypes.c_uint64()
        for i in range(n):
            lib.repro_trace_entry(i, name, len(name), ctypes.byref(count),
                                  ctypes.byref(ns))
            key = name.value.decode(errors="replace")
            self.us[key] = self.us.get(key, 0.0) + ns.value / 1e3
            self.count[key] = self.count.get(key, 0) + count.value
        return False

    @property
    def n_kernels(self):
        return sum(self.count.values())

    @property
    def busy_s(self):
        return sum(self.us.values()) / 1e6

    def kernels(self, *parts):
        """Records whose name holds one of ``parts``."""
        return sum(c for n, c in self.count.items()
                   if any(part in n for part in parts))


def profile_call(torch, run, label, warm_wall, top=6):
    """One more warm call (``run()``) under ``DeviceTrace``.  Prints the
    card's busy time (kernels, copies and sets), its share of this call's
    wall time and of ``warm_wall``, the kernels that take the most device
    time, and the seconds the trace took to start and, after the call, to
    stop.  The ``sgl_prox`` kernels CUPTI saw on the card, graph replays
    included, must equal the wrapper's launch count for the same call.
    Returns (idle share, run's result, the ``DeviceTrace``, the launch
    counts of the call)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t_start = time.perf_counter()
    with DeviceTrace(torch) as dev:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stop = time.perf_counter() - t0 - wall
    note_wall(wall)
    counts = ops.launch_counts()
    counted = counts["sgl_prox"]
    n_prox = dev.kernels("sgl_prox_flat_kernel")
    busy = dev.busy_s
    say(f"[{label}] sgl_prox kernels seen by CUPTI {n_prox}, launches "
        f"counted by the wrapper {counted}")
    require(busy <= wall, f"{label}: device busy {busy:.3f} s over a "
            f"{wall:.3f} s wall on one stream (CUPTI's timestamps not in "
            f"ns: a torch.profiler run with CUDA activity came first?)")
    require(n_prox == counted > 0, f"{label}: CUPTI saw {n_prox} sgl_prox "
            f"kernels, the wrapper counted {counted}")
    say(f"[{label}] wall {wall:.3f} s (traced); device kernels, copies and "
        f"sets {dev.n_kernels}, device busy {busy:.3f} s; idle share "
        f"{1 - busy / wall:.4f} of this wall, {1 - busy / warm_wall:.4f} of "
        f"the untraced warm wall {warm_wall:.3f} s; the trace's start "
        f"{t0 - t_start:.3f} s, stop {stop:.3f} s")
    for name, us in sorted(dev.us.items(), key=lambda kv: -kv[1])[:top]:
        say(f"[{label}]   {us / 1e3:10.3f} ms  {name[:100]}")
    return 1 - busy / warm_wall, out, dev, counts


class ScreenRanges:
    """Inside the block, every call of ``screening._grid_group_stats`` (the
    grid screen's group statistics) is counted (``calls``) and runs under a
    function mode that records each torch function it calls with the
    shapes of its tensor inputs (``ops``: (name, shapes)).  A function
    mode, not a dispatch mode: the first dispatch mode of a process
    imports ``torch._dynamo`` (seconds) inside the traced call."""

    def __init__(self, torch):
        self.torch = torch
        self.calls, self.ops = 0, []

    def __enter__(self):
        from torch.overrides import TorchFunctionMode
        from torch.utils._pytree import tree_leaves
        from repro_torch.core import screening
        Tensor, ops = self.torch.Tensor, self.ops

        class Record(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                ops.append((getattr(func, "__name__", repr(func)), [
                    tuple(a.shape) for a in tree_leaves((args, kwargs))
                    if isinstance(a, Tensor)]))
                return func(*args, **kwargs)

        self.mod = screening
        self.orig = orig = screening._grid_group_stats

        def ranged(*args, **kw):
            self.calls += 1
            with Record():
                return orig(*args, **kw)

        screening._grid_group_stats = ranged
        return self

    def __exit__(self, *exc):
        self.mod._grid_group_stats = self.orig


def require_fused_screen(dev, ranges, res, counts, spec, label,
                         per_screen=1):
    """In a traced call of the float32 SGL path run under ``ScreenRanges``:
    the ``screen_norms`` kernels CUPTI saw on the card (``dev``) equal the
    wrapper's launches and ``per_screen`` times
    ``EngineStats.n_pallas_screens`` (and the screen's calls; 2 under
    Gap-Safe: TLFre's grid and the Gap-Safe center row), and no operator
    inside the screen's group statistics took a tensor of the padded layout
    (., G, n_max): no gather or mask built a padded copy of the screen
    GEMM's output."""
    G, n_max = spec.pad_index.shape
    n_dev = dev.kernels("screen_norms_small", "screen_norms_large")
    padded = sorted({name for name, shapes in ranges.ops
                     if any(len(sh) == 3 and list(sh[1:]) == [G, n_max]
                            for sh in shapes)})
    say(f"[{label}] screen_norms kernels seen by CUPTI {n_dev}, launches "
        f"counted {counts['screen_norms']}, n_pallas_screens "
        f"{res.stats.n_pallas_screens}, screen calls {ranges.calls}; "
        f"operators in the screen's group statistics "
        f"{sorted({name for name, _ in ranges.ops})}; of them on a (., {G}, "
        f"{n_max}) tensor: {padded or 'none'}")
    require(n_dev == counts["screen_norms"]
            == per_screen * res.stats.n_pallas_screens == ranges.calls > 0,
            f"{label}: screen_norms kernels {n_dev}, launches "
            f"{counts['screen_norms']}, {per_screen} x n_pallas_screens "
            f"{res.stats.n_pallas_screens}, screen calls {ranges.calls}: "
            f"not all equal")
    require(not padded, f"{label}: the screen built a padded copy ({padded})")


def graph_vs_eager(torch, T, calls, label):
    """The graphed FISTA block against the eager ``fista_sgl`` (kernel prox)
    on the recorded longest solve of a real segment: equal iteration
    counts, betas within 1e-6 * max|beta|, whether they are bitwise equal;
    and the host time per iteration of each, cold (capturing) and warm."""
    from repro_torch.core.path_engine import _padded_prox
    its, args, kw = calls.longest
    kw = {k: v for k, v in kw.items() if k != "graphs"}
    spec = args[2]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        note_wall(time.perf_counter() - t0)
        return out, CALL_WALLS[-1]

    eager, t_eager = timed(lambda: T.fista_sgl(*args, prox=_padded_prox(spec),
                                               **kw))
    graphs = {}
    cold, t_cold = timed(lambda: T.fista_sgl_graphed(*args, graphs=graphs,
                                                     **kw))
    warm, t_warm = timed(lambda: T.fista_sgl_graphed(*args, graphs=graphs,
                                                     **kw))
    scale = float(eager.beta.abs().max())
    dbeta = max(float((b.beta - eager.beta).abs().max()) for b in (cold, warm))
    bitwise = all(torch.equal(b.beta, eager.beta) for b in (cold, warm))
    X_sub = args[0]
    say(f"[{label}] graph vs eager on a segment row (X_sub "
        f"{tuple(X_sub.shape)}, g_b {spec.num_groups}, n_max "
        f"{spec.max_size}): iterations eager {eager.iters} graphed "
        f"{cold.iters}/{warm.iters} (path {its}); max|beta_graph - "
        f"beta_eager| = {dbeta:.3e} (bound 1e-6 * max|beta| = "
        f"{1e-6 * scale:.3e}); bitwise equal {bitwise}; host us per "
        f"iteration eager {1e6 * t_eager / eager.iters:.2f} graphed cold "
        f"(capture) {1e6 * t_cold / cold.iters:.2f} warm "
        f"{1e6 * t_warm / warm.iters:.2f}; captures {len(graphs)}")
    require(eager.iters == cold.iters == warm.iters == its,
            f"{label}: graph and eager iteration counts differ")
    require(dbeta <= 1e-6 * scale, f"{label}: graph and eager betas differ")
    require(len(graphs) == 1, f"{label}: the warm solve captured")


def sgl_objectives(X, y, betas, lambdas, G, n, alpha=1.0):
    """Primal SGL objective of each row, in float64 on the host, for G
    uniform groups of n with the paper's weights sqrt(n)."""
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    B = np.asarray(betas, dtype=np.float64)
    resid = y64[None, :] - B @ X64.T
    pen = (alpha * np.sqrt(n) * np.linalg.norm(B.reshape(len(B), G, n),
                                               axis=2).sum(axis=1)
           + np.abs(B).sum(axis=1))
    return 0.5 * (resid * resid).sum(axis=1) + np.asarray(lambdas) * pen


def main_path(torch, T, N=250, G=1000, n=10):
    from repro_torch.data_synth import synthetic_sgl
    X, y, _ = synthetic_sgl(1, N=N, G=G, n=n, gamma1=0.1, gamma2=0.1, seed=1)
    plan = T.Plan(alpha=1.0, n_lambdas=100, tol=1e-6, safety=1e-6,
                  max_iter=6000, check_every=50)
    sess = T.SGLSession(T.Problem.sgl(X, y, [n] * G))       # cuda, float32
    require(sess.problem.device.type == "cuda", "problem is not on the card")
    res, counts, wall, calls = run_path(torch, sess, plan, "synthetic1-f32")
    require_kernel_route(res, counts, "synthetic1-f32")
    require_graph_route(res, counts, calls, "synthetic1-f32")
    require(res.betas.shape == (100, n * G), "wrong beta shape")

    sess64 = T.SGLSession(T.Problem.sgl(X.astype(np.float64),
                                        y.astype(np.float64), [n] * G,
                                        dtype=torch.float64))
    res64, counts64, _, _ = run_path(torch, sess64, plan, "synthetic1-f64")
    require(sum(counts64.values()) == 0 and
            res64.stats.n_pallas_screens == 0,
            "the float64 path engaged a float32 kernel")
    # Both paths certify every row: the f64 one at relative gap 1e-6, the
    # f32 one at its 64-ulp floor (7.6e-6).  So the two primal objectives
    # (evaluated in float64) differ by at most the sum of the two gaps, and
    # the betas by O(sqrt(relative gap)) * max|beta| (sqrt(7.6e-6) = 2.8e-3;
    # the bound keeps a factor 3.6 of headroom).
    tol32 = max(plan.tol, 64 * EPS32)
    gap_scale = 0.5 * float(np.dot(y.astype(np.float64), y))
    dobj = np.abs(sgl_objectives(X, y, res.betas, res.lambdas, G, n)
                  - sgl_objectives(X, y, res64.betas, res.lambdas, G, n))
    certified = (res.iters < plan.max_iter) & (res64.iters < plan.max_iter)
    obj_bound = 1.01 * (tol32 + plan.tol) * gap_scale
    dbeta = float(np.abs(res.betas - res64.betas).max())
    dbound = 1e-2 * float(np.abs(res64.betas).max())
    say(f"[synthetic1] max|P(beta_f32) - P(beta_f64)| = "
        f"{float(dobj[certified].max()):.3e} over {int(certified.sum())} "
        f"certified rows (bound (tol32 + tol64) * 0.5|y|^2 = "
        f"{obj_bound:.3e}); max|beta_f32 - beta_f64| = {dbeta:.3e} (bound "
        f"1e-2 * max|beta_f64| = {dbound:.3e}); lambda grids max rel diff "
        f"{float(np.abs(res.lambdas / res64.lambdas - 1).max()):.3e}")
    require(bool((dobj[certified] <= obj_bound).all()),
            "f32 kernel path's objectives disagree with the f64 path's")
    require(dbeta <= dbound, "f32 kernel path disagrees with the f64 path")
    worst, n_disc = screen_discards_are_zero(torch, T, sess.problem, res,
                                             res64.betas, 1.0, 1e-6)
    say(f"[synthetic1] f32 kernel screen discarded {n_disc} feature-lambda "
        f"pairs; max |beta_f64| over them = {worst:.3e} (must be <= 1e-6)")
    require(n_disc > 0 and worst <= 1e-6,
            "the f32 screen discarded a feature active in the f64 solution")

    n_captures = len(sess.fista_graphs)
    require(0 < n_captures <= res.stats.n_compilations,
            "captures do not coincide with counted compilations")
    warm, counts_w, warm_wall, calls_w = run_path(torch, sess, plan,
                                                  "synthetic1-f32-warm")
    require(warm.stats.n_compilations == 0, "warm call paid compilations")
    require(len(sess.fista_graphs) == n_captures,
            "the warm call captured a graph")
    require_graph_route(warm, counts_w, calls_w, "synthetic1-f32-warm")
    with ScreenRanges(torch) as ranges:
        idle, res_p, dev, counts_p = profile_call(
            torch, lambda: sess.path(plan), "synthetic1-f32-profiled",
            warm_wall)
    require_fused_screen(dev, ranges, res_p, counts_p, sess.problem.spec,
                         "synthetic1-f32-profiled")
    say(f"[synthetic1] warm wall {warm_wall:.3f} s, idle share {idle:.4f}")
    graph_vs_eager(torch, T, calls, "synthetic1")
    from repro_torch.core.path_engine import _pow2_len
    # the first screen's grid: the lambdas below lambda_max, padded to a
    # power of two (99 -> 128); the prox bucket that ran the most iterations
    shapes = {"L": _pow2_len(len(res.lambdas) - 1),
              "bucket_spec": calls.busiest_spec}
    return sess, res, counts, shapes, res64


def ragged_path(torch, T, N=747, p=100_000):
    from repro_torch.data_synth import ragged_sizes
    sizes = ragged_sizes(p, avg=4.5, seed=0)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, p)).astype(np.float32)
    beta = np.zeros(p, np.float32)
    hot = rng.choice(p, 60, replace=False)
    beta[hot] = rng.standard_normal(60)
    y = (X @ beta + 0.01 * rng.standard_normal(N)).astype(np.float32)
    sess = T.SGLSession(T.Problem.sgl(X, y, sizes))
    require(sess.problem.spec.max_size == 9, "ragged n_max is not 9")
    plan = T.Plan(alpha=1.0, n_lambdas=8, tol=1e-6, safety=1e-6,
                  max_iter=6000, check_every=50, specnorm_method="frobenius")
    res, counts, _, calls = run_path(torch, sess, plan, "table2-ragged-f32")
    require_kernel_route(res, counts, "table2-ragged-f32")
    require_graph_route(res, counts, calls, "table2-ragged-f32")
    return sess, res, counts, calls.busiest_spec


# ---------------------------------------------------------------------------
# phase 5: the nonnegative-Lasso path (paper Table 3)
# ---------------------------------------------------------------------------

def nn_objectives(X, y, betas, lambdas):
    """Primal nonnegative-Lasso objective of each row, float64 on the
    host."""
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    B = np.asarray(betas, dtype=np.float64)
    resid = y64[None, :] - B @ X64.T
    return (0.5 * (resid * resid).sum(axis=1)
            + np.asarray(lambdas) * B.sum(axis=1))


def dpc_discards_are_zero(torch, T, prob32, res32, betas64, safety, *,
                          screen="dpc"):
    """Sequential f32 DPC screen at every lambda from the f32 path's
    certified dual at the previous lambda (``screen='gapsafe'``: intersected
    with the Gap-Safe ball around that dual); every discarded feature must
    be zero (|beta| <= 1e-6) in the float64 solution."""
    from repro_torch.core.screening import gap_safe_grid_radii
    X, y = prob32.X, prob32.y
    xty = X.T @ y
    lam_max_t, i_star = T.lambda_max_nn(xty)
    lam_max = float(lam_max_t)
    col_n = T.column_norms(X)
    lambdas = res32.lambdas
    worst, n_discarded = 0.0, 0
    for j in range(1, len(lambdas)):
        lam_bar = float(lambdas[j - 1])
        beta = torch.as_tensor(res32.betas[j - 1], dtype=X.dtype,
                               device=X.device)
        if lam_bar >= lam_max * (1.0 - 1e-12):
            theta = y / lam_max
            beta = torch.zeros_like(beta)
        else:
            rho = (y - X @ beta) / lam_bar
            theta = T.dual_scaling_nn(X.T @ rho) * rho
        n_vec = T.normal_vector_nn(X, y, lam_bar, lam_max, theta, i_star)
        lam = torch.as_tensor([lambdas[j]], dtype=X.dtype, device=X.device)
        fk, _ = T.dpc_screen_grid(X, y, lam, theta, n_vec, col_n,
                                  safety=safety)
        if screen == "gapsafe":
            radii = gap_safe_grid_radii(y, lam, theta, y - X @ beta,
                                        torch.sum(beta)) * (1.0 + safety)
            fk = fk & T.gap_safe_screen_grid_nn(X.T @ theta, radii, col_n)
        dropped = ~fk[0].cpu().numpy()
        n_discarded += int(dropped.sum())
        if dropped.any():
            worst = max(worst, float(np.abs(betas64[j][dropped]).max()))
    return worst, n_discarded


def compare_paths(res, res64, plan, objectives, label):
    """The float32 path against the float64 one: objectives within the sum
    of the two certified gaps, betas within 1e-2 * max|beta|."""
    tol32 = max(plan.tol, 64 * EPS32)
    dobj = np.abs(objectives(res.betas) - objectives(res64.betas))
    certified = (res.iters < plan.max_iter) & (res64.iters < plan.max_iter)
    gap_scale = objectives.gap_scale
    obj_bound = 1.01 * (tol32 + plan.tol) * gap_scale
    dbeta = float(np.abs(res.betas - res64.betas).max())
    dbound = 1e-2 * float(np.abs(res64.betas).max())
    say(f"[{label}] max|P(beta_f32) - P(beta_f64)| = "
        f"{float(dobj[certified].max()):.3e} over {int(certified.sum())} "
        f"certified rows (bound (tol32 + tol64) * 0.5|y|^2 = "
        f"{obj_bound:.3e}); max|beta_f32 - beta_f64| = {dbeta:.3e} (bound "
        f"1e-2 * max|beta_f64| = {dbound:.3e})")
    require(int(certified.sum()) > 0, f"{label}: no certified row")
    require(bool((dobj[certified] <= obj_bound).all()),
            f"{label}: f32 objectives disagree with the f64 path's")
    require(dbeta <= dbound, f"{label}: f32 path disagrees with the f64 path")


def nn_path(torch, T, N=250, p=10_000):
    from repro_torch.data_synth import synthetic_nn
    X, y, _ = synthetic_nn(1, N=N, p=p, seed=1)
    plan = T.Plan(n_lambdas=100, tol=1e-6, safety=1e-6, max_iter=6000,
                  check_every=50)
    sess = T.SGLSession(T.Problem.nn_lasso(X, y))           # cuda, float32
    require(sess.problem.device.type == "cuda", "problem is not on the card")
    res, counts, _, _ = run_path(torch, sess, plan, "table3-nn-f32")
    require(counts["xtv"] > 0, "table3-nn-f32: xtv was not launched")
    require(sum(counts.values()) == counts["xtv"],
            "table3-nn-f32: a kernel other than xtv was launched")
    require(res.betas.shape == (100, p) and (res.betas >= 0).all(),
            "table3-nn-f32: wrong shape or a negative coefficient")
    sess64 = T.SGLSession(T.Problem.nn_lasso(
        X.astype(np.float64), y.astype(np.float64), dtype=torch.float64))
    res64, counts64, _, _ = run_path(torch, sess64, plan, "table3-nn-f64")
    require(sum(counts64.values()) == 0,
            "the float64 path engaged a float32 kernel")

    def objectives(betas):
        return nn_objectives(X, y, betas, res.lambdas)
    objectives.gap_scale = 0.5 * float(np.dot(y.astype(np.float64), y))
    compare_paths(res, res64, plan, objectives, "table3-nn")
    worst, n_disc = dpc_discards_are_zero(torch, T, sess.problem, res,
                                          res64.betas, plan.safety)
    say(f"[table3-nn] f32 DPC screen discarded {n_disc} feature-lambda "
        f"pairs; max |beta_f64| over them = {worst:.3e} (must be <= 1e-6)")
    require(n_disc > 0 and worst <= 1e-6,
            "the f32 DPC screen discarded a feature active in the f64 "
            "solution")
    return counts, res64


# ---------------------------------------------------------------------------
# phases 6-7: fold-batched cross-validation
# ---------------------------------------------------------------------------

class LaunchShapes:
    """Records the argument shapes of every launch of one kernel wrapper
    inside the block.  The wrapper itself still counts each launch."""

    def __init__(self, module, name):
        self.module, self.name, self.shapes = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def recorded(*args):
            self.shapes.append(tuple(tuple(a.shape) for a in args))
            return self.orig(*args)

        setattr(self.module, self.name, recorded)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class LaunchArgs:
    """Keeps the arguments of one call of a kernel's CUDA function inside
    the block, by reference (no copy, so nothing is added to a graph being
    captured): the first call, or with ``largest`` the call whose first
    argument has the most elements."""

    def __init__(self, module, name, largest=False):
        self.module, self.name, self.largest = module, name, largest
        self.args = None

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def recorded(*args):
            if self.args is None or (self.largest and args[0].numel()
                                     > self.args[0].numel()):
                self.args = args
            return self.orig(*args)

        setattr(self.module, self.name, recorded)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def run_cv(torch, sess, plan, label):
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with GraphedSolves() as calls:
        t0 = time.perf_counter()
        res = sess.cv(plan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    note_wall(wall)
    counts = ops.launch_counts()
    st = res.stats
    say(f"[{label}] wall {wall:.3f} s = setup {res.setup_time:.3f} + screen "
        f"{res.screen_time:.3f} + solve {res.solve_time:.3f} s (+ host "
        f"{wall - res.total_time:.3f}); K {len(res.folds)} n_segments "
        f"{st.n_segments} n_screens {st.n_screens} n_pallas_screens "
        f"{st.n_pallas_screens} n_compilations {st.n_compilations} "
        f"n_rejected {st.n_rejected} fold_sweeps "
        f"{[int(v) for v in st.fold_sweeps]} iters "
        f"{int(res.fold_iters.sum())} (accepted rows) fista iterations run "
        f"{st.fista_iters} (graphed {calls.iters}); solve "
        f"{1e6 * res.solve_time / max(st.fista_iters, 1):.2f} us per "
        f"iteration; kept features (summed over folds and rows) "
        f"{int(res.kept_features.sum())}; graphs captured "
        f"{len(sess.fista_graphs)} (in the session); best_index "
        f"{res.best_index} index_1se "
        f"{res.index_1se} launches {json.dumps(counts)}")
    require(np.isfinite(res.fold_betas).all() and
            np.isfinite(res.mean_mse).all(), f"{label}: non-finite result")
    return res, counts, wall, calls


def require_fold_route(res, counts, label, fold_kernel, others):
    st = res.stats
    require(st.n_pallas_screens == st.n_screens > 0,
            f"{label}: not every stacked screen went through the kernels")
    require(counts[fold_kernel] == st.n_screens,
            f"{label}: {fold_kernel} launches {counts[fold_kernel]} != "
            f"stacked screens {st.n_screens}")
    for name in others:
        require(counts[name] > 0, f"{label}: kernel {name} was not launched")
    for name in set(counts) - set(others) - {fold_kernel}:
        require(counts[name] == 0, f"{label}: kernel {name} was launched")


def compare_cv(res, res64, label):
    """The float32 CV against the float64 one on the same folds and grid:
    per-fold betas within 1e-2 * max|beta|, mean MSE within 1e-2
    relative, the selected index within one grid step."""
    require(all((a[1] == b[1]).all() for a, b in zip(res.folds,
                                                    res64.folds)),
            f"{label}: the folds differ")
    dbeta = float(np.abs(res.fold_betas - res64.fold_betas).max())
    dbound = 1e-2 * float(np.abs(res64.fold_betas).max())
    dmse = float(np.max(np.abs(res.mean_mse - res64.mean_mse)
                        / np.abs(res64.mean_mse)))
    say(f"[{label}] max|beta_f32 - beta_f64| over folds = {dbeta:.3e} "
        f"(bound {dbound:.3e}); max rel |mean_mse_f32 - mean_mse_f64| = "
        f"{dmse:.3e} (bound 1e-2); best_index f32 {res.best_index} f64 "
        f"{res64.best_index}")
    require(dbeta <= dbound, f"{label}: f32 betas disagree with f64")
    require(dmse <= 1e-2, f"{label}: f32 mean MSE disagrees with f64")
    require(abs(res.best_index - res64.best_index) <= 1,
            f"{label}: best_index more than one grid step from f64")


CV_PLAN = dict(alpha=1.0, n_lambdas=100, n_folds=5, seed=0, tol=3e-6,
               safety=1e-5, max_iter=6000, check_every=50)


def sgl_cv_phase(torch, T, N=250, G=1000, n=10):
    from repro_torch.data_synth import synthetic_sgl
    from repro_torch.kernels import screen_norms_folds as snf
    X, y, _ = synthetic_sgl(1, N=N, G=G, n=n, gamma1=0.1, gamma2=0.1, seed=1)
    plan = T.Plan(**CV_PLAN)
    sess = T.SGLSession(T.Problem.sgl(X, y, [n] * G))       # cuda, float32
    with LaunchShapes(snf, "screen_norms_folds_cuda") as shapes:
        res, counts, _, calls = run_cv(torch, sess, plan, "sgl-cv-f32")
    require_fold_route(res, counts, "sgl-cv-f32", "screen_norms_folds",
                       ("sgl_prox", "xtv"))
    require_graph_route(res, counts, calls, "sgl-cv-f32")
    n_captures = len(sess.fista_graphs)
    require(res.fold_betas.shape == (5, 100, n * G), "wrong fold_betas shape")
    warm, counts_w, warm_wall, calls_w = run_cv(torch, sess, plan,
                                                "sgl-cv-f32-warm")
    require(warm.stats.n_compilations == 0, "warm CV paid compilations")
    require(len(sess.fista_graphs) == n_captures,
            "the warm CV captured a graph")
    require_fold_route(warm, counts_w, "sgl-cv-f32-warm",
                       "screen_norms_folds", ("sgl_prox", "xtv"))
    require_graph_route(warm, counts_w, calls_w, "sgl-cv-f32-warm")
    idle = profile_call(torch, lambda: sess.cv(plan), "sgl-cv-f32-profiled",
                        warm_wall)[0]
    say(f"[sgl-cv] warm wall {warm_wall:.3f} s, idle share {idle:.4f}")
    sess64 = T.SGLSession(T.Problem.sgl(X.astype(np.float64),
                                        y.astype(np.float64), [n] * G,
                                        dtype=torch.float64))
    res64, counts64, _, _ = run_cv(torch, sess64, plan, "sgl-cv-f64")
    require(sum(counts64.values()) == 0 and res64.stats.n_pallas_screens == 0,
            "the float64 CV engaged a float32 kernel")
    compare_cv(res, res64, "sgl-cv")
    centred = plan.with_(center="per-fold", n_lambdas=20)
    resc, counts_c, _, calls_c = run_cv(torch, sess, centred,
                                        "sgl-cv-f32-per-fold")
    require_fold_route(resc, counts_c, "sgl-cv-f32-per-fold",
                       "screen_norms_folds", ("sgl_prox", "xtv"))
    require_graph_route(resc, counts_c, calls_c, "sgl-cv-f32-per-fold")
    require(bool((resc.fold_iters < centred.max_iter).all()),
            "sgl-cv-f32-per-fold: a row ran to max_iter (not certified)")
    return counts, shapes.shapes[0]


def nn_cv_phase(torch, T, N=250, p=10_000):
    from repro_torch.data_synth import synthetic_nn
    from repro_torch.kernels import dpc_screen_folds as dsf
    X, y, _ = synthetic_nn(1, N=N, p=p, seed=1)
    plan = T.Plan(**CV_PLAN)
    sess = T.SGLSession(T.Problem.nn_lasso(X, y))           # cuda, float32
    with LaunchShapes(dsf, "dpc_screen_folds_cuda") as shapes:
        res, counts, _, _ = run_cv(torch, sess, plan, "nn-cv-f32")
    require_fold_route(res, counts, "nn-cv-f32", "dpc_screen_folds",
                       ("xtv",))
    sess64 = T.SGLSession(T.Problem.nn_lasso(
        X.astype(np.float64), y.astype(np.float64), dtype=torch.float64))
    res64, counts64, _, _ = run_cv(torch, sess64, plan, "nn-cv-f64")
    require(sum(counts64.values()) == 0,
            "the float64 CV engaged a float32 kernel")
    compare_cv(res, res64, "nn-cv")
    return counts, shapes.shapes[0]


# ---------------------------------------------------------------------------
# phases 8-13: the Gap-Safe screen, adaptive weights, the logistic path
# ---------------------------------------------------------------------------

def spec_objectives(X, y, spec, alpha, lambdas, loss="squared"):
    """Primal objective of each row of ``betas``, in float64 on the host,
    for ``spec``'s (possibly weighted) SGL penalty and the loss;
    ``.gap_scale`` is the loss's (0.5|y|^2, or N log 2 for logistic)."""
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    gid = spec.group_ids.cpu().numpy()
    w = spec.weights.cpu().numpy()
    fw = (np.ones(X.shape[1]) if spec.feature_weights is None
          else spec.feature_weights.cpu().numpy())
    G = spec.num_groups

    def objectives(betas):
        B = np.asarray(betas, dtype=np.float64)
        U = B @ X64.T
        if loss == "squared":
            f = 0.5 * ((y64[None, :] - U) ** 2).sum(axis=1)
        else:
            f = (np.logaddexp(0.0, U) - y64[None, :] * U).sum(axis=1)
        gn = np.sqrt(np.stack([np.bincount(gid, weights=b * b, minlength=G)
                               for b in B]))
        return f + np.asarray(lambdas) * (alpha * gn @ w + np.abs(B) @ fw)
    objectives.gap_scale = (0.5 * float(y64 @ y64) if loss == "squared"
                            else len(y64) * np.log(2.0))
    return objectives


def require_no_kernel(counts, label):
    require(sum(counts.values()) == 0,
            f"{label}: a kernel was launched ({counts}); this route runs "
            f"none")


def require_xtv_only(res, counts, calls, label):
    """The feature-weighted float32 route: ``xtv`` certifies every SGL row
    solved, and no other kernel runs (the fused prox and screen statistics
    take one l1 threshold), nor does any graphed solve."""
    require(counts["xtv"] == calls.rows > 0 and calls.solves == 0,
            f"{label}: xtv launches {counts['xtv']}, rows solved "
            f"{calls.rows} (graphed {calls.solves})")
    require(sum(counts.values()) == counts["xtv"],
            f"{label}: a kernel other than xtv was launched ({counts})")
    require(res.stats.n_pallas_screens == 0,
            f"{label}: a screen took the fused statistics")


def require_discards(torch, T, sess32, res32, res64, plan, label, **kw):
    """The f32 sequential screen's discards are zero in float64; returns
    the per-row (TLFre kept, kept) pairs."""
    kept = []
    worst, n_disc = screen_discards_are_zero(
        torch, T, sess32.problem, res32, res64.betas, plan.alpha,
        plan.safety, kept=kept, **kw)
    say(f"[{label}] f32 screen discarded {n_disc} feature-lambda pairs; "
        f"max |beta_f64| over them = {worst:.3e} (must be <= 1e-6)")
    require(n_disc > 0 and worst <= 1e-6,
            f"{label}: the f32 screen discarded a feature active in the "
            f"f64 solution")
    return kept


def warm_call(torch, sess, plan, label, verb="path"):
    """The same call again on the same session: it must pay no new
    compilation and capture no graph.  Returns its wall time."""
    n_captures = len(sess.fista_graphs)
    run = run_path if verb == "path" else run_cv
    res, _, wall, _ = run(torch, sess, plan, f"{label}-warm")
    require(res.stats.n_compilations == 0 and
            len(sess.fista_graphs) == n_captures,
            f"{label}-warm: compiled or captured")
    say(f"[{label}] warm wall {wall:.3f} s")
    return wall


def f64_session(torch, T, X, y, sizes, loss="squared"):
    make = T.Problem.sgl if loss == "squared" else T.Problem.sgl_logistic
    return T.SGLSession(make(X.astype(np.float64), y.astype(np.float64),
                             sizes, dtype=torch.float64))


CALL_WALLS = []          # the wall of every call timed so far, s


def note_wall(wall):
    CALL_WALLS.append(wall)


@contextlib.contextmanager
def timed_phase(label):
    """Prints the phase's seconds when it ends, beside the summed walls of
    the calls it timed (``note_wall``) and the rest, spent outside them:
    data, sessions, checks, the tracers' start and stop."""
    t0 = time.perf_counter()
    n0 = len(CALL_WALLS)
    yield
    total = time.perf_counter() - t0
    walls = sum(CALL_WALLS[n0:])
    say(f"[{label}] phase seconds {total:.3f}; call walls {walls:.3f} s over "
        f"{len(CALL_WALLS) - n0} calls; outside them {total - walls:.3f} s")


def gapsafe_path_phase(torch, T, res_tlfre, N=250, G=1000, n=10):
    """Phase 3's data and plan with ``screen='gapsafe'``: the float32 path
    on the kernel route (two ``screen_norms`` launches a screen, one
    ``sgl_prox`` per FISTA iteration, one ``xtv`` per row solved), a warm
    call, a profiled warm call (2 x ``n_pallas_screens`` fused screen
    kernels), the float64 reference and the bars."""
    from repro_torch.data_synth import synthetic_sgl
    X, y, _ = synthetic_sgl(1, N=N, G=G, n=n, gamma1=0.1, gamma2=0.1, seed=1)
    plan = T.Plan(alpha=1.0, n_lambdas=100, tol=1e-6, safety=1e-6,
                  max_iter=6000, check_every=50, screen="gapsafe")
    sess = T.SGLSession(T.Problem.sgl(X, y, [n] * G))
    res, counts, _, calls = run_path(torch, sess, plan, "gapsafe-sgl-f32")
    require_kernel_route(res, counts, "gapsafe-sgl-f32")
    require_graph_route(res, counts, calls, "gapsafe-sgl-f32")
    st = res.stats
    require(counts["screen_norms"] == 2 * st.n_pallas_screens,
            f"gapsafe-sgl-f32: screen_norms launches {counts['screen_norms']}"
            f" != 2 x n_pallas_screens {st.n_pallas_screens}")
    require(counts["xtv"] == calls.solves,
            f"gapsafe-sgl-f32: xtv launches {counts['xtv']} != rows solved "
            f"{calls.solves}")
    n_captures = len(sess.fista_graphs)
    warm, counts_w, warm_wall, calls_w = run_path(torch, sess, plan,
                                                  "gapsafe-sgl-f32-warm")
    require(warm.stats.n_compilations == 0 and
            len(sess.fista_graphs) == n_captures,
            "gapsafe-sgl-f32-warm: compiled or captured")
    require_graph_route(warm, counts_w, calls_w, "gapsafe-sgl-f32-warm")
    with ScreenRanges(torch) as ranges:
        idle, res_p, dev, counts_p = profile_call(
            torch, lambda: sess.path(plan), "gapsafe-sgl-f32-profiled",
            warm_wall)
    require_fused_screen(dev, ranges, res_p, counts_p, sess.problem.spec,
                         "gapsafe-sgl-f32-profiled", per_screen=2)
    say(f"[gapsafe-sgl] warm wall {warm_wall:.3f} s, idle share {idle:.4f}, "
        f"n_rejected {st.n_rejected}")
    sess64 = f64_session(torch, T, X, y, [n] * G)
    res64, counts64, _, _ = run_path(torch, sess64, plan, "gapsafe-sgl-f64")
    require_no_kernel(counts64, "gapsafe-sgl-f64")
    compare_paths(res, res64, plan, spec_objectives(
        X, y, sess.problem.spec, 1.0, res.lambdas), "gapsafe-sgl")
    kept = require_discards(torch, T, sess, res, res64, plan, "gapsafe-sgl",
                            screen="gapsafe")
    n_tl, n_ball, n_gs = (sum(k[i] for k in kept) for i in range(3))
    say(f"[gapsafe-sgl] sequential screens keep, summed over rows: TLFre "
        f"{n_tl}, the Gap-Safe ball alone {n_ball}, TLFre and Gap-Safe "
        f"{n_gs} (rows where Gap-Safe discards more than TLFre alone: "
        f"{sum(k[2] < k[0] for k in kept)}); solver columns summed over "
        f"the path: TLFre path {int(res_tlfre.kept_features.sum())}, "
        f"Gap-Safe path {int(res.kept_features.sum())}")
    require(all(k[2] <= k[0] for k in kept),
            "gapsafe-sgl: Gap-Safe kept more features than TLFre on a row")
    return counts


def weights_phase(torch, T, N=250, G=1000, n=10):
    """Phase 3's data with adaptive weights from ``uniform(0.5, 2.0)`` (seed
    20): group and feature weights under TLFre and Gap-Safe (``xtv`` for
    every row; the prox and the screen statistics run plainly), then
    group weights alone under TLFre (the kernel route of phase 3); each
    with its float64 twin at 20 lambdas against a float32 call on the
    same plan."""
    from repro_torch.data_synth import synthetic_sgl
    X, y, _ = synthetic_sgl(1, N=N, G=G, n=n, gamma1=0.1, gamma2=0.1, seed=1)
    wr = np.random.default_rng(20)
    gw, fw = wr.uniform(0.5, 2.0, G), wr.uniform(0.5, 2.0, G * n)
    base = T.Plan(alpha=1.0, n_lambdas=100, tol=1e-6, safety=1e-6,
                  max_iter=6000, check_every=50)
    sess = T.SGLSession(T.Problem.sgl(X, y, [n] * G))
    sess64 = f64_session(torch, T, X, y, [n] * G)

    def f64_twin(plan, label, **kw):
        # the float64 twin at 20 lambdas (its bars repeat the 100-lambda
        # float32 route's), against a float32 call on the same plan
        plan20 = plan.with_(n_lambdas=20)
        res20 = run_path(torch, sess, plan20, f"{label}-f32-20")[0]
        res64, counts64, _, _ = run_path(torch, sess64, plan20,
                                         f"{label}-f64")
        require_no_kernel(counts64, f"{label}-f64")
        spec = sess._effective(plan)[1]
        compare_paths(res20, res64, plan20, spec_objectives(
            X, y, spec, 1.0, res20.lambdas), label)
        require_discards(torch, T, sess, res20, res64, plan20, label,
                         spec=spec, **kw)

    out = {}
    for screen in ("tlfre", "gapsafe"):
        label = f"weighted-{screen}"
        plan = base.with_(screen=screen, group_weights=gw, feature_weights=fw)
        res, counts, _, calls = run_path(torch, sess, plan, f"{label}-f32")
        require_xtv_only(res, counts, calls, f"{label}-f32")
        say(f"[{label}] n_rejected {res.stats.n_rejected}")
        warm_call(torch, sess, plan, f"{label}-f32")
        f64_twin(plan, label, screen=screen)
        out[label] = counts
    label = "group-weighted"
    plan = base.with_(group_weights=gw)
    res, counts, _, calls = run_path(torch, sess, plan, f"{label}-f32")
    require_kernel_route(res, counts, f"{label}-f32")
    require_graph_route(res, counts, calls, f"{label}-f32")
    warm_call(torch, sess, plan, f"{label}-f32")
    f64_twin(plan, label)
    out[label] = counts
    return out


def gapsafe_nn_path_phase(torch, T, N=250, p=10_000):
    """Phase 5's data and plan with ``screen='gapsafe'``: ``xtv`` only."""
    from repro_torch.data_synth import synthetic_nn
    X, y, _ = synthetic_nn(1, N=N, p=p, seed=1)
    plan = T.Plan(n_lambdas=100, tol=1e-6, safety=1e-6, max_iter=6000,
                  check_every=50, screen="gapsafe")
    sess = T.SGLSession(T.Problem.nn_lasso(X, y))
    res, counts, _, _ = run_path(torch, sess, plan, "gapsafe-nn-f32")
    require(counts["xtv"] > 0 and sum(counts.values()) == counts["xtv"],
            "gapsafe-nn-f32: xtv was not the only kernel launched")
    require((res.betas >= 0).all(), "gapsafe-nn-f32: a negative coefficient")
    say(f"[gapsafe-nn] n_rejected {res.stats.n_rejected}")
    warm_call(torch, sess, plan, "gapsafe-nn-f32")
    sess64 = T.SGLSession(T.Problem.nn_lasso(
        X.astype(np.float64), y.astype(np.float64), dtype=torch.float64))
    res64, counts64, _, _ = run_path(torch, sess64, plan, "gapsafe-nn-f64")
    require_no_kernel(counts64, "gapsafe-nn-f64")

    def objectives(betas):
        return nn_objectives(X, y, betas, res.lambdas)
    objectives.gap_scale = 0.5 * float(np.dot(y.astype(np.float64), y))
    compare_paths(res, res64, plan, objectives, "gapsafe-nn")
    worst, n_disc = dpc_discards_are_zero(torch, T, sess.problem, res,
                                          res64.betas, plan.safety,
                                          screen="gapsafe")
    say(f"[gapsafe-nn] f32 DPC and Gap-Safe screen discarded {n_disc} "
        f"feature-lambda pairs; max |beta_f64| over them = {worst:.3e} "
        f"(must be <= 1e-6)")
    require(n_disc > 0 and worst <= 1e-6,
            "gapsafe-nn: the f32 screen discarded a feature active in the "
            "f64 solution")
    return counts


def gapsafe_sgl_cv_phase(torch, T, N=250, G=1000, n=10):
    """Phase 6's plan with ``screen='gapsafe'``: two ``screen_norms_folds``
    launches a stacked screen (TLFre's K x L rows, Gap-Safe's K rows),
    ``sgl_prox`` on graphed blocks, ``xtv``; cold, warm; float64 against
    float32 at 20 lambdas."""
    from repro_torch.data_synth import synthetic_sgl
    X, y, _ = synthetic_sgl(1, N=N, G=G, n=n, gamma1=0.1, gamma2=0.1, seed=1)
    plan = T.Plan(**CV_PLAN, screen="gapsafe")
    sess = T.SGLSession(T.Problem.sgl(X, y, [n] * G))
    res, counts, _, calls = run_cv(torch, sess, plan, "gapsafe-sgl-cv-f32")
    st = res.stats
    require(st.n_pallas_screens == st.n_screens > 0 and
            counts["screen_norms_folds"] == 2 * st.n_screens,
            f"gapsafe-sgl-cv-f32: screen_norms_folds launches "
            f"{counts['screen_norms_folds']} != 2 x stacked screens "
            f"{st.n_screens}")
    require(counts["sgl_prox"] > 0 and counts["xtv"] > 0 and
            counts["screen_norms"] == counts["dpc_screen_folds"] == 0,
            "gapsafe-sgl-cv-f32: wrong kernels launched")
    require_graph_route(res, counts, calls, "gapsafe-sgl-cv-f32")
    n_captures = len(sess.fista_graphs)
    warm, counts_w, warm_wall, calls_w = run_cv(torch, sess, plan,
                                                "gapsafe-sgl-cv-f32-warm")
    require(warm.stats.n_compilations == 0 and
            len(sess.fista_graphs) == n_captures,
            "gapsafe-sgl-cv-f32-warm: compiled or captured")
    require_graph_route(warm, counts_w, calls_w, "gapsafe-sgl-cv-f32-warm")
    say(f"[gapsafe-sgl-cv] warm wall {warm_wall:.3f} s, n_rejected "
        f"{st.n_rejected}")
    # the float64 twin at 20 lambdas (its bars repeat phase 6's at 100),
    # against a float32 call on the same plan
    plan20 = plan.with_(n_lambdas=20)
    res20, _, _, _ = run_cv(torch, sess, plan20, "gapsafe-sgl-cv-f32-20")
    sess64 = f64_session(torch, T, X, y, [n] * G)
    res64, counts64, _, _ = run_cv(torch, sess64, plan20,
                                   "gapsafe-sgl-cv-f64")
    require_no_kernel(counts64, "gapsafe-sgl-cv-f64")
    compare_cv(res20, res64, "gapsafe-sgl-cv")
    return counts


def gapsafe_nn_cv_phase(torch, T, N=250, p=10_000):
    """Phase 7's plan with ``screen='gapsafe'``: ``dpc_screen_folds`` once
    a stacked screen, ``xtv``; float64 against float32 at 20 lambdas."""
    from repro_torch.data_synth import synthetic_nn
    X, y, _ = synthetic_nn(1, N=N, p=p, seed=1)
    plan = T.Plan(**CV_PLAN, screen="gapsafe")
    sess = T.SGLSession(T.Problem.nn_lasso(X, y))
    res, counts, _, _ = run_cv(torch, sess, plan, "gapsafe-nn-cv-f32")
    require_fold_route(res, counts, "gapsafe-nn-cv-f32", "dpc_screen_folds",
                       ("xtv",))
    say(f"[gapsafe-nn-cv] n_rejected {res.stats.n_rejected}")
    warm_call(torch, sess, plan, "gapsafe-nn-cv-f32", verb="cv")
    # the float64 twin at 20 lambdas, as in phase 11
    plan20 = plan.with_(n_lambdas=20)
    res20, _, _, _ = run_cv(torch, sess, plan20, "gapsafe-nn-cv-f32-20")
    sess64 = T.SGLSession(T.Problem.nn_lasso(
        X.astype(np.float64), y.astype(np.float64), dtype=torch.float64))
    res64, counts64, _, _ = run_cv(torch, sess64, plan20,
                                   "gapsafe-nn-cv-f64")
    require_no_kernel(counts64, "gapsafe-nn-cv-f64")
    compare_cv(res20, res64, "gapsafe-nn-cv")
    return counts


def logistic_phase(torch, T, N=250, G=1000, n=10):
    """``benchmarks/paper_tables.py:loss_logistic_bench`` at full size
    (N=250, 1000 groups of 10, seed 7, alpha 0.9, 100 lambdas, min_ratio
    0.1, tol 1e-6, max_iter 6000, check_every 50): ``screen='gapsafe'``
    against ``'none'`` in float32 and float64.  In float32 the prox does
    not depend on the loss, so FISTA replays graphed ``sgl_prox`` blocks;
    ``xtv`` certifies every row, and each Gap-Safe screen's statistics are
    one ``screen_norms`` launch on the center row.  The screened betas
    within 1e-3 of the unscreened (the benchmark's own bar; in float64
    on a 20-lambda plan, where both float64 paths run again); float32
    against float64 and the f32 screen's discards as in the other
    phases."""
    from repro_torch.data_synth import synthetic_logistic
    X, y, _ = synthetic_logistic(N, G, n, seed=7)
    X32, y32 = X.astype(np.float32), y.astype(np.float32)
    plan = T.Plan(alpha=0.9, n_lambdas=100, min_ratio=0.1, tol=1e-6,
                  max_iter=6000, check_every=50, screen="gapsafe")
    sess = T.SGLSession(T.Problem.sgl_logistic(X32, y32, [n] * G))
    sess64 = f64_session(torch, T, X, y, [n] * G, loss="logistic")
    res, launches = {}, {}
    for screen in ("gapsafe", "none"):
        label = f"logistic-{screen}-f32"
        r, counts, _, calls = run_path(torch, sess, plan.with_(screen=screen),
                                       label)
        res[screen, "f32"], launches[screen, "f32"] = r, counts
        st = r.stats
        require_graph_route(r, counts, calls, label)
        require(counts["xtv"] == calls.rows > 0,
                f"{label}: xtv launches {counts['xtv']} != rows solved "
                f"{calls.rows}")
        require(counts["screen_norms"] == st.n_pallas_screens
                == st.n_screens,
                f"{label}: screen_norms launches "
                f"{counts['screen_norms']}, n_pallas_screens "
                f"{st.n_pallas_screens}, screens {st.n_screens}")
        require(counts["screen_norms_folds"] ==
                counts["dpc_screen_folds"] == 0,
                f"{label}: a fold kernel was launched")
        warm_call(torch, sess, plan.with_(screen=screen), label)
    # float64: the screened path on the plan, and both on a 20-lambda plan
    for dt, p, screens in (("f64", plan, ("gapsafe",)),
                           ("f64-20", plan.with_(n_lambdas=20),
                            ("gapsafe", "none"))):
        for screen in screens:
            label = f"logistic-{screen}-{dt}"
            r, counts, _, _ = run_path(torch, sess64, p.with_(screen=screen),
                                       label)
            require_no_kernel(counts, label)
            res[screen, dt] = r
    for dt in ("f32", "f64-20"):
        agree = float(np.abs(res["gapsafe", dt].betas
                             - res["none", dt].betas).max())
        say(f"[logistic-{dt}] max|beta_gapsafe - beta_none| = {agree:.3e} "
            f"(bound 1e-3)")
        require(agree <= 1e-3, f"logistic-{dt}: the screened path drifts "
                f"from the unscreened one")
    say(f"[logistic] f32 Gap-Safe n_rejected "
        f"{res['gapsafe', 'f32'].stats.n_rejected}")

    compare_paths(res["gapsafe", "f32"], res["gapsafe", "f64"], plan,
                  spec_objectives(X32, y32, sess.problem.spec, 0.9,
                                  res["gapsafe", "f32"].lambdas,
                                  loss="logistic"), "logistic")
    require_discards(torch, T, sess, res["gapsafe", "f32"],
                     res["gapsafe", "f64"], plan, "logistic",
                     screen="gapsafe")
    return launches["gapsafe", "f32"]


# ---------------------------------------------------------------------------
# phase 14: the paper's per-lambda driver (engine='legacy')
# ---------------------------------------------------------------------------

def run_legacy(torch, sess, plan, label):
    """One ``Plan(engine='legacy')`` path with the launch counts reset just
    before and read just after.  The per-lambda driver reports no
    ``EngineStats``: its FISTA iterations are the rows' ``iters``, its
    screens the rows below lambda_max, its solved rows those that kept a
    feature."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with GraphedSolves() as calls:
        t0 = time.perf_counter()
        res = sess.path(plan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    note_wall(wall)
    counts = ops.launch_counts()
    iters = int(res.iters.sum())
    screens = int((res.lambdas < res.lam_max * (1.0 - 1e-12)).sum())
    solved = int((res.kept_features > 0).sum())
    say(f"[{label}] wall {wall:.3f} s = setup {res.setup_time:.3f} + screen "
        f"{res.screen_time:.3f} + solve {res.solve_time:.3f} s; screens "
        f"{screens} rows solved {solved} fista iterations {iters} (graphed "
        f"{calls.iters}); solve {1e6 * res.solve_time / max(iters, 1):.2f} "
        f"us per iteration; kept features (summed over rows) "
        f"{int(res.kept_features.sum())}; graphs captured "
        f"{len(sess.fista_graphs)} (in the session); launches "
        f"{json.dumps(counts)}")
    require(res.stats is None, f"{label}: the legacy driver reported stats")
    require(np.isfinite(res.betas).all(), f"{label}: non-finite betas")
    require(iters > 0 and solved > 0, f"{label}: nothing was solved")
    return res, counts, calls, screens, solved


def legacy_phase(torch, T, res_sgl64, res_nn64, N=250, G=1000, n=10,
                 p_nn=10_000):
    """The main path's and Table 3's data and plans with
    ``Plan(engine='legacy')``, float32 and float64.  Float32 SGL: ``xtv``
    once a screen (the GEMV ``X^T center``) and once a solved row (the
    certification), ``screen_norms`` once a screen (the (1, p) row),
    ``sgl_prox`` once a FISTA iteration, replayed from graphed blocks, and
    a warm second call that captures no graph.  Float32 nonnegative Lasso:
    ``xtv`` alone, as often.  Float64 runs no kernel, on every fifth point
    of the float32 grid (20 lambdas).  Bars on those points: float32
    against float64 as ``compare_paths``; the float64 legacy betas within
    1e-2 * max|beta| of the float64 batched path's."""
    from repro_torch.data_synth import synthetic_nn, synthetic_sgl
    plan = T.Plan(alpha=1.0, n_lambdas=100, tol=1e-6, safety=1e-6,
                  max_iter=6000, check_every=50, engine="legacy")
    X, y, _ = synthetic_sgl(1, N=N, G=G, n=n, gamma1=0.1, gamma2=0.1, seed=1)
    Xn, yn, _ = synthetic_nn(1, N=N, p=p_nn, seed=1)
    cases = {
        "sgl": (T.SGLSession(T.Problem.sgl(X, y, [n] * G)),
                f64_session(torch, T, X, y, [n] * G), res_sgl64, X, y),
        "nn": (T.SGLSession(T.Problem.nn_lasso(Xn, yn)),
               T.SGLSession(T.Problem.nn_lasso(
                   Xn.astype(np.float64), yn.astype(np.float64),
                   dtype=torch.float64)), res_nn64, Xn, yn),
    }
    launches = {}
    for kind, (sess, sess64, batched64, Xk, yk) in cases.items():
        label = f"legacy-{kind}"
        res, counts, calls, screens, solved = run_legacy(
            torch, sess, plan, f"{label}-f32")
        iters = int(res.iters.sum())
        require(counts["xtv"] == screens + solved,
                f"{label}-f32: xtv launches {counts['xtv']} != screens "
                f"{screens} + rows solved {solved}")
        if kind == "sgl":
            require(counts["screen_norms"] == screens,
                    f"{label}-f32: screen_norms launches "
                    f"{counts['screen_norms']} != screens {screens}")
            require(counts["sgl_prox"] == iters == calls.iters
                    and calls.solves == solved and calls.eager_solves == 0,
                    f"{label}-f32: sgl_prox launches {counts['sgl_prox']}, "
                    f"FISTA iterations {iters}, graphed {calls.iters}, "
                    f"graphed solves {calls.solves} of {solved}")
            others = ("screen_norms_folds", "dpc_screen_folds")
        else:
            others = ("screen_norms", "sgl_prox", "screen_norms_folds",
                      "dpc_screen_folds")
        require(all(counts[k] == 0 for k in others),
                f"{label}-f32: a kernel off this route was launched "
                f"({counts})")
        launches[kind] = counts
        n_captures = len(sess.fista_graphs)
        res_w, _, _, _, _ = run_legacy(torch, sess, plan, f"{label}-f32-warm")
        require(len(sess.fista_graphs) == n_captures,
                f"{label}-f32-warm: the warm call captured a graph")
        require(np.array_equal(res_w.iters, res.iters),
                f"{label}-f32-warm: iterations differ from the cold call's")
        # the float64 twin on every fifth grid point: each row is its
        # lambda's certified optimum whatever the grid around it
        lams = res.lambdas[::5]
        res64, counts64, _, _, _ = run_legacy(
            torch, sess64, plan.with_(lambdas=lams), f"{label}-f64-20")
        require_no_kernel(counts64, f"{label}-f64-20")
        res32 = dataclasses.replace(res, lambdas=lams,
                                    betas=res.betas[::5],
                                    iters=res.iters[::5])
        if kind == "sgl":
            objectives = spec_objectives(Xk, yk, sess.problem.spec, 1.0,
                                         lams)
        else:
            def objectives(betas, Xk=Xk, yk=yk, lambdas=lams):
                return nn_objectives(Xk, yk, betas, lambdas)
            objectives.gap_scale = 0.5 * float(np.dot(
                yk.astype(np.float64), yk))
        compare_paths(res32, res64, plan, objectives, label)
        dbeta = float(np.abs(res64.betas - batched64.betas[::5]).max())
        dbound = 1e-2 * float(np.abs(batched64.betas).max())
        say(f"[{label}] max|beta_legacy_f64 - beta_batched_f64| = "
            f"{dbeta:.3e} (bound 1e-2 * max|beta| = {dbound:.3e}); kept "
            f"features summed over rows: legacy {int(res.kept_features.sum())}"
            f" (f32), {int(res64.kept_features.sum())} (f64, every fifth "
            f"row); batched "
            f"solver columns {int(batched64.kept_features.sum())} (f64)")
        require(dbeta <= dbound,
                f"{label}: the legacy path disagrees with the batched one")
    return launches


# ---------------------------------------------------------------------------
# phases 15-18: model selection: refine, stability, the estimators, serving
# ---------------------------------------------------------------------------

def run_counted(torch, label, fn):
    """``fn()`` with the launch counts reset just before and read just
    after, inside ``GraphedSolves``.  Prints the wall time and the launches
    by kernel; returns (result, counts, wall, calls)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with GraphedSolves() as calls:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    note_wall(wall)
    counts = ops.launch_counts()
    say(f"[{label}] wall {wall:.3f} s; graphed FISTA iterations "
        f"{calls.iters} in {calls.solves} solves; launches "
        f"{json.dumps(counts)}")
    return out, counts, wall, calls


def require_only(counts, label, kernels):
    """Every kernel of ``kernels`` launched, and no other."""
    for name in kernels:
        require(counts[name] > 0, f"{label}: kernel {name} was not launched")
    for name in set(counts) - set(kernels):
        require(counts[name] == 0, f"{label}: kernel {name} was launched "
                f"({counts})")


def require_cv_route(res, counts, calls, label, fold_kernel, refits=0):
    """A float32 fold-engine call on the card: each stacked screen one
    ``fold_kernel`` launch; for SGL every FISTA iteration (the engine's,
    and ``refits`` more of solo refits) a graphed ``sgl_prox`` launch."""
    st = res.stats
    require(st.n_pallas_screens == st.n_screens == counts[fold_kernel] > 0,
            f"{label}: {fold_kernel} launches {counts[fold_kernel]}, "
            f"stacked screens {st.n_screens}, n_pallas_screens "
            f"{st.n_pallas_screens}: not all equal")
    if fold_kernel == "screen_norms_folds":
        require(counts["sgl_prox"] == st.fista_iters + refits
                == calls.iters > 0 and calls.eager_solves == 0,
                f"{label}: sgl_prox launches {counts['sgl_prox']}, FISTA "
                f"iterations {st.fista_iters} + refits {refits}, graphed "
                f"{calls.iters}, eager solves {calls.eager_solves}")
        require_only(counts, label, (fold_kernel, "sgl_prox", "xtv"))
    else:
        require_only(counts, label, (fold_kernel, "xtv"))
    say(f"[{label}] n_screens {st.n_screens} n_segments {st.n_segments} "
        f"n_compilations {st.n_compilations} n_rejected {st.n_rejected} "
        f"fista iterations {st.fista_iters}")


def refine_phase(torch, T, N=250, G=1000, n=10):
    """``benchmarks/paper_tables.py:session_bench`` at full size: Synthetic
    1 with 0.5 std(y) of noise (seed 2), K = 5, 100 lambdas, tol 3e-6,
    safety 1e-6, max_iter 6000, check_every 50, float32.  ``cv``, then
    ``refine(factor=10)`` and, at check_every 10, ``refine(factor=3)``
    (the refinement of the refinement), each against a cold ``cv`` on a
    fresh session over its fine grid (``refine_against_cold``); the same
    session's ``cv`` and both refinements again (no compilation, no
    capture).  The FISTA iterations of each refinement and of its cold CV
    are printed side by side, not required to differ: the seed changes
    only each fold's first fine row, and in float32 that row converges
    within the same gap checks from either start (the reference's too).
    Float64 ``cv`` + ``refine`` at 20 lambdas on
    float64's coarse grid and window against float32's, held by the CV
    bars.  The nonnegative-Lasso ``refine`` on the Table-3 data at 20
    lambdas (``dpc_screen_folds``, ``xtv``)."""
    from repro_torch.data_synth import synthetic_nn, synthetic_sgl
    X, y, _ = synthetic_sgl(1, N=N, G=G, n=n, gamma1=0.1, gamma2=0.1, seed=1)
    y = y + np.std(y) * 0.5 * np.random.default_rng(2).standard_normal(
        len(y)).astype(y.dtype)
    plan = T.Plan(alpha=1.0, n_lambdas=100, tol=3e-6, safety=1e-6,
                  max_iter=6000, check_every=50, n_folds=5)
    sess = T.SGLSession(T.Problem.sgl(X, y, [n] * G))       # cuda, float32
    coarse, counts_c, _, calls_c = run_counted(
        torch, "refine-coarse-cv-f32", lambda: sess.cv(plan))
    require_cv_route(coarse, counts_c, calls_c, "refine-coarse-cv-f32",
                     "screen_norms_folds")
    ref, counts = refine_against_cold(torch, T, sess, X, y, [n] * G, plan,
                                      10.0, "refine-f32")
    # the factor-10 window of this data reaches lambda_max, so its seed is
    # the grid's first point: each fold's clamped lambda_max state.  The
    # refinement of the refinement, by 3 and at check_every 10, seeds
    # below it, from rebuilt duals
    fine10 = dict(check_every=10)
    ref3, counts3 = refine_against_cold(torch, T, sess, X, y, [n] * G, plan,
                                        3.0, "refine-f32-by-3", **fine10)
    require(ref3.warm_start_lambda < ref.fine.lambdas[0],
            "refine-f32-by-3: seeded at the top of its coarse grid")
    n_graphs = len(sess.fista_graphs)
    walls = []
    for label, call in (("cv", lambda: sess.cv(plan)),
                        ("refine", lambda: sess.refine(factor=10.0)),
                        ("refine-by-3",
                         lambda: sess.refine(factor=3.0, **fine10))):
        res, counts_w, wall_w, calls_w = run_counted(
            torch, f"refine-f32-warm-{label}", call)
        res = res if label == "cv" else res.fine
        require(res.stats.n_compilations == 0 and
                len(sess.fista_graphs) == n_graphs,
                f"refine-f32-warm-{label}: compiled or captured")
        require_cv_route(res, counts_w, calls_w, f"refine-f32-warm-{label}",
                         "screen_norms_folds")
        walls.append(wall_w)
    say(f"[refine] warm cv {walls[0]:.3f} s + refine {walls[1]:.3f} s + "
        f"refine by 3 {walls[2]:.3f} s")

    # float64 reference at 20 lambdas: both dtypes on float64's coarse grid
    # and around float64's selection, so that the fine grids are equal
    plan20 = plan.with_(n_lambdas=20)
    sess64 = f64_session(torch, T, X, y, [n] * G)
    cv64, counts64, _, _ = run_counted(torch, "refine-cv-f64",
                                       lambda: sess64.cv(plan20))
    ref64, counts64r, _, _ = run_counted(
        torch, "refine-f64", lambda: sess64.refine(
            around=cv64.best_lambda, factor=10.0))
    require_no_kernel(counts64, "refine-cv-f64")
    require_no_kernel(counts64r, "refine-f64")
    cv32 = sess.cv(plan20.with_(lambdas=cv64.lambdas))
    ref32 = sess.refine(around=cv64.best_lambda, factor=10.0)
    compare_cv(cv32, cv64, "refine-coarse-20")
    require(np.allclose(ref32.fine.lambdas, ref64.fine.lambdas, rtol=1e-12),
            "refine-20: the fine grids differ")
    compare_cv(ref32.fine, ref64.fine, "refine-20")

    Xn, yn, _ = synthetic_nn(1, N=N, p=G * n, seed=1)
    plan_nn = T.Plan(**CV_PLAN).with_(n_lambdas=20)
    sess_nn = T.SGLSession(T.Problem.nn_lasso(Xn, yn))
    run_counted(torch, "refine-nn-cv-f32", lambda: sess_nn.cv(plan_nn))
    ref_nn, counts_nn, _, calls_nn = run_counted(
        torch, "refine-nn-f32", lambda: sess_nn.refine(factor=10.0))
    require_cv_route(ref_nn.fine, counts_nn, calls_nn, "refine-nn-f32",
                     "dpc_screen_folds")
    require(bool((ref_nn.fine.fold_iters < plan_nn.max_iter).all()),
            "refine-nn-f32: a row ran to max_iter (not certified)")
    say(f"[refine-nn] lambda_ {ref_nn.lambda_:.6g} seeded at "
        f"{ref_nn.warm_start_lambda:.6g}; FISTA iterations "
        f"{ref_nn.total_iters}; n_rejected f32 "
        f"{ref_nn.fine.stats.n_rejected}")
    return {"refine": counts, "refine-by-3": counts3, "refine-nn": counts_nn}


def refine_against_cold(torch, T, sess, X, y, sizes, plan, factor, label,
                        **overrides):
    """``sess.refine(factor, **overrides)`` after the session's last CV (or
    refine), then a cold CV on a fresh session over the same fine grid
    with the same overrides.  Both on the
    kernel route; every refined row certified, the refined betas within
    1e-2 * max|beta| of the cold ones and the selection within one step;
    both runs' FISTA iterations printed."""
    top = sess._last_cv.result.lambdas[0]
    ref, counts, wall_r, calls = run_counted(
        torch, label, lambda: sess.refine(factor=factor, **overrides))
    fine = ref.fine
    require_cv_route(fine, counts, calls, label, "screen_norms_folds")
    cold, _, wall_cold, _ = run_counted(
        torch, f"{label}-cold-cv", lambda: T.SGLSession(
            T.Problem.sgl(X, y, sizes)).cv(plan.with_(lambdas=fine.lambdas,
                                                      **overrides)))
    cold_iters = int(cold.fold_iters.sum())
    dbeta = float(np.abs(fine.fold_betas - cold.fold_betas).max())
    dbound = 1e-2 * float(np.abs(cold.fold_betas).max())
    at_top = ref.warm_start_lambda >= top
    say(f"[{label}] window [{fine.lambdas.min():.6g}, "
        f"{fine.lambdas.max():.6g}] around {ref.coarse.best_lambda:.6g}, "
        f"seeded at {ref.warm_start_lambda:.6g} (top of the coarse grid "
        f"{top:.6g}: {'yes' if at_top else 'no'}); lambda_ "
        f"{ref.lambda_:.6g} (index {ref.index}, cold CV's "
        f"{cold.best_index}); FISTA iterations {ref.total_iters} (accepted "
        f"rows; run {fine.stats.fista_iters}) against the cold CV's "
        f"{cold_iters} (run {cold.stats.fista_iters}): saving "
        f"{cold_iters / max(ref.total_iters, 1):.3f}x; wall {wall_r:.3f} s "
        f"against cold {wall_cold:.3f} s; new compilations "
        f"{ref.new_compilations}; n_rejected f32 {fine.stats.n_rejected}; "
        f"max|beta_refine - beta_cold| = {dbeta:.3e} (bound 1e-2 * "
        f"max|beta| = {dbound:.3e})")
    require(np.isfinite(fine.fold_betas).all() and
            np.isfinite(fine.mean_mse).all(), f"{label}: non-finite")
    require(bool((fine.fold_iters < plan.max_iter).all()),
            f"{label}: a row ran to max_iter (not certified)")
    require(dbeta <= dbound, f"{label}: refined betas disagree with the "
            f"cold CV's")
    require(abs(ref.index - cold.best_index) <= 1,
            f"{label}: selection more than one step from the cold CV's")
    return ref, counts


class FoldBetas:
    """Inside the block, records the (betas, iters) of every
    ``sgl_fold_paths`` call a session makes."""

    def __enter__(self):
        from repro_torch.core import session
        self.mod, self.orig = session, session.sgl_fold_paths
        self.calls = []

        def recorded(*args, **kw):
            out = self.orig(*args, **kw)
            self.calls.append((out[0], out[2]))
            return out

        session.sgl_fold_paths = recorded
        return self

    def __exit__(self, *exc):
        self.mod.sgl_fold_paths = self.orig

    def betas(self):
        return np.concatenate([b for b, _ in self.calls])

    def iters(self):
        return np.concatenate([i for _, i in self.calls])


def stability_phase(torch, T, N=250, G=1000, n=10):
    """Stability selection on Synthetic 1 at the ``stability_selection``
    shim's defaults (50 subsamples of half the rows, batches of 10, 30
    lambdas, min_ratio 0.05, tol 1e-7, the Frobenius group bound), float32:
    every stacked screen one ``screen_norms_folds`` launch, ``sgl_prox``
    graphed, ``xtv``; every accepted row certified; a warm second call that
    compiles and captures nothing.  Float64 at 10 subsamples and 10
    lambdas against float32 on the same masks and grid: a (subsample,
    lambda, feature) is active in one dtype and not the other only where
    float64's |beta| is within 1e-2 * max|beta| (the float32 bar on betas)
    of ``active_tol``."""
    from repro_torch.data_synth import synthetic_sgl
    X, y, _ = synthetic_sgl(1, N=N, G=G, n=n, gamma1=0.1, gamma2=0.1, seed=1)
    plan = T.Plan(n_subsamples=50, subsample_frac=0.5, batch_size=10,
                  n_lambdas=30, min_ratio=0.05, active_tol=1e-8, tol=1e-7,
                  max_iter=20000, check_every=10, specnorm_method="fro")
    sess = T.SGLSession(T.Problem.sgl(X, y, [n] * G))       # cuda, float32
    with FoldBetas() as rec:
        res, counts, wall, calls = run_counted(
            torch, "stability-f32", lambda: sess.stability(plan))
    require_cv_route(res, counts, calls, "stability-f32",
                     "screen_norms_folds")
    iters = rec.iters()
    require(iters.shape == (50, 30) and bool((iters < plan.max_iter).all()),
            "stability-f32: a row ran to max_iter (not certified)")
    probs = res.selection_probs
    say(f"[stability] selection_probs {probs.shape}, features with max_prob "
        f">= 0.6: {int((res.max_probs >= 0.6).sum())}; n_rejected f32 "
        f"{res.stats.n_rejected}; FISTA iterations {res.stats.fista_iters}")
    require(np.isfinite(probs).all() and probs.min() >= 0 and
            probs.max() <= 1, "stability-f32: probabilities out of [0, 1]")
    n_graphs = len(sess.fista_graphs)
    warm, _, wall_w, _ = run_counted(torch, "stability-f32-warm",
                                     lambda: sess.stability(plan))
    require(warm.stats.n_compilations == 0 and
            len(sess.fista_graphs) == n_graphs,
            "stability-f32-warm: compiled or captured")
    require(np.array_equal(warm.selection_probs, probs),
            "stability-f32-warm: probabilities differ from the cold call's")
    say(f"[stability] cold {wall:.3f} s, warm {wall_w:.3f} s")

    small = plan.with_(n_subsamples=10, n_lambdas=10)
    sess64 = f64_session(torch, T, X, y, [n] * G)
    with FoldBetas() as rec64:
        s64, counts64, _, _ = run_counted(torch, "stability-f64",
                                          lambda: sess64.stability(small))
    require_no_kernel(counts64, "stability-f64")
    with FoldBetas() as rec32:
        s32, _, _, _ = run_counted(torch, "stability-f32-small", lambda:
                                   sess.stability(small.with_(
                                       lambdas=s64.lambdas)))
    b32, b64 = rec32.betas(), rec64.betas()
    tol = plan.active_tol
    flips = (np.abs(b32) > tol) != (np.abs(b64) > tol)
    band = 1e-2 * float(np.abs(b64).max()) + tol
    worst = float(np.abs(b64[flips]).max()) if flips.any() else 0.0
    dprob = float(np.abs(s32.selection_probs - s64.selection_probs).max())
    say(f"[stability] f32 vs f64 (10 subsamples, 10 lambdas): "
        f"{int(flips.sum())} of {flips.size} (subsample, lambda, feature) "
        f"activity decisions differ, at float64 |beta| <= {worst:.3e} "
        f"(bound 1e-2 * max|beta| + active_tol = {band:.3e}); max "
        f"|prob_f32 - prob_f64| = {dprob:.3f}")
    require(worst <= band, "stability: a float32 activity decision differs "
            "from float64's at a feature far from active_tol")
    return counts


def estimators_phase(torch, T, N=250, G=1000, n=10):
    """The estimators of ``api.py`` at float32 on the card: ``SGLCV`` on
    Synthetic 1 with an intercept (y + 3), K = 5, 20 lambdas, then its
    ``session_.refine``; ``SGLRegressor`` at ``SGLCV.lambda_`` (coef within
    1e-2 * max|coef| of ``SGLCV.coef_``); ``NNLassoCV`` on the Table-3
    data (coef >= 0); ``SGLClassifier`` on ``loss_logistic_bench``'s data
    at 0.3 lambda_max, alpha 0.9 (its objective at most its certified gap
    above the float64 fit's)."""
    from repro_torch import api
    from repro_torch.data_synth import (synthetic_logistic, synthetic_nn,
                                        synthetic_sgl)
    f32 = torch.float32
    X, y, _ = synthetic_sgl(1, N=N, G=G, n=n, gamma1=0.1, gamma2=0.1, seed=1)
    y = y + 3.0
    sizes = [n] * G
    kw = dict(tol=3e-6, max_iter=6000)
    est, counts_cv, _, calls = run_counted(
        torch, "sglcv-f32", lambda: api.SGLCV(
            groups=sizes, n_folds=5, n_lambdas=20, safety=1e-5, dtype=f32,
            **kw).fit(X, y))
    require_cv_route(est.cv_result_, counts_cv, calls, "sglcv-f32",
                     "screen_norms_folds", refits=est.n_iter_)
    require(est.n_iter_ < kw["max_iter"], "sglcv-f32: the refit ran to "
            "max_iter")
    ref, counts_r, _, calls_r = run_counted(
        torch, "sglcv-refine-f32", lambda: est.session_.refine(factor=10.0))
    require_cv_route(ref.fine, counts_r, calls_r, "sglcv-refine-f32",
                     "screen_norms_folds")
    reg, counts_reg, _, calls_reg = run_counted(
        torch, "sglregressor-f32", lambda: api.SGLRegressor(
            lam=est.lambda_, groups=sizes, dtype=f32, **kw).fit(X, y))
    require(counts_reg["sgl_prox"] == reg.n_iter_ == calls_reg.iters > 0,
            "sglregressor-f32: sgl_prox launches are not its graphed FISTA "
            "iterations")
    require_only(counts_reg, "sglregressor-f32", ("sgl_prox",))
    dcoef = float(np.abs(reg.coef_ - est.coef_).max())
    cbound = 1e-2 * float(np.abs(est.coef_).max())
    say(f"[estimators] SGLCV lambda_ {est.lambda_:.6g} (index "
        f"{int(np.argmin(np.abs(est.lambdas_ - est.lambda_)))}), refit "
        f"{est.n_iter_} iterations, intercept {est.intercept_:.4f}, "
        f"score {est.score(X, y):.6f}; refine lambda_ {ref.lambda_:.6g}; "
        f"SGLRegressor score {reg.score(X, y):.6f}, max|coef_reg - "
        f"coef_cv| = {dcoef:.3e} (bound {cbound:.3e}); n_rejected f32 "
        f"{est.cv_result_.stats.n_rejected}")
    require(dcoef <= cbound, "SGLRegressor disagrees with SGLCV")

    Xn, yn, _ = synthetic_nn(1, N=N, p=G * n, seed=1)
    nn, counts_nn, _, calls_nn = run_counted(
        torch, "nnlassocv-f32", lambda: api.NNLassoCV(
            n_folds=5, n_lambdas=20, safety=1e-5, dtype=f32,
            **kw).fit(Xn, yn))
    require_cv_route(nn.cv_result_, counts_nn, calls_nn, "nnlassocv-f32",
                     "dpc_screen_folds")
    require(nn.coef_.min() >= 0.0, "NNLassoCV: a negative coefficient")
    say(f"[estimators] NNLassoCV lambda_ {nn.lambda_:.6g}, refit "
        f"{nn.n_iter_} iterations, score {nn.score(Xn, yn):.6f}, "
        f"nnz {int((nn.coef_ > 0).sum())}")

    Xl, yl, _ = synthetic_logistic(N, G, n, seed=7)
    Xl32, yl32 = Xl.astype(np.float32), yl.astype(np.float32)
    lam = 0.3 * f64_session(torch, T, Xl, yl, sizes,
                            loss="logistic").lambda_max(0.9)
    ckw = dict(lam=lam, alpha=0.9, groups=sizes, tol=1e-6, max_iter=6000)
    clf, counts_clf, _, calls_clf = run_counted(
        torch, "sglclassifier-f32", lambda: api.SGLClassifier(
            dtype=f32, **ckw).fit(Xl32, yl32))
    require(counts_clf["sgl_prox"] == clf.session_.stats.fista_iters
            == calls_clf.iters > 0,
            "sglclassifier-f32: sgl_prox launches are not its graphed FISTA "
            "iterations")
    require(counts_clf["xtv"] > 0 and counts_clf["screen_norms"] > 0,
            "sglclassifier-f32: xtv or screen_norms was not launched")
    require_only(counts_clf, "sglclassifier-f32",
                 ("sgl_prox", "xtv", "screen_norms"))
    clf64, counts64, _, _ = run_counted(
        torch, "sglclassifier-f64", lambda: api.SGLClassifier(
            dtype=torch.float64, **ckw).fit(Xl, yl))
    require_no_kernel(counts64, "sglclassifier-f64")
    objectives = spec_objectives(Xl32, yl32, clf.spec_, 0.9, [lam],
                                 loss="logistic")
    obj32 = float(objectives(clf.coef_[None, :])[0])
    obj64 = float(objectives(clf64.coef_[None, :])[0])
    gap_bound = 1.01 * max(ckw["tol"], 64 * EPS32) * objectives.gap_scale
    say(f"[estimators] SGLClassifier at 0.3 lambda_max = {lam:.6g}: "
        f"{clf.n_iter_} iterations, kept {clf.kept_features_}, accuracy "
        f"{clf.score(Xl, yl):.4f} (f64 {clf64.score(Xl, yl):.4f}); "
        f"objective f32 {obj32:.9g} - f64 {obj64:.9g} = {obj32 - obj64:.3e} "
        f"(bound, the f32 certified gap {gap_bound:.3e})")
    require(clf.n_iter_ < ckw["max_iter"],
            "sglclassifier-f32: ran to max_iter")
    require(obj32 - obj64 <= gap_bound,
            "SGLClassifier: the float32 objective is above float64's by "
            "more than its certified gap")
    return {"sglcv": counts_cv, "sglcv-refine": counts_r,
            "sglregressor": counts_reg, "nnlassocv": counts_nn,
            "sglclassifier": counts_clf}


def serving_phase(torch, T, N=250, G=1000, n=10):
    """``SGLServer`` at Synthetic-1 width: 2 designs (250 x 10 000, 1000
    groups of 10) with 3 responses each (``_synthetic_jobs``, seed 0), 5
    folds, 20 lambdas, tol 1e-6 (the serve CLI's plan), float32; drained
    cold, then warm.  Every job returns with ``error is None``; each
    design's jobs share one fold-stacked engine call; every stacked screen
    is one ``screen_norms_folds`` launch and every FISTA iteration (the
    engine's and the refits') a graphed ``sgl_prox`` launch; the warm
    drain adds no compilation and captures no graph.  Each job against a
    solo CV of its own on the same folds and grid (the CV bars) and a solo
    refit at the job's selection."""
    from repro_torch.launch import sgl_serve
    plan = T.Plan(n_folds=5, n_lambdas=20, tol=1e-6, safety=1e-6,
                  max_iter=6000, check_every=50)
    jobs = sgl_serve._synthetic_jobs(np.random.default_rng(0), 2, 3, N, G, n)
    sizes = [n] * G
    server = sgl_serve.SGLServer(plan, dtype=torch.float32)

    def drain():
        for X, y in jobs:
            server.submit(X, y, groups=sizes)
        return server.drain()

    out = {}
    for label in ("cold", "warm"):
        n_graphs = len(server.fista_graphs)
        before = dict(screens=server.stats.n_screens,
                      iters=server.stats.fista_iters)
        res, counts, wall, calls = run_counted(torch, f"serve-{label}",
                                               drain)
        errors = {j: r.error for j, r in res.items() if r.error is not None}
        require(not errors, f"serve-{label}: jobs failed: {errors}")
        ids = sorted(res)
        require(len(ids) == len(jobs), f"serve-{label}: jobs lost")
        for r in res.values():
            d = (r.job_id - ids[0]) // 3
            require(r.batched_with == ids[3 * d:3 * d + 3],
                    f"serve-{label}: job {r.job_id} batched with "
                    f"{r.batched_with}")
        screens = server.stats.n_screens - before["screens"]
        iters = server.stats.fista_iters - before["iters"]
        refits = sum(r.n_iter for r in res.values())
        require(counts["screen_norms_folds"] == screens > 0,
                f"serve-{label}: screen_norms_folds launches "
                f"{counts['screen_norms_folds']} != stacked screens "
                f"{screens}")
        require(counts["sgl_prox"] == iters + refits == calls.iters > 0
                and calls.eager_solves == 0,
                f"serve-{label}: sgl_prox launches {counts['sgl_prox']}, "
                f"FISTA iterations {iters} + refits {refits}, graphed "
                f"{calls.iters}")
        require_only(counts, f"serve-{label}",
                     ("screen_norms_folds", "sgl_prox", "xtv"))
        comp = sum({r.batched_with[0]: r.new_compilations
                    for r in res.values()}.values())
        lat = [r.latency for r in res.values()]
        say(f"[serve-{label}] {len(jobs)} jobs in 2 fold-stacked batches; "
            f"{wall:.3f} s, latency per job {np.mean(lat):.3f} s "
            f"({wall / len(jobs):.3f} s wall / jobs); compilations {comp}; "
            f"graphs captured {len(server.fista_graphs) - n_graphs}; "
            f"stacked screens {screens}, FISTA iterations {iters} + refits "
            f"{refits}")
        if label == "warm":
            require(comp == 0 and len(server.fista_graphs) == n_graphs,
                    "serve-warm: compiled or captured")
        out[label] = (res, counts)

    res = out["cold"][0]
    for t, (X, y) in enumerate(jobs):
        r = res[sorted(res)[t]]
        sess = T.SGLSession(T.Problem.sgl(X.astype(np.float32),
                                          y.astype(np.float32), sizes))
        cv = sess.cv(plan.with_(lambdas=r.lambdas))
        fit = T.solve_sgl(sess.problem.X, sess.problem.y, sess.problem.spec,
                          r.best_lambda, 1.0,
                          float(T.spectral_norm(sess.problem.X)) ** 2,
                          max_iter=plan.max_iter, check_every=10,
                          tol=plan.tol, use_kernels=True,
                          graphs=sess.fista_graphs)
        dmse = float(np.max(np.abs(r.mean_mse - cv.mean_mse)
                            / np.abs(cv.mean_mse)))
        idx = int(np.argmin(np.abs(r.lambdas - r.best_lambda)))
        coef = fit.beta.cpu().numpy()
        dcoef = float(np.abs(r.coef - coef).max())
        cbound = 1e-2 * float(np.abs(coef).max())
        say(f"[serve] job {r.job_id}: best_lambda {r.best_lambda:.6g} "
            f"(index {idx}; solo {cv.best_index}), refit {r.n_iter} "
            f"iterations (solo {fit.iters}); max rel |mean_mse - solo| = "
            f"{dmse:.3e} (bound 1e-2); max|coef - solo| = {dcoef:.3e} "
            f"(bound {cbound:.3e})")
        require(dmse <= 1e-2 and abs(idx - cv.best_index) <= 1 and
                dcoef <= cbound, f"serve: job {r.job_id} disagrees with its "
                f"solo CV and refit")
    return out["cold"][1]


# ---------------------------------------------------------------------------
# phase 19: feature sharding, stacked on the card and across two ranks
# ---------------------------------------------------------------------------

SHARDS = 8


def rows_run(res):
    """Rows certified by a path: each segment's accepted rows, and the
    failed row where it stopped early."""
    return sum(k + (k < m) for _, _, m, k in res.stats.buckets)


def require_sharded_path(res, counts, label, shards, screen_kernel=True):
    """A float32 sharded path on the card: ``xtv`` once a block a certified
    row (the setup's GEMVs are plain, as unsharded), ``screen_norms`` once
    a block a screen, and for SGL ``sgl_prox`` once a FISTA iteration."""
    st, rows = res.stats, rows_run(res)
    want = {"xtv": shards * rows,
            "screen_norms": shards * st.n_screens if screen_kernel else 0,
            "sgl_prox": st.fista_iters if screen_kernel else 0,
            "screen_norms_folds": 0, "dpc_screen_folds": 0}
    say(f"[{label}] rows certified {rows}, screens {st.n_screens}: "
        f"launches {json.dumps(counts)}, predicted {json.dumps(want)}")
    require(counts == want and rows > 0, f"{label}: launches {counts} are "
            f"not the predicted {want}")
    require(st.n_pallas_screens == (st.n_screens if screen_kernel else 0),
            f"{label}: n_pallas_screens {st.n_pallas_screens}")


def compare_same_dtype(res, ref, label, betas="betas"):
    """Two float32 runs of one problem (sharded and unsharded): betas
    within 1e-2 * max|beta| (the float32 bar of PERF.md section 2)."""
    a, b = getattr(res, betas), getattr(ref, betas)
    dbeta = float(np.abs(a - b).max())
    dbound = 1e-2 * float(np.abs(b).max())
    say(f"[{label}] max|beta_sharded - beta_unsharded| = {dbeta:.3e} "
        f"(bound {dbound:.3e})")
    require(np.isfinite(a).all() and dbeta <= dbound,
            f"{label}: the sharded run disagrees with the unsharded one")


def _rank_path(rank, world, init_file, out_dir, plan_kw, N, G, n):
    """One rank of the two-rank rehearsal (a spawned process): joins the
    ``gloo`` group, runs the Synthetic-1 path with ``feature_shards=world``
    on the card (block ``rank``) and writes its betas, launches and
    collectives to ``out_dir``."""
    import datetime
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    import repro_torch.core as T
    from repro_torch.data_synth import synthetic_sgl
    from repro_torch.distributed import feature_shard as fs
    from repro_torch.kernels import ops
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        X, y, _ = synthetic_sgl(1, N=N, G=G, n=n, gamma1=0.1, gamma2=0.1,
                                seed=1)
        sess = T.SGLSession(T.Problem.sgl(X, y, [n] * G))
        if fs.resolve_feature_mesh(world) is None:
            raise RuntimeError("the ranks did not get the process group")
        ops.reset_launch_counts()
        fs.reset_collective_counts()
        res = sess.path(T.Plan(feature_shards=world, **plan_kw))
        torch.cuda.synchronize()
        np.save(f"{out_dir}/rank{rank}.npy", res.betas)
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump({"launches": ops.launch_counts(),
                       "collectives": fs.collective_counts(),
                       "n_screens": res.stats.n_screens,
                       "rows": rows_run(res)}, f)
    finally:
        dist.destroy_process_group()


def two_ranks(torch, T, X, y, sizes, plan, world=2, timeout=300.0):
    """The rehearsal of the distributed executor on one card: ``world``
    ``gloo`` ranks share it, one block each, and each rank's betas must
    equal the stacked executor's on the same plan bit for bit.  Both
    groups are ``gloo`` here (NCCL refuses two ranks on one card); a
    backend that refuses a CUDA tensor fails the phase."""
    stacked = T.SGLSession(T.Problem.sgl(X, y, sizes)).path(
        plan.with_(feature_shards=world))
    torch.cuda.synchronize()
    plan_kw = {f: getattr(plan, f) for f in (
        "alpha", "n_lambdas", "tol", "safety", "max_iter", "check_every")}

    def load(tmp, r):
        with open(f"{tmp}/rank{r}.json") as f:
            return np.load(f"{tmp}/rank{r}.npy"), json.load(f)
    out, wall = run_ranks(_rank_path, world, (
        plan_kw, X.shape[0], len(sizes), sizes[0]), load, "two-ranks",
        timeout)
    betas = [b for b, _ in out]
    info = [i for _, i in out]
    say(f"[two-ranks] {world} gloo ranks on one card, {wall:.3f} s with "
        f"start-up; rank 0: rows certified {info[0]['rows']}, screens "
        f"{info[0]['n_screens']}, launches {json.dumps(info[0]['launches'])}"
        f", collectives {json.dumps(info[0]['collectives'])}")
    for r in range(world):
        require(np.array_equal(betas[r], betas[0]),
                f"two-ranks: rank {r}'s betas differ from rank 0's")
        require(info[r] == info[0], f"two-ranks: rank {r}'s counters "
                f"{info[r]} differ from rank 0's {info[0]}")
    dmax = float(np.abs(betas[0] - stacked.betas).max())
    require(np.array_equal(betas[0], stacked.betas),
            f"two-ranks: the ranks' betas differ from the stacked "
            f"executor's (max {dmax})")
    launches, coll = info[0]["launches"], info[0]["collectives"]
    require(launches["xtv"] == info[0]["rows"] and
            launches["screen_norms"] == info[0]["n_screens"] and
            coll["all_reduce_min"] == info[0]["rows"] and
            coll["all_gather"] > 0,
            "two-ranks: a rank's launches or collectives are not one "
            "block's")
    say(f"[two-ranks] betas of both ranks equal the stacked executor's bit "
        f"for bit ({betas[0].shape}, max|beta| "
        f"{float(np.abs(betas[0]).max()):.4f})")


def peak_run(torch, label, fn):
    """``fn()`` with the card's peak allocation during it printed above
    what was allocated before it (the session's design among that).
    Returns (fn's result, the peak above that in bytes)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    say(f"[{label}] device memory: {base / 2**20:.1f} MiB allocated before "
        f"the call, peak {(base + extra) / 2**20:.1f} MiB during it "
        f"(+{extra / 2**20:.1f} MiB)")
    return out, extra


def sharded_kernel_checks(torch, X1, spec1, sn1, X2, spec2, sn2, snf, dsf,
                          floor):
    """Each kernel on the card at the sharded route's own inputs, against
    its plain version at phase 23's tolerances: ``xtv`` on Synthetic 1's
    first block and on Table 2's widest; ``screen_norms`` at the recorded
    first screen shapes on a Synthetic-1 local spec and on the Table-2
    block with the most pad columns (past the last group of the block's
    local spec, owned by none; poisoned with 1e30 and NaN, so a read of
    one shows); ``screen_norms_folds`` and ``dpc_screen_folds`` at the
    sharded CVs' first per-block screen shapes."""
    from repro_torch.distributed import feature_shard as fs
    fp1 = fs.plan_feature_shards(SHARDS, X1.shape[1], spec1)
    fp2 = fs.plan_feature_shards(SHARDS, X2.shape[1], spec2)
    for label, fp, sn in (("synthetic1", fp1, sn1), ("table2", fp2, sn2)):
        (L, w), _, _ = sn
        require(w == fp.p_shard, f"sharded-{label}: screen_norms ran on C "
                f"of width {w}, not the block width {fp.p_shard}")
    out = {name: {} for name in ("xtv", "screen_norms", "screen_norms_folds",
                                 "dpc_screen_folds")}
    Xb1 = fs.feature_ops(SHARDS).blocks(fp1, X1)[0]
    out["xtv"]["synthetic1-block"] = check_xtv(torch, Xb1,
                                               "sharded-synthetic1-block")
    wide = int(np.argmax(fp2.widths))
    c0, w = int(fp2.col_starts[wide]), int(fp2.widths[wide])
    Xb2 = torch.zeros((X2.shape[0], fp2.p_shard), device=X2.device)
    Xb2[:, :w] = X2[:, c0:c0 + w]
    out["xtv"]["table2-widest-block"] = check_xtv(
        torch, Xb2, "sharded-table2-widest-block")
    del Xb2
    out["screen_norms"]["synthetic1-block"] = check_screen_norms(
        torch, sn1[0][0], fp1.specs[0], "sharded-synthetic1-block", floor)
    narrow = int(np.argmin(fp2.widths))
    spec_n = fp2.specs[narrow]
    n_pad = spec_n.num_features - int(spec_n.sizes.sum())
    require(n_pad > 0, "sharded-table2: the narrowest block has no pad "
            "column")
    say(f"[sharded-table2] block {narrow}: {int(fp2.widths[narrow])} "
        f"columns of {fp2.p_shard}, {n_pad} pad columns poisoned")
    out["screen_norms"]["table2-padded-block"] = check_screen_norms(
        torch, sn2[0][0], spec_n, "sharded-table2-padded-block", floor)
    (R, G_sh, n_max), _ = snf
    require((G_sh, n_max) == tuple(fp1.specs[0].pad_mask.shape),
            f"sharded-sgl-cv: screen_norms_folds ran on groups {G_sh} x "
            f"{n_max}, not a block's")
    out["screen_norms_folds"]["sgl-cv-block"] = check_screen_norms_folds(
        torch, R, fp1.specs[0].pad_mask, "sharded-sgl-cv-block")
    (K, L, p_sh), _, _ = dsf
    require(p_sh == X1.shape[1] // SHARDS, f"sharded-nn-cv: "
            f"dpc_screen_folds ran on width {p_sh}, not a block's")
    out["dpc_screen_folds"]["nn-cv-block"] = check_dpc_screen_folds(
        torch, K, L, p_sh, "sharded-nn-cv-block")
    return out


def feature_shard_phase(torch, T, res64, N=250, G=1000, n=10, N2=747,
                        p2_full=100_000):
    """``Plan(feature_shards=8)`` on the card through the stacked executor:
    the Synthetic-1 path of phase 3 (float32 cold, warm, profiled; against
    phase 3's float64 path; a float64 twin at 20 lambdas against the
    unsharded float64 path), the Table-2 shape with its last 7 groups
    dropped (18 184 groups: 8 blocks of unequal width) against the
    unsharded path at 4 lambdas, SGL and NN CV at 20 lambdas and the NN
    path at 20 lambdas, each against its unsharded twin with the peak
    memory of both; then the two-rank rehearsal.  Returns (launches by
    path, a function that checks and times each kernel at the sharded
    inputs, called when the card is otherwise idle)."""
    from repro_torch.data_synth import ragged_sizes, synthetic_nn, \
        synthetic_sgl
    from repro_torch.kernels import dpc_screen_folds as dsf
    from repro_torch.kernels import screen_norms as sn
    from repro_torch.kernels import screen_norms_folds as snf
    out = {}
    t0 = time.perf_counter()

    def lap(what):
        nonlocal t0
        say(f"[feature-shards] {what}: {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()

    def pair(label, run, sess, plan, record=None):
        """The unsharded twin, then the sharded run, each with its peak;
        ``record`` (module, wrapper name): the shapes of the sharded run's
        launches of that kernel."""
        a, _ = peak_run(torch, label, lambda: run(torch, sess, plan, label))
        with LaunchShapes(*(record or (sn, "screen_norms_cuda"))) as shapes:
            b, _ = peak_run(torch, f"sharded-{label}", lambda: run(
                torch, sess, plan.with_(feature_shards=SHARDS),
                f"sharded-{label}"))
        return a, b, shapes.shapes

    X, y, _ = synthetic_sgl(1, N=N, G=G, n=n, gamma1=0.1, gamma2=0.1, seed=1)
    sizes = [n] * G
    plan = T.Plan(alpha=1.0, n_lambdas=100, tol=1e-6, safety=1e-6,
                  max_iter=6000, check_every=50, feature_shards=SHARDS)
    sess = T.SGLSession(T.Problem.sgl(X, y, sizes))
    with LaunchShapes(sn, "screen_norms_cuda") as shapes1:
        res, counts, _, calls = run_path(torch, sess, plan,
                                         "sharded-synthetic1")
    require_sharded_path(res, counts, "sharded-synthetic1", SHARDS)
    require(calls.rows == rows_run(res), "sharded-synthetic1: rows solved "
            f"{calls.rows} != rows certified {rows_run(res)}")
    require(bool((res.iters < plan.max_iter).all()),
            "sharded-synthetic1: a row ran to max_iter (not certified)")

    def objectives(betas):
        return sgl_objectives(X, y, betas, res.lambdas, G, n)
    objectives.gap_scale = 0.5 * float(np.dot(y.astype(np.float64), y))
    compare_paths(res, res64, plan, objectives, "sharded-synthetic1")
    out["synthetic1-sharded-path"] = counts
    n_captures = len(sess.fista_graphs)
    warm, counts_w, warm_wall, _ = run_path(torch, sess, plan,
                                            "sharded-synthetic1-warm")
    require(warm.stats.n_compilations == 0 and
            len(sess.fista_graphs) == n_captures,
            "sharded-synthetic1-warm: compiled or captured")
    require_sharded_path(warm, counts_w, "sharded-synthetic1-warm", SHARDS)
    idle = profile_call(torch, lambda: sess.path(plan),
                        "sharded-synthetic1-profiled", warm_wall)[0]
    say(f"[sharded-synthetic1] warm wall {warm_wall:.3f} s, idle share "
        f"{idle:.4f}")
    lap("Synthetic-1 float32, cold, warm, profiled")

    plan20 = plan.with_(n_lambdas=20, feature_shards=0)
    sess64 = f64_session(torch, T, X, y, sizes)
    (r64, c64, _, _), (r64s, c64s, _, _), _ = pair(
        "synthetic1-f64-20", run_path, sess64, plan20)
    dbeta = float(np.abs(r64s.betas - r64.betas).max())
    say(f"[sharded-synthetic1-f64-20] max|beta_sharded - beta_unsharded| "
        f"= {dbeta:.3e} (bound 1e-12); kept sets equal "
        f"{np.array_equal(r64s.kept_features, r64.kept_features)}")
    require(sum(c64.values()) == sum(c64s.values()) == 0,
            "a float64 path launched a kernel")
    require(np.array_equal(r64s.kept_features, r64.kept_features) and
            np.array_equal(r64s.kept_groups, r64.kept_groups) and
            dbeta <= 1e-12, "sharded-synthetic1-f64-20: the sharded float64 "
            "path is not the unsharded one")
    del sess64
    lap("Synthetic-1 float64 twins")

    # Table 2's shape with its last 7 groups dropped: 18 184 groups, 8
    # blocks of 2 273 groups of unequal width, each padded to the widest
    rsizes = ragged_sizes(p2_full, avg=4.5, seed=0)[:-7]
    p2 = int(sum(rsizes))
    rng = np.random.default_rng(0)
    X2 = rng.standard_normal((N2, p2_full)).astype(np.float32)
    beta2 = np.zeros(p2_full, np.float32)
    hot = rng.choice(p2_full, 60, replace=False)
    beta2[hot] = rng.standard_normal(60)
    y2 = (X2 @ beta2 + 0.01 * rng.standard_normal(N2)).astype(np.float32)
    X2 = np.ascontiguousarray(X2[:, :p2])     # phase 4's data, 31 fewer cols
    sess2 = T.SGLSession(T.Problem.sgl(X2, y2, rsizes))
    del X2
    plan2 = T.Plan(alpha=1.0, n_lambdas=4, tol=1e-6, safety=1e-6,
                   max_iter=6000, check_every=50, specnorm_method="frobenius")
    (r2u, _, _, _), (r2s, c2s, _, _), shapes2 = pair(
        "table2-ragged-4", run_path, sess2, plan2)
    from repro_torch.distributed.feature_shard import plan_feature_shards
    fp2 = plan_feature_shards(SHARDS, p2, sess2.problem.spec)
    say(f"[sharded-table2] {len(rsizes)} groups, p {p2}: {fp2.n_shards} "
        f"blocks of widths {fp2.widths.tolist()}, p_shard {fp2.p_shard}; "
        f"X {4 * N2 * p2 / 2**20:.1f} MiB on the card, its blocks "
        f"{4 * SHARDS * N2 * fp2.p_shard / 2**20:.1f} MiB more")
    require(fp2.n_shards == SHARDS and len(set(fp2.widths.tolist())) > 1,
            "sharded-table2: not 8 blocks of unequal width")
    require_sharded_path(r2s, c2s, "sharded-table2-ragged-4", SHARDS)
    compare_same_dtype(r2s, r2u, "sharded-table2-ragged-4")
    out["table2-sharded-path"] = c2s
    lap("Table 2 shape, data and both paths")

    cv_plan = T.Plan(**dict(CV_PLAN, n_lambdas=20))
    sess_cv = T.SGLSession(T.Problem.sgl(X, y, sizes))
    (cu, _, _, _), (cs, ccs, _, calls_cv), shapes_cv = pair(
        "sgl-cv-20", run_cv, sess_cv, cv_plan,
        (snf, "screen_norms_folds_cuda"))
    st = cs.stats
    require(st.n_pallas_screens == st.n_screens > 0 and
            ccs["screen_norms_folds"] == SHARDS * st.n_screens and
            ccs["sgl_prox"] == st.fista_iters == calls_cv.iters and
            ccs["xtv"] == calls_cv.rows and
            ccs["screen_norms"] == ccs["dpc_screen_folds"] == 0,
            f"sharded-sgl-cv-20: launches {ccs} are not {SHARDS} x "
            f"{st.n_screens} screen_norms_folds, {st.fista_iters} sgl_prox, "
            f"{calls_cv.rows} xtv")
    compare_same_dtype(cs, cu, "sharded-sgl-cv-20", betas="fold_betas")
    require(abs(cs.best_index - cu.best_index) <= 1,
            "sharded-sgl-cv-20: selection more than one step away")
    out["sgl-cv-sharded"] = ccs
    lap("SGL CV pair")

    Xn, yn, _ = synthetic_nn(1, N=N, p=n * G, seed=1)
    sess_nn = T.SGLSession(T.Problem.nn_lasso(Xn, yn))
    (nu, _, _, _), (ns, cns, _, _), shapes_nn = pair(
        "nn-cv-20", run_cv, sess_nn, cv_plan, (dsf, "dpc_screen_folds_cuda"))
    st = ns.stats
    require(st.n_pallas_screens == st.n_screens > 0 and
            cns["dpc_screen_folds"] == SHARDS * st.n_screens and
            cns["xtv"] > 0 and cns["screen_norms_folds"] ==
            cns["screen_norms"] == cns["sgl_prox"] == 0,
            f"sharded-nn-cv-20: launches {cns} are not {SHARDS} x "
            f"{st.n_screens} dpc_screen_folds and xtv")
    compare_same_dtype(ns, nu, "sharded-nn-cv-20", betas="fold_betas")
    out["nn-cv-sharded"] = cns
    nn_plan = T.Plan(n_lambdas=20, tol=1e-6, safety=1e-6, max_iter=6000,
                     check_every=50)
    (pu, _, _, _), (ps, cps, _, _), _ = pair("table3-nn-20", run_path,
                                             sess_nn, nn_plan)
    require_sharded_path(ps, cps, "sharded-table3-nn-20", SHARDS,
                         screen_kernel=False)
    compare_same_dtype(ps, pu, "sharded-table3-nn-20")
    out["table3-nn-sharded-path"] = cps
    lap("NN CV and path pairs")
    two_ranks(torch, T, X, y, sizes, plan.with_(n_lambdas=20,
                                                feature_shards=0))
    lap("two ranks, with the stacked run")

    def checks():
        # the sharded shapes: a block's C (L, p_shard), the stacked fold
        # rows (K*L, G_shard, n_max) and (K, L, p_shard) of each route's
        # first screen
        floor = time_ms(torch, lambda: torch.empty(1, device="cuda").zero_())
        return sharded_kernel_checks(
            torch, sess.problem.X, sess.problem.spec, shapes1.shapes[0],
            sess2.problem.X, sess2.problem.spec, shapes2[0], shapes_cv[0],
            shapes_nn[0], floor)
    return out, checks


# ---------------------------------------------------------------------------
# phase 20: the fold mesh, and the audits of every session
# ---------------------------------------------------------------------------

class KeyAudit:
    """Records, for every ``SGLSession`` the smoke builds while it is
    installed, each verb it ran and whether a refit ran on its graph cache
    (``solve_sgl`` through ``repro_torch.api`` or ``repro_torch.core``
    with the session's ``fista_graphs``: the estimators' refits and the
    serving phase's solo references), so that ``check`` can hold the
    sweep-shape keys and FISTA graphs it paid to
    ``repro_torch.analysis.compile_audit``'s universes.  The wrappers only append references, so no audit work
    falls inside a phase's timed window: the plans are resolved in
    ``check``, and a session's key sets are copied there or, if the
    session is collected first, by its finalizer.  It holds no session
    alive."""
    VERBS = ("path", "cv", "refine", "stability")

    def __init__(self, T):
        import repro_torch.api as api
        self.cls, self.entries = T.SGLSession, []
        self.saved = {v: getattr(self.cls, v) for v in self.VERBS}
        for verb, fn in self.saved.items():
            setattr(self.cls, verb, self._wrap(verb, fn))
        self.solvers = {m: m.solve_sgl for m in (api, T)}
        for m, fn in self.solvers.items():
            m.solve_sgl = self._refit(fn)

    @staticmethod
    def _settle(entry, problem, keys, graphs):
        from repro_torch.analysis import compile_audit as ca
        entry.update(shape=ca.ProblemShape.of(problem), paid=set(keys),
                     graphs=set(graphs))

    def _entry(self, sess) -> dict:
        entry = sess.__dict__.get("_key_audit")
        if entry is None:
            entry = sess._key_audit = dict(calls=[], refit=False,
                                           session=weakref.ref(sess))
            entry["fin"] = weakref.finalize(
                sess, self._settle, entry, sess.problem, sess.compile_keys,
                sess.fista_graphs)
            entry["fin"].atexit = False
            self.entries.append(entry)
        return entry

    def _wrap(self, verb, fn):
        def call(sess, *args, **kw):
            out = fn(sess, *args, **kw)
            st = sess._last_cv if verb == "refine" else None
            self._entry(sess)["calls"].append(
                (verb, args, kw, sess.default_plan,
                 None if st is None else (st.plan, st.result.lambdas)))
            return out
        return call

    def _refit(self, fn):
        def call(*args, graphs=None, **kw):
            for e in self.entries:
                sess = e["session"]()
                if sess is not None and sess.fista_graphs is graphs:
                    e["refit"] = True
            return fn(*args, graphs=graphs, **kw)
        return call

    def close(self):
        for verb, fn in self.saved.items():
            setattr(self.cls, verb, fn)
        for m, fn in self.solvers.items():
            m.solve_sgl = fn

    @staticmethod
    def _runs(calls) -> list:
        """(plan, kinds, n_folds) of each recorded verb, its plan resolved
        as ``SGLSession._resolve`` does (the refined grid's plan for
        ``refine``, which becomes the session's CV state)."""
        runs = []
        for verb, args, kw, default, refined in calls:
            if verb == "refine":
                plan, lambdas = refined
                runs.append((plan.with_(lambdas=np.asarray(lambdas)),
                             ("cv",), None))
                continue
            kw = dict(kw)
            plan = args[0] if args else kw.pop("plan", None)
            plan = default if plan is None else plan
            if kw:
                plan = plan.with_(**kw)
            n_folds = plan.batch_size if verb == "stability" else None
            runs.append((plan, ("path",) if verb == "path" else ("cv",),
                         n_folds))
        return runs

    def check(self) -> tuple:
        """(sessions, keys, graphs audited, findings).  Every session's
        keys against the union of its runs' key universes, its graphs
        against the union of their graph universes, with the full-design
        refit's where a refit ran on the session's graph cache."""
        from repro_torch.analysis import compile_audit as ca
        findings, n_keys, n_graphs = [], 0, 0
        for i, e in enumerate(self.entries):
            e["fin"]()              # copies the keys of a live session
            refit = ("refit",) if e["refit"] else ()
            keys, graphs = set(), set()
            for plan, kinds, n_folds in self._runs(e["calls"]):
                keys |= ca.predict_keys(e["shape"], plan, kinds, n_folds)
                graphs |= ca.predict_graph_keys(e["shape"], plan,
                                                kinds + refit)
            label = f"session {i} ({e['shape'].penalty}, p {e['shape'].p})"
            findings += ca.verify_paid_keys(e["paid"], keys, label)
            findings += ca.verify_paid_graphs(e["graphs"], graphs, label)
            n_keys += len(e["paid"])
            n_graphs += len(e["graphs"])
        return len(self.entries), n_keys, n_graphs, findings


def run_ranks(target, world, args, load, label, timeout=300.0):
    """``target(rank, world, rendezvous, out_dir, *args)`` on ``world``
    spawned ranks sharing the card (a ``gloo`` group, a ``file://``
    rendezvous under ``build/``).  Requires every rank to exit 0 within
    ``timeout``; kills the rest.  Returns ([load(out_dir, rank)], wall
    seconds with start-up)."""
    import multiprocessing as mp
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=target, args=(
            r, world, f"{tmp}/rendezvous", tmp) + tuple(args))
            for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(max(timeout - (time.perf_counter() - t0), 0.0))
        finally:
            alive = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        wall = time.perf_counter() - t0
        note_wall(wall)
        codes = [p.exitcode for p in procs]
        require(not alive, f"{label}: ranks {alive} still running after "
                f"{timeout} s")
        require(codes == [0] * world, f"{label}: rank exit codes {codes} "
                f"(a rank's traceback is on stderr; a gloo refusal of a "
                f"CUDA tensor ends here)")
        return [load(tmp, r) for r in range(world)], wall


FOLD_STATS = ("n_segments", "n_screens", "n_pallas_screens",
              "n_compilations", "n_rejected", "fista_iters")


def fold_stats(res) -> dict:
    st = res.stats
    out = {f: int(getattr(st, f)) for f in FOLD_STATS}
    out["buckets"] = [[int(v) for v in b] for b in st.buckets]
    out["fold_sweeps"] = [int(v) for v in st.fold_sweeps]
    return out


def _rank_fold_cv(rank, world, init_file, out_dir, mesh_args, cases, N, G,
                  n):
    """One rank of a fold-mesh run (a spawned process): joins the ``gloo``
    group, builds the mesh (``make_fold_mesh(K)`` or
    ``make_fold_feature_mesh(K, S)``), runs each case's float32 CV on the
    card under it with the counts reset just before, audits the session's
    keys and graphs, and writes betas and counters to ``out_dir``."""
    import datetime
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    import repro_torch.core as T
    from repro_torch.analysis import compile_audit as ca
    from repro_torch.data_synth import synthetic_nn, synthetic_sgl
    from repro_torch.distributed import feature_shard as fs
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as M
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = (M.make_fold_mesh(*mesh_args) if len(mesh_args) == 1
                else M.make_fold_feature_mesh(*mesh_args))
        out = {}
        for label, penalty, plan_kw in cases:
            if penalty == "sgl":
                X, y, _ = synthetic_sgl(1, N=N, G=G, n=n, gamma1=0.1,
                                        gamma2=0.1, seed=1)
                prob = T.Problem.sgl(X, y, [n] * G)
            else:
                X, y, _ = synthetic_nn(1, N=N, p=n * G, seed=1)
                prob = T.Problem.nn_lasso(X, y)
            sess = T.SGLSession(prob)
            plan = T.Plan(mesh=mesh, **plan_kw)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            M.reset_fold_counts()
            fs.reset_collective_counts()
            t0 = time.perf_counter()
            res = sess.cv(plan)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            shape = ca.ProblemShape.of(prob)
            found = ca.verify_paid_keys(
                sess.compile_keys, ca.predict_keys(shape, plan, ("cv",)))
            found += ca.verify_paid_graphs(
                sess.fista_graphs, ca.predict_graph_keys(shape, plan,
                                                         ("cv",)))
            np.save(f"{out_dir}/{label}-rank{rank}.npy", res.fold_betas)
            np.save(f"{out_dir}/{label}-mse-rank{rank}.npy", res.mean_mse)
            out[label] = dict(
                wall=wall, launches=ops.launch_counts(),
                tally=M.fold_counts(), collectives=fs.collective_counts(),
                stats=fold_stats(res), best_index=int(res.best_index),
                coords=mesh.coords, findings=[str(f) for f in found])
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _load_fold_rank(cases):
    def load(tmp, r):
        with open(f"{tmp}/rank{r}.json") as f:
            info = json.load(f)
        for label, _, _ in cases:
            info[label]["betas"] = np.load(f"{tmp}/{label}-rank{r}.npy")
            info[label]["mean_mse"] = np.load(f"{tmp}/{label}-mse-rank{r}.npy")
        return info
    return load


def _same_cv(got, ref, label):
    """A mesh run's (betas, mean MSE, selection, counters) against the
    unsplit run's: bit for bit."""
    require(np.array_equal(got["betas"], ref.fold_betas),
            f"{label}: fold betas differ from the unsplit run's (max "
            f"{float(np.abs(got['betas'] - ref.fold_betas).max()):.3e})")
    require(np.array_equal(got["mean_mse"], ref.mean_mse) and
            got["best_index"] == ref.best_index,
            f"{label}: mean MSE or selection differ from the unsplit run's")
    require(got["stats"] == fold_stats(ref), f"{label}: EngineStats "
            f"{got['stats']} differ from the unsplit run's "
            f"{fold_stats(ref)}")


def fold_mesh_phase(torch, T, card, N=250, G=1000, n=10):
    """``Plan(mesh=...)`` on the card at Synthetic 1's full width: a mesh
    of one in process (K 5, 20 lambdas) against no mesh; two ``gloo``
    ranks on ``make_fold_mesh(4)`` (SGL CV K 4 at 20 lambdas, NN CV K 4 at
    10) and four on ``make_fold_feature_mesh(2, 2)`` (SGL CV K 4 at 10
    lambdas, ``feature_shards=2``), each against its unsplit run in this
    process, bit for bit.  Returns the launches by route."""
    from repro_torch.data_synth import synthetic_nn, synthetic_sgl
    from repro_torch.launch import mesh as M
    X, y, _ = synthetic_sgl(1, N=N, G=G, n=n, gamma1=0.1, gamma2=0.1, seed=1)
    Xn, yn, _ = synthetic_nn(1, N=N, p=n * G, seed=1)
    sizes = [n] * G
    cv20 = dict(CV_PLAN, n_lambdas=20)
    out = {}

    def sgl():
        return T.SGLSession(T.Problem.sgl(X, y, sizes))

    # 1. a mesh of one: the sweep itself, every number unchanged
    mesh1 = M.make_fold_mesh(5)

    def probe(v):
        return v
    require(mesh1.size == 1 and mesh1.axis_names == ("fold",) and
            M.shard_over_folds(probe, mesh1, (0,)) is probe,
            "fold-mesh-one: make_fold_mesh(5) in one process is not a mesh "
            "of one, or shard_over_folds wrapped the sweep")
    a, counts_none, _, _ = run_cv(torch, sgl(), T.Plan(**cv20), "fold-mesh-none-k5")
    M.reset_fold_counts()
    b, counts_one, _, _ = run_cv(torch, sgl(), T.Plan(mesh=mesh1, **cv20),
                         "fold-mesh-one-k5")
    _same_cv(dict(betas=b.fold_betas, mean_mse=b.mean_mse,
                  best_index=b.best_index, stats=fold_stats(b)), a,
             "fold-mesh-one-k5")
    require(counts_one == counts_none and M.fold_counts() == dict.fromkeys(
        M.FOLD_TALLIES, 0), f"fold-mesh-one-k5: launches {counts_one} "
            f"against {counts_none}, tally {M.fold_counts()}")
    out["fold-mesh-one-k5"] = counts_one
    say(f"[fold-mesh-one-k5] equal to mesh=None bit for bit: betas, "
        f"mean_mse, best_index {b.best_index}, EngineStats, launches")

    # the unsplit twins of the rank runs
    k4 = dict(cv20, n_folds=4)
    cases2 = [("sgl-k4", "sgl", k4),
              ("nn-k4", "nn", dict(k4, n_lambdas=10))]
    twin = {"sgl-k4": run_cv(torch, sgl(), T.Plan(**k4), "fold-k4-none"),
            "nn-k4": run_cv(torch, T.SGLSession(T.Problem.nn_lasso(Xn, yn)),
                            T.Plan(**cases2[1][2]), "fold-nn-k4-none")}
    case4 = ("sgl-k4-feat2", "sgl", dict(k4, n_lambdas=10,
                                         feature_shards=2))
    twin[case4[0]] = run_cv(torch, sgl(), T.Plan(**case4[2]),
                            "fold-k4-feat2-stacked")

    # 2. two ranks on make_fold_mesh(4), 3. four on a 2 x 2 fold-feature
    for world, mesh_args, cases in ((2, (4,), cases2),
                                    (4, (2, 2), [case4])):
        ranks, wall = run_ranks(_rank_fold_cv, world, (
            mesh_args, cases, N, G, n), _load_fold_rank(cases),
            f"fold-mesh-{world}-ranks")
        S = 1 if len(mesh_args) == 1 else mesh_args[1]
        for label, penalty, _ in cases:
            ref, ref_counts = twin[label][0], twin[label][1]
            tag = f"fold-mesh-{world}-ranks-{label}"
            rows = [r[label] for r in ranks]
            for r, info in enumerate(rows):
                _same_cv(info, ref, f"{tag} rank {r}")
                require(info["findings"] == [], f"{tag} rank {r}: "
                        f"{info['findings']}")
                require(info["tally"] == rows[0]["tally"],
                        f"{tag}: the ranks' tallies differ")
            t, st = rows[0]["tally"], rows[0]["stats"]
            require(t["sharded"] >= 1 and
                    t["sharded"] + t["unsharded"] == st["n_segments"] and
                    t["all_gather"] == t["sharded"], f"{tag}: tally {t} "
                    f"against {st['n_segments']} launches")
            total = {k: sum(r["launches"][k] for r in rows)
                     for k in rows[0]["launches"]}
            screen = ("screen_norms_folds" if penalty == "sgl"
                      else "dpc_screen_folds")
            # the sweeps split over the fold axis and repeat over the
            # feature axis; every rank screens, one block of S.  An
            # unsplit launch runs on each of the d ranks of a fold group,
            # so with one the sums lie between one and d times the split
            lo = S
            hi = S if t["unsharded"] == 0 else S * (world // S)
            prox = st["fista_iters"] if penalty == "sgl" else 0
            xtv = ref_counts["xtv"]
            require(lo * prox <= total["sgl_prox"] <= hi * prox and
                    lo * xtv <= total["xtv"] <= hi * xtv and
                    all(r["launches"][screen] == st["n_screens"]
                        for r in rows), f"{tag}: launches "
                    f"{[r['launches'] for r in rows]} are not the split of "
                    f"{ref_counts} ({st['fista_iters']} FISTA iterations, "
                    f"{st['n_screens']} stacked screens)")
            out[tag] = total
            say(f"[{tag}] {world} gloo ranks on one card, mesh "
                f"{mesh_args}: {wall:.3f} s with start-up; CV wall a rank "
                f"{[round(r['wall'], 3) for r in rows]} s (unsplit "
                f"{twin[label][2]:.3f} s); FISTA iterations "
                f"{st['fista_iters']}; tally {json.dumps(t)}; launches a "
                f"rank {[r['launches'] for r in rows]}; collectives a "
                f"rank {[r['collectives'] for r in rows]}; betas equal "
                f"to the unsplit run's bit for bit on every rank; {card}")
    return out


def audit_sessions(audit):
    """Every session this process built while ``audit`` was installed,
    against the compile audit's universes."""
    audit.close()
    sessions, n_keys, n_graphs, found = audit.check()
    say(f"[audit] {sessions} sessions: {n_keys} sweep-shape keys and "
        f"{n_graphs} FISTA graphs paid, findings {len(found)}")
    require(found == [], f"audit: {[str(f) for f in found[:5]]}")


def audit_kernels():
    """The kernel audit on the card: mask coverage under poison and the
    float64 gate."""
    from repro_torch.analysis import kernel_check
    errors = {}
    found = kernel_check.mask_coverage("cuda", errors)
    say(f"[audit] mask coverage on the card under 1e30 poison: "
        f"max_abs_err {json.dumps(errors)}, findings {len(found)}")
    require(found == [] and len(errors) == 5,
            f"audit: mask coverage {[str(f) for f in found]}")
    found = kernel_check.f64_gate()
    require(found == [], f"audit: f64 gate {[str(f) for f in found]}")
    say("[audit] f64 gate: the three grid screens refuse use_kernels=True "
        "on float64")


# ---------------------------------------------------------------------------
# phase 21: the LM zoo (dense, MLA, MoE, Mamba2 with shared attention, xLSTM,
# the enc-dec family and the vision prefix)
# ---------------------------------------------------------------------------

LM_STEPS = 20            # the host draws every batch (PERF.md section 5);
                         # (d), (t) and (u) read its losses


def _step_stats(times, tokens):
    """(first step ms, median ms of the others, tokens/s at that median)."""
    warm = times[1:] if len(times) > 1 else times
    med = float(np.median(warm))
    return 1e3 * times[0], 1e3 * med, tokens / med


def _zeros(w):
    return int((w == 0).sum())


def lm_example_phase(torch, dev="cuda"):
    """(a) The example's configuration (``gemma2-100m``) through the port's
    example driver for ``LM_STEPS`` steps, the SGL prox after each; its
    pruning-threshold curve in float32 on the kernel route and its float64
    twin.  Returns (run, curve launch counts, graphed-solve record)."""
    from repro_torch.examples import sgl_pruned_lm as ex
    from repro_torch.sparsity import group_reg
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    # the training launches no kernel of the port; the curve does
    run, counts, wall, calls = run_counted(
        torch, "lm-example", lambda: ex.main(
            ["--steps", str(LM_STEPS), "--device", dev],
            step_times=times))
    peak = torch.cuda.max_memory_allocated() - base
    losses = run["losses"]
    first, med, tok_s = _step_stats(times, 8 * 256)
    say(f"[lm-example] gemma2-100m ({len(losses)} steps, B 8, S 256, "
        f"float32): loss {losses[0]:.4f} -> {losses[-1]:.4f}; train step "
        f"(the step alone) first {first:.1f} ms, median of the rest "
        f"{med:.2f} ms = {tok_s:.0f} tokens/s; peak device memory "
        f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB before")
    require(np.isfinite(losses).all() and losses[-1] < losses[0],
            "lm-example: the loss did not decrease")
    blocks = run["state"].params["blocks"]
    for lname in blocks.keys():
        ffn = group_reg.group_sparsity_stats(blocks[lname]["ffn"]["w_in"], 2)
        heads = group_reg.group_sparsity_stats(blocks[lname]["attn"]["wq"], 2)
        say(f"[lm-example] {lname} FFN channels {json.dumps(ffn)}; heads "
            f"{json.dumps(heads)}")
    require_curve(torch, run["curve"], run["surviving"], run["signal"],
                  counts, calls, "lm-curve", dev)
    run["peak"] = peak
    return run, counts, calls


def require_curve(torch, res, surv, signal, counts, calls, label, dev):
    """A pruning-threshold curve in float32 on the card: ``xtv`` once a row
    certified, ``screen_norms`` once a screen (``n_pallas_screens``),
    ``sgl_prox`` once a FISTA iteration through graphed blocks, no other
    kernel; its float64 twin (no kernel) keeps the same channels on every
    row."""
    from repro_torch.examples import sgl_pruned_lm as ex
    from repro_torch.kernels import ops
    st = res.stats
    rows = rows_run(res)
    say(f"[{label}] f32 on the card: {len(res.lambdas)} lambdas over "
        f"{len(signal)} channels, surviving channels {surv.tolist()}; rows "
        f"certified {rows}, n_screens {st.n_screens} n_pallas_screens "
        f"{st.n_pallas_screens} fista iterations {st.fista_iters} (graphed "
        f"{calls.iters}, eager solves {calls.eager_solves}) n_rejected "
        f"{st.n_rejected}; launches {json.dumps(counts)}")
    require_only(counts, label, PATH_KERNELS)
    require(counts["xtv"] == rows == calls.rows > 0,
            f"{label}: xtv launches {counts['xtv']}, rows certified {rows}, "
            f"rows solved {calls.rows}")
    require(counts["screen_norms"] == st.n_pallas_screens == st.n_screens,
            f"{label}: screen_norms launches {counts['screen_norms']}, "
            f"n_pallas_screens {st.n_pallas_screens}")
    require(counts["sgl_prox"] == st.fista_iters == calls.iters > 0
            and calls.eager_solves == 0,
            f"{label}: sgl_prox launches {counts['sgl_prox']}, FISTA "
            f"iterations {st.fista_iters}, graphed {calls.iters}")
    ops.reset_launch_counts()
    res64, surv64 = ex.pruning_threshold_curve(signal, device=dev,
                                               dtype=torch.float64)
    require(sum(ops.launch_counts().values()) == 0,
            f"{label}: the float64 twin launched a kernel")
    say(f"[{label}] f64 twin surviving channels {surv64.tolist()}; "
        f"max|beta_f32 - beta_f64| "
        f"{float(np.abs(res.betas - res64.betas).max()):.3e}")
    require(np.array_equal(surv, surv64),
            f"{label}: the float32 and float64 curves keep other channels")


def lm_full_width_phase(torch, dev="cuda"):
    """(b) ``gemma2-2b`` at its published width and depth through
    ``train.main``, float32, 3 steps at B 2, S 256, the SGL prox on."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as model_lib
    n_params = model_lib.param_count(get_config("gemma2-2b"))
    times = []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, state = train_mod.main(
        ["--arch", "gemma2-2b", "--steps", "3", "--global-batch", "2",
         "--seq", "256", "--lr", "3e-4", "--sgl-lambda", "3e-4",
         "--log-every", "1", "--device", dev], return_state=True,
        step_times=times)
    peak = torch.cuda.max_memory_allocated()
    pb = state.params["blocks"]
    zeros = {name: sum(_zeros(pb[l][mod][name]) for l in pb.keys())
             for mod, name in (("attn", "wq"), ("ffn", "w_in"),
                               ("attn", "wk"))}
    first, med, tok_s = _step_stats(times, 2 * 256)
    say(f"[lm-gemma2-2b] {n_params} parameters, float32: losses "
        f"{[round(l, 4) for l in losses]}; train step first {first:.1f} ms, "
        f"median of the rest {med:.1f} ms = {tok_s:.0f} tokens/s; peak "
        f"device memory {peak / 2**30:.3f} GiB; exact zeros after the prox "
        f"(both block kinds) wq {zeros['wq']}, w_in {zeros['w_in']}, wk "
        f"(no prox) {zeros['wk']}")
    require(len(losses) == 3 and np.isfinite(losses).all(),
            "lm-gemma2-2b: non-finite losses")
    require(zeros["wq"] > 0 and zeros["w_in"] > 0 and zeros["wk"] == 0,
            "lm-gemma2-2b: the SGL prox left no zero in its groups")
    del state
    torch.cuda.empty_cache()
    return dict(step_ms=med, first_step_ms=first, tokens_per_s=tok_s,
                peak_gib=peak / 2**30)


def lm_serve_phase(torch, dev="cuda"):
    """(c) ``serve.main`` on ``gemma2-2b`` at full width (batch 4, prompt
    16, gen 32, cache 128); then decode against the full forward on the
    example's config at T 300 > window 256 with a 512-slot cache, so the
    local ring wraps: within 2e-2, the reference's bar, and within 1e-4,
    the bar of the card test (a freshly drawn model's logits are about 0.1
    in size, so 2e-2 alone would pass a wrong ring slot)."""
    from repro_torch.examples import sgl_pruned_lm as ex
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as model_lib
    lat = []
    gen = serve_mod.main(["--arch", "gemma2-2b", "--batch", "4",
                          "--prompt-len", "16", "--gen", "32", "--cache-len",
                          "128", "--device", dev], latencies=lat)
    warm = np.asarray(lat[1:]) * 1e3
    p50, p99 = np.percentile(warm, 50), np.percentile(warm, 99)
    tok_s = 4 * len(warm) / (warm.sum() / 1e3)
    say(f"[lm-serve] gemma2-2b float32 batch 4: per-step p50 {p50:.3f} ms "
        f"p99 {p99:.3f} ms (warm; first step {1e3 * lat[0]:.3f} ms), "
        f"{tok_s:.1f} tokens/s")
    require(gen.shape == (4, 32) and ((gen >= 0) & (gen < 256000)).all(),
            "lm-serve: wrong generated tokens")
    torch.cuda.empty_cache()

    cfg = ex.example_config()
    params = model_lib.init_params(cfg, torch.Generator(
        device=dev).manual_seed(1))
    B, T = 2, 300
    toks = torch.as_tensor(np.random.default_rng(21).integers(
        0, cfg.vocab_size, (B, T)), device=dev)
    with torch.no_grad():
        x = model_lib.embed_tokens(params, cfg, toks, torch.float32)
        x, _, _ = model_lib.decoder_stack(params, x, torch.arange(
            T, device=dev), cfg, remat="none")
        full = model_lib.logits_fn(params, cfg, model_lib.rms_norm(
            x, params["final_norm"], cfg.norm_eps))
        caches = model_lib.init_cache(cfg, B, 512, torch.float32,
                                      device=dev)
        slots = caches["blocks"]["l0"].k.shape[2]
        errs = torch.zeros(T, device=dev)
        for t in range(T):
            logits, caches = model_lib.forward_decode(
                params, cfg, caches, toks[:, t:t + 1], t,
                compute_dtype=torch.float32)
            errs[t] = (logits[:, 0] - full[:, t]).abs().max()
    err = float(errs.max())
    say(f"[lm-decode] gemma2-100m: decode against the full forward, T {T}, "
        f"window {cfg.window_size}, local ring {slots} slots (wraps at "
        f"{slots}), global cache 512: max|logits diff| {err:.3e} (the "
        f"reference's bar 2e-2, and 1e-4, the card test's); after the wrap "
        f"{float(errs[slots:].max()):.3e}")
    require(slots == cfg.window_size and err < 2e-2 and err < 1e-4,
            "lm-decode: decode disagrees with the full forward")
    return dict(p50_ms=p50, p99_ms=p99, tokens_per_s=tok_s,
                decode_err=err)


def lm_resume_phase(torch, losses, dev="cuda"):
    """(d) The example's run to step 2 with a checkpoint, then resumed to
    step 4: the losses of steps 3-4 equal the uninterrupted run's within
    1e-5 relative (the embedding's backward uses atomics).  Returns a
    directory holding a copy of the step-2 checkpoint, for (t) to resume
    on two ranks (the caller removes it)."""
    import shutil
    import tempfile
    from repro_torch.examples import sgl_pruned_lm as ex
    from repro_torch.launch import train as train_mod
    (ROOT / "build").mkdir(exist_ok=True)
    ck = tempfile.mkdtemp(prefix="lm_ckpt_", dir=ROOT / "build")
    keep = tempfile.mkdtemp(prefix="lm_ckpt_d2_", dir=ROOT / "build")
    try:
        train_mod.main(ex.train_argv(2, dev) + [
            "--ckpt-dir", ck, "--ckpt-every", "2"])
        shutil.copytree(Path(ck) / "step_00000002",
                        Path(keep) / "step_00000002")
        resumed = train_mod.main(ex.train_argv(4, dev) + [
            "--ckpt-dir", ck, "--resume"])
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    rel = np.abs(np.asarray(resumed) / np.asarray(losses[2:4]) - 1)
    say(f"[lm-resume] steps 3-4 resumed from the step-2 checkpoint "
        f"{resumed} against {losses[2:4]}: max relative diff "
        f"{float(rel.max()):.3e} (bar 1e-5)")
    require(len(resumed) == 2 and float(rel.max()) <= 1e-5,
            "lm-resume: the resumed losses differ")
    return keep


def lm_moe_train_phase(torch, dev="cuda"):
    """(e) ``granite-moe-1b-a400m`` at its published width and depth
    through ``train.main``, float32, 4 steps at B 4, S 256, the SGL prox
    on.  Returns its trained ``ffn/w_in`` channel signal (the example's
    ``ffn_channel_signal``: one norm a channel of ``moe_d_ff``) and each
    step's metrics (loss, ce, aux, the prox's exact zeros)."""
    from repro_torch.configs.base import get_config
    from repro_torch.examples import sgl_pruned_lm as ex
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as model_lib
    cfg = get_config("granite-moe-1b-a400m")
    times, metrics = [], []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, state = train_mod.main(
        ["--arch", cfg.name, "--steps", "4", "--global-batch", "4",
         "--seq", "256", "--lr", "3e-4", "--sgl-lambda", "3e-4",
         "--log-every", "1", "--device", dev], return_state=True,
        step_times=times, step_metrics=metrics)
    peak = torch.cuda.max_memory_allocated()
    pb = state.params["blocks"]["l0"]
    zeros = {"wq": _zeros(pb["attn"]["wq"]), "w_in": _zeros(pb["ffn"]["w_in"])}
    first, med, tok_s = _step_stats(times, 4 * 256)
    aux = [m["aux"] for m in metrics]
    say(f"[lm-granite-moe] {model_lib.param_count(cfg)} parameters, "
        f"{cfg.num_experts} experts top {cfg.experts_per_token}, float32, "
        f"B 4, S 256: losses {[round(l, 4) for l in losses]}, aux "
        f"{[round(a, 4) for a in aux]}; train step first {first:.1f} ms, "
        f"median of the rest {med:.1f} ms = {tok_s:.0f} tokens/s; peak "
        f"device memory {peak / 2**30:.3f} GiB; exact zeros after the prox: "
        f"wq (head groups) {zeros['wq']}, w_in (expert groups) "
        f"{zeros['w_in']}")
    require(len(losses) == 4 and np.isfinite(losses).all()
            and np.isfinite(aux).all(), "lm-granite-moe: non-finite losses")
    require(zeros["wq"] > 0 and zeros["w_in"] > 0,
            "lm-granite-moe: the SGL prox left no zero in its groups")
    signal = ex.ffn_channel_signal(state.params)
    require(signal.shape == (cfg.moe_d_ff,),
            f"lm-granite-moe: channel signal of shape {signal.shape}")
    del state, pb
    gc.collect()         # free the state before (g) reads its peak
    torch.cuda.empty_cache()
    return signal, metrics


def lm_moe_curve_phase(torch, signal, dev="cuda"):
    """(f) The pruning-threshold curve of (e)'s trained expert channels
    (G = ``moe_d_ff`` = 512) through ``pruning_threshold_curve``, with the
    gates of (a)'s curve.  Returns (launch counts, graphed-solve record,
    the curve)."""
    from repro_torch.examples import sgl_pruned_lm as ex
    (res, surv), counts, _, calls = run_counted(
        torch, "lm-moe-curve",
        lambda: ex.pruning_threshold_curve(signal, device=dev))
    require_curve(torch, res, surv, signal, counts, calls, "lm-moe-curve",
                  dev)
    return counts, calls, res


def lm_mla_serve_phase(torch, dev="cuda"):
    """(g) ``serve.main`` on ``minicpm3-4b`` at its published width and
    depth (batch 4, prompt 16, gen 32, cache 128; the absorbed MLA decode
    over the latent cache); then the absorbed decode of 16 tokens against
    the expanded full forward on the same weights (B 1): within
    ``1e-3 * max|logits|``."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as model_lib
    cfg = get_config("minicpm3-4b")
    lat = []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = serve_mod.main(["--arch", cfg.name, "--batch", "4",
                          "--prompt-len", "16", "--gen", "32", "--cache-len",
                          "128", "--device", dev], latencies=lat)
    peak = torch.cuda.max_memory_allocated()
    warm = np.asarray(lat[1:]) * 1e3
    p50, p99 = np.percentile(warm, 50), np.percentile(warm, 99)
    tok_s = 4 * len(warm) / (warm.sum() / 1e3)
    say(f"[lm-minicpm3] {model_lib.param_count(cfg)} parameters, float32 "
        f"batch 4, cache 128: per-step p50 {p50:.3f} ms p99 {p99:.3f} ms "
        f"(warm; first step {1e3 * lat[0]:.3f} ms), {tok_s:.1f} tokens/s; "
        f"peak device memory {peak / 2**30:.3f} GiB")
    require(gen.shape == (4, 32) and ((gen >= 0) & (gen < cfg.vocab_size))
            .all(), "lm-minicpm3: wrong generated tokens")
    torch.cuda.empty_cache()

    params = model_lib.init_params(cfg, torch.Generator(
        device=dev).manual_seed(0))
    T_ = 16
    toks = torch.as_tensor(np.random.default_rng(22).integers(
        0, cfg.vocab_size, (1, T_)), device=dev)
    with torch.no_grad():
        x = model_lib.embed_tokens(params, cfg, toks, torch.float32)
        x, _, _ = model_lib.decoder_stack(params, x, torch.arange(
            T_, device=dev), cfg, remat="none")
        full = model_lib.logits_fn(params, cfg, model_lib.rms_norm(
            x, params["final_norm"], cfg.norm_eps))
        caches = model_lib.init_cache(cfg, 1, T_, torch.float32, device=dev)
        errs = torch.zeros(T_, device=dev)
        for t in range(T_):
            logits, caches = model_lib.forward_decode(
                params, cfg, caches, toks[:, t:t + 1], t,
                compute_dtype=torch.float32)
            errs[t] = (logits[:, 0] - full[:, t]).abs().max()
    err, scale = float(errs.max()), float(full.abs().max())
    say(f"[lm-minicpm3] absorbed decode against the expanded full forward, "
        f"B 1, T {T_}, full width: max|logits diff| {err:.3e}, max|logits| "
        f"{scale:.3e}, bar 1e-3 * max|logits| = {1e-3 * scale:.3e}")
    require(err < 1e-3 * scale,
            "lm-minicpm3: the absorbed decode disagrees with the expanded "
            "forward")
    del params, caches
    torch.cuda.empty_cache()
    return dict(p50_ms=p50, p99_ms=p99, tokens_per_s=tok_s, decode_err=err)


def lm_deepseek_phase(torch, dev="cuda"):
    """(h) ``deepseek-v2-236b`` ``reduced()`` (a dense prologue layer, MLA,
    8 routed experts top 2 and 2 shared): 3 train steps (finite losses, aux
    > 0); decode of T 48 against the full forward at
    ``capacity_factor=None``, within 1e-4; the MoE layer called twice on
    the same input gives the same bits."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_mod
    cfg = get_config("deepseek-v2-236b").reduced()
    metrics = []
    losses = train_mod.main(
        ["--arch", "deepseek-v2-236b", "--smoke", "--steps", "3",
         "--global-batch", "4", "--seq", "64", "--lr", "1e-3",
         "--sgl-lambda", "3e-4", "--log-every", "1", "--device", dev],
        step_metrics=metrics)
    aux = [m["aux"] for m in metrics]
    say(f"[lm-deepseek-v2] reduced, float32: losses "
        f"{[round(l, 4) for l in losses]}, aux {[round(a, 4) for a in aux]}")
    require(len(losses) == 3 and np.isfinite(losses).all()
            and min(aux) > 0, "lm-deepseek-v2: non-finite losses or no aux")

    params = model_lib.init_params(cfg, torch.Generator(
        device=dev).manual_seed(2))
    B, T_ = 2, 48
    toks = torch.as_tensor(np.random.default_rng(23).integers(
        0, cfg.vocab_size, (B, T_)), device=dev)
    with torch.no_grad():
        x = model_lib.embed_tokens(params, cfg, toks, torch.float32)
        x, _, _ = model_lib.decoder_stack(params, x, torch.arange(
            T_, device=dev), cfg, remat="none", capacity_factor=None)
        full = model_lib.logits_fn(params, cfg, model_lib.rms_norm(
            x, params["final_norm"], cfg.norm_eps))
        caches = model_lib.init_cache(cfg, B, 64, torch.float32, device=dev)
        errs = torch.zeros(T_, device=dev)
        for t in range(T_):
            logits, caches = model_lib.forward_decode(
                params, cfg, caches, toks[:, t:t + 1], t,
                compute_dtype=torch.float32)
            errs[t] = (logits[:, 0] - full[:, t]).abs().max()
        ffn = {k: v[0] for k, v in params["blocks"]["l0"]["ffn"].items()}
        h = torch.randn((4, 64, cfg.d_model), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
        once, aux1 = moe_mod.moe_forward(ffn, h, cfg)
        twice, aux2 = moe_mod.moe_forward(ffn, h, cfg)
    err = float(errs.max())
    same = bool(torch.equal(once, twice) and torch.equal(aux1, aux2))
    say(f"[lm-deepseek-v2] decode against the full forward (lossless "
        f"dispatch), T {T_}: max|logits diff| {err:.3e} (bar 1e-4); the "
        f"MoE layer twice on (4, 64, {cfg.d_model}): bitwise equal {same}")
    require(err < 1e-4, "lm-deepseek-v2: decode disagrees with the full "
            "forward")
    require(same, "lm-deepseek-v2: two calls of the MoE layer differ")


def decode_errors(torch, cfg, params, toks, cache_len):
    """``toks`` (B, T) decoded step by step into a fresh ``cache_len``
    cache against the full forward on the same weights: (each step's
    max|logits diff| (T,), the full forward's max|logits|)."""
    from repro_torch.models import model as model_lib
    B, T_ = toks.shape
    with torch.no_grad():
        x = model_lib.embed_tokens(params, cfg, toks, torch.float32)
        x, _, _ = model_lib.decoder_stack(params, x, torch.arange(
            T_, device=toks.device), cfg, remat="none")
        full = model_lib.logits_fn(params, cfg, model_lib.rms_norm(
            x, params["final_norm"], cfg.norm_eps))
        caches = model_lib.init_cache(cfg, B, cache_len, torch.float32,
                                      device=toks.device)
        errs = torch.zeros(T_, device=toks.device)
        for t in range(T_):
            logits, caches = model_lib.forward_decode(
                params, cfg, caches, toks[:, t:t + 1], t,
                compute_dtype=torch.float32)
            errs[t] = (logits[:, 0] - full[:, t]).abs().max()
    return errs, float(full.abs().max())


def lm_train_full(torch, arch, B, S, label, dev="cuda"):
    """``train.main`` on ``arch`` at its published width and depth,
    float32, 3 steps at B x S, no prox: finite losses; prints the losses,
    the first and median step ms, tokens/s and the peak device memory."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as model_lib
    cfg = get_config(arch)
    times = []
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = train_mod.main(
        ["--arch", arch, "--steps", "3", "--global-batch", str(B), "--seq",
         str(S), "--lr", "3e-4", "--log-every", "1", "--device", dev],
        step_times=times)
    note_wall(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    first, med, tok_s = _step_stats(times, B * S)
    say(f"[{label}] {model_lib.param_count(cfg)} parameters, float32, B "
        f"{B}, S {S}, remat none: losses {[round(l, 4) for l in losses]}; "
        f"train step first {first:.1f} ms, median of the rest {med:.1f} ms "
        f"= {tok_s:.0f} tokens/s; peak device memory {peak / 2**30:.3f} GiB")
    require(len(losses) == 3 and np.isfinite(losses).all(),
            f"{label}: non-finite losses")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(step_ms=med, first_step_ms=first, tokens_per_s=tok_s,
                peak_gib=peak / 2**30)


def serve_cli(torch, arch, label, dev="cuda"):
    """``serve.main`` on ``arch`` at its published width and depth (batch
    4, prompt 16, gen 32, cache 128): warm p50 / p99 ms a step, tokens/s
    and the peak device memory printed."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve as serve_mod
    cfg = get_config(arch)
    lat = []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = serve_mod.main(["--arch", arch, "--batch", "4", "--prompt-len",
                          "16", "--gen", "32", "--cache-len", "128",
                          "--device", dev], latencies=lat)
    note_wall(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    warm = np.asarray(lat[1:]) * 1e3
    p50, p99 = np.percentile(warm, 50), np.percentile(warm, 99)
    tok_s = 4 * len(warm) / (warm.sum() / 1e3)
    say(f"[{label}] float32 batch 4, cache 128: per-step p50 {p50:.3f} ms "
        f"p99 {p99:.3f} ms (warm; first step {1e3 * lat[0]:.3f} ms), "
        f"{tok_s:.1f} tokens/s; peak device memory {peak / 2**30:.3f} GiB")
    require(gen.shape == (4, 32) and ((gen >= 0) & (gen < cfg.vocab_size))
            .all(), f"{label}: wrong generated tokens")
    _free(torch)
    return dict(p50_ms=p50, p99_ms=p99, tokens_per_s=tok_s,
                peak_gib=peak / 2**30)


def lm_serve_full(torch, arch, label, seed, dev="cuda", keep=False):
    """``serve_cli`` on ``arch``; then decode of 32 tokens against the full
    forward (B 1) on freshly drawn weights, within 1e-4 * max|logits|.
    ``keep``: also return those weights."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    cfg = get_config(arch)
    out = serve_cli(torch, arch, label, dev)
    params = model_lib.init_params(cfg, torch.Generator(
        device=dev).manual_seed(seed))
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, 32)), device=dev)
    t0 = time.perf_counter()
    errs, scale = decode_errors(torch, cfg, params, toks, 32)
    err = float(errs.max())
    note_wall(time.perf_counter() - t0)
    say(f"[{label}] decode against the full forward, B 1, T 32, full "
        f"width: max|logits diff| {err:.3e}, max|logits| {scale:.3e}, bar "
        f"1e-4 * max|logits| = {1e-4 * scale:.3e}")
    require(err < 1e-4 * scale,
            f"{label}: decode disagrees with the full forward")
    out["decode_err"] = err
    if keep:
        return out, params
    del params
    torch.cuda.empty_cache()
    return out


def lm_mamba_layer_phase(torch, dev="cuda"):
    """(k) One Mamba2 layer of ``zamba2-2.7b`` at full width (d 2 560, 80
    heads of 64, state 64, chunk 256) on freshly drawn weights, B 2, S 300:
    a full chunk and a padded tail of 44.  The chunked forward against
    the token-by-token decode within 1e-4 * max|y|; the gradient of
    ``sum(y**2)`` through the chunked form finite everywhere and within
    1e-3 relative L2 of the gradient through the decode recurrence, leaf
    by leaf."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import ssm
    from repro_torch.models.common import tree_init
    cfg = get_config("zamba2-2.7b")
    B, S = 2, 300
    gen = torch.Generator(device=dev).manual_seed(5)
    params = {k: v.detach().requires_grad_(True) for k, v in
              tree_init(ssm.mamba2_descs(cfg), gen).items()}
    keys = sorted(params)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    y, _ = ssm.mamba2_forward(params, x, cfg)
    g_chunk = torch.autograd.grad(torch.sum(y ** 2),
                                  [params[k] for k in keys])
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    conv, state = ssm.mamba2_cache_shape(cfg, B)
    cache = ssm.MambaCache(torch.zeros(conv, device=dev),
                           torch.zeros(state, device=dev))
    ys = []
    for t in range(S):
        y_t, cache = ssm.mamba2_forward(params, x[:, t:t + 1], cfg,
                                        cache=cache)
        ys.append(y_t)
    y_rec = torch.cat(ys, dim=1)
    g_rec = torch.autograd.grad(torch.sum(y_rec ** 2),
                                [params[k] for k in keys])
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    note_wall(chunk_s + rec_s)
    y, y_rec = y.detach(), y_rec.detach()
    y_err = float((y - y_rec).abs().max())
    y_scale = float(y_rec.abs().max())
    finite = all(bool(torch.isfinite(g).all()) for g in g_chunk)
    rel = {k: float(torch.linalg.vector_norm(a - b)
                    / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))
           for k, a, b in zip(keys, g_chunk, g_rec)}
    say(f"[lm-mamba2-layer] zamba2-2.7b's Mamba2 layer, B {B}, S {S} "
        f"(chunk {cfg.ssm_chunk} + a padded tail): chunked forward and "
        f"backward {1e3 * chunk_s:.1f} ms (peak {peak / 2**30:.3f} GiB above "
        f"the weights), the decode recurrence's {1e3 * rec_s:.1f} ms; "
        f"max|y_chunked - y_decode| {y_err:.3e} of max|y| {y_scale:.3e} "
        f"(bar 1e-4 * max|y|); chunked gradient finite {finite}; relative "
        f"L2 against the recurrence's {json.dumps({k: float(f'{v:.3e}') for k, v in rel.items()})} "
        f"(bar 1e-3)")
    require(finite, "lm-mamba2-layer: the chunked gradient is not finite")
    require(y_err <= 1e-4 * y_scale,
            "lm-mamba2-layer: the chunked forward disagrees with decode")
    require(max(rel.values()) < 1e-3,
            "lm-mamba2-layer: the chunked gradient disagrees with the "
            "recurrence's")
    del params, g_chunk, g_rec, y, y_rec, ys, cache
    torch.cuda.empty_cache()
    return dict(y_err=y_err, grad_rel=max(rel.values()))


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def _seeded_batch(torch, cfg, B, S, seed, dev, frames=0, patches=0):
    """A batch drawn from a seeded numpy generator, as the reference's
    smoke tests build one by hand: ``tokens`` and ``labels`` (B, S) from
    ``integers``, and ``frames`` (B, frames, d) or ``patches`` (B, patches,
    d) from a normal."""
    rng = np.random.default_rng(seed)
    ints = lambda: torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                   device=dev)
    batch = {"tokens": ints(), "labels": ints()}
    for key, n in (("frames", frames), ("patches", patches)):
        if n:
            batch[key] = torch.as_tensor(rng.standard_normal(
                (B, n, cfg.d_model), dtype=np.float32), device=dev)
    return batch


def train_steps(torch, cfg, batch, label, n_steps=3, prox=None, dev="cuda"):
    """``steps.make_train_step`` on ``cfg`` (float32, remat none, the
    learning rate of ``train.main``'s defaults at lr 3e-4) for ``n_steps``
    steps on one ``batch``, the SGL prox ``(t_l1, t_l2)`` after each when
    given: finite losses.  Returns (losses, step seconds, peak device
    bytes, the final ``TrainState``)."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init_params(cfg, torch.Generator(
        device=dev).manual_seed(0))
    state = adamw.init_state(params)
    del params
    step = steps_mod.make_train_step(
        cfg, remat="none", compute_dtype=torch.float32,
        lr_kwargs=dict(base_lr=3e-4, warmup=20, total=100))
    losses, times = [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        if prox is not None:
            train_mod.sgl_prox_step(state.params, cfg, *prox)
    note_wall(sum(times))
    peak = torch.cuda.max_memory_allocated()
    require(len(losses) == n_steps and np.isfinite(losses).all(),
            f"{label}: non-finite losses {losses}")
    return losses, times, peak, state


def prefill_p50(torch, cfg, params, batch, label, reps=5):
    """``steps.make_prefill_step`` on ``batch``: one cold call, then the
    p50 of ``reps`` warm calls (ms, each to its synchronize)."""
    from repro_torch.launch import steps as steps_mod
    prefill = steps_mod.make_prefill_step(cfg, compute_dtype=torch.float32)
    out = prefill(params, batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = prefill(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    note_wall(sum(times))
    require(tuple(out.shape) == (batch["tokens"].shape[0], 1,
                                 cfg.vocab_size)
            and bool(torch.isfinite(out).all()),
            f"{label}: prefill logits of shape {tuple(out.shape)}, or not "
            f"finite")
    return 1e3 * float(np.median(times))


def lm_seamless_train_phase(torch, dev="cuda"):
    """(m) ``seamless-m4t-medium`` (enc-dec, 12 + 12 layers, d 1 024, V
    256 206) at its published width and depth through
    ``steps.make_train_step``, float32, remat none, 3 steps at B 4, S 256
    (frames (4, 256, 1 024) from a normal, tokens and labels drawn from
    ``integers``): finite losses."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    cfg = get_config("seamless-m4t-medium")
    B, S = 4, 256
    batch = _seeded_batch(torch, cfg, B, S, 31, dev, frames=S)
    losses, times, peak, state = train_steps(torch, cfg, batch,
                                             "lm-seamless-train", dev=dev)
    first, med, tok_s = _step_stats(times, B * S)
    say(f"[lm-seamless-train] {model_lib.param_count(cfg)} parameters "
        f"({cfg.enc_layers} encoder + {cfg.dec_layers} decoder layers), "
        f"float32, B {B}, frames {S}, tokens {S}, remat none: losses "
        f"{[round(l, 4) for l in losses]}; train step first {first:.1f} ms, "
        f"median of the rest {med:.1f} ms = {tok_s:.0f} decoder tokens/s; "
        f"peak device memory {peak / 2**30:.3f} GiB")
    del state, batch
    _free(torch)
    return dict(step_ms=med, first_step_ms=first, tokens_per_s=tok_s,
                peak_gib=peak / 2**30)


def lm_seamless_serve_phase(torch, dev="cuda"):
    """(n) ``serve.main`` on ``seamless-m4t-medium`` (the reference's
    prefill-free loop over the cache's zero ``enc_out``); then the encoder
    once over frames (1, 32, 1 024), its output written into a cache of
    32, and 32 tokens decoded against the full ``encdec_forward``, within
    1e-4 * max|logits|; then ``make_prefill_step`` at B 4, frames 128,
    tokens 16: the p50 of 5 warm calls."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    cfg = get_config("seamless-m4t-medium")
    out = serve_cli(torch, cfg.name, "lm-seamless-serve", dev)
    params = model_lib.init_params(cfg, torch.Generator(
        device=dev).manual_seed(27))
    one = _seeded_batch(torch, cfg, 1, 32, 27, dev, frames=32)
    t0 = time.perf_counter()
    with torch.no_grad():
        y, enc_out, _ = model_lib.encdec_forward(
            params, cfg, one["frames"], one["tokens"], remat="none")
        full = model_lib.logits_fn(params, cfg, y)
        caches = model_lib.init_cache(cfg, 1, 32, torch.float32, device=dev)
        caches["enc_out"].copy_(enc_out)
        errs = torch.zeros(32, device=dev)
        for t in range(32):
            logits, caches = model_lib.forward_decode(
                params, cfg, caches, one["tokens"][:, t:t + 1], t,
                compute_dtype=torch.float32)
            errs[t] = (logits[:, 0] - full[:, t]).abs().max()
        same_enc = bool(torch.equal(caches["enc_out"], enc_out))
    err, scale = float(errs.max()), float(full.abs().max())
    note_wall(time.perf_counter() - t0)
    say(f"[lm-seamless-serve] the encoder over frames (1, 32, "
        f"{cfg.d_model}) into a cache of 32, then decode of 32 tokens "
        f"against the full encdec_forward: max|logits diff| {err:.3e}, "
        f"max|logits| {scale:.3e}, bar 1e-4 * max|logits| = "
        f"{1e-4 * scale:.3e}; enc_out untouched by decode {same_enc}")
    require(err < 1e-4 * scale and same_enc,
            "lm-seamless-serve: decode disagrees with the full forward")
    batch = _seeded_batch(torch, cfg, 4, 16, 28, dev, frames=128)
    p50 = prefill_p50(torch, cfg, params, batch, "lm-seamless-prefill")
    say(f"[lm-seamless-serve] make_prefill_step at B 4, frames 128, tokens "
        f"16: p50 of 5 warm calls {p50:.3f} ms")
    del params, caches, full, y, enc_out
    _free(torch)
    return dict(out, decode_err=err, prefill_p50_ms=p50)


def lm_llava_serve_phase(torch, dev="cuda"):
    """(o) ``llava-next-mistral-7b`` at its published width and depth
    (32 layers, d 4 096, d_ff 14 336): ``serve.main`` and decode against
    the full forward within 1e-4 * max|logits| (``lm_serve_full``); then
    ``make_prefill_step`` with 576 patches and 16 tokens at B 4 (p50 of 5
    warm calls); then ``forward_train``'s loss under ``no_grad`` at B 1,
    576 patches and 64 tokens, within 1e-5 relative of a cross-entropy
    computed by hand over the text positions alone."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    cfg = get_config("llava-next-mistral-7b")
    P = cfg.num_patches
    out, params = lm_serve_full(torch, cfg.name, "lm-llava-serve", 26, dev,
                                keep=True)
    batch = _seeded_batch(torch, cfg, 4, 16, 29, dev, patches=P)
    p50 = prefill_p50(torch, cfg, params, batch, "lm-llava-prefill")
    say(f"[lm-llava-serve] make_prefill_step at B 4, {P} patches + 16 "
        f"tokens: p50 of 5 warm calls {p50:.3f} ms")
    one = _seeded_batch(torch, cfg, 1, 64, 30, dev, patches=P)
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, _ = model_lib.forward_train(params, cfg, one, remat="none",
                                          compute_dtype=torch.float32)
        x = model_lib.assemble_inputs(params, cfg, one, torch.float32)
        x, _, _ = model_lib.decoder_stack(params, x, torch.arange(
            x.shape[1], device=dev), cfg, remat="none")
        x = model_lib.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = model_lib.logits_fn(params, cfg, x[:, P:])
        gold = torch.gather(logits, -1, one["labels"][..., None])[..., 0]
        by_hand = torch.mean(torch.logsumexp(logits, dim=-1) - gold)
    rel = abs(float(loss) / float(by_hand) - 1)
    note_wall(time.perf_counter() - t0)
    say(f"[lm-llava-serve] forward_train's masked loss at B 1, {P} patches "
        f"+ 64 tokens: {float(loss):.6f}; the cross-entropy by hand over "
        f"the 64 text positions {float(by_hand):.6f}; relative diff "
        f"{rel:.3e} (bar 1e-5)")
    require(rel < 1e-5, "lm-llava-serve: the masked loss is not the text "
            "positions' cross-entropy")
    del params, logits, x
    _free(torch)
    return dict(out, prefill_p50_ms=p50, loss_rel=rel)


def lm_llava_train_phase(torch, dev="cuda"):
    """(p) ``llava-next-mistral-7b`` at full width on 8 of its 32 layers
    (``dataclasses.replace(cfg, num_layers=8)``; the full depth's 107.9
    GiB of state does not fit on the card) through
    ``steps.make_train_step``, float32, remat none, 3 steps at B 2 with
    576 patches and 256 tokens (S 832, one CE chunk), ``train.
    sgl_prox_step`` after each as ``train.main`` applies it (lr 3e-4, SGL
    lambda 3e-4): finite losses, exact zeros in the prox's groups
    (``attn/wq`` heads, ``ffn/w_in`` channels) and none in ``wk``.
    Returns its trained FFN channel signal (G = d_ff = 14 336)."""
    from repro_torch.configs.base import get_config
    from repro_torch.examples import sgl_pruned_lm as ex
    from repro_torch.models import model as model_lib
    cfg = dataclasses.replace(get_config("llava-next-mistral-7b"),
                              num_layers=8)
    B, S, P = 2, 256, cfg.num_patches
    batch = _seeded_batch(torch, cfg, B, S, 32, dev, patches=P)
    t = 3e-4 * 3e-4
    losses, times, peak, state = train_steps(
        torch, cfg, batch, "lm-llava-train", prox=(t, t), dev=dev)
    pb = state.params["blocks"]["l0"]
    zeros = {"wq": _zeros(pb["attn"]["wq"]), "w_in": _zeros(pb["ffn"]["w_in"]),
             "wk": _zeros(pb["attn"]["wk"])}
    first, med, tok_s = _step_stats(times, B * S)
    say(f"[lm-llava-train] {model_lib.param_count(cfg)} parameters (8 of 32 "
        f"layers), float32, B {B}, {P} patches + {S} tokens (S {P + S}), "
        f"remat none: losses {[round(l, 4) for l in losses]}; train step "
        f"first {first:.1f} ms, median of the rest {med:.1f} ms = "
        f"{tok_s:.0f} text tokens/s, {tok_s * (P + S) / S:.0f} positions/s; "
        f"peak device memory {peak / 2**30:.3f} GiB; exact zeros after the "
        f"prox wq {zeros['wq']}, w_in {zeros['w_in']}, wk (no prox) "
        f"{zeros['wk']}")
    require(zeros["wq"] > 0 and zeros["w_in"] > 0 and zeros["wk"] == 0,
            "lm-llava-train: the SGL prox left no zero in its groups")
    signal = ex.ffn_channel_signal(state.params)
    require(signal.shape == (cfg.d_ff,),
            f"lm-llava-train: channel signal of shape {signal.shape}")
    del state, pb, batch
    _free(torch)
    return signal, dict(step_ms=med, first_step_ms=first,
                        tokens_per_s=tok_s, peak_gib=peak / 2**30)


def lm_vlm_curve_phase(torch, signal, dev="cuda"):
    """(q) The pruning-threshold curve of (p)'s trained FFN channels (G =
    14 336, X = eye(14 336)) through ``pruning_threshold_curve``, with the
    gates of (a)'s curve.  Returns (launch counts, graphed-solve record,
    the curve)."""
    from repro_torch.examples import sgl_pruned_lm as ex
    (res, surv), counts, _, calls = run_counted(
        torch, "lm-vlm-curve",
        lambda: ex.pruning_threshold_curve(signal, device=dev))
    require_curve(torch, res, surv, signal, counts, calls, "lm-vlm-curve",
                  dev)
    _free(torch)
    return counts, calls, res


def curve_checks(torch, T, res, calls, label):
    """``xtv``, ``screen_norms`` and ``sgl_prox`` against their plain
    versions at a pruning curve's shapes: X = eye(G), the first screen's
    padded grid, the prox bucket that ran the most iterations."""
    from repro_torch.core.path_engine import _pow2_len
    G = res.betas.shape[1]
    spec = T.GroupSpec.uniform_groups(G, 1, device="cuda")
    return {
        "xtv": check_xtv(torch, torch.eye(G, device="cuda"), label),
        "screen_norms": check_screen_norms(
            torch, _pow2_len(len(res.lambdas) - 1), spec, label),
        "sgl_prox": check_sgl_prox(torch, calls.busiest_spec,
                                   f"{label}-bucket"),
    }


# ---------------------------------------------------------------------------
# phase 21 (r)-(v): ZeRO-3, expert parallelism, elastic restore, seq_shard,
# compression
# ---------------------------------------------------------------------------

ZERO_STEPS = 2       # (r)'s steps
MOE_ARGV = ["--arch", "granite-moe-1b-a400m", "--global-batch", "4",
            "--seq", "256", "--lr", "3e-4", "--sgl-lambda", "3e-4",
            "--log-every", "1"]


@contextlib.contextmanager
def timed_collectives(torch, acc):
    """Adds the wall of every collective call of ``torch.distributed``
    (``all_gather``, ``all_reduce``, ``reduce_scatter``, ``barrier``) to
    ``acc["s"]``, the card synchronized on both sides of each call (the
    compute before it is waited for outside the sum)."""
    import torch.distributed as dist
    names = ("all_gather", "all_reduce", "reduce_scatter", "barrier")
    real = {n: getattr(dist, n) for n in names}

    def wrap(fn):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc["s"] += time.perf_counter() - t0
            acc["calls"] += 1
            return out
        return timed
    for n in names:
        setattr(dist, n, wrap(real[n]))
    try:
        yield acc
    finally:
        for n in names:
            setattr(dist, n, real[n])


def _zero_train(torch, out, dev):
    """(r) on this rank: ``train.main`` on granite at full width for
    ``ZERO_STEPS`` steps, the mesh ``make_local_mesh()``."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import train as train_mod
    from repro_torch.pytree import leaves
    times, metrics, acc = [], [], {"s": 0.0, "calls": 0}
    torch.cuda.reset_peak_memory_stats()
    sh.reset_collective_counts()
    t0 = time.perf_counter()
    with timed_collectives(torch, acc):
        losses, state = train_mod.main(
            MOE_ARGV + ["--steps", str(ZERO_STEPS), "--device", dev],
            return_state=True, step_times=times, step_metrics=metrics)
    state_bytes = sum(t.numel() * t.element_size() for t in
                      leaves(state.params) + leaves(state.m)
                      + leaves(state.v))
    out["r"] = dict(losses=losses, metrics=metrics, step_s=times,
                    state_bytes=state_bytes, wall=time.perf_counter() - t0,
                    peak=torch.cuda.max_memory_allocated(),
                    collective_s=acc["s"], collective_calls=acc["calls"],
                    counts=sh.collective_counts())
    del state
    gc.collect()
    torch.cuda.empty_cache()


EP_FACTORS = (1.25, 0.05)   # (s)'s capacity factors: the training one, and
                            # one whose windows drop pairs on both layers


def _zero_expert_layer(torch, out, dev):
    """(s) on this rank: granite's first MoE layer (the init of (r)) on
    ``lm_mesh({"data": 1, "model": 2})``, B 4, S 256, at each capacity
    factor of ``EP_FACTORS``, against the emulation
    (``_shard_capacity_moe``: the port's ``moe_ffn_local`` over each
    model shard's expert slice at the per-shard capacity, summed) run here
    on the full expert set with no mesh; the pairs each dispatch keeps,
    counted inside ``moe_ffn_local`` (``moe.log_kept``): this rank's
    layer, the emulation's shard of this rank and the unsharded layer's."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_mod
    cfg = get_config("granite-moe-1b-a400m")
    mesh = mesh_mod.lm_mesh({"data": 1, "model": 2})
    full = model_lib.init_params(cfg, torch.Generator(device=dev)
                                 .manual_seed(0))
    p = {k: v.detach()[0].clone().requires_grad_()
         for k, v in full["blocks"]["l0"]["ffn"].items()}
    del full
    torch.cuda.empty_cache()
    B, S, d = 4, 256, cfg.d_model
    E, k, M = cfg.num_experts, cfg.experts_per_token, 2
    n_local, mi = E // M, mesh.coords["model"]
    T_ = B * S
    gen = torch.Generator(device=dev).manual_seed(26)
    x = torch.randn((B, S, d), generator=gen, device=dev)
    R = torch.randn((B, S, d), generator=gen, device=dev)
    x.requires_grad_()
    wrt = lambda: [x, p["w_in"], p["router"]]
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    es = slice(mi * n_local, (mi + 1) * n_local)
    out["s"] = {}
    shards = _shard_capacity_moe(M)
    for cf in EP_FACTORS:
        cap = moe_mod.shard_capacity(T_, k, M, cf)

        def emulation(x, w_in, router):
            return shards(dict(p, w_in=w_in, router=router), x, cfg,
                          capacity_factor=cf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with moe_mod.log_kept() as kept:
            y, aux = moe_mod.moe_forward(p, x, cfg, mesh=mesh,
                                         capacity_factor=cf)
        got = torch.autograd.grad((y * R).sum() + aux, wrt())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with moe_mod.log_kept() as kept_e:
            ye, auxe = emulation(*wrt())
        want = torch.autograd.grad((ye * R).sum() + auxe, wrt())
        with moe_mod.log_kept() as kept_1, torch.no_grad():
            moe_mod.moe_forward(p, x, cfg, capacity_factor=cf)
        out["s"][str(cf)] = dict(
            wall=wall, cap=cap, cap_unsharded=moe_mod.capacity_of(
                T_, k, E, cf),
            out=rel(y.detach(), ye.detach()),
            aux=abs(float(aux.detach() - auxe.detach())),
            gx=rel(got[0], want[0]), gw_in=rel(got[1][es], want[1][es]),
            router=rel(got[2], want[2]),
            kept=[int(c) for c in kept], kept_emulation=int(kept_e[mi]),
            kept_unsharded=[int(c) for c in kept_1], pairs=T_ * k)
        del y, ye, got, want


def _zero_resume(torch, out, ck_d, dev):
    """(t) on the ranks: part (d)'s step-2 checkpoint (no mesh) resumed
    here to step 4, which writes its step-4 checkpoint (on this mesh) for
    the parent to resume."""
    from repro_torch.examples import sgl_pruned_lm as ex
    from repro_torch.launch import train as train_mod
    ex.example_config()
    t0 = time.perf_counter()
    resumed = train_mod.main(ex.train_argv(4, dev) + [
        "--ckpt-dir", ck_d, "--resume"])
    out["t"] = dict(resumed=resumed, wall=time.perf_counter() - t0)


def _zero_seq_shard(torch, out, dev):
    """(u) on the ranks: the example's ``gemma2-100m`` on ``lm_mesh({"data":
    1, "model": 2})`` through ``make_train_step(seq_shard=True,
    remat="full")``, 2 steps on (a)'s batches with (a)'s schedule and prox;
    and the bytes the stack saves for backward (its periods' boundaries),
    through ``saved_tensors_hooks``, with and without ``seq_shard``."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.lm_data import SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.examples import sgl_pruned_lm as ex
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    ex.example_config()
    cfg = get_config("gemma2-100m")
    mesh = mesh_mod.lm_mesh({"data": 1, "model": 2})
    specs = model_lib.param_pspecs(cfg, mesh.shape)
    shardings = sh.named(mesh, adamw.state_pspecs(specs))
    init = model_lib.init_params(cfg, torch.Generator(device=dev)
                                 .manual_seed(0))
    S = 256
    data = SyntheticLM(cfg.vocab_size, S, 8, seed=0)
    batches = [{k: v.to(dev) for k, v in data.batch_at(i).items()}
               for i in range(2)]
    # the boundaries' bytes: one forward of the stack at (a)'s first batch
    saved = {}
    for flag in (False, True):
        sizes = []

        def pack(t):
            sizes.append(t.numel() * t.element_size())
            return t
        x = model_lib.embed_tokens(init, cfg, batches[0]["tokens"],
                                   torch.float32)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y, _, _ = model_lib.decoder_stack(
                init, x.detach().requires_grad_(), torch.arange(
                    S, device=dev), cfg, mesh=mesh, remat="full",
                seq_shard=flag)
        saved[flag] = (sum(sizes), len(sizes))
        del y, x
    state = adamw.init_state(train_mod.local_params(init,
                                                    shardings.params))
    del init
    step = steps_mod.make_train_step(
        cfg, mesh=mesh, remat="full", compute_dtype=torch.float32,
        lr_kwargs=dict(base_lr=1e-3, warmup=20, total=max(LM_STEPS, 100)),
        seq_shard=True)
    losses, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        train_mod.sgl_prox_step(state.params, cfg, 1e-3 * 3e-4, 1e-3 * 3e-4,
                                mesh, specs)
    out["u"] = dict(losses=losses, step_s=times, saved=saved)


def _rank_lm_zero(rank, world, init_file, out_dir, ck_d, dev):
    """One rank of phase 21's spawn (r), (s), (t) and (u), one after
    another: the card shared with the other rank through ``gloo``."""
    import datetime
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    out = {"rank": rank}
    try:
        for part, fn in (
                ("r", lambda: _zero_train(torch, out, dev)),
                ("s", lambda: _zero_expert_layer(torch, out, dev)),
                ("t", lambda: _zero_resume(torch, out, ck_d, dev)),
                ("u", lambda: _zero_seq_shard(torch, out, dev))):
            t0 = time.perf_counter()
            fn()
            out[part]["seconds"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return got.shape == want.shape and bool(
        np.all(np.abs(got - want) <= rel * np.abs(want)))


def lm_zero_phase(torch, losses_a, moe_metrics, ck_d, dev="cuda"):
    """Parts (r)-(v): one spawn of two ``gloo`` ranks on the card runs
    (r), (s), (t)'s rank half and (u); this process resumes the ranks'
    step-4 checkpoint with no mesh to step 6 ((t)'s other half) and runs
    (v)."""
    import shutil
    from repro_torch.examples import sgl_pruned_lm as ex
    from repro_torch.launch import train as train_mod
    gc.collect()
    torch.cuda.empty_cache()
    try:
        with timed_phase("lm-zero-ranks"):
            ranks, wall = run_ranks(
                _rank_lm_zero, 2, (ck_d, dev),
                lambda d, r: json.load(open(f"{d}/rank{r}.json")),
                "lm-zero", timeout=600.0)
            say(f"[lm-zero] one spawn of 2 ranks for (r), (s), (t) and "
                f"(u): {wall:.3f} s with start-up; parts by rank "
                + json.dumps({r["rank"]: {p: round(r[p]["seconds"], 3)
                                          for p in "rstu"} for r in ranks}))
            lm_zero_checks(ranks, losses_a, moe_metrics)
        with timed_phase("lm-zero-resume"):
            ex.example_config()
            t0 = time.perf_counter()
            resumed = train_mod.main(ex.train_argv(6, dev) + [
                "--ckpt-dir", ck_d, "--resume"])
            note_wall(time.perf_counter() - t0)
            rel = np.abs(np.asarray(resumed) / np.asarray(losses_a[4:6]) - 1)
            say(f"[lm-zero-t] the ranks' step-4 checkpoint (mesh data 2) "
                f"resumed here with no mesh to step 6: {resumed} against "
                f"(a)'s {losses_a[4:6]}, max relative diff "
                f"{float(rel.max()):.3e} (bar 1e-5)")
            require(len(resumed) == 2 and float(rel.max()) <= 1e-5,
                    "lm-zero-t: the resume with no mesh differs from (a)")
    finally:
        shutil.rmtree(ck_d, ignore_errors=True)
    with timed_phase("lm-compression"):
        lm_compression_phase(torch, dev)
    return [r["r"]["peak"] for r in ranks]


def lm_zero_checks(ranks, losses_a, moe_metrics):
    """The bars of (r), (s), (t)'s rank half and (u) on each rank."""
    e2 = moe_metrics[:ZERO_STEPS]
    for r in ranks:
        rk = r["rank"]
        z = r["r"]
        ms = z["metrics"]
        step_ms = [1e3 * t for t in z["step_s"]]
        say(f"[lm-zero-r] rank {rk}: granite-moe-1b-a400m on (data 2, model "
            f"1), B 4 (2 a rank), S 256, the prox on: losses "
            f"{z['losses']} against (e)'s {[m['loss'] for m in e2]}; ce "
            f"{[m['ce'] for m in ms]} against {[m['ce'] for m in e2]}; aux "
            f"{[m['aux'] for m in ms]} against {[m['aux'] for m in e2]}; "
            f"state {z['state_bytes'] / 2**30:.3f} GiB (its blocks), peak "
            f"device memory {z['peak'] / 2**30:.3f} GiB (this process), "
            f"steps {[round(t, 1) for t in step_ms]} ms, collectives "
            f"{z['collective_s']:.3f} s over {z['collective_calls']} calls "
            f"in the run's {z['wall']:.3f} s ({json.dumps(z['counts'])}); "
            f"exact zeros after each step {[m.get('zeros') for m in ms]} "
            f"against (e)'s {[m.get('zeros') for m in e2]}")
        for key in ("loss", "ce", "aux"):
            require(_close([m[key] for m in ms], [m[key] for m in e2]),
                    f"lm-zero-r: rank {rk}'s {key} differs from (e)'s")
        require([m.get("zeros") for m in ms] == [m.get("zeros") for m in e2]
                and all(v > 0 for v in ms[-1]["zeros"].values()),
                f"lm-zero-r: rank {rk}'s prox zeros differ from (e)'s")
        for cf in EP_FACTORS:
            s = r["s"][str(cf)]
            say(f"[lm-zero-s] rank {rk}: one MoE layer of granite (E 32, k "
                f"8, d 1 024) on (data 1, model 2), 16 experts a rank, B 4, "
                f"S 256, capacity factor {cf}: against the emulation, "
                f"max|diff| / max|.| output {s['out']:.3e}, grad x "
                f"{s['gx']:.3e}, grad w_in (its experts) {s['gw_in']:.3e}, "
                f"grad router {s['router']:.3e} (bar 1e-5); |aux diff| "
                f"{s['aux']:.3e}; pairs kept by moe_ffn_local on this "
                f"rank's experts {s['kept']} at capacity {s['cap']} a "
                f"window (the emulation's shard {s['kept_emulation']}), by "
                f"the unsharded layer {s['kept_unsharded']} of "
                f"{s['pairs']} at {s['cap_unsharded']}; "
                f"{1e3 * s['wall']:.3f} ms forward and backward")
            require(max(s["out"], s["gx"], s["gw_in"], s["router"]) <= 1e-5
                    and s["aux"] <= 1e-6 and len(s["kept"]) == 1
                    and s["kept"][0] == s["kept_emulation"]
                    and len(s["kept_unsharded"]) == 1,
                    f"lm-zero-s: rank {rk}'s expert-parallel layer differs "
                    f"at capacity factor {cf}")
        s = r["s"]
        require(s["1.25"]["cap"] == 5120 and s["1.25"]["cap_unsharded"] == 320
                and s["0.05"]["cap"] == 205
                and s["0.05"]["cap_unsharded"] == 13,
                "lm-zero-s: the windows are not the reference's")
        t = r["t"]
        rel = np.abs(np.asarray(t["resumed"]) / np.asarray(losses_a[2:4]) - 1)
        say(f"[lm-zero-t] rank {rk}: part (d)'s step-2 checkpoint (no mesh) "
            f"resumed on (data 2, model 1) to step 4, writing its step-4 "
            f"checkpoint: {t['resumed']} against (a)'s {losses_a[2:4]}, max "
            f"relative diff {float(rel.max()):.3e} (bar 1e-5)")
        require(len(t["resumed"]) == 2 and float(rel.max()) <= 1e-5,
                f"lm-zero-t: rank {rk}'s resume differs from (a)")
        u = r["u"]
        (full, n_full), (half, n_half) = u["saved"]["false"], \
            u["saved"]["true"]
        say(f"[lm-zero-u] rank {rk}: gemma2-100m on (data 1, model 2) with "
            f"seq_shard, remat full: losses {u['losses']} against (a)'s "
            f"{losses_a[:2]}; steps {[round(1e3 * x, 1) for x in u['step_s']]}"
            f" ms; bytes saved for backward at the layer boundaries "
            f"{half} ({n_half} tensors) against {full} ({n_full}) without "
            f"seq_shard: {half / full:.3f}")
        require(_close(u["losses"], losses_a[:2]),
                f"lm-zero-u: rank {rk}'s losses differ from (a)'s")
        require(2 * half == full and n_half == n_full,
                f"lm-zero-u: rank {rk}'s boundaries did not halve")
    for cf in EP_FACTORS:
        one = ranks[0]["s"][str(cf)]
        kept = sum(r["s"][str(cf)]["kept"][0] for r in ranks)
        say(f"[lm-zero-s] capacity factor {cf}: the two ranks' windows of "
            f"{one['cap']} keep {kept} of {one['pairs']} pairs, the "
            f"unsharded layer's of {one['cap_unsharded']} "
            f"{one['kept_unsharded'][0]}")
        require(kept <= one["pairs"] and (kept < one["pairs"]) == (cf < 1),
                f"lm-zero-s: at capacity factor {cf} the windows kept "
                f"{kept} of {one['pairs']} pairs")


def lm_compression_phase(torch, dev="cuda"):
    """(v) ``compress_tree`` / ``decompress_tree`` on random normal
    gradients shaped like granite's parameter tree (1.33 B values): every
    element within max|block| / 127 of its input, the error feedback
    ``x + err - decompress(q)`` to 1e-7, ``wire_bytes`` exactly the padded
    payload plus its scales."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import compression as C
    from repro_torch.models import model as model_lib
    from repro_torch.pytree import flatten, leaves, tree_map
    descs = model_lib.param_descs(get_config("granite-moe-1b-a400m"))
    gen = torch.Generator(device=dev).manual_seed(27)
    grads = tree_map(lambda d: torch.randn(d.shape, generator=gen,
                                           device=dev), descs,
                     is_leaf=lambda x: hasattr(x, "axes"))
    n_values = sum(g.numel() for g in leaves(grads))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        note_wall(dt)
        return out, 1e3 * dt

    (comp, err), ms_c = timed(lambda: C.compress_tree(grads))
    deq, ms_d = timed(lambda: C.decompress_tree(comp))
    worst = 0.0              # max |x - deq| / (its block's max|x| / 127)
    for x, y in zip(leaves(grads), leaves(deq)):
        n = x.numel()
        pad = -(-n // C.BLOCK) * C.BLOCK
        xp = torch.nn.functional.pad(x.reshape(-1), (0, pad - n))
        bound = xp.reshape(-1, C.BLOCK).abs().amax(1, keepdim=True) / 127
        diff = torch.nn.functional.pad((x - y).reshape(-1), (0, pad - n))
        worst = max(worst, float((diff.reshape(-1, C.BLOCK).abs()
                                  / bound).max()))
    del deq
    # a second step with the error fed back
    grads2 = tree_map(lambda g: torch.randn(g.shape, generator=gen,
                                            device=dev), grads)
    del grads
    (comp2, err2), ms_c2 = timed(lambda: C.compress_tree(grads2, err))
    fb = 0.0
    for x, e, q, e2 in zip(leaves(grads2), leaves(err),
                           flatten(comp2, is_leaf=lambda c: isinstance(
                               c, C.Compressed))[0], leaves(err2)):
        fb = max(fb, float((x + e - C.decompress(q) - e2).abs().max()))
    wire = C.wire_bytes(grads2)
    want = sum(-(-g.numel() // 256) * 256 + 4 * (-(-g.numel() // 256))
               for g in leaves(grads2))
    say(f"[lm-compression] {n_values} values in {len(leaves(grads2))} "
        f"leaves (granite's tree), float32 on the card: compress_tree "
        f"{ms_c:.3f} ms, decompress_tree {ms_d:.3f} ms, compress_tree with "
        f"the error fed back {ms_c2:.3f} ms; worst |x - deq| over its "
        f"block's max|.| / 127: {worst:.4f} (must be <= 1); error feedback "
        f"max|x + err - deq - err'| {fb:.3e} (bar 1e-7); wire bytes "
        f"{wire} = {wire / n_values:.4f} a value, against "
        f"{4 * n_values} at 4 bytes a value")
    require(n_values == 1334628352, "lm-compression: not granite's tree")
    require(worst <= 1.0 and fb <= 1e-7 and wire == want,
            "lm-compression: a bound, the error feedback or the wire "
            "bytes failed")
    del grads2, err, err2, comp, comp2
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 21 (w) and (x): tensor-parallel serving over 'model'
# ---------------------------------------------------------------------------

TP_SHAPE = {"data": 1, "model": 2}
#: (part, config, parameter dtype, init seed, layers: None for the
#: config's depth); every part at its published width, compute float32
TP_PARTS = (("w1", "gemma2-2b", "float32", 27, None),
            ("w2", "gemma3-12b", "bfloat16", 28, None))
#: part (x), the MLA and MoE configs: deepseek-v2-236b's 60 layers (472 GB
#: in bf16) fit no card, so it keeps its dense prologue and one MoE layer
#: (5.36 B parameters, 10.7 GB in bf16)
TPX_PARTS = (("x1", "minicpm3-4b", "bfloat16", 29, None),
             ("x2", "granite-moe-1b-a400m", "float32", 30, None),
             ("x3", "deepseek-v2-236b", "bfloat16", 31, 2))
TP_B, TP_PROMPT, TP_GEN, TP_CACHE = 4, 16, 32, 128
TP_STEPS = TP_PROMPT + TP_GEN - 1       # the prompt's, then the greedy ones


def _tp_config(arch, layers):
    """The config at its published width, cut to its first ``layers``
    layers where that is given."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(
        cfg, num_layers=layers)


def tp_collectives(cfg, m):
    """The collectives of a tensor-parallel step on (data 1, model ``m``),
    from the config's dims: each layer one all-reduce after ``wo`` where
    'model' divides the heads, one after its FFN where it splits the MLP's
    channels (a MoE layer: its experts or its shared channels, one
    all-reduce for both), one for the embedding where it divides the
    vocabulary, and one all-gather of the logits where it splits the
    head."""
    div = lambda n: n % m == 0
    shared = cfg.moe_d_ff * cfg.num_shared_experts
    kinds = list(cfg.prologue) + list(cfg.block_pattern) * cfg.repeats
    ffn = sum(div(cfg.num_experts) or (shared > 0 and div(shared))
              if kind == "moe" else div(cfg.d_ff) for kind in kinds)
    embed = div(cfg.vocab_size)      # the head's columns split alike
    return {"all_gather": int(embed), "reduce_scatter": 0,
            "all_reduce": len(kinds) * div(cfg.num_heads) + ffn + embed}


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def _tp_steps(torch, cfg, params, toks, dev, mesh=None, greedy=False):
    """``TP_STEPS`` decode steps of ``toks`` (B, TP_STEPS) into a fresh
    float32 cache, one ``forward_decode`` a step (under ``mesh``, the
    serving layout).  ``greedy``: the tokens after the prompt are
    overwritten by each step's argmax.  Returns (each step's logits on the
    host, each step's seconds, each step's collectives)."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import model as model_lib
    tp = mesh is not None
    caches = model_lib.init_cache(
        cfg, TP_B, TP_CACHE, torch.float32, dev,
        tp_mesh_shape=mesh.shape if tp else None)
    logits, times, counts = [], [], []
    with torch.no_grad():
        for t in range(TP_STEPS):
            torch.cuda.synchronize()
            sh.reset_collective_counts()
            t0 = time.perf_counter()
            lg, caches = model_lib.forward_decode(
                params, cfg, caches, toks[:, t:t + 1], t, mesh=mesh,
                compute_dtype=torch.float32, tp=tp)
            if greedy and TP_PROMPT <= t + 1 < TP_STEPS:
                toks[:, t + 1] = torch.argmax(lg[:, 0], dim=-1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            counts.append(sh.collective_counts())
            logits.append(lg[:, 0].cpu())
    return logits, times, counts


def _tp_prefill(torch, cfg, params, toks, mesh=None):
    """The prefill step's last logits over the prompt (B 4, S 16) and its
    collectives."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps as steps_mod
    sh.reset_collective_counts()
    last = steps_mod.make_prefill_step(
        cfg, mesh=mesh, compute_dtype=torch.float32, tp=mesh is not None)(
            params, {"tokens": toks[:, :TP_PROMPT]})
    return last[:, 0].cpu(), sh.collective_counts()


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _rank_lm_tp(rank, world, init_file, out_dir, twin_dir, dev, parts):
    """One rank of (w) or (x): each part's config on
    ``lm_mesh(TP_SHAPE)``, its blocks drawn by ``init_params(shardings=)``,
    the twin's tokens decoded and prefilled under the serving layout; each
    step's logits against the twin's, the bytes and peaks."""
    import datetime
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.cost_analysis import alloc_bytes
    from repro_torch.models import model as model_lib
    from repro_torch.pytree import leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    out = {"rank": rank}
    try:
        mesh = mesh_mod.lm_mesh(TP_SHAPE)
        for part, arch, dtype, seed, layers in parts:
            t_part = time.perf_counter()
            cfg = _tp_config(arch, layers)
            shardings = sh.named(mesh, sh.serving_pspecs(cfg, mesh.shape))
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            params = model_lib.init_params(
                cfg, torch.Generator(device=dev).manual_seed(seed),
                getattr(torch, dtype), shardings=shardings)
            torch.cuda.synchronize()
            param_bytes = sum(alloc_bytes(t.untyped_storage().nbytes())
                              for t in leaves(params))
            allocated = torch.cuda.memory_allocated() - base
            init_peak = torch.cuda.max_memory_allocated() - base
            twin = torch.load(f"{twin_dir}/{part}.pt")
            toks = twin["toks"].to(dev)
            torch.cuda.reset_peak_memory_stats()
            logits, times, counts = _tp_steps(torch, cfg, params, toks, dev,
                                              mesh=mesh)
            decode_peak = torch.cuda.max_memory_allocated() - base
            pre, pre_counts = _tp_prefill(torch, cfg, params, toks, mesh)
            out[part] = dict(
                param_bytes=param_bytes, allocated=allocated,
                init_peak=init_peak,
                decode_peak=decode_peak,
                peak=torch.cuda.max_memory_allocated() - base,
                errs=[_rel(g, w) for g, w in zip(logits, twin["logits"])],
                prefill_err=_rel(pre, twin["prefill"]),
                counts=counts, prefill_counts=pre_counts,
                step_s=times, seconds=time.perf_counter() - t_part)
            del params, logits, twin, toks
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _shard_capacity_moe(n_model):
    """``moe_forward`` as expert parallelism over a 'model' axis of
    ``n_model`` computes it, in one process: the router on the whole
    input, each shard's E / n_model experts at the per-shard capacity
    (``moe.shard_capacity``), the shards' outputs summed, then the shared
    experts (the reference's ``shard_map`` order)."""
    from repro_torch.models import moe as moe_mod

    def forward(p, x, cfg, *, mesh=None, capacity_factor=1.25, tp=None):
        B, S, d = x.shape
        E, k = cfg.num_experts, cfg.experts_per_token
        n_local = E // n_model
        idx, gw, aux = moe_mod.router_topk(p, x, cfg)
        cap = moe_mod.shard_capacity(B * S, k, n_model, capacity_factor)
        out = 0
        for mi in range(n_model):
            es = slice(mi * n_local, (mi + 1) * n_local)
            out = out + moe_mod.moe_ffn_local(
                x.reshape(-1, d), idx.reshape(-1, k), gw.reshape(-1, k),
                p["w_in"][es], p["w_gate"][es] if "w_gate" in p else None,
                p["w_out"][es], e_lo=mi * n_local, n_local=n_local,
                capacity=cap, act=cfg.mlp_act).to(x.dtype)
        out = out.reshape(B, S, d)
        if cfg.num_shared_experts:
            out = out + moe_mod.shared_ffn(p, x, cfg.mlp_act)
        return out.to(x.dtype), aux
    return forward


def _tp_twin(torch, part, arch, dtype, seed, layers, twin_dir, dev):
    """The twin of a part in this process: the full parameters (the same
    draws), the prompt teacher-forced then ``TP_GEN`` greedy tokens, and
    the prefill (a MoE config's at the ranks' per-shard capacity); its
    tokens and logits saved for the ranks."""
    from unittest import mock
    from repro_torch.launch.cost_analysis import alloc_bytes
    from repro_torch.models import model as model_lib
    from repro_torch.pytree import leaves
    cfg = _tp_config(arch, layers)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed),
        getattr(torch, dtype))
    toks = torch.zeros((TP_B, TP_STEPS), dtype=torch.int64, device=dev)
    toks[:, :TP_PROMPT] = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (TP_B, TP_PROMPT)), device=dev)
    logits, times, _ = _tp_steps(torch, cfg, params, toks, dev, greedy=True)
    with mock.patch.object(model_lib.moe_mod, "moe_forward",
                           _shard_capacity_moe(TP_SHAPE["model"])):
        pre, _ = _tp_prefill(torch, cfg, params, toks)
    torch.save({"toks": toks.cpu(), "logits": logits, "prefill": pre},
               f"{twin_dir}/{part}.pt")
    peak = torch.cuda.max_memory_allocated()
    max_leaf = max(alloc_bytes(t.numel() * t.element_size())
                   for t in leaves(params))
    del params, logits
    _free(torch)
    return dict(step_s=times, peak=peak, param_count=model_lib.param_count(
        cfg), layers=cfg.num_layers, max_leaf_bytes=max_leaf,
        collectives=tp_collectives(cfg, TP_SHAPE["model"]))


def _tp_dry(torch, parts):
    """The dry run of each part's rank: ``tp_decode_bf16`` on a fake
    (data 1, model 2) world at B 4, cache 128, float32 compute and cache,
    the parameters in the part's dtype."""
    from repro_torch.launch import dryrun
    out = {}
    for part, arch, dtype, _, layers in parts:
        out[part] = dryrun.run_cell(
            arch=arch, shape_name="decode_32k", variant="tp_decode_bf16",
            extra_opts={"param_dtype": dtype}, mesh_shape=dict(TP_SHAPE),
            cfg=_tp_config(arch, layers), batch=TP_B, seq=TP_CACHE,
            compute_dtype=torch.float32, cache_dtype=torch.float32)
    return out


def lm_tp_phase(torch, parts, label, dev="cuda"):
    """Part (w) or (x): each part's twin here, one after the other; then
    one spawn of two ``gloo`` ranks on (data 1, model 2) runs the parts,
    while their dry runs run in a thread here."""
    import concurrent.futures
    import tempfile
    card = card_line()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as twin_dir:
        twins = {}
        for part, *spec in parts:
            t0 = time.perf_counter()
            twins[part] = _tp_twin(torch, part, *spec, twin_dir, dev)
            note_wall(time.perf_counter() - t0)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            dry = pool.submit(_tp_dry, torch, parts)
            ranks, wall = run_ranks(
                _rank_lm_tp, 2, (twin_dir, dev, parts),
                lambda d, r: json.load(open(f"{d}/rank{r}.json")),
                label, timeout=600.0)
            dry = dry.result()
    names = [p[0] for p in parts]
    say(f"[{label}] one spawn of 2 ranks for {', '.join(names)}: {wall:.3f}"
        f" s with start-up; parts by rank " + json.dumps(
            {r["rank"]: {p: round(r[p]["seconds"], 3) for p in names}
             for r in ranks}) + f" ({card})")
    lm_tp_checks(ranks, twins, dry, card, parts, label)


def lm_tp_checks(ranks, twins, dry, card, parts, label):
    """(w)'s and (x)'s bars on each rank: every step's logits and the
    prefill's within 1e-4 x max|logits| of the twin's, the parameter bytes
    equal to the dry run's, the blocks drawn within one leaf above them,
    the collectives of every step and of the prefill ``tp_collectives``'
    count."""
    for part, arch, dtype, _, layers in parts:
        tw, d = twins[part], dry[part]
        tag = f"{label}-{part}"
        require(d["status"] == "ok", f"{tag}: the dry run: "
                f"{d.get('error') or d.get('reason')}")
        m = d["memory"]
        want = tw["collectives"]
        width = "at full width" + ("" if layers is None else
                                   f", its first {layers} layers")
        twin_ms = np.asarray(tw["step_s"][TP_PROMPT:]) * 1e3
        say(f"[{tag}] twin: {arch} {width}, {tw['param_count']}"
            f" parameters in {dtype}, float32 compute, one process: B "
            f"{TP_B}, prompt {TP_PROMPT}, gen {TP_GEN}, cache {TP_CACHE}: "
            f"p50 {np.percentile(twin_ms, 50):.3f} ms a step (first "
            f"{1e3 * tw['step_s'][0]:.3f}), peak device memory "
            f"{tw['peak']} bytes ({card})")
        for r in ranks:
            w = r[part]
            ms = np.asarray(w["step_s"][TP_PROMPT:]) * 1e3
            err = max(w["errs"])
            say(f"[{tag}] rank {r['rank']} on (data 1, model 2): "
                f"parameter bytes {w['param_bytes']} (its blocks' storages "
                f"at the allocator's 512-byte grain; the dry run's "
                f"{m['param_bytes']}; the allocator's count after the draw "
                f"{w['allocated']}), the draw's peak {w['init_peak']} "
                f"(blocks plus one leaf: at most "
                f"{w['allocated'] + tw['max_leaf_bytes']}); decode peak "
                f"{w['decode_peak']}, "
                f"whole part {w['peak']} bytes beside the dry run's "
                f"predicted peak {m['peak_bytes']} (resident "
                f"{m['resident_bytes']}, step {m['step_peak_bytes']}, "
                f"workspaces {m['workspace_bytes']}); every step's logits "
                f"within {err:.3e} x max|logits| of the twin's, the "
                f"prefill's within {w['prefill_err']:.3e} (bar 1e-4); "
                f"collectives a step {json.dumps(w['counts'][0])} "
                f"(prefill {json.dumps(w['prefill_counts'])}; the formula's "
                f"{json.dumps(want)}; the dry run's "
                f"{json.dumps(d['collectives']['counts'])}); p50 "
                f"{np.percentile(ms, 50):.3f} ms a step (first "
                f"{1e3 * w['step_s'][0]:.3f}) beside the twin's "
                f"{np.percentile(twin_ms, 50):.3f} ({card})")
            require(err <= 1e-4 and w["prefill_err"] <= 1e-4,
                    f"{tag}: rank {r['rank']}'s logits differ from the "
                    f"twin's")
            require(w["param_bytes"] == m["param_bytes"],
                    f"{tag}: rank {r['rank']}'s parameter bytes are not "
                    f"the dry run's")
            require(all(c == want for c in w["counts"])
                    and w["prefill_counts"] == want,
                    f"{tag}: rank {r['rank']}'s collectives are not "
                    f"{want} a step")
            require(w["init_peak"] <= w["allocated"] + tw["max_leaf_bytes"],
                    f"{tag}: rank {r['rank']}'s draw held more than its "
                    f"blocks and one leaf")


def lm_phase(torch, T):
    """Phase 21.  Returns (the launch counts of each pruning curve, by
    path; a function returning each kernel's checks at the curves' shapes,
    by curve, called when the card is otherwise idle; the peaks of (a)'s
    run and of (r)'s ranks, for phase 22)."""
    with timed_phase("lm-example"):
        run, counts, calls = lm_example_phase(torch)
    example_peak = run["peak"]
    losses = run["losses"]
    res = run["curve"]
    del run
    with timed_phase("lm-gemma2-2b"):
        lm_full_width_phase(torch)
    with timed_phase("lm-serve"):
        lm_serve_phase(torch)
    with timed_phase("lm-resume"):
        ck_d = lm_resume_phase(torch, losses)
    with timed_phase("lm-granite-moe"):
        signal, moe_metrics = lm_moe_train_phase(torch)
    with timed_phase("lm-moe-curve"):
        counts_moe, calls_moe, res_moe = lm_moe_curve_phase(torch, signal)
    zero_peaks = lm_zero_phase(torch, losses, moe_metrics, ck_d)
    with timed_phase("lm-tp"):
        lm_tp_phase(torch, TP_PARTS, "lm-tp")
    with timed_phase("lm-minicpm3"):
        lm_mla_serve_phase(torch)
    with timed_phase("lm-deepseek-v2"):
        lm_deepseek_phase(torch)
    with timed_phase("lm-zamba2-train"):
        lm_train_full(torch, "zamba2-2.7b", 2, 256, "lm-zamba2-train")
    with timed_phase("lm-zamba2-serve"):
        lm_serve_full(torch, "zamba2-2.7b", "lm-zamba2-serve", 24)
    with timed_phase("lm-mamba2-layer"):
        lm_mamba_layer_phase(torch)
    with timed_phase("lm-xlstm"):
        lm_train_full(torch, "xlstm-350m", 4, 256, "lm-xlstm-train")
        lm_serve_full(torch, "xlstm-350m", "lm-xlstm-serve", 25)
    counts_vlm, calls_vlm, res_vlm = lm_encdec_vision_phase(torch)
    torch.cuda.empty_cache()

    def checks():
        out = {}
        for key, (r, c, label) in {"lm_curve": (res, calls, "lm-curve"),
                                   "lm_moe_curve": (res_moe, calls_moe,
                                                    "lm-moe-curve"),
                                   "lm_vlm_curve": (res_vlm, calls_vlm,
                                                    "lm-vlm-curve")}.items():
            for name, row in curve_checks(torch, T, r, c, label).items():
                out.setdefault(name, {})[key] = row
        return out
    return {"lm-pruning-curve": counts,
            "lm-moe-pruning-curve": counts_moe,
            "lm-vlm-pruning-curve": counts_vlm}, checks, dict(
                example=example_peak, zero=zero_peaks)


def lm_encdec_vision_phase(torch, dev="cuda"):
    """Parts (m)-(q): the enc-dec family and the vision prefix.  Returns
    (q)'s (launch counts, graphed-solve record, curve)."""
    with timed_phase("lm-seamless-train"):
        lm_seamless_train_phase(torch, dev)
    with timed_phase("lm-seamless-serve"):
        lm_seamless_serve_phase(torch, dev)
    with timed_phase("lm-llava-serve"):
        lm_llava_serve_phase(torch, dev)
    with timed_phase("lm-llava-train"):
        signal, _ = lm_llava_train_phase(torch, dev)
    with timed_phase("lm-vlm-curve"):
        return lm_vlm_curve_phase(torch, signal, dev)


# ---------------------------------------------------------------------------
# phase 22: the port's audits on the card, the predicted memory envelope
# against the allocator, the capacity planner's answer run, the dry run
# against phase 21's measured peaks
# ---------------------------------------------------------------------------

CAPACITY_BUDGET = int(4e9)    # (c)'s budget, bytes
CAPACITY_SURVIVORS = 16384    # the planner's screened solve bucket
# (c)'s plan: the default grid (down to 0.01 of lambda_max), whose last
# rows keep more than the screened bucket on random data
CAPACITY_PLAN = dict(alpha=1.0, n_lambdas=8, tol=1e-6, safety=1e-6,
                     max_iter=6000, check_every=50)


def audit_layers(torch):
    """(a) ``run_layers`` on every layer on the card, against the committed
    baseline and budgets: no new finding."""
    from repro_torch import analysis
    root = SRC / "repro_torch" / "analysis"
    t0 = time.perf_counter()
    found = analysis.run_layers(analysis.LAYERS, device="cuda",
                                budgets=str(root / "budgets.json"))
    wall = time.perf_counter() - t0
    new, matched, stale = analysis.diff_against_baseline(
        found, analysis.load_baseline(str(root / "baseline.json")))
    say(f"[audits-a] layers {','.join(analysis.LAYERS)} on the card in "
        f"{wall:.3f} s: {len(found)} findings, {len(matched)} baselined, "
        f"{len(new)} new, {len(stale)} stale baseline entries")
    for f in new:
        say(f"[audits-a] NEW {f.rule} @ {f.location}: {f.detail}")
    require(new == [], f"audits-a: {len(new)} new findings")


def audit_envelope(torch, T, N=250, G=1000, n=10):
    """(b) phase 3's float32 Synthetic-1 path and phase 6's 5-fold SGL CV on
    one session in this process: the allocator's peak above what was
    allocated before, against the resource audit's envelope of the keys
    and graphs the calls paid."""
    from repro_torch.analysis import compile_audit as cka
    from repro_torch.analysis import resource_audit as ra
    from repro_torch.data_synth import synthetic_sgl
    X, y, _ = synthetic_sgl(1, N=N, G=G, n=n, gamma1=0.1, gamma2=0.1, seed=1)
    path_plan = T.Plan(alpha=1.0, n_lambdas=100, tol=1e-6, safety=1e-6,
                       max_iter=6000, check_every=50)
    cv_plan = T.Plan(**CV_PLAN)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sess = T.SGLSession(T.Problem.sgl(X, y, [n] * G))       # cuda, float32
    res = sess.path(path_plan)
    cv = sess.cv(cv_plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    note_wall(wall)
    peak = torch.cuda.max_memory_allocated() - base
    shape = cka.ProblemShape.of(sess.problem)
    keys = cka.predict_keys(shape, path_plan, ("path",)) | \
        cka.predict_keys(shape, cv_plan, ("cv",))
    graphs = cka.predict_graph_keys(shape, path_plan, ("path",)) | \
        cka.predict_graph_keys(shape, cv_plan, ("cv",))
    paid, captured = set(sess.compile_keys), set(sess.fista_graphs)
    found = cka.verify_paid_keys(paid, keys, "audits-b") + \
        cka.verify_paid_graphs(captured, graphs, "audits-b")
    require(found == [], f"audits-b: {[str(f) for f in found]}")
    t1 = time.perf_counter()
    env = ra.session_envelope(shape, paid, captured, device="cuda",
                              grid_len=100, n_folds=5)
    no_ws = env["total"] - env["workspace"]
    say(f"[audits-b] Synthetic-1 path (100 lambdas, {int(res.iters.sum())} "
        f"FISTA iterations) + 5-fold CV on one session in {wall:.3f} s: "
        f"{len(paid)} keys, {len(captured)} graphs paid; allocator peak "
        f"{peak} bytes above the {base} before; envelope {env['total']} "
        f"(residents {env['residents']}, {env['n_graphs']} graphs "
        f"{env['graphs']}, largest transient {env['transient']}, cuBLAS "
        f"workspaces {env['workspace']}; priced in "
        f"{time.perf_counter() - t1:.3f} s): measured / predicted "
        f"{peak / env['total']:.4f}, without the workspaces "
        f"{peak / no_ws:.4f}")
    require(cv.best_index >= 0, "audits-b: the CV selected nothing")
    require(peak <= env["total"], "audits-b: the allocator's peak is above "
            "the audit's envelope")
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    return dict(peak=peak, envelope=env)


def capacity_run(torch, T, out):
    """(c), in a process of its own (``python3 chip_smoke.py --capacity
    OUT``): the planner's largest p for the SGL path (N 250, groups of 10,
    8 lambdas) at ``CAPACITY_BUDGET`` bytes and at the card's memory; then
    that path at 0.95 of the first answer, with the process's share of
    the card set to the budget; then the audit's envelope of the keys and
    graphs the run paid, and the planner's screened card at that p."""
    from repro_torch.analysis import compile_audit as cka
    from repro_torch.analysis import resource_audit as ra
    from repro_torch.launch import cost_analysis as ca
    plan = T.Plan(**CAPACITY_PLAN)
    kw = dict(plan=plan, N=250, group_size=10, survivors=CAPACITY_SURVIVORS,
              device="cuda")
    t0 = time.perf_counter()
    p_cap = ra.capacity_max_p("sgl", "float32", "path",
                              hbm_bytes=CAPACITY_BUDGET, **kw)
    t_plan = time.perf_counter() - t0
    hbm = ca.device_hbm_bytes()
    p_card = ra.capacity_max_p("sgl", "float32", "path", hbm_bytes=hbm, **kw)
    p = 10 * int(0.95 * p_cap / 10)
    G = p // 10
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(CAPACITY_BUDGET / total)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(7)
    X = torch.randn((250, p), generator=gen, device="cuda")
    beta = torch.zeros(p, device="cuda")
    beta[:50] = torch.randn(50, generator=gen, device="cuda")
    y = X @ beta + 0.1 * torch.randn(250, generator=gen, device="cuda")
    del beta
    t1 = time.perf_counter()
    sess = T.SGLSession(T.Problem.sgl(X, y, [10] * G))
    del X, y
    res = sess.path(plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    buckets = [b[0] for b in res.stats.buckets]
    shape = cka.ProblemShape.of(sess.problem)
    paid, captured = set(sess.compile_keys), set(sess.fista_graphs)
    unpredicted = [str(f) for f in cka.verify_paid_keys(
        paid, cka.predict_keys(shape, plan, ("path",)), "audits-c")
        + cka.verify_paid_graphs(
            captured, cka.predict_graph_keys(shape, plan, ("path",)),
            "audits-c")]
    env = ra.session_envelope(shape, paid, captured, device="cuda",
                              grid_len=plan.n_lambdas)
    screened = ra._peak_at(p, "sgl", "float32", "path", **kw)
    Path(out).write_text(json.dumps(dict(
        p_cap=p_cap, p_card=p_card, hbm=hbm, p=p, peak=peak, base=base,
        wall=wall, t_plan=t_plan, rows=int((res.iters > 0).sum()),
        iters=int(res.iters.sum()), max_bucket=max(buckets, default=0),
        kept=[int(k) for k in res.kept_features], n_keys=len(paid),
        n_graphs=len(captured), unpredicted=unpredicted, envelope=env,
        screened_peak=screened, total=total)))
    return 0


def audit_capacity(torch):
    """(c) from this process: the child's run, its gates and its numbers.
    The run's peak is held to the budget and to the audit's envelope of
    the keys and graphs it paid; the planner's screened card at p holds
    only while every bucket stays within ``CAPACITY_SURVIVORS`` features,
    and is printed beside (no gate)."""
    import tempfile
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        out = f"{d}/capacity.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--capacity",
             out], cwd=ROOT, stdin=subprocess.DEVNULL, capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            say(proc.stdout[-4000:] + proc.stderr[-4000:])
        require(proc.returncode == 0, f"audits-c: the capacity run exited "
                f"{proc.returncode}")
        r = json.loads(Path(out).read_text())
    env = r["envelope"]
    regime = ("within" if r["max_bucket"] <= CAPACITY_SURVIVORS
              else "past")
    say(f"[audits-c] capacity_max_p (SGL path, N 250, groups of 10, 8 "
        f"lambdas, float32 on the card's route, screened bucket "
        f"{CAPACITY_SURVIVORS}): {r['p_cap']} features at "
        f"{CAPACITY_BUDGET} bytes (planned in {r['t_plan']:.3f} s), "
        f"{r['p_card']} at the card's {r['hbm']} bytes; the path at p = "
        f"{r['p']} (0.95 of the first) under a memory fraction of "
        f"{CAPACITY_BUDGET} bytes: {r['rows']} rows, {r['iters']} FISTA "
        f"iterations, kept features {r['kept']}, largest bucket "
        f"{r['max_bucket']} ({regime} the screened regime), "
        f"{r['wall']:.3f} s; allocator peak {r['peak']} bytes "
        f"({r['peak'] / CAPACITY_BUDGET:.4f} of the budget); envelope of "
        f"the {r['n_keys']} keys and {r['n_graphs']} graphs paid "
        f"{env['total']} (residents {env['residents']}, graphs "
        f"{env['graphs']}, largest transient {env['transient']}, cuBLAS "
        f"workspaces {env['workspace']}): measured / predicted "
        f"{r['peak'] / env['total']:.4f}; the planner's screened card at p "
        f"{r['screened_peak']}: measured / screened "
        f"{r['peak'] / r['screened_peak']:.4f}; the child's wall "
        f"{wall:.3f} s")
    require(r["unpredicted"] == [], f"audits-c: {r['unpredicted']}")
    require(r["peak"] <= CAPACITY_BUDGET, "audits-c: the capacity run's "
            "peak is above its budget")
    require(r["peak"] <= env["total"], "audits-c: the capacity run's peak "
            "is above the audit's envelope of the keys it paid")
    return r


def audit_dryrun(torch, peaks):
    """(d) the dry run of the example's train step (``gemma2-100m``, B 8,
    S 256, no mesh, float32, remat none, as ``launch.train`` runs it)
    against phase 21 (a)'s measured peak, which the fresh ``lm`` worker
    reads with every workspace taken inside it; (e) the dry run of (r)'s
    granite ZeRO-3 cell on a fake (data 2, model 1) world beside (r)'s
    measured peaks (no gate)."""
    from repro_torch.configs.base import get_config
    from repro_torch.examples import sgl_pruned_lm as ex
    from repro_torch.launch import dryrun
    kw = dict(shape_name="train_4k", seq=256, remat="none",
              compute_dtype=torch.float32)
    t0 = time.perf_counter()
    d = dryrun.run_cell(arch="gemma2-100m", cfg=ex.example_config(),
                        mesh_shape={}, batch=8, **kw)
    require(d["status"] == "ok", f"audits-d: {d.get('error')}")
    m = d["memory"]
    pred, measured = m["peak_bytes"], peaks["example"]
    taken = measured - m["resident_bytes"] - m["step_peak_bytes"] - \
        m["carried_bytes"]
    say(f"[audits-d] dry run of gemma2-100m's train step (B 8, S 256, no "
        f"mesh, float32) on fake {d['trace_device']} tensors in "
        f"{time.perf_counter() - t0:.3f} s: peak {pred} bytes (state and "
        f"batch {m['resident_bytes']} + step {m['step_peak_bytes']} + the "
        f"previous step's metrics {m['carried_bytes']} + cuBLAS workspaces "
        f"at most {m['workspace_bytes']}), FLOPs "
        f"{d['roofline']['flops']:.4e}, useful {d['useful_flops_ratio']:.4f}"
        f"; phase 21 (a) measured {measured} bytes: predicted / measured "
        f"{pred / max(measured, 1):.4f}; the measured less state, step and "
        f"metrics {taken} bytes = {taken / 2**20:.4f} MiB of workspaces "
        f"against at most {m['workspace_bytes'] / 2**20:.4f}")
    require(pred >= measured, "audits-d: the dry run's peak is below the "
            "measured step's")
    t0 = time.perf_counter()
    e = dryrun.run_cell(arch="granite-moe-1b-a400m",
                        cfg=get_config("granite-moe-1b-a400m"),
                        mesh_shape={"data": 2, "model": 1}, batch=4, **kw)
    require(e["status"] == "ok", f"audits-e: {e.get('error')}")
    say(f"[audits-e] dry run of (r)'s cell (granite-moe-1b-a400m, ZeRO-3 on "
        f"a fake (data 2, model 1) world, B 4, S 256, float32) in "
        f"{time.perf_counter() - t0:.3f} s: a rank's peak "
        f"{e['memory']['peak_gb'] * 1e9 / 2**30:.3f} GiB (state "
        f"{e['memory']['resident_gb'] * 1e9 / 2**30:.3f}), collectives "
        f"{json.dumps(e['collectives']['counts'])} (equal to the port's "
        f"tallies: {e['collectives']['match_tallies']}); (r) measured "
        f"{[round(v / 2**30, 3) for v in peaks['zero']]} GiB a rank")
    return dict(d=d, e=e)


def audits_phase(torch, T, peaks):
    """Phase 22 (parts (a)-(e)), in the ``lm`` worker after phase 21."""
    with timed_phase("audits-a"):
        audit_layers(torch)
    with timed_phase("audits-b"):
        audit_envelope(torch, T)
    with timed_phase("audits-c"):
        audit_capacity(torch)
    with timed_phase("audits-de"):
        audit_dryrun(torch, peaks)


# ---------------------------------------------------------------------------
# phase 23: each kernel against its plain version, and its time
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps=10, inner=20):
    """Device time of one call, in ms: ``inner`` calls are captured in one
    CUDA graph, and the median over ``reps`` replays, timed by CUDA events,
    is divided by ``inner``.  The replays carry no host work, so a short
    kernel is timed by what the card spends on it, not by its launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return float(np.median(out))


def eager_ms(torch, fn, reps=10, inner=50):
    """Time per call of ``inner`` eager back-to-back calls (median over
    ``reps``, CUDA events): what the path pays per call, host issue
    included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return float(np.median(out))


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _cycling(pool, fn):
    """A call that takes the next member of ``pool`` each time: timed in a
    graph of 20 calls, each call finds its input evicted from L2 by the
    others' when the pool holds more than the 50 MB L2."""
    state = {"i": 0}

    def call():
        state["i"] += 1
        return fn(pool[state["i"] % len(pool)])
    return call


def check_xtv(torch, X, label):
    """Within ``2*N*eps*sum|x v|`` per column of the plain version, bit for
    bit the same on a second run; timed against ``torch.mv(X.T, v)``
    L2-warm (one X, back to back) and L2-cold (a pool of copies of X over
    100 MB, so each call reads X from HBM)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.xtv import xtv_cuda
    N, p = X.shape
    v = torch.randn(N, device=X.device)
    got = xtv_cuda(X, v)
    again = xtv_cuda(X, v)
    want = ref.xtv_ref(X, v)
    torch.cuda.synchronize()
    err = (got - want).abs()
    # per column: N * eps * sum_i |x_ij v_i| (summation order differs)
    tol = N * EPS32 * (X.abs() * v.abs()[:, None]).sum(dim=0)
    require(bool(torch.isfinite(got).all()), f"xtv {label}: non-finite")
    require(bool((err <= 2 * tol + 1e-30).all()),
            f"xtv {label}: outside 2*N*eps*sum|x v|")
    require(torch.equal(got, again), f"xtv {label}: differs between runs")
    ms = time_ms(torch, lambda: xtv_cuda(X, v))
    eager = eager_ms(torch, lambda: xtv_cuda(X, v))
    plain = time_ms(torch, lambda: ref.xtv_ref(X, v), inner=5)
    lib = time_ms(torch, lambda: torch.mv(X.T, v))
    n_copies = max(2, -(-100_000_000 // (4 * N * p)))
    pool = [X] + [X.clone() for _ in range(n_copies - 1)]
    ms_cold = time_ms(torch, _cycling(pool, lambda A: xtv_cuda(A, v)))
    lib_cold = time_ms(torch, _cycling(pool, lambda A: torch.mv(A.T, v)))
    del pool
    b, by = bound_ms(4 * (N * p + N + p), 2 * N * p)
    say(f"[kernel xtv {label}] X {tuple(X.shape)} max_abs_err "
        f"{float(err.max()):.3e} (tol 2*N*eps*sum|x v|, max "
        f"{float(tol.max()):.3e}), same bits on a second run; L2-warm: ms "
        f"{ms:.5f} torch.mv {lib:.5f}; L2-cold ({n_copies} copies of X): ms "
        f"{ms_cold:.5f} torch.mv {lib_cold:.5f}; eager_ms {eager:.5f} "
        f"plain_ms {plain:.5f} bound_ms {b:.5f} ({by}); faster than "
        f"torch.mv: warm {ms < lib}, cold {ms_cold < lib_cold}")
    return dict(max_abs_err=float(err.max()), ms=ms, eager_ms=eager,
                plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
                ms_l2_cold=ms_cold, library_ms_l2_cold=lib_cold)


def _poisoned(torch, rows, mask_rows, dev, scale=2.0):
    """float32 (rows, n_max) values with 1e30 in every masked slot, for a
    mask whose rows repeat every mask_rows.shape[0] rows."""
    G, n_max = mask_rows.shape
    vals = torch.randn(rows, n_max, device=dev) * scale
    return torch.where(mask_rows.repeat(rows // G, 1), vals, 1e30).contiguous()


def _screen_poisoned(torch, L, spec):
    """C (L, p + 2) on the card for ``spec``'s padded view: column p holds
    1e30 and column p + 1 NaN, and every masked slot of the returned index
    points at one of the two (alternately).  The columns past the spec's
    last group (a padded block's pad columns, which no group owns) hold
    1e30 and NaN alternately too."""
    G, n_max = spec.pad_index.shape
    p = spec.num_features
    dev = spec.device
    C = torch.randn(L, p + 2, device=dev) * 2
    C[:, p], C[:, p + 1] = 1e30, float("nan")
    covered = int(spec.sizes.sum())
    pads = torch.arange(covered, p, device=dev)
    C[:, covered:p] = torch.where(pads % 2 == 0, 1e30, float("nan"))
    alt = p + torch.arange(G * n_max, device=dev).reshape(G, n_max) % 2
    idx = torch.where(spec.pad_mask, spec.pad_index, alt).contiguous()
    return C, idx, spec.pad_mask


def check_screen_norms(torch, L, spec, label, floor_ms=None):
    """The fused screen statistics against their plain composition
    (gather, mask, padded statistics) under 1e30 and NaN poison in every
    masked slot: ``snorm2`` within rtol = atol = 1e-5, ``cinf`` (a max)
    exactly, every output finite.  Timed as the path calls it (C of shape
    (L, p), the spec's own index and mask) L2-warm (one C, back to back)
    and L2-cold (a pool of copies of C over 100 MB), beside its bound and
    the launch floor."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.screen_norms import screen_norms_cuda
    C, idx, mask = _screen_poisoned(torch, L, spec)
    G, n_max = idx.shape
    got = screen_norms_cuda(C, idx, mask)
    want = ref.screen_norms_gather_ref(C, idx, mask)
    torch.cuda.synchronize()
    for g in got:
        require(bool(torch.isfinite(g).all()),
                f"screen_norms {label}: non-finite (poison leaked)")
    require(bool(torch.allclose(got[0], want[0], **KERNEL_TOL)),
            f"screen_norms {label}: snorm2 outside rtol=atol=1e-5")
    require(torch.equal(got[1], want[1]),
            f"screen_norms {label}: cinf differs from the plain max")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    C = C[:, :spec.num_features].contiguous()    # the path's inputs
    idx = spec.pad_index
    ms = time_ms(torch, lambda: screen_norms_cuda(C, idx, mask))
    eager = eager_ms(torch, lambda: screen_norms_cuda(C, idx, mask))
    plain = time_ms(torch, lambda: ref.screen_norms_gather_ref(C, idx, mask))
    n_copies = max(2, -(-100_000_000 // (4 * C.numel())))
    pool = [C] + [C.clone() for _ in range(n_copies - 1)]
    ms_cold = time_ms(torch, _cycling(
        pool, lambda A: screen_norms_cuda(A, idx, mask)))
    del pool
    valid = int(mask.sum())
    b, by = bound_ms(4 * L * valid + 9 * G * n_max + 8 * L * G,
                     6 * L * valid)
    n_pad = spec.num_features - int(spec.sizes.sum())
    say(f"[kernel screen_norms {label}] checked on C ({L}, {C.shape[1] + 2}) "
        f"with 2 poison columns and {n_pad} poisoned pad columns, timed on C {tuple(C.shape)}; G {G} n_max "
        f"{n_max} valid {valid / (G * n_max):.3f} max_abs_err {err:.3e} "
        f"(tol rtol=atol=1e-5, cinf exact) L2-warm ms {ms:.5f} L2-cold "
        f"({n_copies} copies of C) ms {ms_cold:.5f}"
        f"{'' if floor_ms is None else f' launch floor {floor_ms:.5f}'} "
        f"eager_ms {eager:.5f} plain_ms {plain:.5f} bound_ms {b:.5f} ({by}); "
        f"warm / bound {ms / b:.2f}")
    return dict(max_abs_err=err, ms=ms, ms_l2_cold=ms_cold, eager_ms=eager,
                plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
                launch_floor_ms=floor_ms)


def check_screen_step(torch, L, spec, label):
    """The group-statistics step as the path runs it,
    ``_grid_group_stats(spec, C, True)`` (the fused kernel and a ``sqrt``),
    timed beside the gather and the mask that the unfused screen ran in
    front of its kernel, on a C of the path's shape (L, p)."""
    from repro_torch.core.screening import _grid_group_stats
    C = torch.randn(L, spec.num_features, device=spec.device) * 2
    step = time_ms(torch, lambda: _grid_group_stats(spec, C, True))
    copy = time_ms(torch, lambda: torch.where(
        spec.pad_mask[None], C[:, spec.pad_index], 0.0))
    say(f"[screen step {label}] C {tuple(C.shape)}: _grid_group_stats(spec, "
        f"C, True) ms {step:.5f}; the gather + where that the unfused "
        f"screen ran before its kernel ms {copy:.5f}")
    return step


def check_screen_cv_shape(torch, R, spec, label):
    """Data for a later decision (CV is not rerouted): the fused kernel at
    the SGL CV's first stacked screen shape, beside that screen's own step
    (gather, mask and ``screen_norms_folds``) on the same C."""
    from repro_torch.core.screening import _grid_group_stats_folds
    from repro_torch.kernels.screen_norms import screen_norms_cuda
    C = torch.randn(R, spec.num_features, device=spec.device) * 2
    fused = time_ms(torch, lambda: screen_norms_cuda(C, spec.pad_index,
                                                     spec.pad_mask))
    folds = time_ms(torch, lambda: _grid_group_stats_folds(
        spec, C.reshape(1, R, -1), True))
    say(f"[screen cv-shape {label}] C {tuple(C.shape)}: fused screen_norms "
        f"ms {fused:.5f}; gather + where + screen_norms_folds + sqrt ms "
        f"{folds:.5f}")


def _bucket_spec(torch, T, sizes, keep, p_b, g_b):
    """A bucketed spec (garbage bin past n_max) on the card."""
    full = T.GroupSpec.from_sizes(sizes, device="cpu")
    gid = np.repeat(np.arange(len(sizes)), sizes)
    sub, _ = full.bucketed_subset(np.isin(gid, keep), p_b, g_b)
    return sub.to("cuda")


def check_sgl_prox(torch, spec, label, floor_ms=None):
    """The fused flat prox against its plain composition on ``spec``'s
    padded view, with one more column, uncovered, that holds 1e30 and that
    every masked slot points at; every uncovered column (the spec's own and
    that one) must come out exactly 0.  Timed beside the launch floor."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sgl_prox import sgl_prox_cuda
    G, n_max = spec.pad_index.shape
    p = spec.num_features
    dev = spec.device
    mask = spec.pad_mask
    idx = torch.where(mask, spec.pad_index, p).contiguous()
    unc = torch.cat([spec.pad_uncovered,
                     torch.ones(1, dtype=torch.bool, device=dev)])
    v = torch.where(unc, 1e30, torch.randn(p + 1, device=dev) * 2)
    t_l1 = torch.tensor([0.3], device=dev)
    t_group = torch.rand(G, device=dev) * 2

    def kernel():
        return sgl_prox_cuda(v, idx, mask, unc, t_l1, t_group)

    def plain():
        return ref.sgl_prox_flat_ref(v, idx, mask, t_l1, t_group)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()),
            f"sgl_prox {label}: non-finite (poison leaked)")
    require(bool((got[unc] == 0).all()),
            f"sgl_prox {label}: an uncovered column is not 0")
    require(bool(torch.allclose(got, want, **KERNEL_TOL)),
            f"sgl_prox {label}: outside rtol=atol=1e-5")
    err = float((got - want).abs().max())
    ms = time_ms(torch, kernel)
    eager = eager_ms(torch, kernel)
    plain_ms = time_ms(torch, plain)
    q = p + 1
    b, by = bound_ms(4 * q + 9 * G * n_max + q + 4 * G + 4 + 4 * q,
                     8 * G * n_max)
    say(f"[kernel sgl_prox {label}] p {p} G {G} n_max {n_max} valid "
        f"{float(mask.float().mean()):.3f} uncovered "
        f"{int(spec.pad_uncovered.sum())} max_abs_err {err:.3e} (tol "
        f"rtol=atol=1e-5) ms {ms:.5f}"
        f"{'' if floor_ms is None else f' launch floor {floor_ms:.5f}'} "
        f"eager_ms {eager:.5f} plain_ms {plain_ms:.5f} bound_ms {b:.7f} "
        f"({by})")
    return dict(max_abs_err=err, ms=ms, eager_ms=eager, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=None,
                launch_floor_ms=floor_ms)


def check_screen_norms_folds(torch, R, mask, label):
    from repro_torch.kernels import ref
    from repro_torch.kernels.screen_norms_folds import screen_norms_folds_cuda
    G, n_max = mask.shape
    poison = _poisoned(torch, R * G, mask, mask.device).reshape(R, G, n_max)
    got = screen_norms_folds_cuda(poison, mask)
    want = ref.screen_norms_folds_ref(poison, mask)
    torch.cuda.synchronize()
    errs = []
    for g, w in zip(got, want):
        require(bool(torch.isfinite(g).all()),
                f"screen_norms_folds {label}: non-finite (poison leaked)")
        require(bool(torch.allclose(g, w, **KERNEL_TOL)),
                f"screen_norms_folds {label}: outside rtol=atol=1e-5")
        errs.append(float((g - w).abs().max()))
    ms = time_ms(torch, lambda: screen_norms_folds_cuda(poison, mask))
    eager = eager_ms(torch, lambda: screen_norms_folds_cuda(poison, mask))
    plain = time_ms(torch, lambda: ref.screen_norms_folds_ref(poison, mask))
    b, by = bound_ms(4 * R * G * n_max + G * n_max + 8 * R * G,
                     6 * R * G * n_max)
    say(f"[kernel screen_norms_folds {label}] rows {R} x G {G} n_max "
        f"{n_max} valid {float(mask.float().mean()):.3f} max_abs_err "
        f"{max(errs):.3e} (tol rtol=atol=1e-5) ms {ms:.5f} eager_ms "
        f"{eager:.5f} plain_ms {plain:.5f} bound_ms {b:.5f} ({by})")
    return dict(max_abs_err=max(errs), ms=ms, eager_ms=eager, plain_ms=plain,
                bound_ms=b, bound_by=by, library_ms=None)


def check_dpc_screen_folds(torch, K, L, p, label, borderline=False):
    """Exact equality with the plain version.  ``borderline``: inputs on
    which C + r*cn lands on 1.0 within one ulp, where a fused multiply-add
    would flip ``n_flips`` decisions."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.dpc_screen_folds import (borderline_inputs,
                                                      dpc_screen_folds_cuda)
    n_flips = None
    if borderline:
        C, r, cn, n_flips = borderline_inputs(K, L, p, seed=1)
        require(n_flips > 0, "the borderline case flips nothing under fma")
        C, r, cn = (torch.from_numpy(a).cuda() for a in (C, r, cn))
    else:
        gen = torch.Generator(device="cuda").manual_seed(K * L * p)
        C = torch.randn(K, L, p, device="cuda", generator=gen) * 0.5 + 0.6
        r = torch.rand(K, L, device="cuda", generator=gen)
        cn = torch.rand(K, p, device="cuda", generator=gen) + 0.5
    got = dpc_screen_folds_cuda(C, r, cn)
    want = ref.dpc_screen_folds_ref(C, r, cn)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    require(n_diff == 0, f"dpc_screen_folds {label}: {n_diff} decisions "
            f"differ from the plain version")
    ms = time_ms(torch, lambda: dpc_screen_folds_cuda(C, r, cn))
    eager = eager_ms(torch, lambda: dpc_screen_folds_cuda(C, r, cn))
    plain = time_ms(torch, lambda: ref.dpc_screen_folds_ref(C, r, cn))
    b, by = bound_ms(5 * K * L * p + 4 * K * L + 4 * K * p, 3 * K * L * p)
    say(f"[kernel dpc_screen_folds {label}] K {K} L {L} p {p} kept "
        f"{float(got.float().mean()):.3f} mismatches 0 (exact)"
        f"{'' if n_flips is None else f', fma would flip {n_flips}'} ms "
        f"{ms:.5f} eager_ms {eager:.5f} plain_ms {plain:.5f} bound_ms "
        f"{b:.5f} ({by})")
    return dict(max_abs_err=0.0, ms=ms, eager_ms=eager, plain_ms=plain,
                bound_ms=b, bound_by=by, library_ms=None)


def check_padded_entry_points(torch, L, spec, label):
    """The reference's padded entry points (``ops.screen_norms``,
    ``ops.screen_norms_batched``, ``ops.sgl_prox_padded``) on the spec's
    padded layout, 1e30 and NaN in the masked slots (alternately), against
    their plain versions on clean data: ``snorm2`` and the prox within
    rtol = atol = 1e-5, ``cinf`` and the prox's masked slots exactly; the
    three calls launch ``screen_norms`` twice and ``sgl_prox`` once, and
    nothing else."""
    from repro_torch.kernels import ops, ref
    mask = spec.pad_mask
    G, n_max = mask.shape
    dev = mask.device
    vals = torch.randn(L, G, n_max, device=dev) * 2
    alt = torch.arange(G * n_max, device=dev).reshape(G, n_max) % 2 == 1
    dirty = torch.where(mask, vals, torch.where(alt, float("nan"), 1e30))
    clean = torch.where(mask, vals, 0.0)
    t_group = torch.rand(G, device=dev) + 0.1
    before = ops.launch_counts()
    got_row = ops.screen_norms(dirty[0], mask)
    got_grid = ops.screen_norms_batched(dirty, mask)
    got_prox = ops.sgl_prox_padded(dirty[0], mask, 0.3, t_group)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    rose = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    require(rose == {"screen_norms": 2, "sgl_prox": 1},
            f"padded entry points {label}: launches {rose}")
    want = ref.screen_norms_folds_ref(clean, mask)
    want_prox = ref.sgl_prox_ref(clean[0], mask, 0.3, t_group)
    errs = []
    for name, got, w in (("screen_norms", got_row, (want[0][0], want[1][0])),
                         ("screen_norms_batched", got_grid, want)):
        require(all(bool(torch.isfinite(g).all()) for g in got),
                f"{name} {label}: non-finite (poison leaked)")
        require(bool(torch.allclose(got[0], w[0], **KERNEL_TOL)),
                f"{name} {label}: snorm2 outside rtol=atol=1e-5")
        require(torch.equal(got[1], w[1]),
                f"{name} {label}: cinf differs from the plain max")
        errs.append(float((got[0] - w[0]).abs().max()))
    require(bool(torch.isfinite(got_prox).all())
            and bool((got_prox[~mask] == 0).all())
            and bool(torch.allclose(got_prox, want_prox, **KERNEL_TOL)),
            f"sgl_prox_padded {label}: differs from the plain prox")
    errs.append(float((got_prox - want_prox).abs().max()))
    say(f"[kernel padded entry points {label}] L {L} G {G} n_max {n_max}: "
        f"screen_norms / screen_norms_batched / sgl_prox_padded max_abs_err "
        f"{errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e} (tol rtol=atol=1e-5, "
        f"cinf and masked slots exact), launches {rose}")
    return max(errs)


def kernel_checks(torch, T, sess_main, shapes, sess_ragged, ragged_bucket,
                  snf_shape, dsf_shape):
    spec = sess_main.problem.spec
    rspec = sess_ragged.problem.spec
    # the launch floor: a 1-element zero_() in the same graph harness
    one = torch.empty(1, device="cuda")
    floor = time_ms(torch, lambda: one.zero_())
    say(f"[kernel launch floor] 1-element zero_() ms {floor:.5f}")
    # the main path's shapes: the full X of the certification GEMV, the
    # first screen's padded (128 x G, n_max) grid, the prox bucket that ran
    # the most iterations
    rows = {
        "xtv": check_xtv(torch, sess_main.problem.X, "synthetic1"),
        "screen_norms": check_screen_norms(torch, shapes["L"], spec,
                                           "synthetic1", floor),
        "sgl_prox": check_sgl_prox(torch, shapes["bucket_spec"],
                                   "synthetic1-bucket", floor),
    }
    # ragged shapes with live masks: Table 2's X and padded layouts
    rows["xtv"]["table2"] = check_xtv(torch, sess_ragged.problem.X, "table2")
    check_screen_norms(torch, 8, rspec, "table2", floor)
    check_screen_norms(torch, 1, spec, "synthetic1-legacy-row", floor)
    check_screen_step(torch, shapes["L"], spec, "synthetic1")
    check_sgl_prox(torch, rspec, "table2-full", floor)
    check_sgl_prox(torch, ragged_bucket, "table2-bucket", floor)
    check_sgl_prox(torch, spec, "synthetic1-full", floor)
    check_sgl_prox(torch, _bucket_spec(torch, T, [1] * 4096,
                                       list(range(0, 4096, 3)), 2048, 2048),
                   "n_max-1", floor)
    check_sgl_prox(torch, _bucket_spec(torch, T, [40, 35, 7, 50] * 250,
                                       list(range(0, 1000, 4)), 16384, 512),
                   "n_max-50", floor)
    # the CV paths' shapes: the first stacked screen of each
    (R, _, _), _ = snf_shape
    rows["screen_norms_folds"] = check_screen_norms_folds(
        torch, R, spec.pad_mask, "sgl-cv")
    check_screen_cv_shape(torch, R, spec, "sgl-cv")
    check_screen_norms_folds(torch, 3 * 8, rspec.pad_mask, "table2-folds")
    (K, L, p), _, _ = dsf_shape
    rows["dpc_screen_folds"] = check_dpc_screen_folds(torch, K, L, p,
                                                      "nn-cv")
    check_dpc_screen_folds(torch, K, L, p + 7, "ragged-p")
    check_dpc_screen_folds(torch, K, L, p + 7, "borderline", borderline=True)
    # the reference's padded entry points, through the same two kernels
    check_padded_entry_points(torch, shapes["L"], spec, "synthetic1")
    check_padded_entry_points(torch, 8, rspec, "table2")
    return rows


# ---------------------------------------------------------------------------
# phase 24: the six root examples at the reference's sizes
# ---------------------------------------------------------------------------

#: the kernels each example's float32 run must launch (none for the LM)
EXAMPLE_KERNELS = {
    "quickstart": ("xtv", "screen_norms", "sgl_prox"),
    "nonneg_lasso_dpc": ("xtv",),
    "cv_model_selection": ("xtv", "screen_norms", "screen_norms_folds",
                           "sgl_prox"),
    "session_refinement": ("xtv", "screen_norms_folds", "sgl_prox"),
    "sgl_logistic": ("xtv", "screen_norms", "sgl_prox"),
    "serve_batched": (),
}


def _example_results(name, out):
    """(label, betas, scale) of each solution an example's ``run``
    returns, and (label, index) of each selection it makes.  ``scale``:
    the largest |beta| its bar is relative to (a served job's against the
    queue's largest coef)."""
    pick = {
        "quickstart": lambda o: [(k, o[k].betas) for k in
                                 ("res", "legacy", "base")],
        "nonneg_lasso_dpc": lambda o: [(k, o[k].betas) for k in
                                       ("res", "base")],
        "cv_model_selection": lambda o: [
            ("cv", o["cv"].fold_betas), ("sequential", np.stack(
                o["seq_betas"])), ("SGLCV", o["est"].coef_)],
        "session_refinement": lambda o: [
            ("coarse", o["coarse"].fold_betas),
            ("refined", o["refined"].fine.fold_betas),
            ("cold", o["cold"].fold_betas),
            ("served", np.stack([o["results"][j].coef
                                 for j in sorted(o["results"])]))],
        "sgl_logistic": lambda o: [
            (k, o[k].betas) for k in ("res", "base", "wres")] + [
            ("SGLClassifier", o["clf"].coef_)],
    }[name](out)
    index = {
        "cv_model_selection": lambda o: [("cv", o["cv"].best_index)],
        "session_refinement": lambda o: [
            ("coarse", o["coarse"].best_index),
            ("refined", o["refined"].index), ("cold", o["cold"].best_index)],
    }.get(name, lambda o: [])(out)
    return [(k, np.asarray(b, dtype=np.float64)) for k, b in pick], index


def _recorders():
    """{kernel: LaunchArgs of its CUDA function}: ``xtv``'s largest X, the
    first screen of each screen kernel, ``sgl_prox``'s largest vector."""
    from repro_torch.kernels import screen_norms as sn
    from repro_torch.kernels import screen_norms_folds as snf
    from repro_torch.kernels import sgl_prox as prox
    from repro_torch.kernels import xtv
    return {"xtv": LaunchArgs(xtv, "xtv_cuda", largest=True),
            "screen_norms": LaunchArgs(sn, "screen_norms_cuda"),
            "screen_norms_folds": LaunchArgs(snf, "screen_norms_folds_cuda"),
            "sgl_prox": LaunchArgs(prox, "sgl_prox_cuda", largest=True)}


def example_kernel_checks(torch, T, inputs):
    """Phase 23's checks at the inputs that each example's float32 run
    gave each kernel it called (``inputs``: {example: {kernel: the arguments
    ``_recorders`` kept}}): ``xtv`` on the largest X, ``screen_norms`` at
    the first screen's C rows and padded layout, ``screen_norms_folds`` at
    the first stacked screen's rows and mask, ``sgl_prox`` on the largest
    prox vector's layout and on the problem's whole layout (the spec of
    the screens' mask).  Each against its plain version at phase 23's
    tolerances.  Returns {kernel: {``example_<name>[_full]``: row}}."""
    from types import SimpleNamespace
    out = {}
    for name, args in inputs.items():
        key, label = f"example_{name}", f"example-{name}"
        rows = {}
        if "xtv" in args:
            rows["xtv"] = check_xtv(torch, args["xtv"][0], label)
        if "screen_norms" in args:
            C, idx, mask = args["screen_norms"]
            layout = SimpleNamespace(pad_index=idx, pad_mask=mask,
                                     num_features=C.shape[1],
                                     sizes=mask.sum(dim=1), device=C.device)
            rows["screen_norms"] = check_screen_norms(torch, C.shape[0],
                                                      layout, label)
            whole = mask
        if "screen_norms_folds" in args:
            c_pad, mask = args["screen_norms_folds"]
            rows["screen_norms_folds"] = check_screen_norms_folds(
                torch, c_pad.shape[0], mask, label)
            whole = mask
        if "sgl_prox" in args:
            v, idx, mask, unc = args["sgl_prox"][:4]
            layout = SimpleNamespace(pad_index=idx, pad_mask=mask,
                                     pad_uncovered=unc,
                                     num_features=v.shape[0], device=v.device)
            rows["sgl_prox"] = check_sgl_prox(torch, layout,
                                              f"{label}-largest")
            spec = T.GroupSpec.from_sizes(whole.sum(dim=1).tolist(),
                                          device="cuda")
            require(torch.equal(spec.pad_mask, whole),
                    f"{label}: the screens' mask is not a spec's layout")
            out.setdefault("sgl_prox", {})[f"{key}_full"] = check_sgl_prox(
                torch, spec, f"{label}-full")
        for kernel, row in rows.items():
            out.setdefault(kernel, {})[key] = row
    return out


def examples_phase(torch, T):
    """Phase 24: each root example's ``main`` on the card (float32, the
    reference's sizes), its kernels' launches counted and their inputs
    kept; then the same ``run`` in float64 on the card, which launches no
    kernel, as the reference for the float32 results at PERF.md section
    2's bars (betas within 1e-2 * max|beta|, a CV's selection within one
    step).  Returns the launch counts by path, and a function that holds
    each kernel against its plain version at those inputs
    (``example_kernel_checks``), called when the card is otherwise
    idle."""
    import importlib
    from repro_torch.kernels import ops
    paths, inputs = {}, {}
    for name, kernels in EXAMPLE_KERNELS.items():
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        label = f"example-{name}"
        say(f"[{label}] python -m repro_torch.examples.{name} --device cuda")
        argv = ["--device", "cuda"]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if name == "serve_batched":
            lat = []
            gen = mod.main(argv, latencies=lat)
            wall = time.perf_counter() - t0
            require(gen.shape == (8, 24) and len(lat) == 24,
                    f"{label}: generated {gen.shape}, {len(lat)} steps")
            out32 = dict(walls=dict(main=wall, decode_steps=float(sum(lat))))
        else:
            with contextlib.ExitStack() as stack:
                rec = {k: stack.enter_context(r) for k, r in
                       _recorders().items()}
                out32 = mod.main(argv)
            wall = time.perf_counter() - t0
            inputs[name] = {k: r.args for k, r in rec.items()
                            if r.args is not None}
            require(set(kernels) <= set(inputs[name]),
                    f"{label}: the CUDA function of a kernel in "
                    f"{kernels} was never called")
        note_wall(wall)
        counts = ops.launch_counts()
        paths[label] = counts
        missing = [k for k in kernels if not counts[k]]
        require(not missing, f"{label}: no launch of {missing} ({counts})")
        say(f"[{label}] exit 0 in {wall:.3f} s; walls "
            f"{json.dumps({k: round(v, 6) for k, v in out32['walls'].items()})}"
            f"; launches {json.dumps(counts)}")
        if name == "serve_batched":
            continue
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out64 = mod.run(device="cuda", dtype=torch.float64)
        wall64 = time.perf_counter() - t0
        note_wall(wall64)
        require(not any(ops.launch_counts().values()),
                f"{label}: float64 launched {ops.launch_counts()}")
        got, idx32 = _example_results(name, out32)
        want, idx64 = _example_results(name, out64)
        rel = {}
        for (k, b32), (_, b64) in zip(got, want):
            scale = float(np.max(np.abs(b64)))
            err = float(np.max(np.abs(b32 - b64)))
            require(b32.shape == b64.shape and err <= 1e-2 * scale,
                    f"{label} {k}: float32 against float64 max|diff| "
                    f"{err:.3e} > 1e-2 * max|beta| {scale:.3e}")
            rel[k] = err / scale if scale > 0 else 0.0
        for (k, i32), (_, i64) in zip(idx32, idx64):
            require(abs(i32 - i64) <= 1, f"{label} {k}: float32 selects "
                    f"index {i32}, float64 {i64}")
        say(f"[{label}] float64 twin on the card in {wall64:.3f} s, no "
            f"kernel; walls "
            f"{json.dumps({k: round(v, 6) for k, v in out64['walls'].items()})}"
            f"; float32 against float64 max|diff| / max|beta| "
            f"{json.dumps({k: float(f'{v:.3e}') for k, v in rel.items()})}"
            f" (bar 1e-2); selections f32 / f64 "
            f"{[(k, a, b) for (k, a), (_, b) in zip(idx32, idx64)]}")
    return paths, lambda: example_kernel_checks(torch, T, inputs)


# ---------------------------------------------------------------------------
# the processes: four groups of phases run beside the main one
# ---------------------------------------------------------------------------

WORKER_TIMEOUT = 900.0      # seconds a worker may take, start-up included


def cv_group(torch, T):
    """Phases 6, 7, 12 and 24 (the group that ended first without phase
    24).  The launch counts by path, the first stacked screens' shapes,
    which phase 23 checks the fold kernels at, and, as ``timed``, the
    kernels' checks at the examples' inputs."""
    paths = {}
    with timed_phase("sgl-cv"):
        paths["sgl-cv"], snf_shape = sgl_cv_phase(torch, T)
    with timed_phase("nn-cv"):
        paths["nn-cv"], dsf_shape = nn_cv_phase(torch, T)
    with timed_phase("gapsafe-nn-cv"):
        paths["nn-cv-gapsafe"] = gapsafe_nn_cv_phase(torch, T)
    with timed_phase("examples"):
        ex_paths, ex_checks = examples_phase(torch, T)
    paths.update(ex_paths)
    return dict(paths=paths, shapes=dict(snf=snf_shape, dsf=dsf_shape),
                timed=ex_checks)


def selection_group(torch, T):
    """Phases 9, 10, 13 and 15, then phase 21's part (x)."""
    paths = {}
    with timed_phase("weights"):
        for label, c in weights_phase(torch, T).items():
            paths[f"synthetic1-{label}-path"] = c
    with timed_phase("gapsafe-nn"):
        paths["table3-nn-gapsafe-path"] = gapsafe_nn_path_phase(torch, T)
    with timed_phase("logistic"):
        paths["logistic-gapsafe-path"] = logistic_phase(torch, T)
    with timed_phase("refine"):
        for label, c in refine_phase(torch, T).items():
            paths[f"session-{label}"] = c
    with timed_phase("lm-tpx"):
        lm_tp_phase(torch, TPX_PARTS, "lm-tpx")
    return dict(paths=paths)


def serving_group(torch, T):
    """Phases 11 and 16-18."""
    paths = {}
    with timed_phase("gapsafe-sgl-cv"):
        paths["sgl-cv-gapsafe"] = gapsafe_sgl_cv_phase(torch, T)
    with timed_phase("stability"):
        paths["stability"] = stability_phase(torch, T)
    with timed_phase("estimators"):
        for label, c in estimators_phase(torch, T).items():
            paths[f"estimator-{label}"] = c
    with timed_phase("serving"):
        paths["serving"] = serving_phase(torch, T)
    return dict(paths=paths)


def lm_group(torch, T):
    """Phases 21 and 22.  The curves' launch counts, by path, and, as
    ``timed``, the kernels' checks at the curves' shapes."""
    with timed_phase("lm"):
        paths, checks, peaks = lm_phase(torch, T)
    with timed_phase("audits"):
        audits_phase(torch, T, peaks)
    return dict(paths=paths, timed=checks)


WORKERS = {"cv": cv_group, "selection": selection_group,
           "serving": serving_group, "lm": lm_group}
AUDITED = ("cv", "selection", "serving")     # the groups that run sessions


def worker_main(torch, T, name, out, *flags):
    """``python3 chip_smoke.py --worker NAME OUT [--wait]``: the group
    ``NAME`` in this process, its sessions audited, its results written to
    ``OUT``.  A group's ``timed`` function (kernel timings) runs last and
    puts its rows under ``checks``; with ``--wait`` it first writes
    ``OUT.ready`` and waits for ``OUT.go``, which ``Workers.join`` writes
    once the card is otherwise idle."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()                  # built by the main process: loads it
    audit = KeyAudit(T) if name in AUDITED else None
    with timed_phase(f"worker-{name}"):
        result = WORKERS[name](torch, T)
        if audit is not None:
            audit_sessions(audit)
    timed = result.pop("timed", None)
    if timed is not None:
        if "--wait" in flags:
            Path(out + ".ready").touch()
            t0 = time.perf_counter()
            while not Path(out + ".go").exists():
                require(time.perf_counter() - t0 < WORKER_TIMEOUT,
                        f"worker {name}: no turn on the card")
                time.sleep(0.2)
        with timed_phase(f"worker-{name}-kernels"):
            result["checks"] = timed()
    Path(out).write_text(json.dumps(result))
    return 0


class Workers:
    """The groups of ``WORKERS``, each in a process of its own beside this
    one (``worker_main --wait`` in a new session, its output to a log under
    ``build/``).  The card is shared as the ranks of phases 19-21 share it.
    ``join`` waits until every worker has ended or waits for its turn to
    time kernels, gives the waiting ones their turns one at a time, prints
    each log, requires exit 0 and returns the results by group.  Leaving
    the block kills every worker still running, with the processes it
    started, and prints their logs."""

    def __enter__(self):
        import tempfile
        (ROOT / "build").mkdir(exist_ok=True)
        self.tmp = tempfile.TemporaryDirectory(prefix="workers_",
                                               dir=ROOT / "build")
        self.t0 = time.perf_counter()
        self.procs = {}
        for name in WORKERS:
            log = open(self._file(name, "log"), "w")
            self.procs[name] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--worker",
                 name, str(self._file(name, "json")), "--wait"], stdout=log,
                stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL, cwd=ROOT,
                start_new_session=True)
            log.close()
        return self

    def _file(self, name, ext):
        return Path(self.tmp.name) / f"{name}.{ext}"

    def _print_log(self, name, rc):
        say(f"[worker {name}] exit {rc}, {time.perf_counter() - self.t0:.3f}"
            f" s after the workers started; its output:")
        say(self._file(name, "log").read_text(errors="replace").rstrip())
        say(f"[worker {name}] end of its output")

    def join(self):
        deadline = self.t0 + WORKER_TIMEOUT
        while any(p.poll() is None and not
                  self._file(name, "json.ready").exists()
                  for name, p in self.procs.items()):
            require(time.perf_counter() < deadline, f"workers still running "
                    f"after {WORKER_TIMEOUT} s")
            time.sleep(0.2)
        results = {}
        for name in list(self.procs):
            p = self.procs[name]
            if p.poll() is None:             # its turn on the card
                self._file(name, "json.go").touch()
                try:
                    p.wait(timeout=max(deadline - time.perf_counter(), 0.0))
                except subprocess.TimeoutExpired:
                    require(False, f"worker {name} still running after "
                            f"{WORKER_TIMEOUT} s")
            del self.procs[name]
            self._print_log(name, p.returncode)
            require(p.returncode == 0, f"worker {name} exited "
                    f"{p.returncode}")
            results[name] = json.loads(self._file(name, "json").read_text())
        return results

    def __exit__(self, *exc):
        import os
        import signal
        for name, p in self.procs.items():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
            self._print_log(name, p.returncode)
        self.tmp.cleanup()
        return False


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch.core as T
    if sys.argv[1:2] == ["--worker"]:
        return worker_main(torch, T, *sys.argv[2:])
    if sys.argv[1:2] == ["--capacity"]:
        return capacity_run(torch, T, sys.argv[2])

    card = environment(torch)
    build_kernels()
    new_paths = {}
    with Workers() as workers:
        audit = KeyAudit(T)      # records every session of this process
        with timed_phase("synthetic1"):
            sess, res, counts, shapes, res64 = main_path(torch, T)
        with timed_phase("table2"):
            sess_r, res_r, counts_r, ragged_bucket = ragged_path(torch, T)
        with timed_phase("table3-nn"):
            counts_nn, res_nn64 = nn_path(torch, T)
        with timed_phase("gapsafe-sgl"):
            new_paths["synthetic1-gapsafe-path"] = gapsafe_path_phase(
                torch, T, res)
        with timed_phase("legacy"):
            legacy = legacy_phase(torch, T, res64, res_nn64)
        new_paths["synthetic1-legacy-path"] = legacy["sgl"]
        new_paths["table3-nn-legacy-path"] = legacy["nn"]
        with timed_phase("feature-shards"):
            sharded, time_sharded = feature_shard_phase(torch, T, res64)
        new_paths.update(sharded)
        with timed_phase("fold-mesh"):
            new_paths.update(fold_mesh_phase(torch, T, card))
        with timed_phase("audit"):
            audit_sessions(audit)
            audit_kernels()
        with timed_phase("workers"):
            done = workers.join()
    for name in WORKERS:
        new_paths.update(done[name]["paths"])
    shapes_cv = done["cv"]["shapes"]
    with timed_phase("kernels"):             # alone on the card
        sharded_checks = time_sharded()
        rows = kernel_checks(torch, T, sess, shapes, sess_r, ragged_bucket,
                             shapes_cv["snf"], shapes_cv["dsf"])
    for name, by_input in sharded_checks.items():
        rows[name]["sharded"] = by_input     # at the sharded route's inputs
    for group in ("lm", "cv"):    # at the pruning curves', examples' inputs
        for name, by_input in done[group]["checks"].items():
            rows[name].update(by_input)

    by_path = {"synthetic1-path": counts, "table2-path": counts_r,
               "table3-nn-path": counts_nn, **new_paths}
    own = {"screen_norms_folds": new_paths["sgl-cv"],
           "dpc_screen_folds": new_paths["nn-cv"]}   # else the main path's
    kernels = []
    for name, row in rows.items():
        src, replaces = SOURCES[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=own.get(name, counts)[name],
            launches_ragged=counts_r[name],
            launches_by_path={k: v[name] for k, v in by_path.items()},
            max_err=row["max_abs_err"], **row))
    say(f"[card] {card} (every time above was taken on this card)")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
