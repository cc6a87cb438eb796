#!/usr/bin/env python3
"""Drive the PyTorch port's CSR-k, SELL-C-σ, segmented-sum and DIA/CSR-hybrid paths,
the ELL baseline path, the serving engine, the distributed layer, the LM
tree's serving and training paths, one-device and sharded, and the LM
tree's shape cells at their lengths, on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together; sm_90a);
2. print the card's name and power limit (``nvidia-smi``);
3. hold the kernel against its plain PyTorch version on a small suite matrix:
   f32/bf16/int8 x B in {1, 8} x monolithic/bucketed layouts, within the
   per-row bound |y - y_plain| <= (2 k_i + 2) eps32 (|A| |x|)_i, with repeat
   launches bit-equal, column j of a B=8 launch bit-equal to a B=1 launch
   and every launch bit-equal to ``ref.csrk_tile_rows_in_order`` (each row's
   f32 products added from +0 in slot order);
4. run the main path at the paper's size of ecology1 (1M rows, 5M nnz):
   ``prepare(format="auto")`` under the default device model ``"h100"``
   (its params logged) -> ``apply_original`` against a plain CSR
   product -> the kernel bit-equal to ``ref.csrk_tile_rows_in_order`` at
   B = 1 and 8 -> CG and 8-column block CG to a true relative residual
   <= 1e-4 (logged beside the 129 and 133 iterations and the 9.855e-06
   residual of the earlier kernel under ``"ampere"``, whose sums were the
   same), counting kernel launches; then the ``"ampere"`` container built
   from the same Band-k permutation (``prepare(Ar, "ampere",
   reorder="natural")`` on the permuted matrix), whose ``apply_original``
   must give the same bits at B = 1 and 8 on every row no remainder
   touches (the kernel sums a row in slot order whatever the tile);
5. time the kernel, its plain version and ``torch.sparse`` CSR (cuSPARSE
   with int32 indices, the yardstick; the port never calls it) at the
   ecology1 shapes, as device time from CUDA-graph replays between CUDA
   events, beside the memory-bound least time, with the achieved GB/s and
   the time as a multiple of the bound and of cuSPARSE (f32 at the same B
   for every value type); the eager per-call time (host overhead included)
   is logged; and the ``"h100"`` and ``"ampere"`` containers at f32, B = 1
   and 8, timed in turns (h100, ampere, ampere, h100) beside cuSPARSE;
6. SELL-C-σ kernel against its plain version on bmwcra_1 at 1/64 and on a
   Pareto matrix with empty rows and m not a multiple of C: f32/bf16/int8 x
   B in {1, 8}, within the same per-row bound, repeat launches and B=8
   columns bit-equal;
7. the SELL-C-σ path at the paper's size of bmwcra_1 (147,456 rows, 11.7M
   nnz): ``prepare(format="auto")`` must route to "sellcs";
   ``apply_original`` against a plain CSR product; 40 Jacobi sweeps for 1
   and for 8 right-hand sides to a true relative residual <= 1e-5
   (bmwcra_1's values are not symmetric, but it is strictly diagonally
   dominant), counting kernel launches;
8. time the SELL-C-σ kernel, its plain version and cuSPARSE at the bmwcra_1
   shapes, as in phase 5 (GB/s, x bound and x cuSPARSE logged as there);
9. segmented-sum kernel against its plain versions (``ref.spmv_segsum``,
   and ``ref.segsum_table_rows``, which reads the segment-start table the
   kernel reads in place of ``local_seg``) on powerlaw_zipf(2048) at 128-
   and 512-slot chunks, on a matrix whose first and last rows are empty, on
   a row that spans three chunks (which must come out exactly) and on a row
   that spans 40: f32/bf16/int8 x B in {1, 8}, within the same per-row
   bound, repeat launches and B=8 columns bit-equal, empty rows 0 in an
   output filled with NaN before the call, and with unit values the row
   lengths exactly;
10. the segmented-sum path at powerlaw_zipf's full size (262,144 rows,
    32.6M nnz): ``prepare(format="auto")`` must route to "segsum";
    ``apply_original`` against a plain CSR product at B=1 and B=8; 50 sweeps
    of power iteration and of 8-column block power iteration, whose last
    products through the operator must agree with a float64 CSR product
    within the bound (their values have random signs, so the iterations
    need not converge), counting kernel launches;
11. at the powerlaw_zipf shapes, check that unit values give the row
    lengths exactly, then time the segmented-sum kernel, its plain version
    and cuSPARSE as in phase 5; log the bytes the kernel is modeled to read
    (its loads counted) beside the least bytes and the earlier kernel's,
    which read ``local_seg``, and the split of a call between the chunk pass
    and the carry pass (``torch.profiler``);
12. DIA/CSR-hybrid kernel against its plain versions (``ref.spmv_diahybrid``,
    and ``ref.diahybrid_list_rows``, which finds the remainder through the
    row list the kernel reads) on stencil_fringe(48), (64) and (47) (m % 4
    = 1), a 130x200 matrix with offsets {0, 40} and remainder entries at
    columns 0 and 199, a pure plane (a 9-point grid), a pure remainder (no
    dense diagonal), remainder rows of 1, 2, 31, 32, 33, 64 and 129 entries
    at mask-word edges and the last row with m % 4 = 0, 1, 2 and 3, three
    long remainder rows (32 lanes a row), every row listed (with and
    without a plane) and 71 diagonals: f32/bf16
    x B in {1, 8}, within the same per-row bound, repeat launches and B=8
    columns bit-equal, every row written into an output filled with NaN; the
    8x8 integer hand case exactly; and with an inf, a -inf and a NaN in x,
    NaN and inf in the same places as the plain version;
13. the DIA/CSR-hybrid path at stencil_fringe(side=2048) (4,194,304 rows,
    40.4M nnz): ``prepare(format="auto")`` must route to "diahybrid";
    ``apply_original`` against a plain CSR product at B=1 and B=8; 50 sweeps
    of power iteration and of 8-column block power iteration, whose last
    products through the operator must agree with a float64 CSR product
    within the bound (the matrix is neither symmetric nor diagonally
    dominant, so the iterations need not converge); exactly one CUDA launch
    per SpMV;
14. time the DIA/CSR-hybrid kernel, its plain version and cuSPARSE at the
    stencil_fringe shapes, as in phase 5, beside the plane pass alone (the
    same container with its row list emptied), the bound counting the row
    list the kernel reads, and beside it the bound with the remainder's row
    pointer in its place;
15. ELL kernel against its plain version on bmwcra_1 at 1/64 and on slabs of
    kmax 1, 3, 5, 7, 33, 73, 80 and 129 with m = 1003 (no multiple of any
    block size; rows of an odd kmax are not 16-byte aligned), two slabs cut
    at an explicit kmax, an all-empty matrix and views of ``col_idx`` and
    ``vals`` whose base pointers are off 16-byte boundaries: within the
    per-row bound, a repeat launch bit-equal, every row written into an
    output filled with NaN; with an inf (at x[0], which every padding slot
    reads), a -inf and a NaN in x, NaN and inf in the same rows as the plain
    version, on aligned and unaligned slabs;
16. the ELL path at bmwcra_1's full size, on the matrix phase 7 built:
    ``ell_from_csr`` -> ``to`` -> ``ops.spmv_ell`` against a plain CSR
    product and against the SELL-C-σ route's output within the bound; 40
    Jacobi sweeps through ``ops.spmv_ell`` with phase 7's diagonal and
    right-hand side to a true relative residual <= 1e-5 and within 1e-5 of
    the SELL-C-σ route's iterate; exactly one CUDA launch per SpMV;
17. time the ELL kernel, its plain version and cuSPARSE on bmwcra_1 and on
    phase 13's stencil_fringe(2048) (kmax 73: 7.6x its nnz in slots), as in
    phase 5, beside the SELL-C-σ and DIA kernels' times;
18. print one JSON line describing the five kernels (with what phase 19
    measured of the four route kernels); then the card line and, last,
    ``{"ok": true, "device": {...}}``;
19. (run before the result lines of 18) the serving engine over the four
    route matrices at full size, ecology1, bmwcra_1, powerlaw_zipf and
    stencil_fringe(2048): one ``ServeEngine(max_batch=8)`` prepares each
    inside the step of its first miss (the four routes asserted), serves a
    seeded stream of 512 requests (matrix uniform, width uniform in
    {1, 2, 3}, a step after a submit with probability 0.5, then drain) and a
    burst of 64 ``[n]`` requests per matrix (eight full 8-column batches);
    every result bit-equal to a direct call of the cached operator, 10 per
    matrix within the row bound of the plain CSR product, 4 misses and 4
    prepares, every request completed, each route kernel launched; a warm
    stream of 512 more for requests/s and latency; per route the device time
    of one W=8 dispatch beside the host time of a ``step()`` that makes it
    and beside 8 B=1 launches; then a second engine whose byte budget is one
    under bmwcra_1's and powerlaw_zipf's operators: A, B, A, B at
    ``max_batch=1`` give 4 prepares, 3 evictions and the first engine's bits;
20. (run after 19, before the result lines of 18) the distributed layer,
    D row-block shards on the one card: ecology1/64 built at f32, bf16 and
    int8, sharded at D in {2, 4} (auto, replicated, all-gather, halo
    overlapped and blocking), B = 1 and 8 bit-equal to the single-device
    operator with as many CSR-k launches as the plans schedule; phase 4's
    ecology1 and phase 7's bmwcra_1 operators sharded the same way without a
    second ``prepare``, bit-equal at B = 1 and 8, CG through the D = 4
    ecology1 operator with phase 4's iterations and bits, each sharded
    call's device time (CUDA-graph replay) beside the single-device
    operator's, its launches, the plan's modeled collective bytes and the x
    bytes the executor copies; stencil_fringe(256) (DIA) at D = 4 declining
    to the CSR path (``distributed/tile_decline.diahybrid``) within the row
    bound; ``python -m repro_torch.launch.cg_solver --shards 4`` on the card;
21. (run after 20, before the result lines of 18; the SpMV operators freed
    first) the LM tree's serving path: (a) the ten ``SMOKE_CONFIG``s with
    weights drawn on the CPU from one seed and numpy-seeded inputs, on the
    CPU and on the card at f32 (TF32 off, asserted): forward logits
    (``make_prefill_step``; encode + decode for seamless, ``vlm_prepend``
    for internvl2) and 8 cached decode steps within 1e-4 + 1e-4 |cpu|, and
    the same for four of them at their published counts (kimi-k2's 384
    experts at top-8, llama4-scout's 16 at top-1, internvl2's 256 patches,
    seamless's 1,024 frames);
    (b) full width, random bf16 weights from a seeded generator on the
    card, depth cut only where one card forces it: granite-3-2b, rwkv6-3b
    and seamless-m4t-medium (12 + 12 layers, 1,024 numpy-seeded frames) at
    full depth, jamba-v0.1-52b cut to one 8-layer period (7 mamba, 1
    attention, 4 MoE layers of 16 experts), kimi-k2-1t-a32b to 1 of 61
    layers (384 experts, top-8, shared expert), llama4-scout-17b-a16e to 4
    of 48 (16 experts, top-1, shared expert) and internvl2-76b to 8 of 80
    (256 numpy-seeded patch embeddings ahead of the prompt, counted by the
    cache and every decode index); a prefill of B=4 x P=1536 into the cache
    (the encoder run once first), then G=32 greedy steps through
    ``make_decode_step``, and one full forward over prompt + generated
    tokens: at bf16 their distance, the forward's own distance from f32 and
    the argmax agreement are logged (bf16 rounding over the full depth moves
    the logits as far), the logits must be finite; then the same weights in
    f32 (TF32 off) generate from the same prompts, and every f32 step's
    logits must lie within 2e-3 + 2e-3 |logit| (the reference's own
    tolerance for this identity) of the f32 full forward's, whose argmax
    must be the generated token wherever its top-2 margin exceeds twice
    that, at one position at least; where the prefill or that forward drops
    MoE routings over capacity (logged) the check runs again with
    ``moe_apply``'s capacity factor set so that nothing drops, and holds
    there; a config whose f32 weights would pass 3/4 of the card (kimi-k2)
    has no f32 check and says so; a second bf16 run from the seed gives the
    same tokens;
    (c) prefill ms, decode ms/step, tokens/s and peak allocated memory of
    the second run, each beside its least time (decode: the bf16 weight
    bytes a step reads, routed experts only, over the memory rate, and for
    MoE every expert's too, which a step reads; prefill: 2 x parameters x
    the rows each multiplies over the dense bf16 rate), the peak of the
    whole row, the encoder-decoder's cross-attention K/V share of a step;
    (d)
    ``python -m repro_torch.launch.serve --arch granite-3-2b`` (full config)
    on the card;
22. (run after 21, before the result lines of 18; phase 21's models freed
    first) the LM tree's training path: (a) the ten ``SMOKE_CONFIG``s with
    weights drawn on the CPU from one seed and numpy-seeded tokens, labels
    and frontend inputs, on the CPU and on the card at f32 (TF32 off,
    asserted): the loss, the MoE aux, grad_norm and every gradient leaf of
    ``make_grad_fn`` within 1e-4 max|cpu| + 1e-6; one ``make_train_step``
    with microbatches=2 (loss, grad_norm, lr, aux the same way); and, fed
    the CPU's gradients on both devices, ``compress_grads`` at density 0.05
    (sparse gradients, residuals, ``topk_csr`` indices and ``compress_ratio``
    equal) and ``adamw.apply`` (params and moments within 4 float32 ulps);
    (b) granite-3-2b at full width and depth, bf16, random weights from the
    seed: 8 steps of ``train_with_restart`` at B=4 x S=1536 (past the
    1,024-row kv chunk and no multiple of it), lr 3e-4, warmup 2; every loss
    finite and the last below the first; then 2 steps through
    ``compress_grads`` at density 0.01, ``compress_ratio`` equal to the value
    from the sizes of the reference's stacked leaves, the host and device
    times of ``compress_grads``
    logged; (c) rwkv6-3b at full width cut to 16 of 32 layers, bf16: 3
    ``make_train_step`` steps at B=2 x S=1024, losses finite; (d)
    granite-3-2b at full width in f32
    (TF32 off), B=1 x S=1536, remat on: with g autograd's gradient and
    v = g/|g|, (L(p + eps v) - L(p - eps v)) / 2 eps equals |g| within the
    relative tolerance derived in PERF.md §6, and so along g restricted to
    the embedding and to the attention and MLP of layers 0, 20 and 39,
    each normalised; every gradient leaf is nonzero; (e) the reference's
    restart test on the card (granite smoke, 2 layers, seq_len 64): 20 steps
    straight against 10 + restart + 10 within rtol 1e-4, a ``failure_at``
    run through ``train_with_restart`` (steps 11-12 twice), bf16 leaves
    through a checkpoint bit for bit; (f) for (b) and (c) the median step
    ms after the first, tokens/s, peak allocated memory and the least step
    time (8 N B S flops over the dense bf16 rate, plus 22 bytes a parameter
    of AdamW over the memory rate); (g) seamless-m4t-medium at full width
    and depth, bf16: 3 ``make_train_step`` steps at B=4 x S=1536 against
    1,024 frames a sequence, losses finite and the last below the first,
    step ms, tokens/s, peak and least time as (f); then in f32 (TF32 off)
    at B=1 x S=64 with all 1,024 frames, loss, grad_norm and every gradient
    leaf card against CPU as in (a); (h) ``python -m
    repro_torch.launch.train --arch granite-3-2b --steps 3 --batch 2 --seq
    512`` (full config) on the card;
23. (run after 22, before the result lines of 18) the sharded LM path,
    every shard on the one card: (a) qwen2-7b (2 layers) on data 2 x model
    2, jamba on 2 x 4 and 2 x 2 and rwkv6 on 2 x 2 at smoke width (every
    mixer tensor-parallel where its heads divide), one train step and a
    prefill and decode on card shards against CPU shards at f32 (logits
    within 1e-4 + 1e-4 |cpu|; loss, grad_norm, every averaged gradient leaf
    within 1e-4 max|g| + 1e-6, every updated parameter within 1e-4 of its
    leaf's max where the gradient is outside that bar of 0, else within
    2 lr more: Adam's first step), and ``moe_apply_ep`` alone; (b)
    granite-3-2b at full width and depth, bf16, 3 trainer steps on data 2
    x model 4 from phase 22(b)'s seed and batches (each step's time and the
    host's load average logged), each loss within 1e-2
    of phase 22(b)'s, step ms, peak memory and the pieces' bytes per
    shard beside ``state_bytes_per_device``; (c) the same at f32, 2
    layers, the sharded step against the one-device step (gradients and
    updated leaves as in (a)); (d) one jamba period with expert
    parallelism on data 1 x model 4, attention, MLP, the 7 mamba mixers
    and vocabulary tensor-parallel, params, cache and token rows in
    pieces (the expert leaves kept as their model pieces), phase 21's
    prompts, teacher-forced with phase 21's one-device tokens: at bf16 the
    per-position RMS over the vocabulary of the logits' distance from phase
    21's f32 full forward, rank by rank, at most ``LM_PIECES_RMS`` times one
    device's bf16 decode's, and the argmax the next token wherever phase
    21's top-2 margin exceeds 2 (2e-3 + 2e-3 |logit|) plus twice one
    device's bf16 distance from f32 there (at one position at least, unless
    that distance covers every margin); at f32 every position within 2e-3
    + 2e-3 |logit| of the one-device full forward, and three faults planted
    into the pieces' logits (a position from another, a vocabulary shard's
    block scaled by 1 + 2^-6, a head dropped) each past that bar, the bf16
    bar's readings of them logged; the state bytes of each shard
    equal to the dry run's ``state_bytes_per_device`` for the same
    placement; decode ms/step beside phase 21's, MoE drops; (e) granite
    smoke on 8 data shards, a failure, a rebuild to 6 and a resume from
    the checkpoint, equal within rtol 1e-4 to an uninterrupted 6-shard run
    from that checkpoint; (f) granite-3-2b greedy serving at full width
    on data 2 x model 4, params, cache and token rows in pieces, with
    (d)'s bars against phase 21's granite run, its state bytes per shard
    equal to the dry run's, decode ms/step and the peak beside phase 21's;
    (g) rwkv6-3b at full width on data 2 x model 4, every layer
    tensor-parallel: greedy serving on pieces with (d)'s bars against phase
    21's rwkv6 run, and 2 train steps at phase 22(c)'s depth and B=2 x
    S=1024, the first loss within 1e-2 of phase 22(c)'s; ms a step, peak, kernels and
    device-busy ms of a decode step and of a train step;
24. (run after 23, before the result lines of 18) the dry run and the
    examples: (a) ``launch.dryrun.dryrun_config`` on fake tensors of the
    cells phases 21-23 measured (granite-3-2b decode at B=4 with a
    1,568-row cache and its train step at B=4 x S=1536 on one device, the
    same train step on data 2 x model 4 distinct ``meta`` devices, one
    jamba period's EP decode on data 1 x model 4, granite's decode and
    rwkv6-3b's train step on data 2 x model 4; run in a process of their
    own, started after the build, beside phases 19-23), each predicted term
    printed beside the phase's measured ms and peak; the predicted peak at
    most the measured one, CUDA never initialised in their process, the
    constants ``PEAKS["H100"]``'s and ``HBM_BYTES``
    at most the card's memory; (b) ``python -m repro_torch.launch.dryrun``
    for granite-3-2b and jamba-v0.1-52b at ``decode_32k`` on the 16 x 16
    mesh, started in the background after the build and each exiting 0;
    (c) the three examples on the card at their defaults (``train_lm`` at
    ``--steps 20``), side by side: ``quickstart``'s CSR-k product within
    1e-4 of plain CSR;
25. (run after 24, before the result lines of 18) the reference's shape
    cells (``models/config.py::SHAPES``, every pair of
    ``registry.supported_shapes``) at their lengths, TF32 off; each row
    logs ms, its bound, kernels and device-busy ms (``torch.profiler``),
    the peak allocated beside the resident state counted from the tensors
    (weights, cache, optimizer moments) and the host's load average; only
    batch and depth are cut (``CELL_*``): (a) at smoke width and f32, card
    against CPU within 1e-4 + 1e-4 |cpu|: ``decode_32k`` of every family
    and jamba-v0.1-52b's and rwkv6-3b's ``long_500k``, a cache of 32,768 or
    524,288 rows drawn with numpy from a seed in the reference's layout
    (``cell_ref_cache``) and carried by ``cache_from_reference``, 4 steps
    to the cache's last row, the logits and the caches after it; and
    granite-3-2b's ``train_4k`` gradients at B=1 x S=4,096, remat on, every
    leaf within 1e-4 max|g| + 1e-6; (b) at full width, bf16, for each of
    the ten families (``CELL_SERVE``): the cache's prefill of 32,752
    tokens at B=1 into a 32,768-row cache (after internvl2's 256 patch
    rows; against seamless's encoded frames), 16 greedy steps at B=1 to its
    last row, the cache copied into B rows and 16 steps there (every row
    the same tokens, MoE drops logged), then ``prefill_32k``:
    ``make_prefill_step`` over the prompt and the tokens the steps were
    fed, 32,768 at B=1, its last 16 positions' gap to the steps' logits
    logged and its argmax the generated token wherever its top-2 margin
    exceeds twice that position's gap (at one position at least, but for
    ``CELL_PREFILL_F32_ONLY``); ``train_4k`` (``CELL_TRAIN``): 3
    ``make_train_step`` steps at B=2 x S=4,096, remat on, losses finite and
    falling, and the reckoning of the families over one card logged
    (``CELL_TRAIN_UNFIT``); ``long_500k``: one jamba period and rwkv6-3b
    whole at B=1, a 524,288-row cache and states drawn on the card from a
    seed, 16 greedy steps from index 524,272, finite logits; (c)
    (``CELL_F32``) granite-3-2b and rwkv6-3b at 4 of their layers in f32:
    a cached prefill into a 32,768-row cache, the steps to row 32,767, each
    within 2e-3 + 2e-3 |logit| of the uncached forward over the same 32,768
    tokens, the argmax as in phase 21.

26. (run after 5) the fit tool, ``repro_torch.launch.fit_device_model``,
    on the card with ``--quick`` at scale 256 (ids 1, 9, 12, 16: every
    candidate within the row bound of the plain CSR product, timed with
    the CSR-k kernel), its per-matrix table logged and its JSON read back
    through ``tuner.load_fitted_device_model(path, "h100")``.

bf16 x, inside the phases above (each kernel reads a bf16 x, sums in f32
and writes y in bf16, rounded once):

(a) in 3, 6, 9, 12 and 15, each kernel on the same small matrices at bf16
    x with f32 and bf16 values (and int8 where the route takes it), B = 1
    and 8 (ELL: 1): y bf16; every row within ``(r_i 2^-8 + (2 k_i + 2)
    eps32) (|A| |x|)_i`` of a float64 product of the same bf16 x and
    dequantised values (r_i = 1, ``FOLD_ROUNDINGS`` on a CSR-k row the ops
    layer folds a remainder into in bf16: phase 3 adds the 64x1024 matrix
    whose far entries ride the remainder) and within ``(k_i + 2) 2^-7
    (|A| |x|)_i`` of the plain version, which multiplies and sums in bf16;
    repeat launches and the columns of B = 8 bit-equal; CSR-k's tile rows
    bit-equal to ``ref.csrk_tile_rows_in_order``'s bf16 form; segsum, DIA
    and ELL into NaN-filled bf16 output; phase 3 also holds ``spmm_width=8``
    padding to each bf16 column's lone launch;
(b) in 4, 7, 10, 13 and 16, each route's operator (``apply_original``; the
    ELL path at B = 1) at bf16 x on its full-size matrix against a float64
    CSR product, every row within the float64 bound, the kernel's launches
    counted from 0 over that run;
(c) in 5, 8, 11, 14 and 17, bf16 x at B = 1 and 8 (ELL: 1, on both of its
    matrices) with f32 values, timed as the f32 cases, beside
    ``torch.sparse`` CSR at bf16 where torch runs it on the card (else
    logged, timing nothing); the bound counts x and y at 2 bytes;
(d) in 19, a fifth of each stream's requests in bf16 x: every result in
    its x's dtype and bit-equal to a direct call, no batch mixing dtypes,
    a float16 x refused unqueued;
(e) in 20, every sharded operator at bf16 x too (B = 1 and 8), bit-equal
    to the single-device operator.

Each kernel's entry in the ``kernels`` line carries a ``bf16_x`` part: its
launches on (b), its worst errors in (a) and (b) and the (c) variants.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
EPS32 = float(np.finfo(np.float32).eps)

#: Memory rate (bytes/s), float32 rate (flop/s, outside the tensor cores)
#: and dense bf16 tensor-core rate (flop/s, no sparsity) of the card, from
#: NVIDIA's data sheets, keyed by a substring of its name; the SXM part's
#: figures are the default.
PEAKS = {"H100 PCIe": (2.0e12, 51e12, 756e12), "H100 NVL": (3.9e12, 60e12, 835e12),
         "H100": (3.35e12, 67e12, 989e12)}
VALUE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}


def log(msg: str) -> None:
    print(msg, flush=True)


def loadavg() -> str:
    """The host's 1, 5 and 15 minute load averages, logged beside host-clock numbers."""
    import os

    return "load average " + ", ".join(f"{v:.2f}" for v in os.getloadavg())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    return PEAKS["H100"]


def time_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device milliseconds of one ``fn()``, without the host's per-call cost.

    ``reps`` calls of ``fn`` are captured in one CUDA graph, which is replayed
    ``iters`` times between two CUDA events.
    """
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def eager_ms(fn, iters: int = 100) -> float:
    """Host-clock milliseconds of one eager ``fn()`` call, synchronised."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def pass_split_ms(fn, iters: int = 20) -> dict:
    """Device milliseconds per ``fn()`` of each CUDA kernel it launches, by
    kernel name, from ``torch.profiler`` over ``iters`` calls; {} where the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None)
        if total is None:
            total = getattr(e, "cuda_time_total", 0)
        if total:
            out[e.key] = total / iters / 1e3
    return out


def row_bound(abs_prod, row_nnz):
    """Per-row tolerance (2 k_i + 2) eps32 (|A| |x|)_i, with a trailing batch axis."""
    k = row_nnz.to(abs_prod.dtype)
    if abs_prod.ndim == 2:
        k = k[:, None]
    return (2 * k + 2) * EPS32 * abs_prod


def check_close(y, y_ref, bound, what: str) -> float:
    import torch

    if y.shape != y_ref.shape or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{what}: shape {tuple(y.shape)} or non-finite output")
    err = (y.double() - y_ref.double()).abs()
    bad = int((err > bound.double()).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} rows outside the rounding bound")
    return float(err.max())


#: bf16 x: one rounding to bf16 (its unit roundoff) and its machine epsilon
BF16_ROUND = 2.0 ** -8
BF16_EPS = 2.0 ** -7
#: bf16 roundings on the path of a CSR-k row the ops layer folds a COO
#: remainder into in y's dtype: the tile row's store, the remainder value's
#: cast, its product, the bf16 sum, the add to y (4 + 1: first order, with
#: a margin for the higher-order terms)
FOLD_ROUNDINGS = 5


def bf16_bounds(abs_prod, row_nnz, folded=None):
    """The two per-row bounds at bf16 x: against a float64 product of the
    same bf16 x and dequantised values, ``(r_i 2^-8 + (2 k_i + 2) eps32)
    (|A| |x|)_i`` (one rounding of an f32 sum, ``r_i`` roundings on a folded
    row); against the plain version, which multiplies and sums in bf16,
    ``(k_i + 2) 2^-7 (|A| |x|)_i``.  ``abs_prod`` is float64, with a
    trailing batch axis where x has one; ``folded`` a bool mask of rows."""
    import torch

    k = row_nnz.to(torch.float64)
    r = torch.ones_like(k)
    if folded is not None:
        r = torch.where(folded, torch.full_like(k, FOLD_ROUNDINGS), r)
    if abs_prod.ndim == 2:
        k, r = k[:, None], r[:, None]
    return ((r * BF16_ROUND + (2 * k + 2) * EPS32) * abs_prod,
            (k + 2) * BF16_EPS * abs_prod)


def bf16x_checks(what, run, plain, abs_plain, n, row_nnz, seed: int, folded=None,
                 batched: bool = True, in_order=None) -> dict:
    """Phase (a) at bf16 x for one kernel path ``run`` (x -> y): at B = 1
    and 8 (1 alone unless ``batched``), y is bf16 and within the float64
    bound of ``plain`` run on the float64 x (which sums in float64) and
    within the plain bound of ``plain`` run on the bf16 x; a repeat launch
    and ``in_order`` (where given) are bit-equal; column j of B = 8 equals
    a B = 1 launch.  ``abs_plain`` gives |A| |x| from a float64 |x|.
    Returns {"f64": worst |err| against float64, "plain": against plain}."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((n, 8), generator=gen, device="cuda").to(torch.bfloat16)
    errs = {"f64": 0.0, "plain": 0.0}
    for B, xb in ((1, X[:, 0].contiguous()), (8, X))[: 2 if batched else 1]:
        y = run(xb)
        if y.dtype != torch.bfloat16:
            raise AssertionError(f"{what} B={B}: y is {y.dtype}, not bfloat16")
        x64 = xb.double()
        b64, b_plain = bf16_bounds(abs_plain(x64.abs()), row_nnz, folded)
        errs["f64"] = max(errs["f64"], check_close(y, plain(x64), b64,
                                                   f"{what} bf16 x B={B} vs float64"))
        errs["plain"] = max(errs["plain"], check_close(y, plain(xb), b_plain,
                                                       f"{what} bf16 x B={B} vs plain"))
        if not torch.equal(y, run(xb)):
            raise AssertionError(f"{what} bf16 x B={B}: repeat launch differs")
        if in_order is not None and not torch.equal(*in_order(xb)):
            raise AssertionError(f"{what} bf16 x B={B}: kernel != in-order plain bits")
    if batched:
        Y8 = run(X)
        for j in range(8):
            if not torch.equal(Y8[:, j], run(X[:, j].contiguous())):
                raise AssertionError(f"{what} bf16 x: column {j} of B=8 != B=1")
    return errs


def bf16x_full(tag, apply, A_dev, seed: int, folded=None, batched: bool = True) -> float:
    """Phase (b): ``apply`` (x in the original index space) at bf16 x, B = 1
    and 8, against a float64 CSR product of A (its f32 values) on the same
    x, every row within the float64 bound.  Returns the worst |err|."""
    import torch

    from repro_torch.sparse import CSRMatrix

    A64 = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.double(), A_dev.shape)
    A_abs = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.double().abs(), A_dev.shape)
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.standard_normal((A_dev.shape[1], 8)).astype(np.float32))
    X = X.cuda().to(torch.bfloat16)
    worst = 0.0
    for B, xb in ((1, X[:, 0].contiguous()), (8, X))[: 2 if batched else 1]:
        y = apply(xb)
        if y.dtype != torch.bfloat16:
            raise AssertionError(f"{tag} bf16 x B={B}: y is {y.dtype}, not bfloat16")
        x64 = xb.double()
        b64, _ = bf16_bounds(csr_product(A_abs, x64.abs()), A_dev.row_lengths(), folded)
        err = check_close(y, csr_product(A64, x64), b64, f"{tag} bf16 x B={B} vs float64 CSR")
        log(f"[{tag}] bf16 x B={B}: y bf16, every row within (r 2^-8 + (2k+2) eps32)|A||x| "
            f"of the float64 CSR product, max |err| {err:.3e}")
        worst = max(worst, err)
    return worst


def library_bf16(csr):
    """``torch.sparse`` CSR of ``csr`` with bf16 values, or None where torch
    does not run a bf16 CSR product on this card (the reason is logged)."""
    import torch

    sp = library_csr(csr)
    sp = torch.sparse_csr_tensor(sp.crow_indices(), sp.col_indices(),
                                 sp.values().to(torch.bfloat16), size=sp.shape,
                                 check_invariants=True)
    try:
        for x in (torch.ones(csr.shape[1], dtype=torch.bfloat16, device="cuda"),
                  torch.ones((csr.shape[1], 8), dtype=torch.bfloat16, device="cuda")):
            sp @ x
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        log(f"[bf16x] torch.sparse CSR at bf16 does not run on this card, timed nothing: "
            f"{str(exc).splitlines()[0]}")
        return None
    return sp


def bf16x_time(tag, xb, kernel, plain, abs_plain, row_nnz, sp16, nbytes, nnz, rates) -> dict:
    """Phase (c): one bf16-x case (f32 values): the kernel path ``kernel``
    checked against ``plain`` on the float64 x within the float64 bound,
    then timed as ``time_variant`` times the others, beside ``torch.sparse``
    CSR at bf16 (``sp16``, None where it does not run).  ``nbytes`` counts x
    and y at 2 bytes."""
    B = 1 if xb.ndim == 1 else int(xb.shape[1])
    x64 = xb.double()
    b64, _ = bf16_bounds(abs_plain(x64.abs()), row_nnz)
    err = check_close(kernel(xb), plain(x64), b64, f"{tag} bf16 x B={B} vs float64")
    rec = time_variant(f"{tag}/bf16x", "f32", B, err, lambda: kernel(xb), lambda: plain(xb),
                       None if sp16 is None else (lambda: sp16 @ xb), nbytes, nnz, rates)
    rec["x_dtype"] = "bf16"
    return rec


def abs_tiles(view):
    """The same tile view with |values| (for the |A| |x| bound)."""
    from repro_torch.sparse import CSRkTileBuckets

    if isinstance(view, CSRkTileBuckets):
        return dataclasses.replace(
            view, buckets=tuple(abs_tiles(b) for b in view.buckets),
            rem_val=view.rem_val.abs())
    return dataclasses.replace(view, vals=view.vals.abs(), rem_val=view.rem_val.abs())


def kernel_vs_plain(views, row_nnz, n, seed: int, what: str):
    """Phase-3 checks for one matrix; returns {(dtype, layout, B): max_abs_err}."""
    import torch

    from repro_torch.kernels import ops, ref

    run = {"monolithic": ops.spmv_csrk, "bucketed": ops.spmv_csrk_bucketed}
    plain = {"monolithic": ref.spmv_csrk_tiles, "bucketed": ref.spmv_csrk_buckets}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs = {}
    for dtype, layouts in views.items():
        X = torch.randn((n, 8), generator=gen, device="cuda")
        Y8 = {}
        for layout, view in layouts.items():
            Y8[layout] = run[layout](view, X)
            for B, xb in ((1, X[:, 0].contiguous()), (8, X)):
                yb = run[layout](view, xb)
                bound = row_bound(plain[layout](abs_tiles(view), xb.abs()), row_nnz)
                errs[(dtype, layout, B)] = check_close(
                    yb, plain[layout](view, xb), bound, f"{what} {dtype} {layout} B={B}")
                if not torch.equal(yb, run[layout](view, xb)):
                    raise AssertionError(f"{what} {dtype} {layout} B={B}: repeat launch differs")
                y_k, y_in_order = csrk_in_order(view, xb)
                if not torch.equal(y_k, y_in_order):
                    raise AssertionError(f"{what} {dtype} {layout} B={B}: kernel != "
                                         f"ref.csrk_tile_rows_in_order bits")
            for j in range(8):
                if not torch.equal(Y8[layout][:, j], run[layout](view, X[:, j].contiguous())):
                    raise AssertionError(f"{what} {dtype} {layout}: column {j} of B=8 != B=1")
        if len(Y8) == 2 and not torch.equal(Y8["monolithic"], Y8["bucketed"]):
            raise AssertionError(f"{what} {dtype}: bucketed != monolithic bits")
    return errs


def csrk_in_order(view, x):
    """The CSR-k kernel's tile rows (no remainder) and
    ``ref.csrk_tile_rows_in_order`` over the same monolithic or bucketed
    view; returns (kernel, plain), rows placed as the kernel places them."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles

    R, W = view.rows_per_tile, view.window
    tail = tuple(x.shape[1:])

    def plain(b):
        return ref.csrk_tile_rows_in_order(b.vals, b.local_col, b.local_row, b.win_block, x,
                                           b.val_scale, rows_per_tile=R, window=W,
                                           tile_nnz=b.tile_nnz)

    if not hasattr(view, "buckets"):
        return spmv_csrk_tiles(view.vals, view.local_col, view.local_row, view.win_block, x,
                               view.val_scale, rows_per_tile=R, window=W,
                               tile_nnz=view.tile_nnz), plain(view)
    y = torch.full((view.num_tiles * R,) + tail, float("nan"), dtype=x.dtype, device=x.device)
    want = torch.full((view.num_tiles, R) + tail, float("nan"), dtype=x.dtype, device=x.device)
    for b, ids in zip(view.buckets, view.tile_ids):
        spmv_csrk_tiles(b.vals, b.local_col, b.local_row, b.win_block, x, b.val_scale,
                        rows_per_tile=R, window=W, tile_nnz=b.tile_nnz, tile_ids=ids, out=y)
        want[ids.long()] = plain(b).view((b.num_tiles, R) + tail)
    return y, want.view_as(y)


def views_for(csrk, dtypes, layouts=("monolithic", "bucketed")):
    from repro_torch.sparse import bucket_tiles, tiles_from_csrk

    out = {}
    for dt in dtypes:
        tiles = tiles_from_csrk(csrk, value_dtype=dt)
        v = {}
        if "monolithic" in layouts:
            v["monolithic"] = tiles.to("cuda")
        if "bucketed" in layouts:
            v["bucketed"] = bucket_tiles(tiles).to("cuda")
        out[dt] = v
    return out


def far_entries_csrk():
    """The port's tests' 64x1024 matrix (a near diagonal and one far entry
    per row) as CSR-k with a 128-column window: every tile's far entries
    ride the COO remainder, which the ops layer folds into y."""
    from repro_torch.sparse import CSRMatrix, build_csrk

    dense = np.zeros((64, 1024), np.float32)
    for i in range(64):
        dense[i, i] = 2.0
        dense[i, 600 + (i * 37) % 400] = 1.0
    return build_csrk(CSRMatrix.fromdense(dense), srs=4, ssrs=2, k=3)


def csrk_bf16x_small(op_small, A_small) -> dict:
    """Phase 3(a): the CSR-k kernel at bf16 x on ecology1/64 and on the
    64x1024 matrix with a remainder, at f32, bf16 and int8 values, both
    layouts (``bf16x_checks``, the tile rows bit-equal to
    ``ref.csrk_tile_rows_in_order``'s bf16 form); then ``PreparedSpMV``
    with ``spmm_width=8``: each column of a zero-padded bf16 block, and a
    bf16 [n] x, give the bits of their lone launch, through ``__call__`` and
    ``apply_original``.  Returns {case: worst errors}."""
    import torch

    from repro_torch.core import prepare
    from repro_torch.kernels import ops, ref
    from repro_torch.sparse import bucket_tiles, tiles_from_csrk

    run = {"monolithic": ops.spmv_csrk, "bucketed": ops.spmv_csrk_bucketed}
    plain = {"monolithic": ref.spmv_csrk_tiles, "bucketed": ref.spmv_csrk_buckets}
    errs = {}
    for name, csrk, kw in (("ecology1/64", op_small.csrk, {}),
                           ("64x1024 remainder", far_entries_csrk(), {"window": 128})):
        row_nnz = csrk.csr.row_lengths().to("cuda")
        for dt in ("f32", "bf16", "int8"):
            tiles = tiles_from_csrk(csrk, value_dtype=dt, **kw)
            folded = torch.zeros(csrk.csr.shape[0], dtype=torch.bool, device="cuda")
            folded[tiles.rem_row.long().to("cuda")] = True
            for layout, view in (("monolithic", tiles.to("cuda")),
                                 ("bucketed", bucket_tiles(tiles).to("cuda"))):
                abs_view = abs_tiles(view)
                errs[(name, dt, layout)] = bf16x_checks(
                    f"{name} {dt} {layout} (remainder {tiles.remainder_nnz})",
                    lambda x: run[layout](view, x), lambda x: plain[layout](view, x),
                    lambda x: plain[layout](abs_view, x), csrk.csr.shape[1], row_nnz, 6,
                    folded=folded, in_order=lambda x: csrk_in_order(view, x))
    op8 = prepare(A_small, device="cuda", format="auto", spmm_width=8)
    gen = torch.Generator(device="cuda").manual_seed(7)
    X = torch.randn((A_small.n, 3), generator=gen, device="cuda").to(torch.bfloat16)
    for call in ("__call__", "apply_original"):
        padded, lone = getattr(op8, call), getattr(op_small, call)
        Y = padded(X)
        for j in range(3):
            xj = X[:, j].contiguous()
            if not (torch.equal(Y[:, j], lone(xj)) and torch.equal(padded(xj), lone(xj))):
                raise AssertionError(f"spmm_width=8 {call}: bf16 column {j} != its lone launch")
        if Y.dtype != torch.bfloat16:
            raise AssertionError(f"spmm_width=8 {call}: y is {Y.dtype}")
    return errs


def time_variant(tag, dt, B, err, run, plain, library, nbytes, nnz, rates,
                 read_bytes=None, yardstick=None) -> dict:
    """Time one (value dtype, B) case: kernel, eager call, plain version and,
    where there is one, the library call; log it and return its record.

    ``nbytes`` is the least the function must move, which sets the bound;
    ``read_bytes``, where given, is what the kernel is modeled to move (its
    loads counted, not measured), if more.  Where
    ``yardstick`` (a dict) is given, the line also logs the time as a
    multiple of the bound and of the library call at this B (the f32 one,
    which ``yardstick`` keeps, for the other value types)."""
    mem_rate, f32_rate = rates
    ms = time_ms(run)
    call_ms = eager_ms(run)
    plain_ms = time_ms(plain, reps=5)
    lib_ms = None if library is None else time_ms(library)
    t_bytes = nbytes / mem_rate * 1e3
    t_ops = 2 * nnz * B / f32_rate * 1e3
    lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
    read_txt = "" if read_bytes is None else (
        f"; modeled kernel reads {read_bytes / 1e6:.1f} MB, "
        f"{read_bytes / ms / 1e6:.0f} GB/s, {read_bytes / mem_rate * 1e3:.4f} ms at the rate")
    ratio_txt = ""
    if yardstick is not None:
        if lib_ms is not None:
            yardstick[B] = lib_ms
        ratio_txt = f"; {ms / max(t_bytes, t_ops):.2f} x bound"
        if B in yardstick:
            ratio_txt += f", {ms / yardstick[B]:.2f} x cuSPARSE f32"
    log(f"[{tag}] {dt:4s} B={B}: kernel {ms:.4f} ms (eager call {call_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, cuSPARSE {lib_txt} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB; "
        f"{nbytes / ms / 1e6:.0f} GB/s achieved{read_txt}{ratio_txt}), max |err| {err:.3e}")
    rec = {
        "value_dtype": dt, "B": B, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "library_ms": lib_ms, "eager_call_ms": call_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes,
    }
    if read_bytes is not None:
        rec["modeled_bytes_read"] = read_bytes
    return rec


def bf16_entry(launches, small_errs, full_err, variants) -> dict:
    """A kernel's bf16-x part of the ``kernels`` line: the wrapper's
    launches on the full-size bf16-x path (phase (b)), the worst |err| of
    the small cases (phase (a)) against float64 and against the plain
    version, and of the full-size run against float64, and the timed
    variants (phase (c), f32 values)."""
    return {
        "launches": launches,
        "max_abs_err_f64": max([full_err] + [e["f64"] for e in small_errs.values()]),
        "max_abs_err_plain": max(e["plain"] for e in small_errs.values()),
        "variants": variants,
    }


def kernel_entry(name, source, replaces, launches, variants, shape,
                 cuda_launches_per_call: int = 1, bf16_x=None) -> dict:
    """One kernel's record of the ``kernels`` line; the headline numbers are
    its first variant's (f32 x and values, B=1).  ``launches`` counts
    wrapper calls, each ``cuda_launches_per_call`` CUDA launches; ``bf16_x``
    is the kernel's bf16-x part (``bf16_entry``)."""
    head = variants[0]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "cuda_launches_per_call": cuda_launches_per_call,
        "max_abs_err": max(v["max_abs_err"] for v in variants),
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": shape,
        "variants": variants,
        "bf16_x": bf16_x,
    }


def library_csr(csr):
    """``torch.sparse`` CSR of ``csr`` (cuSPARSE), with int32 indices as the
    kernels read them; the yardstick only, never called by the port."""
    import torch

    warnings.filterwarnings("ignore", message=".*[Ss]parse CSR tensor support is in beta.*")
    return torch.sparse_csr_tensor(csr.row_ptr.int(), csr.col_idx.int(), csr.vals,
                                   size=csr.shape, check_invariants=True)


def build_all(names):
    """Build every kernel source at once (one nvcc each) and log the reports."""
    from repro_torch.kernels import build

    def timed(name):
        t0 = time.perf_counter()
        lib = build.build(name)
        return lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(timed, names)))
    for name, (lib, secs) in built.items():
        log(f"[build] {name}.cu -> {lib.name} in {secs:.2f} s")
        report = Path(str(lib) + ".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "entry function" in line or "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")


def sell_kernel_vs_plain(views, row_nnz, n, seed: int, what: str):
    """Phase-6 checks for one matrix; returns {(dtype, B): max_abs_err}."""
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs = {}
    for dtype, tiles in views.items():
        X = torch.randn((n, 8), generator=gen, device="cuda")
        abs_view = dataclasses.replace(tiles, vals=tiles.vals.abs())
        for B, xb in ((1, X[:, 0].contiguous()), (8, X)):
            yb = ops.spmv_sellcs(tiles, xb)
            bound = row_bound(ref.spmv_sellcs_tiles(abs_view, xb.abs()), row_nnz)
            errs[(dtype, B)] = check_close(
                yb, ref.spmv_sellcs_tiles(tiles, xb), bound, f"{what} {dtype} B={B}")
            if not torch.equal(yb, ops.spmv_sellcs(tiles, xb)):
                raise AssertionError(f"{what} {dtype} B={B}: repeat launch differs")
        Y8 = ops.spmv_sellcs(tiles, X)
        for j in range(8):
            if not torch.equal(Y8[:, j], ops.spmv_sellcs(tiles, X[:, j].contiguous())):
                raise AssertionError(f"{what} {dtype}: column {j} of B=8 != B=1")
    return errs


def sell_views(sell, dtypes):
    from repro_torch.sparse import tiles_from_sellcs

    return {dt: tiles_from_sellcs(sell, value_dtype=dt).to("cuda") for dt in dtypes}


def csr_diagonal(A):
    """The diagonal of a square CSR matrix, on its device."""
    import torch

    rows = torch.repeat_interleave(
        torch.arange(A.m, device=A.vals.device), A.row_lengths().long())
    on = rows == A.col_idx.long()
    diag = torch.zeros(A.m, dtype=A.vals.dtype, device=A.vals.device)
    diag[rows[on]] = A.vals[on]
    return diag


def sellcs_phases(mem_rate: float, f32_rate: float):
    """Phases 6-8: the SELL-C-σ kernel, its path at bmwcra_1's size, timing.

    Returns the kernel's entry of the ``kernels`` line, and bmwcra_1 with its
    operator, diagonal and one-column right-hand side for the ELL phases.
    """
    import torch

    from repro_torch.configs.spmv_suite import load_suite, pareto_rows
    from repro_torch.core import jacobi_smoother, prepare
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
    from repro_torch.kernels.spmv_sellcs import spmv_sellcs_chunks
    from repro_torch.obs import get_registry
    from repro_torch.sparse import CSRMatrix, sellcs_from_csr

    # 6. kernel vs plain on small matrices; (a) at bf16 x
    t0 = time.perf_counter()
    errs, errs16 = {}, {}
    for name, A_s in (("bmwcra_1/64", load_suite(scale=64, ids=[16])["bmwcra_1"]),
                      ("pareto", pareto_rows(1003, seed=3))):
        sell_s = sellcs_from_csr(A_s)
        views = sell_views(sell_s, ("f32", "bf16", "int8"))
        what = (f"{name} ({A_s.m} rows, widths {int(sell_s.chunk_widths().min())}.."
                f"{int(sell_s.chunk_widths().max())}, W {views['f32'].width})")
        errs.update({(name,) + k: v for k, v in sell_kernel_vs_plain(
            views, A_s.row_lengths().cuda(), A_s.n, 2, what).items()})
        for dt, view in views.items():
            abs_view = dataclasses.replace(view, vals=view.vals.abs())
            errs16[(name, dt)] = bf16x_checks(
                f"{what} {dt}", lambda x: ops.spmv_sellcs(view, x),
                lambda x: ref.spmv_sellcs_tiles(view, x),
                lambda x: ref.spmv_sellcs_tiles(abs_view, x), A_s.n, A_s.row_lengths().cuda(), 6)
    torch.cuda.synchronize()
    log(f"[sellcs/kernel] {len(errs)} cases within bound, repeat launches and B=8 columns "
        f"bit-equal; max |err| {max(errs.values()):.3e}; bf16 x: {len(errs16)} cases (B=1 "
        f"and 8) y bf16 within the float64 and plain bounds, repeat and B=8 columns "
        f"bit-equal, worst |err| {max(e['f64'] for e in errs16.values()):.3e} vs float64 "
        f"({time.perf_counter() - t0:.1f} s)")

    # 7. the SELL-C-σ path at the paper's bmwcra_1 size
    t0 = time.perf_counter()
    A = load_suite(scale=1, ids=[16])["bmwcra_1"]
    log(f"[sellcs/main] bmwcra_1: {A.m} rows, {A.nnz} nnz "
        f"(built in {time.perf_counter() - t0:.1f} s)")
    t_main = time.perf_counter()
    reg = get_registry()
    reg.clear()
    spmv_csrk_tiles.launches = 0
    spmv_sellcs_chunks.launches = 0
    t0 = time.perf_counter()
    op = prepare(A, device="cuda", format="auto")
    t_prep = time.perf_counter() - t0
    if op.backend != "sellcs":
        raise AssertionError(f"bmwcra_1 routed to {op.backend}, expected sellcs")
    if not np.array_equal(op.perm, np.arange(A.m)):
        raise AssertionError("the SELL-C-σ route must not reorder")
    phases = {r["name"]: r["value"] for r in reg.records() if r["section"] == "prepare"}
    log(f"[sellcs/main] prepare {t_prep:.1f} s: " + ", ".join(
        f"{k[6:-3]} {v / 1e3:.2f} s" for k, v in sorted(phases.items())
        if k.startswith("phase.") and k.endswith("_ms")))
    widths, counts = np.unique(op.sell.chunk_widths(), return_counts=True)
    tiles = op.sell_tiles
    log(f"[sellcs/main] stats row_var {op.stats.row_var:.2f}, row_skew "
        f"{op.stats.row_skew:.2f}; C {tiles.C}, sigma {op.sell.sigma}, {tiles.num_chunks} "
        f"chunks, widths " + ", ".join(f"{w} x{c}" for w, c in zip(widths, counts))
        + f"; canonical slots {op.sell.slots}, [T, C, W] view {tiles.vals.numel()} slots "
        f"(W {tiles.width}); modeled_bytes() {op.modeled_bytes()} (prices all W lanes)")
    A_dev = A.to("cuda")
    A64 = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.double(), A_dev.shape)
    A_abs = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.abs(), A_dev.shape)
    row_nnz = A_dev.row_lengths()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(A.n).astype(np.float32)).cuda()
    err = check_close(op.apply_original(x), ref.spmv_csr(A_dev, x),
                      row_bound(ref.spmv_csr(A_abs, x.abs()), row_nnz),
                      "apply_original vs plain CSR")
    log(f"[sellcs/main] apply_original vs plain CSR product: max |err| {err:.3e}")

    # perm is the identity, so op works in the original index space
    diag = csr_diagonal(A_dev)
    sweeps = 40
    X_true = torch.from_numpy(rng.standard_normal((A.n, 8)).astype(np.float32)).cuda()
    b1 = ref.spmv_csr(A_dev, X_true[:, 0].contiguous())
    for label, xt in (("1 rhs", X_true[:, 0].contiguous()), ("8 rhs", X_true)):
        b = ref.spmm_csr(A_dev, xt) if xt.ndim == 2 else b1
        d = diag[:, None] if xt.ndim == 2 else diag
        t0 = time.perf_counter()
        xs = jacobi_smoother(op, d, b, iters=sweeps)
        torch.cuda.synchronize()
        t_j = time.perf_counter() - t0
        r = (b.double() - (ref.spmm_csr(A64, xs.double()) if xt.ndim == 2
                           else ref.spmv_csr(A64, xs.double())))
        true_res = float((torch.linalg.norm(r, dim=0) / torch.linalg.norm(b.double(), dim=0))
                         .max())
        log(f"[sellcs/main] jacobi ({label}): {sweeps} sweeps, worst true relative residual "
            f"{true_res:.3e}, {t_j:.3f} s ({t_j / sweeps * 1e3:.3f} ms/sweep)")
        if not true_res <= 1e-5:
            raise AssertionError(f"jacobi ({label}) did not reach 1e-5 on bmwcra_1")
    launches = spmv_sellcs_chunks.launches
    spmvs = 1 + 2 * sweeps
    log(f"[sellcs/main] phase done in {time.perf_counter() - t_main:.1f} s")
    log(f"[sellcs/main] spmv_sellcs launches on the path: {launches} "
        f"({launches / spmvs:.2f} per SpMV over {spmvs} SpMVs); spmv_csrk_tiles "
        f"launches {spmv_csrk_tiles.launches}")
    if launches == 0:
        raise AssertionError("the SELL-C-σ path never launched its CUDA kernel")
    spmv_sellcs_chunks.launches = 0
    err16 = bf16x_full("sellcs/main", op.apply_original, A_dev, 8)
    bf16_launches = spmv_sellcs_chunks.launches
    log(f"[sellcs/main] bf16 x path: spmv_sellcs launches {bf16_launches}")
    if bf16_launches == 0:
        raise AssertionError("the bf16-x SELL-C-σ path never launched its CUDA kernel")

    # 8. timing at the bmwcra_1 shapes
    t0 = time.perf_counter()
    m, n, nnz = A.m, A.n, A.nnz
    T, m_pad = tiles.num_chunks, op.sell.m_pad
    sp = library_csr(A_dev)
    views = sell_views(op.sell, ("bf16", "int8"))
    views["f32"] = tiles
    # int8 scales the kernel reads: one per 128 real lanes of every real row
    real_rows = (op.sell.row_perm < m).view(T, -1).sum(dim=1).cpu().numpy()
    w_t = op.sell.chunk_widths()
    scale_reads = int((real_rows * -(-w_t // 128)).sum())
    gen = torch.Generator(device="cuda").manual_seed(3)
    variants = []
    yardstick = {}
    for dt in ("f32", "bf16", "int8"):
        view = views[dt]
        abs_view = dataclasses.replace(view, vals=view.vals.abs())
        for B in (1, 8):
            xb = torch.randn((n, B), generator=gen, device="cuda")
            xb = xb[:, 0].contiguous() if B == 1 else xb
            err = check_close(ops.spmv_sellcs(view, xb), ref.spmv_sellcs_tiles(view, xb),
                              row_bound(ref.spmv_sellcs_tiles(abs_view, xb.abs()), row_nnz),
                              f"bmwcra_1 {dt} B={B}")
            # real slots only: values, columns, int8 scales; row_perm and
            # chunk_width once; x and y once per column
            nbytes = (nnz * (VALUE_BYTES[dt] + 4) + (4 * scale_reads if dt == "int8" else 0)
                      + 4 * m_pad + 4 * T + 4 * n * B + 4 * m * B)
            variants.append(time_variant(
                "sellcs/time", dt, B, err, lambda: ops.spmv_sellcs(view, xb),
                lambda: ref.spmv_sellcs_tiles(view, xb),
                (lambda: sp @ xb) if dt == "f32" else None, nbytes, nnz, (mem_rate, f32_rate),
                yardstick=yardstick))
    sp16 = library_bf16(A_dev)
    abs_tiles_ = dataclasses.replace(tiles, vals=tiles.vals.abs())
    bf16_variants = []
    for B in (1, 8):
        xb = torch.randn((n, B), generator=gen, device="cuda").to(torch.bfloat16)
        xb = xb[:, 0].contiguous() if B == 1 else xb
        bf16_variants.append(bf16x_time(
            "sellcs/time", xb, lambda x: ops.spmv_sellcs(tiles, x),
            lambda x: ref.spmv_sellcs_tiles(tiles, x),
            lambda x: ref.spmv_sellcs_tiles(abs_tiles_, x), row_nnz, sp16,
            nnz * (4 + 4) + 4 * m_pad + 4 * T + 2 * n * B + 2 * m * B, nnz,
            (mem_rate, f32_rate)))
    log(f"[sellcs/time] done in {time.perf_counter() - t0:.1f} s")
    entry = kernel_entry(
        "spmv_sellcs", "src/repro_torch/csrc/spmv_sellcs.cu",
        "src/repro/kernels/spmv_sellcs.py:103", launches, variants,
        {"matrix": "bmwcra_1", "m": m, "n": n, "nnz": nnz, "C": tiles.C, "chunks": T,
         "W": tiles.width, "value_dtype": "f32", "B": 1},
        bf16_x=bf16_entry(bf16_launches, errs16, err16, bf16_variants))
    return entry, {"A": A, "A_dev": A_dev, "op": op, "diag": diag, "b": b1}


def segsum_kernel_vs_plain(seg, row_nnz, n, seed: int, what: str):
    """Phase-9 checks for one container; returns {B: max_abs_err}."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmv_segsum import spmv_segsum_chunks

    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((n, 8), generator=gen, device="cuda")
    abs_seg = dataclasses.replace(seg, vals=seg.vals.abs())
    empty = row_nnz == 0
    errs = {}
    for B, xb in ((1, X[:, 0].contiguous()), (8, X)):
        out = torch.full((seg.m,) + tuple(xb.shape[1:]), float("nan"), device="cuda")
        yb = spmv_segsum_chunks(seg.vals, seg.col_idx, seg.seg_row, seg.seg_start, seg.carry,
                                xb, seg.val_scale, m=seg.m, nnz=seg.nnz, out=out)
        if not bool((yb[empty] == 0).all()):
            raise AssertionError(f"{what} B={B}: an empty row is not 0")
        bound = row_bound(ref.spmv_segsum(abs_seg, xb.abs()), row_nnz)
        errs[B] = check_close(yb, ref.spmv_segsum(seg, xb), bound, f"{what} B={B}")
        check_close(yb, ref.segsum_table_rows(seg.vals, seg.col_idx, seg.seg_row, seg.seg_start,
                                              xb, seg.val_scale, m=seg.m, nnz=seg.nnz),
                    bound, f"{what} B={B} vs the table's plain version")
        if not torch.equal(yb, ops.spmv_segsum(seg, xb)):
            raise AssertionError(f"{what} B={B}: repeat launch differs")
    Y8 = ops.spmv_segsum(seg, X)
    for j in range(8):
        if not torch.equal(Y8[:, j], ops.spmv_segsum(seg, X[:, j].contiguous())):
            raise AssertionError(f"{what}: column {j} of B=8 != B=1")
    return errs


def segsum_into_nan(seg, x):
    """The segmented-sum kernel into an output of x's dtype filled with NaN
    before the call: every row, empty ones too, must be written."""
    import torch

    from repro_torch.kernels.spmv_segsum import spmv_segsum_chunks

    out = torch.full((seg.m,) + tuple(x.shape[1:]), float("nan"), dtype=x.dtype,
                     device=x.device)
    return spmv_segsum_chunks(seg.vals, seg.col_idx, seg.seg_row, seg.seg_start, seg.carry, x,
                              seg.val_scale, m=seg.m, nnz=seg.nnz, out=out)


def segsum_pattern_exact(seg, row_nnz, what: str) -> None:
    """Unit values (scale 1 for int8) and ``x[:, j] = j + 1``: y[i, j] must be
    ``(j + 1)·k_i`` bit for bit, at B = 1 and 8.  Every partial sum is an
    integer below 2^24, so a fragment dropped or added twice shows whatever
    the row's tolerance."""
    import torch

    from repro_torch.kernels import ops

    ones = dataclasses.replace(
        seg, vals=torch.ones_like(seg.vals),
        val_scale=None if seg.val_scale is None else torch.ones_like(seg.val_scale))
    X = torch.arange(1, 9, dtype=torch.float32, device="cuda").expand(seg.shape[1], 8)
    X = X.contiguous()
    want = row_nnz.float()[:, None] * X[0]
    for B, xb, wb in ((1, X[:, 0].contiguous(), want[:, 0]), (8, X, want)):
        if not torch.equal(ops.spmv_segsum(ones, xb), wb):
            raise AssertionError(f"{what} B={B}: unit-value product != row lengths")


def csr_product(mat, v):
    """Plain CSR product of ``mat`` with [n] or [n, B] ``v``."""
    from repro_torch.kernels import ref

    return ref.spmm_csr(mat, v) if v.ndim == 2 else ref.spmv_csr(mat, v)


class Recorder:
    """A matvec that passes through to ``op`` and keeps its last input and output."""

    def __init__(self, op):
        self.op = op
        self.last = None

    def __call__(self, v):
        w = self.op(v)
        self.last = (v, w)
        return w


def check_route_products(tag, op, A_dev, seed: int, iters: int = 50) -> int:
    """``apply_original`` at B=1 and B=8 against a plain CSR product, then
    ``iters`` sweeps of power and of 8-column block power iteration whose
    last products through ``op`` must agree with a float64 CSR product
    within the bound (the iterations need not converge).  Returns the
    number of SpMVs made through ``op``."""
    import torch

    from repro_torch.core import block_power_iteration, power_iteration
    from repro_torch.sparse import CSRMatrix

    A64 = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.double(), A_dev.shape)
    A_abs = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.abs(), A_dev.shape)
    row_nnz = A_dev.row_lengths()
    n = A_dev.shape[1]
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32)).cuda()
    for B, xb in ((1, X[:, 0].contiguous()), (8, X)):
        err = check_close(op.apply_original(xb), csr_product(A_dev, xb),
                          row_bound(csr_product(A_abs, xb.abs()), row_nnz),
                          f"apply_original B={B} vs plain CSR")
        log(f"[{tag}] apply_original (B={B}) vs plain CSR product: max |err| {err:.3e}")

    for label, run in (
            ("power_iteration",
             lambda mv: power_iteration(mv, n, iters=iters, device="cuda")),
            ("block_power_iteration (8)",
             lambda mv: block_power_iteration(mv, n, 8, iters=iters, device="cuda"))):
        rec = Recorder(op)
        t0 = time.perf_counter()
        est = run(rec)
        torch.cuda.synchronize()
        t_it = time.perf_counter() - t0
        v, w = rec.last
        err = check_close(w, csr_product(A64, v.double()),
                          row_bound(csr_product(A_abs, v.abs()), row_nnz),
                          f"{label}: last product vs float64 CSR")
        est = est.reshape(-1).double().cpu()
        if not bool(torch.isfinite(est).all()):
            raise AssertionError(f"{label}: non-finite estimate {est.tolist()}")
        log(f"[{tag}] {label}: {iters} sweeps in {t_it:.3f} s "
            f"({t_it / iters * 1e3:.3f} ms/sweep), estimates "
            + ", ".join(f"{e:.6g}" for e in est.tolist())
            + f"; last product vs float64 CSR within bound, max |err| {err:.3e}")
    return 2 + 2 * (iters + 1)


def segsum_phases(mem_rate: float, f32_rate: float):
    """Phases 9-11: the segmented-sum kernel, its path at powerlaw_zipf's
    full size, timing.  Returns the kernel's entry of the ``kernels`` line
    and the matrix (on the host), which the serving phase reuses."""
    import torch

    from repro_torch.configs.spmv_suite import (
        empty_margin_rows, load_adversarial, long_row_matrix, powerlaw_zipf,
        three_chunk_matrix)
    from repro_torch.core import prepare
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
    from repro_torch.kernels.spmv_segsum import spmv_segsum_chunks
    from repro_torch.kernels.spmv_sellcs import spmv_sellcs_chunks
    from repro_torch.obs import get_registry
    from repro_torch.sparse import segsum_from_csr

    # 9. kernel vs plain on small matrices; (a) at bf16 x
    t0 = time.perf_counter()
    errs, errs16 = {}, {}
    cases = (("powerlaw_zipf(2048)", powerlaw_zipf(2048), (128, 512)),
             ("empty margins", empty_margin_rows(300, seed=3), (128, 512)),
             ("three chunks", three_chunk_matrix(), (128,)),
             ("long row", long_row_matrix(), (128,)))
    for name, A_s, chunks in cases:
        row_nnz = A_s.row_lengths().cuda()
        for S in chunks:
            for dt in ("f32", "bf16", "int8"):
                seg = segsum_from_csr(A_s, chunk_slots=S, value_dtype=dt).to("cuda")
                what = (f"{name} ({A_s.m} rows, {int((row_nnz == 0).sum())} empty) "
                        f"S={S} T={seg.num_chunks} R={seg.segs_per_chunk} {dt}")
                errs.update({(name, S, dt, B): e for B, e in segsum_kernel_vs_plain(
                    seg, row_nnz, A_s.n, 4, what).items()})
                segsum_pattern_exact(seg, row_nnz, what)
                errs16[(name, S, dt)] = bf16x_checks(
                    what, lambda x: segsum_into_nan(seg, x), lambda x: ref.spmv_segsum(seg, x),
                    lambda x: ref.spmv_segsum(dataclasses.replace(seg, vals=seg.vals.abs()), x),
                    A_s.n, row_nnz, 6)
    seg = segsum_from_csr(three_chunk_matrix(), chunk_slots=128).to("cuda")
    x = torch.from_numpy((np.arange(512) % 7 + 1).astype(np.float32)).cuda()
    y = ops.spmv_segsum(seg, x).cpu().numpy()
    if seg.num_chunks != 3 or not np.array_equal(y, [1197.0, 0.0, 14.0, 17.0]):
        raise AssertionError(f"three-chunk carry gave {y.tolist()}, expected [1197, 0, 14, 17]")
    torch.cuda.synchronize()
    log(f"[segsum/kernel] {len(errs)} cases within bound, repeat launches and B=8 columns "
        f"bit-equal, empty rows 0 in NaN-filled output, unit-value products exactly the "
        f"row lengths (a row over 40 chunks among them); three-chunk carry exactly "
        f"{y.tolist()}; max |err| {max(errs.values()):.3e}; bf16 x: {len(errs16)} cases (B=1 "
        f"and 8, into NaN-filled bf16 output) y bf16 within the float64 and plain bounds, "
        f"repeat and B=8 columns bit-equal, worst |err| "
        f"{max(e['f64'] for e in errs16.values()):.3e} vs float64 "
        f"({time.perf_counter() - t0:.1f} s)")

    # 10. the segmented-sum path at powerlaw_zipf's full size
    t0 = time.perf_counter()
    A = load_adversarial(scale=1, names=["powerlaw_zipf"])["powerlaw_zipf"]
    lengths = A.row_lengths()
    log(f"[segsum/main] powerlaw_zipf: {A.m} rows, {A.nnz} nnz, {int((lengths == 0).sum())} "
        f"empty rows, longest row {int(lengths.max())} (built in "
        f"{time.perf_counter() - t0:.1f} s)")
    t_main = time.perf_counter()
    reg = get_registry()
    reg.clear()
    spmv_csrk_tiles.launches = 0
    spmv_sellcs_chunks.launches = 0
    spmv_segsum_chunks.launches = 0
    t0 = time.perf_counter()
    op = prepare(A, device="cuda", format="auto")
    t_prep = time.perf_counter() - t0
    if op.backend != "segsum":
        raise AssertionError(f"powerlaw_zipf routed to {op.backend}, expected segsum")
    if not np.array_equal(op.perm, np.arange(A.m)):
        raise AssertionError("the segmented-sum route must not reorder")
    phases = {r["name"]: r["value"] for r in reg.records() if r["section"] == "prepare"}
    log(f"[segsum/main] prepare {t_prep:.1f} s: " + ", ".join(
        f"{k[6:-3]} {v / 1e3:.2f} s" for k, v in sorted(phases.items())
        if k.startswith("phase.") and k.endswith("_ms")))
    seg = op.segsum
    T, S, R = seg.num_chunks, seg.chunk_slots, seg.segs_per_chunk
    real = seg.real_segments()
    sr = seg.seg_row
    last_row = sr.gather(1, torch.from_numpy(real - 1).cuda()[:, None])[:, 0]
    cuts = int((sr[1:, 0] == last_row[:-1]).sum())
    log(f"[segsum/main] stats row_var {op.stats.row_var:.4g}, row_skew "
        f"{op.stats.row_skew:.4g}; T {T} chunks of S {S} slots, R {R} segments per chunk, "
        f"{real.mean():.2f} real on average (max {int(real.max())}); {cuts} of {T - 1} chunk "
        f"boundaries cut a row; modeled_bytes() {op.modeled_bytes()} (prices all T*R "
        f"partials)")
    A_dev = A.to("cuda")
    row_nnz = A_dev.row_lengths()
    spmvs = check_route_products("segsum/main", op, A_dev, seed=2)
    launches = spmv_segsum_chunks.launches
    log(f"[segsum/main] phase done in {time.perf_counter() - t_main:.1f} s")
    log(f"[segsum/main] spmv_segsum launches on the path: {launches} ({launches / spmvs:.2f} "
        f"wrapper calls per SpMV over {spmvs} SpMVs; each call is two CUDA launches, a chunk "
        f"pass and a carry pass); "
        f"spmv_csrk_tiles {spmv_csrk_tiles.launches}, spmv_sellcs {spmv_sellcs_chunks.launches}")
    if launches == 0:
        raise AssertionError("the segmented-sum path never launched its CUDA kernel")
    spmv_segsum_chunks.launches = 0
    err16 = bf16x_full("segsum/main", op.apply_original, A_dev, 9)
    bf16_launches = spmv_segsum_chunks.launches
    log(f"[segsum/main] bf16 x path: spmv_segsum launches {bf16_launches}")
    if bf16_launches == 0:
        raise AssertionError("the bf16-x segmented-sum path never launched its CUDA kernel")

    # 11. timing at the powerlaw_zipf shapes
    t0 = time.perf_counter()
    m, n, nnz = A.m, A.n, A.nnz
    sp = library_csr(A_dev)
    views = {dt: segsum_from_csr(A, value_dtype=dt).to("cuda") for dt in ("bf16", "int8")}
    views["f32"] = seg
    gen = torch.Generator(device="cuda").manual_seed(5)
    n_real = int(real.sum())
    n_carry = int(seg.carry.shape[0])
    variants = []
    for dt in ("f32", "bf16", "int8"):
        view = views[dt]
        segsum_pattern_exact(view, row_nnz, f"powerlaw_zipf {dt}")
        abs_view = dataclasses.replace(view, vals=view.vals.abs())
        for B in (1, 8):
            xb = torch.randn((n, B), generator=gen, device="cuda")
            xb = xb[:, 0].contiguous() if B == 1 else xb
            err = check_close(ops.spmv_segsum(view, xb), ref.spmv_segsum(view, xb),
                              row_bound(ref.spmv_segsum(abs_view, xb.abs()), row_nnz),
                              f"powerlaw_zipf {dt} B={B}")
            # least bytes, real slots only: values and columns, one int8
            # scale per 128 of them; each chunk's L_t + 1 segment offsets and
            # L_t seg_row entries; x and y once per column
            nbytes = (nnz * (VALUE_BYTES[dt] + 4) + (4 * -(-nnz // 128) if dt == "int8" else 0)
                      + 4 * (2 * n_real + T) + 4 * n * B + 4 * m * B)
            # modeled, not measured: every load the kernel issues counted
            # once (x too).  Beyond the least bytes a warp loads three table
            # offsets and two neighbour rows a chunk, writes and reads back
            # two fragment sums a chunk, and the carry pass reads the carry
            # list; the earlier kernel read local_seg, 4 bytes a slot, in
            # place of the offsets
            read_bytes = nbytes + 16 * T + 16 * T * B + 12 * n_carry
            old_bytes = nbytes + 4 * nnz - 4 * (n_real + T)
            rec = time_variant(
                "segsum/time", dt, B, err, lambda: ops.spmv_segsum(view, xb),
                lambda: ref.spmv_segsum(view, xb),
                (lambda: sp @ xb) if dt == "f32" else None, nbytes, nnz, (mem_rate, f32_rate),
                read_bytes=read_bytes)
            split = pass_split_ms(lambda: ops.spmv_segsum(view, xb))
            chunk_ms = sum(v for k, v in split.items() if "segsum_chunk_kernel" in k)
            carry_ms = sum(v for k, v in split.items() if "segsum_carry_kernel" in k)
            rec.update(chunk_pass_ms=chunk_ms or None, carry_pass_ms=carry_ms or None)
            split_txt = (f"chunk pass {chunk_ms:.4f} ms, carry pass {carry_ms:.4f} ms "
                         f"({100 * carry_ms / (chunk_ms + carry_ms):.1f}% of the two; "
                         f"torch.profiler)" if chunk_ms and carry_ms else
                         "pass split not measured (the profiler saw no device time)")
            log(f"[segsum/time] {dt:4s} B={B}: {split_txt}; modeled reads "
                f"{read_bytes / 1e6:.1f} MB against {nbytes / 1e6:.1f} MB least, "
                f"{old_bytes / 1e6:.1f} MB for the earlier kernel, which read local_seg")
            variants.append(rec)
    sp16 = library_bf16(A_dev)
    abs_seg = dataclasses.replace(seg, vals=seg.vals.abs())
    bf16_variants = []
    for B in (1, 8):
        xb = torch.randn((n, B), generator=gen, device="cuda").to(torch.bfloat16)
        xb = xb[:, 0].contiguous() if B == 1 else xb
        bf16_variants.append(bf16x_time(
            "segsum/time", xb, lambda x: ops.spmv_segsum(seg, x),
            lambda x: ref.spmv_segsum(seg, x), lambda x: ref.spmv_segsum(abs_seg, x), row_nnz,
            sp16, nnz * (4 + 4) + 4 * (2 * n_real + T) + 2 * n * B + 2 * m * B, nnz,
            (mem_rate, f32_rate)))
    log(f"[segsum/time] unit-value products exactly the row lengths at full size "
        f"(f32/bf16/int8, B=1 and 8); done in {time.perf_counter() - t0:.1f} s")
    return kernel_entry(
        "spmv_segsum", "src/repro_torch/csrc/spmv_segsum.cu",
        "src/repro/kernels/spmv_segsum.py:101", launches, variants,
        {"matrix": "powerlaw_zipf", "m": m, "n": n, "nnz": nnz, "chunks": T, "S": S, "R": R,
         "value_dtype": "f32", "B": 1},
        cuda_launches_per_call=2 if seg.carry.shape[0] else 1,
        bf16_x=bf16_entry(bf16_launches, errs16, err16, bf16_variants)), A


def abs_dia(d):
    """The same DIA-hybrid container with |values| (for the |A| |x| bound)."""
    return dataclasses.replace(d, diag_vals=d.diag_vals.abs(), remainder=dataclasses.replace(
        d.remainder, vals=d.remainder.vals.abs()))


def dia_kernel_vs_plain(d, row_nnz, seed: int, what: str):
    """Phase-12 checks for one container; returns {B: max_abs_err}."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmv_diahybrid import spmv_diahybrid_rows

    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((d.n, 8), generator=gen, device="cuda")
    r = d.remainder
    errs = {}
    for B, xb in ((1, X[:, 0].contiguous()), (8, X)):
        out = torch.full((d.m,) + tuple(xb.shape[1:]), float("nan"), device="cuda")
        yb = spmv_diahybrid_rows(d.diag_vals, d.offset_vec, d.rem_rows, d.rem_start, d.rem_mask,
                                 r.col_idx, r.vals, xb, m=d.m, n=d.n, out=out)
        bound = row_bound(ref.spmv_diahybrid(abs_dia(d), xb.abs()), row_nnz)
        errs[B] = check_close(yb, ref.spmv_diahybrid(d, xb), bound, f"{what} B={B}")
        check_close(yb, ref.diahybrid_list_rows(
            d.diag_vals, d.offset_vec, d.rem_rows, d.rem_start, d.rem_mask, r.col_idx, r.vals,
            xb, m=d.m, n=d.n), bound, f"{what} B={B} (plain version over the row list)")
        if not torch.equal(yb, ops.spmv_diahybrid(d, xb)):
            raise AssertionError(f"{what} B={B}: repeat launch differs")
    Y8 = ops.spmv_diahybrid(d, X)
    for j in range(8):
        if not torch.equal(Y8[:, j], ops.spmv_diahybrid(d, X[:, j].contiguous())):
            raise AssertionError(f"{what}: column {j} of B=8 != B=1")
    return errs


def dia_into_nan(d, x):
    """The DIA/CSR-hybrid kernel into an output of x's dtype filled with NaN
    before the call: every row must be written."""
    import torch

    from repro_torch.kernels.spmv_diahybrid import spmv_diahybrid_rows

    out = torch.full((d.m,) + tuple(x.shape[1:]), float("nan"), dtype=x.dtype, device=x.device)
    r = d.remainder
    return spmv_diahybrid_rows(d.diag_vals, d.offset_vec, d.rem_rows, d.rem_start, d.rem_mask,
                               r.col_idx, r.vals, x, m=d.m, n=d.n, out=out)


def dia_phases(mem_rate: float, f32_rate: float):
    """Phases 12-14: the DIA/CSR-hybrid kernel, its path at
    stencil_fringe(side=2048), timing.  Returns the kernel's entry of the
    ``kernels`` line and the matrix (on the host), which the ELL timing
    reuses."""
    import torch

    from repro_torch.configs.spmv_suite import (
        dia_fringe_matrix, dia_hand_matrix, dia_rectangular_matrix, grid_laplacian_2d,
        no_dense_diagonal_matrix, stencil_fringe)
    from repro_torch.core import prepare
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
    from repro_torch.kernels.spmv_diahybrid import fringe_lanes, spmv_diahybrid_rows
    from repro_torch.kernels.spmv_segsum import spmv_segsum_chunks
    from repro_torch.kernels.spmv_sellcs import spmv_sellcs_chunks
    from repro_torch.obs import get_registry
    from repro_torch.sparse import diahybrid_from_csr

    # 12. kernel vs plain on small matrices; (a) at bf16 x
    t0 = time.perf_counter()
    errs, errs16 = {}, {}
    # remainder rows of 1..129 entries at mask-word edges and the last row
    lengths = lambda m: dict(zip((0, 31, 32, 33, 63, 64, m - 1),  # noqa: E731
                                 (1, 2, 31, 32, 33, 64, 129)))
    cases = (("stencil_fringe(48)", stencil_fringe(48)),
             ("stencil_fringe(64)", stencil_fringe(64)),
             ("stencil_fringe(47), m % 4 = 1", stencil_fringe(47)),
             ("rectangular 130x200", dia_rectangular_matrix()),
             ("pure plane (9-point grid 24x24)", grid_laplacian_2d(24, 24, stencil=9)),
             ("pure remainder", no_dense_diagonal_matrix()),
             *((f"remainder rows of 1..129 entries, m % 4 = {m % 4}",
                dia_fringe_matrix(m, lengths(m))) for m in (1000, 1001, 1002, 1003)),
             ("three long remainder rows (G = 32)",
              dia_fringe_matrix(1003, {0: 129, 31: 160, 1002: 200}, seed=1)),
             ("every row listed", dia_fringe_matrix(1001, every_row=12, seed=2)),
             ("every row listed, no plane",
              dia_fringe_matrix(333, every_row=3, band=None, seed=3)),
             ("71 diagonals",
              dia_fringe_matrix(1001, {7: 2}, band=35, seed=4)))
    for name, A_s in cases:
        row_nnz = A_s.row_lengths().cuda()
        for dt in ("f32", "bf16"):
            d = diahybrid_from_csr(A_s, value_dtype=dt).to("cuda")
            R = d.rem_rows.numel()
            what = (f"{name} ({A_s.m}x{A_s.n}, {d.n_diag} offsets, remainder "
                    f"{d.remainder.nnz} in {R} rows, G {fringe_lanes(d.remainder.nnz, R)}) {dt}")
            errs.update({(name, dt, B): e for B, e in dia_kernel_vs_plain(
                d, row_nnz, 7, what).items()})
            abs_d = abs_dia(d)
            errs16[(name, dt)] = bf16x_checks(
                what, lambda x: dia_into_nan(d, x), lambda x: ref.spmv_diahybrid(d, x),
                lambda x: ref.spmv_diahybrid(abs_d, x), A_s.n, row_nnz, 6)
    A_h = dia_hand_matrix()
    X = torch.arange(1, 9, dtype=torch.float32)[:, None] * torch.tensor([1.0, -2.0, 3.0])
    want = (A_h.todense().double() @ X.double()).float().cuda()
    X = X.cuda()
    for dt in ("f32", "bf16"):
        d = diahybrid_from_csr(A_h, occupancy=0.7, value_dtype=dt).to("cuda")
        if d.offsets != (-2, 0, 2) or d.remainder.nnz != 1:
            raise AssertionError(f"hand case split as {d.offsets}, {d.remainder.nnz} remainder")
        if not (torch.equal(ops.spmv_diahybrid(d, X), want)
                and torch.equal(ops.spmv_diahybrid(d, X[:, 0].contiguous()), want[:, 0])):
            raise AssertionError(f"hand case {dt}: not exactly the integer product")
    A_f = stencil_fringe(64)
    d = diahybrid_from_csr(A_f).to("cuda")
    bad = torch.tensor([float("inf"), float("-inf"), float("nan")], device="cuda")
    n_bad = {}
    for B in (1, 8):
        xb = torch.randn((A_f.n, B), device="cuda")
        xb[[0, 100, A_f.n - 1]] = bad[:, None]
        xb = xb[:, 0].contiguous() if B == 1 else xb
        for xd in (xb, xb.to(torch.bfloat16)):
            y, yp = ops.spmv_diahybrid(d, xd), ref.spmv_diahybrid(d, xd)
            for test in (torch.isnan, torch.isposinf, torch.isneginf):
                if not torch.equal(test(y), test(yp)):
                    raise AssertionError(f"non-finite {xd.dtype} x, B={B}: {test.__name__} "
                                         f"differs from plain")
        n_bad[B] = (int(torch.isnan(y).sum()), int(torch.isinf(y).sum()))
    torch.cuda.synchronize()
    log(f"[dia/kernel] {len(errs)} cases within bound, repeat launches and B=8 columns "
        f"bit-equal, every row written into NaN-filled output; hand case exact "
        f"(f32/bf16, B=1 and 3); inf/-inf/NaN in x (f32 and bf16): NaN and inf rows equal "
        f"the plain version's (NaN, inf rows at B=1 {n_bad[1]}, B=8 {n_bad[8]}); max |err| "
        f"{max(errs.values()):.3e}; bf16 x: {len(errs16)} cases (B=1 and 8, into NaN-filled "
        f"bf16 output) y bf16 within the float64 and plain bounds, repeat and B=8 columns "
        f"bit-equal, worst |err| {max(e['f64'] for e in errs16.values()):.3e} vs float64 "
        f"({time.perf_counter() - t0:.1f} s)")

    # 13. the DIA/CSR-hybrid path at stencil_fringe(side=2048)
    t0 = time.perf_counter()
    A = stencil_fringe(side=2048)
    lengths = A.row_lengths()
    log(f"[dia/main] stencil_fringe(side=2048): {A.m} rows, {A.nnz} nnz, longest row "
        f"{int(lengths.max())} (built in {time.perf_counter() - t0:.1f} s)")
    t_main = time.perf_counter()
    reg = get_registry()
    reg.clear()
    spmv_csrk_tiles.launches = 0
    spmv_sellcs_chunks.launches = 0
    spmv_segsum_chunks.launches = 0
    spmv_diahybrid_rows.launches = 0
    t0 = time.perf_counter()
    op = prepare(A, device="cuda", format="auto")
    t_prep = time.perf_counter() - t0
    if op.backend != "diahybrid":
        raise AssertionError(f"stencil_fringe routed to {op.backend}, expected diahybrid")
    if not np.array_equal(op.perm, np.arange(A.m)):
        raise AssertionError("the DIA/CSR-hybrid route must not reorder")
    phases = {r["name"]: r["value"] for r in reg.records() if r["section"] == "prepare"}
    log(f"[dia/main] prepare {t_prep:.1f} s: " + ", ".join(
        f"{k[6:-3]} {v / 1e3:.2f} s" for k, v in sorted(phases.items())
        if k.startswith("phase.") and k.endswith("_ms")))
    dia = op.dia
    rem_len = dia.remainder.row_lengths()
    log(f"[dia/main] stats row_var {op.stats.row_var:.4g}, diag_fraction "
        f"{op.stats.diag_fraction:.4f}, row_skew {op.stats.row_skew:.4g}; offsets "
        f"{list(dia.offsets)}; diag_nnz {dia.diag_nnz}, remainder nnz {dia.remainder.nnz} "
        f"in {int((rem_len > 0).sum())} rows (longest {int(rem_len.max())}); value_dtype "
        f"{op.value_dtype}; padding_overhead {op.padding_overhead():.4f}; modeled_bytes() "
        f"{op.modeled_bytes()} (prices one x read per plane slot)")
    A_dev = A.to("cuda")
    row_nnz = A_dev.row_lengths()
    spmvs = check_route_products("dia/main", op, A_dev, seed=3)
    launches = spmv_diahybrid_rows.launches
    log(f"[dia/main] phase done in {time.perf_counter() - t_main:.1f} s")
    log(f"[dia/main] spmv_diahybrid launches on the path: {launches} over {spmvs} SpMVs "
        f"(one CUDA launch each); spmv_csrk_tiles {spmv_csrk_tiles.launches}, spmv_sellcs "
        f"{spmv_sellcs_chunks.launches}, spmv_segsum {spmv_segsum_chunks.launches}")
    if launches != spmvs:
        raise AssertionError(f"the DIA/CSR-hybrid path made {launches} kernel launches for "
                             f"{spmvs} SpMVs, expected one each")
    spmv_diahybrid_rows.launches = 0
    err16 = bf16x_full("dia/main", op.apply_original, A_dev, 10)
    bf16_launches = spmv_diahybrid_rows.launches
    log(f"[dia/main] bf16 x path: spmv_diahybrid launches {bf16_launches} over 2 SpMVs")
    if bf16_launches != 2:
        raise AssertionError(f"the bf16-x DIA/CSR-hybrid path made {bf16_launches} kernel "
                             f"launches for 2 SpMVs, expected one each")

    # 14. timing at the stencil_fringe(2048) shapes
    t0 = time.perf_counter()
    m, n, nnz = A.m, A.n, A.nnz
    sp = library_csr(A_dev)
    views = {"f32": dia, "bf16": diahybrid_from_csr(A, value_dtype="bf16").to("cuda")}
    gen = torch.Generator(device="cuda").manual_seed(8)
    rem_nnz = dia.remainder.nnz
    R = dia.rem_rows.numel()
    variants = []
    for dt in ("f32", "bf16"):
        view = views[dt]
        abs_view = abs_dia(view)
        # the same container with its row list emptied: the plane pass alone
        plane_only = dataclasses.replace(
            view, rem_rows=view.rem_rows[:0], rem_start=view.rem_start[:1],
            rem_mask=torch.zeros_like(view.rem_mask))
        for B in (1, 8):
            xb = torch.randn((n, B), generator=gen, device="cuda")
            xb = xb[:, 0].contiguous() if B == 1 else xb
            err = check_close(ops.spmv_diahybrid(view, xb), ref.spmv_diahybrid(view, xb),
                              row_bound(ref.spmv_diahybrid(abs_view, xb.abs()), row_nnz),
                              f"stencil_fringe(2048) {dt} B={B}")
            # least bytes: the plane once, remainder values and columns, the
            # row list (rows, starts, mask), x and y once per column; the
            # bound with the remainder's row pointer in place of the row list
            # (the layout the kernel no longer reads) in ``row_ptr_bytes``
            nbytes = (view.n_diag * m * VALUE_BYTES[dt] + 8 * rem_nnz + 4 * (2 * R + 1)
                      + 4 * -(-m // 32) + 4 * n * B + 4 * m * B)
            row_ptr_bytes = nbytes - 4 * (2 * R + 1) - 4 * -(-m // 32) + 4 * (m + 1)
            rec = time_variant(
                "dia/time", dt, B, err, lambda: ops.spmv_diahybrid(view, xb),
                lambda: ref.spmv_diahybrid(view, xb),
                (lambda: sp @ xb) if dt == "f32" else None, nbytes, nnz, (mem_rate, f32_rate))
            rec["plane_only_ms"] = time_ms(lambda: ops.spmv_diahybrid(plane_only, xb))
            rec["row_ptr_bytes"] = row_ptr_bytes
            rec["row_ptr_bound_ms"] = row_ptr_bytes / mem_rate * 1e3
            log(f"[dia/time] {dt:4s} B={B}: plane pass alone (row list emptied) "
                f"{rec['plane_only_ms']:.4f} ms beside the full SpMV's {rec['ms']:.4f}; "
                f"bound with the row pointer in place of the row list "
                f"{row_ptr_bytes / 1e6:.1f} MB, {rec['row_ptr_bound_ms']:.4f} ms "
                f"({rec['ms'] / rec['row_ptr_bound_ms']:.2f} x), beside the bound's "
                f"{nbytes / 1e6:.1f} MB, {rec['bound_ms']:.4f} ms")
            variants.append(rec)
    sp16 = library_bf16(A_dev)
    abs_view = abs_dia(dia)
    bf16_variants = []
    for B in (1, 8):
        xb = torch.randn((n, B), generator=gen, device="cuda").to(torch.bfloat16)
        xb = xb[:, 0].contiguous() if B == 1 else xb
        bf16_variants.append(bf16x_time(
            "dia/time", xb, lambda x: ops.spmv_diahybrid(dia, x),
            lambda x: ref.spmv_diahybrid(dia, x), lambda x: ref.spmv_diahybrid(abs_view, x),
            row_nnz, sp16, dia.n_diag * m * 4 + 8 * rem_nnz + 4 * (2 * R + 1)
            + 4 * -(-m // 32) + 2 * n * B + 2 * m * B, nnz, (mem_rate, f32_rate)))
    log(f"[dia/time] done in {time.perf_counter() - t0:.1f} s")
    entry = kernel_entry(
        "spmv_diahybrid", "src/repro_torch/csrc/spmv_diahybrid.cu",
        "src/repro/kernels/spmv_diahybrid.py:84", launches, variants,
        {"matrix": "stencil_fringe(side=2048)", "m": m, "n": n, "nnz": nnz,
         "n_diag": dia.n_diag, "diag_nnz": dia.diag_nnz, "remainder_nnz": rem_nnz,
         "value_dtype": "f32", "B": 1},
        bf16_x=bf16_entry(bf16_launches, errs16, err16, bf16_variants))
    return entry, A


def ell_bound(e, x):
    """Per-row bound over the slab's own slots: (2 k_i + 2) eps32 (|vals| |x[col]|)_i,
    k_i the row's nonzero slots."""
    from repro_torch.kernels import ref

    return row_bound(ref.ell_rows(e.col_idx, e.vals.abs(), x.abs()), (e.vals != 0).sum(dim=1))


def ell_kernel_vs_plain(e, n, seed: int, what: str) -> float:
    """Phase-15 checks for one slab: within the bound of the plain version,
    every row written into NaN-filled output, a repeat launch bit-equal."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.spmv_ell import spmv_ell_rows

    m = e.shape[0]
    x = torch.randn(n, generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    out = torch.full((m,), float("nan"), device="cuda")
    y = spmv_ell_rows(e.col_idx, e.vals, x, m=m, n=n, out=out)
    err = check_close(y, ref.ell_rows(e.col_idx, e.vals, x), ell_bound(e, x), what)
    if not torch.equal(y, spmv_ell_rows(e.col_idx, e.vals, x, m=m, n=n)):
        raise AssertionError(f"{what}: repeat launch differs")
    return err


def ell_into_nan(e, x):
    """The ELL kernel into an output of x's dtype filled with NaN before the
    call: every row must be written."""
    import torch

    from repro_torch.kernels.spmv_ell import spmv_ell_rows

    m = e.shape[0]
    out = torch.full((m,), float("nan"), dtype=x.dtype, device=x.device)
    return spmv_ell_rows(e.col_idx, e.vals, x, m=m, n=x.shape[0], out=out)


def ell_bf16x(e, n, what: str) -> dict:
    """Phase 15(a) for one slab: bf16 x (``bf16x_checks``, vector only)."""
    from repro_torch.kernels import ref

    abs_vals = e.vals.abs()
    return bf16x_checks(what, lambda x: ell_into_nan(e, x),
                        lambda x: ref.ell_rows(e.col_idx, e.vals, x),
                        lambda x: ref.ell_rows(e.col_idx, abs_vals, x), n,
                        (e.vals != 0).sum(dim=1), 6, batched=False)


def shifted(t, by: int):
    """The same values in a view whose base lies ``by`` elements past a fresh
    allocation's: not 16-byte aligned for ``by % 4 != 0``."""
    import torch

    buf = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    view = buf[by:].view(t.shape)
    view.copy_(t)
    return view


def ell_phases(mem_rate: float, f32_rate: float, bmw: dict, fringe, others: dict) -> dict:
    """Phases 15-17: the ELL kernel, the ELL path at bmwcra_1's full size,
    timing on bmwcra_1 and stencil_fringe(2048).  ``bmw`` is what the
    SELL-C-σ phase built, ``fringe`` the DIA phase's matrix (host) and
    ``others`` the other kernels' entries.  Returns the kernel's entry of the
    ``kernels`` line."""
    import torch

    from repro_torch.configs.spmv_suite import ell_width_matrix, load_suite
    from repro_torch.core import jacobi_smoother
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
    from repro_torch.kernels.spmv_diahybrid import spmv_diahybrid_rows
    from repro_torch.kernels.spmv_ell import spmv_ell_rows
    from repro_torch.kernels.spmv_segsum import spmv_segsum_chunks
    from repro_torch.kernels.spmv_sellcs import spmv_sellcs_chunks
    from repro_torch.obs import get_registry
    from repro_torch.sparse import CSRMatrix, ell_from_csr

    # 15. kernel vs plain on small slabs
    t0 = time.perf_counter()
    bmw64 = load_suite(scale=64, ids=[16])["bmwcra_1"]
    widths = {k: ell_width_matrix(1003, 700, k, seed=k) for k in (1, 3, 5, 7, 33, 73, 80, 129)}
    cases = [("bmwcra_1/64", bmw64, None), ("bmwcra_1/64 cut at 50", bmw64, 50)]
    cases += [(f"m 1003, kmax {k}", A_s, None) for k, A_s in widths.items()]
    cases += [("m 1003, kmax 129 cut at 40", widths[129], 40),
              ("all empty 37x20", CSRMatrix.fromdense(np.zeros((37, 20), np.float32)), None)]
    errs, errs16 = {}, {}
    for name, A_s, cut in cases:
        e = ell_from_csr(A_s, cut).to("cuda")
        errs[name] = ell_kernel_vs_plain(e, A_s.n, 10, f"{name} (kmax {e.kmax})")
        e16 = dataclasses.replace(e, vals=e.vals.to(torch.bfloat16))
        errs[name + ", bf16 values"] = ell_kernel_vs_plain(
            e16, A_s.n, 10, f"{name} (kmax {e.kmax}), bf16 values")
        for dt, ed in (("f32", e), ("bf16", e16)):
            errs16[(name, dt)] = ell_bf16x(ed, A_s.n, f"{name} (kmax {e.kmax}) {dt} values")
    # views whose base pointers are off 16-byte boundaries: at one phase
    # (vectors) and at two (slot by slot); rows of kmax 73 start at every phase
    views = {}
    for name, A_s in (("kmax 73", widths[73]), ("kmax 7", widths[7]), ("bmwcra_1/64", bmw64)):
        e = ell_from_csr(A_s).to("cuda")
        for sc, sv in ((1, 1), (2, 2), (0, 3)):
            label = f"{name}, col and vals {sc} and {sv} elements off 16 bytes"
            views[label] = (dataclasses.replace(e, col_idx=shifted(e.col_idx, sc),
                                                vals=shifted(e.vals, sv)), A_s.n)
            errs[label] = ell_kernel_vs_plain(views[label][0], A_s.n, 10, label)
            e16 = dataclasses.replace(e, col_idx=shifted(e.col_idx, sc),
                                      vals=shifted(e.vals.to(torch.bfloat16), sv))
            errs[label + ", bf16 values"] = ell_kernel_vs_plain(
                e16, A_s.n, 10, label + ", bf16 values")
            errs16[(label, "f32")] = ell_bf16x(views[label][0], A_s.n, label)
            errs16[(label, "bf16")] = ell_bf16x(e16, A_s.n, label + ", bf16 values")
    bad = torch.tensor([float("inf"), float("-inf"), float("nan")], device="cuda")
    n_bad = {}
    nonfinite = [(name, ell_from_csr(A_s).to("cuda"), A_s.n) for name, A_s in (
        ("bmwcra_1/64", bmw64), ("kmax 80", widths[80]), ("kmax 73", widths[73]))]
    nonfinite += [(label, e, n) for label, (e, n) in views.items() if "1 and 1" in label]
    for name, e, n in nonfinite:
        x = torch.randn(n, device="cuda")
        x[[0, 100, n - 1]] = bad
        y, yp = ops.spmv_ell(e, x), ref.ell_rows(e.col_idx, e.vals, x)
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(test(y), test(yp)):
                raise AssertionError(f"{name}, non-finite x: {test.__name__} differs from plain")
        n_bad[name] = (int(torch.isnan(y).sum()), int(torch.isinf(y).sum()))
    torch.cuda.synchronize()
    log(f"[ell/kernel] {len(errs)} slabs (kmax 1..129, rows not 16-byte aligned at kmax "
        f"3, 5, 7, 33 and 73, two cut, one all padding, {len(views)} views off 16-byte "
        f"boundaries) within bound, repeat launches bit-equal, every row written into "
        f"NaN-filled output; inf/-inf/NaN in x (inf at x[0]) on aligned and unaligned slabs: "
        f"NaN and inf rows equal the plain version's (NaN, inf rows {n_bad}); max |err| "
        f"{max(errs.values()):.3e} (f32 and bf16 values); bf16 x: {len(errs16)} cases (f32 "
        f"and bf16 values, into NaN-filled bf16 output) y bf16 within the float64 and plain "
        f"bounds, repeat bit-equal, worst |err| {max(e['f64'] for e in errs16.values()):.3e} "
        f"vs float64 ({time.perf_counter() - t0:.1f} s)")

    # 16. the ELL path at bmwcra_1's full size
    A, A_dev, op, diag, b = (bmw[k] for k in ("A", "A_dev", "op", "diag", "b"))
    t0 = time.perf_counter()
    ell_host = ell_from_csr(A)
    t_build = time.perf_counter() - t0
    ell = ell_host.to("cuda")
    slots = ell.vals.numel()
    log(f"[ell/main] bmwcra_1: {A.m} rows, {A.nnz} nnz; ell_from_csr {t_build:.2f} s: kmax "
        f"{ell.kmax}, {slots} slots, padding_overhead {ell_host.padding_overhead():.4f}")
    sweeps = 40
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(A.n).astype(np.float32)).cuda()
    y_sell = op.apply_original(x)
    x_sell = jacobi_smoother(op, diag, b, iters=sweeps)
    A_abs = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.abs(), A_dev.shape)
    A64 = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.double(), A_dev.shape)
    bound = row_bound(ref.spmv_csr(A_abs, x.abs()), A_dev.row_lengths())
    t_main = time.perf_counter()
    reg = get_registry()
    reg.clear()
    for counted in (spmv_csrk_tiles, spmv_sellcs_chunks, spmv_segsum_chunks,
                    spmv_diahybrid_rows, spmv_ell_rows):
        counted.launches = 0
    y = ops.spmv_ell(ell, x)
    err_csr = check_close(y, ref.spmv_csr(A_dev, x), bound, "ELL vs plain CSR")
    err_sell = check_close(y, y_sell, bound, "ELL vs the SELL-C-σ route")
    t0 = time.perf_counter()
    xs = jacobi_smoother(lambda v: ops.spmv_ell(ell, v), diag, b, iters=sweeps)
    torch.cuda.synchronize()
    t_j = time.perf_counter() - t0
    launches = spmv_ell_rows.launches
    other = {f.__name__: f.launches for f in (spmv_csrk_tiles, spmv_sellcs_chunks,
                                              spmv_segsum_chunks, spmv_diahybrid_rows)}
    true_res = float(torch.linalg.norm(b.double() - ref.spmv_csr(A64, xs.double()))
                     / torch.linalg.norm(b.double()))
    vs_sell = float(torch.linalg.norm(xs - x_sell) / torch.linalg.norm(x_sell))
    spmvs = 1 + sweeps
    log(f"[ell/main] spmv_ell vs plain CSR product: max |err| {err_csr:.3e}; vs the SELL-C-σ "
        f"route: max |diff| {err_sell:.3e}")
    log(f"[ell/main] jacobi through ops.spmv_ell: {sweeps} sweeps, true relative residual "
        f"{true_res:.3e}, relative difference from the SELL-C-σ route's iterate "
        f"{vs_sell:.3e}, {t_j:.3f} s ({t_j / sweeps * 1e3:.3f} ms/sweep)")
    log(f"[ell/main] phase done in {time.perf_counter() - t_main:.1f} s; spmv_ell launches on "
        f"the path: {launches} over {spmvs} SpMVs (one CUDA launch each); others {other}")
    if not true_res <= 1e-5 or not vs_sell <= 1e-5:
        raise AssertionError("jacobi through ELL did not match the SELL-C-σ route to 1e-5")
    if launches != spmvs or any(other.values()):
        raise AssertionError(f"the ELL path made {launches} ELL launches for {spmvs} SpMVs "
                             f"and {other} others, expected one ELL launch each")
    spmv_ell_rows.launches = 0
    err16 = bf16x_full("ell/main", lambda v: ops.spmv_ell(ell, v), A_dev, 11, batched=False)
    bf16_launches = spmv_ell_rows.launches
    log(f"[ell/main] bf16 x path: spmv_ell launches {bf16_launches} over 1 SpMV")
    if bf16_launches != 1:
        raise AssertionError(f"the bf16-x ELL path made {bf16_launches} launches for 1 SpMV")

    # 17. timing on bmwcra_1 and stencil_fringe(2048)
    def time_ell(label, A_t, A_t_dev, ell_t):
        xt = torch.randn(A_t.n, generator=torch.Generator(device="cuda").manual_seed(11),
                         device="cuda")
        A_abs_t = CSRMatrix(A_t_dev.row_ptr, A_t_dev.col_idx, A_t_dev.vals.abs(), A_t_dev.shape)
        err = check_close(ops.spmv_ell(ell_t, xt), ref.spmv_csr(A_t_dev, xt),
                          row_bound(ref.spmv_csr(A_abs_t, xt.abs()), A_t_dev.row_lengths()),
                          f"{label} ELL vs plain CSR")
        err = max(err, check_close(ops.spmv_ell(ell_t, xt), ref.ell_rows(
            ell_t.col_idx, ell_t.vals, xt), ell_bound(ell_t, xt), f"{label} ELL vs plain"))
        sp = library_csr(A_t_dev)
        # least bytes: the slab (value and column of every slot, padding
        # included: it is the function's input), x and y once
        slots_t = ell_t.vals.numel()
        nbytes = 8 * slots_t + 4 * A_t.n + 4 * A_t.m
        rec = time_variant(
            "ell/time", "f32", 1, err, lambda: ops.spmv_ell(ell_t, xt),
            lambda: ref.ell_rows(ell_t.col_idx, ell_t.vals, xt), lambda: sp @ xt, nbytes,
            slots_t, (mem_rate, f32_rate))
        rec["matrix"] = label
        beside = others["spmv_sellcs" if label == "bmwcra_1" else "spmv_diahybrid"]
        log(f"[ell/time] {label}: ELL {rec['ms']:.4f} ms beside {beside['name']} "
            f"{beside['ms']:.4f} ms and cuSPARSE {rec['library_ms']:.4f} ms (this run)")
        abs_vals = ell_t.vals.abs()
        rec16 = bf16x_time(
            "ell/time", xt.to(torch.bfloat16), lambda x: ops.spmv_ell(ell_t, x),
            lambda x: ref.ell_rows(ell_t.col_idx, ell_t.vals, x),
            lambda x: ref.ell_rows(ell_t.col_idx, abs_vals, x), (ell_t.vals != 0).sum(dim=1),
            library_bf16(A_t_dev), 8 * slots_t + 2 * A_t.n + 2 * A_t.m, slots_t,
            (mem_rate, f32_rate))
        rec16["matrix"] = label
        return rec, rec16

    t0 = time.perf_counter()
    variants, bf16_variants = (list(r) for r in zip(time_ell("bmwcra_1", A, A_dev, ell)))
    t1 = time.perf_counter()
    ell_f = ell_from_csr(fringe)
    t_build = time.perf_counter() - t1
    log(f"[ell/time] stencil_fringe(2048): {fringe.m} rows, {fringe.nnz} nnz; ell_from_csr "
        f"{t_build:.2f} s: kmax {ell_f.kmax}, {ell_f.vals.numel()} slots "
        f"({ell_f.vals.numel() / fringe.nnz:.2f} x nnz), padding_overhead "
        f"{ell_f.padding_overhead():.4f}, slab {8 * ell_f.vals.numel() / 1e9:.2f} GB")
    # the 2.45 GB slab lives on the card only inside this call
    rec, rec16 = time_ell("stencil_fringe(2048)", fringe, fringe.to("cuda"), ell_f.to("cuda"))
    variants.append(rec)
    bf16_variants.append(rec16)
    del ell_f
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[ell/time] done in {time.perf_counter() - t0:.1f} s")
    return kernel_entry(
        "spmv_ell", "src/repro_torch/csrc/spmv_ell.cu", "src/repro/kernels/spmv_ell.py:29",
        launches, variants,
        {"matrix": "bmwcra_1", "m": A.m, "n": A.n, "nnz": A.nnz, "kmax": ell.kmax,
         "slots": slots, "value_dtype": "f32", "B": 1},
        bf16_x=bf16_entry(bf16_launches, errs16, err16, bf16_variants))


#: the share of bf16 requests in phase 19's streams: the reference's stream
#: test's (tests/test_serve_engine.py)
SERVE_BF16_SHARE = 0.2


def served_close(y, x, op, A, what: str) -> float:
    """One served result against a plain CSR product of the matrix in the
    operator's own order (CSR-k results live in the Band-k order): an f32 x
    within the f32 row bound; a bf16 x within the float64 bound of a float64
    product (``bf16_bounds``)."""
    import torch

    from repro_torch.sparse import CSRMatrix

    mat = op.csr if op.backend == "csrk" else A.to("cuda")
    mat_abs = CSRMatrix(mat.row_ptr, mat.col_idx, mat.vals.abs(), mat.shape)
    if x.dtype != torch.bfloat16:
        return check_close(y, csr_product(mat, x),
                           row_bound(csr_product(mat_abs, x.abs()), mat.row_lengths()), what)
    folded = None
    if op.backend == "csrk" and op.tiles is not None and op.tiles.remainder_nnz:
        folded = torch.zeros(mat.shape[0], dtype=torch.bool, device="cuda")
        folded[op.tiles.rem_row.long()] = True
    x64 = x.double()
    b64, _ = bf16_bounds(csr_product(mat_abs, x64.abs()), mat.row_lengths(), folded)
    mat64 = CSRMatrix(mat.row_ptr, mat.col_idx, mat.vals.double(), mat.shape)
    return check_close(y, csr_product(mat64, x64), b64, what + " (bf16 x, float64 product)")


def serve_phase(fleet: dict) -> dict:
    """Phase 19: the serving engine over the four route matrices at full size.

    ``fleet`` maps a matrix id to (host CSR, the route ``prepare`` must
    give it).  One ``ServeEngine(max_batch=8)`` prepares each on its first
    miss, serves a seeded stream (a fifth of its requests in bf16 x, no batch
    mixing dtypes) and one burst per matrix, and every result is held bit
    for bit against a direct call of the cached operator (a sample also
    within the row bound of the plain CSR product); a float16 x is refused
    before queuing; then a
    second engine with a byte budget one under two operators evicts and
    re-prepares.  Returns, per kernel name, its serving launches and the
    device ms of one W=8 dispatch, for the ``kernels`` line."""
    import torch

    from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
    from repro_torch.kernels.spmv_diahybrid import spmv_diahybrid_rows
    from repro_torch.kernels.spmv_ell import spmv_ell_rows
    from repro_torch.kernels.spmv_segsum import spmv_segsum_chunks
    from repro_torch.kernels.spmv_sellcs import spmv_sellcs_chunks
    from repro_torch.obs import MetricsRegistry, get_registry, using_registry
    from repro_torch.serve import ServeEngine, ServeStats
    from repro_torch.sparse import CSRMatrix

    W = 8
    # each route's kernel wrapper, under its name in the ``kernels`` line
    kernel_of = {"csrk": ("spmv_csrk_tiles", spmv_csrk_tiles),
                 "sellcs": ("spmv_sellcs", spmv_sellcs_chunks),
                 "segsum": ("spmv_segsum", spmv_segsum_chunks),
                 "diahybrid": ("spmv_diahybrid", spmv_diahybrid_rows)}
    counted = dict(kernel_of.values(), spmv_ell=spmv_ell_rows)
    t_phase = time.perf_counter()
    reg = get_registry()
    reg.clear()
    for f in counted.values():
        f.launches = 0
    eng = ServeEngine(max_batch=W, device="cuda", format="auto")
    batch_dtypes = []      # the x dtypes of each batch the scheduler hands out
    next_batch = eng.scheduler.next_batch

    def recording_next_batch(now, flush=False):
        batch = next_batch(now, flush=flush)
        if batch is not None:
            batch_dtypes.append({r.x.dtype for r in batch.requests})
        return batch

    eng.scheduler.next_batch = recording_next_batch
    fp_of = {mid: eng.add_matrix(mid, A) for mid, (A, _) in fleet.items()}
    mid_of = {fp: mid for mid, fp in fp_of.items()}
    mids = list(fleet)
    rng = np.random.default_rng(19)
    gen = torch.Generator(device="cuda").manual_seed(19)
    step_s = {}            # matrix id -> host seconds of the step that prepared it

    def step(flush=False):
        before = eng.cache.prepares
        t0 = time.perf_counter()
        done = eng.step(flush=flush)
        if eng.cache.prepares > before:        # the new operator is the MRU entry
            step_s[mid_of[eng.cache.fingerprints_lru_order()[-1]]] = time.perf_counter() - t0
        return done

    def stream(n_req, stepper):
        """The reference CLI's stream: matrix uniform over the fleet, width
        uniform over {1, 2, 3}, x in bf16 with probability ``SERVE_BF16_SHARE``
        (else f32), a step after a submit with probability 0.5, then drain.
        Returns [(id, x, future)] and the wall seconds."""
        sent = []
        t0 = time.perf_counter()
        for _ in range(n_req):
            mid = mids[rng.integers(len(mids))]
            n, w = fleet[mid][0].n, int(rng.integers(1, 4))
            x = torch.randn((n,) if w == 1 else (n, w), generator=gen, device="cuda")
            if rng.random() < SERVE_BF16_SHARE:
                x = x.to(torch.bfloat16)
            sent.append((mid, x, eng.submit(mid, x)))
            if rng.random() < 0.5:
                stepper()
        while eng.queue_depth:                  # drain(), one step at a time
            stepper(flush=True)
        torch.cuda.synchronize()
        return sent, time.perf_counter() - t0

    # (a)+(b) the cold stream: each matrix prepared inside the step of its first miss
    cold, cold_s = stream(512, step)
    if eng.drain() != 0:
        raise AssertionError("drain after the stream found requests left")
    snap_cold = eng.stats.snapshot()
    log(f"[serve] cold stream: 512 requests in {cold_s:.2f} s "
        f"({512 / cold_s:.1f} req/s, the four prepares included); " + ", ".join(
            f"{k} {v:.4g}" for k, v in snap_cold.items()))

    # the bursts: 64 [n] requests per matrix, eight full 8-column batches each
    bursts = []
    t0 = time.perf_counter()
    for mid in mids:
        n_batches = eng.stats.batches_dispatched
        xs = torch.randn((64, fleet[mid][0].n), generator=gen, device="cuda")
        bursts += [(mid, x, eng.submit(mid, x)) for x in xs]
        eng.drain()
        if eng.stats.batches_dispatched - n_batches != 64 // W:
            raise AssertionError(f"{mid}: a burst of 64 went out in "
                                 f"{eng.stats.batches_dispatched - n_batches} batches")
    torch.cuda.synchronize()
    burst_s = time.perf_counter() - t0
    served = {name: f.launches for name, f in counted.items()}
    log(f"[serve] bursts: 4 x 64 [n] requests in {burst_s:.3f} s ({256 / burst_s:.1f} req/s), "
        f"8 batches of 8 columns each; kernel launches while serving (stream and bursts, "
        f"wrapper calls): {served}")

    # (c) checks: counts first, before any lookup of this phase's own
    c = eng.cache
    if (c.misses, c.prepares, c.evictions) != (4, 4, 0):
        raise AssertionError(f"cache counts misses {c.misses}, prepares {c.prepares}, "
                             f"evictions {c.evictions}; expected 4, 4, 0")
    if eng.stats.requests_completed != eng.stats.requests_submitted or \
            eng.stats.requests_submitted != 512 + 256:
        raise AssertionError(f"completed {eng.stats.requests_completed} of "
                             f"{eng.stats.requests_submitted} submitted, 768 sent")
    if any(served[name] == 0 for name, _ in kernel_of.values()):
        raise AssertionError(f"a route kernel never launched while serving: {served}")
    amort = reg.get("serve", "prepare_amortization")
    prepare_s = sum(r["value"] for r in reg.records()
                    if (r["section"], r["name"]) == ("serve", "prepare_ms")) / 1e3
    hits = c.hits
    ops = {mid: c.get_or_prepare(fleet[mid][0], fp_of[mid])[0] for mid in mids}
    for mid, op in ops.items():
        log(f"[serve] {mid}: prepared by the engine inside a step of {step_s[mid]:.2f} s "
            f"(host; the prepare and that step's dispatch), backend {op.backend}, "
            f"resident_bytes {op.resident_bytes()}")
    if [op.backend for op in ops.values()] != [route for _, route in fleet.values()]:
        raise AssertionError(f"routes {[op.backend for op in ops.values()]}, expected "
                             f"the four routes")
    bad = [(mid, tuple(x.shape), x.dtype) for mid, x, fut in cold + bursts
           if fut.result().dtype != x.dtype or not torch.equal(fut.result(), ops[mid](x))]
    if bad:
        raise AssertionError(f"{len(bad)} served results differ from a direct call: {bad[:4]}")
    mixed = [d for d in batch_dtypes if len(d) != 1]
    if mixed:
        raise AssertionError(f"{len(mixed)} batches mixed x dtypes: {mixed[:4]}")
    n16 = sum(x.dtype == torch.bfloat16 for _, x, _ in cold)
    b16 = sum(d == {torch.bfloat16} for d in batch_dtypes)
    if not n16:
        raise AssertionError("the stream sent no bf16 request")
    worst = {}
    for mid in mids:
        op, A = ops[mid], fleet[mid][0]
        mine = [(x, fut) for m, x, fut in cold + bursts if m == mid]
        mine16 = [(x, fut) for x, fut in mine if x.dtype == torch.bfloat16]
        sample = mine[:8] + mine[-2:] + mine16[:2]
        worst[mid] = max(served_close(fut.result(), x, op, A, f"served {mid} vs plain CSR")
                         for x, fut in sample)
    try:
        eng.submit(mids[0], torch.ones(fleet[mids[0]][0].n, dtype=torch.float16, device="cuda"))
    except TypeError:
        pass
    else:
        raise AssertionError("a float16 x was queued")
    if eng.queue_depth:
        raise AssertionError("the refused float16 request was queued")
    log(f"[serve] checks: all {len(cold) + len(bursts)} results bit-equal to direct calls of "
        f"the cached operators, each in its x's dtype; {n16} of the stream's 512 requests in "
        f"bf16 x ({SERVE_BF16_SHARE:.0%} share asked), {b16} of {len(batch_dtypes)} batches "
        f"bf16, none mixing dtypes; a float16 x refused unqueued; 12 per matrix (2 of them "
        f"bf16) within the row bound of the plain CSR product (float64 for bf16 x; max |err| "
        + ", ".join(f"{m} {e:.3e}" for m, e in worst.items()) + f"); cache "
        f"hits {hits}, misses {c.misses}, prepares {c.prepares}, evictions {c.evictions}; "
        f"prepare_amortization {amort}; serve.prepare {prepare_s:.2f} s in all")
    del cold, bursts

    # the warm stream, on fresh statistics: requests/s and latency with no prepare
    eng.stats = ServeStats()
    warm, warm_s = stream(512, eng.step)
    bad = [mid for mid, x, fut in warm if fut.result().dtype != x.dtype
           or not torch.equal(fut.result(), ops[mid](x))]
    if bad or eng.stats.requests_completed != 512:
        raise AssertionError(f"warm stream: {len(bad)} results differ, "
                             f"{eng.stats.requests_completed} of 512 completed")
    snap = eng.stats.snapshot()
    warm16 = sum(x.dtype == torch.bfloat16 for _, x, _ in warm)
    del warm
    log(f"[serve] warm stream: 512 requests in {warm_s:.3f} s ({512 / warm_s:.1f} req/s); "
        f"latency p50 {snap['latency_p50_ms']:.3f} ms, p95 {snap['latency_p95_ms']:.3f} ms, "
        f"p99 {snap['latency_p99_ms']:.3f} ms (registry on); mean batch columns "
        f"{snap['mean_batch_cols']:.3f} over {int(snap['batches_dispatched'])} batches "
        f"({warm16} requests in bf16 x); all "
        f"bit-equal to direct calls")

    # (e) per route: one W=8 dispatch on the device, and the host time of a step
    out = {}
    for mid in mids:
        op, n = ops[mid], fleet[mid][0].n
        xs = list(torch.randn((W, n), generator=gen, device="cuda"))
        dev_ms = time_ms(lambda: op(torch.cat([x[:, None] for x in xs], dim=1)), reps=10)
        # the dispatch's two parts apart, and another way to build the block
        X8 = torch.cat([x[:, None] for x in xs], dim=1)
        if not torch.equal(torch.stack(xs).T.contiguous(), X8):
            raise AssertionError(f"{mid}: stack-then-transpose differs from torch.cat")
        op_ms = time_ms(lambda: op(X8), reps=10)
        cat_ms = time_ms(lambda: torch.cat([x[:, None] for x in xs], dim=1), reps=10)
        stack_ms = time_ms(lambda: torch.stack(xs).T.contiguous(), reps=10)
        del X8
        one = dataclasses.replace(op, spmm_width=None)
        b1_ms = time_ms(lambda: one(xs[0]), reps=10)
        for f in counted.values():
            f.launches = 0
        for x in xs:
            eng.submit(mid, x)
        eng.step()
        per_dispatch = {k: f.launches for k, f in counted.items() if f.launches}
        host = {}
        for label, registry in (("on", reg), ("off", MetricsRegistry(enabled=False))):
            with using_registry(registry):
                times = []
                for _ in range(20):
                    for x in xs:
                        eng.submit(mid, x)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    eng.step()
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
            host[label] = float(np.median(times)) * 1e3
        name = kernel_of[op.backend][0]
        out[name] = {"serve_launches": served[name], "serve_launches_per_dispatch": per_dispatch,
                     "serve_dispatch_ms": dev_ms, "serve_op_ms": op_ms, "serve_cat_ms": cat_ms,
                     "serve_stack_transpose_ms": stack_ms, "serve_step_host_ms": host["on"],
                     "serve_step_host_ms_registry_off": host["off"], "serve_b1_ms": b1_ms}
        log(f"[serve] {mid} ({op.backend}): one W=8 dispatch {dev_ms:.4f} ms on the device "
            f"(torch.cat and the kernel; CUDA-graph replay between CUDA events: the operator "
            f"call alone {op_ms:.4f}, torch.cat alone {cat_ms:.4f}, a stack-then-transpose of "
            f"the same columns, which the engine does not use, {stack_ms:.4f}) beside a step() "
            f"that dispatches it: {host['on']:.4f} ms host time with the registry on (its sync "
            f"included), {host['off']:.4f} ms with it off (a sync after it); launches per "
            f"dispatch {per_dispatch}; 8 B=1 launches {8 * b1_ms:.4f} ms, so one W=8 dispatch "
            f"takes {dev_ms / (8 * b1_ms):.3f} x their time")
    out["spmv_ell"] = {"serve_launches": served["spmv_ell"]}
    if served["spmv_ell"]:
        raise AssertionError("the ELL kernel launched while serving")

    # (d) eviction at full size: a budget one byte under two operators
    pair = ("bmwcra_1", "powerlaw_zipf")
    budget = sum(ops[mid].resident_bytes() for mid in pair) - 1
    eng2 = ServeEngine(max_batch=1, device="cuda", format="auto", cache_bytes=budget,
                       spmm_width=W)
    for mid in pair:
        eng2.add_matrix(mid, fleet[mid][0])
    t0 = time.perf_counter()
    for mid in pair + pair:
        x = torch.randn(fleet[mid][0].n, generator=gen, device="cuda")
        fut2, fut1 = eng2.submit(mid, x), eng.submit(mid, x)
        eng2.drain()
        eng.drain()
        if not torch.equal(fut2.result(), fut1.result()):
            raise AssertionError(f"eviction run: {mid} differs from the first engine's result")
    c2 = eng2.cache
    if (c2.prepares, c2.evictions) != (4, 3):
        raise AssertionError(f"eviction run: {c2.prepares} prepares, {c2.evictions} "
                             f"evictions; expected 4 and 3")
    log(f"[serve] eviction: budget {budget} bytes (one under bmwcra_1 + powerlaw_zipf); "
        f"A, B, A, B at max_batch 1: prepares {c2.prepares}, evictions {c2.evictions}, "
        f"{time.perf_counter() - t0:.1f} s; results bit-equal to the first engine's")
    del eng2
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[serve] phase done in {time.perf_counter() - t_phase:.1f} s")
    return out


def distributed_phase(A_small, eco: dict, bmw: dict) -> dict:
    """Phase 20: the distributed layer, D row-block shards on the one card.

    ``A_small`` is phase 3's ecology1/64, ``eco`` phase 4's operator with its
    right-hand side, permutation and CG result, ``bmw`` phase 7's bmwcra_1
    and operator.  Every sharded result, at f32 and at bf16 x, is held bit
    for bit against the single-device operator; CG through the D = 4 ecology1 operator must
    repeat phase 4's iterations and bits.  Returns, per kernel name, the
    launches of the sharded runs and the per-call records, for the
    ``kernels`` line."""
    import os

    import torch

    from repro_torch.configs.spmv_suite import stencil_fringe
    from repro_torch.core import cg, prepare
    from repro_torch.core.distributed import shard_prepared
    from repro_torch.kernels import ref
    from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
    from repro_torch.kernels.spmv_sellcs import spmv_sellcs_chunks
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.obs import MetricsRegistry, using_registry
    from repro_torch.sparse import CSRMatrix

    t_phase = time.perf_counter()
    kernels = (spmv_csrk_tiles, spmv_sellcs_chunks)
    configs = (("auto", None), ("replicated", None), ("allgather", None), ("halo", True),
               ("halo", False))
    gen = torch.Generator(device="cuda").manual_seed(20)

    def launches_per_call(op) -> int:
        return sum(len(run) for _, _, run in op._launches)

    def with_bf16(X):
        """B = 1 and 8 at f32 x, then the same columns rounded to bf16."""
        X16 = X.to(torch.bfloat16)
        return X[:, 0].contiguous(), X, X16[:, 0].contiguous(), X16

    def check_bits(op, base, xs, what) -> int:
        """op(x) == base(x) for each x; returns the kernel launches it made."""
        for f in kernels:
            f.launches = 0
        for x in xs:
            y = op(x)
            if y.dtype != x.dtype or not torch.equal(y, base(x)):
                raise AssertionError(f"{what} {x.dtype} B={x.shape[1:] or 1}: sharded != "
                                     f"single-device")
        made = sum(f.launches for f in kernels) - len(xs) * base_launches(base)
        if made != len(xs) * launches_per_call(op):
            raise AssertionError(f"{what}: {made} kernel launches, expected "
                                 f"{len(xs) * launches_per_call(op)}")
        return made

    def base_launches(base) -> int:
        return len(base.tile_buckets.buckets) if base.tile_buckets is not None else 1

    # (a) ecology1/64, built fresh at each value dtype
    t0 = time.perf_counter()
    xs = with_bf16(torch.randn((A_small.n, 8), generator=gen, device="cuda"))
    n_ops = made = 0
    for dt in ("f32", "bf16", "int8"):
        base = prepare(A_small, device="cuda", format="auto", value_dtype=dt)
        for D in (2, 4):
            for strategy, overlap in configs:
                op = shard_prepared(base, make_host_mesh(D), x_strategy=strategy,
                                    A=base.csrk.csr, halo_overlap=overlap)
                made += check_bits(op, base, xs, f"ecology1/64 {dt} D={D} {strategy}/{overlap}")
                n_ops += 1
    torch.cuda.synchronize()
    log(f"[dist/small] ecology1/64 ({A_small.m} rows): {n_ops} sharded operators (f32, bf16, "
        f"int8 x D in {{2, 4}} x auto, replicated, allgather, halo overlapped and blocking), "
        f"B = 1 and 8 at f32 and bf16 x bit-equal to the single-device operator; {made} CSR-k "
        f"kernel launches, "
        f"as many as the plans schedule ({time.perf_counter() - t0:.1f} s)")

    # (b) and (c): the full-size operators of phases 4 and 7
    cases = (("ecology1", eco["op"], eco["op"].csrk.csr, "spmv_csrk_tiles"),
             ("bmwcra_1", bmw["op"], bmw["A"], "spmv_sellcs"))
    inputs = {}
    for name, base, src, _ in cases:
        xs = with_bf16(torch.randn((src.n, 8), generator=gen, device="cuda"))
        inputs[name] = (xs, [base(x) for x in xs])     # before the counts start
    ops = {}
    for f in kernels:
        f.launches = 0
    spmvs = {}
    for name, base, src, _ in cases:
        t0 = time.perf_counter()
        xs, want = inputs[name]
        spmvs[name] = 0
        for D in (2, 4):
            for strategy, overlap in configs:
                reg = MetricsRegistry()
                t1 = time.perf_counter()
                with using_registry(reg):
                    op = shard_prepared(base, make_host_mesh(D), x_strategy=strategy, A=src,
                                        halo_overlap=overlap)
                t_shard = time.perf_counter() - t1
                for x, y in zip(xs, want):
                    if not torch.equal(op(x), y) or y.dtype != x.dtype:
                        raise AssertionError(f"{name} D={D} {strategy}/{overlap} {x.dtype} "
                                             f"B={x.shape[1:] or 1}: sharded != single-device")
                spmvs[name] += len(xs)
                demoted = bool(reg.get("distributed", "halo_demoted_to_allgather"))
                ops[(name, D, strategy, overlap)] = op
                log(f"[dist/{name}] D={D} {strategy}/{overlap} -> {op.x_strategy}"
                    f"{' (halo demoted)' if demoted else ''}, overlap {op.overlap}, Rs "
                    f"{op.rows_per_shard}, H {op.halo}, interior {op.interior_fraction:.4f}, "
                    f"edges {len(op.plan.left_edges)}+{len(op.plan.right_edges)}, "
                    f"{launches_per_call(op)} launches a call; shard_prepared {t_shard:.2f} s; "
                    f"B = 1 and 8 at f32 and bf16 x bit-equal")
        log(f"[dist/{name}] done in {time.perf_counter() - t0:.1f} s")

    # CG through the D = 4 auto ecology1 operator: phase 4's iterations and bits
    sh4 = ops[("ecology1", 4, "auto", None)]
    t0 = time.perf_counter()
    res = cg(sh4, eco["b"][eco["perm"]], tol=1e-5, maxiter=5000)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    spmvs["ecology1"] += 1 + res.iters
    if res.iters != eco["cg"].iters or not torch.equal(res.x, eco["cg"].x):
        raise AssertionError(f"sharded CG: {res.iters} iterations against phase 4's "
                             f"{eco['cg'].iters}, or other bits")
    log(f"[dist/ecology1] cg through the D=4 {sh4.x_strategy} operator: {res.iters} "
        f"iterations, the same bits as phase 4's {eco['cg'].iters}; {t_cg:.2f} s "
        f"({t_cg / max(res.iters, 1) * 1e3:.3f} ms/iter)")
    counts = {f.__name__: f.launches for f in kernels}
    log(f"[dist] kernel launches on the sharded path: {counts} over {spmvs} SpMVs")
    if not all(counts.values()):
        raise AssertionError("a kernel of the sharded path never launched")

    # timing: device ms of one call (CUDA-graph replay) beside the single-device operator
    out = {"spmv_csrk_tiles": {"distributed_launches": counts["spmv_csrk_tiles"],
                               "distributed_spmvs": spmvs["ecology1"], "distributed_calls": []},
           "spmv_sellcs": {"distributed_launches": counts["spmv_sellcs_chunks"],
                           "distributed_spmvs": spmvs["bmwcra_1"], "distributed_calls": []}}
    t0 = time.perf_counter()
    for name, base, src, entry in cases:
        for B in (1, 8):
            xb = torch.randn((src.n, B), generator=gen, device="cuda")
            xb = xb[:, 0].contiguous() if B == 1 else xb
            base_ms = time_ms(lambda: base(xb))
            for (mname, D, strategy, overlap), op in ops.items():
                if mname != name:
                    continue
                ms = time_ms(lambda: op(xb))
                rec = {"matrix": name, "D": D, "requested": strategy, "overlap_requested":
                       overlap, "strategy": op.x_strategy, "overlap": op.overlap, "B": B,
                       "ms": ms, "single_device_ms": base_ms,
                       "launches_per_call": launches_per_call(op),
                       "collective_bytes": op.collective_bytes_per_call(B),
                       "x_copy_bytes": op.x_copy_bytes_per_call(B)}
                out[entry]["distributed_calls"].append(rec)
                log(f"[dist/time] {name} B={B} D={D} {strategy}/{overlap} ({op.x_strategy}, "
                    f"overlap {op.overlap}): {ms:.4f} ms against {base_ms:.4f} single-device "
                    f"({ms / base_ms:.2f} x); {rec['launches_per_call']} launches; modeled "
                    f"collective {rec['collective_bytes'] / 1e6:.3f} MB, x copied "
                    f"{rec['x_copy_bytes'] / 1e6:.3f} MB")
    log(f"[dist/time] done in {time.perf_counter() - t0:.1f} s")
    del ops, sh4

    # (d) a declining backend: stencil_fringe(256) through the DIA route at D = 4
    F = stencil_fringe(256).to("cuda")
    reg = MetricsRegistry()
    with using_registry(reg):
        base = prepare(F, device="cuda", format="auto")
        op = prepare(F, device="cuda", format="auto", mesh=make_host_mesh(4))
    if base.backend != "diahybrid" or reg.get("distributed", "tile_decline.diahybrid") != 1:
        raise AssertionError(f"stencil_fringe(256): backend {base.backend}, decline counter "
                             f"{reg.get('distributed', 'tile_decline.diahybrid')}")
    F_abs = CSRMatrix(F.row_ptr, F.col_idx, F.vals.abs(), F.shape)
    X = torch.randn((F.n, 8), generator=gen, device="cuda")
    for x in (X[:, 0].contiguous(), X):
        if x.ndim == 1:
            bound = row_bound(ref.spmv_csr(F_abs, x.abs()), F.row_lengths())
            y_plain = ref.spmv_csr(F, x)
        else:
            bound = row_bound(ref.spmm_csr(F_abs, x.abs()), F.row_lengths())
            y_plain = ref.spmm_csr(F, x)
        err = check_close(op(x), y_plain, bound, f"stencil_fringe(256) sharded B={x.shape[1:]}")
    log(f"[dist/decline] stencil_fringe(256) ({F.m} rows, diahybrid) at D=4: "
        f"distributed/tile_decline.diahybrid = "
        f"{reg.get('distributed', 'tile_decline.diahybrid'):.0f}, {op.x_strategy} over the CSR "
        f"path, within the row bound of the plain CSR product (max |err| {err:.3e})")

    # (e) the solver CLI on the card
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.cg_solver", "--shards", "4",
                          "--nrhs", "4"], capture_output=True, text=True, env=env, timeout=300,
                         cwd=str(ROOT))
    for line in cli.stdout.strip().splitlines():
        log(f"[dist/cli] {line}")
    if cli.returncode != 0 or "cuda" not in cli.stdout:
        raise AssertionError(f"cg_solver --shards 4 exited {cli.returncode}: {cli.stderr[-2000:]}")
    log(f"[dist/cli] python -m repro_torch.launch.cg_solver --shards 4 --nrhs 4 on the card: "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[dist] phase done in {time.perf_counter() - t_phase:.1f} s")
    return out


#: Phase 21: the full-width configs (arch, layers kept or None for all:
#: depth cut only as far as one 80 GB card forces), the prompt batch and
#: length (past the 1,024-row kv chunk and no multiple of it; a multiple of
#: la_chunk, as the chunked recurrence needs), the decode steps, the f32
#: tolerance of the CPU-versus-card parity and that of the f32
#: decode-versus-forward check at full width; the share of the card's
#: memory a config's f32 weights may take for its f32 check; the published
#: counts phase 21(a) gives back to four smoke configs (narrow width, as
#: tests/test_torch_published_counts.py).
LM_FULL = (("granite-3-2b", None), ("rwkv6-3b", None), ("jamba-v0.1-52b", 8),
           ("kimi-k2-1t-a32b", 1), ("llama4-scout-17b-a16e", 4), ("internvl2-76b", 8),
           ("seamless-m4t-medium", None))
LM_B, LM_P, LM_G = 4, 1536, 32
LM_F32_ATOL = LM_F32_RTOL = 1e-4
LM_DECODE_TOL = 2e-3     # f32 decode vs full forward, as tests/test_models.py
#: the bf16 logits of tensor- and expert-parallel pieces (phase 23(d), (f),
#: (g)): their per-position RMS distances over the vocabulary from the
#: one-device f32 full forward, ranked, each at most this many times the
#: one-device bf16 decode's of the same rank (:func:`pieces_rms_bar`; the
#: readings it was set from: PERF.md section 6)
LM_PIECES_RMS = 2.0
#: the rows of phase 21 whose f32 full forward phase 23 holds pieces against
LM_PIECES_ARCHS = ("granite-3-2b", "rwkv6-3b", "jamba-v0.1-52b")
LM_PROFILED = 4          # decode steps of run 1 traced by torch.profiler
LM_F32_FIT = 0.75
LM_PUBLISHED = (("kimi-k2-1t-a32b", dict(num_experts=384, top_k=8)),
                ("llama4-scout-17b-a16e", dict(num_experts=16, top_k=1)),
                ("internvl2-76b", dict(frontend_seq=256)),
                ("seamless-m4t-medium", dict(frontend_seq=1024)))


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def upcast_(tree):
    """Replace every leaf with its float32 copy, leaf by leaf, releasing each
    narrower copy's memory to the device as it goes (a bf16 block cannot
    hold its f32 successor, so cached blocks would otherwise add up)."""
    import torch

    for k in list(tree.keys()) if isinstance(tree, dict) else range(len(tree)):
        if isinstance(tree[k], (dict, list)):
            upcast_(tree[k])
        else:
            big = tree[k].numel() * tree[k].element_size() >= 1 << 26
            tree[k] = tree[k].float()
            if big:
                torch.cuda.empty_cache()


def lm_smoke_pair(cfg, dev, seed: int):
    """The port's forward logits (through ``make_prefill_step``) and 8 cached
    decode steps of ``cfg`` on ``dev``, from weights drawn on the CPU from
    ``seed`` and numpy-seeded inputs: the prompt goes into the cache in one
    call, then each step feeds the next of the seeded tokens."""
    import torch

    from repro_torch.launch import steps as STEPS
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as TF
    from repro_torch.util.tree import tree_map
    from repro_torch.models.frontends import vlm_prepend

    model = ED if cfg.is_encdec else TF
    params = tree_map(lambda t: t.to(dev),
                      model.init_params(torch.Generator().manual_seed(seed), cfg))
    rng = np.random.default_rng(seed)
    B, T, G = 2, 16, 8
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T + G)).astype(np.int32)).to(dev)
    extra = None
    if cfg.is_encdec or cfg.frontend == "vit":
        extra = torch.from_numpy(rng.standard_normal(
            (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)).to(dev)
    logits = STEPS.make_prefill_step(cfg)(params, tokens[:, :T], extra)
    step_extra = None
    if cfg.is_encdec:
        step_extra = ED.encode(params, extra, cfg)
        T0 = T
        cache = ED.init_cache(cfg, B, T0 + G, device=dev)
        last, cache = ED.decode(params, tokens[:, :T], step_extra, cfg, cache=cache, cache_index=0)
    else:
        inp = vlm_prepend(params, extra, tokens[:, :T], cfg) if cfg.frontend == "vit" else tokens[:, :T]
        T0 = inp.shape[1]
        cache = TF.init_cache(cfg, B, T0 + G, device=dev)
        last, cache, _ = TF.forward(params, inp, cfg, cache=cache, cache_index=0)
    step = STEPS.make_decode_step(cfg)
    steps = [last[:, -1]]
    for i in range(G):
        last, cache = step(params, cache, tokens[:, T + i:T + i + 1], T0 + i, step_extra)
        steps.append(last[:, 0])
    return logits.float().cpu(), torch.stack(steps, 1).float().cpu()


def lm_parity() -> float:
    """Phase 21(a): the ten smoke configs on the CPU and on the card, at f32;
    then four of them at their published expert, top-k, patch and frame
    counts (``LM_PUBLISHED``; kimi-k2's f32 hold, which its full-width row
    cannot have)."""
    import torch

    from repro_torch.configs.registry import all_archs, get_smoke_config

    t0 = time.perf_counter()
    worst = 0.0
    cases = [(arch, get_smoke_config(arch)) for arch in all_archs()] + [
        (f"{arch} {' '.join(f'{k}={v}' for k, v in counts.items())}",
         dataclasses.replace(get_smoke_config(arch), **counts)) for arch, counts in LM_PUBLISHED]
    for arch, cfg in cases:
        with torch.inference_mode():
            cpu = lm_smoke_pair(cfg, torch.device("cpu"), 0)
            card = lm_smoke_pair(cfg, torch.device("cuda"), 0)
        errs = []
        for what, a, b in (("forward", cpu[0], card[0]), ("decode", cpu[1], card[1])):
            if a.shape != b.shape or not bool(torch.isfinite(b).all()):
                raise AssertionError(f"{arch} {what}: shape {tuple(b.shape)} or non-finite")
            err = float((a - b).abs().max())
            if not bool(((a - b).abs() <= LM_F32_ATOL + LM_F32_RTOL * a.abs()).all()):
                raise AssertionError(f"{arch} {what}: card vs CPU max |err| {err:.3e} over "
                                     f"{LM_F32_ATOL} + {LM_F32_RTOL}|cpu|")
            errs.append(err)
        worst = max(worst, *errs)
        log(f"[lm/parity] {arch}: forward {tuple(card[0].shape)} max |card - cpu| "
            f"{errs[0]:.3e}; 8 cached decode steps {errs[1]:.3e}")
    log(f"[lm/parity] ten smoke configs and four at their published counts within "
        f"{LM_F32_ATOL} + {LM_F32_RTOL}|cpu| at f32 (TF32 off), worst {worst:.3e} "
        f"({time.perf_counter() - t0:.1f} s)")
    return worst


class DispatchLog:
    """Counts, while on, what ``moe.csr_dispatch_plan`` dispatches: tokens
    dropped over capacity and experts routed to, as device tensors (no
    synchronisation inside the forward)."""

    def __init__(self, moe_module):
        self.moe, self.plan = moe_module, moe_module.csr_dispatch_plan
        self.dropped, self.routed = [], []

    def __enter__(self):
        def plan(expert_idx, num_experts, capacity):
            dest, keep, row_ptr = self.plan(expert_idx, num_experts, capacity)
            self.dropped.append((~keep).sum())
            self.routed.append((row_ptr[1:] > row_ptr[:-1]).sum())
            return dest, keep, row_ptr
        self.moe.csr_dispatch_plan = plan
        return self

    def __exit__(self, *exc):
        self.moe.csr_dispatch_plan = self.plan

    def total(self, which) -> int:
        return sum(int(v) for v in getattr(self, which))


class NoDrops:
    """While on, every ``moe.moe_apply`` runs at the capacity factor that
    makes its capacity the N tokens of its call (its own
    ``capacity_factor`` argument; no default of the package changes): a
    token routes to an expert at most once, so nothing is dropped."""

    def __init__(self, moe_module):
        self.moe, self.apply = moe_module, moe_module.moe_apply

    def __enter__(self):
        def apply(params, x, *, num_experts, top_k, **kw):
            # int(N top_k / E x cf) = N; the 1e-6 keeps the product's
            # rounding from landing at N - 1
            kw["capacity_factor"] = num_experts / top_k * (1 + 1e-6)
            return self.apply(params, x, num_experts=num_experts, top_k=top_k, **kw)
        self.moe.moe_apply = apply
        return self

    def __exit__(self, *exc):
        self.moe.moe_apply = self.apply


def lm_model(cfg):
    """The module whose ``init_params`` and ``init_cache`` build ``cfg``."""
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as TF

    return ED if cfg.is_encdec else TF


def lm_prefix(cfg) -> int:
    """Rows ahead of the prompt in the decoder's sequence and cache: the
    ``vit`` frontend's patches, else none."""
    return cfg.frontend_seq if cfg.frontend == "vit" else 0


def lm_moe_layers(cfg) -> int:
    from repro_torch.models import transformer as TF

    if cfg.is_encdec:
        return 0
    return sum(m for _, m in (TF.layer_spec(cfg, i) for i in range(TF.num_layers(cfg))))


def lm_seeded(cfg, seed: int, B: int, P: int, device="cuda"):
    """Weights in ``cfg.dtype`` and [B, P] prompts, drawn on ``device`` from
    one seeded generator."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm_model(cfg).init_params(gen, cfg)
    return params, torch.randint(0, cfg.vocab, (B, P), generator=gen, device=device)


def lm_frontend(cfg, seed: int, B: int, device="cuda"):
    """The frontend stub's input, numpy-seeded float32 [B, frontend_seq,
    d_model]: patch embeddings (``vit``) or encoder frames (encoder–decoder);
    None for a text-only decoder."""
    import torch

    if not (cfg.is_encdec or cfg.frontend == "vit"):
        return None
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((B, cfg.frontend_seq, cfg.d_model))
                            .astype(np.float32)).to(device)


def lm_generate(cfg, params, prompts, G: int, profile_last: int = 0, extra=None):
    """A prefill of ``prompts`` into the cache, then ``G`` greedy steps
    through ``make_decode_step``.  ``extra`` is the frontend's input: patch
    embeddings go ahead of the prompt (the prefill runs
    ``make_prefill_step``'s forward, and the cache rows and every decode
    index count the patches); encoder frames are encoded once, inside the
    prefill's time, and every decoder call attends to that output.  Returns
    every step's logits [B, G+1, V] (the prefill's last position first), the
    tokens [B, G+1], the host times (s) of the prefill and of the decode
    steps, and, where ``profile_last`` > 0, the device work of each of the
    last ``profile_last`` steps from ``torch.profiler`` (kernels launched,
    their summed device ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps as STEPS
    from repro_torch.models import encdec as ED

    B, P = prompts.shape
    off = lm_prefix(cfg)
    cache = lm_model(cfg).init_cache(cfg, B, off + P + G, device=prompts.device)
    step = STEPS.make_decode_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc_out = ED.encode(params, extra, cfg) if cfg.is_encdec else None
    logits, cache = lm_forward_cached(cfg, params, prompts, cache, 0, extra, enc_out)
    tok = logits[:, -1:].argmax(-1)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    outs, toks = [logits[:, -1].clone()], [tok]
    del logits
    prof = None
    t0 = time.perf_counter()
    for i in range(G):
        if profile_last and i == G - profile_last:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        logits, cache = step(params, cache, tok, off + P + i, enc_out)
        tok = logits[:, -1:].argmax(-1)
        outs.append(logits[:, 0])
        toks.append(tok)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    work = None
    if prof is not None:
        prof.__exit__(None, None, None)
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        work = {"kernels": len(kernels) / profile_last,
                "busy_ms": sum(e.device_time_total for e in kernels) / 1e3 / profile_last}
    return torch.stack(outs, 1), torch.cat(toks, 1), t_prefill, t_decode, work


def lm_full_logits(cfg, params, seq, P: int, extra=None):
    """One full forward (``make_prefill_step``) over ``seq``, prompt +
    generated tokens, after the patches or against the encoder's output of
    ``extra``: the logits of the prompt's last position and of each later
    one, [B, G + 1, vocab] (padded rows cut), copied out of the whole
    [B, T, padded vocab] tensor so that it is freed."""
    from repro_torch.launch import steps as STEPS

    logits = STEPS.make_prefill_step(cfg)(params, seq, extra)
    return logits[:, lm_prefix(cfg) + P - 1:, :cfg.vocab].clone()


def lm_check_f32(cfg, params, prompts, G: int, tag: str, extra=None,
                 no_drop: bool = False, profile_last: int = 0) -> dict:
    """The decode-versus-forward check at float32 (TF32 off): a prefill and
    ``G`` greedy steps from ``params`` (float32), then one full forward over
    prompt + generated tokens.  Every step's logits lie within
    ``LM_DECODE_TOL`` (atol and rtol, the reference's own tolerance for this
    identity) of the full forward's at its position, and the full forward's
    argmax is the generated token wherever its top-2 margin exceeds twice
    that tolerance, which must hold at one position at least.  Where the
    prefill or the full forward drops MoE routings over capacity that the
    steps keep, the identity does not hold (as in the reference) and
    nothing is asserted; with ``no_drop`` both run under :class:`NoDrops`,
    must drop nothing, and the identity is held.  ``profile_last`` steps
    are profiled as in :func:`lm_generate` (``work`` in the result)."""
    import contextlib

    import torch

    from repro_torch.models import moe as MOE

    V, P = cfg.vocab, prompts.shape[1]
    mlayers = lm_moe_layers(cfg)
    with torch.inference_mode(), (NoDrops(MOE) if no_drop else contextlib.nullcontext()):
        with DispatchLog(MOE) as moe_gen:
            dec, toks, t_pre, t_dec, work = lm_generate(cfg, params, prompts, G, profile_last,
                                                        extra)
        seq = torch.cat([prompts, toks[:, :-1]], dim=1)
        with DispatchLog(MOE) as moe_full:
            full = lm_full_logits(cfg, params, seq, P, extra)
    dec = dec[..., :V]
    if dec.dtype != torch.float32 or full.dtype != torch.float32:
        raise AssertionError(f"{tag} the f32 check ran at {dec.dtype}, {full.dtype}")
    if int(toks.max()) >= V:
        raise AssertionError(f"{tag} f32 greedy decode picked a padded vocabulary row")
    drops = moe_full.total("dropped")
    pre_drops = sum(int(v) for v in moe_gen.dropped[:mlayers])
    step_drops = sum(int(v) for v in moe_gen.dropped[mlayers:])
    gap = (full - dec).abs()
    tol = LM_DECODE_TOL + LM_DECODE_TOL * full.abs()
    top2 = full.topk(2, dim=-1).values
    checked = (top2[..., 0] - top2[..., 1]) > 2 * tol.amax(-1)
    agree = full.argmax(-1) == toks
    out = {"gap": float(gap.max()), "gap_last": float(gap[:, -1].max()),
           "over_tol": float((gap / tol).max()), "checked": int(checked.sum()),
           "agree": int((agree & checked).sum()), "positions": checked.numel(),
           "drops": drops, "prefill_drops": pre_drops, "step_drops": step_drops,
           "max_logit": float(full.abs().max()),
           "prefill_ms": t_pre * 1e3, "decode_ms": t_dec * 1e3 / G, "work": work}
    what = "f32 check" + (" with nothing dropped (capacity = N tokens)" if no_drop else "")
    log(f"{tag} {what}: decode vs full forward over {seq.shape[1]} tokens, max |gap| "
        f"{out['gap']:.3e} (last position {out['gap_last']:.3e}), {out['over_tol']:.3f} of "
        f"{LM_DECODE_TOL} + {LM_DECODE_TOL}|logit| at worst; max |logit| {out['max_logit']:.3f}; "
        f"argmax = generated token at {out['agree']} of {out['checked']} positions whose top-2 "
        f"margin exceeds twice that ({out['positions']} generated positions); MoE drops in the "
        f"full forward {drops}, in the cached prefill {pre_drops}, in the decode steps "
        f"{step_drops}; f32 prefill {out['prefill_ms']:.2f} ms, decode "
        f"{out['decode_ms']:.3f} ms/step")
    if no_drop and (drops or pre_drops or step_drops):
        raise AssertionError(f"{tag} {drops + pre_drops + step_drops} routings dropped at "
                             f"capacity = N")
    if drops or pre_drops:
        log(f"{tag} the f32 check does not stand here: the full forward dropped {drops} and the "
            f"cached prefill {pre_drops} routings over capacity that the decode steps kept "
            f"(capacity is set by the B*T tokens of one call)")
        return out
    if not bool((gap <= tol).all()):
        raise AssertionError(f"{tag} f32 decode differs from the full forward by "
                             f"{out['gap']:.3e}, over {LM_DECODE_TOL} + {LM_DECODE_TOL}|logit|")
    if not out["checked"]:
        raise AssertionError(f"{tag} no generated position has a top-2 margin over twice the "
                             f"tolerance: the argmax check covers nothing")
    if out["agree"] != out["checked"]:
        raise AssertionError(f"{tag} a generated token is not the f32 full forward's argmax "
                             f"where the margin exceeds twice the tolerance")
    return out


def weight_bytes_per_step(params, cfg, routed_per_step: float) -> float:
    """Bytes of weights one decode step must read: every tensor once (the
    input embedding only where it is also the unembedding: an untied one is
    read B rows at a time; not the encoder, which runs once before the
    steps), and of each MoE layer's experts only the ``routed_per_step``
    (mean over the steps, per MoE layer) that the step's tokens were routed
    to."""
    nbytes = lambda t: t.numel() * t.element_size()
    total = sum(nbytes(t) for t in tree_leaves(params))
    if "unembedding" in params:
        total -= nbytes(params["embedding"])
    if "enc_layers" in params:
        total -= sum(nbytes(t) for t in tree_leaves([params["enc_layers"], params["enc_norm"]]))
    for lp in params.get("layers", ()):
        if "moe" in lp:
            E = lp["moe"]["w_in"].shape[0]
            expert = sum(nbytes(lp["moe"][k]) for k in ("w_in", "w_gate", "w_out"))
            total -= expert * (1 - routed_per_step / E)
    return total


def encdec_split(params):
    """(parameters that multiply the encoder's rows, the rest) of an
    encoder–decoder: the encoder and the cross-attention's K/V weights
    against the decoder's weights and the (tied) embedding."""
    count = lambda tree: sum(t.numel() for t in tree_leaves(tree))
    enc = count([params["enc_layers"], params["enc_norm"]]) + sum(
        lp["xattn"][k].numel() for lp in params["dec_layers"] for k in ("wk", "wv"))
    return enc, count(params) - enc


def prefill_flops(cfg, params, B: int, P: int) -> float:
    """2 x parameters x the rows each multiplies in a prefill: the active
    parameters over the B (patches + P) decoder rows; for the encoder–decoder
    :func:`encdec_split`'s over the B x frames rows and B x P rows."""
    if not cfg.is_encdec:
        return 2 * cfg.active_param_count() * B * (lm_prefix(cfg) + P)
    enc, rest = encdec_split(params)
    return 2 * (enc * B * cfg.frontend_seq + rest * B * P)


def lm_full_width(arch: str, layers, mem_rate: float, bf16_rate: float) -> dict:
    """Phase 21(b)+(c): greedy generation at full width, bf16 and then f32
    from the same weights, each checked against one full forward; repeated
    from its seed at bf16, timed.  A config whose f32 weights would take
    more than ``LM_F32_FIT`` of the card's memory (kimi-k2) has no f32
    check: its bars are the repeated tokens, no padded-vocabulary pick and
    finite logits.  Where the f32 check's forwards drop MoE routings, it
    runs again with nothing dropped (:class:`NoDrops`) and holds there."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import encdec as ED
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TF

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, layers=layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tag = f"[lm/{arch}]"
    mlayers = lm_moe_layers(cfg)
    if cfg.is_encdec:
        what = (f"{cfg.encoder_layers} encoder and {cfg.layers} decoder layers (all), "
                f"{cfg.frontend_seq} encoder frames")
    else:
        kinds = [TF.layer_spec(cfg, i)[0] for i in range(TF.num_layers(cfg))]
        what = (f"{cfg.layers} of {get_config(arch).layers} layers ({kinds.count('attn')} "
                f"attention, {kinds.count('mamba')} mamba, {kinds.count('rwkv')} rwkv, {mlayers} "
                f"MoE" + (f" of {cfg.num_experts} experts, top-{cfg.top_k}"
                          + (", shared expert" if cfg.shared_expert else "") if mlayers else "")
                + ")" + (f", {lm_prefix(cfg)} patches ahead of the prompt" if lm_prefix(cfg)
                         else ""))
    log(f"{tag} {what}, d_model {cfg.d_model}, vocab {cfg.vocab} (padded {cfg.padded_vocab}), "
        f"{cfg.dtype}; B={LM_B} P={LM_P} G={LM_G}")
    V = cfg.vocab
    extra = lm_frontend(cfg, 0, LM_B)
    torch.cuda.reset_peak_memory_stats()

    # run 1: generate at bf16, then one full forward over prompt + generated
    # tokens; its distance from the decode steps is logged, not held (bf16
    # rounding over the full depth moves the logits by as much)
    t0 = time.perf_counter()
    with torch.inference_mode(), DispatchLog(MOE) as moe_dec:
        params, prompts = lm_seeded(cfg, 0, LM_B, LM_P)
        dec, toks, t_pre1, t_dec1, work = lm_generate(cfg, params, prompts, LM_G, LM_PROFILED,
                                                      extra)
    n_params = sum(t.numel() for t in tree_leaves(params))
    # experts routed to per MoE layer and step (the prefill's dispatches,
    # one per MoE layer, come first)
    step_routed = [int(v) for v in moe_dec.routed[mlayers:]]
    routed_steps = sum(step_routed) / len(step_routed) if step_routed else 0.0
    seq = torch.cat([prompts, toks[:, :-1]], dim=1)                   # P + G tokens
    with torch.inference_mode(), DispatchLog(MOE) as moe_full:
        full = lm_full_logits(cfg, params, seq, LM_P, extra).float()  # G + 1 positions
    dec = dec[..., :V].float()
    if int(toks.max()) >= V:
        raise AssertionError(f"{tag} greedy decode picked a padded vocabulary row")
    if not (bool(torch.isfinite(dec).all()) and bool(torch.isfinite(full).all())):
        raise AssertionError(f"{tag} non-finite bf16 logits")
    gap = (full - dec).abs().amax(-1)                                 # [B, G + 1]
    agree = int((full.argmax(-1) == toks).sum())
    log(f"{tag} run 1 (bf16): {n_params / 1e9:.3f} G parameters; decode vs full forward over "
        f"{seq.shape[1]} tokens: max |gap| last position {float(gap[:, -1].max()):.4f}, "
        f"any position {float(gap.max()):.4f}; max |logit| {float(full.abs().max()):.3f}; "
        f"argmax = generated token at {agree} of {toks.numel()} positions"
        + (f"; MoE drops in the full forward {moe_full.total('dropped')} of "
           f"{LM_B * seq.shape[1] * cfg.top_k * mlayers} routings ({len(moe_full.dropped)} "
           f"dispatches); in the cached prefill {sum(int(v) for v in moe_dec.dropped[:mlayers])}, "
           f"in the decode steps {sum(int(v) for v in moe_dec.dropped[mlayers:])}"
           if mlayers else ""))
    one_device = {"tokens": toks.cpu(), "logits": dec.cpu(), "bf16_gap": float(gap.max()),
                  "bf16_f32": None, "full32": None, "rms_full16": None}
    total = torch.cuda.get_device_properties(0).total_memory
    check = None
    if 4 * n_params <= LM_F32_FIT * total:
        # the same weights in f32: the full forward's own bf16 rounding
        # (logged), then the check that holds, the f32 decode against the
        # f32 forward
        upcast_(params)
        with torch.inference_mode():
            full32 = lm_full_logits(cfg32, params, seq, LM_P, extra)
        one_device["bf16_f32"] = float((full - full32).abs().max())
        if arch in LM_PIECES_ARCHS:
            one_device["full32"] = full32.cpu()
        one_device["rms_full16"] = position_rms(full, full32).cpu()
        log(f"{tag} bf16 rounding: max |full forward bf16 - f32| on the same weights and tokens "
            f"{one_device['bf16_f32']:.4f}")
        del full, full32, dec
        check = lm_check_f32(cfg32, params, prompts, LM_G, tag, extra)
        if check["drops"] or check["prefill_drops"]:
            held = lm_check_f32(cfg32, params, prompts, LM_G, tag, extra, no_drop=True)
            check = dict(held, default_drops=check["drops"],
                         default_prefill_drops=check["prefill_drops"])
    else:
        del full, dec
        log(f"{tag} no f32 check at full width: its f32 weights would take "
            f"{4 * n_params / 2**30:.1f} GiB of the card's {total / 2**30:.1f} GiB (over "
            f"{LM_F32_FIT:.0%}); here its bars are the same tokens from the seed, no padded "
            f"vocabulary row and finite logits, and phase 21(a) holds it card against CPU at f32 "
            f"at its published expert count and top-k, narrow")
    del params
    row_peak = torch.cuda.max_memory_allocated()
    free_cuda()

    # run 2: the same seed again, timed, with the peak memory
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        params, prompts = lm_seeded(cfg, 0, LM_B, LM_P)
        _, toks2, t_pre, t_dec, _ = lm_generate(cfg, params, prompts, LM_G, extra=extra)
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(toks, toks2):
        raise AssertionError(f"{tag} two runs from one seed gave different tokens")
    wbytes = weight_bytes_per_step(params, cfg, routed_steps)
    wbytes_all = weight_bytes_per_step(params, cfg, cfg.num_experts)
    pre_bound = prefill_flops(cfg, params, LM_B, LM_P) / bf16_rate * 1e3
    xkv_ms = None
    if cfg.is_encdec:
        # the cross-attention K/V every decode step recomputes from the
        # encoder's output, layer by layer, as the reference does
        with torch.inference_mode():
            enc_out = ED.encode(params, extra, cfg)
            xkv_ms = eager_ms(lambda: [ED._enc_kv(lp["xattn"], enc_out, cfg)
                                       for lp in params["dec_layers"]], iters=20)
        del enc_out
    del params, prompts
    free_cuda()
    dec_ms = t_dec * 1e3 / LM_G
    pre_ms = t_pre * 1e3
    dec_bound = wbytes / mem_rate * 1e3
    tok_s = LM_B * LM_G / t_dec
    log(f"{tag} run 2 (bf16, same seed): the same {toks2.numel()} tokens; prefill {pre_ms:.2f} ms "
        f"(bound {pre_bound:.2f} ms = 2 x parameters x the rows each multiplies / bf16 peak; "
        f"x{pre_ms / pre_bound:.2f}), decode "
        f"{dec_ms:.3f} ms/step (bound {dec_bound:.3f} ms = {wbytes / 1e9:.3f} GB of weights"
        + (f", {routed_steps:.2f} of {cfg.num_experts} experts a MoE layer" if mlayers else "")
        + f" / memory rate; x{dec_ms / dec_bound:.2f}), {tok_s:.1f} tokens/s, peak "
        f"{peak / 2**30:.2f} GiB allocated (the whole row's, f32 check included: "
        f"{row_peak / 2**30:.2f} GiB); run 1 (cold, its last {LM_PROFILED} steps profiled): "
        f"prefill {t_pre1 * 1e3:.2f} ms, decode {t_dec1 * 1e3 / LM_G:.3f} ms/step "
        f"({time.perf_counter() - t0:.1f} s in all)")
    if mlayers:
        log(f"{tag} a MoE decode step runs every expert (as the reference does): "
            f"{wbytes_all / 1e9:.3f} GB of weights, {wbytes_all / mem_rate * 1e3:.3f} ms at the "
            f"memory rate, x{dec_ms / (wbytes_all / mem_rate * 1e3):.2f}; the routed-only bound "
            f"above is the least a step could read")
    if xkv_ms is not None:
        log(f"{tag} the cross-attention K/V of the {cfg.layers} decoder layers, recomputed from "
            f"the encoder's output each step: {xkv_ms:.3f} ms eager, {xkv_ms / dec_ms:.1%} of "
            f"the {dec_ms:.3f} ms step")
    layers_run = cfg.layers if cfg.is_encdec else TF.num_layers(cfg)
    log(f"{tag} a decode step launches {work['kernels']:.0f} kernels "
        f"({work['kernels'] / layers_run:.1f} a layer) that keep the card busy "
        f"{work['busy_ms']:.3f} ms (torch.profiler, run 1): {work['busy_ms'] / dec_ms:.1%} of "
        f"run 2's {dec_ms:.3f} ms step, idle {1 - work['busy_ms'] / dec_ms:.1%}")
    return {"arch": arch, "layers": cfg.layers, "prefill_ms": pre_ms, "prefill_bound_ms": pre_bound,
            "decode_ms": dec_ms, "decode_bound_ms": dec_bound, "tokens_per_s": tok_s,
            "peak_bytes": peak, "row_peak_bytes": row_peak, "f32_check": check,
            "step_kernels": work["kernels"], "step_busy_ms": work["busy_ms"],
            "decode_all_experts_ms": wbytes_all / mem_rate * 1e3, "xattn_kv_ms": xkv_ms,
            **one_device}


def lm_phase(mem_rate: float, bf16_rate: float) -> list:
    """Phase 21: the LM tree's serving path on the card."""
    import os

    import torch

    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("f32 matmuls must run at full precision (TF32 off) for phase 21")
    t_phase = time.perf_counter()
    lm_parity()
    rows = []
    for arch, layers in LM_FULL:
        free_cuda()         # each config's weights go before the next one's are drawn
        rows.append(lm_full_width(arch, layers, mem_rate, bf16_rate))

    # (d) the --arch CLI on the card, full config
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                          "granite-3-2b"], capture_output=True, text=True, env=env, timeout=300,
                         cwd=str(ROOT))
    for line in cli.stdout.strip().splitlines():
        if not line.startswith("# obs serve.decode_step_ms."):
            log(f"[lm/cli] {line}")
    if (cli.returncode != 0 or "on cuda" not in cli.stdout or "decode 31 steps" not in cli.stdout
            or "sample tokens:" not in cli.stdout):
        raise AssertionError(f"serve --arch granite-3-2b exited {cli.returncode}: "
                             f"{cli.stderr[-2000:]}")
    log(f"[lm/cli] python -m repro_torch.launch.serve --arch granite-3-2b on the card: "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"[lm] phase done in {time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 22: the LM tree's training path
# ---------------------------------------------------------------------------

#: Phase 22: the full-width training runs (arch, batch, sequence, steps) and
#: rwkv6-3b's depth (16 of its 32 layers: phase 23(g) trains the same cut on
#: 2 x 4 shards, where a step takes about eight times one device's); the
#: card-versus-CPU tolerance of a gradient leaf (of its largest entry), of a
#: loss and of grad_norm; the ulps an AdamW step may differ by on identical
#: inputs; the f32 gradient check's batch, sequence, step length and the
#: bound assumed on its truncation coefficient (``fd_tolerance``); the
#: optimizer's bytes a parameter (bf16 p and g read, f32 m and v read and
#: written, p written: 22).
TR_GRANITE = ("granite-3-2b", 4, 1536, 8)
TR_RWKV = ("rwkv6-3b", 2, 1024, 3)
TR_RWKV_LAYERS = 16
TR_RTOL, TR_ATOL = 1e-4, 1e-6
TR_ULPS = 4
TR_FD_B, TR_FD_S, TR_FD_EPS, TR_FD_TRUNC = 1, 1536, 1e-3, 1e3
# parts of granite-3-2b checked on their own in phase 22(d), as leaf-path prefixes
TR_FD_BLOCKS = (("embedding",), ("layers", 0, "attn"), ("layers", 0, "mlp"),
                ("layers", 20, "attn"), ("layers", 20, "mlp"), ("layers", 39, "attn"),
                ("layers", 39, "mlp"))
OPT_BYTES_PER_PARAM = 22


def fd_tolerance(loss: float, gnorm: float, eps: float = TR_FD_EPS) -> float:
    """Relative tolerance of the central difference (L(p + eps v) - L(p - eps
    v)) / 2 eps against |g|, v = g / |g| (derived in PERF.md §6; the
    same for g restricted to a part of the weights, |g| then that part's,
    since only that part is rounded): truncation c eps^2
    with |c| <= ``TR_FD_TRUNC``; each f32 loss within 8 u L (u = 2^-24) of
    exact, so the difference within 8 u L / (eps |g|); and the rounding of
    p - eps v (half an ulp of a weight, at most 2^-23 |p| < 2^-23 for every
    weight under 1: six standard deviations of the uniform rounding along g
    give 6 (2^-23 / sqrt 12) / (2 eps))."""
    u = 2.0 ** -24
    return (TR_FD_TRUNC * eps ** 2 + 8 * u * loss / (eps * gnorm)
            + 6 * (2 * u / 12 ** 0.5) / (2 * eps))


def train_smoke_inputs(cfg, seed: int, B: int = 2, T: int = 16):
    """Numpy-seeded tokens, labels and (vit, encdec) frontend inputs."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    extra = None
    if cfg.is_encdec or cfg.frontend == "vit":
        extra = rng.standard_normal((B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return tokens, labels, extra


def train_smoke_grads(cfg, dev, seed: int, B: int = 2, T: int = 16):
    """(params, inputs, loss, aux, grads) of ``cfg`` on ``dev`` through
    ``make_grad_fn`` at B x T, from weights drawn on the CPU from
    ``seed``."""
    import torch

    from repro_torch.launch import steps as STEPS
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as TF
    from repro_torch.util.tree import tree_map

    model = ED if cfg.is_encdec else TF
    params = tree_map(lambda t: t.to(dev),
                      model.init_params(torch.Generator().manual_seed(seed), cfg))
    inputs = [None if a is None else torch.from_numpy(a).to(dev)
              for a in train_smoke_inputs(cfg, seed, B, T)]
    loss, aux, grads = STEPS.make_grad_fn(cfg)(params, *inputs)
    return params, inputs, loss, aux, grads


def check_within(what: str, card, cpu, rtol: float, atol: float) -> float:
    """max |card - cpu| <= rtol * max |cpu| + atol, or raise; returns it."""
    import torch

    card, cpu = card.detach().double().cpu(), cpu.detach().double().cpu()
    if card.shape != cpu.shape or not bool(torch.isfinite(card).all()):
        raise AssertionError(f"{what}: shape {tuple(card.shape)} or non-finite")
    err = float((card - cpu).abs().max()) if cpu.numel() else 0.0
    tol = rtol * (float(cpu.abs().max()) if cpu.numel() else 0.0) + atol
    if not err <= tol:
        raise AssertionError(f"{what}: max |card - cpu| {err:.3e} over {tol:.3e}")
    return err


def train_parity(arch: str) -> dict:
    """Phase 22(a) for one smoke config: loss, grad_norm and every gradient
    leaf card against CPU; one microbatches=2 step; ``compress_grads`` and
    ``adamw.apply`` fed the CPU's gradients on both devices."""
    import torch

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import steps as STEPS
    from repro_torch.util.tree import tree_map
    from repro_torch.optim import adamw
    from repro_torch.optim import compress as COMP
    from repro_torch.util.tree import leaves

    cfg = get_smoke_config(arch)
    cpu, card = torch.device("cpu"), torch.device("cuda")
    p_cpu, in_cpu, l_cpu, a_cpu, g_cpu = train_smoke_grads(cfg, cpu, 0)
    p_card, in_card, l_card, a_card, g_card = train_smoke_grads(cfg, card, 0)
    out = {"loss": check_within(f"{arch} loss", l_card, l_cpu, TR_RTOL, TR_ATOL),
           "aux": check_within(f"{arch} moe aux", a_card, a_cpu, TR_RTOL, TR_ATOL),
           "grad_norm": check_within(f"{arch} grad_norm", adamw.global_norm(g_card),
                                     adamw.global_norm(g_cpu), TR_RTOL, TR_ATOL)}
    errs = [check_within(f"{arch} gradient leaf {i} {tuple(g.shape)}", gc, g, TR_RTOL, TR_ATOL)
            / max(float(g.abs().max()), 1e-30)
            for i, (gc, g) in enumerate(zip(leaves(g_card), leaves(g_cpu)))]
    out["leaves"], out["worst_rel"] = len(errs), max(errs)

    # one microbatches=2 step from the same weights on both devices
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    mets = []
    for params, inputs in ((p_cpu, in_cpu), (p_card, in_card)):
        params = tree_map(torch.clone, params)
        _, opt, m = STEPS.make_train_step(cfg, opt_cfg, microbatches=2)(
            params, adamw.init(params), *inputs)
        if int(opt.step) != 1:
            raise AssertionError(f"{arch} microbatches=2: step {int(opt.step)}")
        mets.append(m)
    for k in ("loss", "grad_norm", "lr", "moe_aux"):
        check_within(f"{arch} microbatches=2 {k}", mets[1][k], mets[0][k], TR_RTOL, TR_ATOL)

    # compress_grads (density 0.05, top-k over the reference's stacks) and
    # adamw.apply on identical gradients
    comp = COMP.CompressionConfig(density=0.05)
    groups = STEPS.stacked_leaf_groups(cfg, g_cpu)
    to_card = lambda tree: tree_map(lambda t: t.to(card), tree)
    sparse = []
    for dev_grads, params in ((g_cpu, p_cpu), (to_card(g_cpu), p_card)):
        sparse.append(COMP.compress_grads(comp, dev_grads, COMP.init(params), groups=groups))
    (sg_cpu, st_cpu, cm_cpu), (sg_card, st_card, cm_card) = sparse
    if cm_cpu["compress_ratio"] != cm_card["compress_ratio"]:
        raise AssertionError(f"{arch} compress_ratio {cm_card} != {cm_cpu}")
    for a, b in zip(leaves(sg_card) + leaves(st_card.residual),
                    leaves(sg_cpu) + leaves(st_cpu.residual)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"{arch} compress_grads: card and CPU differ on equal inputs")
    big = max(leaves(g_cpu), key=lambda t: t.numel())
    k = max(int(big.numel() * comp.density), 1)
    if not torch.equal(COMP.topk_csr(big.to(card), k)[1].cpu(), COMP.topk_csr(big, k)[1]):
        raise AssertionError(f"{arch} topk_csr: card and CPU indices differ on equal input")
    applied = []
    for params, grads in ((p_cpu, g_cpu), (p_card, to_card(g_cpu))):
        params = tree_map(torch.clone, params)
        applied.append(adamw.apply(opt_cfg, params, grads, adamw.init(params)))
    (np_cpu, s_cpu, m_cpu), (np_card, s_card, m_card) = applied
    for a, b in zip(leaves(np_card) + leaves(s_card.mu) + leaves(s_card.nu),
                    leaves(np_cpu) + leaves(s_cpu.mu) + leaves(s_cpu.nu)):
        check_within(f"{arch} adamw.apply", a, b, TR_ULPS * EPS32, 0.0)
    out["compress_ratio"] = cm_card["compress_ratio"]
    return out


def train_parity_all() -> None:
    """Phase 22(a): the ten smoke configs, card against CPU, at f32."""
    from repro_torch.configs.registry import all_archs

    t0 = time.perf_counter()
    worst = 0.0
    for arch in all_archs():
        r = train_parity(arch)
        worst = max(worst, r["worst_rel"])
        log(f"[train/parity] {arch}: loss |card - cpu| {r['loss']:.3e}, grad_norm "
            f"{r['grad_norm']:.3e}, {r['leaves']} gradient leaves within {TR_RTOL} max|g| + "
            f"{TR_ATOL} (worst {r['worst_rel']:.3e} of its leaf's max); microbatches=2 step "
            f"agrees; compress_grads (ratio {r['compress_ratio']:.4f}) and topk_csr bit-equal "
            f"and adamw.apply within {TR_ULPS} ulps on equal gradients")
    log(f"[train/parity] ten smoke configs' backward passes card vs CPU at f32 (TF32 off), "
        f"worst leaf {worst:.3e} of its max ({time.perf_counter() - t0:.1f} s)")


class CompressTimer:
    """Times, while on, each ``compress_grads`` call: host ms to return
    (enqueue) and device ms between CUDA events around it."""

    def __init__(self, module):
        self.mod, self.fn = module, module.compress_grads
        self.host_ms, self.device_ms = [], []

    def __enter__(self):
        import torch

        def timed(*args, **kw):
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            out = self.fn(*args, **kw)
            end.record()
            self.host_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            self.device_ms.append(start.elapsed_time(end))
            return out

        self.mod.compress_grads = timed
        return self

    def __exit__(self, *exc):
        self.mod.compress_grads = self.fn


def step_bound_ms(n_params: int, tokens: int, mem_rate: float, bf16_rate: float):
    """(compute ms, optimizer ms): 8 N flops a token (forward, backward and
    remat's second forward) over the dense bf16 rate; 22 bytes a parameter
    of the AdamW update over the memory rate."""
    return (8 * n_params * tokens / bf16_rate * 1e3,
            OPT_BYTES_PER_PARAM * n_params / mem_rate * 1e3)


def free_cuda() -> None:
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def train_granite(mem_rate: float, bf16_rate: float) -> dict:
    """Phase 22(b)+(f): granite-3-2b at full width and depth, bf16, through
    ``train_with_restart``; then two steps with CSR top-k compression."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, global_batch_array
    from repro_torch.launch import steps as STEPS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import compress as COMP
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import TrainerConfig, train_with_restart
    from repro_torch.util.tree import leaves

    arch, B, S, steps = TR_GRANITE
    cfg = get_config(arch)
    tag = f"[train/{arch}]"
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=steps)
    data = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    log(f"{tag} {cfg.layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}, "
        f"remat {cfg.remat}; B={B} S={S}, {steps} steps of train_with_restart, lr 3e-4, "
        f"warmup 2")
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    t0 = time.perf_counter()
    state = train_with_restart(cfg, opt_cfg, data, TrainerConfig(steps=steps, log_every=steps),
                               lambda: make_host_mesh(1, device="cuda"), metrics_out=metrics)
    t_run = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{tag} losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag} the last loss {losses[-1]:.4f} is not below the first "
                             f"{losses[0]:.4f}")
    n_params = sum(t.numel() for t in leaves(state.params))
    step_ms = float(np.median([m["time_s"] for m in metrics[1:]])) * 1e3
    comp_ms, opt_ms = step_bound_ms(n_params, B * S, mem_rate, bf16_rate)
    log(f"{tag} losses " + ", ".join(f"{v:.4f}" for v in losses)
        + f"; drop {losses[0] - losses[-1]:.4f}; grad_norm "
        + ", ".join(f"{m['grad_norm']:.3f}" for m in metrics)
        + f"; lr " + ", ".join(f"{m['lr']:.2e}" for m in metrics))
    log(f"{tag} {n_params / 1e9:.3f} G parameters; step {step_ms:.1f} ms (median of steps "
        f"2-{steps}; first {metrics[0]['time_s'] * 1e3:.1f} ms), {B * S / step_ms * 1e3:.0f} "
        f"tokens/s; least time {comp_ms:.1f} ms (8 N B S / bf16 peak) + {opt_ms:.1f} ms "
        f"({OPT_BYTES_PER_PARAM} B a parameter / memory rate) = {comp_ms + opt_ms:.1f} ms, "
        f"x{step_ms / (comp_ms + opt_ms):.2f}; peak {peak / 2**30:.2f} GiB allocated; "
        f"{t_run:.1f} s in all")

    # two more steps through the CSR top-k compression at density 0.01
    comp = COMP.CompressionConfig(density=0.01)
    step = STEPS.make_train_step(cfg, opt_cfg, compression=comp)
    comp_state = COMP.init(state.params)
    mesh = make_host_mesh(1, device="cuda")
    params, opt_state = state.params, state.opt_state
    del state
    # compress_ratio from the sizes of the reference's stacked leaves
    flat = leaves(params)
    sizes = [sum(flat[i].numel() for i in g) for g in STEPS.stacked_leaf_groups(cfg, params)]
    want = (sum(8 * max(int(n * comp.density), 1) if n >= comp.min_size else 4 * n
                for n in sizes) / sum(4 * n for n in sizes))
    closses = []
    with CompressTimer(COMP) as timer:
        for s in (steps, steps + 1):
            tokens, labels = global_batch_array(data, s, mesh)
            params, opt_state, comp_state, m = step(params, opt_state, comp_state, tokens, labels)
            closses.append(float(m["loss"]))
            if abs(m["compress_ratio"] - want) > 1e-12 * want:
                raise AssertionError(f"{tag} compress_ratio {m['compress_ratio']} != {want} "
                                     f"from the leaf sizes")
    if not all(np.isfinite(closses)):
        raise AssertionError(f"{tag} compressed losses {closses}")
    peak_c = torch.cuda.max_memory_allocated()
    log(f"{tag} 2 steps with compress_grads at density {comp.density}: losses "
        + ", ".join(f"{v:.4f}" for v in closses)
        + f"; compress_ratio {want:.6f} (= the stacks' 8k or 4 size bytes over 4 size); "
        f"compress_grads host {', '.join(f'{v:.1f}' for v in timer.host_ms)} ms to return, "
        f"device {', '.join(f'{v:.1f}' for v in timer.device_ms)} ms over {len(flat)} leaves "
        f"in {len(sizes)} stacks; "
        f"peak {peak_c / 2**30:.2f} GiB allocated")
    del params, opt_state, comp_state, m, tokens, labels, flat
    free_cuda()
    return {"arch": arch, "step_ms": step_ms, "bound_ms": comp_ms + opt_ms, "peak": peak,
            "losses": losses, "compress_ms": timer.device_ms}


def train_rwkv(mem_rate: float, bf16_rate: float) -> dict:
    """Phase 22(c)+(f): rwkv6-3b at full width, ``TR_RWKV_LAYERS`` layers,
    bf16, ``make_train_step``."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, global_batch_array
    from repro_torch.launch import steps as STEPS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adamw
    from repro_torch.util.tree import leaves

    arch, B, S, steps = TR_RWKV
    cfg = dataclasses.replace(get_config(arch), layers=TR_RWKV_LAYERS)
    tag = f"[train/{arch}]"
    mesh = make_host_mesh(1, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params = TF.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt_state = adamw.init(params)
    n_params = sum(t.numel() for t in leaves(params))
    step = STEPS.make_train_step(cfg, adamw.AdamWConfig(lr=3e-4, warmup_steps=1,
                                                        total_steps=steps))
    data = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    losses, times = [], []
    for s in range(steps):
        tokens, labels = global_batch_array(data, s, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, tokens, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag} losses {losses}")
    step_ms = float(np.median(times[1:])) * 1e3
    comp_ms, opt_ms = step_bound_ms(n_params, B * S, mem_rate, bf16_rate)
    log(f"{tag} {cfg.layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} G parameters, "
        f"{cfg.dtype}, remat {cfg.remat}; B={B} S={S}: losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f"; step {step_ms:.1f} ms (median of steps 2-{steps}; first {times[0] * 1e3:.1f} ms), "
        f"{B * S / step_ms * 1e3:.0f} tokens/s; least time {comp_ms:.1f} + {opt_ms:.1f} = "
        f"{comp_ms + opt_ms:.1f} ms, x{step_ms / (comp_ms + opt_ms):.2f}; peak "
        f"{peak / 2**30:.2f} GiB allocated")
    del params, opt_state, m
    free_cuda()
    return {"arch": arch, "step_ms": step_ms, "bound_ms": comp_ms + opt_ms, "peak": peak,
            "losses": losses}


#: Phase 22(g): seamless-m4t-medium trained whole (arch, batch, decoder
#: sequence, steps; the encoder takes the config's 1,024 frames a sequence)
#: and the batch and decoder sequence of its f32 gradient check (with all
#: 1,024 frames).
TR_SEAMLESS = ("seamless-m4t-medium", 4, 1536, 3)
TR_SEAMLESS_F32 = (1, 64)


def encdec_step_bound_ms(params, cfg, B: int, S: int, mem_rate: float, bf16_rate: float):
    """:func:`step_bound_ms` of an encoder–decoder step: :func:`encdec_split`'s
    parameters over the B x frames rows and the B x S decoder rows; AdamW
    over every parameter."""
    enc, rest = encdec_split(params)
    comp = (step_bound_ms(enc, B * cfg.frontend_seq, mem_rate, bf16_rate)[0]
            + step_bound_ms(rest, B * S, mem_rate, bf16_rate)[0])
    return comp, step_bound_ms(enc + rest, 0, mem_rate, bf16_rate)[1]


def train_seamless(mem_rate: float, bf16_rate: float) -> dict:
    """Phase 22(g): seamless-m4t-medium at full width and depth (12 encoder
    and 12 decoder layers), bf16, remat as configured: ``make_train_step``
    steps at B=4 x S=1536, each batch's 1,024 frames a sequence
    numpy-seeded by its step; every loss finite and the last below the
    first."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, global_batch_array
    from repro_torch.launch import steps as STEPS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import encdec as ED
    from repro_torch.optim import adamw
    from repro_torch.util.tree import leaves

    arch, B, S, steps = TR_SEAMLESS
    cfg = get_config(arch)
    tag = f"[train/{arch}]"
    mesh = make_host_mesh(1, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params = ED.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt_state = adamw.init(params)
    n_params = sum(t.numel() for t in leaves(params))
    comp_ms, opt_ms = encdec_step_bound_ms(params, cfg, B, S, mem_rate, bf16_rate)
    step = STEPS.make_train_step(cfg, adamw.AdamWConfig(lr=3e-4, warmup_steps=1,
                                                        total_steps=steps))
    data = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    losses, times = [], []
    for s in range(steps):
        tokens, labels = global_batch_array(data, s, mesh)
        frames = lm_frontend(cfg, s, B)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, tokens, labels, frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag} losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag} the last loss {losses[-1]:.4f} is not below the first "
                             f"{losses[0]:.4f}")
    step_ms = float(np.median(times[1:])) * 1e3
    tokens_s = B * S / step_ms * 1e3
    log(f"{tag} {cfg.encoder_layers} encoder and {cfg.layers} decoder layers (all), d_model "
        f"{cfg.d_model}, vocab {cfg.vocab} (tied), {n_params / 1e9:.3f} G parameters, "
        f"{cfg.dtype}, remat {cfg.remat}; B={B} S={S} against {cfg.frontend_seq} frames a "
        f"sequence: losses " + ", ".join(f"{v:.4f}" for v in losses)
        + f"; step {step_ms:.1f} ms (median of steps 2-{steps}; first {times[0] * 1e3:.1f} ms), "
        f"{tokens_s:.0f} decoder tokens/s; least time {comp_ms:.1f} ms (8 N x the rows each "
        f"weight multiplies / bf16 peak) + {opt_ms:.1f} ms = {comp_ms + opt_ms:.1f} ms, "
        f"x{step_ms / (comp_ms + opt_ms):.2f}; peak {peak / 2**30:.2f} GiB allocated")
    del params, opt_state, m
    free_cuda()
    return {"arch": arch, "step_ms": step_ms, "bound_ms": comp_ms + opt_ms, "peak": peak,
            "losses": losses, "tokens_per_s": tokens_s}


def train_seamless_f32() -> dict:
    """Phase 22(g), f32: seamless-m4t-medium at full width and depth in f32
    (TF32 off), remat on, B=1 x S=64 against all 1,024 frames: the loss,
    grad_norm and every gradient leaf of ``make_grad_fn`` on the card
    against the CPU's, from the same weights (drawn on the CPU) and
    numpy-seeded inputs, at phase 22(a)'s bars."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import encdec as ED
    from repro_torch.optim import adamw
    from repro_torch.util.tree import leaf_paths, leaves, tree_map

    cfg = dataclasses.replace(get_config(TR_SEAMLESS[0]), dtype="float32")
    B, S = TR_SEAMLESS_F32
    tag = f"[train/{cfg.name} f32]"
    t0 = time.perf_counter()
    p_cpu = ED.init_params(torch.Generator().manual_seed(0), cfg)
    inputs = [torch.from_numpy(a) for a in train_smoke_inputs(cfg, 0, B, S)]
    grad_fn = STEPS.make_grad_fn(cfg)
    t1 = time.perf_counter()
    l_cpu, _, g_cpu = grad_fn(p_cpu, *inputs)
    t_cpu = time.perf_counter() - t1
    p_card = tree_map(lambda t: t.to("cuda"), p_cpu)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    l_card, _, g_card = grad_fn(p_card, *[t.cuda() for t in inputs])
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t1
    errs = {"loss": check_within(f"{tag} loss", l_card, l_cpu, TR_RTOL, TR_ATOL),
            "grad_norm": check_within(f"{tag} grad_norm", adamw.global_norm(g_card),
                                      adamw.global_norm(g_cpu), TR_RTOL, TR_ATOL)}
    rel = [check_within(f"{tag} gradient leaf {'/'.join(map(str, q))} {tuple(g.shape)}", gc, g,
                        TR_RTOL, TR_ATOL) / max(float(g.abs().max()), 1e-30)
           for q, gc, g in zip(leaf_paths(g_cpu), leaves(g_card), leaves(g_cpu))]
    log(f"{tag} B={B} S={S} against {cfg.frontend_seq} frames, remat {cfg.remat}: loss "
        f"{float(l_card):.9g} on the card, {float(l_cpu):.9g} on the CPU (|diff| "
        f"{errs['loss']:.3e}); grad_norm {float(adamw.global_norm(g_card)):.9g} and "
        f"{float(adamw.global_norm(g_cpu)):.9g} (|diff| {errs['grad_norm']:.3e}); "
        f"{len(rel)} gradient leaves within {TR_RTOL} max|g| + {TR_ATOL} (worst {max(rel):.3e} "
        f"of its leaf's max); make_grad_fn {t_cpu:.1f} s on the CPU, {t_card * 1e3:.1f} ms on "
        f"the card ({time.perf_counter() - t0:.1f} s in all)")
    del p_card, g_card, l_card
    free_cuda()
    return dict(errs, worst_rel=max(rel), cpu_s=t_cpu, card_ms=t_card * 1e3)


def fd_gap(loss_at, flat_p, flat_g, idx, eps: float = TR_FD_EPS) -> dict:
    """The central differences of the loss along v = g_S / |g_S|, the
    gradient restricted to the leaves ``idx``, at eps and 2 eps, against
    |g_S| (each point p + k eps v is one rounding from the saved weights,
    which are put back after)."""
    import torch

    gnorm = float(torch.sqrt(sum(torch.sum(flat_g[i].double() ** 2) for i in idx)))
    saved = [flat_p[i].clone() for i in idx]
    losses = {}
    with torch.no_grad():
        for k in (1, -1, 2, -2):
            for i, p0 in zip(idx, saved):
                flat_p[i].copy_(p0).add_(flat_g[i], alpha=k * eps / gnorm)
            losses[k] = loss_at()
        for i, p0 in zip(idx, saved):
            flat_p[i].copy_(p0)
    fd = (losses[1] - losses[-1]) / (2 * eps)
    fd2 = (losses[2] - losses[-2]) / (4 * eps)
    rel, rel2 = fd / gnorm - 1, fd2 / gnorm - 1
    return {"gnorm": gnorm, "fd": fd, "rel": rel, "rel2": rel2,
            "c": (rel2 - rel) / (3 * eps ** 2), "losses": losses}


def train_grad_check() -> dict:
    """Phase 22(d): granite-3-2b at full width in f32 (TF32 off), B=1 x
    S=1536, remat on.  Every gradient leaf is nonzero somewhere; the central
    difference of the loss along the gradient restricted to each part of
    ``TR_FD_BLOCKS`` (the embedding, attention and MLP of layers 0, 20 and
    39), normalised, equals that part's |g_S| within ``fd_tolerance``, so
    a layer whose gradient is lost or mis-scaled fails its own check; then
    the same along v = g/|g| over every leaf.  The difference at twice the
    step measures the truncation coefficient the tolerance assumes."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, global_batch_array
    from repro_torch.launch import steps as STEPS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as TF
    from repro_torch.util.tree import leaf_paths, leaves

    cfg = dataclasses.replace(get_config("granite-3-2b"), dtype="float32")
    tag = "[train/grad-check]"
    t0 = time.perf_counter()
    params = TF.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    data = DataConfig(vocab=cfg.vocab, seq_len=TR_FD_S, global_batch=TR_FD_B)
    tokens, labels = global_batch_array(data, 0, make_host_mesh(1, device="cuda"))
    loss, _, grads = STEPS.make_grad_fn(cfg)(params, tokens, labels)
    flat_p, flat_g, paths = leaves(params), leaves(grads), leaf_paths(params)
    zero = [paths[i] for i, g in enumerate(flat_g) if not bool(g.any())]
    if zero:
        raise AssertionError(f"{tag} leaves whose gradient is zero everywhere: {zero}")

    def loss_at():
        with torch.inference_mode():
            return float(STEPS.cross_entropy(TF.forward(params, tokens, cfg)[0], labels))

    L0 = loss_at()
    log(f"{tag} {cfg.layers} layers f32, B={TR_FD_B} S={TR_FD_S}, remat {cfg.remat}: loss "
        f"{float(loss):.6f} (forward alone {L0:.6f}); all {len(flat_g)} gradient leaves nonzero; "
        f"central differences at eps {TR_FD_EPS} along the gradient of each part, normalised:")
    out = {}
    for prefix in TR_FD_BLOCKS + ((),):
        idx = [i for i, q in enumerate(paths) if q[:len(prefix)] == prefix]
        r = fd_gap(loss_at, flat_p, flat_g, idx)
        tol = fd_tolerance(L0, r["gnorm"])
        name = "/".join(map(str, prefix)) or "every leaf"
        log(f"{tag}   {name} ({len(idx)} leaves): |g_S| {r['gnorm']:.6f}, difference "
            f"{r['fd']:.6f}, relative gap {r['rel']:+.3e} against the tolerance {tol:.3e}; at "
            f"2 eps {r['rel2']:+.3e}, so c = {r['c']:+.1f} (assumed |c| <= {TR_FD_TRUNC:.0f}); "
            f"losses " + ", ".join(f"{k:+d} eps {v:.7f}" for k, v in r["losses"].items()))
        if not abs(r["rel"]) <= tol or not np.isfinite(r["gnorm"]):
            raise AssertionError(f"{tag} {name}: the directional derivative {r['fd']:.6f} "
                                 f"differs from |g_S| {r['gnorm']:.6f} by {r['rel']:+.3e}, "
                                 f"over {tol:.3e}")
        out[name] = dict(r, tol=tol)
    log(f"{tag} {len(out)} directions within their tolerances "
        f"({time.perf_counter() - t0:.1f} s)")
    del params, grads, flat_p, flat_g
    free_cuda()
    return out


def train_restart_check(dev: str = "cuda") -> dict:
    """Phase 22(e): the reference's restart test shape on the card (granite
    smoke with 2 layers, seq_len 64): 20 steps straight against 10 +
    restart + 10 (final losses within rtol 1e-4), a ``failure_at`` run
    through ``train_with_restart`` (steps 11-12 twice), and bf16 leaves
    through a checkpoint bit for bit."""
    import tempfile

    import torch

    from repro_torch.checkpoint import ckpt as CKPT
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as TF
    from repro_torch.util.tree import tree_map
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import trainer as TR
    from repro_torch.util.tree import leaves

    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), layers=2)
    data = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=1)
    mesh = lambda: make_host_mesh(1, device=dev)

    def run(steps, ckpt_dir=None, failure_at=None, schedule_steps=None, restart=False):
        opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=schedule_steps or steps)
        tcfg = TR.TrainerConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=5, log_every=100,
                                failure_at=failure_at)
        metrics = []
        if restart:
            TR.train_with_restart(cfg, opt, data, tcfg, mesh, metrics_out=metrics)
        else:
            TR.train(cfg, opt, data, tcfg, mesh(), metrics_out=metrics)
        return metrics

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".ckpt_") as d:
        straight = run(20)
        run(10, ckpt_dir=f"{d}/a", schedule_steps=20)
        resumed = run(20, ckpt_dir=f"{d}/a")
        failed = run(15, ckpt_dir=f"{d}/b", failure_at=12, restart=True)
        params = tree_map(lambda t: t.to(torch.bfloat16),
                          TF.init_params(torch.Generator(device=dev).manual_seed(0), cfg))
        CKPT.save(f"{d}/c", 1, {"params": params})
        back, _ = CKPT.restore(f"{d}/c", {"params": tree_map(torch.zeros_like, params)})
    if resumed[0]["step"] != 11:
        raise AssertionError(f"resume started at step {resumed[0]['step']}, not 11")
    a, b = straight[-1]["loss"], resumed[-1]["loss"]
    if not abs(a - b) <= 1e-4 * abs(b):
        raise AssertionError(f"restart: final loss {b} against {a} straight, over rtol 1e-4")
    steps = [m["step"] for m in failed]
    if steps[-1] != 15 or steps.count(11) != 2 or steps.count(12) != 2:
        raise AssertionError(f"failure run steps {steps}")
    for x, y in zip(leaves(back), leaves(params)):
        if x.dtype != torch.bfloat16 or x.device != y.device or not torch.equal(
                x.view(torch.int16), y.view(torch.int16)):
            raise AssertionError("a bf16 leaf did not come back from the checkpoint bit for bit")
    log(f"[train/restart] on {dev}: final loss {a:.6f} straight, {b:.6f} after 10 + restart + "
        f"10 (|diff| {abs(a - b):.2e}, rtol 1e-4); failure at step 12 restarted from step 10 "
        f"(steps 11-12 twice, 15 reached); {len(leaves(params))} bf16 leaves round-trip bit for "
        f"bit ({time.perf_counter() - t0:.1f} s)")
    return {"straight": a, "resumed": b}


def train_phase(mem_rate: float, bf16_rate: float) -> list:
    """Phase 22: the LM tree's training path on the card."""
    import os

    import torch

    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("f32 matmuls must run at full precision (TF32 off) for phase 22")
    t_phase = time.perf_counter()
    train_parity_all()
    rows = [train_granite(mem_rate, bf16_rate), train_rwkv(mem_rate, bf16_rate)]
    train_grad_check()
    train_restart_check()
    # (g) the encoder-decoder trained whole, then its f32 gradients
    rows.append(train_seamless(mem_rate, bf16_rate))
    train_seamless_f32()

    # (h) the training CLI on the card, full config
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                          "granite-3-2b", "--steps", "3", "--batch", "2", "--seq", "512"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=str(ROOT))
    for line in cli.stdout.strip().splitlines():
        log(f"[train/cli] {line}")
    if cli.returncode != 0 or "[trainer] step 3 loss" not in cli.stdout or "over 3 steps" \
            not in cli.stdout:
        raise AssertionError(f"launch.train --arch granite-3-2b exited {cli.returncode}: "
                             f"{cli.stderr[-2000:]}")
    log(f"[train/cli] python -m repro_torch.launch.train --arch granite-3-2b --steps 3 --batch 2 "
        f"--seq 512 on the card: {time.perf_counter() - t0:.1f} s")
    log(f"[train] phase done in {time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 23: the sharded LM path
# ---------------------------------------------------------------------------

#: Phase 23: the data x model mesh of the smoke and full-width runs; the
#: smoke configs (arch, layers, model axis: qwen2's 4 heads and 2 kv heads
#: divide over model 2, so attention, MLP and vocabulary run tensor-parallel
#: there; jamba's experts and its mamba mixers' 4 heads split over model 4,
#: and on model 2 its attention too; rwkv6's 2 heads over model 2, so its
#: time mix and channel mix both run tensor-parallel there) and their batch;
#: the card-versus-CPU bar of a leaf (of its largest entry, phase 22(a)'s)
#: and of a logit (of its own size); the bf16 loss bar against phase 22
#: (the reference's, tests/test_distributed.py:111); the restart batch
#: (divides over 8 and 6 data shards); (g)'s train steps.
SH_DATA, SH_MODEL = 2, 4
SH_SMOKE = (("qwen2-7b", 2, 2), ("jamba-v0.1-52b", None, 4), ("jamba-v0.1-52b", None, 2),
            ("rwkv6-3b", None, 2))
SH_B, SH_T = 4, 32
SH_RTOL = 1e-4
SH_LOGIT_TOL = 1e-4
SH_LOSS_TOL = 1e-2
SH_STEPS = 3
SH_RESTART_B = 24
SH_EP_MODEL = 4
SH_RWKV_STEPS = 2


def sharded_mesh(dev, data: int = SH_DATA, model: int = SH_MODEL):
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(data * model, dev, model=model)


def sharded_smoke_step(cfg, dev, seed: int, model: int = SH_MODEL) -> dict:
    """One sharded train step of ``cfg`` on a data 2 x ``model`` mesh of
    ``dev`` shards, from weights drawn on the CPU from ``seed`` and
    numpy-seeded tokens: loss, aux, the averaged gradients and the updated
    parameters (whole, on the CPU), the step's metrics; and, from the same
    weights in pieces, the logits of a prefill of the tokens into a cache
    in pieces and of one decode step after it (on the CPU)."""
    import torch

    from repro_torch.launch import sharded as SHD
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adamw
    from repro_torch.util import sharded as SU

    mesh = sharded_mesh(dev, SH_DATA, model)
    params = TF.init_params(torch.Generator().manual_seed(seed), cfg)
    sp = SHD.shard_tree(params, mesh)
    rng = np.random.default_rng(seed)
    tokens, labels = (torch.from_numpy(rng.integers(0, cfg.vocab, (SH_B, SH_T)).astype(np.int32))
                      for _ in range(2))
    cache = TF.init_cache(cfg, SH_B, SH_T + 1)
    cache = SHD.shard_tree(cache, mesh, SH.cache_pspecs(cache, mesh, SH_B))
    step = STEPS.make_decode_step(cfg, mesh)
    with torch.inference_mode():
        prefill, cache = step(sp, cache, SHD.batch_rows(tokens, mesh), 0)
        decode, cache = step(sp, cache, SHD.batch_rows(labels[:, -1:], mesh), SH_T)
    logits = {"prefill": prefill.cpu(), "decode": decode.cpu()}
    del cache
    loss, aux, grads = STEPS.make_grad_fn(cfg, mesh=mesh)(sp, tokens, labels)
    grads = SU.full_tree(grads, "cpu")
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=5)
    sp, opt, m = STEPS.make_train_step(cfg, opt_cfg, mesh)(sp, adamw.init(sp), tokens, labels)
    if int(opt.step) != 1 or not all(isinstance(s, SU.Sharded) for s in tree_leaves(sp)):
        raise AssertionError(f"{cfg.name} sharded step on {dev}: state not sharded or no step")
    return {"loss": loss.cpu(), "aux": aux.cpu(), "grads": grads,
            "params": SU.full_tree(sp, "cpu"), "metrics": {k: torch.as_tensor(v).cpu()
                                                           for k, v in m.items()},
            "lr": float(m["lr"]), "logits": logits}


def updated_within(what: str, got, want, grads, lr: float, rtol: float = SH_RTOL) -> float:
    """Updated parameters ``got`` against ``want`` (whole, CPU): within rtol
    of each leaf's largest entry wherever the gradient ``grads`` is outside
    the gradient bar (rtol max|g| + 1e-6) of 0, and within that + 2 lr
    elsewhere (Adam's first step moves such an entry by ~lr sign(g), a sign
    the rounding does not fix).  Returns the worst gap over the bar."""
    import torch

    from repro_torch.util.tree import leaf_paths, leaves

    worst = 0.0
    for path, a, b, g in zip(leaf_paths(want), leaves(got), leaves(want), leaves(grads)):
        a, b, g = a.double(), b.double(), g.double()
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what} {path}: shape {tuple(a.shape)} or non-finite")
        bar = rtol * float(b.abs().max())
        fixed = g.abs() > rtol * float(g.abs().max()) + TR_ATOL
        gap = (a - b).abs()
        fixed_gap = float(torch.where(fixed, gap, 0).max())
        if fixed_gap > bar or float(gap.max()) > bar + 2 * lr:
            raise AssertionError(f"{what} {path}: updated parameter gap {fixed_gap:.3e} "
                                 f"(any entry {float(gap.max()):.3e}) over {bar:.3e}")
        worst = max(worst, fixed_gap / max(bar, 1e-30))
    return worst


def sharded_parity() -> dict:
    """Phase 23(a): the sharded step and serve steps at smoke width (qwen2 on
    data 2 x model 2, every layer tensor-parallel; jamba on 2 x 4, its
    experts expert-parallel, its MLPs, mamba mixers and vocabulary
    tensor-parallel, and on 2 x 2, its attention too; rwkv6 on 2 x 2, its
    time mix (one head a shard) and channel mix tensor-parallel) and
    moe_apply_ep, card shards against CPU shards at f32; and
    :func:`sharded_bf16_rounding`."""
    import torch

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import moe as MOE
    from repro_torch.util.tree import leaves

    t0 = time.perf_counter()
    out = {}
    for arch, layers, model in SH_SMOKE:
        cfg = get_smoke_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, layers=layers)
        cpu = sharded_smoke_step(cfg, "cpu", 0, model)
        card = sharded_smoke_step(cfg, "cuda", 0, model)
        logit_gap = {}
        for k, want in cpu["logits"].items():
            got = card["logits"][k]
            gap = (got.double() - want.double()).abs()
            over = float((gap / (SH_LOGIT_TOL + SH_LOGIT_TOL * want.double().abs())).max())
            if got.shape != want.shape or not over <= 1.0:
                raise AssertionError(f"[sharded] {arch} {k} logits on {SH_DATA} x {model}: "
                                     f"{float(gap.max()):.3e} from the CPU shards' ({over:.3f} of "
                                     f"{SH_LOGIT_TOL} + {SH_LOGIT_TOL}|cpu|)")
            logit_gap[k] = float(gap.max())
        check_within(f"[sharded] {arch} loss", card["loss"], cpu["loss"], TR_RTOL, TR_ATOL)
        check_within(f"[sharded] {arch} aux", card["aux"], cpu["aux"], TR_RTOL, TR_ATOL)
        for k in ("loss", "grad_norm", "lr"):
            check_within(f"[sharded] {arch} step {k}", card["metrics"][k], cpu["metrics"][k],
                         TR_RTOL, TR_ATOL)
        g_worst = max(check_within(f"[sharded] {arch} gradient leaf {i}", a, b, SH_RTOL, TR_ATOL)
                      / max(float(b.abs().max()), 1e-30)
                      for i, (a, b) in enumerate(zip(leaves(card["grads"]), leaves(cpu["grads"]))))
        p_worst = updated_within(f"[sharded] {arch}", card["params"], cpu["params"],
                                 cpu["grads"], cpu["lr"])
        out[f"{arch} {SH_DATA}x{model}"] = {"grad_worst": g_worst, "param_worst": p_worst,
                                            "logits": logit_gap}
        log(f"[sharded/parity] {arch} ({cfg.layers} layers) on {SH_DATA} x {model} shards: "
            f"prefill and decode logits within {SH_LOGIT_TOL} + {SH_LOGIT_TOL}|cpu| (max |card - "
            f"cpu| {logit_gap['prefill']:.3e}, {logit_gap['decode']:.3e}); "
            f"loss {float(card['loss']):.6f} (cpu {float(cpu['loss']):.6f}), "
            f"{len(leaves(card['grads']))} gradient leaves within {SH_RTOL} max|g| + {TR_ATOL} "
            f"(worst {g_worst:.3e} of its max), updated parameters within {SH_RTOL} of each "
            f"leaf's max where the gradient is determined (worst {p_worst:.3f} of the bar)")
    # expert parallelism alone: E=8 over model=4, x over data=2
    gen = torch.Generator().manual_seed(0)
    params = MOE.moe_init(gen, 64, 128, 8)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 16, 64)).astype(np.float32))
    ys = {}
    for dev in ("cpu", "cuda"):
        mesh = sharded_mesh(dev)
        p = {k: v.to(mesh.devices[0]) for k, v in params.items()}
        with torch.inference_mode():
            ys[dev] = [t.cpu() for t in MOE.moe_apply_ep(p, x.to(mesh.devices[0]), num_experts=8,
                                                           top_k=2, mesh=mesh)]
    out["moe_ep"] = check_within("[sharded] moe_apply_ep", ys["cuda"][0], ys["cpu"][0],
                                 SH_RTOL, TR_ATOL)
    check_within("[sharded] moe_apply_ep aux", ys["cuda"][1], ys["cpu"][1], SH_RTOL, TR_ATOL)
    out["bf16_tp"] = sharded_bf16_rounding()
    log(f"[sharded/parity] moe_apply_ep (8 experts over model 4, 4 x 16 tokens over data 2): "
        f"max |card - cpu| {out['moe_ep']:.3e}; {time.perf_counter() - t0:.1f} s")
    return out


def sharded_bf16_rounding() -> dict:
    """Phase 23(a) at bf16: granite smoke (2 layers) on data 2 x model 2 card
    shards, attention, MLP and vocabulary tensor-parallel, against the same
    steps on one card device: the logits of a prefill and of one decode
    step equal bit for bit.  A tensor-parallel layer rounds where one
    device's layer rounds (the row blocks' partial outputs summed unrounded
    in float32, cast once), and at this size the card's GEMMs of the blocks
    keep one device's bits; a partial rounded to bf16 before the sum moves
    most logits by one to three bf16 steps."""
    import torch

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import sharded as SHD
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import transformer as TF
    from repro_torch.util.tree import tree_map

    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), layers=2, dtype="bfloat16")
    params = TF.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (SH_B, SH_T + 1))
                            .astype(np.int32))
    mesh = sharded_mesh("cuda", SH_DATA, 2)
    runs = {}
    for where in ("one device", "shards"):
        cache = TF.init_cache(cfg, SH_B, SH_T + 1)
        if where == "shards":
            p, rows = SHD.shard_tree(params, mesh), (lambda t: SHD.batch_rows(t, mesh))
            cache = SHD.shard_tree(cache, mesh, SH.cache_pspecs(cache, mesh, SH_B))
            step = STEPS.make_decode_step(cfg, mesh)
        else:
            p, rows = tree_map(lambda t: t.cuda(), params), (lambda t: t.cuda())
            cache = tree_map(lambda t: t.cuda(), cache)
            step = STEPS.make_decode_step(cfg)
        with torch.inference_mode():
            pre, cache = step(p, cache, rows(toks[:, :SH_T]), 0)
            dec, cache = step(p, cache, rows(toks[:, SH_T:]), SH_T)
        runs[where] = torch.cat([pre, dec], 1).float().cpu()
    one, tp = runs["one device"], runs["shards"]
    if tp.dtype != one.dtype or not torch.equal(tp, one):
        raise AssertionError(f"[sharded] bf16 granite smoke on {SH_DATA} x 2: logits differ from "
                             f"one device's at {int((tp != one).sum())} of {one.numel()}, max "
                             f"{float((tp - one).abs().max()):.3e}")
    log(f"[sharded/parity] bf16 granite smoke (2 layers) on {SH_DATA} x 2 card shards, every "
        f"layer tensor-parallel: prefill and decode logits ({one.numel()}) equal bit for bit to "
        f"one card device's")
    return {"logits": one.numel()}


def sharded_granite(mem_rate: float, bf16_rate: float, phase22: dict) -> dict:
    """Phase 23(b): granite-3-2b at full width and depth, bf16, 2 steps of
    the trainer on data 2 x model 4 shards on the one card, from phase
    22(b)'s seed and batches; each loss within 1e-2 of phase 22(b)'s."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import sharding as SH
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import trainer as TR
    from repro_torch.util import sharded as SU
    from repro_torch.util.tree import leaves, tree_map

    arch, B, S, steps22 = TR_GRANITE
    cfg = get_config(arch)
    tag = f"[sharded/{arch}]"
    mesh = sharded_mesh("cuda")
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=steps22)
    data = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = TR.init_state(cfg, mesh, seed=0)
    t_init = time.perf_counter() - t0
    n_params = sum(s.numel() for s in leaves(state.params))
    meta = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), state.params)
    want = SH.state_bytes_per_device(meta, SH.params_shardings(meta, mesh), mesh)
    held = [sum(v) for v in zip(*(SU.bytes_per_shard(t, mesh) for t in
                                  (state.params, state.opt_state.mu, state.opt_state.nu)))]
    splits = {}
    for s in leaves(state.params):
        splits[len(s.pieces)] = splits.get(len(s.pieces), 0) + 1
    emb = state.params["embedding"]
    metrics = []
    t0 = time.perf_counter()
    state = TR.train(cfg, opt_cfg, data, TR.TrainerConfig(steps=SH_STEPS, log_every=SH_STEPS),
                     mesh, state=state, metrics_out=metrics)
    t_run = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    ref = phase22["losses"][:SH_STEPS]
    gaps = [abs(a - b) for a, b in zip(losses, ref)]
    if len(losses) != SH_STEPS or not all(np.isfinite(losses)) or max(gaps) > SH_LOSS_TOL:
        raise AssertionError(f"{tag} sharded losses {losses} against phase 22(b)'s {ref}: gaps "
                             f"{gaps} over {SH_LOSS_TOL}")
    step_ms = float(np.median([m["time_s"] for m in metrics[1:]])) * 1e3
    comp_ms, opt_ms = step_bound_ms(n_params, B * S, mem_rate, bf16_rate)
    log(f"{tag} {n_params / 1e9:.3f} G parameters on data {SH_DATA} x model {SH_MODEL} shards "
        f"(one card); leaves by pieces {dict(sorted(splits.items()))}; embedding spec "
        f"{tuple(emb.spec)} (padded vocabulary {cfg.padded_vocab}); init + shard {t_init:.1f} s")
    log(f"{tag} bytes of params + mu + nu per shard: max {max(held) / 2**30:.3f} GiB, min "
        f"{min(held) / 2**30:.3f} GiB, mean {sum(held) / len(held) / 2**30:.3f} GiB (a block "
        f"stored once, on its first shard); state_bytes_per_device (every replica, x5 of the "
        f"bf16 params) {want / 2**30:.3f} GiB")
    log(f"{tag} {SH_STEPS} steps at B={B} S={S}: losses " + ", ".join(f"{v:.4f}" for v in losses)
        + f" against phase 22(b)'s " + ", ".join(f"{v:.4f}" for v in ref)
        + f" (|gap| max {max(gaps):.2e}, bar {SH_LOSS_TOL}); grad_norm "
        + ", ".join(f"{m['grad_norm']:.3f}" for m in metrics)
        + f"; steps " + ", ".join(f"{m['time_s'] * 1e3:.1f}" for m in metrics)
        + f" ms, {step_ms:.1f} ms the median of steps 2-{SH_STEPS}, against phase 22(b)'s "
        f"one-device {phase22['step_ms']:.1f} ms and the least {comp_ms + opt_ms:.1f} ms; peak "
        f"{peak / 2**30:.2f} GiB allocated (one device: {phase22['peak'] / 2**30:.2f} GiB); "
        f"{t_run:.1f} s; {loadavg()}")
    del state, meta
    free_cuda()
    return {"step_ms": step_ms, "peak": peak, "losses": losses, "gaps": gaps,
            "held_max": max(held), "held_min": min(held), "state_bytes": want}


def sharded_granite_f32() -> dict:
    """Phase 23(c): granite-3-2b at full width cut to 2 layers, f32 (TF32
    off): the sharded step and the one-device step from the same weights,
    every gradient and updated leaf."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, global_batch_array
    from repro_torch.launch import sharded as SHD
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adamw
    from repro_torch.util import sharded as SU
    from repro_torch.util.tree import leaves, tree_map

    arch, B, S, _ = TR_GRANITE
    cfg = dataclasses.replace(get_config(arch), layers=2, dtype="float32")
    tag = f"[sharded/{arch} f32]"
    t0 = time.perf_counter()
    mesh = sharded_mesh("cuda")
    one_mesh = sharded_mesh("cuda", 1, 1)
    data = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=8)
    params = TF.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    sp = SHD.shard_tree(params, mesh)
    tokens, labels = global_batch_array(data, 0, mesh)
    t1, l1 = global_batch_array(data, 0, one_mesh)
    loss_s, _, g_s = STEPS.make_grad_fn(cfg, mesh=mesh)(sp, tokens, labels)
    loss_1, _, g_1 = STEPS.make_grad_fn(cfg)(params, t1, l1)
    g_s = SU.full_tree(g_s, "cpu")
    g_1 = tree_map(lambda t: t.cpu(), g_1)
    check_within(f"{tag} loss", loss_s, loss_1, TR_RTOL, TR_ATOL)
    g_worst = max(check_within(f"{tag} gradient leaf {i}", a, b, SH_RTOL, TR_ATOL)
                  / max(float(b.abs().max()), 1e-30)
                  for i, (a, b) in enumerate(zip(leaves(g_s), leaves(g_1))))
    sp, _, m_s = STEPS.make_train_step(cfg, opt_cfg, mesh)(sp, adamw.init(sp), tokens, labels)
    params, _, m_1 = STEPS.make_train_step(cfg, opt_cfg, one_mesh)(params, adamw.init(params),
                                                                  t1, l1)
    check_within(f"{tag} grad_norm", m_s["grad_norm"], m_1["grad_norm"], TR_RTOL, TR_ATOL)
    p_worst = updated_within(tag, SU.full_tree(sp, "cpu"),
                             tree_map(lambda t: t.cpu(), params), g_1, float(m_1["lr"]))
    n = len(leaves(params))
    log(f"{tag} B={B} S={S}: loss {float(loss_s):.6f} sharded, {float(loss_1):.6f} one device; "
        f"{n} gradient leaves within {SH_RTOL} max|g| + {TR_ATOL} (worst {g_worst:.3e} of its "
        f"max); {n} updated leaves within {SH_RTOL} of the leaf's max where the gradient is "
        f"determined (worst {p_worst:.3f} of the bar); {time.perf_counter() - t0:.1f} s")
    del params, sp, g_s, g_1
    free_cuda()
    return {"grad_worst": g_worst, "param_worst": p_worst}


class EPDrops:
    """Counts, while on, the routings ``moe.csr_dispatch_plan`` drops over
    capacity, leaving out expert parallelism's dummy bin (the last expert id
    of a plan built with one more bin than the shard's experts, as
    ``moe_apply_ep`` builds it); device tensors, no synchronisation."""

    def __init__(self, moe_module, ep: bool):
        self.moe, self.plan, self.ep = moe_module, moe_module.csr_dispatch_plan, ep
        self.dropped = []

    def __enter__(self):
        def plan(expert_idx, num_experts, capacity):
            dest, keep, row_ptr = self.plan(expert_idx, num_experts, capacity)
            real = expert_idx.reshape(-1) < num_experts - 1 if self.ep else True
            self.dropped.append((~keep & real).sum())
            return dest, keep, row_ptr
        self.moe.csr_dispatch_plan = plan
        return self

    def __exit__(self, *exc):
        self.moe.csr_dispatch_plan = self.plan

    def total(self) -> int:
        return sum(int(v) for v in self.dropped)


def map_leaves_(tree, fn, path=()):
    """Replace each leaf of a dict/list tree by ``fn(path, leaf)`` in place,
    leaf by leaf, releasing each old leaf's memory to the device as it goes
    (two full copies of a full-width model do not fit beside each other);
    returns the tree."""
    import torch

    for k in list(tree.keys()) if isinstance(tree, dict) else range(len(tree)):
        if isinstance(tree[k], (dict, list)):
            map_leaves_(tree[k], fn, path + (k,))
        else:
            big = tree[k].numel() * tree[k].element_size() >= 1 << 26
            tree[k] = fn(path + (k,), tree[k])
            if big:
                torch.cuda.empty_cache()
    return tree


def sharded_forced(cfg, sp, prompts, seq, mesh, pieces: bool = True):
    """Logits [B, G+1, V] of a prefill of ``prompts`` into a cache in pieces
    (cut by ``cache_spec``), then one decode step per token of ``seq`` after
    the prompt (teacher forcing), all through ``make_decode_step(cfg,
    mesh)`` on ``Sharded`` params ``sp``, cache and token rows; the cache,
    and the host seconds of the decode steps.  With ``pieces`` False,
    ``sp``, the cache and the tokens are whole tensors (the mesh for expert
    parallelism only)."""
    import torch

    from repro_torch.launch import sharded as SHD
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import transformer as TF

    B, P = prompts.shape
    G = seq.shape[1] - P
    cache = TF.init_cache(cfg, B, P + G, device=prompts.device)
    rows = (lambda t: SHD.batch_rows(t, mesh)) if pieces else (lambda t: t)
    if pieces:
        cache = SHD.shard_tree(cache, mesh, SH.cache_pspecs(cache, mesh, B))
    step = STEPS.make_decode_step(cfg, mesh)
    logits, cache = step(sp, cache, rows(prompts), 0)
    outs = [logits[:, -1]]
    del logits
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(G):
        logits, cache = step(sp, cache, rows(seq[:, P + i:P + i + 1]), P + i)
        outs.append(logits[:, 0])
    torch.cuda.synchronize()
    return torch.stack(outs, 1)[..., :cfg.vocab], cache, time.perf_counter() - t0


def position_rms(x, f32):
    """At each position (b, t) of [B, T, V] logits ``x``, the RMS over the
    vocabulary of their distance from ``f32``: [B, T]."""
    return (x.float() - f32.float()).square().mean(-1).sqrt()


def pieces_rms_ratio(pieces, one, f32):
    """Rank by rank, the ratios of the per-position RMS distances of
    ``pieces`` and of ``one`` from ``f32`` (:func:`position_rms`): the
    largest position of the pieces over the largest of one device, the
    second over the second, and so on ([B x T], from the largest RMS
    down)."""
    import torch

    desc = lambda x: torch.sort(position_rms(x, f32).flatten(), descending=True).values
    return desc(pieces) / torch.clamp(desc(one), min=torch.finfo(torch.float32).tiny)


def pieces_rms_bar(pieces, one, f32, tag: str = ""):
    """The bar for bf16 logits [B, T, V] computed on pieces: at each position
    the RMS over the vocabulary of their distance from ``f32``, the
    one-device f32 full forward's logits, and of ``one``'s, one device's
    bf16 logits on the same weights and tokens; ranked from the largest
    down, each of the pieces' at most ``LM_PIECES_RMS`` times one device's
    of the same rank (:func:`pieces_rms_ratio`).  An RMS over the
    vocabulary is steady where a maximum is one draw of the rounding noise,
    and a fault confined to one position, one head or one shard's
    vocabulary block moves that position's RMS up the ranks as far as it
    stands out of one device's own bf16 noise (on the card a block scaled by
    1 + 2^-6 does not, nor a dropped head of jamba or rwkv6: PERF.md
    section 6; the f32 bar of :func:`forced_checks` holds those).  The ranks, not the positions, are
    matched: where bf16 noise turns a MoE routing, one position's RMS rises
    several times, and two runs of one device turn it at different
    positions (a jamba period's decode and full forward: 4.5 times apart at
    one position).  Returns the ratios; raises where one exceeds the bar."""
    ratio = pieces_rms_ratio(pieces, one, f32)
    if not bool((ratio <= LM_PIECES_RMS).all()):
        raise AssertionError(f"{tag} bf16 logits on pieces: RMS distance from the f32 forward "
                             f"{float(ratio.max()):.3f} times one device's of the same rank, "
                             f"over {LM_PIECES_RMS} (at {int((ratio > LM_PIECES_RMS).sum())} of "
                             f"{ratio.numel()} ranks)")
    return ratio


def planted_faults(x, f32, shards: int, layers: int, heads: int) -> dict:
    """Three faults planted into copies of [B, T, V] logits ``x`` (B >= 2,
    T >= 4), each of the kind a wrong piece would make: one position's
    logits taken from another; one position's block of the vocabulary that
    one of ``shards`` model shards holds scaled by 1 + 2^-6; one head of one
    layer left out, a rank-1 change (a direction over the vocabulary, a
    numpy-seeded size at each position) of the RMS that one of the
    2 x ``layers`` x ``heads`` sublayer-head contributions adds to the
    logits of ``f32``."""
    import torch

    B, T, V = x.shape
    position = x.clone()
    position[B - 1, T // 2] = x[B - 1, T - 1]
    block = x.clone()
    blk = -(-V // shards)
    block[0, T // 4, 2 * blk:3 * blk] *= 1 + 2.0 ** -6
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.standard_normal((B, T, 1), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((V,), dtype=np.float32))
    size = float(f32.float().square().mean().sqrt()) / np.sqrt(2 * layers * heads)
    head = (x.float() + size * u.to(x.device) * v.to(x.device)).to(x.dtype)
    return {"position_from_another": position, "shard_block_scaled": block,
            "head_dropped": head}


#: how a caller of :func:`forced_checks` logs its bars
PIECES_BAR_WHAT = (f"per position, the RMS over the vocabulary of the distance from phase 21's f32 "
                   f"full forward, rank by rank at most {{rms_ratio:.3f}} times one device's bf16 "
                   f"decode's (bar {LM_PIECES_RMS}); argmax = the next one-device token at all "
                   f"{{checked}} positions whose margin exceeds twice the f32 bound plus twice one "
                   f"device's largest bf16 distance from f32 there ({LM_B * (LM_G + 1)} "
                   f"positions; that distance covers every margin: {{covered}}); at f32 the "
                   f"forward's argmax at all {{checked32}} positions whose margin exceeds twice the "
                   f"f32 bound; faults planted into the pieces' logits read (bf16 bar / f32 bar, "
                   f"each over its bound where past 1; the f32 must be) {{planted}}")


def forced_checks(tag, cfg, mesh, phase21: dict, drops=None, whole_too: bool = False) -> dict:
    """Phase 23(d), (f) and (g): ``cfg``'s state in pieces on ``mesh``, from
    phase 21's seed and prompts: at bf16 teacher-forced with phase 21's
    one-device tokens, the logits held by :func:`pieces_rms_bar` against
    phase 21's one-device bf16 decode logits and its f32 full forward on the
    same weights and tokens (the tensor-parallel layers round where one
    device rounds, but at full width the card's GEMMs of a shard's heads add
    in another order than those of all heads, which moves bf16 logits as
    much as one device's own rounding does), and argmax = the next token at
    every position where phase 21's top-2 margin exceeds twice the f32
    bound plus twice one device's largest bf16 distance from the f32
    forward at that position, at one position at least unless that
    distance covers the margin at every position (rwkv6's bf16 noise; the
    flips at twice the f32 bound alone are logged); the state bytes of each
    shard equal to the dry run's ``state_bytes_per_device`` for the same
    placement (on distinct ``meta`` devices); at f32 every position within
    2e-3 + 2e-3 |logit| of the one-device f32 full forward (its weights the
    pieces made whole, which are the one-device weights bit for bit), and
    its argmax wherever the forward's top-2 margin exceeds twice that, at
    one position at least.  The three faults of :func:`planted_faults`,
    planted into copies of the pieces' logits, must each go past the f32
    bar; the bf16 bar's readings of them are logged (on the card a scaled
    block, and jamba's and rwkv6's dropped head, lie within one device's
    bf16 noise).
    ``drops``: an ``EPDrops`` factory, for MoE.  ``whole_too``: the bf16
    steps also run on the same state whole (``make_decode_step(cfg, mesh)``
    on whole tensors, the mesh for expert parallelism only, no tensor
    parallelism), and their logits must equal phase 21's one-device logits
    bit for bit; their distance from the pieces' is returned."""
    import contextlib

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import sharded as SHD
    from repro_torch.launch import steps as STEPS
    from repro_torch.launch.mesh import make_meta_mesh
    from repro_torch.models import transformer as TF
    from repro_torch.models.config import ShapeConfig

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    counted = drops or (lambda ep: contextlib.nullcontext())
    toks, ref = phase21["tokens"].cuda(), phase21["logits"]           # [B, G+1], [B, G+1, V]
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        params, prompts = lm_seeded(cfg, 0, LM_B, LM_P)
        seq = torch.cat([prompts, toks[:, :-1]], dim=1)                 # P + G tokens
        whole16, drops_whole = None, None
        if whole_too:
            with counted(True) as drops_whole:
                whole16, _, _ = sharded_forced(cfg, params, prompts, seq, mesh, pieces=False)
        sp = SHD.shard_tree_(params, mesh)
        with counted(True) as drops16:
            out16, cache, t_dec = sharded_forced(cfg, sp, prompts, seq, mesh)
        # the last decode step once more (its token and position again, so the
        # cache keeps its values) under the profiler: the device work of a step
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            STEPS.make_decode_step(cfg, mesh)(sp, cache, SHD.batch_rows(seq[:, -1:], mesh),
                                              seq.shape[1] - 1)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        work = {"kernels": len(kernels), "busy_ms": sum(e.device_time_total for e in kernels) / 1e3}
    peak16 = torch.cuda.max_memory_allocated()
    out16 = out16.float().cpu()
    gap_whole = None
    if whole16 is not None:
        whole16 = whole16.float().cpu()
        if not torch.equal(whole16, ref):
            raise AssertionError(f"{tag} bf16: the steps on whole state differ from phase 21's "
                                 f"one-device steps by {float((whole16 - ref).abs().max()):.3e}")
        gap_whole = float((whole16 - out16).abs().max())
    del whole16
    gap16 = float((out16 - ref).abs().max())
    if phase21["full32"] is None:
        raise AssertionError(f"{tag} phase 21 has no f32 full forward to hold the pieces against")
    full32 = phase21["full32"]
    ratio = pieces_rms_bar(out16, ref, full32, tag=tag)
    # logged beside the bar: the same ratio position by position, and that of
    # one device's two runs (its decode steps, its full forward); the bar's
    # readings of three faults planted into the pieces' logits
    same = position_rms(out16, full32) / position_rms(ref, full32)
    ones = phase21["rms_full16"] / position_rms(ref, full32)
    plant = lambda x, f: planted_faults(x, f, mesh.shape["model"], TF.num_layers(cfg),
                                        cfg.num_heads)
    planted16 = {k: float(pieces_rms_ratio(x, ref, full32).max())
                 for k, x in plant(out16, full32).items()}
    log(f"{tag} bf16 on pieces: per-position RMS over the vocabulary of the distance from phase "
        f"21's f32 full forward, rank by rank over one device's: max {float(ratio.max()):.4f}, "
        f"median {float(ratio.median()):.4f}, min {float(ratio.min()):.4f} (bar "
        f"{LM_PIECES_RMS}); position by position {float(same.min()):.4f}-"
        f"{float(same.max()):.4f}; one device's full forward over its decode steps, position by "
        f"position, {float(ones.min()):.4f}-{float(ones.max()):.4f}; max |pieces - one device| "
        f"{gap16:.4f}; planted into the pieces' logits, the bar reads "
        + ", ".join(f"{k} {v:.4f}" for k, v in planted16.items()))
    tol = LM_DECODE_TOL + LM_DECODE_TOL * ref.abs()
    top2 = ref.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    # the allowance: one device's own bf16 distance from f32 at the position,
    # for each of the two runs; at least one position checked unless that
    # distance covers the margin at every position (rwkv6's bf16 noise)
    dist = (ref - full32).abs().amax(-1)
    checked = margin > 2 * tol.amax(-1) + 2 * dist
    covered = bool((dist >= margin).all())
    agree = out16.argmax(-1) == toks.cpu()
    if bool((checked & ~agree).any()) or not (int(checked.sum()) or covered):
        raise AssertionError(f"{tag} bf16: argmax differs from the one-device token at "
                             f"{int((checked & ~agree).sum())} of {int(checked.sum())} positions "
                             f"whose one-device top-2 margin exceeds twice the bound plus twice "
                             f"one device's largest distance from f32 there (none checked, and "
                             f"that distance covers every margin: {covered})")
    at_f32 = margin > 2 * tol.amax(-1)
    f32_flips = (int((at_f32 & ~agree).sum()), int(at_f32.sum()),
                 [round(float(m), 4) for m in margin[at_f32 & ~agree]])
    S = LM_P + LM_G
    rows = SHD.batch_rows(torch.zeros(LM_B, 1, dtype=torch.int32, device=mesh.devices[0]), mesh)
    state = DR.state_bytes_per_device({"params": sp, "cache": cache, "tokens": rows,
                                       "cache_index": S - 1}, "decode", mesh)
    meta = make_meta_mesh(tuple(mesh.shape.values()), mesh.axis_names)
    with FakeTensorMode():
        fake, _ = STEPS.input_specs(cfg, ShapeConfig("forced_decode", S, LM_B, "decode"), meta)
        want = DR.state_bytes_per_device(fake, "decode", meta)
    if state != want:
        raise AssertionError(f"{tag} state bytes per shard {state} against the dry run's {want}")
    del cache, rows
    # f32: the one-device full forward on the pieces made whole, then the
    # steps on the same weights in pieces (the tree is converted in place)
    whole = map_leaves_(sp, lambda _, s: s.full().float())
    with torch.inference_mode():
        with counted(False) as drops_full:
            full = TF.forward(whole, seq, cfg32)[0][:, LM_P - 1:, :cfg.vocab]
        sp32 = SHD.shard_tree_(whole, mesh)
        free_cuda()
        with counted(True) as drops32:
            out32, _, _ = sharded_forced(cfg32, sp32, prompts, seq, mesh)
    tol32 = LM_DECODE_TOL + LM_DECODE_TOL * full.abs()
    gap32 = (out32 - full).abs()
    over = float((gap32 / tol32).max())
    if out32.dtype != torch.float32 or over > 1.0:
        raise AssertionError(f"{tag} f32: logits {float(gap32.max()):.3e} from the one-device "
                             f"full forward, {over:.3f} of {LM_DECODE_TOL} + "
                             f"{LM_DECODE_TOL}|logit|")
    planted32 = {k: float(((x - full).abs() / tol32).max()) for k, x in plant(out32, full).items()}
    if min(planted32.values()) <= 1.0:
        raise AssertionError(f"{tag} f32: a fault planted into the pieces' logits stays within "
                             f"the bar: " + ", ".join(f"{k} {v:.3f}" for k, v in planted32.items())
                             + " of it")
    top32 = full.topk(2, dim=-1).values
    checked32 = (top32[..., 0] - top32[..., 1]) > 2 * tol32.amax(-1)
    agree32 = out32.argmax(-1) == full.argmax(-1)
    if not int(checked32.sum()) or bool((checked32 & ~agree32).any()):
        raise AssertionError(f"{tag} f32: argmax = the one-device full forward's at "
                             f"{int((checked32 & agree32).sum())} of {int(checked32.sum())} "
                             f"positions whose top-2 margin exceeds twice the bound")
    del sp32, full, out32
    return {"decode_ms": t_dec * 1e3 / LM_G, "peak": peak16, "checked": int(checked.sum()),
            "rms_ratio": float(ratio.max()), "rms_ratios": ratio, "gap16": gap16,
            "checked32": int(checked32.sum()), "gap32": float(gap32.max()),
            "over": over, "state": state, "gap_whole": gap_whole, "work": work,
            "f32_flips": f32_flips, "covered": covered,
            "planted": ", ".join(f"{k} {planted16[k]:.3f} / {planted32[k]:.1f}" for k in planted16),
            "drops": {"bf16": drops16, "f32": drops32, "full": drops_full,
                      "whole": drops_whole}}


def forced_work_log(tag: str, r: dict) -> None:
    """The device work of one decode step on pieces and the argmax flips at
    the f32 bound alone, from :func:`forced_checks`."""
    w, (flips, at, margins) = r["work"], r["f32_flips"]
    log(f"{tag} a decode step on pieces launches {w['kernels']} kernels that keep the card busy "
        f"{w['busy_ms']:.3f} ms (torch.profiler): {w['busy_ms'] / r['decode_ms']:.1%} of the "
        f"step, idle {1 - w['busy_ms'] / r['decode_ms']:.1%}; bf16 argmax differs from the "
        f"one-device token at {flips} of the {at} positions whose margin exceeds twice the f32 "
        f"bound alone (one-device margins there {margins}; logged: the shards' GEMMs add in "
        f"another order)")


def sharded_jamba_ep(phase21: dict) -> dict:
    """Phase 23(d): one jamba period at full width, its state in pieces on
    data 1 x model 4, the MoE layers expert-parallel (4 experts a shard, the
    expert leaves kept as their model pieces), attention, MLP, the seven
    mamba mixers (128 heads, 32 a shard) and vocabulary tensor-parallel,
    from phase 21's seed and prompts: the bars
    of ``forced_checks``, and the bf16 steps on the same state whole (the
    experts split on every call) equal to phase 21's one-device steps bit
    for bit."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TF

    arch = "jamba-v0.1-52b"
    cfg = dataclasses.replace(get_config(arch), layers=dict(LM_FULL)[arch])
    tag = f"[sharded/{arch} ep]"
    mesh = sharded_mesh("cuda", 1, SH_EP_MODEL)
    t0 = time.perf_counter()
    free_cuda()
    r = forced_checks(tag, cfg, mesh, phase21, drops=lambda ep: EPDrops(MOE, ep=ep),
                      whole_too=True)
    d = r["drops"]
    log(f"{tag} {TF.num_layers(cfg)} layers, {cfg.num_experts} experts over model "
        f"{SH_EP_MODEL} (data 1), attention, MLP, mamba mixers and vocabulary tensor-parallel, "
        f"params and cache in pieces; B={LM_B} P={LM_P} G={LM_G}: the same steps on whole state "
        f"(the experts "
        f"split on every call, MoE drops {d['whole'].total()}) equal phase 21's one-device "
        f"logits bit for bit, max |whole - pieces| {r['gap_whole']:.3f} at bf16; bf16 "
        f"teacher-forced with phase 21's tokens: max |EP - one device| {r['gap16']:.3f}; "
        f"{PIECES_BAR_WHAT.format(**r)}; f32 within "
        f"{LM_DECODE_TOL} + "
        f"{LM_DECODE_TOL}|logit| of the one-device full forward at every position (max |gap| "
        f"{r['gap32']:.3e}, {r['over']:.3f} of the bound); MoE drops: EP bf16 "
        f"{d['bf16'].total()}, EP f32 {d['f32'].total()}, one-device f32 forward "
        f"{d['full'].total()}")
    log(f"{tag} state bytes per shard " + ", ".join(str(v) for v in r["state"])
        + " = the dry run's state_bytes_per_device on 1 x 4 meta devices")
    log(f"{tag} decode {r['decode_ms']:.3f} ms/step with EP and TP (bf16, teacher-forced) "
        f"against phase 21's one-device {phase21['decode_ms']:.3f} ms/step; peak "
        f"{r['peak'] / 2**30:.2f} GiB allocated (bytes moved a step: phase 24's dry run of "
        f"this cell); {time.perf_counter() - t0:.1f} s")
    forced_work_log(tag, r)
    free_cuda()
    return {"decode_ms": r["decode_ms"], "over": r["over"],
            "drops": d["bf16"].total() + d["f32"].total() + d["whole"].total(),
            "peak": r["peak"], "gap_whole": r["gap_whole"]}


def sharded_granite_serve(phase21: dict) -> dict:
    """Phase 23(f): granite-3-2b greedy serving at full width (40 layers),
    params, cache and token rows in pieces on data 2 x model 4 shards of
    the card, attention (32 heads, 8 kv heads), MLP and vocabulary
    tensor-parallel over model, from phase 21's seed and prompts: the bars
    of ``forced_checks``, and the state bytes of each shard equal to the
    dry run's ``state_bytes_per_device`` for the same placement."""
    from repro_torch.configs.registry import get_config

    arch = "granite-3-2b"
    cfg = get_config(arch)
    tag = f"[sharded/{arch} serve]"
    mesh = sharded_mesh("cuda")
    t0 = time.perf_counter()
    free_cuda()
    r = forced_checks(tag, cfg, mesh, phase21)
    card = r["state"]
    log(f"{tag} {cfg.layers} layers, d_model {cfg.d_model}, params, cache ({LM_P + LM_G} positions) and "
        f"token rows in pieces on data {SH_DATA} x model {SH_MODEL} (one card); B={LM_B} P={LM_P} "
        f"G={LM_G}: bf16 teacher-forced with phase 21's tokens: max |sharded - one device| "
        f"{r['gap16']:.3f}; "
        f"{PIECES_BAR_WHAT.format(**r)}; f32 "
        f"within {LM_DECODE_TOL} + {LM_DECODE_TOL}|logit| of the one-device full forward at "
        f"every position (max |gap| {r['gap32']:.3e}, {r['over']:.3f} of the bound)")
    log(f"{tag} state bytes per shard " + ", ".join(str(v) for v in card)
        + f" = the dry run's state_bytes_per_device on {SH_DATA} x {SH_MODEL} meta devices "
        f"(max {max(card) / 2**30:.3f} GiB, shard 0; {sum(card) / 2**30:.3f} GiB in all)")
    log(f"{tag} decode {r['decode_ms']:.3f} ms/step (bf16, teacher-forced, 2 units of "
        f"{LM_B // SH_DATA} rows, each model shard its blocks of each layer, its K/V in place) "
        f"against phase 21's one-device {phase21['decode_ms']:.3f} ms/step; peak "
        f"{r['peak'] / 2**30:.2f} GiB allocated (phase 21 run 2: "
        f"{phase21['peak_bytes'] / 2**30:.2f} GiB; bytes moved a step: phase 24's dry run of "
        f"this cell); {time.perf_counter() - t0:.1f} s")
    forced_work_log(tag, r)
    free_cuda()
    return {"decode_ms": r["decode_ms"], "over": r["over"], "peak": r["peak"],
            "state": card}


def sharded_rwkv_serve(phase21: dict) -> dict:
    """Phase 23(g), serving: rwkv6-3b greedy serving at full width (32
    layers), params, cache and token rows in pieces on data 2 x model 4
    shards of the card, every layer tensor-parallel over model (40 heads,
    10 a shard; d_ff 8960), from phase 21's seed and prompts: the bars of
    ``forced_checks`` (the recurrent state in its ``cache_spec`` cut, each
    shard scanning its heads' slice), and the state bytes of each shard
    equal to the dry run's ``state_bytes_per_device``.  rwkv6's bf16 logits
    move far under any reordering of additions (its per-head group norm and
    decay magnify a rounding step by step; on an H100 a data split alone,
    data 2 x model 1 with no tensor parallelism, put their largest distance
    from one device's at 1.41 against phase 21's largest decode-versus-forward
    gap of 1.36), which the per-position RMS bar reads as noise of one
    device's size."""
    from repro_torch.configs.registry import get_config

    arch = "rwkv6-3b"
    cfg = get_config(arch)
    tag = f"[sharded/{arch} serve]"
    mesh = sharded_mesh("cuda")
    t0 = time.perf_counter()
    free_cuda()
    r = forced_checks(tag, cfg, mesh, phase21)
    log(f"{tag} {cfg.layers} layers, d_model {cfg.d_model}, {cfg.num_heads} heads; params, "
        f"recurrent state and token rows in pieces on data {SH_DATA} x model {SH_MODEL} (one "
        f"card), time mix and channel mix tensor-parallel; B={LM_B} P={LM_P} G={LM_G}: bf16 "
        f"teacher-forced with phase 21's tokens: max |sharded - one device| {r['gap16']:.3f} "
        f"(phase 21's largest decode-versus-forward gap {phase21['bf16_gap']:.4f}); "
        f"{PIECES_BAR_WHAT.format(**r)}; f32 within "
        f"{LM_DECODE_TOL} + "
        f"{LM_DECODE_TOL}|logit| of the one-device full forward at every position (max |gap| "
        f"{r['gap32']:.3e}, {r['over']:.3f} of the bound)")
    log(f"{tag} state bytes per shard " + ", ".join(str(v) for v in r["state"])
        + f" = the dry run's state_bytes_per_device on {SH_DATA} x {SH_MODEL} meta devices")
    log(f"{tag} decode {r['decode_ms']:.3f} ms/step (bf16, teacher-forced, 2 units of "
        f"{LM_B // SH_DATA} rows, each model shard its heads) against phase 21's one-device "
        f"{phase21['decode_ms']:.3f} ms/step ({phase21['step_kernels']:.0f} kernels, busy "
        f"{phase21['step_busy_ms']:.3f} ms); peak {r['peak'] / 2**30:.2f} GiB allocated (phase "
        f"21 run 2: {phase21['peak_bytes'] / 2**30:.2f} GiB); {time.perf_counter() - t0:.1f} s")
    forced_work_log(tag, r)
    free_cuda()
    return {"decode_ms": r["decode_ms"], "over": r["over"], "peak": r["peak"],
            "state": r["state"], "work": r["work"]}


def sharded_rwkv_train(mem_rate: float, bf16_rate: float, phase22: dict) -> dict:
    """Phase 23(g), training: rwkv6-3b at full width, bf16, on data 2 x
    model 4 shards of the card, every layer tensor-parallel, phase 22(c)'s
    depth, shape (B=2 x S=1024), weights and batches: the first loss within
    1e-2 of phase 22's one-device first loss (the reference's bar), the
    later ones finite (logged: rwkv6's bf16 gradients lie far from its f32
    ones, so later steps part from one device's); the first step profiled
    (kernels a step and device-busy ms; the profiler doubles its wall
    time), the second timed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, global_batch_array
    from repro_torch.launch import sharded as SHD
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adamw
    from repro_torch.util.tree import leaves

    arch, B, S, steps22 = TR_RWKV
    cfg = dataclasses.replace(get_config(arch), layers=TR_RWKV_LAYERS)
    tag = f"[sharded/{arch} train]"
    mesh = sharded_mesh("cuda")
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sp = SHD.shard_tree_(TF.init_params(torch.Generator(device="cuda").manual_seed(0), cfg),
                         mesh)
    opt = adamw.init(sp)
    n_params = sum(s.numel() for s in leaves(sp))
    step = STEPS.make_train_step(cfg, adamw.AdamWConfig(lr=3e-4, warmup_steps=1,
                                                        total_steps=steps22), mesh)
    data = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    losses, times = [], []
    for s in range(SH_RWKV_STEPS):
        tokens, labels = global_batch_array(data, s, mesh)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if s == 0:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                sp, opt, m = step(sp, opt, tokens, labels)
                torch.cuda.synchronize()
            # the raw records: building the profiler's event tree for half a
            # million kernels would take longer than the step
            kernels = [e.duration_ns() for e in prof.profiler.kineto_results.events()
                       if e.device_type() == DeviceType.CUDA]
        else:
            sp, opt, m = step(sp, opt, tokens, labels)
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    ref = phase22["losses"]
    gap = abs(losses[0] - ref[0])
    if not all(np.isfinite(losses)) or gap > SH_LOSS_TOL:
        raise AssertionError(f"{tag} losses {losses}: the first {gap:.3e} from phase 22's "
                             f"{ref[0]:.4f}, over {SH_LOSS_TOL}")
    step_ms = float(np.median(times[1:])) * 1e3
    busy_ms = sum(kernels) / 1e6
    comp_ms, opt_ms = step_bound_ms(n_params, B * S, mem_rate, bf16_rate)
    log(f"{tag} {cfg.layers} layers, {n_params / 1e9:.3f} G parameters on data {SH_DATA} x model "
        f"{SH_MODEL} shards (one card), every layer tensor-parallel, remat {cfg.remat}; B={B} "
        f"S={S}: losses " + ", ".join(f"{v:.4f}" for v in losses) + " against phase 22's "
        + ", ".join(f"{v:.4f}" for v in ref) + f" (first |gap| {gap:.2e}, bar {SH_LOSS_TOL}; the "
        f"later ones logged); step {step_ms:.1f} ms (median of steps 2-{SH_RWKV_STEPS}) "
        f"against phase 22's one-device {phase22['step_ms']:.1f} ms and the least "
        f"{comp_ms + opt_ms:.1f} ms; peak {peak / 2**30:.2f} GiB allocated (one device: "
        f"{phase22['peak'] / 2**30:.2f} GiB); step 1 profiled ({times[0] * 1e3:.1f} ms under "
        f"torch.profiler): {len(kernels)} kernels keep the card busy {busy_ms:.1f} ms, "
        f"{busy_ms / step_ms:.1%} of a step, idle {1 - busy_ms / step_ms:.1%}; "
        f"{time.perf_counter() - t0:.1f} s")
    del sp, opt, m
    free_cuda()
    return {"step_ms": step_ms, "peak": peak, "losses": losses, "kernels": len(kernels),
            "busy_ms": busy_ms}


def sharded_restart_check(dev: str = "cuda") -> dict:
    """Phase 23(e): granite smoke (2 layers) on 8 data shards to a checkpoint
    at step 4, then a failure after step 5; the supervisor rebuilds the
    mesh at failed_fraction 0.25 (6 shards) and resumes from step 4.  The
    resumed losses equal an uninterrupted 6-shard run from a copy of that
    checkpoint within rtol 1e-4."""
    import shutil
    import tempfile

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_host_mesh, rebuild_mesh_after_failure
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import trainer as TR

    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), layers=2)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    data = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=SH_RESTART_B, seed=1)
    t0 = time.perf_counter()
    meshes = []

    def factory():
        mesh = (make_host_mesh(8, dev, model=1) if not meshes
                else rebuild_mesh_after_failure(0.25, 8, dev))
        meshes.append(mesh)
        return mesh

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".ckpt_") as d:
        tcfg = TR.TrainerConfig(steps=7, ckpt_dir=f"{d}/run", ckpt_every=2, log_every=100,
                                failure_at=5)
        TR.train(cfg, opt, data, dataclasses.replace(tcfg, steps=4, failure_at=None), factory())
        shutil.copytree(f"{d}/run", f"{d}/copy")
        meshes.clear()
        metrics, straight = [], []
        TR.train_with_restart(cfg, opt, data, tcfg, factory, metrics_out=metrics)
        TR.train(cfg, opt, data, dataclasses.replace(tcfg, ckpt_dir=f"{d}/copy", failure_at=None),
                 rebuild_mesh_after_failure(0.25, 8, dev), metrics_out=straight)
    shapes = [m.shape for m in meshes]
    if shapes != [{"data": 8, "model": 1}, {"data": 6, "model": 1}]:
        raise AssertionError(f"restart meshes {shapes}")
    if [m["step"] for m in metrics] != [5, 5, 6, 7] or [m["step"] for m in straight] != [5, 6, 7]:
        raise AssertionError(f"restart steps {[m['step'] for m in metrics]}, "
                             f"{[m['step'] for m in straight]}")
    gaps = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(metrics[1:], straight)]
    if max(gaps) > 1e-4:
        raise AssertionError(f"resumed losses differ from the uninterrupted 6-shard run: {gaps}")
    log(f"[sharded/restart] on {dev}: 8 data shards to step 4, failure after step 5, rebuilt "
        f"to {shapes[1]} and resumed from step 4; losses "
        + ", ".join(f"{m['loss']:.6f}" for m in metrics[1:]) + " against "
        + ", ".join(f"{m['loss']:.6f}" for m in straight)
        + f" uninterrupted on 6 shards (max rel gap {max(gaps):.2e}, rtol 1e-4); B="
        f"{SH_RESTART_B}; {time.perf_counter() - t0:.1f} s")
    return {"gaps": gaps}


def sharded_phase(mem_rate: float, bf16_rate: float, lm_rows: list, train_rows: list) -> dict:
    """Phase 23: the sharded LM path on a data x model mesh on the card."""
    import torch

    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("f32 matmuls must run at full precision (TF32 off) for phase 23")
    t_phase = time.perf_counter()
    out = {"parity": sharded_parity()}
    out["granite"] = sharded_granite(mem_rate, bf16_rate,
                                     next(r for r in train_rows if r["arch"] == "granite-3-2b"))
    out["granite_f32"] = sharded_granite_f32()
    out["jamba_ep"] = sharded_jamba_ep(next(r for r in lm_rows if r["arch"] == "jamba-v0.1-52b"))
    out["restart"] = sharded_restart_check()
    out["granite_serve"] = sharded_granite_serve(
        next(r for r in lm_rows if r["arch"] == "granite-3-2b"))
    out["rwkv_serve"] = sharded_rwkv_serve(next(r for r in lm_rows if r["arch"] == "rwkv6-3b"))
    out["rwkv_train"] = sharded_rwkv_train(mem_rate, bf16_rate,
                                           next(r for r in train_rows if r["arch"] == "rwkv6-3b"))
    log(f"[sharded] phase done in {time.perf_counter() - t_phase:.1f} s; {loadavg()}")
    return out


# ---------------------------------------------------------------------------
# Phase 24: the dry run and the examples
# ---------------------------------------------------------------------------

#: Phase 24(b): the dry-run CLI's cells on the 16 x 16 production mesh, run in
#: the background from the build on; (c): the examples and their arguments.
DRY_CLI = (("granite-3-2b", "decode_32k"), ("jamba-v0.1-52b", "decode_32k"))
EXAMPLES = (("quickstart", ()), ("serve_lm", ()), ("train_lm", ("--steps", "20")))


def start_modules(mods) -> list:
    """``python -m repro_torch.launch.<name> <args>`` for each (name, args),
    started side by side from the repo's root; killed at exit if still
    running."""
    import atexit
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for name, args in mods:
        p = subprocess.Popen([sys.executable, "-m", f"repro_torch.launch.{name}", *args],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=env, cwd=str(ROOT))
        procs.append((name, args, time.perf_counter(), p))
        atexit.register(lambda p=p: p.poll() is None and p.kill())
    return procs


def finish_modules(procs, timeout: float) -> dict:
    """{name: (exit code, output, seconds from its start until it was
    joined here)} of ``start_modules``'s processes, each given until
    ``timeout`` s from now."""
    out = {}
    deadline = time.perf_counter() + timeout
    for name, args, t0, p in procs:
        try:
            text, _ = p.communicate(timeout=max(deadline - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
            raise AssertionError(f"{name} {' '.join(args)} still running after its time")
        out[" ".join((name,) + tuple(args))] = (p.returncode, text, time.perf_counter() - t0)
    return out


def dry_cells() -> list:
    """(label, config, shape, mesh shape) of the cells phases 21-23 measure."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.config import ShapeConfig

    granite = get_config("granite-3-2b")
    rwkv = dataclasses.replace(get_config("rwkv6-3b"), layers=TR_RWKV_LAYERS)
    jamba = dataclasses.replace(get_config("jamba-v0.1-52b"), layers=dict(LM_FULL)["jamba-v0.1-52b"])
    _, rB, rS, _ = TR_RWKV
    _, B, S, _ = TR_GRANITE
    decode = ShapeConfig("phase21_decode", LM_P + LM_G, LM_B, "decode")
    train = ShapeConfig("phase22_train", S, B, "train")
    return [
        ("granite-3-2b decode (phase 21, run 2)", granite, decode, (1, 1)),
        ("granite-3-2b train step (phase 22(b))", granite, train, (1, 1)),
        ("granite-3-2b train step, data 2 x model 4 (phase 23(b))", granite, train,
         (SH_DATA, SH_MODEL)),
        ("jamba-v0.1-52b period, EP decode on data 1 x model 4 (phase 23(d))", jamba, decode,
         (1, SH_EP_MODEL)),
        ("granite-3-2b decode, data 2 x model 4 (phase 23(f))", granite, decode,
         (SH_DATA, SH_MODEL)),
        ("rwkv6-3b train step, data 2 x model 4 (phase 23(g))", rwkv,
         ShapeConfig("phase22_rwkv_train", rS, rB, "train"), (SH_DATA, SH_MODEL)),
    ]


def dry_cells_measured(lm_rows: list, train_rows: list, sharded: dict) -> list:
    """(measured ms, measured peak bytes) of each of :func:`dry_cells`, in
    order."""
    g21 = next(r for r in lm_rows if r["arch"] == "granite-3-2b")
    g22 = next(r for r in train_rows if r["arch"] == TR_GRANITE[0])
    return [(g21["decode_ms"], g21["peak_bytes"]), (g22["step_ms"], g22["peak"])] + [
        (sharded[k][ms], sharded[k]["peak"]) for k, ms in (
            ("granite", "step_ms"), ("jamba_ep", "decode_ms"), ("granite_serve", "decode_ms"),
            ("rwkv_train", "step_ms"))]


def dry_cells_main(path: str) -> int:
    """``chip_smoke.py --dry-cells PATH``: the dry run of each of
    :func:`dry_cells` on ``meta`` devices (no card), pickled to ``path``.
    Phase 24 starts it in the background after the build and reads it."""
    import os
    import pickle

    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_meta_mesh

    # beside the host-bound phases: one core, at the lowest priority
    os.nice(19)
    torch.set_num_threads(1)
    out = []
    for label, cfg, shape, mshape in dry_cells():
        t0 = time.perf_counter()
        r = DR.dryrun_config(cfg, shape, make_meta_mesh(mshape, ("data", "model")))
        out.append(dict(r, wall_s=time.perf_counter() - t0))
    with open(path, "wb") as fh:
        pickle.dump({"cells": out, "cuda_initialized": torch.cuda.is_initialized()}, fh)
    return 0


def start_dry_cells():
    """:func:`dry_cells_main` in a process of its own, from the repo's root;
    (process, its output file, start time); killed at exit if still
    running."""
    import atexit
    import tempfile

    path = tempfile.NamedTemporaryFile(dir=ROOT, prefix=".dry_cells_", delete=False).name
    atexit.register(lambda: Path(path).unlink(missing_ok=True))
    p = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dry-cells", path],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         cwd=str(ROOT))
    atexit.register(lambda: p.poll() is None and p.kill())
    return p, path, time.perf_counter()


def dryrun_phase(lm_rows: list, train_rows: list, sharded: dict, dry_cli: list,
                 dry_bg) -> dict:
    """Phase 24: the dry run's predictions (``dry_bg``, :func:`start_dry_cells`'s
    process) beside phases 21-23's measurements, the dry-run CLI, and the
    three examples on the card."""
    import pickle

    import torch

    from repro_torch.launch import dryrun as DR

    t_phase = time.perf_counter()
    examples = start_modules(EXAMPLES)
    mem_rate, _, bf16_rate = PEAKS["H100"]
    total = torch.cuda.get_device_properties(0).total_memory
    if (DR.HBM_BW, DR.PEAK_FLOPS) != (mem_rate, bf16_rate) or not DR.HBM_BYTES <= total:
        raise AssertionError(f"dry-run constants {DR.HBM_BW}, {DR.PEAK_FLOPS}, {DR.HBM_BYTES} "
                             f"against PEAKS['H100'] {mem_rate}, {bf16_rate} and the card's "
                             f"{total} bytes")
    log(f"[dryrun] constants: HBM_BW {DR.HBM_BW:.3e} B/s and PEAK_FLOPS {DR.PEAK_FLOPS:.3e} "
        f"FLOP/s (= PEAKS['H100']), LINK_BW {DR.LINK_BW:.3e} B/s, HBM_BYTES {DR.HBM_BYTES:.3e} "
        f"<= total_memory {total}")
    rows = []
    proc, path, t_bg = dry_bg
    try:
        text, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError("[dryrun] the dry runs of the measured cells still running after "
                             "300 s")
    if proc.returncode != 0:
        raise AssertionError(f"[dryrun] chip_smoke.py --dry-cells exited {proc.returncode}: "
                             f"{text[-2000:]}")
    with open(path, "rb") as fh:
        dry = pickle.load(fh)
    log(f"[dryrun] the dry runs of the measured cells ran beside phases 19-23 in a process of "
        f"their own, done within {time.perf_counter() - t_bg:.1f} s of its start")
    for (label, cfg, shape, mshape), (ms, peak), r in zip(
            dry_cells(), dry_cells_measured(lm_rows, train_rows, sharded), dry["cells"]):
        t = {k: v * 1e3 for k, v in r["terms"].items()}
        bound = max(t.values())
        c = r["collective_bytes"]
        log(f"[dryrun] {label}: B={shape.global_batch} S={shape.seq_len} on "
            f"{r['mesh']} meta devices; predicted compute {t['compute_s']:.3f} ms, memory "
            f"{t['memory_s']:.3f} ms, collective {t['collective_s']:.3f} ms (dominant "
            f"{r['dominant']}); {r['flops_per_device']:.4e} FLOP, "
            f"{r['hbm_bytes_per_device']:.4e} B (unfused), collective {c['total']} B "
            + str({k: v for k, v in c.items() if v and k != "total"})
            + f" a device; measured {ms:.3f} ms = x{ms / bound:.2f} the largest term; peak "
            f"{r['peak_hbm_per_device'] / 2**30:.3f} GiB predicted a device, {peak / 2**30:.3f} "
            f"GiB measured on the card; fake runs at one and two repeat units of depth, "
            f"extrapolated (exact on a uniform stack) {r['lower_s'] + r['compile_s']:.1f} s "
            f"({r['wall_s']:.1f} s)")
        if not r["peak_hbm_per_device"] <= peak:
            raise AssertionError(f"[dryrun] {label}: predicted peak {r['peak_hbm_per_device']} "
                                 f"above the measured {peak}")
        rows.append(dict(r, label=label, measured_ms=ms, measured_peak=peak))
    if dry["cuda_initialized"]:
        raise AssertionError("[dryrun] the dry runs initialised CUDA in their process")
    log("[dryrun] the dry runs' process never initialised CUDA: they allocated nothing on the "
        "card")

    for cmd, (rc, text, secs) in finish_modules(dry_cli, 300).items():
        for line in text.strip().splitlines():
            log(f"[dryrun/cli] {line}")
        if rc != 0 or "[OK]" not in text or "1 cells compiled, 0 failures" not in text:
            raise AssertionError(f"python -m repro_torch.launch.{cmd} exited {rc}")
        log(f"[dryrun/cli] python -m repro_torch.launch.{cmd}: exit 0, done within {secs:.1f} s "
            f"of its start after the build")

    for cmd, (rc, text, secs) in finish_modules(examples, 300).items():
        for line in text.strip().splitlines():
            log(f"[examples] {line}")
        if rc != 0 or "cuda" not in text:
            raise AssertionError(f"python -m repro_torch.launch.{cmd} exited {rc} or ran off the "
                                 f"card")
        if cmd.startswith("quickstart"):
            err = float(text.split("max |CSR-k − CSR| = ")[1].split()[0])
            if not err < 1e-4:
                raise AssertionError(f"quickstart: max |CSR-k - CSR| {err} over 1e-4")
        if cmd.startswith("train_lm"):
            first, last = (float(v) for v in
                           text.split("loss: ")[1].split(" on ")[0].split(" → "))
            if not (np.isfinite(first) and np.isfinite(last)):
                raise AssertionError(f"train_lm losses {first}, {last}")
        log(f"[examples] python -m repro_torch.launch.{cmd} on the card: exit 0, done within "
            f"{secs:.1f} s of its start")
    log(f"[dryrun] phase done in {time.perf_counter() - t_phase:.1f} s")
    return {"cells": rows}


# ---------------------------------------------------------------------------
# Phase 25: the reference's shape cells
# ---------------------------------------------------------------------------

#: Phase 25: the reference's shape cells (``models/config.py::SHAPES``) at
#: their lengths.  Only batch and depth are cut; no width, expert count,
#: frontend length or sequence length is.  ``CELL_SERVE``: decode_32k and
#: prefill_32k of each family, (arch, layers kept or None for all, the B of
#: decode_32k's second row; 128 in the reference), each family paying for
#: two 32k prefills at B=1 (``CELL_PREFILL_B``; 32 in the reference): the
#: one that fills the steps' cache and ``make_prefill_step``'s.  A depth is
#: reckoned from the bytes a prefill holds at once (bf16 weights, the 32k
#: cache, about four f32 score blocks of [H, 32,768, 1,024], the bf16
#: logits of [32,768, vocab]), then cut further where the prefills' time
#: (eager f32 flash attention: some 25-30 ms a head and layer at 32k) would
#: take the script near its limit.  granite-3-2b: 20 of 40 (whole, its two
#: prefills took 67.8 s and the script 1,114 s of its 1,200).  qwen1.5-32b: 1.72 GB a layer (weights
#: 1.05, its MHA cache 0.67), 35 would fit beside 21 GB of score blocks; 4
#: run.  qwen2-7b: whole would fit (its cache 0.07 GB a layer and sequence;
#: 26.8 s a prefill on the card); 7 of 28 run.  deepseek-7b: whole would fit
#: (13.8 GB of weights, 16.1 GB of cache a sequence); 4 of 30 run.
#: kimi-k2-1t-a32b: 1 of 61 as phase 21 (36 GiB of weights beside four
#: score blocks of 8 GiB; phase 25 grows the allocator's segments in place
#: for it).  llama4-scout-17b-a16e: 4 of 48 as phase 21.  internvl2-76b: 2
#: of 80 (its cache holds the 256 patch rows ahead of the 32,768 tokens).
#: seamless-m4t-medium whole.  jamba-v0.1-52b: one 8-layer period as phase
#: 21.  rwkv6-3b: 8 of 32 (its chunked prefill over 32k tokens took ~40 s
#: whole).  ``CELL_PREFILL_F32_ONLY``: the families whose bf16 noise may
#: cover every top-2 margin of prefill_32k's last positions against the
#: steps (rwkv6: 1-3 at phase 21's positions), so that the argmax check
#: there may find no position; (c) holds their identity at f32.  ``CELL_TRAIN``: train_4k at (arch, layers, B;
#: 256 in the reference, lr), where the reckoning of
#: :func:`cell_train_bytes` (16 B a parameter for weights, gradients and
#: moments, three f32 copies of the logits) fits in ``CELL_TRAIN_FIT`` of
#: the card, the depth cut further for time; the widths past granite's
#: take a tenth of its learning rate: at granite's, their losses rose in
#: probe runs on the card (qwen1.5-32b 13.2 to 33.1, internvl2-76b 13.4 to
#: 72.0; rwkv6-3b failed the check at 5e-6 and held at 1.5e-5).  Whether
#: the reference rises the same way at granite's rate is open: no witness
#: has run it at these widths (Adam's first update, sign-sized at every
#: weight, is the guess, not a finding; PERF.md section 7).  ``CELL_TRAIN_UNFIT``: the configs whose smallest cut does not
#: fit (kimi's one layer of 384 experts, jamba's five layers that keep its
#: attention layer, index 4, and two MoE layers, llama4's one layer of 16
#: experts and its untied 202,048-row vocabulary), logged with their
#: reckoning.  ``CELL_NARROW``: (a)'s card-against-CPU decode cells at
#: smoke width (arch, cell, B).  ``CELL_F32``: (c)'s f32 identities (arch,
#: layers, steps; the prefill a multiple of ``la_chunk``): rwkv6's bf16
#: noise covers every top-2 margin of its 32k prefill's last positions, so
#: its identity is held at f32.  The greedy steps at full width (the last
#: writes the cache's last row), the narrow steps of (a), the train steps;
#: the train cells' learning rate, their first update at it and their
#: second at a tenth (the cosine's floor): at 0.55 of it the second update
#: took granite's third loss above the first (11.14, 10.35, 12.54 on the
#: card), as phase 22(b)'s does at lr 3e-4.
CELL_JAMBA_LAYERS = 8
CELL_TRAIN_LR = 1.5e-4
CELL_SERVE = (("granite-3-2b", 20, 16), ("qwen1.5-32b", 4, 4), ("qwen2-7b", 7, 16),
              ("deepseek-7b", 4, 4), ("kimi-k2-1t-a32b", 1, 16),
              ("llama4-scout-17b-a16e", 4, 16), ("internvl2-76b", 2, 16),
              ("seamless-m4t-medium", None, 16), ("jamba-v0.1-52b", CELL_JAMBA_LAYERS, 16),
              ("rwkv6-3b", 8, 16))
CELL_PREFILL_B = 1
CELL_PREFILL_F32_ONLY = ("rwkv6-3b",)
CELL_TRAIN = (("granite-3-2b", None, 2, CELL_TRAIN_LR),
              ("qwen1.5-32b", 2, 2, CELL_TRAIN_LR / 10), ("qwen2-7b", 4, 2, CELL_TRAIN_LR / 10),
              ("deepseek-7b", 4, 2, CELL_TRAIN_LR / 10),
              ("internvl2-76b", 1, 2, CELL_TRAIN_LR / 10),
              ("seamless-m4t-medium", None, 2, CELL_TRAIN_LR),
              ("rwkv6-3b", 8, 2, CELL_TRAIN_LR / 10))
CELL_TRAIN_UNFIT = (("kimi-k2-1t-a32b", 1, 1), ("jamba-v0.1-52b", 5, 1),
                    ("llama4-scout-17b-a16e", 1, 1))
CELL_TRAIN_FIT = 0.85
CELL_NARROW = (("granite-3-2b", "decode_32k", 2), ("jamba-v0.1-52b", "long_500k", 1),
               ("rwkv6-3b", "long_500k", 1)) + tuple(
    (arch, "decode_32k", 2) for arch in ("qwen1.5-32b", "qwen2-7b", "deepseek-7b",
                                         "kimi-k2-1t-a32b", "llama4-scout-17b-a16e",
                                         "internvl2-76b", "seamless-m4t-medium",
                                         "jamba-v0.1-52b", "rwkv6-3b"))
CELL_F32 = (("granite-3-2b", 4, 8), ("rwkv6-3b", 4, 32))
CELL_STEPS, CELL_NARROW_STEPS, CELL_TRAIN_STEPS = 16, 4, 3


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def profiled(fn):
    """``fn()`` under ``torch.profiler``, synchronised on both sides: (its
    result, host ms, CUDA kernels launched, their summed device ms); the
    three kernel names with the most device time, and their ms, are left
    in ``profiled.top``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    profiled.top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return out, ms, len(kernels), sum(e.device_time_total for e in kernels) / 1e3


def cell_steps(step, n: int):
    """``step(i)`` for i < n, each synchronised and timed on the host, the
    last under :func:`profiled`: (outputs, host ms of each, the last's
    kernels and busy ms, the median ms of the unprofiled steps after the
    first (of the only step where n is 1 or 2: the profiled one))."""
    import torch

    outs, ms = [], []
    for i in range(n - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(step(i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out, last_ms, kernels, busy = profiled(lambda: step(n - 1))
    outs.append(out)
    ms.append(last_ms)
    med = float(np.median(ms[1:-1])) if n >= 3 else last_ms
    return outs, ms, kernels, busy, med


def attention_flops(cfg, B: int, T: int) -> float:
    """A causal forward's attention FLOPs over T rows: QK^T and PV, 2 T^2 Dh
    each a head, half the square under the mask: 2 L H Dh T^2 a sequence,
    L the attention layers (the encoder–decoder's decoder self-attention;
    its cross-attention and encoder are left out)."""
    from repro_torch.models import transformer as TF

    L = cfg.layers if cfg.is_encdec else sum(TF.layer_spec(cfg, i)[0] == "attn"
                                             for i in range(TF.num_layers(cfg)))
    return 2.0 * L * cfg.num_heads * cfg.resolved_head_dim * T * T * B


def cache_bytes_read(cache, valid: int) -> float:
    """Bytes of a decode cache one step must read: the K and V rows below
    ``valid`` of each attention layer, every recurrent state read and
    written."""
    total = 0.0
    for entry in cache:
        if "k" in entry:
            k = entry["k"]
            total += 2 * k.shape[0] * valid * k[0, 0].numel() * k.element_size()
        else:
            total += 2 * nbytes(entry)
    return total


def cell_decode_bound(params, cfg, routed: float, cache, first: int, n: int, mem_rate: float):
    """The least time of a decode step of a cell, (ms, what): the weights a
    step reads (:func:`weight_bytes_per_step`, ``routed`` experts a MoE
    layer) and the cache rows below each of the ``n`` steps' index from
    ``first`` (:func:`cache_bytes_read`), their mean, over the memory rate."""
    wbytes = weight_bytes_per_step(params, cfg, routed)
    read = sum(cache_bytes_read(cache, first + i + 1) for i in range(n)) / n
    what = (f"{wbytes / 1e9:.3f} GB of weights" + (" (routed experts)" if cfg.is_moe else "")
            + f" + {read / 1e9:.3f} GB of cache a step / memory rate")
    return (wbytes + read) / mem_rate * 1e3, what


def cell_ref_cache(cfg, B: int, S: int, seed: int):
    """A decode cache of S rows in the reference's ``init_cache`` layout,
    float32 draws from ``seed`` in numpy (every attention row and every
    recurrent state): stacked over layers, or a list over the period's
    positions each stacked over periods (hybrids), or a list per layer
    (interleaved dense/MoE); the encoder–decoder's self-attention cache
    stacked over its decoder layers.  ``convert.cache_from_reference``
    carries it to the port."""
    rng = np.random.default_rng(seed)
    layers = lm_model(cfg).init_cache(cfg, B, S, device="meta")
    draw = lambda entry: {k: rng.standard_normal(tuple(t.shape), dtype=np.float32)
                          for k, t in entry.items()}
    stack = lambda entries: {k: np.stack([e[k] for e in entries]) for k in entries[0]}
    drawn = [draw(e) for e in layers]
    if cfg.attn_period > 0:
        P = cfg.attn_period
        return [stack(drawn[j::P]) for j in range(P)]
    if cfg.is_moe and cfg.moe_every > 1:
        return drawn
    return stack(drawn)


def cell_log(tag: str, what: str, r: dict) -> dict:
    """One line of a cell: ms, bound, kernels and busy ms, peak beside the
    resident state, the machine's load."""
    res = " + ".join(f"{k} {v / 2**30:.2f}" for k, v in r["resident"].items())
    log(f"{tag} {what}: {r['ms']:.3f} ms ({r['ms_what']}); bound {r['bound_ms']:.3f} ms "
        f"({r['bound_what']}), x{r['ms'] / r['bound_ms']:.2f}; {r['kernels']} kernels busy "
        f"{r['busy_ms']:.3f} ms ({r['busy_what']}, torch.profiler), "
        f"{r['busy_ms'] / r['profiled_ms']:.1%} of its {r['profiled_ms']:.3f} ms"
        + "".join(f"{', most in' if i == 0 else ','} {name[:60]} {t:.3f} ms"
                  for i, (name, t) in enumerate(r["top"])) + "; peak "
        f"{r['peak'] / 2**30:.2f} GiB allocated beside {sum(r['resident'].values()) / 2**30:.2f} "
        f"GiB resident ({res} GiB); {loadavg()}")
    return dict(r, tag=tag)


def f32_within(what: str, card, cpu) -> float:
    """max |card - cpu|, every entry finite and within ``LM_F32_ATOL`` +
    ``LM_F32_RTOL`` |cpu|, or raise."""
    import torch

    err = (card - cpu).abs()
    if not bool(torch.isfinite(card).all()) or not bool(
            (err <= LM_F32_ATOL + LM_F32_RTOL * cpu.abs()).all()):
        raise AssertionError(f"{what} card vs CPU max |err| {float(err.max()):.3e} over "
                             f"{LM_F32_ATOL} + {LM_F32_RTOL}|cpu|")
    return float(err.max())


def cell_narrow_decode(arch: str, cell: str, B: int, mem_rate: float) -> dict:
    """Phase 25(a), one decode cell at smoke width and f32: the cell's S rows
    drawn in the reference's layout (:func:`cell_ref_cache`), carried to
    the CPU and to the card, then ``CELL_NARROW_STEPS`` steps of
    ``make_decode_step`` from index S - steps on both (the encoder–decoder's
    against its encoder's output over numpy-seeded frames, encoded on each
    side): each step's logits and the caches after the last-row write within
    ``LM_F32_ATOL`` + ``LM_F32_RTOL`` |cpu|."""
    import torch

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import encdec as ED
    from repro_torch.models import moe as MOE
    from repro_torch.models.config import SHAPES
    from repro_torch.models.convert import cache_from_reference
    from repro_torch.util.tree import tree_map

    cfg, S, n = get_smoke_config(arch), SHAPES[cell].seq_len, CELL_NARROW_STEPS
    tag = f"[cells/{cell} {arch} narrow]"
    ref = cell_ref_cache(cfg, B, S, 0)
    cpu_params = lm_model(cfg).init_params(torch.Generator().manual_seed(0), cfg)
    frames = lm_frontend(cfg, 0, B, "cpu") if cfg.is_encdec else None
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, n)).astype(np.int32)
    step = STEPS.make_decode_step(cfg)
    got = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev), cpu_params)
        state = {"cache": cache_from_reference(cfg, ref, dev)}
        toks = torch.from_numpy(tokens).to(dev)
        if dev == "cpu":
            seeded_last = {i: e["k"][:, S - 1].clone() for i, e in enumerate(state["cache"])
                           if "k" in e}
        else:
            torch.cuda.reset_peak_memory_stats()
            resident = {"weights": nbytes(params), "cache": nbytes(state["cache"])}

        def run(i):
            logits, state["cache"] = step(params, state["cache"], toks[:, i:i + 1], S - n + i,
                                          enc_out)
            return logits[:, 0].float()

        with torch.inference_mode(), DispatchLog(MOE) as moe:
            enc_out = ED.encode(params, frames.to(dev), cfg) if cfg.is_encdec else None
            if dev == "cpu":
                outs = [run(i) for i in range(n)]
            else:
                outs, ms, kernels, busy, med = cell_steps(run, n)
        got[dev] = (torch.stack(outs, 1).cpu(), [tree_map(lambda t: t.cpu(), e)
                                                  for e in state["cache"]])
    peak = torch.cuda.max_memory_allocated()
    (cpu_l, cpu_c), (card_l, card_c) = got["cpu"], got["cuda"]
    err = f32_within(f"{tag} logits", card_l, cpu_l)
    cache_err = max(f32_within(f"{tag} cache layer {i} {k}", a[k], b[k])
                    for i, (a, b) in enumerate(zip(card_c, cpu_c)) for k in a)
    for i, last in seeded_last.items():     # the last step wrote the cache's last row
        if torch.equal(card_c[i]["k"][:, S - 1], last):
            raise AssertionError(f"{tag} layer {i}: row {S - 1} not written")
    routed = moe.total("routed") / len(moe.routed) if moe.routed else 0.0
    bound, bound_what = cell_decode_bound(cpu_params, cfg, routed, got["cuda"][1], S - n, n,
                                          mem_rate)
    kv = len(seeded_last)
    r = cell_log(tag, f"B={B}, {S:,} rows in {kv} attention and {len(card_c) - kv} recurrent "
                 f"layers, {n} steps from index {S - n:,} (the last writes row {S - 1:,}); "
                 f"logits card vs CPU max |err| {err:.3e}, caches {cache_err:.3e} (bar "
                 f"{LM_F32_ATOL} + {LM_F32_RTOL}|cpu|), max |logit| "
                 f"{float(cpu_l.abs().max()):.3f}",
                 {"ms": med, "ms_what": f"a step, median of steps 2-{n - 1}",
                  "bound_ms": bound, "bound_what": f"f32: {bound_what}",
                  "kernels": kernels, "busy_ms": busy, "busy_what": f"step {n}",
                  "top": profiled.top,
                  "profiled_ms": ms[-1], "peak": peak, "resident": resident})
    return dict(r, err=err, cache_err=cache_err)


def cell_narrow_train(f32_rate: float) -> dict:
    """Phase 25(a), train_4k at smoke width: granite-3-2b's f32 loss and
    every gradient leaf of ``make_grad_fn`` at B=1 x S=4,096, remat on,
    card against CPU within phase 22's 1e-4 max|g| + 1e-6."""
    import dataclasses as dc

    import torch

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.config import SHAPES
    from repro_torch.util.tree import leaves

    cfg = dc.replace(get_smoke_config("granite-3-2b"), remat=True)
    S = SHAPES["train_4k"].seq_len
    tag = "[cells/train_4k granite-3-2b narrow]"
    _, _, l_cpu, _, g_cpu = train_smoke_grads(cfg, torch.device("cpu"), 0, 1, S)
    torch.cuda.reset_peak_memory_stats()
    (p, _, l_card, _, g_card), ms, kernels, busy = profiled(
        lambda: train_smoke_grads(cfg, torch.device("cuda"), 0, 1, S))
    peak = torch.cuda.max_memory_allocated()
    check_within(f"{tag} loss", l_card, l_cpu, TR_RTOL, TR_ATOL)
    worst = max(check_within(f"{tag} gradient leaf {i} {tuple(g.shape)}", gc, g, TR_RTOL, TR_ATOL)
                / max(float(g.abs().max()), 1e-30)
                for i, (gc, g) in enumerate(zip(leaves(g_card), leaves(g_cpu))))
    n_params = sum(t.numel() for t in leaves(p))
    bound = (8 * n_params * S + 4 * attention_flops(cfg, 1, S)) / f32_rate * 1e3
    r = cell_log(tag, f"B=1 x S={S:,}, remat on, f32: loss {float(l_card):.6f} (CPU "
                 f"{float(l_cpu):.6f}), {len(leaves(g_cpu))} gradient leaves within {TR_RTOL} "
                 f"max|g| + {TR_ATOL} (worst {worst:.3e} of its leaf's max)",
                 {"ms": ms, "ms_what": "the gradient call, weights drawn and copied included",
                  "bound_ms": bound, "bound_what": "(8 N S + 4 x attention's forward FLOPs) / "
                                                   "f32 peak",
                  "kernels": kernels, "busy_ms": busy, "busy_what": "the same call",
                  "top": profiled.top,
                  "profiled_ms": ms, "peak": peak,
                  "resident": {"weights": nbytes(p), "gradients": nbytes(g_card)}})
    return dict(r, worst_rel=worst)


def lm_forward_cached(cfg, params, tokens, cache, index: int, extra=None, enc_out=None):
    """(logits, cache) of ``tokens`` [B, T] written into ``cache`` from row
    ``index``: the decoder's forward of ``make_prefill_step`` with the patch
    embeddings ``extra`` ahead of the tokens where given (a ``vit`` model's
    first call), or the encoder–decoder's decoder against ``enc_out``."""
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import encdec as ED

    if cfg.is_encdec:
        return ED.decode(params, tokens, enc_out, cfg, cache=cache, cache_index=index)
    logits, cache, _ = STEPS._decoder_forward(cfg)(params, tokens, extra, cache=cache,
                                                   cache_index=index)
    return logits, cache


def cell_serve(arch: str, layers, B: int, mem_rate: float, bf16_rate: float) -> dict:
    """Phase 25(b), decode_32k and prefill_32k of ``arch`` at full width
    (``layers`` of it, or whole), bf16: the cache's prefill, the cell's
    S - ``CELL_STEPS`` prompt tokens at B=1 through an S-row cache (after a
    ``vit`` model's patches, whose rows the cache holds too; against the
    encoder's output over the frames for the encoder–decoder), in calls of
    a multiple of ``min(la_chunk, T)`` tokens, as the chunked recurrence
    needs; from there ``CELL_STEPS`` greedy steps at B=1 (the last writes
    the cache's last row); then the recurrent states go back to S -
    ``CELL_STEPS``, the cache is copied into ``B`` rows and as many steps
    run there (every row the same tokens).  Then prefill_32k:
    ``make_prefill_step``, the uncached forward, over the prompt and the
    tokens the B=1 steps were fed, S in all at B=1, its argmax held against
    the steps' tokens wherever its top-2 margin exceeds twice its gap to
    their logits, at one position at least where the prefill dropped no
    MoE routing (``CELL_PREFILL_F32_ONLY``: a family whose bf16 noise may
    cover those margins, held at f32 by (c))."""
    import dataclasses as dc

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import encdec as ED
    from repro_torch.models import moe as MOE
    from repro_torch.models.config import SHAPES

    cfg = get_config(arch)
    if layers is not None:
        cfg = dc.replace(cfg, layers=layers)
    S, G, V, off = SHAPES["decode_32k"].seq_len, CELL_STEPS, cfg.vocab, lm_prefix(cfg)
    if SHAPES["prefill_32k"].seq_len != S or CELL_PREFILL_B != 1:
        raise AssertionError("prefill_32k and decode_32k differ in length, or the prefill's "
                             "batch is not the decode rows' one")
    P = S - G
    calls = [(0, P - P % min(cfg.la_chunk, P)), (P - P % min(cfg.la_chunk, P), P)]
    tag = f"[cells/decode_32k {arch}]"
    mlayers = lm_moe_layers(cfg)
    rows_what = (f"{off} patches + " if off else "") + "{:,} tokens" + (
        f" against {cfg.frontend_seq} frames" if cfg.is_encdec else "")
    rows = {}
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        params, seq = lm_seeded(cfg, 0, 1, S)
        extra = lm_frontend(cfg, 0, 1)
        cache = lm_model(cfg).init_cache(cfg, 1, off + S, device="cuda")
        resident = {"weights": nbytes(params), "cache": nbytes(cache)}
        # the K/V rows are written in place, the recurrent states returned
        state = {"enc_out": None, "cache": cache}
        del cache

        def prefill():
            if cfg.is_encdec:
                state["enc_out"] = ED.encode(params, extra, cfg)
            for a, b in calls:
                if b > a:
                    logits, state["cache"] = lm_forward_cached(
                        cfg, params, seq[:, a:b], state["cache"], off + a if a else 0,
                        extra if a == 0 else None, state["enc_out"])
                    last = logits[:, -1, :V].float()
                    del logits
            return last

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with DispatchLog(MOE) as moe_pre:
            first = prefill()
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        pre_peak = torch.cuda.max_memory_allocated()
        enc_out, cache = state.pop("enc_out"), state.pop("cache")
        saved = [None if "k" in e else {k: t.clone() for k, t in e.items()} for e in cache]
        step = STEPS.make_decode_step(cfg)
        tok0 = first.argmax(-1, keepdim=True)

        def decode(cache, B: int):
            st = {"cache": cache, "tok": tok0.expand(B, 1)}
            enc = None if enc_out is None else enc_out.repeat(B, 1, 1)

            def run(i):
                logits, st["cache"] = step(params, st["cache"], st["tok"], off + P + i, enc)
                st["tok"] = logits[:, -1:, :V].argmax(-1)
                return logits[:, 0, :V].float(), st["tok"]

            with DispatchLog(MOE) as moe:
                outs, ms, kernels, busy, med = cell_steps(run, G)
            return (torch.stack([o[0] for o in outs], 1), torch.cat([t for _, t in outs], 1),
                    st["cache"], ms, kernels, busy, med, moe)

        for B_row in (1, B):
            if B_row > 1:
                # the recurrent states back to S - steps; each step writes its
                # own row before it attends, so the rows the earlier steps
                # wrote are rewritten before they are read
                for e, kept in zip(cache, saved):
                    for k, t in (kept or {}).items():
                        e[k].copy_(t)
                cache = [{k: t.repeat(B_row, *(1,) * (t.dim() - 1)) for k, t in e.items()}
                         for e in cache]
                free_cuda()
            torch.cuda.reset_peak_memory_stats()
            dec, toks, cache, ms, kernels, busy, med, moe = decode(cache, B_row)
            peak = torch.cuda.max_memory_allocated()
            if not bool(torch.isfinite(dec).all()):
                raise AssertionError(f"{tag} B={B_row}: non-finite logits")
            if any(not bool(e["k"][:, off + S - 1].abs().sum()) for e in cache if "k" in e):
                raise AssertionError(f"{tag} B={B_row}: row {off + S - 1} of the cache not "
                                     f"written")
            routed = moe.total("routed") / len(moe.routed) if mlayers else 0.0
            bound, bound_what = cell_decode_bound(params, cfg, routed, cache, off + P, G,
                                                  mem_rate)
            what = (f"{cfg.layers} of {get_config(arch).layers} layers, B={B_row}: {G} greedy "
                    f"steps from index {off + P:,} (the last writes row {off + S - 1:,})")
            if mlayers:
                what += (f"; MoE drops in the steps {moe.total('dropped')}, "
                         f"{routed:.2f} of {cfg.num_experts} experts routed a MoE layer and step")
            if B_row > 1:
                row_gap = float((dec - dec[:1]).abs().max())
                same = bool((toks == toks[:1]).all())
                what += (f"; every row the same tokens: {same}, the largest logit gap between "
                         f"rows {row_gap:.4f}; tokens as B=1's at "
                         f"{int((toks[0].cpu() == rows[1]['toks'][0]).sum())} of {G}")
                if not same:
                    raise AssertionError(f"{tag} B={B_row}: rows gave different tokens")
            rows[B_row] = cell_log(
                tag, what,
                {"ms": med, "ms_what": f"a step, median of steps 2-{G - 1}",
                 "bound_ms": bound, "bound_what": bound_what,
                 "kernels": kernels, "busy_ms": busy, "busy_what": f"step {G}",
                 "top": profiled.top, "profiled_ms": ms[-1], "peak": peak,
                 "resident": {"weights": nbytes(params), "cache": nbytes(cache)}})
            rows[B_row].update(toks=toks.cpu(), dec=dec.cpu(), step_ms=ms)
        del cache, saved
        free_cuda()
        pre_bound = ((prefill_flops(cfg, params, 1, P) + attention_flops(cfg, 1, off + P))
                     / bf16_rate * 1e3)
        log(f"{tag} the steps' cache filled at B=1 with {rows_what.format(P)} through the cache "
            f"(not profiled), in calls of " + ", ".join(f"{b - a:,}" for a, b in calls if b > a)
            + f": {pre_ms:.3f} ms, bound {pre_bound:.3f} ms ((2 N T + 2 L H Dh T^2) / bf16 peak), "
            f"x{pre_ms / pre_bound:.2f}; peak {pre_peak / 2**30:.2f} GiB allocated beside "
            f"{sum(resident.values()) / 2**30:.2f} GiB resident"
            + (f"; MoE drops {moe_pre.total('dropped')}" if mlayers else ""))

        # prefill_32k: the prompt and the tokens the B=1 steps were fed, S in all
        fed = torch.cat([tok0, rows[1]["toks"][:, :-1].cuda()], 1)
        seq = torch.cat([seq[:, :P], fed], 1)
        torch.cuda.reset_peak_memory_stats()
        with DispatchLog(MOE) as moe_full:
            full, ms, kernels, busy = profiled(lambda: lm_full_logits(cfg, params, seq, P + 1,
                                                                      extra))
        peak = torch.cuda.max_memory_allocated()
        full = full.float().cpu()                                       # positions P..S-1
    dec, toks = rows[1]["dec"], rows[1]["toks"]
    if not bool(torch.isfinite(full).all()):
        raise AssertionError(f"{tag} prefill_32k: non-finite logits")
    # decode step i read the token at position P + i and chose toks[:, i]
    gap = (full - dec).abs().amax(-1)                                   # [1, G]
    top2 = full.topk(2, dim=-1).values
    checked = (top2[..., 0] - top2[..., 1]) > 2 * gap
    agree = full.argmax(-1) == toks
    dropped = moe_full.total("dropped") if mlayers else 0
    bound = (prefill_flops(cfg, params, 1, S) + attention_flops(cfg, 1, off + S)) / bf16_rate * 1e3
    r = cell_log(
        f"[cells/prefill_32k {arch}]",
        f"{cfg.layers} of {get_config(arch).layers} layers, make_prefill_step at B=1 over "
        f"{rows_what.format(S)}, the last {G} tokens those the B=1 steps were fed; its last {G} "
        f"positions' bf16 gap to the steps' logits max {float(gap.max()):.4f} (max |logit| "
        f"{float(full.abs().max()):.3f}); argmax = the generated token at "
        f"{int((agree & checked).sum())} of {int(checked.sum())} positions whose top-2 margin "
        f"exceeds twice their gap, {int(agree.sum())} of {agree.numel()} in all"
        + (f"; MoE drops {dropped} (the steps drop none)" if mlayers else ""),
        {"ms": ms, "ms_what": "the call, profiled", "bound_ms": bound,
         "bound_what": "(2 N T + 2 L H Dh T^2) / bf16 peak", "kernels": kernels,
         "busy_ms": busy, "busy_what": "the call", "top": profiled.top, "profiled_ms": ms,
         "peak": peak, "resident": {"weights": nbytes(params)}})
    # at least one position checked, but where the prefill dropped routings
    # (its tokens then see other experts than the steps') or the family's
    # bf16 noise may cover every margin (held at f32 by (c))
    if not bool(agree[checked].all()) or not (
            int(checked.sum()) or dropped or arch in CELL_PREFILL_F32_ONLY):
        raise AssertionError(f"{tag} prefill_32k: argmax = the generated token at "
                             f"{int((agree & checked).sum())} of {int(checked.sum())} positions "
                             f"whose top-2 margin exceeds twice their gap")
    del params
    free_cuda()
    return {"decode_1": rows[1], f"decode_{B}": rows[B], "cache_prefill_ms": pre_ms,
            "prefill_32k": r, "gap": float(gap.max())}


def cell_train_bytes(cfg, B: int, S: int) -> int:
    """The reckoning of a train step's memory: 16 B a parameter (bf16
    weights and gradients, f32 moments, the f32 update's transients) and
    three f32 [B, rows, vocab] tensors of the logits (the logits, their
    softmax, their gradient)."""
    return 16 * cfg.param_count() + 3 * 4 * B * (lm_prefix(cfg) + S) * cfg.padded_vocab


def cell_train(arch: str, layers, B: int, lr: float, mem_rate: float, bf16_rate: float) -> dict:
    """Phase 25(b), train_4k: ``arch`` at full width (``layers`` of it, or
    whole), bf16, remat on, ``CELL_TRAIN_STEPS`` ``make_train_step`` steps at
    B x S=4,096 (a ``vit`` model's patches and the encoder–decoder's frames
    numpy-seeded by the step; the last step profiled), the reckoning of
    :func:`cell_train_bytes` within ``CELL_TRAIN_FIT`` of the card; losses
    finite and falling.  The learning rate ``lr`` for the first update, a
    tenth of it for the second (the cosine's floor)."""
    import dataclasses as dc

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, global_batch_array
    from repro_torch.launch import steps as STEPS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import SHAPES
    from repro_torch.optim import adamw

    cfg = get_config(arch)
    if layers is not None:
        cfg = dc.replace(cfg, layers=layers)
    S, n = SHAPES["train_4k"].seq_len, CELL_TRAIN_STEPS
    tag = f"[cells/train_4k {arch}]"
    if not cfg.remat:
        raise AssertionError(f"{tag} remat off")
    need, total = cell_train_bytes(cfg, B, S), torch.cuda.get_device_properties(0).total_memory
    if need > CELL_TRAIN_FIT * total:
        raise AssertionError(f"{tag} reckoned {need / 2**30:.1f} GiB, over {CELL_TRAIN_FIT:.0%} "
                             f"of the card's {total / 2**30:.1f} GiB")
    mesh = make_host_mesh(1, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params = lm_model(cfg).init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = adamw.init(params)
    resident = {"weights": nbytes(params), "AdamW moments": nbytes([opt.mu, opt.nu])}
    n_params = sum(t.numel() for t in tree_leaves(params))
    step = STEPS.make_train_step(cfg, adamw.AdamWConfig(lr=lr, warmup_steps=1, total_steps=2))
    data = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    state = {"params": params, "opt": opt}
    comp_ms = 4 * prefill_flops(cfg, params, B, S) / bf16_rate * 1e3
    opt_ms = step_bound_ms(n_params, 0, mem_rate, bf16_rate)[1]
    del params, opt

    def run(i):
        tokens, labels = global_batch_array(data, i, mesh)
        state["params"], state["opt"], m = step(state["params"], state["opt"], tokens, labels,
                                                lm_frontend(cfg, i, B))
        return float(m["loss"])

    losses, ms, kernels, busy, med = cell_steps(run, n)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag} losses {losses}: not finite or not falling")
    attn_ms = 4 * attention_flops(cfg, B, lm_prefix(cfg) + S) / bf16_rate * 1e3
    r = cell_log(
        tag, f"{cfg.layers} of {get_config(arch).layers} layers, B={B} x S={S:,}"
        + (f" after {lm_prefix(cfg)} patches" if lm_prefix(cfg) else "")
        + (f" against {cfg.frontend_seq} frames" if cfg.is_encdec else "")
        + f", remat on, {n_params / 1e9:.3f} G parameters (reckoned {need / 2**30:.1f} GiB), lr "
        f"{lr:.3g} then a tenth: losses " + ", ".join(f"{v:.4f}" for v in losses)
        + "; steps " + ", ".join(f"{v:.1f}" for v in ms) + f" ms; {B * S / med * 1e3:.0f} "
        f"tokens/s",
        {"ms": med, "ms_what": f"a step, median of steps 2-{n - 1}",
         "bound_ms": comp_ms + attn_ms + opt_ms,
         "bound_what": f"8 N x rows {comp_ms:.1f} + 4 x attention's forward {attn_ms:.1f} (bf16 "
                       f"peak) + {OPT_BYTES_PER_PARAM} B a parameter {opt_ms:.1f} (memory rate)",
         "kernels": kernels, "busy_ms": busy, "busy_what": f"step {n}", "top": profiled.top,
         "profiled_ms": ms[-1], "peak": peak, "resident": resident})
    del state
    free_cuda()
    return dict(r, losses=losses, step_ms=ms)


def cell_train_unfit() -> list:
    """The train_4k configs of ``CELL_TRAIN_UNFIT``: their reckoning
    (:func:`cell_train_bytes`) over ``CELL_TRAIN_FIT`` of the card, logged;
    they do not run (ROADMAP C1: a mesh of cards)."""
    import dataclasses as dc

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models.config import SHAPES

    total, out = torch.cuda.get_device_properties(0).total_memory, []
    for arch, layers, B in CELL_TRAIN_UNFIT:
        cfg = dc.replace(get_config(arch), layers=layers)
        need = cell_train_bytes(cfg, B, SHAPES["train_4k"].seq_len)
        if need <= CELL_TRAIN_FIT * total:
            raise AssertionError(f"[cells/train_4k {arch}] reckoned {need / 2**30:.1f} GiB fits: "
                                 f"run it")
        log(f"[cells/train_4k {arch}] not run: {layers} of {get_config(arch).layers} layers at "
            f"B={B} x S={SHAPES['train_4k'].seq_len:,}, {cfg.param_count() / 1e9:.2f} G "
            f"parameters, reckoned {need / 2**30:.1f} GiB (16 B a parameter + three f32 copies "
            f"of the logits) against {CELL_TRAIN_FIT:.0%} of the card's {total / 2**30:.1f} GiB")
        out.append((arch, need))
    return out


def cell_long(arch: str, layers, mem_rate: float) -> dict:
    """Phase 25(b), long_500k: ``arch`` at full width (``layers`` of it, or
    whole), bf16, B=1, a 524,288-row cache (and the recurrent states) drawn
    on the card from a seed, then ``CELL_STEPS`` greedy steps from index
    524,288 - steps; finite logits."""
    import dataclasses as dc

    import torch

    from repro_torch.configs.registry import get_config, supported_shapes
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TF
    from repro_torch.models.config import SHAPES

    cfg = get_config(arch)
    if "long_500k" not in supported_shapes(cfg):
        raise AssertionError(f"{arch} does not run long_500k")
    if layers is not None:
        cfg = dc.replace(cfg, layers=layers)
    S, G, V = SHAPES["long_500k"].seq_len, CELL_STEPS, cfg.vocab
    tag = f"[cells/long_500k {arch}]"
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        params, prompt = lm_seeded(cfg, 0, 1, 1)
        cache = TF.init_cache(cfg, 1, S, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        for t in tree_leaves(cache):
            t.normal_(generator=gen)
        resident = {"weights": nbytes(params), "cache": nbytes(cache)}
        step = STEPS.make_decode_step(cfg)
        state = {"cache": cache, "tok": prompt}
        del cache

        def run(i):
            logits, state["cache"] = step(params, state["cache"], state["tok"], S - G + i)
            state["tok"] = logits[:, -1:, :V].argmax(-1)
            return logits[:, 0, :V].float()

        with DispatchLog(MOE) as moe:
            outs, ms, kernels, busy, med = cell_steps(run, G)
        dec = torch.stack(outs, 1)
    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(dec).all()):
        raise AssertionError(f"{tag} non-finite logits")
    mlayers = lm_moe_layers(cfg)
    routed = moe.total("routed") / len(moe.routed) if mlayers else 0.0
    bound, bound_what = cell_decode_bound(params, cfg, routed, state["cache"], S - G, G, mem_rate)
    kinds = [TF.layer_spec(cfg, i)[0] for i in range(TF.num_layers(cfg))]
    r = cell_log(
        tag, f"{cfg.layers} of {get_config(arch).layers} layers ({kinds.count('attn')} attention, "
        f"{kinds.count('mamba')} mamba, {kinds.count('rwkv')} rwkv, {mlayers} MoE), bf16, B=1, "
        f"a seeded {S:,}-row cache, {G} greedy steps from index {S - G:,}: logits finite, max "
        f"|logit| {float(dec.abs().max()):.3f}" + (f"; {routed:.2f} of {cfg.num_experts} experts "
                                                     f"routed a MoE layer and step" if mlayers
                                                     else ""),
        {"ms": med, "ms_what": f"a step, median of steps 2-{G - 1}",
         "bound_ms": bound, "bound_what": bound_what,
         "kernels": kernels, "busy_ms": busy, "busy_what": f"step {G}", "top": profiled.top,
         "profiled_ms": ms[-1], "peak": peak, "resident": resident})
    del params, state
    free_cuda()
    return dict(r, step_ms=ms)


def cell_f32(arch: str, layers: int, G: int, mem_rate: float, f32_rate: float) -> dict:
    """Phase 25(c): ``arch`` at full width, ``layers`` of its layers, f32 (TF32
    off): a cached prefill of S - ``G`` tokens into an S-row cache
    (decode_32k's S; S - G a multiple of ``la_chunk``, as a recurrent
    prefill needs) and the steps to its last row, each within
    ``LM_DECODE_TOL`` of the uncached forward over the same S tokens
    (:func:`lm_check_f32`)."""
    import dataclasses as dc

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models.config import SHAPES

    cfg = dc.replace(get_config(arch), layers=layers, dtype="float32")
    S = SHAPES["decode_32k"].seq_len
    tag = f"[cells/decode_32k {arch} f32]"
    torch.cuda.reset_peak_memory_stats()
    params, prompt = lm_seeded(cfg, 0, 1, S - G)
    cache = nbytes(lm_model(cfg).init_cache(cfg, 1, S, device="meta"))
    out = lm_check_f32(cfg, params, prompt, G, tag, profile_last=1)
    peak = torch.cuda.max_memory_allocated()
    w = nbytes(params)
    pre_bound = ((prefill_flops(cfg, params, 1, S - G) + attention_flops(cfg, 1, S - G))
                 / f32_rate * 1e3)
    r = cell_log(
        tag, f"{layers} of {get_config(arch).layers} layers, f32, B=1: cached prefill of "
        f"{S - G:,} tokens {out['prefill_ms']:.1f} ms (bound {pre_bound:.1f} ms at the f32 "
        f"peak), {G} steps to row {S - 1:,} within {LM_DECODE_TOL} + {LM_DECODE_TOL}|logit| of "
        f"the forward over {S:,} tokens ({out['over_tol']:.3f} of it at worst), argmax at "
        f"{out['agree']} of {out['checked']}",
        {"ms": out["decode_ms"], "ms_what": f"a step, mean of {G}, the last profiled",
         "bound_ms": (w + cache) / mem_rate * 1e3,
         "bound_what": "f32 weights + the cache / memory rate",
         "kernels": round(out["work"]["kernels"]), "busy_ms": out["work"]["busy_ms"],
         "busy_what": f"step {G}", "top": [], "profiled_ms": out["decode_ms"], "peak": peak,
         "resident": {"weights": w, "cache": cache}})
    del params, prompt
    free_cuda()
    return dict(r, check=out)


def cells_phase(mem_rate: float, f32_rate: float, bf16_rate: float) -> dict:
    """Phase 25: the reference's shape cells on the card."""
    import torch

    from repro_torch.configs.registry import get_config

    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("f32 matmuls must run at full precision (TF32 off) for phase 25")
    if not set(CELL_PREFILL_F32_ONLY) <= {arch for arch, _, _ in CELL_F32}:
        raise AssertionError("a family without (c)'s f32 identity is exempt from prefill_32k's "
                             "argmax check")
    t_phase = time.perf_counter()
    # a 32k prefill's f32 score blocks are 2-9 GB each; segments that grow
    # in place keep them from fragmenting the cache allocator (kimi-k2's
    # one layer: 36 GiB of weights beside four blocks of 8 GiB)
    free_cuda()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    cut = lambda layers, arch: (f" {layers} of {get_config(arch).layers} layers"
                                if layers is not None else "")
    log("[cells] cuts (batch and depth only; no length cut): decode_32k B=128 -> 1 and "
        + ", ".join(f"{arch}{cut(layers, arch)} B={B}" for arch, layers, B in CELL_SERVE)
        + f"; prefill_32k B=32 -> {CELL_PREFILL_B}, the same depths; train_4k B=256 -> "
        + ", ".join(f"{arch}{cut(layers, arch)} B={B}" for arch, layers, B, _ in CELL_TRAIN)
        + "; not run (over the card): " + ", ".join(f"{arch}{cut(layers, arch)} B={B}"
                                                    for arch, layers, B in CELL_TRAIN_UNFIT)
        + f"; long_500k jamba-v0.1-52b 32 -> {CELL_JAMBA_LAYERS} layers; (c) in f32 "
        + ", ".join(f"{arch}{cut(layers, arch)}" for arch, layers, _ in CELL_F32))

    def timed(fn, *args):
        t = time.perf_counter()
        r = fn(*args)
        log(f"[cells] {fn.__name__}{args[:2]} took {time.perf_counter() - t:.1f} s")
        return r

    out = {"narrow": [timed(cell_narrow_decode, arch, cell, B, mem_rate)
                      for arch, cell, B in CELL_NARROW] + [timed(cell_narrow_train, f32_rate)]}
    free_cuda()
    out["serve"] = [timed(cell_serve, arch, layers, B, mem_rate, bf16_rate)
                    for arch, layers, B in CELL_SERVE]
    out["train"] = [timed(cell_train, arch, layers, B, lr, mem_rate, bf16_rate)
                    for arch, layers, B, lr in CELL_TRAIN]
    out["unfit"] = cell_train_unfit()
    out["long"] = [timed(cell_long, "jamba-v0.1-52b", CELL_JAMBA_LAYERS, mem_rate),
                   timed(cell_long, "rwkv6-3b", None, mem_rate)]
    out["f32"] = [timed(cell_f32, arch, layers, G, mem_rate, f32_rate)
                  for arch, layers, G in CELL_F32]
    log(f"[cells] phase done in {time.perf_counter() - t_phase:.1f} s; {loadavg()}")
    return out


# ---------------------------------------------------------------------------
# Phase 26: the fit tool on the card
# ---------------------------------------------------------------------------

#: the suite's down-scale for the fit tool's quick run: ids 1, 9, 12, 16 at
#: 5,442, 1,024, 1,000 and 576 rows
FIT_SCALE = 256


def fit_phase() -> dict:
    """Phase 26: ``fit_device_model`` with ``--quick`` at ``FIT_SCALE`` on the
    card, through the CSR-k kernel; its JSON read back through
    ``tuner.load_fitted_device_model(path, "h100")``."""
    import tempfile

    from repro_torch.core import tuner
    from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
    from repro_torch.launch import fit_device_model as fdm

    t0 = time.perf_counter()
    spmv_csrk_tiles.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "device_model.json")
        result = fdm.run(scale=FIT_SCALE, quick=True, out=path, device="cuda")
        model = tuner.load_fitted_device_model(path, "h100")
    launches = spmv_csrk_tiles.launches
    want = result["model"]["h100"]
    got = {"ssrs": [model.ssrs_a, model.ssrs_b], "srs": [model.srs_a, model.srs_b],
           "gather_chunk": model.gather_chunk}
    if model.name != "h100" or got != want:
        raise AssertionError(f"the fit tool wrote {want}, read back as {model}")
    if tuple(r["id"] for r in result["rows"]) != fdm.QUICK_IDS or launches == 0:
        raise AssertionError(f"the fit tool swept {[r['id'] for r in result['rows']]} with "
                             f"{launches} CSR-k launches")
    for line in fdm.report(result, path).splitlines():
        if not line.startswith("# grid"):
            log(f"[fit] {line}")
    log(f"[fit] read back through load_fitted_device_model(path, 'h100'): {model}; "
        f"{launches} spmv_csrk_tiles launches; {time.perf_counter() - t0:.1f} s")
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.spmv_suite import load_suite
    from repro_torch.core import block_cg, cg, prepare, tuner
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
    from repro_torch.obs import get_registry
    from repro_torch.sparse import CSRMatrix

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    # 1. build; then phase 24's dry runs (the CLI's cells and those phases
    # 21-23 measure), on the host, in the background
    build_all(("spmv_csrk", "spmv_sellcs", "spmv_segsum", "spmv_diahybrid", "spmv_ell"))
    dry_cli = start_modules(("dryrun", ("--arch", arch, "--shape", shape))
                            for arch, shape in DRY_CLI)
    dry_bg = start_dry_cells()

    # 2. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    mem_rate, f32_rate, bf16_rate = peaks(kind)
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; peaks used: "
        f"{mem_rate / 1e12:.2f} TB/s, {f32_rate / 1e12:.0f} TFLOP/s f32, "
        f"{bf16_rate / 1e12:.0f} TFLOP/s bf16 (tensor cores)")

    # 3. kernel vs plain on a small suite matrix
    t0 = time.perf_counter()
    A_small = load_suite(scale=64, ids=[8])["ecology1"]
    op_small = prepare(A_small, device="cuda", format="auto")
    errs = kernel_vs_plain(views_for(op_small.csrk, ("f32", "bf16", "int8")),
                           op_small.csrk.csr.row_lengths(), A_small.n, 0,
                           f"ecology1/64 ({A_small.m} rows)")
    torch.cuda.synchronize()
    log(f"[kernel] {len(errs)} cases within bound, repeat launches and B=8 columns "
        f"bit-equal, every launch bit-equal to ref.csrk_tile_rows_in_order; max |err| "
        f"{max(errs.values()):.3e} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    errs16 = csrk_bf16x_small(op_small, A_small)
    torch.cuda.synchronize()
    log(f"[kernel] bf16 x: {len(errs16)} cases (B=1 and 8) y bf16, every row within the "
        f"float64 bound (r 2^-8 + (2k+2) eps32)|A||x| (r = {FOLD_ROUNDINGS} on the rows a "
        f"remainder is folded into) and the plain bound (k+2) 2^-7 |A||x|, repeat launches and "
        f"B=8 columns bit-equal, tile rows bit-equal to ref.csrk_tile_rows_in_order's bf16 "
        f"form; worst |err| {max(e['f64'] for e in errs16.values()):.3e} vs float64, "
        f"{max(e['plain'] for e in errs16.values()):.3e} vs plain; spmm_width=8 padding gives "
        f"each bf16 column its lone launch's bits ({time.perf_counter() - t0:.1f} s)")

    # 4. main path at the paper's ecology1 size
    t0 = time.perf_counter()
    A = load_suite(scale=1, ids=[8])["ecology1"]
    log(f"[main] ecology1: {A.m} rows, {A.nnz} nnz (built in {time.perf_counter() - t0:.1f} s)")
    t_main = time.perf_counter()
    reg = get_registry()
    reg.clear()
    spmv_csrk_tiles.launches = 0
    t0 = time.perf_counter()
    op = prepare(A, device="cuda", format="auto")
    t_prep = time.perf_counter() - t0
    if op.backend != "csrk":
        raise AssertionError(f"ecology1 routed to {op.backend}, expected csrk")
    if op.device_model != "h100":
        raise AssertionError(f"prepare's default device model is {op.device_model!r}, "
                             f"expected 'h100'")
    phases = {r["name"]: r["value"] for r in reg.records() if r["section"] == "prepare"}
    log(f"[main] prepare {t_prep:.1f} s: " + ", ".join(
        f"{k[6:-3]} {v / 1e3:.1f} s" for k, v in sorted(phases.items())
        if k.startswith("phase.") and k.endswith("_ms")))
    T = op.tiles.num_tiles
    log(f"[main] device model {op.device_model!r} ({tuner.active_h100_model()})")
    log(f"[main] params {op.params}; tiles {T} x {op.tiles.rows_per_tile} rows, "
        f"window {op.tiles.window}, buckets {op.tile_buckets.bucket_slots()}, "
        f"remainder {op.tiles.remainder_nnz}; modeled_bytes() {op.modeled_bytes()} "
        f"(prices a 2*window x slice per tile)")
    A_dev = A.to("cuda")
    A64 = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.double(), A_dev.shape)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(A.n).astype(np.float32)).cuda()
    y = op.apply_original(x)
    y_plain = ref.spmv_csr(A_dev, x)
    A_abs = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.abs(), A_dev.shape)
    bound = row_bound(ref.spmv_csr(A_abs, x.abs()), A_dev.row_lengths())
    err = check_close(y, y_plain, bound, "apply_original vs plain CSR")
    log(f"[main] apply_original vs plain CSR product: max |err| {err:.3e}")

    perm, inv = op._perm_dev, op._inv_perm_dev
    x_true = torch.from_numpy(rng.standard_normal(A.n).astype(np.float32)).cuda()
    b = ref.spmv_csr(A_dev, x_true)
    t0 = time.perf_counter()
    res = cg(op, b[perm], tol=1e-5, maxiter=5000)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    xs = res.x[inv]
    true_res = float(torch.linalg.norm(b.double() - ref.spmv_csr(A64, xs.double()))
                     / torch.linalg.norm(b.double()))
    log(f"[main] cg: {res.iters} iterations, recurrence residual "
        f"{float(res.residual) / float(torch.linalg.norm(b)):.3e}, true relative residual "
        f"{true_res:.3e}, {t_cg:.2f} s ({t_cg / max(res.iters, 1) * 1e3:.3f} ms/iter)")
    if res.iters >= 5000 or not true_res <= 1e-4:
        raise AssertionError("cg did not converge on ecology1")

    X_true = torch.from_numpy(rng.standard_normal((A.n, 8)).astype(np.float32)).cuda()
    Bm = ref.spmm_csr(A_dev, X_true)
    t0 = time.perf_counter()
    bres = block_cg(op, Bm[perm], tol=1e-5, maxiter=5000)
    torch.cuda.synchronize()
    t_bcg = time.perf_counter() - t0
    Xs = bres.X[inv]
    true_b = (torch.linalg.norm(Bm.double() - ref.spmm_csr(A64, Xs.double()), dim=0)
              / torch.linalg.norm(Bm.double(), dim=0))
    log(f"[main] block_cg (8 rhs): {bres.iters} iterations, worst true relative residual "
        f"{float(true_b.max()):.3e}, {t_bcg:.2f} s ({t_bcg / max(bres.iters, 1) * 1e3:.3f} "
        f"ms/iter)")
    if bres.iters >= 5000 or not float(true_b.max()) <= 1e-4:
        raise AssertionError("block_cg did not converge on ecology1")
    launches = spmv_csrk_tiles.launches
    log(f"[main] phase done in {time.perf_counter() - t_main:.1f} s")
    spmvs = 1 + (1 + res.iters) + (1 + bres.iters)   # apply_original, then each solve
    log(f"[main] spmv_csrk_tiles launches on the main path: {launches} "
        f"({launches / spmvs:.2f} per SpMV over {spmvs} SpMVs)")
    if launches == 0:
        raise AssertionError("the main path never launched the CUDA kernel")
    log(f"[main] cg {res.iters} and block_cg {bres.iters} iterations, true relative residual "
        f"{true_res:.3e}; under 'ampere' the kernel, whose sums do not depend on the tile, "
        f"took 129 and 133 iterations to 9.855e-06")
    for xb in (x, X_true):
        y_k, y_in_order = csrk_in_order(op.tile_buckets, xb)
        if not torch.equal(y_k, y_in_order):
            raise AssertionError(f"ecology1 B={xb.shape[1:] or 1}: kernel != "
                                 f"ref.csrk_tile_rows_in_order bits")
    log("[main] at full size the kernel equals ref.csrk_tile_rows_in_order bit for bit "
        f"(B = 1 and 8, all {op.tile_buckets.num_buckets} buckets)")
    # the A100 model's container, from the same Band-k permutation
    t0 = time.perf_counter()
    op_amp = prepare(op.csrk.csr, "ampere", device="cuda", reorder="natural")
    t_amp = time.perf_counter() - t0
    params_h100, params_amp = op.params, op_amp.params
    touched = torch.zeros(A.m, dtype=torch.bool, device="cuda")
    for o in (op, op_amp):
        touched[perm[o.tile_buckets.rem_row.long()]] = True
    for xb in (x, X_true):
        y_h = op.apply_original(xb)
        y_a = op_amp.apply_original(xb[perm])[inv]
        if not torch.equal(y_h[~touched], y_a[~touched]):
            raise AssertionError(f"ecology1 B={xb.shape[1:] or 1}: the 'h100' and 'ampere' "
                                 f"containers give other bits")
    log(f"[main] 'ampere' container from the same permutation: params {op_amp.params}; tiles "
        f"{op_amp.tiles.num_tiles} x {op_amp.tiles.rows_per_tile} rows, buckets "
        f"{op_amp.tile_buckets.bucket_slots()}, remainder {op_amp.tiles.remainder_nnz} (h100's "
        f"{op.tiles.remainder_nnz}); prepare {t_amp:.1f} s; apply_original bit-equal to the "
        f"'h100' one at B = 1 and 8 on the {int((~touched).sum())} of {A.m} rows no remainder "
        f"touches")
    spmv_csrk_tiles.launches = 0
    folded = torch.zeros(A.m, dtype=torch.bool, device="cuda")
    folded[perm[op.tiles.rem_row.long()]] = True
    err16 = bf16x_full("main", op.apply_original, A_dev, 7, folded)
    bf16_launches = spmv_csrk_tiles.launches
    log(f"[main] bf16 x path: spmv_csrk_tiles launches {bf16_launches}")
    if bf16_launches == 0:
        raise AssertionError("the bf16-x path never launched the CUDA kernel")

    # 5. timing at the ecology1 shapes
    t0 = time.perf_counter()
    m, n, nnz = A.m, A.n, A.nnz
    csr = op.csrk.csr
    sp = library_csr(csr)
    views = views_for(op.csrk, ("bf16", "int8"), layouts=("bucketed",))
    views["f32"] = {"bucketed": op.tile_buckets}
    gen = torch.Generator(device="cuda").manual_seed(1)
    variants = []
    yardstick = {}
    for dt in ("f32", "bf16", "int8"):
        view = views[dt]["bucketed"]
        scale_bytes = sum(4 * b.val_scale.numel() for b in view.buckets
                          if b.val_scale is not None)
        abs_view = abs_tiles(view)
        for B in (1, 8):
            xb = torch.randn((n, B), generator=gen, device="cuda")
            xb = xb[:, 0].contiguous() if B == 1 else xb
            yk = ops.spmv_csrk_bucketed(view, xb)
            yp = ref.spmv_csrk_buckets(view, xb)
            bound = row_bound(ref.spmv_csrk_buckets(abs_view, xb.abs()), csr.row_lengths())
            err = check_close(yk, yp, bound, f"ecology1 {dt} B={B}")
            nbytes = nnz * (VALUE_BYTES[dt] + 8) + scale_bytes + n * 4 * B + m * 4 * B
            variants.append(time_variant(
                "time", dt, B, err, lambda: ops.spmv_csrk_bucketed(view, xb),
                lambda: ref.spmv_csrk_buckets(view, xb),
                (lambda: sp @ xb) if dt == "f32" else None, nbytes, nnz, (mem_rate, f32_rate),
                yardstick=yardstick))
    sp16 = library_bf16(csr)
    view = op.tile_buckets
    abs_view = abs_tiles(view)
    bf16_variants = []
    for B in (1, 8):
        xb = torch.randn((n, B), generator=gen, device="cuda").to(torch.bfloat16)
        xb = xb[:, 0].contiguous() if B == 1 else xb
        bf16_variants.append(bf16x_time(
            "time", xb, lambda x: ops.spmv_csrk_bucketed(view, x),
            lambda x: ref.spmv_csrk_buckets(view, x),
            lambda x: ref.spmv_csrk_buckets(abs_view, x), csr.row_lengths(), sp16,
            nnz * (4 + 8) + 2 * n * B + 2 * m * B, nnz, (mem_rate, f32_rate)))
    # the two device models' containers, timed in turns beside cuSPARSE
    by_model = {}
    views_by = {"h100": op.tile_buckets, "ampere": op_amp.tile_buckets}
    for B in (1, 8):
        xb = torch.randn((n, B), generator=gen, device="cuda")
        xb = xb[:, 0].contiguous() if B == 1 else xb
        got = {k: [] for k in views_by}
        for k in ("h100", "ampere", "ampere", "h100"):
            got[k].append(time_ms(lambda: ops.spmv_csrk_bucketed(views_by[k], xb)))
        by_model[B] = {"library_ms": yardstick[B], **got}
        log(f"[time] f32 B={B} by device model: 'h100' {op.params.ssrs}x{op.params.srs} "
            f"{got['h100'][0]:.4f}, {got['h100'][1]:.4f} ms; 'ampere' "
            f"{op_amp.params.ssrs}x{op_amp.params.srs} {got['ampere'][0]:.4f}, "
            f"{got['ampere'][1]:.4f} ms; cuSPARSE {yardstick[B]:.4f} ms")
    log(f"[time] done in {time.perf_counter() - t0:.1f} s")

    # 26. the fit tool on the card
    fit_phase()

    # 6.-8. the SELL-C-σ kernel and its path
    sell_entry, bmw = sellcs_phases(mem_rate, f32_rate)

    # 9.-11. the segmented-sum kernel and its path
    segsum_entry, zipf = segsum_phases(mem_rate, f32_rate)

    # 12.-14. the DIA/CSR-hybrid kernel and its path
    dia_entry, fringe = dia_phases(mem_rate, f32_rate)

    # 15.-17. the ELL kernel and its path
    ell_entry = ell_phases(mem_rate, f32_rate, bmw, fringe,
                           {e["name"]: e for e in (sell_entry, dia_entry)})

    # 19. the serving engine over the four route matrices
    serving = serve_phase({"ecology1": (A, "csrk"), "bmwcra_1": (bmw["A"], "sellcs"),
                           "powerlaw_zipf": (zipf, "segsum"),
                           "stencil_fringe(2048)": (fringe, "diahybrid")})

    # 20. the distributed layer: D row-block shards on the card
    distributed = distributed_phase(A_small, {"op": op, "b": b, "perm": perm, "cg": res}, bmw)

    # 21. the LM tree's serving path; the SpMV phases' operators go first
    del op, op_amp, op_small, A, A_small, A_dev, A64, bmw, zipf, fringe, views, view, abs_view
    del sp, csr
    del x, X_true, Bm, b, xb
    gc.collect()
    torch.cuda.empty_cache()
    lm_rows = lm_phase(mem_rate, bf16_rate)

    # 22. the LM tree's training path
    free_cuda()
    train_rows = train_phase(mem_rate, bf16_rate)

    # 23. the sharded LM path
    free_cuda()
    sharded = sharded_phase(mem_rate, bf16_rate, lm_rows, train_rows)

    # 24. the dry run and the examples
    free_cuda()
    dryrun_phase(lm_rows, train_rows, sharded, dry_cli, dry_bg)

    # 25. the reference's shape cells
    free_cuda()
    cells_phase(mem_rate, f32_rate, bf16_rate)

    # 18. result lines
    kernels = {"kernels": [kernel_entry(
        "spmv_csrk_tiles", "src/repro_torch/csrc/spmv_csrk.cu",
        "src/repro/kernels/spmv_csrk.py:131", launches, variants,
        {"matrix": "ecology1", "m": m, "n": n, "nnz": nnz, "value_dtype": "f32", "B": 1},
        bf16_x=bf16_entry(bf16_launches, errs16, err16, bf16_variants),
    ), sell_entry, segsum_entry, dia_entry, ell_entry]}
    kernels["kernels"][0]["device_models"] = {
        "h100": dataclasses.asdict(params_h100), "ampere": dataclasses.asdict(params_amp),
        "f32_ms_in_turns": by_model}
    for entry in kernels["kernels"]:
        entry.update(serving[entry["name"]])
        entry.update(distributed.get(entry["name"], {}))
    print(json.dumps(kernels), flush=True)
    log(f"[card] {card}")
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dry-cells"]:
        sys.exit(dry_cells_main(sys.argv[2]))
    sys.exit(main())
