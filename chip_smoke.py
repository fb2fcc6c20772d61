#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its CUDA kernels to
their plain version.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an H100:
the kernels are built for sm_90a).  Phases, each of which fails the run:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: one ``nvcc`` per source under ``taboo_brittleness_tpu_torch/csrc/``,
   started together; each kernel's registers, spills and shared memory as
   ``-Xptxas -v`` reports them; beside them the host's npz writer
   (``native/npz_writer.cpp``, one ``g++`` against zlib), its library's
   path, the host's cores and the writer's deflate threads;
3. kernel: ``ops.lens_kernel.lens_stats`` (the wgmma route) against
   ``lens_stats_reference`` at the main path's shape (N = 1140, D = 3584,
   V = 256000, K = 5, bf16), with and without the cap, with one target and
   with per-row targets; its raw [S, N] partials against
   ``lens_stats_partials_reference``; the wgmma call timed, split into
   kernel body and torch epilogue, beside the library yardstick and the
   bound;
   then the wgmma kernel's long list (K 16 and K 32 = KMAX_WIDE) on the
   same call, stats and raw partials against the plain version, timed in
   turns with K 5 (5, 16, 32, 32, 16, 5) beside the library yardstick (the
   bf16 product in f32, ``logsumexp``, ``topk`` at that K), the plain
   version and the bound; then the f32 builds of the Hopper kernels (3xTF32) at N 1140, K 5
   (wgmma) and N 8, K 1 (split-V) against the plain version, timed beside
   the f32 library call (TF32 off, matmul precision "highest", both set)
   and two bounds: three TF32 products (3xTF32) and the f32 FMA rate, with
   a NOTE where a call is not below its library call; last, a top-k above
   KMAX_WIDE on the Hopper kernels (ceil(K / 32) certified passes, the
   split-V kernel certifying in its last blocks): bf16 at N 1140 and 8, K
   33, 64 and 128, and f32 at N 1140 and 8, K 64, each against the plain
   version (values at ATOL, ids entry by entry where clear), its launches
   by route (pass 1 and refills) and, per refill, the blocks of its fixed
   grid that ran and the open units (``lens_kernel.refill_work``), timed
   in turns with the library call at that K (library, call, call,
   library), beside the plain version and the bound; the worst cases at K
   128, bf16, N 1140 and 8 (one row's whole top-k planted in one chunk,
   and x = 0: every pair saturates), on exact inputs, ids and values equal
   to the plain version's bit for bit, timed beside the library call and
   the bound (a NOTE where not at or below the library call); a K 128
   call at each N under
   ``torch.cuda.set_sync_debug_mode("error")``; and a K 64 call at N 1140
   captured in a CUDA graph, its replay bit-equal to the eager call;
   3b. the split-V kernel (every bf16 readout of at most SPLITV_MAX_ROWS
   rows, K <= KMAX_WIDE) against the plain version at N in {1, 8, 16, 32,
   33, 64}, K in {1, 5, 8, 16, 32}, cap None and 30, per-row targets with
   -1 and V - 1, V 256000 and 128000: its merged stats (merged by its last
   block) and its raw partials at K 5 and K 32 (the latter with a target at
   the first, second, middle and last column of the chunks); exact ties
   planted on both sides of chunk edges at K 5, 8, 16 and 32; then the
   split-V and the wgmma route (its plan built on purpose) timed in turns
   on the same K = 1 readouts behind a sleep kernel at N in {1, 8, 16, 32,
   48, 64} beside the library yardstick and the bound (the crossover), the
   body and the torch merge apart at N 8, the tp shard's N 8, V 128000,
   and the long list's calls at N 8 and 32, K 16 and 32 beside their
   library call, plain version and bound; then the f32 builds of the
   split-V and the wgmma kernels on the same K = 1 readouts at the same N,
   each held to the plain version and timed in turns (the f32 crossover
   that sets SPLITV_F32_MAX_ROWS);
   3c. the f16 builds (a ``model.dtype: float16`` run): N 1140 at K 5, 16
   and 64 (the wgmma build; K 64 two certified passes) and N 8 at K 1 and
   64 (the split-V build), cap None and 30, a scalar target and per-row
   targets with -1 and V - 1, each against the plain version at ATOL with
   ids equal wherever the margins clear; K 5 at N 1140 and K 1 at N 8 timed
   in turns with the bf16 build of the same call (bf16, f16, f16, bf16)
   beside the f16 library yardstick, the plain version and the bound (a
   NOTE where not below the library call); both routes at N 48 and 64,
   held and timed in turns (the f16 crossover: f16 takes bf16's
   SPLITV_MAX_ROWS);
4. edges: bf16 at N in {1, 129, 1140} and f32 at N in {1,
   SPLITV_F32_MAX_ROWS + 1, 129, 1140}, V in {384, 256000}, D in {72,
   3584}, K in {1, 5, KMAX, 16, KMAX_WIDE} (on the Hopper kernels) and
   KMAX_WIDE + 1 (two certified passes of the long list), and f16 at N in
   {1, SPLITV_MAX_ROWS + 1, 129}, V 384, D 72, K in {1, KMAX, KMAX_WIDE,
   KMAX_WIDE + 1}, cap None and 30,
   one target and per-row targets with -1, each route of each dtype reached
   by at least one case; then exact ties from duplicated embedding rows in
   different tiles, at K 5, 8, 16, 32 and 33, and for K 16 and up also on
   both sides of the wgmma plan's chunk edges; in f32 and in f16 on both
   sides of two chunk edges of the wgmma plan at N 1140 and of the split-V
   plan at N 8;
5. a tiny f32 model through the lens pass on the card (N 33 on the split-V
   kernel's f32 build, N 77 on the wgmma kernel's, each route's launches
   counted) and on the CPU (the plain tap), at 1e-5;
   5b. a 2-layer f32 model at Gemma-2-9B width (seeded random weights made
   on the card, ~4.9 GiB) through ``lens.lens_forward`` with the kernel tap
   for the 10 prompts at their padded 64 columns (the wgmma kernel's f32
   build) and one prompt's last 8 columns (the split-V kernel's), each held
   to the same call with the plain tap on the card: probabilities at 1e-5,
   top-5 ids equal wherever the margins clear; the launches counted from 0
   just before each pass are the f32 entries' ``launches``;
6. main path: Gemma-2-9B width (42 layers, seeded random bf16 weights made on
   the card), ``run_generation`` then ``run_evaluation`` for the default
   config's 10 prompts, through a model loader, into a temporary directory;
   the kernel must have launched 42 times per lens pass, all on the wgmma
   route; then one more ``run_evaluation`` of the second word at ``top_k``
   16 (the wgmma kernel's long list): 42 launches, all wgmma, no refill,
   its lens taps' top-5 ids and its top-5 guesses equal the K 5 pass's
   wherever the 5th/6th margin clears;
7. SAE and interventions, at the same width with a seeded random
   3584 x 16384 f32 SAE made on the card: ``analyze_sae_baseline`` over the
   cache the main path wrote (top latents equal to the same function on the
   CPU where margins are clear); identity arms (``measure_arm`` with every
   latent id -1, and with zero projection bases: tokens equal to the
   baseline on every row, |ΔNLL| <= 1e-4); ``run_intervention_study`` for
   one word at the default intervention config (6 budgets x 11 arms and 4
   ranks x 11 arms: 110 arms, 1100 decode rows in launches of 330, 330, 220
   and 220 rows), its JSON held to the schema of
   ``results/fixtures/intervention_moon.json``; ``ablate_latents`` at one
   arm launch's prefill shape (330 rows x 64 columns x 3584, up to 32 ids
   per row, and one shared set) against the plain ``x + decode(ablated) -
   decode(encode(x))``, with a row-shifted and an id-dropped patch shown to
   miss the tolerance; last, the largest budget's targeted arm in a launch
   of the same row count holding only copies of it, against the same arm
   inside its folded launch (tokens equal, ΔNLL within 1e-4), and alone
   through ``measure_arm`` (reported).  This path launches no kernel of its
   own: every product is a ``torch.matmul``;
8. attacks and the multi-word study sweep, at the same width, with phase 6's params
   and tokenizer and phase 7's SAE: ``run_token_forcing`` (pre- and
   postgame) for two words through a shared-model loader, in exactly
   launches of 10, 1, 1, 1 and 10 rows (the memo serves both words), every
   completion opening with its prefill, 3 warm-up replies without
   ``<end_of_turn>``, the per-word and aggregate JSONs written, and a second
   call that loads no model and returns equal entries; then
   ``run_prompting_attacks`` in two launches of 10 rows.
   ``forcing_under_arms`` in the study's ablation layout (7 arms: all -1
   ids, then the six budgets' targeted rows; launches of 70, 7, 7, 7, 70
   rows), whose identity arm must equal, token for token, an unedited
   decode of the same rendered rows at the same row count (the 70 pregame
   rows, and the 70 final rows built from the identity arm's own warm-up);
   against the 10-row pregame launch it is only reported.  The SAE edit is
   wrapped to keep each row's patch at the edit layer: the identity arm's
   must be zero, and the largest budget's targeted arm must have one in
   each of the five launches and equal, in tokens and patches (rtol 1e-5),
   the launch made again with the same rendered rows and 7 copies of that
   arm's ids.
   ``run_intervention_studies`` with forcing over moon, ship and bad
   through a ``CheckpointManager`` (ship a full copy of the params made on
   the card and served by the prefetch while moon's study runs, so the
   sweep's peak memory is a full-snapshot CLI sweep's; bad's load raises an
   error that is not transient): bad quarantined in
   ``_failures.json``, the other two written with the fixture's schema plus
   the forcing blocks (``"edit": "none"`` on the baseline,
   ``"all-positions"`` on every targeted arm, none on random arms), forcing
   launches of 70, 7, 7, 7, 70 and 40, 4, 4, 4, 40 rows per word, and a
   second call that loads only bad and returns equal JSON.  Seconds of
   every attack launch, forcing and study seconds per word and the phase's
   peak device memory are printed.  No kernel of its own either;
9. delta residency and speculation, at the same width with phase 6's
   params as the base: two words made on the card from seeded edits
   (``final_norm`` and the stacked ``layers.k`` with noise, ``xor``;
   ``layers.input_norm`` set to m * 2^-12, ``q8``), packed, saved, loaded
   and applied bit-equal to each word's params on every leaf, with codecs,
   byte ratio, artifact bytes and the switch time (``load_delta`` +
   ``apply_packed``, once per word); ``run_generation`` for both words through
   a delta-mode ``CheckpointManager`` (capacity 1; its base slot seeded with
   phase 6's triple, as no snapshot can be read here) with the second word
   served by the prefetch, and through a plain loader of the materialised
   params, the two runs' tokens equal row for row; then the main path's
   prompts with ``TBX_SPECULATE=1`` at the default plan (k = 28, G = 3), at
   G = 1 and 5 and with a 3-layer draft (k = 2) between two vanilla runs,
   that draft on a word whose later layers outweigh the embedding (most
   drafts rejected: accept rate under ``LOW_ACCEPT``), one
   ``TBX_SPECULATE_CAPTURE=1`` launch, and ``run_token_forcing`` for two
   words under speculation, each held to vanilla row by row: a row may
   differ only first at a token whose vanilla top-1/top-2 logit gap is
   under ``SPEC_MARGIN`` (margins recorded from the vanilla decodes' own
   logits, phase 8's for the forcing); each generated column of the
   captured residual within ``CAPTURE_RTOL`` relative L2 error of
   vanilla's on equal rows, while the capture read one column on and a
   capture of the draft's layer miss it; and
   forcing texts equal to phase 8's on rows with equal tokens.  Blocks,
   accept rate, tokens per verify and seconds beside vanilla's, load
   sources and seconds, and the phase's peak memory are printed.  No kernel
   of its own: the draft head is a ``torch.matmul`` + argmax.

10. the decode launch path, at the same width on phase 6's params: every
   decode of phases 6 to 9 already steps through ``runtime.aot``'s CUDA
   graphs (phase 8's peak memory must stay under ``PEAK_GIB``); here one
   eager and one graphed step of the main path's 10-row decode under
   ``torch.profiler`` (kernels per step, host and device ms, the eager
   step's device time split into attention, weight matmuls and the rest)
   and 10 of each timed with CUDA events; the main path's decode eager
   (``TBX_AOT=0``) then graphed, tokens and residual
   compared; a 330-row ablation and a 220-row projection launch of the
   study, eager and graphed, tokens, residual and ΔNLL compared;
   at a sixth of the study's depth (budget 1; rank 1),
   ``run_intervention_study`` with ``TBX_FUSED=1`` against ``TBX_FUSED=0``
   (JSON identical), then ``warm_start_study`` and the study again (zero
   misses), then the studies driver over two words at the same depth
   with its cross-word pre-dispatch (timed); graphed decodes of two words of equal
   shapes, each against its own eager decode (the second must not
   reproduce the first's tokens); speculation at G = 3 graphed against
   eager (tokens equal).  Graphed results are held bit-equal to eager.
   Should tokens differ, the max abs diff and first diverging tokens are
   printed and the tokens held under phase 9's margin rule, the residual
   still bit-equal on the columns before a row's first divergence and the
   ΔNLL everywhere.
11. in-process serving, at the same width on phase 6's params, phase 7's
   SAE and phase 9's delta words, with the CLI's engine envelope (8 slots,
   max_context 160, prompt_cols 96, edits and lens tap at the config's
   layer 31), after phase 10's programs are dropped: ``ServeEngine``
   warm-started (its step one CUDA graph, the lens readout's
   ``lens_stats`` launched inside it) drives 8 sessions over the first 8
   hint prompts, held to ``greedy_decode`` of the same prompts under phase
   9's margin rule (11a); the same sessions through an engine stepping
   eagerly (``TBX_AOT=0``) give bit-equal tokens and lens probabilities,
   launching the split-V kernel once per step and no other lens kernel
   (the counts set to 0 before the sessions: the kernels line's split-V
   ``launches``), and every readout's kernel call at the serving shape (N
   = 8, K = 1) is held to ``lens_stats_reference`` on its own inputs (logsumexp,
   target and top-1 logits within ATOL, P(target) within
   SERVE_PROB_RTOL), a zeroed and a row-shifted result must miss that
   check, and the engine's lens probabilities are held to the plain
   readout of the eager run's taps within SERVE_PROB_RTOL (11b); one prompt in four slots (plain, 8 SAE latents
   ablated, plain, a rank-4 basis removed): the plain slots bit-equal, the
   edited ones reading other lens probabilities (11c);
   ``loadgen.run_inprocess`` with 32 requests, seed 0, concurrency 16,
   50/s over chat, chat_lens, sae_ablate, projection and forcing:
   completed == admitted, no registry miss, the ``serve_latency`` report
   printed (11d); the multi-word engine over phase 9's two words' stacked
   deltas, each slot bit-equal to a single-word engine on that word's
   applied params, no miss under ``serve.step.multi`` (11e); then step ms
   graphed and eager for the single- and the multi-word engine (CUDA
   events over 20 steps, one step profiled: the readout kernels in each
   profiled step, counted by name, must be the engine's
   ``readouts_per_step``, 1 and W = 2, all of the route a readout of 8
   rows takes (``readout_route``: split-V), the readout's ``lens_stats`` at
   N = 8 against its bound, plain version and library yardstick, and the
   phase's peak memory (11f).
12. the speculative serve engine and the serve process, at the same width
   and envelope, phase 7's SAE and phase 9's delta words, after phase 11's
   programs are dropped; plan k = 2, G = 3.  ``SpecServeEngine``
   warm-started (a draft and a verify graph, no registry miss after) over
   the 8 hint-prompt sessions; the same sessions through an eager engine
   (``TBX_AOT=0``) bit-equal in tokens, lens probabilities and accepted
   drafts; tokens held row by row to the vanilla ``ServeEngine`` (eager,
   each emitted token's top-1/top-2 gap read from its logits) under phase
   9's margin rule, each first divergence printed with its gap (12a);
   every eager verify readout's ``lens_stats`` call (N = S (G + 1) = 32,
   K = 1) held to ``lens_stats_reference`` on its own inputs at 11b's
   tolerances, a zeroed and a row-shifted result missing, and the call
   timed on the card behind a sleep kernel beside the library yardstick,
   the plain version and the bound (12b); the W = 2 engine over the delta
   words, each slot bit-equal to a single-word speculative engine on its
   word's applied params (12c); draft, verify and step ms graphed and
   eager for both engines (CUDA events over 20 launches) and one profiled
   step each, whose ``lens_splitv_kernel`` count (the route of N 32) must
   be 1 and W, with no other lens kernel; phase
   11d's load under ``TBX_SERVE_SPECULATE=1`` (goodput 32/32, accept rate
   per scenario, tokens/s beside 11d's) (12d); ``serve_forever`` in
   process over 16 pre-written requests (exit 0, ``_serve.json`` with no
   miss), then drained by ``request_drain()`` after the first response
   (exit 75, every claimed request answered) and rerun to the end (12e);
   the process on the card's default device, the tiny synthetic stack:
   ``supervise -- serve --max-requests 8`` (exit 0, 8 responses,
   ``_supervise.json``) and beside it a speculative ``serve`` SIGTERMed on
   its own PID (exit 75, progress ``preempted``) (12f).  The phase's seconds and
   peak memory are printed.
13. the multi-tap capture, the grid and the attack search, at the same
   width after phase 12's programs are dropped: the main path's 10 prompts
   and 50 new tokens graphed with ``capture_residual_layer=(9, 20, 31)``,
   each slot bit-equal to a graphed single-tap capture at its layer, the
   1-tuple to the int, eager (``TBX_AOT=0``) to graphed, no registry miss
   on a second call (13a); ``GridSpec.build([31], [16384, 65536])``
   with synthetic cells over phase 9's two delta words (each captured
   once), the 4 units through a ``FleetSpool`` and ``fleet.run_worker``
   in this process with each word loaded through the delta
   ``CheckpointManager``: the matrix complete, every uid committed once,
   every cell readout held to float64 on the host, one cell's ablated
   decode bit-equal to ``generate`` with ``sae_ablation_edit`` called
   directly (graphed and eager), and 13a's program still a registry hit
   (13b); ``grid.search.run_search`` (seed 3, 2 generations x 4, 6
   requests of 6 tokens) over phase 11e's W = 2 engine with 13b's 16k
   cell as its latent pool: the same seed twice byte-identical, generation 0
   on an eager engine byte-equal to the graphed run's, every eager
   readout call held to ``lens_stats_reference`` at 11b's tolerances
   (a zeroed and a row-shifted result must miss), one timed, and a
   profiled step with 2 ``lens_splitv_kernel`` launches (13c); only with
   ``--processes``, the ``grid`` (one worker; one transient ``grid.cell``
   fault), ``fleet`` (two words, two workers, w1 killed at its first
   commit) and ``attack-search`` (twice, the same file) processes on the
   card's default device with the tiny synthetic stack (13d).  The phase's seconds and peak memory are printed.
14. the replica fleet and the HTTP gateway, after phase 13's programs are
   dropped: a fresh 8-slot ``ServeEngine`` at phase 11's envelope on phase
   6's params and phase 7's SAE, warm-started, first serves
   ``loadgen.run_inprocess``'s 32 requests (seed 0, 50/s, the five
   scenarios, 24 tokens, concurrency 8) as the reference, then serves them
   again through ``serve_forever(replica=True)`` in this process (worker
   r0, 5 s leases) behind a ``gateway`` process (port 0, no card) with
   ``loadgen.run_socket``; a thread runs ``serve.replica.FleetCoordinator``
   rounds (routing, lease-expiry scan) until every request is answered.
   Held: 32/32 over HTTP, each stream's SSE token events equal to its
   response's tokens, tokens equal to the reference run's under phase 9's
   margin rule (a diverging request's margins read from an eager engine),
   chat_lens probabilities within SERVE_PROB_RTOL, zero lease expiries
   (the largest renewal gap printed), no registry miss in
   ``_serve.r0.json``, a client that disconnects after its first token
   answered ``canceled`` and the next request into the freed slot equal to
   the reference's chat tokens, a 1 ms deadline answered
   ``deadline-exceeded``, and in a window of replica steps after the load,
   profiled (stopped WINDOW_MARGIN_S after a device sync), one
   ``lens_splitv_kernel`` per step counted by name in the graph replays
   and no other lens kernel,
   the registry's hits equal to the window's steps, and the kernels
   placed step by step printed; latency and TTFT over HTTP beside the
   reference's, tokens/s, step ms and the split of each slot's idle gap
   between requests
   (gateway, coordinator round, claim, step boundary; from r0's events and
   the client's clock) printed.  A second replica run at concurrency 16,
   above the 8 slots: the gateway's 429s typed ``fleet-saturated`` and
   counted as rejected by the client and the gateway alike, the
   coordinator's sheds typed, every acknowledged request answered (14a).
   Then
   the processes on the tiny synthetic stack, replicas on the card's
   default device: ``serve-fleet --replicas 2`` with replica w1 killed at
   its first ``serve.respond`` (every request answered once, the lease
   expiry and re-spool, ``tools/trace_report.py --check`` green on the
   merged events), ``top --once`` and ``trace --slowest 5`` over its
   directory; only with ``--processes``, a gateway in front of a second
   fleet answering 503 to a request read after its drain latched and
   exiting 75 on SIGTERM, that fleet SIGTERMed on the coordinator's PID
   (exit 75) and rerun to ``done`` (14b).  The phase's seconds and peak
   memory are printed.
15. the device profile, after phase 14's programs are dropped: phase 6's
   calls again through the CLI (``generate`` for one word, then
   ``logit-lens`` for it and a second word, on phase 6's params through a
   patched loader) with ``--profile`` and ``TBX_PROFILE_WORDS=2``: each
   writes ``run_manifest.json``, ``_events.jsonl``, ``_progress.json`` and
   ``_device_profile.json``, every annotated launch joins device slices,
   the busy union fits the capture, the two traces hold exactly as many
   ``lens_wgmma_kernel`` slices as the route counter grew by (84), the
   second word's decode replays its graph (one registry miss in the window,
   the first launch's capture) with its kernels joined by launch
   correlation, and the predictions, tokens and top-k ids equal phase 6's;
   the device idle share and the top five kernels printed (15a).
   ``run_launch_profile`` for ``decode`` and ``readout`` (``gemma2_bench``,
   330 rows): each record joined by correlation, no registry miss in the
   profiled decode (15b).  One ``dispatch_fused`` launch at the study's 330
   rows under a capture: one ``fused`` record whose phase split sums to its
   device seconds within 1% (15c).
16. tensor and sequence parallelism: two rank processes on the one card
   (``parallel.multihost.run_ranks`` given no device, as a user would call
   it: each rank joins on the card, ``LOCAL_RANK % device_count``, and
   holds its params on cuda:0; ``gloo``, since NCCL refuses two ranks on
   one device, every collective staged through the host, and each mesh's
   record names the shared card), each drawing
   phase 6's weights from its seed leaf by leaf and keeping its tp shard.
   16a: ``run_evaluation`` for "ship" through the model at tp 2 (rank 0
   alone writes; TP_NEW_TOKENS new tokens), against the unsharded
   ``analyze_word_on_device`` of the same prompts on phase 6's params in
   this process: tokens under phase 9's margin rule, P(target) within
   TP_PROB_RTOL of itself, the per-position top-k ids where clear and the
   guesses on rows of equal tokens, beside the witness's reading of the
   same gap (``split_row_parallel``: the unsharded forward with the tp
   forward's rounding of its row-parallel products); the lens kernel's
   counter set to 0 before the run and read after (42 per rank, all
   wgmma) and its ``lens_wgmma_kernel`` slices counted by name in each
   rank's profiled lens pass (42); ``tp_lens_stats`` merged over the two
   ranks at N 1140 against ``lens_stats_reference`` over the whole
   vocabulary, and with its targets shifted by one id (a planted fault,
   which must read over TP_PROB_RTOL); one per-shard call at N 1140, V
   128000, K 5 (one wgmma launch) and one at N 8, K 1 (one split-V
   launch) held to ``lens_stats_reference`` and timed beside the plain
   version, the library yardstick and the bound;
   one tp ``all_reduce`` timed.  16b: phase 11's 8-slot engine at tp 2
   (rank 0 drives, rank 1 follows) over 8 requests of 11d's uniform mix
   (seed TP_LOAD_SEED, whose first 8 hold all five scenarios, sae_ablate
   twice; the served scenarios are checked) against the unsharded engine
   here: tokens under the margin rule
   (margins from ``_request_margins``), chat_lens probabilities within
   TP_PROB_RTOL, beside the witness engine's, no miss of
   ``serve.step[tp]``, no graph; the tp step ms over 8 sessions
   (TP_STEP_REPS steps) and a profiled step with one split-V readout
   kernel; a tp
   2 ``SpecServeEngine`` (k 2, G 3) over the 8 hint sessions held to the
   vanilla engine's tokens under the margin rule; with ``--parallel``
   then ``serve --selfcheck`` as processes on the tiny stack.  16c, after
   phase 6's params are dropped here: ``lens_forward_sp`` at sp 2 over one
   SP_T-column row (past the 4096-column sliding window) against the dense
   ``lens_forward`` on rank 0: top-1 ids equal where the logit gap is
   clear, the residual within SP_RESID_RTOL.  Times are gloo over one
   card, not a tensor-parallel speed; the peak device memory over the
   processes stays under PEAK_GIB.  ``python3 chip_smoke.py --parallel``
   runs phases 1, 2 and 16 alone, and ``serve --selfcheck`` with them.
17. the parity dump (``generate --parity-dump``), at the same width on
   phase 6's params after phase 15's programs are dropped, run before
   phase 16 and its tensors freed before it.  17b: ``full_probs_forward``
   over the config's 10 prompts at their 64 padded columns (``all_probs``
   [42, 10, 64, 256000] f32): rows summing to 1 and the peak device memory
   under PEAK_GIB, nothing written.  17c, on the config's first prompt
   (PARITY_PROMPTS: each pair is GB-scale and every read inflates it on
   one host thread): ``generate_for_word(parity_dump=True)`` writes the
   reference-schema pair through ``runtime.native_io.save_npz`` (its bytes,
   seconds, GB/s and threads printed, beside ``np.savez_compressed`` of one
   layer's slice, scaled by the layer count and labelled so), and the same
   prompt's summary cache goes to a second directory through the lens
   kernel (its launches counted: 42); the pair's residual within 1e-3
   relative L2 of the summary's, its P(target) at the config's layer
   within PARITY_PROB_RTOL of the summary's (read one column on, it must
   miss), and its argmax ids at every layer equal to the summary's
   wherever the top-1/top-2 logit gap clears SPEC_MARGIN.  17d:
   ``run_evaluation`` (``logit-lens``) over the pair cache and over the
   summary cache: the pair loads back bit-equal, and the top-5 guesses are
   equal at every rank whose summed probabilities stand more than twice
   PARITY_PROB_RTOL from their neighbours'.  17e: ``spec-calibrate``
   through the CLI over each cache (its ``np.load`` of the pair handed
   17d's bit-equal arrays rather than inflating the file a second time):
   the same response window, per-layer agreement apart by no more columns
   than the gap rule excuses, and the pair's plan reading the agreement
   computed here.  Phase 17 uses a word
   tokenizer whose id -> token -> id round trip is exact for every id (as
   Gemma's is): the pair path zeroes tokens through that round trip.
   ``python3 chip_smoke.py --parity`` runs phases 1, 2 and 17 alone, and
   ``python3 chip_smoke.py --processes`` phases 1, 2, 12f, 13d and 14b's
   second fleet; ``python3 chip_smoke.py --readout-window`` phases 1, 2
   and 14a's profiled readout window taken again and again, each read
   step by step (how often a readout goes missing, and whether the trace
   or the step is short); ``python3 chip_smoke.py --kernels`` phases 1-5b
   alone (the lens kernels held to their plain version and timed);
18. deep (run after phase 5b): tbx-check's deep registry
   (``analysis/deep.py``, the 19 entry points) on the CPU at vocab 641 and
   on the card at vocab 641 x 128 (the kernels take whole 128-row tiles),
   the four ``[tp]`` entries on two ``gloo`` ranks sharing the card (both
   runs in one spawn); each entry's widening f32 conversions on
   vocab-carrying tensors, the card's marker mapped back to 641, must equal
   the CPU's (where the CPU runs the lens kernels' plain twins, which the
   pass treats as opaque for CPU tensors only, the card launches the
   kernels: each entry whose CPU run went through a twin must launch one
   there, and a twin run on card tensors is recorded); the findings are
   printed as a ``{"deep": ...}`` line.  ``python3 chip_smoke.py --deep``
   runs phases 1, 2 and 18 alone.
19. the float16 main path (run before phase 6, whose bf16 params do not
   exist yet): Gemma-2-9B width with ``dtype`` and ``param_dtype``
   float16 (42 layers, seeded random weights made on the card),
   ``run_generation`` then ``run_evaluation`` for the default config's 10
   prompts, through a model loader, into a temporary directory; 42
   launches per lens pass, all on the wgmma route; each pass's taps held
   to the same call with the plain tap on the card (probabilities at
   ATOL, top-5 ids equal wherever the margins clear the plain tap's f16
   rounding); the largest |h| per tenth of the layers printed and every
   tap, residual and |h| finite (an f16 overflow fails, reported, nothing
   rescaled); peak memory under PEAK_GIB; then one prompt's last 8
   columns through ``lens.lens_forward``: 42 launches of the split-V f16
   build, held the same way.

The card's name and power limit are printed again just before the
``{"kernels": [...]}`` line, which is the line before the last: one entry
per route and dtype (times in ms, measured here; ``bound_ms`` from this
run's shapes and the card's published peaks).  The wide top-k route's
entry (``lens_stats_wide_k``) is its bf16 N 1140, K 33 call, with every
call of phase 3's wide rows in ``rows``, the worst cases, the sync-debug
and the graph check beside it; its ``launches`` are the main path's
refills (none: no path asks a top-k above 32).  The f32 entries (``lens_stats_wgmma_f32`` at N
1140, K 5 and ``lens_stats_splitv_f32`` at N 8, K 1, with the f32
``crossover`` and ``by_rows``) take ``launches`` from 5b's passes; the f16
entries (``lens_stats_wgmma_f16`` at N 1140, K 5 and
``lens_stats_splitv_f16`` at N 8, K 1, each with ``bf16_ms``, the bf16
build in turns, and the split-V one with the f16 ``by_rows``) take theirs
from phase 19's main path and its split-V pass.  The split-V entry: ``launches`` from 11b's
eager serving sessions, the N 8 readout's times from 3b with
``wgmma_ms``, ``body_ms``, ``merge_ms``, ``crossover`` and ``by_rows`` (the
routes per N) and ``tp_shard`` (N 8, V 128000); beside them the serving
readout's ``serve_*`` times and ``serve_launches_per_step``, the readout
kernels counted in each profiled serve step, the speculative verify
readout's ``spec_verify_*`` times, ``spec_step_ms`` and
``spec_verify_launches_per_step``, the attack search's readout:
``search_readout_*`` times, ``search_steps`` (engine steps of 13c's
graphed search) and ``search_readouts_per_step``, 14a's replica:
``replica_readouts`` (the readout kernels the profiler counted over its
window), ``replica_steps`` (the window's steps) and ``replica_step_ms``,
and phase 16's per-shard ``tp_serve_shard_*`` (N 8) times and bounds and
``tp_step_ms``.  The wgmma entry: ``launches`` from the main path's run
(phase 6), 15a's ``profiled_launches``: the ``lens_wgmma_kernel`` slices
its traces hold, phase 16's per-shard ``tp_shard_*`` (N 1140) times and
bounds, ``tp_shard_launches`` (a rank's count over 16a's run),
``tp_lens_seconds``, ``sp_seconds`` and ``sp_dense_seconds``, and 17c's
``parity_launches``: the lens kernel's launches for the summary it holds
the pair against.  The last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "taboo_brittleness_tpu_torch"

# NVIDIA H100 SXM published peaks (data sheet, dense): HBM bytes/s and bf16
# tensor-core FLOP/s.  A card below its 700 W limit runs slower than these.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12    # tensor cores
FP32_FLOP_PER_S = 67e12     # outside the tensor cores

# The main path's lens-kernel shape: 10 prompts left-padded to 64 columns
# plus 50 new tokens (N = 10 * 114), Gemma-2-9B width and vocabulary.
N_ROWS, HIDDEN, VOCAB, TOP_K = 1140, 3584, 256_000, 5

# Kernel vs plain: both accumulate exact bf16 products in f32, in another
# order; logits are O(1), so 1e-3 is ~100x the expected rounding gap.
ATOL = 1e-3
MIN_ID_ROWS = 0.9   # share of rows whose top-(K+1) gaps all exceed ATOL
# The long list's ids are held entry by entry: at K 32 on random logits only
# ~10% of rows have all 32 gaps above ATOL, but most entries are more than
# ATOL from both neighbours, which fixes their rank whatever the rounding.
WIDE_KS = (16, 32)
MIN_CLEAR_ENTRIES = 0.5
# The guesses' summed probabilities of two passes over the same residuals:
# f32 sums of ~50 probabilities in the same order; a margin under this could
# only flip if the order changed.
AGG_MARGIN = 1e-6
# A chunk's sum of exp(logit - max) runs to thousands at V = 256000; the two
# versions add it in other orders (and the kernel through exp2), so it is
# held to a relative tolerance instead.
SUMEXP_RTOL = 1e-4
TIE_PATTERN = (5, 300, 131_000, 255_999)   # duplicated rows: tiles 0, 1, 511, 999
# A row's SAE patch under the same edit on the same rows at the same row
# count is computed alike whatever the other rows hold; another arm's ids
# change it by O(1) of itself.
PATCH_RTOL = 1e-5


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def timed_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
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


def backlogged_ms(torch, fn, reps: int) -> tuple:
    """Mean device time of ``fn`` over ``reps`` calls enqueued behind a
    sleep kernel, so the host's enqueue hides under the card's work: (ms
    per call, ms the host took to enqueue the calls, ms of the backlog).
    The reading is the device time alone only while the enqueue is shorter
    than the backlog."""
    fn()
    torch.cuda.synchronize()
    t0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    t0.record()
    torch.cuda._sleep(200_000_000)
    start.record()
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue = time.perf_counter() - h0
    end.record()
    end.synchronize()
    return (start.elapsed_time(end) / reps, enqueue * 1e3,
            t0.elapsed_time(start))


def report_device(torch) -> tuple:
    """(the last line's device block, the card's name and power limit as
    nvidia-smi gives them), the latter printed."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    log(f"device {name}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, cuda {torch.version.cuda}")
    return {"platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}, card


_KERNEL_NAMES = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}


def ptxas_summary(out: str) -> list:
    """One line per kernel of ``-Xptxas -v`` output: registers, spills,
    stack and static shared memory."""
    lines, name = [], None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            # lens_<route>_kernel<T[, NT], CAP, L>
            k = re.search(r"(lens_[a-z_]+_kernel)I(f|13__nv_bfloat16|6__half)"
                          r"(?:Li(\d+)E)?(?:Lb([01])ELi(\d+)E)?",
                          m.group(1))
            if k:
                parts = [_KERNEL_NAMES[k.group(2)]]
                if k.group(3):
                    parts.append(f"N <= {8 * int(k.group(3))}")
                if k.group(4):
                    parts += ["cap" if k.group(4) == "1" else "no cap",
                              f"K <= {k.group(5)}"]
                name = f"{k.group(1)}<{', '.join(parts)}>"
            else:
                name = m.group(1)
            stats = {}
            continue
        for key, pat in (("spill stores", r"(\d+) bytes spill stores"),
                         ("spill loads", r"(\d+) bytes spill loads"),
                         ("stack frame", r"(\d+) bytes stack frame")):
            m = re.search(pat, line)
            if m and name:
                stats[key] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(
                f"{name}: {m.group(1)} registers, "
                f"{stats.get('spill stores', 0)} B spill stores, "
                f"{stats.get('spill loads', 0)} B spill loads, "
                f"{stats.get('stack frame', 0)} B stack frame, "
                f"{smem.group(1) if smem else 0} B static shared memory")
            name = None
    return lines


def build_kernels() -> None:
    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk
    from taboo_brittleness_tpu_torch.runtime import native_io

    t0 = time.perf_counter()
    built = lk.build_library()
    log(f"built {len(built)} libraries in {time.perf_counter() - t0:.1f} s "
        f"(one nvcc per unit, {sum(map(len, lk.UNITS.values()))} units in "
        "parallel, then one link per library)")
    for route, (path, out) in built.items():
        log(f"  {route}: {os.path.relpath(path, REPO)}")
        for line in ptxas_summary(out) or ["(cached build: no compiler output)"]:
            log(f"    ptxas: {line}")
    wgmma = lk._library("wgmma")
    log(f"  wgmma: {wgmma.tbx_wgmma_smem_bytes()} B (f32 "
        f"{wgmma.tbx_wgmma_f32_smem_bytes()} B) dynamic shared memory per "
        f"block ({lk.WGMMA_ROWS} x {lk.WGMMA_COLS} tiles, TMA ring); dtypes "
        f"{wgmma.dtypes}")
    splitv = lk._library("splitv")
    log("  splitv: " + ", ".join(
        f"{splitv.tbx_splitv_smem_bytes(n)} B (f32 "
        f"{splitv.tbx_splitv_f32_smem_bytes(n)} B) at N <= {n}"
        for n in range(8, lk.SPLITV_MAX_ROWS + 1, 8))
        + " of dynamic shared memory per block (TMA ring and staged tiles); "
        f"dtypes {splitv.dtypes}; its last block certifies top_k up to "
        f"{splitv.merge_max}")
    t0 = time.perf_counter()
    try:
        writer = native_io.build_library()
    except RuntimeError as exc:
        fail(f"the npz writer did not build: {exc}")
    log(f"  npz writer (g++ {' '.join(native_io.FLAGS)} ... -lz) in "
        f"{time.perf_counter() - t0:.1f} s: {os.path.relpath(writer, REPO)}; "
        f"os.cpu_count() {os.cpu_count()}, save_npz deflates on "
        f"{native_io.threads()} threads; loads: {native_io.native_available()}")


def lens_bound_ms(n: int, d: int, v: int, k: int) -> tuple:
    """(bound ms, "bytes" or "operations") of one lens_stats call: bf16 x and
    E read once, int32 targets, f32 lse/target/top-k values and int32 ids
    written once; 2*N*D*V multiply-adds at the bf16 tensor-core peak."""
    moved = 2 * n * d + 2 * v * d + 4 * n + 4 * n * (2 + 2 * k)
    ops = 2 * n * d * v
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _main_inputs(torch):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((N_ROWS, HIDDEN), generator=gen, device=dev).to(torch.bfloat16)
    embed = (torch.randn((VOCAB, HIDDEN), generator=gen, device=dev)
             * HIDDEN ** -0.5).to(torch.bfloat16)
    per_row = torch.randint(0, VOCAB, (N_ROWS,), generator=gen, device=dev,
                            dtype=torch.int32)
    per_row[::7] = -1
    per_row[-1] = VOCAB - 1
    return x, embed, per_row


def compare(got, ref, k: int) -> tuple:
    """(max abs err over lse, target and top-k values; rows whose reference
    top-(k+1) gaps all exceed ATOL; of those, rows whose ids differ).  ``ref``
    holds at least k + 1 candidates (a wider top-k of the same logits)."""
    err = max(
        (got.logsumexp - ref.logsumexp).abs().max().item(),
        (got.target_logit - ref.target_logit).abs().max().item(),
        (got.topk_vals - ref.topk_vals[:, :k]).abs().max().item())
    gaps = ref.topk_vals[:, :k] - ref.topk_vals[:, 1:k + 1]
    clear = (gaps > ATOL).all(dim=1)
    same = (got.topk_ids == ref.topk_ids[:, :k]).all(dim=1)
    return err, int(clear.sum().item()), int((clear & ~same).sum().item())


def compare_partials(got, ref, k: int) -> tuple:
    """(max abs err over the chunks' max, target and top-k values; the
    sum-exps' max relative err; (chunk, row) pairs whose reference top-(k+1)
    gaps all exceed ATOL; of those, pairs whose ids differ) of a kernel's
    partials against ``lens_stats_partials_reference`` of the same plan
    with at least k + 1 candidates."""
    err = max((got.chunk_max - ref.chunk_max).abs().max().item(),
              (got.chunk_tgt - ref.chunk_tgt).abs().max().item(),
              (got.cand_vals - ref.cand_vals[..., :k]).abs().max().item())
    rel = ((got.chunk_sumexp - ref.chunk_sumexp).abs()
           / ref.chunk_sumexp).max().item()
    clear = ((ref.cand_vals[..., :k] - ref.cand_vals[..., 1:k + 1])
             > ATOL).all(dim=-1)
    same = (got.cand_ids == ref.cand_ids[..., :k]).all(dim=-1)
    return (err, rel, int(clear.sum().item()),
            int((clear & ~same).sum().item()))


def rank_ids(torch, got_ids, ref_vals, ref_ids, k: int,
             margin: float = ATOL) -> tuple:
    """(entries of a top-k whose reference value lies more than ``margin``
    from both its neighbours in the reference top-(k+1); of those, entries
    whose id differs), over any leading axes.  A clear entry's rank, hence
    its id, is the same whatever the rounding."""
    ref = ref_vals[..., :k + 1]
    below = ref[..., :-1] - ref[..., 1:]
    above = torch.cat([torch.full_like(below[..., :1], float("inf")),
                       below[..., :-1]], dim=-1)
    clear = (below > margin) & (above > margin)
    bad = clear & (got_ids != ref_ids[..., :k])
    return int(clear.sum().item()), int(bad.sum().item())


def library_topk(torch, x, embed, k: int):
    """The library yardstick of a call: one product in the inputs' type,
    read in f32, ``logsumexp`` and ``topk`` at K."""
    def call():
        # tbx: f32-ok — the library yardstick forms the [N, V] f32 logits
        logits = torch.matmul(x, embed.T).float()
        torch.logsumexp(logits, dim=-1)
        torch.topk(logits, k, dim=-1)
    return call


def check_wide(torch, lk, x, embed, per_row, plan) -> float:
    """The wgmma kernel's long list at the main path's shape: stats with
    both caps and the raw partials (a target at every chunk position) at K
    in WIDE_KS against the plain version, ids entry by entry.  Returns the
    worst error."""
    worst = 0.0
    for k in WIDE_KS:
        wide = lk.lens_plan(N_ROWS, VOCAB, k, torch.bfloat16,
                            sm_count=lk._sm_count(x.device))
        if wide != plan:
            fail(f"K={k} plans {wide[:4]}, not the K={TOP_K} plan {plan[:4]}")
        for cap in (None, 30.0):
            before = dict(lk.lens_stats.route_launches)
            got = lk.lens_stats(x, embed, per_row, top_k=k, logit_cap=cap)
            ref = lk.lens_stats_reference(x, embed, per_row, top_k=k + 1,
                                          logit_cap=cap)
            torch.cuda.synchronize()
            if lk.lens_stats.route_launches != {**before,
                                                "wgmma": before["wgmma"] + 1}:
                fail(f"lens_stats K={k} did not launch the wgmma kernel alone")
            err, n_clear, n_bad = compare(got, ref, k)
            e_clear, e_bad = rank_ids(torch, got.topk_ids, ref.topk_vals,
                                      ref.topk_ids, k)
            log(f"lens_stats K={k} cap={cap} per-row targets (wgmma, long "
                f"list): max_abs_err {err:.3e} (atol {ATOL}); ids equal on "
                f"{n_clear - n_bad}/{n_clear} rows and {e_clear - e_bad}/"
                f"{e_clear} entries with clear margins of {N_ROWS * k}")
            if not err <= ATOL or n_bad or e_bad \
                    or e_clear < MIN_CLEAR_ENTRIES * N_ROWS * k:
                fail(f"the wgmma kernel's K={k} list disagrees with its plain "
                     f"version: err {err}, {n_bad} rows and {e_bad} entries "
                     "with other ids")
            worst = max(worst, err)
            del got, ref
        spots = _chunk_position_targets(torch, plan, N_ROWS, x.device)
        parts = lk.lens_stats_partials(x, embed, spots, top_k=k)
        pref = lk.lens_stats_partials_reference(x, embed, spots, plan,
                                                top_k=k + 1)
        torch.cuda.synchronize()
        err, rel, _, n_bad = compare_partials(parts, pref, k)
        e_clear, e_bad = rank_ids(torch, parts.cand_ids, pref.cand_vals,
                                  pref.cand_ids, k)
        log(f"raw partials K={k} [{plan.chunks}, {N_ROWS}, {k}], targets at "
            f"every chunk position: max_abs_err "
            f"{err:.3e}, sum-exp max rel err {rel:.3e}; ids equal on "
            f"{e_clear - e_bad}/{e_clear} entries with clear margins")
        if not (err <= ATOL and rel <= SUMEXP_RTOL) or n_bad or e_bad \
                or e_clear < MIN_CLEAR_ENTRIES * parts.cand_ids.numel():
            fail(f"the wgmma kernel's K={k} partials disagree with their "
                 "plain version")
        worst = max(worst, err)
        del parts, pref
    return worst


def check_lens_stats(torch) -> dict:
    """The wgmma route at the main path's shape against the plain version
    (stats and raw partials, K 5 and the long list's K 16 and 32), then
    timed (K 5, 16 and 32 in turns).  Returns the kernel's entry."""
    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

    x, embed, per_row = _main_inputs(torch)
    scalar = 7509
    plan = lk.lens_plan(N_ROWS, VOCAB, TOP_K, torch.bfloat16,
                        sm_count=lk._sm_count(x.device))
    if plan.route != "wgmma":
        fail(f"the main path's shape plans {plan.route}, not wgmma")
    log(f"plan: {plan.row_tiles} row tiles x {plan.chunks} vocab chunks = "
        f"{plan.row_tiles * plan.chunks} blocks over "
        f"{lk._sm_count(x.device)} SMs; chunks of "
        f"{min(b - a for a, b in zip(plan.bounds, plan.bounds[1:]))}-"
        f"{max(b - a for a, b in zip(plan.bounds, plan.bounds[1:]))} columns")

    worst = 0.0
    for cap in (None, 30.0):
        for name, target in (("scalar", scalar), ("per-row", per_row)):
            before = dict(lk.lens_stats.route_launches)
            got = lk.lens_stats(x, embed, target, top_k=TOP_K, logit_cap=cap)
            ref = lk.lens_stats_reference(x, embed, target, top_k=TOP_K + 1,
                                          logit_cap=cap)
            torch.cuda.synchronize()
            if lk.lens_stats.route_launches["wgmma"] != before["wgmma"] + 1:
                fail("lens_stats at the main path's shape did not launch "
                     "the wgmma kernel")
            err, n_clear, n_bad = compare(got, ref, TOP_K)
            log(f"lens_stats cap={cap} target={name}: max_abs_err {err:.3e} "
                f"(atol {ATOL}); top-k ids equal on {n_clear - n_bad}/"
                f"{n_clear} rows with clear margins of {N_ROWS}")
            if not err <= ATOL:
                fail(f"lens_stats disagrees with its plain version: {err}")
            if n_bad or n_clear < MIN_ID_ROWS * N_ROWS:
                fail(f"lens_stats top-k ids: {n_bad} mismatches, "
                     f"{n_clear} rows with clear margins")
            worst = max(worst, err)
            del got, ref

    # The raw partials, chunk by chunk.
    parts = lk.lens_stats_partials(x, embed, per_row, top_k=TOP_K)
    ref = lk.lens_stats_partials_reference(x, embed, per_row, plan,
                                           top_k=TOP_K + 1)
    torch.cuda.synchronize()
    err, rel, n_clear, n_bad = compare_partials(parts, ref, TOP_K)
    log(f"raw partials [{plan.chunks}, {N_ROWS}] per-row targets: max_abs_err "
        f"{err:.3e} (atol {ATOL}), sum-exp max rel err {rel:.3e} (rtol "
        f"{SUMEXP_RTOL}); ids equal on {n_clear - n_bad}/{n_clear} (chunk, "
        "row) pairs with clear margins")
    if not (err <= ATOL and rel <= SUMEXP_RTOL) or n_bad \
            or n_clear < MIN_ID_ROWS * parts.chunk_max.numel():
        fail("the wgmma kernel's partials disagree with their plain version")
    worst = max(worst, err)
    del ref
    worst = max(worst, check_wide(torch, lk, x, embed, per_row, plan))

    def new():
        lk.lens_stats(x, embed, scalar, top_k=TOP_K)

    def body():
        lk.lens_stats_partials(x, embed, scalar, top_k=TOP_K)

    def capped():
        lk.lens_stats(x, embed, scalar, top_k=TOP_K, logit_cap=30.0)

    def at_k(k):
        return lambda: lk.lens_stats(x, embed, scalar, top_k=k)

    def epilogue():
        lk.merge_partials(parts)

    def plain():
        lk.lens_stats_reference(x, embed, scalar, top_k=TOP_K)

    ms = timed_ms(torch, new, 10)
    body_ms = timed_ms(torch, body, 10)
    epilogue_ms = timed_ms(torch, epilogue, 10)
    cap_ms = timed_ms(torch, capped, 10)
    plain_ms = timed_ms(torch, plain, 3)
    library_ms = timed_ms(torch, library_topk(torch, x, embed, TOP_K), 10)
    # The long list in turns with K 5 (5, 16, 32, 32, 16, 5).
    ks = (TOP_K, *WIDE_KS)
    wide_turns = {k: [] for k in ks}
    for k in (*ks, *reversed(ks)):
        wide_turns[k].append(timed_ms(torch, at_k(k), 10))
    wide = {}
    for k in WIDE_KS:
        w_bound, w_by = lens_bound_ms(N_ROWS, HIDDEN, VOCAB, k)
        w_ms = sum(wide_turns[k]) / 2
        wide[f"k{k}"] = dict(
            ms=w_ms, k5_ms=sum(wide_turns[TOP_K]) / 2,
            body_ms=timed_ms(torch, lambda: lk.lens_stats_partials(
                x, embed, scalar, top_k=k), 10),
            plain_ms=timed_ms(torch, lambda: lk.lens_stats_reference(
                x, embed, scalar, top_k=k), 3),
            library_ms=timed_ms(torch, library_topk(torch, x, embed, k), 10),
            bound_ms=w_bound, bound_by=w_by)
        r = wide[f"k{k}"]
        log(f"lens_stats N={N_ROWS} K={k} bf16 (wgmma, long list): call "
            f"{r['ms']:.3f} ms (in turns with K={TOP_K} at {r['k5_ms']:.3f} ms: "
            f"{r['ms'] / r['k5_ms']:.2f}x; kernel body {r['body_ms']:.3f} ms), "
            f"plain {r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, "
            f"bound {w_bound:.3f} ms ({w_by}; {w_bound / r['ms']:.1%} of it)")
        if not r["ms"] < r["library_ms"]:
            log(f"NOTE: the K={k} wgmma call ({r['ms']:.3f} ms) is not below "
                f"its library yardstick ({r['library_ms']:.3f} ms)")
    bound_ms, bound_by = lens_bound_ms(N_ROWS, HIDDEN, VOCAB, TOP_K)
    tflops = 2 * N_ROWS * HIDDEN * VOCAB / (ms * 1e-3) / 1e12
    log(f"lens_stats N={N_ROWS} D={HIDDEN} V={VOCAB} K={TOP_K} bf16: wgmma "
        f"call {ms:.3f} ms (kernel body {body_ms:.3f} ms, torch epilogue "
        f"{epilogue_ms:.3f} ms), plain "
        f"{plain_ms:.3f} ms, library {library_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}); {tflops:.1f} TFLOP/s, "
        f"{bound_ms / ms:.1%} of bound; with the cap 30 {cap_ms:.3f} ms")
    if not ms < library_ms:
        log(f"NOTE: the wgmma call ({ms:.3f} ms) is not below the library "
            f"yardstick ({library_ms:.3f} ms)")
    del x, embed, per_row, parts
    torch.cuda.empty_cache()
    common = {"route": "cuda", "replaces": "taboo_brittleness_tpu/ops/pallas_lens.py:56",
              "launches": 0, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": library_ms}
    return dict(
        name="lens_stats", source=f"{PACKAGE}/csrc/lens_stats_wgmma.cu",
        max_abs_err=worst, ms=ms, body_ms=body_ms, epilogue_ms=epilogue_ms,
        tflops=tflops, share_of_bound=bound_ms / ms, cap_ms=cap_ms, wide=wide,
        **common)


# The f32 calls: the main path's shape at K 5 (the wgmma kernel's f32
# instantiation) and a serving readout's N 8 at K 1 (the split-V kernel's).
F32_CALLS = ((N_ROWS, TOP_K, "wgmma"), (8, 1, "splitv"))
# A top-k above the kernels' 32-entry lists (ceil(K / 32) certified passes
# of the Hopper kernels): (dtype, N, K) held to the plain version and timed.
WIDE_CALLS = tuple(("bf16", n, k) for n in (N_ROWS, 8) for k in (33, 64, 128)) \
    + (("f32", N_ROWS, 64), ("f32", 8, 64))
WORST_K = 128       # the worst cases' top-k
PLANTED = 160       # columns of one chunk that hold one row's whole top-k


def f32_bounds_ms(n: int, d: int, v: int, k: int) -> dict:
    """An f32 call's bounds: f32 x and E read once and the statistics
    written once at the memory rate; the product as three TF32 tensor-core
    products (3xTF32, the least tensor-core work that keeps f32's accuracy)
    and, beside it, at the f32 rate outside the tensor cores."""
    moved = 4 * n * d + 4 * v * d + 4 * n + 4 * n * (2 + 2 * k)
    flop = 2 * n * d * v
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    tf32_ms = 3 * flop / TF32_FLOP_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, tf32_ms),
            "bound_by": "operations" if tf32_ms >= bytes_ms else "bytes",
            "bytes_ms": bytes_ms, "3xtf32_ms": tf32_ms,
            "fp32_fma_ms": flop / FP32_FLOP_PER_S * 1e3}


def measure_f32(torch) -> list:
    """The f32 calls at F32_CALLS on their routes (the Hopper kernels' f32
    instantiations, 3xTF32): held to the plain version, then timed beside
    the plain version, the library call and the bounds.  The library call
    and the plain version run in full f32: TF32 off and matmul precision
    "highest", both set here."""
    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"f32 route: allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
        f"matmul precision {torch.get_float32_matmul_precision()!r}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    embed = torch.randn((VOCAB, HIDDEN), generator=gen, device=dev) * HIDDEN ** -0.5
    rows = []
    for n, k, route in F32_CALLS:
        x = torch.randn((n, HIDDEN), generator=gen, device=dev)
        t = torch.randint(0, VOCAB, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        plan = lk.lens_plan(n, VOCAB, k, torch.float32,
                            sm_count=lk._sm_count(dev))
        if plan.route != route:
            fail(f"f32 N={n} K={k} plans {plan.route}, not {route}")
        before = dict(lk.lens_stats.route_launches)
        got = lk.lens_stats(x, embed, t, top_k=k)
        ref = lk.lens_stats_reference(x, embed, t, top_k=k + 1)
        torch.cuda.synchronize()
        if lk.lens_stats.route_launches != {**before,
                                            route: before[route] + 1}:
            fail(f"f32 N={n} K={k} did not launch the {route} kernel alone")
        err, n_clear, n_bad = compare(got, ref, k)
        if not err <= ATOL or n_bad:
            fail(f"the {route} kernel's f32 N={n} K={k} disagrees with its "
                 f"plain version: err {err}, {n_bad} rows with other ids")
        del got, ref
        call = lambda: lk.lens_stats(x, embed, t, top_k=k)
        library = library_topk(torch, x, embed, k)
        if n > 64:
            ms, library_ms = timed_ms(torch, call, 5), timed_ms(torch, library, 5)
        else:   # behind the backlog, as the other small-N calls
            ms = backlogged_ms(torch, call, SPLITV_REPS)[0]
            library_ms = backlogged_ms(torch, library, SPLITV_REPS)[0]
        row = dict(n=n, k=k, route=route, max_abs_err=err, ms=ms,
                   plain_ms=timed_ms(torch, lambda: lk.lens_stats_reference(
                       x, embed, t, top_k=k), 3),
                   library_ms=library_ms, **f32_bounds_ms(n, HIDDEN, VOCAB, k))
        rows.append(row)
        log(f"f32 N={n} K={k} ({route}, 3xTF32): max_abs_err {err:.3e}, ids "
            f"equal on {n_clear}/{n_clear} rows with clear margins; call "
            f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, library "
            f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
            f"({row['bound_by']}; {row['bound_ms'] / row['ms']:.1%} of it; "
            f"3xTF32 {row['3xtf32_ms']:.3f} ms, f32 FMA "
            f"{row['fp32_fma_ms']:.3f} ms, bytes {row['bytes_ms']:.3f} ms)")
        if not row["ms"] < row["library_ms"]:
            log(f"NOTE: the f32 N={n} K={k} {route} call ({row['ms']:.3f} ms) "
                f"is not below its library call ({row['library_ms']:.3f} ms)")
        del x, t
    del embed
    torch.cuda.empty_cache()
    return rows


# Phase 3c: the f16 builds (a ``model.dtype: float16`` run's readouts) held
# to the plain version at the main path's N (K 5, 16 and 64: one, one and
# two certified passes of the wgmma build) and the serving readout's N 8
# (K 1 and 64: the split-V build, its last block certifying); K 5 at N 1140
# and K 1 at N 8 timed in turns with the bf16 build of the same call; the
# split-V route against the wgmma route at F16_CROSSOVER_ROWS.
F16_CHECKS = ((N_ROWS, (TOP_K, WIDE_KS[0], 64), "wgmma"), (8, (1, 64), "splitv"))
F16_CROSSOVER_ROWS = (48, 64)


def measure_f16(torch) -> dict:
    """Phase 3c (see F16_CHECKS).  Each call with cap None and 30, a scalar
    target and per-row targets with -1 and V - 1, at ATOL, ids equal on
    every row and entry whose margins clear.  Returns {route: entry fields}
    for the kernels line (``launches`` filled by phase 19), the f16
    crossover beside the split-V one."""
    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    sms = lk._sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    embed32 = torch.randn((VOCAB, HIDDEN), generator=gen, device=dev) * HIDDEN ** -0.5
    embed = embed32.to(torch.float16)
    out = {}
    for n, ks, route in F16_CHECKS:
        x32 = torch.randn((n, HIDDEN), generator=gen, device=dev)
        x = x32.to(torch.float16)
        per_row = torch.randint(0, VOCAB, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
        per_row[::7] = -1
        per_row[-1] = VOCAB - 1
        worst = 0.0
        for k in ks:
            plan = lk.lens_plan(n, VOCAB, k, torch.float16, sm_count=sms)
            if plan.route != route:
                fail(f"f16 N={n} K={k} plans {plan.route}, not {route}")
            passes = -(-k // lk.KMAX_WIDE)
            for cap in (None, 30.0):
                for name, target in (("scalar", 7509), ("per-row", per_row)):
                    before = dict(lk.lens_stats.route_launches)
                    got = lk.lens_stats(x, embed, target, top_k=k,
                                        logit_cap=cap)
                    ref = lk.lens_stats_reference(x, embed, target,
                                                  top_k=k + 1, logit_cap=cap)
                    torch.cuda.synchronize()
                    want = {**before, route: before[route] + 1,
                            f"{route}_refill": before[f"{route}_refill"]
                            + passes - 1}
                    if lk.lens_stats.route_launches != want:
                        fail(f"f16 N={n} K={k} launched "
                             f"{lk.lens_stats.route_launches}, expected {want}")
                    err, n_clear, n_bad = compare(got, ref, k)
                    e_clear, e_bad = rank_ids(torch, got.topk_ids,
                                              ref.topk_vals, ref.topk_ids, k)
                    log(f"f16 N={n} K={k} cap={cap} target={name} ({route}, "
                        f"{passes} pass{'es' if passes > 1 else ''}): "
                        f"max_abs_err {err:.3e} (atol {ATOL}); ids equal on "
                        f"{n_clear - n_bad}/{n_clear} rows and "
                        f"{e_clear - e_bad}/{e_clear} entries with clear "
                        f"margins of {n * k}")
                    if not err <= ATOL or n_bad or e_bad \
                            or e_clear < MIN_CLEAR_ENTRIES * n * k:
                        fail(f"the f16 {route} build disagrees with its plain "
                             f"version at N={n} K={k} cap={cap}: err {err}, "
                             f"{n_bad} rows and {e_bad} entries with other ids")
                    worst = max(worst, err)
                    del got, ref
        # The call timed in turns with the bf16 build of the same values
        # (bf16, f16, f16, bf16), beside the f16 library yardstick (the f16
        # product read in f32, logsumexp, topk) and the bound (the same bytes
        # and tensor-core rate as bf16).  The targets lie on the card: a
        # scalar's copy to it would wait on the backlog at every call.
        k = ks[0]
        xb, eb = x32.to(torch.bfloat16), embed32.to(torch.bfloat16)
        t = torch.full((n,), 7509, dtype=torch.int32, device=dev)
        calls = {"bf16": lambda: lk.lens_stats(xb, eb, t, top_k=k),
                 "f16": lambda: lk.lens_stats(x, embed, t, top_k=k)}
        library = library_topk(torch, x, embed, k)
        if route == "wgmma":
            def timer(fn):
                return timed_ms(torch, fn, 10)
        else:   # behind the backlog, as the other small-N calls
            def timer(fn):
                return backlogged_ms(torch, fn, SPLITV_REPS)[0]
        turns = {name: [] for name in calls}
        for name in ("bf16", "f16", "f16", "bf16"):
            turns[name].append(timer(calls[name]))
        bound_ms, bound_by = lens_bound_ms(n, HIDDEN, VOCAB, k)
        r = dict(n=n, k=k, max_abs_err=worst, ms=sum(turns["f16"]) / 2,
                 bf16_ms=sum(turns["bf16"]) / 2,
                 plain_ms=timed_ms(torch, lambda: lk.lens_stats_reference(
                     x, embed, t, top_k=k), 3),
                 library_ms=timer(library), bound_ms=bound_ms,
                 bound_by=bound_by)
        log(f"f16 N={n} K={k} ({route}): call {r['ms']:.3f} ms, the bf16 "
            f"build in turns {r['bf16_ms']:.3f} ms ({r['ms'] / r['bf16_ms']:.3f}"
            f"x), plain {r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} "
            f"ms, bound {bound_ms:.3f} ms ({bound_by}; "
            f"{bound_ms / r['ms']:.1%} of it)")
        if not r["ms"] < r["library_ms"]:
            log(f"NOTE: the f16 N={n} K={k} {route} call ({r['ms']:.3f} ms) is "
                f"not below its library call ({r['library_ms']:.3f} ms)")
        out[route] = r
        del x, x32, xb, eb, per_row, t
    del embed32
    # The crossover at the top of the split-V route's rows: both routes on
    # the same K = 1 readouts, held to the plain version, timed in turns.
    rows = []
    for n in F16_CROSSOVER_ROWS:
        x = torch.randn((n, HIDDEN), generator=gen, device=dev).to(torch.float16)
        t = torch.randint(0, VOCAB, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        ref = lk.lens_stats_reference(x, embed, t, top_k=2)
        for plan in (lk._splitv_plan(n, VOCAB, sms),
                     lk._wgmma_plan(n, VOCAB, sms)):
            got = (lk._launch(x, embed, t, plan, 1, None, merged=True)
                   if plan.route == "splitv" else
                   lk.merge_partials(lk._launch(x, embed, t, plan, 1, None)))
            torch.cuda.synchronize()
            err, _, n_bad = compare(got, ref, 1)
            if not err <= ATOL or n_bad:
                fail(f"f16 {plan.route} N={n} K=1: max_abs_err {err:.3e}, "
                     f"{n_bad} rows with other ids")
            out["splitv"]["max_abs_err"] = max(out["splitv"]["max_abs_err"],
                                               err)
        r = _time_routes(torch, lk, x, embed, t)
        rows.append(r)
        log(f"  f16 N={n} V={VOCAB} K=1 readout: splitv {r['splitv_ms']:.3f} "
            f"ms, wgmma {r['wgmma_ms']:.3f} ms, library {r['library_ms']:.3f} "
            f"ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}; splitv "
            f"{r['bound_ms'] / r['splitv_ms']:.1%} of it)")
        if not r["splitv_ms"] < r["wgmma_ms"]:
            log(f"NOTE: at f16 N={n} the split-V route ({r['splitv_ms']:.3f} "
                f"ms) is not below the wgmma route ({r['wgmma_ms']:.3f} ms) "
                f"though SPLITV_MAX_ROWS is {lk.SPLITV_MAX_ROWS}")
        del x, t, ref
    out["splitv"]["by_rows"] = rows
    del embed
    torch.cuda.empty_cache()
    log(f"phase 3c f16: {time.perf_counter() - t0:.2f} s")
    return out


def refill_blocks(torch, lk, fn) -> list:
    """Run ``fn`` once with the launcher watched: for each refill launch,
    (blocks that ran, blocks of its grid, open units, units in all), read
    from the ceilings it was given through the kernels' work list
    (``lens_kernel.refill_work``: a unit is open when one of its (chunk,
    row) pairs is; the grid is one block per SM, and a block runs when it
    takes one of the open units' tiles)."""
    real, seen = lk._launch, []

    def watched(x, embed, targets, plan, top_k, logit_cap, **kw):
        if kw.get("ceiling") is not None:
            seen.append((plan, kw["ceiling"].clone()))
        return real(x, embed, targets, plan, top_k, logit_cap, **kw)

    lk._launch = watched
    try:
        fn()
    finally:
        lk._launch = real
    torch.cuda.synchronize()
    grid = lk._sm_count(torch.device("cuda"))
    out = []
    for plan, ceiling in seen:
        work = lk.refill_work(ceiling.cpu(), plan)
        out.append((min(grid, work.starts[-1]), grid, len(work.units),
                    len(work.items)))
    return out


def refill_log(blocks: list) -> str:
    """Each refill's blocks that ran of its grid and open units of all."""
    return ", ".join(f"{a}/{b} blocks ({c}/{d} units)"
                     for a, b, c, d in blocks) or "none"


def _timed_call(torch, fn, n: int) -> float:
    """A call's device ms: CUDA events over back-to-back calls at the main
    path's N, behind the backlog at a readout's few rows."""
    return (timed_ms(torch, fn, 10) if n > 64
            else backlogged_ms(torch, fn, SPLITV_REPS)[0])


def _exact_inputs(torch, gen, n: int, dev):
    """bf16 x in {-1, 0, 1} and E in {-64 .. 64} / 64: every logit a
    multiple of 1/64 below 2**17, exact in f32 whatever the order of the
    sums, so the kernels and the plain version agree bit for bit, ties
    included."""
    x = torch.randint(-1, 2, (n, HIDDEN), generator=gen, device=dev).float()
    embed = torch.randint(-64, 65, (VOCAB, HIDDEN), generator=gen,
                          device=dev).float() / 64
    return x.to(torch.bfloat16), embed.to(torch.bfloat16)


def check_wide_worst(torch, lk, gen, dev) -> dict:
    """The certified passes' worst cases at K = WORST_K, bf16, at N 1140
    (wgmma) and N 8 (split-V): one row whose whole top-k lies in one chunk
    (PLANTED columns of E equal to that row / 4, on exact inputs), and
    all-equal logits (x = 0: every pair saturates, every pass runs full).
    Ids and values equal to the plain version's exactly; times, passes and
    the refill blocks that ran are logged."""
    out = {}
    k = WORST_K
    for n in (N_ROWS, 8):
        x, embed = _exact_inputs(torch, gen, n, dev)
        plan = lk.lens_plan(n, VOCAB, k, torch.bfloat16,
                            sm_count=lk._sm_count(dev))
        lo = plan.bounds[plan.chunks // 2]
        r0 = n // 2
        embed[lo:lo + PLANTED] = x[r0] / 4
        targets = torch.full((n,), lo, dtype=torch.int32, device=dev)
        for case in ("one_chunk", "all_equal"):
            if case == "all_equal":
                x = torch.zeros_like(x)
            call = lambda: lk.lens_stats(x, embed, targets, top_k=k)
            blocks = refill_blocks(torch, lk, call)
            got = call()
            ref = lk.lens_stats_reference(x, embed, targets, top_k=k)
            torch.cuda.synchronize()
            same = (torch.equal(got.topk_ids, ref.topk_ids)
                    and torch.equal(got.topk_vals, ref.topk_vals))
            err = (got.logsumexp - ref.logsumexp).abs().max().item()
            if case == "one_chunk":
                inside = ((ref.topk_ids[r0] >= lo)
                          & (ref.topk_ids[r0] < lo + PLANTED)).all().item()
            else:
                inside = (ref.topk_ids == torch.arange(
                    k, device=dev, dtype=torch.int32)).all().item()
            ms = _timed_call(torch, call, n)
            library_ms = _timed_call(torch, library_topk(torch, x, embed, k), n)
            bound_ms, bound_by = lens_bound_ms(n, HIDDEN, VOCAB, k)
            out[f"n{n}_{case}"] = dict(ms=ms, library_ms=library_ms,
                                       bound_ms=bound_ms, bound_by=bound_by,
                                       refill_blocks=blocks, ids_equal=same,
                                       lse_err=err, route=plan.route)
            log(f"  worst case {case} N={n} K={k} ({plan.route}): ids and "
                f"values equal to the plain version {same} (the planted "
                f"top-k where built: {inside}), lse err {err:.3e}; "
                f"{len(blocks) + 1} passes, refills ran {refill_log(blocks)}; "
                f"call {ms:.3f} ms, library {library_ms:.3f} ms "
                f"({ms / library_ms:.2f}x), bound {bound_ms:.3f} ms "
                f"({bound_by}; {bound_ms / ms:.1%} of it)")
            if not ms <= library_ms:
                log(f"NOTE: the worst case {case} at N={n} K={k} ({ms:.3f} "
                    f"ms) is not at or below its library call "
                    f"({library_ms:.3f} ms)")
            if not (same and inside and err <= ATOL):
                fail(f"the wide route's worst case {case} at N={n} K={k} "
                     "differs from the plain version")
        del x, embed, targets
    torch.cuda.empty_cache()
    return out


def check_wide_graph_and_syncs(torch, lk, gen, dev) -> dict:
    """A K 128 call at N 1140 and at N 8 under
    ``torch.cuda.set_sync_debug_mode("error")`` (nothing on the route
    syncs the host), and a K 64 call at N 1140 captured in a CUDA graph and
    replayed bit-equal to the same call run eagerly."""
    embed = (torch.randn((VOCAB, HIDDEN), generator=gen, device=dev)
             * HIDDEN ** -0.5).to(torch.bfloat16)
    for n in (N_ROWS, 8):
        x = torch.randn((n, HIDDEN), generator=gen, device=dev).to(torch.bfloat16)
        t = torch.randint(0, VOCAB, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        lk.lens_stats(x, embed, t, top_k=WORST_K)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            lk.lens_stats(x, embed, t, top_k=WORST_K)
        except RuntimeError as exc:
            fail(f"the K={WORST_K} call at N={n} syncs the host: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    log(f"  sync debug mode 'error': K={WORST_K} at N={N_ROWS} and N=8 "
        "raised nothing")
    x = torch.randn((N_ROWS, HIDDEN), generator=gen, device=dev).to(torch.bfloat16)
    t = torch.randint(0, VOCAB, (N_ROWS,), generator=gen, device=dev,
                      dtype=torch.int32)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            lk.lens_stats(x, embed, t, top_k=64)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = lk.lens_stats(x, embed, t, top_k=64)
    graph.replay()
    eager = lk.lens_stats(x, embed, t, top_k=64)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(captured, eager))
    log(f"  K=64 N={N_ROWS} captured in a CUDA graph: replay bit-equal to "
        f"eager {equal}")
    if not equal:
        fail("the K=64 graph replay differs from the eager call")
    del graph, captured, eager, x, embed
    torch.cuda.empty_cache()
    return {"sync_debug_raised": False, "graph_bit_equal": equal}


def measure_wide(torch) -> dict:
    """A top-k above KMAX_WIDE on the Hopper kernels (ceil(K / 32)
    certified passes; the split-V kernel certifies in its last blocks) at
    WIDE_CALLS: each held to the plain version (values at ATOL, ids entry
    by entry where clear), timed beside the library call at that K, the
    plain version and the bound, its launches by route counted; then the
    worst cases, the sync-debug calls and the graph replay.  Returns the
    kernels line's entry of the route."""
    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    sms = lk._sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for dtype_name in ("bf16", "f32"):
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype_name]
        embed = (torch.randn((VOCAB, HIDDEN), generator=gen, device=dev)
                 * HIDDEN ** -0.5).to(dtype)
        for n in sorted({n for d, n, _ in WIDE_CALLS if d == dtype_name},
                        reverse=True):
            x = torch.randn((n, HIDDEN), generator=gen, device=dev).to(dtype)
            t = torch.randint(0, VOCAB, (n,), generator=gen, device=dev,
                              dtype=torch.int32)
            ks = [k for d, m, k in WIDE_CALLS if d == dtype_name and m == n]
            ref = lk.lens_stats_reference(x, embed, t, top_k=max(ks) + 1)
            for k in ks:
                plan = lk.lens_plan(n, VOCAB, k, dtype, sm_count=sms)
                passes = -(-k // lk.KMAX_WIDE)
                before = dict(lk.lens_stats.route_launches)
                blocks = refill_blocks(
                    torch, lk, lambda: lk.lens_stats(x, embed, t, top_k=k))
                got = lk.lens_stats(x, embed, t, top_k=k)
                torch.cuda.synchronize()
                want = dict(before)
                want[plan.route] += 2
                want[f"{plan.route}_refill"] += 2 * (passes - 1)
                if lk.lens_stats.route_launches != want:
                    fail(f"{dtype_name} N={n} K={k} launched "
                         f"{lk.lens_stats.route_launches} from {before}; "
                         f"expected {passes} {plan.route} launches a call")
                err = max((got.logsumexp - ref.logsumexp).abs().max().item(),
                          (got.target_logit - ref.target_logit).abs().max().item(),
                          (got.topk_vals - ref.topk_vals[:, :k]).abs().max().item())
                e_clear, e_bad = rank_ids(torch, got.topk_ids, ref.topk_vals,
                                          ref.topk_ids, k)
                if not err <= ATOL or e_bad \
                        or e_clear < MIN_CLEAR_ENTRIES * n * k:
                    fail(f"the wide route at {dtype_name} N={n} K={k} "
                         f"disagrees with its plain version: err {err}, "
                         f"{e_bad} of {e_clear} clear entries with other ids")
                del got
                call = lambda: lk.lens_stats(x, embed, t, top_k=k)
                library = library_topk(torch, x, embed, k)
                turns = [_timed_call(torch, fn, n)
                         for fn in (library, call, call, library)]
                bounds = (f32_bounds_ms(n, HIDDEN, VOCAB, k) if dtype_name == "f32"
                          else dict(zip(("bound_ms", "bound_by"),
                                        lens_bound_ms(n, HIDDEN, VOCAB, k))))
                row = dict(dtype=dtype_name, n=n, k=k, route=plan.route,
                           passes=passes, refill_blocks=blocks,
                           max_abs_err=err, ms=(turns[1] + turns[2]) / 2,
                           library_ms=(turns[0] + turns[3]) / 2,
                           plain_ms=timed_ms(torch, lambda: lk.lens_stats_reference(
                               x, embed, t, top_k=k), 3),
                           bound_ms=bounds["bound_ms"],
                           bound_by=bounds["bound_by"])
                rows.append(row)
                log(f"{dtype_name} N={n} K={k} ({plan.route}, {passes} passes; "
                    f"refills ran {refill_log(blocks)}): "
                    f"max_abs_err {err:.3e}, ids equal on {e_clear - e_bad}/"
                    f"{e_clear} entries with clear margins; call "
                    f"{row['ms']:.3f} ms, library {row['library_ms']:.3f} ms "
                    f"({row['ms'] / row['library_ms']:.2f}x; in turns "
                    f"library, call, call, library: "
                    + ", ".join(f"{v:.3f}" for v in turns)
                    + f"), plain {row['plain_ms']:.3f} ms, bound "
                    f"{row['bound_ms']:.3f} ms ({row['bound_by']}; "
                    f"{row['bound_ms'] / row['ms']:.1%} of it)")
                if not row["ms"] < row["library_ms"]:
                    log(f"NOTE: the {dtype_name} N={n} K={k} call "
                        f"({row['ms']:.3f} ms) is not below its library call "
                        f"({row['library_ms']:.3f} ms)")
            del x, t, ref
        del embed
        torch.cuda.empty_cache()
    worst = check_wide_worst(torch, lk, gen, dev)
    checks = check_wide_graph_and_syncs(torch, lk, gen, dev)
    log(f"phase 3 wide top-k: {time.perf_counter() - t0:.2f} s")
    head = rows[0]   # bf16 N 1140 K 33
    return dict(
        name="lens_stats_wide_k", route="cuda",
        source=f"{PACKAGE}/csrc/lens_stats_wgmma.cu",
        replaces="taboo_brittleness_tpu/ops/pallas_lens.py:56", launches=0,
        max_abs_err=max(r["max_abs_err"] for r in rows), ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        n=head["n"], k=head["k"], on_main_path=False,
        sources=[f"{PACKAGE}/csrc/lens_stats_wgmma.cu",
                 f"{PACKAGE}/csrc/lens_stats_splitv.cu",
                 f"{PACKAGE}/csrc/refill_work.cuh"],
        rows=rows, worst_cases=worst, **checks)


def check_edges(torch) -> dict:
    """Edge shapes of each dtype on the card against the plain version,
    both caps, both kinds of target; then exact ties.  Returns the worst
    error per route (f32's keyed ``<route>_f32``, f16's ``<route>_f16``);
    fails if a route of a dtype was reached by no case."""
    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

    # Per dtype: its tag in the keys, rows, vocabularies, depths and top-k.
    # K 33: the long list in two certified passes.  f32 also one row past
    # its split-V limit (the wgmma kernel's f32 build); f16 one row past the
    # split-V limit and two row tiles.
    ks = (1, 5, lk.KMAX, *WIDE_KS, lk.KMAX_WIDE + 1)
    shapes = {
        "bf16": ("", (1, 129, N_ROWS), (384, VOCAB), (72, HIDDEN), ks),
        "f32": ("_f32", (1, lk.SPLITV_F32_MAX_ROWS + 1, 129, N_ROWS),
                (384, VOCAB), (72, HIDDEN), ks),
        "f16": ("_f16", (1, lk.SPLITV_MAX_ROWS + 1, 129), (384,), (72,),
                (1, lk.KMAX, lk.KMAX_WIDE, lk.KMAX_WIDE + 1)),
    }
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    types_ = {"bf16": torch.bfloat16, "f32": torch.float32,
              "f16": torch.float16}
    worst = {f"{r}{tag}": 0.0 for tag, *_ in shapes.values()
             for r in ("splitv", "wgmma")}
    n_cases = dict.fromkeys(worst, 0)
    for name, (tag, rows, vocabs, depths, ks) in shapes.items():
        dtype = types_[name]
        for v in vocabs:
            for d in depths:
                embed = (torch.randn((v, d), generator=gen, device=dev)
                         * d ** -0.5).to(dtype)
                for n in rows:
                    x = torch.randn((n, d), generator=gen, device=dev).to(dtype)
                    per_row = torch.randint(0, v, (n,), generator=gen,
                                            device=dev, dtype=torch.int32)
                    per_row[::3] = -1
                    for cap in (None, 30.0):
                        for target in (v - 17, per_row):
                            ref = lk.lens_stats_reference(
                                x, embed, target, top_k=max(ks) + 1,
                                logit_cap=cap)
                            for k in ks:
                                route = lk.lens_plan(n, v, k, dtype).route
                                got = lk.lens_stats(x, embed, target, top_k=k,
                                                    logit_cap=cap)
                                err, n_clear, n_bad = compare(got, ref, k)
                                _, e_bad = rank_ids(torch, got.topk_ids,
                                                    ref.topk_vals,
                                                    ref.topk_ids, k)
                                n_cases[route + tag] += 1
                                worst[route + tag] = max(worst[route + tag], err)
                                if not err <= ATOL or n_bad or e_bad:
                                    fail(f"edge {dtype} N={n} D={d} V={v} "
                                         f"K={k} cap={cap} ({route}): "
                                         f"max_abs_err {err:.3e}, {n_bad} id "
                                         f"mismatches of {n_clear} rows with "
                                         "clear margins")
                            del ref
                del embed, x
    log("edge shapes: " + ", ".join(
        f"{r} {n_cases[r]} cases max_abs_err {worst[r]:.3e}" for r in worst)
        + f" (atol {ATOL}); ids equal on every row with clear margins")
    if not all(n_cases.values()):
        fail(f"edge shapes reached a route by no case: {n_cases}")

    # Exact ties: entries that are multiples of 1/8 make every logit exact in
    # f32 whatever the order of the sums, and duplicated embedding rows in
    # different tiles and chunks tie exactly at the top of every row.
    x = torch.randint(-1, 2, (N_ROWS, HIDDEN), generator=gen, device=dev).float()
    x[:, :64] = 1.0
    embed = torch.randint(-1, 2, (VOCAB, HIDDEN), generator=gen,
                          device=dev).float() / 8
    hot = torch.zeros(HIDDEN, device=dev)
    hot[:64] = 1.0
    dups = torch.tensor(TIE_PATTERN, device=dev)
    x32, embed32 = x, embed.clone()
    x, embed = x.to(torch.bfloat16), embed.to(torch.bfloat16)
    # The duplicates at TIE_PATTERN for every K; then, for K 16 and up, also
    # on both sides of two of the wgmma plan's chunk edges.
    bounds = lk.lens_plan(N_ROWS, VOCAB, lk.KMAX_WIDE, torch.bfloat16,
                          sm_count=lk._sm_count(dev)).bounds
    mid = bounds[len(bounds) // 2]
    edge_dups = torch.tensor(sorted({*TIE_PATTERN, bounds[1] - 1, bounds[1],
                                     mid - 1, mid}), device=dev)
    long_ks = (*WIDE_KS, lk.KMAX_WIDE + 1)
    for ks_, heads_of in (((TOP_K, lk.KMAX, *long_ks), dups),
                          (long_ks, edge_dups)):
        embed[heads_of] = hot.to(torch.bfloat16)
        for k in ks_:
            route = lk.lens_plan(N_ROWS, VOCAB, k, torch.bfloat16).route
            got = lk.lens_stats(x, embed, 11, top_k=k)
            ref = lk.lens_stats_reference(x, embed, 11, top_k=k)
            torch.cuda.synchronize()
            same = torch.equal(got.topk_ids, ref.topk_ids)
            err = (got.topk_vals - ref.topk_vals).abs().max().item()
            heads = (got.topk_ids[:, :len(heads_of)]
                     == heads_of.to(torch.int32)).all().item()
            log(f"exact ties K={k} ({route}), {len(heads_of)} duplicated "
                f"rows: ids equal {same}, duplicated rows first in id order "
                f"{heads}, values max_abs_err {err:.3e}")
            if not (same and heads and err == 0.0):
                fail(f"the {route} route breaks exact ties at K {k} other "
                     "than lowest id first")
    del x, embed
    # The f32 and f16 builds: the same values are TF32 numbers (lo = 0), so
    # 3xTF32 sums them exactly, and f16 numbers, whose products are exact in
    # f32; duplicated rows on both sides of two chunk edges of each route's
    # own plan (wgmma at N 1140, split-V at N 8), and the last row.
    for name in ("f32", "f16"):
        dtype = types_[name]
        for n in (N_ROWS, 8):
            bounds = lk.lens_plan(n, VOCAB, lk.KMAX_WIDE, dtype,
                                  sm_count=lk._sm_count(dev)).bounds
            mid = bounds[len(bounds) // 2]
            heads_of = torch.tensor(sorted({bounds[1] - 1, bounds[1], mid - 1,
                                            mid, VOCAB - 1}), device=dev)
            embed = embed32.clone()
            embed[heads_of] = hot
            embed, xn = embed.to(dtype), x32[:n].to(dtype)
            for k in (TOP_K, lk.KMAX, *WIDE_KS, lk.KMAX_WIDE + 1):
                route = lk.lens_plan(n, VOCAB, k, dtype).route
                got = lk.lens_stats(xn, embed, 11, top_k=k)
                ref = lk.lens_stats_reference(xn, embed, 11, top_k=k)
                torch.cuda.synchronize()
                same = torch.equal(got.topk_ids, ref.topk_ids)
                err = (got.topk_vals - ref.topk_vals).abs().max().item()
                heads = (got.topk_ids[:, :len(heads_of)]
                         == heads_of.to(torch.int32)).all().item()
                log(f"exact ties {name} N={n} K={k} ({route}), duplicated "
                    f"rows on both sides of chunk edges: ids equal {same}, "
                    f"duplicated rows first in id order {heads}, values "
                    f"max_abs_err {err:.3e}")
                if not (same and heads and err == 0.0):
                    fail(f"the {name} {route} route breaks exact ties at K "
                         f"{k} other than lowest id first")
            del embed, xn
    del x32, embed32
    torch.cuda.empty_cache()
    return worst


# Phase 3b: the split-V kernel at the serving readouts' rows and top-k; the
# rows timed against the wgmma route (its plan built on purpose) for the
# crossover that sets SPLITV_MAX_ROWS; calls per timing behind the backlog.
SPLITV_ROWS = (1, 8, 16, 32, 33, 64)
SPLITV_KS = (1, 5, 8, *WIDE_KS)
WIDE_ROWS = (8, 32)   # the serving readout's and the speculative verify's N
CROSSOVER_ROWS = (1, 8, 16, 32, 48, 64)
SPLITV_REPS = 50
TP_VOCAB = VOCAB // 2    # one shard of phase 16's tp 2


def _readout_call(lk, x, embed, targets, plan):
    """A K = 1 readout through ``plan``'s kernel, P(target) last as the
    serving readouts take it: the split-V kernel merges its own chunks, the
    wgmma kernel's partials go through the torch merge."""
    if plan.route == "splitv":
        return lambda: lk._launch(x, embed, targets, plan, 1, None,
                                  merged=True).target_prob()
    return lambda: lk.merge_partials(
        lk._launch(x, embed, targets, plan, 1, None)).target_prob()


def _library_readout(torch, x, embed, targets):
    """The library yardstick of a K = 1 readout: one matmul, logsumexp and
    the target's gather (no top-k: the serving readouts read P(target))."""
    def call():
        # tbx: f32-ok — the library yardstick forms the [N, V] f32 logits
        logits = torch.matmul(x, embed.T).float()
        return torch.exp(logits.gather(1, targets.long()[:, None])[:, 0]
                         - torch.logsumexp(logits, dim=-1))
    return call


def _time_routes(torch, lk, x, embed, targets) -> dict:
    """The split-V and the wgmma route on the same readout, in turns
    (wgmma, splitv, splitv, wgmma) behind the backlog, then the library
    yardstick, and the bound."""
    n, v = x.shape[0], embed.shape[0]
    sms = lk._sm_count(x.device)
    fns = {"splitv": _readout_call(lk, x, embed, targets,
                                   lk._splitv_plan(n, v, sms)),
           "wgmma": _readout_call(lk, x, embed, targets,
                                  lk._wgmma_plan(n, v, sms))}
    times = {name: [] for name in fns}
    for name in ("wgmma", "splitv", "splitv", "wgmma"):
        times[name].append(backlogged_ms(torch, fns[name], SPLITV_REPS)[0])
    if x.dtype == torch.float32:
        b = f32_bounds_ms(n, x.shape[1], v, 1)
        bound_ms, bound_by = b["bound_ms"], b["bound_by"]
    else:
        bound_ms, bound_by = lens_bound_ms(n, x.shape[1], v, 1)
    return {"n": n, "v": v, **{f"{k}_ms": sum(t) / 2 for k, t in times.items()},
            "library_ms": backlogged_ms(
                torch, _library_readout(torch, x, embed, targets),
                SPLITV_REPS)[0],
            "bound_ms": bound_ms, "bound_by": bound_by}


def _chunk_position_targets(torch, plan, n: int, dev):
    """[N] targets that put a row's target at the first, second, middle and
    last column of the plan's chunks in turn, over every chunk."""
    spots = []
    for r in range(n):
        s = (r * 37) % plan.chunks
        lo, hi = plan.bounds[s], plan.bounds[s + 1]
        spots.append((lo, lo + 1, (lo + hi) // 2, hi - 1)[r % 4])
    return torch.tensor(spots, dtype=torch.int32, device=dev)


def check_splitv(torch) -> dict:
    """Phase 3b: the split-V kernel (the route of every readout of at most
    SPLITV_MAX_ROWS rows) against the plain version: merged stats (its last
    block's merge) at N in SPLITV_ROWS, K in SPLITV_KS, cap None and 30,
    per-row targets with -1 and V - 1, V 256000 and 128000; its raw partials
    chunk by chunk at K 5 and at K 32 (targets at every chunk position);
    exact ties planted on both sides of chunk edges.  Then the split-V and
    the wgmma route timed on the same readouts at N in CROSSOVER_ROWS (the
    crossover), the body and the torch merge apart at N 8, the tp shard's V
    128000, and the long list at N in WIDE_ROWS, K in WIDE_KS.  Returns the
    kernel's entry of the kernels line."""
    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    sms = lk._sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    worst, n_cases = 0.0, 0
    for v in (VOCAB, TP_VOCAB):
        embed = (torch.randn((v, HIDDEN), generator=gen, device=dev)
                 * HIDDEN ** -0.5).to(torch.bfloat16)
        for n in SPLITV_ROWS:
            x = torch.randn((n, HIDDEN), generator=gen, device=dev).to(torch.bfloat16)
            per_row = torch.randint(0, v, (n,), generator=gen, device=dev,
                                    dtype=torch.int32)
            per_row[1::3] = -1
            per_row[-1] = v - 1
            plan = lk.lens_plan(n, v, 1, torch.bfloat16, sm_count=sms)
            if plan.route != "splitv" or plan.chunks != sms:
                fail(f"N={n} V={v} plans {plan.route} with {plan.chunks} "
                     f"chunks, not splitv over {sms}")
            for cap in (None, 30.0):
                ref = lk.lens_stats_reference(x, embed, per_row,
                                              top_k=max(SPLITV_KS) + 1,
                                              logit_cap=cap)
                for k in SPLITV_KS:
                    before = dict(lk.lens_stats.route_launches)
                    got = lk.lens_stats(x, embed, per_row, top_k=k,
                                        logit_cap=cap)
                    torch.cuda.synchronize()
                    if lk.lens_stats.route_launches != {
                            **before, "splitv": before["splitv"] + 1}:
                        fail(f"N={n} V={v} K={k} did not launch the splitv "
                             "kernel alone")
                    err, n_clear, n_bad = compare(got, ref, k)
                    e_clear, e_bad = rank_ids(torch, got.topk_ids,
                                              ref.topk_vals, ref.topk_ids, k)
                    n_cases += 1
                    worst = max(worst, err)
                    if not err <= ATOL or n_bad or e_bad:
                        fail(f"splitv N={n} V={v} K={k} cap={cap}: max_abs_err "
                             f"{err:.3e}, {n_bad} id mismatches of {n_clear} "
                             f"rows and {e_bad} of {e_clear} entries with "
                             "clear margins")
                del ref
                for k, targets in ((TOP_K, per_row), (lk.KMAX_WIDE,
                                   _chunk_position_targets(torch, plan, n, dev))):
                    parts = lk.lens_stats_partials(x, embed, targets, top_k=k,
                                                   logit_cap=cap)
                    pref = lk.lens_stats_partials_reference(
                        x, embed, targets, plan, top_k=k + 1, logit_cap=cap)
                    torch.cuda.synchronize()
                    err, rel, n_clear, n_bad = compare_partials(parts, pref, k)
                    e_clear, e_bad = rank_ids(torch, parts.cand_ids,
                                              pref.cand_vals, pref.cand_ids, k)
                    worst = max(worst, err)
                    enough = (n_clear >= MIN_ID_ROWS * parts.chunk_max.numel()
                              if k <= lk.KMAX else
                              e_clear >= MIN_CLEAR_ENTRIES * parts.cand_ids.numel())
                    if not (err <= ATOL and rel <= SUMEXP_RTOL) or n_bad \
                            or e_bad or not enough:
                        fail(f"splitv partials N={n} V={v} K={k} cap={cap}: "
                             f"max_abs_err {err:.3e}, sum-exp rel {rel:.3e}, "
                             f"{n_bad} row and {e_bad} entry id mismatches, "
                             f"{n_clear}/{parts.chunk_max.numel()} rows and "
                             f"{e_clear}/{parts.cand_ids.numel()} entries clear")
                    del parts, pref
        del embed, x
        torch.cuda.empty_cache()
    log(f"splitv: {n_cases} merged cases and {2 * 2 * 2 * len(SPLITV_ROWS)} "
        f"raw partials [{sms}, N] (K {TOP_K} and {lk.KMAX_WIDE}, the latter "
        "with targets at every chunk position) held to the plain version: "
        f"max_abs_err "
        f"{worst:.3e} (atol {ATOL}, sum-exp rtol {SUMEXP_RTOL}); ids equal on "
        "every row with clear margins")

    # Exact ties on both sides of chunk edges (entries that are multiples of
    # 1/8: every logit exact in f32 whatever the order of the sums).
    x = torch.randint(-1, 2, (max(SPLITV_ROWS), HIDDEN), generator=gen,
                      device=dev).float()
    x[:, :64] = 1.0
    embed = torch.randint(-1, 2, (VOCAB, HIDDEN), generator=gen,
                          device=dev).float() / 8
    bounds = lk.lens_plan(8, VOCAB, 1, torch.bfloat16, sm_count=sms).bounds
    mid = bounds[len(bounds) // 2]
    dups = torch.tensor((bounds[1] - 1, bounds[1], mid - 1, mid, VOCAB - 1),
                        device=dev)
    embed[dups] = 0.0
    embed[dups, :64] = 1.0
    x, embed = x.to(torch.bfloat16), embed.to(torch.bfloat16)
    for n in (8, max(SPLITV_ROWS)):
        for k in (TOP_K, lk.KMAX, *WIDE_KS):
            got = lk.lens_stats(x[:n], embed, 11, top_k=k)
            ref = lk.lens_stats_reference(x[:n], embed, 11, top_k=k)
            torch.cuda.synchronize()
            same = torch.equal(got.topk_ids, ref.topk_ids)
            err = (got.topk_vals - ref.topk_vals).abs().max().item()
            heads = (got.topk_ids[:, :len(dups)] == dups.to(torch.int32)).all().item()
            log(f"splitv exact ties across chunk edges N={n} K={k}: ids equal "
                f"{same}, duplicated rows first in id order {heads}, values "
                f"max_abs_err {err:.3e}")
            if not (same and heads and err == 0.0):
                fail("the splitv kernel breaks exact ties other than lowest "
                     "id first")
    del x, embed
    torch.cuda.empty_cache()

    # The routes timed on the same readouts (K = 1, as the serving paths).
    embed = (torch.randn((VOCAB, HIDDEN), generator=gen, device=dev)
             * HIDDEN ** -0.5).to(torch.bfloat16)
    rows = []
    for n in CROSSOVER_ROWS:
        x = torch.randn((n, HIDDEN), generator=gen, device=dev).to(torch.bfloat16)
        t = torch.randint(0, VOCAB, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        r = _time_routes(torch, lk, x, embed, t)
        rows.append(r)
        log(f"  N={n} V={VOCAB} K=1 readout: splitv {r['splitv_ms']:.3f} ms, "
            f"wgmma {r['wgmma_ms']:.3f} ms, library {r['library_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}; splitv "
            f"{r['bound_ms'] / r['splitv_ms']:.1%} of it)")
        if n == 8:
            x8, t8, r8 = x, t, r
    crossover = next((r["n"] for r in rows if r["splitv_ms"] >= r["wgmma_ms"]),
                     None)
    faster = [r["n"] for r in rows if r["splitv_ms"] < r["wgmma_ms"]]
    log(f"crossover: splitv faster than wgmma at N in {faster}; first N where "
        f"it is not: {crossover} (SPLITV_MAX_ROWS {lk.SPLITV_MAX_ROWS})")

    def body():
        return lk.lens_stats_partials(x8, embed, t8, top_k=1)

    parts = body()

    def merge():
        return lk.merge_partials(parts).target_prob()

    def plain():
        return lk.lens_stats_reference(x8, embed, t8, top_k=1).target_prob()

    body_ms = backlogged_ms(torch, body, SPLITV_REPS)[0]
    merge_ms = backlogged_ms(torch, merge, SPLITV_REPS)[0]
    plain_ms = timed_ms(torch, plain, 3)
    log(f"splitv at N=8: body (partials alone) {body_ms:.3f} ms + torch merge "
        f"{merge_ms:.3f} ms ({merge_ms / (body_ms + merge_ms):.1%} of a call "
        f"merged in torch); the call merged by its last block "
        f"{r8['splitv_ms']:.3f} ms (the merge and P(target) "
        f"{r8['splitv_ms'] - body_ms:.3f} ms); plain {plain_ms:.3f} ms")
    del embed, parts
    torch.cuda.empty_cache()
    embed = (torch.randn((TP_VOCAB, HIDDEN), generator=gen, device=dev)
             * HIDDEN ** -0.5).to(torch.bfloat16)
    tp = _time_routes(torch, lk, x8, embed, t8 % TP_VOCAB)
    log(f"  tp shard N=8 V={TP_VOCAB} K=1 readout: splitv {tp['splitv_ms']:.3f} "
        f"ms, wgmma {tp['wgmma_ms']:.3f} ms, library {tp['library_ms']:.3f} "
        f"ms, bound {tp['bound_ms']:.3f} ms ({tp['bound_ms'] / tp['splitv_ms']:.1%})")
    del embed, x8
    torch.cuda.empty_cache()
    wide = time_wide_splitv(torch, lk, gen, dev)
    log(f"phase 3b: {time.perf_counter() - t0:.2f} s")
    return dict(
        name="lens_stats_splitv", route="cuda",
        source=f"{PACKAGE}/csrc/lens_stats_splitv.cu",
        replaces="taboo_brittleness_tpu/ops/pallas_lens.py:56", launches=0,
        max_abs_err=worst, ms=r8["splitv_ms"], plain_ms=plain_ms,
        bound_ms=r8["bound_ms"], bound_by=r8["bound_by"],
        library_ms=r8["library_ms"], wgmma_ms=r8["wgmma_ms"],
        body_ms=body_ms, merge_ms=merge_ms, crossover=crossover,
        by_rows=rows, tp_shard=tp, wide=wide)


def check_f32_crossover(torch) -> dict:
    """Phase 3b, f32: the split-V and the wgmma kernels' f32 instantiations
    on the same K = 1 readouts at N in CROSSOVER_ROWS, each held to the
    plain version, then timed in turns (wgmma, splitv, splitv, wgmma) behind
    the backlog beside the f32 library call and the bound: the crossover
    that sets SPLITV_F32_MAX_ROWS."""
    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    sms = lk._sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    embed = torch.randn((VOCAB, HIDDEN), generator=gen, device=dev) * HIDDEN ** -0.5
    rows, worst = [], 0.0
    for n in CROSSOVER_ROWS:
        x = torch.randn((n, HIDDEN), generator=gen, device=dev)
        t = torch.randint(0, VOCAB, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        ref = lk.lens_stats_reference(x, embed, t, top_k=2)
        for plan in (lk._splitv_plan(n, VOCAB, sms), lk._wgmma_plan(n, VOCAB, sms)):
            got = (lk._launch(x, embed, t, plan, 1, None, merged=True)
                   if plan.route == "splitv" else
                   lk.merge_partials(lk._launch(x, embed, t, plan, 1, None)))
            torch.cuda.synchronize()
            err, _, n_bad = compare(got, ref, 1)
            worst = max(worst, err)
            if not err <= ATOL or n_bad:
                fail(f"f32 {plan.route} N={n} K=1: max_abs_err {err:.3e}, "
                     f"{n_bad} rows with other ids")
        r = _time_routes(torch, lk, x, embed, t)
        rows.append(r)
        log(f"  f32 N={n} V={VOCAB} K=1 readout: splitv {r['splitv_ms']:.3f} "
            f"ms, wgmma {r['wgmma_ms']:.3f} ms, library {r['library_ms']:.3f} "
            f"ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}; splitv "
            f"{r['bound_ms'] / r['splitv_ms']:.1%} of it)")
        del x, t, ref
    del embed
    torch.cuda.empty_cache()
    crossover = next((r["n"] for r in rows if r["splitv_ms"] >= r["wgmma_ms"]),
                     None)
    faster = [r["n"] for r in rows if r["splitv_ms"] < r["wgmma_ms"]]
    log(f"f32 crossover: splitv faster than wgmma at N in {faster}; first N "
        f"where it is not: {crossover} (SPLITV_F32_MAX_ROWS "
        f"{lk.SPLITV_F32_MAX_ROWS}); max_abs_err {worst:.3e}; "
        f"{time.perf_counter() - t0:.2f} s")
    return {"crossover": crossover, "by_rows": rows, "max_abs_err": worst}


def time_wide_splitv(torch, lk, gen, dev) -> dict:
    """The split-V kernel's long list at N in WIDE_ROWS, K in WIDE_KS (and
    K 5 beside them) on V 256000, each call merged by its last block and
    timed behind the backlog, beside the library yardstick (behind the
    backlog too), the plain version and the bound."""
    embed = (torch.randn((VOCAB, HIDDEN), generator=gen, device=dev)
             * HIDDEN ** -0.5).to(torch.bfloat16)
    out = {}
    for n in WIDE_ROWS:
        x = torch.randn((n, HIDDEN), generator=gen, device=dev).to(torch.bfloat16)
        t = torch.randint(0, VOCAB, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        k5_ms = backlogged_ms(torch, lambda: lk.lens_stats(
            x, embed, t, top_k=TOP_K), SPLITV_REPS)[0]
        for k in WIDE_KS:
            if lk.lens_plan(n, VOCAB, k, torch.bfloat16,
                            sm_count=lk._sm_count(dev)).route != "splitv":
                fail(f"N={n} K={k} does not plan the splitv route")
            bound_ms, bound_by = lens_bound_ms(n, HIDDEN, VOCAB, k)
            r = dict(
                ms=backlogged_ms(torch, lambda: lk.lens_stats(
                    x, embed, t, top_k=k), SPLITV_REPS)[0], k5_ms=k5_ms,
                plain_ms=timed_ms(torch, lambda: lk.lens_stats_reference(
                    x, embed, t, top_k=k), 3),
                library_ms=backlogged_ms(
                    torch, library_topk(torch, x, embed, k), SPLITV_REPS)[0],
                bound_ms=bound_ms, bound_by=bound_by)
            out[f"n{n}_k{k}"] = r
            log(f"  N={n} K={k} (splitv, long list): call {r['ms']:.3f} ms "
                f"(K={TOP_K} {k5_ms:.3f} ms), plain {r['plain_ms']:.3f} ms, "
                f"library {r['library_ms']:.3f} ms, bound {bound_ms:.3f} ms "
                f"({bound_by}; {bound_ms / r['ms']:.1%} of it)")
            if not r["ms"] < r["library_ms"]:
                log(f"NOTE: the N={n} K={k} splitv call ({r['ms']:.3f} ms) is "
                    f"not below its library yardstick ({r['library_ms']:.3f} ms)")
        del x, t
    del embed
    torch.cuda.empty_cache()
    return out


# Phase 5's tiny f32 lens passes: (prompts, columns) of N 33 rows (the
# split-V kernel's f32 build) and of N 77 (the wgmma kernel's).
TINY_F32_SHAPES = ((3, 11, "splitv"), (7, 11, "wgmma"))
PROB_ATOL = 1e-5


def _reset_launches(lens_kernel) -> None:
    lens_kernel.lens_stats.launches = 0
    lens_kernel.lens_stats.route_launches.update(
        dict.fromkeys(lens_kernel.lens_stats.route_launches, 0))


def check_small_against_cpu(torch) -> dict:
    """A tiny model (f32, vocab 256) through the lens pass on the card (the
    f32 builds of the Hopper kernels: N 33 on the split-V route, N 77 on the
    wgmma route, each route's launches counted) and on the CPU (the plain
    tap): same stats at PROB_ATOL.  Returns {route: max abs error}."""
    from taboo_brittleness_tpu_torch.models import gemma2
    from taboo_brittleness_tpu_torch.ops import lens, lens_kernel

    cfg = gemma2.PRESETS["gemma2_tiny"].replace(vocab_size=256)
    params = gemma2.init_params(cfg, torch.Generator().manual_seed(1),
                                device="cpu")
    on_card = {k: v.cuda() for k, v in params.items() if k != "layers"}
    on_card["layers"] = {k: v.cuda() for k, v in params["layers"].items()}
    out = {}
    for b, t, route in TINY_F32_SHAPES:
        ids = torch.randint(0, 256, (b, t),
                            generator=torch.Generator().manual_seed(2))
        targets = torch.full((b,), 17)
        cpu = lens.lens_forward(params, cfg, ids, targets, tap_layer=2, top_k=3)
        _reset_launches(lens_kernel)
        gpu = lens.lens_forward(on_card, cfg, ids.cuda(), targets.cuda(),
                                tap_layer=2, top_k=3)
        torch.cuda.synchronize()
        by_route = dict(lens_kernel.lens_stats.route_launches)
        want = {**dict.fromkeys(by_route, 0), route: cfg.num_layers}
        if by_route != want:
            fail(f"the tiny f32 lens pass at N {b * t} launched {by_route}; "
                 f"expected {want}")
        err = max(
            (gpu.tap.target_prob.cpu() - cpu.tap.target_prob).abs().max().item(),
            (gpu.tap.topk_probs.cpu() - cpu.tap.topk_probs).abs().max().item(),
            (gpu.residual.cpu() - cpu.residual).abs().max().item())
        same = torch.equal(gpu.tap.topk_ids.cpu(), cpu.tap.topk_ids)
        log(f"tiny f32 lens pass N={b * t} ({route}, {by_route[route]} "
            f"launches), card vs CPU: max_abs_err {err:.3e} (atol "
            f"{PROB_ATOL}), top-k ids equal: {same}")
        if not (err <= PROB_ATOL and same):
            fail(f"the tiny lens pass at N {b * t} on the card disagrees with "
                 "the CPU")
        out[route] = err
    return out


# Phase 5b: a 2-layer f32 model at Gemma-2-9B width (its lens calls are
# the f32 instantiations' main path), the 10 prompts at their padded 64
# columns on the wgmma route and one prompt's last 8 columns on the
# split-V route.
F32_9B_LAYERS = 2
F32_9B_READOUT_ROWS = 8


def check_f32_lens_pass(torch) -> dict:
    """5b: ``lens.lens_forward`` of a 2-layer Gemma-2-9B-width f32 model
    (seeded random weights made on the card) with the kernel tap, held to
    the same call with the plain tap on the card: probabilities within
    PROB_ATOL, top-5 ids equal wherever the margins clear.  The kernel
    counts are set to 0 just before each kernel pass and read just after.
    Returns {route: (launches, max abs error)}."""
    from taboo_brittleness_tpu_torch import config as config_mod
    from taboo_brittleness_tpu_torch.models import gemma2
    from taboo_brittleness_tpu_torch.ops import lens, lens_kernel
    from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

    t0 = time.perf_counter()
    config = config_mod.Config(output=config_mod.OutputConfig(save_plots=False))
    cfg = gemma2.PRESETS["gemma2_9b"].replace(
        num_layers=F32_9B_LAYERS, dtype="float32", param_dtype="float32")
    params = gemma2.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(7), device="cuda")
    words = sorted({w for p in config.prompts for w in p.split()}
                   | set(config.words))
    tok = WordTokenizer(words, vocab_size=cfg.vocab_size)
    ids, valid, positions = _prompt_args(torch, (params, cfg, tok, config))
    size = gemma2.num_params(params) * 4 / 2**30
    out = {}
    for route, cut in (("wgmma", slice(None)),
                       ("splitv", slice(-F32_9B_READOUT_ROWS, None))):
        rows = (slice(None), cut) if route == "wgmma" else (slice(0, 1), cut)
        args = (params, cfg, ids[rows])
        kw = dict(tap_layer=1, positions=positions[rows],
                  attn_validity=valid[rows])
        targets = torch.full((args[2].shape[0],), 17, device="cuda")
        plain = lens.lens_forward(*args, targets, top_k=TOP_K + 1,
                                  use_pallas=False, **kw)
        _reset_launches(lens_kernel)
        got = lens.lens_forward(*args, targets, top_k=TOP_K, use_pallas=True,
                                **kw)
        torch.cuda.synchronize()
        by_route = dict(lens_kernel.lens_stats.route_launches)
        want = {**dict.fromkeys(by_route, 0), route: cfg.num_layers}
        if by_route != want:
            fail(f"5b: the f32 lens pass over {args[2].shape} launched "
                 f"{by_route}; expected {want}")
        g, p = got.tap, plain.tap
        err = max((g.target_prob - p.target_prob).abs().max().item(),
                  (g.topk_probs - p.topk_probs[..., :TOP_K]).abs().max().item())
        logp = p.topk_probs.clamp_min(1e-38).log()
        e_clear, e_bad = rank_ids(torch, g.topk_ids, logp, p.topk_ids, TOP_K)
        n = args[2].numel()
        log(f"5b f32 lens pass {tuple(args[2].shape)} = {n} rows ({route}, "
            f"{by_route[route]} launches): probabilities max_abs_err "
            f"{err:.3e} (atol {PROB_ATOL}) against the plain tap on the card; "
            f"top-{TOP_K} ids equal on {e_clear - e_bad}/{e_clear} entries "
            f"with clear margins of {g.topk_ids.numel()}")
        if not (err <= PROB_ATOL and e_bad == 0
                and e_clear >= MIN_CLEAR_ENTRIES * g.topk_ids.numel()):
            fail(f"5b: the f32 {route} lens pass disagrees with the plain tap: "
                 f"err {err:.3e}, {e_bad} entries with other ids")
        out[route] = (by_route[route], err)
        del plain, got
    del params
    torch.cuda.empty_cache()
    log(f"5b: {F32_9B_LAYERS}-layer f32 model at Gemma-2-9B width "
        f"({size:.2f} GiB of weights made on the card) in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


class PhaseTimer:
    """Adds a synchronised host clock around module functions of the main
    path (``decode.generate``, ``lens.lens_forward``,
    ``lens.aggregate_from_residual``) while a run is driven; where ``keep``
    is given, also appends ``keep(result)`` of each call to
    ``kept[label]``."""

    def __init__(self, torch):
        self.torch = torch
        self.seconds = {}
        self.calls = {}
        self.kept = {}
        self._restore = []

    def wrap(self, module, name: str, label: str, keep=None) -> None:
        orig = getattr(module, name)

        def timed(*args, **kwargs):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            self.torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.seconds[label] = self.seconds.get(label, 0.0) + dt
            self.calls.setdefault(label, []).append(dt)
            if keep is not None:
                self.kept.setdefault(label, []).append(keep(out))
            return out

        setattr(module, name, timed)
        self._restore.append((module, name, orig))

    def restore(self) -> None:
        for module, name, orig in reversed(self._restore):
            setattr(module, name, orig)


def _keep_tap(res):
    """A lens pass's per-layer top-k (ids, log-probabilities) on the host."""
    return (res.tap.topk_ids.cpu(),
            res.tap.topk_probs.float().clamp_min(1e-38).log().cpu())


def _keep_guesses(out):
    """The aggregation's (ids [B, K], summed probabilities [B, K])."""
    return tuple(t.cpu() for t in out)


def _held_topk(what: str, ids5, ids_wide, vals_wide, margin: float) -> tuple:
    """Holds the first 5 of a wider top-k to the K 5 pass's: as a set where
    the 5th/6th margin of the wider values clears ``margin``, in order where
    every margin of its top 6 does.  Returns (rows held as sets, in order,
    of all)."""
    gaps = vals_wide[..., :5] - vals_wide[..., 1:6]
    as_set = gaps[..., 4] > margin
    in_order = (gaps > margin).all(dim=-1)
    head = ids_wide[..., :5]
    same_set = (head.sort(dim=-1).values == ids5.sort(dim=-1).values).all(dim=-1)
    same_order = (head == ids5).all(dim=-1)
    bad = int((as_set & ~same_set).sum()) + int((in_order & ~same_order).sum())
    if bad:
        fail(f"{what}: {bad} rows whose top-5 differs from the K 5 pass's "
             "although the margins clear")
    return int(as_set.sum()), int(in_order.sum()), as_set.numel()


def check_wide_lens_pass(torch, config, tok, loader, processed: str,
                         workdir: str, word: str, taps5, guesses5,
                         results5) -> dict:
    """``run_evaluation`` of ``word`` again at ``top_k`` 16 (the wgmma
    kernel's long list): 42 launches, all wgmma; its lens taps' and its
    guesses' top 5 held to the K 5 pass's (``taps5``, ``guesses5``,
    ``results5``) under the margin rule of :func:`_held_topk`."""
    import dataclasses

    from taboo_brittleness_tpu_torch.ops import lens, lens_kernel
    from taboo_brittleness_tpu_torch.pipelines import logit_lens

    k = WIDE_KS[0]
    wide = dataclasses.replace(config, model=dataclasses.replace(
        config.model, top_k=k))
    timer = PhaseTimer(torch)
    timer.wrap(lens, "lens_forward", "lens", keep=_keep_tap)
    timer.wrap(lens, "aggregate_from_residual", "aggregate", keep=_keep_guesses)
    lens_kernel.lens_stats.launches = 0
    lens_kernel.lens_stats.route_launches.update(
        dict.fromkeys(lens_kernel.lens_stats.route_launches, 0))
    t0 = time.perf_counter()
    try:
        results = logit_lens.run_evaluation(
            wide, tok, words=[word], model_loader=loader,
            processed_dir=processed,
            output_path=os.path.join(workdir, f"top{k}", "results.json"))
    finally:
        timer.restore()
    seconds = time.perf_counter() - t0
    taps = timer.kept.get("lens", [])
    guesses = timer.kept.get("aggregate", [])
    by_route = dict(lens_kernel.lens_stats.route_launches)
    n_layers = taps5[0][0].shape[0]
    if by_route != {"splitv": 0, "wgmma": n_layers, "splitv_refill": 0,
                    "wgmma_refill": 0}:
        fail(f"the top_k {k} logit-lens pass launched {by_route}; expected "
             f"{n_layers} on the wgmma route alone")
    if len(taps) != 1 or len(guesses) != 1:
        fail(f"the top_k {k} pass made {len(taps)} lens passes and "
             f"{len(guesses)} aggregations, expected one each")
    (ids5, _), (ids_w, logp_w) = taps5[0], taps[0]
    if ids_w.shape != ids5.shape[:-1] + (k,):
        fail(f"top_k {k} lens taps {tuple(ids_w.shape)} beside K 5's "
             f"{tuple(ids5.shape)}")
    tap_sets, tap_order, tap_rows = _held_topk(
        "lens taps", ids5, ids_w, logp_w, ATOL)
    (gids5, _), (gids_w, gsum_w) = guesses5[0], guesses[0]
    g_sets, g_order, g_rows = _held_topk(
        "guesses", gids5, gids_w, gsum_w, AGG_MARGIN)
    preds5, preds_w = (r[word]["predictions"] for r in (results5, results))
    clear = (gsum_w[:, 4] - gsum_w[:, 5] > AGG_MARGIN).tolist()
    off = [b for b, c in enumerate(clear)
           if c and sorted(preds_w[b][:5]) != sorted(preds5[b])]
    if off:
        fail(f"top_k {k} guesses of prompts {off} differ from the K 5 pass's")
    log(f"logit-lens at top_k {k} ({word}, {seconds:.2f} s): launches by route "
        f"{by_route}; lens-tap top-5 ids equal the K 5 pass's as sets on "
        f"{tap_sets}/{tap_rows} (layer, prompt, position) rows with a clear "
        f"5th/6th margin and in order on {tap_order} with every margin clear; "
        f"guesses likewise on {g_sets} and {g_order} of {g_rows} prompts")
    return {"top_k": k, "launches": by_route["wgmma"], "seconds": seconds,
            "tap_rows_held": tap_sets, "guess_rows_held": g_sets}


def drive_main_path(torch, workdir: str) -> tuple:
    """``run_generation`` for one word, then ``run_evaluation`` for it and a
    second word (the first from the cache, the second through the model) at
    Gemma-2-9B width.  Returns the kernel launches of the run by route and
    (params, cfg, tokenizer, config, cache directory, word) for the next
    phase."""
    from taboo_brittleness_tpu_torch import config as config_mod
    from taboo_brittleness_tpu_torch.models import gemma2
    from taboo_brittleness_tpu_torch.ops import lens, lens_kernel
    from taboo_brittleness_tpu_torch.pipelines import generation, logit_lens
    from taboo_brittleness_tpu_torch.runtime import cache as cache_io
    from taboo_brittleness_tpu_torch.runtime import decode
    from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

    config = config_mod.Config(
        output=config_mod.OutputConfig(save_plots=False))
    cfg = gemma2.PRESETS["gemma2_9b"]
    gen_word, lens_word = "ship", "moon"
    t0 = time.perf_counter()
    params = gemma2.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    log(f"gemma2_9b: {cfg.num_layers} layers, D={cfg.hidden_size}, "
        f"V={cfg.vocab_size}, {gemma2.num_params(params) / 1e9:.2f} B params "
        f"({cfg.param_dtype}) made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    words = sorted({w for p in config.prompts for w in p.split()}
                   | set(config.words))
    tok = WordTokenizer(words, vocab_size=cfg.vocab_size)

    def loader(word):
        return params, cfg, tok

    processed = os.path.join(workdir, "processed")
    timer = PhaseTimer(torch)
    timer.wrap(decode, "generate", "decode")
    timer.wrap(lens, "lens_forward", "lens", keep=_keep_tap)
    timer.wrap(lens, "aggregate_from_residual", "aggregate", keep=_keep_guesses)
    torch.cuda.reset_peak_memory_stats()
    lens_kernel.lens_stats.launches = 0
    lens_kernel.lens_stats.route_launches.update(
        dict.fromkeys(lens_kernel.lens_stats.route_launches, 0))
    try:
        t0 = time.perf_counter()
        done = generation.run_generation(
            config, model_loader=loader, words=[gen_word],
            processed_dir=processed, fail_fast=True)
        t_gen = time.perf_counter() - t0
        after_generate = lens_kernel.lens_stats.launches
        timer.kept.clear()   # keep run_evaluation's calls alone
        t0 = time.perf_counter()
        results = logit_lens.run_evaluation(
            config, tok, words=[gen_word, lens_word], model_loader=loader,
            processed_dir=processed,
            output_path=os.path.join(workdir, "results.json"))
        t_eval = time.perf_counter() - t0
    finally:
        timer.restore()
    taps5 = timer.kept.get("lens", [])
    guesses5 = timer.kept.get("aggregate", [])
    launches = lens_kernel.lens_stats.launches
    by_route = dict(lens_kernel.lens_stats.route_launches)
    peak = torch.cuda.max_memory_allocated()

    n_prompts = len(config.prompts)
    if done != {gen_word: list(range(n_prompts))}:
        fail(f"run_generation wrote {done}")
    if after_generate != cfg.num_layers or launches != 2 * cfg.num_layers:
        fail(f"lens kernel launches: {after_generate} in generate, {launches} "
             f"in all; expected {cfg.num_layers} per lens pass, 2 passes")
    if by_route["wgmma"] != launches:
        fail(f"lens kernel launches by route: {by_route}; expected all "
             f"{launches} on the wgmma route")
    log(f"run_generation ({gen_word}) {t_gen:.2f} s, run_evaluation "
        f"({gen_word} cached, {lens_word} on the card) {t_eval:.2f} s; lens "
        f"kernel launches {launches} = {cfg.num_layers} per lens pass x 2, "
        f"by route {by_route}")
    log("phases (host clock, synchronised, summed over both words): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in timer.seconds.items())
        + f"; peak device memory {peak / 2**30:.2f} GiB "
        "(torch.cuda.max_memory_allocated)")

    # The outputs: summaries of the expected shapes and ranges, and the
    # lens at the last layer reproducing the decode's own greedy tokens.  Not
    # all of them: the decode picks from logits rounded to bf16 (ties go to
    # the lower id) in a one-column forward, the kernel from f32 sums over
    # the whole sequence, and a random model's top-2 gap is under bf16's
    # step (1/64 near 3) at several percent of positions.
    agree = total = 0
    for i in range(n_prompts):
        arrays, meta = cache_io.load_summary(
            cache_io.summary_path(processed, gen_word, i))
        T = arrays["token_ids"].shape[0]
        tp = arrays["target_prob"]
        if tp.shape != (cfg.num_layers, T) or not ((tp >= 0) & (tp <= 1)).all():
            fail(f"summary {i}: target_prob {tp.shape}")
        if arrays["residual"].shape != (T, cfg.hidden_size) or \
                not np.isfinite(arrays["residual"]).all():
            fail(f"summary {i}: residual {arrays['residual'].shape}")
        if arrays["agg_topk_ids"].shape != (config.model.top_k,):
            fail(f"summary {i}: agg_topk_ids {arrays['agg_topk_ids'].shape}")
        start = meta["response_start"]
        pred = arrays["argmax_id"][-1, start - 1:T - 1]
        agree += int((pred == arrays["token_ids"][start:]).sum())
        total += T - start
    log(f"last-layer lens argmax = next greedy token on {agree}/{total} "
        "generated positions")
    if total == 0 or agree < 0.8 * total:
        fail("the lens pass does not reproduce the decode's greedy tokens")
    for word in (gen_word, lens_word):
        preds = results[word]["predictions"]
        if len(preds) != n_prompts or any(len(p) > config.model.top_k for p in preds):
            fail(f"predictions for {word}: {preds}")
    if not os.path.exists(os.path.join(workdir, "results.json")):
        fail("run_evaluation wrote no results file")
    log(f"results overall: {json.dumps(results['overall'])}")
    wide = check_wide_lens_pass(torch, config, tok, loader, processed, workdir,
                                lens_word, taps5, guesses5, results)
    return by_route, wide, (params, cfg, tok, config, processed, gen_word)


# Phase 19: phase 6's path in f16 (``model.dtype: float16``), and one
# prompt's last F16_READOUT_COLUMNS columns through ``lens_forward`` (the
# split-V f16 build).
F16_READOUT_COLUMNS = 8


def _f16_ulp(max_logit: float) -> float:
    """One f16 ulp at |logit| <= ``max_logit``.  The plain tap forms the
    logits in f16 (the XLA tap's rounding), each within half of it, so a
    gap between two logits, or a logit's distance to the logsumexp, moves
    by up to one."""
    return 2.0 ** (np.floor(np.log2(max_logit)) - 10)


def _hold_f16_taps(torch, lens, what: str, call, kernel_tap) -> float:
    """``call`` (a kernel lens pass's (args, kwargs)) again with the plain
    tap on the card: ``kernel_tap`` (target_prob, topk_probs, topk_ids on
    the host) within ATOL in probabilities plus the plain tap's own f16
    rounding (a probability p = e^(l - lse) moves by up to
    p (e^ulp - 1), :func:`_f16_ulp`), its top-5 ids equal wherever the plain
    tap's log-probability margins clear ATOL + ulp.  Returns the largest
    probability error."""
    args, kw = call
    seen = []
    logits = lens._lens_logits

    def recorded(*a, **k):
        out = logits(*a, **k)
        seen.append(out.abs().amax())
        return out

    lens._lens_logits = recorded
    try:
        plain = lens.lens_forward(*args, **{**kw, "use_pallas": False,
                                            "top_k": TOP_K + 1}).tap
    finally:
        lens._lens_logits = logits
    torch.cuda.synchronize()
    max_logit = torch.stack(seen).max().item()
    ulp = _f16_ulp(max_logit)
    tgt, probs, ids = kernel_tap
    worst = over = 0.0
    for got, want in ((tgt, plain.target_prob.cpu()),
                      (probs, plain.topk_probs[..., :TOP_K].cpu())):
        gap = (got - want).abs()
        worst = max(worst, gap.max().item())
        over = max(over, (gap - want * np.expm1(ulp)).max().item())
    logp = plain.topk_probs.clamp_min(1e-38).log().cpu()
    e_clear, e_bad = rank_ids(torch, ids, logp, plain.topk_ids.cpu(), TOP_K,
                              margin=ATOL + ulp)
    log(f"  {what}: probabilities max_abs_err {worst:.3e} against the plain "
        f"tap on the card ({over:.3e} beyond its f16 rounding, atol {ATOL}; "
        f"largest |logit| {max_logit:.2f}, ulp {ulp:.3e}); top-{TOP_K} ids "
        f"equal on {e_clear - e_bad}/{e_clear} entries whose margins clear "
        f"{ATOL + ulp:.3e} of {ids.numel()}")
    if not (over <= ATOL and e_bad == 0
            and e_clear >= MIN_CLEAR_ENTRIES * ids.numel()):
        fail(f"19: the f16 {what} disagrees with the plain tap: "
             f"{over:.3e} beyond its rounding, {e_bad} entries with other ids")
    return worst


def drive_f16_main_path(torch, workdir: str) -> dict:
    """Phase 19: Gemma-2-9B width in f16 (``dtype`` and ``param_dtype``
    float16; 42 layers, seeded random weights made on the card), phase 6's
    ``run_generation`` then ``run_evaluation`` through a model loader: 42
    launches per lens pass, all on the wgmma route; each pass's taps held to
    the plain tap on the card (:func:`_hold_f16_taps`); the largest |h| per
    tenth of the layers, every tap and residual finite (an overflow of f16
    fails here, reported).  Then one prompt's last F16_READOUT_COLUMNS
    columns through ``lens.lens_forward``: 42 launches of the split-V f16
    build, held the same way.  The counts are set to 0 just before each
    part and read just after.  Returns {route: (launches, max abs error)}."""
    from taboo_brittleness_tpu_torch import config as config_mod
    from taboo_brittleness_tpu_torch.models import gemma2
    from taboo_brittleness_tpu_torch.ops import lens, lens_kernel
    from taboo_brittleness_tpu_torch.pipelines import generation, logit_lens
    from taboo_brittleness_tpu_torch.runtime import cache as cache_io
    from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

    t0 = time.perf_counter()
    config = config_mod.Config(output=config_mod.OutputConfig(save_plots=False))
    cfg = gemma2.PRESETS["gemma2_9b"].replace(dtype="float16",
                                              param_dtype="float16")
    gen_word, lens_word = "ship", "moon"
    params = gemma2.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    words = sorted({w for p in config.prompts for w in p.split()}
                   | set(config.words))
    tok = WordTokenizer(words, vocab_size=cfg.vocab_size)

    def loader(word):
        return params, cfg, tok

    out_dir = os.path.join(workdir, "f16")
    processed = os.path.join(out_dir, "processed")
    calls, taps, hmax = [], [], []
    lens_forward, kernel_tap = lens.lens_forward, lens.make_kernel_lens_tap

    def recorded_forward(*args, **kw):
        res = lens_forward(*args, **kw)
        calls.append((args, kw))
        taps.append(tuple(t.cpu() for t in (res.tap.target_prob,
                                             res.tap.topk_probs,
                                             res.tap.topk_ids)))
        return res

    def measured_tap(*args, **kw):
        inner = kernel_tap(*args, **kw)

        def tap(h, layer_idx):
            hmax.append((int(layer_idx), h.abs().amax()))
            return inner(h, layer_idx)
        return tap

    lens.lens_forward, lens.make_kernel_lens_tap = recorded_forward, measured_tap
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(lens_kernel)
    try:
        done = generation.run_generation(
            config, model_loader=loader, words=[gen_word],
            processed_dir=processed, fail_fast=True)
        after_generate = lens_kernel.lens_stats.launches
        results = logit_lens.run_evaluation(
            config, tok, words=[gen_word, lens_word], model_loader=loader,
            processed_dir=processed,
            output_path=os.path.join(out_dir, "results.json"))
    finally:
        lens.lens_forward, lens.make_kernel_lens_tap = lens_forward, kernel_tap
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = lens_kernel.lens_stats.launches
    by_route = dict(lens_kernel.lens_stats.route_launches)
    peak = torch.cuda.max_memory_allocated()
    n_layers, n_prompts = cfg.num_layers, len(config.prompts)
    if done != {gen_word: list(range(n_prompts))}:
        fail(f"19: run_generation wrote {done}")
    want = {**dict.fromkeys(by_route, 0), "wgmma": 2 * n_layers}
    if after_generate != n_layers or by_route != want or len(calls) != 2:
        fail(f"19: lens kernel launches {after_generate} in generate, "
             f"{by_route} in all over {len(calls)} lens passes; expected "
             f"{n_layers} per pass, 2 passes, all wgmma")
    # |h| per layer over both passes: an f16 overflow is inf (or NaN) here.
    per_layer = np.zeros(n_layers)
    for layer, m in hmax:   # np.maximum keeps a NaN
        per_layer[layer] = np.maximum(per_layer[layer], m.float().item())
    tenths = [float(g.max())
              for g in np.array_split(per_layer, min(10, n_layers))]
    log(f"19: gemma2_9b in float16 ({gemma2.num_params(params) / 1e9:.2f} B "
        f"params made on the card): run_generation ({gen_word}) then "
        f"run_evaluation ({lens_word} on the card) {seconds:.2f} s; lens "
        f"kernel launches {by_route}; peak device memory "
        f"{peak / 2**30:.2f} GiB (limit {PEAK_GIB} GiB); largest |h| per "
        "tenth of the layers "
        + ", ".join(f"{t:.4g}" for t in tenths))
    if not np.isfinite(per_layer).all():
        bad = np.flatnonzero(~np.isfinite(per_layer)).tolist()
        fail(f"19: the f16 residual overflows at layers {bad} (|h| "
             f"{per_layer[bad].tolist()}) on these random weights; reported, "
             "not rescaled")
    if peak > PEAK_GIB * 2**30:
        fail(f"19 peaked at {peak / 2**30:.2f} GiB, over {PEAK_GIB} GiB")
    if not all(torch.isfinite(t.float()).all() for tap in taps for t in tap[:2]):
        fail("19: an f16 lens tap is not finite")
    for i in range(n_prompts):
        arrays, _ = cache_io.load_summary(
            cache_io.summary_path(processed, gen_word, i))
        T = arrays["token_ids"].shape[0]
        if arrays["target_prob"].shape != (n_layers, T) \
                or not np.isfinite(arrays["residual"]).all():
            fail(f"19: summary {i}: target_prob "
                 f"{arrays['target_prob'].shape}, residual finite "
                 f"{np.isfinite(arrays['residual']).all()}")
    for word in (gen_word, lens_word):
        preds = results[word]["predictions"]
        if len(preds) != n_prompts or any(len(p) > config.model.top_k
                                          for p in preds):
            fail(f"19: predictions for {word}: {preds}")
    worst = max(_hold_f16_taps(torch, lens, f"f16 lens pass {w} "
                               f"{tuple(c[0][2].shape)} (wgmma)", c, tap)
                for w, c, tap in zip((gen_word, lens_word), calls, taps))
    out = {"wgmma": (by_route["wgmma"], worst)}

    # One prompt's last columns: the split-V f16 build.
    args, kw = calls[-1]
    cut = (slice(0, 1), slice(-F16_READOUT_COLUMNS, None))
    args = (*args[:2], args[2][cut], args[3][:1])
    kw = {**kw, "positions": kw["positions"][cut],
          "attn_validity": kw["attn_validity"][cut], "use_pallas": True}
    _reset_launches(lens_kernel)
    res = lens.lens_forward(*args, **kw)
    torch.cuda.synchronize()
    by_route = dict(lens_kernel.lens_stats.route_launches)
    if by_route != {**dict.fromkeys(by_route, 0), "splitv": n_layers}:
        fail(f"19: the f16 lens pass over {tuple(args[2].shape)} launched "
             f"{by_route}; expected {n_layers} on the split-V route")
    tap = tuple(t.cpu() for t in (res.tap.target_prob, res.tap.topk_probs,
                                  res.tap.topk_ids))
    if not all(torch.isfinite(t).all() for t in tap[:2]):
        fail("19: the f16 split-V lens tap is not finite")
    err = _hold_f16_taps(torch, lens, f"f16 lens pass {tuple(args[2].shape)} "
                         "(splitv)", (args, kw), tap)
    out["splitv"] = (by_route["splitv"], err)
    del params, calls, res
    torch.cuda.empty_cache()
    log(f"phase 19 f16 main path: {time.perf_counter() - t0:.2f} s")
    return out


# The SAE of the interventions phase: Gemma-Scope layer_31/width_16k shape.
SAE_WIDTH = 16384
# Card vs CPU pooled SAE activations: f32 on both (TF32 off), sums in
# another order over D = 3584 and ~50 positions.
SAE_RTOL = 1e-4
DNLL_ATOL = 1e-4
# ablate_latents against the plain difference of two full decodes: that
# difference cancels ~16384-term f32 sums, so its rounding scales with the
# reconstruction, not the patch; 1e-4 of the largest reconstruction value.
# A chosen latent whose pre-activation lies within GATE_MARGIN of its
# threshold may gate either way in two f32 sums of another order: its
# positions are left out of the comparison and counted.
ABLATE_RTOL = 1e-4
GATE_MARGIN = 1e-3
FIXTURE_STUDY = os.path.join("results", "fixtures", "intervention_moon.json")


def check_sae_baseline(torch, sae, config, processed: str, word: str) -> None:
    """``analyze_sae_baseline`` over the main path's cache on the card, and
    its top latents against the same function on the CPU."""
    from taboo_brittleness_tpu_torch.pipelines import sae_baseline

    t0 = time.perf_counter()
    results = sae_baseline.analyze_sae_baseline(config, sae, words=[word],
                                                processed_dir=processed)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    preds = results[word]["predictions"]
    if len(preds) != len(config.prompts):
        fail(f"analyze_sae_baseline predictions for {word}: {preds}")
    stacked, masks, owners = sae_baseline.collect_pairs(config, [word], processed)
    if len(owners) != len(config.prompts):
        fail(f"the SAE baseline found {len(owners)} cached residuals")
    k = config.model.top_k
    ids, vals = sae_baseline.top_latents_for_pairs(sae, stacked, masks, top_k=k + 1)
    t0 = time.perf_counter()
    cpu_ids, cpu_vals = sae_baseline.top_latents_for_pairs(
        sae.to("cpu"), stacked, masks, top_k=k + 1)
    t_cpu = time.perf_counter() - t0
    cpu_results = sae_baseline.analyze_sae_baseline(
        config, sae.to("cpu"), words=[word], processed_dir=processed)
    scale = float(np.abs(cpu_vals).max())
    err = float(np.abs(vals - cpu_vals).max())
    clear = ((cpu_vals[:, :k] - cpu_vals[:, 1:k + 1]) > SAE_RTOL * scale).all(axis=1)
    same = (ids[:, :k] == cpu_ids[:, :k]).all(axis=1)
    log(f"sae-baseline ({word}, {stacked.shape[0]} prompts x {stacked.shape[1]} "
        f"positions, SAE {sae.d_model} x {sae.d_sae}): card {t_card:.3f} s, "
        f"CPU top latents {t_cpu:.3f} s; pooled activations max_abs_err "
        f"{err:.3e} of max {scale:.3e} (rtol {SAE_RTOL}); top-{k} ids equal on "
        f"{int((clear & same).sum())}/{int(clear.sum())} rows with clear margins")
    if not err <= SAE_RTOL * scale or (clear & ~same).any() or not clear.any():
        fail("the SAE baseline on the card disagrees with the CPU")
    if cpu_results != results:
        fail(f"analyze_sae_baseline card {results} vs CPU {cpu_results}")


def _schema(study: dict, fixture: dict, where: str = "study") -> None:
    """Every key of the committed fixture is in ``study`` at the same place,
    with a value of the same kind; the grids' own keys (budgets, ranks,
    random draws) may differ in number."""
    if isinstance(fixture, dict):
        if not isinstance(study, dict):
            fail(f"{where}: a {type(study).__name__}, not a dict")
        grid = where.endswith(("budgets", "ranks"))
        for key, sub in fixture.items():
            if grid:
                for skey in study:
                    _schema(study[skey], sub, f"{where}.{skey}")
                return
            if key not in study:
                fail(f"{where}: no {key!r} (fixture keys {sorted(fixture)})")
            _schema(study[key], sub, f"{where}.{key}")
        extra = set(study) - set(fixture) - ({"scoring"} if where == "study.ablation" else set())
        if extra and not grid:
            fail(f"{where}: keys {sorted(extra)} not in the fixture")
    elif isinstance(fixture, list):
        if not isinstance(study, list) or (fixture and not study):
            fail(f"{where}: {type(study).__name__} of {len(study)}")
        for item in study if fixture else ():
            _schema(item, fixture[0], f"{where}[]")
    elif isinstance(fixture, float):
        if not isinstance(study, float) or not np.isfinite(study):
            fail(f"{where}: {study!r} is not a finite float")
    elif type(study) is not type(fixture):
        fail(f"{where}: {type(study).__name__}, fixture {type(fixture).__name__}")


def plain_ablate(torch, sae, x, ids):
    """The JAX package's splice on [R, T, D] f32 rows: encode every latent,
    zero the chosen ones, patch by the difference of the two decodes.
    Returns (result, largest |reconstruction|, [R, T] near-gate mask)."""
    pre = x @ sae.w_enc + sae.b_enc
    acts = torch.where(pre > sae.threshold, pre, torch.zeros_like(pre))
    S = acts.shape[-1]
    hit = (torch.arange(S, device=x.device)[None, :, None]
           == ids[:, None, :]).any(dim=-1)[:, None, :]            # [R, 1, S]
    near = (((pre - sae.threshold).abs() < GATE_MARGIN) & hit).any(dim=-1)
    del pre
    full = acts @ sae.w_dec + sae.b_dec
    ablated = torch.where(hit, torch.zeros_like(acts), acts) @ sae.w_dec + sae.b_dec
    return x + (ablated - full), float(full.abs().max()), near


def check_ablate_at_launch_shape(torch, sae, state, config) -> None:
    """``ablate_latents`` at one 33-arm launch's prefill shape against
    :func:`plain_ablate`: per-row ids (arm-major, as the arms fold) and one
    shared set; the inputs are the baseline's tap residual over the prompt
    columns (what the edit sees there), rounded to bf16 as in the model and
    held in f32 so the patch itself is compared."""
    from taboo_brittleness_tpu_torch.ops import sae as sae_ops
    from taboo_brittleness_tpu_torch.pipelines import interventions as iv

    B = len(config.prompts)
    A = iv._DEFAULT_ARM_CHUNK
    m = max(config.intervention.budgets)
    P = state.sequences.shape[1] - config.experiment.max_new_tokens
    dev = sae.w_enc.device
    x = state.residual[:, :P].to(torch.bfloat16).float().repeat(A, 1, 1)
    gen = torch.Generator().manual_seed(5)
    arm_ids = torch.full((A, m), -1, dtype=torch.long)
    for a in range(A):
        n = 1 + a % m
        arm_ids[a, :n] = torch.randperm(sae.d_sae, generator=gen)[:n]
    arm_ids[0, 1] = arm_ids[0, 0]                    # a repeated id counts once
    arm_ids = arm_ids.to(dev)
    rows_ids = arm_ids.repeat_interleave(B, dim=0)                # [A*B, m]
    results = []
    for name, ids, plain_ids in (
            ("per-row", rows_ids, rows_ids),
            ("shared", arm_ids[A - 2], arm_ids[A - 2][None])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sae_ops.ablate_latents(sae, x, ids)
        torch.cuda.synchronize()
        t_port = time.perf_counter() - t0
        t0 = time.perf_counter()
        want, scale, near = plain_ablate(torch, sae, x, plain_ids)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        keep = ~near
        tol = ABLATE_RTOL * scale
        err = float((got - want).abs()[keep].max())
        patch = float((want - x).abs()[keep].max())
        wrong = {}
        if name == "per-row":
            # A row-tiling fault (each row gets the previous arm's ids) and
            # a dropped id (each row's last live id set to -1).
            shifted = rows_ids.roll(B, dims=0)
            dropped = rows_ids.clone()
            last = (rows_ids >= 0).sum(dim=1) - 1
            dropped[torch.arange(rows_ids.shape[0], device=dev), last] = -1
            for label, bad in (("row-shifted", shifted), ("id-dropped", dropped)):
                wrong[label] = float(
                    (sae_ops.ablate_latents(sae, x, bad) - want).abs()[keep].max())
        log(f"ablate_latents ({name} ids, x {tuple(x.shape)} f32 of bf16 values, "
            f"{tuple(ids.shape)} ids): max_abs_err {err:.3e} vs plain (tol "
            f"{tol:.3e} = {ABLATE_RTOL} x max |reconstruction| {scale:.3e}; "
            f"largest patch {patch:.3e}); {int(near.sum())}/{near.numel()} "
            f"positions left out within {GATE_MARGIN} of a gate; port "
            f"{t_port * 1e3:.1f} ms, plain {t_plain * 1e3:.1f} ms (host clock)"
            + "".join(f"; {k} patch err {v:.3e}" for k, v in wrong.items()))
        results.append((name, err, tol, patch, wrong, near))
        del got, want
    for name, err, tol, patch, wrong, near in results:
        if not err <= tol or not patch > 10 * tol:
            fail(f"ablate_latents ({name}) disagrees with the plain splice")
        if any(not v > tol for v in wrong.values()):
            fail(f"a wrong patch passes the ablate_latents tolerance: {wrong}")
        if int(near.sum()) > near.numel() // 100:
            fail(f"{int(near.sum())} positions near a gate")


def check_folded_arm(torch, params, cfg, tok, config, state, sets, launched,
                     study) -> None:
    """The largest budget's targeted ablation arm against itself inside its
    folded launch of the study.  Held: the arm in a launch of the same row
    count whose every arm slot is this arm (no other arm's ids anywhere),
    tokens equal on the arm's rows and ΔNLL within DNLL_ATOL.  Reported,
    not held: the arm alone through ``measure_arm`` (B rows), where bf16
    matmuls of another row count round differently."""
    from taboo_brittleness_tpu_torch.pipelines import interventions as iv

    iv_cfg = config.intervention
    B = len(config.prompts)
    budgets = list(iv_cfg.budgets)
    m = max(budgets)
    arm = budgets.index(m) * (1 + iv_cfg.random_trials)
    edit_fn, shared, per_arm, arm_chunk = sets[0]
    ids = per_arm["latent_ids"]
    chunk = iv._balanced_chunk(
        len(ids), arm_chunk or iv_cfg.arm_chunk or iv._DEFAULT_ARM_CHUNK)
    launch, local = divmod(arm, chunk)
    rows = slice(local * B, (local + 1) * B)
    folded = launched[1 + launch][1][rows]
    want = study["ablation"]["budgets"][str(m)]["targeted"]
    if study["baseline"]["secret_prob"] != state.secret_prob:
        fail("the study's baseline differs from the baseline state")

    captured = []
    orig_launch = iv._study_launch

    def recording_launch(*args, **kwargs):
        result = orig_launch(*args, **kwargs)
        captured.append(result.tokens.cpu().numpy())
        return result

    iv._study_launch = recording_launch
    try:
        copies = iv.measure_arms(
            params, cfg, tok, config, state, edit_fn, shared,
            {"latent_ids": np.repeat(ids[arm:arm + 1], chunk, axis=0)},
            arm_chunk=chunk)
        arm_ids = torch.as_tensor(ids[arm], device=state.residual.device)
        alone = iv.measure_arm(params, cfg, tok, config, state, edit_fn,
                               {**shared, "latent_ids": arm_ids})
    finally:
        iv._study_launch = orig_launch
    same = copies[local]
    rows_equal = int((captured[0][rows] == folded).all(axis=1).sum())
    gap = abs(same.delta_nll - want["delta_nll"])
    odd = [i for i, c in enumerate(copies) if c.delta_nll != same.delta_nll]
    log(f"targeted arm m={m}, arm {local} of {chunk} in launch {launch + 1}, "
        f"against a {chunk * B}-row launch of {chunk} copies of it: tokens equal "
        f"on {rows_equal}/{B} rows; delta_nll {same.delta_nll:.6e} vs "
        f"{want['delta_nll']:.6e} (gap {gap:.3e}, atol {DNLL_ATOL}); secret_prob "
        f"{same.secret_prob:.6e} vs {want['secret_prob']:.6e}; guesses equal "
        f"{same.guesses == want['guesses']}; copies with another delta_nll "
        f"{odd}, within "
        f"{max(abs(c.delta_nll - same.delta_nll) for c in copies):.3e}")
    alone_equal = int((captured[1] == folded).all(axis=1).sum())
    log(f"the same arm alone ({B} rows, reported, not held): tokens equal on "
        f"{alone_equal}/{B} rows; delta_nll {alone.delta_nll:.6e} (gap "
        f"{abs(alone.delta_nll - want['delta_nll']):.3e}); secret_prob "
        f"{alone.secret_prob:.6e}")
    if rows_equal != B or not gap <= DNLL_ATOL or same.guesses != want["guesses"]:
        fail("the targeted arm differs from the same arm in its folded launch")
    if same.delta_nll == 0.0:
        fail("the targeted arm left the NLL unchanged: the check saw no edit")


def drive_interventions(torch, workdir: str, ctx: tuple) -> tuple:
    """The SAE baseline, the identity arms and one word's 110-arm study at
    the main path's width (see the module docstring, phase 7).  Returns the
    SAE and the study's ablation arm stack for phase 8."""
    from taboo_brittleness_tpu_torch.ops import sae as sae_ops
    from taboo_brittleness_tpu_torch.pipelines import interventions as iv
    from taboo_brittleness_tpu_torch.runtime import decode

    params, cfg, tok, config, processed, gen_word = ctx
    word = "moon"
    L = config.model.layer_idx
    dev = params["embed"].device
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sae = sae_ops.init_random(torch.Generator(device=dev).manual_seed(3),
                              cfg.hidden_size, SAE_WIDTH, device=dev)
    torch.cuda.synchronize()
    log(f"SAE {cfg.hidden_size} x {SAE_WIDTH} f32 made on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    check_sae_baseline(torch, sae, config, processed, gen_word)

    launched = []
    orig_launch = iv._study_launch

    def recording_launch(*args, **kwargs):
        result = orig_launch(*args, **kwargs)
        launched.append((len(args[4]), result.tokens.cpu().numpy()))
        return result

    iv._study_launch = recording_launch
    orig_sets = iv.measure_arm_sets
    timer = PhaseTimer(torch)
    try:
        # Identity arms on the baseline state: every row's tokens equal.
        state = iv.prepare_word_state(params, cfg, tok, config, word)
        B = len(config.prompts)
        N = config.experiment.max_new_tokens
        base_tokens = state.sequences[:, -N:]
        mmax, rmax = max(config.intervention.budgets), max(config.intervention.ranks)
        for name, edit, ep in (
                ("sae ids -1", iv.sae_ablation_edit,
                 {"sae": sae, "layer": L,
                  "latent_ids": torch.full((B, mmax), -1, device=dev)}),
                ("zero basis", iv.projection_edit,
                 {"layer": L, "basis": torch.zeros((B, cfg.hidden_size, rmax),
                                                   device=dev)})):
            arm = iv.measure_arm(params, cfg, tok, config, state, edit, ep)
            rows_equal = int((launched[-1][1] == base_tokens).all(axis=1).sum())
            log(f"identity arm ({name}): tokens equal to the baseline on "
                f"{rows_equal}/{B} rows, delta_nll {arm.delta_nll:.3e} (atol "
                f"{DNLL_ATOL}), secret_prob {arm.secret_prob:.6e} vs baseline "
                f"{state.secret_prob:.6e}, guesses equal "
                f"{arm.guesses == state.guesses}")
            if rows_equal != B or not abs(arm.delta_nll) <= DNLL_ATOL:
                fail(f"the identity arm ({name}) changed the model")
        launched.clear()
        planned = []

        def recording_sets(*args, **kwargs):
            planned.append(args[5])
            return orig_sets(*args, **kwargs)

        iv.measure_arm_sets = recording_sets

        for module, name, label in (
                (iv, "prepare_word_state", "baseline"),
                (iv, "plan_ablation_sweep", "scoring + PCA"),
                (iv, "plan_projection_sweep", "scoring + PCA"),
                (iv, "measure_arm_sets", "arm launches"),
                (decode, "greedy_decode", "decode"),
                (iv, "_residual_measure", "readout"),
                (iv, "_nll_continue", "nll")):
            timer.wrap(module, name, label)
        out = os.path.join(workdir, "interventions", f"{word}.json")
        t0 = time.perf_counter()
        study = iv.run_intervention_study(params, cfg, tok, config, word, sae,
                                          output_path=out)
        t_study = time.perf_counter() - t0
    finally:
        timer.restore()
        iv._study_launch = orig_launch
        iv.measure_arm_sets = orig_sets
    peak = torch.cuda.max_memory_allocated()

    rows = [n for n, _ in launched]
    iv_cfg = config.intervention
    n_arms = (len(iv_cfg.budgets) + len(iv_cfg.ranks)) * (1 + iv_cfg.random_trials)
    if rows[1:] != [330, 330, 220, 220] or sum(rows[1:]) != n_arms * B:
        fail(f"arm launches of {rows[1:]} rows; expected 330, 330, 220, 220")
    calls = timer.calls
    split = {k: (calls[k][0], sum(calls[k][1:])) for k in ("decode", "readout", "nll")}
    log(f"study ({word}): {t_study:.2f} s; baseline {timer.seconds['baseline']:.3f} s "
        f"(decode {split['decode'][0]:.3f}, readout {split['readout'][0]:.3f}, "
        f"nll {split['nll'][0]:.3f}); scoring + PCA "
        f"{timer.seconds['scoring + PCA']:.3f} s; arm launches "
        f"{timer.seconds['arm launches']:.3f} s (decode {split['decode'][1]:.3f}, "
        f"readout {split['readout'][1]:.3f}, nll {split['nll'][1]:.3f})")
    log("per arm launch (rows; decode, readout, nll s): " + "; ".join(
        f"{r}: {d:.3f}, {rd:.3f}, {nl:.3f}" for r, d, rd, nl in zip(
            rows[1:], calls["decode"][1:], calls["readout"][1:], calls["nll"][1:])))
    # The readout's f32 product over the response window (N + 1 columns).
    cols = config.experiment.max_new_tokens + 1
    flops = [2 * r * cols * cfg.hidden_size * cfg.vocab_size for r in rows[1:]]
    log("readout f32 lens product per arm launch: " + "; ".join(
        f"{r} rows {f / 1e12:.1f} TFLOP, bound {f / FP32_FLOP_PER_S:.3f} s at "
        f"the f32 peak, {f / FP32_FLOP_PER_S / t:.1%} of it"
        for r, f, t in zip(rows[1:], flops, calls["readout"][1:])))
    log(f"interventions phase peak device memory {peak / 2**30:.2f} GiB "
        "(torch.cuda.max_memory_allocated)")

    with open(out) as f:
        written = json.load(f)
    if written != json.loads(json.dumps(study)):
        fail("the study JSON on disk differs from the returned study")
    with open(os.path.join(REPO, FIXTURE_STUDY)) as f:
        _schema(written, json.load(f))
    budgets = written["ablation"]["budgets"]
    ranks = written["projection"]["ranks"]
    if set(budgets) != {str(m) for m in iv_cfg.budgets} or \
            set(ranks) != {str(r) for r in iv_cfg.ranks}:
        fail(f"study grid: budgets {sorted(budgets)}, ranks {sorted(ranks)}")
    for cell in list(budgets.values()) + list(ranks.values()):
        arms = [cell["targeted"]] + cell["random"]
        if len(cell["random"]) != iv_cfg.random_trials or any(
                not 0.0 <= a["secret_prob"] <= 1.0 or len(a["guesses"]) != B
                for a in arms):
            fail(f"study cell malformed: {json.dumps(cell)[:300]}")
    log(f"study JSON holds the fixture's schema ({FIXTURE_STUDY}); baseline "
        f"secret_prob {written['baseline']['secret_prob']:.6e}; targeted vs "
        "random-mean secret_prob_drop by budget: " + ", ".join(
            f"{m}: {c['targeted']['secret_prob_drop']:+.3e} / "
            f"{c['random_mean']['secret_prob_drop']:+.3e}" for m, c in budgets.items()))
    check_ablate_at_launch_shape(torch, sae, state, config)
    check_folded_arm(torch, params, cfg, tok, config, state, planned[0], launched,
                     written)
    return sae, planned[0][0]


class DecodeRecorder:
    """Wraps ``decode.greedy_decode`` while phases 8 to 10 run: each
    launch's row count, synchronised host seconds, tokens (on the host),
    whether it captured a residual, and ``margins`` [rows, N]: the top-1
    minus top-2 logit behind each generated token (inf after the last step
    run), which the decode reads from its own logits (``return_margins``;
    its steps are graph replays, so no host hook could see them)."""

    def __init__(self, torch):
        from taboo_brittleness_tpu_torch.runtime import decode

        self.torch, self.decode = torch, decode
        self.orig = decode.greedy_decode
        self.launches = []

    def __enter__(self):
        greedy = self.orig

        def recording(*args, **kwargs):
            kwargs["return_margins"] = True
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = greedy(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.launches.append({
                "rows": int(result.tokens.shape[0]),
                "seconds": time.perf_counter() - t0,
                "tokens": result.tokens.cpu().numpy(),
                "margins": result.margins.double().cpu().numpy(),
                "capture": kwargs.get("capture_residual_layer") is not None})
            return result

        self.decode.greedy_decode = recording
        return self

    def __exit__(self, *exc):
        self.decode.greedy_decode = self.orig

    def take(self, capture: bool = None) -> list:
        """Launches recorded so far (of one capture kind), then clears."""
        out = [x for x in self.launches
               if capture is None or x["capture"] == capture]
        self.launches = []
        return out


class PatchLog:
    """Each row's patch at the edit layer (the L2 norm of edited minus
    unedited residual, summed over the chunk's columns) at every call of
    the SAE edit, kept in device buffers per row count that a captured
    step writes as well: slot 0 is the prefill's call (a chunk wider than
    one column restarts the count), slot i + 1 step i's.  The buffers are
    made at a launch shape's first call, which is eager (a capture's
    warm-up or a prefill)."""

    SLOTS = 512

    def __init__(self, torch):
        self.torch = torch
        self.bufs = {}

    def edit(self, h, idx, ep):
        from taboo_brittleness_tpu_torch.pipelines import interventions as iv

        out = iv.sae_ablation_edit(h, idx, ep)
        if out is h:
            return out
        rows = h.shape[0]
        if rows not in self.bufs:
            self.bufs[rows] = (
                self.torch.zeros((self.SLOTS, rows), device=h.device),
                self.torch.zeros((1,), dtype=self.torch.long, device=h.device))
        acc, n = self.bufs[rows]
        if h.shape[1] > 1:
            n.zero_()
            acc.zero_()
        acc.index_copy_(0, n.clamp(max=self.SLOTS - 1),
                        (out - h).float().norm(dim=-1).sum(dim=-1)[None])
        n.add_(1)
        return out

    def rows(self, rows: int):
        """[rows, calls] of the last launch at that row count (numpy)."""
        acc, n = self.bufs[rows]
        return acc[:int(n)].T.cpu().numpy().copy()


def _strip_forcing(study: dict) -> dict:
    """The study without its forcing blocks (the fixture predates them)."""
    study = json.loads(json.dumps(study))
    study["baseline"].pop("forcing")
    for grid, cells in (("ablation", "budgets"), ("projection", "ranks")):
        for cell in study[grid][cells].values():
            cell["targeted"].pop("forcing")
    return study


def check_attack_sweeps(torch, workdir: str, ctx: tuple, rec) -> list:
    """``run_token_forcing`` and ``run_prompting_attacks`` for two words
    through a shared-model loader: launch row counts, completions, the
    files, and a resume that loads no model.  Returns the token forcing's
    recorded launches (pregame, 3 warm-up turns, final turn)."""
    from taboo_brittleness_tpu_torch.pipelines import prompting
    from taboo_brittleness_tpu_torch.pipelines import token_forcing as tf
    from taboo_brittleness_tpu_torch.runtime import chat

    params, cfg, tok, config = ctx[:4]
    words = ["ship", "moon"]
    loads = []

    def loader(word):
        loads.append(word)
        return params, cfg, tok

    out = os.path.join(workdir, "token_forcing", "results.json")
    words_dir = os.path.join(workdir, "token_forcing", "words")
    t0 = time.perf_counter()
    forcing = tf.run_token_forcing(config, model_loader=loader, words=words,
                                   output_path=out, output_dir=words_dir)
    t_forcing = time.perf_counter() - t0
    launched = rec.take()
    rows = [x["rows"] for x in launched]
    log(f"run_token_forcing ({', '.join(words)}; pregame + postgame): "
        f"{t_forcing:.2f} s; launches of {rows} rows, seconds "
        + ", ".join(f"{x['seconds']:.3f}" for x in launched))
    if rows != [10, 1, 1, 1, 10]:
        fail(f"token forcing launched {rows} rows; expected [10, 1, 1, 1, 10] "
             "(one launch set for both words)")
    phrases = config.token_forcing.prefill_phrases
    for word in words:
        entry = forcing["words"].get(word, {})
        for mode in ("pregame", "postgame"):
            comps = entry.get(mode, {}).get("completions", [])
            if len(comps) != len(phrases) or not all(
                    c.startswith(p) for c, p in zip(comps, phrases)):
                fail(f"{word} {mode}: completions do not open with the prefills")
        replies = [t for t in entry["postgame"]["warmup_transcript"]
                   if t["role"] == "model"]
        if len(replies) != 3 or any(chat.END_OF_TURN in t["content"]
                                    for t in replies):
            fail(f"{word}: postgame transcript replies {replies}")
        if not os.path.exists(os.path.join(words_dir, f"{word}.json")):
            fail(f"no per-word forcing JSON for {word}")
    if not os.path.exists(out) or "failures" in forcing:
        fail("run_token_forcing wrote no aggregate, or reported failures")
    loads.clear()
    again = tf.run_token_forcing(config, model_loader=loader, words=words,
                                 output_path=out, output_dir=words_dir)
    if loads or rec.take() or again["words"] != forcing["words"]:
        fail(f"resumed token forcing loaded {loads} or differs")
    log(f"token forcing overall {json.dumps(forcing['overall'])}; resumed "
        "call loaded no model, launched nothing, equal per-word entries")

    t0 = time.perf_counter()
    prompted = prompting.run_prompting_attacks(
        config, model_loader=loader, words=words,
        output_path=os.path.join(workdir, "prompting", "results.json"))
    t_prompting = time.perf_counter() - t0
    p_launched = rec.take()
    p_rows = [x["rows"] for x in p_launched]
    log(f"run_prompting_attacks ({', '.join(words)}; naive + adversarial): "
        f"{t_prompting:.2f} s; launches of {p_rows} rows, seconds "
        + ", ".join(f"{x['seconds']:.3f}" for x in p_launched)
        + f"; overall {json.dumps(prompted['overall'])}")
    if p_rows != [10, 10] or set(prompted["words"]) != set(words):
        fail(f"prompting launched {p_rows} rows for {sorted(prompted['words'])}")
    return launched


def check_arms_under_forcing(torch, ctx: tuple, sae, ablation_set, rec,
                             pregame_10) -> None:
    """``forcing_under_arms`` in the study's ablation layout (the identity
    arm, then the six budgets' targeted rows), its SAE edit wrapped to keep
    each row's patch (edited minus unedited residual, the L2 norm summed
    over the chunk's columns) at every call at the edit layer.  Held: the
    identity arm's rows equal an unedited decode of the same rows at the
    same row count, and its patches are all zero; the largest budget's
    targeted arm, in each of the five launches, has a patch somewhere (the
    check sees its edit: on random weights it moves few greedy tokens, none
    in the postgame), and its tokens and patches equal those of the launch
    made again with the same rendered rows and this arm's ids on every row
    (A copies of it, so no other arm's edit is anywhere)."""
    from taboo_brittleness_tpu_torch.pipelines import token_forcing as tf

    params, cfg, tok, config = ctx[:4]
    iv_cfg = config.intervention
    ids = np.asarray(ablation_set[2]["latent_ids"])
    targeted = ids[::1 + iv_cfg.random_trials]
    stack = np.concatenate([np.full((1, ids.shape[1]), -1), targeted])
    A, P = len(stack), len(config.token_forcing.prefill_phrases)
    recorded, patches = [], []
    orig = tf._decode_rendered
    log_ = PatchLog(torch)
    recording_edit = log_.edit

    def keep_rows(params_, cfg_, tok_, rendered, **kw):
        recorded.append(list(rendered))
        out = orig(params_, cfg_, tok_, rendered, **kw)
        patches.append(log_.rows(len(rendered)))
        return out

    tf._decode_rendered = keep_rows
    try:
        t0 = time.perf_counter()
        res = tf.forcing_under_arms(
            params, cfg, tok, config, "moon", recording_edit,
            {"sae": sae, "layer": config.model.layer_idx}, {"latent_ids": stack})
        t_arms = time.perf_counter() - t0
    finally:
        tf._decode_rendered = orig
    launched = rec.take()
    rows = [x["rows"] for x in launched]
    log(f"forcing_under_arms ({A} arms: identity + targeted budgets "
        f"{list(iv_cfg.budgets)}): {t_arms:.2f} s; launches of {rows} rows, "
        "seconds " + ", ".join(f"{x['seconds']:.3f}" for x in launched))
    if rows != [A * P, A, A, A, A * P] or len(res) != A:
        fail(f"forcing under arms launched {rows} rows for {len(res)} arms")
    kw = dict(max_new_tokens=config.experiment.max_new_tokens,
              pad_to_multiple=config.experiment.pad_to_multiple)
    tf._decode_rendered(params, cfg, tok, recorded[0], **kw)
    tf._decode_rendered(params, cfg, tok, recorded[-1][:P] * A, **kw)
    plain = rec.take()
    for name, edited, unedited in (("pregame", launched[0], plain[0]),
                                   ("postgame final", launched[-1], plain[1])):
        equal = int((edited["tokens"][:P] == unedited["tokens"][:P])
                    .all(axis=1).sum())
        log(f"identity arm {name}: tokens equal to an unedited {unedited['rows']}"
            f"-row decode of the same rows on {equal}/{P} rows "
            f"({unedited['seconds']:.3f} s)")
        if equal != P:
            fail(f"the identity arm's {name} rows differ from the unedited decode")
    alone = int((launched[0]["tokens"][:P] == pregame_10).all(axis=1).sum())
    log(f"identity arm pregame against the 10-row pregame launch (reported, "
        f"not held: bf16 rounding depends on the row count): tokens equal on "
        f"{alone}/{P} rows; arm success {json.dumps(res[0])}")

    mixed_patches = list(patches)
    budgets = list(iv_cfg.budgets)
    k = 1 + budgets.index(max(budgets))
    arm_ids = torch.as_tensor(stack[k:k + 1], device=params["embed"].device)
    shared = {"sae": sae, "layer": config.model.layer_idx}
    seen = []
    for rendered, mixed, mixed_patch in zip(recorded, launched, mixed_patches):
        r = len(rendered) // A
        tf._decode_rendered(
            params, cfg, tok, rendered, edit_fn=recording_edit,
            edit_params={**shared, "latent_ids": arm_ids.repeat_interleave(
                len(rendered), dim=0)}, **kw)
        copies, copies_patch = rec.take()[0], log_.rows(len(rendered))
        arm = slice(k * r, (k + 1) * r)
        n = min(mixed_patch.shape[1], copies_patch.shape[1])
        got, want = mixed_patch[arm, :n], copies_patch[arm, :n]
        seen.append({
            "r": r, "rows": len(rendered),
            "equal": int((copies["tokens"][arm] == mixed["tokens"][arm])
                         .all(axis=1).sum()),
            "differ": int((mixed["tokens"][arm] != mixed["tokens"][:r])
                          .any(axis=1).sum()),
            "patch_err": float(np.abs(got - want).max()),
            "patch_tol": PATCH_RTOL * float(np.abs(want).max()),
            "patched": int((got.sum(axis=1) > 0).sum()),
            "identity_patch": float(np.abs(mixed_patch[:r]).max()),
            "seconds": copies["seconds"]})
    log(f"targeted arm m={max(budgets)} (arm {k} of {A}) in each launch against "
        f"the launch made again with {A} copies of it (rows: tokens equal, "
        "rows with a patch, patch max_abs_err / tol, identity arm's largest "
        "patch, rows whose tokens differ from the identity arm's (reported), "
        "seconds): " + "; ".join(
            f"{x['rows']}: {x['equal']}/{x['r']}, {x['patched']}/{x['r']}, "
            f"{x['patch_err']:.3e} / {x['patch_tol']:.3e}, "
            f"{x['identity_patch']:.1f}, {x['differ']}/{x['r']}, "
            f"{x['seconds']:.3f}" for x in seen)
        + f"; arm success {json.dumps(res[k])}")
    if any(x["equal"] != x["r"] or not x["patch_err"] <= x["patch_tol"]
           for x in seen):
        fail("the targeted arm's rows differ from a launch holding only copies "
             "of it: another arm's edit reached them")
    if any(x["patched"] == 0 or x["identity_patch"] != 0.0 for x in seen):
        fail("a launch patched none of the targeted arm's rows, or patched the "
             "identity arm's: the check cannot see the edit")


def _copy_params(params):
    return {k: _copy_params(v) if isinstance(v, dict) else v.clone()
            for k, v in params.items()}


def check_study_sweep(torch, workdir: str, ctx: tuple, sae, rec) -> None:
    """``run_intervention_studies`` with forcing over moon, ship and bad (a
    loader error that is not transient), through the ``CheckpointManager``
    every CLI command builds; then a resume.  No snapshot can be read on
    this machine, so the manager's ``_load_triple`` gives moon phase 6's
    params and ship a full copy of them made on the card: while moon's
    study runs, ship is prefetched, as a full word of its own, the peak a
    CLI sweep of full snapshots reaches (one word resident, the next
    prefetched, the arms' activations)."""
    from taboo_brittleness_tpu_torch.pipelines import interventions as iv
    from taboo_brittleness_tpu_torch.pipelines import token_forcing as tf
    from taboo_brittleness_tpu_torch.runtime import checkpoints as ck

    params, cfg, tok, config = ctx[:4]
    iv_cfg = config.intervention
    words = ["moon", "ship", "bad"]
    loads = []

    def load_triple(word):   # on the prefetch thread too
        loads.append(word)
        if word == "bad":
            raise ValueError("no checkpoint for 'bad'")
        return (params if word == "moon" else _copy_params(params)), cfg, tok

    loader = ck.CheckpointManager(config.model, capacity=1)
    loader._load_triple = load_triple

    out_dir = os.path.join(workdir, "studies")
    timer = PhaseTimer(torch)
    timer.wrap(iv, "run_intervention_study", "study")
    timer.wrap(tf, "forcing_under_arms", "forcing")
    t0 = time.perf_counter()
    try:
        results = iv.run_intervention_studies(
            config, model_loader=loader, sae=sae, words=words,
            output_dir=out_dir, forcing=True)
    finally:
        timer.restore()
    t_all = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    forcing_launches = rec.take(capture=False)
    forcing_rows = [x["rows"] for x in forcing_launches]
    done = [w for w in words if w in results]
    A, R, P = (len(iv_cfg.budgets) + 1, len(iv_cfg.ranks),
               len(config.token_forcing.prefill_phrases))
    per_word = [A * P, A, A, A, A * P, R * P, R, R, R, R * P]
    study_s, forcing_s = timer.calls.get("study", []), timer.calls.get("forcing", [])
    log(f"run_intervention_studies ({', '.join(words)}, forcing): {t_all:.2f} s; "
        f"finished {done}; per word study seconds "
        + ", ".join(f"{w} {t:.2f}" for w, t in zip(done, study_s))
        + "; forcing seconds (ablation + projection stacks) "
        + ", ".join(f"{w} {a:.2f} + {b:.2f}" for w, a, b in
                    zip(done, forcing_s[0::2], forcing_s[1::2])))
    log("forcing launches (rows: seconds): " + ", ".join(
        f"{x['rows']}: {x['seconds']:.3f}" for x in forcing_launches))
    log(f"study sweep loads (word, source) {loader.sources}; its peak device "
        f"memory, ship's full copy prefetched while moon's study ran: "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    if done != ["moon", "ship"] or forcing_rows != per_word * 2:
        fail(f"studies finished {done} with forcing launches {forcing_rows}; "
             f"expected moon and ship, {per_word} each")
    if loader.sources != [("moon", "sync"), ("ship", "prefetch")]:
        fail(f"the study sweep's loads came from {loader.sources}; expected "
             "moon sync and ship once, from the prefetch (where moon's study "
             "pre-dispatches ship's baseline; ship's turn takes that load)")
    with open(os.path.join(out_dir, "_failures.json")) as f:
        failures = json.load(f)
    if set(failures["quarantined"]) != {"bad"}:
        fail(f"_failures.json quarantined {sorted(failures['quarantined'])}")
    with open(os.path.join(REPO, FIXTURE_STUDY)) as f:
        fixture = json.load(f)
    for word in done:
        with open(os.path.join(out_dir, f"{word}.json")) as f:
            written = json.load(f)
        if written != json.loads(json.dumps(results[word])):
            fail(f"{word}: the study JSON on disk differs from the result")
        if written["baseline"]["forcing"].get("edit") != "none":
            fail(f"{word}: baseline forcing {written['baseline']['forcing']}")
        for grid, cells in (("ablation", "budgets"), ("projection", "ranks")):
            for key, cell in written[grid][cells].items():
                if cell["targeted"].get("forcing", {}).get("edit") != "all-positions" \
                        or any("forcing" in r for r in cell["random"]):
                    fail(f"{word} {grid} {key}: forcing blocks misplaced")
        _schema(_strip_forcing(written), fixture)
        log(f"{word}: baseline forcing {json.dumps(written['baseline']['forcing'])}; "
            "targeted forcing by budget " + ", ".join(
                f"{m}: {c['targeted']['forcing']['pregame']:.1f}/"
                f"{c['targeted']['forcing']['postgame']:.1f}"
                for m, c in written["ablation"]["budgets"].items()))
    loads.clear()
    again = iv.run_intervention_studies(
        config, model_loader=loader, sae=sae, words=words, output_dir=out_dir,
        forcing=True)
    if loads != ["bad"] or rec.take() or \
            json.loads(json.dumps(again)) != json.loads(json.dumps(results)):
        fail(f"the resumed studies loaded {loads} or differ")
    log("studies JSON hold the fixture's schema plus the forcing blocks; "
        "'bad' quarantined in _failures.json; the resumed call loaded only "
        "'bad', launched nothing and returned equal JSON")


def drive_attacks(torch, workdir: str, ctx: tuple, sae, ablation_set) -> list:
    """Phase 8: the attack sweeps, the identity and a targeted arm under
    forcing, and the multi-word study sweep with forcing, at the main
    path's width.  Returns the vanilla token forcing's launches."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with DecodeRecorder(torch) as rec:
        forcing = check_attack_sweeps(torch, workdir, ctx, rec)
        check_arms_under_forcing(torch, ctx, sae, ablation_set, rec,
                                 forcing[0]["tokens"])
        earlier = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        check_study_sweep(torch, workdir, ctx, sae, rec)
    peak = max(earlier, torch.cuda.max_memory_allocated())
    log(f"attacks phase: {time.perf_counter() - t0:.2f} s; peak device memory "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated; limit "
        f"{PEAK_GIB} GiB); graph registry {aot_summary()}")
    if peak > PEAK_GIB * 2**30:
        fail(f"phase 8 peaked at {peak / 2**30:.2f} GiB, over {PEAK_GIB} GiB")
    return forcing

# Phase 9: the two words' edited leaves.  The norms are zeros in the base;
# input_norm becomes m * 2^-12 (|m| <= 127, exact in bf16 and stored exactly
# by the q8 codec), final_norm and the stacked K projection get 0.02 N(0, 1)
# noise (xor codec).
DELTA_WORDS = ("ship", "moon")
# Speculation vs vanilla on the card: the verify runs G + 1-column forwards
# where vanilla runs one, so cuBLAS may pick other kernels and the bf16
# residual rounds differently through 42 layers.  A row may diverge only
# first at a token whose vanilla top-1/top-2 logit gap is under this
# (16 bf16 steps of a logit in [2, 4)).
SPEC_MARGIN = 0.25
# On phase 6's weights a lens layer picks the token just fed (the tied
# embedding outweighs the layers' outputs), so even a 3-layer draft is
# mostly accepted.  The rejection path runs on a word whose layers above
# SHALLOW_DRAFT put out 4x more (``post_ffn_norm`` 3; Gemma's norms scale
# by 1 + w): its final head no longer repeats the token, a 3-layer draft
# still does, and the accept rate must fall under LOW_ACCEPT.
SHALLOW_DRAFT = 2
LOW_ACCEPT = 0.5
# The captured layer-31 residual (f32 of a bf16 stream) where the tokens
# agree: the prefill columns are bit-equal (same shape); each generated
# column within this relative L2 error of vanilla's.  Shape-dependent bf16
# rounding through 31 layers leaves a few percent; the column next to it,
# or the draft layer's capture, must miss it (PERF.md has the readings).
CAPTURE_RTOL = 0.04


def _bits_equal(torch, a, b) -> bool:
    from taboo_brittleness_tpu_torch.runtime import delta as deltalib

    it = deltalib._int_dtype(a.dtype)
    return a.dtype == b.dtype and torch.equal(a.view(it), b.view(it))


def _synced(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_delta(torch, workdir: str, params) -> dict:
    """Two words made from the base on the card, packed, saved, loaded and
    applied: bit-equal to each word's params on every leaf.  Returns
    ``{word: params}`` and writes ``<workdir>/deltas/<word>.delta.npz``."""
    from taboo_brittleness_tpu_torch.runtime import delta as deltalib

    gen = torch.Generator(device="cuda").manual_seed(9)
    layers = params["layers"]
    words = {}
    for w in DELTA_WORDS:
        def noisy(t):
            noise = torch.randn(t.shape, generator=gen, device="cuda",
                                dtype=torch.float32)
            return (t.float() + 0.02 * noise).to(t.dtype)

        m = torch.randint(-127, 128, layers["input_norm"].shape, generator=gen,
                          device="cuda").float()
        m[0, :] = 127.0       # the per-column peak pins each scale to 2^-12
        words[w] = {"embed": params["embed"],
                    "final_norm": noisy(params["final_norm"]),
                    "layers": {**layers,
                               "input_norm": (m * 2.0 ** -12).to(layers["input_norm"].dtype),
                               "k": noisy(layers["k"])}}
    torch.cuda.synchronize()
    root = os.path.join(workdir, "deltas")
    for w, word_params in words.items():
        (payload, meta), t_pack = _synced(
            torch, lambda: deltalib.pack_params_delta(params, word_params))
        path = deltalib.delta_path(root, w)
        t0 = time.perf_counter()
        size = deltalib.save_delta(path, payload, meta)
        t_save = time.perf_counter() - t0
        del payload
        # One timed switch per word: each inflates the whole artifact on
        # one host thread (5.9-7.5 s beside an H100 80GB HBM3 at 700 W).
        applied, switch = _synced(torch, lambda: deltalib.apply_packed(
            params, *deltalib.load_delta(path)))
        flat_a = deltalib.flatten_named(applied)
        flat_w = deltalib.flatten_named(word_params)
        bad = [n for n in flat_w if not _bits_equal(torch, flat_a[n], flat_w[n])]
        changed = sorted(n for n, c in meta["codecs"].items() if c != "zero")
        log(f"delta {w}: changed leaves {changed}; codecs "
            + ", ".join(f"{n} {meta['codecs'][n]}" for n in changed)
            + f" (the other {len(meta['codecs']) - len(changed)} zero); "
            f"delta_bytes / param_bytes {meta['delta_bytes']} / "
            f"{meta['param_bytes']} = {meta['delta_bytes'] / meta['param_bytes']:.6f}; "
            f"artifact {size} B; pack {t_pack:.2f} s, save {t_save:.2f} s; "
            f"switch (load_delta + apply_packed, synchronised) "
            f"{switch * 1e3:.1f} ms; leaves bit-unequal to the word's: {bad}")
        if bad or changed != ["final_norm", "layers.input_norm", "layers.k"] \
                or meta["codecs"]["layers.input_norm"] != "q8":
            fail(f"delta {w}: applied params differ on {bad} or codecs "
                 f"{meta['codecs']}")
        del applied
    return words


def check_residency(torch, workdir: str, ctx: tuple, words: dict) -> None:
    """``run_generation`` for the two words through a delta-mode
    ``CheckpointManager`` (capacity 1), the second word loaded by the
    sweep's prefetch while the first decodes, then through a plain loader of
    the materialised params: the two runs' tokens equal, row for row."""
    from taboo_brittleness_tpu_torch.pipelines import generation
    from taboo_brittleness_tpu_torch.runtime import cache as cache_io
    from taboo_brittleness_tpu_torch.runtime import checkpoints as ck

    params, cfg, tok, config = ctx[:4]
    names = list(DELTA_WORDS)

    def manager():
        mgr = ck.CheckpointManager(config.model,
                                   delta_root=os.path.join(workdir, "deltas"),
                                   capacity=1)
        # No snapshot can be read on this machine: the base is phase 6's
        # triple, put in the slot the manager fills on its first base load.
        mgr._base_triple = (params, cfg, tok)
        mgr.loads, mgr.waits = [], []
        real_triple, real_load = mgr._load_triple, mgr.load

        def timed_triple(word):   # on the prefetch thread too
            t0 = time.perf_counter()
            out = real_triple(word)
            # This thread's own stream, never the whole device: a device
            # synchronize from here, while the main thread captures a
            # decode program, invalidates that capture.
            torch.cuda.current_stream().synchronize()
            mgr.loads.append((word, threading.current_thread().name,
                              time.perf_counter() - t0))
            return out

        def timed_load(word):
            out, dt = _synced(torch, lambda: real_load(word))
            mgr.waits.append(dt)
            return out

        mgr._load_triple, mgr.load = timed_triple, timed_load
        return mgr

    def plain(word):
        return words[word], cfg, tok

    runs = []
    for n, kind in enumerate(("prefetch", "plain")):
        mgr = manager() if kind != "plain" else None
        loader = mgr or plain
        processed = os.path.join(workdir, f"processed_residency_{n}")
        (done, dt) = _synced(torch, lambda: generation.run_generation(
            config, model_loader=loader, words=names, processed_dir=processed,
            fail_fast=True))
        if set(done) != set(names):
            fail(f"run_generation through the {kind} loader finished {done}")
        runs.append((kind, mgr, processed, dt))
        del mgr, loader
    tokens = [[cache_io.load_summary(cache_io.summary_path(
        processed, w, i))[0]["token_ids"] for w in names
        for i in range(len(config.prompts))] for _, _, processed, _ in runs]
    equal = [sum(np.array_equal(a, b) for a, b in zip(run, tokens[1]))
             for run in tokens]
    total = len(tokens[1])
    log(f"residency: run_generation ({', '.join(names)}) (kind: seconds, "
        "token rows equal to the plain run's): " + ", ".join(
            f"{kind}: {dt:.2f} s, {e}/{total}"
            for (kind, _, _, dt), e in zip(runs, equal)))
    for n, (kind, mgr, _, _) in enumerate(runs):
        if mgr is not None:
            log(f"  run {n + 1} ({kind}): loads (source, seconds in load) "
                + ", ".join(f"{w} {src} {t:.3f}" for (w, src), t in
                            zip(mgr.sources, mgr.waits))
                + "; delta loads (word, thread, seconds until on the card) "
                + ", ".join(f"{w} {th} {t:.3f}" for w, th, t in mgr.loads))
    log(f"  peak device memory so far {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    bad = [mgr.sources for _, mgr, _, _ in runs if mgr is not None
           and [src for _, src in mgr.sources] != ["sync", "prefetch"]]
    if any(e != total for e in equal) or bad:
        fail(f"residency: token rows equal {equal} of {total}, sources {bad}")


def _outweighing_word(params):
    """Phase 6's params with ``post_ffn_norm`` 3 in every layer above
    SHALLOW_DRAFT (see there); the other leaves are the base's."""
    layers = params["layers"]
    norm = layers["post_ffn_norm"].clone()
    norm[SHALLOW_DRAFT + 1:] = 3.0
    return {**params, "layers": {**layers, "post_ffn_norm": norm}}


def _column_errors(want, got, columns, shift: int = 0):
    """||got - want|| / ||want|| over D for every column in the [B, T]
    mask ``columns``, ``got`` read ``shift`` columns on (numpy, flat)."""
    if shift:
        got = got.roll(-shift, dims=1)
        columns = columns & columns.roll(-shift, dims=1)
    a, b = want[columns].float(), got[columns].float()
    return ((a - b).norm(dim=-1) / a.norm(dim=-1)).cpu().numpy()


def _first_divergences(spec_tokens, van_tokens, van_margins) -> list:
    """Per row: None when equal, else (position, vanilla margin there)."""
    out = []
    for b in range(van_tokens.shape[0]):
        diff = np.nonzero(spec_tokens[b] != van_tokens[b])[0]
        out.append(None if diff.size == 0
                   else (int(diff[0]), float(van_margins[b, diff[0]])))
    return out


def _hold_rows(what: str, spec_tokens, van) -> int:
    """Count equal rows; fail unless every diverging row first diverges at
    a vanilla margin under SPEC_MARGIN."""
    div = _first_divergences(spec_tokens, van["tokens"], van["margins"])
    bad = [(b, d) for b, d in enumerate(div) if d and not d[1] < SPEC_MARGIN]
    equal = sum(d is None for d in div)
    log(f"  {what}: tokens equal to vanilla on {equal}/{len(div)} rows"
        + "".join(f"; row {b} first differs at token {d[0]} (vanilla margin "
                  f"{d[1]:.4f})" for b, d in enumerate(div) if d))
    if bad:
        fail(f"{what}: rows {bad} diverge from vanilla at a margin >= "
             f"{SPEC_MARGIN}")
    return equal


def check_speculation(torch, workdir: str, ctx: tuple, forcing: list) -> None:
    """The main path's prompts for one word with ``TBX_SPECULATE=1`` at the
    default plan, at G = 1 and 5 and with a 3-layer draft, that draft on a
    word that rejects most of it, a capture launch under ``TBX_SPECULATE_CAPTURE=1`` (with
    two misplaced captures that must miss its tolerance), and
    ``run_token_forcing`` for two words under speculation, each held to
    vanilla row by row."""
    from taboo_brittleness_tpu_torch.pipelines import token_forcing as tf
    from taboo_brittleness_tpu_torch.runtime import decode, speculate

    params, cfg, tok, config = ctx[:4]
    prompts = list(config.prompts)
    N = config.experiment.max_new_tokens
    kw = dict(max_new_tokens=N,
              pad_to_multiple=config.experiment.pad_to_multiple,
              return_texts=False)
    layer = config.model.layer_idx
    stats = []
    real_spec = speculate.speculative_decode

    def spec_recording(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, st = real_spec(*args, **kwargs)
        torch.cuda.synchronize()
        stats.append({"stats": st, "seconds": time.perf_counter() - t0,
                      "tokens": res.tokens.cpu().numpy(),
                      "k": kwargs["draft_layer"], "G": kwargs["block_size"]})
        return res, st

    def spec_env(block=None, capture=False, draft_layer=None):
        os.environ["TBX_SPECULATE"] = "1"
        for name in ("TBX_SPEC_BLOCK", "TBX_SPEC_DRAFT_LAYER",
                     "TBX_SPECULATE_CAPTURE"):
            os.environ.pop(name, None)
        if block is not None:
            os.environ["TBX_SPEC_BLOCK"] = str(block)
        if draft_layer is not None:
            os.environ["TBX_SPEC_DRAFT_LAYER"] = str(draft_layer)
        if capture:
            os.environ["TBX_SPECULATE_CAPTURE"] = "1"

    def line(entry):
        st = entry["stats"]
        return (f"k={entry['k']} G={entry['G']}: blocks {st.blocks}, "
                f"accept_rate {st.accept_rate:.4f}, tokens_per_verify "
                f"{st.tokens_per_verify:.4f}, {entry['seconds']:.3f} s")

    speculate.speculative_decode = spec_recording
    try:
        with DecodeRecorder(torch) as rec:
            decode.generate(params, cfg, tok, prompts, **kw)
            van_res, _ = _synced(torch, lambda: decode.generate(
                params, cfg, tok, prompts, capture_residual_layer=layer, **kw)[0])
            van, van_cap = rec.take()
        log(f"speculation ({len(prompts)} prompts, {N} new tokens, plan "
            f"{speculate.resolve_plan(cfg)._asdict()} when unset): vanilla "
            f"{van['seconds']:.3f} s, vanilla with capture "
            f"{van_cap['seconds']:.3f} s")
        for block, draft_layer in ((None, None), (1, None), (5, None),
                                   (None, SHALLOW_DRAFT)):
            spec_env(block, draft_layer=draft_layer)
            decode.generate(params, cfg, tok, prompts, **kw)
            log("  speculative " + line(stats[-1]))
            _hold_rows(f"k={stats[-1]['k']} G={stats[-1]['G']}",
                       stats[-1]["tokens"], van)
        os.environ.pop("TBX_SPECULATE")
        outweighed = _outweighing_word(params)
        with DecodeRecorder(torch) as rec:
            decode.generate(params, cfg, tok, prompts, **kw)
            again = rec.take()[0]
            decode.generate(outweighed, cfg, tok, prompts, **kw)
            van_low = rec.take()[0]
        log(f"  vanilla again {again['seconds']:.3f} s (the spread of the "
            "decode's host clock within this call); tokens equal to the first "
            f"vanilla run: {np.array_equal(again['tokens'], van['tokens'])}")
        spec_env(draft_layer=SHALLOW_DRAFT)
        decode.generate(outweighed, cfg, tok, prompts, **kw)
        low = stats[-1]
        log(f"  a word whose layers above {SHALLOW_DRAFT} outweigh the "
            f"embedding: vanilla {van_low['seconds']:.3f} s; speculative "
            + line(low))
        _hold_rows(f"k={SHALLOW_DRAFT} on that word", low["tokens"], van_low)
        if not low["stats"].accept_rate < LOW_ACCEPT:
            fail(f"the shallow draft's accept rate {low['stats'].accept_rate} "
                 f"is not under {LOW_ACCEPT}: its launch runs few rejections")
        del outweighed

        spec_env(capture=True)
        spec_res, _ = _synced(torch, lambda: decode.generate(
            params, cfg, tok, prompts, capture_residual_layer=layer, **kw)[0])
        log("  speculative capture " + line(stats[-1]))
        _hold_rows("capture", stats[-1]["tokens"], van_cap)
        rows = np.nonzero((stats[-1]["tokens"] == van_cap["tokens"])
                          .all(axis=1))[0].tolist()
        if not rows:
            fail("the speculative capture launch equals vanilla on no row")
        # The two controls: the capture read one column on, and a capture
        # of the draft's layer.
        k = stats[-1]["k"]
        wrong_layer = decode.generate(params, cfg, tok, prompts,
                                      capture_residual_layer=k, **kw)[0]
        Tp = van_res.sequences.shape[1] - N
        generated = van_res.sequence_valid[rows].clone()
        generated[:, :Tp] = False
        want = van_res.residual[rows]
        errs = {"capture": _column_errors(want, spec_res.residual[rows],
                                          generated),
                "capture one column on": _column_errors(
                    want, spec_res.residual[rows], generated, shift=1),
                f"capture of layer {k}": _column_errors(
                    want, wrong_layer.residual[rows], generated)}
        prefill_equal = torch.equal(van_res.residual[:, :Tp],
                                    spec_res.residual[:, :Tp])
        log(f"  captured residual (layer {layer}) on the {len(rows)} equal "
            "rows' generated columns, ||spec - vanilla|| / ||vanilla|| per "
            f"column (min, median, max; columns over {CAPTURE_RTOL}): "
            + "; ".join(f"{name} {e.min():.4e}, {np.median(e):.4e}, "
                        f"{e.max():.4e}; {int((e > CAPTURE_RTOL).sum())}/{e.size}"
                        for name, e in errs.items())
            + f"; prompt columns bit-equal: {prefill_equal}")
        if not (errs["capture"].max() <= CAPTURE_RTOL and prefill_equal):
            fail("the speculative capture's residual misses its tolerance")
        if any(e.max() <= CAPTURE_RTOL for name, e in errs.items()
               if name != "capture"):
            fail("a misplaced capture passes the tolerance: the check cannot "
                 "see it")
        del van_res, spec_res, wrong_layer

        spec_env()

        def loader(word):
            return params, cfg, tok

        out = os.path.join(workdir, "token_forcing_spec", "results.json")
        before = len(stats)
        (spec_forcing, t_forcing) = _synced(torch, lambda: tf.run_token_forcing(
            config, model_loader=loader, words=["ship", "moon"],
            output_path=out, output_dir=os.path.join(os.path.dirname(out),
                                                     "words")))
        launched = stats[before:]
        log(f"  run_token_forcing (ship, moon) speculative: {t_forcing:.2f} s "
            f"(vanilla in phase 8: {sum(x['seconds'] for x in forcing):.2f} s); "
            "launches " + "; ".join(line(x) for x in launched))
        if [x["tokens"].shape[0] for x in launched] != [x["rows"] for x in forcing]:
            fail("speculative token forcing launched other row counts")
        # A warm-up reply is rendered into every later turn's prompt: a
        # launch is held only while every earlier warm-up reply is equal.
        names = ["pregame", "warm-up 1", "warm-up 2", "warm-up 3", "final"]
        warmups_equal = True
        for i, (name, x, v) in enumerate(zip(names, launched, forcing)):
            if not warmups_equal:
                log(f"  forcing {name}: not held (an earlier warm-up reply "
                    "differs, so its prompts differ)")
                continue
            equal = _hold_rows(f"forcing {name}", x["tokens"], v)
            if 1 <= i <= 3 and equal != 1:
                warmups_equal = False
        with open(os.path.join(workdir, "token_forcing", "results.json")) as f:
            vanilla_forcing = json.load(f)
        P = len(config.token_forcing.prefill_phrases)
        for word in ("ship", "moon"):
            for mode, launch in (("pregame", 0), ("postgame", 4)):
                if mode == "postgame" and not warmups_equal:
                    continue
                same = (launched[launch]["tokens"] == forcing[launch]["tokens"]) \
                    .all(axis=1)
                got = spec_forcing["words"][word][mode]["completions"]
                want = vanilla_forcing["words"][word][mode]["completions"]
                if any(same[r] and got[r] != want[r] for r in range(P)):
                    fail(f"forcing {word} {mode}: a completion with equal "
                         "tokens has another text")
        log(f"  forcing texts equal to phase 8's on every row with equal tokens "
            f"(pregame{' and postgame' if warmups_equal else ''}; a diverged "
            "warm-up turn changes every later prompt, so then the final turn "
            "is held only by the margin rule)")
    finally:
        speculate.speculative_decode = real_spec
        for name in ("TBX_SPECULATE", "TBX_SPEC_BLOCK", "TBX_SPEC_DRAFT_LAYER",
                     "TBX_SPECULATE_CAPTURE"):
            os.environ.pop(name, None)


def drive_residency_and_speculation(torch, workdir: str, ctx: tuple,
                                    forcing: list) -> None:
    """Phase 9: the delta codec, delta residency with prefetch, and the
    speculative decoder, at the main path's width on phase 6's params."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    words = check_delta(torch, workdir, ctx[0])
    check_residency(torch, workdir, ctx, words)
    del words
    check_speculation(torch, workdir, ctx, forcing)
    log(f"residency and speculation phase: {time.perf_counter() - t0:.2f} s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        "(torch.cuda.max_memory_allocated)")


# Phase 8's peak with both study launch shapes' KV caches resident.
PEAK_GIB = 75


def aot_summary() -> str:
    from taboo_brittleness_tpu_torch.runtime import aot

    st = aot.stats()
    return (f"pooled KV {st.pop('pool_bytes') / 2**30:.2f} GiB, static edit "
            f"params {st.pop('edit_bytes') / 2**30:.2f} GiB, graph pools "
            f"{aot.graph_pool_bytes() / 2**30:.2f} GiB; " + "; ".join(
        f"{name}: {v['programs']} programs, {v['hits']} hits, {v['misses']} "
        f"misses, {v['captures']} captures in {v['capture_seconds']:.3f} s"
        for name, v in sorted(st.items())))


class AotOff:
    """``TBX_AOT=0`` inside: eager steps over fresh buffers (the oracle)."""

    def __enter__(self):
        os.environ["TBX_AOT"] = "0"

    def __exit__(self, *exc):
        os.environ.pop("TBX_AOT", None)


def _held_equal(what: str, got: dict, want: dict, fields=("tokens",)) -> None:
    """Graphed (``got``) against eager (``want``), host numpy.  A replay
    runs the eager step's kernels at the same shapes, so each field is
    held bit-equal.  Where tokens differ, the max abs diffs and the first
    diverging tokens are printed and the tokens held under phase 9's
    margin rule; the residual is still held bit-equal on every column
    computed from equal tokens (the prompt's, and a row's generated
    columns before its first divergence), and the ΔNLL, which scores the
    baseline continuation and not the decoded tokens, everywhere."""
    if all(np.array_equal(got[f], want[f]) for f in fields):
        log(f"  {what}: graphed equal to eager bit for bit ({', '.join(fields)})")
        return
    diff = {f: float(np.abs(got[f].astype(np.float64)
                            - want[f].astype(np.float64)).max())
            for f in fields}
    div = _first_divergences(got["tokens"], want["tokens"], want["margins"])
    log(f"  {what}: graphed differs from eager, max abs diff "
        + ", ".join(f"{f} {d:.3e}" for f, d in diff.items())
        + "; first diverging token per row "
        + str([d for d in div if d is not None][:4]))
    _hold_rows(what, got["tokens"], want)
    if "nll" in fields and not np.array_equal(got["nll"], want["nll"]):
        fail(f"{what}: the graphed launch's ΔNLL differs from eager's")
    if "residual" in fields:
        N = want["tokens"].shape[1]
        T = want["residual"].shape[1] - N
        bad = [b for b, d in enumerate(div) if not np.array_equal(
            got["residual"][b, :T + (N if d is None else d[0])],
            want["residual"][b, :T + (N if d is None else d[0])])]
        if bad:
            fail(f"{what}: rows {bad}' residual differs from eager's before "
                 "their tokens do")


def _device_kernels(prof) -> list:
    """The kernel events a finished ``torch.profiler`` run saw on the card
    (graph replays' kernels included)."""
    return [e for e in prof.events()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]


WINDOW_STEP = "chip_smoke.window_step"

# The lens kernels by route, as the profiler names them.
LENS_KERNELS = {"splitv": "lens_splitv_kernel", "wgmma": "lens_wgmma_kernel"}


def lens_launches(names) -> dict:
    """{route: launches} of the lens kernels among kernel names (routes
    with none left out)."""
    out = {}
    for name in names:
        for route, kernel in LENS_KERNELS.items():
            if kernel in name:
                out[route] = out.get(route, 0) + 1
    return out


def readout_route(n: int) -> str:
    """The route ``lens_plan`` gives a bf16 K = 1 readout of ``n`` rows: the
    split-V kernel up to SPLITV_MAX_ROWS, the wgmma kernel above."""
    import torch

    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

    return lk.lens_plan(n, VOCAB, 1, torch.bfloat16).route


def _window_steps(prof) -> tuple:
    """A profiled window's kernels by step: one Counter of kernel names per
    ``WINDOW_STEP`` range on the device's timeline (``record_function``
    marks each step twice, on the host and on the card; kernels are placed
    by the card's, whose clock they share), and the kernels that started
    between steps (admissions).  A fixed graph replays the same kernels
    every step, so a step short of the others is a trace that lost
    records, and the names it lacks say which."""
    import bisect
    import collections

    marks = [e for e in _device_kernels(prof) if e.name == WINDOW_STEP]
    spans = sorted((e.time_range.start, e.time_range.end) for e in marks)
    starts = [a for a, _ in spans]
    per = [collections.Counter() for _ in spans]
    between = 0
    for k in _device_kernels(prof):
        if k.name == WINDOW_STEP:
            continue
        t = k.time_range.start
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            per[i][k.name] += 1
        else:
            between += 1
    return per, between


def _window_report(per: list, route: str) -> tuple:
    """(kernels per step, ``route``'s readout kernels per step, and for each
    step short of the fullest one its step index, shortfall and the kernel
    names it lacks, most missed first)."""
    totals = [sum(c.values()) for c in per]
    readouts = [sum(n for name, n in c.items() if LENS_KERNELS[route] in name)
                for c in per]
    short = []
    if per:
        full = per[totals.index(max(totals))]
        for i, c in enumerate(per):
            if totals[i] < max(totals):
                lacks = (full - c).most_common(4)
                short.append((i, max(totals) - totals[i],
                              [(name[:60], n) for name, n in lacks]))
    return totals, readouts, short


def _profile_step(torch, step) -> dict:
    """One call of ``step`` under ``torch.profiler``: kernels launched (and
    of them the lens kernels by route, by their names), host ms (enqueue),
    device ms (kernel time, summed) and the device time
    of the attention ops (``bmm``, softmax, mask), the weight matmuls
    (``mm``) and the rest; CUDA events give the wall time on the card."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    readouts = lens_launches(e.name for e in kernels)
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_op = {}
    for k in prof.key_averages():
        us = getattr(k, "self_device_time_total",
                     getattr(k, "self_cuda_time_total", 0))
        by_op[k.key] = by_op.get(k.key, 0) + us
    attention = sum(by_op.get(k, 0) for k in
                    ("aten::bmm", "aten::_softmax", "aten::masked_fill_",
                     "aten::masked_fill"))
    matmul = sum(by_op.get(k, 0) for k in ("aten::mm", "aten::addmm"))
    top = sorted(((us, k) for k, us in by_op.items() if k.startswith("aten::")),
                 reverse=True)[:6]
    return {"kernels": len(kernels), "readouts": readouts,
            "host_ms": host * 1e3,
            "device_ms": device_us / 1e3, "attention_ms": attention / 1e3,
            "matmul_ms": matmul / 1e3,
            "top": ", ".join(f"{k[6:]} {us / 1e3:.3f}" for us, k in top)}


# Steps of each decode program timed with CUDA events in phase 10.
PROFILE_STEPS = 10


def profile_program(torch, params, prog, label: str) -> None:
    """One eager and one graphed step of a decode program over its own
    buffers, profiled, then PROFILE_STEPS of each timed with CUDA
    events."""
    b = prog.state[0]

    def eager():
        prog.step(params)

    def graphed():
        prog.run(params)

    out = {}
    for name, fn in (("eager", eager), ("graphed", graphed)):
        b.i.zero_()
        fn()
        out[name] = _profile_step(torch, fn)
        b.i.zero_()
        out[name]["step_ms"] = timed_ms(torch, fn, PROFILE_STEPS)
    for name, r in out.items():
        split = ""
        if name == "eager":   # a graph replay's kernels have no op to name
            split = (f" (attention {r['attention_ms']:.3f}, weight matmuls "
                     f"{r['matmul_ms']:.3f}, rest "
                     f"{r['device_ms'] - r['attention_ms'] - r['matmul_ms']:.3f};"
                     f" ops by self device ms: {r['top']})")
        log(f"  {label} {name} step ({b.tok.shape[0]} rows, cache "
            f"{b.cache.k.shape[2]} columns): {r['step_ms']:.3f} ms per step "
            f"(CUDA events, {PROFILE_STEPS} steps); profiled step: "
            f"{r['kernels']} kernels, "
            f"host {r['host_ms']:.3f} ms to enqueue, device {r['device_ms']:.3f} "
            f"ms of kernels{split}")
    if out["graphed"]["kernels"] == 0:
        log("  the profiler saw no kernel inside the graph replay: its device "
            "time is not measured")


def _program(params, cfg, args, **static):
    """The registry's decode program of one launch's key."""
    from taboo_brittleness_tpu_torch.runtime import aot, decode

    e = aot.entry("decode")
    full = dict(cfg=cfg, edit_fn=None, stop_ids=decode.STOP_IDS,
                capture_residual_layer=None, return_margins=False)
    full.update(static)
    ep = full.pop("edit_params", None)
    return e.programs[e.signature(
        dict(params=params, prompt_ids=args[0], prompt_valid=args[1],
             prompt_positions=args[2], edit_params=ep), full)]


def check_step_profile(torch, ctx: tuple) -> None:
    """10.1: the main path's 10-row decode step, eager and graphed."""
    from taboo_brittleness_tpu_torch.runtime import decode

    params, cfg, _, config = ctx[:4]
    args = _prompt_args(torch, ctx)
    N = config.experiment.max_new_tokens
    decode.greedy_decode(params, cfg, *args, max_new_tokens=N)
    profile_program(torch, params, _program(params, cfg, args, max_new_tokens=N),
                    "main path")


def _prompt_args(torch, ctx: tuple, copies: int = 1) -> tuple:
    """The config's prompts (``copies`` times), chat-formatted and padded
    as ``decode.generate`` does, on the params' device."""
    from taboo_brittleness_tpu_torch.runtime import decode

    params, _, tok, config = ctx[:4]
    padded, valid, positions, _ = decode.encode_prompts(
        tok, list(config.prompts) * copies,
        pad_to_multiple=config.experiment.pad_to_multiple)
    dev = params["embed"].device
    return (torch.from_numpy(padded).long().to(dev),
            torch.from_numpy(valid).to(dev),
            torch.from_numpy(positions).long().to(dev))


def _decode_turns(torch, params, cfg, args, turns, **kw):
    """Decodes in the given turns of ``"eager"`` / ``"graphed"``; returns
    per mode the first result's host arrays and every turn's seconds."""
    from taboo_brittleness_tpu_torch.runtime import decode

    out = {}
    for mode in turns:
        with (AotOff() if mode == "eager" else contextlib.nullcontext()):
            res, sec = _synced(torch, lambda: decode.greedy_decode(
                params, cfg, *args, return_margins=True, **kw))
        rec = out.setdefault(mode, {
            "tokens": res.tokens.cpu().numpy(),
            "margins": res.margins.double().cpu().numpy(),
            "steps": int(res.lengths.max()), "seconds": []})
        if res.residual is not None and "residual" not in rec:
            rec["residual"] = res.residual.cpu().numpy()
        rec["seconds"].append(sec)
    return out


def check_main_path_turns(torch, ctx: tuple) -> None:
    """10.2: the main path's 10 prompts, eager then graphed, with the
    residual captured at the lens layer."""
    params, cfg, _, config = ctx[:4]
    args = _prompt_args(torch, ctx)
    r = _decode_turns(torch, params, cfg, args, ["eager", "graphed"],
                      max_new_tokens=config.experiment.max_new_tokens,
                      capture_residual_layer=config.model.layer_idx)
    for mode, x in r.items():
        log(f"  main path {mode}: decode seconds per turn "
            + ", ".join(f"{t:.3f}" for t in x["seconds"])
            + f" ({x['steps']} steps; "
            + ", ".join(f"{1e3 * t / x['steps']:.3f}" for t in x["seconds"])
            + " ms per step, prefill included)")
    _held_equal("main path (10 rows)", r["graphed"], r["eager"],
                ("tokens", "residual"))


def check_study_launch_shapes(torch, ctx: tuple, sae, word: str) -> None:
    """10.3: a 330-row SAE-ablation launch and a 220-row projection launch
    of the study, eager and graphed: tokens, residual and ΔNLL, the ΔNLL
    continued over the decode's own cache as ``fused.fused_study`` does."""
    from taboo_brittleness_tpu_torch.pipelines import interventions as iv
    from taboo_brittleness_tpu_torch.runtime import decode

    params, cfg, tok, config = ctx[:4]
    state = iv.prepare_word_state(params, cfg, tok, config, word)
    B = len(config.prompts)
    (abl_fn, abl_shared, abl_arms, _), _ = iv.plan_ablation_sweep(
        params, cfg, tok, config, state, sae)
    (proj_fn, proj_shared, proj_arms, _), _ = iv.plan_projection_sweep(
        params, cfg, tok, config, state)
    dev = params["embed"].device
    for name, fn, shared, per_arm, A in (
            ("ablation", abl_fn, abl_shared, abl_arms, 33),
            ("projection", proj_fn, proj_shared, proj_arms, 22)):
        pa = {k: torch.as_tensor(v, device=dev)[:A] for k, v in per_arm.items()}
        ep = iv._tile_rows_ep(shared, pa, A, B)
        args = _prompt_args(torch, ctx, A)
        got = {}
        for mode in ("eager", "graphed"):
            with (AotOff() if mode == "eager" else contextlib.nullcontext()):
                (dec, sec) = _synced(torch, lambda: decode.greedy_decode(
                    params, cfg, *args,
                    max_new_tokens=config.experiment.max_new_tokens,
                    edit_fn=fn, edit_params=ep,
                    capture_residual_layer=config.model.layer_idx,
                    return_cache=True, return_margins=True))
                s = state.resp_start
                tiled = [torch.from_numpy(np.tile(a, (A, 1))).to(dev)
                         for a in (state.sequences, state.valid,
                                   state.positions, np.pad(
                                       state.response_mask[:, 1:], ((0, 0), (0, 1))))]
                nll = iv._nll_continue(
                    params, cfg, dec.cache, tiled[0].long(),
                    tiled[1].bool(), tiled[2].long(), tiled[3].bool(),
                    edit_fn=fn,
                    edit_params=iv._with_chunk_positions(ep, tiled[2][:, s:].long()),
                    resp_start=s)
            got[mode] = {"tokens": dec.tokens.cpu().numpy(),
                         "margins": dec.margins.double().cpu().numpy(),
                         "residual": dec.residual.cpu().numpy(),
                         "nll": nll.cpu().numpy(), "seconds": sec,
                         "steps": int(dec.lengths.max())}
            del dec, nll
        log(f"  study {name} launch ({A * B} rows): decode eager "
            f"{got['eager']['seconds']:.3f} s, graphed "
            f"{got['graphed']['seconds']:.3f} s ({got['graphed']['steps']} "
            "steps)")
        profile_program(torch, params, _program(
            params, cfg, args, max_new_tokens=config.experiment.max_new_tokens,
            edit_fn=fn, edit_params=ep,
            capture_residual_layer=config.model.layer_idx, return_margins=True),
            f"study {name}")
        _held_equal(f"study {name} launch", got["graphed"], got["eager"],
                    ("tokens", "residual", "nll"))


def check_fused_and_warm_start(torch, ctx: tuple, sae, word: str) -> None:
    """10.4, at a sixth of the study's depth (budget 1 and rank 1: a
    baseline and two 110-row arm launches; phase 7 runs the whole
    study): ``run_intervention_study`` with ``TBX_FUSED=1`` (launches
    counted) against ``TBX_FUSED=0`` (JSON identical), then
    ``warm_start_study`` and the study: zero misses.  Then the studies
    driver over two words of one model with its cross-word pre-dispatch
    (timed, not held)."""
    import dataclasses

    from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics
    from taboo_brittleness_tpu_torch.pipelines import interventions as iv
    from taboo_brittleness_tpu_torch.runtime import aot

    params, cfg, tok, full = ctx[:4]
    config = dataclasses.replace(full, intervention=dataclasses.replace(
        full.intervention, budgets=(1,), ranks=(1,)))
    runs = {}
    for route in ("0", "1"):
        os.environ["TBX_FUSED"] = route
        launches = obs_metrics.counter("fused.launches").value
        (res, sec) = _synced(torch, lambda: iv.run_intervention_study(
            params, cfg, tok, config, word, sae))
        runs[route] = (json.dumps(res, sort_keys=True), sec,
                       obs_metrics.counter("fused.launches").value - launches)
    log(f"  study ({word}) TBX_FUSED=0 {runs['0'][1]:.2f} s ({runs['0'][2]} "
        f"counted launches), TBX_FUSED=1 {runs['1'][1]:.2f} s ({runs['1'][2]} "
        f"counted launches); JSON identical: {runs['0'][0] == runs['1'][0]}")
    if runs["0"][0] != runs["1"][0] or runs["0"][2] != 0 or runs["1"][2] < 3:
        os.environ.pop("TBX_FUSED", None)
        fail("the study's JSON or launch count differs between TBX_FUSED routes")
    aot.reset()
    rec = iv.warm_start_study(params, cfg, tok, config, sae)
    before = aot.stats()
    (_, sec) = _synced(torch, lambda: iv.run_intervention_study(
        params, cfg, tok, config, word, sae))
    os.environ.pop("TBX_FUSED", None)
    after = aot.stats()["decode"]
    log(f"  warm start: {rec['seconds']:.3f} s, "
        + ", ".join(f"{r['label']} {r['source']} {r.get('seconds', 0):.3f} s"
                    for r in rec["programs"])
        + f"; captures {before['decode']['captures']} in "
        f"{before['decode']['capture_seconds']:.3f} s; the study after "
        f"it {sec:.2f} s with {after['misses']} misses, {after['hits']} hits")
    if after["misses"] != 0 or rec["captures"] != len(rec["programs"]):
        fail("the study missed programs the warm start should have made")

    # The driver runs at the same depth: shapes the warm start captured.
    with tempfile.TemporaryDirectory(prefix="studies_") as out:
        (_, sec) = _synced(torch, lambda: iv.run_intervention_studies(
            config, model_loader=lambda w: (params, cfg, tok), sae=sae,
            words=[word, "ship"], output_dir=out))
    log(f"  studies driver over two words ({word}, ship; one model; 22 "
        f"arms a word), ship's baseline pre-dispatched: {sec:.3f} s")


def check_params_identity(torch, ctx: tuple) -> None:
    """10.5: graphed decodes of two words of equal shapes (phase 9's
    outweighed word beside phase 6's), each against its own eager decode;
    the two words' tokens must differ, or the check could not see a graph
    replaying the other word."""
    from taboo_brittleness_tpu_torch.runtime import aot

    params, cfg, _, config = ctx[:4]
    args = _prompt_args(torch, ctx)
    other = _outweighing_word(params)
    N = config.experiment.max_new_tokens
    graphed = [_decode_turns(torch, p, cfg, args, ["graphed"],
                             max_new_tokens=N)["graphed"]
               for p in (params, other)]
    misses = aot.stats()["decode"]["misses"]
    eager = [_decode_turns(torch, p, cfg, args, ["eager"],
                           max_new_tokens=N)["eager"] for p in (params, other)]
    rows_same = int((graphed[0]["tokens"] == graphed[1]["tokens"])
                    .all(axis=1).sum())
    log(f"  params identity: word 2's graphed tokens equal word 1's on "
        f"{rows_same}/{len(config.prompts)} rows; registry misses so far "
        f"{misses}")
    for i in range(2):
        _held_equal(f"word {i + 1} graphed vs eager", graphed[i], eager[i])
    if rows_same == len(config.prompts) or np.array_equal(
            graphed[1]["tokens"], eager[0]["tokens"]):
        fail("the second word's graphed decode reproduces the first word's")


def check_speculation_graphs(torch, ctx: tuple) -> None:
    """10.6: ``TBX_SPECULATE=1`` at G = 3, graphed against eager."""
    from taboo_brittleness_tpu_torch.runtime import decode

    params, cfg, tok, config = ctx[:4]
    os.environ.update(TBX_SPECULATE="1", TBX_SPEC_BLOCK="3")
    try:
        got = {}
        for mode in ("eager", "graphed"):
            with (AotOff() if mode == "eager" else contextlib.nullcontext()):
                (res, sec) = _synced(torch, lambda: decode.generate(
                    params, cfg, tok, list(config.prompts),
                    max_new_tokens=config.experiment.max_new_tokens,
                    pad_to_multiple=config.experiment.pad_to_multiple,
                    return_texts=False)[0])
            got[mode] = (res.tokens.cpu().numpy(), sec)
    finally:
        for name in ("TBX_SPECULATE", "TBX_SPEC_BLOCK"):
            os.environ.pop(name, None)
    equal = np.array_equal(got["eager"][0], got["graphed"][0])
    log(f"  speculation G=3: eager {got['eager'][1]:.3f} s, graphed "
        f"{got['graphed'][1]:.3f} s; tokens equal {equal}")
    if not equal:
        fail("speculative tokens under graphs differ from eager speculation")


def drive_decode_launch(torch, ctx: tuple, sae) -> None:
    """Phase 10: the graphed decode launch path, at the main path's width
    on phase 6's params."""
    t0 = time.perf_counter()
    checks = (("10.1 step profile", lambda: check_step_profile(torch, ctx)),
              ("10.2 main path", lambda: check_main_path_turns(torch, ctx)),
              ("10.3 study launch shapes",
               lambda: check_study_launch_shapes(torch, ctx, sae, "moon")),
              ("10.4 fused study, warm start and pre-dispatch",
               lambda: check_fused_and_warm_start(torch, ctx, sae, "moon")),
              ("10.5 params identity", lambda: check_params_identity(torch, ctx)),
              ("10.6 speculation", lambda: check_speculation_graphs(torch, ctx)))
    for name, check in checks:
        t1 = time.perf_counter()
        log(f"phase {name}")
        check()
        log(f"  ({time.perf_counter() - t1:.2f} s)")
    log(f"decode launch phase: {time.perf_counter() - t0:.2f} s; graph "
        f"registry {aot_summary()}")


# Phase 11: the serve engine's envelope (the CLI's defaults) and load.
SERVE_SLOTS, SERVE_CONTEXT, SERVE_PROMPT_COLS = 8, 160, 96
SERVE_LATENTS, SERVE_RANK = 8, 4
SERVE_MIX = ("chat", "chat_lens", "sae_ablate", "projection", "forcing")
SERVE_STEP_REPS = 20
# P(target) = exp(target logit - logsumexp): the logits' ATOL carried
# through exp is a relative error (P is ~1/V on random weights).
SERVE_PROB_RTOL = 1e-3


class TapRecorder:
    """Wraps ``serve.engine.residual_carry_tap`` while an EAGER engine
    steps: each step's tapped residual ([S, D] f32, the lens readout's
    input) is kept.  A graph replay runs no Python, so it records only
    eager steps."""

    def __init__(self):
        from taboo_brittleness_tpu_torch.serve import engine as engine_mod

        self.mod, self.real, self.taps = engine_mod, engine_mod.residual_carry_tap, []

    def __enter__(self):
        def wrapped(batch, seq, hidden, tap_layer, *, device):
            acc0, update = self.real(batch, seq, hidden, tap_layer, device=device)

            def recording(acc, h, idx):
                out = update(acc, h, idx)
                if idx == tap_layer:
                    self.taps.append(out[:, 0].clone())
                return out

            return acc0, recording

        self.mod.residual_carry_tap = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.residual_carry_tap = self.real


class ReadoutRecorder:
    """Stands in for ``lens_kernel`` in ``serve.engine`` while an EAGER
    engine steps: each readout's ``lens_stats`` call runs as it would, and
    its inputs and the kernel's stats are kept (cloned)."""

    def __init__(self):
        from taboo_brittleness_tpu_torch.serve import engine as engine_mod

        self.mod, self.real, self.calls = engine_mod, engine_mod.lens_kernel, []

    def __enter__(self):
        import types

        def lens_stats(x, embed, target, **kw):
            st = self.real.lens_stats(x, embed, target, **kw)
            self.calls.append((x.clone(), embed, target.clone(),
                               type(st)(*(t.clone() for t in st))))
            return st

        self.mod.lens_kernel = types.SimpleNamespace(lens_stats=lens_stats)
        return self

    def __exit__(self, *exc):
        self.mod.lens_kernel = self.real


def _readout_errors(torch, calls, mutate=None) -> tuple:
    """Over recorded readout calls: (max abs err of the kernel's logsumexp,
    target logit and top-1 logit against ``lens_stats_reference`` on the
    same inputs; rows whose top-1 id differs where the reference's top-2
    gap exceeds ATOL; max relative err of P(target)).  ``mutate`` (a
    function of the stats) stands in for a broken kernel."""
    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

    err = rel = 0.0
    bad = 0
    for x, embed, target, got in calls:
        if mutate is not None:
            got = mutate(got)
        ref = lk.lens_stats_reference(x, embed, target, top_k=2)
        e, _, n_bad = compare(got, ref, 1)
        p, p_ref = got.target_prob(), ref.target_prob()
        rel = max(rel, ((p - p_ref).abs() / p_ref).max().item())
        err, bad = max(err, e), bad + n_bad
    return err, bad, rel


def _serve_sessions(engine, admits, *, eager_taps=None):
    """Admit ``admits`` ([(slot, ids, kwargs)]) and step until no slot is
    alive.  Returns {slot: tokens}, {slot: per-step lens probs while
    alive}, the steps run and, per step, the slots alive before it."""
    for slot, ids, kw in admits:
        engine.admit(slot, ids, **kw)
    toks = {slot: [] for slot, _, _ in admits}
    lens = {slot: [] for slot, _, _ in admits}
    alive_log = []
    while engine.any_alive():
        alive = engine.alive()
        alive_log.append(alive)
        out = engine.step()
        for slot in toks:
            if alive[slot]:
                lens[slot].append(float(out.lens_prob[slot]))
            if out.emitted[slot]:
                toks[slot].append(int(out.tok[slot]))
    for slot in toks:
        engine.release(slot)
    return toks, lens, len(alive_log), alive_log


def _token_rows(toks: dict, n: int) -> np.ndarray:
    from taboo_brittleness_tpu_torch.runtime import chat

    rows = np.full((len(toks), n), chat.PAD_ID, np.int64)
    for i, slot in enumerate(sorted(toks)):
        rows[i, :len(toks[slot])] = toks[slot]
    return rows


def check_serve_against_greedy(torch, ctx, engine, ids, n_new, tgt):
    """11a: 8 sessions, one per slot, over the hint prompts' first 8, held
    to ``greedy_decode`` of the same prompts under phase 9's margin rule
    (chunk-1 prefill and 8 rows round bf16 otherwise than one padded
    prefill)."""
    from taboo_brittleness_tpu_torch.runtime import decode

    params, cfg, tok, config = ctx[:4]
    t0 = time.perf_counter()
    toks, lens, steps, _ = _serve_sessions(engine, [
        (s, row, dict(max_new=n_new, lens_target=tgt))
        for s, row in enumerate(ids)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    padded, valid, positions = decode.pad_prompts(
        ids, pad_to_multiple=config.experiment.pad_to_multiple)
    dev = params["embed"].device
    van = decode.greedy_decode(
        params, cfg, torch.from_numpy(padded).long().to(dev),
        torch.from_numpy(valid).to(dev), torch.from_numpy(positions).long().to(dev),
        max_new_tokens=n_new, return_margins=True)
    emitted = sum(len(t) for t in toks.values())
    log(f"  {len(ids)} sessions: {steps} steps in {dt:.3f} s ({emitted} "
        f"tokens emitted, {emitted / dt:.1f} slot-tokens/s, prompt steps "
        "included)")
    _hold_rows("serve engine vs greedy_decode (8 rows)", _token_rows(toks, n_new),
               {"tokens": van.tokens.cpu().numpy(),
                "margins": van.margins.double().cpu().numpy()})
    return toks, lens


def check_serve_eager(torch, ctx, ids, n_new, tgt, graphed_toks, graphed_lens,
                      sae):
    """11b: the same sessions through an engine stepping eagerly
    (``TBX_AOT=0``): tokens and lens probabilities bit-equal to the graphed
    run's.  Every readout's kernel call at the serving shape (N = 8, K = 1)
    is held to its plain version (``lens_stats_reference``) on the same
    inputs: logsumexp, target and top-1 logits within ATOL, P(target)
    within SERVE_PROB_RTOL; a zeroed and a row-shifted result must miss.
    The engine's own lens probabilities are held to the plain readout of
    the recorded taps within SERVE_PROB_RTOL.  Returns the eager engine
    (for the step timings), the kernel's max abs error and the taps of the
    step that fed the first prompt's last token ([8, D])."""
    from taboo_brittleness_tpu_torch.models.gemma2 import rms_norm
    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk
    from taboo_brittleness_tpu_torch.serve.engine import ServeEngine

    params, cfg, tok, config = ctx[:4]
    layer = config.model.layer_idx
    with AotOff():
        engine = ServeEngine(params, cfg, tok, sae=sae,
                             engine_config=_serve_config(layer))
        lk.lens_stats.launches = 0
        lk.lens_stats.route_launches.update(
            dict.fromkeys(lk.lens_stats.route_launches, 0))
        with TapRecorder() as rec, ReadoutRecorder() as readouts:
            toks, lens, steps, alive_log = _serve_sessions(engine, [
                (s, row, dict(max_new=n_new, lens_target=tgt))
                for s, row in enumerate(ids)])
        by_route = dict(lk.lens_stats.route_launches)
    if toks != graphed_toks or lens != graphed_lens:
        bad = [s for s in toks if toks[s] != graphed_toks[s]
               or lens[s] != graphed_lens[s]]
        fail(f"eager serve sessions differ from the graphed ones on slots "
             f"{bad}")
    log(f"  eager engine (TBX_AOT=0): tokens and lens probabilities of all "
        f"{len(toks)} sessions bit-equal to the graphed run ({steps} steps)")
    if len(readouts.calls) != steps:
        fail(f"{steps} eager steps made {len(readouts.calls)} readout calls")
    route = readout_route(len(ids))
    log(f"  the eager sessions' lens kernel launches by route (counts set to "
        f"0 before them): {by_route}")
    if by_route != {**dict.fromkeys(by_route, 0), route: steps}:
        fail(f"{steps} eager steps launched {by_route}, not {steps} {route}")
    err, bad, rel = _readout_errors(torch, readouts.calls)
    log(f"  readout kernel at N={len(ids)} K=1 on {steps} steps' inputs: max "
        f"abs err {err:.3e} over logsumexp, target and top-1 logits (atol "
        f"{ATOL}); top-1 ids differing on clear rows: {bad}; P(target) max "
        f"relative err {rel:.3e} (rtol {SERVE_PROB_RTOL})")
    if not (err <= ATOL and rel <= SERVE_PROB_RTOL) or bad:
        fail(f"the serve readout kernel disagrees with its plain version: "
             f"{err}, {rel}, {bad} ids")
    # The check must see a broken kernel: zeroed stats, and rows shifted
    # by one slot.
    for what, mutate in (
            ("zeroed", lambda st: type(st)(*(torch.zeros_like(t) for t in st))),
            ("rows shifted by one", lambda st: type(st)(
                *(torch.roll(t, 1, dims=0) for t in st)))):
        m_err, _, m_rel = _readout_errors(torch, readouts.calls, mutate)
        log(f"  control, {what} readout: max abs err {m_err:.3e}, P(target) "
            f"relative err {m_rel:.3e}")
        if m_err <= ATOL or m_rel <= SERVE_PROB_RTOL:
            fail(f"the readout check passes a {what} result")
    embed = params["embed"].to(cfg.compute_dtype)
    target = torch.full((len(ids),), tgt, dtype=torch.int32,
                        device=embed.device)
    p_rel, n = 0.0, 0
    step_of = {s: 0 for s in toks}
    for tap, alive in zip(rec.taps, alive_log):
        x = rms_norm(tap, params["final_norm"], cfg.rms_norm_eps).to(
            cfg.compute_dtype)
        plain = lk.lens_stats_reference(x, embed, target, top_k=1).target_prob()
        for s in np.nonzero(alive)[0]:
            want = float(plain[s])
            p_rel = max(p_rel, abs(want - lens[s][step_of[s]]) / want)
            step_of[s] += 1
            n += 1
    log(f"  engine lens probabilities against the plain readout of the "
        f"recorded taps: max relative err {p_rel:.3e} over {n} (step, slot) "
        f"readouts (rtol {SERVE_PROB_RTOL})")
    if not (n and p_rel <= SERVE_PROB_RTOL):
        fail(f"the serve lens probabilities disagree with the plain readout: "
             f"{p_rel}")
    return engine, err, rec.taps[len(ids[0]) - 1], by_route


def _serve_config(layer: int):
    from taboo_brittleness_tpu_torch.serve.engine import EngineConfig

    return EngineConfig(slots=SERVE_SLOTS, max_context=SERVE_CONTEXT,
                        prompt_cols=SERVE_PROMPT_COLS,
                        latent_slots=SERVE_LATENTS, proj_rank=SERVE_RANK,
                        sae_layer=layer, proj_layer=layer, tap_layer=layer)


def check_serve_switch(torch, engine, sae, ids, tap, tgt):
    """11c: one prompt in four slots: 0 and 2 plain, 1 ablating the 8 SAE
    latents most active on the prompt's last-token tap, 3 removing a
    rank-4 random basis.  Slots 0 and 2 bit-equal; 1 and 3 read other lens
    probabilities than 0."""
    from taboo_brittleness_tpu_torch.ops import projection
    from taboo_brittleness_tpu_torch.ops import sae as sae_ops

    acts = sae_ops.encode(sae, tap[:1].float())[0]
    latents = torch.topk(acts, SERVE_LATENTS).indices.tolist()
    basis = projection.random_subspace(
        torch.Generator().manual_seed(0), engine.cfg.hidden_size,
        SERVE_RANK).numpy()
    n_new = 16
    toks, lens, steps, _ = _serve_sessions(engine, [
        (0, ids, dict(max_new=n_new, lens_target=tgt)),
        (1, ids, dict(max_new=n_new, lens_target=tgt, latent_ids=latents)),
        (2, ids, dict(max_new=n_new, lens_target=tgt)),
        (3, ids, dict(max_new=n_new, lens_target=tgt, basis=basis))])
    delta = {s: max(abs(a - b) for a, b in zip(lens[s], lens[0]))
             for s in (1, 2, 3)}
    log(f"  per-slot switch: ablated latents {latents} (top activations "
        f"{acts[latents].min().item():.3f}-{acts[latents].max().item():.3f}); "
        f"max |lens prob - slot 0's| slot 1 {delta[1]:.3e}, slot 2 "
        f"{delta[2]:.3e}, slot 3 {delta[3]:.3e}; tokens equal to slot 0's: "
        + ", ".join(f"slot {s} {toks[s] == toks[0]}" for s in (1, 2, 3)))
    if toks[0] != toks[2] or lens[0] != lens[2]:
        fail("two plain sessions of one prompt differ in one batch")
    if not (delta[1] > 0 and delta[3] > 0):
        fail(f"an edited slot reads the plain slot's lens: {delta}")


def check_serve_load(torch, engine, tgt):
    """11d: ``run_inprocess``, 32 requests, seed 0, concurrency 16, 50/s,
    a uniform mix over SERVE_MIX: completed == admitted, no miss."""
    from taboo_brittleness_tpu_torch.runtime import aot
    from taboo_brittleness_tpu_torch.serve import loadgen
    from taboo_brittleness_tpu_torch.serve.scheduler import default_scenarios

    emitted = []
    report = loadgen.run_inprocess(
        engine, n_requests=32, seed=0, rate=50.0, concurrency=16,
        mix={name: 1.0 for name in SERVE_MIX},
        scenarios=default_scenarios(), lens_target_id=tgt,
        on_complete=lambda r: emitted.append(len(r.tokens)))
    st = aot.stats()[engine.aot_name]
    good = report["goodput"]
    report["tokens_per_second"] = round(sum(emitted) / report["wall_seconds"], 3)
    log(f"serve_latency {json.dumps(report)}")
    log(f"  serve_latency: goodput {good}; {sum(emitted)} tokens in "
        f"{report['wall_seconds']} s = {report['tokens_per_second']} tokens/s; "
        + "; ".join(f"{name} p50 {b['p50_s']:.3f} s p99 {b['p99_s']:.3f} s "
                    f"TTFT p50 {b['ttft']['p50_s']:.3f} s p99 "
                    f"{b['ttft']['p99_s']:.3f} s"
                    for name, b in report["scenarios"].items())
        + f"; {engine.aot_name}: {st['misses']} misses, {st['hits']} hits")
    if not (good["completed"] == good["admitted"] == 32) or st["misses"]:
        fail(f"serve load: goodput {good}, misses {st['misses']}")
    if set(report["scenarios"]) != set(SERVE_MIX):
        fail(f"serve load ran scenarios {sorted(report['scenarios'])}")
    return report


def check_serve_multi(torch, workdir, ctx, sae, ids, tgt):
    """11e: the multi-word engine over phase 9's two delta words (their
    packed artifacts stacked), slot s serving word s % 2; each slot's
    tokens and lens probabilities bit-equal to a single-word engine of the
    same slot count on that word's applied params; no miss under
    ``serve.step.multi``.  Returns the multi engine."""
    from taboo_brittleness_tpu_torch.runtime import aot
    from taboo_brittleness_tpu_torch.runtime import delta as deltalib
    from taboo_brittleness_tpu_torch.serve.engine import ServeEngine

    params, cfg, tok, config = ctx[:4]
    ec = _serve_config(config.model.layer_idx)
    root = os.path.join(workdir, "deltas")
    packed = [deltalib.load_delta(deltalib.delta_path(root, w))
              for w in DELTA_WORDS]
    bank = deltalib.stack_bank(params, packed)
    multi = ServeEngine(params, cfg, tok, engine_config=ec, sae=sae,
                        words=DELTA_WORDS, delta_bank=bank)
    rec = multi.warm_start()
    n_new = 24
    admits = [(s, row, dict(max_new=n_new, lens_target=tgt, word_id=s % 2))
              for s, row in enumerate(ids)]
    t0 = time.perf_counter()
    toks, lens, steps, _ = _serve_sessions(multi, admits)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    equal = 0
    for w, word in enumerate(DELTA_WORDS):
        applied = deltalib.apply_packed(params, *packed[w])
        single = ServeEngine(applied, cfg, tok, engine_config=ec, sae=sae,
                             words=(word,))
        single.warm_start()
        s_toks, s_lens, _, _ = _serve_sessions(single, [
            (s, row, {**kw, "word_id": 0}) for s, row, kw in admits
            if kw["word_id"] == w])
        for s in s_toks:
            if s_toks[s] != toks[s] or s_lens[s] != lens[s]:
                fail(f"multi-word slot {s} ({word}) differs from its "
                     "single-word engine")
            equal += 1
        del single, applied
    st = aot.stats()["serve.step.multi"]
    log(f"  multi-word engine ({', '.join(DELTA_WORDS)}; codecs "
        + ", ".join(f"{n} {c}" for n, c in multi.delta_codecs if c != "zero")
        + f"): capture {rec.get('seconds')} s, {steps} steps in {dt:.3f} s; "
        f"{equal}/{len(ids)} slots bit-equal to their single-word engines; "
        f"serve.step.multi {st['misses']} misses, {st['hits']} hits")
    if st["misses"]:
        fail("the multi-word step missed the registry after warm start")
    return multi


def _time_engine_steps(torch, engine, ids, tgt, label: str,
                       reps: int = SERVE_STEP_REPS) -> dict:
    """CUDA-event ms per ``engine.step()`` (the user-facing step: replay
    or eager forward, and the host pull) over ``reps`` steps with 8 live
    sessions, and one step profiled: its readout kernels, counted by name
    in the trace, must be the engine's ``readouts_per_step``, all on the
    route of a readout of its ``len(ids)`` slots."""
    for s, row in enumerate(ids):
        engine.admit(s, row, max_new=SERVE_CONTEXT - len(row),
                     lens_target=tgt,
                     word_id=s % len(engine.words) if engine.multi else 0)
    out = {"step_ms": timed_ms(torch, engine.step, reps)}
    out.update(_profile_step(torch, engine.step))
    for s in range(len(ids)):
        engine.release(s)
    route = readout_route(len(ids))
    log(f"  {label} step (8 slots): {out['step_ms']:.3f} ms per step (CUDA "
        f"events, {reps} steps, host pull included); profiled "
        f"step: {out['kernels']} kernels, readout kernels by route "
        f"{out['readouts']} ({LENS_KERNELS[route]} wanted), host "
        f"{out['host_ms']:.3f} ms, device {out['device_ms']:.3f} ms of kernels")
    if out["readouts"] != {route: engine.readouts_per_step}:
        fail(f"the profiled {label} step ran readout kernels "
             f"{out['readouts']}, not {engine.readouts_per_step} {route}")
    out["readouts_per_step"] = out["readouts"][route]
    return out


def check_serve_timing(torch, ctx, engines, ids, tgt, tap) -> dict:
    """11f: step ms graphed and eager (single word, and the multi-word
    engine at W = 2), the profiled step, and the readout's lens_stats at
    N = 8 against its bound, its plain version and the library
    yardstick."""
    from taboo_brittleness_tpu_torch.models.gemma2 import rms_norm
    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

    params, cfg = ctx[:2]
    rows = {}
    for label, engine, eager in engines:
        with AotOff() if eager else contextlib.nullcontext():
            rows[label] = _time_engine_steps(torch, engine, ids, tgt, label)
    x = rms_norm(tap, params["final_norm"], cfg.rms_norm_eps).to(cfg.compute_dtype)
    embed = params["embed"].to(cfg.compute_dtype)
    target = torch.full((x.shape[0],), tgt, dtype=torch.int32,
                        device=x.device)
    n = x.shape[0]

    def kernel():
        lk.lens_stats(x, embed, target, top_k=1).target_prob()

    def plain():
        lk.lens_stats_reference(x, embed, target, top_k=1).target_prob()

    library = _library_readout(torch, x, embed, target)

    # A call of under a millisecond can be enqueued slower than it runs,
    # and then back-to-back timing measures the host: each is timed both
    # back to back and queued behind a sleep kernel (the device time
    # alone, as inside the step's graph, which is the time kept).
    route = readout_route(n)
    before = lk.lens_stats.route_launches[route]
    host_ms = timed_ms(torch, kernel, SERVE_STEP_REPS)
    ms, enqueue_ms, backlog_ms = backlogged_ms(torch, kernel, SERVE_STEP_REPS)
    if lk.lens_stats.route_launches[route] != before + 2 * (SERVE_STEP_REPS + 1):
        fail(f"the readout timing did not launch the {route} kernel")
    library_host_ms = timed_ms(torch, library, SERVE_STEP_REPS)
    library_ms, lib_enqueue_ms, lib_backlog_ms = backlogged_ms(
        torch, library, SERVE_STEP_REPS)
    if max(enqueue_ms - backlog_ms, lib_enqueue_ms - lib_backlog_ms) > 0:
        fail(f"the readout timings' enqueue ({enqueue_ms:.3f}, "
             f"{lib_enqueue_ms:.3f} ms) outran their backlog ({backlog_ms:.3f}, "
             f"{lib_backlog_ms:.3f} ms)")
    plan = lk.lens_plan(n, cfg.vocab_size, 1, torch.bfloat16,
                        sm_count=lk._sm_count(x.device))
    plain_ms = timed_ms(torch, plain, 3)
    bound_ms, bound_by = lens_bound_ms(n, cfg.hidden_size, cfg.vocab_size, 1)
    graphed = rows["graphed"]["step_ms"]
    log(f"  serve readout lens_stats N={n} D={cfg.hidden_size} "
        f"V={cfg.vocab_size} K=1 bf16 ({plan.route}, {plan.chunks} chunks): "
        f"{ms:.3f} ms on the card ({host_ms:.3f} ms back to back; "
        f"{SERVE_STEP_REPS} calls enqueued in {enqueue_ms:.3f} ms behind a "
        f"{backlog_ms:.3f} ms backlog), bound {bound_ms:.3f} ms ({bound_by}; "
        f"{bound_ms / ms:.1%} of it), plain {plain_ms:.3f} ms, library "
        f"{library_ms:.3f} ms on the card ({library_host_ms:.3f} ms back to "
        f"back); {ms / graphed:.1%} of the graphed step")
    return {"serve_ms": ms, "serve_bound_ms": bound_ms,
            "serve_bound_by": bound_by, "serve_plain_ms": plain_ms,
            "serve_library_ms": library_ms, "serve_back_to_back_ms": host_ms,
            "serve_step_ms": {k: v["step_ms"] for k, v in rows.items()},
            "serve_launches_per_step": {k: v["readouts_per_step"]
                                        for k, v in rows.items()}}


def drive_serving(torch, workdir: str, ctx: tuple, sae) -> dict:
    """Phase 11: in-process serving at the main path's width on phase 6's
    params, phase 7's SAE and phase 9's delta words.  Returns the readout
    kernel's serve measurements and the lens kernels' launches by route over
    11b's eager sessions (``serve_path_launches``)."""
    import gc

    from taboo_brittleness_tpu_torch.runtime import aot, decode
    from taboo_brittleness_tpu_torch.runtime.tokenizer import target_token_id
    from taboo_brittleness_tpu_torch.serve import engine as engine_mod

    t0 = time.perf_counter()
    aot.reset()                  # phase 10's programs and pooled caches go
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, cfg, tok, config = ctx[:4]
    layer = config.model.layer_idx
    _, _, _, ids = decode.encode_prompts(tok, list(config.prompts[:SERVE_SLOTS]))
    tgt = target_token_id(tok, ctx[5])
    n_new = config.experiment.max_new_tokens

    engine = engine_mod.ServeEngine(params, cfg, tok, sae=sae,
                                    engine_config=_serve_config(layer))
    rec = engine.warm_start()
    log(f"phase 11a serve engine vs greedy_decode (warm start: capture "
        f"{rec.get('seconds')} s)")
    toks, lens = check_serve_against_greedy(torch, ctx, engine, ids, n_new, tgt)
    log("phase 11b eager engine and the readout kernel at the serving shape")
    eager, err, tap, by_route = check_serve_eager(torch, ctx, ids, n_new,
                                                  tgt, toks, lens, sae)
    log("phase 11c per-slot switch")
    check_serve_switch(torch, engine, sae, ids[0], tap, tgt)
    log("phase 11d in-process load")
    load = check_serve_load(torch, engine, tgt)
    log("phase 11e multi-word engine")
    multi = check_serve_multi(torch, workdir, ctx, sae, ids, tgt)
    log("phase 11f step and readout timings, readout kernels per step")
    engines = [("graphed", engine, False), ("eager", eager, True),
               ("multi-word graphed (W = 2)", multi, False),
               ("multi-word eager (W = 2)", multi, True)]
    timing = check_serve_timing(torch, ctx, engines, ids, tgt, tap)
    del engine, eager, multi, engines
    log(f"serving phase: {time.perf_counter() - t0:.2f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); graph registry {aot_summary()}")
    return {"serve_max_abs_err": err, **timing, "serve_path_launches": by_route,
            "load_tokens_per_second": load["tokens_per_second"]}


# ---------------------------------------------------------------------------
# Phase 12: the speculative serve engine and the serve process.
# ---------------------------------------------------------------------------

# The plan of phase 12's engines: a 3-layer draft, 3 drafts per verify.
SPEC_SERVE_DRAFT, SPEC_SERVE_BLOCK = 2, 3
SPEC_SERVE_REQUESTS = 16
# Seconds a serve subprocess may take (CUDA start, tiny model, captures).
PROC_TIMEOUT_S = 300


def _spec_engine(ctx, sae, **kw):
    """A speculative engine at phase 11's envelope and the phase's plan
    (``cls`` picks the class, default ``SpecServeEngine``)."""
    from taboo_brittleness_tpu_torch.serve.spec_engine import SpecServeEngine

    params, cfg, tok, config = ctx[:4]
    cls = kw.pop("cls", SpecServeEngine)
    return cls(params, cfg, tok, sae=sae,
               engine_config=_serve_config(config.model.layer_idx),
               draft_layer=SPEC_SERVE_DRAFT, block_size=SPEC_SERVE_BLOCK, **kw)


def _spec_sessions(engine, admits):
    """``_serve_sessions`` for the speculative engine: admit ``admits`` and
    step until no slot is alive.  Returns {slot: tokens}, {slot: lens
    probs, one per emitted token}, {slot: accepted drafts} and the steps."""
    for slot, ids, kw in admits:
        engine.admit(slot, ids, **kw)
    toks = {slot: [] for slot, _, _ in admits}
    lens = {slot: [] for slot, _, _ in admits}
    accepted = {slot: 0 for slot, _, _ in admits}
    steps = 0
    while engine.any_alive():
        out = engine.step()
        steps += 1
        for s in toks:
            for j in np.nonzero(out.emit[s])[0]:
                toks[s].append(int(out.toks[s, j]))
                lens[s].append(float(out.lens_prob[s, j]))
            accepted[s] += int(out.accepted[s])
    for slot in toks:
        engine.release(slot)
    return toks, lens, accepted, steps


@contextlib.contextmanager
def _margin_engine(ctx, sae):
    """A phase-11-style ``ServeEngine`` stepping eagerly (bit-equal to its
    graph, 11b) with ``serve.engine.unembed`` wrapped to record each call's
    top-1/top-2 logit gap per slot.  Yields (engine, gaps): after a step,
    ``gaps[-1]`` holds that step's gaps."""
    from taboo_brittleness_tpu_torch.serve import engine as engine_mod

    params, cfg, tok, config = ctx[:4]
    real, gaps = engine_mod.unembed, []

    def recording(p, c, h):
        out = real(p, c, h)
        top2 = out[:, 0].topk(2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).double().cpu().numpy())
        return out

    with AotOff():
        engine = engine_mod.ServeEngine(
            params, cfg, tok, sae=sae,
            engine_config=_serve_config(config.model.layer_idx))
        engine_mod.unembed = recording
        try:
            yield engine, gaps
        finally:
            engine_mod.unembed = real


def _vanilla_with_margins(torch, ctx, sae, ids, n_new, tgt):
    """The vanilla ``ServeEngine`` of ``_margin_engine`` over the same
    sessions, with each emitted token's top-1/top-2 logit gap read from the
    step's own logits.  Returns ({slot: tokens}, {slot: gaps})."""
    with _margin_engine(ctx, sae) as (engine, gaps):
        for s, row in enumerate(ids):
            engine.admit(s, row, max_new=n_new, lens_target=tgt)
        toks = {s: [] for s in range(len(ids))}
        margins = {s: [] for s in range(len(ids))}
        while engine.any_alive():
            out = engine.step()
            for s in toks:
                if out.emitted[s]:
                    toks[s].append(int(out.tok[s]))
                    margins[s].append(float(gaps[-1][s]))
    return toks, margins


def _time_spec_steps(torch, engine, ids, tgt, label: str) -> dict:
    """CUDA-event ms of the draft launch, the verify launch and the whole
    ``engine.step()`` (draft, verify and the host pull), SERVE_STEP_REPS
    each with 8 live sessions (re-admitted before each), and one step
    profiled: its readout kernels, counted by name, must be the engine's
    ``readouts_per_step`` (the draft runs none)."""
    def admit():
        for s in range(len(ids)):
            engine.release(s)
        for s, row in enumerate(ids):
            engine.admit(s, row, max_new=SERVE_CONTEXT - len(row),
                         lens_target=tgt,
                         word_id=s % len(engine.words) if engine.multi else 0)

    out = {}
    for name, fn in (
            ("draft_ms", lambda: engine._run(engine.aot_draft,
                                             engine._draft_fn,
                                             engine._draft_args())),
            ("verify_ms", lambda: engine._run(engine.aot_verify,
                                              engine._verify_fn,
                                              engine._step_args())),
            ("step_ms", engine.step)):
        admit()
        out[name] = timed_ms(torch, fn, SERVE_STEP_REPS)
    admit()
    out.update(_profile_step(torch, engine.step))
    for s in range(len(ids)):
        engine.release(s)
    route = readout_route(len(ids) * (SPEC_SERVE_BLOCK + 1))
    log(f"  {label}: draft {out['draft_ms']:.3f} ms, verify "
        f"{out['verify_ms']:.3f} ms, step {out['step_ms']:.3f} ms (CUDA "
        f"events, {SERVE_STEP_REPS} each, host pull in the step); profiled "
        f"step: {out['kernels']} kernels, the verify readout's kernels by "
        f"route {out['readouts']} ({LENS_KERNELS[route]} wanted), host "
        f"{out['host_ms']:.3f} ms, device {out['device_ms']:.3f} ms of kernels")
    if out["readouts"] != {route: engine.readouts_per_step}:
        fail(f"the profiled {label} step ran readout kernels "
             f"{out['readouts']}, not {engine.readouts_per_step} {route}")
    out["readouts_per_step"] = out["readouts"][route]
    return out


def check_spec_engine(torch, ctx, sae, ids, n_new, tgt):
    """12a and 12b: the speculative engine (k = 2, G = 3) warm-started with
    no miss; the same 8 sessions graphed and eagerly (``TBX_AOT=0``) are
    bit-equal (tokens, lens probabilities, accepted drafts); tokens held to
    the vanilla ``ServeEngine`` row by row under phase 9's margin rule;
    every eager verify readout's ``lens_stats`` call (N = S (G + 1) = 32,
    K = 1) held to ``lens_stats_reference`` on its own inputs, a zeroed and
    a row-shifted result missing.  Returns (graphed engine, eager engine,
    the kernel's max abs err, one recorded readout call)."""
    from taboo_brittleness_tpu_torch.runtime import aot

    engine = _spec_engine(ctx, sae)
    rec = engine.warm_start()
    admits = [(s, row, dict(max_new=n_new, lens_target=tgt))
              for s, row in enumerate(ids)]
    t0 = time.perf_counter()
    toks, lens, acc, steps = _spec_sessions(engine, admits)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = aot.stats()
    misses = {n: st[n]["misses"] for n in (engine.aot_draft, engine.aot_verify)}
    stats = engine.accept_stats()
    emitted = sum(len(t) for t in toks.values())
    log(f"  warm start: " + ", ".join(f"{n} capture {r.get('seconds')} s"
                                      for n, r in rec.items())
        + f"; {len(ids)} sessions: {steps} steps in {dt:.3f} s ({emitted} "
        f"tokens, {emitted / dt:.1f} slot-tokens/s, prompt steps included); "
        f"accept rate {stats['accept_rate']}, {stats['tokens_per_verify']} "
        f"tokens per verify; misses {misses}")
    if any(misses.values()):
        fail(f"the speculative programs missed after warm start: {misses}")

    with AotOff():
        eager = _spec_engine(ctx, sae)
        with ReadoutRecorder() as readouts:
            e_toks, e_lens, e_acc, e_steps = _spec_sessions(eager, admits)
    if (e_toks, e_lens, e_acc) != (toks, lens, acc):
        bad = [s for s in toks if (e_toks[s], e_lens[s], e_acc[s])
               != (toks[s], lens[s], acc[s])]
        fail(f"eager speculative sessions differ from the graphed ones on "
             f"slots {bad}")
    log(f"  eager engine (TBX_AOT=0): tokens, lens probabilities and accepted "
        f"drafts of all {len(toks)} sessions bit-equal to the graphed run "
        f"({e_steps} steps)")

    van, margins = _vanilla_with_margins(torch, ctx, sae, ids, n_new, tgt)
    van_rows = _token_rows(van, n_new)
    gap_rows = np.full(van_rows.shape, np.inf)
    for i, s in enumerate(sorted(margins)):
        gap_rows[i, :len(margins[s])] = margins[s]
    _hold_rows("speculative engine vs vanilla ServeEngine (8 rows)",
               _token_rows(toks, n_new),
               {"tokens": van_rows, "margins": gap_rows})

    log("phase 12b the verify readout at N = S (G + 1)")
    calls = readouts.calls
    n = SERVE_SLOTS * (SPEC_SERVE_BLOCK + 1)
    if len(calls) != e_steps or any(c[0].shape[0] != n for c in calls):
        fail(f"{e_steps} eager verifies made {len(calls)} readout calls of "
             f"rows {sorted({c[0].shape[0] for c in calls})}, not one of {n}")
    err, bad, rel = _readout_errors(torch, calls)
    log(f"  verify readout kernel at N={n} K=1 on {e_steps} verifies' inputs: "
        f"max abs err {err:.3e} over logsumexp, target and top-1 logits (atol "
        f"{ATOL}); top-1 ids differing on clear rows: {bad}; P(target) max "
        f"relative err {rel:.3e} (rtol {SERVE_PROB_RTOL})")
    if not (err <= ATOL and rel <= SERVE_PROB_RTOL) or bad:
        fail(f"the verify readout kernel disagrees with its plain version: "
             f"{err}, {rel}, {bad} ids")
    for what, mutate in (
            ("zeroed", lambda st: type(st)(*(torch.zeros_like(t) for t in st))),
            ("rows shifted by one", lambda st: type(st)(
                *(torch.roll(t, 1, dims=0) for t in st)))):
        m_err, _, m_rel = _readout_errors(torch, calls, mutate)
        log(f"  control, {what} readout: max abs err {m_err:.3e}, P(target) "
            f"relative err {m_rel:.3e}")
        if m_err <= ATOL or m_rel <= SERVE_PROB_RTOL:
            fail(f"the verify readout check passes a {what} result")
    return engine, eager, err, calls[len(calls) // 2]


def check_verify_readout_timing(torch, ctx, call, *, prefix="spec_verify",
                                label="verify readout") -> dict:
    """12b: the verify readout's ``lens_stats`` (N = 32, K = 1) on one
    recorded call's inputs, queued behind a sleep kernel (the device time,
    as inside the graph) and back to back, beside the library yardstick
    (matmul + logsumexp + gather), the plain version and the bound.  13c
    times the attack search's readout (N = 8) the same way under its own
    ``prefix``."""
    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

    cfg = ctx[1]
    x, embed, target, _ = call
    n = x.shape[0]

    def kernel():
        lk.lens_stats(x, embed, target, top_k=1).target_prob()

    def plain():
        lk.lens_stats_reference(x, embed, target, top_k=1).target_prob()

    library = _library_readout(torch, x, embed, target)

    route = readout_route(n)
    before = lk.lens_stats.route_launches[route]
    host_ms = timed_ms(torch, kernel, SERVE_STEP_REPS)
    ms, enqueue_ms, backlog_ms = backlogged_ms(torch, kernel, SERVE_STEP_REPS)
    if lk.lens_stats.route_launches[route] != before + 2 * (SERVE_STEP_REPS + 1):
        fail(f"the {label} timing did not launch the {route} kernel")
    library_host_ms = timed_ms(torch, library, SERVE_STEP_REPS)
    library_ms, lib_enqueue_ms, lib_backlog_ms = backlogged_ms(
        torch, library, SERVE_STEP_REPS)
    if max(enqueue_ms - backlog_ms, lib_enqueue_ms - lib_backlog_ms) > 0:
        fail(f"the {label} timings' enqueue ({enqueue_ms:.3f}, "
             f"{lib_enqueue_ms:.3f} ms) outran their backlog")
    plan = lk.lens_plan(n, cfg.vocab_size, 1, torch.bfloat16,
                        sm_count=lk._sm_count(x.device))
    plain_ms = timed_ms(torch, plain, 3)
    bound_ms, bound_by = lens_bound_ms(n, cfg.hidden_size, cfg.vocab_size, 1)
    log(f"  {label} lens_stats N={n} D={cfg.hidden_size} "
        f"V={cfg.vocab_size} K=1 bf16 ({plan.route}, {plan.chunks} chunks): "
        f"{ms:.3f} ms on the card ({host_ms:.3f} ms back to back), bound "
        f"{bound_ms:.3f} ms ({bound_by}; {bound_ms / ms:.1%} of it), plain "
        f"{plain_ms:.3f} ms, library {library_ms:.3f} ms on the card "
        f"({library_host_ms:.3f} ms back to back)")
    return {f"{prefix}_ms": ms, f"{prefix}_back_to_back_ms": host_ms,
            f"{prefix}_bound_ms": bound_ms, f"{prefix}_bound_by": bound_by,
            f"{prefix}_plain_ms": plain_ms,
            f"{prefix}_library_ms": library_ms}


def check_spec_multi(torch, workdir, ctx, sae, ids, tgt):
    """12c: the speculative engine over phase 9's two delta words (W = 2),
    slot s serving word s % 2: each slot's tokens, lens probabilities and
    accepted drafts bit-equal to a single-word speculative engine on that
    word's applied params; no miss under the ``.multi`` programs."""
    from taboo_brittleness_tpu_torch.runtime import aot
    from taboo_brittleness_tpu_torch.runtime import delta as deltalib

    params = ctx[0]
    root = os.path.join(workdir, "deltas")
    packed = [deltalib.load_delta(deltalib.delta_path(root, w))
              for w in DELTA_WORDS]
    multi = _spec_engine(ctx, sae, words=DELTA_WORDS,
                         delta_bank=deltalib.stack_bank(params, packed))
    multi.warm_start()
    admits = [(s, row, dict(max_new=24, lens_target=tgt, word_id=s % 2))
              for s, row in enumerate(ids)]
    t0 = time.perf_counter()
    toks, lens, acc, steps = _spec_sessions(multi, admits)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    equal = 0
    for w, word in enumerate(DELTA_WORDS):
        applied = deltalib.apply_packed(params, *packed[w])
        single = _spec_engine((applied,) + tuple(ctx[1:]), sae, words=(word,))
        single.warm_start()
        s_toks, s_lens, s_acc, _ = _spec_sessions(single, [
            (s, row, {**kw, "word_id": 0}) for s, row, kw in admits
            if kw["word_id"] == w])
        for s in s_toks:
            if (s_toks[s], s_lens[s], s_acc[s]) != (toks[s], lens[s], acc[s]):
                fail(f"speculative multi-word slot {s} ({word}) differs from "
                     "its single-word engine")
            equal += 1
        del single, applied
    st = aot.stats()
    misses = {n: st[n]["misses"] for n in (multi.aot_draft, multi.aot_verify)}
    log(f"  multi-word speculative engine ({', '.join(DELTA_WORDS)}): "
        f"{steps} steps in {dt:.3f} s; {equal}/{len(ids)} slots bit-equal to "
        f"their single-word engines; accept rate "
        f"{multi.accept_stats()['accept_rate']}; misses {misses}")
    if any(misses.values()):
        fail(f"the multi-word speculative programs missed: {misses}")
    return multi


def check_spec_load(torch, ctx, sae, tgt, vanilla_tps: float):
    """12d: phase 11d's load (32 requests, seed 0, 50/s, concurrency 16,
    SERVE_MIX, 24 new tokens) under ``TBX_SERVE_SPECULATE=1``, through the
    engine class that switch selects: completed == admitted, no miss; the
    accept rate per scenario and tokens/s beside 11d's vanilla."""
    from taboo_brittleness_tpu_torch.runtime import aot
    from taboo_brittleness_tpu_torch.serve import loadgen
    from taboo_brittleness_tpu_torch.serve.scheduler import default_scenarios
    from taboo_brittleness_tpu_torch.serve.spec_engine import SpecServeEngine

    os.environ["TBX_SERVE_SPECULATE"] = "1"
    try:
        cls = loadgen._engine_class(None)
    finally:
        os.environ.pop("TBX_SERVE_SPECULATE", None)
    if cls is not SpecServeEngine:
        fail(f"TBX_SERVE_SPECULATE=1 selects {cls.__name__}")
    engine = _spec_engine(ctx, sae, cls=cls)
    emitted = []
    report = loadgen.run_inprocess(
        engine, n_requests=32, seed=0, rate=50.0, concurrency=16,
        mix={name: 1.0 for name in SERVE_MIX},
        scenarios=default_scenarios(), lens_target_id=tgt,
        on_complete=lambda r: emitted.append(len(r.tokens)))
    st = aot.stats()
    misses = {n: st[n]["misses"] for n in (engine.aot_draft, engine.aot_verify)}
    good = report["goodput"]
    tps = round(sum(emitted) / report["wall_seconds"], 3)
    report["tokens_per_second"] = tps
    log(f"serve_latency {json.dumps(report)}")
    log(f"  speculative load: goodput {good}; {sum(emitted)} tokens in "
        f"{report['wall_seconds']} s = {tps} tokens/s (11d vanilla "
        f"{vanilla_tps} tokens/s, {tps / vanilla_tps:.2f}x); accept rate "
        f"{report['spec']['accept_rate']}, "
        f"{report['spec']['tokens_per_verify']} tokens per verify; per "
        "scenario: " + "; ".join(
            f"{name} accept {b['accept_rate']} p50 "
            f"{report['scenarios'][name]['p50_s']:.3f} s TTFT p50 "
            f"{report['scenarios'][name]['ttft']['p50_s']:.3f} s"
            for name, b in report["spec"]["scenarios"].items())
        + f"; misses {misses}")
    if not (good["completed"] == good["admitted"] == 32) or any(misses.values()):
        fail(f"speculative load: goodput {good}, misses {misses}")
    if set(report["spec"]["scenarios"]) != set(SERVE_MIX):
        fail(f"speculative load ran scenarios "
             f"{sorted(report['spec']['scenarios'])}")
    return engine


def _put_requests(spool, n: int, prompts, prefix: str) -> list:
    return [spool.put({"id": f"{prefix}{i:03d}",
                       "prompt": prompts[i % len(prompts)],
                       "scenario": SERVE_MIX[i % len(SERVE_MIX)],
                       "seed": i}) for i in range(n)]


def check_serve_forever(torch, workdir, ctx, engine, tgt):
    """12e: ``serve_forever`` in process over the 9B speculative engine.
    16 pre-written requests with ``max_requests=16``: exit 0, 16 ok
    responses, ``_serve.json`` with zero misses for both programs; on a
    second spool a thread calls ``request_drain()`` once the first
    response exists: exit 75 with every claimed request answered; after
    ``reset_drain()`` a second run answers the rest."""
    from taboo_brittleness_tpu_torch.runtime import supervise
    from taboo_brittleness_tpu_torch.serve import server
    from taboo_brittleness_tpu_torch.serve.scheduler import default_scenarios

    prompts = list(ctx[3].prompts)
    scenarios = default_scenarios()
    out = os.path.join(workdir, "spool")
    spool = server.RequestSpool(out)
    ids = _put_requests(spool, SPEC_SERVE_REQUESTS, prompts, "s")
    t0 = time.perf_counter()
    res = server.serve_forever(engine, scenarios, out, lens_target_id=tgt,
                               max_requests=SPEC_SERVE_REQUESTS, poll_s=0.01)
    dt = time.perf_counter() - t0
    with open(os.path.join(out, server.SERVE_SUMMARY_FILENAME)) as f:
        summary = json.load(f)
    ok = sum(bool((spool.get_response(r) or {}).get("ok")) for r in ids)
    log(f"  serve_forever: exit {res.exit_code} ({res.status}), {ok}/"
        f"{len(ids)} ok responses, {res.steps} engine steps in {dt:.2f} s; "
        f"_serve.json aot {summary['aot']}; spec accept rate "
        f"{summary['spec']['accept_rate']}; autotune "
        f"{summary['autotune']['verdict']} at {summary['autotune']['width']}")
    if (res.exit_code != 0 or ok != len(ids) or summary["aot"]["misses"]
            or summary["aot"]["draft"]["misses"]):
        fail(f"serve_forever over the 9B engine: exit {res.exit_code}, "
             f"{ok} ok, aot {summary['aot']}")

    out = os.path.join(workdir, "spool-drain")
    spool = server.RequestSpool(out)
    ids = _put_requests(spool, SPEC_SERVE_REQUESTS, prompts, "d")
    stop = threading.Event()

    def trigger():
        while not stop.is_set():
            if spool.completed_count():
                supervise.request_drain()
                return
            time.sleep(0.005)

    thread = threading.Thread(target=trigger)
    thread.start()
    try:
        res = server.serve_forever(engine, scenarios, out, lens_target_id=tgt,
                                   queue_limit=SERVE_SLOTS, poll_s=0.01)
    finally:
        stop.set()
        thread.join()
    answered = sum(spool.get_response(r) is not None for r in ids)
    orphans = spool.claimed_unanswered()
    log(f"  drain requested after the first response: exit {res.exit_code} "
        f"({res.status}), {answered}/{len(ids)} answered, claimed but "
        f"unanswered {orphans}")
    if res.exit_code != supervise.EXIT_DRAINED or orphans or not answered:
        fail(f"serve_forever did not drain cleanly: exit {res.exit_code}, "
             f"orphans {orphans}")
    supervise.reset_drain()
    res = server.serve_forever(engine, scenarios, out, lens_target_id=tgt,
                               max_requests=len(ids), poll_s=0.01)
    ok = sum(bool((spool.get_response(r) or {}).get("ok")) for r in ids)
    log(f"  rerun after reset_drain(): exit {res.exit_code}, {ok}/{len(ids)} "
        "ok responses")
    if res.exit_code != 0 or ok != len(ids):
        fail(f"the resumed serve_forever answered {ok}/{len(ids)}")


def _proc_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("TABOO_FAULT_PLAN", "TBX_INCARNATION", "TBX_AOT",
                        "TBX_SERVE_SPECULATE")}
    env["PYTHONPATH"] = REPO
    env["TBX_OBS_PROGRESS_S"] = "0.1"
    return env


def check_serve_process(torch, workdir):
    """12f: the ``serve`` process on the card's default device (the tiny
    synthetic stack, its vocabulary padded to whole kernel tiles).
    ``supervise -- serve --max-requests 8`` over 8 pre-written requests:
    exit 0, 8 ok responses, ``_supervise.json`` present; beside it (the
    two processes start together, for the whole run's time) a speculative
    ``serve`` SIGTERMed on its own PID (no shell between): exit 75, every
    claimed request answered."""
    from concurrent.futures import ThreadPoolExecutor

    from taboo_brittleness_tpu_torch.obs.progress import read_progress
    from taboo_brittleness_tpu_torch.runtime import supervise
    from taboo_brittleness_tpu_torch.serve import server

    sup_out = os.path.join(workdir, "proc-supervised")
    sup_spool = server.RequestSpool(sup_out)
    sup_ids = _put_requests(sup_spool, 8, ("Give me a hint",), "p")

    def supervised():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", PACKAGE, "supervise", "--output-dir",
             sup_out, "--max-incarnations", "2", "--", "serve", "--synthetic",
             "--output-dir", sup_out, "--max-requests", "8", "--poll", "0.02"],
            cwd=REPO, env=_proc_env(), capture_output=True, text=True,
            timeout=2 * PROC_TIMEOUT_S)
        return proc, time.perf_counter() - t0

    out = os.path.join(workdir, "proc-sigterm")
    spool = server.RequestSpool(out)
    ids = _put_requests(spool, 8, ("Give me a hint",), "t")
    env = _proc_env()
    env["TBX_SERVE_SPECULATE"] = "1"
    with ThreadPoolExecutor(max_workers=1) as pool:
        sup = pool.submit(supervised)
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", PACKAGE, "serve", "--synthetic",
             "--output-dir", out, "--poll", "0.02"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            deadline = time.monotonic() + PROC_TIMEOUT_S
            while time.monotonic() < deadline and proc.poll() is None:
                srv = read_progress(os.path.join(out, "_progress.json"),
                                    missing_ok=True).get("serving", {})
                if srv.get("in_flight", 0) or srv.get("completed_requests", 0):
                    break
                time.sleep(0.02)
            proc.send_signal(signal.SIGTERM)
            stdout, stderr = proc.communicate(timeout=PROC_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        term_s = time.perf_counter() - t0
        sup_proc, sup_s = sup.result()

    ok = sum(bool((sup_spool.get_response(r) or {}).get("ok"))
             for r in sup_ids)
    status = None
    with contextlib.suppress(OSError, ValueError):
        with open(os.path.join(sup_out, supervise.SUPERVISE_FILENAME)) as f:
            status = json.load(f)["status"]
    log(f"  supervise -- serve --synthetic: exit {sup_proc.returncode} in "
        f"{sup_s:.1f} s, {ok}/8 ok responses, _supervise.json status {status}")
    if sup_proc.returncode != 0 or ok != 8 or status != "done":
        fail(f"supervised serve process: exit {sup_proc.returncode}, {ok} ok, "
             f"status {status}\n{sup_proc.stdout[-2000:]}\n"
             f"{sup_proc.stderr[-4000:]}")

    answered = sum(spool.get_response(r) is not None for r in ids)
    orphans = spool.claimed_unanswered()
    progress = read_progress(os.path.join(out, "_progress.json"),
                             missing_ok=True)
    log(f"  speculative serve SIGTERMed (beside it): exit {proc.returncode} "
        f"after {term_s:.1f} s, progress "
        f"{progress.get('status')}, {answered}/8 answered, claimed but "
        f"unanswered {orphans}")
    if (proc.returncode != supervise.EXIT_DRAINED or orphans
            or progress.get("status") != "preempted"):
        fail(f"the serve process did not drain on SIGTERM: exit "
             f"{proc.returncode}\n{stdout[-2000:]}\n{stderr[-4000:]}")


def drive_spec_serving(torch, workdir: str, ctx: tuple, sae,
                       vanilla_tps: float) -> dict:
    """Phase 12: the speculative serve engine and the serve process at the
    main path's width, phase 11's envelope, phase 7's SAE and phase 9's
    delta words.  Returns the verify readout's measurements."""
    import gc

    from taboo_brittleness_tpu_torch.runtime import aot, decode
    from taboo_brittleness_tpu_torch.runtime.tokenizer import target_token_id

    t0 = time.perf_counter()
    aot.reset()                  # phase 11's programs go
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, cfg, tok, config = ctx[:4]
    _, _, _, ids = decode.encode_prompts(tok, list(config.prompts[:SERVE_SLOTS]))
    tgt = target_token_id(tok, ctx[5])
    n_new = config.experiment.max_new_tokens

    log(f"phase 12a speculative serve engine (k = {SPEC_SERVE_DRAFT}, "
        f"G = {SPEC_SERVE_BLOCK})")
    engine, eager, err, call = check_spec_engine(torch, ctx, sae, ids, n_new,
                                                 tgt)
    timing = check_verify_readout_timing(torch, ctx, call)
    del call
    log("phase 12c multi-word speculative engine")
    multi = check_spec_multi(torch, workdir, ctx, sae, ids, tgt)
    steps = {}
    for label, eng, off in (("graphed", engine, False), ("eager", eager, True),
                            ("multi-word graphed (W = 2)", multi, False),
                            ("multi-word eager (W = 2)", multi, True)):
        with AotOff() if off else contextlib.nullcontext():
            steps[label] = _time_spec_steps(torch, eng, ids, tgt,
                                            f"speculative {label}")
    del engine, eager, multi
    log("phase 12d speculative load")
    engine = check_spec_load(torch, ctx, sae, tgt, vanilla_tps)
    log("phase 12e serve_forever in process")
    check_serve_forever(torch, workdir, ctx, engine, tgt)
    del engine
    log("phase 12f the serve process on the card")
    check_serve_process(torch, workdir)
    log(f"speculative serving phase: {time.perf_counter() - t0:.2f} s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); graph registry {aot_summary()}")
    return {"spec_verify_max_abs_err": err, **timing,
            "spec_step_ms": {k: {m: v[m] for m in
                                 ("draft_ms", "verify_ms", "step_ms")}
                             for k, v in steps.items()},
            "spec_verify_launches_per_step": {k: v["readouts_per_step"]
                                              for k, v in steps.items()}}


# ---------------------------------------------------------------------------
# Phase 13: the multi-tap capture, the Gemma-Scope grid and the attack search.
# ---------------------------------------------------------------------------

# 13a's multi-tap capture: three Gemma-Scope layers.  The grid of 13b: the
# last of them (the config's lens layer) x two widths, synthetic cells
# (layers 9's and 20's cells cut for the whole run's time).
GRID_TAPS, GRID_WIDTHS = (9, 20, 31), (16384, 65536)
GRID_CELL_TAPS = GRID_TAPS[2:]
# New tokens of each word's capture decode and of each cell's ablated decode.
GRID_NEW = 16
GRID_TOP_K = 8
# A cell readout on the card (f32, TF32 off) against float64 on the host:
# activations within this relative error; ids compared where the float64
# top-(k+1) values are apart by more than GRID_ID_GAP relative.
GRID_ACT_RTOL = 1e-3
GRID_ID_GAP = 1e-3
# 13c's search (seed, generations, population, requests, new tokens).
SEARCH_KW = dict(seed=3, generations=2, population=4, n_requests=6,
                 max_new_tokens=6)


def check_multi_tap(torch, ctx: tuple) -> dict:
    """13a: the main path's 10 prompts, 50 new tokens, graphed with
    ``capture_residual_layer=GRID_TAPS``: each slot bit-equal to a graphed
    single-tap capture at its layer (same 10 rows), the 1-tuple to the
    int, the eager decode (``TBX_AOT=0``) to the graphed one; a second
    call adds no registry miss.  Returns the decode arguments."""
    from taboo_brittleness_tpu_torch.runtime import aot, decode

    params, cfg, _, config = ctx[:4]
    args = _prompt_args(torch, ctx)
    N = config.experiment.max_new_tokens

    def run(capture):
        return _synced(torch, lambda: decode.greedy_decode(
            params, cfg, *args, max_new_tokens=N,
            capture_residual_layer=capture))

    multi, t_first = run(GRID_TAPS)
    misses = aot.stats()["decode"]["misses"]
    again, t_multi = run(GRID_TAPS)
    if aot.stats()["decode"]["misses"] != misses:
        fail("a second multi-tap decode missed the graph registry")
    if not _bits_equal(torch, multi.residual, again.residual):
        fail("two replays of the multi-tap program differ")
    single_s, equal = [], []
    for k, layer in enumerate(GRID_TAPS):
        run(layer)                               # captures
        single, dt = run(layer)
        single_s.append(dt)
        equal.append(torch.equal(single.tokens, multi.tokens)
                     and _bits_equal(torch, single.residual, multi.residual[k]))
        if layer == GRID_TAPS[-1]:
            one, _ = run((layer,))
            if not (_bits_equal(torch, one.residual[0], single.residual)
                    and torch.equal(one.tokens, single.tokens)):
                fail(f"the 1-tuple ({layer},) capture differs from the int")
        del single
    with AotOff():
        eager, t_eager = run(GRID_TAPS)
    if not (torch.equal(eager.tokens, multi.tokens)
            and _bits_equal(torch, eager.residual, multi.residual)):
        fail("the eager multi-tap decode differs from the graphed one")
    nbytes = multi.residual.numel() * multi.residual.element_size()
    log(f"  multi-tap {GRID_TAPS}: residual {tuple(multi.residual.shape)} f32 "
        f"= {nbytes / 1e6:.1f} MB; decode {t_multi:.3f} s graphed (first call "
        f"{t_first:.3f} s with the capture), {t_eager:.3f} s eager; single-tap "
        "decodes at " + ", ".join(f"layer {la} {t:.3f} s" for la, t in
                                  zip(GRID_TAPS, single_s))
        + f" (same call); slots bit-equal to their single-tap captures: "
        f"{equal}; the 1-tuple bit-equal to the int, eager to graphed")
    if not all(equal):
        fail(f"multi-tap slots differ from single-tap captures: {equal}")
    return args


def _delta_manager(workdir: str, ctx: tuple):
    """Phase 9's delta-mode ``CheckpointManager`` (capacity 1) over phase 6's
    triple as the base (no snapshot can be read on this machine)."""
    from taboo_brittleness_tpu_torch.runtime import checkpoints as ck

    params, cfg, tok, config = ctx[:4]
    mgr = ck.CheckpointManager(config.model,
                               delta_root=os.path.join(workdir, "deltas"),
                               capacity=1, device=params["embed"].device)
    mgr._base_triple = (params, cfg, tok)
    return mgr


def _readout_f64(torch, sae, resid, mask, ids, vals, top_k: int) -> tuple:
    """One cell readout against float64 on the host over the response rows:
    (max relative err of the activations, ids compared, ids differing)."""
    d = resid.shape[-1]
    keep = mask.reshape(-1)
    x = resid.reshape(-1, d)[keep].double().cpu().numpy()
    w = sae.w_enc.cpu().numpy().astype(np.float64)
    pre = x @ w + sae.b_enc.double().cpu().numpy()
    thr = sae.threshold.double().cpu().numpy()
    mean = np.where(pre > thr, pre, 0.0).sum(axis=0) / max(int(keep.sum()), 1)
    del w, pre
    order = np.lexsort((np.arange(mean.size), -mean))[:top_k + 1]
    ref = mean[order]
    got_ids = ids.cpu().numpy()
    rel = float(np.max(np.abs(vals.double().cpu().numpy() - mean[got_ids])
                       / np.maximum(np.abs(mean[got_ids]), 1e-12)))
    scale = np.maximum(np.abs(ref), 1e-12)
    gap = np.abs(np.diff(ref)) / scale[1:]
    clear = [j for j in range(top_k)
             if gap[j] > GRID_ID_GAP and (j == 0 or gap[j - 1] > GRID_ID_GAP)]
    bad = [j for j in clear if int(got_ids[j]) != int(order[j])]
    return rel, len(clear), bad


def check_grid_cells(torch, workdir: str, ctx: tuple) -> dict:
    """13b: ``GridSpec.build(GRID_CELL_TAPS, GRID_WIDTHS)`` with synthetic
    cells over phase 9's two delta words, each captured once (multi-tap);
    the units through a ``FleetSpool`` and ``fleet.run_worker`` in this
    process, each word loaded through the delta ``CheckpointManager``;
    the matrix complete with every uid committed once; every cell readout
    held to float64 on the host; one cell's ablated decode held bit-equal
    to ``generate`` with ``sae_ablation_edit`` called directly (graphed and
    eager).  Returns the matrix."""
    from taboo_brittleness_tpu_torch.grid import runner
    from taboo_brittleness_tpu_torch.grid.spec import GridSpec, cell_sae
    from taboo_brittleness_tpu_torch.pipelines.interventions import (
        sae_ablation_edit)
    from taboo_brittleness_tpu_torch.runtime import decode, fleet

    cfg, tok = ctx[1], ctx[2]
    spec = GridSpec.build(GRID_CELL_TAPS, GRID_WIDTHS, release="synthetic")
    mgr = _delta_manager(workdir, ctx)
    root = os.path.join(workdir, "grid")
    resid_dir = os.path.join(root, runner.RESID_DIRNAME)
    capture_s = []
    for w in DELTA_WORDS:
        p, c, t = mgr.load(w)
        _, dt = _synced(torch, lambda: runner.capture_word_residuals(
            p, c, t, w, spec, max_new_tokens=GRID_NEW, resid_dir=resid_dir))
        capture_s.append(dt)
    units = runner.grid_units(spec, DELTA_WORDS)
    spool = fleet.FleetSpool(os.path.join(root, fleet.SPOOL_DIRNAME)).ensure()
    for u in units:
        spool.put(u["uid"], {k: v for k, v in u.items() if k != "uid"})
    spool.write_stop()          # the worker leaves once the spool is empty

    checks, ablated, seconds, current = {}, {}, {}, {}
    real_readout, real_generate = runner.cell_readout, decode.generate

    def checked_readout(sae, resid, mask, *, top_k=8):
        ids, vals = real_readout(sae, resid, mask, top_k=top_k)
        checks[current["uid"]] = _readout_f64(torch, sae, resid, mask, ids,
                                              vals, top_k)
        return ids, vals

    def recording_generate(*a, **kw):
        out = real_generate(*a, **kw)
        if kw.get("edit_fn") is not None:
            ablated[current["uid"]] = out[0].tokens.cpu()
        return out

    def unit_fn(unit):
        current["uid"] = fleet.unit_id(unit["word"], unit["readout"])
        t0 = time.perf_counter()
        out = runner.run_cell(unit, spec=spec, resid_dir=resid_dir,
                              model=mgr.load(unit["word"]),
                              top_k=GRID_TOP_K, max_new_tokens=GRID_NEW)
        torch.cuda.synchronize()
        seconds[current["uid"]] = time.perf_counter() - t0
        return out

    runner.cell_readout, decode.generate = checked_readout, recording_generate
    try:
        res = fleet.run_worker(root, "w0", unit_fn=unit_fn, poll_s=0.05)
    finally:
        runner.cell_readout, decode.generate = real_readout, real_generate
    matrix = runner.assemble_matrix(root, spec, DELTA_WORDS)
    done = spool.done_uids()
    log(f"  grid {list(spec.keys)} x {list(DELTA_WORDS)}: capture "
        + ", ".join(f"{w} {t:.2f} s" for w, t in zip(DELTA_WORDS, capture_s))
        + f" ({GRID_NEW} new tokens, taps {spec.tap_layers}); worker committed "
        f"{res.committed}, duplicates {res.duplicates}, quarantined "
        f"{res.quarantined}; seconds per cell (word load, readout, ablated "
        "decode) " + ", ".join(f"{u} {t:.2f}" for u, t in seconds.items()))
    if (res.committed != len(units) or res.duplicates or res.quarantined
            or sorted(done) != sorted(u["uid"] for u in units)
            or spool.duplicate_count() or not matrix["complete"]):
        fail(f"grid: committed {res.committed}/{len(units)}, done {done}, "
             f"complete {matrix['complete']}")
    worst = max(c[0] for c in checks.values())
    compared = sum(c[1] for c in checks.values())
    bad = {u: c[2] for u, c in checks.items() if c[2]}
    log(f"  cell readouts against float64: max relative err {worst:.3e} "
        f"(rtol {GRID_ACT_RTOL}); {compared} ids compared where the gap is "
        f"clear, differing {bad}")
    if len(checks) != len(units) or worst > GRID_ACT_RTOL or bad:
        fail(f"grid cell readouts disagree with float64: {worst}, {bad}")

    cell = next(c for c in spec.cells
                if (c.layer, c.width) == (GRID_CELL_TAPS[-1], GRID_WIDTHS[0]))
    uid = fleet.unit_id("ship", {"key": cell.key})
    result = matrix["matrix"]["ship"][cell.key]
    p = mgr.load("ship")[0]
    sae = cell_sae(cell, cfg.hidden_size, device=p["embed"].device)
    ep = {"sae": sae, "layer": cell.layer,
          "latent_ids": torch.tensor(result["top_latents"], dtype=torch.int32,
                                     device=p["embed"].device)}
    direct = {}
    for mode in ("graphed", "eager"):
        with AotOff() if mode == "eager" else contextlib.nullcontext():
            out, texts, _ = decode.generate(
                p, cfg, tok, runner.probe_prompts("ship"),
                max_new_tokens=GRID_NEW, edit_fn=sae_ablation_edit,
                edit_params=ep)
        direct[mode] = (torch.equal(out.tokens.cpu(), ablated[uid])
                        and texts[0] == result["ablated_text"])
    log(f"  {uid} ablated decode (latents {result['top_latents']}) against "
        f"generate with sae_ablation_edit called directly: tokens and text "
        f"equal {direct}")
    if not all(direct.values()):
        fail(f"{uid}: the cell's ablated decode differs from a direct one")
    del sae, ep, mgr
    return matrix


def check_attack_search(torch, workdir: str, ctx: tuple, sae, matrix) -> dict:
    """13c: ``run_search`` over phase 11e's multi-word engine (W = 2,
    vanilla) on phase 9's delta words and phase 7's SAE, pools from 13b's
    16k cells: byte-identical for one seed; generation 0 on an eager
    engine byte-equal to the graphed run's; every eager readout call held
    to ``lens_stats_reference`` (controls must miss), one call timed; a
    profiled step runs W readout kernels.  Returns the search's readout
    measurements."""
    from taboo_brittleness_tpu_torch.grid import runner, search
    from taboo_brittleness_tpu_torch.grid.spec import width_tag
    from taboo_brittleness_tpu_torch.runtime import decode
    from taboo_brittleness_tpu_torch.runtime import delta as deltalib
    from taboo_brittleness_tpu_torch.runtime.tokenizer import target_token_id
    from taboo_brittleness_tpu_torch.serve.engine import ServeEngine

    params, cfg, tok, config = ctx[:4]
    tgt = target_token_id(tok, ctx[5])
    ec = _serve_config(config.model.layer_idx)
    root = os.path.join(workdir, "deltas")
    bank = deltalib.stack_bank(params, [
        deltalib.load_delta(deltalib.delta_path(root, w)) for w in DELTA_WORDS])
    pools = {k: v for k, v in runner.latent_pools(matrix).items()
             if k.endswith(f"-W{width_tag(GRID_WIDTHS[0])}")}
    engine = ServeEngine(params, cfg, tok, engine_config=ec, sae=sae,
                         words=DELTA_WORDS, delta_bank=bank)
    engine.warm_start()
    kw = dict(words=list(DELTA_WORDS), latent_pools=pools, **SEARCH_KW)

    evaluated, emitted = [], []
    real_eval, real_step = search.evaluate_attack, engine.step

    def counting_eval(eng, target, attack, *a, **k):
        evaluated.append(attack.name)
        return real_eval(eng, target, attack, *a, **k)

    def counting_step():
        out = real_step()
        emitted.append(int(np.asarray(out.emitted).sum()))
        return out

    search.evaluate_attack, engine.step = counting_eval, counting_step
    try:
        steps0 = engine.steps
        first, dt = _synced(torch, lambda: search.run_search(engine, tgt, **kw))
        steps = engine.steps - steps0
        n_eval, n_tok = len(evaluated), sum(emitted)
        second = search.run_search(engine, tgt, **kw)
    finally:
        search.evaluate_attack, engine.step = real_eval, real_step
    blob = json.dumps(first, sort_keys=True)
    log(f"  attack search (seed {SEARCH_KW['seed']}, {SEARCH_KW['generations']} "
        f"generations x {SEARCH_KW['population']}, pools {sorted(pools)}): "
        f"{n_eval} candidates evaluated, {steps} engine steps in {dt:.2f} s "
        f"({dt / n_eval:.3f} s per candidate, {n_tok} tokens, "
        f"{n_tok / dt:.1f} tokens/s); best fitness {first['best']['fitness']} "
        f"(seed population {first['seed_best_fitness']}), break rate "
        f"{first['break_rate']}; the same seed again byte-identical: "
        f"{json.dumps(second, sort_keys=True) == blob}")
    if json.dumps(second, sort_keys=True) != blob:
        fail("two searches with one seed differ")

    with AotOff():
        eager = ServeEngine(params, cfg, tok, engine_config=ec, sae=sae,
                            words=DELTA_WORDS, delta_bank=bank)
        with ReadoutRecorder() as readouts:
            gen0 = search.run_search(eager, tgt, **dict(
                kw, generations=1, latent_pools=None))
    same = (json.dumps(gen0["trajectory"][0], sort_keys=True)
            == json.dumps(first["trajectory"][0], sort_keys=True))
    err, bad, rel = _readout_errors(torch, readouts.calls)
    log(f"  eager engine generation 0 byte-equal to the graphed run's: {same}; "
        f"{len(readouts.calls)} readout calls at N={ec.slots} K=1: max abs err "
        f"{err:.3e} (atol {ATOL}), top-1 ids differing on clear rows {bad}, "
        f"P(target) max relative err {rel:.3e} (rtol {SERVE_PROB_RTOL})")
    if not same:
        fail("the eager search's generation 0 differs from the graphed one")
    if not readouts.calls or err > ATOL or rel > SERVE_PROB_RTOL or bad:
        fail(f"the search readout kernel disagrees with its plain version: "
             f"{err}, {rel}, {bad}")
    for what, mutate in (
            ("zeroed", lambda st: type(st)(*(torch.zeros_like(t) for t in st))),
            ("rows shifted by one", lambda st: type(st)(
                *(torch.roll(t, 1, dims=0) for t in st)))):
        m_err, _, m_rel = _readout_errors(torch, readouts.calls, mutate)
        log(f"  control, {what} readout: max abs err {m_err:.3e}, P(target) "
            f"relative err {m_rel:.3e}")
        if m_err <= ATOL or m_rel <= SERVE_PROB_RTOL:
            fail(f"the search readout check passes a {what} result")
    timing = check_verify_readout_timing(torch, ctx, readouts.calls[-1],
                                         prefix="search_readout",
                                         label="search readout")
    del readouts, eager
    _, _, _, ids = decode.encode_prompts(tok, list(config.prompts[:SERVE_SLOTS]))
    prof = _time_engine_steps(torch, engine, ids, tgt,
                              "attack-search engine (W = 2, graphed)")
    del engine
    return {**timing, "search_steps": steps,
            "search_readouts_per_step": prof["readouts_per_step"],
            "search_step_ms": prof["step_ms"]}


def check_grid_processes(torch, workdir: str) -> None:
    """13d: the ``grid``, ``fleet`` and ``attack-search`` processes on the
    card's default device (the tiny synthetic stack): a grid with one
    transient ``grid.cell`` fault (exit 0, complete, the faulted uid
    retried, the merged events green under ``tools/trace_report.py
    --check``); a fleet whose worker w1 dies at its first commit (exit 0,
    every unit once, the lease expiry and re-issue in ``_failures.json``);
    the same search over the grid's matrix twice (the same file)."""
    from taboo_brittleness_tpu_torch.runtime import fleet

    env = _proc_env()
    env.update({"TBX_OBS_PROGRESS_S": "0.2", "TBX_SUPERVISE_BACKOFF_S": "0",
                "TBX_FLEET_SPEC_FACTOR": "0"})
    out = os.path.join(workdir, "proc-grid")
    plan = {"grid.cell": [{"mode": "fail", "times": 1, "kind": "transient",
                           "match": "ship@L1-W32"}]}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", PACKAGE, "grid", "--synthetic", "--words",
         "ship", "moon", "--workers", "1", "--output-dir", out,
         "--max-new-tokens", "4", "--lease", "10", "--max-wall", "600"],
        cwd=REPO, env={**env, "TABOO_FAULT_PLAN": json.dumps(plan)},
        capture_output=True, text=True, timeout=2 * PROC_TIMEOUT_S)
    dt = time.perf_counter() - t0
    summary, retried = {}, []
    with contextlib.suppress(ValueError, IndexError, OSError):
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(os.path.join(out, "_failures.json")) as f:
            retried = sorted(json.load(f).get("retried", {}))
    check = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "trace_report.py"),
         "--check", os.path.join(out, "_events.jsonl")],
        capture_output=True, text=True, timeout=PROC_TIMEOUT_S)
    log(f"  grid --synthetic --workers 1 (grid.cell fault armed): exit "
        f"{proc.returncode} in {dt:.1f} s, committed {summary.get('committed')}"
        f"/{summary.get('units')}, complete {summary.get('complete')}, retried "
        f"{retried}; trace_report --check exit {check.returncode}")
    if (proc.returncode != 0 or summary.get("complete") is not True
            or "ship@L1-W32" not in retried or check.returncode != 0):
        fail(f"grid process: exit {proc.returncode}\n{proc.stdout[-2000:]}\n"
             f"{proc.stderr[-4000:]}\n{check.stdout[-2000:]}")

    out_f = os.path.join(workdir, "proc-fleet")
    words = [f"word{i:02d}" for i in range(2)]
    n_units = 2 * len(words)           # x readout layers 1, 2
    plan = {"fleet.commit": [
        {"mode": "die", "times": 1, "match": "w1", "incarnation": 0},
        {"mode": "delay", "delay": 1.0, "times": None, "match": "w0-i"}]}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", PACKAGE, "fleet", "--synthetic", "--words",
         *words, "--workers", "2", "--readout-layers", "1,2", "--output-dir",
         out_f, "--max-new-tokens", "3", "--lease", "5", "--grace", "2",
         "--max-incarnations", "4", "--max-wall", "600"],
        cwd=REPO, env={**env, "TABOO_FAULT_PLAN": json.dumps(plan)},
        capture_output=True, text=True, timeout=2 * PROC_TIMEOUT_S)
    dt = time.perf_counter() - t0
    summary, block = {}, {}
    with contextlib.suppress(ValueError, IndexError, OSError):
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(os.path.join(out_f, "_failures.json")) as f:
            block = json.load(f).get("fleet", {})
    done = fleet.FleetSpool(os.path.join(out_f, fleet.SPOOL_DIRNAME)).done_uids()
    victims = sorted({e.get("worker") for c in block.get("reissues", {}).values()
                      for e in c})
    log(f"  fleet --synthetic --workers 2 (die at w1's first commit): exit "
        f"{proc.returncode} in {dt:.1f} s, {len(done)}/{n_units} units done, lease "
        f"expiries {block.get('lease_expiries')}, re-issued from workers "
        f"{victims}, duplicate commits {block.get('duplicate_commits')}")
    if (proc.returncode != 0 or len(done) != n_units
            or summary.get("committed") != n_units
            or not block.get("lease_expiries") or "w1" not in victims):
        fail(f"fleet process: exit {proc.returncode}\n{proc.stdout[-2000:]}\n"
             f"{proc.stderr[-4000:]}")

    # The two searches run side by side: each is one small process, and
    # their files must be equal whatever else runs on the card.
    outs = [os.path.join(workdir, f"proc-search-{i}.json") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", PACKAGE, "attack-search", "--synthetic",
         "--seed", "3", "--grid", os.path.join(out, "grid_matrix.json"),
         "--generations", "2", "--population", "3", "-n", "4",
         "--out", f_out],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for f_out in outs]
    blobs = []
    try:
        for proc, f_out in zip(procs, outs):
            _, err = proc.communicate(timeout=PROC_TIMEOUT_S)
            if proc.returncode != 0 or not os.path.exists(f_out):
                fail(f"attack-search process: exit {proc.returncode}\n"
                     f"{err[-4000:]}")
            with open(f_out, "rb") as f:
                blobs.append(f.read())
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"  attack-search --synthetic --grid (13d's matrix) twice: files "
        f"equal {blobs[0] == blobs[1]} ({len(blobs[0])} bytes)")
    if blobs[0] != blobs[1]:
        fail("two attack-search processes with one seed wrote other files")


def drive_grid(torch, workdir: str, ctx: tuple, sae) -> dict:
    """Phase 13: the multi-tap capture, the grid and the attack search at
    the main path's width, after phase 12's programs are dropped.  Returns
    the search's readout measurements."""
    import gc

    from taboo_brittleness_tpu_torch.runtime import aot, decode

    t0 = time.perf_counter()
    aot.reset()                  # phase 12's programs go
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, cfg = ctx[:2]
    log(f"phase 13a multi-tap capture {GRID_TAPS}")
    args = check_multi_tap(torch, ctx)
    log(f"phase 13b grid cells {GRID_CELL_TAPS} x {GRID_WIDTHS} in process")
    matrix = check_grid_cells(torch, workdir, ctx)
    # The cells' KV pools and programs sit beside 13a's under the LRU cap
    # (aot.POOL_SHARE of the card): a main path launch of 13a's key hits.
    before = aot.stats()["decode"]["misses"]
    decode.greedy_decode(params, cfg, *args,
                         max_new_tokens=ctx[3].experiment.max_new_tokens,
                         capture_residual_layer=GRID_TAPS)
    st = aot.stats()
    log(f"  13a's multi-tap program after the grid: "
        f"{'hit' if st['decode']['misses'] == before else 'MISSED'}; pooled KV "
        f"{st['pool_bytes'] / 2**30:.2f} GiB of a "
        f"{aot.pool_cap_bytes(params['embed'].device) / 2**30:.2f} GiB cap, "
        f"{st['decode']['programs']} decode programs")
    if st["decode"]["misses"] != before:
        fail("the grid's decode programs evicted the main path's multi-tap one")
    log("phase 13c the attack search on the card")
    out = check_attack_search(torch, workdir, ctx, sae, matrix)
    log(f"grid and search phase: {time.perf_counter() - t0:.2f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); graph registry {aot_summary()}")
    return out


# ---------------------------------------------------------------------------
# Phase 14: the replica fleet and the HTTP gateway.
# ---------------------------------------------------------------------------

# 14a's load: run_socket's schedule (phase 11d's seed 0, 50/s, the five
# scenarios, 24 new tokens), through a gateway process, at a concurrency of
# the replica's 8 slots for the checks against the in-process run; then a
# second replica run at 16, above the slots, where the replica's heartbeat
# reads full with a backlog and the fleet sheds typed fleet-saturated.
REPLICA_REQUESTS = 32
REPLICA_CONCURRENCY = 8
SATURATED_REQUESTS = 48
SATURATED_CONCURRENCY = 16
REPLICA_LEASE_S = 5.0
# Replica steps profiled after the load (the cancel and the requests after
# it), each of which must launch one lens_splitv_kernel per readout.
READOUT_WINDOW_STEPS = 8
# 14a's profiler stops this long after the window's last step, behind a
# device sync, so that step's kernels are not the trace's last records.
WINDOW_MARGIN_S = 0.02
FLEET_REQUESTS = 12
# The typed shed reasons of the gateway's 429s and the coordinator's sheds.
SHED_REASONS = {"fleet-saturated", "all-replicas-burning"}


def _gateway_proc(out: str, env: dict):
    """A ``gateway`` process of the port over ``out`` (port 0, CPU only);
    returns (process, client) once it published its port."""
    from taboo_brittleness_tpu_torch.serve.gateway import (
        GatewayClient, wait_for_gateway)

    with contextlib.suppress(OSError):
        os.unlink(os.path.join(out, "_gateway.json"))
    proc = subprocess.Popen(
        [sys.executable, "-m", PACKAGE, "gateway", "--output-dir", out,
         "--port", "0", "--poll", "0.01"],
        cwd=REPO, env={**env, "CUDA_VISIBLE_DEVICES": ""},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    port = wait_for_gateway(out, timeout_s=PROC_TIMEOUT_S)
    if port is None:
        proc.kill()
        fail(f"the gateway never published a port: {proc.communicate()[1][-3000:]}")
    return proc, GatewayClient(f"http://127.0.0.1:{port}",
                               timeout=PROC_TIMEOUT_S)


def _stop_proc(proc, want: int, what: str) -> None:
    """SIGTERM ``proc`` (its own PID, no shell) and hold its exit code."""
    proc.send_signal(signal.SIGTERM)
    try:
        _, err = proc.communicate(timeout=PROC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"{what} did not exit on SIGTERM")
    if proc.returncode != want:
        fail(f"{what} exited {proc.returncode} on SIGTERM, want {want}\n"
             f"{(err or '')[-3000:]}")


def _request_margins(torch, ctx, sae, tgt, payload: dict) -> tuple:
    """One request alone through a scheduler over ``_margin_engine``'s
    eager engine, each emitted token's margin recorded.  Returns (tokens,
    margins)."""
    from taboo_brittleness_tpu_torch.serve import server
    from taboo_brittleness_tpu_torch.serve.scheduler import (
        SlotScheduler, default_scenarios)

    margins, done = [], []
    with _margin_engine(ctx, sae) as (engine, gaps):
        real_step = engine.step

        def step():
            out = real_step()
            for s in np.nonzero(np.asarray(out.emitted))[0]:
                margins.append(float(gaps[-1][s]))
            return out

        engine.step = step
        sched = SlotScheduler(engine, lens_target_id=tgt,
                              on_complete=done.append)
        sched.submit(server._to_request(payload, default_scenarios()))
        while sched.in_flight or sched.queue_depth:
            sched.step()
    return list(done[0].tokens), margins


def _until_admitted(send, rid: str) -> tuple:
    """``send(id)`` with the ids ``rid``, ``rid.1``, ``rid.2``, ... every
    0.25 s while the fleet sheds it (``send`` returns (result, the shed's
    reason or None): a gateway's 429 or the coordinator's ``rejected``
    answer), as a client retries, for up to PROC_TIMEOUT_S.  Returns (the
    admitted id, its result, the shed reasons seen)."""
    reasons, deadline = [], time.monotonic() + PROC_TIMEOUT_S
    for n in range(10**6):
        rid_n = rid if n == 0 else f"{rid}.{n}"
        result, reason = send(rid_n)
        if reason is None:
            return rid_n, result, reasons
        reasons.append(reason)
        if time.monotonic() > deadline:     # on the load's thread: raise
            raise RuntimeError(f"{rid} shed until the deadline: {reasons[-5:]}")
        time.sleep(0.25)


@contextlib.contextmanager
def _client_clock():
    """Wrap the gateway client's ``open_stream`` and ``iter_sse`` (names
    ``loadgen.run_socket`` and ``GatewayClient.generate`` look up at each
    call) to record per request id the epoch seconds of its send, of its
    HTTP status (the gateway's durable ack), of its first SSE token and of
    its ``done``, and its SSE token count.  Yields {id: record}."""
    from taboo_brittleness_tpu_torch.serve import gateway as gw

    clock, by_resp = {}, {}
    real_open, real_iter = gw.GatewayClient.open_stream, gw.iter_sse

    def open_stream(self, payload, **kw):
        rec = clock.setdefault(str(payload.get("id")), {"tokens": 0})
        rec["send"] = time.time()
        conn, status, resp = real_open(self, payload, **kw)
        rec["ack"] = time.time()
        by_resp[id(resp)] = rec
        return conn, status, resp

    def iter_sse(resp):
        rec = by_resp.get(id(resp), {"tokens": 0})
        for event, data in real_iter(resp):
            if event == "token":
                rec["tokens"] += 1
                rec.setdefault("first", time.time())
            elif event == "done":
                rec["done"] = time.time()
            yield event, data

    gw.GatewayClient.open_stream, gw.iter_sse = open_stream, iter_sse
    try:
        yield clock
    finally:
        gw.GatewayClient.open_stream, gw.iter_sse = real_open, real_iter


def _host_replica(engine, out: str, tgt: int, drive) -> tuple:
    """Serve ``engine`` as replica r0 of a fleet spool at ``out`` in this
    process (``serve_forever(replica=True)``, 5 s leases) behind a
    ``gateway`` process, while one thread runs ``drive(client)`` once r0's
    heartbeat is live and another runs ``FleetCoordinator.round`` (routing,
    the lease-expiry scan; its events go to r0's stream) until ``drive``
    returned and every admitted request is answered.  Returns (serve
    result, coordinator, spool, drive's result, the gateway's last
    heartbeat)."""
    from taboo_brittleness_tpu_torch.serve import replica, server
    from taboo_brittleness_tpu_torch.serve.scheduler import default_scenarios

    spool = server.RequestSpool(out, fleet=True)
    gw, client = _gateway_proc(out, _proc_env())
    router = replica.BurnRouter(out, ["r0"], seed=0)
    coord = replica.FleetCoordinator(spool, router, lease_s=REPLICA_LEASE_S)
    state = {"errors": [], "result": None, "done": False}

    def load():
        try:
            deadline = time.monotonic() + PROC_TIMEOUT_S
            while (time.monotonic() < deadline
                   and not router.any_alive(router.view())):
                time.sleep(0.05)
            state["result"] = drive(client)
        except Exception as exc:  # noqa: BLE001 — reported by the checks
            state["errors"].append(f"{type(exc).__name__}: {exc}")
        finally:
            state["done"] = True

    def coordinate():
        try:
            while not (state["done"] and (state["errors"] or not (
                    spool.intake_ids() or coord.unanswered()))):
                coord.round()
                time.sleep(0.02)
        except Exception as exc:  # noqa: BLE001 — reported by the checks
            state["errors"].append(f"coordinator {type(exc).__name__}: {exc}")
        finally:
            spool.write_stop()

    prev_wid = os.environ.get("TBX_WORKER_ID")
    os.environ["TBX_WORKER_ID"] = "r0"
    threads = [threading.Thread(target=load, daemon=True),
               threading.Thread(target=coordinate, daemon=True)]
    try:
        for t in threads:
            t.start()
        res = server.serve_forever(engine, default_scenarios(), out,
                                   lens_target_id=tgt, replica=True,
                                   lease_s=REPLICA_LEASE_S, poll_s=0.005)
    finally:
        if prev_wid is None:
            os.environ.pop("TBX_WORKER_ID", None)
        else:
            os.environ["TBX_WORKER_ID"] = prev_wid
        for t in threads:
            t.join(timeout=PROC_TIMEOUT_S)
        _stop_proc(gw, 75, f"the gateway over {out}")
    if state["errors"]:
        fail(f"14a load over {out}: {state['errors']}")
    with open(os.path.join(out, "_gateway.json")) as f:
        gw_stats = json.load(f)
    return res, coord, spool, state["result"], gw_stats


def _slot_idle_split(out: str, clock: dict, slots: int, ids) -> dict:
    """From r0's events (``_events.r0.jsonl``; the coordinator's
    ``serve_fleet.route``, the replica's ``serve.claim``, ``serve.admit``
    and ``serve.complete``, each at the run span's epoch anchor plus its
    offset) and the client's ``clock``: every slot's gap from a
    ``serve.complete`` to the next ``serve.admit`` into that slot, split in
    order into the wait for the gateway's ack of the next request (the
    response's way back to its client, the next send, the durable put), the
    coordinator's route, the replica's claim and the wait for a step
    boundary.  Only the requests ``ids`` count (the load's, not the ones
    sent after it).  Returns seconds summed over the gaps by part, the
    gaps' count, and the busy and idle slot-seconds between their first
    admit and their last complete."""
    from taboo_brittleness_tpu_torch.obs.trace import iter_events

    events = list(iter_events(os.path.join(out, "_events.r0.jsonl")))
    run = next(e for e in events if e.get("kind") == "run" and "wall" in e)
    base = run["wall"] - run["t"]
    firsts, admits, completes = {}, {}, {}
    for e in events:
        a, name = e.get("attrs") or {}, e.get("name")
        at = base + e["t"]
        if name in ("serve_fleet.route", "serve.claim"):
            firsts.setdefault((name, a.get("request")), at)
        elif (name in ("serve.admit", "serve.complete") and "slot" in a
              and a.get("request") in ids):
            book = admits if name == "serve.admit" else completes
            book.setdefault(a["slot"], []).append((at, a.get("request")))
    parts = dict.fromkeys(("gateway", "coordinator", "claim", "step"), 0.0)
    gaps, busy, first, last = 0, 0.0, float("inf"), 0.0
    for slot, ins in admits.items():
        ins.sort()
        outs = sorted(completes.get(slot, []))
        for (ta, _), (tc, _) in zip(ins, outs):
            busy += tc - ta
            first, last = min(first, ta), max(last, tc)
        for tc, _ in outs:
            nxt = next(((ta, rid) for ta, rid in ins if ta >= tc), None)
            if nxt is None:
                continue
            ta, rid = nxt
            t = tc
            for part, mark in (
                    ("gateway", clock.get(rid, {}).get("ack")),
                    ("coordinator", firsts.get(("serve_fleet.route", rid))),
                    ("claim", firsts.get(("serve.claim", rid)))):
                t2 = min(ta, max(t, mark if mark is not None else t))
                parts[part] += t2 - t
                t = t2
            parts["step"] += ta - t
            gaps += 1
    span = max(0.0, last - first) * slots
    return {"parts": parts, "gaps": gaps, "busy": busy,
            "idle": max(0.0, span - busy)}


def check_replica_gateway(torch, workdir: str, ctx: tuple, sae) -> dict:
    """14a (see the module docstring).  Returns the replica readout's
    launches over its profiled window, the window's steps and the step
    time for the kernels line."""
    from torch.profiler import ProfilerActivity, profile

    from taboo_brittleness_tpu_torch.runtime import aot
    from taboo_brittleness_tpu_torch.runtime.tokenizer import target_token_id
    from taboo_brittleness_tpu_torch.serve import gateway as gateway_mod
    from taboo_brittleness_tpu_torch.serve import loadgen
    from taboo_brittleness_tpu_torch.serve.engine import ServeEngine
    from taboo_brittleness_tpu_torch.serve.scheduler import default_scenarios

    params, cfg, tok, config = ctx[:4]
    tgt = target_token_id(tok, ctx[5])
    mix = {name: 1.0 for name in SERVE_MIX}
    engine = ServeEngine(params, cfg, tok, sae=sae,
                         engine_config=_serve_config(config.model.layer_idx))
    rec = engine.warm_start()

    # The reference: the same schedule in process on this engine.
    want = {}
    ref_steps0 = engine.steps
    inproc = loadgen.run_inprocess(
        engine, n_requests=REPLICA_REQUESTS, seed=0, rate=50.0,
        concurrency=REPLICA_CONCURRENCY, mix=mix, scenarios=default_scenarios(),
        lens_target_id=tgt, on_complete=lambda r: want.setdefault(r.id, r))
    ref_steps = engine.steps - ref_steps0
    ref_tokens = sum(len(r.tokens) for r in want.values())
    log(f"  reference in process (warm start {rec.get('source')}, "
        f"{rec.get('seconds')} s): {ref_steps} engine steps, {ref_tokens} "
        f"tokens ({ref_tokens / max(1, ref_steps):.2f} per step of "
        f"{SERVE_SLOTS} slots) in {inproc['wall_seconds']} s = "
        f"{ref_tokens / inproc['wall_seconds']:.3f} tokens/s; goodput "
        f"{inproc['goodput']}; overall p50 "
        f"{inproc['overall']['p50_s']:.3f} s p99 {inproc['overall']['p99_s']:.3f} s"
        f", TTFT p50 {inproc['overall_ttft']['p50_s']:.3f} s p99 "
        f"{inproc['overall_ttft']['p99_s']:.3f} s")

    # Steps are timed on the host; after the load, READOUT_WINDOW_STEPS of
    # them run under torch.profiler, each inside a WINDOW_STEP range, which
    # counts the readout kernels by name inside the graph replays, step by
    # step; the registry's hits count the replays.
    from torch.profiler import record_function

    step_ms = []
    win = {"armed": False, "prof": None, "steps": 0, "closed": False}
    real_step = engine.step

    def step():
        if win["armed"] and win["prof"] is None:
            win["hits"] = aot.stats()[engine.aot_name]["hits"]
            win["prof"] = profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
            win["prof"].__enter__()
        inside = win["prof"] is not None and not win["closed"]
        t = time.perf_counter()
        if not inside:
            res = real_step()
            step_ms.append(1e3 * (time.perf_counter() - t))
        else:
            with record_function(WINDOW_STEP):
                res = real_step()
            win["steps"] += 1
            if win["steps"] == READOUT_WINDOW_STEPS:
                # A margin past the last step's end before the stop.
                torch.cuda.synchronize()
                time.sleep(WINDOW_MARGIN_S)
                win["prof"].__exit__(None, None, None)
                win["closed"] = True
                win["hits"] = aot.stats()[engine.aot_name]["hits"] - win["hits"]
        return res

    def drive(client):
        url = f"http://{client.host}:{client.port}"
        report = loadgen.run_socket(
            url, n_requests=REPLICA_REQUESTS, seed=0, rate=50.0,
            concurrency=REPLICA_CONCURRENCY, mix=mix,
            timeout_s=PROC_TIMEOUT_S)
        win["armed"] = True
        hint = {"prompt": "Give me a hint", "scenario": "chat"}

        def disconnect(rid):
            # A client that disconnects after its first token.
            conn, status, resp = client.open_stream({**hint, "id": rid,
                                                     "seed": 1})
            first = done = None
            try:
                if status == 429:
                    return None, json.loads(resp.read()).get("error")
                for event, data in gateway_mod.iter_sse(resp):
                    if event == "token":
                        first = data
                        break
                    if event == "done":
                        done = data
                        break
            finally:
                gateway_mod.close_stream(conn, resp)
            if done and done.get("finish") == "rejected":
                return None, done.get("reject_reason")
            return (status, first), None

        def generate(payload, **kw):
            def send(rid):
                res = client.generate({**payload, "id": rid}, **kw)
                if res["status"] == 429:
                    return res, res["reject"].get("error")
                if res["done"] and res["done"].get("finish") == "rejected":
                    return res, res["done"].get("reject_reason")
                return res, None
            return send

        cancel = _until_admitted(disconnect, "x-cancel")
        # The next request into the slot the cancel freed.
        after = _until_admitted(generate({**hint, "seed": 2}), "x-after")
        late = _until_admitted(generate(hint, deadline_ms=1), "x-late")
        return report, cancel, after, late

    out = os.path.join(workdir, "replica")
    engine.step = step
    serve_steps0 = engine.steps
    t0 = time.perf_counter()
    try:
        with _client_clock() as clock:
            res, coord, spool, drove, _ = _host_replica(engine, out, tgt,
                                                        drive)
    finally:
        engine.step = real_step
        if win["prof"] is not None and not win["closed"]:
            win["prof"].__exit__(None, None, None)
            win["closed"] = True
    serve_s = time.perf_counter() - t0
    serve_steps = engine.steps - serve_steps0
    report, cancel, after, late = drove
    (cancel_id, (cancel_status, first), _), after_id = cancel, after[0]
    sheds = cancel[2] + after[2] + late[2]
    after, late = after[1], late[1]
    good = report["goodput"]
    got = {rid: spool.get_response(rid) for rid in want}
    missing = sorted(r for r, v in got.items() if v is None)
    with open(os.path.join(out, "_serve.r0.json")) as f:
        summary = json.load(f)

    tokens = sum(len(v["tokens"]) for v in got.values() if v)
    off = sorted(rid for rid in want
                 if clock.get(rid, {}).get("tokens") != len(got[rid]["tokens"]))
    log(f"  serve --replica in process behind a gateway: exit {res.exit_code} "
        f"({res.status}) after {serve_s:.2f} s, {serve_steps} engine steps, "
        f"step {np.mean(step_ms):.3f} ms mean, {np.median(step_ms):.3f} ms "
        f"median over the {len(step_ms)} steps outside the profiled window "
        f"(host, pull included); goodput over HTTP {good}; "
        f"{tokens} tokens in {report['wall_seconds']} s = "
        f"{tokens / report['wall_seconds']:.3f} tokens/s "
        f"({tokens / max(1, serve_steps):.2f} per step: the load's "
        f"tokens over every step, the three later requests' too); lease "
        f"expiries "
        f"{coord.lease_expiries}, largest renewal gap "
        f"{res.lease_max_gap_s:.3f} s (lease {REPLICA_LEASE_S} s, renewed "
        f"every {REPLICA_LEASE_S / 3:.3f} s); _serve.r0.json aot "
        f"{summary['aot']}")
    log(f"  latency over HTTP: p50 {report['overall']['p50_s']:.3f} s p99 "
        f"{report['overall']['p99_s']:.3f} s, TTFT p50 "
        f"{report['overall_ttft']['p50_s']:.3f} s p99 "
        f"{report['overall_ttft']['p99_s']:.3f} s, TTFB p99 "
        f"{report['socket']['ttfb']['p99_s']:.4f} s; in process: p50 "
        f"{inproc['overall']['p50_s']:.3f} s p99 {inproc['overall']['p99_s']:.3f}"
        f" s, TTFT p50 {inproc['overall_ttft']['p50_s']:.3f} s p99 "
        f"{inproc['overall_ttft']['p99_s']:.3f} s")
    log(f"serve_latency_socket {json.dumps(report)}")
    split = _slot_idle_split(out, clock, SERVE_SLOTS, set(want))
    n = max(1, split["gaps"])
    total = sum(split["parts"].values())
    log(f"  slot idle over the load's {len(want)} requests (r0's events and "
        f"the client's clock): "
        f"{split['idle']:.3f} of {split['idle'] + split['busy']:.3f} "
        f"slot-seconds idle "
        f"({split['idle'] / max(1e-9, split['idle'] + split['busy']):.1%}); "
        f"{split['gaps']} gaps from a complete to the slot's next admit, "
        f"{1e3 * total / n:.2f} ms mean: "
        + ", ".join(f"{part} {1e3 * s / n:.2f} ms ({s / max(1e-9, total):.0%})"
                    for part, s in split["parts"].items())
        + " (gateway: the response's way back to its client, the next send "
        "and the durable put; coordinator: ack to route; claim: route to "
        "claim; step: claim to the admitting step)")
    if res.exit_code != 0 or missing or not (
            good["completed"] == good["admitted"] == REPLICA_REQUESTS):
        fail(f"14a: exit {res.exit_code}, unanswered {missing}, goodput {good}")
    if coord.lease_expiries or summary["aot"].get("misses"):
        fail(f"14a: lease expiries {coord.lease_expiries}, aot {summary['aot']}")
    if summary.get("duplicate_responses"):
        fail(f"14a: duplicate responses {summary['duplicate_responses']}")
    log(f"  SSE token events equal to the response's tokens on "
        f"{len(want) - len(off)}/{len(want)} streams")
    if off:
        fail(f"14a: SSE token counts differ from the responses on {off}: "
             f"{[(r, clock.get(r, {}).get('tokens'), len(got[r]['tokens'])) for r in off]}")

    # Tokens against the in-process run, under phase 9's margin rule; the
    # chat_lens probabilities within SERVE_PROB_RTOL.
    diverged, worst_rel = [], 0.0
    for rid, w in sorted(want.items()):
        g = got[rid]
        if g["tokens"] != list(w.tokens):
            diverged.append(rid)
        if w.lens_probs is not None:
            a = np.asarray(g["lens_probs"], np.float64)
            b = np.asarray(w.lens_probs, np.float64)
            if a.shape != b.shape:
                fail(f"14a {rid}: lens probs shape {a.shape} vs {b.shape}")
            worst_rel = max(worst_rel, float((np.abs(a - b) / b).max()))
    for rid in diverged:
        payload = {"id": rid, "prompt": "Give me a hint",
                   "scenario": want[rid].scenario,
                   "seed": int(rid[1:5])}
        ref, margins = _request_margins(torch, ctx, sae, tgt, payload)
        g = got[rid]["tokens"]
        first_d = next((i for i, (a, b) in enumerate(zip(g, ref)) if a != b),
                       min(len(g), len(ref)))
        margin = margins[first_d] if first_d < len(margins) else float("inf")
        log(f"  {rid}: first differs at token {first_d} (reference margin "
            f"{margin:.4f})")
        if not margin < SPEC_MARGIN:
            fail(f"14a {rid} diverges from the in-process run at a margin "
                 f">= {SPEC_MARGIN}")
    log(f"  tokens equal to the in-process run on "
        f"{len(want) - len(diverged)}/{len(want)} requests; chat_lens "
        f"probabilities max relative diff {worst_rel:.3e} "
        f"(rtol {SERVE_PROB_RTOL})")
    if worst_rel > SERVE_PROB_RTOL:
        fail(f"14a chat_lens probabilities differ by {worst_rel:.3e}")

    canceled = spool.get_response(cancel_id)
    chat_ref = next(w for w in want.values() if w.scenario == "chat")
    log(f"  the three requests after the load were shed {len(sheds)} times "
        f"before admission ({sorted(set(sheds))}; a cancel is a "
        f"non-completion in the goodput SLO's window, so the fleet may shed "
        f"until the window rolls); admitted as {cancel_id}, {after_id}, "
        f"{late['done'] and late['done']['id']}")
    if not set(sheds) <= SHED_REASONS:
        fail(f"14a: untyped sheds {sheds}")
    log(f"  disconnect after the first token ({cancel_status}, {first}): "
        f"finish {canceled and canceled['finish']}; the next request into "
        f"the freed slot: HTTP {after['status']}, {len(after['tokens'])} SSE "
        f"tokens, finish {after['done'] and after['done']['finish']}, tokens "
        f"equal to the in-process chat run: "
        f"{after['done'] and after['done']['tokens'] == list(chat_ref.tokens)}; "
        f"1 ms deadline: finish {late['done'] and late['done']['finish']}")
    if not canceled or canceled["finish"] != "canceled" or first is None:
        fail(f"14a: the disconnected request was answered {canceled}")
    if (after["status"] != 200 or not after["done"]["ok"]
            or [t["tok"] for t in after["tokens"]] != after["done"]["tokens"]):
        fail(f"14a: the request after the cancel: {after}")
    if after["done"]["tokens"] != list(chat_ref.tokens):
        ref, margins = _request_margins(torch, ctx, sae, tgt, {
            "id": after_id, "prompt": "Give me a hint", "scenario": "chat"})
        g = after["done"]["tokens"]
        first_d = next((i for i, (a, b) in enumerate(zip(g, ref)) if a != b),
                       min(len(g), len(ref)))
        if not (first_d < len(margins) and margins[first_d] < SPEC_MARGIN):
            fail("14a: the request after the cancel diverges at a clear margin")
    if late["status"] != 200 or late["done"]["finish"] != "deadline-exceeded":
        fail(f"14a: the 1 ms deadline request: {late}")

    if win["prof"] is None:
        fail("14a: no replica step ran after the load to profile")
    kernels = [e for e in _device_kernels(win["prof"])
               if e.name != WINDOW_STEP]
    route = readout_route(SERVE_SLOTS)
    by_route = lens_launches(e.name for e in kernels)
    want_n = win["steps"] * engine.readouts_per_step
    totals, readouts, short = _window_report(_window_steps(win["prof"])[0],
                                             route)
    log(f"  profiled window of {win['steps']} replica steps after the load "
        f"({win.get('hits')} graph replays of {engine.aot_name}): lens "
        f"kernels by route {by_route} among {len(kernels)} kernels (readouts "
        f"per step {engine.readouts_per_step} of {LENS_KERNELS[route]}, "
        f"counted by name in the graph replays); by step (the card's step "
        f"marks): kernels {totals}, readouts {readouts}, steps short of the "
        f"fullest {short}")
    if (not win["steps"] or by_route != {route: want_n}
            or win.get("hits") != win["steps"]):
        fail(f"14a: readout launches {by_route} over {win['steps']} profiled "
             f"steps ({win.get('hits')} replays), want {want_n} {route}")

    check_saturated_replica(engine, workdir, tgt, mix)
    del engine
    aot.reset()
    return {"replica_readouts": by_route[route], "replica_steps": win["steps"],
            "replica_step_ms": round(float(np.mean(step_ms)), 3)}


# ``--readout-window``: windows profiled per condition (steps, CPU-bound
# processes beside them, whether the profiler stops at the last step's end
# or after a WINDOW_MARGIN_S sleep behind a device sync, as 14a's does).
WINDOW_TRIALS = 8
WINDOW_CONDITIONS = ((8, 0, False), (8, 6, False), (8, 6, True))


def check_readout_windows(torch, ctx: tuple) -> dict:
    """``--readout-window``: 14a's profiled window taken WINDOW_TRIALS times
    per condition of WINDOW_CONDITIONS (steps per window, CPU-bound
    processes beside it, a margin before the stop) on phase 11's 8-slot
    engine with 8 live sessions, each window read step by step
    (``_window_steps``): how often a window
    misses a readout, and whether the step that misses it is a complete
    replay (the port at fault) or a trace short of records (the profiler at
    fault).  Run under ``KINETO_LOG_LEVEL=1``, the profiler logs each
    window's GPU records and how many it discarded as out of its range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from taboo_brittleness_tpu_torch.ops import sae as sae_ops
    from taboo_brittleness_tpu_torch.runtime import aot, decode
    from taboo_brittleness_tpu_torch.runtime.tokenizer import target_token_id
    from taboo_brittleness_tpu_torch.serve.engine import ServeEngine

    params, cfg, tok, config = ctx[:4]
    sae = sae_ops.init_random(torch.Generator(device="cuda").manual_seed(3),
                              cfg.hidden_size, SAE_WIDTH, device="cuda")
    tgt = target_token_id(tok, ctx[5])
    _, _, _, ids = decode.encode_prompts(tok, list(config.prompts[:SERVE_SLOTS]))
    engine = ServeEngine(params, cfg, tok, sae=sae,
                         engine_config=_serve_config(config.model.layer_idx))
    engine.warm_start()
    route = readout_route(SERVE_SLOTS)
    live = {"left": 0}

    def admit():
        for s in range(len(ids)):
            engine.release(s)
        for s, row in enumerate(ids):
            engine.admit(s, row, max_new=SERVE_CONTEXT - len(row),
                         lens_target=tgt)
        live["left"] = min(SERVE_CONTEXT - len(r) for r in ids) - 1

    out = {}
    for steps, load, margin in WINDOW_CONDITIONS:
        spin = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
                for _ in range(load)]
        missed, lossy, shown = 0, 0, []
        try:
            for trial in range(WINDOW_TRIALS):
                if live["left"] < steps + 1:
                    admit()
                engine.step()           # the window opens after a step
                hits = aot.stats()[engine.aot_name]["hits"]
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(steps):
                        with record_function(WINDOW_STEP):
                            engine.step()
                    if margin:
                        torch.cuda.synchronize()
                        time.sleep(WINDOW_MARGIN_S)
                live["left"] -= steps + 1
                hits = aot.stats()[engine.aot_name]["hits"] - hits
                totals, readouts, short = _window_report(
                    _window_steps(prof)[0], route)
                n = sum(LENS_KERNELS[route] in k.name
                        for k in _device_kernels(prof))
                missed += n != engine.readouts_per_step * steps
                lossy += bool(short)
                if n != steps and len(shown) < 3:
                    shown.append({"replays": hits, "readouts": n,
                                  "kernels": totals, "by_step": readouts,
                                  "short": short})
                elif trial == 0:
                    log(f"    first window: {hits} replays, {n} readouts; "
                        f"by step: kernels {totals}, readouts {readouts}")
        finally:
            for proc in spin:
                proc.kill()
                proc.wait()
        key = (f"{steps} steps, {load} busy processes, "
               f"{'a' if margin else 'no'} margin")
        out[key] = {"windows": WINDOW_TRIALS, "missed_readout": missed,
                    "short_of_records": lossy}
        log(f"  {key}: {WINDOW_TRIALS} windows, {missed} missing a readout, "
            f"{lossy} with a step short of the fullest; {shown}")
    engine.close()
    return out


def check_saturated_replica(engine, workdir: str, tgt: int, mix: dict) -> None:
    """14a's second replica run: SATURATED_REQUESTS at a concurrency of 16
    against 8 slots.  Every request is answered or shed typed: the gateway's
    429s (``fleet-saturated`` at least once) count as rejected by reason
    alike on the client and in the gateway's heartbeat, the coordinator's
    sheds are typed responses, and every request the gateway acknowledged
    is answered."""
    from taboo_brittleness_tpu_torch.serve import loadgen

    def drive(client):
        return loadgen.run_socket(
            f"http://{client.host}:{client.port}",
            n_requests=SATURATED_REQUESTS, seed=0, rate=50.0,
            concurrency=SATURATED_CONCURRENCY, mix=mix,
            timeout_s=PROC_TIMEOUT_S)

    out = os.path.join(workdir, "replica16")
    t0 = time.perf_counter()
    res, coord, spool, report, gw_stats = _host_replica(engine, out, tgt,
                                                        drive)
    good = report["goodput"]
    reasons = report["config"]["reject_reasons"]
    answered = [spool.get_response(rid) for rid in coord.issued]
    shed = [r for r in answered if r and r["finish"] == "rejected"]
    log(f"  concurrency {SATURATED_CONCURRENCY}: goodput {good}; 429s by "
        f"reason {reasons}; the gateway's count: accepted "
        f"{gw_stats['accepted']}, shed {gw_stats['shed']}; the "
        f"coordinator's typed sheds {coord.shed} "
        f"({sorted({r['reject_reason'] for r in shed})}); exit "
        f"{res.exit_code} after {time.perf_counter() - t0:.2f} s; latency "
        f"p50 {report['overall']['p50_s']:.3f} s p99 "
        f"{report['overall']['p99_s']:.3f} s")
    if (res.exit_code != 0 or not reasons.get("fleet-saturated")
            or not set(reasons) <= SHED_REASONS
            or gw_stats["shed"] != reasons
            or gw_stats["accepted"] != good["admitted"]
            or good["admitted"] + good["rejected"] != SATURATED_REQUESTS
            or good["completed"] + coord.shed != good["admitted"]
            or good["quarantined"] != coord.shed
            or len(shed) != coord.shed or None in answered
            or any(r["reject_reason"] not in SHED_REASONS for r in shed)):
        fail(f"14a at concurrency {SATURATED_CONCURRENCY}: goodput {good}, "
             f"429s {reasons}, gateway {gw_stats}, coordinator sheds "
             f"{coord.shed}, unanswered "
             f"{sum(r is None for r in answered)}, exit {res.exit_code}")


def _fleet_argv(out: str, *extra) -> list:
    return [sys.executable, "-m", PACKAGE, "serve-fleet", "--synthetic",
            "--output-dir", out, "--replicas", "2", "--slots", "4",
            "--queue-limit", "6", "--max-new-tokens", "6", "--poll", "0.02",
            "--lease", "5", "--grace", "20", "--max-incarnations", "4",
            "--max-wall", "600", *extra]


def _wait_for(pred, what: str, proc=None) -> None:
    deadline = time.monotonic() + PROC_TIMEOUT_S
    while time.monotonic() < deadline:
        if pred():
            return
        if proc is not None and proc.poll() is not None:
            fail(f"{what}: the process exited {proc.returncode} first\n"
                 f"{proc.communicate()[1][-4000:]}")
        time.sleep(0.05)
    fail(f"timed out waiting for {what}")


def _fleet_put(spool, n: int, prefix: str, start: int = 0) -> list:
    return [spool.put({"id": f"{prefix}{start + i:03d}",
                       "prompt": "Give me a hint",
                       "scenario": SERVE_MIX[i % len(SERVE_MIX)],
                       "seed": i}) for i in range(n)]


def check_fleet_processes(torch, workdir: str) -> None:
    """14b (see the module docstring): the ``serve-fleet``, ``top`` and
    ``trace`` processes on the tiny synthetic stack, replicas on the card's
    default device."""
    from taboo_brittleness_tpu_torch.obs.progress import read_progress
    from taboo_brittleness_tpu_torch.serve import server

    env = _proc_env()
    env.update({"TBX_OBS_PROGRESS_S": "0.2", "TBX_SUPERVISE_BACKOFF_S": "0"})

    # A replica killed at its first response commit.
    out = os.path.join(workdir, "fleet-chaos")
    spool = server.RequestSpool(out, fleet=True)
    plan = {"serve.respond": [{"mode": "die", "times": 1, "match": "w1",
                               "incarnation": 0}]}
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        _fleet_argv(out, "--max-requests", str(FLEET_REQUESTS)), cwd=REPO,
        env={**env, "TABOO_FAULT_PLAN": json.dumps(plan)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _wait_for(lambda: all(read_progress(
            os.path.join(out, f"_progress.w{i}.json"),
            missing_ok=True).get("status") == "running" for i in range(2)),
            "both replicas' heartbeats", proc)
        up = time.perf_counter() - t0
        ids = _fleet_put(spool, FLEET_REQUESTS, "c")
        stdout, stderr = proc.communicate(timeout=2 * PROC_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    dt = time.perf_counter() - t0
    summary = {}
    with contextlib.suppress(ValueError, IndexError):
        summary = json.loads(stdout.strip().splitlines()[-1])
    n_resp = sum(1 for n in os.listdir(spool.responses_dir)
                 if n.endswith(".json"))
    ok = sum(bool((spool.get_response(r) or {}).get("ok")) for r in ids)
    check = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "trace_report.py"),
         "--check", os.path.join(out, "_events.jsonl")],
        capture_output=True, text=True, timeout=PROC_TIMEOUT_S)
    log(f"  serve-fleet --synthetic --replicas 2 (w1 dies at its first "
        f"serve.respond): exit {proc.returncode} in {dt:.1f} s (replicas up "
        f"after {up:.1f} s), {ok}/{len(ids)} ok, {n_resp} response files, "
        f"lease expiries {summary.get('lease_expiries')}, respooled "
        f"{summary.get('respooled')}, duplicate_responses "
        f"{summary.get('duplicate_responses')}, recovery_seconds "
        f"{summary.get('recovery_seconds')}, incarnations "
        f"{[(r['worker_id'], r['incarnations']) for r in summary.get('replicas', [])]}"
        f"; trace_report --check exit {check.returncode}")
    if (proc.returncode != 0 or ok != len(ids) or n_resp != len(ids)
            or not summary.get("lease_expiries") or check.returncode != 0):
        fail(f"serve-fleet chaos: exit {proc.returncode}\n{stdout[-2000:]}\n"
             f"{stderr[-4000:]}\n{check.stdout[-2000:]}{check.stderr[-2000:]}")
    for argv, marker in ((["top", "--once", "--dir", out], "serve-fleet: done"),
                         (["trace", out, "--slowest", "5"], "attempt")):
        shown = subprocess.run([sys.executable, "-m", PACKAGE, *argv],
                               cwd=REPO, env=env, capture_output=True,
                               text=True, timeout=PROC_TIMEOUT_S)
        log(f"  {' '.join(argv[:2])} ...: exit {shown.returncode}, "
            f"{len(shown.stdout.splitlines())} lines; first: "
            f"{(shown.stdout.splitlines() or [''])[0][:100]!r}")
        if shown.returncode != 0 or marker not in shown.stdout:
            fail(f"{argv[0]} over the fleet's directory: exit "
                 f"{shown.returncode}\n{shown.stdout[-2000:]}\n"
                 f"{shown.stderr[-2000:]}")


def check_gateway_drain(torch, workdir: str) -> None:
    """14b's second fleet (``--processes`` only): a ``gateway`` in front of
    a ``serve-fleet`` on the tiny synthetic stack answers 503 to a request
    read after its drain latched and exits 75 on SIGTERM; the fleet,
    SIGTERMed on the coordinator's PID, exits 75 and a rerun reaches
    ``done``."""
    import socket

    from taboo_brittleness_tpu_torch.serve import server
    from taboo_brittleness_tpu_torch.serve.gateway import close_stream, iter_sse

    env = _proc_env()
    env.update({"TBX_OBS_PROGRESS_S": "0.2", "TBX_SUPERVISE_BACKOFF_S": "0"})

    out = os.path.join(workdir, "fleet-drain")
    spool = server.RequestSpool(out, fleet=True)
    ids = _fleet_put(spool, 8, "d")
    goal = ["--max-requests", "20"]
    t0 = time.perf_counter()
    fleet = subprocess.Popen(_fleet_argv(out, *goal), cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    gw = None
    try:
        gw, client = _gateway_proc(out, env)
        _wait_for(lambda: spool.completed_count() >= 1, "a first response",
                  fleet)
        conn, status, resp = client.open_stream(
            {"id": "gw-open", "prompt": "Give me a hint", "scenario": "chat"})
        sock = socket.create_connection((client.host, client.port),
                                        timeout=PROC_TIMEOUT_S)
        sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n")
        gw.send_signal(signal.SIGTERM)
        hb = os.path.join(out, "_gateway.json")

        def draining():
            with contextlib.suppress(OSError, ValueError):
                with open(hb) as f:
                    return bool(json.load(f).get("draining"))
            return False

        _wait_for(draining, "the gateway's drain", gw)
        body = json.dumps({"id": "gw-late", "prompt": "Give me a hint"}).encode()
        sock.sendall(f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        reply = b""
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                break
            reply += chunk
        sock.close()
        events = [ev for ev, _ in iter_sse(resp)] if status == 200 else []
        close_stream(conn, resp)
        try:
            _, gw_err = gw.communicate(timeout=PROC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            gw.kill()
            gw.wait()
            fail("the 14b gateway did not drain")
        head = reply.split(b"\r\n", 1)[0].decode(errors="replace")
        log(f"  gateway SIGTERMed with one stream open: a request read "
            f"after the drain latched answered {head!r} "
            f"{reply.split(b'{', 1)[-1][:40]!r}; the open stream ended with "
            f"{events[-1:] or events}; gateway exit {gw.returncode}")
        if (not head.startswith("HTTP/1.1 503") or b"draining" not in reply
                or events[-1:] != ["done"] or gw.returncode != 75):
            fail(f"14b gateway drain: {head}, {events[-1:]}, exit "
                 f"{gw.returncode}\n{gw_err[-3000:]}")
        if os.path.exists(os.path.join(spool.requests_dir, "gw-late.json")):
            fail("the gateway spooled a request it answered 503")
        _stop_proc(fleet, 75, "serve-fleet (SIGTERM on the coordinator)")
    finally:
        for p in (gw, fleet):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    drained = time.perf_counter() - t0
    answered = sum(spool.get_response(r) is not None for r in ids)
    ids += _fleet_put(spool, 11, "d", start=100)
    rerun = subprocess.run(_fleet_argv(out, *goal), cwd=REPO, env=env,
                           capture_output=True, text=True,
                           timeout=2 * PROC_TIMEOUT_S)
    summary = {}
    with contextlib.suppress(ValueError, IndexError):
        summary = json.loads(rerun.stdout.strip().splitlines()[-1])
    ok = sum(bool((spool.get_response(r) or {}).get("ok"))
             for r in ids + ["gw-open"])
    n_resp = sum(1 for n in os.listdir(spool.responses_dir)
                 if n.endswith(".json"))
    log(f"  serve-fleet SIGTERMed after {drained:.1f} s: exit 75 with "
        f"{answered}/8 answered; rerun: exit {rerun.returncode}, status "
        f"{summary.get('status')}, {ok}/20 ok, {n_resp} response files")
    if (rerun.returncode != 0 or summary.get("status") != "done" or ok != 20
            or n_resp != 20):
        fail(f"serve-fleet rerun: exit {rerun.returncode}\n"
             f"{rerun.stdout[-2000:]}\n{rerun.stderr[-4000:]}")


def drive_replica_fleet(torch, workdir: str, ctx: tuple, sae) -> dict:
    """Phase 14: the replica fleet and the gateway, after phase 13's
    programs are dropped.  Returns the replica readout's launches and
    steps for the kernels line."""
    import gc

    from taboo_brittleness_tpu_torch.runtime import aot

    t0 = time.perf_counter()
    aot.reset()                  # phase 13's programs go
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log("phase 14a serve --replica at full width behind a gateway process")
    out = check_replica_gateway(torch, workdir, ctx, sae)
    peak_a = torch.cuda.max_memory_allocated()
    log("phase 14b the serve-fleet, top and trace processes")
    check_fleet_processes(torch, workdir)
    log(f"replica fleet phase: {time.perf_counter() - t0:.2f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated; 14a's {peak_a / 2**30:.2f} GiB)")
    return out


# ---------------------------------------------------------------------------
# Phase 15: the device profile.
# ---------------------------------------------------------------------------

# The study's launch shape: 33 copies of the 10 hint prompts.
STUDY_ROWS = 330


def _profile_invariants(where: str, profile: dict) -> None:
    """The join invariants of ``tools/trace_report.py --check --device``,
    held here on the port's side: launches, slices joined per launch, a
    window join inside its span, the busy union inside the capture, a fused
    split conserving its launches' seconds."""
    progs = profile.get("programs") or []
    if not progs:
        fail(f"{where}: no annotated launch in the profile")
    for rec in progs:
        if rec["slices"] < 1 and not rec.get("truncated"):
            fail(f"{where}: {rec['program']} (span {rec['span_id']}) joined "
                 "no device slice")
        if (rec["joined"] == "window" and rec["device_union_seconds"]
                > rec["window_seconds"] + 1e-6):
            fail(f"{where}: {rec['program']}'s window join outgrows its span")
    dev = profile["device"]
    if dev["busy_union_seconds"] > dev["capture_seconds"] + 1e-6:
        fail(f"{where}: device busy union {dev['busy_union_seconds']} s "
             f"exceeds the capture {dev['capture_seconds']} s")
    split = profile.get("fused_phase_split")
    if split is not None:
        total = sum(c["device_seconds"] for c in split["phases"].values())
        src = split["source_device_seconds"]
        if abs(total - src) > max(1e-3, 0.01 * src):
            fail(f"{where}: the fused split's {total:.6f} s do not conserve "
                 f"the launches' {src:.6f} s")


def _profile_summary(label: str, profile: dict) -> None:
    dev = profile["device"]
    log(f"  {label}: {profile['capture']['device_slices']} device slices, "
        f"{profile['capture']['annotations']} launches; device busy "
        f"{dev['busy_union_seconds']:.4f} s (union) of a "
        f"{dev['capture_seconds']:.4f} s capture: idle share "
        f"{dev['idle_share']:.4f}; unattributed "
        f"{profile['unattributed']['seconds']:.6f} s; after the window "
        f"{profile['capture'].get('overhead_seconds')} s")
    for name, ph in profile["phases"].items():
        log(f"    program {name}: {ph['launches']} launches, device "
            f"{ph['device_seconds']:.6f} s, host window "
            f"{ph['window_seconds']:.6f} s, {ph['slices']} slices")
    for cell in profile["top_ops"][:5]:
        log(f"    top kernel {cell['seconds']:.6f} s x{cell['count']} "
            f"[{cell['class']}] {cell['op'][:90]}")


def _kernel_count(profile: dict, name: str, expected: int) -> int:
    """Slices of kernels named ``name`` in the profile's trace: the counts
    of its ``top_ops`` when they hold ``expected`` of them, else a count
    over the whole trace file parsed again (``top_ops`` keeps 15 names)."""
    from taboo_brittleness_tpu_torch.obs import profile as profile_mod

    n = sum(c["count"] for c in profile["top_ops"] if name in c["op"])
    if n == expected:
        return n
    _, slices = profile_mod.parse_trace_file(profile["capture"]["trace_file"])
    return sum(name in s["name"] for s in slices)


def check_profiled_main_path(torch, workdir: str, ctx: tuple) -> int:
    """15a: phase 6's main path again, through the CLI's ``generate`` (one
    word) and ``logit-lens`` (it and a second word) with ``--profile``
    (``TBX_PROFILE_WORDS=2``), each a sweep observer with its device
    capture.  Returns the wgmma kernels the two traces hold."""
    import dataclasses
    import signal as signal_mod

    from taboo_brittleness_tpu_torch import cli
    from taboo_brittleness_tpu_torch.obs import profile as profile_mod
    from taboo_brittleness_tpu_torch.ops import lens_kernel
    from taboo_brittleness_tpu_torch.runtime import aot
    from taboo_brittleness_tpu_torch.runtime import cache as cache_io

    params, cfg, tok, config, processed6, gen_word = ctx
    lens_word = "moon"
    root = os.path.join(workdir, "profiled")
    processed = os.path.join(root, "processed")
    config = dataclasses.replace(config, output=dataclasses.replace(
        config.output, base_dir=os.path.join(root, "lens"),
        processed_dir=processed))
    patched = {"_load": lambda args: config,
               "_loader": lambda config_, args: (lambda w: (params, cfg, tok)),
               "_tokenizer": lambda config_, args, w: tok}
    saved = {k: getattr(cli, k) for k in patched}
    handlers = {sig: signal_mod.getsignal(sig)
                for sig in (signal_mod.SIGTERM, signal_mod.SIGINT)}
    env = {k: os.environ.get(k) for k in ("TBX_PROFILE", "TBX_PROFILE_WORDS")}
    os.environ["TBX_PROFILE_WORDS"] = "2"
    wgmma0 = lens_kernel.lens_stats.route_launches["wgmma"]
    st0 = aot.stats().get("decode", {})
    t0 = time.perf_counter()
    try:
        for k, v in patched.items():
            setattr(cli, k, v)
        common = ["-c", os.path.join(root, "absent.yaml"), "--device",
                  "cuda", "--processed-dir", processed, "--profile"]
        rc_gen = cli.main(["generate", "--words", gen_word, *common])
        t_gen = time.perf_counter() - t0
        rc_ll = cli.main(["logit-lens", "--words", gen_word, lens_word,
                          *common])
    finally:
        for k, v in saved.items():
            setattr(cli, k, v)
        for sig, h in handlers.items():
            signal_mod.signal(sig, h)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    launched = lens_kernel.lens_stats.route_launches["wgmma"] - wgmma0
    st1 = aot.stats().get("decode", {})
    if rc_gen != 0 or rc_ll != 0:
        fail(f"15a: generate exited {rc_gen}, logit-lens {rc_ll}")
    lens_dir = os.path.join(config.output.base_dir,
                            f"seed_{config.experiment.seed}",
                            config.output.experiment_name)
    profiles = {}
    for label, d in (("generate", processed), ("logit-lens", lens_dir)):
        for name in ("run_manifest.json", "_events.jsonl", "_progress.json",
                     profile_mod.DEVICE_PROFILE_FILENAME):
            path = os.path.join(d, name)
            if not os.path.exists(path) or os.path.getsize(path) == 0:
                fail(f"15a: {label} wrote no {name} in {d}")
        profiles[label] = profile_mod.load_device_profile(
            os.path.join(d, profile_mod.DEVICE_PROFILE_FILENAME))
        _profile_invariants(f"15a {label}", profiles[label])
    log(f"15a profiled generate ({gen_word}) {t_gen:.2f} s, logit-lens "
        f"({gen_word} cached, {lens_word} on the card) "
        f"{wall - t_gen:.2f} s, captures parsed and written included")
    for label, profile in profiles.items():
        _profile_summary(label, profile)
    counted = sum(_kernel_count(p, "lens_wgmma_kernel", cfg.num_layers)
                  for p in profiles.values())
    log(f"  lens_wgmma_kernel: {counted} in the two traces, {launched} "
        "launched by the wrapper over the same window")
    if counted != launched or launched != 2 * cfg.num_layers:
        fail(f"15a: the traces hold {counted} lens_wgmma_kernel, the route "
             f"counter grew by {launched} (expected {2 * cfg.num_layers})")
    misses = st1.get("misses", 0) - st0.get("misses", 0)
    hits = st1.get("hits", 0) - st0.get("hits", 0)
    replayed = [r for r in profiles["logit-lens"]["programs"]
                if r["program"] == "decode"]
    log(f"  decode registry over the window: {misses} miss(es) (the first "
        f"launch's capture), {hits} hit(s); {lens_word}'s graphed decode: "
        + ", ".join(f"{r['slices']} slices joined by {r['joined']}"
                    for r in replayed))
    if misses > 1 or hits < 1 or len(replayed) != 1 \
            or replayed[0]["joined"] != "correlation" \
            or replayed[0]["slices"] < 50:
        fail(f"15a: a profiled sweep must replay its graphs after the first "
             f"launch: {misses} misses, {hits} hits, records {replayed}")
    # The results equal phase 6's unprofiled ones.
    with open(os.path.join(workdir, "results.json")) as f:
        want = json.load(f)
    with open(os.path.join(lens_dir, "logit_lens_evaluation_results.json")) as f:
        got = json.load(f)
    for word in (gen_word, lens_word):
        if got[word]["predictions"] != want[word]["predictions"]:
            fail(f"15a: {word}'s predictions differ from phase 6's")
    for i in range(len(config.prompts)):
        a, _ = cache_io.load_summary(cache_io.summary_path(processed6, gen_word, i))
        b, _ = cache_io.load_summary(cache_io.summary_path(processed, gen_word, i))
        for key in ("token_ids", "agg_topk_ids"):
            if not np.array_equal(a[key], b[key]):
                fail(f"15a: prompt {i}'s {key} differ from phase 6's")
    log(f"  tokens and top-k ids of {len(config.prompts)} prompts and both "
        "words' predictions equal phase 6's")
    return counted


def check_launch_profiles(torch) -> None:
    """15b: ``run_launch_profile`` for ``decode`` and ``readout`` on the
    card (``gemma2_bench`` at 330 rows; 24 new tokens, half the default, to
    halve the decode trace the phase parses)."""
    import gc

    from taboo_brittleness_tpu_torch.obs import profile as profile_mod
    from taboo_brittleness_tpu_torch.runtime import aot

    for phase in ("decode", "readout"):
        t0 = time.perf_counter()
        res = profile_mod.run_launch_profile(
            phase=phase, new_tokens=24,
            trace_dir=os.path.join(tempfile.gettempdir(), f"chip_smoke_{phase}"))
        (rec,) = res["profile"]["programs"]
        log(f"15b {phase} at {res['rows']} rows ({time.perf_counter() - t0:.2f}"
            f" s): {rec['slices']} slices joined by {rec['joined']}, device "
            f"{rec['device_seconds']:.6f} s, host window "
            f"{rec['window_seconds']:.6f} s, registry misses in the profiled "
            f"launch {res['aot_misses']}")
        for line in res["lines"][1:6] + res["lines"][-2:-1]:
            log("  " + line.strip())
        _profile_invariants(f"15b {phase}", res["profile"])
        if rec["slices"] < 1 or rec["joined"] != "correlation":
            fail(f"15b: the {phase} record joined {rec}")
        if phase == "decode" and res["aot_misses"] != 0:
            fail(f"15b: the profiled decode missed the registry "
                 f"{res['aot_misses']} time(s)")
        del res
        aot.reset()
        gc.collect()
        torch.cuda.empty_cache()


def check_fused_profile(torch, ctx: tuple) -> None:
    """15c: one ``dispatch_fused`` launch (the study's baseline at 330
    rows) under a device capture: one ``fused`` record, joined by launch
    correlation, whose phase split sums to its seconds within 1%."""
    from taboo_brittleness_tpu_torch.obs import metrics as obs_metrics
    from taboo_brittleness_tpu_torch.obs import profile as profile_mod
    from taboo_brittleness_tpu_torch.pipelines import interventions as iv

    params, cfg, tok, config, _, word = ctx
    prompts = list(config.prompts) * (STUDY_ROWS // len(config.prompts))
    target = torch.full((len(prompts),), 7, dtype=torch.long,
                        device=params["embed"].device)
    prev = os.environ.get("TBX_FUSED")
    os.environ["TBX_FUSED"] = "1"
    try:
        def launch():
            fr = iv._study_launch(params, cfg, tok, config, prompts,
                                  target_ids=target,
                                  spike_top_k=config.intervention.spike_top_k)
            torch.cuda.synchronize()
            return fr

        t0 = time.perf_counter()
        launch()                    # the graph's capture, outside the window
        t_warm = time.perf_counter() - t0
        counter = obs_metrics.counter("fused.launches")
        launches0 = counter.value
        cap = profile_mod.DeviceCapture(
            os.path.join(tempfile.gettempdir(), "chip_smoke_fused"))
        if not cap.start():
            fail("15c: the device capture did not start")
        t0 = time.perf_counter()
        fr = launch()
        profile = cap.stop()
        t_prof = time.perf_counter() - t0
    finally:
        if prev is None:
            os.environ.pop("TBX_FUSED", None)
        else:
            os.environ["TBX_FUSED"] = prev
    if profile is None:
        fail("15c: the fused launch's capture parsed nothing")
    if counter.value - launches0 != 1 or tuple(fr.tokens.shape)[0] != STUDY_ROWS:
        fail(f"15c: {counter.value - launches0} fused launches of "
             f"{tuple(fr.tokens.shape)}")
    _profile_invariants("15c", profile)
    recs = profile["programs"]
    split = profile.get("fused_phase_split")
    if (len(recs) != 1 or recs[0]["program"] != "fused"
            or recs[0]["joined"] != "correlation" or split is None
            or recs[0].get("phases_in_launch") != ["decode", "readout", "nll"]):
        fail(f"15c: records {recs}, split {split}")
    total = sum(c["device_seconds"] for c in split["phases"].values())
    own = recs[0]["device_seconds"]
    log(f"15c one fused launch at {STUDY_ROWS} rows (warm {t_warm:.2f} s, "
        f"profiled {t_prof:.2f} s with the parse): {recs[0]['slices']} "
        f"slices, device {own:.6f} s; split "
        + ", ".join(f"{p} {c['device_seconds']:.6f} s"
                    for p, c in split["phases"].items())
        + f" (sum {total:.6f} s)")
    _profile_summary("fused", profile)
    if abs(total - own) > 0.01 * own:
        fail(f"15c: the phase split sums to {total:.6f} s, the launch took "
             f"{own:.6f} s")


def drive_device_profile(torch, workdir: str, ctx: tuple) -> dict:
    """Phase 15: the device profile, after phase 14's programs are
    dropped.  Returns the kernels line's ``profiled_launches``."""
    import gc

    from taboo_brittleness_tpu_torch.runtime import aot

    t0 = time.perf_counter()
    aot.reset()                  # phase 14's programs go
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log("phase 15a the main path with --profile")
    counted = check_profiled_main_path(torch, workdir, ctx)
    aot.reset()
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 15b run_launch_profile (decode, readout)")
    check_launch_profiles(torch)
    log("phase 15c one fused study launch under a capture")
    check_fused_profile(torch, ctx)
    aot.reset()
    log(f"device profile phase: {time.perf_counter() - t0:.2f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        "(torch.cuda.max_memory_allocated)")
    return {"profiled_launches": counted}


# ---------------------------------------------------------------------------
# Phase 17: the parity dump at 9B width.
# ---------------------------------------------------------------------------

# 17c's depth cut: the default config's first prompt alone.  Its pair holds
# [42, 63, 256000] f32 (2.71 GB), and every read of it inflates the whole
# array on one host thread.
PARITY_PROMPTS = 1
# The pair's probabilities are the softmax of bf16-rounded lens logits
# (``ops.lens.lens_probs``: the bf16 product's output); the summary's come
# from the kernel's f32 sums over the same bf16 operands.  A logit l rounds
# by up to |l| * 2^-9, which moves P(l) by that much relative to itself.
# P(target) at layer 31 read 4.613e-03 at most (median 6.993e-04) on an
# H100 80GB HBM3 at 700 W; read one column on, 5.854e-02 (median).
PARITY_PROB_RTOL = 0.01


def _round_trip_tokenizer(config, vocab: int):
    """Phase 6's word tokenizer, except that an id outside its words reads
    as the token ``<id N>`` and back, so id -> token -> id is exact for
    every id, as Gemma's tokenizer is.  The pair path
    (``logit_lens.aggregate_response_probs``, the reference's semantics)
    zeroes each position's tokens through that round trip; through phase
    6's tokenizer every generated id outside its word list would come back
    as ``<unk>``, and the pair path would zero ``<unk>`` instead.  Prompts
    encode to phase 6's ids."""
    from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

    class RoundTrip(WordTokenizer):
        def _token(self, i: int) -> str:
            t = self._id_to_token.get(i)
            return t if t is not None else f"<id {i}>"

        def convert_ids_to_tokens(self, ids):
            return [self._token(int(i)) for i in ids]

        def convert_tokens_to_ids(self, tokens):
            return [int(t[4:-1]) if t.startswith("<id ") else self._lookup(t)
                    for t in tokens]

        def decode(self, ids):
            return "".join(" " + t[1:] if t.startswith("▁") else t
                           for t in self.convert_ids_to_tokens(ids))

    words = sorted({w for p in config.prompts for w in p.split()}
                   | set(config.words))
    return RoundTrip(words, vocab_size=vocab)


def probe_parity_memory(torch, ctx: tuple) -> None:
    """17b: ``full_probs_forward`` over the config's 10 prompts at their
    padded 64 columns; the peak device memory held under PEAK_GIB.  Nothing
    is written."""
    from taboo_brittleness_tpu_torch.ops import lens

    params, cfg, _, config = ctx[:4]
    ids, valid, positions = _prompt_args(torch, ctx)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (probs, resid), dt = _synced(torch, lambda: lens.full_probs_forward(
        params, cfg, ids, tap_layer=config.model.layer_idx,
        positions=positions, attn_validity=valid))
    peak = torch.cuda.max_memory_allocated()
    shape, nbytes = tuple(probs.shape), probs.numel() * probs.element_size()
    worst = (probs.sum(dim=-1) - 1).abs().max().item()
    del probs, resid
    torch.cuda.empty_cache()
    log(f"  full_probs_forward over {shape[1]} prompts x {shape[2]} columns: "
        f"all_probs {list(shape)} f32 ({nbytes / 2**30:.2f} GiB) in {dt:.2f} s; "
        f"peak device memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated after a reset; "
        f"{resident / 2**30:.2f} GiB resident before); every row's sum "
        f"within {worst:.3e} of 1")
    if peak > PEAK_GIB * 2**30:
        fail(f"full_probs_forward peaked at {peak / 2**30:.2f} GiB, over "
             f"{PEAK_GIB} GiB")
    if not worst < 1e-3:
        fail(f"full_probs_forward rows sum {worst:.3e} away from 1")


def _pair_argmax(torch, all_probs) -> tuple:
    """Per layer and column of a [L, T, V] dump: the argmax id as
    ``spec-calibrate`` reads it (``np.argmax``: the first index of the
    maximum) and the top-1/top-2 logit gap ``log(p1 / p2)``, read on the
    card one layer at a time."""
    ids, gaps = [], []
    for layer in all_probs:
        ids.append(np.argmax(layer, axis=-1))
        top = torch.from_numpy(layer).cuda().topk(2, dim=-1).values
        gaps.append((top[:, 0].log() - top[:, 1].log()).double().cpu().numpy())
        del top
    return np.stack(ids), np.stack(gaps)


def _clear_ranks(summed: np.ndarray, k: int, rtol: float) -> list:
    """Ranks 0..k-1 of the descending ``summed`` whose neighbours both sit
    more than ``rtol`` (relative) away: two sums each within rtol / 2 of
    their own value cannot swap them."""
    s = np.sort(summed)[::-1][:k + 1]
    clear = []
    for i in range(k):
        above = i == 0 or s[i - 1] - s[i] > rtol * s[i - 1]
        below = s[i] - s[i + 1] > rtol * s[i]
        if above and below:
            clear.append(i)
    return clear


def check_parity_dump(torch, workdir: str, ctx: tuple) -> dict:
    """17c-e (see the module docstring).  Returns the kernels line's
    ``parity_launches``."""
    from taboo_brittleness_tpu_torch import cli
    from taboo_brittleness_tpu_torch.ops import lens_kernel
    from taboo_brittleness_tpu_torch.perf import spec_calibrate
    from taboo_brittleness_tpu_torch.pipelines import generation, logit_lens
    from taboo_brittleness_tpu_torch.runtime import cache as cache_io
    from taboo_brittleness_tpu_torch.runtime import chat, native_io
    from taboo_brittleness_tpu_torch.runtime.tokenizer import target_token_id

    import dataclasses

    params, cfg, _, config = ctx[:4]
    word = ctx[5]
    one = dataclasses.replace(config, prompts=config.prompts[:PARITY_PROMPTS])
    tok = _round_trip_tokenizer(config, cfg.vocab_size)
    layer, top_k = one.model.layer_idx, one.model.top_k
    root = os.path.join(workdir, "parity")
    pair_dir, summ_dir = (os.path.join(root, d) for d in ("pairs", "summaries"))

    # 17c: the pair through the pipeline, every npz write recorded.
    writes, real_save = [], native_io.save_npz

    def recording_save(path, arrays, **kw):
        t0 = time.perf_counter()
        out = real_save(path, arrays, **kw)
        writes.append({"arrays": arrays, "seconds": time.perf_counter() - t0,
                       "threads": native_io.threads(kw.get("n_threads", 0))})
        return out

    native_io.save_npz = recording_save
    try:
        torch.cuda.reset_peak_memory_stats()
        done, t_pair = _synced(torch, lambda: generation.generate_for_word(
            params, cfg, tok, one, word, processed_dir=pair_dir,
            parity_dump=True))
        peak = torch.cuda.max_memory_allocated()
        lens_kernel.lens_stats.launches = 0
        lens_kernel.lens_stats.route_launches.update(
            dict.fromkeys(lens_kernel.lens_stats.route_launches, 0))
        done_s, t_summ = _synced(torch, lambda: generation.generate_for_word(
            params, cfg, tok, one, word, processed_dir=summ_dir))
        launches = dict(lens_kernel.lens_stats.route_launches)
    finally:
        native_io.save_npz = real_save
    if done != list(range(PARITY_PROMPTS)) or done_s != done or len(writes) != 2:
        fail(f"parity generate wrote {done} / {done_s}, {len(writes)} npz files")
    if launches != {"splitv": 0, "wgmma": cfg.num_layers, "splitv_refill": 0,
                    "wgmma_refill": 0}:
        fail(f"the summary's lens pass launched {launches}; expected "
             f"{cfg.num_layers} on the wgmma route")
    npz_path, json_path = cache_io.pair_paths(pair_dir, word, 0)
    pair_write = writes[0]
    all_probs = pair_write["arrays"]["all_probs"]
    resid = pair_write["arrays"][f"residual_stream_l{layer}"]
    raw = sum(a.nbytes for a in pair_write["arrays"].values())
    on_disk = os.path.getsize(npz_path)
    with open(json_path) as f:
        pair_meta = json.load(f)
    summ, summ_meta = cache_io.load_summary(
        cache_io.summary_path(summ_dir, word, 0))
    L, T, V = all_probs.shape
    log(f"  generate --parity-dump ({PARITY_PROMPTS} of "
        f"{len(config.prompts)} prompts): {t_pair:.2f} s, peak device memory "
        f"{peak / 2**30:.2f} GiB; the same prompt's summary cache "
        f"{t_summ:.2f} s, lens kernel launches {launches}")
    log(f"  pair all_probs {[L, T, V]} f32 + residual {list(resid.shape)}: "
        f"{raw} B raw, {on_disk} B on disk (ratio {raw / on_disk:.3f}); "
        f"save_npz {pair_write['seconds']:.2f} s on "
        f"{pair_write['threads']} threads = {raw / pair_write['seconds'] / 1e9:.3f} "
        f"GB/s raw in, {on_disk / pair_write['seconds'] / 1e9:.3f} GB/s out")
    tmp = os.path.join(root, "yardstick.npz")
    t0 = time.perf_counter()
    np.savez_compressed(tmp, all_probs=all_probs[layer:layer + 1])
    t_np = time.perf_counter() - t0
    os.remove(tmp)
    log(f"  yardstick: np.savez_compressed of one layer's [1, {T}, {V}] "
        f"slice {t_np:.2f} s ({all_probs[0].nbytes / t_np / 1e9:.3f} GB/s, "
        f"one thread); scaled x {L} (not measured at that size): "
        f"{t_np * L:.1f} s against the writer's {pair_write['seconds']:.2f} s")

    if (summ["target_prob"].shape != (L, T)
            or pair_meta["input_words"] != summ_meta["input_words"]):
        fail(f"pair {[L, T]} vs summary {summ['target_prob'].shape}, or "
             "other input words")
    resid_err = float(np.linalg.norm(resid - summ["residual"])
                      / np.linalg.norm(summ["residual"]))
    log(f"  residual_stream_l{layer} vs the summary's residual: relative L2 "
        f"{resid_err:.3e} (bit-equal {np.array_equal(resid, summ['residual'])})")
    if not resid_err <= 1e-3:
        fail(f"the pair's residual is {resid_err:.3e} from the summary's")
    tid = target_token_id(tok, word)
    tp_pair = all_probs[layer, :, tid].astype(np.float64)
    tp_summ = summ["target_prob"][layer].astype(np.float64)
    rel = np.abs(tp_pair - tp_summ) / tp_summ
    shifted = np.median(np.abs(tp_pair[1:] - tp_summ[:-1]) / tp_summ[:-1])
    log(f"  P(target) at layer {layer}: pair vs summary max relative error "
        f"{rel.max():.3e}, median {np.median(rel):.3e} (tolerance "
        f"{PARITY_PROB_RTOL}); read one column on, median {shifted:.3e}")
    if not rel.max() <= PARITY_PROB_RTOL or not shifted > PARITY_PROB_RTOL:
        fail("the pair's P(target) does not hold to the summary's, or a "
             "shifted read holds too")
    pair_ids, gaps = _pair_argmax(torch, all_probs)
    clear = gaps > SPEC_MARGIN
    wrong = clear & (pair_ids != summ["argmax_id"])
    log(f"  argmax ids, all {L} layers: {int(clear.sum())} of {L * T} "
        f"positions clear (top-1/top-2 gap > {SPEC_MARGIN}), {int(wrong.sum())} "
        f"of them differ from the summary's; at layer {layer}: "
        f"{int(clear[layer].sum())} clear, {int(wrong[layer].sum())} differ")
    if wrong.any():
        fail(f"the pair's argmax differs from the summary's at "
             f"{np.argwhere(wrong)[:5].tolist()} (layer, column)")

    # 17d: logit-lens over each cache; the pair's load is the round trip.
    loads, real_load = [], cache_io.load_pair

    def recording_load(*args, **kw):
        loads.append(real_load(*args, **kw))
        return loads[-1]

    cache_io.load_pair = recording_load
    try:
        res_pair, t_ll = _synced(torch, lambda: logit_lens.run_evaluation(
            one, tok, words=[word], processed_dir=pair_dir,
            output_path=os.path.join(root, "pair_results.json")))
    finally:
        cache_io.load_pair = real_load
    res_summ = logit_lens.run_evaluation(
        one, tok, words=[word], processed_dir=summ_dir,
        output_path=os.path.join(root, "summary_results.json"))
    if len(loads) != 1:
        fail(f"logit-lens over the pair cache loaded {len(loads)} pairs")
    back = loads[0]
    round_trip = (np.array_equal(back.all_probs.view(np.uint32),
                                 all_probs.view(np.uint32))
                  and np.array_equal(back.residual_stream.view(np.uint32),
                                     resid.view(np.uint32)))
    start = chat.find_model_response_start(pair_meta["input_words"])
    summed = logit_lens.aggregate_response_probs(
        all_probs[layer, start:], pair_meta["input_words"][start:], tok)
    ranks = _clear_ranks(summed, top_k, 2 * PARITY_PROB_RTOL)
    got, want = res_pair[word]["predictions"][0], res_summ[word]["predictions"][0]
    differ = [i for i in ranks if got[i] != want[i]]
    top = np.sort(summed)[::-1][:top_k + 1].astype(np.float64)
    agg = summ["agg_topk_probs"].astype(np.float64)
    agg_err = np.abs(summed[summ["agg_topk_ids"]] - agg) / agg
    log(f"  logit-lens over the pair {t_ll:.2f} s (np.load inflating "
        f"{all_probs.nbytes} B included); round trip bit-equal {round_trip}; "
        f"top-{top_k} {got} vs over the summary {want}; the pair's summed "
        f"probabilities of the summary's guesses within {agg_err.max():.3e} "
        f"(relative) of the summary's; neighbouring sums apart by "
        f"{np.round((top[:-1] - top[1:]) / top[:-1], 4).tolist()} (relative); "
        f"clear ranks {ranks} (more than {2 * PARITY_PROB_RTOL} apart), "
        f"differing {differ}")
    if (not round_trip or differ or len(got) != len(want)
            or not agg_err.max() <= PARITY_PROB_RTOL):
        fail("logit-lens over the pair cache does not hold to the summary "
             "cache, or the pair did not load back bit-equal")

    # 17e: spec-calibrate over each cache, through the CLI.  Its np.load of
    # the pair is handed 17d's inflated arrays, which 17d held bit-equal to
    # what was written: a second inflate of the same file reads nothing new.
    arts, secs, real_np_load, served = {}, {}, np.load, []

    class Inflated(dict):
        files = property(lambda self: list(self))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def pair_load(path, *args, **kw):
        if os.path.abspath(path) != os.path.abspath(npz_path):
            return real_np_load(path, *args, **kw)
        served.append(os.path.abspath(path))
        return Inflated(all_probs=back.all_probs, **{
            f"residual_stream_l{layer}": back.residual_stream})

    for name, d in (("pair", pair_dir), ("summary", summ_dir)):
        out = os.path.join(root, f"calibration-{name}.json")
        np.load = pair_load
        try:
            rc, secs[name] = _synced(torch, lambda: cli.main([
                "spec-calibrate", "-c", os.path.join(root, "absent.yaml"),
                "--processed-dir", d, "--words", word, "--out", out]))
        finally:
            np.load = real_np_load
        with open(out) as f:
            arts[name] = json.load(f)
        if rc != 0:
            fail(f"spec-calibrate over the {name} cache: exit {rc}")
    s_start = int(summ_meta["response_start"])
    vec_pair = spec_calibrate.layer_agreement(pair_ids, start)
    vec_summ = spec_calibrate.layer_agreement(summ["argmax_id"], s_start)
    window = clear[:, start:]
    excused = (~window | ~window[-1:]).sum(axis=1)
    moved = np.rint(np.abs(vec_pair - vec_summ) * (T - start)).astype(int)
    plan = arts["pair"]["words"][word]
    read = round(float(vec_pair[plan["draft_layer"]]), 4)
    log(f"  spec-calibrate over the pair {secs['pair']:.2f} s (its np.load "
        f"handed 17d's arrays), over the summary {secs['summary']:.2f} s; "
        "response window from column "
        f"{start} (pair) / {s_start} (summary) of {T}; per-layer agreement "
        f"equal on {int((vec_pair == vec_summ).sum())}/{L} layers, "
        f"{int(moved.sum())} columns moved, {int(excused.sum())} excused by "
        f"the gap rule (summed over layers); plans "
        f"{arts['pair']['words'][word]} / {arts['summary']['words'][word]}")
    if served != [os.path.abspath(npz_path)]:
        fail(f"spec-calibrate read the pair {len(served)} times, not once")
    if (start != s_start or (moved > excused).any()
            or plan["agreement"] != read
            or (np.array_equal(vec_pair, vec_summ)
                and arts["pair"]["words"] != arts["summary"]["words"])):
        fail("spec-calibrate over the pair cache does not hold to the "
             "summary cache")
    return {"parity_launches": launches["wgmma"]}


def drive_parity_dump(torch, workdir: str, ctx: tuple) -> dict:
    """Phase 17: the parity-dump path at 9B width, after phase 15's
    programs are dropped; its tensors go before phase 16."""
    import gc

    from taboo_brittleness_tpu_torch.runtime import aot

    t0 = time.perf_counter()
    aot.reset()                  # phase 15's programs go
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 17b full_probs_forward's peak at 10 prompts x 64 columns")
    probe_parity_memory(torch, ctx)
    log("phase 17c-e generate --parity-dump, logit-lens and spec-calibrate "
        "over the pair")
    out = check_parity_dump(torch, workdir, ctx)
    aot.reset()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"parity dump phase: {time.perf_counter() - t0:.2f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 16: tensor and sequence parallelism, two ranks on the one card.
# ---------------------------------------------------------------------------

TP_RANKS = 2
# 16c's sequence: longer than Gemma-2's 4096-column sliding window, so the
# sliding layers' window crosses the sp ranks' boundary.
SP_T = 5120
# 16b's load: 8 requests (one per slot) of phase 11d's uniform mix over
# SERVE_MIX at 50/s, from the seed whose first 8 hold every scenario
# (seed 6: sae_ablate twice, chat_lens, projection and forcing once each).
TP_LOAD_REQUESTS = 8
TP_LOAD_SEED = 6
TP_SPEC_NEW = 4
# 16a decodes this many tokens per prompt (the main path's 50 cut for
# time: each tp decode step waits on ~84 host-staged all-reduces).
TP_NEW_TOKENS = 8
# Steps timed of the tp serve step (each ~0.25-0.6 s over gloo).
TP_STEP_REPS = 8


def _tp_config(config):
    """Phase 16a's config: the default one at TP_NEW_TOKENS new tokens."""
    import dataclasses

    return dataclasses.replace(config, experiment=dataclasses.replace(
        config.experiment, max_new_tokens=TP_NEW_TOKENS))
# bf16 sums in another order (the tp all-reduce, the ring's flash merge)
# move lens probabilities by a few percent of themselves: a guess or a
# top-k id is held equal where its sum or logit leads the next by more.
AGG_GAP_RTOL = 0.05
# The sp pass's tap-layer residual against the dense one, relative L2.
SP_RESID_RTOL = 0.05
# A tp lens probability against the unsharded one, relative: the tapped
# residual differs by bf16 rounding of the row-parallel sums, and a lens
# logit moved by d moves P(target) by exp(d) - 1.  Set from the readings
# of phase 16 on the H100: the witness (``split_row_parallel``: the
# unsharded forward with the tp forward's rounding of its o and down
# products, one process) read 0.093 in 16a (tp 2 the same 0.093, 3.9e-06
# from the witness) and 0.056 in 16b (tp 2: 0.066), 16c's sp pass 0.087;
# a target shifted by one id (16a's planted fault) read a median of 0.79,
# over 0.15 on 92% of rows.
TP_PROB_RTOL = 0.15


@contextlib.contextmanager
def split_row_parallel(torch, params, parts: int = TP_RANKS):
    """The unsharded forward with the tp forward's arithmetic on its
    row-parallel products: every ``o`` and ``down`` product of ``params``
    computed per ``parts`` slice of its contraction, each slice's product
    rounded to the compute dtype and the slices summed, as ``parts`` tp
    ranks and their all-reduce (f32 on the wire, one rounding back) compute
    it.  Yields a dict whose ``calls`` counts the products split."""
    from torch.overrides import TorchFunctionMode

    layers = params["layers"]
    split = {layers[name][i].data_ptr() for name in ("o", "down")
             for i in range(layers[name].shape[0])}
    seen = {"calls": 0}

    class Split(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if (func in (torch.Tensor.matmul, torch.Tensor.__matmul__)
                    and not kwargs
                    and isinstance(args[1], torch.Tensor)
                    and args[1].dim() == 2
                    and args[1].data_ptr() in split):
                a, w = args
                seen["calls"] += 1
                h = w.shape[0] // parts
                out = None
                for j in range(parts):
                    y = (a[..., j * h:(j + 1) * h] @ w[j * h:(j + 1) * h])
                    out = y.float() if out is None else out + y.float()
                return out.to(y.dtype)
            return func(*args, **(kwargs or {}))

    with Split():
        yield seen


def _rel_gap(a, b) -> float:
    """Max relative difference of ``a`` from ``b`` (float64)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / b).max()) if b.size else 0.0


def _rank_setup(torch, rank: int):
    """A phase-16 rank: the port on the path, TF32 off.  Its card is the
    one the join gave it (``LOCAL_RANK % device_count``: card 0 here)."""
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rank_model(torch, mesh):
    """Phase 6's model on a rank: the same seed's weights, drawn leaf by
    leaf and sliced to this rank's shard (whole params under an sp mesh),
    the word tokenizer and config.  Returns (params, cfg, tok, config,
    seconds)."""
    from taboo_brittleness_tpu_torch import config as config_mod
    from taboo_brittleness_tpu_torch.models import gemma2
    from taboo_brittleness_tpu_torch.parallel.mesh import tp_size
    from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

    config = config_mod.Config(output=config_mod.OutputConfig(save_plots=False))
    cfg = gemma2.PRESETS["gemma2_9b"]
    t0 = time.perf_counter()
    params = gemma2.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
        mesh=mesh if tp_size(mesh) > 1 else None)
    torch.cuda.synchronize()
    words = sorted({w for p in config.prompts for w in p.split()}
                   | set(config.words))
    tok = WordTokenizer(words, vocab_size=cfg.vocab_size)
    return params, cfg, tok, config, time.perf_counter() - t0


def _shard_kernel(torch, embed_shard, n: int, k: int) -> dict:
    """One per-shard ``lens_stats`` call (this rank's [V/tp, D] rows, the
    targets a tp readout hands the shard: in-range ids and -1 outside it)
    against ``lens_stats_reference`` on the same inputs, and timed beside
    the plain version, the library yardstick and the bound."""
    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk

    v, d = embed_shard.shape
    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
    tgt = torch.randint(0, v, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    tgt[::2] = -1
    route = lk.lens_plan(n, v, k, torch.bfloat16).route
    before = dict(lk.lens_stats.route_launches)
    got = lk.lens_stats(x, embed_shard, tgt, top_k=k)
    ref = lk.lens_stats_reference(x, embed_shard, tgt, top_k=k + 1)
    torch.cuda.synchronize()
    err, n_clear, n_bad = compare(got, ref, k)
    out = {"n": n, "v": v, "k": k, "max_abs_err": err, "clear": n_clear,
           "bad": n_bad, "route": route,
           "launches": {r: c - before[r] for r, c in
                        lk.lens_stats.route_launches.items() if c != before[r]}}

    def kernel():
        lk.lens_stats(x, embed_shard, tgt, top_k=k)

    def plain():
        lk.lens_stats_reference(x, embed_shard, tgt, top_k=k)

    def library():
        # tbx: f32-ok — the library yardstick forms the [N, V] f32 logits
        logits = torch.matmul(x, embed_shard.T).float()
        torch.logsumexp(logits, dim=-1)
        torch.topk(logits, k, dim=-1)

    if n > SERVE_SLOTS:
        out["ms"] = timed_ms(torch, kernel, 10)
        out["library_ms"] = timed_ms(torch, library, 10)
    else:   # small calls: queued behind a sleep kernel, as 11f times them
        out["ms"] = backlogged_ms(torch, kernel, 20)[0]
        out["library_ms"] = backlogged_ms(torch, library, 20)[0]
    out["plain_ms"] = timed_ms(torch, plain, 3)
    out["bound_ms"], out["bound_by"] = lens_bound_ms(n, d, v, k)
    return out


def _merged_readout(torch, mesh, embed_shard, job: dict) -> dict:
    """16a on a rank: ``tp_lens_stats`` (this rank's per-shard kernel, the
    partials merged over the ranks) on ``job``'s rows and whole-vocabulary
    targets, and again with every target shifted by one id (a planted
    fault in the shift)."""
    from taboo_brittleness_tpu_torch.parallel.mesh import tp_lens_stats

    x, t = job["x"].cuda(), job["t"].cuda()
    got = tp_lens_stats(mesh, x, embed_shard, t, top_k=TOP_K)
    planted = tp_lens_stats(mesh, x, embed_shard,
                            torch.where(t >= 0, t + 1, t), top_k=TOP_K)
    return {"stats": [a.cpu() for a in got],
            "planted": planted.target_prob().cpu()}


def _collective_ms(torch, mesh) -> dict:
    """Host-clock ms of one tp ``all_reduce`` of a serve step's activation
    ([8, 1, 3584] bf16) on the card (staged through the host) and of the
    same tensor on the host, over 50 calls each: what one collective of a
    tp step costs over gloo with both ranks on the one card."""
    x = torch.ones((SERVE_SLOTS, 1, HIDDEN), dtype=torch.bfloat16,
                   device="cuda")
    out = {}
    for where, t in (("card", x), ("host", x.cpu())):
        mesh.all_reduce(t, "tp")
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(50):
            mesh.all_reduce(t, "tp")
        out[where] = (time.perf_counter() - t0) / 50 * 1e3
    return out


def _tp_lens(torch, mesh, params, cfg, tok, config, out_dir) -> dict:
    """16a on a rank: ``run_evaluation`` for "ship" through the model (no
    cache), over the tp mesh; the lens pass profiled (its
    ``lens_wgmma_kernel`` slices counted by name) and the kernel's counter
    set to 0 just before the run and read just after."""
    from torch.profiler import ProfilerActivity, profile

    from taboo_brittleness_tpu_torch.ops import lens, lens_kernel
    from taboo_brittleness_tpu_torch.pipelines import logit_lens

    real, traced = lens.lens_forward, {}

    def profiled(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = real(*a, **kw)
            torch.cuda.synchronize()
        traced["seconds"] = time.perf_counter() - t0
        traced["wgmma"] = sum("lens_wgmma_kernel" in e.name
                              for e in _device_kernels(prof))
        traced["topk"] = (res.tap.topk_ids.cpu().numpy(),
                          res.tap.topk_probs.float().cpu().numpy())
        return res

    def analyze(*a, **kw):
        traced["analysis"] = real_analyze(*a, **kw)
        return traced["analysis"]

    real_analyze = logit_lens.analyze_word_on_device
    lens.lens_forward, logit_lens.analyze_word_on_device = profiled, analyze
    lens_kernel.lens_stats.launches = 0
    lens_kernel.lens_stats.route_launches.update(
        dict.fromkeys(lens_kernel.lens_stats.route_launches, 0))
    try:
        t0 = time.perf_counter()
        results = logit_lens.run_evaluation(
            config, tok, words=["ship"],
            model_loader=lambda word: (params, cfg, tok),
            processed_dir=os.path.join(out_dir, "processed"),
            output_path=os.path.join(out_dir, "results.json"), mesh=mesh)
        seconds = time.perf_counter() - t0
    finally:
        lens.lens_forward = real
        logit_lens.analyze_word_on_device = real_analyze
    a = traced["analysis"]
    return {"predictions": results["ship"]["predictions"],
            "guess_ids": a.guess_ids, "sequences": a.sequences,
            "target_probs": a.target_probs, "topk": traced["topk"],
            "seconds": seconds,
            "lens_seconds": traced["seconds"], "profiled": traced["wgmma"],
            "launches": lens_kernel.lens_stats.launches,
            "by_route": dict(lens_kernel.lens_stats.route_launches),
            "wrote": os.path.exists(os.path.join(out_dir, "results.json"))}


def _tp_serve(torch, mesh, params, cfg, tok, config, ids) -> dict:
    """16b on a rank (rank 0 drives, rank 1 follows): phase 11's 8-slot
    engine over 16b's TP_LOAD_REQUESTS requests, step ms over
    8 sessions with one profiled step, then the speculative engine over the
    8 sessions."""
    from taboo_brittleness_tpu_torch.ops import sae as sae_ops
    from taboo_brittleness_tpu_torch.runtime import aot
    from taboo_brittleness_tpu_torch.runtime.tokenizer import target_token_id
    from taboo_brittleness_tpu_torch.serve import engine as engine_mod
    from taboo_brittleness_tpu_torch.serve import loadgen, spec_engine
    from taboo_brittleness_tpu_torch.serve.scheduler import default_scenarios

    sae = sae_ops.init_random(torch.Generator(device="cuda").manual_seed(3),
                              cfg.hidden_size, SAE_WIDTH, device="cuda")
    tgt = target_token_id(tok, "moon")
    layer = config.model.layer_idx
    out = {}
    engine = engine_mod.ServeEngine(params, cfg, tok, sae=sae, mesh=mesh,
                                    engine_config=_serve_config(layer))
    if mesh.rank > 0:
        engine.follow()
    else:
        streams = {}
        t0 = time.perf_counter()
        report = loadgen.run_inprocess(
            engine, n_requests=TP_LOAD_REQUESTS, seed=TP_LOAD_SEED,
            rate=50.0, concurrency=16, mix={name: 1.0 for name in SERVE_MIX},
            scenarios=default_scenarios(), lens_target_id=tgt,
            on_complete=lambda r: streams.__setitem__(
                r.id, (r.scenario, list(r.tokens), r.lens_probs)))
        out["load_seconds"] = time.perf_counter() - t0
        out["streams"], out["goodput"] = streams, report["goodput"]
        out["steps"] = engine.steps
        out["timing"] = _time_engine_steps(torch, engine, ids, tgt,
                                           "tp 2 (gloo, eager)",
                                           reps=TP_STEP_REPS)
        out["aot"] = {k: v for k, v in aot.stats().items()
                      if k.startswith("serve.")}
        out["graph"] = engine.graph_record()
        engine.close()
    del engine
    spec = spec_engine.SpecServeEngine(
        params, cfg, tok, sae=sae, mesh=mesh, draft_layer=2, block_size=3,
        engine_config=_serve_config(layer))
    if mesh.rank > 0:
        spec.follow()
    else:
        spec.warm_start()
        for s, row in enumerate(ids):
            spec.admit(s, row, max_new=TP_SPEC_NEW, lens_target=tgt)
        toks = {s: [] for s in range(len(ids))}
        t0 = time.perf_counter()
        while spec.any_alive():
            o = spec.step()
            for s in toks:
                toks[s].extend(int(t) for t, e in zip(o.toks[s], o.emit[s])
                               if e)
        out["spec_seconds"] = time.perf_counter() - t0
        out["spec_tokens"] = toks
        out["spec_stats"] = spec.accept_stats()
        out["spec_name"] = spec.aot_verify
        spec.close()
    return out


def tp_rank(rank: int, job: dict) -> dict:
    """Phase 16a-b on one of the tp ranks (spawned by ``run_ranks``)."""
    import torch

    _rank_setup(torch, rank)
    from taboo_brittleness_tpu_torch.config import MeshConfig
    from taboo_brittleness_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(dp=1, tp=TP_RANKS, sp=1))
    torch.cuda.reset_peak_memory_stats()
    params, cfg, tok, config, t_params = _rank_model(torch, mesh)
    out = {"rank": rank, "mesh": mesh.record(), "params_seconds": t_params,
           "embed_rows": int(params["embed"].shape[0]),
           "params_device": str(params["embed"].device)}
    out["lens"] = _tp_lens(torch, mesh, params, cfg, tok, _tp_config(config),
                           os.path.join(job["workdir"], f"lens{rank}"))
    out["merged"] = _merged_readout(torch, mesh, params["embed"], job["merge"])
    mesh.barrier()
    if rank == 0:      # the card is rank 0's while rank 1 waits
        out["shard_main"] = _shard_kernel(torch, params["embed"], N_ROWS, TOP_K)
        out["shard_serve"] = _shard_kernel(torch, params["embed"],
                                           SERVE_SLOTS, 1)
    mesh.barrier()
    out["collective_ms"] = _collective_ms(torch, mesh)
    out["serve"] = _tp_serve(torch, mesh, params, cfg, tok, config,
                             job["ids"])
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def sp_rank(rank: int, job: dict) -> dict:
    """Phase 16c on one of the sp ranks: ``lens_forward_sp`` at sp 2 over
    one SP_T-column row, and on rank 0 the dense ``lens_forward`` of it."""
    import torch

    _rank_setup(torch, rank)
    from taboo_brittleness_tpu_torch.config import MeshConfig
    from taboo_brittleness_tpu_torch.ops import lens
    from taboo_brittleness_tpu_torch.parallel import sp as splib
    from taboo_brittleness_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(dp=1, tp=1, sp=TP_RANKS))
    torch.cuda.reset_peak_memory_stats()
    params, cfg, tok, config, t_params = _rank_model(torch, mesh)
    gen = torch.Generator(device="cuda").manual_seed(16)
    ids = torch.randint(3, cfg.vocab_size, (1, SP_T), generator=gen,
                        device="cuda")
    target = torch.tensor([ids[0, -1].item()], device="cuda")
    layer = config.model.layer_idx
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = splib.lens_forward_sp(params, cfg, ids, target, mesh,
                                tap_layer=layer, top_k=TOP_K)
    torch.cuda.synchronize()
    out = {"rank": rank, "mesh": mesh.record(), "params_seconds": t_params,
           "params_device": str(params["embed"].device),
           "sp_seconds": time.perf_counter() - t0}
    mesh.barrier()
    if rank == 0:
        t0 = time.perf_counter()
        dense = lens.lens_forward(params, cfg, ids, target, tap_layer=layer,
                                  top_k=TOP_K)
        torch.cuda.synchronize()
        out["dense_seconds"] = time.perf_counter() - t0
        # A lens logit gap is the log of a probability ratio.
        logp = dense.tap.topk_probs.float().log()
        gaps = logp[..., :-1] - logp[..., 1:]
        clear1 = gaps[..., 0] > SPEC_MARGIN
        # The first K - 1 ids are fixed by the K - 1 gaps the top-K holds;
        # the K-th also needs the gap to the (K+1)-th, which it does not.
        clear = (gaps > SPEC_MARGIN).all(dim=-1)
        same1 = got.tap.topk_ids[..., 0] == dense.tap.topk_ids[..., 0]
        same = (got.tap.topk_ids[..., :-1]
                == dense.tap.topk_ids[..., :-1]).all(dim=-1)
        rel = ((got.tap.target_prob - dense.tap.target_prob).abs()
               / dense.tap.target_prob)
        out.update(
            positions=int(clear1.numel()), clear=int(clear1.sum().item()),
            bad=int((clear1 & ~same1).sum().item()),
            clear_k=int(clear.sum().item()),
            bad_k=int((clear & ~same).sum().item()),
            prob_err=float((got.tap.topk_probs - dense.tap.topk_probs).abs()
                           .div(dense.tap.topk_probs).max().item()),
            target_err=float(rel.max().item()),
            target_err_median=float(rel.median().item()),
            resid_rel=float(((got.residual - dense.residual).norm()
                             / dense.residual.norm()).item()),
            finite=bool(torch.isfinite(got.residual).all().item()))
        del dense
    mesh.barrier()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def check_tp_lens(torch, ref, ref_sums, ref_topk, ranks, margins,
                  witness) -> None:
    """16a: the tp lens pass against the unsharded one: tokens under the
    margin rule; on rows of equal tokens, P(target) within TP_PROB_RTOL of
    itself (beside the witness's reading of the same gap), the
    per-position top-k ids where their logit gaps exceed SPEC_MARGIN (the
    first K - 1, as in 16c), and the guesses where the reference's summed
    probabilities lead the next by more than AGG_GAP_RTOL of
    themselves."""
    r0, r1 = (r["lens"] for r in ranks)
    log(f"  tp 2 run_evaluation (ship, through the model): {r0['seconds']:.2f} "
        f"s on rank 0, lens pass {r0['lens_seconds']:.2f} s (profiled); lens "
        f"kernel launches per rank {r0['launches']}, {r1['launches']} (by "
        f"route {r0['by_route']}), lens_wgmma_kernel slices in the profiled "
        f"pass {r0['profiled']}, {r1['profiled']}; results written by rank 0 "
        f"{r0['wrote']}, rank 1 {r1['wrote']}")
    for r in (r0, r1):
        if r["launches"] != 42 or r["by_route"]["wgmma"] != 42 \
                or r["profiled"] != 42:
            fail(f"16a: a rank's lens pass launched {r['launches']} kernels "
                 f"({r['by_route']}), {r['profiled']} in its trace; 42 each")
    if not r0["wrote"] or r1["wrote"]:
        fail("16a: rank 0 alone must write the results")
    if r0["guess_ids"] != r1["guess_ids"]:
        fail("16a: the two tp ranks hold other guesses")
    equal_rows, worst, gap_w, tp_w, scale = [], 0.0, 0.0, 0.0, []
    for b, (got, want) in enumerate(zip(r0["sequences"], ref.sequences)):
        if got == want:
            equal_rows.append(b)
            worst = max(worst, _rel_gap(r0["target_probs"][b],
                                        ref.target_probs[b]))
            scale.append(np.asarray(ref.target_probs[b], np.float64).ravel())
            if witness.sequences[b] == want:
                gap_w = max(gap_w, _rel_gap(witness.target_probs[b],
                                            ref.target_probs[b]))
                tp_w = max(tp_w, _rel_gap(r0["target_probs"][b],
                                          witness.target_probs[b]))
            continue
        start = len(want) - len(margins[b]) if len(margins[b]) else 0
        first = next(i for i, (a, c) in enumerate(zip(got, want)) if a != c) \
            if len(got) == len(want) else min(len(got), len(want))
        m = margins[b][first - start] if 0 <= first - start < len(margins[b]) \
            else float("inf")
        log(f"  16a row {b}: tokens first differ at {first} (unsharded "
            f"margin {m:.4f})")
        if not m < SPEC_MARGIN:
            fail(f"16a row {b} diverges at a margin >= {SPEC_MARGIN}")
    k = len(ref.guess_ids[0])
    gaps = (ref_sums[:, :-1] - ref_sums[:, 1:]) / np.maximum(ref_sums[:, :-1],
                                                             1e-30)
    clear = [b for b in equal_rows if (gaps[b, :k] > AGG_GAP_RTOL).all()]
    bad = [b for b in clear if r0["guess_ids"][b] != ref.guess_ids[b]]
    same_guess = sum(r0["guess_ids"][b] == ref.guess_ids[b] for b in equal_rows)
    log(f"  tokens equal on {len(equal_rows)}/{len(ref.sequences)} rows; of "
        f"those, guess ids equal on {same_guess} ({len(clear)} with every "
        f"summed-probability gap over {AGG_GAP_RTOL} of itself, {len(bad)} "
        f"differ there); predictions {r0['predictions'][:2]}...")
    median = float(np.median(np.concatenate(scale))) if scale else 0.0
    log(f"  P(target) on rows of equal tokens (median {median:.3e}): tp 2 vs "
        f"unsharded max relative diff {worst:.3e} (rtol {TP_PROB_RTOL}); the "
        f"witness (split o/down sums, one process) vs unsharded {gap_w:.3e}, "
        f"tp 2 vs the witness {tp_w:.3e}")
    if worst > TP_PROB_RTOL:
        fail(f"16a: P(target) differs by {worst} (relative) on rows of equal "
             "tokens")
    if bad:
        fail(f"16a: rows {bad} guess otherwise where the margin is clear")
    # Per-position top-k of the lens pass ([L, B, T, K]) on rows of equal
    # tokens; pad columns are the same tokens on both sides.
    ids_g, _ = r0["topk"]
    ids_w, probs_w = ref_topk
    logp = np.log(probs_w[:, equal_rows])
    clear = ((logp[..., :-1] - logp[..., 1:]) > SPEC_MARGIN).all(axis=-1)
    same = (ids_g[:, equal_rows, :, :-1] == ids_w[:, equal_rows, :, :-1]
            ).all(axis=-1)
    log(f"  per-position lens top-{ids_w.shape[-1]}: the first "
        f"{ids_w.shape[-1] - 1} ids equal on "
        f"{int((clear & same).sum())}/{int(clear.sum())} (layer, position) "
        f"pairs whose gaps exceed {SPEC_MARGIN}, of {clear.size}")
    if not clear.any() or (clear & ~same).any():
        fail("16a: the tp lens pass's top-k ids differ where the margin is "
             "clear")


def check_merged_readout(torch, merge: dict, ref, ranks) -> None:
    """16a: ``tp_lens_stats`` merged over the two ranks against
    ``lens_stats_reference`` over the whole vocabulary (``ref``, one more
    candidate) on the same rows and targets: logits within ATOL, ids equal
    where clear, P(target) within SERVE_PROB_RTOL of itself; and the planted
    shift fault's P(target) off by more than TP_PROB_RTOL on most rows, so
    that the tp limits would catch it."""
    from taboo_brittleness_tpu_torch.ops.lens_kernel import LensStats

    got, other = (LensStats(*r["merged"]["stats"]) for r in ranks)
    if not all(torch.equal(a, b) for a, b in zip(got, other)):
        fail("16a: the two tp ranks merged other lens statistics")
    err, n_clear, n_bad = compare(got, ref, TOP_K)
    rows = merge["t"] >= 0
    p_ref = ref.target_prob()[rows].double().numpy()
    rel = _rel_gap(got.target_prob()[rows].double().numpy(), p_ref)
    planted = np.abs(ranks[0]["merged"]["planted"][rows].double().numpy()
                     - p_ref) / p_ref
    n = int(merge["t"].numel())
    log(f"  tp_lens_stats merged over 2 ranks, N={n} K={TOP_K} (targets "
        f"over the whole vocabulary, {n - int(rows.sum())} of them -1): "
        f"max_abs_err {err:.3e} (atol {ATOL}) against lens_stats_reference "
        f"over V={VOCAB}, ids equal on {n_clear - n_bad}/{n_clear} rows "
        f"with clear margins, P(target) max relative diff {rel:.3e} (rtol "
        f"{SERVE_PROB_RTOL}); planted fault (targets shifted by one id): "
        f"P(target) relative diff median {np.median(planted):.3e}, "
        f"{(planted > TP_PROB_RTOL).mean():.3f} of rows over {TP_PROB_RTOL}")
    if err > ATOL or n_bad or rel > SERVE_PROB_RTOL:
        fail("16a: the merged tp readout disagrees with the whole-vocabulary "
             "reference")
    if not np.median(planted) > TP_PROB_RTOL:
        fail(f"16a: a planted target shift reads under {TP_PROB_RTOL}: the "
             "tp probability limit would not catch it")


def check_tp_serve(torch, ctx, sae, tgt, ref_streams, served, spec_ref,
                   witness) -> None:
    """16b: the tp engine's streams against the unsharded engine's, and the
    tp speculative engine against vanilla, under the margin rule."""
    log(f"  tp 2 load ({TP_LOAD_REQUESTS} requests): goodput "
        f"{served['goodput']}, {served['steps']} engine steps in "
        f"{served['load_seconds']:.2f} s; programs {served['aot']}; "
        f"{served['graph']}")
    good = served["goodput"]
    if not good["completed"] == good["admitted"] == TP_LOAD_REQUESTS:
        fail(f"16b: the tp load completed {good}")
    for name, st in served["aot"].items():
        if name.endswith("[tp]") and st["misses"]:
            fail(f"16b: {name} missed after its warm start: {st}")
    if served["graph"].get("graphed"):
        fail("16b: a gloo rank's step claims a graph")
    for who, streams in (("unsharded", ref_streams), ("tp", served["streams"])):
        ran = {scen for scen, _, _ in streams.values()}
        if ran != set(SERVE_MIX):
            fail(f"16b: the {who} load ran scenarios {sorted(ran)}, not all "
                 f"of {sorted(SERVE_MIX)}")
    diverged, worst_rel, gap_w, tp_w = [], 0.0, 0.0, 0.0
    for rid, (scen, toks, probs) in sorted(ref_streams.items()):
        g = served["streams"].get(rid)
        if g is None:
            fail(f"16b: no tp response for {rid}")
        if g[1] != toks:
            diverged.append((rid, scen))
        elif probs is not None:
            worst_rel = max(worst_rel, _rel_gap(g[2], probs))
            w = witness[rid]
            if w[1] == toks:
                gap_w = max(gap_w, _rel_gap(w[2], probs))
                tp_w = max(tp_w, _rel_gap(g[2], w[2]))
    for rid, scen in diverged:
        ref, margins = _request_margins(torch, ctx, sae, tgt, {
            "id": rid, "prompt": "Give me a hint", "scenario": scen,
            "seed": TP_LOAD_SEED * 10_000 + int(rid[1:5])})
        g = served["streams"][rid][1]
        first = next((i for i, (a, b) in enumerate(zip(g, ref)) if a != b),
                     min(len(g), len(ref)))
        m = margins[first] if first < len(margins) else float("inf")
        log(f"  16b {rid}: first differs at token {first} (unsharded margin "
            f"{m:.4f})")
        if not m < SPEC_MARGIN:
            fail(f"16b {rid} diverges at a margin >= {SPEC_MARGIN}")
    log(f"  tokens equal to the unsharded engine on "
        f"{len(ref_streams) - len(diverged)}/{len(ref_streams)} requests; "
        f"chat_lens probabilities max relative diff {worst_rel:.3e} (rtol "
        f"{TP_PROB_RTOL}); the witness (split o/down sums, one process) vs "
        f"unsharded {gap_w:.3e}, tp 2 vs the witness {tp_w:.3e}")
    if worst_rel > TP_PROB_RTOL:
        fail(f"16b: lens probabilities differ by {worst_rel} (relative)")
    t = served["timing"]
    if t["readouts_per_step"] != 1:
        fail(f"16b: the profiled tp step ran {t['readouts']} readout kernels")
    van_toks, van_margins = spec_ref
    st = served["spec_stats"]
    log(f"  tp 2 speculative engine ({served['spec_name']}, k 2, G 3) over 8 "
        f"sessions of {TP_SPEC_NEW} tokens: {served['spec_seconds']:.2f} s, "
        f"accept rate {st['accept_rate']}, tokens per verify "
        f"{st['tokens_per_verify']}")
    spec_rows = np.array([served["spec_tokens"][s] for s in range(len(van_toks))])
    van = {"tokens": np.array([van_toks[s] for s in range(len(van_toks))]),
           "margins": np.array([van_margins[s] for s in range(len(van_toks))])}
    if spec_rows.shape != van["tokens"].shape:
        fail(f"16b: tp speculative rows {spec_rows.shape} vs vanilla "
             f"{van['tokens'].shape}")
    _hold_rows("16b tp 2 speculative engine", spec_rows, van)


def check_selfcheck_process(torch) -> None:
    """16b: ``serve --selfcheck`` as processes on the card (the tiny
    synthetic stack): a ``--tp 2`` server's ranks and a ``--tp-no-shard``
    server, their responses compared by the command itself."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", PACKAGE, "serve",
                           "--selfcheck"], cwd=REPO, env=_proc_env(),
                          capture_output=True, text=True,
                          timeout=PROC_TIMEOUT_S)
    verdict = {}
    with contextlib.suppress(ValueError):
        verdict = json.loads(proc.stdout)
    log(f"  serve --selfcheck (processes, card): exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s, ok {verdict.get('ok')}, compared "
        f"{verdict.get('compared')}, mesh {verdict.get('mesh')}, aot "
        f"{verdict.get('aot')}")
    if proc.returncode != 0 or not verdict.get("ok"):
        fail(f"serve --selfcheck: exit {proc.returncode}\n{proc.stdout[-3000:]}"
             f"\n{proc.stderr[-3000:]}")
    if shared_card_reason(torch) not in verdict["mesh"].get("reason", ""):
        fail(f"serve --selfcheck: the tp ranks joined as {verdict['mesh']}")


def shared_card_reason(torch) -> str:
    """How ``choose_backend`` names phase 16's layout: more ranks than
    cards share them over ``gloo``."""
    return f"{TP_RANKS} ranks share {torch.cuda.device_count()} card(s)"


def check_rank_layout(torch, r: dict) -> None:
    """A phase-16 rank started with no device: on card 0 (``LOCAL_RANK %
    device_count`` of one card), ``gloo`` with its collectives staged
    through the host, and the reason naming the shared card."""
    mesh = r["mesh"]
    if (mesh["backend"] != "gloo" or mesh["staging"] != "host"
            or shared_card_reason(torch) not in mesh["reason"]
            or r["params_device"] != "cuda:0"):
        fail(f"rank {r['rank']}: mesh {mesh}, params on {r['params_device']}")


def drive_parallel_tp(torch, workdir: str, ctx: tuple, *,
                      selfcheck: bool = False) -> dict:
    """Phase 16a-b: the unsharded references and their witnesses
    (``split_row_parallel``) in this process on phase 6's params, then two
    tp ranks on the card (``gloo``, collectives staged on the host), then
    (``selfcheck``) ``serve --selfcheck``.  Returns the per-shard kernel
    rows and the phase's readings."""
    import gc

    from taboo_brittleness_tpu_torch.ops import lens_kernel as lk
    from taboo_brittleness_tpu_torch.ops import sae as sae_ops
    from taboo_brittleness_tpu_torch.parallel.multihost import run_ranks
    from taboo_brittleness_tpu_torch.pipelines import logit_lens
    from taboo_brittleness_tpu_torch.runtime import aot, decode
    from taboo_brittleness_tpu_torch.runtime.tokenizer import target_token_id
    from taboo_brittleness_tpu_torch.serve import engine as engine_mod
    from taboo_brittleness_tpu_torch.serve import loadgen
    from taboo_brittleness_tpu_torch.serve.scheduler import default_scenarios

    t_phase = time.perf_counter()
    aot.reset()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, cfg, tok, config = ctx[:4]
    layer = config.model.layer_idx
    config = _tp_config(config)
    log(f"phase 16a references: the unsharded lens pass for ship "
        f"({TP_NEW_TOKENS} new tokens)")
    from taboo_brittleness_tpu_torch.ops import lens as lens_mod

    real_agg, sums = lens_mod.aggregate_from_residual, []
    real_lens, taps = lens_mod.lens_forward, []

    def wider(*a, top_k, **kw):        # one more candidate, for the margins
        ids_, vals = real_agg(*a, top_k=top_k + 1, **kw)
        sums.append(vals.cpu().numpy())
        return ids_[:, :top_k], vals[:, :top_k]

    def kept(*a, **kw):                # the per-position top-k, kept
        res = real_lens(*a, **kw)
        taps.append((res.tap.topk_ids.cpu().numpy(),
                     res.tap.topk_probs.float().cpu().numpy()))
        return res

    lens_mod.aggregate_from_residual, lens_mod.lens_forward = wider, kept
    try:
        ref = logit_lens.analyze_word_on_device(
            params, cfg, tok, "ship", list(config.prompts), layer_idx=layer,
            top_k=config.model.top_k,
            max_new_tokens=config.experiment.max_new_tokens,
            pad_to_multiple=config.experiment.pad_to_multiple)
    finally:
        lens_mod.aggregate_from_residual = real_agg
        lens_mod.lens_forward = real_lens
    ref_sums, ref_topk = sums[0], taps[0]
    with AotOff(), split_row_parallel(torch, params) as split_a:
        witness_a = logit_lens.analyze_word_on_device(
            params, cfg, tok, "ship", list(config.prompts), layer_idx=layer,
            top_k=config.model.top_k,
            max_new_tokens=config.experiment.max_new_tokens,
            pad_to_multiple=config.experiment.pad_to_multiple)
    gen = torch.Generator(device=params["embed"].device).manual_seed(17)
    merge = {"x": torch.randn((N_ROWS, HIDDEN), generator=gen,
                              device=gen.device).to(torch.bfloat16),
             "t": torch.randint(0, cfg.vocab_size - 1, (N_ROWS,),
                                generator=gen, device=gen.device)}
    merge["t"][::3] = -1
    merge_ref = lk.lens_stats_reference(merge["x"], params["embed"],
                                        merge["t"], top_k=TOP_K + 1)
    merge_ref = lk.LensStats(*(a.cpu() for a in merge_ref))
    merge = {k: v.cpu() for k, v in merge.items()}
    padded, valid, positions, _ = decode.encode_prompts(
        tok, list(config.prompts),
        pad_to_multiple=config.experiment.pad_to_multiple)
    dev = params["embed"].device
    dec = decode.greedy_decode(
        params, cfg, torch.from_numpy(padded).long().to(dev),
        torch.from_numpy(valid).to(dev),
        torch.from_numpy(positions).long().to(dev),
        max_new_tokens=config.experiment.max_new_tokens, return_margins=True)
    margins = [m[:int(n)].tolist() for m, n in
               zip(dec.margins.cpu().numpy(), dec.lengths.cpu().numpy())]
    del dec
    log(f"phase 16b references: the unsharded engine over {TP_LOAD_REQUESTS} "
        f"requests (seed {TP_LOAD_SEED}), vanilla margins for the speculative "
        "check")
    sae = sae_ops.init_random(torch.Generator(device=dev).manual_seed(3),
                              cfg.hidden_size, SAE_WIDTH, device=dev)
    tgt = target_token_id(tok, "moon")
    _, _, _, ids = decode.encode_prompts(tok, list(config.prompts[:SERVE_SLOTS]))
    engine = engine_mod.ServeEngine(params, cfg, tok, sae=sae,
                                    engine_config=_serve_config(layer))
    def load(engine) -> dict:
        streams = {}
        loadgen.run_inprocess(
            engine, n_requests=TP_LOAD_REQUESTS, seed=TP_LOAD_SEED,
            rate=50.0, concurrency=16, mix={name: 1.0 for name in SERVE_MIX},
            scenarios=default_scenarios(), lens_target_id=tgt,
            on_complete=lambda r: streams.__setitem__(
                r.id, (r.scenario, list(r.tokens), r.lens_probs)))
        return streams

    ref_streams = load(engine)
    del engine
    with AotOff(), split_row_parallel(torch, params) as split_b:
        witness_b = load(engine_mod.ServeEngine(
            params, cfg, tok, sae=sae, engine_config=_serve_config(layer)))
    log(f"  witnesses: {split_a['calls']} and {split_b['calls']} o/down "
        "products split in two in the lens pass and the engine load")
    if not (split_a["calls"] and split_b["calls"]):
        fail("16: the witness split no o/down product")
    spec_ref = _vanilla_with_margins(torch, ctx, sae, ids, TP_SPEC_NEW, tgt)
    aot.reset()
    gc.collect()
    torch.cuda.empty_cache()
    main_peak = torch.cuda.max_memory_allocated() / 2**30

    log(f"phase 16a-b: {TP_RANKS} tp ranks on the card over gloo")
    t0 = time.perf_counter()
    ranks = run_ranks(tp_rank, TP_RANKS,
                      {"workdir": workdir, "ids": ids, "merge": merge},
                      workdir=os.path.join(workdir, "tp-ranks"))
    t_ranks = time.perf_counter() - t0
    for r in ranks:
        log(f"  rank {r['rank']}: mesh {r['mesh']}; params on "
            f"{r['params_device']}; embed rows "
            f"{r['embed_rows']}; params sliced in {r['params_seconds']:.1f} s; "
            f"peak device memory {r['peak_gib']:.2f} GiB")
        if r["embed_rows"] * TP_RANKS != cfg.vocab_size:
            fail(f"rank {r['rank']} holds {r['embed_rows']} vocab rows")
        check_rank_layout(torch, r)
    log("phase 16a the tp lens pass")
    check_tp_lens(torch, ref, ref_sums, ref_topk, ranks, margins, witness_a)
    check_merged_readout(torch, merge, merge_ref, ranks)
    rows = {}
    for key in ("shard_main", "shard_serve"):
        s = ranks[0][key]
        log(f"  per-shard lens_stats N={s['n']} V={s['v']} K={s['k']}: "
            f"max_abs_err {s['max_abs_err']:.3e} (atol {ATOL}), ids equal on "
            f"{s['clear'] - s['bad']}/{s['clear']} rows with clear margins, "
            f"launches by route {s['launches']}; {s['ms']:.3f} ms, plain "
            f"{s['plain_ms']:.3f} ms, library {s['library_ms']:.3f} ms, bound "
            f"{s['bound_ms']:.3f} ms ({s['bound_by']})")
        if s["max_abs_err"] > ATOL or s["bad"] or s["launches"] != {s["route"]: 1}:
            fail(f"the per-shard lens_stats call disagrees: {s}")
        rows[key] = s
    c = ranks[0]["collective_ms"]
    log(f"  one tp all_reduce of [8, 1, {HIDDEN}] bf16 over gloo: "
        f"{c['card']:.3f} ms from the card (staged), {c['host']:.3f} ms "
        "between host tensors (host clock, mean of 50)")
    log("phase 16b the tp serve engine")
    served = ranks[0]["serve"]
    check_tp_serve(torch, ctx, sae, tgt, ref_streams, served, spec_ref,
                   witness_b)
    del sae
    if selfcheck:
        log("phase 16b serve --selfcheck")
        check_selfcheck_process(torch)
    peak = main_peak + sum(r["peak_gib"] for r in ranks)
    step_ms = served["timing"]["step_ms"]
    log(f"tp phase: {time.perf_counter() - t_phase:.2f} s (ranks "
        f"{t_ranks:.2f} s); tp 2 step {step_ms:.3f} ms and lens pass "
        f"{ranks[0]['lens']['lens_seconds']:.2f} s are gloo over one card "
        "(collectives staged on the host), not a tensor-parallel speed; peak "
        f"device memory, this process's plus each rank's: {peak:.2f} GiB")
    if peak >= PEAK_GIB:
        fail(f"phase 16a-b peaks at {peak:.2f} GiB, over {PEAK_GIB}")
    return {"tp_shard_ms": rows["shard_main"]["ms"],
            "tp_shard_plain_ms": rows["shard_main"]["plain_ms"],
            "tp_shard_library_ms": rows["shard_main"]["library_ms"],
            "tp_shard_bound_ms": rows["shard_main"]["bound_ms"],
            "tp_shard_max_abs_err": rows["shard_main"]["max_abs_err"],
            "tp_shard_launches": ranks[0]["lens"]["launches"],
            "tp_serve_shard_ms": rows["shard_serve"]["ms"],
            "tp_serve_shard_plain_ms": rows["shard_serve"]["plain_ms"],
            "tp_serve_shard_library_ms": rows["shard_serve"]["library_ms"],
            "tp_serve_shard_bound_ms": rows["shard_serve"]["bound_ms"],
            "tp_serve_shard_max_abs_err": rows["shard_serve"]["max_abs_err"],
            "tp_step_ms": step_ms,
            "tp_lens_seconds": ranks[0]["lens"]["lens_seconds"]}


def drive_parallel_sp(torch, workdir: str) -> dict:
    """Phase 16c: two sp ranks, each with phase 6's whole params, one
    SP_T-column row through ``lens_forward_sp`` against the dense pass."""
    import gc

    from taboo_brittleness_tpu_torch.parallel.multihost import run_ranks

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated() / 2**30
    log(f"phase 16c lens_forward_sp at sp {TP_RANKS}, B 1, T {SP_T} (this "
        f"process holds {held:.2f} GiB)")
    ranks = run_ranks(sp_rank, TP_RANKS, {"workdir": workdir},
                      workdir=os.path.join(workdir, "sp-ranks"))
    for x in ranks:
        log(f"  rank {x['rank']}: mesh {x['mesh']}; params on "
            f"{x['params_device']}")
        check_rank_layout(torch, x)
    r = ranks[0]
    peak = held + sum(x["peak_gib"] for x in ranks)
    log(f"  sp pass {r['sp_seconds']:.2f} s (gloo over one card), dense pass "
        f"{r['dense_seconds']:.2f} s; of {r['positions']} (layer, position) "
        f"pairs, top-1 ids equal on {r['clear'] - r['bad']}/{r['clear']} "
        f"whose top-1/top-2 logit gap exceeds {SPEC_MARGIN}, the first "
        f"{TOP_K - 1} of the top-{TOP_K} on {r['clear_k'] - r['bad_k']}/"
        f"{r['clear_k']} with every gap among them clear; "
        f"top-k probs max relative diff {r['prob_err']:.3e}, P(target) "
        f"{r['target_err']:.3e} (median {r['target_err_median']:.3e}); "
        f"residual relative L2 {r['resid_rel']:.3e} (rtol {SP_RESID_RTOL}); "
        f"peak device memory, this process's plus the ranks' {peak:.2f} GiB; phase "
        f"{time.perf_counter() - t0:.2f} s")
    if r["bad"] or r["bad_k"] or not r["clear"] or not r["finite"]:
        fail(f"16c: the sp pass disagrees with the dense one: {r}")
    if not r["resid_rel"] < SP_RESID_RTOL:
        fail(f"16c: the sp residual is {r['resid_rel']} from the dense one")
    if peak >= PEAK_GIB:
        fail(f"phase 16c peaks at {peak:.2f} GiB, over {PEAK_GIB}")
    return {"sp_seconds": r["sp_seconds"], "sp_dense_seconds": r["dense_seconds"]}


def drive_deep(torch) -> dict:
    """Phase 18: the deep registry on the CPU and on the card, each entry's
    conversions held equal (the card's marker mapped back; a twin running on
    the card is recorded there), and each entry whose CPU run went through a
    twin launching the kernel on the card.  Returns the ``{"deep": ...}``
    line's object."""
    from taboo_brittleness_tpu_torch.analysis import deep

    t0 = time.perf_counter()
    log(f"phase 18 deep: {len(deep.ENTRY_NAMES)} entries on the CPU (vocab "
        f"{deep.VOCAB_MARKER}) and on the card (vocab {deep.CARD_MARKER}), "
        f"the [tp] ones on {deep.TP} gloo ranks")
    cpu, card = deep.run_entries(
        deep.ENTRY_POINTS, runs=[("cpu", deep.VOCAB_MARKER),
                                 ("cuda", deep.CARD_MARKER)])
    failed = {f"{where}:{name}": r["error"]
              for where, run in (("cpu", cpu), ("cuda", card))
              for name, r in run.items() if "error" in r}
    if failed:
        fail(f"18: entries failed to run: {failed}")
    entries, differ = {}, {}
    for name in deep.ENTRY_NAMES:
        want = sorted(cpu[name]["conversions"])
        got = sorted((src, deep.map_marker(shape, deep.CARD_MARKER))
                     for src, shape in card[name]["conversions"])
        entries[name] = {"conversions": [f"{src}->f32 {shape}"
                                         for src, shape in got],
                         "launches": card[name]["launches"]}
        log(f"  {name}: {entries[name]['conversions']}, lens kernel "
            f"launches {card[name]['launches']} on the card")
        if got != want:
            differ[name] = {"cpu": want, "card": got}
    seconds = time.perf_counter() - t0
    if differ:
        fail(f"18: the card's conversions differ from the CPU's: {differ}")
    twinned = [name for name in deep.ENTRY_NAMES if cpu[name]["opaque"]]
    unlaunched = [name for name in twinned if not card[name]["launches"]]
    if unlaunched:
        fail(f"18: entries whose CPU run went through a kernel's plain twin "
             f"launched no kernel on the card: {unlaunched}")
    launched = sum(e["launches"] for e in entries.values())
    if not launched:
        fail("18: no entry launched the lens kernel on the card")
    log(f"  every entry's conversions equal the CPU's; {launched} lens "
        f"kernel launches, each of the {len(twinned)} entries whose CPU run "
        f"went through a twin launching; phase {seconds:.2f} s")
    return {"entries": entries,
            "findings": sum(len(e["conversions"]) for e in entries.values()),
            "seconds": round(seconds, 2)}


def drive_kernels(torch) -> tuple:
    """Phases 3-5b: every lens kernel held to its plain version and timed.
    Returns the kernels line's entries: the bf16 split-V and wgmma kernels,
    the wide top-k route (top_k above 32 in certified passes of both, its
    headline bf16 N 1140 K 33), the f32 builds of the wgmma and the split-V
    kernels (their launches from 5b's passes, counted from 0 just before
    each) and their f16 builds (3c; launches 0 until phase 19 sets them)."""
    wgmma = check_lens_stats(torch)
    f32_rows = {r["route"]: r for r in measure_f32(torch)}
    wide = measure_wide(torch)
    splitv = check_splitv(torch)
    f32_cross = check_f32_crossover(torch)
    f16 = measure_f16(torch)
    worst = check_edges(torch)
    small = check_small_against_cpu(torch)
    f32_pass = check_f32_lens_pass(torch)
    wgmma["max_abs_err"] = max(wgmma["max_abs_err"], worst["wgmma"])
    splitv["max_abs_err"] = max(splitv["max_abs_err"], worst["splitv"])
    entries = []
    for route, source in (("wgmma", "lens_stats_wgmma.cu"),
                          ("splitv", "lens_stats_splitv.cu")):
        r = f32_rows[route]
        launches, pass_err = f32_pass[route]
        entry = dict(
            name=f"lens_stats_{route}_f32", route="cuda",
            source=f"{PACKAGE}/csrc/{source}",
            replaces="taboo_brittleness_tpu/ops/pallas_lens.py:56",
            launches=launches,
            max_abs_err=max(r["max_abs_err"], worst[f"{route}_f32"],
                            small[route], pass_err),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], n=r["n"],
            k=r["k"], product="3xTF32")
        if route == "splitv":
            entry.update(crossover=f32_cross["crossover"],
                         by_rows=f32_cross["by_rows"])
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       f32_cross["max_abs_err"])
        entries.append(entry)
    for route, source in (("wgmma", "lens_stats_wgmma.cu"),
                          ("splitv", "lens_stats_splitv.cu")):
        r = f16[route]
        entries.append(dict(
            name=f"lens_stats_{route}_f16", route="cuda",
            source=f"{PACKAGE}/csrc/{source}",
            replaces="taboo_brittleness_tpu/ops/pallas_lens.py:56",
            launches=0, max_abs_err=max(r["max_abs_err"],
                                        worst[f"{route}_f16"]),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], n=r["n"],
            k=r["k"], bf16_ms=r["bf16_ms"], product="f16 wgmma",
            **({"by_rows": r["by_rows"]} if route == "splitv" else {})))
    return (splitv, wgmma, wide, *entries)


def _standalone_ctx(torch) -> tuple:
    """Phase 6's params, config and tokenizer made here, for a run of a
    few phases alone."""
    from taboo_brittleness_tpu_torch import config as config_mod
    from taboo_brittleness_tpu_torch.models import gemma2
    from taboo_brittleness_tpu_torch.runtime.tokenizer import WordTokenizer

    config = config_mod.Config(output=config_mod.OutputConfig(save_plots=False))
    cfg = gemma2.PRESETS["gemma2_9b"]
    params = gemma2.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    words = sorted({w for p in config.prompts for w in p.split()}
                   | set(config.words))
    tok = WordTokenizer(words, vocab_size=cfg.vocab_size)
    return (params, cfg, tok, config, None, "ship")


def phases_alone(torch, which: str) -> int:
    """``--parallel``: phases 1-2 and 16 alone; ``--parity``: phases 1-2
    and 17 alone; each on phase 6's params made here.  ``--processes``:
    phases 1-2, 12f, 13d and 14b's second fleet (the tiny synthetic
    stack's processes on the card; the whole run leaves 13d and 14b's
    second fleet out for time).  ``--kernels``: phases 1-5 alone (the lens
    kernels against their plain version, timed).  ``--deep``: phases 1-2
    and 18 alone.  The quickest proof that those paths run on the card."""
    device, card = report_device(torch)
    build_kernels()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if which == "kernels":
            out = {"kernels": list(drive_kernels(torch))}
        elif which == "deep":
            out = drive_deep(torch)
        elif which == "processes":
            log("phase 12f the serve process on the card")
            check_serve_process(torch, workdir)
            log("phase 13d the grid, fleet and attack-search processes on "
                "the card")
            check_grid_processes(torch, workdir)
            log("phase 14b's second fleet: a gateway draining in front of it")
            check_gateway_drain(torch, workdir)
        elif which == "parity":
            out = drive_parity_dump(torch, workdir, _standalone_ctx(torch))
        elif which == "readout-window":
            log("14a's profiled readout window, taken again and again")
            out = check_readout_windows(torch, _standalone_ctx(torch))
        else:
            ctx = _standalone_ctx(torch)
            out = drive_parallel_tp(torch, workdir, ctx, selfcheck=True)
            del ctx
            out.update(drive_parallel_sp(torch, workdir))
    print(card, flush=True)
    print(json.dumps({which: out}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, PACKAGE)):
        fail(f"{PACKAGE}/ not found beside chip_smoke.py: run it from the "
             "root of a checkout")
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    # Stated for every f32 comparison below: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if sys.argv[1:] in (["--parallel"], ["--parity"], ["--processes"],
                        ["--readout-window"], ["--kernels"], ["--deep"]):
        return phases_alone(torch, sys.argv[1][2:])
    device, card = report_device(torch)
    build_kernels()
    splitv, wgmma, wide, *entries = drive_kernels(torch)
    print(json.dumps({"deep": drive_deep(torch)}), flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        # Before phase 6 makes its bf16 params: the two models never share
        # the card.  Its launches (and tap errors) go to the f16 entries.
        f16_path = drive_f16_main_path(torch, workdir)
        for entry in entries:
            if entry["name"].endswith("_f16"):
                launches, err = f16_path[entry["name"].split("_")[2]]
                entry["launches"] = launches
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
        by_route, wide_pass, ctx = drive_main_path(torch, workdir)
        sae, ablation_set = drive_interventions(torch, workdir, ctx)
        forcing = drive_attacks(torch, workdir, ctx, sae, ablation_set)
        del ablation_set
        drive_residency_and_speculation(torch, workdir, ctx, forcing)
        drive_decode_launch(torch, ctx, sae)
        serve = drive_serving(torch, workdir, ctx, sae)
        spec = drive_spec_serving(torch, workdir, ctx, sae,
                                  serve.pop("load_tokens_per_second"))
        grid = drive_grid(torch, workdir, ctx, sae)
        fleet = drive_replica_fleet(torch, workdir, ctx, sae)
        del sae
        profiled = drive_device_profile(torch, workdir, ctx)
        parity = drive_parity_dump(torch, workdir, ctx)
        parallel = drive_parallel_tp(torch, workdir, ctx)
        del ctx
        parallel.update(drive_parallel_sp(torch, workdir))
    # Each entry's ``launches`` is its own path's count: the main path's
    # (phase 6) for the wgmma kernel and the wide route's refills, the
    # serving path's (11b's
    # eager sessions) for the split-V kernel.  The small-N readouts' numbers
    # (serving, speculative verify, attack search, replica, tp serve shard)
    # ride beside the split-V entry, the main path's beside the wgmma one.
    splitv["max_abs_err"] = max(splitv["max_abs_err"],
                                serve.pop("serve_max_abs_err"),
                                spec.pop("spec_verify_max_abs_err"),
                                parallel.pop("tp_serve_shard_max_abs_err"))
    splitv["launches"] = serve.pop("serve_path_launches")["splitv"]
    for part in (serve, spec, grid, fleet):
        splitv.update(part)
    splitv.update({k: parallel.pop(k) for k in list(parallel)
                   if k.startswith("tp_serve_shard_") or k == "tp_step_ms"})
    wgmma.update(profiled)
    wgmma.update(parity)
    wgmma.update(parallel)
    wgmma["max_abs_err"] = max(wgmma["max_abs_err"],
                               wgmma.pop("tp_shard_max_abs_err"))
    wgmma["launches"] = by_route["wgmma"]
    wgmma["wide"]["pass"] = wide_pass
    wide["launches"] = by_route["wgmma_refill"] + by_route["splitv_refill"]
    if not (splitv["launches"] and wgmma["launches"]):
        fail(f"a path ran without its kernel: splitv {splitv['launches']} "
             f"launches on the serving path, wgmma {wgmma['launches']} on "
             "the main path")
    # Again at the end, beside the numbers, where a tail of the output
    # keeps it.
    print(card, flush=True)
    print(json.dumps({"kernels": [splitv, wgmma, wide, *entries]}),
          flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
