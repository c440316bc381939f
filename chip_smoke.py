#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dynamo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases; any failure exits non-zero before the result line:

1. build the CUDA kernels from dynamo_tpu_torch/ops/csrc (one nvcc per
   source, in parallel);
2. hold the decode kernel against its plain PyTorch version on the card:
   with and without stats, rows of length 0, softcap and a lower bound,
   and in the fused-window form, float32 (atol 1e-5; the float32 route at
   head_dim 32 to 128), bfloat16 (atol 2e-2 + rtol 1e-2; the bf16 route)
   and float16 (the same tolerance; the bf16 kernel's float16 form, route
   f16_mma), and in every dtype the generic kernel outside the routes'
   sets: head_dim 96 at page 4, Mistral-Large-2's 12 heads a kv head,
   16 on one kv head at page 3, 71 on one at head_dim 80 and page 48,
   page 256, head_dim 7 and 20 (rows that are not 16-byte multiples in
   16 bits), and head_dim 320 and 512 (two value-column tiles; 512 at
   the 8B's heads); each call must have taken its shape's route (the
   launch counts), the generic cases route generic, and every route must
   have been taken;
3. the same for the prefill kernel: padding queries, a sliding window, a
   second chunk that skips pages, the fourth chunk of a 2048-token prompt
   (float32 on the 3xTF32 route; bfloat16 on the bf16 route, float16 on
   its float16 form, route f16), and in every dtype the generic kernel
   outside those sets: head_dim 96 at page 4, the deep chunk (positions
   1536-2047) at head_dim 96 and page 8, 71 heads on one kv head at
   head_dim 80, page 48, with a window and the softcap, the shapes
   phase 13's tiny engines serve (head_dim 16 at page 16, float32 at
   page 4), head_dim 20, 7, 320 and 512, and the verify step of
   ``--spec-tokens 4`` (T = 5 queries a row starting mid-page, on a
   page's last slot, on a boundary and at 1) on every prefill route;
4. serve Llama-3-8B-shaped requests (32 layers at full width, random
   weights from a seed, byte tokenizer) over the OpenAI HTTP front end on
   a local port, with pipelined decode windows and prefill chunks, each
   one replay of the CUDA graph warmup() captured for its bucket (decode
   per (batch, page), prefill per (prefill batch, chunk length, page)):
   every bucket of both warmed grids must be captured, and serving must
   capture none (post_warmup_compiles_total 0); four concurrent streaming
   and unary requests (the service's first: the cold batch), the same
   four three times more (the warm batches), once more with the engine's
   dispatch profiler sampling every iteration (its bucket_cost printed,
   kept apart from the timed batches since sampling syncs), then a
   repeated greedy request that must give identical tokens. Each batch's
   TTFT is broken down per request into stages (client send -> engine
   entry, queue wait, admission -> first-token read-back, read-back ->
   emission, emission -> the token reaching the HTTP chain) that must sum
   to the measured TTFT within 1 ms, and the engine's own TTFT histogram
   must agree with the stamps. The launch counts of both kernels
   (replays count the launches their capture recorded), reset just
   before and read just after, must be above 0 and equal to the graph
   replays times the calls one replay makes (no eager dispatch), and
   every decode and prefill call must have taken the bf16 route. The four
   requests then go again one at a time, greedy, with logprobs and the
   top 5 (the logprobs variants warmup() captured by default): every
   token's logprob must be the top-1 logprob, and each logprob and top
   value within LOGPROB_LIMIT of the plain path teacher-forced with the
   served tokens; these results are phase 8's reference. Then prefill
   and one teacher-forced decode window on the kernel path against the
   plain path (logits of every step, K/V of every window position), with
   two injected faults as controls that must fail it; then one 8B window
   by graph replay against the same window called eagerly from the same
   inputs and pools (tokens, emitted counts and carry identical, the
   written K/V within bf16 tolerance), and two 8B prefill chunks by graph
   replay against the same chunks called eagerly (a first chunk of 512
   tokens; a batch of 8 rows of 64 with three real rows, one of them
   sampled): sampled tokens, logits and the whole K/V pools bitwise
   equal; the same window and chunks again in the logprobs variants,
   their logprobs bitwise equal too;
5. time each kernel at the serving shapes beside its bound, its plain
   version and scaled_dot_product_attention on the same dense work, and
   hold it against its plain version there (bf16 tolerance): decode in
   the window form at the served window, at 32 rows of 520 positions and
   at 8 rows of 3,968 positions, also within DECODE_REL_RMS of the plain
   output's rms, with a row one 16-key block short as the control that
   must exceed it; prefill at the served first chunk and at
   a deep chunk (positions 1536-2047); the float32 routes (atol 1e-5) at
   the served window and first chunk at the 1b's heads (the row, whose
   launches phase 11 counts), the 8B's and the tiny preset's (page 16,
   its own served request), on float32 pools from a seed, the prefill
   bound at 3xTF32 (three TF32 products an operation, 494.7 TF/s) with
   the FFMA bound (67 TF/s) beside it; the float16 forms at the served
   window and first chunk on float16 pools from a seed (the rows whose
   launches phase 12 counts); the generic decode kernel in bfloat16 at
   the heads phase 14 serves (96 on 8 kv heads, head_dim 128, page 64)
   at the served window (its row, whose launches phase 14 counts), 32
   rows of 520 positions and 8 of 3,968; the generic kernels in every
   dtype at the 8B's heads with head_dim 96, outside every fast set, at
   the served window (under the generic decode row) and first chunk (a
   prefill row each, its launches from phase 13's engines at their own
   head_dim, whose shapes phases 3 and 5 hold to the plain version), and
   the generic prefill at the chunk phase 13 serves (the 1b's heads in
   bfloat16 at page 8). Bounds count the work of this run's inputs
   (ops.paged_attention.decode_work and prefill_work);
6. hold the tensor-parallel wrappers (paged_attention_decode_sharded, its
   window form, paged_attention_prefill_sharded) against the plain
   versions at the heads one rank holds of the 8B widths at tp 2, 4 and
   8, float32, bfloat16 and float16, and time them at those heads at the
   served
   shapes (the 4-row window, with the cluster of splits the launch plan
   picks and each row's live splits, beside tp=1's full heads timed in
   the same phase; a first chunk of 512), and the decode at tp=8's heads
   on the long-row guard (8 rows of 3,968 positions);
7. tensor parallel at model=2 with both ranks on the one card (each with
   its own NCCL_HOSTID, NCCL over the loopback socket): two ranks of this
   script build a tp=2 engine, warm it, and run check_paths' prefill and
   teacher-forced window on their shards, whose logits must stay within
   PATH_LIMITS of phase 4's tp=1 logits (same seed, same inputs) with
   equal argmax wherever tp=1's top-2 margin exceeds the limit; each
   rank also holds its replayed window and prefill chunks (NCCL
   collectives captured inside) against the same calls made eagerly,
   as phase 4 does at tp=1, and checks that every eager and replayed
   all-reduce of distinct per-rank inputs gives the exact sum; then two
   ranks of the launcher serve
   the phase-4 requests over HTTP to rank 0, in both launch forms (one
   process per rank with ``--coordinator ... --process-id r``; one
   command that starts rank 1 itself), and each rank's serving summary
   must show no capture after warmup, mesh model=2, every kernel call
   from a graph replay on the bf16 routes, and the same counts on both
   ranks (the two forms side by side, the second started once the
   first's ranks warm up: four ranks, two groups, on the card). The launcher ranks of phase 7 run with
   ``--max-batch-size 4`` (the requests here are four at most) and
   phase 8's with 1 (its requests go one at a time), the check's ranks
   with batches up to 8 and only the chunk lengths their checks replay
   (64 and 512), so each warms fewer graphs; every launcher rank's ``engine ready`` line (where its start
   went: imports, process group, load, weights, warmup) is kept. Every
   rank process is killed at the end of the phase. Its times are two
   ranks sharing one card, not a TP speed;
8. the seed-0 8B weights at full width and depth written as a BF16
   HuggingFace checkpoint (four shards, their index and config.json, no
   tokenizer files: the byte tokenizer serves), by this script's own
   writer, into a temporary directory; loaded by
   ``dynamo_tpu_torch/models/loader.py`` (seconds, GB/s and peak host
   RSS printed) and held bitwise against the seed-0 params; then served
   with ``python -m dynamo_tpu_torch.run --model-path``, tp=1 and tp=2
   side by side (three ranks on the card): at tp=1 the
   four phase-4 requests one at a time must give phase 4's results
   bitwise (text, every logprob and top value: the same tokens), and at
   tp=2 (two launcher ranks, each loading its shard, with its load line)
   tp=1's tokens wherever tp=1's top-2 margin exceeds twice
   LOGPROB_LIMIT; each launch's serving summaries checked as phase 7's;
   then loaded with quant="int8": at tp=1 bitwise ``quantize_int8`` of
   the seed-0 params on the card, at tp=2 (two ranks of this script on
   the one card) each rank's int8 shard bitwise the cut of tp=1's, and
   its logits on check_paths' inputs within PATH_LIMITS of phase 10's
   tp=1 int8 logits;
9. an engine on the loaded weights warmed with ``warmup_penalties``: the
   plain and the penalised window variants over every bucket (graph pool
   MiB by variant printed), the penalised window's replay bitwise equal
   to its eager call, with the three penalties and logit_bias and with
   logit_bias alone over a state left unrebuilt; repetition, frequency and
   presence penalties served over HTTP in one batch, then logit_bias +100
   alone: the biased request emits the token at every step, the others'
   greedy tokens agree with the plain path's penalised argmax where the
   margin exceeds twice LOGPROB_LIMIT, and nothing is captured after
   warmup.
10. (run after phase 6, once the bf16 engine has left the card) the
   weight-only int8 GEMM (``ops/csrc/int8_gemm.cu``: the small_m and
   wgmma routes, each in a bf16, a float16 and a float32 form) held
   against the float32 evaluation of its plain version, within one
   rounding of the output to its dtype plus the float32 summation order
   (``ops/int8_gemm.py int8_gemm_tolerance``), at every projection shape
   of the 8B model at M = 1, 4, 16, 24, 32, 48, 64, 512 and 4,096 in bf16
   and in float16, at the 1b's in float32 (the 2xTF32 forms), at tp=2's
   shapes and at ragged M, N and K (bf16 and float32), with one scale
   perturbed as the control that must fail at every route and form; the
   small-M
   route's programmatic launches captured in a graph, replayed bitwise
   equal to the eager calls, and timed with and without programmatic
   launch; timed at M = 4 to 4,096 in bf16 and float16 (both bf16 routes
   at 4 to 32 rows, where they cross; the small-M route also after a
   kernel that writes its x), at the tiny preset's shapes and at the 1b's
   (M = 4 and 512) in float32 on the float32 forms, beside its bound (in
   float32 both: two TF32 products an operation or the bytes, and the
   FFMA rate), its plain version, ``torch.matmul`` on the dequantized
   weight in x's dtype and ``torch._weight_int8pack_mm`` where it runs on
   CUDA; then the 8B model
   built by the launcher's ``--dtype int8`` path and checked as phase 4
   checks the bf16 one (phase 4's requests over HTTP, every bucket
   captured, none after warmup, int8 GEMM launches by route summing to
   the replays times 7 x 32 + 1 a forward, logprobs against the int8
   plain path, the teacher-forced kernel path against the int8 plain
   path with an int8 fault among its controls, one window and two chunks
   by replay against eager calls) and its logits held within rel_l2
   INT8_REL_L2 of the bf16 engine's on the same seed-0 weights; then the
   launcher's defaults with ``--dtype int8`` (the float32 tiny preset)
   answer one completion, every product on the float32 forms and every
   attention call on the float32 routes.
11. (run last, once the 8B engines have left the card) a float32 engine
   of Llama-3.2-1B's widths (16 layers, D 2048, I 8192, H 32 on 8 kv
   heads of head_dim 64, V 128256, ~6 GB of seed-0 random weights with
   an untied head; the default EngineConfig, batches up to 8): warmed, phase 4's requests
   served over HTTP and checked as phase 4 checks them (no capture after
   warmup; decode launches on the float32 route equal to the window
   replays x 16 layers x K, prefill launches on the float32 route to the
   chunk replays x 16); then its kernel path against its plain path
   teacher-forced at F32_PATH_LIMITS, with the same two fault controls,
   beside the plain path's own float32 noise (every weight moved one
   ulp); then the same seed-0 weights with quant="int8" and float32
   activations, served alike with every product on the float32 forms of
   small_m and wgmma (replays x (7 x 16 + 1), none on a bf16 or float16
   form), its kernel path against its int8 plain path at
   F32_PATH_LIMITS with the int8 fault as its control, beside that plain
   path's noise, and its logits within INT8_REL_L2 of the float32
   engine's. Its launches fill the float32 rows of the kernels line.
12. (run after phase 11) the 8B model in float16 (``ModelConfig.llama3_8b``
   with dtype float16: 32 layers at full width, seed-0 weights, the
   default EngineConfig, batches up to 8), an engine built directly (the launchers offer
   no float16): warmed, every bucket of both grids captured, phase 4's
   requests served over HTTP with no capture after warmup, every decode
   call on the float16 form of the bf16 decode kernel (window replays x
   32 x K) and every prefill call on the float16 prefill form (chunk
   replays x 32), none on another route; its kernel path against its
   plain path teacher-forced at PATH_LIMITS with the two fault controls;
   then the same weights with quant="int8" and float16 activations,
   served alike, every product on the float16 forms of small_m and
   wgmma (replays x (7 x 32 + 1), none on another form), its
   teacher-forced check with the int8 fault among its controls, and its
   logits within INT8_REL_L2 of the float16 engine's. Every plain logit
   must be finite (the plain int8 order rounds x @ q to float16 before
   the scale, which overflows past 65504). Its launches fill the float16
   rows of the kernels line.
13. (run after phase 12) the generic kernels on served paths: Llama-3.2-1B's
   widths in bfloat16 (the launcher's ``1b`` preset, seed-0 weights) at
   page size 8, as the reference's ``--kv-cache-block-size 8`` gives
   (1,024 pages, page buckets 16 and 128, the default chunk of 512):
   warmed, phase 4's requests served over HTTP with no capture after
   warmup, every prefill call on the generic prefill kernel and every
   decode call on the generic decode kernel, its kernel path against its
   plain path teacher-forced at page 8 (PATH_LIMITS, the two fault
   controls); then the tiny preset (head_dim 16) in float16 and
   bfloat16 at page 16 and in float32 at page 4, one request each on the
   card with every prefill call on the generic kernel. Its launches fill
   the generic prefill rows of the kernels line.
14. (run last) Mistral-Large-2's widths, from Mistral-Large-Instruct-2407's
   published config.json (``model_type`` mistral, D 12288, I 28672, 96
   query heads on 8 kv heads of head_dim 128: a GQA group of 12, V 32768,
   rope theta 1e6, an untied head) through ``ModelConfig.from_hf_config``,
   at 4 of its 88 layers, bfloat16, seed-0 weights, the default
   EngineConfig (page 64), an engine built directly: warmed, phase 4's
   requests served over HTTP with no capture after warmup, every decode
   call on the generic decode kernel (window replays x 4 x K) and every
   prefill call on the generic prefill kernel, none on another route;
   its kernel path against its plain path teacher-forced at PATH_LIMITS
   with the two fault controls. Its launches fill the generic decode row
   of the kernels line.
15. (run after phase 6, on phase 4's seed-0 8B weights, shared, before
   its engine leaves the card) the reference's synchronous decode arms
   (:func:`sync_arms_phase`): the default engine, (a) the launcher's
   ``--prefill-token-budget 256`` (pipelined windows with budgeted
   mixing), (b) ``--spec-decode --spec-tokens 4 --prefill-token-budget
   256``, (c) ``EngineConfig(decode_steps=1, prefill_token_budget=
   256)`` built directly and (d) the default config with
   ``coalesce_window_emissions=False``, (a)-(d) at ``max_batch`` 8 (their grids
   trimmed to the batch the traffic reaches), one engine at a time, each
   warmed and freed before the next, on the same traffic (phase 4's four
   requests, a 2,048-token prompt sent while they decode, a greedy
   prompt repeating a 40-token passage three times, a sampled and a
   logprobs request): no capture after warmup, decode dispatched beside
   a prefill in (a)-(c), decode launches = (window replays x K + step
   replays) x 32 on bf16_mma and prefill launches = (chunk + verify
   replays) x 32 on the bf16 route, an accepted draft on the repeated
   passage, no bypass row verified, (b)'s greedy tokens (a)'s up to a
   plain-path near-tie; (d) the default engine with
   ``coalesce_window_emissions=False``: every EngineOutput one token at
   most, its greedy tokens the default engine's up to a plain-path
   near-tie; then the single step and the verify step kernel
   path against plain path at PATH_LIMITS with a fault control each.
   Prints each engine's ITL mean and max and TTFT (records); its
   launches fill the kernels line's single-step and verify rows.
16. (run after phase 15, on phase 4's seed-0 8B weights) the distributed
   runtime (:func:`runtime_phase`). (a) Three processes on the card: the
   control plane (``python -m dynamo_tpu_torch.runtime.dcp_server``), a
   worker (the launcher's ``in=dyn://dynamo.llama8b.generate out=torch
   --model 8b --seed 0 --max-batch-size 4``: the same weights, built and
   warmed before it attaches) and a frontend (``in=http out=dyn``), each
   launcher under this script's ``--dyn-role`` stamps. Once the frontend
   lists the model, phase 4's four requests go at once and one streaming
   request of 64 tokens after them, and the worker gets SIGTERM when that
   stream's first chunk arrives: every request finishes, the streams end
   in [DONE], the greedy tokens are phase 4's or first differ where the
   plain path's top-2 margin is under 0.25 (:func:`margin_rule`); each
   request's TTFT stages are printed (client send -> frontend receive ->
   worker handler entry -> engine entry -> first token). The worker
   drains (``runtime/revive.py drain_worker``): the stream in flight
   still finishes ``length`` with all 64 tokens, the frontend lists no
   model within the lease TTL (10 s) of the SIGTERM, the worker logs a
   clean drain and exits 0 within ``DYN_DRAIN_TIMEOUT_MS`` (10 s) of it,
   and its serving summary shows no capture after warmup, every decode
   launch on bf16_mma and every prefill launch on bf16; the drain's times
   are printed (``drain after SIGTERM``). (b) In this process, every span
   sampled (``DYN_TRACE_SAMPLE=1``), two 8B engines on phase 4's weight
   tensors (``max_batch`` 8, the default pool each, the plain graphs
   warmed: no request of (b) asks for logprobs), each behind
   ``serve_token_model`` on its own runtime attachment with a KV event
   publisher, and the KvRouter, Processor and HTTP service in front: four
   prompts of one 640-token prefix (10 pages) with their own 32-token
   suffixes go one by one, then all at once, then a prompt with a fresh
   prefix. Every request after the first that shares the prefix goes to
   the worker that holds it (its engine counts >= 640 prefix-hit tokens a
   repeat, the router's hit rate is above 0), the fresh prefix overlaps
   nothing, the index holds the stored blocks less the removed ones, no
   capture after warmup, and the routed greedy tokens are one engine's
   under the margin rule. One request's ``/v1/traces/{rid}`` is one tree:
   ``http.request`` the root, ``preprocess``, ``route`` and
   ``serve.generate_tokens`` its children, the engine's cost block beside
   it (``(b) trace of``); the router's ``stats()`` holds a calibration
   entry for each request and its ``load_balance_weight`` and
   ``autotune.adjustments`` are printed (``(b) router calibration``).
   Last, the resume (:func:`resume_check`): phase 4's long prompt as a
   greedy stream of 64 tokens, alone in flight, whose handle a
   ``worker.kill`` chaos rule kills after its second decode window; the
   stream finishes on the sibling with no error event, its finish's cost
   block names one resume, the route fallback counter does not move, the
   sibling captures nothing after warmup, the killed engine frees every
   page, the journal ends empty, and its tokens are the sibling's solo
   control's and phase 4's under the margin rule (the resumed tokens come
   from K/V the prefill kernel wrote); the gap from the dead worker's
   last chunk to the sibling's first is printed (``(b) resume``). Its
   launches join the served path's rows of the kernels line. Two engines
   share one card: no speed is concluded.
17. (run after phase 16, on phase 4's seed-0 8B weights) disaggregated
   prefill/decode (:func:`disagg_phase`): two 8B engines at the default
   ``EngineConfig``, each its own pool, the prefill engine under a
   ``PrefillWorker``, the decode engine under ``build_disagg_decode`` on
   another runtime attachment, served by ``serve_token_model`` with the
   KV event publisher on the inner engine and the KvRouter, Processor
   and HttpService in front. (a) ``prefill_only`` of phase 4's long
   prompt (a variant of its second token: 625 tokens, 10 pages) on the
   prefill engine, its pages extracted and injected into pages reserved
   on the decode engine, which hold them bitwise, within bf16 tolerance
   of a local prefill of the prompt on the decode engine, first token
   equal or a plain-path near-tie. (b) The threshold set to 32 tokens
   with ``publish_config`` (the live watch); greedy requests of 16
   tokens: phase 4's four prompts (17, 41, 55, 625 tokens) one by one,
   then at once, the 625-token prompt again (its decode-side prefix hit
   ships 1 page), phase 4's solo long prompt in bulk mode
   (``chunk_pages=0``), a fresh long prompt int8-compressed, then with
   the worker stopped and ``prefill_timeout`` 2 s the 41-token prompt,
   which must fall back. Each request goes where
   ``DisaggRouter.prefill_remote`` sends it given its reservation's
   prefix hit, ``remote_fallbacks`` is 0 until the fallback and 1 after,
   ``pages_ingested`` is the non-cached prompt pages sent, the greedy
   tokens are phase 4's under the margin rule (the int8 request is held
   to finishing, its injected pages to s/2 of the bf16 pages), no
   capture after warmup, the prefill engine replays prefill chunks only,
   every decode launch on bf16_mma and prefill on bf16, the decode
   engine prefills only its local and fallback prompts, and its KV
   events reach the router's index. Prints per remote request the
   decode-side wait from enqueue until the KV landed, the sender's
   stages, the receiver's inject seconds and the worker-side TTFT
   (records: loopback on one card). Its launches join the served path's
   rows of the kernels line.
18. (run after phase 17, while phase 4's engine holds its share of the
   card) the launcher's benchmark mode as a user runs it
   (:func:`batch_phase`): ``python -m dynamo_tpu_torch.run
   in=batch:FILE out=torch --model 8b --max-batch-size 1 --max-tokens 32
   --context-length 4096 --profile-dir DIR``, the 8B at full width with
   phase 4's seed-0 weights, FILE holding phase 4's four cold-batch
   prompts: a line a request (tokens_in the prompt's words, tokens_out
   in [0, 32]: the chunks that carried text, and the random 8B's tokens
   are mostly past the byte tokenizer's 256 bytes) and the aggregate
   line; the rank's serving summary with no capture after warmup,
   every attention launch a replay's on the bf16 routes and windows
   enough for the 32 tokens; the
   ``torch.profiler`` Chrome trace in DIR naming both hand kernels. Its
   launches join the served path's rows of the kernels line.
19. (on a card the earlier phases have left) MoE at
   Mixtral-8x7B's widths (:func:`moe_phase`): MIXTRAL_8X7B (its published
   config.json) through ``ModelConfig.from_hf_config``, 4 of its 32
   layers, bfloat16, seed-0 weights, the default EngineConfig, an engine
   built directly. (a) Warmed (every bucket of both grids captured);
   phase 4's four prompts submitted to the engine at once, so their
   first chunks pack into one [8, 512] prefill dispatch, which the cost
   model puts on the blocked expert dispatch (2*4096 + 8*256 <= 8*4096/2);
   then phase 4's requests over HTTP (serve_and_check: one at a time and
   four at once, no capture after warmup, every decode call on bf16_mma
   and every prefill call on bf16); from the replayed prefill buckets'
   shapes and ``_moe_use_blocked``, at least one served replay on the
   blocked dispatch and one on the dense sum; then check_paths at
   PATH_LIMITS with its two fault controls (the plain path routed to the
   experts the kernel path picked: :func:`routed`). (b) One layer's MoE
   block alone, bfloat16, at Mixtral's widths on 2,048 tokens and at
   Qwen3-30B-A3B's (D 2048, expert width 768, 128 experts, top 8) on
   1,024: the blocked dispatch and the dense sum against each other and
   each against a float32 computation expert by expert (relative L2
   MOE_REL_L2), each replayed twice from a CUDA graph with the same bits;
   their device times, and the block's share of a 4-row window. (c) The
   same 4-layer Mixtral with int8 weights quantized on the card from the
   seed-0 draw: warmed, phase 4's four prompts at once; every int8 GEMM
   launch accounted for by the replayed buckets (``small_m`` in the
   windows, ``wgmma`` in the blocked prefill); check_paths against its
   plain int8 path with the int8 fault control. Its launches join the
   bf16 attention rows and the bf16 int8 rows of the kernels line.
20. (run last) MLA at DeepSeek-V2-Lite's widths (:func:`mla_phase`):
   DEEPSEEK_V2_LITE (its published config.json) through
   ``ModelConfig.from_hf_config``, 4 of its 27 layers (the dense first
   layer and 3 MoE layers of 64 experts, top 6, and 2 shared experts),
   bfloat16, seed-0 weights, the default EngineConfig, an engine built
   directly, which the registry puts on ``models/mla.py`` and the
   engine's generic window. (a) Warmed (every bucket of both grids);
   phase 4's four prompts at once (their first chunks pack into one
   [8, 512] dispatch, which the cost model puts on the blocked expert
   dispatch: 4096*6 + 64*256 <= 4096*64/2), then phase 4's requests
   over HTTP (serve_and_check); no capture after warmup, served replays
   on both expert dispatches, and no launch of either attention kernel
   (latent attention is plain torch, as it is XLA in the JAX package);
   one window and two chunks replayed against the same calls made
   eagerly (check_graph_window, check_graph_prefill); the teacher-forced
   prefill and window against the same model in float32 on the card
   (MLA_F32_LIMITS, with a zeroed latent row as the fault control). (b)
   The blocks alone, bfloat16, each against a float32 computation: one
   MLA attention layer at V2-Lite's and at DeepSeek-V3's widths (q LoRA
   1536, 128 heads) on the 4-row window and a 512-token first chunk;
   V3's router (256 experts, top 8, 8 groups, top 4 groups, a nonzero
   selection bias, renormalised, scaled by 2.5) on 2,048 tokens; V2-Lite's
   MoE block on 4 rows and 2,048 tokens, each dispatch replayed twice
   from a CUDA graph with the same bits; their device times beside their
   bounds, and the blocks' shares of a 4-row window. (c) The same 4-layer
   model with int8 weights quantized on the card: warmed (its plain
   variants: it serves no logprobs request), the four prompts at once, every int8 GEMM launch accounted for by the replayed
   buckets (``small_m`` in the windows, ``wgmma`` in the blocked chunk),
   check_paths against its plain int8 path with the int8 fault control.
   Its int8 launches join the bf16 int8 rows of the kernels line.

21. (run after phase 17, on phase 4's seed-0 8B weights) the host KV
   tier (:func:`tier_phase`): two 8B engines, one at a time, each a
   40-page device pool, 64 host pages (pinned), batches of up to 4, the
   grids trimmed to the traffic's, LRU eviction: (a) the default tier
   (``host_tier_int8`` resolves True), (b) the lossless tier with
   ``tier_restore_chunk=4``. Phase 4's long prompt A (625 tokens, 9 full
   pages), greedy with logprobs; A again (the HBM-hit control); four
   fresh 704-token prompts that push A's pages out to the host; A a
   third time (the host hit). Both: the host hit's cost block counts >=
   9 restored blocks and a restore wait above 0, the tier offloaded and
   restored pages, ``cache.restore`` events on the step timeline, no
   capture and no pinned allocation after warmup, every decode launch
   on bf16_mma (window replays x 32 x K) and every prefill launch on
   bf16 (chunk replays x 32). (a): the host hit's tokens the control's
   up to a plain-path near-tie (:func:`margin_rule`); the device
   ``quantize_pages`` of A's pages bitwise the same function's on the
   CPU and the numpy host form's int8 rows wherever its scale (a true
   division by 127) is the same float, the others one ulp away at most;
   the restored pages bitwise the bf16 cast of their device round trip,
   within s/2 an element of the evicted pages before the cast. (b): A's
   restore gated over three drains of at most 4 pages; the restored
   pages, the host hit's tokens and every logprob bitwise the control's;
   then A evicted again and restored with ``restore_overlap`` off: the
   same bits. Records the cold, HBM-hit and host-hit TTFT of A, each
   restore batch's dispatch ms, the pinned pools' allocation time, and
   offload and restore GB/s (CUDA events on the engine's stream). Its
   launches join the served path's rows of the kernels line.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Without a GPU, or
without the rest of the repository beside it, it fails and prints no
result.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12       # dense bf16 tensor cores
H100_F32_FLOPS = 67e12         # float32 outside the tensor cores
H100_TF32_FLOPS = 494.7e12     # dense TF32 tensor cores
# the decode kernels of each route (ops.paged_attention.decode_route)
DECODE_KERNELS = {"bf16_mma": "paged_decode_bf16_kernel",
                  "f16_mma": "paged_decode_bf16_kernel<hd, __half>",
                  "f32": "paged_decode_f32_kernel",
                  "generic": "paged_decode_generic_kernel"}
# phase 5's decode shapes: max abs error over the plain output's rms. The
# bf16 tolerance alone is as large as the outputs of rows of thousands of
# keys (rms ~0.026 at 3,968), where a lost 16-key block moves the output
# by ~4/sqrt(keys) of its rms, up to ~0.3 of it at the worst element
DECODE_REL_RMS = 0.1


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


# the monotonic time each phase began ("phase N" -> seconds)
PHASE_START = {}


def log(msg: str) -> None:
    if msg.startswith("phase "):
        PHASE_START[msg.split(":", 1)[0]] = time.monotonic()
    print(msg, flush=True)


# ------------------------------------------------------------------ timing


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    the graph replayed between two CUDA events. The host's per-call
    launch overhead is out of the measurement (see :func:`eager_ms`).
    The warm-up runs on the stream that is then captured."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    reps = 5
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (iters * reps)


def once_ms(fn) -> float:
    """Device time of one call, between two CUDA events (for a call too
    slow to repeat)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def eager_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Wall time per call when called back to back from Python: the larger
    of the device time and the host's launch overhead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item()) if a.numel() else 0.0


def tolerance(dtype) -> tuple:
    """(atol, rtol) of a kernel against its plain version: float32 atol
    1e-5 (the same math, another summation order; 3xTF32 products within
    ~1e-6 of float32 ones); bfloat16 atol 2e-2 + rtol 1e-2 (one or two
    bf16 roundings of the output at any magnitude)."""
    import torch

    return (1e-5, 0.0) if dtype == torch.float32 else (2e-2, 1e-2)


def excess(got, want, atol: float, rtol: float) -> float:
    """Largest amount by which |got - want| passes atol + rtol * |want|
    (<= 0 when every element is within tolerance)."""
    if not got.numel():
        return 0.0
    g, w = got.float(), want.float()
    return float(((g - w).abs() - atol - rtol * w.abs()).max().item())


# --------------------------------------------------------- kernel checks


def check_decode(dev) -> dict:
    import torch

    from dynamo_tpu_torch.ops import paged_attention as ops
    from dynamo_tpu_torch.ops.paged_attention import (
        decode_reference, paged_attention_decode_layered)

    errs = {}
    routes = set()  # (dtype, route) of the calls
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [
        # (name, L, N, KV, G, ps, hd, P, lengths, lower, softcap)
        ("8b", 2, 64, 8, 4, 64, 128, 8,
         [0, 1, 64, 65, 300, 512, 7], [0, 0, 0, 10, 200, 500, 7], None),
        ("8b-softcap", 2, 64, 8, 4, 64, 128, 8,
         [33, 0, 511, 128], [0, 0, 0, 100], 30.0),
        ("small", 3, 32, 2, 1, 16, 32, 4, [1, 0, 16, 64], [0, 0, 3, 60],
         15.0),
        ("mha-64", 1, 16, 4, 2, 8, 64, 5, [5, 40, 17], [0, 30, 17], None),
        # enough rows x kv heads to fill the card: no page split
        ("8b-b40", 1, 64, 8, 4, 64, 128, 4, [(7 * i) % 257 for i in range(40)],
         [max(0, (7 * i) % 257 - 100) for i in range(40)], None),
        # outside the float32 and the bf16 kernels' sets, on the generic
        # kernel in every dtype: head_dim 96 at page 4; Mistral-Large's 12
        # heads a kv head; 16 on one kv head at page 3; 71 on one (five
        # head tiles) at head_dim 80, page 48; page 256; float32 head_dim 7
        ("generic", 2, 32, 2, 3, 4, 96, 8, [0, 5, 17, 32], [0, 0, 3, 20],
         20.0),
        ("generic-g12", 1, 48, 2, 12, 64, 128, 8, [0, 1, 64, 300, 511],
         [0, 0, 0, 10, 200], None),
        ("generic-g16", 1, 64, 1, 16, 3, 64, 40, [40, 7, 0, 100],
         [0, 2, 0, 50], 30.0),
        ("generic-mqa71", 1, 24, 1, 71, 48, 80, 4, [33, 150, 0], [0, 20, 0],
         20.0),
        ("generic-page256", 1, 12, 2, 4, 256, 128, 4, [300, 600, 1, 0],
         [0, 257, 0, 0], None),
        ("generic-hd7", 1, 32, 2, 3, 5, 7, 8, [20, 9, 0], [0, 0, 0], 15.0),
        # 16-byte rows no more in 16 bits (8-byte copies), and head_dim
        # past 256 (two value-column tiles), at the 8B's heads for 512
        ("generic-hd20", 1, 32, 2, 4, 16, 20, 4, [20, 0, 60], [0, 0, 5],
         None),
        ("generic-hd320", 1, 24, 2, 4, 16, 320, 6, [40, 0, 90], [0, 0, 33],
         20.0),
        ("generic-hd512", 1, 24, 8, 4, 16, 512, 6, [40, 0, 90], [0, 0, 33],
         None),
    ]
    # float32: atol 1e-5 (same math, another summation order); bfloat16
    # and float16: atol 2e-2 + rtol 1e-2, i.e. one or two bf16 roundings
    # of the output at any magnitude
    for dname, tol, rtol in DTYPE_TOLS:
        dtype = getattr(torch, dname)
        # the shapes phase 13's tiny engines serve (4 heads on 2 kv heads,
        # head_dim 16: the kernel's narrowest width): page 16 in the
        # 16-bit types, page 4 in float32, at the served context of 28
        tiny = ("generic-tiny", 2, 48, 2, 2,
                4 if dtype == torch.float32 else 16, 16, 16,
                [TINY_SERVED_CTX[0], 0, 17, 5, 60], [0, 0, 3, 0, 20], None)
        for name, L, N, KV, G, ps, hd, P, lengths, lower, softcap in (
                cases + [tiny]):
            B, H = len(lengths), KV * G
            kp = torch.randn(L, N, KV, ps, hd, generator=g, device=dev).to(dtype)
            vp = torch.randn(L, N, KV, ps, hd, generator=g, device=dev).to(dtype)
            q = torch.randn(B, H, hd, generator=g, device=dev).to(dtype)
            table = torch.randint(1, N, (B, P), generator=g, device=dev,
                                  dtype=torch.int32)
            ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
            lo = torch.tensor(lower, dtype=torch.int32, device=dev)
            route = ops.DECODE_ROUTES[ops.decode_route(dtype, H, KV, ps,
                                                       hd)]
            if name.startswith("generic") and route != "generic":
                fail(f"decode {name} {dtype}: on the {route} route, not the "
                     f"generic kernel")
            for layer in range(L):
                for stats in (True, False):
                    before = dict(ops.DECODE_ROUTE_LAUNCHES)
                    got = paged_attention_decode_layered(
                        q, kp, vp, layer, table, ln, return_stats=stats,
                        softcap=softcap, lower=lo)
                    torch.cuda.synchronize()
                    if ops.DECODE_ROUTE_LAUNCHES[route] != before[route] + 1:
                        fail(f"decode {name} {dtype}: not on the {route} "
                             f"route")
                    routes.add((dtype, route))
                    want = decode_reference(q, kp, vp, layer, table, ln, lo,
                                            hd ** -0.5, softcap)
                    got = got if stats else (got,)
                    e = max_err(got[0], want[0])
                    if stats:
                        # stats are float32 on both sides; l grows with the
                        # number of keys, so hold it relatively
                        rel = ((got[2] - want[2]).abs()
                               / want[2].abs().clamp(min=1.0)).max().item()
                        e_m = max_err(got[1], want[1])
                        if rel > 1e-4 or e_m > 1e-4:
                            fail(f"decode stats {name} {dtype}: l rel "
                                 f"{rel:.3g} m {e_m:.3g}")
                    if excess(got[0], want[0], tol, rtol) > 0:
                        fail(f"decode {name} {dtype} layer {layer} stats="
                             f"{stats}: max abs err {e:.3g} > {tol} + "
                             f"{rtol}|x|")
                    zero = [i for i, n in enumerate(lengths) if n == 0]
                    if zero and got[0][zero].abs().max().item() != 0.0:
                        fail(f"decode {name}: length-0 rows not zero")
                    key = (name, str(dtype).split(".")[-1])
                    errs[key] = max(errs.get(key, 0.0), e)
    need_routes(routes, "decode", DECODE_NEEDS)
    for (name, dt), e in sorted(errs.items()):
        log(f"  decode {name:10s} {dt:8s} max_abs_err {e:.3g}")
    return errs


# (dtype, atol, rtol) of the kernel checks, each dtype's routes that
# phases 2 and 3 must take
DTYPE_TOLS = (("float32", 1e-5, 0.0), ("bfloat16", 2e-2, 1e-2),
              ("float16", 2e-2, 1e-2))
DECODE_NEEDS = [("float32", "f32"), ("float32", "generic"),
                ("bfloat16", "bf16_mma"), ("bfloat16", "generic"),
                ("float16", "f16_mma"), ("float16", "generic")]
PREFILL_NEEDS = [("float32", "f32"), ("float32", "generic"),
                 ("bfloat16", "bf16"), ("bfloat16", "generic"),
                 ("float16", "f16"), ("float16", "generic")]


def need_routes(routes: set, what: str, required) -> None:
    """Fail unless a check's calls (``routes``: the (dtype, route) each
    call took, by the launch counts) took every (dtype, route) of
    ``required``, so that each kernel of a route was held to its plain
    version (dtypes by name)."""
    import torch

    for name, route in required:
        dtype = getattr(torch, name)
        if (dtype, route) not in routes:
            fail(f"{what}: no {dtype} call on the {route} route")


def check_window(dev) -> dict:
    """The fused-window form of the decode kernel (pool + in-flight buffer,
    folded in the kernel on every route) against its plain version."""
    import torch

    from dynamo_tpu_torch.ops import paged_attention as ops
    from dynamo_tpu_torch.ops.paged_attention import (
        paged_attention_decode_window, window_reference)

    errs = {}
    routes = set()  # (dtype, route) of the calls
    g = torch.Generator(device=dev).manual_seed(2)
    L, Kw = 2, 4
    pools = (
        # (N, KV, G, ps, hd, layouts): the 8B's heads
        (700, 8, 4, 64, 128, (
            # rows of 0 to 12 pages, a padding row
            ("mixed", 12, [-1, 0, 64, 300, 511, 700]),
            # the served decode shapes: the batch bucket of 4 rows, the
            # page bucket of 64 (so most of the flash-decoding splits are
            # empty), the served contexts of 40 to 656 positions
            ("served", 64, [40, 64, 86, 656]))),
        # outside the float32 and the bf16 kernels' sets, on the generic
        # kernel: head_dim 96 at page 4; Mistral-Large's 12 heads a kv
        # head at page 64; 71 on one kv head at head_dim 80, page 48; page
        # 256; float32 head_dim 7
        (64, 2, 3, 4, 96, (("generic", 8, [-1, 0, 5, 17, 30]),)),
        (64, 2, 12, 64, 128, (("generic-g12", 12, [-1, 0, 64, 300, 700]),)),
        (24, 1, 71, 48, 80, (("generic-mqa71", 6, [-1, 33, 150]),)),
        (12, 2, 4, 256, 128, (("generic-page256", 4, [-1, 300, 600]),)),
        (40, 2, 3, 5, 7, (("generic-hd7", 8, [-1, 0, 9, 37]),)),
        (32, 2, 4, 16, 20, (("generic-hd20", 4, [-1, 0, 20, 60]),)),
        (32, 2, 4, 16, 320, (("generic-hd320", 6, [-1, 0, 40, 90]),)),
        (32, 8, 4, 16, 512, (("generic-hd512", 6, [-1, 40, 90]),)),
    )
    for (dname, tol, rtol), (N, KV, G, ps, hd, layouts) in (
            (d, p) for d in DTYPE_TOLS
            # and the shapes phase 13's tiny engines serve: 4 heads on 2
            # kv heads, head_dim 16, page 16 in 16 bits, page 4 in float32
            for p in pools + ((64, 2, 2, 4 if d[0] == "float32" else 16, 16,
                               (("generic-tiny", 16,
                                 [-1, 0, 24, 27, 40]),)),)):
        dtype = getattr(torch, dname)
        H = KV * G
        route = ops.DECODE_ROUTES[ops.decode_route(dtype, H, KV, ps, hd)]
        if layouts[0][0].startswith("generic") and route != "generic":
            fail(f"decode window {layouts[0][0]} {dtype}: on the {route} "
                 f"route, not the generic kernel")
        kp = torch.randn(L, N, KV, ps, hd, generator=g, device=dev).to(dtype)
        vp = torch.randn(L, N, KV, ps, hd, generator=g, device=dev).to(dtype)
        for lay, P, starts in layouts:
            start = torch.tensor(starts, dtype=torch.int32, device=dev)
            B = start.numel()
            table = torch.stack([torch.randperm(N - 1, generator=g,
                                                device=dev)[:P] + 1
                                 for _ in range(B)]).to(torch.int32)
            q = torch.randn(B, H, hd, generator=g, device=dev).to(dtype)
            wk = torch.randn(B, Kw, KV, hd, generator=g, device=dev).to(dtype)
            wv = torch.randn(B, Kw, KV, hd, generator=g, device=dev).to(dtype)
            for name, win, softcap in (("global", None, None),
                                       ("sliding", 100, 30.0),
                                       ("narrow", 2, None)):
                for n_win in range(1, Kw + 1):
                    qp = (start.clamp(min=0) + n_win - 1).to(torch.int32)
                    eff = (None if win is None else
                           torch.full((B,), win, dtype=torch.int32,
                                      device=dev))
                    for layer in range(L):
                        before = ops.DECODE_ROUTE_LAUNCHES[route]
                        got = paged_attention_decode_window(
                            q, kp, vp, layer, table, start, qp, wk, wv,
                            n_win, softcap=softcap, eff_win=eff)
                        torch.cuda.synchronize()
                        if ops.DECODE_ROUTE_LAUNCHES[route] != before + 1:
                            fail(f"decode window {lay} {dtype}: not on the "
                                 f"{route} route")
                        routes.add((dtype, route))
                        want = window_reference(q, kp, vp, layer, table,
                                                start, qp, wk, wv, n_win,
                                                hd ** -0.5, softcap, eff)
                        e = max_err(got, want)
                        if excess(got, want, tol, rtol) > 0:
                            fail(f"decode window {lay} {name} {dtype} "
                                 f"n_win={n_win}: max abs err {e:.3g}")
                        pad = start < 0
                        if pad.any() and got[pad].abs().max().item() != 0.0:
                            fail("decode window: padding row not zero")
                        key = (f"{lay}-{name}", str(dtype).split(".")[-1])
                        errs[key] = max(errs.get(key, 0.0), e)
    need_routes(routes, "decode window", DECODE_NEEDS)
    for (name, dt), e in sorted(errs.items()):
        log(f"  window {name:15s} {dt:8s} max_abs_err {e:.3g}")
    return errs


def check_prefill(dev) -> dict:
    import torch

    from dynamo_tpu_torch.ops import paged_attention as ops
    from dynamo_tpu_torch.ops.paged_attention import (NO_WINDOW,
                                                      paged_attention_prefill,
                                                      prefill_reference)

    errs = {}
    routes = set()  # (dtype, route) of the calls
    g = torch.Generator(device=dev).manual_seed(1)
    # tolerances as in check_decode; the 16-bit tensor-core forms also
    # round the probabilities to their type before P V, as the gather path
    # does
    for dname, tol, rtol in DTYPE_TOLS:
        dtype = getattr(torch, dname)
        cases = []
        # 8B: first chunk of 512 with a padding row and a short row
        N, KV, G, ps, hd, P, T = 64, 8, 4, 64, 128, 16, 512
        pos = torch.full((3, T), -1, dtype=torch.int32)
        pos[0] = torch.arange(T)
        pos[1, :200] = torch.arange(200)
        cases.append(("8b-chunk1", N, KV, G, ps, hd, P, P, pos,
                      [NO_WINDOW] * 3, None))
        # 8B: a second chunk continuing at position 512
        pos = (512 + torch.arange(256, dtype=torch.int32))[None]
        cases.append(("8b-chunk2", N, KV, G, ps, hd, P, P, pos, [NO_WINDOW],
                      None))
        # 8B: the fourth chunk of a 2048-token prompt (positions
        # 1536-2047), 32 of the 64-entry page table in use
        pos = (1536 + torch.arange(512, dtype=torch.int32))[None]
        cases.append(("8b-chunk4", N, KV, G, ps, hd, 64, 32, pos,
                      [NO_WINDOW], None))
        # sliding window + softcap, second chunk past the window: pages
        # wholly below it are skipped
        pos = (300 + torch.arange(64, dtype=torch.int32))[None].repeat(2, 1)
        pos[1, 40:] = -1
        cases.append(("window", N, KV, G, ps, hd, P, P, pos, [100, 37], 20.0))
        # small shapes: group 2; float32 at head_dim 32, page 4, bfloat16
        # at head_dim 64, page 16 (the smallest the bf16 kernel takes)
        pos = torch.stack([torch.arange(8, 24), torch.arange(16)]).to(torch.int32)
        f32 = dtype == torch.float32
        cases.append(("small", 32, 2, 2, 4 if f32 else 16, 32 if f32 else 64,
                      8, 8, pos, [NO_WINDOW, 5], None))
        # the generic kernel in every dtype: head_dim 96 at page 4, the
        # deep chunk (positions 1536-2047) at head_dim 96 and page 8, and
        # MQA (71 heads on one kv head: two head tiles) at head_dim 80
        # and page 48 with a window and the softcap
        cases.append(("generic", 32, 2, 2, 4, 96, 8, 8, pos, [NO_WINDOW, 5],
                      None))
        pos = (1536 + torch.arange(512, dtype=torch.int32))[None]
        cases.append(("generic-deep", 300, 8, 4, 8, 96, 256, 256, pos,
                      [NO_WINDOW], None))
        pos = torch.stack([torch.arange(90, 130),
                           torch.arange(40)]).to(torch.int32)
        pos[1, 25:] = -1
        cases.append(("generic-mqa", 12, 1, 71, 48, 80, 4, 3, pos,
                      [NO_WINDOW, 30], 20.0))
        # the shapes phase 13's tiny engines serve (4 heads on 2 kv heads,
        # head_dim 16: the kernel's narrowest width): page 16 in the
        # 16-bit types, page 4 in float32; the served 16-token chunk and a
        # chunk continuing mid-sequence with padding and a window
        pos = torch.stack([torch.arange(16),
                           torch.arange(12, 28)]).to(torch.int32)
        pos[1, 12:] = -1
        cases.append(("generic-tiny", 32, 2, 2, 4 if f32 else 16, 16, 8, 8,
                      pos, [NO_WINDOW, 5], None))
        # head_dim 20 and 7 (no 16-byte rows), 320 and 512 (two value
        # column tiles; 512 at the 8B's heads), a window and the softcap
        pos = torch.stack([torch.arange(20, 60),
                           torch.arange(40)]).to(torch.int32)
        pos[1, 30:] = -1
        for hd_w, KV_w in ((20, 2), (7, 2), (320, 2), (512, 8)):
            cases.append((f"generic-hd{hd_w}", 16, KV_w, 4, 16, hd_w, 8, 6,
                          pos, [NO_WINDOW, 25], 20.0))
        # the verify step of --spec-tokens 4: T = 5 queries a row, rows
        # starting mid-page, on a page's last slot, on a boundary and at
        # 1, and a padding row; on every prefill route: the 8B's heads
        # (the dtype's fast route at page 64) and head_dim 96 at page 8
        starts = [37, 63, 64 + 5, 1]
        pos = torch.full((5, 5), -1, dtype=torch.int32)
        for b, st in enumerate(starts):
            pos[b] = torch.arange(st, st + 5)
        cases.append(("verify-8b", 16, 8, 4, 64, 128, 4, 2, pos,
                      [NO_WINDOW] * 5, None))
        cases.append(("generic-verify", 64, 2, 4, 8, 96, 12, 10, pos,
                      [NO_WINDOW] * 5, None))
        for name, N, KV, G, ps, hd, P, used, pos, win, softcap in cases:
            B, T = pos.shape
            H = KV * G
            kp = torch.randn(N, KV, ps, hd, generator=g, device=dev).to(dtype)
            vp = torch.randn(N, KV, ps, hd, generator=g, device=dev).to(dtype)
            q = torch.randn(B, T, H, hd, generator=g, device=dev).to(dtype)
            # `used` distinct pages of the pool, then 0 (the engine's
            # padding entry)
            table = torch.zeros((B, P), dtype=torch.int32, device=dev)
            for b in range(B):
                table[b, :used] = torch.randperm(N - 1, generator=g,
                                                 device=dev)[:used] + 1
            qp = pos.to(dev)
            w = torch.tensor(win, dtype=torch.int32, device=dev)
            route = ops.PREFILL_ROUTES[ops.prefill_route(dtype, H, KV, ps,
                                                         hd)]
            before = ops.PREFILL_ROUTE_LAUNCHES[route]
            got = paged_attention_prefill(q, kp, vp, table, qp,
                                          softcap=softcap, eff_win=w)
            torch.cuda.synchronize()
            if ops.PREFILL_ROUTE_LAUNCHES[route] != before + 1:
                fail(f"prefill {name} {dtype}: not on the {route} route")
            if name.startswith("generic") and route != "generic":
                fail(f"prefill {name} {dtype}: on the {route} route, not "
                     f"the generic kernel")
            routes.add((dtype, route))
            want = prefill_reference(q, kp, vp, table, qp, hd ** -0.5,
                                     softcap, w)
            e = max_err(got, want)
            if excess(got, want, tol, rtol) > 0:
                fail(f"prefill {name} {dtype}: max abs err {e:.3g} > {tol} "
                     f"+ {rtol}|x|")
            if (qp < 0).any() and got[qp < 0].abs().max().item() != 0.0:
                fail(f"prefill {name}: padding queries not zero")
            errs[(name, str(dtype).split(".")[-1])] = e
    need_routes(routes, "prefill", PREFILL_NEEDS)
    for (name, dt), e in sorted(errs.items()):
        log(f"  prefill {name:10s} {dt:8s} max_abs_err {e:.3g}")
    return errs


# ------------------------------------------------------------ serving


class TapEngine:
    """Wraps the engine for the smoke's own bookkeeping: records each
    request's tokens and token arrival times, keyed by request id. Every
    other attribute is the engine's (``stats``, ``drain``: what
    ``serve_http`` wires the service's admission and drain to)."""

    def __init__(self, engine):
        self.engine = engine
        self.tokens = {}
        self.times = {}
        self.prompt_len = {}
        self.prompt_ids = {}
        self.logprobs = {}   # request id -> [(logprob, {id: logprob})]

    def __getattr__(self, name):
        return getattr(self.engine, name)

    async def generate(self, request, context):
        self.prompt_len[context.id] = len(request.token_ids)
        self.prompt_ids[context.id] = list(request.token_ids)
        toks = self.tokens.setdefault(context.id, [])
        times = self.times.setdefault(context.id, [])
        async for out in self.engine.generate(request, context):
            if out.token_ids:
                toks.extend(out.token_ids)
                times.append((time.monotonic(), len(out.token_ids)))
            if out.logprobs:
                self.logprobs.setdefault(context.id, []).extend(
                    zip(out.logprobs, out.top_logprobs))
            yield out


class StageClock:
    """Stage stamps of each request's first token, taken by wrapping the
    engine's first-token read-back (``_process_prefill``: the wait on the
    chunk's event, done here first), its emission (``_emit``: entry and
    admission times from the sequence) and both graph sets' launches (a
    log of the dispatches), on this engine instance only."""

    def __init__(self, engine):
        self.read = {}        # request id -> first-token read-back time
        self.emit = {}        # request id -> (arrival, queue wait, emit)
        self.dispatches = []  # (time, kind, bucket key)
        process, emit = engine._process_prefill, engine._emit

        def process_prefill(pf):
            if not pf.processed:
                if pf.event is not None:
                    pf.event.synchronize()
                now = time.monotonic()
                for _, seq in pf.finishing:
                    self.read.setdefault(seq.context.id, now)
            process(pf)

        def emit_first(seq, out):
            if out.token_ids and seq.context.id not in self.emit:
                self.emit[seq.context.id] = (seq.arrival, seq.queue_wait_s,
                                             time.monotonic())
            emit(seq, out)

        engine._process_prefill = process_prefill
        engine._emit = emit_first
        for gs, kind in ((engine.graphs, "decode_window"),
                         (engine.prefill_graphs, "prefill")):
            def launch(bk, real=gs.launch, kind=kind):
                self.dispatches.append((time.monotonic(), kind, bk.key))
                real(bk)
            gs.launch = launch

    def stages(self, rid, sent, tap_first) -> dict:
        """The request's TTFT and its stages (ms), and the dispatches
        between its admission and its first token's read-back."""
        arrival, wait, emitted = self.emit[rid]
        admit, read = arrival + wait, self.read[rid]
        ahead = [(kind, list(key)) for t, kind, key in self.dispatches
                 if admit <= t <= read]
        return {
            "ttft_ms": (tap_first - sent) * 1e3,
            "stages_ms": {
                "send_to_engine": (arrival - sent) * 1e3,
                "queue_wait": wait * 1e3,
                "admit_to_readback": (read - admit) * 1e3,
                "readback_to_emit": (emitted - read) * 1e3,
                "emit_to_http": (tap_first - emitted) * 1e3},
            "engine_ttft_ms": (emitted - arrival) * 1e3,
            "ahead": {"prefill": [k for kind, k in ahead
                                  if kind == "prefill"],
                      "decode_windows": sum(kind == "decode_window"
                                            for kind, _ in ahead)},
        }


def _ttft_hist(engine) -> tuple:
    h = engine.stats()["latency_hist"].get("unified", {}).get("ttft", {})
    return h.get("count", 0), h.get("sum", 0.0)


def only(routes, route: str, n: int) -> dict:
    """Launch counts by route with all ``n`` on ``route``."""
    return {r: n if r == route else 0 for r in routes}


def served_routes(engine) -> tuple:
    """The decode and prefill routes an engine's attention shape takes
    (ops.paged_attention.decode_route, prefill_route), by name."""
    from dynamo_tpu_torch.ops import paged_attention as ops

    c = engine.cfg
    shape = (c.torch_dtype, c.num_heads, c.num_kv_heads,
             engine.ecfg.page_size, c.head_dim_)
    return (ops.DECODE_ROUTES[ops.decode_route(*shape)],
            ops.PREFILL_ROUTES[ops.prefill_route(*shape)])


async def serve_and_check(engine, mdc, operator: bool = False):
    """Serve phase 4's requests over HTTP through ``engine`` and check the
    served path (tokens, finishes, launches by route, graph replays, no
    capture after warmup); with ``operator`` (phase 4 only), also the
    frontend's operator surface (:func:`operator_checks`) before the
    launch counts are read."""
    import collections

    import aiohttp

    from dynamo_tpu_torch.runtime import profiling

    from dynamo_tpu_torch.ops import int8_gemm
    from dynamo_tpu_torch.ops import paged_attention as ops
    from dynamo_tpu_torch.run import serve_http

    tap = TapEngine(engine)
    clock = StageClock(engine)
    svc = await serve_http(tap, mdc, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{svc.port}"
    sent = {}
    results = {}
    # requests sent by (endpoint, request type), and each stream's data
    # chunks (the frontend's TTFT and ITL histograms count them)
    kinds = collections.Counter()
    stream_chunks = {}

    async def chat(s, rid, content, max_tokens, stream):
        body = {"model": mdc.name, "stream": stream, "max_tokens": max_tokens,
                "messages": [{"role": "user", "content": content}]}
        sent[rid] = time.monotonic()
        async with s.post(f"{base}/v1/chat/completions", json=body,
                          headers={"X-Request-Id": rid}) as r:
            if r.status != 200:
                fail(f"{rid}: HTTP {r.status}: {await r.text()}")
            if stream:
                lines = [ln.decode().strip() async for ln in r.content]
                data = [ln[6:] for ln in lines if ln.startswith("data: ")]
                if data[-1] != "[DONE]":
                    fail(f"{rid}: stream did not end with [DONE]")
                stream_chunks[rid] = len(data) - 1
                fin = [c["finish_reason"] for d in data[:-1]
                       for c in json.loads(d)["choices"] if c.get("finish_reason")]
                results[rid] = fin[-1] if fin else None
            else:
                out = await r.json()
                results[rid] = out["choices"][0]["finish_reason"]
        kinds["chat_completions", "stream" if stream else "unary"] += 1

    async def completion(s, rid, prompt, max_tokens):
        sent[rid] = time.monotonic()
        async with s.post(f"{base}/v1/completions", json={
                "model": mdc.name, "prompt": prompt,
                "max_tokens": max_tokens},
                headers={"X-Request-Id": rid}) as r:
            if r.status != 200:
                fail(f"{rid}: HTTP {r.status}: {await r.text()}")
            results[rid] = (await r.json())["choices"][0]["finish_reason"]
        kinds["completions", "unary"] += 1

    long_prompt = ("The quick brown fox jumps over the lazy dog. " * 14)[:600]

    async def batch(s, tag, first="T"):
        """The four concurrent requests; their TTFT stages (checked to sum
        to the TTFT within 1 ms, and against the engine's histogram).
        ``first`` replaces the long prompt's first letter: another letter
        changes the hash of each of its full pages, so the batch misses
        the prefix cache and prefills what the first batch did (the three
        short prompts fill no page and never hit it)."""
        n0, sum0 = _ttft_hist(engine)
        rids = [f"{tag}r0-stream", f"{tag}r1-stream", f"{tag}r2-unary",
                f"{tag}r3-completion"]
        t0 = time.monotonic()
        await asyncio.gather(
            chat(s, rids[0], "Tell me about paged attention.", 32, True),
            chat(s, rids[1], first + long_prompt[1:], 32, True),
            chat(s, rids[2], "What is an H100?", 24, False),
            completion(s, rids[3], "Once upon a time", 24))
        wall = time.monotonic() - t0
        stages = {r: clock.stages(r, sent[r], tap.times[r][0][0])
                  for r in rids}
        for r, st in stages.items():
            off = abs(sum(st["stages_ms"].values()) - st["ttft_ms"])
            if off > 1.0:
                fail(f"{r}: TTFT stages sum {off:.3f} ms off its TTFT")
        n1, sum1 = _ttft_hist(engine)
        stamped = sum(st["engine_ttft_ms"] for st in stages.values()) / 1e3
        if n1 - n0 != len(rids) or abs((sum1 - sum0) - stamped) > 1e-3 * len(
                rids):
            fail(f"engine TTFT histogram ({n1 - n0} obs, {sum1 - sum0:.6f} "
                 f"s) disagrees with the stage stamps ({stamped:.6f} s)")
        return rids, wall, stages

    ops.reset_launch_counts()
    int8_gemm.reset_launch_counts()
    replays0 = engine.graph_replays()
    async with aiohttp.ClientSession() as s:
        async with s.get(f"{base}/health") as r:
            if r.status != 200:
                fail("health check failed")
        concurrent, wall, cold = await batch(s, "")
        # the loop-lag samples taken while the warm batches ran
        monitor = profiling.current_loop_profiler().monitor
        beats0 = monitor.beats
        warm = [(await batch(s, f"w{k}-", "ABC"[k - 1]))[2]
                for k in range(1, 4)]
        warm_lag = list(monitor.samples)[
            len(monitor.samples) - (monitor.beats - beats0):]
        # the cold batch's requests again: the long prompt's first nine
        # pages come from the prefix cache
        hit = (await batch(s, "hit-"))[2]
        # the sampled-profiler batch: every iteration drains the device
        # once per dispatch, so it is timed by the profiler only
        engine.profiler.sample = 1
        try:
            await batch(s, "prof-", "D")
        finally:
            engine.profiler.sample = 0
        bucket_cost = engine.stats()["bucket_cost"]
        # the same greedy request twice, alone: identical tokens
        for rid in ("r4-repeat", "r5-repeat"):
            await chat(s, rid, "Tell me about paged attention.", 32, False)
    # the four requests again, one at a time, with logprobs (top 5): the
    # warmed logprobs variants; phase 8's reference
    solo = await solo_logprobs(base, mdc.name, "solo")
    for kind, *_ in SOLO:
        kinds["chat_completions" if kind == "chat" else "completions",
              "unary"] += 1
    op_report = None
    if operator:
        op_report = await operator_checks(
            svc, tap, engine, base, mdc.name, kinds, stream_chunks,
            warm_lag)
    launches = dict(ops.LAUNCHES)
    route_launches = dict(ops.DECODE_ROUTE_LAUNCHES)
    prefill_routes = dict(ops.PREFILL_ROUTE_LAUNCHES)
    int8_launches = dict(int8_gemm.INT8_GEMM_LAUNCHES)
    replayed = engine.graph_replays()
    replays = (replayed["prefill"] - replays0["prefill"],
               replayed["decode_window"] - replays0["decode_window"])
    await svc.stop()
    await engine.stop()
    compiles = engine.stats()["post_warmup_compiles_total"]
    if compiles != 0:
        fail(f"{compiles} graphs captured while serving (after warmup): a "
             f"bucket outside the warmed grid")

    for rid, toks in tap.tokens.items():
        # the operator checks' requests (op-*) include refused and
        # timed-out ones; operator_checks holds them to their own answers
        if not toks and not rid.startswith("op-"):
            fail(f"{rid}: no tokens")
    for rid in sent:
        if rid not in tap.tokens or not tap.tokens[rid]:
            fail(f"{rid}: no tokens")
        if results.get(rid) not in ("length", "stop"):
            fail(f"{rid}: finish_reason {results.get(rid)!r}")
    for i, res in enumerate(solo):
        rid = f"solo{i}"
        if len(res["lp"]) != len(tap.tokens.get(rid, ())):
            fail(f"{rid}: {len(res['lp'])} logprob entries for "
                 f"{len(tap.tokens.get(rid, ()))} tokens")
    if tap.tokens["r4-repeat"] != tap.tokens["r5-repeat"]:
        fail("repeated greedy request gave different tokens")
    L, K = engine.cfg.num_layers, engine.ecfg.decode_steps
    if engine.cfg.is_mla:
        # latent attention is plain torch (no TPU kernel to port): the
        # registry kept the model off models/llama.py's kernel path
        if any(launches.values()) or any(route_launches.values()) \
                or any(prefill_routes.values()):
            fail(f"an MLA engine launched attention kernels: {launches}")
    else:
        for name, n in launches.items():
            if n <= 0:
                fail(f"kernel {name} was not launched on the served path")
        # every kernel call of the served path came from a graph replay:
        # the prefill kernel once per layer of each replayed chunk, the
        # decode kernel once per layer and step of each replayed window
        if (launches["paged_attention_prefill"] != replays[0] * L
                or launches["paged_attention_decode"] != replays[1] * L * K):
            fail(f"launches {launches} are not the graph replays' "
                 f"({replays[0]} prefill chunks x {L}, {replays[1]} "
                 f"windows x {L * K})")
        # every call takes the route its shape names (bf16 Llama-3-8B
        # widths: the bf16 kernels; float32 at the 1b widths: the float32
        # kernels)
        want_dec, want_pf = served_routes(engine)
        if route_launches != only(ops.DECODE_ROUTES, want_dec,
                                  launches["paged_attention_decode"]):
            fail(f"decode calls by route on the served path: "
                 f"{route_launches}")
        if prefill_routes != only(ops.PREFILL_ROUTES, want_pf,
                                  launches["paged_attention_prefill"]):
            fail(f"prefill calls by route on the served path: "
                 f"{prefill_routes}")
    # int8 weights: every projection of every replayed chunk and window
    # step through the int8 GEMM (7 a layer, and the head); none in bf16
    per_pass = (7 * L + 1) if engine.quant == "int8" else 0
    if sum(int8_launches.values()) != (replays[0] + replays[1] * K) \
            * per_pass:
        fail(f"int8 GEMM launches {int8_launches} are not the graph "
             f"replays' ({replays[0]} prefill chunks, {replays[1]} windows "
             f"x {K} steps, x {per_pass} products)")
    profiled = {k: v for k, v in bucket_cost.items()
                if k.startswith(("prefill:", "decode_window:"))}
    if not any(k.startswith("prefill:") for k in profiled) or not any(
            k.startswith("decode_window:") for k in profiled):
        fail(f"the sampled batch profiled no prefill or no window: "
             f"{sorted(bucket_cost)}")
    ttft = [tap.times[r][0][0] - sent[r] for r in concurrent]
    itl = []
    for r in concurrent:
        ts = tap.times[r]
        for (a, _), (b, n) in zip(ts, ts[1:]):
            itl += [(b - a) / n] * n
    n_tok = sum(len(tap.tokens[r]) for r in concurrent)
    # per request of the batch, per stage: the warm runs' min and max
    spread = {}
    for i, r in enumerate(concurrent):
        runs = [list(w.values())[i] for w in warm]
        spread[r] = {
            stage: [min(x["stages_ms"][stage] for x in runs),
                    max(x["stages_ms"][stage] for x in runs)]
            for stage in runs[0]["stages_ms"]}
        spread[r]["ttft_ms"] = [min(x["ttft_ms"] for x in runs),
                                max(x["ttft_ms"] for x in runs)]
    served = {
        "requests": len(sent), "concurrent": len(concurrent),
        # informational: the batch of 4 pads to other matmul shapes than a
        # lone request, so bf16 rounding may differ between the two
        "repeat_matches_batched": tap.tokens["r4-repeat"]
        == tap.tokens["r0-stream"],
        "tokens_concurrent": n_tok,
        "tokens_total": sum(len(t) for t in tap.tokens.values()),
        "prompt_tokens": {r: tap.prompt_len[r] for r in concurrent},
        # context lengths of the concurrent rows at their last decode
        # window: the shapes the decode kernel saw
        "decode_lengths": [tap.prompt_len[r] + len(tap.tokens[r]) - 1
                           for r in concurrent],
        "ttft_ms": sorted(round(x * 1e3, 3) for x in ttft),
        "itl_ms_mean": round(sum(itl) / len(itl) * 1e3, 3),
        "itl_ms_max": round(max(itl) * 1e3, 3),
        "output_tok_per_s": round(n_tok / wall, 3),
        "wall_s": round(wall, 3), "launches": launches,
        "route_launches": route_launches,
        "prefill_route_launches": prefill_routes,
        "int8_gemm_launches": int8_launches,
        "replays": {"prefill": replays[0], "decode_window": replays[1]},
        "post_warmup_compiles_total": compiles,
        "decode_graphs": sum(len(gs.buckets) for gs in
                             engine.decode_variants.values()),
        "prefill_graphs": sum(len(gs.buckets) for gs in
                              engine.prefill_variants.values()),
        "graph_capture_s": {
            f"{gs.kind}, {gs.variant}": round(gs.capture_seconds, 3)
            for gs in (*engine.decode_variants.values(),
                       *engine.prefill_variants.values())},
        # the graph pool's own segments, by the captures that added them
        # (each decode variant, then each prefill variant)
        "graph_pool_mib": {k: round(v, 1)
                           for k, v in engine.graph_pool_mib().items()},
        "solo_rids": [f"solo{i}" for i in range(len(solo))],
    }
    if op_report is not None:
        served["operator"] = op_report
    ttft_report = {"cold": cold, "warm": warm, "warm_spread": spread,
                   "prefix_hit": hit, "bucket_cost_sampled": profiled}
    reference = {"http": solo, "tap": {
        rid: {"prompt_ids": tap.prompt_ids[rid], "tokens": tap.tokens[rid],
              "logprobs": tap.logprobs.get(rid, [])}
        for rid in served["solo_rids"]},
        # the cold batch's tokens: phase 16 (a) serves the same four
        # requests at once through a worker process
        "batch": {rid: {"prompt_ids": tap.prompt_ids[rid],
                        "tokens": tap.tokens[rid]} for rid in concurrent}}
    return served, ttft_report, reference


# the keys of a request's cost block (jax_engine.py _attribution)
COST_KEYS = {"queue_wait_ms", "device_step_share", "dispatches",
             "prompt_tokens", "prefix_hit_tokens", "prompt_blocks",
             "device_hit_blocks", "host_restored_blocks", "restore_wait_ms",
             "decode_tokens", "kv_pages_peak", "kv_bytes_peak",
             "device_ms_est", "finish_reason", "replica", "mesh_shape"}


def prom_samples(text: str, name: str) -> dict:
    """``{label body: value}`` of the samples of one metric in a
    Prometheus text exposition."""
    out = {}
    for ln in text.splitlines():
        if ln.startswith(name + "{"):
            labels, value = ln[len(name) + 1:].rsplit("} ", 1)
            out[labels] = float(value)
    return out


def lag_quantiles(samples: list) -> dict:
    """Nearest-rank p50, p99 and max (ms) of loop-lag samples (s)."""
    vals = sorted(samples)
    if not vals:
        return {"samples": 0}

    def pct(q):
        return vals[min(max(int(len(vals) * q / 100.0), 0), len(vals) - 1)]

    return {"samples": len(vals), "p50_ms": round(pct(50) * 1e3, 3),
            "p99_ms": round(pct(99) * 1e3, 3),
            "max_ms": round(vals[-1] * 1e3, 3)}


async def pages_idle(engine, what: str, limit_s: float = 5.0) -> None:
    """Wait until no sequence holds a page (``kv_active_blocks`` 0); fail
    after ``limit_s``."""
    t = time.monotonic()
    while engine.stats()["kv_active_blocks"]:
        if time.monotonic() - t > limit_s:
            fail(f"{what}: {engine.stats()['kv_active_blocks']} pages "
                 f"still held after {limit_s} s with no request in flight")
        await asyncio.sleep(0.01)


async def operator_checks(svc, tap, engine, base: str, name: str,
                          kinds, stream_chunks: dict,
                          warm_lag: list) -> dict:
    """Phase 4's operator surface, on its service and engine after its
    batches: the admission and drain wiring of ``serve_http``; /metrics'
    request counts by status and its TTFT and ITL histogram counts against
    what phase 4 sent and streamed; /live, /health, /debug/slo,
    /debug/cache (against ``stats()``), /debug/profile (the loop lag, and
    over the warm batches), /debug/profile/stacks; /v1/traces and a
    request's trace with its cost block; an ``n = 2`` greedy request whose
    choices are the solo request's tokens (margin_rule); a request whose
    deadline is far below its decode time (504, its pages back); a burst
    of 8 under ``ShedConfig(queue_depth=1)`` (a 503 with Retry-After,
    every admitted one answered); /debug/profile/start, one short request,
    /stop (the trace names both bf16 kernels); an incident captured and
    read back; and last ``POST /drain`` with a stream in flight (it
    finishes, the next request gets 503, a second drain 409). Then the
    attribution's conservation over every finished request."""
    import aiohttp

    from dynamo_tpu_torch.runtime import blackbox, profiling, revive

    t0 = time.monotonic()
    report = {}
    if svc.admission is None or len(svc._drain_cbs) != 1:
        fail(f"serve_http wired admission {svc.admission!r} and "
             f"{len(svc._drain_cbs)} drain callbacks through the tap "
             f"engine")
    label = f"torch-engine-{id(engine):x}"
    async with aiohttp.ClientSession() as s:
        async def get(path, as_json=True):
            async with s.get(base + path) as r:
                body = await (r.json() if as_json else r.text())
                if r.status != 200:
                    fail(f"GET {path}: HTTP {r.status}: {body}")
                return body

        async def post(path, body=None, rid=None, headers=None):
            hdrs = dict(headers or {})
            if rid is not None:
                hdrs["X-Request-Id"] = rid
            async with s.post(base + path, json=body, headers=hdrs) as r:
                if body is not None and body.get("stream"):
                    text = (await r.read()).decode()
                    payload = [ln[6:] for ln in text.splitlines()
                               if ln.startswith("data: ")]
                else:
                    payload = await r.json()
                if rid is not None and (
                        r.headers.get("X-Request-Id") != rid
                        or "traceparent" not in r.headers):
                    fail(f"{rid}: answer without its X-Request-Id or "
                         f"traceparent: {dict(r.headers)}")
                return r.status, dict(r.headers), payload

        def chat(content, max_tokens, **extra):
            return {"model": name, "max_tokens": max_tokens,
                    "messages": [{"role": "user", "content": content}],
                    **extra}

        # /metrics against what phase 4 sent, before any request of these
        # checks: every request a success, streams' first tokens and gaps
        text = await get("/metrics", as_json=False)
        got = prom_samples(text, "dyn_llm_http_service_requests_total")
        want = {f'model="{name}",endpoint="{ep}",request_type="{rt}",'
                f'status="success"': float(n)
                for (ep, rt), n in kinds.items()}
        if got != want:
            fail(f"/metrics requests_total {got} != phase 4's {want}")
        ttft_n = prom_samples(
            text, "dyn_llm_http_service_time_to_first_token_seconds_count")
        itl_n = prom_samples(text, "dyn_llm_http_service_itl_seconds_count")
        key = f'model="{name}"'
        gaps = sum(n - 1 for n in stream_chunks.values())
        if ttft_n.get(key) != len(stream_chunks) or itl_n.get(key) != gaps:
            fail(f"/metrics TTFT count {ttft_n} / ITL count {itl_n} != "
                 f"{len(stream_chunks)} streams / {gaps} chunk gaps")
        report["metrics"] = {"requests": sum(kinds.values()),
                             "streams": len(stream_chunks),
                             "itl_gaps": gaps,
                             "families": sum(ln.startswith("# TYPE ")
                                             for ln in text.splitlines())}
        for path in ("/live", "/health"):
            if (await get(path))["status"] != "healthy":
                fail(f"GET {path}: not healthy")
        slo_view = await get("/debug/slo")
        if set(slo_view) != {"registry", "evaluation", "pressures",
                             "alerts", "goodput"}:
            fail(f"/debug/slo keys {sorted(slo_view)}")
        # a finished request's pages free when its last window in flight
        # lands, which may follow its answer: read the pool with no page
        # held, so the two reads below see the same pool
        await pages_idle(engine, "before /debug/cache")
        st = engine.stats()
        pool = (await get("/debug/cache"))["caches"][label]["pool"]
        if (pool["free_blocks"], pool["cached_blocks"]) != (
                st["kv_free_blocks"], st["kv_cached_blocks"]):
            fail(f"/debug/cache pool {pool} against stats() free "
                 f"{st['kv_free_blocks']} cached {st['kv_cached_blocks']}")
        prof = await get("/debug/profile")
        if label not in prof["engines"] or prof["loop"] is None:
            fail(f"/debug/profile: {sorted(prof)}")
        stacks = await get("/debug/profile/stacks", as_json=False)
        report["loop_lag"] = {
            "all": prof["loop"], "warm_batches": lag_quantiles(warm_lag),
            "stall_stacks": len(stacks.splitlines()),
            "hottest_stacks": [ln[-160:] for ln in stacks.splitlines()[:3]],
            "stats_p50_p99_s": [st["loop_lag_p50_seconds"],
                                st["loop_lag_p99_seconds"]]}
        traces = await get("/v1/traces")
        if not traces["traces"] or label not in traces["engine_steps"]:
            fail(f"/v1/traces: {len(traces['traces'])} traces, timelines "
                 f"{sorted(traces['engine_steps'])}")
        one = await get("/v1/traces/solo0")
        if set(one.get("cost", {})) != COST_KEYS or not one["spans"]:
            fail(f"/v1/traces/solo0: {one}")
        report["trace_solo0"] = {"stages_ms": one["stages"],
                                 "cost": one["cost"]}

        # n = 2, greedy: both choices the solo request's tokens
        prompt = SOLO[0][1]
        st_, _, n2 = await post("/v1/chat/completions",
                                chat(prompt, SOLO[0][2], n=2), "op-n2")
        if st_ != 200 or len(n2["choices"]) != 2:
            fail(f"op-n2: HTTP {st_}: {n2}")
        # the choices are one batch's two identical rows: the same tokens;
        # against solo0 (decoded alone, in the 1-row buckets) equal up to
        # a plain-path near-tie, as any batch against a lone request
        solo, choices = tap.tokens["solo0"], [tap.tokens[f"op-n2-c{i}"]
                                              for i in range(2)]
        # the two choices share every window once both run; a choice that
        # reached the engine a window after the other decoded that window
        # alone: equal, or up to a plain-path near-tie, as solo0
        report["n2"] = {
            f"choice {i}": margin_rule(
                engine.params, engine.cfg, engine.device,
                tap.prompt_ids["solo0"], solo, choices[i],
                f"phase 4: n = 2 choice {i} against solo0")
            for i in range(2)}
        report["n2"]["choice 1 against choice 0"] = margin_rule(
            engine.params, engine.cfg, engine.device,
            tap.prompt_ids["solo0"], choices[0], choices[1],
            "phase 4: n = 2 choice 1 against choice 0")

        # a deadline far below the decode time of its 512 tokens
        await pages_idle(engine, "before op-deadline")
        free0 = engine.stats()["kv_free_blocks"]
        t = time.monotonic()
        st_, _, body = await post("/v1/chat/completions",
                                  chat("What is an H100?", 512),
                                  "op-deadline",
                                  {"X-Request-Deadline-Ms": "50"})
        answered = time.monotonic() - t
        if st_ != 504:
            fail(f"op-deadline: HTTP {st_} (want 504): {body}")
        t = time.monotonic()
        await pages_idle(engine, "after op-deadline")
        if engine.stats()["kv_free_blocks"] != free0:
            fail(f"op-deadline: kv_free_blocks {free0} before, "
                 f"{engine.stats()['kv_free_blocks']} after")
        report["deadline"] = {
            "status": st_, "answered_ms": round(answered * 1e3, 3),
            "tokens_before_timeout": len(tap.tokens.get("op-deadline", [])),
            "pages_back_ms": round((time.monotonic() - t) * 1e3, 3)}

        # shedding: queue depth 1, a burst of 8, then the default again
        default = svc.admission
        svc.set_admission(revive.AdmissionController(
            lambda: revive.signals_from_stats(engine.stats()),
            revive.ShedConfig(queue_depth=1)))
        burst = await asyncio.gather(*(
            post("/v1/chat/completions",
                 chat(f"Burst {i}: name a prime number.", 8), f"op-b{i}")
            for i in range(8)))
        shed = svc.admission.snapshot()
        svc.set_admission(default)
        codes = [st_ for st_, _, _ in burst]
        cap = revive.ShedConfig().retry_after_cap_s
        if 503 not in codes or set(codes) - {200, 503}:
            fail(f"burst under queue_depth=1: {codes}")
        retry = [int(h["Retry-After"]) for st_, h, _ in burst if st_ == 503]
        if not all(1 <= r <= cap for r in retry):
            fail(f"burst Retry-After {retry} outside [1, {cap}]")
        report["burst"] = {"codes": codes, "retry_after": retry,
                           "admission": shed}

        # an on-demand profile of one short request
        trace_dir = tempfile.mkdtemp(prefix="chip_smoke_prof_")
        try:
            st_, _, started = await post("/debug/profile/start",
                                         {"dir": trace_dir})
            if st_ != 200:
                fail(f"/debug/profile/start: HTTP {st_}: {started}")
            st_, _, _ = await post("/v1/chat/completions",
                                   chat("Profile me.", 8), "op-prof")
            st2, _, stopped = await post("/debug/profile/stop")
            if st_ != 200 or st2 != 200:
                fail(f"profiled request HTTP {st_}, stop HTTP {st2}: "
                     f"{stopped}")
            path = os.path.join(stopped["dir"], "trace.pt.trace.json")
            named = trace_names(path, BATCH_KERNELS)
            if named != set(BATCH_KERNELS):
                fail(f"/debug/profile trace names {sorted(named)} of "
                     f"{list(BATCH_KERNELS)}")
            report["profile"] = {"trace_bytes": os.path.getsize(path),
                                 "kernels": sorted(named)}
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)

        # an incident: the recorder's 60 s debounce may hold from an
        # automatic trip earlier in the phase (a stall, say): list them,
        # then lift the debounce for the manual capture
        rec = blackbox.get_recorder()
        report["incidents_before"] = [
            (i["trigger"], i["at_wall_ms"]) for i in rec.incidents_summary()]
        rec.cooldown_s = 0.0
        st_, _, cap_ = await post("/debug/incidents/capture")
        if st_ != 200:
            fail(f"/debug/incidents/capture: HTTP {st_}: {cap_}")
        bundle = await get(f"/debug/incidents/{cap_['id']}")
        if label not in bundle["telemetry"]["engines"]:
            fail(f"incident bundle engines "
                 f"{sorted(bundle['telemetry']['engines'])}")
        report["incident"] = {"id": cap_["id"],
                              "bytes": len(json.dumps(bundle))}

        # last: drain with a stream in flight
        inflight = asyncio.ensure_future(post(
            "/v1/chat/completions", chat(SOLO[0][1], 32, stream=True),
            "op-drain"))
        t = time.monotonic()
        while not engine.stats()["request_active_slots"]:
            if inflight.done() or time.monotonic() - t > 30:
                fail(f"op-drain never ran in the engine: "
                     f"{inflight.result() if inflight.done() else 'none'}")
            await asyncio.sleep(0.005)
        st_, _, drained = await post("/drain")
        st2, _, chunks = await inflight
        st3, hdrs, _ = await post("/v1/chat/completions",
                                  chat("Too late.", 8), "op-late")
        st4, _, _ = await post("/drain")
        if (st_, drained.get("results"), st2, chunks[-1:], st3, st4) != (
                200, [True], 200, ["[DONE]"], 503, 409) \
                or "Retry-After" not in hdrs:
            fail(f"drain: {st_} {drained}, in flight {st2} "
                 f"{chunks[-1:]}, next {st3} {hdrs}, again {st4}")
        report["drain"] = {"in_flight_tokens": len(tap.tokens["op-drain"]),
                           "next": st3, "retry_after": hdrs["Retry-After"]}
    # every finished request's step share: the dispatches, in all. A
    # request's finish (with its cost) rides with its pages' release,
    # which waits for the window in flight: poll until the engine's last
    # finish has landed
    t = time.monotonic()
    while True:
        attr = profiling.attributions_snapshot(10 ** 6)
        shares = sum(c["device_step_share"] for _, c in attr)
        total = engine.batch_dispatches_total
        if abs(shares - total) <= 1e-6 * len(attr) + 1e-9 \
                or time.monotonic() - t > 5:
            break
        await asyncio.sleep(0.01)
    if abs(shares - total) > 1e-6 * len(attr) + 1e-9:
        fail(f"attribution: {len(attr)} requests' shares sum to {shares}, "
             f"batch_dispatches_total {total}")
    report["conservation"] = {"requests": len(attr),
                              "device_step_share_sum": round(shares, 6),
                              "batch_dispatches_total": total}
    report["seconds"] = round(time.monotonic() - t0, 3)
    return report


# phase 4's four requests (kind, prompt, max tokens), sent one at a time;
# the long prompt starts with a letter no batch used, so it never hits the
# prefix cache (its pages are computed as a fresh server computes them)
SOLO = [("chat", "Tell me about paged attention.", 32),
        ("chat", "S" + ("The quick brown fox jumps over the lazy dog. "
                        * 14)[1:600], 32),
        ("chat", "What is an H100?", 24),
        ("completion", "Once upon a time", 24)]
SOLO_TOP = 5


async def solo_logprobs(base: str, name: str, prefix: str) -> list:
    """:data:`SOLO`'s requests against the server at ``base``, one at a
    time (each decodes alone, in the 1-row buckets, so two servers of the
    same weights and kernels give the same tokens), greedy, with
    logprobs and the top :data:`SOLO_TOP`: per request its finish, text,
    chosen-token logprobs and the top values (completions key their top
    entries by token string, so ids that decode alike keep one)."""
    import aiohttp

    out = []
    async with aiohttp.ClientSession() as s:
        for i, (kind, prompt, n) in enumerate(SOLO):
            hdrs = {"X-Request-Id": f"{prefix}{i}"}
            if kind == "chat":
                url, body = "/v1/chat/completions", {
                    "model": name, "max_tokens": n, "logprobs": True,
                    "top_logprobs": SOLO_TOP,
                    "messages": [{"role": "user", "content": prompt}]}
            else:
                url, body = "/v1/completions", {
                    "model": name, "prompt": prompt, "max_tokens": n,
                    "logprobs": SOLO_TOP}
            async with s.post(base + url, json=body, headers=hdrs) as r:
                if r.status != 200:
                    fail(f"{prefix}{i}: HTTP {r.status}: {await r.text()}")
                c = (await r.json())["choices"][0]
            if kind == "chat":
                entries = c["logprobs"]["content"]
                res = {"text": c["message"]["content"],
                       "lp": [e["logprob"] for e in entries],
                       "top": [[t["logprob"] for t in e["top_logprobs"]]
                               for e in entries]}
            else:
                lp = c["logprobs"]
                res = {"text": c["text"], "lp": lp["token_logprobs"],
                       "top": [sorted(d.values(), reverse=True)
                               for d in lp["top_logprobs"]]}
            res["finish"] = c["finish_reason"]
            if res["finish"] not in ("length", "stop") or not res["lp"]:
                fail(f"{prefix}{i}: finish {res['finish']!r}, "
                     f"{len(res['lp'])} logprob entries")
            out.append(res)
    return out


# logprobs of the served path against the plain path (check_logprobs):
# the bf16 tolerance of the window logits (PATH_LIMITS), since a logprob
# is a logit less the row's log-sum-exp
LOGPROB_LIMIT = 0.25
# tp=2 against tp=1 on the same weights (compare_tp_solo,
# tp_teacher_forced): three bf16 ulps of a logit in [4, 8), where the
# seed-0 8B's logits lie; on an H100 80GB HBM3 (700 W) the two differed
# by 0 to 1 ulp (0.031) at every step of the same token (PERF.md)
TP_LOGPROB_LIMIT = 0.1


def plain_params(params) -> dict:
    """The params of the plain path: int8 weights multiplied through the
    int8 GEMM's plain version (``QuantInt8.as_plain``), the rest as
    they are."""
    from dynamo_tpu_torch.models.quant import QuantInt8

    return {k: v.as_plain() if isinstance(v, QuantInt8) else v
            for k, v in params.items()}


def plain_logits(params, cfg, dev, ids: list):
    """Logits [len(ids), V] at every position of one sequence, by one
    forward of the plain path (the gather attention, no kernel) over
    fresh pools."""
    import torch

    from dynamo_tpu_torch.models import llama as tl

    T, ps = len(ids), 64
    npg = -(-T // ps)
    kv_k, kv_v = tl.init_kv_cache(cfg, tl.KVCacheSpec(npg + 1, ps),
                                  device=dev)
    pos = torch.arange(T, device=dev, dtype=torch.int32)
    table = torch.arange(1, npg + 1, device=dev, dtype=torch.int32)
    slots = table[pos // ps] * ps + pos % ps
    h, _, _ = tl.forward(params, cfg,
                         torch.tensor([ids], device=dev, dtype=torch.int32),
                         pos[None], kv_k, kv_v, table[None], slots[None],
                         use_kernels=False)
    return tl.project_logits(params, cfg, h[0])


def check_logprobs(engine, cfg, dev, reference) -> dict:
    """Phase 4's logprobs requests (greedy, top 5): every token's logprob
    is the top-1 logprob (the greedy token is the argmax), and each
    token's logprob and top values are within LOGPROB_LIMIT of the plain
    path's, teacher-forced with the served tokens."""
    import torch

    out = {}
    worst = 0.0
    for rid, ref in reference["tap"].items():
        toks, entries = ref["tokens"], ref["logprobs"]
        if len(entries) != len(toks):
            fail(f"{rid}: {len(entries)} logprob entries for {len(toks)} "
                 f"tokens")
        P = len(ref["prompt_ids"])
        with torch.no_grad():
            logp = torch.log_softmax(plain_logits(
                plain_params(engine.params), cfg, dev,
                ref["prompt_ids"] + toks[:-1])[P - 1:].float(), dim=-1)
        top = torch.topk(logp, SOLO_TOP).values.cpu()
        chosen = logp.gather(1, torch.tensor(toks, device=dev)[:, None])[
            :, 0].cpu()
        not_top1, err = 0, 0.0
        for j, (lp, tops) in enumerate(entries):
            if abs(lp - max(tops.values())) > 1e-6:
                not_top1 += 1
            err = max(err, abs(lp - float(chosen[j])), *(
                abs(a - float(b)) for a, b in zip(
                    sorted(tops.values(), reverse=True), top[j])))
        out[rid] = {"tokens": len(toks), "max_abs_err": err,
                    "not_top1": not_top1}
        worst = max(worst, err)
        if not_top1:
            fail(f"{rid}: {not_top1} greedy tokens whose logprob is not the "
                 f"top-1 logprob")
    log(f"  logprobs vs the plain path: {json.dumps(out)} (limit "
        f"{LOGPROB_LIMIT})")
    if worst > LOGPROB_LIMIT:
        fail(f"served logprobs differ from the plain path by {worst:.4g} > "
             f"{LOGPROB_LIMIT}")
    return out


# Limits of the served-model check (check_paths), set from readings on an
# H100 (PERF.md, Findings): sound runs gave at most 0.094 (logits, |x| up
# to 4.8) and 0.081 (K/V); the weakest control fault 0.73 (logits of
# window steps 1-3) and 1.55 (K/V). 0.25 sits near 2.7x the one and
# 2.9x below the other.
PATH_LIMITS = {"prefill_logits": 0.25, "window_logits": 0.25,
               "window_kv": 0.25}


# check_paths' inputs: a full chunk, a padded row, and a short row (at
# 12 positions each in-flight key weighs enough that a fault in folding
# it shows above the bf16 noise of 32 layers; at 300+ positions it does
# not), then a teacher-forced window of PATH_K steps
PATH_LENS, PATH_T, PATH_K = [512, 300, 12], 512, 4


def path_run(params, cfg, dev, use: bool, mesh=None, ps: int = 64):
    """Prefill of check_paths' three rows, then its teacher-forced window
    (the same input token at every step whatever the logits), on fresh
    pools of page size ``ps``: (prefill logits [B, V], every step's logits
    [K, B, V], the K/V committed at the window's K positions in every
    layer). With ``mesh``, one tensor-parallel rank's run on its shards
    (its K/V: its kv heads). The model module is the registry's; one
    without a fused window (MLA) runs the engine's generic window. An MLA
    model's K/V rows are its latent and rope rows side by side."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.engine import sampling
    from dynamo_tpu_torch.engine.torch_engine import _make_decode_multi
    from dynamo_tpu_torch.models.llama import KVCacheSpec
    from dynamo_tpu_torch.models.registry import get_model_module

    mod = get_model_module(cfg)

    T, K, lens = PATH_T, PATH_K, PATH_LENS
    B = len(lens)
    # pages a row: its longest context and the window, and one spare
    per = -(-(max(lens) + K) // ps) + 1
    spec = KVCacheSpec(num_pages=max(64, 1 + B * per), page_size=ps)
    g = torch.Generator(device="cpu").manual_seed(5)
    tokens = torch.randint(0, 256, (B, T), generator=g, dtype=torch.int32)
    forced = torch.randint(0, 256, (B, K + 1), generator=g,
                           dtype=torch.int32).to(dev)
    positions = torch.full((B, T), -1, dtype=torch.int32)
    table = torch.zeros((B, max(16, per)), dtype=torch.int32)
    slots = torch.full((B, T), 1 << 30, dtype=torch.int32)
    for b, n in enumerate(lens):
        positions[b, :n] = torch.arange(n)
        table[b, :per] = torch.arange(1 + per * b, 1 + per * (b + 1))
        p = torch.arange(n)
        slots[b, :n] = table[b, p // ps] * ps + p % ps
    last = torch.tensor([n - 1 for n in lens], dtype=torch.int32)

    kk, vv = mod.init_kv_cache(cfg, spec, device=dev, mesh=mesh)
    pre, _ = mod.make_step_fns(cfg, use_kernels=use, mesh=mesh)
    logits, kk, vv = pre(params, tokens.to(dev), positions.to(dev), kk, vv,
                         table.to(dev), slots.to(dev), last.to(dev))
    step_logits = []

    def forcing(lg, *args, **kwargs):
        step_logits.append(lg.float().clone())
        return forced[:, len(step_logits)]

    real = sampling.sample_tokens
    sampling.sample_tokens = forcing
    try:
        if hasattr(mod, "make_decode_window_fn"):
            win = mod.make_decode_window_fn(cfg, use_kernels=use, mesh=mesh)
        else:
            win = _make_decode_multi(mod, cfg, 64, mesh=mesh)
    finally:
        sampling.sample_tokens = real
    win(params, forced[:, 0].contiguous(),
        torch.tensor(lens, dtype=torch.int32, device=dev),
        torch.zeros(B, dtype=torch.bool, device=dev),
        torch.zeros(B, dtype=torch.int32, device=dev),
        torch.full((B,), 100, dtype=torch.int32, device=dev), kk, vv,
        table.to(dev), np.zeros(B, np.float32), np.zeros(B, np.int32),
        np.ones(B, np.float32), np.zeros(B, np.uint32),
        torch.full((B, 1), -1, dtype=torch.int32, device=dev), k_steps=K)
    torch.cuda.synchronize()
    kv = torch.stack([
        torch.cat([pool[:, table[b, (n + i) // ps].item(), :, (n + i) % ps]
                   for pool in (kk, vv)], dim=-1)
        for b, n in enumerate(lens) for i in range(K)])
    return logits.float(), torch.stack(step_logits), kv


def check_paths(engine, cfg, dev, limits=None) -> tuple:
    """Prefill and one fused decode window of the served 8B model, kernel
    path against plain path (:func:`path_run`): same weights, same
    inputs, fresh pools. The window is teacher-forced, so every step's
    logits and the K/V committed at all K window positions in every
    layer are compared; steps 1.. are where the decode kernel folds 2..
    in-flight keys. Two controls, each a fault on the kernel path, show
    the check can see one: prefill queries that miss their own key, and a
    window step that folds one in-flight key too few; with int8 weights
    (whose plain path multiplies through the int8 GEMM's plain version)
    instead every int8 GEMM call leaving out the last 16 of its K. Each
    control must land above its limit. ``limits``: PATH_LIMITS (bf16)
    unless given. Returns the report and the kernel path's (prefill
    logits, step logits) on the host: the tp=1 reference of the
    tensor-parallel phase."""
    import torch

    from dynamo_tpu_torch.models import llama, quant

    limits = limits or PATH_LIMITS
    # a MoE model: the kernel path's expert choices, which every other
    # run follows (routed), counted afresh for this check
    routes = [] if cfg.num_experts > 0 else None
    ROUTED.update(differ=0, rows=0)

    def run(use: bool):
        def go():
            return path_run(
                engine.params if use else plain_params(engine.params), cfg,
                dev, use, ps=engine.ecfg.page_size)

        if routes is None:
            return go()
        return routed(go, routes, record=use and not routes,
                      mla=cfg.is_mla)

    def errs(a, b):
        return {"rel_l2_logits": rel_l2(torch.cat([a[0][None], a[1]]),
                                        torch.cat([b[0][None], b[1]])),
                "prefill_logits": max_err(a[0], b[0]),
                "window_logits_by_step": [max_err(x, y)
                                          for x, y in zip(a[1], b[1])],
                "window_logits": max_err(a[1], b[1]),
                "window_kv": max_err(a[2], b[2])}

    kern, plain = run(True), run(False)
    for side, out in (("kernel", kern), ("plain", plain)):
        for what, t in zip(("prefill logits", "window logits", "window K/V"),
                           out):
            if not bool(torch.isfinite(t).all()):
                fail(f"{side} path: non-finite {what} "
                     f"({int((~torch.isfinite(t)).sum())} of {t.numel()})")
    sound = errs(kern, plain)

    # controls: the kernel path with one fault each, against the plain path
    real_pf = llama.paged_attention_prefill
    real_win = llama.paged_attention_decode_window

    def pf_miss_own_key(q, kp, vp, table_, qpos, **kw):
        shifted = torch.where(qpos >= 0, qpos - 1, qpos).to(torch.int32)
        return real_pf(q, kp, vp, table_, shifted, **kw)

    def win_one_key_short(q, kp, vp, layer, table_, start, qp, wk, wv,
                          n_win, **kw):
        return real_win(q, kp, vp, layer, table_, start, qp, wk, wv,
                        max(1, n_win - 1), **kw)

    real_int8 = quant.int8_matmul

    def int8_k_tail_dropped(x, q, s):
        k = q.shape[1] - 16
        return real_int8(x[..., :k].contiguous(), q[:, :k].contiguous(), s)

    def with_fault(name, fault, module=llama):
        real = getattr(module, name)
        setattr(module, name, fault)
        try:
            return errs(run(True), plain)
        finally:
            setattr(module, name, real)

    if engine.quant == "int8":
        # the attention kernels are phase 4's, controlled there
        control = {"int8_k_tail_dropped": with_fault(
            "int8_matmul", int8_k_tail_dropped, quant)}
    else:
        control = {
            "prefill_misses_own_key": with_fault("paged_attention_prefill",
                                                 pf_miss_own_key),
            "window_one_key_short": with_fault(
                "paged_attention_decode_window", win_one_key_short)}

    if routes is not None:
        log(f"  routing: the plain path and the faults follow the kernel "
            f"path's experts; {ROUTED['differ']} of {ROUTED['rows']} "
            f"token-layers of the plain path would have picked another "
            f"expert set")
    scale = {"prefill_logits_max_abs": float(plain[0].abs().max()),
             "window_logits_max_abs": float(plain[1].abs().max()),
             "window_kv_max_abs": float(plain[2].float().abs().max())}
    log(f"  kernel vs plain path: {json.dumps(sound)}")
    log(f"  control faults vs plain path: {json.dumps(control)}")
    log(f"  magnitudes: {json.dumps(scale)}; limits "
        f"{json.dumps(limits)}")
    for key, limit in limits.items():
        if sound[key] > limit:
            fail(f"kernel path differs from plain path: {key} "
                 f"{sound[key]:.4g} > {limit}")
    if "int8_k_tail_dropped" in control:
        ci = control["int8_k_tail_dropped"]
        checks = [("prefill_logits", ci["prefill_logits"]),
                  ("window_logits", ci["window_logits"])]
    else:
        # the window fault leaves step 0 alone (one key is all it has)
        cp = control["prefill_misses_own_key"]
        cw = control["window_one_key_short"]
        checks = [("prefill_logits", cp["prefill_logits"]),
                  ("window_logits", max(cw["window_logits_by_step"][1:])),
                  ("window_kv", cw["window_kv"])]
    for key, got in checks:
        if got <= limits[key]:
            fail(f"control fault stays within the {key} limit "
                 f"({got:.4g} <= {limits[key]}): the check is blind")
    return ({"sound": sound, "control": control, "magnitudes": scale,
             "limits": limits}, (kern[0].cpu(), kern[1].cpu()))


# routed(): the plain run's count of token-layers whose own routing
# differs from the recorded one, and of token-layers replayed
ROUTED = {"differ": 0, "rows": 0}


def routed(fn, routes: list, record: bool, mla: bool = False):
    """Run ``fn`` with every MoE routing (``models/llama.py moe_route``)
    either recorded into ``routes`` (``record``) or replayed from it in
    call order: the experts recorded, their softmax weights from this
    run's own router logits. A MoE router's bfloat16 logits tie or nearly
    tie at the k-th place often, so two paths that differ by bf16 noise
    upstream (the kernel and the plain attention) would otherwise send
    some tokens to other experts, a difference of routing and not of the
    attention kernels check_paths holds to their plain versions. The
    replaying run counts in ROUTED the token-layers whose own choice
    differs. ``mla``: DeepSeek's router (``models/mla.py
    _deepseek_gate``) in place of ``moe_route``, its weights of the
    recorded experts from this run's own scores."""
    import torch

    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models import mla as mla_mod

    module, name = (mla_mod, "_deepseek_gate") if mla else (llama,
                                                             "moe_route")
    real = getattr(module, name)
    replay = iter(list(routes))

    def check(idx):
        want = next(replay)
        ROUTED["differ"] += int((idx.sort(-1).values
                                 != want.sort(-1).values).any(-1).sum())
        ROUTED["rows"] += idx.shape[0]
        return want

    def route(x, w_router, k):
        weights, idx = real(x, w_router, k)
        if record:
            routes.append(idx)
            return weights, idx
        want = check(idx)
        logits = (x @ w_router).float().gather(-1, want)
        return torch.softmax(logits, dim=-1), want

    def gate(x32, w_router, bias, cfg):
        weights, idx = real(x32, w_router, bias, cfg)
        if record:
            routes.append(idx)
            return weights, idx
        want = check(idx)
        scores, _ = mla_mod.deepseek_scores(x32, w_router, bias, cfg)
        return mla_mod._gate_weights(scores, want, cfg), want

    setattr(module, name, gate if mla else route)
    try:
        out = fn()
    finally:
        setattr(module, name, real)
    if not record and next(replay, None) is not None:
        fail("routed: a run made fewer MoE calls than the recorded one")
    return out


def check_graph_window(engine, cfg, dev, topn: int = 0,
                       form: int = 0, counts: bool = True) -> dict:
    """One fused decode window of the served 8B engine by graph replay
    (its warmed bucket of 4 rows x 64 pages, in variant (``topn``,
    ``form``)) against the same window called eagerly from the same
    inputs and pools: four rows prefilled to 40, 300, 500 and 12
    positions, greedy rows and one sampled row (the on-device draw runs
    inside the graph). A penalised variant reads the shared penalty
    buffers, set here: row 2's logit_bias +100 on token 1234 (which it
    must then emit at every step) and, with ``counts``, repetition,
    frequency and presence penalties over a state rebuilt from the rows'
    prompts; without, neutral penalties over the state as it was left
    (the engine's logit_bias-only batches). Tokens, emitted counts,
    carry and the logprobs aux must be
    identical, the K/V written at the window's positions in every layer
    within bf16 tolerance (atol 2e-2 + rtol 1e-2)."""
    import torch

    from dynamo_tpu_torch.engine.cuda_graphs import PEN_NONE
    from dynamo_tpu_torch.engine.sampling import fill_penalty_state
    from dynamo_tpu_torch.models.llama import DROP_SLOT

    ecfg = engine.ecfg
    ps, K, B, P, T = ecfg.page_size, ecfg.decode_steps, 4, 64, 512
    lens = [40, 300, 500, 12]
    g = torch.Generator(device="cpu").manual_seed(9)
    tokens = torch.randint(0, 256, (B, T), generator=g, dtype=torch.int32)
    positions = torch.full((B, T), -1, dtype=torch.int32)
    table = torch.zeros((B, P), dtype=torch.int32)
    slots = torch.full((B, T), DROP_SLOT, dtype=torch.int32)
    for b, n in enumerate(lens):
        positions[b, :n] = torch.arange(n)
        table[b, :10] = torch.arange(1 + 10 * b, 11 + 10 * b)
        p = torch.arange(n)
        slots[b, :n] = table[b, p // ps] * ps + p % ps
    last = torch.tensor([n - 1 for n in lens], dtype=torch.int32)
    i32 = dict(dtype=torch.int32, device=dev)
    graphs = engine.decode_set(topn, form)
    bk = graphs.buckets[(B, P)]
    if bk.graph is None:
        fail(f"decode bucket {(B, P)} ({graphs.variant}) has no graph")
    with graphs.stream_ctx():
        if form != PEN_NONE:
            bufs = engine.penalty_buffers
            full = counts
            f32 = dict(dtype=torch.float32, device=dev)
            bufs.rep[:B] = torch.tensor([1.0, 1.3, 1.0, 0.8] if full
                                        else [1.0] * B, **f32)
            bufs.freq[:B] = torch.tensor([0.0, 0.4, 0.0, 0.2] if full
                                         else [0.0] * B, **f32)
            bufs.pres[:B] = torch.tensor([0.0, 0.3, 0.6, 0.0] if full
                                         else [0.0] * B, **f32)
            bufs.bias[:B].zero_()
            bufs.bias[2, 1234] = 100.0
            bufs.bias[1, 77] = -5.0
            if full:
                ids = torch.where(positions >= 0, tokens, -1).to(dev)
                fill_penalty_state(
                    bufs.counts[:B], bufs.presence[:B], ids,
                    torch.tensor([n // 2 for n in lens], **i32))
        logits, _, _ = engine.prefill_fn(
            engine.params, tokens.to(dev), positions.to(dev), engine.kv_k,
            engine.kv_v, table.to(dev), slots.to(dev), last.to(dev))
        inputs = (
            torch.argmax(logits, -1).to(torch.int32),
            torch.tensor(lens, **i32), torch.zeros(B, dtype=torch.bool,
                                                   device=dev),
            torch.ones(B, **i32), torch.full((B,), 100, **i32),
            table.to(dev), torch.tensor([0.0, 0.8, 0.0, 0.0], device=dev),
            torch.tensor([0, 40, 0, 0], **i32),
            torch.tensor([1.0, 0.95, 1.0, 1.0], device=dev),
            torch.tensor([0, 7, 0, 0], dtype=torch.int64, device=dev),
            torch.full((B, ecfg.max_eos_ids), -1, **i32))
        kk0, vv0 = engine.kv_k.clone(), engine.kv_v.clone()

        def written():
            # both pools' rows side by side (MLA's differ in width)
            return torch.stack([
                torch.cat([pool[:, int(table[b, (n + i) // ps]), :,
                                (n + i) % ps] for pool in
                           (engine.kv_k, engine.kv_v)], dim=-1)
                for b, n in enumerate(lens) for i in range(K)])

        e_out = engine.decode_multi_fn(
            engine.params, *inputs[:5], engine.kv_k, engine.kv_v,
            *inputs[5:], bk.pen, k_steps=K, logprobs_topn=topn)
        e_toks, e_n, e_carry = e_out[0], e_out[1], e_out[-3]
        e_aux = e_out[2] if topn else ()
        e_kv = written()
        engine.kv_k.copy_(kk0)
        engine.kv_v.copy_(vv0)
        del kk0, vv0
        statics = bk.carry_in + (bk.table, bk.temperature, bk.top_k,
                                 bk.top_p, bk.seeds, bk.eos)
        for dst, src in zip(statics, inputs):
            dst.copy_(src)
        graphs.launch(bk)
        g_kv = written()
    torch.cuda.synchronize()
    same = {"toks": torch.equal(bk.toks, e_toks),
            "emitted": torch.equal(bk.emitted, e_n),
            "carry": all(torch.equal(a, b)
                         for a, b in zip(bk.carry, e_carry)),
            "aux": all(torch.equal(a, b)
                       for a, b in zip(bk.aux or (), e_aux))}
    if form != PEN_NONE and not bool((e_toks[2] == 1234).all()):
        fail(f"logit_bias +100 on token 1234 did not force row 2's tokens "
             f"({graphs.variant}): {e_toks[2].tolist()}")
    result = {"variant": graphs.variant + (
                  "" if form == PEN_NONE or counts else " (logit_bias only)"),
              **same,
              "kv_max_abs_err": max_err(g_kv, e_kv),
              "kv_bitwise": torch.equal(g_kv, e_kv),
              "kv_max_abs": float(e_kv.float().abs().max()),
              "emitted_per_row": e_n.tolist(),
              "tokens": e_toks.tolist()}
    log(f"  graph replay vs eager window: {json.dumps(result)}")
    if not all(same.values()):
        fail(f"graph replay differs from the eager window: {same}")
    if excess(g_kv, e_kv, 2e-2, 1e-2) > 0:
        fail(f"graph replay K/V differs from the eager window: max abs err "
             f"{result['kv_max_abs_err']:.4g}")
    return result


def check_graph_prefill(engine, dev, topn: int = 0) -> dict:
    """Two 8B prefill chunks and their first-token draws by graph replay
    (their warmed buckets; with ``topn``, of the variant whose draw also
    gives its logprobs) against the same chunks called eagerly from the
    same inputs and pools: a first chunk of 512 tokens alone (1 x 512 x 8
    pages, page commit), and a batch of 8 rows of 64 (8 x 64 x 8, page
    commit) with three real rows (a third chunk at positions 128-191, a
    row of 40 and a sampled row of 7) and five padding rows. Sampled
    tokens, logits, the logprobs aux and the whole K/V pools after the
    chunk must be bitwise equal (the same kernels on the same inputs)."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.engine.cuda_graphs import to_device
    from dynamo_tpu_torch.engine.sampling import logprob_aux, sample_tokens

    ecfg = engine.ecfg
    ps = ecfg.page_size
    graphs = engine.prefill_set(topn)
    rng = np.random.RandomState(11)
    # (bucket, rows of (start, length, pages, temperature, top_k, seed))
    cases = {
        "first_chunk_512": ((1, 512, 8, True),
                            [(0, 512, list(range(1, 9)), 0.0, 0, 0)]),
        "mixed_8x64": ((8, 64, 8, True),
                       [(128, 64, [20, 21, 22], 0.0, 0, 0),
                        (0, 40, [30], 0.0, 0, 0),
                        (0, 7, [31], 0.8, 40, 7)]),
    }
    out = {}
    for name, (key, rows) in cases.items():
        bk = graphs.buckets[key]
        if bk.graph is None:
            fail(f"prefill bucket {key} has no graph")
        img, f = bk.host_inputs()
        for i, (start, n, pages, temp, top_k, seed) in enumerate(rows):
            pos = np.arange(start, start + n)
            pg = np.asarray(pages)
            f["tokens"][i, :n] = rng.randint(0, 256, n)
            f["positions"][i, :n] = pos
            f["table"][i, :len(pages)] = pages
            f["last_idx"][i] = n - 1
            f["slots"][i, :n] = pg[pos // ps] * ps + pos % ps
            npg = -(-n // ps)
            f["pslots"][i, :npg] = pg[start // ps:start // ps + npg]
            f["temperature"][i], f["top_k"][i] = temp, top_k
            f["seeds"][i] = seed
        host = {k: np.array(v) for k, v in f.items()}
        with graphs.stream_ctx():
            k0, v0 = engine.kv_k.clone(), engine.kv_v.clone()
            d = {k: to_device(v, dev) for k, v in host.items()}
            e_logits, _, _ = engine.prefill_fn(
                engine.params, d["tokens"], d["positions"], engine.kv_k,
                engine.kv_v, d["table"], d["slots"], d["last_idx"],
                d["pslots"])
            e_tok = sample_tokens(e_logits, d["temperature"], d["top_k"],
                                  d["top_p"], d["seeds"], d["steps"],
                                  max_top_k=ecfg.max_top_k)
            e_aux = logprob_aux(e_logits, e_tok, topn) if topn else ()
            e_k, e_v = engine.kv_k.clone(), engine.kv_v.clone()
            engine.kv_k.copy_(k0)
            engine.kv_v.copy_(v0)
            graphs.run(bk, img)
        torch.cuda.synchronize()
        same = {"sampled": torch.equal(bk.sampled, e_tok),
                "logits": torch.equal(bk.logits, e_logits),
                "aux": all(torch.equal(a, b)
                           for a, b in zip(bk.aux or (), e_aux)),
                "kv": torch.equal(engine.kv_k, e_k)
                and torch.equal(engine.kv_v, e_v)}
        # the chunk wrote its rows' pages and nothing else
        pages = sorted({p for r in rows for p in r[2]})
        changed = sorted(set(torch.nonzero(
            (e_k != k0).flatten(2).any(-1).any(0))[:, 0].tolist()))
        out[name] = {**same, "pages_written": changed,
                     "logits_max_abs": float(e_logits.abs().max()),
                     "sampled": bk.sampled.tolist()}
        del k0, v0, e_k, e_v
        log(f"  graph replay vs eager prefill {name} ({graphs.variant}): "
            f"{json.dumps(out[name])}")
        if not all(same.values()):
            fail(f"graph replay differs from the eager prefill chunk "
                 f"{name}: {same}")
        if not set(changed) <= set(pages) or not changed:
            fail(f"prefill chunk {name} wrote pages {changed}, its rows own "
                 f"{pages}")
    return out


# ------------------------------------------------------------ timings


def time_decode(kp, vp, ctx, B: int, P: int, K: int, H: int, g,
                mesh=None, peak_flops: float = H100_BF16_FLOPS) -> dict:
    """The decode kernel in the window form at one shape
    (time_attention.decode_case), through its tensor-parallel wrapper on
    the rank's heads when ``mesh`` is given (``kp``/``vp`` then hold the
    rank's kv heads):
    device time (CUDA graph), eager time, its plain version, one SDPA
    call on the same dense work, the bound counted from the inputs
    (ops.paged_attention.decode_work); held to the plain version at the
    bf16 tolerance (as check_decode) and within DECODE_REL_RMS of the
    plain output's rms, a limit the plain version one 16-key block short
    in every row must pass (else the check is blind). Also the route,
    the splits per (row, kv head) that the launch plan picks (one
    cluster of them) and each row's live splits.
    ``peak_flops``: the rate of the operands' type the bound counts
    (float32 pools: H100_F32_FLOPS for the float32 kernel's FFMA, a third
    of H100_TF32_FLOPS for the generic kernel's 3xTF32). float32 pools
    are held to atol 1e-5 in place of the bf16 tolerance."""
    import torch
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops.paged_attention import (
        DECODE_ROUTES, _decode_launch_plan, decode_work,
        paged_attention_decode_layered,
        paged_attention_decode_window, paged_attention_decode_window_sharded,
        window_reference)
    from time_attention import decode_case

    dev = kp.device
    N, KV, ps, hd = kp.shape[1:]
    q, table, start, qp, wk, wv = decode_case(kp, vp, ctx, B, P, K, H, g)
    scale = hd ** -0.5
    dec = lambda: paged_attention_decode_window(  # noqa: E731
        q, kp, vp, 0, table, start, qp, wk, wv, K)
    if mesh is not None:
        dec = lambda: paged_attention_decode_window_sharded(  # noqa: E731
            q, kp, vp, 0, table, start, qp, wk, wv, K, mesh=mesh,
            kv_heads=KV * mesh.model)
    t_k, t_eager = time_ms(dec, iters=50), eager_ms(dec)
    t_p = time_ms(lambda: window_reference(q, kp, vp, 0, table, start, qp,
                                           wk, wv, K, scale), iters=5)
    got, want = dec(), window_reference(q, kp, vp, 0, table, start, qp, wk,
                                        wv, K, scale)
    err = max_err(got, want)
    limit = DECODE_REL_RMS * float(want.float().pow(2).mean().sqrt())
    if excess(got, want, *tolerance(kp.dtype)) > 0 or err > limit:
        fail(f"decode window at {len(ctx)} rows of {max(ctx)} positions: "
             f"max abs err {err:.3g} (limit {limit:.3g})")
    # control: the first 16 pool keys of every row out of view
    short = window_reference(q, kp, vp, 0, table, start, qp, wk, wv, K,
                             scale, None, (qp + 1 - 16).to(torch.int32))
    control = max_err(got, short)
    if control <= limit:
        fail(f"decode window at {len(ctx)} rows of {max(ctx)} positions: a "
             f"row one 16-key block short stays within the limit "
             f"({control:.3g} <= {limit:.3g}): the check is blind")
    ln = start.clamp(min=0).to(torch.int32)
    stats_ms = time_ms(lambda: paged_attention_decode_layered(
        q, kp, vp, 0, table, ln, return_stats=True), iters=50)
    S = P * ps
    kd = kp[0][table.long()].permute(0, 2, 1, 3, 4).reshape(B, KV, S, hd)
    vd = vp[0][table.long()].permute(0, 2, 1, 3, 4).reshape(B, KV, S, hd)
    kd = torch.cat([kd, wk.transpose(1, 2)], dim=2)
    vd = torch.cat([vd, wv.transpose(1, 2)], dim=2)
    mask = torch.cat([torch.arange(S, device=dev)[None, :] < ln[:, None],
                      (start >= 0)[:, None].expand(B, K)], dim=1)[:, None, None]
    qs = q[:, :, None, :]
    t_lib = time_ms(lambda: F.scaled_dot_product_attention(
        qs, kd, vd, attn_mask=mask, enable_gqa=True), iters=50)
    del kd, vd
    live, keys, bytes_ = decode_work(
        ln, None, torch.where(start >= 0, K, 0), heads=H, kv_heads=KV,
        head_dim=hd, elem_bytes=kp.element_size())
    flops = 4 * keys * H * hd
    route, splits = _decode_launch_plan(q, kp, vp, B, P)
    return {
        "max_abs_err": err, "err_limit": limit, "control_err": control,
        "decode_route": DECODE_ROUTES[route], "splits": splits,
        "live_splits": live_splits(ctx, ps, splits, DECODE_ROUTES[route],
                                   P, H // KV, hd, kp.dtype),
        "ms": t_k, "plain_ms": t_p,
        "bound_ms": max(bytes_ / H100_BYTES_PER_S,
                        flops / peak_flops) * 1e3,
        "bound_by": ("bytes" if bytes_ / H100_BYTES_PER_S
                     >= flops / peak_flops else "operations"),
        "library_ms": t_lib, "eager_ms": t_eager, "stats_form_ms": stats_ms,
        "work": {"rows": live, "kv_positions": keys, "bytes": bytes_,
                 "flops": flops},
        "shape": {"B": B, "H": H, "KV": KV, "hd": hd, "ps": ps, "P": P,
                  "pool": list(ctx), "window": K},
    }


def live_splits(ctx, ps: int, S: int, route: str, P: int, G: int, hd: int,
                dtype) -> list:
    """The splits of a cluster of ``S`` that read keys, per row of pool
    contexts ``ctx``, by the decode kernels' cut
    (dynamo_tpu_torch/ops/csrc/paged_attention.cu): on the bf16 and
    float32 routes (``db_min_pages``, ``DecodeF32Tile::RING_KEYS``) a
    row of n pages takes min(S, ceil(n / max(ring // ps, 1))) splits
    (ring 192 keys; 96 on the float32 route); the generic kernel cuts its
    key blocks (ops.paged_attention.decode_generic_shares)."""
    from dynamo_tpu_torch.ops import paged_attention as ops

    if route == "generic":
        plan = ops.decode_generic_plan(G, ps, hd, dtype)
        return [len(ops.decode_generic_shares(0, n, P, ps, S, plan))
                for n in ctx]
    least = max((96 if route == "f32" else 192) // ps, 1)
    return [min(S, -(-(-(-n // ps)) // least)) for n in ctx]


def time_prefill(k0, v0, ecfg, start: int, n: int, H: int, g,
                 mesh=None, peak_flops: float = H100_BF16_FLOPS) -> dict:
    """Kernel, plain version and SDPA on one prompt chunk of n tokens at
    positions start .. start + n - 1 (the row's earlier pages in the
    pool ``k0``/``v0`` [N, KV, ps, hd]), in the served bucket shapes; the
    kernel is held to its plain version (the tolerance of its dtype, as
    in check_prefill). With ``mesh``, through the tensor-parallel wrapper
    on the rank's heads (the pool holds the rank's kv heads).
    ``peak_flops``: the rate the bound counts the operations at (the
    float32 kernel's 3xTF32 does three TF32 products for each: a third of
    H100_TF32_FLOPS). A float32 row also carries ``bound_ffma_ms``, the
    bound at H100_F32_FLOPS."""
    import torch
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import paged_attention as ops
    from dynamo_tpu_torch.ops.paged_attention import (
        NO_WINDOW, paged_attention_prefill, paged_attention_prefill_sharded,
        prefill_reference, prefill_work)

    dev = k0.device
    N, KV, ps, hd = k0.shape
    el = k0.element_size()
    scale = hd ** -0.5
    T = ecfg.bucket_len(n)
    B = ecfg.prefill_bucket_batch(1)
    used = -(-(start + n) // ps)
    P = ecfg.bucket_pages(used)
    table = torch.zeros((B, P), dtype=torch.int32, device=dev)
    table[0, :used] = torch.randperm(N - 1, generator=g,
                                     device=dev)[:used] + 1
    pos = torch.full((B, T), -1, dtype=torch.int32, device=dev)
    pos[0, :n] = torch.arange(start, start + n, device=dev)
    win = torch.full((B,), NO_WINDOW, dtype=torch.int32, device=dev)
    qf = torch.randn(B, T, H, hd, generator=g, device=dev).to(k0.dtype)
    pf = lambda: paged_attention_prefill(  # noqa: E731
        qf, k0, v0, table, pos, eff_win=win)
    if mesh is not None:
        pf = lambda: paged_attention_prefill_sharded(  # noqa: E731
            qf, k0, v0, table, pos, mesh=mesh, kv_heads=KV * mesh.model,
            eff_win=win)
    t_k, t_eager = time_ms(pf, iters=20), eager_ms(pf, iters=20)
    t_p = time_ms(lambda: prefill_reference(qf, k0, v0, table, pos,
                                            scale, None, win), iters=5)
    got, want = pf(), prefill_reference(qf, k0, v0, table, pos, scale,
                                        None, win)
    err = max_err(got, want)
    if excess(got, want, *tolerance(k0.dtype)) > 0:
        fail(f"prefill at positions {start}..{start + n - 1} (H={H}, "
             f"KV={KV}, hd={hd}, {k0.dtype}): max abs err {err:.3g}")
    S = P * ps
    kd = k0[table.long()].permute(0, 2, 1, 3, 4).reshape(B, KV, S, hd)
    vd = v0[table.long()].permute(0, 2, 1, 3, 4).reshape(B, KV, S, hd)
    qpos = pos[:, :, None].long()
    kvpos = torch.arange(S, device=dev)[None, None, :]
    mask = ((kvpos <= qpos) | (qpos < 0))[:, None]
    qt = qf.transpose(1, 2)
    t_lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kd, vd, attn_mask=mask, enable_gqa=True), iters=20)
    queries, pairs, keys = prefill_work(pos, win)
    bytes_ = (2 * keys * KV * hd * el + 2 * queries * H * hd * el
              + table.numel() * 4 + pos.numel() * 4)
    flops = 4 * pairs * H * hd
    extra = {}
    if k0.dtype == torch.float32:
        extra["bound_ffma_ms"] = max(bytes_ / H100_BYTES_PER_S,
                                     flops / H100_F32_FLOPS) * 1e3
    return {
        "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
        "prefill_route": ops.PREFILL_ROUTES[ops.prefill_route(
            k0.dtype, H, KV, ps, hd)],
        "bound_ms": max(bytes_ / H100_BYTES_PER_S,
                        flops / peak_flops) * 1e3,
        "bound_by": ("bytes" if bytes_ / H100_BYTES_PER_S
                     >= flops / peak_flops else "operations"),
        **extra, "library_ms": t_lib, "eager_ms": t_eager,
        "work": {"queries": queries, "pairs": pairs, "kv_positions": keys,
                 "bytes": bytes_, "flops": flops},
        "shape": {"B": B, "T": T, "start": start, "valid": n, "H": H,
                  "KV": KV, "hd": hd, "ps": ps, "P": P},
    }


def time_kernels(engine, cfg, dev, served) -> list:
    import torch

    ecfg = engine.ecfg
    H, ps = cfg.num_heads, ecfg.page_size
    kp, vp = engine.kv_k, engine.kv_v
    g = torch.Generator(device=dev).manual_seed(7)
    # random K/V in layer 0 of the served pool (the engine has stopped):
    # most pages were never written, and zeros would hide any error
    kp[0].normal_(generator=g)
    vp[0].normal_(generator=g)
    rows = []

    # decode in the window form the main path launches (the last step of
    # a K-step window, K in-flight keys), at three shapes: the served
    # window (the concurrent batch, each row with its served context),
    # 32 rows of 520 positions (profile_step --rows 32 after its first
    # window) and 8 rows of 3,968 positions (62 pages each, 496 of the
    # pool's 511 usable pages)
    K = ecfg.decode_steps
    ctx = served["decode_lengths"]
    shapes = {}
    for name, rows_ctx in (("served", ctx), ("rows32", [520] * 32),
                           ("long8", [3968] * 8)):
        B = ecfg.bucket_batch(len(rows_ctx))
        P = ecfg.bucket_pages(max(-(-n // ps) for n in rows_ctx))
        shapes[name] = time_decode(kp, vp, rows_ctx, B, P, K, H, g)
    dec = shapes.pop("served")
    rows.append({
        "name": "paged_attention_decode", "route": "cuda",
        "source": "dynamo_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "dynamo_tpu/ops/paged_attention.py:52",
        # the kernels that served the 8B path (decode_route)
        "kernel": " and ".join(
            DECODE_KERNELS[r] for r, n in served["route_launches"].items()
            if n > 0),
        "launches": served["launches"]["paged_attention_decode"],
        "route_launches": served["route_launches"],
        **dec, "shapes": shapes,
    })

    # prefill at the served first chunk's shapes (one prompt chunk of
    # prefill_chunk tokens from position 0), and at a deep chunk of the
    # same size: the fourth chunk of a 2048-token prompt
    first = time_prefill(kp[0], vp[0], ecfg, 0, served["prefill_chunk"], H, g)
    chunk = ecfg.prefill_chunk
    deep = time_prefill(kp[0], vp[0], ecfg, 3 * chunk, chunk, H, g)
    rows.append({
        "name": "paged_attention_prefill", "route": "cuda",
        "source": "dynamo_tpu_torch/ops/csrc/paged_prefill.cu",
        "replaces": "dynamo_tpu/ops/paged_attention.py:336",
        "kernel": "paged_prefill_bf16_kernel",
        "launches": served["launches"]["paged_attention_prefill"],
        **first, "deep_chunk": deep,
    })

    # the float32 routes at the heads of the presets served in float32,
    # on float32 pools from a seed: the 1b's (phase 11 serves it, and its
    # launches fill the rows), the 8B's, and the tiny preset's (phase 10
    # serves it, with its own engine config: page 16)
    dec32, pf32 = {}, {}
    for name, (H32, KV32, hd32, ec, ctx32, chunk32) in f32_shapes(
            ecfg, ctx, served["prefill_chunk"]).items():
        N32 = ec.num_pages
        k32 = torch.randn(1, N32, KV32, ec.page_size, hd32, generator=g,
                          device=dev)
        v32 = torch.randn(1, N32, KV32, ec.page_size, hd32, generator=g,
                          device=dev)
        dec32[name] = time_decode(
            k32, v32, ctx32, ec.bucket_batch(len(ctx32)),
            ec.bucket_pages(max(-(-n // ec.page_size) for n in ctx32)),
            ec.decode_steps, H32, g, peak_flops=H100_F32_FLOPS)
        pf32[name] = time_prefill(k32[0], v32[0], ec, 0, chunk32, H32, g,
                                  peak_flops=H100_TF32_FLOPS / 3)
        del k32, v32
        torch.cuda.empty_cache()
    for name, line, src, kernel, times in (
            ("paged_attention_decode float32", 52, "paged_attention.cu",
             DECODE_KERNELS["f32"], dec32),
            ("paged_attention_prefill float32", 336, "paged_prefill.cu",
             "paged_prefill_f32_kernel (3xTF32)", pf32)):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"dynamo_tpu_torch/ops/csrc/{src}",
            "replaces": f"dynamo_tpu/ops/paged_attention.py:{line}",
            "kernel": kernel, "launches": 0, **times["1b"],
            "shapes": {k: v for k, v in times.items() if k != "1b"},
            "launches_from": "the 1b preset served in float32 (phase 11)"})

    # the float16 forms at the served window and first chunk, on float16
    # pools of the 8B's heads from a seed (phase 12 serves the 8B in
    # float16, and its launches fill the rows)
    k16 = torch.randn(1, ecfg.num_pages, cfg.num_kv_heads, ps, cfg.head_dim_,
                      generator=g, device=dev).to(torch.float16)
    v16 = torch.randn(1, ecfg.num_pages, cfg.num_kv_heads, ps, cfg.head_dim_,
                      generator=g, device=dev).to(torch.float16)
    B = ecfg.bucket_batch(len(ctx))
    P = ecfg.bucket_pages(max(-(-n // ps) for n in ctx))
    for name, line, src, kernel, times in (
            ("paged_attention_decode float16", 52, "paged_attention.cu",
             DECODE_KERNELS["f16_mma"],
             time_decode(k16, v16, ctx, B, P, K, H, g)),
            ("paged_attention_prefill float16", 336, "paged_prefill.cu",
             "paged_prefill_bf16_kernel<hd, ps, __half>",
             time_prefill(k16[0], v16[0], ecfg, 0, served["prefill_chunk"], H,
                          g))):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"dynamo_tpu_torch/ops/csrc/{src}",
            "replaces": f"dynamo_tpu/ops/paged_attention.py:{line}",
            "kernel": kernel, "launches": 0, **times,
            "launches_from": "the 8B served in float16 (phase 12)"})
    del k16, v16
    torch.cuda.empty_cache()

    # the generic decode kernel (paged_decode_generic_kernel) in bfloat16
    # at the heads phase 14 serves, Mistral-Large-2's 96 on 8 kv heads at
    # head_dim 128, page 64, on pools from a seed: the served window (its
    # launches fill the row), 32 rows of 520 positions and 8 of 3,968
    gen_shapes = {}
    km = torch.randn(1, ecfg.num_pages, 8, ps, 128, generator=g,
                     device=dev).to(torch.bfloat16)
    vm = torch.randn(1, ecfg.num_pages, 8, ps, 128, generator=g,
                     device=dev).to(torch.bfloat16)
    for name, rows_ctx in (("served", ctx), ("rows32 g12", [520] * 32),
                           ("long8 g12", [3968] * 8)):
        gen_shapes[name] = time_decode(
            km, vm, rows_ctx, ecfg.bucket_batch(len(rows_ctx)),
            ecfg.bucket_pages(max(-(-n // ps) for n in rows_ctx)), K, 96, g)
        if gen_shapes[name]["decode_route"] != "generic":
            fail(f"decode at Mistral-Large-2's heads ({name}) took route "
                 f"{gen_shapes[name]['decode_route']}, not the generic "
                 f"kernel")
    del km, vm
    torch.cuda.empty_cache()
    gen_row = {
        "name": "paged_attention_decode generic", "route": "cuda",
        "source": "dynamo_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "dynamo_tpu/ops/paged_attention.py:52",
        "kernel": "paged_decode_generic_kernel (bfloat16, 96 heads on 8, "
                  "head_dim 128, page 64)",
        "launches": 0, **gen_shapes.pop("served"), "shapes": gen_shapes,
        "launches_from": "Mistral-Large-2's widths served in bfloat16 "
                         "(phase 14)"}
    rows.append(gen_row)

    # the generic kernels at the 8B's heads with head_dim 96, outside
    # every fast set, on pools from a seed: the served window in
    # bfloat16, float16 and float32 (under the generic decode row's
    # shapes; float32 bound at 3xTF32, as its products) and the first
    # chunk in each (a row each, its launches from phase 13's engines;
    # float32 bound at 3xTF32, as the f32 route's)
    for dtype, peak in ((torch.bfloat16, H100_BF16_FLOPS),
                        (torch.float16, H100_BF16_FLOPS),
                        (torch.float32, H100_TF32_FLOPS / 3)):
        kg = torch.randn(1, ecfg.num_pages, cfg.num_kv_heads, ps, 96,
                         generator=g, device=dev).to(dtype)
        vg = torch.randn(1, ecfg.num_pages, cfg.num_kv_heads, ps, 96,
                         generator=g, device=dev).to(dtype)
        name = str(dtype).split(".")[-1]
        dec_g = time_decode(kg, vg, ctx, B, P, K, H, g, peak_flops=peak)
        if dec_g["decode_route"] != "generic":
            fail(f"decode at head_dim 96 in {name} took route "
                 f"{dec_g['decode_route']}, not the generic kernel")
        gen_row["shapes"][f"hd96 {name}"] = dec_g
        pf_g = time_prefill(kg[0], vg[0], ecfg, 0, served["prefill_chunk"], H,
                            g, peak_flops=peak)
        if pf_g["prefill_route"] != "generic":
            fail(f"prefill at head_dim 96 in {name} took route "
                 f"{pf_g['prefill_route']}, not the generic kernel")
        rows.append({
            "name": f"paged_attention_prefill generic {name}",
            "route": "cuda",
            "source": "dynamo_tpu_torch/ops/csrc/paged_prefill.cu",
            "replaces": "dynamo_tpu/ops/paged_attention.py:336",
            "kernel": f"paged_prefill_generic_kernel ({name}, head_dim 96)",
            "launches": 0, **pf_g, "launches_from": GENERIC_SERVED[name][0]})
        del kg, vg
        torch.cuda.empty_cache()
    # the chunk phase 13 serves: Llama-3.2-1B's heads (head_dim 64) in
    # bfloat16 at page 8, its engine config, on pools from a seed
    ec8 = generic_1b_ecfg()
    k8 = torch.randn(ec8.num_pages, 8, ec8.page_size, 64, generator=g,
                     device=dev).to(torch.bfloat16)
    v8 = torch.randn(ec8.num_pages, 8, ec8.page_size, 64, generator=g,
                     device=dev).to(torch.bfloat16)
    pf8 = time_prefill(k8, v8, ec8, 0, served["prefill_chunk"], 32, g)
    if pf8["prefill_route"] != "generic":
        fail(f"the 1b's page-8 chunk took route {pf8['prefill_route']}")
    next(r for r in rows if r["name"] == "paged_attention_prefill generic "
         "bfloat16")["shapes"] = {"1b page 8 (served, phase 13)": pf8}
    del k8, v8
    torch.cuda.empty_cache()

    # the synchronous arms' shapes on the served pool (phase 15 serves
    # them; its launches fill the rows): the single decode step at the
    # served contexts, and the verify step of --spec-tokens 4, a [B, 5]
    # chunk from each served context (mid-page) on the bf16 prefill route
    B = ecfg.bucket_batch(len(ctx))
    P = ecfg.bucket_pages(max(-(-(n + 5) // ps) for n in ctx))
    rows.append({
        "name": "paged_attention_decode step", "route": "cuda",
        "source": "dynamo_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "dynamo_tpu/ops/paged_attention.py:52",
        "kernel": "paged_decode_bf16_kernel, the single-step form "
                  "(decode_steps=1)",
        "launches": 0, **time_step(kp, vp, ctx, B, P, H, g),
        "launches_from": "engine (c), decode_steps=1 (phase 15)"})
    rows.append({
        "name": "paged_attention_prefill verify", "route": "cuda",
        "source": "dynamo_tpu_torch/ops/csrc/paged_prefill.cu",
        "replaces": "dynamo_tpu/ops/paged_attention.py:336",
        "kernel": "paged_prefill_bf16_kernel at the verify step's [B, 5] "
                  "chunk (--spec-tokens 4)",
        "launches": 0, **time_verify(kp[0], vp[0], ctx, B, P, 5, H, g),
        "launches_from": "engine (b), --spec-decode (phase 15)"})
    # the widened generic kernels: the 8B's heads (32 on 8) at head_dim
    # 512 in bfloat16, on pools from a seed: the served window and the
    # first chunk (their launches from phase 13's tiny engine at head dim
    # 512)
    kw = torch.randn(1, ecfg.num_pages, cfg.num_kv_heads, ps, 512,
                     generator=g, device=dev).to(torch.bfloat16)
    vw = torch.randn(1, ecfg.num_pages, cfg.num_kv_heads, ps, 512,
                     generator=g, device=dev).to(torch.bfloat16)
    P = ecfg.bucket_pages(max(-(-n // ps) for n in ctx))
    dec_w = time_decode(kw, vw, ctx, B, P, K, H, g)
    pf_w = time_prefill(kw[0], vw[0], ecfg, 0, served["prefill_chunk"], H, g)
    if (dec_w["decode_route"], pf_w["prefill_route"]) != ("generic",
                                                          "generic"):
        fail(f"head_dim 512 took {dec_w['decode_route']} / "
             f"{pf_w['prefill_route']}, not the generic kernels")
    for name, src, line, kern, t in (
            ("paged_attention_decode generic wide", "paged_attention.cu",
             52, "paged_decode_generic_kernel<__nv_bfloat16, 256, true>",
             dec_w),
            ("paged_attention_prefill generic wide", "paged_prefill.cu", 336,
             "paged_prefill_generic_kernel<__nv_bfloat16, 256, true>",
             pf_w)):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"dynamo_tpu_torch/ops/csrc/{src}",
            "replaces": f"dynamo_tpu/ops/paged_attention.py:{line}",
            "kernel": f"{kern} (32 heads on 8, head_dim 512: two column "
                      f"tiles)", "launches": 0, **t,
            "launches_from": "the tiny preset at head_dim 512 in bfloat16 "
                             "(phase 13)"})
    del kw, vw
    torch.cuda.empty_cache()
    return rows


# the tiny preset's served request (phase 10: one completion of a
# 16-token prompt and 12 tokens): its window's context and first chunk
TINY_SERVED_CTX, TINY_SERVED_CHUNK = [28], 16
# the generic prefill rows of the kernels line by dtype: the phase-13
# engine whose launches fill the row (what, its report key, the served
# shape's head_dim and where that shape is held to its plain version)
GENERIC_SERVED = {
    "bfloat16": ("the 1b in bfloat16 at page 8 (phase 13)",
                 "1b bf16 page 8", 64, "phase 5, the row's 1b page-8 chunk"),
    "float16": ("the tiny preset in float16 (phase 13)",
                "tiny float16 page 16", 16, "phase 3, generic-tiny"),
    "float32": ("the tiny preset in float32 at page 4 (phase 13)",
                "tiny float32 page 4", 16, "phase 3, generic-tiny")}
# phase 13's tiny engines: (dtype, page size)
TINY_GENERIC = (("float16", 16), ("float32", 4), ("bfloat16", 16))
# phase 13's tiny engine at head_dim 512 (the widened kernels' rows take
# their launches from it)
WIDE_SERVED = "tiny bfloat16 page 16 head_dim 512"


def generic_1b_ecfg():
    """Phase 13's engine config for the 1b in bfloat16: page 8 (the
    reference's --kv-cache-block-size 8), 1,024 pages, page buckets 16 and
    128 (1,024 tokens a row: phase 4's 625-token prompt and its tokens),
    the default chunk of 512."""
    from dynamo_tpu_torch.engine.torch_engine import EngineConfig

    return EngineConfig(page_size=8, num_pages=1024, page_buckets=(16, 128))


def f32_shapes(ecfg, ctx, chunk) -> dict:
    """Phase 5's float32 shapes: name -> (H, KV, head_dim, engine config,
    window contexts, first chunk): the 1b's and the 8B's heads at the
    served window (phase 4's contexts) and first chunk, the tiny preset's
    at its own served request."""
    from dynamo_tpu_torch.run import build_engine_config, parse_args

    tiny_ecfg = build_engine_config(parse_args(["in=http", "out=torch"]))
    return {"1b": (32, 8, 64, ecfg, ctx, chunk),
            "8b": (32, 8, 128, ecfg, ctx, chunk),
            "tiny": (4, 2, 16, tiny_ecfg, TINY_SERVED_CTX,
                     TINY_SERVED_CHUNK)}


def log_kernel_row(r: dict) -> None:
    log(f"  {r['name']}: {r['ms']:.4f} ms on the device, {r['eager_ms']:.4f}"
        f" ms called eagerly (bound {r['bound_ms']:.4f} ms by "
        f"{r['bound_by']}; plain {r['plain_ms']:.4f} ms; SDPA "
        f"{r['library_ms']:.4f} ms); launches {r['launches']}"
        + (f" ({r['launches_per_token']:.1f}/token)"
           if "launches_per_token" in r else "")
        + (f"; FFMA bound {r['bound_ffma_ms']:.4f} ms"
           if "bound_ffma_ms" in r else "")
        + f"; max abs err {r['max_abs_err']:.4g}" + (
            f" (limit {r['err_limit']:.4g}, control {r['control_err']:.4g})"
            if "err_limit" in r else "") + f"; shape {r['shape']}")
    for shape, d in ([("deep chunk", r["deep_chunk"])]
                     if "deep_chunk" in r else []) + list(
                         r.get("shapes", {}).items()):
        log(f"  {r['name']} {shape}: {json.dumps(d)}")


# ---------------------------------------------------------------- int8

# the int8 GEMM's shapes on the 8B main path (K, N): wq and wo, wk and
# wv, w_gate and w_up, w_down, lm_head; one rank's at tp=2; ragged M, N
# and K (not a multiple of the kernel's 64-wide chunk)
INT8_SHAPES = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024),
               "gate_up": (4096, 14336), "down": (14336, 4096),
               "lm_head": (4096, 128256)}
INT8_TP2_SHAPES = {"wq": (4096, 2048), "wk_wv": (4096, 512),
                   "gate_up": (4096, 7168), "lm_head": (4096, 64128),
                   "wo": (2048, 4096), "down": (7168, 4096)}
INT8_RAGGED = [(3, 4096, 1000), (37, 4096, 130), (100, 4096, 4100),
               (300, 1040, 1000), (17, 48, 33), (5, 1040, 130)]
# the rows M of a decode window (4 at the served batch, 16 to 64 about
# the routes' crossover, 64 at the largest bucket) and of a prefill chunk
# (one of 512 tokens, 8 x 512)
INT8_ROWS = (1, 4, 16, 24, 32, 48, 64, 512, 4096)
INT8_TIMED_ROWS = (4, 16, 32, 48, 64, 512, 4096)
# rows where both bf16 routes are timed, to place their crossover
INT8_CROSS_ROWS = (4, 16, 32, 48, 64)
# the kernels line carries the served window's and first chunk's rows
INT8_LINE_ROWS = (4, 512)
# the float32 tiny preset's projections (K, N), the launcher's default
# model: wq and wo, wk and wv, w_gate and w_up, w_down, lm_head; served
# through the float32 forms, at the rows of a decode window and a chunk
INT8_TINY_SHAPES = {"wq_wo": (64, 64), "wk_wv": (64, 32),
                    "gate_up": (64, 128), "down": (128, 64),
                    "lm_head": (64, 512)}
INT8_TINY_ROWS = (4, 128)
# Llama-3.2-1B's projections (K, N), where phase 11 serves the float32
# forms: held at INT8_ROWS, and timed beside float32 torch.matmul and
# torch._weight_int8pack_mm at the rows of a decode window and a chunk
INT8_1B_SHAPES = {"wq_wo": (2048, 2048), "wk_wv": (2048, 512),
                  "gate_up": (2048, 8192), "down": (8192, 2048),
                  "lm_head": (2048, 128256)}
INT8_1B_ROWS = (4, 512)
# the checks and controls of each route and form: (name, M, K, N, dtype)
INT8_ROUTE_CASES = [("small_m", 4, 4096, 1024, "bfloat16"),
                    ("small_m", 32, 4096, 4096, "bfloat16"),
                    ("wgmma", 48, 4096, 4096, "bfloat16"),
                    ("wgmma", 512, 4096, 1024, "bfloat16"),
                    ("small_m", 4, 2048, 2048, "float32"),
                    ("small_m", 16, 2048, 512, "float32"),
                    ("wgmma", 48, 2048, 2048, "float32"),
                    ("wgmma", 512, 2048, 512, "float32"),
                    ("small_m", 4, 4096, 1024, "float16"),
                    ("small_m", 32, 4096, 4096, "float16"),
                    ("wgmma", 48, 4096, 4096, "float16"),
                    ("wgmma", 512, 4096, 1024, "float16")]
# timed calls cycle over copies of the weights holding this many int8
# bytes, so each call finds its weights out of the 50 MB L2 as a layer's
# call does
INT8_COLD_BYTES = 256 * 2**20
# the int8 logits against the bf16 logits of the same seed-0 weights, as
# rel_l2. tests/test_quant.py bounds the scheme's error by 0.05 on a
# 2-layer model of width 64; the error grows with depth and width, and
# the 8B's 32 layers of 4096 read 0.060 on an H100 80GB HBM3 (PERF.md,
# Findings) with the int8 path at its plain version's bf16 noise
# (check_paths). 0.1 keeps this a check on the scheme's scale; the
# int8 fault of check_paths reports its own rel_l2 beside it.
INT8_REL_L2 = 0.1
INT8_SOURCE = "dynamo_tpu_torch/ops/csrc/int8_gemm.cu"
# no TPU kernel: QuantInt8.__rmatmul__, an XLA fusion
INT8_REPLACES = "dynamo_tpu/models/quant.py:87"


def int8_case(dev, M: int, K: int, N: int, seed: int = 0,
              dtype: str = "bfloat16"):
    """x [M, K] in ``dtype`` (bfloat16 unless named) and a random [K, N]
    weight quantized on the card: (x, q [N, K], s [N], the QuantInt8)."""
    import torch

    from dynamo_tpu_torch.models.quant import quantize_int8

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=dev).to(getattr(torch, dtype))
    qw = quantize_int8(torch.randn(K, N, generator=g, device=dev)
                       / K ** 0.5)
    return x, qw.q, qw.s.reshape(-1), qw


def int8_excess(y, x, q, s) -> tuple:
    """(largest amount by which y passes the stated tolerance, its max
    abs error) against the float32 evaluation of the plain version."""
    from dynamo_tpu_torch.ops.int8_gemm import int8_gemm_tolerance

    ref, tol = int8_gemm_tolerance(x, q, s)
    y = y.float().reshape(ref.shape)
    return float(((y - ref).abs() - tol).max()), max_err(y, ref)


def check_int8_gemm(dev) -> dict:
    """The int8 GEMM against the float32 evaluation of its plain version
    (TF32 off) at every shape of INT8_SHAPES at every M of INT8_ROWS in
    bfloat16 (the small_m and wgmma routes) and in float16 (their
    float16 forms), at every shape of INT8_1B_SHAPES at every M of
    INT8_ROWS in float32 (their float32 forms), at tp=2's shapes (M = 4,
    32 and 512) and at ragged M, N and K, in bfloat16 and, for tp=2's
    shapes at M = 4 and the ragged shapes, in float32: within
    ``ops/int8_gemm.py
    int8_gemm_tolerance``, one rounding of the output to its dtype (2^-8
    of it in bf16, 2^-11 in float16, 2^-24 in float32) plus the float32
    sums in another order (2^-16 of the sum of the terms' magnitudes).
    Each case records the route it took (with ``_f16`` or ``_f32`` for
    a float16 or float32 form). The control, one scale 1 + 2^-5 off, must pass the tolerance
    at every route and form (INT8_ROUTE_CASES)."""
    import torch

    from dynamo_tpu_torch.ops.int8_gemm import (device_plan, int8_matmul,
                                                launch_key)

    cases = ([(n, M, K, N, d) for d in ("bfloat16", "float16")
              for n, (K, N) in INT8_SHAPES.items() for M in INT8_ROWS]
             + [(f"1b {n}", M, K, N, "float32")
                for n, (K, N) in INT8_1B_SHAPES.items() for M in INT8_ROWS]
             + [(f"tp2 {n}", M, K, N, "bfloat16")
                for n, (K, N) in INT8_TP2_SHAPES.items()
                for M in INT8_LINE_ROWS + (32,)]
             + [("ragged", M, K, N, "bfloat16") for M, K, N in INT8_RAGGED]
             + [(f"tp2 {n}", 4, K, N, "float32")
                for n, (K, N) in INT8_TP2_SHAPES.items()]
             + [("ragged", M, K, N, "float32") for M, K, N in INT8_RAGGED])
    out = {}
    for name, M, K, N, dtype in cases:
        x, q, s, _ = int8_case(dev, M, K, N, dtype=dtype)
        route = launch_key(device_plan(M, N, K, dev, x.dtype).route, x.dtype)
        ex, err = int8_excess(int8_matmul(x, q, s), x, q, s)
        key = f"{name} {K}x{N} M={M}" + ("" if dtype == "bfloat16"
                                          else f" {dtype}")
        out[key] = {"max_abs_err": err, "excess": ex, "route": route}
        if ex > 0:
            fail(f"int8 GEMM {key} ({route}): {ex:.4g} past the tolerance "
                 f"(max abs err {err:.4g})")
        del x, q, s
    for want, M, K, N, dtype in INT8_ROUTE_CASES:
        x, q, s, _ = int8_case(dev, M, K, N, dtype=dtype)
        route = device_plan(M, N, K, dev, x.dtype).route
        if route != want:
            fail(f"int8 control {M}x{K}x{N} {dtype} took route {route}, "
                 f"not {want}")
        route = launch_key(route, x.dtype)
        bad = s.clone()
        bad[7] *= 1 + 2.0 ** -5
        ex, err = int8_excess(int8_matmul(x, q, bad), x, q, s)
        out[f"control: scale 7 off by 2^-5, {K}x{N} M={M} {dtype} "
            f"({route})"] = {"max_abs_err": err, "excess": ex,
                             "route": route}
        if ex <= 0:
            fail(f"the perturbed-scale control stays within the int8 "
                 f"tolerance at M={M} {dtype} ({route}): the check is blind")
    torch.cuda.empty_cache()
    worst = max(v["excess"] for k, v in out.items()
                if not k.startswith("control"))
    by_route = {}
    for k, v in out.items():
        if not k.startswith("control"):
            by_route[v["route"]] = by_route.get(v["route"], 0) + 1
    log(f"  int8 GEMM vs plain, {len(cases)} shapes within tolerance "
        f"(largest excess {worst:.4g} <= 0; cases by route "
        f"{json.dumps(by_route)}); controls "
        f"{json.dumps({k: v for k, v in out.items() if k.startswith('control')})}")
    return out


def time_int8_gemm(dev, errs: dict) -> list:
    """The int8 GEMM timed at the served shapes (INT8_SHAPES at every M
    of INT8_TIMED_ROWS, bfloat16 and float16), at the tiny preset's
    (INT8_TINY_SHAPES at INT8_TINY_ROWS, float32: the float32 forms) and
    at the 1b's (INT8_1B_SHAPES at INT8_1B_ROWS, float32, beside float32
    torch.matmul) in a CUDA graph of calls that cycle over copies of the
    weights (INT8_COLD_BYTES), beside its bound (``int8_gemm_work``; in
    float32 also the FFMA bound, ``bound_ffma_ms``), its plain
    version, ``torch.matmul`` on the dequantized weight in x's dtype (the
    unquantized path's cost of the same product), the other bf16 route
    at INT8_CROSS_ROWS where it takes the rows (forced, to place the
    crossover; bfloat16 only) and, where the card's torch runs it on CUDA,
    ``torch._weight_int8pack_mm`` (one PyTorch call of the same function,
    timed over fewer calls; the port never calls it). The small-M route
    is timed both ways (its launch is programmatic, so back to back a
    call overlaps the one before it): ``ms``, a graph of calls back to
    back, and, in bfloat16, ``after_write_ms``, after a kernel that
    writes its x (:func:`after_write_ms`), as wq, wo and w_down follow a
    norm, attention or SiLU-mul; and back to back with programmatic
    launch switched off (``ms_without_pdl``)."""
    import itertools

    import torch

    from dynamo_tpu_torch.ops.int8_gemm import (SMALL_M_ROWS, device_plan,
                                                int8_gemm_work, int8_matmul,
                                                int8_matmul_plain, launch_key,
                                                resident_of, set_programmatic,
                                                small_m_plan, wgmma_plan)

    def library(x, q, s):
        return torch._weight_int8pack_mm(x, q, s.to(x.dtype))

    notes = {}
    for dtype in ("bfloat16", "float16", "float32"):
        x, q, s, _ = int8_case(dev, 4, 64, 32, dtype=dtype)
        try:
            library(x, q, s)
            torch.cuda.synchronize()
            notes[dtype] = None
        except (RuntimeError, NotImplementedError) as e:
            notes[dtype] = (f"{type(e).__name__}: "
                            f"{str(e).splitlines()[0][:160]}")
            log(f"  torch._weight_int8pack_mm does not run on CUDA here "
                f"for {dtype} x: {notes[dtype]}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def other_plan(M, N, K, plan):
        """The other bf16 route's launch of the same call (None where the
        small-M route cannot take the rows)."""
        if plan.route == "small_m":
            return wgmma_plan(M, N, K, resident_of(dev))
        if M <= SMALL_M_ROWS:
            return small_m_plan(M, N, K, sms, resident_of(dev))
        return None

    rows = []
    cells = ([(n, K, N, M, d) for d in ("bfloat16", "float16")
              for n, (K, N) in INT8_SHAPES.items()
              for M in INT8_TIMED_ROWS]
             + [(f"tiny {n}", K, N, M, "float32")
                for n, (K, N) in INT8_TINY_SHAPES.items()
                for M in INT8_TINY_ROWS]
             + [(f"1b {n}", K, N, M, "float32")
                for n, (K, N) in INT8_1B_SHAPES.items()
                for M in INT8_1B_ROWS])
    for (name, K, N, _), group in itertools.groupby(
            cells, key=lambda c: c[:3] + (c[4],)):
        copies = max(1, min(64, -(-INT8_COLD_BYTES // (K * N))))
        group = list(group)
        dtype = group[0][4]
        ws = []
        for c in range(copies):
            _, q, s, qw = int8_case(dev, 1, K, N, seed=10 + c)
            ws.append((q, s, qw.dequant(getattr(torch, dtype)).contiguous()))
        for _, _, _, M, dtype in group:
            x = torch.randn(M, K, device=dev).to(getattr(torch, dtype))
            turn = itertools.count()
            plan = device_plan(M, N, K, dev, x.dtype)

            def pick():
                return ws[next(turn) % copies]

            def kern(p=None):
                q, s, _ = pick()
                return int8_matmul(x, q, s, plan=p)

            def plain():
                q, s, _ = pick()
                return int8_matmul_plain(x, q, s)

            def dense():
                return x @ pick()[2]

            def lib():
                q, s, _ = pick()
                return library(x, q, s)

            work = int8_gemm_work(M, K, N, x.dtype)
            iters = (20 if work["bound_ms"] < 0.2 else
                     5 if work["bound_ms"] < 2 else 2)
            key = f"{name} {K}x{N} M={M}" + ("" if dtype == "bfloat16"
                                              else f" {dtype}")
            form = {"float16": "<..., __half>",
                    "float32": "<..., float>"}.get(dtype, "")
            row = {
                "name": f"int8_gemm {key}", "route": "cuda",
                "source": INT8_SOURCE, "replaces": INT8_REPLACES,
                "kernel": f"int8_matmul (ops/int8_gemm.py) -> "
                          f"int8_gemm_{plan.route.split('_')[0]}_kernel{form}",
                "int8_route": launch_key(plan.route, x.dtype),
                "plan": list(plan), "M": M, "K": K,
                "N": N, "dtype": dtype, "launches": 0,
                "max_abs_err": (errs[key]["max_abs_err"] if key in errs
                                else None),
                "ms": time_ms(kern, iters), "plain_ms": time_ms(plain, iters),
                "matmul_ms": time_ms(dense, iters), "matmul_dtype": dtype,
                "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
                **({"bound_ffma_ms": work["bound_ffma_ms"]}
                   if "bound_ffma_ms" in work else {}),
                # the library call is far slower than the kernel: a
                # graph of two calls at decode rows, one call at prefill's
                "library_ms": (None if notes[dtype] is not None else
                               time_ms(lib, 2, warmup=1) if M <= 64
                               else once_ms(lib)),
                "library": "torch._weight_int8pack_mm" + (
                    "" if notes[dtype] is None
                    else f" (not on CUDA: {notes[dtype]})")}
            if row["max_abs_err"] is None:
                # a shape only timed here (the tiny preset's, the 1b's):
                # held to the tolerance on this call
                q, s, _ = ws[0]
                ex, row["max_abs_err"] = int8_excess(int8_matmul(x, q, s),
                                                     x, q, s)
                if ex > 0:
                    fail(f"int8 GEMM {key} {dtype}: {ex:.4g} past the "
                         f"tolerance")
            if plan.route == "small_m" and dtype == "bfloat16":
                row["after_write_ms"] = after_write_ms(kern, x, iters)
                set_programmatic(False)
                try:
                    row["ms_without_pdl"] = time_ms(kern, iters)
                finally:
                    set_programmatic(True)
            other = (other_plan(M, N, K, plan)
                     if dtype == "bfloat16" and M in INT8_CROSS_ROWS
                     else None)
            if other is not None:
                row["other_route"] = other.route
                row["other_plan"] = list(other)
                row["other_ms"] = time_ms(lambda: kern(other), iters)
                if other.route == "small_m":
                    row["other_after_write_ms"] = after_write_ms(
                        lambda: kern(other), x, iters)
            rows.append(row)
            log(f"  {row['name']} ({row['int8_route']}): {row['ms']:.4f} "
                f"ms (bound {work['bound_ms']:.4f}, {work['bound_by']}"
                + (f", FFMA {row['bound_ffma_ms']:.4f}"
                   if "bound_ffma_ms" in row else "") + "; "
                f"plain {row['plain_ms']:.4f}; {dtype} matmul "
                f"{row['matmul_ms']:.4f}; library {row['library_ms']}"
                + (f"; after a writer {row['after_write_ms']:.4f}, without "
                   f"PDL {row['ms_without_pdl']:.4f}"
                   if "after_write_ms" in row else "")
                + (f"; {row['other_route']} {row['other_ms']:.4f}"
                   if "other_ms" in row else "")
                + (f" (after a writer {row['other_after_write_ms']:.4f})"
                   if "other_after_write_ms" in row else "") + ")")
        del ws
        torch.cuda.empty_cache()
    return rows


def after_write_ms(fn, x, iters: int) -> float:
    """Device ms of ``fn`` after a kernel that writes its x: a graph of
    (``torch.add(x_src, 0, out=x)``, ``fn``) pairs less a graph of the
    writer alone (x_src: a copy of x, so x keeps its values)."""
    import torch

    x_src = x.clone()

    def write():
        torch.add(x_src, 0, out=x)

    def pair():
        write()
        return fn()

    return time_ms(pair, iters) - time_ms(write, iters)


def check_programmatic_replay(dev) -> dict:
    """Programmatic launch under CUDA-graph capture: a graph of 20 small-M
    calls back to back (wk/wv's shape at 4 rows, the weights cycling
    over copies out of the L2), replayed with the launches programmatic
    and then not; the replay must give the eager call's bits either way.
    A replay that is faster with it shows the captured launch kept its
    programmatic edge (the result records both times)."""
    import itertools

    import torch

    from dynamo_tpu_torch.ops.int8_gemm import int8_matmul, set_programmatic

    M, K, N = 4, 4096, 1024
    x, q, s, _ = int8_case(dev, M, K, N, seed=20)
    copies = max(1, INT8_COLD_BYTES // (K * N))
    ws = [int8_case(dev, 1, K, N, seed=21 + c)[1:3] for c in range(copies)]
    eager = [int8_matmul(x, wq, ws_) for wq, ws_ in ws[:2]]
    out = {}
    for on in (True, False):
        set_programmatic(on)
        try:
            turn = itertools.count()

            def call():
                wq, ws_ = ws[next(turn) % copies]
                return int8_matmul(x, wq, ws_)

            out["ms_pdl" if on else "ms_no_pdl"] = time_ms(call, 20)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                got = [int8_matmul(x, wq, ws_) for wq, ws_ in ws[:2]]
            graph.replay()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, eager)):
                fail(f"small-M replay (programmatic={on}) differs from the "
                     f"eager calls")
        finally:
            set_programmatic(True)
    out["replay_bitwise_eager"] = True
    log(f"  small-M launches in a graph, programmatic vs not (ms a call, "
        f"back to back): {json.dumps(out)}")
    return out


def same_param(a, b) -> bool:
    """Bitwise equal params: a tensor, or an int8 weight's q and s."""
    import torch

    from dynamo_tpu_torch.models.quant import QuantInt8

    if isinstance(a, QuantInt8) or isinstance(b, QuantInt8):
        return (isinstance(a, QuantInt8) and isinstance(b, QuantInt8)
                and torch.equal(a.q, b.q) and torch.equal(a.s, b.s))
    return torch.equal(a, b)


def compare_int8_bf16(int8_logits, bf16_logits, what: str = "bf16") -> dict:
    """check_paths' teacher-forced logits (prefill, then every window
    step) of the int8 engine against the bf16 engine's (``what``: the
    float16 engine's in phase 12) on the same seed-0 weights: rel_l2
    below INT8_REL_L2, and the greedy agreement."""
    import torch

    a = torch.cat([int8_logits[0][None], int8_logits[1]])
    b = torch.cat([bf16_logits[0][None], bf16_logits[1]])
    rel = rel_l2(a, b)
    agree = a.argmax(-1) == b.argmax(-1)
    out = {"rel_l2": rel, "limit": INT8_REL_L2,
           "rel_l2_by_step": [rel_l2(x, y) for x, y in zip(a, b)],
           "greedy_agree": int(agree.sum()), "greedy_of": agree.numel()}
    log(f"  int8 vs {what} logits (same seed-0 weights): {json.dumps(out)}")
    if not rel < INT8_REL_L2:
        fail(f"int8 logits rel_l2 {rel:.4g} from {what}'s >= {INT8_REL_L2}")
    return out


def serve_tiny_int8(out_dir: str) -> dict:
    """The launcher's defaults with ``--dtype int8``: the float32 tiny
    preset on the card (``python -m dynamo_tpu_torch.run in=http
    out=torch --dtype int8``), which must answer one completion; its
    serving summary must show no capture after warmup and every
    projection of every replayed chunk and window step (7 a layer and
    the head) through the int8 GEMM's float32 forms, and no other form."""
    import urllib.request

    from dynamo_tpu_torch.engine.torch_engine import EngineConfig
    from dynamo_tpu_torch.models.config import ModelConfig

    port = _free_port()
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.run", "in=http",
           "out=torch", "--dtype", "int8", "--model-name", "tiny-int8",
           "--http-host", "127.0.0.1", "--http-port", str(port)]
    path = os.path.join(out_dir, "serve_tiny_int8.log")
    report = {}

    def drive(procs):
        t0 = time.monotonic()
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                            timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            if procs[0].poll() is not None:
                fail(f"the tiny int8 launcher exited {procs[0].returncode} "
                     f"before serving:\n{_tail(path)}")
            if time.monotonic() - t0 > 300:
                fail(f"the tiny int8 launcher is not serving after 300 s:\n"
                     f"{_tail(path)}")
            time.sleep(0.5)
        report["start_s"] = time.monotonic() - t0
        body = json.dumps({"model": "tiny-int8", "prompt": "Once upon a time",
                           "max_tokens": 12}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/completions", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            if r.status != 200:
                fail(f"tiny int8 completion: HTTP {r.status}")
            out = json.loads(r.read())
        report["finish_reason"] = out["choices"][0]["finish_reason"]
        report["usage"] = out.get("usage")
        if report["finish_reason"] not in ("length", "stop"):
            fail(f"tiny int8 completion finished by "
                 f"{report['finish_reason']!r}")
        procs[0].send_signal(signal.SIGTERM)

    rcs = _run_ranks([cmd], [path], 420, until=drive, rank_env=False)
    if rcs[0] != 0:
        fail(f"the tiny int8 launcher exited {rcs[0]}:\n{_tail(path)}")
    summary = None
    with open(path) as f:
        for line in f:
            if "serving summary " in line:
                summary = json.loads(line.split("serving summary ", 1)[1])
    if summary is None:
        fail(f"the tiny int8 launcher printed no serving summary:\n"
             f"{_tail(path)}")
    L = ModelConfig.tiny().num_layers
    K = EngineConfig().decode_steps
    pf = summary["replays"]["prefill"]
    win = summary["replays"]["decode_window"]
    int8 = summary["int8_gemm_launches"]
    want = (pf + win * K) * (7 * L + 1)
    if (summary["post_warmup_compiles_total"] != 0 or win <= 0
            or sum(int8.values()) != want
            or any(n for k, n in int8.items() if not k.endswith("_f32"))):
        fail(f"tiny int8 serving summary: int8 GEMM launches {int8}, not "
             f"{want} on the float32 forms alone ({pf} chunk replays, {win} "
             f"windows x {K} steps x {7 * L + 1}), or a capture after "
             f"warmup: {json.dumps(summary)}")
    # the tiny preset's attention (head_dim 16, page 16, group 2) on the
    # float32 routes
    lc = summary["launches"]
    if (summary["route_launches"]["f32"] != lc["paged_attention_decode"]
            or summary["prefill_route_launches"]["f32"]
            != lc["paged_attention_prefill"]
            or lc["paged_attention_decode"] != win * L * K):
        fail(f"tiny int8 serving summary: attention calls not all on the "
             f"float32 routes: {json.dumps(summary)}")
    report["summary"] = summary
    log(f"  tiny preset served with --dtype int8 (float32 forms): "
        f"{json.dumps(report)}")
    return report


def int8_phase(cfg, dev, bf16_logits) -> tuple:
    """Phase 10: the int8 GEMM held against its plain version and timed
    (check_int8_gemm, time_int8_gemm); then the 8B model built by the
    launcher's ``--dtype int8`` path (random seed-0 weights quantized as
    drawn, every graph of the bf16 engine's grid warmed) and checked as
    phase 4 checks the bf16 one: phase 4's requests over HTTP, every
    projection of every replayed chunk and window step through the
    kernel and no capture after warmup (serve_and_check), served
    logprobs against the int8 plain path (check_logprobs), the kernel
    path against the plain path teacher-forced with its controls
    (check_paths), the logits against the bf16 engine's on the same
    weights (compare_int8_bf16), one window and two chunks by replay
    against eager calls (check_graph_window, check_graph_prefill).
    Returns (report, the kernel rows, check_paths' int8 logits)."""
    import torch

    from dynamo_tpu_torch.models.quant import QuantInt8
    from dynamo_tpu_torch.run import build_engine, parse_args

    errs = check_int8_gemm(dev)
    programmatic = check_programmatic_replay(dev)
    rows = time_int8_gemm(dev, errs)
    t = time.monotonic()
    engine, mdc, _ = build_engine(parse_args([
        "in=http", "out=torch", "--model", "8b", "--dtype", "int8",
        "--max-batch-size", str(TRAFFIC_MAX_BATCH),
        "--model-name", "llama3-8b-int8-random"]))
    topn = engine.ecfg.max_top_logprobs
    check_warmed(engine, [(0, 0), (topn, 0)], [0, topn])
    weights = {"int8_projections_bytes": sum(
        v.nbytes for v in engine.params.values() if isinstance(v, QuantInt8)),
        "other_bytes": sum(v.nbytes for v in engine.params.values()
                           if not isinstance(v, QuantInt8))}
    log(f"  8B int8 engine (--dtype int8: 32 layers, seed 0 quantized) "
        f"built and warmed up in {time.monotonic() - t:.1f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated; "
        f"weights {json.dumps(weights)}")
    served, ttft, solo_ref = asyncio.run(serve_and_check(engine, mdc))
    log(f"  served int8: {json.dumps(served)}")
    for batch_name, stages in (("cold", ttft["cold"]),
                               ("warm 1", ttft["warm"][0])):
        log(f"  int8 TTFT stages, {batch_name} batch: {json.dumps(stages)}")
    logprobs = check_logprobs(engine, cfg, dev, solo_ref)
    paths, logits = check_paths(engine, cfg, dev)
    vs_bf16 = compare_int8_bf16(logits, bf16_logits)
    graph_window = check_graph_window(engine, cfg, dev)
    graph_prefill = check_graph_prefill(engine, dev)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    tiny_dir = tempfile.mkdtemp(prefix="chip_smoke_tiny_")
    try:
        tiny = serve_tiny_int8(tiny_dir)
    finally:
        shutil.rmtree(tiny_dir, ignore_errors=True)
    for r in rows:
        if r["dtype"] == "float16":
            r["launches_from"] = "the 8B served in float16 with int8 " \
                                 "weights (phase 12)"
            continue  # phase 12 serves the float16 forms
        if r["name"].startswith("int8_gemm 1b "):
            r["launches_from"] = "the 1b served in float32 with int8 " \
                                 "weights (phase 11)"
            continue  # phase 11 serves the 1b's float32 forms
        if r["dtype"] == "float32":
            r["launches_from"] = "the tiny preset served with --dtype int8"
        launched = (tiny["summary"] if r["dtype"] == "float32"
                    else served)["int8_gemm_launches"]
        r["launches"] = launched[r["int8_route"]]
        if r["M"] in INT8_LINE_ROWS and r["launches"] <= 0:
            fail(f"{r['name']}: its route {r['int8_route']} was not "
                 f"launched on the served path")
    report = {"weights": weights, "served": served, "tiny": tiny,
              "ttft": {"cold": ttft["cold"], "warm_spread":
                       ttft["warm_spread"]},
              "logprobs": logprobs, "paths": paths, "vs_bf16": vs_bf16,
              "graph_window": graph_window, "graph_prefill": graph_prefill,
              "kernel_errs": errs, "programmatic_replay": programmatic}
    return report, rows, logits


def check_tp_int8(ckpt_dir: str, reference, out_dir: str) -> dict:
    """Two ranks of :func:`tp_worker` in its int8 mode on the one card:
    each loads its shard of the phase-8 checkpoint with quant="int8",
    which must be bitwise the cut of tp=1's (the engine's seed-0 weights
    quantized whole and cut, as random init does at tp=2), and runs
    check_paths' inputs on it; its logits must stay within tp=1 int8's
    limits (compare_tp_logits against phase 10's), the ranks' bitwise
    equal."""
    import torch

    coordinator = f"127.0.0.1:{_free_port()}"
    cmds = [[sys.executable, os.path.join(REPO, "chip_smoke.py"),
             "--tp-worker", str(r), "--tp-coordinator", coordinator,
             "--tp-dir", out_dir, "--tp-int8", ckpt_dir]
            for r in range(TP_RANKS)]
    logs = [os.path.join(out_dir, f"tp_int8_rank{r}.log")
            for r in range(TP_RANKS)]
    t0 = time.monotonic()
    rcs = _run_ranks(cmds, logs, 360)
    for r in sorted(range(TP_RANKS), key=lambda r: rcs[r] is None
                    or rcs[r] < 0):
        if rcs[r] != 0:
            fail(f"tp int8 rank {r} exited {rcs[r]}:\n{_tail(logs[r])}")
    got = [torch.load(os.path.join(out_dir, f"tp_int8_rank{r}.pt"))
           for r in range(TP_RANKS)]
    for r in range(1, TP_RANKS):
        if not all(torch.equal(got[0][k], got[r][k])
                   for k in ("prefill", "steps")):
            fail(f"tp int8 rank {r}'s logits differ from rank 0's")
    result = {"keys_equal": [g["keys_equal"] for g in got],
              "load_s": [g["load_s"] for g in got],
              **compare_tp_logits(got[0], reference, "tp=2 int8"),
              "seconds": time.monotonic() - t0}
    log(f"  tp=2 int8 shards and logits vs tp=1 int8: {json.dumps(result)}")
    return result


# ------------------------------------------------------ tensor parallel

TP_SIZES = (2, 4, 8)
# the served tensor-parallel phase: ranks of the model axis on the one card
TP_RANKS = 2


def check_local_shapes(dev) -> dict:
    """The tensor-parallel wrappers at the heads one rank holds of the 8B
    widths at tp = 2, 4 and 8 (32/tp q heads, 8/tp kv heads, GQA group 4
    on every rank): the decode kernel in the layered form with stats and
    in the window form, and the prefill kernel (a first chunk of 512 and a
    second chunk), against their plain versions under the limits of
    phases 2 and 3, in float32, bfloat16 and float16. Every call must
    take its dtype's route: the float32 route, the bf16 kernels or their
    float16 forms. Few kv heads mean few (row, kv head) pairs, so the
    split plan gives whole clusters of 8 splits here."""
    import torch

    from dynamo_tpu_torch.ops import paged_attention as ops
    from dynamo_tpu_torch.ops.paged_attention import (
        NO_WINDOW, decode_reference, prefill_reference, window_reference)
    from dynamo_tpu_torch.parallel.mesh import MeshSpec

    errs = {}
    g = torch.Generator(device=dev).manual_seed(13)
    L, N, ps, hd, P, Kw = 2, 96, 64, 128, 16, 4
    lengths = [0, 1, 64, 300, 700, 1000]
    lower = [0, 0, 10, 200, 0, 900]
    B = len(lengths)
    i32 = dict(dtype=torch.int32, device=dev)
    for tp in TP_SIZES:
        H, KV = 32 // tp, 8 // tp
        mesh = MeshSpec(model=tp).view(tp - 1)
        for dt, tol, rtol in DTYPE_TOLS:
            dtype = getattr(torch, dt)
            dec_route, pf_route = {"float32": ("f32", "f32"),
                                   "bfloat16": ("bf16_mma", "bf16"),
                                   "float16": ("f16_mma", "f16")}[dt]
            kp = torch.randn(L, N, KV, ps, hd, generator=g,
                             device=dev).to(dtype)
            vp = torch.randn(L, N, KV, ps, hd, generator=g,
                             device=dev).to(dtype)
            q = torch.randn(B, H, hd, generator=g, device=dev).to(dtype)
            table = torch.stack([torch.randperm(N - 1, generator=g,
                                                device=dev)[:P] + 1
                                 for _ in range(B)]).to(torch.int32)
            ln = torch.tensor(lengths, **i32)
            lo = torch.tensor(lower, **i32)
            ops.reset_launch_counts()
            calls = 0
            got = ops.paged_attention_decode_sharded(
                q, kp, vp, 1, table, ln, mesh=mesh, kv_heads=8,
                return_stats=True, softcap=30.0, lower=lo)
            calls += 1
            torch.cuda.synchronize()
            want = decode_reference(q, kp, vp, 1, table, ln, lo, hd ** -0.5,
                                    30.0)
            rel = ((got[2] - want[2]).abs()
                   / want[2].abs().clamp(min=1.0)).max().item()
            if (excess(got[0], want[0], tol, rtol) > 0 or rel > 1e-4
                    or max_err(got[1], want[1]) > 1e-4):
                fail(f"sharded decode tp={tp} {dt}: out "
                     f"{max_err(got[0], want[0]):.3g}, l rel {rel:.3g}")
            e = max_err(got[0], want[0])
            start = torch.tensor([n - 1 if n else -1 for n in lengths], **i32)
            wk = torch.randn(B, Kw, KV, hd, generator=g, device=dev).to(dtype)
            wv = torch.randn(B, Kw, KV, hd, generator=g, device=dev).to(dtype)
            for n_win in range(1, Kw + 1):
                qp = (start.clamp(min=0) + n_win - 1).to(torch.int32)
                eff = torch.full((B,), 100, **i32) if n_win == Kw else None
                out = ops.paged_attention_decode_window_sharded(
                    q, kp, vp, 0, table, start, qp, wk, wv, n_win, mesh=mesh,
                    kv_heads=8, eff_win=eff)
                calls += 1
                torch.cuda.synchronize()
                ref = window_reference(q, kp, vp, 0, table, start, qp, wk,
                                       wv, n_win, hd ** -0.5, None, eff)
                if excess(out, ref, tol, rtol) > 0:
                    fail(f"sharded decode window tp={tp} {dt} n_win={n_win}:"
                         f" max abs err {max_err(out, ref):.3g}")
                e = max(e, max_err(out, ref))
            routes = dict(ops.DECODE_ROUTE_LAUNCHES)
            if (ops.LAUNCHES["paged_attention_decode"] != calls
                    or routes[dec_route] != calls):
                fail(f"sharded decode tp={tp} {dt}: {calls} calls, counts "
                     f"{ops.LAUNCHES}, routes {routes}")
            errs[(f"decode-tp{tp}", dt)] = e
            # prefill: a first chunk of 512 and a 256-token second chunk
            pos = torch.full((2, 512), -1, dtype=torch.int32)
            pos[0] = torch.arange(512)
            pos[1, :256] = torch.arange(512, 768)
            qf = torch.randn(2, 512, H, hd, generator=g,
                             device=dev).to(dtype)
            pt = table[:2].contiguous()
            w = torch.tensor([NO_WINDOW, 300], **i32)
            out = ops.paged_attention_prefill_sharded(
                qf, kp[0], vp[0], pt, pos.to(dev), mesh=mesh, kv_heads=8,
                softcap=20.0, eff_win=w)
            torch.cuda.synchronize()
            ref = prefill_reference(qf, kp[0], vp[0], pt, pos.to(dev),
                                    hd ** -0.5, 20.0, w)
            if excess(out, ref, tol, rtol) > 0:
                fail(f"sharded prefill tp={tp} {dt}: max abs err "
                     f"{max_err(out, ref):.3g}")
            if ops.PREFILL_ROUTE_LAUNCHES[pf_route] != 1:
                fail(f"sharded prefill tp={tp} {dt}: counts {ops.LAUNCHES}"
                     f", routes {ops.PREFILL_ROUTE_LAUNCHES}")
            errs[(f"prefill-tp{tp}", dt)] = max_err(out, ref)
    for (name, dt), e in sorted(errs.items()):
        log(f"  {name:12s} {dt:8s} max_abs_err {e:.3g}")
    return errs


def time_local_shapes(dev, ecfg, served) -> dict:
    """The two tensor-parallel wrappers timed at the heads one rank holds
    of the 8B widths at tp = 2, 4 and 8 (32/tp q heads, 8/tp kv heads) at
    the served shapes: the served 4-row window (its contexts from phase
    4) and a first chunk of 512; the decode also at tp=1's full heads
    (the plain wrapper) on the same window, for a comparison within this
    phase, and at tp=8's heads on the long-row guard (8 rows of 3,968
    positions). Each decode result names the cluster of splits per (row,
    kv head) that the launch plan picks and each row's live splits.
    Keyed by tp."""
    import torch

    from dynamo_tpu_torch.parallel.mesh import MeshSpec

    g = torch.Generator(device=dev).manual_seed(17)
    N, ps, hd = ecfg.num_pages, ecfg.page_size, 128
    ctx = served["decode_lengths"]
    B = ecfg.bucket_batch(len(ctx))
    P = ecfg.bucket_pages(max(-(-n // ps) for n in ctx))
    long_ctx = [3968] * 8
    out = {}
    for tp in (1,) + TP_SIZES:
        mesh = MeshSpec(model=tp).view(0) if tp > 1 else None
        H, KV = 32 // tp, 8 // tp
        kp = torch.randn(1, N, KV, ps, hd, generator=g,
                         device=dev).to(torch.bfloat16)
        vp = torch.randn(1, N, KV, ps, hd, generator=g,
                         device=dev).to(torch.bfloat16)
        out[tp] = {"decode": time_decode(kp, vp, ctx, B, P,
                                         ecfg.decode_steps, H, g, mesh=mesh)}
        if mesh is not None:
            out[tp]["prefill"] = time_prefill(
                kp[0], vp[0], ecfg, 0, ecfg.prefill_chunk, H, g, mesh=mesh)
        if tp == 8:
            out[tp]["decode_long8"] = time_decode(
                kp, vp, long_ctx, ecfg.bucket_batch(len(long_ctx)),
                ecfg.bucket_pages(-(-long_ctx[0] // ps)), ecfg.decode_steps,
                H, g, mesh=mesh)
        for name, r in out[tp].items():
            log(f"  tp={tp} ({H} q heads, {KV} kv heads) {name}: "
                f"{r['ms']:.4f} ms on the device (bound {r['bound_ms']:.5f}"
                f" ms by {r['bound_by']}; plain {r['plain_ms']:.4f} ms; SDPA"
                f" {r['library_ms']:.4f} ms)"
                + (f"; a cluster of {r['splits']} splits per (row, kv head)"
                   f", live splits per row {r['live_splits']}"
                   if "splits" in r else ""))
    base = out[1]["decode"]["ms"]
    for tp in TP_SIZES:
        r = out[tp]["decode"]
        log(f"  served window at tp={tp}'s heads: {r['ms']:.4f} ms, "
            f"{'at or below' if r['ms'] <= r['library_ms'] else 'ABOVE'} "
            f"SDPA's {r['library_ms']:.4f} ms and "
            f"{'at or below' if r['ms'] <= 1.05 * base else 'ABOVE'} 1.05 x "
            f"tp=1's {base:.4f} ms")
    return out


def tp_worker(rank: int, coordinator: str, out_dir: str,
              int8_ckpt: str = None) -> None:
    """One rank of the tensor-parallel check (a process of its own): an
    engine of model=TP_RANKS on the 8B weights of seed 0 (this rank's
    shard), its plain variant warmed as the launcher warms it; then :func:`path_run` on its
    shards (eager), :func:`check_graph_window` and
    :func:`check_graph_prefill` (its replayed window and chunks, NCCL
    collectives inside, against the same calls made eagerly on this
    rank; each fails the rank on a difference) and :func:`collective_ms`.
    Every rank makes the same calls in the same order, so their
    collectives pair up. The results go to ``out_dir``. With
    ``int8_ckpt`` (the int8 mode, :func:`check_tp_int8`): the rank's
    shard of that checkpoint loaded with quant="int8" must equal, param
    by param and bitwise, the rank's weights of an int8 engine of seed 0
    (each param drawn whole, quantized whole, then cut); then
    :func:`path_run` on the loaded shard."""
    import torch

    from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.parallel.mesh import MeshSpec, initialize_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_multihost(coordinator, TP_RANKS, rank)
    mesh = MeshSpec(model=TP_RANKS).build("cuda")
    cfg = ModelConfig.llama3_8b()
    if int8_ckpt:
        from dynamo_tpu_torch.models.loader import load_params

        drawn = TorchEngine(cfg, EngineConfig(warmup_logprobs=False),
                            seed=0, mesh=mesh, quant="int8").params
        t = time.monotonic()
        loaded = load_params(int8_ckpt, cfg, mesh.device, rank=rank,
                             size=TP_RANKS, quant="int8")
        load_s = time.monotonic() - t
        unequal = sorted(k for k in drawn if k not in loaded
                         or not same_param(loaded[k], drawn[k]))
        if unequal or set(loaded) != set(drawn):
            fail(f"tp int8 rank {rank}: loaded shards differ from the cut "
                 f"of tp=1's: {unequal}")
        del drawn
        torch.cuda.empty_cache()
        logits, steps, _ = path_run(loaded, cfg, mesh.device, True,
                                    mesh=mesh)
        torch.save({"prefill": logits.cpu(), "steps": steps.cpu(),
                    "keys_equal": len(loaded), "load_s": load_s},
                   os.path.join(out_dir, f"tp_int8_rank{rank}.pt"))
        log(f"tp int8 worker {rank}: done")
        return
    # the plain variant alone: the rank checks no logprobs window, and at
    # tp=2 on one card each warm call's collectives cost ~1 s a window;
    # batches up to 8, the largest bucket its checks replay (a window of
    # 4 rows, a prefill batch of 8) and the chunk lengths they replay (64
    # and 512: the length-16 graphs are never replayed here)
    engine = TorchEngine(cfg, EngineConfig(max_batch=8,
                                           warmup_logprobs=False,
                                           prefill_buckets=(64, 512)),
                         seed=0, mesh=mesh)
    engine.warmup()
    dev = mesh.device
    logits, steps, _ = path_run(engine.params, cfg, dev, True, mesh=mesh)
    window = check_graph_window(engine, cfg, dev)
    prefill = check_graph_prefill(engine, dev)
    torch.save({"prefill": logits.cpu(), "steps": steps.cpu(),
                "graph_window": window, "graph_prefill": prefill,
                "collective_ms": collective_ms(mesh)},
               os.path.join(out_dir, f"tp_rank{rank}.pt"))
    log(f"tp worker {rank}: done")


def collective_ms(mesh) -> dict:
    """Host wall per all-reduce of one decode step's hidden row
    ([4, 4096] bf16) over the mesh: 50 eager calls, and a CUDA graph of a
    window's 264 (4 steps x (1 + 2 x 32 + 1)) replayed 3 times; and
    whether every call gave the sum over the ranks. Call i reduces a
    buffer of its own, filled from the rank's input plus i % 32 (a small
    kernel before each call, in the graph too), and the input changes
    before each replay (rank r holds base x (r + 1) x (replay + 1), base
    0..4) with the buffers zeroed: a replay that returned a stale sum or
    left out a rank's part shows. Every value is an integer below 256,
    exact in bf16."""
    import torch

    n, dev = 264, mesh.device
    shares = mesh.model * (mesh.model + 1) // 2  # sum of (r + 1) over ranks
    base = (torch.arange(4 * 4096, device=dev) % 5).view(4, 4096).float()
    src = torch.empty(4, 4096, dtype=torch.bfloat16, device=dev)
    bufs = torch.zeros((n, 4, 4096), dtype=torch.bfloat16, device=dev)
    off = (torch.arange(n, device=dev) % 32).view(n, 1, 1).float()

    def reduce(k):
        for i in range(k):
            torch.add(src, i % 32, out=bufs[i])
            mesh.all_reduce(bufs[i])

    def exact(k, rep):
        want = base * (shares * (rep + 1)) + mesh.model * off[:k]
        return bool(torch.equal(bufs[:k].float(), want))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        src.copy_(base * (mesh.model_rank + 1))
        reduce(3)
        bufs.zero_()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        reduce(50)
        torch.cuda.synchronize()
        eager = (time.monotonic() - t0) / 50 * 1e3
        exact_eager = exact(50, 0)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            reduce(n)
        replayed, exact_replays = 0.0, []
        for rep in range(3):
            src.copy_(base * ((mesh.model_rank + 1) * (rep + 1)))
            bufs.zero_()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            graph.replay()
            torch.cuda.synchronize()
            replayed += time.monotonic() - t0
            exact_replays.append(exact(n, rep))
    return {"eager": eager, "replayed": replayed / (3 * n) * 1e3,
            "sums_exact": {"eager": exact_eager, "replays": exact_replays}}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(rank: int, ranks: int = TP_RANKS) -> dict:
    """The environment of rank ``rank`` of ``ranks``: where ranks share a
    card, its own NCCL host id (the launcher's shared_device_env)."""
    import torch

    from dynamo_tpu_torch.run import shared_device_env

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env.update(shared_device_env(rank, ranks, torch.cuda.device_count()))
    return env


def _run_ranks(cmds, logs, limit: float, until=None, rank_env=True):
    """Start one process per command (in rank r's environment unless
    ``rank_env`` is False), call ``until(procs)`` if given, then wait for
    every process up to ``limit`` seconds in all, or until one exits
    with an error (the others would wait on it in a collective); every
    process, and what it started, is killed at the end whatever happens.
    Returns the exit codes."""
    procs = []
    t0 = time.monotonic()
    try:
        for r, (cmd, path) in enumerate(zip(cmds, logs)):
            env = _rank_env(r, len(cmds))
            if not rank_env:
                env = {k: v for k, v in env.items()
                       if not k.startswith("NCCL_")}
            with open(path, "w") as f:
                procs.append(subprocess.Popen(
                    cmd, env=env, cwd=REPO, stdout=f,
                    stderr=subprocess.STDOUT, start_new_session=True))
        if until is not None:
            until(procs)
        while time.monotonic() - t0 < limit:
            rcs = [p.poll() for p in procs]
            if any(rcs) or all(rc is not None for rc in rcs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            try:  # ranks the process started itself
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    return [p.returncode for p in procs]


def _tail(path: str, n: int = 3000) -> str:
    with open(path) as f:
        return f.read()[-n:]


def check_tp_logits(reference, out_dir: str) -> dict:
    """Two ranks of :func:`tp_worker` on the one card against the tp=1
    reference (check_paths' kernel path, same weights and inputs):
    prefill logits and every teacher-forced window step's logits within
    PATH_LIMITS (the bf16 noise budget of 32 layers that the kernel path
    keeps against the plain path); the ranks' logits bitwise equal (each
    holds the gathered logits); argmax equal to tp=1's wherever tp=1's
    top-2 margin exceeds that limit (random weights make near-ties
    common: elsewhere bf16 rounding may swap the top two). Each rank's
    replayed decode window and prefill chunks must have matched its
    eager calls (tokens, emitted counts and carry identical, window K/V
    within bf16 tolerance, chunk logits, draws and pools bitwise), with
    the same tokens and draws on both ranks, and every eager and
    replayed all-reduce of :func:`collective_ms` must give the exact
    sum."""
    import torch

    coordinator = f"127.0.0.1:{_free_port()}"
    cmds = [[sys.executable, os.path.join(REPO, "chip_smoke.py"),
             "--tp-worker", str(r), "--tp-coordinator", coordinator,
             "--tp-dir", out_dir] for r in range(TP_RANKS)]
    logs = [os.path.join(out_dir, f"tp_logits_rank{r}.log")
            for r in range(TP_RANKS)]
    t0 = time.monotonic()
    rcs = _run_ranks(cmds, logs, 480)
    # a rank that failed first, before one killed after it
    for r in sorted(range(TP_RANKS), key=lambda r: rcs[r] is None
                    or rcs[r] < 0):
        if rcs[r] != 0:
            fail(f"tp logits rank {r} exited {rcs[r]}:\n{_tail(logs[r])}")
    got = [torch.load(os.path.join(out_dir, f"tp_rank{r}.pt"))
           for r in range(TP_RANKS)]
    for r in range(1, TP_RANKS):
        if not all(torch.equal(got[0][k], got[r][k])
                   for k in ("prefill", "steps")):
            fail(f"tp rank {r}'s logits differ from rank 0's")
    graphs = []
    for r, g in enumerate(got):
        gw, gp = g["graph_window"], g["graph_prefill"]
        sums = g["collective_ms"]["sums_exact"]
        same = {"window": gw["toks"] and gw["emitted"] and gw["carry"],
                **{f"prefill {k}": c["sampled"] and c["logits"] and c["kv"]
                   for k, c in gp.items()},
                "all_reduce sums": sums["eager"] and all(sums["replays"])}
        graphs.append({"rank": r, **same,
                       "window_kv_bitwise": gw["kv_bitwise"],
                       "window_kv_max_abs_err": gw["kv_max_abs_err"]})
        if not all(same.values()):
            fail(f"tp rank {r}: graph replay or collective differs: {same}")
        if r and (gw["tokens"] != got[0]["graph_window"]["tokens"]
                  or any(c["sampled"] != got[0]["graph_prefill"][k]["sampled"]
                         for k, c in gp.items())):
            fail(f"tp rank {r}'s replayed tokens differ from rank 0's")
    result = {"collective_ms": [g["collective_ms"] for g in got],
              "graph_replay_vs_eager": graphs,
              **compare_tp_logits(got[0], reference),
              "seconds": time.monotonic() - t0}
    log(f"  tp=2 vs tp=1 logits, tp=2 replays vs eager: "
        f"{json.dumps(result)}")
    return result


def compare_tp_logits(got: dict, reference, what: str = "tp=2") -> dict:
    """A tp=2 rank's prefill and window-step logits (``got``) against the
    tp=1 reference (check_paths' kernel path, same weights and inputs):
    within PATH_LIMITS, and the same argmax wherever tp=1's top-2 margin
    exceeds that limit (random weights make near-ties common: elsewhere
    bf16 rounding may swap the top two)."""
    import torch

    want_pf, want_steps = reference
    err = {"prefill_logits": max_err(got["prefill"], want_pf),
           "window_logits_by_step": [max_err(a, b) for a, b in
                                     zip(got["steps"], want_steps)]}
    err["window_logits"] = max(err["window_logits_by_step"])
    # top-2 margins of the tp=1 logits, every (step, row); the prefill's
    # first tokens first
    ref = torch.cat([want_pf[None], want_steps])
    tp2 = torch.cat([got["prefill"][None], got["steps"]])
    top2 = ref.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    decided = margin > PATH_LIMITS["window_logits"]
    same = ref.argmax(-1) == tp2.argmax(-1)
    for key in ("prefill_logits", "window_logits"):
        if err[key] > PATH_LIMITS[key]:
            fail(f"{what} {key} differ from tp=1 by {err[key]:.4g} > "
                 f"{PATH_LIMITS[key]}")
    if not bool(same[decided].all()):
        fail(f"{what} argmax differs from tp=1 where tp=1's top-2 margin "
             f"exceeds {PATH_LIMITS['window_logits']}")
    return {**err, "limits": {k: PATH_LIMITS[k] for k in
                              ("prefill_logits", "window_logits")},
            "argmax_checked": int(decided.sum()),
            "argmax_of": int(decided.numel()),
            "argmax_equal_all": int(same.sum()),
            "tp1_top2_margins": [round(float(m), 4)
                                 for m in margin.flatten()]}


async def _serve_remote(base: str, name: str) -> dict:
    """Phase 4's four concurrent requests against a server at ``base``
    (two streaming chats, one unary chat, one completion): each must
    answer 200 and finish by length or stop."""
    import aiohttp

    long_prompt = ("The quick brown fox jumps over the lazy dog. " * 14)[:600]

    async def chat(s, content, max_tokens, stream):
        body = {"model": name, "stream": stream, "max_tokens": max_tokens,
                "messages": [{"role": "user", "content": content}]}
        async with s.post(f"{base}/v1/chat/completions", json=body) as r:
            if r.status != 200:
                fail(f"tp serve: HTTP {r.status}: {await r.text()}")
            if not stream:
                return (await r.json())["choices"][0]["finish_reason"]
            lines = [ln.decode().strip() async for ln in r.content]
            data = [ln[6:] for ln in lines if ln.startswith("data: ")]
            if data[-1] != "[DONE]":
                fail("tp serve: stream did not end with [DONE]")
            fin = [c["finish_reason"] for d in data[:-1]
                   for c in json.loads(d)["choices"] if c.get("finish_reason")]
            return fin[-1] if fin else None

    async def completion(s, prompt, max_tokens):
        async with s.post(f"{base}/v1/completions", json={
                "model": name, "prompt": prompt,
                "max_tokens": max_tokens}) as r:
            if r.status != 200:
                fail(f"tp serve: HTTP {r.status}: {await r.text()}")
            return (await r.json())["choices"][0]["finish_reason"]

    async with aiohttp.ClientSession() as s:
        t0 = time.monotonic()
        fins = await asyncio.gather(
            chat(s, "Tell me about paged attention.", 32, True),
            chat(s, long_prompt, 32, True),
            chat(s, "What is an H100?", 24, False),
            completion(s, "Once upon a time", 24))
        wall = time.monotonic() - t0
    if any(f not in ("length", "stop") for f in fins):
        fail(f"tp serve: finish reasons {fins}")
    return {"finish_reasons": fins, "wall_s": wall}


def staggered(first, then, logs, ranks: int, limit: float = 300) -> list:
    """``first`` and ``then`` (each ``(fn, *args)``) in threads of their
    own, ``then`` started once every rank of ``first`` has logged
    ``warming up`` in ``logs`` (the launcher's line once its engine is
    built), or once ``first`` has ended: the ranks of ``first`` then hold
    their weights and are warming up, past the peak of their start (a
    random draw holds a whole float32 param), and the card has room for
    the peaks of ``then``'s ranks beside them.
    Their results in order. A call that fails (``fail`` ends its thread)
    fails the script once both calls have ended: each kills the
    processes it started before it returns."""
    from concurrent.futures import ThreadPoolExecutor

    def warming() -> int:
        n = 0
        for path in logs:
            try:
                with open(path) as f:
                    n += f.read().count("; warming up")
            except OSError:
                pass
        return n

    with ThreadPoolExecutor(2) as ex:
        a = ex.submit(*first)
        t0 = time.monotonic()
        while not (a.done() or warming() >= ranks
                   or time.monotonic() - t0 > limit):
            time.sleep(0.5)
        b = ex.submit(*then)
        return [a.result(), b.result()]


def serve_logs(out_dir: str, name: str, ranks: int, one_command: bool):
    """The rank logs :func:`serve_launcher` writes for these arguments."""
    form = "one_command" if one_command or ranks == 1 else "coordinator"
    n = 1 if form == "one_command" else ranks
    return [os.path.join(out_dir, f"serve_{name}_{form}_{r}.log")
            for r in range(n)]


def serve_tp(cfg, out_dir: str, one_command: bool) -> dict:
    """The served tensor-parallel phase: two ranks of the launcher on the
    one card, in one of its two forms: one process per rank
    (``--tensor-parallel-size 2 --coordinator ... --process-id r``, each
    given its NCCL host id here), or one command that starts rank 1
    itself (``--tensor-parallel-size 2`` alone; it must set the NCCL host
    ids itself, and say so). The phase-4 requests go over HTTP to rank 0,
    then SIGTERM to rank 0, which stops rank 1 (:func:`serve_launcher`,
    whose checks of the ranks' serving summaries apply)."""
    return serve_launcher(cfg, out_dir, ["--model", "8b"], "llama3-8b-tp2",
                          TP_RANKS, one_command, _serve_remote)


# the launcher ranks' --max-batch-size in phase 7 (four requests at
# once: at 1 they go one at a time, and at tp=2 on one card each window's
# collectives cost ~2 s, more than the graphs of a batch of 4 cost to
# warm); phase 8's requests go one at a time, so its ranks take 1 (half
# the decode graphs and half the prefill graphs of 4)
LAUNCHER_MAX_BATCH = 4
CKPT_MAX_BATCH = 1
# the batch of an engine whose traffic is phase 4's (four rows at once at
# most): its grid stops at 8 rows, where the default's goes on to 64, and
# every bucket that traffic takes (decode 1..4 rows, prefill 1 or 8) is
# the default grid's, so it computes what the default engine computes
TRAFFIC_MAX_BATCH = 8


def serve_launcher(cfg, out_dir: str, model_args: list, name: str,
                   ranks: int, one_command: bool, requests,
                   max_batch: int = LAUNCHER_MAX_BATCH) -> dict:
    """``ranks`` ranks of the launcher (``model_args`` choose the weights)
    on the one card, in the one-command form or one process per rank;
    ``requests(base, name)`` drives rank 0 over HTTP, then SIGTERM to
    rank 0, which stops the others. The ranks take ``--max-batch-size``
    ``max_batch``, and each must print its ``engine ready`` line
    (kept in the report). Each rank's serving summary must
    show no capture after warmup, its mesh, every kernel call from a
    graph replay (prefill: one per layer of a replayed chunk; decode:
    one per layer and step of a replayed window), all attention calls on
    the bf16 routes (with a mesh the model calls the kernels only through
    the sharded wrappers), and the same counts on every rank. Each rank's
    ``checkpoint loaded`` line, when it prints one, is kept."""
    import urllib.request

    from dynamo_tpu_torch.engine.torch_engine import EngineConfig
    from dynamo_tpu_torch.ops import paged_attention as ops

    port = _free_port()
    # batches of up to 4 rows (the requests here are 4 at most): the ranks
    # warm 12 decode graphs where the default batch of 64 warms 28, and at
    # tp=2 on one card each warm call's collectives cost ~1 s a window
    base = [sys.executable, "-m", "dynamo_tpu_torch.run", "in=http",
            "out=torch", *model_args, "--model-name", name,
            "--tensor-parallel-size", str(ranks), "--max-batch-size",
            str(max_batch), "--http-host", "127.0.0.1",
            "--http-port", str(port)]
    form = "one_command" if one_command or ranks == 1 else "coordinator"
    if form == "one_command":
        cmds = [base]
    else:
        coordinator = f"127.0.0.1:{_free_port()}"
        cmds = [base + ["--coordinator", coordinator, "--num-processes",
                        str(ranks), "--process-id", str(r)]
                for r in range(ranks)]
    logs = [os.path.join(out_dir, f"serve_{name}_{form}_{r}.log")
            for r in range(len(cmds))]
    report = {"form": form, "ranks": ranks}

    def drive(procs):
        t0 = time.monotonic()
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                            timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            for i, p in enumerate(procs):
                if p.poll() is not None:
                    fail(f"tp process {i} exited {p.returncode} before "
                         f"serving:\n{_tail(logs[i])}")
            if time.monotonic() - t0 > 420:
                fail(f"tp ranks not serving after 420 s:\n{_tail(logs[0])}")
            time.sleep(1)
        report["start_s"] = time.monotonic() - t0
        report.update(asyncio.run(requests(f"http://127.0.0.1:{port}",
                                           name)))
        procs[0].send_signal(signal.SIGTERM)

    rcs = _run_ranks(cmds, logs, 600, until=drive,
                     rank_env=form != "one_command")
    summaries, loads, ready = {}, {}, {}
    for i, path in enumerate(logs):
        with open(path) as f:
            text = f.read()
        for line in text.splitlines():
            if "serving summary " in line:
                s = json.loads(line.split("serving summary ", 1)[1])
                summaries[s["rank"]] = s
            if "checkpoint loaded " in line:
                ld = json.loads(line.split("checkpoint loaded ", 1)[1])
                loads[ld["rank"]] = ld
            if "engine ready " in line:
                rd = json.loads(line.split("engine ready ", 1)[1])
                ready[rd["rank"]] = rd
        if rcs[i] != 0:
            fail(f"tp process {i} exited {rcs[i]}:\n{_tail(path)}")
        if (form == "one_command" and ranks > 1
                and "each rank gets its own NCCL_HOSTID" not in text):
            fail(f"the one-command launcher did not set the ranks' NCCL "
                 f"host ids:\n{_tail(path)}")
    report["loads"] = loads
    # where each rank's start went (the launcher's engine-ready line)
    report["ready"] = ready
    if sorted(ready) != list(range(ranks)) or any(
            rd["max_batch"] != max_batch for rd in ready.values()):
        fail(f"engine-ready lines of ranks {sorted(ready)}: "
             f"{json.dumps(ready)}")
    if sorted(summaries) != list(range(ranks)):
        fail(f"tp serving summaries of ranks {sorted(summaries)}:\n"
             f"{_tail(logs[0])}")
    L, K = cfg.num_layers, EngineConfig().decode_steps
    for r, s in summaries.items():
        pf, win = s["replays"]["prefill"], s["replays"]["decode_window"]
        lc = s["launches"]
        problems = []
        if s["post_warmup_compiles_total"] != 0:
            problems.append("captures after warmup")
        if s["mesh_shape"] != (f"model={ranks}" if ranks > 1 else "single"):
            problems.append(f"mesh_shape {s['mesh_shape']}")
        if pf <= 0 or win <= 0:
            problems.append("no replay")
        if (lc["paged_attention_prefill"] != pf * L
                or lc["paged_attention_decode"] != win * L * K):
            problems.append("launches are not the replays'")
        if s["route_launches"] != only(ops.DECODE_ROUTES, "bf16_mma",
                                       lc["paged_attention_decode"]):
            problems.append(f"decode routes {s['route_launches']}")
        if s["prefill_route_launches"] != only(
                ops.PREFILL_ROUTES, "bf16", lc["paged_attention_prefill"]):
            problems.append(f"prefill routes {s['prefill_route_launches']}")
        if problems:
            fail(f"tp rank {r}: {problems}: {json.dumps(s)}")
    first = {k: v for k, v in summaries[0].items() if k != "rank"}
    for r in range(1, ranks):
        if {k: v for k, v in summaries[r].items() if k != "rank"} != first:
            fail(f"tp rank {r}'s summary differs from rank 0's: "
                 f"{json.dumps(summaries[r])} vs {json.dumps(summaries[0])}")
    report["summaries"] = summaries
    log(f"  {name} served by {ranks} launcher rank(s), {form} form (ranks "
        f"sharing one card: not a TP speed): {json.dumps(report)}")
    return report


# ------------------------------------------- checkpoint and penalties


def check_warmed(engine, decode_variants, prefill_variants) -> None:
    """Every bucket of the warmed grid captured in each of the variants
    warmup() was to warm, and no other variant made; logs each set's
    capture time and the graph pool it added."""
    grid = engine.ecfg.warmed_grid()
    ps = engine.ecfg.page_size
    want_d = {(B, P) for B in grid["decode_batches"]
              for P in grid["page_buckets"]}
    want_p = {(B, T, P, T % ps == 0) for B in grid["prefill_batches"]
              for T in grid["prefill_lens"] for P in grid["page_buckets"]}
    if (sorted(engine.decode_variants) != sorted(decode_variants)
            or sorted(engine.prefill_variants) != sorted(prefill_variants)):
        fail(f"warmed variants {sorted(engine.decode_variants)} / "
             f"{sorted(engine.prefill_variants)}, expected "
             f"{sorted(decode_variants)} / {sorted(prefill_variants)}")
    for gs, want in ([(g, want_d) for g in engine.decode_variants.values()]
                     + [(g, want_p)
                        for g in engine.prefill_variants.values()]):
        got = {k for k, bk in gs.buckets.items() if bk.graph is not None}
        log(f"  {len(got)} {gs.kind} graphs ({gs.variant}) captured in "
            f"{gs.capture_seconds:.1f}s (warm call + capture each), "
            f"graph pool +{gs.pool_bytes / 2**20:.0f} MiB")
        if got != want or len(gs.buckets) != len(want):
            fail(f"{gs.kind} graphs ({gs.variant}) captured {sorted(got)} "
                 f"!= the warmed grid {sorted(want)}")


def hf_tensors(params, cfg) -> list:
    """(HF name, tensor in the HF layout) of every param: projections
    back to ``[out, in]``, the stacked layers one by one (the inverse of
    ``models/loader.py``)."""
    out = [("model.embed_tokens.weight", params["embed"]),
           ("model.norm.weight", params["ln_final"])]
    if "lm_head" in params:
        out.append(("lm_head.weight", params["lm_head"].T))
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        out += [(pre + "input_layernorm.weight", params["ln_attn"][i]),
                (pre + "post_attention_layernorm.weight",
                 params["ln_mlp"][i])]
        for key, proj in (("wq", "q_proj"), ("wk", "k_proj"),
                          ("wv", "v_proj"), ("wo", "o_proj")):
            out.append((pre + f"self_attn.{proj}.weight", params[key][i].T))
        for key, proj in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                          ("w_down", "down_proj")):
            out.append((pre + f"mlp.{proj}.weight", params[key][i].T))
    return out


def write_checkpoint(params, cfg, path: str, shards: int = 4) -> int:
    """The params as a BF16 HF-layout checkpoint under ``path``: ``shards``
    ``model-0000k-of-0000n.safetensors`` files of about equal size (each
    an 8-byte little-endian header length, the JSON header padded to 8
    bytes, then the raw little-endian tensors), their
    ``model.safetensors.index.json`` and a Llama ``config.json``; no
    tokenizer files. Returns the bytes of tensor data."""
    import torch

    tensors = hf_tensors(params, cfg)
    sizes = [t.numel() * 2 for _, t in tensors]
    total, per, groups, acc = sum(sizes), sum(sizes) / shards, [[]], 0
    for item, n in zip(tensors, sizes):
        if acc >= per * len(groups) and len(groups) < shards:
            groups.append([])
        groups[-1].append(item)
        acc += n
    weight_map = {}
    for k, group in enumerate(groups):
        fname = f"model-{k + 1:05d}-of-{len(groups):05d}.safetensors"
        header, at = {"__metadata__": {"format": "pt"}}, 0
        for name, t in group:
            n = t.numel() * 2
            header[name] = {"dtype": "BF16", "shape": list(t.shape),
                            "data_offsets": [at, at + n]}
            at += n
            weight_map[name] = fname
        head = json.dumps(header).encode()
        head += b" " * (-len(head) % 8)
        with open(os.path.join(path, fname), "wb") as f:
            f.write(len(head).to_bytes(8, "little"))
            f.write(head)
            for _, t in group:
                host = t.to(torch.bfloat16).contiguous().cpu()
                f.write(host.view(torch.uint8).numpy().data)
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
            "tie_word_embeddings": cfg.tie_word_embeddings,
            "max_position_embeddings": 8192, "torch_dtype": "bfloat16"}, f)
    return total


def compare_solo(got: list, ref: list) -> None:
    """Served SOLO results equal to the reference's: text, finish, every
    token's logprob and top values, bitwise (the same weights and
    kernels give the same tokens)."""
    for i, (g, r) in enumerate(zip(got, ref)):
        if g != r:
            fail(f"request {i} ({SOLO[i][0]}) differs from phase 4's: "
                 f"{json.dumps(g)[:600]} vs {json.dumps(r)[:600]}")
    if len(got) != len(ref):
        fail(f"{len(got)} results for {len(ref)} requests")


def compare_tp_solo(got: list, ref_tap: dict) -> dict:
    """tp=2's SOLO results against tp=1's (phase 4, by token id). The
    byte tokenizer decodes ids past 255 to nothing, so tp=2's tokens show
    only through their logprobs: a step whose tp=1 top-2 margin exceeds
    twice TP_LOGPROB_LIMIT has one greedy token at any rounding within
    the limit, so there tp=2's token must be tp=1's, which its logprob
    shows (a different token's would lie more than the limit below);
    past the first closer step the two may part, and are not compared.
    Returns the steps compared."""
    compared = []
    for i, (g, rid) in enumerate(zip(got, sorted(ref_tap))):
        ref = ref_tap[rid]["logprobs"]
        n = 0
        for j, (lp1, tops) in enumerate(ref):
            vals = sorted(tops.values(), reverse=True)
            if len(vals) < 2 or vals[0] - vals[1] <= 2 * TP_LOGPROB_LIMIT:
                break
            if j >= len(g["lp"]):
                fail(f"tp=2 request {i} ended at step {j} where tp=1 "
                     f"goes on with a margin of {vals[0] - vals[1]:.3f}")
            if abs(g["lp"][j] - lp1) > TP_LOGPROB_LIMIT:
                fail(f"tp=2 request {i} step {j}: logprob {g['lp'][j]:.4f} "
                     f"vs tp=1's {lp1:.4f} (margin {vals[0] - vals[1]:.3f}):"
                     f" another token")
            n += 1
        compared.append(n)
    return {"steps_compared": compared,
            "steps": [len(g["lp"]) for g in got]}


TEACHER_STEPS = 8


async def tp_teacher_forced(base: str, name: str, ref_tap: dict) -> dict:
    """tp=2 along tp=1's greedy path: for the first TEACHER_STEPS tokens
    of each SOLO request (phase 4, by token id), a completion of one
    greedy token from the prompt's ids and tp=1's tokens before the
    step, with logprobs. Its token's logprob, the maximum of tp=2's
    distribution, must be within TP_LOGPROB_LIMIT of tp=1's top-1
    logprob at every step, and where tp=1's top-2 margin exceeds twice
    the limit, that token is tp=1's (compare_tp_solo's argument)."""
    import aiohttp

    worst, steps, decided = 0.0, 0, 0
    async with aiohttp.ClientSession() as s:
        for rid in sorted(ref_tap):
            ref = ref_tap[rid]
            for j, (lp1, tops) in enumerate(
                    ref["logprobs"][:TEACHER_STEPS]):
                body = {"model": name, "max_tokens": 1, "logprobs": 1,
                        "prompt": ref["prompt_ids"] + ref["tokens"][:j]}
                async with s.post(f"{base}/v1/completions", json=body) as r:
                    if r.status != 200:
                        fail(f"teacher-forced {rid} step {j}: HTTP "
                             f"{r.status}: {await r.text()}")
                    lp2 = (await r.json())["choices"][0]["logprobs"][
                        "token_logprobs"][0]
                top1 = max(tops.values())
                worst = max(worst, abs(lp2 - top1))
                if abs(lp2 - top1) > TP_LOGPROB_LIMIT:
                    fail(f"teacher-forced {rid} step {j}: tp=2's greedy "
                         f"logprob {lp2:.4f} vs tp=1's top-1 {top1:.4f}")
                vals = sorted(tops.values(), reverse=True)
                decided += vals[0] - vals[1] > 2 * TP_LOGPROB_LIMIT
                steps += 1
    return {"teacher_forced": {"steps": steps, "token_decided": decided,
                               "max_abs_err": worst}}


def checkpoint_phase(cfg, dev, ckpt_dir: str, solo_ref,
                     int8_logits) -> tuple:
    """Phase 8: the seed-0 8B weights (as the engine draws them) written
    as a BF16 HF checkpoint in four shards; loaded here by
    ``models/loader.py`` (timed) and held bitwise against the seed-0
    params, its config equal to the preset's; then served by the
    launcher with ``--model-path`` at tp=1, whose SOLO results must equal
    phase 4's bitwise, and at tp=2 (two ranks, each loading its shard),
    held against tp=1's (compare_tp_solo). Then loaded with
    quant="int8": at tp=1 bitwise ``quantize_int8`` of the seed-0 params
    on the card, and at tp=2 (:func:`check_tp_int8`) each rank's shard
    bitwise the cut of tp=1's, with logits within tp=1 int8's limits
    (``int8_logits``, phase 10's). Returns (report, the loaded
    params)."""
    import torch

    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.models.llama import init_params
    from dynamo_tpu_torch.models.loader import load_params
    from dynamo_tpu_torch.models.quant import quantize_params
    from dynamo_tpu_torch.run import peak_rss_gib

    report = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    t = time.monotonic()
    nbytes = write_checkpoint(params, cfg, ckpt_dir)
    report["write_s"] = time.monotonic() - t
    report["bytes"] = nbytes
    report["files"] = sorted(os.listdir(ckpt_dir))
    if ModelConfig.from_local_path(ckpt_dir) != cfg:
        fail(f"the checkpoint's config {ModelConfig.from_local_path(ckpt_dir)}"
             f" is not the preset's {cfg}")
    torch.cuda.synchronize()
    rss0 = peak_rss_gib()
    t = time.monotonic()
    loaded = load_params(ckpt_dir, device=dev)
    seconds = time.monotonic() - t
    report["load"] = {
        "seconds": seconds, "gb_per_s": nbytes / 1e9 / seconds,
        "peak_rss_gib_before": rss0, "peak_rss_gib_after": peak_rss_gib()}
    unequal = sorted(k for k in params
                     if k not in loaded or not torch.equal(params[k],
                                                           loaded[k]))
    if unequal or set(loaded) != set(params):
        fail(f"loaded params differ from the seed-0 params: {unequal}")
    report["bitwise_equal_keys"] = len(params)
    del params
    torch.cuda.empty_cache()
    log(f"  wrote {nbytes / 1e9:.2f} GB in {report['write_s']:.1f}s; loaded "
        f"in {seconds:.2f}s ({report['load']['gb_per_s']:.2f} GB/s), "
        f"bitwise equal to the seed-0 params ({len(loaded)} tensors); "
        f"{json.dumps(report)}")

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_logs_")
    try:
        async def requests(base, name):
            out = {"solo": await solo_logprobs(base, name, "ckpt")}
            if not name.endswith("tp1"):
                out.update(await tp_teacher_forced(base, name,
                                                   solo_ref["tap"]))
            return out

        # tp=1 and tp=2 side by side, tp=2 started once tp=1 warms up:
        # three ranks on the card
        served = staggered(*(
            (serve_launcher, cfg, out_dir, ["--model-path", ckpt_dir],
             f"llama3-8b-ckpt-tp{ranks}", ranks, False, requests,
             CKPT_MAX_BATCH)
            for ranks in (1, TP_RANKS)),
            serve_logs(out_dir, "llama3-8b-ckpt-tp1", 1, False), 1)
        for ranks, res in zip((1, TP_RANKS), served):
            if sorted(res["loads"]) != list(range(ranks)):
                fail(f"tp={ranks}: load lines of ranks "
                     f"{sorted(res['loads'])}")
            for r, ld in res["loads"].items():
                if abs(ld["bytes"] * ranks - nbytes) > nbytes * 0.02:
                    fail(f"tp={ranks} rank {r} loaded {ld['bytes']} bytes "
                         f"of {nbytes}: not its shard")
            if ranks == 1:
                compare_solo(res["solo"], solo_ref["http"])
            else:
                res["vs_tp1"] = compare_tp_solo(res["solo"], solo_ref["tap"])
            report[f"tp{ranks}"] = res
        t = time.monotonic()
        q8 = load_params(ckpt_dir, device=dev, quant="int8")
        load_s = time.monotonic() - t
        want = quantize_params(loaded)
        unequal = sorted(k for k in want if k not in q8
                         or not same_param(q8[k], want[k]))
        if unequal or set(q8) != set(want):
            fail(f"the int8 load differs from quantize_int8 of the seed-0 "
                 f"params: {unequal}")
        report["int8"] = {"tp1": {
            "load_s": load_s, "keys_equal": len(q8),
            "bytes": sum(v.nbytes for v in q8.values())}}
        del q8, want
        torch.cuda.empty_cache()
        log(f"  int8 load at tp=1 bitwise quantize_int8 of the seed-0 "
            f"params: {json.dumps(report['int8']['tp1'])}")
        report["int8"]["tp2"] = check_tp_int8(ckpt_dir, int8_logits, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return report, loaded


PENALTY_REQUESTS = [
    ("pen-rep", "Tell me about paged attention.", {"repetition_penalty": 2.0}),
    ("pen-freq", "What is an H100?", {"frequency_penalty": 1.5}),
    ("pen-pres", "Once upon a time", {"presence_penalty": 2.0}),
    ("pen-bias", "Tell me about paged attention.",
     {"logit_bias": {"1000": 100.0}}),
]


def plain_penalties(row, context: list, generated: list, kw: dict):
    """One row of logits [V] penalised from the definitions, on its own
    (not the port's ``apply_penalties``): HF's repetition penalty over
    every token of ``context`` (a positive logit divided by it, a
    negative one multiplied), then OpenAI's frequency and presence
    penalties over the ``generated`` tokens (``freq * count + pres``
    off each), then the logit_bias map added."""
    import collections

    import torch

    out = row.float().clone()
    rep = kw.get("repetition_penalty", 1.0)
    if rep != 1.0:
        ids = torch.tensor(sorted(set(context)), device=row.device)
        v = out[ids]
        out[ids] = torch.where(v > 0, v / rep, v * rep)
    counts = collections.Counter(generated)
    if counts:
        ids = torch.tensor(list(counts), device=row.device)
        n = torch.tensor(list(counts.values()), device=row.device,
                         dtype=torch.float32)
        out[ids] -= (kw.get("frequency_penalty", 0.0) * n
                     + kw.get("presence_penalty", 0.0))
    for t, b in (kw.get("logit_bias") or {}).items():
        out[int(t)] += b
    return out


def check_penalised_tokens(engine, cfg, dev, tap, rid, kw) -> dict:
    """A penalised greedy request's tokens against the plain path,
    teacher-forced with the served tokens, each step's logits penalised
    by :func:`plain_penalties` (the context and generated tokens before
    the step): at every step the served token's penalised
    logit must be within LOGPROB_LIMIT of the maximum (a penalty left out
    would let a repeated token win by its penalty, 1.5 to 2 here), and it
    must be the maximum wherever the top-2 margin exceeds twice the
    limit. Also counts the served tokens that repeat an earlier one."""
    import torch

    prompt, toks = tap.prompt_ids[rid], tap.tokens[rid]
    with torch.no_grad():
        logits = plain_logits(engine.params, cfg, dev,
                              prompt + toks[:-1])[len(prompt) - 1:]
        decided, worst = 0, 0.0
        for j, tok in enumerate(toks):
            pen = plain_penalties(logits[j], prompt + toks[:j], toks[:j], kw)
            top = torch.topk(pen, 2)
            short = float(top.values[0] - pen[tok])
            worst = max(worst, short)
            if short > LOGPROB_LIMIT:
                fail(f"{rid} step {j}: served token {tok}'s penalised logit "
                     f"is {short:.4f} below the plain path's maximum")
            if float(top.values[0] - top.values[1]) > 2 * LOGPROB_LIMIT:
                if int(top.indices[0]) != tok:
                    fail(f"{rid} step {j}: served token {tok}, the plain "
                         f"path's penalised argmax {int(top.indices[0])}")
                decided += 1
    return {"steps": len(toks), "decided": decided,
            "max_below_max": worst,
            "repeats": len(toks) - len(set(toks))}


def penalty_phase(cfg, dev, params) -> dict:
    """Phase 9: an engine on ``params`` warmed with warmup_penalties (no
    logprobs variants): the plain and the penalised window variants
    captured over every bucket; the penalised window's replay bitwise
    equal to its eager call, with the three penalties and with logit_bias
    alone (check_graph_window); then repetition,
    frequency and presence penalties and a logit_bias of +100 on token
    1000 served concurrently over HTTP: the biased request emits 1000 at
    every step, the others' greedy tokens agree with the plain path's
    penalised argmax (check_penalised_tokens), and nothing is captured
    after warmup. Reports the graph pool by variant."""
    import aiohttp
    import torch

    from dynamo_tpu_torch.engine.cuda_graphs import PEN_FULL
    from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.run import serve_http

    t = time.monotonic()
    engine = TorchEngine(cfg, EngineConfig(warmup_penalties=True,
                                           warmup_logprobs=False,
                                           max_batch=TRAFFIC_MAX_BATCH),
                         params=params, device=dev)
    engine.warmup()
    check_warmed(engine, [(0, 0), (0, PEN_FULL)], [0])
    report = {"warmup_s": time.monotonic() - t,
              "graph_pool_mib": engine.graph_pool_mib(),
              "penalty_buffers_mib":
                  engine.penalty_buffers.nbytes / 2**20}
    log(f"  warmed in {report['warmup_s']:.1f}s; graph pool MiB by "
        f"variant {json.dumps(report['graph_pool_mib'])}, penalty buffers "
        f"{report['penalty_buffers_mib']:.0f} MiB")
    report["graph_window"] = {
        name: check_graph_window(engine, cfg, dev, form=PEN_FULL,
                                 counts=counts)
        for name, counts in (("penalties", True), ("logit_bias", False))}
    tap = TapEngine(engine)
    mdc = ModelDeploymentCard(name="llama3-8b-ckpt")
    mdc.kv_block_size = engine.ecfg.page_size

    async def serve():
        svc = await serve_http(tap, mdc, "127.0.0.1", 0)
        base = f"http://127.0.0.1:{svc.port}"

        async def one(s, rid, prompt, kw):
            body = {"model": mdc.name, "max_tokens": 24, "messages": [
                {"role": "user", "content": prompt}], **kw}
            async with s.post(f"{base}/v1/chat/completions", json=body,
                              headers={"X-Request-Id": rid}) as r:
                if r.status != 200:
                    fail(f"{rid}: HTTP {r.status}: {await r.text()}")
                return (await r.json())["choices"][0]["finish_reason"]

        try:
            async with aiohttp.ClientSession() as s:
                # the three count-driven penalties in one batch (the state
                # rebuilt per dispatch), then logit_bias alone (no rebuild)
                fins = await asyncio.gather(*[
                    one(s, rid, prompt, kw)
                    for rid, prompt, kw in PENALTY_REQUESTS[:3]])
                return fins + [await one(s, *PENALTY_REQUESTS[3])]
        finally:
            await svc.stop()
            await engine.stop()

    report["finish"] = asyncio.run(serve())
    report["post_warmup_compiles_total"] = \
        engine.stats()["post_warmup_compiles_total"]
    if report["post_warmup_compiles_total"] != 0:
        fail(f"{report['post_warmup_compiles_total']} captures after warmup "
             f"in the penalty phase")
    if tap.tokens["pen-bias"] != [1000] * len(tap.tokens["pen-bias"]) or \
            not tap.tokens["pen-bias"]:
        fail(f"logit_bias +100 did not force token 1000: "
             f"{tap.tokens['pen-bias']}")
    report["vs_plain"] = {
        rid: check_penalised_tokens(engine, cfg, dev, tap, rid, kw)
        for rid, _, kw in PENALTY_REQUESTS}
    report["tokens"] = {rid: len(t) for rid, t in tap.tokens.items()}
    report["replays"] = engine.graph_replays()
    log(f"  penalties served: {json.dumps(report, default=str)}")
    del engine, tap
    torch.cuda.empty_cache()
    return report


# ------------------------------------------------------------ float32

# Limits of phase 11's teacher-forced check (check_paths on the float32 1b
# engine), set from the plain path's float32 noise: that path against
# itself with every weight moved by at most one float32 ulp (f32_noise,
# printed by the phase) read 1.17e-5 (prefill logits), 0.96e-5 (window
# logits) and 0.79e-5 (K/V) on an H100 80GB HBM3 at 700 W (PERF.md,
# Findings); 2e-4 is about 20x that noise. The sound kernel path read
# 1.05e-5, 0.80e-5 and 0.58e-5 there, and the weakest control faults
# 0.87 (window steps 1-3), 1.42 (K/V) and 5.0 (prefill).
F32_PATH_LIMITS = {"prefill_logits": 2e-4, "window_logits": 2e-4,
                   "window_kv": 2e-4}


def f32_noise(engine, cfg, dev) -> dict:
    """The plain path's float32 noise on check_paths' inputs: its logits
    and K/V against the same path with every float32 weight (an int8
    weight's scales) multiplied by 1 + 2^-23 (moved by at most one ulp,
    by rounding), max abs."""
    import torch

    from dynamo_tpu_torch.models.quant import QuantInt8

    def moved(v):
        if isinstance(v, QuantInt8):
            return QuantInt8(v.q, v.s * (1 + 2 ** -23), v.plain)
        return v * (1 + 2 ** -23) if v.dtype == torch.float32 else v

    base = path_run(plain_params(engine.params), cfg, dev, False)
    other = path_run({k: moved(v)
                      for k, v in plain_params(engine.params).items()},
                     cfg, dev, False)
    return {"prefill_logits": max_err(base[0], other[0]),
            "window_logits": max_err(base[1], other[1]),
            "window_kv": max_err(base[2], other[2])}


def f32_phase(dev) -> dict:
    """Phase 11: a TorchEngine of Llama-3.2-1B's widths in float32 (16
    layers, D 2048, I 8192, H 32 on KV 8, head_dim 64, V 128256, an
    untied head; seed-0 random weights, the default EngineConfig with
    batches up to 8) warmed
    (every bucket of both grids captured), phase 4's requests served over
    HTTP (serve_and_check: no capture after warmup, every attention call
    from a graph replay on the float32 routes: decode launches the window
    replays x 16 layers x K, prefill launches the chunk replays x 16),
    then the kernel path against the plain path teacher-forced
    (check_paths at F32_PATH_LIMITS, with its two fault controls) beside
    the plain path's own float32 noise (f32_noise); then the same with
    quant="int8" and float32 activations: served alike with every
    product on the float32 forms of small_m and wgmma (the chunk and
    window replays x (7 x 16 + 1) launches), its check_paths against the
    int8 plain path at F32_PATH_LIMITS with the int8 fault, beside that
    path's noise, and its logits within INT8_REL_L2 of the float32
    engine's."""
    import dataclasses

    import torch

    from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = dataclasses.replace(ModelConfig.llama_1b(), dtype="float32")
    report = {}
    logits = None
    for quant in (None, "int8"):
        tag = "float32" + (" int8" if quant else "")
        t = time.monotonic()
        engine = TorchEngine(cfg, EngineConfig(max_batch=TRAFFIC_MAX_BATCH),
                             seed=0, device="cuda", quant=quant)
        engine.warmup()
        topn = engine.ecfg.max_top_logprobs
        check_warmed(engine, [(0, 0), (topn, 0)], [0, topn])
        log(f"  1b {tag} engine (16 layers, D=2048, V=128256, seed 0) "
            f"built and warmed up in {time.monotonic() - t:.1f}s; "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
        mdc = ModelDeploymentCard(name="llama-1b-" + tag.replace(" ", "-")
                                  + "-random")
        mdc.kv_block_size = engine.ecfg.page_size
        t = time.monotonic()
        served, _, _ = asyncio.run(serve_and_check(engine, mdc))
        log(f"  served {tag} in {time.monotonic() - t:.1f}s: "
            f"{json.dumps(served)}")
        if served_routes(engine) != ("f32", "f32"):
            fail(f"the {tag} engine's attention shape is not on the float32 "
                 f"routes: {served_routes(engine)}")
        if quant == "int8":
            int8 = served["int8_gemm_launches"]
            off = {k: n for k, n in int8.items()
                   if n and not k.endswith("_f32")}
            if off or not all(int8[k] > 0 for k in ("small_m_f32",
                                                     "wgmma_f32")):
                fail(f"{tag}: int8 GEMM launches {int8} are not all on the "
                     f"float32 forms of small_m and wgmma")
        t = time.monotonic()
        noise = f32_noise(engine, cfg, dev)
        log(f"  the {tag} plain path's float32 noise (weights moved one "
            f"ulp): {json.dumps(noise)}")
        paths, got = check_paths(engine, cfg, dev, F32_PATH_LIMITS)
        log(f"  {tag} teacher-forced check in {time.monotonic() - t:.1f}s")
        entry = {"served": served, "noise": noise, "paths": paths}
        if quant == "int8":
            entry["vs_float32"] = compare_int8_bf16(got, logits, "float32")
        logits = got
        report[tag] = entry
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return report


# ------------------------------------------------------------ float16


def f16_phase(dev) -> dict:
    """Phase 12: the 8B model in float16 (seed-0 weights, the default
    EngineConfig), an engine built directly: warmed (every bucket of both
    grids captured), phase 4's requests served over HTTP (serve_and_check:
    no capture after warmup, every attention call from a graph replay on
    the float16 routes, decode launches the window replays x 32 x K,
    prefill launches the chunk replays x 32), its kernel path against its
    plain path teacher-forced (check_paths at PATH_LIMITS with the two
    fault controls); then the same with quant="int8" and float16
    activations: served alike with every product on the float16 forms of
    small_m and wgmma, its check_paths with the int8 fault, and its
    logits within INT8_REL_L2 of the float16 engine's."""
    import dataclasses

    import torch

    from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = dataclasses.replace(ModelConfig.llama3_8b(), dtype="float16")
    report = {}
    logits = None
    for quant in (None, "int8"):
        tag = "float16" + (" int8" if quant else "")
        t = time.monotonic()
        engine = TorchEngine(cfg, EngineConfig(max_batch=TRAFFIC_MAX_BATCH),
                             seed=0, device="cuda", quant=quant)
        engine.warmup()
        topn = engine.ecfg.max_top_logprobs
        check_warmed(engine, [(0, 0), (topn, 0)], [0, topn])
        log(f"  8B {tag} engine (32 layers, D=4096, V=128256, seed 0) built "
            f"and warmed up in {time.monotonic() - t:.1f}s; "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
        mdc = ModelDeploymentCard(name="llama3-8b-" + tag.replace(" ", "-"))
        mdc.kv_block_size = engine.ecfg.page_size
        t = time.monotonic()
        served, _, _ = asyncio.run(serve_and_check(engine, mdc))
        log(f"  served {tag} in {time.monotonic() - t:.1f}s: "
            f"{json.dumps(served)}")
        if served_routes(engine) != ("f16_mma", "f16"):
            fail(f"the {tag} engine's attention shape is not on the float16 "
                 f"routes: {served_routes(engine)}")
        if quant == "int8":
            int8 = served["int8_gemm_launches"]
            off = {k: n for k, n in int8.items()
                   if n and not k.endswith("_f16")}
            if off or not all(int8[k] > 0 for k in ("small_m_f16",
                                                     "wgmma_f16")):
                fail(f"{tag}: int8 GEMM launches {int8} are not all on the "
                     f"float16 forms of small_m and wgmma")
        t = time.monotonic()
        paths, got = check_paths(engine, cfg, dev)
        log(f"  {tag} teacher-forced check in {time.monotonic() - t:.1f}s")
        entry = {"served": served, "paths": paths}
        if quant == "int8":
            entry["vs_float16"] = compare_int8_bf16(got, logits, "float16")
        logits = got
        report[tag] = entry
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return report


# ------------------------------------------------------- generic prefill


def serve_one_tiny(dtype: str, ps: int, hd: int = 16) -> dict:
    """The tiny preset (head_dim ``hd``, 16 as the preset has it) in
    ``dtype`` with the launcher's tiny engine config at page size ``ps``,
    seed-0 weights, warmed, then one request on the card (16 prompt
    tokens, 12 generated, greedy): no capture after warmup, every prefill
    call on the generic kernel and every decode call on the generic
    decode kernel."""
    import dataclasses

    import torch

    from dynamo_tpu_torch.engine.torch_engine import TorchEngine
    from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                       StopConditions)
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import paged_attention as ops
    from dynamo_tpu_torch.run import build_engine_config, parse_args
    from dynamo_tpu_torch.runtime.engine import Context

    ecfg = dataclasses.replace(
        build_engine_config(parse_args(["in=http", "out=torch"])),
        page_size=ps)
    engine = TorchEngine(ModelConfig.tiny(dtype=dtype, head_dim=hd), ecfg,
                         seed=0, device="cuda")
    engine.warmup()
    ops.reset_launch_counts()

    async def one():
        toks = []
        try:
            req = PreprocessedRequest(
                token_ids=list(range(30, 30 + TINY_SERVED_CHUNK)),
                stop=StopConditions(max_tokens=12, ignore_eos=True))
            async for out in engine.generate(req, Context()):
                toks += out.token_ids
        finally:
            await engine.stop()
        return toks

    toks = asyncio.run(one())
    torch.cuda.synchronize()
    got = {"dtype": dtype, "page_size": ps, "head_dim": hd, "tokens": toks,
           "launches": dict(ops.LAUNCHES),
           "route_launches": dict(ops.DECODE_ROUTE_LAUNCHES),
           "prefill_route_launches": dict(ops.PREFILL_ROUTE_LAUNCHES),
           "post_warmup_compiles_total":
               engine.stats()["post_warmup_compiles_total"]}
    n_pf, n_dec = (got["launches"]["paged_attention_prefill"],
                   got["launches"]["paged_attention_decode"])
    if (len(toks) != 12 or got["post_warmup_compiles_total"] != 0
            or n_pf <= 0 or n_dec <= 0
            or got["prefill_route_launches"] != only(ops.PREFILL_ROUTES,
                                                     "generic", n_pf)
            or got["route_launches"] != only(ops.DECODE_ROUTES, "generic",
                                             n_dec)):
        fail(f"tiny {dtype} engine at page {ps}, head_dim {hd}: "
             f"{json.dumps(got)}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return got


def generic_phase(dev) -> dict:
    """Phase 13: the generic prefill kernel on served paths. Llama-3.2-1B's
    widths in bfloat16 (the JAX launcher's ``1b`` preset, seed-0 weights)
    at page size 8, as the reference's ``--kv-cache-block-size 8`` gives
    (:func:`generic_1b_ecfg`): warmed (every bucket of both grids
    captured), phase 4's requests served over HTTP (serve_and_check: no
    capture after warmup, every attention call from a graph replay, every
    prefill call on the generic kernel, every decode call on the generic
    decode kernel), then its kernel path against its plain path
    teacher-forced at page 8 (check_paths at PATH_LIMITS with the two
    fault controls); then the tiny preset in bfloat16 and float16 (head
    dim 16, page 16) and in float32 at page 4, one request each on the
    generic kernel (:func:`serve_one_tiny`)."""
    import torch

    from dynamo_tpu_torch.engine.torch_engine import TorchEngine
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.llama_1b()
    t = time.monotonic()
    engine = TorchEngine(cfg, generic_1b_ecfg(), seed=0, device="cuda")
    engine.warmup()
    topn = engine.ecfg.max_top_logprobs
    check_warmed(engine, [(0, 0), (topn, 0)], [0, topn])
    log(f"  1b bf16 engine at page 8 (16 layers, D=2048, V=128256, seed 0) "
        f"built and warmed up in {time.monotonic() - t:.1f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    if served_routes(engine) != ("generic", "generic"):
        fail(f"the 1b at page 8 is not on the generic kernels: "
             f"{served_routes(engine)}")
    mdc = ModelDeploymentCard(name="llama-1b-page8-random")
    mdc.kv_block_size = engine.ecfg.page_size
    t = time.monotonic()
    served, _, _ = asyncio.run(serve_and_check(engine, mdc))
    log(f"  served in {time.monotonic() - t:.1f}s: {json.dumps(served)}")
    t = time.monotonic()
    paths, _ = check_paths(engine, cfg, dev)
    log(f"  teacher-forced check at page 8 in {time.monotonic() - t:.1f}s")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    report = {"1b bf16 page 8": {"served": served, "paths": paths}}
    for dtype, ps in TINY_GENERIC:
        report[f"tiny {dtype} page {ps}"] = got = serve_one_tiny(dtype, ps)
        log(f"  tiny {dtype} engine at page {ps}: {json.dumps(got)}")
    # the widened kernels (head_dim past 256) on a served path: the tiny
    # preset at head_dim 512 in bfloat16 (its launches fill their rows)
    report[WIDE_SERVED] = got = serve_one_tiny("bfloat16", 16, hd=512)
    log(f"  tiny bfloat16 engine at head_dim 512: {json.dumps(got)}")
    return report


# ------------------------------------------------ Mistral-Large-2's widths


# Mistral-Large-Instruct-2407's published config.json (the fields the
# loader reads): 96 query heads on 8 kv heads of head_dim 128, a GQA group
# of 12, which no fast decode route takes
MISTRAL_LARGE_2407 = {
    "model_type": "mistral", "hidden_size": 12288,
    "intermediate_size": 28672, "num_attention_heads": 96,
    "num_key_value_heads": 8, "head_dim": 128, "vocab_size": 32768,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-05,
    "tie_word_embeddings": False, "num_hidden_layers": 88}
# its one cut: 4 of the 88 layers (2.77 GB of bfloat16 weights a layer;
# the whole model, 246 GB, does not fit the card)
MISTRAL_LAYERS = 4


def mistral_phase(dev) -> dict:
    """Phase 14: Mistral-Large-2's widths (MISTRAL_LARGE_2407 through
    ``ModelConfig.from_hf_config``, 4 of its 88 layers, bfloat16, seed-0
    weights, the default EngineConfig: page 64), an engine built
    directly: warmed (every bucket of both grids captured), phase 4's
    requests served over HTTP (serve_and_check: no capture after warmup,
    every attention call from a graph replay, every decode call on the
    generic decode kernel, window replays x 4 layers x K, and every
    prefill call on the generic prefill kernel), then its kernel path
    against its plain path teacher-forced (check_paths at PATH_LIMITS
    with the two fault controls)."""
    import torch

    from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.from_hf_config(
        dict(MISTRAL_LARGE_2407, num_hidden_layers=MISTRAL_LAYERS))
    if (cfg.dtype, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim_) != (
            "bfloat16", 12, 128):
        fail(f"Mistral-Large-2's config parsed as {cfg}")
    t = time.monotonic()
    engine = TorchEngine(cfg, EngineConfig(), seed=0, device="cuda")
    engine.warmup()
    topn = engine.ecfg.max_top_logprobs
    check_warmed(engine, [(0, 0), (topn, 0)], [0, topn])
    log(f"  Mistral-Large-2 engine ({cfg.num_layers} of 88 layers, D=12288, "
        f"H=96 on 8 kv heads, V=32768, bf16, seed 0) built and warmed up in "
        f"{time.monotonic() - t:.1f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    if served_routes(engine) != ("generic", "generic"):
        fail(f"Mistral-Large-2's heads are not on the generic kernels: "
             f"{served_routes(engine)}")
    mdc = ModelDeploymentCard(name="mistral-large-2407-4-layers-random")
    mdc.kv_block_size = engine.ecfg.page_size
    t = time.monotonic()
    served, _, _ = asyncio.run(serve_and_check(engine, mdc))
    log(f"  served in {time.monotonic() - t:.1f}s: {json.dumps(served)}")
    t = time.monotonic()
    paths, _ = check_paths(engine, cfg, dev)
    log(f"  teacher-forced check in {time.monotonic() - t:.1f}s")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"config": dict(MISTRAL_LARGE_2407,
                           num_hidden_layers=MISTRAL_LAYERS),
            "served": served, "paths": paths}


# ------------------------------------------------- Mixtral-8x7B's widths


# Mixtral-8x7B-v0.1's published config.json (the fields the loader reads)
MIXTRAL_8X7B = {
    "model_type": "mixtral", "hidden_size": 4096,
    "intermediate_size": 14336, "num_attention_heads": 32,
    "num_key_value_heads": 8, "vocab_size": 32000,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-05,
    "tie_word_embeddings": False, "num_local_experts": 8,
    "num_experts_per_tok": 2, "sliding_window": None,
    "num_hidden_layers": 32}
# its one cut: 4 of the 32 layers (2.82 GB of bfloat16 experts a layer;
# the whole model, 93.4 GB, does not fit the card)
MIXTRAL_LAYERS = 4
# phase 19 (b)'s MoE blocks alone: (name, D, expert width, experts, top
# k, tokens); Qwen3-30B-A3B's from its config.json (hidden_size,
# moe_intermediate_size, num_experts, num_experts_per_tok)
MOE_BLOCKS = (("mixtral-8x7b", 4096, 14336, 8, 2, 2048),
              ("qwen3-30b-a3b", 2048, 768, 128, 8, 1024))
# the bfloat16 MoE block against its float32 computation expert by expert,
# and the blocked dispatch against the dense sum: relative L2. Each expert
# product rounds to bfloat16 four times (gate, up, their product, down;
# 2^-9 relative each at most) and the two strategies multiply in other
# GEMM shapes
MOE_REL_L2 = 2e-2
# tokens each of phase 4's four prompts generates when submitted at once
# (phase 19 (a) and (c))
MOE_MAX_TOKENS = 32
# the contexts of a timed 4-row window's rows (phase 4's four prompts)
WINDOW_CONTEXTS = [48, 640, 64, 40]


def moe_prompts() -> list:
    """Phase 4's four requests as token ids (the byte tokenizer; the chat
    ones through its chat template), the long prompt first (the
    scheduler's head sets a dispatch's chunk bucket, and prompts of
    smaller buckets ride along: so all four pack into one [8, 512]
    dispatch) with its first letter P."""
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    tok = ByteTokenizer()

    def chat(text):
        return tok.encode(tok.apply_chat_template(
            [{"role": "user", "content": text}]))

    long_prompt = "P" + ("The quick brown fox jumps over the lazy dog. "
                         * 14)[1:600]
    return [chat(long_prompt), chat("Tell me about paged attention."),
            chat("What is an H100?"), tok.encode("Once upon a time")]


async def serve_packed(engine, prompts: list, max_tokens: int) -> dict:
    """``prompts`` submitted to the engine at once (greedy, ``max_tokens``
    each, EOS ignored): the scheduler admits them together, so their
    first chunks pack into one prefill dispatch. Returns tokens, TTFT
    and ITL."""
    from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                       StopConditions)
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(ids):
        req = PreprocessedRequest(
            token_ids=list(ids),
            stop=StopConditions(max_tokens=max_tokens, ignore_eos=True))
        toks, stamps, finish = [], [], None
        async for out in engine.generate(req, Context()):
            if out.token_ids:
                toks += out.token_ids
                stamps.append((time.monotonic(), len(out.token_ids)))
            finish = out.finish_reason or finish
        if finish != "length" or len(toks) != max_tokens:
            fail(f"packed batch: a {len(ids)}-token prompt finished "
                 f"{finish!r} after {len(toks)} tokens")
        return toks, stamps

    t0 = time.monotonic()
    res = await asyncio.gather(*[one(p) for p in prompts])
    itl = []
    for _, ts in res:
        for (a, _), (b, n) in zip(ts, ts[1:]):
            itl += [(b - a) / n] * n
    out = {"tokens": [t for t, _ in res],
           "prompt_tokens": [len(p) for p in prompts],
           "ttft_ms": sorted(round((ts[0][0] - t0) * 1e3, 3)
                             for _, ts in res),
           "itl_ms_mean": round(sum(itl) / len(itl) * 1e3, 3),
           "wall_s": round(time.monotonic() - t0, 3)}
    return out


def prefill_replays(engine) -> dict:
    """Prefill graph replays so far by bucket key, every variant's."""
    got = {}
    for gs in engine.prefill_variants.values():
        for key, n in gs.replays_by_key.items():
            got[key] = got.get(key, 0) + n
    return got


def moe_dispatch(cfg, key) -> str:
    """The expert dispatch a prefill bucket ``key`` (B, T, ...) runs:
    the port's cost model on its static shape."""
    from dynamo_tpu_torch.models import llama

    B, T = key[:2]
    return ("blocked" if llama._moe_use_blocked(
        None, B * T, cfg.num_experts, cfg.num_experts_per_tok,
        llama._MOE_BLOCK) else "dense")


def by_dispatch(cfg, replays: dict) -> dict:
    out = {"blocked": 0, "dense": 0}
    for key, n in replays.items():
        out[moe_dispatch(cfg, key)] += n
    return out


def int8_moe_launches(engine, decode_replays: dict, pf_replays: dict
                      ) -> int:
    """The int8 GEMM launches the replayed buckets make: a prefill chunk
    4 attention products and the experts' 3 a block (blocked) or an
    expert (dense) a layer, and the head; a window that per step."""
    from dynamo_tpu_torch.models import llama

    c, K = engine.cfg, engine.ecfg.decode_steps
    E, k, L = c.num_experts, c.num_experts_per_tok, c.num_layers

    def per_pass(tokens: int, blocked: bool) -> int:
        block = llama._MOE_BLOCK
        experts = (-(-tokens * k // block) + E) if blocked else E
        return L * (4 + 3 * experts) + 1

    n = 0
    for (B, T, *_), r in pf_replays.items():
        n += r * per_pass(B * T, moe_dispatch(c, (B, T)) == "blocked")
    for (B, _), r in decode_replays.items():
        n += r * K * per_pass(B, False)
    return n


def decode_replays(engine) -> dict:
    got = {}
    for gs in engine.decode_variants.values():
        for key, n in gs.replays_by_key.items():
            got[key] = got.get(key, 0) + n
    return got


def graph_twice(fn):
    """``fn`` captured in a CUDA graph (warmed on the capture stream) and
    replayed twice: the two outputs, cloned."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    outs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append(out.clone())
    return outs


def moe_f32_reference(x, weights, idx, wg, wu, wd):
    """The MoE block in float32, expert by expert: each expert's tokens
    (found on the host) through its weights upcast to float32, weighted
    and added. [N, D] float32."""
    import torch
    import torch.nn.functional as F

    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(wg.shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok].float()
        y = (F.silu(xe @ wg[e].float()) * (xe @ wu[e].float())) \
            @ wd[e].float()
        out.index_add_(0, tok, y * weights[tok, slot, None])
    return out


def moe_block_case(dev, name, D, I, E, k, N, seed: int = 0) -> dict:
    """Phase 19 (b), one MoE block of seed-0 bfloat16 weights on N
    bfloat16 tokens: routing, then the blocked dispatch (which the cost
    model takes at N) and the dense sum, each replayed twice from a CUDA
    graph (same bits), against each other and against the float32
    computation (MOE_REL_L2), and timed: the whole block at N (blocked)
    and at 4 rows (dense), and the dense sum at N."""
    import math

    import torch

    from dynamo_tpu_torch.models import llama

    g = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape):
        x = torch.randn(shape, generator=g, device=dev)
        return x.mul_(1.0 / math.sqrt(shape[-2])).to(torch.bfloat16)

    router, wg, wu, wd = w(D, E), w(E, D, I), w(E, D, I), w(E, I, D)
    h = torch.randn((1, N, D), generator=g, device=dev).to(torch.bfloat16)
    block = llama._MOE_BLOCK
    if not llama._moe_use_blocked(None, N, E, k, block):
        fail(f"{name}: the cost model keeps {N} tokens on the dense sum")
    x = h[0]
    weights, idx = llama.moe_route(x, router, k)
    ref = moe_f32_reference(x, weights, idx, wg, wu, wd)
    got = {}
    for strategy, fn in (
            ("blocked", lambda: llama.moe_experts_blocked(
                x, weights, idx, wg, wu, wd, block=block)),
            ("dense", lambda: llama.moe_experts_dense(
                x, weights, idx, wg, wu, wd))):
        a, b = graph_twice(fn)
        if not torch.equal(a, b):
            fail(f"{name} {strategy}: two replays differ "
                 f"({max_err(a, b):.4g})")
        if not bool(torch.isfinite(a).all()):
            fail(f"{name} {strategy}: non-finite output")
        got[strategy] = a
    errs = {"blocked_vs_f32": rel_l2(got["blocked"], ref),
            "dense_vs_f32": rel_l2(got["dense"], ref),
            "blocked_vs_dense": rel_l2(got["blocked"], got["dense"])}
    for key, err in errs.items():
        if err > MOE_REL_L2:
            fail(f"{name}: {key} rel_l2 {err:.4g} > {MOE_REL_L2}")
    h4 = h[:, :4].reshape(4, 1, D).contiguous()
    times = {
        f"block_{N}_blocked_ms": time_ms(
            lambda: llama._moe_mlp(h, router, wg, wu, wd, k), iters=5),
        f"dense_sum_{N}_ms": time_ms(
            lambda: llama.moe_experts_dense(x, weights, idx, wg, wu, wd),
            iters=5),
        "block_4_dense_ms": time_ms(
            lambda: llama._moe_mlp(h4, router, wg, wu, wd, k), iters=20)}
    expert_bytes = 3 * E * D * I * 2
    bounds = {
        # 4 rows read every expert (the dense sum): the weight bytes
        "block_4_dense_bound_ms": expert_bytes / H100_BYTES_PER_S * 1e3,
        # N tokens: the k experts' products each token needs, or the
        # weights read once, whichever is longer
        f"block_{N}_blocked_bound_ms": max(
            2 * 3 * N * k * D * I / H100_BF16_FLOPS,
            expert_bytes / H100_BYTES_PER_S) * 1e3}
    rep = {"shape": {"D": D, "I": I, "E": E, "k": k, "N": N,
                     "block": block,
                     "blocks": -(-N * k // block) + E},
           "rel_l2": errs, "replays_bitwise": True, **times, **bounds}
    log(f"  MoE block {name}: {json.dumps(rep)}")
    return rep


def window_4_rows_ms(engine, table_pages: int = 0) -> float:
    """Device ms of a 4-row greedy window of the served model (its decode
    function on scratch pools through the registry's module, rows at
    WINDOW_CONTEXTS, phase 4's contexts), the rows' page tables
    ``table_pages`` wide (0: just their pages)."""
    import torch

    from dynamo_tpu_torch.models.llama import KVCacheSpec

    cfg, ps, K = engine.cfg, engine.ecfg.page_size, engine.ecfg.decode_steps
    ctx = WINDOW_CONTEXTS
    per = -(-(max(ctx) + K) // ps)
    kk, vv = engine.model.init_kv_cache(cfg, KVCacheSpec(1 + 4 * per, ps),
                                        device=engine.device)
    dev = kk.device
    table = torch.zeros((4, max(table_pages, per)), dtype=torch.int32,
                        device=dev)
    table[:, :per] = torch.arange(1, 1 + 4 * per, dtype=torch.int32,
                                  device=dev).reshape(4, per)

    def full(value, dtype, shape=(4,)):
        return torch.full(shape, value, dtype=dtype, device=dev)

    # greedy rows at the contexts, device inputs as a decode bucket's
    i32 = torch.int32
    args = (torch.tensor([5, 6, 7, 8], dtype=i32, device=dev),
            torch.tensor(ctx, dtype=i32, device=dev), full(False, torch.bool),
            full(0, i32), full(100, i32), kk, vv, table,
            full(0.0, torch.float32), full(0, i32), full(1.0, torch.float32),
            full(0, torch.int64), full(-1, i32, (4, 1)))

    def window():
        return engine.decode_multi_fn(engine.params, *args, k_steps=K)

    return time_ms(window, iters=5)


def moe_window_share(engine, block_4_ms: float) -> dict:
    """A 4-row greedy window of the served model timed on the card
    (:func:`window_4_rows_ms`), and the share of it the MoE blocks take
    (layers x steps x one 4-row block's time)."""
    cfg, K = engine.cfg, engine.ecfg.decode_steps
    ms = window_4_rows_ms(engine)
    moe = cfg.num_layers * K * block_4_ms
    return {"window_4_rows_ms": ms, "moe_blocks_ms": moe,
            "moe_share": moe / ms, "contexts": WINDOW_CONTEXTS, "steps": K}


def check_packed_routes(packed: dict) -> None:
    """Every attention call of a packed batch on the bf16 kernels."""
    from dynamo_tpu_torch.ops import paged_attention as ops

    n_dec = packed["launches"]["paged_attention_decode"]
    n_pf = packed["launches"]["paged_attention_prefill"]
    if (n_dec <= 0 or n_pf <= 0
            or packed["route_launches"] != only(ops.DECODE_ROUTES,
                                                "bf16_mma", n_dec)
            or packed["prefill_route_launches"] != only(ops.PREFILL_ROUTES,
                                                        "bf16", n_pf)):
        fail(f"packed batch's attention calls by route: "
             f"{json.dumps(packed)}")


def moe_engine(cfg, quant=None):
    import torch

    from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine

    t = time.monotonic()
    engine = TorchEngine(cfg, EngineConfig(max_batch=TRAFFIC_MAX_BATCH),
                         seed=0, device="cuda", quant=quant)
    engine.warmup()
    topn = engine.ecfg.max_top_logprobs
    check_warmed(engine, [(0, 0), (topn, 0)], [0, topn])
    log(f"  Mixtral-8x7B engine ({cfg.num_layers} of 32 layers, 8 experts "
        f"top 2, D=4096, expert width 14336, V=32000, bf16"
        f"{', int8 weights' if quant else ''}, seed 0) built and warmed up "
        f"in {time.monotonic() - t:.1f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    if served_routes(engine) != ("bf16_mma", "bf16"):
        fail(f"Mixtral's heads are not on the bf16 kernels: "
             f"{served_routes(engine)}")
    return engine


def moe_phase(dev) -> dict:
    """Phase 19: MoE at Mixtral-8x7B's widths (the docstring's (a), (b)
    and (c))."""
    import torch

    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import int8_gemm
    from dynamo_tpu_torch.ops import paged_attention as ops

    t_phase = time.monotonic()
    cfg = ModelConfig.from_hf_config(
        dict(MIXTRAL_8X7B, num_hidden_layers=MIXTRAL_LAYERS))
    if (cfg.dtype, cfg.num_experts, cfg.num_experts_per_tok, cfg.head_dim_,
            cfg.intermediate_size) != ("bfloat16", 8, 2, 128, 14336):
        fail(f"Mixtral-8x7B's config parsed as {cfg}")
    prompts = moe_prompts()

    # (a) served, bfloat16
    engine = moe_engine(cfg)
    mdc = ModelDeploymentCard(name="mixtral-8x7b-4-layers-random")
    mdc.kv_block_size = engine.ecfg.page_size

    async def serve():
        ops.reset_launch_counts()
        packed = await serve_packed(engine, prompts, MOE_MAX_TOKENS)
        packed["prefill_replays"] = by_dispatch(cfg, prefill_replays(engine))
        packed["launches"] = dict(ops.LAUNCHES)
        packed["route_launches"] = dict(ops.DECODE_ROUTE_LAUNCHES)
        packed["prefill_route_launches"] = dict(ops.PREFILL_ROUTE_LAUNCHES)
        served, _, _ = await serve_and_check(engine, mdc)
        return packed, served

    t = time.monotonic()
    packed, served = asyncio.run(serve())
    replays = prefill_replays(engine)
    dispatch = by_dispatch(cfg, replays)
    log(f"  packed batch: {json.dumps(packed)}")
    log(f"  served in {time.monotonic() - t:.1f}s: {json.dumps(served)}")
    log(f"  prefill replays by bucket: "
        f"{json.dumps({str(k): v for k, v in sorted(replays.items())})}; "
        f"by expert dispatch {json.dumps(dispatch)}")
    check_packed_routes(packed)
    if packed["prefill_replays"]["blocked"] <= 0:
        fail(f"the packed prompts took no blocked dispatch: "
             f"{json.dumps(packed['prefill_replays'])}")
    if dispatch["blocked"] <= 0 or dispatch["dense"] <= 0:
        fail(f"served prefill replays by dispatch {dispatch}: both "
             f"strategies must have run")
    moe_calls = {  # MoE blocks the replays ran (a layer each)
        "prefill": sum(replays.values()) * cfg.num_layers,
        "window": sum(decode_replays(engine).values())
        * cfg.num_layers * engine.ecfg.decode_steps}
    t = time.monotonic()
    paths, _ = check_paths(engine, cfg, dev)
    log(f"  teacher-forced check in {time.monotonic() - t:.1f}s")

    # (b) the MoE block alone
    blocks = {name: moe_block_case(dev, name, *shape)
              for name, *shape in MOE_BLOCKS}
    share = moe_window_share(engine,
                             blocks["mixtral-8x7b"]["block_4_dense_ms"])
    log(f"  4-row window: {json.dumps(share)}")
    # the served path's attention launches: the packed batch's and
    # serve_and_check's (check_paths' and the timings' do not count)
    attn = {"decode": packed["launches"]["paged_attention_decode"]
            + served["launches"]["paged_attention_decode"],
            "prefill": packed["launches"]["paged_attention_prefill"]
            + served["launches"]["paged_attention_prefill"]}
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # (c) int8 experts
    engine = moe_engine(cfg, quant="int8")
    ops.reset_launch_counts()
    int8_gemm.reset_launch_counts()
    t = time.monotonic()
    packed8 = asyncio.run(serve_packed(engine, prompts, MOE_MAX_TOKENS))
    log(f"  int8 packed batch in {time.monotonic() - t:.1f}s: "
        f"{json.dumps(packed8)}")
    launched = dict(int8_gemm.INT8_GEMM_LAUNCHES)
    packed8["launches"] = dict(ops.LAUNCHES)
    packed8["route_launches"] = dict(ops.DECODE_ROUTE_LAUNCHES)
    packed8["prefill_route_launches"] = dict(ops.PREFILL_ROUTE_LAUNCHES)
    check_packed_routes(packed8)
    pf8, dec8 = prefill_replays(engine), decode_replays(engine)
    want = int8_moe_launches(engine, dec8, pf8)
    blocked8 = {str(k): bk.counts for gs in engine.prefill_variants.values()
                for k, bk in gs.buckets.items()
                if pf8.get(k) and moe_dispatch(cfg, k) == "blocked"}
    if sum(launched.values()) != want:
        fail(f"int8 GEMM launches {launched} != the replayed buckets' "
             f"{want}")
    if launched["small_m"] <= 0 or launched["wgmma"] <= 0:
        fail(f"int8 routes on the served MoE: {launched}")
    if not blocked8 or not all(
            any(c.get("wgmma", 0) > 0 for c in counts)
            for counts in blocked8.values()):
        fail(f"the blocked prefill's expert products are not on wgmma: "
             f"{blocked8}")
    if engine.stats()["post_warmup_compiles_total"] != 0:
        fail("int8 MoE engine captured graphs while serving")
    paths8, _ = check_paths(engine, cfg, dev)
    attn["decode"] += packed8["launches"]["paged_attention_decode"]
    attn["prefill"] += packed8["launches"]["paged_attention_prefill"]
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.monotonic() - t_phase
    log(f"  phase 19: served ITL mean {served['itl_ms_mean']} ms, TTFT "
        f"{served['ttft_ms']} ms (HTTP, four at once); packed ITL mean "
        f"{packed['itl_ms_mean']} ms, TTFT {packed['ttft_ms']} ms; int8 "
        f"packed ITL mean {packed8['itl_ms_mean']} ms, TTFT "
        f"{packed8['ttft_ms']} ms; MoE blocks on the served path "
        f"{json.dumps(moe_calls)}; {seconds:.1f}s")
    return {"config": dict(MIXTRAL_8X7B, num_hidden_layers=MIXTRAL_LAYERS),
            "packed": packed, "served": served, "dispatch": dispatch,
            "moe_calls": moe_calls, "paths": paths, "blocks": blocks,
            "window_share": share, "int8": {
                "packed": packed8, "launches": launched,
                "expected_launches": want, "paths": paths8},
            "attention_launches": attn, "seconds": seconds}


# ------------------------------------------ MLA at DeepSeek-V2-Lite's widths


# deepseek-ai/DeepSeek-V2-Lite's config.json (the fields the port reads,
# and those that say which of DeepSeek's variants it is)
DEEPSEEK_V2_LITE = {
    "model_type": "deepseek_v2", "hidden_size": 2048,
    "intermediate_size": 10944, "num_hidden_layers": 27,
    "num_attention_heads": 16, "num_key_value_heads": 16,
    "q_lora_rank": None, "kv_lora_rank": 512, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "n_routed_experts": 64,
    "num_experts_per_tok": 6, "n_shared_experts": 2,
    "moe_intermediate_size": 1408, "first_k_dense_replace": 1,
    "routed_scaling_factor": 1.0, "topk_method": "greedy", "n_group": 1,
    "topk_group": 1, "norm_topk_prob": False, "scoring_func": "softmax",
    "vocab_size": 102400, "rms_norm_eps": 1e-06, "rope_theta": 10000,
    "tie_word_embeddings": False, "max_position_embeddings": 163840,
    "rope_scaling": {"type": "yarn", "factor": 40,
                     "original_max_position_embeddings": 4096,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "beta_fast": 32, "beta_slow": 1}}
# its one cut: 4 of the 27 layers (the dense first layer and 3 MoE layers)
# at full width, ~4.5 GB of bfloat16 weights
DEEPSEEK_LAYERS = 4
# phase 20 (b): one MLA attention layer at DeepSeek-V3's widths and V3's
# router (deepseek-ai/DeepSeek-V3's config.json)
DEEPSEEK_V3_ATTN = {"hidden_size": 7168, "num_heads": 128,
                    "q_lora_rank": 1536, "kv_lora_rank": 512,
                    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
                    "v_head_dim": 128}
DEEPSEEK_V3_ROUTER = {"hidden_size": 7168, "num_experts": 256,
                      "num_experts_per_tok": 8, "n_group": 8,
                      "topk_group": 4, "routed_scaling_factor": 2.5}
ROUTER_TOKENS = 2048
# tokens each of phase 4's four prompts generates when submitted at once
# (phase 20 (a) and (c))
MLA_MAX_TOKENS = 32
# the bfloat16 blocks (MLA attention, the MoE block) against their float32
# computation on the same bfloat16 weights and inputs: relative L2.
# Attention rounds q, the latents, the rotated rope parts and the output
# to bfloat16 (2^-9 relative each at most) around float32 latent einsums
MLA_BLOCK_REL_L2 = 2e-2
# V3's router on bfloat16 tokens against float32 tokens and weights: a
# token's expert set may differ only where the float32 selection has a
# near-tie (its k-th and k+1-th expert, or its top_k-th and next group,
# within ROUTER_TIE); the applied weights of the same sets within
# ROUTER_WEIGHT_ATOL (scaled by 2.5, renormalised over 8)
ROUTER_TIE = 5e-3
ROUTER_WEIGHT_ATOL = 1e-2
# the served model in bfloat16 against the same model in float32 (phase
# 20 (a) 6; teacher-forced, the float32 run on the bf16 run's experts):
# relative L2 of each row's prefill logits and of each row's window logits
# over its steps, and of the window's committed latent and rope rows. A
# fault control (one latent row zeroed in every layer's pool, read by
# the short row) must land above the logits limits
MLA_F32_LIMITS = {"prefill_rel_l2": 0.05, "window_rel_l2": 0.05,
                  "window_kv_rel_l2": 0.05}


def mla_cfg():
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.from_hf_config(
        dict(DEEPSEEK_V2_LITE, num_hidden_layers=DEEPSEEK_LAYERS))
    if (cfg.dtype, cfg.is_mla, cfg.num_experts, cfg.num_experts_per_tok,
            cfg.n_shared_experts, cfg.first_k_dense_replace, cfg.moe_router,
            cfg.n_group, cfg.q_lora_rank) != (
            "bfloat16", True, 64, 6, 2, 1, "deepseek_v2", 0, 0):
        fail(f"DeepSeek-V2-Lite's config parsed as {cfg}")
    return cfg


def mla_engine(cfg, quant=None):
    """The 4-layer V2-Lite engine, warmed. With int8 weights it serves
    only phase 20 (c)'s packed prompts (no logprobs request), so it warms
    the plain variants alone."""
    import torch

    from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models import mla

    t = time.monotonic()
    engine = TorchEngine(cfg, EngineConfig(warmup_logprobs=quant is None,
                                           max_batch=TRAFFIC_MAX_BATCH),
                         seed=0, device="cuda", quant=quant)
    if engine.model is not mla or engine.decode_multi_fn.__qualname__ != (
            "_make_decode_multi.<locals>.decode_multi"):
        fail("the MLA engine is not on models/mla.py and the generic window")
    engine.warmup()
    topns = [0] + ([engine.ecfg.max_top_logprobs] if quant is None else [])
    check_warmed(engine, [(n, 0) for n in topns], topns)
    log(f"  DeepSeek-V2-Lite engine ({cfg.num_layers} of 27 layers, MLA r "
        f"512 + rope 64, 16 heads, 64 experts top 6 + 2 shared, D=2048, "
        f"V=102400, bf16{', int8 weights' if quant else ''}, seed 0) built "
        f"and warmed up in {time.monotonic() - t:.1f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated; latent "
        f"pools {(engine.kv_k.nbytes + engine.kv_v.nbytes) / 2**20:.0f} MiB")
    return engine


def int8_mla_launches(engine, decode_replays: dict, pf_replays: dict) -> int:
    """The int8 GEMM launches the replayed buckets make: a pass runs each
    layer's attention products (w_q or w_dq and w_uq, w_dkv, w_o; w_uk and
    w_uv dequantize), the dense first layers' 3, each MoE layer's experts'
    3 a block (blocked) or an expert (dense) and the shared experts' 3,
    and the head; a window that per step."""
    from dynamo_tpu_torch.models import llama

    c, K = engine.cfg, engine.ecfg.decode_steps
    E, k, L = c.num_experts, c.num_experts_per_tok, c.num_layers
    kd = c.first_k_dense_replace
    attn = 4 if c.q_lora_rank else 3
    shared = 3 if c.n_shared_experts else 0

    def per_pass(tokens: int, blocked: bool) -> int:
        experts = (-(-tokens * k // llama._MOE_BLOCK) + E) if blocked else E
        return L * attn + kd * 3 + (L - kd) * (3 * experts + shared) + 1

    n = 0
    for (B, T, *_), r in pf_replays.items():
        n += r * per_pass(B * T, moe_dispatch(c, (B, T)) == "blocked")
    for (B, _), r in decode_replays.items():
        n += r * K * per_pass(B, False)
    return n


def mla_f32_check(engine, cfg, dev) -> dict:
    """Phase 20 (a) 6: check_paths' teacher-forced prefill and window
    (:func:`path_run`) of the served bfloat16 model against the same
    model computed in float32 on the card (its bfloat16 weights upcast,
    float32 pools), the float32 run on the bf16 run's experts (routed):
    each row's prefill logits, each row's window logits over its steps
    and the window's committed latent and rope rows, by relative L2,
    within MLA_F32_LIMITS. The control: the bfloat16 run with one latent
    row (the short row's position 5) zeroed in every layer's pool where
    attention reads it, which must land above the logits limits."""
    import dataclasses

    import torch

    from dynamo_tpu_torch.models import mla

    ps = engine.ecfg.page_size
    routes = []
    ROUTED.update(differ=0, rows=0)

    def run(params, c, record):
        return routed(lambda: path_run(params, c, dev, True, ps=ps), routes,
                      record=record, mla=True)

    bf = run(engine.params, cfg, True)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = {k: v.float() for k, v in engine.params.items()}
    f32 = run(p32, cfg32, False)
    del p32
    torch.cuda.empty_cache()

    def errs(a, b):
        rows = range(a[0].shape[0])
        return {"prefill_rel_l2": max(rel_l2(a[0][r], b[0][r])
                                      for r in rows),
                "window_rel_l2": max(rel_l2(a[1][:, r], b[1][:, r])
                                     for r in rows),
                "window_kv_rel_l2": rel_l2(a[2].float(), b[2].float()),
                "prefill_rel_l2_by_row": [rel_l2(a[0][r], b[0][r])
                                          for r in rows],
                "window_rel_l2_by_row": [rel_l2(a[1][:, r], b[1][:, r])
                                         for r in rows]}

    sound = errs(bf, f32)
    # the fault: path_run's short row (row 2) holds its positions on page
    # 1 + 2 * per of the fresh pools; its position 5 reads as zeros
    per = -(-(max(PATH_LENS) + PATH_K) // ps) + 1
    page = 1 + 2 * per
    real = mla._mla_attention

    def zeroed(q_lat, q_rope, c_pages, *args):
        c = c_pages.clone()
        c[page, :, 5] = 0
        return real(q_lat, q_rope, c, *args)

    mla._mla_attention = zeroed
    try:
        control = errs(run(engine.params, cfg, False), f32)
    finally:
        mla._mla_attention = real
    log(f"  bf16 vs float32 (teacher-forced): {json.dumps(sound)}; "
        f"control (a latent row zeroed): {json.dumps(control)}; limits "
        f"{json.dumps(MLA_F32_LIMITS)}; routing: {ROUTED['differ']} of "
        f"{ROUTED['rows']} token-layers of the float32 runs would have "
        f"picked another expert set")
    for key, limit in MLA_F32_LIMITS.items():
        if sound[key] > limit:
            fail(f"MLA bf16 vs float32: {key} {sound[key]:.4g} > {limit}")
    for key in ("prefill_rel_l2", "window_rel_l2"):
        if control[key] <= MLA_F32_LIMITS[key]:
            fail(f"MLA control fault stays within the {key} limit "
                 f"({control[key]:.4g}): the check is blind")
    return {"sound": sound, "control": control, "limits": MLA_F32_LIMITS}


def mla_attention_case(dev, name: str, widths: dict, chunk: int = 0,
                       seed: int = 0) -> dict:
    """Phase 20 (b): one MLA attention layer (``models/mla.py
    _mla_block``: q and latent projections, the latent write, absorbed
    attention over the row's pages, ``w_uv`` and ``w_o``) of seed-0
    bfloat16 weights at ``widths``, on the 4-row served window (rows at
    WINDOW_CONTEXTS, its bucket's 64-page table) and, with ``chunk``, a
    first chunk of that many tokens (its bucket's 8-page table): each
    against the same block in float32 (the bfloat16 weights, inputs and
    pools upcast) within MLA_BLOCK_REL_L2, timed, beside its bound: the
    weights, the rows' latents and the input and output moved once, or
    the products (bf16 projections at the bf16 peak, the float32 latent
    einsums over each query's visible keys at the float32 peak). The
    library column: one ``scaled_dot_product_attention`` call on the same
    absorbed work in bfloat16 (:func:`sdpa_latent_ms`), the yardstick of
    a latent-attention kernel."""
    import math

    import torch

    from dynamo_tpu_torch.models import mla
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.models.llama import (_drop_plan, rope_cos_sin,
                                               rope_freqs)

    cfg = ModelConfig(model_type="deepseek_v3", num_layers=1, vocab_size=8,
                      intermediate_size=8, num_kv_heads=widths["num_heads"],
                      rope_theta=10000.0, dtype="bfloat16", **widths)
    D, H = cfg.hidden_size, cfg.num_heads
    r, dr, dn, dv = (cfg.kv_lora_rank, cfg.qk_rope_head_dim,
                     cfg.qk_nope_head_dim, cfg.v_head_dim)
    g = torch.Generator(device=dev).manual_seed(seed)
    lp = {}
    for key, kind, shape in mla.param_table(cfg):
        if key not in mla._mla_attn_keys(cfg):
            continue
        shape = shape[1:]
        t = (torch.randn(shape, generator=g, device=dev) / math.sqrt(
            shape[-2]) if kind == "w" else torch.ones(shape, device=dev))
        lp[key] = t.to(torch.bfloat16)
    lp32 = {k: v.float() for k, v in lp.items()}
    weight_bytes = sum(v.nbytes for k, v in lp.items()
                       if k not in ("ln_attn", "ln_mlp"))
    ps = 64
    inv = rope_freqs(cfg, dim=dr, device=dev)

    def case(B, T, P, starts, lens):
        per = P
        N = 1 + B * per
        c = torch.randn((N, 1, ps, r), generator=g, device=dev).to(
            torch.bfloat16)
        kr = torch.randn((N, 1, ps, dr), generator=g, device=dev).to(
            torch.bfloat16)
        table = torch.zeros((B, P), dtype=torch.int32, device=dev)
        pos = torch.full((B, T), -1, dtype=torch.int32, device=dev)
        slots = torch.full((B, T), 1 << 30, dtype=torch.int32, device=dev)
        for b, (s0, n) in enumerate(zip(starts, lens)):
            npg = -(-(s0 + n) // ps)
            table[b, :npg] = torch.arange(1 + b * per, 1 + b * per + npg,
                                          device=dev)
            p = torch.arange(s0, s0 + n, device=dev)
            pos[b, :n] = p
            slots[b, :n] = table[b, p // ps] * ps + p % ps
        x = torch.randn((B, T, D), generator=g, device=dev).to(torch.bfloat16)
        rope = rope_cos_sin(pos.clamp(min=0), inv)
        plan = _drop_plan(slots.reshape(-1).long(), N * ps)

        def run(params, x_, c_, kr_):
            return mla._mla_block(cfg, params, x_, rope, c_, kr_, table, pos,
                                  slots, plan, H)

        got = run(lp, x, c.clone(), kr.clone())
        ref = run(lp32, x.float(), c.float(), kr.float())
        err = rel_l2(got, ref)
        if not bool(torch.isfinite(got).all()) or err > MLA_BLOCK_REL_L2:
            fail(f"MLA attention {name} [{B}, {T}]: rel_l2 {err:.4g} > "
                 f"{MLA_BLOCK_REL_L2} (or non-finite)")
        ms = time_ms(lambda: run(lp, x, c, kr), iters=10)
        # keys each query sees: its own position and those before it
        keys = sum((s0 + i + 1) for s0, n in zip(starts, lens)
                   for i in range(n))
        q_in = D * cfg.q_lora_rank + cfg.q_lora_rank * H * (dn + dr) \
            if cfg.q_lora_rank else D * H * (dn + dr)
        rows = B * T
        ops_bf16 = 2 * rows * (q_in + D * (r + dr) + H * dv * D)
        ops_f32 = 2 * (rows * H * dn * r + H * (r + dr) * keys
                       + H * r * keys + rows * H * r * dv)
        moved = (weight_bytes + 2 * rows * D * 2
                 + sum(s0 + n for s0, n in zip(starts, lens)) * (r + dr) * 2)
        by_bytes = moved / H100_BYTES_PER_S
        by_ops = ops_bf16 / H100_BF16_FLOPS + ops_f32 / H100_F32_FLOPS
        return {"rel_l2": err, "ms": ms,
                "library_ms": sdpa_latent_ms(dev, g, H, r, dr,
                                             1.0 / math.sqrt(dn + dr),
                                             T, starts, lens),
                "bound_ms": max(by_bytes, by_ops) * 1e3,
                "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                "bytes": moved, "ops_bf16": ops_bf16, "ops_f32": ops_f32,
                "table_positions": P * ps}

    rep = {"widths": widths, "weight_bytes": weight_bytes,
           "window_4_rows": case(4, 1, 64, WINDOW_CONTEXTS, [1] * 4)}
    if chunk:
        rep[f"first_chunk_{chunk}"] = case(1, chunk, 8, [0], [chunk])
    log(f"  MLA attention block {name}: {json.dumps(rep)}")
    return rep


def sdpa_latent_ms(dev, g, H: int, r: int, dr: int, scale: float, T: int,
                   starts: list, lens: list) -> float:
    """ms of one ``torch.nn.functional.scaled_dot_product_attention`` call
    on MLA's absorbed attention in bfloat16: per row, H query heads of
    width r + dr (the latent and the rope part) against one shared "kv
    head" of the row's latents and rope keys (width r + dr, values the
    latents of width r), each query over its row's positions up to its
    own (the rows' own lengths, by a boolean mask); MLA's softmax scale."""
    import torch

    B = len(starts)
    S = max(s0 + n for s0, n in zip(starts, lens))
    q = torch.randn((B, H, T, r + dr), generator=g, device=dev).to(
        torch.bfloat16)
    kv = torch.randn((B, 1, S, r + dr), generator=g, device=dev).to(
        torch.bfloat16)
    k, v = kv.expand(B, H, S, r + dr), kv[..., :r].expand(B, H, S, r)
    qpos = torch.tensor([[s0 + min(i, n - 1) for i in range(T)]
                         for s0, n in zip(starts, lens)], device=dev)
    mask = (torch.arange(S, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale)

    if call().shape != (B, H, T, r):
        fail("SDPA on the absorbed MLA attention: wrong shape")
    return time_ms(call, iters=10)


def deepseek_router_case(dev, seed: int = 0) -> dict:
    """Phase 20 (b): DeepSeek-V3's router (``_deepseek_gate``, v3:
    sigmoid scores, a nonzero selection bias, 8 groups ranked by their
    top-2 sums, the top 4 kept, renormalised, scaled by 2.5) on
    ROUTER_TOKENS bfloat16 tokens and bfloat16 weights, against the
    float32 tokens and weights they were rounded from: the same expert
    sets except at near-ties (ROUTER_TIE), the weights of the same sets
    within ROUTER_WEIGHT_ATOL; timed, beside its bound (the tokens and
    the router read once, or the float32 product at the float32 peak)."""
    import torch

    from dynamo_tpu_torch.models import mla
    from dynamo_tpu_torch.models.config import ModelConfig

    w = DEEPSEEK_V3_ROUTER
    D, E, k = w["hidden_size"], w["num_experts"], w["num_experts_per_tok"]
    G, TG, N = w["n_group"], w["topk_group"], ROUTER_TOKENS
    cfg = ModelConfig(model_type="deepseek_v3", moe_router="deepseek_v3",
                      kv_lora_rank=512, norm_topk_prob=True, **w)
    g = torch.Generator(device=dev).manual_seed(seed)
    w32 = torch.randn((D, E), generator=g, device=dev) / D ** 0.5
    b32 = torch.randn((E,), generator=g, device=dev) * 0.1
    x32 = torch.randn((N, D), generator=g, device=dev)
    wb, bb, xb = (t.to(torch.bfloat16) for t in (w32, b32, x32))
    got_w, got_i = mla._deepseek_gate(xb.float(), wb, bb, cfg)
    ref_w, ref_i = mla._deepseek_gate(x32, w32, b32, cfg)
    # the float32 selection's margins: experts (after the group mask) and
    # groups
    _, choice = mla.deepseek_scores(x32, w32, b32, cfg)
    gs = choice.view(N, G, E // G).topk(2, dim=-1).values.sum(-1)
    gsort = gs.sort(-1, descending=True).values
    g_margin = gsort[:, TG - 1] - gsort[:, TG]
    keep = torch.zeros_like(gs).scatter_(-1, gs.topk(TG, -1).indices, 1.0)
    masked = torch.where(keep[:, :, None] > 0, choice.view(N, G, E // G),
                         torch.zeros_like(choice.view(N, G, E // G)))
    csort = masked.reshape(N, E).sort(-1, descending=True).values
    e_margin = csort[:, k - 1] - csort[:, k]
    margin = torch.minimum(g_margin, e_margin)
    gs_, gi = got_i.sort(-1)
    rs_, ri = ref_i.sort(-1)
    same = (gs_ == rs_).all(-1)
    differ_margins = margin[~same]
    w_err = float((got_w.gather(-1, gi) - ref_w.gather(-1, ri))[same]
                  .abs().max())
    rep = {"tokens": N, "rows_differ": int((~same).sum()),
           "max_margin_of_differing": float(differ_margins.max())
           if differ_margins.numel() else 0.0,
           "min_margin": float(margin.min()), "weight_max_abs_err": w_err}
    if differ_margins.numel() and rep["max_margin_of_differing"] >= ROUTER_TIE:
        fail(f"V3 router: a token's experts differ away from a near-tie "
             f"{json.dumps(rep)}")
    if w_err > ROUTER_WEIGHT_ATOL:
        fail(f"V3 router: weights differ by {w_err:.4g} > "
             f"{ROUTER_WEIGHT_ATOL}")
    rep["ms"] = time_ms(lambda: mla._deepseek_gate(xb.float(), wb, bb, cfg),
                        iters=10)
    moved = N * D * 2 + D * E * 2 + E * 2 + N * k * (4 + 8)
    by_bytes = moved / H100_BYTES_PER_S
    by_ops = 2 * N * D * E / H100_F32_FLOPS
    rep.update(bound_ms=max(by_bytes, by_ops) * 1e3,
               bound_by="bytes" if by_bytes >= by_ops else "operations")
    log(f"  V3 router: {json.dumps(rep)}")
    return rep


def deepseek_moe_case(dev, cfg, N: int = 2048, seed: int = 0) -> dict:
    """Phase 20 (b): V2-Lite's MoE block (``_deepseek_moe_mlp``: the v2
    router, 64 routed experts top 6 and 2 shared experts) of seed-0
    bfloat16 weights, on 4 rows (the dense sum) and on N tokens (the
    blocked dispatch, then the dense sum on the same routing): each
    replayed twice from a CUDA graph (the same bits), against each other
    and against the float32 computation expert by expert
    (MOE_REL_L2), and timed: the whole block at 4 rows and at N, the
    dense sum at N, beside their bounds."""
    import math

    import torch

    from dynamo_tpu_torch.models import llama, mla

    D, E, k = cfg.hidden_size, cfg.num_experts, cfg.num_experts_per_tok
    Im = cfg.moe_intermediate_size
    Is = Im * cfg.n_shared_experts
    g = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape):
        x = torch.randn(shape, generator=g, device=dev)
        return x.mul_(1.0 / math.sqrt(shape[-2])).to(torch.bfloat16)

    lp = {"w_router": w(D, E), "w_gate_e": w(E, D, Im),
          "w_up_e": w(E, D, Im), "w_down_e": w(E, Im, D),
          "w_gate_s": w(D, Is), "w_up_s": w(D, Is), "w_down_s": w(Is, D)}
    h = torch.randn((1, N, D), generator=g, device=dev).to(torch.bfloat16)
    block = llama._MOE_BLOCK
    if not llama._moe_use_blocked(None, N, E, k, block) or \
            llama._moe_use_blocked(None, 4, E, k, block):
        fail(f"the cost model does not take the blocked dispatch at {N} "
             f"tokens and the dense sum at 4")
    out = {}
    for rows in (4, N):
        x = h[0, :rows]
        weights, idx = mla._deepseek_gate(x.float(), lp["w_router"], None,
                                          cfg)
        s32 = [lp[k_].float() for k_ in ("w_gate_s", "w_up_s", "w_down_s")]
        x32 = x.float()
        ref = moe_f32_reference(x, weights, idx, lp["w_gate_e"],
                                lp["w_up_e"], lp["w_down_e"]) \
            + llama._mlp(x32, *s32)

        def shared():
            return llama._mlp(x, lp["w_gate_s"], lp["w_up_s"],
                              lp["w_down_s"]).float()

        fns = {"dense": lambda: llama.moe_experts_dense(
            x, weights, idx, lp["w_gate_e"], lp["w_up_e"],
            lp["w_down_e"]) + shared()}
        if rows == N:
            fns["blocked"] = lambda: llama.moe_experts_blocked(
                x, weights, idx, lp["w_gate_e"], lp["w_up_e"],
                lp["w_down_e"], block=block) + shared()
        got = {}
        for strategy, fn in fns.items():
            a, b = graph_twice(fn)
            if not torch.equal(a, b) or not bool(torch.isfinite(a).all()):
                fail(f"V2-Lite MoE {strategy} at {rows}: replays differ or "
                     f"non-finite")
            got[strategy] = a
        errs = {f"{s}_vs_f32": rel_l2(v, ref) for s, v in got.items()}
        if "blocked" in got:
            errs["blocked_vs_dense"] = rel_l2(got["blocked"], got["dense"])
        for key, err in errs.items():
            if err > MOE_REL_L2:
                fail(f"V2-Lite MoE at {rows}: {key} rel_l2 {err:.4g} > "
                     f"{MOE_REL_L2}")
        out[f"rel_l2_{rows}"] = errs
    h4 = h[:, :4].reshape(4, 1, D).contiguous()
    x = h[0]
    weights, idx = mla._deepseek_gate(x.float(), lp["w_router"], None, cfg)
    expert_bytes = 3 * E * D * Im * 2
    shared_bytes = 3 * D * Is * 2
    out.update({
        "block_4_dense_ms": time_ms(
            lambda: mla._deepseek_moe_mlp(h4, lp, cfg), iters=20),
        f"block_{N}_blocked_ms": time_ms(
            lambda: mla._deepseek_moe_mlp(h, lp, cfg), iters=3),
        f"dense_sum_{N}_ms": time_ms(
            lambda: llama.moe_experts_dense(x, weights, idx, lp["w_gate_e"],
                                            lp["w_up_e"], lp["w_down_e"]),
            iters=3),
        # 4 rows read every expert and the shared experts
        "block_4_dense_bound_ms": (expert_bytes + shared_bytes)
        / H100_BYTES_PER_S * 1e3,
        # N tokens: each token's k experts and the shared experts, or the
        # weights read once, whichever is longer
        f"block_{N}_blocked_bound_ms": max(
            2 * 3 * N * (k * D * Im + D * Is) / H100_BF16_FLOPS,
            (expert_bytes + shared_bytes) / H100_BYTES_PER_S) * 1e3,
        "blocks": -(-N * k // block) + E, "block": block})
    log(f"  V2-Lite MoE block: {json.dumps(out)}")
    return out


def mla_window_share(engine, attn_4_ms: float, moe_4_ms: float) -> dict:
    """A 4-row greedy window of the served model timed on the card (its
    generic window, the 64-page bucket's table: :func:`window_4_rows_ms`),
    and the shares the blocks take of it: attention (layers x steps x one
    4-row block) and the MoE blocks (MoE layers x steps x one 4-row
    block)."""
    cfg, K = engine.cfg, engine.ecfg.decode_steps
    ms = window_4_rows_ms(engine, table_pages=64)
    attn = cfg.num_layers * K * attn_4_ms
    moe = (cfg.num_layers - cfg.first_k_dense_replace) * K * moe_4_ms
    return {"window_4_rows_ms": ms, "attention_ms": attn,
            "attention_share": attn / ms, "moe_blocks_ms": moe,
            "moe_share": moe / ms, "contexts": WINDOW_CONTEXTS, "steps": K}


def mla_phase(dev) -> dict:
    """Phase 20: MLA at DeepSeek-V2-Lite's widths (the docstring's (a),
    (b) and (c))."""
    import torch

    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.ops import int8_gemm
    from dynamo_tpu_torch.ops import paged_attention as ops

    t_phase = time.monotonic()
    cfg = mla_cfg()
    prompts = moe_prompts()

    # (a) served, bfloat16
    engine = mla_engine(cfg)
    mdc = ModelDeploymentCard(name="deepseek-v2-lite-4-layers-random")
    mdc.kv_block_size = engine.ecfg.page_size

    async def serve():
        ops.reset_launch_counts()
        packed = await serve_packed(engine, prompts, MLA_MAX_TOKENS)
        packed["prefill_replays"] = by_dispatch(cfg, prefill_replays(engine))
        packed["launches"] = dict(ops.LAUNCHES)
        packed["compiles"] = engine.stats()["post_warmup_compiles_total"]
        served, _, _ = await serve_and_check(engine, mdc)
        return packed, served

    t = time.monotonic()
    packed, served = asyncio.run(serve())
    replays = prefill_replays(engine)
    dispatch = by_dispatch(cfg, replays)
    windows = decode_replays(engine)
    log(f"  packed batch: {json.dumps(packed)}")
    log(f"  served in {time.monotonic() - t:.1f}s: {json.dumps(served)}")
    log(f"  prefill replays by bucket: "
        f"{json.dumps({str(k): v for k, v in sorted(replays.items())})}; "
        f"by expert dispatch {json.dumps(dispatch)}; window replays "
        f"{json.dumps({str(k): v for k, v in sorted(windows.items())})}")
    if any(packed["launches"].values()) or packed["compiles"]:
        fail(f"MLA packed batch: attention launches {packed['launches']}, "
             f"{packed['compiles']} captures")
    if packed["prefill_replays"]["blocked"] <= 0:
        fail(f"the packed prompts took no blocked dispatch: "
             f"{json.dumps(packed['prefill_replays'])}")
    if dispatch["blocked"] <= 0 or dispatch["dense"] <= 0 or not windows:
        fail(f"served replays by dispatch {dispatch}, windows {windows}: "
             f"both expert dispatches must have served")
    graph_window = check_graph_window(engine, cfg, dev)
    graph_prefill = check_graph_prefill(engine, dev)
    t = time.monotonic()
    f32 = mla_f32_check(engine, cfg, dev)
    log(f"  bf16 vs float32 check in {time.monotonic() - t:.1f}s")

    # (b) the blocks alone
    t = time.monotonic()
    lite_widths = {"hidden_size": cfg.hidden_size, "num_heads": cfg.num_heads,
                   "q_lora_rank": 0, "kv_lora_rank": cfg.kv_lora_rank,
                   "qk_nope_head_dim": cfg.qk_nope_head_dim,
                   "qk_rope_head_dim": cfg.qk_rope_head_dim,
                   "v_head_dim": cfg.v_head_dim}
    blocks = {"attention_v2_lite": mla_attention_case(
                  dev, "v2-lite", lite_widths, chunk=512),
              "attention_v3": mla_attention_case(dev, "v3", DEEPSEEK_V3_ATTN,
                                                 chunk=512),
              "router_v3": deepseek_router_case(dev),
              "moe_v2_lite": deepseek_moe_case(dev, cfg)}
    share = mla_window_share(
        engine, blocks["attention_v2_lite"]["window_4_rows"]["ms"],
        blocks["moe_v2_lite"]["block_4_dense_ms"])
    log(f"  4-row window: {json.dumps(share)}; blocks in "
        f"{time.monotonic() - t:.1f}s")
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # (c) int8 weights
    engine = mla_engine(cfg, quant="int8")
    ops.reset_launch_counts()
    int8_gemm.reset_launch_counts()
    t = time.monotonic()
    packed8 = asyncio.run(serve_packed(engine, prompts, MLA_MAX_TOKENS))
    launched = dict(int8_gemm.INT8_GEMM_LAUNCHES)
    packed8["launches"] = dict(ops.LAUNCHES)
    log(f"  int8 packed batch in {time.monotonic() - t:.1f}s: "
        f"{json.dumps(packed8)}")
    pf8, dec8 = prefill_replays(engine), decode_replays(engine)
    want = int8_mla_launches(engine, dec8, pf8)
    blocked8 = {str(k): bk.counts for gs in engine.prefill_variants.values()
                for k, bk in gs.buckets.items()
                if pf8.get(k) and moe_dispatch(cfg, k) == "blocked"}
    window8 = {str(k): bk.counts for gs in engine.decode_variants.values()
               for k, bk in gs.buckets.items() if dec8.get(k)}
    if any(packed8["launches"].values()):
        fail(f"int8 MLA engine launched attention kernels: "
             f"{packed8['launches']}")
    if sum(launched.values()) != want:
        fail(f"int8 GEMM launches {launched} != the replayed buckets' "
             f"{want}")
    if not blocked8 or not all(
            any(c.get("wgmma", 0) > 0 for c in counts)
            for counts in blocked8.values()):
        fail(f"the blocked prefill's expert products are not on wgmma: "
             f"{blocked8}")
    if not window8 or not all(
            any(c.get("small_m", 0) > 0 for c in counts)
            for counts in window8.values()):
        fail(f"the windows' products are not on small_m: {window8}")
    if engine.stats()["post_warmup_compiles_total"] != 0:
        fail("int8 MLA engine captured graphs while serving")
    paths8, _ = check_paths(engine, cfg, dev)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.monotonic() - t_phase
    log(f"  phase 20: served ITL mean {served['itl_ms_mean']} ms, TTFT "
        f"{served['ttft_ms']} ms (HTTP, four at once); packed ITL mean "
        f"{packed['itl_ms_mean']} ms, TTFT {packed['ttft_ms']} ms; int8 "
        f"packed ITL mean {packed8['itl_ms_mean']} ms, TTFT "
        f"{packed8['ttft_ms']} ms; int8 launches {json.dumps(launched)}; "
        f"{seconds:.1f}s")
    return {"config": dict(DEEPSEEK_V2_LITE,
                           num_hidden_layers=DEEPSEEK_LAYERS),
            "packed": packed, "served": served, "dispatch": dispatch,
            "window_replays": {str(k): v for k, v in windows.items()},
            "graph_window": graph_window, "graph_prefill": graph_prefill,
            "f32": f32, "blocks": blocks, "window_share": share,
            "int8": {"packed": packed8, "launches": launched,
                     "expected_launches": want, "paths": paths8},
            "seconds": seconds}


# ------------------------------------------ the synchronous decode arms


# phase 15's traffic, as token ids of the 8B's vocabulary (a marker first,
# so that no prompt shares a page with an earlier phase's): phase 4's four
# requests, a 2,048-token prompt sent while they decode, a greedy prompt
# repeating a 40-token passage three times (the drafter's case), and a
# sampled and a logprobs request, which bypass speculation
SYNC_MARK = [128000, 128001]
SYNC_LONG, SYNC_LONG_AFTER_S = 2048, 0.3
SYNC_PASSAGE = 40
# the arms' engines: (name, how built, EngineConfig fields or launcher
# flags). (b) and (c) trim their bucket grids to the batch phase 15's
# traffic reaches (max_batch 8: decode batches 1, 2, 4, 8)
SYNC_ENGINES = (
    # the default engine, its grid stopped at the traffic's batch (the
    # buckets the traffic takes are the default's)
    ("default", "EngineConfig", dict(max_batch=TRAFFIC_MAX_BATCH)),
    ("a budget", "launcher", ["--prefill-token-budget", "256",
                              "--max-batch-size", str(TRAFFIC_MAX_BATCH)]),
    ("b spec", "launcher", ["--spec-decode", "--spec-tokens", "4",
                            "--prefill-token-budget", "256",
                            "--max-batch-size", "8"]),
    ("c single step", "EngineConfig", dict(decode_steps=1,
                                           prefill_token_budget=256,
                                           max_batch=8)),
    # the default engine emitting token by token (its grid stopped at
    # the traffic's batch: the buckets it takes are the default's)
    ("d per token", "EngineConfig", dict(coalesce_window_emissions=False,
                                         max_batch=TRAFFIC_MAX_BATCH)))


def sync_requests() -> list:
    """Phase 15's requests: (id, prompt ids, max tokens, delay s,
    sampling fields, logprobs)."""
    import numpy as np

    rng = np.random.RandomState(15)
    reqs = []
    for i, (_, text, n) in enumerate(SOLO):
        reqs.append((f"p4-{i}", SYNC_MARK + list(text.encode()), n, 0.0,
                     None, None))
    reqs.append(("long", SYNC_MARK + [int(x) for x in rng.randint(
        1000, 100000, SYNC_LONG - len(SYNC_MARK))], 16, SYNC_LONG_AFTER_S,
        None, None))
    passage = [int(x) for x in rng.randint(1000, 100000, SYNC_PASSAGE)]
    reqs.append(("repeat", SYNC_MARK + passage * 3, 64, 0.0, None, None))
    reqs.append(("sampled", SYNC_MARK + list(b"Sample a short story."), 24,
                 0.0, dict(temperature=0.8, top_p=0.95, seed=11), None))
    reqs.append(("logprobs", SYNC_MARK + list(b"Rate this answer."), 24,
                 0.0, None, 5))
    return reqs


async def sync_traffic(engine) -> dict:
    """Phase 15's requests on ``engine`` (its generate, the entry point
    the HTTP front end calls): per request its tokens, TTFT and the
    gaps between token arrivals (ITL, one gap spread over the tokens of
    a chunk)."""
    from dynamo_tpu_torch.llm.protocols.common import (OutputOptions,
                                                       PreprocessedRequest,
                                                       SamplingOptions,
                                                       StopConditions)
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(rid, ids, n, delay, samp, lp):
        await asyncio.sleep(delay)
        req = PreprocessedRequest(token_ids=ids, stop=StopConditions(
            max_tokens=n, ignore_eos=True))
        if samp:
            req.sampling = SamplingOptions(**samp)
        if lp:
            req.output = OutputOptions(logprobs=lp)
        sent, last, toks, itl, ttft = time.monotonic(), None, [], [], None
        widest = 0
        async for out in engine.generate(req, Context()):
            widest = max(widest, len(out.token_ids))
            if out.token_ids:
                now = time.monotonic()
                if last is None:
                    ttft = now - sent
                else:
                    itl += [(now - last) / len(out.token_ids)] * len(
                        out.token_ids)
                last = now
                toks += out.token_ids
        return rid, {"tokens": toks, "ttft_ms": ttft * 1e3,
                     "itl_ms": [x * 1e3 for x in itl], "widest": widest}

    try:
        got = dict(await asyncio.gather(*[one(*r) for r in sync_requests()]))
    finally:
        await engine.stop()
    itl = [x for r in got.values() for x in r["itl_ms"]]
    return {"requests": got,
            "itl_mean_ms": sum(itl) / max(len(itl), 1),
            "itl_max_ms": max(itl, default=0.0),
            "ttft_ms": {k: r["ttft_ms"] for k, r in got.items()}}


# the verify and single-step checks' inputs: check_paths' rows (a full
# chunk, a padded row, a short row), then K = 4 drafts verified from each
# row's length (positions 512, 300 and 12: on, mid and early in a page of
# 64) and two single steps there
SPEC_PATH_K = 4


def spec_path_run(params, cfg, dev, use: bool, ps: int = 64) -> tuple:
    """check_paths' prefill rows on fresh pools, then two single decode
    steps (teacher-forced tokens) and, on the pools as the prefill left
    them, one [B, K+1] verify step of teacher-forced drafts (every
    position's logits): (step logits [2, B, V], verify logits [B, K+1,
    V])."""
    import torch

    from dynamo_tpu_torch.models.llama import (KVCacheSpec, init_kv_cache,
                                               make_step_fns, make_verify_fn)

    T, lens, K = PATH_T, PATH_LENS, SPEC_PATH_K
    B = len(lens)
    per = -(-(max(lens) + K + 2) // ps) + 1
    spec = KVCacheSpec(num_pages=max(64, 1 + B * per), page_size=ps)
    g = torch.Generator(device="cpu").manual_seed(6)
    tokens = torch.randint(0, 256, (B, T), generator=g, dtype=torch.int32)
    forced = torch.randint(0, 256, (B, K + 1), generator=g,
                           dtype=torch.int32)
    positions = torch.full((B, T), -1, dtype=torch.int32)
    table = torch.zeros((B, max(16, per)), dtype=torch.int32)
    slots = torch.full((B, T), 1 << 30, dtype=torch.int32)
    for b, n in enumerate(lens):
        positions[b, :n] = torch.arange(n)
        table[b, :per] = torch.arange(1 + per * b, 1 + per * (b + 1))
        p = torch.arange(n)
        slots[b, :n] = table[b, p // ps] * ps + p % ps
    last = torch.tensor([n - 1 for n in lens], dtype=torch.int32)
    pre, step = make_step_fns(cfg, use_kernels=use)
    verify = make_verify_fn(cfg, use_kernels=use)

    def prefilled():
        kk, vv = init_kv_cache(cfg, spec, device=dev)
        _, kk, vv = pre(params, tokens.to(dev), positions.to(dev), kk, vv,
                        table.to(dev), slots.to(dev), last.to(dev))
        return kk, vv

    def at(pos):  # [B, ...] flat slots of positions pos [B, ...]
        return (table.gather(1, (pos // ps).reshape(B, -1)).reshape(
            pos.shape) * ps + pos % ps).to(torch.int32)

    base = torch.tensor(lens, dtype=torch.int32)
    kk, vv = prefilled()
    steps = []
    for i in range(2):
        pos = base + i
        lg, kk, vv = step(params, forced[:, i].to(dev), pos.to(dev), kk, vv,
                          table.to(dev), at(pos).to(dev))
        steps.append(lg.float())
    kk, vv = prefilled()
    vpos = base[:, None] + torch.arange(K + 1, dtype=torch.int32)[None]
    vlog, _, _ = verify(params, forced.to(dev), vpos.to(dev), kk, vv,
                        table.to(dev), at(vpos).to(dev))
    torch.cuda.synchronize()
    return torch.stack(steps), vlog.float()


def check_spec_paths(params, cfg, dev) -> dict:
    """The single decode step and the verify step of the 8B, kernel path
    against plain path (:func:`spec_path_run`) at PATH_LIMITS' window
    limit (bf16 logits), with a control fault on each: single steps whose
    decode call misses the row's newest key, and a verify whose prefill
    call has each query miss its own key. Each control must land above
    the limit."""
    import torch

    from dynamo_tpu_torch.models import llama

    limit = PATH_LIMITS["window_logits"]
    kern = spec_path_run(params, cfg, dev, True)
    plain = spec_path_run(plain_params(params), cfg, dev, False)
    for side, out in (("kernel", kern), ("plain", plain)):
        if not all(bool(torch.isfinite(t).all()) for t in out):
            fail(f"phase 15 {side} path: non-finite logits")

    def errs(a):
        return {"step_logits": max_err(a[0], plain[0]),
                "verify_logits": max_err(a[1], plain[1]),
                "verify_logits_by_position": [
                    max_err(a[1][:, j], plain[1][:, j])
                    for j in range(a[1].shape[1])]}

    real_dec, real_pf = (llama.paged_attention_decode_layered,
                         llama.paged_attention_prefill)

    def dec_misses_newest(q, kp, vp, layer, table, lengths, **kw):
        return real_dec(q, kp, vp, layer, table,
                        (lengths - 1).clamp(min=0).to(torch.int32), **kw)

    def pf_misses_own(q, kp, vp, table, qpos, **kw):
        return real_pf(q, kp, vp, table,
                       torch.where(qpos >= 0, qpos - 1, qpos).to(torch.int32),
                       **kw)

    sound = errs(kern)
    control = {}
    for name, attr, fault in (
            ("step_misses_newest_key", "paged_attention_decode_layered",
             dec_misses_newest),
            ("verify_misses_own_key", "paged_attention_prefill",
             pf_misses_own)):
        setattr(llama, attr, fault)
        try:
            control[name] = errs(spec_path_run(params, cfg, dev, True))
        finally:
            setattr(llama, attr, real_dec if "decode" in attr else real_pf)
    log(f"  single step and verify, kernel vs plain path: "
        f"{json.dumps(sound)}; controls: {json.dumps(control)}")
    for key in ("step_logits", "verify_logits"):
        if sound[key] > limit:
            fail(f"phase 15: {key} kernel vs plain {sound[key]:.4g} > "
                 f"{limit}")
    if control["step_misses_newest_key"]["step_logits"] <= limit or \
            control["verify_misses_own_key"]["verify_logits"] <= limit:
        fail(f"phase 15: a control fault stays within {limit}: the check "
             f"is blind ({json.dumps(control)})")
    return {"sound": sound, "control": control, "limit": limit}


def margin_rule(params, cfg, dev, prompt: list, want: list, got: list,
                what: str):
    """``got`` against ``want``, greedy tokens of one prompt from two
    serving paths: "equal", or equal up to the first position whose top-2
    logit margin on the plain path (one forward over the prompt and
    ``want``'s tokens before it) is under the bf16 tolerance of a logit
    (PATH_LIMITS' window limit); such a position and its margin are
    reported, any other difference fails."""
    import torch

    first = next((i for i, (x, y) in enumerate(zip(want, got)) if x != y),
                 None)
    if first is None and len(want) == len(got):
        return "equal"
    first = min(len(want), len(got)) if first is None else first
    lg = plain_logits(params, cfg, dev, list(prompt) + want[:first])[-1]
    top2 = torch.topk(lg.float(), 2).values
    margin = float(top2[0] - top2[1])
    log(f"  {what}: first difference at generated position {first}, "
        f"plain-path top-2 margin {margin:.4g}")
    limit = PATH_LIMITS["window_logits"]
    if margin >= limit:
        fail(f"{what}: tokens differ at {first}, where the plain path's "
             f"margin {margin:.4g} >= {limit}")
    return {"first_difference": first, "plain_margin": margin}


def check_spec_tokens(params, cfg, dev, spec: dict, plain_arm: dict) -> dict:
    """Engine (b)'s greedy tokens against engine (a)'s under
    :func:`margin_rule`."""
    prompts = {rid: ids for rid, ids, *_ in sync_requests()}
    return {rid: margin_rule(params, cfg, dev, prompts[rid],
                             plain_arm["requests"][rid]["tokens"],
                             got["tokens"],
                             f"phase 15: (b) against (a), {rid}")
            for rid, got in spec["requests"].items() if rid != "sampled"}


def check_per_token(params, cfg, dev, per_token: dict, default: dict) -> dict:
    """Engine (d)'s greedy tokens against the default engine's under
    :func:`margin_rule` (the same windows; only the emission differs):
    every EngineOutput of (d) carries one token at most, and the default
    engine emitted some window row as one output of several tokens."""
    prompts = {rid: ids for rid, ids, *_ in sync_requests()}
    widest = {rid: r["widest"] for rid, r in per_token["requests"].items()}
    if max(widest.values()) != 1:
        fail(f"phase 15: (d) emitted several tokens at once: {widest}")
    if max(r["widest"] for r in default["requests"].values()) < 2:
        fail("phase 15: the default engine never coalesced a window row")
    return {rid: margin_rule(params, cfg, dev, prompts[rid],
                             default["requests"][rid]["tokens"],
                             got["tokens"],
                             f"phase 15: (d) against the default, {rid}")
            for rid, got in per_token["requests"].items()
            if rid != "sampled"}


def sync_arms_phase(cfg, dev, params) -> dict:
    """Phase 15: the reference's synchronous decode arms on the 8B at full
    width (32 layers, phase 4's seed-0 weights, shared), one engine at a
    time, each freed before the next (SYNC_ENGINES): the default engine,
    (a) ``--prefill-token-budget 256 --max-batch-size 8`` through the
    launcher's build_engine_config (pipelined windows with budgeted
    mixing), (b)
    ``--spec-decode --spec-tokens 4 --prefill-token-budget 256`` with
    ``--max-batch-size 8`` (its grid trimmed to the batch the traffic
    reaches), (c) ``EngineConfig(decode_steps=1, prefill_token_budget=
    256, max_batch=8)``, built directly (the reference has no flag for
    it). Each is warmed and serves the same traffic (sync_requests)
    through its generate; each must capture nothing after warmup, and
    (a)-(c) dispatch decode work beside a prefill (mixed_dispatches > 0).
    (b): its verify steps launch the prefill route 32 times each with
    its prefill chunks, its windows the decode route 32 x K times each,
    acceptance above 0 on the repeated passage, the sampled and logprobs
    requests never in a verify step, greedy tokens as (a)'s
    (:func:`check_spec_tokens`). (c): its single steps launch the decode
    route 32 times each. (d), the default engine with
    ``coalesce_window_emissions=False``: one token an EngineOutput, its
    greedy tokens the default engine's (:func:`check_per_token`). Then
    the single step and the verify step,
    kernel path against plain path (:func:`check_spec_paths`). Records
    ITL mean and max and TTFT of each engine."""
    import dataclasses

    import torch

    from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.ops import paged_attention as ops
    from dynamo_tpu_torch.run import build_engine_config, parse_args

    L = cfg.num_layers
    report = {}
    for name, how, conf in SYNC_ENGINES:
        if how == "launcher":
            ecfg = build_engine_config(parse_args(
                ["in=http", "out=torch", "--model", "8b", *conf]))
        else:
            ecfg = dataclasses.replace(EngineConfig(), **conf)
        t = time.monotonic()
        engine = TorchEngine(cfg, ecfg, params=params, device="cuda")
        n_graphs = engine.warmup()
        warm_s = time.monotonic() - t
        verified = []  # the requests of every verify step's rows
        if engine.verify_fn is not None:
            rid_of = {tuple(ids): rid for rid, ids, *_ in sync_requests()}
            real = engine._decode_step_spec

            def spy(batch, drafts, real=real):
                verified.extend(rid_of.get(tuple(s.req.token_ids))
                                for s in batch)
                return real(batch, drafts)
            engine._decode_step_spec = spy
        ops.reset_launch_counts()
        t = time.monotonic()
        got = asyncio.run(sync_traffic(engine))
        torch.cuda.synchronize()
        stats = engine.stats()
        replays = engine.graph_replays()
        got.update({
            "warmup_s": warm_s, "graphs": n_graphs,
            "serve_s": time.monotonic() - t,
            "post_warmup_compiles_total": stats["post_warmup_compiles_total"],
            "mixed_dispatches": engine.mixed_dispatches,
            "graph_replays": replays,
            "route_launches": dict(ops.DECODE_ROUTE_LAUNCHES),
            "prefill_route_launches": dict(ops.PREFILL_ROUTE_LAUNCHES),
            **{k: stats[k] for k in stats if k.startswith("spec_decode")}})
        log(f"  {name}: warmed {n_graphs} graphs in {warm_s:.1f}s, served in "
            f"{got['serve_s']:.1f}s; ITL mean {got['itl_mean_ms']:.2f} ms, "
            f"max {got['itl_max_ms']:.2f} ms; TTFT ms "
            f"{json.dumps({k: round(v, 1) for k, v in got['ttft_ms'].items()})}"
            f"; mixed {engine.mixed_dispatches}; replays {json.dumps(replays)}"
            f"; spec {json.dumps({k: v for k, v in got.items() if k.startswith('spec_decode')})}")
        if got["post_warmup_compiles_total"] != 0:
            fail(f"phase 15 {name}: captures after warmup")
        if (ecfg.prefill_token_budget is not None
                and engine.mixed_dispatches <= 0):
            fail(f"phase 15 {name}: no decode dispatched beside a prefill")
        dec = got["route_launches"]["bf16_mma"]
        pf = got["prefill_route_launches"]["bf16"]
        if sum(got["route_launches"].values()) != dec or sum(
                got["prefill_route_launches"].values()) != pf:
            fail(f"phase 15 {name}: attention off the 8B's routes: "
                 f"{json.dumps(got)}")
        want_dec = (replays["decode_window"] * ecfg.decode_steps
                    + replays["decode_step"]) * L
        want_pf = (replays["prefill"] + replays["spec_verify"]) * L
        if dec != want_dec or pf != want_pf:
            fail(f"phase 15 {name}: decode launches {dec} != {want_dec} or "
                 f"prefill launches {pf} != {want_pf} (replays x {L})")
        if name.startswith("c") and (replays["decode_step"] <= 0
                                     or replays["decode_window"] != 0):
            fail(f"phase 15 {name}: not on the single-step arm")
        if name.startswith("b"):
            if replays["spec_verify"] <= 0:
                fail(f"phase 15 {name}: no verify step")
            if got["spec_decode_acceptance_rate"] <= 0:
                fail(f"phase 15 {name}: no draft accepted")
            if {"sampled", "logprobs"} & set(verified):
                fail(f"phase 15 {name}: a bypass row took a verify step")
            if "repeat" not in verified:
                fail(f"phase 15 {name}: the repeated passage was never "
                     f"verified")
        for rid, r in got["requests"].items():
            n = next(m for i, _, m, *_ in sync_requests() if i == rid)
            if len(r["tokens"]) != n:
                fail(f"phase 15 {name}: {rid} gave {len(r['tokens'])} of "
                     f"{n} tokens")
        report[name] = got
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    report["spec_tokens_vs_budget"] = check_spec_tokens(
        params, cfg, dev, report["b spec"], report["a budget"])
    report["per_token_vs_default"] = check_per_token(
        params, cfg, dev, report["d per token"], report["default"])
    report["paths"] = check_spec_paths(params, cfg, dev)
    return report


# ------------------------------------------- phase 16: distributed runtime

# (a): the worker's endpoint; the frontend must drop the model within the
# lease TTL (DYN_LEASE_TTL's default) of the worker's SIGTERM
DYN_ENDPOINT = "dyn://dynamo.llama8b.generate"
DYN_LEASE_TTL_S = 10.0
# phase 4's cold batch (request id, kind, prompt, max tokens, stream), sent
# at once to the frontend, then one more streaming request
DYN_LONG = ("The quick brown fox jumps over the lazy dog. " * 14)[:600]
DYN_BATCH = [("r0-stream", "chat", "Tell me about paged attention.", 32,
              True),
             ("r1-stream", "chat", DYN_LONG, 32, True),
             ("r2-unary", "chat", "What is an H100?", 24, False),
             ("r3-completion", "completion", "Once upon a time", 24, False)]
# the stream the worker drains: SIGTERM goes after its first chunk, and it
# must still end in [DONE] with all its tokens, before the worker exits 0
# within the drain budget (DYN_DRAIN_TIMEOUT_MS's default)
DYN_STREAM = ("r4-drain", "chat", "Stream one more answer.", 64, True)
DYN_DRAIN_TIMEOUT_S = 10.0
# (b): a shared prefix of 10 pages of 64 with four 32-token suffixes, then
# a prompt of the same length with a fresh prefix
ROUTED_PREFIX, ROUTED_SUFFIX, ROUTED_N = 640, 32, 4
ROUTED_MAX_TOKENS = 16
ROUTED_POLL_S = 5.0  # events arrive every 0.25 s (KvEventPublisher)
# (b)'s resume: phase 4's long prompt as a greedy stream of 64 tokens,
# whose handle dies under its 4th frame (the first token, then a frame a
# decode window: after its second window)
RESUME_RID = "resume"
RESUME_MAX_TOKENS = 64
RESUME_KILL_FRAME = 4


def dyn_role(role: str, stamps: str, argv: list) -> None:
    """One process of phase 16 (a): the launcher (``run.main(argv)``, as
    ``python -m dynamo_tpu_torch.run`` runs it) with the smoke's stamps
    around it, one JSON line per request to ``stamps``: in the frontend
    the time the HTTP service received the request; in the worker the
    time its endpoint handler was entered, and the engine's entry, first
    token, prompt and tokens (time.monotonic, one clock for every process
    of the machine)."""
    from dynamo_tpu_torch import run

    out = open(stamps, "a", buffering=1)

    def stamp(rec: dict) -> None:
        out.write(json.dumps(rec) + "\n")

    if role == "frontend":
        from dynamo_tpu_torch.llm.http.service import HttpService

        serve = HttpService._serve

        async def _serve(self, request, *a):
            stamp({"rid": request.headers.get("X-Request-Id"),
                   "frontend_receive": time.monotonic()})
            return await serve(self, request, *a)

        HttpService._serve = _serve
    else:
        from dynamo_tpu_torch.engine.torch_engine import TorchEngine
        from dynamo_tpu_torch.runtime.component import ServeHandle

        run_request, generate = ServeHandle._run_request, \
            TorchEngine.generate

        async def _run_request(self, req_id, *a):
            stamp({"rid": req_id, "handler_entry": time.monotonic()})
            await run_request(self, req_id, *a)

        async def _generate(self, request, context):
            rec = {"rid": context.id, "engine_entry": time.monotonic(),
                   "prompt": list(request.token_ids), "tokens": []}
            try:
                async for o in generate(self, request, context):
                    if o.token_ids and "first_token" not in rec:
                        rec["first_token"] = time.monotonic()
                    rec["tokens"] += list(o.token_ids)
                    yield o
            finally:  # the caller may close the stream at its finish
                stamp(rec)

        ServeHandle._run_request = _run_request
        TorchEngine.generate = _generate
    run.main(argv)


def read_stamps(*paths) -> dict:
    """Request id -> every stamp the processes wrote for it."""
    out = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                out.setdefault(rec.pop("rid"), {}).update(rec)
    return out


def _stop(procs) -> None:
    """SIGTERM, then SIGKILL what is still running after 30 s."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


async def dyn_traffic(base: str, model: str, on_drain_chunk) -> dict:
    """DYN_BATCH at once, then DYN_STREAM, calling ``on_drain_chunk()``
    when its first chunk arrives: per request its send time, the time its
    answer ended and, for a stream, its first chunk with text or a finish
    (random weights mostly draw ids past the byte tokenizer's 256, which
    decode to no text), and its finish."""
    import aiohttp

    async def one(s, rid, kind, prompt, n, stream, on_chunk=None):
        if kind == "chat":
            url, body = "/v1/chat/completions", {
                "model": model, "stream": stream, "max_tokens": n,
                "messages": [{"role": "user", "content": prompt}]}
        else:
            url, body = "/v1/completions", {"model": model, "prompt": prompt,
                                            "max_tokens": n}
        sent = time.monotonic()
        async with s.post(base + url, json=body,
                          headers={"X-Request-Id": rid}) as r:
            if r.status != 200:
                fail(f"phase 16 {rid}: HTTP {r.status}: {await r.text()}")
            if not stream:
                fin = (await r.json())["choices"][0]["finish_reason"]
                return rid, {"sent": sent, "first_content": None,
                             "end": time.monotonic(), "finish": fin}
            first, data = None, []
            async for ln in r.content:
                ln = ln.decode().strip()
                if ln.startswith("data: "):
                    data.append(ln[6:])
                    if on_chunk is not None and len(data) == 1:
                        on_chunk()
                    if first is None and ln != "data: [DONE]" and any(
                            (c.get("delta") or {}).get("content")
                            or c.get("finish_reason")
                            for c in json.loads(ln[6:])["choices"]):
                        first = time.monotonic()
            if not data or data[-1] != "[DONE]":
                fail(f"phase 16 {rid}: the stream did not end in [DONE]")
            fin = [c["finish_reason"] for d in data[:-1]
                   for c in json.loads(d)["choices"] if c.get("finish_reason")]
            return rid, {"sent": sent, "first_content": first,
                         "end": time.monotonic(),
                         "finish": fin[-1] if fin else None}

    async with aiohttp.ClientSession() as s:
        got = dict(await asyncio.gather(*(one(s, *q) for q in DYN_BATCH)))
        got.update([await one(s, *DYN_STREAM, on_chunk=on_drain_chunk)])
    return got


def models_listed(base: str):
    import urllib.request

    try:
        with urllib.request.urlopen(base + "/v1/models", timeout=5) as r:
            return [m["id"] for m in json.loads(r.read())["data"]]
    except OSError:
        return None


def dyn_worker_phase(cfg, dev, params, batch_ref, out_dir,
                     model_args=("--model", "8b", "--seed", "0"),
                     start_limit_s: float = 300.0) -> dict:
    """Phase 16 (a): the control plane, a worker and a frontend, three
    processes on one card (:func:`dyn_role` around the launcher). The
    worker serves ``model_args`` (phase 4's seed-0 weights) at
    DYN_ENDPOINT with ``--max-batch-size 4``; once the frontend lists its
    model, DYN_BATCH goes at once and DYN_STREAM after it, and the worker
    gets SIGTERM when DYN_STREAM's first chunk arrives: it drains
    (``runtime/revive.py drain_worker``). Checks: every request finishes,
    streams end in [DONE]; the greedy tokens are phase 4's (``batch_ref``)
    under :func:`margin_rule`; the drained stream finishes ``length`` with
    all its tokens; the frontend lists no model within DYN_LEASE_TTL_S of
    the SIGTERM, the worker logs a clean drain and exits 0 within
    DYN_DRAIN_TIMEOUT_S of it, and its serving summary shows no capture
    after warmup, every decode launch on bf16_mma and every prefill
    launch on bf16. Prints each request's TTFT stages to the engine's
    first token, the frontend -> worker hop apart, and the drain's
    times."""
    dcp_port, http_port = _free_port(), _free_port()
    dcp = f"127.0.0.1:{dcp_port}"
    base = f"http://127.0.0.1:{http_port}"
    stamps = {r: os.path.join(out_dir, f"{r}.stamps") for r in
              ("frontend", "worker")}
    logs = {r: os.path.join(out_dir, f"{r}.log") for r in
            ("dcp", "frontend", "worker")}
    cmds = {
        "dcp": [sys.executable, "-m", "dynamo_tpu_torch.runtime.dcp_server",
                "--port", str(dcp_port)],
        "worker": [sys.executable, os.path.abspath(__file__), "--dyn-role",
                   "worker", "--dyn-stamps", stamps["worker"], "--",
                   f"in={DYN_ENDPOINT}", "out=torch", *model_args,
                   "--dcp", dcp, "--max-batch-size", "4"],
        "frontend": [sys.executable, os.path.abspath(__file__), "--dyn-role",
                     "frontend", "--dyn-stamps", stamps["frontend"], "--",
                     "in=http", "out=dyn", "--dcp", dcp, "--http-host",
                     "127.0.0.1", "--http-port", str(http_port)],
    }
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = {}
    try:
        for name in ("dcp", "worker", "frontend"):
            with open(logs[name], "w") as f:
                procs[name] = subprocess.Popen(
                    cmds[name], env=env, cwd=REPO, stdout=f,
                    stderr=subprocess.STDOUT, start_new_session=True)
            if name == "dcp":
                time.sleep(1.0)
        t0 = time.monotonic()
        model = model_args[model_args.index("--model") + 1]
        while models_listed(base) != [model]:
            for name, p in procs.items():
                if p.poll() is not None:
                    fail(f"phase 16: the {name} process exited "
                         f"({p.returncode}): {_tail(logs[name])}")
            if time.monotonic() - t0 > start_limit_s:
                fail(f"phase 16: no model on the frontend after "
                     f"{start_limit_s:.0f} s: {_tail(logs['worker'])}")
            time.sleep(0.5)
        ready_s = time.monotonic() - t0
        log(f"  the frontend lists {model!r} {ready_s:.1f} s after the "
            f"processes started")
        term = []

        def sigterm():
            procs["worker"].send_signal(signal.SIGTERM)
            term.append(time.monotonic())

        client = asyncio.run(dyn_traffic(base, model, sigterm))
        t_term = term[0]
        stream_done_s = client[DYN_STREAM[0]]["end"] - t_term
        while models_listed(base) != []:
            if time.monotonic() - t_term > DYN_LEASE_TTL_S:
                fail(f"phase 16: the frontend still lists "
                     f"{models_listed(base)} {DYN_LEASE_TTL_S} s after the "
                     f"worker's SIGTERM")
            time.sleep(0.05)
        withdrawn_s = time.monotonic() - t_term
        rc = procs["worker"].wait(timeout=120)
        exit_s = time.monotonic() - t_term
        if rc != 0:
            fail(f"phase 16: the worker exited {rc}: {_tail(logs['worker'])}")
        if exit_s > DYN_DRAIN_TIMEOUT_S:
            fail(f"phase 16: the worker exited {exit_s:.2f} s after its "
                 f"SIGTERM, past the drain budget of {DYN_DRAIN_TIMEOUT_S} s")
    finally:
        _stop(list(procs.values()))
    with open(logs["worker"]) as f:
        worker_log = f.read()
    if "drained (clean)" not in worker_log:
        fail(f"phase 16: the worker did not drain clean: "
             f"{_tail(logs['worker'])}")
    lines = [ln for ln in worker_log.splitlines(keepends=True)
             if ln.startswith("serving summary ")]
    if len(lines) != 1:
        fail(f"phase 16: {len(lines)} serving summaries in the worker's log")
    summary = json.loads(lines[0][len("serving summary "):])
    dec, pf = summary["route_launches"], summary["prefill_route_launches"]
    if summary["post_warmup_compiles_total"] != 0:
        fail(f"phase 16: the worker captured graphs after warmup: {summary}")
    if dec["bf16_mma"] <= 0 or sum(dec.values()) != dec["bf16_mma"] \
            or pf["bf16"] <= 0 or sum(pf.values()) != pf["bf16"]:
        fail(f"phase 16: the worker's attention was not all on bf16_mma / "
             f"bf16: {dec} {pf}")
    seen = read_stamps(stamps["frontend"], stamps["worker"])
    stages, tokens = {}, {}
    for rid, c in client.items():
        st = seen.get(rid, {})
        if c["finish"] not in ("length", "stop") or not st.get("tokens"):
            fail(f"phase 16 {rid}: finish {c['finish']!r}, "
                 f"{len(st.get('tokens', ()))} tokens")
        # client send -> frontend receive -> worker handler entry ->
        # engine entry -> the engine's first token
        marks = [c["sent"], st["frontend_receive"], st["handler_entry"],
                 st["engine_entry"], st["first_token"]]
        names = ["send_to_frontend", "frontend_to_worker",
                 "worker_to_engine", "engine_first_token"]
        stages[rid] = {
            "ttft_ms": (marks[-1] - marks[0]) * 1e3,
            "stages_ms": {n: (b - a) * 1e3 for n, a, b in
                          zip(names, marks, marks[1:])},
            "client_first_content_ms": None if c["first_content"] is None
            else (c["first_content"] - c["sent"]) * 1e3,
            "client_end_ms": (c["end"] - c["sent"]) * 1e3,
            "prompt_tokens": len(st["prompt"]),
            "tokens": len(st["tokens"])}
        log(f"  TTFT stages, {rid}: {json.dumps(stages[rid])}")
        if rid in batch_ref:
            ref = batch_ref[rid]
            if st["prompt"] != ref["prompt_ids"]:
                fail(f"phase 16 {rid}: the worker's prompt ids are not "
                     f"phase 4's")
            tokens[rid] = margin_rule(
                params, cfg, dev, ref["prompt_ids"], ref["tokens"],
                st["tokens"], f"phase 16 (a): {rid} against phase 4")
    drained = seen.get(DYN_STREAM[0], {})
    if client[DYN_STREAM[0]]["finish"] != "length" or \
            len(drained.get("tokens", ())) != DYN_STREAM[3]:
        fail(f"phase 16: the drained stream finished "
             f"{client[DYN_STREAM[0]]['finish']!r} with "
             f"{len(drained.get('tokens', ()))} of {DYN_STREAM[3]} tokens")
    drain = {"stream_done_s": stream_done_s, "withdrawn_s": withdrawn_s,
             "exit_s": exit_s}
    log(f"  drain after SIGTERM: the stream's last {DYN_STREAM[3]}-token "
        f"chunk {stream_done_s:.3f} s, no model on the frontend "
        f"{withdrawn_s:.3f} s, the worker's exit {exit_s:.3f} s; worker "
        f"summary {json.dumps(summary)}")
    return {"ready_s": ready_s, "withdrawn_s": withdrawn_s, "drain": drain,
            "summary": summary, "ttft": stages, "tokens_vs_phase4": tokens,
            "prompt_tokens": {r: s["prompt_tokens"]
                              for r, s in stages.items()}}


async def routed_graph(cfg, dev, params, ecfg, batch_ref=None,
                       warm: bool = True) -> dict:
    """Phase 16 (b), the reference's KV-routed graph at full width: two
    TorchEngines on ``params`` (shared tensors, each its own pool), each
    served by serve_token_model on its own DistributedRuntime attachment
    with a KvEventPublisher, and the KvRouter, Processor and HttpService
    in front, every span sampled (DYN_TRACE_SAMPLE=1). ROUTED_N prompts of
    one ROUTED_PREFIX-token prefix with their own suffixes go one by one,
    then all at once, then one prompt with a fresh prefix. Then
    :func:`check_trace_tree` on one request and, with ``batch_ref`` (phase
    4's batch), :func:`resume_check` last. Returns what each request did
    (its worker, its prompt and tokens), the router's and engines'
    counters, the trace tree and the resume."""
    import aiohttp
    import numpy as np

    from dynamo_tpu_torch.runtime import tracing

    from dynamo_tpu_torch.engine.torch_engine import TorchEngine
    from dynamo_tpu_torch.llm.http.service import HttpService
    from dynamo_tpu_torch.llm.kv_router.protocols import KV_EVENT_SUBJECT
    from dynamo_tpu_torch.llm.kv_router.router import KvRouter
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.processor import Processor
    from dynamo_tpu_torch.llm.worker import serve_token_model
    from dynamo_tpu_torch.ops import paged_attention as ops
    from dynamo_tpu_torch.runtime.dcp_client import unpack
    from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

    tracing.configure(sample=1.0)
    engines, warm_s = [], []
    for _ in range(2):
        t = time.monotonic()
        eng = TorchEngine(cfg, ecfg, params=params, device=dev)
        if warm:
            eng.warmup()
        warm_s.append(time.monotonic() - t)
        engines.append(eng)
    seen = {}
    solo_generate = engines[0].generate
    for eng in engines:
        real = eng.generate

        async def generate(req, ctx, real=real, eng=eng):
            if ctx.id.startswith(RESUME_RID):  # resume_check's own
                async for o in real(req, ctx):
                    yield o
                return
            rec = seen.setdefault(ctx.id, {
                "prompt": list(req.token_ids), "tokens": [],
                "engine": engines.index(eng)})
            async for o in real(req, ctx):
                rec["tokens"] += list(o.token_ids)
                yield o
        eng.generate = generate
    drts = [await DistributedRuntime.detached()]
    drts.append(await DistributedRuntime.attach(drts[0].dcp.address))
    mdc = ModelDeploymentCard(name="routed", kv_block_size=ecfg.page_size)
    served = [await serve_token_model(d, mdc, e, namespace="dynamo",
                                      component="routed")
              for d, e in zip(drts, engines)]
    events = {"stored": 0, "removed": 0}

    async def count(msg):
        for ev in unpack(msg.payload):
            events[ev["kind"]] += len(ev["block_hashes"])

    await drts[0].dcp.subscribe(f"dynamo.routed.{KV_EVENT_SUBJECT}", count)
    router = KvRouter(drts[0], "dynamo", "routed",
                      block_size=ecfg.page_size, scrape_interval=0.25, seed=0)
    await router.start()
    client = await drts[0].namespace("dynamo").component("routed") \
        .endpoint("generate_tokens").client()
    while len(await client.wait_for_instances(30)) < 2:
        await asyncio.sleep(0.05)
    processor = Processor(mdc, client, router)
    svc = HttpService()
    svc.manager.add_completions_model("routed", processor.completion)
    await svc.start("127.0.0.1", 0)
    base = f"http://127.0.0.1:{svc.port}"
    rng = np.random.RandomState(16)
    lo, hi = (1000, 100000) if cfg.vocab_size > 100000 else \
        (0, cfg.vocab_size)

    def ids(n):
        return [int(t) for t in rng.randint(lo, hi, n)]

    prefix = ids(ROUTED_PREFIX)
    prompts = [prefix + ids(ROUTED_SUFFIX) for _ in range(ROUTED_N)]
    fresh = ids(ROUTED_PREFIX + ROUTED_SUFFIX)
    hits0 = [e.prefix_hit_tokens_total for e in engines]
    ops.reset_launch_counts()
    report = {"warmup_s": warm_s, "requests": {}}

    async def send(s, rid, ids):
        async with s.post(base + "/v1/completions", json={
                "model": "routed", "prompt": ids,
                "max_tokens": ROUTED_MAX_TOKENS},
                headers={"X-Request-Id": rid}) as r:
            if r.status != 200:
                fail(f"phase 16 (b) {rid}: HTTP {r.status}: {await r.text()}")
            fin = (await r.json())["choices"][0]["finish_reason"]
        if fin not in ("length", "stop"):
            fail(f"phase 16 (b) {rid}: finish {fin!r}")

    async def indexed(prompt, wid) -> bool:
        t0 = time.monotonic()
        while time.monotonic() - t0 < ROUTED_POLL_S:
            if router.overlap_for(prompt, wid) >= ROUTED_PREFIX // \
                    ecfg.page_size:
                return True
            await asyncio.sleep(0.05)
        return False

    t0 = time.monotonic()
    async with aiohttp.ClientSession() as s:
        await send(s, "seq0", prompts[0])
        holder = router.scheduler.decisions[-1]["chosen"]
        for i in range(1, ROUTED_N):
            if not await indexed(prompts[0], holder):
                fail(f"phase 16 (b): the index does not hold the first "
                     f"request's {ROUTED_PREFIX // ecfg.page_size} blocks "
                     f"on its worker after {ROUTED_POLL_S} s")
            await send(s, f"seq{i}", prompts[i])
        await asyncio.gather(*(send(s, f"all{i}", p)
                               for i, p in enumerate(prompts)))
        report["fresh_overlap"] = [router.overlap_for(fresh, d.instance_id)
                                   for d in drts]
        await send(s, "fresh", fresh)
    report["serve_s"] = time.monotonic() - t0
    for _h, pub in served:
        await pub.flush()
    await asyncio.sleep(0.5)
    report["route_launches"] = dict(ops.DECODE_ROUTE_LAUNCHES)
    report["prefill_route_launches"] = dict(ops.PREFILL_ROUTE_LAUNCHES)
    wids = [d.instance_id for d in drts]
    chosen = {d["request_id"]: d["chosen"]
              for d in router.scheduler.decisions}
    for rid, rec in seen.items():
        report["requests"][rid] = {**rec, "worker": wids.index(chosen[rid])}
    report.update({
        "holder": wids.index(holder),
        "router": router.stats(),
        # a copy: the resume below stores more blocks
        "events": dict(events),
        "index_blocks": router.indexer.tree.block_count(),
        "prefix_hit_tokens": [e.prefix_hit_tokens_total - h
                              for e, h in zip(engines, hits0)],
        "post_warmup_compiles_total": [
            e.stats()["post_warmup_compiles_total"] for e in engines]})
    report["trace"] = await check_trace_tree(base, "seq1")
    if batch_ref is not None:
        # last: the killed handle stays dead
        report["resume"] = await resume_check(
            base, engines, served, wids, batch_ref["r1-stream"])
        report["route_launches"] = dict(ops.DECODE_ROUTE_LAUNCHES)
        report["prefill_route_launches"] = dict(ops.PREFILL_ROUTE_LAUNCHES)
    await router.stop()
    await svc.stop()
    await client.close()
    for h, pub in served:
        await h.stop()
        await pub.stop()
    # the same prompts on one engine, one at a time: the tokens the
    # routed requests are held to
    from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                       StopConditions)
    from dynamo_tpu_torch.runtime.engine import Context

    report["solo"] = {}
    for i, p in enumerate(prompts + [fresh]):
        toks = []
        async for o in solo_generate(PreprocessedRequest(
                token_ids=p, stop=StopConditions(
                    max_tokens=ROUTED_MAX_TOKENS)), Context(f"solo{i}")):
            toks += o.token_ids
        report["solo"][i] = toks
    report["prompts"] = prompts + [fresh]
    for e in engines:
        await e.stop()
    for d in drts[::-1]:
        await d.shutdown()
    return report


async def check_trace_tree(base: str, rid: str) -> dict:
    """Phase 16 (b)'s trace check: ``/v1/traces/{rid}`` holds one trace,
    one root ``http.request``, and ``preprocess``, ``route`` and
    ``serve.generate_tokens`` (the worker's span, parented on the
    envelope's trace field) its children; its cost block is the engine's
    (queue wait, dispatches, ROUTED_MAX_TOKENS decode tokens) and carries
    the router's predicted overlap beside the realized one."""
    import aiohttp

    async with aiohttp.ClientSession() as s:
        async with s.get(f"{base}/v1/traces/{rid}") as r:
            if r.status != 200:
                fail(f"phase 16 (b): /v1/traces/{rid}: HTTP {r.status}")
            tr = await r.json()
    spans = tr["spans"]
    by_name = {sp["name"]: sp for sp in spans}
    roots = [sp["name"] for sp in spans if sp["parent_id"] is None]
    want = ("preprocess", "route", "serve.generate_tokens")
    root_id = by_name.get("http.request", {}).get("span_id")
    if len({sp["trace_id"] for sp in spans}) != 1 or \
            roots != ["http.request"] or any(
                by_name.get(n, {}).get("parent_id") != root_id
                for n in want):
        links = [(sp["name"], sp["span_id"], sp["parent_id"]) for sp in spans]
        fail(f"phase 16 (b): {rid}'s trace is not one tree http.request -> "
             f"{want}: {links}")
    cost = tr.get("cost") or {}
    if cost.get("decode_tokens") != ROUTED_MAX_TOKENS or \
            "queue_wait_ms" not in cost or \
            "router_overlap_blocks" not in cost:
        fail(f"phase 16 (b): {rid}'s cost block {cost}")
    tree = {"spans": [sp["name"] for sp in spans], "stages_ms": tr["stages"],
            "cost": {k: cost[k] for k in (
                "queue_wait_ms", "dispatches", "decode_tokens",
                "device_hit_blocks", "router_overlap_blocks")}}
    log(f"  (b) trace of {rid}: {json.dumps(tree)}")
    return tree


async def resume_check(base: str, engines: list, served: list, wids: list,
                       ref: dict) -> dict:
    """Phase 16 (b)'s resume, run last: phase 4's long prompt
    (``ref['prompt_ids']``) as a greedy stream of RESUME_MAX_TOKENS, the
    only request in flight; a ``worker.kill`` chaos rule kills the handle
    that serves it under its RESUME_KILL_FRAME-th frame (after its second
    decode window). Checks: the stream finishes ``length`` on the sibling
    with no error event and all its tokens, one resume named on its
    finish's cost block, the route fallback counter unchanged, no capture
    after warmup on the sibling, the killed engine's pages all free, the
    journal empty. Returns the delivered tokens (the processor's journal
    of what it forwarded), the sibling's solo control of the same prompt,
    and the resume's gap: from the last chunk from the dead worker to the
    first from the sibling, as the processor received them."""
    import aiohttp

    from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                       StopConditions)
    from dynamo_tpu_torch.runtime import guard, profiling, revive
    from dynamo_tpu_torch.runtime.engine import Context

    observed = []
    real_observe = revive.ReviveSession.observe

    def observe(session, out):
        if session.entry.request_id == RESUME_RID:
            observed.append((time.monotonic(), session.resumes,
                             list(out.token_ids or [])))
        return real_observe(session, out)

    def fallbacks() -> float:
        return sum(v for k, v in guard.counters_snapshot().items()
                   if k.startswith("dyn_llm_route_fallback_total"))

    fallback0 = fallbacks()
    revive.ReviveSession.observe = observe
    guard.set_chaos(f"seed=1;sever:worker.kill@nth={RESUME_KILL_FRAME}")
    saw_error, finishes = False, []
    try:
        async with aiohttp.ClientSession() as s:
            async with s.post(base + "/v1/completions", json={
                    "model": "routed", "prompt": ref["prompt_ids"],
                    "stream": True, "max_tokens": RESUME_MAX_TOKENS},
                    headers={"X-Request-Id": RESUME_RID}) as r:
                if r.status != 200:
                    fail(f"phase 16 (b) resume: HTTP {r.status}")
                async for ln in r.content:
                    ln = ln.decode().strip()
                    if ln.startswith("event: error"):
                        saw_error = True
                    if ln.startswith("data: ") and ln != "data: [DONE]":
                        finishes += [c["finish_reason"] for c in
                                     json.loads(ln[6:]).get("choices", [])
                                     if c.get("finish_reason")]
    finally:
        guard.set_chaos(None)
        revive.ReviveSession.observe = real_observe
    dead = [i for i, (h, _) in enumerate(served) if h._dead]
    if len(dead) != 1:
        fail(f"phase 16 (b) resume: {len(dead)} handles died, not 1")
    survivor = engines[1 - dead[0]]
    delivered = [t for _, _, ids in observed for t in ids]
    before = [o for o in observed if o[1] == 0]
    after = [o for o in observed if o[1] == 1]
    cost = profiling.request_attribution(RESUME_RID) or {}
    if saw_error or finishes != ["length"] or \
            len(delivered) != RESUME_MAX_TOKENS or not before or \
            not after or cost.get("resumed_attempts") != 1:
        fail(f"phase 16 (b) resume: error event {saw_error}, finishes "
             f"{finishes}, {len(delivered)} tokens ({len(before)} chunks "
             f"before the kill, {len(after)} after), cost {cost}")
    if fallbacks() != fallback0:
        fail(f"phase 16 (b) resume: the route fallback counter moved "
             f"({fallback0} -> {fallbacks()})")
    if survivor.stats()["post_warmup_compiles_total"] != 0:
        fail("phase 16 (b) resume: the sibling captured a graph after "
             "warmup for the resume prompt")
    await pages_idle(engines[dead[0]], "phase 16 (b) resume: the killed "
                     "engine", limit_s=10.0)
    if len(revive.journal()) != 0:
        fail(f"phase 16 (b) resume: {len(revive.journal())} journal entries "
             f"left")
    gap_ms = (after[0][0] - before[-1][0]) * 1e3
    control = []
    async for o in survivor.generate(PreprocessedRequest(
            token_ids=list(ref["prompt_ids"]),
            stop=StopConditions(max_tokens=RESUME_MAX_TOKENS)),
            Context(RESUME_RID + "-control")):
        control += o.token_ids
    out = {"dead_worker": dead[0], "tokens_before_kill":
           sum(len(o[2]) for o in before), "gap_ms": gap_ms,
           "resumed_attempts": cost["resumed_attempts"],
           "delivered": delivered, "control": control}
    log(f"  (b) resume: worker {dead[0]} killed after "
        f"{out['tokens_before_kill']} tokens; the sibling's first token "
        f"came {gap_ms:.2f} ms after the dead worker's last; "
        f"{len(delivered)} tokens, resumed_attempts 1, journal empty")
    return out


def check_routed(params, cfg, dev, rep: dict) -> dict:
    """Phase 16 (b)'s checks: every request after the first that shares
    the prefix went to the worker that holds it, the router counts its
    decisions with a hit rate above 0, and that engine counted at least
    ROUTED_PREFIX hit tokens a repeat; the fresh prefix overlapped
    nothing on either worker and was served; the index holds the stored
    blocks less the removed ones; no capture after warmup; the routed
    greedy tokens are one engine's under :func:`margin_rule`."""
    reqs = rep["requests"]
    shared = [r for r in reqs if r != "fresh"]
    repeats = [r for r in shared if r != "seq0"]
    if len(shared) != 2 * ROUTED_N or "fresh" not in reqs:
        fail(f"phase 16 (b): served {sorted(reqs)}")
    strays = {r: reqs[r]["worker"] for r in repeats
              if reqs[r]["worker"] != rep["holder"]}
    if strays:
        fail(f"phase 16 (b): shared-prefix requests went to the worker "
             f"without the prefix: {strays}")
    st = rep["router"]
    if st["decisions"] != len(reqs) or st["avg_hit_rate"] <= 0:
        fail(f"phase 16 (b): router stats {st}")
    hits = rep["prefix_hit_tokens"][rep["holder"]]
    if hits < ROUTED_PREFIX * len(repeats):
        fail(f"phase 16 (b): the holding engine counted {hits} prefix hit "
             f"tokens for {len(repeats)} repeats of {ROUTED_PREFIX}")
    if rep["fresh_overlap"] != [0, 0]:
        fail(f"phase 16 (b): the fresh prefix overlapped "
             f"{rep['fresh_overlap']}")
    ev = rep["events"]
    if rep["index_blocks"] != ev["stored"] - ev["removed"] or \
            ev["stored"] <= 0:
        fail(f"phase 16 (b): the index holds {rep['index_blocks']} blocks; "
             f"events stored {ev['stored']}, removed {ev['removed']}")
    if rep["post_warmup_compiles_total"] != [0, 0]:
        fail(f"phase 16 (b): captures after warmup "
             f"{rep['post_warmup_compiles_total']}")
    tokens = {}
    for rid, rec in reqs.items():
        i = ROUTED_N if rid == "fresh" else int(rid[3:])
        if rec["prompt"] != rep["prompts"][i]:
            fail(f"phase 16 (b) {rid}: prompt ids changed on the way")
        tokens[rid] = margin_rule(params, cfg, dev, rec["prompt"],
                                  rep["solo"][i], rec["tokens"],
                                  f"phase 16 (b): {rid} against one engine")
    return tokens


def check_resume(params, cfg, dev, rep: dict, ref: dict) -> dict:
    """Phase 16 (b)'s resumed tokens under :func:`margin_rule`: all of
    them against the sibling's solo control of the same prompt, and the
    first of them against phase 4's greedy tokens of it (``ref``). The
    resumed tokens come from K/V the prefill kernel wrote, where an
    unfaulted run's came from decode windows: a bf16 near-tie can move
    one."""
    res = rep["resume"]
    n = len(ref["tokens"])
    return {"vs_control": margin_rule(
                params, cfg, dev, ref["prompt_ids"], res["control"],
                res["delivered"], "phase 16 (b): the resumed stream against "
                "the sibling's control"),
            "vs_phase4": margin_rule(
                params, cfg, dev, ref["prompt_ids"], ref["tokens"],
                res["delivered"][:n], f"phase 16 (b): the resumed stream's "
                f"first {n} tokens against phase 4's")}


def check_calibration(rep: dict) -> dict:
    """Phase 16 (b)'s router stats: a calibration entry for each routed
    request (its finish cost block compared with the parked prediction),
    and the live weight and autotune block beside them."""
    st = rep["router"]
    cal = st.get("calibration", {})
    if cal.get("compared") != st["decisions"] or \
            "load_balance_weight" not in st or "autotune" not in st:
        fail(f"phase 16 (b): router stats hold no calibration entry for "
             f"each of its {st['decisions']} decisions: {st}")
    log(f"  (b) router calibration: {json.dumps(cal)}; "
        f"load_balance_weight {st['load_balance_weight']}, "
        f"autotune.adjustments {st['autotune']['adjustments']}")
    return {"calibration": cal, "load_balance_weight":
            st["load_balance_weight"], "autotune": st["autotune"]}


def runtime_phase(cfg, dev, params, batch_ref) -> dict:
    """Phase 16: (a) :func:`dyn_worker_phase`, (b) :func:`routed_graph`
    with :func:`check_routed`, :func:`check_calibration` and
    :func:`check_resume`, each engine at ``max_batch`` 8, the default pool
    and only the plain graph variant warmed."""
    from dynamo_tpu_torch.engine.torch_engine import EngineConfig

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dyn_")
    try:
        t = time.monotonic()
        worker = dyn_worker_phase(cfg, dev, params, batch_ref, out_dir)
        worker["seconds"] = time.monotonic() - t
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    t = time.monotonic()
    # (b) sends no logprobs request: its engines warm the plain variant
    # only (a capture after warmup would still fail the phase)
    routed = asyncio.run(routed_graph(
        cfg, dev, params, EngineConfig(max_batch=8, warmup_logprobs=False),
        batch_ref))
    routed["checks"] = check_routed(params, cfg, dev, routed)
    routed["calibration"] = check_calibration(routed)
    routed["resume"]["checks"] = check_resume(params, cfg, dev, routed,
                                              batch_ref["r1-stream"])
    routed["seconds"] = time.monotonic() - t
    brief = {k: routed[k] for k in (
        "holder", "router", "events", "index_blocks", "prefix_hit_tokens",
        "fresh_overlap", "route_launches", "prefill_route_launches",
        "warmup_s", "serve_s", "seconds")}
    brief["resume"] = {k: routed["resume"][k] for k in (
        "dead_worker", "tokens_before_kill", "gap_ms", "checks")}
    log(f"  (a) took {worker['seconds']:.1f} s; (b) {json.dumps(brief)}")
    return {"worker": worker, "routed": routed}


# ------------------------------------- phase 17: disaggregated prefill/decode

# phase 17: the threshold published live (max_local_prefill_length), the
# tokens each request decodes, and the fallback request's prefill_timeout
DISAGG_THRESHOLD = 32
DISAGG_MAX_TOKENS = 16
DISAGG_TIMEOUT_S = 2.0


def _variant(ids: list, k: int, vocab: int) -> list:
    """``ids`` with its second token moved by ``k``: every full page's
    chain hash changes, so no prefix cache holds it."""
    out = list(ids)
    out[1] = (out[1] + k) % vocab
    return out


def _prompt_rows(t, n: int):
    """Pages [L, pages, KV, ps, hd] -> their first n positions."""
    L, npg, kv, ps, hd = t.shape
    return t.permute(0, 1, 3, 2, 4).reshape(L, npg * ps, kv, hd)[:, :n]


async def disagg_primitives(params, cfg, dev, pre, dec, prompt) -> dict:
    """Phase 17 (a): prefill_only of ``prompt`` on the prefill engine, its
    pages extracted and injected into pages reserved on the decode engine
    (which hold them bitwise), against a local prefill_only of the same
    prompt on the decode engine (K/V at the prompt's positions within
    bf16 tolerance, the first token equal or a plain-path near-tie)."""
    import torch

    from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                       StopConditions)
    from dynamo_tpu_torch.runtime.engine import Context

    def req():
        return PreprocessedRequest(token_ids=list(prompt),
                                   stop=StopConditions(max_tokens=1))

    out = {"prompt_tokens": len(prompt)}
    t = time.monotonic()
    first, pages = await pre.prefill_only(req(), Context("a-remote"))
    out["prefill_only_s"] = time.monotonic() - t
    t = time.monotonic()
    k, v = await pre.extract_pages(pages)
    out["extract_s"] = time.monotonic() - t
    res = await dec.reserve_remote(prompt)
    if res is None or res.skip_pages or len(res.pages) != len(pages):
        fail(f"phase 17 (a): reservation {res} for {len(pages)} pages")
    t = time.monotonic()
    await dec.inject_pages(res.pages, k, v)
    out["inject_s"] = time.monotonic() - t
    k2, v2 = await dec.extract_pages(res.pages)
    if not (torch.equal(k2.view(torch.int16), k.view(torch.int16))
            and torch.equal(v2.view(torch.int16), v.view(torch.int16))):
        fail("phase 17 (a): the injected pages are not the extracted ones "
             "bitwise")
    local_first, local_pages = await dec.prefill_only(req(),
                                                      Context("a-local"))
    lk, lv = await dec.extract_pages(local_pages)
    atol, rtol = tolerance(torch.bfloat16)
    n = len(prompt)
    out["pages"] = len(pages)
    out["bytes"] = k.nbytes + v.nbytes
    out["kv_max_abs_err"] = max(
        max_err(_prompt_rows(a, n), _prompt_rows(b, n))
        for a, b in ((k, lk), (v, lv)))
    over = max(excess(_prompt_rows(a, n), _prompt_rows(b, n), atol, rtol)
               for a, b in ((k, lk), (v, lv)))
    if over > 0:
        fail(f"phase 17 (a): remote K/V off the local prefill's by {over} "
             f"past atol {atol} + rtol {rtol}")
    out["first_token"] = margin_rule(params, cfg, dev, prompt,
                                     [local_first], [first],
                                     "phase 17 (a): the first token")
    for eng, p in ((pre, pages), (dec, res.pages), (dec, local_pages)):
        await eng.release_pages(p)
    return out


async def disagg_serving(cfg, dev, params, ref) -> dict:
    """Phase 17: two TorchEngines at the default EngineConfig (batches
    up to 8) on
    ``params`` (each its own pool), the prefill engine under a
    PrefillWorker, the decode engine under build_disagg_decode on another
    runtime attachment, served by serve_token_model with the KV event
    publisher on the inner engine, and the KvRouter, Processor and
    HttpService in front. (a) :func:`disagg_primitives`; (b) the traffic
    of the module docstring. Returns what each request did and the
    engines', worker's and transfer plane's counters."""
    import aiohttp
    import torch

    from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.llm.disagg import PrefillWorker
    from dynamo_tpu_torch.llm.disagg.decode import build_disagg_decode
    from dynamo_tpu_torch.llm.disagg.prefill_worker import \
        DEFAULT_CHUNK_PAGES
    from dynamo_tpu_torch.llm.disagg.router import publish_config
    from dynamo_tpu_torch.llm.http.service import HttpService
    from dynamo_tpu_torch.llm.kv_router.protocols import KV_EVENT_SUBJECT
    from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher
    from dynamo_tpu_torch.llm.kv_router.router import KvRouter
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.processor import Processor
    from dynamo_tpu_torch.llm.worker import serve_token_model
    from dynamo_tpu_torch.ops import paged_attention as ops
    from dynamo_tpu_torch.runtime.dcp_client import unpack
    from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

    rep = {"warmup_s": []}
    engines = []
    for _ in range(2):
        t = time.monotonic()
        eng = TorchEngine(cfg, EngineConfig(max_batch=TRAFFIC_MAX_BATCH),
                          params=params, device=dev)
        eng.warmup()
        rep["warmup_s"].append(time.monotonic() - t)
        engines.append(eng)
    pre, dec = engines
    ps = dec.ecfg.page_size
    rep["decode_steps"] = dec.ecfg.decode_steps
    batch = {rid: r["prompt_ids"] for rid, r in ref["batch"].items()}
    long_rid = max(batch, key=lambda r: len(batch[r]))
    ops.reset_launch_counts()
    rep["a"] = await disagg_primitives(
        params, cfg, dev, pre, dec,
        _variant(batch[long_rid], 1, cfg.vocab_size))

    # (b): the serving stack
    drt_d = await DistributedRuntime.detached()
    drt_p = await DistributedRuntime.attach(drt_d.dcp.address)
    disagg = await build_disagg_decode(drt_d, dec, namespace="dynamo",
                                       model="disagg")
    decisions, waits, sends, injects, seen = [], {}, {}, {}, {}
    capture = {"on": False, "sent": [], "landed": []}
    decide = disagg.router.prefill_remote

    def prefill_remote(n, hit, depth=0):
        remote = decide(n, hit, depth)
        decisions.append({"len": n, "hit": hit, "depth": depth,
                          "remote": remote})
        return remote

    disagg.router.prefill_remote = prefill_remote
    remote_prefill = disagg._remote_prefill

    async def timed_remote(request, context, res):
        t = time.monotonic()
        first = await remote_prefill(request, context, res)
        waits[context.id] = {"wait_s": time.monotonic() - t,
                             "landed": first is not None,
                             "skip_pages": res.skip_pages,
                             "pages": len(res.pages)}
        return first

    disagg._remote_prefill = timed_remote
    generate = disagg.generate

    async def tapped(req, ctx):
        rec = seen.setdefault(ctx.id, {"prompt": list(req.token_ids),
                                       "tokens": [], "ttft_s": None})
        t0 = time.monotonic()
        async for o in generate(req, ctx):
            if o.token_ids and rec["ttft_s"] is None:
                rec["ttft_s"] = time.monotonic() - t0
            rec["tokens"] += list(o.token_ids)
            yield o

    disagg.generate = tapped
    inject_chunk = disagg.transfer._inject_chunk

    async def timed_inject(h, body, st):
        t = time.monotonic()
        await inject_chunk(h, body, st)
        rid = h["request_id"]
        injects[rid] = injects.get(rid, 0.0) + time.monotonic() - t

    disagg.transfer._inject_chunk = timed_inject
    chunked, inject_pages = pre.extract_pages_chunked, dec.inject_pages

    async def captured_chunks(page_ids, cp):
        async for c in chunked(page_ids, cp):
            if capture["on"]:
                capture["sent"].append(c[1:3])
            yield c

    async def captured_inject(page_ids, k, v):
        if capture["on"]:
            capture["landed"].append((k, v))
        await inject_pages(page_ids, k, v)

    pre.extract_pages_chunked = captured_chunks
    dec.inject_pages = captured_inject

    mdc = ModelDeploymentCard(name="disagg", kv_block_size=ps)
    handle, wrapper_pub = await serve_token_model(
        drt_d, mdc, disagg, namespace="dynamo", component="disagg")
    if wrapper_pub is not None:
        fail("phase 17: serve_token_model published from the wrapper")
    events = {"stored": 0, "removed": 0}

    async def count(msg):
        for ev in unpack(msg.payload):
            events[ev["kind"]] += len(ev["block_hashes"])

    await drt_d.dcp.subscribe(f"dynamo.disagg.{KV_EVENT_SUBJECT}", count)
    router = KvRouter(drt_d, "dynamo", "disagg", block_size=ps,
                      scrape_interval=0.25, seed=0)
    await router.start()
    # the publisher runs on the inner engine: the wrapper has no pm
    pub = KvEventPublisher(drt_d.dcp, "dynamo", "disagg", drt_d.instance_id,
                           dec)
    pub.start()
    client = await drt_d.namespace("dynamo").component("disagg") \
        .endpoint("generate_tokens").client()
    await client.wait_for_instances(30)
    processor = Processor(mdc, client, router)
    svc = HttpService()
    svc.manager.add_completions_model("disagg", processor.completion)
    await svc.start("127.0.0.1", 0)
    base = f"http://127.0.0.1:{svc.port}"
    pw = PrefillWorker(drt_p, pre, namespace="dynamo")
    send_once = pw._send_once

    async def recorded_send(client, req, local_send, remote_dst, first,
                            stats, deadline=None):
        await send_once(client, req, local_send, remote_dst, first, stats,
                        deadline)
        sends[req.request_id] = {**stats.to_dict(),
                                 "pages": len(local_send)}

    pw._send_once = recorded_send
    pw.start()
    await publish_config(drt_d.dcp, "dynamo", "disagg",
                         max_local_prefill_length=DISAGG_THRESHOLD)
    t0 = time.monotonic()
    while disagg.router.max_local_prefill_length != DISAGG_THRESHOLD:
        if time.monotonic() - t0 > 10:
            fail("phase 17: the published threshold never reached the "
                 "router's watch")
        await asyncio.sleep(0.02)
    replays0 = [e.graph_replays() for e in engines]
    walls = {}

    async def send(s, rid, ids):
        t = time.monotonic()
        async with s.post(base + "/v1/completions", json={
                "model": "disagg", "prompt": ids,
                "max_tokens": DISAGG_MAX_TOKENS},
                headers={"X-Request-Id": rid}) as r:
            if r.status != 200:
                fail(f"phase 17 {rid}: HTTP {r.status}: {await r.text()}")
            fin = (await r.json())["choices"][0]["finish_reason"]
        if fin not in ("length", "stop"):
            fail(f"phase 17 {rid}: finish {fin!r}")
        walls[rid] = time.monotonic() - t

    order = sorted(batch, key=lambda r: len(batch[r]))
    solo = ref["tap"]["solo1"]["prompt_ids"]
    int8_prompt = _variant(batch[long_rid], 2, cfg.vocab_size)
    t_serve = time.monotonic()
    async with aiohttp.ClientSession() as s:
        for rid in order:
            await send(s, f"seq-{rid}", batch[rid])
        await asyncio.gather(*(send(s, f"all-{rid}", batch[rid])
                               for rid in order))
        await send(s, f"again-{long_rid}", batch[long_rid])
        pw.chunk_pages = 0
        await send(s, "bulk-solo1", solo)
        pw.chunk_pages = DEFAULT_CHUNK_PAGES
        pw.compress_kv, capture["on"] = True, True
        await send(s, "int8-variant", int8_prompt)
        pw.compress_kv, capture["on"] = False, False
        rep["fallbacks_before"] = disagg.remote_fallbacks
        await pw.stop()
        disagg.prefill_timeout = DISAGG_TIMEOUT_S
        fb_rid = order[1]
        await send(s, f"fallback-{fb_rid}", batch[fb_rid])
    rep["serve_s"] = time.monotonic() - t_serve
    await pub.flush()
    await asyncio.sleep(0.5)
    replays1 = [e.graph_replays() for e in engines]
    rep["replays"] = {name: {k: replays1[i][k] - replays0[i][k]
                             for k in replays1[i]}
                      for i, name in enumerate(("prefill", "decode"))}
    rep["route_launches"] = dict(ops.DECODE_ROUTE_LAUNCHES)
    rep["prefill_route_launches"] = dict(ops.PREFILL_ROUTE_LAUNCHES)
    rep["launches"] = dict(ops.LAUNCHES)
    rep["replays_total"] = {"prefill": replays1[0], "decode": replays1[1]}
    rep["index_overlap"] = router.overlap_for(batch[long_rid],
                                              drt_d.instance_id)
    rep["index_blocks"] = router.indexer.tree.block_count()
    rep["events"] = events
    rep["stats"] = disagg.stats()
    rep["worker"] = pw.stats()
    rep["post_warmup_compiles_total"] = [
        e.stats()["post_warmup_compiles_total"] for e in engines]
    rep.update(decisions=decisions, waits=waits, sends=sends,
               injects=injects, walls=walls, requests=seen,
               capture=capture, long_rid=long_rid, order=order,
               fallback_rid=f"fallback-{fb_rid}", solo_prompt=solo,
               int8_prompt=int8_prompt)
    await router.stop()
    await svc.stop()
    await client.close()
    await handle.stop()
    await pub.stop()
    disagg.router.stop()
    await disagg.transfer.stop()
    for e in engines:
        await e.stop()
    await drt_p.shutdown()
    await drt_d.shutdown()
    return rep


def check_disagg(params, cfg, dev, rep: dict, ref: dict) -> dict:
    """Phase 17 (b)'s checks (module docstring); returns the token
    checks."""
    import math

    import numpy as np

    from dynamo_tpu_torch.engine.kv_compress import quantize_pages_np
    from dynamo_tpu_torch.ops import paged_attention as ops

    ps, L = 64, cfg.num_layers
    reqs, waits = rep["requests"], rep["waits"]
    # the decisions, request by request: a prompt's first serving finds
    # no page cached on the decode side, a repeat its full pages but the
    # last token's ((len - 1) // 64 pages)
    served, expect = set(), {}
    for rid in sorted(reqs, key=lambda r: list(rep["walls"]).index(r)):
        p = tuple(reqs[rid]["prompt"])
        n = len(p)
        hit = ((n - 1) // ps) * ps if p in served else 0
        if not rid.startswith("fallback"):
            served.add(p)
        expect[rid] = {"remote": n - hit > DISAGG_THRESHOLD,
                       "skip_pages": hit // ps,
                       "send_pages": math.ceil(n / ps) - hit // ps}
    for rid, e in expect.items():
        if (rid in waits) != e["remote"]:
            fail(f"phase 17 {rid}: went {'remote' if rid in waits else 'local'}"
                 f" where the router's rule sends it "
                 f"{'remote' if e['remote'] else 'local'}")
        if e["remote"] and waits[rid]["skip_pages"] != e["skip_pages"]:
            fail(f"phase 17 {rid}: skip_pages {waits[rid]['skip_pages']}, "
                 f"predicted {e['skip_pages']}")
    for d in rep["decisions"]:
        if d["remote"] != (d["len"] - d["hit"] > DISAGG_THRESHOLD):
            fail(f"phase 17: router decision {d}")
    fb = rep["fallback_rid"]
    landed = {rid for rid, w in waits.items() if w["landed"]}
    if landed != set(waits) - {fb} or waits[fb]["landed"]:
        fail(f"phase 17: remote requests that fell back: "
             f"{sorted(set(waits) - landed)} (only {fb} may)")
    st = rep["stats"]
    if (rep["fallbacks_before"], st["remote_fallbacks"]) != (0, 1):
        fail(f"phase 17: remote_fallbacks {rep['fallbacks_before']} before "
             f"the fallback request, {st['remote_fallbacks']} after")
    want_pages = sum(expect[r]["send_pages"] for r in landed)
    if st["kv_transfer_pages_total"] != want_pages:
        fail(f"phase 17: {st['kv_transfer_pages_total']} pages ingested, "
             f"{want_pages} non-cached prompt pages sent")
    if sorted(rep["sends"]) != sorted(landed):
        fail(f"phase 17: the worker sent {sorted(rep['sends'])}")
    for rid in landed:
        if rep["sends"][rid]["pages"] != expect[rid]["send_pages"]:
            fail(f"phase 17 {rid}: sent {rep['sends'][rid]['pages']} pages")
    bulk = rep["sends"]["bulk-solo1"]
    if bulk["chunks_sent"] != 0 or bulk["pages"] > 31:
        fail(f"phase 17: the bulk send {bulk}")
    # routes and launches
    if rep["post_warmup_compiles_total"] != [0, 0]:
        fail(f"phase 17: captures after warmup "
             f"{rep['post_warmup_compiles_total']}")
    pre_r, dec_r = rep["replays"]["prefill"], rep["replays"]["decode"]
    if pre_r["decode_window"] or pre_r["decode_step"] or \
            pre_r["spec_verify"] or pre_r["prefill"] <= 0:
        fail(f"phase 17: the prefill engine's replays {pre_r}")
    local = [r for r in reqs if r not in landed]
    if dec_r["prefill"] != len(local):
        fail(f"phase 17: the decode engine replayed {dec_r['prefill']} "
             f"prefill chunks for its {len(local)} local prompts {local}")
    tot_pre, tot_dec = rep["replays_total"]["prefill"], \
        rep["replays_total"]["decode"]
    K = rep["decode_steps"]
    n_dec = rep["launches"]["paged_attention_decode"]
    n_pf = rep["launches"]["paged_attention_prefill"]
    if tot_pre["decode_window"] or n_dec != tot_dec["decode_window"] * L * K:
        fail(f"phase 17: decode launches {n_dec} are not the decode "
             f"engine's window replays' ({tot_dec['decode_window']} x "
             f"{L * K}); prefill engine windows {tot_pre['decode_window']}")
    if n_pf != (tot_pre["prefill"] + tot_dec["prefill"]) * L:
        fail(f"phase 17: prefill launches {n_pf} are not the chunk "
             f"replays' x {L}")
    if rep["route_launches"] != only(ops.DECODE_ROUTES, "bf16_mma", n_dec):
        fail(f"phase 17: decode launches by route {rep['route_launches']}")
    if rep["prefill_route_launches"] != only(ops.PREFILL_ROUTES, "bf16",
                                             n_pf):
        fail(f"phase 17: prefill launches by route "
             f"{rep['prefill_route_launches']}")
    ev = rep["events"]
    if rep["index_overlap"] < (len(reqs[f"again-{rep['long_rid']}"][
            "prompt"]) - 1) // ps:
        fail(f"phase 17: the router's index holds {rep['index_overlap']} "
             f"of the long prompt's pages on the decode worker")
    if rep["index_blocks"] != ev["stored"] - ev["removed"] or \
            ev["stored"] <= 0:
        fail(f"phase 17: the index holds {rep['index_blocks']} blocks; "
             f"events stored {ev['stored']}, removed {ev['removed']}")
    # int8: finished, and every landed element within s/2 of the bf16
    # page it came from (plus the bfloat16 rounding of the result, half
    # an ulp: 2^-8 of its magnitude, and float32 slack)
    cap = rep["capture"]
    if not cap["sent"] or len(cap["sent"]) != len(cap["landed"]):
        fail(f"phase 17: int8 capture {len(cap['sent'])} chunks sent, "
             f"{len(cap['landed'])} landed")
    worst = 0.0
    for (sk, sv), (lk, lv) in zip(cap["sent"], cap["landed"]):
        for s_, l_ in ((sk, lk), (sv, lv)):
            _, scale = quantize_pages_np(s_)
            a = np.abs(s_.float().numpy())
            err = np.abs(l_.float().numpy() - s_.float().numpy())
            bound = (scale / 2 + a) * (1 + 2.0 ** -8) - a + scale * 1e-6
            worst = max(worst, float((err - bound).max()))
    if worst > 0:
        fail(f"phase 17: int8 pages past s/2 by {worst}")
    rep["int8_excess"] = worst
    cap.clear()
    if len(reqs["int8-variant"]["tokens"]) < 1:
        fail("phase 17: the int8 request gave no token")
    # greedy tokens: phase 4's (its cold batch's; the bulk request phase
    # 4's solo long prompt), under the margin rule
    tokens = {}
    for rid, rec in reqs.items():
        if rid == "int8-variant":
            continue
        if rid == "bulk-solo1":
            want = ref["tap"]["solo1"]["tokens"]
        else:
            want = ref["batch"][rid.split("-", 1)[1]]["tokens"]
        want = want[:DISAGG_MAX_TOKENS]
        tokens[rid] = margin_rule(params, cfg, dev, rec["prompt"], want,
                                  rec["tokens"],
                                  f"phase 17: {rid} against phase 4")
    return tokens


def disagg_phase(cfg, dev, params, ref) -> dict:
    """Phase 17: :func:`disagg_serving`, :func:`check_disagg`, and the
    records it prints (no speed is concluded: loopback on one card)."""
    t = time.monotonic()
    rep = asyncio.run(disagg_serving(cfg, dev, params, ref))
    rep["tokens"] = check_disagg(params, cfg, dev, rep, ref)
    rep["seconds"] = time.monotonic() - t
    log(f"  (a) {json.dumps(rep['a'])}")
    for rid, w in rep["waits"].items():
        rec = {"prompt_tokens": len(rep["requests"][rid]["prompt"]), **w,
               "inject_s": rep["injects"].get(rid),
               "sender": rep["sends"].get(rid),
               "worker_ttft_s": rep["requests"][rid]["ttft_s"]}
        log(f"  remote {rid}: {json.dumps(rec)}")
    for rid, rec in rep["requests"].items():
        if rid not in rep["waits"]:
            log(f"  local {rid}: prompt {len(rec['prompt'])} tokens, worker "
                f"TTFT {rec['ttft_s'] * 1e3:.1f} ms")
    brief = {k: rep[k] for k in (
        "warmup_s", "serve_s", "seconds", "replays", "route_launches",
        "prefill_route_launches", "index_overlap", "index_blocks", "events",
        "post_warmup_compiles_total", "int8_excess")}
    brief["decode_stats"] = {k: rep["stats"][k] for k in (
        "remote_prefills", "local_prefills", "remote_fallbacks",
        "remote_wait_total_s", "kv_transfer_bytes_total",
        "kv_transfer_pages_total", "kv_transfer_chunks_total",
        "kv_transfer_inject_seconds_total")}
    brief["worker"] = rep["worker"]
    log(f"  phase 17: {json.dumps(brief)}")
    for k in ("requests", "decisions", "solo_prompt", "int8_prompt",
              "capture"):
        rep.pop(k, None)
    return rep


# ------------------------------------------- phase 21: the host KV tier

# two 8B engines, one at a time (TIER_ENGINES): a device pool of 40 pages
# and a host tier of 64 (8 MiB of bf16 K and V a page: ~512 MiB pinned,
# about half in int8), batches of up to 4, the grids trimmed to what the
# traffic reaches (chunk lengths 64 and 512, batches 1 and 4)
TIER_ECFG = dict(num_pages=41, host_pages=64, max_batch=4,
                 batch_buckets=(1, 4), prefill_buckets=(64, 512),
                 evict_policy="lru")
# (a) the default tier (host_tier_int8 resolves True); (b) the lossless
# tier, restores drained 4 pages a drain, so the 9-page hit takes three
TIER_ENGINES = (("a int8", {}),
                ("b lossless", dict(host_tier_int8=False,
                                    tier_restore_chunk=4)))
# each request's tokens (greedy, with logprobs and the top TIER_TOP);
# the evictors: fresh 704-token prefixes (11 pages each, 12 with their
# tokens) sent one at a time, which push all of A's pages out of the
# pool (least recently freed first; 600-token ones left 3 of its 9 full
# pages on the device: each finish frees its partial last page)
TIER_MAX_TOKENS, TIER_TOP, TIER_EVICTORS, TIER_EVICTOR_LEN = 16, 5, 4, 704
# the int8 round trip's error bound, in scales: the grid's half step plus
# the float32 roundings of a/s and q*s (each at most 64 * 2**-24 of s)
TIER_HALF_STEP = 0.5 + 2 ** -17


async def tier_request(engine, ids: list) -> dict:
    """One greedy request of TIER_MAX_TOKENS with logprobs through the
    engine's generate: tokens, logprobs, top logprobs, TTFT (s) and the
    finish's cost block."""
    from dynamo_tpu_torch.llm.protocols.common import (OutputOptions,
                                                       PreprocessedRequest,
                                                       StopConditions)
    from dynamo_tpu_torch.runtime.engine import Context

    req = PreprocessedRequest(token_ids=list(ids), stop=StopConditions(
        max_tokens=TIER_MAX_TOKENS, ignore_eos=True))
    req.output = OutputOptions(logprobs=TIER_TOP)
    rec = {"tokens": [], "lp": [], "top": [], "ttft_s": None, "cost": None}
    t0 = time.monotonic()
    async for out in engine.generate(req, Context()):
        if out.token_ids and rec["ttft_s"] is None:
            rec["ttft_s"] = time.monotonic() - t0
        rec["tokens"] += out.token_ids
        rec["lp"] += out.logprobs or []
        rec["top"] += out.top_logprobs or []
        if out.finish_reason is not None:
            rec["cost"] = out.cost
    if len(rec["tokens"]) != TIER_MAX_TOKENS:
        fail(f"phase 21: a request gave {len(rec['tokens'])} of "
             f"{TIER_MAX_TOKENS} tokens")
    return rec


def tier_pages(engine, ids: list):
    """The device pages holding ``ids``' full blocks, by the page
    manager's hash map (None where a block is not on the device), and
    copies of them, K and V stacked [n, L, KV, ps, hd]."""
    import torch

    from dynamo_tpu_torch.engine.kv_manager import chain_hashes

    torch.cuda.synchronize()
    pages = [engine.pm.by_hash.get(h)
             for h in chain_hashes(ids, engine.ecfg.page_size)]
    if None in pages:
        return pages, None
    idx = torch.tensor(pages, device=engine.kv_k.device)
    return pages, tuple(pool.transpose(0, 1).index_select(0, idx).clone()
                        for pool in (engine.kv_k, engine.kv_v))


def tier_copy_rates(engine, pages: list) -> dict:
    """Offload ``pages`` into host slots 0.. and restore them in place,
    timed by CUDA events on the engine's stream: seconds, and GB/s of the
    pool's bytes (bf16 K and V) and of the bytes that crossed the link."""
    import torch

    tier, n = engine.tier, len(pages)
    pool_bytes = n * engine._page_bytes
    # one slot's bytes in every host buffer (values, and int8 scales)
    link = sum(h[0].nbytes for pair in tier.pools for h in pair
               if h is not None)
    out = {"pages": n, "pool_bytes": pool_bytes,
           "link_bytes": link * n}
    with engine.graphs.stream_ctx():
        for what in ("offload", "restore"):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                if what == "offload":
                    tier.offload((engine.kv_k, engine.kv_v), pages,
                                 list(range(n))).wait()
                else:
                    staged = tier.stage(list(range(n)), (
                        engine.kv_k.dtype, engine.kv_v.dtype))
                    tier.inject((engine.kv_k, engine.kv_v), staged, pages)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
            s = min(times)
            out[what] = {"s": s, "pool_GBps": pool_bytes / s / 1e9,
                         "link_GBps": link * n / s / 1e9}
    return out


async def tier_traffic(engine, prompt: list, rng) -> dict:
    """A cold, A again (the HBM-hit control), TIER_EVICTORS fresh prompts
    one at a time, A a third time (the host hit); with ``(b)``'s repeat
    the caller evicts and serves A once more. A's pages are read before
    its eviction and after its restore."""
    rep = {}
    try:
        rep["cold"] = await tier_request(engine, prompt)
        rep["control"] = await tier_request(engine, prompt)
        await pages_idle(engine, "phase 21")
        rep["before"] = tier_pages(engine, prompt)
        rep["evictors"] = await tier_evict(engine, rng)
        rep["host_hit"] = await tier_request(engine, prompt)
        await pages_idle(engine, "phase 21")
        rep["after"] = tier_pages(engine, prompt)
        if not engine.ecfg.host_tier_int8:
            # the serial control of the overlapped restore: A out again
            # (its blocks are still in the tier) and back in one drain
            engine.ecfg.restore_overlap = False
            await tier_evict(engine, rng)
            rep["serial"] = await tier_request(engine, prompt)
            await pages_idle(engine, "phase 21")
            rep["after_serial"] = tier_pages(engine, prompt)
    finally:
        await engine.stop()
    return rep


async def tier_evict(engine, rng) -> list:
    ids = [[int(x) for x in rng.randint(1000, 100000, TIER_EVICTOR_LEN)]
           for _ in range(TIER_EVICTORS)]
    return [(await tier_request(engine, p))["tokens"] for p in ids]


def tier_phase(cfg, dev, params, ref) -> dict:
    """Phase 21: the host KV tier on the 8B (phase 4's seed-0 weights,
    shared), one engine of TIER_ENGINES at a time, each warmed and freed
    before the next, on :func:`tier_traffic` with phase 4's long prompt A
    (625 tokens, 9 full pages of 64). Both: the host hit counts >= 9
    restored blocks and a restore wait above 0 in its cost block, the
    tier offloaded and restored pages, ``cache.restore`` events on the
    step timeline, no capture and no pinned allocation after warmup,
    every decode launch on bf16_mma (window replays x 32 x K) and every
    prefill launch on bf16 (chunk replays x 32). (a), the default int8
    tier: A's host-hit tokens the control's up to a plain-path near-tie
    (:func:`margin_rule`); the device ``quantize_pages`` of A's pages
    bitwise the same function's on the CPU (the JAX package's jitted
    arithmetic, held there by the CPU tests) and the numpy host form's
    int8 rows wherever its scale (a true division by 127) is the same
    float, its other scales one ulp away at most; the restored pages
    bitwise the bf16 cast of their device round trip, within s/2 an
    element of the pages before eviction before the cast. (b), the
    lossless tier, 4 pages a drain (A's restore gated over three): the
    restored pages, the host hit's tokens and every logprob bitwise the
    control's, then again with ``restore_overlap`` off. Records the
    cold, HBM-hit and host-hit TTFT of A, each restore batch's dispatch
    ms, the pinned pools' allocation time, and offload and restore
    GB/s."""
    import dataclasses

    import numpy as np
    import torch

    from dynamo_tpu_torch.engine import kv_compress
    from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.ops import paged_attention as ops

    prompt = max((r["prompt_ids"] for r in ref["batch"].values()), key=len)
    L = cfg.num_layers
    report = {"prompt_tokens": len(prompt)}
    launches = {"decode": 0, "prefill": 0}
    saved_timeline = os.environ.get("DYN_STEP_TIMELINE")
    os.environ["DYN_STEP_TIMELINE"] = "4096"
    try:
        for name, arm in TIER_ENGINES:
            ecfg = dataclasses.replace(EngineConfig(), **TIER_ECFG, **arm)
            t = time.monotonic()
            engine = TorchEngine(cfg, ecfg, params=params, device="cuda")
            n_graphs = engine.warmup()
            warm_s = time.monotonic() - t
            ops.reset_launch_counts()
            replays0 = engine.graph_replays()
            rep = asyncio.run(tier_traffic(engine, prompt,
                                           np.random.RandomState(21)))
            torch.cuda.synchronize()
            replays = {k: v - replays0[k]
                       for k, v in engine.graph_replays().items()}
            stats = engine.stats()
            dec = dict(ops.DECODE_ROUTE_LAUNCHES)
            pf = dict(ops.PREFILL_ROUTE_LAUNCHES)
            events = [e for e in engine.step_timeline.snapshot()
                      if e["kind"] == "cache.restore"]
            got = {
                "int8": ecfg.host_tier_int8, "warmup_s": warm_s,
                "graphs": n_graphs,
                "host_pool_MiB": engine.tier.nbytes / 2**20,
                "pinned_alloc_s": engine.tier.alloc_seconds,
                "pinned_allocs": engine.tier.pinned_allocs,
                "pinned_after_warmup": engine.tier.pinned_after_warmup,
                "post_warmup_compiles_total":
                    stats["post_warmup_compiles_total"],
                "offload_pages": stats["host_offload_pages_total"],
                "restore_pages": stats["host_restore_pages_total"],
                "ttft_ms": {k: rep[k]["ttft_s"] * 1e3
                            for k in ("cold", "control", "host_hit",
                                      "serial") if k in rep},
                "host_hit_cost": {k: rep["host_hit"]["cost"][k] for k in (
                    "prefix_hit_tokens", "device_hit_blocks",
                    "host_restored_blocks", "restore_wait_ms")},
                "restore_events": [{k: e[k] for k in (
                    "pages", "queued", "staged", "dispatch_ms")}
                    for e in events],
                "replays": replays, "route_launches": dec,
                "prefill_route_launches": pf}
            problems = []
            if got["post_warmup_compiles_total"] != 0:
                problems.append("captures after warmup")
            if got["pinned_after_warmup"] != 0:
                problems.append("pinned allocations after warmup")
            if got["host_hit_cost"]["host_restored_blocks"] < 9:
                problems.append("the host hit restored < 9 blocks")
            if got["host_hit_cost"]["restore_wait_ms"] <= 0:
                problems.append("no restore wait in the host hit's cost")
            if got["offload_pages"] <= 0 or got["restore_pages"] <= 0:
                problems.append("the tier moved no page")
            if not events:
                problems.append("no cache.restore event")
            K = ecfg.decode_steps
            if (dec.get("bf16_mma", 0) != sum(dec.values())
                    or dec["bf16_mma"] != replays["decode_window"] * L * K
                    or pf.get("bf16", 0) != sum(pf.values())
                    or pf["bf16"] != replays["prefill"] * L
                    or replays["decode_window"] <= 0
                    or replays["prefill"] <= 0):
                problems.append("attention launches off the bf16 routes or "
                                "not the replays'")
            pages, before = rep["before"]
            _, after = rep["after"]
            if before is None or after is None:
                problems.append("A's blocks not on the device")
            elif ecfg.host_tier_int8:
                got.update(tier_int8_checks(before, after, kv_compress))
                got["tokens"] = margin_rule(
                    params, cfg, dev, prompt, rep["control"]["tokens"],
                    rep["host_hit"]["tokens"],
                    f"phase 21 {name}: the host hit against the control")
                if not got["restored_roundtrip_bitwise"]:
                    problems.append("restored pages are not their int8 "
                                    "round trip")
                if got["restored_excess_over_half_step"] > 0:
                    problems.append("restored pages beyond s/2")
                if not got["quantize_device_bitwise_cpu"]:
                    problems.append("device quantize_pages differs from "
                                    "the CPU's")
                if not got["quantize_np_agrees"]:
                    problems.append("device quantize_pages off the numpy "
                                    "form beyond one scale ulp")
            else:
                if len([e for e in events if e["pages"] <= 4]) < 3:
                    problems.append("the 9-page restore did not take three "
                                    "drains of at most 4 pages")
                if rep["serial"]["cost"]["host_restored_blocks"] < 9:
                    problems.append("the serial control restored < 9 "
                                    "blocks")
                for key, pages_key in (("host_hit", "after"),
                                       ("serial", "after_serial")):
                    _, pg = rep[pages_key]
                    same = (pg is not None
                            and all(torch.equal(x, y)
                                    for x, y in zip(pg, before)))
                    exact = all(rep[key][k] == rep["control"][k]
                                for k in ("tokens", "lp", "top"))
                    got[f"{key}_pages_bitwise"] = same
                    got[f"{key}_tokens_logprobs_bitwise"] = exact
                    if not (same and exact):
                        problems.append(f"{key}: pages or tokens and "
                                        f"logprobs not bitwise the "
                                        f"control's")
            if before is not None:
                got["copy_rates"] = tier_copy_rates(engine, pages[:9])
            log(f"  {name}: {json.dumps(got)}")
            if problems:
                fail(f"phase 21 {name}: {'; '.join(problems)}")
            launches["decode"] += dec["bf16_mma"]
            launches["prefill"] += pf["bf16"]
            report[name] = got
            del engine, rep
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if saved_timeline is None:
            os.environ.pop("DYN_STEP_TIMELINE", None)
        else:
            os.environ["DYN_STEP_TIMELINE"] = saved_timeline
    report["attention_launches"] = launches
    return report


def tier_int8_checks(before, after, kv_compress) -> dict:
    """(a)'s page checks: ``before`` and ``after`` are A's pages (K, V)
    before eviction and after the restore, on the card."""
    import numpy as np
    import torch

    out = {"quantize_device_bitwise_cpu": True, "quantize_np_agrees": True,
           "np_scale_rows_differing": 0, "restored_roundtrip_bitwise": True,
           "restored_excess_over_half_step": 0.0,
           "restored_max_err_over_s": 0.0}
    for b, a in zip(before, after):
        q, s = kv_compress.quantize_pages(b)
        qc, sc = kv_compress.quantize_pages(b.cpu())
        out["quantize_device_bitwise_cpu"] &= bool(
            torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc))
        qn, sn = kv_compress.quantize_pages_np(b.cpu())
        s_np = s.cpu().numpy()
        same = s_np == sn
        ulps = np.abs(s_np.view(np.int32).astype(np.int64)
                      - sn.view(np.int32).astype(np.int64))
        rows_same = np.broadcast_to(same, qn.shape)
        out["np_scale_rows_differing"] += int((~same).sum())
        out["quantize_np_agrees"] &= bool(
            ulps.max() <= 1
            and np.array_equal(q.cpu().numpy()[rows_same], qn[rows_same]))
        deq = kv_compress.dequantize_pages(q, s)
        out["restored_roundtrip_bitwise"] &= bool(
            torch.equal(a, deq.to(a.dtype)))
        ratio = ((deq - b.float()).abs() / s).max().item()
        out["restored_max_err_over_s"] = max(
            out["restored_max_err_over_s"], ratio)
        out["restored_excess_over_half_step"] = max(
            out["restored_excess_over_half_step"], ratio - TIER_HALF_STEP)
    return out


# ------------------------------------------- phase 18: the batch launcher

# the launcher's benchmark mode on the 8B: phase 4's cold-batch prompts,
# each answer capped at BATCH_MAX_TOKENS, traced by torch.profiler; one
# request at a time (the warmup's graphs, and with them the trace, are
# half a batch of 4's)
BATCH_MAX_TOKENS = 32
BATCH_ARGV = ["out=torch", "--model", "8b", "--max-batch-size", "1",
              "--max-tokens", str(BATCH_MAX_TOKENS), "--context-length",
              "4096"]
BATCH_KERNELS = ("paged_decode_bf16_kernel", "paged_prefill_bf16_kernel")


def trace_names(path: str, names) -> set:
    """Which of ``names`` occur in the file at ``path``, read in chunks (a
    trace of the 8B's warmup and serving runs to hundreds of MB)."""
    found, tail, width = set(), b"", max(len(n) for n in names)
    with open(path, "rb") as f:
        while len(found) < len(names):
            block = f.read(1 << 24)
            if not block:
                break
            text = tail + block
            found |= {n for n in names if n.encode() in text}
            tail = text[-width:]
    return found


def batch_phase(cfg, out_dir: str) -> dict:
    """Phase 18: ``python -m dynamo_tpu_torch.run in=batch:FILE out=torch
    --model 8b --max-batch-size 1 --max-tokens 32 --context-length 4096
    --profile-dir DIR`` on the card: the 8B at full width with phase 4's
    seed-0 weights, FILE holding phase 4's four cold-batch prompts. Its
    output must be a line a request (``tokens_in`` the prompt's words,
    ``tokens_out`` in [0, 32]) and the aggregate; the rank's serving
    summary (standard error) no capture after warmup, every attention
    launch from a replay on the bf16 routes (decode: window replays x 32
    x K, prefill: chunk replays x 32), both kernels launched, and windows
    enough for 31 tokens after the first; the Chrome trace in DIR must
    name both hand kernels. ``tokens_out`` counts the chunks that carried
    text (the reference's definition): the random 8B's tokens are mostly
    ids past the byte tokenizer's 256 bytes, which decode to nothing."""
    from dynamo_tpu_torch.engine.torch_engine import EngineConfig
    from dynamo_tpu_torch.ops import paged_attention as ops

    path = os.path.join(out_dir, "batch.jsonl")
    with open(path, "w") as f:
        for _, _, prompt, _, _ in DYN_BATCH:
            f.write(json.dumps({"text": prompt}) + "\n")
    prof = os.path.join(out_dir, "trace")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.run", f"in=batch:{path}",
           *BATCH_ARGV, "--profile-dir", prof]
    log(f"  {' '.join(cmd[1:])}")
    t = time.monotonic()
    try:
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=420)
    except subprocess.TimeoutExpired as e:
        fail(f"phase 18: the batch launcher ran past 420 s:\n"
             f"{(e.stderr or '')[-3000:]}")
    seconds = time.monotonic() - t
    if proc.returncode != 0:
        fail(f"phase 18: the batch launcher exited {proc.returncode}:\n"
             f"{proc.stderr[-4000:]}")
    err = proc.stderr
    ready = json.loads(err.split("engine ready ", 1)[1].splitlines()[0])
    export = [ln for ln in err.splitlines() if "profiler trace written" in ln]
    log(f"  engine ready {json.dumps(ready)}; "
        f"{export[-1].split(': ', 1)[-1] if export else 'no trace line'}")
    rows = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]
    if len(rows) != len(DYN_BATCH) + 1 or "aggregate" not in rows[-1]:
        fail(f"phase 18: expected {len(DYN_BATCH)} request lines and the "
             f"aggregate:\n{proc.stdout[-3000:]}")
    lines, agg = rows[:-1], rows[-1]["aggregate"]
    words = [len(prompt.split()) for _, _, prompt, _, _ in DYN_BATCH]
    # tokens_out counts the chunks that carried text (the reference's
    # definition): the random 8B's tokens are mostly ids past the byte
    # tokenizer's 256 bytes, which decode to nothing, so it may be 0
    if ([r["index"] for r in lines] != list(range(len(DYN_BATCH)))
            or [r["tokens_in"] for r in lines] != words
            or not all(0 <= r["tokens_out"] <= BATCH_MAX_TOKENS
                       for r in lines)
            or agg["requests"] != len(DYN_BATCH)):
        fail(f"phase 18: request lines {json.dumps(rows)}")
    summary = json.loads(err.split("serving summary ", 1)[1].splitlines()[0])
    L, K = cfg.num_layers, EngineConfig().decode_steps
    rep = summary["replays"]
    dec = summary["route_launches"]["bf16_mma"]
    pf = summary["prefill_route_launches"]["bf16"]
    problems = []
    if summary["post_warmup_compiles_total"] != 0:
        problems.append("captures after warmup")
    if dec <= 0 or pf <= 0:
        problems.append("a kernel never launched")
    if summary["route_launches"] != only(ops.DECODE_ROUTES, "bf16_mma", dec):
        problems.append("decode off the bf16 route")
    if summary["prefill_route_launches"] != only(ops.PREFILL_ROUTES, "bf16",
                                                 pf):
        problems.append("prefill off the bf16 route")
    if dec != rep["decode_window"] * L * K or pf != rep["prefill"] * L:
        problems.append("launches are not the replays'")
    # every request decodes its 31 tokens after the first: K a window
    if rep["decode_window"] * K < BATCH_MAX_TOKENS - 1:
        problems.append("fewer windows than --max-tokens needs")
    if problems:
        fail(f"phase 18: {problems}: {json.dumps(summary)}")
    trace = os.path.join(prof, "rank0.pt.trace.json")
    if not os.path.isfile(trace):
        fail(f"phase 18: no trace in {prof}: {os.listdir(prof)}")
    named = trace_names(trace, BATCH_KERNELS)
    if named != set(BATCH_KERNELS):
        fail(f"phase 18: the trace names {sorted(named)} of "
             f"{list(BATCH_KERNELS)}")
    report = {"seconds": seconds, "requests": lines, "aggregate": agg,
              "ready": ready, "summary": summary,
              "trace_bytes": os.path.getsize(trace),
              "trace_export": export[-1].split(": ", 1)[-1] if export
              else None}
    log(f"  phase 18: {json.dumps(report)}")
    return report


def time_step(kp, vp, ctx, B: int, P: int, H: int, g) -> dict:
    """The decode kernel in the single-step form the ``decode_steps=1``
    arm launches (paged_attention_decode_layered, no stats, no window),
    at rows of ``ctx`` positions (the newest key included) on layer 0 of
    ``kp``/``vp``: device time (CUDA graph), eager time, its plain
    version, one SDPA call on the same dense work, and the bound counted
    from the inputs (decode_work); held to the plain version at the
    dtype's tolerance."""
    import torch
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops.paged_attention import (
        DECODE_ROUTES, _decode_launch_plan, decode_reference, decode_work,
        paged_attention_decode_layered)
    from time_attention import decode_case

    dev = kp.device
    N, KV, ps, hd = kp.shape[1:]
    q, table, start, _, _, _ = decode_case(kp, vp, ctx, B, P, 1, H, g)
    ln = start.clamp(min=0).to(torch.int32)
    lo = torch.zeros_like(ln)
    dec = lambda: paged_attention_decode_layered(  # noqa: E731
        q, kp, vp, 0, table, ln)
    t_k, t_eager = time_ms(dec, iters=50), eager_ms(dec)
    t_p = time_ms(lambda: decode_reference(q, kp, vp, 0, table, ln, lo,
                                           hd ** -0.5), iters=5)
    got, want = dec(), decode_reference(q, kp, vp, 0, table, ln, lo,
                                        hd ** -0.5)[0]
    err = max_err(got, want)
    if excess(got, want, *tolerance(kp.dtype)) > 0:
        fail(f"single-step decode at {ctx}: max abs err {err:.3g}")
    S = P * ps
    kd = kp[0][table.long()].permute(0, 2, 1, 3, 4).reshape(B, KV, S, hd)
    vd = vp[0][table.long()].permute(0, 2, 1, 3, 4).reshape(B, KV, S, hd)
    mask = (torch.arange(S, device=dev)[None, :] < ln[:, None])[:, None,
                                                                 None]
    t_lib = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kd, vd, attn_mask=mask, enable_gqa=True), iters=50)
    live, keys, bytes_ = decode_work(ln, None, None, heads=H, kv_heads=KV,
                                     head_dim=hd,
                                     elem_bytes=kp.element_size())
    flops = 4 * keys * H * hd
    route, splits = _decode_launch_plan(q, kp, vp, B, P)
    return {
        "max_abs_err": err, "decode_route": DECODE_ROUTES[route],
        "splits": splits, "ms": t_k, "plain_ms": t_p,
        "bound_ms": max(bytes_ / H100_BYTES_PER_S,
                        flops / H100_BF16_FLOPS) * 1e3,
        "bound_by": ("bytes" if bytes_ / H100_BYTES_PER_S
                     >= flops / H100_BF16_FLOPS else "operations"),
        "library_ms": t_lib, "eager_ms": t_eager,
        "work": {"rows": live, "kv_positions": keys, "bytes": bytes_,
                 "flops": flops},
        "shape": {"B": B, "H": H, "KV": KV, "hd": hd, "ps": ps, "P": P,
                  "pool": list(ctx)}}


def time_verify(k0, v0, ctx, B: int, P: int, T: int, H: int, g) -> dict:
    """The prefill kernel in the verify step's shape: B rows of T = K + 1
    queries, row b at positions ctx[b] .. ctx[b] + T - 1 (from anywhere
    in a page; rows past len(ctx) padding), the row's earlier positions
    in the pool ``k0``/``v0`` [N, KV, ps, hd]: device time (CUDA graph),
    eager time, its plain version, SDPA on the same work and the bound
    counted from the inputs (prefill_work); held to the plain version at
    the dtype's tolerance."""
    import torch
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops import paged_attention as ops
    from dynamo_tpu_torch.ops.paged_attention import (
        paged_attention_prefill, prefill_reference, prefill_work)

    dev = k0.device
    N, KV, ps, hd = k0.shape
    el = k0.element_size()
    used = [-(-(n + T) // ps) for n in ctx]
    perm = torch.randperm(N - 1, generator=g, device=dev)[:sum(used)] + 1
    table = torch.zeros((B, P), dtype=torch.int32, device=dev)
    pos = torch.full((B, T), -1, dtype=torch.int32, device=dev)
    at = 0
    for b, (n, u) in enumerate(zip(ctx, used)):
        table[b, :u] = perm[at:at + u]
        at += u
        pos[b] = torch.arange(n, n + T, device=dev)
    qf = torch.randn(B, T, H, hd, generator=g, device=dev).to(k0.dtype)
    pf = lambda: paged_attention_prefill(qf, k0, v0, table, pos)  # noqa: E731
    t_k, t_eager = time_ms(pf, iters=50), eager_ms(pf)
    scale = hd ** -0.5
    t_p = time_ms(lambda: prefill_reference(qf, k0, v0, table, pos, scale),
                  iters=5)
    got, want = pf(), prefill_reference(qf, k0, v0, table, pos, scale)
    err = max_err(got, want)
    if excess(got, want, *tolerance(k0.dtype)) > 0:
        fail(f"verify-shaped prefill at {ctx}: max abs err {err:.3g}")
    S = P * ps
    kd = k0[table.long()].permute(0, 2, 1, 3, 4).reshape(B, KV, S, hd)
    vd = v0[table.long()].permute(0, 2, 1, 3, 4).reshape(B, KV, S, hd)
    qpos = pos[:, :, None].long()
    kvpos = torch.arange(S, device=dev)[None, None, :]
    mask = ((kvpos <= qpos) | (qpos < 0))[:, None]
    t_lib = time_ms(lambda: F.scaled_dot_product_attention(
        qf.transpose(1, 2), kd, vd, attn_mask=mask, enable_gqa=True),
        iters=50)
    queries, pairs, keys = prefill_work(pos)
    bytes_ = (2 * keys * KV * hd * el + 2 * queries * H * hd * el
              + table.numel() * 4 + pos.numel() * 4)
    flops = 4 * pairs * H * hd
    return {
        "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
        "prefill_route": ops.PREFILL_ROUTES[ops.prefill_route(
            k0.dtype, H, KV, ps, hd)],
        "bound_ms": max(bytes_ / H100_BYTES_PER_S,
                        flops / H100_BF16_FLOPS) * 1e3,
        "bound_by": ("bytes" if bytes_ / H100_BYTES_PER_S
                     >= flops / H100_BF16_FLOPS else "operations"),
        "library_ms": t_lib, "eager_ms": t_eager,
        "work": {"queries": queries, "pairs": pairs, "kv_positions": keys,
                 "bytes": bytes_, "flops": flops},
        "shape": {"B": B, "T": T, "starts": list(ctx), "H": H, "KV": KV,
                  "hd": hd, "ps": ps, "P": P}}


# --------------------------------------------------------------- main


def main() -> None:
    if sys.argv[1:2] == ["--dyn-role"]:
        # a process of phase 16 (a):
        #   --dyn-role worker|frontend --dyn-stamps PATH -- <launcher argv>
        sys.path.insert(0, REPO)
        dyn_role(sys.argv[2], sys.argv[4], sys.argv[sys.argv.index("--") + 1:])
        return
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the full results as JSON here")
    # one rank of phase 7's logits check (the script starts them itself)
    ap.add_argument("--tp-worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp-coordinator", help=argparse.SUPPRESS)
    ap.add_argument("--tp-dir", help=argparse.SUPPRESS)
    ap.add_argument("--tp-int8", help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.monotonic()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA GPU available")
    if not os.path.isdir(os.path.join(REPO, "dynamo_tpu_torch")):
        fail("dynamo_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, REPO)
    if args.tp_worker is not None:
        tp_worker(args.tp_worker, args.tp_coordinator, args.tp_dir,
                  args.tp_int8)
        return
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    from dynamo_tpu_torch.ops import build

    log("phase 1: build kernels")
    t = time.monotonic()
    build.build_all()
    for src, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "error")):
                log(f"  {src}: {line.strip()}")
    log(f"  built {build.sources()} in {time.monotonic() - t:.1f}s")

    log("phase 2: decode kernel vs plain version")
    dec_errs = check_decode(dev)
    win_errs = check_window(dev)
    log("phase 3: prefill kernel vs plain version")
    pf_errs = check_prefill(dev)

    log("phase 4: serve Llama-3-8B-shaped requests over HTTP")
    from dynamo_tpu_torch.engine.torch_engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.llama3_8b()
    t = time.monotonic()
    engine = TorchEngine(cfg, EngineConfig(), seed=0, device="cuda")
    engine.warmup()
    # the default engine warms the plain and the logprobs variants
    topn = engine.ecfg.max_top_logprobs
    check_warmed(engine, [(0, 0), (topn, 0)], [0, topn])
    log(f"  8B engine (32 layers, D=4096, V=128256, bf16, seed 0) built and "
        f"warmed up in {time.monotonic() - t:.1f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    mdc = ModelDeploymentCard(name="llama3-8b-random")
    mdc.kv_block_size = engine.ecfg.page_size
    served, ttft, solo_ref = asyncio.run(serve_and_check(engine, mdc,
                                                         operator=True))
    log(f"  operator surface: {json.dumps(served['operator'])}")
    log(f"  served: {json.dumps({k: v for k, v in served.items() if k != 'operator'})}")
    logprobs_check = check_logprobs(engine, cfg, dev, solo_ref)
    for batch_name, stages in (
            ("cold", ttft["cold"]),
            *((f"warm {k + 1}", w) for k, w in enumerate(ttft["warm"])),
            ("prefix-hit", ttft["prefix_hit"])):
        log(f"  TTFT stages, {batch_name} batch: {json.dumps(stages)}")
    log(f"  TTFT stages, warm min-max per request: "
        f"{json.dumps(ttft['warm_spread'])}")
    log(f"  bucket_cost, sampled batch: "
        f"{json.dumps(ttft['bucket_cost_sampled'])}")
    paths, tp1_logits = check_paths(engine, cfg, dev)
    graph_window = check_graph_window(engine, cfg, dev)
    graph_prefill = check_graph_prefill(engine, dev)
    graph_window_lp = check_graph_window(engine, cfg, dev, topn=topn)
    graph_prefill_lp = check_graph_prefill(engine, dev, topn=topn)

    log("phase 5: kernel timings at the serving shapes")
    # the first prefill chunk of the long prompt (r1-stream)
    served["prefill_chunk"] = min(served["prompt_tokens"]["r1-stream"],
                                  engine.ecfg.prefill_chunk)
    rows = time_kernels(engine, cfg, dev, served)
    tokens_total = served["tokens_total"]
    for r in rows:
        r["launches_per_token"] = r["launches"] / max(tokens_total, 1)
        log_kernel_row(r)

    log("phase 6: the tensor-parallel wrappers at one rank's heads "
        f"(tp {', '.join(map(str, TP_SIZES))})")
    local_errs = check_local_shapes(dev)
    local_times = time_local_shapes(dev, engine.ecfg, served)

    log("phase 15: the synchronous decode arms on the 8B (phase 4's "
        "weights): pipelined budgeted mixing, speculative decoding, "
        "single-step decode")
    sync_report = sync_arms_phase(cfg, dev, engine.params)
    for name, key, n in (
            ("paged_attention_decode step", "c single step",
             sync_report["c single step"]["route_launches"]["bf16_mma"]),
            ("paged_attention_prefill verify", "b spec",
             sync_report["b spec"]["graph_replays"]["spec_verify"]
             * cfg.num_layers)):
        row = next(r for r in rows if r["name"] == name)
        row["launches"] = n
        if n <= 0:
            fail(f"{name}: not launched on its served path ({key})")
    log("phase 16: the distributed runtime: the 8B as a worker process "
        "behind the frontend process, then two 8B engines behind the KV "
        "router")
    dyn_report = runtime_phase(cfg, dev, engine.params, solo_ref["batch"])
    # phase 16's attention launches join the served path's: the worker's
    # (its serving summary) and the routed engines'
    for name, key, route in (("paged_attention_decode", "route_launches",
                              "bf16_mma"),
                             ("paged_attention_prefill",
                              "prefill_route_launches", "bf16")):
        n = (dyn_report["worker"]["summary"][key][route]
             + dyn_report["routed"][key][route])
        row = next(r for r in rows if r["name"] == name)
        row["launches"] += n
        if n <= 0:
            fail(f"{name}: not launched in phase 16")
    log("phase 17: disaggregated prefill/decode: a prefill worker's engine "
        "computes the 8B's prompts and streams their KV pages into a "
        "decode engine's pool")
    disagg_report = disagg_phase(cfg, dev, engine.params, solo_ref)
    for name, key, route in (("paged_attention_decode", "route_launches",
                              "bf16_mma"),
                             ("paged_attention_prefill",
                              "prefill_route_launches", "bf16")):
        n = disagg_report[key][route]
        next(r for r in rows if r["name"] == name)["launches"] += n
        if n <= 0:
            fail(f"{name}: not launched in phase 17")
    log("phase 21: the host KV tier on the 8B (phase 4's weights): phase "
        "4's long prompt evicted to pinned host memory and restored, on the "
        "int8 tier and on the lossless one")
    tier_report = tier_phase(cfg, dev, engine.params, solo_ref)
    for name, key in (("paged_attention_decode", "decode"),
                      ("paged_attention_prefill", "prefill")):
        n = tier_report["attention_launches"][key]
        next(r for r in rows if r["name"] == name)["launches"] += n
        if n <= 0:
            fail(f"{name}: not launched in phase 21")
    log("phase 18: the launcher's batch mode on the 8B with --max-tokens, "
        "--context-length and --profile-dir")
    batch_dir = tempfile.mkdtemp(prefix="chip_smoke_batch_")
    try:
        batch_report = batch_phase(cfg, batch_dir)
    finally:
        shutil.rmtree(batch_dir, ignore_errors=True)
    for name, key, route in (("paged_attention_decode", "route_launches",
                              "bf16_mma"),
                             ("paged_attention_prefill",
                              "prefill_route_launches", "bf16")):
        next(r for r in rows if r["name"] == name)["launches"] += \
            batch_report["summary"][key][route]
    # the tp=1 engine leaves the card before the int8 one and the ranks
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 10: the int8 GEMM vs its plain version and timed; the 8B "
        "served with --dtype int8")
    int8_report, int8_rows, int8_logits = int8_phase(cfg, dev, tp1_logits)
    rows += [r for r in int8_rows if r["M"] in INT8_LINE_ROWS]

    # the ranks of phases 7 and 8 share the card with this process: hand
    # back what its allocator still caches
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 7: tensor-parallel serving, {TP_RANKS} ranks of the "
        f"launcher on the one card (this process holds "
        f"{torch.cuda.memory_reserved() / 2**30:.1f} GiB)")
    tp_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        tp_logits = check_tp_logits(tp1_logits, tp_dir)
        # the two launch forms side by side, the second started once the
        # first's ranks warm up: four ranks on the card, two groups (each
        # form's checks are its own)
        tp_served, tp_served_one = staggered(
            (serve_tp, cfg, tp_dir, False), (serve_tp, cfg, tp_dir, True),
            serve_logs(tp_dir, "llama3-8b-tp2", TP_RANKS, False), TP_RANKS)
    finally:
        shutil.rmtree(tp_dir, ignore_errors=True)

    log("phase 8: a BF16 HF checkpoint of the seed-0 8B weights, loaded "
        "and served with --model-path at tp=1 and tp=2")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        checkpoint, loaded = checkpoint_phase(cfg, dev, ckpt_dir, solo_ref,
                                              int8_logits)
        log("phase 9: penalties and logit_bias on an engine warmed with "
            "warmup_penalties, on the loaded weights")
        penalties = penalty_phase(cfg, dev, loaded)
        del loaded
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 11: a float32 Llama-3.2-1B-shaped engine served over HTTP "
        "on the float32 attention routes, then with int8 weights on the "
        "float32 forms of the int8 GEMM")
    f32_report = f32_phase(dev)

    log("phase 12: the 8B served in float16 over HTTP on the float16 forms "
        "of the bf16 attention kernels, then with int8 weights on the "
        "float16 forms of the int8 GEMM's tensor-core routes")
    f16_report = f16_phase(dev)

    log("phase 13: the generic prefill kernel served: the 1b in bfloat16 "
        "at page 8 over HTTP, then the tiny preset in bfloat16, float16 and "
        "float32")
    generic_report = generic_phase(dev)

    log("phase 14: Mistral-Large-2's widths (4 of 88 layers) in bfloat16 "
        "served over HTTP on the generic decode and prefill kernels")
    mistral_report = mistral_phase(dev)
    gen_row = next(r for r in rows
                   if r["name"] == "paged_attention_decode generic")
    gen_row["launches"] = mistral_report["served"]["route_launches"][
        "generic"]
    if gen_row["launches"] <= 0:
        fail(f"{gen_row['name']}: not launched on its served path (phase 14)")
    wide = generic_report[WIDE_SERVED]
    for name, n in (("paged_attention_decode generic wide",
                     wide["route_launches"]["generic"]),
                    ("paged_attention_prefill generic wide",
                     wide["prefill_route_launches"]["generic"])):
        row = next(r for r in rows if r["name"] == name)
        row["launches"] = n
        if n <= 0:
            fail(f"{name}: not launched on its served path (phase 13)")
    # the generic prefill rows take their launches from phase 13's engines
    # (its head_dim 16 or 64, another instantiation than the timed head
    # dim 96: the row's kernel says which shape each number is from)
    for dtype, (what, key, hd, held) in GENERIC_SERVED.items():
        rep = generic_report[key]
        row = next(r for r in rows
                   if r["name"] == f"paged_attention_prefill generic {dtype}")
        row["launches"] = rep.get("served", rep)["prefill_route_launches"][
            "generic"]
        if row["launches"] <= 0:
            fail(f"{row['name']}: not launched on its served path ({what})")
        row["kernel"] = (f"paged_prefill_generic_kernel ({dtype}): times "
                         f"and max_abs_err at head_dim 96, launches from "
                         f"{what} at head_dim {hd}, held to its plain "
                         f"version in {held}")
    # the float32 rows (attention, and the 1b's int8 products) take their
    # launches from phase 11, the float16 rows (attention and int8) theirs
    # from phase 12
    f16_served = f16_report["float16"]["served"]
    f16_int8 = f16_report["float16 int8"]["served"]["int8_gemm_launches"]
    f32_served = f32_report["float32"]["served"]
    f32_int8 = f32_report["float32 int8"]["served"]["int8_gemm_launches"]
    for r in rows:
        decode = r["name"].startswith("paged_attention_decode")
        if " generic " in r["name"]:  # phase 13's, above
            continue
        if "int8_route" in r:  # an int8 GEMM row
            if r["dtype"] == "float16":
                r["launches"] = f16_int8[r["int8_route"]]
            elif r["name"].startswith("int8_gemm 1b "):
                r["launches"] = f32_int8[r["int8_route"]]
            else:
                continue
        elif r["name"].endswith(" float16"):
            r["launches"] = (f16_served["route_launches"]["f16_mma"] if decode
                             else f16_served["prefill_route_launches"]["f16"])
        elif r["name"].endswith(" float32"):
            r["launches"] = f32_served[
                "route_launches" if decode
                else "prefill_route_launches"]["f32"]
        else:
            continue
        if r["launches"] <= 0:
            fail(f"{r['name']}: not launched on its served path "
                 f"({r.get('launches_from')})")
    log("phase 19: MoE at Mixtral-8x7B's widths (4 of 32 layers) in "
        "bfloat16 served over HTTP on both expert dispatches, the MoE block "
        "alone, then with int8 experts on the int8 GEMM")
    moe_report = moe_phase(dev)
    for name, key in (("paged_attention_decode", "decode"),
                      ("paged_attention_prefill", "prefill")):
        next(r for r in rows if r["name"] == name)["launches"] += \
            moe_report["attention_launches"][key]
    log("phase 20: MLA at DeepSeek-V2-Lite's widths (4 of 27 layers) in "
        "bfloat16 served over HTTP on the generic window and both expert "
        "dispatches, the blocks alone, then with int8 weights on the int8 "
        "GEMM")
    mla_report = mla_phase(dev)
    for r in rows:
        if (r.get("dtype") == "bfloat16"
                and r.get("int8_route") in ("small_m", "wgmma")
                and not r["name"].startswith("int8_gemm 1b ")):
            r["launches"] += (moe_report["int8"]["launches"][r["int8_route"]]
                              + mla_report["int8"]["launches"][
                                  r["int8_route"]])
    # the served tp=2 phase's rank 0 (rank 1 is checked equal): with a
    # mesh every kernel call goes through a sharded wrapper
    rank0 = tp_served["summaries"][0]["launches"]
    for name, line, src, kernel, launches, times in (
            ("paged_attention_decode_sharded", 161,
             "dynamo_tpu_torch/ops/csrc/paged_attention.cu",
             DECODE_KERNELS["bf16_mma"], rank0["paged_attention_decode"],
             local_times[2]["decode"]),
            ("paged_attention_prefill_sharded", 293,
             "dynamo_tpu_torch/ops/csrc/paged_prefill.cu",
             "paged_prefill_bf16_kernel", rank0["paged_attention_prefill"],
             local_times[2]["prefill"])):
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"dynamo_tpu/ops/paged_attention.py:{line}",
            "kernel": f"{name} (ops/paged_attention.py) -> {kernel}",
            "launches": launches, **times,
            "timed_at": "one rank's heads of tp=2 (two ranks share the "
                        "card in phase 7: not a TP speed)"})
        log_kernel_row(rows[-1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "served": served, "ttft": ttft,
                       "paths": paths, "graph_window": graph_window,
                       "graph_prefill": graph_prefill,
                       "graph_window_logprobs": graph_window_lp,
                       "graph_prefill_logprobs": graph_prefill_lp,
                       "logprobs": logprobs_check,
                       "checkpoint": checkpoint, "penalties": penalties,
                       "f32_1b": f32_report, "f16_8b": f16_report,
                       "generic_prefill": generic_report,
                       "mistral_large": mistral_report,
                       "mixtral_moe": moe_report,
                       "deepseek_mla": mla_report,
                       "sync_arms": sync_report,
                       "runtime": dyn_report,
                       "disagg": disagg_report,
                       "host_tier": tier_report,
                       "batch_launcher": batch_report,
                       "kernels": rows, "int8": int8_report,
                       "int8_gemm_timings": int8_rows,
                       "tp_local_errs": {" ".join(k): v for k, v in
                                         local_errs.items()},
                       "tp_local_times": local_times,
                       "tp_logits": tp_logits, "tp_served": tp_served,
                       "tp_served_one_command": tp_served_one,
                       "decode_errs": {" ".join(k): v
                                       for k, v in dec_errs.items()},
                       "window_errs": {" ".join(k): v
                                       for k, v in win_errs.items()},
                       "prefill_errs": {" ".join(k): v
                                        for k, v in pf_errs.items()},
                       "phase_start_s": {k: v - t_start for k, v in
                                         PHASE_START.items()},
                       "seconds": time.monotonic() - t_start}, f, indent=1)
    for r in rows:
        if r["route"] not in ("cuda", "triton"):
            fail(f"kernel row {r['name']}: route {r['route']!r}")
    keys = ("name", "route", "kernel", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
