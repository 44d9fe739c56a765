#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpuserve_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, run in order, each printing one JSON line; any failure exits
non-zero:

1. build     compile the four CUDA kernels from ``tpuserve_torch/csrc``, one
             nvcc each, all started together; count each library's wgmma
             (HGMMA) instructions, which the bf16 attention tile must
             contain, and read the tile's and the split-K decode kernels'
             registers and stack, and the decode kernels' shared memory.
2. kernels   hold each kernel against its plain PyTorch version at the
             shapes its path gives it (flash prefill: the main path's B=8 x
             1024 batch of 128-1024-token prompts; paged decode: B=8,
             32-token pages, 64 pages a sequence, then the main path's own
             lengths, one 2,048-token sequence alone and lengths at a
             split-K partition's edges; paged window: the chunked phase's
             last chunk of a 6,000-token prompt, 1,904 rows over 4,096
             cached tokens; ragged paged: the mixed phase's 512-row stream
             of 8 decode rows and a 480-row chunk, then each half alone),
             at further shapes (the speculative verify window, 8 x 5 rows
             over 1,024 cached tokens; the draft's 8 x 68 prefill;
             Phi-3-mini's prefill at head_dim 96, padded to 128 in the
             tile; decode at Qwen3-30B-A3B's group of 8 and at Gemma-2-2B's
             D=256 past a 4,096 window; D=96 in every kernel, float32,
             bf16 and int8), and in sliding-window/softcap and NaN-slot
             cases, with times: the kernel, the plain version, the least
             time the card could take (``bound_ms``) and, where one PyTorch
             call computes the same function, that call as a yardstick only
             (SDPA over K/V gathered beforehand for paged decode and
             window, and over the flat stream's K/V for ragged paged).  The
             flash, window and ragged headlines also carry a
             planted fault (a K/V tile's V zeroed) that the comparison must
             reject.
3. families  every other family the repo registers, at full width (at
             full depth but for ``FAMILY_LAYERS``: Mistral-7B, Gemma-2-2B,
             OPT-1.3B and Phi-3-mini at 8 layers, Gemma-3-4B at 12,
             Qwen3-30B-A3B at 24 of 48),
             weights made on the card from the seed: Qwen3-30B-A3B
             (128 experts, top-8, bf16): its prefill and decode steps
             captured (the pool under ``pool_bytes_bound``), 8 prompts of
             128-1,024 tokens x 64, launches against the steps, prefill
             ms and decode tok/s beside their bounds (every expert read
             each step: dense dispatch), the first step's logits against
             the plain attention (top-1 >= 0.75 free-running; within
             LOGIT_DIFF_MAX with each layer's experts pinned to the plain
             run's), layer 0's dense MoE against a routed-only float32
             loop (1e-3 relative); Mistral-7B in float32 (TF32 off): a
             6,000-token prompt in chunks and 256 tokens with the window
             release off, on, and on under n-gram speculation (the same
             tokens; released blocks = (tokens at the last release -
             4,096) // 32); Gemma-2-2B (6,000 tokens), Gemma-3-4B
             (2,048), OPT-1.3B and Phi-3-mini (head_dim 96; 8 prompts of
             128-1,024, 64 tokens) in float32: kernel and plain engines
             token-identical, nothing released; then each in bf16: the
             first step's logits and (windowed ones) the chunks' logits
             against the plain attention.  Before every engine phase:
             Qwen3-30B-A3B needs ~31 GB of the card at 24 layers.
4. breadth   the rest of the model breadth, weights made on the card: (a)
             DeepSeek-V2-Lite (MLA: a one-head 576-wide latent cache;
             64 experts top-6, 2 shared) in bf16 at full width, 8 of its
             27 layers (``FAMILY_LAYERS``), on the default engine, which downgrades its attention to the
             plain one (MLA's only path, as in the JAX engine): 8 prompts
             of 128-1,024 x 64, the eager engine's tokens; a chunked
             4,096-token prompt and its prefix hit; the absorbed decode
             step against the naive form (a prefill over the prompt and
             that token), each MoE layer's experts pinned to the naive
             run's, on two seeds, within eight bf16 steps at the logits'
             largest magnitude (``bf16_logit_gate``), free top-1 >= 0.75;
             no kernel launched; decode tok/s and prefill ms beside their
             bounds,
             weight GB, blocks, the pool against its bound.  Then in
             float32 (TF32 off) cut to 4 layers: graph and eager engines'
             tokens equal, absorbed against naive within 1e-3 (the check
             that catches a fault in the absorbed form; a step without
             its rope part is read beside, as in bf16), an int8 latent
             cache serving and its step within twice LOGIT_DIFF_MAX of a
             float32 cache's (a bf16 cache's beside), the same step with
             its scales swapped or its slices cut at 448 read above that
             gate, with one shared scale read beside.  (b)
             Qwen3-30B-A3B with int8 weights, made and quantized a layer
             at a time: its bytes at most 0.52 of bf16's,
             prefill logits against the dequantized weights (pinned
             experts) within LOGIT_DIFF_MAX, an engine sized to the card,
             8 x 64 tokens, launches against the steps, the pool under its
             bound, decode tok/s beside the dequantizing bound, blocks
             against what the same memory gives bf16.  (c) LoRA on
             Qwen3-0.6B, two PEFT adapters the script writes (rank 16,
             seven projections, one rsLoRA): in float32, merged ``a`` =
             the stack's ``a`` rows; a batch of base, ``a`` and ``b`` rows
             and a 6,000-token ``a`` prompt = each row alone, phase-split
             and mixed; bf16 decode tok/s with the stack against none;
             ``python -m tpuserve_torch.server --lora-modules`` with 8
             streams of mixed ``model`` fields, each echoed, ``/v1/models``
             and an adapter's embeddings refused.  The int8 and LoRA runs'
             launches go to the kernel report.
4a. tp      tensor and expert parallel ranks in lockstep
             (``tpuserve_torch/parallel/``), weights drawn on the card from
             the seed at full width: Qwen2-72B-Instruct at tp 4 (16 q and 2
             kv heads a rank) and Qwen3-30B-A3B at ep 4 (32 of 128 experts
             a rank), each in float32 (TF32 off) cut to 2 layers and in
             bf16 cut to 4.  First each kernel against its plain version
             and timed at a tp 4 rank's shapes.  Then a one-card reference
             in this process (``reference_run``; freed before the ranks
             start), then
             four ranks on the one card over gloo (NCCL refuses two ranks on
             a device), spawned through the launcher ``--tp`` uses, eager
             (gloo cannot be captured): rank 0 serves 4 prompts of 128-512
             x 16 greedy and one sampled request, a prefix hit (one chunk),
             and the 4 prompts on a mixed-batching engine; the followers
             mirror every step.  Gates: float32 greedy tokens equal to the
             reference's, bf16 first-step logits within ``bf16_logit_gate``
             with top-1 >= 0.75, every follower's window tokens equal rank
             0's, every rank's launches equal layers x its runs of each
             step kind (all four kernels on every rank of the dense grid),
             every rank exiting 0; the all-reduce ms a layer.  With two or
             more cards, the same on NCCL with captured graphs at tp /
             ep = min(4, cards), with decode tok/s beside the reference's;
             on one card the line says ``"nccl": "not run: 1 card"``.
4b. pp      pipeline stages (``tpuserve_torch/parallel/pipeline.py``),
             Qwen2-72B-Instruct at full width, float32 (TF32 off) cut to 4
             layers and bf16 cut to 8, each stage's layers (and stage 0's
             head) drawn on the card from the seed.  A one-card reference in
             this process, then four stages on the one card over
             gloo (activations staged through host memory), spawned through
             the launcher ``--pp`` uses, eager: rank 0 serves phase tp's 4
             prompts of 128-512 x 16 greedy, one sampled request and a
             prefix hit (prefilled batched: no chunk route under pp, nor on
             the reference), two prompts a prefill step (the JAX pipeline
             engine's prompt-score budget, kept); the stages follow.
             Gates: float32 greedy tokens equal to the reference's, bf16
             first-step logits within ``bf16_logit_gate``
             with top-1 >= 0.75, every stage's windows equal rank 0's, every
             stage's flash-prefill and paged-decode launches equal its
             layers x the microbatches it ran (both > 0), the head on stage
             0 alone, every rank exiting 0.  With two or more cards, the same
             on NCCL at pp = min(4, cards) with captured graphs (a replay
             adds its capture's launches and microbatches), 8 layers (the
             one-card reference holds no more), decode tok/s beside the
             reference's (with graphs and eager, read only then); on one
             card the line says ``"nccl": "not run: 1 card"``.
4c. ring     context parallelism (``parallel/ring_attention.py``) at
             Qwen2-72B-Instruct's attention shape, bf16: one 16,384-token
             prompt, 64 q / 8 kv heads of 128, over four gloo ranks on the
             card (4,096 rows a rank; K/V and the all-to-alls staged through
             host memory): ring attention and Ulysses (the flash kernel on
             each rank's 16 heads over the whole prompt) against the flash
             kernel on one rank over the whole prompt, within the bf16
             kernel gate; ms of each beside the one-rank call (with its
             bound and SDPA's time); the flash kernel launched once a rank
             a call by Ulysses, nothing by the ring.
4d. train    the fine-tuning step (``parallel/train.py``), Qwen3-0.6B at full
             width: (a) bf16 steps at 28 layers, a first one on one
             16-token row at learning rate 0 (its ms apart), then remat on
             and off, each from the seed's weights (learning rate 3e-4:
             every bf16 weight below 0.0625 moves): finite weights, the loss
             falls, the two steps' losses agree (``TRAIN_BF16_REMAT_GATE``),
             peak bytes past the weights, step ms; (b) a float32 step at 2
             layers (TF32 off) against the port's CPU step: the losses, and
             leaf by leaf the update and both moments relative to the
             leaf's norm, within ``TRAIN_LIMITS``; (c) dp 2 x tp 2 gloo
             ranks on the card at 2 float32 layers: each rank's slices
             against the one-rank step's, within the same limits.
5. identity  Qwen3-0.6B at full width, 2 layers, float32, no TF32: engines
             on the CUDA kernels and on the plain attention, decoding
             synchronously, give the same greedy tokens on the main path
             (and so does the default engine, with captured decode graphs
             and pipelined windows), on the chunked path (prompts of 37,
             2,500 and 5,000 tokens and a prefix hit on the 5,000-token
             prompt, also against an engine with chunking off) and on the
             mixed path (8 streams decoding while 8 prompts of 200-1,500
             tokens arrive, also against the phase-split engine).
6. main      the main path: a default engine (Qwen3-0.6B, 28 layers, bf16,
             random weights from the seed; every step a replayed CUDA
             graph, one a step kind and padded shape, decode windows
             pipelined) is warmed by ``Engine.warmup`` (its defaults),
             then every other executable it can make is captured, and the
             graph pool's bytes are held against ``pool_bytes_bound``; it
             serves 8 prompts of 128-1024 tokens through
             ``add_request``/``step``, then one sampled request repeating
             the first prompt (a prefix-cache hit, which the chunk route
             serves); each kernel's launch count must match the layers
             times its dispatches (the graphs' replays add their captured
             launches; each replay is counted by kind), and the first
             step's bf16 logits must agree with the plain attention path's
             (max |diff| at most LOGIT_DIFF_MAX, top-1 agreement at least
             0.75).  Then an engine that runs every step eagerly and
             decodes synchronously serves the same requests: the same
             tokens; both engines' TTFT, step times and decode tok/s.
7. graphs    the decode executables at full width, bf16, on 8 prefilled
             sequences of the main path's lengths: one decode step replayed
             from its graph against the same step run eagerly (logits
             bit-equal, or within the main phase's logits gate with the
             difference reported), a 32-token greedy window and a seeded
             temperature window replayed against eager (identical tokens);
             one prefill step (the main path's (8, 1024) batch), one chunk
             step (1,904 rows over 4,096 cached, in the 2,048 bucket) and
             one mixed step (8 decode rows and a 480-row chunk in 512
             rows) replayed against the same step run eagerly (logits and
             cache bit-equal); the main path's greedy streams with
             pipelining off on an engine not warmed (every executable
             captured on first use; launch counts still its steps'), and
             with pipelined single steps (``multi_step=1``), against the
             default engine's (identical).
8. sampler   the full sampler on the main path's two engines (the default
             one, every decode dispatch a replayed graph; the eager one),
             made on the first ``FEATURE_LAYERS`` (4) layers of the main
             weights at full width, prefix caching off for the phase: the main path's 8 prompts,
             64 tokens, in each sampling variant (greedy, temperature 0.8,
             full with top_p 0.9 and top_k 50, repetition_penalty 1.2,
             logprobs 5, top_k 1, min_p 1.0, logit_bias {eos: +100} with
             min_tokens 16).  Gates: the same tokens on both engines;
             top_k 1 gives the greedy streams and min_p 1.0 a token at its
             step's largest logprob every step (it samples among tokens
             tied there; whether it equals greedy is a reading); the floor gives
             16 tokens, then EOS; every logprobs entry within the logits
             gate of a fresh eager log_softmax of its step's logits, its
             top 5 sorted; launches equal to the layers times the steps;
             the graph pool under its bound.  Readings: decode tok/s of
             each variant on both engines, one profiled window each of the
             temperature and full modes and of logprobs, the decode
             executables and their capture seconds, and the KV blocks the
             cache sizing gives at the CLI's defaults with and without the
             sampler's decode executables (full mode and extras) bound.
9. guided    guided decoding on the sampler's two engines (4 layers of
             the main weights), prefix caching off: the 8 prompts, up to 64 tokens, in each spec
             family (json_object; a json_schema of a string, a boolean and
             an enum; one with an integer field, whose digit prefixes pass
             the FSM compile's state budget, so it runs the substitution
             path; a regex; a choice of three words), greedy and at
             temperature 0.8; 4 guided rows beside 4 unguided; two
             grammars in one batch (single steps); json_object with
             ``guided_fsm`` off (the substitution path).  Gates: every
             output a legal prefix of its spec and every stopped one a
             whole document; the same tokens on both engines; the FSM
             families' greedy tokens the same with single steps; guided
             windows dispatched; launches equal to the layers times the
             steps; the pool under its bound; the json_object requests with
             the mask disabled (a planted fault) fail the validity gate.
             Readings: the token-text table's and each spec's compile
             seconds, the guided executables' first-use capture seconds,
             decode tok/s of each family and of 129-token guided streams
             beside greedy ones, and one profiled guided window beside a
             greedy one.
10. chunked   the chunked path, full depth, bf16: 4 short streams, a
             6,000-token prompt served in chunks, then a prompt sharing its
             first 4,096 tokens, served from the prefix cache; each
             kernel's launches must be the layers times its steps (batched
             prefills, decode token steps, chunk steps), the prefix hit's
             first chunk must start at its cached offset, and chunk logits
             must agree with the plain path's.  The default engine, then
             the eager engine: the same tokens, both engines' TTFTs, step
             times and decode tok/s.
11. mixed    the mixed path, full depth, bf16, ``mixed_batching=True``: 8
             streams decoding, then 8 prompts of 512-1,500 tokens; each
             kernel's launches must be the layers times its steps, the
             ragged kernel's the layers times the mixed steps.  The default
             engine, then the eager engine, as in the chunked phase.
12. server   the top of the main path, full depth, bf16: the main phase's
             seed-0 weights written as an HF checkpoint (two bf16 shards,
             an index, no lm_head) and loaded back with
             ``load_hf_checkpoint``, bit-equal, with its GB/s; then
             ``OpenAIServer`` over ``Engine(checkpoint_dir=...)`` (the
             CLI's cache defaults), warmed, on a free port: (a) four greedy
             completions of 128-1,024-token prompts one at a time, two
             plain and two streamed, each equal token for token to a twin
             engine's ``generate`` of it alone (the same EngineConfig, the
             loaded weights); (b) a prefix hit of (a)'s 1,024-token prompt
             (the chunk route), then eight concurrent streams and a chat
             request: every stream complete and well formed, client-side
             TTFT and decode tok/s beside the twin's for the same prompts,
             and the share of streams equal to the twin's (a reading:
             concurrent arrivals batch differently); (c) a top_p request's
             200, a streamed chat with logprobs (every token's entry with
             its top 5), best_of 3 (one choice, three candidates billed),
             a bad json_schema's 400, /v1/models, and /metrics counting
             the tokens served, then a response_format json_schema and a
             guided_choice request, each full and streamed, a document of
             its spec, and /metrics' three guided counters; (d) the kernels'
             launches, reset before (a), against the engine's steps.
             The CLI on the checkpoint, as a subprocess, is phase
             provision's: the rendered deploy command.
12b. provision  the port's provisioner (``tpuserve_torch/provision``): (a)
             every preset's manifests, on gke and on local, as dicts
             through the port's validator; (b) the ``qwen3-0.6b-h100``
             engine container as rendered for gke (command, literal env,
             probes, one ``nvidia.com/gpu``, grace period); (c) that
             command as a subprocess on the server phase's checkpoint
             (full width and depth, bf16), only ``--checkpoint-dir``,
             ``--port`` and the ``/models`` root changed,
             ``CUDA_VISIBLE_DEVICES`` the one card; (d) the rendered
             gateway command in front of it; (e) ``/readyz`` within the
             rendered liveness budget, the provisioner's smoke tests
             ("Who are you?", 32 tokens) through the gateway inside a
             ``/debug/profile`` capture whose trace names B1's and B2's
             kernels, every family the provisioner's queries, alert rules
             and dashboard read from the engine on its ``/metrics``, one
             streamed greedy completion of the server phase's first
             prompt equal to the in-process server's, and both processes
             out with code 0 on SIGTERM (sent together), the engine within
             its drain timeout, the gateway within its grace period.  Logs
             in ``build/provision_*.log``.
13. tiers    the tiered KV cache at full depth, bf16, the main weights,
             greedy, ``TPUSERVE_STRICT_BLOCKS=1`` (the block and tier
             accounting checked every engine cycle): two requests over a
             3,072-token prefix (96 blocks) on a 384-block engine, its
             pages read with ``gather_block_pages``; 2,048-token churn
             prompts until every block of it is evicted (demoted: the
             store must hold the chain); then the prefix plus 128 new
             tokens, 32 greedy tokens.  With the 1 GiB host tier, then with
             a 64 MiB host budget and a spill directory under ``build/``.
             Gates: the restored blocks' pages bit-equal to the first read,
             through the engine's own cache, and a restore with one page
             zeroed failing that; the hit's tokens equal to a twin's that
             keeps the prefix on the card (1,024 blocks, the same chunk
             route); its launches against its steps; nothing left
             restoring; no tensor on the spill writer; then an in-process
             server on the host engine: churn over HTTP, the hit streamed
             (the twin's tokens), ``/healthz`` host blocks and a digest,
             ``/metrics`` demotes and restores.  Readings: the hit's TTFT
             host / spill / HBM / cold recompute (a ``kv_tiers=False``
             engine after the same churn), each demote's stall and GB/s,
             the restore's host time, the copies alone (GB/s each way),
             blocks demoted, spilled, dropped and restored, host bytes.
14. slo      SLO classes and the brownout ladder, full width and depth,
             greedy, ``TPUSERVE_STRICT_BLOCKS=1``: (a) a 256-token batch
             stream on a max_num_seqs=1 engine, an interactive request
             arriving once it holds 40 tokens: the interactive one finishes
             first (a class preemption), the batch stream resumes by
             re-prefill, launches equal to the layers times the steps; in
             float32 (the main weights' seed drawn in float32, TF32 off)
             its tokens equal an uninterrupted twin's, in bf16 up to the
             preemption (after it, where a bf16 re-prefill rounds unlike
             decode, the agreement is a reading); (b) an in-process server
             (max_num_seqs 8, max_waiting 64, bf16) takes a burst of 96
             streams of 512-token prompts and 128 tokens (64 batch, 24
             standard, 8 interactive, in that order, 10 ms apart) while
             /metrics is polled; after the drain one interactive request
             at a time keeps the engine ticking.  Gates: every request
             complete or 429 with Retry-After; no interactive 429; the
             level above 0 in the burst and back at 0 within hold_s x 4 +
             10 s of the drain; /healthz's brownout_level; 429s = the shed
             counter = the engine's; the kernels' launches = the layers
             times the steps; no block held.  Readings: TTFT p50/p99 and
             429s per class, preemptions, seconds at each level.
15. salvage  crash-only recovery on the CLI's engine (``--step-watchdog-s
             2``; captured graphs, pipelined 32-token windows; prefix
             caching off so runs repeat), full width, FEATURE_LAYERS (4)
             layers of the main weights, greedy,
             ``TPUSERVE_STRICT_BLOCKS=1``, in float32 and in bf16: (a) the
             main path's 8 prompts, 128 tokens, and a request whose id holds
             "poison" through the runner under
             ``decode_dispatch:raise:1.0:match=poison``: the poison alone
             fails, isolated by bisection; (b) a one-shot fault with a
             pipelined window in flight, among the rows a guided
             json_object row and a repetition_penalty row, at
             ``decode_dispatch`` and at ``window_flush``: the guided output
             legal, the dropped window's rows as planned; in bf16 the
             re-prefill's next-token logits on the kernels within
             LOGIT_DIFF_MAX of the plain attention's and of the twin's
             decode step's; (c) through the runner, a clean run with no
             watchdog trip, buckets met for the first time past the
             watchdog's warmup (a guided row beside logprobs and penalty
             rows: captured in the steps, no trip, no salvage), then a
             one-shot ``decode_dispatch:hang:1.0:count=1``: one trip, the
             hang released into salvage, no request failed.  Streams equal
             the fault-free twin's in float32; in bf16 whole, and the
             twin's up to the fault (after it a reading).  Readings:
             recovery time (the fault to each survivor's next token),
             tokens re-prefilled, salvaged, poisoned and trips, first-use
             capture seconds.  The flight recorder writes into a
             directory of each dtype's own: one ``flight-poison-*.json``
             naming the poison request, a ``flight-watchdog_trip-*.json``,
             and ``tpuserve_flight_postmortems_total`` equal to the files.
16. flight   the flight recorder and the host-phase profiler, on by
             default in every engine above: (a) the main path's 8
             prompts, 64 greedy tokens, on two default engines (prefix
             caching off), the recorder on and ``flight=False``,
             interleaved over 3 rounds after an untimed one: the same
             tokens, launches against the steps; decode tok/s, TTFT and
             the recorder's cost are readings; (b) the recording engine's
             step records: each kind one the engine runs, each record's
             phases within its wall (+0.5 ms), no ring entry but host
             values; the median ms of each phase by step kind; (c) the
             CLI's engine on the server phase's checkpoint in an
             in-process server, the recorder writing into a temporary
             ``TPUSERVE_FLIGHT_DIR``: 8 concurrent streams (their step
             records split the same way: the HTTP engine beside (b)), a
             prefix hit, chat requests with ``tools`` under
             ``tool_choice`` auto, required and a named function, full and
             streamed (200s; stop, length or tool_calls; no forced marker
             in a streamed delta); every request's
             ``/debug/requests/{id}`` timeline in order (the hit on the
             chunk route), ``/debug/engine`` (phased steps, SLIs,
             ``cold_start_s``), ``/healthz``, ``/debug/engine/dump``
             (schema 2, ring markers), launches against the steps.
17. spec     speculative decoding at full width on the first
             ``FEATURE_LAYERS`` (4) layers of the main weights (float32:
             the seed drawn at that depth): (a) a verify
             window (B=8, K=5, contexts 128-2,048, 1-5 valid rows) after a
             kernel prefill, through the paged window kernel and through
             the plain attention on a copy of the same cache: the valid
             rows' logits within LOGIT_DIFF_MAX, one launch a layer, argmax
             agreement a reading; (b) ``draft_propose`` (k=4 over (8, 68)
             windows) on the flash kernel against the plain attention, in
             bf16 and in float32 (TF32 off): each pass's logits within the
             logit gate (1e-3 in float32), the proposals equal wherever
             the plain top-2 gap (and every earlier pass's) exceeds twice
             it (in float32 some such positions required), 4 launches a
             layer; (c) three default engines, plain, n-gram (k=4) and
             an identity draft (the target as its draft, adaptive off),
             on 8 prompts of 64-192 tokens, 48 greedy tokens: in float32
             (TF32 off) token-identical with the draft's acceptance 100%,
             in bf16 each one's first divergence, acceptance and spec
             steps; launches against the steps (verify and draft replays
             counted); (d) sampled speculation (temperature 0.7, top_p
             0.9, seeded) twice on one engine: the same tokens; and
             ``spec_accept_sampled`` on the card: the first emitted token
             follows p̃ (the CPU marginal test's gates); (e) decode tok/s
             of the default engine with and without n-gram speculation,
             8 streams of 256 tokens, on an extractive workload (a
             512-token span repeated three times) and a free one (random
             1,536-token prompts): acceptance, spec steps, governor pauses,
             the spec executables' capture seconds, and the pool's bytes
             against ``pool_bytes_bound`` of every executable made (gated).
18. embed    the cache-less trunks at full width on the first
             ``FEATURE_LAYERS`` (4) layers of the main weights (float32:
             the seed drawn at that depth): (a)
             ``Engine.embed`` (mean and last pooling) and
             ``Engine.score_prompts`` of 8 inputs of 128-1,024 tokens on a
             kernel engine and a plain-attention engine: cosines at least
             0.999, chosen logprobs within LOGIT_DIFF_MAX, each rank inside
             the band the plain log-softmax allows when every logprob may
             move by that much (one rank where the gaps allow only one),
             one flash launch a layer a trunk batch;
             (b) ``/v1/embeddings`` (base64), prompt scoring and a streamed
             echo with logprobs through an in-process server: equal to the
             engine's own calls; (c) in float32, embeddings posted in a
             loop while 8 streams decode on a server engine not warmed
             (its decode bucket captured on first use amid the traffic):
             every request 200, no failed step, the streams' tokens equal
             a twin engine's without the traffic.
19. services the native block manager and the services around the card:
             (a) on the main weights, a default engine with the C++ block
             manager (it must hold a ``NativeBlockManager``) and one with
             the Python manager: the main path's 8 prompts x 64 greedy,
             twice (the second a prefix hit), the same tokens; host ms a
             step of each (the step records' host phases), a reading; at
             the phase's end a mixed step's idle share on the mixed
             phase's engine (torch.profiler, last: a profiler run slows
             the launches after it).  (b) the CLI's
             server in process (``build_parser``, ``engine_config``,
             ``server_config``: Qwen3-0.6B bf16 loaded from a checkpoint
             of weights drawn on the card and written under ``build/``,
             the default scheduler), holding the C++
             manager: decode tok/s of 8 streams of fresh prompts with the
             device profiler on and off, interleaved over 3 rounds
             (readings: the engine's over its window steps, the clients');
             its device seconds (CUDA events) positive and at most the
             steps' wall, one ladder entry a graph captured with the
             profiler on, the HBM watermark (weights, KV, the graphs'
             allocator bytes and executables, each counted apart) within
             5% of the card's used bytes that the server added; a 2 s ``/debug/profile`` capture
             while 8 streams decode and a 6,000-token prompt chunks, its
             trace naming ``flash_prefill_bf16``, ``paged_decode_kernel``
             and ``paged_window_bf16``; interactive requests breaching a
             10 ms TTFT objective: its fast burn fires and the auto-capture
             writes a second trace; the NVML exporter's name, power limit
             and frame buffer used against ``nvidia-smi``; two tenants at
             once, the 429s to the one whose token rate is below its
             traffic; the kernels' launches over (b).  (c) the model pool,
             catalog {Qwen3-0.6B, Llama-3.1-8B-Instruct at full width cut
             to 8 of its 32 layers}, one resident, a
             2 GiB host tier and a spill directory under ``build/``:
             requests alternating by ``model`` through swaps from cold (the
             8B's checkpoint, through the loader), the host tier (the 0.6B) and the spill
             files (the 8B, flushed first): the same greedy tokens after
             each swap back, the card's used memory after the round trip
             within 1 GiB of before; each swap's seconds, tier and bytes.
20. fleet    the fleet layer over the port's servers and engines, Qwen3-0.6B
             at full width and depth on the main weights (drawn once): (a)
             two ``OpenAIServer`` replicas in process (1,024 blocks each),
             nothing captured before they serve (each captures on first
             use while the other serves: the graphs' capture lock, F7)
             behind the port's ``Gateway`` (``health_interval_s`` 0.5, a
             backends file): 16 streamed greedy completions of 64 tokens
             from 4 prefix groups (a 1,024-token prefix, two keyed to each
             replica by rendezvous hashing, plus 64-256-token suffixes),
             each group's first request alone, then the other 12, 8 at a
             time: every request on the replica rendezvous predicts (8 at
             a time under a load slack of 8 cannot divert one), the
             replicas' ``tpuserve_prefix_cache_hits`` up by at least 12,
             every stream well formed, the kernels' launches equal to the
             layers times both engines' dispatches; then replica 2 leaves
             the backends file while 8 streams run on it (all 8 finish),
             the next 8 requests land on replica 1 only, and replica 2,
             listed again, is admitted by a passing probe; ``/gateway/status``
             at each step.  (b) replica 1's ``/debug/engine/dump`` as a
             workload (``workload_from_bundle``), replayed twice on the
             card (``replay``, the bundle's engine facts): equal token and
             SLI digests, outcome counts equal to the source's; then
             ``backtest`` with the default objectives twice: identical
             alert timelines.  (c) ``pool_replay`` of ``make_storm_workload``
             (60 requests of 512 tokens, 32 generated, classes 2:1:1) with
             the autoscale policy, at most 3 replicas, 32-token pages,
             twice: equal decision digests, the first scale-out before the
             first L3 entry and the first shed.  The wall speedups of (b)
             and (c) are readings.
20a. disagg prefill/decode disaggregation on the main weights: (a) in
             process, ``DisaggregatedEngine`` (both engines on the card,
             one weight tree) against the colocated engine: the main
             path's 8 prompts of 128-1,024 x 64 tokens and one request
             finishing at its prefill, in bf16 at full depth (the same
             tokens; the pair's launches against its engines' runs; the
             handoff's host ms and MB a request) and in float32 (TF32 off)
             cut to 4 layers (the same tokens); Mistral-7B (a 4,096
             window) in float32 cut to 4 layers, a 6,000-token prompt x 32
             (the same tokens, the decode side releasing blocks, the
             prefill side none); a guided_choice request whose first token
             opens a canonical-suffix plan (a choice in the choices, the
             plan handed over and released).  (b) two in-process servers
             as ``--role decode`` and ``--role prefill --decode-url``
             build them, float32 at 4 layers, nothing captured before
             they serve (F7): 8 concurrent streams through the prefill
             server equal to the colocated engine's tokens; the pool-full
             fallback: a decode pool of 48 blocks (1,504 tokens a
             sequence) holding a 640-token stream, slowed by a delay
             fault so that it holds them, answers a 1,000-token prompt's
             migration 503 (it fits a sequence, not the free blocks)
             twice, once a retry, and the prompt is decoded on the
             prefill pod, equal too; ``/internal/abort`` of an unknown id.
21. profile  where the time goes, under torch.profiler, after every
             counted run (a profiler run slows the launches that follow
             it): one prefill and one decode window of the main path, one
             steady pipelined window alone (the paged decode kernel must
             appear in the trace from the replays, at most layers x window
             times); then on the default and the eager engine of each
             path, one prefill step alone, one chunk step and one mixed
             step.  Each: wall and device-busy ms, the idle share and the
             host's calls that put work on the card.

The engines of the main, chunked and mixed phases are warmed
(``Engine.warmup``, and the buckets their requests hit, as a bench warms
its run's buckets) before their launch counts are reset, so each count
holds exactly the launches of the path driven.

Then the kernel report (with each headline's TFLOP/s and its bound's share
of its time), the card's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``.  Needs one CUDA card; exits non-zero
with no result without one, or without the ``tpuserve_torch`` package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

PHASES = ("build", "kernels", "families", "breadth", "tp", "pp", "ring", "train", "identity",
          "main", "graphs", "sampler",
          "guided", "chunked", "mixed", "server", "provision", "tiers", "slo", "salvage",
          "flight", "spec", "embed", "services", "fleet", "disagg", "profile")
# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): bf16 tensor cores, float32 CUDA cores, HBM.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# bf16 outputs are held at rtol 2e-2 and an atol of a tenth of the
# reference's standard deviation (at most 2e-2): over a few thousand keys
# the outputs themselves are ~0.02, where a fixed 2e-2 would pass a
# skipped K/V tile.
BF16_ATOL_SHARE, BF16_ATOL_MAX, BF16_RTOL = 0.1, 2e-2, 2e-2
SEED = 0
# The main path's prompt lengths: one prefill batch of B=8 x T=1024.
MAIN_LENGTHS = [128, 256, 384, 512, 640, 768, 896, 1024]
# bf16 first-step logits, kernel path against plain path, over 28 layers:
# 0.0625 on an H100, where |logit| reaches 3.34 (four bf16 steps of
# 0.0156 at 2-4); the gate is twice that.
LOGIT_DIFF_MAX = 0.125
# GPU clock cycles the card spins before each cold-timed call (~0.5 ms)
COLD_SPIN_CYCLES = 1_000_000
# The feature phases (sampler, guided, spec, embed) run the main weights'
# first FEATURE_LAYERS layers at full width: their gates hold two engines'
# tokens against each other and logits at the logits' own scale, which no
# depth enters, and at 28 layers their eager and profiled runs took 293 s
# of the script's limit.  The main path itself (main, graphs, chunked,
# mixed, server, ...) and the fleet keep all 28.
FEATURE_LAYERS = 4


def cut_depth(params, cfg, layers: int):
    """The first ``layers`` layers of a weight tree (the same tensors, no
    copy) and its config at that depth; every width stays."""
    return ({**params, "layers": params["layers"][:layers]},
            dataclasses.replace(cfg, num_layers=layers))


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2, cold: bool = False,
            stats: dict | None = None) -> float:
    """Ms of one ``fn()`` on the card: the mean over ``iters`` calls back to
    back.  ``cold``: overwrite a buffer larger than the 50 MB L2 before each
    call, as a decode step finds each layer's cache pages, time each call
    alone and take the median (a few calls in fifty read 2-8x the rest, on
    an H100 80GB HBM3, which moved a mean of fifty by up to 40%); ``stats``
    then also gets the mean, the measure before the median.  Between the
    overwrite and the start event the card spins (COLD_SPIN_CYCLES, ~0.5
    ms), which touches no memory: the host enqueues ``fn``'s launch
    meanwhile, so a wrapper slower on the host than the overwrite on the
    card does not add its enqueue time to the kernel's."""
    import statistics
    import torch
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters if cold else 1)]
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda") if cold else None
    torch.cuda.synchronize()
    if cold:
        for start, end in events:
            flush.zero_()
            torch.cuda._sleep(COLD_SPIN_CYCLES)
            start.record()
            fn()
            end.record()
    else:
        events[0][0].record()
        for _ in range(iters):
            fn()
        events[0][1].record()
    torch.cuda.synchronize()
    times = [s.elapsed_time(e) for s, e in events]
    if not cold:
        return times[0] / iters
    if stats is not None:
        stats["mean"] = sum(times) / iters
    return statistics.median(times)


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def fill_slots(cache, bt_row, positions, page: int, value: float) -> None:
    """``value`` into the cache slots of one sequence at ``positions``."""
    import torch
    pos = torch.tensor(list(positions), dtype=torch.long, device=cache.device)
    if pos.numel():
        cache[bt_row.long()[pos // page], pos % page] = value


def poison(kc, vc, bt_row, positions, page: int) -> None:
    """NaN into the cache slots of one sequence at ``positions``, as a fresh
    cache may hold in slots never written (an int8 cache cannot)."""
    if kc.dtype.is_floating_point:
        fill_slots(kc, bt_row, positions, page, float("nan"))
        fill_slots(vc, bt_row, positions, page, float("nan"))


def zeroed_slots(cache, bt_row, page: int):
    """A function (lo, hi) -> a copy of ``cache`` with one sequence's slots
    lo .. hi - 1 zeroed."""
    def zeroed(lo, hi):
        bad = cache.clone()
        fill_slots(bad, bt_row, range(lo, hi), page, 0.0)
        return bad
    return zeroed


def paged_cache(g, nb: int, page: int, Hkv: int, D: int, dtype: str, int8: bool):
    """Random K/V pages on the card in ``dtype``, or int8 with scales."""
    import torch
    from tpuserve_torch.ops import attention
    kf = torch.randn(nb, page, Hkv, D, generator=g, device="cuda")
    vf = torch.randn(nb, page, Hkv, D, generator=g, device="cuda")
    if int8:
        kc, ks = attention.quantize_kv(kf)
        vc, vs = attention.quantize_kv(vf)
        return kc, vc, ks, vs
    return kf.to(getattr(torch, dtype)), vf.to(getattr(torch, dtype)), None, None


def attended(ctx: int, n: int, window) -> tuple[int, int]:
    """(query-key pairs, distinct keys) that n query rows at cache
    positions ctx .. ctx + n - 1 attend: each row every key at or before
    it, within the window."""
    if window is None:
        return n * ctx + n * (n + 1) // 2, ctx + n
    pairs = sum(min(ctx + i + 1, window) for i in range(n))
    return pairs, ctx + n - max(0, ctx - window + 1)


def tolerance(ref, dtype: str) -> dict:
    """fp32: atol 1e-4.  bf16: see BF16_ATOL_SHARE; ``ref`` holds the
    reference's valid rows."""
    if dtype == "float32":
        return dict(atol=1e-4, rtol=0.0)
    std = ref.float().std().item()
    return dict(atol=min(BF16_ATOL_MAX, BF16_ATOL_SHARE * std), rtol=BF16_RTOL)


def compare(out, ref, tol: dict) -> tuple[float, bool]:
    import torch
    err = (out.float() - ref.float()).abs().max().item()
    ok = bool(torch.isfinite(out.float()).all()) and torch.allclose(
        out.float(), ref.float(), **tol)
    return err, ok


def planted_fault(run, zeroed, end: int, rows, ref, tol) -> dict:
    """The check must reject a wrong tile: ``run(zeroed(lo, end))``, V with
    key positions lo .. end - 1 zeroed, the last 64-key tile below ``end``
    (as if the kernel skipped that tile's P.V), must come out not ok on
    ``rows`` against ``ref``."""
    err, ok = compare(run(zeroed((end - 1) // 64 * 64, end))[rows], ref, tol)
    return {"fault": f"V zeroed over key positions {(end - 1) // 64 * 64}..{end - 1}",
            "max_abs_err": err, "caught": not ok}


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def flash_case(dtype: str, B: int, T: int, Hq: int, Hkv: int, D: int, lens,
               window=None, softcap=None, timed=True, plant=False) -> dict:
    """``plant``: also hold a planted fault in the longest prompt's last K/V
    tile."""
    import torch
    import torch.nn.functional as F
    from tpuserve_torch.ops import attention, flash_prefill
    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(B, T, Hq, D, generator=g, device="cuda").to(tdt)
    k = torch.randn(B, T, Hkv, D, generator=g, device="cuda").to(tdt)
    v = torch.randn(B, T, Hkv, D, generator=g, device="cuda").to(tdt)
    plens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    # padding keys past each prompt hold NaN, as a fresh buffer may
    for b, n in enumerate(lens):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    scale = D ** -0.5
    kw = dict(sliding_window=window, logit_softcap=softcap)
    out = flash_prefill.flash_prefill_attention(q, k, v, plens, scale, **kw)
    ref = attention.prefill_attention(q, k, v, plens, scale, **kw)
    torch.cuda.synchronize()
    tol = tolerance(torch.cat([ref[b, :n].flatten() for b, n in enumerate(lens)]), dtype)
    errs, oks = [], []
    for b, n in enumerate(lens):                      # valid rows only
        e, ok = compare(out[b, :n], ref[b, :n], tol)
        errs.append(e)
        oks.append(ok)
    pairs = sum(n * (n + 1) // 2 if window is None else
                sum(min(i + 1, window) for i in range(n)) for n in lens)
    res = {"case": f"flash_prefill {dtype} B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} "
                   f"lens={list(lens)} window={window} softcap={softcap}",
           "max_abs_err": max(errs), "tol": tol, "ok": all(oks)}
    if plant:
        b = int(np.argmax(lens))

        def zeroed(lo, hi):
            bad = v.clone()
            bad[b, lo:hi] = 0.0
            return bad
        res["planted"] = planted_fault(
            lambda bad: flash_prefill.flash_prefill_attention(q, k, bad, plens, scale, **kw)[b],
            zeroed, lens[b], slice(0, lens[b]), ref[b, :lens[b]], tol)
        res["ok"] = res["ok"] and res["planted"]["caught"]
    if timed:
        res["ms"] = cuda_ms(lambda: flash_prefill.flash_prefill_attention(
            q, k, v, plens, scale, **kw))
        res["plain_ms"] = cuda_ms(lambda: attention.prefill_attention(
            q, k, v, plens, scale, **kw), iters=3, warmup=1)
        # the bytes this data needs: each prompt's q, k, v and out rows once
        rows = sum(lens) * (2 * Hq + 2 * Hkv) * D * q.element_size()
        res["flops"] = 2 * 2 * Hq * D * pairs
        res["bound_ms"], res["bound_by"] = bound(res["flops"], rows + nbytes(plens), dtype)
        # yardstick only: one dense causal SDPA call over the padded batch
        qd, kd, vd = (x.transpose(1, 2) for x in (q, k.nan_to_num(), v.nan_to_num()))
        kd = kd.repeat_interleave(Hq // Hkv, dim=1)
        vd = vd.repeat_interleave(Hq // Hkv, dim=1)
        res["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, is_causal=True, scale=scale))
    return res


def paged_case(dtype: str, B: int, Hq: int, Hkv: int, D: int, page: int,
               max_pages: int, lens, int8=False, window=None, softcap=None,
               timed=True) -> dict:
    import torch
    import torch.nn.functional as F
    from tpuserve_torch.ops import attention, paged_decode
    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    nb = B * max_pages + 7
    q = torch.randn(B, Hq, D, generator=g, device="cuda").to(tdt)
    kf = torch.randn(nb, page, Hkv, D, generator=g, device="cuda")
    vf = torch.randn(nb, page, Hkv, D, generator=g, device="cuda")
    perm = torch.randperm(nb, generator=g, device="cuda")[:B * max_pages]
    bt = perm.reshape(B, max_pages).to(torch.int32).contiguous()
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    ks = vs = None
    if int8:
        kc, ks = attention.quantize_kv(kf)
        vc, vs = attention.quantize_kv(vf)
    else:
        kc, vc = kf.to(tdt), vf.to(tdt)
        # slots past each sequence's end hold NaN, as a fresh cache may
        for b, n in enumerate(lens):
            for t in range(n, min(max_pages * page, n + 2 * page)):
                blk, off = int(bt[b, t // page]), t % page
                kc[blk, off] = float("nan")
                vc[blk, off] = float("nan")
    scale = D ** -0.5
    kw = dict(k_scale=ks, v_scale=vs, sliding_window=window, logit_softcap=softcap)
    out = paged_decode.paged_decode_attention(q, kc, vc, bt, sl, scale, **kw)
    ref = attention.paged_decode_attention(q, kc, vc, bt, sl, scale, **kw)
    torch.cuda.synchronize()
    tol = tolerance(ref, dtype)
    err, ok = compare(out, ref, tol)
    kv_name = "int8" if int8 else dtype
    res = {"case": f"paged_decode q={dtype} kv={kv_name} B={B} Hq={Hq} Hkv={Hkv} D={D} "
                   f"page={page} max_pages={max_pages} max_len={max(lens)} "
                   f"window={window} softcap={softcap}",
           "max_abs_err": err, "tol": tol, "ok": ok}
    if timed:
        st = {}
        res["ms"] = cuda_ms(lambda: paged_decode.paged_decode_attention(
            q, kc, vc, bt, sl, scale, **kw), iters=50, warmup=5, cold=True, stats=st)
        res["ms_mean"] = st["mean"]
        res["plain_ms"] = cuda_ms(lambda: attention.paged_decode_attention(
            q, kc, vc, bt, sl, scale, **kw), iters=5, warmup=1, cold=True)
        attended = sum(n if window is None else min(n, window) for n in lens)
        row = Hkv * D * kc.element_size() + (Hkv * 4 if int8 else 0)
        res["flops"] = 2 * 2 * Hq * D * attended
        res["bound_ms"], res["bound_by"] = bound(
            res["flops"], 2 * attended * row + nbytes(q, out, bt, sl), dtype)
        # yardstick only: one SDPA call over K/V gathered to a dense
        # (B, Hq, S, D) tensor beforehand (not timed), with a boolean mask of
        # each row's valid keys
        S = max(lens)
        kd, vd = attention._gather_pages(kc, vc, bt, ks, vs, tdt)
        kd, vd = (x[:, :S].nan_to_num().repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
                  .contiguous() for x in (kd, vd))
        j = torch.arange(S, device="cuda")[None, :]
        mask = j < sl.long()[:, None]
        if window is not None:
            mask &= j >= sl.long()[:, None] - window
        qd = q[:, :, None, :]
        res["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask[:, None, None], scale=scale), iters=50, warmup=5,
            cold=True)
    return res


def window_case(dtype: str, B: int, C: int, Hq: int, Hkv: int, D: int, page: int,
                ctx, n, int8=False, window=None, softcap=None, timed=True,
                plant=False) -> dict:
    """``plant``: also hold a planted fault in sequence 0's last K/V tile."""
    import torch
    import torch.nn.functional as F
    from tpuserve_torch.ops import attention, paged_window
    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    max_pages = -(-max(c + k for c, k in zip(ctx, n)) // page) + 1
    nb = B * max_pages + 7
    q = torch.randn(B, C, Hq, D, generator=g, device="cuda").to(tdt)
    kc, vc, ks, vs = paged_cache(g, nb, page, Hkv, D, dtype, int8)
    perm = torch.randperm(nb, generator=g, device="cuda")[:B * max_pages]
    bt = perm.reshape(B, max_pages).to(torch.int32).contiguous()
    for b in range(B):                       # unwritten slots past each chunk
        poison(kc, vc, bt[b], range(ctx[b] + n[b], max_pages * page), page)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    n_t = torch.tensor(n, dtype=torch.int32, device="cuda")
    scale = D ** -0.5
    args = (q, kc, vc, bt, ctx_t, n_t, scale)
    kw = dict(k_scale=ks, v_scale=vs, sliding_window=window, logit_softcap=softcap)
    out = paged_window.paged_window_attention(*args, **kw)
    ref = attention.chunked_prefill_attention(*args, **kw)
    torch.cuda.synchronize()
    tol = tolerance(torch.cat([ref[b, :n[b]].flatten() for b in range(B)]), dtype)
    errs, oks = [], []
    for b in range(B):                       # valid rows; the rest must be 0
        e, ok = compare(out[b, :n[b]], ref[b, :n[b]], tol)
        errs.append(e)
        oks.append(ok and int(torch.count_nonzero(out[b, n[b]:])) == 0)
    kv_name = "int8" if int8 else dtype
    res = {"case": f"paged_window q={dtype} kv={kv_name} B={B} C={C} Hq={Hq} Hkv={Hkv} "
                   f"D={D} page={page} ctx={list(ctx)} chunk={list(n)} window={window} "
                   f"softcap={softcap}",
           "max_abs_err": max(errs), "tol": tol, "ok": all(oks)}
    if plant:
        res["planted"] = planted_fault(
            lambda bad: paged_window.paged_window_attention(q, kc, bad, *args[3:], **kw)[0],
            zeroed_slots(vc, bt[0], page), ctx[0] + n[0], slice(0, n[0]), ref[0, :n[0]], tol)
        res["ok"] = res["ok"] and res["planted"]["caught"]
    if timed:                      # L2 flushed before each call, as a step finds it
        st = {}
        res["ms"] = cuda_ms(lambda: paged_window.paged_window_attention(*args, **kw),
                            cold=True, stats=st)
        res["ms_mean"] = st["mean"]
        res["plain_ms"] = cuda_ms(lambda: attention.chunked_prefill_attention(*args, **kw),
                                  iters=3, warmup=1, cold=True)
        pairs = keys = 0
        for c, k in zip(ctx, n):
            p_, k_ = attended(c, k, window)
            pairs, keys = pairs + p_, keys + k_
        row = Hkv * D * kc.element_size() + (Hkv * 4 if int8 else 0)
        io = 2 * sum(n) * Hq * D * q.element_size()
        res["flops"] = 4 * Hq * D * pairs
        res["bound_ms"], res["bound_by"] = bound(
            res["flops"], io + 2 * keys * row + nbytes(bt, ctx_t, n_t), dtype)
        # yardstick only: one SDPA call over K/V gathered to a dense tensor
        # beforehand (not timed), with the offset-causal boolean mask
        S = max(c + k for c, k in zip(ctx, n))
        kd, vd = attention._gather_pages(kc, vc, bt, ks, vs, tdt)
        kd, vd = (x[:, :S].nan_to_num().repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
                  .contiguous() for x in (kd, vd))
        i = torch.arange(C, device="cuda")[None, :, None]
        j = torch.arange(S, device="cuda")[None, None, :]
        mask = (j <= ctx_t[:, None, None] + i) & (j < (ctx_t + n_t)[:, None, None])
        if window is not None:
            mask &= j > ctx_t[:, None, None] + i - window
        qd = q.transpose(1, 2)
        res["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask[:, None], scale=scale), cold=True)
    return res


def ragged_case(dtype: str, dec_lens, chunks, blk: int, Hq=16, Hkv=8, D=128, page=32,
                int8=False, window=None, softcap=None, timed=True, plant=False,
                max_pages=None) -> dict:
    """A mixed stream packed as the engine packs it: decode rows with cache
    lengths ``dec_lens``, then prefill chunks ((q_len, kv_len) each).
    ``plant``: also hold a planted fault in the first chunk's last K/V tile.
    ``max_pages``: the block tables' width (default: the longest sequence's
    pages and one more)."""
    import torch
    from tpuserve_torch.ops import attention, ragged_paged
    from tpuserve_torch.ops.ragged_paged import ragged_layout
    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    n_dec = len(dec_lens)
    kv = list(dec_lens) + [kl for _, kl in chunks]
    B = len(kv)
    max_pages = max_pages or -(-max(kv) // page) + 1
    nb = B * max_pages + 7
    kc, vc, ks, vs = paged_cache(g, nb, page, Hkv, D, dtype, int8)
    perm = torch.randperm(nb, generator=g, device="cuda")[:B * max_pages]
    bt = perm.reshape(B, max_pages).to(torch.int32).contiguous()
    starts, T, meta, blk_seq = ragged_layout(n_dec, [ql for ql, _ in chunks], blk)
    q_starts = list(range(n_dec)) + starts
    q_lens = [1] * n_dec + [ql for ql, _ in chunks]
    valid = torch.zeros(T, dtype=torch.bool, device="cuda")
    for s in range(B):
        valid[q_starts[s]:q_starts[s] + q_lens[s]] = True
        poison(kc, vc, bt[s], range(kv[s], max_pages * page), page)
    q = torch.randn(T, Hq, D, generator=g, device="cuda").to(tdt)
    desc = [torch.tensor(x, dtype=torch.int32, device="cuda")
            for x in (kv, q_starts, q_lens, meta, blk_seq)]
    scale = D ** -0.5
    args = (q, kc, vc, bt, *desc, scale, blk)
    kw = dict(k_scale=ks, v_scale=vs, sliding_window=window, logit_softcap=softcap)
    out = ragged_paged.ragged_paged_attention(*args, **kw)
    ref = attention.ragged_paged_attention(*args, **kw)
    torch.cuda.synchronize()
    tol = tolerance(ref[valid], dtype)
    err, ok = compare(out[valid], ref[valid], tol)
    ok = ok and int(torch.count_nonzero(out[~valid])) == 0
    kv_name = "int8" if int8 else dtype
    res = {"case": f"ragged_paged q={dtype} kv={kv_name} T={T} blk={blk} Hq={Hq} Hkv={Hkv} "
                   f"D={D} page={page} max_pages={max_pages} decode_rows={n_dec} max_decode_len="
                   f"{max(dec_lens, default=0)} chunks(q_len,kv_len)={list(chunks)} "
                   f"window={window} softcap={softcap}",
           "max_abs_err": err, "tol": tol, "ok": ok}
    if plant:
        s, rows = n_dec, slice(q_starts[n_dec], q_starts[n_dec] + q_lens[n_dec])
        res["planted"] = planted_fault(
            lambda bad: ragged_paged.ragged_paged_attention(q, kc, bad, *args[3:], **kw),
            zeroed_slots(vc, bt[s], page), kv[s], rows, ref[rows], tol)
        res["ok"] = res["ok"] and res["planted"]["caught"]
    if timed:                      # L2 flushed before each call, as a step finds it
        st = {}
        res["ms"] = cuda_ms(lambda: ragged_paged.ragged_paged_attention(*args, **kw),
                            iters=50, warmup=5, cold=True, stats=st)
        res["ms_mean"] = st["mean"]
        res["plain_ms"] = cuda_ms(lambda: attention.ragged_paged_attention(*args, **kw),
                                  iters=3, warmup=1, cold=True)
        pairs = keys = 0
        for s in range(B):
            p_, k_ = attended(kv[s] - q_lens[s], q_lens[s], window)
            pairs, keys = pairs + p_, keys + k_
        row = Hkv * D * kc.element_size() + (Hkv * 4 if int8 else 0)
        io = 2 * sum(q_lens) * Hq * D * q.element_size()
        res["flops"] = 4 * Hq * D * pairs
        res["bound_ms"], res["bound_by"] = bound(
            res["flops"], io + 2 * keys * row + nbytes(bt, *desc), dtype)
        # yardstick only: one SDPA call over the K/V of every sequence in
        # the stream, gathered into one flat key range beforehand (not
        # timed), with a boolean (T x keys) mask: each row sees its own
        # sequence's keys up to its position (padding rows: key 0 alone)
        import torch.nn.functional as F
        kd, vd = attention._gather_pages(kc, vc, bt, ks, vs, tdt)
        kd, vd = (torch.cat([x[s_, :kv[s_]] for s_ in range(B)]).nan_to_num()
                  .repeat_interleave(Hq // Hkv, dim=1).transpose(0, 1)[None].contiguous()
                  for x in (kd, vd))
        key_seq = torch.cat([torch.full((kv[s_],), s_) for s_ in range(B)]).cuda()
        key_pos = torch.cat([torch.arange(kv[s_]) for s_ in range(B)]).cuda()
        row_seq = torch.full((T,), -1, dtype=torch.long)
        row_pos = torch.zeros(T, dtype=torch.long)
        for s_ in range(B):
            rows = slice(q_starts[s_], q_starts[s_] + q_lens[s_])
            row_seq[rows] = s_
            row_pos[rows] = kv[s_] - q_lens[s_] + torch.arange(q_lens[s_])
        row_seq, row_pos = row_seq.cuda(), row_pos.cuda()
        mask = (row_seq[:, None] == key_seq[None]) & (key_pos[None] <= row_pos[:, None])
        if window is not None:
            mask &= key_pos[None] > row_pos[:, None] - window
        mask[row_seq < 0, 0] = True
        qd = q.transpose(0, 1)[None]
        res["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask[None, None], scale=scale), iters=50, warmup=5,
            cold=True)
    return res


def phase_build(_build) -> dict:
    """Build the four libraries, then read what was compiled: the wgmma
    (HGMMA) instructions in each library's SASS, which the bf16 tile must
    contain, registers and stack (spills) of the tile's and the split-K
    decode kernels, and the decode kernels' dynamic shared memory a block
    at the main path's shapes (bf16 and int8 K/V, D=128; the decode
    headline's pages a partition, the engine's 64 pages a row for ragged)."""
    import re
    import shutil
    import tempfile
    import torch
    from tpuserve_torch.ops.paged_decode import decode_splits, num_sms
    build_s = _build.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    hgmma, usage = {}, {}
    # every library's two dumps at once, each into a file of its own
    dumps = {}
    for name in KERNELS:
        for flag in ("-sass", "-res-usage"):
            out = tempfile.TemporaryFile(mode="w+")
            dumps[name, flag] = (subprocess.Popen(
                [tool, flag, str(_build._lib_path(name))], stdout=out), out)

    def dump(name: str, flag: str) -> str:
        proc, out = dumps[name, flag]
        proc.wait()
        out.seek(0)
        with out:
            return out.read()
    for name in KERNELS:
        hgmma[name] = dump(name, "-sass").count("HGMMA")
        res = dump(name, "-res-usage")
        for fn, reg, stack, shared in re.findall(
                r"Function (\S+):\s*REG:(\d+) STACK:(\d+)(?: SHARED:(\d+))?", res):
            if "bf16" in fn or "ragged" in fn or "decode" in fn:
                usage[demangle(fn)] = {"regs": int(reg), "stack": int(stack),
                                       "static_shared": int(shared or 0)}
    _, pages = decode_splits(64, 32, 8, 8, num_sms(torch.device("cuda", 0)))
    dec, rag = _build.load("paged_decode"), _build.load("ragged_paged")
    smem = {f"paged_decode kv={kv} D=128, {pages} pages a partition":
            dec.paged_decode_smem_bytes(code, 128, pages)
            for kv, code in (("bf16", 1), ("int8", 2))}
    smem.update({f"ragged_paged q=bf16 kv={kv} D=128, 64 pages a row":
                 rag.ragged_paged_smem_bytes(1, code, 128, 64)
                 for kv, code in (("bf16", 1), ("int8", 2))})
    ok = all(hgmma[n] > 0 for n in ("flash_prefill", "paged_window", "ragged_paged"))
    return {"ok": ok, "build_s": build_s, "hgmma": hgmma, "tile_kernels": usage,
            "decode_dynamic_smem_bytes": smem}


def demangle(name: str) -> str:
    import shutil
    tool = shutil.which("c++filt")
    if tool is None:
        return name
    out = subprocess.run([tool, name], capture_output=True, text=True).stdout.strip()
    return out.replace("(anonymous namespace)::", "").replace("__nv_bfloat16", "bf16")


def phase_kernels() -> dict:
    import torch
    from tpuserve_torch.ops.paged_decode import decode_splits, num_sms
    rng = np.random.default_rng(SEED)
    # keys a split-K partition holds at the decode headline's shape
    part = 32 * decode_splits(64, 32, 8, 8, num_sms(torch.device("cuda", 0)))[1]
    lens_p = [1024, 777, 512, 129]
    lens_d = sorted(rng.integers(1, 2049, 7).tolist()) + [2048]
    # the mixed phase's decode rows: 256-token prompts some way into decode
    dec = rng.integers(257, 400, 8).tolist()
    # decode rows past Gemma-2-2B's 4,096 window, up to the families
    # phase's 6,000-token context
    lens_g2 = sorted(rng.integers(4097, 6001, 7).tolist()) + [6000]
    # the first case of each kernel is its headline in the report
    cases = {
        "flash_prefill": [
            flash_case("bfloat16", 8, 1024, 16, 8, 128, MAIN_LENGTHS, plant=True),
            flash_case("bfloat16", 4, 1024, 16, 8, 128, lens_p),
            flash_case("float32", 4, 1024, 16, 8, 128, lens_p),
            flash_case("float32", 2, 256, 8, 4, 64, [256, 200], window=64,
                       softcap=30.0, timed=False),
            flash_case("bfloat16", 2, 96, 4, 1, 256, [96, 50], timed=False),
            flash_case("bfloat16", 2, 200, 8, 2, 64, [200, 150], window=70,
                       softcap=30.0, timed=False),
            # the spec phase's draft pass: 8 windows of 1-64 tokens + 4
            flash_case("bfloat16", 8, 68, 16, 8, 128, [64, 64, 40, 64, 17, 64, 33, 1]),
            # Phi-3-mini's prefill: head_dim 96, padded to 128 in the tile
            flash_case("bfloat16", 8, 1024, 32, 32, 96, MAIN_LENGTHS, plant=True),
            flash_case("float32", 2, 300, 32, 32, 96, [300, 129], window=100, timed=False),
        ],
        "paged_decode": [
            paged_case("bfloat16", 8, 16, 8, 128, 32, 64, lens_d),
            # the main path's decode shape: its prompts 32 tokens into decode
            paged_case("bfloat16", 8, 16, 8, 128, 32, 64, [n + 32 for n in MAIN_LENGTHS]),
            # one sequence that has to fill the card alone
            paged_case("bfloat16", 1, 16, 8, 128, 32, 64, [2048]),
            # lengths at a partition's edges
            paged_case("bfloat16", 8, 16, 8, 128, 32, 64,
                       [part - 1, part, part + 1, 2 * part - 1, 2 * part, 2 * part + 1,
                        2047, 2048]),
            paged_case("float32", 8, 16, 8, 128, 32, 64, lens_d),
            paged_case("bfloat16", 8, 16, 8, 128, 32, 64, lens_d, int8=True),
            paged_case("float32", 4, 8, 2, 64, 16, 16, [256, 200, 17, 0],
                       window=100, softcap=30.0, timed=False),
            paged_case("float32", 3, 8, 1, 256, 16, 8, [128, 77, 1],
                       timed=False),
            # Qwen3-30B-A3B's decode (group 8), Gemma-2-2B's past its window
            paged_case("bfloat16", 8, 32, 4, 128, 32, 64, lens_d),
            paged_case("bfloat16", 8, 8, 4, 256, 32, 190, lens_g2, window=4096,
                       softcap=50.0),
            # Phi-3-mini: head_dim 96
            paged_case("bfloat16", 8, 32, 32, 96, 32, 64, lens_d, timed=False),
            paged_case("bfloat16", 4, 8, 2, 96, 16, 16, [256, 200, 17, 0], int8=True,
                       window=100, timed=False),
            paged_case("float32", 4, 32, 32, 96, 16, 16, [256, 200, 17, 0], timed=False),
        ],
        "paged_window": [
            # the 6,000-token prompt's last chunk: 1,904 rows over 4,096 cached
            window_case("bfloat16", 1, 2048, 16, 8, 128, 32, [4096], [1904], plant=True),
            window_case("bfloat16", 1, 512, 16, 8, 128, 32, [4096], [300]),
            window_case("bfloat16", 1, 2048, 16, 8, 128, 32, [0], [2048]),
            window_case("float32", 1, 2048, 16, 8, 128, 32, [4096], [1904]),
            window_case("bfloat16", 1, 2048, 16, 8, 128, 32, [4096], [1904], int8=True),
            window_case("bfloat16", 2, 256, 8, 2, 64, 16, [300, 0], [256, 100], window=128,
                        softcap=30.0, timed=False),
            window_case("float32", 2, 256, 8, 2, 64, 16, [300, 0], [256, 100], window=128,
                        softcap=30.0, timed=False),
            window_case("bfloat16", 3, 64, 16, 8, 128, 32, [33, 0, 500], [64, 7, 40],
                        timed=False),
            window_case("float32", 3, 32, 16, 8, 128, 32, [33, 0, 500], [32, 7, 1],
                        timed=False),
            # the speculative verify window: 8 sequences of 5 rows over 1,024
            window_case("bfloat16", 8, 5, 16, 8, 128, 32, [1024] * 8, [5] * 8),
            # head_dim 96 (Phi-3-mini's chunks; int8 copies split unevenly)
            window_case("bfloat16", 2, 256, 32, 32, 96, 32, [300, 0], [256, 100],
                        timed=False),
            window_case("bfloat16", 2, 256, 8, 2, 96, 32, [300, 0], [256, 100], int8=True,
                        window=128, timed=False),
            window_case("float32", 2, 64, 32, 32, 96, 32, [300, 0], [64, 33], timed=False),
        ],
        "ragged_paged": [
            # the mixed phase's stream: 8 decode rows and a 480-row chunk
            ragged_case("bfloat16", dec, [(480, 960)], 32, plant=True),
            # the headline's two halves alone: its 8 decode rows (at the
            # headline's table width), then its 480-row chunk
            ragged_case("bfloat16", dec, [], 32, max_pages=-(-960 // 32) + 1),
            ragged_case("bfloat16", [], [(480, 960)], 32),
            ragged_case("bfloat16", dec, [(448, 896)], 64),
            ragged_case("float32", dec, [(480, 960)], 32),
            ragged_case("bfloat16", dec, [(480, 960)], 32, int8=True),
            ragged_case("bfloat16", dec[:4], [(200, 500)], 16, Hq=8, Hkv=2, D=64, page=16,
                        window=128, softcap=30.0, timed=False),
            ragged_case("float32", dec[:4], [(200, 500)], 16, Hq=8, Hkv=2, D=64, page=16,
                        window=128, softcap=30.0, timed=False),
            ragged_case("bfloat16", dec, [], 32, timed=False),
            ragged_case("bfloat16", [], [(300, 300), (150, 1000)], 32, timed=False),
            ragged_case("bfloat16", dec[:3], [(70, 90), (9, 9)], 8, timed=False),
            ragged_case("bfloat16", dec[:4], [(200, 260)], 128, timed=False),
            ragged_case("bfloat16", dec[:4], [(200, 500)], 32, Hq=32, Hkv=32, D=96,
                        timed=False),
            ragged_case("float32", dec[:4], [(100, 300)], 32, Hq=32, Hkv=32, D=96,
                        timed=False),
        ],
    }
    for name, rs in cases.items():
        for r in rs:
            emit({"phase": "kernels", "kernel": name, **r})
    ok = all(r["ok"] for rs in cases.values() for r in rs)
    return {"ok": ok, "headline": {n: rs[0] for n, rs in cases.items()}}


# --------------------------------------------------------------------------
# phases 3 and 4: the engine
# --------------------------------------------------------------------------

def prompts(rng, lengths, vocab):
    return [rng.integers(0, vocab, n).tolist() for n in lengths]


def phase_identity() -> dict:
    import torch
    from tpuserve_torch.models.config import get_model_config
    from tpuserve_torch.models.weights import init_params
    from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig,
                                        SamplingParams)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_model_config("Qwen/Qwen3-0.6B"), num_layers=2,
                              dtype="float32")
    params = init_params(cfg, SEED, "cuda")
    ps = prompts(np.random.default_rng(SEED + 2), [37, 64, 100, 150], cfg.vocab_size)
    sp = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True)
    streams = {}
    # synchronous decode on the kernels and on the plain attention, then
    # the default engine: captured graphs, pipelined windows
    for name, impl, pipelined in (("cuda", "cuda", False), ("reference", "reference", False),
                                  ("cuda_pipelined", "cuda", None)):
        eng = Engine(EngineConfig(attn_impl=impl, multi_step=8, pipeline_decode=pipelined,
                                  cache=CacheConfig(num_blocks=256, dtype="float32")),
                     params=params, model_cfg=cfg, device="cuda")
        streams[name] = [r.output_token_ids for r in eng.generate(ps, sp)]
        del eng
    same = streams["cuda"] == streams["reference"] == streams["cuda_pipelined"]
    ok = same and all(len(s) == 32 for s in streams["cuda"])
    chunked = identity_chunked(cfg, params)
    mixed = identity_mixed(cfg, params)
    return {"ok": ok and chunked["ok"] and mixed["ok"], "prompts": len(ps),
            "tokens_each": 32, "identical": same, "chunked": chunked, "mixed": mixed}


def identity_run(engine, early, late, start_late) -> tuple[list, dict]:
    """Serve ``early`` ((prompt, params) each), step until ``start_late``
    holds, add ``late``, drain; each request's tokens in order, and stats."""
    rids = [engine.add_request(prompt_token_ids=p, params=sp) for p, sp in early]
    while not start_late(engine, rids):
        engine.step()
    rids += [engine.add_request(prompt_token_ids=p, params=sp) for p, sp in late]
    while engine.has_work():
        engine.step()
    st = engine.stats
    return ([engine.requests[r].output_token_ids for r in rids],
            {"chunk_steps": st.num_chunk_steps, "mixed_steps": st.num_mixed_steps,
             "prefix_hits": engine.block_manager.prefix_hits})


def identity_chunked(cfg, params) -> dict:
    """Prompts of 37, 2,500 and 5,000 tokens, then (once the 5,000-token
    prompt has its first token) a prompt sharing its first 4,096 tokens:
    the chunked engine on the kernels, on the plain attention, and an
    engine with chunking off give the same greedy tokens."""
    import torch
    from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig,
                                        SamplingParams, SchedulerConfig)
    rng = np.random.default_rng(SEED + 4)
    ps = prompts(rng, [37, 2500, 5000], cfg.vocab_size)
    hit = ps[2][:4096] + prompts(rng, [300], cfg.vocab_size)[0]
    sp = SamplingParams(max_tokens=16, temperature=0.0, ignore_eos=True)
    cache = CacheConfig(max_blocks_per_seq=256, num_blocks=1024, dtype="float32")
    runs, stats = {}, {}
    for name, impl, chunking in (("chunked_cuda", "cuda", True),
                                 ("chunked_reference", "reference", True),
                                 ("unchunked_cuda", "cuda", False)):
        eng = Engine(EngineConfig(attn_impl=impl, multi_step=8, cache=cache,
                                  pipeline_decode=False,
                                  scheduler=SchedulerConfig(allow_chunked_prefill=chunking)),
                     params=params, model_cfg=cfg, device="cuda")
        runs[name], stats[name] = identity_run(
            eng, [(p, sp) for p in ps], [(hit, sp)],
            lambda e, rids: bool(e.requests[rids[2]].output_token_ids))
        del eng
        torch.cuda.empty_cache()
    same = runs["chunked_cuda"] == runs["chunked_reference"] == runs["unchunked_cuda"]
    ok = (same and all(len(t) == 16 for t in runs["chunked_cuda"])
          and stats["chunked_cuda"]["chunk_steps"] >= 5
          and stats["unchunked_cuda"]["chunk_steps"] == 0)
    return {"ok": ok, "prompt_lens": [len(p) for p in ps] + [len(hit)],
            "identical": same, "stats": stats}


def identity_mixed(cfg, params) -> dict:
    """8 streams decoding while 8 prompts of 200-1,500 tokens arrive: the
    mixed engine on the kernels, on the plain attention, and the
    phase-split engine give the same greedy tokens."""
    import torch
    from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig,
                                        SamplingParams, SchedulerConfig)
    rng = np.random.default_rng(SEED + 5)
    early = [(p, SamplingParams(max_tokens=48, temperature=0.0, ignore_eos=True))
             for p in prompts(rng, [64] * 8, cfg.vocab_size)]
    late = [(p, SamplingParams(max_tokens=16, temperature=0.0, ignore_eos=True))
            for p in prompts(rng, rng.integers(200, 1501, 8).tolist(), cfg.vocab_size)]
    runs, stats = {}, {}
    for name, impl, mixed in (("mixed_cuda", "cuda", True),
                              ("mixed_reference", "reference", True),
                              ("phase_split_cuda", "cuda", False)):
        eng = Engine(EngineConfig(attn_impl=impl, multi_step=8, pipeline_decode=False,
                                  cache=CacheConfig(num_blocks=1024, dtype="float32"),
                                  scheduler=SchedulerConfig(mixed_batching=mixed)),
                     params=params, model_cfg=cfg, device="cuda")
        runs[name], stats[name] = identity_run(
            eng, early, late, lambda e, rids: e.stats.num_decode_windows >= 1)
        del eng
        torch.cuda.empty_cache()
    same = runs["mixed_cuda"] == runs["mixed_reference"] == runs["phase_split_cuda"]
    ok = (same and stats["mixed_cuda"]["mixed_steps"] >= 3
          and stats["phase_split_cuda"]["mixed_steps"] == 0)
    return {"ok": ok, "identical": same, "stats": stats}


def serve_main(eng, ps, greedy, sampled):
    """The main path on ``eng``: the prompts ``ps`` (``greedy``), then one
    ``sampled`` request repeating the first.  Returns the greedy requests,
    the sampled one and timings: prefill and decode seconds (host clock
    around each step; a step ends in the host read of the decode dispatch
    it flushes, so their sum holds the card's work), decode tokens, TTFT,
    and each step's kind and ms."""
    rids = [eng.add_request(prompt_token_ids=p, params=greedy) for p in ps]
    t_prefill = t_decode = 0.0
    decode_tokens = 0
    log = []
    while eng.has_work():
        n_prefill = eng.stats.num_prefill_steps
        t = time.perf_counter()
        outs = eng.step()
        dt = time.perf_counter() - t
        if eng.stats.num_prefill_steps > n_prefill:
            t_prefill += dt
            log.append(["prefill", round(dt * 1e3, 2)])
        else:
            t_decode += dt
            decode_tokens += sum(len(o.new_token_ids) for o in outs)
            log.append(["decode", round(dt * 1e3, 2)])
    reqs = [eng.requests.pop(r) for r in rids]
    timing = {"prefill_s": t_prefill, "decode_s": t_decode, "decode_tokens": decode_tokens,
              "decode_tok_per_s": decode_tokens / t_decode if t_decode else None,
              "mean_ttft_ms": 1e3 * eng.stats.ttft_sum / eng.stats.ttft_count,
              "step_ms": log}
    return reqs, eng.generate([ps[0]], sampled)[0], timing


def phase_main() -> dict:
    import torch
    from tpuserve_torch.models import transformer
    from tpuserve_torch.ops.attention import PAD_SLOT
    from tpuserve_torch.runtime import Engine, EngineConfig, SamplingParams
    from tpuserve_torch.runtime.graphs import pool_bytes_bound
    from tpuserve_torch.runtime.kv_cache import create_kv_cache

    t0 = time.perf_counter()
    eng = Engine(EngineConfig(seed=SEED))            # Qwen/Qwen3-0.6B, cuda
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = eng.model_cfg
    # the executables, captured before serving as the server's startup
    # warms them (``Engine.warmup``'s defaults: the decode ladder in both
    # modes, the smallest prefill bucket), then every other executable
    # the engine can make (each (batch, length) prefill bucket and chunk
    # length), as a bench warms the buckets its run will hit: the graph
    # pool then holds all of them, against the bound the cache sizing uses
    t0 = time.perf_counter()
    eng.warmup()
    warmup_s = time.perf_counter() - t0
    default_keys = sorted(eng.graphs.executables)
    keys = eng._step_keys(eng.scheduler.cfg, eng.max_seq_len)
    t0 = time.perf_counter()
    eng.graphs.warmup(keys)
    torch.cuda.synchronize()
    capture = {"default_warmup_s": warmup_s, "default_executables": default_keys,
               "full_warmup_s": time.perf_counter() - t0,
               "capture_s": eng.graphs.capture_s,
               "executables": len(eng.graphs.executables),
               "executables_by_kind": {k: sum(1 for e in eng.graphs.executables if e[0] == k)
                                       for k in ("prefill", "chunk", "mixed", "decode")},
               "pool_bytes": eng.graphs.pool_bytes(),
               "pool_bytes_bound": pool_bytes_bound(cfg, keys, eng._ragged_seqs),
               "replay_launches": {"/".join(map(str, k)): exe.launches
                                   for k, exe in eng.graphs.executables.items()
                                   if k in (("prefill", 8, 1024), ("decode", 8, "greedy"))}}
    lengths = MAIN_LENGTHS
    ps = prompts(np.random.default_rng(SEED + 3), lengths, cfg.vocab_size)
    greedy = SamplingParams(max_tokens=64, temperature=0.0, ignore_eos=True)
    sampled = SamplingParams(max_tokens=64, temperature=0.8, seed=1, ignore_eos=True)

    reset_launches()
    replays0 = dict(eng.graphs.replays)
    reqs, sampled_req, timing = serve_main(eng, ps, greedy, sampled)
    launches = read_launches()
    L = cfg.num_layers
    # the sampled request repeats a prompt: a prefix-cache hit, served by
    # the chunk route from its cached offset, as the JAX engine does
    steps = {"prefill_steps": eng.stats.num_prefill_steps - eng.stats.num_chunk_steps,
             "chunk_steps": eng.stats.num_chunk_steps,
             "decode_steps": eng.stats.num_decode_steps,
             "decode_windows": eng.stats.num_decode_windows,
             "graph_replays": {k: eng.graphs.replays[k] - replays0.get(k, 0)
                               for k in ("prefill", "chunk", "mixed", "decode")}}
    want = {"flash_prefill": L * steps["prefill_steps"],
            "paged_decode": L * steps["decode_steps"],
            "paged_window": L * steps["chunk_steps"], "ragged_paged": 0}
    finished = all(r.finished and len(r.output_token_ids) == 64
                   for r in reqs + [sampled_req])

    # the same requests on an engine that runs every step eagerly and
    # decodes synchronously (kept for the profile phase)
    eager = Engine(EngineConfig(seed=SEED, cuda_graphs=False, pipeline_decode=False),
                   params=eng.params)
    eager.warmup()
    ereqs, esampled, etiming = serve_main(eager, ps, greedy, sampled)
    streams = [r.output_token_ids for r in reqs]
    same_as_eager = (streams == [r.output_token_ids for r in ereqs]
                     and sampled_req.output_token_ids == esampled.output_token_ids)

    # first step against the reference path: prefill logits, both impls
    B, T = 8, 1024
    tokens = torch.zeros(B, T, dtype=torch.int32, device="cuda")
    slots = torch.full((B, T), PAD_SLOT, dtype=torch.int32, device="cuda")
    for i, p in enumerate(ps):
        tokens[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
        slots[i, :len(p)] = torch.arange(i * 1024, i * 1024 + len(p), dtype=torch.int32)
    plens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    logits = {}
    for impl in ("cuda", "reference"):
        cache = create_kv_cache(cfg, dataclasses.replace(eng.cache_cfg, num_blocks=B * 32),
                                "cuda")
        logits[impl], _ = transformer.prefill(eng.params, cfg, tokens, plens, slots,
                                              cache, attn_impl=impl)
        del cache
    diff = (logits["cuda"] - logits["reference"]).abs().max().item()
    top1 = (logits["cuda"].argmax(-1) == logits["reference"].argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(logits["cuda"]).all())
    max_logit = logits["reference"].abs().max().item()
    # bf16 argmax on random weights is path-sensitive: most rows, not all
    ok = (finished and finite and diff <= LOGIT_DIFF_MAX and top1 >= 0.75
          and launches == want and launches["flash_prefill"] > 0
          and launches["paged_decode"] > 0 and same_as_eager
          and steps["graph_replays"] == {"prefill": steps["prefill_steps"],
                                         "chunk": steps["chunk_steps"], "mixed": 0,
                                         "decode": steps["decode_steps"]}
          and capture["pool_bytes"] <= capture["pool_bytes_bound"])
    return {"ok": ok, "engine": eng, "eager_engine": eager, "params": eng.params,
            "streams": streams,
            "sampled_stream": sampled_req.output_token_ids, "model": cfg.name, "layers": L,
            "dtype": cfg.dtype, "requests": len(reqs) + 1, "finished_with_tokens": finished,
            "engine_init_s": init_s, "graphs": capture, **timing,
            "multi_step": eng._multi_step, "pipeline_decode": eng._pipeline_decode, **steps,
            "eager": {**etiming, "same_tokens": same_as_eager},
            "launches": launches, "launches_expected": want,
            "first_step_max_logit_diff": diff,
            "first_step_logit_diff_max_allowed": LOGIT_DIFF_MAX,
            "first_step_max_abs_logit": max_logit,
            "first_step_top1_agreement": top1,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_graphs(results) -> dict:
    """The decode executables at full width, bf16, on 8 sequences of the
    main path's lengths prefilled into a cache of their own: one step, a
    32-token greedy window and a seeded temperature window replayed from
    captured graphs against the same runs eager; then the main path's
    greedy streams with pipelining off against the default engine's."""
    import torch
    from tpuserve_torch.models import transformer
    from tpuserve_torch.ops.attention import PAD_SLOT
    from tpuserve_torch.runtime import Engine, EngineConfig, SamplingParams
    from tpuserve_torch.runtime.graphs import StepGraphs
    from tpuserve_torch.runtime.kv_cache import CacheConfig, create_kv_cache
    main = results["main"]
    params, cfg = main["params"], main["engine"].model_cfg
    B, pages, page, S = len(MAIN_LENGTHS), 64, 32, 32
    ps = prompts(np.random.default_rng(SEED + 10), MAIN_LENGTHS, cfg.vocab_size)
    bt = torch.arange(B * pages, dtype=torch.int32, device="cuda").reshape(B, pages)
    tokens = torch.zeros(B, 1024, dtype=torch.int32, device="cuda")
    slots = torch.full((B, 1024), PAD_SLOT, dtype=torch.int32, device="cuda")
    for i, p in enumerate(ps):
        tokens[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
        slots[i, :len(p)] = i * pages * page + torch.arange(len(p), dtype=torch.int32)
    cache0 = create_kv_cache(cfg, CacheConfig(num_blocks=B * pages, max_blocks_per_seq=pages),
                             "cuda")
    logits0, _ = transformer.prefill(params, cfg, tokens,
                                     torch.tensor(MAIN_LENGTHS, dtype=torch.int32,
                                                  device="cuda"),
                                     slots, cache0, attn_impl="cuda")
    first = logits0.argmax(-1).tolist()
    out = {}
    for mode in ("greedy", "temperature"):
        runs = {}
        for name, capture in (("graph", True), ("eager", False)):
            cache = [{k: t.clone() for k, t in e.items()} for e in cache0]
            graphs = StepGraphs(params, cfg, cache, device=torch.device("cuda"),
                                attn_impl="cuda", max_blocks=pages, steps=S, max_batch=B,
                                capture=capture)
            exe = graphs.get("decode", B, mode)
            st = exe.stage()
            for i, n in enumerate(MAIN_LENGTHS):
                st.tokens[i], st.positions[i], st.seq_lens[i] = first[i], n, n + 1
                st.active[i], st.salt[i], st.step[i] = 1, 100 + i, 1
                st.temperature[i] = 0.8 if mode == "temperature" else 0.0
            st.block_tables[:] = bt.cpu().numpy()
            exe.load(st)
            exe.run(1)
            step_logits = exe.logits.clone()
            exe.run(S - 1)
            torch.cuda.synchronize()
            runs[name] = (step_logits, exe.state.out.clone())
            del graphs, exe, cache
            torch.cuda.empty_cache()
        (lg, tg), (le, te) = runs["graph"], runs["eager"]
        bit_equal = torch.equal(lg, le)
        diff = (lg - le).abs().max().item()
        top1 = (lg.argmax(-1) == le.argmax(-1)).float().mean().item()
        out[mode] = {"step_logits_bit_equal": bit_equal, "step_max_logit_diff": diff,
                     "step_top1_agreement": top1,
                     "window_tokens_identical": torch.equal(tg, te),
                     "ok": (bit_equal or (diff <= LOGIT_DIFF_MAX and top1 >= 0.75))
                     and torch.equal(tg, te) and int(tg.min()) >= 0}
    del cache0
    torch.cuda.empty_cache()
    out["steps"] = step_graphs_bit_equal(params, cfg)
    # the main path's requests with pipelining off: the default engine's
    # tokens.  Not warmed: every executable is captured on first use,
    # inside the counted run, and the launch counts still hold its steps
    eng = Engine(EngineConfig(seed=SEED, pipeline_decode=False), params=params)
    greedy = SamplingParams(max_tokens=64, temperature=0.0, ignore_eos=True)
    sampled = SamplingParams(max_tokens=64, temperature=0.8, seed=1, ignore_eos=True)
    main_ps = prompts(np.random.default_rng(SEED + 3), MAIN_LENGTHS, cfg.vocab_size)
    reset_launches()
    reqs, sreq, timing = serve_main(eng, main_ps, greedy, sampled)
    launches = read_launches()
    st, L = eng.stats, cfg.num_layers
    first_use = {"flash_prefill": L * (st.num_prefill_steps - st.num_chunk_steps),
                 "paged_decode": L * st.num_decode_steps,
                 "paged_window": L * st.num_chunk_steps, "ragged_paged": 0}
    timing["captured_in_run"] = sorted("/".join(map(str, k)) for k in eng.graphs.executables)
    timing["capture_s"] = eng.graphs.capture_s
    del eng
    same = ([r.output_token_ids for r in reqs] == main["streams"]
            and sreq.output_token_ids == main["sampled_stream"])
    # single pipelined steps (multi_step 1) replay the same executable
    # once a step: the windows' first 16 tokens
    eng = Engine(EngineConfig(seed=SEED, multi_step=1), params=params)
    single = eng.generate(main_ps, SamplingParams(max_tokens=16, temperature=0.0,
                                                  ignore_eos=True))
    del eng
    torch.cuda.empty_cache()
    same_single = [r.output_token_ids for r in single] == [t[:16] for t in main["streams"]]
    return {"ok": (all(v["ok"] for v in out.values()) and same and same_single
                   and launches == first_use),
            "window": S, "batch": B, **out, "pipelining_off_same_tokens": same,
            "pipelining_off": timing, "pipelining_off_launches": launches,
            "pipelining_off_launches_expected": first_use,
            "single_steps_same_tokens": same_single}


# phase sampler: each sampling variant of the main path's 8 streams, as
# SamplingParams fields (64 tokens, ignore_eos; seeded ones seed 100 + row)
SAMPLER_VARIANTS = {
    "greedy": dict(temperature=0.0),
    "temperature": dict(temperature=0.8),
    "full": dict(temperature=0.8, top_p=0.9, top_k=50),
    "penalties": dict(temperature=0.0, repetition_penalty=1.2),
    "logprobs": dict(temperature=0.0, logprobs=5),
    "top_k_1": dict(temperature=0.8, top_k=1),
    # min_p 1.0 keeps every token tied at the top probability (bf16 logits
    # tie often) and samples among them: its logprobs show each token at
    # its step's maximum
    "min_p_1": dict(temperature=0.8, min_p=1.0, logprobs=1),
    "bias_floor": dict(temperature=0.0, min_tokens=16),   # + logit_bias {eos: 100}
}
SAMPLER_FLOOR = 16


def sampler_params(name: str, eos: int) -> list:
    from tpuserve_torch.runtime import SamplingParams
    kw = dict(SAMPLER_VARIANTS[name])
    if name == "bias_floor":
        return [SamplingParams(max_tokens=64, logit_bias={eos: 100.0}, **kw)] * 8
    return [SamplingParams(max_tokens=64, ignore_eos=True,
                           seed=None if kw["temperature"] == 0 else 100 + i, **kw)
            for i in range(8)]


def fresh_logprobs(params, cfg, ids: list, n_out: int):
    """log_softmax of the logits at the last ``n_out`` positions of ``ids``
    (each position's logits predict the next token), from one eager
    forward of the whole sequence over a fresh cache on the plain
    attention: the reference of a served request's logprobs."""
    import torch
    from tpuserve_torch.models import transformer
    from tpuserve_torch.runtime.kv_cache import CacheConfig, create_kv_cache
    T, page = len(ids), 32
    nb = -(-T // page)
    dev = params["embed"]["weight"].device
    cache = create_kv_cache(cfg, CacheConfig(block_size=page, num_blocks=nb,
                                             max_blocks_per_seq=nb), dev)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)   # noqa: E731
    h = transformer._chunk_trunk(params, cfg, i32([ids]), i32([0]), i32([T]),
                                 i32([list(range(T))]), i32([list(range(nb))]), cache,
                                 "reference")
    return torch.log_softmax(transformer._unembed(params, cfg, h[0, T - n_out:]), dim=-1)


def phase_sampler(results) -> dict:
    """The full sampler on the main path's engines (the default one, every
    dispatch a replayed graph, pipelined; the eager, synchronous one) on
    ``feature_model`` (full width, FEATURE_LAYERS layers), bf16, the main path's 8 prompts (prefix caching off
    for the phase, so every variant prefills them fresh), 64 tokens.  Each
    variant of ``SAMPLER_VARIANTS`` on the default engine, launches
    counted, then on the eager engine.  Gates: each variant's tokens equal
    on both engines; top_k 1 at temperature 0.8 gives the greedy streams,
    min_p 1.0 a token at its step's largest logprob (ties at the top are
    kept and sampled among); logit_bias {eos: +100} with min_tokens 16 gives 16
    tokens, then EOS; each logprobs entry's value within the logits gate of
    a fresh eager log_softmax of its step's logits, its top 5 sorted
    descending; the launches equal the layers times the steps.
    Readings: decode tok/s of each variant on both engines (the default
    engine's five headline variants twice), device-busy ms of one window
    in the temperature and full modes and with logprobs, the decode
    executables and their capture seconds, the pool against its bound, and
    the KV blocks the cache sizing gives at the CLI's defaults with every
    executable bound and without the full mode's and the extras' decode
    executables."""
    import torch
    from tpuserve_torch.runtime import SchedulerConfig
    from tpuserve_torch.runtime.graphs import keeps_logits, pool_bytes_bound
    from tpuserve_torch.runtime.kv_cache import CacheConfig, num_blocks_for_budget
    main = feature_engines(results)
    eng, eager = main["engine"], main["eager_engine"]
    cfg, L = eng.model_cfg, eng.model_cfg.num_layers
    ps = prompts(np.random.default_rng(SEED + 3), MAIN_LENGTHS, cfg.vocab_size)
    eos = min(eng._eos_ids)
    for e in (eng, eager):
        e.block_manager.enable_prefix_caching = False
    out, streams = {"variants": {}}, {}
    try:
        st = eng.stats
        before = (st.num_prefill_steps, st.num_chunk_steps, st.num_decode_steps)
        t0 = time.perf_counter()
        reset_launches()
        for name in SAMPLER_VARIANTS:
            reqs, rates = serve_steps(eng, ps, sampler_params(name, eos))
            streams[name] = reqs
            out["variants"][name] = {"decode_tok_per_s": [rates["decode_tok_per_s"]],
                                     "mean_ttft_ms": rates["mean_ttft_ms"]}
        launches = read_launches()
        steps = {"prefill_steps": (st.num_prefill_steps - before[0])
                 - (st.num_chunk_steps - before[1]),
                 "chunk_steps": st.num_chunk_steps - before[1],
                 "decode_steps": st.num_decode_steps - before[2]}
        # a second round of the five headline variants, after the counted
        # run: one round's two windows a variant vary by ~10% on the host
        # clock
        for name in ("greedy", "temperature", "full", "penalties", "logprobs"):
            out["variants"][name]["decode_tok_per_s"].append(
                serve_steps(eng, ps, sampler_params(name, eos))[1]["decode_tok_per_s"])
        out["default_s"] = time.perf_counter() - t0
        want = {"flash_prefill": L * steps["prefill_steps"],
                "paged_decode": L * steps["decode_steps"],
                "paged_window": L * steps["chunk_steps"], "ragged_paged": 0}
        same = {}
        t0 = time.perf_counter()
        for name in SAMPLER_VARIANTS:
            ereqs, erates = serve_steps(eager, ps, sampler_params(name, eos))
            out["variants"][name]["eager_decode_tok_per_s"] = erates["decode_tok_per_s"]
            same[name] = ([r.output_token_ids for r in ereqs]
                          == [r.output_token_ids for r in streams[name]])
        out["eager_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        toks = {k: [r.output_token_ids for r in v] for k, v in streams.items()}
        floor_rows = streams["bias_floor"]
        floor_ok = all(len(r.output_token_ids) == SAMPLER_FLOOR + 1
                       and r.output_token_ids[-1] == eos
                       and not set(r.output_token_ids[:-1]) & eng._eos_ids
                       and r.finish_reason.value == "stop" for r in floor_rows)
        # logprobs against a fresh eager forward of each stream
        lp_diff, lp_sorted, lp_count = 0.0, True, 0
        for p, r in zip(ps, streams["logprobs"]):
            out_ids = r.output_token_ids
            ref = fresh_logprobs(eng.params, cfg, p + out_ids[:-1], len(out_ids))
            ref_chosen = ref.gather(1, torch.tensor(out_ids, device=ref.device)[:, None])[:, 0]
            got = torch.tensor([e["logprob"] for e in r.logprobs], device=ref.device)
            lp_diff = max(lp_diff, (got - ref_chosen).abs().max().item())
            lp_sorted &= all([lp for _, lp in e["top"]] == sorted(
                (lp for _, lp in e["top"]), reverse=True) and len(e["top"]) == 5
                for e in r.logprobs)
            lp_count += len(r.logprobs)
            lp_sorted &= [e["token_id"] for e in r.logprobs] == out_ids
            del ref
        out["logprobs_check_s"] = time.perf_counter() - t0
        gates = {
            "same_tokens_default_and_eager": same,
            "top_k_1_is_greedy": toks["top_k_1"] == toks["greedy"],
            "min_p_1_at_the_max": all(e["logprob"] == e["top"][0][1]
                                      for r in streams["min_p_1"] for e in r.logprobs)
            and sum(len(r.logprobs) for r in streams["min_p_1"]) == 8 * 64,
            "min_p_1_is_greedy": toks["min_p_1"] == toks["greedy"],
            "bias_floor_16_then_eos": floor_ok,
            "logprobs_max_abs_diff": lp_diff,
            "logprobs_entries": lp_count,
            "logprobs_sorted_and_aligned": lp_sorted,
            "launches_are_steps": launches == want and launches["paged_decode"] > 0,
        }
        out["ok"] = (all(same.values()) and gates["top_k_1_is_greedy"]
                     and gates["min_p_1_at_the_max"] and floor_ok and lp_sorted
                     and lp_count == 8 * 64 and lp_diff <= LOGIT_DIFF_MAX
                     and gates["launches_are_steps"]
                     and toks["temperature"] != toks["greedy"]
                     and toks["full"] != toks["temperature"])
        out.update(gates=gates, launches=launches, launches_expected=want, **steps,
                   logprobs_gate=LOGIT_DIFF_MAX, eos=eos)
        # one steady window of the temperature and full modes and of
        # greedy with logprobs, profiled (phase profile has a greedy one)
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED + 13)
        out["window_profiles"] = {}
        for name, kw in (("temperature", dict(temperature=0.8, seed=3)),
                         ("full", dict(temperature=0.8, top_p=0.9, top_k=50, seed=3)),
                         ("logprobs", dict(logprobs=5))):
            prof = profile_window(eng, prompts(rng, MAIN_LENGTHS, cfg.vocab_size), **kw)
            out["window_profiles"][name] = {
                k: prof.get(k) for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                         "host_launch_calls", "kernel_launches")}
            out["ok"] &= prof["ok"]
        out["profiles_s"] = time.perf_counter() - t0
    finally:
        for e in (eng, eager):
            e.block_manager.enable_prefix_caching = True
    exes = eng.graphs.executables
    dec = [k for k in exes if k[0] == "decode"]
    out["decode_executables"] = len(dec)
    out["decode_capture_s"] = sum(exes[k].capture_s for k in dec)
    out["decode_executables_keeping_logits"] = sum(1 for k in dec if keeps_logits(k))
    out["pool_bytes"] = eng.graphs.pool_bytes()
    keys = eng._step_keys(eng.scheduler.cfg, eng.max_seq_len)
    out["pool_bytes_bound"] = pool_bytes_bound(cfg, keys, eng._ragged_seqs)
    out["ok"] &= out["pool_bytes"] <= out["pool_bytes_bound"]
    # the cache sizing at the CLI's defaults (--num-blocks 0), from the
    # card's free memory now: bounding every executable, and bounding only
    # greedy and temperature decode without extras beside the other kinds
    cli_cache, cli_sched = CacheConfig(block_size=32, max_blocks_per_seq=64), SchedulerConfig()
    free = torch.cuda.mem_get_info()[0]
    old = [k for k in keys if k[0] != "decode" or (len(k) == 3 and k[2] != "full")]
    kv = {"free_bytes": free, "addressable_blocks": cli_sched.max_num_seqs * 65}
    for label, ks in (("without_sampler_graphs", old), ("every_graph", keys)):
        bound = pool_bytes_bound(cfg, ks, eng._ragged_seqs)
        blocks = num_blocks_for_budget(cfg, cli_cache, free - bound)
        kv[label] = {"pool_bytes_bound": bound, "budget_blocks": blocks,
                     "blocks": min(blocks, kv["addressable_blocks"], 1 << 17)}
    out["kv_blocks_cli_defaults"] = kv
    return out


# phase guided: the spec families (mode, spec) of the main path's 8
# streams, greedy and at temperature 0.8 (seed 200 + row), up to 64 tokens
GUIDED_SCHEMA = {"type": "object",
                 "properties": {"name": {"type": "string"}, "ok": {"type": "boolean"},
                                "mood": {"enum": ["up", "down", "flat"]}},
                 "required": ["name", "ok", "mood"], "additionalProperties": False}
# an integer field's digit prefixes pass the FSM compile's state budget (in
# the JAX package too): this schema runs the substitution path
GUIDED_INT_SCHEMA = {"type": "object",
                     "properties": {"name": {"type": "string"}, "n": {"type": "integer"},
                                    "mood": {"enum": ["up", "down", "flat"]}},
                     "required": ["name", "n", "mood"], "additionalProperties": False}
GUIDED_FAMILIES = {
    "json_object": ("json", None),
    "json_schema": ("json_schema", json.dumps(GUIDED_SCHEMA)),
    "json_schema_int": ("json_schema", json.dumps(GUIDED_INT_SCHEMA)),
    "regex": ("regex", "[0-9]{3}-[0-9]{4}"),
    "choice": ("choice", json.dumps(["alpha", "beta", "gamma"])),
}
# a grammar that never completes inside 129 tokens: long guided streams
# for the decode rate and the profiled window
GUIDED_LONG = ("regex", "[a-z0-9 ]+")
GUIDED_TOKENS = 64


def guided_params(mode: str, spec, temperature: float, n: int = 8, **kw) -> list:
    from tpuserve_torch.runtime import SamplingParams
    return [SamplingParams(max_tokens=GUIDED_TOKENS, temperature=temperature, guided=mode,
                           guided_schema=spec, seed=None if temperature == 0 else 200 + i,
                           **kw) for i in range(n)]


def guided_valid(mode: str, spec, text: str, stopped: bool) -> bool:
    """Whether ``text`` is legal under its spec: a prefix its character
    acceptor takes, and, when the request stopped, a whole document: JSON
    (an object; with a schema, exactly its fields with their types and enum
    values), a full match of the pattern, or one of the choices."""
    import re
    from tpuserve_torch.runtime import guided, guided_choice, guided_regex
    if mode == "json":
        m = guided.JsonStateMachine()
    elif mode == "json_schema":
        m = guided.SchemaJsonStateMachine(guided.compile_schema(json.loads(spec)))
    elif mode == "regex":
        m = guided_regex.RegexStateMachine(guided_regex.compile_regex(spec))
    else:
        m = guided_choice.ChoiceStateMachine(guided_choice.compile_choices(json.loads(spec)))
    try:
        m.feed(text)
    except ValueError:
        return False
    if not stopped:
        return True
    if mode == "regex":
        return re.fullmatch(spec, text) is not None
    if mode == "choice":
        return text in json.loads(spec)
    try:
        doc = json.loads(text)
    except ValueError:
        return False
    if not isinstance(doc, dict):
        return False
    if mode == "json":
        return True
    schema = json.loads(spec)
    types = {"string": str, "boolean": bool, "integer": int}
    return set(doc) == set(schema["required"]) and all(
        (v["type"] != "integer" or not isinstance(doc[k], bool))
        and isinstance(doc[k], types[v["type"]]) if "type" in v else doc[k] in v["enum"]
        for k, v in schema["properties"].items())


def guided_check(eng, reqs, plist, fsm_served: bool = True) -> dict:
    """Validity of each served request against its own spec, unguided rows
    aside: its text by ``guided_valid``, and, for a spec that compiles to
    an FSM (``eng``'s memo), every token a transition of the FSM from its
    start (the byte tokenizer's ids past 258 have no text, so a text check
    alone would pass a row that sampled them unmasked), unless the rows
    ran the substitution path (``fsm_served`` False).  Returns (all valid,
    stopped count, finish reasons)."""
    valid, stopped = True, 0
    for r, p in zip(reqs, plist):
        if p.guided is None:
            continue
        stop = r.finish_reason.value == "stop"
        stopped += stop
        valid &= guided_valid(p.guided, p.guided_schema, r.output_text, stop)
        fsm = eng._fsm_for(p) if fsm_served else None
        state = None if fsm is None else fsm.start
        for tok in r.output_token_ids if fsm is not None else ():
            state = fsm.advance(state, tok)
            if state < 0:
                valid = False
                break
    return {"valid": bool(valid), "stopped": stopped,
            "finish": [r.finish_reason.value for r in reqs]}


def phase_guided(results) -> dict:
    """Guided decoding on the main path's engines (the default one, every
    decode dispatch a replayed graph, pipelined; the eager, synchronous
    one) on ``feature_model`` (full width, FEATURE_LAYERS layers), bf16,
    the main path's 8 prompts (prefix caching off for the phase), up to 64
    tokens.  Each spec family of
    ``GUIDED_FAMILIES`` greedy and at temperature 0.8 (json_schema_int
    runs the substitution path: its integer field does not compile), a
    batch of 4 guided and 4 unguided rows, a batch of two grammars (single
    steps), and json_object on the substitution path (``guided_fsm`` off),
    on the default engine with launches counted, then on the eager engine.
    Gates: every output a legal prefix of its spec and every stopped one a
    whole document; the same tokens on both engines; the FSM families'
    greedy tokens the same on an engine of single steps
    (``multi_step=1``); FSM-guided windows dispatched; the launches the
    layers times the steps; the graph pool under its bound; and the same
    json_object requests with the mask disabled (a planted fault) must
    fail the validity gate.  Readings: the token-text table's and each
    spec's compile seconds, the guided executables' first-use capture
    seconds, decode tok/s of each family and of long guided streams beside
    greedy's, and one profiled 32-token guided window beside a greedy one."""
    import torch
    from tpuserve_torch.runtime import Engine, EngineConfig, SamplingParams, grammar
    from tpuserve_torch.runtime.graphs import is_guided, pool_bytes_bound
    main = feature_engines(results)
    eng, eager = main["engine"], main["eager_engine"]
    cfg, L, V = eng.model_cfg, eng.model_cfg.num_layers, eng.model_cfg.vocab_size
    ps = prompts(np.random.default_rng(SEED + 3), MAIN_LENGTHS, V)
    out = {"families": {}}
    # host work a spec costs once: the token-text table (once an engine),
    # then each spec's compile
    t0 = time.perf_counter()
    texts = grammar.token_text_table(eng.tokenizer, V)
    out["token_text_table_s"] = time.perf_counter() - t0
    out["token_text_table_tokens"] = len(texts)
    out["compile_s"], out["fsm_states"] = {}, {}
    for name, (mode, spec) in list(GUIDED_FAMILIES.items()) + [("long", GUIDED_LONG)]:
        t0 = time.perf_counter()
        try:
            fsm = grammar.fsm_for_spec(mode, spec, eng.tokenizer, V, eng._eos_ids, texts=texts)
            out["fsm_states"][name] = [fsm.num_states, fsm.num_classes]
        except ValueError as e:
            out["fsm_states"][name] = f"not compiled: {str(e)[:60]}"
        out["compile_s"][name] = time.perf_counter() - t0
    runs = {}
    for name, (mode, spec) in GUIDED_FAMILIES.items():
        for temp in (0.0, 0.8):
            runs[f"{name}/{'greedy' if temp == 0 else 'temperature'}"] = guided_params(
                mode, spec, temp)
    plain = SamplingParams(max_tokens=GUIDED_TOKENS, temperature=0.0, ignore_eos=True)
    runs["mixed_batch"] = [guided_params("json", None, 0.0, 1)[0], plain] * 4
    runs["two_grammars"] = (guided_params("json", None, 0.0, 4)
                            + guided_params(*GUIDED_FAMILIES["regex"], 0.0, 4))
    runs["no_fsm"] = guided_params("json", None, 0.0)          # guided_fsm off
    fsm_greedy = [f"{n}/greedy" for n in ("json_object", "json_schema", "regex", "choice")]
    for e in (eng, eager):
        e.block_manager.enable_prefix_caching = False

    def serve_all(e):
        got = {}
        for name, plist in runs.items():
            e.config.guided_fsm = name != "no_fsm"
            try:
                reqs, rates = serve_steps(e, ps, plist)
            finally:
                e.config.guided_fsm = True
            got[name] = (reqs, rates)
        return got

    try:
        st = eng.stats
        before = (st.num_prefill_steps, st.num_chunk_steps, st.num_decode_steps,
                  st.guided_fsm_windows, st.guided_fsm_requests, st.guided_fallbacks,
                  st.guided_plans, st.num_decode_windows)
        t0 = time.perf_counter()
        reset_launches()
        served = serve_all(eng)
        launches = read_launches()
        steps = {"prefill_steps": (st.num_prefill_steps - before[0])
                 - (st.num_chunk_steps - before[1]),
                 "chunk_steps": st.num_chunk_steps - before[1],
                 "decode_steps": st.num_decode_steps - before[2],
                 "decode_windows": st.num_decode_windows - before[7],
                 "guided_fsm_windows": st.guided_fsm_windows - before[3],
                 "guided_fsm_requests": st.guided_fsm_requests - before[4],
                 "guided_fallbacks": st.guided_fallbacks - before[5],
                 "guided_plans": st.guided_plans - before[6]}
        out["default_s"] = time.perf_counter() - t0
        want = {"flash_prefill": L * steps["prefill_steps"],
                "paged_decode": L * steps["decode_steps"],
                "paged_window": L * steps["chunk_steps"], "ragged_paged": 0}
        t0 = time.perf_counter()
        eager_served = serve_all(eager)
        out["eager_s"] = time.perf_counter() - t0
        same, valid = {}, {}
        for name, (reqs, rates) in served.items():
            toks = [r.output_token_ids for r in reqs]
            same[name] = toks == [r.output_token_ids for r in eager_served[name][0]]
            e_chk = guided_check(eager, eager_served[name][0], runs[name], name != "no_fsm")
            chk = guided_check(eng, reqs, runs[name], name != "no_fsm")
            valid[name] = chk["valid"] and e_chk["valid"]
            out["families"][name] = {
                "decode_tok_per_s": rates["decode_tok_per_s"],
                "eager_decode_tok_per_s": eager_served[name][1]["decode_tok_per_s"],
                "tokens": sum(len(t) for t in toks), "stopped": chk["stopped"],
                "finish": chk["finish"], "text_0": reqs[0].output_text[:80]}
        # the FSM families' greedy streams on single steps
        t0 = time.perf_counter()
        single = Engine(EngineConfig(seed=SEED, multi_step=1, enable_prefix_caching=False),
                        params=eng.params, model_cfg=cfg)
        same_single = {}
        for name in fsm_greedy:
            reqs, _ = serve_steps(single, ps, runs[name])
            same_single[name] = ([r.output_token_ids for r in reqs]
                                 == [r.output_token_ids for r in served[name][0]])
        out["single_steps_s"] = time.perf_counter() - t0
        out["single_steps_guided_fsm_windows"] = single.stats.guided_fsm_windows
        del single
        torch.cuda.empty_cache()
        # the planted fault: the json_object requests with the mask off
        eng.guided_mask_enabled = False
        try:
            fault_reqs, _ = serve_steps(eng, ps, runs["json_object/greedy"])
        finally:
            eng.guided_mask_enabled = True
        fault = guided_check(eng, fault_reqs, runs["json_object/greedy"])
        # long guided streams (129 tokens) beside greedy ones, same run
        t0 = time.perf_counter()
        long_p = [SamplingParams(max_tokens=1 + 4 * eng._multi_step, temperature=0.0,
                                 ignore_eos=True, guided=GUIDED_LONG[0],
                                 guided_schema=GUIDED_LONG[1])] * 8
        greedy_p = [SamplingParams(max_tokens=1 + 4 * eng._multi_step, temperature=0.0,
                                   ignore_eos=True)] * 8
        rates = {"greedy": [], "guided_long": []}
        for _ in range(2):
            for name, plist in (("greedy", greedy_p), ("guided_long", long_p)):
                reqs, r = serve_steps(eng, ps, plist)
                rates[name].append(r["decode_tok_per_s"])
                if name == "guided_long":
                    valid["guided_long"] = guided_check(eng, reqs, plist)["valid"]
        out["long_streams_decode_tok_per_s"] = rates
        out["long_streams_s"] = time.perf_counter() - t0
        # one steady 32-token window each, profiled
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED + 17)
        out["window_profiles"] = {}
        for name, kw in (("greedy", {}), ("guided", dict(guided=GUIDED_LONG[0],
                                                          guided_schema=GUIDED_LONG[1]))):
            prof = profile_window(eng, prompts(rng, MAIN_LENGTHS, V), **kw)
            out["window_profiles"][name] = {
                k: prof.get(k) for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                         "host_launch_calls", "kernel_launches", "top")}
            out["window_profiles"][name]["ok"] = prof["ok"]
        busy = [out["window_profiles"][k]["device_busy_ms"] for k in ("greedy", "guided")]
        if all(isinstance(b, float) for b in busy):
            out["guided_window_busy_over_greedy"] = busy[1] / busy[0] - 1
        out["profiles_s"] = time.perf_counter() - t0
    finally:
        for e in (eng, eager):
            e.block_manager.enable_prefix_caching = True
    exes = eng.graphs.executables
    guided_keys = [k for k in exes if is_guided(k)]
    out["guided_executables"] = ["/".join(map(str, k)) for k in guided_keys]
    out["guided_capture_s"] = {"/".join(map(str, k)): exes[k].capture_s for k in guided_keys}
    out["pool_bytes"] = eng.graphs.pool_bytes()
    keys = eng._step_keys(eng.scheduler.cfg, eng.max_seq_len, guided=True)
    out["pool_bytes_bound"] = pool_bytes_bound(cfg, keys, eng._ragged_seqs)
    gates = {
        "valid": valid,
        "same_tokens_default_and_eager": same,
        "same_tokens_windows_and_single_steps": same_single,
        "guided_fsm_windows": steps["guided_fsm_windows"] > 0,
        "planted_fault_fails_validity": not fault["valid"],
        "launches_are_steps": launches == want and launches["paged_decode"] > 0,
        "pool_under_bound": out["pool_bytes"] <= out["pool_bytes_bound"],
        "profiles_ok": all(v["ok"] for v in out["window_profiles"].values()),
    }
    out["ok"] = (all(valid.values()) and all(same.values()) and all(same_single.values())
                 and all(v for k, v in gates.items() if isinstance(v, bool)))
    out.update(gates=gates, launches=launches, launches_expected=want, **steps,
               planted_fault=fault, tokens_max=GUIDED_TOKENS)
    return out


def step_graphs_bit_equal(params, cfg) -> dict:
    """One prefill, one chunk and one mixed step, each replayed from its
    captured graph and run eagerly by an executable on the same inputs
    and a copy of the same cache, at full width and depth, bf16: the
    logits and the cache must be bit-equal (the same kernels in the same
    order).  Shapes of the main, chunked and mixed phases: the main
    path's (8, 1024) prefill batch of 128-1,024-token prompts; a 2,048-row
    chunk bucket carrying 1,904 rows over 4,096 cached tokens; a 512-row
    mixed stream of 8 decode rows over 256 cached tokens each and a
    480-row chunk over 480 cached, descriptors for 64 sequences.  The
    cached pages hold random values."""
    import torch
    from tpuserve_torch.ops.ragged_paged import ragged_block, ragged_layout
    from tpuserve_torch.runtime.graphs import StepGraphs
    from tpuserve_torch.runtime.kv_cache import CacheConfig, create_kv_cache
    rng = np.random.default_rng(SEED + 11)
    V, page, seqs = cfg.vocab_size, 32, 64
    blk = ragged_block("cuda")

    def tok(n):
        return rng.integers(0, V, n)

    def slots(bt_row, start, n):
        t = np.arange(start, start + n)
        return bt_row[t // page] * page + t % page

    cases = {}
    # prefill: 8 prompts of the main lengths, sequence i on pages i*32 ..
    pages = 32
    bt = np.arange(8 * pages, dtype=np.int32).reshape(8, pages)
    fill = {"tokens": np.zeros((8, 1024), np.int32), "prompt_lens": np.array(MAIN_LENGTHS),
            "slot_ids": np.full((8, 1024), 2**30, np.int32)}
    for i, n in enumerate(MAIN_LENGTHS):
        fill["tokens"][i, :n], fill["slot_ids"][i, :n] = tok(n), slots(bt[i], 0, n)
    cases["prefill"] = (("prefill", 8, 1024), pages, 8 * pages, fill)
    # chunk: rows 4,096 .. 5,999 of one sequence, in the 2,048 bucket
    pages = 192
    bt = np.arange(pages, dtype=np.int32)
    n = 1904
    fill = {"tokens": np.zeros((1, 2048), np.int32), "ctx_lens": [4096], "chunk_lens": [n],
            "slot_ids": np.full((1, 2048), 2**30, np.int32), "block_tables": bt[None]}
    fill["tokens"][0, :n], fill["slot_ids"][0, :n] = tok(n), slots(bt, 4096, n)
    cases["chunk"] = (("chunk", 2048), pages, pages, fill)
    # mixed: sequences 0-7 decode at position 256, sequence 8 a chunk
    pages = 64
    bt = np.arange(9 * pages, dtype=np.int32).reshape(9, pages)
    starts, T, meta, blk_seq = ragged_layout(8, [480], blk)
    fill = {k: np.zeros(n, np.int32) for k, n in (
        ("tokens", T), ("positions", T), ("row_seq", T), ("kv_lens", seqs),
        ("q_lens", seqs), ("last_rows", seqs))}
    fill.update(slot_ids=np.full(T, 2**30, np.int32), q_starts=np.full(seqs, T, np.int32),
                block_tables=np.zeros((seqs, pages), np.int32), meta=meta, blk_seq=blk_seq)
    for i in range(8):
        fill["tokens"][i], fill["positions"][i] = tok(1)[0], 256
        fill["slot_ids"][i] = slots(bt[i], 256, 1)[0]
        fill["row_seq"][i] = fill["q_starts"][i] = fill["last_rows"][i] = i
        fill["kv_lens"][i], fill["q_lens"][i], fill["block_tables"][i] = 257, 1, bt[i]
    st, n = starts[0], 480
    rows = slice(st, st + n)
    fill["tokens"][rows], fill["positions"][rows] = tok(n), 480 + np.arange(n)
    fill["slot_ids"][rows], fill["row_seq"][rows] = slots(bt[8], 480, n), 8
    fill["kv_lens"][8], fill["q_starts"][8], fill["q_lens"][8] = 960, st, n
    fill["last_rows"][8], fill["block_tables"][8] = st + n - 1, bt[8]
    cases["mixed"] = (("mixed", T), pages, 9 * pages, fill)

    out = {}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for kind, (key, pages, nb, fill) in cases.items():
        cache0 = create_kv_cache(cfg, CacheConfig(num_blocks=nb, max_blocks_per_seq=pages),
                                 "cuda")
        for e in cache0:
            for t in e.values():
                t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
        runs = {}
        for name, capture in (("graph", True), ("eager", False)):
            cache = [{k: t.clone() for k, t in e.items()} for e in cache0]
            graphs = StepGraphs(params, cfg, cache, device=torch.device("cuda"),
                                attn_impl="cuda", max_blocks=pages, steps=1, max_batch=seqs,
                                ragged_blk=blk, capture=capture)
            exe = graphs.get(*key)
            st = exe.stage()
            for field, arr in fill.items():
                getattr(st, field)[...] = arr
            exe.load(st)
            exe.run()
            torch.cuda.synchronize()
            runs[name] = (exe.logits.clone(), cache)
            del graphs, exe
        (lg, cg), (le, ce) = runs["graph"], runs["eager"]
        logits_equal = torch.equal(lg, le)
        cache_equal = all(torch.equal(a[k], b[k]) for a, b in zip(cg, ce) for k in a)
        out[kind] = {"key": list(key), "logits_bit_equal": logits_equal,
                     "cache_bit_equal": cache_equal,
                     "max_logit_diff": (lg - le).abs().max().item(),
                     "finite": bool(torch.isfinite(lg).all()),
                     "ok": logits_equal and cache_equal and bool(torch.isfinite(lg).all())}
        del runs, cache0, lg, le, cg, ce
        torch.cuda.empty_cache()
    out["ok"] = all(v["ok"] for v in out.values())
    return out


def phase_profile(results) -> dict:
    """Where the time goes, after every counted run, on the phases'
    engines: the main path's 8 prompt lengths as fresh prompts (one
    prefill and one 32-token window; the served prompts are prefix-cache
    hits now), one steady window alone; then, on the default engine (every
    step a replayed graph) and on the eager engine of the same phase, one
    prefill step alone (8 fresh prompts of the main lengths), the third
    chunk of a fresh 6,000-token prompt (1,904 rows on 4,096 cached), and
    one mixed step of 8 decoding streams and a 1,000-token arrival."""
    import torch
    from tpuserve_torch.runtime import SamplingParams
    rng = np.random.default_rng(SEED + 9)
    eng = results["main"]["engine"]
    ps = prompts(rng, MAIN_LENGTHS, eng.model_cfg.vocab_size)
    params = SamplingParams(max_tokens=1 + eng._multi_step, temperature=0.0,
                            ignore_eos=True)
    out = {"main_prefill_and_window": device_profile(lambda: eng.generate(ps, params))}
    out["decode_window"] = profile_window(eng, prompts(rng, MAIN_LENGTHS,
                                                      eng.model_cfg.vocab_size))
    for name, phase, profile in (("prefill_step", "main", profile_prefill),
                                 ("chunk_step", "chunked", profile_chunk),
                                 ("mixed_step", "mixed", profile_mixed)):
        out[name] = {}
        for engine in ("engine", "eager_engine"):
            eng = results[phase].pop(engine)
            out[name]["graphs" if engine == "engine" else "eager"] = profile(eng, rng)
            del eng
        torch.cuda.empty_cache()
    out["pad_drop_write"] = pad_drop_write(results["main"]["params"])
    out["ok"] = (all(v.get("request_finished", True) for k in ("prefill_step", "chunk_step",
                                                                "mixed_step")
                     for v in out[k].values())
                 and out["decode_window"]["ok"])
    return out


def pad_drop_write(params) -> dict:
    """What writing every row of a bucket costs over writing its real rows
    alone: one layer's KV write (``attention.write_kv_entry``, bf16 and
    int8 pages) of a prefix hit's 300-row suffix padded to a 2,048-row
    chunk bucket, every padding row rewriting the first real row's slot
    (``pad_drop``, one plan a step), against the write of the 300 rows
    alone; CUDA events, mean of 50 back-to-back calls.  The model's layers
    times the difference is the padding's cost a step."""
    import torch
    from tpuserve_torch.ops import attention
    cfg_layers = len(params["layers"])
    g = torch.Generator(device="cuda").manual_seed(SEED)
    nb, page, Hkv, D, rows, real = 4096, 32, 8, 128, 2048, 300
    k = torch.randn(rows, Hkv, D, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(rows, Hkv, D, generator=g, device="cuda").to(torch.bfloat16)
    slots = torch.full((rows,), 2**30, dtype=torch.int32, device="cuda")
    slots[:real] = 1000 * page + torch.arange(real, dtype=torch.int32, device="cuda")
    out = {"layers": cfg_layers, "bucket_rows": rows, "real_rows": real}
    for name, int8 in (("bf16", False), ("int8", True)):
        kc, vc, ks, vs = paged_cache(g, nb, page, Hkv, D, "bfloat16", int8)
        entry = {"k": kc, "v": vc, **({"ks": ks, "vs": vs} if int8 else {})}
        drop = attention.pad_drop(slots, nb * page)
        drop_real = attention.pad_drop(slots[:real], nb * page)
        bucket = cuda_ms(lambda: attention.write_kv_entry(entry, k, v, slots, drop=drop), 50)
        alone = cuda_ms(lambda: attention.write_kv_entry(entry, k[:real], v[:real],
                                                         slots[:real], drop=drop_real), 50)
        out[name] = {"bucket_ms": bucket, "real_rows_alone_ms": alone,
                     "padding_ms_a_step": cfg_layers * (bucket - alone)}
    return out


def profile_prefill(eng, rng) -> dict:
    """One batched prefill alone: 8 fresh prompts of the main lengths."""
    return profile_step(eng, prompts(rng, MAIN_LENGTHS, eng.model_cfg.vocab_size), skip=0)


def profile_chunk(eng, rng) -> dict:
    """The third chunk of a fresh 6,000-token prompt."""
    return profile_step(eng, prompts(rng, [6000], eng.model_cfg.vocab_size), skip=2)


def profile_mixed(eng, rng) -> dict:
    """One mixed step: 8 streams decoding, then a 1,000-token arrival."""
    from tpuserve_torch.runtime import SamplingParams
    V = eng.model_cfg.vocab_size
    for p in prompts(rng, [64] * 8, V):
        eng.add_request(prompt_token_ids=p, params=SamplingParams(
            max_tokens=48, temperature=0.0, ignore_eos=True))
    windows = eng.stats.num_decode_windows
    while eng.stats.num_decode_windows == windows:     # the 8 streams decode
        eng.step()
    return profile_step(eng, prompts(rng, [1000], V), skip=0)


def profile_window(eng, ps, **sampling) -> dict:
    """One steady pipelined decode window of the main path under
    torch.profiler: serve ``ps`` (greedy, or with the SamplingParams
    fields ``sampling``) until two windows are dispatched, let the card
    finish, then profile the step that dispatches the third (and flushes
    the second).  Its kernels are one window's, all from graph
    replays: the paged decode kernel's must show in the trace, at most
    layers x window of them (the profiler may drop a few records of a
    window's ~80,000 kernels; their share is reported)."""
    import torch
    from tpuserve_torch.runtime import SamplingParams
    S = eng._multi_step
    sp = dict(dict(max_tokens=1 + 4 * S, temperature=0.0, ignore_eos=True), **sampling)
    rids = [eng.add_request(prompt_token_ids=p, params=SamplingParams(**sp)) for p in ps]
    windows = eng.stats.num_decode_windows
    while eng.stats.num_decode_windows < windows + 2:
        eng.step()
    torch.cuda.synchronize()
    res = device_profile(eng.step)
    while eng.has_work():
        eng.step()
    L = eng.model_cfg.num_layers
    res["paged_decode_kernels_launched"] = L * S
    res["request_finished"] = all(eng.requests.pop(r).finished for r in rids)
    traced = res.get("paged_decode_kernels", 0)
    res["paged_decode_traced_share"] = traced / (L * S)
    res["ok"] = 0 < traced <= L * S
    return res


# CUDA API calls (runtime `cuda*`, low-level `cu*`) that put work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def device_profile(run) -> dict:
    """``run()`` under torch.profiler.  Device busy time is the sum of
    kernel self times; the rest of the wall time the card sits idle
    waiting for the host.  ``host_launch_calls`` counts the host's calls
    that put work on the card (a graph replay is one), by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        return {"device_busy_ms": "not measured", "wall_ms": wall_ms}
    busy = sum(ms for _, ms, _ in kernels)

    def share(pred):
        return sum(ms for k, ms, _ in kernels if pred(k.lower())) / busy

    kernels.sort(key=lambda x: -x[1])
    calls = {e.key: e.count for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CPU and e.key in LAUNCH_CALLS}
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "host_launch_calls": sum(calls.values()), "host_launch_calls_by_name": calls,
            "paged_decode_kernels": sum(c for k, _, c in kernels if "paged_decode" in k.lower()),
            "device_idle_share": 1 - busy / wall_ms,
            **{f"share_{name}": share(lambda k, n=name: n in k) for name in KERNELS},
            "share_gemm": share(lambda k: any(w in k for w in (
                "gemm", "cutlass", "xmma", "nvjet")) or k.startswith("sm90")),
            "kernel_launches": sum(c for _, _, c in kernels),
            "top": [{"name": k[:90], "ms": ms, "count": c} for k, ms, c in kernels[:8]]}


# --------------------------------------------------------------------------
# phases 5 and 6: the chunked and mixed paths
# --------------------------------------------------------------------------

def drive(eng, on_step=None) -> list[dict]:
    """Step ``eng`` until it has no work, synchronising after each step so
    its wall time holds its device work.  ``on_step(eng, steps)`` runs
    after each step.  Returns one record per step: its kind (by the stats it moved),
    ms, and tokens emitted outside prefill."""
    import torch
    steps = []
    while eng.has_work():
        st = eng.stats
        before = (st.num_chunk_steps, st.num_mixed_steps, st.num_prefill_steps,
                  st.actual_tokens_total, st.num_decode_steps)
        t = time.perf_counter()
        outs = eng.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        kind = ("chunk" if st.num_chunk_steps > before[0] else
                "mixed" if st.num_mixed_steps > before[1] else
                "prefill" if st.num_prefill_steps > before[2] else "decode")
        decoded = {}                  # a fused window emits one output a token
        for o in outs:
            if not o.from_prefill:
                decoded[o.request_id] = decoded.get(o.request_id, 0) + len(o.new_token_ids)
        steps.append({"kind": kind, "ms": ms,
                      "computed": st.actual_tokens_total - before[3],
                      "decode_steps": st.num_decode_steps - before[4],
                      "decode_tokens": decoded})
        if on_step is not None:
            on_step(eng, steps)
    return steps


def expected_launches(layers: int, steps) -> dict:
    """Each kernel's launches over the steps ``drive`` recorded: one a layer
    for each batched prefill (flash prefill), each decode token step of a
    decode window or single step (paged decode), each chunk step (paged
    window) and each mixed step (ragged paged)."""
    count = {"prefill": 0, "decode": 0, "chunk": 0, "mixed": 0}
    for s in steps:
        count[s["kind"]] += s["decode_steps"] if s["kind"] == "decode" else 1
    return {"flash_prefill": layers * count["prefill"],
            "paged_decode": layers * count["decode"],
            "paged_window": layers * count["chunk"],
            "ragged_paged": layers * count["mixed"]}


def step_summary(steps) -> dict:
    """Count, total ms and decode tokens of each kind of step, and the
    steps in order as [kind, ms, decode tokens, rows decoded]."""
    out = {"log": []}
    for s in steps:
        k = out.setdefault(s["kind"], {"steps": 0, "ms": 0.0, "decode_tokens": 0})
        k["steps"] += 1
        k["ms"] += s["ms"]
        k["decode_tokens"] += sum(s["decode_tokens"].values())
        out["log"].append([s["kind"], round(s["ms"], 1), sum(s["decode_tokens"].values()),
                           len(s["decode_tokens"])])
    return out


def ttft_ms(req) -> float:
    return (req.first_token_time - req.arrival_time) * 1e3


def phase_chunked(params) -> dict:
    """The chunked path at full depth, bf16: 4 short streams, a 6,000-token
    prompt in chunks of 2,048, then (once it has its first token) a prompt
    sharing its first 4,096 tokens, which the prefix cache serves.  The
    default engine (every step a replayed graph), then the eager engine
    (``cuda_graphs=False, pipeline_decode=False``) on the same requests:
    the same tokens, each one's step times, TTFTs and decode tok/s."""
    import torch
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig
    torch.cuda.empty_cache()
    # the default engine, with room for the long prompts: the default 64
    # blocks a sequence hold 2,048 tokens, one chunk
    cache = CacheConfig(max_blocks_per_seq=256, num_blocks=4096)
    eng = Engine(EngineConfig(seed=SEED, cache=cache), params=params)
    cfg = eng.model_cfg
    L, V = cfg.num_layers, cfg.vocab_size
    rng = np.random.default_rng(SEED + 6)
    short = prompts(rng, [512] * 4, V)
    long = prompts(rng, [6000], V)[0]
    hit = long[:4096] + prompts(rng, [300], V)[0]
    res = serve_chunked(eng, short, long, hit)
    eager = Engine(EngineConfig(seed=SEED, cache=cache, cuda_graphs=False,
                                pipeline_decode=False), params=params)
    eres = serve_chunked(eager, short, long, hit)
    same = res.pop("tokens") == eres.pop("tokens")
    logit_check = chunk_logits(params, cfg, long)
    ok = (res.pop("ok") and eres.pop("ok") and same and logit_check["ok"])
    return {"ok": ok, "engine": eng, "eager_engine": eager, "model": cfg.name, "layers": L,
            "dtype": cfg.dtype, **res, "eager": {**eres, "same_tokens": same},
            "logits": logit_check}


def serve_chunked(eng, short, long, hit) -> dict:
    """The chunked phase's requests on ``eng``, warmed for the buckets they
    hit (the defaults, which hold the 2,048 chunk, plus the short
    prompts' (4, 512) prefill, as a bench warms its run's buckets; the
    hit, longer than a chunk, runs its 300-token suffix in the 2,048
    bucket); each kernel's launches must be the layers times its steps,
    and the hit's one chunk must start at its cached offset."""
    from tpuserve_torch.runtime import SamplingParams
    L = eng.model_cfg.num_layers
    sp_short = SamplingParams(max_tokens=64, temperature=0.0, ignore_eos=True)
    sp_long = SamplingParams(max_tokens=16, temperature=0.0, ignore_eos=True)
    eng.warmup()
    eng.warmup(decode_buckets=[], prefill_buckets=[(4, 512)])
    reset_launches()
    short_ids = [eng.add_request(prompt_token_ids=p, params=sp_short) for p in short]
    long_id = eng.add_request(prompt_token_ids=long, params=sp_long)
    state = {}

    def on_step(e, steps):
        # the hit arrives once the long prompt has its first token (its
        # blocks are then written and in the prefix cache)
        if "hit" not in state and e.requests[long_id].output_token_ids:
            state["cached"] = e.block_manager.lookup_prefix(hit, count_stats=False)[1]
            state["hit"] = e.add_request(prompt_token_ids=hit, params=sp_long)
            state["from"] = len(steps)

    steps = drive(eng, on_step)
    launches = read_launches()
    # the hit's one chunk step computed its uncached tail: it started at the
    # prompt's length less the tokens computed
    hit_chunks = [s for s in steps[state["from"]:] if s["kind"] == "chunk"]
    hit_start = len(hit) - hit_chunks[0]["computed"] if hit_chunks else None
    reqs = [eng.requests[r] for r in short_ids + [long_id, state["hit"]]]
    finished = all(r.finished for r in reqs) and [len(r.output_token_ids) for r in reqs] == (
        [64] * 4 + [16, 16])
    chunk_steps = eng.stats.num_chunk_steps
    want = expected_launches(L, steps)
    chunk_ms = [s["ms"] for s in steps if s["kind"] == "chunk"]
    dec = [s for s in steps if s["kind"] == "decode"]
    short_tokens = sum(n for s in dec for r, n in s["decode_tokens"].items() if r in short_ids)
    dec_s = sum(s["ms"] for s in dec) / 1e3
    # the path runs batched prefill (the short prompts), decode windows and chunks
    ran = all(launches[k] > 0 for k in ("flash_prefill", "paged_decode", "paged_window"))
    ok = (finished and launches == want and ran and chunk_steps >= 4
          and hit_start == state["cached"] == 4096 and len(hit_chunks) == 1)
    return {"ok": ok, "tokens": [r.output_token_ids for r in reqs],
            "requests": len(reqs), "finished_with_tokens": finished,
            "chunk_steps": chunk_steps, "launches": launches, "launches_expected": want,
            "hit_cached_tokens": state["cached"], "hit_first_chunk_start": hit_start,
            "long_ttft_ms": ttft_ms(reqs[4]), "hit_ttft_ms": ttft_ms(reqs[5]),
            "chunk_step_ms": chunk_ms, "mean_chunk_step_ms": sum(chunk_ms) / len(chunk_ms),
            "short_decode_tokens": short_tokens, "decode_s": dec_s,
            "short_decode_tok_per_s": short_tokens / dec_s if dec_s else None,
            "decode_windows": eng.stats.num_decode_windows,
            "graph_replays": dict(eng.graphs.replays), "step_kinds": step_summary(steps)}


def chunk_logits(params, cfg, first, total: int = 6000) -> dict:
    """The last-row logits of each 2,048-token chunk (ctx 0, 2,048, 4,096
    at the default ``total``) of four ``total``-token prompts, ``first``
    among them, on the kernel and on the plain attention: max |diff| and
    top-1 agreement."""
    import torch
    from tpuserve_torch.models import transformer
    from tpuserve_torch.ops.attention import PAD_SLOT
    from tpuserve_torch.runtime.kv_cache import CacheConfig, create_kv_cache
    rng = np.random.default_rng(SEED + 7)
    ps = [first] + prompts(rng, [total] * 3, cfg.vocab_size)
    B, C, pages = len(ps), 2048, -(-total // 32)
    bt = torch.arange(B * pages, dtype=torch.int32, device="cuda").reshape(B, pages)
    logits = {}
    for impl in ("cuda", "reference"):
        cache = create_kv_cache(cfg, CacheConfig(num_blocks=B * pages, max_blocks_per_seq=pages,
                                                 dtype=cfg.dtype), "cuda")
        rows = []
        for start in range(0, total, C):
            n = min(C, total - start)
            tokens = torch.zeros(B, C, dtype=torch.int32, device="cuda")
            tokens[:, :n] = torch.tensor([p[start:start + n] for p in ps], dtype=torch.int32)
            pos = torch.arange(start, start + n, device="cuda")
            slots = torch.full((B, C), PAD_SLOT, dtype=torch.int32, device="cuda")
            slots[:, :n] = (bt[:, pos // 32] * 32 + pos % 32).to(torch.int32)
            lens = lambda v: torch.full((B,), v, dtype=torch.int32, device="cuda")
            lg, _ = transformer.prefill_chunk(params, cfg, tokens, lens(start), lens(n),
                                              slots, bt, cache, attn_impl=impl)
            rows.append(lg)
        logits[impl] = torch.cat(rows)
        del cache
    diff = (logits["cuda"] - logits["reference"]).abs().max().item()
    top1 = (logits["cuda"].argmax(-1) == logits["reference"].argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(logits["cuda"]).all())
    return {"ok": finite and diff <= LOGIT_DIFF_MAX and top1 >= 0.75,
            "rows": logits["cuda"].shape[0],
            "max_logit_diff": diff, "logit_diff_max_allowed": LOGIT_DIFF_MAX,
            "max_abs_logit": logits["reference"].abs().max().item(), "top1_agreement": top1}


def profile_step(eng, ps, skip: int) -> dict:
    """Where the time goes in one step: add the prompts ``ps`` (one output
    token each), run ``skip`` steps, profile the next one, drain."""
    import torch
    from tpuserve_torch.runtime import SamplingParams
    sp = SamplingParams(max_tokens=1, temperature=0.0, ignore_eos=True)
    rids = [eng.add_request(prompt_token_ids=p, params=sp) for p in ps]
    for _ in range(skip):
        eng.step()
    # a decode window in flight finishes first: the trace holds this step
    torch.cuda.synchronize()
    res = device_profile(eng.step)
    while eng.has_work():
        eng.step()
    res["request_finished"] = all(eng.requests[r].finished for r in rids)
    return res


def phase_mixed(params) -> dict:
    """The mixed path at full depth, bf16, ``mixed_batching=True``: 8
    streams of 256-token prompts decoding, then, after their first fused
    window, 8 prompts of 512-1,500 tokens.  The default engine (every step
    a replayed graph), then the eager engine on the same requests: the
    same tokens, each one's step times, TTFTs and decode tok/s."""
    import torch
    from tpuserve_torch.ops import ragged_paged
    from tpuserve_torch.runtime import Engine, EngineConfig, SchedulerConfig
    torch.cuda.empty_cache()
    sched = SchedulerConfig(mixed_batching=True)
    eng = Engine(EngineConfig(seed=SEED, scheduler=sched), params=params)
    cfg = eng.model_cfg
    rng = np.random.default_rng(SEED + 8)
    early = prompts(rng, [256] * 8, cfg.vocab_size)
    late_lens = rng.integers(512, 1501, 8).tolist()
    late = prompts(rng, late_lens, cfg.vocab_size)
    res = serve_mixed(eng, early, late)
    eager = Engine(EngineConfig(seed=SEED, scheduler=sched, cuda_graphs=False,
                                pipeline_decode=False), params=params)
    eres = serve_mixed(eager, early, late)
    same = res.pop("tokens") == eres.pop("tokens")
    return {"ok": res.pop("ok") and eres.pop("ok") and same, "engine": eng,
            "eager_engine": eager, "model": cfg.name, "layers": cfg.num_layers,
            "dtype": cfg.dtype, "late_prompt_lens": late_lens,
            "ragged_block": ragged_paged.ragged_block(device="cuda"), **res,
            "eager": {**eres, "same_tokens": same}}


def serve_mixed(eng, early, late) -> dict:
    """The mixed phase's requests on ``eng``, warmed by ``Engine.warmup``'s
    defaults (the flat-token ladder and the decode ladder); each kernel's
    launches must be the layers times its steps, the ragged kernel's the
    layers times the mixed steps."""
    from tpuserve_torch.runtime import SamplingParams
    L = eng.model_cfg.num_layers
    sp_early = SamplingParams(max_tokens=128, temperature=0.0, ignore_eos=True)
    sp_late = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True)
    eng.warmup()
    reset_launches()
    early_ids = [eng.add_request(prompt_token_ids=p, params=sp_early) for p in early]
    late_ids = []

    def on_step(e, steps):
        if not late_ids and e.stats.num_decode_windows >= 1:
            late_ids.extend(e.add_request(prompt_token_ids=p, params=sp_late) for p in late)

    steps = drive(eng, on_step)
    launches = read_launches()
    st = eng.stats
    want = expected_launches(L, steps)
    reqs = [eng.requests[r] for r in early_ids + late_ids]
    finished = all(r.finished for r in reqs) and [len(r.output_token_ids) for r in reqs] == (
        [128] * 8 + [32] * 8)
    emitting = [s for s in steps if s["decode_tokens"]]
    dec_tokens = sum(sum(s["decode_tokens"].values()) for s in emitting)
    dec_s = sum(s["ms"] for s in emitting) / 1e3
    mixed_ms = [s["ms"] for s in steps if s["kind"] == "mixed"]
    padded_share = 1 - st.actual_tokens_total / st.padded_tokens_total
    mixed_steps, windows = st.num_mixed_steps, st.num_decode_windows
    # the path runs mixed steps and the decode windows between them
    ok = (finished and launches == want and mixed_steps >= 3
          and launches["ragged_paged"] == L * mixed_steps and launches["paged_decode"] > 0)
    return {"ok": ok, "tokens": [r.output_token_ids for r in reqs],
            "requests": len(reqs), "finished_with_tokens": finished,
            "mixed_steps": mixed_steps, "decode_windows": windows,
            "launches": launches, "launches_expected": want,
            "late_mean_ttft_ms": sum(ttft_ms(r) for r in reqs[8:]) / 8,
            "decode_tokens": dec_tokens, "decode_s": dec_s,
            "decode_tok_per_s": dec_tokens / dec_s if dec_s else None,
            "mixed_step_ms": mixed_ms, "mean_mixed_step_ms": sum(mixed_ms) / len(mixed_ms),
            "padded_row_share": padded_share, "graph_replays": dict(eng.graphs.replays),
            "step_kinds": step_summary(steps)}


# --------------------------------------------------------------------------
# phase tiers: the tiered KV cache on the main weights

# a 3,072-token shared prefix (96 blocks of 32), 2,048-token churn prompts,
# a hit of the prefix plus 128 new tokens; 384 blocks hold the prefix and
# about four churn prompts, so six or so evict it
TIER_PREFIX, TIER_SUFFIX, TIER_CHURN, TIER_BLOCKS = 3072, 128, 2048, 384
TIER_HIT_TOKENS = 32
TIER_SPILL_HOST_BYTES = 64 << 20           # 18 blocks of 3.5 MiB


def tier_engine(params, num_blocks: int = TIER_BLOCKS, **kw):
    """A default engine (captured graphs, pipelined windows) of the tiers
    phase, warmed for the buckets its requests hit: the churn's (1, 2,048)
    prefill, the 2,048 / 64 / 128 chunks of the shared prompts and the hit,
    greedy windows of one or two rows."""
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig
    eng = Engine(EngineConfig(seed=SEED, cache=CacheConfig(num_blocks=num_blocks,
                                                           max_blocks_per_seq=128), **kw),
                 params=params)
    eng.warmup(decode_buckets=[eng.scheduler.decode_bucket(1)],
               prefill_buckets=[(1, TIER_CHURN)], chunk_buckets=[64, TIER_SUFFIX],
               sample_modes=("greedy",))
    return eng


def timed_calls(eng, method: str, stat: str) -> list:
    """Wrap ``eng.<method>`` to record, for each call that moved blocks by
    ``stat``: (blocks, wall s, s of that spent first waiting for the card
    to finish the work already queued).  The wait is taken apart with a
    synchronise before the call, which the call would otherwise spend in
    its own host wait."""
    import torch
    calls, orig = [], getattr(eng, method)

    def timed():
        n0, t = getattr(eng.stats, stat), time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        orig()
        n = getattr(eng.stats, stat) - n0
        if n:
            calls.append((n, time.perf_counter() - t, t1 - t))
    setattr(eng, method, timed)
    return calls


def prefix_blocks(eng, prefix: list) -> list | None:
    blocks, n = eng.block_manager.lookup_prefix(prefix + [0], count_stats=False)
    return blocks if n == len(prefix) else None


def pages_equal(a, b) -> bool:
    """Bit equality of two blocks' page lists (``gather_block_pages``)."""
    return all(x.keys() == y.keys() and all(
        torch_equal_bits(x[k], y[k]) for k in x) for pa, pb in zip(a, b)
        for x, y in zip(pa, pb)) and len(a) == len(b)


def torch_equal_bits(x, y) -> bool:
    import torch
    return torch.equal(x.view(torch.uint8), y.view(torch.uint8))


def churn_out(eng, chain: list, rng, V: int, limit: int = 16) -> int:
    """Serve unrelated 2,048-token prompts one at a time until no hash of
    ``chain`` resolves on the card; returns how many it took."""
    from tpuserve_torch.runtime import SamplingParams
    sp = SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True)
    n = 0
    while any(eng.block_manager.prefix_resolvable(h) for h in chain):
        if n == limit:
            raise RuntimeError(f"the prefix survived {limit} churn prompts")
        eng.generate([prompts(rng, [TIER_CHURN], V)[0]], sp)
        n += 1
    return n


def serve_hit(eng, hit: list) -> dict:
    """The hit alone on ``eng``, launches counted from 0 and read just
    after: tokens, TTFT, its steps and launches against them."""
    from tpuserve_torch.runtime import SamplingParams
    sp = SamplingParams(max_tokens=TIER_HIT_TOKENS, temperature=0.0, ignore_eos=True)
    reset_launches()
    rid = eng.add_request(prompt_token_ids=hit, params=sp)
    steps = drive(eng)
    launches = read_launches()
    req = eng.requests.pop(rid)
    want = expected_launches(eng.model_cfg.num_layers, steps)
    chunks = [s for s in steps if s["kind"] == "chunk"]
    return {"tokens": req.output_token_ids, "ttft_ms": ttft_ms(req),
            "launches": launches, "launches_ok": launches == want,
            "chunk_steps": len(chunks), "computed_first_chunk": chunks[0]["computed"] if chunks else None,
            "step_kinds": step_summary(steps)["log"]}


def tier_run(eng, prefix, shared, hit, rng, planted: bool) -> dict:
    """Shared prefix, snapshot, churn, hit on a tiered engine, with the
    gates: the chain demoted and in the store, the restored blocks' pages
    bit-equal to the snapshot read through the engine's own cache (and,
    ``planted``, a restore with one page zeroed failing that), strict
    integrity every cycle (the engine raises), nothing left restoring and
    no tensor on the spill writer."""
    import torch
    from tpuserve_torch.runtime import SamplingParams
    from tpuserve_torch.runtime.kv_cache import gather_block_pages, scatter_block_pages
    V = eng.model_cfg.vocab_size
    store, bm, staging = eng._kv_tiers, eng.block_manager, eng._staging()
    t_phase = time.perf_counter()
    eng.generate(shared, SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True))
    chain = bm.prefix_chain(prefix + [0])
    blocks = prefix_blocks(eng, prefix)
    snapshot = gather_block_pages(eng.kv_cache, blocks, staging)
    demotes = timed_calls(eng, "_demote_evicted", "kv_demoted_blocks")
    restores = timed_calls(eng, "_begin_tier_restores", "kv_restored_blocks")
    churned = churn_out(eng, chain, rng, V)
    demoted = eng.stats.kv_demoted_blocks
    where = {}
    for h in chain:
        w = store.where(h)
        where[w] = where.get(w, 0) + 1
    in_store = all(store.has(h) for h in chain)
    host_bytes_after_churn = store.host_bytes_used
    res = serve_hit(eng, hit)
    restored = prefix_blocks(eng, prefix)
    pages_ok = restored is not None and pages_equal(
        gather_block_pages(eng.kv_cache, restored, staging), snapshot)
    out = {"churn_prompts": churned, "chain_blocks": len(chain),
           "demoted_after_churn": demoted, "chain_where": where, "chain_in_store": in_store,
           "host_bytes_after_churn": host_bytes_after_churn, "pages_bit_equal": pages_ok,
           "record_bytes": staging.record_bytes, **{"hit_" + k: v for k, v in res.items()}}
    if planted and restored is not None:
        fault = gather_block_pages(eng.kv_cache, restored, staging)
        fault[len(fault) // 2][eng.model_cfg.num_layers // 2]["k"].zero_()
        scatter_block_pages(eng.kv_cache, restored, fault, staging)
        out["planted_fault_caught"] = not pages_equal(
            gather_block_pages(eng.kv_cache, restored, staging), snapshot)
        # the copies alone, each way, on the restored blocks: the scatter
        # writes the snapshot back
        torch.cuda.synchronize()
        t = time.perf_counter()
        scatter_block_pages(eng.kv_cache, restored, snapshot, staging)
        torch.cuda.synchronize()
        scatter_s = time.perf_counter() - t
        t = time.perf_counter()
        back = gather_block_pages(eng.kv_cache, restored, staging)
        gather_s = time.perf_counter() - t
        out["pages_after_fault_repair"] = pages_equal(back, snapshot)
        nbytes = len(restored) * staging.record_bytes
        out["copy_alone"] = {"blocks": len(restored), "bytes": nbytes,
                             "scatter_ms": scatter_s * 1e3, "scatter_GBps": nbytes / scatter_s / 1e9,
                             "gather_ms": gather_s * 1e3, "gather_GBps": nbytes / gather_s / 1e9}
    s = eng.stats
    store.flush()
    out.update({
        # [blocks, stall ms, of it ms waiting for queued work, GB/s after it]
        "demote_calls": [[n, dt * 1e3, w * 1e3, n * staging.record_bytes / (dt - w) / 1e9]
                         for n, dt, w in demotes],
        "restore_begin_calls": [[n, dt * 1e3, w * 1e3] for n, dt, w in restores],
        "kv_demoted_blocks": s.kv_demoted_blocks, "kv_spilled_blocks": s.kv_spilled_blocks,
        "kv_tier_dropped_blocks": s.kv_tier_dropped_blocks,
        "kv_restored_blocks": s.kv_restored_blocks, "kv_restores": s.kv_restores,
        "host_bytes_used": store.host_bytes_used, "host_blocks": store.host_count,
        "spill_blocks": store.spill_count, "restoring_left": bm.num_restoring_blocks,
        "writer_tensor_pages": store.writer_tensor_pages,
        "seconds": time.perf_counter() - t_phase})
    del eng._demote_evicted, eng._begin_tier_restores      # the class's again
    out["ok"] = bool(
        in_store and demoted >= len(chain) == TIER_PREFIX // 32 and pages_ok
        and out.get("planted_fault_caught", True) and out.get("pages_after_fault_repair", True)
        and s.kv_restores >= 1 and s.kv_restored_blocks >= len(chain)
        and res["launches_ok"] and res["computed_first_chunk"] == len(hit) - TIER_PREFIX
        and bm.num_restoring_blocks == 0 and store.writer_tensor_pages == 0)
    return out


def tier_server(eng, prefix, hit, rng, twin_tokens) -> dict:
    """An in-process server on the tiered engine: churn over HTTP until the
    prefix is demoted, then the hit, streamed: the twin's tokens;
    ``/healthz`` shows host blocks and a digest, ``/metrics`` demotes and
    restores."""
    from tpuserve_torch.server import OpenAIServer, ServerConfig
    chain = eng.block_manager.prefix_chain(prefix + [0])
    V = eng.model_cfg.vocab_size
    d0, r0 = eng.stats.kv_demoted_blocks, eng.stats.kv_restored_blocks
    srv = OpenAIServer(eng, ServerConfig(host="127.0.0.1", port=0))
    url = f"http://127.0.0.1:{srv.start()}"
    base = dict(temperature=0, ignore_eos=True)
    try:
        churned = 0
        while any(eng.block_manager.prefix_resolvable(h) for h in chain) and churned < 16:
            status, _ = http(url + "/v1/completions",
                             dict(base, prompt=prompts(rng, [TIER_CHURN], V)[0], max_tokens=4))
            churned += 1
        res = sse(url + "/v1/completions", dict(base, prompt=hit, max_tokens=TIER_HIT_TOKENS,
                                                return_token_ids=True))
        _, health = http(url + "/healthz")
        _, metrics = http(url + "/metrics")
    finally:
        srv.shutdown()
    samples = {}
    for ln in metrics.splitlines():
        if ln.startswith("tpuserve_kv_blocks_"):
            samples[ln.split("{")[0]] = float(ln.rsplit(" ", 1)[1])
    tokens = stream_ids(res)
    tiers = health.get("kv_tier_blocks", {})
    ok = (tokens == twin_tokens and res["status"] == 200
          and tiers.get("host", 0) > 0 and int(health.get("kv_digest", "0") or "0", 16) != 0
          and samples.get("tpuserve_kv_blocks_demoted_total", 0) > 0
          and samples.get("tpuserve_kv_blocks_restored_total", 0) > 0
          and eng.stats.kv_demoted_blocks > d0 and eng.stats.kv_restored_blocks > r0)
    return {"ok": ok, "churn_prompts": churned, "same_tokens_as_twin": tokens == twin_tokens,
            "healthz_kv_tier_blocks": tiers, "healthz_digest_bits": health.get("kv_digest_bits"),
            "metrics": samples}


def phase_tiers(results) -> dict:
    """The tiered KV cache at full width and depth, bf16, the main
    weights, greedy, under ``TPUSERVE_STRICT_BLOCKS=1``: a 3,072-token
    shared prefix served twice, then churned out of a 384-block cache, then
    a hit of the prefix plus 128 tokens.  Host tier (1 GiB default), then
    spill tier (64 MiB host budget, a spill directory under build/).  The
    hit's tokens equal a twin's that serves it from HBM (1,024 blocks, no
    eviction, the same chunk route); a cold ``kv_tiers=False`` engine after
    the same churn recomputes it.  Then an in-process server on the host
    engine.  TTFT of the hit four ways, demote stalls, copy rates."""
    import os
    import shutil

    import torch
    t_all = time.perf_counter()
    params = results["main"]["params"]
    prev = os.environ.get("TPUSERVE_STRICT_BLOCKS")
    os.environ["TPUSERVE_STRICT_BLOCKS"] = "1"
    spill_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "tier_spill")
    shutil.rmtree(spill_dir, ignore_errors=True)
    try:
        torch.cuda.empty_cache()
        # the twin: the prefix stays on the card
        from tpuserve_torch.runtime import SamplingParams
        twin = tier_engine(params, num_blocks=1024)
        V = twin.model_cfg.vocab_size
        rng = np.random.default_rng(SEED + 10)
        prefix = prompts(rng, [TIER_PREFIX], V)[0]
        shared = [prefix + p for p in prompts(rng, [64, 64], V)]
        hit = prefix + prompts(rng, [TIER_SUFFIX], V)[0]
        twin.generate(shared, SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True))
        twin_hit = serve_hit(twin, hit)
        twin_ok = (twin.stats.kv_demoted_blocks == 0 and twin_hit["launches_ok"]
                   and twin_hit["computed_first_chunk"] == TIER_SUFFIX)
        del twin
        # cold: no tiers, the same churn
        cold = tier_engine(params, kv_tiers=False)
        cold.generate(shared, SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True))
        cold_churn = churn_out(cold, cold.block_manager.prefix_chain(prefix + [0]),
                               np.random.default_rng(SEED + 11), V)
        cold_hit = serve_hit(cold, hit)
        del cold
        host_eng = tier_engine(params)
        host = tier_run(host_eng, prefix, shared, hit, np.random.default_rng(SEED + 11), True)
        server = tier_server(host_eng, prefix, hit, np.random.default_rng(SEED + 12),
                             twin_hit["tokens"])
        del host_eng
        torch.cuda.empty_cache()
        spill_eng = tier_engine(params, kv_host_bytes=TIER_SPILL_HOST_BYTES,
                                kv_spill_dir=spill_dir)
        spill = tier_run(spill_eng, prefix, shared, hit, np.random.default_rng(SEED + 11), False)
        del spill_eng
    finally:
        if prev is None:
            os.environ.pop("TPUSERVE_STRICT_BLOCKS", None)
        else:
            os.environ["TPUSERVE_STRICT_BLOCKS"] = prev
        shutil.rmtree(spill_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    same = {"host": host["hit_tokens"] == twin_hit["tokens"],
            "spill": spill["hit_tokens"] == twin_hit["tokens"],
            "cold": cold_hit["tokens"] == twin_hit["tokens"]}
    for r in (host, spill):
        r.pop("hit_tokens")
    ok = (twin_ok and host["ok"] and spill["ok"] and server["ok"] and same["host"]
          and same["spill"] and spill["kv_spilled_blocks"] > 0 and spill["chain_where"].get("spill", 0) > 0)
    return {"ok": ok, "model": "Qwen/Qwen3-0.6B", "twin_ok": twin_ok,
            "same_tokens_as_twin": same,
            "ttft_ms": {"host_hit": host["hit_ttft_ms"], "spill_hit": spill["hit_ttft_ms"],
                        "hbm_hit": twin_hit["ttft_ms"], "cold_recompute": cold_hit["ttft_ms"]},
            "cold_churn_prompts": cold_churn, "cold_chunk_steps": cold_hit["chunk_steps"],
            "twin_steps": twin_hit["step_kinds"], "cold_steps": cold_hit["step_kinds"],
            "host": host, "spill": spill, "server": server,
            "wall_s": time.perf_counter() - t_all}


# --------------------------------------------------------------------------
# server phase

# the CLI's cache defaults (python -m tpuserve_torch.server), given to the
# in-process server, its twin and the CLI alike: split-K decode's
# partitions follow the block-table width, so bf16 tokens match only
# under one cache config
SERVER_CACHE = dict(block_size=32, num_blocks=2048, max_blocks_per_seq=64)
# (a): one request at a time; the last is the prefix (b) repeats
SERVER_ONE_LENGTHS = [128, 384, 640, 1024]
SERVER_TOKENS = 64


def hf_tensors(params, cfg):
    """The parameter tree as HF-named tensors of the Llama family: kernels
    back to (out, in), no ``lm_head`` when the embeddings are tied."""
    yield "model.embed_tokens.weight", params["embed"]["weight"]
    for i, lp in enumerate(params["layers"]):
        pre = f"model.layers.{i}."
        yield pre + "input_layernorm.weight", lp["attn_norm"]["scale"]
        yield pre + "post_attention_layernorm.weight", lp["mlp_norm"]["scale"]
        for proj, hf in (("q_proj", "self_attn.q_proj"), ("k_proj", "self_attn.k_proj"),
                         ("v_proj", "self_attn.v_proj"), ("o_proj", "self_attn.o_proj"),
                         ("gate_proj", "mlp.gate_proj"), ("up_proj", "mlp.up_proj"),
                         ("down_proj", "mlp.down_proj")):
            yield pre + hf + ".weight", lp[proj]["kernel"].T
            if "bias" in lp[proj]:
                yield pre + hf + ".bias", lp[proj]["bias"]
        if cfg.qk_norm:
            yield pre + "self_attn.q_norm.weight", lp["q_norm"]["scale"]
            yield pre + "self_attn.k_norm.weight", lp["k_norm"]["scale"]
    yield "model.norm.weight", params["final_norm"]["scale"]
    if not cfg.tie_word_embeddings:
        yield "lm_head.weight", params["lm_head"]["kernel"].T


def write_hf_checkpoint(params, cfg, out_dir, shards: int = 2) -> int:
    """``params`` as a bf16 HF safetensors checkpoint of ``shards`` files
    and a ``model.safetensors.index.json``, written leaf by leaf.  Returns
    the bytes of tensor data written."""
    import struct
    import torch
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("*.safetensors"):
        old.unlink()
    names = [(n, tuple(t.shape)) for n, t in hf_tensors(params, cfg)]
    sizes = [2 * int(np.prod(s)) for _, s in names]
    total, cut, acc = sum(sizes), [], 0
    for i, sz in enumerate(sizes):               # shard boundaries by bytes
        acc += sz
        if len(cut) < shards - 1 and acc >= total * (len(cut) + 1) / shards:
            cut.append(i + 1)
    bounds = [0] + cut + [len(names)]
    files = [f"model-{k + 1:05d}-of-{shards:05d}.safetensors" for k in range(shards)]
    weight_map = {}
    tensors = hf_tensors(params, cfg)
    for k, fname in enumerate(files):
        header, off = {}, 0
        for (name, shape), sz in zip(names[bounds[k]:bounds[k + 1]],
                                     sizes[bounds[k]:bounds[k + 1]]):
            header[name] = {"dtype": "BF16", "shape": list(shape),
                            "data_offsets": [off, off + sz]}
            off += sz
            weight_map[name] = fname
        head = json.dumps(header).encode()
        head += b" " * (-len(head) % 8)
        with open(out_dir / fname, "wb") as f:
            f.write(struct.pack("<Q", len(head)) + head)
            for _ in range(bounds[k + 1] - bounds[k]):
                _, t = next(tensors)
                f.write(t.to(torch.bfloat16).contiguous().cpu().view(torch.int16)
                        .numpy().tobytes())
    (out_dir / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    return total


def http(url: str, body: dict | None = None, timeout: float = 600, headers=None,
         method: str | None = None):
    """(status, parsed JSON body or text) of a GET or JSON POST."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            data = r.read().decode()
            return r.status, json.loads(data) if "json" in r.headers["Content-Type"] else data
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "null")


def sse(url: str, body: dict, timeout: float = 600, headers=None) -> dict:
    """One streamed request, read event by event: status, chunks, whether
    it ended in ``[DONE]``, and the host clock at the send, the first
    chunk carrying tokens, the last, and each one (``t_tokens``)."""
    import http.client
    from urllib.parse import urlparse
    u = urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    out = {"chunks": [], "done": False, "t_first": None, "t_last": None, "t_tokens": []}
    try:
        out["t_send"] = time.perf_counter()
        conn.request("POST", u.path, body=json.dumps(dict(body, stream=True)),
                     headers={"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        out["status"] = r.status
        if r.status != 200:
            out["error"] = r.read().decode()
            return out
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                out["done"] = True
                continue
            chunk = json.loads(line[len("data: "):])
            now = time.perf_counter()
            if any(ch.get("token_ids") or ch.get("delta", {}).get("content")
                   for ch in chunk["choices"]):
                out["t_first"] = out["t_first"] or now
                out["t_last"] = now
                out["t_tokens"].append(now)
            out["chunks"].append(chunk)
    finally:
        conn.close()
    return out


def stream_ids(res) -> list:
    return [t for c in res["chunks"] for ch in c["choices"] for t in ch.get("token_ids", [])]


def stream_ok(res, url: str, prompt_len: int) -> bool:
    """A complete, well-formed stream: SERVER_TOKENS tokens, finish_reason
    ``length``, ``[DONE]``, text equal to its ids detokenised, and usage."""
    if res.get("status") != 200 or not res["done"]:
        return False
    ids = stream_ids(res)
    finishes = [ch["finish_reason"] for c in res["chunks"] for ch in c["choices"]
                if ch.get("finish_reason")]
    text = "".join(ch.get("text", "") for c in res["chunks"] for ch in c["choices"])
    usage = res["chunks"][-1].get("usage") or {}
    _, detok = http(url + "/detokenize", {"tokens": ids})
    # the streaming detokenizer holds back a trailing partial UTF-8 rune,
    # as the JAX engine's does: at most that tail may be missing
    tail = detok["prompt"][len(text):]
    return (len(ids) == SERVER_TOKENS and finishes == ["length"]
            and detok["prompt"].startswith(text) and set(tail) <= {"\ufffd"}
            and usage == {"prompt_tokens": prompt_len, "completion_tokens": SERVER_TOKENS,
                          "total_tokens": prompt_len + SERVER_TOKENS})


def stream_rates(results) -> dict:
    """Client-side TTFT of each stream and decode tok/s across them (tokens
    after each stream's first, over the time from the earliest first token
    to the latest last)."""
    ttft = [1e3 * (r["t_first"] - r["t_send"]) for r in results]
    after = sum(len(stream_ids(r)) - 1 for r in results)
    span = max(r["t_last"] for r in results) - min(r["t_first"] for r in results)
    return {"mean_ttft_ms": sum(ttft) / len(ttft), "ttft_ms": ttft,
            "decode_tok_per_s": after / span if span > 0 else None}


def serve_steps(eng, ps, params) -> tuple[list, dict]:
    """``ps`` through ``eng``'s ``add_request``/``step`` (``params`` one
    SamplingParams for all, or a list of one a prompt): the requests;
    decode tok/s over the steps that emit decode tokens (host clock around
    each) and, as ``stream_rates`` counts a client's, over the time from
    the earliest first token to the latest last; mean TTFT."""
    plist = params if isinstance(params, list) else [params] * len(ps)
    rids = [eng.add_request(prompt_token_ids=p, params=sp) for p, sp in zip(ps, plist)]
    t_decode, tokens = 0.0, 0
    first, last = {}, {}
    while eng.has_work():
        n_prefill = eng.stats.num_prefill_steps
        t = time.perf_counter()
        outs = eng.step()
        now = time.perf_counter()
        if eng.stats.num_prefill_steps == n_prefill:
            t_decode += now - t
            tokens += sum(len(o.new_token_ids) for o in outs)
        for o in outs:
            first.setdefault(o.request_id, now)
            last[o.request_id] = now
    reqs = [eng.requests.pop(r) for r in rids]
    after = sum(len(r.output_token_ids) - 1 for r in reqs)
    span = max(last.values()) - min(first.values())
    return reqs, {"decode_tok_per_s": tokens / t_decode if t_decode else None,
                  "span_tok_per_s": after / span if span > 0 else None,
                  "mean_ttft_ms": sum(ttft_ms(r) for r in reqs) / len(reqs)}


def phase_server(results) -> dict:
    """The top of the main path: the main phase's seed-0 weights written as
    a two-shard bf16 HF checkpoint and loaded back (bit-equal), then served
    by an in-process ``OpenAIServer`` over ``Engine(checkpoint_dir=...)``:
    (a) four greedy completions one at a time (two plain, two streamed),
    each equal to a twin engine's ``generate`` of it alone; (b) eight
    concurrent streams, a chat request and a prefix hit of a served
    1,024-token prompt (the chunk route); (c) a top_p request's 200, a
    streamed chat with logprobs, best_of 3, a bad schema's 400,
    /v1/models, /metrics, then a response_format json_schema and a
    guided_choice request, each full and streamed (the same text, a
    document of its spec), and /metrics' three guided counters; (d) the
    three kernels' launches against the steps.  The first prompt and its
    tokens go on to phase provision, whose deploy command serves it."""
    import gc
    import threading
    from pathlib import Path
    import torch
    from tpuserve_torch.models.weights import load_hf_checkpoint
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig, SamplingParams
    from tpuserve_torch.server import OpenAIServer, ServerConfig

    root = Path(__file__).resolve().parent
    ckpt = root / "build" / "server_ckpt"
    model = "Qwen/Qwen3-0.6B"
    params = results["main"]["params"]
    cfg = results["main"]["engine"].model_cfg
    L = cfg.num_layers
    out = {"free_gb_at_start": torch.cuda.mem_get_info()[0] / 1e9}
    t0 = time.perf_counter()
    nbytes_ = write_hf_checkpoint(params, cfg, ckpt)
    out["checkpoint"] = {"bytes": nbytes_, "files": sorted(p.name for p in ckpt.iterdir()),
                         "write_s": time.perf_counter() - t0}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = load_hf_checkpoint(cfg, str(ckpt), "cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]
    pairs = list(zip(leaves(loaded), leaves(params)))
    bit_equal = (len(leaves(loaded)) == len(leaves(params))
                 and all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs))
    out["checkpoint"].update(load_s=load_s, load_gb_per_s=nbytes_ / load_s / 1e9,
                             bit_equal=bit_equal)
    del loaded, pairs

    ecfg = EngineConfig(model=model, checkpoint_dir=str(ckpt),
                        cache=CacheConfig(**SERVER_CACHE))
    eng = Engine(ecfg)
    srv = OpenAIServer(eng, ServerConfig(host="127.0.0.1", port=0))
    t0 = time.perf_counter()
    url = f"http://127.0.0.1:{srv.start(warmup=True)}"
    out["start_s"] = time.perf_counter() - t0
    out["tokenizer"] = type(eng.tokenizer).__name__
    # a tap on the runner's routing: the token ids of non-streamed requests,
    # which the HTTP response does not carry
    served: dict[str, list] = {}
    route = srv.runner._route_outputs

    def tap(outputs):
        for o in outputs:
            served.setdefault(o.request_id, []).extend(o.new_token_ids)
        route(outputs)
    srv.runner._route_outputs = tap
    rng = np.random.default_rng(SEED + 11)
    V = cfg.vocab_size
    one = prompts(rng, SERVER_ONE_LENGTHS, V)
    conc = prompts(rng, MAIN_LENGTHS, V)
    hit = one[-1] + prompts(rng, [64], V)[0]
    base = {"model": model, "max_tokens": SERVER_TOKENS, "temperature": 0,
            "ignore_eos": True}
    st = eng.stats
    before = (st.num_prefill_steps, st.num_chunk_steps, st.num_decode_steps)
    reset_launches()
    try:
        # (a) one at a time
        http_tokens, a_ok = [], True
        for i, p in enumerate(one):
            if i < 2:
                known = set(served)
                status, body = http(url + "/v1/completions", dict(base, prompt=p))
                new = [r for r in served if r not in known]
                ids = served[new[0]] if len(new) == 1 else []
                a_ok &= (status == 200 and body["usage"]["completion_tokens"] == SERVER_TOKENS
                         and body["choices"][0]["finish_reason"] == "length")
            else:
                res = sse(url + "/v1/completions", dict(base, prompt=p, return_token_ids=True,
                                                        stream_options={"include_usage": True}))
                ids = stream_ids(res)
                a_ok &= stream_ok(res, url, len(p))
            http_tokens.append(ids)
        # (b) eight concurrent streams, a chat request and a prefix hit
        chunks0 = st.num_chunk_steps
        conc_res: dict = {}
        opts = dict(base, return_token_ids=True, stream_options={"include_usage": True})

        def run(key, fn):
            conc_res[key] = fn()
        jobs = [(i, lambda p=p: sse(url + "/v1/completions", dict(opts, prompt=p)))
                for i, p in enumerate(conc)]
        jobs.append(("chat", lambda: http(url + "/v1/chat/completions", dict(
            base, messages=[{"role": "user", "content": "Say something long."}]))))
        # the prefix hit first: the scheduler routes a hit to the chunk
        # path only from the head of the queue; the rest arrive while its
        # chunk runs or it decodes
        threads = [threading.Thread(target=run, args=("hit", lambda: sse(
            url + "/v1/completions", dict(opts, prompt=hit))))]
        threads[0].start()
        t_wait = time.perf_counter() + 60
        while st.num_chunk_steps == chunks0 and time.perf_counter() < t_wait:
            time.sleep(0.001)
        threads += [threading.Thread(target=run, args=j) for j in jobs]
        for t in threads[1:]:
            t.start()
        for t in threads:
            t.join(timeout=600)
        streams = [conc_res[i] for i in range(len(conc))]
        chat_status, chat = conc_res["chat"]
        b_ok = (all(stream_ok(r, url, len(p)) for r, p in zip(streams, conc))
                and stream_ok(conc_res["hit"], url, len(hit))
                and chat_status == 200 and chat["choices"][0]["finish_reason"] == "length"
                and chat["usage"]["completion_tokens"] == SERVER_TOKENS
                and st.num_chunk_steps > chunks0)
        rates = stream_rates(streams)
        # (c) the sampler's options: top_p, a streamed chat with
        # logprobs, best_of 3; a bad schema's 400; /v1/models, /metrics;
        # then guided requests and the guided counters
        sampled = dict(base, prompt=one[0], temperature=0.8, seed=5)
        top_p = http(url + "/v1/completions", dict(sampled, top_p=0.9))
        chat_lp = sse(url + "/v1/chat/completions", dict(
            base, messages=[{"role": "user", "content": "Say something long."}],
            logprobs=True, top_logprobs=5))
        best_of = http(url + "/v1/completions", dict(sampled, best_of=3))
        bad_rf = {"type": "json_schema", "json_schema": {"name": "x", "schema": {
            "type": "object", "patternProperties": {}}}}
        bad = [http(url + "/v1/completions", dict(base, prompt=one[0], response_format=bad_rf)),
               (lambda r: (r["status"], json.loads(r.get("error") or "null")))(
                   sse(url + "/v1/completions", dict(base, prompt=one[0],
                                                     response_format=bad_rf)))]
        _, models = http(url + "/v1/models")
        _, metrics = http(url + "/metrics")
        gen_line = [ln for ln in metrics.splitlines()
                    if ln.startswith("vllm_generation_tokens_total{")]
        gen = float(gen_line[0].split()[-1]) if gen_line else None
        # one at a time, concurrent, the hit, the chat; top_p, the
        # logprobs chat and best_of's three candidates
        served_tokens = SERVER_TOKENS * (len(one) + len(conc) + 2 + 2 + 3)
        lp_entries = [e for c in chat_lp["chunks"] for ch in c["choices"]
                      if "logprobs" in ch for e in ch["logprobs"]["content"]]
        sampler_ok = {
            "top_p_200": top_p[0] == 200
            and top_p[1]["usage"]["completion_tokens"] == SERVER_TOKENS,
            "chat_logprobs": chat_lp.get("status") == 200 and chat_lp["done"]
            and len(lp_entries) == SERVER_TOKENS
            and all(len(e["top_logprobs"]) == 5 and e["logprob"] <= 0 for e in lp_entries),
            "best_of_3": best_of[0] == 200 and len(best_of[1]["choices"]) == 1
            and best_of[1]["usage"]["completion_tokens"] == 3 * SERVER_TOKENS
            and "logprobs" not in best_of[1]["choices"][0],
            "bad_schema_400": all(s == 400 and e["error"]["message"].startswith(
                "unsupported json_schema") for s, e in bad)}
        # guided: a response_format json_schema and a guided_choice request,
        # each full and streamed, every one a document of its spec
        guided = {}
        rf = {"type": "json_schema", "json_schema": {"name": "pet", "schema": GUIDED_SCHEMA}}
        choices = ["alpha", "beta", "gamma"]
        for name, extra, mode, spec in (
                ("json_schema", {"response_format": rf}, "json_schema",
                 json.dumps(GUIDED_SCHEMA)),
                ("guided_choice", {"guided_choice": choices}, "choice", json.dumps(choices))):
            body = dict(base, prompt=one[1], ignore_eos=False, **extra)
            status, full = http(url + "/v1/completions", body)
            text, reason = full["choices"][0]["text"], full["choices"][0]["finish_reason"]
            streamed = sse(url + "/v1/completions", body)
            s_text = "".join(ch["text"] for c in streamed["chunks"] for ch in c["choices"])
            s_reason = streamed["chunks"][-1]["choices"][0]["finish_reason"]
            guided[name] = {
                "text": text, "finish_reason": reason,
                "ok": status == 200 and streamed.get("status") == 200 and streamed["done"]
                and (s_text, s_reason) == (text, reason)
                and guided_valid(mode, spec, text, reason == "stop")}
        _, metrics2 = http(url + "/metrics")
        guided["counters"] = {ln.split("{")[0]: float(ln.split()[-1])
                              for ln in metrics2.splitlines()
                              if ln.startswith("tpuserve_guided_")}
        guided_ok = (all(v["ok"] for k, v in guided.items() if k != "counters")
                     and len(guided["counters"]) == 3
                     and guided["counters"].get("tpuserve_guided_fsm_requests_total", 0) >= 4)
        c_ok = (all(sampler_ok.values()) and [m["id"] for m in models["data"]] == [model]
                and gen == served_tokens and guided_ok)
    finally:
        srv.shutdown()
    # (d) the kernels' launches against the engine's steps
    launches = read_launches()
    steps = {"prefill_steps": (st.num_prefill_steps - before[0])
             - (st.num_chunk_steps - before[1]),
             "chunk_steps": st.num_chunk_steps - before[1],
             "decode_steps": st.num_decode_steps - before[2]}
    want = {"flash_prefill": L * steps["prefill_steps"],
            "paged_decode": L * steps["decode_steps"],
            "paged_window": L * steps["chunk_steps"], "ragged_paged": 0}
    d_ok = (launches == want and all(launches[k] > 0 for k in
                                     ("flash_prefill", "paged_decode", "paged_window")))

    # the twin: the same EngineConfig and the loaded parameters
    twin = Engine(ecfg, params=eng.params)
    twin.warmup()
    greedy = SamplingParams(max_tokens=SERVER_TOKENS, temperature=0.0, ignore_eos=True)
    twin_one = [twin.generate([p], greedy)[0].output_token_ids for p in one]
    twin_conc, twin_rates = serve_steps(twin, conc, greedy)
    same_one = twin_one == http_tokens
    same_conc = [stream_ids(r) == t.output_token_ids for r, t in zip(streams, twin_conc)]
    del srv, eng, twin, params
    gc.collect()
    torch.cuda.empty_cache()

    ok = bit_equal and a_ok and same_one and b_ok and c_ok and d_ok
    return {"ok": ok, **out, "model": model, "layers": L, "cache": SERVER_CACHE,
            "one_at_a_time": {"prompt_lens": SERVER_ONE_LENGTHS, "well_formed": a_ok,
                              "same_as_twin": same_one},
            "concurrent": {"prompt_lens": MAIN_LENGTHS, "hit_prompt_len": len(hit),
                           "well_formed": b_ok, "http": rates, "twin": twin_rates,
                           "same_as_twin_share": sum(same_conc) / len(same_conc)},
            "sampler_options": sampler_ok, "guided": guided,
            "metrics_generation_tokens": gen,
            "served_tokens": served_tokens, "launches": launches, "launches_expected": want,
            **steps,
            # the CLI as a deploy starts it serves this prompt in phase provision
            "cli_reference": {"prompt": one[0], "tokens": http_tokens[0]}}


# --------------------------------------------------------------------------
# provision phase

PROVISION_PRESET = "qwen3-0.6b-h100"
PROVISION_PROFILE_S = 2.0          # the /debug/profile capture around the smoke
PROVISION_KERNELS = ("flash_prefill", "paged_decode")
PROVISION_TRACE = {"flash_prefill": "flash_prefill_bf16", "paged_decode": "paged_decode_kernel"}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rendered_container(obj: dict) -> tuple:
    """(container, pod spec) of a rendered Deployment."""
    pod = obj["spec"]["template"]["spec"]
    return pod["containers"][0], pod


def provision_command(command: list, models_root: str, **flags) -> list:
    """A rendered command to run here: ``python`` as this interpreter, each
    flag of ``flags`` (``--checkpoint-dir``, ``--port``, ``--backend``) set
    to its value, and every ``/models`` path under ``models_root``."""
    assert command[0] == "python", command
    cmd = [sys.executable] + list(command[1:])
    for flag, value in flags.items():
        flag = "--" + flag.replace("_", "-")
        i = cmd.index(flag)
        cmd[i + 1] = str(value)
    return [models_root + a[len("/models"):] if a.startswith("/models") else a for a in cmd]


def wait_ready(url: str, proc, budget_s: float, t0: float) -> dict:
    """Poll ``/healthz`` and ``/readyz`` until ready, the process exits, or
    twice the budget passes: the seconds from ``t0`` at which each first
    answered 200."""
    import urllib.error
    out = {"healthz_s": None, "readyz_s": None}
    while time.perf_counter() - t0 < 2 * budget_s and proc.poll() is None:
        for key, path in (("healthz_s", "/healthz"), ("readyz_s", "/readyz")):
            if out[key] is None:
                try:
                    if http(url + path, timeout=5)[0] == 200:
                        out[key] = time.perf_counter() - t0
                except (urllib.error.URLError, OSError):
                    pass
        if out["readyz_s"] is not None:
            break
        time.sleep(0.25)
    return out


def wait_backend_healthy(gw_url: str, limit_s: float, t0: float) -> float | None:
    """Seconds from ``t0`` until the gateway holds every backend healthy."""
    while time.perf_counter() - t0 < limit_s:
        status, body = http(gw_url + "/gateway/status")
        if status == 200 and all(b["healthy"] for b in body["backends"]):
            return time.perf_counter() - t0
        time.sleep(0.25)
    return None


def stop_process(proc, grace_s: float) -> dict:
    """SIGTERM, then the exit code and seconds to exit (killed past the
    grace period)."""
    import signal
    t = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=grace_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    return {"rc": rc, "exit_s": time.perf_counter() - t, "grace_s": grace_s}


def provision_manifests() -> dict:
    """(a) Every preset's manifests as dicts, on gke and on local, through
    the port's validator: the object count; a failure raises."""
    from tpuserve_torch.provision import config as pconfig, e2e, validate
    counts = {}
    for name in pconfig.PRESETS:
        for provider in ("gke", "local"):
            cfg = pconfig.load_config(preset=name, provider=provider, project="chip-smoke")
            counts[f"{name}/{provider}"] = validate.validate_all(e2e.all_manifests(cfg))
    return {"objects": sum(counts.values()), "configs": len(counts), "by_config": counts}


def engine_read_families() -> dict:
    """The families the port's VERIFY_QUERIES, alert rules and dashboard
    read from the engine's ``/metrics``."""
    from urllib.parse import unquote
    from tpuserve_torch.provision import alerts, dashboard, observability
    verify = [unquote(p.split("query=", 1)[1]) for _, p, _ in observability.VERIFY_QUERIES
              if "query=" in p]
    rules = [r["expr"] for g in alerts.prometheus_rule()["spec"]["groups"] for r in g["rules"]]
    return {"verify": alerts.engine_families(verify), "alerts": alerts.engine_families(rules),
            "dashboard": alerts.engine_families(dashboard.exprs()),
            "exported": {m.family: m.exported for m in alerts.registry()}}


def phase_provision(results) -> dict:
    """The provisioner's path on the card: (a) every preset's manifests
    through the port's validator; (b) the engine container of
    ``qwen3-0.6b-h100`` on gke as rendered (command, literal env, probes,
    its one ``nvidia.com/gpu``, the grace period); (c) that command run as a
    subprocess on the server phase's seed-0 Qwen3-0.6B checkpoint (full
    width and depth, bf16), only ``--checkpoint-dir``, ``--port`` and the
    ``/models`` root changed, ``CUDA_VISIBLE_DEVICES`` the card the limit
    asks for; (d) the rendered gateway command in front of it; (e) ready
    within the rendered liveness budget, the port's
    ``smoke.run_local_smoke_tests`` through the gateway inside a
    ``/debug/profile`` capture whose trace names B1's and B2's kernels,
    every family the port's queries, alerts and dashboard read from the
    engine on its ``/metrics``, and both processes out with 0 on SIGTERM
    within their grace periods."""
    import tempfile
    import threading
    from pathlib import Path
    from tpuserve_torch.provision import config as pconfig, manifests, smoke
    from tpuserve_torch.provision.validate import GPU_RESOURCE

    root = Path(__file__).resolve().parent
    ckpt = root / "build" / "server_ckpt"
    out = {"ok": False, "preset": PROVISION_PRESET}

    # (b) the rendered engine and gateway containers
    cfg = pconfig.load_config(preset=PROVISION_PRESET, project="chip-smoke")
    objs = {(o["kind"], o["metadata"]["name"]): o for o in manifests.serving_manifests(cfg)}
    eng_c, eng_pod = rendered_container(objs[("Deployment", "tpuserve-engine")])
    gw_c, gw_pod = rendered_container(objs[("Deployment", "tpuserve-gateway")])
    gpus = int(eng_c["resources"]["limits"][GPU_RESOURCE])
    live = eng_c["livenessProbe"]
    budget = live["initialDelaySeconds"] + live["periodSeconds"] * live.get("failureThreshold", 3)
    # K8s runs the preStop hook inside the grace period, before SIGTERM
    pre_stop = float(eng_c["lifecycle"]["preStop"]["exec"]["command"][1])
    eng_grace = eng_pod["terminationGracePeriodSeconds"] - pre_stop
    gw_grace = gw_pod.get("terminationGracePeriodSeconds", 30)
    model = cfg.model
    out["rendered"] = {"engine_command": eng_c["command"], "gateway_command": gw_c["command"],
                       "env": {e["name"]: e["value"] for e in eng_c["env"] if "value" in e},
                       "gpus": gpus, "liveness_budget_s": budget,
                       "engine_grace_s": eng_grace, "gateway_grace_s": gw_grace}
    if gpus != 1:
        out["error"] = f"the engine asks for {gpus} cards, not 1"
        return out

    # (c) the engine command on the card, (d) the gateway command before it
    models_root = tempfile.mkdtemp(prefix="provision_models_", dir=root / "build")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=",".join(map(str, range(gpus))),
               **out["rendered"]["env"])
    env = {k: (models_root + v[len("/models"):] if v.startswith("/models") else v)
           for k, v in env.items()}
    eng_port, gw_port = free_port(), free_port()
    eng_cmd = provision_command(eng_c["command"], models_root,
                                checkpoint_dir=ckpt, port=eng_port)
    eng_url = f"http://127.0.0.1:{eng_port}"
    gw_cmd = provision_command(gw_c["command"], models_root, port=gw_port, backend=eng_url)
    gw_url = f"http://127.0.0.1:{gw_port}"
    out["run"] = {"engine_command": eng_cmd, "gateway_command": gw_cmd,
                  "cuda_visible_devices": env["CUDA_VISIBLE_DEVICES"]}
    logs = {name: open(root / "build" / f"provision_{name}.log", "w")
            for name in ("engine", "gateway")}
    procs = {}
    try:
        t_start = time.perf_counter()
        procs["engine"] = subprocess.Popen(eng_cmd, cwd=root, env=env, stdout=logs["engine"],
                                           stderr=subprocess.STDOUT)
        # (a) while the engine boots
        t0 = time.perf_counter()
        out["manifests"] = provision_manifests()
        out["manifests"]["seconds"] = time.perf_counter() - t0
        ready = wait_ready(eng_url, procs["engine"], budget, t_start)
        out["start"] = {**ready, "liveness_budget_s": budget,
                        "within_budget": ready["readyz_s"] is not None
                        and ready["readyz_s"] <= budget}
        if ready["readyz_s"] is None:
            out["error"] = "the engine never answered /readyz"
            return out
        # the process's first capture initialises the profiler, which holds
        # the engine for seconds: done while the gateway starts (its imports
        # take as long), before any traffic; should its health probes have
        # caught the hold, the smoke waits for the engine's readmission
        t_gw = time.perf_counter()
        procs["gateway"] = subprocess.Popen(gw_cmd, cwd=root, env=env, stdout=logs["gateway"],
                                            stderr=subprocess.STDOUT)
        first = http(eng_url + "/debug/profile?seconds=0.1", {}, method="POST")[0]
        out["profiler_init"] = {"status": first, "seconds": time.perf_counter() - t_gw}
        gw_ready = wait_ready(gw_url, procs["gateway"], 30.0, t_gw)
        out["gateway_start_s"] = gw_ready["healthz_s"]
        if gw_ready["healthz_s"] is None:
            out["error"] = "the gateway never answered /healthz"
            return out
        out["backend_healthy_s"] = wait_backend_healthy(gw_url, 30.0, t_gw)

        # (e) the smoke tests through the gateway inside a profile capture,
        # before the gateway's canary sends its first round (an interval
        # after it starts): the window holds the smoke's requests alone
        _, before = http(eng_url + "/metrics")
        got = {}

        def capture():
            got["capture"] = http(eng_url + f"/debug/profile?seconds={PROVISION_PROFILE_S}",
                                  {}, method="POST")
        t_cap = time.perf_counter()
        th = threading.Thread(target=capture)
        th.start()
        time.sleep(0.5)           # the capture starts on the loop thread first
        t_smoke = time.perf_counter()
        try:
            res = smoke.run_local_smoke_tests(gw_url, model)
            smoke_ok, smoke_err = True, None
        except smoke.SmokeTestFailure as e:
            res, smoke_ok, smoke_err = {}, False, str(e)
        smoke_s = time.perf_counter() - t_smoke
        smoke_end = time.perf_counter() - t_cap
        _, during = http(eng_url + "/metrics")
        th.join()
        status, cap = got["capture"]
        events = {}
        if status == 200:
            named = trace_kernels(cap["trace"])
            events = {k: named[PROVISION_TRACE[k]] for k in PROVISION_KERNELS}
        completion = json.loads(res["completion"]) if smoke_ok else {}
        canary_in_window = (metric_sum(during, "tpuserve_canary_requests_total")
                            - metric_sum(before, "tpuserve_canary_requests_total"))
        out["smoke"] = {"ok": smoke_ok, "error": smoke_err, "seconds": smoke_s,
                        # done inside the window (its start lagging the request
                        # by at most half a second; the trace's events of the
                        # prefill and every decode step say it did), with no
                        # canary request in it
                        "within_capture": smoke_end < PROVISION_PROFILE_S - 0.5,
                        "canary_requests_in_window": canary_in_window,
                        "models_names_model": smoke_ok and model in res["models"],
                        "completion_tokens": completion.get("usage", {}).get(
                            "completion_tokens"),
                        "text_chars": len(completion["choices"][0]["text"]) if smoke_ok else None}
        out["profile"] = {"status": status, "trace_kernel_events": events}
        out["launches"] = events

        # the engine's /metrics against what the queries, alerts and dashboard read
        _, metrics = http(eng_url + "/metrics")
        reads = engine_read_families()
        exported = reads.pop("exported")
        missing = {k: sorted(f for f in fams if f"# TYPE {exported[f]} " not in metrics)
                   for k, fams in reads.items()}
        out["metrics"] = {"families_read": {k: len(v) for k, v in reads.items()},
                          "missing": missing,
                          "smoke_requests": metric_sum(during, "vllm_request_total")
                          - metric_sum(before, "vllm_request_total")}
        # the CLI's greedy stream of the server phase's first prompt against
        # the in-process server's (the same engine config and checkpoint)
        ref = results["server"]["cli_reference"]
        res = sse(eng_url + "/v1/completions", {
            "model": model, "prompt": ref["prompt"], "max_tokens": len(ref["tokens"]),
            "temperature": 0, "ignore_eos": True, "return_token_ids": True})
        out["cli_stream"] = {"status": res.get("status"), "done": bool(res.get("done")),
                             "same_as_in_process": stream_ids(res) == ref["tokens"]}
        # SIGTERM to both at once, as a rollout sends it; the engine drains
        # within its --drain-timeout, inside the rendered grace period
        drain = float(eng_c["command"][eng_c["command"].index("--drain-timeout") + 1])
        stops = {}
        ths = [threading.Thread(target=lambda n=n, g=g: stops.__setitem__(
            n, stop_process(procs[n], g))) for n, g in (("gateway", gw_grace),
                                                        ("engine", min(eng_grace, drain)))]
        for th_ in ths:
            th_.start()
        for th_ in ths:
            th_.join()
        procs.clear()
        out["stop"] = stops
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
        for f in logs.values():
            f.close()
        shutil.rmtree(models_root, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else None
    out["ok"] = (out["manifests"]["objects"] > 0 and out["start"]["within_budget"]
                 and out["backend_healthy_s"] is not None
                 and out["smoke"]["ok"] and out["smoke"]["models_names_model"]
                 and out["smoke"]["within_capture"]
                 and out["smoke"]["canary_requests_in_window"] == 0
                 and all(events.get(k, 0) > 0 for k in PROVISION_KERNELS)
                 and not any(out["metrics"]["missing"].values())
                 and out["cli_stream"]["done"] and out["cli_stream"]["same_as_in_process"]
                 and all(s["rc"] == 0 and s["exit_s"] <= s["grace_s"]
                         for s in out["stop"].values()))
    return out


# --------------------------------------------------------------------------
# slo and salvage phases

# the overload burst: (class, requests), sent in this order
SLO_BURST = (("batch", 64), ("standard", 24), ("interactive", 8))
SLO_PROMPT, SLO_TOKENS = 512, 128
SLO_GAP_S = 0.010                 # between the burst's sends
# (a): the batch stream's and the interactive request's prompts, the batch
# stream's tokens, and the tokens it holds when the interactive one arrives
SLO_PREEMPT_LENGTHS, SLO_PREEMPT_TOKENS, SLO_PREEMPT_AT = [512, 256], 256, 40
SALVAGE_TOKENS, SALVAGE_POISON_LENGTH = 128, 256
# the salvage phase's caches: 9 streams of up to 1,152 tokens need 324
SALVAGE_BLOCKS = 512


def fp32_main(layers: int = 0):
    """The main weights' seed drawn in float32 at full width and depth
    (``layers``: at that depth), with TF32 off: the dtype in which a re-prefill reproduces decode's
    tokens on the card (bf16 prefill and decode round differently, so a
    re-prefilled bf16 stream drifts from its uninterrupted twin after some
    tokens).  (params, config)."""
    import torch
    from tpuserve_torch.models.config import get_model_config
    from tpuserve_torch.models.weights import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_model_config("Qwen/Qwen3-0.6B"), dtype="float32",
                              num_layers=layers or get_model_config("Qwen/Qwen3-0.6B").num_layers)
    return init_params(cfg, SEED, "cuda"), cfg


def feature_model(results):
    """The main weights cut to FEATURE_LAYERS layers and their config."""
    return cut_depth(results["main"]["params"], results["main"]["engine"].model_cfg,
                     FEATURE_LAYERS)


def feature_engines(results) -> dict:
    """The main path's two engines on ``feature_model``, made once, as the
    main phase makes its own: the default engine (graphs, pipelined) with
    ``Engine.warmup``'s executables and then every one its scheduler can
    make, captured; the eager, synchronous one, warmed."""
    if "feature" not in results:
        import torch
        from tpuserve_torch.runtime import Engine, EngineConfig
        params, cfg = feature_model(results)
        t = time.perf_counter()
        eng = Engine(EngineConfig(seed=SEED), params=params, model_cfg=cfg)
        eng.warmup()
        eng.graphs.warmup(eng._step_keys(eng.scheduler.cfg, eng.max_seq_len))
        eager = Engine(EngineConfig(seed=SEED, cuda_graphs=False, pipeline_decode=False),
                       params=params, model_cfg=cfg)
        eager.warmup()
        torch.cuda.synchronize()
        results["feature"] = {"engine": eng, "eager_engine": eager, "params": params,
                              "made_s": time.perf_counter() - t}
    return results["feature"]


def first_diff(a: list, b: list):
    """The first index where two token streams differ, None if equal."""
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    return i if i is not None or len(a) == len(b) else min(len(a), len(b))


def stat_marks(eng) -> tuple:
    st = eng.stats
    return (st.num_prefill_steps, st.num_chunk_steps, st.num_decode_steps, st.num_mixed_steps)


def launches_since(eng, before: tuple) -> dict:
    """Each kernel's launches the steps since ``before`` (``stat_marks``)
    must have made: one a layer a batched prefill, decode token step,
    chunk step and mixed step."""
    d = [a - b for a, b in zip(stat_marks(eng), before)]
    L = eng.model_cfg.num_layers
    return {"flash_prefill": L * (d[0] - d[1] - d[3]), "paged_decode": L * d[2],
            "paged_window": L * d[1], "ragged_paged": L * d[3]}


def percentile(xs: list, q: float):
    return float(np.percentile(xs, q)) if xs else None


def slo_engine(params, cfg, num_blocks: int = 2048, **sched):
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig, SchedulerConfig
    dtype = cfg.dtype if cfg is not None else "bfloat16"
    return Engine(EngineConfig(seed=SEED, cache=CacheConfig(num_blocks=num_blocks, dtype=dtype),
                               scheduler=SchedulerConfig(**sched)),
                  params=params, model_cfg=cfg)


def slo_preempt(params, cfg, ps) -> dict:
    """A batch stream of 256 tokens on a max_num_seqs=1 engine, an
    interactive request arriving once it has 40: the interactive one must
    finish first (a class preemption), and the batch stream resumes by
    re-prefill; its tokens against a twin's uninterrupted run."""
    from tpuserve_torch.runtime import SamplingParams
    batch = SamplingParams(max_tokens=SLO_PREEMPT_TOKENS, temperature=0.0, ignore_eos=True,
                           slo_class="batch")
    vip = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True,
                         slo_class="interactive")
    twin = slo_engine(params, cfg, num_blocks=256, max_num_seqs=1)
    ref = twin.generate([ps[0]], batch)[0].output_token_ids
    del twin
    eng = slo_engine(params, cfg, num_blocks=256, max_num_seqs=1)
    reset_launches()
    marks = stat_marks(eng)
    rb = eng.add_request(prompt_token_ids=ps[0], params=batch, request_id="batch-0")
    while len(eng.requests[rb].output_token_ids) < SLO_PREEMPT_AT:
        eng.step()
    at = len(eng.requests[rb].output_token_ids)
    ri = eng.add_request(prompt_token_ids=ps[1], params=vip, request_id="interactive-0")
    order = []
    t = time.perf_counter()
    while eng.has_work():
        order += [o.request_id for o in eng.step() if o.finished]
    wall = time.perf_counter() - t
    launches, want = read_launches(), launches_since(eng, marks)
    got = eng.requests[rb].output_token_ids
    fd = first_diff(got, ref)
    out = {"dtype": eng.model_cfg.dtype, "preempted_at_tokens": at, "finish_order": order,
           "slo_preemptions": eng.stats.slo_preemptions, "equal_to_twin": got == ref,
           "first_diff": fd, "agree_share": sum(a == b for a, b in zip(got, ref)) / len(ref),
           "vip_ms": 1e3 * (eng.requests[ri].finish_time - eng.requests[ri].arrival_time),
           "wall_s": wall, "launches": launches, "launches_ok": launches == want,
           "chunk_steps": eng.stats.num_chunk_steps}
    out["ok"] = bool(order == [ri, rb] and eng.stats.slo_preemptions >= 1
                     and len(got) == SLO_PREEMPT_TOKENS and launches == want
                     and (got == ref if cfg is not None else fd is None or fd >= at)
                     and eng.block_manager.num_seqs() == 0)
    del eng
    return out


def slo_request(url: str, prompt: list, cls: str, tokens: int, out: list) -> None:
    """One streamed completion of class ``cls``: its status, Retry-After,
    TTFT on the host clock, tokens, and whether it ended in [DONE]."""
    import http.client
    from urllib.parse import urlparse
    u = urlparse(url)
    res = {"class": cls, "t_send": time.perf_counter(), "tokens": 0, "done": False,
           "error_chunks": 0, "t_first": None}
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=600)
    try:
        conn.request("POST", "/v1/completions", body=json.dumps({
            "prompt": prompt, "max_tokens": tokens, "temperature": 0, "ignore_eos": True,
            "stream": True, "return_token_ids": True, "slo_class": cls}),
            headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        res["status"], res["retry_after"] = r.status, r.getheader("Retry-After")
        if r.status != 200:
            body = r.read().decode()
            res["error_type"] = (json.loads(body or "{}").get("error") or {}).get("type")
        else:
            for line in r:
                line = line.decode().strip()
                if line == "data: [DONE]":
                    res["done"] = True
                elif line.startswith("data: "):
                    chunk = json.loads(line[len("data: "):])
                    if "error" in chunk:
                        res["error_chunks"] += 1
                        continue
                    n = sum(len(ch.get("token_ids", [])) for ch in chunk["choices"])
                    if n and res["t_first"] is None:
                        res["t_first"] = time.perf_counter()
                    res["tokens"] += n
    except Exception as e:                       # a client error is a failed request
        res["exception"] = repr(e)
    finally:
        conn.close()
    out.append(res)


def brownout_level(url: str) -> int:
    _, metrics = http(url + "/metrics")
    for ln in metrics.splitlines():
        if ln.startswith("tpuserve_brownout_level"):
            return int(float(ln.rsplit(" ", 1)[1]))
    raise RuntimeError("no tpuserve_brownout_level on /metrics")


def metric_sum(metrics: str, name: str) -> float:
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in metrics.splitlines()
               if ln.startswith(name + "{") or ln.startswith(name + " "))


def slo_overload(params, V: int) -> dict:
    """An in-process server (max_num_seqs 8, max_waiting 64) takes a burst
    of 96 streams of 512-token prompts and 128 tokens, batch first, then
    standard, then interactive, ``SLO_GAP_S`` apart, while a poller reads
    the brownout level off /metrics; after the drain, one interactive
    request at a time keeps the engine ticking until the level is back at
    0 (ticks run only while the engine steps, as in the JAX engine)."""
    import threading
    from tpuserve_torch.runtime.slo import SloConfig
    from tpuserve_torch.server import OpenAIServer, ServerConfig
    eng = slo_engine(params, None, max_num_seqs=8, max_waiting=64)
    eng.warmup(sample_modes=("greedy",), prefill_buckets=[(b, SLO_PROMPT) for b in (1, 2, 4, 8)])
    # no burn-rate evaluator: the burst's 429s would fire its availability
    # page, whose auto-capture would profile the trickle this phase times
    # (phase services fires and captures one on purpose)
    srv = OpenAIServer(eng, ServerConfig(host="127.0.0.1", port=0, slo_burn=False))
    url = f"http://127.0.0.1:{srv.start()}"
    rng = np.random.default_rng(SEED + 20)
    burst = [(cls, p) for cls, n in SLO_BURST for p in prompts(rng, [SLO_PROMPT] * n, V)]
    levels, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            levels.append((time.perf_counter(), brownout_level(url)))
            stop.wait(0.05)

    results: list = []
    hold = SloConfig().hold_s
    try:
        poller = threading.Thread(target=poll, daemon=True)
        reset_launches()
        marks = stat_marks(eng)
        t0 = time.perf_counter()
        poller.start()
        threads = []
        for cls, p in burst:
            th = threading.Thread(target=slo_request, args=(url, p, cls, SLO_TOKENS, results),
                                  daemon=True)
            th.start()
            threads.append(th)
            time.sleep(SLO_GAP_S)
        _, health = http(url + "/healthz")
        for th in threads:
            th.join(timeout=600)
        t_drained = time.perf_counter()
        launches, want = read_launches(), launches_since(eng, marks)
        time.sleep(0.2)               # the idle loop's gauge update
        _, metrics = http(url + "/metrics")
        level_at_drain = brownout_level(url)
        # the trickle: one interactive request at a time until level 0
        trickle, back_s = [], None
        deadline = t_drained + hold * 4 + 10
        while time.perf_counter() < deadline:
            if brownout_level(url) == 0:
                back_s = time.perf_counter() - t_drained
                break
            slo_request(url, prompts(rng, [64], V)[0], "interactive", 16, trickle)
        stop.set()
        poller.join(timeout=10)
    finally:
        srv.shutdown()
    t_end = time.perf_counter()
    by_class: dict = {}
    ok_terminal = True
    for r in results:
        c = by_class.setdefault(r["class"], {"sent": 0, "complete": 0, "shed_429": 0,
                                             "other": 0, "ttft_ms": []})
        c["sent"] += 1
        if (r.get("status") == 200 and r["done"] and r["tokens"] == SLO_TOKENS
                and not r["error_chunks"]):
            c["complete"] += 1
            c["ttft_ms"].append(1e3 * (r["t_first"] - r["t_send"]))
        elif r.get("status") == 429 and r.get("retry_after") and r.get("error_type") == "overloaded":
            c["shed_429"] += 1
        else:
            c["other"] += 1
            ok_terminal = False
    for c in by_class.values():
        ttft = c.pop("ttft_ms")
        c["ttft_p50_ms"], c["ttft_p99_ms"] = percentile(ttft, 50), percentile(ttft, 99)
    n429 = sum(c["shed_429"] for c in by_class.values())
    shed_metric = metric_sum(metrics, "tpuserve_requests_shed_total")
    # seconds at each level: the poller's samples, each held to the next
    at_level: dict = {}
    for (t, lv), (t2, _) in zip(levels, levels[1:]):
        at_level[lv] = at_level.get(lv, 0.0) + (t2 - t)
    during = [lv for t, lv in levels if t <= t_drained]
    trickle_ok = all(r.get("status") == 200 and r["done"] for r in trickle)
    out = {"requests": len(results), "by_class": by_class, "shed_429": n429,
           "shed_metric": shed_metric, "preempted_metric": metric_sum(
               metrics, "tpuserve_requests_preempted_total"),
           "slo_preemptions": eng.stats.slo_preemptions, "preemptions": eng.stats.preemptions,
           "max_level": max(during, default=0), "level_at_drain": level_at_drain,
           "seconds_at_level": {str(k): v for k, v in sorted(at_level.items())},
           "back_to_0_s_after_drain": back_s, "back_to_0_limit_s": hold * 4 + 10,
           "trickle_requests": len(trickle), "trickle_ok": trickle_ok,
           "healthz_brownout_level": health.get("brownout_level"),
           "burst_s": t_drained - t0, "phase_s": t_end - t0,
           "launches": launches, "launches_ok": launches == want,
           "blocks_left": eng.block_manager.num_seqs()}
    out["ok"] = bool(
        ok_terminal and len(results) == sum(n for _, n in SLO_BURST)
        and by_class.get("interactive", {}).get("shed_429", 1) == 0
        and by_class["interactive"]["complete"] == dict(SLO_BURST)["interactive"]
        and out["max_level"] > 0 and back_s is not None and trickle_ok
        and isinstance(health.get("brownout_level"), int)
        and n429 == shed_metric == eng.stats.requests_shed
        and launches == want and launches["flash_prefill"] > 0 and launches["paged_decode"] > 0
        and eng.block_manager.num_seqs() == 0)
    del srv, eng
    return out


def phase_slo(results) -> dict:
    """SLO classes and the brownout ladder (the repair of ROADMAP F3) at
    full width and depth, greedy, ``TPUSERVE_STRICT_BLOCKS=1``: (a) a
    class preemption on a max_num_seqs=1 engine, in float32 (tokens equal
    to the twin's: gated) and on the bf16 main weights (the twin's tokens
    up to the preemption: gated; after it a reading); (b) the bf16 overload
    burst through an in-process server."""
    import gc
    import os
    import torch
    params = results["main"]["params"]
    V = results["main"]["engine"].model_cfg.vocab_size
    ps = prompts(np.random.default_rng(SEED + 21), SLO_PREEMPT_LENGTHS, V)
    prev = os.environ.get("TPUSERVE_STRICT_BLOCKS")
    os.environ["TPUSERVE_STRICT_BLOCKS"] = "1"
    try:
        torch.cuda.empty_cache()
        fp32_params, fp32_cfg = fp32_main()
        pre32 = slo_preempt(fp32_params, fp32_cfg, ps)
        del fp32_params
        gc.collect()
        torch.cuda.empty_cache()
        pre16 = slo_preempt(params, None, ps)
        overload = slo_overload(params, V)
    finally:
        if prev is None:
            os.environ.pop("TPUSERVE_STRICT_BLOCKS", None)
        else:
            os.environ["TPUSERVE_STRICT_BLOCKS"] = prev
        gc.collect()
        torch.cuda.empty_cache()
    return {"ok": pre32["ok"] and pre16["ok"] and overload["ok"],
            "preempt_fp32": pre32, "preempt_bf16": pre16, "overload": overload,
            "launches": overload["launches"]}


def salvage_engine(params, cfg):
    """The salvage phase's engine: the CLI's defaults (captured graphs,
    32-token windows, pipelined), ``--step-watchdog-s 2``, prefix caching
    off so a run repeats a twin's numerics exactly, warmed for the
    buckets its streams and their re-prefills hit."""
    from tpuserve_torch.runtime import Engine
    from tpuserve_torch.server.openai_api import build_parser, engine_config
    ecfg = engine_config(build_parser().parse_args(
        ["--num-blocks", str(SALVAGE_BLOCKS), "--step-watchdog-s", "2",
         "--kv-cache-dtype", cfg.dtype]))
    ecfg = dataclasses.replace(ecfg, seed=SEED, enable_prefix_caching=False)
    eng = Engine(ecfg, params=params, model_cfg=cfg)
    eng.warmup(sample_modes=("greedy", "penalties"),
               prefill_buckets=[(b, L) for b in (1, 2, 4, 8) for L in (1024, 2048)
                                if b == 1 or (b // 2 + 1) * L <= eng.scheduler.cfg.max_prefill_tokens])
    return eng


def timed_streams(runner, subs) -> dict:
    """Read every submit's queue on its own thread: {rid: (tokens, token
    arrival times, error or None)}."""
    import threading
    got: dict = {}

    def read(rid, q):
        toks, times, err = [], [], None
        while (item := q.get(timeout=600)) is not None:
            if isinstance(item, Exception):
                err = item
                continue
            toks += item.new_token_ids
            times += [time.perf_counter()] * len(item.new_token_ids)
        got[rid] = (toks, times, err)
        runner.engine.requests.pop(rid, None)

    threads = [threading.Thread(target=read, args=s, daemon=True) for s in subs]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    return got


def salvage_watch(eng) -> dict:
    """Record each rule's fire (its time and every request's tokens then)
    and the tokens each salvage re-queues for re-prefill (on the loop
    thread)."""
    rec = {"fires": [], "reprefill_tokens": 0, "salvages": 0}
    hook = eng.flight.fault_hook if eng.flight.enabled else None

    def fired(site, mode, rids):
        rec["fires"].append((time.perf_counter(), {
            rid: len(r.output_token_ids) for rid, r in list(eng.requests.items())}))
        if hook is not None:                  # the FAULT in the flight timelines
            hook(site, mode, rids)
    eng.faults.on_fire = fired
    orig = eng.salvage_requeue

    def salvage():
        rids = orig()
        rec["salvages"] += 1
        rec["reprefill_tokens"] += sum(eng.requests[r].num_tokens for r in rids)
        return rids
    eng.salvage_requeue = salvage
    return rec


def recovery_s(got: dict, rids, fire: tuple) -> list:
    """Seconds from a fire (``salvage_watch``) to each stream's next token
    (the first past the tokens it held then, as its reader received it)."""
    t, held = fire
    return [got[r][1][held.get(r, 0)] - t for r in rids if len(got[r][1]) > held.get(r, 0)]


def token_gate(exact: bool, toks: list, ref: list, before: int) -> bool:
    """float32: the twin's tokens; bf16: the twin's up to ``before`` (the
    tokens emitted before the fault), the whole stream delivered."""
    return toks == ref if exact else (len(toks) == len(ref) and toks[:before] == ref[:before])


def reprefill_logits(eng, seqs: list, follow: list) -> dict:
    """The bf16 witness of a re-prefill on the main path's kernels: each
    row of ``seqs`` is a prompt plus the tokens it held at a fault (what
    the re-prefill runs), and its next-token logits come three ways at
    the engine's weights: the re-prefill on the kernels (flash prefill
    over the whole row in the engine's padded bucket), the same on the
    plain attention, and the twin's decode step on the kernels (a prefill
    of all but the last token, then a paged decode step of it).  The
    kernel re-prefill is held to both at ``LOGIT_DIFF_MAX``; top-1
    agreement, and whether it picks ``follow`` (the token the twin went
    on with, where a greedy row's argmax is the token; else None), are
    read."""
    import torch
    from tpuserve_torch.models import transformer
    from tpuserve_torch.ops.attention import PAD_SLOT
    from tpuserve_torch.runtime.kv_cache import CacheConfig, create_kv_cache
    params, cfg = eng.params, eng.model_cfg
    B, page = len(seqs), CacheConfig.block_size
    lens = [len(q) for q in seqs]
    T = 1 << (max(lens) - 1).bit_length()
    pages = T // page
    bt = torch.arange(B * pages, dtype=torch.int32, device="cuda").reshape(B, pages)
    dev = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")

    def prefill(n: list, impl: str):
        cache = create_kv_cache(cfg, CacheConfig(num_blocks=B * pages, max_blocks_per_seq=pages),
                                "cuda")
        tokens = torch.zeros(B, T, dtype=torch.int32, device="cuda")
        slots = torch.full((B, T), PAD_SLOT, dtype=torch.int32, device="cuda")
        for i, (q, k) in enumerate(zip(seqs, n)):
            tokens[i, :k] = dev(q[:k])
            pos = torch.arange(k, device="cuda")
            slots[i, :k] = (bt[i, pos // page] * page + pos % page).to(torch.int32)
        lg, _ = transformer.prefill(params, cfg, tokens, dev(n), slots, cache, attn_impl=impl)
        return lg, cache

    logits = {impl: prefill(lens, impl)[0] for impl in ("cuda", "reference")}
    _, cache = prefill([k - 1 for k in lens], "cuda")
    pos = dev([k - 1 for k in lens]).long()
    slot = (bt[torch.arange(B, device="cuda"), pos // page] * page + pos % page).to(torch.int32)
    logits["decode"], _ = transformer.decode_step(
        params, cfg, dev([q[k - 1] for q, k in zip(seqs, lens)]), pos.to(torch.int32), slot,
        bt, dev(lens), cache, attn_impl="cuda")
    del cache
    kern, top = logits["cuda"], logits["cuda"].argmax(-1)
    out = {"rows": B, "lengths": lens, "bucket": T}
    for other in ("reference", "decode"):
        out[f"max_logit_diff_{other}"] = (kern - logits[other]).abs().max().item()
        out[f"top1_agreement_{other}"] = (top == logits[other].argmax(-1)).float().mean().item()
    out["next_token_equal"] = [None if f is None else int(t) == f
                               for t, f in zip(top.tolist(), follow)]
    out["logit_diff_max_allowed"] = LOGIT_DIFF_MAX
    out["ok"] = bool(torch.isfinite(kern).all()
                     and out["max_logit_diff_reference"] <= LOGIT_DIFF_MAX
                     and out["max_logit_diff_decode"] <= LOGIT_DIFF_MAX)
    return out


def salvage_poison(eng, exact: bool, ps, poison, metrics=None) -> dict:
    """(a) Eight greedy streams of the main path and one request whose id
    holds "poison", through the runner, under
    ``decode_dispatch:raise:1.0:match=poison``: the poison alone fails,
    isolated by bisection; the eight against the twin's tokens."""
    from tpuserve_torch.runtime import SamplingParams
    from tpuserve_torch.runtime.faults import FaultInjector
    from tpuserve_torch.server.runner import AsyncEngineRunner
    sp = SamplingParams(max_tokens=SALVAGE_TOKENS, temperature=0.0, ignore_eos=True)
    twin = [r.output_token_ids for r in eng.generate(ps, sp)]
    eng.faults = FaultInjector.from_spec("decode_dispatch:raise:1.0:match=poison")
    rec = salvage_watch(eng)
    s0 = dataclasses.replace(eng.stats)
    runner = AsyncEngineRunner(eng, metrics)
    runner.step_watchdog_s = 0.0               # (c) times the watchdog
    runner.start()
    try:
        subs = [runner.submit(prompt_token_ids=p, params=sp, request_id=f"stream-{i}")
                for i, p in enumerate(ps)]
        subs.append(runner.submit(prompt_token_ids=poison, params=sp, request_id="poison-0"))
        got = timed_streams(runner, subs)
    finally:
        runner.shutdown()
        runner._update_gauges()
        del eng.salvage_requeue
        eng.faults = FaultInjector.from_spec(None)
    rids = [s[0] for s in subs[:-1]]
    err = got["poison-0"][2]
    streams = [got[r][0] for r in rids]
    st = eng.stats
    rec_s = recovery_s(got, rids, rec["fires"][0]) if rec["fires"] else []
    out = {"faults": len(rec["fires"]), "salvages": rec["salvages"],
           "reprefill_tokens": rec["reprefill_tokens"],
           "salvaged": st.requests_salvaged - s0.requests_salvaged,
           "poisoned": st.requests_poisoned - s0.requests_poisoned,
           "poison_error": str(err)[:120] if err else None,
           "survivor_errors": sum(got[r][2] is not None for r in rids),
           "equal_to_twin": streams == twin,
           "first_diff": [first_diff(s, t) for s, t in zip(streams, twin)],
           "recovery_s_min": min(rec_s, default=None), "recovery_s_max": max(rec_s, default=None)}
    out["ok"] = bool(err is not None and "poison" in str(err) and out["survivor_errors"] == 0
                     and out["poisoned"] == 1 and out["salvaged"] > 0
                     # bf16: the twin prefills 8 prompts, this run 9 (another
                     # batch shape), so only whole streams are gated there
                     and all(token_gate(exact, s, t, 0) for s, t in zip(streams, twin))
                     and eng.block_manager.num_seqs() == 0)
    return out


def salvage_in_flight(eng, exact: bool, ps, site: str) -> dict:
    """(b) A one-shot fault while a pipelined window is in flight, driven
    step by step, among eight rows a guided json_object row and a
    repetition-penalty row.  A live penalty row makes each dispatch read
    the window first, so at ``decode_dispatch`` the fault is armed once
    it finished (a quarter of the tokens) and meets an unread window; at
    ``window_flush`` it lands on the window holding both rows, armed once
    every row holds an eighth of its tokens.  Every row
    against the twin's tokens; the guided output legal."""
    from tpuserve_torch.runtime import SamplingParams
    from tpuserve_torch.runtime.faults import FaultInjector, InjectedFault
    pen_tokens = SALVAGE_TOKENS // 4 if site == "decode_dispatch" else SALVAGE_TOKENS
    base = dict(temperature=0.0, ignore_eos=True)
    plist = ([SamplingParams(max_tokens=SALVAGE_TOKENS, **base)] * 6
             + [SamplingParams(max_tokens=SALVAGE_TOKENS, guided="json", **base),
                SamplingParams(max_tokens=pen_tokens, repetition_penalty=1.3, **base)])

    def run(inject: bool):
        rids = [eng.add_request(prompt_token_ids=p, params=sp) for p, sp in zip(ps, plist)]
        reqs = [eng.requests[r] for r in rids]
        rec = salvage_watch(eng) if inject else None
        armed, faults, at, in_window = False, 0, None, None
        t_fault = t_next = None
        while eng.has_work():
            pw = eng._pending_window
            if (inject and not armed and pw is not None
                    and (reqs[7].finished if site == "decode_dispatch"
                         else min(len(r.output_token_ids) for r in reqs) >= pen_tokens // 8)):
                eng.faults = FaultInjector.from_spec(f"{site}:raise:1.0:count=1")
                armed, at = True, [len(r.output_token_ids) for r in reqs]
                in_window = [i for i, r in enumerate(reqs) if r in pw.reqs and not r.finished]
            try:
                outs = eng.step()
                if t_fault is not None and t_next is None and outs:
                    t_next = time.perf_counter()
            except InjectedFault:
                faults += 1
                t_fault = time.perf_counter()
                eng.salvage_requeue()
        if inject:
            del eng.salvage_requeue
            eng.faults = FaultInjector.from_spec(None)
        res = [eng.requests.pop(r) for r in rids]
        extra = {"faults": faults, "tokens_at_fault": at, "rows_in_dropped_window": in_window,
                 "reprefill_tokens": rec["reprefill_tokens"] if rec else None,
                 "recovery_s": (t_next - t_fault) if t_next and t_fault else None} if inject else {}
        return res, extra

    twin, _ = run(False)
    got, extra = run(True)
    gtext, greason = got[6].output_text, got[6].finish_reason.value
    legal = guided_valid("json", None, gtext, greason == "stop")
    streams, ref = [r.output_token_ids for r in got], [r.output_token_ids for r in twin]
    at = extra["tokens_at_fault"]
    out = {"site": site, **extra, "equal_to_twin": streams == ref,
           "first_diff": [first_diff(s, t) for s, t in zip(streams, ref)],
           "guided_legal": legal, "guided_finish": greason,
           "guided_fsm_windows": eng.stats.guided_fsm_windows}
    rows = extra["rows_in_dropped_window"] or []
    if not exact:
        # the twin's tokens up to the fault (gated equal), and the one the
        # twin went on with where the row is plain greedy (rows 0-5)
        out["reprefill_witness"] = reprefill_logits(
            eng, [list(p) + t[:a] for p, t, a in zip(ps, ref, at)],
            [t[a] if i < 6 and a < len(t) else None for i, (t, a) in enumerate(zip(ref, at))])
    # the guided row always rides the dropped window; the penalty row only
    # at window_flush (at decode_dispatch it finished before the fault)
    out["ok"] = bool(extra["faults"] == 1 and legal and eng.block_manager.num_seqs() == 0
                     and 6 in rows and (7 in rows) == (site == "window_flush")
                     and all(token_gate(exact, s, t, a) for s, t, a in zip(streams, ref, at))
                     and eng._pending_window is None
                     and out.get("reprefill_witness", {"ok": True})["ok"])
    return out


def salvage_hang(eng, exact: bool, ps, metrics=None) -> dict:
    """(c) Through the runner with the engine's ``--step-watchdog-s 2``:
    a clean run of the eight streams (no trip; enough steps to leave the
    watchdog's warmup); then, past the warmup, buckets the engine meets
    for the first time (a guided choice row beside rows with logprobs and
    a repetition penalty, whose graphs are captured inside the steps: no
    trip and no salvage, the capture seconds read); then the eight
    streams under a one-shot ``decode_dispatch:hang:1.0:count=1``: one
    trip, the hang released into salvage, every stream against the clean
    run's tokens."""
    import json
    from tpuserve_torch.runtime import SamplingParams
    from tpuserve_torch.runtime.faults import FaultInjector
    from tpuserve_torch.server.runner import AsyncEngineRunner
    sp = SamplingParams(max_tokens=SALVAGE_TOKENS, temperature=0.0, ignore_eos=True)
    runner = AsyncEngineRunner(eng, metrics)
    runner.start()
    try:
        clean = {}
        while runner._steps_done < runner.WATCHDOG_WARMUP_STEPS or not clean:
            subs = [runner.submit(prompt_token_ids=p, params=sp) for p in ps]
            got = timed_streams(runner, subs)
            clean = {i: got[s[0]][0] for i, s in enumerate(subs)}
        trips_clean = eng.stats.watchdog_trips
        graphs = eng.graphs
        known, c0, sv0 = set(graphs.executables), graphs.capture_s, eng.stats.requests_salvaged
        fresh = [SamplingParams(max_tokens=16, temperature=0.0, guided="choice",
                                guided_schema=json.dumps(["alpha", "beta", "gamma"]))]
        fresh += [SamplingParams(max_tokens=16, temperature=0.0, ignore_eos=True, logprobs=5,
                                 repetition_penalty=1.3)] * (len(ps) - 1)
        first = timed_streams(runner, [runner.submit(prompt_token_ids=p, params=f)
                                       for p, f in zip(ps, fresh)])
        new = [k for k in graphs.executables if k not in known]
        first_use = {"steps_before": runner.WATCHDOG_WARMUP_STEPS, "new_graphs": len(new),
                     "capture_s": graphs.capture_s - c0,
                     "capture_s_max": max((graphs.executables[k].capture_s for k in new),
                                          default=None),
                     "errors": sum(v[2] is not None for v in first.values()),
                     "salvaged": eng.stats.requests_salvaged - sv0,
                     "trips": eng.stats.watchdog_trips - trips_clean}
        trips0 = eng.stats.watchdog_trips
        eng.faults = FaultInjector.from_spec("decode_dispatch:hang:1.0:count=1")
        rec = salvage_watch(eng)
        subs = [runner.submit(prompt_token_ids=p, params=sp) for p in ps]
        t0 = time.perf_counter()
        got = timed_streams(runner, subs)
        wall = time.perf_counter() - t0
    finally:
        runner.shutdown()
        runner._update_gauges()
        eng.__dict__.pop("salvage_requeue", None)
        eng.faults = FaultInjector.from_spec(None)
    streams = [got[s[0]][0] for s in subs]
    ref = [clean[i] for i in range(len(ps))]
    errors = sum(got[s[0]][2] is not None for s in subs)
    rec_s = recovery_s(got, [s[0] for s in subs], rec["fires"][0]) if rec["fires"] else []
    out = {"watchdog_s": runner.step_watchdog_s, "clean_trips": trips_clean,
           "first_use": first_use,
           "trips": eng.stats.watchdog_trips - trips0, "errors": errors,
           "salvages": rec["salvages"], "reprefill_tokens": rec["reprefill_tokens"],
           "equal_to_clean": streams == ref,
           "first_diff": [first_diff(s, t) for s, t in zip(streams, ref)],
           "hang_to_next_token_s_min": min(rec_s, default=None),
           "hang_to_next_token_s_max": max(rec_s, default=None), "wall_s": wall}
    out["ok"] = bool(trips0 == 0 and out["trips"] == 1 and errors == 0 and rec["salvages"] >= 1
                     and first_use["new_graphs"] > 0 and first_use["errors"] == 0
                     and first_use["salvaged"] == 0
                     and all(token_gate(exact, s, t, 1) for s, t in zip(streams, ref))
                     and eng.block_manager.num_seqs() == 0)
    return out


def phase_salvage(results) -> dict:
    """Crash-only salvage at full width on ``feature_model``'s depth
    (FEATURE_LAYERS layers of the main weights), greedy, on the CLI's
    engine (``--step-watchdog-s 2``; pipelined 32-token windows, captured
    graphs; prefix caching off so runs repeat), under
    ``TPUSERVE_STRICT_BLOCKS=1``: (a) poison, (b) a fault with a window in
    flight at ``decode_dispatch`` and at ``window_flush``, (c) a released
    hang.  Each on the float32 draw of the main weights (tokens equal to
    the twin's: gated) and on the bf16 main weights (delivered tokens and
    terminal states gated; agreement after the fault a reading).  The
    engine's flight recorder writes into a directory of each dtype's own
    (``TPUSERVE_FLIGHT_DIR``): the poison run must leave a
    ``flight-poison-*.json`` naming the poison request, the released hang
    a ``flight-watchdog_trip-*.json``, and the runners'
    ``tpuserve_flight_postmortems_total`` must equal the files."""
    import gc
    import os
    import tempfile
    import torch
    from tpuserve_torch.server.metrics import ServerMetrics
    params, bf16_cfg = feature_model(results)
    V = bf16_cfg.vocab_size
    rng = np.random.default_rng(SEED + 3)
    ps = prompts(rng, MAIN_LENGTHS, V)
    poison = prompts(np.random.default_rng(SEED + 22), [SALVAGE_POISON_LENGTH], V)[0]
    prev = {k: os.environ.get(k) for k in ("TPUSERVE_STRICT_BLOCKS", "TPUSERVE_FLIGHT_DIR")}
    os.environ["TPUSERVE_STRICT_BLOCKS"] = "1"
    out = {}
    try:
        for name in ("fp32", "bf16"):
            gc.collect()
            torch.cuda.empty_cache()
            if name == "fp32":
                p, cfg = fp32_main(FEATURE_LAYERS)
            else:
                p, cfg = params, bf16_cfg
            flight_dir = tempfile.mkdtemp(prefix=f"flight-{name}-")
            os.environ["TPUSERVE_FLIGHT_DIR"] = flight_dir    # read by the recorder
            t = time.perf_counter()
            eng = salvage_engine(p, cfg)
            res = {"warmup_s": time.perf_counter() - t}
            exact = name == "fp32"
            metrics = ServerMetrics("Qwen/Qwen3-0.6B")
            res["poison"] = salvage_poison(eng, exact, ps, poison, metrics)
            for site in ("decode_dispatch", "window_flush"):
                res[f"in_flight_{site}"] = salvage_in_flight(eng, exact, ps, site)
            res["hang"] = salvage_hang(eng, exact, ps, metrics)
            res["postmortems"] = salvage_postmortems(flight_dir, metrics)
            res["ok"] = all(v["ok"] for v in res.values() if isinstance(v, dict))
            out[name] = res
            del eng, p
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        gc.collect()
        torch.cuda.empty_cache()
    return {"ok": out["fp32"]["ok"] and out["bf16"]["ok"], **out}


def salvage_postmortems(flight_dir: str, metrics) -> dict:
    """The salvage runs' post-mortem bundles in ``flight_dir``: a poison
    one naming the poison request with its whole timeline, a watchdog
    trip's, each of schema 2 with its ring markers; the counter equal to
    the files."""
    import glob
    import os
    files = {r: sorted(glob.glob(os.path.join(flight_dir, f"flight-{r}-*.json")))
             for r in ("poison", "watchdog_trip", "fault_storm")}
    total = len(glob.glob(os.path.join(flight_dir, "flight-*.json")))
    counter = metric_sum(metrics.render().decode(), "tpuserve_flight_postmortems_total")
    bundles = {r: [json.load(open(f)) for f in fs] for r, fs in files.items()}
    poison = bundles["poison"][0] if bundles["poison"] else {}
    tl = [e["event"] for e in poison.get("requests", {}).get("poison-0", [])]
    out = {"dir": flight_dir, "files": {r: [os.path.basename(f) for f in fs]
                                        for r, fs in files.items()},
           "counter": counter, "poison_timeline": tl,
           "watchdog_steps": [len(b["steps"]) for b in bundles["watchdog_trip"]]}
    out["ok"] = bool(
        len(files["poison"]) == 1 and len(files["watchdog_trip"]) >= 1
        and not files["fault_storm"] and counter == total
        and tl[:1] == ["QUEUED"] and tl[-1:] == ["FINISHED"] and "SALVAGED" in tl
        and all(b["schema"] == 2 and set(b["rings"]) == {"events", "steps"}
                for bs in bundles.values() for b in bs))
    return out


# --------------------------------------------------------------------------
# the flight phase

FLIGHT_REPEATS = 3                # timed A/B rounds, after one untimed first use
FLIGHT_TOKENS = 64
# every step kind the engine's records can carry
FLIGHT_KINDS = ("idle", "prefill", "prefill_chunk", "mixed", "window", "decode")
FLIGHT_PHASE_SLACK_MS = 0.5       # a record's phases may exceed its wall by this
FLIGHT_TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "current weather of a city",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}},
                   "required": ["city"]}}}]


def host_values(x) -> bool:
    """A ring entry holds str, int, float, bool, None, tuples and dicts of
    those only (no tensor: a value read from the card would be a wait)."""
    if x is None or isinstance(x, (str, int, float, bool)):
        return True
    if isinstance(x, tuple):
        return all(host_values(v) for v in x)
    if isinstance(x, dict):
        return all(isinstance(k, str) and host_values(v) for k, v in x.items())
    return False


def step_split(runs: list) -> dict:
    """Step records of one or more runs (a list of record lists) by kind:
    the count, the median wall ms and the median ms of each host phase (0
    where a record has none); each decode dispatch's tokens a row and each
    prefill's rows; and the time between steps within a run (a record's
    start less the previous record's end: the loop's own time outside
    ``Engine.step``), as a median and a share of the runs' spans."""
    from tpuserve_torch.runtime.hostprof import HostPhaseProfiler
    med = lambda xs: float(np.median(xs)) if xs else None        # noqa: E731
    steps = [s for run in runs for s in run]
    out = {"kinds": {}}
    for kind in sorted({s["kind"] for s in steps}):
        recs = [s for s in steps if s["kind"] == kind]
        out["kinds"][kind] = {"n": len(recs), "ms": med([r["ms"] for r in recs]),
                              **{ph: med([r.get("phase_ms", {}).get(ph, 0.0) for r in recs])
                                 for ph in HostPhaseProfiler.PHASES}}
    # a decode dispatch's tokens a row (the window's size), by count
    sizes = [s["actual_tokens"] // s["rows"] for s in steps
             if s["kind"] in ("window", "decode") and s["rows"]]
    out["decode_steps_a_dispatch"] = {str(k): sizes.count(k) for k in sorted(set(sizes))}
    out["prefill_rows"] = [s["rows"] for s in steps if s["kind"] == "prefill"]
    gaps = [1e3 * (b["t"] - a["t"]) - b["ms"] for run in runs for a, b in zip(run, run[1:])]
    span = sum(1e3 * (run[-1]["t"] - run[0]["t"]) + run[0]["ms"] for run in runs if run)
    out["between_steps_ms_median"] = med(gaps)
    out["between_steps_share"] = sum(gaps) / span if span > 0 else None
    out["steps"] = len(steps)
    return out


def steps_gate(steps: list) -> dict:
    """Every record's kind is one the engine runs and its phases sum to at
    most its wall (+ FLIGHT_PHASE_SLACK_MS)."""
    over = [s for s in steps if sum((s.get("phase_ms") or {}).values())
            > s["ms"] + FLIGHT_PHASE_SLACK_MS]
    kinds = {s["kind"] for s in steps}
    return {"records": len(steps), "over_wall": len(over),
            "worst_over_ms": max((sum(s["phase_ms"].values()) - s["ms"] for s in over),
                                 default=0.0),
            "with_phases": sum(1 for s in steps if s.get("phase_ms")),
            "kinds_known": kinds <= set(FLIGHT_KINDS),
            "ok": bool(steps) and not over and kinds <= set(FLIGHT_KINDS)
            and all(s.get("phase_ms") for s in steps if s["kind"] != "idle")}


def flight_ab(params, ps) -> dict:
    """(a) The main path's 8 prompts, 64 greedy tokens, on two default
    engines (prefix caching off, so every run repeats the first): the
    recorder on and ``flight=False``, interleaved (on/off, off/on, on/off)
    after one untimed run of each.  The process has one host-phase
    profiler: it is on while the recorder's engine runs and off while the
    other one does, as each would be in a process of its own.  Tokens must
    be identical; decode tok/s and TTFT of each and the recorder's cost
    are readings.  (b) The recording engine's step records (its first
    left out: its phases are those since the recorder was made, every
    other engine of the process included): the gates of ``steps_gate``,
    no ring entry other than host values, and the phase split."""
    import torch
    from tpuserve_torch.runtime import Engine, EngineConfig, SamplingParams
    from tpuserve_torch.runtime.hostprof import PROF
    greedy = SamplingParams(max_tokens=FLIGHT_TOKENS, temperature=0.0, ignore_eos=True)
    engines = {}
    for k in ("on", "off"):
        eng = Engine(EngineConfig(seed=SEED, flight=k == "on", enable_prefix_caching=False),
                     params=params)
        eng.warmup(decode_buckets=[8], sample_modes=("greedy",), prefill_buckets=[(8, 1024)])
        engines[k] = eng
    tokens = {k: [] for k in engines}
    timings = {k: [] for k in engines}
    order = [("on", "off")] + [("on", "off") if i % 2 == 0 else ("off", "on")
                               for i in range(FLIGHT_REPEATS)]
    marks = {k: stat_marks(e) for k, e in engines.items()}
    on = engines["on"]
    runs = []                          # the recording engine's timed runs' records
    try:
        for rnd, pair in enumerate(order):
            if rnd == 1:
                reset_launches()
                marks = {k: stat_marks(e) for k, e in engines.items()}
            for k in pair:
                PROF.enabled = k == "on"
                idx = on.flight._steps.idx
                reqs, timing = serve_steps(engines[k], ps, greedy)
                tokens[k].append([r.output_token_ids for r in reqs])
                if rnd:
                    timings[k].append(timing)
                    if k == "on":
                        runs.append(on.flight.steps_snapshot(limit=on.flight._steps.idx - idx))
    finally:
        PROF.enabled = True
    launches = read_launches()
    want = {}
    for k, e in engines.items():
        for name, n in launches_since(e, marks[k]).items():
            want[name] = want.get(name, 0) + n
    med = {k: {m: float(np.median([t[m] for t in timings[k]]))
               for m in ("decode_tok_per_s", "mean_ttft_ms")} for k in engines}
    steps = on.flight.steps_snapshot(limit=10 ** 6)[1:]
    gate = steps_gate(steps)
    ring_host = (all(host_values(e) for e in on.flight._events.snapshot())
                 and all(host_values(s) for s in on.flight._steps.snapshot()))
    same = all(t == tokens["on"][0] for k in engines for t in tokens[k])
    out = {"repeats": FLIGHT_REPEATS, "order": order[1:], "same_tokens": same,
           "decode_tok_per_s": {k: [t["decode_tok_per_s"] for t in timings[k]] for k in engines},
           "mean_ttft_ms": {k: [t["mean_ttft_ms"] for t in timings[k]] for k in engines},
           "median": med,
           "recorder_cost_decode_share": 1 - med["on"]["decode_tok_per_s"]
           / med["off"]["decode_tok_per_s"],
           "recorder_cost_ttft_share": med["on"]["mean_ttft_ms"] / med["off"]["mean_ttft_ms"] - 1,
           "events_recorded": on.flight._events.idx, "off_events": engines["off"].flight._events.idx,
           "steps_gate": gate, "ring_host_values_only": ring_host,
           "split": step_split(runs), "launches": launches, "launches_expected": want}
    out["ok"] = bool(same and gate["ok"] and ring_host and out["off_events"] == 0
                     and launches == want and launches["flash_prefill"] > 0
                     and launches["paged_decode"] > 0)
    del engines, on
    torch.cuda.empty_cache()
    return out


def timeline_ok(events: list, chunked: bool) -> bool:
    """QUEUED, ADMITTED, PREFILL (PREFILL_CHUNK on the chunk route, any
    number), WINDOW... (none when the prefill's token ended it), FINISHED,
    in time order."""
    names = [e["event"] for e in events]
    runs = [n for i, n in enumerate(names) if i == 0 or n != names[i - 1]]
    return (runs[:2] == ["QUEUED", "ADMITTED"] and len(runs) in (4, 5)
            and runs[2] == ("PREFILL_CHUNK" if chunked else runs[2])
            and runs[2] in ("PREFILL", "PREFILL_CHUNK")
            and runs[3:] in (["WINDOW", "FINISHED"], ["FINISHED"])
            and [e["t"] for e in events] == sorted(e["t"] for e in events))


def flight_server(results) -> dict:
    """(c) The CLI's engine on the server phase's checkpoint, the recorder
    writing into a temporary ``TPUSERVE_FLIGHT_DIR``, in an in-process
    server: 8 concurrent streams of the main path's lengths (their step
    records give the HTTP engine's phase split), a prefix hit of one (the
    chunk route), then chat requests with ``tools`` under ``tool_choice``
    auto, required and a named function, each full and streamed.  Gates:
    every tools request 200 with a finish reason of stop, length or
    tool_calls and no streamed content carrying the forced marker; every
    request's ``/debug/requests/{id}`` timeline as ``timeline_ok`` (the hit
    on the chunk route); ``/debug/engine`` with phased steps, SLIs of the
    class and ``cold_start_s`` > 0; ``/healthz`` with ``cold_start_s``;
    ``/debug/engine/dump`` of schema 2 with its ring markers; the HTTP
    engine's records under ``steps_gate``; launches against the steps."""
    import os
    import tempfile
    import threading
    from pathlib import Path
    import torch
    from tpuserve_torch.runtime import Engine
    from tpuserve_torch.server import OpenAIServer, ServerConfig
    from tpuserve_torch.server.openai_api import build_parser, engine_config
    ckpt = Path(__file__).resolve().parent / "build" / "server_ckpt"
    prev = os.environ.get("TPUSERVE_FLIGHT_DIR")
    fdir = tempfile.mkdtemp(prefix="flight-server-")
    os.environ["TPUSERVE_FLIGHT_DIR"] = fdir
    try:
        eng = Engine(engine_config(build_parser().parse_args(
            ["--checkpoint-dir", str(ckpt)])))
    finally:
        if prev is None:
            os.environ.pop("TPUSERVE_FLIGHT_DIR", None)
        else:
            os.environ["TPUSERVE_FLIGHT_DIR"] = prev
    srv = OpenAIServer(eng, ServerConfig(host="127.0.0.1", port=0))
    url = f"http://127.0.0.1:{srv.start(warmup=True)}"
    rng = np.random.default_rng(SEED + 31)
    V = eng.model_cfg.vocab_size
    rounds = {"cold": prompts(rng, MAIN_LENGTHS, V), "warm": prompts(rng, MAIN_LENGTHS, V)}
    hit = rounds["warm"][-1] + prompts(rng, [64], V)[0]
    base = {"max_tokens": SERVER_TOKENS, "temperature": 0, "ignore_eos": True,
            "return_token_ids": True, "stream_options": {"include_usage": True}}
    out = {"rounds": {}}
    try:
        # 8 concurrent streams, twice with new prompts: the first round
        # meets buckets the server's warmup did not capture, the second
        # meets them captured.  Their step records are the HTTP engine's
        # split; the engine's first record (phases since its recorder was
        # made, the whole process's) is reported without its phases.
        marks = stat_marks(eng)
        reset_launches()
        first = None
        for name, conc in rounds.items():
            st0 = eng.flight._steps.idx
            res: dict = {}
            threads = [threading.Thread(target=lambda i=i, p=p: res.__setitem__(
                i, sse(url + "/v1/completions", dict(base, prompt=p))))
                for i, p in enumerate(conc)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            recs = eng.flight.steps_snapshot(limit=eng.flight._steps.idx - st0)
            if st0 == 0:
                first = {k: v for k, v in recs[0].items() if k != "phase_ms"}
                recs = recs[1:]
            streams = [res[i] for i in range(len(conc))]
            out["rounds"][name] = {
                "streams_ok": all(stream_ok(r, url, len(p)) for r, p in zip(streams, conc)),
                "rates": stream_rates(streams), "steps_gate": steps_gate(recs),
                "split": step_split([recs])}
        out["first_record"] = first
        # the prefix hit, then the tools requests
        hit_res = sse(url + "/v1/completions", dict(base, prompt=hit))
        out["hit_ok"] = stream_ok(hit_res, url, len(hit))
        tools = {}
        for name, choice in (("auto", "auto"), ("required", "required"),
                             ("named", {"type": "function",
                                        "function": {"name": "get_weather"}})):
            body = {"messages": [{"role": "user", "content": "What is the weather in Paris?"}],
                    "tools": FLIGHT_TOOLS, "tool_choice": choice, "max_tokens": 32,
                    "temperature": 0}
            status, full = http(url + "/v1/chat/completions", body)
            streamed = sse(url + "/v1/chat/completions", body)
            deltas = [ch["delta"].get("content", "") for c in streamed["chunks"]
                      for ch in c["choices"]]
            finishes = [ch["finish_reason"] for c in streamed["chunks"] for ch in c["choices"]
                        if ch.get("finish_reason")]
            msg = full["choices"][0]["message"] if status == 200 else {}
            tools[name] = {
                "status": [status, streamed.get("status")],
                "finish": [full["choices"][0]["finish_reason"] if status == 200 else None,
                           finishes[-1] if finishes else None],
                "tool_calls": [len(msg.get("tool_calls") or []),
                               sum(len(ch["delta"].get("tool_calls", []))
                                   for c in streamed["chunks"] for ch in c["choices"])],
                "content_chars": len(msg.get("content") or ""),
                "marker_in_stream": any("<tool_call>" in d for d in deltas)}
            tools[name]["ok"] = (tools[name]["status"] == [200, 200] and streamed["done"]
                                 and all(f in ("stop", "length", "tool_calls")
                                         for f in tools[name]["finish"])
                                 and not tools[name]["marker_in_stream"])
        out["tools"] = tools
        launches = read_launches()
        want = launches_since(eng, marks)
        # the debug routes
        s_eng, snap = http(url + "/debug/engine")
        rids = snap["requests"]
        tls = {r: http(url + f"/debug/requests/{r}") for r in rids}
        hit_rids = [r for r, (_, tl) in tls.items()
                    if tl["events"][0].get("detail", {}).get("prompt_tokens") == len(hit)]
        bad = [r for r, (s, tl) in tls.items()
               if s != 200 or not timeline_ok(tl["events"], r in hit_rids)]
        s_h, health = http(url + "/healthz")
        s_d, dump = http(url + "/debug/engine/dump")
        s_404, _ = http(url + "/debug/requests/no-such-request")
        rings = dump.get("rings", {}) if s_d == 200 else {}
        sli = snap.get("sli", {}).get("standard", {})
        out.update({
            "requests_recorded": len(rids), "hit_requests": len(hit_rids),
            "timelines_not_ok": bad, "example_timeline": [e["event"] for e in
                                                         tls[hit_rids[0]][1]["events"]]
            if hit_rids else None,
            "debug_engine": {"status": s_eng, "steps": len(snap.get("steps", [])),
                             "steps_with_phases": sum(1 for s in snap.get("steps", [])
                                                      if s.get("phase_ms")),
                             "sli_kinds": sorted(sli), "cold_start_s": snap.get("cold_start_s"),
                             "compile_caches": snap.get("compile_caches")},
            "healthz_cold_start_s": health.get("cold_start_s"),
            "dump": {"status": s_d, "schema": dump.get("schema"),
                     "rings": rings, "requests": len(dump.get("requests", {}))},
            "unknown_id_status": s_404, "postmortems_in_clean_run": len(os.listdir(fdir)),
            "launches": launches, "launches_expected": want})
        out["ok"] = bool(
            all(r["streams_ok"] and r["steps_gate"]["ok"] for r in out["rounds"].values())
            and out["hit_ok"] and all(t["ok"] for t in tools.values())
            and len(rids) == 2 * len(MAIN_LENGTHS) + 1 + 2 * len(tools)
            and len(hit_rids) == 1 and not bad
            and s_eng == 200 and out["debug_engine"]["steps_with_phases"] > 0
            and {"ttft", "itl", "e2e"} <= set(sli) and (snap.get("cold_start_s") or 0) > 0
            and s_h == 200 and (health.get("cold_start_s") or 0) > 0
            and s_d == 200 and dump.get("schema") == 2
            and all(set(rings.get(k, {})) == {"cursor", "capacity", "dropped", "torn"}
                    for k in ("events", "steps"))
            and s_404 == 404 and launches == want and launches["paged_window"] > 0)
    finally:
        srv.shutdown()
        del srv, eng
        torch.cuda.empty_cache()
    return out


def phase_flight(results) -> dict:
    """The flight recorder and the host-phase profiler on the main path:
    (a) the recorder's A/B and (b) its step records (``flight_ab``), (c) the
    HTTP server's debug routes, request timelines, tools and step records
    (``flight_server``)."""
    import gc
    import torch
    params = results["main"]["params"]
    V = results["main"]["engine"].model_cfg.vocab_size
    ps = prompts(np.random.default_rng(SEED + 3), MAIN_LENGTHS, V)
    gc.collect()
    torch.cuda.empty_cache()
    ab = flight_ab(params, ps)
    server = flight_server(results)
    gc.collect()
    torch.cuda.empty_cache()
    return {"ok": ab["ok"] and server["ok"], "ab": ab, "server": server}


# --------------------------------------------------------------------------
# phases spec and embed: speculative decoding and the cache-less trunks
# --------------------------------------------------------------------------

SPEC_K = 4
# the verify window's contexts and valid rows (1 + each row's drafts)
SPEC_CTX = [128, 384, 640, 896, 1152, 1408, 1664, 2048]
SPEC_ROWS = [5, 5, 4, 3, 5, 2, 1, 5]
# the identity runs: 8 prompts of 64-192 tokens (half a repeated span)
SPEC_TOKENS = 48
SPEC_DRAFT_WINDOW = 256           # the identity draft sees every token
SPEC_RATE_TOKENS = 256            # the tok/s workloads
# float32 (TF32 off) logits, kernel path against plain path, over 28
# layers: the draft check's gate there
FP32_LOGIT_GATE = 1e-3


def spec_marks(eng) -> tuple:
    return stat_marks(eng) + (eng.stats.spec_steps, eng.graphs.replays["verify"],
                              eng.graphs.replays["draft"])


def spec_launches(eng, before: tuple) -> dict:
    """Each kernel's launches the steps since ``before`` (``spec_marks``)
    must have made on a captured engine: flash prefill one a layer a
    batched prefill and k a layer a draft replay; paged decode one a layer
    a decode token step that was not a verify pass; paged window one a
    layer a chunk step or verify replay."""
    d = [a - b for a, b in zip(spec_marks(eng), before)]
    L = eng.model_cfg.num_layers
    k = eng._spec.num_draft_tokens if eng._spec is not None else 0
    return {"flash_prefill": L * (d[0] - d[1] - d[3]) + L * k * d[6],
            "paged_decode": L * (d[2] - d[4]), "paged_window": L * (d[1] + d[5]),
            "ragged_paged": L * d[3]}


def spec_engine(params, cfg, spec=None, identity=False, **kw):
    """A default engine (captured graphs, 32-token pipelined windows) on
    the main weights (``cfg`` None: the registered bf16 config) with
    ``spec``; ``identity``: the draft model is the target itself."""
    import torch
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig
    dtype = cfg.dtype if cfg is not None else "bfloat16"
    eng = Engine(EngineConfig(seed=SEED, cache=CacheConfig(dtype=dtype), speculative=spec,
                              **kw), params=params, model_cfg=cfg)
    if identity:
        # the registered draft's random weights give way to the target's
        # own, on the engine and on the step graphs that replay the draft
        eng._draft_cfg = eng.graphs.draft_cfg = eng.model_cfg
        eng._draft_params = eng.graphs.draft_params = params
        torch.cuda.empty_cache()
    return eng


def spec_configs() -> dict:
    from tpuserve_torch.runtime.spec import SpecConfig
    return {"plain": (None, False),
            "ngram": (SpecConfig(num_draft_tokens=SPEC_K), False),
            "draft": (SpecConfig(num_draft_tokens=SPEC_K, draft_model="Qwen/Qwen3-0.6B",
                                 draft_window=SPEC_DRAFT_WINDOW, adaptive=False), True)}


def spec_verify(params, cfg) -> dict:
    """One verify window (B=8, K=5, contexts 128-2,048, 1-5 valid rows)
    through the paged window kernel and through the plain attention on the
    same cache (a copy taken before), after a kernel prefill of the
    contexts: the logits of the valid rows within LOGIT_DIFF_MAX, the
    kernel's launches 28 (one a layer), argmax agreement and both passes'
    ms."""
    import torch
    from tpuserve_torch.models import transformer
    from tpuserve_torch.ops.attention import PAD_SLOT
    from tpuserve_torch.runtime.kv_cache import CacheConfig, create_kv_cache
    page, B, K = 32, len(SPEC_CTX), SPEC_K + 1
    V = cfg.vocab_size
    mb = -(-(max(SPEC_CTX) + K) // page)
    cache = create_kv_cache(cfg, CacheConfig(block_size=page, num_blocks=B * mb,
                                             max_blocks_per_seq=mb), "cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 41)
    bt = torch.randperm(B * mb, generator=g, device="cuda").to(torch.int32).reshape(B, mb)
    rng = np.random.default_rng(SEED + 41)
    T = max(SPEC_CTX)
    toks = np.zeros((B, T), np.int32)
    slots = np.full((B, T), PAD_SLOT, np.int32)
    bt_h = bt.cpu().numpy()

    def slot_of(b, pos):
        pos = np.asarray(pos)
        return (bt_h[b, pos // page] * page + pos % page).astype(np.int32)
    for b, n in enumerate(SPEC_CTX):
        toks[b, :n] = rng.integers(0, V, n)
        slots[b, :n] = slot_of(b, np.arange(n))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    transformer.prefill(params, cfg, t(toks), t(np.array(SPEC_CTX, np.int32)), t(slots),
                        cache, attn_impl="cuda")
    vt = rng.integers(0, V, (B, K)).astype(np.int32)
    vs = np.stack([slot_of(b, np.arange(c, c + K)) for b, c in enumerate(SPEC_CTX)])
    for b, n in enumerate(SPEC_ROWS):
        vt[b, n:] = 0
    args = (t(vt), t(np.array(SPEC_CTX, np.int32)), t(np.array(SPEC_ROWS, np.int32)),
            t(vs), bt)
    snap = [{k: v.clone() for k, v in e.items()} for e in cache]
    torch.cuda.synchronize()
    reset_launches()
    lk = transformer.verify_logits(params, cfg, *args, cache, attn_impl="cuda")
    torch.cuda.synchronize()
    launches = read_launches()
    lr = transformer.verify_logits(params, cfg, *args, snap, attn_impl="reference")
    rows = [(b, j) for b in range(B) for j in range(SPEC_ROWS[b])]
    bi = torch.tensor([r[0] for r in rows], device="cuda")
    ji = torch.tensor([r[1] for r in rows], device="cuda")
    a, r = lk[bi, ji], lr[bi, ji]
    diff = (a - r).abs().max().item()
    agree = (a.argmax(-1) == r.argmax(-1)).float().mean().item()
    # the pass on each path, over copies of the same cache (the writes are
    # the same rows each call)
    ms_k = cuda_ms(lambda: transformer.verify_logits(params, cfg, *args, cache,
                                                     attn_impl="cuda"), iters=5)
    ms_r = cuda_ms(lambda: transformer.verify_logits(params, cfg, *args, snap,
                                                     attn_impl="reference"), iters=3)
    del cache, snap
    out = {"rows": len(rows), "max_abs_diff": diff, "argmax_agree": agree,
           "launches": launches, "finite": bool(torch.isfinite(a).all()),
           "pass_ms": ms_k, "plain_pass_ms": ms_r}
    out["ok"] = bool(diff <= LOGIT_DIFF_MAX and out["finite"]
                     and launches["paged_window"] == cfg.num_layers
                     and sum(launches.values()) == cfg.num_layers)
    return out


def spec_draft(params, cfg, gate: float) -> dict:
    """``draft_propose`` (k=4 passes over (8, 64 + 4) windows of 1-64
    tokens) on the flash kernel against the plain attention: each pass's
    last-position logits, along the plain path's own proposals, within
    ``gate`` of the plain path's; the proposals equal at every position
    whose plain top-2 gap, and every earlier one's, exceeds twice
    ``gate``; the kernel's launches k a layer a call.  In float32 (TF32
    off) some positions must be that clear; in bf16 random weights'
    top-2 gaps mostly sit under the gate, so there it is a reading."""
    import torch
    from tpuserve_torch.models import transformer
    B, W, k = 8, 64, SPEC_K
    rng = np.random.default_rng(SEED + 43)
    lens = np.array([64, 64, 40, 64, 17, 64, 33, 1], np.int32)
    toks = np.zeros((B, W + k), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, cfg.vocab_size, n)
    tt, lt = torch.from_numpy(toks).cuda(), torch.from_numpy(lens).cuda()
    reset_launches()
    pk = transformer.draft_propose(params, cfg, tt, lt, k=k, attn_impl="cuda")
    torch.cuda.synchronize()
    launches = read_launches()
    pr = transformer.draft_propose(params, cfg, tt, lt, k=k, attn_impl="reference")
    # each pass's logits on both paths, along the plain path's proposals
    rows = torch.arange(B, device="cuda")
    cur, cols = lt.clone(), torch.arange(W + k, device="cuda")[None, :]
    ctx, gaps, diff = tt.clone(), [], 0.0
    with torch.no_grad():
        for j in range(k):
            last = {}
            for impl in ("cuda", "reference"):
                h = transformer._cacheless_trunk(params, cfg, ctx, cur, impl)
                last[impl] = transformer._unembed(params, cfg, h[rows, cur.long() - 1])
            diff = max(diff, (last["cuda"] - last["reference"]).abs().max().item())
            top2 = last["reference"].topk(2).values
            gaps.append(top2[:, 0] - top2[:, 1])
            ctx = torch.where(cols == cur[:, None], pr[:, j:j + 1], ctx)
            cur = cur + 1
    clear = (torch.stack(gaps, 1) > 2 * gate).int().cumprod(1).bool()
    checked = int(clear.sum())
    mismatched = int(((pk != pr) & clear).sum())
    ms_k = cuda_ms(lambda: transformer.draft_propose(params, cfg, tt, lt, k=k,
                                                     attn_impl="cuda"), iters=5)
    out = {"dtype": cfg.dtype, "gate": gate, "proposals": B * k, "max_abs_diff": diff,
           "checked": checked, "mismatched_where_clear": mismatched,
           "equal_share": (pk == pr).float().mean().item(), "launches": launches,
           "eager_call_ms": ms_k}
    out["ok"] = bool(mismatched == 0 and diff <= gate
                     and (cfg.dtype != "float32" or checked > 0)
                     and launches["flash_prefill"] == cfg.num_layers * k
                     and sum(launches.values()) == cfg.num_layers * k)
    return out


def spec_prompts(V: int) -> list:
    rng = np.random.default_rng(SEED + 45)
    out = []
    for i, n in enumerate([64, 96, 128, 160, 192, 80, 112, 144]):
        if i % 2:
            out.append(rng.integers(0, V, n).tolist())
        else:                                # a 32-token span, repeated
            span = rng.integers(0, V, 32).tolist()
            out.append((span * (n // 32 + 1))[:n])
    return out


def spec_identity(params, cfg, ps) -> dict:
    """The main path's greedy streams on three default engines, plain,
    n-gram (k=4) and identity-draft speculation (the target as its own
    draft, ``adaptive=False``): in float32 (TF32 off) the
    three token-identical and the draft's acceptance 100%; in bf16 each
    one's first divergence from the plain stream.  Launches against the
    steps on each engine."""
    import torch
    from tpuserve_torch.runtime import SamplingParams
    sp = SamplingParams(max_tokens=SPEC_TOKENS, temperature=0.0, ignore_eos=True)
    out, streams = {}, {}
    for name, (spec, identity) in spec_configs().items():
        eng = spec_engine(params, cfg, spec, identity)
        reset_launches()
        marks = spec_marks(eng)
        t = time.perf_counter()
        streams[name] = [r.output_token_ids for r in eng.generate(ps, sp)]
        torch.cuda.synchronize()
        st = eng.stats
        launches, want = read_launches(), spec_launches(eng, marks)
        d = [a - b for a, b in zip(spec_marks(eng), marks)]
        out[name] = {"wall_s": time.perf_counter() - t, "spec_steps": st.spec_steps,
                     "prefill_steps": d[0] - d[1] - d[3], "chunk_steps": d[1],
                     "verify_replays": d[5],
                     "draft_replays": d[6],
                     "proposed": st.spec_proposed, "accepted": st.spec_accepted,
                     "acceptance": st.spec_accepted / st.spec_proposed if st.spec_proposed
                     else None, "pauses": st.spec_pauses, "launches": launches,
                     "launches_ok": launches == want, "capture_s": eng.graphs.capture_s,
                     "first_diff": [first_diff(a, b) for a, b in
                                    zip(streams[name], streams.get("plain", streams[name]))]}
        out[name]["ok"] = launches == want and eng.block_manager.num_seqs() == 0
        del eng
        torch.cuda.empty_cache()
    exact = cfg is not None and cfg.dtype == "float32"
    d = out["draft"]
    out["equal"] = streams["ngram"] == streams["plain"] == streams["draft"]
    out["ok"] = bool(all(v["ok"] for v in out.values() if isinstance(v, dict))
                     and d["spec_steps"] > 0
                     and (not exact or (out["equal"] and d["accepted"] == d["proposed"])))
    return out


def spec_marginal() -> dict:
    """``spec_accept_sampled`` on the card, on its keyed noise: 4,000 rows
    of one 8-token distribution and a fixed draft token; the acceptance
    rate within 0.03 of p(draft) and the first emitted token's frequencies
    within 0.03 of p (the CPU test's gates)."""
    import torch
    from tpuserve_torch.ops import sampling
    rng = np.random.default_rng(0)
    V, N = 8, 4000
    row = rng.normal(size=(V,)).astype(np.float32) * 1.5
    logits = torch.from_numpy(np.tile(row, (N, 2, 1))).cuda()
    accept, pred = sampling.spec_accept_sampled(
        logits, torch.full((N, 1), 3, dtype=torch.int32, device="cuda"),
        torch.full((N,), 2, dtype=torch.int32, device="cuda"),
        torch.arange(N, device="cuda"), torch.full((N,), 7, device="cuda"),
        torch.ones(N, device="cuda"), torch.zeros(N, dtype=torch.int32, device="cuda"),
        torch.ones(N, device="cuda"))
    acc = accept.cpu().numpy()[:, 0]
    emitted = np.where(acc, 3, pred.cpu().numpy()[:, 0])
    p = np.exp(row) / np.exp(row).sum()
    freq_err = float(np.abs(np.bincount(emitted, minlength=V) / N - p).max())
    acc_err = abs(float(acc.mean()) - float(p[3]))
    return {"accept_rate": float(acc.mean()), "p_draft": float(p[3]),
            "max_freq_err": freq_err, "ok": acc_err < 0.03 and freq_err < 0.03}


def spec_sampled(params, cfg, ps) -> dict:
    """Sampled speculation (temperature 0.7, top_p 0.9, seeded) with the
    identity draft in bf16, prefix caching off: two runs give the same
    tokens; the sampled verify executables ran."""
    from tpuserve_torch.runtime import SamplingParams
    spec, _ = spec_configs()["draft"]
    eng = spec_engine(params, cfg, spec, identity=True, enable_prefix_caching=False)
    plist = [SamplingParams(max_tokens=SPEC_TOKENS, temperature=0.7, top_p=0.9, seed=100 + i,
                            ignore_eos=True) for i in range(len(ps))]
    runs = [[r.output_token_ids for r in eng.generate(ps, plist)] for _ in range(2)]
    st = eng.stats
    sampled_keys = sorted(k for k in eng.graphs.executables if k[0] == "verify"
                          and k[3] == "sampled")
    out = {"equal": runs[0] == runs[1], "spec_steps": st.spec_steps,
           "acceptance": st.spec_accepted / max(st.spec_proposed, 1),
           "sampled_verify_keys": [list(k) for k in sampled_keys],
           "marginal": spec_marginal()}
    out["ok"] = bool(out["equal"] and st.spec_steps > 0 and sampled_keys
                     and out["marginal"]["ok"])
    del eng
    return out


def spec_rates(params, cfg) -> dict:
    """Decode tok/s with and without n-gram speculation on the default
    engine, 8 streams of 256 greedy tokens: an extractive workload (each
    prompt a 512-token span repeated three times) and a free one (random
    1,536-token prompts).  The spec engine's verify executables are
    captured first (``_spec_keys``); its pool's bytes against
    ``pool_bytes_bound`` of every executable it made.  Acceptance, spec
    steps, governor pauses and capture seconds are readings; launches
    against the steps are gated."""
    import torch
    from tpuserve_torch.runtime import SamplingParams
    from tpuserve_torch.runtime.graphs import VERIFY_MODES, pool_bytes_bound
    V = cfg.vocab_size
    rng = np.random.default_rng(SEED + 47)
    work = {"extractive": [(lambda s: s * 3)(rng.integers(0, V, 512).tolist())
                           for _ in range(8)],
            "free": [rng.integers(0, V, 1536).tolist() for _ in range(8)]}
    sp = SamplingParams(max_tokens=SPEC_RATE_TOKENS, temperature=0.0, ignore_eos=True)
    out = {}
    for name, (spec, _) in (("plain", spec_configs()["plain"]),
                            ("ngram", spec_configs()["ngram"])):
        eng = spec_engine(params, cfg, spec, enable_prefix_caching=False)
        t0 = time.perf_counter()
        eng.graphs.warmup(eng._spec_keys(VERIFY_MODES))
        res = {"spec_capture_s": time.perf_counter() - t0}
        for wname, ps in work.items():
            before = (eng.stats.spec_steps, eng.stats.spec_proposed, eng.stats.spec_accepted,
                      eng.stats.spec_pauses)
            reset_launches()
            marks = spec_marks(eng)
            rids = [eng.add_request(prompt_token_ids=p, params=sp) for p in ps]
            t_first = None
            while eng.has_work():
                eng.step()
                if t_first is None and all(eng.requests[r].output_token_ids for r in rids):
                    torch.cuda.synchronize()
                    t_first = time.perf_counter()
            torch.cuda.synchronize()
            span = time.perf_counter() - t_first
            toks = sum(len(eng.requests.pop(r).output_token_ids) - 1 for r in rids)
            st = eng.stats
            d = [st.spec_steps - before[0], st.spec_proposed - before[1],
                 st.spec_accepted - before[2], st.spec_pauses - before[3]]
            launches, want = read_launches(), spec_launches(eng, marks)
            res[wname] = {"decode_tok_per_s": toks / span, "decode_s": span,
                          "spec_steps": d[0], "acceptance": d[2] / d[1] if d[1] else None,
                          "pauses": d[3], "launches_ok": launches == want}
        keys = list(eng.graphs.executables)
        res.update(capture_s=eng.graphs.capture_s, executables=len(keys),
                   spec_executables=sorted("/".join(map(str, k)) for k in keys
                                           if k[0] in ("verify", "draft")),
                   pool_bytes=eng.graphs.pool_bytes(),
                   pool_bytes_bound=pool_bytes_bound(eng.model_cfg, keys, eng._ragged_seqs,
                                                     eng._draft_cfg))
        res["ok"] = (all(res[w]["launches_ok"] for w in work)
                     and res["pool_bytes"] <= res["pool_bytes_bound"])
        out[name] = res
        del eng
        torch.cuda.empty_cache()
    for w in work:
        out[f"{w}_speedup"] = (out["ngram"][w]["decode_tok_per_s"]
                               / out["plain"][w]["decode_tok_per_s"])
    out["ok"] = out["plain"]["ok"] and out["ngram"]["ok"]
    return out


def phase_spec(results) -> dict:
    """Speculative decoding at full width on ``feature_model``
    (FEATURE_LAYERS layers of the main weights): the verify window on
    the paged window kernel (``spec_verify``), the draft on the flash
    kernel (``spec_draft``), the three engines' streams in float32 and
    bf16 (``spec_identity``), sampled speculation and the acceptance's
    marginal on the card (``spec_sampled``), and decode tok/s with and
    without it (``spec_rates``)."""
    import gc
    import torch
    params, cfg = feature_model(results)
    verify = spec_verify(params, cfg)
    draft = spec_draft(params, cfg, LOGIT_DIFF_MAX)
    ps = spec_prompts(cfg.vocab_size)
    gc.collect()
    torch.cuda.empty_cache()
    fp32_params, fp32_cfg = fp32_main(FEATURE_LAYERS)
    draft32 = spec_draft(fp32_params, fp32_cfg, FP32_LOGIT_GATE)
    ident32 = spec_identity(fp32_params, fp32_cfg, ps)
    del fp32_params
    gc.collect()
    torch.cuda.empty_cache()
    ident16 = spec_identity(params, cfg, ps)
    sampled = spec_sampled(params, cfg, ps)
    rates = spec_rates(params, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    # the kernels' launches on the main path: the bf16 identity-draft
    # engine's run (counts zeroed just before its generate, read just
    # after), its verify and draft replays beside them; the standalone
    # calls' counts above gate one call each
    run = ident16["draft"]
    L = cfg.num_layers
    launches = {"paged_window": run["launches"]["paged_window"],
                "flash_prefill": run["launches"]["flash_prefill"]}
    engine_run = {"verify_replays": run["verify_replays"],
                  "draft_replays": run["draft_replays"],
                  "prefill_steps": run["prefill_steps"], "chunk_steps": run["chunk_steps"],
                  **launches,
                  "paged_window_per_verify_replay": (
                      (launches["paged_window"] - L * run["chunk_steps"])
                      / run["verify_replays"]
                      if run["verify_replays"] else None),
                  "flash_prefill_per_draft_replay": (
                      (launches["flash_prefill"] - L * run["prefill_steps"])
                      / run["draft_replays"] if run["draft_replays"] else None)}
    engine_run["ok"] = bool(run["launches_ok"] and run["verify_replays"] > 0
                            and run["draft_replays"] > 0)
    return {"ok": all(r["ok"] for r in (verify, draft, draft32, ident32, ident16, sampled,
                                        rates, engine_run)),
            "verify": verify, "draft": draft, "draft_fp32": draft32, "identity_fp32": ident32,
            "identity_bf16": ident16, "sampled": sampled, "rates": rates,
            "engine_run": engine_run, "launches": launches}


EMBED_LENGTHS = MAIN_LENGTHS         # batch 8 x T 128-1,024
EMBED_STREAMS = 8
EMBED_STREAM_TOKENS = 64


def cosines(a, b) -> np.ndarray:
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def embed_paths(params, cfg) -> dict:
    """``Engine.embed`` (mean and last pooling) and ``Engine.score_prompts``
    (top 5) of 8 inputs of 128-1,024 tokens on a kernel engine and on a
    plain-attention engine: embeddings' cosines at least 0.999; chosen
    logprobs within LOGIT_DIFF_MAX; every kernel rank inside the band the
    plain logprobs allow when each may move by LOGIT_DIFF_MAX
    (``rank_bands``: one rank wherever the gap allows only one); the
    flash kernel's launches one a layer a trunk batch; ms of each call
    on each engine."""
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig
    kern = Engine(EngineConfig(seed=SEED, cache=CacheConfig(num_blocks=64)), params=params,
                  model_cfg=cfg)
    plain = Engine(EngineConfig(seed=SEED, attn_impl="reference", cuda_graphs=False,
                                cache=CacheConfig(num_blocks=64)), params=params, model_cfg=cfg)
    rng = np.random.default_rng(SEED + 51)
    inputs = prompts(rng, EMBED_LENGTHS, cfg.vocab_size)
    L = cfg.num_layers
    out = {"launches": {}}
    ok = True
    for pooling in ("mean", "last"):
        reset_launches()
        vk, counts = kern.embed(inputs, pooling)
        out["launches"][f"embed_{pooling}"] = read_launches()
        vp, _ = plain.embed(inputs, pooling)
        cos = cosines(vk, vp)
        out[f"embed_{pooling}"] = {"min_cosine": float(cos.min()), "shape": list(vk.shape),
                                   "ms": 1e3 * timed_host(lambda: kern.embed(inputs, pooling)),
                                   "plain_ms": 1e3 * timed_host(
                                       lambda: plain.embed(inputs, pooling))}
        ok &= bool(cos.min() >= 0.999 and np.isfinite(vk).all()
                   and out["launches"][f"embed_{pooling}"]["flash_prefill"] == L)
    reset_launches()
    sk = kern.score_prompts(inputs, top_n=5)
    out["launches"]["score"] = read_launches()
    sr = plain.score_prompts(inputs, top_n=5)
    bands = rank_bands(params, cfg, inputs, LOGIT_DIFF_MAX)
    diffs, rank_eq, pinned, outside = [], 0, 0, 0
    for ek, er, (lo, hi) in zip(sk, sr, bands):
        for a, b, l_, h_ in zip(ek[1:], er[1:], lo, hi):
            diffs.append(abs(a["logprob"] - b["logprob"]))
            rank_eq += a["rank"] == b["rank"]
            pinned += l_ == h_
            outside += not l_ <= a["rank"] <= h_
    out["score"] = {"tokens": len(diffs), "max_abs_diff": max(diffs),
                    "rank_equal_share": rank_eq / len(diffs),
                    "ranks_pinned_by_the_gap": pinned,
                    "ranks_outside_their_band": outside,
                    "ms": 1e3 * timed_host(lambda: kern.score_prompts(inputs, top_n=5)),
                    "plain_ms": 1e3 * timed_host(lambda: plain.score_prompts(inputs, top_n=5))}
    ok &= bool(max(diffs) <= LOGIT_DIFF_MAX and outside == 0
               and out["launches"]["score"]["flash_prefill"] == L)
    out["ok"] = ok
    out["engine"] = kern
    del plain
    return out


def rank_bands(params, cfg, inputs: list, gate: float) -> list:
    """For each input, the (lo, hi) full-vocabulary ranks its token p can
    take at position p - 1 when every logprob may move by ``gate``: 1 +
    the tokens more than 2 ``gate`` above its plain logprob, 1 + those
    above it less 2 ``gate``, from the plain attention's full
    log-softmax (128 positions at a time).  lo == hi where the gap
    allows one rank only."""
    import torch
    from tpuserve_torch.models import transformer
    T = max(len(x) for x in inputs)
    toks = np.zeros((len(inputs), T), np.int32)
    for b, x in enumerate(inputs):
        toks[b, :len(x)] = x
    lens = torch.tensor([len(x) for x in inputs], dtype=torch.int32, device="cuda")
    out = []
    with torch.no_grad():
        h = transformer._cacheless_trunk(params, cfg, torch.from_numpy(toks).cuda(), lens,
                                         "reference")
        for b, x in enumerate(inputs):
            nxt = torch.tensor(x[1:], device="cuda")
            lo, hi = [], []
            for c in range(0, len(x) - 1, 128):
                lps = torch.log_softmax(transformer._unembed(params, cfg, h[b, c:c + 128]), -1)
                n = min(128, len(x) - 1 - c)
                ch = lps[torch.arange(n, device="cuda"), nxt[c:c + n]][:, None]
                lo.append((lps[:n] > ch + 2 * gate).sum(-1) + 1)
                hi.append((lps[:n] > ch - 2 * gate).sum(-1) + 1)
            out.append((torch.cat(lo).tolist(), torch.cat(hi).tolist()))
    return out


def timed_host(fn) -> float:
    """Seconds of one ``fn()`` on the host clock, the card synchronised."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def embed_server(eng) -> dict:
    """``/v1/embeddings``, prompt scoring and a streamed echo with logprobs
    through an in-process server over the kernel engine: the embeddings
    equal ``Engine.embed``'s, the scored logprobs ``score_prompts``', and
    the echo chunk's arrays the scoring's, its stream complete."""
    import base64
    from tpuserve_torch.server import OpenAIServer, ServerConfig
    srv = OpenAIServer(eng, ServerConfig(host="127.0.0.1", port=0))
    url = f"http://127.0.0.1:{srv.start()}"
    rng = np.random.default_rng(SEED + 53)
    ids = prompts(rng, [200, 77, 513], eng.model_cfg.vocab_size)
    try:
        s1, emb = http(url + "/v1/embeddings", {"input": ids, "encoding_format": "base64"})
        want, _ = eng.embed(ids)
        got = np.stack([np.frombuffer(base64.b64decode(d["embedding"]), "<f4")
                        for d in emb["data"]]) if s1 == 200 else None
        s2, sc = http(url + "/v1/completions", {"prompt": ids[0], "max_tokens": 0,
                                                "echo": True, "logprobs": 2})
        entries = eng.score_prompts([ids[0]], top_n=2)[0]
        lp_ok = s2 == 200 and all(
            (x is None and e["logprob"] is None) or abs(x - e["logprob"]) <= 1e-6
            for x, e in zip(sc["choices"][0]["logprobs"]["token_logprobs"], entries))
        st = sse(url + "/v1/completions", {"prompt": ids[1], "max_tokens": 16, "echo": True,
                                           "logprobs": 2, "temperature": 0, "ignore_eos": True,
                                           "return_token_ids": True})
        first = st["chunks"][0]["choices"][0] if st.get("chunks") else {}
        echo_lp = (first.get("logprobs") or {}).get("token_logprobs", [])
        e1 = eng.score_prompts([ids[1]], top_n=2)[0]
        out = {"embeddings_status": s1, "embeddings_max_diff": (
                   float(np.abs(got - want).max()) if got is not None else None),
               "scoring_status": s2, "scoring_equal": bool(lp_ok),
               "stream_status": st.get("status"), "stream_done": st.get("done"),
               "stream_tokens": len(stream_ids(st)) if st.get("chunks") else 0,
               "echo_entries": len(echo_lp)}
        out["ok"] = bool(s1 == 200 and out["embeddings_max_diff"] <= 1e-6 and lp_ok
                         and st.get("status") == 200 and st.get("done")
                         and out["stream_tokens"] == 16 and len(echo_lp) == len(e1)
                         and echo_lp[0] is None
                         and all(abs(x - e["logprob"]) <= 1e-6
                                 for x, e in zip(echo_lp[1:], e1[1:])))
    finally:
        srv.shutdown()
    return out


def serve_streams(eng, ps: list, emb_in=None) -> dict:
    """``ps`` streamed through an in-process server over ``eng``, greedy,
    EMBED_STREAM_TOKENS each, with embeddings of ``emb_in`` posted in a
    loop until the streams end (none when None): each stream's ids (None
    where its status was not 200), its gaps between token chunks, the
    posts' statuses, the decode executables the run captured and the
    runner's failed steps."""
    import threading
    from tpuserve_torch.server import OpenAIServer, ServerConfig
    srv = OpenAIServer(eng, ServerConfig(host="127.0.0.1", port=0))
    url = f"http://127.0.0.1:{srv.start()}"
    decode_before = sum(1 for k in eng.graphs.executables if k[0] == "decode")
    streams, posts, stop = {}, [], threading.Event()

    def stream(i):
        streams[i] = sse(url + "/v1/completions", {
            "prompt": ps[i], "max_tokens": EMBED_STREAM_TOKENS, "temperature": 0,
            "ignore_eos": True, "return_token_ids": True})

    def embed_loop():
        while not stop.is_set():
            posts.append(http(url + "/v1/embeddings", {"input": emb_in})[0])
    try:
        poster = threading.Thread(target=embed_loop)
        if emb_in is not None:
            poster.start()
        threads = [threading.Thread(target=stream, args=(i,)) for i in range(len(ps))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        stop.set()
        if emb_in is not None:
            poster.join()
    finally:
        srv.shutdown()
    res = [streams[i] for i in range(len(ps))]
    return {"ids": [stream_ids(r) if r.get("status") == 200 else None for r in res],
            "statuses": [r.get("status") for r in res],
            "gaps": [float(g) for r in res for g in np.diff(r["t_tokens"])],
            "posts": posts, "steps_failed": srv.runner.steps_failed,
            "decode_made": sum(1 for k in eng.graphs.executables
                               if k[0] == "decode") - decode_before}


def embed_concurrent(params, cfg) -> dict:
    """Embeddings posted while 8 streams decode, in float32 (TF32 off) on a
    server engine that is not warmed, so its decode bucket is captured on
    first use amid the traffic: no request fails, a decode executable was
    captured during it, and the streams' tokens equal a twin engine's
    streams with no embedding traffic.  The embeddings run on the loop
    thread between steps, so they stall every stream: the largest, the
    90th percentile and the median gap between token chunks with and
    without the traffic, and one embedding call's seconds, are readings."""
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig
    conf = EngineConfig(seed=SEED, cache=CacheConfig(num_blocks=512, dtype="float32"))
    rng = np.random.default_rng(SEED + 55)
    ps = prompts(rng, [100, 150, 200, 250, 300, 350, 400, 128], cfg.vocab_size)
    emb_in = prompts(rng, [256] * 8, cfg.vocab_size)
    twin = serve_streams(Engine(conf, params=params, model_cfg=cfg), ps)
    eng = Engine(conf, params=params, model_cfg=cfg)
    run = serve_streams(eng, ps, emb_in)
    embed_s = timed_host(lambda: eng.embed(emb_in))
    gaps = {name: {"max_gap_s": max(r["gaps"]),
                   "p90_gap_s": float(np.quantile(r["gaps"], 0.9)),
                   "median_gap_s": float(np.median(r["gaps"])), "gaps": len(r["gaps"])}
            for name, r in (("alone", twin), ("with_embeddings", run)) if r["gaps"]}
    out = {"embed_posts": len(run["posts"]), "embed_statuses": sorted(set(run["posts"])),
           "stream_statuses": run["statuses"], "twin_statuses": twin["statuses"],
           "equal_to_twin": run["ids"] == twin["ids"],
           "first_diff": [first_diff(g, w) if g is not None and w is not None else 0
                          for g, w in zip(run["ids"], twin["ids"])],
           "decode_executables_captured": run["decode_made"], "capture_s": eng.graphs.capture_s,
           "steps_failed": run["steps_failed"], "token_gaps": gaps,
           "one_embed_call_s": embed_s}
    out["ok"] = bool(run["posts"] and set(run["posts"]) == {200}
                     and None not in twin["ids"] and run["ids"] == twin["ids"]
                     and run["decode_made"] > 0 and run["steps_failed"] == 0)
    del eng
    return out


def phase_embed(results) -> dict:
    """The cache-less trunks at full width on ``feature_model``
    (FEATURE_LAYERS layers of the main weights): the kernel path
    against the plain path (``embed_paths``), the HTTP surfaces
    (``embed_server``) and embeddings amid decoding streams and a
    first-use capture (``embed_concurrent``)."""
    import gc
    import torch
    params, cfg = feature_model(results)
    paths = embed_paths(params, cfg)
    server = embed_server(paths.pop("engine"))
    gc.collect()
    torch.cuda.empty_cache()
    fp32_params, fp32_cfg = fp32_main(FEATURE_LAYERS)
    conc = embed_concurrent(fp32_params, fp32_cfg)
    del fp32_params
    gc.collect()
    torch.cuda.empty_cache()
    return {"ok": paths["ok"] and server["ok"] and conc["ok"], "paths": paths,
            "server": server, "concurrent": conc,
            "launches": {"flash_prefill": paths["launches"]["embed_mean"]["flash_prefill"]}}


# --------------------------------------------------------------------------
# families phase: every model family the repo registers, at full width

# the phase's caches: 200 pages of 32 keys hold a 6,000-token prompt and
# 256 generated tokens (6,400 tokens a sequence)
FAMILY_CACHE = dict(block_size=32, max_blocks_per_seq=200)
FAMILY_BLOCKS = 256
MOE_MODEL, MOE_BLOCKS, MOE_TOKENS = "Qwen/Qwen3-30B-A3B", 640, 64
# the dense form against the routed-only one, float32: max |diff| over
# max |routed|
MOE_ROUTED_RTOL = 1e-3
WINDOW_MODEL, WINDOW_PROMPT, WINDOW_TOKENS, WINDOW_SPAN = (
    "mistralai/Mistral-7B-Instruct-v0.1", 6000, 256, 500)
# (model, long prompt, greedy tokens): mixed-layer windowed families
MIXED_WINDOW_FAMILIES = (("google/gemma-2-2b", 6000, 32),
                         ("google/gemma-3-4b-text", 2048, 32))
SHORT_FAMILIES = ("facebook/opt-1.3b", "microsoft/Phi-3-mini-4k-instruct")
FAMILY_TOKENS = 64


def family_free() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


# The depth the families and breadth phases run these models at, cut to
# keep the script inside its limit (every width, head and expert count,
# window, prompt and dtype stays; a 5:1 model keeps two global layers);
# the rest run at full depth.  Qwen3-30B-A3B runs 24 of its 48 layers in
# both phases: the int8 run's weight share is gated against the families
# phase's bf16 bytes at the same depth (0.5015 at 24 layers, as at 48).
FAMILY_LAYERS = {"mistralai/Mistral-7B-Instruct-v0.1": 8, "google/gemma-2-2b": 8,
                 "google/gemma-3-4b-text": 12, "facebook/opt-1.3b": 8,
                 "microsoft/Phi-3-mini-4k-instruct": 8, "deepseek-ai/DeepSeek-V2-Lite": 8,
                 "Qwen/Qwen3-30B-A3B": 24}


def family_cfg(name: str, dtype: str):
    from tpuserve_torch.models.config import get_model_config
    cfg = dataclasses.replace(get_model_config(name), dtype=dtype)
    layers = FAMILY_LAYERS.get(name)
    if layers is None:
        return cfg
    return dataclasses.replace(
        cfg, num_layers=layers,
        window_layers=cfg.window_layers[:layers] if cfg.window_layers else cfg.window_layers)


def family_params(cfg, seed: int = SEED):
    """Full-width random weights at ``cfg``'s depth made on the card from ``seed``
    (``init_params_device``: init_params' tree, shapes and scales), with
    their bytes and seconds."""
    from tpuserve_torch.models.weights import init_params_device, param_nbytes
    box = []
    init_s = timed_host(lambda: box.append(init_params_device(cfg, seed, "cuda")))
    return box[0], {"weights_gb": param_nbytes(box[0]) / 1e9, "init_s": init_s}


def family_engine(cfg, params, plain: bool = False, blocks: int = FAMILY_BLOCKS,
                  cache: dict = FAMILY_CACHE, **kw):
    """The default engine (captured graphs, pipelined windows) or, with
    ``plain``, the plain attention's eager engine, on one parameter tree;
    ``cache``: the CacheConfig fields (the model's dtype unless given)."""
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig
    if plain:
        kw = dict(kw, attn_impl="reference", cuda_graphs=False)
    cache = CacheConfig(num_blocks=blocks, **dict({"dtype": cfg.dtype}, **cache))
    return Engine(EngineConfig(model=cfg.name, seed=SEED, cache=cache, **kw), params=params,
                  model_cfg=cfg)


def family_serve(eng, ps, tokens: int) -> dict:
    """``ps`` greedy, ``tokens`` each, through ``add_request``/``step``, the
    kernels' launches counted from 0 over the run and held against its
    steps; the tokens, decode tok/s, the first step's ms, released blocks
    and, per request, its token count after the last step it ran in."""
    from tpuserve_torch.runtime import SamplingParams
    sp = SamplingParams(max_tokens=tokens, temperature=0.0, ignore_eos=True)
    reset_launches()
    rids = [eng.add_request(prompt_token_ids=p, params=sp) for p in ps]
    last = {}

    def on_step(e, steps):
        for r in e.scheduler.running:
            last[r.request_id] = r.num_tokens
    steps = drive(eng, on_step)
    launches = read_launches()
    want = expected_launches(eng.model_cfg.num_layers, steps)
    reqs = [eng.requests[r] for r in rids]
    dec = [s for s in steps if s["kind"] == "decode"]
    dec_tokens = sum(sum(s["decode_tokens"].values()) for s in dec)
    dec_s = sum(s["ms"] for s in dec) / 1e3
    return {"tokens": [r.output_token_ids for r in reqs],
            "finished": all(r.finished and len(r.output_token_ids) == tokens for r in reqs),
            "launches": launches, "launches_ok": launches == want,
            "first_step_ms": steps[0]["ms"], "decode_tokens": dec_tokens, "decode_s": dec_s,
            "decode_tok_per_s": dec_tokens / dec_s if dec_s else None,
            "chunk_steps": eng.stats.num_chunk_steps, "spec_steps": eng.stats.spec_steps,
            "released_blocks": eng.stats.released_blocks,
            "last_tokens": [last.get(r) for r in rids], "steps": step_summary(steps)}


def prefill_last_logits(params, cfg, ps, impl: str):
    """The last-row logits of one batched prefill of ``ps`` on a scratch
    cache, on the kernels (``impl`` "cuda") or the plain attention."""
    import torch
    from tpuserve_torch.models import transformer
    from tpuserve_torch.ops.attention import PAD_SLOT
    from tpuserve_torch.runtime.kv_cache import CacheConfig, create_kv_cache
    B, T = len(ps), max(len(p) for p in ps)
    tokens = torch.zeros(B, T, dtype=torch.int32, device="cuda")
    slots = torch.full((B, T), PAD_SLOT, dtype=torch.int32, device="cuda")
    for i, p in enumerate(ps):
        tokens[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
        slots[i, :len(p)] = torch.arange(i * T, i * T + len(p), dtype=torch.int32)
    plens = torch.tensor([len(p) for p in ps], dtype=torch.int32, device="cuda")
    cache = create_kv_cache(cfg, CacheConfig(num_blocks=-(-B * T // 32), dtype=cfg.dtype),
                            "cuda")
    return transformer.prefill(params, cfg, tokens, plens, slots, cache, attn_impl=impl)[0]


def family_prefill_logits(params, cfg, ps) -> dict:
    """The first step's last-row logits, kernels against the plain
    attention: one batched prefill of ``ps`` on a scratch cache each."""
    import torch
    logits = {impl: prefill_last_logits(params, cfg, ps, impl) for impl in ("cuda", "reference")}
    diff = (logits["cuda"] - logits["reference"]).abs().max().item()
    top1 = (logits["cuda"].argmax(-1) == logits["reference"].argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(logits["cuda"]).all())
    return {"ok": finite and diff <= LOGIT_DIFF_MAX and top1 >= 0.75, "rows": len(ps),
            "max_logit_diff": diff, "max_abs_logit": logits["reference"].abs().max().item(),
            "top1_agreement": top1}


def family_bf16_gates(name: str, long_len: int = 0) -> dict:
    """bf16 weights of ``name``: the first step's logits (8 prompts of the
    main lengths, within its positions), and, for a windowed family, the
    chunk logits of 6,000- (or ``long_len``-) token prompts past its
    window, kernels against the plain attention."""
    cfg = family_cfg(name, "bfloat16")
    params, made = family_params(cfg)
    ps = prompts(np.random.default_rng(SEED + 63), MAIN_LENGTHS, cfg.vocab_size)
    out = {"weights": made, "prefill_logits": family_prefill_logits(params, cfg, ps)}
    if long_len:
        first = prompts(np.random.default_rng(SEED + 64), [long_len], cfg.vocab_size)[0]
        out["chunk_logits"] = chunk_logits(params, cfg, first, total=long_len)
    out["ok"] = all(v["ok"] for k, v in out.items() if k.endswith("logits"))
    del params
    family_free()
    return out


class Routing:
    """Each MoE layer's expert choice (``transformer._top_k``'s indices)
    recorded over one run, then replayed in later runs, each replayed pass's
    rows mapped onto the recorded rows: a run whose inputs differ from the
    recorded one's by rounding then sends every token where it went, and
    its logits differ by the rounding alone (a bf16 router flips an expert
    on a last-bit change, which moves a row by a whole expert's output).
    ``moved`` counts the replayed rows whose own choice differed."""

    def __init__(self):
        self.picks, self.moved, self.rows = [], 0, 0

    def record(self, run):
        from tpuserve_torch.models import transformer
        top_k = transformer._top_k

        def rec(x, k):
            out = top_k(x, k)
            self.picks.append(out[1])
            return out
        transformer._top_k = rec
        try:
            return run()
        finally:
            transformer._top_k = top_k

    def replay(self, run, *row_maps, real=None):
        """``run`` with the recorded choices; ``row_maps``: one a replayed
        pass over the recorded picks (None: the same rows), each the
        recorded row of every row the pass routes; ``real``: the rows
        ``moved`` counts (all when None)."""
        from tpuserve_torch.models import transformer
        top_k, n, calls = transformer._top_k, len(self.picks), [0]

        def rep(x, k):
            _, idx = top_k(x, k)
            c = calls[0]
            calls[0] += 1
            rows = row_maps[c // n]
            pinned = self.picks[c % n] if rows is None else self.picks[c % n][rows]
            moved = (idx.sort(-1).values != pinned.sort(-1).values).any(-1)
            if real is not None:
                moved = moved & real
            self.moved += int(moved.sum())
            self.rows += idx.shape[0] if real is None else int(real.sum())
            return x.gather(-1, pinned), pinned
        transformer._top_k = rep
        try:
            return run()
        finally:
            transformer._top_k = top_k


def moe_prefill_logits(params, cfg, ps) -> dict:
    """The MoE model's first step, kernels against the plain attention.
    A router picks each token's experts from bf16 logits, where a change
    in the last bit moves a token to another expert, and a moved token's
    output differs by a whole expert's: so the free-running logits are a
    reading (with their top-1 agreement gated), and the logit gate holds
    the kernels' run with every layer's expert choice pinned to the plain
    run's (``Routing``), which leaves only the attention's rounding.  The
    real rows whose expert set moved in the free run are counted."""
    import torch
    free = family_prefill_logits(params, cfg, ps)
    B, T = len(ps), max(len(p) for p in ps)
    real = torch.tensor([[t < len(p) for t in range(T)] for p in ps], device="cuda").flatten()
    route = Routing()
    ref = route.record(lambda: prefill_last_logits(params, cfg, ps, "reference"))
    kern = route.replay(lambda: prefill_last_logits(params, cfg, ps, "cuda"), None, real=real)
    diff = (kern - ref).abs().max().item()
    return {"ok": bool(torch.isfinite(kern).all()) and free["top1_agreement"] >= 0.75
            and diff <= LOGIT_DIFF_MAX, "rows": B,
            "free_running": free, "pinned_routing_max_logit_diff": diff,
            "pinned_routing_top1_agreement": (kern.argmax(-1) == ref.argmax(-1))
            .float().mean().item(),
            "expert_sets_moved": route.moved, "expert_sets": route.rows}


def moe_routed_check(params, cfg) -> dict:
    """Layer 0's MoE MLP, dense dispatch (every expert on every token, the
    unchosen at weight 0), against a routed-only loop that runs each token
    through its chosen experts alone, both in float32 (TF32 off) on 64
    random rows: max |diff| over max |routed| within MOE_ROUTED_RTOL.  The
    bf16 dense form's share is a reading."""
    import torch
    from tpuserve_torch.models import transformer
    lp = params["layers"][0]
    lp32 = {"router": {"kernel": lp["router"]["kernel"].float()},
            "experts": {k: {"kernel": v["kernel"].float()} for k, v in lp["experts"].items()}}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(SEED + 65)
    x = torch.randn(64, cfg.hidden_size, generator=g, device="cuda")
    with torch.no_grad():
        dense = transformer._moe_mlp(x, lp32, cfg32)
        dense_bf16 = transformer._moe_mlp(x.to(torch.bfloat16), lp, cfg).float()
        scores = torch.softmax(x @ lp32["router"]["kernel"], dim=-1)
        topv, topi = torch.topk(scores, cfg.num_experts_per_tok, dim=-1)
        if cfg.norm_topk_prob:
            topv = topv / topv.sum(dim=-1, keepdim=True)
        routed = torch.zeros_like(x)
        w = lp32["experts"]
        for e in topi.unique().tolist():
            t, j = (topi == e).nonzero(as_tuple=True)
            h = (transformer._act(x[t] @ w["gate_proj"]["kernel"][e], cfg.act)
                 * (x[t] @ w["up_proj"]["kernel"][e]))
            routed.index_add_(0, t, (h @ w["down_proj"]["kernel"][e]) * topv[t, j, None])
    scale = routed.abs().max().item()
    rel = (dense - routed).abs().max().item() / scale
    del lp32
    return {"ok": bool(torch.isfinite(dense).all()) and rel <= MOE_ROUTED_RTOL,
            "rows": 64, "experts_chosen": int(topi.unique().numel()),
            "max_rel_diff": rel, "rtol": MOE_ROUTED_RTOL,
            "bf16_max_rel_diff": (dense_bf16 - routed).abs().max().item() / scale}


def moe_bounds(cfg, params, lens, tokens: int) -> dict:
    """The least time the card could take for the MoE model's prefill of
    ``lens`` (padded to a (B, max) batch, every row through every expert:
    dense dispatch) and for one decode token step of B streams (every
    weight but the embedding table read once, and the streams' K/V at the
    middle of their decode), from shapes and the data-sheet peaks."""
    from tpuserve_torch.models.weights import param_nbytes
    H, E, I, L = cfg.hidden_size, cfg.num_experts, cfg.expert_intermediate_size, cfg.num_layers
    B, T = len(lens), max(lens)
    per_row = L * (2 * H * (cfg.q_size + 2 * cfg.kv_size) + 2 * cfg.q_size * H
                   + 2 * H * E + E * 3 * 2 * H * I)
    pairs = sum(n * (n + 1) // 2 for n in lens)
    flops = B * T * per_row + L * 4 * cfg.num_heads * cfg.head_dim * pairs \
        + 2 * B * H * cfg.vocab_size
    w_bytes = param_nbytes(params) - param_nbytes(params["embed"])
    kv_token = 2 * L * cfg.num_kv_heads * cfg.head_dim * 2
    kv_bytes = sum(n + tokens // 2 for n in lens) * kv_token
    prefill_ms, prefill_by = bound(flops, w_bytes, "bfloat16")
    step_ms, step_by = bound(B * per_row, w_bytes + kv_bytes, "bfloat16")
    return {"prefill_tflop": flops / 1e12, "prefill_bound_ms": prefill_ms,
            "prefill_bound_by": prefill_by, "decode_step_bound_ms": step_ms,
            "decode_step_bound_by": step_by, "decode_bound_tok_per_s": B / step_ms * 1e3,
            "decode_step_gb": (w_bytes + kv_bytes) / 1e9}


def family_moe() -> dict:
    """Qwen3-30B-A3B (128 experts, top-8), bf16, full width, 24 of its 48
    layers (``FAMILY_LAYERS``): the default engine with its prefill (8, 1,024) and decode (8,
    greedy) steps captured, the graph pool under ``pool_bytes_bound``;
    8 prompts of the main lengths, 64 greedy tokens each, launches against
    the steps; prefill ms and decode tok/s beside their bounds; the first
    step's logits against the plain attention; the dense MoE against the
    routed one."""
    from tpuserve_torch.runtime.graphs import pool_bytes_bound
    cfg = family_cfg(MOE_MODEL, "bfloat16")
    params, made = family_params(cfg)
    eng = family_engine(cfg, params, blocks=MOE_BLOCKS)
    keys = [("prefill", 8, max(MAIN_LENGTHS)), ("decode", 8, "greedy")]
    capture_s = timed_host(lambda: eng.graphs.warmup(keys))
    ps = prompts(np.random.default_rng(SEED + 66), MAIN_LENGTHS, cfg.vocab_size)
    run = family_serve(eng, ps, MOE_TOKENS)
    made_keys = list(eng.graphs.executables)
    pool = {"pool_bytes": eng.graphs.pool_bytes(),
            "pool_bytes_bound": pool_bytes_bound(cfg, made_keys, eng._ragged_seqs),
            "executables": ["/".join(map(str, k)) for k in made_keys], "capture_s": capture_s}
    run.pop("tokens")
    del eng
    family_free()
    logits = moe_prefill_logits(params, cfg, ps)
    routed = moe_routed_check(params, cfg)
    bounds = moe_bounds(cfg, params, MAIN_LENGTHS, MOE_TOKENS)
    del params
    family_free()
    ok = (run["finished"] and run["launches_ok"] and logits["ok"] and routed["ok"]
          and pool["pool_bytes"] <= pool["pool_bytes_bound"])
    return {"ok": ok, "model": cfg.name, "dtype": cfg.dtype, "weights": made,
            "cache_blocks": MOE_BLOCKS, **pool, "run": run, "prefill_ms": run["first_step_ms"],
            "decode_tok_per_s": run["decode_tok_per_s"], "bounds": bounds,
            "prefill_logits": logits, "moe_routed": routed, "launches": run["launches"]}


def family_window() -> dict:
    """Mistral-7B (every layer a 4,096 window), float32 with TF32 off: a
    6,000-token prompt (a 500-token span twelve times, so n-gram drafts
    find matches) in chunks, 256 greedy tokens, on the default engine with
    the rolling-buffer release off, on, and on with n-gram speculation
    (k=4): the same tokens; released blocks = (tokens after the last step
    the request ran in - 4,096) // 32.  Then bf16, kernels against the
    plain attention."""
    from tpuserve_torch.runtime.spec import SpecConfig
    cfg = family_cfg(WINDOW_MODEL, "float32")
    params, made = family_params(cfg)
    span = prompts(np.random.default_rng(SEED + 67), [WINDOW_SPAN], cfg.vocab_size)[0]
    long = (span * (-(-WINDOW_PROMPT // WINDOW_SPAN)))[:WINDOW_PROMPT]
    runs = {}
    for name, kw in (("release_off", dict(window_release=False)), ("release_on", {}),
                     ("ngram_release_on", dict(speculative=SpecConfig(num_draft_tokens=4)))):
        eng = family_engine(cfg, params, **kw)
        runs[name] = family_serve(eng, [long], WINDOW_TOKENS)
        del eng
        family_free()
    del params
    family_free()
    W, page = cfg.sliding_window, FAMILY_CACHE["block_size"]
    for r in runs.values():
        r["released_expected"] = (r["last_tokens"][0] - W) // page
    toks = runs["release_off"].pop("tokens")
    same = {k: runs[k].pop("tokens") == toks for k in ("release_on", "ngram_release_on")}
    on, spec = runs["release_on"], runs["ngram_release_on"]
    bf16 = family_bf16_gates(WINDOW_MODEL, WINDOW_PROMPT)
    ok = (all(r["finished"] for r in runs.values()) and all(same.values())
          and runs["release_off"]["launches_ok"] and on["launches_ok"]
          and runs["release_off"]["released_blocks"] == 0
          and on["released_blocks"] == on["released_expected"] > 0
          and spec["released_blocks"] == spec["released_expected"] > 0
          and spec["spec_steps"] > 0 and on["chunk_steps"] >= 3 and bf16["ok"])
    return {"ok": ok, "model": cfg.name, "weights_float32": made, "runs": runs,
            "same_tokens": same, "bf16": bf16, "launches": on["launches"]}


def family_exact(name: str, ps, tokens: int, bf16_long: int = 0) -> dict:
    """One family in float32 (TF32 off): the default engine and the plain
    attention's engine give the same greedy tokens; neither releases a
    block unless every layer is windowed.  Then its bf16 logit gates."""
    cfg = family_cfg(name, "float32")
    params, made = family_params(cfg)
    kern = family_serve(family_engine(cfg, params), ps, tokens)
    family_free()
    plain = family_serve(family_engine(cfg, params, plain=True), ps, tokens)
    del params
    family_free()
    same = kern.pop("tokens") == plain.pop("tokens")
    for k in ("launches", "launches_ok"):       # the plain engine launches no kernel
        plain.pop(k)
    bf16 = family_bf16_gates(name, bf16_long)
    release_ok = cfg.uniform_window or kern["released_blocks"] == plain["released_blocks"] == 0
    ok = (kern["finished"] and plain["finished"] and same and kern["launches_ok"]
          and release_ok and bf16["ok"])
    return {"ok": ok, "model": cfg.name, "head_dim": cfg.head_dim, "layers": cfg.num_layers,
            "weights_float32": made, "kernels": kern, "plain": plain, "same_tokens": same,
            "bf16": bf16, "launches": kern["launches"]}


def phase_families() -> dict:
    """Every model family the repo registers beside Qwen3, at full width
    and depth on the kernels: Qwen3-30B-A3B (MoE), Mistral-7B (the
    rolling-buffer release), Gemma-2-2B and Gemma-3-4B (softcaps,
    alternating and 5:1 windows past their windows, Gemma norms, 256K
    vocabularies), OPT-1.3B (layernorm, learned positions) and
    Phi-3-mini (head_dim 96).  Each model's weights are made on the card;
    the launches of the serving runs are summed for the kernel report."""
    import torch
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        out["moe"] = family_moe()
        out["window"] = family_window()
        for name, long_len, tokens in MIXED_WINDOW_FAMILIES:
            V = family_cfg(name, "float32").vocab_size
            long = prompts(np.random.default_rng(SEED + 68), [long_len], V)[0]
            out[name] = family_exact(name, [long], tokens, bf16_long=long_len)
        for name in SHORT_FAMILIES:
            V = family_cfg(name, "float32").vocab_size
            ps = prompts(np.random.default_rng(SEED + 69), MAIN_LENGTHS, V)
            out[name] = family_exact(name, ps, FAMILY_TOKENS)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        family_free()
    launches = {k: sum(v["launches"][k] for v in out.values()) for k in KERNELS}
    ok = (all(v["ok"] for v in out.values())
          and all(launches[k] > 0 for k in ("flash_prefill", "paged_decode", "paged_window")))
    return {"ok": ok, **out, "launches": launches}


# --------------------------------------------------------------------------
# breadth phase: MLA (DeepSeek-V2-Lite), int8 weights, LoRA and multi-LoRA

MLA_MODEL = "deepseek-ai/DeepSeek-V2-Lite"
# 5,120 tokens a sequence: the 4,096-token prompt, its prefix hit, their tokens
MLA_CACHE = dict(block_size=32, max_blocks_per_seq=160)
MLA_BLOCKS, MLA_TOKENS = 512, 64
MLA_LONG, MLA_HIT_KEEP, MLA_HIT_NEW, MLA_LONG_TOKENS = 4096, 4000, 200, 16
MLA_FP32_LAYERS = 4               # the dense first layer and 3 MoE layers
MLA_FP32_TOKENS = 32
MLA_FP32_GATE = 1e-3
# an int8 latent cache's decode step against the float32 cache's, float32
# model: one absmax scale over the 512-wide latent slice puts its half step
# at ~1/254 of the slice's largest value, ~4x a bf16 value's rounding (a
# bf16 cache: 0.035 on the CPU at 3 layers, int8 0.129), so twice the bf16
# logit gate.  On an H100 80GB HBM3 the sound cache reads 0.1409 and the
# planted faults that this gate must catch 2.14 (slices cut at 448) and
# 3.74 (scales swapped); one shared scale reads 0.1312, beside the sound
# one, so only the CPU test's hot rope channel catches that fault
INT8_CACHE_LOGIT_MAX = 2 * LOGIT_DIFF_MAX
MLA_CAUGHT_FAULTS = ("swapped_scales", "split_448")
# int8 Qwen3-30B-A3B's weight bytes against the families phase's bf16 ones
INT8_WEIGHT_SHARE = 0.52
LORA_MODEL, LORA_RANK, LORA_TOKENS, LORA_LONG = "Qwen/Qwen3-0.6B", 16, 32, 6000
LORA_SCALE = 0.02                 # the adapters' factors' standard deviation
LORA_BLOCKS, LORA_RATE_TOKENS, LORA_STREAM_TOKENS = 1024, 64, 32
LORA_SHORT = [128, 384, 640, 1024]
LORA_MODULES = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


def call(fn):
    return fn()


def mla_step(params, cfg, ps, nxt, cache_dtype: str, run_prefill=call, run_step=call):
    """One prefill over each prompt of ``ps`` followed by its token ``nxt``
    (the naive form: K and V decompressed) into a fresh cache of
    ``cache_dtype`` that keeps the prompt's latents and drops the token's
    (its slot is padding), then the absorbed decode step of that token over
    that cache (latent space, the pages read as K and V).  Every latent the
    step reads comes from the run that computed the naive logits, so the
    two differ by the token's own path alone.  ``run_prefill`` /
    ``run_step`` call their argument (``Routing.record`` / ``replay``
    there).  Returns (the prefill's last-row logits, the step's), (B, V)
    each."""
    import torch
    from tpuserve_torch.models import transformer
    from tpuserve_torch.ops.attention import PAD_SLOT
    from tpuserve_torch.runtime.kv_cache import CacheConfig, create_kv_cache
    B, T, page = len(ps), max(len(p) for p in ps) + 1, 32
    mb = T // page + 2
    cache = create_kv_cache(cfg, CacheConfig(block_size=page, num_blocks=B * mb,
                                             max_blocks_per_seq=mb, dtype=cache_dtype), "cuda")
    tokens = torch.zeros(B, T, dtype=torch.int32, device="cuda")
    slots = torch.full((B, T), PAD_SLOT, dtype=torch.int32, device="cuda")
    for i, (p, t) in enumerate(zip(ps, nxt.tolist())):
        tokens[i, :len(p) + 1] = torch.tensor(p + [t], dtype=torch.int32)
        slots[i, :len(p)] = torch.arange(len(p), dtype=torch.int32) + i * mb * page
    lens = torch.tensor([len(p) for p in ps], dtype=torch.int32, device="cuda")
    naive = run_prefill(lambda: transformer.prefill(params, cfg, tokens, lens + 1, slots,
                                                    cache)[0])
    bt = torch.arange(B * mb, dtype=torch.int32, device="cuda").view(B, mb)
    slot = lens + torch.arange(B, dtype=torch.int32, device="cuda") * mb * page
    step = run_step(lambda: transformer.decode_step(params, cfg, nxt.to(torch.int32), lens,
                                                    slot, bt, lens + 1, cache)[0])
    return naive, step


def mla_absorbed_vs_naive(params, cfg, ps, gate: float | None) -> dict:
    """The absorbed decode step against the naive form on the token each
    prompt's prefill picks (``mla_step``): free-running (top-1 agreement
    gated at 0.75, the difference a reading), and with every MoE layer's
    experts pinned to the naive run's choice for the token's row (the
    logits within ``gate``, or None: ``bf16_logit_gate`` of the naive
    logits).  The pinned step with a fault planted, its rope part dropped
    from the absorbed query, is read beside."""
    import torch
    from tpuserve_torch.models import transformer
    nxt = prefill_last_logits(params, cfg, ps, "reference").argmax(-1)
    route = Routing()
    naive, free = mla_step(params, cfg, ps, nxt, cfg.dtype, run_prefill=route.record)
    T = max(len(p) for p in ps) + 1
    rows = (torch.arange(len(ps), device=nxt.device) * T
            + torch.tensor([len(p) for p in ps], device=nxt.device))
    _, pinned = mla_step(params, cfg, ps, nxt, cfg.dtype,
                         run_step=lambda fn: route.replay(fn, rows))
    real = transformer._mla_absorb_q
    transformer._mla_absorb_q = lambda q_nope, q_rope, lp, c: real(
        q_nope, torch.zeros_like(q_rope), lp, c)
    try:
        _, bad = mla_step(params, cfg, ps, nxt, cfg.dtype,
                          run_step=lambda fn: route.replay(fn, rows))
    finally:
        transformer._mla_absorb_q = real
    max_abs = naive.abs().max().item()
    gate = bf16_logit_gate(max_abs) if gate is None else gate
    diff = (pinned - naive).abs().max().item()
    top1 = (free.argmax(-1) == naive.argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(free).all() and torch.isfinite(pinned).all())
    return {"ok": finite and diff <= gate and top1 >= 0.75, "rows": len(ps), "gate": gate,
            "pinned_routing_max_logit_diff": diff,
            "pinned_routing_top1_agreement": (pinned.argmax(-1) == naive.argmax(-1))
            .float().mean().item(),
            "free_running_max_logit_diff": (free - naive).abs().max().item(),
            "free_running_top1_agreement": top1,
            "rope_dropped_fault_max_logit_diff": (bad - naive).abs().max().item(),
            "max_abs_logit": max_abs,
            "routed_rows_moved": route.moved, "routed_rows": route.rows}


def planted_mla_write(fault: str):
    """``write_mla_entry`` with one fault planted in its int8 branch, to show
    what the int8 latent-cache gate catches at the phase's own shape:
    ``shared_scale`` one absmax scale over the whole 576-wide vector (as if
    the two slices shared it), ``swapped_scales`` each slice's scale stored
    in the other's place, ``split_448`` the slices cut 64 channels early
    (the pages then dequantize with the scales of the wrong slice)."""
    import torch
    from tpuserve_torch.ops import attention as attn_ops
    real = attn_ops.write_mla_entry

    def write(entry, latent, slots, latent_split=None, drop=None):
        if "ks" not in entry:
            return real(entry, latent, slots, latent_split, drop)
        if fault == "split_448":
            return real(entry, latent, slots, latent_split - 64, drop)
        lat = latent[..., None, :]
        if drop is None:
            drop = attn_ops.pad_drop(slots, entry["k"].shape[0] * entry["k"].shape[1])
        if fault == "shared_scale":
            q, s = attn_ops.quantize_kv(lat)
            scales = torch.cat([s, s], dim=-1)
        else:
            q1, s1 = attn_ops.quantize_kv(lat[..., :latent_split])
            q2, s2 = attn_ops.quantize_kv(lat[..., latent_split:])
            q, scales = torch.cat([q1, q2], dim=-1), torch.cat([s2, s1], dim=-1)
        attn_ops.write_kv_cache(entry["k"], q, slots, drop)
        attn_ops.write_kv_scales(entry["ks"], scales, slots, drop)
        return entry
    return real, write


MLA_PLANTED_FAULTS = ("shared_scale", "swapped_scales", "split_448")


def mla_int8_cache_logits(params, cfg, ps) -> dict:
    """The absorbed decode step (``mla_step``) over an int8 latent cache
    (two scales a token), a bf16 one and one in the model's float32, each
    layer's experts pinned to the float32 run's: the int8 step within
    INT8_CACHE_LOGIT_MAX of the float32 cache's, the exact one (the int8
    pages dequantize into float32; a bf16 cache's P.V runs in bf16, so its
    own rounding is reported beside, as is int8 against it), its top-1
    agreement at least 0.75.  The same int8 step with each fault of
    ``planted_mla_write``: those of MLA_CAUGHT_FAULTS read above the gate,
    the shared scale is a reading."""
    import torch
    from tpuserve_torch.ops import attention as attn_ops
    nxt = prefill_last_logits(params, cfg, ps, "reference").argmax(-1)
    route = Routing()
    out = {"float32": mla_step(params, cfg, ps, nxt, "float32", run_step=route.record)[1]}
    for dt in ("bfloat16", "int8"):
        out[dt] = mla_step(params, cfg, ps, nxt, dt,
                           run_step=lambda fn: route.replay(fn, None))[1]
    planted = {}
    for fault in MLA_PLANTED_FAULTS:
        real, write = planted_mla_write(fault)
        attn_ops.write_mla_entry = write
        try:
            bad = mla_step(params, cfg, ps, nxt, "int8",
                           run_step=lambda fn: route.replay(fn, None))[1]
        finally:
            attn_ops.write_mla_entry = real
        planted[fault] = (bad - out["float32"]).abs().max().item()

    def d(a, b):
        return (out[a] - out[b]).abs().max().item()
    diff = d("int8", "float32")
    top1 = (out["int8"].argmax(-1) == out["float32"].argmax(-1)).float().mean().item()
    caught = all(planted[f] > INT8_CACHE_LOGIT_MAX for f in MLA_CAUGHT_FAULTS)
    return {"ok": bool(torch.isfinite(out["int8"]).all()) and diff <= INT8_CACHE_LOGIT_MAX
            and top1 >= 0.75 and caught,
            "int8_vs_float32_max_logit_diff": diff, "gate": INT8_CACHE_LOGIT_MAX,
            "planted_faults_vs_float32_max_logit_diff": planted,
            "bf16_vs_float32_max_logit_diff": d("bfloat16", "float32"),
            "int8_vs_bf16_max_logit_diff": d("int8", "bfloat16"),
            "int8_top1_agreement": top1,
            "max_abs_logit": out["float32"].abs().max().item(), "routed_rows_moved": route.moved}


def mla_serve_long(eng, V: int) -> dict:
    """A 4,096-token prompt (its chunks), then one sharing its first 4,000
    tokens and 200 new ones (the prefix hit: one chunk over the uncached
    suffix), 16 greedy tokens each."""
    from tpuserve_torch.runtime import SamplingParams
    rng = np.random.default_rng(SEED + 71)
    long = prompts(rng, [MLA_LONG], V)[0]
    hit = long[:MLA_HIT_KEEP] + prompts(rng, [MLA_HIT_NEW], V)[0]
    sp = SamplingParams(max_tokens=MLA_LONG_TOKENS, temperature=0.0, ignore_eos=True)
    reset_launches()
    out = {}
    for name, p in (("long", long), ("hit", hit)):
        rid = eng.add_request(prompt_token_ids=p, params=sp)
        steps = drive(eng)
        req = eng.requests.pop(rid)
        chunks = [s for s in steps if s["kind"] == "chunk"]
        out[name] = {"prompt": len(p), "chunk_steps": len(chunks),
                     "chunk_rows": sum(s["computed"] for s in chunks),
                     "finished": req.finished and len(req.output_token_ids) == MLA_LONG_TOKENS,
                     "ttft_ms": ttft_ms(req)}
    out["launches"] = read_launches()
    out["ok"] = (out["long"]["finished"] and out["hit"]["finished"]
                 and out["long"]["chunk_steps"] >= 2
                 and 0 < out["hit"]["chunk_rows"] < out["hit"]["prompt"])
    return out


def mla_bounds(cfg, params, lens, tokens: int) -> dict:
    """The least time the card could take for DeepSeek-V2-Lite's prefill of
    ``lens`` (padded to a (B, max) batch: the naive form, every expert on
    every row, dense dispatch) and for one decode token step of B streams
    (the absorbed form: every weight but the embedding table read once,
    and the streams' latent pages at the middle of their decode), from
    shapes and the data-sheet peaks."""
    from tpuserve_torch.models.weights import param_nbytes
    H, L, Hd, V = cfg.num_heads, cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    r, nope, vd, lat = (cfg.mla_kv_lora_rank, cfg.mla_qk_nope_head_dim, cfg.mla_v_head_dim,
                        cfg.mla_latent_dim)
    E, I = cfg.num_experts, cfg.expert_intermediate_size
    dense, moe = cfg.moe_first_k_dense, L - cfg.moe_first_k_dense
    proj = 2 * Hd * cfg.q_size + 2 * Hd * lat + 2 * H * vd * Hd
    mlp = (moe * (2 * Hd * E + E * 6 * Hd * I + 6 * Hd * I * cfg.moe_shared_experts)
           + dense * 6 * Hd * cfg.intermediate_size)
    B, T = len(lens), max(lens)
    pre_row = L * (proj + 2 * r * H * (nope + vd)) + mlp
    pairs = sum(n * (n + 1) // 2 for n in lens)
    flops = B * T * pre_row + L * pairs * 2 * H * (cfg.head_dim + vd) + 2 * B * Hd * V
    ctx = sum(n + tokens // 2 for n in lens)
    dec_flops = B * (L * (proj + 2 * H * r * (nope + vd)) + mlp) + L * ctx * 4 * H * lat \
        + 2 * B * Hd * V
    w_bytes = param_nbytes(params) - param_nbytes(params["embed"])
    kv_bytes = ctx * L * lat * 2
    prefill_ms, prefill_by = bound(flops, w_bytes, "bfloat16")
    step_ms, step_by = bound(dec_flops, w_bytes + kv_bytes, "bfloat16")
    return {"prefill_tflop": flops / 1e12, "prefill_bound_ms": prefill_ms,
            "prefill_bound_by": prefill_by, "decode_step_bound_ms": step_ms,
            "decode_step_bound_by": step_by, "decode_bound_tok_per_s": B / step_ms * 1e3,
            "decode_step_gb": (w_bytes + kv_bytes) / 1e9, "kv_bytes_per_token": L * lat * 2}


def bf16_logit_gate(max_abs_logit: float) -> float:
    """LOGIT_DIFF_MAX's rule at a model's own logit scale: eight bf16 steps
    (twice four) at the largest |logit| (0.125 where |logits| reach 2-4,
    Qwen3-0.6B's; 0.25 at 4-8, DeepSeek-V2-Lite's ~5, whose absorbed step
    reads 0.1211 and 0.125 on two seeds, four steps of 0.03125)."""
    return 8 * 2.0 ** (math.floor(math.log2(max_abs_logit)) - 7)


def zero_launches(launches: dict) -> bool:
    return all(v == 0 for v in launches.values())


def breadth_mla_bf16() -> dict:
    """DeepSeek-V2-Lite (MLA with a 576-wide one-head latent cache, 64
    experts top-6 with 2 shared, the first layer dense), bf16, full width,
    8 of its 27 layers (``FAMILY_LAYERS``): the default engine (graphs, pipelined; the
    engine downgrades its attention to the plain one, MLA's only path)
    serves 8 prompts of the main lengths x 64 greedy tokens, the same
    tokens as the eager engine's; a chunked 4,096-token prompt and its
    prefix hit; the absorbed decode step against the naive form, on these
    weights and prompts and on a second seed's; no kernel launched by any
    of it.  In bf16 the absorbed step's gate bounds rounding over the layers
    (``bf16_logit_gate``: 0.25 at |logits| ~5); the check that catches a
    fault in the absorbed form is the float32 one of ``breadth_mla_fp32``
    (1e-3)."""
    from tpuserve_torch.runtime import Engine, EngineConfig
    cfg = family_cfg(MLA_MODEL, "bfloat16")
    params, made = family_params(cfg)
    V = cfg.vocab_size
    ps = prompts(np.random.default_rng(SEED + 70), MAIN_LENGTHS, V)
    eng = family_engine(cfg, params, blocks=MLA_BLOCKS, cache=MLA_CACHE)
    keys = [("prefill", 8, max(MAIN_LENGTHS)), ("decode", 8, "greedy")]
    capture_s = timed_host(lambda: eng.graphs.warmup(keys))
    run = family_serve(eng, ps, MLA_TOKENS)
    long = mla_serve_long(eng, V)
    made_keys = list(eng.graphs.executables)
    pool = {"pool_bytes": eng.graphs.pool_bytes(), "pool_bytes_bound":
            eng.graphs.pool_bound(made_keys),
            "executables": ["/".join(map(str, k)) for k in made_keys], "capture_s": capture_s}
    attn = {"requested": eng.config.attn_impl, "chosen": eng.attn_impl}
    del eng
    family_free()
    eager = family_serve(family_engine(cfg, params, plain=True, blocks=MLA_BLOCKS,
                                       cache=MLA_CACHE), ps, MLA_TOKENS)
    family_free()
    same = run.pop("tokens") == eager.pop("tokens")
    reset_launches()
    logits = mla_absorbed_vs_naive(params, cfg, ps, None)
    bounds = mla_bounds(cfg, params, MAIN_LENGTHS, MLA_TOKENS)
    del params
    family_free()
    params, _ = family_params(cfg, SEED + 1)
    second = mla_absorbed_vs_naive(params, cfg, prompts(np.random.default_rng(SEED + 74),
                                                        MAIN_LENGTHS, V), None)
    direct = read_launches()
    del params
    family_free()
    launches = {k: run["launches"][k] + eager["launches"][k] + long["launches"][k] + direct[k]
                for k in KERNELS}
    ok = (run["finished"] and eager["finished"] and same and long["ok"] and logits["ok"]
          and second["ok"] and zero_launches(launches) and attn["chosen"] == "reference"
          and pool["pool_bytes"] <= pool["pool_bytes_bound"])
    for r in (run, eager):
        r.pop("launches_ok")                     # held against the kernel count: 0 here
    return {"ok": ok, "model": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
            "attn_impl": attn, "weights": made, "cache_blocks": MLA_BLOCKS,
            "kv_bytes_per_token": bounds["kv_bytes_per_token"], **pool, "run": run,
            "eager": eager, "same_tokens_as_eager": same, "long": long,
            "prefill_ms": run["first_step_ms"], "decode_tok_per_s": run["decode_tok_per_s"],
            "bounds": bounds, "absorbed_vs_naive": logits,
            "absorbed_vs_naive_second_seed": second, "launches": launches}


def breadth_mla_fp32() -> dict:
    """DeepSeek-V2-Lite at full width in float32 (TF32 off), cut to its
    dense first layer and 3 MoE layers (the 62.8 GB of full depth leave no
    room): an engine asked for ``attn_impl="cuda"`` (downgraded) with
    graphs and the eager one give the same greedy tokens; the absorbed
    decode step against the naive form within 1e-3 (the trap for a fault
    in the absorbed form); an int8-cache engine
    serves, its decode step within INT8_CACHE_LOGIT_MAX of a float32
    cache's (``mla_int8_cache_logits``)."""
    cfg = dataclasses.replace(family_cfg(MLA_MODEL, "float32"), num_layers=MLA_FP32_LAYERS)
    params, made = family_params(cfg)
    ps = prompts(np.random.default_rng(SEED + 72), MAIN_LENGTHS, cfg.vocab_size)
    eng = family_engine(cfg, params, blocks=MLA_BLOCKS, cache=MLA_CACHE, attn_impl="cuda")
    chosen = eng.attn_impl
    graph = family_serve(eng, ps, MLA_FP32_TOKENS)
    del eng
    eager = family_serve(family_engine(cfg, params, plain=True, blocks=MLA_BLOCKS,
                                       cache=MLA_CACHE), ps, MLA_FP32_TOKENS)
    family_free()
    same = graph.pop("tokens") == eager.pop("tokens")
    int8_eng = family_engine(cfg, params, blocks=MLA_BLOCKS,
                             cache=dict(MLA_CACHE, dtype="int8"))
    int8_run = family_serve(int8_eng, ps, MLA_FP32_TOKENS)
    int8_run.pop("tokens")
    del int8_eng
    family_free()
    reset_launches()
    logits = mla_absorbed_vs_naive(params, cfg, ps, MLA_FP32_GATE)
    int8_logits = mla_int8_cache_logits(params, cfg, ps)
    direct = read_launches()
    del params
    family_free()
    launches = {k: graph["launches"][k] + eager["launches"][k] + int8_run["launches"][k]
                + direct[k] for k in KERNELS}
    for r in (graph, eager, int8_run):
        r.pop("launches_ok")
    ok = (graph["finished"] and eager["finished"] and same and int8_run["finished"]
          and logits["ok"] and int8_logits["ok"] and chosen == "reference"
          and zero_launches(launches))
    return {"ok": ok, "model": cfg.name, "dtype": "float32", "layers": cfg.num_layers,
            "attn_impl": {"requested": "cuda", "chosen": chosen}, "weights": made,
            "graph": graph, "eager": eager, "same_tokens": same, "int8_cache": int8_run,
            "absorbed_vs_naive": logits, "int8_cache_logits": int8_logits,
            "launches": launches}


def dequantized(p: dict, dtype) -> dict:
    """An int8 linear (or stacked experts) in ``dtype``, its scale applied;
    any other leaf dict as it is."""
    if "scale" not in p or "kernel" not in p:
        return p
    s = p["scale"][:, None, :] if p["kernel"].dim() == 3 else p["scale"][None, :]
    out = {"kernel": p["kernel"].to(dtype) * s.to(dtype)}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


class DequantizedLayers:
    """An int8 tree's layers dequantized into ``dtype`` one at a time as a
    forward walks them (only the layer in use exists in the model's
    dtype): the plain reference of an int8 model too large to hold twice."""

    def __init__(self, layers, dtype):
        self.layers, self.dtype = layers, dtype

    def __len__(self):
        return len(self.layers)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __getitem__(self, i):
        return {name: ({k: dequantized(v, self.dtype) for k, v in p.items()}
                       if name in ("experts", "shared") else dequantized(p, self.dtype))
                for name, p in self.layers[i].items()}


def int8_dequantized(params, dtype):
    """The int8 tree's plain reference: the layers lazily dequantized, the
    embedding and lm_head dequantized (a vocabulary each)."""
    emb = params["embed"]
    out = {"layers": DequantizedLayers(params["layers"], dtype),
           "embed": {"weight": emb["weight"].to(dtype) * emb["scale"][:, None].to(dtype)},
           "final_norm": params["final_norm"]}
    if "lm_head" in params:
        out["lm_head"] = dequantized(params["lm_head"], dtype)
    return out


def model_dtype_bytes(tree, itemsize: int = 2) -> int:
    """The bytes an int8 tree's model would hold in a ``itemsize``-byte
    dtype: every value but the quantization scales at that size (float32
    leaves, the router bias, at four)."""
    import torch
    if isinstance(tree, dict):
        quantized = "kernel" in tree or "weight" in tree
        return sum(model_dtype_bytes(v, itemsize) for k, v in tree.items()
                   if not (quantized and k == "scale"))
    if isinstance(tree, list):
        return sum(model_dtype_bytes(v, itemsize) for v in tree)
    return tree.numel() * (4 if tree.dtype == torch.float32 else itemsize)


def int8_bounds(cfg, params, lens, tokens: int) -> dict:
    """The least time the card could take for one decode token step of the
    int8 MoE model at B streams: reading each int8 weight once (what a fused
    int8 product would move), and what the port moves, each int8 weight
    read, written as a bf16 copy and that copy read (1 + 2 + 2 bytes) before
    its product; with the streams' K/V at the middle of their decode."""
    import torch
    from tpuserve_torch.models.weights import param_nbytes
    w_bytes = param_nbytes(params) - param_nbytes(params["embed"])

    def int8_values(t):
        if isinstance(t, dict):
            return sum(int8_values(v) for v in t.values())
        if isinstance(t, list):
            return sum(int8_values(v) for v in t)
        return t.numel() if t.dtype == torch.int8 else 0
    values = int8_values({"layers": params["layers"], "lm_head": params.get("lm_head", {})})
    L, B = cfg.num_layers, len(lens)
    kv = sum(n + tokens // 2 for n in lens) * 2 * L * cfg.num_kv_heads * cfg.head_dim * 2
    fused_ms, _ = bound(0, w_bytes + kv, "bfloat16")
    impl_ms, _ = bound(0, w_bytes + 4 * values + kv, "bfloat16")
    return {"int8_weight_values": values, "fused_step_bound_ms": fused_ms,
            "fused_bound_tok_per_s": B / fused_ms * 1e3, "dequant_step_gb":
            (w_bytes + 4 * values + kv) / 1e9, "dequant_step_bound_ms": impl_ms,
            "dequant_bound_tok_per_s": B / impl_ms * 1e3}


def breadth_int8(results) -> dict:
    """Qwen3-30B-A3B with int8 weights and bf16 activations: the tree made
    on the card and quantized one layer at a time (the peak allocation a
    reading beside the bf16 model's bytes), its bytes within
    INT8_WEIGHT_SHARE of the families phase's bf16 ones; the prefill logits
    against the dequantized bf16 weights (lazily, a layer at a time), experts
    pinned; an engine sized to the card (``num_blocks=0``), its prefill and
    decode steps captured, the pool under its bound, 8 prompts x 64 tokens,
    launches against the steps; decode tok/s beside the int8 bounds; the KV
    blocks it sized beside what the same free memory would give bf16
    weights."""
    import torch
    from tpuserve_torch.models.weights import (init_params_device, param_nbytes,
                                               quantize_layer_int8, quantize_params_int8)
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig
    from tpuserve_torch.runtime.graphs import Sizing, pool_bytes_bound
    from tpuserve_torch.runtime.kv_cache import num_blocks_for_budget
    cfg = family_cfg(MOE_MODEL, "bfloat16")
    torch.cuda.reset_peak_memory_stats()
    box = []
    init_s = timed_host(lambda: box.append(quantize_params_int8(init_params_device(
        cfg, SEED, "cuda", layer_fn=quantize_layer_int8))))
    params = box.pop()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bf16_gb = model_dtype_bytes(params) / 1e9
    w_gb = param_nbytes(params) / 1e9
    families = results.get("families", {}).get("moe", {})
    made = {"weights_gb": w_gb, "init_s": init_s, "peak_alloc_gb": peak_gb,
            "bf16_weights_gb": bf16_gb, "share": w_gb / bf16_gb,
            "families_bf16_weights_gb": families.get("weights", {}).get("weights_gb")}
    ps = prompts(np.random.default_rng(SEED + 73), MAIN_LENGTHS, cfg.vocab_size)
    route = Routing()
    ref = route.record(lambda: prefill_last_logits(int8_dequantized(params, torch.bfloat16),
                                                   cfg, ps, "cuda"))
    q = route.replay(lambda: prefill_last_logits(params, cfg, ps, "cuda"), None)
    free = prefill_last_logits(params, cfg, ps, "cuda")
    diff = (q - ref).abs().max().item()
    logits = {"ok": bool(torch.isfinite(q).all()) and diff <= LOGIT_DIFF_MAX
              and (free.argmax(-1) == ref.argmax(-1)).float().mean().item() >= 0.75,
              "pinned_routing_max_logit_diff": diff, "max_abs_logit": ref.abs().max().item(),
              "free_running_max_logit_diff": (free - ref).abs().max().item(),
              "free_running_top1_agreement": (free.argmax(-1) == ref.argmax(-1))
              .float().mean().item(), "routed_rows_moved": route.moved}
    del ref, q, free
    family_free()
    free0 = torch.cuda.mem_get_info()[0]
    eng = Engine(EngineConfig(model=cfg.name, seed=SEED, quantization="int8",
                              cache=CacheConfig(num_blocks=0, dtype=cfg.dtype, **FAMILY_CACHE)),
                 params=params, model_cfg=cfg, device="cuda")
    sched = eng.config.scheduler
    max_len = min(eng.cache_cfg.max_model_len, cfg.max_position_embeddings)
    all_keys = eng._step_keys(sched, max_len, guided=True)
    addressable = sched.max_num_seqs * (eng.cache_cfg.max_blocks_per_seq + 1)
    sz = eng.graphs.sizing
    bf16_free = (free0 - int((bf16_gb - w_gb) * 1e9)
                 - pool_bytes_bound(cfg, all_keys, eng._ragged_seqs, None,
                                    Sizing(ctx=sz.ctx, blk=sz.blk)))
    int8_free = free0 - pool_bytes_bound(cfg, all_keys, eng._ragged_seqs, None, sz)
    blocks = {"engine_sized": eng.cache_cfg.num_blocks, "addressable_cap": addressable,
              "int8_uncapped": num_blocks_for_budget(cfg, eng.cache_cfg, int8_free),
              "bf16_uncapped_derived": num_blocks_for_budget(cfg, eng.cache_cfg, bf16_free)}
    keys = [("prefill", 8, max(MAIN_LENGTHS)), ("decode", 8, "greedy")]
    capture_s = timed_host(lambda: eng.graphs.warmup(keys))
    run = family_serve(eng, ps, MOE_TOKENS)
    run.pop("tokens")
    made_keys = list(eng.graphs.executables)
    pool = {"pool_bytes": eng.graphs.pool_bytes(),
            "pool_bytes_bound": eng.graphs.pool_bound(made_keys), "capture_s": capture_s}
    bounds = int8_bounds(cfg, params, MAIN_LENGTHS, MOE_TOKENS)
    del eng, params
    family_free()
    ok = (made["share"] <= INT8_WEIGHT_SHARE and logits["ok"] and run["finished"]
          and run["launches_ok"] and pool["pool_bytes"] <= pool["pool_bytes_bound"])
    return {"ok": ok, "model": cfg.name, "weights": made, "prefill_logits": logits,
            "kv_blocks": blocks, **pool, "run": run, "prefill_ms": run["first_step_ms"],
            "decode_tok_per_s": run["decode_tok_per_s"],
            "bf16_decode_tok_per_s": families.get("decode_tok_per_s"),
            "bounds": bounds, "launches": run["launches"]}


def write_safetensors(path, tensors: dict) -> None:
    """float32 numpy ``tensors`` as one safetensors file (the format the
    port reads without the ``safetensors`` package)."""
    import struct
    header, off = {}, 0
    for name, a in tensors.items():
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [off, off + a.nbytes]}
        off += a.nbytes
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for a in tensors.values():
            f.write(np.ascontiguousarray(a, np.float32).tobytes())


def write_adapter(out_dir, cfg, seed: int, alpha: float, rslora: bool) -> str:
    """A synthetic PEFT adapter of rank LORA_RANK on all seven projections of
    every layer, its factors drawn from ``seed`` (standard deviation
    LORA_SCALE, a delta of about a tenth of a base projection's output):
    ``adapter_config.json`` and ``adapter_model.safetensors``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    h, r = cfg.hidden_size, LORA_RANK
    width = {"self_attn.q_proj": (h, cfg.q_size), "self_attn.k_proj": (h, cfg.kv_size),
             "self_attn.v_proj": (h, cfg.kv_size), "self_attn.o_proj": (cfg.q_size, h),
             "mlp.gate_proj": (h, cfg.intermediate_size),
             "mlp.up_proj": (h, cfg.intermediate_size),
             "mlp.down_proj": (cfg.intermediate_size, h)}
    tensors = {}
    for li in range(cfg.num_layers):
        for m in LORA_MODULES:
            i, o = width[m]
            pre = f"base_model.model.model.layers.{li}.{m}"
            tensors[f"{pre}.lora_A.weight"] = LORA_SCALE * rng.standard_normal(
                (r, i), dtype=np.float32)
            tensors[f"{pre}.lora_B.weight"] = LORA_SCALE * rng.standard_normal(
                (o, r), dtype=np.float32)
    write_safetensors(out_dir / "adapter_model.safetensors", tensors)
    (out_dir / "adapter_config.json").write_text(json.dumps(
        {"r": r, "lora_alpha": alpha, "use_rslora": rslora, "peft_type": "LORA",
         "target_modules": [m.rsplit(".", 1)[1] for m in LORA_MODULES]}))
    return str(out_dir)


def clone_tree(t):
    if isinstance(t, dict):
        return {k: clone_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [clone_tree(v) for v in t]
    return t.clone()


def lora_engine(cfg, params, **kw):
    """A default engine (graphs, pipelined) on its own copy of ``params``
    (a merge or a stack changes the tree it is given), prefix caching off
    so a repeated prompt recomputes."""
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig, SchedulerConfig
    sched = SchedulerConfig(**kw.pop("sched", {}))
    cache = CacheConfig(num_blocks=LORA_BLOCKS, dtype=cfg.dtype, **FAMILY_CACHE)
    return Engine(EngineConfig(model=cfg.name, seed=SEED, cache=cache, scheduler=sched,
                               enable_prefix_caching=False, **kw),
                  params=clone_tree(params), model_cfg=cfg, device="cuda")


def adapter_serve(eng, reqs, tokens: int) -> dict:
    """``reqs`` ((prompt, adapter or None) each) greedy, ``tokens`` each, the
    kernels' launches counted from 0 and held against the steps."""
    from tpuserve_torch.runtime import SamplingParams
    sp = SamplingParams(max_tokens=tokens, temperature=0.0, ignore_eos=True)
    reset_launches()
    rids = [eng.add_request(prompt_token_ids=p, params=sp, **({"adapter": a} if a else {}))
            for p, a in reqs]
    steps = drive(eng)
    launches = read_launches()
    done = [eng.requests.pop(r) for r in rids]
    dec = [s for s in steps if s["kind"] == "decode"]
    dec_tokens = sum(sum(s["decode_tokens"].values()) for s in dec)
    dec_s = sum(s["ms"] for s in dec) / 1e3
    return {"tokens": [r.output_token_ids for r in done],
            "finished": all(r.finished and len(r.output_token_ids) == tokens for r in done),
            "launches": launches,
            "launches_ok": launches == expected_launches(eng.model_cfg.num_layers, steps),
            "decode_tok_per_s": dec_tokens / dec_s if dec_s else None,
            "chunk_steps": sum(s["kind"] == "chunk" for s in steps),
            "mixed_steps": sum(s["kind"] == "mixed" for s in steps)}


def breadth_lora_fp32(adapters: dict) -> dict:
    """Qwen3-0.6B in float32 (TF32 off), the two adapters: the engine with
    ``a`` merged at load gives the stack engine's tokens on rows selecting
    ``a``; one batch of base, ``a`` and ``b`` rows and a 6,000-token ``a``
    prompt (chunked) gives each row's tokens run alone, on the phase-split
    stack engine and on the mixed one (``mixed_batching=True``), whose
    rows are held to the phase-split engine's alone runs."""
    cfg = family_cfg(LORA_MODEL, "float32")
    params, made = family_params(cfg)
    rng = np.random.default_rng(SEED + 74)
    short = prompts(rng, LORA_SHORT, cfg.vocab_size)
    long = prompts(rng, [LORA_LONG], cfg.vocab_size)[0]
    runs, launches = {}, {k: 0 for k in KERNELS}

    def serve(name, eng, reqs):
        res = adapter_serve(eng, reqs, LORA_TOKENS)
        runs[name] = {k: v for k, v in res.items() if k != "tokens"}
        for k in KERNELS:
            launches[k] += res["launches"][k]
        return res["tokens"]
    merged = serve("merged_a", lora_engine(cfg, params, lora_dir=adapters["a"]),
                   [(p, None) for p in short])
    family_free()
    stack = lora_engine(cfg, params, lora_modules=adapters)
    stacked_a = serve("stack_a", stack, [(p, "a") for p in short])
    batch = [(short[0], None), (short[1], "a"), (short[2], "b"), (short[3], "a"),
             (long, "a")]
    together = serve("stack_batch", stack, batch)
    alone = [serve(f"stack_alone_{i}", stack, [req])[0] for i, req in enumerate(batch)]
    del stack
    family_free()
    mixed = serve("mixed_batch", lora_engine(cfg, params, lora_modules=adapters,
                                             sched=dict(mixed_batching=True)), batch)
    del params
    family_free()
    gates = {"merged_equals_stack": merged == stacked_a, "batch_equals_alone": together == alone,
             "mixed_equals_alone": mixed == alone,
             "finished": all(r["finished"] for r in runs.values()),
             "launches_against_steps": all(r["launches_ok"] for r in runs.values()),
             "long_prompt_chunked": runs["stack_batch"]["chunk_steps"] > 0,
             "mixed_steps": runs["mixed_batch"]["mixed_steps"] > 0}
    return {"ok": all(gates.values()), **gates, "weights": made, "runs": runs,
            "launches": launches}


def breadth_lora_rates(adapters: dict) -> dict:
    """Decode tok/s of bf16 Qwen3-0.6B on the default engine, 8 prompts of
    the main lengths x 64 tokens: no stack against the two-adapter stack
    with the rows alternating ``a`` and ``b`` (their prefill and decode
    steps captured first)."""
    cfg = family_cfg(LORA_MODEL, "bfloat16")
    params, _ = family_params(cfg)
    ps = prompts(np.random.default_rng(SEED + 75), MAIN_LENGTHS, cfg.vocab_size)
    keys = [("prefill", 8, max(MAIN_LENGTHS)), ("decode", 8, "greedy")]
    out, launches = {}, {k: 0 for k in KERNELS}
    for name, kw, names in (("none", {}, [None] * 8),
                            ("stack", {"lora_modules": adapters}, ["a", "b"] * 4)):
        eng = lora_engine(cfg, params, **kw)
        capture_s = timed_host(lambda: eng.graphs.warmup(keys))
        res = adapter_serve(eng, list(zip(ps, names)), LORA_RATE_TOKENS)
        res.pop("tokens")
        out[name] = dict(res, capture_s=capture_s, pool_bytes=eng.graphs.pool_bytes(),
                         pool_bytes_bound=eng.graphs.pool_bound(list(eng.graphs.executables)))
        for k in KERNELS:
            launches[k] += res["launches"][k]
        del eng
        family_free()
    del params
    family_free()
    ok = all(r["finished"] and r["launches_ok"] and r["pool_bytes"] <= r["pool_bytes_bound"]
             for r in out.values())
    return {"ok": ok, **out, "stack_over_none": out["stack"]["decode_tok_per_s"]
            / out["none"]["decode_tok_per_s"], "launches": launches}


def breadth_lora_server(root, adapters: dict) -> dict:
    """``python -m tpuserve_torch.server --lora-modules a=DIR b=DIR`` (bf16
    Qwen3-0.6B from the seed, graphs captured on first use): 8 concurrent
    streams whose ``model`` fields alternate the base, ``a`` and ``b``,
    each complete and echoing the model it asked for; ``/v1/models``
    listing both adapters with the base as parent; an embeddings request
    naming an adapter refused with 400; then SIGTERM, which must end it
    with code 0 within its drain timeout."""
    import queue as queue_mod
    import signal
    import threading
    drain_timeout = 25.0
    cmd = [sys.executable, "-m", "tpuserve_torch.server", "--model", LORA_MODEL,
           "--host", "127.0.0.1", "--port", "0", "--no-warmup", "--max-num-seqs", "8",
           "--num-blocks", str(LORA_BLOCKS), "--drain-timeout", str(drain_timeout),
           "--device", "cuda", "--lora-modules"] + [f"{k}={v}" for k, v in adapters.items()]
    log = root / "build" / "breadth_lora_server.log"
    out = {"ok": False, "log": str(log.relative_to(root))}
    models = [LORA_MODEL, "a", "b"] * 3
    ps = prompts(np.random.default_rng(SEED + 76), MAIN_LENGTHS,
                 family_cfg(LORA_MODEL, "bfloat16").vocab_size)
    with open(log, "w") as err:
        proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            lines: "queue_mod.Queue[str]" = queue_mod.Queue()
            threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                             daemon=True).start()
            line = lines.get(timeout=300)
            if " listening on " not in line:
                out["stdout"] = line
                return out
            url = "http://127.0.0.1:" + line.strip().rsplit(":", 1)[1]
            _, listed = http(url + "/v1/models")
            res = [None] * len(ps)

            def one(i):
                res[i] = sse(url + "/v1/completions", {
                    "model": models[i], "prompt": ps[i], "max_tokens": LORA_STREAM_TOKENS,
                    "temperature": 0, "ignore_eos": True, "return_token_ids": True})
            threads = [threading.Thread(target=one, args=(i,)) for i in range(len(ps))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            emb_status, emb = http(url + "/v1/embeddings", {"model": "a", "input": "x"})
            streams = [{"model": models[i], "status": r.get("status"), "done": r["done"],
                        "tokens": len(stream_ids(r)),
                        "echoed": sorted({c["model"] for c in r["chunks"]})}
                       for i, r in enumerate(res)]
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=drain_timeout)
            listing = [(m["id"], m.get("parent")) for m in listed["data"]]
            out.update(
                streams=streams, models=listing, embeddings_status=emb_status,
                embeddings_error=(emb or {}).get("error", {}).get("message"), rc=rc,
                ok=(rc == 0 and emb_status == 400
                    and listing == [(LORA_MODEL, None), ("a", LORA_MODEL), ("b", LORA_MODEL)]
                    and all(s["status"] == 200 and s["done"]
                            and s["tokens"] == LORA_STREAM_TOKENS and s["echoed"] == [s["model"]]
                            for s in streams)))
        except (queue_mod.Empty, subprocess.TimeoutExpired) as e:
            out["error"] = repr(e)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def phase_breadth(results) -> dict:
    """The rest of the model breadth, at full width on the card: MLA with
    DeepSeek-V2-Lite (bf16 at 8 layers; float32 at 4), which the
    engine serves on the plain attention, so no kernel launches; int8
    Qwen3-30B-A3B on the flash prefill and paged decode kernels; LoRA
    (merged and stacked) on Qwen3-0.6B on all four kernels.  The kernels'
    launches of the int8 and LoRA runs are summed for the kernel report."""
    import torch
    from pathlib import Path
    root = Path(__file__).resolve().parent
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        out["mla"] = breadth_mla_bf16()
        out["mla_fp32"] = breadth_mla_fp32()
        out["int8"] = breadth_int8(results)
        cfg = family_cfg(LORA_MODEL, "float32")
        adir = root / "build" / "breadth_adapters"
        adapters = {"a": write_adapter(adir / "a", cfg, SEED + 80, alpha=32.0, rslora=False),
                    "b": write_adapter(adir / "b", cfg, SEED + 81, alpha=16.0, rslora=True)}
        out["lora"] = breadth_lora_fp32(adapters)
        out["lora_rates"] = breadth_lora_rates(adapters)
        out["lora_server"] = breadth_lora_server(root, adapters)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        family_free()
    counted = ("int8", "lora", "lora_rates")
    launches = {k: sum(out[p]["launches"][k] for p in counted) for k in KERNELS}
    ok = all(v["ok"] for v in out.values()) and all(v > 0 for v in launches.values())
    return {"ok": ok, **out, "launches": launches}


# --------------------------------------------------------------------------

KERNELS = {
    "flash_prefill": dict(source="tpuserve_torch/csrc/flash_prefill.cu",
                          replaces="tpuserve/ops/pallas_flash_attention.py:173"),
    "paged_decode": dict(source="tpuserve_torch/csrc/paged_decode.cu",
                         replaces="tpuserve/ops/pallas_paged_attention.py:420"),
    "paged_window": dict(source="tpuserve_torch/csrc/paged_window.cu",
                         replaces="tpuserve/ops/pallas_chunked_prefill.py:278"),
    "ragged_paged": dict(source="tpuserve_torch/csrc/ragged_paged.cu",
                         replaces="tpuserve/ops/pallas_ragged_attention.py:430"),
}


# --------------------------------------------------------------------------
# phase services: the native block manager and the device-coupled services

SERVICES_TOKENS = 64
SERVICES_ROUNDS = 3               # devprof on/off, interleaved
SERVICES_AB_TOKENS = 256          # a run's streams: mostly 8-row windows
SERVICES_SWAP_LENGTHS = [128, 384, 640]
SERVICES_SWAP_TOKENS = 32
# Llama-3.1-8B-Instruct at full width cut to SERVICES_8B_LAYERS of its 32
# layers (registered under this name at the phase's start): its checkpoint
# write and its cold and spill swaps took 73 s of the script's limit at
# full depth, and every swap path and gate is the same at 8
SERVICES_8B, SERVICES_8B_LAYERS = "meta-llama/Llama-3.1-8B-Instruct-8L", 8
SERVICES_POOL = ("Qwen/Qwen3-0.6B", SERVICES_8B)
SERVICES_HOST_BYTES = 2 << 30     # holds the 0.6B (1.2 GB), not the cut 8B (5.6 GB)
SERVICES_SWAP_MARGIN = 1 << 30    # card memory after the round trip, within
# the tenants: "slow" refills below one 8 x 1,024 + 64 request's estimate
SERVICES_TENANTS = {"tenants": {
    "slow": {"rate_tps": 200, "burst": 4000, "api_keys": ["sk-slow"]},
    "fast": {"rate_tps": 1e9, "api_keys": ["sk-fast"]}}}
# an objective the interactive traffic breaches: TTFT at 10 ms, the first
# edge of the TTFT histogram (a threshold must sit on an edge)
SERVICES_OBJECTIVES = [{"name": "interactive-ttft-10ms", "slo_class": "interactive",
                        "sli": "ttft", "objective": 0.99, "window_s": 3600,
                        "threshold_s": 0.01}]
TRACE_KERNELS = ("flash_prefill_bf16", "paged_decode_kernel", "paged_window_bf16")


def host_ms_a_step(eng) -> dict:
    """The median ms of each host phase of the engine's step records, by
    step kind (the flight recorder's ``phase_ms``, runtime/hostprof.py;
    "flush" is the wait on the card, "block" the block manager's calls)."""
    by: dict = {}
    for rec in eng.flight.steps_snapshot(512):
        if rec.get("phase_ms") and rec["kind"] != "idle":
            by.setdefault(rec["kind"], []).append(rec["phase_ms"])
    return {k: {"steps": len(v), **{ph: float(np.median([r.get(ph, 0.0) for r in v]))
                                   for ph in sorted({p for r in v for p in r})}}
            for k, v in by.items()}


def services_managers(results) -> dict:
    """The native block manager against the Python one on the main
    weights: the same greedy tokens on the main path's 8 prompts x 64;
    host ms a step of each (a reading; both runs before any profiler run
    of the phase, which would slow the launches that follow it)."""
    import torch
    from tpuserve_torch.native import NativeBlockManager
    from tpuserve_torch.runtime import Engine, EngineConfig, SamplingParams
    from tpuserve_torch.runtime.block_manager import BlockManager
    params = results["main"]["params"]
    V = results["main"]["engine"].model_cfg.vocab_size
    ps = prompts(np.random.default_rng(SEED + 21), MAIN_LENGTHS, V)
    sp = SamplingParams(max_tokens=SERVICES_TOKENS, temperature=0.0, ignore_eos=True)
    out, toks = {}, {}
    for impl, cls in (("native", NativeBlockManager), ("python", BlockManager)):
        os.environ["TPUSERVE_BLOCK_MANAGER"] = impl      # read at engine construction
        eng = Engine(EngineConfig(seed=SEED), params=params)
        del os.environ["TPUSERVE_BLOCK_MANAGER"]
        held = isinstance(eng.block_manager, cls)
        # the first run captures its buckets; the second hits the prefix
        # cache (the chunk route)
        toks[impl] = [r.output_token_ids for r in eng.generate(ps, sp)]
        t = time.perf_counter()
        toks[impl] += [r.output_token_ids for r in eng.generate(ps, sp)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        out[impl] = {"holds": held, "wall_s": wall, "host_ms_a_step": host_ms_a_step(eng)}
        del eng
        torch.cuda.empty_cache()
    out["same_tokens"] = toks["native"] == toks["python"]
    out["ok"] = out["native"]["holds"] and out["python"]["holds"] and out["same_tokens"]
    return out


def services_checkpoints(root) -> tuple:
    """Each SERVICES_POOL model's random weights, drawn on the card from a
    seed (``init_params_device``) and written as a bf16 HF checkpoint
    under ``build/``, so that the server's start and the pool's cold swap
    run the checkpoint loader: ``{name: dir}`` and each write's bytes and
    seconds."""
    import torch
    from tpuserve_torch.models.config import get_model_config
    from tpuserve_torch.models.weights import init_params_device
    dirs, writes = {}, {}
    for i, name in enumerate(SERVICES_POOL):
        cfg = get_model_config(name)
        d = root / "build" / "services_ckpt" / str(i)
        t = time.perf_counter()
        params = init_params_device(cfg, SEED + 90 + i, "cuda")
        nbytes_ = write_hf_checkpoint(params, cfg, d)
        del params
        torch.cuda.empty_cache()
        dirs[name] = str(d)
        writes[name] = {"bytes": nbytes_, "write_s": time.perf_counter() - t}
    return dirs, writes


def card_used() -> int:
    """The card's used bytes (``mem_get_info``) once the caching
    allocator has handed back the blocks no tensor or graph holds."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return total - free


def services_server(root, flight_dir, ckpts):
    """The CLI's server in process (``build_parser`` / ``engine_config`` /
    ``server_config``, as ``python -m tpuserve_torch.server`` builds it):
    Qwen3-0.6B bf16 from its checkpoint in ``ckpts``, the default
    scheduler, the tenants, the objective, the catalog (``ckpts``); and
    the card's used bytes just before the engine was made."""
    from tpuserve_torch.runtime import Engine
    from tpuserve_torch.server import OpenAIServer
    from tpuserve_torch.server.openai_api import build_parser, engine_config, server_config
    spill = root / "build" / "weight_spill"
    shutil.rmtree(spill, ignore_errors=True)
    args = build_parser().parse_args([
        "--model", SERVICES_POOL[0], "--checkpoint-dir", ckpts[SERVICES_POOL[0]],
        "--host", "127.0.0.1", "--port", "0",
        "--num-blocks", "1024", "--max-blocks-per-seq", "256",
        "--tenant-config", json.dumps(SERVICES_TENANTS),
        "--slo-objectives", json.dumps(SERVICES_OBJECTIVES),
        "--model-catalog", json.dumps(ckpts), "--max-resident-models", "1",
        "--weight-host-bytes", str(SERVICES_HOST_BYTES), "--weight-spill-dir", str(spill)])
    os.environ["TPUSERVE_FLIGHT_DIR"] = flight_dir
    base = card_used()
    t = time.perf_counter()
    eng = Engine(engine_config(args))
    srv = OpenAIServer(eng, server_config(args))
    url = f"http://127.0.0.1:{srv.start(warmup=True)}"
    return srv, url, time.perf_counter() - t, base


def concurrent(jobs) -> list:
    """Run the thunks ``jobs`` on threads; their results in order."""
    import threading
    res = [None] * len(jobs)

    def run(i, fn):
        res[i] = fn()
    threads = [threading.Thread(target=run, args=(i, fn)) for i, fn in enumerate(jobs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return res


def services_streams(url, ps, tokens, headers=None, **extra) -> dict:
    """``ps`` as concurrent streams: statuses, token ids, client decode
    tok/s."""
    t = time.perf_counter()
    res = concurrent([lambda p=p: sse(url + "/v1/completions", dict(
        {"prompt": p, "max_tokens": tokens, "temperature": 0, "ignore_eos": True,
         "return_token_ids": True}, **extra), headers=headers) for p in ps])
    wall = time.perf_counter() - t
    ok = all(r.get("status") == 200 and r["done"] for r in res)
    out = {"ok": ok, "wall_s": wall, "ids": [stream_ids(r) for r in res],
           "models": {c["model"] for r in res for c in r["chunks"]}}
    if ok:
        out.update(stream_rates(res))
    return out


def window_rate(eng, since: int) -> float | None:
    """Engine decode tok/s of the window steps recorded since the flight
    recorder's step cursor was ``since``: their real tokens over their
    wall (no prefill step and no capture in it: the decode ladder is
    captured at the server's start)."""
    n = eng.flight._steps.idx - since
    recs = [r for r in eng.flight.steps_snapshot(512)[-n:] if r["kind"] == "window"] if n else []
    ms = sum(r["ms"] for r in recs)
    return 1e3 * sum(r["actual_tokens"] for r in recs) / ms if ms else None


def services_devprof(srv, url, V, base_used: int) -> dict:
    """Decode tok/s with the device profiler on and off, interleaved over
    SERVICES_ROUNDS rounds (readings: the engine's over its window steps,
    and the clients'); then the checks: device seconds over the sync kinds
    positive and at most the steps' summed wall, one ladder entry a graph
    captured with the profiler on (the executables made in an off run,
    new batchings of the arrivals, are left out of it by design), the HBM
    watermark within 5% of the card's used bytes that the server added
    (``base_used``: the card's used bytes before its engine was made; the
    earlier phases' engines stay on the card).  The watermark's parts are
    counted apart: the weights from the tree, the KV from the cache, the
    rest from the allocator (the graphs' pool and buffers, the page
    staging) and, outside it, what the engine added (the graph
    executables); weights or KV miscounted by 5% of the server's bytes
    fail."""
    import torch
    eng, runner = srv.engine, srv.runner
    dp = eng.devprof
    step_wall = [0.0]
    feed = runner.on_step_time

    def on_step(s):
        step_wall[0] += s
        if feed is not None:
            feed(s)
    runner.on_step_time = on_step
    made = {"on": set(eng.graphs.executables), "off": set()}
    hook = eng.graphs.on_make

    def on_make(key, secs):
        made["on" if dp.enabled else "off"].add(key)
        hook(key, secs)
    eng.graphs.on_make = on_make

    def switch(on):
        dp.enabled = dp.cuda = on
        eng.flight.devprof = dp if on else None
    rates = {"on": [], "off": []}
    client = {"on": [], "off": []}
    served = True
    dev0, wall0 = sum(dp.sync_s.values()), 0.0
    rng = np.random.default_rng(SEED + 26)
    for _ in range(SERVICES_ROUNDS):
        for arm in ("on", "off"):
            runner.call(lambda arm=arm: switch(arm == "on"))
            since = eng.flight._steps.idx
            # fresh prompts each run: no prefix hit moves one arm's work
            res = services_streams(url, prompts(rng, MAIN_LENGTHS, V), SERVICES_AB_TOKENS)
            rates[arm].append(window_rate(eng, since))
            client[arm].append(res.get("decode_tok_per_s"))
            served &= res["ok"]
            if arm == "on":
                wall0 += step_wall[0]
            step_wall[0] = 0.0
    runner.call(lambda: switch(True))
    device_s = sum(dp.sync_s.values()) - dev0
    runner.call(eng.note_hbm)
    added = runner.call(card_used) - base_used
    hbm = dp.hbm_snapshot()
    mark = hbm["weights_bytes"] + hbm["kv_reserved_bytes"] + hbm["other_bytes"]
    graphs = eng.graphs.executables
    eng.graphs.on_make = hook
    ladder_keys = {key for _kind, key in dp.ladder}
    # every graph made with the profiler on has its entry; one made in an
    # off run gets one at its first dispatch with the profiler on (the JAX
    # ladder's first-call rule); no entry without a graph, none twice
    ladder_ok = (made["on"] <= ladder_keys <= set(graphs) == made["on"] | made["off"]
                 and len(dp.ladder) == len(ladder_keys) == dp.compiles
                 and all(e.graph is not None for e in graphs.values()))
    med = {k: float(np.median([r for r in v if r])) for k, v in rates.items()}
    return {"ok": served and 0 < device_s <= wall0 and ladder_ok
            and abs(mark - added) <= 0.05 * added,
            "decode_tok_per_s": rates, "median_tok_per_s": med,
            "overhead_share": 1 - med["on"] / med["off"], "client_decode_tok_per_s": client,
            "device_s_on": device_s, "step_wall_s_on": wall0,
            "device_s_by_kind": dict(dp.sync_s), "ladder_entries": len(dp.ladder),
            "captured_graphs": len(graphs), "made_with_profiler_off": len(made["off"]),
            "ladder_ok": ladder_ok,
            "hbm": hbm, "hbm_watermark": mark, "card_used_added": added,
            "card_used_before_server": base_used,
            "capture_ms_total": dp.compile_s * 1e3}


def trace_kernels(path) -> dict:
    """How often each of TRACE_KERNELS names an event of a Chrome trace."""
    with open(path) as f:
        trace = json.load(f)
    names = [ev.get("name", "") for ev in trace.get("traceEvents", ())]
    return {k: sum(1 for n in names if k in n) for k in TRACE_KERNELS}


def services_profile(srv, url, V) -> dict:
    """A 2 s ``/debug/profile`` capture while 8 streams decode and a
    6,000-token prompt chunks: the trace names the three kernels.  Then
    interactive requests breach the 10 ms TTFT objective: its fast burn
    fires and the auto-capture writes a second trace."""
    import threading
    rng = np.random.default_rng(SEED + 23)
    got = {}

    def capture():
        got["capture"] = http(url + "/debug/profile?seconds=2", {}, method="POST")
    streams, long = prompts(rng, MAIN_LENGTHS, V), prompts(rng, [6000], V)
    th = threading.Thread(target=capture)
    th.start()
    time.sleep(0.3)               # the capture's start is queued ahead of these
    load = concurrent([lambda: services_streams(url, streams, 128),
                       lambda: services_streams(url, long, 16)])
    th.join()
    status, cap = got["capture"]
    manual = trace_kernels(cap["trace"]) if status == 200 else {}
    dp = srv.engine.devprof
    before = dp.captures_total
    burst = services_streams(url, prompts(rng, [1024] * 12, V), 16,
                             headers={"X-SLO-Class": "interactive"})
    deadline = time.perf_counter() + 60
    while dp.captures_total == before and time.perf_counter() < deadline:
        time.sleep(0.2)
    auto = dp.captures[-1] if dp.captures_total > before else None
    auto_trace = (trace_kernels(f"{auto['trace_dir']}/trace.json")
                  if auto and os.path.exists(f"{auto['trace_dir']}/trace.json") else {})
    _, metrics = http(url + "/metrics")
    firing = metric_sum(metrics, "tpuserve_slo_alerts_firing")
    return {"ok": (status == 200 and all(manual.get(k, 0) > 0 for k in TRACE_KERNELS)
                   and all(r["ok"] for r in load) and burst["ok"] and auto is not None
                   and auto["reason"].startswith("slo-") and bool(auto_trace)
                   and firing >= 1),
            "manual": {"status": status, "trace_kernel_events": manual,
                       "trace_mb": os.path.getsize(cap["trace"]) / 1e6 if status == 200 else None},
            "auto": {"capture": auto, "trace_kernel_events": auto_trace,
                     "alerts_firing": firing}}


def services_nvml(srv, url) -> dict:
    """The NVML exporter against ``nvidia-smi``: the name and the power
    limit equal, the frame buffer used within 5%, the gauges on
    ``/metrics`` under the DCGM exporter's names."""
    exp = srv.gpu_exporter
    if exp is None:
        return {"ok": False, "error": "no NVML exporter on the card's machine"}
    reading = exp.collect_once()[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,memory.used",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    name, limit, used = (x.strip() for x in smi.split(","))
    _, metrics = http(url + "/metrics")
    exported = {fam: metric_sum(metrics, fam) for fam in (
        "DCGM_FI_DEV_FB_USED", "DCGM_FI_DEV_FB_TOTAL", "DCGM_FI_DEV_GPU_UTIL",
        "DCGM_FI_DEV_POWER_USAGE", "DCGM_FI_DEV_ENFORCED_POWER_LIMIT", "DCGM_FI_DEV_COUNT",
        "gpu_duty_cycle_percent")}
    ok = (reading["name"] == name and abs(reading["power_limit_w"] - float(limit)) < 0.5
          and abs(reading["fb_used_mib"] - float(used)) <= 0.05 * float(used)
          and exp.collections >= 1 and exported["DCGM_FI_DEV_FB_USED"] > 0
          and exported["DCGM_FI_DEV_ENFORCED_POWER_LIMIT"] == reading["power_limit_w"]
          and exported["DCGM_FI_DEV_COUNT"] >= 1)
    return {"ok": ok, "nvml": reading, "metrics": exported,
            "nvidia_smi": {"name": name, "power_limit_w": float(limit), "used_mib": float(used)}}


def services_tenants(url, V) -> dict:
    """Two tenants at once, 6 requests each: the 429s go to "slow" alone."""
    rng = np.random.default_rng(SEED + 24)
    ps = prompts(rng, [1024] * 6, V)
    body = {"max_tokens": SERVICES_TOKENS, "temperature": 0, "ignore_eos": True}
    res = concurrent([lambda p=p, who=who: http(url + "/v1/completions", dict(body, prompt=p),
                                                headers={"Authorization": f"Bearer sk-{who}"})
                      for who in ("slow", "fast") for p in ps])
    codes = {"slow": [r[0] for r in res[:6]], "fast": [r[0] for r in res[6:]]}
    _, metrics = http(url + "/metrics")
    limited = {who: sum(float(ln.rsplit(" ", 1)[1]) for ln in metrics.splitlines()
                        if ln.startswith("tpuserve_tenant_rate_limited_total{")
                        and f'tenant="{who}"' in ln)
               for who in ("slow", "fast")}
    return {"ok": (codes["fast"] == [200] * 6 and 429 in codes["slow"]
                   and set(codes["slow"]) <= {200, 429}
                   and limited["slow"] == codes["slow"].count(429) and limited["fast"] == 0),
            "codes": codes, "rate_limited": limited}


def services_pool(srv, url) -> dict:
    """The catalog {Qwen3-0.6B, Llama-3.1-8B-Instruct}, one resident, a
    2 GiB host tier: requests alternate by ``model`` through swaps from
    cold (the 8B's checkpoint, through the loader), the host tier (the
    0.6B) and the spill files (the 8B); each model's greedy tokens after a
    swap back equal its first ones, and the card's memory after the round
    trip is within SERVICES_SWAP_MARGIN of before."""
    import torch
    from tpuserve_torch.models.weights import param_nbytes
    pool, runner, eng = srv.pool, srv.runner, srv.engine
    rng = np.random.default_rng(SEED + 25)
    ps = prompts(rng, SERVICES_SWAP_LENGTHS, 50000)

    def used():
        def read():
            torch.cuda.synchronize()
            free, total = torch.cuda.mem_get_info()
            return total - free
        return runner.call(read)

    def allocator():
        return runner.call(lambda: {"allocated": torch.cuda.memory_allocated(),
                                    "reserved": torch.cuda.memory_reserved()})

    def serve(model):
        res = services_streams(url, ps, SERVICES_SWAP_TOKENS, model=model)
        return res["ok"] and res["models"] == {model}, res["ids"]

    def swap_events():
        return [d for _t, _rid, ev, d in eng.flight._events.snapshot() if ev == "SWAP"]
    mem0, alloc0 = used(), allocator()
    seen = len(swap_events())
    swaps = []
    order = (SERVICES_POOL[0], SERVICES_POOL[1], SERVICES_POOL[0], SERVICES_POOL[1],
             SERVICES_POOL[0])
    first, ok, flush_s = {}, True, None
    for i, model in enumerate(order):
        if i == 3:
            t = time.perf_counter()
            pool.tiers.flush()          # the 8B's spill files written: a real spill read
            flush_s = time.perf_counter() - t
        t = time.perf_counter()
        good, ids = serve(model)
        wall = time.perf_counter() - t
        ok &= good
        if model in first:
            ok &= ids == first[model]
        else:
            first[model] = ids
        if i:
            swaps.append({"to": model, "requests_wall_s": wall,
                          "bytes": runner.call(lambda: param_nbytes(eng.params))})
    # each swap's source tier and seconds, from the flight recorder's SWAP
    # events (the runner drains the stats' copy into the histogram)
    for rec, ev in zip(swaps, swap_events()[seen:]):
        rec.update(tier=ev["source_tier"], swap_s=ev["seconds"])
    by = dict(eng.stats.model_swaps_by_outcome)
    mem1, alloc1 = used(), allocator()
    want_tiers = ["cold", "host", "spill", "host"]
    return {"ok": (ok and [s["tier"] for s in swaps] == want_tiers
                   and abs(mem1 - mem0) <= SERVICES_SWAP_MARGIN),
            "swaps": swaps, "by_outcome": by, "spill_flush_s": flush_s,
            "card_used_before": mem0, "card_used_after": mem1,
            "allocator_before": alloc0, "allocator_after": alloc1,
            "same_tokens_after_swap_back": ok, "status": pool.status()}


def phase_services(results) -> dict:
    """See the module docstring, phase 19."""
    import gc
    import tempfile
    from pathlib import Path
    import torch
    from tpuserve_torch.native import NativeBlockManager
    root = Path(__file__).resolve().parent
    gc.collect()
    torch.cuda.empty_cache()
    out = {"free_gb_at_start": torch.cuda.mem_get_info()[0] / 1e9}
    t = time.perf_counter()
    out["managers"] = services_managers(results)
    out["managers_s"] = time.perf_counter() - t
    from tpuserve_torch.models.config import get_model_config, register_model_config
    register_model_config(dataclasses.replace(
        get_model_config("meta-llama/Llama-3.1-8B-Instruct"), name=SERVICES_8B,
        num_layers=SERVICES_8B_LAYERS))
    ckpts, out["checkpoints"] = services_checkpoints(root)
    flight_dir = tempfile.mkdtemp(prefix="services-flight-", dir=str(root / "build"))
    srv, url, start_s, base_used = services_server(root, flight_dir, ckpts)
    out["server_start_s"] = start_s
    eng = srv.engine
    V = eng.model_cfg.vocab_size
    try:
        out["native_held"] = isinstance(eng.block_manager, NativeBlockManager)
        reset_launches()
        t = time.perf_counter()
        out["devprof"] = services_devprof(srv, url, V, base_used)
        out["profile"] = services_profile(srv, url, V)
        out["launches"] = read_launches()
        out["nvml"] = services_nvml(srv, url)
        out["tenants"] = services_tenants(url, V)
        out["serve_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["pool"] = services_pool(srv, url)
        out["pool_s"] = time.perf_counter() - t
        # the idle share of a mixed step on the mixed phase's engine (the C++
        # manager, its flat-token ladder warmed), profiled last: a profiler
        # run slows the launches after it
        prof = profile_mixed(results["mixed"]["engine"], np.random.default_rng(SEED + 22))
        out["mixed_step"] = {k: prof.get(k) for k in ("wall_ms", "device_busy_ms",
                                                      "device_idle_share")}
        out["mixed_step"]["manager"] = type(results["mixed"]["engine"].block_manager).__name__
    finally:
        srv.shutdown()
        os.environ.pop("TPUSERVE_FLIGHT_DIR", None)
        if srv.pool is not None:
            srv.pool.tiers.clear()
        shutil.rmtree(flight_dir, ignore_errors=True)
        shutil.rmtree(root / "build" / "services_ckpt", ignore_errors=True)
    del srv, eng
    gc.collect()
    torch.cuda.empty_cache()
    la = out["launches"]
    out["ok"] = (out["native_held"] and out["managers"]["ok"]
                 and all(out[k]["ok"] for k in ("devprof", "profile", "nvml", "tenants", "pool"))
                 and la["flash_prefill"] > 0 and la["paged_decode"] > 0
                 and la["paged_window"] > 0)
    return out


FLEET_BLOCKS = 1024               # each replica's KV blocks
FLEET_PREFIX = 1024               # a prefix group's shared prompt tokens
FLEET_GROUPS = 4
FLEET_PER_GROUP = 4
FLEET_CONCURRENCY = 8
FLEET_MOVE = 8                    # streams on the replica removed from the file
FLEET_READMIT_S = 10.0            # the removed replica's readmission deadline
FLEET_STORM = dict(n=60, ramp_s=3.0, span_s=6.0, prompt_tokens=512, max_tokens=32)
FLEET_POOL = dict(step_time_s=0.05, control_interval_s=0.25, cold_start_s=1.0,
                  initial_replicas=1, max_num_seqs=2, max_waiting=12, block_size=32)
FLEET_POLICY = dict(min_replicas=1, max_replicas=3, scale_out_cooldown_s=2.0,
                    scale_in_cooldown_s=20.0, idle_in_s=10.0)
# a fleet stream's body, but for its prompt
FLEET_BODY = {"max_tokens": SERVER_TOKENS, "temperature": 0, "ignore_eos": True,
              "return_token_ids": True, "stream_options": {"include_usage": True}}


def fleet_replica(params):
    """One port replica in process: ``OpenAIServer`` over an engine on the
    main weights (drawn once, shared), 1,024 blocks, the default scheduler,
    nothing captured before it serves: each replica captures on first use
    while the other serves (the graphs' process-wide capture lock, F7)."""
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig
    from tpuserve_torch.server import OpenAIServer, ServerConfig
    eng = Engine(EngineConfig(seed=SEED, cache=CacheConfig(num_blocks=FLEET_BLOCKS)),
                 params=params)
    srv = OpenAIServer(eng, ServerConfig(host="127.0.0.1", port=0))
    return srv, f"http://127.0.0.1:{srv.start()}"


def fleet_keyed(gw, rng, V: int, n: int, target: str, length: int) -> list:
    """``n`` fresh prompts of ``length`` tokens whose rendezvous target among
    the gateway's backends is ``target``."""
    from tpuserve_torch.server.kv_digest import affinity_key
    out = []
    while len(out) < n:
        p = rng.integers(0, V, length).tolist()
        if gw._rendezvous_target(affinity_key({"prompt": p}), gw.backends).url == target:
            out.append(p)
    return out


def fleet_landed(srvs) -> dict:
    """prompt length -> the replica index whose flight recorder queued it."""
    out = {}
    for i, srv in enumerate(srvs):
        fl = srv.engine.flight
        for rid in fl.recent_request_ids(limit=4096):
            tl = fl.request_timeline(rid)
            if tl and tl[0]["event"] == "QUEUED":
                out.setdefault(tl[0]["detail"]["prompt_tokens"], set()).add(i)
    return out


def fleet_metric(url: str, name: str) -> float:
    _, text = http(url + "/metrics")
    return metric_sum(text, name)


def fleet_streams(gw_url: str, det_url: str, ps: list, conc: int) -> list:
    """``ps`` as streams through the gateway, ``conc`` at a time; each
    result with ``ok`` (``stream_ok`` against a replica's detokenizer)."""
    res = []
    for i in range(0, len(ps), conc):
        wave = ps[i:i + conc]
        got = concurrent([lambda p=p: sse(gw_url + "/v1/completions",
                                          dict(FLEET_BODY, prompt=p)) for p in wave])
        for r, p in zip(got, wave):
            r["ok"] = stream_ok(r, det_url, len(p))
        res += got
    return res


def fleet_status(gw_url: str) -> list:
    _, st = http(gw_url + "/gateway/status")
    return [[b["url"].rsplit(":", 1)[1], b["healthy"], b["outstanding"]]
            for b in st["backends"]]


def fleet_gateway(srvs, urls, gw, gw_url, bf, V: int) -> dict:
    """(a) 4 prefix groups, 2 keyed to each replica, through the gateway:
    every request on its rendezvous target, the prefix hits on /metrics,
    the streams, the launches against both engines' steps; then the
    backends file without replica 2 while 8 streams run on it, the next 8
    requests, and replica 2 back after a passing probe."""
    import threading
    rng = np.random.default_rng(SEED + 40)
    out = {"status": {"start": fleet_status(gw_url)}}
    # the groups: a 1,024-token prefix each, two keyed to each replica
    heads = fleet_keyed(gw, rng, V, 2, urls[0], FLEET_PREFIX) + \
        fleet_keyed(gw, rng, V, 2, urls[1], FLEET_PREFIX)
    suffix = rng.permutation(np.arange(64, 257))[:FLEET_GROUPS * FLEET_PER_GROUP]
    groups = [[heads[g] + rng.integers(0, V, int(suffix[g * FLEET_PER_GROUP + k])).tolist()
               for k in range(FLEET_PER_GROUP)] for g in range(FLEET_GROUPS)]
    want = {len(p): g // 2 for g in range(FLEET_GROUPS) for p in groups[g]}
    hits0 = [fleet_metric(u, "tpuserve_prefix_cache_hits_total") for u in urls]
    marks = [stat_marks(s.engine) for s in srvs]
    reset_launches()
    t = time.perf_counter()
    # each group's first request alone (they fill the cache), then the
    # other 12, 8 at a time: the 12 must hit
    res = fleet_streams(gw_url, urls[0], [g[0] for g in groups], FLEET_GROUPS)
    res += fleet_streams(gw_url, urls[0], [p for g in groups for p in g[1:]],
                         FLEET_CONCURRENCY)
    out["serve_s"] = time.perf_counter() - t
    launches = read_launches()
    expect = {k: 0 for k in launches}
    for s, m in zip(srvs, marks):
        for k, v in launches_since(s.engine, m).items():
            expect[k] += v
    landed = fleet_landed(srvs)
    out["misrouted"] = sum(1 for n, r in want.items() if landed.get(n) != {r})
    out["per_replica"] = [sum(1 for r in want.values() if r == i) for i in range(2)]
    out["prefix_hits"] = sum(fleet_metric(u, "tpuserve_prefix_cache_hits_total") for u in urls) \
        - sum(hits0)
    out["streams_ok"] = sum(r["ok"] for r in res)
    out["launches"], out["launches_expected"] = launches, expect
    out["rates"] = stream_rates(res) if all(r["ok"] for r in res) else None
    out["status"]["served"] = fleet_status(gw_url)
    # replica 2 leaves the backends file while 8 streams run on it
    moving = fleet_keyed(gw, rng, V, FLEET_MOVE, urls[1], 512)
    got: dict = {}
    threads = [threading.Thread(target=lambda i=i, p=p: got.__setitem__(
        i, sse(gw_url + "/v1/completions", dict(FLEET_BODY, prompt=p))))
        for i, p in enumerate(moving)]
    for th in threads:
        th.start()
    b2 = next(b for b in gw.backends if b.url == urls[1])
    deadline = time.perf_counter() + 60
    while b2.outstanding < FLEET_MOVE and time.perf_counter() < deadline:
        time.sleep(0.002)
    routed = b2.outstanding
    with open(bf, "w") as f:
        json.dump([urls[0]], f)
    reloaded = gw.reload_backends()
    out["in_flight_at_removal"] = sum(1 for i in range(FLEET_MOVE) if i not in got)
    out["status"]["removed"] = fleet_status(gw_url)
    # the next requests, any keys, told apart by their lengths
    nxt = [rng.integers(0, V, 520 + i).tolist() for i in range(FLEET_MOVE)]
    after = fleet_streams(gw_url, urls[0], nxt, FLEET_CONCURRENCY)
    for th in threads:
        th.join(timeout=600)
    landed = fleet_landed(srvs)
    moved_ok = [i in got and stream_ok(got[i], urls[0], len(p)) for i, p in enumerate(moving)]
    out["removal"] = {
        "routed_to_removed": routed, "reloaded": reloaded,
        "dropped": FLEET_MOVE - sum(moved_ok),
        "after_ok": sum(r["ok"] for r in after),
        "after_served": [sum(1 for p in nxt if i in landed.get(len(p), ())) for i in range(2)]}
    # replica 2 back: listed, then admitted by a passing probe
    with open(bf, "w") as f:
        json.dump(urls, f)
    t = time.perf_counter()
    gw.reload_backends()
    back = next(b for b in gw.backends if b.url == urls[1])
    listed_unhealthy = not back.healthy
    out["status"]["listed"] = fleet_status(gw_url)
    while not back.healthy and time.perf_counter() - t < FLEET_READMIT_S:
        time.sleep(0.05)
    out["readmit"] = {"listed_unhealthy": listed_unhealthy, "healthy": back.healthy,
                      "s": time.perf_counter() - t, "probe_failures": back.probe_failures}
    out["status"]["readmitted"] = fleet_status(gw_url)
    out["ok"] = (out["misrouted"] == 0 and out["per_replica"] == [8, 8]
                 and out["prefix_hits"] >= FLEET_GROUPS * (FLEET_PER_GROUP - 1)
                 and out["streams_ok"] == len(res)
                 and launches == expect and launches["flash_prefill"] > 0
                 and launches["paged_decode"] > 0 and launches["paged_window"] > 0
                 and routed == FLEET_MOVE and reloaded
                 and out["in_flight_at_removal"] == FLEET_MOVE
                 and out["removal"]["dropped"] == 0
                 and out["removal"]["after_ok"] == FLEET_MOVE
                 and out["removal"]["after_served"] == [FLEET_MOVE, 0]
                 and listed_unhealthy and back.healthy)
    return out


def fleet_replay(params, bundle) -> dict:
    """(b) Replica 1's bundle as a workload, replayed twice on the card at
    full width, then backtested twice with the default objectives."""
    from tpuserve_torch.obs import backtest
    from tpuserve_torch.replay import ReplayOptions, diff_report, replay, workload_from_bundle
    wl = workload_from_bundle(bundle, seed=SEED)
    opts = ReplayOptions(model="Qwen/Qwen3-0.6B", device="cuda", params=params,
                         include_token_streams=False)
    reset_launches()
    runs = [replay(wl, opts) for _ in range(2)]
    launches = read_launches()
    diff = diff_report(runs[0], wl)
    t = time.perf_counter()
    bts = [backtest(wl, replay_opts=opts) for _ in range(2)]
    bt_s = time.perf_counter() - t
    keep = ("virtual_s", "wall_s", "speedup", "step_time_s", "aborted", "token_digest",
            "sli_digest")
    out = {"workload": wl.summary(), "source_engine": wl.meta.get("source_engine"),
           "runs": [{k: r[k] for k in keep} | {"counters": r["counters"]} for r in runs],
           "source_outcomes": diff["source_outcomes"],
           "replay_outcomes": diff["replay_outcomes"], "launches": launches,
           "backtest": [{"firing_digest": b["firing_digest"], "alerts_fired": b["alerts_fired"],
                         "transitions": len(b["transitions"]),
                         "token_digest": b["replay"]["token_digest"]} for b in bts],
           "backtest_s": bt_s}
    out["ok"] = (not any(r["aborted"] for r in runs)
                 and runs[0]["token_digest"] == runs[1]["token_digest"]
                 and runs[0]["sli_digest"] == runs[1]["sli_digest"]
                 and diff["replay_outcomes"] == diff["source_outcomes"]
                 and sum(diff["source_outcomes"].values()) == len(wl.requests)
                 and json.dumps(bts[0]["transitions"], sort_keys=True)
                 == json.dumps(bts[1]["transitions"], sort_keys=True)
                 and bts[0]["firing_digest"] == bts[1]["firing_digest"]
                 and bts[0]["replay"]["token_digest"] == runs[0]["token_digest"]
                 and launches["flash_prefill"] > 0 and launches["paged_decode"] > 0)
    return out


def fleet_pool(params) -> dict:
    """(c) The storm through the simulated pool, autoscaled up to 3 replicas
    on the card, twice."""
    from tpuserve_torch.autoscale import (PolicyConfig, PoolReplayOptions, make_storm_workload,
                                          pool_replay)
    wl = make_storm_workload(**FLEET_STORM)
    opts = PoolReplayOptions(model="Qwen/Qwen3-0.6B", device="cuda", params=params,
                             **FLEET_POOL)
    reset_launches()
    runs = [pool_replay(wl, opts, PolicyConfig(**FLEET_POLICY)) for _ in range(2)]
    launches = read_launches()
    r = runs[0]
    keep = ("decision_digest", "token_digest", "first_scale_out_t", "first_shed_t",
            "first_l3_t", "replicas_peak", "cold_starts_observed_s", "virtual_s", "wall_s",
            "speedup", "counters", "aborted")
    out = {"workload": wl.summary(), "runs": [{k: x[k] for k in keep} for x in runs],
           "decisions": [[d["t"], d["action"], d["target"]] for d in r["decisions"]],
           "launches": launches}
    first = r["first_scale_out_t"]
    out["ok"] = (not any(x["aborted"] for x in runs)
                 and runs[0]["decision_digest"] == runs[1]["decision_digest"]
                 and runs[0]["token_digest"] == runs[1]["token_digest"]
                 and 1 < r["replicas_peak"] <= FLEET_POLICY["max_replicas"]
                 and first is not None
                 and all(first < s for s in (r["first_shed_t"], r["first_l3_t"])
                         if s is not None)
                 and launches["flash_prefill"] > 0 and launches["paged_decode"] > 0)
    return out


def phase_fleet(results) -> dict:
    """See the module docstring, phase 20."""
    import gc
    import tempfile
    from pathlib import Path
    import torch
    from tpuserve_torch.server.gateway import Gateway, GatewayConfig
    root = Path(__file__).resolve().parent
    params = results["main"]["params"]
    gc.collect()
    torch.cuda.empty_cache()
    out = {"free_gb_at_start": torch.cuda.mem_get_info()[0] / 1e9}
    work = Path(tempfile.mkdtemp(prefix="fleet-", dir=str(root / "build")))
    bf = str(work / "backends.json")
    t = time.perf_counter()
    srvs, urls = [], []
    gw = None
    try:
        for _ in range(2):
            srv, url = fleet_replica(params)
            srvs.append(srv)
            urls.append(url)
        with open(bf, "w") as f:
            json.dump(urls, f)
        gw = Gateway([], GatewayConfig(host="127.0.0.1", port=0, health_interval_s=0.5,
                                       backends_file=bf))
        gw_url = f"http://127.0.0.1:{gw.start()}"
        gw.probe_backends_once()
        out["start_s"] = time.perf_counter() - t
        t = time.perf_counter()
        V = srvs[0].engine.model_cfg.vocab_size
        out["gateway"] = fleet_gateway(srvs, urls, gw, gw_url, bf, V)
        out["gateway_s"] = time.perf_counter() - t
        out["launches"] = out["gateway"]["launches"]
        # each replica's seconds capturing on first use, under the
        # process-wide capture lock (F7)
        out["capture_s"] = [srv.engine.graphs.capture_s for srv in srvs]
        out["captures"] = [len(srv.engine.graphs.executables) for srv in srvs]
        # each replica's replays made while the other captured: captures
        # hold the capture lock only
        out["replays_beside_capture"] = [srv.engine.graphs.replays_beside_capture
                                         for srv in srvs]
        _, bundle = http(urls[0] + "/debug/engine/dump")
    finally:
        if gw is not None:
            gw.shutdown()
        for srv in srvs:
            srv.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    del srvs
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["replay"] = fleet_replay(params, bundle)
    out["replay_s"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["pool"] = fleet_pool(params)
    out["pool_s"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    out["ok"] = all(out[k]["ok"] for k in ("gateway", "replay", "pool"))
    return out


# --------------------------------------------------------------------------
# phase tp: tensor and expert parallel ranks in lockstep (parallel/)
# --------------------------------------------------------------------------

# (label, model, dtype, layers, tp, ep): full width, depth cut; each rank's
# weights drawn on the card from the seed
TP_RUNS = (("dense_fp32", "Qwen/Qwen2-72B-Instruct", "float32", 2, 4, 1),
           ("dense_bf16", "Qwen/Qwen2-72B-Instruct", "bfloat16", 4, 4, 1),
           ("moe_fp32", "Qwen/Qwen3-30B-A3B", "float32", 2, 1, 4),
           ("moe_bf16", "Qwen/Qwen3-30B-A3B", "bfloat16", 4, 1, 4))
TP_LENGTHS = [128, 256, 384, 512]
TP_TOKENS = 16
TP_HIT = 64                 # new tokens after the cached 512-token prompt: one chunk
TP_RATE_TOKENS = 64         # decode tok/s: 4 streams of 64 tokens (graphs only)
TP_CACHE = dict(block_size=32, num_blocks=256, max_blocks_per_seq=32)
TP_MULTI_STEP = 8
TP_WORKER = "--tp-worker"
TP_TIMEOUT_S = 300
TP_ALL_REDUCE_ITERS = 20
# the step kind whose runs launch each kernel, once a layer
KERNEL_KIND = {"flash_prefill": "prefill", "paged_decode": "decode",
               "paged_window": "chunk", "ragged_paged": "mixed"}


def tp_params(cfg, mesh):
    """The cut model's weights drawn on the card (``init_params_device``);
    under a mesh each rank draws each layer whole and keeps its slice, the
    ranks one after another, so the whole embedding and lm_head are on the
    card for one rank at a time."""
    import torch
    from tpuserve_torch.models.weights import init_params_device
    if mesh is None:
        return init_params_device(cfg, SEED, "cuda")
    import torch.distributed as dist
    from tpuserve_torch.parallel.sharding import RankSlicer
    sl = RankSlicer(mesh, num_layers=cfg.num_layers)
    params = None
    for r in range(mesh.world):
        if r == mesh.rank:
            params = sl.tree(init_params_device(cfg, SEED, mesh.device, layer_fn=sl.layer),
                             skip_layers=True)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    return params


def tp_engine(cfg, params, mesh, mixed: bool):
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig, SchedulerConfig
    return Engine(EngineConfig(model=cfg.name, seed=SEED,
                               cache=CacheConfig(dtype=cfg.dtype, **TP_CACHE),
                               multi_step=TP_MULTI_STEP,
                               scheduler=SchedulerConfig(max_num_seqs=8, mixed_batching=mixed,
                                                         mixed_token_budget=512)),
                  params=params, model_cfg=cfg, mesh=mesh, device="cuda")


def tp_serve(eng, cfg, mixed: bool, logits_path: str) -> dict:
    """Rank 0's (or the one-card reference's) work: the 4 prompts greedy
    and one sampled (seeded) request, their prefill's logits saved, then a
    prefix hit (one chunk); on the mixed engine the 4 prompts in mixed
    steps."""
    import torch
    from tpuserve_torch.runtime import SamplingParams
    rng = np.random.default_rng(SEED)
    ps = prompts(rng, TP_LENGTHS, cfg.vocab_size)
    greedy = SamplingParams(max_tokens=TP_TOKENS, temperature=0.0, ignore_eos=True)
    if mixed:
        reqs = eng.generate(ps, greedy)
        return {"tokens": [r.output_token_ids for r in reqs],
                "mixed_steps": eng.stats.num_mixed_steps}
    sampled = SamplingParams(max_tokens=TP_TOKENS, temperature=0.8, top_p=0.95, seed=3,
                             ignore_eos=True)
    reqs = eng.generate(ps + [ps[1]], [greedy] * len(ps) + [sampled])
    pre = next(e for k, e in eng.graphs.executables.items() if k[0] == "prefill")
    torch.save(pre.logits[:len(ps) + 1].float().cpu(), logits_path)
    hit = eng.generate([ps[-1] + rng.integers(0, cfg.vocab_size, TP_HIT).tolist()], greedy)
    return {"tokens": [r.output_token_ids for r in reqs + hit],
            "chunk_steps": eng.stats.num_chunk_steps}


def tp_rate(eng, cfg) -> float:
    """Decode tok/s of 4 streams of TP_RATE_TOKENS: the wall of a run
    with the tokens less that of the same prompts' prefill alone."""
    import torch
    from tpuserve_torch.runtime import SamplingParams
    ps = prompts(np.random.default_rng(SEED + 1), TP_LENGTHS, cfg.vocab_size)
    walls = []
    for n in (1, TP_RATE_TOKENS + 1, 1, TP_RATE_TOKENS + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.generate(ps, SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    # the second pair: every executable captured by the first
    return len(ps) * TP_RATE_TOKENS / (walls[3] - walls[2])


def tp_all_reduce_ms(mesh, cfg) -> float:
    """Ms of one of the step's all-reduces at a decode batch's rows: the tp
    sum of a (4, hidden) model-dtype tensor (two a layer), or the ep sum of
    the MoE layer's float32 (4, hidden) partial (one a layer)."""
    import torch
    import torch.distributed as dist
    tp = mesh.cfg.tp > 1
    x = torch.ones((len(TP_LENGTHS), cfg.hidden_size), device=mesh.device,
                   dtype=getattr(torch, cfg.dtype) if tp else torch.float32)
    op = mesh.comm.tp_sum if tp else mesh.comm.ep_sum
    op(x)
    torch.cuda.synchronize()
    dist.barrier()
    t = time.perf_counter()
    for _ in range(TP_ALL_REDUCE_ITERS):
        op(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / TP_ALL_REDUCE_ITERS


def tp_run(run, spec: dict, rank: int) -> dict:
    """One TP_RUNS entry on this process: the one-card reference (no mesh)
    or a rank of the spec's grid; each engine (phase-split, then mixed)
    served by rank 0 and followed by the others, launches counted."""
    import gc
    import torch
    from tpuserve_torch.models.config import get_model_config
    from tpuserve_torch.parallel.mesh import MeshConfig, make_mesh
    from tpuserve_torch.parallel.multihost import follower_loop
    label, model, dtype, layers, tp, ep = run
    cfg = dataclasses.replace(get_model_config(model), dtype=dtype, num_layers=layers)
    mesh, (tp, ep) = None, (1, 1) if spec["world"] == 1 else (tp, ep)
    if spec["world"] > 1:
        tp, ep = (min(tp, spec["world"]), 1) if tp > 1 else (1, min(ep, spec["world"]))
        mesh = make_mesh(MeshConfig(tp=tp, ep=ep), device_type="cuda",
                         devices=(["cuda:0"] * spec["world"] if spec["backend"] == "gloo"
                                  else None), timeout_s=TP_TIMEOUT_S)
    t = time.perf_counter()
    params = tp_params(cfg, mesh)
    out = {"init_s": time.perf_counter() - t, "tp": tp, "ep": ep, "engines": {}}
    lead = mesh is None or mesh.is_coordinator
    for mixed in (False, True):
        eng = tp_engine(cfg, params, mesh, mixed)
        reset_launches()
        t = time.perf_counter()
        if lead:
            if mesh is not None:
                eng._lockstep.record = True
            res = tp_serve(eng, cfg, mixed, f"{spec['out']}.{label}.rank{rank}.pt")
            if not mixed and spec["rate"] and dtype == "bfloat16":
                res["decode_tok_s"] = tp_rate(eng, cfg)
            # every window rank 0 ran, the rate's too: the followers ran them all
            res["recorded"] = ([t_.tolist() for t_ in eng._lockstep.tokens]
                               if mesh is not None else [])
            eng.stop_followers()
        else:
            res = {"recorded": [t_.tolist() for t_ in follower_loop(eng, record=True)]}
        torch.cuda.synchronize()
        res["seconds"] = time.perf_counter() - t
        res["launches"] = read_launches()
        res["expected"] = {k: layers * eng.graphs.replays[kind]
                           for k, kind in KERNEL_KIND.items()}
        res["graphs"] = eng.graphs.capture
        res["local"] = {"heads": eng.model_cfg.num_heads, "kv_heads": eng.model_cfg.num_kv_heads,
                        "experts": eng.model_cfg.num_experts,
                        "cache": list(eng.kv_cache[0]["k"].shape)}
        out["engines"]["mixed" if mixed else "split"] = res
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    if mesh is not None:
        out["all_reduce_ms"] = tp_all_reduce_ms(mesh, cfg)
        out["all_reduces_a_layer"] = 2 if mesh.cfg.tp > 1 else 1
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_worker(spec_path: str) -> int:
    """A spawned process of phases tp, pp, ring and train (``chip_smoke.py
    --tp-worker SPEC``, the spec's ``mode``): every TP_RUNS (PP_RUNS) entry,
    on one card without a mesh (world 1) or as a rank of the spec's grid
    over its backend, or a ring or train rank; writes its results."""
    import torch
    spec = json.loads(open(spec_path).read())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ.get("RANK", 0))
    if spec["world"] > 1:
        from tpuserve_torch.parallel.mesh import multihost_initialize
        multihost_initialize("cuda", backend=spec["backend"],
                             init_method=os.environ["TPUSERVE_INIT_METHOD"],
                             timeout_s=TP_TIMEOUT_S)
    mode = spec.get("mode", "tp")
    if mode == "ring":
        out = ring_rank(spec, rank)
    elif mode == "train":
        out = train_rank(spec, rank)
    else:
        runs, fn = (PP_RUNS, pp_run) if mode == "pp" else (TP_RUNS, tp_run)
        out = {run[0]: fn(run, spec, rank) for run in runs}
    with open(f"{spec['out']}.rank{rank}.json", "w") as f:
        json.dump(out, f)
    if spec["world"] > 1:
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
    return 0


def reference_run(work, rate: bool, mode: str = "tp") -> dict:
    """``tp_worker``'s one-card reference (world 1, no mesh) in this
    process, as a spawned rank would run it (TF32 off, restored after;
    its results through JSON, as the ranks' come), its memory freed before
    the ranks start; a process of its own would add its start-up."""
    import torch
    spec = {"world": 1, "backend": None, "rate": rate, "out": str(work / "ref"), "mode": mode}
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        runs, fn = (PP_RUNS, pp_run) if mode == "pp" else (TP_RUNS, tp_run)
        out = {run[0]: fn(run, spec, 0) for run in runs}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return json.loads(json.dumps(out))


def tp_spawn(work, label: str, world: int, backend, rate: bool, mode: str = "tp") -> tuple:
    """Run ``tp_worker`` in ``world`` processes through the launcher
    ``--tp`` uses (``multihost.spawn_ranks``: torchrun's variables, a
    file store, logs to files), killing every rank at TP_TIMEOUT_S.
    Returns (each rank's results or None, return codes, log tails)."""
    from tpuserve_torch.parallel import multihost
    spec = {"world": world, "backend": backend, "rate": rate, "out": str(work / label),
            "mode": mode}
    path = work / f"{label}.json"
    path.write_text(json.dumps(spec))
    procs = multihost.spawn_ranks([None, os.path.abspath(__file__), TP_WORKER, str(path)],
                                  world, str(work / f"{label}-logs"),
                                  f"file://{work / (label + '-store')}", ranks=range(world))
    rcs = multihost.stop_ranks(procs, TP_TIMEOUT_S)
    res, tails = [], {}
    for r in range(world):
        f = work / f"{label}.rank{r}.json"
        res.append(json.loads(f.read_text()) if f.exists() else None)
        if rcs[r] != 0:
            tails[r] = (work / f"{label}-logs" / f"rank{r}.log").read_text()[-3000:]
    return res, rcs, tails


def tp_gates(work, ref, ranks, rcs, label: str) -> dict:
    """Each run's checks against the one-card reference: float32 tokens
    equal (the greedy and sampled streams, the prefix hit, the mixed
    steps), bf16 first-step logits within ``bf16_logit_gate`` with top-1
    >= 0.75, the followers' recorded window tokens equal rank 0's, every
    rank's launches equal layers x its runs of each step kind (all four
    kernels on the dense grid), every rank exiting 0."""
    import torch
    out = {"ranks": len(ranks), "rcs": rcs}
    oks = [all(rc == 0 for rc in rcs.values()) and all(r is not None for r in ranks)]
    if not oks[0]:
        out["ok"] = False
        return out
    lead = ranks[0]
    for run in TP_RUNS:
        name, dtype = run[0], run[2]
        r0, rf = lead[name], ref[name]
        row = {"tp": r0["tp"], "ep": r0["ep"], "init_s": r0["init_s"],
               "all_reduce_ms": r0["all_reduce_ms"],
               "all_reduce_ms_a_layer": r0["all_reduce_ms"] * r0["all_reduces_a_layer"],
               "local": r0["engines"]["split"]["local"]}
        for kind in ("split", "mixed"):
            a, b = r0["engines"][kind], rf["engines"][kind]
            same = [x == y for x, y in zip(a["tokens"], b["tokens"])]
            row[f"{kind}_tokens_equal"] = f"{sum(same)}/{len(same)}"
            # the split engine's streams: 4 greedy, the sampled one, the hit
            row[f"{kind}_first_diff"] = [first_diff(x, y) for x, y in zip(a["tokens"],
                                                                          b["tokens"])]
            row[f"{kind}_s"] = a["seconds"]
            row[f"{kind}_ref_s"] = b["seconds"]
            if dtype == "float32":
                greedy = [s for i, s in enumerate(same) if kind == "mixed" or i != len(TP_LENGTHS)]
                oks.append(all(greedy))
            row[f"{kind}_followers_equal"] = all(
                r[name]["engines"][kind]["recorded"] == a["recorded"] for r in ranks[1:])
            oks.append(row[f"{kind}_followers_equal"]
                       and (kind == "mixed" or bool(a["recorded"])))
            launches = [r[name]["engines"][kind]["launches"] for r in ranks]
            expected = [r[name]["engines"][kind]["expected"] for r in ranks]
            row[f"{kind}_launches"] = launches
            oks.append(launches == expected)
        row["chunk_steps"] = r0["engines"]["split"]["chunk_steps"]
        row["mixed_steps"] = r0["engines"]["mixed"]["mixed_steps"]
        oks.append(row["chunk_steps"] > 0 and row["mixed_steps"] > 0)
        if r0["tp"] > 1:
            # the dense grid: every rank launched all four kernels
            oks.append(all(sum(r[name]["engines"][k]["launches"][n] for k in ("split", "mixed"))
                           > 0 for r in ranks for n in KERNEL_KIND))
        if dtype == "bfloat16":
            got = torch.load(f"{work / label}.{name}.rank0.pt")
            want = torch.load(f"{work / 'ref'}.{name}.rank0.pt")
            gate = bf16_logit_gate(want.abs().max().item())
            row["logits_max_abs_diff"] = (got - want).abs().max().item()
            row["logits_gate"] = gate
            row["top1"] = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
            oks.append(row["logits_max_abs_diff"] <= gate and row["top1"] >= 0.75)
            if "decode_tok_s" in r0["engines"]["split"]:
                row["decode_tok_s"] = r0["engines"]["split"]["decode_tok_s"]
            row["ref_decode_tok_s"] = rf["engines"]["split"].get("decode_tok_s")
        out[name] = row
    out["launches"] = {n: sum(r[run[0]]["engines"][k]["launches"][n] for r in ranks
                              for run in TP_RUNS for k in ("split", "mixed"))
                       for n in KERNEL_KIND}
    out["ok"] = all(oks)
    return out


def tp_local_kernels() -> dict:
    """Each kernel held against its plain version and timed at a tp 4
    rank's shapes of Qwen2-72B (16 q heads, 2 kv heads: G 8) and of this
    phase's work: the 4-prompt prefill, a 4-row decode step over 512-1,024
    keys, the prefix hit's 64-row chunk over 512 cached keys, a mixed step
    of 4 decode rows and a 256-row chunk."""
    import torch
    Hq, Hkv, D = 64 // 4, 8 // 4, 128
    from tpuserve_torch.ops.ragged_paged import ragged_block
    blk = ragged_block(torch.device("cuda"))
    cases = {
        "flash_prefill": flash_case("bfloat16", 4, 512, Hq, Hkv, D, TP_LENGTHS),
        "paged_decode": paged_case("bfloat16", 4, Hq, Hkv, D, 32, 32,
                                   [n + TP_TOKENS for n in TP_LENGTHS]),
        "paged_window": window_case("bfloat16", 1, TP_HIT, Hq, Hkv, D, 32, [512], [TP_HIT]),
        "ragged_paged": ragged_case("bfloat16", [n + 8 for n in TP_LENGTHS], [(256, 256)],
                                    blk, Hq=Hq, Hkv=Hkv, D=D),
    }
    keep = ("case", "ok", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {n: {k: c.get(k) for k in keep} for n, c in cases.items()}


def phase_tp(results) -> dict:
    """See the module docstring, phase tp."""
    import gc
    import tempfile
    from pathlib import Path
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    work = Path(tempfile.mkdtemp(prefix="tp-", dir=str(root / "build")))
    out = {"free_gb_at_start": torch.cuda.mem_get_info()[0] / 1e9}
    t = time.perf_counter()
    out["local_kernels"] = tp_local_kernels()
    out["local_kernels_s"] = time.perf_counter() - t
    oks = [all(c["ok"] for c in out["local_kernels"].values())]
    t = time.perf_counter()
    ref = reference_run(work, rate=True)
    out["ref_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ranks, rcs, tails = tp_spawn(work, "gloo", 4, "gloo", rate=False)
    out["gloo"] = tp_gates(work, ref, ranks, rcs, "gloo")
    out["gloo"]["seconds"] = time.perf_counter() - t
    if tails:
        out["gloo"]["logs"] = tails
    oks.append(out["gloo"]["ok"])
    out["launches"] = out["gloo"]["launches"]
    count = torch.cuda.device_count()
    if count >= 2:
        t = time.perf_counter()
        ranks, rcs, tails = tp_spawn(work, "nccl", min(4, count), "nccl", rate=True)
        out["nccl"] = tp_gates(work, ref, ranks, rcs, "nccl")
        out["nccl"]["seconds"] = time.perf_counter() - t
        if tails:
            out["nccl"]["logs"] = tails
        oks.append(out["nccl"]["ok"])
    else:
        out["nccl"] = f"not run: {count} card"
    shutil.rmtree(work, ignore_errors=True)
    out["ok"] = all(oks)
    return out


# --------------------------------------------------------------------------
# phase pp: pipeline stages (parallel/pipeline.py)
# --------------------------------------------------------------------------

# (label, model, dtype, layers): full width, depth cut; each stage's layers
# drawn on the card from the seed (stage 0 also keeps the head)
PP_RUNS = (("dense_fp32", "Qwen/Qwen2-72B-Instruct", "float32", 4),
           ("dense_bf16", "Qwen/Qwen2-72B-Instruct", "bfloat16", 8))
PP_STAGES = 4
# the step kind whose microbatches launch each kernel, once a stage's layer
PP_KERNEL_KIND = {"flash_prefill": "prefill", "paged_decode": "decode"}
# prefill tokens a step: the JAX pipeline engine's intake budget (1 GiB of
# float32 scores at a prompt's bucket, kept) admits 64-head prompts of up
# to 1,024 tokens two rows at a time; the reference closes the chunk route
# too, so its prefix hits prefill batched as the stages' do
PP_PREFILL_TOKENS = 2048


def pp_engine(cfg, params, mesh, **kw):
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig, SchedulerConfig
    return Engine(EngineConfig(model=cfg.name, seed=SEED, **kw,
                               cache=CacheConfig(dtype=cfg.dtype, **TP_CACHE),
                               multi_step=TP_MULTI_STEP,
                               scheduler=SchedulerConfig(max_num_seqs=8,
                                                         max_prefill_tokens=PP_PREFILL_TOKENS,
                                                         allow_chunked_prefill=False)),
                  params=params, model_cfg=cfg, mesh=mesh, device="cuda")


def pp_run(run, spec: dict, rank: int) -> dict:
    """One PP_RUNS entry on this process: the one-card reference (no mesh)
    or a stage of a pp grid over the spec's backend; the engine served by
    rank 0 (tp_serve's requests: the prefix hit prefills batched, as every
    prompt under pp) and followed by the others, launches counted against
    the microbatches each stage ran."""
    import gc
    import torch
    from tpuserve_torch.models.config import get_model_config
    from tpuserve_torch.models.weights import param_nbytes
    from tpuserve_torch.parallel.mesh import MeshConfig, make_mesh
    from tpuserve_torch.parallel.multihost import follower_loop
    label, model, dtype, layers = run
    cfg = dataclasses.replace(get_model_config(model), dtype=dtype, num_layers=layers)
    mesh = None
    if spec["world"] > 1:
        mesh = make_mesh(MeshConfig(pp=spec["world"]), device_type="cuda",
                         devices=(["cuda:0"] * spec["world"] if spec["backend"] == "gloo"
                                  else None), timeout_s=TP_TIMEOUT_S)
    t = time.perf_counter()
    params = tp_params(cfg, mesh)
    out = {"init_s": time.perf_counter() - t, "pp": spec["world"]}
    eng = pp_engine(cfg, params, mesh)
    stage = mesh.stage if mesh is not None else None
    counts0 = stage.counts.copy() if stage is not None else None
    reset_launches()
    t = time.perf_counter()
    if mesh is None or mesh.is_coordinator:
        if mesh is not None:
            eng._lockstep.record = True
        res = tp_serve(eng, cfg, False, f"{spec['out']}.{label}.rank{rank}.pt")
        if spec["rate"] and dtype == "bfloat16":
            res["decode_tok_s"] = tp_rate(eng, cfg)
            if mesh is None:
                # the stages run eagerly: one card eager beside its graphs
                res["decode_tok_s_eager"] = tp_rate(
                    pp_engine(cfg, params, None, cuda_graphs=False), cfg)
        res["windows"] = ([list(w.shape) for w in eng._lockstep.tokens]
                          if mesh is not None else [])
        if mesh is not None:
            eng.stop_followers()
    else:
        res = {"windows": [list(w.shape) for w in follower_loop(eng, record=True)]}
    torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - t
    res["launches"] = read_launches()
    if stage is None:
        res["expected"] = {k: layers * eng.graphs.replays[kind] for k, kind in KERNEL_KIND.items()}
    else:
        ran = stage.counts - counts0
        res["microbatches"] = {k: ran[k] for k in PP_KERNEL_KIND.values()}
        res["transfers"] = ran["sent"]
        res["expected"] = {k: (layers // spec["world"]) * ran[PP_KERNEL_KIND[k]]
                           if k in PP_KERNEL_KIND else 0 for k in KERNEL_KIND}
    res["graphs"] = eng.graphs.capture
    res["layers_here"] = len(eng.kv_cache)
    res["head_here"] = "embed" in eng.params
    res["weight_gb"] = param_nbytes(eng.params) / 1e9
    out["engine"] = res
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pp_gates(work, ref, ranks, rcs, label: str) -> dict:
    """Each run's checks against the one-card reference: float32 greedy
    tokens equal (4 prompts and the prefix hit), bf16 first-step logits
    within ``bf16_logit_gate`` with top-1 >= 0.75, every stage's windows
    equal rank 0's, every stage's flash-prefill and paged-decode launches
    equal its layers x the microbatches it ran (and > 0), the head on stage
    0 alone, every rank exiting 0."""
    import torch
    out = {"ranks": len(ranks), "rcs": rcs}
    oks = [all(rc == 0 for rc in rcs.values()) and all(r is not None for r in ranks)]
    if not oks[0]:
        out["ok"] = False
        return out
    for run in PP_RUNS:
        name, dtype = run[0], run[2]
        a, b = ranks[0][name]["engine"], ref[name]["engine"]
        same = [x == y for x, y in zip(a["tokens"], b["tokens"])]
        row = {"init_s": ranks[0][name]["init_s"], "seconds": a["seconds"],
               "ref_seconds": b["seconds"], "tokens_equal": f"{sum(same)}/{len(same)}",
               "first_diff": [first_diff(x, y) for x, y in zip(a["tokens"], b["tokens"])],
               "microbatches": [r[name]["engine"]["microbatches"] for r in ranks],
               "transfers": [r[name]["engine"]["transfers"] for r in ranks],
               "weight_gb": [r[name]["engine"]["weight_gb"] for r in ranks],
               "graphs": a["graphs"]}
        if dtype == "float32":
            oks.append(all(s for i, s in enumerate(same) if i != len(TP_LENGTHS)))
        row["windows_equal"] = all(r[name]["engine"]["windows"] == a["windows"]
                                   for r in ranks[1:]) and bool(a["windows"])
        oks.append(row["windows_equal"])
        launches = [r[name]["engine"]["launches"] for r in ranks]
        expected = [r[name]["engine"]["expected"] for r in ranks]
        row["launches"] = launches
        oks.append(launches == expected and all(
            x[k] > 0 for x in launches for k in PP_KERNEL_KIND))
        oks.append([r[name]["engine"]["head_here"] for r in ranks]
                   == [True] + [False] * (len(ranks) - 1))
        if dtype == "bfloat16":
            got = torch.load(f"{work / label}.{name}.rank0.pt")
            want = torch.load(f"{work / 'ref'}.{name}.rank0.pt")
            gate = bf16_logit_gate(want.abs().max().item())
            row["logits_max_abs_diff"] = (got - want).abs().max().item()
            row["logits_gate"] = gate
            row["top1"] = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
            oks.append(row["logits_max_abs_diff"] <= gate and row["top1"] >= 0.75)
            row["decode_tok_s"] = a.get("decode_tok_s")
            row["ref_decode_tok_s"] = b.get("decode_tok_s")
            row["ref_eager_decode_tok_s"] = b.get("decode_tok_s_eager")
        out[name] = row
    out["launches"] = {n: sum(r[run[0]]["engine"]["launches"][n] for r in ranks for run in PP_RUNS)
                       for n in KERNEL_KIND}
    out["ok"] = all(oks)
    return out


def phase_pp(results) -> dict:
    """See the module docstring, phase pp."""
    import gc
    import tempfile
    from pathlib import Path
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    work = Path(tempfile.mkdtemp(prefix="pp-", dir=str(root / "build")))
    out = {}
    t = time.perf_counter()
    count = torch.cuda.device_count()
    # the reference's decode rates are the NCCL stages' yardstick
    ref = reference_run(work, rate=count >= 2, mode="pp")
    out["ref_s"] = time.perf_counter() - t
    oks = []
    t = time.perf_counter()
    ranks, rcs, tails = tp_spawn(work, "gloo", PP_STAGES, "gloo", rate=False, mode="pp")
    out["gloo"] = pp_gates(work, ref, ranks, rcs, "gloo")
    out["gloo"]["seconds"] = time.perf_counter() - t
    if tails:
        out["gloo"]["logs"] = tails
    oks.append(out["gloo"]["ok"])
    out["launches"] = out["gloo"]["launches"]
    if count >= 2:
        t = time.perf_counter()
        ranks, rcs, tails = tp_spawn(work, "nccl", min(PP_STAGES, count), "nccl", rate=True,
                                     mode="pp")
        out["nccl"] = pp_gates(work, ref, ranks, rcs, "nccl")
        out["nccl"]["seconds"] = time.perf_counter() - t
        if tails:
            out["nccl"]["logs"] = tails
        oks.append(out["nccl"]["ok"])
    else:
        out["nccl"] = f"not run: {count} card"
    shutil.rmtree(work, ignore_errors=True)
    out["ok"] = all(oks)
    return out


# --------------------------------------------------------------------------
# phase ring: ring and Ulysses context parallelism (parallel/ring_attention.py)
# --------------------------------------------------------------------------

# Qwen2-72B-Instruct's attention: 64 q / 8 kv heads of 128, one 16,384-token
# prompt over four ranks (4,096 rows a rank)
RING_SHAPE = dict(B=1, T=16384, Hq=64, Hkv=8, D=128)
RING_SP = 4
RING_ITERS = 3


def ring_inputs(device) -> tuple:
    """The whole bf16 q, k, v and the lengths, drawn on the card from the
    seed (every rank draws the same, then keeps its shard)."""
    import torch
    s = RING_SHAPE
    g = torch.Generator(device=device).manual_seed(SEED)
    q, k, v = (torch.randn((s["B"], s["T"], h, s["D"]), generator=g, device=device,
                           dtype=torch.float32).to(torch.bfloat16)
               for h in (s["Hq"], s["Hkv"], s["Hkv"]))
    return q, k, v, torch.full((s["B"],), s["T"], dtype=torch.int32, device=device)


def ring_rank(spec: dict, rank: int) -> dict:
    """One sp rank on the card (gloo): ring and Ulysses on its shard, once
    to build and warm, then counted and timed; each output saved."""
    import torch
    import torch.distributed as dist
    from tpuserve_torch.parallel.ring_attention import (make_sp_group, ring_prefill_attention,
                                                        seq_shard, ulysses_prefill_attention)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    group = make_sp_group()
    q, k, v, lens = ring_inputs(dev)
    shard = [seq_shard(x, group).contiguous() for x in (q, k, v)]
    del q, k, v
    scale = RING_SHAPE["D"] ** -0.5
    out = {}
    for name, fn in (("ring", ring_prefill_attention), ("ulysses", ulysses_prefill_attention)):
        fn(*shard, lens, scale, group)
        torch.cuda.synchronize()
        reset_launches()
        walls = []
        for _ in range(RING_ITERS):
            dist.barrier(group)
            t = time.perf_counter()
            res = fn(*shard, lens, scale, group)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        out[name] = {"ms": sorted(walls)[len(walls) // 2], "launches": read_launches()}
        torch.save(res.cpu(), f"{spec['out']}.{name}.rank{rank}.pt")
    return out


def phase_ring(results) -> dict:
    """See the module docstring, phase ring."""
    import tempfile
    from pathlib import Path
    import torch
    from tpuserve_torch.ops.flash_prefill import flash_prefill_attention
    root = Path(__file__).resolve().parent
    work = Path(tempfile.mkdtemp(prefix="ring-", dir=str(root / "build")))
    t = time.perf_counter()
    ranks, rcs, tails = tp_spawn(work, "sp", RING_SP, "gloo", rate=False, mode="ring")
    out = {"spawn_s": time.perf_counter() - t, "rcs": rcs, "shape": RING_SHAPE, "sp": RING_SP}
    if tails or any(r is None for r in ranks):
        out.update(ok=False, logs=tails)
        return out
    # the one-rank flash kernel over the whole prompt: the reference (its
    # launches compare, they are not the path's)
    q, k, v, lens = ring_inputs(torch.device("cuda"))
    scale = RING_SHAPE["D"] ** -0.5
    ref = flash_prefill_attention(q, k, v, lens, scale)
    out["one_rank_ms"] = cuda_ms(lambda: flash_prefill_attention(q, k, v, lens, scale), iters=3)
    # the one-rank call's bound and library time (SDPA, dense causal; the
    # plain version's 64 x 16,384^2 float32 scores would take 68.7 GB)
    s_ = RING_SHAPE
    pairs = s_["B"] * s_["T"] * (s_["T"] + 1) // 2
    out["one_rank_bound_ms"], out["one_rank_bound_by"] = bound(
        4 * s_["Hq"] * s_["D"] * pairs, nbytes(q, k, v, ref), "bfloat16")
    rep = s_["Hq"] // s_["Hkv"]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k.repeat_interleave(rep, dim=2),
                                               v.repeat_interleave(rep, dim=2)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["one_rank_library_ms"] = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, scale=scale),
                                         iters=3)
    del qt, kt, vt
    tol = tolerance(ref, "bfloat16")
    oks = []
    for name in ("ring", "ulysses"):
        got = torch.cat([torch.load(f"{work / 'sp'}.{name}.rank{r}.pt") for r in range(RING_SP)],
                        dim=1).to(ref.device)
        err, ok = compare(got, ref, tol)
        out[name] = {"max_abs_err": err, "ok": ok, "dtype": str(got.dtype),
                     "ms_by_rank": [r[name]["ms"] for r in ranks],
                     "ms": max(r[name]["ms"] for r in ranks)}
        oks.append(ok and got.dtype == torch.bfloat16)
    out["tolerance"] = tol
    out["launches"] = {n: sum(r["ulysses"]["launches"][n] + r["ring"]["launches"][n]
                              for r in ranks) for n in KERNEL_KIND}
    # Ulysses runs the flash kernel once a rank a call; the ring step is
    # plain torch
    oks.append(out["launches"]["flash_prefill"] == RING_SP * RING_ITERS
               and sum(out["launches"].values()) == RING_SP * RING_ITERS)
    del q, k, v, ref
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    out["ok"] = all(oks)
    return out


# --------------------------------------------------------------------------
# phase train: the fine-tuning step (parallel/train.py)
# --------------------------------------------------------------------------

TRAIN_MODEL = "Qwen/Qwen3-0.6B"
# bf16: a step of 3e-4 moves every weight below 0.0625 in magnitude (half
# a bf16 ulp there is 1.2e-4); each step starts from the seed's weights
TRAIN_BF16 = dict(B=4, T=512, lr=3e-4)
TRAIN_BF16_REMAT_GATE = 1e-2    # |loss1 with remat - without|: the same sums
TRAIN_FP32 = dict(layers=2, B=4, T=64)      # the JAX TrainConfig's learning rate
TRAIN_DP, TRAIN_TP = 2, 2
# the float32 steps' limits against the one-rank step: the losses, and
# leaf by leaf the update (p1 - p0) and both moments as ||a - b|| / ||b||
# (Adam's first step moves each weight by about the learning rate whatever
# its gradient, so the weights alone do not show a gradient that is missing
# or partial; that gives a leaf an error of order 1).  About ten times
# the worst readings of this phase, card against CPU and dp 2 x tp 2 ranks
# against the card (PERF.md)
TRAIN_LIMITS = {"loss": 1e-5, "update": 2e-3, "mu": 5e-5, "nu": 5e-5}


def train_batch(cfg, B: int, T: int, device) -> tuple:
    import torch
    g = torch.Generator(device="cpu").manual_seed(SEED)
    tokens = torch.randint(1, cfg.vocab_size, (B, T), generator=g, dtype=torch.int64)
    return tokens.to(device), torch.ones((B, T), dtype=torch.bool, device=device)


def train_once(params, cfg, tokens, mask, tcfg) -> dict:
    """loss0, the step, loss1, the step's ms; the tree and the moments."""
    import torch
    from tpuserve_torch.parallel import train
    opt, state = train.init_train_state(params, tcfg)
    with torch.no_grad():
        loss0 = float(train.causal_lm_loss(params, cfg, tokens, mask))
    sync = torch.cuda.synchronize if tokens.is_cuda else (lambda: None)
    sync()
    t = time.perf_counter()
    params, state, loss = train.train_step(params, state, cfg, tcfg, opt, tokens, mask)
    sync()
    ms = (time.perf_counter() - t) * 1e3
    with torch.no_grad():
        loss1 = float(train.causal_lm_loss(params, cfg, tokens, mask))
    return {"loss0": loss0, "loss": float(loss), "loss1": loss1, "ms": ms, "params": params,
            "mu": state["mu"], "nu": state["nu"]}


def train_fp32_cfg():
    from tpuserve_torch.models.config import get_model_config
    return dataclasses.replace(get_model_config(TRAIN_MODEL), dtype="float32",
                               num_layers=TRAIN_FP32["layers"])


def train_rank(spec: dict, rank: int) -> dict:
    """One rank of the dp x tp grid (gloo, one card): the float32 step on
    its tp slice of the seed's weights and its dp rows; its slices saved."""
    import torch
    from tpuserve_torch.models.weights import init_params_device
    from tpuserve_torch.parallel import train
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    comm = train.make_train_comm(TRAIN_DP, TRAIN_TP)
    cfg = train_fp32_cfg()
    params = train.shard_train_params(init_params_device(cfg, SEED, dev), comm)
    tokens, mask = train_batch(cfg, TRAIN_FP32["B"], TRAIN_FP32["T"], dev)
    rows = TRAIN_FP32["B"] // TRAIN_DP
    sl = slice(comm.dp_rank * rows, (comm.dp_rank + 1) * rows)
    res = train_once(params, train.train_config(cfg, comm), tokens[sl], mask[sl],
                     train.TrainConfig())
    torch.save({k: res[k] for k in ("params", "mu", "nu", "loss0", "loss", "loss1")},
               f"{spec['out']}.rank{rank}.pt")
    return {"tp_rank": comm.tp_rank, "dp_rank": comm.dp_rank,
            **{k: res[k] for k in ("loss0", "loss", "loss1", "ms")}}


def tree_diff(ours, theirs, base, tp: int = 1, tp_rank: int = 0) -> dict:
    """Two trees against each other, ``theirs`` and ``base`` cut to the tp
    rank's slice first: "max_abs", the largest |a - b|; "rel", the largest
    leaf-by-leaf ||a - b|| / ||b||, of the leaves themselves or, with
    ``base`` (the weights both steps started from), of the updates
    ``a - base`` and ``b - base``.  In float64 on the card."""
    import types
    import torch
    from tpuserve_torch.parallel import train
    from tpuserve_torch.parallel.sharding import slice_leaf, spec_for
    grid = types.SimpleNamespace(cfg=types.SimpleNamespace(tp=tp, ep=1), tp_rank=tp_rank,
                                 ep_rank=0)
    cut = (lambda path, t: slice_leaf(t, spec_for(path), grid)) if tp > 1 else (
        lambda path, t: t)
    bases = [None] * len(train._leaves(ours)) if base is None else train._leaves(base)
    worst, rel = 0.0, 0.0
    for (path, a), (_, b), base_leaf in zip(train._leaves(ours), train._leaves(theirs), bases,
                                            strict=True):
        a = a.to("cuda", torch.float64)
        b = cut(path, b).to("cuda", torch.float64)
        worst = max(worst, (a - b).abs().max().item())
        if base_leaf is not None:
            p0 = cut(path, base_leaf[1]).to("cuda", torch.float64)
            a, b = a - p0, b - p0
        rel = max(rel, ((a - b).norm() / b.norm().clamp(min=1e-30)).item())
    return {"max_abs": worst, "rel": rel}


def train_gate(ours, theirs, base, tp: int = 1, tp_rank: int = 0) -> dict:
    """The losses' largest difference and :func:`tree_diff` of the weights
    (their update from ``base``) and both moments, against ``TRAIN_LIMITS``."""
    row = {"loss_diff": max(abs(ours[k] - theirs[k]) for k in ("loss0", "loss", "loss1")),
           "update": tree_diff(ours["params"], theirs["params"], base, tp, tp_rank),
           "mu": tree_diff(ours["mu"], theirs["mu"], None, tp, tp_rank),
           "nu": tree_diff(ours["nu"], theirs["nu"], None, tp, tp_rank)}
    row["ok"] = row["loss_diff"] <= TRAIN_LIMITS["loss"] and all(
        row[k]["rel"] <= TRAIN_LIMITS[k] for k in ("update", "mu", "nu"))
    return row


def phase_train(results) -> dict:
    """See the module docstring, phase train."""
    import gc
    import tempfile
    from pathlib import Path
    import torch
    from tpuserve_torch.models.config import get_model_config
    from tpuserve_torch.models.weights import init_params_device, map_leaves
    from tpuserve_torch.parallel import train
    out, oks = {}, []
    # (a) bf16 at full depth, remat on and off, each step from the seed's
    # weights: finite, the loss falls; peak bytes
    cfg = dataclasses.replace(get_model_config(TRAIN_MODEL), dtype="bfloat16")
    params = init_params_device(cfg, SEED, "cuda")
    # the first step pays the first use of every kernel and of autograd:
    # taken on one short row at learning rate 0 (the weights stay the
    # seed's), its ms apart
    first = train_once(params, cfg, *train_batch(cfg, 1, 16, "cuda"),
                       train.TrainConfig(learning_rate=0.0))
    out["bf16_first_step_ms"] = first["ms"]
    del first
    tokens, mask = train_batch(cfg, TRAIN_BF16["B"], TRAIN_BF16["T"], "cuda")
    for remat in (True, False):
        step_params = map_leaves(torch.clone, params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res = train_once(step_params, cfg, tokens, mask,
                         train.TrainConfig(learning_rate=TRAIN_BF16["lr"], remat=remat))
        row = {k: res[k] for k in ("loss0", "loss", "loss1", "ms")}
        row["peak_gb_over_weights"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        row["finite"] = all(bool(torch.isfinite(t).all())
                            for _, t in train._leaves(step_params))
        out["bf16_remat" if remat else "bf16_plain"] = row
        oks.append(row["finite"] and math.isfinite(row["loss"]) and row["loss1"] < row["loss0"])
        del res, step_params
    out["bf16_remat_vs_plain"] = abs(out["bf16_remat"]["loss1"] - out["bf16_plain"]["loss1"])
    oks.append(out["bf16_remat_vs_plain"] <= TRAIN_BF16_REMAT_GATE)
    out["bf16_layers"] = cfg.num_layers
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # (b) float32 at 2 layers, TF32 off: the card's step against the CPU's
    cfg = train_fp32_cfg()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        whole = init_params_device(cfg, SEED, "cuda")
        tokens, mask = train_batch(cfg, TRAIN_FP32["B"], TRAIN_FP32["T"], "cuda")
        card = train_once(map_leaves(torch.clone, whole), cfg, tokens, mask, train.TrainConfig())
        cpu = train_once(map_leaves(lambda t: t.cpu(), whole), cfg, tokens.cpu(), mask.cpu(),
                         train.TrainConfig())
        row = {"card_ms": card["ms"], "cpu_ms": cpu["ms"], **train_gate(card, cpu, whole)}
        out["fp32_card_vs_cpu"] = row
        oks.append(row["ok"] and card["loss1"] < card["loss0"])
        # (c) dp 2 x tp 2 gloo ranks on the card: each rank's slices equal
        # the one-rank step's
        work = Path(tempfile.mkdtemp(prefix="train-", dir=str(Path(__file__).resolve().parent
                                                               / "build")))
        t = time.perf_counter()
        ranks, rcs, tails = tp_spawn(work, "grid", TRAIN_DP * TRAIN_TP, "gloo", rate=False,
                                     mode="train")
        row = {"seconds": time.perf_counter() - t, "rcs": rcs}
        if tails or any(r is None for r in ranks):
            row.update(ok=False, logs=tails)
        else:
            row["ms"] = [r["ms"] for r in ranks]
            row["by_rank"] = [train_gate(torch.load(f"{work / 'grid'}.rank{r}.pt"), card, whole,
                                         TRAIN_TP, res["tp_rank"])
                              for r, res in enumerate(ranks)]
            row["ok"] = all(g["ok"] for g in row["by_rank"])
        out["dp2_tp2"] = row
        oks.append(row["ok"])
        shutil.rmtree(work, ignore_errors=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["launches"] = {n: 0 for n in KERNEL_KIND}       # the plain attention: no kernel
    gc.collect()
    torch.cuda.empty_cache()
    out["ok"] = all(oks)
    return out


# --------------------------------------------------------------------------
# phase disagg: prefill/decode disaggregation, in process and across servers
# --------------------------------------------------------------------------

DISAGG_TOKENS = 64
DISAGG_BLOCKS = 512                  # each engine's KV blocks (16,384 tokens)
DISAGG_FP32_LAYERS = 4               # the float32 identity runs' depth
DISAGG_WINDOW_LAYERS = 4             # Mistral-7B's, float32
DISAGG_WINDOW_PROMPT = 6000          # past Mistral-7B's 4,096 window
DISAGG_WINDOW_TOKENS = 32
DISAGG_CHOICES = ["ünïcödé", "Ωmega"]   # its first token opens a canonical-suffix plan
# the pool-full fallback: a decode pool of 48 blocks (1,504 tokens a
# sequence) holding a 640-token stream has 28 free blocks, and a
# 1,000-token prompt needs 33; the stream's decode dispatches are delayed so
# that it holds them while the prompt migrates twice
DISAGG_FULL_BLOCKS = 48
DISAGG_FULL_PROMPT = 1000
DISAGG_FILL_PROMPT = 640
DISAGG_FILL_TOKENS = 512
DISAGG_FILL_FAULT = "decode_dispatch:delay:1.0:delay_s=0.25"


def disagg_pair(cfg, params, **kw):
    from tpuserve_torch.parallel.disagg import DisaggregatedEngine
    from tpuserve_torch.runtime import CacheConfig, EngineConfig
    ecfg = EngineConfig(model=cfg.name, seed=SEED, **kw,
                        cache=CacheConfig(num_blocks=DISAGG_BLOCKS, dtype=cfg.dtype,
                                          max_blocks_per_seq=200))
    return DisaggregatedEngine(ecfg, ecfg, params=params, model_cfg=cfg, device="cuda")


def disagg_colocated(cfg, params, **kw):
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig
    return Engine(EngineConfig(model=cfg.name, seed=SEED, **kw,
                               cache=CacheConfig(num_blocks=DISAGG_BLOCKS, dtype=cfg.dtype,
                                                 max_blocks_per_seq=200)),
                  params=params, model_cfg=cfg)


def disagg_in_process(cfg, params, ps, count: bool) -> dict:
    """The pair against the colocated engine on one tree: ``ps`` greedy,
    DISAGG_TOKENS each, plus one request that finishes at its prefill;
    with ``count`` the pair's launches against its engines' runs."""
    import torch
    from tpuserve_torch.runtime import SamplingParams
    greedy = SamplingParams(max_tokens=DISAGG_TOKENS, temperature=0.0, ignore_eos=True)
    one = SamplingParams(max_tokens=1, temperature=0.0, ignore_eos=True)
    params_list = [greedy] * len(ps) + [one]
    reqs = ps + [ps[0]]
    ref = disagg_colocated(cfg, params).generate(reqs, params_list)
    family_free()
    pair = disagg_pair(cfg, params)
    reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = pair.generate(reqs, params_list)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    same = [a.output_token_ids == b.output_token_ids for a, b in zip(out, ref)]
    st = pair.stats
    res = {"layers": cfg.num_layers, "dtype": cfg.dtype, "tokens_equal": f"{sum(same)}/{len(same)}",
           "kv_transfers": st.kv_transfers, "handoff_ms_a_request":
           1e3 * st.transfer_time_s / max(1, st.kv_transfers),
           "kv_mb_a_request": st.kv_bytes_transferred / max(1, st.kv_transfers) / 1e6,
           "wall_s": wall, "finished_at_prefill": len(out[-1].output_token_ids) == 1,
           "drained": pair.prefill.block_manager.num_seqs() == 0
           and pair.decode.block_manager.num_seqs() == 0}
    res["ok"] = (all(same) and st.kv_transfers == len(ps) and res["finished_at_prefill"]
                 and res["drained"])
    if count:
        L = cfg.num_layers
        runs = {k: pair.prefill.graphs.replays[k] + pair.decode.graphs.replays[k]
                for k in KERNEL_KIND.values()}
        res["launches"] = launches
        res["graph_replays"] = runs
        res["ok"] = res["ok"] and launches == {n: L * runs[k] for n, k in KERNEL_KIND.items()}
    del pair
    family_free()
    return res


def disagg_window() -> dict:
    """Mistral-7B (every layer a 4,096 window), float32 with TF32 off, cut
    to DISAGG_WINDOW_LAYERS: a 6,000-token prompt through the pair (the
    prefill side keeps every block; the decode side releases) against the
    colocated engine."""
    from tpuserve_torch.runtime import SamplingParams
    cfg = dataclasses.replace(family_cfg(WINDOW_MODEL, "float32"),
                              num_layers=DISAGG_WINDOW_LAYERS)
    params, _made = family_params(cfg)
    long = prompts(np.random.default_rng(SEED + 71), [DISAGG_WINDOW_PROMPT], cfg.vocab_size)
    p = SamplingParams(max_tokens=DISAGG_WINDOW_TOKENS, temperature=0.0, ignore_eos=True)
    ref = disagg_colocated(cfg, params).generate(long, p)[0]
    family_free()
    pair = disagg_pair(cfg, params)
    out = pair.generate(long, p)[0]
    res = {"model": cfg.name, "layers": cfg.num_layers,
           "tokens_equal": out.output_token_ids == ref.output_token_ids,
           "prefill_window_release": pair.prefill.config.window_release,
           "decode_released_blocks": pair.decode.stats.released_blocks}
    res["ok"] = (res["tokens_equal"] and not res["prefill_window_release"]
                 and res["decode_released_blocks"] > 0)
    del pair, params
    family_free()
    return res


def disagg_guided(cfg, params) -> dict:
    """A guided_choice request whose first token opens a committed
    canonical-suffix plan (a non-ASCII choice: the byte tokenizer's first
    token is a partial rune) keeps its plan across the handoff."""
    from tpuserve_torch.runtime import SamplingParams
    pair = disagg_pair(cfg, params)
    (r,) = pair.generate([[5, 6, 7]], [SamplingParams(
        max_tokens=40, temperature=0.0, guided="choice",
        guided_schema=json.dumps(DISAGG_CHOICES))])
    res = {"text": r.output_text, "plans": pair.prefill.stats.guided_plans,
           "plans_left": len(pair.prefill._guided_plan) + len(pair.decode._guided_plan)}
    res["ok"] = r.output_text in DISAGG_CHOICES and res["plans"] >= 1 and not res["plans_left"]
    del pair
    family_free()
    return res


def disagg_servers(cfg, params, ps) -> dict:
    """Two in-process servers, as ``--role prefill --decode-url`` and
    ``--role decode`` build them, on one tree, with nothing captured before
    they serve: both capture on first use while the other serves (F7).
    ``ps`` as concurrent streams through the prefill server: each equal to
    the colocated engine's tokens; then a prompt a full decode pool
    refuses (503) on both attempts: decoded on the prefill pod, equal too;
    and ``/internal/abort`` of an id the pool never saw."""
    import threading
    from tpuserve_torch.parallel.disagg_net import PrefillHandoffEngine
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig, SamplingParams
    from tpuserve_torch.server import OpenAIServer, ServerConfig
    cache = CacheConfig(num_blocks=DISAGG_BLOCKS, dtype=cfg.dtype, max_blocks_per_seq=200)
    ecfg = EngineConfig(model=cfg.name, seed=SEED, cache=cache)
    greedy = SamplingParams(max_tokens=DISAGG_TOKENS, temperature=0.0, ignore_eos=True)
    rng = np.random.default_rng(SEED + 73)
    full_prompt = rng.integers(0, cfg.vocab_size, DISAGG_FULL_PROMPT).tolist()
    ref = [r.output_token_ids for r in
           disagg_colocated(cfg, params).generate(ps + [full_prompt], greedy)]
    family_free()
    dec = OpenAIServer(Engine(ecfg, params=params, model_cfg=cfg),
                       ServerConfig(host="127.0.0.1", port=0, allow_kv_migration=True))
    d_url = f"http://127.0.0.1:{dec.start()}"
    tiny = OpenAIServer(Engine(dataclasses.replace(ecfg, faults=DISAGG_FILL_FAULT,
                                                   cache=dataclasses.replace(
        cache, num_blocks=DISAGG_FULL_BLOCKS)), params=params, model_cfg=cfg),
        ServerConfig(host="127.0.0.1", port=0, allow_kv_migration=True))
    t_url = f"http://127.0.0.1:{tiny.start()}"
    pre = OpenAIServer(PrefillHandoffEngine(ecfg, d_url, params=params, model_cfg=cfg),
                       ServerConfig(host="127.0.0.1", port=0))
    p_url = f"http://127.0.0.1:{pre.start()}"
    res = {}
    try:
        t = time.perf_counter()
        body = {"max_tokens": DISAGG_TOKENS, "temperature": 0, "ignore_eos": True,
                "return_token_ids": True}
        got = concurrent([lambda p=p: sse(p_url + "/v1/completions", dict(body, prompt=p))
                          for p in ps])
        res["streams_s"] = time.perf_counter() - t
        toks = [stream_ids(r) for r in got]
        res["streams_equal"] = f"{sum(a == b for a, b in zip(toks, ref))}/{len(ps)}"
        res["ttft_ms"] = [1e3 * (r["t_first"] - r["t_send"]) for r in got if r["t_first"]]
        res["captures"] = {"prefill": len(pre.engine.prefill.graphs.executables),
                           "decode": len(dec.engine.graphs.executables)}
        res["capture_s"] = {"prefill": pre.engine.prefill.graphs.capture_s,
                            "decode": dec.engine.graphs.capture_s}
        res["replays_beside_capture"] = {
            "prefill": pre.engine.prefill.graphs.replays_beside_capture,
            "decode": dec.engine.graphs.replays_beside_capture}
        # the pool-full fallback: a stream holds the tiny pool's blocks, the
        # pool 503s both attempts, the prefill pod decodes
        fb = PrefillHandoffEngine(ecfg, t_url, params=params, model_cfg=cfg)
        fb.MIGRATE_RETRIES, fb.MIGRATE_RETRY_DELAY_S = 2, 0.5
        started, stop = threading.Event(), threading.Event()
        fill = {}
        filler = threading.Thread(target=disagg_hold_stream, args=(
            t_url, dict(body, prompt=rng.integers(0, cfg.vocab_size, DISAGG_FILL_PROMPT).tolist(),
                        max_tokens=DISAGG_FILL_TOKENS), started, stop, fill))
        filler.start()
        try:
            res["filler_started"] = started.wait(120)
            # an id of its own: the filler is the pool's "req-0", as fb's
            # first request would be
            rid = fb.add_request(request_id="pool-full", prompt_token_ids=full_prompt,
                                 params=greedy)
            while fb.has_work():
                if not fb.step():
                    time.sleep(0.005)
            r = fb.requests.pop(rid)
            res["filler_held"] = not fill.get("done", True)
        finally:
            stop.set()
            filler.join(60)
        res["pool_full_503s"] = fb.refused
        res["fallback_equal"] = r.output_token_ids == ref[-1]
        res["fallback_local"] = fb.prefill.stats.num_decode_steps > 0
        del fb
        status, ab = http(d_url + "/internal/abort", {"request_id": "never-seen"})
        res["abort"] = [status, ab]
        res["decode_drained"] = dec.engine.block_manager.num_seqs() == 0
    finally:
        for srv in (pre, dec, tiny):
            srv.shutdown()
    res["ok"] = (res["streams_equal"] == f"{len(ps)}/{len(ps)}" and res["fallback_equal"]
                 and res["fallback_local"] and res["pool_full_503s"] == 2
                 and res["filler_started"] and res["filler_held"] and res["abort"] == [200, {
                     "request_id": "never-seen", "aborted": False}] and res["decode_drained"])
    return res


def disagg_hold_stream(url: str, body: dict, started, stop, out: dict) -> None:
    """One stream through ``url``'s /v1/completions, held open until
    ``stop``: ``started`` once its first token arrives; ``out["done"]``
    whether it ended by itself first.  Closing it aborts the request."""
    import http.client
    from urllib.parse import urlparse
    u = urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=600)
    out["done"] = False
    try:
        conn.request("POST", "/v1/completions", body=json.dumps(dict(body, stream=True)),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        for line in r:
            if line.startswith(b"data: [DONE]"):
                out["done"] = True
                break
            if line.startswith(b"data: {"):
                started.set()
                if stop.is_set():
                    break
    finally:
        conn.close()


def phase_disagg(results) -> dict:
    """See the module docstring, phase disagg."""
    family_free()
    params, cfg = results["main"]["params"], results["main"]["engine"].model_cfg
    rng = np.random.default_rng(SEED + 70)
    ps = prompts(rng, MAIN_LENGTHS, cfg.vocab_size)
    out = {}
    t = time.perf_counter()
    out["bf16"] = disagg_in_process(cfg, params, ps, count=True)
    out["bf16_s"] = time.perf_counter() - t
    out["launches"] = out["bf16"]["launches"]
    t = time.perf_counter()
    fparams, fcfg = fp32_main(DISAGG_FP32_LAYERS)
    out["fp32"] = disagg_in_process(fcfg, fparams, ps, count=False)
    out["fp32_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["window"] = disagg_window()
    out["window_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["guided"] = disagg_guided(cfg, params)
    out["guided_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["servers"] = disagg_servers(fcfg, fparams, ps)
    out["servers_s"] = time.perf_counter() - t
    del fparams
    family_free()
    out["ok"] = all(out[k]["ok"] for k in ("bf16", "fp32", "window", "guided", "servers"))
    return out


def kernel_modules() -> dict:
    from tpuserve_torch.ops import flash_prefill, paged_decode, paged_window, ragged_paged
    return {"flash_prefill": flash_prefill, "paged_decode": paged_decode,
            "paged_window": paged_window, "ragged_paged": ragged_paged}


def reset_launches() -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    for mod in kernel_modules().values():
        mod.LAUNCHES = 0


def read_launches() -> dict:
    return {name: mod.LAUNCHES for name, mod in kernel_modules().items()}


# the phase whose run counts each kernel's launches, and the later paths'
# phases that count them too
LAUNCH_PHASE = {"flash_prefill": "main", "paged_decode": "main",
                "paged_window": "chunked", "ragged_paged": "mixed"}
PATH_PHASES = {"flash_prefill": ("families", "breadth", "tp", "pp", "ring", "spec", "embed",
                                 "services", "fleet", "disagg", "provision"),
               "paged_decode": ("families", "breadth", "tp", "pp", "services", "fleet",
                                "disagg", "provision"),
               "paged_window": ("families", "breadth", "tp", "spec", "services", "fleet",
                                "disagg"),
               "ragged_paged": ("breadth", "tp", "disagg")}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == TP_WORKER:
        return tp_worker(sys.argv[2])            # a process of phase tp
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from tpuserve_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the tpuserve_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    results = {}
    t_all = time.perf_counter()
    for phase in PHASES:
        t = time.perf_counter()
        if phase == "build":
            res = phase_build(_build)
        elif phase == "kernels":
            res = phase_kernels()
        elif phase == "families":
            res = phase_families()
        elif phase == "breadth":
            res = phase_breadth(results)
        elif phase == "tp":
            res = phase_tp(results)
        elif phase == "pp":
            res = phase_pp(results)
        elif phase == "ring":
            res = phase_ring(results)
        elif phase == "train":
            res = phase_train(results)
        elif phase == "identity":
            res = phase_identity()
        elif phase == "main":
            res = phase_main()
        elif phase == "graphs":
            res = phase_graphs(results)
        elif phase == "sampler":
            res = phase_sampler(results)
        elif phase == "guided":
            res = phase_guided(results)
        elif phase == "chunked":
            res = phase_chunked(results["main"]["params"])
        elif phase == "mixed":
            res = phase_mixed(results["main"]["params"])
        elif phase == "server":
            res = phase_server(results)
        elif phase == "provision":
            res = phase_provision(results)
        elif phase == "tiers":
            res = phase_tiers(results)
        elif phase == "slo":
            res = phase_slo(results)
        elif phase == "salvage":
            res = phase_salvage(results)
        elif phase == "flight":
            res = phase_flight(results)
        elif phase == "spec":
            res = phase_spec(results)
        elif phase == "embed":
            res = phase_embed(results)
        elif phase == "services":
            res = phase_services(results)
        elif phase == "fleet":
            res = phase_fleet(results)
        elif phase == "disagg":
            res = phase_disagg(results)
        elif phase == "profile":
            res = phase_profile(results)
        else:
            raise SystemExit(f"unknown phase {phase!r}")
        res["seconds"] = time.perf_counter() - t
        results[phase] = res
        emit({"phase": phase, **{k: v for k, v in res.items() if k not in (
            "headline", "params", "engine", "eager_engine", "streams", "sampled_stream",
            "cli_reference")}})
        if not res["ok"]:
            print(f"chip_smoke: phase {phase} failed", file=sys.stderr)
            return 1
    report = []
    for name, meta in KERNELS.items():
        h = results["kernels"]["headline"][name]
        report.append({"name": name, "route": "cuda", **meta,
                       "launches": results[LAUNCH_PHASE[name]]["launches"][name],
                       "max_abs_err": h["max_abs_err"], "ms": h["ms"],
                       "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                       "bound_by": h["bound_by"], "library_ms": h["library_ms"],
                       "tflops": h["flops"] / (h["ms"] * 1e9),
                       "bound_share": h["bound_ms"] / h["ms"],
                       "path_launches": {ph: results[ph]["launches"][name]
                                         for ph in PATH_PHASES.get(name, ())}})
    emit({"kernels": report})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_all:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
