"""Smoke run of the PyTorch port on one CUDA card (an H100 for the numbers in
PERF.md): builds the kernels, holds each against its plain PyTorch version at
the main paths' shapes, serves full-width smollm-135m (also with prefix
sharing and speculative decoding), full-width deepseek-v3
(depth cut), full-size rwkv6-7b and full-size h2o-danube-1.8b (past its
4096-token window) through the paged engine on the kernels, holds the paged
engine against the contiguous ``ServeEngine`` through the launcher's
``--parity-check``, encodes full-size hubert-xlarge, trains full-size
smollm-135m with A2Q and serves the trained model, traces, meters and
samples the served smollm-135m and reports its accumulator headroom, trains
the paper's four vision networks with A2Q and deploys their conv layers, and
checks the results.  Every model is
deployed on the card through the ``a2q_quantize`` kernel, and every deployed
matrix's codes are held to the plain quantizer's on the card.  yi-6b is
also served through the serving cluster's routed and disaggregated fleets,
and smollm-135m through spawned replicas.  smollm-135m also trains through
the compressed data-parallel gradient reduction, and hubert-xlarge and
llava-next-34b train at full width before they encode and serve; yi-6b
trains on a device mesh (DTensor, a world of one rank on the one card), is
re-sharded through a checkpoint, deployed and served, and llama4-scout's
MoE runs expert-parallel.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build every kernel from ``src/repro_torch/csrc`` (one nvcc per source, in
   parallel) and print the build seconds;
3. hold each kernel against its plain version on the card: ``int_matmul`` at
   M in {1, 8, 64} for the four (K, N) pairs of a smollm-135m layer with the
   int16 carry and the fused scale (A2Q-deployed weights), plus raw int32,
   ``wrap`` and ``saturate`` on full-range weights, and at deepseek-v3's
   largest K (18432) and largest N (129280) at M in {8, 32};
   ``paged_attention`` at B=8, H=9, KV=3, Dh=64, bs=16 with ragged lengths
   including 0, fp32 and bf16 pools; ``paged_mla_attention`` at deepseek-v3's
   B=8, H=128, R=512, P=64, bs=16 with ragged lengths including 0, 1 and
   lengths that end mid-block, a table entry past a row's length pointing at
   a block of NaN, fp32 and bf16 pools, with and without the activation
   fake-quant replay.  Times come from CUDA graphs of back-to-back calls
   timed with CUDA events (the plain versions, hubert's and the deploy's
   shapes from CUDA events around back-to-back calls); the
   smollm int_matmul weights rotate over 30 layer copies so each call
   streams its weights from HBM as the 30-layer model does.  The
   ``--int-chain`` variants too: ``int_matmul`` with the quantizing prologue
   (fp32 x) at smollm's layer shapes, M=8, signed and unsigned 8-bit, and at
   deepseek's K=18432, M in {8, 32} (both sides of the kernel's choice of
   quantization layout), bit for bit the plain version and the same kernel
   on the standalone act-quant's codes; ``paged_attention`` on int8 and
   packed-int4 pools with a bf16 query and ``paged_mla_attention`` on int8
   and packed-int4 latent pools with the replay, each against its plain
   version with a NaN scale block behind a table entry past a length, and
   SDPA on the dequantized gathered view as the library time.  The rwkv6
   slice's: ``int_matmul`` with the requantizing epilogue behind the
   prologue (relu^2 replayed in bf16, unsigned 8-bit codes out) at rwkv6-7b's
   cm.wk shape (K=4096, N=14336) and K=N=64, M in {8, 32}, bit for bit the
   plain version and timed beside the prologue-only kernel; ``rwkv6_scan`` at
   decode (B=8, H=64, T=1, bf16 r/k/v, fp32 y, the state updated in place)
   on the step kernel, and on the chunked tensor-core kernel a prefill chunk
   (B=1, T=32, carried state), a T=64 chunk with the decay floored at e^-8,
   a long prompt's engine chunk (T=512, carried, floored), a whole
   4096-token prompt (cacheless, floored) and 8 x 64 tokens (floored), each
   within ``RWKV_TOL`` and 1e-5 of the largest |S| of the plain version, the
   kernel that ran read from the wrapper's counters.  The
   hubert slice's: ``a2q_quantize`` at hubert-xlarge's four matrix shapes
   and rwkv6-7b's cm.wk (l1, codes and dequantized weights bit for bit,
   every column within the A2Q l1 budget); ``flash_attention``
   at hubert's encode (8 x 1000 frames, 16 heads of 80, bidirectional, bf16
   and fp32), smollm's causal GQA, a window and end-aligned queries, with
   SDPA as the library time, bf16 on the tensor-core kernel and fp32 on the
   CUDA-core one (also timed on hubert's bf16 values); ``int_matmul`` at
   M=8000 on the tensor-core kernel with the gelu requant epilogue (hubert's
   mlp.w_in, equal or one apart at rounding ties; bf16 x equal to its fp32
   widening) and at hubert's other shapes, with ``torch._int_mm`` as the
   library time and the share of the bound.  The decode slice's:
   ``int_matmul``'s split-K decode kernel (M <= 16) at rwkv6-7b's 4096 x
   4096 prologue shape, bit for bit, its K splits summed inside a
   thread-block cluster, two CUDA-graph replays equal to the eager call,
   timed against the weight bytes; ``torch._int_mm`` on x zero-padded to
   24 rows (its smallest legal M) as the decode shapes' library time; both
   int_matmul kernels forced
   at M in {1, 8, 16, 24, 32} on smollm's, rwkv6's and deepseek's decode
   shapes (the crossover); ``paged_attention`` at SmolLM-135M's 2048-token
   context (B=32, lengths from the seed in [1536, 2048]) on bf16, int8 and
   int4 pools against the plain version, two graph replays equal to the
   eager call, SDPA on the gathered view as the library time; the fp32 and
   bf16 pools' entries past a length poisoned with NaN as the integer
   pools' scales are; every phase-3 call of those two kernels under
   ``torch.cuda.set_sync_debug_mode("error")`` (a host sync fails).  The
   third decode slice's: ``a2q_quantize`` at every matrix shape a run
   deploys (55 shapes, 1,598 matrices: deepseek-v3's experts, dense mlp,
   MLA projections and head, rwkv6-7b's and smollm-135m's too, and phase
   4i's 33 conv and linear shapes, K=9 depthwise to K=4608, C_out=1 to
   1024), l1 and codes
   bit for bit, timed on copies rotated past the L2 and summed by count into
   the deploy kernel ms a run; ``paged_mla_attention`` on the tensor-core
   kernel for bf16, int8 and int4 pools (fp32 pools and a 12-bit replay on
   the CUDA-core kernel, each route checked by the wrapper's
   ``tc_launches``), its bound the operations at the bf16 tensor-core peak
   or the bytes, and at DeepSeek-V3's 4K pre-training context (B=8,
   lengths from the seed in [3072, 4096]) on bf16, int8 and int4 pools with
   the replay: within MLA_TOL, two graph replays equal to the eager call,
   no host sync, SDPA on the gathered view as the library time.  The last
   slice's, in the same checks: ``int_matmul`` with the prologue at
   ``PROLOGUE_SHAPES`` (hymba-1.5b's decode shapes, its dt_proj (N=25) at
   decode and at a 256-row prefill chunk (the tensor-core kernel's
   register-copy route) and its head (N=32001), llama4-scout's head
   (N=202048), llava's mlp.w_out (K=20480) and its patch prefill (M=1280)),
   bit for bit; ``paged_attention`` on bf16 pools at ``NEW_PAGED``
   (llama4's global layer past the 8192 chunk, B=2, H=40, KV=8, Dh=128, and
   llava's decode, H=56, KV=8), and ``flash_attention`` at llava's causal
   prefill (B=2, H=56, KV=8, T=640, D=128, tensor cores), against their
   plain versions;
4. serve full-width smollm-135m (30 layers, random A2Q weights from seed 0,
   deployed to int8; in this phase and 4b, 4e and 4f every deployed
   matrix's codes recomputed on the card with the plain quantizer from the
   same ``v``, ``t``, ``d`` and the flips counted, ``held_deploys``):
   8 requests, prompt 64, 32 new tokens, batch 8, through
   ``PagedServeEngine`` with ``Runtime(int_forward=True, decode_kernel=True)``;
   print prefill and decode tok/s and check that the launch counts show both
   kernels on every decode tick (210 int_matmul and 30 paged_attention) and
   the prefill chunks' rows on the tensor-core int_matmul;
5. compare the int path with the default ``Runtime()`` (dequant bf16
   matmuls, gathered-view attention) on the same weights: the prompts'
   logits must agree to two bf16 ulps of the largest logit (``eps``), and
   the greedy tokens served on the dequant path must agree with the int
   path's under ``parity_up_to_ties`` at that ``eps``; then a reduced model
   on the card against the same model on the CPU (plain versions), token for
   token and margin for margin;
4s. on phase 4's smollm-135m params cut to their first ``SIDE_LAYERS`` (4)
   layers (``serve_shared``), 10 requests of a
   64-token shared prefix and a 4-24-token tail (seed 2), 16 new, batch 8,
   blocks of 16, on ``Runtime(int_forward=True, decode_kernel=True)``:
   ``prefix_share`` per tick (tokens and margins bit for bit with the engine
   without sharing, 9 hits, the prefill tokens saved), at prefill chunk 40
   (adopters copy a shared block: ``cow_copies`` > 0 in place, every pool's
   ``data_ptr`` kept), on the megastep (bit for bit with per tick), and a
   pinned 32-token preamble on the megastep in 21 blocks (evictions, the
   pin kept, bit for bit with plain per tick); ``SpecServeEngine(spec_k=4)``
   with the self-int8 drafter on bf16 and int8 KV (``parity_up_to_ties`` at
   1e-3 / 0.05 against the plain engine, the launches exact: 7 int_matmul
   and 1 paged_attention a layer a draft step, 7 tensor-core int_matmul a
   layer a verify), a 4-layer smollm ``ModelDrafter`` (both free lists
   whole) and the megastep fallback (no round, graph replays, bit for bit);
   acceptance, tokens a row a round, host ops a spec round, decode tok/s
   against plain per tick;
4o. on phase 4's smollm-135m params cut to their first ``SIDE_LAYERS`` (4)
   layers (``serve_observed``), phase 4m's 8
   prompts, 32 new, ``decode_steps=8``, ``Runtime(int_chain=True,
   decode_kernel=True)``, bf16 KV: a traced engine against an untraced one
   (tokens, margins, launches and host ops a window equal; the reference's
   span names; the trace exported under ``build/obs`` and read back; span
   ms by name, events a window, the spans' share of a window's wall time),
   the metrics snapshot against ``stats``, ``cache.counters()`` and
   ``graph_info`` (``jit_cache_size{fn=megadecode}`` 1), the accumulator
   headroom at seq 8 and 32 (both ``int_matmul`` kernels: 0 violations,
   ``util_max < 1``), top-k sampling in the captured window (temperature
   1e-7 greedy bit for bit, one seed's engines identical, two replays on
   the same inputs drawing other tokens at temperature 64, ``sample_tokens``
   on ``(64, 49152)`` logits against the masked softmax by chi-square;
   sampled vs greedy decode tok/s), and the launcher with ``--sample topk
   --trace --metrics-json`` (its deploy held);
4b. serve full-width deepseek-v3 with its depth cut to the 3 dense MLA layers
   and 1 MoE layer (256 routed experts top-8 + 1 shared), no MTP head
   (serving never reads it), random A2Q weights from seed 0 built and
   deployed to int8 stack by stack and leaf by leaf (no whole fp32 tree
   exists): 8 requests, prompt 64, 32 new tokens, batch 8, through
   ``PagedServeEngine`` with ``Runtime(int_forward=True, decode_kernel=True,
   mla_absorb=True)``; print peak device memory, prefill and decode tok/s,
   and check the launch counts (29 int_matmul per forward, 4
   paged_mla_attention per decode tick);
5b. compare with ``Runtime(mla_absorb=True)`` (dequant bf16 matmuls,
   gathered-view latent attention) on the same weights, as in phase 5; then
   reduced deepseek-v3 on the card against the same model on the CPU;
4p. the contiguous ``ServeEngine`` (per-token prefill into a slot's lane,
   host argmax) and the reference's parity gate, through ``launch/serve.py
   --paged --parity-check`` on smollm-135m at full width, its depth cut from
   30 layers to 4 (2 requests, prompt 64, 32 new, batch 8, seed 0): with ``--deploy-int8`` the contiguous dequant
   engine against the paged one, token for token; with ``--int-forward
   --kv-int8`` the paged int path (int_matmul, int8 KV) against the
   contiguous float path under ``parity_up_to_ties`` at eps 0.05, the
   sub-margin ties printed; then the contiguous engine alone on
   ``--int-chain`` (1 request, 8 new) on int_matmul's prologue; every
   deploy held to the plain quantizer, both engines' tok/s, the host ops of
   a contiguous tick, the contiguous engines' params and caches on the card;
4r. the serving cluster (``serve_cluster``) through ``launch/serve_cluster.py``
   in this process on yi-6b at full width (d_model 4096, 32 heads over 4 KV
   heads of 128, d_ff 11008, vocab 64000), its depth cut from 32 layers to
   ``CLUSTER_LAYERS`` (2), random A2Q weights from seed 0 drawn once for
   three fleets: 16 requests (prompts of 64 tokens, every fourth 192), 32
   new, batch 8, blocks of 16, prefill chunks of 32, ``--int-forward
   --parity-check``: ``--disagg 1:1`` (bf16 blocks migrate; token-identical
   to the single engine), ``--disagg 2:2 --kv-int8 --fault-rate 0.25`` (one
   replica killed a quarter into the wave: one death, requeues, every
   stream emitted once, ``parity_up_to_ties`` at eps 0.05) and ``--disagg
   1:2 --kv-int8 --kv-bits 4 --decode-steps 8 --policy weighted-latency``
   (int4 blocks imported in place into megastep replicas: one graph capture
   a decode replica, replays); every engine on the card, every deploy held,
   int_matmul launches equal to 29 a forward of the forwards the engines'
   stats imply, migration bytes in equal to bytes out (plus a dead decode
   replica's re-imports), bytes a block token equal to
   ``kv_bytes_per_token()``; fleet tokens, capacity, dispatch, p50/p99
   latency and TTFT, migrated blocks and bytes, tok/s by engine; then
   smollm-135m at full size on two spawned replicas (``--transport
   subproc``, built in the parent first), token-identical to the parent's
   single engine, no death (the children's launches are not counted);
4c. on phase 4's smollm-135m cut to its first ``SIDE_LAYERS`` (4) layers, as
   4m's, 4s's and 4o's, the ``--int-chain --kv-int8 [--kv-bits 4]
   --decode-kernel`` path: ``Runtime(int_chain=True, decode_kernel=True)``
   on int8, then int4 KV pools; launch counts (7 int_matmul a layer per
   forward, 1 paged_attention a layer per tick) and the chain report (all
   folded, 0 standalone); the unchained int-forward run on the same pools gives
   bitwise-equal prompt logits and identical tokens and margins; the
   gathered dequantized read gives the same tokens; against bf16 KV,
   ``parity_up_to_ties`` at an eps measured from the prompt logits (the
   largest rise of any logit over the bf16 top-1), at most a quarter of the
   logits' spread; decode and prefill tok/s, peak memory and host ops per
   decode tick of every run;
4d. the same on phase 4b's deepseek-v3 params (no second model is built),
   with ``mla_absorb=True``: 29 int_matmul per forward (29 folded), 4
   paged_mla_attention per tick;
4e. serve full-width rwkv6-7b (d_model 4096, d_ff 14336, vocab 65536), its
   depth cut from 32 layers to ``RWKV6_LAYERS`` (8) for this phase, 4e-long,
   5e and its 4m (random A2Q weights from seed 0 deployed block by block): 8
   requests, prompt 64, 32 new tokens, batch 8, with ``Runtime(int_chain=
   True)``: 7 int_matmul a layer and the head a forward (one a layer
   cm.wk's requant), one rwkv6_scan a layer, chain report all folded but
   cm.wk's chained, 0 standalone; the
   recurrent state bytes a slot, host ops a decode tick, a profiled decode;
   the unchained int-forward run gives bitwise-equal prompt logits and
   identical tokens and margins; the prefill chunks' recurrences on the
   chunked ``rwkv6_scan`` kernel, the ticks' on the step kernel;
4e-long. on the same params, one 4096-token prompt (seed 0, RWKV-6's
   training context) in prefill chunks of 1024 (four chunked-form calls a
   layer, the slot's state carried) and 8 new tokens: prefill and decode
   tok/s, the launch counts (4 a layer on the chunked kernel, one a layer a
   tick on the
   step kernel), the host ops of each prefill chunk, one profiled prefill
   chunk's device ms by kernel (``rwkv6_scan``, ``int_matmul``, the rest);
   in-vocab tokens and finite margins;
5e. the dequant path (``Runtime()``) as in phase 5 (logits within two bf16
   ulps of the largest, ``parity_up_to_ties`` at that eps); reduced rwkv6
   on the card (int-chain, prefill chunks of the ssm chunk, so chunked and
   sequential forms) against the CPU, token for token;
4m. the decode megastep (``decode_steps=8``, every window one replay of a
   CUDA graph captured at the engine's first step) on each decoder's own
   params, right after its per-tick phases: smollm-135m on 4c's
   ``--int-chain`` int8 KV with 12 requests over 8 slots (a slot recycled
   between windows), deepseek-v3 on 4b's ``mla_absorb`` bf16 latent pools,
   rwkv6-7b on 4e's ``--int-chain``; prompts of 64 tokens, 32 new, batch 8:
   tokens identical to the per-tick engine's (the largest margin difference
   printed), ``graph_replays`` one a window, every tick of every window
   through the kernels (their launches a tick and a prefill chunk, the
   replays' counted: each adds the capture's counts), the EOS rerun (request
   0's per-tick token at step 16) identical with request 0 ended early and
   every block freed, at most 50 host ops a window, one eager window under
   ``torch.cuda.set_sync_debug_mode("error")``; decode tok/s per-tick vs
   megastep (median of 3 alternating runs), host ops a tick vs a window,
   capture seconds, the graph pool's bytes, one window's launches by kernel;
4h. h2o-danube-1.8b at full width, its depth cut from 24 layers to
   ``H2O_LAYERS`` (2) for the main run (d_model 2560, 32 heads over 8
   KV heads of 80, window 4096, vocab 32000; random A2Q weights from seed 0
   deployed through ``a2q_quantize``: 7 a layer and the head, each held)
   served with
   ``Runtime(int_chain=True, decode_kernel=True)``: 4 requests over 4 slots,
   prompts of 4,100-4,300 tokens (seed 0) in prefill chunks of 256, so the
   per-slot rings wrap in prefill and again in decode, 64 new tokens; per
   tick, then on the megastep (``decode_steps=8``) on the same params and
   batches, tokens and margins bit for bit, then the EOS rerun (request
   0's token at step 32); 7 int_matmul prologue launches a layer and the
   head's a forward and no
   ``paged_attention`` launch (ring layers take ``_sdpa``, as in the
   reference); prefill and decode tok/s, host ops a tick and a window, ring
   state bytes a slot, peak memory; then the contiguous check: the same
   widths cut to 2 layers, one 4,128-token prompt and 16 new tokens through
   ``launch/serve.py --paged --parity-check --deploy-int8`` (the paged
   engine's ring against the contiguous ``ServeEngine``'s, past the window:
   token for token);
4y. hymba-1.5b at full width, ``HYMBA_LAYERS`` (4) of its 32 layers
   (d_model 1600, 25 heads over 5 KV heads of 64, window 1024, 25 mamba
   heads of 64, state 16, SSD chunk 64, d_ff 5504, vocab 32001; random A2Q
   weights from seed 0 deployed through ``a2q_quantize``: 177 matrices,
   each held) served with
   ``Runtime(int_chain=True, decode_kernel=True)``: 4 requests over 4
   slots, prompts of 1,100-1,300 tokens (seed 0) in prefill chunks of 256
   (the ring wraps; the chunked SSD form on whole chunks, the sequential one
   on each prompt's tail), 64 new; per tick, then on the megastep on the same
   params and batches, tokens and margins bit for bit; 177 int_matmul
   prologue launches a forward, no ``paged_attention`` launch (the ring
   takes ``_sdpa``); then the contiguous check at 2 layers (one 1,100-token
   prompt, 16 new, ``--paged --parity-check --deploy-int8``);
4l. llama4-scout at full width (d_model 5120, 40 heads over 8 KV heads of
   128, 16 experts top-1 with d_ff 8192 + 1 shared, vocab 202048), its depth
   cut from 48 layers to one iRoPE period (3 chunk-local RoPE layers of
   chunk 8192, 1 NoPE global layer; ~10.9 B parameters), built and deployed
   block by block (221 matrices, each held): 2 requests of 8,300 and 8,450
   tokens in prefill chunks of 256 (across the 8192 chunk boundary), 32 new,
   per tick and on the megastep, bit for bit; 29 int_matmul prologue
   launches a forward, one ``paged_attention`` a tick (the global layer);
4v. llava-next-34b at full width (d_model 7168, 56 heads over 8 KV heads of
   128, d_ff 20480, vocab 64000), depth cut from 60 layers to 4 (29
   matrices, each held): ``build_prefill_step`` on ``Runtime(int_chain=
   True)`` over 576 patch embeddings and 64 tokens (seed 0), batch 2, bf16
   (4 ``flash_attention`` launches, causal, GQA 7:1, D=128, all on the
   tensor cores; the logits within two bf16 ulps of the largest of the same
   forward on ``_sdpa``), then phase 4's 8 text prompts (64 tokens, 32 new)
   per tick and on the megastep, bit for bit, 4 ``paged_attention`` a tick;
   each of 4y, 4l and 4v prints prefill and decode tok/s, host ops a tick
   and a window, KV bytes a token, state bytes a slot, peak memory, a
   profiled decode tick and its own seconds;
4f. deploy full-size hubert-xlarge (48 layers, d_model 1280, d_ff 5120, 504
   classes, random A2Q weights from seed 0, block by block: 289
   ``a2q_quantize`` launches) and encode 8 clips of 1000 bf16 frames (seed
   0) with ``Runtime(int_chain=True)`` through ``build_prefill_step`` /
   ``apply_lm(frontend_embeds=...)``: 289 int_matmul a forward (241 with the
   prologue, 48 of them mlp.w_in's gelu requant; 48 on int8 codes; all 289
   on the tensor-core kernel), 48 flash_attention (all on the tensor-core
   kernel), chain report 289 folded /
   48 chained / 0 standalone; frames/s, peak memory building and encoding,
   kernel time of a profiled forward;
5f. chained vs unchained: the w_out input codes compared (each differing
   code one apart at a gelu rounding tie, ``requant_ties``), logits bitwise
   equal where none differs, else within two bf16 ulps; the dequant path
   (logits within two bf16 ulps of the largest, framewise argmax
   agreement), reduced hubert on the card against the CPU to 1e-4;
4t. train full-size smollm-135m (30 layers, d_model 576, vocab 49152; bf16
   compute, fp32 params, ``remat="block"``, A2Q M=8 N=8 P=16) from seed 0
   with ``adamw`` and ``cosine_with_warmup`` on ``TokenStream(vocab=49152,
   seq_len=512, global_batch=8, seed=0)`` for ``TRAIN_STEPS`` steps through
   ``build_train_step`` and the ``Trainer`` (a checkpoint at the midpoint):
   median step ms, train tok/s, peak memory, first-10 and last-10 mean
   loss / ce / penalty, the largest grad norm; every loss finite and the
   last-10 mean at least 0.5 nat below the first-10; 0 kernel launches while
   training (the cacheless attention differentiates ``_sdpa``, the linears
   their fake-quant); the mid-run checkpoint restored into a fresh
   ``Trainer`` and run to the end, its first loss bit for bit and every loss
   within ``RESUME_TOL`` of the uninterrupted run's; the trained params
   deployed through ``a2q_quantize`` (every matrix held to the plain
   quantizer: 0 code flips), every column's ``Σ|q|`` within the P=16 l1
   budget, the largest column's share of it and the share of zero codes,
   untrained against trained; 8 prompts of 64 tokens from the same stream
   (step 10000) served for 32 new tokens through ``PagedServeEngine`` with
   ``Runtime(int_forward=True, decode_kernel=True)`` on bf16 KV, held with
   ``parity_up_to_ties`` against the dequant path; the share of served
   tokens that follow the stream's bigram ``(31 * prev + 17) mod 49152`` and
   the largest |logit|;
4u. train the MoE and recurrent decoders at full width (``train_decoders``,
   ``DECODER_TRAIN_RUNS``): llama4-scout cut to one chunk-local MoE layer
   (adafactor), deepseek-v3 to one dense MLA layer and its MTP head
   (adafactor), rwkv6-7b to 2 layers and hymba-1.5b to 4 (adamw), params
   from a device generator, 8 steps of 4 x 512 ``TokenStream`` tokens
   through ``build_train_step(donate=True)``: step ms, train tok/s, peak
   memory, the max |logit| at init, first-3 and last-3 mean loss (and
   ``mtp_ce``): finite and not rising by more than ``DECODER_FLAT_TOL``, 0
   kernel launches; each trained tree deployed under ``held_deploys`` (one
   launch an A2Q matrix, the MTP head's included, 0 flips) and served (4
   requests of 64 tokens, 16 new) on ``int_forward`` with the decode
   kernels (deepseek absorbed on ``paged_mla_attention``, all on the tensor
   cores; rwkv6 on both ``rwkv6_scan`` kernels), the launches counted
   against the ticks and chunks, ``parity_up_to_ties`` against the deployed
   tree's dequant path; then each reduced config trained 12 steps of 4 x
   64 on the card and on the CPU (``reduced_learns``): the loss (and
   ``mtp_ce``) falls, each step within ``DECODER_CHECK_TOL`` of the CPU's,
   no kernel launched;
4g. the compressed data-parallel gradient reduction (``train_compressed``):
   smollm-135m at full width (``COMPRESS_LAYERS`` layers) trained ``COMPRESS_STEPS``
   steps of 8 x 512 ``TokenStream`` tokens from one seed-0 init,
   uncompressed and through ``build_train_step(Runtime(mesh, rules,
   grad_compress))`` with a data axis of ``COMPRESS_GROUPS`` groups on the
   card, int8 ``tensor`` then int8 ``column``: step ms, train tok/s, peak
   memory, the largest |loss - uncompressed| and the share of nonzero
   gradient elements the wire sends as 0 (``wire_zeros``), each run
   learning, both residual trees nonzero, no kernel launched; the
   reference's own tracking test on the card (``COMPRESS_REF``: every
   compressed loss within ``COMPRESS_TOL`` of the uncompressed one); its
   int8 tensor state's residual pair through a checkpoint bit for bit and
   an uncompressed checkpoint restored with ``allow_missing``;
   ``compressed_allreduce_tree`` on the card against the CPU port
   (``wire_on_card``: codes, totals and residuals bit for bit); the int8
   tensor run deployed (held, 0 flips) and served (4 requests, 16 new) on
   ``int_matmul`` and ``paged_attention``, ``parity_up_to_ties`` against
   the dequant path;
4w. the frontend families trained at full width (``train_frontends``):
   hubert-xlarge (``HUBERT_TRAIN_LAYERS`` layers) on 4 x 1,000 seed-made
   frames with framewise targets, llava-next-34b (``LLAVA_TRAIN_LAYERS``
   of 60) on 2 x (576 patches + 64 tokens), ``FRONTEND_TRAIN_STEPS`` adamw
   steps through ``build_train_step(donate=True)``: step ms, train tok/s,
   peak memory, losses finite and not rising by more than
   ``DECODER_FLAT_TOL``, 0 kernel launches; each deployed (held, 0 flips);
   hubert encodes on ``int_chain`` (``flash_attention``, ``int_matmul``
   with the gelu requant), llava prefills its patches on ``int_chain``
   (``flash_attention``) and serves 4 text requests on the paged engine
   (``paged_attention``, ``int_matmul``); each reduced config learns on the
   card as on the CPU (``frontend_learns``);
4i. train the paper's four vision networks at full width: MobileNetV1 and
   ResNet18 (width 1.0) on ``ImageClassStream(global_batch=64)`` at 5e-3,
   ESPCN and UNet (base 32) on ``SuperResStream(global_batch=16, hr=48)``
   at 1e-3, each ``VISION_STEPS`` float adamw steps, then, as the paper
   starts A2Q from a float model, ``requantize_from_float`` into A2Q
   (M=N=6, P=16) and ``VISION_STEPS`` A2Q steps through
   ``build_vision_train_step``; median step ms and images/s; every loss
   finite and a held-out batch's loss lower after the A2Q steps than
   before them (the training losses' first and last-5 mean printed: the
   super-resolution batches' own mean squares vary more than 20 steps move
   ESPCN's); the share of nonzero outputs and a profiled A2Q step's kernel
   time (printed); every conv and linear leaf deployed through
   ``deploy_vision`` (``a2q_quantize``, held to the plain quantizer), every
   deployed column's ``Σ|q|`` within its layer's P=16 budget, the deployed
   forward within ``VISION_DEPLOY_TOL`` of the fake-quant forward, every
   deployed shape a phase-3 ``DEPLOY_SHAPES`` row with its count; the
   share of zero codes (``tree_sparsity``) and ``model_luts`` totals at
   P=16 and P=32 (printed);
4x. sharded execution (``train_sharded``) on a world of ``SHARDED_RANKS``
   rank(s) over ``SHARDED_BACKEND`` (printed on the phase's line): yi-6b at
   full width (``SHARDED_LAYERS`` of 32 layers) trained ``SHARDED_STEPS``
   adamw steps on DTensors placed by ``shard_state`` on a ``(data, model)``
   mesh, each loss within ``SHARDED_LOSS_RTOL`` of the same steps unsharded
   in a process of their own (``sharded_reference_main``); the params saved
   from the mesh and restored onto ``(data=ranks, model=1)`` and onto one
   unsharded rank, bit for bit; the restored tree deployed (held, 0 flips)
   and served on ``int_matmul`` and ``paged_attention``,
   ``parity_up_to_ties`` against the tree trained unsharded; llama4-scout's
   MoE layer (16 experts, top-1, cf 1.25) with ``ep_axis="model"`` and
   ``("model", "data")`` against its local path, and the 1-layer model's
   adafactor step with ``ep_axis="model"`` against the unsharded one;
   yi-6b's cache placed by ``cache_specs`` through one decode step against
   the unsharded step (``KV_TOL``, ``kpos`` written at 0); the phase's
   seconds printed;
4z. the dry-run's cost of 4x's step (``cost_model``, in a spawned process:
   ``launch.dryrun.trace_step`` on fake ``cuda`` tensors over a fake world
   of 4x's ranks): its ``argument_size_in_bytes`` equal to the bytes of
   4x's real sharded state and batch, and its per-device FLOPs equal to
   ``FlopCounterMode``'s count of 4x's unsharded reference step; the
   predicted peak over 4x's ``max_memory_allocated`` and the roofline bound
   over 4x's steady step time printed as ratios;
6. print the ``kernels`` line (every kernel and its int-chain variants:
   ``int_matmul[prologue]``, ``int_matmul[requant]``,
   ``int_matmul[gelu requant]``, ``paged_attention[int8|int4]``,
   ``paged_mla_attention[int8|int4]``, ``rwkv6_scan`` (the step kernel),
   ``rwkv6_scan[chunked]`` (the tensor-core kernel), ``a2q_quantize``,
   ``flash_attention``, ``int_matmul[tc]`` (the tensor-core kernel), each
   with its launches on its main paths, counted by the wrappers:
   ``int_matmul[prologue]`` every launch with the prologue, the requant ones
   included; ``int_matmul`` the launches with int8 codes in;
   ``int_matmul[tc]`` every launch on the tensor cores; flash's
   ``launches_tc``; ``paged_mla_attention``'s ``launches_tc``, refused
   unless every main-path launch ran on the tensor cores; and on
   ``a2q_quantize`` the deployed matrices held to the plain quantizer and
   their code flips, refused if any, and the deploy kernel ms a run), then
   the result line.

The last line is ``{"ok": true, "device": {...}}``; the line before it lists
every ported kernel with its launches on the main paths (counted from zero
just before each path's run and read just after, the 4m paths' graph
replays included; 4s's sharing and spec runs, not their baselines;
int_matmul's is the sum of every path's), its error
against the plain version, and its time beside the
plain version's, a PyTorch library call's and the card's bound.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at the 700 W limit):
# HBM, the int8 and bf16 tensor cores, fp32 outside the tensor cores (the
# paged kernel's fp32 FMAs).  Fails outside a checkout of the repo.
from repro_torch.roofline.hw import (  # noqa: E402
    BF16_FLOPS_PER_S,
    FP32_FLOPS_PER_S,
    HBM_BYTES_PER_S,
    INT8_OPS_PER_S,
)

SMOLLM_SITES = {  # (K, N) of the seven linears of one smollm-135m layer -> count
    (576, 576): 2,   # wq, wo
    (576, 192): 2,   # wk, wv
    (576, 1536): 2,  # w_in, w_gate
    (1536, 576): 1,  # w_out
}
LAYERS = 30
# plain vs kernel tolerances: int_matmul is bit-exact; paged attention is fp32
# softmax summed in another order (fp32 pools), plus one bf16 rounding of the
# output (bf16 pools: one ulp at |o| < 2).  The MLA kernels' output is fp32
# whatever the pools: the CUDA-core kernel's fp32 sums, the tensor-core
# kernel's with q in three bf16 terms and P in two (three with a token scale
# folded in), so both take the fp32 tolerance.
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0**-6}
MLA_TOL = 2e-5
# depth cuts of the earlier paths, so the script, the last slice's three decoders
# included, stays inside its time limit on a slow host (PERF.md section 4)
SIDE_LAYERS = 2  # 4c, 4m, 4s and 4o: phase 4's smollm-135m params, their first layers
H2O_LAYERS = 2  # 4h's main run (of 24)
RWKV6_LAYERS = 8  # 4e, 4e-long, 5e and rwkv6's 4m (of 32)
# deepseek-v3's largest int_matmul shapes on the served path: (K, N) -> site
DEEPSEEK_SITES = {(18432, 7168): "dense mlp.w_out, largest K",
                  (7168, 129280): "head, largest N"}


START = time.perf_counter()


def phase(title: str) -> None:
    print(f"== [{time.perf_counter() - START:.1f} s] {title}", flush=True)


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def held_deploys(tag: str):
    """Every ``a2q_quantize`` kernel launch of the deploys inside the block
    held to the plain quantizer while the fp32 ``v`` is alive: the codes
    recomputed on the card with ``a2q_quantize_plain`` from the same ``v``
    and the same ``g/s``, ``s`` (from the same ``t``, ``d``), the flips
    counted with ``code_flips_explained``; a flip it does not explain fails
    the phase.  Yields the block's counts of matrices and flips."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.a2q_quantize import deployed_code_flips

    kernel, held = ops.a2q_quantize_cuda, {"matrices": 0, "flips": 0}

    def checked(v, gs, s, *, n, p, dequantize=True):
        deq, q, l1 = kernel(v, gs, s, n=n, p=p, dequantize=dequantize)
        flips, explained = deployed_code_flips(q, l1, v, gs, s, n=n, p=p)
        if not explained:
            raise AssertionError(f"{tag}: a deployed {tuple(v.shape)} matrix has {flips} codes off "
                                 "the plain quantizer's, not all one apart at a near-integer")
        held["matrices"] += 1
        held["flips"] += flips
        return deq, q, l1

    ops.a2q_quantize_cuda = checked
    try:
        yield held
    finally:
        ops.a2q_quantize_cuda = kernel
        print(f"{tag} deploy held to the plain quantizer on the card: {held['matrices']} matrices, "
              f"{held['flips']} code flips", flush=True)


def check_held(tag: str, held: dict, deploys: int) -> None:
    """Every deploy launch of a phase was held (the flips, all explained,
    go on the path's counts and are refused in phase 6, once every phase
    has run)."""
    if held["matrices"] != deploys:
        raise AssertionError(f"{tag}: {held['matrices']} of {deploys} deployed matrices held to the "
                             "plain quantizer")


@contextlib.contextmanager
def no_host_sync():
    """Any host sync inside the block raises (the split kernels' wrappers
    must choose their grids from shapes alone)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def replays_equal(fn, want) -> bool:
    """``fn``'s output captured in a CUDA graph and replayed twice: both
    replays equal ``want`` bit for bit (a split kernel keeps no state from
    one launch to the next)."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    got = []
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        got.append(out.clone())
    return all(torch.equal(t, want) for t in got)


def graph_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` (``reps`` back-to-back calls captured
    in one CUDA graph, replayed and timed with CUDA events)."""
    fn()  # warm up outside the capture (lazy library handles, allocator)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def events_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` back-to-back calls timed
    with CUDA events (for calls long enough that launch gaps do not count)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def a2q_bounded_weights(gen, K, N, device):
    """int8 (K, N) weights with every column's l1 norm within the A2Q budget
    of P=16, N=8 signed inputs (255.99), as ``deploy_params`` produces them."""
    w = torch.randint(-127, 128, (K, N), generator=gen, device=device, dtype=torch.int32)
    keep = torch.rand((K, N), generator=gen, device=device) < 24.0 / K
    w = w * keep
    l1 = w.abs().sum(0, keepdim=True).clamp_min(1)
    w = torch.trunc(w.float() * torch.clamp(255.0 / l1, max=1.0)).to(torch.int8)
    return w


def check_int_matmul(dev) -> dict:
    from repro_torch.kernels.int_matmul import int_matmul_cuda, int_matmul_plain
    from repro_torch.kernels.ops import int_matmul_block_k

    gen = torch.Generator(device=dev).manual_seed(1)
    per_layer = {M: {"ms": 0.0, "plain_ms": 0.0, "lib_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0,
                     "ops": 0.0, "splits": 0} for M in (1, 8, 64)}
    worst = 0.0
    for (K, N), count in SMOLLM_SITES.items():
        ws = [a2q_bounded_weights(gen, K, N, dev) for _ in range(LAYERS)]
        ws_cm = [w.t().contiguous().t() for w in ws]  # column-major copies for cuBLASLt
        scale = torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-4
        kw = dict(acc_bits=16, mode="exact", block_k=int_matmul_block_k(K), spill_int16=True)
        for M in (1, 8, 64):
            x = torch.randint(-128, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
            split = int_matmul_cuda.split_launches
            with no_host_sync():
                got = int_matmul_cuda(x, ws[0], scale, **kw)
            torch.cuda.synchronize()
            per_layer[M]["splits"] += count * (int_matmul_cuda.split_launches - split)
            want = int_matmul_plain(x, ws[0], scale, **kw)
            err = (got - want).abs().max().item()
            if not torch.equal(got, want):
                raise AssertionError(f"int_matmul M={M} K={K} N={N}: kernel != plain, max err {err}")
            worst = max(worst, err)
            it = iter(range(10**9))
            ms = graph_ms(lambda: int_matmul_cuda(x, ws[next(it) % LAYERS], scale, **kw), LAYERS)
            it = iter(range(10**9))
            plain_ms = graph_ms(lambda: int_matmul_plain(x, ws[next(it) % LAYERS], scale, **kw), LAYERS)
            # torch._int_mm's shape rule (M > 16, K and N multiples of 8): at
            # decode rows on x zero-padded to 24 rows, its smallest legal M
            xl = x if M > 16 else torch.cat([x, x.new_zeros((24 - M, K))])
            it = iter(range(10**9))
            lib_ms = graph_ms(lambda: torch._int_mm(xl, ws_cm[next(it) % LAYERS]), LAYERS)
            n_bytes = M * K + K * N + 4 * N + 4 * M * N
            n_ops = 2 * M * K * N
            b_ms, b_by = bound_ms(n_bytes, n_ops, INT8_OPS_PER_S)
            print(f"int_matmul M={M} K={K} N={N}: max_abs_err {err} kernel_ms {ms:.5f} "
                  f"plain_ms {plain_ms:.5f} bound_ms {b_ms:.6f} ({b_by}) "
                  f"library_ms(_int_mm{', x padded to 24 rows' if M <= 16 else ''}) "
                  f"{lib_ms:.5f}", flush=True)
            acc = per_layer[M]
            acc["ms"] += count * ms
            acc["plain_ms"] += count * plain_ms
            acc["lib_ms"] += count * lib_ms
            acc["bytes"] += count * n_bytes
            acc["ops"] += count * n_ops
    # the other carry modes and the raw int32 output, on full-range weights
    x = torch.randint(-128, 128, (8, 1536), generator=gen, device=dev, dtype=torch.int8)
    w = torch.randint(-128, 128, (1536, 576), generator=gen, device=dev, dtype=torch.int8)
    for kw in (dict(acc_bits=32, mode="exact"), dict(acc_bits=16, mode="wrap", spill_int16=True),
               dict(acc_bits=16, mode="saturate", spill_int16=True),
               dict(acc_bits=12, mode="saturate")):
        got = int_matmul_cuda(x, w, block_k=512, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, int_matmul_plain(x, w, block_k=512, **kw)):
            raise AssertionError(f"int_matmul {kw}: kernel != plain")
        print(f"int_matmul raw int32 {kw}: equal", flush=True)
    for M, acc in per_layer.items():
        acc["bound_ms"], acc["bound_by"] = bound_ms(acc["bytes"], acc["ops"], INT8_OPS_PER_S)
        print(f"int_matmul one layer's 7 calls at M={M}: kernel_ms {acc['ms']:.5f} "
              f"plain_ms {acc['plain_ms']:.5f} library_ms(_int_mm) {acc['lib_ms']:.5f} "
              f"bound_ms {acc['bound_ms']:.6f} ({acc['bound_by']}); {acc['splits']} of the 7 calls "
              "over several K splits", flush=True)
    dec = per_layer[8]
    return {"name": "int_matmul", "route": "cuda", "source": "src/repro_torch/csrc/int_matmul.cu",
            "replaces": "src/repro/kernels/int_matmul.py:300",
            "at": "one smollm-135m layer's 7 decode calls, M=8, int16 carry, fused scale",
            "max_abs_err": worst, "ms": dec["ms"], "plain_ms": dec["plain_ms"],
            "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"], "library_ms": dec["lib_ms"],
            "library": "torch._int_mm on x zero-padded to 24 rows (its smallest legal M)"}


SERVED_ROWS, SERVED_CONTEXT = 32, 2048  # SmolLM-135M's max_position_embeddings


def paged_case(dev, dtype, B=8, H=9, KV=3, Dh=64, bs=16, max_seq=96, lengths=None):
    gen = torch.Generator(device=dev).manual_seed(2)
    MB = max_seq // bs
    NB = B * MB + 1
    if lengths is None:
        lengths = torch.tensor([0, 1, 17, 33, 64, 65, 80, 96], dtype=torch.int32, device=dev)[:B]
    perm = torch.randperm(NB - 1, generator=gen, device=dev).to(torch.int32) + 1
    bt = perm[: B * MB].reshape(B, MB).clone()
    used = (lengths[:, None] + bs - 1) // bs
    bt[torch.arange(MB, device=dev)[None, :] >= used] = 0  # entries past the length: trash
    q = torch.randn((B, H, Dh), generator=gen, device=dev).to(dtype)
    kp = torch.randn((NB, bs, KV, Dh), generator=gen, device=dev).to(dtype)
    vp = torch.randn((NB, bs, KV, Dh), generator=gen, device=dev).to(dtype)
    return q, kp, vp, bt, lengths


def served_case(dev):
    """SmolLM-135M's 2048-token context: 32 rows of lengths drawn from the
    seed in [1536, 2048], fp32 pools (B=32, H=9, KV=3, Dh=64, bs=16)."""
    gen = torch.Generator(device=dev).manual_seed(16)
    lengths = torch.randint(SERVED_CONTEXT * 3 // 4, SERVED_CONTEXT + 1, (SERVED_ROWS,),
                            generator=gen, device=dev, dtype=torch.int32)
    return paged_case(dev, torch.float32, B=SERVED_ROWS, max_seq=SERVED_CONTEXT, lengths=lengths)


def paged_served(dev, kind: str) -> dict:
    """``paged_attention`` at the 2048-token context on ``kind`` pools
    (bf16, int8 or int4; bf16 q), over several table runs: within the
    bf16 tolerance of the plain version with no host sync, two graph
    replays equal to the eager call, then timed over 3 pool copies (past
    the L2) beside SDPA on the (dequantized) gathered view and the K/V
    bytes' bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain
    from repro_torch.nn.attention import _unpack_nibbles

    q, kp, vp, bt, lengths = served_case(dev)
    q = q.to(torch.bfloat16)
    B, H, Dh = q.shape
    NB, bs, KV, _ = kp.shape
    gen = torch.Generator(device=dev).manual_seed(17)
    copies = []
    for i in range(3):
        k, v = (kp, vp) if i == 0 else (torch.randn(kp.shape, generator=gen, device=dev)
                                        for _ in range(2))
        if kind == "bf16":
            copies.append((k.to(torch.bfloat16), v.to(torch.bfloat16), None, None))
        else:
            (kq, ks), (vq, vs) = (_quantize(t, 8 if kind == "int8" else 4) for t in (k, v))
            copies.append((kq, vq, ks, vs))
    k0, v0, ks0, vs0 = copies[0]
    split = paged_attention_cuda.split_launches
    with no_host_sync():
        got = paged_attention_cuda(q, k0, v0, bt, lengths, ks0, vs0)
    torch.cuda.synchronize()
    if paged_attention_cuda.split_launches == split:
        raise AssertionError("paged_attention at the 2048-token context ran one table run")
    err = (got.float() - paged_attention_plain(q, k0, v0, bt, lengths, ks0, vs0).float()
           ).abs().max().item()
    if not err <= ATTN_TOL[torch.bfloat16] or not torch.isfinite(got).all():
        raise AssertionError(f"paged_attention 2048-token context {kind}: max err {err}")
    if not replays_equal(lambda: paged_attention_cuda(q, k0, v0, bt, lengths, ks0, vs0), got):
        raise AssertionError(f"paged_attention 2048-token context {kind}: a graph replay differs")
    it = iter(range(10**9))

    def call():
        k, v, ks, vs = copies[next(it) % 3]
        return paged_attention_cuda(q, k, v, bt, lengths, ks, vs)

    ms = graph_ms(call, 3 * LAYERS)
    S = bt.shape[1] * bs
    if kind == "bf16":
        kd, vd = k0.float(), v0.float()
    else:
        kd, vd = ((_unpack_nibbles(c) if kind == "int4" else c).float() * sc[..., None]
                  for c, sc in ((k0, ks0), (v0, vs0)))
    G = H // KV
    kg, vg = (d[bt.long()].reshape(B, S, KV, Dh).transpose(1, 2).to(torch.bfloat16)
              .repeat_interleave(G, dim=1).contiguous() for d in (kd, vd))
    del kd, vd
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask), LAYERS)
    plain_ms = events_ms(lambda: paged_attention_plain(q, k0, v0, bt, lengths, ks0, vs0), 2)
    toks = lengths.sum().item()
    n_bytes = (2 * q.numel() * 2 + toks * KV * 2 * k0.shape[-1] * k0.element_size()
               + (toks * KV * 2 * 4 if ks0 is not None else 0) + bt.numel() * 4 + B * 4)
    b_ms, b_by = bound_ms(n_bytes, 4 * toks * H * Dh, FP32_FLOPS_PER_S)
    print(f"paged_attention {kind} pools, bf16 q, 2048-token context B={B} H={H} KV={KV} "
          f"Dh={Dh} bs={bs} ({toks} keys): max_abs_err {err:.3g}, graph replays equal, "
          f"kernel_ms {ms:.5f} plain_ms {plain_ms:.4f} bound_ms {b_ms:.5f} ({b_by}), "
          f"{b_ms / ms:.1%} of the bound, library_ms(sdpa, gathered) {lib_ms:.5f}", flush=True)
    return {"at": f"B={B} H={H} KV={KV} Dh={Dh} bs={bs} {kind} pools, bf16 q, lengths in "
                  f"[1536, 2048] ({toks} keys)", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
            "library_ms": lib_ms}


def check_paged_attention(dev) -> dict:
    """paged_attention against its plain version at smollm-135m's decode
    shape (fp32 and bf16 pools, ragged lengths, a window of 20, a NaN block
    behind an entry past a row's length), at the 2048-token context
    (``paged_served``) and at ``NEW_PAGED``, within ``ATTN_TOL``; timed
    beside the plain version, SDPA and the bound (``paged_times``)."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain

    entry = None
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, bt, lengths = paged_case(dev, dtype)
        B, H, Dh = q.shape
        KV = kp.shape[2]
        worst = 0.0
        for window in (None, 20):
            with no_host_sync():
                got = paged_attention_cuda(q, kp, vp, bt, lengths, window=window)
            torch.cuda.synchronize()
            want = paged_attention_plain(q, kp, vp, bt, lengths, window=window)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= ATTN_TOL[dtype]:
                raise AssertionError(f"paged_attention {dtype} window={window}: max err {err}")
            if not torch.isfinite(got).all() or got[0].abs().max().item() != 0.0:
                raise AssertionError("paged_attention: non-finite output or nonzero empty row")
            worst = max(worst, err)
        spare = sorted(set(range(1, kp.shape[0])) - set(bt.flatten().tolist()))[0]
        kp_nan, vp_nan, bt_past = kp.clone(), vp.clone(), bt.clone()
        kp_nan[spare] = vp_nan[spare] = float("nan")  # a block no live entry reaches...
        bt_past[2, -1] = spare  # ...but an entry past row 2's length
        past = paged_attention_cuda(q, kp_nan, vp_nan, bt_past, lengths)
        torch.cuda.synchronize()
        if not torch.equal(past, paged_attention_cuda(q, kp, vp, bt, lengths)):
            raise AssertionError(f"paged_attention {dtype} read a table entry past the length")
        t = paged_times(q, kp, vp, bt, lengths, LAYERS, plain_time=graph_ms)
        print(f"paged_attention {str(dtype).replace('torch.', '')} B={B} H={H} KV={KV} Dh={Dh} "
              f"bs={kp.shape[1]} lengths={lengths.tolist()}: max_abs_err {worst:.3g} "
              f"kernel_ms {t['ms']:.5f} plain_ms {t['plain_ms']:.5f} bound_ms "
              f"{t['bound_ms']:.6f} ({t['bound_by']}) library_ms(sdpa, gathered) "
              f"{t['library_ms']:.5f}", flush=True)
        if dtype == torch.bfloat16:  # the main path's pools
            entry = {"name": "paged_attention", "route": "cuda",
                     "source": "src/repro_torch/csrc/paged_attention.cu",
                     "replaces": "src/repro/kernels/paged_attention.py:212",
                     "at": "B=8 H=9 KV=3 Dh=64 bs=16 bf16 pools, ragged lengths incl. 0",
                     "max_abs_err": worst, **t,
                     "at_2048_context": paged_served(dev, "bf16"), "at_new_decoders": {}}
    # the shapes of llama4-scout's global layer and llava-next-34b's decode
    gen = torch.Generator(device=dev).manual_seed(25)
    for site, B, H, KV, Dh, lo, hi in NEW_PAGED:
        lengths = torch.randint(lo, hi + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
        q, kp, vp, bt, lengths = paged_case(dev, torch.bfloat16, B=B, H=H, KV=KV, Dh=Dh,
                                            max_seq=-(-hi // 16) * 16, lengths=lengths)
        with no_host_sync():
            got = paged_attention_cuda(q, kp, vp, bt, lengths)
        torch.cuda.synchronize()
        err = (got.float() - paged_attention_plain(q, kp, vp, bt, lengths).float()
               ).abs().max().item()
        if not err <= ATTN_TOL[torch.bfloat16] or not torch.isfinite(got).all():
            raise AssertionError(f"paged_attention {site}: max err {err}")
        t = paged_times(q, kp, vp, bt, lengths, 10,
                        plain_time=lambda fn, _: events_ms(fn, 2))
        print(f"paged_attention {site} B={B} H={H} KV={KV} Dh={Dh} bf16 pools "
              f"({lengths.sum().item()} keys): max_abs_err {err:.3g} kernel_ms {t['ms']:.5f} "
              f"plain_ms {t['plain_ms']:.4f} bound_ms {t['bound_ms']:.5f} ({t['bound_by']}), "
              f"{t['bound_ms'] / t['ms']:.1%} of the bound, library_ms(sdpa, gathered) "
              f"{t['library_ms']:.5f}", flush=True)
        entry["at_new_decoders"][f"{site} B={B} H={H} KV={KV} Dh={Dh}"] = {"max_abs_err": err,
                                                                          **t}
        del q, kp, vp
    return entry


def paged_times(q, kp, vp, bt, lengths, reps: int, plain_time) -> dict:
    """``paged_attention`` on (q, pools, table, lengths) timed in a CUDA
    graph of ``reps`` calls, its plain version by ``plain_time(fn, reps)``,
    SDPA on the already-gathered view (the gather not timed) and the bound:
    the K/V bytes of the live tokens, or QK^T and PV at the fp32 peak."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain

    B, H, Dh = q.shape
    KV = kp.shape[2]
    ms = graph_ms(lambda: paged_attention_cuda(q, kp, vp, bt, lengths), reps)
    plain_ms = plain_time(lambda: paged_attention_plain(q, kp, vp, bt, lengths), reps)
    S = bt.shape[1] * kp.shape[1]
    G = H // KV  # heads h*G..h*G+G-1 share KV head h
    kg, vg = (p[bt.long()].reshape(B, S, KV, Dh).transpose(1, 2).repeat_interleave(G, dim=1)
              .contiguous() for p in (kp, vp))
    mask = (torch.arange(S, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask), reps)
    toks = lengths.sum().item()
    n_bytes = (q.numel() * q.element_size() * 2 + toks * KV * Dh * 2 * kp.element_size()
               + bt.numel() * 4 + B * 4)
    n_ops = 4 * toks * H * Dh  # QK^T and PV multiply-adds, 2 flops each
    b_ms, b_by = bound_ms(n_bytes, n_ops, FP32_FLOPS_PER_S)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def check_int_matmul_deepseek(dev) -> dict:
    """int_matmul at deepseek-v3's largest K and largest N (A2Q-bounded
    weights, int16 carry, fused scale), against the plain version bit for
    bit; times at M=8 (decode) and M=32 (a prefill chunk)."""
    from repro_torch.kernels.int_matmul import int_matmul_cuda, int_matmul_plain
    from repro_torch.kernels.ops import int_matmul_block_k

    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for (K, N), site in DEEPSEEK_SITES.items():
        w = a2q_bounded_weights(gen, K, N, dev)
        w_cm = w.t().contiguous().t()  # column-major copy for cuBLASLt
        scale = torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-4
        kw = dict(acc_bits=16, mode="exact", block_k=int_matmul_block_k(K), spill_int16=True)
        for M in (8, 32):
            x = torch.randint(-128, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
            got = int_matmul_cuda(x, w, scale, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, int_matmul_plain(x, w, scale, **kw)):
                raise AssertionError(f"int_matmul M={M} K={K} N={N}: kernel != plain")
            ms = graph_ms(lambda: int_matmul_cuda(x, w, scale, **kw), 5)
            plain_ms = events_ms(lambda: int_matmul_plain(x, w, scale, **kw), 2)
            lib_ms = graph_ms(lambda: torch._int_mm(x, w_cm), 5) if M > 16 else None
            b_ms, b_by = bound_ms(M * K + K * N + 4 * N + 4 * M * N, 2 * M * K * N,
                                  INT8_OPS_PER_S)
            print(f"int_matmul deepseek {site} M={M} K={K} N={N}: equal, kernel_ms {ms:.4f} "
                  f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.5f} ({b_by}) library_ms(_int_mm) "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'}", flush=True)
            out[f"M={M} K={K} N={N}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                         "bound_by": b_by, "library_ms": lib_ms}
        del w, w_cm
    return out


RWKV_TM = (4096, 4096)  # rwkv6-7b's time-mix projections (K, N)
DEEPSEEK_W_OUT = (18432, 7168)  # deepseek-v3's dense mlp.w_out (K, N), the largest K
CROSSOVER_ROWS = (1, 8, 16, 24, 32)


def check_int_matmul_decode(dev) -> dict:
    """The split-K decode kernel at rwkv6-7b's 4096 x 4096 prologue shape
    (M=8, fp32 x, int16 carry, fused scale), over several K splits: bit for
    bit the plain version with no host sync, two CUDA-graph replays equal
    (the splits' sums meet in the cluster, nothing is kept between launches),
    timed over 4 weight copies
    (67 MB, past the L2) against the weight bytes; then the crossover: both
    kernels forced at M in {1, 8, 16, 24, 32} (int8 x, scale) at smollm's
    layer (7 calls, 30 weight copies), rwkv6's 4096 x 4096 and deepseek's
    18432 x 7168, with ``torch._int_mm`` (x padded to 24 rows below 17)."""
    from repro_torch.kernels.int_matmul import int_matmul_cuda, int_matmul_plain
    from repro_torch.kernels.ops import int_matmul_block_k

    gen = torch.Generator(device=dev).manual_seed(12)
    out = {}
    K, N = RWKV_TM
    ws = [a2q_bounded_weights(gen, K, N, dev) for _ in range(4)]
    scale = torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-4
    kw = dict(acc_bits=16, mode="exact", block_k=int_matmul_block_k(K), spill_int16=True,
              aq_scale=torch.tensor([6.0 / 127], device=dev), q_lo=-128, q_hi=127, q_shift=0)
    x = torch.randn((8, K), generator=gen, device=dev) * 3
    split = int_matmul_cuda.split_launches
    with no_host_sync():
        got = int_matmul_cuda(x, ws[0], scale, **kw)
    torch.cuda.synchronize()
    if int_matmul_cuda.split_launches == split:
        raise AssertionError("int_matmul at rwkv6's 4096 x 4096 ran one K split")
    if not torch.equal(got, int_matmul_plain(x, ws[0], scale, **kw)):
        raise AssertionError("int_matmul decode M=8 K=4096 N=4096: kernel != plain")
    if not replays_equal(lambda: int_matmul_cuda(x, ws[0], scale, **kw), got):
        raise AssertionError("int_matmul decode: a graph replay differs from the eager call")
    it = iter(range(10**9))
    ms = graph_ms(lambda: int_matmul_cuda(x, ws[next(it) % 4], scale, **kw), 8)
    plain_ms = events_ms(lambda: int_matmul_plain(x, ws[0], scale, **kw), 3)
    b_ms, b_by = bound_ms(4 * 8 * K + K * N + 4 * N + 4 * 8 * N, 2 * 8 * K * N, INT8_OPS_PER_S)
    print(f"int_matmul decode prologue rwkv6 tm M=8 K={K} N={N}: equal to plain, graph replays "
          f"equal, kernel_ms {ms:.5f} plain_ms {plain_ms:.4f} bound_ms {b_ms:.5f} ({b_by}), "
          f"{b_ms / ms:.1%} of the bound", flush=True)
    out["at_rwkv6"] = {f"M=8 K={K} N={N} prologue": {"ms": ms, "plain_ms": plain_ms,
                                                      "bound_ms": b_ms, "bound_by": b_by,
                                                      "bound_share": b_ms / ms}}
    del ws
    # the crossover
    shapes = [("smollm layer", [(K, N, c) for (K, N), c in SMOLLM_SITES.items()], LAYERS),
              ("rwkv6 tm", [(*RWKV_TM, 1)], 4), ("deepseek w_out", [(*DEEPSEEK_W_OUT, 1)], 1)]
    out["crossover"] = {}
    for site, parts, copies in shapes:
        mats = [([a2q_bounded_weights(gen, K, N, dev) for _ in range(copies)],
                 torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-4, K, N, c)
                for K, N, c in parts]
        for m in CROSSOVER_ROWS:
            row = {"decode_ms": 0.0, "tc_ms": 0.0, "library_ms": 0.0, "bytes": 0, "ops": 0}
            for ws, sc, K, N, c in mats:
                x = torch.randint(-128, 128, (m, K), generator=gen, device=dev, dtype=torch.int8)
                kw = dict(acc_bits=16, mode="exact", block_k=int_matmul_block_k(K),
                          spill_int16=True)
                want = int_matmul_plain(x, ws[0], sc, **kw)
                for tc in (False, True):
                    with int_matmul_route(tc):
                        got = int_matmul_cuda(x, ws[0], sc, **kw)
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            raise AssertionError(f"int_matmul {site} M={m} K={K} N={N} tc={tc}: "
                                                 "kernel != plain")
                        it = iter(range(10**9))
                        row["tc_ms" if tc else "decode_ms"] += c * graph_ms(
                            lambda: int_matmul_cuda(x, ws[next(it) % copies], sc, **kw),
                            max(copies, 8))
                xl = x if m > 16 else torch.cat([x, x.new_zeros((24 - m, K))])
                cms = [w.t().contiguous().t() for w in ws]
                it = iter(range(10**9))
                row["library_ms"] += c * graph_ms(
                    lambda: torch._int_mm(xl, cms[next(it) % copies]), max(copies, 8))
                del cms
                row["bytes"] += c * (m * K + K * N + 4 * N + 4 * m * N)
                row["ops"] += c * 2 * m * K * N
            row["bound_ms"], row["bound_by"] = bound_ms(row.pop("bytes"), row.pop("ops"),
                                                        INT8_OPS_PER_S)
            print(f"int_matmul crossover {site} M={m} (int8 x, scale): decode_ms "
                  f"{row['decode_ms']:.5f} tc_ms {row['tc_ms']:.5f} library_ms(_int_mm"
                  f"{', x padded to 24 rows' if m <= 16 else ''}) {row['library_ms']:.5f} "
                  f"bound_ms {row['bound_ms']:.6f} ({row['bound_by']}); the wrapper runs "
                  f"{'tc' if m >= tc_min_rows() else 'decode'}", flush=True)
            out["crossover"][f"{site} M={m}"] = row
        del mats
    return out


def tc_min_rows() -> int:
    import importlib

    return importlib.import_module("repro_torch.kernels.int_matmul").TC_MIN_ROWS


def mla_case(dev, dtype, B=8, H=128, R=512, P=64, bs=16, max_seq=96):
    gen = torch.Generator(device=dev).manual_seed(4)
    MB = max_seq // bs
    NB = B * MB + 2
    lengths = torch.tensor([0, 1, 17, 33, 64, 65, 80, 96], dtype=torch.int32, device=dev)[:B]
    perm = torch.randperm(NB - 2, generator=gen, device=dev).to(torch.int32) + 1
    bt = perm[: B * MB].reshape(B, MB).clone()
    used = (lengths[:, None] + bs - 1) // bs
    bt[torch.arange(MB, device=dev)[None, :] >= used] = 0  # entries past the length: trash
    q_lat = torch.randn((B, H, R), generator=gen, device=dev)
    q_pe = torch.randn((B, H, P), generator=gen, device=dev)
    ckvp = torch.randn((NB, bs, R), generator=gen, device=dev).to(dtype)
    kpep = torch.randn((NB, bs, P), generator=gen, device=dev).to(dtype)
    return q_lat, q_pe, ckvp, kpep, bt, lengths


def mla_bound(toks, B, H, R, P, pool_row_bytes, scale_bytes):
    """The least time for one call: the pools' bytes of the valid keys (and
    their scales), the queries in and the output out at 3.35 TB/s, or the
    2 H (R + P + R) operations a key (scores and PV) at the 989 TFLOP/s of
    the bf16 tensor cores, whichever is larger.  The kernel's extra products
    (q in three bf16 terms, P in two or three) are its own overhead, not the
    bound's."""
    n_bytes = toks * (pool_row_bytes + scale_bytes) + 4 * B * H * (R + P + R) + 8 * B
    return bound_ms(n_bytes, 2 * H * toks * (R + P + R), BF16_FLOPS_PER_S)


def mla_sdpa_ms(q_lat, q_pe, ckv_d, kpe_d, bt, lengths, scale, dtype) -> float:
    """SDPA on the (dequantized) gathered view, one KV head shared by every
    query head: the same function without the replay."""
    import torch.nn.functional as F

    B, H, R = q_lat.shape
    P, bs = q_pe.shape[-1], ckv_d.shape[1]
    S = bt.shape[1] * bs
    ckv_g = ckv_d[bt.long()].reshape(B, 1, S, R).to(dtype)
    kpe_g = kpe_d[bt.long()].reshape(B, 1, S, P).to(dtype)
    qs = torch.cat([q_lat, q_pe], dim=-1)[:, :, None, :].to(dtype)
    kg = torch.cat([ckv_g, kpe_g], dim=-1).contiguous()
    vg = ckv_g.contiguous()
    mask = (torch.arange(S, device=q_lat.device)[None, :] < lengths[:, None])[:, None, None, :]
    return graph_ms(lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=mask, scale=scale, enable_gqa=True), 5)


MLA_SERVED = (3072, 4096)  # DeepSeek-V3's 4K pre-training context (arXiv:2412.19437)


def mla_served(dev, kind: str) -> dict:
    """paged_mla_attention at a served context: B=8 rows at DeepSeek-V3's 4K
    pre-training length (lengths from the seed in [3072, 4096]), H=128,
    R=512, P=64, bs=16, the replay at 8 bits, on bf16, int8 or int4 pools:
    within MLA_TOL of the plain version, two CUDA-graph replays equal to
    the eager call, no host sync; timed on pool copies that rotate past the
    L2, beside the plain version, SDPA on the gathered view and the bound."""
    from repro_torch.kernels.paged_mla_attention import (
        paged_mla_attention_cuda,
        paged_mla_attention_plain,
    )
    from repro_torch.nn.attention import _unpack_nibbles

    B, H, R, P, bs, MB = 8, 128, 512, 64, 16, MLA_SERVED[1] // 16
    scale = (128 + 64) ** -0.5
    kw = {"aq_scale": torch.tensor([0.02], device=dev), "act_bits": 8}
    gen = torch.Generator(device=dev).manual_seed(12)
    lengths = torch.randint(MLA_SERVED[0], MLA_SERVED[1] + 1, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    NB = B * MB + 1
    bt = (torch.randperm(NB - 1, generator=gen, device=dev).to(torch.int32) + 1)[: B * MB]
    bt = bt.reshape(B, MB).clone()
    bt[torch.arange(MB, device=dev)[None, :] >= (lengths[:, None] + bs - 1) // bs] = 0
    q_lat = torch.randn((B, H, R), generator=gen, device=dev)
    q_pe = torch.randn((B, H, P), generator=gen, device=dev)
    copies = 3  # 3 x 37.8 MB of bf16 pools: past the 50 MB L2 for every pool type
    pools = []
    for _ in range(copies):
        ckv = torch.randn((NB, bs, R), generator=gen, device=dev)
        kpe = torch.randn((NB, bs, P), generator=gen, device=dev)
        if kind == "bf16":
            pools.append((ckv.bfloat16(), kpe.bfloat16(), None, None))
        else:
            (cq, cs), (kq, ks) = (_quantize(t, 8 if kind == "int8" else 4) for t in (ckv, kpe))
            pools.append((cq, kq, cs, ks))
    ckvp, kpep, ckvs, kpes = pools[0]
    args = (q_lat, q_pe, ckvp, kpep, bt, lengths, ckvs, kpes)
    tc0 = paged_mla_attention_cuda.tc_launches
    with no_host_sync():
        got = paged_mla_attention_cuda(*args, scale=scale, **kw)
    torch.cuda.synchronize()
    if paged_mla_attention_cuda.tc_launches != tc0 + 1:
        raise AssertionError(f"paged_mla_attention {kind}: not on the tensor-core kernel")
    want = paged_mla_attention_plain(*args, scale=scale, **kw)
    err = (got - want).abs().max().item()
    replays = replays_equal(lambda: paged_mla_attention_cuda(*args, scale=scale, **kw), got)
    if not err <= MLA_TOL or not torch.isfinite(got).all() or not replays:
        raise AssertionError(f"paged_mla_attention 4K {kind}: max err {err}, graph replays equal "
                             f"{replays}")
    it = iter(range(10**9))

    def call():
        c, k, cs, ks = pools[next(it) % copies]
        return paged_mla_attention_cuda(q_lat, q_pe, c, k, bt, lengths, cs, ks, scale=scale, **kw)

    ms = graph_ms(call, 30)
    plain_ms = graph_ms(lambda: paged_mla_attention_plain(*args, scale=scale, **kw), 3)
    if kind == "bf16":
        ckv_d, kpe_d = ckvp.float(), kpep.float()
    else:
        ckv_d, kpe_d = ((_unpack_nibbles(c) if kind == "int4" else c).float() * sc[..., None]
                        for c, sc in ((ckvp, ckvs), (kpep, kpes)))
    lib_ms = mla_sdpa_ms(q_lat, q_pe, ckv_d, kpe_d, bt, lengths, scale, torch.bfloat16)
    toks = int(lengths.sum())
    b_ms, b_by = mla_bound(toks, B, H, R, P, (ckvp.shape[-1] + kpep.shape[-1]) *
                           ckvp.element_size(), 0 if ckvs is None else 8)
    print(f"paged_mla_attention {kind} pools at the 4K context (B={B}, {toks} keys, lengths "
          f"{lengths.tolist()}) act_bits=8: max_abs_err {err:.3g}, two graph replays equal, "
          f"kernel_ms {ms:.5f} plain_ms {plain_ms:.5f} library_ms(sdpa, gathered, gqa) "
          f"{lib_ms:.5f} bound_ms {b_ms:.6f} ({b_by}, {b_ms / ms:.1%})", flush=True)
    del pools, args, got, want
    torch.cuda.empty_cache()
    return {"at": f"B=8 H=128 R=512 P=64 bs=16, {toks} keys ([3072, 4096] a row), {kind} pools, "
                  "act_bits=8 replay",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_share": b_ms / ms, "library_ms": lib_ms}


def check_paged_mla_attention(dev) -> dict:
    from repro_torch.kernels.paged_mla_attention import (
        paged_mla_attention_cuda,
        paged_mla_attention_plain,
    )

    scale = (128 + 64) ** -0.5  # (qk_nope_dim + qk_rope_dim) ** -0.5
    aq = torch.tensor([0.02], device=dev)  # |ckv| > 2.54 clips at 127
    entry = None
    for dtype in (torch.float32, torch.bfloat16):
        q_lat, q_pe, ckvp, kpep, bt, lengths = mla_case(dev, dtype)
        B, H, R = q_lat.shape
        P, bs = q_pe.shape[-1], ckvp.shape[1]
        poisoned = ckvp.clone()
        poisoned[-1] = float("nan")  # a block no live entry reaches...
        bt_past = bt.clone()
        bt_past[2, -1] = ckvp.shape[0] - 1  # ...but an entry past row 2's length
        worst = 0.0
        # fp32 pools (and replays over 9 bits) run on the CUDA cores, bf16 on the tensor cores
        tc = dtype == torch.bfloat16
        for kw in ({}, {"aq_scale": aq, "act_bits": 8}, {"aq_scale": aq, "act_bits": 12}):
            tc0 = paged_mla_attention_cuda.tc_launches
            with no_host_sync():
                got = paged_mla_attention_cuda(q_lat, q_pe, ckvp, kpep, bt, lengths, scale=scale,
                                               **kw)
            torch.cuda.synchronize()
            on_tc = paged_mla_attention_cuda.tc_launches > tc0
            if on_tc != (tc and kw.get("act_bits", 0) <= 9):
                raise AssertionError(f"paged_mla_attention {dtype} {kw}: tensor-core route {on_tc}")
            want = paged_mla_attention_plain(q_lat, q_pe, ckvp, kpep, bt, lengths, scale=scale, **kw)
            err = (got - want).abs().max().item()
            if not err <= MLA_TOL:
                raise AssertionError(f"paged_mla_attention {dtype} {kw}: max err {err}")
            if not torch.isfinite(got).all() or got[0].abs().max().item() != 0.0:
                raise AssertionError("paged_mla_attention: non-finite output or nonzero empty row")
            # row 1 has one key: its output is the staged latent itself, so the
            # replay's codes (out / s_aq) must equal the plain version's exactly
            if not torch.equal(got[1], want[1]):
                raise AssertionError(f"paged_mla_attention {dtype} {kw}: length-1 row differs")
            past = paged_mla_attention_cuda(q_lat, q_pe, poisoned, kpep, bt_past, lengths,
                                            scale=scale, **kw)
            torch.cuda.synchronize()
            if not torch.equal(past, got):
                raise AssertionError("paged_mla_attention read a table entry past the length")
            note = ""
            if kw:
                codes = torch.round(got[1] / aq)
                if not torch.equal(codes * aq, got[1]):
                    raise AssertionError("paged_mla_attention: replayed latent is off the grid")
                note = (f" replay codes in [{codes.min().item():.0f}, {codes.max().item():.0f}], "
                        f"{int((codes.abs() >= 127).sum().item())} of {codes.numel()} clipped")
            print(f"paged_mla_attention {str(dtype).replace('torch.', '')} act_bits="
                  f"{kw.get('act_bits')} ({'tensor cores' if on_tc else 'CUDA cores'}): "
                  f"max_abs_err {err:.3g}, length-1 row exact, entry past the length "
                  f"unread{note}", flush=True)
            worst = max(worst, err)
        kw = {"aq_scale": aq, "act_bits": 8}
        ms = graph_ms(lambda: paged_mla_attention_cuda(q_lat, q_pe, ckvp, kpep, bt, lengths,
                                                       scale=scale, **kw), LAYERS)
        plain_ms = graph_ms(lambda: paged_mla_attention_plain(q_lat, q_pe, ckvp, kpep, bt, lengths,
                                                              scale=scale, **kw), LAYERS)
        lib_ms = mla_sdpa_ms(q_lat, q_pe, ckvp.float(), kpep.float(), bt, lengths, scale, dtype)
        toks = lengths.sum().item()
        if tc:
            b_ms, b_by = mla_bound(toks, B, H, R, P, (R + P) * ckvp.element_size(), 0)
        else:  # fp32 inputs: the fp32 peak outside the tensor cores
            n_bytes = 4 * B * H * (R + P + R) + toks * (R + P) * 4 + 8 * B
            b_ms, b_by = bound_ms(n_bytes, 2 * H * toks * (R + P + R), FP32_FLOPS_PER_S)
        print(f"paged_mla_attention {str(dtype).replace('torch.', '')} B={B} H={H} R={R} P={P} "
              f"bs={bs} lengths={lengths.tolist()} act_bits=8: max_abs_err {worst:.3g} "
              f"kernel_ms {ms:.5f} plain_ms {plain_ms:.5f} bound_ms {b_ms:.6f} ({b_by}) "
              f"library_ms(sdpa, gathered, gqa) {lib_ms:.5f}", flush=True)
        if tc:  # the main path's pools
            entry = {"name": "paged_mla_attention", "route": "cuda", "kernel": "tc",
                     "source": "src/repro_torch/csrc/paged_mla_attention.cu",
                     "replaces": "src/repro/kernels/paged_attention.py:373",
                     "at": "B=8 H=128 R=512 P=64 bs=16 bf16 pools, act_bits=8 replay, "
                           "ragged lengths incl. 0 and 1",
                     "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms,
                     "at_4k_context": mla_served(dev, "bf16")}
    return entry


# int_matmul with the prologue past smollm's layer: (key in the entry, site, M,
# K, N), the shapes the main paths give it.  hymba's dt_proj and head are the
# only N that are not multiples of 8: the decode kernel's column tail, and the
# tensor-core kernel's register-copy route at the prefill chunk's 256 rows.
PROLOGUE_SHAPES = (
    ("at_deepseek", "deepseek-v3 mlp.w_out, decode", 8, 18432, 7168),
    ("at_deepseek", "deepseek-v3 mlp.w_out, a prefill chunk", 32, 18432, 7168),
    ("at_new_decoders", "hymba-1.5b mamba.in_proj, decode", 4, 1600, 3200),
    ("at_new_decoders", "hymba-1.5b mamba.dt_proj, decode", 4, 1600, 25),
    ("at_new_decoders", "hymba-1.5b mamba.dt_proj, prefill chunk", 256, 1600, 25),
    ("at_new_decoders", "hymba-1.5b mlp.w_out, decode", 4, 5504, 1600),
    ("at_new_decoders", "hymba-1.5b head, decode", 4, 1600, 32001),
    ("at_new_decoders", "llama4-scout head, decode (the largest N)", 2, 5120, 202048),
    ("at_new_decoders", "llava-next-34b mlp.w_out, decode (the largest K)", 8, 20480, 7168),
    ("at_new_decoders", "llava-next-34b mlp.w_in, patch prefill", 1280, 7168, 20480),
)


def check_int_matmul_prologue(dev) -> dict:
    """int_matmul with the quantizing prologue (fp32 activations quantized
    in the kernel, the ``--int-chain`` path) at smollm-135m's seven layer
    shapes (M=8, signed and unsigned 8-bit inputs) and at
    ``PROLOGUE_SHAPES`` (deepseek-v3's K=18432 at M=8, where all the
    threads quantize the few live rows, and M=32, a prefill chunk, where
    each thread quantizes its own segment; the shapes of hymba-1.5b,
    llama4-scout and llava-next-34b): bit for bit the plain version, the
    kernel's codes the standalone act-quant's (the same kernel on those int8
    codes gives the same output), and on the tensor cores exactly from
    ``TC_MIN_ROWS`` rows.  Times of one smollm layer's seven calls (signed
    inputs, the main path's) and of each of ``PROLOGUE_SHAPES``."""
    from repro_torch.kernels.int_matmul import int_matmul_cuda, int_matmul_plain, prologue_codes
    from repro_torch.kernels.ops import int_matmul_block_k

    gen = torch.Generator(device=dev).manual_seed(5)
    s_aq = torch.tensor([6.0 / 127], device=dev)  # the A2Q init's act scale
    worst = 0.0

    def check(x, w, scale, kw, pro, what):
        nonlocal worst
        tc = int_matmul_cuda.tc_launches
        got = int_matmul_cuda(x, w, scale, **kw, **pro)
        torch.cuda.synchronize()
        if (int_matmul_cuda.tc_launches > tc) != (x.shape[0] >= tc_min_rows()):
            raise AssertionError(f"int_matmul prologue {what}: ran on the "
                                 f"{'tensor-core' if int_matmul_cuda.tc_launches > tc else 'decode'}"
                                 " kernel")
        want = int_matmul_plain(x, w, scale, **kw, **pro)
        err = (got - want).abs().max().item()
        standalone = int_matmul_cuda(prologue_codes(x, s_aq, pro["q_lo"], pro["q_hi"],
                                                    pro["q_shift"]), w, scale, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or not torch.equal(got, standalone):
            raise AssertionError(f"int_matmul prologue {what}: kernel != plain (max err {err}) "
                                 "or != the kernel on the standalone codes")
        worst = max(worst, err)

    entry = None
    for signed in (True, False):
        lo, hi, shift = (-128, 127, 0) if signed else (0, 255, 128)
        pro = dict(aq_scale=s_aq, q_lo=lo, q_hi=hi, q_shift=shift)
        acc = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0}
        for (K, N), count in SMOLLM_SITES.items():
            ws = [a2q_bounded_weights(gen, K, N, dev) for _ in range(LAYERS)]
            scale = torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-4
            kw = dict(acc_bits=16, mode="exact", block_k=int_matmul_block_k(K), spill_int16=True)
            x = torch.randn((8, K), generator=gen, device=dev) * 3
            x = x if signed else x.abs()
            check(x, ws[0], scale, kw, pro, f"signed={signed} M=8 K={K} N={N}")
            it = iter(range(10**9))
            ms = graph_ms(lambda: int_matmul_cuda(x, ws[next(it) % LAYERS], scale, **kw, **pro),
                          LAYERS)
            it = iter(range(10**9))
            plain_ms = graph_ms(lambda: int_matmul_plain(x, ws[next(it) % LAYERS], scale, **kw,
                                                         **pro), LAYERS)
            n_bytes = 4 * 8 * K + K * N + 4 * N + 4 * 8 * N
            b_ms, b_by = bound_ms(n_bytes, 2 * 8 * K * N, INT8_OPS_PER_S)
            print(f"int_matmul prologue {'s8' if signed else 'u8'} M=8 K={K} N={N}: equal to plain "
                  f"and to the standalone codes, kernel_ms {ms:.5f} plain_ms {plain_ms:.5f} "
                  f"bound_ms {b_ms:.6f} ({b_by})", flush=True)
            acc["ms"] += count * ms
            acc["plain_ms"] += count * plain_ms
            acc["bytes"] += count * n_bytes
            acc["ops"] += count * 2 * 8 * K * N
        b_ms, b_by = bound_ms(acc["bytes"], acc["ops"], INT8_OPS_PER_S)
        print(f"int_matmul prologue {'s8' if signed else 'u8'}, one smollm layer's 7 calls at M=8: "
              f"kernel_ms {acc['ms']:.5f} plain_ms {acc['plain_ms']:.5f} bound_ms {b_ms:.6f} "
              f"({b_by})", flush=True)
        if signed:  # the main path's activations
            entry = {"name": "int_matmul[prologue]", "route": "cuda",
                     "source": "src/repro_torch/csrc/int_matmul.cu",
                     "replaces": "src/repro/kernels/int_matmul.py:300",
                     "at": "one smollm-135m layer's 7 decode calls, M=8, fp32 x quantized in the "
                           "prologue (signed 8-bit), int16 carry, fused scale",
                     "ms": acc["ms"], "plain_ms": acc["plain_ms"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, "at_deepseek": {},
                     "at_new_decoders": {}}
    pro = dict(aq_scale=s_aq, q_lo=-128, q_hi=127, q_shift=0)
    for at, site, M, K, N in PROLOGUE_SHAPES:
        w = a2q_bounded_weights(gen, K, N, dev)
        scale = torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-4
        kw = dict(acc_bits=16, mode="exact", block_k=int_matmul_block_k(K), spill_int16=True)
        x = torch.randn((M, K), generator=gen, device=dev) * 3
        check(x, w, scale, kw, pro, f"{site} M={M} K={K} N={N}")
        ms = graph_ms(lambda: int_matmul_cuda(x, w, scale, **kw, **pro), 5)
        plain_ms = events_ms(lambda: int_matmul_plain(x, w, scale, **kw, **pro), 2)
        # the library: torch._int_mm on the prologue's int8 codes, within its
        # shape rule (M > 16 and M, K, N multiples of 8): rows zero-padded to
        # 24 below 17, N zero-padded to a multiple of 8 (hymba's 25 and 32001)
        M_l, N_l = max(-(-M // 8) * 8, 24), -(-N // 8) * 8
        codes = torch.zeros((M_l, K), dtype=torch.int8, device=dev)
        codes[:M] = prologue_codes(x, s_aq, -128, 127, 0)
        w_l = torch.zeros((K, N_l), dtype=torch.int8, device=dev)
        w_l[:, :N] = w
        w_l = w_l.t().contiguous().t()  # column-major for cuBLASLt
        lib_ms = graph_ms(lambda: torch._int_mm(codes, w_l), 5)
        pad = (f", padded to M={M_l}" if M_l != M else "") + (f" N={N_l}" if N_l != N else "")
        del codes, w_l
        b_ms, b_by = bound_ms(4 * M * K + K * N + 4 * N + 4 * M * N, 2 * M * K * N,
                              INT8_OPS_PER_S)
        print(f"int_matmul prologue {site} M={M} K={K} N={N} "
              f"({'tensor-core' if M >= tc_min_rows() else 'decode'} kernel): equal to plain and "
              f"to the standalone codes, kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
              f"{b_ms:.5f} ({b_by}), {b_ms / ms:.1%} of the bound; library_ms(_int_mm on the "
              f"codes{pad}) {lib_ms:.4f}", flush=True)
        key = f"M={M} K={K} N={N}" if at == "at_deepseek" else f"{site} M={M} K={K} N={N}"
        entry[at][key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": lib_ms, "library": f"torch._int_mm on the codes{pad}"}
        del w
    entry["max_abs_err"] = worst
    return entry


RWKV_CM_WK = (4096, 14336)  # rwkv6-7b's cm.wk (K, N): the requant epilogue's site
# rwkv6_scan vs plain: the same fp32 recurrence with its 64-deep sums split in
# four and contracted into FMAs: 1e-5 of the largest |y| and |S| with fp32 y;
# one bf16 rounding of y (2^-7 of the largest |y|) with bf16 y
RWKV_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}


def check_int_matmul_requant(dev) -> dict:
    """int_matmul with the requantizing epilogue behind the prologue, as
    rwkv6's cm.wk runs it under ``--int-chain`` (fp32 x quantized in the
    kernel, relu^2 replayed in bf16, unsigned 8-bit codes out for cm.wv), at
    cm.wk's shape (K=4096, N=14336) and a reduced one (K=N=64), M=8 (decode)
    and M=32 (a prefill chunk): bit for bit the plain version.  At cm.wk's
    shape timed (CUDA graphs over two weight copies) beside the
    prologue-only kernel (fp32 out) on the same inputs and the weight-byte
    bound."""
    from repro_torch.kernels.int_matmul import int_matmul_cuda, int_matmul_plain
    from repro_torch.kernels.ops import int_matmul_block_k

    gen = torch.Generator(device=dev).manual_seed(6)
    pro = dict(aq_scale=torch.tensor([6.0 / 127], device=dev), q_lo=-128, q_hi=127, q_shift=0)
    entry = None
    for K, N in ((64, 64), RWKV_CM_WK):
        w = a2q_bounded_weights(gen, K, N, dev)
        scale = torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-4
        kw = dict(acc_bits=16, mode="exact", block_k=int_matmul_block_k(K), spill_int16=True,
                  **pro)
        for M in (8, 32):
            x = torch.randn((M, K), generator=gen, device=dev) * 3
            y = int_matmul_plain(x, w, scale, **kw)
            # the consumer's scale: relu^2 of the flush spans ~1.3x the codes
            req = dict(out_scale=torch.full((N,), (y.clamp_min(0) ** 2).max().item() / 200,
                                            device=dev),
                       r_lo=0, r_hi=255, r_shift=128, act_fn="relu2", cast_dtype=torch.bfloat16)
            got = int_matmul_cuda(x, w, scale, **kw, **req)
            torch.cuda.synchronize()
            want = int_matmul_plain(x, w, scale, **kw, **req)
            if not torch.equal(got, want):
                raise AssertionError(f"int_matmul requant M={M} K={K} N={N}: kernel != plain in "
                                     f"{(got != want).sum().item()} codes")
            codes = len(torch.unique(got))
            if (K, N) != RWKV_CM_WK:
                print(f"int_matmul requant M={M} K={K} N={N}: equal ({codes} distinct codes)",
                      flush=True)
                continue
            ws = [w, a2q_bounded_weights(gen, K, N, dev)]  # two copies: past the L2
            it = iter(range(10**9))
            ms = graph_ms(lambda: int_matmul_cuda(x, ws[next(it) % 2], scale, **kw, **req), 20)
            it = iter(range(10**9))
            pro_ms = graph_ms(lambda: int_matmul_cuda(x, ws[next(it) % 2], scale, **kw), 20)
            del ws
            plain_ms = events_ms(lambda: int_matmul_plain(x, w, scale, **kw, **req), 3)
            b_ms, b_by = bound_ms(4 * M * K + K * N + 8 * N + M * N, 2 * M * K * N,
                                  INT8_OPS_PER_S)
            print(f"int_matmul requant (prologue + relu2 in bf16 -> u8) M={M} K={K} N={N}: equal "
                  f"({codes} distinct codes), kernel_ms {ms:.4f} prologue-only kernel_ms "
                  f"{pro_ms:.4f} plain_ms {plain_ms:.4f} bound_ms {b_ms:.5f} ({b_by})", flush=True)
            at = {"ms": ms, "prologue_only_ms": pro_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                  "bound_by": b_by, "library_ms": None}
            if M == 8:
                entry = {"name": "int_matmul[requant]", "route": "cuda",
                         "source": "src/repro_torch/csrc/int_matmul.cu",
                         "replaces": "src/repro/kernels/int_matmul.py:300",
                         "at": "rwkv6-7b cm.wk, M=8 K=4096 N=14336: fp32 x through the prologue, "
                               "int16 carry, relu^2 replayed in bf16, unsigned 8-bit codes out",
                         "max_abs_err": 0.0, **at}
            else:
                entry["at_prefill"] = {f"M={M} K={K} N={N}": at}
        del w
    return entry


def _rwkv6_inputs(dev, B, H, T, D, dtype, seed):
    """r, k, v in ``dtype`` and fp32 w as the time-mix makes them: head views
    ``(B, H, T, D)`` of ``(B, T, H * D)`` projections; u and a state."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def heads(t):
        return t.reshape(B, T, H, D).transpose(1, 2)

    r, k, v = (heads(torch.randn((B, T, H * D), generator=g, device=dev).to(dtype))
               for _ in range(3))
    w = heads(torch.exp(-torch.exp(torch.randn((B, T, H * D), generator=g, device=dev) - 0.6)))
    return r, k, v, w, torch.randn((H, D), generator=g, device=dev) * 0.5, \
        torch.randn((B, H, D, D), generator=g, device=dev)


def check_rwkv6_scan(dev) -> list:
    """rwkv6_scan at rwkv6-7b's shapes against its plain version: decode
    (B=8, H=64, T=1, bf16 r/k/v, fp32 y, the carried state updated in place)
    on the step kernel; on the chunked kernel a prefill chunk (B=1, T=32,
    carried state, bf16 y), a T=64 chunk with the decay floored at e^-8
    (some decays below it), a long prompt's engine chunk (B=1, T=512,
    carried, floored), a whole 4096-token prompt (cacheless, floored) and 8
    x 64 tokens (the 4e gates' cacheless forward, floored); each timed (CUDA
    graphs of back-to-back calls; the plain version from T=512 on with CUDA
    events around one call) beside the plain version and its bound.  The
    wrappers' counters show which kernel ran.  No single PyTorch call
    computes this recurrence (no library time).  Returns the step kernel's
    entry and the chunked kernel's."""
    import math

    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda, rwkv6_scan_plain

    entries = {}
    for tag, (B, T, out_dtype, floor, carried) in {
            "decode": (8, 1, torch.float32, False, True),
            "prefill T=32": (1, 32, torch.bfloat16, False, True),
            "chunk T=64, floored": (1, 64, torch.bfloat16, True, False),
            "engine chunk T=512, floored": (1, 512, torch.bfloat16, True, True),
            "prompt T=4096, cacheless, floored": (1, 4096, torch.bfloat16, True, False),
            "cacheless 8 x 64, floored": (8, 64, torch.bfloat16, True, False)}.items():
        H, D = 64, 64
        r, k, v, w, u, s0 = _rwkv6_inputs(dev, B, H, T, D, torch.bfloat16, seed=T + B)
        if floor:
            w[..., ::7] = 1e-5
        kw = dict(out_dtype=out_dtype, min_w=math.exp(-8.0) if floor else None)
        init = s0 if carried else None
        state = s0.clone() if carried else None
        chunked0 = rwkv6_scan_cuda.chunked_launches
        y, s = rwkv6_scan_cuda(r, k, v, w, u, state, state_out=state, **kw)
        torch.cuda.synchronize()
        kernel = "chunked" if rwkv6_scan_cuda.chunked_launches > chunked0 else "step"
        if kernel != ("step" if T == 1 else "chunked"):
            raise AssertionError(f"rwkv6_scan {tag}: ran the {kernel} kernel")
        y_p, s_p = rwkv6_scan_plain(r, k, v, w, u, init, **kw)
        err_y = (y.float() - y_p.float()).abs().max().item()
        err_s = (s - s_p).abs().max().item()
        tol_y = RWKV_TOL[out_dtype] * y_p.float().abs().max().item()
        tol_s = 1e-5 * s_p.abs().max().item()
        if not (err_y <= tol_y and err_s <= tol_s) or (carried and s is not state):
            raise AssertionError(f"rwkv6_scan {tag}: y err {err_y} > {tol_y} or state err "
                                 f"{err_s} > {tol_s}")
        reps = 30 if T == 1 else 10
        ms = graph_ms(lambda: rwkv6_scan_cuda(r, k, v, w, u, state, state_out=state, **kw), reps)
        plain_ms = (graph_ms(lambda: rwkv6_scan_plain(r, k, v, w, u, init, **kw), reps) if T < 512
                    else events_ms(lambda: rwkv6_scan_plain(r, k, v, w, u, init, **kw), 1))
        n = B * H * T * D
        n_bytes = 3 * 2 * n + 4 * n + 4 * H * D + out_dtype.itemsize * n + \
            4 * B * H * D * D * (2 if carried else 1)
        # the recurrence's operations, at the peak of the units that run them:
        # the step kernel's fp32 FMAs, the chunked kernel's bf16 tensor cores
        b_ms, b_by = bound_ms(n_bytes, 7 * n * D,
                              FP32_FLOPS_PER_S if kernel == "step" else BF16_FLOPS_PER_S)
        print(f"rwkv6_scan {tag} B={B} H={H} T={T} D={D} ({kernel} kernel): y err {err_y:.3g} "
              f"(tol {tol_y:.3g}), state err {err_s:.3g} (tol {tol_s:.3g}), kernel_ms {ms:.5f} "
              f"plain_ms {plain_ms:.5f} bound_ms {b_ms:.6f} ({b_by})", flush=True)
        at = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
              "library_ms": None}
        name = "rwkv6_scan" if kernel == "step" else "rwkv6_scan[chunked]"
        if name not in entries:
            entries[name] = {
                "name": name, "route": "cuda", "source": "src/repro_torch/csrc/rwkv6_scan.cu",
                "replaces": "src/repro/kernels/rwkv6_scan.py:100",
                "kernel": "rwkv6_scan_kernel (step)" if kernel == "step" else
                          "chunk::rwkv6_chunk_kernel (bf16 tensor cores, mma.sync m16n8k16)",
                "at": f"rwkv6-7b {tag}, B={B} H={H} T={T} D={D}, bf16 r/k/v", "max_abs_err": 0.0,
                **at}
        else:
            entries[name][f"at {tag}"] = at
        entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], err_y)
    return [entries["rwkv6_scan"], entries["rwkv6_scan[chunked]"]]


HUBERT_SITES = {  # (K, N) of the six deployed linears of one hubert-xlarge layer -> count
    (1280, 1280): 4,  # attn.wq, wk, wv, wo
    (1280, 5120): 1,  # mlp.w_in (gelu requant into w_out)
    (5120, 1280): 1,  # mlp.w_out (int8 codes in)
}
HUBERT_HEAD = (1280, 504)  # the boundary classification head
HUBERT_CLIPS, HUBERT_FRAMES = 8, 1000  # 20 s of 16 kHz audio at HuBERT's 20 ms frame stride
# flash_attention vs plain: the fp32 softmax summed in another order (2e-5, as
# the reference's own test), plus one bf16 rounding of the output in bf16


def flash_within_tolerance(got, want) -> tuple[bool, float]:
    g, w = got.float(), want.float()
    tol = torch.full_like(w, 2e-5)
    if want.dtype == torch.bfloat16:
        top = torch.maximum(g.abs(), w.abs())
        tol = tol + torch.ldexp(torch.ones_like(w), torch.frexp(top).exponent - 8)
    err = (g - w).abs()
    return bool((err <= tol).all()), err.max().item()


def check_a2q_quantize(dev) -> dict:
    """a2q_quantize against its plain version (``a2q_int_weights``'
    arithmetic) at every matrix shape a run deploys (``DEPLOY_SHAPES`` of
    ``tools/time_decode_kernels.py``: smollm-135m, deepseek-v3's experts,
    dense mlp, MLA projections and head, rwkv6-7b, hubert-xlarge), on the A2Q
    initializer's (v, t, d) at P=16, 8-bit signed inputs: l1 and codes equal
    (both sum in ``core.a2q.pairwise_sum``'s fp32 order; flips counted with
    ``code_flips_explained``, none allowed), and the A2Q bound exactly: every
    column's ``sum |q|`` within ``l1_budget``; at hubert's four shapes and
    rwkv6-7b's cm.wk also the launch that writes the dequantized weights,
    equal to the plain version's.  Each shape timed as the deploy calls it
    (codes only; CUDA graphs of back-to-back calls on copies that rotate past
    the L2), beside the byte bound, and summed over the shapes' counts into
    the deploy kernel ms a run; the plain version timed at hubert's shapes;
    no single PyTorch call computes the quantizer (no library time)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.a2q import _effective_gs
    from repro_torch.core.bounds import l1_budget
    from repro_torch.kernels.a2q_quantize import (a2q_quantize_cuda, a2q_quantize_plain,
                                                  code_flips_explained)
    from repro_torch.nn.linear import init_linear

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from time_decode_kernels import DEPLOY_COPIES, DEPLOY_SHAPES, copies_for

    quant = get_arch("hubert-xlarge").quant
    P, N = quant.acc_bits, quant.act_bits
    budget = l1_budget(P, N, True)
    gen = torch.Generator(device=dev).manual_seed(8)
    layer = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0}
    run = {"ms": 0.0, "bound_ms": 0.0, "matrices": 0}
    at, worst, flips_total = {}, 0.0, 0
    with_deq = {(1280, 1280), (1280, 5120), (5120, 1280), (1280, 504), (4096, 14336)}
    for site, K, C, count in DEPLOY_SHAPES:
        n = min(copies_for(4 * K * C), DEPLOY_COPIES)
        args = []
        for _ in range(n):
            p = init_linear(gen, K, C, quant, boundary=site == "hubert head")
            gs, s = _effective_gs(p, P, N, True)
            args.append((p["v"], gs, s))
            del p
        v, gs, s = args[0]
        with no_host_sync():
            _, q, l1 = a2q_quantize_cuda(v, gs, s, n=-128, p=127, dequantize=False)
        torch.cuda.synchronize()
        deq_p, q_p, l1_p = a2q_quantize_plain(v, gs, s, n=-128, p=127,
                                              dequantize=(K, C) in with_deq)
        l1_rel = ((l1 - l1_p).abs() / l1_p).max().item()
        flips, explained = code_flips_explained(q, q_p, v, gs, l1, l1_p)
        col_l1 = q.to(torch.int64).abs().sum(0)
        if not torch.equal(l1, l1_p) or flips or not (col_l1 <= budget).all():
            raise AssertionError(f"a2q_quantize {site} K={K} C={C}: l1 rel err {l1_rel}, {flips} "
                                 f"code flips (explained {explained}), or a column's l1 "
                                 f"{col_l1.max().item()} above the budget {budget}")
        deq_ms = err = plain_ms = None
        if (K, C) in with_deq:
            deq, q_d, _ = a2q_quantize_cuda(v, gs, s, n=-128, p=127)
            torch.cuda.synchronize()
            err = (deq - deq_p).abs().max().item()
            if not torch.equal(deq, deq_p) or not torch.equal(q_d, q):
                raise AssertionError(f"a2q_quantize K={K} C={C}: dequantized weights or codes "
                                     "with deq differ")
            worst = max(worst, err)
            deq_ms = events_ms(lambda: a2q_quantize_cuda(v, gs, s, n=-128, p=127), 10)
            plain_ms = events_ms(lambda: a2q_quantize_plain(v, gs, s, n=-128, p=127,
                                                             dequantize=False), 3)
            del deq, q_d
        flips_total += flips
        it = iter(range(10**9))
        ms = graph_ms(lambda: a2q_quantize_cuda(*args[next(it) % n], n=-128, p=127,
                                                dequantize=False), 2 * n)
        n_bytes = 5 * K * C + 12 * C  # v read once, q written; gs, s in, l1 out
        b_ms, b_by = bound_ms(n_bytes, 4 * K * C, FP32_FLOPS_PER_S)
        extra = "" if deq_ms is None else (f" (with deq written {deq_ms:.5f}, max |deq - plain| "
                                           f"{err:.3g}) plain_ms {plain_ms:.5f}")
        print(f"a2q_quantize {site} K={K} C={C} (x{count} a run): l1 max rel err {l1_rel:.3g}, "
              f"{flips} code flips, largest column l1 {col_l1.max().item()} <= budget "
              f"{budget:.2f}, kernel_ms {ms:.5f}{extra} bound_ms {b_ms:.6f} ({b_by}, "
              f"{b_ms / ms:.1%})", flush=True)
        at[f"{site} K={K} C={C}"] = {"count": count, "ms": ms, "deq_ms": deq_ms,
                                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                                     "library_ms": None, "code_flips": flips,
                                     "l1_max_rel_err": l1_rel}
        run["ms"] += count * ms
        run["bound_ms"] += count * b_ms
        run["matrices"] += count
        if site.startswith("hubert") and site != "hubert head":
            per_layer = count // 48
            layer["ms"] += per_layer * ms
            layer["plain_ms"] += per_layer * plain_ms
            layer["bytes"] += per_layer * n_bytes
            layer["ops"] += per_layer * 4 * K * C
        del args, v, gs, s, q, q_p, l1, l1_p, deq_p
        torch.cuda.empty_cache()
    b_ms, b_by = bound_ms(layer["bytes"], layer["ops"], FP32_FLOPS_PER_S)
    print(f"a2q_quantize one hubert-xlarge layer's 6 matrices: kernel_ms {layer['ms']:.5f} "
          f"plain_ms {layer['plain_ms']:.5f} bound_ms {b_ms:.6f} ({b_by}); {flips_total} code "
          f"flips in all shapes", flush=True)
    print(f"a2q_quantize deploy kernel ms a run ({run['matrices']} matrices): {run['ms']:.3f} ms, "
          f"bound {run['bound_ms']:.3f} ms ({run['bound_ms'] / run['ms']:.1%})", flush=True)
    return {"name": "a2q_quantize", "route": "cuda", "source": "src/repro_torch/csrc/a2q_quantize.cu",
            "replaces": "src/repro/kernels/a2q_quantize.py:101",
            "at": "one hubert-xlarge layer's 6 deploys (4 x 1280x1280, 1280x5120, 5120x1280), "
                  "A2Q P=16 M=8 N=8",
            "max_abs_err": worst, "code_flips": flips_total, "ms": layer["ms"],
            "plain_ms": layer["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "deploy_kernel_ms_a_run": run["ms"],
            "deploy_bound_ms_a_run": run["bound_ms"], "at_shapes": at}


def check_flash_attention(dev) -> dict:
    """flash_attention against its plain version (dense fp32 softmax) on the
    head views of (B, T, H * D) projections, as the layer passes them:
    hubert-xlarge's whole-utterance encode (8 clips x 1000 frames, 16 heads
    of 80, bidirectional) in bf16 and fp32; smollm-135m's causal GQA (9 heads
    over 3, D 64, T 64); a causal sliding window of 256 at hubert's shape;
    64 queries end-aligned to 1000 keys; llava-next-34b's causal patch and
    text prefill (GQA 7:1, D 128, timed beside its causal bound; the
    entry's ``at_new_decoders``).  Within 2e-5 (fp32) plus one bf16
    ulp of the output (bf16); bf16 runs on the tensor-core kernel, fp32 on
    the CUDA-core one (the launch counts show which).  hubert's bf16 case
    timed (CUDA events) beside the plain version, the CUDA-core kernel on
    the same values (an unaligned copy of the views, which the wrapper
    routes there; also held to the gate),
    ``F.scaled_dot_product_attention`` on the same bf16 views (the library
    time; the port never calls it) and the bound: its operations at the
    bf16 tensor-core peak (the card's for bf16 inputs), with the share of
    it reached; hubert's fp32 case timed likewise on the CUDA-core kernel,
    beside SDPA in fp32 and its operations at the fp32 peak."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    B, H, D = HUBERT_CLIPS, 16, 80
    cases = {  # tag: (B, H, KV, Tq, Tk, D, causal, window, dtype)
        "hubert bf16": (B, H, H, HUBERT_FRAMES, HUBERT_FRAMES, D, False, None, torch.bfloat16),
        "hubert fp32": (B, H, H, HUBERT_FRAMES, HUBERT_FRAMES, D, False, None, torch.float32),
        "smollm GQA causal bf16": (8, 9, 3, 64, 64, 64, True, None, torch.bfloat16),
        "smollm GQA causal fp32": (8, 9, 3, 64, 64, 64, True, None, torch.float32),
        "window 256 causal bf16": (2, H, H, HUBERT_FRAMES, HUBERT_FRAMES, D, True, 256,
                                   torch.bfloat16),
        "end-aligned Tq=64 Tk=1000 bf16": (B, H, H, 64, HUBERT_FRAMES, D, True, None,
                                           torch.bfloat16),
        LLAVA_PREFILL: (2, 56, 8, 576 + 64, 576 + 64, 128, True, None, torch.bfloat16),
    }
    gen = torch.Generator(device=dev).manual_seed(9)
    entry, worst, worst_bf16 = None, 0.0, 0.0
    for tag, (b, h, kv, tq, tk, d, causal, window, dtype) in cases.items():
        q = torch.randn((b, tq, h * d), generator=gen, device=dev).to(dtype)
        q = q.reshape(b, tq, h, d).transpose(1, 2)
        k, v = (torch.randn((b, tk, kv * d), generator=gen, device=dev).to(dtype)
                .reshape(b, tk, kv, d).transpose(1, 2) for _ in range(2))
        kw = dict(causal=causal, window=window, scale=d**-0.5)
        before = flash_attention_cuda.tc_launches
        got = flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        kernel = "tc" if flash_attention_cuda.tc_launches > before else "cuda_cores"
        want = flash_attention_plain(q, k, v, **kw)
        ok, err = flash_within_tolerance(got, want)
        if not ok or kernel != ("tc" if dtype == torch.bfloat16 else "cuda_cores"):
            raise AssertionError(f"flash_attention {tag}: kernel {kernel} != plain, max err {err}")
        if dtype == torch.float32:
            worst = max(worst, err)
        else:
            worst_bf16 = max(worst_bf16, err)
        print(f"flash_attention {tag} (B={b} H={h} KV={kv} Tq={tq} Tk={tk} D={d}): kernel "
              f"{kernel}, max err {err:.3g} within tolerance", flush=True)
        if tag == "hubert fp32":  # the CUDA-core kernel at hubert's shape, in fp32
            ms = events_ms(lambda: flash_attention_cuda(q, k, v, **kw), 3)
            plain_ms = events_ms(lambda: flash_attention_plain(q, k, v, **kw), 2)
            lib_ms = events_ms(lambda: F.scaled_dot_product_attention(q, k, v), 3)
            n_ops = 4 * b * h * tq * tk * d
            b_ms, b_by = bound_ms(4 * (2 * b * h * tq * d + 2 * b * kv * tk * d), n_ops,
                                  FP32_FLOPS_PER_S)
            print(f"flash_attention {tag}: kernel cuda_cores ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"library_ms(sdpa, fp32) {lib_ms:.4f} bound_ms {b_ms:.5f} ({b_by}, fp32 at "
                  f"67 TFLOP/s), {b_ms / ms:.1%} of the bound", flush=True)
            entry["fp32"] = {"at": "the same shape in fp32, on the CUDA cores", "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                             "bound_share": b_ms / ms, "library_ms": lib_ms}
        if tag == LLAVA_PREFILL:  # causal: the kept (q, k) pairs' operations
            ms = graph_ms(lambda: flash_attention_cuda(q, k, v, **kw), 10)
            plain_ms = events_ms(lambda: flash_attention_plain(q, k, v, **kw), 2)
            kr, vr = (t.repeat_interleave(h // kv, dim=1).contiguous() for t in (k, v))
            qc = q.contiguous()
            lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qc, kr, vr, is_causal=True),
                              10)
            n_ops = 4 * b * h * d * (tq * (tq + 1) // 2)
            b_ms, b_by = bound_ms(dtype.itemsize * (2 * b * h * tq * d + 2 * b * kv * tk * d),
                                  n_ops, BF16_FLOPS_PER_S)
            print(f"flash_attention {tag}: kernel tc ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"library_ms(sdpa, KV repeated) {lib_ms:.4f} bound_ms {b_ms:.5f} ({b_by}), "
                  f"{b_ms / ms:.1%} of the bound", flush=True)
            at_llava = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms}
            del kr, vr, qc
        if tag != "hubert bf16":
            continue
        # the same values as unaligned views: the wrapper routes them to the CUDA cores
        def unaligned(t):
            flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
            view = flat[1:].view(b, t.shape[2], t.shape[1], d).transpose(1, 2)
            view.copy_(t)
            return view
        qu, ku, vu = unaligned(q), unaligned(k), unaligned(v)
        before = flash_attention_cuda.tc_launches
        got_cc = flash_attention_cuda(qu, ku, vu, **kw)
        torch.cuda.synchronize()
        ok, err_cc = flash_within_tolerance(got_cc, want)
        if not ok or flash_attention_cuda.tc_launches != before:
            raise AssertionError(f"flash_attention {tag} on the CUDA cores: max err {err_cc}")
        ms = events_ms(lambda: flash_attention_cuda(q, k, v, **kw), 10)
        cc_kernel_ms = events_ms(lambda: flash_attention_cuda(qu, ku, vu, **kw), 10)
        plain_ms = events_ms(lambda: flash_attention_plain(q, k, v, **kw), 2)
        lib_ms = events_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10)
        n_ops = 4 * b * h * tq * tk * d  # QK^T and PV, every key kept (bidirectional)
        n_bytes = dtype.itemsize * (2 * b * h * tq * d + 2 * b * kv * tk * d)
        b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_FLOPS_PER_S)
        print(f"flash_attention {tag}: kernel tc ms {ms:.4f} (the CUDA-core kernel on the same "
              f"values {cc_kernel_ms:.4f}, max err {err_cc:.3g}) plain_ms {plain_ms:.4f} "
              f"library_ms(sdpa) {lib_ms:.4f} bound_ms {b_ms:.5f} ({b_by}, bf16 tensor cores; "
              f"{n_ops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB), {b_ms / ms:.1%} of the bound",
              flush=True)
        entry = {"name": "flash_attention", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:135",
                 "at": "hubert-xlarge encode, one layer: B=8 H=16 T=1000 D=80, bidirectional, "
                       "bf16 head views",
                 "kernel": kernel, "ms": ms, "cuda_cores_ms": cc_kernel_ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
                 "library_ms": lib_ms}
        del want, qu, ku, vu, got_cc
    entry["max_abs_err"] = worst  # fp32; bf16 adds one rounding of the output
    entry["max_abs_err_bf16"] = worst_bf16
    entry["at_new_decoders"] = {LLAVA_PREFILL: at_llava}
    return entry


@contextlib.contextmanager
def int_matmul_route(tc: bool):
    """Every ``int_matmul_cuda`` call inside the block on the tensor-core
    kernel (``tc``) or on the decode kernel (at most 32 rows), whatever its
    rows: the crossover's timings."""
    import importlib

    im = importlib.import_module("repro_torch.kernels.int_matmul")
    edge = im.TC_MIN_ROWS
    im.TC_MIN_ROWS = 1 if tc else 1 << 30
    try:
        yield
    finally:
        im.TC_MIN_ROWS = edge


def check_int_matmul_hubert(dev) -> list:
    """int_matmul at hubert-xlarge's encode shapes (M = 8 clips x 1000 frames,
    on the tensor-core kernel): mlp.w_in with the prologue (fp32 and bf16
    x), bias and the gelu requant epilogue (replayed in bf16 after the flush,
    signed 8-bit codes out for mlp.w_out) against its plain version, equal
    or one apart only at rounding ties (``requant_ties``: the kernel's tanhf
    against PyTorch's tanh), timed beside the prologue-only kernel on the
    same inputs; then the attention projections and the head (prologue,
    fp32 out) and mlp.w_out (int8 codes in), bit for bit.  Every shape timed
    beside ``torch._int_mm`` on the same int8 operands (the library time),
    with the kernel that ran and the share of the bound it reached.  Returns
    the ``int_matmul[gelu requant]`` and
    ``int_matmul[tc]`` (mlp.w_out, int8 codes in) entries."""
    from repro_torch.kernels.int_matmul import (int_matmul_cuda, int_matmul_plain,
                                                prologue_codes, requant_ties)
    from repro_torch.kernels.ops import int_matmul_block_k

    gen = torch.Generator(device=dev).manual_seed(10)
    M = HUBERT_CLIPS * HUBERT_FRAMES
    s_aq = torch.tensor([6.0 / 127], device=dev)  # the A2Q init's act scale
    pro = dict(aq_scale=s_aq, q_lo=-128, q_hi=127, q_shift=0)
    entry, tc_entry, at = None, None, {}

    def timed(fn, reps=10):
        before = int_matmul_cuda.tc_launches
        ms = events_ms(fn, reps)
        return ms, "tc" if int_matmul_cuda.tc_launches > before else "decode"

    for (K, N), site in (((1280, 5120), "mlp.w_in"), ((1280, 1280), "attn.wq/wk/wv/wo"),
                         ((5120, 1280), "mlp.w_out"), (HUBERT_HEAD, "head")):
        w = a2q_bounded_weights(gen, K, N, dev)
        w_cm = w.t().contiguous().t()  # column-major for cuBLASLt
        scale = torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-4
        bias = torch.randn((N,), generator=gen, device=dev) * 0.1
        kw = dict(acc_bits=16, mode="exact", block_k=int_matmul_block_k(K), spill_int16=True)
        x = torch.randn((M, K), generator=gen, device=dev)
        codes = prologue_codes(x, s_aq, -128, 127, 0)
        lib_ms = events_ms(lambda: torch._int_mm(codes, w_cm), 10)
        if site == "mlp.w_out":  # int8 codes in, as the chained edge hands them over
            x, xkw = codes, kw
        else:
            xkw = {**kw, **pro}
        y = int_matmul_plain(x, w, scale, bias, **xkw)
        if site == "mlp.w_in":
            # w_out's quantizer: one scale for the tensor, gelu's range over 127 codes
            out_scale = torch.full((N,), y.clamp_min(0).max().item() / 127, device=dev)
            req = dict(out_scale=out_scale, r_lo=-128, r_hi=127, r_shift=0, act_fn="gelu",
                       cast_dtype=torch.bfloat16)
            got = int_matmul_cuda(x, w, scale, bias, **xkw, **req)
            torch.cuda.synchronize()
            want = int_matmul_plain(x, w, scale, bias, **xkw, **req)
            diff = got.to(torch.int32) - want.to(torch.int32)
            ties = requant_ties(y, out_scale, "gelu", torch.bfloat16)
            n_diff = int((diff != 0).sum())
            if diff.abs().max().item() > 1 or (diff != 0)[~ties].any():
                raise AssertionError(f"int_matmul gelu requant M={M} K={K} N={N}: {n_diff} codes "
                                     "differ from plain, some not one apart at a rounding tie")
            xb = x.bfloat16()  # bf16 x, as the int-chain layer now hands it over
            got_b = int_matmul_cuda(xb, w, scale, bias, **xkw, **req)
            torch.cuda.synchronize()
            if not torch.equal(got_b, int_matmul_cuda(xb.float(), w, scale, bias, **xkw, **req)):
                raise AssertionError("int_matmul gelu requant: bf16 x != its fp32 widening")
            ms, kernel = timed(lambda: int_matmul_cuda(x, w, scale, bias, **xkw, **req))
            bf16_ms, _ = timed(lambda: int_matmul_cuda(xb, w, scale, bias, **xkw, **req))
            pro_ms, _ = timed(lambda: int_matmul_cuda(x, w, scale, bias, **xkw))
            int8_ms, _ = timed(lambda: int_matmul_cuda(codes, w, scale, bias, **kw, **req))
            plain_ms = events_ms(lambda: int_matmul_plain(x, w, scale, bias, **xkw, **req), 2)
            b_ms, b_by = bound_ms(4 * M * K + K * N + 12 * N + M * N, 2 * M * K * N,
                                  INT8_OPS_PER_S)
            print(f"int_matmul gelu requant ({site}: prologue + bias + gelu in bf16 -> s8) M={M} "
                  f"K={K} N={N}: {n_diff} of {M * N} codes one apart from plain, all at "
                  f"rounding ties ({int(ties.sum())} ties); bf16 x equal to its widening; "
                  f"{len(torch.unique(got))} distinct codes; kernel {kernel} ms {ms:.4f} (bf16 x "
                  f"{bf16_ms:.4f}, int8 codes in {int8_ms:.4f}: the prologue pass costs "
                  f"{ms - int8_ms:.4f}) prologue-only (fp32 out) {pro_ms:.4f} plain_ms "
                  f"{plain_ms:.4f} library_ms(_int_mm) {lib_ms:.4f} bound_ms {b_ms:.5f} ({b_by}), "
                  f"{b_ms / ms:.1%} of the bound", flush=True)
            entry = {"name": "int_matmul[gelu requant]", "route": "cuda",
                     "source": "src/repro_torch/csrc/int_matmul.cu",
                     "replaces": "src/repro/kernels/int_matmul.py:300",
                     "at": "hubert-xlarge mlp.w_in, M=8000 K=1280 N=5120: fp32 x through the "
                           "prologue, int16 carry, bias, gelu replayed in fp32 after a bf16 "
                           "cast, signed 8-bit codes out",
                     "kernel": kernel, "max_abs_err": float(diff.abs().max().item()),
                     "codes_off_by_one": n_diff, "ms": ms, "bf16_x_ms": bf16_ms,
                     "int8_x_ms": int8_ms, "prologue_only_ms": pro_ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
                     "library_ms": lib_ms, "at_hubert": at}
            continue
        got = int_matmul_cuda(x, w, scale, bias, **xkw)
        torch.cuda.synchronize()
        if not torch.equal(got, y):
            raise AssertionError(f"int_matmul hubert {site} M={M} K={K} N={N}: kernel != plain")
        ms, kernel = timed(lambda: int_matmul_cuda(x, w, scale, bias, **xkw))
        plain_ms = events_ms(lambda: int_matmul_plain(x, w, scale, bias, **xkw), 2)
        b_ms, b_by = bound_ms(x.element_size() * M * K + K * N + 12 * N + 4 * M * N,
                              2 * M * K * N, INT8_OPS_PER_S)
        print(f"int_matmul hubert {site} ({'int8 x' if site == 'mlp.w_out' else 'prologue'}) "
              f"M={M} K={K} N={N}: equal to plain, kernel {kernel} ms {ms:.4f} plain_ms "
              f"{plain_ms:.4f} library_ms(_int_mm) {lib_ms:.4f} bound_ms {b_ms:.5f} ({b_by}), "
              f"{b_ms / ms:.1%} of the bound", flush=True)
        at[f"{site} M={M} K={K} N={N}"] = {"kernel": kernel, "ms": ms, "plain_ms": plain_ms,
                                           "bound_ms": b_ms, "bound_by": b_by,
                                           "bound_share": b_ms / ms, "library_ms": lib_ms}
        if site == "mlp.w_out":
            tc_entry = {"name": "int_matmul[tc]", "route": "cuda",
                        "source": "src/repro_torch/csrc/int_matmul.cu",
                        "replaces": "src/repro/kernels/int_matmul.py:300",
                        "at": "the tensor-core kernel (M > 16) at hubert-xlarge mlp.w_out, "
                              "M=8000 K=5120 N=1280: int8 codes in, int16 carry, scale + bias",
                        "kernel": kernel, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
                        "library_ms": lib_ms}
        del w, w_cm, x, codes, y
    return [entry, tc_entry]


# paged_attention and flash_attention at the shapes phases 4l and 4v give them
NEW_PAGED = (  # (site, B, H, KV, Dh, lengths lo, hi)
    ("llama4-scout global NoPE layer, decode past the 8192 chunk", 2, 40, 8, 128, 8300, 8482),
    ("llava-next-34b decode", 8, 56, 8, 128, 64, 96),
)
LLAVA_PREFILL = "llava-next-34b causal prefill bf16 (B=2 H=56 KV=8 T=576+64 D=128)"


def _quantize(pool, bits):
    """Integer pool of ``pool``'s values: codes (packed for int4) and fp32
    per-token scales, by the layers' own quantize-on-write."""
    from repro_torch.nn.attention import _kv_quantize, _pack_nibbles

    codes, scales = _kv_quantize(pool, bits=bits)
    return (_pack_nibbles(codes) if bits == 4 else codes), scales


def check_paged_attention_int(dev) -> list:
    """paged_attention on int8 and packed-int4 pools at smollm-135m's decode
    shape, with the main path's bf16 query: against the plain version, with
    a NaN scale block behind a table entry past a row's length."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain
    from repro_torch.nn.attention import _unpack_nibbles

    q, kp, vp, bt, lengths = paged_case(dev, torch.float32)
    q = q.to(torch.bfloat16)
    B, H, Dh = q.shape
    NB, bs, KV, _ = kp.shape
    entries = []
    for bits in (8, 4):
        kq, ks = _quantize(kp, bits)
        vq, vs = _quantize(vp, bits)
        worst = 0.0
        for window in (None, 20):
            with no_host_sync():
                got = paged_attention_cuda(q, kq, vq, bt, lengths, ks, vs, window=window)
            torch.cuda.synchronize()
            want = paged_attention_plain(q, kq, vq, bt, lengths, ks, vs, window=window)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= ATTN_TOL[torch.bfloat16]:
                raise AssertionError(f"paged_attention int{bits} window={window}: max err {err}")
            if not torch.isfinite(got).all() or got[0].abs().max().item() != 0.0:
                raise AssertionError("paged_attention: non-finite output or nonzero empty row")
            worst = max(worst, err)
        spare = sorted(set(range(1, NB)) - set(bt.flatten().tolist()))[0]
        ks_nan, vs_nan, bt_past = ks.clone(), vs.clone(), bt.clone()
        ks_nan[spare] = vs_nan[spare] = float("nan")  # a block no live entry reaches...
        bt_past[2, -1] = spare  # ...but an entry past row 2's length
        past = paged_attention_cuda(q, kq, vq, bt_past, lengths, ks_nan, vs_nan)
        torch.cuda.synchronize()
        if not torch.equal(past, paged_attention_cuda(q, kq, vq, bt, lengths, ks, vs)):
            raise AssertionError(f"paged_attention int{bits} read a table entry past the length")
        ms = graph_ms(lambda: paged_attention_cuda(q, kq, vq, bt, lengths, ks, vs), LAYERS)
        plain_ms = graph_ms(lambda: paged_attention_plain(q, kq, vq, bt, lengths, ks, vs), LAYERS)
        # yardstick: SDPA on the dequantized gathered view (gather and dequant not timed)
        S = bt.shape[1] * bs
        deq = [(_unpack_nibbles(c) if bits == 4 else c).float() * sc[..., None]
               for c, sc in ((kq, ks), (vq, vs))]
        G = H // KV
        kg, vg = (d[bt.long()].reshape(B, S, KV, Dh).transpose(1, 2).to(torch.bfloat16)
                  .repeat_interleave(G, dim=1).contiguous() for d in deq)
        mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        qs = q[:, :, None, :]
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask), LAYERS)
        toks = lengths.sum().item()
        n_bytes = (2 * q.numel() * 2 + toks * KV * 2 * kq.shape[-1] + toks * KV * 2 * 4
                   + bt.numel() * 4 + B * 4)
        n_ops = 4 * toks * H * Dh
        b_ms, b_by = bound_ms(n_bytes, n_ops, FP32_FLOPS_PER_S)
        print(f"paged_attention int{bits} pools, bf16 q, B={B} H={H} KV={KV} Dh={Dh} bs={bs} "
              f"lengths={lengths.tolist()}: max_abs_err {worst:.3g} (tol {ATTN_TOL[torch.bfloat16]:.3g}), "
              f"entry past the length unread, kernel_ms {ms:.5f} plain_ms {plain_ms:.5f} "
              f"bound_ms {b_ms:.6f} ({b_by}) library_ms(sdpa, dequantized gathered) {lib_ms:.5f}",
              flush=True)
        entries.append({"name": f"paged_attention[int{bits}]", "route": "cuda",
                        "source": "src/repro_torch/csrc/paged_attention.cu",
                        "replaces": "src/repro/kernels/paged_attention.py:212",
                        "at": f"B=8 H=9 KV=3 Dh=64 bs=16 int{bits} pools, bf16 q, ragged lengths "
                              "incl. 0",
                        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms,
                        "at_2048_context": paged_served(dev, f"int{bits}")})
    return entries


def check_paged_mla_attention_int(dev) -> list:
    """paged_mla_attention on int8 and packed-int4 latent pools at
    deepseek-v3's decode shape, with and without the act-quant replay, on
    the tensor-core kernel: against the plain version (the length-1 row
    exactly), with a NaN scale block behind a table entry past a row's
    length; then at the 4K context (``mla_served``)."""
    from repro_torch.kernels.paged_mla_attention import (
        paged_mla_attention_cuda,
        paged_mla_attention_plain,
    )
    from repro_torch.nn.attention import _unpack_nibbles

    scale = (128 + 64) ** -0.5
    kw = {"aq_scale": torch.tensor([0.02], device=dev), "act_bits": 8}
    q_lat, q_pe, ckvp, kpep, bt, lengths = mla_case(dev, torch.float32)
    B, H, R = q_lat.shape
    P, bs = q_pe.shape[-1], ckvp.shape[1]
    entries = []
    for bits in (8, 4):
        ckvq, ckvs = _quantize(ckvp, bits)
        kpeq, kpes = _quantize(kpep, bits)
        args = (q_lat, q_pe, ckvq, kpeq, bt, lengths, ckvs, kpes)
        worst = 0.0
        for kwi in ({}, kw):
            tc0 = paged_mla_attention_cuda.tc_launches
            with no_host_sync():
                got = paged_mla_attention_cuda(*args, scale=scale, **kwi)
            torch.cuda.synchronize()
            if paged_mla_attention_cuda.tc_launches != tc0 + 1:
                raise AssertionError(f"paged_mla_attention int{bits} {kwi}: not on the tensor "
                                     "cores")
            want = paged_mla_attention_plain(*args, scale=scale, **kwi)
            err = (got - want).abs().max().item()
            if not err <= MLA_TOL:
                raise AssertionError(f"paged_mla_attention int{bits} {kwi}: max err {err}")
            if not torch.isfinite(got).all() or got[0].abs().max().item() != 0.0 or \
                    not torch.equal(got[1], want[1]):
                raise AssertionError(f"paged_mla_attention int{bits}: non-finite output, nonzero "
                                     "empty row, or a length-1 row off the dequantized latent")
            worst = max(worst, err)
        ckvs_nan, bt_past = ckvs.clone(), bt.clone()
        ckvs_nan[-1] = float("nan")
        bt_past[2, -1] = ckvq.shape[0] - 1
        past = paged_mla_attention_cuda(q_lat, q_pe, ckvq, kpeq, bt_past, lengths, ckvs_nan, kpes,
                                        scale=scale, **kw)
        torch.cuda.synchronize()
        if not torch.equal(past, paged_mla_attention_cuda(*args, scale=scale, **kw)):
            raise AssertionError(f"paged_mla_attention int{bits} read a table entry past the length")
        ms = graph_ms(lambda: paged_mla_attention_cuda(*args, scale=scale, **kw), LAYERS)
        plain_ms = graph_ms(lambda: paged_mla_attention_plain(*args, scale=scale, **kw), LAYERS)
        ckv_d, kpe_d = ((_unpack_nibbles(c) if bits == 4 else c).float() * sc[..., None]
                        for c, sc in ((ckvq, ckvs), (kpeq, kpes)))
        lib_ms = mla_sdpa_ms(q_lat, q_pe, ckv_d, kpe_d, bt, lengths, scale, torch.float32)
        toks = lengths.sum().item()
        b_ms, b_by = mla_bound(toks, B, H, R, P, ckvq.shape[-1] + kpeq.shape[-1], 8)
        print(f"paged_mla_attention int{bits} pools B={B} H={H} R={R} P={P} bs={bs} act_bits=8 "
              f"(tensor cores): max_abs_err {worst:.3g} (tol {MLA_TOL:.3g}), length-1 row exact, "
              f"entry past the length unread, kernel_ms {ms:.5f} plain_ms {plain_ms:.5f} "
              f"bound_ms {b_ms:.6f} ({b_by}) library_ms(sdpa, dequantized gathered, gqa) "
              f"{lib_ms:.5f}", flush=True)
        entries.append({"name": f"paged_mla_attention[int{bits}]", "route": "cuda", "kernel": "tc",
                        "source": "src/repro_torch/csrc/paged_mla_attention.cu",
                        "replaces": "src/repro/kernels/paged_attention.py:373",
                        "at": f"B=8 H=128 R=512 P=64 bs=16 int{bits} latent pools, act_bits=8 "
                              "replay, ragged lengths incl. 0 and 1",
                        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms,
                        "at_4k_context": mla_served(dev, f"int{bits}")})
    return entries


def serve(dev):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.a2q_quantize import a2q_quantize_cuda
    from repro_torch.kernels.int_matmul import int_matmul_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.lm import Runtime, apply_lm, init_lm
    from repro_torch.nn.module import tree_to
    from repro_torch.serve.engine import PagedServeEngine, deploy_params, parity_up_to_ties

    phase("4: serve full-width smollm-135m on the kernels")
    arch = get_arch("smollm-135m")
    t0 = time.perf_counter()
    a2q_quantize_cuda.launches = 0
    with held_deploys(arch.name) as held:
        params = deploy_params(init_lm(torch.Generator(device=dev).manual_seed(0), arch,
                                       device=dev), arch.quant)
    torch.cuda.synchronize()
    deploys = a2q_quantize_cuda.launches
    check_held(arch.name, held, deploys)
    print(f"init + deploy of {arch.name} ({arch.n_layers} layers, d_model {arch.d_model}): "
          f"{time.perf_counter() - t0:.2f}s, {deploys} a2q_quantize launches", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.vocab, (64,)).astype(np.int32) for _ in range(8)]
    kw = dict(batch=8, max_seq=96, block_size=16, prefill_chunk=32, device=dev)
    engine = PagedServeEngine(arch, params, rt=Runtime(int_forward=True, decode_kernel=True), **kw)
    engine.generate(prompts[:1], max_new=2)  # warm-up: first-call library set-up
    engine.reset_stats()
    torch.cuda.synchronize()
    int_matmul_cuda.launches = int_matmul_cuda.tc_launches = 0
    paged_attention_cuda.launches = 0
    outs = engine.generate(prompts, max_new=32)
    torch.cuda.synchronize()
    launches = {"int_matmul": int_matmul_cuda.launches,
                "int_matmul[tc]": int_matmul_cuda.tc_launches,
                "paged_attention": paged_attention_cuda.launches}
    tp = engine.throughput()
    ticks = tp["decode_dispatches"]
    chunks = sum(-(-len(p) // 32) for p in prompts)
    print(f"prefill: {tp['prefill_tokens']} tok in {tp['prefill_s']:.3f}s "
          f"({tp['prefill_tok_s']:.1f} tok/s) | decode: {tp['decode_tokens']} tok in "
          f"{tp['decode_s']:.3f}s ({tp['decode_tok_s']:.1f} tok/s, {ticks} ticks)", flush=True)
    print(f"launches on the main path: {launches} over {ticks} decode ticks and "
          f"{chunks} prefill chunks", flush=True)
    print(f"host ops per decode tick (int-forward, bf16 KV): {tick_ops(engine, prompts)}",
          flush=True)
    per_forward = 7 * arch.n_layers
    if launches["int_matmul"] != per_forward * (ticks + chunks) or \
            launches["paged_attention"] != arch.n_layers * ticks or ticks < 31 or \
            not 0 < launches["int_matmul[tc]"] <= per_forward * chunks:
        raise AssertionError(f"launch counts {launches} do not show {per_forward} int_matmul "
                             f"and {arch.n_layers} paged_attention per decode tick, and the "
                             "prefill chunks' rows on the tensor cores")
    for r, o in zip(engine.last_requests, outs):
        if len(o) != 32 or not all(0 <= t < arch.vocab for t in o) or \
                not np.isfinite(r.margins).all():
            raise AssertionError(f"bad output: {o} margins {r.margins}")
    print(f"req 0 tokens: {outs[0]}", flush=True)
    if deploys != 7 * arch.n_layers:
        raise AssertionError(f"{deploys} a2q_quantize launches at deploy, expected "
                             f"{7 * arch.n_layers}")
    launches["a2q_quantize"] = deploys
    launches["a2q_quantize[flips]"] = held["flips"]

    phase("5: same weights and prompts on the dequant bf16 path; reduced model card vs CPU")
    toks = torch.as_tensor(np.stack(prompts), device=dev)
    l_int = apply_lm(params, arch, tokens=toks, rt=Runtime(int_forward=True))[0].float()
    l_deq = apply_lm(params, arch, tokens=toks)[0].float()
    scale = l_deq.abs().max().item()
    diff = (l_int - l_deq).abs().max().item()
    eps = 2.0**-6 * scale  # two bf16 ulps at the top of the logit range
    print(f"prompt logits, int path vs dequant path: max |diff| {diff:.4g}, max |logit| "
          f"{scale:.4g}, bound {eps:.4g}; argmax agreement "
          f"{(l_int.argmax(-1) == l_deq.argmax(-1)).float().mean().item():.4f}", flush=True)
    if not (np.isfinite(diff) and diff <= eps):
        raise AssertionError(f"int path logits off the dequant path by {diff} > {eps}")
    ref = PagedServeEngine(arch, params, rt=Runtime(), **kw)
    ref.generate(prompts[:1], max_new=2)
    ref.reset_stats()
    ref_outs = ref.generate(prompts, max_new=32)
    rtp = ref.throughput()
    print(f"dequant path: prefill {rtp['prefill_tok_s']:.1f} tok/s | decode "
          f"{rtp['decode_tok_s']:.1f} tok/s ({rtp['decode_dispatches']} ticks)", flush=True)
    ok, ties, detail = parity_up_to_ties(ref.last_requests, outs, eps)
    same = sum(a == b for a, b in zip(ref_outs, outs))
    marg = max(abs(a - b) for r, g in zip(ref.last_requests, engine.last_requests)
               for a, b in zip(r.margins, g.margins))
    print(f"served tokens, int path vs dequant path: parity_up_to_ties eps={eps:.4g}: ok={ok} "
          f"ties={ties} identical_requests={same}/{len(outs)}; max greedy-margin diff "
          f"{marg:.4g}", flush=True)
    if not ok:
        raise AssertionError(f"parity failed: {detail}")
    small = reduced(arch)
    sp = deploy_params(init_lm(torch.Generator().manual_seed(0), small, device="cpu"), small.quant)
    small_prompts = [p[: 5 + 3 * i] % small.vocab for i, p in enumerate(prompts[:3])]
    skw = dict(batch=2, max_seq=32, block_size=4, prefill_chunk=4,
               rt=Runtime(int_forward=True, decode_kernel=True))
    cpu_e = PagedServeEngine(small, sp, device="cpu", **skw)
    cpu_outs = cpu_e.generate(small_prompts, max_new=5)
    gpu_e = PagedServeEngine(small, tree_to(sp, dev), device=dev, **skw)
    gpu_outs = gpu_e.generate(small_prompts, max_new=5)
    ok, ties, detail = parity_up_to_ties(cpu_e.last_requests, gpu_outs, 1e-4)
    marg = max(abs(a - b) for r, g in zip(cpu_e.last_requests, gpu_e.last_requests)
               for a, b in zip(r.margins, g.margins))
    print(f"reduced smollm-135m card vs CPU: tokens {gpu_outs} vs {cpu_outs}, ties {ties}, "
          f"max margin diff {marg:.3g}", flush=True)
    if not ok or ties or marg > 1e-4:
        raise AssertionError(f"card vs CPU disagree: {detail}, margin diff {marg}")
    del engine, ref
    # 4c, 4m, 4s and 4o run on the first SIDE_LAYERS layers of these params
    side = dataclasses.replace(arch, stacks=(dataclasses.replace(arch.stacks[0],
                                                                  count=SIDE_LAYERS),))
    side_params = {**params, "stacks": {"0": _first_layers(params["stacks"]["0"], SIDE_LAYERS)}}
    phase(f"4c: smollm-135m ({SIDE_LAYERS} of its {arch.n_layers} layers) on --int-chain "
          "--kv-int8 [--kv-bits 4] --decode-kernel")
    by_path = {"smollm-135m": launches,
               "smollm-135m int-chain": serve_int(dev, side, side_params, prompts,
                                                  per_forward=7 * side.n_layers, mla=False)}
    phase(f"4m: smollm-135m ({SIDE_LAYERS} layers, 4c's --int-chain --kv-int8) on the megastep, "
          "12 requests over 8 slots")
    more = np.random.default_rng(1)
    prompts12 = prompts + [more.integers(0, arch.vocab, (64,)).astype(np.int32) for _ in range(4)]
    n = 7 * side.n_layers
    by_path["smollm-135m megastep"] = serve_megastep(
        dev, side, side_params, prompts12, rt=Runtime(int_chain=True, decode_kernel=True),
        kv_bits=8,
        per_call={"int_matmul_cuda.launches": (n, n), "int_matmul_cuda.prologue_launches": (n, n),
                  "paged_attention_cuda.launches": (side.n_layers, 0)},
        names={"int_matmul[prologue]": "int_matmul_cuda.prologue_launches",
               "int_matmul[tc]": "int_matmul_cuda.tc_launches",
               "paged_attention[int8]": "paged_attention_cuda.launches"})
    by_path["smollm-135m shared and spec"] = serve_shared(dev, side, side_params)
    by_path["smollm-135m observed"] = serve_observed(dev, side, side_params)
    return by_path


def _first_layers(tree, n: int):
    """The first ``n`` layers of a stack's ``(count, ...)`` leaves (views)."""
    if isinstance(tree, dict):
        return {k: _first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def op_counter():
    """A context that counts the PyTorch operators dispatched inside it (its
    ``n``): the host work they issue, each a kernel launch unless it is a
    view.  The CUDA kernels' own launches go through ctypes and are not
    among them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    return Count()


def tick_ops(engine, prompts) -> int:
    """Host-dispatched PyTorch operators in one decode tick of ``engine``
    (every request admitted and prefilled first)."""
    from repro_torch.serve.engine import Request

    for i, p in enumerate(prompts):
        engine.submit(Request(uid=2000 + i, prompt=p, max_new=3))
    engine.step()
    with op_counter() as count:
        engine.tick()
    while not engine.sched.idle():
        engine.step()
    return count.n


def _prompt_logits(params, arch, toks, rt, dev, kv_bits=None):
    """Logits of the prompts ``toks (B, T)`` prefilled in one step into fresh
    paged pools: bf16 pools, or integer ones at ``kv_bits``."""
    from repro_torch.models.lm import apply_lm
    from repro_torch.nn.transformer import COMPUTE_DTYPES
    from repro_torch.serve.paged_cache import PagedKVCache

    B, T = toks.shape
    cache = PagedKVCache(arch, B, block_size=16, max_seq=T, dtype=COMPUTE_DTYPES[arch.compute_dtype],
                         device=dev, kv_quant=kv_bits is not None, kv_bits=kv_bits or 8)
    for b in range(B):
        cache.allocate(b, T)
    logits, _ = apply_lm(params, arch, tokens=toks, rt=rt, start_pos=0,
                         cache={**cache.pools, "_paged": {"bt": cache.bt()}})
    return logits.float()


def serve_int(dev, arch, params, prompts, *, per_forward: int, mla: bool) -> dict:
    """The ``--int-chain --kv-int8 [--kv-bits 4] --decode-kernel`` path on
    ``params``: for int8, then int4 KV, the main-path run (every deployed
    linear's act-quant in the int_matmul prologue, the decode read through
    the int-pool attention kernel) with its launch counts and chain report,
    held against the unchained int-forward run on the same pools (bitwise
    prompt logits, identical tokens and margins), the gathered dequantized
    read (same tokens), and bf16 KV (``parity_up_to_ties`` at an eps derived
    from the prompt logits' quantization error, at most a quarter of the
    logits' spread).  Returns the main-path runs' launch counts by kernel
    variant."""
    from repro_torch.kernels.int_matmul import int_matmul_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.kernels.paged_mla_attention import paged_mla_attention_cuda
    from repro_torch.models.lm import Runtime, apply_lm
    from repro_torch.serve.engine import PagedServeEngine, parity_up_to_ties

    attn = paged_mla_attention_cuda if mla else paged_attention_cuda
    name = "paged_mla_attention" if mla else "paged_attention"
    n_attn = sum(s.count for s in arch.stacks)
    kw = dict(batch=8, max_seq=96, block_size=16, prefill_chunk=32, device=dev)
    chunks = sum(-(-len(p) // 32) for p in prompts)

    def run(tag, kv_bits, **rt):
        engine = PagedServeEngine(arch, params, rt=Runtime(mla_absorb=mla, **rt),
                                  kv_quant=kv_bits is not None, kv_bits=kv_bits or 8, **kw)
        engine.generate(prompts[:1], max_new=2)  # warm-up
        engine.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        int_matmul_cuda.launches = int_matmul_cuda.prologue_launches = 0
        int_matmul_cuda.tc_launches = attn.launches = paged_mla_attention_cuda.tc_launches = 0
        outs = engine.generate(prompts, max_new=32)
        torch.cuda.synchronize()
        launches = {"int_matmul": int_matmul_cuda.launches,
                    "int_matmul[prologue]": int_matmul_cuda.prologue_launches,
                    "int_matmul[tc]": int_matmul_cuda.tc_launches, name: attn.launches}
        if mla:
            launches[f"{name}[tc]"] = paged_mla_attention_cuda.tc_launches
        tp = engine.throughput()
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"[{tag}] prefill {tp['prefill_tok_s']:.2f} tok/s | decode {tp['decode_tok_s']:.2f} "
              f"tok/s ({tp['decode_dispatches']} ticks) | peak allocated {peak:.2f} GB | "
              f"{engine.cache.kv_bytes_per_token()} KV bytes/token | chain report: "
              f"{tp['int_chain_folded']} folded, {tp['int_chain_requant_dispatches']} standalone, "
              f"{tp['int_chain_fallback']} fallback | launches {launches} | host ops per decode "
              f"tick {tick_ops(engine, prompts)}", flush=True)
        for r, o in zip(engine.last_requests, outs):
            if len(o) != 32 or not all(0 <= t < arch.vocab for t in o) or \
                    not np.isfinite(r.margins).all():
                raise AssertionError(f"[{tag}] bad output: {o} margins {r.margins}")
        return engine, outs, launches, tp

    toks = torch.as_tensor(np.stack(prompts), device=dev)
    chained = Runtime(int_chain=True, mla_absorb=mla)
    bf16, bf16_outs, _, _ = run("bf16 KV, int-chain, kernel", None, int_chain=True,
                                decode_kernel=True)
    l_bf16 = _prompt_logits(params, arch, toks, chained, dev)
    counts = {"int_matmul[prologue]": 0, "int_matmul[tc]": 0}
    for bits in (8, 4):
        main, outs, launches, tp = run(f"int{bits} KV, int-chain, kernel (main path)", bits,
                                       int_chain=True, decode_kernel=True)
        ticks = tp["decode_dispatches"]
        if launches["int_matmul"] != per_forward * (ticks + chunks) or \
                launches["int_matmul[prologue]"] != launches["int_matmul"] or \
                launches[name] != n_attn * ticks or ticks < 31 or \
                (mla and launches[f"{name}[tc]"] != launches[name]) or \
                tp["int_chain_requant_dispatches"] != 0 or tp["int_chain_folded"] != per_forward:
            raise AssertionError(f"int{bits} KV: launches {launches}, chain report {tp} do not "
                                 f"show {per_forward} folded int_matmul per forward and {n_attn} "
                                 f"{name} per decode tick")
        counts["int_matmul[prologue]"] += launches["int_matmul[prologue]"]
        counts["int_matmul[tc]"] += launches["int_matmul[tc]"]
        counts[f"{name}[int{bits}]"] = launches[name]
        if mla:
            counts[f"{name}[int{bits}][tc]"] = launches[f"{name}[tc]"]
        # chaining is a pure dispatch fusion: the unchained run on the same pools
        l_q = _prompt_logits(params, arch, toks, chained, dev, bits)
        l_u = _prompt_logits(params, arch, toks, Runtime(int_forward=True, mla_absorb=mla), dev, bits)
        unchained, outs_u, _, _ = run(f"int{bits} KV, unchained int-forward, kernel", bits,
                                      int_forward=True, decode_kernel=True)
        same_margins = [r.margins for r in unchained.last_requests] == \
            [r.margins for r in main.last_requests]
        print(f"int{bits} KV chained vs unchained: prompt logits bitwise equal "
              f"{torch.equal(l_q, l_u)}, tokens identical {outs_u == outs}, margins identical "
              f"{same_margins}", flush=True)
        if not torch.equal(l_q, l_u) or outs_u != outs or not same_margins:
            raise AssertionError(f"int{bits} KV: chained and unchained runs differ")
        # the kernel read against the gathered dequantized view of the same pools
        gathered, outs_g, _, _ = run(f"int{bits} KV, int-chain, gathered view", bits,
                                     int_chain=True)
        ulps = 2.0**-6 * l_q.abs().max().item()  # two bf16 ulps at the top of the logit range
        ok, ties, detail = parity_up_to_ties(gathered.last_requests, outs, ulps)
        same = sum(a == b for a, b in zip(outs_g, outs))
        print(f"int{bits} KV kernel read vs gathered view: identical_requests {same}/{len(outs)}, "
              f"parity_up_to_ties eps={ulps:.4g} ok={ok} ties={ties}", flush=True)
        if not ok:
            raise AssertionError(f"int{bits} KV kernel read vs gathered view: {detail}")
        # against bf16 KV, at the eps the quantization error sets: on the prompt
        # positions, the largest rise of any logit over the bf16 top-1 token
        # (a greedy token can flip only where its margin is below that)
        d = l_q - l_bf16
        top = l_bf16.argmax(-1, keepdim=True)
        eps = (d - d.gather(-1, top)).amax(-1).max().item()
        spread = (l_bf16.amax(-1) - l_bf16.amin(-1)).median().item()
        margins = np.concatenate([r.margins for r in bf16.last_requests])
        ok, ties, detail = parity_up_to_ties(bf16.last_requests, outs, eps)
        same = sum(a == b for a, b in zip(bf16_outs, outs))
        agree = (l_q.argmax(-1) == l_bf16.argmax(-1)).float().mean().item()
        print(f"int{bits} KV vs bf16 KV: prompt logits max |diff| {d.abs().max().item():.4g}, "
              f"eps (largest rise over the bf16 top-1) {eps:.4g} = {eps / spread:.1%} of the "
              f"median logit spread {spread:.4g}; {float((margins > eps).mean()):.1%} of the bf16 "
              f"greedy steps have a margin above eps (median margin {np.median(margins):.4g}); "
              f"prompt argmax agreement {agree:.4f}; parity_up_to_ties ok={ok} ties={ties} "
              f"identical_requests {same}/{len(outs)}", flush=True)
        if not ok or not eps <= 0.25 * spread:
            raise AssertionError(f"int{bits} KV vs bf16 KV: parity {detail}, or eps {eps} above a "
                                 f"quarter of the logit spread {spread} (vacuous)")
        if bits == 8:  # chained vs unchained decode tok/s in turns: A B (above), B A, A B
            profile_decode(main, prompts)
            tps = {"int-chain": [tp["decode_tok_s"]],
                   "int-forward": [unchained.throughput()["decode_tok_s"]]}
            for order in (("int-forward", "int-chain"), ("int-chain", "int-forward")):
                for which in order:
                    chain = which == "int-chain"
                    tps[which].append(run(f"int{bits} KV, {which}, kernel (timing)", bits,
                                          int_chain=chain, int_forward=not chain,
                                          decode_kernel=True)[3]["decode_tok_s"])
            print(f"int{bits} KV decode tok/s in turns (A B B A A B): " + "; ".join(
                f"{k} {[round(v, 2) for v in vs]} median {np.median(vs):.2f}"
                for k, vs in tps.items()), flush=True)
        del main, unchained, gathered, l_q, l_u
        torch.cuda.empty_cache()
    return counts


MEGASTEP_N = 8  # decode_steps of phase 4m: 31 decode tokens = three full windows and one partial
MEGASTEP_MAX_WINDOW_OPS = 50


def window_ops(engine, prompts) -> int:
    """Host-dispatched PyTorch operators in one megastep window of
    ``engine`` (every request admitted and prefilled, and one window run,
    first); then one window of the decode forward run eagerly on the same
    live slots under ``no_host_sync`` (the forward the graph holds reads no
    device value back).  Drains the requests and returns the window's ops."""
    from repro_torch.serve.engine import Request

    for i, p in enumerate(prompts):
        engine.submit(Request(uid=4000 + i, prompt=p, max_new=2 * engine.decode_steps + 2))
    engine.step()
    with op_counter() as count:
        engine.megastep()
    inp = torch.as_tensor(engine._window_inputs(engine.sched.live), device=engine.device)
    torch.cuda.synchronize()
    with no_host_sync():
        engine._window(inp)
    torch.cuda.synchronize()
    while not engine.sched.idle():
        engine.step()
    return count.n


def serve_megastep(dev, arch, params, prompts, *, rt, kv_bits, per_call: dict,
                   names: dict) -> dict:
    """Phase 4m on one decoder's params: the megastep (``decode_steps=8``, a
    CUDA-graph replay a window) against the per-tick engine on the same
    prompts (64 tokens, 32 new, batch 8).  Gates: tokens identical (the
    largest margin difference printed), ``graph_replays`` one a window and
    at least one, every tick of every window through the kernels (each
    ``ops.launch_counts`` counter of ``per_call`` counts ``(a, b)``: ``a`` a
    decode tick, ``b`` a prefill chunk), the EOS rerun (``eos_id`` = request 0's
    per-tick token at step 16) identical with request 0 ended early and every
    block freed, at most ``MEGASTEP_MAX_WINDOW_OPS`` host ops a window.
    Prints decode tok/s per-tick vs megastep (median of 3 alternating runs),
    host ops a tick vs a window, capture seconds, the graph pool's bytes and
    one window's launches by kernel.  Returns the main run's launches by
    kernel entry (``names``: entry -> ``ops.launch_counts`` key, or a pair
    (key, key subtracted))."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import PagedServeEngine

    tag = f"4m {arch.name}"
    kw = dict(batch=8, max_seq=96, block_size=16, prefill_chunk=32, device=dev, rt=rt,
              kv_quant=kv_bits is not None, kv_bits=kv_bits or 8)
    tick = PagedServeEngine(arch, params, **kw)
    mega = PagedServeEngine(arch, params, decode_steps=MEGASTEP_N, **kw)
    for e in (tick, mega):  # warm-up; the megastep engine captures its window here
        e.generate(prompts[:1], max_new=2)

    def run(engine):
        engine.reset_stats()
        torch.cuda.synchronize()
        outs = engine.generate(prompts, max_new=32)
        torch.cuda.synchronize()
        return outs, engine.throughput()

    torch.cuda.synchronize()
    before = ops.launch_counts()
    outs, tp = run(mega)
    after = ops.launch_counts()
    delta = {k: after[k] - before[k] for k in after}
    windows = tp["decode_dispatches"]
    chunks = sum(-(-len(p) // 32) for p in prompts)
    ticks = MEGASTEP_N * windows  # a window runs all N ticks, coasting ones too
    want = {k: a * ticks + b * chunks for k, (a, b) in per_call.items()}
    got = {k: delta[k] for k in want}
    if got != want or tp["graph_replays"] != windows or windows < 1:
        raise AssertionError(f"[{tag}] launches {got} (expected {want}) over {windows} windows "
                             f"and {tp['graph_replays']} graph replays")
    ref, ttp = run(tick)
    tps = {"per-tick": [ttp["decode_tok_s"]], "megastep": [tp["decode_tok_s"]]}
    marg = max(abs(a - b) for r, g in zip(tick.last_requests, mega.last_requests)
               for a, b in zip(r.margins, g.margins))
    print(f"[{tag}] {len(prompts)} requests over 8 slots: {windows} windows = {windows} graph "
          f"replays, {tp['decode_tokens']} decode tokens; tokens identical to the per-tick "
          f"engine's {outs == ref}; largest margin difference {marg!r}", flush=True)
    if outs != ref or len(outs[0]) != 32:
        raise AssertionError(f"[{tag}] megastep tokens differ from the per-tick engine's")
    for which in ("per-tick", "megastep", "megastep", "per-tick"):
        tps[which].append(run(tick if which == "per-tick" else mega)[1]["decode_tok_s"])
    # EOS: request 0's per-tick token at step 16 ends it early in both engines
    eos = int(ref[0][16])
    for e in (tick, mega):
        e.eos_id = eos
    eos_outs = [run(e)[0] for e in (tick, mega)]
    for e in (tick, mega):
        e.eos_id = None
    freed = [e.cache.free_blocks == e.cache.num_blocks - 1 for e in (tick, mega)]
    print(f"[{tag}] eos_id {eos}: tokens identical {eos_outs[0] == eos_outs[1]}, request 0 "
          f"ends after {len(eos_outs[1][0])} tokens, lengths {[len(o) for o in eos_outs[1]]}, "
          f"every block freed {freed}", flush=True)
    if eos_outs[0] != eos_outs[1] or len(eos_outs[1][0]) >= 32 or not all(freed):
        raise AssertionError(f"[{tag}] the EOS rerun differs or did not end request 0 early")
    n_tick = tick_ops(tick, prompts[:8])
    n_window = window_ops(mega, prompts[:8])
    info = mega.graph_info
    print(f"[{tag}] decode tok/s in turns (M T T M M T): " + "; ".join(
        f"{k} {[round(v, 2) for v in vs]} median {np.median(vs):.2f}" for k, vs in tps.items())
        + f" ({np.median(tps['megastep']) / np.median(tps['per-tick']):.2f}x); host ops a tick "
        f"{n_tick}, a window of {MEGASTEP_N} ticks {n_window} (no host sync in an eager window); "
        f"capture {info['capture_s']:.3f} s; graph pool {info['pool_bytes']} bytes "
        f"({info['pool_bytes'] / 2**20:.1f} MiB); one window's launches {info['launches']}",
        flush=True)
    if n_window > MEGASTEP_MAX_WINDOW_OPS:
        raise AssertionError(f"[{tag}] {n_window} host ops a window > {MEGASTEP_MAX_WINDOW_OPS}")
    del tick, mega
    torch.cuda.empty_cache()
    return {entry: delta[key] if isinstance(key, str) else delta[key[0]] - delta[key[1]]
            for entry, key in names.items()}


# phase 4o (PERF.md section 4): phase 4m's batch, prompts and budget on phase 4's
# smollm-135m params, bf16 KV; the sampled runs' top-k and temperature
OBS_TOP_K, OBS_TEMPERATURE = 40, 0.8
OBS_HOT = 64.0  # a temperature at which the top-k draws spread (the fresh-noise gates)
OBS_DRAWS = 2000  # sample_tokens draws of the (64, vocab) logits on the card
OBS_P_MIN = 1e-4  # the chi-square gate of tests/test_torch_sampling.py


def _launch_delta(fn):
    """``fn()``'s result and the ``ops.launch_counts`` increase over it."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    before = ops.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = ops.launch_counts()
    return out, {k: after[k] - before[k] for k in after}


def _q8_leaves(tree) -> int:
    if not isinstance(tree, dict):
        return 0
    return 1 if "q8" in tree else sum(_q8_leaves(v) for v in tree.values())


def sampled_in_distribution(dev, vocab: int) -> str:
    """``sample_tokens`` on the card over fixed ``(64, vocab)`` logits (seed
    0, N(0, 2^2)), ``OBS_DRAWS`` draws with top-k ``OBS_TOP_K`` at
    ``OBS_TEMPERATURE``: every token in its row's top-k set, and the counts
    against the masked softmax by Pearson's chi-square over all rows' cells
    at p > ``OBS_P_MIN``.  Returns the line to print."""
    from scipy.stats import chi2

    from repro_torch.serve.sampling import SampleConfig, sample_tokens

    cfg = SampleConfig("topk", temperature=OBS_TEMPERATURE, top_k=OBS_TOP_K)
    logits = torch.randn((64, vocab), generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev) * 2
    gen = torch.Generator(device=dev).manual_seed(1)
    draws = torch.stack([sample_tokens(logits, cfg, gen) for _ in range(OBS_DRAWS)])
    vals, idx = torch.topk(logits, OBS_TOP_K, dim=-1)
    hits = draws.long()[:, :, None] == idx[None]  # (draws, rows, k)
    if not bool(hits.any(-1).all()):
        raise AssertionError("[4o] sample_tokens drew a token outside its row's top-k set")
    counts = hits.sum(0).double().cpu().numpy()
    p = torch.softmax(vals.double() / OBS_TEMPERATURE, -1).cpu().numpy()
    stat = float((((counts - OBS_DRAWS * p) ** 2) / (OBS_DRAWS * p)).sum())
    dof = 64 * (OBS_TOP_K - 1)
    pval = float(chi2.sf(stat, dof))
    ms = events_ms(lambda: sample_tokens(logits, cfg, gen), 20)
    if not pval > OBS_P_MIN:
        raise AssertionError(f"[4o] sampled tokens off the masked softmax: chi-square {stat:.1f} "
                             f"on {dof} dof, p {pval:.3g}")
    return (f"[4o] sample_tokens on the card, (64, {vocab}) logits, top-k {OBS_TOP_K} at "
            f"temperature {OBS_TEMPERATURE}: {OBS_DRAWS} draws a row, all in the row's top-k "
            f"set; chi-square {stat:.1f} on {dof} dof, p {pval:.3g} (> {OBS_P_MIN}); "
            f"{ms:.4f} ms a call")


def serve_observed(dev, arch, params) -> dict:
    """Phase 4o on phase 4's smollm-135m params: observability and sampling
    at full width, on ``Runtime(int_chain=True, decode_kernel=True)``, bf16
    KV, ``decode_steps=8`` (phase 4m's 8 prompts of 64 tokens, 32 new,
    batch 8):

    1. a traced engine (``Obs(trace=True)``) against an untraced one: tokens
       and margins bit for bit, the same launches in the main run, the same
       host ops a window (at most ``MEGASTEP_MAX_WINDOW_OPS``); the trace
       holds the reference's span names, is exported under ``build/obs``
       and read back as JSON; the spans' total ms by name, the events a
       window and the spans' share of a window's wall time printed;
    2. ``metrics_snapshot()`` against ``stats``, ``cache.counters()`` and
       ``graph_info``: ``jit_cache_size{fn=megadecode}`` 1 (one capture),
       the replays one a decode dispatch; the snapshot's size printed;
    3. ``engine_headroom`` at ``seq`` 8 (int_matmul's split-K decode kernel)
       and 32 (its tensor-core kernel): 0 violations, ``util_max < 1``,
       ``observed_frac_max <= util_max``, one static record a deployed
       ``q8`` leaf; the figures printed;
    4. sampling: temperature 1e-7 gives step 1's greedy tokens bit for bit;
       two engines with the same seed at top-k ``OBS_TOP_K``, temperature
       ``OBS_TEMPERATURE`` give the same tokens, and two at ``OBS_HOT`` too,
       off the greedy ones; two replays of one hot engine's window on the
       same inputs (8 live slots) draw different tokens;
       ``sample_tokens`` in distribution (``sampled_in_distribution``);
       decode tok/s sampled vs greedy megastep in turns (G S S G);
    5. the launcher once with ``--paged --deploy-int8 --int-chain
       --decode-kernel --decode-steps 8 --sample topk --temperature 0.8
       --top-k 40 --trace ... --metrics-json ...``, its deploy held to the
       plain quantizer: the headroom line (0 violations) and both files
       written and read back.

    Returns the launches of the traced main run, the headroom forwards and
    the launcher run by kernel entry."""
    from repro_torch.kernels.a2q_quantize import a2q_quantize_cuda
    from repro_torch.kernels.int_matmul import int_matmul_cuda
    from repro_torch.models.lm import Runtime
    from repro_torch.obs import Obs
    from repro_torch.obs.headroom import engine_headroom, static_headroom_report
    from repro_torch.serve.engine import PagedServeEngine, Request
    from repro_torch.serve.sampling import SampleConfig

    phase("4o: smollm-135m traced, metrics, accumulator headroom and top-k sampling "
          "on the megastep")
    t_phase = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "build" / "obs"
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.vocab, (64,)).astype(np.int32) for _ in range(8)]
    chunks = sum(-(-len(p) // 32) for p in prompts)
    n = 7 * arch.n_layers
    kw = dict(batch=8, max_seq=96, block_size=16, prefill_chunk=32, device=dev,
              decode_steps=MEGASTEP_N, rt=Runtime(int_chain=True, decode_kernel=True))
    topk = SampleConfig("topk", temperature=OBS_TEMPERATURE, top_k=OBS_TOP_K)

    def engine(**more):
        e = PagedServeEngine(arch, params, **kw, **more)
        e.generate(prompts[:1], max_new=2)  # warm-up; captures the window
        return e

    def run(e):
        e.reset_stats()
        outs = e.generate(prompts, max_new=32)
        torch.cuda.synchronize()
        return outs, e.throughput()

    # 1. tracing is observation only
    plain, traced = engine(), engine(obs=Obs(trace=True))
    (want, gtp), plain_launches = _launch_delta(lambda: run(plain))
    walls: list = []
    megastep = traced.megastep

    def timed_megastep():
        t0 = time.perf_counter()
        live = megastep()
        walls.append(time.perf_counter() - t0)
        return live

    traced.megastep = timed_megastep
    (got, ttp), counted = _launch_delta(lambda: run(traced))
    traced.megastep = megastep
    windows = ttp["decode_dispatches"]
    if got != want or [r.margins for r in traced.last_requests] != \
            [r.margins for r in plain.last_requests] or counted != plain_launches:
        raise AssertionError("[4o] the traced engine's tokens, margins or launches differ from "
                             "the untraced engine's")
    expect = {"int_matmul_cuda.prologue_launches": n * (MEGASTEP_N * windows + chunks),
              "paged_attention_cuda.launches": arch.n_layers * MEGASTEP_N * windows}
    if any(counted[k] != v for k, v in expect.items()) or windows < 1 or \
            ttp["graph_replays"] != windows:
        raise AssertionError(f"[4o] launches {counted} (expected {expect}) over {windows} windows")
    tr = traced.obs.trace
    events = list(tr.events)
    names = tr.span_names()
    need = {"submit", "admit", "block_alloc", "prefill_chunk", "cow_preflight",
            "decode_megastep", "emit"}
    if not need <= names:
        raise AssertionError(f"[4o] the trace lacks {need - names}")
    tr.export(str(out_dir / "trace.json"))
    doc = json.loads((out_dir / "trace.json").read_text())
    if len(doc["traceEvents"]) != len(events):
        raise AssertionError("[4o] the exported trace does not read back whole")
    by_name: dict = {}
    for _, name, _, dur, _ in events:
        if dur is not None:
            by_name[name] = by_name.get(name, 0.0) + dur * 1e3
    # the windows' preflights carry "live"; the prefill chunks' carry "uid"
    preflight_ms = sum(dur for _, _, dur, args in tr.spans("cow_preflight") if "live" in args) * 1e3
    window_ms, wall_ms = by_name["decode_megastep"], sum(walls) * 1e3
    print(f"[4o] traced vs untraced: tokens and margins bit for bit, launches equal "
          f"({ {k: v for k, v in counted.items() if v} }); {len(events)} events, "
          f"{len(events) / windows:.1f} a window over {windows} windows; span ms by name "
          f"{ {k: round(v, 3) for k, v in sorted(by_name.items())} }; a window's spans "
          f"(cow_preflight {preflight_ms / windows:.3f} + decode_megastep "
          f"{window_ms / windows:.3f} ms) of its megastep() wall {wall_ms / windows:.3f} ms: "
          f"{(preflight_ms + window_ms) / wall_ms:.4f}; decode tok/s untraced "
          f"{gtp['decode_tok_s']:.2f}, traced {ttp['decode_tok_s']:.2f}", flush=True)
    # 2. metrics of the traced run
    snap = traced.metrics_snapshot()
    cc = traced.cache.counters()
    checks = {
        "serve_prefill_tokens": ttp["prefill_tokens"], "serve_decode_tokens": ttp["decode_tokens"],
        "serve_decode_dispatches": ttp["graph_replays"], "requests_completed": len(prompts),
        "kv_peak_blocks": cc.pop("peak_blocks"), "kv_free_blocks": traced.cache.free_blocks,
        **{f"kv_{k}": v for k, v in cc.items()},
        "jit_cache_size{fn=megadecode}": 1, "jit_cache_size{fn=prefill}": 0,
        "jit_cache_size{fn=decode}": 0, "int_chain_folded": n,
        "int_chain_requant_dispatches": 0}
    bad = {k: (snap.get(k, {}).get("value"), v) for k, v in checks.items()
           if snap.get(k, {}).get("value") != v}
    if bad or len(snap["request_latency_s"]["values"]) != len(prompts) or \
            not traced.graph_info:
        raise AssertionError(f"[4o] metrics snapshot off the engine's state: {bad}")
    print(f"[4o] metrics snapshot: {len(snap)} metrics, agrees with stats, cache.counters() "
          f"and graph_info (jit_cache_size{{fn=megadecode}} 1, {ttp['graph_replays']} replays "
          f"= decode dispatches); p50 / p99 request latency "
          f"{traced.obs.metrics.histogram('request_latency_s').percentile(50):.3f} / "
          f"{traced.obs.metrics.histogram('request_latency_s').percentile(99):.3f} s", flush=True)

    # host ops a window (each drains extra requests: after the snapshot)
    ops_plain, ops_traced = window_ops(plain, prompts), window_ops(traced, prompts)
    print(f"[4o] host ops a window: untraced {ops_plain}, traced {ops_traced}", flush=True)
    if ops_plain != ops_traced or ops_traced > MEGASTEP_MAX_WINDOW_OPS:
        raise AssertionError(f"[4o] host ops a window {ops_plain} / {ops_traced} (at most "
                             f"{MEGASTEP_MAX_WINDOW_OPS}, equal)")

    # 3. accumulator headroom on both int_matmul kernels
    static = static_headroom_report(params, arch.quant)
    if len(static) != _q8_leaves(params):
        raise AssertionError(f"[4o] {len(static)} static records for {_q8_leaves(params)} "
                             "deployed q8 leaves")
    for seq in (8, 32):
        tc0 = int_matmul_cuda.tc_launches
        hr, more = _launch_delta(lambda: engine_headroom(traced, seq=seq))
        tc = int_matmul_cuda.tc_launches - tc0
        counted = {k: counted[k] + more[k] for k in counted}
        route = "tensor-core" if seq >= 17 else "split-K decode"
        if hr["violations"] or not hr["util_max"] < 1 or \
                not 0 < hr["observed_frac_max"] <= hr["util_max"] or \
                hr["observed_sites"] != n or (tc == n) != (seq >= 17):
            raise AssertionError(f"[4o] headroom at seq {seq}: {hr}, {tc} tensor-core launches")
        print(f"[4o] accumulator headroom, seq {seq} ({route} int_matmul): {hr['layers']} "
              f"deployed layers, util_max {hr['util_max']!r}, observed_frac_max "
              f"{hr['observed_frac_max']!r} over {hr['observed_sites']} probed calls, "
              f"{hr['violations']} violations", flush=True)

    # 4. sampling inside the captured window
    cold = engine(sample=SampleConfig("topk", temperature=1e-7, top_k=OBS_TOP_K))
    if run(cold)[0] != want:
        raise AssertionError("[4o] temperature 1e-7 differs from the greedy megastep")
    s1, s2 = engine(sample=topk, seed=0), engine(sample=topk, seed=0)
    (a, stp), (b, _) = run(s1), run(s2)
    if a != b or not all(len(o) == 32 and all(0 <= t < arch.vocab for t in o) for o in a):
        raise AssertionError("[4o] two engines of one seed sampled different tokens")
    # random smollm-135m's tied head puts the top logit far above the rest, so
    # at 0.8 the draws mostly take it: the fresh-noise gates run hot as well
    h1, h2 = (engine(sample=SampleConfig("topk", temperature=OBS_HOT, top_k=OBS_TOP_K), seed=0)
              for _ in range(2))
    hot, hot2 = run(h1)[0], run(h2)[0]
    # two replays on one window's inputs: every request admitted and one
    # window run, then the live slots' window twice (the rows' first tick
    # sees the same logits in both; the writes stay in their reservations)
    for i, p in enumerate(prompts):
        h1.submit(Request(uid=6000 + i, prompt=p, max_new=3 * MEGASTEP_N))
    h1.step()
    inp = h1._window_inputs(h1.sched.live)
    offset = (lambda: h1._gen.get_offset()) if h1._gen.device.type == "cuda" else (lambda: 0)
    offsets = [offset()]
    w1 = h1._run_window(inp)[0].copy()  # a view of the pinned read-back buffer otherwise
    offsets.append(offset())
    w2 = h1._run_window(inp)[0].copy()
    offsets.append(offset())
    while not h1.sched.idle():
        h1.step()
    margin = float(np.median([m for r in plain.last_requests for m in r.margins]))
    same = sum(x == y for o, g in zip(a, want) for x, y in zip(o, g))
    if hot != hot2 or hot == want or np.array_equal(w1, w2):
        raise AssertionError(f"[4o] at temperature {OBS_HOT}: two engines of one seed "
                             f"identical {hot == hot2}, the greedy tokens {hot == want}, two "
                             f"replays on the same inputs identical {np.array_equal(w1, w2)}")
    print(f"[4o] sampled megastep (top-k {OBS_TOP_K}): temperature 1e-7 = greedy bit for bit; "
          f"two engines of seed 0 identical at {OBS_TEMPERATURE} ({same} of {32 * len(a)} "
          f"tokens the greedy ones; greedy top-2 margin median {margin:.3f}) and at {OBS_HOT} "
          f"({sum(x != y for o, g in zip(hot, want) for x, y in zip(o, g))} tokens off the "
          f"greedy ones); two replays of the window on the same inputs at {OBS_HOT} differ in "
          f"{int((w1 != w2).sum())} of {w1.size} tokens (first tick {int((w1[:, 0] != w2[:, 0])
          .sum())} of {len(w1)}); generator offset by replay {np.diff(offsets).tolist()}",
          flush=True)
    print(sampled_in_distribution(dev, arch.vocab), flush=True)
    tps = {"greedy": [gtp["decode_tok_s"]], "sampled": [stp["decode_tok_s"]]}
    for which in ("sampled", "greedy"):
        tps[which].append(run(s1 if which == "sampled" else plain)[1]["decode_tok_s"])
    print("[4o] megastep decode tok/s in turns (G S S G): " + "; ".join(
        f"{k} {[round(v, 2) for v in vs]} mean {np.mean(vs):.2f}" for k, vs in tps.items()),
        flush=True)
    del plain, cold, s1, s2, h1, h2

    # 5. the launcher with sampling, --trace and --metrics-json
    trace_path, metrics_path = out_dir / "launcher_trace.json", out_dir / "launcher_metrics.json"
    argv = ["--arch", arch.name, "--device", str(dev), "--paged", "--deploy-int8", "--int-chain",
            "--decode-kernel", "--decode-steps", str(MEGASTEP_N), "--sample", "topk",
            "--temperature", str(OBS_TEMPERATURE), "--top-k", str(OBS_TOP_K),
            "--trace", str(trace_path), "--metrics-json", str(metrics_path),
            "--requests", "8", "--prompt-len", "64", "--max-new", "16", "--batch", "8",
            "--max-seq", "96", "--block-size", "16", "--prefill-chunk", "32"]
    a2q_quantize_cuda.launches = 0
    with held_deploys("4o launcher") as held:
        out, more = _launch_delta(lambda: launcher(argv, get_arch=lambda name: arch))
    check_held("4o launcher", held, a2q_quantize_cuda.launches)
    counted = {k: counted[k] + more[k] for k in counted}
    hr = out["report"]["headroom"]
    ltrace = json.loads(trace_path.read_text())["traceEvents"]
    lsnap = json.loads(metrics_path.read_text())
    if hr["violations"] or more["a2q_quantize_cuda.launches"] != n or \
            not {"decode_megastep", "emit"} <= {e["name"] for e in ltrace} or \
            lsnap["requests_completed"]["value"] != 8 or \
            lsnap["acc_headroom_violations"]["value"] != 0 or \
            lsnap["jit_cache_size{fn=megadecode}"]["value"] != 1:
        raise AssertionError(f"[4o] launcher run: headroom {hr}, {len(ltrace)} trace events, "
                             f"{len(lsnap)} metrics")
    print(f"[4o] launcher --sample topk --trace --metrics-json: {len(ltrace)} trace events, "
          f"{len(lsnap)} metrics written and read back; headroom {hr}", flush=True)
    del out, traced
    torch.cuda.empty_cache()
    launches = {"int_matmul": counted["int_matmul_cuda.launches"]
                - counted["int_matmul_cuda.prologue_launches"],
                "int_matmul[prologue]": counted["int_matmul_cuda.prologue_launches"],
                "int_matmul[tc]": counted["int_matmul_cuda.tc_launches"],
                "paged_attention": counted["paged_attention_cuda.launches"],
                "a2q_quantize": counted["a2q_quantize_cuda.launches"],
                "a2q_quantize[flips]": held["flips"]}
    print(f"[4o] launches {launches}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# phase 4s (PERF.md section 4): phase 4m's batch, blocks and prefill chunk; a
# 64-token shared prefix and a 4-24-token tail a request, 16 new tokens
SHARE_REQUESTS, SHARE_PREFIX, SHARE_TAIL, SHARE_NEW = 10, 64, (4, 24), 16
SHARE_COW_CHUNK = 40  # resumes adopters at 40, inside the shared block 32..47
SHARE_PIN, SHARE_PIN_BLOCKS = 32, 21  # the pinned preamble; 2 pinned + 2 x 9 blocks + trash
SPEC_K, SPEC_DRAFT_LAYERS = 4, 4
SPEC_EPS, SPEC_KV_EPS = 1e-3, 0.05  # bf16 pools; the reference's int8-KV eps


def spec_round_ops(engine, prompts) -> int:
    """Host-dispatched PyTorch operators in one speculative round of
    ``engine`` (every request admitted and prefilled, and one round run,
    first); drains the requests."""
    from repro_torch.serve.engine import Request

    for i, p in enumerate(prompts):
        engine.submit(Request(uid=5000 + i, prompt=p, max_new=3 * (engine.spec_k + 1)))
    engine.step()
    with op_counter() as count:
        engine.spec_round()
    while not engine.sched.idle():
        engine.step()
    return count.n


def serve_shared(dev, arch, params) -> dict:
    """Phase 4s on phase 4's smollm-135m params: prefix sharing and
    speculative decoding at full width (``SHARE_REQUESTS`` requests of a
    ``SHARE_PREFIX``-token shared prefix and a ``SHARE_TAIL`` tail, seed 2;
    ``SHARE_NEW`` new tokens; batch 8, blocks of 16, prefill chunk 32) on
    ``Runtime(int_forward=True, decode_kernel=True)``:

    1. sharing per tick against the same engine without sharing: tokens
       identical and margins bit for bit, ``prefix_hits`` > 0, the prefill
       tokens saved;
    2. sharing at prefill chunk ``SHARE_COW_CHUNK`` (adopters resume inside
       a shared block and copy it): ``cow_copies`` > 0, every pool tensor's
       ``data_ptr()`` unchanged across the run, tokens against the plain
       engine at that chunk under ``parity_up_to_ties`` (eps ``SPEC_EPS``);
    3. sharing on the megastep (``decode_steps=8``, graph replays) against
       step 1's per-tick sharing engine, margins bit for bit; then a
       ``pin_prompt(SHARE_PIN)`` preamble ahead of a body of each request's
       own on the megastep with ``SHARE_PIN_BLOCKS`` blocks, so two requests
       run at a time and ``allocate`` evicts the cold cached blocks: the
       pinned chain survives, every request adopts it, and the tokens and
       margins equal the plain per-tick engine's on those prompts;
    4. ``SpecServeEngine(spec_k=SPEC_K)`` with the default self-int8 drafter
       on bf16 pools and on ``kv_quant`` int8 pools, each under
       ``parity_up_to_ties`` against the plain engine of the same runtime
       (eps ``SPEC_EPS``, ``SPEC_KV_EPS``), its launches exact: every draft
       step 7 int_matmul a layer on the decode kernel and 1 paged_attention
       a layer, every verify (8 rows x 5 tokens) 7 a layer on the tensor
       cores;
    5. a ``ModelDrafter`` of smollm-135m cut to ``SPEC_DRAFT_LAYERS`` layers
       (its own seed 1, A2Q float, the decode kernel), ``min_accept=0``,
       same gate, both caches' free lists whole at the drain;
    6. a spec engine on the megastep whose gate never opens: no round,
       fallback rounds, graph replays, tokens and margins bit for bit.

    Prints the acceptance rate, tokens a row a round, host ops a spec round,
    decode tok/s spec vs plain per tick, and the launches.  Returns the
    sharing and spec runs' launches by kernel entry."""
    from repro_torch.kernels import ops
    from repro_torch.models.lm import Runtime, init_lm
    from repro_torch.serve.engine import PagedServeEngine, parity_up_to_ties
    from repro_torch.serve.spec import ModelDrafter, SpecServeEngine

    phase(f"4s: smollm-135m prefix sharing and speculative decoding (spec_k {SPEC_K}), "
          f"{SHARE_REQUESTS} requests over 8 slots")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(2)
    common = rng.integers(0, arch.vocab, (SHARE_PREFIX,)).astype(np.int32)
    prompts = [np.concatenate([common, rng.integers(0, arch.vocab, (int(n),)).astype(np.int32)])
               for n in rng.integers(SHARE_TAIL[0], SHARE_TAIL[1] + 1, SHARE_REQUESTS)]
    preamble = rng.integers(0, arch.vocab, (SHARE_PIN,)).astype(np.int32)
    # behind the preamble a body of its own a request, so every donor caches
    # cold blocks and the tight pool makes ``allocate`` evict them
    pin_prompts = [np.concatenate([preamble, rng.integers(0, arch.vocab, (len(p),))
                                   .astype(np.int32)]) for p in prompts]
    warm = [rng.integers(0, arch.vocab, (8,)).astype(np.int32)]  # under a block: registers nothing
    rt = Runtime(int_forward=True, decode_kernel=True)
    kw = dict(batch=8, max_seq=160, block_size=16, prefill_chunk=32, device=dev, rt=rt)
    counted = {}  # launches of the sharing and spec runs by kernel entry (baselines left out)

    def run(engine, ps, count=True, pools="paged_attention"):
        engine.generate(warm, max_new=2)  # first-call set-up (and a megastep's capture)
        engine.reset_stats()
        torch.cuda.synchronize()
        before = ops.launch_counts()
        outs = engine.generate(ps, max_new=SHARE_NEW)
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}
        if count:
            for entry, key in (("int_matmul", "int_matmul_cuda.launches"),
                               ("int_matmul[tc]", "int_matmul_cuda.tc_launches"),
                               (pools, "paged_attention_cuda.launches")):
                counted[entry] = counted.get(entry, 0) + delta.get(key, 0)
        for r, o in zip(engine.last_requests, outs):
            if len(o) != SHARE_NEW or not all(0 <= t < arch.vocab for t in o) or \
                    not np.isfinite(r.margins).all():
                raise AssertionError(f"[4s] bad output: {o} margins {r.margins}")
        return outs, delta

    def margins(engine):
        return [r.margins for r in engine.last_requests]

    def same(a, b):
        return [r.generated for r in a.last_requests] == [r.generated for r in b.last_requests] \
            and margins(a) == margins(b)

    # 1. sharing, per tick
    plain = PagedServeEngine(arch, params, **kw)
    want, _ = run(plain, prompts, count=False)
    share = PagedServeEngine(arch, params, prefix_share=True, **kw)
    run(share, prompts)
    saved = plain.stats["prefill_tokens"] - share.stats["prefill_tokens"]
    print(f"[4s sharing, per tick] prefix_hits {share.cache.prefix_hits}, "
          f"{share.cache.prefix_hit_tokens} prompt tokens adopted, prefill tokens "
          f"{share.stats['prefill_tokens']} vs {plain.stats['prefill_tokens']} ({saved} saved); "
          f"prefill {share.throughput()['prefill_tok_s']:.1f} vs "
          f"{plain.throughput()['prefill_tok_s']:.1f} tok/s; tokens and margins bit for bit "
          f"{same(share, plain)}; cow_copies {share.cache.cow_copies}", flush=True)
    if not same(share, plain) or share.cache.prefix_hits < SHARE_REQUESTS - 1 or saved <= 0:
        raise AssertionError("[4s] sharing per tick differs from the plain engine or never hit")

    # 2. copy-on-write: adopters resume inside a shared block
    cow_kw = dict(kw, prefill_chunk=SHARE_COW_CHUNK)
    plain_cow = PagedServeEngine(arch, params, **cow_kw)
    run(plain_cow, prompts, count=False)
    cow = PagedServeEngine(arch, params, prefix_share=True, **cow_kw)
    ptrs = [leaf.data_ptr() for leaf in cow.cache._leaves(pools=True)]
    run(cow, prompts)
    kept = ptrs == [leaf.data_ptr() for leaf in cow.cache._leaves(pools=True)]
    ok, ties, detail = parity_up_to_ties(plain_cow.last_requests,
                                         [r.generated for r in cow.last_requests], SPEC_EPS)
    print(f"[4s copy-on-write, chunk {SHARE_COW_CHUNK}] cow_copies {cow.cache.cow_copies} in "
          f"{cow.cache.pool_rebuilds} batched in-place copies, prefix_hits "
          f"{cow.cache.prefix_hits}; every pool's data_ptr unchanged {kept}; against the plain "
          f"engine: parity_up_to_ties eps={SPEC_EPS} ok={ok} ties={ties}, bit for bit "
          f"{same(cow, plain_cow)}", flush=True)
    if cow.cache.cow_copies <= 0 or not kept or not ok:
        raise AssertionError(f"[4s] copy-on-write run: {detail}")
    del plain_cow, cow

    # 3. sharing on the megastep, then a pinned preamble under block pressure
    mega = PagedServeEngine(arch, params, prefix_share=True, decode_steps=MEGASTEP_N, **kw)
    run(mega, prompts)
    tp = mega.throughput()
    print(f"[4s sharing, megastep] {tp['graph_replays']} graph replays, prefix_hits "
          f"{mega.cache.prefix_hits}; tokens and margins bit for bit with the per-tick sharing "
          f"engine {same(mega, share)}; decode {tp['decode_tok_s']:.1f} vs per tick "
          f"{share.throughput()['decode_tok_s']:.1f} tok/s", flush=True)
    if not same(mega, share) or tp["graph_replays"] < 1 or mega.cache.prefix_hits < 1:
        raise AssertionError("[4s] sharing on the megastep differs from per tick")
    del mega
    plain_pin = PagedServeEngine(arch, params, **kw)
    run(plain_pin, pin_prompts, count=False)
    pin = PagedServeEngine(arch, params, prefix_share=True, decode_steps=MEGASTEP_N,
                           num_blocks=SHARE_PIN_BLOCKS, **kw)
    pin.generate(warm, max_new=2)  # the capture, before the pin (needs an idle engine)
    pinned = pin.pin_prompt(preamble)
    evicted = [0]
    evict_one = pin.cache._evict_one

    def counting(*a, **k):
        out = evict_one(*a, **k)
        evicted[0] += out
        return out

    pin.cache._evict_one = counting
    run(pin, pin_prompts)
    survived = pin.cache.lookup_prefix(np.concatenate([preamble, warm[0]]))[0]
    print(f"[4s pin_prompt({SHARE_PIN}), megastep, {SHARE_PIN_BLOCKS} blocks] pinned {pinned} "
          f"tokens; {evicted[0]} prompt-cache nodes evicted under pressure; the pinned chain "
          f"still serves {survived} tokens; prefix_hits {pin.cache.prefix_hits}; tokens and "
          f"margins bit for bit with the plain per-tick engine {same(pin, plain_pin)}", flush=True)
    if pinned != SHARE_PIN or evicted[0] < 1 or survived < SHARE_PIN or not same(pin, plain_pin) \
            or pin.cache.prefix_hits < SHARE_REQUESTS:
        raise AssertionError("[4s] the pinned run did not evict, lost its pin or differs")
    del pin, plain_pin, share

    # 4. speculative decoding, default self-int8 drafter, bf16 and int8 pools
    n = 7 * arch.n_layers
    spec_rows = {}
    for kv, eps, base in (("bf16", SPEC_EPS, plain), ("int8", SPEC_KV_EPS, None)):
        skw = dict(kw, kv_quant=kv == "int8")
        if base is None:
            base = PagedServeEngine(arch, params, **skw)
            run(base, prompts, count=False)
        spec = SpecServeEngine(arch, params, spec_k=SPEC_K, **skw)
        outs, delta = run(spec, prompts, pools=f"paged_attention{'[int8]' * (kv == 'int8')}")
        st, tps = dict(spec.spec_stats), spec.throughput()
        chunks = sum(-(-len(p) // 32) for p in prompts)
        ones = sum(len(p) % 32 == 1 for p in prompts)  # a one-token chunk reads through the kernel
        k_rounds, plain_ticks = SPEC_K * st["rounds"], st["fallback_rounds"]
        want_counts = {"int_matmul_cuda.launches":
                       n * (chunks + k_rounds + st["rounds"] + plain_ticks),
                       "paged_attention_cuda.launches":
                       arch.n_layers * (k_rounds + plain_ticks + ones)}
        got_counts = {k: delta.get(k, 0) for k in want_counts}
        ok, ties, detail = parity_up_to_ties(base.last_requests, outs, eps)
        identical = outs == [r.generated for r in base.last_requests]
        rows = st["proposed"] // SPEC_K
        ops_round = spec_round_ops(spec, prompts[:8])
        spec_rows[kv] = (spec.acceptance_rate(), st["emitted"] / max(rows, 1))
        print(f"[4s spec k={SPEC_K}, self-int8 drafter, {kv} KV] spec_stats {st}; acceptance "
              f"{spec.acceptance_rate():.4f}; {st['emitted'] / max(rows, 1):.3f} tokens a row a "
              f"round; parity_up_to_ties eps={eps} ok={ok} ties={ties}, tokens identical "
              f"{identical}; decode {tps['decode_tok_s']:.1f} tok/s vs plain per tick "
              f"{base.throughput()['decode_tok_s']:.1f}; host ops a spec round {ops_round}; "
              f"launches {got_counts} (expected {want_counts}), int_matmul on the tensor cores "
              f"{delta.get('int_matmul_cuda.tc_launches', 0)}", flush=True)
        if not ok or st["rounds"] < 1 or got_counts != want_counts or \
                delta.get("int_matmul_cuda.tc_launches", 0) < n * st["rounds"]:
            raise AssertionError(f"[4s] spec on {kv} KV: {detail}, launches {got_counts}")
        if base is not plain:
            del base
        del spec

    # 5. a model drafter: smollm-135m cut to SPEC_DRAFT_LAYERS layers, its own seed
    darch = dataclasses.replace(arch, stacks=(dataclasses.replace(arch.stacks[0],
                                                                  count=SPEC_DRAFT_LAYERS),))
    dparams = init_lm(torch.Generator(device=dev).manual_seed(1), darch, device=dev)
    drafter = ModelDrafter(darch, dparams, slots=8, max_seq=kw["max_seq"], spec_k=SPEC_K,
                           block_size=16, prefill_chunk=32, rt=Runtime(decode_kernel=True),
                           device=dev)
    mspec = SpecServeEngine(arch, params, spec_k=SPEC_K, drafter=drafter, min_accept=0.0, **kw)
    outs, _ = run(mspec, prompts)
    ok, ties, detail = parity_up_to_ties(plain.last_requests, outs, SPEC_EPS)
    whole = (mspec.cache.free_blocks == mspec.cache.num_blocks - 1,
             drafter.cache.free_blocks == drafter.cache.num_blocks - 1)
    print(f"[4s spec k={SPEC_K}, model drafter ({SPEC_DRAFT_LAYERS} layers, seed 1)] spec_stats "
          f"{mspec.spec_stats}; acceptance {mspec.acceptance_rate():.4f}; parity_up_to_ties "
          f"eps={SPEC_EPS} ok={ok} ties={ties}; decode {mspec.throughput()['decode_tok_s']:.1f} "
          f"tok/s; free lists whole (engine, drafter) {whole}", flush=True)
    if not ok or not all(whole) or mspec.spec_stats["rounds"] < 1:
        raise AssertionError(f"[4s] model drafter: {detail}, free lists {whole}")
    del mspec, drafter, dparams

    # 6. the fallback through the megastep: a gate that never opens
    fb = SpecServeEngine(arch, params, spec_k=SPEC_K, min_accept=2.0, probe_interval=10**6,
                         decode_steps=MEGASTEP_N, **kw)
    run(fb, prompts)
    st, tp = fb.spec_stats, fb.throughput()
    print(f"[4s spec fallback, megastep] rounds {st['rounds']}, fallback_rounds "
          f"{st['fallback_rounds']}, graph replays {tp['graph_replays']}; tokens and margins bit "
          f"for bit with the plain per-tick engine {same(fb, plain)}", flush=True)
    if st["rounds"] != 0 or st["fallback_rounds"] < 1 or tp["graph_replays"] < 1 or \
            not same(fb, plain):
        raise AssertionError("[4s] the megastep fallback differs or ran a round")
    del fb, plain
    torch.cuda.empty_cache()
    print(f"[4s] acceptance and tokens a row a round (bf16, int8 KV) {spec_rows}; launches "
          f"{counted}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counted


DEEPSEEK_INT_MATMUL_PER_FORWARD = 29  # see deepseek_int_matmul_per_forward


def deepseek_arch():
    """deepseek-v3 at full width with its depth cut to the first 3 dense MLA
    layers and 1 MoE layer, without the MTP head (serving never reads it)."""
    from repro_torch.configs import get_arch

    arch = get_arch("deepseek-v3-671b")
    dense, moe = arch.stacks
    return dataclasses.replace(arch, mtp_depth=0, stacks=(
        dataclasses.replace(dense, count=3), dataclasses.replace(moe, count=1)))


def deepseek_int_matmul_per_forward(arch) -> int:
    """Deployed 2-D linears one cached forward with ``mla_absorb`` runs on
    int_matmul: per MLA layer wq_a, wq_b, wkv_a and wo (wkv_b is folded into
    the query and output, not applied as a linear); per dense layer the
    gated MLP's w_in, w_gate and w_out; per MoE layer the shared expert's
    three linears (the routed experts run on the dequantized view); and the
    untied head."""
    n = 1
    for s in arch.stacks:
        ffn = 3 if s.kind == "attn_mlp" else 3 * (s.moe.n_shared > 0)
        n += s.count * (4 + ffn)
    return n


def build_by_block(dev, arch) -> dict:
    """Full-width random A2Q params of ``arch`` (stacks of ``attn_mlp`` and
    ``moe`` blocks: deepseek-v3, llama4-scout), deployed to int8 stack by
    stack and leaf by leaf with the package's own initializers and
    ``deploy_params`` on sub-trees, so no whole fp32 tree exists: the
    largest fp32 leaf alive at once is one routed expert weight (deepseek's
    256 x 7168 x 2048, 15 GB)."""
    from repro_torch.core.quantizers import init_act_quant
    from repro_torch.nn.attention import init_attention
    from repro_torch.nn.embedding import init_embedding
    from repro_torch.nn.linear import init_linear
    from repro_torch.nn.module import kaiming
    from repro_torch.nn.moe import _init_expert_weight
    from repro_torch.nn.norms import init_norm
    from repro_torch.nn.transformer import _init_block
    from repro_torch.serve.engine import deploy_params

    q, d = arch.quant, arch.d_model
    gen = torch.Generator(device=dev).manual_seed(0)

    def moe_layer(s):
        m = s.moe
        ff = m.shared_d_ff or m.d_ff * m.n_shared
        moe = {"router": kaiming(gen, (d, m.n_experts), fan_in=d)}
        for name, (din, dout) in (("w_in", (d, m.d_ff)), ("w_gate", (d, m.d_ff)),
                                  ("w_out", (m.d_ff, d))):
            moe[name] = deploy_params(_init_expert_weight(gen, m.n_experts, din, dout, q), q)
            torch.cuda.empty_cache()
        moe["aq"] = init_act_quant(q.act_bits, True, device=dev)
        moe.update(deploy_params({"shared_in": init_linear(gen, d, ff, q),
                                  "shared_gate": init_linear(gen, d, ff, q),
                                  "shared_out": init_linear(gen, ff, d, q)}, q))
        return {"ln1": init_norm(d, arch.norm, device=dev),
                "attn": deploy_params(init_attention(gen, d, s.attn, q), q),
                "ln2": init_norm(d, arch.norm, device=dev), "moe": moe}

    params = {"embed": init_embedding(gen, arch.vocab, d), "stacks": {}}
    for i, s in enumerate(arch.stacks):
        layers = []
        for _ in range(s.count):
            layers.append(deploy_params(_init_block(gen, arch, s), q) if s.kind == "attn_mlp"
                          else moe_layer(s))
            torch.cuda.empty_cache()
        params["stacks"][str(i)] = _stack_layers(*layers)
    params["final_norm"] = init_norm(d, arch.norm, device=dev)
    params["head"] = deploy_params(init_linear(gen, d, arch.vocab, q, boundary=True), q)
    return params


def _stack_layers(*layers):
    """The ``(count, ...)`` leaves of ``init_stack`` from per-layer trees."""
    if isinstance(layers[0], dict):
        return {k: _stack_layers(*(layer[k] for layer in layers)) for k in layers[0]}
    return layers[0].unsqueeze(0) if len(layers) == 1 else torch.stack(layers)


def kernel_ms(prof) -> dict:
    """Device ms by kernel name in a torch.profiler trace."""
    from torch.autograd import DeviceType

    dev = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # an op's entry repeats its kernels' time
            continue
        t = getattr(e, "self_device_time_total", None)
        t = getattr(e, "self_cuda_time_total", 0) if t is None else t
        dev[e.key] = dev.get(e.key, 0.0) + t / 1e3
    return dev


def profile_decode(engine, prompts, ticks: int = 4) -> None:
    """Device time of ``ticks`` decode ticks by kernel, from a torch.profiler
    trace (CUPTI): every request is admitted and prefilled first, then only
    the decode ticks run under the profiler.  Prints the device time a tick
    spends in each kernel and in all of them together."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request

    for i, p in enumerate(prompts):
        engine.submit(Request(uid=1000 + i, prompt=p, max_new=ticks + 2))
    engine.step()  # admits and prefills every request, then one tick
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            engine.tick()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    while not engine.sched.idle():
        engine.step()
    dev = {k: ms / ticks for k, ms in kernel_ms(prof).items()}
    total = sum(dev.values())
    print(f"profiled decode: {ticks} ticks, kernels' device time {total:.3f} ms a tick, "
          f"{wall_ms:.1f} ms a tick of wall time under the profiler ({len(dev)} kernels)",
          flush=True)
    for name, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:8.4f} ms/tick  {ms / max(total, 1e-9):6.1%}  {name[:110]}", flush=True)


def serve_deepseek(dev):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.a2q_quantize import a2q_quantize_cuda
    from repro_torch.kernels.int_matmul import int_matmul_cuda
    from repro_torch.kernels.paged_mla_attention import paged_mla_attention_cuda
    from repro_torch.models.lm import Runtime, apply_lm, init_lm
    from repro_torch.nn.module import tree_to
    from repro_torch.serve.engine import PagedServeEngine, deploy_params, parity_up_to_ties

    phase("4b: serve full-width deepseek-v3 (3 dense MLA + 1 MoE layer) on the kernels")
    arch = deepseek_arch()
    per_forward = deepseek_int_matmul_per_forward(arch)
    if per_forward != DEEPSEEK_INT_MATMUL_PER_FORWARD:
        raise AssertionError(f"{per_forward} int_matmul per forward, expected 29")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a2q_quantize_cuda.launches = 0
    with held_deploys(arch.name) as held:
        params = build_by_block(dev, arch)
    torch.cuda.synchronize()
    deploys = a2q_quantize_cuda.launches
    check_held(arch.name, held, deploys)
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"init + deploy of {arch.name} cut to {arch.n_layers} layers (d_model {arch.d_model}, "
          f"{arch.stacks[1].moe.n_experts} experts): {time.perf_counter() - t0:.1f}s, "
          f"{n_params / 1e9:.3f} B params, {n_bytes / 1e9:.2f} GB on the card, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, {deploys} a2q_quantize launches",
          flush=True)
    if deploys == 0:
        raise AssertionError("deepseek-v3 was deployed without a2q_quantize")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.vocab, (64,)).astype(np.int32) for _ in range(8)]
    kw = dict(batch=8, max_seq=96, block_size=16, prefill_chunk=32, device=dev)
    rt = Runtime(int_forward=True, decode_kernel=True, mla_absorb=True)
    engine = PagedServeEngine(arch, params, rt=rt, **kw)
    engine.generate(prompts[:1], max_new=2)  # warm-up: first-call library set-up
    engine.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    int_matmul_cuda.launches = int_matmul_cuda.tc_launches = 0
    paged_mla_attention_cuda.launches = paged_mla_attention_cuda.tc_launches = 0
    outs = engine.generate(prompts, max_new=32)
    torch.cuda.synchronize()
    launches = {"int_matmul": int_matmul_cuda.launches,
                "int_matmul[tc]": int_matmul_cuda.tc_launches,
                "paged_mla_attention": paged_mla_attention_cuda.launches,
                "paged_mla_attention[tc]": paged_mla_attention_cuda.tc_launches}
    tp = engine.throughput()
    ticks = tp["decode_dispatches"]
    launches_deploy = {"a2q_quantize": deploys, "a2q_quantize[flips]": held["flips"]}
    chunks = sum(-(-len(p) // 32) for p in prompts)
    print(f"prefill: {tp['prefill_tokens']} tok in {tp['prefill_s']:.3f}s "
          f"({tp['prefill_tok_s']:.2f} tok/s) | decode: {tp['decode_tokens']} tok in "
          f"{tp['decode_s']:.3f}s ({tp['decode_tok_s']:.2f} tok/s, {ticks} ticks); peak "
          f"allocated while serving {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    print(f"launches on the main path: {launches} over {ticks} decode ticks and {chunks} "
          f"prefill chunks; chain report fallbacks {tp['int_chain_fallback']} per forward "
          f"(routed experts)", flush=True)
    n_mla = sum(s.count for s in arch.stacks)
    if launches["int_matmul"] != per_forward * (ticks + chunks) or \
            launches["paged_mla_attention"] != n_mla * ticks or ticks < 31 or \
            launches["paged_mla_attention[tc]"] != launches["paged_mla_attention"]:
        raise AssertionError(f"launch counts {launches} do not show {per_forward} int_matmul "
                             f"per forward and {n_mla} paged_mla_attention per decode tick, all "
                             "on the tensor cores")
    for r, o in zip(engine.last_requests, outs):
        if len(o) != 32 or not all(0 <= t < arch.vocab for t in o) or \
                not np.isfinite(r.margins).all():
            raise AssertionError(f"bad output: {o} margins {r.margins}")
    print(f"req 0 tokens: {outs[0]}", flush=True)
    print(f"host ops per decode tick (int-forward, bf16 KV): {tick_ops(engine, prompts)}",
          flush=True)
    profile_decode(engine, prompts)

    phase("5b: deepseek-v3 on the dequant path (absorbed, gathered view); reduced card vs CPU")
    toks = torch.as_tensor(np.stack(prompts), device=dev)
    l_int = apply_lm(params, arch, tokens=toks,
                     rt=Runtime(int_forward=True, mla_absorb=True))[0].float()
    l_deq = apply_lm(params, arch, tokens=toks, rt=Runtime(mla_absorb=True))[0].float()
    scale = l_deq.abs().max().item()
    diff = (l_int - l_deq).abs().max().item()
    eps = 2.0**-6 * scale  # two bf16 ulps at the top of the logit range
    print(f"prompt logits, int path vs dequant path: max |diff| {diff:.4g}, max |logit| "
          f"{scale:.4g}, bound {eps:.4g}; argmax agreement "
          f"{(l_int.argmax(-1) == l_deq.argmax(-1)).float().mean().item():.4f}", flush=True)
    if not (np.isfinite(diff) and diff <= eps):
        raise AssertionError(f"int path logits off the dequant path by {diff} > {eps}")
    del l_int, l_deq
    ref = PagedServeEngine(arch, params, rt=Runtime(mla_absorb=True), **kw)
    ref.generate(prompts[:1], max_new=2)
    ref.reset_stats()
    ref_outs = ref.generate(prompts, max_new=32)
    rtp = ref.throughput()
    print(f"dequant path: prefill {rtp['prefill_tok_s']:.2f} tok/s | decode "
          f"{rtp['decode_tok_s']:.2f} tok/s ({rtp['decode_dispatches']} ticks)", flush=True)
    ok, ties, detail = parity_up_to_ties(ref.last_requests, outs, eps)
    same = sum(a == b for a, b in zip(ref_outs, outs))
    marg = max(abs(a - b) for r, g in zip(ref.last_requests, engine.last_requests)
               for a, b in zip(r.margins, g.margins))
    print(f"served tokens, int path vs dequant path: parity_up_to_ties eps={eps:.4g}: ok={ok} "
          f"ties={ties} identical_requests={same}/{len(outs)}; max greedy-margin diff "
          f"{marg:.4g}", flush=True)
    if not ok:
        raise AssertionError(f"parity failed: {detail}")
    del engine, ref
    torch.cuda.empty_cache()
    phase("4d: deepseek-v3 (phase 4b's params) on --int-chain --kv-int8 [--kv-bits 4] "
          "--decode-kernel, mla_absorb")
    int_counts = serve_int(dev, arch, params, prompts, per_forward=per_forward, mla=True)
    phase("4m: deepseek-v3 (4b's mla_absorb, bf16 latent pools) on the megastep")
    mega_counts = serve_megastep(
        dev, arch, params, prompts, rt=rt, kv_bits=None,
        per_call={"int_matmul_cuda.launches": (per_forward, per_forward),
                  "paged_mla_attention_cuda.launches": (n_mla, 0),
                  "paged_mla_attention_cuda.tc_launches": (n_mla, 0)},
        names={"int_matmul": "int_matmul_cuda.launches",
               "int_matmul[tc]": "int_matmul_cuda.tc_launches",
               "paged_mla_attention": "paged_mla_attention_cuda.launches",
               "paged_mla_attention[tc]": "paged_mla_attention_cuda.tc_launches"})
    del params
    torch.cuda.empty_cache()
    small = reduced(get_arch("deepseek-v3-671b"))
    sp = deploy_params(init_lm(torch.Generator().manual_seed(0), small, device="cpu"), small.quant)
    small_prompts = [p[: 5 + 3 * i] % small.vocab for i, p in enumerate(prompts[:3])]
    skw = dict(batch=2, max_seq=32, block_size=4, prefill_chunk=4)
    cpu_e = PagedServeEngine(small, sp, device="cpu", rt=Runtime(
        int_forward=True, decode_kernel=True, mla_absorb=True), **skw)
    cpu_outs = cpu_e.generate(small_prompts, max_new=5)
    paged_mla_attention_cuda.launches = 0
    gpu_e = PagedServeEngine(small, tree_to(sp, dev), device=dev, rt=Runtime(
        int_forward=True, decode_kernel=True, mla_absorb=True), **skw)
    gpu_outs = gpu_e.generate(small_prompts, max_new=5)
    ok, ties, detail = parity_up_to_ties(cpu_e.last_requests, gpu_outs, 1e-4)
    marg = max(abs(a - b) for r, g in zip(cpu_e.last_requests, gpu_e.last_requests)
               for a, b in zip(r.margins, g.margins))
    print(f"reduced deepseek-v3 card vs CPU: tokens {gpu_outs} vs {cpu_outs}, ties {ties}, "
          f"max margin diff {marg:.3g}, {paged_mla_attention_cuda.launches} MLA kernel "
          f"launches on the card", flush=True)
    if not ok or ties or marg > 1e-4 or paged_mla_attention_cuda.launches == 0:
        raise AssertionError(f"card vs CPU disagree: {detail}, margin diff {marg}")
    return {"deepseek-v3": {**launches, **launches_deploy}, "deepseek-v3 int-chain": int_counts,
            "deepseek-v3 megastep": mega_counts}


def build_rwkv6(dev, arch) -> dict:
    """Full-width random A2Q params of ``arch``, each block drawn with the
    package's own initializer and deployed to int8 before the next is drawn,
    so no whole fp32 tree exists (one block's fp32 weights, ~0.8 GB, at a
    time)."""
    from repro_torch.nn.embedding import init_embedding
    from repro_torch.nn.linear import init_linear
    from repro_torch.nn.norms import init_norm
    from repro_torch.nn.transformer import _init_block
    from repro_torch.serve.engine import deploy_params

    q, d = arch.quant, arch.d_model
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {"embed": init_embedding(gen, arch.vocab, d), "stacks": {}}
    for i, s in enumerate(arch.stacks):
        layers = []
        for _ in range(s.count):
            layers.append(deploy_params(_init_block(gen, arch, s), q))
            torch.cuda.empty_cache()
        params["stacks"][str(i)] = _stack_layers(*layers)
        del layers
    params["final_norm"] = init_norm(d, arch.norm, device=dev)
    params["head"] = deploy_params(init_linear(gen, d, arch.vocab, q, boundary=True), q)
    return params


LONG_PROMPT, LONG_CHUNK, LONG_NEW = 4096, 1024, 8  # RWKV-6's training context (arXiv:2404.05892)


def chunk_host_ops(engine) -> list:
    """Wraps ``engine._prefill_fn`` so each prefill chunk's host-dispatched
    PyTorch operators are counted (as ``tick_ops`` counts a tick's); returns
    the list the counts go into."""
    counts, inner = [], engine._prefill_fn

    def counted(*args):
        with op_counter() as count:
            out = inner(*args)
        counts.append(count.n)
        return out

    engine._prefill_fn = counted
    return counts


def profile_prefill_chunk(engine, prompt) -> dict:
    """Device time of one prefill chunk (the second of the prompt's, past any
    first-call work) by kernel, from a torch.profiler trace: ``rwkv6_scan``
    (both kernels), ``int_matmul`` and the rest."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request

    inner, seen, dev_ms = engine._prefill_fn, [], {}

    def profiled(*args):
        seen.append(1)
        if len(seen) != 2:
            return inner(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = inner(*args)
            torch.cuda.synchronize()
        for name, ms in kernel_ms(prof).items():
            part = ("rwkv6_scan" if "rwkv6_" in name else
                    "int_matmul" if "int_matmul" in name else "rest")
            dev_ms[part] = dev_ms.get(part, 0.0) + ms
        return out

    engine._prefill_fn = profiled
    engine.submit(Request(uid=3000, prompt=prompt, max_new=2))
    while not engine.sched.idle():
        engine.step()
    engine._prefill_fn = inner
    return dev_ms


def serve_rwkv6_long(dev, arch, params) -> dict:
    """Phase 4e-long: the same deployed rwkv6-7b on ``--int-chain`` serves one
    4096-token prompt (seed 0) in prefill chunks of 1024 (four chunked-form
    calls a layer, each carrying the slot's state) and 8 new tokens.  Checks
    the launch counts (the prefill chunks' recurrences on the chunked
    kernel, the ticks' on the step kernel) and the outputs (in-vocab tokens,
    finite margins); prints prefill and decode tok/s, the host ops of one
    prefill chunk, and one profiled prefill chunk's device ms by kernel.
    Returns the run's launches by kernel variant."""
    from repro_torch.kernels.int_matmul import int_matmul_cuda
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda
    from repro_torch.models.lm import Runtime
    from repro_torch.serve.engine import PagedServeEngine

    phase(f"4e-long: rwkv6-7b serves one {LONG_PROMPT}-token prompt in prefill chunks of "
          f"{LONG_CHUNK} (--int-chain)")
    n = arch.n_layers
    per_forward = 7 * n + 1
    prompt = np.random.default_rng(0).integers(0, arch.vocab, (LONG_PROMPT,)).astype(np.int32)
    engine = PagedServeEngine(arch, params, rt=Runtime(int_chain=True), batch=1,
                              max_seq=LONG_PROMPT + LONG_NEW, block_size=16,
                              prefill_chunk=LONG_CHUNK, device=dev)
    engine.generate([prompt[:LONG_CHUNK]], max_new=2)  # warm-up
    engine.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops = chunk_host_ops(engine)
    int_matmul_cuda.launches = int_matmul_cuda.prologue_launches = 0
    int_matmul_cuda.requant_launches = int_matmul_cuda.tc_launches = 0
    rwkv6_scan_cuda.launches = rwkv6_scan_cuda.chunked_launches = 0
    outs = engine.generate([prompt], max_new=LONG_NEW)
    torch.cuda.synchronize()
    chunks = -(-LONG_PROMPT // LONG_CHUNK)
    tp = engine.throughput()
    ticks = tp["decode_dispatches"]
    forwards = chunks + ticks
    launches = {"int_matmul": int_matmul_cuda.launches,
                "int_matmul[prologue]": int_matmul_cuda.prologue_launches,
                "int_matmul[requant]": int_matmul_cuda.requant_launches,
                "rwkv6_scan": rwkv6_scan_cuda.launches,
                "rwkv6_scan[chunked]": rwkv6_scan_cuda.chunked_launches}
    want = {"int_matmul": per_forward * forwards,
            "int_matmul[prologue]": (per_forward - n) * forwards,
            "int_matmul[requant]": n * forwards, "rwkv6_scan": n * forwards,
            "rwkv6_scan[chunked]": n * chunks}
    tc = int_matmul_cuda.tc_launches
    req = engine.last_requests[0]
    print(f"[long prompt] prefill {tp['prefill_tokens']} tok in {tp['prefill_s']:.3f}s "
          f"({tp['prefill_tok_s']:.2f} tok/s) | decode {tp['decode_tokens']} tok in "
          f"{tp['decode_s']:.3f}s ({tp['decode_tok_s']:.2f} tok/s, {ticks} ticks) | peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB | launches {launches} (expected "
          f"{want}) | host ops a prefill chunk {ops} | tokens {outs[0]}", flush=True)
    if launches != want or ticks != LONG_NEW - 1 or len(outs[0]) != LONG_NEW or \
            not all(0 <= t < arch.vocab for t in outs[0]) or not np.isfinite(req.margins).all():
        raise AssertionError(f"long prompt: launches {launches} (expected {want}) over {ticks} "
                             f"ticks, tokens {outs[0]}, margins {req.margins}")
    dev_ms = profile_prefill_chunk(engine, prompt)
    total = sum(dev_ms.values())
    print(f"[long prompt] one profiled prefill chunk of {LONG_CHUNK} tokens: {total:.3f} ms of "
          f"kernels; " + ", ".join(f"{k} {v:.3f} ms ({v / max(total, 1e-9):.1%})"
                                   for k, v in sorted(dev_ms.items(), key=lambda kv: -kv[1])),
          flush=True)
    del engine
    torch.cuda.empty_cache()
    return {"int_matmul[requant]": launches["int_matmul[requant]"],
            "int_matmul[prologue]": launches["int_matmul[prologue]"],
            "int_matmul": launches["int_matmul"] - launches["int_matmul[prologue]"],  # int8 x in
            "int_matmul[tc]": tc,
            "rwkv6_scan": launches["rwkv6_scan"] - launches["rwkv6_scan[chunked]"],  # step kernel
            "rwkv6_scan[chunked]": launches["rwkv6_scan[chunked]"]}


def serve_rwkv6(dev) -> dict:
    """Phases 4e and 5e: full-width rwkv6-7b served on ``--int-chain`` (every
    deployed linear on int_matmul, cm.wk through the requant epilogue, every
    recurrence through rwkv6_scan), held against the unchained int-forward
    run (bitwise) and the dequant path (``parity_up_to_ties``); then reduced
    rwkv6 on the card against the CPU.  Returns the main run's launches by
    kernel variant."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.a2q_quantize import a2q_quantize_cuda
    from repro_torch.kernels.int_matmul import int_matmul_cuda
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda
    from repro_torch.models.lm import Runtime, apply_lm, init_lm
    from repro_torch.nn.module import tree_to
    from repro_torch.serve.engine import PagedServeEngine, deploy_params, parity_up_to_ties

    full = get_arch("rwkv6-7b")
    arch = dataclasses.replace(full, stacks=(dataclasses.replace(full.stacks[0],
                                                                 count=RWKV6_LAYERS),))
    phase(f"4e: serve full-width rwkv6-7b ({arch.n_layers} of {full.n_layers} layers) on "
          "--int-chain (requant epilogue, rwkv6_scan)")
    n = arch.n_layers
    per_forward = 7 * n + 1  # r, k, v, g, o, cm.wk, cm.wv a layer, and the untied head
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a2q_quantize_cuda.launches = 0
    with held_deploys(arch.name) as held:
        params = build_rwkv6(dev, arch)
    torch.cuda.synchronize()
    deploys = a2q_quantize_cuda.launches
    check_held(arch.name, held, deploys)
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"init + deploy of {arch.name} ({n} layers, d_model {arch.d_model}, d_ff "
          f"{arch.stacks[0].d_ff}, vocab {arch.vocab}): {time.perf_counter() - t0:.1f}s, "
          f"{n_params / 1e9:.3f} B params, {n_bytes / 1e9:.2f} GB on the card, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, {deploys} a2q_quantize launches",
          flush=True)
    if deploys != per_forward:
        raise AssertionError(f"{deploys} a2q_quantize launches at deploy, expected {per_forward}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.vocab, (64,)).astype(np.int32) for _ in range(8)]
    kw = dict(batch=8, max_seq=96, block_size=16, prefill_chunk=32, device=dev)
    chunks = sum(-(-len(p) // 32) for p in prompts)

    def run(tag, **rt):
        engine = PagedServeEngine(arch, params, rt=Runtime(**rt), **kw)
        engine.generate(prompts[:1], max_new=2)  # warm-up
        engine.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        int_matmul_cuda.launches = int_matmul_cuda.requant_launches = 0
        int_matmul_cuda.prologue_launches = rwkv6_scan_cuda.launches = 0
        int_matmul_cuda.tc_launches = rwkv6_scan_cuda.chunked_launches = 0
        outs = engine.generate(prompts, max_new=32)
        torch.cuda.synchronize()
        launches = {"int_matmul": int_matmul_cuda.launches,
                    "int_matmul[prologue]": int_matmul_cuda.prologue_launches,
                    "int_matmul[requant]": int_matmul_cuda.requant_launches,
                    "rwkv6_scan": rwkv6_scan_cuda.launches,
                    "rwkv6_scan[chunked]": rwkv6_scan_cuda.chunked_launches}
        tc = int_matmul_cuda.tc_launches
        tp = engine.throughput()
        print(f"[{tag}] prefill {tp['prefill_tokens']} tok in {tp['prefill_s']:.3f}s "
              f"({tp['prefill_tok_s']:.2f} tok/s) | decode {tp['decode_tokens']} tok in "
              f"{tp['decode_s']:.3f}s ({tp['decode_tok_s']:.2f} tok/s, {tp['decode_dispatches']} "
              f"ticks) | peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB | "
              f"launches {launches} | chain report: {tp.get('int_chain_folded')} folded, "
              f"{tp.get('int_chain_chained')} chained, {tp.get('int_chain_requant_dispatches')} "
              f"standalone, {tp.get('int_chain_fallback')} fallback", flush=True)
        for r, o in zip(engine.last_requests, outs):
            if len(o) != 32 or not all(0 <= t < arch.vocab for t in o) or \
                    not np.isfinite(r.margins).all():
                raise AssertionError(f"[{tag}] bad output: {o} margins {r.margins}")
        return engine, outs, launches, tp, tc

    main, outs, launches, tp, tc = run("int-chain (main path)", int_chain=True)
    ticks = tp["decode_dispatches"]
    forwards = ticks + chunks
    if launches != {"int_matmul": per_forward * forwards,
                    "int_matmul[prologue]": (per_forward - n) * forwards,
                    "int_matmul[requant]": n * forwards, "rwkv6_scan": n * forwards,
                    "rwkv6_scan[chunked]": n * chunks} or \
            ticks < 31 or \
            (tp["int_chain_folded"], tp["int_chain_chained"],
             tp["int_chain_requant_dispatches"], tp["int_chain_fallback"]) != (per_forward, n, 0, 0):
        raise AssertionError(f"launches {launches} over {forwards} forwards, chain report {tp}: "
                             f"expected {per_forward} int_matmul ({per_forward - n} prologue, {n} "
                             f"requant) and {n} rwkv6_scan a forward (the prefill chunks' on the "
                             f"chunked kernel), {per_forward} folded / {n} chained / 0 standalone")
    cache = main.cache
    print(f"launches on the main path: {launches} over {ticks} decode ticks and {chunks} prefill "
          f"chunks = {per_forward} int_matmul ({n} requant) and {n} rwkv6_scan a forward (the "
          f"prefill chunks' {n * chunks} on the chunked kernel, the ticks' on the step kernel); "
          f"{cache.kv_bytes_per_token()} KV bytes/token, {cache.state_bytes_per_slot()} recurrent "
          f"state bytes a slot ({4 * n * cache.pools['0']['tm']['S'][0, 0].numel()} of them the "
          f"fp32 state)", flush=True)
    print(f"req 0 tokens: {outs[0]}", flush=True)
    print(f"host ops per decode tick (int-chain): {tick_ops(main, prompts)}", flush=True)
    profile_decode(main, prompts)
    # chaining is a pure dispatch fusion: the unchained run on the same weights
    toks = torch.as_tensor(np.stack(prompts), device=dev)
    l_c = apply_lm(params, arch, tokens=toks, rt=Runtime(int_chain=True))[0].float()
    l_u = apply_lm(params, arch, tokens=toks, rt=Runtime(int_forward=True))[0].float()
    unchained, outs_u, _, _, _ = run("unchained int-forward", int_forward=True)
    same_margins = [r.margins for r in unchained.last_requests] == \
        [r.margins for r in main.last_requests]
    print(f"chained vs unchained: prompt logits bitwise equal {torch.equal(l_c, l_u)}, tokens "
          f"identical {outs_u == outs}, margins identical {same_margins}", flush=True)
    if not torch.equal(l_c, l_u) or outs_u != outs or not same_margins:
        raise AssertionError("rwkv6-7b: chained and unchained runs differ")
    del unchained, l_u
    long_counts = serve_rwkv6_long(dev, arch, params)

    phase("5e: rwkv6-7b on the dequant path; reduced rwkv6 card vs CPU")
    l_deq = apply_lm(params, arch, tokens=toks)[0].float()
    scale = l_deq.abs().max().item()
    diff = (l_c - l_deq).abs().max().item()
    eps = 2.0**-6 * scale  # two bf16 ulps at the top of the logit range
    print(f"prompt logits, int-chain path vs dequant path: max |diff| {diff:.4g}, max |logit| "
          f"{scale:.4g}, bound {eps:.4g}; argmax agreement "
          f"{(l_c.argmax(-1) == l_deq.argmax(-1)).float().mean().item():.4f}", flush=True)
    if not (np.isfinite(diff) and diff <= eps):
        raise AssertionError(f"int-chain logits off the dequant path by {diff} > {eps}")
    del l_c, l_deq
    ref, ref_outs, _, _, _ = run("dequant path")
    ok, ties, detail = parity_up_to_ties(ref.last_requests, outs, eps)
    same = sum(a == b for a, b in zip(ref_outs, outs))
    print(f"served tokens, int-chain vs dequant path: parity_up_to_ties eps={eps:.4g}: ok={ok} "
          f"ties={ties} identical_requests={same}/{len(outs)}", flush=True)
    if not ok:
        raise AssertionError(f"parity failed: {detail}")
    del main, ref
    torch.cuda.empty_cache()
    phase("4m: rwkv6-7b (4e's --int-chain) on the megastep")
    mega_counts = serve_megastep(
        dev, arch, params, prompts, rt=Runtime(int_chain=True), kv_bits=None,
        per_call={"int_matmul_cuda.launches": (per_forward, per_forward),
                  "int_matmul_cuda.prologue_launches": (per_forward - n, per_forward - n),
                  "int_matmul_cuda.requant_launches": (n, n),
                  "rwkv6_scan_cuda.launches": (n, n), "rwkv6_scan_cuda.chunked_launches": (0, n)},
        names={"int_matmul[requant]": "int_matmul_cuda.requant_launches",
               "int_matmul[prologue]": "int_matmul_cuda.prologue_launches",
               "int_matmul": ("int_matmul_cuda.launches", "int_matmul_cuda.prologue_launches"),
               "int_matmul[tc]": "int_matmul_cuda.tc_launches",
               "rwkv6_scan": ("rwkv6_scan_cuda.launches", "rwkv6_scan_cuda.chunked_launches"),
               "rwkv6_scan[chunked]": "rwkv6_scan_cuda.chunked_launches"})
    del params
    torch.cuda.empty_cache()
    small = reduced(arch)
    sp = deploy_params(init_lm(torch.Generator().manual_seed(0), small, device="cpu"), small.quant)
    small_prompts = [p[: 5 + 3 * i] % small.vocab for i, p in enumerate(prompts[:3])]
    skw = dict(batch=2, max_seq=32, block_size=4, prefill_chunk=8, rt=Runtime(int_chain=True))
    cpu_e = PagedServeEngine(small, sp, device="cpu", **skw)
    cpu_outs = cpu_e.generate(small_prompts, max_new=5)
    rwkv6_scan_cuda.launches = int_matmul_cuda.requant_launches = 0
    gpu_e = PagedServeEngine(small, tree_to(sp, dev), device=dev, **skw)
    gpu_outs = gpu_e.generate(small_prompts, max_new=5)
    ok, ties, detail = parity_up_to_ties(cpu_e.last_requests, gpu_outs, 1e-4)
    marg = max(abs(a - b) for r, g in zip(cpu_e.last_requests, gpu_e.last_requests)
               for a, b in zip(r.margins, g.margins))
    print(f"reduced rwkv6-7b card vs CPU (prefill chunks of 8 = the chunk: chunked and "
          f"sequential forms): tokens {gpu_outs} vs {cpu_outs}, ties {ties}, max margin diff "
          f"{marg:.3g}, {rwkv6_scan_cuda.launches} rwkv6_scan and "
          f"{int_matmul_cuda.requant_launches} requant launches on the card", flush=True)
    if not ok or ties or marg > 1e-4 or not rwkv6_scan_cuda.launches or \
            not int_matmul_cuda.requant_launches:
        raise AssertionError(f"card vs CPU disagree: {detail}, margin diff {marg}")
    return {"rwkv6-7b int-chain": {
        "a2q_quantize": deploys,
        "a2q_quantize[flips]": held["flips"],
        "int_matmul[requant]": launches["int_matmul[requant]"],
        "int_matmul[prologue]": launches["int_matmul[prologue]"],
        "int_matmul": launches["int_matmul"] - launches["int_matmul[prologue]"],  # int8 x in
        "int_matmul[tc]": tc,
        "rwkv6_scan": launches["rwkv6_scan"] - launches["rwkv6_scan[chunked]"],  # step kernel
        "rwkv6_scan[chunked]": launches["rwkv6_scan[chunked]"]},
        "rwkv6-7b long prompt": long_counts, "rwkv6-7b megastep": mega_counts}


# phase 4p: phase 4's prompts and budget, 2 requests of its 8, smollm-135m's depth cut
# from 30 layers to 4 (the contiguous engine prefills a token a forward, 0.1-0.15 s
# a forward at full depth; PERF.md section 4)
CONTIG_PROMPTS, CONTIG_PROMPT_LEN, CONTIG_NEW, CONTIG_LAYERS = 2, 64, 32, 4


def contig_tick_ops(engine, prompt) -> int:
    """Host-dispatched PyTorch operators in one tick of a contiguous
    ``ServeEngine`` (a request admitted and prefilled token by token first,
    then drained)."""
    from repro_torch.serve.engine import Request

    engine.admit(Request(uid=3000, prompt=prompt, max_new=3))
    with op_counter() as count:
        engine.tick()
    while engine.tick():
        pass
    return count.n


def launcher(argv: list, entry: str = "serve", **patch):
    """``repro_torch.launch.<entry>`` run in this process on ``argv`` (its
    ``run``: the report, the outputs and the engines); ``patch`` replaces
    names for the call wherever the launcher's module, or for
    ``serve_cluster`` the replica module, defines them (a depth-cut config
    behind ``get_arch``, a shared param draw behind ``init_params``, a
    spawned replica's main)."""
    import importlib
    from unittest import mock

    mods = [importlib.import_module(f"repro_torch.launch.{entry}")]
    if entry == "serve_cluster":
        mods.append(importlib.import_module("repro_torch.serve.cluster.replica"))
    with contextlib.ExitStack() as stack:
        for name, value in patch.items():
            owners = [m for m in mods if hasattr(m, name)]
            if not owners:
                raise AttributeError(f"no module of launch.{entry} defines {name}")
            for m in owners:
                stack.enter_context(mock.patch.object(m, name, value))
        return mods[0].run(argv)


def on_card(*trees) -> bool:
    """Every tensor leaf of ``trees`` (an engine's params, its cache or
    pools) is a CUDA tensor."""
    return all(t.is_cuda for tree in trees for t in _leaves(tree))


def serve_contiguous(dev) -> dict:
    """Phase 4p: the contiguous ``ServeEngine`` and the reference's parity
    gate, through ``launch/serve.py --paged --parity-check`` on smollm-135m
    at full width with its depth cut to ``CONTIG_LAYERS`` (2 requests of 64
    prompt tokens, 32 new, batch 8): with
    ``--deploy-int8`` the contiguous dequant engine against the paged one,
    token for token; with ``--int-forward --kv-int8`` the paged int path
    (int_matmul, int8 KV) against the contiguous float path under
    ``parity_up_to_ties`` at eps 0.05, the sub-margin ties printed; then the
    contiguous engine on ``--int-chain`` (no ``--paged``; 1 request, 8
    new) on int_matmul's prologue.  Every launcher run deploys through
    ``a2q_quantize``, held to the plain quantizer.  Prints both engines'
    prefill and decode tok/s and the host ops of a contiguous tick; checks
    that the contiguous engines ran on the card.  Returns the phase's
    launches by kernel entry."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.a2q_quantize import a2q_quantize_cuda
    from repro_torch.kernels.int_matmul import int_matmul_cuda

    full = get_arch("smollm-135m")
    arch = dataclasses.replace(full, stacks=(dataclasses.replace(full.stacks[0],
                                                                 count=CONTIG_LAYERS),))
    phase(f"4p: the contiguous ServeEngine and --parity-check on smollm-135m at full width, "
          f"{arch.n_layers} of its {full.n_layers} layers")
    t_phase = time.perf_counter()
    base = ["--arch", arch.name, "--device", str(dev), "--requests", str(CONTIG_PROMPTS),
            "--prompt-len", str(CONTIG_PROMPT_LEN), "--max-new", str(CONTIG_NEW), "--batch", "8",
            "--max-seq", "96", "--block-size", "16", "--prefill-chunk", "32"]
    n = 7 * arch.n_layers
    torch.cuda.synchronize()
    a2q_quantize_cuda.launches = int_matmul_cuda.launches = 0
    int_matmul_cuda.prologue_launches = int_matmul_cuda.tc_launches = 0
    flips, deploys, expect, expect_prologue = 0, 0, 0, 0
    runs = (("--deploy-int8", ["--paged", "--parity-check", "--deploy-int8"]),
            ("--int-forward --kv-int8", ["--paged", "--parity-check", "--int-forward",
                                         "--kv-int8"]),
            ("contiguous --int-chain", ["--int-chain"]))
    for tag, flags in runs:
        argv = base + flags
        if tag.startswith("contiguous"):  # a shorter run: per-token prefill is the slow part
            argv[argv.index("--requests") + 1], argv[argv.index("--max-new") + 1] = "1", "8"
        t0 = time.perf_counter()
        with held_deploys(f"4p {tag}") as held:
            out = launcher(argv, get_arch=lambda name: arch)
        torch.cuda.synchronize()
        flips += held["flips"]
        deploys += held["matrices"]
        rep, engines = out["report"], out["engines"]
        contig = engines["contiguous"]
        # an --int-forward run ends in the launcher's headroom probe: one
        # eager forward of 8 tokens on the served engine's runtime
        probe = n if "headroom" in rep else 0
        if not on_card(contig.params, contig.cache):
            raise AssertionError(f"[4p {tag}] the contiguous engine did not run on the card")
        ctp = contig.throughput()
        line = (f"[4p {tag}] {time.perf_counter() - t0:.1f} s; contiguous: prefill "
                f"{ctp['prefill_tok_s']:.2f} tok/s, decode {ctp['decode_tok_s']:.2f} tok/s")
        if "paged" in engines:
            ptp = engines["paged"].throughput()
            chunks = sum(-(-CONTIG_PROMPT_LEN // 32) for _ in range(CONTIG_PROMPTS))
            if rep["int_forward"]:
                expect += n * (ptp["decode_dispatches"] + chunks) + probe
            line += (f"; paged: prefill {ptp['prefill_tok_s']:.2f} tok/s, decode "
                     f"{ptp['decode_tok_s']:.2f} tok/s")
            if "parity_sub_margin_ties" in rep:
                line += (f"; parity_up_to_ties eps {rep['parity_eps']}: "
                         f"{rep['parity_sub_margin_ties']} sub-margin ties")
            else:
                line += "; tokens identical across engines (exact parity)"
        else:
            expect_prologue += n * (ctp["prefill_tokens"] + ctp["decode_dispatches"]) + probe
            counted = ops.launch_counts()  # the op count's own launches are not the path's
            line += (f"; host ops a contiguous tick {contig_tick_ops(contig, out['outs'][0][:4])}"
                     f" (int-chain)")
            ops.set_launch_counts(counted)
        for r, o in zip(contig.last_requests, out["outs"]):
            if len(o) != int(argv[argv.index("--max-new") + 1]) or \
                    not all(0 <= t < arch.vocab for t in o) or not np.isfinite(r.margins).all():
                raise AssertionError(f"[4p {tag}] bad output {o}")
        print(line, flush=True)
        del out, engines, contig
        torch.cuda.empty_cache()
    launches = {"int_matmul": int_matmul_cuda.launches - int_matmul_cuda.prologue_launches,
                "int_matmul[prologue]": int_matmul_cuda.prologue_launches,
                "int_matmul[tc]": int_matmul_cuda.tc_launches,
                "a2q_quantize": a2q_quantize_cuda.launches, "a2q_quantize[flips]": flips}
    check_held("4p", {"matrices": deploys}, a2q_quantize_cuda.launches)
    print(f"[4p] launches {launches}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    if launches["int_matmul"] != expect or launches["int_matmul[prologue]"] != expect_prologue \
            or not 0 < launches["int_matmul[tc]"] < expect or deploys != 3 * n:
        raise AssertionError(f"[4p] launches {launches}: expected {expect} int_matmul on the "
                             f"paged int side, {expect_prologue} prologue launches on the "
                             f"contiguous int-chain run, {3 * n} deploys")
    return {"smollm-135m contiguous": launches}


# phase 4r (PERF.md section 4): yi-6b at full width, its depth cut from 32 layers to 4,
# served by routed and disaggregated fleets through launch/serve_cluster.py
CLUSTER_LAYERS = 2
CLUSTER_ARGS = ["--requests", "16", "--prompt-len", "64", "--long-every", "4", "--max-new", "32",
                "--batch", "8", "--max-seq", "256", "--block-size", "16", "--prefill-chunk", "32",
                "--int-forward", "--parity-check"]
CLUSTER_RUNS = (("1:1 bf16", ["--disagg", "1:1"]),
                ("2:2 int8 fault", ["--disagg", "2:2", "--kv-int8", "--fault-rate", "0.25"]),
                ("1:2 int4 megastep", ["--disagg", "1:2", "--kv-int8", "--kv-bits", "4",
                                       "--decode-steps", "8", "--policy", "weighted-latency"]))
# one prefill chunk a prompt (the longest is 194 tokens): a spawned child's
# prefill forwards are the requests dispatched to it
CLUSTER_SPAWN = ["--arch", "smollm-135m", "--transport", "subproc", "--replicas", "2",
                 "--requests", "4", "--max-new", "16", "--int-forward", "--parity-check",
                 "--prompt-len", "64", "--batch", "8", "--max-seq", "256",
                 "--prefill-chunk", "256"]


def held_replica_main(cfg, conn) -> None:
    """A spawned cluster replica (``replica._replica_main``) whose deploys are
    held to the plain quantizer in its own process (``held_deploys``: a
    flip it cannot explain kills the child before its hello); the held
    counts ride in its stats events under ``held``.  Defined at module
    level, so a spawn child of this script can unpickle it."""
    from repro_torch.serve.cluster import replica

    with held_deploys(f"4r spawn {cfg.name}") as held:
        replica._replica_main(cfg, conn, stats_extra={"held": held})


def engine_forwards(engine, prompts, chunk: int) -> int:
    """Forwards an engine ran: its prefill chunks (``prompts`` are the ones
    it prefilled) and one a tick, or ``decode_steps`` a window replayed and
    the capture's eager warm-up window."""
    chunks = sum(-(-len(p) // chunk) for p in prompts)
    if engine.decode_steps > 1:
        return chunks + engine.decode_steps * (engine.stats["graph_replays"] + engine._captures)
    return chunks + engine.stats["decode_dispatches"]


def serve_cluster(dev, smi: str) -> dict:
    """Phase 4r: the serving cluster through ``launch/serve_cluster.py`` in
    this process, on yi-6b at full width with its depth cut to
    ``CLUSTER_LAYERS`` (``CLUSTER_ARGS``: 16 requests, prompts of 64 and
    every fourth 192 tokens, 32 new, batch 8, ``--int-forward
    --parity-check``), three fleets sharing one raw param draw: ``--disagg
    1:1`` (bf16 blocks migrate; token-identical to the single engine),
    ``--disagg 2:2 --kv-int8 --fault-rate 0.25`` (int8 blocks; one replica
    killed a quarter into the wave: one death, requeues, every stream
    emitted once; ``parity_up_to_ties`` at eps 0.05) and ``--disagg 1:2
    --kv-int8 --kv-bits 4 --decode-steps 8 --policy weighted-latency``
    (int4 blocks imported into megastep engines whose CUDA graphs hold the
    pools: one capture a decode replica, replays).  Every deploy held to
    the plain quantizer; the int_matmul and a2q_quantize launches against
    the count the engines' stats imply; migration bytes in equal to bytes
    out (plus the blocks a death made a decode replica import again), each
    engine's bytes a block token equal to ``kv_bytes_per_token()``.  Then
    the spawn transport: smollm-135m at full size on two spawned replicas
    (``CLUSTER_SPAWN``), token-identical, no death, both dispatched to;
    each child's deploys held in its own process, its launches read from
    its stats event and checked against its engine stats.  Returns the
    launches by path."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.a2q_quantize import a2q_quantize_cuda
    from repro_torch.kernels.int_matmul import int_matmul_cuda
    from repro_torch.serve.cluster import replica

    full = get_arch("yi-6b")
    arch = dataclasses.replace(full, stacks=(dataclasses.replace(full.stacks[0],
                                                                 count=CLUSTER_LAYERS),))
    phase(f"4r: the serving cluster on yi-6b at full width, {arch.n_layers} of its "
          f"{full.n_layers} layers: routed and disaggregated fleets, failover, int8/int4 "
          "block migration, megastep decode replicas; the spawn transport on smollm-135m")
    t_phase = time.perf_counter()
    drawn, draw = {}, replica.init_params

    def shared_params(cfg, a):  # one seeded draw for the phase's three fleets
        if "params" not in drawn:
            drawn["params"] = draw(cfg, a)
        return drawn["params"]

    per_forward = 7 * arch.n_layers + 1  # seven linears a layer and the untied head
    chunk = int(CLUSTER_ARGS[CLUSTER_ARGS.index("--prefill-chunk") + 1])
    max_new = int(CLUSTER_ARGS[CLUSTER_ARGS.index("--max-new") + 1])
    torch.cuda.synchronize()
    a2q_quantize_cuda.launches = int_matmul_cuda.launches = 0
    int_matmul_cuda.prologue_launches = int_matmul_cuda.tc_launches = 0
    flips, deploys, forwards, prefill_chunks, runs = 0, 0, 0, 0, {}
    for tag, flags in CLUSTER_RUNS:
        t0 = time.perf_counter()
        before = int_matmul_cuda.launches
        with held_deploys(f"4r {tag}") as held:
            out = launcher(["--arch", arch.name, "--device", str(dev), *CLUSTER_ARGS, *flags],
                           "serve_cluster", get_arch=lambda name: arch,
                           init_params=shared_params)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        flips += held["flips"]
        deploys += held["matrices"]
        rep, router, prompts = out["report"], out["router"], out["prompts"]
        engines = dict(out["engines"], single=out["single"])
        fleet = out["engines"]
        if not all(on_card(e.params, e.cache.pools) for e in engines.values()):
            raise AssertionError(f"[4r {tag}] an engine's params or pools are off the card")
        if rep["completed"] != len(prompts) or rep.get("parity") is not True or \
                any(len(o) != max_new or not all(0 <= t < arch.vocab for t in o)
                    for o in out["outs"]):
            raise AssertionError(f"[4r {tag}] incomplete or bad streams: {rep['completed']} done")
        if len(engines) * per_forward != held["matrices"]:
            raise AssertionError(f"[4r {tag}] {held['matrices']} deployed matrices for "
                                 f"{len(engines)} engines of {per_forward}")
        # each prompt prefilled once by the fleet (a death never repeats a
        # prefill) and once by the parity engine
        fleet_prefilled = sum(e.stats["prefill_tokens"] for e in fleet.values())
        if fleet_prefilled != sum(len(p) for p in prompts):
            raise AssertionError(f"[4r {tag}] the fleet prefilled {fleet_prefilled} tokens")
        # the prefill replicas together prefilled every prompt once, the
        # parity engine every prompt again
        run_forwards = {n: engine_forwards(e, prompts if n == "single" else [], chunk)
                        for n, e in engines.items()}
        run_forwards["prefill replicas"] = sum(-(-len(p) // chunk) for p in prompts)
        if int_matmul_cuda.launches - before != per_forward * sum(run_forwards.values()):
            raise AssertionError(f"[4r {tag}] {int_matmul_cuda.launches - before} int_matmul "
                                 f"launches, expected {per_forward} a forward of {run_forwards}")
        forwards += sum(run_forwards.values())
        prefill_chunks += 2 * sum(-(-len(p) // chunk) for p in prompts)
        # migration: bytes in == bytes out, plus what a death made a decode
        # replica import again (its adopted, unfinished requests)
        again = 0
        for st in router.states.values():
            if not st.alive:
                rep_ = st.handle.replica
                bs = rep_.engine.cache.block_size
                again += sum(-(-len(r.prompt) // bs) * bs * rep_.engine.cache.kv_bytes_per_token()
                             for r, _ in rep_._track.values() if r.prefilled)
        b_out = sum(e.cache.migration_bytes_out for e in fleet.values())
        b_in = sum(e.cache.migration_bytes_in for e in fleet.values())
        blocks = sum(e.cache.migrated_blocks_out for e in fleet.values())
        if not b_out > 0 or b_in != b_out + again:
            raise AssertionError(f"[4r {tag}] migration bytes in {b_in} != out {b_out} + "
                                 f"{again} imported again")
        for n, e in fleet.items():
            c = e.cache
            per_tok = c.block_size * c.kv_bytes_per_token()
            if c.migration_bytes_out != c.migrated_blocks_out * per_tok or \
                    c.migration_bytes_in != c.migrated_blocks_in * per_tok:
                raise AssertionError(f"[4r {tag}] {n}: migration bytes off "
                                     f"{c.kv_bytes_per_token()} bytes a token")
        tok_s = {n: (round(e.throughput()["prefill_tok_s"], 1),
                     round(e.throughput()["decode_tok_s"], 1)) for n, e in engines.items()}
        line = (f"[4r {tag}] {smi}; {seconds:.1f} s; fleet {rep['total_tokens']} tokens, "
                f"capacity {rep['agg_tok_s']:.1f} tok/s (busiest replica busy "
                f"{rep['makespan_s']:.3f} s); dispatched {rep['dispatched']}; latency p50 "
                f"{rep['latency']['p50_latency_s']:.3f} s p99 {rep['latency']['p99_latency_s']:.3f}"
                f" s, ttft p50 {rep['latency']['p50_ttft_s']:.3f} s p99 "
                f"{rep['latency']['p99_ttft_s']:.3f} s; migrated {blocks} blocks, {b_out} bytes "
                f"out, {b_in} in ({again} imported again), "
                f"{fleet['d0'].cache.kv_bytes_per_token()} KV bytes a token; tok/s by engine "
                f"(prefill, decode) {tok_s}")
        if "parity_sub_margin_ties" in rep:
            line += f"; parity_up_to_ties eps 0.05: {rep['parity_sub_margin_ties']} sub-margin ties"
        else:
            line += "; tokens identical to the single engine (exact parity)"
        if "fault" in tag:
            line += f"; killed {rep['killed']}, deaths {rep['deaths']}, requeues {rep['requeues']}"
            if rep["deaths"] != 1 or rep["requeues"] <= 0:
                raise AssertionError(f"[4r {tag}] deaths {rep['deaths']}, requeues "
                                     f"{rep['requeues']}")
        if "megastep" in tag:
            graphs = {n: (e._captures, e.stats["graph_replays"]) for n, e in engines.items()
                      if not n.startswith("p")}
            line += f"; decode graphs (captures, replays) {graphs}"
            if any(c != 1 or r <= 0 for c, r in graphs.values()):
                raise AssertionError(f"[4r {tag}] graph captures and replays {graphs}")
        print(line, flush=True)
        runs[tag] = {"report": rep, "seconds": seconds, "bytes_out": b_out, "bytes_in": b_in}
        del out, engines, fleet, router
        torch.cuda.empty_cache()
    drawn.clear()
    torch.cuda.empty_cache()
    launches = {"int_matmul": int_matmul_cuda.launches - int_matmul_cuda.prologue_launches,
                "int_matmul[prologue]": int_matmul_cuda.prologue_launches,
                "int_matmul[tc]": int_matmul_cuda.tc_launches,
                "a2q_quantize": a2q_quantize_cuda.launches, "a2q_quantize[flips]": flips}
    check_held("4r", {"matrices": deploys}, a2q_quantize_cuda.launches)
    print(f"[4r] launches {launches}", flush=True)
    if launches["int_matmul"] != per_forward * forwards or launches["int_matmul[prologue]"] or \
            not 0 < launches["int_matmul[tc]"] <= per_forward * prefill_chunks:
        raise AssertionError(f"[4r] launches {launches}: expected {per_forward * forwards} "
                             f"int_matmul ({forwards} forwards of {per_forward}), the tensor-core "
                             f"ones within {prefill_chunks} prefill chunks")
    by_path = {"yi-6b cluster": launches}

    # the spawn transport: each child builds its engine, its deploys held in
    # its own process (held_replica_main), and loads the kernels phase 2
    # built; its stats event brings back its launch and held counts, checked
    # against its own engine stats by the in-process fleets' rule
    t0 = time.perf_counter()
    a2q_quantize_cuda.launches = int_matmul_cuda.launches = 0
    int_matmul_cuda.prologue_launches = int_matmul_cuda.tc_launches = 0
    with held_deploys("4r spawn parity engine") as held:
        out = launcher([*CLUSTER_SPAWN, "--device", str(dev)], "serve_cluster",
                       _replica_main=held_replica_main)
    torch.cuda.synchronize()
    rep, sm = out["report"], out["single"]
    if rep.get("parity") is not True or rep["deaths"] != 0 or rep["completed"] != 4 or \
            out["engines"] or not on_card(sm.params, sm.cache.pools):
        raise AssertionError(f"[4r spawn] {rep}")
    per_forward = 7 * sm.arch.n_layers  # smollm-135m's head is tied: seven linears a layer
    children = {}
    for name, st in out["router"].states.items():
        ev, n = st.stats, st.dispatched
        c, tp = ev["launches"], ev["throughput"]
        got = {"int_matmul": c["int_matmul_cuda.launches"] - c["int_matmul_cuda.prologue_launches"],
               "int_matmul[prologue]": c["int_matmul_cuda.prologue_launches"],
               "int_matmul[tc]": c["int_matmul_cuda.tc_launches"],
               "a2q_quantize": c["a2q_quantize_cuda.launches"],
               "a2q_quantize[flips]": ev["held"]["flips"]}
        want = per_forward * (n + tp["decode_dispatches"])  # one prefill chunk a request
        children[name] = got
        if n <= 0 or ev["served"] != n or got["int_matmul"] != want or \
                got["int_matmul[prologue]"] or not 0 < got["int_matmul[tc]"] <= per_forward * n \
                or ev["held"]["matrices"] != got["a2q_quantize"] or \
                got["a2q_quantize"] != per_forward:
            raise AssertionError(f"[4r spawn] child {name}: dispatched {n}, served "
                                 f"{ev['served']}, {tp['decode_dispatches']} decode dispatches, "
                                 f"launches {got}, held {ev['held']}; expected {want} int_matmul "
                                 f"and {per_forward} held deploys")
    fleet = {k: sum(g[k] for g in children.values()) for k in children[name]}
    prefilled = sum(st.stats["throughput"]["prefill_tokens"] for st in out["router"].states.values())
    if prefilled != sum(len(p) for p in out["prompts"]):
        raise AssertionError(f"[4r spawn] the children prefilled {prefilled} tokens")
    parity = {"int_matmul": int_matmul_cuda.launches, "int_matmul[tc]": int_matmul_cuda.tc_launches,
              "a2q_quantize": a2q_quantize_cuda.launches, "a2q_quantize[flips]": held["flips"]}
    check_held("4r spawn parity engine", held, a2q_quantize_cuda.launches)
    want = per_forward * engine_forwards(sm, out["prompts"], 256)
    if parity["int_matmul"] != want or int_matmul_cuda.prologue_launches:
        raise AssertionError(f"[4r spawn] parity engine launches {parity}, expected {want} "
                             "int_matmul")
    lat = rep["latency"]
    print(f"[4r spawn] {smi}; {time.perf_counter() - t0:.1f} s; smollm-135m on 2 spawned "
          f"replicas: tokens identical to the parent's single engine, deaths 0, dispatched "
          f"{rep['dispatched']}, capacity {rep['agg_tok_s']:.1f} tok/s (busiest replica busy "
          f"{rep['makespan_s']:.3f} s), latency p50 {lat['p50_latency_s']:.3f} s p99 "
          f"{lat['p99_latency_s']:.3f} s, ttft p50 {lat['p50_ttft_s']:.3f} s p99 "
          f"{lat['p99_ttft_s']:.3f} s; the children's launches (their stats events) "
          f"{children}; the parent's parity engine {parity}", flush=True)
    by_path["smollm-135m spawned fleet"] = fleet
    by_path["smollm-135m spawned fleet's parity engine"] = parity
    print(f"[4r] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return by_path


H2O_REQUESTS, H2O_NEW, H2O_CHUNK = 4, 64, 256  # phase 4h (PERF.md section 4)
H2O_PROMPTS = (4100, 4300)  # prompt lengths drawn in this range: past the 4096-token window
H2O_CUT_LAYERS, H2O_CUT_PROMPT, H2O_CUT_NEW = 2, 4128, 16  # the contiguous check's cut


def serve_h2o(dev) -> dict:
    """Phase 4h: h2o-danube-1.8b at full width (d_model 2560, 32 heads over 8
    KV heads of 80, window 4096, vocab 32000) cut to ``H2O_LAYERS`` of its 24
    layers, random A2Q weights from seed 0 deployed through ``a2q_quantize``
    (every matrix held to the plain quantizer), served on the paged engine with
    ``Runtime(int_chain=True, decode_kernel=True)``: 4 requests over 4
    slots, prompts of 4,100-4,300 tokens in prefill chunks of 256 (the ring
    wraps in prefill and again in decode), 64 new tokens; per tick, then on
    the megastep (``decode_steps=8``) on the same params and batches, tokens
    and margins bit for bit, then the EOS rerun.  Ring layers take
    ``_sdpa``, as in the reference: no ``paged_attention`` launch.  Then the
    contiguous check: the same widths cut to 2 layers, one 4,128-token
    prompt and 16 new tokens through ``launch/serve.py --paged
    --parity-check --deploy-int8`` (the paged engine's ring against the
    contiguous ``ServeEngine``'s, past the window).  Returns the launches by
    kernel entry."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.engine import deploy_params

    full = get_arch("h2o-danube-1.8b")
    arch = dataclasses.replace(full, stacks=(dataclasses.replace(full.stacks[0],
                                                                 count=H2O_LAYERS),))
    a = arch.stacks[0].attn
    phase(f"4h: h2o-danube-1.8b full width ({arch.n_layers} of {full.n_layers} layers, d_model "
          f"{arch.d_model}, "
          f"window {a.window}) on --int-chain --decode-kernel, prompts past the window; "
          f"{H2O_REQUESTS} requests, {H2O_NEW} new tokens")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, deployed = deploy_held(arch.name, lambda: deploy_params(
        init_lm(torch.Generator(device=dev).manual_seed(0), arch, device=dev), arch.quant))
    per_forward = 7 * arch.n_layers + 1  # the untied head too
    if deployed["a2q_quantize"] != per_forward:
        raise AssertionError(f"{deployed} deploys, expected {per_forward}")
    rng = np.random.default_rng(0)
    lens = rng.integers(H2O_PROMPTS[0], H2O_PROMPTS[1] + 1, H2O_REQUESTS)
    prompts = [rng.integers(0, arch.vocab, (int(n),)).astype(np.int32) for n in lens]
    short = [p[:300] for p in prompts]  # warm-ups and host-op counts
    run = tick_and_megastep("4h", arch, params, prompts, dev=dev, chunk=H2O_CHUNK,
                            max_new=H2O_NEW, per_forward=per_forward, attn_layers=0,
                            short=short)
    tick, mega = run["engine"], run["mega"]
    eos = int(run["outs"][0][H2O_NEW // 2])
    for e in (tick, mega):
        e.eos_id = eos
    eos_outs = [e.generate(prompts, max_new=H2O_NEW) for e in (tick, mega)]
    for e in (tick, mega):
        e.eos_id = None
    eos_same = eos_outs[0] == eos_outs[1] and \
        [r.margins for r in tick.last_requests] == [r.margins for r in mega.last_requests]
    freed = all(e.cache.free_blocks == e.cache.num_blocks - 1 for e in (tick, mega))
    print(f"[4h] eos_id {eos}: tokens and margins identical {eos_same}, request 0 ends after "
          f"{len(eos_outs[1][0])} tokens, every block freed {freed}", flush=True)
    if not eos_same or len(eos_outs[1][0]) >= H2O_NEW or not freed:
        raise AssertionError("[4h] the EOS rerun differs or did not end request 0 early")
    chunk = profile_prefill_chunk(tick, prompts[0][:2 * H2O_CHUNK + 88])
    print(f"[4h] profiled prefill chunk of {H2O_CHUNK} tokens (device ms by part): "
          + ", ".join(f"{k} {v:.3f}" for k, v in chunk.items() if k != "rwkv6_scan"), flush=True)
    launches = {**run["launches"], **deployed}
    del run, tick, mega, params
    torch.cuda.empty_cache()

    cut = contiguous_check("4h", dev, arch, H2O_CUT_LAYERS, 7, H2O_CUT_PROMPT, H2O_CUT_NEW,
                           H2O_CHUNK)
    for k in ("a2q_quantize", "a2q_quantize[flips]"):
        launches[k] += cut[k]
    print(f"[4h] launches {launches}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"h2o-danube-1.8b": launches}


def contiguous_check(tag, dev, arch, layers, per_layer, prompt_len, new, chunk) -> dict:
    """The paged engine's ring against the contiguous ``ServeEngine``'s past
    the window: ``arch`` at full width cut to ``layers`` layers (the
    contiguous engine prefills a token a forward), one ``prompt_len``-token
    prompt and ``new`` tokens through ``launch/serve.py --paged
    --parity-check --deploy-int8`` (token for token), the deploy held to the
    plain quantizer (``per_layer`` matrices a layer and the head).  Returns
    its ``a2q_quantize`` launches and flips."""
    from repro_torch.kernels.a2q_quantize import a2q_quantize_cuda

    cut = dataclasses.replace(arch, stacks=(dataclasses.replace(arch.stacks[0], count=layers),))
    print(f"[{tag}] the contiguous check, depth cut to {layers} layers: 1 request of "
          f"{prompt_len} prompt tokens, {new} new, --paged --parity-check --deploy-int8",
          flush=True)
    t0 = time.perf_counter()
    a2q_quantize_cuda.launches = 0
    with held_deploys(f"{tag} cut") as held:
        out = launcher(["--arch", arch.name, "--device", str(dev), "--paged", "--parity-check",
                        "--deploy-int8", "--requests", "1", "--prompt-len", str(prompt_len),
                        "--max-new", str(new), "--batch", "1", "--max-seq",
                        str(prompt_len + new), "--block-size", "16",
                        "--prefill-chunk", str(chunk)], get_arch=lambda name: cut)
    torch.cuda.synchronize()
    check_held(f"{tag} cut", held, a2q_quantize_cuda.launches)
    contig = out["engines"]["contiguous"]
    ctp, ptp = contig.throughput(), out["engines"]["paged"].throughput()
    ring = contig.cache["0"]["attn"]["kpos"]
    print(f"[{tag}] contiguous check: tokens identical across engines {out['outs']}; ring "
          f"{tuple(contig.cache['0']['attn']['k'].shape)}, kpos from {int(ring.min())} to "
          f"{int(ring.max())}; contiguous prefill {ctp['prefill_tok_s']:.2f} tok/s, decode "
          f"{ctp['decode_tok_s']:.2f} tok/s; paged prefill {ptp['prefill_tok_s']:.2f} tok/s; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not on_card(contig.params, contig.cache) or len(out["outs"][0]) != new or int(ring.min()) <= 0 or \
            held["matrices"] != per_layer * layers + 1:
        raise AssertionError(f"[{tag}] the contiguous check did not run past the window on the "
                             "card")
    del out, contig
    torch.cuda.empty_cache()
    return {"a2q_quantize": held["matrices"], "a2q_quantize[flips]": held["flips"]}


def tick_and_megastep(tag, arch, params, prompts, *, dev, chunk, max_new, per_forward,
                      attn_layers, short, after_run=None) -> dict:
    """The paged engine on ``Runtime(int_chain=True, decode_kernel=True)``,
    ``len(prompts)`` slots, blocks of 16, prefill chunks of ``chunk``: per
    tick, then on the megastep (``decode_steps=8``) on the same params and
    batches, tokens and margins bit for bit; ``per_forward`` int_matmul
    prologue launches a forward (every prefill chunk, every tick, every
    tick of a window) and ``attn_layers`` ``paged_attention`` launches a
    decode tick.  Prints prefill and decode tok/s, host ops a tick and a
    window (``short`` prompts), KV bytes a token and state bytes a slot,
    peak memory and a profiled decode (``after_run(engine)`` is called on the
    per-tick engine right after its run); returns the launches by kernel
    entry, both engines and the per-tick run's tokens."""
    from repro_torch.kernels import ops
    from repro_torch.models.lm import Runtime
    from repro_torch.serve.engine import PagedServeEngine

    max_seq = -(-(max(len(p) for p in prompts) + max_new) // 16) * 16
    kw = dict(batch=len(prompts), max_seq=max_seq, block_size=16, prefill_chunk=chunk,
              device=dev, rt=Runtime(int_chain=True, decode_kernel=True))
    tick = PagedServeEngine(arch, params, **kw)
    mega = PagedServeEngine(arch, params, decode_steps=MEGASTEP_N, **kw)
    for e in (tick, mega):  # warm-up; the megastep engine captures its window here
        e.generate(short[:1], max_new=2)
    chunks = sum(-(-len(p) // chunk) for p in prompts)

    def run(engine):
        engine.reset_stats()
        torch.cuda.synchronize()
        before = ops.launch_counts()
        outs = engine.generate(prompts, max_new=max_new)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        return outs, engine.throughput(), {k: after[k] - before[k] for k in after}

    outs, ttp, tl = run(tick)
    if after_run is not None:
        after_run(tick)
    mouts, mtp, ml = run(mega)
    ticks, windows = ttp["decode_dispatches"], mtp["decode_dispatches"]
    want = {"int_matmul_cuda.prologue_launches": (per_forward * (ticks + chunks),
                                                  per_forward * (MEGASTEP_N * windows + chunks)),
            "paged_attention_cuda.launches": (attn_layers * ticks,
                                              attn_layers * MEGASTEP_N * windows)}
    got = {k: (tl[k], ml[k]) for k in want}
    for r, o in zip(tick.last_requests, outs):
        if len(o) != max_new or not all(0 <= t < arch.vocab for t in o) or \
                not np.isfinite(r.margins).all():
            raise AssertionError(f"[{tag}] bad output {o}")
    same_margins = [r.margins for r in tick.last_requests] == \
        [r.margins for r in mega.last_requests]
    marg = max(abs(x - y) for r, g in zip(tick.last_requests, mega.last_requests)
               for x, y in zip(r.margins, g.margins))
    print(f"[{tag}] prompts {[len(p) for p in prompts]} in chunks of {chunk}; per tick: prefill "
          f"{ttp['prefill_tok_s']:.2f} tok/s, decode {ttp['decode_tok_s']:.2f} tok/s ({ticks} "
          f"ticks); megastep: prefill {mtp['prefill_tok_s']:.2f} tok/s, decode "
          f"{mtp['decode_tok_s']:.2f} tok/s ({windows} windows, {mtp['graph_replays']} graph "
          f"replays); tokens identical {mouts == outs}, margins bit for bit {same_margins} "
          f"(largest difference {marg!r}); chain report {ttp['int_chain_folded']} folded, "
          f"{ttp['int_chain_requant_dispatches']} standalone, {ttp['int_chain_fallback']} "
          "fallback", flush=True)
    if got != want or mtp["graph_replays"] != windows or mouts != outs or not same_margins:
        raise AssertionError(f"[{tag}] launches {got} (expected {want}), or the megastep differs "
                             "from the per-tick engine")
    n_tick, n_window = tick_ops(tick, short), window_ops(mega, short)
    tc = tl["int_matmul_cuda.tc_launches"]
    print(f"[{tag}] host ops a tick {n_tick}, a window of {MEGASTEP_N} ticks {n_window}; "
          f"{tick.cache.kv_bytes_per_token()} KV bytes a token, {tick.cache.state_bytes_per_slot()} "
          f"state bytes a slot (rings and recurrent state); peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; per-tick run's int_matmul "
          f"launches: {tl['int_matmul_cuda.launches'] - tc} on the split-K decode kernel, {tc} "
          f"on the tensor-core kernel; graph pool {mega.graph_info['pool_bytes']} bytes; "
          f"capture {mega.graph_info['capture_s']:.3f} s", flush=True)
    if n_window > MEGASTEP_MAX_WINDOW_OPS:
        raise AssertionError(f"[{tag}] {n_window} host ops a window > {MEGASTEP_MAX_WINDOW_OPS}")
    profile_decode(tick, short)
    launches = {"int_matmul[prologue]": tl["int_matmul_cuda.prologue_launches"]
                + ml["int_matmul_cuda.prologue_launches"],
                "int_matmul[tc]": tc + ml["int_matmul_cuda.tc_launches"],
                "paged_attention": tl["paged_attention_cuda.launches"]
                + ml["paged_attention_cuda.launches"]}
    return {"launches": launches, "engine": tick, "mega": mega, "outs": outs}


def deploy_held(tag, build) -> tuple[dict, dict]:
    """``build()`` (an init and a deploy) under ``held_deploys``: the params
    and ``{"a2q_quantize": launches, "a2q_quantize[flips]": flips}``;
    prints the seconds, the parameters and their bytes on the card."""
    from repro_torch.kernels.a2q_quantize import a2q_quantize_cuda

    t0 = time.perf_counter()
    a2q_quantize_cuda.launches = 0
    with held_deploys(tag) as held:
        params = build()
    torch.cuda.synchronize()
    deploys = a2q_quantize_cuda.launches
    check_held(tag, held, deploys)
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"[{tag}] init + deploy: {time.perf_counter() - t0:.1f} s, {n_params / 1e9:.3f} B "
          f"params, {n_bytes / 1e9:.2f} GB on the card, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, {deploys} a2q_quantize launches, "
          f"{held['flips']} code flips", flush=True)
    return params, {"a2q_quantize": deploys, "a2q_quantize[flips]": held["flips"]}


# phase 4y (PERF.md section 4): prompts past the 1024-token window, in chunks
# of 256 (four 64-token SSD chunks a call) with a tail of another length (the
# sequential form)
HYMBA_REQUESTS, HYMBA_NEW, HYMBA_CHUNK = 4, 64, 256
HYMBA_PROMPTS = (1100, 1300)
HYMBA_LAYERS = 4  # of 32: a depth cut for the script's time (PERF.md section 4)
HYMBA_CUT_LAYERS, HYMBA_CUT_PROMPT, HYMBA_CUT_NEW = 2, 1100, 16  # the contiguous check's cut


def serve_hymba(dev) -> dict:
    """Phase 4y: hymba-1.5b at full width (d_model 1600, 25 heads over 5 KV
    heads of 64, window 1024, 25 mamba heads of 64 with state 16 and SSD
    chunk 64, d_ff 5504, vocab 32001), ``HYMBA_LAYERS`` of its 32 layers,
    random A2Q weights from seed 0 deployed through ``a2q_quantize`` (11 a
    layer and the head, each held), served on
    the paged engine with ``Runtime(int_chain=True, decode_kernel=True)``:
    4 requests over 4 slots, prompts of 1,100-1,300 tokens in prefill chunks
    of 256 (the ring wraps; the chunked SSD form on whole chunks, the
    sequential one on the tail), 64 new tokens, per tick and on the
    megastep, bit for bit; 11 a layer + 1 int_matmul prologue launches a forward and no
    ``paged_attention`` launch (the ring takes ``_sdpa``).  Then the
    contiguous check: the same widths cut to 2 layers, one 1,100-token
    prompt and 16 new tokens through ``launch/serve.py --paged
    --parity-check --deploy-int8``.  Returns the launches by kernel entry."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.engine import deploy_params

    full = get_arch("hymba-1.5b")
    arch = dataclasses.replace(full, stacks=(dataclasses.replace(full.stacks[0],
                                                                 count=HYMBA_LAYERS),))
    s = arch.stacks[0]
    phase(f"4y: hymba-1.5b full width ({arch.n_layers} of {full.n_layers} layers, d_model "
          f"{arch.d_model}, window "
          f"{s.attn.window}, {arch.d_model // s.ssm.head_dim} mamba heads, SSD chunk "
          f"{s.ssm.chunk}) on --int-chain --decode-kernel; {HYMBA_REQUESTS} requests of "
          f"{HYMBA_PROMPTS[0]}-{HYMBA_PROMPTS[1]} tokens, {HYMBA_NEW} new")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, deployed = deploy_held(arch.name, lambda: deploy_params(
        init_lm(torch.Generator(device=dev).manual_seed(0), arch, device=dev), arch.quant))
    per_forward = 11 * arch.n_layers + 1  # attention 4, mamba 4, mlp 3; the head
    if deployed["a2q_quantize"] != per_forward:
        raise AssertionError(f"{deployed} deploys, expected {per_forward}")
    rng = np.random.default_rng(0)
    lens = rng.integers(HYMBA_PROMPTS[0], HYMBA_PROMPTS[1] + 1, HYMBA_REQUESTS)
    prompts = [rng.integers(0, arch.vocab, (int(n),)).astype(np.int32) for n in lens]
    if all(len(p) % HYMBA_CHUNK % s.ssm.chunk == 0 for p in prompts):
        raise AssertionError("no prompt tail takes the sequential SSD form")
    run = tick_and_megastep("4y", arch, params, prompts, dev=dev, chunk=HYMBA_CHUNK,
                            max_new=HYMBA_NEW, per_forward=per_forward, attn_layers=0,
                            short=[p[:64] for p in prompts])
    launches = {**run["launches"], **deployed}
    del run, params
    torch.cuda.empty_cache()

    cut = contiguous_check("4y", dev, arch, HYMBA_CUT_LAYERS, 11, HYMBA_CUT_PROMPT,
                           HYMBA_CUT_NEW, HYMBA_CHUNK)
    for k in ("a2q_quantize", "a2q_quantize[flips]"):
        launches[k] += cut[k]
    print(f"[4y] launches {launches}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"hymba-1.5b": launches}


# phase 4l (PERF.md section 4): one iRoPE period, prompts across the 8192 chunk
LLAMA4_LAYERS, LLAMA4_PROMPTS, LLAMA4_NEW, LLAMA4_CHUNK = 4, (8300, 8450), 32, 256


def serve_llama4(dev) -> dict:
    """Phase 4l: llama4-scout at full width (d_model 5120, 40 heads over 8
    KV heads of 128, 16 experts top-1 with d_ff 8192 plus 1 shared expert,
    vocab 202048) with its depth cut from 48 layers to one iRoPE period (3
    chunk-local RoPE layers with chunk 8192, then 1 NoPE global layer),
    built and deployed block by block (221 matrices, each held): 2
    requests of 8,300 and 8,450 tokens in prefill chunks of 256 (prefill
    crosses the 8192 chunk boundary; the local layers' rings of 8192 slots
    wrap), 32 new tokens, per tick and on the megastep on the same batches,
    bit for bit; 29 int_matmul prologue launches a forward, one
    ``paged_attention`` launch a tick (the global layer; the rings take
    ``_sdpa``).  Returns the launches by kernel entry."""
    from repro_torch.configs import get_arch

    full = get_arch("llama4-scout-17b-a16e")
    arch = dataclasses.replace(full, stacks=full.stacks[:2])  # 3 local + 1 global
    local, glob = arch.stacks
    if arch.n_layers != LLAMA4_LAYERS or local.attn.chunk is None or \
            glob.attn.rope_theta is not None:
        raise AssertionError("llama4-scout's first two stacks are not one iRoPE period")
    phase(f"4l: llama4-scout full width (d_model {arch.d_model}, {local.moe.n_experts} experts "
          f"top-{local.moe.top_k} + {local.moe.n_shared} shared, vocab {arch.vocab}) cut to "
          f"{arch.n_layers} layers ({local.count} chunk-local of {local.attn.chunk}, "
          f"{glob.count} NoPE global); {len(LLAMA4_PROMPTS)} requests of {LLAMA4_PROMPTS} tokens")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, deployed = deploy_held(arch.name, lambda: build_by_block(dev, arch))
    per_forward = 7 * arch.n_layers + 1  # attention 4, the shared expert 3; the head
    n_deploy = arch.n_layers * (4 + 3 * local.moe.n_experts + 3) + 1
    if deployed["a2q_quantize"] != n_deploy:
        raise AssertionError(f"{deployed} deploys, expected {n_deploy}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.vocab, (n,)).astype(np.int32) for n in LLAMA4_PROMPTS]
    def rings(engine):
        kpos = engine.cache.pools["0"]["attn"]["kpos"]
        chunk = local.attn.chunk
        seen = (kpos >= 0) & (kpos // chunk == kpos.max(-1, keepdim=True).values // chunk)
        print(f"[4l] after the per-tick run: local rings {tuple(kpos.shape)}, each slot's kpos "
              f"from {kpos.min(-1).values[0].tolist()} to {kpos.max(-1).values[0].tolist()}; "
              f"keys in the last token's chunk {seen.sum(-1)[0].tolist()} of {chunk} slots; the "
              f"global layer's pools {tuple(engine.cache.pools['1']['attn']['kp'].shape)}",
              flush=True)
        if int(kpos.max()) < chunk or int(seen.sum(-1).max()) >= chunk:
            raise AssertionError("[4l] no prompt crossed the chunk boundary")

    run = tick_and_megastep("4l", arch, params, prompts, dev=dev, chunk=LLAMA4_CHUNK,
                            max_new=LLAMA4_NEW, per_forward=per_forward,
                            attn_layers=glob.count, short=[p[:64] for p in prompts],
                            after_run=rings)
    launches = {**run["launches"], **deployed}
    print(f"[4l] launches {launches}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    del run, params
    torch.cuda.empty_cache()
    return {"llama4-scout": launches}


LLAVA_LAYERS, LLAVA_TEXT = 4, 64  # phase 4v (PERF.md section 4)


def _sdpa_as_flash(q, k, v, *, causal, window=None, scale=None, q_chunk=256):
    """``ops.flash_attention``'s contract on ``nn.attention._sdpa`` (the
    reference's cacheless attention): ``(B, H, T, D)`` head views in and out,
    positions ``0 .. T - 1`` for queries and keys."""
    from repro_torch.nn.attention import _sdpa

    B, T = q.shape[0], q.shape[2]
    pos = torch.arange(T, dtype=torch.int32, device=q.device)[None].expand(B, T)
    return _sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), pos, pos,
                 causal=causal, window=window, chunk=None, q_chunk=q_chunk).transpose(1, 2)


def serve_llava(dev) -> dict:
    """Phase 4v: llava-next-34b at full width (d_model 7168, 56 heads over 8
    KV heads of 128, d_ff 20480, vocab 64000) with its depth cut from 60
    layers to 4, random A2Q weights from seed 0 deployed through
    ``a2q_quantize`` (29 matrices, each held).  (a) ``build_prefill_step``
    on ``Runtime(int_chain=True)`` over 576 patch embeddings drawn from the
    seed plus 64 text tokens, batch 2, bf16: 4 ``flash_attention`` launches,
    causal, GQA 7:1, D=128, all on the tensor cores, 29 int_matmul on the
    tensor-core kernel; the last position's logits held to the same forward
    with the cacheless attention on ``_sdpa`` within two bf16 ulps of the
    largest logit.  (b) the paged engine serves phase 4's 8 text prompts (64
    tokens, 32 new) per tick and on the megastep, bit for bit, 4
    ``paged_attention`` launches a tick.  Returns the launches by kernel
    entry."""
    from unittest import mock

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.lm import Runtime, init_lm
    from repro_torch.models.steps import build_prefill_step
    from repro_torch.serve.engine import deploy_params

    full = get_arch("llava-next-34b")
    arch = dataclasses.replace(full, stacks=(dataclasses.replace(full.stacks[0],
                                                                 count=LLAVA_LAYERS),))
    a = arch.stacks[0].attn
    S = arch.frontend.seq_len
    phase(f"4v: llava-next-34b full width (d_model {arch.d_model}, {a.heads} heads over "
          f"{a.kv_heads} KV heads of {a.head_dim}) cut to {arch.n_layers} layers; {S} patches + "
          f"{LLAVA_TEXT} tokens through build_prefill_step, then served on text")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, deployed = deploy_held(arch.name, lambda: deploy_params(
        init_lm(torch.Generator(device=dev).manual_seed(0), arch, device=dev), arch.quant))
    per_forward = 7 * arch.n_layers + 1
    if deployed["a2q_quantize"] != per_forward:
        raise AssertionError(f"{deployed} deploys, expected {per_forward}")
    rng = np.random.default_rng(0)
    batch = {"frontend_embeds": torch.as_tensor(rng.normal(size=(2, S, arch.d_model)),
                                                dtype=torch.bfloat16, device=dev),
             "tokens": torch.as_tensor(rng.integers(0, arch.vocab, (2, LLAVA_TEXT)),
                                       dtype=torch.int32, device=dev)}
    step = build_prefill_step(arch, Runtime(int_chain=True))
    step(params, batch)  # warm-up
    torch.cuda.synchronize()
    before = ops.launch_counts()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    after = ops.launch_counts()
    got = {k: (after[k] - before[k]) // 3 for k in after if after[k] != before[k]}
    want = {"int_matmul_cuda.launches": per_forward, "int_matmul_cuda.prologue_launches":
            per_forward, "int_matmul_cuda.tc_launches": per_forward,
            "flash_attention_cuda.launches": arch.n_layers,
            "flash_attention_cuda.tc_launches": arch.n_layers}
    with mock.patch.object(ops, "flash_attention", _sdpa_as_flash):
        ref = step(params, batch)
    torch.cuda.synchronize()
    if ops.launch_counts()["flash_attention_cuda.launches"] != after[
            "flash_attention_cuda.launches"]:
        raise AssertionError("[4v a] the _sdpa forward launched flash_attention")
    lf, rf = logits.float(), ref.float()
    scale = rf.abs().max().item()
    diff = (lf - rf).abs().max().item()
    eps = 2.0**-6 * scale  # two bf16 ulps at the top of the logit range
    tok_s = 2 * (S + LLAVA_TEXT) / sorted(secs)[1]
    print(f"[4v a] prefill of 2 x ({S} patches + {LLAVA_TEXT} tokens): {tok_s:.1f} tok/s "
          f"(median of 3), logits {tuple(logits.shape)}; launches a forward {got}; against "
          f"the cacheless attention on _sdpa: max |diff| {diff:.4g}, max |logit| {scale:.4g}, "
          f"bound {eps:.4g}, argmax equal {torch.equal(lf.argmax(-1), rf.argmax(-1))}",
          flush=True)
    if got != want or not torch.isfinite(lf).all() or not diff <= eps:
        raise AssertionError(f"[4v a] launches {got} (expected {want}) or logits off _sdpa's by "
                             f"{diff} > {eps}")
    launches = {"int_matmul[prologue]": 3 * per_forward, "int_matmul[tc]": 3 * per_forward,
                "flash_attention": 3 * arch.n_layers, "flash_attention[tc]": 3 * arch.n_layers}
    del logits, ref, lf, rf
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.vocab, (64,)).astype(np.int32) for _ in range(8)]
    run = tick_and_megastep("4v b", arch, params, prompts, dev=dev, chunk=32, max_new=32,
                            per_forward=per_forward, attn_layers=arch.n_layers,
                            short=prompts)
    for k, v in run["launches"].items():
        launches[k] = launches.get(k, 0) + v
    launches.update(deployed)
    print(f"[4v] launches {launches}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    del run, params
    torch.cuda.empty_cache()
    return {"llava-next-34b": launches}


def build_hubert(dev, arch) -> dict:
    """Full-size random A2Q params of ``arch`` (hubert-xlarge), each block
    drawn with the package's own initializer and deployed to int8 (on the
    card: every A2Q matrix through the ``a2q_quantize`` kernel) before the
    next is drawn, so no whole fp32 tree exists."""
    from repro_torch.nn.linear import init_linear
    from repro_torch.nn.norms import init_norm
    from repro_torch.nn.transformer import _init_block
    from repro_torch.serve.engine import deploy_params

    q, d = arch.quant, arch.d_model
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {"stacks": {}}
    for i, s in enumerate(arch.stacks):
        layers = []
        for _ in range(s.count):
            layers.append(deploy_params(_init_block(gen, arch, s), q))
        params["stacks"][str(i)] = _stack_layers(*layers)
        del layers
    params["final_norm"] = init_norm(d, arch.norm, device=dev)
    params["head"] = deploy_params(init_linear(gen, d, arch.n_classes, q, boundary=True), q)
    return params


def profile_forward(fn, label: str = "forward") -> float:
    """Device time of one call of ``fn`` by kernel, from a torch.profiler
    trace (CUPTI).  Prints the kernels' device time and the largest kernels;
    returns the total in ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = kernel_ms(prof)
    total = sum(dev.values())
    print(f"profiled {label}: kernels' device time {total:.3f} ms ({len(dev)} kernels)",
          flush=True)
    for name, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:9.3f} ms  {ms / max(total, 1e-9):6.1%}  {name[:110]}", flush=True)
    return total


def w_out_code_diffs(params, arch, frames) -> tuple[int, int, bool]:
    """One ``int_chain`` encode with every layer's non-gated MLP probed: the
    int8 codes ``mlp.w_in``'s gelu requant epilogue hands ``mlp.w_out``
    against the codes the unchained path makes of the same input (the fp
    output, the host gelu, ``w_out``'s own act-quant).  Returns (codes that
    differ, codes compared, whether each differing code is one apart at a
    rounding tie of the gelu replay, ``requant_ties``)."""
    import repro_torch.nn.transformer as transformer
    from repro_torch.core.quantizers import act_quant_int
    from repro_torch.kernels.int_matmul import requant_ties
    from repro_torch.kernels.ref import gelu_tanh
    from repro_torch.models.lm import Runtime, apply_lm
    from repro_torch.nn.linear import apply_linear, chain_out_aq

    apply_mlp = transformer._apply_mlp
    seen = [0, 0, True]

    def probe(p, x, q, cd, int_forward=False, int_chain=False):
        chained = apply_linear(p["w_in"], x, q, compute_dtype=cd, int_forward=True,
                               int_chain=True, out_aq=chain_out_aq(p["w_out"], q, act_fn="gelu"))
        h = apply_linear(p["w_in"], x, q, compute_dtype=cd, int_forward=True)
        h = gelu_tanh(h.to(torch.float32)).to(cd)
        codes, scale = act_quant_int({"log2_scale": p["w_out"]["aq"]["log2_scale"]},
                                     h.to(torch.float32), q.act_bits, signed=True)
        diff = chained.codes.to(torch.float32) - codes
        if (diff != 0).any():
            N = h.shape[-1]
            ties = requant_ties(h.reshape(-1, N), scale.reshape(-1).expand(N), "gelu", cd)
            seen[2] &= bool(diff.abs().max() <= 1) and not (diff != 0).reshape(-1, N)[~ties].any()
        seen[0] += int((diff != 0).sum())
        seen[1] += codes.numel()
        return apply_mlp(p, x, q, cd, int_forward, int_chain)

    transformer._apply_mlp = probe
    try:
        apply_lm(params, arch, frontend_embeds=frames, rt=Runtime(int_chain=True))
    finally:
        transformer._apply_mlp = apply_mlp
    return seen[0], seen[1], seen[2]


def encode_hubert(dev) -> dict:
    """Phases 4f and 5f: full-size hubert-xlarge deployed on the card through
    a2q_quantize and encoded on ``--int-chain`` through the port's
    ``build_prefill_step`` / ``apply_lm(frontend_embeds=...)``: every
    attention on flash_attention, every deployed linear on int_matmul,
    mlp.w_in's gelu requant epilogue handing int8 codes to mlp.w_out; held
    against the unchained int-forward encode and the dequant path; then
    reduced hubert on the card against the CPU.  Returns the main run's
    launches by kernel variant."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.a2q_quantize import a2q_quantize_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.int_matmul import int_matmul_cuda
    from repro_torch.models.lm import Runtime, apply_lm, init_lm
    from repro_torch.models.steps import build_prefill_step
    from repro_torch.nn.module import tree_to
    from repro_torch.serve.engine import deploy_params

    phase("4f: encode full-size hubert-xlarge on --int-chain (a2q_quantize deploy, "
          "flash_attention, gelu requant)")
    arch = get_arch("hubert-xlarge")
    n = arch.n_layers
    per_forward = 6 * n + 1  # wq, wk, wv, wo, w_in, w_out a layer, and the head
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    a2q_quantize_cuda.launches = 0
    t0 = time.perf_counter()
    with held_deploys(arch.name) as held:
        params = build_hubert(dev, arch)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    deploys = a2q_quantize_cuda.launches
    check_held(arch.name, held, deploys)
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"init + deploy of {arch.name} ({n} layers, d_model {arch.d_model}, d_ff "
          f"{arch.stacks[0].d_ff}, {arch.n_classes} classes): {build_s:.1f}s, "
          f"{n_params / 1e9:.4f} B params, {n_bytes / 1e9:.3f} GB on the card, peak allocated "
          f"while building {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, {deploys} "
          f"a2q_quantize launches", flush=True)
    if deploys != per_forward:
        raise AssertionError(f"{deploys} a2q_quantize launches at deploy, expected {per_forward}")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal((HUBERT_CLIPS, HUBERT_FRAMES, arch.d_model),
                                                  dtype=np.float32)).to(dev, torch.bfloat16)
    rt = Runtime(int_chain=True)
    step = build_prefill_step(arch, rt)
    step(params, {"frontend_embeds": frames[:1, :64]})  # warm-up: first-call library set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    int_matmul_cuda.launches = int_matmul_cuda.requant_launches = 0
    int_matmul_cuda.prologue_launches = flash_attention_cuda.launches = 0
    int_matmul_cuda.tc_launches = flash_attention_cuda.tc_launches = 0
    t0 = time.perf_counter()
    logits = apply_lm(params, arch, frontend_embeds=frames, rt=rt)[0]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"int_matmul": int_matmul_cuda.launches,
                "int_matmul[prologue]": int_matmul_cuda.prologue_launches,
                "int_matmul[requant]": int_matmul_cuda.requant_launches,
                "int_matmul[tc]": int_matmul_cuda.tc_launches,
                "flash_attention": flash_attention_cuda.launches,
                "flash_attention[tc]": flash_attention_cuda.tc_launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    rep = rt.chain_report
    report = tuple(len(rep[k]) for k in ("folded", "chained", "standalone", "fallback"))
    print(f"encode of {HUBERT_CLIPS} clips x {HUBERT_FRAMES} frames: {first_s:.3f}s; peak "
          f"allocated while encoding {peak:.2f} GB; launches {launches}; chain report "
          f"{report[0]} folded, {report[1]} chained, {report[2]} standalone, {report[3]} "
          f"fallback", flush=True)
    if launches != {"int_matmul": per_forward, "int_matmul[prologue]": per_forward - n,
                    "int_matmul[requant]": n, "int_matmul[tc]": per_forward,
                    "flash_attention": n, "flash_attention[tc]": n} \
            or report != (per_forward, n, 0, 0) or rep["chained"] != ["mlp.w_in"] * n:
        raise AssertionError(f"launches {launches}, chain report {report}: expected {per_forward} "
                             f"int_matmul ({per_forward - n} prologue, {n} gelu requant, {n} "
                             f"int8 x; all on the tensor cores), {n} flash_attention on the "
                             f"tensor cores, {per_forward} folded / {n} chained / 0 standalone")
    if logits.shape != (HUBERT_CLIPS, HUBERT_FRAMES, arch.n_classes) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits: {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        apply_lm(params, arch, frontend_embeds=frames, rt=rt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    frames_n = HUBERT_CLIPS * HUBERT_FRAMES
    print(f"encode seconds {[round(t, 4) for t in times]}: {frames_n / np.median(times):.1f} "
          f"frames/s ({frames_n * 0.02 / np.median(times):.1f} s of audio a second), median of 3",
          flush=True)
    last = step(params, {"frontend_embeds": frames})
    if not torch.equal(last, logits[:, -1:]):
        raise AssertionError("build_prefill_step's logits are not the last frame's")
    kernel_ms = profile_forward(lambda: apply_lm(params, arch, frontend_embeds=frames, rt=rt))
    print(f"kernel ms a forward {kernel_ms:.3f}; prefill step gives the last frame's logits "
          f"(max |logit| {logits.float().abs().max().item():.4g})", flush=True)

    phase("5f: hubert-xlarge chained vs unchained and on the dequant path; reduced hubert "
          "card vs CPU")
    l_c = logits.float()
    l_u = apply_lm(params, arch, frontend_embeds=frames, rt=Runtime(int_forward=True))[0].float()
    differ, compared, at_ties = w_out_code_diffs(params, arch, frames)
    cu_diff = (l_c - l_u).abs().max().item()
    cu_eps = 2.0**-6 * l_u.abs().max().item()  # two bf16 ulps at the top of the logit range
    print(f"chained vs unchained: logits bitwise equal {torch.equal(l_c, l_u)}, max |diff| "
          f"{cu_diff:.4g} (bound {cu_eps:.4g} where codes differ); w_out input codes differing "
          f"{differ} of {compared}, each one apart at a gelu rounding tie {at_ties}", flush=True)
    if not (torch.equal(l_c, l_u) if differ == 0 else at_ties and cu_diff <= cu_eps):
        raise AssertionError(f"hubert-xlarge: chained and unchained encodes differ ({differ} "
                             f"w_out input codes, at ties {at_ties}; logits max |diff| {cu_diff})")
    del l_u
    l_deq = apply_lm(params, arch, frontend_embeds=frames)[0].float()
    scale = l_deq.abs().max().item()
    diff = (l_c - l_deq).abs().max().item()
    eps = 2.0**-6 * scale  # two bf16 ulps at the top of the logit range
    agree = (l_c.argmax(-1) == l_deq.argmax(-1)).float().mean().item()
    print(f"logits, int-chain vs dequant path: max |diff| {diff:.4g}, max |logit| {scale:.4g}, "
          f"bound {eps:.4g}; framewise argmax agreement {agree:.4f}", flush=True)
    if not (np.isfinite(diff) and diff <= eps):
        raise AssertionError(f"int-chain logits off the dequant path by {diff} > {eps}")
    del params, logits, l_c, l_deq
    torch.cuda.empty_cache()
    small = reduced(arch)
    sp = deploy_params(init_lm(torch.Generator().manual_seed(0), small, device="cpu"), small.quant)
    x = torch.from_numpy(rng.standard_normal((2, 40, small.d_model), dtype=np.float32))
    small_rt = Runtime(int_chain=True)
    cpu_l = apply_lm(sp, small, frontend_embeds=x, rt=small_rt)[0]
    flash_attention_cuda.launches = int_matmul_cuda.requant_launches = 0
    gpu_l = apply_lm(tree_to(sp, dev), small, frontend_embeds=x.to(dev), rt=small_rt)[0].cpu()
    err = (gpu_l - cpu_l).abs().max().item()
    tol = 1e-4 * cpu_l.abs().max().item()
    print(f"reduced hubert-xlarge card vs CPU (int-chain, 2 x 40 frames): max |diff| {err:.3g} "
          f"(tol {tol:.3g}), {flash_attention_cuda.launches} flash_attention and "
          f"{int_matmul_cuda.requant_launches} gelu requant launches on the card", flush=True)
    if not err <= tol or not flash_attention_cuda.launches or \
            not int_matmul_cuda.requant_launches:
        raise AssertionError(f"reduced hubert card vs CPU: max |diff| {err} > {tol}")
    return {"hubert-xlarge int-chain": {
        "a2q_quantize": deploys,
        "a2q_quantize[flips]": held["flips"],
        "int_matmul[gelu requant]": launches["int_matmul[requant]"],
        "int_matmul[prologue]": launches["int_matmul[prologue]"],  # the gelu requant's included
        "int_matmul": launches["int_matmul"] - launches["int_matmul[prologue]"],  # int8 x in
        "int_matmul[tc]": launches["int_matmul[tc]"],
        "flash_attention": launches["flash_attention"],
        "flash_attention[tc]": launches["flash_attention[tc]"]}}


# with the resumed half, about 40 s at full size (cut from 100 steps, then 50, as
# later phases needed the script's time; PERF.md section 4)
TRAIN_STEPS = 24
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 512, 3e-3
# the resumed run's losses against the uninterrupted run's: the first step
# bit for bit (same state, same batch, a deterministic forward), the rest
# within RESUME_TOL nat — the embedding's and the CE gather's backward add
# with atomics on the card, so each step's gradient differs in its last bits
# and Adam carries that on
RESUME_TOL = 0.05


def _bigram(prev: int, vocab: int) -> int:
    """``TokenStream``'s grammar: ``next = (a * prev + 17) % V``."""
    return ((31 if vocab % 31 else 37) * prev + 17) % vocab


def code_stats(params, arch) -> dict:
    """Over every deployed matrix: the largest column's ``Σ|q|`` as a share
    of the Eq. 15 budget (the accumulator guarantee: must be <= 1) and the
    share of zero codes (A2Q's unstructured sparsity)."""
    from repro_torch.core.bounds import l1_budget

    budget = l1_budget(arch.quant.acc_bits, arch.quant.act_bits, True)
    worst, zeros, total = 0.0, 0, 0
    for node in _deployed(params):
        q = node["q8"].to(torch.int32)  # (..., K, C)
        worst = max(worst, float(q.abs().sum(-2).max()) / budget)
        zeros += int((q == 0).sum())
        total += q.numel()
    return {"max_column_budget_share": worst, "zero_code_share": zeros / total,
            "budget": budget}


def _deployed(tree):
    if isinstance(tree, dict):
        if "q8" in tree:
            yield tree
        else:
            for v in tree.values():
                yield from _deployed(v)


def train_smollm(dev) -> dict:
    """Phase 4t: A2Q training of full-width smollm-135m on the card, resumed
    from a mid-run checkpoint, deployed through a2q_quantize and served on
    the int path.  Returns the deploy + serve path's launches by kernel."""
    import shutil

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.kernels.a2q_quantize import a2q_quantize_cuda
    from repro_torch.kernels.int_matmul import int_matmul_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.lm import Runtime, apply_lm, init_lm
    from repro_torch.models.steps import build_train_step
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.schedules import cosine_with_warmup
    from repro_torch.serve.engine import PagedServeEngine, deploy_params, parity_up_to_ties
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.state import init_state
    from repro_torch.train.trainer import Trainer

    phase(f"4t: train full-width smollm-135m ({TRAIN_STEPS} steps), resume, deploy, serve")
    arch = get_arch("smollm-135m")
    q = arch.quant
    if (arch.compute_dtype, arch.param_dtype, arch.remat) != ("bfloat16", "float32", "block") or \
            (q.mode, q.weight_bits, q.act_bits, q.acc_bits) != ("a2q", 8, 8, 16):
        raise AssertionError(f"smollm-135m's config moved: {arch}")
    N, mid = TRAIN_STEPS, TRAIN_STEPS // 2
    stream = TokenStream(vocab=arch.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0)
    sched = cosine_with_warmup(TRAIN_LR, warmup=max(N // 20, 1), total=N)
    d = str(Path(__file__).resolve().parent / "build" / "smoke_ckpt")
    shutil.rmtree(d, ignore_errors=True)

    def fresh():
        params = init_lm(torch.Generator(device=dev).manual_seed(0), arch, device=dev)
        opt = adamw()
        return params, init_state(params, opt).tree(), build_train_step(
            arch, opt, Runtime(), lr_schedule=sched)

    untrained, state, step_fn = fresh()
    ops.set_launch_counts({k: 0 for k in ops.launch_counts()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = Trainer(step_fn, stream.batch, ckpt_dir=d, ckpt_every=mid, keep=2,
                  log_every=1).run(state, N)
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist = res.history
    losses = np.array([r["loss"] for r in hist])
    if len(hist) != N or not np.isfinite(losses).all():
        raise AssertionError(f"training: {len(hist)} logged steps, finite {np.isfinite(losses).all()}")
    step_ms = float(np.median([r["step_time"] for r in hist[1:]])) * 1e3
    head = {k: float(np.mean([r[k] for r in hist[:10]])) for k in ("loss", "ce", "penalty")}
    tail = {k: float(np.mean([r[k] for r in hist[-10:]])) for k in ("loss", "ce", "penalty")}
    print(f"train: {N} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {train_s:.1f}s; median step "
          f"{step_ms:.2f} ms ({TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.0f} train tok/s; first "
          f"step {hist[0]['step_time'] * 1e3:.0f} ms); peak memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"first-10 mean {head}; last-10 mean {tail}; largest grad norm "
          f"{max(r['grad_norm'] for r in hist):.4g}", flush=True)
    if not tail["loss"] <= head["loss"] - 0.5:
        raise AssertionError(f"loss fell {head['loss'] - tail['loss']:.3f} nat, less than 0.5")

    phase("4t: resume from the mid-run checkpoint in a fresh Trainer")
    _, like, step_fn2 = fresh()
    restored, start = ckpt.restore(d, like, step=mid)
    del like
    res2 = Trainer(step_fn2, stream.batch, log_every=1).run(restored, N - start, start_step=start)
    resumed = np.array([r["loss"] for r in res2.history])
    diff = np.abs(resumed - losses[start:])
    print(f"resumed at step {start}: {len(resumed)} steps, largest |loss - uninterrupted| "
          f"{diff.max():.4g} nat (first step {diff[0]:.3g}); tolerance {RESUME_TOL}", flush=True)
    if start != mid or resumed[0] != losses[mid] or not diff.max() <= RESUME_TOL:
        raise AssertionError(f"resume off the uninterrupted run: {diff}")
    shutil.rmtree(d, ignore_errors=True)
    train_launches = sum(ops.launch_counts().values())
    print(f"kernel launches while training and resuming: {train_launches}", flush=True)
    if train_launches:
        raise AssertionError(f"training launched kernels: {ops.launch_counts()}")
    trained = res.state["params"]
    del res, res2, restored
    torch.cuda.empty_cache()
    probe = TokenStream(vocab=arch.vocab, seq_len=64, global_batch=8, seed=0).batch(10_000)["tokens"]
    with torch.no_grad():  # the trained model as training computes it (fake-quant, bf16)
        l_train = apply_lm(trained, arch, tokens=torch.as_tensor(probe, device=dev))[0]
    train_hits = float((l_train[:, :-1].argmax(-1).cpu().numpy() ==
                        _bigram(probe[:, :-1], arch.vocab)).mean())
    del l_train

    phase("4t: deploy the trained model; serve it on the kernels")
    with held_deploys(f"{arch.name} untrained") as held0:
        before = code_stats(deploy_params(untrained, q), arch)
    del untrained
    a2q_quantize_cuda.launches = 0
    with held_deploys(f"{arch.name} trained") as held:
        params = deploy_params(trained, q)
    torch.cuda.synchronize()
    deploys = a2q_quantize_cuda.launches
    check_held(f"{arch.name} trained", held, deploys)
    after = code_stats(params, arch)
    print(f"codes untrained -> trained: largest column's share of the P=16 budget "
          f"({after['budget']:.2f}) {before['max_column_budget_share']:.4f} -> "
          f"{after['max_column_budget_share']:.4f}; zero codes {before['zero_code_share']:.4f} -> "
          f"{after['zero_code_share']:.4f}", flush=True)
    if max(before["max_column_budget_share"], after["max_column_budget_share"]) > 1.0 or \
            deploys != 7 * arch.n_layers or held0["flips"] or held["flips"]:
        raise AssertionError(f"deploy: {deploys} launches, untrained {before}, trained {after}, "
                             f"flips {held0['flips']} / {held['flips']}")
    prompts = list(probe)
    kw = dict(batch=8, max_seq=96, block_size=16, prefill_chunk=32, device=dev)
    engine = PagedServeEngine(arch, params, rt=Runtime(int_forward=True, decode_kernel=True), **kw)
    engine.generate(prompts[:1], max_new=2)  # warm-up
    engine.reset_stats()
    torch.cuda.synchronize()
    int_matmul_cuda.launches = int_matmul_cuda.tc_launches = paged_attention_cuda.launches = 0
    outs = engine.generate(prompts, max_new=32)
    torch.cuda.synchronize()
    launches = {"int_matmul": int_matmul_cuda.launches,
                "int_matmul[tc]": int_matmul_cuda.tc_launches,
                "paged_attention": paged_attention_cuda.launches,
                "a2q_quantize": deploys, "a2q_quantize[flips]": held["flips"]}
    tp = engine.throughput()
    print(f"serve trained: prefill {tp['prefill_tok_s']:.1f} tok/s | decode "
          f"{tp['decode_tok_s']:.1f} tok/s; launches {launches}", flush=True)
    ticks, chunks = tp["decode_dispatches"], sum(-(-len(p) // 32) for p in prompts)
    if launches["int_matmul"] != 7 * arch.n_layers * (ticks + chunks) or \
            launches["paged_attention"] != arch.n_layers * ticks:
        raise AssertionError(f"launch counts {launches} over {ticks} ticks, {chunks} chunks")
    toks = torch.as_tensor(np.stack(prompts), device=dev)
    l_int = apply_lm(params, arch, tokens=toks, rt=Runtime(int_forward=True))[0].float()
    l_deq = apply_lm(params, arch, tokens=toks)[0].float()
    scale = l_deq.abs().max().item()
    eps = 2.0**-6 * scale  # two bf16 ulps at the top of the logit range
    ref = PagedServeEngine(arch, params, rt=Runtime(), **kw)
    ref_outs = ref.generate(prompts, max_new=32)
    ok, ties, detail = parity_up_to_ties(ref.last_requests, outs, eps)
    hits = [t == _bigram(p, arch.vocab) for prompt, o in zip(prompts, outs)
            for p, t in zip([int(prompt[-1])] + list(o[:-1]), o)]
    ref_hits = [t == _bigram(p, arch.vocab) for prompt, o in zip(prompts, ref_outs)
                for p, t in zip([int(prompt[-1])] + list(o[:-1]), o)]
    prompt_hits = float((l_deq[:, :-1].argmax(-1).cpu().numpy() ==
                         _bigram(np.stack(prompts)[:, :-1], arch.vocab)).mean())
    print(f"served tokens, int path vs dequant path: parity_up_to_ties eps={eps:.4g}: ok={ok} "
          f"ties={ties} identical_requests={sum(a == b for a, b in zip(ref_outs, outs))}/8; "
          f"largest |logit| {scale:.4g}, int vs dequant max |diff| "
          f"{(l_int - l_deq).abs().max().item():.4g}", flush=True)
    print(f"bigram agreement: served tokens equal to (31 * prev + 17) mod {arch.vocab}: "
          f"{np.mean(hits):.4f} int path, {np.mean(ref_hits):.4f} dequant path; the prompts' "
          f"next-token argmax {prompt_hits:.4f} deployed, {train_hits:.4f} as trained "
          "(fake-quant)", flush=True)
    print(f"req 0 tokens: {outs[0]}", flush=True)
    if not ok:
        raise AssertionError(f"parity failed: {detail}")
    for o in outs:
        if len(o) != 32 or not all(0 <= t < arch.vocab for t in o):
            raise AssertionError(f"bad output {o}")
    del engine, ref, params, trained
    return {"smollm-135m trained": launches}


# phase 4u (PERF.md section 4): the MoE and recurrent decoders trained at full
# width, each cut in depth to fit one card with its optimizer: 8 steps of 4 x
# 512 TokenStream tokens (512 a multiple of rwkv6's and hymba's 64-token
# chunks), then deployed and served.  At these widths A2Q from the
# reference's init puts out logits within ~0.03 of 0 (the P=16 budget spreads
# 256 integer units over each column's K = 1,600-18,432 inputs), and 8 steps
# do not move the loss: the full-width runs are held to a finite loss that
# does not rise by more than DECODER_FLAT_TOL, and the learning to the
# reduced configs trained on the card against the same run on the CPU
DECODER_TRAIN_STEPS, DECODER_TRAIN_BATCH, DECODER_TRAIN_SEQ, DECODER_TRAIN_LR = 8, 4, 512, 3e-3
DECODER_CHECK_STEPS = 12  # the reduced configs' learning runs, card against CPU
DECODER_SERVE_REQUESTS, DECODER_SERVE_PROMPT, DECODER_SERVE_NEW = 4, 64, 16
DECODER_FLAT_TOL = 1e-3  # nat
DECODER_CHECK_SEQ, DECODER_CHECK_TOL = 64, 1e-3  # reduced runs: tokens a row, card vs CPU rtol
DECODER_TRAIN_RUNS = (  # (arch, layers kept of the first stack, optimizer)
    # one chunk-local MoE layer: 4.27 B parameters; adamw's two moments would not fit
    ("llama4-scout-17b-a16e", 1, "adafactor"),
    # one of the 3 dense MLA layers and the MTP head (its block then takes the
    # dense stack's d_ff 18,432): 3.12 B; adamw's moments ran out of memory in
    # the backward (69.3 GiB peak, 12.8 GiB of it unallocated between blocks)
    ("deepseek-v3-671b", 1, "adafactor"),
    ("rwkv6-7b", 2, "adamw"),
    ("hymba-1.5b", 4, "adamw"),
)


def _a2q_matrices(tree) -> int:
    """The 2-D A2Q weight matrices of a tree (a stacked leaf's layers and
    experts each one): what a deploy launches ``a2q_quantize`` on."""
    if not isinstance(tree, dict):
        return 0
    if {"v", "t", "d"} <= set(tree):
        return int(np.prod(tree["v"].shape[:-2]))
    return sum(_a2q_matrices(v) for v in tree.values())


def _int_matmul_per_forward(arch) -> int:
    """Deployed 2-D linears one cached forward runs on int_matmul (the
    routed experts take the dequantized view; MLA's wkv_b is absorbed)."""
    s = arch.stacks[0]
    if s.kind == "rwkv6":
        return 7 * s.count + 1  # time-mix 5, channel-mix 2; the head
    if s.kind == "hymba":
        return 11 * s.count + 1  # attention 4, mamba 4, mlp 3; the head
    return deepseek_int_matmul_per_forward(arch)


def train_decoders(dev, smi: str) -> dict:
    """Phase 4u: each of ``DECODER_TRAIN_RUNS`` at full width with its depth
    cut, params drawn by a device generator, A2Q training through
    ``build_train_step`` (``donate=True``: one copy of the state) and the
    ``Trainer`` (cosine schedule, warm-up of one step) for
    ``DECODER_TRAIN_STEPS`` steps with no kernel launched;
    the loss (and deepseek's ``mtp_ce``) must stay finite and not rise (see
    ``DECODER_FLAT_TOL``), and the reduced config must learn on the card as
    on the CPU (``reduced_learns``).  The trained tree is deployed through
    ``deploy_params`` under ``held_deploys`` (one launch an A2Q matrix, the
    MTP head's included, 0 code flips) and served: 4 requests of 64
    TokenStream tokens, 16 new, on ``PagedServeEngine`` with
    ``int_forward`` and the decode kernels (deepseek absorbed into latent
    space on ``paged_mla_attention``; rwkv6 on ``rwkv6_scan``), held to the
    deployed tree's dequant path with ``parity_up_to_ties``.  Returns the
    deploy and serve launches by model."""
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.kernels.a2q_quantize import a2q_quantize_cuda
    from repro_torch.models.lm import Runtime, apply_lm, init_lm
    from repro_torch.models.steps import build_train_step
    from repro_torch.optim.optimizers import adafactor, adamw
    from repro_torch.optim.schedules import cosine_with_warmup
    from repro_torch.serve.engine import PagedServeEngine, deploy_params, parity_up_to_ties
    from repro_torch.train.state import init_state
    from repro_torch.train.trainer import Trainer

    N, B, S = DECODER_TRAIN_STEPS, DECODER_TRAIN_BATCH, DECODER_TRAIN_SEQ
    phase(f"4u: train the MoE and recurrent decoders at full width ({N} steps of {B} x {S} "
          f"tokens), deploy, serve {DECODER_SERVE_REQUESTS} requests each")
    t_phase = time.perf_counter()
    out = {}
    for name, layers, opt_name in DECODER_TRAIN_RUNS:
        t_model = time.perf_counter()
        full = get_arch(name)
        arch = dataclasses.replace(full, stacks=(dataclasses.replace(full.stacks[0],
                                                                     count=layers),))
        q = arch.quant
        if (arch.compute_dtype, arch.param_dtype, arch.remat) != ("bfloat16", "float32", "block") \
                or q.mode != "a2q" or S % max(s.ssm.chunk if s.ssm else 1 for s in arch.stacks):
            raise AssertionError(f"{name}'s config moved: {arch}")
        tag = f"4u {name}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        opt = {"adamw": adamw, "adafactor": adafactor}[opt_name]()
        held_state = [init_state(init_lm(torch.Generator(device=dev).manual_seed(0), arch,
                                         device=dev), opt).tree()]
        n_params = sum(t.numel() for t in _leaves(held_state[0]["params"]))
        probe = TokenStream(vocab=arch.vocab, seq_len=DECODER_SERVE_PROMPT,
                            global_batch=DECODER_SERVE_REQUESTS, seed=0).batch(10_000)["tokens"]
        with torch.no_grad():
            init_logit = apply_lm(held_state[0]["params"], arch, tokens=torch.as_tensor(
                probe, device=dev))[0].abs().max().item()
        step_fn = build_train_step(arch, opt, Runtime(), lr_schedule=cosine_with_warmup(
            DECODER_TRAIN_LR, warmup=1, total=N), donate=True)
        stream = TokenStream(vocab=arch.vocab, seq_len=S, global_batch=B, seed=0)
        print(f"[{tag}] d_model {arch.d_model}, {arch.n_layers} of {full.n_layers} layers"
              f"{' + the MTP head' if arch.mtp_depth else ''}, {n_params / 1e9:.3f} B parameters, "
              f"{opt_name}; init {time.perf_counter() - t_model:.1f} s", flush=True)
        ops.set_launch_counts({k: 0 for k in ops.launch_counts()})
        t0 = time.perf_counter()
        # the trainer holds the only reference to the initial state, so the
        # first step's update frees it
        res = Trainer(step_fn, stream.batch, log_every=1).run(held_state.pop(), N)
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        train_launches = sum(ops.launch_counts().values())
        hist = res.history
        keys = ["loss", "ce", "penalty"] + (["mtp_ce"] if "mtp_ce" in hist[0] else [])
        series = {k: np.array([r[k] for r in hist]) for k in keys}
        step_ms = float(np.median([r["step_time"] for r in hist[1:]])) * 1e3
        print(f"[{tag}] {N} steps in {train_s:.1f} s: median step {step_ms:.1f} ms, "
              f"{B * S / step_ms * 1e3:.0f} train tok/s (first step "
              f"{hist[0]['step_time'] * 1e3:.0f} ms), peak memory {peak / 2**30:.2f} GiB ({smi}); "
              f"kernel launches while training {train_launches}", flush=True)
        print(f"[{tag}] " + "; ".join(
            f"{k} {series[k][:3].mean():.6f} -> {series[k][-3:].mean():.6f}" for k in keys)
              + f"; largest grad norm {max(r['grad_norm'] for r in hist):.4g}; max |logit| at "
              f"init {init_logit:.4g}", flush=True)
        for k in ("loss", "mtp_ce"):
            if k in series and not (np.isfinite(series[k]).all() and
                                    series[k][-3:].mean() <= series[k][:3].mean()
                                    + DECODER_FLAT_TOL):
                raise AssertionError(f"[{tag}] {k} not finite or rose: {series[k]}")
        if train_launches:
            raise AssertionError(f"[{tag}] training launched kernels: {ops.launch_counts()}")
        trained = res.state["params"]
        del res
        torch.cuda.empty_cache()

        matrices = _a2q_matrices(trained)
        a2q_quantize_cuda.launches = 0
        with held_deploys(tag) as held:
            params = deploy_params(trained, q)
        torch.cuda.synchronize()
        deploys = a2q_quantize_cuda.launches
        check_held(tag, held, deploys)
        if deploys != matrices or held["flips"]:
            raise AssertionError(f"[{tag}] {deploys} deploy launches for {matrices} A2Q matrices, "
                                 f"{held['flips']} code flips")
        del trained
        torch.cuda.empty_cache()

        mla = arch.stacks[0].attn is not None and arch.stacks[0].attn.kind == "mla"
        rt = Runtime(int_forward=True, decode_kernel=True, mla_absorb=mla)
        prompts = list(probe)
        kw = dict(batch=DECODER_SERVE_REQUESTS, max_seq=96, block_size=16,
                  prefill_chunk=DECODER_SERVE_PROMPT, device=dev)
        engine = PagedServeEngine(arch, params, rt=rt, **kw)
        engine.generate(prompts[:1], max_new=2)  # warm-up
        engine.reset_stats()
        torch.cuda.synchronize()
        before = ops.launch_counts()
        outs = engine.generate(prompts, max_new=DECODER_SERVE_NEW)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        d = {k: after[k] - before[k] for k in after}
        tp = engine.throughput()
        ticks = tp["decode_dispatches"]
        per_forward = _int_matmul_per_forward(arch)
        chunked = d["rwkv6_scan_cuda.chunked_launches"]
        launches = {"int_matmul": d["int_matmul_cuda.launches"],  # int8 x in (int_forward)
                    "int_matmul[tc]": d["int_matmul_cuda.tc_launches"],
                    "paged_mla_attention": d["paged_mla_attention_cuda.launches"],
                    "paged_mla_attention[tc]": d["paged_mla_attention_cuda.tc_launches"],
                    "rwkv6_scan": d["rwkv6_scan_cuda.launches"] - chunked,  # step kernel
                    "rwkv6_scan[chunked]": chunked,
                    "a2q_quantize": deploys, "a2q_quantize[flips]": held["flips"]}
        print(f"[{tag}] served: prefill {tp['prefill_tok_s']:.1f} tok/s, decode "
              f"{tp['decode_tok_s']:.1f} tok/s ({ticks} ticks); launches {launches}", flush=True)
        rwkv = arch.stacks[0].kind == "rwkv6"
        want = {"int_matmul": per_forward * (ticks + DECODER_SERVE_REQUESTS),
                "paged_mla_attention": arch.n_layers * ticks if mla else 0,
                "rwkv6_scan": arch.n_layers * ticks if rwkv else 0,  # one prefill chunk a prompt
                "rwkv6_scan[chunked]": arch.n_layers * DECODER_SERVE_REQUESTS if rwkv else 0}
        got = {k: launches[k] for k in want}
        if got != want or d["int_matmul_cuda.prologue_launches"] or \
                d["paged_attention_cuda.launches"] or \
                launches["paged_mla_attention[tc]"] != launches["paged_mla_attention"]:
            raise AssertionError(f"[{tag}] launches {launches}, expected {want}, no prologue or "
                                 "paged_attention launch and the MLA launches all on the tensor "
                                 "cores")
        toks = torch.as_tensor(np.stack(prompts), device=dev)
        with torch.no_grad():
            l_deq = apply_lm(params, arch, tokens=toks, rt=Runtime(mla_absorb=mla))[0].float()
        eps = 2.0**-6 * l_deq.abs().max().item()  # two bf16 ulps at the top of the range
        hits = float((l_deq[:, :-1].argmax(-1).cpu().numpy() ==
                      _bigram(probe[:, :-1], arch.vocab)).mean())
        del l_deq
        ref = PagedServeEngine(arch, params, rt=Runtime(mla_absorb=mla), **kw)
        ref_outs = ref.generate(prompts, max_new=DECODER_SERVE_NEW)
        ok, ties, detail = parity_up_to_ties(ref.last_requests, outs, eps)
        print(f"[{tag}] int path vs the deployed tree's dequant path: parity_up_to_ties "
              f"eps={eps:.4g} ok={ok} ties={ties} identical "
              f"{sum(a == b for a, b in zip(ref_outs, outs))}/{len(outs)}; prompts' next-token "
              f"argmax on the bigram {hits:.4f}; model {time.perf_counter() - t_model:.1f} s",
              flush=True)
        if not ok:
            raise AssertionError(f"[{tag}] parity failed: {detail}")
        for o in outs:
            if len(o) != DECODER_SERVE_NEW or not all(0 <= t < arch.vocab for t in o):
                raise AssertionError(f"[{tag}] bad output {o}")
        out[f"{name} trained (4u)"] = launches
        del engine, ref, params
        torch.cuda.empty_cache()
        reduced_learns(name, opt_name, dev)
    print(f"[4u] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def reduced_learns(name, opt_name, dev) -> None:
    """``name``'s reduced config (fp32) trained ``DECODER_CHECK_STEPS`` steps
    of ``DECODER_TRAIN_BATCH`` x ``DECODER_CHECK_SEQ`` tokens on the card and
    on the CPU from the same CPU-drawn params, as 4u trains the full width:
    the loss (and ``mtp_ce``) falls from the first three steps' mean to the
    last three's on the card, each step's figure within
    ``DECODER_CHECK_TOL`` of the CPU's, and the card's run launches no
    kernel."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.models.lm import Runtime, init_lm
    from repro_torch.models.steps import build_train_step
    from repro_torch.optim.optimizers import adafactor, adamw
    from repro_torch.optim.schedules import cosine_with_warmup
    from repro_torch.train.state import init_state
    from repro_torch.train.trainer import Trainer

    arch, N = reduced(get_arch(name)), DECODER_CHECK_STEPS
    runs = {}
    ops.set_launch_counts({k: 0 for k in ops.launch_counts()})
    for device in ("cpu", dev):
        opt = {"adamw": adamw, "adafactor": adafactor}[opt_name]()
        step_fn = build_train_step(arch, opt, Runtime(), lr_schedule=cosine_with_warmup(
            DECODER_TRAIN_LR, warmup=1, total=N), donate=True)
        state = init_state(init_lm(torch.Generator().manual_seed(0), arch, device=device),
                           opt).tree()
        stream = TokenStream(vocab=arch.vocab, seq_len=DECODER_CHECK_SEQ,
                             global_batch=DECODER_TRAIN_BATCH, seed=0)
        hist = Trainer(step_fn, stream.batch, log_every=1).run(state, N).history
        runs[str(device)] = {k: np.array([r[k] for r in hist]) for k in ("loss", "mtp_ce")
                             if k in hist[0]}
    card, cpu = runs[str(dev)], runs["cpu"]
    launches = sum(ops.launch_counts().values())
    err = max(float(np.abs(card[k] / cpu[k] - 1).max()) for k in card)
    print(f"[4u {name} reduced] card: " + "; ".join(
        f"{k} {v[:3].mean():.4f} -> {v[-3:].mean():.4f}" for k, v in card.items())
          + f"; largest relative difference from the CPU's {err:.3g}; kernel launches "
          f"{launches}", flush=True)
    if launches or not err <= DECODER_CHECK_TOL or not all(
            np.isfinite(v).all() and v[-3:].mean() < v[:3].mean() for v in card.values()):
        raise AssertionError(f"[4u {name} reduced] card {card}, CPU {cpu}, launches {launches}")


# phase 4g (PERF.md section 4): the compressed data-parallel gradient
# reduction on full-size smollm-135m, a data axis of COMPRESS_GROUPS groups on
# the one card (each group's rows' gradient taken in turn, stacked, and
# reduced through compressed_allreduce_tree: the global view the reference's
# devices compute together), adamw.  At full width the int8 runs learn
# (COMPRESS_LEARN) but do not track the uncompressed one within the
# reference's tolerance: adam moves every weight whose gradient is nonzero by
# about the lr, and the wire sends most of the embedding table's small
# gradients as 0 (their error is fed back, and sent once it grows past half a
# code); the share is printed.  The tracking is held where the reference's
# own 20-step test holds it (tests/test_sharding.py,
# test_compressed_grad_training_tracks_uncompressed: reduced smollm-135m, 8
# devices of one row of 32 tokens, adamw at 2e-3): COMPRESS_REF, on the card
COMPRESS_GROUPS, COMPRESS_STEPS, COMPRESS_BATCH, COMPRESS_SEQ = 4, 12, 8, 512
COMPRESS_LR, COMPRESS_TOL, COMPRESS_LEARN = 3e-3, 0.05, 0.5  # nat
COMPRESS_REF = dict(groups=8, steps=20, batch=8, seq=32, lr=2e-3)
COMPRESS_LAYERS = 6  # of smollm-135m's 30: a depth cut for the script's time (PERF.md section 4)
COMPRESS_SERVE_REQUESTS, COMPRESS_SERVE_NEW = 4, 16
# the wire held bit for bit, card against the CPU port: stacked gradients of
# smollm-135m's leaf shapes on a (data=4, model=1) mesh, each spec giving
# another owner dim: (name, shape, spec)
WIRE_LEAVES = (
    ("one layer's mlp.w_in.v (FSDP owner dim)", (576, 1536), ("data", "model")),
    ("attn.wk.t over 30 layers (first free dim)", (30, 192), ("model", None)),
    ("mlp.w_out.t over 30 layers (owner dim padded to 32)", (30, 576), None),
    ("three rows of the head's width (column owner dim padded)", (3, 49150), ("model", None)),
    ("aq.log2_scale over 30 layers (rank 1)", (30,), None),
    ("a scalar", (), None),
)
WIRE_ROUNDS = 3


def wire_on_card(dev) -> dict:
    """``compressed_allreduce_tree`` on the card against the CPU port, fed
    the same stacked numpy gradients (``WIRE_LEAVES``, seed 0) through
    ``WIRE_ROUNDS`` rounds of error feedback, at bits 8 and 16 on the tensor
    and column scales: every leaf's codes (phase 1 and the requantized phase
    2, read where the port quantizes), totals and both residuals bit for
    bit.  Returns the codes compared."""
    from repro_torch.dist import collectives
    from repro_torch.dist.collectives import compressed_allreduce_tree, owner_dim, server_shape
    from repro_torch.dist.sharding import Mesh

    n = COMPRESS_GROUPS
    rng = np.random.default_rng(0)
    grads = [{name: (rng.standard_normal((n,) + shape) * 10.0 ** rng.integers(-4, 0, (n,) + (
        1,) * len(shape))).astype(np.float32) for name, shape, _ in WIRE_LEAVES}
        for _ in range(WIRE_ROUNDS)]
    specs = {name: spec for name, _, spec in WIRE_LEAVES}
    compared, orig = 0, collectives._quantize
    for bits in (8, 16):
        for scale in ("tensor", "column"):
            outs = {}
            for device in ("cpu", dev):
                rec: list = []
                collectives._quantize = lambda *a: rec.append(orig(*a)) or rec[-1]
                mesh = Mesh.on_device(device, data=n, model=1)
                err = {"local": {k: torch.zeros((n,) + s, device=device)
                                 for k, s, _ in WIRE_LEAVES},
                       "server": {k: torch.zeros(server_shape(s, n, owner_dim(p, len(s), "data")),
                                                 device=device) for k, s, p in WIRE_LEAVES}}
                got = []
                try:
                    for g in grads:
                        rec.clear()
                        total, err = compressed_allreduce_tree(
                            {k: torch.from_numpy(v).to(device) for k, v in g.items()}, err,
                            mesh=mesh, axis="data", bits=bits, scale_axis=scale, pspec_tree=specs)
                        got.append(([c.cpu() for c in rec], {k: v.cpu() for k, v in total.items()},
                                    {p: {k: v.cpu() for k, v in err[p].items()}
                                     for p in ("local", "server")}))
                finally:
                    collectives._quantize = orig
                outs[str(device)] = got
            for r, (cpu, card) in enumerate(zip(outs["cpu"], outs[str(dev)])):
                same = all(torch.equal(a, b) for a, b in zip(cpu[0], card[0])) and \
                    len(cpu[0]) == len(card[0]) == 2 * len(WIRE_LEAVES) and \
                    all(torch.equal(cpu[1][k], card[1][k]) for k in cpu[1]) and \
                    all(torch.equal(cpu[2][p][k], card[2][p][k]) for p in cpu[2] for k in cpu[2][p])
                if not same:
                    raise AssertionError(f"[4g wire] int{bits} {scale} round {r}: the card's codes, "
                                         "totals or residuals are not the CPU port's bit for bit")
                compared += sum(c.numel() for c in cpu[0])
    print(f"[4g wire] compressed_allreduce_tree on the card vs the CPU port, {len(WIRE_LEAVES)} "
          f"smollm-shaped leaves x {n} groups, {WIRE_ROUNDS} rounds of error feedback, int8 and "
          f"int16, tensor and column scales: {compared} codes, the totals and both residuals bit "
          "for bit", flush=True)
    return {"codes": compared}


def _serve_trained(tag, arch, params, dev, prompts, max_new, rt_kw) -> dict:
    """``params`` (deployed) served on ``PagedServeEngine`` with
    ``int_forward`` and the decode kernel (one prefill chunk a prompt),
    held to the dequant path's engine with ``parity_up_to_ties``; returns
    the launches by kernel entry and the throughput."""
    from repro_torch.kernels import ops
    from repro_torch.models.lm import Runtime, apply_lm
    from repro_torch.serve.engine import PagedServeEngine, parity_up_to_ties

    chunk = max(len(p) for p in prompts)
    kw = dict(batch=len(prompts), max_seq=-(-(chunk + max_new) // 16) * 16, block_size=16,
              prefill_chunk=chunk, device=dev)
    engine = PagedServeEngine(arch, params, rt=Runtime(int_forward=True, decode_kernel=True,
                                                       **rt_kw), **kw)
    engine.generate(prompts[:1], max_new=2)  # warm-up
    engine.reset_stats()
    torch.cuda.synchronize()
    before = ops.launch_counts()
    outs = engine.generate(prompts, max_new=max_new)
    torch.cuda.synchronize()
    d = {k: v - before[k] for k, v in ops.launch_counts().items()}
    tp = engine.throughput()
    ticks = tp["decode_dispatches"]
    launches = {"int_matmul": d["int_matmul_cuda.launches"],
                "int_matmul[tc]": d["int_matmul_cuda.tc_launches"],
                "paged_attention": d["paged_attention_cuda.launches"]}
    per_forward = 7 * arch.n_layers + (0 if arch.tie_embeddings else 1)  # a tied head: a matmul
    want = {"int_matmul": per_forward * (ticks + len(prompts)),
            "paged_attention": arch.n_layers * ticks}
    toks = torch.as_tensor(np.stack(prompts), device=dev)
    with torch.no_grad():
        l_deq = apply_lm(params, arch, tokens=toks)[0].float()
    eps = 2.0**-6 * l_deq.abs().max().item()  # two bf16 ulps at the top of the logit range
    del l_deq
    ref = PagedServeEngine(arch, params, rt=Runtime(**rt_kw), **kw)
    ref_outs = ref.generate(prompts, max_new=max_new)
    ok, ties, detail = parity_up_to_ties(ref.last_requests, outs, eps)
    print(f"[{tag}] served {len(prompts)} requests: prefill {tp['prefill_tok_s']:.1f} tok/s, "
          f"decode {tp['decode_tok_s']:.1f} tok/s ({ticks} ticks); launches {launches}; int path "
          f"vs the deployed tree's dequant path: parity_up_to_ties eps={eps:.4g} ok={ok} "
          f"ties={ties} identical {sum(a == b for a, b in zip(ref_outs, outs))}/{len(outs)}",
          flush=True)
    if {k: launches[k] for k in want} != want or d["int_matmul_cuda.prologue_launches"]:
        raise AssertionError(f"[{tag}] launches {launches}, expected {want} and no prologue")
    if not ok:
        raise AssertionError(f"[{tag}] parity failed: {detail}")
    for o in outs:
        if len(o) != max_new or not all(0 <= t < arch.vocab for t in o):
            raise AssertionError(f"[{tag}] bad output {o}")
    del engine, ref
    return launches


def wire_zeros(dev, arch, mesh, rules, batch) -> None:
    """The first batch's stacked group gradients at the seed-0 init through
    one ``compressed_allreduce_tree`` (zero residuals) a scale: the share of
    the elements with a nonzero fp32 sum that the wire sends as 0, over the
    whole tree and on the embedding table."""
    from repro_torch.dist.collectives import compressed_allreduce_tree
    from repro_torch.dist.sharding import param_specs
    from repro_torch.models.lm import init_lm, lm_loss
    from repro_torch.nn.module import tree_leaves_with_path, tree_map
    from repro_torch.train.state import init_grad_err

    G = int(mesh.shape["data"])
    params = init_lm(torch.Generator(device=dev).manual_seed(0), arch, device=dev)
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    per = next(iter(b.values())).shape[0] // G
    paths = [p for p, _ in tree_leaves_with_path(params)]
    rows = []
    for i in range(G):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = lm_loss(live, arch, {k: v[i * per:(i + 1) * per] for k, v in b.items()})
        by_path = dict(tree_leaves_with_path(live))
        leaves = [by_path[p] for p in paths]
        rows.append(torch.autograd.grad(loss, leaves, materialize_grads=True))
        del live, loss
    stacked = {"/".join(p): torch.stack([r[j] for r in rows]) / G for j, p in enumerate(paths)}
    del rows
    pspecs = param_specs(params, mesh, rules)
    specs = {"/".join(p): s for p, s in tree_leaves_with_path(pspecs)}
    fp32 = {k: v.sum(0) for k, v in stacked.items()}
    line = []
    for scale in ("tensor", "column"):
        err = init_grad_err(fp32, G, pspecs=specs, axis="data")
        total, _ = compressed_allreduce_tree(stacked, err, mesh=mesh, axis="data", bits=8,
                                             scale_axis=scale, pspec_tree=specs)
        live_n = sum(int((fp32[k] != 0).sum()) for k in fp32)
        zeroed = sum(int(((fp32[k] != 0) & (total[k] == 0)).sum()) for k in fp32)
        emb = "embed/table"
        e_live = int((fp32[emb] != 0).sum())
        e_zero = int(((fp32[emb] != 0) & (total[emb] == 0)).sum())
        line.append(f"{scale}: {zeroed / live_n:.4f} of {live_n} (embed.table {e_zero / e_live:.4f}"
                    f" of {e_live})")
    print("[4g wire zeros] the first batch's nonzero fp32 gradient elements sent as 0 by the int8 "
          "wire at the seed-0 init: " + "; ".join(line), flush=True)
    del stacked, fp32, params
    torch.cuda.empty_cache()


def compressed_tracks_on_reduced(dev) -> None:
    """The reference's own test (``COMPRESS_REF``) on the card: reduced
    smollm-135m from a CPU-drawn seed-0 init, ``groups`` groups of the
    batch, adamw at a constant lr, uncompressed and int8 ``tensor`` and
    ``column``: each learns 0.5 nat, every compressed loss within
    ``COMPRESS_TOL`` of the uncompressed one, both residual trees nonzero.
    Returns the int8 tensor run's final state."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.dist.collectives import GradCompressConfig
    from repro_torch.dist.sharding import Mesh, ShardingRules, param_specs
    from repro_torch.models.lm import Runtime, init_lm
    from repro_torch.models.steps import build_train_step
    from repro_torch.nn.module import tree_leaves_with_path, tree_map, tree_to
    from repro_torch.optim.optimizers import adamw
    from repro_torch.train.state import init_grad_err, init_state
    from repro_torch.train.trainer import Trainer

    c = COMPRESS_REF
    arch = reduced(get_arch("smollm-135m"))
    mesh = Mesh.on_device(dev, data=c["groups"])
    rules = ShardingRules.default(mesh, arch)
    init = tree_to(init_lm(torch.Generator().manual_seed(0), arch, device="cpu"), dev)
    stream = TokenStream(vocab=arch.vocab, seq_len=c["seq"], global_batch=c["batch"])
    runs, line = {}, []
    for label, gc in (("uncompressed", None), ("int8 tensor", GradCompressConfig(8, "tensor")),
                      ("int8 column", GradCompressConfig(8, "column"))):
        params = tree_map(torch.clone, init)
        opt = adamw()
        state = init_state(params, opt).tree()
        rt = Runtime(mesh=mesh, rules=rules, grad_compress=gc)
        if gc is not None:
            state["grad_err"] = init_grad_err(params, c["groups"],
                                              pspecs=param_specs(params, mesh, rules), axis="data")
        step = build_train_step(arch, opt, rt, lr_schedule=lambda s: torch.full(
            (), c["lr"], dtype=torch.float32, device=dev))
        res = Trainer(step, stream.batch, log_every=1).run(state, c["steps"])
        losses = runs[label] = np.array([r["loss"] for r in res.history])
        if label == "int8 tensor":
            kept = res.state
        if not (np.isfinite(losses).all() and losses[-1] < losses[0] - 0.5):
            raise AssertionError(f"[4g reduced {label}] did not learn: {losses}")
        if gc is not None:
            diff = float(np.abs(losses - runs["uncompressed"]).max())
            nz = [sum(float(t.abs().sum()) for _, t in
                      tree_leaves_with_path(res.state["grad_err"][p])) for p in ("local", "server")]
            line.append(f"{label} {diff:.4g} nat (residual sums {nz[0]:.4g}, {nz[1]:.4g})")
            if not (diff < COMPRESS_TOL and min(nz) > 0):
                raise AssertionError(f"[4g reduced {label}] off the uncompressed losses by {diff} "
                                     f"(tolerance {COMPRESS_TOL}) or a residual tree is zero {nz}")
    print(f"[4g reduced] the reference's test on the card (reduced smollm-135m, {c['groups']} "
          f"groups of {c['batch'] // c['groups']} x {c['seq']} tokens, adamw {c['lr']}, "
          f"{c['steps']} steps): uncompressed loss {runs['uncompressed'][0]:.4f} -> "
          f"{runs['uncompressed'][-1]:.4f}; largest |loss - uncompressed| " + "; ".join(line)
          + f" (tolerance {COMPRESS_TOL})", flush=True)
    return kept


def train_compressed(dev, smi: str) -> dict:
    """Phase 4g: smollm-135m at full width (``COMPRESS_LAYERS`` layers) trained ``COMPRESS_STEPS`` steps of
    ``COMPRESS_BATCH`` x ``COMPRESS_SEQ`` ``TokenStream`` tokens from one
    seed-0 init three times: uncompressed (``Runtime()``), then through the
    compressed step (``Runtime(mesh, rules, grad_compress)`` with a data
    axis of ``COMPRESS_GROUPS`` on the card) on the int8 ``tensor`` and the
    int8 ``column`` scale.  Step ms, train tok/s, peak memory, the largest
    |loss - uncompressed| and the share of the first batch's nonzero
    gradient elements the wire sends as 0; each run learning
    ``COMPRESS_LEARN`` nat, both residual trees nonzero, no kernel
    launched.  The reference's own tracking test on the card
    (``compressed_tracks_on_reduced``: every compressed loss within
    ``COMPRESS_TOL`` of the uncompressed one), whose int8 tensor state goes
    through a checkpoint (the residual pair bit for bit; an uncompressed
    checkpoint restored into it with ``allow_missing``); the wire against
    the CPU port (``wire_on_card``); then the full-size tensor run's params
    deployed through ``a2q_quantize`` (held, 0 flips) and served on
    ``int_matmul``.  Returns the deploy and serve launches."""
    import shutil

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.dist.collectives import GradCompressConfig
    from repro_torch.dist.sharding import Mesh, ShardingRules, param_specs
    from repro_torch.kernels import ops
    from repro_torch.kernels.a2q_quantize import a2q_quantize_cuda
    from repro_torch.models.lm import Runtime, init_lm
    from repro_torch.models.steps import build_train_step
    from repro_torch.nn.module import tree_leaves_with_path, tree_map
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.schedules import cosine_with_warmup
    from repro_torch.serve.engine import deploy_params
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.state import init_grad_err, init_state
    from repro_torch.train.trainer import Trainer

    full = get_arch("smollm-135m")
    arch = dataclasses.replace(full, stacks=(dataclasses.replace(full.stacks[0],
                                                                 count=COMPRESS_LAYERS),))
    G, N, B, S = COMPRESS_GROUPS, COMPRESS_STEPS, COMPRESS_BATCH, COMPRESS_SEQ
    phase(f"4g: smollm-135m ({arch.n_layers} of {full.n_layers} layers) trained {N} steps of "
          f"{B} x {S} tokens, uncompressed and with the int8 gradient wire over a data axis of "
          f"{G} groups on the card (tensor, column); checkpoint, deploy, serve")
    t_phase = time.perf_counter()
    mesh = Mesh.on_device(dev, data=G)
    rules = ShardingRules.default(mesh, arch)
    stream = TokenStream(vocab=arch.vocab, seq_len=S, global_batch=B, seed=0)
    runs, trained = {}, None
    for label, gc in (("uncompressed", None), ("int8 tensor", GradCompressConfig(8, "tensor")),
                      ("int8 column", GradCompressConfig(8, "column"))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = init_lm(torch.Generator(device=dev).manual_seed(0), arch, device=dev)
        opt = adamw()
        state = init_state(params, opt).tree()
        rt = Runtime()
        if gc is not None:
            state["grad_err"] = init_grad_err(params, G, pspecs=param_specs(params, mesh, rules),
                                              axis="data")
            rt = Runtime(mesh=mesh, rules=rules, grad_compress=gc)
        del params
        step_fn = build_train_step(arch, opt, rt, lr_schedule=cosine_with_warmup(
            COMPRESS_LR, warmup=1, total=N))
        ops.set_launch_counts({k: 0 for k in ops.launch_counts()})
        t0 = time.perf_counter()
        res = Trainer(step_fn, stream.batch, log_every=1).run(state, N)
        del state
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launched = sum(ops.launch_counts().values())
        losses = np.array([r["loss"] for r in res.history])
        step_ms = float(np.median([r["step_time"] for r in res.history[1:]])) * 1e3
        runs[label] = losses
        extra = ""
        if gc is not None:
            mags = {p: sum(float(t.abs().sum()) for _, t in
                           tree_leaves_with_path(res.state["grad_err"][p]))
                    for p in ("local", "server")}
            extra = (f"; residual sums local {mags['local']:.4g}, server {mags['server']:.4g}; "
                     f"largest |loss - uncompressed| "
                     f"{np.abs(losses - runs['uncompressed']).max():.4g} nat (not gated at full "
                     "width: see COMPRESS_REF)")
            if not min(mags.values()) > 0:
                raise AssertionError(f"[4g {label}] a residual tree is all zeros: {mags}")
        print(f"[4g {label}] {N} steps in {train_s:.1f} s: median step {step_ms:.1f} ms, "
              f"{B * S / step_ms * 1e3:.0f} train tok/s (first step "
              f"{res.history[0]['step_time'] * 1e3:.0f} ms), peak memory {peak / 2**30:.2f} GiB "
              f"({smi}); loss {losses[0]:.4f} -> {losses[-1]:.4f}; kernel launches while "
              f"training {launched}{extra}", flush=True)
        if launched or not np.isfinite(losses).all() or \
                not losses[-1] <= losses[0] - COMPRESS_LEARN:
            raise AssertionError(f"[4g {label}] losses {losses}, launches {launched}")
        if label == "int8 tensor":
            trained = res.state["params"]
        del res
        torch.cuda.empty_cache()

    wire_zeros(dev, arch, mesh, rules, stream.batch(1))
    kept = compressed_tracks_on_reduced(dev)
    d = str(Path(__file__).resolve().parent / "build" / "smoke_ckpt_4g")
    shutil.rmtree(d, ignore_errors=True)
    ckpt.save(d + "/a", kept, N)

    def like():
        s = init_state(tree_map(torch.zeros_like, kept["params"]), adamw()).tree()
        s["grad_err"] = tree_map(torch.zeros_like, kept["grad_err"])
        return s

    restored, at = ckpt.restore(d + "/a", like())
    same = at == N and all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves_with_path(restored), tree_leaves_with_path(kept)))
    ckpt.save(d + "/b", {k: v for k, v in kept.items() if k != "grad_err"}, N)
    plain, _ = ckpt.restore(d + "/b", like(), allow_missing=True)
    zeros = sum(float(t.abs().sum()) for _, t in tree_leaves_with_path(plain["grad_err"]))
    try:
        ckpt.restore(d + "/b", like())
        refused = False
    except KeyError:
        refused = True
    shutil.rmtree(d, ignore_errors=True)
    print(f"[4g checkpoint] the reduced int8 tensor run's state (residual pair included) on the "
          f"card restored bit for "
          f"bit {same}; an uncompressed checkpoint restored with allow_missing: residuals "
          f"{zeros} (zero), refused without it {refused}", flush=True)
    if not (same and zeros == 0 and refused):
        raise AssertionError("[4g checkpoint] the residual pair did not survive a checkpoint")
    del restored, plain, kept
    wire_on_card(dev)

    tag = "4g smollm-135m compressed"
    a2q_quantize_cuda.launches = 0
    with held_deploys(tag) as held:
        params = deploy_params(trained, arch.quant)
    torch.cuda.synchronize()
    deploys = a2q_quantize_cuda.launches
    check_held(tag, held, deploys)
    if deploys != 7 * arch.n_layers or held["flips"]:
        raise AssertionError(f"[{tag}] {deploys} deploy launches, {held['flips']} code flips")
    del trained
    prompts = list(TokenStream(vocab=arch.vocab, seq_len=64, global_batch=COMPRESS_SERVE_REQUESTS,
                               seed=0).batch(10_000)["tokens"])
    launches = _serve_trained(tag, arch, params, dev, prompts, COMPRESS_SERVE_NEW, {})
    launches.update({"a2q_quantize": deploys, "a2q_quantize[flips]": held["flips"]})
    del params
    torch.cuda.empty_cache()
    print(f"[4g] launches {launches}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"smollm-135m compressed-gradient trained (4g)": launches}


# phase 4w (PERF.md section 4): the frontend families trained at full width
# with A2Q, FRONTEND_TRAIN_STEPS steps through build_train_step(donate=True):
# hubert-xlarge on HUBERT_TRAIN clips of seed-made frames with framewise
# targets, llava-next-34b on LLAVA_TRAIN rows of seed-made patches ahead of
# TokenStream text, targets over the whole sequence.  A frame's (a patch's)
# target is the argmax of its first n_classes (FRONTEND_PATCH_CLASSES)
# dims, a class a linear read-out can learn.  As in 4u, a full-width A2Q
# model from the reference's init does not move its loss in 12 steps: the
# full-width losses are held finite and not rising by more than
# DECODER_FLAT_TOL, and learning to the reduced configs, card against CPU
FRONTEND_TRAIN_STEPS, FRONTEND_TRAIN_LR = 12, 3e-3
HUBERT_TRAIN = (4, 1000)  # clips x frames a step
HUBERT_TRAIN_LAYERS = 48  # of 48: no depth cut
LLAVA_TRAIN = (2, 64)  # rows x text tokens a step, behind the 576 patches
LLAVA_TRAIN_LAYERS = 2  # of 60: two layers, 2.05 B parameters, train with adamw
FRONTEND_PATCH_CLASSES = 64
FRONTEND_CHECK = (4, 64)  # reduced runs: rows x positions a step


def frontend_batch(arch, step: int, rows: int, text: int, frames: int = 0, seed: int = 0) -> dict:
    """One numpy step of a frontend family: ``frontend_embeds`` (float32,
    normal, from ``seed`` and ``step``) with the argmax of each position's
    first ``n_classes`` (audio) or ``FRONTEND_PATCH_CLASSES`` (vlm) dims as
    its target; a vlm's ``TokenStream`` text of ``text`` tokens behind its
    patches, the text's own targets behind the patches'."""
    rng = np.random.default_rng([seed, step])
    if arch.family == "audio":
        x = rng.standard_normal((rows, frames, arch.d_model), dtype=np.float32)
        return {"frontend_embeds": x,
                "targets": x[..., :arch.n_classes].argmax(-1).astype(np.int32)}
    si = arch.frontend.seq_len
    x = rng.standard_normal((rows, si, arch.d_model), dtype=np.float32)
    text_batch = _text_stream(arch.vocab, text, rows, seed).batch(step)
    return {"frontend_embeds": x, "tokens": text_batch["tokens"],
            "targets": np.concatenate([x[..., :FRONTEND_PATCH_CLASSES].argmax(-1).astype(
                np.int32), text_batch["targets"]], axis=1)}


def _text_stream(vocab, seq_len, rows, seed):
    from repro_torch.data.synthetic import TokenStream

    return TokenStream(vocab=vocab, seq_len=seq_len, global_batch=rows, seed=seed)


def train_frontends(dev, smi: str) -> dict:
    """Phase 4w: hubert-xlarge (``HUBERT_TRAIN_LAYERS`` layers) and
    llava-next-34b (``LLAVA_TRAIN_LAYERS`` of 60) at full width, params from
    a device generator, ``FRONTEND_TRAIN_STEPS`` adamw steps through
    ``build_train_step(donate=True)`` and the ``Trainer``: step ms, train
    tok/s, peak memory, first-3 and last-3 mean loss (finite and not rising
    by more than ``DECODER_FLAT_TOL``), 0 kernel launches; each trained tree
    deployed under ``held_deploys`` (one launch an A2Q matrix, 0 flips);
    hubert encodes 2 clips on ``int_chain`` (every attention on
    ``flash_attention``, every linear on ``int_matmul``, ``mlp.w_in``'s gelu
    requant); llava prefills its patches and text on ``int_chain``
    (``flash_attention``, ``int_matmul``) and serves 4 text requests on the
    paged engine (``paged_attention``, ``int_matmul``); then each reduced
    config learns on the card as on the CPU (``frontend_learns``).  Returns
    the launches by model."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.a2q_quantize import a2q_quantize_cuda
    from repro_torch.models.lm import Runtime, apply_lm, init_lm
    from repro_torch.models.steps import build_prefill_step, build_train_step
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.schedules import cosine_with_warmup
    from repro_torch.serve.engine import deploy_params
    from repro_torch.train.state import init_state
    from repro_torch.train.trainer import Trainer

    N = FRONTEND_TRAIN_STEPS
    phase(f"4w: train hubert-xlarge ({HUBERT_TRAIN_LAYERS} layers, {HUBERT_TRAIN[0]} x "
          f"{HUBERT_TRAIN[1]} frames) and llava-next-34b ({LLAVA_TRAIN_LAYERS} of 60 layers, "
          f"{LLAVA_TRAIN[0]} x (576 patches + {LLAVA_TRAIN[1]} tokens)) at full width, {N} steps; "
          "deploy, encode and serve")
    t_phase = time.perf_counter()
    out = {}
    for name, layers in (("hubert-xlarge", HUBERT_TRAIN_LAYERS),
                         ("llava-next-34b", LLAVA_TRAIN_LAYERS)):
        t_model = time.perf_counter()
        full = get_arch(name)
        arch = dataclasses.replace(full, stacks=(dataclasses.replace(full.stacks[0],
                                                                     count=layers),))
        q = arch.quant
        if (arch.compute_dtype, arch.param_dtype, arch.remat) != ("bfloat16", "float32", "block") \
                or q.mode != "a2q":
            raise AssertionError(f"{name}'s config moved: {arch}")
        tag = f"4w {name}"
        audio = arch.family == "audio"
        rows = HUBERT_TRAIN[0] if audio else LLAVA_TRAIN[0]
        batch_fn = (lambda i: frontend_batch(arch, i, HUBERT_TRAIN[0], 0, HUBERT_TRAIN[1])) \
            if audio else (lambda i: frontend_batch(arch, i, LLAVA_TRAIN[0], LLAVA_TRAIN[1]))
        tokens_a_step = rows * (HUBERT_TRAIN[1] if audio else arch.frontend.seq_len
                                + LLAVA_TRAIN[1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        opt = adamw()
        held_state = [init_state(init_lm(torch.Generator(device=dev).manual_seed(0), arch,
                                         device=dev), opt).tree()]
        n_params = sum(t.numel() for t in _leaves(held_state[0]["params"]))
        step_fn = build_train_step(arch, opt, Runtime(), lr_schedule=cosine_with_warmup(
            FRONTEND_TRAIN_LR, warmup=1, total=N), donate=True)
        print(f"[{tag}] d_model {arch.d_model}, {arch.n_layers} of {full.n_layers} layers, "
              f"{n_params / 1e9:.3f} B parameters, adamw; init "
              f"{time.perf_counter() - t_model:.1f} s", flush=True)
        ops.set_launch_counts({k: 0 for k in ops.launch_counts()})
        t0 = time.perf_counter()
        res = Trainer(step_fn, batch_fn, log_every=1).run(held_state.pop(), N)
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        train_launches = sum(ops.launch_counts().values())
        hist = res.history
        series = {k: np.array([r[k] for r in hist]) for k in ("loss", "ce", "penalty")}
        step_ms = float(np.median([r["step_time"] for r in hist[1:]])) * 1e3
        print(f"[{tag}] {N} steps of {tokens_a_step} positions in {train_s:.1f} s: median step "
              f"{step_ms:.1f} ms, {tokens_a_step / step_ms * 1e3:.0f} train tok/s (first step "
              f"{hist[0]['step_time'] * 1e3:.0f} ms), peak memory {peak / 2**30:.2f} GiB ({smi}); "
              f"kernel launches while training {train_launches}; " + "; ".join(
                  f"{k} {v[:3].mean():.6f} -> {v[-3:].mean():.6f}" for k, v in series.items())
              + f"; largest grad norm {max(r['grad_norm'] for r in hist):.4g}", flush=True)
        loss = series["loss"]
        if not (np.isfinite(loss).all() and loss[-3:].mean() <= loss[:3].mean()
                + DECODER_FLAT_TOL):
            raise AssertionError(f"[{tag}] loss not finite or rose: {loss}")
        if train_launches:
            raise AssertionError(f"[{tag}] training launched kernels: {ops.launch_counts()}")
        trained = res.state["params"]
        del res
        torch.cuda.empty_cache()

        matrices = _a2q_matrices(trained)
        a2q_quantize_cuda.launches = 0
        with held_deploys(tag) as held:
            params = deploy_params(trained, q)
        torch.cuda.synchronize()
        deploys = a2q_quantize_cuda.launches
        check_held(tag, held, deploys)
        if deploys != matrices or held["flips"]:
            raise AssertionError(f"[{tag}] {deploys} deploy launches for {matrices} A2Q matrices, "
                                 f"{held['flips']} code flips")
        del trained
        torch.cuda.empty_cache()
        launches = {"a2q_quantize": deploys, "a2q_quantize[flips]": held["flips"]}
        n = arch.n_layers
        ref_batch = frontend_batch(arch, 10_000, 2, LLAVA_TRAIN[1], HUBERT_TRAIN[1])
        x = {k: torch.as_tensor(v, device=dev) for k, v in ref_batch.items() if k != "targets"}
        x["frontend_embeds"] = x["frontend_embeds"].to(torch.bfloat16)
        step = build_prefill_step(arch, Runtime(int_chain=True))
        step(params, x)  # warm-up
        torch.cuda.synchronize()
        before = ops.launch_counts()
        rt = Runtime(int_chain=True)
        logits = apply_lm(params, arch, tokens=x.get("tokens"),
                          frontend_embeds=x["frontend_embeds"], rt=rt)[0]
        torch.cuda.synchronize()
        d = {k: v - before[k] for k, v in ops.launch_counts().items()}
        per_forward = (6 if audio else 7) * n + 1
        want = {"int_matmul_cuda.launches": per_forward,
                "int_matmul_cuda.prologue_launches": per_forward - (n if audio else 0),
                "int_matmul_cuda.requant_launches": n if audio else 0,
                "int_matmul_cuda.tc_launches": per_forward,
                "flash_attention_cuda.launches": n, "flash_attention_cuda.tc_launches": n}
        got = {k: d[k] for k in want}
        with torch.no_grad():
            l_deq = apply_lm(params, arch, tokens=x.get("tokens"),
                             frontend_embeds=x["frontend_embeds"])[0].float()
        lf = logits.float()
        agree = float((lf.argmax(-1) == l_deq.argmax(-1)).float().mean())
        print(f"[{tag}] {'encode' if audio else 'patch prefill'} of 2 x "
              f"{x['frontend_embeds'].shape[1] + (LLAVA_TRAIN[1] if not audio else 0)} positions on "
              f"--int-chain: launches {got}; chain report folded {len(rt.chain_report['folded'])}, "
              f"chained {len(rt.chain_report['chained'])}, standalone "
              f"{len(rt.chain_report['standalone'])}; logits {tuple(lf.shape)}, max |diff| from "
              f"the dequant path {(lf - l_deq).abs().max().item():.4g} (max |logit| "
              f"{l_deq.abs().max().item():.4g}), argmax agreement {agree:.4f}", flush=True)
        if got != want or not torch.isfinite(lf).all() or rt.chain_report["standalone"]:
            raise AssertionError(f"[{tag}] launches {got}, expected {want}; finite "
                                 f"{bool(torch.isfinite(lf).all())}; chain {rt.chain_report}")
        del logits, l_deq, lf
        if audio:  # w_out takes w_in's requantized codes: int8 x in
            launches.update({"int_matmul[gelu requant]": n, "int_matmul": n,
                             "int_matmul[prologue]": per_forward - n, "int_matmul[tc]": per_forward,
                             "flash_attention": n, "flash_attention[tc]": n})
        else:
            launches.update({"int_matmul[prologue]": per_forward, "int_matmul[tc]": per_forward,
                             "flash_attention": n, "flash_attention[tc]": n})
            prompts = list(_text_stream(arch.vocab, 64, 4, 0).batch(10_000)["tokens"])
            served = _serve_trained(tag, arch, params, dev, prompts, 16, {})
            for k, v in served.items():
                launches[k] = launches.get(k, 0) + v
        del params
        torch.cuda.empty_cache()
        print(f"[{tag}] launches {launches}; model {time.perf_counter() - t_model:.1f} s",
              flush=True)
        out[f"{name} trained (4w)"] = launches
        frontend_learns(name, dev)
    print(f"[4w] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def frontend_learns(name, dev) -> None:
    """``name``'s reduced config (fp32) trained ``FRONTEND_TRAIN_STEPS``
    adamw steps of ``FRONTEND_CHECK`` frontend batches (``frontend_batch``)
    on the card and on the CPU from the same CPU-drawn params, as 4w trains
    the full width: the loss falls from the first three steps' mean to the
    last three's on the card, each step within ``DECODER_CHECK_TOL`` of the
    CPU's, and the card's run launches no kernel."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import ops
    from repro_torch.models.lm import Runtime, init_lm
    from repro_torch.models.steps import build_train_step
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.schedules import cosine_with_warmup
    from repro_torch.train.state import init_state
    from repro_torch.train.trainer import Trainer

    arch, N = reduced(get_arch(name)), FRONTEND_TRAIN_STEPS
    rows, pos = FRONTEND_CHECK
    if arch.family == "audio":
        batch_fn = lambda i: frontend_batch(arch, i, rows, 0, pos)  # noqa: E731
    else:
        batch_fn = lambda i: frontend_batch(arch, i, rows, pos - arch.frontend.seq_len)  # noqa
    runs = {}
    ops.set_launch_counts({k: 0 for k in ops.launch_counts()})
    for device in ("cpu", dev):
        opt = adamw()
        step_fn = build_train_step(arch, opt, Runtime(), lr_schedule=cosine_with_warmup(
            FRONTEND_TRAIN_LR, warmup=1, total=N), donate=True)
        state = init_state(init_lm(torch.Generator().manual_seed(0), arch, device=device),
                           opt).tree()
        hist = Trainer(step_fn, batch_fn, log_every=1).run(state, N).history
        runs[str(device)] = np.array([r["loss"] for r in hist])
    card, cpu = runs[str(dev)], runs["cpu"]
    launches = sum(ops.launch_counts().values())
    err = float(np.abs(card / cpu - 1).max())
    print(f"[4w {name} reduced] card: loss {card[:3].mean():.4f} -> {card[-3:].mean():.4f}; "
          f"largest relative difference from the CPU's {err:.3g}; kernel launches {launches}",
          flush=True)
    if launches or not err <= DECODER_CHECK_TOL or not (
            np.isfinite(card).all() and card[-3:].mean() < card[:3].mean()):
        raise AssertionError(f"[4w {name} reduced] card {card}, CPU {cpu}, launches {launches}")


# phase 4i (PERF.md section 4): the paper's A2Q widths M = N = 6 at P = 16, the
# fig scripts' batch of 64 CIFAR-shaped images (benchmarks/fig4_pareto.py) and
# 16 BSD-shaped 48 x 48 patches.  As in the paper (App. B) and the fig scripts'
# requantized_init, each A2Q network starts from its float counterpart
# (VISION_STEPS float steps, then requantize_from_float): from its own init,
# A2Q MobileNetV1 at width 1.0 did not learn in 20 steps at any adamw lr from
# 5e-3 to 5e-2 (PERF.md, PR 26).  A deployed forward within VISION_DEPLOY_TOL
# of the largest |y| of the fake-quant forward (the same weights bit for bit:
# 0 expected, the margin for a conv algorithm cuDNN might choose otherwise)
VISION_STEPS = 20
VISION_Q = dict(mode="a2q", weight_bits=6, act_bits=6, acc_bits=16)
VISION_RUNS = (  # (model, init kwargs, lr)
    ("mobilenetv1", {"width": 1.0}, 5e-3), ("resnet18", {"width": 1.0}, 5e-3),
    ("espcn", {}, 1e-3), ("unet", {"base": 32}, 1e-3))
VISION_DEPLOY_TOL = 1e-5


def _deployed_layers(tree, model, top=None):
    """``(node, boundary)`` of every deployed layer of a vision tree."""
    from repro_torch.models.vision import BOUNDARY_LAYERS

    if isinstance(tree, dict):
        if "q8" in tree:
            yield tree, top in BOUNDARY_LAYERS[model]
            return
        for k, v in tree.items():
            yield from _deployed_layers(v, model, k if top is None else "")
    elif isinstance(tree, list):
        for v in tree:
            yield from _deployed_layers(v, model, "")


def _train(step, params, state, batches):
    """``step`` over ``batches``: (params, losses as numpy, host ms a step,
    each step ending in a synchronize)."""
    losses, times = [], []
    torch.cuda.synchronize()
    for batch in batches:
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    return params, state, torch.stack(losses).cpu().numpy(), times


def train_vision(dev, smi: str) -> dict:
    """Phase 4i: the paper's four networks at full width (MobileNetV1 and
    ResNet18 at width 1.0, ESPCN, UNet at base 32), each trained
    ``VISION_STEPS`` float adamw steps, requantized into A2Q
    (``requantize_from_float``) and trained ``VISION_STEPS`` A2Q steps
    through ``build_vision_train_step``; one A2Q step profiled; deployed
    through ``deploy_linear`` (the ``a2q_quantize`` kernel, every matrix
    held to the plain quantizer), every deployed column within its layer's
    P=16 budget, the deployed forward against the fake-quant one, the
    sparsity and LUT accounting printed.  Returns the path's deploy
    launches and flips."""
    from collections import Counter

    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.bounds import l1_budget
    from repro_torch.core.lut import LayerGeometry, model_luts
    from repro_torch.core.sparsity import tree_sparsity
    from repro_torch.data.synthetic import ImageClassStream, SuperResStream
    from repro_torch.kernels.a2q_quantize import a2q_quantize_cuda
    from repro_torch.models import vision
    from repro_torch.optim.optimizers import adamw

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from time_decode_kernels import DEPLOY_SHAPES

    phase(f"4i: the paper's vision networks at full width: {VISION_STEPS} float steps, "
          f"requantized to A2Q (M=N=6, P=16), {VISION_STEPS} A2Q steps; deploy through a2q_quantize")
    t_phase = time.perf_counter()
    q, qf = QuantConfig(**VISION_Q), QuantConfig(mode="none")
    totals, shapes = {"a2q_quantize": 0, "a2q_quantize[flips]": 0}, Counter()
    for model, kw, lr in VISION_RUNS:
        init, apply = vision.VISION_MODELS[model]
        gen = torch.Generator(device=dev).manual_seed(0)
        if model in ("mobilenetv1", "resnet18"):
            stream, B = ImageClassStream(global_batch=64, seed=0), 64
        else:
            stream, B = SuperResStream(global_batch=16, hr=48, seed=0), 16
        batches = [{k: torch.as_tensor(v, device=dev) for k, v in stream.batch(i).items()}
                   for i in list(range(2 * VISION_STEPS)) + [10_000]]
        held_out = batches.pop()
        x = held_out["x"] if "x" in held_out else held_out["lr"]

        opt = adamw()
        flt = init(gen, qf, device=dev, **kw)
        flt, _, f_losses, f_ms = _train(vision.build_vision_train_step(model, qf, opt, lr), flt,
                                        opt.init(flt), batches[:VISION_STEPS])
        params = vision.requantize_from_float(init(gen, q, device=dev, **kw), flt, q)
        del flt
        with torch.no_grad():
            before = vision.vision_loss(params, model, held_out, q).item()
        step = vision.build_vision_train_step(model, q, opt, lr)
        params, state, losses, a_ms = _train(step, params, opt.init(params),
                                             batches[VISION_STEPS:])
        step_ms = float(np.median(a_ms[1:]))
        print(f"[4i] {model} {kw}, {B} images a step, lr {lr}: float loss first {f_losses[0]:.4f} "
              f"last-5 mean {f_losses[-5:].mean():.4f} (median step {np.median(f_ms[1:]):.2f} ms); "
              f"A2Q loss first {losses[0]:.4f} last-5 mean {losses[-5:].mean():.4f}; A2Q median "
              f"step {step_ms:.2f} ms ({B / step_ms * 1e3:.1f} images/s; first step "
              f"{a_ms[0]:.0f} ms) on {smi}", flush=True)
        with torch.no_grad():
            after = vision.vision_loss(params, model, held_out, q).item()
            y_fq = apply(params, x, q)
        nonzero = (y_fq != 0).float().mean().item()
        print(f"[4i] {model}: held-out batch loss {before:.6f} before the A2Q steps, {after:.6f} "
              f"after; nonzero outputs {nonzero:.4f}", flush=True)
        # the gate is the held-out batch's loss: the super-resolution batches'
        # own mean squares vary by more than 20 A2Q steps move ESPCN's loss, so
        # the training losses' last 5 against the first tell nothing there
        if not (np.isfinite(losses).all() and np.isfinite(f_losses).all()) or not after < before:
            raise AssertionError(f"{model}: float losses {f_losses}, A2Q losses {losses}, "
                                 f"held-out {before} -> {after}")
        kernels = profile_forward(lambda: step(params, state, batches[-1]), "A2Q train step")
        print(f"[4i] {model}: a profiled A2Q step's kernels {kernels:.3f} ms of a {step_ms:.2f} ms "
              f"step ({1 - kernels / step_ms:.1%} of it device-idle)", flush=True)
        del state

        a2q_quantize_cuda.launches = 0
        with held_deploys(f"[4i] {model}") as held:
            dep = vision.deploy_vision(params, q, model)
        torch.cuda.synchronize()
        deploys = a2q_quantize_cuda.launches
        layers = list(_deployed_layers(dep, model))
        check_held(f"[4i] {model}", held, deploys)
        if deploys != len(layers):
            raise AssertionError(f"{model}: {deploys} deploy launches for {len(layers)} layers")
        worst = 0.0
        for node, boundary in layers:
            qc = node["q8"].to(torch.int64).reshape(-1, node["q8"].shape[-1])
            shapes[tuple(qc.shape)] += 1
            budget = l1_budget(q.acc_bits, 8 if boundary else q.act_bits, False)
            worst = max(worst, float(qc.abs().sum(0).max()) / budget)
        with torch.no_grad():
            y_dep = apply(dep, x, q)
        diff, scale = (y_dep - y_fq).abs().max().item(), y_fq.abs().max().item()
        codes = tree_sparsity([node["q8"] for node, _ in layers])["overall"]
        geoms = vision.layer_geometries(params, q)
        luts = {P: model_luts([LayerGeometry(**{**g.__dict__, "acc_bits": P})
                               for g in geoms])["total"] for P in (16, 32)}
        print(f"[4i] {model}: {deploys} matrices deployed, {held['flips']} code flips; largest "
              f"column's share of its P=16 budget {worst:.4f}; deployed vs fake-quant forward max "
              f"|diff| {diff:.3g} (largest |y| {scale:.4g}, tolerance {VISION_DEPLOY_TOL} of it); "
              f"zero codes {codes:.4f}; model_luts total {luts[16]:.1f} at P=16, {luts[32]:.1f} "
              "at P=32", flush=True)
        if worst > 1.0 or not diff <= VISION_DEPLOY_TOL * scale:
            raise AssertionError(f"{model}: budget share {worst}, deployed forward off by {diff}")
        totals["a2q_quantize"] += deploys
        totals["a2q_quantize[flips]"] += held["flips"]
        del params, dep, batches, held_out, y_fq, y_dep
        torch.cuda.empty_cache()
    rows = Counter()
    for _, K, C, count in DEPLOY_SHAPES:
        if (K, C) in shapes:
            rows[(K, C)] += count
    if rows != shapes:
        raise AssertionError(f"phase 3's DEPLOY_SHAPES rows {dict(rows)} are not 4i's deploys "
                             f"{dict(shapes)}")
    print(f"[4i] launches {totals}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"vision networks trained": totals}


# phase 4x (PERF.md section 4): sharded execution.  gloo does not move
# DTensor's collectives for CUDA tensors of ranks that share one card (every
# one hangs, tools/probe_gloo_cuda.py; PERF.md section 6, PR 30) and NCCL
# refuses two ranks on one device, so on the one card the sharded path runs
# as a world of one rank over NCCL: its code and numerics, not a memory or a
# speed gain.  The four-rank world runs on the CPU (tests/test_torch_sharded.py).
SHARDED_RANKS, SHARDED_BACKEND = 1, "nccl"
SHARDED_LAYERS = 2  # of yi-6b's 32, as 4r cuts it: full width, 32 heads over 4 KV heads
SHARDED_STEPS, SHARDED_BATCH, SHARDED_SEQ, SHARDED_LR = 4, 8, 512, 3e-4
SHARDED_LOSS_RTOL = 1e-4  # tests/test_torch_sharded.py's ADAM_TOL, sharded vs unsharded adamw
SHARDED_SERVE = (4, 64, 16)  # requests, prompt tokens, new tokens
EP_TOKENS = (2, 64)  # rows x tokens through llama4-scout's MoE layer
EP_TOL = 1e-2  # of the local path's largest |y|, in bf16
KV_DECODE_ROWS, KV_CACHE_SEQ, KV_TOL = 8, 64, 1e-2  # the reference's gate on the logits
SHARDED_MEASURED: dict = {}  # 4x's arguments, peak, step times and step FLOPs, for 4z


def _yi6b_cut():
    from repro_torch.configs import get_arch

    full = get_arch("yi-6b")
    arch = dataclasses.replace(full, stacks=(dataclasses.replace(full.stacks[0],
                                                                 count=SHARDED_LAYERS),))
    a = arch.stacks[0].attn
    if (a.heads, a.kv_heads, arch.compute_dtype, arch.quant.mode) != (32, 4, "bfloat16", "a2q"):
        raise AssertionError(f"yi-6b's config moved: {arch}")
    return full, arch


def _llama4_moe_layer():
    from repro_torch.configs import get_arch

    full = get_arch("llama4-scout-17b-a16e")
    arch = dataclasses.replace(full, stacks=(dataclasses.replace(full.stacks[0], count=1),))
    m = arch.stacks[0].moe
    if (m.n_experts, m.top_k, m.capacity_factor) != (16, 1, 1.25):
        raise AssertionError(f"llama4-scout's MoE config moved: {m}")
    return arch


def _leaf_digests(tree) -> dict:
    import hashlib

    from repro_torch.nn.module import keystr, tree_leaves_with_path

    return {keystr(p): hashlib.sha256(t.detach().cpu().reshape(-1).view(torch.uint8).numpy()
                                      .tobytes()).hexdigest()
            for p, t in tree_leaves_with_path(tree)}


def _moe_input(arch, dev):
    g = torch.Generator(device=dev).manual_seed(7)
    return torch.randn(*EP_TOKENS, arch.d_model, generator=g, device=dev).to(torch.bfloat16)


def sharded_reference_main(out_dir: str, device: str = "cuda") -> None:
    """4x's unsharded comparisons, in a process of their own before the
    sharded run (llama4's unsharded step peaks at ~56 GiB): yi-6b's
    ``SHARDED_STEPS`` adamw steps and its trained tree served, llama4-scout's
    MoE layer's local path, and the 1-layer model's first adafactor step, as
    4u trains it.  Writes ``reference.json`` and ``moe_local.pt``."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import resolve_device
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.lm import Runtime, apply_lm, init_lm
    from repro_torch.models.steps import build_train_step
    from repro_torch.nn import moe
    from repro_torch.optim.optimizers import adafactor, adamw
    from repro_torch.serve.engine import PagedServeEngine, deploy_params
    from repro_torch.train.state import init_state

    from torch.utils.flop_counter import FlopCounterMode

    dev = resolve_device(device)
    out = {}
    _, arch = _yi6b_cut()
    opt = adamw()
    state = init_state(init_lm(torch.Generator(device=dev).manual_seed(0), arch, device=dev),
                       opt).tree()
    step = build_train_step(arch, opt, Runtime(), lr_schedule=lambda s: torch.full(
        (), SHARDED_LR, device=dev), donate=True)
    stream = TokenStream(vocab=arch.vocab, seq_len=SHARDED_SEQ, global_batch=SHARDED_BATCH, seed=0)
    losses = []
    for i in range(SHARDED_STEPS):
        # 4z holds the dry-run's per-device FLOPs to this count of one step
        with FlopCounterMode(display=False) if i == 0 else contextlib.nullcontext() as fc:
            state, m = step(state, {k: torch.from_numpy(v).to(dev)
                                    for k, v in stream.batch(i).items()})
        if i == 0:
            out["yi_step_flops"] = fc.get_total_flops()
        losses.append(float(m["loss"]))
    out["yi_losses"] = losses
    params = state["params"]
    del state
    with torch.no_grad():
        deployed = deploy_params(params, arch.quant)
        n, plen, new = SHARDED_SERVE
        prompts = list(np.random.default_rng(0).integers(0, arch.vocab, (n, plen)))
        l_deq = apply_lm(deployed, arch, tokens=torch.as_tensor(np.stack(prompts), device=dev))[0]
        out["serve_eps"] = 2.0**-6 * float(l_deq.float().abs().max())
        del l_deq
        engine = PagedServeEngine(arch, deployed, rt=Runtime(int_forward=True, decode_kernel=True),
                                  batch=n, max_seq=-(-(plen + new) // 16) * 16, block_size=16,
                                  prefill_chunk=plen, device=dev)
        engine.generate(prompts, max_new=new)
    out["serve_ref"] = [{"generated": [int(t) for t in r.generated],
                         "margins": [float(x) for x in r.margins]} for r in engine.last_requests]
    del engine, deployed, params
    torch.cuda.empty_cache()

    la = _llama4_moe_layer()
    s = la.stacks[0]
    mp = moe.init_moe(torch.Generator(device=dev).manual_seed(1), la.d_model, s.moe, la.quant)
    x = _moe_input(la, dev)
    with torch.no_grad():
        y = moe.apply_moe(mp, x, s.moe, la.quant, compute_dtype=torch.bfloat16)
    torch.save(y.cpu(), os.path.join(out_dir, "moe_local.pt"))
    del mp, y
    torch.cuda.empty_cache()
    opt = adafactor()
    state = init_state(init_lm(torch.Generator(device=dev).manual_seed(0), la, device=dev),
                       opt).tree()
    stream = TokenStream(vocab=la.vocab, seq_len=DECODER_TRAIN_SEQ,
                         global_batch=DECODER_TRAIN_BATCH, seed=0)
    step = build_train_step(la, opt, Runtime(), lr_schedule=lambda s: torch.full(
        (), DECODER_TRAIN_LR, device=dev), donate=True)
    state, m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in stream.batch(0).items()})
    out["llama4_loss"] = float(m["loss"])
    with open(os.path.join(out_dir, "reference.json"), "w") as f:
        json.dump(out, f)


def _run_reference(out_dir: Path) -> None:
    """``sharded_reference_main`` in a spawned process of its own."""
    import multiprocessing

    proc = multiprocessing.get_context("spawn").Process(target=sharded_reference_main,
                                                         args=(str(out_dir),))
    proc.start()
    proc.join()
    if proc.exitcode != 0:
        raise AssertionError(f"[4x] the unsharded reference process exited {proc.exitcode}")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train_sharded(dev, smi: str) -> dict:
    """Phase 4x: sharded execution on a world of ``SHARDED_RANKS`` ranks
    over ``SHARDED_BACKEND``, a ``(data, model)`` mesh bound to it
    (``Mesh.over_ranks``).  First the unsharded comparisons in their own
    process (``sharded_reference_main``).  Then: yi-6b at full width
    (``SHARDED_LAYERS`` layers) trained ``SHARDED_STEPS`` adamw steps of
    ``SHARDED_BATCH`` x ``SHARDED_SEQ`` bigram tokens through
    ``build_train_step`` on DTensors placed by ``shard_state`` (each loss
    within ``SHARDED_LOSS_RTOL`` of the unsharded steps'); the params saved
    from the mesh and restored onto ``(data=ranks, model=1)`` and onto one
    unsharded rank (bit for bit: sha256 of every leaf); the restored tree
    deployed through ``a2q_quantize`` (every launch held, 0 flips) and
    served (``SHARDED_SERVE``, ``--int-forward --decode-kernel``), held with
    ``parity_up_to_ties`` to the tree trained unsharded; llama4-scout's MoE
    layer at full width on ``EP_TOKENS`` with ``ep_axis="model"`` and
    ``("model", "data")`` against the local path, and the 1-layer model's
    first adafactor step with ``ep_axis="model"`` against 4u's unsharded
    one; yi-6b's cache placed by ``cache_specs`` (``k`` dim 3 on ``model``)
    through one decode step of ``KV_DECODE_ROWS`` tokens against the
    unsharded step (``KV_TOL``, ``kpos`` written at 0).  Returns the deploy
    and serve launches."""
    import shutil
    import types

    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.data.synthetic import TokenStream
    from repro_torch.dist.sharding import (Mesh, ShardingRules, cache_specs, full_tree,
                                           param_specs, shard_tree)
    from repro_torch.kernels import ops
    from repro_torch.kernels.a2q_quantize import a2q_quantize_cuda
    from repro_torch.models.lm import Runtime, init_cache, init_lm
    from repro_torch.models.steps import build_serve_step, build_train_step
    from repro_torch.nn import moe
    from repro_torch.nn.module import tree_map
    from repro_torch.optim.optimizers import adafactor, adamw
    from repro_torch.roofline.cost import tree_bytes
    from repro_torch.serve.engine import PagedServeEngine, deploy_params, parity_up_to_ties
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.state import init_state, shard_state, specs_to_shardings

    full, arch = _yi6b_cut()
    phase(f"4x: sharded execution, ranks {SHARDED_RANKS} backend {SHARDED_BACKEND}: yi-6b "
          f"({arch.n_layers} of {full.n_layers} layers) trained on a mesh, re-sharded, "
          "deployed, served; llama4-scout's MoE layer expert-parallel; the KV-sharded decode")
    t_phase = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "build" / "smoke_4x"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    torch.cuda.empty_cache()
    _run_reference(out_dir)
    ref = json.loads((out_dir / "reference.json").read_text())
    t_ref = time.perf_counter() - t_phase

    dist.init_process_group(SHARDED_BACKEND, init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=SHARDED_RANKS,
                            device_id=torch.device("cuda", torch.cuda.current_device())
                            if dev.type == "cuda" else None)
    try:
        mesh = Mesh.over_ranks(dev.type, data=SHARDED_RANKS, model=1)
        rules = ShardingRules.default(mesh, arch)
        opt = adamw()
        state = shard_state(init_state(init_lm(torch.Generator(device=dev).manual_seed(0), arch,
                                               device=dev), opt).tree(), opt, mesh, rules)
        step = build_train_step(arch, opt, Runtime(mesh=mesh, rules=rules), donate=True,
                                lr_schedule=lambda s: torch.full((), SHARDED_LR, device=dev))
        stream = TokenStream(vocab=arch.vocab, seq_len=SHARDED_SEQ, global_batch=SHARDED_BATCH,
                             seed=0)
        ops.set_launch_counts({k: 0 for k in ops.launch_counts()})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times, comm = [], [], CommDebugMode()
        for i in range(SHARDED_STEPS):
            b = {k: torch.from_numpy(v).to(dev) for k, v in stream.batch(i).items()}
            if i == 0:  # 4z's gate: the dry-run's arguments are these bytes
                SHARDED_MEASURED["argument_bytes"] = tree_bytes((state, b))
            t0 = time.perf_counter()
            with comm if i == SHARDED_STEPS - 1 else contextlib.nullcontext():
                state, m = step(state, b)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        SHARDED_MEASURED.update(peak_bytes=peak, step_s=times[1:],
                                step_flops=ref["yi_step_flops"])
        launched = sum(ops.launch_counts().values())
        counts = {str(k): v for k, v in comm.get_comm_counts().items()}
        print(f"[4x train] mesh {mesh.shape}: {SHARDED_STEPS} adamw steps of {SHARDED_BATCH} x "
              f"{SHARDED_SEQ}: step s {[round(t, 3) for t in times]} (first with DTensor's "
              f"sharding propagation), peak memory {peak / 2**30:.2f} GiB ({smi}); collectives of "
              f"a step {counts}; losses {losses} against unsharded {ref['yi_losses']}; kernel "
              f"launches while training {launched}", flush=True)
        if launched or not np.allclose(losses, ref["yi_losses"], rtol=SHARDED_LOSS_RTOL, atol=0):
            raise AssertionError(f"[4x train] losses {losses} vs {ref['yi_losses']}, launches "
                                 f"{launched}")

        d = str(out_dir / "ckpt")
        ckpt.save(d, state["params"], SHARDED_STEPS)
        trained = full_tree(state["params"])
        want = _leaf_digests(trained)
        del state
        mesh2 = Mesh.over_ranks(dev.type, data=SHARDED_RANKS, model=1)
        specs2 = param_specs(trained, mesh2, ShardingRules.default(mesh2, arch))
        r2, at2 = ckpt.restore(d, trained, shardings=specs_to_shardings(specs2, mesh2))
        same2 = at2 == SHARDED_STEPS and _leaf_digests(full_tree(r2)) == want
        del r2, trained
        torch.cuda.empty_cache()
        like = init_lm(torch.Generator(device=dev).manual_seed(1), arch, device=dev)
        restored, at1 = ckpt.restore(d, like)
        del like
        same1 = at1 == SHARDED_STEPS and _leaf_digests(restored) == want
        shutil.rmtree(d, ignore_errors=True)
        print(f"[4x checkpoint] saved from {mesh.shape}; restored onto {mesh2.shape} bit for bit "
              f"{same2}, onto one unsharded rank bit for bit {same1}", flush=True)
        if not (same1 and same2):
            raise AssertionError("[4x checkpoint] a restored leaf differs")

        n, plen, new = SHARDED_SERVE
        tag = "4x yi-6b trained sharded"
        ops.set_launch_counts({k: 0 for k in ops.launch_counts()})
        with held_deploys(tag) as held:
            params = deploy_params(restored, arch.quant)
        torch.cuda.synchronize()
        deploys = a2q_quantize_cuda.launches
        check_held(tag, held, deploys)
        if deploys != 7 * arch.n_layers + 1 or held["flips"]:
            raise AssertionError(f"[{tag}] {deploys} deploy launches, {held['flips']} flips")
        prompts = list(np.random.default_rng(0).integers(0, arch.vocab, (n, plen)))
        engine = PagedServeEngine(arch, params, rt=Runtime(int_forward=True, decode_kernel=True),
                                  batch=n, max_seq=-(-(plen + new) // 16) * 16, block_size=16,
                                  prefill_chunk=plen, device=dev)
        outs = engine.generate(prompts, max_new=new)
        torch.cuda.synchronize()
        c = ops.launch_counts()
        launches = {"int_matmul": c["int_matmul_cuda.launches"],
                    "int_matmul[tc]": c["int_matmul_cuda.tc_launches"],
                    "paged_attention": c["paged_attention_cuda.launches"],
                    "a2q_quantize": deploys, "a2q_quantize[flips]": held["flips"]}
        ticks = engine.throughput()["decode_dispatches"]
        per_forward = 7 * arch.n_layers + 1
        ref_reqs = [types.SimpleNamespace(**r) for r in ref["serve_ref"]]
        ok, ties, detail = parity_up_to_ties(ref_reqs, outs, ref["serve_eps"])
        print(f"[{tag}] deployed {deploys} matrices, served {n} requests ({ticks} ticks): "
              f"launches {launches}; against the tree trained unsharded parity_up_to_ties "
              f"eps={ref['serve_eps']:.4g} ok={ok} ties={ties} identical "
              f"{sum(r.generated == list(o) for r, o in zip(ref_reqs, outs))}/{n}", flush=True)
        if launches["int_matmul"] != per_forward * (ticks + n) or \
                launches["paged_attention"] != arch.n_layers * ticks or not ok:
            raise AssertionError(f"[{tag}] launches {launches} or parity {detail}")
        del engine, params
        torch.cuda.empty_cache()

        # the KV-sharded decode on the restored (unsharded) tree
        kv_rules = rules
        cache = init_cache(arch, KV_DECODE_ROWS, KV_CACHE_SEQ, dtype=torch.bfloat16, device=dev)
        cs = cache_specs(cache, mesh, kv_rules)
        tokens = torch.as_tensor(np.random.default_rng(1).integers(
            0, arch.vocab, (KV_DECODE_ROWS, 1)), device=dev)
        with torch.no_grad():
            want_logits, _ = build_serve_step(arch, Runtime())(
                restored, tokens, tree_map(torch.clone, cache), 0)
            got, new_cache = build_serve_step(arch, Runtime(mesh=mesh, rules=kv_rules))(
                shard_tree(restored, param_specs(restored, mesh, kv_rules), mesh), tokens,
                shard_tree(cache, cs, mesh), 0)
            got = got.full_tensor().float()
            kpos = new_cache["0"]["attn"]["kpos"].full_tensor()
        err = float((got - want_logits.float()).abs().max())
        kspec = cs["0"]["attn"]["k"]
        print(f"[4x kv] cache k spec {kspec}: one decode step of {KV_DECODE_ROWS} tokens, logits "
              f"max |sharded - unsharded| {err:.3g}; kpos at 0 {bool((kpos[:, :, 0] == 0).all())}",
              flush=True)
        if err >= KV_TOL or not bool((kpos[:, :, 0] == 0).all()) or kspec[3] not in ("model", None):
            raise AssertionError(f"[4x kv] err {err}, kpos {kpos[:, :, :2]}, spec {kspec}")
        del restored, cache, new_cache
        torch.cuda.empty_cache()

        # llama4-scout's MoE layer expert-parallel against its local path
        la = _llama4_moe_layer()
        s = la.stacks[0]
        mp = moe.init_moe(torch.Generator(device=dev).manual_seed(1), la.d_model, s.moe, la.quant)
        x = _moe_input(la, dev)
        y_local = torch.load(out_dir / "moe_local.pt").to(dev).float()
        errs = {}
        with torch.no_grad():
            for ep in ("model", ("model", "data")):
                y = moe.apply_moe(mp, x, s.moe, la.quant, compute_dtype=torch.bfloat16,
                                  mesh=mesh, ep_axis=ep).full_tensor().float()
                errs[str(ep)] = float((y - y_local).abs().max())
        del mp, x, y
        torch.cuda.empty_cache()
        top = float(y_local.abs().max())
        opt = adafactor()
        lrules = ShardingRules.default(mesh, la)
        lstate = shard_state(init_state(init_lm(torch.Generator(device=dev).manual_seed(0), la,
                                                device=dev), opt).tree(), opt, mesh, lrules)
        lstream = TokenStream(vocab=la.vocab, seq_len=DECODER_TRAIN_SEQ,
                              global_batch=DECODER_TRAIN_BATCH, seed=0)
        lstep = build_train_step(la, opt, Runtime(mesh=mesh, rules=lrules, ep_axis="model"),
                                 lr_schedule=lambda s: torch.full((), DECODER_TRAIN_LR,
                                                                  device=dev), donate=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lstate, lm = lstep(lstate, {k: torch.from_numpy(v).to(dev)
                                    for k, v in lstream.batch(0).items()})
        ep_loss, ep_s = float(lm["loss"]), time.perf_counter() - t0
        ep_peak = torch.cuda.max_memory_allocated()
        del lstate
        torch.cuda.empty_cache()
        print(f"[4x moe] llama4-scout's MoE layer ({s.moe.n_experts} experts, top-{s.moe.top_k}, "
              f"cf {s.moe.capacity_factor}) on {EP_TOKENS[0]} x {EP_TOKENS[1]} tokens: max "
              f"|EP - local| {errs} (largest |y| {top:.4g}); the 1-layer model's adafactor step "
              f"with ep_axis='model': loss {ep_loss:.6f} against unsharded "
              f"{ref['llama4_loss']:.6f}, {ep_s:.1f} s, peak {ep_peak / 2**30:.2f} GiB ({smi})",
              flush=True)
        if max(errs.values()) > EP_TOL * top or \
                not np.isclose(ep_loss, ref["llama4_loss"], rtol=SHARDED_LOSS_RTOL, atol=0):
            raise AssertionError(f"[4x moe] {errs}, loss {ep_loss} vs {ref['llama4_loss']}")
    finally:
        dist.destroy_process_group()
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"[4x] launches {launches}; reference process {t_ref:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s ({smi})", flush=True)
    return {"yi-6b trained sharded (4x)": launches}


def cost_model_main(out_path: str) -> None:
    """4z's dry-run, in a process of its own (a fake world cannot share one
    with 4x's NCCL world): 4x's step, yi-6b at full width cut to
    ``SHARDED_LAYERS`` layers, adamw on ``SHARDED_BATCH`` x ``SHARDED_SEQ``
    with ``donate=True``, traced on fake ``cuda`` tensors over a fake world
    of ``SHARDED_RANKS`` rank(s) by the dry-run's ``trace_step``.  Writes its
    record to ``out_path``."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.models.lm import Runtime
    from repro_torch.optim.optimizers import adamw
    from repro_torch.roofline.analysis import roofline_terms

    from repro_torch.kernels import ops

    _, arch = _yi6b_cut()
    t0 = time.perf_counter()
    before = ops.launch_counts()
    with fake_mesh(dryrun.trace_device(), data=SHARDED_RANKS, model=1) as mesh:
        rules = ShardingRules.default(mesh, arch)
        info = dryrun.trace_step(
            arch, ShapeSpec("4x", "train", SHARDED_SEQ, SHARDED_BATCH), mesh, rules,
            Runtime(mesh=mesh, rules=rules), optimizer=adamw(), donate=True,
            lr_schedule=lambda s: torch.full((), SHARDED_LR))
        n = mesh.size
    # the parent's gate: the trace launched no kernel in this process
    info["launched"] = {k: v - before.get(k, 0) for k, v in ops.launch_counts().items()
                        if v != before.get(k, 0)}
    info["roofline"] = roofline_terms(
        flops_per_device=info["cost"]["flops"], bytes_per_device=info["cost"]["bytes accessed"],
        collective_bytes_per_device=info["collectives"]["total_bytes"], n_chips=n)
    info["seconds"] = time.perf_counter() - t0
    info["device"] = dryrun.trace_device()
    with open(out_path, "w") as f:
        json.dump(info, f)


def cost_model(dev, smi: str) -> dict:
    """Phase 4z: the dry-run's cost of 4x's step against the card.  The
    gates: the trace's ``argument_size_in_bytes`` equals the bytes of 4x's
    real sharded state and first batch, and its per-device FLOPs equal
    ``FlopCounterMode``'s count of one real unsharded step (in a world of one
    every shard is whole).  Printed: the predicted peak (arguments + temp)
    over 4x's ``max_memory_allocated``, and ``roofline.bound_s`` over 4x's
    steady step time.  And the dry-run launched no kernel (its process's
    counts, read before and after the trace)."""
    import multiprocessing

    phase("4z: the dry-run's cost of 4x's step (yi-6b, 2 layers, adamw 8 x 512) against the card")
    t_phase = time.perf_counter()
    out = Path(__file__).resolve().parent / "build" / "smoke_4z.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    proc = multiprocessing.get_context("spawn").Process(target=cost_model_main, args=(str(out),))
    proc.start()
    proc.join()
    if proc.exitcode != 0:
        raise AssertionError(f"[4z] the dry-run process exited {proc.exitcode}")
    info = json.loads(out.read_text())
    m = SHARDED_MEASURED
    mem = info["memory_analysis"]
    flops = info["cost"]["flops"]
    predicted_peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    steady = float(np.median(m["step_s"]))
    bound = info["roofline"]["bound_s"]
    print(f"[4z] trace on fake {info['device']} tensors {info['compile_s']} s (process "
          f"{time.perf_counter() - t_phase:.1f} s): arguments {mem['argument_size_in_bytes']} B "
          f"(4x real {m['argument_bytes']} B), per-device FLOPs {flops:.6g} (real unsharded "
          f"step, FlopCounterMode {m['step_flops']:.6g}), bytes accessed "
          f"{info['cost']['bytes accessed']:.6g}, collectives {info['collectives']['counts']}, "
          f"kernel launches {sum(info['launched'].values())}; "
          f"predicted peak {predicted_peak / 2**30:.3f} GiB / 4x max_memory_allocated "
          f"{m['peak_bytes'] / 2**30:.3f} GiB = {predicted_peak / m['peak_bytes']:.3f}; "
          f"roofline bound {bound * 1e3:.3f} ms ({info['roofline']['dominant']}) / 4x steady "
          f"step {steady * 1e3:.3f} ms = {bound / steady:.3f} ({smi})", flush=True)
    if mem["argument_size_in_bytes"] != m["argument_bytes"] or flops != m["step_flops"]:
        raise AssertionError(f"[4z] arguments {mem['argument_size_in_bytes']} vs "
                             f"{m['argument_bytes']}, FLOPs {flops} vs {m['step_flops']}")
    if info["launched"]:
        raise AssertionError(f"[4z] the dry-run launched kernels: {info['launched']}")
    out.unlink(missing_ok=True)
    return {"peak_ratio": predicted_peak / m["peak_bytes"], "bound_over_step": bound / steady}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    phase("1: device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import resolve_device  # fails outside a checkout of the repo
    from repro_torch.kernels import _build

    dev = resolve_device("cuda")  # also turns TF32 off: fp32 matmuls in full fp32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    phase("2: build")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"built {list(logs)} in {time.perf_counter() - t0:.1f}s", flush=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    phase("3: kernels against their plain versions")
    entries = [check_int_matmul(dev), check_int_matmul_prologue(dev),
               check_int_matmul_requant(dev), check_paged_attention(dev),
               *check_paged_attention_int(dev), check_paged_mla_attention(dev),
               *check_paged_mla_attention_int(dev), *check_rwkv6_scan(dev),
               check_a2q_quantize(dev), check_flash_attention(dev), *check_int_matmul_hubert(dev)]
    entries[0]["at_deepseek"] = check_int_matmul_deepseek(dev)
    entries[0].update(check_int_matmul_decode(dev))
    torch.cuda.empty_cache()
    by_path = serve(dev)
    torch.cuda.empty_cache()
    by_path.update(serve_contiguous(dev))
    torch.cuda.empty_cache()
    by_path.update(serve_cluster(dev, smi))
    torch.cuda.empty_cache()
    by_path.update(serve_deepseek(dev))
    torch.cuda.empty_cache()  # deepseek's params are gone before rwkv6 is built
    by_path.update(serve_rwkv6(dev))
    torch.cuda.empty_cache()
    by_path.update(serve_h2o(dev))
    torch.cuda.empty_cache()
    by_path.update(serve_hymba(dev))
    torch.cuda.empty_cache()
    by_path.update(serve_llama4(dev))
    torch.cuda.empty_cache()
    by_path.update(serve_llava(dev))
    torch.cuda.empty_cache()
    by_path.update(encode_hubert(dev))
    torch.cuda.empty_cache()
    by_path.update(train_smollm(dev))
    torch.cuda.empty_cache()
    by_path.update(train_decoders(dev, smi))
    torch.cuda.empty_cache()
    by_path.update(train_compressed(dev, smi))
    torch.cuda.empty_cache()
    by_path.update(train_frontends(dev, smi))
    torch.cuda.empty_cache()
    by_path.update(train_vision(dev, smi))
    torch.cuda.empty_cache()
    by_path.update(train_sharded(dev, smi))
    cost_model(dev, smi)
    for e in entries:
        counts = {path: n[e["name"]] for path, n in by_path.items() if e["name"] in n}
        e["launches"] = sum(counts.values())
        e["launches_by_path"] = counts
        if e["launches"] == 0:
            raise AssertionError(f"{e['name']} was never launched on the main paths")
        if e["name"] == "flash_attention":
            e["launches_tc"] = sum(n.get("flash_attention[tc]", 0) for n in by_path.values())
        if e["name"].startswith("paged_mla_attention"):  # every main-path launch on the tensor cores
            e["launches_tc"] = sum(n.get(f"{e['name']}[tc]", 0) for n in by_path.values())
            if e["launches_tc"] != e["launches"]:
                raise AssertionError(f"{e['name']}: {e['launches_tc']} of {e['launches']} "
                                     "launches on the tensor cores")
        if e["name"] == "a2q_quantize":  # each phase held every deploy launch (check_held)
            e["deploy_matrices_checked"] = e["launches"]
            e["deploy_code_flips"] = sum(n.get("a2q_quantize[flips]", 0) for n in by_path.values())
            if e["deploy_code_flips"]:
                raise AssertionError(f"{e['deploy_code_flips']} deployed codes off the plain "
                                     "quantizer's")

    phase("6: result")
    print(smi, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
