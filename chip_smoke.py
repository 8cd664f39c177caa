#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result). They are listed
by number; they run in this order: 1-4, 7b, then 7f (tp) beside 4b-7 and
8-10, the tp kernel records, 7g (tp fleet) and 7h (ep) with the card to
themselves, the ep kernel records, then 12-13 (moe, mla: a process of their
own)
beside 7d, 7e, 7c, 11, 16 and 18, the MLA and hybrid kernel records, 14,
15, 17. Served steps keep the host busy and the card mostly idle, so the
work beside overlaps well; the phases that run beside another (``BESIDE``,
printed when the work beside starts) take their walls and profiled times
under that load. Every kernel record is timed with the card to itself.

1. device  — require CUDA, print the card's name and power limit, turn TF32
             off for the f32 checks;
2. build   — compile the kernel library from ``src/repro_torch/kernels/csrc``
             with nvcc (``kernels/_build.py``); ptxas' registers and spills,
             summarised for the redesigned kernels;
3. kernels — every kernel of the served paths against its plain PyTorch
             version at the main path's shapes, bf16 (atol/rtol 2e-2) and f32
             (atol 2e-5, rtol 2e-4; the SSD scan's f32 at the reference's
             SSD tolerance, atol 2e-4, rtol 2e-3), plus edge cases (RMSNorm's
             four prologues at every served shape, the second operand a
             slice of its projection as the models pass it, add's sum equal
             to x + r and add's and mul's output equal to the none kernel
             on the unfused result bit for bit, the route each width
             takes in the profiler; fully
             masked rows, windows, MQA up to G = 64, D=128, T=1; decode at
             the edges of its sequence split, S = 321 and 4096, a repeat
             call bit-identical; the paged decode at the served pool (8
             slots, block 16, 21 blocks a slot, 48 blocks) with n_valid 1,
             block edges and MB * bs, a freed slot's all-zero table and a
             descending one, a repeat call bit-identical, and against the
             contiguous kernel on the gathered rows; flash attention at a
             mixed step's shapes (8 slots of 64 lanes against 336 gathered
             keys, slots prefilling, decoding and idle, positions and
             k_valid as the paged layer builds them), a repeat call
             bit-identical; flash attention at a verify step's shapes (8
             slots of 5 lanes against the contiguous cache's 321 keys and
             against 336 keys gathered from the pool, widths 5, 1, 3 and 0),
             bf16 and f32, a repeat call bit-identical; int8 GEMMs at M = 1 and ragged shapes, a
             repeat call bit-identical, the dynamic one bit for bit in every
             shape; HSTU's band, empty rows, lengths inside a tile and
             clipped bias, bf16 also normwise (max |err| <= 1e-2 max
             |want|); SSD's ragged chunks, G = 2, initial state or none;
             HSTU and SSD repeat calls bit-identical);
             CUDA-event times of kernel, plain version and a PyTorch library
             call (with its device time), beside the card's bound, HSTU and
             SSD on both routes (bf16 tensor cores, f32 CUDA cores), the
             SSD's device kernels per call from ``ssd_scan.launch_plan``;
             the int8 GEMMs' device time at every served linear shape;
             flash attention at the prefill and the mixed step; RMSNorm at
             llama's decode, prefill and mixed step, Mamba-2's gated norm
             and HSTU's three norms. A profiler session that saw fewer
             device kernels than were launched is printed with the names it
             lacked and taken once more; a second short one fails;
4. serve   — full-width llama3.2-1b in bf16 (random weights from a seeded
             generator) serves 16 requests through the continuous-batching
             scheduler, then through ``policy="fixed"``: every request gets
             its own max_new tokens, all logits are finite, every kernel's
             launch counter rose by exactly its per-forward count (RMSNorm's
             also by prologue: none 1 and add 2 x n_layers), and both
             policies give identical tokens;
4b. paged — the same 16 requests through the paged pool (block 16, 48
             blocks: 752 tokens against the ~160 blocks eight full slots
             want) and through paged + chunked prefill (budget 64): each arm
             preempts, gives every request its tokens, finite logits and no
             leaked block, launches exactly its kernels (the paged decode
             kernel n_layers per plain decode step, flash n_layers per
             prefill and per mixed step, the contiguous decode never,
             RMSNorm as in phase 4), and gives the contiguous arm's tokens
             up to a near tie (phase 5's rule); tok/s, TTFT, TPOT, block
             occupancy, reserved and peak-used KV bytes and
             ``max_memory_allocated`` printed for the record (every arm of
             phase 4 prints the last too); one mixed and one paged decode
             step profiled (device busy share, kernels per step);
4c. speculative — the same 16 requests on the same weights through four
             arms: (a) plain sampling at t = 0.8 / top-p 0.9, contiguous; (b)
             LayerSkip speculative (exit layer 8, 4 drafts a window), greedy,
             contiguous; (c) speculative at t = 0.8 / 0.9, contiguous; (d) as
             (c) on phase 4b's paged + chunked pool, which preempts. (b) gives
             phase 4's greedy tokens and (c), (d) give (a)'s, up to a near tie
             (phase 4b's rule; for a sampled token the top-two perturbed
             scores, nucleus-filtered logits / T plus the token's Gumbel
             draw, against the kernel and plain paths' max |dlogit| / T);
             exact launches (a speculative step: decode E x K, flash
             n_layers, RMSNorm none K + 1 and add 2EK + 2 n_layers);
             committed = accepted + slot-steps, the commit histogram sums, no
             leaked block, at least one draft accepted; tok/s, TTFT, TPOT,
             steps, acceptance, tokens a slot-step and preemptions printed;
             one speculative step profiled (wall, device ms, busy share,
             kernels a step) and the sampler's device kernels counted (keys,
             Gumbel draw, the whole per-slot and per-window sampler);
4d. mixed — the same 16 requests under ``apply_profile_mix("greedy,beam,
             contrastive,speculative", n_beams=2)`` through phase 4b's chunked
             pool: 2-beam and contrastive requests served as slot groups
             beside plain and speculative ones (a group needs up to 42 of the
             47 usable blocks, so groups preempt and replay). Exact launches
             (a group's prefills and steps count as everyone's), no row
             gather, table permutations and copy-on-write copies, no block
             and no refcount left; every request against its batch engine
             (greedy and speculative: phase 4's tokens; beam: a recording
             ``run_profile``, compared step by step under ``beam_parity``'s
             rule; contrastive: ``generate_contrastive`` under
             ``greedy_parity``'s); the per-class TTFT/TPOT rows;
             ``kv_cache.copy_block``'s ms a copy-on-write beside its bound;
4e. prefix — ``shared_prefix_trace`` (16 requests, 4 system prompts of 64
             tokens, pad 128) through phase 4b's chunked pool without and
             with the prefix cache, at t = 0 and t = 0.8: exact launches, the
             same reserved KV bytes, at least one hit, warm tokens against
             cold under the near-tie rule; hit rate, prompt tokens skipped,
             TTFT printed;
4f. router — the same 16 requests through ``ReplicaRouter`` fleets on the
             one card, 8 slots a replica: 2 replicas contiguous at t = 0 and
             t = 0.8 / top-p 0.9, 2 on phase 4b's paged pool, 3 contiguous
             (each the single pool's tokens exactly: phase 4's, 4c's plain
             sampled arm's, 4b's paged arm's) and 2 on the chunked pool
             (phase 4's tokens up to a near tie); exact launches against the
             fleet's summed steps and prefills; wall, tok/s, the aggregate
             rate over the busiest replica's own seconds (a card a replica,
             emulated), spills, requeues and a line a replica printed. Every
             ``step_begin`` of a chunked and of a contiguous run (mixed and
             decode steps, greedy and sampled) under
             ``torch.cuda.set_sync_debug_mode("error")``, its staging
             buffers pinned; the host ms of two replicas' ``step_begin``
             against one replica's ``step()``; the reference's starvation
             trace (one slot, arrivals 2 ms apart): the priority-0 request
             last without aging, at position 4 or earlier aged every 2 ms;
5. parity  — prefill logits of two requests through the kernels and through
             the plain versions on the same weights, and their first served
             tokens against greedy generation on the plain path;
6. profile — torch.profiler over one prefill and over served decode steps:
             device busy share and device time by kind (ported kernels,
             matmuls, other ops), device kernels per prefill and per step
             beside the unfused layer loops' counts;
7. quant   — AutoQuant (``core/quantization.py``) of the same bf16 params,
             calibrated for decode (8 tokens/step: every linear weight-only
             int8) and for prefill (256 tokens/step: every linear dynamic
             int8), each arm served as in phase 4 with exact launch counts
             (its int8 kernel 7 x n_layers per forward, the other 0), its
             kernel path held against its plain path as in phase 5, and
             profiled as in phase 6; printed for the record: tok/s, TTFT,
             TPOT, int8 vs bf16 weight bytes, logit drift against the bf16
             params, and the counts of ``calibrate="measure"``;
7b. extend — the same bf16 llama3.2-1b, 8 slots of its contiguous cache
             (321 rows) prefilled on the plain path to lengths 1..320, each
             takes a 4-token window through ``forward(mode="extend")``:
             flash exactly n_layers (RMSNorm a forward's, nothing else);
             lengths + 4; in every layer each window written at rows
             [min(len, S - 4), +4) by the kernel and the plain path alike,
             every other row bit-identical to the prefilled cache (the
             slot at 320 overhangs: the reference's clamp writes it at
             317..320); the slots that fit held against a chain of 4 plain
             decode steps on the window's tokens, the overhanging slot
             against the plain extend (its layer-0 rows bit for bit): max
             |dlogit| within 2e-2 of the logits' scale, the written rows
             within EXTEND_KV_NORMWISE, a differing greedy pick only at a
             near tie. Then an f32 cut of 2 layers (the f32 flash
             kernel) within EXTEND_F32_BOUND and, the flash kernel one key
             short, above it; a paged cache and a ring refuse extend before
             any write; flash at the extend shape timed beside its bound
             and SDPA;
7c. train — full-width llama3.2-1b (16 layers, bf16, tied, 1.24 G
             parameters, seeded init on the card) trained 8 AdamW steps
             (f32 moments, lr 1e-3 after one warmup step) through
             ``train_loop.train`` on one repeated ``token_stream`` batch of
             4 x 128 (seed 0) with ``impl="torch"``: no kernel launched, the
             loss falling from the first step to the last, finite gradient
             norms and learning rates, every step printed; step wall ms,
             tok/s and ``max_memory_allocated``. The 12.4 GB ``.npz``
             checkpoint saved under ``build/`` and restored into fresh
             tensors on the card, bit for bit, then deleted; a forward and
             backward under ``impl="auto"`` refused by the kernels' guard
             (no launch); one f32 step of a 2-layer cut on the card against
             the same step on the CPU (TF32 off): loss, gradient norm and
             every gradient at f32 tolerance, new params too but where the
             CPU's gradient is rounding noise (there within 2 lr);
7d. scanned — the same bf16 llama3.2-1b, 8 prompts of 256 tokens, 64
             greedy tokens through ``engine.generate`` (the eager loop) and
             ``engine.generate_scanned`` (one decode step captured as a CUDA
             graph, replayed once a token, one host sync at the end): the
             same tokens bit for bit, exact launches for both (flash
             n_layers at the prefill, decode n_layers a decode step; the
             captured step's counts added once a replay); the kernel path
             teacher-forced to the plain path's tokens, eagerly and through
             the captured step (bit for bit the eager logits), within 2e-2 of
             the plain logits' max, and on an f32 cut of 2 layers within
             0.01 with the decode kernel one key short above it; per decode
             token the wall ms, device ms and busy share of each loop; a
             sampler with a host sync makes ``generate_scanned`` raise;
7e. audit — ``python -m repro_torch.analysis --device cuda``'s step audit
             on the same model at the reference's pool geometry (4 slots,
             pad 16, 64 new, block 16, 14 blocks, budget 4, exit layer 1, 4
             drafts): prefill, decode, draft and verify on both pools and
             the paged mixed step, each on the states two serving traces
             left, hold one program, write their caches in place, grow
             nothing, widen nothing but RoPE's and the unembed's per-token
             f32, capture as one CUDA graph and replay bit for bit their
             eager runs on both states; each step's eager and replay wall
             ms and its graph's device kernels printed;
7f. tp — full-width llama3.2-1b (bf16, seeded weights) at TP = 2: two
             ``torch.distributed`` ranks on cuda:0 under gloo
             (``tp_pool.spawn``; the kernels built here first, so the ranks
             only load them), each with its shard and its KV heads. Rank 0
             first records the single-rank plain run of both arms (the
             serve trace on the contiguous pool, and phase 4b's chunked
             geometry, which must preempt) and the single-rank kernel run
             forced to it. Each TP arm: host counters the single-rank
             run's, launches exact and the same on both ranks, no leaked
             block, KV a rank <= 0.6x the pool (the ranks' pools counted
             once are the single pool's bytes), teacher-forced |dlogit|
             within TP_DLOGIT_BOUND, which the decode kernel one key short
             breaks. Then TP_FAMILIES on the dense phase's trace (8
             requests of 16 tokens), the same way, each family with its
             bound (TP_FAMILY_BOUND) and its control: chameleon-34b (4
             layers, 8 I-T requests, paged and chunked, and an f32 arm of
             2 layers that decides), qwen3-moe-30b-a3b (4 layers:
             contiguous, chunked, speculative at t = 0.8),
             deepseek-v2-236b (3 layers: contiguous, chunked; the latent
             whole on each rank), llama3.2-1b AutoQuant'd wo and dyn
             (contiguous, and an f32 dyn arm of 2 layers that decides),
             mamba2-130m (24 layers, greedy and t = 0.8: a rank's 12
             heads, the gate norm on the RMSNorm kernel's split-row form;
             its control the split-row sums one column short; an f32 arm
             of 2 layers decides), whisper-base (6 + 6 layers, S-T with
             each request's frames, greedy and 2 beam groups of 4 forced
             to the plain run's beams; its 51865-row vocabulary whole),
             seamless-m4t (S-T greedy) and recurrentgemma-2b (all 26
             layers: a rank's 5 q heads over the one KV head, whole on
             each rank, and 1280 of 2560 RG-LRU channels; phase 4's trace,
             a ring of 321 rows whole on each rank, the decode kernel at
             G * D = 1280; the long arm, 2 x 3072 + 32 through the
             scheduler, a ring of 2048 rows split along them, decoded by
             ``sp_decode`` on the partial form and the merge, its control
             the partial form one key short; no bf16 bound, an f32 arm of
             6 layers on each route decides; a decode step timed on both
             routes beside the whole model's);
             params a rank what the serving specs give, the reduces a
             decode step ``reduces_per_forward``'s. The f32 smoke configs
             of llama, chameleon, qwen3-moe and deepseek-v2: TP tokens the
             single-rank kernel run's on both smoke pools. Printed,
             labelled "2 ranks on one card, no interconnect": the backend,
             the bytes a rank holds, tok/s and TTFT, a decode step's wall
             and device ms beside the single rank's, the reduces a step
             and their host ms, each family's seconds. Then the kernels at
             a rank's shapes as kernel records: flash, decode and paged
             decode (llama, chameleon, qwen3-moe, the MLA prefill and
             latent at 64 heads), the qk-norm RMSNorm, both int8 GEMMs at
             N / 2 and K / 2, the split-row RMSNorm (beside the whole-row
             kernel), the SSD scan at 12 heads, whisper's encoder flash
             and cross attention at 4 heads, recurrentgemma's flash at 5
             heads and decode at G * D = 1280, the decode kernel's partial
             form over a rank's 1024 ring rows (bf16 and f32) and the
             merge of the ranks' partials; and ``sp_decode`` on both ranks
             at llama3.2-1b's decode shapes against the single-rank
             decode kernel (its rows the whole write's, one partial form
             and one merge a call, its wall beside the kernel's).
             ``python3 chip_smoke.py tp`` runs device, build and this phase
             alone, with no result lines (``tp FAMILY ...``: only those
             TP_FAMILIES and their records);
7g. tp fleet — full-width llama3.2-1b (bf16, seeded weights) served by a
             DP x TP fleet: ``ReplicaRouter(tp=2)`` of 2 replicas, each a
             TP = 2 pool on the group (cuda:0, cuda:0), run by two
             ``torch.distributed`` processes under gloo, process r rank r of
             both replicas, each replica with its own process group and
             shared slots, both on the rank's one shard. Rank 0 first serves
             phase 4f's ``x2`` and ``x2 chunked`` arms again on the whole
             model, recorded (their tokens and host counters 4f's); then
             each arm through the fleet, teacher-forced to the recording:
             placements, spills, requeues and each replica's steps,
             prefills, chunks and preemptions 4f's on both processes,
             launches exact against the replicas' summed forwards and the
             same on both, each replica's reduces ``reduces_per_forward`` a
             forward, KV a rank <= 0.6x a replica's and params the specs'
             bytes, |dlogit| within TP_DLOGIT_BOUND, which the contiguous
             arm with the decode kernel one key short breaks. It runs with
             the card to itself after the tp join (beside the tp ranks'
             MoE and MLA models the card ran out of memory). Printed,
             labelled as 7f's: wall, tok/s, the aggregate over
             ``busy_max_s`` and each replica's reduces and their host ms;
7h. ep — expert parallelism (``moe.moe_ffn_ep``) at EP = 2: two
             ``torch.distributed`` processes on cuda:0 under gloo, one
             ``tp_pool.ep_group`` of both, each rank with 2 x 256 tokens of
             its own. Full-width MoE layers of qwen3-moe-30b-a3b (bf16 and
             f32) and deepseek-v2-236b (bf16), seeded, forward and backward
             of ``sum(out * ct) + aux`` on the plain path: the output, the
             aux, the rank's expert gradients, its x gradient and the
             router's and shared experts' (summed over the ranks) within
             their type's tolerance of ``moe_ffn_ep_plain`` (every rank in
             one process on the whole experts, one rank at a time), the
             same forward with the two sources' chunks swapped before the
             experts (``sources_swapped``) outside it, 2 exchanges forward
             and 2 backward. Then qwen3-moe-30b-a3b cut to 4 layers at
             dropless capacity (E / k), its experts split over the ranks:
             a train forward with no gradient on the kernels, launches
             exactly ``_want_counts``' (flash 4) on both ranks, 8
             exchanges and 4 aux reduces, finite logits within
             EP_DLOGIT_BOUND of the one-device forward on the rank's batch
             and the control above it. Printed, labelled as 7f's: the
             drops, a layer's exchange bytes and host ms, its experts' bmm
             by CUDA events beside their bound, its forward at EP = 2 and
             at TP = 2 (``moe_ffn(tp=)``, one reduce), the model's
             exchanges one by one, the file system of the shared slots.
             Its kernel records: flash and RMSNorm add at the model's
             shapes, launches from rank 0's run. ``python3 chip_smoke.py
             ep`` runs device, build and this phase alone, with no result
             lines;
8. hstu    — full-width HSTU (14 layers, d 512, 8 heads, band 1024 from
             layer 3, bf16, seeded weights) scores 8 user histories from
             ``hstu_user_histories(seed=0)``, right-padded with ``lengths``:
             exact launches per forward (hstu_attention 14, rmsnorm 29: none
             1, add 14, mul 14; the rest 0), finite logits, and the kernel path's retrieval and
             ranking logits against the plain path's on 2 histories (bf16
             and an f32 copy of the params, each profiled: every layer on
             the tensor-core kernel in bf16, on the CUDA-core one in f32);
             forward wall / device ms and histories per second;
9. ssm     — full-width mamba2-130m (24 layers, d 768, N 128, bf16, seeded
             weights) serves the same 16 requests as phase 4 (continuous):
             exact launches (ssd_scan 24 per prefill and 0 per decode step,
             rmsnorm 49 per forward: none 1, add 24, mul_silu 24; the rest
             0), parity as in phase 5 and a
             decode-step profile as in phase 6; then one bf16 and one f32
             prefill (an f32 copy of the params), profiled: every layer's
             scan on its type's kernels, the f32 logits against the plain
             path's;
10. seamless — full-width whisper-base (6 + 6 layers, d 512, 8 heads of
             64, 1500 frames, bf16, seeded weights): S-T of 4 utterances
             (``seamless_s2t`` frame lengths at seed 2) x 4 beams, BOS 1,
             EOS 2, 48 tokens through ``engine.generate_beam``, the reorder
             in place and then into fresh tensors (equal tokens; each arm's
             reorder time a step by CUDA events); exact launches (flash:
             the encoder's layers, the decoder's self-attention at the
             prefill and its cross-attention every step; decode: the
             self-attention every decode step; RMSNorm by prologue); the
             kernel path's beam choices against the plain path's at every
             step with the plain path's beams forced on both (each step's
             logits within 2e-2 of the plain logit span, a differing choice
             only at a near tie);
             the encoder's device time, one beam step profiled, the reorder
             alone and the cache's bytes; S-T served: each utterance one
             4-beam request with its frames through the contiguous scheduler
             (16 slots), held step by step against a recording batch run
             (the same tokens) under ``beam_parity``'s rule, exact launches
             (a prefill per admission, a decode forward per pool step), the
             row gathers timed, one served step profiled; then seamless-m4t's S-S of 2
             utterances (beam text, one T2U forward, one vocoder forward:
             the waveform 32 samples a text token);
11. chameleon — chameleon-34b at full width (d 8192, 64/8 heads of 128,
             d_ff 22016, vocab 65536, qk-norm, bf16), 4 of its 48 layers:
             I-T (1024 stub image tokens + 6 text tokens, 30 greedy tokens)
             and T-I (``generate_contrastive`` on a 14-token prompt, 1024
             image tokens, guidance 3: every token in the image range),
             exact launches (qk-norm's RMSNorms too) and tokens against the
             plain path's up to a near tie; one T-I step (two streams)
             profiled; T-I served: two contrastive requests through the
             scheduler on the paged pool (block 16) and on the contiguous
             one, exact launches, every token an image token, against a batch
             ``generate_contrastive`` of both prompts up to a near tie. The
             kernels phase also holds the paged decode on slot groups'
             tables (prefix blocks shared, and after ``permute_group``):
             bit-identical to the contiguous kernel on the gathered rows and
             to a repeat call. It also holds flash attention at the
             whisper encoder's, the cross-attention's, the decoder's BOS
             prefill (Tq = Tk = 1) and Chameleon's prefill shapes,
             flash-decode at the decoder's self cache (every length of the
             S-T and S-S runs) and Chameleon's T-I cache, and RMSNorm at its
             qk-norm rows against their plain versions, timed.
12. moe   — qwen3-moe-30b-a3b at full width (d 2048, 32/4 heads of 128,
             qk-norm, 128 experts top-8 of 768, vocab 151936, bf16, seeded
             weights), 4 of its 48 layers, serves the 16 requests through
             four arms: contiguous, paged (block 16, 48 blocks), paged +
             chunked (budget 64) and speculative at t = 0.8 / top-p 0.9
             (exit layer 2, 4 drafts). Each arm runs on the kernels (exact
             launches, finite logits, no leaked block), then on the plain
             path (``plain_path``: every ``auto`` dispatch to the plain
             versions, no launch), recorded, then on the kernels again,
             teacher-forced to the plain run's draws (``Forced``): the same
             steps, the first MoE layer's router probabilities at every
             live lane within FORCED_DPROB_BOUND, and the logits of every
             committed token whose forward routed its slot as the plain
             run's within FORCED_DLOGIT_BOUND; every routing difference and
             every kernel pick that differs is counted with its gap. The
             contiguous arm with the decode kernel one key short
             (``one_key_short``) must break a bound. Under dropless
             capacity (E / k) the paged, chunked and speculative pools,
             forced to the contiguous pool's tokens by (request, index),
             hold their rows' median |dlogit| within
             CROSS_DLOGIT_MEDIAN_BOUND, and the paged pool one key short
             breaks it (at 1.25 a token's drops depend on what shares its
             step, so pools are compared only there). One decode step of 8
             slots profiled, the experts' three batched products of a MoE
             layer at decode capacity timed against their weight bytes
             over the card's memory rate, ``max_memory_allocated``;
13. mla   — deepseek-v2-236b at full width (d 5120, 128 heads, MLA q_lora
             1536, kv_lora 512, rope 64, 160 experts top-6 of 1536 + 2
             shared, vocab 102400, bf16), 3 of its 60 layers (the dense
             layer 0 and two MoE layers), through the same arms, checks
             and profile; then the MLA kernel shapes against their plain
             versions at full width, timed beside their bound and SDPA:
             flash at the prefill (D 192 / Dv 128), flash over the latent
             (D 576, V its leading 512 columns, Hkv 1, G 128) at the
             chunked arm's mixed step and at the verify step, the latent
             decode and the paged latent decode (bit for bit the
             contiguous kernel on the gathered rows). Then phase 7b's
             extend over the latent (dropless capacity, so extend and decode
             route alike but at near ties; rows routed otherwise are left
             out) within FORCED_DLOGIT_BOUND, the flash kernel one key short
             above it, and flash over the latent at the extend shape. Each
             model's weights are freed before the next phase.
14. dense — qwen2.5-3b (36 layers, q/k/v bias redrawn N(0, 0.5^2)),
             llama3-405b (4 of 126 layers, d 16384, 128/8 heads: G * D =
             2048) and yi-34b (all 60 layers, 68.8 GB, 56/8 heads: G = 7)
             at full width, bf16, seeded weights, each serving 8
             ``llama_humaneval`` requests of 16 tokens through the
             contiguous pool and the paged + chunked one (block 16, budget
             64): exact launches, no leaked block or refcount, the plain
             path's tokens under the near-tie rule, and the kernel path
             forced to the plain run's draws with every committed row's
             |dlogit| within the model's DENSE_DLOGIT_BOUND (the contiguous
             arm with the decode kernel one key short must break it). The kernels
             phase's records gain flash at G = 7 and G = 16 (held at Tq 1,
             5, 64, 154 and the served prefill, causal and under
             ``k_valid``), the contiguous and paged decode at G = 7 and
             G * D = 2048 (split edges, 4096 rows, paged bit for bit the
             contiguous kernel on the gathered rows) and RMSNorm none and
             add at d 7168 and 16384 (their routes from the profiler);
15. characterize — the paper's four workloads (``launch/op_breakdown.py``,
             the shapes of ``benchmarks/bench_op_breakdown.py``): T-T
             yi-34b (60 layers; prefill 4 x 154, decode at 846), I-T
             chameleon-34b (24 of 48 layers; 16 x 1040, 1050), S-T
             whisper-base (the encoder over 32 utterances and the BOS
             prefill; one 4-beam step of 128 streams) and H-A HSTU (32
             histories of 4814, prefill only). Each window profiled once
             (host and card, input shapes) with the counters set to 0
             around it: device ms and share of linear, attention, norm,
             embed and other, idle, the unprofiled wall and the analytic
             H100 roofline shares; every kernel in one class, classes plus
             idle within 1 % of the window, the ported kernels in their
             class as often as their wrappers launched;
16. hybrid — recurrentgemma-2b at full width and depth (26 layers: 18
             RG-LRU blocks, 8 local attention layers of 10 heads over one KV
             head of 256, window 2048 over ring-buffer K/V caches; d 2560,
             vocab 256000, bf16, seeded weights: 2.9 G parameters) serves
             phase 4's 16 requests under the continuous and the fixed
             policy (the same tokens; exact launches: flash 8 a prefill,
             decode 8 a decode step, RMSNorm none 1 and add 52 a forward),
             then a plain run recorded, the kernel path forced to its draws
             (every committed row's |dlogit| within
             HYBRID_DLOGIT_BOUND["serve"], a differing pick only at a near
             tie) and, one key short, above the bound; the same forced arm
             in f32 on the f32 kernels at 6 of the 26 layers (its own
             HYBRID_F32_BOUND; the sound reading, the control and their
             separation printed: bf16's noise on logits of ~900 leaves the
             bf16 bound only 1.03-1.09x from its controls); one decode step of
             8 slots profiled, the RG-LRU and the conv timed on the device;
             a long-context arm through ``engine.generate`` (2 prompts of
             3072 tokens, 32 greedy tokens: a ring prefill, windowed flash
             over 3072 keys, decode over a wrapped ring) with exact
             launches, forced to the plain run's tokens within
             HYBRID_DLOGIT_BOUND["long"], one key short and the ring's
             wrap ignored above it, and for the record a plain run without
             the window. Its kernel records: flash at D = 256
             (the served prefill and the long prompt, window 2048, the
             window's edge checked exactly), the decode at G * D = 2560
             over the served ring and a full ring of 2048, f32 at small
             shapes, RMSNorm at d 2560 (phase 3's cases);
17. smoke_configs — each of the twelve smoke configs in f32 on the card
             (``SMOKE_CONFIGS``: heads of 32 but qwen3-moe's 64, MLA at
             (96, 64)), through its normal entry twice, on the kernels and
             on the plain path: the decoder families on the contiguous pool
             and on paged + chunked (block 8, 24 blocks, budget 16: it
             preempts), 8 greedy requests at pad 16; mamba2 on the
             contiguous pool; recurrentgemma at pad 48, past its 32-row
             ring; whisper and seamless as 2 S-T groups of 4 beams; HSTU's
             forward. The same host counters (prefills, steps, mixed steps,
             preemptions, chunks), the same tokens up to a near tie (beams
             and scores too), launches exactly ``_want_counts``'. Then bf16
             arms teacher-forced to the plain path's greedy tokens (llama
             D = 32, recurrentgemma's ring, deepseek-v2's MLA at 96 / 64),
             each within SMOKE_DLOGIT_BOUND, which the decode kernel one
             key short must break; and the records of the new widths
             (flash, decode and paged decode at D = 32, MLA's prefill and
             latent at (96, 64), f32 and bf16), plus the widths no served
             path runs (D = 16; f32 at (192, 128) and (576, 512)) timed
             and printed outside the ``kernels`` line;
18. examples — the reference's five examples ported
             (``repro_torch.examples``) on the card: quickstart (top-p,
             AutoQuant, LayerSkip lossless), serve_batched (the launcher
             on the HumanEval smoke trace), speech_translation (S-T and
             S-S, batch and served: the served beams the batch run's),
             image_generation (T-I, I-T, the served T-I group the batch
             run's) and train_small (the 67.4 M llama, 300 steps on the
             plain path, checkpoints every 100, as the reference's): the four that serve move
             the attention kernels' counters, train_small none.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the ``{"kernels": [...]}`` summary. Imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 peak outside the tensor cores
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 2e-4)}  # (atol, rtol)
# the SSD scan in f32: the kernel's cumulative decay sums in another order
# than torch.cumsum (the reference's own SSD tolerance, tests/test_kernels.py)
SSD_F32_TOL = (2e-4, 2e-3)
ARCH = "llama3.2-1b"
D_FF = 8192  # llama3.2-1b's FFN width (the kernels phase's int8 shapes)
N_REQUESTS, SLOTS, MAX_NEW, SEED = 16, 8, 64, 0
# the seamless phase: S-T utterances x beams over whisper-base's frames, BOS,
# EOS, new tokens; S-S utterances
N_UTTER, N_BEAMS, N_FRAMES, BOS, EOS, ST_MAX_NEW, N_SS = 4, 4, 1500, 1, 2, 48, 2
# the chameleon phase: chameleon-34b's depth cut (4 of 48 layers), the I-T
# prompt (1024 image tokens + 6 text tokens) and new tokens, the T-I prompt,
# image tokens and guidance
CHAMELEON_LAYERS, N_IMAGE, IT_TEXT, IT_NEW, TI_PROMPT, GUIDANCE = 4, 1024, 6, 30, 14, 3.0
IT_LEN = N_IMAGE + IT_TEXT
#: the speculative phase: LayerSkip's exit layer and drafts a window, and the
#: sampled arms' temperature and top-p
SPEC_EXIT, SPEC_DRAFT, SPEC_TEMP, SPEC_TOP_P = 8, 4, 0.8, 0.9


class PhaseError(RuntimeError):
    pass


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, samples: int = 20, inner: int = 10, warmup: int = 5) -> float:
    """Median over ``samples`` of CUDA-event time around ``inner``
    back-to-back calls, divided by ``inner`` (after ``warmup`` calls). A call
    whose host side outlasts its kernels is timed at its host rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def host_ms(fn, calls: int = 200) -> float:
    """Host time per call of ``fn`` (its enqueue rate), from an idle card:
    ``calls`` calls with no synchronisation between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def profiler(cpu: bool = False, shapes: bool = False):
    """A torch.profiler session over the card (and the host, with ``cpu``;
    the host ops' input shapes too, with ``shapes``), padded with spin
    kernels that ``device_kernels`` leaves out (``op_breakdown``'s
    ``padded_session``): under the card's NVIDIA stack 580.159.03 a long
    process's profiler sessions lost their first device records (this
    script's later phases, in earlier versions of it too), and the spin
    kernels take that loss in their place."""
    from repro_torch.launch.op_breakdown import padded_session

    return padded_session(cpu=cpu, shapes=shapes)


def device_kernels(prof):
    """The CUDA kernel (and memcpy/memset) events of a torch.profiler run,
    ``profiler``'s spin kernels left out."""
    from torch.autograd import DeviceType

    from repro_torch.launch.op_breakdown import PAD_NAME

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and PAD_NAME not in e.name]


def device_ms(fn, calls: int = 20):
    """Device time per call: the summed durations of the kernels that
    ``calls`` calls launched, from torch.profiler (CUPTI), over ``calls``;
    None when the profiler saw no device activity."""
    import torch

    fn()
    torch.cuda.synchronize()
    with profiler() as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kern = device_kernels(prof)
    if not kern:
        return None
    return sum(e.time_range.elapsed_us() for e in kern) / calls / 1e3


#: every profiler session taken again because it saw fewer device kernels
#: than the wrappers launched: where, kernels seen of launched, the kernel
#: names it lacked against the next session, and the first launch index at
#: which the two sessions' kernels differ (0: the session's first kernel)
PROFILE_RETRIES = []


def note_short_session(where: str, short, full, launched: int) -> None:
    """Record and print a session that lost device kernels beside the full
    session that replaced it."""
    from collections import Counter

    a = [e.name for e in sorted(short, key=lambda e: e.time_range.start)]
    b = [e.name for e in sorted(full, key=lambda e: e.time_range.start)]
    lacked = {n[:60]: c for n, c in (Counter(b) - Counter(a)).items()}
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
    PROFILE_RETRIES.append(dict(where=where, seen=len(a), launched=launched, lacked=lacked,
                                first_missing=first))
    print(f"[profile] {where}: a session saw {len(a)} of {launched} device kernels, lacking "
          f"{lacked} (the first difference at launch index {first}); the next session saw "
          f"all {len(b)}", flush=True)


def device_ms_each(fns, per_call, calls: int = 20, where: str = "kernels"):
    """Device time per call of each of ``fns``, where fn i launches exactly
    ``per_call[i]`` device kernels: one profiler session runs every fn
    ``calls`` times in turn, and the kernels, in launch order, are split
    back by fn. A session that saw some but fewer kernels than were
    launched lost events (the profiler drops some now and then): it is
    recorded (``note_short_session``) and taken once more, and the second
    must hold them all. None for all when neither session saw any device
    activity (a profiler that does not see the card)."""
    import torch

    want = calls * sum(per_call)
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    short = None
    for n in range(2):
        with profiler() as prof:
            for fn in fns:
                for _ in range(calls):
                    fn()
            torch.cuda.synchronize()
        kern = sorted(device_kernels(prof), key=lambda e: e.time_range.start)
        if len(kern) == want:
            break
        names = {}
        for e in kern:
            names[e.name[:60]] = names.get(e.name[:60], 0) + 1
        print(f"[{where}] profiler saw {len(kern)} device kernels of the {want} launched: "
              f"{names}", flush=True)
        check(len(kern) < want, f"profiler saw {len(kern)} device kernels, expected {want}")
        check(short is None or not (short or kern),
              f"{where}: two profiler sessions in a row lost device kernels")
        short = kern
    if not kern:
        return [None] * len(fns)
    if short is not None:
        note_short_session(where, short, kern, want)
    out, at = [], 0
    for n in per_call:
        out.append(sum(e.time_range.elapsed_us() for e in kern[at:at + calls * n])
                   / calls / 1e3)
        at += calls * n
    return out


def max_err(got, want, dtype_name: str, tol=None) -> float:
    """max |got - want| in f32; raises if any element is outside
    atol + rtol * |want| (the assert_allclose rule; ``tol`` overrides the
    type's) or not finite."""
    import torch

    g, w = got.float(), want.float()
    atol, rtol = tol if tol is not None else TOL[dtype_name]
    check(bool(torch.isfinite(g).all()), "kernel output is not finite")
    diff = (g - w).abs()
    bad = diff > atol + rtol * w.abs()
    check(not bool(bad.any()),
          f"{int(bad.sum())} elements outside atol={atol} rtol={rtol} "
          f"(max |diff| {float(diff.max()):.3e})")
    return float(diff.max()) if diff.numel() else 0.0


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device():
    import torch

    line = gpu_line()
    print(f"[device] {line} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return line


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    secs = time.perf_counter() - t0
    print(f"[build] {path.name} in {secs:.1f}s", flush=True)
    log = _build.BUILD_DIR / "build.log"
    if log.exists():
        text = log.read_text()
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"[build]   {ln.strip()}", flush=True)
        for name, regs, stores, loads in ptxas_report(text, REDESIGNED):
            print(f"[build] ptxas {name}: {regs} registers, spill stores {stores} bytes, "
                  f"spill loads {loads} bytes", flush=True)
    return secs


#: the redesigned kernels whose ptxas report is summarised
REDESIGNED = ("rmsnorm_warp_kernel", "flash_attention_mma_kernel", "int8_mma_kernel",
              "int8_wo_mma_kernel",
              "decode_attention_kernel", "decode_attention_paged_kernel",
              "decode_attention_combine_kernel", "hstu_attention_mma_kernel", "ssd_chunk_state_kernel",
              "ssd_state_passing_kernel", "ssd_chunk_scan_kernel", "flash_latent_kernel",
              "decode_latent_kernel", "flash_attention_kernel")


def ptxas_report(text: str, names):
    """(kernel, registers, spill store bytes, spill load bytes) of every
    entry function in an ``nvcc -Xptxas -v`` log whose name holds one of
    ``names`` (a template's element type and int argument shown as
    ``<bf16,64>``)."""
    out, cur, spill = [], None, (0, 0)
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = next((n for n in names if n in m.group(1)), None)
            if cur is not None:
                rest = m.group(1)[m.group(1).index(cur) + len(cur):]  # template args
                args = [t for t, code in (("bf16", "I13__nv_bfloat16"), ("f32", "If"))
                        if rest.startswith(code)]
                args += re.findall(r"Li(\d+)E", rest)
                args += [w.lower() for w in re.findall(r"Latent(Contig|Paged)", rest)]
                cur += f"<{','.join(args)}>" if args else ""
            spill = (0, 0)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append((cur, int(m.group(1)), *spill))
            cur = None
    return out


def _rand(gen, shape, dtype, device):
    import torch

    return torch.randn(shape, generator=gen, device=device).to(dtype)


def phase_kernels(pad_to: int, max_len: int):
    """Correctness of every kernel in both types at the main path's shapes
    and edge cases, then bf16 timings; returns the per-kernel records."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.models import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    d_model, hq, hkv, dh = 2048, 32, 8, 64
    errs = {"flash_attention": {}, "decode_attention": {}, "paged_decode_attention": {}}

    # ---- flash attention: the served prefill plus edge cases
    def flash_case(b, t, s, h_q, h_kv, d, dt, *, window=None, positions=None,
                   k_valid=None, causal=True):
        q = _rand(gen, (b, t, h_q, d), dt, dev)
        k = _rand(gen, (b, s, h_kv, d), dt, dev)
        v = _rand(gen, (b, s, h_kv, d), dt, dev)
        if positions is None:
            qp = (torch.arange(t, device=dev) + (s - t)).expand(b, t)
            kp = torch.arange(s, device=dev).expand(b, s)
        else:
            qp, kp = positions
        qp = qp.to(torch.int32).contiguous()
        kp = kp.to(torch.int32).contiguous()
        kw = dict(q_positions=qp, k_positions=kp, causal=causal, window=window,
                  k_valid=k_valid)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        return got, want

    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        got, want = flash_case(1, pad_to, pad_to, hq, hkv, dh, dt)
        errs["flash_attention"][f"{name} prefill T={pad_to}"] = max_err(got, want, name)
        for label, args, kw in (
            ("gqa ragged", (2, 67, 67, 8, 2, 64), {}),
            ("window 16", (2, 67, 67, 8, 2, 64), {"window": 16}),
            ("mqa", (1, 128, 128, 4, 1, 64), {}),
            ("mqa G=64", (1, 67, 67, 64, 1, 64), {}),
            ("mha D=128", (1, 80, 80, 4, 4, 128), {}),
            ("T=1", (1, 1, 1, hq, hkv, dh), {}),
        ):
            got, want = flash_case(*args, dt, **kw)
            errs["flash_attention"][f"{name} {label}"] = max_err(got, want, name)
        # explicit positions + k_valid; batch row 1 sees no valid key at all
        b, t, s = 2, 5, 40
        qp = torch.tensor([[10, 11, 12, 13, 14], [3, 4, 5, 6, 7]], device=dev)
        kp = torch.arange(s, device=dev).expand(b, s)
        kval = kp < torch.tensor([[15], [0]], device=dev)
        got, want = flash_case(b, t, s, 8, 2, 64, dt, positions=(qp, kp),
                               k_valid=kval.contiguous())
        errs["flash_attention"][f"{name} positions+k_valid"] = max_err(got, want, name)
        check(bool((got[1] == 0).all()), "flash: a fully masked row is not exactly zero")

    # ---- decode attention: the served decode step plus edge cases
    def decode_case(b, s, h_q, h_kv, d, dt, lengths):
        q = _rand(gen, (b, h_q, d), dt, dev)
        k = _rand(gen, (b, s, h_kv, d), dt, dev)
        v = _rand(gen, (b, s, h_kv, d), dt, dev)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        return (da.decode_attention_cuda(q, k, v, ln),
                da.decode_attention_plain(q, k, v, ln))

    serve_lengths = [1, max_len, pad_to, pad_to + 1, 44, 100, 200, max_len - 1]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        got, want = decode_case(SLOTS, max_len, hq, hkv, dh, dt, serve_lengths)
        errs["decode_attention"][f"{name} decode S={max_len}"] = max_err(got, want, name)
        # lengths at the edges of the sequence split (0, 1, split - 1, split,
        # split + 1, two splits, S - 1, S); a repeat call is bit-identical
        for s in (max_len, 4096):
            split_len = da.split_plan(SLOTS, hkv, s, n_sms)[1]
            edges = [min(s, n) for n in (0, 1, split_len - 1, split_len, split_len + 1,
                                         2 * split_len, s - 1, s)]
            q = _rand(gen, (SLOTS, hq, dh), dt, dev)
            k, v = (_rand(gen, (SLOTS, s, hkv, dh), dt, dev) for _ in range(2))
            ln = torch.tensor(edges, dtype=torch.int32, device=dev)
            got = da.decode_attention_cuda(q, k, v, ln)
            errs["decode_attention"][f"{name} split edges S={s}"] = max_err(
                got, da.decode_attention_plain(q, k, v, ln), name)
            check(bool((got[0] == 0).all()), "decode: a row of length 0 is not exactly zero")
            check(torch.equal(got, da.decode_attention_cuda(q, k, v, ln)),
                  f"decode: a repeat call differs (S={s})")
        got, want = decode_case(3, 129, 8, 1, 64, dt, [0, 64, 129])
        errs["decode_attention"][f"{name} mqa len 0/64/129"] = max_err(got, want, name)
        check(bool((got[0] == 0).all()), "decode: a row of length 0 is not exactly zero")
        got, want = decode_case(2, 50, 8, 2, 128, dt, [1, 50])
        errs["decode_attention"][f"{name} D=128"] = max_err(got, want, name)

    # ---- paged decode: the served pool (8 slots, block 16, MB = ceil(max_len /
    # 16) = 21, 48 blocks); n_valid of 1, block edges and MB * bs, a freed
    # slot (all-zero table, a drifted count) and a permuted table
    bs, nb = PAGED_ARMS["paged"]["block_size"], PAGED_ARMS["paged"]["num_blocks"]
    mb = -(-max_len // bs)
    paged_valid = [1, bs, 2 * bs, mb * bs, 200, bs + 1, max_len, 64]

    def paged_case(dt):
        q = _rand(gen, (SLOTS, hq, dh), dt, dev)
        kbuf, vbuf = (_rand(gen, (nb, bs, hkv, dh), dt, dev) for _ in range(2))
        perm = torch.randperm(nb - 1, device=dev, generator=gen) + 1
        bt = torch.stack([perm[(i * 5) % (nb - mb):][:mb] for i in range(SLOTS)])
        bt[4] = 0  # a freed slot: its table points at the sink block only
        bt[1] = bt[1].flip(0)  # a descending table
        return q, kbuf, vbuf, bt.to(torch.int32).contiguous()

    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        pq, pk, pv, pbt = paged_case(dt)
        nv = torch.tensor(paged_valid, dtype=torch.int32, device=dev)
        got = pda.paged_decode_attention_cuda(pq, pk, pv, pbt, nv)
        errs["paged_decode_attention"][f"{name} served MB={mb}"] = max_err(
            got, pda.paged_decode_attention_plain(pq, pk, pv, pbt, nv), name)
        check(torch.equal(got, pda.paged_decode_attention_cuda(pq, pk, pv, pbt, nv)),
              f"paged decode: a repeat call differs ({name})")
        gk, gv = (A.paged_gather(x, pbt) for x in (pk, pv))
        errs["paged_decode_attention"][f"{name} vs contiguous kernel"] = max_err(
            got, da.decode_attention_cuda(pq, gk, gv, nv), name)

    # ---- paged decode on the tables of slot groups: streams sharing their
    # prompt's blocks (each write cursor's block unshared copy-on-write), and
    # the same tables after ``permute_group``; bit-identical to the contiguous
    # kernel on the gathered rows and to a repeat call
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        sq, sk, sv, tables, snv = shared_table_case(gen, dt, max_len)
        for label, sbt in tables.items():
            got = pda.paged_decode_attention_cuda(sq, sk, sv, sbt, snv)
            errs["paged_decode_attention"][f"{name} {label} tables"] = max_err(
                got, pda.paged_decode_attention_plain(sq, sk, sv, sbt, snv), name)
            check(torch.equal(got, pda.paged_decode_attention_cuda(sq, sk, sv, sbt, snv)),
                  f"paged decode on {label} tables: a repeat call differs ({name})")
            gk, gv = (A.paged_gather(x, sbt) for x in (sk, sv))
            check(torch.equal(got, da.decode_attention_cuda(sq, gk, gv, snv)),
                  f"paged decode on {label} tables: not the contiguous kernel's bits on the "
                  f"gathered rows ({name})")

    # ---- flash attention at a mixed step's shapes: 8 slots of MIXED_LANES
    # queries against each slot's logical K/V gathered from the served pool
    # (MB * bs keys), positions and k_valid built as the paged layer builds
    # them (``paged_addresses``)
    def mixed_case(dt):
        _, mk, mv, mbt = paged_case(dt)
        q = _rand(gen, (SLOTS, MIXED_LANES, hq, dh), dt, dev)
        ln = torch.tensor(serve_lengths, dtype=torch.int32, device=dev)
        tn = torch.tensor(MIXED_T_NEW, dtype=torch.int32, device=dev)
        addr = A.paged_addresses(mbt, ln, bs, "mixed", tn, MIXED_LANES)
        qp = ln[:, None] + torch.arange(MIXED_LANES, device=dev, dtype=torch.int32)[None]
        kw = dict(q_positions=qp, k_positions=addr["kpos"], causal=True,
                  k_valid=addr["k_valid"])
        return q, A.paged_gather(mk, mbt), A.paged_gather(mv, mbt), kw

    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        mq, mk, mv, mkw = mixed_case(dt)
        got = fa.flash_attention_cuda(mq, mk, mv, **mkw)
        errs["flash_attention"][f"{name} mixed step"] = max_err(
            got, fa.flash_attention_plain(mq, mk, mv, **mkw), name)
        check(torch.equal(got, fa.flash_attention_cuda(mq, mk, mv, **mkw)),
              f"flash: a repeat call differs ({name} mixed step)")

    # ---- flash attention at a verify step's shapes: 8 slots of SPEC_DRAFT + 1
    # lanes against the contiguous cache (max_len keys, k_valid as the
    # contiguous verify layer builds it) and against each slot's logical view
    # gathered from the served pool (``paged_addresses`` in verify mode)
    lanes = SPEC_DRAFT + 1

    def verify_case(dt, paged):
        ln = torch.tensor(VERIFY_LENGTHS, dtype=torch.int32, device=dev)
        tn = torch.tensor(VERIFY_T_NEW, dtype=torch.int32, device=dev)
        q = _rand(gen, (SLOTS, lanes, hq, dh), dt, dev)
        qp = ln[:, None] + torch.arange(lanes, device=dev, dtype=torch.int32)[None]
        if paged:
            _, vk, vv, vbt = paged_case(dt)
            addr = A.paged_addresses(vbt, ln, bs, "verify", tn, lanes)
            k, v = A.paged_gather(vk, vbt), A.paged_gather(vv, vbt)
            kpos, kval = addr["kpos"], addr["k_valid"]
        else:
            k, v = (_rand(gen, (SLOTS, max_len, hkv, dh), dt, dev) for _ in range(2))
            kpos = torch.arange(max_len, device=dev, dtype=torch.int32)[None].expand(
                SLOTS, max_len).contiguous()
            kval = (kpos < (ln + tn)[:, None]).contiguous()
        return q, k, v, dict(q_positions=qp.contiguous(), k_positions=kpos, causal=True,
                             k_valid=kval)

    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        for paged in (False, True):
            label = f"{name} verify {'paged' if paged else 'contiguous'}"
            vq, vk, vv, vkw = verify_case(dt, paged)
            got = fa.flash_attention_cuda(vq, vk, vv, **vkw)
            errs["flash_attention"][label] = max_err(
                got, fa.flash_attention_plain(vq, vk, vv, **vkw), name)
            check(torch.equal(got, fa.flash_attention_cuda(vq, vk, vv, **vkw)),
                  f"flash: a repeat call differs ({label})")
            check(bool((got[VERIFY_T_NEW.index(0)] == 0).all()),
                  "flash: an idle verify slot's rows are not exactly zero")

    # ---- int8 GEMMs: every served linear [M, K] x [K, N] at decode (M = slots)
    # and prefill (M = pad_to), plus M = 1 and ragged edges
    errs["int8_matmul_weight_only"], errs["int8_matmul_dynamic"] = {}, {}
    linears = [(d_model, hq * dh), (d_model, hkv * dh), (d_model, D_FF), (D_FF, d_model)]
    served = [(m, k, n) for m in (SLOTS, pad_to) for k, n in linears]
    exact = 0
    int8_cases = served + [(1, d_model, d_model), (37, 100, 53), (128, 256, 64), (8, 300, 100),
                           (48, 200, 96)]  # K % 16 != 0: the tensor-core kernel's byte path
    for mi, ki, ni in int8_cases:
        xi, wi_q, wi_scale = _int8_operands(gen, mi, ki, ni)
        label = f"[{mi},{ki}]x[{ki},{ni}]"
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            xt = xi.to(dt)
            want = im.int8_matmul_weight_only_plain(xt, wi_q, wi_scale)
            got = im.int8_matmul_weight_only_cuda(xt, wi_q, wi_scale)
            errs["int8_matmul_weight_only"][f"{name} {label}"] = max_err(got, want, name)
            check(torch.equal(got, im.int8_matmul_weight_only_cuda(xt, wi_q, wi_scale)),
                  f"int8_matmul_weight_only: a repeat call differs ({name} {label})")
        xi_q, xi_scale = ops.quantize_rows(xi)
        got = im.int8_matmul_dynamic_cuda(xi_q, wi_q, wi_scale, xi_scale)
        want = im.int8_matmul_dynamic_plain(xi_q, wi_q, wi_scale, xi_scale)
        errs["int8_matmul_dynamic"][f"float32 {label}"] = max_err(got, want, "float32")
        exact += bool(torch.equal(got, want))
    torch.cuda.synchronize()
    for kname, e in errs.items():
        for case, v in e.items():
            print(f"[kernels] {kname:23s} {case:32s} max|err| {v:.3e}", flush=True)
    print(f"[kernels] int8_matmul_dynamic equals its plain version bit for bit in {exact} "
          f"of {len(int8_cases)} shapes", flush=True)
    check(exact == len(int8_cases), "int8_matmul_dynamic is not bit-identical to its plain "
          "version")

    # ---- timings at the main path's shapes, bf16
    bf = torch.bfloat16
    records = rmsnorm_kernel_records(gen, pad_to)

    q = _rand(gen, (1, pad_to, hq, dh), bf, dev)
    k = _rand(gen, (1, pad_to, hkv, dh), bf, dev)
    v = _rand(gen, (1, pad_to, hkv, dh), bf, dev)
    pos = torch.arange(pad_to, device=dev, dtype=torch.int32)[None].contiguous()
    fkw = dict(q_positions=pos, k_positions=pos, causal=True)
    k_exp = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    v_exp = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    q_t = q.transpose(1, 2)
    pairs = pad_to * (pad_to + 1) // 2  # causal (query, key) pairs this input needs
    records.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:88",
        shape=f"q[1,{pad_to},{hq},{dh}] kv[1,{pad_to},{hkv},{dh}] bf16 causal (prefill)",
        max_abs_err=errs["flash_attention"][f"bfloat16 prefill T={pad_to}"],
        call=lambda: fa.flash_attention_cuda(q, k, v, **fkw),
        ms=cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **fkw)),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **fkw)),
        library=lambda: F.scaled_dot_product_attention(q_t, k_exp, v_exp, is_causal=True),
        bytes=(q.numel() * 2 + k.numel() + v.numel()) * 2 + 2 * pad_to * 4,
        flops=pairs * hq * 4 * dh,
    ))

    mq, mk, mv, mkw = mixed_case(bf)
    mk_exp, mv_exp = (x.repeat_interleave(hq // hkv, dim=2).transpose(1, 2) for x in (mk, mv))
    # (query, key) pairs the mask keeps: valid keys at or before each query
    mmask = ((mkw["k_positions"][:, None, :] <= mkw["q_positions"][:, :, None])
             & mkw["k_valid"][:, None, :])
    n_keys = int(mkw["k_valid"].sum())  # key rows this input needs read
    records.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:88",
        shape=f"q[{SLOTS},{MIXED_LANES},{hq},{dh}] kv[{SLOTS},{mk.shape[1]},{hkv},{dh}] bf16 "
              f"(mixed step: lengths {serve_lengths}, t_new {MIXED_T_NEW})",
        max_abs_err=errs["flash_attention"]["bfloat16 mixed step"],
        call=lambda: fa.flash_attention_cuda(mq, mk, mv, **mkw),
        ms=cuda_ms(lambda: fa.flash_attention_cuda(mq, mk, mv, **mkw)),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(mq, mk, mv, **mkw)),
        library=lambda: F.scaled_dot_product_attention(
            mq.transpose(1, 2), mk_exp, mv_exp, attn_mask=mmask[:, None]),
        path="chunked", counter="flash_attention",
        bytes=(2 * mq.numel() + 2 * n_keys * hkv * dh) * 2
        + (mkw["q_positions"].numel() + mkw["k_positions"].numel()) * 4
        + mkw["k_valid"].numel(),
        flops=int(mmask.sum()) * hq * 4 * dh,
    ))

    for paged in (False, True):
        vq, vk, vv, vkw = verify_case(bf, paged)
        vk_exp, vv_exp = (x.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
                          for x in (vk, vv))
        vmask = ((vkw["k_positions"][:, None, :] <= vkw["q_positions"][:, :, None])
                 & vkw["k_valid"][:, None, :])
        where = "paged, keys gathered from the pool" if paged else "contiguous cache"
        records.append(dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:88",
            shape=f"q[{SLOTS},{lanes},{hq},{dh}] kv[{SLOTS},{vk.shape[1]},{hkv},{dh}] bf16 "
                  f"(verify step, {where}: lengths {VERIFY_LENGTHS}, t_new {VERIFY_T_NEW})",
            max_abs_err=errs["flash_attention"][
                f"bfloat16 verify {'paged' if paged else 'contiguous'}"],
            call=lambda a=(vq, vk, vv), kw=vkw: fa.flash_attention_cuda(*a, **kw),
            ms=cuda_ms(lambda a=(vq, vk, vv), kw=vkw: fa.flash_attention_cuda(*a, **kw)),
            plain_ms=cuda_ms(lambda a=(vq, vk, vv), kw=vkw: fa.flash_attention_plain(*a, **kw)),
            library=(lambda qt=vq.transpose(1, 2), ke=vk_exp, ve=vv_exp, m=vmask[:, None]:
                     F.scaled_dot_product_attention(qt, ke, ve, attn_mask=m)),
            path="spec_paged" if paged else "spec", counter="flash_attention",
            bytes=(2 * vq.numel() + 2 * int(vkw["k_valid"].sum()) * hkv * dh) * 2
            + (vkw["q_positions"].numel() + vkw["k_positions"].numel()) * 4
            + vkw["k_valid"].numel(),
            flops=int(vmask.sum()) * hq * 4 * dh,
        ))

    qd = _rand(gen, (SLOTS, hq, dh), bf, dev)
    kc = _rand(gen, (SLOTS, max_len, hkv, dh), bf, dev)
    vc = _rand(gen, (SLOTS, max_len, hkv, dh), bf, dev)
    ln = torch.tensor(serve_lengths, dtype=torch.int32, device=dev)
    kc_exp = kc.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    vc_exp = vc.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    amask = (torch.arange(max_len, device=dev)[None] < ln[:, None])[:, None, None, :]
    n_rows = int(sum(serve_lengths))  # cache rows this input needs read
    records.append(dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:80",
        shape=f"q[{SLOTS},{hq},{dh}] cache[{SLOTS},{max_len},{hkv},{dh}] bf16 "
              f"lengths {serve_lengths}",
        max_abs_err=errs["decode_attention"][f"bfloat16 decode S={max_len}"],
        call=lambda: da.decode_attention_cuda(qd, kc, vc, ln),
        ms=cuda_ms(lambda: da.decode_attention_cuda(qd, kc, vc, ln)),
        plain_ms=cuda_ms(lambda: da.decode_attention_plain(qd, kc, vc, ln)),
        library=lambda: F.scaled_dot_product_attention(qd[:, :, None], kc_exp, vc_exp,
                                                       attn_mask=amask),
        bytes=(2 * qd.numel() + 2 * n_rows * hkv * dh) * 2 + SLOTS * 4,
        flops=n_rows * hq * 4 * dh,
    ))

    pq, pk, pv, pbt = paged_case(bf)
    pnv = torch.tensor(serve_lengths, dtype=torch.int32, device=dev)
    pgk, pgv = (A.paged_gather(x, pbt) for x in (pk, pv))  # the same rows, contiguous
    records.append(dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/models/attention.py:177",
        shape=f"q[{SLOTS},{hq},{dh}] pool[{nb},{bs},{hkv},{dh}] bt[{SLOTS},{mb}] bf16 "
              f"n_valid {serve_lengths}",
        max_abs_err=errs["paged_decode_attention"][f"bfloat16 served MB={mb}"],
        call=lambda: pda.paged_decode_attention_cuda(pq, pk, pv, pbt, pnv),
        ms=cuda_ms(lambda: pda.paged_decode_attention_cuda(pq, pk, pv, pbt, pnv)),
        plain_ms=cuda_ms(lambda: pda.paged_decode_attention_plain(pq, pk, pv, pbt, pnv)),
        library=None,  # no PyTorch call reads a block table
        contiguous_ms=cuda_ms(lambda: da.decode_attention_cuda(pq, pgk, pgv, pnv)),
        contiguous_device_ms=device_ms(lambda: da.decode_attention_cuda(pq, pgk, pgv, pnv)),
        bytes=(2 * pq.numel() + 2 * n_rows * hkv * dh) * 2 + pbt.numel() * 4 + SLOTS * 4,
        flops=n_rows * hq * 4 * dh,
    ))

    # the paged decode on the permuted group tables, on the mixed-classes path
    sq, sk, sv, tables, snv = shared_table_case(gen, bf, max_len)
    sbt = tables["permuted"]
    sgk, sgv = (A.paged_gather(x, sbt) for x in (sk, sv))
    sk_exp, sv_exp = (x.repeat_interleave(hq // hkv, dim=2).transpose(1, 2) for x in (sgk, sgv))
    smask = (torch.arange(sgk.shape[1], device=dev)[None] < snv[:, None])[:, None, None, :]
    # the pool rows these tables reach under n_valid, each read once
    reach = {(int(sbt[b, t // bs]), t % bs) for b in range(SLOTS)
             for t in range(int(snv[b]))}
    records.append(dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/models/attention.py:177",
        shape=f"q[{SLOTS},{hq},{dh}] pool[{nb},{bs},{hkv},{dh}] bt[{SLOTS},{mb}] bf16, a "
              f"4-beam group's tables after permute_group, a 2-stream group, 2 free slots; "
              f"n_valid {snv.tolist()} ({len(reach)} distinct rows)",
        max_abs_err=errs["paged_decode_attention"]["bfloat16 permuted tables"],
        call=lambda: pda.paged_decode_attention_cuda(sq, sk, sv, sbt, snv),
        ms=cuda_ms(lambda: pda.paged_decode_attention_cuda(sq, sk, sv, sbt, snv)),
        plain_ms=cuda_ms(lambda: pda.paged_decode_attention_plain(sq, sk, sv, sbt, snv)),
        library=lambda: F.scaled_dot_product_attention(sq[:, :, None], sk_exp, sv_exp,
                                                       attn_mask=smask),
        path="mixed", counter="paged_decode_attention",
        bytes=(2 * sq.numel() + 2 * len(reach) * hkv * dh) * 2 + sbt.numel() * 4 + SLOTS * 4,
        flops=int(snv.sum()) * hq * 4 * dh,
    ))

    # weight-only at the decode step's widest linear (w1/w3), bf16
    mw, kw, nw = SLOTS, d_model, D_FF
    xw, ww_q, ww_scale = _int8_operands(gen, mw, kw, nw)
    xw = xw.to(bf)
    records.append(dict(
        name="int8_matmul_weight_only", route="cuda",
        source="src/repro_torch/kernels/csrc/int8_matmul.cu",
        replaces="src/repro/kernels/int8_matmul.py:66",
        shape=f"x[{mw},{kw}] bf16 @ w_q[{kw},{nw}] int8 (decode step, w1/w3)",
        max_abs_err=errs["int8_matmul_weight_only"][f"bfloat16 [{mw},{kw}]x[{kw},{nw}]"],
        call=lambda: im.int8_matmul_weight_only_cuda(xw, ww_q, ww_scale),
        ms=cuda_ms(lambda: im.int8_matmul_weight_only_cuda(xw, ww_q, ww_scale)),
        plain_ms=cuda_ms(lambda: im.int8_matmul_weight_only_plain(xw, ww_q, ww_scale)),
        library=lambda: torch.matmul(xw, ww_q.to(xw.dtype)) * ww_scale,
        **_int8_work(mw, kw, nw, dynamic=False),
    ))

    # weight-only at a prefill's widest linear (w1/w3), bf16
    xp = _int8_operands(gen, pad_to, kw, nw)[0].to(bf)
    records.append(dict(
        name="int8_matmul_weight_only", route="cuda",
        source="src/repro_torch/kernels/csrc/int8_matmul.cu",
        replaces="src/repro/kernels/int8_matmul.py:66",
        shape=f"x[{pad_to},{kw}] bf16 @ w_q[{kw},{nw}] int8 (prefill, w1/w3)",
        max_abs_err=errs["int8_matmul_weight_only"][f"bfloat16 [{pad_to},{kw}]x[{kw},{nw}]"],
        call=lambda: im.int8_matmul_weight_only_cuda(xp, ww_q, ww_scale),
        ms=cuda_ms(lambda: im.int8_matmul_weight_only_cuda(xp, ww_q, ww_scale)),
        plain_ms=cuda_ms(lambda: im.int8_matmul_weight_only_plain(xp, ww_q, ww_scale)),
        library=lambda: torch.matmul(xp, ww_q.to(xp.dtype)) * ww_scale,
        **_int8_work(pad_to, kw, nw, dynamic=False),
    ))

    # dynamic at a prefill's widest linear (torch._int_mm refuses M <= 16)
    md = pad_to
    xd, wd_q, wd_scale = _int8_operands(gen, md, kw, nw)
    xd_q, xd_scale = ops.quantize_rows(xd)
    records.append(dict(
        name="int8_matmul_dynamic", route="cuda",
        source="src/repro_torch/kernels/csrc/int8_matmul.cu",
        replaces="src/repro/kernels/int8_matmul.py:104",
        shape=f"x_q[{md},{kw}] int8 @ w_q[{kw},{nw}] int8, f32 out (prefill, w1/w3)",
        max_abs_err=errs["int8_matmul_dynamic"][f"float32 [{md},{kw}]x[{kw},{nw}]"],
        call=lambda: im.int8_matmul_dynamic_cuda(xd_q, wd_q, wd_scale, xd_scale),
        ms=cuda_ms(lambda: im.int8_matmul_dynamic_cuda(xd_q, wd_q, wd_scale, xd_scale)),
        plain_ms=cuda_ms(lambda: im.int8_matmul_dynamic_plain(xd_q, wd_q, wd_scale,
                                                              xd_scale)),
        library=_int_mm_call(xd_q, wd_q, wd_scale, xd_scale),
        **_int8_work(md, kw, nw, dynamic=True),
    ))
    records += hstu_kernel_records(gen) + ssd_kernel_records(gen) + multimodal_kernel_records(gen)
    finish_records(records)
    int8_served_times(gen, served)
    rmsnorm_routes(gen, pad_to)
    return records


def finish_records(records):
    """Each kernel record's bound (from its bytes and operations), device
    time (profiled), and library call's CUDA-event and device times; prints
    a line a record."""
    for r in records:
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("flops"),
                                             r.pop("peak", BF16_FLOPS_PER_S))
        r["kernel_ms"] = r["ms"]
        calls = r.pop("device_calls", 20)
        per_call = r.pop("per_call", None)  # device kernels per call, from the wrapper's plan
        r["device_ms"] = (device_ms(r.pop("call"), calls=calls) if per_call is None else
                          device_ms_each([r.pop("call")], [per_call], calls=calls,
                                         where=f"kernels {r['name']} {r['shape']}")[0])
        lib = r.pop("library")
        r["library_ms"] = None if lib is None else cuda_ms(lib)
        r["library_device_ms"] = None if lib is None else device_ms(lib, calls=calls)

        def fmt(v):
            return "not measured" if v is None else f"{v:.4f} ms"

        lib_txt = ("none" if lib is None else
                   f"{r['library_ms']:.4f} ms (device {fmt(r['library_device_ms'])})")
        print(f"[kernels] {r['name']:23s} kernel {r['ms']:.4f} ms (device "
              f"{fmt(r['device_ms'])}) | plain {r['plain_ms']:.4f} ms | library {lib_txt} | "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}) | {r['shape']}", flush=True)
        if "contiguous_ms" in r:
            print(f"[kernels] {r['name']:23s} the contiguous decode kernel on the same rows "
                  f"laid out contiguously: {r['contiguous_ms']:.4f} ms (device "
                  f"{fmt(r['contiguous_device_ms'])})", flush=True)


def shared_table_case(gen, dt, max_len):
    """A served pool (8 slots, block 16, 48 blocks, llama's K/V heads) after
    slot-group admissions: a 4-beam group prefilled once (200 tokens) with
    its other three streams sharing the blocks, a 2-stream group (100
    tokens) likewise, each stream's write-cursor block unshared
    copy-on-write, two free slots; K/V random. Returns q [8, 32, 64], the
    pool's K and V, the tables {"shared", "permuted": after
    ``permute_group`` of the 4-beam group by parents [1, 1, 3, 0]} and each
    slot's n_valid (a decode step's: the written tokens plus the new one;
    the free slots drifted counts over the sink block)."""
    import types

    import torch

    from repro_torch.core.slot_pool import BlockPool

    dev = torch.device("cuda")
    hq, hkv, dh = 32, 8, 64
    bs, nb = PAGED_ARMS["paged"]["block_size"], PAGED_ARMS["paged"]["num_blocks"]

    class OneLayer:
        config = types.SimpleNamespace(family="dense", sliding_window=None,
                                       scan_layers=False, encdec=None)

        def init_cache(self, batch, length, device):
            return {"lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
                    "layers": [{x: _rand(gen, (batch, length, hkv, dh), dt, device)
                                for x in ("k", "v")}]}

    pool = BlockPool(OneLayer(), SLOTS, max_len, dev, block_size=bs, num_blocks=nb)
    tables = {}
    for first, n, streams in ((0, 200, 4), (4, 100, 2)):
        row = OneLayer().init_cache(1, max_len, dev)
        slots = [pool.acquire() for _ in range(streams)]
        check(slots[0] == first, "shared tables: unexpected slot order")
        pool.assign(slots[0], row, n)
        for s in slots[1:]:
            pool.share(s, slots[0])
        for s in slots:
            check(pool.ensure_writable(s, n), "shared tables: out of blocks")
    check(pool.n_cow_copies == 4, f"shared tables: {pool.n_cow_copies} copy-on-write copies")
    n_valid = torch.tensor([201] * 4 + [101] * 2 + [7, 1], dtype=torch.int32, device=dev)
    tables["shared"] = torch.from_numpy(pool.block_tables.copy()).to(dev)
    pool.permute_group([0, 1, 2, 3], [1, 1, 3, 0])
    tables["permuted"] = torch.from_numpy(pool.block_tables.copy()).to(dev)
    check(len(set(pool.block_tables[:4, 200 // bs].tolist())) == 3,
          "permuted tables: expected two streams on one write-cursor block")
    layer = pool.cache["layers"][0]
    return _rand(gen, (SLOTS, hq, dh), dt, dev), layer["k"], layer["v"], tables, n_valid


def st_frame_lengths(n: int, n_frames: int = N_FRAMES):
    """The S-T batch's frame lengths (``op_breakdown.st_frame_lengths``)."""
    from repro_torch.launch import op_breakdown as ob

    return ob.st_frame_lengths(n, n_frames)


def multimodal_kernel_records(gen):
    """The flash and decode kernels at the shapes the seamless and
    chameleon phases give them, against their plain versions in bf16 and
    f32: the encoder's bidirectional attention over 1500 frames (a key
    count that is no multiple of the 64-key tile), the decoder's
    cross-attention (Tq = 1 against the frames, ``k_valid`` from the S-T
    frame lengths), the decoder's self-attention at the prefill of the BOS
    prompt (Tq = Tk = 1) and at every decode step of the S-T and S-S runs
    (G = 1 at D = 64 over the ``1 + ST_MAX_NEW + 1`` cache rows, the
    lengths of each step), Chameleon's prefill (64/8 heads of 128, G = 8)
    and its T-I decode over a 2-stream cache; a repeat call bit-identical.
    Returns the bf16 records, launches read from their phase's run."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    wh, wd = 8, WHISPER_D // 8  # whisper-base: 8 heads of 64
    hq, hkv, dh = CHAMELEON_HEADS, 8, CHAMELEON_DH
    streams = N_UTTER * N_BEAMS
    fl = torch.tensor(st_frame_lengths(N_UTTER), device=dev).repeat_interleave(N_BEAMS)
    s_ti = TI_PROMPT + N_IMAGE + 1  # the T-I cache rows
    ti_len = torch.full((2,), s_ti - 1, dtype=torch.int32, device=dev)  # its last step
    s_self = 1 + ST_MAX_NEW + 1  # the decoder's self cache: BOS + new tokens + 1
    # the S-T and S-S streams; decode step i (1 .. ST_MAX_NEW - 1) reads i + 1 rows
    self_streams = {"S-T": streams, "S-S": N_SS * N_BEAMS}
    self_lengths = range(2, ST_MAX_NEW + 1)

    def positions(b, t):
        return torch.arange(t, device=dev, dtype=torch.int32)[None].expand(b, t).contiguous()

    # label -> (q, k, v shapes, flash keyword arguments)
    flash = {
        "bidirectional": ((N_UTTER, N_FRAMES, wh, wd), (N_UTTER, N_FRAMES, wh, wd),
                          dict(q_positions=positions(N_UTTER, N_FRAMES),
                               k_positions=positions(N_UTTER, N_FRAMES), causal=False)),
        "cross": ((streams, 1, wh, wd), (streams, N_FRAMES, wh, wd),
                  dict(q_positions=torch.zeros((streams, 1), dtype=torch.int32, device=dev),
                       k_positions=torch.zeros((streams, N_FRAMES), dtype=torch.int32,
                                               device=dev),
                       causal=False,
                       k_valid=(torch.arange(N_FRAMES, device=dev)[None]
                                < fl[:, None]).contiguous())),
        "chameleon prefill": ((1, IT_LEN, hq, dh), (1, IT_LEN, hkv, dh),
                              dict(q_positions=positions(1, IT_LEN),
                                   k_positions=positions(1, IT_LEN), causal=True)),
    }
    for run, b in self_streams.items():  # the decoder's self-attention at the prefill
        flash[f"self prefill {run}"] = ((b, 1, wh, wd), (b, 1, wh, wd),
                                        dict(q_positions=positions(b, 1),
                                             k_positions=positions(b, 1), causal=True))
    errs, inputs = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        for label, (qs, ks, kw) in flash.items():
            q, k, v = _rand(gen, qs, dt, dev), _rand(gen, ks, dt, dev), _rand(gen, ks, dt, dev)
            got = fa.flash_attention_cuda(q, k, v, **kw)
            errs[f"flash {name} {label}"] = max_err(got, fa.flash_attention_plain(q, k, v, **kw),
                                                    name)
            check(torch.equal(got, fa.flash_attention_cuda(q, k, v, **kw)),
                  f"flash: a repeat call differs ({name} {label})")
            inputs[(label, name)] = (q, k, v, kw)
        q = _rand(gen, (2, hq, dh), dt, dev)
        k, v = (_rand(gen, (2, s_ti, hkv, dh), dt, dev) for _ in range(2))
        got = da.decode_attention_cuda(q, k, v, ti_len)
        errs[f"decode {name} chameleon T-I"] = max_err(
            got, da.decode_attention_plain(q, k, v, ti_len), name)
        check(torch.equal(got, da.decode_attention_cuda(q, k, v, ti_len)),
              f"decode: a repeat call differs ({name} chameleon T-I)")
        inputs[("decode", name)] = (q, k, v, ti_len)
        for run, b in self_streams.items():  # every decode step's lengths of the run
            q = _rand(gen, (b, wh, wd), dt, dev)
            k, v = (_rand(gen, (b, s_self, wh, wd), dt, dev) for _ in range(2))
            worst = 0.0
            for n in self_lengths:
                ln = torch.full((b,), n, dtype=torch.int32, device=dev)
                got = da.decode_attention_cuda(q, k, v, ln)
                worst = max(worst, max_err(got, da.decode_attention_plain(q, k, v, ln), name))
                check(torch.equal(got, da.decode_attention_cuda(q, k, v, ln)),
                      f"decode: a repeat call differs ({name} self {run}, length {n})")
            errs[f"decode {name} self {run} lengths 2..{ST_MAX_NEW}"] = worst
            inputs[("decode self", run, name)] = (q, k, v, ln)
    torch.cuda.synchronize()
    for case, e in errs.items():
        print(f"[kernels] multimodal {case:40s} max|err| {e:.3e}", flush=True)

    def expand(x, g):  # GQA K/V repeated per q head, [B, H, T, D], for SDPA
        return x.repeat_interleave(g, dim=2).transpose(1, 2)

    records = []
    for label, shape_txt, path in (
            ("bidirectional", f"q/k/v[{N_UTTER},{N_FRAMES},{wh},{wd}] bf16 non-causal "
                              "(whisper encoder)", "seamless"),
            ("cross", f"q[{streams},1,{wh},{wd}] kv[{streams},{N_FRAMES},{wh},{wd}] bf16 "
                      f"k_valid frame lengths {fl[::N_BEAMS].tolist()} (cross-attention, "
                      "decode step)", "seamless"),
            ("self prefill S-T", f"q/k/v[{streams},1,{wh},{wd}] bf16 causal (decoder "
                                 "self-attention, prefill of the BOS prompt)", "seamless"),
            ("chameleon prefill", f"q[1,{IT_LEN},{hq},{dh}] kv[1,{IT_LEN},{hkv},{dh}] bf16 "
                                  "causal (chameleon I-T prefill)", "chameleon")):
        q, k, v, kw = inputs[(label, "bfloat16")]
        g = q.shape[2] // k.shape[2]
        ke, ve, qt = expand(k, g), expand(v, g), q.transpose(1, 2)
        kval = kw.get("k_valid")
        if kval is not None:  # keys this input needs read, every pair kept
            keys = int(kval.sum())
            pairs = keys * q.shape[1]
            lib = (lambda qt=qt, ke=ke, ve=ve, m=kval[:, None, None, :]:
                   F.scaled_dot_product_attention(qt, ke, ve, attn_mask=m))
        else:
            keys = k.shape[0] * k.shape[1]
            t = q.shape[1]
            pairs = q.shape[0] * (t * (t + 1) // 2 if kw["causal"] else t * t)
            lib = (lambda qt=qt, ke=ke, ve=ve, c=kw["causal"]:
                   F.scaled_dot_product_attention(qt, ke, ve, is_causal=c))
        records.append(dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:88", shape=shape_txt,
            max_abs_err=errs[f"flash bfloat16 {label}"],
            call=lambda a=(q, k, v), kw=kw: fa.flash_attention_cuda(*a, **kw),
            ms=cuda_ms(lambda a=(q, k, v), kw=kw: fa.flash_attention_cuda(*a, **kw)),
            plain_ms=cuda_ms(lambda a=(q, k, v), kw=kw: fa.flash_attention_plain(*a, **kw)),
            library=lib, path=path, counter="flash_attention",
            bytes=(2 * q.numel() + 2 * keys * k.shape[2] * k.shape[3]) * 2
            + (kw["q_positions"].numel() + kw["k_positions"].numel()) * 4
            + (0 if kval is None else kval.numel()),
            flops=pairs * q.shape[2] * 4 * q.shape[3],
        ))
    for key, err, shape_txt, path in (
            (("decode", "bfloat16"), "decode bfloat16 chameleon T-I",
             "(chameleon T-I decode, G*D = 1024)", "chameleon"),
            (("decode self", "S-T", "bfloat16"),
             f"decode bfloat16 self S-T lengths 2..{ST_MAX_NEW}",
             f"(decoder self-attention, G = 1; max |err| over lengths 2..{ST_MAX_NEW})",
             "seamless")):
        q, k, v, ln = inputs[key]
        b, h, d = q.shape
        s_rows, h_kv = k.shape[1], k.shape[2]
        n_rows = int(ln.sum())
        amask = (torch.arange(s_rows, device=dev)[None] < ln[:, None])[:, None, None, :]
        ke, ve = expand(k, h // h_kv), expand(v, h // h_kv)
        records.append(dict(
            name="decode_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:80",
            shape=f"q[{b},{h},{d}] cache[{b},{s_rows},{h_kv},{d}] bf16 lengths "
                  f"{sorted(set(ln.tolist()))} {shape_txt}",
            max_abs_err=errs[err],
            call=lambda a=(q, k, v, ln): da.decode_attention_cuda(*a),
            ms=cuda_ms(lambda a=(q, k, v, ln): da.decode_attention_cuda(*a)),
            plain_ms=cuda_ms(lambda a=(q, k, v, ln): da.decode_attention_plain(*a)),
            library=(lambda q=q, ke=ke, ve=ve, m=amask:
                     F.scaled_dot_product_attention(q[:, :, None], ke, ve, attn_mask=m)),
            path=path, counter="decode_attention",
            bytes=(2 * q.numel() + 2 * n_rows * h_kv * d) * 2 + b * 4,
            flops=n_rows * h * 4 * d,
        ))
    return records


def bound(n_bytes: float, ops: float, peak: float):
    """(least ms, "bytes" or "operations"): the bytes over the card's memory
    rate against the operations over its peak rate for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _int8_work(m: int, k: int, n: int, dynamic: bool):
    """What an int8 GEMM [m, k] x [k, n] must move and do: x (bf16, or int8
    with its f32 row scales), the int8 weights and their f32 scales read
    once, the output (bf16, or f32) written once; 2mkn operations at the
    bf16 (weight-only) or int8 (dynamic) tensor-core peak."""
    if dynamic:
        return dict(bytes=m * k + 4 * m + k * n + 4 * n + 4 * m * n, flops=2 * m * k * n,
                    peak=INT8_OPS_PER_S)
    return dict(bytes=2 * m * k + k * n + 4 * n + 2 * m * n, flops=2 * m * k * n,
                peak=BF16_FLOPS_PER_S)


def _int8_operands(gen, m: int, k: int, n: int):
    """x [m, k] f32 ~ N(0, 1) and a quantized fan-in-scaled weight, so the
    product is O(1) as in the served layers."""
    import torch

    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    x = _rand(gen, (m, k), torch.float32, dev)
    w = _rand(gen, (k, n), torch.float32, dev) * k ** -0.5
    return (x, *ops.quantize_int8(w, axis=0))


def _int_mm_call(x_q, w_q, w_scale, x_scale):
    """torch._int_mm plus the f32 epilogue, the dynamic kernel's library
    yardstick, as a call; None where _int_mm refuses the shape."""
    import torch

    def call():
        return torch._int_mm(x_q, w_q).float() * x_scale * w_scale

    try:
        call()
    except RuntimeError as e:
        print(f"[kernels] torch._int_mm refused [{x_q.shape[0]},{x_q.shape[1]}]x"
              f"[{w_q.shape[0]},{w_q.shape[1]}]: {str(e).splitlines()[0]}", flush=True)
        return None
    return call


def int8_served_times(gen, served):
    """Device time of both int8 kernels at every served linear shape (bf16
    x for weight-only; the split-K sum included), beside the bound and the
    library call (with its own device time), and the weight-only call's
    ``ms`` and host time (``host_ms``) on the route the wrapper takes."""
    import torch

    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import ops

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count

    def fmt(v):
        return "not measured" if v is None else f"{v:.4f}"

    for m in sorted({s[0] for s in served}):
        shapes = [s for s in served if s[0] == m]
        ops_in = [_int8_operands(gen, *s) for s in shapes]
        wo_in = [(x.to(torch.bfloat16), w_q, w_scale) for x, w_q, w_scale in ops_in]
        dyn_in = [(*ops.quantize_rows(x), w_q, w_scale) for x, w_q, w_scale in ops_in]
        # the GEMM, plus the split-K sum where K is split, with the plan the
        # wrapper takes; both kernels in one profiler session
        wo_plans = [im.plan_weight_only(m, n, k, torch.bfloat16, n_sms) for _, k, n in shapes]
        dyn_splits = [im.split_k_dynamic(m, n, k, n_sms)[0] for _, k, n in shapes]
        fns = [lambda a=a: im.int8_matmul_weight_only_cuda(*a) for a in wo_in]
        fns += [lambda a=a: im.int8_matmul_dynamic_cuda(a[0], a[2], a[3], a[1])
                for a in dyn_in]
        dev_ms = device_ms_each(fns, [1 + (p[1] > 1) for p in wo_plans]
                                + [1 + (z > 1) for z in dyn_splits], where=f"int8 M={m}")
        wo_dev, dyn_dev = dev_ms[:len(shapes)], dev_ms[len(shapes):]
        for i, (_, k, n) in enumerate(shapes):
            x, w_q, w_scale = wo_in[i]
            wo_bound = bound(*_int8_work(m, k, n, dynamic=False).values())[0]
            wo_lib = lambda: torch.matmul(x, w_q.to(x.dtype)) * w_scale  # noqa: E731
            x_q, x_scale, wq, ws = dyn_in[i]
            dyn_bound = bound(*_int8_work(m, k, n, dynamic=True).values())[0]
            dyn_lib = _int_mm_call(x_q, wq, ws, x_scale) if m > 16 else None
            lib_txt = ("none" if dyn_lib is None else
                       f"{cuda_ms(dyn_lib):.4f}, device {fmt(device_ms(dyn_lib))}")
            call = lambda: im.int8_matmul_weight_only_cuda(x, w_q, w_scale)  # noqa: E731
            tile_m, splits = wo_plans[i][:2]
            wo_txt = (f"{tile_m}-row tiles ({splits} splits) {fmt(wo_dev[i])} (ms "
                      f"{cuda_ms(call):.4f}, host {host_ms(call):.4f})")
            print(f"[kernels] int8 [{m},{k}]x[{k},{n}]: weight-only device ms {wo_txt} "
                  f"(bound {wo_bound:.5f}, library "
                  f"{cuda_ms(wo_lib):.4f}, device {fmt(device_ms(wo_lib))}) | dynamic "
                  f"({dyn_splits[i]} splits) device {fmt(dyn_dev[i])} ms (bound "
                  f"{dyn_bound:.5f}, library {lib_txt})", flush=True)


def hstu_forward_rows() -> tuple:
    """(histories, padded length) of the ``hstu`` phase's batch."""
    from repro_torch.training import data as data_mod

    return N_HISTORIES, max(len(h) for h in data_mod.hstu_user_histories(N_HISTORIES, seed=0))


#: widths of the served RMSNorms and the row stride of the projection that
#: their second operand is a slice of (HSTU's u of uvqk, Mamba-2's z of
#: zxbcdt); llama's and the residual adds' operands are contiguous
LLAMA_D, MAMBA_D, MAMBA_D_IN, MAMBA_ZXBCDT, HSTU_D, HSTU_UVQK = 2048, 768, 1536, 3352, 512, 2048
#: whisper-base's width, and chameleon-34b's width and head (its qk-norm rows)
WHISPER_D, CHAMELEON_D, CHAMELEON_HEADS, CHAMELEON_DH = 512, 8192, 64, 128
YI_D, LLAMA405_D = 7168, 16384  # the dense phase's widest norms
HYBRID_D = 2560  # recurrentgemma-2b's d_model


def rmsnorm_cases(pad_to: int):
    """(label, path, prologue, x shape, second operand's row stride or None)
    of every served RMSNorm: checked in both types; those with a path are
    also timed in bf16, their launches read from that path's run."""
    b, t = hstu_forward_rows()
    return [
        ("llama decode", "serve", "none", (SLOTS, 1, LLAMA_D), None),
        ("llama decode", "serve", "add", (SLOTS, 1, LLAMA_D), None),
        ("llama prefill", None, "none", (1, pad_to, LLAMA_D), None),
        ("llama prefill", "serve", "add", (1, pad_to, LLAMA_D), None),
        ("llama mixed", "chunked", "none", (SLOTS, MIXED_LANES, LLAMA_D), None),
        ("llama mixed", "chunked", "add", (SLOTS, MIXED_LANES, LLAMA_D), None),
        ("mamba2 decode", None, "add", (SLOTS, 1, MAMBA_D), None),
        ("mamba2 decode", None, "mul_silu", (SLOTS, 1, MAMBA_D_IN), MAMBA_ZXBCDT),
        ("mamba2 prefill", None, "add", (1, pad_to, MAMBA_D), None),
        ("mamba2 prefill", "ssm", "mul_silu", (1, pad_to, MAMBA_D_IN), MAMBA_ZXBCDT),
        ("hstu forward", "hstu", "none", (b, t, HSTU_D), None),
        ("hstu forward", "hstu", "add", (b, t, HSTU_D), None),
        ("hstu forward", "hstu", "mul", (b, t, HSTU_D), HSTU_UVQK),
        ("whisper encoder", None, "add", (N_UTTER * N_BEAMS, N_FRAMES, WHISPER_D), None),
        ("whisper decode", None, "add", (N_UTTER * N_BEAMS, 1, WHISPER_D), None),
        ("chameleon qk-norm prefill", "chameleon", "none",
         (IT_LEN * CHAMELEON_HEADS, CHAMELEON_DH), None),
        ("chameleon qk-norm decode", None, "none", (2 * CHAMELEON_HEADS, CHAMELEON_DH), None),
        ("chameleon prefill", None, "add", (1, IT_LEN, CHAMELEON_D), None),
        ("yi-34b decode", "dense yi-34b", "none", (SLOTS, 1, YI_D), None),
        ("yi-34b prefill", "dense yi-34b", "add", (1, pad_to, YI_D), None),
        ("llama3-405b decode", "dense llama3-405b", "none", (SLOTS, 1, LLAMA405_D), None),
        ("llama3-405b prefill", "dense llama3-405b", "add", (1, pad_to, LLAMA405_D), None),
        ("recurrentgemma decode", "hybrid", "none", (SLOTS, 1, HYBRID_D), None),
        ("recurrentgemma prefill", "hybrid", "add", (1, pad_to, HYBRID_D), None),
    ]


def rmsnorm_routes(gen, pad_to: int) -> None:
    """The kernel each RMSNorm grid takes, from the profiler's kernel names
    (the warp kernel's template arguments: type, prologue, elements a lane,
    warps a row), against ``rmsnorm.route``: the served grids, a wide one,
    one past one warp's budget and one past eight warps' (the block path)."""
    import torch

    from repro_torch.kernels import rmsnorm as rn

    dev = torch.device("cuda")
    for rows, d, dt in ((8, LLAMA_D, torch.bfloat16), (pad_to, LLAMA_D, torch.bfloat16),
                        (SLOTS * MIXED_LANES, LLAMA_D, torch.bfloat16),
                        (SLOTS, MAMBA_D, torch.bfloat16), (pad_to, MAMBA_D_IN, torch.bfloat16),
                        (4096, HSTU_D, torch.bfloat16), (4096, 4096, torch.bfloat16),
                        (3, 20000, torch.bfloat16), (4096, HSTU_D, torch.float32),
                        (pad_to, MAMBA_D_IN, torch.float32), (3, 9000, torch.float32),
                        (IT_LEN * CHAMELEON_HEADS, CHAMELEON_DH, torch.bfloat16),
                        (N_UTTER * N_BEAMS * N_FRAMES, WHISPER_D, torch.bfloat16),
                        (SLOTS, YI_D, torch.bfloat16), (pad_to, YI_D, torch.bfloat16),
                        (SLOTS, LLAMA405_D, torch.bfloat16),
                        (pad_to, LLAMA405_D, torch.bfloat16),
                        (SLOTS, HYBRID_D, torch.bfloat16), (pad_to, HYBRID_D, torch.bfloat16)):
        x = _rand(gen, (rows, d), dt, dev)
        w = torch.ones((d,), dtype=dt, device=dev)
        with profiler() as prof:
            rn.rmsnorm_cuda(x, w)
            torch.cuda.synchronize()
        kern = device_kernels(prof)
        if kern:
            route, warps, per_lane = rn.route(rows, d, dt)
            tname = "__nv_bfloat16" if dt == torch.bfloat16 else "float"
            name = (f"rmsnorm_warp_kernel<{tname}, 0, {per_lane}, {warps}>" if route == "warp"
                    else "rmsnorm_block_kernel")
            other = "rmsnorm_block_kernel" if route == "warp" else "rmsnorm_warp_kernel"
            check_kernel_names(kern, {name: 1, other: 0},
                               f"kernels rmsnorm [{rows}, {d}] {str(dt).split('.')[-1]}",
                               again=lambda x=x, w=w: rn.rmsnorm_cuda(x, w))


def rmsnorm_work(prologue: str, n: int, d: int, elt: int = 2):
    """Bytes RMSNorm with ``prologue`` must move over n elements of rows of
    width d (its inputs once, the weight once, y, and add's s, once) and
    its operations (square-accumulate, scale and weight: 4 a element; the
    prologue's add or mul 1 more; silu's negate, exp, add and divide 4
    more)."""
    tensors = {"none": 2, "add": 4, "mul": 3, "mul_silu": 3}[prologue]
    ops_ = {"none": 4, "add": 5, "mul": 5, "mul_silu": 9}[prologue]
    return dict(bytes=(tensors * n + d) * elt, flops=ops_ * n, peak=F32_FLOPS_PER_S)


def rmsnorm_kernel_records(gen, pad_to: int):
    """Every prologue at every served shape against its plain version, in
    bf16 and f32, the second operand as the models pass it (a slice of its
    projection); add's sum equal to x + r, and each fused output equal to
    the none kernel on the unfused ops' result, bit for bit (the prologue
    rounds as torch's ops round); a repeat call bit-identical. Returns the
    bf16 records of the cases with a path."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    dev = torch.device("cuda")
    kernel = {"none": lambda x, o, w: (None, rn.rmsnorm_cuda(x, w)),
              "add": rn.add_rmsnorm_cuda,
              "mul": lambda x, o, w: (None, rn.mul_rmsnorm_cuda(x, o, w)),
              "mul_silu": lambda x, o, w: (None, rn.mul_silu_rmsnorm_cuda(x, o, w))}
    plain = {"none": lambda x, o, w: (None, rn.rmsnorm_plain(x, w)),
             "add": rn.add_rmsnorm_plain,
             "mul": lambda x, o, w: (None, rn.mul_rmsnorm_plain(x, o, w)),
             "mul_silu": lambda x, o, w: (None, rn.mul_silu_rmsnorm_plain(x, o, w))}
    unfused = {"add": lambda x, o: x + o, "mul": lambda x, o: x * o,
               "mul_silu": lambda x, o: x * F.silu(o)}

    def operands(shape, stride, dt):
        x = _rand(gen, shape, dt, dev) * 3
        d = shape[-1]
        wide = _rand(gen, (*shape[:-1], stride or d), dt, dev)
        other = wide[..., :d] if stride else wide
        w = (1 + 0.1 * _rand(gen, (d,), torch.float32, dev)).to(dt)
        return x, other, w

    errs, timed = {}, []
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        for label, path, prologue, shape, stride in rmsnorm_cases(pad_to):
            x, other, w = operands(shape, stride, dt)
            s, y = kernel[prologue](x, other, w)
            ws, wy = plain[prologue](x, other, w)
            case = f"{name} {prologue} {label} {list(shape)}"
            errs[case] = max_err(y, wy, name)
            check(torch.equal(y, kernel[prologue](x, other, w)[1]),
                  f"rmsnorm: a repeat call differs ({case})")
            if prologue == "add":
                check(torch.equal(s, ws), f"rmsnorm: add's sum is not x + r bit for bit ({case})")
            if prologue != "none":
                check(torch.equal(y, rn.rmsnorm_cuda(unfused[prologue](x, other), w)),
                      f"rmsnorm: the fused output differs from the none kernel on the "
                      f"unfused result ({case})")
            if path is not None and dt == torch.bfloat16:
                timed.append((label, path, prologue, shape, stride, (x, other, w), case))
    torch.cuda.synchronize()
    for case, v in errs.items():
        print(f"[kernels] {'rmsnorm':23s} {case:44s} max|err| {v:.3e}", flush=True)

    records = []
    for label, path, prologue, shape, stride, (x, other, w), case in timed:
        n, d = x.numel(), shape[-1]
        call = lambda p=prologue, a=(x, other, w): kernel[p](*a)  # noqa: E731
        rec = dict(
            name="rmsnorm", prologue=prologue, route="cuda",
            source="src/repro_torch/kernels/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm.py:25",
            shape=f"{prologue} x{list(shape)} bf16"
                  + (f", second operand row stride {stride}" if stride else "") + f" ({label})",
            max_abs_err=errs[case], call=call, ms=cuda_ms(call),
            plain_ms=cuda_ms(lambda p=prologue, a=(x, other, w): plain[p](*a)),
            library=(lambda a=(x, w, d): F.rms_norm(a[0], (a[2],), a[1], 1e-5))
            if prologue == "none" else None,
            path=path, counter=f"rmsnorm/{prologue}", per_call=1,
            **rmsnorm_work(prologue, n, d),
        )
        records.append(rec)
    return records


def hstu_in_band_pairs(t: int, lengths, band) -> int:
    """(query, key) pairs the HSTU mask keeps over a batch: j <= i,
    i - j < band (when given) and j < length; the work these inputs need."""
    import numpy as np

    i = np.arange(t)
    lo = np.maximum(0, i - band + 1) if band is not None else np.zeros_like(i)
    return sum(int(np.clip(np.minimum(i, ln - 1) - lo + 1, 0, None).sum()) for ln in lengths)


HSTU_T, HSTU_LENGTHS, HSTU_BAND = 5121, [4507, 5121], 1024
# bf16 HSTU beside the elementwise tolerance: its outputs are divided by T,
# so with the band every full-width output lies below the bf16 atol and
# zeros would pass that alone; max |err| must stay within this share of
# max |want| per call
HSTU_NORMWISE = 1e-2


def hstu_normwise(got, want) -> float:
    """max |got - want| / max |want| of one call; raises above HSTU_NORMWISE."""
    err = float((got.float() - want.float()).abs().max())
    rel = err / max(float(want.float().abs().max()), 1e-30)
    check(rel <= HSTU_NORMWISE,
          f"hstu: max |err| {err:.3e} is {rel:.3e} of max |want| (limit {HSTU_NORMWISE})")
    return rel


def hstu_kernel_records(gen):
    """HSTU attention against its plain version (edge cases in both types,
    the full width q/k/v [2, 5121, 8, 64], lengths 4507 / 5121, no band and
    the 1024 band in bf16; bf16 also normwise), a repeat call bit-identical
    and a row of length 0 exactly zero; then times at the full width with
    the band (11 of the 14 layers' launch) on both routes: bf16 on the
    tensor-core kernel, f32 on the CUDA-core kernel. Returns their records."""
    import torch

    from repro_torch.kernels import hstu_attention as ha

    dev = torch.device("cuda")
    errs, norms = {}, {}

    def inputs(b, t, h, d, dt, n_bias, band, lens):
        q, k, v = (_rand(gen, (b, t, h, d), dt, dev) for _ in range(3))
        rb = _rand(gen, (n_bias,), torch.float32, dev) * 0.1
        return (q, k, v, rb), dict(max_attn_len=band,
                                   lengths=torch.tensor(lens, dtype=torch.int32, device=dev))

    def held(label, name, args, kw):
        got = ha.hstu_attention_cuda(*args, **kw)
        want = ha.hstu_attention_plain(*args, **kw)
        errs[f"{name} {label}"] = max_err(got, want, name)
        if name == "bfloat16":
            norms[f"{name} {label}"] = hstu_normwise(got, want)
        check(torch.equal(got, ha.hstu_attention_cuda(*args, **kw)),
              f"hstu: a repeat call differs ({name} {label})")
        return got

    cases = [("T=133 band 24, lengths 0/133", (2, 133, 4, 64, 4095, 24, [0, 133])),
             ("D=32 T=70 clipped table 127", (2, 70, 4, 32, 127, None, [40, 70])),
             ("T=1100 band 1024", (2, 1100, 8, 64, 4095, 1024, [900, 1100])),
             ("T=300 band 100, lengths 211/300", (2, 300, 2, 64, 4095, 100, [211, 300]))]
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        for label, (b, t, h, d, n_bias, band, lens) in cases:
            args, kw = inputs(b, t, h, d, dt, n_bias, band, lens)
            got = held(label, name, args, kw)
            if lens[0] == 0:
                check(bool((got[0] == 0).all()), "hstu: a row of length 0 is not exactly zero")
    full = {}
    for dt, band in ((torch.bfloat16, None), (torch.bfloat16, HSTU_BAND),
                     (torch.float32, HSTU_BAND)):
        name = str(dt).split(".")[-1]
        args, kw = inputs(2, HSTU_T, 8, 64, dt, 4095, band, HSTU_LENGTHS)
        held(f"full width band {band}", name, args, kw)
        full[name, band] = (args, kw)
    torch.cuda.synchronize()
    for case, v in errs.items():
        extra = f" | {norms[case]:.3e} of max|want|" if case in norms else ""
        print(f"[kernels] {'hstu_attention':23s} {case:32s} max|err| {v:.3e}{extra}",
              flush=True)

    records = []
    for (name, band), (args, kw) in full.items():
        q = args[0]
        pairs = hstu_in_band_pairs(HSTU_T, HSTU_LENGTHS, band)
        rec = dict(
            name="hstu_attention", route="cuda", dtype=name,
            source="src/repro_torch/kernels/csrc/hstu_attention.cu",
            replaces="src/repro/kernels/hstu_attention.py:87",
            shape=f"q/k/v[2,{HSTU_T},8,64] {name} lengths {HSTU_LENGTHS} band {band}",
            max_abs_err=errs[f"{name} full width band {band}"],
            call=lambda a=args, k=kw: ha.hstu_attention_cuda(*a, **k),
            ms=cuda_ms(lambda a=args, k=kw: ha.hstu_attention_cuda(*a, **k),
                       samples=5, inner=2, warmup=1),
            plain_ms=cuda_ms(lambda a=args, k=kw: ha.hstu_attention_plain(*a, **k),
                             samples=3, inner=1, warmup=1),
            library=None,  # no single PyTorch call computes SiLU attention with this bias
            bytes=4 * q.numel() * q.element_size() + args[3].numel() * 4 + 2 * 4,
            flops=pairs * q.shape[2] * 4 * q.shape[3], device_calls=3, per_call=1,
        )
        if name == "float32":  # f32 operations at the CUDA cores' peak
            rec["peak"] = F32_FLOPS_PER_S
        if band is None:  # printed for the record; the JSON line keeps the banded call
            b_ms, b_by = bound(rec["bytes"], rec["flops"], BF16_FLOPS_PER_S)
            dev = device_ms_each([rec["call"]], [1], calls=3, where="kernels hstu no band")[0]
            dev_txt = "not measured" if dev is None else f"{dev:.4f} ms"
            print(f"[kernels] hstu_attention (no band, layers 0-2) kernel {rec['ms']:.4f} ms "
                  f"(device {dev_txt}) | plain "
                  f"{rec['plain_ms']:.4f} ms | bound {b_ms:.5f} ms ({b_by}) | "
                  f"{pairs} in-band pairs", flush=True)
            continue
        records.append(rec)
    return records


def _ssd_inputs(gen, b, t, h, p, g, n, dt, init):
    """x, B, C ~ N(0, 1) in ``dt``; dt = 0.1 softplus(N(0, 1)); A = -(1..16)
    as the model's A_log init; D = 1; an N(0, 1) initial state or None."""
    import torch

    dev = torch.device("cuda")
    step = torch.nn.functional.softplus(_rand(gen, (b, t, h), torch.float32, dev)) * 0.1
    return dict(x=_rand(gen, (b, t, h, p), dt, dev), dt=step,
                A=-torch.linspace(1.0, 16.0, h, device=dev),
                B_=_rand(gen, (b, t, g, n), dt, dev), C=_rand(gen, (b, t, g, n), dt, dev),
                D=torch.ones((h,), device=dev),
                initial_state=_rand(gen, (b, h, p, n), torch.float32, dev) if init else None)


def ssd_work(b, t, h, p, g, n, chunk, init, elt=2):
    """Bytes the scan must move (inputs once, y and the final state once)
    and the operations of the chunked algorithm on them: per (b, h) and
    chunk of L positions, the causal pairs' C.B and score.x products,
    the inter-chunk C.h and the state update."""
    n_bytes = (2 * b * t * h * p * elt + b * t * h * 4 + 2 * h * 4 + 2 * b * t * g * n * elt
               + b * h * p * n * 4 * (2 if init else 1))
    ops_ = 0
    for t0 in range(0, t, chunk):
        length = min(chunk, t - t0)
        ops_ += length * (length + 1) // 2 * (2 * n + 2 * p) + 4 * length * n * p
    return n_bytes, b * h * ops_


SSM_WIDTH = (1, 256, 24, 64, 1, 128, 256)  # B, T (= pad_to), H, P, G, N, chunk


def ssd_kernel_records(gen):
    """The SSD scan against its plain version: the served prefill width
    [1, 256, 24, 64] / N 128 / one 256-chunk, four 128-chunks with a ragged
    last one, G = 2 and an initial state, a T below the chunk, and five
    64-chunks with no initial state; in bf16 (the chunk-parallel
    tensor-core route) and f32 (the single-block walk, at the SSD
    tolerance), the state at the SSD tolerance in both; a repeat call
    bit-identical. Then the served width's times on both routes, the
    profiler's kernels per call from ``launch_plan``."""
    import torch

    from repro_torch.kernels import ssd_scan as ss

    errs = {}
    cases = [("served prefill [1,256,24,64] N128", SSM_WIDTH + (False,)),
             ("4 chunks T=461 G=2 init", (2, 461, 8, 64, 2, 128, 128, True)),
             ("T=5 < chunk, init", (1, 5, 2, 16, 1, 8, 256, True)),
             ("5 chunks T=300, no init", (1, 300, 4, 64, 1, 128, 64, False))]
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        tol = SSD_F32_TOL if dt == torch.float32 else None
        for label, (b, t, h, p, g, n, chunk, init) in cases:
            kw = _ssd_inputs(gen, b, t, h, p, g, n, dt, init)
            y, s = ss.ssd_scan_cuda(chunk=chunk, **kw)
            wy, ws = ss.ssd_scan_plain(chunk=chunk, **kw)
            errs[f"{name} {label}"] = max_err(y, wy, name, tol)
            errs[f"{name} {label} state"] = max_err(s, ws, "float32", SSD_F32_TOL)
            y2, s2 = ss.ssd_scan_cuda(chunk=chunk, **kw)
            check(torch.equal(y, y2) and torch.equal(s, s2),
                  f"ssd_scan: a repeat call differs ({name} {label})")
    torch.cuda.synchronize()
    for case, v in errs.items():
        print(f"[kernels] {'ssd_scan':23s} {case:32s} max|err| {v:.3e}", flush=True)
    b, t, h, p, g, n, chunk = SSM_WIDTH
    records = []
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        kw = _ssd_inputs(gen, b, t, h, p, g, n, dt, False)
        elt = torch.finfo(dt).bits // 8
        n_bytes, n_ops = ssd_work(b, t, h, p, g, n, chunk, False, elt=elt)
        plan = ss.launch_plan(b, t, h, p, g, n, chunk, dt)
        print(f"[kernels] ssd_scan {name} at the served width launches {list(plan)}",
              flush=True)
        records.append(dict(
            name="ssd_scan", route="cuda", dtype=name,
            source="src/repro_torch/kernels/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan.py:90",
            shape=f"x[{b},{t},{h},{p}] {name}, B/C[{b},{t},{g},{n}], chunk {chunk} (prefill)",
            max_abs_err=errs[f"{name} served prefill [1,256,24,64] N128"],
            call=lambda kw=kw: ss.ssd_scan_cuda(chunk=chunk, **kw),
            ms=cuda_ms(lambda kw=kw: ss.ssd_scan_cuda(chunk=chunk, **kw)),
            plain_ms=cuda_ms(lambda kw=kw: ss.ssd_scan_plain(chunk=chunk, **kw)),
            library=None,  # no single PyTorch call computes the SSD scan
            bytes=n_bytes, flops=n_ops, per_call=len(plan),
            **({"peak": F32_FLOPS_PER_S} if dt == torch.float32 else {}),
        ))
    return records


def _counters():
    """Every kernel launch counter's name (``kernels.counts``: a wrapper's
    ``LAUNCHES``, RMSNorm's also by prologue as ``rmsnorm/<prologue>``)."""
    from repro_torch.kernels import counts

    return list(counts.snapshot())


def _reset_counts():
    from repro_torch.kernels import counts

    counts.restore(dict.fromkeys(_counters(), 0))


def _read_counts():
    from repro_torch.kernels import counts

    return counts.snapshot()


def _none_per_layer(cfg) -> int:
    """RMSNorms without a prologue a layer of ``cfg``: 2 under qk-norm (q and k
    per head) and 2 in MLA (its q_down and kv latent norms), else 0."""
    return 2 if (cfg.qk_norm or cfg.mla is not None) else 0


def _attn_layers(cfg) -> int:
    """Attention layers of ``cfg``: a hybrid's by its pattern, else all."""
    if cfg.family == "hybrid":
        return sum(cfg.hybrid.block_kind(i) == "attention" for i in range(cfg.n_layers))
    return cfg.n_layers


def _want_counts(cfg, n_fwd: int, **kernels):
    """Every counter 0 but ``kernels`` and RMSNorm's over ``n_fwd``
    forwards of ``cfg``: 2 x n_layers + 1 launches a forward, the first
    layer's norm alone (none) and every residual add fused into the norm
    after it (add: 2 a layer in a dense, VLM, MoE or hybrid model, 1 in
    HSTU and Mamba-2, whose gate products take the other: mul and
    mul_silu); under
    qk-norm or MLA 2 x n_layers more (none: q and k per head, or MLA's q and
    latent norms)."""
    n_layers = cfg.n_layers
    want = dict.fromkeys(_counters(), 0)
    want.update(kernels)
    want["rmsnorm/none"] = n_fwd * (1 + _none_per_layer(cfg) * n_layers)
    if cfg.family in ("dense", "vlm", "moe", "mla_moe", "hybrid"):
        want["rmsnorm/add"] = 2 * n_layers * n_fwd
    else:
        want["rmsnorm/add"] = n_layers * n_fwd
        want[f"rmsnorm/{'mul' if cfg.family == 'hstu' else 'mul_silu'}"] = n_layers * n_fwd
    want["rmsnorm"] = sum(want[f"rmsnorm/{p}"] for p in RMSNORM_COUNTERS)
    return want


#: RMSNorm's counters by prologue and the split-row form's (``kernels.rmsnorm``)
RMSNORM_COUNTERS = ("none", "add", "mul", "mul_silu", "mul_silu_split")


def _split_gate_norms(want) -> None:
    """A TP rank's Mamba-2 counts: each gate norm is the split-row form's
    two launches (``ops.mul_silu_rmsnorm_split``) instead of one
    ``mul_silu`` launch."""
    n = want["rmsnorm/mul_silu"]
    want["rmsnorm/mul_silu"] = 0
    want["rmsnorm/mul_silu_split"] = 2 * n
    want["rmsnorm"] += n


def _encdec_served(cfg, prefills: int, steps: int):
    """Launches of ``prefills`` admissions and ``steps`` pool steps of an
    encoder-decoder served by the scheduler (``_encdec_counts``' prefill
    an admission and decode step a pool step)."""
    one, two = _encdec_counts(cfg, 1), _encdec_counts(cfg, 2)
    return {k: prefills * one[k] + steps * (two[k] - one[k]) for k in one}


def _trace(cfg, pad_to, temperature: float = 0.0, top_p: float = 1.0, n: int = N_REQUESTS,
           max_new: int = MAX_NEW):
    from repro_torch.launch import serve
    from repro_torch.training import data as data_mod

    return serve.poisson_trace(data_mod.PAPER_PROFILES["llama_humaneval"], n,
                               pad_to=pad_to, max_new_cap=max_new,
                               vocab_size=cfg.vocab_size, arrival_rate=0.0, seed=SEED,
                               temperature=temperature, top_p=top_p)


def serve_once(model, params, cfg, pad_to, *, policy, int8_mode, tag, temperature=0.0,
               top_p=1.0, speculative=False, reqs=None, mix=None, prepare=None,
               spec_exit=SPEC_EXIT, tp=None, **geometry):
    """One scheduler run of the trace, launch counters set to 0 just before
    it and read just after. Checks that every request got its max_new
    tokens, that every logits tensor the scheduler sampled from was finite
    (one device flag, read once per run: no per-step host sync is added),
    and that each kernel launched exactly its per-forward count: rmsnorm
    2 x n_layers + 1 (by prologue as ``_want_counts``); for a dense model
    flash attention per prefill layer and per mixed-step layer, decode
    attention per decode layer (the paged kernel on a paged pool) and the
    int8 kernel of ``int8_mode`` ("wo"/"dyn"/None) 7 x n_layers per
    forward; for an SSM the scan per prefill layer; for a hybrid flash and
    decode attention in its attention layers only; every other kernel 0.
    Every request samples at ``temperature`` / ``top_p``; ``speculative``
    makes each a ``SpeculativeProfile`` (exit layer ``spec_exit``,
    ``SPEC_DRAFT`` drafts), and a speculative step counts as a full forward
    (the verify: flash n_layers) plus ``SPEC_DRAFT`` draft forwards of
    ``spec_exit`` layers (decode attention and 2 add-norms a layer, one
    none-norm each and the layers' qk or MLA norms). Within ``plain_path``
    every count must stay 0. ``geometry`` (paged, block_size, num_blocks, chunked,
    prefill_budget, prefix_cache) goes to the scheduler; a paged run must
    end with no block owned and, without the prefix cache, every refcount
    0. ``reqs`` replaces the trace; ``mix`` cycles ``apply_profile_mix``'s
    kinds over it (beam groups of ``MIX_BEAMS``, speculative requests as
    above; a group's prefills and steps count as everyone's, and a beam may
    end early at its EOS); ``prepare`` edits the requests before the run
    (recording profiles). ``tp`` (a rank's ``TPContext``) serves as that
    rank of a tensor-parallel pool: the counts are the rank's own, which
    runs every layer at its heads. Prints the device memory the run
    allocated at its peak."""
    import torch

    from repro_torch.core import engine
    from repro_torch.launch import serve

    from repro_torch.core import profiles

    dev = torch.device("cuda")
    if reqs is None:
        reqs = _trace(cfg, pad_to, temperature, top_p)
    if speculative and mix is None:
        mix = "speculative"
    if mix is not None:
        serve.apply_profile_mix(reqs, mix, n_beams=MIX_BEAMS, exit_layer=spec_exit,
                                n_draft=SPEC_DRAFT)
        speculative = "speculative" in mix
    if prepare is not None:
        prepare(reqs)
    want_new = {r.rid: r.max_new for r in reqs}
    beams = {r.rid for r in reqs if isinstance(r.profile, profiles.BeamProfile)}
    n_req = len(reqs)
    finite = {"ok": torch.ones((), dtype=torch.bool, device=dev)}
    real = {name: getattr(engine, name)
            for name in ("prefill", "decode_step", "mixed_step", "verify_step")}

    def checked(fn):
        def step(*a, **kw):
            logits, cache = fn(*a, **kw)
            finite["ok"] &= torch.isfinite(logits).all()
            return logits, cache
        return step

    from repro_torch.core import router as router_mod

    scheds, real_sched = [], serve.Scheduler

    class Kept(real_sched):  # the run's schedulers (a router's replicas), for their pools
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            scheds.append(self)

    for name, fn in real.items():
        setattr(engine, name, checked(fn))
    serve.Scheduler = router_mod.Scheduler = Kept
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    try:
        _reset_counts()
        m, done = serve.run_scheduler(
            model, params, reqs, slots=SLOTS, pad_to=pad_to, max_new_cap=MAX_NEW,
            device=dev, policy=policy, return_requests=True, tp=tp, **geometry,
        )
        got_counts = _read_counts()
    finally:
        for name, fn in real.items():
            setattr(engine, name, fn)
        serve.Scheduler = router_mod.Scheduler = real_sched
    m["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    m["run_peak_bytes"] = m["max_memory_allocated"] - base_bytes
    check(bool(finite["ok"]), f"{tag}: non-finite logits during serving")
    check(len(done) == n_req, f"{tag}: {len(done)} of {n_req} done")
    for r in done:
        n_tok = len(r.tokens)
        check(n_tok == want_new[r.rid] or (r.rid in beams and 1 <= n_tok < want_new[r.rid]),
              f"{tag}: request {r.rid} got {n_tok} of {want_new[r.rid]} tokens")
    n_fwd = m["prefills"] + m["decode_steps"]  # decode steps count mixed and verify ones
    mixed = m.get("mixed_steps", 0)
    spec = m.get("spec_steps", 0)
    check(speculative or not spec, f"{tag}: speculative steps in a plain run")
    want_counts = _want_counts(cfg, n_fwd)
    drafts = SPEC_DRAFT * spec  # early-exit forwards of spec_exit layers
    want_counts["rmsnorm/none"] += (1 + _none_per_layer(cfg) * spec_exit) * drafts
    want_counts["rmsnorm/add"] += 2 * spec_exit * drafts
    want_counts["rmsnorm"] += (1 + (2 + _none_per_layer(cfg)) * spec_exit) * drafts
    if cfg.family == "ssm":  # the scan at every prefill; decode is plain torch
        want_counts["ssd_scan"] = cfg.n_layers * m["prefills"]
        if tp is not None and tp.size > 1:
            _split_gate_norms(want_counts)
    elif cfg.encdec is not None:
        want_counts = _encdec_served(cfg, m["prefills"], m["decode_steps"])
    else:
        n_attn = _attn_layers(cfg)
        want_counts["flash_attention"] = n_attn * (m["prefills"] + mixed + spec)
        decode = "paged_decode_attention" if geometry.get("paged") else "decode_attention"
        want_counts[decode] = (n_attn * (m["decode_steps"] - mixed - spec)
                               + spec_exit * drafts)
        if split_ring(cfg, pad_to + MAX_NEW + 1, tp):  # sp_decode: partial, then merge
            want_counts["decode_attention_partial"] = want_counts[
                "combine_partial_attention"] = want_counts.pop("decode_attention")
            want_counts["decode_attention"] = 0
        if int8_mode is not None:
            want_counts[f"int8_matmul_{'weight_only' if int8_mode == 'wo' else 'dynamic'}"] = (
                7 * cfg.n_layers * n_fwd)
    if PLAIN_PATH["on"]:  # nothing may reach a kernel
        want_counts = dict.fromkeys(_counters(), 0)
    check(got_counts == want_counts,
          f"{tag}: kernel launches {got_counts}, expected {want_counts}")
    if geometry.get("paged"):
        check(m["leaked_blocks"] == 0, f"{tag}: {m['leaked_blocks']} blocks still owned")
        for sched in scheds:  # the prefix cache's blocks keep its one reference
            pool = sched.pool
            check((pool._ref == pool._cached).all(),
                  f"{tag}: refcounts {pool._ref.nonzero()} left after the run")
    print(f"[{tag}] {m['n_requests']} requests | "
          f"{m['tokens_per_s']:.1f} tok/s | ttft p50 {m['ttft_p50_ms']:.2f} ms p99 "
          f"{m['ttft_p99_ms']:.2f} ms | tpot p50 {m['tpot_p50_ms']:.3f} ms | decode steps "
          f"{m['decode_steps']} | prefills {m['prefills']} | occupancy "
          f"{m['mean_slot_occupancy']:.3f} | wall {m['wall_s']:.2f} s | kv reserved "
          f"{m['kv_reserved_bytes']} B | max_memory_allocated {m['max_memory_allocated']} B "
          f"({m['run_peak_bytes']} B above the allocation before the run) | launches "
          f"{got_counts}", flush=True)
    return m, {r.rid: list(r.tokens) for r in done}, got_counts


def split_ring(cfg, max_len: int, tp) -> bool:
    """True when a hybrid TP rank's rings of ``min(max_len, window)`` rows
    split along them (``hybrid.init_cache``): decode then runs
    ``attention.sp_decode``."""
    if cfg.family != "hybrid" or tp is None or tp.size == 1:
        return False
    return min(max_len, cfg.hybrid.window) % tp.size == 0


def phase_serve(pad_to: int):
    """Full-width llama3.2-1b, bf16, 16 requests, continuous then fixed."""
    import torch

    from repro_torch.core.kv_cache import leaves
    from repro_torch.launch import serve

    dev = torch.device("cuda")
    cfg, model, params = serve.build_model(ARCH, smoke=False, seed=SEED, device=dev)
    check(cfg.dtype == "bfloat16" and cfg.d_model == 2048 and cfg.n_layers == 16,
          f"unexpected config {cfg}")
    t0 = time.perf_counter()
    serve.warmup(model, params, slots=SLOTS, pad_to=pad_to, max_new_cap=MAX_NEW,
                 device=dev)
    print(f"[serve] params {sum(p.numel() for p in leaves(params)) / 1e9:.3f}G "
          f"elements | pad_to {pad_to} | warm-up {time.perf_counter() - t0:.1f}s",
          flush=True)
    runs = {policy: serve_once(model, params, cfg, pad_to, policy=policy, int8_mode=None,
                               tag=f"serve/{policy}")
            for policy in ("continuous", "fixed")}
    check(runs["continuous"][1] == runs["fixed"][1],
          "continuous and fixed policies gave different tokens")
    return cfg, model, params, _trace(cfg, pad_to), runs


#: the paged phase's two arms: 48 blocks of 16 hold 752 tokens against the
#: ~8 x 20 blocks eight full slots want, so both arms preempt
PAGED_ARMS = {"paged": dict(paged=True, block_size=16, num_blocks=48),
              "chunked": dict(paged=True, block_size=16, num_blocks=48, chunked=True,
                              prefill_budget=64)}
#: a mixed step's lanes a slot: [slots, budget] tokens every mixed step
MIXED_LANES = PAGED_ARMS["chunked"]["prefill_budget"]
#: each slot's new tokens in the kernels phase's mixed step: prefilling slots
#: (a full and a partial chunk), decoding slots (1) and an idle one (0)
MIXED_T_NEW = [MIXED_LANES, 1, MIXED_LANES, 37, 0, 1, MIXED_LANES, 1]
#: arm -> (temperature, top_p, speculative, scheduler geometry); the paged arm
#: runs at phase 4b's chunked geometry, which preempts
SPEC_ARMS = {"plain t=0.8": (SPEC_TEMP, SPEC_TOP_P, False, {}),
             "spec greedy": (0.0, 1.0, True, {}),
             "spec t=0.8": (SPEC_TEMP, SPEC_TOP_P, True, {}),
             "spec t=0.8 paged": (SPEC_TEMP, SPEC_TOP_P, True, PAGED_ARMS["chunked"])}
#: the kernels phase's verify step: each slot's write position and window
#: width (full windows, a plain lane, a window cut by max_new, an idle slot;
#: the last slot's window ends at the contiguous cache's last row)
VERIFY_LENGTHS = [1, 44, 100, 200, 256, 300, 0, 316]
#: the mixed-classes arm: ``apply_profile_mix``'s kinds over the trace, beams
#: a beam request (a 2-beam group needs up to 42 of the chunked pool's 47
#: usable blocks at max_len 321, so groups preempt), its default guidance
MIX_KINDS, MIX_BEAMS, MIX_GUIDANCE = "greedy,beam,contrastive,speculative", 2, 2.0
#: the prefix-cache arm: ``shared_prefix_trace``'s system prompts and their
#: length (pad_to twice that, as the launcher sets it)
PFX_PREFIXES, PFX_LEN = 4, 64
VERIFY_T_NEW = [SPEC_DRAFT + 1] * 3 + [1, SPEC_DRAFT + 1, 3, 0, SPEC_DRAFT + 1]


def _deciding_gap(model, params, seq, rid, index, temperature, top_p):
    """(gap, bound) of the token after ``seq`` under the near-tie rule: a
    divergence passes only where the gap is below the bound. Greedy: the
    plain path's top-1/top-2 logit gap against the kernel and plain paths'
    max |dlogit| at that step; sampled: the top-two perturbed scores (the
    nucleus-filtered plain logits / T plus the Gumbel draw of request
    ``rid``'s token ``index``) against that max |dlogit| / T."""
    import torch

    from repro_torch.core import prng, sampling

    lp = _prefill_last(model, params, seq, "torch")
    d = float((_prefill_last(model, params, seq, "cuda") - lp).abs().max())
    if temperature <= 0:
        top2 = torch.topk(lp, 2).values
        return float(top2[0] - top2[1]), d
    key = sampling.slot_step_keys(prng.PRNGKey(0, device=lp.device), [rid], [index])[0]
    scores = sampling.nucleus(lp / temperature, top_p) + prng.gumbel(key, lp.shape)
    top2 = torch.topk(scores, 2).values
    return float(top2[0] - top2[1]), d / temperature


def same_tokens(model, params, cfg, pad_to, got, want, temperature, top_p, tag, what,
                reqs=None):
    """Each request's tokens in ``got`` against ``want`` (of the trace, or
    of ``reqs``): equal, or equal up to a first divergence at a near tie
    (``_deciding_gap``)."""
    same = 0
    reqs = _trace(cfg, pad_to) if reqs is None else reqs
    for r in reqs:
        g, w = got[r.rid], want[r.rid]
        first = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if first is None:
            check(len(g) == len(w), f"{tag} request {r.rid}: {len(g)} tokens vs {len(w)}")
            same += 1
            continue
        gap, lim = _deciding_gap(model, params, list(r.prompt) + w[:first], r.rid, first,
                                 temperature, top_p)
        print(f"[{tag}] request {r.rid}: token {first} differs from {what} (gap {gap:.4f}, "
              f"bound {lim:.4f})", flush=True)
        check(gap < lim, f"{tag} request {r.rid}: token {first} differs away from a near tie")
    print(f"[{tag}] {same} of {len(reqs)} requests give {what} exactly", flush=True)


def phase_paged(cfg, model, params, pad_to, served):
    """Phase 4b: the same 16 requests through the paged pool and through
    paged + chunked prefill. Each arm must preempt, give every request its
    tokens, leave no block owned, launch exactly its kernels (paged decode
    per plain step, flash per prefill and per mixed step, no contiguous
    decode), and match the contiguous arm's tokens up to a near tie. Then
    one mixed step and one paged decode step, profiled. Returns each arm's
    launch counts and tokens."""
    import torch

    from repro_torch.launch import serve

    dev = torch.device("cuda")
    out, tokens = {}, {}
    for arm, geometry in PAGED_ARMS.items():
        tag = f"paged/{arm}"
        serve.warmup(model, params, slots=SLOTS, pad_to=pad_to, max_new_cap=MAX_NEW,
                     device=dev, **geometry)
        m, toks, counts = serve_once(model, params, cfg, pad_to, policy="continuous",
                                     int8_mode=None, tag=tag, **geometry)
        check(m["n_preemptions"] >= 1, f"{tag}: the pool never preempted")
        print(f"[{tag}] preemptions {m['n_preemptions']} | block occupancy "
              f"{m['mean_block_occupancy']:.4f} | kv reserved {m['kv_reserved_bytes']} B, "
              f"peak used {m['kv_used_peak_bytes']} B ({m['peak_used_blocks']} of "
              f"{geometry['num_blocks'] - 1} blocks)"
              + (f" | mixed steps {m['mixed_steps']} of {m['decode_steps']}, chunks "
                 f"{m['prefill_chunks']} ({m['prefill_chunk_tokens']} tokens)"
                 if geometry.get("chunked") else ""), flush=True)
        same_tokens(model, params, cfg, pad_to, toks, served, 0.0, 1.0, tag,
                    "the contiguous arm's tokens")
        out[arm], tokens[arm] = counts, toks
    profile_paged_steps(cfg, model, params, pad_to)
    return out, tokens


def profile_paged_steps(cfg, model, params, pad_to, pairs: int = 3):
    """Mixed steps (8 slots, cursors pending) and then paged decode steps
    of a chunked scheduler, ``pairs`` of each kind run in turn unprofiled
    (wall time) and under torch.profiler (device time, device kernels, the
    step's own launches); medians and every reading printed, with the
    card's SM clock and power draw before and after."""
    import torch

    from repro_torch.core.scheduler import Scheduler

    dev = torch.device("cuda")
    sched = Scheduler(model, params, slots=SLOTS, pad_to=pad_to, max_new_cap=MAX_NEW,
                      device=dev, **PAGED_ARMS["chunked"])
    sched.submit(_trace(cfg, pad_to)[:SLOTS])
    sched._t0 = time.perf_counter()
    sched._admit(sched._now())
    print(f"[paged profile] clocks.sm, power.draw before: {gpu_clocks()}", flush=True)

    def run(kind, profiled):
        """Steps until one of ``kind`` ran; its wall ms, and under the
        profiler its device kernels and launches."""
        while True:
            check(sched.has_work, f"profile: the pool drained before a {kind} step")
            mixed = sched.n_mixed_steps
            _reset_counts()
            prof = (profiler(cpu=True) if profiled else None)
            if prof is not None:
                prof.__enter__()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sched.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            if prof is not None:
                prof.__exit__(None, None, None)
            ran = "mixed" if sched.n_mixed_steps > mixed else "decode"
            if ran == kind and not (kind == "decode" and sched.chunk_mgr.cursors):
                return wall, (device_kernels(prof) if profiled else None), _read_counts()

    n = cfg.n_layers
    for kind in ("mixed", "decode"):
        walls, busy, n_kern, attn = [], [], [], []
        for _ in range(pairs):
            walls.append(run(kind, False)[0])
            _, kern, launched = run(kind, True)
            want = {"flash_attention": n if kind == "mixed" else 0,
                    "paged_decode_attention": n if kind == "decode" else 0}
            got = {k: launched[k] for k in want}
            check(got == want, f"paged profile: {kind} step launches {got}, expected {want}")
            if kern:
                cats, by_name = device_split(kern)
                busy.append(sum(cats.values()) / 1e3)
                n_kern.append(len(kern))
                attn.append(sum(us for name, us in by_name.items() if "attention" in name) / 1e3)
        wall = statistics.median(walls)
        head = (f"[paged profile] {kind} step (B={SLOTS}, {len(sched.active)} decoding, "
                f"{len(sched.chunk_mgr)} prefilling after the last): wall {wall:.3f} ms "
                f"unprofiled (median of {[round(w, 3) for w in walls]})")
        if not busy:
            print(f"{head}; the profiler saw no device activity: device busy share not "
                  f"measured", flush=True)
            continue
        dev_ms = statistics.median(busy)
        print(f"{head} | device busy {dev_ms:.3f} ms = {dev_ms / wall:.1%} (median of "
              f"{[round(b, 3) for b in busy]}) | {statistics.median(n_kern):.0f} device kernels "
              f"per step ({n_kern}) | attention kernels {statistics.median(attn):.4f} ms",
              flush=True)
        print_split(f"paged profile {kind}", cats, by_name, 1, "step (the last)")
    print(f"[paged profile] clocks.sm, power.draw after: {gpu_clocks()}", flush=True)


def phase_speculative(cfg, model, params, pad_to, served):
    """Phase 4c: LayerSkip self-speculative serving and keyed sampling on
    the serve phase's weights and trace, four arms (``SPEC_ARMS``): every
    arm's launches exact (``serve_once``), the speculative arms' counters
    consistent, tokens against phase 4's greedy run and the plain sampled
    arm up to a near tie, at least one draft accepted; then one speculative
    step profiled. Returns each arm's launch counts and the plain sampled
    arm's tokens."""
    import torch

    from repro_torch.launch import serve

    dev = torch.device("cuda")
    runs = {}
    for arm, (temp, top_p, spec, geometry) in SPEC_ARMS.items():
        tag = f"spec/{arm}"
        serve.warmup(model, params, slots=SLOTS, pad_to=pad_to, max_new_cap=MAX_NEW,
                     device=dev, speculative=spec, exit_layer=SPEC_EXIT, n_draft=SPEC_DRAFT,
                     **geometry)
        m, toks, counts = serve_once(model, params, cfg, pad_to, policy="continuous",
                                     int8_mode=None, tag=tag, temperature=temp, top_p=top_p,
                                     speculative=spec, **geometry)
        line = (f"[{tag}] pool steps {m['decode_steps']} + {m['prefills']} prefills | "
                f"preemptions {m.get('n_preemptions', 0)}")
        if spec:
            check(m.get("spec_steps", 0) >= 1, f"{tag}: no speculative step ran")
            check(m["spec_committed"] == m["spec_accepted"] + m["spec_slot_steps"],
                  f"{tag}: committed {m['spec_committed']} != accepted {m['spec_accepted']} "
                  f"+ slot-steps {m['spec_slot_steps']}")
            hist = {int(k): v for k, v in m["spec_commit_hist"].items()}
            check(sum(hist.values()) == m["spec_slot_steps"]
                  and sum(k * v for k, v in hist.items()) == m["spec_committed"],
                  f"{tag}: the commit histogram {hist} does not sum")
            line += (f" | spec steps {m['spec_steps']} | slot-steps {m['spec_slot_steps']} | "
                     f"drafted {m['spec_drafted']} accepted {m['spec_accepted']} "
                     f"(acceptance {m['spec_acceptance']:.4f}) | tokens a slot-step "
                     f"{m['spec_tokens_per_step']:.4f} | commit hist {m['spec_commit_hist']}")
        if geometry.get("paged"):
            check(m["n_preemptions"] >= 1, f"{tag}: the pool never preempted")
        print(line, flush=True)
        runs[arm] = (m, toks, counts)
    check(sum(r[0].get("spec_accepted", 0) for r in runs.values()) >= 1,
          f"speculative: no draft accepted at exit layer {SPEC_EXIT}")
    same_tokens(model, params, cfg, pad_to, runs["spec greedy"][1], served, 0.0, 1.0,
                "spec/spec greedy", "phase 4's greedy tokens")
    for arm in ("spec t=0.8", "spec t=0.8 paged"):
        same_tokens(model, params, cfg, pad_to, runs[arm][1], runs["plain t=0.8"][1],
                    SPEC_TEMP, SPEC_TOP_P, f"spec/{arm}", "the plain sampled arm's tokens")
    profile_speculative_step(cfg, model, params, pad_to)
    return ({arm: counts for arm, (_, _, counts) in runs.items()},
            runs["plain t=0.8"][1])


def profile_speculative_step(cfg, model, params, pad_to, n: int = 3):
    """Speculative steps of a contiguous scheduler with 8 sampled
    speculative residents, ``n`` unprofiled (wall) and ``n`` under
    torch.profiler (device busy ms and device kernels a step), each step's
    launches checked; then the sampler's device kernels a call, by part:
    the per-lane keys, the Gumbel draw, the whole window sampler and the
    plain step's per-slot sampler."""
    import numpy as np
    import torch

    from repro_torch.core import prng, sampling
    from repro_torch.core.scheduler import Scheduler
    from repro_torch.launch import serve

    dev = torch.device("cuda")
    sched = Scheduler(model, params, slots=SLOTS, pad_to=pad_to, max_new_cap=MAX_NEW,
                      device=dev)
    reqs = _trace(cfg, pad_to, SPEC_TEMP, SPEC_TOP_P)[:SLOTS]
    serve.apply_profile_mix(reqs, "speculative", exit_layer=SPEC_EXIT, n_draft=SPEC_DRAFT)
    sched.submit(reqs)
    sched._t0 = time.perf_counter()
    sched._admit(sched._now())
    want = {"decode_attention": SPEC_EXIT * SPEC_DRAFT, "flash_attention": cfg.n_layers,
            "rmsnorm/none": SPEC_DRAFT + 1,
            "rmsnorm/add": 2 * SPEC_EXIT * SPEC_DRAFT + 2 * cfg.n_layers}

    def run(profiled):
        check(sched._spec_ready(), "speculative profile: the pool left speculative stepping")
        spec = sched.n_spec_steps
        _reset_counts()
        prof = (profiler(cpu=True) if profiled else None)
        if prof is not None:
            prof.__enter__()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if prof is not None:
            prof.__exit__(None, None, None)
        check(sched.n_spec_steps == spec + 1, "speculative profile: the step was no spec step")
        got = {k: _read_counts()[k] for k in want}
        check(got == want, f"speculative profile: step launches {got}, expected {want}")
        return wall, (device_kernels(prof) if profiled else None)

    walls, busy, n_kern = [], [], []
    for _ in range(n):
        walls.append(run(False)[0])
        kern = run(True)[1]
        if kern:
            cats, by_name = device_split(kern)
            busy.append(sum(cats.values()) / 1e3)
            n_kern.append(len(kern))
    wall = statistics.median(walls)
    head = (f"[spec profile] speculative step (B={SLOTS}, exit layer {SPEC_EXIT}, "
            f"{SPEC_DRAFT} drafts, t={SPEC_TEMP}): wall {wall:.3f} ms unprofiled (median of "
            f"{[round(w, 3) for w in walls]}) | launches a step {want}")
    if not busy:
        print(f"{head}; the profiler saw no device activity: device busy share not measured",
              flush=True)
    else:
        dev_ms = statistics.median(busy)
        print(f"{head} | device busy {dev_ms:.3f} ms = {dev_ms / wall:.1%} (median of "
              f"{[round(b, 3) for b in busy]}) | {statistics.median(n_kern):.0f} device "
              f"kernels a step ({n_kern})", flush=True)
        print_split("spec profile", cats, by_name, 1, "step (the last)")

    # the sampler alone, at the step's shapes: device kernels and ms a call
    v = cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(5)
    logits = torch.randn((SLOTS, SPEC_DRAFT + 1, v), generator=gen, device=dev)
    window = torch.zeros((SLOTS, SPEC_DRAFT + 1), dtype=torch.int32, device=dev)
    steps = sched._ngen[:, None] + np.arange(SPEC_DRAFT + 1)[None]
    keys = torch.from_numpy(sampling.window_step_keys(sched.base_key, sched._rid, steps,
                                                      sched._stream)).to(dev)
    parts = {
        "window keys (folded on the host)":
            lambda: sampling.window_step_keys(sched.base_key, sched._rid, steps, sched._stream),
        "gumbel draw [8,5,V]": lambda: prng.gumbel(keys, (v,)),
        "window sampler (keys to tokens on the host)":
            lambda: sched._staging.wait(sched._sample_window(logits, window)),
        "slot sampler (plain step, keys to tokens on the host)":
            lambda: sched._staging.wait(sched._sample(logits[:, 0])),
    }
    for label, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        with profiler() as prof:
            fn()
            torch.cuda.synchronize()
        kern = device_kernels(prof)
        ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / 5
        print(f"[spec profile] sampler part {label}: {len(kern)} device kernels, device "
              f"{ms:.4f} ms, wall {host:.3f} ms a call", flush=True)


def phase_mixed(cfg, model, params, pad_to, served):
    """Phase 4d: the trace under ``apply_profile_mix(MIX_KINDS)`` through
    phase 4b's chunked pool: greedy, 2-beam, contrastive and speculative
    requests side by side. Exact launches (``serve_once``), preemptions, no
    row gather, table permutations and copy-on-write copies, no block or
    refcount left; every request against its batch engine (greedy and
    speculative: phase 4's tokens; beam: a recording ``run_profile``;
    contrastive: ``generate_contrastive``) under the near-tie rules; the
    per-class latency rows; ``kv_cache.copy_block``'s time a copy beside
    its bound. Returns the launch counts."""
    import numpy as np
    import torch

    from repro_torch.core import engine, kv_cache, profiles
    from repro_torch.core.kv_cache import leaves
    from repro_torch.core.slot_pool import BlockPool
    from repro_torch.launch import serve

    dev = torch.device("cuda")
    geometry = PAGED_ARMS["chunked"]
    tag = "mixed"
    serve.warmup(model, params, slots=SLOTS, pad_to=pad_to, max_new_cap=MAX_NEW, device=dev,
                 profile_mix=True, n_beams=MIX_BEAMS, speculative=True, exit_layer=SPEC_EXIT,
                 n_draft=SPEC_DRAFT, **geometry)
    kept = []

    def record(reqs):
        for r in reqs:
            if isinstance(r.profile, profiles.BeamProfile):
                r.profile = recording_beam(r.profile.n_beams, r.profile.eos_id)
        kept.extend(reqs)

    m, toks, counts = serve_once(model, params, cfg, pad_to, policy="continuous",
                                 int8_mode=None, tag=tag, mix=MIX_KINDS, prepare=record,
                                 **geometry)
    check(m["group_admissions"] >= 8 and m["cache_reorders"] == 0
          and m["block_permutes"] >= 1 and m["cow_copies"] >= 1 and m["n_preemptions"] >= 1,
          f"{tag}: groups {m['group_admissions']}, row gathers {m['cache_reorders']}, table "
          f"permutations {m['block_permutes']}, copy-on-write {m['cow_copies']}, preemptions "
          f"{m['n_preemptions']}")
    print(f"[{tag}] groups {m['group_admissions']} | preemptions {m['n_preemptions']} | "
          f"table permutations {m['block_permutes']} | copy-on-write copies "
          f"{m['cow_copies']} | row gathers {m['cache_reorders']} | pool steps "
          f"{m['decode_steps']} ({m['mixed_steps']} mixed, {m.get('spec_steps', 0)} "
          f"speculative) | prefills {m['prefills']} | chunks {m['prefill_chunks']}", flush=True)
    for cls, row in m["per_class"].items():
        print(f"[{tag}]   class {cls}: {row['n_requests']} requests | ttft p50 "
              f"{row['ttft_p50_ms']:.2f} ms p99 {row['ttft_p99_ms']:.2f} ms | tpot p50 "
              f"{row['tpot_p50_ms']:.3f} ms p99 {row['tpot_p99_ms']:.3f} ms", flush=True)
    plain = [r for r in kept if serve.request_class(r) in ("greedy", "speculative")]
    same_tokens(model, params, cfg, pad_to, toks, served, 0.0, 1.0, tag,
                "phase 4's greedy tokens", reqs=plain)
    for r in kept:
        prompt = torch.tensor(np.asarray(r.prompt, np.int32)[None], device=dev)
        if isinstance(r.profile, profiles.BeamProfile):
            rec = recording_beam(r.profile.n_beams, r.profile.eos_id)
            want = engine.run_profile(model, params, rec, prompt, max_new_tokens=r.max_new)
            if beam_agreement(r.profile.log, rec.log, 0, r.profile.n_beams,
                              f"{tag} beam {r.rid}") is None:
                check(toks[r.rid] == want["tokens"][0, :len(toks[r.rid])].tolist(),
                      f"{tag} beam {r.rid}: no step differs but the tokens do")
                print(f"[{tag}] beam {r.rid}: the batch run's beams at every step", flush=True)
        elif isinstance(r.profile, profiles.ContrastiveProfile):
            want = engine.generate_contrastive(model, params, prompt, uncond_token=0,
                                               n_image_tokens=r.max_new, guidance=MIX_GUIDANCE)
            greedy_parity(model, params, r.prompt.tolist(), toks[r.rid],
                          want["tokens"][0].tolist(), f"{tag} contrastive {r.rid}",
                          mix=(MIX_GUIDANCE, 0, 0), what="the batch run's")

    # one copy-on-write copy: every layer's K and V block, in place
    bs = geometry["block_size"]
    pool = BlockPool(model, SLOTS, pad_to + MAX_NEW + 1, dev, block_size=bs,
                     num_blocks=geometry["num_blocks"])
    n_bytes = 2 * sum(x[0].numel() * x.element_size() for x in leaves(pool.cache["layers"]))
    ms = cuda_ms(lambda: kv_cache.copy_block(pool.cache["layers"], 1, 2))
    print(f"[{tag}] copy_block: {ms:.4f} ms a copy-on-write ({2 * cfg.n_layers} block copies, "
          f"{n_bytes} B read and written) | bound {n_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms "
          f"(bytes)", flush=True)
    del pool
    return counts


def phase_prefix(cfg, model, params):
    """Phase 4e: ``shared_prefix_trace`` (16 requests, PFX_PREFIXES system
    prompts of PFX_LEN tokens) through phase 4b's chunked pool without and
    with the prefix cache, at t = 0 and at t = 0.8: exact launches, no block
    owned at the end, the same reserved KV bytes in both arms, at least one
    hit, warm tokens against cold ones under the near-tie rule; hit rate,
    tokens skipped and TTFT printed."""
    import torch

    from repro_torch.launch import serve

    dev = torch.device("cuda")
    pad = 2 * PFX_LEN
    geometry = PAGED_ARMS["chunked"]
    serve.warmup(model, params, slots=SLOTS, pad_to=pad, max_new_cap=MAX_NEW, device=dev,
                 prefix_cache=True, **geometry)
    for temp, top_p in ((0.0, 1.0), (SPEC_TEMP, SPEC_TOP_P)):
        def trace():
            return serve.shared_prefix_trace(
                N_REQUESTS, n_prefixes=PFX_PREFIXES, prefix_len=PFX_LEN, pad_to=pad,
                max_new_cap=MAX_NEW, vocab_size=cfg.vocab_size, arrival_rate=0.0, seed=SEED,
                temperature=temp, top_p=top_p)

        arms = {}
        for cache in (False, True):
            tag = f"prefix/{'warm' if cache else 'cold'} t={temp}"
            arms[cache] = serve_once(model, params, cfg, pad, policy="continuous",
                                     int8_mode=None, tag=tag, reqs=trace(),
                                     prefix_cache=cache, **geometry)
        (cold, cold_toks, _), (warm, warm_toks, _) = arms[False], arms[True]
        tag = f"prefix t={temp}"
        check(warm["kv_reserved_bytes"] == cold["kv_reserved_bytes"] and warm["prefix_hits"] >= 1,
              f"{tag}: reserved {warm['kv_reserved_bytes']} vs {cold['kv_reserved_bytes']} B, "
              f"{warm['prefix_hits']} hits")
        print(f"[{tag}] hits {warm['prefix_hits']} of {warm['prefix_lookups']} (rate "
              f"{warm['prefix_hit_rate']:.4f}) | prompt tokens skipped "
              f"{warm['prefill_tokens_skipped']} | reclaimed {warm['prefix_blocks_reclaimed']} | "
              f"cached blocks a step {warm['mean_cached_blocks']:.2f} | chunk tokens "
              f"{warm['prefill_chunk_tokens']} vs {cold['prefill_chunk_tokens']} cold | ttft p50 "
              f"{warm['ttft_p50_ms']:.2f} vs {cold['ttft_p50_ms']:.2f} ms cold | tok/s "
              f"{warm['tokens_per_s']:.1f} vs {cold['tokens_per_s']:.1f} | preemptions "
              f"{warm['n_preemptions']} vs {cold['n_preemptions']}", flush=True)
        same_tokens(model, params, cfg, pad, warm_toks, cold_toks, temp, top_p, tag,
                    "the cold arm's tokens", reqs=trace())


#: the router phase's arms: replicas, temperature, top-p, each replica's
#: geometry and the single-pool run its tokens must equal ("exact") or match
#: up to a near tie ("near tie"): phase 4's greedy tokens, phase 4c's plain
#: sampled arm's, phase 4b's paged arm's
ROUTER_ARMS = {"x2": (2, 0.0, 1.0, {}, "serve", "exact"),
               "x2 t=0.8": (2, SPEC_TEMP, SPEC_TOP_P, {}, "sampled", "exact"),
               "x2 paged": (2, 0.0, 1.0, PAGED_ARMS["paged"], "paged", "exact"),
               "x3": (3, 0.0, 1.0, {}, "serve", "exact"),
               "x2 chunked": (2, 0.0, 1.0, PAGED_ARMS["chunked"], "serve", "near tie")}
#: the reference's starvation trace: one slot, a priority-0 request at t = 0
#: beside 10 priority-2 ones 2 ms apart, aged every 2 ms
STARVE_STREAM, STARVE_GAP, STARVE_PAD, STARVE_NEW = 10, 0.002, 8, 4


def phase_router(cfg, model, params, pad_to, single):
    """Phase 4f: the trace through ``ReplicaRouter`` fleets on the one card
    (``ROUTER_ARMS``), each replica 8 slots of the serve phase's geometry:
    exact launches against the fleet's summed steps and prefills
    (``serve_once``), every request its single-pool tokens (``single``: arm
    name -> tokens) by the arm's rule; wall, tok/s, the emulated
    one-card-a-replica rate over ``busy_max_s``, spills, requeues and each
    replica's line printed. Then the two-phase step's contract
    (``sync_contract``), the host time of two replicas' ``step_begin``
    against one replica's ``step()`` (``begin_host_ms``), and the starvation
    trace with and without aging (``starvation``). Returns, for the tp fleet
    arm, each FLEET_ARMS router arm's tokens, host counters (``fleet_host``)
    and KV bytes, by the fleet's arm name."""
    fleet = {}
    for arm, (n, temp, top_p, geometry, want, rule) in ROUTER_ARMS.items():
        tag = f"router/{arm}"
        with kept_routers() as routers:
            m, toks, _ = serve_once(model, params, cfg, pad_to, policy="continuous",
                                    int8_mode=None, tag=tag, temperature=temp, top_p=top_p,
                                    replicas=n, **geometry)
        for fleet_arm, router_arm in FLEET_ARMS.items():
            if router_arm == arm:
                fleet[fleet_arm] = dict(tokens=toks, host=fleet_host(routers[-1]),
                                        kv_reserved_bytes=m["kv_reserved_bytes"])
        check(m["replicas"] == n and len(m["per_replica"]) == n, f"{tag}: not {n} replicas")
        check(m["requeues"] == m.get("n_preemptions", 0),
              f"{tag}: {m['requeues']} requeues for {m.get('n_preemptions', 0)} preemptions")
        print(f"[{tag}] wall {m['wall_s']:.3f} s | {m['tokens_per_s']:.1f} tok/s | aggregate "
              f"{m['aggregate_tokens_per_s']:.1f} tok/s over busy max {m['busy_max_s']:.3f} s "
              f"(a card a replica, emulated) | steps {m['decode_steps']} (max {m['steps_max']}) "
              f"| prefills {m['prefills']} | spills {m['spills']} | requeues {m['requeues']} | "
              f"preemptions {m.get('n_preemptions', 0)}", flush=True)
        for e in m["per_replica"]:
            print(f"[{tag}]   replica {e['replica']} ({e['device']}): {e['n_requests']} requests "
                  f"| steps {e['decode_steps']} | prefills {e['prefills']} | preemptions "
                  f"{e['preemptions']} | busy {e['busy_s']:.3f} s | occupancy "
                  f"{e['mean_slot_occupancy']:.3f} | ttft p50 {e['ttft_p50_ms']:.2f} ms | tpot "
                  f"p50 {e['tpot_p50_ms']:.3f} ms", flush=True)
        if rule == "exact":
            same = sum(toks[rid] == single[want][rid] for rid in single[want])
            print(f"[{tag}] {same} of {len(single[want])} requests give the single pool's "
                  f"tokens exactly ({want})", flush=True)
            check(same == len(single[want]), f"{tag}: tokens differ from the single pool's")
        else:
            same_tokens(model, params, cfg, pad_to, toks, single[want], temp, top_p, tag,
                        "phase 4's single-pool tokens")
    sync_contract(cfg, model, params, pad_to)
    begin_host_ms(cfg, model, params, pad_to)
    starvation(cfg, model, params)
    return fleet


def sync_contract(cfg, model, params, pad_to):
    """Every ``step_begin`` of four trace requests (two at t = 0.8) served
    on the chunked pool (mixed, then paged decode steps) and on the
    contiguous one runs under ``set_sync_debug_mode("error")``: no
    device-to-host sync, no blocking host-to-device copy. Admissions run
    outside the mode."""
    import torch

    from repro_torch.core.scheduler import Scheduler

    dev = torch.device("cuda")
    for arm, geometry in (("chunked", PAGED_ARMS["chunked"]), ("contiguous", {})):
        reqs = _trace(cfg, pad_to)[:4]
        for r in reqs[::2]:
            r.temperature, r.top_p = SPEC_TEMP, SPEC_TOP_P
        sched = Scheduler(model, params, slots=SLOTS, pad_to=pad_to, max_new_cap=MAX_NEW,
                          device=dev, **geometry)
        sched.submit(reqs)
        kinds = {}
        with torch.inference_mode():
            while sched.waiting or sched.has_work:
                sched._admit(sched._now())
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    pending = sched.step_begin()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                kinds[pending[0]] = kinds.get(pending[0], 0) + 1
                sched.step_finish(pending)
        want = {"decode", "mixed"} if geometry.get("chunked") else {"decode"}
        check(set(kinds) == want and len(sched.finished) == 4,
              f"[router/sync {arm}] step kinds {kinds}, {len(sched.finished)} of 4 done")
        pinned = all(b.is_pinned() for b in sched._staging._bufs.values())
        check(pinned, f"[router/sync {arm}] a staging buffer is not pinned")
        print(f"[router/sync {arm}] {sum(kinds.values())} step_begin calls under "
              f"set_sync_debug_mode('error'), none synchronized: {kinds} | staging buffers "
              f"pinned: {sorted(sched._staging._bufs)}", flush=True)


def begin_host_ms(cfg, model, params, pad_to, rounds: int = 8):
    """Host time of two replicas' ``step_begin`` calls back to back (both
    full, 8 decoding slots each) against the wall of one replica's
    ``step()`` ending in a synchronize: the share of a round the second
    replica's launches can hide behind the first's kernels. Medians over
    ``rounds``."""
    import torch

    from repro_torch.core.router import ReplicaRouter

    dev = torch.device("cuda")
    fleet = ReplicaRouter(model, params, replicas=2, slots=SLOTS, pad_to=pad_to,
                          max_new_cap=MAX_NEW, devices=[dev, dev])
    reqs = _trace(cfg, pad_to)
    for r in reqs:
        r.max_new = MAX_NEW
    begins, finishes, steps = [], [], []
    with torch.inference_mode():
        fleet.submit(reqs)
        fleet._place(fleet._now())
        check(all(s.pool.n_free == 0 for s in fleet.replicas), "[router/host] fleet not full")
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pend = [(s, s.step_begin()) for s in fleet.replicas]
            t1 = time.perf_counter()
            for s, p in pend:
                s.step_finish(p)
            t2 = time.perf_counter()
            begins.append((t1 - t0) * 1e3)
            finishes.append((t2 - t1) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fleet.replicas[0].step()
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
    b, f, w = (statistics.median(x) for x in (begins, finishes, steps))
    print(f"[router/host] two replicas' step_begin {b:.3f} ms host (then both finishes "
          f"{f:.3f} ms) against one replica's step() {w:.3f} ms wall; medians of {rounds}",
          flush=True)


def starvation(cfg, model, params):
    """The reference's starvation trace on the card (one slot, pad 8, 4
    tokens a request; the wall clock): without aging the priority-0
    request finishes last; aged every 2 ms, at position 4 or earlier."""
    import numpy as np
    import torch

    from repro_torch.core.scheduler import Scheduler, ServeRequest

    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=4) for _ in range(STARVE_STREAM + 1)]
    orders = {}
    for boost in (None, STARVE_GAP):
        sched = Scheduler(model, params, slots=1, pad_to=STARVE_PAD, max_new_cap=STARVE_NEW,
                          device=torch.device("cuda"), priority_boost_after=boost)
        reqs = [ServeRequest(rid=i, prompt=p, max_new=STARVE_NEW, priority=0 if i == 0 else 2,
                             t_arrival=0.0 if i == 0 else STARVE_GAP * (i - 1))
                for i, p in enumerate(prompts)]
        orders[boost] = ([r.rid for r in sched.run(reqs)], sched.n_priority_boosts)
    (plain, _), (aged, boosts) = orders[None], orders[STARVE_GAP]
    print(f"[router/aging] finish order without aging {plain}, aged every "
          f"{STARVE_GAP * 1e3:.0f} ms {aged} ({boosts} boosts)", flush=True)
    check(plain[-1] == 0, "[router/aging] the priority-0 request did not starve without aging")
    check(aged.index(0) <= 4 and boosts > 0, "[router/aging] aging did not break the starvation")


def gpu_clocks() -> str:
    """The card's SM clock and power draw now, for the record."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except OSError as e:
        return f"not read ({e})"
    return out.stdout.strip() if out.returncode == 0 else "not read"


def _prefill_last(model, params, seq, impl):
    """Last-position logits of one token sequence, through ``impl``."""
    import torch

    from repro_torch.core import engine

    dev = torch.device("cuda")
    toks = torch.tensor([list(seq)], dtype=torch.int32, device=dev)
    ln = torch.tensor([len(seq)], dtype=torch.int32, device=dev)
    logits, _ = engine.prefill(model, params, toks, ln, len(seq) + 1, impl=impl)
    return logits[0]


def phase_parity(model, params, pad_to, reqs, served, tag="parity"):
    """Prefill logits through the kernels vs through the plain versions, and
    the first served tokens vs greedy generation on the plain path. A
    token may differ only at a near tie: where the plain path's top-1/top-2
    gap is below the two paths' max |logit difference| at that step."""
    import numpy as np
    import torch

    from repro_torch.core import engine

    dev = torch.device("cuda")
    n_tok = 16
    for r in reqs:
        lc = _prefill_last(model, params, r.prompt, "cuda")
        lp = _prefill_last(model, params, r.prompt, "torch")
        check(bool(torch.isfinite(lc).all()), "non-finite kernel-path logits")
        delta = float((lc - lp).abs().max())
        span = float(lp.max() - lp.min())
        top2 = torch.topk(lp, 2).values
        gap = float(top2[0] - top2[1])
        same = int(lc.argmax()) == int(lp.argmax())
        print(f"[{tag}] request {r.rid}: prefill max|dlogit| {delta:.4f} = "
              f"{delta / span:.2e} of the logit range {span:.1f} | top1-top2 gap "
              f"{gap:.4f} | greedy token {'agrees' if same else 'differs'}", flush=True)
        check(same or gap < delta,
              f"{tag} request {r.rid}: greedy first token differs with gap {gap} >= {delta}")

        buf = np.zeros((1, pad_to), np.int32)
        buf[0, : len(r.prompt)] = r.prompt
        plain = engine.generate(
            model, params, torch.from_numpy(buf).to(dev),
            prompt_lengths=torch.tensor([len(r.prompt)], dtype=torch.int32, device=dev),
            max_new_tokens=n_tok, impl="torch",
        )["tokens"][0].tolist()
        got = served[r.rid][:n_tok]
        first = next((i for i, (a, b) in enumerate(zip(got, plain)) if a != b), None)
        if first is None:
            print(f"[{tag}] request {r.rid}: first {n_tok} served tokens equal the "
                  f"plain path's", flush=True)
            continue
        seq = list(r.prompt) + plain[:first]
        lp = _prefill_last(model, params, seq, "torch")
        d = float((_prefill_last(model, params, seq, "cuda") - lp).abs().max())
        top2 = torch.topk(lp, 2).values
        g = float(top2[0] - top2[1])
        print(f"[{tag}] request {r.rid}: served token {first} differs from the plain "
              f"path (gap {g:.4f}, max|dlogit| {d:.4f})", flush=True)
        check(g < d, f"{tag} request {r.rid}: token {first} differs away from a near tie")


PORTED_KERNEL_NAMES = ("rmsnorm_warp_kernel", "rmsnorm_block_kernel", "flash_attention_kernel",
                       "flash_attention_mma_kernel", "decode_attention_kernel",
                       "decode_attention_paged_kernel", "decode_attention_combine_kernel",
                       "int8_gemm_kernel", "int8_mma_kernel", "int8_wo_mma_kernel",
                       "int8_splitk_reduce", "hstu_attention_kernel", "hstu_attention_mma_kernel",
                       "ssd_scan_kernel", "ssd_chunk_state_kernel", "ssd_state_passing_kernel",
                       "ssd_chunk_scan_kernel", "flash_latent_kernel", "decode_latent_kernel")
#: the int8 GEMM kernels proper (their split-K sums excluded)
INT8_GEMM_NAMES = ("int8_gemm_kernel", "int8_mma_kernel", "int8_wo_mma_kernel")
#: device kernels of one prefill and of one decode step, by profile tag, and
#: of one HSTU forward, with every residual add and gate product a launch of
#: its own (the unfused layer loops; NVIDIA H100 80GB HBM3, 700 W)
UNFUSED_KERNELS = {"profile": (942, 1024), "quant/wo profile": (1021, 1120),
                   "quant/dyn profile": (2141, 2240), "ssm profile": (754, 925)}
UNFUSED_HSTU_KERNELS = 189


def fused_per_forward(cfg) -> int:
    """Elementwise launches a forward that the fused RMSNorms take over:
    every residual add (2 a layer in a dense model, 1 in HSTU and Mamba-2),
    HSTU's gate product, and Mamba-2's silu and gate product."""
    return cfg.n_layers * {"dense": 2, "hstu": 2, "ssm": 3}[cfg.family]


def kernels_beside_unfused(tag: str, unit: str, n: float, fused: int) -> str:
    """``n`` device kernels a prefill or step beside the unfused loops'
    count less the fused launches."""
    if tag not in UNFUSED_KERNELS:
        return ""
    old = UNFUSED_KERNELS[tag][unit == "step"]
    return (f" (unfused: {old}; less the {fused} fused launches: {old - fused}; change "
            f"{n - old:+.0f})")


def phase_profile(model, params, pad_to, reqs, tag="profile", fused=0):
    """Where the time of one served decode step goes: torch.profiler over
    a few pool-wide decode steps with every slot live, each ending in the
    scheduler's greedy argmax and host copy."""
    import torch

    from repro_torch.core import engine, sampling
    from repro_torch.core.slot_pool import SlotPool

    dev = torch.device("cuda")
    pool = SlotPool(model, SLOTS, pad_to + MAX_NEW + 1, dev)
    first = []
    for slot, r in enumerate(reqs[:SLOTS]):
        toks = torch.zeros((1, pad_to), dtype=torch.int32, device=dev)
        toks[0, : len(r.prompt)] = torch.as_tensor(r.prompt, dtype=torch.int32)
        logits, row = engine.prefill(model, params, toks,
                                     torch.tensor([len(r.prompt)], dtype=torch.int32,
                                                  device=dev), pool.max_len)
        pool.assign(slot, row)
        first.append(int(sampling.greedy(logits)[0]))
    token = torch.tensor(first, dtype=torch.int32, device=dev)
    # one more prefill of the first request, profiled: where a prefill's time goes
    r = reqs[0]
    toks = torch.zeros((1, pad_to), dtype=torch.int32, device=dev)
    toks[0, : len(r.prompt)] = torch.as_tensor(r.prompt, dtype=torch.int32)
    plen = torch.tensor([len(r.prompt)], dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    with profiler() as pprof:
        engine.prefill(model, params, toks, plen, pool.max_len)
        torch.cuda.synchronize()
    pk = device_kernels(pprof)
    if pk:
        pcats, pnames = device_split(pk)
        print(f"[{tag}] one prefill (T={pad_to}): device {sum(pcats.values()) / 1e3:.3f} ms in "
              f"{len(pk)} device kernels{kernels_beside_unfused(tag, 'prefill', len(pk), fused)}",
              flush=True)
        print_split(f"{tag} prefill", pcats, pnames, 1, "prefill")

    def step():
        nonlocal token
        logits, pool.cache = engine.decode_step(model, params, pool.cache, token)
        host = sampling.greedy(logits).cpu()  # the step's one host sync
        token = host.to(dev)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    n_steps = 5
    with profiler(cpu=True) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    kern = device_kernels(prof)
    if not kern:
        print(f"[{tag}] decode step {bare_ms:.3f} ms wall; the profiler saw no device "
              f"activity: device busy share not measured", flush=True)
        return
    cats, by_name = device_split(kern)
    busy_ms = sum(cats.values()) / n_steps / 1e3
    int8_all = sum(us for name, us in by_name.items() if "int8_" in name) / n_steps / 1e3
    int8_gemm = sum(us for name, us in by_name.items()
                    if any(k in name for k in INT8_GEMM_NAMES)) / n_steps / 1e3
    attn = sum(us for name, us in by_name.items() if "decode_attention" in name) / n_steps / 1e3
    print(f"[{tag}] decode attention device time per decode step: {attn:.4f} ms (kernel and "
          f"split combine)", flush=True)
    norm = sum(us for name, us in by_name.items() if "rmsnorm_" in name) / n_steps / 1e3
    print(f"[{tag}] rmsnorm device time per decode step: {norm:.4f} ms", flush=True)
    if int8_all:
        print(f"[{tag}] int8 GEMM device time per decode step: {int8_gemm:.4f} ms, "
              f"{int8_all:.4f} ms with the split-K sums", flush=True)
    print(f"[{tag}] decode step (B={SLOTS}): wall {bare_ms:.3f} ms unprofiled, "
          f"{wall_ms:.3f} ms profiled | device busy {busy_ms:.3f} ms = "
          f"{busy_ms / bare_ms:.1%} of the unprofiled step ({busy_ms / wall_ms:.1%} of "
          f"the profiled one) | {len(kern) / n_steps:.0f} device kernels per step"
          f"{kernels_beside_unfused(tag, 'step', len(kern) / n_steps, fused)}", flush=True)
    print_split(tag, cats, by_name, n_steps, "step")


def device_split(kern):
    """Device microseconds of profiler kernel events by kind (ported
    kernels, cuBLAS matmuls, other torch ops) and by kernel name."""
    cats = {"ported kernels": 0.0, "matmuls (cuBLAS)": 0.0, "other torch ops": 0.0}
    by_name = {}
    for e in kern:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        low = e.name.lower()
        if any(k in e.name for k in PORTED_KERNEL_NAMES):
            cats["ported kernels"] += us
        elif any(k in low for k in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
            cats["matmuls (cuBLAS)"] += us
        else:
            cats["other torch ops"] += us
    return cats, by_name


def check_kernel_names(kern, want, tag, again=None):
    """Device kernels of a profiler run whose name holds each key of
    ``want`` (no kernel name holds another's); raises unless every count
    equals its value. A profile short of some wanted kernel with none in
    excess, where the launch counters already matched, lost events (the
    profiler drops one now and then): it is recorded
    (``note_short_session``) and ``again`` profiled once more, which must
    hold every count."""
    import torch

    got = {k: sum(1 for e in kern if k in e.name) for k in want}
    if got != want and again is not None and all(got[k] <= want[k] for k in want):
        print(f"[{tag}] profiled kernels {got}, expected {want}: the profile lost events; "
              f"profiling again", flush=True)
        with profiler() as prof:
            again()
            torch.cuda.synchronize()
        short, kern = kern, device_kernels(prof)
        got = {k: sum(1 for e in kern if k in e.name) for k in want}
        if got != want:
            from collections import Counter

            free, total = torch.cuda.mem_get_info()
            print(f"[{tag}] the two short sessions' device kernels by name: "
                  f"{dict(Counter(e.name[:50] for e in short))} / "
                  f"{dict(Counter(e.name[:50] for e in kern))}; first kernels "
                  f"{[e.name[:40] for e in sorted(kern, key=lambda e: e.time_range.start)[:12]]}"
                  f"; device memory free {free} of {total} B", flush=True)
        check(got == want, f"{tag}: two profiles in a row gave {got}, expected {want} "
                           f"({len(short)} and {len(kern)} device kernels in all)")
        note_short_session(tag, short, kern, len(kern))
    check(got == want, f"{tag}: profiled kernels {got}, expected {want}")
    print(f"[{tag}] profiled kernels {got}", flush=True)


def print_split(tag, cats, by_name, n, unit):
    total = max(sum(cats.values()), 1e-9)
    for c, us in cats.items():
        print(f"[{tag}]   {c:18s} {us / n / 1e3:.4f} ms/{unit} ({us / total:.1%} of device "
              f"time)", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag}]   top: {us / n / 1e3:.4f} ms/{unit}  {name[:110]}", flush=True)


def phase_quant(cfg, model, params, pad_to, reqs):
    """AutoQuant the bf16 params for decode (tokens_per_step = slots) and
    for prefill (tokens_per_step = pad_to); serve, check and profile each
    arm. Returns {mode: launch counts of its served run}."""
    import torch

    from repro_torch.core import quantization as Q
    from repro_torch.core.kv_cache import leaves
    from repro_torch.launch import serve

    dev = torch.device("cuda")
    n_lin = 7 * cfg.n_layers
    bf16_bytes = sum(t.numel() * t.element_size() for t in leaves(params["layers"])
                     if t.ndim == 2)
    full = [_prefill_last(model, params, r.prompt, "cuda") for r in reqs[:2]]
    arms = {}
    for tokens, mode in ((SLOTS, "wo"), (pad_to, "dyn")):
        tag = f"quant/{mode}"
        check(Q.roofline_mode(tokens) == mode,
              f"roofline_mode({tokens}) is {Q.roofline_mode(tokens)}, expected {mode}")
        t0 = time.perf_counter()
        qparams, counts = Q.autoquant(params, tokens_per_step=tokens)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(counts == {"wo": n_lin if mode == "wo" else 0,
                         "dyn": n_lin if mode == "dyn" else 0},
              f"{tag}: autoquant counts {counts}")
        q_bytes = sum(t.numel() for t in leaves(qparams["layers"]) if t.dtype == torch.int8)
        print(f"[{tag}] autoquant(tokens_per_step={tokens}) -> {counts} in {secs:.2f} s | "
              f"int8 weight bytes {q_bytes} vs bf16 {bf16_bytes} "
              f"({q_bytes / bf16_bytes:.4f}x)", flush=True)
        serve.warmup(model, qparams, slots=SLOTS, pad_to=pad_to, max_new_cap=MAX_NEW,
                     device=dev)
        _, served, arms[mode] = serve_once(model, qparams, cfg, pad_to, policy="continuous",
                                           int8_mode=mode, tag=tag)
        phase_parity(model, qparams, pad_to, reqs[:2], served, tag=f"{tag} parity")
        drift = []
        for r, lf in zip(reqs[:2], full):
            lq = _prefill_last(model, qparams, r.prompt, "cuda")
            drift.append(float((lq - lf).abs().max() / lf.abs().max()))
        print(f"[{tag}] max relative logit drift vs the bf16 params (prefill, requests "
              f"{[r.rid for r in reqs[:2]]}): {max(drift):.4f} ({drift})", flush=True)
        phase_profile(model, qparams, pad_to, reqs, tag=f"{tag} profile",
                      fused=fused_per_forward(cfg))
        del qparams
        torch.cuda.empty_cache()
    for tokens in (SLOTS, pad_to):
        t0 = time.perf_counter()
        _, counts = Q.autoquant(params, tokens_per_step=tokens, calibrate="measure")
        torch.cuda.synchronize()
        print(f"[quant] autoquant(tokens_per_step={tokens}, calibrate='measure') -> "
              f"{counts} in {time.perf_counter() - t0:.1f} s", flush=True)
    return arms


def _tree_float(tree):
    """An f32 copy of a params tree (the same model in f32, for parity
    without bf16 rounding)."""
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_float(v) for v in tree]
    return tree.float()


N_HISTORIES = 8
# kernel path vs plain path, max |logit difference| over the plain logits'
# range: bf16 rounds each layer's output (one bf16 ulp is 2^-8 of a value),
# f32 differs only in summation order
HSTU_PARITY = {"bfloat16": 5e-2, "float32": 1e-3}


def phase_hstu():
    """Full-width HSTU scores 8 user histories; returns the kernels' launch
    counts of one forward (bf16) and of the f32 forward of the parity check
    (two histories, an f32 copy of the params: the CUDA-core route)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.training import data as data_mod

    dev = torch.device("cuda")
    cfg = get_config("hstu")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab_size, cfg.hstu_max_attn_len,
           cfg.dtype) == (14, 512, 8, 6000, 1024, "bfloat16"), f"unexpected config {cfg}")
    model = get_model(cfg)
    with torch.inference_mode():
        params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    hist = list(data_mod.hstu_user_histories(N_HISTORIES, seed=0))
    lens = [len(h) for h in hist]

    def batch_of(rows):
        toks = np.zeros((len(rows), max(lens[i] for i in rows)), np.int32)
        for j, i in enumerate(rows):
            toks[j, : lens[i]] = hist[i]
        return {"tokens": torch.from_numpy(toks).to(dev),
                "lengths": torch.tensor([lens[i] for i in rows], dtype=torch.int32,
                                        device=dev)}

    batch = batch_of(range(N_HISTORIES))

    def fwd(b=batch, p=params, impl="auto"):
        with torch.inference_mode():
            return model.forward(p, b, mode="prefill", impl=impl)

    fwd()
    torch.cuda.synchronize()
    _reset_counts()
    retrieval, _, aux = fwd()
    torch.cuda.synchronize()
    counts = _read_counts()
    want = _want_counts(cfg, 1, hstu_attention=cfg.n_layers)
    check(counts == want, f"hstu: kernel launches {counts}, expected {want}")
    t_max = batch["tokens"].shape[1]
    check(tuple(retrieval.shape) == (N_HISTORIES, t_max, cfg.vocab_size)
          and tuple(aux["ranking_logits"].shape) == (N_HISTORIES, t_max, 8),
          "hstu: unexpected output shapes")
    check(bool(torch.isfinite(retrieval).all()) and bool(torch.isfinite(aux["ranking_logits"]).all()),
          "hstu: non-finite logits")
    del retrieval, aux
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    with profiler() as prof:
        fwd()
        torch.cuda.synchronize()
    kern = device_kernels(prof)
    if kern:  # bf16: every layer on the tensor-core kernel
        check_kernel_names(kern, {"hstu_attention_mma_kernel": cfg.n_layers,
                                  "hstu_attention_kernel": 0}, "hstu", again=fwd)
    split = device_split(kern) if kern else None
    dev_txt = ("not measured" if split is None else
               f"{sum(split[0].values()) / 1e3:.3f} ms ({len(kern)} device kernels; unfused: "
               f"{UNFUSED_HSTU_KERNELS}, less the {fused_per_forward(cfg)} fused launches: "
               f"{UNFUSED_HSTU_KERNELS - fused_per_forward(cfg)})")
    print(f"[hstu] {N_HISTORIES} histories, lengths {lens} (padded to {t_max}) | forward "
          f"wall {wall:.3f} ms, device {dev_txt} | {N_HISTORIES / wall * 1e3:.2f} "
          f"histories/s | launches per forward {counts}", flush=True)
    if split is not None:
        print_split("hstu", *split, 1, "forward")

    two = batch_of([0, 1])
    f32_counts = None
    for name, p in (("bfloat16", params), ("float32", _tree_float(params))):
        _reset_counts()
        with profiler() as prof:
            got_r, _, got_a = fwd(two, p, "auto")
            torch.cuda.synchronize()
        counts_p = _read_counts()
        check(counts_p == want, f"hstu {name}: kernel launches {counts_p}, expected {want}")
        kern = device_kernels(prof)
        if kern and name == "float32":  # f32: every layer on the CUDA-core kernel
            check_kernel_names(kern, {"hstu_attention_kernel": cfg.n_layers,
                                      "hstu_attention_mma_kernel": 0}, "hstu float32",
                               again=lambda p=p: fwd(two, p, "auto"))
        if name == "float32":
            f32_counts = counts_p
        want_r, _, want_a = fwd(two, p, "torch")
        for what, g_, w_ in (("retrieval", got_r, want_r),
                             ("ranking", got_a["ranking_logits"], want_a["ranking_logits"])):
            check(bool(torch.isfinite(g_).all()), f"hstu {name}: non-finite {what} logits")
            delta = float((g_ - w_).abs().max())
            span = float(w_.max() - w_.min())
            print(f"[hstu parity] {name} {what} logits, histories 0-1: max|d| {delta:.4e} = "
                  f"{delta / span:.2e} of the range {span:.2f} (limit {HSTU_PARITY[name]:.0e})",
                  flush=True)
            check(delta <= HSTU_PARITY[name] * span,
                  f"hstu {name} {what}: kernel path off the plain path by {delta}")
        del got_r, got_a, want_r, want_a
    torch.cuda.empty_cache()
    return counts, f32_counts


def phase_ssm(pad_to: int):
    """Full-width mamba2-130m served through the scheduler; returns the
    launch counts of the served run and of one f32 prefill (an f32 copy of
    the params: the scan's f32 route)."""
    import torch

    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import serve
    from repro_torch.models import get_model

    dev = torch.device("cuda")
    cfg, model, params = serve.build_model("mamba2-130m", smoke=False, seed=SEED, device=dev)
    s = cfg.ssm
    check((cfg.n_layers, cfg.d_model, s.d_state, cfg.vocab_size, s.chunk_size, cfg.dtype)
          == (24, 768, 128, 50280, 256, "bfloat16"), f"unexpected config {cfg}")
    t0 = time.perf_counter()
    serve.warmup(model, params, slots=SLOTS, pad_to=pad_to, max_new_cap=MAX_NEW, device=dev)
    print(f"[ssm] mamba2-130m | pad_to {pad_to} | warm-up {time.perf_counter() - t0:.1f}s",
          flush=True)
    _, served, counts = serve_once(model, params, cfg, pad_to, policy="continuous",
                                   int8_mode=None, tag="ssm/continuous")
    reqs = _trace(cfg, pad_to)
    phase_parity(model, params, pad_to, reqs[:2], served, tag="ssm parity")
    phase_profile(model, params, pad_to, reqs, tag="ssm profile", fused=fused_per_forward(cfg))
    plan = ss.launch_plan(1, pad_to, s.n_heads(cfg.d_model), s.head_dim, s.n_groups,
                          s.d_state, s.chunk_size)
    f32_counts = None
    for name, mdl, p in (("bfloat16", model, params),
                         ("float32", get_model(cfg.replace(dtype="float32")),
                          _tree_float(params))):
        # one prefill through the kernels, profiled: every layer's scan on
        # the route of its type; f32 parity with the plain path as HSTU's
        r = reqs[0]
        _reset_counts()
        with profiler() as prof:
            lc = _prefill_last(mdl, p, r.prompt, "cuda")
            torch.cuda.synchronize()
        counts_p = _read_counts()
        want = _want_counts(cfg, 1, ssd_scan=cfg.n_layers)
        check(counts_p == want, f"ssm {name} prefill: kernel launches {counts_p}, "
                                f"expected {want}")
        kern = device_kernels(prof)
        if kern:
            routes = ({k: cfg.n_layers for k in plan} if name == "bfloat16" else
                      {"ssd_scan_kernel": cfg.n_layers})
            for k in ("ssd_scan_kernel", "ssd_chunk_state_kernel", "ssd_state_passing_kernel",
                      "ssd_chunk_scan_kernel"):
                routes.setdefault(k, 0)
            check_kernel_names(kern, routes, f"ssm {name} prefill",
                               again=lambda mdl=mdl, p=p: _prefill_last(mdl, p, r.prompt,
                                                                         "cuda"))
        if name == "float32":
            f32_counts = counts_p
            lp = _prefill_last(mdl, p, r.prompt, "torch")
            delta = float((lc - lp).abs().max())
            span = float(lp.max() - lp.min())
            print(f"[ssm parity] float32 prefill logits, request {r.rid}: max|d| "
                  f"{delta:.4e} = {delta / span:.2e} of the range {span:.2f} (limit "
                  f"{HSTU_PARITY[name]:.0e})", flush=True)
            check(delta <= HSTU_PARITY[name] * span,
                  f"ssm float32: kernel path off the plain path by {delta}")
            del mdl, p
    del params
    torch.cuda.empty_cache()
    return counts, f32_counts


# --------------------------------------------------------------------------
# the multimodal phases: Seamless (beam search with a KV reorder a step) and
# Chameleon (I-T greedy, T-I contrastive: two forwards a step)
# --------------------------------------------------------------------------

def _encdec_counts(cfg, n_steps: int, t2u_layers: int = 0):
    """Launches of one batch-at-a-time run of an encoder-decoder over
    ``n_steps`` decoder forwards (one prefill, then decode steps): the
    encoder once (flash n_enc; RMSNorm none 1, add 2 a layer), the decoder's
    self-attention on flash at the prefill and on decode after it, its
    cross-attention on flash every forward (RMSNorm none 1, add 3 a layer,
    a forward), and a T2U forward's ``t2u_layers`` bidirectional layers."""
    ne, nd = cfg.encdec.n_encoder_layers, cfg.n_layers
    want = dict.fromkeys(_counters(), 0)
    want["flash_attention"] = ne + nd + nd * n_steps + t2u_layers
    want["decode_attention"] = nd * (n_steps - 1)
    want["rmsnorm/none"] = 1 + n_steps + (1 if t2u_layers else 0)
    want["rmsnorm/add"] = 2 * ne + 3 * nd * n_steps + 2 * t2u_layers
    want["rmsnorm"] = want["rmsnorm/none"] + want["rmsnorm/add"]
    return want


def _event_timed(fn, events):
    """``fn`` with a CUDA event pair recorded around each call (no sync)."""
    import torch

    def run(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **kw)
        end.record()
        events.append((start, end))
        return out
    return run


# a step's logits of the kernel path may leave the plain path's by this
# share of the plain logits' span (max - min of a row): the bf16 kernels'
# own relative tolerance (TOL), over the whole range of a row
LOGIT_DRIFT = TOL["bfloat16"][1]


def beam_parity(model, params, extra, n_groups, max_new, got, tag):
    """The kernel path's beam search against the plain path's on the card,
    every step with the plain path's beams forced on both: the plain run
    records each step's logits; the kernel run is fed the plain path's
    tokens and reorders its cache by the plain path's permutation, and at
    every step its own choice (``beam_step`` on its own logits) is compared
    with the plain path's. Each step's logits must stay within LOGIT_DRIFT
    of each row's plain logit span, so the two paths cannot drift apart. A
    step whose choice differs passes only as a near tie of the groups that
    differ: for each, the plain path's score of the first beam slot that
    differs minus its score of the candidate the kernel path put there is
    below the two paths' max |candidate difference| over those two
    candidates, twice. With no differing step the kernel path's own run
    (``got``, its tokens) must equal the plain path's."""
    import torch

    from repro_torch.core import engine, profiles, sampling

    dev = torch.device("cuda")
    bos = torch.full((n_groups, 1), BOS, dtype=torch.int32, device=dev)

    class Plain(profiles.BeamProfile):
        def step(self, state, logits, key=None):
            kept.append(logits.float().clone())
            return super().step(state, logits, key)

    class Forced(profiles.BeamProfile):
        def step(self, state, logits, key=None):
            lp = kept[len(rows)]
            want = super().step(state, lp, key)
            own = super().step(state, logits, key)
            lk = logits.float()
            drift = float(((lk - lp).abs().amax(1) / (lp.amax(1) - lp.amin(1))).max())
            ties = []
            tok = (own.feed != want.feed) | (own.perm != want.perm)
            for g in torch.nonzero(tok.reshape(n_groups, N_BEAMS).any(1)).flatten().tolist():
                ck = sampling.beam_candidates(state, logits, N_BEAMS, EOS)[g]
                cp = sampling.beam_candidates(state, lp, N_BEAMS, EOS)[g]
                j = int(torch.nonzero(tok[g * N_BEAMS:(g + 1) * N_BEAMS])[0])
                r, v = g * N_BEAMS + j, logits.shape[1]  # candidate = parent * V + token
                cw = int(want.perm[r] - g * N_BEAMS) * v + int(want.feed[r])
                co = int(own.perm[r] - g * N_BEAMS) * v + int(own.feed[r])
                gap = float(cp[cw] - cp[co])
                delta = max(float((ck[cw] - cp[cw]).abs()), float((ck[co] - cp[co]).abs()))
                ties.append((g, j, gap, delta))
            rows.append((drift, ties))
            return want

    kept, rows = [], []
    plain = engine.run_profile(model, params, Plain(n_beams=N_BEAMS, eos_id=EOS), bos,
                               max_new_tokens=max_new, extra_inputs=extra, impl="torch")
    forced = engine.run_profile(model, params, Forced(n_beams=N_BEAMS, eos_id=EOS), bos,
                                max_new_tokens=max_new, extra_inputs=extra, impl="cuda")
    check(len(rows) == len(kept) == plain["n_steps"] == forced["n_steps"]
          and torch.equal(forced["tokens"], plain["tokens"]),
          f"{tag}: the forced run left the plain path's beams")
    drift = max(d for d, _ in rows)
    print(f"[{tag}] {len(rows)} steps with the plain path's beams forced: kernel-path logits "
          f"within {drift:.3e} of the plain logit span a row at worst (bound {LOGIT_DRIFT})",
          flush=True)
    check(drift <= LOGIT_DRIFT, f"{tag}: the kernel path's logits drift {drift} of the plain "
          f"span, above {LOGIT_DRIFT}")
    n_ties = 0
    for i, (_, ties) in enumerate(rows):
        for g, j, gap, delta in ties:
            n_ties += 1
            print(f"[{tag}] step {i}, group {g}: the kernel path's beam {j} differs (plain "
                  f"score gap {gap:.4f}, max|d| of the two candidates {delta:.4f})", flush=True)
            check(gap <= 2 * delta, f"{tag}: step {i} group {g} differs away from a near tie")
    if n_ties == 0:
        check(torch.equal(got, plain["tokens"]),
              f"{tag}: no step differs but the kernel path's tokens do")
        print(f"[{tag}] beam tokens of the kernel path equal the plain path's over "
              f"{len(rows)} steps", flush=True)
    else:
        print(f"[{tag}] {n_ties} near ties in {len(rows)} steps; the kernel path's own tokens "
              f"{'equal' if torch.equal(got, plain['tokens']) else 'differ from'} the plain "
              f"path's", flush=True)


def greedy_parity(model, params, prompt, got, want, tag, mix=None, what="the plain path's"):
    """Greedy tokens of the kernel path (``got``) against the plain path's
    (``want``) for one prompt: equal up to the first divergence, which
    passes only at a near tie: where the plain path's top-1/top-2 gap is
    below the two paths' max |logit difference| at that step (prefills of
    the prompt and the plain tokens before it; ``want`` may come from the
    kernel path's batch engine, ``what`` names it). ``mix`` (the T-I guidance,
    the null token and the image offset) compares the contrastive mix of a
    conditional and an unconditional prefill, masked to the image range."""
    import torch

    from repro_torch.models import vlm

    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if first is None:
        print(f"[{tag}] {len(got)} tokens of the kernel path equal {what}", flush=True)
        return

    def logits(impl):
        cond = _prefill_last(model, params, list(prompt) + want[:first], impl)
        if mix is None:
            return cond
        guidance, uncond_token, offset = mix
        uncond = _prefill_last(model, params, [uncond_token] * len(prompt) + want[:first], impl)
        return vlm.image_token_mask(offset, vlm.contrastive_logits(
            cond[None], uncond[None], guidance))[0, offset:]

    lk, lp = logits("cuda"), logits("torch")
    delta = float((lk - lp).abs().max())
    top2 = torch.topk(lp, 2).values
    gap = float(top2[0] - top2[1])
    print(f"[{tag}] token {first} of {len(got)} differs from {what} (gap {gap:.4f}, "
          f"max|dlogit| {delta:.4f})", flush=True)
    check(gap < delta, f"{tag}: token {first} differs away from a near tie")


def recording_beam(n_beams: int, eos_id: int):
    """A ``BeamProfile`` that keeps, every step, its candidate scores and its
    choice (feed tokens and parents). The scheduler steps a request's own
    profile object, so a served group's beams can be held against a batch
    run's; a replay after a preemption starts the record anew."""
    from repro_torch.core import profiles, sampling

    class BeamProfile(profiles.BeamProfile):  # the name request_class reads
        def step(self, state, logits, key=None):
            if state.step == 0:
                self.log.clear()
            cand = sampling.beam_candidates(state, logits, self.n_beams, self.eos_id)
            out = super().step(state, logits, key)
            self.log.append((cand, out.feed.clone(), out.perm.clone()))
            return out

    prof = BeamProfile(n_beams=n_beams, eos_id=eos_id)
    prof.log = []
    return prof


def beam_agreement(served, batch, g: int, n_beams: int, tag: str):
    """A served group's record against group ``g`` of a batch run's, step by
    step, under ``beam_parity``'s rule: equal choices, or, at the first step
    that differs, a near tie: for the first beam slot that differs, the batch
    run's score of its candidate minus its score of the served run's
    candidate is at most twice the two runs' max |candidate difference| over
    those two candidates. Returns that step, or None when none differs."""
    import torch

    rows = slice(g * n_beams, (g + 1) * n_beams)
    for i, ((ck, fs, ps), (cp, fb, pb)) in enumerate(zip(served, batch)):
        fb, pb = fb[rows], pb[rows] - g * n_beams
        diff = (fs != fb) | (ps != pb)
        if not bool(diff.any()):
            continue
        j = int(torch.nonzero(diff)[0])
        v = ck.shape[1] // n_beams
        cw, co = int(pb[j]) * v + int(fb[j]), int(ps[j]) * v + int(fs[j])
        ck, cp = ck[0], cp[g]
        gap = float(cp[cw] - cp[co])
        delta = max(float((ck[cw] - cp[cw]).abs()), float((ck[co] - cp[co]).abs()))
        print(f"[{tag}] step {i}: beam {j} differs from the batch run (batch score gap "
              f"{gap:.4f}, max|d| of the two candidates {delta:.4f})", flush=True)
        check(gap <= 2 * delta, f"{tag}: step {i} differs away from a near tie")
        return i
    check(len(served) <= len(batch), f"{tag}: {len(served)} served steps, {len(batch)} batch")
    return None


def step_profile(tag, step, n_steps: int = 5):
    """Wall ms (unprofiled, host clock to a synchronise), device busy ms and
    device kernels of one call of ``step``, over ``n_steps`` calls."""
    import torch

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n_steps
    with profiler() as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    kern = device_kernels(prof)
    if not kern:
        print(f"[{tag}] wall {wall:.3f} ms; the profiler saw no device activity: device time "
              f"not measured", flush=True)
        return
    cats, by_name = device_split(kern)
    busy = sum(cats.values()) / n_steps / 1e3
    print(f"[{tag}] wall {wall:.3f} ms unprofiled | device busy {busy:.3f} ms = "
          f"{busy / wall:.1%} | {len(kern) / n_steps:.0f} device kernels", flush=True)
    print_split(tag, cats, by_name, n_steps, "step")


def _peak_run(fn):
    """(fn's result, device bytes allocated at its peak above the
    allocation before it)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def phase_seamless(st_cfg=None, ss_cfg=None):
    """S-T on whisper-base (4 utterances x 4 beams, the reorder in place and
    then into fresh tensors: equal tokens), then S-S on seamless-m4t (2
    utterances: beam text, one T2U and one vocoder forward). Exact launches,
    finite scores, the kernel path's beams against the plain path's, the
    encoder's device time, one beam step profiled, the reorder's time per
    step in each arm. Returns the launch counts of the S-T run."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import engine, kv_cache, profiles
    from repro_torch.models import encdec, get_model, seamless

    dev = torch.device("cuda")
    cfg = st_cfg or get_config("whisper-base")
    if st_cfg is None:
        check((cfg.encdec.n_encoder_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
               cfg.head_dim, cfg.encdec.n_frames, cfg.vocab_size, cfg.dtype)
              == (6, 6, 512, 8, 64, N_FRAMES, 51865, "bfloat16"), f"unexpected config {cfg}")
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.inference_mode():
        params = model.init(gen, dev)
        frames = torch.randn((N_UTTER, cfg.encdec.n_frames, cfg.d_model), generator=gen,
                             device=dev).to(params["embed"]["table"].dtype)
    fl = torch.tensor(st_frame_lengths(N_UTTER, cfg.encdec.n_frames), device=dev)
    extra = {"frames": frames, "frame_lengths": fl}
    kw = dict(batch=N_UTTER, n_beams=N_BEAMS, bos_id=BOS, eos_id=EOS,
              max_new_tokens=ST_MAX_NEW, extra_inputs=extra)
    print(f"[seamless] {cfg.name}: {cfg.encdec.n_encoder_layers} + {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, {cfg.encdec.n_frames} "
          f"frames | S-T {N_UTTER} utterances x {N_BEAMS} beams, frame lengths {fl.tolist()}",
          flush=True)
    engine.generate_beam(model, params, **dict(kw, max_new_tokens=2))  # warm-up
    runs, counts = {}, None
    for arm, donate in (("donated", True), ("realloc", False)):
        events = []
        name = "reorder_donated" if donate else "reorder_realloc"
        real = getattr(kv_cache, name)
        setattr(kv_cache, name, _event_timed(real, events))
        try:
            _reset_counts()
            t0 = time.perf_counter()
            out, peak = _peak_run(lambda: engine.generate_beam(model, params,
                                                               donate_reorder=donate, **kw))
            wall = time.perf_counter() - t0
            got = _read_counts()
        finally:
            setattr(kv_cache, name, real)
        want = _encdec_counts(cfg, out["n_steps"])
        check(got == want, f"seamless S-T {arm}: kernel launches {got}, expected {want}")
        check(tuple(out["tokens"].shape) == (N_UTTER, ST_MAX_NEW)
              and bool(torch.isfinite(out["scores"]).all()), f"seamless S-T {arm}: bad output")
        reorder_ms = [a.elapsed_time(b) for a, b in events]
        runs[arm] = out
        counts = counts or got
        print(f"[seamless S-T/{arm}] {out['n_steps']} steps in {wall * 1e3:.1f} ms wall | "
              f"reorder {statistics.median(reorder_ms):.4f} ms a step (median of "
              f"{len(reorder_ms)}, sum {sum(reorder_ms):.2f} ms) | peak {peak} B above the "
              f"allocation before the run | launches {got}", flush=True)
    check(torch.equal(runs["donated"]["tokens"], runs["realloc"]["tokens"]),
          "seamless S-T: the two reorder arms gave different tokens")
    for b in range(N_UTTER):
        print(f"[seamless S-T] hyp {b}: score {float(runs['donated']['scores'][b]):.4f} "
              f"tokens {runs['donated']['tokens'][b].tolist()}", flush=True)
    beam_parity(model, params, extra, N_UTTER, ST_MAX_NEW, runs["donated"]["tokens"],
                "seamless parity")
    served_counts = st_served(cfg, model, params, extra, runs["donated"]["tokens"])

    # the encoder's device time, one beam step, and the reorder alone on
    # the step's cache (16 streams)
    prof = profiles.BeamProfile(n_beams=N_BEAMS, eos_id=EOS)
    toks, lens, ext = prof.expand_prompts(
        torch.full((N_UTTER, 1), BOS, dtype=torch.int32, device=dev),
        torch.ones((N_UTTER,), dtype=torch.int32, device=dev), extra)
    with torch.inference_mode():
        enc_ms = device_ms(lambda: encdec.encode(cfg, params, ext["frames"]), calls=3)
    print(f"[seamless] encoder over [{N_UTTER * N_BEAMS}, {cfg.encdec.n_frames}, "
          f"{cfg.d_model}]: device "
          f"{'not measured' if enc_ms is None else f'{enc_ms:.3f} ms'}", flush=True)
    logits, cache = engine.prefill(model, params, toks, lens, ST_MAX_NEW + 2, extra=ext)
    state = {"s": prof.init(N_UTTER, ST_MAX_NEW, dev), "logits": logits, "cache": cache}

    def beam_step():
        out = prof.step(state["s"], state["logits"])
        state["cache"] = kv_cache.reorder_donated(state["cache"], out.perm)
        state["logits"], state["cache"] = engine.decode_step(model, params, state["cache"],
                                                             out.feed)
        state["s"] = out.state
        bool(out.done.all().item())  # the loop's one host sync

    step_profile("seamless beam step", beam_step)
    n_bytes = kv_cache.cache_bytes(state["cache"])
    perm = torch.arange(N_UTTER * N_BEAMS, device=dev).flip(0)
    donated = cuda_ms(lambda: kv_cache.reorder_donated(state["cache"], perm), samples=5)
    realloc = cuda_ms(lambda: kv_cache.reorder_realloc(state["cache"], perm), samples=5)
    print(f"[seamless reorder] cache {n_bytes} B ({N_UTTER * N_BEAMS} streams; cross K/V "
          f"{kv_cache.cache_bytes([lc['cross_k'] for lc in state['cache']['layers']]) * 2} B) | "
          f"donated (index_select, then copy_: 4x the bytes) {donated:.4f} ms | realloc "
          f"(index_select: 2x) {realloc:.4f} ms | bound of a gather (2x the bytes) "
          f"{2 * n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
    del state, cache, logits

    # S-S on seamless-m4t: beam text, one T2U forward, one vocoder forward
    scfg = ss_cfg or get_config("seamless-m4t")
    smodel = get_model(scfg)
    with torch.inference_mode():
        sparams = smodel.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    _reset_counts()
    t0 = time.perf_counter()
    ss, peak = _peak_run(lambda: seamless.speech_to_speech(
        smodel, sparams, frames=frames[:N_SS], bos_id=BOS, eos_id=EOS, n_beams=N_BEAMS,
        max_text_len=ST_MAX_NEW))
    wall = time.perf_counter() - t0
    got = _read_counts()
    want = _encdec_counts(scfg, ss["n_decode_steps"], t2u_layers=len(sparams["t2u"]["layers"]))
    check(got == want, f"seamless S-S: kernel launches {got}, expected {want}")
    n_units = ss["text"].shape[1] * seamless.UPSAMPLE_T2U
    check(tuple(ss["units"].shape) == (N_SS, n_units)
          and tuple(ss["waveform"].shape) == (N_SS, n_units * int(np.prod(
              seamless.UPSAMPLE_VOCODER))) and bool(torch.isfinite(ss["waveform"]).all()),
          f"seamless S-S: units {tuple(ss['units'].shape)}, waveform "
          f"{tuple(ss['waveform'].shape)}")
    print(f"[seamless S-S] {scfg.name}: {N_SS} utterances, {ss['n_decode_steps']} decode steps, "
          f"units {tuple(ss['units'].shape)}, waveform {tuple(ss['waveform'].shape)} in "
          f"{wall * 1e3:.1f} ms wall | peak {peak} B | launches {got}", flush=True)
    del model, params, smodel, sparams, ss, runs
    torch.cuda.empty_cache()
    return counts, served_counts


def st_served(cfg, model, params, extra, batch_tokens):
    """S-T served: each utterance a 4-beam request with its own frames
    through the contiguous scheduler (16 slots; its frames written into its
    slots' cross rows at admission), against a recording batch run (the
    phase's ``generate_beam`` tokens) under ``beam_agreement``'s rule; exact
    launches (``_encdec_counts``' prefill per admission and decode step per
    pool step); the reorder (a pool-wide row gather per group a step) timed
    by CUDA events; one served step profiled. Returns the launch counts."""
    import numpy as np
    import torch

    from repro_torch.core import engine, kv_cache, profiles
    from repro_torch.core.scheduler import Scheduler, ServeRequest

    dev = torch.device("cuda")
    rec = recording_beam(N_BEAMS, EOS)
    bos = torch.full((N_UTTER, 1), BOS, dtype=torch.int32, device=dev)
    batch = engine.run_profile(model, params, rec, bos, max_new_tokens=ST_MAX_NEW,
                               extra_inputs=extra)
    check(torch.equal(batch["tokens"], batch_tokens),
          "seamless S-T served: the recording batch run left generate_beam's tokens")

    def requests(max_new, record):
        return [ServeRequest(rid=i, prompt=np.asarray([BOS]), max_new=max_new,
                             profile=(recording_beam(N_BEAMS, EOS) if record else
                                      profiles.BeamProfile(n_beams=N_BEAMS, eos_id=EOS)),
                             extra_inputs={k: v[i:i + 1] for k, v in extra.items()})
                for i in range(N_UTTER)]

    # pad_to 1: the BOS prompt, so the pool's max_len is the batch run's (50)
    kw = dict(slots=N_UTTER * N_BEAMS, pad_to=1, max_new_cap=ST_MAX_NEW, device=dev)
    Scheduler(model, params, **kw).run(requests(2, False))  # warm-up
    events, real = [], kv_cache.reorder_donated
    kv_cache.reorder_donated = _event_timed(real, events)
    try:
        sched = Scheduler(model, params, **kw)
        reqs = requests(ST_MAX_NEW, True)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        done, peak = _peak_run(lambda: sched.run(reqs))
        wall = time.perf_counter() - t0
        got = _read_counts()
    finally:
        kv_cache.reorder_donated = real
    one, two = _encdec_counts(cfg, 1), _encdec_counts(cfg, 2)
    n_adm, n_steps = sched.n_prefills, sched.n_decode_steps
    want = {k: n_adm * one[k] + n_steps * (two[k] - one[k]) for k in one}
    check(got == want, f"seamless S-T served: kernel launches {got}, expected {want}")
    check(n_adm == sched.n_group_admissions == N_UTTER and sched.n_cache_reorders >= 1
          and len(events) == sched.n_cache_reorders,
          f"seamless S-T served: {n_adm} prefills, {sched.n_group_admissions} groups, "
          f"{sched.n_cache_reorders} reorders, {len(events)} timed")
    reorder_ms = [a.elapsed_time(b) for a, b in events]
    same = 0
    for r in sorted(done, key=lambda r: r.rid):
        check(1 <= len(r.tokens) <= ST_MAX_NEW and np.isfinite(r.score),
              f"seamless S-T served {r.rid}: {len(r.tokens)} tokens, score {r.score}")
        if beam_agreement(r.profile.log, rec.log, r.rid, N_BEAMS,
                          f"seamless S-T served {r.rid}") is None:
            check(r.tokens == batch["tokens"][r.rid, :len(r.tokens)].tolist(),
                  f"seamless S-T served {r.rid}: no step differs but the tokens do")
            same += 1
    print(f"[seamless S-T served] {N_UTTER} requests x {N_BEAMS} beams, {n_steps} pool steps "
          f"in {wall * 1e3:.1f} ms wall ({wall * 1e3 / n_steps:.3f} ms a step) | peak {peak} B | "
          f"{sched.n_cache_reorders} row gathers, {statistics.median(reorder_ms):.4f} ms each "
          f"(median), {sum(reorder_ms) / n_steps:.4f} ms a step | {same} of {N_UTTER} give the "
          f"batch run's beams at every step | launches {got}", flush=True)
    sched = Scheduler(model, params, **kw)
    sched.submit(requests(ST_MAX_NEW, False))
    sched._admit(0.0)
    step_profile("seamless S-T served step", sched.step)
    while sched.has_work:
        sched.step()
    return got


def phase_chameleon(cfg=None):
    """chameleon-34b at full width, 4 of 48 layers: I-T (1024 stub image
    tokens + 6 text tokens, 30 greedy tokens) and T-I (a 14-token prompt,
    1024 image tokens under guidance 3, greedy), each with exact launches
    and against the plain path; every T-I token in the image range; one T-I
    step profiled. Returns the launch counts of both runs together."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import engine, profiles
    from repro_torch.core.kv_cache import leaves
    from repro_torch.models import get_model, vlm

    dev = torch.device("cuda")
    if cfg is None:
        cfg = get_config("chameleon-34b").replace(n_layers=CHAMELEON_LAYERS)
        check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
               cfg.vocab_size, cfg.qk_norm, cfg.vlm.n_image_tokens, cfg.dtype)
              == (CHAMELEON_D, CHAMELEON_HEADS, 8, CHAMELEON_DH, 22016, 65536, True, N_IMAGE,
                  "bfloat16"), f"unexpected config {cfg}")
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = model.init(gen, dev)
    print(f"[chameleon] {cfg.name}: {cfg.n_layers} layers (depth cut), d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, qk-norm | params "
          f"{sum(p.numel() for p in leaves(params)) / 1e9:.3f}G elements | init "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    offset = vlm.image_token_offset(cfg)
    n_image = cfg.vlm.n_image_tokens
    image = vlm.encode_image_stub(cfg, gen, 1, dev)
    text = torch.randint(0, offset, (1, IT_TEXT), generator=gen, device=dev, dtype=torch.int32)
    it_prompt = vlm.build_it_input(cfg, image, text)
    ti_prompt = torch.randint(0, offset, (1, TI_PROMPT), generator=gen, device=dev,
                              dtype=torch.int32)
    engine.generate(model, params, it_prompt, max_new_tokens=2)  # warm-up
    total = dict.fromkeys(_counters(), 0)
    L = cfg.n_layers

    # I-T: greedy captioning of the image
    _reset_counts()
    t0 = time.perf_counter()
    it, peak = _peak_run(lambda: engine.generate(model, params, it_prompt,
                                                 max_new_tokens=IT_NEW))
    wall = time.perf_counter() - t0
    got = _read_counts()
    want = _want_counts(cfg, IT_NEW, flash_attention=L, decode_attention=L * (IT_NEW - 1))
    check(got == want, f"chameleon I-T: kernel launches {got}, expected {want}")
    check(it["n_steps"] == IT_NEW and bool(((it["tokens"] >= 0)
                                             & (it["tokens"] < cfg.vocab_size)).all()),
          "chameleon I-T: bad output")
    total = {k: total[k] + got[k] for k in total}
    print(f"[chameleon I-T] prompt {it_prompt.shape[1]} tokens ({n_image} image), {IT_NEW} "
          f"tokens in {wall * 1e3:.1f} ms wall | peak {peak} B | tokens "
          f"{it['tokens'][0].tolist()} | launches {got}", flush=True)
    plain = engine.generate(model, params, it_prompt, max_new_tokens=IT_NEW, impl="torch")
    greedy_parity(model, params, it_prompt[0].tolist(), it["tokens"][0].tolist(),
                  plain["tokens"][0].tolist(), "chameleon I-T parity")

    # T-I: contrastive image generation, two streams a step
    kw = dict(uncond_token=0, n_image_tokens=n_image, guidance=GUIDANCE)
    _reset_counts()
    t0 = time.perf_counter()
    ti, peak = _peak_run(lambda: engine.generate_contrastive(model, params, ti_prompt, **kw))
    wall = time.perf_counter() - t0
    got = _read_counts()
    want = _want_counts(cfg, n_image, flash_attention=L, decode_attention=L * (n_image - 1))
    check(got == want, f"chameleon T-I: kernel launches {got}, expected {want}")
    check(ti["n_steps"] == n_image and bool((ti["tokens"] >= offset).all())
          and bool((ti["tokens"] < cfg.vocab_size).all()),
          "chameleon T-I: a token outside the image range")
    total = {k: total[k] + got[k] for k in total}
    print(f"[chameleon T-I] prompt {TI_PROMPT} tokens, {n_image} image tokens (2 streams, "
          f"guidance {GUIDANCE}) in {wall * 1e3:.1f} ms wall = {wall * 1e3 / n_image:.3f} ms a "
          f"step | peak {peak} B | first tokens {ti['tokens'][0, :16].tolist()} | launches "
          f"{got}", flush=True)
    plain = engine.generate_contrastive(model, params, ti_prompt, impl="torch", **kw)
    greedy_parity(model, params, ti_prompt[0].tolist(), ti["tokens"][0].tolist(),
                  plain["tokens"][0].tolist(), "chameleon T-I parity",
                  mix=(GUIDANCE, 0, offset))

    # one T-I step: the decode forward of both streams and the mix
    prof = profiles.ContrastiveProfile(uncond_token=0, guidance=GUIDANCE, mask_offset=offset)
    toks, lens, _ = prof.expand_prompts(
        ti_prompt, torch.full((1,), TI_PROMPT, dtype=torch.int32, device=dev), None)
    logits, cache = engine.prefill(model, params, toks, lens, TI_PROMPT + n_image + 1)
    state = {"s": prof.init(1, n_image, dev), "logits": logits, "cache": cache}

    def ti_step():
        out = prof.step(state["s"], state["logits"])
        state["logits"], state["cache"] = engine.decode_step(model, params, state["cache"],
                                                             out.feed)
        state["s"] = out.state
        int(out.feed[0].item())  # the host reads the token

    step_profile("chameleon T-I step", ti_step)
    del cache, state, logits
    ti_prompts = torch.cat([ti_prompt, torch.randint(0, offset, (1, TI_PROMPT), generator=gen,
                                                     device=dev, dtype=torch.int32)])
    served = ti_served(cfg, model, params, ti_prompts, offset)
    del model, params
    torch.cuda.empty_cache()
    return total, served


def ti_served(cfg, model, params, prompts, offset):
    """T-I served: two contrastive requests (guidance 3, the image offset,
    N_IMAGE tokens) through the scheduler on the paged pool (block 16) and
    on the contiguous pool; exact launches (4 prefills, then one decode a
    layer each pool step), every token in the image range, no block left,
    and each request's tokens against a batch ``generate_contrastive`` of
    both prompts under ``greedy_parity``'s rule. Returns each arm's launch
    counts."""
    import torch

    from repro_torch.core import engine, profiles
    from repro_torch.core.scheduler import Scheduler, ServeRequest

    dev = torch.device("cuda")
    n_req, n_image, L = prompts.shape[0], cfg.vlm.n_image_tokens, cfg.n_layers
    want = engine.generate_contrastive(model, params, prompts, uncond_token=0,
                                       n_image_tokens=n_image, guidance=GUIDANCE)

    def requests(max_new):
        return [ServeRequest(rid=i, prompt=prompts[i].cpu().numpy(), max_new=max_new,
                             profile=profiles.ContrastiveProfile(
                                 uncond_token=0, guidance=GUIDANCE, mask_offset=offset))
                for i in range(n_req)]

    out = {}
    for arm, geometry in (("paged", dict(paged=True, block_size=16)), ("contiguous", {})):
        tag = f"chameleon T-I served/{arm}"
        kw = dict(slots=2 * n_req, pad_to=TI_PROMPT, max_new_cap=n_image, device=dev,
                  **geometry)
        Scheduler(model, params, **kw).run(requests(2))  # warm-up
        sched = Scheduler(model, params, **kw)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        done, peak = _peak_run(lambda: sched.run(requests(n_image)))
        wall = time.perf_counter() - t0
        got = _read_counts()
        n_pre, n_steps = sched.n_prefills, sched.n_decode_steps
        dec = "paged_decode_attention" if geometry else "decode_attention"
        want_c = _want_counts(cfg, n_pre + n_steps, flash_attention=L * n_pre,
                              **{dec: L * n_steps})
        check(got == want_c, f"{tag}: kernel launches {got}, expected {want_c}")
        check(n_pre == 2 * n_req and n_steps == n_image - 1,
              f"{tag}: {n_pre} prefills, {n_steps} steps")
        if geometry:
            check(sched.pool.n_used_blocks == 0 and not sched.pool._ref.any(),
                  f"{tag}: blocks left after the run")
        for r in sorted(done, key=lambda r: r.rid):
            check(len(r.tokens) == n_image and min(r.tokens) >= offset
                  and max(r.tokens) < cfg.vocab_size, f"{tag} {r.rid}: bad tokens")
            greedy_parity(model, params, prompts[r.rid].tolist(), r.tokens,
                          want["tokens"][r.rid].tolist(), f"{tag} {r.rid}",
                          mix=(GUIDANCE, 0, offset), what="the batch run's")
        print(f"[{tag}] {n_req} requests x 2 streams, {n_image} image tokens: {n_steps} pool "
              f"steps in {wall * 1e3:.1f} ms wall ({wall * 1e3 / n_steps:.3f} ms a step) | peak "
              f"{peak} B | kv reserved {sched.pool.reserved_bytes} B | launches {got}",
              flush=True)
        out[arm] = got
    return out


#: the MoE phases: each model at its published widths, cut in depth to fit
#: one card (qwen3-moe-30b-a3b: 4 of 48 layers; deepseek-v2-236b: 3 of 60,
#: its dense layer 0 and two MoE layers), LayerSkip's exit layer there, and
#: the arms: arm -> (temperature, top_p, speculative, scheduler geometry)
MOE_LAYERS = {"qwen3-moe-30b-a3b": 4, "deepseek-v2-236b": 3}
MOE_SPEC_EXIT = 2
MOE_ARMS = {"contiguous": (0.0, 1.0, False, {}),
            "paged": (0.0, 1.0, False, PAGED_ARMS["paged"]),
            "chunked": (0.0, 1.0, False, PAGED_ARMS["chunked"]),
            "spec t=0.8": (SPEC_TEMP, SPEC_TOP_P, True, {})}
#: the teacher-forced comparison of an arm's kernel path with its plain path
#: (``Forced``, mode "steps"): the largest |dprob| of the first MoE layer's
#: router at a live lane (no routing difference reaches it: every layer
#: before it is attention or dense), and the largest |dlogit| of a committed
#: token's row whose forward routed every lane of its slot as the plain run.
#: Set between sound runs and ``one_key_short`` (NVIDIA H100 80GB HBM3, 700
#: W, bf16; every arm of both models): sound at most 0.0018 and 0.0625, the
#: control at least 0.0035 and 0.22
FORCED_DPROB_BOUND, FORCED_DLOGIT_BOUND = 0.003, 0.125
#: across pools under dropless capacity (mode "keys"): the median |dlogit|
#: of the committed tokens' rows against the contiguous pool's; sound at
#: most 0.035 (chunked), the paged control at least 0.086 (the same card)
CROSS_DLOGIT_MEDIAN_BOUND = 0.0625
#: gaps below this are counted as near ties by the fixed rule
FIXED_TIE = 1e-4


#: set within ``plain_path``: a served run there must launch no kernel
PLAIN_PATH = {"on": False}


class plain_path:
    """Within it, every kernel wrapper that ``impl="auto"`` reaches takes its
    plain PyTorch version on CUDA tensors too (``ops._resolve``): the plain
    path that a served arm is held against. ``serve_once`` then checks that
    every launch count stays 0."""

    def __enter__(self):
        from repro_torch.kernels import ops

        self.real = ops._resolve
        ops._resolve = lambda impl, x: "torch" if impl == "auto" else self.real(impl, x)
        PLAIN_PATH["on"] = True

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops._resolve = self.real
        PLAIN_PATH["on"] = False


def _deciding_scores(row, args, idx):
    """(scores, temperature) a draw decides a row by: the logits when
    greedy; sampled, the nucleus-filtered logits / T plus the row's Gumbel
    draw (``sampling.sample_slots``)."""
    from repro_torch.core import prng, sampling

    if not args:
        return row, 1.0
    keys, temp, top_p = args
    t = float(temp[idx[0]])
    if t <= 0:
        return row, 1.0
    return (sampling.nucleus(row / t, float(top_p[idx[0]])) + prng.gumbel(keys[idx], row.shape),
            t)


class Forced:
    """One served run's token draws, committed logit rows and routing.
    ``mode`` "record" keeps them. "steps" forces every draw (the scheduler's
    samples and LayerSkip's draft windows) to ``ref``'s in call order, so
    the run takes ``ref``'s tokens and steps on the same pool, and holds its
    routing forward by forward and its rows against ``ref``'s. "keys" forces
    each committed token to ``ref``'s token of the same (request, index) on
    another pool and holds its rows against ``ref``'s. A row is the logits a
    committed token was drawn from (a verify lane's when the window before
    it was accepted); the n-th row of a (request, index) meets ``ref``'s
    n-th, or its last. ``forcing`` installs the hooks."""

    def __init__(self, mode, ref=None):
        self.mode, self.ref = mode, ref
        self.sched = self.admitting = None
        self.draws, self.windows, self.routing = [], [], []
        self.rows, self.tokens, self.seen = {}, {}, {}
        self.n_draw = self.n_win = 0
        self.fwd = -1
        self.lanes = self.t_new = self.window = self.taint = None
        self.first_dprob, self.flips, self.row_stats = [], [], []

    def begin(self, lanes, n_rows, t_new=None):
        """A forward of ``n_rows`` rows starts; ``lanes`` [N] marks those
        that carry a live token."""
        self.fwd += 1
        self.lanes, self.n_rows, self.t_new, self.layer = lanes.reshape(-1), n_rows, t_new, 0
        self.flipped = self.lanes & False
        if self.mode == "record":
            self.routing.append([])
        elif self.mode == "steps":
            check(self.fwd < len(self.ref.routing),
                  f"forced run: forward {self.fwd} past the recording's {len(self.ref.routing)}")

    def route(self, probs, topk, kept):
        """One MoE layer's router probabilities [N, E], top-k and kept
        (not dropped) experts as [N, E] masks."""
        if self.lanes is None:  # a draft forward
            return
        check(probs.shape[0] == self.lanes.numel(), "router lanes differ from the forward's")
        if self.mode == "record":
            self.routing[-1].append((probs, topk, kept))
        elif self.mode == "steps":
            pp, tp, kp = self.ref.routing[self.fwd][self.layer]
            check(pp.shape == probs.shape, f"forward {self.fwd}: lanes differ from the recording's")
            live = self.lanes
            dprob = (probs - pp).abs().amax(-1)
            if self.layer == 0:
                self.first_dprob.append((dprob * live).amax())
            differs = (kept != kp).any(-1) & live
            new = differs & ~self.flipped
            k = int(tp[0].sum())
            top = pp.topk(k + 1, dim=-1).values
            self.flips.append((dprob[new], (top[:, k - 1] - top[:, k])[new],
                               (topk != tp).any(-1)[new]))
            self.flipped |= differs
        self.layer += 1

    def end(self):
        if self.mode == "steps":
            self.taint = self.flipped.reshape(self.n_rows, -1).any(-1).cpu().numpy()
        self.lanes = None

    def draft(self, window, cache):
        if self.mode == "record":
            self.windows.append(window.clone())
        elif self.mode == "steps":
            window = self.ref.windows[self.n_win].clone()
        self.n_win += 1
        self.window = window
        return window, cache

    def _committed(self, logits):
        """[(row index, (request, token index))] of the draw's rows that
        the scheduler commits (verify lanes: those it may commit)."""
        s = self.sched
        if logits.dim() == 3:  # a verify window
            w = s._window_widths()
            return [((b, j), (int(s._rid[b]), int(s._ngen[b]) + j))
                    for b in s.active for j in range(int(w[b]))]
        if self.admitting is not None:
            return [((0,), (self.admitting, 0))]
        rows = [((b,), (int(s._rid[b]), int(s._ngen[b]))) for b in s.active]
        if self.t_new is not None:  # a mixed step: the prompts its chunks finish
            rows += [((b,), (int(s._rid[b]), int(s._ngen[b])))
                     for b, cur in s.chunk_mgr.cursors.items()
                     if cur.pos + int(self.t_new[b]) >= cur.n_prompt]
        return rows

    def draw(self, logits, out, args):
        """One token draw of the scheduler: returns the tokens it takes."""
        import torch

        rows = self._committed(logits)
        own = out.cpu().numpy()
        if self.mode == "record":
            self.draws.append(out.clone())
            forced = out
        elif self.mode == "steps":
            check(self.n_draw < len(self.ref.draws), "forced run: more draws than recorded")
            forced = self.ref.draws[self.n_draw].clone()
        else:
            f = own.copy()
            for idx, key in rows:
                f[idx] = self.ref.tokens[key]
            forced = torch.from_numpy(f).to(out.device)
        self.n_draw += 1
        fh = forced.cpu().numpy()
        if logits.dim() == 3:  # a lane counts when every draft before it was taken
            win = self.window.cpu().numpy()
            rows = [(idx, key) for idx, key in rows
                    if all(fh[idx[0], i] == win[idx[0], i + 1] for i in range(idx[1]))]
        for idx, key in rows:
            row = logits[idx].float()
            if self.mode == "record":
                self.rows.setdefault(key, []).append(row.clone())
                self.tokens[key] = int(fh[idx])
                continue
            n = self.seen.get(key, 0)
            self.seen[key] = n + 1
            refs = self.ref.rows[key]
            ref = refs[min(n, len(refs) - 1)]
            dl = float((row - ref).abs().amax())
            tainted = self.taint is not None and bool(self.taint[idx[0]])
            differs = int(own[idx]) != int(fh[idx])
            gap, temp = float("nan"), 1.0
            if differs:
                scores, temp = _deciding_scores(ref, args, idx)
                top2 = scores.topk(2).values
                gap = float(top2[0] - top2[1])
            self.row_stats.append((dl / temp, tainted, differs, gap))
        return forced

    def summary(self, tag):
        """Prints the comparison with ``ref``; returns (the first MoE
        layer's max |dprob|, max |dlogit| of rows whose slot routed alike,
        median |dlogit| of all rows)."""
        import statistics as st

        import torch

        dl = [r[0] for r in self.row_stats]
        check(dl, f"{tag}: no committed row was compared")
        med = st.median(dl)
        picks = [r for r in self.row_stats if r[2]]
        if self.mode == "keys":
            print(f"[{tag}] {len(dl)} committed rows forced to the contiguous pool's tokens: "
                  f"|dlogit| median {med:.6f}, max {max(dl):.6f} (median bound "
                  f"{CROSS_DLOGIT_MEDIAN_BOUND}) | own picks that differ {len(picks)}", flush=True)
            return float("nan"), max(dl), med
        check(self.n_draw == len(self.ref.draws) and self.fwd + 1 == len(self.ref.routing),
              f"{tag}: {self.n_draw} draws, {self.fwd + 1} forwards; recorded "
              f"{len(self.ref.draws)}, {len(self.ref.routing)}")
        clean = [r[0] for r in self.row_stats if not r[1]]
        dmax = max(clean) if clean else 0.0
        untainted = [r for r in picks if not r[1]]
        if not self.first_dprob:  # a dense model: nothing routed, every row counts
            print(f"[{tag}] {self.fwd + 1} forwards and {self.n_draw} draws as the plain run's "
                  f"| rows {len(dl)}: max|dlogit| {dmax:.6f}, median {med:.6f} | kernel picks "
                  f"that differ {len(picks)}"
                  + (f", at a deciding gap <= {max(r[3] for r in picks):.6f}, "
                     f"{sum(r[3] < FIXED_TIE for r in picks)} below {FIXED_TIE}"
                     if picks else ""), flush=True)
            return 0.0, dmax, med
        first = float(torch.stack(self.first_dprob).max())
        fd = torch.cat([f[0] for f in self.flips]).cpu()
        fg = torch.cat([f[1] for f in self.flips]).cpu()
        ft = torch.cat([f[2] for f in self.flips]).cpu()
        print(f"[{tag}] {self.fwd + 1} forwards and {self.n_draw} draws as the plain run's | "
              f"first MoE layer max|dprob| {first:.6f} (bound {FORCED_DPROB_BOUND}) | lanes "
              f"first routed otherwise {fd.numel()} ({int(ft.sum())} by top-k, the rest by a "
              f"drop): there max|dprob| {float(fd.max()) if fd.numel() else 0.0:.6f}, plain "
              f"k-th/(k+1)-th gap max {float(fg[ft].max()) if ft.any() else 0.0:.6f}, "
              f"{int((fg[ft] < FIXED_TIE).sum())} below {FIXED_TIE} | rows {len(dl)}, "
              f"{len(dl) - len(clean)} in a forward that routed their slot otherwise; max|dlogit| "
              f"of the rest {dmax:.6f} (bound {FORCED_DLOGIT_BOUND}), median of all {med:.6f} | "
              f"kernel picks that differ {len(picks)}: {len(picks) - len(untainted)} after a "
              f"routing difference, {len(untainted)} at a deciding gap "
              + (f"<= {max(r[3] for r in untainted):.6f}, "
                 f"{sum(r[3] < FIXED_TIE for r in untainted)} below {FIXED_TIE}"
                 if untainted else "(none)"), flush=True)
        return first, dmax, med


@contextlib.contextmanager
def forcing(rec):
    """Installs ``rec``'s hooks for the served runs within: the scheduler's
    token draws (``sampling.greedy``/``sample_slots``/``sample_window``,
    through the scheduler module's own name, and LayerSkip's
    ``draft_window``, which a TP rank's ``tp_draft_window`` calls too), the
    engine's four forwards (their live lanes and rows), the
    scheduler (to read the slots of the pool that steps or admits: a
    router's replicas take turns) and ``moe.moe_ffn`` (each layer's routing,
    recomputed from its input)."""
    import torch

    from repro_torch.core import engine, layerskip, router as router_mod, sampling
    from repro_torch.core import scheduler as sched_mod
    from repro_torch.launch import serve
    from repro_torch.models import moe as M

    class Proxy:
        def __init__(self, mod, **over):
            self._mod, self._over = mod, over

        def __getattr__(self, name):
            return self._over[name] if name in self._over else getattr(self._mod, name)

    def drawn(fn):
        return lambda logits, *args: rec.draw(logits, fn(logits, *args), args)

    real_draft = layerskip.draft_window

    def draft(*a, **kw):  # the module's own name: a TP rank's draft calls it too
        return rec.draft(*real_draft(*a, **kw))

    def arange_lanes(tokens, n):
        lanes = torch.arange(tokens.shape[1], device=tokens.device)[None]
        return lanes < torch.as_tensor(n, device=tokens.device).reshape(-1, 1)

    def decode_lanes(token):
        lanes = torch.zeros(token.shape[0], dtype=torch.bool, device=token.device)
        lanes[sorted(rec.sched.active)] = True
        return lanes

    lanes_of = {
        "prefill": lambda a: (arange_lanes(a[2], a[3]), a[2].shape[0], None),
        "decode_step": lambda a: (decode_lanes(a[3]), a[3].shape[0], None),
        "mixed_step": lambda a: (arange_lanes(a[3], a[4]), a[3].shape[0], a[4].cpu().numpy()),
        "verify_step": lambda a: (arange_lanes(a[3], a[4]), a[3].shape[0], None),
    }

    def forward(real, name):
        def hooked(*a, **kw):
            rec.begin(*lanes_of[name](a))
            try:
                return real(*a, **kw)
            finally:
                rec.end()
        return hooked

    real_moe = M.moe_ffn

    def moe_spy(cfg, p, x, impl="auto", tp=None, ep=None):
        out = real_moe(cfg, p, x, impl, tp, ep)
        if rec.lanes is not None:
            n = x.shape[0] * x.shape[1]
            probs, _, ids = M.route(cfg, p, x.reshape(n, -1))
            pos = M.position_in_expert(ids.reshape(-1), cfg.moe.n_experts, cfg.moe.dispatch_rank)
            kept = (pos < M.expert_capacity(n, cfg)).reshape(ids.shape)
            none = torch.zeros_like(probs, dtype=torch.bool)
            rec.route(probs, none.scatter(1, ids, True), none.scatter(1, ids, kept))
        return out

    real_sched = serve.Scheduler

    class Seen(real_sched):  # ``rec.sched``: the pool whose draws come (a router's replica)
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            rec.sched = self

        def step_begin(self):
            rec.sched = self
            return super().step_begin()

        def step_finish(self, pending):
            rec.sched = self
            return super().step_finish(pending)

        def _admit_one(self, req, now):
            rec.sched = self
            rec.admitting = req.rid
            try:
                return super()._admit_one(req, now)
            finally:
                rec.admitting = None

    saved = [(sched_mod, "sampling"), (layerskip, "draft_window"), (M, "moe_ffn"),
             (serve, "Scheduler"), (router_mod, "Scheduler")] + [(engine, n) for n in lanes_of]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    sched_mod.sampling = Proxy(sampling, **{n: drawn(getattr(sampling, n)) for n in
                                            ("greedy", "sample_slots", "sample_window")})
    layerskip.draft_window = draft
    M.moe_ffn = moe_spy
    serve.Scheduler = router_mod.Scheduler = Seen
    for name in lanes_of:
        setattr(engine, name, forward(getattr(engine, name), name))
    try:
        yield rec
    finally:
        for mod, name, val in saved:
            setattr(mod, name, val)


@contextlib.contextmanager
def one_key_short(module, name, at):
    """The control: ``module.name``, a decode kernel's wrapper, run with
    each row's length (argument ``at``) one short, so the newest key is
    left out: the off-by-one of a wrong kernel."""
    import torch

    real = getattr(module, name)

    def short(*a, **kw):
        a = list(a)
        a[at] = torch.clamp(a[at] - 1, min=1).to(a[at].dtype)
        return real(*a, **kw)

    setattr(module, name, short)
    try:
        yield
    finally:
        setattr(module, name, real)


def moe_step_profile(tag, cfg, model, params, pad_to):
    """One decode step of 8 slots (the pool's decode program: the model's
    forward in decode mode, the cache at pad_to tokens) profiled as
    ``step_profile``; then the experts' three batched products of one MoE
    layer at the step's capacity (every expert's weights read), timed by
    CUDA events, against the prediction: their weight bytes over the card's
    memory rate. Prints ``max_memory_allocated``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import engine
    from repro_torch.models import moe as M

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab_size, (SLOTS, pad_to), generator=gen, device=dev,
                         dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    _, cache = engine.prefill(model, params, toks,
                              torch.full((SLOTS,), pad_to, dtype=torch.int32, device=dev),
                              pad_to + 16)
    state = {"cache": cache, "tok": toks[:, -1].contiguous()}

    def step():
        logits, state["cache"] = engine.decode_step(model, params, state["cache"],
                                                    state["tok"])
        state["cache"]["lengths"].fill_(pad_to)  # every step at the same length
        state["tok"] = logits.argmax(-1).to(torch.int32)

    with torch.inference_mode():
        step_profile(f"{tag} decode step", step)
    m = cfg.moe
    layer = next(lp["moe"] for lp in params["layers"] if "moe" in lp)
    cap = M.expert_capacity(SLOTS, cfg)
    xe = torch.randn((m.n_experts, cap, cfg.d_model), generator=gen, device=dev).to(
        layer["w1"].dtype)

    def experts():
        h = F.silu(torch.bmm(xe, layer["w1"])) * torch.bmm(xe, layer["w3"])
        return torch.bmm(h, layer["w2"])

    ms = cuda_ms(experts)
    n_moe = sum("moe" in lp for lp in params["layers"])
    w_bytes = 3 * m.n_experts * cfg.d_model * m.d_ff_expert * layer["w1"].element_size()
    predicted = w_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[{tag} decode step] experts' bmm at capacity {cap}: {ms:.4f} ms a MoE layer, "
          f"{ms * n_moe:.4f} ms a step ({n_moe} MoE layers) | predicted >= {predicted:.4f} ms "
          f"a layer ({w_bytes} B of expert weights at 3.35 TB/s) | max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B", flush=True)
    del cache, state


def _geometry(m):
    """A run's host counts: equal in two runs of one pool that took the same
    tokens."""
    return {k: m.get(k, 0) for k in ("prefills", "decode_steps", "mixed_steps", "spec_steps",
                                     "n_preemptions")}


def phase_moe(arch, pad_to):
    """Full-width ``arch`` (MOE_LAYERS' depth cut, bf16, seeded weights)
    serves the 16 requests through MOE_ARMS: contiguous, paged, paged +
    chunked and speculative at t = 0.8. Each arm runs on the kernels (exact
    launches, no leaked block, finite logits), on the plain path (no
    launch), recorded, and on the kernels again, teacher-forced to the plain
    run's draws (``Forced`` "steps": the same steps on the same pool), held
    within FORCED_DPROB_BOUND and FORCED_DLOGIT_BOUND. In the contiguous arm
    the same forced run with the decode kernel one key short
    (``one_key_short``) must break a bound. Then the pools under dropless
    capacity (``dropless_pools``) and one decode step profiled. Returns
    (config, {arm: (metrics, launch counts)}) and, for deepseek, the MLA
    kernels' records."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.kv_cache import leaves
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import serve

    tag = "mla" if arch.startswith("deepseek") else "moe"
    dev = torch.device("cuda")
    full = get_config(arch)
    t0 = time.perf_counter()
    cfg, model, params = serve.build_model(arch, smoke=False, seed=SEED, device=dev,
                                           n_layers=MOE_LAYERS[arch])
    check(cfg.dtype == "bfloat16" and cfg.d_model == full.d_model and cfg.moe == full.moe
          and cfg.mla == full.mla, f"unexpected config {cfg}")
    n_el = sum(p.numel() for p in leaves(params))
    n_bytes = sum(p.numel() * p.element_size() for p in leaves(params))
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} of {full.n_layers} layers (depth cut), d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.moe.n_experts} experts "
          f"top-{cfg.moe.top_k} of {cfg.moe.d_ff_expert} + {cfg.moe.n_shared_experts} shared, "
          f"first dense {cfg.moe.first_dense_layers}, vocab {cfg.vocab_size}"
          + (f", MLA q_lora {cfg.mla.q_lora_rank} kv_lora {cfg.mla.kv_lora_rank} rope "
             f"{cfg.mla.qk_rope_dim}" if cfg.mla else ", qk-norm")
          + f" | params {n_el / 1e9:.3f}G elements, {n_bytes} B | init "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    out = {}
    for arm, (temp, top_p, spec, geometry) in MOE_ARMS.items():
        t_arm = time.perf_counter()
        kw = dict(policy="continuous", int8_mode=None, temperature=temp, top_p=top_p,
                  speculative=spec, spec_exit=MOE_SPEC_EXIT, **geometry)
        serve.warmup(model, params, slots=SLOTS, pad_to=pad_to, max_new_cap=MAX_NEW,
                     device=dev, speculative=spec, exit_layer=MOE_SPEC_EXIT,
                     n_draft=SPEC_DRAFT, **geometry)
        m, toks, counts = serve_once(model, params, cfg, pad_to, tag=f"{tag}/{arm}", **kw)
        plain = Forced("record")
        with plain_path(), forcing(plain):
            mp, ptoks, _ = serve_once(model, params, cfg, pad_to, tag=f"{tag}/{arm} plain",
                                      **kw)
        if geometry:
            print(f"[{tag}/{arm}] preemptions {m['n_preemptions']} | mixed steps "
                  f"{m.get('mixed_steps', 0)} | peak used blocks {m['peak_used_blocks']}",
                  flush=True)
        if spec:
            check(m["spec_steps"] >= 1, f"{tag}/{arm}: no speculative step")
        print(f"[{tag}/{arm}] {sum(toks[r] == ptoks[r] for r in ptoks)} of {len(ptoks)} "
              f"requests served the plain path's tokens exactly", flush=True)
        runs = {"forced": None, "control": None} if arm == "contiguous" else {"forced": None}
        for run in runs:
            rec = Forced("steps", plain)
            with forcing(rec), (one_key_short(da, "decode_attention_cuda", 3)
                                if run == "control" else contextlib.nullcontext()):
                mf, ftoks, _ = serve_once(model, params, cfg, pad_to, tag=f"{tag}/{arm} {run}",
                                          **kw)
            check(ftoks == ptoks and _geometry(mf) == _geometry(mp),
                  f"{tag}/{arm} {run}: tokens or steps differ from the plain run's "
                  f"({_geometry(mf)} vs {_geometry(mp)})")
            runs[run] = rec.summary(f"{tag}/{arm} {run}")[:2]
        first, dlogit = runs["forced"]
        check(first <= FORCED_DPROB_BOUND and dlogit <= FORCED_DLOGIT_BOUND,
              f"{tag}/{arm}: the kernel path left the plain path's bounds (max|dprob| {first}, "
              f"max|dlogit| {dlogit})")
        if "control" in runs:
            first, dlogit = runs["control"]
            check(first > FORCED_DPROB_BOUND or dlogit > FORCED_DLOGIT_BOUND,
                  f"{tag}/{arm} control: a decode kernel one key short stayed within the bounds")
        print(f"[{tag}/{arm}] arm {time.perf_counter() - t_arm:.1f} s", flush=True)
        out[arm] = (m, counts)
        del plain, rec
    dropless_pools(tag, cfg, params, pad_to)
    moe_step_profile(tag, cfg, model, params, pad_to)
    records = []
    if cfg.mla is not None:
        await_quiet(tag)  # the records are timed with the card to itself
        records = mla_kernel_records(cfg, out, pad_to) + mla_extend(cfg, params, pad_to)
    del model, params
    torch.cuda.empty_cache()
    return cfg, out, records


def dropless_pools(tag, cfg, params, pad_to):
    """The pools under dropless capacity (capacity_factor = E / k: no
    assignment dropped, so a token's experts do not depend on what shares
    its step) on the kernels. The contiguous pool serves the trace greedy
    and at t = 0.8, recorded; paged and paged + chunked (greedy) and
    speculative (t = 0.8, every request drafting) are each forced to its
    tokens by (request, index) (``Forced`` "keys"), their committed rows
    held against the contiguous pool's: the median |dlogit| within
    CROSS_DLOGIT_MEDIAN_BOUND. The paged pool with its decode kernel one key
    short must break it."""
    import dataclasses

    import torch

    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.models import get_model

    t0 = time.perf_counter()
    m = cfg.moe
    dcfg = cfg.replace(moe=dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k))
    model = get_model(dcfg)
    refs = {}
    for temp, top_p in ((0.0, 1.0), (SPEC_TEMP, SPEC_TOP_P)):
        refs[temp] = Forced("record")
        with forcing(refs[temp]):
            serve_once(model, params, dcfg, pad_to, policy="continuous", int8_mode=None,
                       tag=f"{tag} dropless/contiguous t={temp}", temperature=temp, top_p=top_p)
    for arm in ("paged", "chunked", "spec t=0.8", "paged control"):
        temp, top_p, spec, geometry = MOE_ARMS[arm.split()[0] if "control" in arm else arm]
        rec = Forced("keys", refs[temp])
        with forcing(rec), (one_key_short(pda, "paged_decode_attention_cuda", 4)
                            if "control" in arm else contextlib.nullcontext()):
            serve_once(model, params, dcfg, pad_to, policy="continuous", int8_mode=None,
                       tag=f"{tag} dropless/{arm}", temperature=temp, top_p=top_p,
                       speculative=spec, spec_exit=MOE_SPEC_EXIT, **geometry)
        med = rec.summary(f"{tag} dropless/{arm}")[2]
        if "control" in arm:
            check(med > CROSS_DLOGIT_MEDIAN_BOUND,
                  f"{tag} dropless/{arm}: a paged decode kernel one key short stayed within "
                  "the bound")
        else:
            check(med <= CROSS_DLOGIT_MEDIAN_BOUND,
                  f"{tag} dropless/{arm}: median |dlogit| {med} against the contiguous pool")
    del refs, rec
    torch.cuda.empty_cache()
    print(f"[{tag} dropless] {time.perf_counter() - t0:.1f} s", flush=True)


def mla_kernel_records(cfg, arms, pad_to):
    """The MLA kernel shapes at deepseek-v2's full width against their plain
    versions in bf16 (atol/rtol 2e-2), a repeat call bit-identical, timed
    beside their bound and SDPA on the same rows: flash at the prefill (D =
    192, Dv = 128, 128 heads, causal over pad_to), flash over the latent at
    the chunked arm's mixed step (8 slots x 64 lanes, 336 gathered keys,
    MIXED_T_NEW) and at the speculative arm's verify step (8 slots x 5
    lanes over the contiguous cache's 321 rows, VERIFY_LENGTHS /
    VERIFY_T_NEW), the latent decode over the contiguous cache
    (VERIFY_LENGTHS + 1 keys) and the paged latent decode over the paged
    arm's pool (48 blocks of 16, 21-block tables). Launches: each shape's
    count in its arm's run."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    ml = cfg.mla
    h, r, d = cfg.n_heads, ml.kv_lora_rank, ml.kv_lora_rank + ml.qk_rope_dim
    dq = ml.qk_nope_dim + ml.qk_rope_dim
    scale = dq ** -0.5
    s_ctg = pad_to + MAX_NEW + 1
    bs, nb = PAGED_ARMS["paged"]["block_size"], PAGED_ARMS["paged"]["num_blocks"]
    mb = -(-s_ctg // bs)
    n_layers = cfg.n_layers

    def ipos(b, t, start=None):
        base = torch.arange(t, device=dev, dtype=torch.int32)[None].expand(b, t)
        return (base + start[:, None]).contiguous() if start is not None else base.contiguous()

    def allowed(qpos, kpos, k_valid):  # [B, Tq, Tk]: causal and valid
        return (kpos[:, None, :] <= qpos[:, :, None]) & k_valid[:, None, :]

    recs = []

    def record(label, shape_txt, call, plain, lib, err, n_bytes, flops, launches, **extra):
        check(torch.equal(call(), call()), f"{label}: a repeat call differs")
        recs.append(dict(name=extra.pop("name"), route="cuda", source=extra.pop("source"),
                         replaces=extra.pop("replaces"), shape=shape_txt, max_abs_err=err,
                         call=call, ms=cuda_ms(call), plain_ms=cuda_ms(plain), library=lib,
                         bytes=n_bytes, flops=flops, launches=launches, **extra))

    flash_src = dict(name="flash_attention",
                     source="src/repro_torch/kernels/csrc/flash_attention.cu",
                     replaces="src/repro/kernels/flash_attention.py:88")
    # prefill: D = 192 against Dv = 128, one (expanded) KV head a q head
    q = _rand(gen, (1, pad_to, h, dq), bf, dev)
    k = _rand(gen, (1, pad_to, h, dq), bf, dev)
    v = _rand(gen, (1, pad_to, h, ml.v_head_dim), bf, dev)
    pos = ipos(1, pad_to)
    kw = dict(q_positions=pos, k_positions=pos, causal=True, scale=scale)
    err = max_err(fa.flash_attention_cuda(q, k, v, **kw),
                  fa.flash_attention_plain(q, k, v, **kw), "bfloat16")
    pairs = pad_to * (pad_to + 1) // 2
    m_c = arms["contiguous"][0]
    record("flash 192/128", f"q/k[1,{pad_to},{h},{dq}] v[1,{pad_to},{h},{ml.v_head_dim}] bf16 "
           "causal (deepseek-v2 MLA prefill, D 192 / Dv 128)",
           lambda: fa.flash_attention_cuda(q, k, v, **kw),
           lambda: fa.flash_attention_plain(q, k, v, **kw),
           lambda qt=q.transpose(1, 2), kt=k.transpose(1, 2), vt=v.transpose(1, 2):
           F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale),
           err, (q.numel() + k.numel() + 2 * v.numel()) * 2 + 2 * pos.numel() * 4,
           pairs * h * 2 * (dq + ml.v_head_dim), n_layers * m_c["prefills"], **flash_src)

    def latent_flash(label, b, tq, tk, lengths, t_new, launches, what):
        qx = _rand(gen, (b, tq, h, d), bf, dev)
        lat = _rand(gen, (b, tk, 1, d), bf, dev)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        tn = torch.tensor(t_new, dtype=torch.int32, device=dev)
        qpos = ipos(b, tq, ln)
        kpos = ipos(b, tk)
        kval = (kpos < (ln + tn)[:, None]).contiguous()
        kwx = dict(q_positions=qpos, k_positions=kpos, causal=True, k_valid=kval, scale=scale)
        got = fa.flash_attention_cuda(qx, lat, lat[..., :r], **kwx)
        want = fa.flash_attention_plain(qx, lat, lat[..., :r], **kwx)
        # live lanes only: a padding lane's row is discarded by the model
        live = (torch.arange(tq, device=dev)[None] < tn[:, None])
        e = max_err(got[live], want[live], "bfloat16")
        ok = allowed(qpos, kpos, kval) & live[:, :, None]
        n_pairs = int(ok.sum())
        keys = int(kval.sum())
        mask = ok[:, None]
        kexp = lat[:, :, 0][:, None].expand(b, h, tk, d)
        record(label, f"q[{b},{tq},{h},{d}] latent[{b},{tk},1,{d}] v = latent[..., :{r}] bf16 "
               f"lengths {lengths} t_new {t_new} ({what})",
               lambda: fa.flash_attention_cuda(qx, lat, lat[..., :r], **kwx),
               lambda: fa.flash_attention_plain(qx, lat, lat[..., :r], **kwx),
               lambda qt=qx.transpose(1, 2), ke=kexp, m=mask:
               F.scaled_dot_product_attention(qt, ke, ke[..., :r], attn_mask=m, scale=scale),
               e, (qx.numel() + keys * d + int(live.sum()) * h * r) * 2
               + (qpos.numel() + kpos.numel()) * 4 + kval.numel(),
               n_pairs * h * 2 * (d + r),
               launches, **flash_src)

    m_ch = arms["chunked"][0]
    latent_flash("flash latent mixed", SLOTS, MIXED_LANES, mb * bs,
                 [0, 40, 64, 128, 0, 200, 192, 255], MIXED_T_NEW,
                 n_layers * m_ch.get("mixed_steps", 0), "deepseek-v2 paged mixed step, "
                 "absorbed latent")
    m_s = arms["spec t=0.8"][0]
    latent_flash("flash latent verify", SLOTS, SPEC_DRAFT + 1, s_ctg, VERIFY_LENGTHS,
                 VERIFY_T_NEW, n_layers * m_s.get("spec_steps", 0),
                 "deepseek-v2 verify step, absorbed latent")

    # the latent decode, contiguous and paged
    dsrc = dict(name="decode_attention",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:80")
    qd = _rand(gen, (SLOTS, h, d), bf, dev)
    lat = _rand(gen, (SLOTS, s_ctg, 1, d), bf, dev)
    ln = torch.tensor([n + 1 for n in VERIFY_LENGTHS], dtype=torch.int32, device=dev)
    err = max_err(da.decode_attention_cuda(qd, lat, lat[..., :r], ln, scale=scale),
                  da.decode_attention_plain(qd, lat, lat[..., :r], ln, scale=scale), "bfloat16")
    amask = (torch.arange(s_ctg, device=dev)[None] < ln[:, None])[:, None, None, :]
    kexp = lat[:, :, 0][:, None].expand(SLOTS, h, s_ctg, d)
    n_rows = int(ln.sum())
    record("decode latent", f"q[{SLOTS},{h},{d}] latent[{SLOTS},{s_ctg},1,{d}] v = "
           f"latent[..., :{r}] bf16 lengths {ln.tolist()} (deepseek-v2 decode, absorbed latent, "
           f"G = {h})",
           lambda: da.decode_attention_cuda(qd, lat, lat[..., :r], ln, scale=scale),
           lambda: da.decode_attention_plain(qd, lat, lat[..., :r], ln, scale=scale),
           lambda qq=qd[:, :, None], ke=kexp, m=amask:
           F.scaled_dot_product_attention(qq, ke, ke[..., :r], attn_mask=m, scale=scale),
           err, (qd.numel() + n_rows * d + SLOTS * h * r) * 2 + SLOTS * 4,
           n_rows * h * 2 * (d + r), arms["contiguous"][1]["decode_attention"], **dsrc)
    pool = _rand(gen, (nb, bs, d), bf, dev)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(SEED))[: 2 * mb] + 1
    bt = torch.stack([perm[(i % 2) * mb:(i % 2 + 1) * mb] for i in range(SLOTS)]).to(
        torch.int32).to(dev).contiguous()
    nv = ln.clamp(max=mb * bs)
    err = max_err(pda.paged_decode_attention_cuda(qd, pool, None, bt, nv, scale=scale, v_dim=r),
                  pda.paged_decode_attention_plain(qd, pool, None, bt, nv, scale=scale,
                                                   v_dim=r), "bfloat16")
    gathered = pool[bt.long()].reshape(SLOTS, mb * bs, 1, d)
    check(torch.equal(pda.paged_decode_attention_cuda(qd, pool, None, bt, nv, scale=scale,
                                                      v_dim=r),
                      da.decode_attention_cuda(qd, gathered, gathered[..., :r], nv,
                                               scale=scale)),
          "paged latent decode: differs from the contiguous kernel on the gathered rows")
    n_rows = int(nv.sum())
    record("paged decode latent", f"q[{SLOTS},{h},{d}] pool[{nb},{bs},{d}] bt[{SLOTS},{mb}] "
           f"v = pool[..., :{r}] bf16 n_valid {nv.tolist()} (deepseek-v2 paged decode, "
           "absorbed latent)",
           lambda: pda.paged_decode_attention_cuda(qd, pool, None, bt, nv, scale=scale, v_dim=r),
           lambda: pda.paged_decode_attention_plain(qd, pool, None, bt, nv, scale=scale,
                                                    v_dim=r),
           None, err, (qd.numel() + n_rows * d + SLOTS * h * r) * 2 + bt.numel() * 4
           + SLOTS * 4, n_rows * h * 2 * (d + r), arms["paged"][1]["paged_decode_attention"],
           name="paged_decode_attention",
           source="src/repro_torch/kernels/csrc/decode_attention.cu",
           replaces="src/repro/models/attention.py:177",
           contiguous_ms=cuda_ms(lambda: da.decode_attention_cuda(
               qd, gathered, gathered[..., :r], nv, scale=scale)),
           contiguous_device_ms=device_ms(lambda: da.decode_attention_cuda(
               qd, gathered, gathered[..., :r], nv, scale=scale)))
    torch.cuda.synchronize()
    finish_records(recs)
    for rec in recs:
        check(rec["launches"] > 0, f"{rec['name']} {rec['shape']}: not launched on its arm")
    return recs


# --------------------------------------------------------------------------
# the dense configs and the characterization
# --------------------------------------------------------------------------

#: the dense phase's models in serving order, each (arch, layers run: None
#: all of them): yi-34b last, its weights kept for the characterize phase's
#: T-T windows
DENSE_MODELS = (("qwen2.5-3b", None), ("llama3-405b", 4), ("yi-34b", None))
#: its trace (``llama_humaneval``, prompts padded to 256) and output cap
DENSE_REQUESTS, DENSE_MAX_NEW = 8, 16
DENSE_ARMS = {"contiguous": {},
              "chunked": dict(paged=True, chunked=True, block_size=16, prefill_budget=64)}
#: the dense phase's teacher-forced check, per model: max |dlogit| of the
#: kernel path's committed rows against the plain run's, forced to the plain
#: run's tokens (bf16; no routing, so every row counts). Each is set between
#: the model's sound runs (both arms) and its contiguous arm with the decode
#: kernel one key short (``one_key_short``), which must break it (NVIDIA H100
#: 80GB HBM3, 700 W; the readings repeat to the bit): sound at most 0.094,
#: 0.047 and 0.141, one key short 0.164, 0.250 and 0.461
DENSE_DLOGIT_BOUND = {"qwen2.5-3b": 0.125, "llama3-405b": 0.125, "yi-34b": 0.25}
#: the qwen2.5-3b biases' scale: its init makes them zero, which checks nothing
QKV_BIAS_SCALE = 0.5


def dense_trace(cfg, pad_to):
    return _trace(cfg, pad_to, n=DENSE_REQUESTS, max_new=DENSE_MAX_NEW)


def phase_dense(pad_to):
    """qwen2.5-3b (36 layers, its q/k/v biases redrawn N(0, 0.5^2)),
    llama3-405b (4 of 126 layers) and yi-34b (60 layers) at full width,
    bf16, seeded weights, each serving ``DENSE_REQUESTS`` requests through
    the contiguous pool and the paged + chunked one: per arm a kernel run
    (exact launches, finite logits, no leaked block or refcount), a plain
    run recorded, its tokens against the kernel run's under the near-tie
    rule, and a kernel run forced to the plain run's draws (the same steps,
    max |dlogit| of its rows within the model's DENSE_DLOGIT_BOUND); the
    contiguous arm once more with the decode kernel one key short, which
    must break that bound. Each model
    is freed before the next. Returns ({arch: {arm: launch counts}},
    [yi-34b's (config, model, params)]: a list the characterize phase
    empties, so that nothing else holds the weights)."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.kv_cache import leaves
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import serve

    dev = torch.device("cuda")
    counts, kept = {}, None
    for arch, layers in DENSE_MODELS:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg, model, params = serve.build_model(arch, smoke=False, seed=SEED, device=dev,
                                               n_layers=layers)
        check(cfg == full.replace(n_layers=cfg.n_layers) and cfg.dtype == "bfloat16",
              f"unexpected config {cfg}")
        if cfg.qkv_bias:
            gen = torch.Generator(device=dev).manual_seed(SEED + 24)
            with torch.inference_mode():
                for lp in params["layers"]:
                    for name in ("wq", "wk", "wv"):
                        b = lp["attn"][name]["b"]
                        b.copy_((QKV_BIAS_SCALE * torch.randn(b.shape, generator=gen,
                                                              device=dev)).to(b.dtype))
        n_el = sum(p.numel() for p in leaves(params))
        n_bytes = sum(p.numel() * p.element_size() for p in leaves(params))
        check(n_el == cfg.n_params() + cfg.d_model,  # the count leaves out the final norm
              f"{arch}: {n_el} parameters, the config counts {cfg.n_params()}")
        print(f"[dense] {arch}: {cfg.n_layers} of {full.n_layers} layers"
              + (" (depth cut)" if cfg.n_layers < full.n_layers else "")
              + f", d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim} "
              f"(G = {cfg.q_per_kv}, G*D = {cfg.q_per_kv * cfg.head_dim}), d_ff {cfg.d_ff}, "
              f"vocab {cfg.vocab_size}"
              + (f", q/k/v bias N(0, {QKV_BIAS_SCALE}^2)" if cfg.qkv_bias else "")
              + f" | params {n_el / 1e9:.3f}G elements, {n_bytes} B | init "
              f"{time.perf_counter() - t0:.1f}s | device memory free "
              f"{torch.cuda.mem_get_info()[0]} B", flush=True)
        counts[arch] = {}
        for arm, geometry in DENSE_ARMS.items():
            t_arm = time.perf_counter()
            tag = f"dense {arch}/{arm}"
            kw = dict(policy="continuous", int8_mode=None, **geometry)
            serve.warmup(model, params, slots=SLOTS, pad_to=pad_to, max_new_cap=MAX_NEW,
                         device=dev, **geometry)
            _, toks, got = serve_once(model, params, cfg, pad_to, tag=tag,
                                      reqs=dense_trace(cfg, pad_to), **kw)
            plain = Forced("record")
            with plain_path(), forcing(plain):
                mp, ptoks, _ = serve_once(model, params, cfg, pad_to, tag=f"{tag} plain",
                                          reqs=dense_trace(cfg, pad_to), **kw)
            same_tokens(model, params, cfg, pad_to, toks, ptoks, 0.0, 1.0, tag,
                        "the plain path's tokens", reqs=dense_trace(cfg, pad_to))
            runs = ("forced", "control") if arm == "contiguous" else ("forced",)
            dl = {}
            for run in runs:
                rec = Forced("steps", plain)
                with forcing(rec), (one_key_short(da, "decode_attention_cuda", 3)
                                    if run == "control" else contextlib.nullcontext()):
                    mf, ftoks, _ = serve_once(model, params, cfg, pad_to, tag=f"{tag} {run}",
                                              reqs=dense_trace(cfg, pad_to), **kw)
                check(ftoks == ptoks and _geometry(mf) == _geometry(mp),
                      f"{tag} {run}: tokens or steps differ from the plain run's")
                dl[run] = rec.summary(f"{tag} {run}")[1]
            bound = DENSE_DLOGIT_BOUND[arch]
            print(f"[{tag}] arm {time.perf_counter() - t_arm:.1f} s | max |dlogit| forced "
                  f"{dl['forced']:.6f}" + (f", control {dl['control']:.6f}" if "control" in dl
                                           else "") + f" (bound {bound})", flush=True)
            check(dl["forced"] <= bound,
                  f"{tag}: max |dlogit| {dl['forced']} against the plain path, bound {bound}")
            if "control" in dl:
                check(dl["control"] > bound,
                      f"{tag} control: a decode kernel one key short stayed within the bound "
                      f"({dl['control']} <= {bound})")
            counts[arch][arm] = got
            del plain, rec
        if arch == DENSE_MODELS[-1][0]:
            kept = [(cfg, model, params)]
        del model, params
    return counts, kept


#: the attention kernels' record fields
FLASH_SRC = dict(name="flash_attention", source="src/repro_torch/kernels/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:88")
DECODE_SRC = dict(name="decode_attention",
                  source="src/repro_torch/kernels/csrc/decode_attention.cu",
                  replaces="src/repro/kernels/decode_attention.py:80")


def int_positions(b, t, dev):
    """Positions 0 .. t - 1 of every row, as the flash kernel reads them."""
    import torch

    return torch.arange(t, device=dev, dtype=torch.int32)[None].expand(b, t).contiguous()


def per_head(x, g):
    """GQA K/V [B, T, Hkv, D] repeated per q head, [B, H, T, D], for SDPA."""
    return x.repeat_interleave(g, dim=2).transpose(1, 2)


def kernel_record(recs, shape_txt, call, plain, lib, err, n_bytes, flops, launches, **src):
    """Append a kernel's record to ``recs`` (a repeat call bit-identical, the
    kernel and its plain version timed by CUDA events); ``finish_records``
    adds the bound and the device and library times. ``src`` holds the
    record's name, source and replaced kernel, and the operations' ``peak``
    rate when it is not the bf16 tensor cores'."""
    import torch

    check(torch.equal(call(), call()), f"{shape_txt}: a repeat call differs")
    recs.append(dict(route="cuda", shape=shape_txt, max_abs_err=err, call=call,
                     ms=cuda_ms(call), plain_ms=cuda_ms(plain), library=lib,
                     bytes=n_bytes, flops=flops, launches=launches, **src))


def dense_kernel_records(pad_to, counts, tt_counts):
    """The dense configs' new kernel shapes against their plain versions in
    bf16, a repeat call bit-identical, timed beside their bound and SDPA:
    flash at G = 7 (yi-34b, 56/8 heads of 128; 9 positions a 64-row block)
    and G = 16 (llama3-405b, 128/8) at Tq 1, 5, 64, 154 and the served
    prefill, causal and under ``k_valid``; the contiguous decode at the
    served pool's rows (lengths at the split edges) and at 4096 rows, and
    the paged decode through the chunked arm's tables (bit for bit the
    contiguous kernel on the gathered rows), at G = 7 and G * D = 2048
    (RMSNorm at d = 7168 and 16384 is in ``rmsnorm_cases``). Records: flash
    at the T-T prefill ([4, 154]; launches from its characterize window,
    ``tt_counts``) and at llama3-405b's served prefill, both decodes;
    launches from the dense arms."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    models = {"yi-34b": get_config("yi-34b"), "llama3-405b": get_config("llama3-405b")}
    s_ctg = pad_to + MAX_NEW + 1  # a contiguous slot's rows
    bs = DENSE_ARMS["chunked"]["block_size"]
    mb = -(-s_ctg // bs)
    nb = SLOTS * mb + 1  # the parity pool and its sink block
    recs, errs = [], {}

    def record(*a, **src):
        kernel_record(recs, *a, **src)
    flash_in = {}
    for arch, cfg in models.items():
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        for b, t in ((1, 1), (2, 5), (2, 64), (4, 154), (1, pad_to)):
            q = _rand(gen, (b, t, hq, dh), bf, dev)
            k, v = (_rand(gen, (b, t, hkv, dh), bf, dev) for _ in range(2))
            pos = int_positions(b, t, dev)
            valid = [t, max(t - 3, 1)][:b] + [t] * (b - 2)
            kval = (pos < torch.tensor(valid, device=dev)[:, None]).contiguous()
            for how, kw in (("causal", dict(q_positions=pos, k_positions=pos, causal=True)),
                            ("k_valid", dict(q_positions=pos, k_positions=pos, causal=True,
                                             k_valid=kval))):
                got = fa.flash_attention_cuda(q, k, v, **kw)
                errs[f"flash G={hq // hkv} [{b},{t}] {how}"] = max_err(
                    got, fa.flash_attention_plain(q, k, v, **kw), "bfloat16")
                check(torch.equal(got, fa.flash_attention_cuda(q, k, v, **kw)),
                      f"flash: a repeat call differs (G = {hq // hkv} [{b}, {t}] {how})")
            flash_in[(arch, b, t)] = (q, k, v, dict(q_positions=pos, k_positions=pos,
                                                         causal=True))
    for (name, b, t), launches in ((("yi-34b", 4, 154), tt_counts["flash_attention"]),
                                   (("llama3-405b", 1, pad_to),
                                    counts["llama3-405b"]["contiguous"]["flash_attention"])):
        q, k, v, kw = flash_in[(name, b, t)]
        g = q.shape[2] // k.shape[2]
        pairs = b * t * (t + 1) // 2
        record(f"q[{b},{t},{q.shape[2]},{q.shape[3]}] kv[{b},{t},{k.shape[2]},{k.shape[3]}] "
               f"bf16 causal ({name} prefill, G = {g}: {64 // g} positions a 64-row block)",
               lambda a=(q, k, v), kw=kw: fa.flash_attention_cuda(*a, **kw),
               lambda a=(q, k, v), kw=kw: fa.flash_attention_plain(*a, **kw),
               lambda qt=q.transpose(1, 2), ke=per_head(k, g), ve=per_head(v, g):
               F.scaled_dot_product_attention(qt, ke, ve, is_causal=True),
               errs[f"flash G={g} [{b},{t}] causal"],
               (2 * q.numel() + 2 * k.numel()) * 2 + 2 * b * t * 4,
               pairs * q.shape[2] * 4 * q.shape[3], launches, **FLASH_SRC)

    # decode over the served pool's rows: lengths at the split edges (1, 63,
    # 64, 65), mid and full; the paged pool through a random permutation
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(SEED))
    bt = (perm[: SLOTS * mb] + 1).reshape(SLOTS, mb).to(torch.int32).to(dev).contiguous()
    for arch, cfg in models.items():
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        g = hq // hkv
        qd = _rand(gen, (SLOTS, hq, dh), bf, dev)
        kc, vc = (_rand(gen, (SLOTS, s_ctg, hkv, dh), bf, dev) for _ in range(2))
        ln = torch.tensor([1, 63, 64, 65, 200, 257, s_ctg - 1, s_ctg], dtype=torch.int32,
                          device=dev)
        errs[f"decode G={g} G*D={g * dh}"] = max_err(da.decode_attention_cuda(qd, kc, vc, ln),
                                                     da.decode_attention_plain(qd, kc, vc, ln),
                                                     "bfloat16")
        kl, vl = (_rand(gen, (2, 4096, hkv, dh), bf, dev) for _ in range(2))
        ll = torch.tensor([4095, 4096], dtype=torch.int32, device=dev)
        errs[f"decode G={g} S=4096"] = max_err(da.decode_attention_cuda(qd[:2], kl, vl, ll),
                                               da.decode_attention_plain(qd[:2], kl, vl, ll),
                                               "bfloat16")
        kp, vp = (_rand(gen, (nb, bs, hkv, dh), bf, dev) for _ in range(2))
        nv = ln.clamp(max=mb * bs)
        got = pda.paged_decode_attention_cuda(qd, kp, vp, bt, nv)
        errs[f"paged decode G={g}"] = max_err(
            got, pda.paged_decode_attention_plain(qd, kp, vp, bt, nv), "bfloat16")
        kg, vg = (x[bt.long()].reshape(SLOTS, mb * bs, hkv, dh) for x in (kp, vp))
        check(torch.equal(got, da.decode_attention_cuda(qd, kg, vg, nv)),
              f"paged decode G = {g}: differs from the contiguous kernel on the gathered rows")
        n_rows = int(ln.sum())
        amask = (torch.arange(s_ctg, device=dev)[None] < ln[:, None])[:, None, None, :]
        c = counts[arch]
        record(f"q[{SLOTS},{hq},{dh}] cache[{SLOTS},{s_ctg},{hkv},{dh}] bf16 lengths "
               f"{ln.tolist()} ({arch} decode, G = {g}, G*D = {g * dh})",
               lambda a=(qd, kc, vc, ln): da.decode_attention_cuda(*a),
               lambda a=(qd, kc, vc, ln): da.decode_attention_plain(*a),
               lambda qq=qd[:, :, None], ke=per_head(kc, g), ve=per_head(vc, g), m=amask:
               F.scaled_dot_product_attention(qq, ke, ve, attn_mask=m),
               errs[f"decode G={g} G*D={g * dh}"],
               (2 * qd.numel() + 2 * n_rows * hkv * dh) * 2 + SLOTS * 4,
               n_rows * hq * 4 * dh, c["contiguous"]["decode_attention"], **DECODE_SRC)
        n_rows = int(nv.sum())
        record(f"q[{SLOTS},{hq},{dh}] pool[{nb},{bs},{hkv},{dh}] bt[{SLOTS},{mb}] bf16 "
               f"n_valid {nv.tolist()} ({arch} paged decode, G = {g})",
               lambda a=(qd, kp, vp, bt, nv): pda.paged_decode_attention_cuda(*a),
               lambda a=(qd, kp, vp, bt, nv): pda.paged_decode_attention_plain(*a),
               None, errs[f"paged decode G={g}"],
               (2 * qd.numel() + 2 * n_rows * hkv * dh) * 2 + bt.numel() * 4 + SLOTS * 4,
               n_rows * hq * 4 * dh, c["chunked"]["paged_decode_attention"],
               name="paged_decode_attention",
               source="src/repro_torch/kernels/csrc/decode_attention.cu",
               replaces="src/repro/models/attention.py:177",
               contiguous_ms=cuda_ms(lambda a=(qd, kg, vg, nv): da.decode_attention_cuda(*a)),
               contiguous_device_ms=device_ms(
                   lambda a=(qd, kg, vg, nv): da.decode_attention_cuda(*a)))

    torch.cuda.synchronize()
    for case, e in errs.items():
        print(f"[kernels] dense {case:36s} max|err| {e:.3e}", flush=True)
    finish_records(recs)
    for rec in recs:
        check(rec["launches"] > 0, f"{rec['name']} {rec['shape']}: not launched on its path")
    return recs


def _as_events(kern):
    """Profiler-event stand-ins (name, time_range) for ``note_short_session``."""
    from types import SimpleNamespace

    return [SimpleNamespace(name=k.name, time_range=SimpleNamespace(start=k.start_us,
                                                                    end=k.end_us))
            for k in kern]


def characterize_window(wl, ph, cfg, model, params):
    """One (workload, phase) window of ``op_breakdown.measure``: warmed up,
    its unprofiled wall, then one call profiled (host and card, input
    shapes) with every launch counter set to 0 just before it and read just
    after; a session short of the ported kernels is recorded and taken once
    more. Checks: ``op_breakdown.problems`` finds none (every kernel in one
    class, every kernel that its name does not place linked to its aten op,
    classes plus idle equal to the window within ``RESIDUAL_BOUND``, the
    flash, decode, HSTU and RMSNorm kernels each in its class as many times
    as their wrappers launched), at least one ported attention kernel among
    them. Prints the measured and the analytic breakdown; returns the
    result and the launch counts."""
    import torch

    from repro_torch.launch import op_breakdown as ob

    tag = f"characterize {wl} {ph}"
    res = ob.measure(wl, ph, cfg, model, params, torch.device("cuda"), SEED,
                     session=lambda: profiler(cpu=True, shapes=True), reset=_reset_counts,
                     read=_read_counts)
    counts, ported = res["launched"], res["ported"]
    check(len(res["short"]) <= 1, f"{tag}: two profiler sessions short of the ported kernels")
    if res["short"]:
        note_short_session(tag, _as_events(res["short"][0]), _as_events(res["kernels"]),
                           sum(p["launched"] for p in ported.values()))
    wrong = ob.problems(res)
    check(not wrong, f"{tag}: " + "; ".join(wrong))
    check(sum(ported[k]["launched"] for k in ("flash", "decode", "hstu")) > 0,
          f"{tag}: no ported attention kernel launched")
    cls, ana, wall = res["classes"], res["analytic"], res["wall_ms"]
    busy = res["busy_ms"]
    print(f"[{tag}] {cfg.name} ({cfg.n_layers} layers), {res['shape']} | window "
          f"{res['window_ms']:.3f} ms profiled, wall {wall:.3f} ms unprofiled | " + " | ".join(
              f"{c} {cls[c]['ms']:.3f} ms {cls[c]['share']:.1%} (n {cls[c]['n']})"
              for c in ob.CLASSES)
          + f" | idle {res['idle_ms']:.3f} ms {res['idle_share']:.1%} (of the unprofiled "
          f"wall: {max(wall - busy, 0.0):.3f} ms, {max(1 - busy / wall, 0.0):.1%}) | residual "
          f"{res['residual']:+.2e} | kernels {res['n_kernels']}, {res['linked']} linked to an "
          f"aten op, the rest placed by name", flush=True)
    print(f"[{tag}] analytic (H100 roofline, batch {res['batch']}, seq {res['seq']}): "
          + " | ".join(f"{c} {a['ms']:.3f} ms {a['share']:.1%}" for c, a in ana.items())
          + " | measured / analytic: " + " ".join(
              f"{c} {r:.2f}" if r is not None else f"{c} -"
              for c, r in res["measured_over_analytic"].items()), flush=True)
    for c in ob.CLASSES:
        if cls[c]["top"]:
            print(f"[{tag}]   {c} top: " + "; ".join(
                f"{ms:.3f} ms x{n} {name[:70]}" for name, ms, n in cls[c]["top"]), flush=True)
    print(f"[{tag}] launches {counts} | ported kernels (seen, launched, classes) "
          + " ".join(f"{k} {p['seen']}/{p['launched']} {p['classes']}"
                     for k, p in ported.items()), flush=True)
    return res, counts


def phase_characterize(tt):
    """The paper's four workload analogues (``op_breakdown.WORKLOADS``)
    measured by class on the card, prefill and decode, beside the analytic
    H100 roofline: T-T on the dense phase's yi-34b (popped from the list
    ``tt``), then I-T
    (chameleon-34b, 24 of 48 layers), S-T (whisper-base) and H-A (HSTU),
    each model freed before the next. Returns {(workload, phase): (result,
    launch counts)}."""
    import gc

    import torch

    from repro_torch.launch import op_breakdown as ob

    dev = torch.device("cuda")
    out = {}
    for wl, spec in ob.WORKLOADS.items():
        t0 = time.perf_counter()
        if wl == "T-T":
            cfg, model, params = tt.pop()
        else:
            gc.collect()
            torch.cuda.empty_cache()
            cfg, model, params = ob.build(wl, dev, SEED)
        torch.cuda.reset_peak_memory_stats()
        for ph in spec[5]:
            out[(wl, ph)] = characterize_window(wl, ph, cfg, model, params)
        del model, params
        print(f"[characterize {wl}] {cfg.name}: {time.perf_counter() - t0:.1f} s | "
              f"max_memory_allocated {torch.cuda.max_memory_allocated()} B", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    rows = {f"{wl} {ph}": {"window_ms": r["window_ms"], "wall_ms": r["wall_ms"],
                           "idle_share": r["idle_share"],
                           "measured": {c: r["classes"][c]["share"] for c in ob.CLASSES},
                           "analytic": {c: a["share"] for c, a in r["analytic"].items()}}
            for (wl, ph), (r, _) in out.items()}
    print(f"[characterize] {json.dumps(rows)}", flush=True)
    return out


# --------------------------------------------------------------------------
# the hybrid phase: recurrentgemma-2b (RG-LRU blocks and local attention over
# ring-buffer K/V caches) at full width
# --------------------------------------------------------------------------

HYBRID_ARCH = "recurrentgemma-2b"
#: the long-context arm through ``engine.generate``: prompts of 1.5 x the
#: window 2048 (a ring prefill, windowed flash over 3072 keys, decode over a
#: wrapped ring), greedy tokens
LONG_BATCH, LONG_PROMPT, LONG_NEW = 2, 3072, 32
#: the hybrid phase's teacher-forced checks: max |dlogit| of the kernel
#: path's committed rows against the plain run's, forced to its tokens
#: (bf16), for the served trace and for the long-context arm. Each is set
#: between the sound run and its controls, which must break it: the decode
#: kernel one key short (``one_key_short``) in both arms, and in the long
#: arm also the ring's wrap ignored (``ring_unwrapped``). The random model's
#: logits reach ~900 (the last token's own embedding), so bf16's rounding
#: (P to bf16 in the kernels, f32 in the plain versions) alone moves them by
#: ~7; in f32 the two paths agree within 0.0014 (``launch/path_drift.py``).
#: Readings (NVIDIA H100 80GB HBM3, 700 W; they repeat to the bit): served
#: sound 7.158, one key short 7.611; long sound 6.373, one key short 6.974,
#: unwrapped 30.19
HYBRID_DLOGIT_BOUND = {"serve": 7.4, "long": 6.7}


@contextlib.contextmanager
def ring_unwrapped():
    """The long arm's control: decode reads only the ring rows written
    since its last wrap (``lengths % S`` of them, not ``min(lengths, S)``),
    the fault of a decode path that forgets its ring has wrapped."""
    from repro_torch.models import attention as A

    real = A.valid_counts
    A.valid_counts = lambda lengths, s: (lengths - 1) % s + 1
    try:
        yield
    finally:
        A.valid_counts = real


def near_tie_picks(rec, tag):
    """Every kernel-path pick of a forced run that differs from the plain
    run's draw must be at a near tie: the plain row's top-two gap below the
    row's |dlogit|. Returns the number of such picks."""
    picks = [r for r in rec.row_stats if r[2]]
    for dl, _, _, gap in picks:
        check(gap < dl, f"{tag}: a kernel pick differs at a deciding gap {gap} >= its row's "
                        f"|dlogit| {dl}")
    return len(picks)


def hybrid_rows(model, params, prompts, feed, impl, n_new):
    """Greedy decoding of ``prompts`` teacher-forced to ``feed`` [B, n_new]
    (its own picks when None): the logits each token is drawn from (the
    prefill's last position, then ``n_new - 1`` decode steps) [n_new, B, V]
    f32, and the tokens fed [B, n_new]."""
    import torch

    from repro_torch.core import engine, sampling

    b, t = prompts.shape
    lengths = torch.full((b,), t, dtype=torch.int32, device=prompts.device)
    logits, cache = engine.prefill(model, params, prompts, lengths, t + n_new + 1, impl=impl)
    rows, toks = [logits.float()], []
    for i in range(n_new):
        tok = sampling.greedy(rows[-1]).to(torch.int32) if feed is None else feed[:, i]
        toks.append(tok)
        if i < n_new - 1:
            logits, cache = engine.decode_step(model, params, cache, tok, impl=impl)
            rows.append(logits.float())
    del cache
    return torch.stack(rows), torch.stack(toks, dim=1)


def hybrid_long_arm(cfg, model, params):
    """Two prompts of LONG_PROMPT tokens through ``engine.generate`` on the
    kernels (exact launches: flash n_attn at the prefill, decode n_attn a
    decode step), a plain run, the kernel path forced to its tokens within
    HYBRID_DLOGIT_BOUND["long"] (a differing pick only at a near tie), the
    one-key-short and the ring-unwrapped controls above it, and for the
    record a plain run with the window removed. Returns the launch counts of
    the generate run."""
    import dataclasses

    import torch

    from repro_torch.core import engine
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import get_model

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    prompts = torch.randint(0, cfg.vocab_size, (LONG_BATCH, LONG_PROMPT), generator=gen,
                            device=dev, dtype=torch.int32)
    n_attn = _attn_layers(cfg)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    out = engine.generate(model, params, prompts, max_new_tokens=LONG_NEW)
    torch.cuda.synchronize()
    counts = _read_counts()
    wall = time.perf_counter() - t0
    want = _want_counts(cfg, LONG_NEW, flash_attention=n_attn,
                        decode_attention=n_attn * (LONG_NEW - 1))
    check(out["n_steps"] == LONG_NEW and tuple(out["tokens"].shape) == (LONG_BATCH, LONG_NEW),
          f"hybrid long: {out['n_steps']} steps, tokens {tuple(out['tokens'].shape)}")
    check(counts == want, f"hybrid long: kernel launches {counts}, expected {want}")
    print(f"[hybrid long] generate {LONG_BATCH} x {LONG_PROMPT} + {LONG_NEW}: {wall:.2f} s | "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B | launches {counts}",
          flush=True)
    with torch.inference_mode():
        prow, ptok = hybrid_rows(model, params, prompts, None, "torch", LONG_NEW)
        same = [bool(torch.equal(out["tokens"][i], ptok[i])) for i in range(LONG_BATCH)]
        rows = {}
        for run, ctx in (("forced", contextlib.nullcontext()), ("control", ring_unwrapped()),
                         ("one key short", one_key_short(da, "decode_attention_cuda", 3))):
            with ctx:
                rows[run] = hybrid_rows(model, params, prompts, ptok, "auto", LONG_NEW)[0]
        check(bool(torch.isfinite(rows["forced"]).all()), "hybrid long: non-finite logits")
        dl = {run: float((r - prow).abs().amax()) for run, r in rows.items()}
        # a kernel pick that differs from the plain path's: only at a near tie
        own = rows["forced"].argmax(-1)
        top2 = prow.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        row_dl = (rows["forced"] - prow).abs().amax(-1)
        differs = own != ptok.T.long()
        check(bool((gap[differs] < row_dl[differs]).all()),
              "hybrid long: a kernel pick differs away from a near tie")
        nowin_cfg = cfg.replace(hybrid=dataclasses.replace(cfg.hybrid, window=None))
        nowin = hybrid_rows(get_model(nowin_cfg), params, prompts, ptok, "torch", LONG_NEW)[0]
        dl_nowin = float((nowin - prow).abs().amax())
    bound = HYBRID_DLOGIT_BOUND["long"]
    print(f"[hybrid long] kernel tokens = plain path's in {sum(same)} of {LONG_BATCH} rows | "
          f"forced: max |dlogit| {dl['forced']:.6f} (bound {bound}), kernel picks that differ "
          f"{int(differs.sum())} | controls: one key short {dl['one key short']:.6f}, the "
          f"ring unwrapped {dl['control']:.6f} | plain run without the window "
          f"{dl_nowin:.6f}", flush=True)
    check(dl["forced"] <= bound, f"hybrid long: max |dlogit| {dl['forced']}, bound {bound}")
    for run in ("control", "one key short"):
        check(dl[run] > bound,
              f"hybrid long {run}: stayed within the bound ({dl[run]} <= {bound})")
    check(dl_nowin > dl["forced"], "hybrid long: removing the window changed nothing")
    del rows, prow, nowin, out
    return counts


def hybrid_step_profile(cfg, model, params, pad_to):
    """One decode step of 8 slots profiled as ``step_profile``, then the
    RG-LRU (``hybrid._rg_lru``) and the causal conv of one recurrent block
    timed on the device at the step's shapes and at the served prefill's,
    times the recurrent layers."""
    import torch

    from repro_torch.core import engine
    from repro_torch.models import hybrid as H
    from repro_torch.models.ssm import _causal_conv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    toks = torch.randint(0, cfg.vocab_size, (SLOTS, pad_to), generator=gen, device=dev,
                         dtype=torch.int32)
    _, cache = engine.prefill(model, params, toks,
                              torch.full((SLOTS,), pad_to, dtype=torch.int32, device=dev),
                              pad_to + 16)
    state = {"cache": cache, "tok": toks[:, -1].contiguous()}

    def step():
        logits, state["cache"] = engine.decode_step(model, params, state["cache"],
                                                    state["tok"])
        state["cache"]["lengths"].fill_(pad_to)  # every step at the same length
        state["tok"] = logits.argmax(-1).to(torch.int32)

    with torch.inference_mode():
        step_profile("hybrid decode step", step)
        rec = next(lp["rec"] for lp in params["layers"] if "rec" in lp)
        n_rec = cfg.n_layers - _attn_layers(cfg)
        w = cfg.hybrid.lru_width
        for what, b, t in (("decode step", SLOTS, 1), ("served prefill", 1, pad_to)):
            x = _rand(gen, (b, t, w), torch.bfloat16, dev)
            h0 = torch.randn((b, w), generator=gen, device=dev) if t == 1 else None
            tail = _rand(gen, (b, cfg.hybrid.conv_width - 1, w), torch.bfloat16, dev)
            lru = device_ms(lambda: H._rg_lru(rec, x, h0))
            conv = device_ms(lambda: _causal_conv(x, rec["conv_w"], rec["conv_b"],
                                                  tail if t == 1 else None))
            fmt = (lambda v: "not measured" if v is None else f"{v:.4f} ms")  # noqa: E731
            print(f"[hybrid decode step] {what} x[{b},{t},{w}]: RG-LRU {fmt(lru)} (gates' "
                  f"GEMMs and the scan's {(t - 1).bit_length()} rounds), causal conv "
                  f"{fmt(conv)} a layer; x {n_rec} recurrent layers: RG-LRU "
                  f"{fmt(None if lru is None else lru * n_rec)}, conv "
                  f"{fmt(None if conv is None else conv * n_rec)}", flush=True)
    del cache, state


def phase_hybrid(pad_to):
    """recurrentgemma-2b at full width (26 layers: 18 recurrent, 8 local
    attention of 10 heads over one KV head of 256, window 2048), bf16,
    seeded weights. Serves the 16 requests under the continuous and the
    fixed policy (the same tokens; exact launches; finite logits), then a
    plain run recorded, its tokens against the kernel run's (a differing
    pick only at a near tie, from the forced run), the kernel path forced
    to its draws within HYBRID_DLOGIT_BOUND["serve"] and, one key short,
    above it; one decode step profiled; the long-context arm. Returns
    (the continuous run's launch counts, the long arm's)."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.kv_cache import leaves
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import serve

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg, model, params = serve.build_model(HYBRID_ARCH, smoke=False, seed=SEED, device=dev)
    check(cfg == get_config(HYBRID_ARCH) and cfg.dtype == "bfloat16"
          and _attn_layers(cfg) == 8 and cfg.n_layers == 26, f"unexpected config {cfg}")
    n_el = sum(p.numel() for p in leaves(params))
    n_bytes = sum(p.numel() * p.element_size() for p in leaves(params))
    print(f"[hybrid] {HYBRID_ARCH}: {cfg.n_layers} layers ({_attn_layers(cfg)} local attention, "
          f"window {cfg.hybrid.window}), d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
          f"of {cfg.head_dim} (G*D = {cfg.q_per_kv * cfg.head_dim}), lru {cfg.hybrid.lru_width}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size} | params {n_el / 1e9:.3f}G elements, "
          f"{n_bytes} B (the f32 unembed table included) | init "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    serve.warmup(model, params, slots=SLOTS, pad_to=pad_to, max_new_cap=MAX_NEW, device=dev)
    runs = {policy: serve_once(model, params, cfg, pad_to, policy=policy, int8_mode=None,
                               tag=f"hybrid/{policy}")
            for policy in ("continuous", "fixed")}
    check(runs["continuous"][1] == runs["fixed"][1],
          "hybrid: continuous and fixed policies gave different tokens")
    kw = dict(policy="continuous", int8_mode=None)
    plain = Forced("record")
    with plain_path(), forcing(plain):
        mp, ptoks, _ = serve_once(model, params, cfg, pad_to, tag="hybrid plain", **kw)
    same = sum(runs["continuous"][1][r] == ptoks[r] for r in ptoks)
    dl, picks = {}, 0
    for run in ("forced", "control"):
        rec = Forced("steps", plain)
        with forcing(rec), (one_key_short(da, "decode_attention_cuda", 3)
                            if run == "control" else contextlib.nullcontext()):
            mf, ftoks, _ = serve_once(model, params, cfg, pad_to, tag=f"hybrid {run}", **kw)
        check(ftoks == ptoks and _geometry(mf) == _geometry(mp),
              f"hybrid {run}: tokens or steps differ from the plain run's")
        dl[run] = rec.summary(f"hybrid {run}")[1]
        if run == "forced":  # the near-tie rule for the kernel run's own tokens
            picks = near_tie_picks(rec, "hybrid forced")
        del rec
    bound = HYBRID_DLOGIT_BOUND["serve"]
    print(f"[hybrid] kernel tokens = plain path's in {same} of {len(ptoks)} requests, "
          f"{picks} differing picks at a near tie | max |dlogit| forced {dl['forced']:.6f}, "
          f"control {dl['control']:.6f} (bound {bound})", flush=True)
    check(dl["forced"] <= bound, f"hybrid: max |dlogit| {dl['forced']} against the plain "
                                 f"path, bound {bound}")
    check(dl["control"] > bound, f"hybrid control: a decode kernel one key short stayed "
                                 f"within the bound ({dl['control']} <= {bound})")
    del plain
    hybrid_f32_arm(pad_to)
    hybrid_step_profile(cfg, model, params, pad_to)
    long_counts = hybrid_long_arm(cfg, model, params)
    print(f"[hybrid] phase {time.perf_counter() - t_phase:.1f} s | max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B", flush=True)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return runs["continuous"][2], long_counts


def hybrid_kernel_records(pad_to, counts, long_counts):
    """recurrentgemma's kernel shapes against their plain versions, bf16
    (and f32 at a small shape), a repeat call bit-identical, timed beside
    their bound and SDPA: flash at D = 256, G = 10 at the served prefill (q
    [1, pad_to, 10, 256], window 2048) and at the long prompt ([2, 3072],
    window 2048, where a row past 2048 sees exactly its 2048 newest keys:
    a dominant key at the window's lower edge is seen by the row 2047 ahead
    of it and not by the row 2048 ahead); the decode at G * D = 2560 over
    the served ring (321 rows, lengths at the split edges) and over a full
    ring of 2048. Launches from the served run (``counts``) and the long
    arm (``long_counts``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    cfg = get_config(HYBRID_ARCH)
    hq, hkv, dh, win = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.hybrid.window
    g = hq // hkv
    s_ctg = pad_to + MAX_NEW + 1  # the served ring's rows (below the window)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    recs, errs = [], {}

    def record(*a, **src):
        kernel_record(recs, *a, **src)

    # flash: f32 at small shapes, bf16 at the served and the long prompt
    for dt, cases in ((torch.float32, ((1, 67, None), (2, 100, 32))),
                      (bf, ((1, pad_to, win), (LONG_BATCH, LONG_PROMPT, win)))):
        name = str(dt).split(".")[-1]
        for b, t, w in cases:
            q = _rand(gen, (b, t, hq, dh), dt, dev)
            k, v = (_rand(gen, (b, t, hkv, dh), dt, dev) for _ in range(2))
            kw = dict(q_positions=int_positions(b, t, dev), k_positions=int_positions(b, t, dev), causal=True, window=w)
            got = fa.flash_attention_cuda(q, k, v, **kw)
            case = f"flash D=256 G={g} {name} [{b},{t}] window {w}"
            errs[case] = max_err(got, fa.flash_attention_plain(q, k, v, **kw), name)
            check(torch.equal(got, fa.flash_attention_cuda(q, k, v, **kw)),
                  f"{case}: a repeat call differs")
            if dt == bf:
                pairs = sum(min(i + 1, w) for i in range(t)) * b
                amask = (torch.arange(t, device=dev)[None] <= torch.arange(t, device=dev)[:, None])
                amask &= torch.arange(t, device=dev)[None] > torch.arange(t, device=dev)[:, None] - w
                record(f"q[{b},{t},{hq},{dh}] kv[{b},{t},{hkv},{dh}] bf16 causal, window {w} "
                       f"(recurrentgemma {'served prefill' if b == 1 else 'long prompt'}, G = "
                       f"{g}: {64 // g} positions a 64-row block)",
                       lambda a=(q, k, v), kw=kw: fa.flash_attention_cuda(*a, **kw),
                       lambda a=(q, k, v), kw=kw: fa.flash_attention_plain(*a, **kw),
                       lambda qt=q.transpose(1, 2), ke=per_head(k, g), ve=per_head(v, g), m=amask:
                       F.scaled_dot_product_attention(qt, ke, ve, attn_mask=m),
                       errs[case], (2 * q.numel() + 2 * k.numel()) * 2 + 2 * b * t * 4,
                       pairs * hq * 4 * dh,
                       counts["flash_attention"] if b == 1 else long_counts["flash_attention"],
                       **FLASH_SRC)
            del q, k, v

    # the window's edge at the long prompt: keys 999 and 1000 dominate every
    # score (40 against 0), V column 0 marks key 1000 and column 1 key 999
    t = LONG_PROMPT
    q = torch.zeros((1, t, hq, dh), dtype=bf, device=dev)
    q[..., 0] = 32.0
    k = torch.zeros((1, t, hkv, dh), dtype=bf, device=dev)
    k[0, 999:1001, :, 0] = 20.0  # 32 * 20 / 16 = a score of 40
    v = torch.zeros_like(k)
    v[0, 1000, :, 0] = 1.0
    v[0, 999, :, 1] = 1.0
    edge = fa.flash_attention_cuda(q, k, v, q_positions=int_positions(1, t, dev), k_positions=int_positions(1, t, dev),
                                   causal=True, window=win).float()[0, :, :, :2]
    for row, want in ((999 + win, (1.0, 0.0)), (998 + win, (0.5, 0.5)), (1000 + win, (0.0, 0.0)),
                      (1000, (0.5, 0.5)), (998, (0.0, 0.0))):
        got_row = edge[row]
        check(bool((got_row - torch.tensor(want, device=dev)).abs().max() < 1e-2),
              f"flash window edge: row {row} gives {got_row[0].tolist()}, want {want}")
    print(f"[kernels] hybrid flash window {win}: row {999 + win} sees key {1000} (its "
          f"{win}th newest) and not key 999; rows {998 + win} and {1000 + win} see both and "
          f"neither", flush=True)
    del q, k, v, edge

    # decode: f32 and bf16 over the served ring at the split edges, bf16 over
    # a full ring of 2048 rows
    split_len = da.split_plan(SLOTS, hkv, s_ctg, n_sms)[1]
    edges = [1, split_len - 1, split_len, split_len + 1, 2 * split_len, 200, s_ctg - 1, s_ctg]
    for dt in (torch.float32, bf):
        name = str(dt).split(".")[-1]
        for b, s, lens in ((SLOTS, s_ctg, edges), (LONG_BATCH, win, [win, win]),
                           (3, 100, [0, 37, 100])):
            if dt == torch.float32 and s == win:
                continue
            qd = _rand(gen, (b, hq, dh), dt, dev)
            kc, vc = (_rand(gen, (b, s, hkv, dh), dt, dev) for _ in range(2))
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            got = da.decode_attention_cuda(qd, kc, vc, ln)
            case = f"decode G*D={g * dh} {name} [{b},{s}] lengths {lens}"
            errs[case] = max_err(got, da.decode_attention_plain(qd, kc, vc, ln), name)
            check(torch.equal(got, da.decode_attention_cuda(qd, kc, vc, ln)),
                  f"{case}: a repeat call differs")
            if lens[0] == 0:
                check(bool((got[0] == 0).all()), "decode: a row of length 0 is not exactly zero")
            if dt == bf and b != 3:
                n_rows = int(ln.sum())
                amask = (torch.arange(s, device=dev)[None] < ln[:, None])[:, None, None, :]
                record(f"q[{b},{hq},{dh}] cache[{b},{s},{hkv},{dh}] bf16 lengths {lens} "
                       f"(recurrentgemma {'served ring' if s == s_ctg else 'full ring'}, "
                       f"G*D = {g * dh})",
                       lambda a=(qd, kc, vc, ln): da.decode_attention_cuda(*a),
                       lambda a=(qd, kc, vc, ln): da.decode_attention_plain(*a),
                       lambda qq=qd[:, :, None], ke=per_head(kc, g), ve=per_head(vc, g), m=amask:
                       F.scaled_dot_product_attention(qq, ke, ve, attn_mask=m),
                       errs[case], (2 * qd.numel() + 2 * n_rows * hkv * dh) * 2 + b * 4,
                       n_rows * hq * 4 * dh,
                       counts["decode_attention"] if s == s_ctg
                       else long_counts["decode_attention"], **DECODE_SRC)
    torch.cuda.synchronize()
    for case, e in errs.items():
        print(f"[kernels] hybrid {case:52s} max|err| {e:.3e}", flush=True)
    finish_records(recs)
    for rec in recs:
        check(rec["launches"] > 0, f"{rec['name']} {rec['shape']}: not launched on its path")
    return recs


# --------------------------------------------------------------------------
# the extend phase: a window of tokens a slot through forward(mode="extend")
# on the contiguous cache
# --------------------------------------------------------------------------

#: 8 slots at these lengths over the contiguous cache of pad_to + MAX_NEW + 1
#: = 321 rows take a window of EXTEND_T tokens; the last slot overhangs (320 +
#: 4 > 321): the reference's clamp writes its window at rows 317..320
EXTEND_LENGTHS, EXTEND_T = [1, 44, 100, 200, 256, 300, 316, 320], 4
#: the bf16 arms' logit bound: max |dlogit| against the plain path within the
#: bf16 tolerance of the logits' scale (2e-2 of the reference's max |logit|,
#: the HSTU check's normwise rule)
EXTEND_BF16_NORMWISE = TOL["bfloat16"][1]
#: the written K/V (or latent) rows against the plain path's, normwise (max
#: |d| over max |ref|, every layer) by the cache's type: in bf16 the kernel
#: path's residual drifts from the plain one by up to 3 % over llama's 16
#: layers (``launch/path_drift.py``), and a layer's K/V with it; layer 0's
#: rows (their inputs differ only by the RMSNorm kernel) are held
#: elementwise at the bf16 tolerance besides
EXTEND_KV_NORMWISE = {"bfloat16": 5e-2, "float32": TOL["float32"][1]}
#: the f32 llama arm (EXTEND_F32_LAYERS of 16 layers at full width, the f32
#: flash kernel): max |dlogit| of the kernel extend against the plain decode
#: chain, set between the sound reading and the flash kernel one key short
#: (``flash_one_key_short``)
EXTEND_F32_LAYERS, EXTEND_F32_BOUND = 2, 0.01


def _clone_cache(cache):
    from repro_torch.core.kv_cache import _map

    return _map(lambda x: x.clone(), cache)


@contextlib.contextmanager
def flash_one_key_short():
    """The extend arms' control: the flash kernel with each row's newest
    valid key left out (its valid keys are a prefix), the off-by-one of a
    wrong ``k_valid``."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    real = fa.flash_attention_cuda

    def short(q, k, v, **kw):
        kv = kw["k_valid"]
        n = kv.sum(-1, keepdim=True)
        kw["k_valid"] = (kv & (torch.arange(kv.shape[1], device=kv.device)[None] < n - 1))
        return real(q, k, v, **kw)

    fa.flash_attention_cuda = short
    try:
        yield
    finally:
        fa.flash_attention_cuda = real


@contextlib.contextmanager
def routing_log(log):
    """Appends each MoE layer's chosen experts [B, T, k] (sorted) to ``log``,
    in call order."""
    from repro_torch.models import moe as M

    real = M.moe_ffn

    def spy(cfg, p, x, impl="auto", tp=None, ep=None):
        n = x.shape[0] * x.shape[1]
        ids = M.route(cfg, p, x.reshape(n, -1))[2]
        log.append(ids.reshape(x.shape[0], x.shape[1], -1).sort(-1).values)
        return real(cfg, p, x, impl, tp, ep)

    M.moe_ffn = spy
    try:
        yield
    finally:
        M.moe_ffn = real


def _cache_leaves(cache):
    """(layer, name, tensor) of a contiguous cache's [B, S, ...] leaves."""
    return [(i, k, v) for i, lc in enumerate(cache["layers"]) for k, v in lc.items()]


def extend_runs(cfg, model, params, pad_to, control=False):
    """The extend arm's runs from one plain-path prefill of 8 slots at
    EXTEND_LENGTHS (a cache of pad_to + MAX_NEW + 1 rows): the kernel path's
    extend of a EXTEND_T-token window (launch counts read around it), the
    plain path's, a chain of EXTEND_T plain decode steps on the window's
    tokens, and with ``control`` the kernel extend with the flash kernel one
    key short. Each: (logits [B, T, V] f32, cache, counts, routing)."""
    import torch

    dev = torch.device("cuda")
    s = pad_to + MAX_NEW + 1
    b = len(EXTEND_LENGTHS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    prompts = torch.randint(0, cfg.vocab_size, (b, s - 1), generator=gen, device=dev,
                            dtype=torch.int32)
    win = torch.randint(0, cfg.vocab_size, (b, EXTEND_T), generator=gen, device=dev,
                        dtype=torch.int32)
    ln = torch.tensor(EXTEND_LENGTHS, dtype=torch.int32, device=dev)
    routed = cfg.moe is not None
    runs = {}
    with torch.inference_mode():
        cache0 = model.init_cache(b, s, dev)
        _, cache0, _ = model.forward(params, {"tokens": prompts, "prompt_lengths": ln},
                                     cache=cache0, mode="prefill", impl="torch")
        arms = [("kernel", "auto", contextlib.nullcontext), ("plain", "torch",
                                                               contextlib.nullcontext)]
        if control:
            arms.append(("control", "auto", flash_one_key_short))
        for run, impl, ctx in arms:
            log = []
            c = _clone_cache(cache0)
            torch.cuda.synchronize()
            _reset_counts()
            with ctx(), (routing_log(log) if routed else contextlib.nullcontext()):
                lg, c, _ = model.forward(params, {"tokens": win}, cache=c, mode="extend",
                                         impl=impl)
            torch.cuda.synchronize()
            runs[run] = (lg.float(), c, _read_counts(), log)
        c, rows, log = _clone_cache(cache0), [], []
        with routing_log(log) if routed else contextlib.nullcontext():
            for i in range(EXTEND_T):
                lg, c, _ = model.forward(params, {"tokens": win[:, i:i + 1]}, cache=c,
                                         mode="decode", impl="torch")
                rows.append(lg[:, 0].float())
        runs["chain"] = (torch.stack(rows, 1), c, None, log)
    return cache0, ln, runs


def _clean_rows(cfg, runs, a, ref):
    """[B, T] bool: the rows of run ``a`` whose slot routed every lane up to
    them as in run ``ref`` in every MoE layer (all rows for a dense model).
    The chain's log holds one [B, 1, k] a layer a step."""
    import torch

    la, lr = runs[a][3], runs[ref][3]
    b = len(EXTEND_LENGTHS)
    if cfg.moe is None:
        return torch.ones((b, EXTEND_T), dtype=torch.bool, device=runs[a][0].device)

    def per_layer(log):
        if len(log) and log[0].shape[1] == EXTEND_T:
            return log
        n = len(log) // EXTEND_T
        return [torch.cat([log[i * n + j] for i in range(EXTEND_T)], dim=1) for j in range(n)]

    same = torch.stack([(x == y).all(-1) for x, y in zip(per_layer(la), per_layer(lr))]).all(0)
    return same.int().cumprod(dim=1).bool()


def extend_check(tag, cfg, model, params, pad_to, *, bound=None, control=False):
    """The extend arm's checks (bf16 unless ``cfg`` is f32): exact launches
    (flash n_layers, RMSNorm as a forward's, nothing else; the plain runs
    none); new lengths = lengths + T; in every layer each slot's window
    written at rows [min(len, S - T), +T) by the kernel path and by the plain
    path, every other row bit-identical to the prefilled cache; the slots
    that fit held against the plain decode chain, the overhanging slot
    against the plain extend: max |dlogit| of the rows routed alike within
    ``bound`` (None: EXTEND_BF16_NORMWISE of the reference's max |logit|),
    the written K/V (or latent) rows within EXTEND_KV_NORMWISE (layer 0's
    elementwise at the type's tolerance, and in bf16 the overhanging slot's
    bit for bit: their inputs differ only by the RMSNorm kernel, which
    rounds as its plain version at these rows), and each row's greedy pick the reference's unless at a near tie (its
    top-two gap below the row's |dlogit|). With ``control`` the flash kernel
    one key short must break the bound. Returns the kernel run's counts and
    the readings."""
    import torch

    cache0, ln, runs = extend_runs(cfg, model, params, pad_to, control)
    s = cache0["layers"][0][next(iter(cache0["layers"][0]))].shape[1]
    n_attn = _attn_layers(cfg)
    want = _want_counts(cfg, 1, flash_attention=n_attn)
    check(runs["kernel"][2] == want,
          f"{tag}: kernel launches {runs['kernel'][2]}, expected {want}")
    check(all(v == 0 for v in runs["plain"][2].values()), f"{tag}: the plain path launched")
    start = torch.clamp(ln.long(), max=s - EXTEND_T)
    rows = torch.arange(s, device=ln.device)[None]
    written = (rows >= start[:, None]) & (rows < start[:, None] + EXTEND_T)  # [B, S]
    fits = (ln + EXTEND_T <= s)
    check(int((~fits).sum()) == 1, f"{tag}: expected one overhanging slot")
    for run in ("kernel", "plain"):
        c = runs[run][1]
        check(torch.equal(c["lengths"], ln + EXTEND_T), f"{tag} {run}: lengths {c['lengths']}")
        for (i, name, got), (_, _, before) in zip(_cache_leaves(c), _cache_leaves(cache0)):
            check(torch.equal(got[~written], before[~written]),
                  f"{tag} {run}: layer {i} {name} changed a row outside its window")
            check(bool((got[written] != before[written]).flatten(1).any(-1).all()),
                  f"{tag} {run}: layer {i} {name} left a window row unwritten")
    # the reference of each slot: the decode chain where the window fits, the
    # plain extend where it overhangs (a decode would wrap to row 0)
    ref_logits = torch.where(fits[:, None, None], runs["chain"][0], runs["plain"][0])
    clean = torch.where(fits[:, None], _clean_rows(cfg, runs, "kernel", "chain"),
                        _clean_rows(cfg, runs, "kernel", "plain"))
    check(int(clean.sum()) * 2 >= clean.numel(),
          f"{tag}: only {int(clean.sum())} of {clean.numel()} rows routed as the reference")
    scale = float(ref_logits.abs().amax())
    limit = EXTEND_BF16_NORMWISE * scale if bound is None else bound

    def dlogit(run):
        d = (runs[run][0] - ref_logits).abs().amax(-1)  # [B, T]
        return d, float(d[clean].max())

    row_dl, dl = dlogit("kernel")
    top2 = ref_logits.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    differs = (runs["kernel"][0].argmax(-1) != ref_logits.argmax(-1)) & clean
    check(bool((gap[differs] < row_dl[differs]).all()),
          f"{tag}: a greedy pick differs from the reference's away from a near tie")
    # the written rows' values: the chain's cache where the window fits, the
    # plain extend's where it overhangs; rows routed otherwise left out
    kv_worst, kv0 = 0.0, 0.0
    b = len(EXTEND_LENGTHS)
    for (i, name, got), (_, _, ch), (_, _, pl) in zip(
            _cache_leaves(runs["kernel"][1]), _cache_leaves(runs["chain"][1]),
            _cache_leaves(runs["plain"][1])):
        ref = torch.where(fits.view(-1, *([1] * (ch.dim() - 1))), ch, pl)
        g = got[written].reshape(b, EXTEND_T, -1).float()  # [B, T, ...] in lane order
        r = ref[written].reshape(b, EXTEND_T, -1).float()
        if i == 0:
            kv0 = max(kv0, max_err(g, r, cfg.dtype))
            if cfg.dtype == "bfloat16":  # the overhanging slot's rows, bit for bit
                check(torch.equal(g[~fits], r[~fits]),
                      f"{tag}: the overhanging window's layer-0 rows differ from the plain "
                      f"path's")
        g, r = g[clean], r[clean]
        kv_worst = max(kv_worst, float((g - r).abs().amax()) / max(float(r.abs().amax()),
                                                                   1e-30))
    line = (f"[{tag}] {len(EXTEND_LENGTHS)} slots at {EXTEND_LENGTHS} over {s} rows + "
            f"{EXTEND_T} tokens: launches {runs['kernel'][2]['flash_attention']} flash (= "
            f"{n_attn} layers) | window rows exact (the overhanging slot at rows "
            f"{s - EXTEND_T}..{s - 1}) | rows routed as the reference {int(clean.sum())} of "
            f"{clean.numel()} | max |dlogit| {dl:.6f} (bound {limit:.6f}; logits' max "
            f"{scale:.3f}) | greedy picks that differ {int(differs.sum())} (near ties) | "
            f"written rows: layer 0 max |d| {kv0:.3e}, every layer's max |d| / max |ref| "
            f"{kv_worst:.2e} (bound {EXTEND_KV_NORMWISE[cfg.dtype]})")
    readings = {"sound": dl, "bound": limit, "kv_rel": kv_worst}
    if control:
        cdl = dlogit("control")[1]
        readings["control"] = cdl
        line += f" | control (flash one key short) {cdl:.6f}, {cdl / max(dl, 1e-30):.1f}x"
    print(line, flush=True)
    check(dl <= limit, f"{tag}: max |dlogit| {dl} above {limit}")
    check(kv_worst <= EXTEND_KV_NORMWISE[cfg.dtype],
          f"{tag}: written rows off by {kv_worst:.3e} of their scale")
    if control:
        check(readings["control"] > limit,
              f"{tag} control: the flash kernel one key short stayed within {limit}")
    return runs["kernel"][2], readings


def extend_refusals(cfg, params):
    """A paged cache and (but for MLA) a ring raise NotImplementedError on
    extend, before any write (one layer of ``cfg``)."""
    import torch

    from repro_torch.core.kv_cache import leaves
    from repro_torch.models import get_model

    dev = torch.device("cuda")
    one = cfg.replace(n_layers=1)
    p1 = dict(params, layers=params["layers"][:1])
    win = torch.zeros((2, EXTEND_T), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        paged = {"lengths": torch.zeros((2,), dtype=torch.int32, device=dev),
                 "block_tables": torch.zeros((2, 2), dtype=torch.int32, device=dev),
                 "layers": [{n: torch.zeros((4, 16) + tuple(x.shape[2:]), dtype=x.dtype,
                                            device=dev)
                             for n, x in get_model(one).init_cache(1, 1, dev)["layers"][0]
                             .items()}]}
        cases = [("paged", get_model(one), paged)]
        if cfg.mla is None:  # MLA's latent has no ring in either package
            ring = get_model(one.replace(sliding_window=64))
            cases.append(("ring", ring, ring.init_cache(2, 321, dev)))
        for what, model, cache in cases:
            try:
                model.forward(p1, {"tokens": win}, cache=cache, mode="extend")
            except NotImplementedError as e:
                check(all(not bool(x.any()) for x in leaves(cache["layers"])),
                      f"extend on a {what} cache wrote before it refused")
                print(f"[extend] {cfg.name}: a {what} cache refuses extend ({e})", flush=True)
            else:
                fail(f"extend on a {what} cache did not raise")


def flash_extend_record(recs, gen, cfg, pad_to, launches, what):
    """Flash at an extend step's shapes against its plain version (bf16,
    atol/rtol 2e-2), timed beside its bound and SDPA: 8 slots x EXTEND_T
    queries at EXTEND_LENGTHS + i over the contiguous cache's rows, keys
    valid below lengths + EXTEND_T. GQA K/V for a dense model, MLA's latent
    (Hkv 1, D = kv_lora + rope, V its leading kv_lora columns) for deepseek."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    bf = torch.bfloat16
    b, t, s = len(EXTEND_LENGTHS), EXTEND_T, pad_to + MAX_NEW + 1
    ln = torch.tensor(EXTEND_LENGTHS, dtype=torch.int32, device=dev)
    if cfg.mla is not None:
        hq, hkv = cfg.n_heads, 1
        d = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
        dv = cfg.mla.kv_lora_rank
        scale = (cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim) ** -0.5
    else:
        hq, hkv, d, dv, scale = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim, None
    q = _rand(gen, (b, t, hq, d), bf, dev)
    k = _rand(gen, (b, s, hkv, d), bf, dev)
    v = k[..., :dv] if cfg.mla is not None else _rand(gen, (b, s, hkv, dv), bf, dev)
    qpos = (ln[:, None] + torch.arange(t, device=dev, dtype=torch.int32)[None]).contiguous()
    kpos = int_positions(b, s, dev)
    kval = (kpos < (ln + t)[:, None]).contiguous()
    kw = dict(q_positions=qpos, k_positions=kpos, causal=True, k_valid=kval, scale=scale)
    err = max_err(fa.flash_attention_cuda(q, k, v, **kw), fa.flash_attention_plain(q, k, v, **kw),
                  "bfloat16")
    ok = (kpos[:, None, :] <= qpos[:, :, None]) & kval[:, None, :]
    g = hq // hkv
    keys = int(kval.sum())
    v_bytes = 0 if cfg.mla is not None else keys * hkv * dv * 2
    kernel_record(
        recs, f"q[{b},{t},{hq},{d}] {'latent' if cfg.mla is not None else 'kv'}[{b},{s},{hkv},"
        f"{d}]{f' v = latent[..., :{dv}]' if cfg.mla is not None else ''} bf16 lengths "
        f"{EXTEND_LENGTHS} + {t} ({what})",
        lambda: fa.flash_attention_cuda(q, k, v, **kw),
        lambda: fa.flash_attention_plain(q, k, v, **kw),
        lambda qt=q.transpose(1, 2), ke=per_head(k, g), ve=per_head(v, g), m=ok[:, None]:
        F.scaled_dot_product_attention(qt, ke, ve, attn_mask=m, scale=scale),
        err, (q.numel() + b * t * hq * dv) * 2 + keys * hkv * d * 2 + v_bytes
        + (qpos.numel() + kpos.numel()) * 4 + kval.numel(),
        int(ok.sum()) * hq * 2 * (d + dv), launches, **FLASH_SRC)


def phase_extend(cfg, model, params, pad_to):
    """llama3.2-1b's extend at full width: the bf16 served model (16 layers)
    through ``extend_check``, then an f32 cut of EXTEND_F32_LAYERS layers
    (the f32 flash kernel) within EXTEND_F32_BOUND with the flash kernel one
    key short above it; the refusals; flash at the extend shapes. Returns
    (the kernel records, the bf16 run's counts)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    t0 = time.perf_counter()
    counts, _ = extend_check("extend", cfg, model, params, pad_to)
    dev = torch.device("cuda")
    cfg32 = get_config(ARCH).replace(dtype="float32", n_layers=EXTEND_F32_LAYERS)
    model32 = get_model(cfg32)
    with torch.inference_mode():
        params32 = model32.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    extend_check(f"extend f32 {EXTEND_F32_LAYERS} layers", cfg32, model32, params32, pad_to,
                 bound=EXTEND_F32_BOUND, control=True)
    del params32
    extend_refusals(cfg, params)
    recs = []
    flash_extend_record(recs, torch.Generator(device=dev).manual_seed(SEED + 29), cfg, pad_to,
                        counts["flash_attention"], "llama3.2-1b extend, contiguous K/V")
    finish_records(recs)
    print(f"[extend] phase {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return recs, counts


# --------------------------------------------------------------------------
# the train phase: full-width llama3.2-1b trained on the plain path
# --------------------------------------------------------------------------

#: 8 AdamW steps on one repeated token_stream batch (seed 0) of 4 x 128, lr
#: 1e-3 from the first step (one warmup step; bf16 params would round a
#: warmup's smaller updates away), then cosine over the 8 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 128, 8, 1e-3
#: the f32 card-against-CPU step: layers kept, batch and sequence
TRAIN_F32_LAYERS, TRAIN_F32_BATCH, TRAIN_F32_SEQ = 2, 2, 64


def train_f32_step_parity():
    """One f32 step of full-width llama3.2-1b cut to TRAIN_F32_LAYERS layers,
    the same params (drawn on the CPU) and batch on the card and on the CPU,
    both on the plain path (TF32 off): loss, gradient norm and every
    gradient leaf within atol 2e-5 + 2e-4 max|g|, every new param within
    atol 2e-5 / rtol 2e-4 but where the CPU's gradient is rounding noise
    (there within 2 lr: Adam's first step is about lr * sign(g))."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.training import data, optimizer as opt, train_loop as tl

    cfg = get_config(ARCH).replace(dtype="float32", n_layers=TRAIN_F32_LAYERS)
    model = get_model(cfg)
    params = L.drop_f32_table(model.init(torch.Generator().manual_seed(SEED), "cpu"))
    batch = next(data.token_stream(cfg, batch=TRAIN_F32_BATCH, seq_len=TRAIN_F32_SEQ,
                                   seed=SEED))
    ocfg = opt.OptimizerConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    out = {}
    for name in ("cpu", "cuda"):
        dev = torch.device(name)
        p = opt.tree_map(lambda _, x: x.to(dev), params)
        t0 = time.perf_counter()
        loss, _, grads = tl.value_and_grad(model, p, tl.to_batch(batch, dev), impl="torch")
        new, _, om = opt.apply_updates(p, grads, opt.init_state(p, ocfg), ocfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        to_cpu = lambda t: opt.leaf_list(opt.tree_map(lambda _, x: x.cpu(), t))  # noqa: E731
        out[name] = (float(loss), float(om["grad_norm"]), to_cpu(grads), to_cpu(new), secs)
        del p, grads, new
    (l_c, n_c, g_c, p_c, s_c), (l_g, n_g, g_g, p_g, s_g) = out["cpu"], out["cuda"]
    check(abs(l_g - l_c) <= 2e-5 + 2e-4 * abs(l_c), f"train f32: loss {l_g} vs CPU {l_c}")
    check(abs(n_g - n_c) <= 2e-5 + 2e-4 * abs(n_c), f"train f32: grad norm {n_g} vs {n_c}")
    worst, noise_n, flips = 0.0, 0, 0
    for (path, _), gc_, gg, pc, pg in zip(opt.tree_items(params), g_c, g_g, p_c, p_g):
        tol = 2e-5 + 2e-4 * float(gc_.abs().max())
        err = float((gg - gc_).abs().max())
        worst = max(worst, err / tol)
        check(err <= tol, f"train f32: gradient {opt.path_str(path)} off by {err} > {tol}")
        noise = gc_.abs() <= tol
        ok = torch.isclose(pg, pc, atol=2e-5, rtol=2e-4)
        check(bool(ok[~noise].all()), f"train f32: param {opt.path_str(path)} differs")
        check(bool(((pg - pc).abs()[noise] <= 2 * TRAIN_LR).all()),
              f"train f32: param {opt.path_str(path)} moved past 2 lr at a noise gradient")
        noise_n += int(noise.sum())
        flips += int((~ok & noise).sum())
    print(f"[train f32] {cfg.n_layers}-layer cut, batch {TRAIN_F32_BATCH} x {TRAIN_F32_SEQ}: "
          f"loss {l_g:.6f} (CPU {l_c:.6f}) | grad norm {n_g:.6f} (CPU {n_c:.6f}) | worst "
          f"gradient error {worst:.3f} of its tolerance | new params within f32 tolerance; "
          f"{noise_n} elements at rounding-noise gradients, {flips} of them updated otherwise "
          f"(within 2 lr) | step {s_g * 1e3:.1f} ms on the card, {s_c * 1e3:.1f} ms on the CPU",
          flush=True)


def phase_train():
    """Full-width llama3.2-1b (16 layers, bf16, tied, seeded init on the
    card) trained TRAIN_STEPS AdamW steps on one repeated ``token_stream``
    batch through ``train_loop.train`` with ``impl="torch"``: no kernel
    launched, the loss falling from the first step to the last, finite
    gradient norms and learning rates; step wall ms, tok/s and
    ``max_memory_allocated``. Then the checkpoint saved and restored into
    fresh tensors on the card, bit for bit; a forward and backward under
    ``impl="auto"`` refused by the kernels' guard; the f32 step against the
    CPU (``train_f32_step_parity``); two more steps profiled and AdamW's
    device time alone beside its bound."""
    import gc
    import itertools
    import math
    import statistics as st

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.kv_cache import leaves
    from repro_torch.models import get_model
    from repro_torch.training import checkpoint, data, optimizer as opt, train_loop as tl

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    check(cfg.n_layers == 16 and cfg.d_model == 2048 and cfg.tie_embeddings
          and cfg.dtype == "bfloat16", f"unexpected config {cfg}")
    batch = next(data.token_stream(cfg, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=SEED))
    ocfg = opt.OptimizerConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    res = tl.train(cfg, data=itertools.repeat(batch), steps=TRAIN_STEPS, opt_cfg=ocfg,
                   seed=SEED, log_every=1, device=dev, impl="torch")
    torch.cuda.synchronize()
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(v == 0 for v in counts.values()), f"train: kernels launched {counts}")
    hist = res.metrics_history
    check(len(hist) == TRAIN_STEPS, f"train: {len(hist)} logged steps")
    for h in hist:
        check(all(math.isfinite(h[k]) for k in ("loss", "grad_norm", "lr")),
              f"train: a non-finite metric {h}")
    check(hist[-1]["loss"] < hist[0]["loss"],
          f"train: the loss did not fall ({hist[0]['loss']} -> {hist[-1]['loss']})")
    walls = [hist[0]["wall_s"]] + [b["wall_s"] - a["wall_s"] for a, b in zip(hist, hist[1:])]
    step_ms = st.median(walls[1:]) * 1e3
    n_el = sum(p.numel() for p in leaves(res.params))
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {n_el / 1e9:.3f}G params (bf16, tied), AdamW f32 moments, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ} (token_stream seed {SEED}, repeated), lr "
          f"{TRAIN_LR}, impl torch | loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} over "
          f"{TRAIN_STEPS} steps | step wall {step_ms:.1f} ms (median of steps 1..; the first "
          f"{walls[0] * 1e3:.1f} ms) = {TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.0f} tok/s | "
          f"max_memory_allocated {peak} B | {gpu_line()}", flush=True)

    path = os.path.join(ROOT, "build", "train_ckpt", "llama3.2-1b.npz")
    t0 = time.perf_counter()
    checkpoint.save(path, res.params, res.opt_state, step=TRAIN_STEPS)
    t_save = time.perf_counter() - t0
    size = os.path.getsize(path)
    empty = lambda tree: opt.tree_map(lambda _, x: torch.empty_like(x), tree)  # noqa: E731
    t0 = time.perf_counter()
    got_p, got_o, step = checkpoint.restore(path, empty(res.params), empty(res.opt_state))
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    os.remove(path)
    check(step == TRAIN_STEPS and int(got_o.step) == TRAIN_STEPS, f"train: restored step {step}")
    for tree, back in ((res.params, got_p), (res.opt_state, got_o)):
        for (p, a), (_, b) in zip(opt.tree_items(tree), opt.tree_items(back)):
            check(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b),
                  f"train: checkpoint leaf {opt.path_str(p)} came back otherwise")
    print(f"[train] checkpoint {size} B: save {t_save:.1f} s, restore {t_restore:.1f} s, every "
          f"leaf bit for bit on the card", flush=True)
    del got_p, got_o

    model = get_model(cfg)
    _reset_counts()
    try:
        tl.value_and_grad(model, res.params, tl.to_batch(batch, dev), impl="auto")
    except RuntimeError as e:
        check("no backward" in str(e), f"train: auto under autograd raised otherwise: {e}")
        print(f"[train] impl='auto' under autograd on the card refused: {e}", flush=True)
    else:
        fail("train: a forward and backward under impl='auto' on the card did not raise")
    check(all(v == 0 for v in _read_counts().values()), "train: the refused step launched")

    # where a step's time goes: two more steps profiled, then AdamW alone
    # beside its bound (params and bf16 grads read, f32 moments read and
    # written, params written: 22 B an element)
    b = tl.to_batch(batch, dev)
    st_ = {"p": res.params, "o": res.opt_state}
    train_step = tl.make_train_step(model, ocfg, impl="torch")

    def one():
        st_["p"], st_["o"], _ = train_step(st_["p"], st_["o"], b)

    step_profile("train step", one, n_steps=2)
    _, _, grads = tl.value_and_grad(model, st_["p"], b, impl="torch")
    adam = device_ms(lambda: opt.apply_updates(st_["p"], grads, st_["o"], ocfg), calls=3)
    print(f"[train step] AdamW alone: device {'not measured' if adam is None else f'{adam:.3f} ms'}"
          f" over {n_el} params | bound {n_el * 22 / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes)",
          flush=True)
    del res, st_, grads
    gc.collect()
    torch.cuda.empty_cache()
    train_f32_step_parity()
    print(f"[train] phase {time.perf_counter() - t_phase:.1f} s", flush=True)


# --------------------------------------------------------------------------
# the hybrid phase's f32 forced arm
# --------------------------------------------------------------------------

#: recurrentgemma-2b in f32 at a depth cut (the published widths, its first
#: HYBRID_F32_LAYERS layers: two periods of rec, rec, attention), served on
#: the f32 kernels, forced to the f32 plain run's draws: max |dlogit| of the
#: committed rows within HYBRID_F32_BOUND, set between the sound reading and
#: the decode kernel one key short
HYBRID_F32_LAYERS, HYBRID_F32_BOUND = 6, 0.01


def hybrid_f32_arm(pad_to):
    """The f32 forced arm: recurrentgemma-2b cut to HYBRID_F32_LAYERS layers
    in f32 (seeded weights), phase 4's 16 requests recorded on the plain
    path, then served on the kernels forced to its draws (exact launches,
    the same tokens and steps) within HYBRID_F32_BOUND, and with the decode
    kernel one key short above it. Prints both readings, the control and
    their separation. Returns the readings."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import get_model

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg = get_config(HYBRID_ARCH).replace(dtype="float32", n_layers=HYBRID_F32_LAYERS)
    model = get_model(cfg)
    with torch.inference_mode():
        params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    kw = dict(policy="continuous", int8_mode=None)
    plain = Forced("record")
    with plain_path(), forcing(plain):
        mp, ptoks, _ = serve_once(model, params, cfg, pad_to, tag="hybrid f32 plain", **kw)
    dl = {}
    for run in ("forced", "control"):
        rec = Forced("steps", plain)
        with forcing(rec), (one_key_short(da, "decode_attention_cuda", 3)
                            if run == "control" else contextlib.nullcontext()):
            mf, ftoks, _ = serve_once(model, params, cfg, pad_to, tag=f"hybrid f32 {run}", **kw)
        check(ftoks == ptoks and _geometry(mf) == _geometry(mp),
              f"hybrid f32 {run}: tokens or steps differ from the plain run's")
        dl[run] = rec.summary(f"hybrid f32 {run}")[1]
        del rec
    bound = HYBRID_F32_BOUND
    print(f"[hybrid f32] {cfg.n_layers} of 26 layers ({_attn_layers(cfg)} local attention), "
          f"f32 kernels, forced to the f32 plain run: max |dlogit| sound {dl['forced']:.6f}, "
          f"one key short {dl['control']:.6f} (bound {bound}; separation "
          f"{dl['control'] / max(dl['forced'], 1e-30):.1f}x) | {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(dl["forced"] <= bound, f"hybrid f32: max |dlogit| {dl['forced']}, bound {bound}")
    check(dl["control"] > bound,
          f"hybrid f32 control: a decode kernel one key short stayed within {bound}")
    del model, params, plain
    gc.collect()
    torch.cuda.empty_cache()
    return dl


def mla_extend(cfg, params, pad_to):
    """deepseek-v2's extend over the latent (the phase's depth cut) through
    ``extend_check`` under dropless capacity (E / k: a token's experts do
    not depend on what shares its forward, so the extend and the decode
    chain route alike but at near ties), within FORCED_DLOGIT_BOUND with the
    flash kernel one key short above it; the paged refusal; flash over the
    latent at the extend shapes. Returns the kernel records."""
    import dataclasses

    import torch

    from repro_torch.models import get_model

    t0 = time.perf_counter()
    m = cfg.moe
    dropless = cfg.replace(moe=dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k))
    counts, _ = extend_check("mla extend", dropless, get_model(dropless), params, pad_to,
                             bound=FORCED_DLOGIT_BOUND, control=True)
    extend_refusals(cfg, params)
    recs = []
    flash_extend_record(recs, torch.Generator(device=torch.device("cuda")).manual_seed(SEED + 30),
                        cfg, pad_to, counts["flash_attention"],
                        "deepseek-v2 extend, absorbed latent")
    finish_records(recs)
    print(f"[mla extend] {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return recs


# --------------------------------------------------------------------------
# the scanned and audit phases: the decode loop captured as one CUDA graph,
# and every hot step captured and replayed against its eager run
# --------------------------------------------------------------------------

#: the scanned phase: prompts x prompt tokens, new tokens
SCAN_BATCH, SCAN_PROMPT, SCAN_NEW = 8, 256, 64
#: the bf16 forced arms' bound: max |dlogit| within this share of the plain
#: path's max |logit| (phase 7b's normwise bf16 bound); bf16 noise on logits
#: of ~750 leaves the one-key-short control inside it, so the control is
#: checked on an f32 cut: SCAN_F32_LAYERS layers, max |dlogit| within
#: SCAN_F32_BOUND (phase 7b's f32 extend bound)
SCAN_NORMWISE = TOL["bfloat16"][1]
SCAN_F32_LAYERS, SCAN_F32_BOUND = 2, 0.01


def forced_arms(tag, model, params, prompts, n, tokens, *, control, bound=None):
    """The kernel path teacher-forced to the plain path's greedy tokens, in
    the eager loop (``hybrid_rows``) and through the captured scanned step
    (``scanned_rows``): the two bit for bit, each within ``bound`` (None:
    SCAN_NORMWISE of the plain logits' max) of the plain logits, a differing
    pick only at a near tie; the decode kernel one key short is printed and,
    with ``control``, must break the bound. ``tokens`` (the captured run's,
    or None) are counted against the plain path's."""
    import torch

    from repro_torch.kernels import decode_attention as da

    with torch.inference_mode():
        prow, ptok = hybrid_rows(model, params, prompts, None, "torch", n)
        rows = {"eager": hybrid_rows(model, params, prompts, ptok, "auto", n)[0],
                "captured": scanned_rows(model, params, prompts, ptok, n, graph=True)}
        with one_key_short(da, "decode_attention_cuda", 3):
            rows["one key short"] = scanned_rows(model, params, prompts, ptok, n, graph=True)
    scale = float(prow.abs().amax())
    limit = SCAN_NORMWISE * scale if bound is None else bound
    dl = {run: float((r - prow).abs().amax()) for run, r in rows.items()}
    top2 = prow.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    for run in ("eager", "captured"):
        check(bool(torch.isfinite(rows[run]).all()), f"{tag} {run}: non-finite logits")
        row_dl = (rows[run] - prow).abs().amax(-1)
        differs = rows[run].argmax(-1) != ptok.T.long()
        check(bool((gap[differs] < row_dl[differs]).all()),
              f"{tag} {run}: a kernel pick differs from the plain path's away from a near tie")
    same = ("" if tokens is None else
            f"captured tokens = plain path's in "
            f"{sum(bool(torch.equal(tokens[i], ptok[i])) for i in range(len(ptok)))} of "
            f"{len(ptok)} rows | ")
    print(f"{tag} {same}max |dlogit| eager {dl['eager']:.6f}, captured {dl['captured']:.6f} "
          f"(bound {limit:.6f}; the plain logits' max {scale:.3f}) | one key short "
          f"{dl['one key short']:.6f}{'' if control else ' (for the record)'}", flush=True)
    for run in ("eager", "captured"):
        check(dl[run] <= limit, f"{tag} {run}: max |dlogit| {dl[run]} above {limit}")
    check(torch.equal(rows["eager"], rows["captured"]),
          f"{tag} the captured step's logits differ from the eager step's")
    if control:
        check(dl["one key short"] > limit, f"{tag} the one-key-short control stayed within "
                                           f"the bound ({dl['one key short']} <= {limit})")


def loop_profile(fn, n_tokens: int):
    """(wall ms of one call of ``fn`` unprofiled, device ms of its kernels
    from one profiled call or None, device kernels) over a warm card."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profiler() as prof:
        fn()
        torch.cuda.synchronize()
    kern = device_kernels(prof)
    dev = sum(e.time_range.elapsed_us() for e in kern) / 1e3 if kern else None
    return wall, dev, len(kern)


def scanned_rows(model, params, prompts, feed, n_new, graph: bool):
    """The logits each token is drawn from [n_new, B, V] f32 when the
    kernel path is teacher-forced to ``feed`` [B, n_new]: the prefill's last
    position, then ``n_new - 1`` steps of ``engine.ScannedStep`` whose
    sampler records the step's logits and feeds the next token of ``feed``
    (the step's key carries its index). With ``graph`` the step is captured
    once and replayed, as ``generate_scanned`` runs it; else it runs
    eagerly."""
    import torch

    from repro_torch.core import engine, graphs

    b, t = prompts.shape
    dev = prompts.device
    lengths = torch.full((b,), t, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        logits, cache = engine.prefill(model, params, prompts, lengths, t + n_new + 1)
        rows = torch.empty((n_new,) + tuple(logits.shape), dtype=torch.float32, device=dev)
        rows[0] = logits
        token = feed[:, 0].clone()
        out = torch.zeros((b, n_new), dtype=torch.int32, device=dev)
        idx = torch.arange(n_new - 1, device=dev)[:, None].expand(n_new - 1, 2).contiguous()

        def forced(logits, key):
            rows.index_copy_(0, key[:1] + 1, logits.float()[None])
            return feed.index_select(1, key[:1] + 1)[:, 0]

        step = engine.ScannedStep(model, params, cache, token, out, idx, forced, "auto")
        if not graph:
            for _ in range(n_new - 1):
                step()
            return rows
        saved = [x.clone() for x in step.state()]

        def undo():
            for x, v in zip(step.state(), saved):
                x.copy_(v)

        g, _, _ = graphs.capture(step, restore=undo)
        for _ in range(n_new - 1):
            g.replay()
        torch.cuda.synchronize()
        del g, cache
    return rows


def phase_scanned(cfg, model, params, gpu: str):
    """Full-width llama3.2-1b (16 layers, bf16), SCAN_BATCH prompts of
    SCAN_PROMPT tokens, SCAN_NEW greedy tokens through ``engine.generate``
    (the eager loop) and ``engine.generate_scanned`` (one decode step
    captured as a CUDA graph, replayed once a token): the same tokens bit for
    bit; exact launches for both (flash n_layers at the prefill, decode
    n_layers a decode step: the captured step's counts added once a replay);
    the kernel path teacher-forced to the plain path's tokens, eagerly and
    through the captured step (``forced_arms``), within SCAN_NORMWISE of the
    plain logits' max, and on an f32 cut of SCAN_F32_LAYERS layers within
    SCAN_F32_BOUND with the decode kernel one key short above it; per-token wall,
    device ms and busy share of both loops; a sampler with a host sync makes
    ``generate_scanned`` raise (no eager fallback)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import engine, sampling
    from repro_torch.models import get_model

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    prompts = torch.randint(0, cfg.vocab_size, (SCAN_BATCH, SCAN_PROMPT), generator=gen,
                            device=dev, dtype=torch.int32)
    n, n_layers = SCAN_NEW, cfg.n_layers
    want = _want_counts(cfg, n, flash_attention=n_layers, decode_attention=n_layers * (n - 1))
    runs = {}
    for name, fn in (("eager", lambda: engine.generate(model, params, prompts,
                                                       max_new_tokens=n)["tokens"]),
                     ("captured", lambda: engine.generate_scanned(model, params, prompts,
                                                                  max_new_tokens=n))):
        torch.cuda.synchronize()
        _reset_counts()
        toks = fn()
        torch.cuda.synchronize()
        counts = _read_counts()
        check(counts == want, f"[scanned {name}] kernel launches {counts}, expected {want}")
        check(tuple(toks.shape) == (SCAN_BATCH, n), f"[scanned {name}] tokens {toks.shape}")
        runs[name] = (toks, counts)
    check(torch.equal(runs["eager"][0], runs["captured"][0]),
          "[scanned] generate_scanned's tokens differ from generate's")
    # the loops' times: each whole call, less one prefill, over its decode steps
    lengths = torch.full((SCAN_BATCH,), SCAN_PROMPT, dtype=torch.int32, device=dev)
    pre = loop_profile(lambda: engine.prefill(model, params, prompts, lengths,
                                              SCAN_PROMPT + n + 1), 1)
    for name, fn in (("eager", lambda: engine.generate(model, params, prompts,
                                                       max_new_tokens=n)),
                     ("captured", lambda: engine.generate_scanned(model, params, prompts,
                                                                  max_new_tokens=n))):
        wall, dms, nk = loop_profile(fn, n)
        tok_wall = (wall - pre[0]) / (n - 1)
        tok_dev = None if dms is None or pre[1] is None else (dms - pre[1]) / (n - 1)
        dev_txt = ("device not measured" if tok_dev is None else
                   f"device {tok_dev:.3f} ms ({tok_dev / tok_wall:.1%} busy), "
                   f"{(nk - pre[2]) / (n - 1):.0f} device kernels")
        print(f"[scanned {name}] {gpu} | {SCAN_BATCH} x {SCAN_PROMPT} + {n} tokens: call "
              f"{wall:.2f} ms, prefill {pre[0]:.2f} ms | per decode token: wall "
              f"{tok_wall:.3f} ms, {dev_txt}", flush=True)
    # teacher-forced: the kernel path (eager and captured) on the plain path's
    # tokens, in bf16 at full depth, then in f32 at SCAN_F32_LAYERS layers
    # (f32 noise is small enough that the one-key-short control shows)
    forced_arms(f"[scanned forced] {gpu} |", model, params, prompts, n,
                runs["captured"][0], control=False)
    cfg32 = get_config(ARCH).replace(dtype="float32", n_layers=SCAN_F32_LAYERS)
    model32 = get_model(cfg32)
    with torch.inference_mode():
        params32 = model32.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    forced_arms(f"[scanned forced f32 {SCAN_F32_LAYERS} layers] {gpu} |", model32, params32,
                prompts, n, None, control=True, bound=SCAN_F32_BOUND)
    del params32

    # a capture-breaking op: generate_scanned raises, nothing runs eagerly instead
    def syncing(logits, key):
        int(logits[0, 0].argmax())  # a host sync inside the step
        return sampling.greedy(logits)

    try:
        engine.generate_scanned(model, params, prompts[:2, :16], max_new_tokens=4,
                                sampler=syncing)
    except Exception as e:  # what the capture raised
        raised = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    else:
        raised = None
    torch.cuda.synchronize()
    check(raised is not None, "[scanned] a sampler with a host sync was captured")
    check(torch.cuda.current_stream() == torch.cuda.default_stream(),
          "[scanned] the failed capture left the program on its capture stream")
    check(float(torch.ones(1, device=dev).add(1)) == 2.0, "[scanned] the card broke")
    print(f"[scanned] a sampler with a host sync: generate_scanned raised {raised}",
          flush=True)
    torch.cuda.empty_cache()
    print(f"[scanned] phase {time.perf_counter() - t0:.1f} s", flush=True)


def phase_audit(model, params, gpu: str):
    """``python -m repro_torch.analysis --device cuda``'s step audit on the
    served full-width llama3.2-1b at the reference's pool geometry (4 slots,
    pad 16, 64 new, block 16, 14 blocks, budget 4, exit layer 1, 4 drafts):
    every hot step (prefill; decode, draft and verify on both pools; the
    paged mixed step) on two traces' states holds the static-program,
    in-place, growth and dtype checks, captures as one CUDA graph and
    replays bit for bit its eager run on both states. Prints each step's
    eager and replay wall ms and its graph's device kernels (one profiled
    replay)."""
    import torch

    from repro_torch.analysis import trace_audit

    t0 = time.perf_counter()
    steps = []
    fails = trace_audit.run_trace_audit("cuda", model=model, params=params, steps_out=steps)
    for msg in fails[:40]:
        print(f"[audit] {msg}", flush=True)
    check(not fails, f"[audit] {len(fails)} failure(s)")
    for step in steps:
        rep = step.report
        with profiler() as prof:
            rep["replay"]()
            torch.cuda.synchronize()
        kern = device_kernels(prof)
        launched = {k: v for k, v in rep["launches"].items() if v and "/" not in k}
        print(f"[audit {step.label}] {gpu} | {rep['ops']} ops | eager {rep['eager_ms'] - rep['load_ms']:.3f} ms, "
              f"graph replay {rep['replay_ms'] - rep['load_ms']:.3f} ms (wall, the state's load "
              f"of {rep['load_ms']:.3f} ms taken out) | graph: {len(kern)} device kernels, "
              f"ported kernels a replay {launched}", flush=True)
        rep.pop("graph"), rep.pop("replay")
    del steps
    torch.cuda.empty_cache()
    print(f"[audit] {len(fails)} failures | phase {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------- smoke configs
#: the smoke_configs phase: requests, prompt pad and new tokens a request;
#: the hybrid's pad past its 32-row ring; the paged + chunked geometry (8
#: slots of up to 16 + 24 tokens want 40 blocks of 8: 24 make it preempt)
SMOKE_REQS, SMOKE_PAD, SMOKE_NEW, SMOKE_RING_PAD = 8, 16, 24, 48
SMOKE_PAGED = dict(paged=True, chunked=True, block_size=8, num_blocks=24, prefill_budget=16)
#: the encoder-decoders' S-T arm: utterances x beams, new tokens
SMOKE_UTTER, SMOKE_ST_NEW = 2, 16
#: the host counters a kernel run and its plain run must share
SMOKE_HOST = ("prefills", "decode_steps", "mixed_steps", "n_preemptions", "prefill_chunks")
#: the bf16 teacher-forced arms: prompt rows x tokens and new tokens by
#: arch; the hybrid's prompts wrap its 32-row ring
SMOKE_FORCED = {"llama3.2-1b": (4, 16, 24), "recurrentgemma-2b": (4, 48, 24),
                "deepseek-v2-236b": (4, 16, 24)}
#: each bf16 arm's bound on max |dlogit| against the plain path, set between
#: its sound readings (0.384, 0.117, 0.375 on the H100) and its one-key-short
#: control (5.757, 3.388, 0.926); the readings repeat run to run (PERF.md)
SMOKE_DLOGIT_BOUND = {"llama3.2-1b": 1.5, "recurrentgemma-2b": 0.625,
                      "deepseek-v2-236b": 0.625}


def smoke_build(arch: str, dtype: str):
    """The smoke config of ``arch`` in ``dtype`` on the card, params from SEED."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model

    dev = torch.device("cuda")
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    model = get_model(cfg)
    with torch.inference_mode():
        params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    return cfg, model, params


def smoke_served(tag, cfg, model, params, pad_to, geometry):
    """The kernel run (exact launches, ``serve_once``) and the plain run (no
    launch) of SMOKE_REQS greedy requests: the same host counters, and the
    same tokens up to a near tie. Returns the kernel run's launches."""
    def reqs():
        return _trace(cfg, pad_to, n=SMOKE_REQS, max_new=SMOKE_NEW)

    m, toks, counts = serve_once(model, params, cfg, pad_to, policy="continuous",
                                 int8_mode=None, tag=f"{tag} kernels", reqs=reqs(), **geometry)
    with plain_path():
        pm, ptoks, _ = serve_once(model, params, cfg, pad_to, policy="continuous",
                                  int8_mode=None, tag=f"{tag} plain", reqs=reqs(), **geometry)
    host, phost = ({k: m.get(k, 0) for k in SMOKE_HOST}, {k: pm.get(k, 0) for k in SMOKE_HOST})
    check(host == phost, f"{tag}: host counters {host}, the plain run's {phost}")
    if geometry.get("paged"):
        check(m["n_preemptions"] > 0, f"{tag}: the paged arm did not preempt")
    same_tokens(model, params, cfg, pad_to, toks, ptoks, 0.0, 1.0, tag,
                "the plain path's tokens", reqs=reqs())
    print(f"[{tag}] host counters {host}", flush=True)
    return counts


def smoke_encdec(tag, cfg, model, params):
    """S-T beam groups (SMOKE_UTTER utterances x N_BEAMS beams) through the
    contiguous scheduler, kernels then plain: exact launches (a prefill per
    admission and a decode step per pool step, ``st_served``'s sum), the
    same host counters, the same tokens and scores within 1e-4."""
    import numpy as np
    import torch

    from repro_torch.core import profiles
    from repro_torch.core.scheduler import Scheduler, ServeRequest

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    n_f = cfg.encdec.n_frames
    frames = torch.randn((SMOKE_UTTER, n_f, cfg.d_model), generator=gen, device=dev)
    extra = {"frames": frames, "frame_lengths": torch.tensor(
        st_frame_lengths(SMOKE_UTTER, n_f), dtype=torch.int32, device=dev)}

    def run():
        reqs = [ServeRequest(rid=i, prompt=np.asarray([BOS]), max_new=SMOKE_ST_NEW,
                             profile=profiles.BeamProfile(n_beams=N_BEAMS, eos_id=EOS),
                             extra_inputs={k: v[i:i + 1] for k, v in extra.items()})
                for i in range(SMOKE_UTTER)]
        sched = Scheduler(model, params, slots=SMOKE_UTTER * N_BEAMS, pad_to=1,
                          max_new_cap=SMOKE_ST_NEW, device=dev)
        _reset_counts()
        with torch.inference_mode():
            done = sorted(sched.run(reqs), key=lambda r: r.rid)
        torch.cuda.synchronize()
        host = (sched.n_prefills, sched.n_decode_steps, sched.n_group_admissions,
                sched.n_cache_reorders)
        return done, host, _read_counts()

    done, host, got = run()
    one, two = _encdec_counts(cfg, 1), _encdec_counts(cfg, 2)
    want = {k: host[0] * one[k] + host[1] * (two[k] - one[k]) for k in one}
    check(got == want, f"{tag}: kernel launches {got}, expected {want}")
    with plain_path():
        pdone, phost, pgot = run()
    check(not any(pgot.values()), f"{tag} plain: kernel launches {pgot}")
    check(host == phost, f"{tag}: host counters {host}, the plain run's {phost}")
    for r, p in zip(done, pdone):
        check(r.tokens == p.tokens and 1 <= len(r.tokens) <= SMOKE_ST_NEW,
              f"{tag} request {r.rid}: tokens {r.tokens}, the plain run's {p.tokens}")
        check(abs(r.score - p.score) <= 1e-4, f"{tag} request {r.rid}: score {r.score}, "
                                              f"the plain run's {p.score}")
    print(f"[{tag}] {SMOKE_UTTER} utterances x {N_BEAMS} beams | prefills, steps, groups, "
          f"reorders {host} | tokens and scores = the plain run's | launches {got}",
          flush=True)
    return got


def smoke_hstu(tag, cfg, model, params):
    """One forward over four histories through the kernels (exact launches)
    and the plain path, at the f32 tolerance."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    lengths = torch.tensor([64, 50, 17, 1], dtype=torch.int32, device=dev)
    tokens = torch.randint(1, cfg.vocab_size, (4, 64), generator=gen, device=dev,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "lengths": lengths}
    with torch.inference_mode():
        _reset_counts()
        got, _, aux = model.forward(params, batch, mode="prefill")
        torch.cuda.synchronize()
        counts = _read_counts()
        with plain_path():
            want, _, paux = model.forward(params, batch, mode="prefill")
    wc = _want_counts(cfg, 1, hstu_attention=cfg.n_layers)
    check(counts == wc, f"{tag}: kernel launches {counts}, expected {wc}")
    tol = (HSTU_PARITY["float32"], HSTU_PARITY["float32"])
    err = max(max_err(got, want, "float32", tol),
              max_err(aux["ranking_logits"], paux["ranking_logits"], "float32", tol))
    print(f"[{tag}] one forward over lengths {lengths.tolist()}: max |dlogit| {err:.3e} "
          f"against the plain path | launches {counts}", flush=True)
    return counts


def smoke_forced_arm(arch):
    """The bf16 smoke config of ``arch`` teacher-forced to its plain path's
    greedy tokens (``hybrid_rows``): exact launches, max |dlogit| within the
    arm's bound (SMOKE_DLOGIT_BOUND), a differing pick only at a near tie;
    the decode kernel one key short must break the bound. Returns the
    kernel run's launches."""
    import torch

    from repro_torch.kernels import decode_attention as da

    cfg, model, params = smoke_build(arch, "bfloat16")
    b, t, n = SMOKE_FORCED[arch]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    prompts = torch.randint(0, cfg.vocab_size, (b, t), generator=gen, device=dev,
                            dtype=torch.int32)
    with torch.inference_mode():
        prow, ptok = hybrid_rows(model, params, prompts, None, "torch", n)
        _reset_counts()
        rows = hybrid_rows(model, params, prompts, ptok, "auto", n)[0]
        torch.cuda.synchronize()
        counts = _read_counts()
        with one_key_short(da, "decode_attention_cuda", 3):
            short = hybrid_rows(model, params, prompts, ptok, "auto", n)[0]
    n_attn = _attn_layers(cfg)
    want = _want_counts(cfg, n, flash_attention=n_attn, decode_attention=n_attn * (n - 1))
    check(counts == want, f"[smoke forced {arch}] kernel launches {counts}, expected {want}")
    scale = float(prow.abs().amax())
    limit = SMOKE_DLOGIT_BOUND[arch]
    dl, dl_short = float((rows - prow).abs().amax()), float((short - prow).abs().amax())
    top2 = prow.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    row_dl = (rows - prow).abs().amax(-1)
    differs = rows.argmax(-1) != ptok.T.long()
    check(bool(torch.isfinite(rows).all()), f"[smoke forced {arch}] non-finite logits")
    check(bool((gap[differs] < row_dl[differs]).all()),
          f"[smoke forced {arch}] a kernel pick differs from the plain path's away from a "
          f"near tie")
    print(f"[smoke forced {arch}] bf16, {b} prompts x {t} tokens, {n} forced tokens | max "
          f"|dlogit| {dl:.6f} (bound {limit:.6f}; the plain logits' max {scale:.3f}; "
          f"{int(differs.sum())} picks differ at near ties) | one key short {dl_short:.6f} | "
          f"launches {counts}", flush=True)
    check(dl <= limit, f"[smoke forced {arch}] max |dlogit| {dl} above {limit}")
    check(dl_short > limit, f"[smoke forced {arch}] the one-key-short control stayed within "
                            f"the bound ({dl_short} <= {limit})")
    del model, params
    return counts


def _attn_work(mask, hq, d, dv):
    """Operations of attention over the (query, key) pairs ``mask`` allows
    [B, Tq, Tk], hq heads: 2 (d + dv) a pair and head."""
    return int(mask.sum()) * hq * 2 * (d + dv)


def smoke_kernel_records(paths):
    """The new widths' records against their plain versions at the smoke
    paths' shapes, a repeat call bit-identical, timed beside their bound and
    SDPA where one call computes the same function; ``paths`` holds each
    path's launches ((arch, arm) -> counts). Then the widths that no served
    path runs (D = 16, and f32 at deepseek-v2-236b's widths (192, 128) and
    (576, 512)) timed the same way and printed, outside the ``kernels``
    line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    paged_src = dict(name="paged_decode_attention",
                     source="src/repro_torch/kernels/csrc/decode_attention.cu",
                     replaces="src/repro/models/attention.py:177")
    recs, off = [], []

    def mask_of(b, kw):
        m = fa._mask(kw["q_positions"], kw["k_positions"], kw.get("causal", True),
                     kw.get("window"), kw.get("k_valid"))
        return m.expand(b, *m.shape[1:])

    def flash(out, what, dt, q, k, v, kw, launches, latent=False):
        b, tq, hq, d = q.shape
        dv = v.shape[-1]
        elt = q.element_size()
        got = fa.flash_attention_cuda(q, k, v, **kw)
        err = max_err(got, fa.flash_attention_plain(q, k, v, **kw), dt)
        m = mask_of(b, kw)
        g = hq // k.shape[2]
        am = m[:, None]
        sc = kw.get("scale", d ** -0.5)
        lib = (lambda qt=q.transpose(1, 2), ke=per_head(k, g), ve=per_head(v, g), am=am, sc=sc:
               F.scaled_dot_product_attention(qt, ke, ve, attn_mask=am, scale=sc))
        n_bytes = elt * (q.numel() + got.numel() + k.numel() + (0 if latent else v.numel())) \
            + 4 * (kw["q_positions"].numel() + kw["k_positions"].numel()) \
            + (0 if kw.get("k_valid") is None else kw["k_valid"].numel())
        kernel_record(out, f"q{list(q.shape)} k{list(k.shape)} v{list(v.shape)} "
                           f"{'bf16' if elt == 2 else 'f32'} ({what})",
                      lambda: fa.flash_attention_cuda(q, k, v, **kw),
                      lambda: fa.flash_attention_plain(q, k, v, **kw), lib, err, n_bytes,
                      _attn_work(m, hq, d, dv), launches,
                      peak=BF16_FLOPS_PER_S if elt == 2 else F32_FLOPS_PER_S, **FLASH_SRC)

    def decode(out, what, dt, q, k, v, ln, launches, latent=False, scale=None):
        b, hq, d = q.shape
        dv, hkv = v.shape[-1], k.shape[2]
        elt = q.element_size()
        got = da.decode_attention_cuda(q, k, v, ln, scale=scale)
        err = max_err(got, da.decode_attention_plain(q, k, v, ln, scale=scale), dt)
        s = k.shape[1]
        am = (torch.arange(s, device=dev)[None] < ln[:, None])[:, None, None, :]
        g = hq // hkv
        sc = d ** -0.5 if scale is None else scale
        lib = (lambda qq=q[:, :, None], ke=per_head(k, g), ve=per_head(v, g), am=am, sc=sc:
               F.scaled_dot_product_attention(qq, ke, ve, attn_mask=am, scale=sc))
        rows = int(ln.sum())
        n_bytes = elt * (q.numel() + got.numel() + rows * hkv * (d if latent else d + dv)) \
            + 4 * b
        kernel_record(out, f"q{list(q.shape)} cache{list(k.shape)} v width {dv} "
                           f"{'bf16' if elt == 2 else 'f32'} lengths {ln.tolist()} ({what})",
                      lambda: da.decode_attention_cuda(q, k, v, ln, scale=scale),
                      lambda: da.decode_attention_plain(q, k, v, ln, scale=scale), lib, err,
                      n_bytes, rows * hq * 2 * (d + dv), launches,
                      peak=BF16_FLOPS_PER_S if elt == 2 else F32_FLOPS_PER_S, **DECODE_SRC)

    def paged(out, what, dt, q, kbuf, vbuf, bt, nv, launches, v_dim=None, scale=None):
        b, hq, d = q.shape
        elt = q.element_size()
        kw = dict(scale=scale, v_dim=v_dim)
        got = pda.paged_decode_attention_cuda(q, kbuf, vbuf, bt, nv, **kw)
        err = max_err(got, pda.paged_decode_attention_plain(q, kbuf, vbuf, bt, nv, **kw), dt)
        dv = got.shape[-1]
        hkv = 1 if kbuf.dim() == 3 else kbuf.shape[2]
        rows = int(nv.sum())
        n_bytes = elt * (q.numel() + got.numel() + rows * hkv * (d if vbuf is None else d + dv)) \
            + 4 * (bt.numel() + b)
        kernel_record(out, f"q{list(q.shape)} pool{list(kbuf.shape)} bt{list(bt.shape)} v width "
                           f"{dv} {'bf16' if elt == 2 else 'f32'} n_valid {nv.tolist()} ({what})",
                      lambda: pda.paged_decode_attention_cuda(q, kbuf, vbuf, bt, nv, **kw),
                      lambda: pda.paged_decode_attention_plain(q, kbuf, vbuf, bt, nv, **kw),
                      None, err, n_bytes, rows * hq * 2 * (d + dv), launches,
                      peak=BF16_FLOPS_PER_S if elt == 2 else F32_FLOPS_PER_S, **paged_src)

    def inputs(dtype, b, t, hq, hkv, d, dv=None, s=None, latent=False):
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
        s = t if s is None else s
        q = _rand(gen, (b, t, hq, d), dt, dev)
        k = _rand(gen, (b, s, hkv, d), dt, dev)
        v = k[..., :dv] if latent else _rand(gen, (b, s, hkv, d if dv is None else dv), dt, dev)
        return q, k, v

    s_ctg = SMOKE_PAD + MAX_NEW + 1  # a contiguous slot's rows (serve_once's max_new_cap)
    bs = SMOKE_PAGED["block_size"]
    mb = -(-s_ctg // bs)
    nb = SMOKE_PAGED["num_blocks"]
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(SEED))
    bt = torch.stack([perm[(i * 3) % (nb - 1 - mb):][:mb] + 1 for i in range(SLOTS)]).to(
        torch.int32).to(dev).contiguous()
    lens = torch.tensor([1, 7, 16, 17, 24, 33, 39, 40], dtype=torch.int32, device=dev)
    dense = get_smoke_config("llama3.2-1b")
    mla = get_smoke_config("deepseek-v2-236b").mla
    rg = get_smoke_config("recurrentgemma-2b")
    wh = get_smoke_config("whisper-base")
    mla_d, mla_dv = mla.qk_nope_dim + mla.qk_rope_dim, mla.v_head_dim
    lat_d, lat_dv = mla.kv_lora_rank + mla.qk_rope_dim, mla.kv_lora_rank
    mla_scale = mla_d ** -0.5
    hq, hkv, dh = dense.n_heads, dense.n_kv_heads, dense.head_dim
    for dtype, src in (("float32", "f32 smoke serve"), ("bfloat16", "bf16 forced arm")):
        f32 = dtype == "float32"

        def n(arch, arm, counter):
            return paths[(arch, arm if f32 else "bf16 forced")][counter]
        t = SMOKE_PAD if f32 else SMOKE_FORCED["llama3.2-1b"][1]
        q, k, v = inputs(dtype, 1, t, hq, hkv, dh)
        pos = int_positions(1, t, dev)
        flash(recs, f"llama3.2-1b smoke prefill, G = {hq // hkv}, D = {dh}; {src}", dtype, q,
              k, v, dict(q_positions=pos, k_positions=pos, causal=True),
              n("llama3.2-1b", "contiguous", "flash_attention"))
        # a contiguous slot's rows: serve_once's pool, or the forced arm's cache
        s_dec = s_ctg if f32 else sum(SMOKE_FORCED["llama3.2-1b"][1:]) + 1
        ln = lens.clamp(max=s_dec)
        q, k, v = inputs(dtype, SLOTS, 1, hq, hkv, dh, s=s_dec)
        decode(recs, f"llama3.2-1b smoke decode; {src}", dtype, q[:, 0], k, v, ln,
               n("llama3.2-1b", "contiguous", "decode_attention"))
        t = SMOKE_RING_PAD if f32 else SMOKE_FORCED["recurrentgemma-2b"][1]
        q, k, v = inputs(dtype, 1, t, rg.n_heads, rg.n_kv_heads, rg.head_dim)
        pos = int_positions(1, t, dev)
        flash(recs, f"recurrentgemma-2b smoke prefill, G = {rg.n_heads}, window "
                    f"{rg.hybrid.window}; {src}", dtype, q, k, v,
              dict(q_positions=pos, k_positions=pos, causal=True, window=rg.hybrid.window),
              n("recurrentgemma-2b", "contiguous", "flash_attention"))
        q, k, v = inputs(dtype, SLOTS, 1, rg.n_heads, 1, rg.head_dim, s=rg.hybrid.window)
        decode(recs, f"recurrentgemma-2b smoke ring decode; {src}", dtype, q[:, 0], k, v,
               lens.clamp(max=rg.hybrid.window), n("recurrentgemma-2b", "contiguous",
                                                   "decode_attention"))
        t = SMOKE_PAD if f32 else SMOKE_FORCED["deepseek-v2-236b"][1]
        h = get_smoke_config("deepseek-v2-236b").n_heads
        q, k, v = inputs(dtype, 1, t, h, h, mla_d, mla_dv)
        pos = int_positions(1, t, dev)
        flash(recs, f"deepseek-v2 smoke MLA prefill ({mla_d}, {mla_dv}); {src}", dtype, q, k,
              v, dict(q_positions=pos, k_positions=pos, causal=True, scale=mla_scale),
              n("deepseek-v2-236b", "contiguous", "flash_attention"))
        q, k, v = inputs(dtype, SLOTS, 1, h, 1, lat_d, lat_dv, s=s_dec, latent=True)
        decode(recs, f"deepseek-v2 smoke latent decode ({lat_d}, {lat_dv}); {src}", dtype,
               q[:, 0], k, v, ln, n("deepseek-v2-236b", "contiguous", "decode_attention"),
               latent=True, scale=mla_scale)
        if not f32:
            continue
        # the f32 paged paths: the chunked arm's pool and tables
        q, kb, vb = (_rand(gen, (SLOTS, hq, dh), torch.float32, dev),
                     _rand(gen, (nb, bs, hkv, dh), torch.float32, dev),
                     _rand(gen, (nb, bs, hkv, dh), torch.float32, dev))
        paged(recs, "llama3.2-1b smoke paged decode; f32 smoke serve", dtype, q, kb, vb, bt,
              lens, n("llama3.2-1b", "chunked", "paged_decode_attention"))
        q, pool = (_rand(gen, (SLOTS, h, lat_d), torch.float32, dev),
                   _rand(gen, (nb, bs, lat_d), torch.float32, dev))
        paged(recs, "deepseek-v2 smoke paged latent decode; f32 smoke serve", dtype, q, pool,
              None, bt, lens, n("deepseek-v2-236b", "chunked", "paged_decode_attention"),
              v_dim=lat_dv, scale=mla_scale)
        # the chunked arm's mixed step over the gathered latent: 8 slots of
        # the budget's 16 lanes
        tq, tk = SMOKE_PAGED["prefill_budget"], mb * bs
        q = _rand(gen, (SLOTS, tq, h, lat_d), torch.float32, dev)
        lat = _rand(gen, (SLOTS, tk, 1, lat_d), torch.float32, dev)
        qpos = (lens[:, None] - 1 + torch.arange(tq, device=dev, dtype=torch.int32)).contiguous()
        kpos = int_positions(SLOTS, tk, dev)
        flash(recs, f"deepseek-v2 smoke latent mixed step ({lat_d}, {lat_dv}); f32 smoke "
                    f"serve", dtype, q, lat, lat[..., :lat_dv],
              dict(q_positions=qpos, k_positions=kpos, causal=True,
                   k_valid=(kpos < (lens + tq)[:, None]).contiguous(), scale=mla_scale),
              n("deepseek-v2-236b", "chunked", "flash_attention"), latent=True)
        # whisper's cross attention: G = 1, bidirectional over the valid frames
        fl = torch.tensor(st_frame_lengths(SLOTS, wh.encdec.n_frames), device=dev)
        q, k, v = inputs(dtype, SLOTS, 1, wh.n_heads, wh.n_kv_heads, wh.head_dim,
                         s=wh.encdec.n_frames)
        kpos = int_positions(SLOTS, wh.encdec.n_frames, dev)
        flash(recs, f"whisper-base smoke cross attention, G = 1, frame lengths "
                    f"{fl.tolist()}; f32 smoke serve", dtype, q, k, v,
              dict(q_positions=int_positions(SLOTS, 1, dev), k_positions=kpos, causal=False,
                   k_valid=(kpos < fl[:, None]).contiguous()),
              n("whisper-base", "contiguous", "flash_attention"))

    # widths no served path runs: timed and printed, not in the kernels line
    for dtype in ("bfloat16", "float32"):
        q, k, v = inputs(dtype, 1, 256, 8, 2, 16)
        pos = int_positions(1, 256, dev)
        flash(off, "D = 16, G = 4, causal", dtype, q, k, v,
              dict(q_positions=pos, k_positions=pos, causal=True), 0)
        q, k, v = inputs(dtype, SLOTS, 1, 8, 2, 16, s=s_ctg)
        decode(off, "D = 16, G = 4", dtype, q[:, 0], k, v, lens, 0)
        q, kb, vb = (_rand(gen, (SLOTS, 8, 16), q.dtype, dev),
                     _rand(gen, (nb, bs, 2, 16), q.dtype, dev),
                     _rand(gen, (nb, bs, 2, 16), q.dtype, dev))
        paged(off, "D = 16, G = 4", dtype, q, kb, vb, bt, lens, 0)
    q, k, v = inputs("float32", 1, 256, 128, 128, 192, 128)
    pos = int_positions(1, 256, dev)
    flash(off, "deepseek-v2-236b MLA prefill (192, 128) in f32", "float32", q, k, v,
          dict(q_positions=pos, k_positions=pos, causal=True, scale=192 ** -0.5), 0)
    q = _rand(gen, (SLOTS, 5, 128, 576), torch.float32, dev)
    lat = _rand(gen, (SLOTS, 321, 1, 576), torch.float32, dev)
    ln = torch.tensor([1, 44, 100, 200, 256, 300, 0, 316], dtype=torch.int32, device=dev)
    qpos = (ln[:, None] + torch.arange(5, device=dev, dtype=torch.int32)).contiguous()
    kpos = int_positions(SLOTS, 321, dev)
    flash(off, "deepseek-v2-236b latent verify step (576, 512) in f32", "float32", q, lat,
          lat[..., :512], dict(q_positions=qpos, k_positions=kpos, causal=True,
                               k_valid=(kpos < (ln + 5)[:, None]).contiguous(),
                               scale=192 ** -0.5), 0, latent=True)
    decode(off, "deepseek-v2-236b latent decode (576, 512) in f32", "float32",
           q[:, 0].contiguous(), lat,
           lat[..., :512], ln + 1, 0, latent=True, scale=192 ** -0.5)
    torch.cuda.synchronize()
    finish_records(recs)
    print("[kernels] widths no served path runs (not in the kernels line):", flush=True)
    finish_records(off)
    for r in off:
        print(f"[kernels off-path] {json.dumps(r)}", flush=True)
    for r in recs:
        check(r["launches"] > 0, f"{r['name']} {r['shape']}: not launched on its path")
    return recs


#: the smoke configs by the entry that serves them
SMOKE_SERVED = ("llama3.2-1b", "qwen2.5-3b", "yi-34b", "llama3-405b", "chameleon-34b",
                "qwen3-moe-30b-a3b", "deepseek-v2-236b")


def phase_smoke_configs():
    """Each of the twelve smoke configs in f32 on the card, through its
    normal entry with the kernels and on the plain path: the decoder
    families on the contiguous pool and on paged + chunked (SMOKE_PAGED),
    mamba2 on the contiguous pool, recurrentgemma at a pad past its ring,
    the encoder-decoders' S-T beam groups, HSTU's forward. Then the bf16
    forced arms (SMOKE_FORCED) and the new widths' kernel records. Returns
    the records."""
    import torch

    from repro_torch.configs import SMOKE_CONFIGS

    t0 = time.perf_counter()
    paths = {}
    for arch in SMOKE_CONFIGS:
        cfg, model, params = smoke_build(arch, "float32")
        tag = f"smoke {arch}"
        if cfg.family in ("encdec", "seamless"):
            paths[(arch, "contiguous")] = smoke_encdec(tag, cfg, model, params)
        elif cfg.family == "hstu":
            paths[(arch, "contiguous")] = smoke_hstu(tag, cfg, model, params)
        else:
            pad = SMOKE_RING_PAD if cfg.family == "hybrid" else SMOKE_PAD
            paths[(arch, "contiguous")] = smoke_served(f"{tag}/contiguous", cfg, model, params,
                                                       pad, {})
            if arch in SMOKE_SERVED:
                paths[(arch, "chunked")] = smoke_served(f"{tag}/chunked", cfg, model, params,
                                                        pad, SMOKE_PAGED)
        del model, params
    check(set(SMOKE_CONFIGS) == {a for a, _ in paths}, "a smoke config was not served")
    t1 = time.perf_counter()
    for arch in SMOKE_FORCED:
        paths[(arch, "bf16 forced")] = smoke_forced_arm(arch)
    t2 = time.perf_counter()
    recs = smoke_kernel_records(paths)
    torch.cuda.empty_cache()
    print(f"[smoke_configs] phase {time.perf_counter() - t0:.1f} s (served {t1 - t0:.1f} s, "
          f"forced arms {t2 - t1:.1f} s, records {time.perf_counter() - t2:.1f} s)", flush=True)
    return recs


# ---------------------------------------------------------------- examples
#: the train_small example's run on the card: steps, checkpoint every
EXAMPLE_TRAIN_STEPS, EXAMPLE_TRAIN_CKPT_EVERY = 300, 100


def phase_examples():
    """The reference's five examples ported (``repro_torch.examples``) run on
    the card through their bodies, as ``python -m repro_torch.examples.<name>``
    runs them; the four that serve must move the attention kernels' counters,
    ``train_small`` (the plain path) none. Each example's own assertions
    hold (LayerSkip lossless, T-I tokens in the image range); the served
    groups must match their batch runs."""
    import torch

    from repro_torch.examples import (image_generation, quickstart, serve_batched,
                                      speech_translation, train_small)
    from repro_torch.models import get_model

    dev = torch.device("cuda")
    t0 = time.perf_counter()

    def counted(name, fn):
        _reset_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in _read_counts().items() if v}
        print(f"[examples/{name}] {time.perf_counter() - t:.1f} s | launches {got}", flush=True)
        return out, got

    attn = ("flash_attention", "decode_attention", "paged_decode_attention")

    def moved(name, got):
        check(any(got.get(k, 0) > 0 for k in attn) and got.get("rmsnorm", 0) > 0,
              f"examples/{name}: the attention kernels' counters did not move ({got})")

    def quick():
        model, params = quickstart.build(dev)
        with torch.inference_mode():
            return quickstart.run(model, params, dev)
    out, got = counted("quickstart", quick)
    moved("quickstart", got)
    check(got.get("int8_matmul_weight_only", 0) + got.get("int8_matmul_dynamic", 0) > 0,
          "examples/quickstart: the quantized generate launched no int8 kernel")
    _, got = counted("serve_batched", lambda: serve_batched.run("cuda"))
    moved("serve_batched", got)

    def speech():
        with torch.inference_mode():
            st = speech_translation.run_st(*speech_translation.build("whisper-base", dev), dev)
            ss = speech_translation.run_ss(*speech_translation.build("seamless-m4t", dev), dev)
        return st, ss
    (st, ss), got = counted("speech_translation", speech)
    moved("speech_translation", got)
    check(all(st["matches"]) and all(ss["matches"]),
          f"examples/speech_translation: served beams differ from the batch run's "
          f"({st['matches']}, {ss['matches']})")

    def image():
        model, params = image_generation.build(dev)
        with torch.inference_mode():
            return image_generation.run(model, params, dev)
    out, got = counted("image_generation", image)
    moved("image_generation", got)
    check(out["matches"], "examples/image_generation: the served T-I group differs from the "
                          "batch run")

    def train():
        model = get_model(train_small.CFG_100M)
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        return train_small.run(model, params, dev, steps=EXAMPLE_TRAIN_STEPS,
                               ckpt_every=EXAMPLE_TRAIN_CKPT_EVERY)
    out, got = counted("train_small", train)
    check(not got, f"examples/train_small: the plain path launched kernels ({got})")
    check(out["last"] < out["first"] and os.path.exists(out["ckpt"]),
          f"examples/train_small: loss {out['first']} -> {out['last']}, checkpoint "
          f"{out['ckpt']}")
    print(f"[examples] phase {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------- tp
#: the tp phase: two ranks on the one card (gloo), its full-width llama arms
#: (the serve phase's contiguous pool and the paged phase's chunked
#: geometry), the family arms (TP_FAMILIES) and the smoke width's (the
#: smoke_configs phase's pools)
TP_RANKS, TP_DEVICES = 2, ("cuda:0", "cuda:0")
TP_ARMS = {"contiguous": {}, "chunked": PAGED_ARMS["chunked"]}
TP_SMOKE = {"contiguous": {}, "chunked": SMOKE_PAGED}
#: max |dlogit| of a TP = 2 arm's committed rows, teacher-forced to the
#: single-rank plain run's draws (bf16, full-width llama3.2-1b, logits of
#: ~200); set between the sound readings of both arms and the contiguous
#: arm with the decode kernel one key short on both ranks, which must break
#: it (NVIDIA H100 80GB HBM3, 700 W: sound 4.857 and 4.643, one key short
#: 13.164; each rank rounds its row-parallel partial sums to bf16)
TP_DLOGIT_BOUND = 8.0
TP_LABEL = "2 ranks on one card, no interconnect"
#: set while the tp phase runs beside the main sequence (``main``): its
#: walls are taken under that load, and its lines say so
TP_BESIDE = {"on": False}


def tp_label(single: bool = False) -> str:
    """TP_LABEL (``single``: the single rank's), and whether the walls on
    the line were taken beside the main sequence."""
    label = "one rank, whole model" if single else TP_LABEL
    return label + (", beside the main sequence" if TP_BESIDE["on"] else "")
TP_STEPS = 10  # decode steps timed a rank
#: a TP run's host counters: prefills, steps, mixed steps, preemptions,
#: chunks, speculative steps
TP_HOST = ("prefills", "decode_steps", "mixed_steps", "n_preemptions", "prefill_chunks",
           "spec_steps")
#: the tp phase's family arms, served at TP = 2 after the llama arms, each
#: at full width, cut in depth as its single-rank phase (``layers``, None:
#: all), in ``dtype``, AutoQuant'd whole by ``quant``: ``trace`` "serve"
#: (the dense phase's trace: ``reqs`` requests of the llama_humaneval
#: profile, ``new`` tokens each) or "it" (``reqs`` I-T prompts of N_IMAGE
#: image tokens and IT_TEXT + 0..2 text tokens, ``new`` greedy tokens, on a
#: paged, chunked pool that holds them all); ``arms``: arm -> (temperature,
#: top-p, speculative, geometry); ``control``: the arm served again with the
#: decode kernel one key short (None: no control). The f32 arms at reduced
#: depth are the deciding checks where bf16's own drift hides one key short
#: (chameleon's 1030-key contexts, dyn's int8 codes flipping at rounding
#: boundaries): their bf16 arms check host counters, launches, bytes and
#: finite readings, with no bound
TP_IT_PAD = IT_LEN + 2
#: the S-T arms: beam groups of N_BEAMS (SLOTS streams), the prompt's pad
#: (BOS and up to 2 text tokens) and the decode step's timed context
TP_ST_GROUPS, TP_ST_PAD, TP_ST_STEP_PAD = SLOTS // N_BEAMS, 4, 16
TP_IT_GEOMETRY = dict(paged=True, chunked=True, block_size=16, prefill_budget=256,
                      num_blocks=8 * -(-(TP_IT_PAD + MAX_NEW + 1) // 16) + 1)
_CONTIGUOUS = {"contiguous": (0.0, 1.0, False, {})}
TP_FAMILIES = {
    "chameleon": dict(arch="chameleon-34b", layers=CHAMELEON_LAYERS, dtype="bfloat16",
                      trace="it", reqs=8, new=8,
                      arms={"chunked": (0.0, 1.0, False, TP_IT_GEOMETRY)}, control=None),
    "chameleon f32": dict(arch="chameleon-34b", layers=2, dtype="float32", trace="it", reqs=2,
                          new=4, arms={"chunked": (0.0, 1.0, False, TP_IT_GEOMETRY)},
                          control="chunked"),
    "moe": dict(arch="qwen3-moe-30b-a3b", layers=4, dtype="bfloat16", trace="serve",
                reqs=DENSE_REQUESTS, new=DENSE_MAX_NEW,
                arms={**_CONTIGUOUS, "chunked": (0.0, 1.0, False, PAGED_ARMS["chunked"]),
                      "spec t=0.8": (SPEC_TEMP, SPEC_TOP_P, True, {})}, control="contiguous"),
    "mla": dict(arch="deepseek-v2-236b", layers=3, dtype="bfloat16", trace="serve",
                reqs=DENSE_REQUESTS, new=DENSE_MAX_NEW,
                arms={**_CONTIGUOUS, "chunked": (0.0, 1.0, False, PAGED_ARMS["chunked"])},
                control="contiguous"),
    "quant wo": dict(arch="llama3.2-1b", layers=None, dtype="bfloat16", quant="wo",
                     trace="serve", reqs=DENSE_REQUESTS, new=DENSE_MAX_NEW, arms=_CONTIGUOUS,
                     control="contiguous"),
    "quant dyn": dict(arch="llama3.2-1b", layers=None, dtype="bfloat16", quant="dyn",
                      trace="serve", reqs=DENSE_REQUESTS, new=DENSE_MAX_NEW, arms=_CONTIGUOUS,
                      control=None),
    "quant dyn f32": dict(arch="llama3.2-1b", layers=2, dtype="float32", quant="dyn",
                          trace="serve", reqs=DENSE_REQUESTS, new=DENSE_MAX_NEW,
                          arms=_CONTIGUOUS, control="contiguous"),
    # mamba2: a rank's 12 of 24 heads, its gate norm's sums reduced; the
    # control: the split-row kernel's partial sums one column short
    "ssm": dict(arch="mamba2-130m", layers=None, dtype="bfloat16", trace="serve",
                reqs=DENSE_REQUESTS, new=DENSE_MAX_NEW,
                arms={"greedy": (0.0, 1.0, False, {}),
                      "t=0.8": (SPEC_TEMP, SPEC_TOP_P, False, {})},
                control="greedy", short="split"),
    "ssm f32": dict(arch="mamba2-130m", layers=2, dtype="float32", trace="serve",
                    reqs=DENSE_REQUESTS, new=DENSE_MAX_NEW,
                    arms={"greedy": (0.0, 1.0, False, {})}, control="greedy", short="split"),
    # the S-T families: each request its own frames; whisper's vocabulary
    # (51865) whole on each rank, seamless's split; beam groups forced to
    # the plain run's beams (``beam_rows``); the control: the decode kernel
    # one key short
    "whisper": dict(arch="whisper-base", layers=None, dtype="bfloat16", trace="st",
                    reqs=DENSE_REQUESTS, groups=TP_ST_GROUPS, new=DENSE_MAX_NEW,
                    arms={"greedy": (0.0, 1.0, False, {}), "beams": (0.0, 1.0, "beams", {})},
                    control="greedy", step_pad=TP_ST_STEP_PAD),
    "seamless": dict(arch="seamless-m4t", layers=None, dtype="bfloat16", trace="st",
                     reqs=DENSE_REQUESTS, new=DENSE_MAX_NEW,
                     arms={"greedy": (0.0, 1.0, False, {})}, control="greedy",
                     step_pad=TP_ST_STEP_PAD),
    # recurrentgemma-2b: a rank's 5 of 10 heads over the one KV head (whole
    # on each rank) and 1280 of 2560 RG-LRU channels. The serve trace (8 x
    # 16 at pad 256, the pool's max_len 321: a ring of 321 rows, odd, whole
    # on each rank) runs the decode kernel at G * D = 1280; the long trace
    # (2 x 3072 + 32: a ring of 2048, split along its rows) runs
    # ``sp_decode``. bf16's noise hides one key short on either route (on
    # 16 x 64: 8.244 sound against 8.758; on the long arm the control read
    # 7.853 against 7.888 sound: NVIDIA H100 80GB HBM3, 700 W), so the bf16
    # arms run no control and the f32 arms of HYBRID_F32_LAYERS layers (two
    # attention layers) decide on each route, the long one's control the
    # partial form one key short on each rank; ``hybrid`` times the decode
    # step on both routes (``step=False``: no step of its own)
    "hybrid": dict(arch=HYBRID_ARCH, layers=None, dtype="bfloat16", trace="serve",
                   reqs=DENSE_REQUESTS, new=DENSE_MAX_NEW, arms=_CONTIGUOUS, control=None,
                   step_routes=True),
    "hybrid long": dict(arch=HYBRID_ARCH, layers=None, dtype="bfloat16", trace="long",
                        reqs=LONG_BATCH, new=LONG_NEW, arms=_CONTIGUOUS, control=None,
                        step=False),
    "hybrid f32": dict(arch=HYBRID_ARCH, layers=HYBRID_F32_LAYERS, dtype="float32",
                       trace="serve", reqs=DENSE_REQUESTS, new=DENSE_MAX_NEW, arms=_CONTIGUOUS,
                       control="contiguous", step=False),
    "hybrid long f32": dict(arch=HYBRID_ARCH, layers=HYBRID_F32_LAYERS, dtype="float32",
                            trace="long", reqs=LONG_BATCH, new=LONG_NEW, arms=_CONTIGUOUS,
                            control="contiguous", short="partial", step=False),
}
#: each family's bounds on a forced TP = 2 run against the single-rank plain
#: path: (the first MoE layer's max |dprob|, max |dlogit| of rows routed
#: alike), set between the sound readings and the one-key-short control
#: (NVIDIA H100 80GB HBM3, 700 W; the readings repeat to the bit): the
#: chameleon f32 arm 0.000011 / 0.010384; qwen3-moe |dprob| 0.000621 /
#: 0.003469, |dlogit| 0.048828 / 0.220703; deepseek-v2 0.001523 / 0.003371,
#: 0.046875 / 0.236572 (the single-rank moe phase's bounds); llama wo 4.383
#: / 13.089; the dyn f32 arm 2.465 / 7.485. None: no bound, the reading is
#: printed and must be finite (bf16 chameleon, on 8 x 16 tokens, read
#: 0.048828 sound and 0.055664 one key short, one bf16 step apart; bf16
#: dyn 14.376 and 19.347, int8 codes flipping at rounding boundaries: a
#: bound between them has no margin on either side, so their f32 arms
#: decide). The ssm and S-T families: whisper-base 0.0625 (greedy and beams) / one
#: key short 2.4219, seamless-m4t 0.0625 / 2.6328; mamba2-130m in bf16
#: 5.2560 (t = 0.8: 5.4717) against the split-row norm's sums one column
#: short 5.6123, 1.07x: no margin for a bound, so none, and its f32 arm
#: of 2 layers decides: 0.000216 against 0.580139
TP_FAMILY_BOUND = {"chameleon": None, "chameleon f32": (0.0, 0.001),
                   "moe": (FORCED_DPROB_BOUND, FORCED_DLOGIT_BOUND),
                   "mla": (FORCED_DPROB_BOUND, FORCED_DLOGIT_BOUND),
                   "quant wo": (0.0, TP_DLOGIT_BOUND), "quant dyn": None,
                   "quant dyn f32": (0.0, 4.3), "ssm": None, "ssm f32": (0.0, 0.01),
                   "whisper": (0.0, 0.5), "seamless": (0.0, 0.5),
                   "hybrid": None, "hybrid long": None, "hybrid f32": (0.0, 0.01),
                   "hybrid long f32": (0.0, 0.01)}
#: sp_decode's check at llama3.2-1b's decode shapes: cache rows, split in
#: halves over the two ranks
SP_ROWS = 4096
#: the f32 smoke configs served at TP = 2 on both smoke pools
TP_SMOKE_ARCHS = ("llama3.2-1b", "chameleon-34b", "qwen3-moe-30b-a3b", "deepseek-v2-236b")
#: ``python3 chip_smoke.py tp FAMILY ...`` runs those TP_FAMILIES alone (the
#: ranks get them from ``phase_tp``)
TP_ONLY = []


def _tp_host(m):
    return {k: m.get(k, 0) for k in TP_HOST}


def _decode_step_times(model, params, pad_to, cfg, group=None, extra=None, max_len=None):
    """One 8-slot decode step over a cache prefilled to ``pad_to`` (every
    step at that length; ``extra`` joins the prefill: an encoder-decoder's
    frames) of ``max_len`` rows (default ``pad_to + 16``; a hybrid's ring
    ``min(max_len, window)``): wall ms (CUDA-synchronised, TP_STEPS steps),
    the device ms of its kernels and of its copies (torch.profiler), and
    under ``group`` the reduces a step and their host ms. Every rank of a
    group calls it alike."""
    import torch

    from repro_torch.core import engine

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    toks = torch.randint(0, cfg.vocab_size, (SLOTS, pad_to), generator=gen, device=dev,
                         dtype=torch.int32)
    lens = torch.full((SLOTS,), pad_to, dtype=torch.int32, device=dev)
    pre, dec = ((engine.prefill, engine.decode_step) if group is None else
                (engine.tp_prefill, engine.tp_decode_step))
    _, cache = pre(model, params, toks, lens, max_len or pad_to + 16, extra=extra)
    state = {"cache": cache, "tok": toks[:, -1].contiguous()}

    def step():
        logits, state["cache"] = dec(model, params, state["cache"], state["tok"])
        state["cache"]["lengths"].fill_(pad_to)
        state["tok"] = logits.argmax(-1).to(torch.int32)

    with torch.inference_mode():
        step()
        torch.cuda.synchronize()
        n0, s0 = (group.n_reduces, group.reduce_s) if group is not None else (0, 0.0)
        t0 = time.perf_counter()
        for _ in range(TP_STEPS):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / TP_STEPS * 1e3
        n1, s1 = (group.n_reduces, group.reduce_s) if group is not None else (0, 0.0)
        with profiler() as prof:
            for _ in range(TP_STEPS):
                step()
            torch.cuda.synchronize()
    kern = device_kernels(prof)
    copies = [e for e in kern if "memcpy" in e.name.lower() or "memset" in e.name.lower()]
    us = sum(e.time_range.elapsed_us() for e in kern)
    cus = sum(e.time_range.elapsed_us() for e in copies)
    del cache, state
    return dict(wall_ms=wall, device_ms=us / TP_STEPS / 1e3,
                copy_ms=cus / TP_STEPS / 1e3, kernels=(len(kern) - len(copies)) / TP_STEPS,
                reduces=(n1 - n0) / TP_STEPS, reduce_ms=(s1 - s0) / TP_STEPS * 1e3)


def _tp_smoke(group):
    """Each TP_SMOKE_ARCHS f32 smoke config through the kernels on each of
    TP_SMOKE's pools: single-rank on rank 0, then at TP = 2 on both ranks.
    Returns each (arch, pool)'s (TP tokens, single-rank tokens or None,
    launches)."""
    import torch.distributed as dist

    from repro_torch.distributed import tp_pool

    out = {}
    for arch in TP_SMOKE_ARCHS:
        cfg, model, params = smoke_build(arch, "float32")
        single = {}
        if group.rank == 0:
            for pool, geometry in TP_SMOKE.items():
                single[pool] = serve_once(
                    model, params, cfg, SMOKE_PAD, policy="continuous", int8_mode=None,
                    tag=f"tp smoke {arch} {pool} single-rank", **geometry,
                    reqs=_trace(cfg, SMOKE_PAD, n=SMOKE_REQS, max_new=SMOKE_NEW))[1]
        dist.barrier()
        tp = tp_pool.TPContext(model, params, group)
        for pool, geometry in TP_SMOKE.items():
            _, toks, counts = serve_once(
                tp.model, tp.params, cfg, SMOKE_PAD, policy="continuous", int8_mode=None,
                tag=f"tp smoke {arch} {pool} rank {group.rank}", tp=tp, **geometry,
                reqs=_trace(cfg, SMOKE_PAD, n=SMOKE_REQS, max_new=SMOKE_NEW))
            out[arch, pool] = (toks, single.get(pool), counts)
    return out


def it_trace(cfg, n, new):
    """``n`` greedy I-T requests of ``cfg`` (a VLM): N_IMAGE stub image
    tokens then IT_TEXT + 0..2 text tokens, ``new`` new tokens each."""
    import numpy as np

    from repro_torch.core.scheduler import ServeRequest
    from repro_torch.models import vlm

    rng = np.random.default_rng(SEED + 30)
    off = vlm.image_token_offset(cfg)
    return [ServeRequest(rid=i, max_new=new, prompt=np.concatenate(
        [off + rng.integers(0, cfg.vlm.image_vocab, N_IMAGE),
         rng.integers(0, off, IT_TEXT + i % 3)]).astype(np.int32)) for i in range(n)]


def tp_spec_bytes(cfg, params, size):
    """The bytes a rank holds of ``params`` under the serving specs
    (``sharding.tp_param_specs``): a split leaf's 1 / size, a replicated
    leaf whole; a Mamba-2 mixer's ``in_proj`` columns and conv channels
    those of its heads beside B and C whole (``2 * N`` of each, one
    group)."""
    from repro_torch.distributed import sharding

    flat = sharding.flat_specs(sharding.tp_param_specs(cfg, params, size))
    total = []

    def add(path, t):
        n = t.numel() * t.element_size()
        if "model" not in flat[path]:
            total.append(n)
            return
        d = flat[path].index("model")
        width = t.shape[d]
        if cfg.ssm is not None and re.search(r"mixer/(in_proj|conv_)", path):
            bc = 2 * cfg.ssm.n_groups * cfg.ssm.d_state
            total.append(n // width * ((width - bc) // size + bc))
        else:
            total.append(n // size)

    sharding.map_with_path(add, params)
    return sum(total)


def reduces_per_forward(cfg, quant=None, split=False):
    """The reduces a TP decode forward of ``cfg`` makes, counted from the
    model's structure (the oracle the measured counts are held to): the
    embedding and the logits' gather when the vocabulary splits (whisper's
    51865 stays whole: neither), two a layer (the attention, and the FFN or
    MoE: a MoE layer's routed and shared partials share one; a Mamba-2
    layer's gate-norm sums and ``out_proj``), three a decoder layer of an
    encoder-decoder (self and cross attention, the FFN), and under ``dyn``
    a max-reduce a row-parallel linear (``wo``, and a dense or shared FFN's
    ``w2``; the experts' stacks stay bf16). A hybrid: three a recurrent
    layer (the post-conv gather, ``proj_out``, the FFN) and two an attention
    layer, four over a ring split along its rows (``split``: the q heads'
    gather and the partials' exchange)."""
    n = 2 if cfg.vocab_size % TP_RANKS == 0 else 0
    if cfg.family == "hybrid":
        n_attn = _attn_layers(cfg)
        return n + 3 * (cfg.n_layers - n_attn) + (4 if split else 2) * n_attn
    for i in range(cfg.n_layers):
        n += 3 if cfg.encdec is not None else 2
        if quant == "dyn":
            moe = cfg.moe is not None and i >= cfg.moe.first_dense_layers
            n += 2 if not moe or cfg.moe.n_shared_experts else 1
    return n


def long_trace(cfg, n, new):
    """``n`` greedy requests of LONG_PROMPT random tokens (numpy, SEED + 32:
    every rank draws the same), ``new`` tokens each: the hybrid's
    long-context arm through the scheduler (a ring of the window's 2048
    rows, wrapped by the prompts)."""
    import numpy as np

    from repro_torch.core.scheduler import ServeRequest

    rng = np.random.default_rng(SEED + 32)
    return [ServeRequest(rid=i, max_new=new, prompt=rng.integers(
        0, cfg.vocab_size, LONG_PROMPT).astype(np.int32)) for i in range(n)]


def st_trace(cfg, n, new, beams=None):
    """``n`` S-T requests of the encoder-decoder ``cfg``: BOS then 0..2 text
    tokens, ``new`` tokens each, each with its own stub frames (N(0, 1) from
    SEED + 31 on the card, in the params' type) and its frame length
    (``st_frame_lengths``); with ``beams`` each a beam group whose profile
    is ``beams(rid)``. Every rank draws the same trace."""
    import numpy as np
    import torch

    from repro_torch.core.scheduler import ServeRequest
    from repro_torch.models import layers as L

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    rng = np.random.default_rng(SEED + 31)
    fl = st_frame_lengths(n, cfg.encdec.n_frames)
    reqs = []
    for i in range(n):
        frames = torch.randn((1, cfg.encdec.n_frames, cfg.d_model), generator=gen,
                             device=dev).to(L.param_dtype(cfg))
        prompt = np.concatenate([[BOS], rng.integers(3, cfg.vocab_size, i % 3)])
        reqs.append(ServeRequest(rid=i, prompt=prompt.astype(np.int32), max_new=new,
                                 profile=None if beams is None else beams(i),
                                 extra_inputs={"frames": frames,
                                               "frame_lengths": fl[i:i + 1]}))
    return reqs


def beam_rows(ref=None):
    """A ``BeamProfile`` of N_BEAMS beams (EOS) that keeps the logits rows
    of every step (``ref`` None: the plain run's record, ``rows``), or that
    takes the choice ``ref``'s rows give at every step (the plain run's
    beams, so the run takes its steps), keeping its own rows' max |dlogit|
    against them (``dl``) and whether its own choice differs (``differs``),
    as device scalars. A replay after a preemption starts anew."""
    from repro_torch.core import profiles

    class BeamProfile(profiles.BeamProfile):  # the name request_class reads
        def step(self, state, logits, key=None):
            if state.step == 0:
                self.rows, self.dl, self.differs = [], [], []
            if self.ref is None:
                self.rows.append(logits.float().clone())
                return super().step(state, logits, key)
            r = self.ref[len(self.dl)]
            want = super().step(state, r, key)
            own = super().step(state, logits, key)
            self.dl.append((logits.float() - r).abs().amax())
            self.differs.append(((own.feed != want.feed) | (own.perm != want.perm)).any())
            return want

    prof = BeamProfile(n_beams=N_BEAMS, eos_id=EOS)
    prof.ref, prof.rows, prof.dl, prof.differs = ref, [], [], []
    return prof


@contextlib.contextmanager
def split_sums_short():
    """The split-row RMSNorm's control: each row's partial sum of squares
    one column short (its last column's square left out) on every rank."""
    from repro_torch.kernels import rmsnorm as rn

    real = rn.mul_silu_partial_cuda

    def short(y, z):
        p, sumsq = real(y, z)
        return p, sumsq - p[..., -1].float() ** 2

    rn.mul_silu_partial_cuda = short
    try:
        yield
    finally:
        rn.mul_silu_partial_cuda = real


def tp_family(group, family, pad_to):
    """One TP_FAMILIES family on both ranks (``tp_rank``): the whole model
    built from SEED (AutoQuant'd whole first), and rank 0 serving each arm
    on the plain path, recorded (``Forced``, or a beam arm's ``beam_rows``,
    whose rows go to rank 1 too), while rank 1 waits; then each rank keeps
    its shard and serves each arm at TP = 2 (exact launches a rank, no
    leaked block), rank 0 forcing it to the plain run's draws (a beam arm:
    both ranks to its beams), the control arm again with its control (the
    decode kernel one key short, or the split-row norm's sums one column
    short) on both ranks; then a TP decode step's times. Returns the rank's
    numbers."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.kv_cache import cache_bytes
    from repro_torch.core.quantization import quantize_params
    from repro_torch.distributed import tp_pool
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.launch import serve

    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.training import data as data_mod

    t0 = time.perf_counter()
    fam = TP_FAMILIES[family]
    arms, control, quant = fam["arms"], fam["control"], fam.get("quant")
    rank0, dev = group.rank == 0, group.device
    cfg = get_config(fam["arch"]).replace(dtype=fam["dtype"])
    if fam["layers"] is not None:
        cfg = cfg.replace(n_layers=fam["layers"])
    model = get_model(cfg)
    with torch.inference_mode():
        params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
        if quant is not None:
            params = quantize_params(params, quant)
    trace = fam["trace"]
    pad = {"it": TP_IT_PAD, "st": TP_ST_PAD, "long": LONG_PROMPT}.get(trace) or (
        serve.trace_pad_to(data_mod.PAPER_PROFILES["llama_humaneval"], fam["reqs"], SEED))
    spec_exit = MOE_SPEC_EXIT if cfg.moe is not None else SPEC_EXIT

    def reqs(temp, top_p, beams=None):
        if trace == "it":
            return it_trace(cfg, fam["reqs"], fam["new"])
        if trace == "long":
            return long_trace(cfg, fam["reqs"], fam["new"])
        if trace == "st":
            return st_trace(cfg, fam["groups"] if beams else fam["reqs"], fam["new"], beams)
        return _trace(cfg, pad, temp, top_p, n=fam["reqs"], max_new=fam["new"])

    out = {"arms": {}, "whole_param_bytes": cache_bytes(params),
           "spec_param_bytes": tp_spec_bytes(cfg, params, group.size)}
    plain = {}
    if rank0:
        for arm, (temp, top_p, spec, geometry) in arms.items():
            tag = f"tp {family} {arm} single-rank plain"
            if spec == "beams":
                rs = reqs(temp, top_p, lambda i: beam_rows())
                with plain_path():
                    mp, ptoks, _ = serve_once(model, params, cfg, pad, policy="continuous",
                                              int8_mode=quant, tag=tag, reqs=rs, **geometry)
                plain[arm] = ({r.rid: [row.cpu() for row in r.profile.rows] for r in rs},
                              ptoks)
            else:
                rec = Forced("record")
                with plain_path(), forcing(rec):
                    mp, ptoks, _ = serve_once(model, params, cfg, pad, policy="continuous",
                                              int8_mode=quant, tag=tag, temperature=temp,
                                              top_p=top_p, speculative=spec,
                                              spec_exit=spec_exit, reqs=reqs(temp, top_p),
                                              **geometry)
                plain[arm] = (rec, ptoks)
            out["arms"][arm] = {"single": dict(_tp_host(mp),
                                               kv_reserved_bytes=mp["kv_reserved_bytes"])}
    step_pad = fam.get("step_pad", pad_to)
    routes = (step_routes(step_pad) if fam.get("step_routes") else
              {"": None} if fam.get("step", True) else {})
    if rank0 and fam.get("step_routes"):  # the whole model's step beside the ranks'
        out["single_steps"] = {label: _decode_step_times(model, params, step_pad, cfg,
                                                         max_len=max_len)
                               for label, max_len in routes.items()}
    dist.barrier()
    beam_refs = [{arm: plain[arm][0] for arm, a in arms.items() if a[2] == "beams"}
                 if rank0 else None]
    if any(a[2] == "beams" for a in arms.values()):  # both ranks take the plain beams
        dist.broadcast_object_list(beam_refs, src=0)
    tp = tp_pool.TPContext(model, params, group)
    del model, params
    torch.cuda.empty_cache()
    for arm, (temp, top_p, spec, geometry) in arms.items():
        res = out["arms"].setdefault(arm, {})
        paged = geometry.get("paged", False)
        short = ((pda, "paged_decode_attention_cuda", 4) if paged else
                 (da, "decode_attention_cuda", 3))
        for run in ("forced", "control") if arm == control else ("forced",):
            tag = f"tp {family} {arm} rank {group.rank} {run}"
            rec, rs = None, None
            if spec == "beams":
                refs = beam_refs[0][arm]
                rs = reqs(temp, top_p, lambda i: beam_rows([x.to(dev) for x in refs[i]]))
            elif rank0:
                rec = Forced("steps", plain[arm][0])
            ctl = contextlib.nullcontext()
            if run == "control" and fam.get("short") == "split":
                ctl = split_sums_short()
            elif run == "control" and fam.get("short") == "partial":  # sp_decode's partials
                ctl = one_key_short(da, "decode_attention_partial_cuda", 3)
            elif run == "control":
                ctl = one_key_short(*short)
            with (forcing(rec) if rec is not None else contextlib.nullcontext()), ctl:
                m, toks, counts = serve_once(tp.model, tp.params, cfg, pad, policy="continuous",
                                             int8_mode=quant, tag=tag, temperature=temp,
                                             top_p=top_p, speculative=spec is True,
                                             spec_exit=spec_exit, tp=tp,
                                             reqs=rs if rs is not None else reqs(temp, top_p),
                                             **geometry)
            r = dict(host=_tp_host(m), counts=counts, **{k: m[k] for k in (
                "tokens_per_s", "ttft_p50_ms", "tpot_p50_ms", "wall_s", "kv_reserved_bytes",
                "kv_reserved_per_device_bytes", "param_bytes_per_device", "reduces",
                "reduce_s", "decode_steps", "prefills")})
            if rec is not None:
                r["bounds"] = rec.summary(tag)[:2]
                r["plain_tokens"] = toks == plain[arm][1]
            elif rs is not None and rank0:
                dl = max(float(torch.stack(q.profile.dl).max()) for q in rs)
                picks = sum(int(torch.stack(q.profile.differs).sum()) for q in rs)
                steps = sum(len(q.profile.dl) for q in rs)
                print(f"[{tag}] {len(rs)} beam groups forced to the plain run's beams over "
                      f"{steps} group steps | rows' max|dlogit| {dl:.6f} | steps whose own "
                      f"choice differs {picks}", flush=True)
                r["bounds"] = (0.0, dl)
                r["plain_tokens"] = toks == plain[arm][1]
            res[run] = r
    extra = None
    if cfg.encdec is not None:  # the decode step's prefill reads frames
        st = st_trace(cfg, SLOTS, 1)
        extra = {"frames": torch.cat([r.extra_inputs["frames"] for r in st]),
                 "frame_lengths": torch.tensor([int(r.extra_inputs["frame_lengths"][0])
                                                for r in st], device=dev)}
    out["steps"] = {label: dict(
        _decode_step_times(tp.model, tp.params, step_pad, cfg, group, extra, max_len),
        want=reduces_per_forward(cfg, quant, split_ring(cfg, max_len or step_pad + 16, tp)))
        for label, max_len in routes.items()}
    out["pad"] = pad
    out["seconds"] = time.perf_counter() - t0
    del tp, plain
    torch.cuda.empty_cache()
    return out


def sp_decode_check(group):
    """``attention.sp_decode`` on this rank at llama3.2-1b's decode shapes
    (8 slots, 32 q heads over 8 KV heads of 64, bf16) over SP_ROWS cache
    rows split in halves, every rank alike, against the single-rank decode
    kernel on the whole written cache: max |err| (bf16 tolerance), its rows
    bit for bit the whole cache's write, the launches of one call (a
    partial form, a merge) and its wall ms (the exchange's reduce included;
    TP_STEPS calls) beside the single-rank kernel's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import counts as kcounts
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import attention as A

    cfg = get_config(ARCH)
    dev, bf = group.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 33)
    hq, hkv, d, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, SP_ROWS
    q = _rand(gen, (SLOTS, hq, d), bf, dev)
    kc, vc = (_rand(gen, (SLOTS, s, hkv, d), bf, dev) for _ in range(2))
    kn, vn = (_rand(gen, (SLOTS, hkv, d), bf, dev) for _ in range(2))
    ln = torch.tensor([0, 1, 63, 64, 65, s // 2 - 1, s // 2, s - 1], dtype=torch.int32,
                      device=dev)
    n = s // group.size
    rows = slice(group.rank * n, (group.rank + 1) * n)
    cache = {"k": kc[:, rows].clone(), "v": vc[:, rows].clone()}
    before = kcounts.snapshot()
    with torch.inference_mode():
        out, cache = A.sp_decode(cache, kn, vn, q, ln, group)
        launched = {k: v for k, v in kcounts.since(before).items() if v}
        wk, wv = A.write_decode(kc.clone(), kn, ln), A.write_decode(vc.clone(), vn, ln)
        want = da.decode_attention_cuda(q, wk, wv, ln + 1)
        err = max_err(out.to(bf), want, "bfloat16")
        same = bool(torch.equal(cache["k"], wk[:, rows]) and torch.equal(cache["v"], wv[:, rows]))
        torch.cuda.synchronize()
        group.all_reduce(torch.zeros(1, device=dev))  # both ranks start the loop together
        t0 = time.perf_counter()
        for _ in range(TP_STEPS):
            A.sp_decode(cache, kn, vn, q, ln, group)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / TP_STEPS * 1e3
    return dict(err=err, same=same, launched=launched, wall_ms=wall,
                single_ms=cuda_ms(lambda: da.decode_attention_cuda(q, wk, wv, ln + 1)),
                lengths=ln.tolist())


def check_sp(ranks) -> list:
    """Prints both ranks' ``sp_decode_check``; returns its failures: rows
    not the whole write's, a call that did not launch one partial form and
    one merge."""
    bad = []
    for rank, r in enumerate(ranks):
        sp = r["sp"]
        ok = {"decode_attention_partial": 1, "combine_partial_attention": 1}
        if not sp["same"]:
            bad.append(f"sp_decode rank {rank}: its cache rows are not the whole write's")
        if sp["launched"] != ok:
            bad.append(f"sp_decode rank {rank}: launched {sp['launched']}, want {ok}")
        print(f"[tp sp_decode] llama3.2-1b decode shapes (q[{SLOTS},32,64], cache[{SLOTS},"
              f"{SP_ROWS},8,64] bf16 split in halves, lengths {sp['lengths']}), {tp_label()} | "
              f"rank {rank}: max |err| {sp['err']:.6f} against the single-rank decode kernel | "
              f"rows the whole write's: {sp['same']} | launches {sp['launched']} | "
              f"{sp['wall_ms']:.4f} ms a call (its reduce included; the single-rank kernel "
              f"{sp['single_ms']:.4f} ms)", flush=True)
    return bad


def step_routes(pad_to):
    """The hybrid's decode step on both of a TP rank's ring routes at
    ``pad_to`` tokens: label -> max_len, whose ring of ``min(max_len,
    2048)`` rows is odd (whole on each rank) or even (split along its
    rows)."""
    odd = pad_to + 16 + (pad_to + 1) % 2
    return {"whole ring": odd, "split ring": odd - 1}


def tp_rank(group, pad_to, only=()):
    """One rank of the tp phase (``tp_pool.spawn``; both on cuda:0, gloo).
    Rank 0 first serves both arms on the whole model on the plain path,
    recorded (``Forced``), and times a single-rank decode step, while rank 1
    waits. Then each rank keeps its shard (``TPContext``) and serves each arm
    at TP = 2 through ``serve_once`` (exact launches a rank, no leaked block):
    the contiguous arm sound, teacher-forced to the plain run's draws (rank 0
    forces and compares; its tokens reach rank 1 through the scheduler's
    broadcast) and forced with the decode kernel one key short on both ranks;
    the chunked arm forced. Then the TP decode step's times, the
    TP_FAMILIES arms (``tp_family``) and the smoke width. Returns the
    rank's numbers."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.kv_cache import cache_bytes
    from repro_torch.distributed import tp_pool
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank0 = group.rank == 0
    dev = group.device
    out = {"rank": group.rank, "arms": {}, "backend": group.backend,
           "slots": group.slots is not None}
    TP_ONLY[:] = only
    if TP_ONLY:  # ``python3 chip_smoke.py tp FAMILY ...``: those families alone
        out["families"] = {f: tp_family(group, f, pad_to) for f in TP_ONLY}
        out["sp"] = sp_decode_check(group)
        return out
    cfg, model, params = serve.build_model(ARCH, smoke=False, seed=SEED, device=dev)
    out["whole_param_bytes"] = cache_bytes(params)
    plain = {}
    if rank0:
        for arm, geometry in TP_ARMS.items():
            rec = Forced("record")
            with plain_path(), forcing(rec):
                mp, ptoks, _ = serve_once(model, params, cfg, pad_to, policy="continuous",
                                          int8_mode=None, tag=f"tp {arm} single-rank plain",
                                          **geometry)
            plain[arm] = (rec, mp, ptoks)
            out["arms"][arm] = {"single": dict(_tp_host(mp),
                                               kv_reserved_bytes=mp["kv_reserved_bytes"])}
        # the single-rank kernel path forced alike: the reading TP's sits beside
        rec = Forced("steps", plain["contiguous"][0])
        tag = "tp contiguous single-rank kernels forced"
        with forcing(rec):
            serve_once(model, params, cfg, pad_to, policy="continuous", int8_mode=None, tag=tag)
        out["single_dlogit"] = rec.summary(tag)[1]
        out["single_step"] = _decode_step_times(model, params, pad_to, cfg)
    dist.barrier()
    tp = tp_pool.TPContext(model, params, group)
    del model, params
    torch.cuda.empty_cache()
    for arm, geometry in TP_ARMS.items():
        serve.warmup(tp.model, tp.params, slots=SLOTS, pad_to=pad_to, max_new_cap=MAX_NEW,
                     device=dev, tp=tp, **geometry)
        res = out["arms"].setdefault(arm, {})
        for run in (("sound", "forced", "control") if arm == "contiguous" else ("forced",)):
            tag = f"tp {arm} rank {group.rank} {run}"
            rec = Forced("steps", plain[arm][0]) if rank0 and run != "sound" else None
            with (forcing(rec) if rec is not None else contextlib.nullcontext()), \
                    (one_key_short(da, "decode_attention_cuda", 3) if run == "control"
                     else contextlib.nullcontext()):
                m, toks, counts = serve_once(tp.model, tp.params, cfg, pad_to,
                                             policy="continuous", int8_mode=None, tag=tag,
                                             tp=tp, **geometry)
            r = dict(host=_tp_host(m), counts=counts, **{k: m[k] for k in (
                "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms", "wall_s",
                "kv_reserved_bytes", "kv_reserved_per_device_bytes", "param_bytes_per_device",
                "reduces", "reduce_s", "decode_steps", "prefills")})
            if rec is not None:
                r["dlogit"] = rec.summary(tag)[1]
                r["plain_tokens"] = toks == plain[arm][2]
            res[run] = r
    out["step"] = _decode_step_times(tp.model, tp.params, pad_to, cfg, group)
    del tp, plain
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    out["families"] = {family: tp_family(group, family, pad_to) for family in TP_FAMILIES}
    out["sp"] = sp_decode_check(group)
    t0 = time.perf_counter()
    out["smoke"] = _tp_smoke(group)
    out["smoke_seconds"] = time.perf_counter() - t0
    return out


def phase_tp(pad_to):
    """Full-width llama3.2-1b (bf16, seeded weights) served at TP = 2 by two
    ``torch.distributed`` ranks that share the one card under gloo
    (``tp_rank``, the kernels built here first so the ranks only load them):
    each arm teacher-forced to the single-rank plain run's draws within
    TP_DLOGIT_BOUND, which the contiguous arm with the decode kernel one key
    short breaks; every run's host counters the single-rank run's; each
    rank's launches exact and the same on both ranks; each rank's KV pool at
    most 0.6x the single pool (its ranks' pools counted once are the single
    pool's bytes). Then the TP_FAMILIES arms (chameleon-34b, qwen3-moe,
    deepseek-v2, AutoQuant'd llama; ``check_tp_family``) and the
    TP_SMOKE_ARCHS f32 smoke configs, whose TP tokens must be the
    single-rank kernel run's. Prints the backend, the bytes a rank holds,
    tok/s and TTFT, a decode step's wall and device ms and its reduces
    (TP_LABEL). Returns rank 0's results."""
    from repro_torch.distributed import tp_pool

    t0 = time.perf_counter()
    with expandable_segments():  # both ranks build whole models beside each other
        ranks = tp_pool.spawn(tp_rank, TP_RANKS, pad_to, tuple(TP_ONLY),
                              devices=list(TP_DEVICES))
    r0 = ranks[0]
    check(all(r["backend"] == "gloo" and r["slots"] for r in ranks),
          f"tp: backends {[r['backend'] for r in ranks]}, shared slots "
          f"{[r['slots'] for r in ranks]}")
    if TP_ONLY:
        bad = [msg for family in TP_ONLY
               for msg in check_tp_family(family, [r["families"][family] for r in ranks],
                                          pad_to)] + check_sp(ranks)
        print(f"[tp] phase {time.perf_counter() - t0:.1f} s", flush=True)
        check(not bad, f"tp: {len(bad)} family checks failed: {bad}")
        return r0
    print(f"[tp] {tp_label()}: {TP_RANKS} ranks on {', '.join(TP_DEVICES)}, backend "
          f"{r0['backend']} (collectives of up to {tp_pool.SLOT_BYTES} B through the ranks' "
          "shared host slots, larger ones through gloo on the CUDA tensors)", flush=True)
    for arm in TP_ARMS:
        single = r0["arms"][arm]["single"]
        want = {k: single[k] for k in TP_HOST}
        for r in ranks:
            for run, res in r["arms"][arm].items():
                if run == "single":
                    continue
                check(res["host"] == want, f"tp {arm} rank {r['rank']} {run}: host counters "
                      f"{res['host']}, the single-rank run's {want}")
                check(res["counts"] == r0["arms"][arm][run]["counts"],
                      f"tp {arm} {run}: rank {r['rank']}'s launches differ from rank 0's")
                ratio = res["kv_reserved_per_device_bytes"] / single["kv_reserved_bytes"]
                check(res["kv_reserved_bytes"] == single["kv_reserved_bytes"] and ratio <= 0.6,
                      f"tp {arm} rank {r['rank']}: KV {res['kv_reserved_per_device_bytes']} B a "
                      f"rank of {res['kv_reserved_bytes']} B, the single pool "
                      f"{single['kv_reserved_bytes']} B")
        if TP_ARMS[arm].get("paged"):
            check(want["n_preemptions"] >= 1, f"tp {arm}: no preemption in the single-rank "
                  "run, the arm reaches no preemption")
        first = r0["arms"][arm]["forced"]
        print(f"[tp {arm}] {tp_label()} | host counters {want} on both ranks, every run, as "
              f"the single-rank run's | KV reserved a rank "
              f"{first['kv_reserved_per_device_bytes']} B of {single['kv_reserved_bytes']} B "
              f"({first['kv_reserved_per_device_bytes'] / single['kv_reserved_bytes']:.4f}x) | "
              f"params a rank {first['param_bytes_per_device']} B of "
              f"{r0['whole_param_bytes']} B | launches a rank {first['counts']}", flush=True)
        for run, res in r0["arms"][arm].items():
            if run == "single":
                continue
            print(f"[tp {arm} {run}] {tp_label()} | {res['tokens_per_s']:.1f} tok/s | ttft p50 "
                  f"{res['ttft_p50_ms']:.2f} ms p99 {res['ttft_p99_ms']:.2f} ms | tpot p50 "
                  f"{res['tpot_p50_ms']:.3f} ms | wall {res['wall_s']:.2f} s | "
                  f"{res['prefills'] + res['decode_steps']} forwards, {res['reduces']} reduces, "
                  f"{res['reduce_s'] * 1e3:.1f} ms of host time in them"
                  + (f" | max |dlogit| {res['dlogit']:.6f} (bound {TP_DLOGIT_BOUND})"
                     if "dlogit" in res else ""), flush=True)
    dl = {(arm, run): res["dlogit"] for arm in TP_ARMS
          for run, res in r0["arms"][arm].items() if "dlogit" in res}
    print(f"[tp] forced max |dlogit| against the single-rank plain path: the single-rank "
          f"kernels {r0['single_dlogit']:.6f} | TP = {TP_RANKS} "
          + ", ".join(f"{arm} {run} {d:.6f}" for (arm, run), d in dl.items())
          + f" | bound {TP_DLOGIT_BOUND}", flush=True)
    for (arm, run), d in dl.items():
        check(r0["arms"][arm][run]["plain_tokens"],
              f"tp {arm} {run}: the forced run's tokens are not the plain run's")
        if run == "control":
            check(d > TP_DLOGIT_BOUND, f"tp {arm} control: a decode kernel one key short "
                  f"stayed within the bound ({d} <= {TP_DLOGIT_BOUND})")
        else:
            check(d <= TP_DLOGIT_BOUND, f"tp {arm}: max |dlogit| {d} against the single-rank "
                  f"plain path, bound {TP_DLOGIT_BOUND}")
    for name, st in (("single rank", r0["single_step"]), ("rank 0", r0["step"]),
                     ("rank 1", ranks[1]["step"])):
        print(f"[tp step] {tp_label(name == 'single rank')} | "
              f"{name}: an 8-slot decode step at {pad_to} tokens {st['wall_ms']:.3f} ms wall, "
              f"{st['device_ms']:.3f} ms device ({st['kernels']:.0f} kernels; "
              f"{st['copy_ms']:.3f} ms of it copies) | {st['reduces']:.0f} reduces a step, "
              f"{st['reduce_ms']:.3f} ms host in them", flush=True)
    print(f"[tp] the llama arms {r0['seconds']:.1f} s", flush=True)
    bad = [msg for family in TP_FAMILIES
           for msg in check_tp_family(family, [r["families"][family] for r in ranks], pad_to)]
    bad += check_sp(ranks)
    for (arch, pool), (toks, single, counts) in r0["smoke"].items():
        check(toks == single and ranks[1]["smoke"][arch, pool][0] == single,
              f"tp smoke {arch} {pool}: the TP = 2 tokens differ from the single-rank kernel "
              "run's")
        check(counts == ranks[1]["smoke"][arch, pool][2],
              f"tp smoke {arch} {pool}: rank 1's launches differ from rank 0's")
        print(f"[tp smoke {arch} {pool}] f32 smoke config, {tp_label()}: {len(single)} requests' "
              f"tokens on both ranks the single-rank kernel run's | launches a rank {counts}",
              flush=True)
    print(f"[tp] the f32 smoke configs {r0['smoke_seconds']:.1f} s", flush=True)
    print(f"[tp] phase {time.perf_counter() - t0:.1f} s", flush=True)
    check(not bad, f"tp: {len(bad)} family checks failed: {bad}")
    return r0


def check_tp_family(family, ranks, pad_to):
    """Prints a TP_FAMILIES family's readings on both ranks' results
    (``tp_family``): the bytes a rank holds, each run's forced readings, a
    decode step's times and reduces. Returns its failures: a run's host
    counters not the single-rank plain run's, launches that differ across
    ranks, forced tokens not the plain run's, a sound run outside the
    family's TP_FAMILY_BOUND or the control within it (a family without a
    bound: a reading not finite), params a rank not
    what the serving specs give, KV a rank not half the head-split pool (at
    most 0.6x) or, for MLA, not the whole latent pool, reduces a step not
    ``reduces_per_forward``'s."""
    from repro_torch.configs import get_config

    fam = TP_FAMILIES[family]
    arch, quant, arms = fam["arch"], fam.get("quant"), fam["arms"]
    r0 = ranks[0]
    bound = TP_FAMILY_BOUND[family]
    mla = arch.startswith("deepseek")
    # a hybrid's whole ring is on every rank: only its state and conv split
    whole_ring = arch == HYBRID_ARCH and (
        min(r0["pad"] + MAX_NEW + 1, get_config(arch).hybrid.window) % TP_RANKS)
    bad = []

    def want(cond, msg):
        if not cond:
            bad.append(msg)

    for arm in arms:
        single = r0["arms"][arm]["single"]
        host = {k: single[k] for k in TP_HOST}
        first = r0["arms"][arm]["forced"]
        print(f"[tp {family} {arm}] {arch}, {tp_label()} | host counters {host} (single rank) | "
              f"KV reserved a rank {first['kv_reserved_per_device_bytes']} B of "
              f"{first['kv_reserved_bytes']} B "
              f"({first['kv_reserved_per_device_bytes'] / first['kv_reserved_bytes']:.4f}x"
              f"{', the latent whole' if mla else ''}) | params a rank "
              f"{first['param_bytes_per_device']} B of {r0['whole_param_bytes']} B (the specs "
              f"give {r0['spec_param_bytes']} B) | launches a rank {first['counts']}", flush=True)
        for rank, r in enumerate(ranks):
            for run, res in r["arms"][arm].items():
                if run == "single":
                    continue
                tag = f"tp {family} {arm} rank {rank} {run}"
                want(res["host"] == host, f"{tag}: host counters {res['host']}, the single-rank "
                     f"run's {host}")
                want(res["counts"] == r0["arms"][arm][run]["counts"],
                     f"{tag}: launches differ from rank 0's")
                want(res["param_bytes_per_device"] == r0["spec_param_bytes"],
                     f"{tag}: {res['param_bytes_per_device']} B of params a rank, the serving "
                     f"specs give {r0['spec_param_bytes']} B")
                per, whole = res["kv_reserved_per_device_bytes"], res["kv_reserved_bytes"]
                want(whole == single["kv_reserved_bytes"] and
                     (per == whole if mla else per < whole if whole_ring else
                      per / whole <= 0.6),
                     f"{tag}: KV {per} B a rank of {whole} B, the single pool "
                     f"{single['kv_reserved_bytes']} B")
        for run, res in r0["arms"][arm].items():
            if run == "single":
                continue
            dprob, dlogit = res["bounds"]
            print(f"[tp {family} {arm} {run}] {tp_label()} | {res['tokens_per_s']:.1f} tok/s | "
                  f"ttft p50 {res['ttft_p50_ms']:.2f} ms | tpot p50 {res['tpot_p50_ms']:.3f} ms "
                  f"| wall {res['wall_s']:.2f} s | {res['prefills'] + res['decode_steps']} "
                  f"forwards, {res['reduces']} reduces, {res['reduce_s'] * 1e3:.1f} ms of host "
                  f"time in them | first MoE layer max |dprob| {dprob:.6f}, max |dlogit| "
                  f"{dlogit:.6f} " + (f"(bounds {bound[0]}, {bound[1]})" if bound else
                                      "(no bound: the f32 arm decides)"), flush=True)
            want(res["plain_tokens"], f"tp {family} {arm} {run}: the forced run's tokens are "
                                      "not the plain run's")
            if bound is None:
                want(math.isfinite(dprob) and math.isfinite(dlogit),
                     f"tp {family} {arm} {run}: readings {dprob}, {dlogit} not finite")
                continue
            dprob_bound, dlogit_bound = bound
            within = dprob <= dprob_bound and dlogit <= dlogit_bound
            if run == "control":
                want(not within, f"tp {family} {arm} control: a decode kernel one key short "
                     f"stayed within the bounds ({dprob}, {dlogit})")
            else:
                want(within, f"tp {family} {arm}: max |dprob| {dprob}, max |dlogit| {dlogit} "
                     f"against the single-rank plain path, bounds {dprob_bound}, "
                     f"{dlogit_bound}")
    steps = [(f"rank {rank}", label, st) for rank, r in enumerate(ranks)
             for label, st in r["steps"].items()]
    steps += [("single rank", label, st) for label, st in r0.get("single_steps", {}).items()]
    for who, label, st in steps:
        if "want" in st:
            want(st["reduces"] == st["want"], f"tp {family} {who} {label}: {st['reduces']} "
                 f"reduces a decode step, reduces_per_forward gives {st['want']}")
        print(f"[tp {family} step{' ' + label if label else ''}] {arch}"
              f"{f' ({quant})' if quant else ''} {fam['dtype']}, {fam['layers'] or 'all'} "
              f"layers, {tp_label(who == 'single rank')} | {who}: an 8-slot decode step at "
              f"{fam.get('step_pad', pad_to)} tokens {st['wall_ms']:.3f} ms wall, "
              f"{st['device_ms']:.3f} ms device ({st['kernels']:.0f} kernels; "
              f"{st['copy_ms']:.3f} ms of it copies) | {st['reduces']:.0f} reduces a step, "
              f"{st['reduce_ms']:.3f} ms host in them", flush=True)
    print(f"[tp {family}] {r0['seconds']:.1f} s" + (f" | FAILED: {bad}" if bad else ""),
          flush=True)
    return bad


# ---------------------------------------------------------------- tp fleet
#: the tp fleet arm: 2 replicas, each a TP = 2 pool, on the tp phase's two
#: gloo ranks' card; process r is rank r of both replicas (every replica's
#: group the one TP_DEVICES pair, whole), the router's arms it is forced to
FLEET_REPLICAS = 2
FLEET_ARMS = {"contiguous": "x2", "chunked": "x2 chunked"}
FLEET_COUNTERS = ("n_decode_steps", "n_prefills", "n_chunks", "n_preemptions")


@contextlib.contextmanager
def kept_routers():
    """The ``ReplicaRouter``s made within (``serve._run_router``'s), kept
    in a list for their host state."""
    from repro_torch.core import router as router_mod

    real, kept = router_mod.ReplicaRouter, []

    class Kept(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.append(self)

    router_mod.ReplicaRouter = Kept
    try:
        yield kept
    finally:
        router_mod.ReplicaRouter = real


def fleet_host(router):
    """A fleet's host counters: placements, spills, requeues and each
    replica's steps, prefills, chunks and preemptions."""
    return {"placements": dict(router.placements), "spills": router.n_spills,
            "requeues": router.n_requeues,
            "replicas": [{k: getattr(s, k) for k in FLEET_COUNTERS} for s in router.replicas]}


def tp_fleet_rank(group, pad_to, want):
    """One process of the tp fleet arm (``tp_pool.spawn``; both on cuda:0,
    gloo), rank ``group.rank`` of both replicas. Rank 0 first serves each
    router arm of FLEET_ARMS again on the whole model, recorded
    (``Forced``), while rank 1 waits. Then each process serves each arm
    through ``ReplicaRouter(tp=2)`` (``serve_once``: exact launches a rank
    against the replicas' summed forwards, no leaked block), teacher-forced
    to the recording (rank 0 forces and compares; its tokens reach rank 1
    through each replica's broadcast), the contiguous arm also with the
    decode kernel one key short on both ranks. ``want``: arm -> the router
    arm's tokens and host counters. Returns the rank's numbers."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.kv_cache import cache_bytes
    from repro_torch.distributed import tp_pool
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank0 = group.rank == 0
    dev = group.device
    cfg, model, params = serve.build_model(ARCH, smoke=False, seed=SEED, device=dev)
    out = {"rank": group.rank, "arms": {}, "recorded": {}, "whole_param_bytes": cache_bytes(params),
           "spec_param_bytes": tp_spec_bytes(cfg, params, TP_RANKS)}
    recs = {}
    if rank0:
        for arm, router_arm in FLEET_ARMS.items():
            rec = Forced("record")
            tag = f"tp fleet {arm} router/{router_arm} recorded"
            with forcing(rec), kept_routers() as routers:
                _, toks, _ = serve_once(model, params, cfg, pad_to, policy="continuous",
                                        int8_mode=None, tag=tag, replicas=FLEET_REPLICAS,
                                        **TP_ARMS[arm])
            recs[arm] = rec
            out["recorded"][arm] = (toks == want[arm]["tokens"], fleet_host(routers[-1]))
    dist.barrier()
    devices = [TP_DEVICES] * FLEET_REPLICAS
    warm = tp_pool.TPContext(model, params, group)
    for geometry in TP_ARMS.values():
        serve.warmup(warm.model, warm.params, slots=SLOTS, pad_to=pad_to, max_new_cap=MAX_NEW,
                     device=dev, tp=warm, **geometry)
    del warm
    torch.cuda.empty_cache()
    for arm, geometry in TP_ARMS.items():
        res = out["arms"].setdefault(arm, {})
        for run in (("forced", "control") if arm == "contiguous" else ("forced",)):
            tag = f"tp fleet {arm} rank {group.rank} {run}"
            rec = Forced("steps", recs[arm]) if rank0 else None
            with (forcing(rec) if rec is not None else contextlib.nullcontext()), \
                    (one_key_short(da, "decode_attention_cuda", 3) if run == "control"
                     else contextlib.nullcontext()), kept_routers() as routers:
                m, toks, counts = serve_once(model, params, cfg, pad_to, policy="continuous",
                                             int8_mode=None, tag=tag, tp=TP_RANKS, group=group,
                                             replicas=FLEET_REPLICAS, devices=devices,
                                             **geometry)
            router = routers[-1]
            r = dict(host=fleet_host(router), counts=counts, tokens=toks == want[arm]["tokens"],
                     slots=[s.tp.group.slots is not None for s in router.replicas],
                     shared=router.replicas[0].tp.params is router.replicas[1].tp.params,
                     **{k: m[k] for k in (
                         "tokens_per_s", "ttft_p50_ms", "tpot_p50_ms", "wall_s", "busy_max_s",
                         "aggregate_tokens_per_s", "kv_reserved_bytes",
                         "kv_reserved_per_device_bytes", "param_bytes_per_device", "backend",
                         "per_replica")})
            if rec is not None:
                r["dlogit"] = rec.summary(tag)[1]
            res[run] = r
            del router, routers  # its shard and pools
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def phase_tp_fleet(pad_to, want):
    """Full-width llama3.2-1b (bf16, seeded weights) served by a DP x TP
    fleet of FLEET_REPLICAS replicas at TP = 2 (``tp_fleet_rank``): two
    ``torch.distributed`` processes on the one card, each rank r of both
    replicas. Each run teacher-forced to the router arm's draws
    (FLEET_ARMS) within TP_DLOGIT_BOUND, which the contiguous arm with the
    decode kernel one key short breaks; every run's placements, spills,
    requeues and each replica's steps, prefills, chunks and preemptions the
    router arm's (``want``: arm -> its tokens and ``fleet_host``), on both
    processes; each rank's launches exact (``serve_once``) and the same on
    both; each replica's reduces ``reduces_per_forward`` a forward of its
    own, through slots of its own; a rank's KV and params half a replica's
    (KV at most 0.6x, params the serving specs' bytes), both replicas on
    the rank's one shard. Prints wall, tok/s, the aggregate over
    ``busy_max_s`` and each replica's reduces (TP_LABEL)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import tp_pool

    t0 = time.perf_counter()
    with expandable_segments():
        ranks = tp_pool.spawn(tp_fleet_rank, TP_RANKS, pad_to, want, devices=list(TP_DEVICES))
    r0 = ranks[0]
    per_fwd = reduces_per_forward(get_config(ARCH))
    label = f"{FLEET_REPLICAS} replicas x TP = {TP_RANKS}, {tp_label()}"
    for arm, router_arm in FLEET_ARMS.items():
        same, host = r0["recorded"][arm]
        check(same and host == want[arm]["host"],
              f"tp fleet {arm}: rank 0's recording of router/{router_arm} is not its run "
              f"(tokens the same: {same}; host {host}, the router arm's {want[arm]['host']})")
        for r in ranks:
            for run, res in r["arms"][arm].items():
                tag = f"tp fleet {arm} rank {r['rank']} {run}"
                check(res["host"] == want[arm]["host"], f"{tag}: host counters {res['host']}, "
                      f"router/{router_arm}'s {want[arm]['host']}")
                check(res["tokens"], f"{tag}: the forced run's tokens are not "
                      f"router/{router_arm}'s")
                check(res["counts"] == r0["arms"][arm][run]["counts"],
                      f"{tag}: launches differ from rank 0's")
                check(res["backend"] == "gloo" and all(res["slots"]) and res["shared"],
                      f"{tag}: backend {res['backend']}, slots {res['slots']}, one shard "
                      f"{res['shared']}")
                whole = res["kv_reserved_bytes"] // FLEET_REPLICAS  # a replica, counted once
                check(res["kv_reserved_bytes"] == want[arm]["kv_reserved_bytes"]
                      and res["kv_reserved_per_device_bytes"] / whole <= 0.6,
                      f"{tag}: KV {res['kv_reserved_per_device_bytes']} B a rank of {whole} B "
                      f"a replica; the router arm's pools {want[arm]['kv_reserved_bytes']} B")
                check(res["param_bytes_per_device"] == r0["spec_param_bytes"],
                      f"{tag}: {res['param_bytes_per_device']} B of params a rank, the serving "
                      f"specs give {r0['spec_param_bytes']} B")
                for e in res["per_replica"]:
                    n_fwd = e["prefills"] + e["decode_steps"]
                    check(e["reduces"] == per_fwd * n_fwd,
                          f"{tag}: replica {e['replica']} reduced {e['reduces']} times over "
                          f"{n_fwd} forwards, reduces_per_forward gives {per_fwd} a forward")
        first = r0["arms"][arm]["forced"]
        whole = first["kv_reserved_bytes"] // FLEET_REPLICAS
        print(f"[tp fleet {arm}] {label} | placements, spills {want[arm]['host']['spills']}, "
              f"requeues {want[arm]['host']['requeues']}, each replica's counters "
              f"{want[arm]['host']['replicas']} as router/{router_arm}'s on both processes, "
              f"every run | KV reserved a rank {first['kv_reserved_per_device_bytes']} B of "
              f"{whole} B a replica ({first['kv_reserved_per_device_bytes'] / whole:.4f}x) | "
              f"params a rank {first['param_bytes_per_device']} B of {r0['whole_param_bytes']} "
              f"B ({first['param_bytes_per_device'] / r0['whole_param_bytes']:.4f}x: the specs' "
              f"bytes; both replicas on one shard) | launches a rank {first['counts']}",
              flush=True)
        for run, res in r0["arms"][arm].items():
            reps = "; ".join(
                f"replica {e['replica']} ({e['device']}): {e['prefills'] + e['decode_steps']} "
                f"forwards, {e['reduces']} reduces, {e['reduce_s'] * 1e3:.1f} ms host in them, "
                f"busy {e['busy_s']:.3f} s" for e in res["per_replica"])
            print(f"[tp fleet {arm} {run}] {label} | wall {res['wall_s']:.3f} s | "
                  f"{res['tokens_per_s']:.1f} tok/s | aggregate "
                  f"{res['aggregate_tokens_per_s']:.1f} tok/s over busy max "
                  f"{res['busy_max_s']:.3f} s | ttft p50 {res['ttft_p50_ms']:.2f} ms | tpot p50 "
                  f"{res['tpot_p50_ms']:.3f} ms | rank 0: {reps} | max |dlogit| "
                  f"{res['dlogit']:.6f} (bound {TP_DLOGIT_BOUND})", flush=True)
            if run == "control":
                check(res["dlogit"] > TP_DLOGIT_BOUND, f"tp fleet {arm} control: a decode "
                      f"kernel one key short stayed within the bound ({res['dlogit']} <= "
                      f"{TP_DLOGIT_BOUND})")
            else:
                check(res["dlogit"] <= TP_DLOGIT_BOUND, f"tp fleet {arm}: max |dlogit| "
                      f"{res['dlogit']} against router/{router_arm}, bound {TP_DLOGIT_BOUND}")
    print(f"[tp fleet] the ranks {r0['seconds']:.1f} s | phase {time.perf_counter() - t0:.1f} s | "
          f"max_memory_allocated a process {[r['peak_bytes'] for r in ranks]} B", flush=True)
    return r0


# ---------------------------------------------------------------- ep
#: the ep arm: expert parallelism (``moe.moe_ffn_ep``) over EP_RANKS gloo
#: ranks on the one card (the TP_DEVICES pair), each with EP_TOKENS tokens
#: of its own
EP_RANKS = 2
EP_TOKENS = (2, 256)
#: the full-width MoE layers held forward and backward against the plain
#: version: arm -> (arch, dtype)
EP_LAYERS = {"qwen3-moe": ("qwen3-moe-30b-a3b", "bfloat16"),
             "deepseek-v2": ("deepseek-v2-236b", "bfloat16"),
             "qwen3-moe f32": ("qwen3-moe-30b-a3b", "float32")}
#: the model arm: qwen3-moe-30b-a3b cut to this depth, dropless
EP_MODEL, EP_MODEL_LAYERS = "qwen3-moe-30b-a3b", 4
#: the model arm's max |dlogit| against the one-device forward, set between
#: its sound reading and the sources-swapped control's
EP_DLOGIT_BOUND = 1.0
#: the layer arms' timed forwards a rank (EP and TP = 2)
EP_TIMED = 5


@contextlib.contextmanager
def sources_swapped():
    """The control: every dispatch exchange of ``moe_ffn_ep`` (the first of
    each layer's two) hands the experts the two sources' chunks swapped, so
    each token's experts read the other rank's tokens; the outputs go back
    by the exchange's own order."""
    from repro_torch.distributed import tp_pool

    real, calls = tp_pool.all_to_all, [0]

    def swapped(x, group):
        y = real(x, group)
        calls[0] += 1
        if calls[0] % 2:
            y = y.reshape(group.size, -1, *y.shape[1:]).flip(0).reshape(y.shape)
        return y

    tp_pool.all_to_all = swapped
    try:
        yield
    finally:
        tp_pool.all_to_all = real


@contextlib.contextmanager
def exchange_log():
    """Records each ``tp_pool.all_to_all`` made within: its host ms."""
    from repro_torch.distributed import tp_pool

    real, log = tp_pool.all_to_all, []

    def logged(x, group):
        t0 = time.perf_counter()
        y = real(x, group)
        log.append(round((time.perf_counter() - t0) * 1e3, 3))
        return y

    tp_pool.all_to_all = logged
    try:
        yield log
    finally:
        tp_pool.all_to_all = real


def fs_type(path: str) -> str:
    """The type of the file system ``path`` lies on (``/proc/mounts``' longest
    mount point above it)."""
    best, kind = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mnt = parts[1]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) and len(mnt) > len(best):
                best, kind = mnt, parts[2]
    return kind


def _outside(got, want, dtype_name: str):
    """(max |got - want| in f32, whether any element is outside atol + rtol
    * |want| of the type or not finite)."""
    import torch

    g, w = got.detach().float(), want.detach().float()
    atol, rtol = TOL[dtype_name]
    diff = (g - w).abs()
    bad = bool((diff > atol + rtol * w.abs()).any()) or not bool(torch.isfinite(g).all())
    return float(diff.max()), bad


def _walls_ms(fn, n: int = EP_TIMED):
    """The median host-clock ms of ``n`` calls of ``fn``, each ended by a
    synchronize (a call that exchanges waits on the host anyway)."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def ep_layer(arch, dtype, group, ep):
    """One full-width MoE layer of ``arch`` in ``dtype`` (seeded, the same
    whole layer on both ranks) at EP = 2 on this rank, each rank with its
    own EP_TOKENS: the forward and the backward of ``sum(out * ct) + aux``
    (``impl="torch"``: no kernel has a backward), held against the plain
    version on every rank's tokens (``moe_ffn_ep_plain``, whole experts:
    the output, the aux, the rank's expert gradients, its x gradient, and
    the router's and the shared experts' summed over the ranks); the same
    forward with the sources swapped (``sources_swapped``); the drops, the
    exchanges' bytes and host ms, the experts' bmm alone by CUDA events,
    and the same layer at TP = 2 (``moe_ffn(tp=)``, one reduce; rank 0's
    tokens on both ranks) timed beside."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.models import moe as M

    dev = group.device
    cfg = get_config(arch).replace(dtype=dtype)
    m, d = cfg.moe, cfg.d_model
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + 35)
    with torch.no_grad():
        whole = M.init_moe(gen, cfg, dev)
        xs = [_rand(gen, (*EP_TOKENS, d), dt, dev) for _ in range(EP_RANKS)]
        cts = [_rand(gen, (*EP_TOKENS, d), torch.float32, dev) for _ in range(EP_RANKS)]
    mine = sharding.shard_tree(whole, sharding.ep_param_specs(cfg, whole, EP_RANKS), ep.rank,
                               EP_RANKS)

    def live(tree):  # leaves of their own on the same storage
        return sharding.map_with_path(lambda _, t: t.detach().requires_grad_(True), tree)

    out = {"arch": arch, "dtype": dtype,
           "cap": M.expert_capacity(xs[0].shape[0] * xs[0].shape[1], cfg)}
    p, x = live(mine), xs[ep.rank].clone().requires_grad_(True)
    c0 = (ep.n_exchanges, ep.exchange_bytes, ep.exchange_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, aux = M.moe_ffn(cfg, p, x, impl="torch", ep=ep)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    c1 = (ep.n_exchanges, ep.exchange_bytes, ep.exchange_s)
    (torch.sum(y.float() * cts[ep.rank]) + aux).backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out.update(fwd_ms=(t1 - t0) * 1e3, bwd_ms=(t2 - t1) * 1e3,
               fwd_exchanges=c1[0] - c0[0], fwd_bytes=c1[1] - c0[1],
               fwd_exchange_ms=(c1[2] - c0[2]) * 1e3, bwd_exchanges=ep.n_exchanges - c1[0],
               bwd_exchange_ms=(ep.exchange_s - c1[2]) * 1e3)
    _, _, plan = M.ep_dispatch(cfg, mine, xs[ep.rank].reshape(-1, d))
    out["dropped"] = int((~plan.keep).sum())
    out["assignments"] = int(plan.keep.numel())

    def whole_leaves(tree):  # the leaves every rank holds whole
        leaves = {"router": tree["router"]["w"]}
        for w in ("w1", "w3", "w2") if "shared" in tree else ():
            leaves[f"shared {w}"] = tree["shared"][w]["w"]
        return leaves

    # the ranks' shares of the whole leaves' gradients, summed
    summed = {k: group.all_reduce(t.grad.detach().clone()) for k, t in whole_leaves(p).items()}
    # the plain version (every rank in this process, on the whole experts),
    # one rank at a time: its whole layer's gradients are the arm's largest
    # tensors (deepseek-v2's 7.5 GB of experts, twice over as they add up)
    el = m.n_experts // EP_RANKS
    blk = slice(ep.rank * el, (ep.rank + 1) * el)
    for turn in range(EP_RANKS):
        if turn == ep.rank:
            pw = live(whole)
            xw = [t.clone().requires_grad_(True) for t in xs]
            outs, paux = M.moe_ffn_ep_plain(cfg, pw, xw, EP_RANKS, impl="torch")
            sum(torch.sum(o.float() * c) + paux for o, c in zip(outs, cts)).backward()
            errs = {"out": _outside(y, outs[ep.rank], dtype),
                    "aux": _outside(aux.reshape(1), paux.reshape(1), dtype),
                    "x grad": _outside(x.grad, xw[ep.rank].grad, dtype)}
            for w in ("w1", "w3", "w2"):
                errs[f"{w} grad"] = _outside(p[w].grad, pw[w].grad[blk], dtype)
            for k, t in whole_leaves(pw).items():
                errs[f"{k} grad"] = _outside(summed[k], t.grad, dtype)
            del pw, xw, outs, paux
            torch.cuda.empty_cache()
        dist.barrier()
    out["errs"] = errs

    with torch.no_grad():
        with sources_swapped():
            yc, _ = M.moe_ffn(cfg, mine, xs[ep.rank], impl="torch", ep=ep)
        out["control"] = _outside(yc, y.detach(), dtype)
        del p, x, y, aux, yc
        torch.cuda.empty_cache()
        x_send, _, _ = M.ep_dispatch(cfg, mine, xs[ep.rank].reshape(-1, d))
        x_recv = ep.all_to_all(x_send)
        out["bmm_ms"] = cuda_ms(lambda: M.ep_experts(mine, x_recv, EP_RANKS), samples=10,
                                inner=5)
        rows = x_recv.shape[0]
        out["bmm_bytes"] = (3 * el * d * m.d_ff_expert + 2 * rows * d) * x_recv.element_size()
        out["bmm_flops"] = rows * 3 * 2 * d * m.d_ff_expert
        c0 = (ep.n_exchanges, ep.exchange_s)
        out["ep_ms"] = _walls_ms(lambda: M.moe_ffn(cfg, mine, xs[ep.rank], impl="torch", ep=ep))
        out["ep_exchange_ms"] = (ep.exchange_s - c0[1]) * 1e3 / (ep.n_exchanges - c0[0])
        del mine, x_send, x_recv
        tp_whole = {"moe": whole}
        ptp = sharding.shard_tree(tp_whole, sharding.tp_param_specs(cfg, tp_whole, EP_RANKS),
                                  group.rank, EP_RANKS)["moe"]
        del whole, tp_whole
        torch.cuda.empty_cache()
        r0, s0 = group.n_reduces, group.reduce_s
        out["tp_ms"] = _walls_ms(lambda: M.moe_ffn(cfg, ptp, xs[0], impl="torch", tp=group))
        out["tp_reduces"] = (group.n_reduces - r0) / EP_TIMED
        out["tp_reduce_ms"] = (group.reduce_s - s0) * 1e3 / EP_TIMED
    del ptp
    torch.cuda.empty_cache()
    return out


def ep_model(group, ep):
    """qwen3-moe-30b-a3b at full width cut to EP_MODEL_LAYERS, dropless
    (capacity E / k), its experts split over the EP group and each rank with
    a batch of its own: the train forward with no gradient on the kernels
    (``impl="auto"``), its launch counters set to 0 just before and read
    just after, and its exchanges and reduces counted; against the
    one-device forward of the whole model on the same batch (max
    |dlogit|), and the sources-swapped control's."""
    import dataclasses

    import torch

    from repro_torch.distributed import sharding
    from repro_torch.launch import serve
    from repro_torch.models import get_model

    dev = group.device
    cfg0, _, params = serve.build_model(EP_MODEL, smoke=False, seed=SEED, device=dev,
                                        n_layers=EP_MODEL_LAYERS)
    cfg = cfg0.replace(moe=dataclasses.replace(
        cfg0.moe, capacity_factor=cfg0.moe.n_experts / cfg0.moe.top_k))
    one = get_model(cfg)
    mine = sharding.shard_tree(params, sharding.ep_param_specs(cfg, params, EP_RANKS),
                               ep.rank, EP_RANKS)
    model = dataclasses.replace(one, ep=ep)
    gen = torch.Generator(device=dev).manual_seed(SEED + 40 + ep.rank)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, EP_TOKENS, generator=gen, device=dev)}
    with torch.no_grad():
        want = one.forward(params, batch, impl="auto")[0]
        del params
        torch.cuda.empty_cache()
        n0, r0, s0, b0 = ep.n_exchanges, group.n_reduces, ep.exchange_s, ep.exchange_bytes
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        with exchange_log() as log:
            got = model.forward(mine, batch, impl="auto")[0]
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = _read_counts()
        out = dict(counts=counts, want=_want_counts(cfg, 1, flash_attention=EP_MODEL_LAYERS),
                   exchanges=ep.n_exchanges - n0, reduces=group.n_reduces - r0,
                   exchange_ms=(ep.exchange_s - s0) * 1e3, wall_ms=wall, each_ms=log,
                   exchange_bytes=ep.exchange_bytes - b0,
                   n_moe=sum(1 for i in range(cfg.n_layers) if i >= cfg.moe.first_dense_layers),
                   finite=bool(torch.isfinite(got).all()),
                   dlogit=float((got - want).abs().max()),
                   logit_scale=float(want.abs().max()))
        with sources_swapped():
            ctrl = model.forward(mine, batch, impl="auto")[0]
        out["control"] = float((ctrl - want).abs().max())
    return out


def ep_rank(group):
    """One rank of the ep arm (``tp_pool.spawn``; both on cuda:0, gloo): its
    EP group (``tp_pool.ep_group``: both ranks, the whole group its own
    ``whole``), each of EP_LAYERS (``ep_layer``) and the model
    (``ep_model``). Returns the rank's numbers."""
    import torch

    from repro_torch.distributed import tp_pool

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ep = tp_pool.ep_group(group, EP_RANKS)
    out = {"rank": group.rank, "slots": ep.slots is not None, "backend": ep.backend,
           "layers": {}, "store_fs": fs_type(os.path.dirname(os.path.realpath(group.store)))}
    for arm, (arch, dtype) in EP_LAYERS.items():
        out["layers"][arm] = ep_layer(arch, dtype, group, ep)
    out["model"] = ep_model(group, ep)
    out["seconds"] = time.perf_counter() - t0
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def phase_ep():
    """Expert parallelism at EP = 2 (``ep_rank``): two ``torch.distributed``
    processes on the one card under gloo, each rank with EP_TOKENS of its
    own. Each of EP_LAYERS, forward and backward: the output, aux and every
    gradient within its type's tolerance of the plain version, and the
    sources-swapped control outside it. The model arm: launches exactly
    ``_want_counts``' (flash a layer) on both ranks, 2 exchanges a MoE layer
    and one aux reduce, finite logits within EP_DLOGIT_BOUND of the
    one-device forward's, and the control above it. Prints the drops, a
    layer's exchanges (bytes and host ms), its experts' bmm beside their
    bound, and its forward at EP = 2 and at TP = 2 (TP_LABEL). Returns
    rank 0's numbers."""
    from repro_torch.distributed import tp_pool

    t0 = time.perf_counter()
    with expandable_segments():
        ranks = tp_pool.spawn(ep_rank, EP_RANKS, devices=list(TP_DEVICES))
    label = tp_label()
    for r in ranks:
        check(r["backend"] == "gloo" and r["slots"], f"ep rank {r['rank']}: backend "
              f"{r['backend']}, shared slots {r['slots']}")
        for arm, res in r["layers"].items():
            tag = f"ep {arm} rank {r['rank']}"
            bad = {k: v for k, v in res["errs"].items() if v[1]}
            check(not bad, f"{tag}: outside the {res['dtype']} tolerance of the plain version: "
                  f"{bad}")
            check(res["control"][1], f"{tag} control: the sources swapped stayed within the "
                  f"{res['dtype']} tolerance (max |diff| {res['control'][0]})")
            check(res["fwd_exchanges"] == 2 and res["bwd_exchanges"] == 2,
                  f"{tag}: {res['fwd_exchanges']} exchanges forward and "
                  f"{res['bwd_exchanges']} backward, not 2 and 2")
            errs = ", ".join(f"{k} {v[0]:.3e}" for k, v in res["errs"].items())
            print(f"[ep {arm}] rank {r['rank']} | {res['arch']} layer, {res['dtype']}, "
                  f"{EP_TOKENS[0]} x {EP_TOKENS[1]} tokens a rank, capacity {res['cap']} an "
                  f"expert a source | dropped {res['dropped']} of {res['assignments']} "
                  f"assignments | max |err| against the plain version: {errs} (tolerance "
                  f"{TOL[res['dtype']]}) | sources swapped {res['control'][0]:.3e} (outside)",
                  flush=True)
        for arm, res in r["layers"].items():
            bound_ms, by = bound(res["bmm_bytes"], res["bmm_flops"],
                                 BF16_FLOPS_PER_S if res["dtype"] == "bfloat16"
                                 else F32_FLOPS_PER_S)
            print(f"[ep {arm}] rank {r['rank']} | {label} | forward {res['fwd_ms']:.3f} ms, "
                  f"backward {res['bwd_ms']:.3f} ms (the first, graph and all) | an exchange "
                  f"{res['fwd_bytes'] // 2} B each way, {res['fwd_exchange_ms'] / 2:.3f} ms "
                  f"host (backward {res['bwd_exchange_ms'] / 2:.3f}) | experts' bmm "
                  f"{res['bmm_ms']:.4f} ms (bound {bound_ms:.4f} ms, {by}) | a forward, median "
                  f"of {EP_TIMED}: EP = 2 {res['ep_ms']:.3f} ms ({res['ep_exchange_ms']:.3f} "
                  f"ms host an exchange) / TP = 2 (moe_ffn(tp=)) {res['tp_ms']:.3f} ms "
                  f"({res['tp_reduces']:.0f} reduce, {res['tp_reduce_ms']:.3f} ms host)",
                  flush=True)
        mo = r["model"]
        tag = f"ep model rank {r['rank']}"
        check(mo["counts"] == mo["want"], f"{tag}: launches {mo['counts']}, want {mo['want']}")
        check(mo["exchanges"] == 2 * mo["n_moe"] and mo["reduces"] == mo["n_moe"],
              f"{tag}: {mo['exchanges']} exchanges and {mo['reduces']} reduces over "
              f"{mo['n_moe']} MoE layers, want 2 and 1 a layer")
        check(mo["finite"] and mo["dlogit"] <= EP_DLOGIT_BOUND,
              f"{tag}: max |dlogit| {mo['dlogit']} against the one-device forward (bound "
              f"{EP_DLOGIT_BOUND}; finite {mo['finite']})")
        check(mo["control"] > EP_DLOGIT_BOUND, f"{tag} control: the sources swapped stayed "
              f"within the bound ({mo['control']} <= {EP_DLOGIT_BOUND})")
        launched = {k: v for k, v in mo["counts"].items() if v}
        print(f"[ep model] rank {r['rank']} | {EP_MODEL} {EP_MODEL_LAYERS} layers, dropless, "
              f"{EP_TOKENS[0]} x {EP_TOKENS[1]} tokens a rank, train forward on the kernels "
              f"| launches {launched} (exact) | {mo['exchanges']} exchanges, "
              f"{mo['exchange_bytes'] // mo['exchanges']} B each way each (dropless "
              f"capacity), {mo['exchange_ms']:.3f} ms host ({mo['each_ms']} each), "
              f"{mo['reduces']} aux reduces | wall {mo['wall_ms']:.3f} ms ({label}) | max "
              f"|dlogit| against the one-device "
              f"forward {mo['dlogit']:.6f} (logits up to {mo['logit_scale']:.3f}; bound "
              f"{EP_DLOGIT_BOUND}) | sources swapped {mo['control']:.6f}", flush=True)
    print(f"[ep] the shared slots' file on {ranks[0]['store_fs']} | the ranks "
          f"{ranks[0]['seconds']:.1f} s | phase {time.perf_counter() - t0:.1f} s "
          f"| max_memory_allocated a process {[r['peak_bytes'] for r in ranks]} B", flush=True)
    return ranks[0]


def ep_kernel_records(r0):
    """The kernels at the ep model's shapes as kernel records, launches from
    rank 0's run: flash at its prefill (q [2, 256, 32, 128], k/v 4 heads,
    causal) and RMSNorm add at [2, 256, 2048], against their plain versions,
    timed beside their bound and the library call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    cfg = get_config(EP_MODEL)
    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 36)
    b, t = EP_TOKENS
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = hq // hkv
    q = _rand(gen, (b, t, hq, dh), bf, dev)
    k, v = (_rand(gen, (b, t, hkv, dh), bf, dev) for _ in range(2))
    pos = int_positions(b, t, dev)
    kw = dict(q_positions=pos, k_positions=pos, causal=True)
    counts = r0["model"]["counts"]
    recs = []
    kernel_record(recs, f"q[{b},{t},{hq},{dh}] kv[{b},{t},{hkv},{dh}] bf16 causal ({EP_MODEL} "
                  f"prefill at EP = {EP_RANKS}, a rank's own tokens)",
                  lambda: fa.flash_attention_cuda(q, k, v, **kw),
                  lambda: fa.flash_attention_plain(q, k, v, **kw),
                  lambda qt=q.transpose(1, 2), ke=per_head(k, g), ve=per_head(v, g):
                  F.scaled_dot_product_attention(qt, ke, ve, is_causal=True),
                  max_err(fa.flash_attention_cuda(q, k, v, **kw),
                          fa.flash_attention_plain(q, k, v, **kw), "bfloat16"),
                  (2 * q.numel() + 2 * k.numel()) * 2 + 2 * b * t * 4,
                  b * t * (t + 1) // 2 * hq * 4 * dh, counts["flash_attention"], **FLASH_SRC)
    x = _rand(gen, (b, t, cfg.d_model), bf, dev) * 3
    r = _rand(gen, (b, t, cfg.d_model), bf, dev)
    w = (1 + 0.1 * _rand(gen, (cfg.d_model,), torch.float32, dev)).to(bf)
    work = rmsnorm_work("add", x.numel(), cfg.d_model)
    kernel_record(recs, f"add x[{b},{t},{cfg.d_model}] bf16 ({EP_MODEL} at EP = {EP_RANKS})",
                  lambda: rn.add_rmsnorm_cuda(x, r, w)[1],
                  lambda: rn.add_rmsnorm_plain(x, r, w)[1], None,
                  max_err(rn.add_rmsnorm_cuda(x, r, w)[1], rn.add_rmsnorm_plain(x, r, w)[1],
                          "bfloat16"),
                  work["bytes"], work["flops"], counts["rmsnorm/add"], name="rmsnorm",
                  prologue="add", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                  replaces="src/repro/kernels/rmsnorm.py:25", peak=work["peak"])
    finish_records(recs)
    for rec in recs:
        check(rec["launches"] > 0, f"{rec['name']} {rec['shape']}: not launched on the ep path")
    return recs


def tp_kernel_records(pad_to, r0):
    """The attention kernels at a rank's shapes of full-width llama3.2-1b at
    TP = 2 (16 q heads over 4 KV heads of 64): flash at the served prefill,
    the contiguous decode over the served pool's rows and the paged decode
    through the chunked arm's pool (48 blocks of 16), against their plain
    versions in bf16, a repeat call bit-identical, timed beside their bound
    and SDPA; launches from rank 0's TP runs (contiguous sound, chunked
    forced)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda

    cfg = get_config(ARCH)
    hq, hkv, dh = cfg.n_heads // TP_RANKS, cfg.n_kv_heads // TP_RANKS, cfg.head_dim
    g = hq // hkv
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    recs = []
    if TP_ONLY:  # the named families' records alone
        tp_ssm_encdec_records(recs, gen, r0)
        tp_hybrid_records(recs, gen, r0)
        finish_records(recs)
        return recs
    ctg, chunked = r0["arms"]["contiguous"]["sound"]["counts"], r0["arms"]["chunked"]["forced"]["counts"]
    q = _rand(gen, (1, pad_to, hq, dh), bf, dev)
    k, v = (_rand(gen, (1, pad_to, hkv, dh), bf, dev) for _ in range(2))
    pos = int_positions(1, pad_to, dev)
    kw = dict(q_positions=pos, k_positions=pos, causal=True)
    err = max_err(fa.flash_attention_cuda(q, k, v, **kw), fa.flash_attention_plain(q, k, v, **kw),
                  "bfloat16")
    kernel_record(recs, f"q[1,{pad_to},{hq},{dh}] kv[1,{pad_to},{hkv},{dh}] bf16 causal "
                  f"(llama3.2-1b prefill, a rank's heads at TP = {TP_RANKS})",
                  lambda: fa.flash_attention_cuda(q, k, v, **kw),
                  lambda: fa.flash_attention_plain(q, k, v, **kw),
                  lambda qt=q.transpose(1, 2), ke=per_head(k, g), ve=per_head(v, g):
                  F.scaled_dot_product_attention(qt, ke, ve, is_causal=True), err,
                  (2 * q.numel() + 2 * k.numel()) * 2 + 2 * pad_to * 4,
                  pad_to * (pad_to + 1) // 2 * hq * 4 * dh, ctg["flash_attention"], **FLASH_SRC)
    s_ctg = pad_to + MAX_NEW + 1
    qd = _rand(gen, (SLOTS, hq, dh), bf, dev)
    kc, vc = (_rand(gen, (SLOTS, s_ctg, hkv, dh), bf, dev) for _ in range(2))
    ln = torch.tensor([1, 63, 64, 65, 200, pad_to + 1, s_ctg - 1, s_ctg], dtype=torch.int32,
                      device=dev)
    err = max_err(da.decode_attention_cuda(qd, kc, vc, ln), da.decode_attention_plain(qd, kc, vc, ln),
                  "bfloat16")
    n_rows = int(ln.sum())
    amask = (torch.arange(s_ctg, device=dev)[None] < ln[:, None])[:, None, None, :]
    kernel_record(recs, f"q[{SLOTS},{hq},{dh}] cache[{SLOTS},{s_ctg},{hkv},{dh}] bf16 lengths "
                  f"{ln.tolist()} (llama3.2-1b decode, a rank's heads at TP = {TP_RANKS})",
                  lambda: da.decode_attention_cuda(qd, kc, vc, ln),
                  lambda: da.decode_attention_plain(qd, kc, vc, ln),
                  lambda qq=qd[:, :, None], ke=per_head(kc, g), ve=per_head(vc, g), m=amask:
                  F.scaled_dot_product_attention(qq, ke, ve, attn_mask=m), err,
                  (2 * qd.numel() + 2 * n_rows * hkv * dh) * 2 + SLOTS * 4,
                  n_rows * hq * 4 * dh, ctg["decode_attention"], **DECODE_SRC)
    geo = TP_ARMS["chunked"]
    bs, nb = geo["block_size"], geo["num_blocks"]
    mb = -(-s_ctg // bs)
    perm = torch.randperm(SLOTS * mb, generator=torch.Generator().manual_seed(SEED))
    bt = (perm % (nb - 1) + 1).reshape(SLOTS, mb).to(torch.int32).to(dev).contiguous()
    kp, vp = (_rand(gen, (nb, bs, hkv, dh), bf, dev) for _ in range(2))
    nv = ln.clamp(max=mb * bs)
    pmask = (torch.arange(mb * bs, device=dev)[None] < nv[:, None])[:, None, None, :]
    err = max_err(pda.paged_decode_attention_cuda(qd, kp, vp, bt, nv),
                  pda.paged_decode_attention_plain(qd, kp, vp, bt, nv), "bfloat16")
    kg, vg = (x[bt.long()].reshape(SLOTS, mb * bs, hkv, dh) for x in (kp, vp))
    n_rows = int(nv.sum())
    kernel_record(recs, f"q[{SLOTS},{hq},{dh}] pool[{nb},{bs},{hkv},{dh}] bt[{SLOTS},{mb}] bf16 "
                  f"n_valid {nv.tolist()} (llama3.2-1b paged decode, a rank's heads at TP = "
                  f"{TP_RANKS})",
                  lambda: pda.paged_decode_attention_cuda(qd, kp, vp, bt, nv),
                  lambda: pda.paged_decode_attention_plain(qd, kp, vp, bt, nv),
                  lambda qq=qd[:, :, None], ke=per_head(kg, g), ve=per_head(vg, g), m=pmask:
                  F.scaled_dot_product_attention(qq, ke, ve, attn_mask=m), err,
                  (2 * qd.numel() + 2 * n_rows * hkv * dh) * 2 + bt.numel() * 4 + SLOTS * 4,
                  n_rows * hq * 4 * dh, chunked["paged_decode_attention"],
                  name="paged_decode_attention",
                  source="src/repro_torch/kernels/csrc/decode_attention.cu",
                  replaces="src/repro/models/attention.py:177")
    tp_family_records(recs, gen, pad_to, r0)
    tp_hybrid_records(recs, gen, r0)
    finish_records(recs)
    for rec in recs:
        check(rec["launches"] > 0, f"{rec['name']} {rec['shape']}: not launched at TP = 2")
    return recs


def tp_family_records(recs, gen, pad_to, r0):
    """The TP_FAMILIES arms' kernels at a rank's shapes (TP = 2), against
    their plain versions in bf16, a repeat call bit-identical, timed beside
    their bound and the library call: flash at chameleon-34b's last I-T
    chunk (32 q heads over 4 KV heads of 128), at qwen3-moe's prefill (16
    over 2) and at deepseek-v2's MLA prefill (64 heads, D 192 / Dv 128);
    the decode kernel at qwen3-moe's G = 8, D = 128 and over deepseek-v2's
    latent at 64 heads; the paged decode through chameleon's I-T pool; the
    qk-norm RMSNorm over qwen3-moe's rank heads; both int8 GEMMs at
    llama3.2-1b's column (N / 2) and row (K / 2) splits. Launches: rank 0's
    forced run of the arm on the path."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import rmsnorm as rn

    dev, bf, n = torch.device("cuda"), torch.bfloat16, TP_RANKS

    def counts(family, arm):
        return r0["families"][family]["arms"][arm]["forced"]["counts"]

    def flash(label, cfg_name, hq, hkv, dq, dv, tq, tk, launches, scale=None):
        q = _rand(gen, (1, tq, hq, dq), bf, dev)
        k = _rand(gen, (1, tk, hkv, dq), bf, dev)
        v = _rand(gen, (1, tk, hkv, dv), bf, dev)
        qpos = int_positions(1, tq, dev) + (tk - tq)
        kpos = int_positions(1, tk, dev)
        kw = dict(q_positions=qpos.contiguous(), k_positions=kpos, causal=True, scale=scale)
        err = max_err(fa.flash_attention_cuda(q, k, v, **kw),
                      fa.flash_attention_plain(q, k, v, **kw), "bfloat16")
        mask = (kpos[:, None, :] <= qpos[:, :, None])[:, None]
        pairs = int(mask.sum())
        kernel_record(recs, f"q[1,{tq},{hq},{dq}] k[1,{tk},{hkv},{dq}] v[1,{tk},{hkv},{dv}] "
                      f"bf16 causal ({cfg_name} {label}, a rank's heads at TP = {n})",
                      lambda: fa.flash_attention_cuda(q, k, v, **kw),
                      lambda: fa.flash_attention_plain(q, k, v, **kw),
                      lambda qt=q.transpose(1, 2), ke=per_head(k, hq // hkv),
                      ve=per_head(v, hq // hkv), m=mask:
                      F.scaled_dot_product_attention(qt, ke, ve, attn_mask=m, scale=scale),
                      err, (2 * q.numel() + k.numel() + v.numel()) * 2 + (tq + tk) * 4,
                      pairs * hq * 2 * (dq + dv), launches, **FLASH_SRC)

    cham, qwen, ds = (get_config(a) for a in ("chameleon-34b", "qwen3-moe-30b-a3b",
                                               "deepseek-v2-236b"))
    flash("I-T prefill, its last chunk", "chameleon-34b", cham.n_heads // n,
          cham.n_kv_heads // n, cham.head_dim, cham.head_dim,
          TP_IT_GEOMETRY["prefill_budget"], IT_LEN,
          counts("chameleon", "chunked")["flash_attention"])
    flash("prefill", "qwen3-moe-30b-a3b", qwen.n_heads // n, qwen.n_kv_heads // n,
          qwen.head_dim, qwen.head_dim, pad_to, pad_to,
          counts("moe", "contiguous")["flash_attention"])
    ml = ds.mla
    dq = ml.qk_nope_dim + ml.qk_rope_dim
    flash(f"MLA prefill, D {dq} / Dv {ml.v_head_dim}", "deepseek-v2-236b", ds.n_heads // n,
          ds.n_heads // n, dq, ml.v_head_dim, pad_to, pad_to,
          counts("mla", "contiguous")["flash_attention"], scale=dq ** -0.5)

    s_ctg = pad_to + MAX_NEW + 1
    ln = torch.tensor([1, 63, 64, 65, 200, pad_to + 1, s_ctg - 1, s_ctg], dtype=torch.int32,
                      device=dev)
    n_rows = int(ln.sum())
    amask = (torch.arange(s_ctg, device=dev)[None] < ln[:, None])[:, None, None, :]
    hq, hkv, dh = qwen.n_heads // n, qwen.n_kv_heads // n, qwen.head_dim
    qd = _rand(gen, (SLOTS, hq, dh), bf, dev)
    kc, vc = (_rand(gen, (SLOTS, s_ctg, hkv, dh), bf, dev) for _ in range(2))
    err = max_err(da.decode_attention_cuda(qd, kc, vc, ln),
                  da.decode_attention_plain(qd, kc, vc, ln), "bfloat16")
    kernel_record(recs, f"q[{SLOTS},{hq},{dh}] cache[{SLOTS},{s_ctg},{hkv},{dh}] bf16 lengths "
                  f"{ln.tolist()} (qwen3-moe-30b-a3b decode, G = {hq // hkv}, a rank's heads "
                  f"at TP = {n})",
                  lambda: da.decode_attention_cuda(qd, kc, vc, ln),
                  lambda: da.decode_attention_plain(qd, kc, vc, ln),
                  lambda qq=qd[:, :, None], ke=per_head(kc, hq // hkv),
                  ve=per_head(vc, hq // hkv), m=amask:
                  F.scaled_dot_product_attention(qq, ke, ve, attn_mask=m), err,
                  (2 * qd.numel() + 2 * n_rows * hkv * dh) * 2 + SLOTS * 4,
                  n_rows * hq * 4 * dh, counts("moe", "contiguous")["decode_attention"],
                  **DECODE_SRC)
    h, r, d = ds.n_heads // n, ml.kv_lora_rank, ml.kv_lora_rank + ml.qk_rope_dim
    ql = _rand(gen, (SLOTS, h, d), bf, dev)
    lat = _rand(gen, (SLOTS, s_ctg, 1, d), bf, dev)
    kw = dict(scale=dq ** -0.5)
    err = max_err(da.decode_attention_cuda(ql, lat, lat[..., :r], ln, **kw),
                  da.decode_attention_plain(ql, lat, lat[..., :r], ln, **kw), "bfloat16")
    kexp = lat[:, :, 0][:, None].expand(SLOTS, h, s_ctg, d)
    kernel_record(recs, f"q[{SLOTS},{h},{d}] latent[{SLOTS},{s_ctg},1,{d}] v = latent[..., :{r}]"
                  f" bf16 lengths {ln.tolist()} (deepseek-v2-236b decode, absorbed latent, "
                  f"G = {h}: a rank's heads at TP = {n})",
                  lambda: da.decode_attention_cuda(ql, lat, lat[..., :r], ln, **kw),
                  lambda: da.decode_attention_plain(ql, lat, lat[..., :r], ln, **kw),
                  lambda qq=ql[:, :, None], ke=kexp, m=amask:
                  F.scaled_dot_product_attention(qq, ke, ke[..., :r], attn_mask=m, **kw),
                  err, (ql.numel() + n_rows * d + SLOTS * h * r) * 2 + SLOTS * 4,
                  n_rows * h * 2 * (d + r), counts("mla", "contiguous")["decode_attention"],
                  **DECODE_SRC)

    hq, hkv, dh = cham.n_heads // n, cham.n_kv_heads // n, cham.head_dim
    bs, nb = TP_IT_GEOMETRY["block_size"], TP_IT_GEOMETRY["num_blocks"]
    s_it = TP_IT_PAD + TP_FAMILIES["chameleon"]["new"]
    mb = -(-(TP_IT_PAD + MAX_NEW + 1) // bs)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(SEED))[
        : SLOTS * mb] + 1
    bt = perm.reshape(SLOTS, mb).to(torch.int32).to(dev).contiguous()
    qp = _rand(gen, (SLOTS, hq, dh), bf, dev)
    kp, vp = (_rand(gen, (nb, bs, hkv, dh), bf, dev) for _ in range(2))
    nv = torch.tensor([IT_LEN + i for i in range(SLOTS)], dtype=torch.int32,
                      device=dev).clamp(max=s_it)
    err = max_err(pda.paged_decode_attention_cuda(qp, kp, vp, bt, nv),
                  pda.paged_decode_attention_plain(qp, kp, vp, bt, nv), "bfloat16")
    kg, vg = (x[bt.long()].reshape(SLOTS, mb * bs, hkv, dh) for x in (kp, vp))
    pmask = (torch.arange(mb * bs, device=dev)[None] < nv[:, None])[:, None, None, :]
    n_rows = int(nv.sum())
    kernel_record(recs, f"q[{SLOTS},{hq},{dh}] pool[{nb},{bs},{hkv},{dh}] bt[{SLOTS},{mb}] bf16 "
                  f"n_valid {nv.tolist()} (chameleon-34b I-T paged decode, a rank's heads at "
                  f"TP = {n})",
                  lambda: pda.paged_decode_attention_cuda(qp, kp, vp, bt, nv),
                  lambda: pda.paged_decode_attention_plain(qp, kp, vp, bt, nv),
                  lambda qq=qp[:, :, None], ke=per_head(kg, hq // hkv),
                  ve=per_head(vg, hq // hkv), m=pmask:
                  F.scaled_dot_product_attention(qq, ke, ve, attn_mask=m), err,
                  (2 * qp.numel() + 2 * n_rows * hkv * dh) * 2 + bt.numel() * 4 + SLOTS * 4,
                  n_rows * hq * 4 * dh, counts("chameleon", "chunked")["paged_decode_attention"],
                  name="paged_decode_attention",
                  source="src/repro_torch/kernels/csrc/decode_attention.cu",
                  replaces="src/repro/models/attention.py:177")

    # qk-norm: RMSNorm over each of a rank's q heads' rows of head_dim
    hq, dh = qwen.n_heads // n, qwen.head_dim
    x = _rand(gen, (SLOTS, 1, hq, dh), bf, dev) * 3
    w = (1 + 0.1 * _rand(gen, (dh,), torch.float32, dev)).to(bf)
    err = max_err(rn.rmsnorm_cuda(x, w), rn.rmsnorm_plain(x, w), "bfloat16")
    kernel_record(recs, f"none x[{SLOTS},1,{hq},{dh}] bf16 (qwen3-moe-30b-a3b decode qk-norm, a "
                  f"rank's q heads at TP = {n})",
                  lambda: rn.rmsnorm_cuda(x, w), lambda: rn.rmsnorm_plain(x, w),
                  lambda: F.rms_norm(x, (dh,), w, 1e-5), err,
                  launches=counts("moe", "contiguous")["rmsnorm/none"], name="rmsnorm",
                  prologue="none", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                  replaces="src/repro/kernels/rmsnorm.py:25", **_rmsnorm_args(x.numel(), dh))

    # both int8 GEMMs at llama3.2-1b's splits: wq's columns (N / 2) and w2's
    # rows (K / 2), weight-only at the decode step, dynamic at a prefill
    llama = get_config(ARCH)
    d = llama.d_model
    for mode, m in (("wo", SLOTS), ("dyn", pad_to)):
        name = "int8_matmul_weight_only" if mode == "wo" else "int8_matmul_dynamic"
        launches = counts(f"quant {mode}", "contiguous")[name]
        for what, k, nn in (("wq, its columns", d, d // n),
                            ("w2, its rows", llama.d_ff // n, d)):
            xq, w_q, w_scale = _int8_operands(gen, m, k, nn)
            label = f"llama3.2-1b {'decode' if mode == 'wo' else 'prefill'} {what} at TP = {n}"
            if mode == "wo":
                xb = xq.to(bf)
                err = max_err(im.int8_matmul_weight_only_cuda(xb, w_q, w_scale),
                              im.int8_matmul_weight_only_plain(xb, w_q, w_scale), "bfloat16")
                kernel_record(recs, f"x[{m},{k}] bf16 @ w_q[{k},{nn}] int8 ({label})",
                              lambda a=(xb, w_q, w_scale): im.int8_matmul_weight_only_cuda(*a),
                              lambda a=(xb, w_q, w_scale): im.int8_matmul_weight_only_plain(*a),
                              lambda a=(xb, w_q, w_scale): torch.matmul(a[0], a[1].to(bf)) * a[2],
                              err, launches=launches, name=name,
                              source="src/repro_torch/kernels/csrc/int8_matmul.cu",
                              replaces="src/repro/kernels/int8_matmul.py:66",
                              **_int8_args(m, k, nn, False))
            else:
                x_q, x_scale = ops.quantize_rows(xq)
                a = (x_q, w_q, w_scale, x_scale)
                err = max_err(im.int8_matmul_dynamic_cuda(*a), im.int8_matmul_dynamic_plain(*a),
                              "float32")
                kernel_record(recs, f"x_q[{m},{k}] int8 @ w_q[{k},{nn}] int8, f32 out ({label})",
                              lambda a=a: im.int8_matmul_dynamic_cuda(*a),
                              lambda a=a: im.int8_matmul_dynamic_plain(*a),
                              _int_mm_call(x_q, w_q, w_scale, x_scale), err,
                              launches=launches, name=name,
                              source="src/repro_torch/kernels/csrc/int8_matmul.cu",
                              replaces="src/repro/kernels/int8_matmul.py:104",
                              **_int8_args(m, k, nn, True))
    tp_ssm_encdec_records(recs, gen, r0)


def tp_ssm_encdec_records(recs, gen, r0):
    """mamba2-130m's and whisper-base's kernels at a rank's shapes (TP = 2),
    against their plain versions in bf16, a repeat call bit-identical, timed
    beside their bound: the split-row RMSNorm (its two launches: the rank's
    ``y * silu(z)`` with its partial sums of squares, then the scale over
    all 1536 channels) at the gate norm's decode and prefill rows of 768 (z
    a slice of the rank's ``in_proj`` rows), beside the whole-row kernel
    over 1536; the SSD scan at 12 of 24 heads; whisper-base's encoder flash
    over 1500 frames and its cross attention at 4 of 8 heads. Launches:
    rank 0's forced greedy run of the family."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ss

    dev, bf, n = torch.device("cuda"), torch.bfloat16, TP_RANKS
    fams = r0["families"]
    if "ssm" in fams:
        cfg = get_config("mamba2-130m")
        s = cfg.ssm
        d_in, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
        dl, hl, gn = d_in // n, nh // n, s.n_groups * s.d_state
        width = 2 * dl + 2 * gn + hl  # the rank's in_proj columns
        counts = fams["ssm"]["arms"]["greedy"]["forced"]["counts"]
        pad = fams["ssm"]["pad"]
        for label, rows in (("decode", (SLOTS, 1)), ("prefill", (1, pad))):
            zx = _rand(gen, rows + (width,), bf, dev)
            y, z = _rand(gen, rows + (dl,), bf, dev), zx[..., :dl]
            w = (1 + 0.1 * _rand(gen, (dl,), torch.float32, dev)).to(bf)
            yw, zw = _rand(gen, rows + (d_in,), bf, dev), _rand(gen, rows + (d_in,), bf, dev)
            ww = (1 + 0.1 * _rand(gen, (d_in,), torch.float32, dev)).to(bf)

            def split(y=y, z=z, w=w):
                p, sumsq = rn.mul_silu_partial_cuda(y, z)
                return rn.rmsnorm_scale_cuda(p, sumsq, w, d_in)

            def split_plain(y=y, z=z, w=w):
                p, sumsq = rn.mul_silu_partial_plain(y, z)
                return rn.rmsnorm_scale_plain(p, sumsq, w, d_in)

            work = rmsnorm_work("mul_silu", y.numel(), dl)
            n_rows = y.numel() // dl
            kernel_record(recs, f"mul_silu_split y[{','.join(map(str, rows))},{dl}] of {d_in} "
                          f"channels, z in rows of {width} bf16 (mamba2-130m {label} gate norm, "
                          f"a rank's heads at TP = {n})", split, split_plain, None,
                          max_err(split(), split_plain(), "bfloat16"),
                          launches=counts["rmsnorm/mul_silu_split"], name="rmsnorm",
                          prologue="mul_silu_split", per_call=2,
                          whole_row_ms=cuda_ms(lambda: rn.mul_silu_rmsnorm_cuda(yw, zw, ww)),
                          whole_row_device_ms=device_ms(
                              lambda: rn.mul_silu_rmsnorm_cuda(yw, zw, ww)),
                          source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                          replaces="src/repro/kernels/rmsnorm.py:25",
                          n_bytes=work["bytes"] + 2 * 4 * n_rows, flops=work["flops"],
                          peak=work["peak"])
            whole = recs[-1]["whole_row_device_ms"]
            print(f"[kernels] rmsnorm split-row {label}: the whole-row mul_silu kernel over "
                  f"{d_in} channels at the same rows {recs[-1]['whole_row_ms']:.4f} ms (device "
                  f"{'not measured' if whole is None else f'{whole:.4f} ms'})", flush=True)
        kw = _ssd_inputs(gen, 1, pad, hl, s.head_dim, s.n_groups, s.d_state, bf, False)
        plan = ss.launch_plan(1, pad, hl, s.head_dim, s.n_groups, s.d_state, s.chunk_size, bf)
        n_bytes, n_ops = ssd_work(1, pad, hl, s.head_dim, s.n_groups, s.d_state, s.chunk_size,
                                  False)
        y, st = ss.ssd_scan_cuda(chunk=s.chunk_size, **kw)
        wy, wst = ss.ssd_scan_plain(chunk=s.chunk_size, **kw)
        err = max(max_err(y, wy, "bfloat16"), max_err(st, wst, "float32", SSD_F32_TOL))
        kernel_record(recs, f"x[1,{pad},{hl},{s.head_dim}] bf16, B/C[1,{pad},{s.n_groups},"
                      f"{s.d_state}], chunk {s.chunk_size} (mamba2-130m prefill, a rank's heads "
                      f"at TP = {n})", lambda kw=kw: ss.ssd_scan_cuda(chunk=s.chunk_size, **kw)[0],
                      lambda kw=kw: ss.ssd_scan_plain(chunk=s.chunk_size, **kw), None, err,
                      n_bytes, n_ops, counts["ssd_scan"], name="ssd_scan",
                      source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                      replaces="src/repro/kernels/ssd_scan.py:90", per_call=len(plan))
    if "whisper" in fams:
        cfg = get_config("whisper-base")
        h, dh, f = cfg.n_heads // n, cfg.head_dim, cfg.encdec.n_frames
        launches = fams["whisper"]["arms"]["greedy"]["forced"]["counts"]["flash_attention"]
        fl = torch.tensor(st_frame_lengths(SLOTS, f), device=dev)
        zeros = torch.zeros((SLOTS, f), dtype=torch.int32, device=dev)
        cases = {
            "encoder (non-causal)": ((1, f, h, dh), (1, f, h, dh),
                                     dict(q_positions=int_positions(1, f, dev),
                                          k_positions=int_positions(1, f, dev), causal=False),
                                     None, f * f),
            "decoder cross attention (Tq 1, k_valid the frame lengths)":
                ((SLOTS, 1, h, dh), (SLOTS, f, h, dh),
                 dict(q_positions=zeros[:, :1].contiguous(), k_positions=zeros, causal=False,
                      k_valid=(torch.arange(f, device=dev)[None] < fl[:, None]).contiguous()),
                 (torch.arange(f, device=dev)[None] < fl[:, None])[:, None, None, :],
                 int(fl.sum())),
        }
        for label, (qs, ks, kw, mask, pairs) in cases.items():
            q, k, v = _rand(gen, qs, bf, dev), _rand(gen, ks, bf, dev), _rand(gen, ks, bf, dev)
            err = max_err(fa.flash_attention_cuda(q, k, v, **kw),
                          fa.flash_attention_plain(q, k, v, **kw), "bfloat16")
            kernel_record(recs, f"q[{','.join(map(str, qs))}] k/v[{','.join(map(str, ks))}] "
                          f"bf16 (whisper-base {label}, a rank's heads at TP = {n})",
                          lambda q=q, k=k, v=v, kw=kw: fa.flash_attention_cuda(q, k, v, **kw),
                          lambda q=q, k=k, v=v, kw=kw: fa.flash_attention_plain(q, k, v, **kw),
                          lambda q=q, k=k, v=v, m=mask: F.scaled_dot_product_attention(
                              q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              attn_mask=m),
                          err, (2 * q.numel() + 2 * k.numel()) * 2 + (qs[1] + ks[1]) * qs[0] * 4,
                          pairs * h * 4 * dh, launches, **FLASH_SRC)


def tp_hybrid_records(recs, gen, r0):
    """recurrentgemma-2b's attention kernels at a rank's shapes (TP = 2),
    against their plain versions, a repeat call bit-identical, timed beside
    their bound and the nearest library call: flash at the served prefill
    (5 q heads over the one KV head of 256, window 2048) and the decode
    kernel over the whole ring of 321 rows (G * D = 1280), launches from the
    ``hybrid`` arm; the partial form over a rank's 1024 rows of the long
    arm's split ring (all 10 heads, bf16 and f32; SDPA over the same rows
    the library call) and the merge of the two ranks' triples as
    ``sp_decode`` holds them (strided views of the exchange buffer),
    launches from the ``hybrid long`` arms."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    fams = r0["families"]
    if "hybrid" not in fams and "hybrid long" not in fams:
        return
    cfg = get_config(HYBRID_ARCH)
    dev, bf, n = torch.device("cuda"), torch.bfloat16, TP_RANKS
    hq, dh, g_all = cfg.n_heads // n, cfg.head_dim, cfg.n_heads

    def counts(family):
        return fams[family]["arms"]["contiguous"]["forced"]["counts"]

    if "hybrid" in fams:
        pad = fams["hybrid"]["pad"]
        q = _rand(gen, (1, pad, hq, dh), bf, dev)
        k, v = (_rand(gen, (1, pad, 1, dh), bf, dev) for _ in range(2))
        pos = int_positions(1, pad, dev)
        kw = dict(q_positions=pos, k_positions=pos, causal=True, window=cfg.hybrid.window)
        err = max_err(fa.flash_attention_cuda(q, k, v, **kw),
                      fa.flash_attention_plain(q, k, v, **kw), "bfloat16")
        kernel_record(recs, f"q[1,{pad},{hq},{dh}] kv[1,{pad},1,{dh}] bf16 causal, window "
                      f"{cfg.hybrid.window} (recurrentgemma-2b prefill, a rank's heads at TP = "
                      f"{n})", lambda q=q, k=k, v=v: fa.flash_attention_cuda(q, k, v, **kw),
                      lambda q=q, k=k, v=v: fa.flash_attention_plain(q, k, v, **kw),
                      lambda qt=q.transpose(1, 2), ke=per_head(k, hq), ve=per_head(v, hq):
                      F.scaled_dot_product_attention(qt, ke, ve, is_causal=True), err,
                      (2 * q.numel() + 2 * k.numel()) * 2 + 2 * pad * 4,
                      pad * (pad + 1) // 2 * hq * 4 * dh, counts("hybrid")["flash_attention"],
                      **FLASH_SRC)
        s_ring = pad + MAX_NEW + 1
        qd = _rand(gen, (SLOTS, hq, dh), bf, dev)
        kc, vc = (_rand(gen, (SLOTS, s_ring, 1, dh), bf, dev) for _ in range(2))
        ln = torch.tensor([1, 63, 64, 65, 200, pad + 1, s_ring - 1, s_ring], dtype=torch.int32,
                          device=dev)
        err = max_err(da.decode_attention_cuda(qd, kc, vc, ln),
                      da.decode_attention_plain(qd, kc, vc, ln), "bfloat16")
        n_rows = int(ln.sum())
        amask = (torch.arange(s_ring, device=dev)[None] < ln[:, None])[:, None, None, :]
        kernel_record(recs, f"q[{SLOTS},{hq},{dh}] ring[{SLOTS},{s_ring},1,{dh}] bf16 lengths "
                      f"{ln.tolist()} (recurrentgemma-2b decode over the whole ring, G * D = "
                      f"{hq * dh}: a rank's heads at TP = {n})",
                      lambda: da.decode_attention_cuda(qd, kc, vc, ln),
                      lambda: da.decode_attention_plain(qd, kc, vc, ln),
                      lambda qq=qd[:, :, None], ke=per_head(kc, hq), ve=per_head(vc, hq),
                      m=amask: F.scaled_dot_product_attention(qq, ke, ve, attn_mask=m), err,
                      (2 * qd.numel() + 2 * n_rows * dh) * 2 + SLOTS * 4, n_rows * hq * 4 * dh,
                      counts("hybrid")["decode_attention"], **DECODE_SRC)
    if "hybrid long" not in fams:
        return
    b, s_loc = LONG_BATCH, cfg.hybrid.window // n
    nv = torch.full((b,), s_loc, dtype=torch.int32, device=dev)  # the wrapped ring: all rows
    for dtype_name, dt, family in (("bfloat16", bf, "hybrid long"),
                                   ("float32", torch.float32, "hybrid long f32")):
        if family not in fams:
            continue
        q = _rand(gen, (b, g_all, dh), dt, dev)
        k, v = (_rand(gen, (b, s_loc, 1, dh), dt, dev) for _ in range(2))
        err = max_err(da.decode_attention_partial_cuda(q, k, v, nv),
                      da.decode_attention_partial_plain(q, k, v, nv), "float32")
        elt = 2 if dt == bf else 4
        n_rows = int(nv.sum())
        kernel_record(recs, f"q[{b},{g_all},{dh}] rows[{b},{s_loc},1,{dh}] "
                      f"{'bf16' if dt == bf else 'f32'} n_valid {nv.tolist()}, f32 (acc, m, l) out "
                      f"(recurrentgemma-2b decode over a rank's rows of the split ring of "
                      f"{cfg.hybrid.window}, every head, at TP = {n})",
                      lambda q=q, k=k, v=v: da.decode_attention_partial_cuda(q, k, v, nv),
                      lambda q=q, k=k, v=v: da.decode_attention_partial_plain(q, k, v, nv),
                      lambda qq=q[:, :, None], ke=per_head(k, g_all), ve=per_head(v, g_all):
                      F.scaled_dot_product_attention(qq, ke, ve), err,
                      (q.numel() + 2 * n_rows * dh) * elt + b * 4 + da.partial_numel(
                          b, g_all, dh) * 4, n_rows * g_all * 4 * dh,
                      counts(family)["decode_attention_partial"],
                      name="decode_attention_partial", dtype=dtype_name,
                      source="src/repro_torch/kernels/csrc/decode_attention.cu",
                      replaces="src/repro/kernels/ops.py:324",
                      **({} if dt == bf else {"peak": F32_FLOPS_PER_S}))
    ex = torch.randn((n, da.partial_numel(b, g_all, dh)), generator=gen, device=dev)
    nn_ = b * g_all * dh
    ml = ex[:, nn_:].view(n, b, g_all, 2)
    ml[..., 1].abs_()
    accs, ms, ls = ex[:, :nn_].view(n, b, g_all, dh), ml[..., 0], ml[..., 1]
    err = max_err(da.combine_partial_attention_cuda(accs, ms, ls),
                  da.combine_partial_attention(accs, ms, ls), "float32")
    kernel_record(recs, f"{n} triples acc[{n},{b},{g_all},{dh}] m/l[{n},{b},{g_all}] f32, "
                  f"strided views of the exchange buffer, out [{b},{g_all},{dh}] f32 "
                  f"(recurrentgemma-2b sp_decode's merge at TP = {n})",
                  lambda: da.combine_partial_attention_cuda(accs, ms, ls),
                  lambda: da.combine_partial_attention(accs, ms, ls), None, err,
                  ex.numel() * 4 + nn_ * 4, n * b * g_all * (3 * dh + 8),
                  counts("hybrid long")["combine_partial_attention"],
                  name="combine_partial_attention", dtype="float32", peak=F32_FLOPS_PER_S,
                  source="src/repro_torch/kernels/csrc/decode_attention.cu",
                  replaces="src/repro/kernels/ops.py:354")


def _rmsnorm_args(n, d):
    w = rmsnorm_work("none", n, d)
    return dict(n_bytes=w["bytes"], flops=w["flops"], peak=w["peak"])


def _int8_args(m, k, n, dynamic):
    w = _int8_work(m, k, n, dynamic)
    return dict(n_bytes=w["bytes"], flops=w["flops"], peak=w["peak"])


def timed(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds printed as ``[main] name``;
    then the cached blocks go back to the card, for the work beside."""
    import torch

    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"[main] {name} {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# work beside the main sequence
# --------------------------------------------------------------------------
#
# Most phases keep the host busy and the card idle (eager decode steps at
# small batch), so two of them run beside the main sequence: the tp phase
# (its ranks are processes already; a thread of this process waits on them)
# and the moe and mla phases (a process of their own, ``side_moe``). Every
# kernel record is timed with the card to itself: the records of the phases
# beside are taken after they are joined (tp) or after the main sequence
# has stopped for them (``await_quiet``). The phases whose walls and
# profiled times are taken beside other work are printed when it starts
# (BESIDE).

#: the main-sequence phases that run while the tp phase or the moe / mla
#: process shares the card and the host, by the name of the work beside;
#: their walls and profiled device times are taken under that load (the
#: kernels line is not)
BESIDE = {"tp": ("paged", "speculative", "mixed", "prefix", "router", "parity", "profile",
                 "quant", "hstu", "ssm", "seamless"),
          "moe, mla": ("scanned", "audit", "train", "chameleon", "hybrid", "examples")}

#: set in the moe / mla process: the main sequence's signal that the card is
#: its own (``await_quiet``)
QUIET = {}


class Beside:
    """``fn(*args)`` run beside the main sequence: in a thread of this
    process (``process=False``: for work that only waits on processes of
    its own, as the tp phase's ranks) or in a process started by spawn,
    whose result comes back through a file. ``join`` returns the result or
    raises the failure; after a failure elsewhere ``stop_children`` ends
    a process left running."""

    def __init__(self, name, fn, *args, process=False):
        import threading

        self.name, self.t0, self.box = name, time.perf_counter(), {}
        print(f"[main] {name} starts, beside the phases {', '.join(BESIDE[name])} (their "
              "walls and profiled times taken under its load)", flush=True)
        if process:
            import tempfile

            import torch.multiprocessing as mp

            ctx = mp.get_context("spawn")
            self.quiet = ctx.Event()
            self.tmp = tempfile.mkdtemp(prefix="chip_smoke_side_")
            self.path = os.path.join(self.tmp, "result.pkl")
            self.proc = ctx.Process(target=_side_main, args=(fn, args, self.quiet, self.path),
                                    name=name)
            with expandable_segments():
                self.proc.start()
            self.thread = None
        else:
            self.proc = None
            self.thread = threading.Thread(target=self._run, args=(fn, args), name=name,
                                           daemon=True)
            self.thread.start()

    def _run(self, fn, args):
        try:
            self.box["out"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 -- re-raised by join
            self.box["err"], self.box["tb"] = e, traceback.format_exc()

    def join(self):
        """Waits for the work (a process is told first that the card is its
        own: ``await_quiet``) and returns its result."""
        import pickle
        import shutil

        t_wait = time.perf_counter()
        if self.thread is not None:
            self.thread.join()
        else:
            self.quiet.set()
            self.proc.join()
            code = self.proc.exitcode
            try:
                if code == 0:
                    with open(self.path, "rb") as f:
                        self.box["out"] = pickle.load(f)
                else:
                    self.box["err"], self.box["tb"] = f"its process exited with code {code}", ""
            finally:
                shutil.rmtree(self.tmp, ignore_errors=True)
        now = time.perf_counter()
        print(f"[main] {self.name} {now - self.t0:.1f} s beside the main sequence (which "
              f"waited {now - t_wait:.1f} s for it)", flush=True)
        if "err" in self.box:
            if self.box["tb"]:
                print(self.box["tb"], file=sys.stderr, flush=True)
            raise PhaseError(f"{self.name}: {self.box['err']}")
        return self.box["out"]


def _side_main(fn, args, quiet, path):
    """A Beside process: the card's settings as ``phase_device`` leaves
    them, ``fn(*args)`` with ``QUIET`` set, its result (and its profiler
    retries) pickled to ``path``; exit code 1 on any failure."""
    import pickle

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    QUIET["event"] = quiet
    try:
        out = fn(*args)
        with open(path, "wb") as f:
            pickle.dump((out, PROFILE_RETRIES), f)
    except BaseException:  # noqa: BLE001 -- reported, and the exit code says it
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def await_quiet(tag: str) -> None:
    """In a Beside process: waits until the main sequence has stopped for
    it, so that what follows is timed with the card to itself. A no-op in
    the main process."""
    ev = QUIET.get("event")
    if ev is None:
        return
    t0 = time.perf_counter()
    ev.wait()
    print(f"[{tag}] waited {time.perf_counter() - t0:.1f} s for the card to itself",
          flush=True)


def side_moe(pad_to):
    """The moe and mla phases, in a process beside the main sequence.
    Returns the MLA kernel records, timed after ``await_quiet``."""
    timed("moe", phase_moe, "qwen3-moe-30b-a3b", pad_to)
    return timed("mla", phase_moe, "deepseek-v2-236b", pad_to)[2]


@contextlib.contextmanager
def expandable_segments():
    """Processes started inside take the caching allocator's expandable
    segments (unless the caller set ``PYTORCH_CUDA_ALLOC_CONF``): the tp
    ranks and the moe / mla process build whole models while other
    processes hold the card, and a model's f32 draws cast to bf16 leave
    cached segments too fragmented to hand back. This process's own
    allocator, set up already, keeps its segments."""
    key = "PYTORCH_CUDA_ALLOC_CONF"
    had = os.environ.get(key)
    if had is None:
        os.environ[key] = "expandable_segments:True"
    try:
        yield
    finally:
        if had is None:
            os.environ.pop(key, None)


def stop_children() -> None:
    """Ends every process this one started that still runs (a failure
    left the work beside unjoined): nothing outlives the script."""
    import multiprocessing

    kids = multiprocessing.active_children()
    for p in kids:
        p.terminate()
    for p in kids:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable from {ROOT}/src: {e}")
    if sys.argv[1:2] == ["tp"]:  # the tp phase alone (or its named families): no result lines
        TP_ONLY.extend(sys.argv[2:])
        check(all(f in TP_FAMILIES for f in TP_ONLY), f"tp: unknown families {TP_ONLY}")
        try:
            phase_device()
            phase_build()
            from repro_torch.launch import serve
            from repro_torch.training import data as data_mod

            pad_to = serve.trace_pad_to(data_mod.PAPER_PROFILES["llama_humaneval"],
                                        N_REQUESTS, SEED)
            tp_kernel_records(pad_to, phase_tp(pad_to))
        except Exception:
            traceback.print_exc()
            fail("the tp phase failed")
        print("[tp] the tp phase alone passed", flush=True)
        return
    if sys.argv[1:2] == ["ep"]:  # the ep arm alone: no result lines
        try:
            phase_device()
            phase_build()
            ep_kernel_records(phase_ep())
        except Exception:
            traceback.print_exc()
            fail("the ep arm failed")
        print("[ep] the ep arm alone passed", flush=True)
        return
    try:
        gpu = timed("device", phase_device)
        timed("build", phase_build)
        from repro_torch.launch import serve
        from repro_torch.training import data as data_mod

        pad_to = serve.trace_pad_to(data_mod.PAPER_PROFILES["llama_humaneval"],
                                    N_REQUESTS, SEED)
        records = timed("kernels", phase_kernels, pad_to, pad_to + MAX_NEW + 1)
        cfg, model, params, trace, runs = timed("serve", phase_serve, pad_to)
        extend_records, _ = phase_extend(cfg, model, params, pad_to)
        records += extend_records
        # the tp phase's ranks serve beside the BESIDE["tp"] phases (no
        # graph capture while its thread runs: scanned and audit come later)
        TP_BESIDE["on"] = True
        tp = Beside("tp", phase_tp, pad_to)
        paged_counts, paged_toks = timed("paged", phase_paged, cfg, model, params, pad_to,
                                         runs["continuous"][1])
        spec_counts, sampled_toks = timed("speculative", phase_speculative, cfg, model, params,
                                          pad_to, runs["continuous"][1])
        mixed_counts = timed("mixed", phase_mixed, cfg, model, params, pad_to,
                             runs["continuous"][1])
        timed("prefix", phase_prefix, cfg, model, params)
        t0 = time.perf_counter()
        fleet_want = phase_router(cfg, model, params, pad_to, {"serve": runs["continuous"][1],
                                                               "sampled": sampled_toks,
                                                               "paged": paged_toks["paged"]})
        print(f"[router] phase {time.perf_counter() - t0:.1f} s", flush=True)
        timed("parity", phase_parity, model, params, pad_to, trace[:2], runs["continuous"][1])
        timed("profile", phase_profile, model, params, pad_to, trace,
              fused=fused_per_forward(cfg))
        arms = timed("quant", phase_quant, cfg, model, params, pad_to, trace)
        hstu_counts, hstu_f32_counts = timed("hstu", phase_hstu)
        ssm_counts, ssm_f32_counts = timed("ssm", phase_ssm, pad_to)
        seamless_counts, _ = timed("seamless", phase_seamless)
        records += timed("tp kernel records", tp_kernel_records, pad_to, tp.join())
        # the DP x TP fleet's two processes serve with the card to themselves:
        # beside the tp ranks' MoE and MLA models the card ran out of memory
        TP_BESIDE["on"] = False
        timed("tp fleet", phase_tp_fleet, pad_to, fleet_want)
        # expert parallelism's two processes, the card to themselves too
        records += timed("ep kernel records", ep_kernel_records, timed("ep", phase_ep))
        # the moe and mla phases serve in a process of their own beside the
        # BESIDE["moe, mla"] phases; their kernel records wait for the join
        side = Beside("moe, mla", side_moe, pad_to, process=True)
        phase_scanned(cfg, model, params, gpu)
        phase_audit(model, params, gpu)
        del model, params
        torch.cuda.empty_cache()
        phase_train()
        chameleon_counts, _ = timed("chameleon", phase_chameleon)
        t0 = time.perf_counter()
        hybrid_counts, long_counts = phase_hybrid(pad_to)
        print(f"[hybrid] phase {time.perf_counter() - t0:.1f} s", flush=True)
        phase_examples()
        mla_records, side_retries = side.join()
        records += mla_records
        PROFILE_RETRIES.extend(side_retries)
        records += timed("hybrid kernel records", hybrid_kernel_records, pad_to, hybrid_counts,
                         long_counts)
        dense_pad = serve.trace_pad_to(data_mod.PAPER_PROFILES["llama_humaneval"],
                                       DENSE_REQUESTS, SEED)
        t0 = time.perf_counter()
        dense_counts, kept = phase_dense(dense_pad)
        print(f"[dense] phase {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        windows = phase_characterize(kept)  # takes yi-34b out of ``kept`` and frees it
        print(f"[characterize] phase {time.perf_counter() - t0:.1f} s", flush=True)
        records += dense_kernel_records(dense_pad, dense_counts, windows[("T-T", "P")][1])
        records += timed("smoke_configs", phase_smoke_configs)
        # each kernel's launches come from the run of the path it is on; an
        # f32 route's from the f32 run of its path
        path_counts = {"paged_decode_attention": paged_counts["paged"],
                       "int8_matmul_weight_only": arms["wo"],
                       "int8_matmul_dynamic": arms["dyn"],
                       "hstu_attention": hstu_counts, "ssd_scan": ssm_counts}
        f32_counts = {"hstu_attention": hstu_f32_counts, "ssd_scan": ssm_f32_counts}
        paths = {"serve": runs["continuous"][2], "chunked": paged_counts["chunked"],
                 "spec": spec_counts["spec t=0.8"], "spec_paged": spec_counts["spec t=0.8 paged"],
                 "hstu": hstu_counts, "ssm": ssm_counts, "seamless": seamless_counts,
                 "chameleon": chameleon_counts, "mixed": mixed_counts,
                 "hybrid": hybrid_counts,
                 **{f"dense {a}": dense_counts[a]["contiguous"] for a in dense_counts}}
        for r in records:
            if "launches" in r:  # the MLA shapes: counted per shape in their arm's run
                pass
            elif "path" in r:  # RMSNorm by prologue, flash's mixed step, the multimodal
                # shapes: the count on their path
                r["launches"] = paths[r.pop("path")][r.pop("counter")]
            else:
                counts = f32_counts if r.get("dtype") == "float32" else path_counts
                r["launches"] = counts.get(r["name"], runs["continuous"][2])[r["name"]]
            check(r["launches"] > 0, f"{r['name']} was not launched on its served path")
        torch.cuda.synchronize()
        print(f"[profile] profiler sessions that lost device kernels and were taken again: "
              f"{len(PROFILE_RETRIES)} {json.dumps(PROFILE_RETRIES)}", flush=True)
    except Exception:  # any phase failure: report and exit non-zero
        traceback.print_exc()
        stop_children()
        fail("a phase failed")
    except SystemExit:  # a phase's own ``fail``
        stop_children()
        raise
    print(gpu, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
