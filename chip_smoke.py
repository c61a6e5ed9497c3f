#!/usr/bin/env python3
"""Drive the PyTorch port (indextts_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py    # one card; no arguments

Phases, in order; any failure exits non-zero and nothing is caught:

1. Environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, the build of every CUDA kernel from csrc/ (one nvcc per source,
   all started together); then the port's environment check
   (indextts_tpu_torch/tools/env_check.py, a process of its own: every
   kernel library loaded, the native DSP, a matmul check), which must exit
   0.
2. Kernels: K1 (ragged decode attention), K2 (anti-aliased SnakeBeta), K3
   (DiT attention), K4 (int8-cache decode attention), K5 (W8A8 GEMV), K6
   (fused W8 MLP), K7 (W4A8 GEMV) and K8 (fused W4 MLP) against their plain
   PyTorch versions, at the shapes the main path gives them at full width
   and at edge cases, each within its stated tolerance. Times are device
   times: CUDA events around replays of a CUDA graph of repeated calls, so
   the host's launch cost is left out. K1's and K4's are per call (one layer
   of one decode step), K2's per vocoder call (its 37 launches), K3's per
   call (one DiT layer of one CFM step), K5's per decode step (its 49
   launches: c_attn and attn c_proj of 24 layers, and the logits head), K7's
   per decode step (its 48 launches: c_attn and attn c_proj of 24 layers),
   K6's and K8's per call (one layer's MLP). Weights and caches cycle over
   24 layers' worth, K1's, K4's, K5's and K7's over enough copies to pass
   100 MB (twice the L2), so they come from device memory as in a decode
   step, not from L2; each of K2's 37 launches reads its own input (1.57
   GB in all, the mel at the s2mel bucket's 640 frames, as the engine
   vocodes it), and K2 is also timed at the longest segment's shapes
   (`time_k2`, which tools/snake_times.py runs on another tree). K1 and K4
   are timed at the main path's last step and
   at the default config's cap (1657) with valid 1657, 1000 and 400: their
   work follows valid_len (`time_k1`, `time_k4`, which
   tools/decode_attention_times.py runs on another tree, such as a parent
   commit, so that two trees timed in turns are timed alike). `bound_ms` is the
   larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s (float32)
   or 1979 TOP/s (int8) (H100 SXM data sheet). `library_ms` times one PyTorch call on the same inputs as a
   yardstick the port never calls: scaled_dot_product_attention (K3; for
   K1 the faster of SDPA masked over the whole cache and SDPA unmasked over
   k[:, :, :valid], which computes K1's function where the hole is empty),
   and torch._int_mm with the activation padded to the 17 rows it accepts
   at least, int32 out without the float epilogue, over the unpacked int8
   weight for K7 and K8 (K5-K8; two products for K6 and K8); none for K2
   and K4. K3's `bound_ms` counts 3 x its operations on the TF32 tensor
   cores (495 TFLOP/s), where it runs in 3xTF32; the float32 bound is
   printed beside it. K3 runs at the CFM solve's width, the target's
   128-frame bucket (T=898 with 774 valid frames at the main path), and is
   also checked at the longest segment the default config allows (T=2946
   with 2838 valid), below one tile, with a row of one valid
   key and with a row of none, at a batched solve's 16 rows (8 unequal
   valid counts, each in the cond and the null half), on the DiT's strided views (against their
   contiguous copies, to the bit) and called again (the same bits). K2 is
   checked at every shape of a vocoder call at the main path and at the
   longest segment, at the five cases checked before the redesign, and at
   edge cases from its plan, at a batched vocoder call's 8 rows of its
   first shape (C=2304, T=2560), and at further cases (`k2_cases`: T = 1, 2, 3, 7, at a warp's chunk
   of 32 x 12 outputs and at a block's four, one either side, a last chunk
   of one lane, T % 4 != 0, logscale False, a last block of one warp, beta
   exp(-4) on every fourth channel, held to 2e-5 plus 1e-5 of the plain
   output), printing the largest |alpha u| its sines see.
   K1 (float32 and bfloat16 caches) and K4 are also checked at valid 1-2,
   15-17 and 127-129 (the edges of a 16-key chunk and of a cluster rank's
   share), with unequal rows, a hole across the ranks' boundaries, a hole
   over every key but one, shares that take two rounds (cap 3000), the
   continuous phase's slot state (8 rows in one cache of cap 512 at unequal
   valid lengths 158-457, holes of unequal length from the conditioning's
   end, 34, one row without a hole and an idle row attending one key), a
   batched request's 8 rows (one prompt, each row its own hole, at one
   step) and, for K1, a row with no key (zeros). K5-K8 are also checked at 16 rows and at
   17 and 40 rows, which go in chunks.
   K5 and K7 are also checked at F=384, at D=2048 and at a contraction long
   enough for three passes of weight boxes a block; K6 and K8 at one group
   and at D=1536 and D=2048 (other column slices a block; D=2048 also at 16
   rows). K1, K2 and K4-K8 are called again and replayed from a CUDA graph
   (the same bits every time), and torch.profiler counts the device kernels
   one call of each of K1-K8 launches (one). K5-K8 print the host us of
   an eager call.
   K2's and K3's bfloat16 instantiations (`check_k2_bf16`,
   `check_k3_bf16`) are checked against their plain versions: K3-bf16 at
   the main path's solve on the DiT's strided views, the longest segment,
   T=37, a row with one valid key, a row with none, a batched solve's
   16 rows and a row whose first and a middle 128-key tile hold no valid
   key (`k3_bf16_cases`), the kernel no farther from the float32 attention
   of the same bfloat16 inputs than its plain version and within 3e-2 of
   max|out| of it, every row with a valid key keeping its bits when the k
   and v of its masked keys are replaced by other draws, and 0 bytes of
   spills (its registers printed); K2-bf16 (a kernel of its own, both
   FIRs on the tensor cores) at every shape of a vocoder call at the
   main path and the longest segment, at 8 rows, and at the edges of its
   tiling (`k2_bf16_cases`), within 2e-5 + 2^-7 of the plain version
   rounded to bfloat16 (one bfloat16 step), with 0 bytes of spills (its
   registers printed) and a checksum of the float32 K2's output on fixed
   inputs (`k2_checksum`, to compare with another tree). Each is one
   launch, repeats its bits and is timed in turns with its float32
   instantiation on the same values (K3 at the main path, the longest
   segment and 16 rows, `time_k3_bf16`, which tools/dit_times.py runs on
   another tree; K2-bf16 over an 8-row vocoder call, where the batched
   route runs it, and over one row, `time_k2_bf16`, which
   tools/snake_times.py runs on another tree); K3-bf16's bound counts 989
   TFLOP/s bf16, its library_ms is SDPA on the bfloat16 tensors.
3. Slice: a small configuration whose heads are 64 wide runs greedy on the
   card and on the CPU (plain versions) from the same weights and CFM noise:
   float; quantized W8 (gpt_quantize, head_quant, kv_quant, gemv_impl
   "pallas": at D=128 it runs K4, K5 and K6); quantized W4 (the same with
   gpt_wbits=4 at D=256, where K7 and K8 open); codes must match and mel and
   waveform agree. Then phase `reference_dir`: the full-width default
   configuration's (GPT 24L x 1280, DiT 13L x 512, BigVGAN v2 22 kHz,
   w2v-BERT 2.0, RepCodec, CAMPPlus) seeded random weights
   (random_params(cfg, seed=0) on the card), copied to the host, are
   written into a checkpoint directory in the reference's layout
   (`write_reference_dir`: gpt.pth with a seeded text_head; s2mel.pth as
   {"net"} with `module.` prefixes; the DiT's final linear, WaveNet,
   RepCodec's projections and every BigVGAN convolution as weight-norm
   pairs;
   hf/w2v-bert-2.0/model.safetensors with all 24 layers and a
   masked_spec_embed, written by this script's own safetensors writer;
   hf/semantic_codec.safetensors, hf/campplus_cn_common.bin,
   hf/bigvgan_generator.pt; the stats; feat1.pt and feat2.pt, the emotion
   phase's seeded banks; no config.yaml, bpe.model or Qwen directory),
   printing each file's bytes and the seconds taken. Then `cache_phase`
   (the loader's converted-weights cache, float route): the directory's
   free disk, a cold load (the files converted, torch_cache/ written) and
   a warm load (torch_cache/ read), the read, write and build seconds of
   each and the cache's bytes; every tensor of the warm engine, the banks
   and the stats equal to the cold engine's to the bit, and one segment's
   greedy codes equal. Each route's server is
   built with `--model-dir` on that directory (runtime/loader.py), which
   must read the cache, printing
   the load's seconds (reading the cache, building the engine on the card),
   the host's peak resident memory, the peak device memory and the models
   filled with random weights, which must be none; on the float route every
   tensor of every module (and the banks and stats) is held to what was
   written: equal to the bit, or within 1e-6 of its largest |value| where
   a weight-norm pair was folded. The engine is served by the port's own
   server on localhost on three routes, one engine on the card at a time:
   float, then quantized W8 with gemv_impl "pallas", then quantized W4
   with gemv_impl "auto", which resolves to the kernels on the card. On
   the float route the server's background precompile (TARS_PRECOMPILE=1,
   over the main path's envelope, TARS_PRECOMPILE_CODES=300) is waited
   for, its job count, seconds and the peak device memory after it
   printed; the requests must then capture nothing new (the decoder's and the three tail runners'
   graph counts do not rise). The other routes capture on demand
   (TARS_PRECOMPILE=0). Every kernel's launch
   counter is set to 0, a few POST /tts requests go out with a seeded
   synthetic 3-s speaker wav, each answer must be a 200 with a valid,
   non-silent WAV from finite mels, and every counter of the route must have
   risen, those of other routes staying at 0 (float: K1-K3; W8: K2-K6; W4:
   K2-K5, K7, K8, with K5 the logits head). On the float route the live-
   server smoke tool (indextts_tpu_torch/tools/run_server_test.py) then
   runs against the server in a process of its own (healthz, readyz, a
   WAV, a stream) and must exit 0. Only runtime.max_mel_tokens is
   lowered, since random weights rarely emit the stop token. The GPT
   decode replays a captured step (runtime/decode.py); then, on each
   route's engine, `decode_turns` runs one request's decode captured and
   eager (the decoder's `eager` argument) from one seed, 2 rounds in turns:
   the codes must be the same every time, and each run prints decode
   tokens/s, wall time and stage seconds; torch.profiler must find the
   same device kernels by name and count in one replay as in one eager
   step (less the generator's seed and offset, which PyTorch writes before
   a replay); 8 replays are timed with CUDA events (the W8 and W4 routes
   run one round, graph then eager, so that the script keeps its time
   with `bf16_phase`); and the reserved
   device memory the decode states free is printed. Phase 3 runs with
   TARS_STAGE_SYNC=1, so each stage's seconds hold its time on the card.
   The requests take the keyed route (the server's default prompt is a
   file path); on each route `keyed_prefill_gate` holds the keyed
   prefill's first-step logits and the float KV of the prompt's slots to
   the monolithic prefill's (1e-3 float, 1e-2 W8/W4, relative) and prints
   how many of 300 greedy codes the two routes share.
   After the float route's requests, `s2mel_turns` runs one segment's s2mel
   stage with its CFM solve replayed from the captured graph and eagerly
   (the runner's `eager` argument), 2 rounds in turns: the same mel to the
   bit every time, both stage times printed, K3 launched 20 x 13 = 260
   times a stage either way; torch.profiler must find the same device
   kernels by name and count in one replay as in one eager solve; 4
   replays are timed with CUDA events against the solve's float32 floor;
   the solve shapes cached and their graphs' pool are printed. Then
   `tail_turns` does the same for the segment's latent pass and vocoder
   call (runtime/graphs.py `LatentRunner`, `VocoderRunner`): replayed and
   eager in turns, 2 rounds, every output equal to the first eager one to
   the bit, both stages' seconds printed, K2 launched 37 times a vocoder
   call either way; a replay's device kernels by name and count against an
   eager call's; 4 replays of each timed with CUDA events; the keys cached
   and the pools' bytes. Then `stream_phase`, over the same engine with
   TARS_STAGE_SYNC unset (it turns the tail overlap off) and restored: a
   sequential server streams a 200-byte text (2 segments) through POST
   /tts/stream and POST /tts with the overlap on and off in turns (the
   same PCM all four times, the stream's trailing silence aside), then the
   text in 3 segments (quick_streaming_tokens 40) through /tts/stream, on
   and off in turns, 2 rounds (the same PCM), each printing its first
   chunk's seconds, wall, audio seconds and each segment's decode
   seconds; then one segment keyed and unkeyed in turns (the gpt_decode
   stage) and the host-timed parts of a segment's prompt work.
   Then `emotion_phase` (float): a small Qwen3 on the card against the CPU
   (prefill logits within 1e-4 of the largest, the same greedy tokens
   captured, eager and on the CPU); Qwen3-0.6B at full width with seeded
   random weights made on the card, behind the stand-in tokenizer
   `qwen_prompt` / `qwen_text` (no Qwen tokenizer is in the repo): the
   prefill's ms, the captured and the eager decode in turns (the same
   tokens; ms a token), a replay's kernels against 16 replays timed (idle
   inside the step) beside the step's bound (2.384 GB of weights at 3.35
   TB/s, 0.712 ms), one inference() call's seconds; the emotion banks of
   the real shapes (73 x 1280, 73 x 192) loaded from the directory, the
   emotion rows scaled to the prompt's emovec spread; through a
   sequential server, counters set to 0 before and read after (K1-K3
   rise): /tts with an emo_vector twice (the second must hit its key),
   without one, and unkeyed, each printing gpt_decode; a /tts/stream with
   the vector; /tts with use_emo_text, 400 without a Qwen and 200 with the
   full-width one attached (the vector it read, the Qwen's seconds).
4. Continuous batching (runtime/batcher.py), on each route right after its
   phase 3, over the same engine (full width, max_mel_tokens 300): the
   port's server is built again over it with TARS_MAX_CONCURRENCY=8, so
   TARS_CONTINUOUS_SLOTS "auto" gives 8 slots (chunks of 32 steps, 2 tail
   workers). On its engine, a 4-slot state with rows at unequal positions
   and holes: one batched greedy step's logits against each row's
   single-row step (1e-4 of the row's largest logit float, 1e-2 quantized)
   with the same codes; 16 sampling steps eagerly, captured (beside a
   running tail) and replayed, the same bits every way; a replay's device
   kernels by name and count against an eager step's, and 8 replays timed;
   the captured step also timed at 1 and 8 slots.
   Then 8 concurrent POST /tts through the continuous server and the same
   8 through a sequential server over the same engine, in turns
   (continuous, then sequential): each answer a WAV as long as its
   tail's waveform, with finite samples; each turn prints aggregate audio s
   per wall s and decode tokens/s, request wall p50 and max and the stage
   seconds; a continuous turn also its chunks and the launches a chunk of
   K1/K4-K8, whose counters must rise on the route and stay 0 off it; the
   slot state's memory, peak memory, and that K6/K8's per-stream arrival
   counters were made on decoder streams only. On the float route one
   /tts/stream goes through the continuous server, then a client leaves
   a stream after its first chunk, and a /tts after it must answer 200;
   then one /tts with an emo_vector (`emotion_continuous`).
5. The beam route (runtime/decode.py `generate_beam`), on each route's
   engine after its phase 3 (float: after `emotion_phase`): the small
   configurations of phase 3 also run deterministic 3-beam search on the
   card and on the CPU (the same codes), and K1 and K4 are checked at a
   beam's 3 rows (one prompt's hole, equal valid lengths). Float:
   `precompile(num_beams=3)` over the request text's 16-bucket captures
   one beam step; a /tts request to a server built with `--num-beams 3`
   (beam-multinomial, the config's default do_sample) must answer a WAV,
   capture nothing new and launch the route's kernels only (counters set
   to 0 just before it, read just after); a sampling request to a
   `--num-beams 1` server on the same text prints its gpt_decode beside
   it; `beam_turns` runs deterministic 3-beam search captured and eager
   in turns (2 rounds, the same codes, tokens/s), a replay's kernels
   against an eager step's by name and count, 8 replays timed, the
   reorder of the caches by a beam index timed alone, and the state's
   buffers. W8 and W4: one such beam request each, with the route's
   counters rising (W8: K2-K6; W4: K2-K5, K7, K8). The launches a beam
   request takes are printed per route before the kernels line.
6. Batched segments (runtime/engine.py `synthesize_segments_batched`,
   `infer(..., batched=True)`), on each route's engine after its phase 5.
   The small configurations of phase 3 also run a batched request of 3
   segments on the card and on the CPU (the same codes, the waveform
   within the route's tolerance). Float (`batched_phase`): the warm-up at
   512 codes from nothing captured (jobs, seconds, peak memory); a
   batched request of 8 segments of unequal length (46-53 ids, so every
   row has its own pad hole) captures its B=8 keys and must leave every
   warmed key in place, and a sequential request after it must capture
   nothing; 2 rounds of the batched request against the same 8 segments
   one after another, in turns (wall, audio s per wall s, stage seconds,
   decode tokens/s; launches counted with the counters set to 0 just
   before a batched request and read just after); the batched decode
   captured against eager (the same codes); the 8-row CFM solve's replay
   against the eager solve (the same bits, the same kernels by name and
   count), 2 replays timed against its float32 floor, its largest
   kernels; one replay of the 8-row latent pass and vocoder; the batched
   decode state's bytes, the runners' pools and the peak memory. W8 and W4
   (`batched_request`): one batched request each, wall, stages and
   launches (W8 also captured against eager). The launches a batched
   request takes are printed per route before the kernels line.

7. `bf16_phase` (the JAX engine's bf16 compute modes), after the float
   route's batched phase, its float32 engine still loaded; each engine
   is loaded from the checkpoint directory (`bf16_engine`, printing the
   MiB each model stores). The float route with gpt_dtype bfloat16 and a
   bfloat16 s2mel and vocoder: one /tts through a sequential server,
   counters set to 0 just before and read just after (K1 over a
   bfloat16 cache, K3-bf16, and K2 through the float32 vocoder sibling
   must rise; K3, K2-bf16 and K4-K8 stay 0), then 2 rounds of a
   one-segment request in turns with the float32 float route (wall,
   decode tokens/s, stage seconds, device memory beyond what was
   allocated). Then JAX bench.py's quantized configuration
   (`bench_config`: W8 blocks, an int8 KV cache, the head float,
   gemv_impl "pallas"), one engine in float32 and one with gpt_dtype,
   s2mel and vocoder bfloat16: a counted /tts on each (the bf16 one:
   K3-bf16, K4-K6 and K2 through the sibling; K3 and K2-bf16 0), a
   counted batched 8-segment request on each (the bf16 one through
   K2-bf16 and K3-bf16; K2 and K3 0), 2 rounds of a one-segment and a
   batched request in turns, `bf16_tail` (the bf16 engine's codes
   through the float32 and the bfloat16 tail over one GPT latent and one
   CFM noise: the mel's and the waveform's relative L2 apart, and the
   PCM16 steps the bfloat16 clip moves a sample, at the served peak and
   scaled to 0.9) and the runners' graph pools (the dual vocoder's two).
   K2-bf16's launches come from its batched request, K3-bf16's from its
   /tts.
8. `train_phase` (runtime/train.py, finetune.py), after the three routes'
   engines are freed, at full width (GPT 24L x 1280 with its text_head;
   S2Mel with the DiT 13L x 512), seeded random weights, AdamW at lr
   1e-4: `finetune.main` on the card for each target (synthetic batches
   of 8: two steps with a save, then a resume for one more, which must
   start at step 2 and end at 3), then ten make_cfm_train_step steps on
   the main path's solve shape (8 rows of T=898, the batched solve's
   valid frames, 774 down) and ten make_train_step steps on its text ids
   and codes, printing the losses, the first step's seconds, steps/s and
   the peak device memory. Every kernel count is set to 0 just before the
   CFM steps and read after: K3, K9 and K10 once a DiT layer a step (13),
   every other kernel 0; the GPT steps launch none. The CFM loss at one
   fixed draw of t, z and drop must fall over the steps, the GPT's step
   loss on its fixed batch too; then torch.profiler takes the device
   kernels of three more steps of each (device ms against the step, the
   idle share, K3's, K9's and K10's share, the largest kernels). K9's and
   K10's `launches` come from the CFM steps. Phase 2 checks K3's row statistics and K9 and K10
   (`check_k9_k10`) against autograd through the plain attention at K3's
   cases and a mask whose valid keys are no prefix, each gradient within
   2e-5 of max(1, max|plain|), dK and dV exactly 0 at masked keys of rows
   with a valid key, repeating its bits, with no register spills; timed
   at the main path, the longest segment and 16 rows (`time_k9_k10`,
   which tools/dit_bwd_times.py runs on another tree), with the backward
   of scaled_dot_product_attention as library_ms. No /tts request of any
   route launches K9 or K10.
9. The rest of the serving path (PR 24). On the float route after
   `tail_turns`, `native_dsp_phase`: the native host DSP (utils/native.py,
   csrc/dsp.cpp built with g++ on first use) against numpy on the 3-s
   prompt's fbank (host ms, within 1e-4), and the route the engine's
   features take (native twice a prepare_speaker); then `prefix_phase` on
   the float route and on W8 + int8 KV (after its requests): text-prefix
   KV reuse turned on, two keyed greedy requests whose texts share 77 ids
   (a miss caching the 64-id grid prefix, then a hit), each with its K1 or
   K4 launches, the tail it prefilled against the prompt's length and the
   cache's entries and MiB; the same two with the flag off (codes in
   common printed); the hit's last logits and KV against the monolithic
   prefill's within KEYED_TOL; the prompt prefill's device ms monolithic,
   keyed and on the hit, in turns. Before `train_phase`, `dilation_phase`:
   a full-width BigVGAN whose resblocks differ in their dilations, one
   vocoder call at 640 frames (one resblock at a time: K2 launched 109
   times) held to the same call with K2's plain version, timed beside the
   release config's lockstep call.
10. `v1_phase` (IndexTTS v1, runtime/engine_v1.py), after the three routes
   and before `dilation_phase`: the JAX package's v1 defaults at full
   width (GPT 24L x 1280 over a 100-bin mel, condition_module input 100;
   BigVGANv1Config(): 1536 initial channels, rates (4, 4, 2, 2, 2, 2),
   ECAPA (512, 512, 512, 512, 1536)), seeded random weights
   (random_params_v1 on the card), the 3-s prompt. Float route, then W8
   (quantize_gpt, kv_quant, head_quant, gemv_impl "pallas"): infer_fast of
   3 segments of unequal length (one bucket of 3 rows), 300 codes at most,
   seed 0, twice (the first captures the decode step), printing wall,
   decode tokens/s and stage seconds; the audio finite at 24 kHz, the codes
   inside the vocabulary; every kernel count set to 0 just before the
   second request and read just after (float: K1 and 37 K2; W8: K4, K5, K6
   and 37 K2); ECAPA's device ms over the 3 rows; greedy decode of 128
   codes captured and eager, the same codes. Float: K1 at the bucket's
   first and last step (B=3, a 32-position conditioning, each row its own
   hole) and at the longest call's 4 rows of 600 codes, K2 at every shape
   of a v1 vocoder call at 300 codes (3 rows) and at 600 (4 rows, C=72 at
   T=614,400), each against its plain version at phase 2's tolerance, K2
   timed over one row's vocoder call at 300 codes (`time_k2`); one
   vocoder call over 3 rows of 300 latents with K2 (37 launches) against
   the same call with plain K2 (1e-3 of its peak), both timed. W8: K4 at
   those cases, K5 (c_attn, attn c_proj, the head) and K6 at 3 rows. Then
   one DVAE.get_codebook_indices at full width (DVAEConfig()) on the
   card, each code the nearest entry by the CPU's distances.
11. `sampling_phase` (runtime/decode.py SamplingConfig, the JAX fields), on
   the float route after `batched_phase`: decoders over its full-width GPT.
   `ban_stop_token` decodes exactly 300 codes, none of them stop,
   captured; greedy captured against eager with each knob flipped on its
   own (128 codes); a sampled decode with the typical filter, captured
   against eager from one seed; a captured step with the typical filter
   timed against one without, in turns.
12. `parallel_phase` (parallel/), after `train_phase`, at full width from
   PARALLEL_SEED: (a) NCCL at a world of 1, the GPT cut over
   make_mesh(1, 1) gives the one-process float decode's 32 codes and last
   logits bit for bit; (b) two processes on the one card over gloo
   (`parallel_worker`), make_mesh(1, 2): TP greedy decode of 32 codes
   (stop banned) on the float and the W8 GPT token-exact with the
   one-process runs, 10 of 20 heads a rank; the TP DiT velocity (4 of 8
   heads) within 1e-4 of the largest value of the one-process one; K1 and
   K3 counted at those head counts and checked against their plain
   versions; (c) make_mesh(2, 1), one data-parallel CFM step at 4 rows
   against the one-process step (loss within 1e-5 relative, the averaged
   gradient within 1e-4 of each leaf's largest value, parameters within
   1e-5). Each prints its time and its collectives' share, with the card's
   name and power limit: two ranks share one card, so no scaling is
   measured.
13. `tools_phase` (indextts_tpu_torch/tools/), after the three routes, on
   `reference_dir`'s directory: verify_checkpoint --synth (every component
   ok, finite audio); precompute's .npz loaded back gives the fresh
   speaker's codes and waveform bit for bit; build_dataset, 3 utterances
   on 2 threads (--deterministic), then a resume that launches no kernel;
   synthesize_clips synth --batched of 2 phrase-bank clips. The last three
   share one engine. Each tool's seconds printed. Then `eval_phase`
   (tools/eval_quality.py main on the same directory, float route, the
   library's 3-beam decode, 300 codes at most): examples/cases.jsonl's 6
   cases against the synthetic prompt, --asr mock, controls on, seed 0;
   every case's row, with WER 0, finite cosines and K1, K2 and K3 each
   launched in each case (launches printed a case), then one case with
   --mock-asr-drop 0.5, whose WER must be above 0; the aggregate, the
   controls' margins and the meta flags printed (random weights:
   spk_sim_discriminative false is expected, not a failure). Then
   `soak_phase`: tools/soak_server.py in a process of its own with
   TARS_CHECKPOINT_DIR set to the directory (its own defaults: W8 + int8
   KV, 192 codes, sequential, no precompile), SOAK_REQUESTS requests from
   4 clients in SOAK_WAVES waves; exit 0 (host RSS, device memory and p50
   drift within its gates), its device gauge "memory_stats", each wave's
   line (p50, RSS, GB in use, captured graphs) and the summary printed.
   Then `bench_phase`: the six measurement tools, each in a process of its
   own at full width as a user runs it, at short settings (BENCH_TOOLS):
   all at once, so that their start-ups overlap (their numbers checked,
   not compared: they share the card): `python -m indextts_tpu_torch.bench`
   (BENCH_RUNS=1, every section on: W8 + int8 KV, bf16 s2mel and vocoder),
   tools/benchmark_infer.py on a 2-case file over the directory,
   bench_server_concurrent.py in each mode, the two processes that
   run_server_bench.sh runs one after the other (2 clients x 2 requests,
   both passes), bench_s2mel.py at one shape, and bench_w4.py and
   bench_decode_kernels.py at a hundred or two steps. Each
   must exit 0 and print parsable JSON: the bench's lines progressive
   supersets with every section landed and none failed, its value,
   tokens/s and every section's number finite and above 0 (the batched
   stages' host trim at least 0), its timed runs' decoded codes exactly
   BENCH_MEL_TOKENS x BENCH_RUNS (the stop token banned) and its tokens/s
   within 10 % of them over the timed runs' gpt_gen seconds, its
   `device.name` the card's, K2, K3-bf16, K5 and K6 launched in its timed
   runs (W8's "auto" GEMV route takes K5 and K6 on the card), K4 exactly
   24 layers x (BENCH_MEL_TOKENS - 1) steps x BENCH_RUNS, and K1, K7, K8
   not; the other tools' numbers finite and above 0, each A/B
   run's kernel launches those of its route (bench_s2mel: K3 and K3-bf16
   260 a solve; bench_w4: K7 and K8 only on W4; bench_decode_kernels: K5
   and K6 under "pallas" and "auto", K1 only on the float cache, K4 only
   on the int8 one). Each tool's headline printed on a line of its own.
14. `tp_train_phase` (training over the model axis), after
   `parallel_phase`, at full width: two processes on the one card over
   gloo, make_mesh(1, 2) (`tp_train_worker`). One CFM step at the main
   path's solve (8 rows, T=898; DiT at 4 of 8 heads a rank: K3 with its
   statistics, K9 and K10 13 launches each a rank, counted) and one GPT
   step (TP_GPT_ROWS rows; 10 of 20 heads; no kernel), each held to the
   one-process step on the card (TF32 off): loss within 1e-5 relative,
   the gathered gradient within 1e-4 of each leaf's largest |value|; each
   step's ms and its collectives' share printed; K3, K9 and K10 at the
   local heads against their plain versions. Then finetune.py
   --model-parallel 2 writes a checkpoint, which this process resumes at
   --model-parallel 1. Two ranks share one card: no scaling is measured.
15. `dryrun_phase` (parallel/dryrun.py, the JAX __graft_entry__'s
   dryrun_multichip), last: four processes on the one card over gloo, mesh
   (2, 2), every attention head 64 wide (K1 and K3 take Dh=64), 300 s a
   worker: (a) a GPT training step cut over the model axis, the batch over
   the data axis, its loss within 1e-5 relative of the one-process step's;
   (b) the 20-head GPT's greedy decode cut and split, codes equal to the
   unsharded ones; (c) the cascade (decode, latent pass, regulator, 2 CFM
   steps, vocoder) with rows over the data axis and the GPT and DiT cut,
   codes equal and the waveform within 2e-4 of the unsharded peak. Each
   rank's K1 ((b), (c)), K3 and K2 ((c)) launches printed, each above 0;
   then K1 and K3 against their plain versions at the shapes the ranks
   gave them, and K2 at each call of one vocoder call of the cascade's
   BigVGAN over a rank's rows, at phase 2's tolerances.

The last three lines are a JSON object listing the kernels, the card's name
and power limit, and {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}.
"""

from __future__ import annotations

import asyncio
import contextlib
import copy
import dataclasses
import functools
import gc
import http.client
import io
import itertools
import json
import math
import os
import resource
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM float32, outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM TF32 tensor cores, dense
BF16_FLOPS = 989e12  # H100 SXM bfloat16 tensor cores, dense
INT8_OPS = 1979e12  # H100 SXM int8 tensor cores, dense
MAX_MEL_TOKENS = 300
# the library flash attention whose backward kernels K9 and K10 replace
LIBRARY_FLASH = "jax/experimental/pallas/ops/tpu/flash_attention.py"
L2_CYCLE_BYTES = 100_000_000  # twice the H100's 50 MB L2
N_REQUESTS = 2
DECODE_ROUNDS = 1  # captured against eager decode, in turns
DECODE_SEED = 7
S2MEL_ROUNDS = 2  # the s2mel stage captured against eager, in turns
TAIL_ROUNDS = 2  # the latent pass and the vocoder captured against eager, in turns
CONT_REQUESTS = 8  # concurrent /tts requests of the continuous phase, and its slots
CONT_STEPS = 16  # batched steps held captured against eager
# the stream phase's text: 200 bytes, 2 segments of 120/80 ids, or 40/120/40
# with quick_streaming_tokens 40
STREAM_TEXT = ("The port streams this answer in pieces, so that the first words play "
               "while the rest is still being made on the card; each piece is one "
               "segment, decoded, then its tail: latent pass, CFM solve and vocoder.")
STREAM_QUICK = 40
STREAM_ROUNDS = 1  # overlap on / off (and keyed / unkeyed), in turns
# the keyed prefill against the monolithic one (logits and KV of [0, S),
# relative to the largest |value|): float32 summed in another order, and
# on W8/W4 one int8 step of an activation row that the noise may flip
KEYED_TOL = {False: 1e-3, True: 1e-2}
PROMPT_SECONDS = 3
PROMPT_SR = 22050
# the emotion phase: a request's 8 weights (happy, angry, sad, afraid,
# disgusted, melancholic, surprised, calm), the seeds of the banks and of
# the Qwen3 weights, the text the Qwen reads
EMO_VECTOR = [0.0, 0.3, 0.0, 0.0, 0.0, 0.0, 0.25, 0.0]
EMO_SEED = 13
EMO_TEXT = "I cannot believe you did that, it makes me so angry and surprised!"
QWEN_SEED = 15
QWEN_SMALL = dict(vocab_size=4096, hidden_size=256, num_hidden_layers=4, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=64, intermediate_size=512)
QWEN_SMALL_TOKENS = 24
# card against CPU, float32 without TF32 summed in another order: relative
# to the largest |logit|
QWEN_LOGIT_TOL = 1e-4
QWEN_MAX_NEW = 256  # QwenEmoConfig.max_new_tokens
QWEN_ROUNDS = 1  # captured against eager decode, in turns
QWEN_EAGER_NEW = 64  # tokens of an eager decode (a captured one runs QWEN_MAX_NEW)
QWEN_EOS = 151645  # Qwen3's <|im_end|>
TEXT_HEAD_SEED = 17  # the checkpoint's text_head, which the loader reads and drops
BEAMS = 3  # the beam phase's beams: the config's default num_beams
BEAM_ROUNDS = 1  # captured against eager beam search, in turns
BEAM_SEED = 19
BATCH_ROUNDS = 1  # the batched request against its segments one after another, in turns
BATCH_SEED = 23
BATCH_CODES = 512  # the envelope the float route's precompile is measured at
BF16_ROUNDS = 1  # each bf16 route against its float32 counterpart, in turns
BF16_SEED = 31  # the turns' requests; the tail comparison's CFM noise
TRAIN_SEED = 37  # train_phase's weights, batches and CFM noise
TRAIN_STEPS = 10  # train_phase's optimizer steps a target
# the prefix phase: two texts whose first 77 ids agree (byte ids: a miss at
# 92 ids caches the 64-id grid prefix, the 114-id text misses at 96 and hits
# it), the requests' seed, prefill readings in turns and calls a reading
PREFIX_TEXT = "The port keeps the start of this sentence for the next request that shares "
PREFIX_TAILS = ("it with this one.", "its first words, which need no prefill.")
PREFIX_SEED = 41
PREFIX_ROUNDS = 2
PREFIX_ITERS = 10
# end-to-end rounds of the prefix phase: a request without reuse, on a
# miss and on a hit, in turns
PREFIX_E2E_ROUNDS = 2
# rounds in turns of the native DSP phase's host timings
NATIVE_ROUNDS = 6
SAMPLING_SEED = 47
SAMPLING_CHECK_NEW = 128  # codes of each knob's captured and eager greedy decodes
# each knob flipped on its own from the JAX defaults (runtime/decode.py SamplingConfig)
SAMPLING_KNOBS = ({"use_repetition_penalty": False}, {"hf_fake_prompt_penalty": False},
                  {"use_typical_sampling": True}, {"ban_stop_token": True})
PARALLEL_SEED = 53  # parallel_phase's weights, prompt and batch
PARALLEL_NEW = 32  # codes of parallel_phase's decodes
PARALLEL_TIMEOUT = 600  # seconds a parallel_phase worker process may take
CFM_DP_ROWS = 4  # the data-parallel CFM step's global batch
TP_TRAIN_SEED = 59  # tp_train_phase's weights, batches and CFM noise
TP_GPT_ROWS = 4  # the rows of tp_train_phase's GPT step
# tp_train_phase's finetune run: one CFM step on synthetic batches of 2
TP_FINETUNE = ["--target", "cfm", "--synthetic", "2", "--steps", "1", "--log-every", "1"]
TOOLS_SEED = 61  # tools_phase's segment seed
CACHE_SEED = 67  # cache_phase's segment seed
DRYRUN_PROCS = 4  # dryrun_phase's processes: the mesh (2, 2), gloo ranks sharing the card
DRYRUN_SEED = 71  # dryrun_phase's kernel inputs
EVAL_DROP_CASE = "en_long"  # eval_phase's case run again under --mock-asr-drop 0.5
# soak_phase's requests from 4 clients, in waves: 16 in 2 (24 in 3 took the
# whole script past 900 s)
SOAK_REQUESTS = 16
SOAK_WAVES = 2
SOAK_TIMEOUT = 480  # seconds the soak's process may take
P_COND = 34  # the GPT's conditioning positions
# the dilation phase: resblocks of differing dilations, the weights' seed
DILATIONS = ((1, 3, 5), (1, 2, 4), (2, 3, 6))
DILATION_SEED = 43


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def request_text(i: int) -> str:
    return f"The port answers request number {i} on the card."


def batch_texts() -> list:
    """The batched phase's 8 segments: texts of 46 to 53 byte ids, so that
    each row of the prompt's 64-bucket has its own left-pad hole."""
    return [request_text(10 ** i) for i in range(CONT_REQUESTS)]


# ---------------------------------------------------------------------------
# phase 1: environment
# ---------------------------------------------------------------------------


def environment():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from indextts_tpu_torch.ops import cuda_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    paths = cuda_lib.build(verbose=True)
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(p.name for p in paths.values())})")
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    check = subprocess.run([sys.executable, "-m", "indextts_tpu_torch.tools.env_check"],
                           cwd=here, capture_output=True, text=True, timeout=300)
    for line in (check.stdout + check.stderr).splitlines():
        print(f"[env_check] {line}")
    print(f"[env_check] exit {check.returncode} in {time.perf_counter() - t0:.1f} s; {card}")
    if check.returncode != 0:
        fail(f"tools/env_check exited {check.returncode}")
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one fn() call, host launch cost excluded: after three
    warm-up calls on a side stream, `iters` calls are captured in one CUDA
    graph on that stream, and `replays` replays of it are timed with CUDA
    events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (iters * replays)


def profile_calls(fn, calls: int = 48):
    """torch.profiler over `calls` fn() calls after one warm-up: ({device
    kernel name: (launches per call, device ms per call)}, the host's
    kernel-launch API records (cudaLaunchKernel and its variants) per
    call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    host = sum(1 for e in prof.events()
               if e.device_type != torch.autograd.DeviceType.CUDA and "LaunchKernel" in e.name)
    return ({e.key: (e.count / calls, e.device_time_total / 1e3 / calls)
             for e in prof.key_averages() if e.device_time_total > 0}, host / calls)


def device_kernels(fn, calls: int = 48):
    """The device kernels that one fn() call launches (`profile_calls`):
    {kernel name: (launches per call, device ms per call)}."""
    return profile_calls(fn, calls)[0]


def host_us(fn, calls: int = 200, rounds: int = 5) -> float:
    """Host time of one eager fn() call in microseconds, the median over
    `rounds` loops of `calls` calls: the wrapper and the launch. A loop is
    not synchronized, so while the card keeps up with the launches it
    measures the host alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def cycled(fn, args_per_layer):
    """A call that runs fn on the next layer's arguments each time."""
    it = itertools.cycle(args_per_layer)
    return lambda: fn(*next(it))


def main_path_shapes(cfg, max_mel: int):
    """The shapes the slice phase's requests give each kernel, when every
    request decodes max_mel tokens (random weights rarely stop early)."""
    from indextts_tpu_torch.frontend.tokenizer import byte_fallback_ids
    from indextts_tpu_torch.ops.mel import mel_frame_count
    from indextts_tpu_torch.runtime.engine import next_bucket
    from indextts_tpu_torch.utils import audio as audio_utils

    g, v = cfg.gpt, cfg.vocoder
    n_text = len(byte_fallback_ids(request_text(0), g.number_text_tokens, 200))
    prompt = g.condition_num_latent + 2 + n_text + 2 + 1
    n22 = len(audio_utils.resample(np.zeros(PROMPT_SECONDS * PROMPT_SR, np.float32),
                                   PROMPT_SR, 22050))
    ref_mel = mel_frame_count(n22, cfg.s2mel.mel)
    target = int(max_mel * 1.72)
    snake = []
    # the vocoder runs at the s2mel bucket, as the engine's default
    # (precise_shapes=False) pads the mel to it
    ch, T = v.upsample_initial_channel, next_bucket(target, 128, 128)
    G = len(v.resblock_kernel_sizes)
    for u in v.upsample_rates:
        ch //= 2
        T *= u
        snake += [(G * ch, T)] * (2 * len(v.resblock_dilation_sizes[0]))
    snake.append((ch, T))
    # the regulator's valid length is rounded in float32 (runtime/engine.py)
    ylen = int(np.floor(np.float32(max_mel) * np.float32(1.72)))
    # a continuous slot's prompt: the text bucketed to the segment cap
    slot_prompt = g.condition_num_latent + 2 + cfg.runtime.max_text_tokens_per_segment + 2 + 1
    # a beam search's prompt: the text padded to a 16-bucket, its left-pad
    # hole after the conditioning (runtime/engine.py `_generate_codes`)
    bucket = min(next_bucket(n_text, 16, 16), g.max_text_tokens)
    c0 = g.condition_num_latent + 2
    # the batched phase's prompt: its texts right-aligned in the 16-bucket of
    # the longest, each row its own hole (runtime/engine.py
    # `synthesize_segments_batched`)
    n_batch = [len(byte_fallback_ids(t, g.number_text_tokens, 200)) for t in batch_texts()]
    batch_bucket = min(next_bucket(max(n_batch), 16, 16), g.max_text_tokens)
    # a batched CFM solve of rows with unequal codes inside one 128-frame
    # bucket: each row's valid frames its own
    T_solve = ref_mel + next_bucket(target, 128, 128)
    batch_codes = [max_mel - 37 * b for b in range(len(n_batch))]
    return {"decode_cap": prompt + max_mel, "slot_prompt": slot_prompt, "snake": snake,
            "beam_prompt": c0 + bucket + 2 + 1, "beam_hole": [c0, c0 + bucket - n_text],
            "batch_prompt": c0 + batch_bucket + 2 + 1,
            "batch_holes": [[c0] * len(n_batch), [c0 + batch_bucket - n for n in n_batch]],
            "batch_dit_valid": [min(ref_mel + int(np.floor(np.float32(c) * np.float32(1.72))),
                                    T_solve) for c in batch_codes],
            # the CFM solve's width: the target bucketed to 128 frames, as the
            # engine's default (precise_shapes=False) runs it
            "dit_T": ref_mel + next_bucket(target, 128, 128),
            "dit_valid": min(ref_mel + ylen, ref_mel + next_bucket(target, 128, 128)),
            # the prompt's mel frames, the batched phase's text ids and codes
            # (train_phase's batches)
            "ref_mel": ref_mel, "batch_text": n_batch, "batch_codes": batch_codes}


def decode_cases(cap: int, slot_prompt: int, beam_prompt: int, beam_hole, batch_prompt: int,
                 batch_holes):
    """K1's and K4's cases: (name, B, cap, valid, hole start, hole end). A
    cluster rank takes a share of 16 * ceil(valid / 128) keys (ops/
    decode_attention.py `rank_span`), so valid 15-17 and 127-129 cross a
    chunk and a share; at cap 1000 the ranks start at 128, 256, ...; at cap
    3000 a share (384 keys) takes two rounds of the block's copies. The
    decoder rounds its caches up to a multiple of 256 slots (runtime/
    decode.py `cache_cap`), so the main path attends to `cap` keys of such
    a cache. The continuous phase's slot state holds 8 rows of prompts of
    `slot_prompt` keys (the text bucket's left-pad hole starts after the 34
    conditioning positions; a full bucket has none) and MAX_MEL_TOKENS
    codes: rows at unequal steps, one idle (one key, a finished request's
    hole past it). A beam search's 3 rows share one prompt of `beam_prompt`
    keys with the hole `beam_hole` and attend to as many keys (the last
    step of MAX_MEL_TOKENS). A batched request's 8 rows share one prompt of
    `batch_prompt` keys, each with its own hole (`batch_holes`: starts,
    ends), at one step (the last of MAX_MEL_TOKENS)."""
    from indextts_tpu_torch.runtime.decode import cache_cap

    S, c0 = slot_prompt, 34
    holes = [0, 5, 17, 40, 63, 90, 118, 25]

    return [
        ("main", 1, cap, [cap], [0], [0]),
        ("main, cache rounded", 1, cache_cap(cap, 0), [cap], [0], [0]),
        ("default-1500", 1, 1657, [1657], [0], [0]),
        ("mid-decode", 2, 1657, [400, 1000], [0, 0], [0, 0]),
        ("valid 1-129", 7, 300, [1, 2, 15, 16, 17, 127, 129], [0] * 7, [0] * 7),
        ("ragged B=3", 3, 700, [700, 333, 1], [0, 40, 0], [0, 90, 0]),
        ("hole-mid", 2, 512, [500, 257], [100, 3], [200, 9]),
        ("hole across ranks", 1, 1000, [1000], [100], [300]),
        ("hole all but one", 2, 500, [500, 500], [0, 1], [499, 500]),
        ("two rounds", 2, 3000, [3000, 2100], [0, 50], [0, 60]),
        ("slot state", 8, cache_cap(S, MAX_MEL_TOKENS),
         [S + MAX_MEL_TOKENS, S + 254, S + 193, S + 141, S + 76, S + 33, S + 1, 1],
         [c0 if h else 0 for h in holes], [c0 + h if h else 0 for h in holes]),
        ("beam rows", 3, cache_cap(beam_prompt, MAX_MEL_TOKENS),
         [beam_prompt + MAX_MEL_TOKENS] * 3, [beam_hole[0]] * 3, [beam_hole[1]] * 3),
        ("batched rows", len(batch_holes[0]), cache_cap(batch_prompt, MAX_MEL_TOKENS),
         [batch_prompt + MAX_MEL_TOKENS] * len(batch_holes[0]), *batch_holes),
    ]


# the main_path_shapes entries that decode_cases takes after the cap
CASE_SHAPES = ("slot_prompt", "beam_prompt", "beam_hole", "batch_prompt", "batch_holes")


# (cap, valid) at which K1 and K4 are timed: the main path's last step, the
# default config's (max_mel_tokens 1500), and two mid-decode steps there
def decode_timings(cap: int):
    return [(cap, cap), (1657, 1657), (1657, 1000), (1657, 400)]


def time_k1(cap_main: int, layers: int, heads: int, yardsticks: bool = True):
    """K1's device ms a call over a float32 cache at each of
    `decode_timings`, one cache per call out of enough copies to pass
    L2_CYCLE_BYTES (as K5/K7), so that the cache comes from device memory
    as in a decode step; with `yardsticks`, also the plain version and
    scaled_dot_product_attention, masked over the whole cache and unmasked
    over k[:, :, :valid] (the same function where the hole is empty).
    Returns one dict a (cap, valid)."""
    import torch
    import torch.nn.functional as F

    from indextts_tpu_torch.ops import decode_attention as k1

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    i32 = dict(dtype=torch.int32, device=dev)
    rows = []
    for c, valid in decode_timings(cap_main):
        layer_bytes = 2 * heads * c * 64 * 4
        copies = cycle_copies(layer_bytes, layers)
        q = torch.randn((1, heads, 64), generator=g, device=dev)
        vl, z = torch.tensor([valid], **i32), torch.zeros(1, **i32)
        kv = [(torch.randn((1, heads, c, 64), generator=g, device=dev),
               torch.randn((1, heads, c, 64), generator=g, device=dev)) for _ in range(copies)]
        row = {"cap": c, "valid": valid,
               "ms": cuda_ms(cycled(lambda k, v: k1.ragged_decode_attention(q, k, v, vl, z, z),
                                    kv), iters=2 * copies)}
        nbytes = 2 * heads * valid * 64 * 4 + 2 * heads * 64 * 4 + 3 * 4
        row["bound"], row["by"] = bound(nbytes, heads * valid * 4 * 64)
        if yardsticks:
            mask = (torch.arange(c, device=dev) < valid)[None, None, None]
            row["plain"] = cuda_ms(cycled(
                lambda k, v: k1.ragged_decode_attention_plain(q, k, v, vl, z, z), kv),
                iters=copies, replays=2)
            row["sdpa_masked"] = cuda_ms(cycled(lambda k, v: F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask), kv), iters=2 * copies)
            row["sdpa_sliced"] = cuda_ms(cycled(lambda k, v: F.scaled_dot_product_attention(
                q[:, :, None], k[:, :, :valid], v[:, :, :valid]), kv), iters=2 * copies)
        print(f"K1 timed cap={c} valid={valid}: kernel_ms={row['ms']:.5f}"
              + (f" plain_ms={row['plain']:.4f} library_ms(sdpa masked)="
                 f"{row['sdpa_masked']:.5f} library_ms(sdpa over k[:valid])="
                 f"{row['sdpa_sliced']:.5f}" if yardsticks else "")
              + f" bound_ms={row['bound']:.5f} ({row['by']}); {copies} caches cycled "
              f"({copies * layer_bytes / 1e6:.1f} MB)")
        rows.append(row)
        del kv
    return rows


def time_k4(cap_main: int, layers: int, heads: int, yardsticks: bool = True):
    """K4's device ms a call over an int8 cache with its scales, as
    `time_k1` (no library call computes K4's function)."""
    import torch

    from indextts_tpu_torch.models.gpt2 import quantize_kv
    from indextts_tpu_torch.ops import decode_attention as k4

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    i32 = dict(dtype=torch.int32, device=dev)
    rows = []
    for c, valid in decode_timings(cap_main):
        layer_bytes = 2 * heads * c * 64 + 2 * heads * c * 4
        copies = cycle_copies(layer_bytes, layers)
        q = torch.randn((1, heads, 64), generator=g, device=dev)
        vl, z = torch.tensor([valid], **i32), torch.zeros(1, **i32)
        args = []
        for _ in range(copies):
            k8, ksc = quantize_kv(torch.randn((1, heads, c, 64), generator=g, device=dev))
            v8, vsc = quantize_kv(torch.randn((1, heads, c, 64), generator=g, device=dev))
            args.append((q, k8, v8, ksc, vsc, vl, z, z))
        row = {"cap": c, "valid": valid,
               "ms": cuda_ms(cycled(k4.ragged_decode_attention_q8, args), iters=2 * copies)}
        nbytes = 2 * heads * valid * (64 + 4) + 2 * heads * 64 * 4 + 3 * 4
        row["bound"], row["by"] = bound(nbytes, heads * valid * 4 * 64)
        if yardsticks:
            row["plain"] = cuda_ms(cycled(k4.ragged_decode_attention_q8_plain, args),
                                   iters=copies, replays=2)
        print(f"K4 timed cap={c} valid={valid}: kernel_ms={row['ms']:.5f}"
              + (f" plain_ms={row['plain']:.4f} library_ms=none" if yardsticks else "")
              + f" bound_ms={row['bound']:.5f} ({row['by']}); {copies} caches cycled "
              f"({copies * layer_bytes / 1e6:.1f} MB)")
        rows.append(row)
        del args
    return rows


def check_decode_cases(label: str, call, plain, cases, make, tol: float):
    """`call` against `plain` at each case, inputs from make(B, cap); the
    main case is also counted in device kernels (one) and replayed. Returns
    the largest error."""
    import torch

    i32 = dict(dtype=torch.int32, device="cuda")
    errs = []
    for name, B, c, vl, hs, he in cases:
        args = (*make(B, c), *(torch.tensor(a, **i32) for a in (vl, hs, he)))
        got = call(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        errs.append(err)
        print(f"{label} {name}: B={B} cap={c} valid={vl} hole=[{hs}, {he}) "
              f"max_abs_err={err:.3g} (tol {tol})")
        if not err <= tol:
            fail(f"{label} {name} disagrees with its plain version: {err}")
        if name == "main":
            one_launch(label, lambda: call(*args))
            replays_equal(label, lambda: call(*args), got)
    return max(errs)


def check_k1(shapes, layers: int, heads: int):
    import torch

    from indextts_tpu_torch.ops import decode_attention as k1

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    tol = 2e-5  # fp32 softmax split over 8 ranks vs one-shot softmax, |out| ~ 1
    cap = shapes["decode_cap"]
    # besides decode_cases: a row with no attending key (zeros) beside a
    # row with one
    cases = decode_cases(cap, *(shapes[k] for k in CASE_SHAPES)) + [
        ("no key", 2, 64, [0, 10], [0, 0], [0, 9])]
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        def make(B, c):
            q = torch.randn((B, heads, 64), generator=g, device=dev)
            k = torch.randn((B, heads, c, 64), generator=g, device=dev).to(dt)
            return q, k, torch.randn((B, heads, c, 64), generator=g, device=dev).to(dt)
        err = max(err, check_decode_cases(f"K1 {str(dt)[6:]}", k1.ragged_decode_attention,
                                          k1.ragged_decode_attention_plain, cases, make, tol))
    rows = time_k1(cap, layers, heads)
    main = rows[0]
    lib = min(("sdpa masked", main["sdpa_masked"]), ("sdpa over k[:valid]", main["sdpa_sliced"]),
              key=lambda x: x[1])
    print(f"K1 library_ms: the faster SDPA yardstick at the main shape is {lib[0]}")
    return {"name": "K1 ragged_decode_attention", "route": "cuda",
            "source": "indextts_tpu_torch/csrc/decode_attention.cu",
            "replaces": "indextts_tpu/ops/decode_attention.py:126",
            "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain"],
            "bound_ms": main["bound"], "bound_by": main["by"], "library_ms": lib[1]}


def k2_inputs(g, B: int, C: int, T: int, logscale: bool = True, small_beta: bool = False):
    """x ~ N(0, 1) and alpha, beta ~ N(0, 0.09) (logscale); without
    logscale alpha, beta = |N(0, 0.09)| + 0.5, as the CPU tests take them.
    `small_beta`: beta = exp(-4) on every fourth channel, so the snake's
    1 / beta (55) scales the sine's error there."""
    import torch

    x = torch.randn((B, C, T), generator=g, device="cuda")
    a = torch.randn((C,), generator=g, device="cuda") * 0.3
    b = torch.randn((C,), generator=g, device="cuda") * 0.3
    if not logscale:
        a, b = a.abs() + 0.5, b.abs() + 0.5
    if small_beta:
        b[::4] = -4.0 if logscale else math.exp(-4.0)
    return x, a, b


def k2_cases():
    """K2's cases, (name, B, C, T, logscale, small_beta): first the five
    checked before the plan, on the same draws; then edge cases from its
    plan (ops/snake.py `snake_plan`: a warp takes 32 * R outputs of a row,
    lane l the R from l * R, SNAKE_WARPS warps a block): rows shorter than
    a lane's R; T at a warp's chunk and at a block's four chunks, and one
    either side; a last chunk of one lane and of one output; a chunk whose
    input halo reaches past a short last chunk (the edge path away from
    chunk 0); T % 4 != 0 (scalar loads); logscale False; a grid whose last
    block holds one warp; small betas (`k2_inputs`)."""
    from indextts_tpu_torch.ops import snake as k2

    r = k2.SNAKE_LANE_OUTPUTS
    chunk, block = 32 * r, 32 * r * k2.SNAKE_WARPS
    cases = [("small-T", 1, 24, 3), ("post-C24", 1, 24, 37), ("C72", 2, 72, 1000),
             ("C2304", 1, 2304, 513), ("tile-edge", 1, 144, 1025)]
    cases += [(f"T={t}", 1, 24, t) for t in (1, 2, 7, chunk - 1, chunk, chunk + 1)]
    cases += [(f"T={t}", 2, 9, t) for t in (block - 1, block, block + 1)]
    cases += [(f"tail of one lane T={2 * chunk + r}", 1, 24, 2 * chunk + r),
              (f"halo past a short tail T={2 * chunk + 3}", 1, 24, 2 * chunk + 3),
              ("T%4=1", 1, 72, 1001), ("T%4=3", 1, 144, 2063), ("T%4=2", 2, 30, 4098),
              ("last block of one warp", 1, 5, 100)]
    cases = [(*c, True, False) for c in cases]
    cases += [("logscale False", 1, 72, 1000, False, False),
              ("logscale False T%4=1", 2, 24, 517, False, False),
              ("small beta", 2, 72, 1000, True, True),
              ("small beta, main first shape", 1, 2304, 2064, True, True),
              ("small beta, logscale False", 2, 24, 517, False, True)]
    return cases


def snake_arg_max(x, alpha, logscale: bool) -> float:
    """max |alpha u| over the up signal u of x: the largest argument K2's
    sines see."""
    import torch
    import torch.nn.functional as F

    from indextts_tpu_torch.ops import snake as k2

    even, odd, _ = k2.polyphase_taps()
    w = 2 * torch.tensor([even + [0.0], [0.0] + odd], device=x.device)[:, None, :]
    B, C, T = x.shape
    up = F.conv1d(F.pad(x.reshape(B * C, 1, T), (3, 3), mode="replicate"), w)
    a = torch.exp(alpha) if logscale else alpha
    return (up.reshape(B, C, 2, T) * a[None, :, None, None]).abs().max().item()


def time_k2(seq, g, plain: bool = True, call=None):
    """Device ms of one vocoder call of K2 (one launch per (C, T) of seq),
    each launch on its own input, so no launch finds its x in L2 (the main
    path's 37 inputs are 1.57 GB); with `plain`, the plain version's too.
    `call` stands in for the wrapper (tools/snake_times.py). Returns (ms,
    plain ms or None, bound ms, what bounds it)."""
    from indextts_tpu_torch.ops import snake as k2

    bufs = [k2_inputs(g, 1, C, T) for C, T in seq]

    def run(fn):
        return lambda: [fn(*b, True) for b in bufs]

    ms = cuda_ms(run(call or k2.anti_alias_snake), iters=2)
    plain_ms = cuda_ms(run(k2.anti_alias_snake_plain), iters=1, replays=2) if plain else None
    nbytes = sum(2 * C * T * 4 + 2 * C * 4 for C, T in seq)
    # per output: 2 x 6-tap up FIRs, 2 snakes, one 12-tap down FIR
    flops = sum(C * T * 58 for C, T in seq)
    b_ms, by = bound(nbytes, flops)
    return ms, plain_ms, b_ms, by


def check_k2(shapes, long_seq):
    import torch

    from indextts_tpu_torch.ops import snake as k2

    g = torch.Generator(device="cuda").manual_seed(2)
    tol = 2e-5  # same fp32 algebra and order; the kernel's sine, expf and FMA contraction
    errs = {}

    def check(name, x, a, b, logscale=True, small_beta=False):
        got = k2.anti_alias_snake(x, a, b, logscale)
        want = k2.anti_alias_snake_plain(x, a, b, logscale)
        d = (got - want).abs()
        err = d.max().item()
        errs[name] = err
        B, C, T = x.shape
        # beta = exp(-4) lifts outputs to ~55, where the kernel's and the
        # plain version's float32 sums part by units in their last place
        # whatever the sine (with sinf 3.4e-5 at the main first shape,
        # tools/snake_times.py --probe): those cases add the card test's
        # rtol of 1e-5
        rtol = 1e-5 if small_beta else 0.0
        excess = (d - tol - rtol * want.abs()).max().item()
        print(f"K2 {name}: B={B} C={C} T={T} logscale={logscale} small_beta={small_beta} "
              f"max_abs_err={err:.3g} (tol {tol} + {rtol} |plain|) "
              f"max|alpha u|={snake_arg_max(x, a, logscale):.3g}")
        if not excess <= 0:
            fail(f"K2 {name} disagrees with its plain version: {err}")

    for name, B, C, T, logscale, small_beta in k2_cases():
        check(name, *k2_inputs(g, B, C, T, logscale, small_beta), logscale, small_beta)
    # every shape of one vocoder call at the main path's and at the longest
    # segment's
    for label, seq in (("main", shapes["snake"]), ("longest", long_seq)):
        for C, T in dict.fromkeys(seq):
            check(f"{label} C={C} T={T}", *k2_inputs(g, 1, C, T))
    # a batched request's vocoder call: 8 rows at its first snake shape,
    # timed against one row of it
    C, T = shapes["snake"][0]
    x, a, b = k2_inputs(g, CONT_REQUESTS, C, T)
    check(f"batched {CONT_REQUESTS} rows C={C} T={T}", x, a, b)
    ms_rows = cuda_ms(lambda: k2.anti_alias_snake(x, a, b, True))
    ms_one = cuda_ms(lambda: k2.anti_alias_snake(x[:1], a, b, True))
    b_ms, by = bound(2 * x.numel() * 4 + 2 * C * 4, 58 * x.numel())
    print(f"K2 batched {CONT_REQUESTS} rows C={C} T={T}: kernel_ms={ms_rows:.4f} (one row "
          f"{ms_one:.4f}) bound_ms={b_ms:.4f} ({by})")
    del x, a, b
    x, a, b = k2_inputs(g, 1, *shapes["snake"][0])
    got = k2.anti_alias_snake(x, a, b, True)
    one_launch("K2", lambda: k2.anti_alias_snake(x, a, b, True))
    replays_equal("K2", lambda: k2.anti_alias_snake(x, a, b, True), got)
    del x, a, b, got

    seq = shapes["snake"]
    ms, plain, b_ms, by = time_k2(seq, g)
    print(f"K2 main ({len(seq)} launches, one vocoder call, each on its own input): "
          f"kernel_ms={ms:.4f} plain_ms={plain:.4f} bound_ms={b_ms:.4f} ({by})")
    long_ms, _, long_b, long_by = time_k2(long_seq, g, plain=False)
    print(f"K2 longest segment ({len(long_seq)} launches, one vocoder call): "
          f"kernel_ms={long_ms:.4f} bound_ms={long_b:.4f} ({long_by})")
    return {"name": "K2 anti_alias_snake", "route": "cuda",
            "source": "indextts_tpu_torch/csrc/snake.cu",
            "replaces": "indextts_tpu/ops/snake_pallas.py:48",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def k2_checksum() -> str:
    """sha256 (16 hex digits) of the float32 K2's outputs on fixed inputs:
    the main path's first shape, a row of T % 4 != 0 and its last shape,
    the same on two trees whose float32 kernel computes the same bits."""
    import hashlib

    import torch

    from indextts_tpu_torch.ops import snake as k2

    g = torch.Generator(device="cuda").manual_seed(5)
    h = hashlib.sha256()
    for C, T in ((2304, 2560), (72, 1001), (24, 163840)):
        h.update(k2.anti_alias_snake(*k2_inputs(g, 1, C, T), True).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def k2_bf16_cases():
    """K2-bf16's cases (name, B, C, T, alpha and beta float32, logscale,
    small beta):
    first the five of its first version, on the same draws; then
    the edges of its tiling (ops/snake.py `snake_bf16_plan`: tiles of 16
    rows, segments of L outputs a multiple of the 64-position TMA box,
    chunks of 8): T = 1, 2, below a window of 16 and one either side; T at
    a box and one either side; rows past a tile (15, 16, 17 rows); T % 8
    = 3..6 (the kernel without TMA; 1, 2 and 7 above); segments longer
    than a box, the last one partial (the main path's first shape and an
    output block either side); alpha and beta
    float32; logscale False; beta = exp(-4) on every fourth channel (h =
    27 lifts the snake's values, whose hi + lo split keeps 2^-17 of them)."""
    from indextts_tpu_torch.ops import cuda_lib
    from indextts_tpu_torch.ops import snake as k2

    cases = [("T=7", 1, 24, 7), ("T%4=1", 1, 72, 1001), ("T%4=3", 1, 144, 2063),
             ("T%4=2", 2, 30, 4098), ("last block of one warp", 1, 5, 100)]
    cases += [(f"T={t}", 1, 24, t) for t in (1, 2, 15, 16, 17)]
    cases += [(f"box{d:+d} T={64 + d}", 3, 5, 64 + d) for d in (-1, 0, 1)]
    cases += [(f"{r} rows", 1, r, 200 + r) for r in (15, 16, 17)]
    cases += [(f"T%8={t % 8}", 2, 12, t) for t in (203, 204, 205, 206)]
    # the main path's first shape and an output block either side: segments
    # of L > 64 (the plan on this card), the last one partial
    sms = cuda_lib.sm_count(0)
    for t in (2552, 2560, 2568):
        L, segs = k2.snake_bf16_plan(1, 2304, t, sms)[:2]
        cases.append((f"segments T={t} L={L} segs={segs}", 1, 2304, t))
    cases = [(*c, False, True, False) for c in cases]
    return cases + [("alpha, beta float32", 2, 72, 1001, True, True, False),
                    ("logscale False", 1, 72, 1000, False, False, False),
                    ("small beta", 2, 72, 1000, False, True, True)]


def time_k2_bf16(seq, g, rows: int, with32: bool = True, plain: bool = False, call=None):
    """Device ms of one vocoder call of K2-bf16 over `rows` rows (one
    launch per (C, T) of seq, each on its own input), in turns with the
    float32 instantiation on the same values (float32, bf16, bf16,
    float32) where `with32`, else twice; with `plain`, the plain version's.
    `call` stands in for the wrapper on the bfloat16 inputs
    (tools/snake_times.py). Returns (ms, float32 ms or None, the turns,
    plain ms or None, bound ms, what bounds it, float32 bound ms)."""
    from indextts_tpu_torch.ops import snake as k2

    call = call or k2.anti_alias_snake

    bufs = []
    for C, T in seq:
        x, a, b = k2_inputs(g, rows, C, T)
        bufs.append((x.bfloat16(), a.bfloat16(), b.bfloat16()))

    def run(fn, bs):
        return lambda: [fn(*buf, True) for buf in bs]

    if with32:
        bufs32 = [(x.float(), a.float(), b.float()) for x, a, b in bufs]
        turns = [cuda_ms(run(k2.anti_alias_snake, bufs32), iters=2),
                 cuda_ms(run(call, bufs), iters=2),
                 cuda_ms(run(call, bufs), iters=2),
                 cuda_ms(run(k2.anti_alias_snake, bufs32), iters=2)]
        del bufs32
        ms, ms32 = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    else:
        turns = [cuda_ms(run(call, bufs), iters=2) for _ in range(2)]
        ms, ms32 = sum(turns) / 2, None
    plain_ms = cuda_ms(run(lambda x, a, b, ls: k2.anti_alias_snake_plain(
        x.float(), a.float(), b.float(), ls).bfloat16(), bufs), iters=1, replays=2) \
        if plain else None
    flops = sum(rows * C * T * 58 for C, T in seq)
    # x read once and the output written once, 2 bytes an element (4 in
    # float32), and alpha and beta in float32
    b_ms, by = bound(sum(2 * rows * C * T * 2 + 2 * C * 4 for C, T in seq), flops)
    b32, _ = bound(sum(2 * rows * C * T * 4 + 2 * C * 4 for C, T in seq), flops)
    return ms, ms32, turns, plain_ms, b_ms, by, b32


def check_k2_bf16(shapes, long_seq):
    """K2-bf16, the bfloat16 kernel (a bfloat16 vocoder), against its plain
    version (x widened to float32, computed, rounded once), at every shape
    of a vocoder call at the main path and at the longest segment, at a
    batched call's 8 rows of the main path's first and last shapes, and at
    the edges of its tiling (`k2_bf16_cases`). The kernel's float32-class
    result and the plain version's part by one bfloat16 step where they
    straddle a rounding boundary: |err| <= 2e-5 + 2^-7 |plain|; each case
    prints the share of outputs one step apart. Prints the kernel's
    registers and local (spill) bytes a thread, which must be 0. Timed
    where it runs, on the batched route's 8 rows, over one vocoder call
    (its 37 launches, each on its own input), in turns with the float32
    instantiation on the same values (float32, bf16, bf16, float32), and
    at one row of the same shapes (`time_k2_bf16`, which
    tools/snake_times.py runs on another tree)."""
    import torch

    from indextts_tpu_torch.ops import snake as k2

    g = torch.Generator(device="cuda").manual_seed(22)
    rtol, atol = 2.0 ** -7, 2e-5
    errs = {}

    def inputs(B, C, T, ab32=False, logscale=True, small_beta=False):
        x, a, b = k2_inputs(g, B, C, T, logscale, small_beta)
        return x.bfloat16(), *((a, b) if ab32 else (a.bfloat16(), b.bfloat16()))

    def check(name, x, a, b, logscale=True):
        before = k2.bf16_counter.launches, k2.counter.launches
        got = k2.anti_alias_snake(x, a, b, logscale)
        if got.dtype != torch.bfloat16 or (k2.bf16_counter.launches, k2.counter.launches) != (
                before[0] + 1, before[1]):
            fail(f"K2-bf16 {name}: not one launch of the bfloat16 instantiation")
        want = k2.anti_alias_snake_plain(x.float(), a.float(), b.float(),
                                         logscale).bfloat16().float()
        d = (got.float() - want).abs()
        errs[name] = err = d.max().item()
        steps = (d > 0).float().mean().item()
        B, C, T = x.shape
        print(f"K2-bf16 {name}: B={B} C={C} T={T} max_abs_err={err:.3g} (tol {atol} + "
              f"2^-7 |plain|; {steps:.2e} of the outputs one step apart)")
        if not (d - atol - rtol * want.abs()).max().item() <= 0:
            fail(f"K2-bf16 {name} disagrees with its plain version: {err}")

    for name, B, C, T, ab32, logscale, small_beta in k2_bf16_cases():
        check(name, *inputs(B, C, T, ab32, logscale, small_beta), logscale)
    for label, seq in (("main", shapes["snake"]), ("longest", long_seq)):
        for C, T in dict.fromkeys(seq):
            check(f"{label} C={C} T={T}", *inputs(1, C, T))
    for C, T in (shapes["snake"][0], shapes["snake"][-1]):
        check(f"batched {CONT_REQUESTS} rows C={C} T={T}", *inputs(CONT_REQUESTS, C, T))
    x, a, b = inputs(1, *shapes["snake"][0])
    got = k2.anti_alias_snake(x, a, b, True)
    one_launch("K2-bf16", lambda: k2.anti_alias_snake(x, a, b, True))
    replays_equal("K2-bf16", lambda: k2.anti_alias_snake(x, a, b, True), got)
    del x, a, b, got
    attrs = k2.bf16_attributes()
    for (tma, ab), (regs, local) in attrs.items():
        print(f"K2-bf16 kernel {'with' if tma else 'without'} TMA, alpha and beta {ab}: "
              f"{regs} registers a thread, {local} bytes of local memory (spills) a thread")
    if any(local for _, local in attrs.values()):
        fail(f"K2-bf16 spills to local memory: {attrs}")
    print(f"K2 float32 output checksum on fixed inputs: {k2_checksum()}")

    seq = shapes["snake"]
    R = CONT_REQUESTS
    ms, ms32, turns, plain, b_ms, by, b32 = time_k2_bf16(seq, g, R, plain=True)
    print(f"K2-bf16 batched vocoder call ({len(seq)} launches of {R} rows, each on its own "
          f"input, {sum(2 * R * C * T for C, T in seq) / 1e9:.2f} GB of bf16 x): "
          f"kernel_ms={ms:.4f} (turns float32, bf16, bf16, float32: "
          f"{', '.join(f'{t:.4f}' for t in turns)}; float32 instantiation {ms32:.4f}, its "
          f"bound {b32:.4f}) plain_ms={plain:.4f} bound_ms={b_ms:.4f} ({by})")
    one, one32, turns1, _, b1, _, b1_32 = time_k2_bf16(seq, g, 1)
    print(f"K2-bf16 one-row vocoder call ({len(seq)} launches): kernel_ms={one:.4f} (turns "
          f"float32, bf16, bf16, float32: {', '.join(f'{t:.4f}' for t in turns1)}; float32 "
          f"{one32:.4f}, its bound {b1_32:.4f}) bound_ms={b1:.4f}")
    return {"name": "K2-bf16 anti_alias_snake", "route": "cuda",
            "source": "indextts_tpu_torch/csrc/snake.cu",
            "replaces": "indextts_tpu/ops/snake_pallas.py:48",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def dit_qkv(g, B: int, heads: int, T: int, dtype=None):
    """q, k, v as the DiT hands them to K3: q and k transposed views of
    (B, T, H, 64) tensors (the rotary output), v a transposed slice of the
    fused qkv projection; float32, or `dtype` (the draws rounded to it)."""
    import torch

    qkv = torch.randn((B, T, 3 * heads * 64), generator=g, device="cuda").to(dtype)
    rot = torch.randn((2, B, T, heads, 64), generator=g, device="cuda").to(dtype)
    v = qkv[..., 2 * heads * 64:].reshape(B, T, heads, 64).transpose(1, 2)
    return rot[0].transpose(1, 2), rot[1].transpose(1, 2), v


def check_k3(shapes, longest, heads: int):
    import torch
    import torch.nn.functional as F

    from indextts_tpu_torch.ops import dit_attention as k3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    tol = 2e-5  # 3xTF32 online softmax vs fp32 one-shot softmax, |out| ~ 1
    T, tv = shapes["dit_T"], shapes["dit_valid"]
    long_T, long_v = longest["dit_T"], longest["dit_valid"]
    # the main path's and the longest segment's (default max_mel_tokens) with
    # the DiT's strided views; T=37 is below one tile; T255 has a row with
    # one valid key, no-valid-key a row that averages v over all T keys
    cases = [("main", T, [tv, tv]), (f"longest T={long_T}", long_T, [long_v, long_v]),
             ("T37", 37, [37, 20]), ("T100", 100, [100, 37]), ("T255", 255, [255, 1]),
             ("T300", 300, [300, 150]), ("T1000", 1000, [999, 600]),
             ("no-valid-key", 300, [300, 0]),
             # a batched solve: 8 rows of unequal valid frames, cond and null
             # halves alike
             ("batched 16 rows", T, shapes["batch_dit_valid"] * 2)]
    errs, inputs = {}, {}
    for name, t, lens in cases:
        B = len(lens)
        if name in ("main", "batched 16 rows") or name.startswith("longest"):
            q, k, v = dit_qkv(g, B, heads, t)
        else:
            q, k, v = (torch.randn((B, heads, t, 64), generator=g, device=dev) for _ in range(3))
        mask = torch.arange(t, device=dev)[None] < torch.tensor(lens, device=dev)[:, None]
        got = k3.dit_attention(q, k, v, mask)
        want = k3.dit_attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        errs[name] = err
        print(f"K3 {name}: B={B} H={heads} T={t} valid={lens} max_abs_err={err:.3g} "
              f"(tol {tol})")
        if not err <= tol:
            fail(f"K3 {name} disagrees with its plain version: {err}")
        inputs[name] = (q, k, v, mask, lens)
    q, k, v, mask, lens = inputs["main"]
    got = k3.dit_attention(q, k, v, mask)
    same = [torch.equal(k3.dit_attention(q, k, v, mask), got),
            torch.equal(k3.dit_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                         mask), got)]
    print(f"K3 main: a second call and contiguous copies of the strided views give the "
          f"same bits: {same}")
    if not all(same):
        fail("K3: a repeated call or contiguous inputs changed the result")
    one_launch("K3", lambda: k3.dit_attention(q, k, v, mask))

    def timed(name):
        q, k, v, mask, lens = inputs[name]
        B, _, t, _ = q.shape
        ms = cuda_ms(lambda: k3.dit_attention(q, k, v, mask))
        plain = cuda_ms(lambda: k3.dit_attention_plain(q, k, v, mask), iters=5)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask[:, None, None, :]))
        nbytes = 4 * B * heads * t * 64 * 4 + B * t
        flops = sum(4 * heads * t * n * 64 for n in lens)
        fp32_ms, _ = bound(nbytes, flops)
        # 3xTF32: three TF32 products per product, on the tensor cores
        tc_ms, tc_by = bound(nbytes, 3 * flops, TF32_FLOPS)
        print(f"K3 {name} B={B} H={heads} T={t}: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
              f"library_ms(sdpa)={lib:.4f} bound_ms(3xTF32 tensor cores)={tc_ms:.4f} "
              f"({tc_by}) bound_ms(fp32 CUDA cores)={fp32_ms:.4f}")
        return ms, plain, lib, tc_ms, tc_by

    ms, plain, lib, b_ms, by = timed("main")
    timed(f"longest T={long_T}")
    timed("batched 16 rows")
    return {"name": "K3 dit_attention", "route": "cuda",
            "source": "indextts_tpu_torch/csrc/dit_attention.cu",
            "replaces": "indextts_tpu/models/s2mel.py:141",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib}


def masked_head_row(t: int):
    """A (t,) bool row whose valid keys are no prefix, cut at K3-bf16's
    128-key tiles: the first 128 keys masked (the first tile has no valid
    key), keys 384-511 masked between valid keys (a whole tile), every
    seventh key of 640-767 masked (a mixed tile), and the last five; the
    other tiles hold valid keys only."""
    import torch

    j = torch.arange(t, device="cuda")
    return ~((j < 128) | ((j >= 384) & (j < 512)) | ((j >= 640) & (j < 768) & (j % 7 == 3))
             | (j >= t - 5))


def k3_bf16_cases(shapes, longest):
    """(name, T, rows) of K3-bf16's checks: the main path's solve (T=898,
    774 valid, on the DiT's strided views), the longest segment's (T=2946,
    2838 valid), T=37 below one tile, a row with one valid key, a row with
    none, a batched solve's 16 rows (8 unequal valid counts, each in the
    cond and the null half), and a row whose first tile and a middle tile
    have no valid key (`masked_head_row`) beside a row with none, at 2 rows
    and at 16 (blocks of 2 and of 3 consumer warpgroups)."""
    T, tv = shapes["dit_T"], shapes["dit_valid"]
    long_T, long_v = longest["dit_T"], longest["dit_valid"]
    return [("main", T, [tv, tv]), (f"longest T={long_T}", long_T, [long_v, long_v]),
            ("T37", 37, [37, 20]), ("T255", 255, [255, 1]), ("no-valid-key", 300, [300, 0]),
            ("batched 16 rows", T, shapes["batch_dit_valid"] * 2),
            ("non-prefix", T, ["masked-head", 0]),
            ("non-prefix 16 rows", T, ["masked-head", 0] * 8)]


def k3_bf16_inputs(g, name: str, t: int, rows, heads: int):
    """(q, k, v, mask, lens) of one K3-bf16 case in bfloat16: the DiT's
    strided views at the main path's shapes, else contiguous draws; lens
    each row's valid keys."""
    import torch

    bf16 = torch.bfloat16
    B = len(rows)
    if name in ("main", "batched 16 rows") or name.startswith("longest"):
        q, k, v = dit_qkv(g, B, heads, t, bf16)
    else:
        q, k, v = (torch.randn((B, heads, t, 64), generator=g, device="cuda").to(bf16)
                   for _ in range(3))
    mask = key_mask(t, rows)
    return q, k, v, mask, mask.sum(1).tolist()


def time_k3_bf16(name: str, inputs, heads: int):
    """K3-bf16 in turns with the float32 instantiation on the same values
    (float32, bf16, bf16, float32), its plain version and SDPA on the
    bfloat16 tensors, by CUDA events over graph replays, on one case's
    inputs; the bound counts 989 TFLOP/s bf16 over the valid keys.
    Returns (ms, plain, lib, bound, by)."""
    import torch.nn.functional as F

    from indextts_tpu_torch.ops import dit_attention as k3

    q, k, v, mask, lens = inputs
    B, _, t, _ = q.shape
    q32, k32, v32 = q.float(), k.float(), v.float()
    turns = [cuda_ms(lambda: k3.dit_attention(q32, k32, v32, mask)),
             cuda_ms(lambda: k3.dit_attention(q, k, v, mask)),
             cuda_ms(lambda: k3.dit_attention(q, k, v, mask)),
             cuda_ms(lambda: k3.dit_attention(q32, k32, v32, mask))]
    ms, ms32 = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    plain = cuda_ms(lambda: k3.dit_attention_plain(q, k, v, mask), iters=5)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask[:, None, None, :]))
    nbytes = 4 * B * heads * t * 64 * 2 + B * t
    flops = sum(4 * heads * t * n * 64 for n in lens)
    b_ms, by = bound(nbytes, flops, BF16_FLOPS)
    print(f"K3-bf16 {name} B={B} H={heads} T={t}: kernel_ms={ms:.4f} (turns float32, "
          f"bf16, bf16, float32: {', '.join(f'{x:.4f}' for x in turns)}; float32 "
          f"instantiation {ms32:.4f}) plain_ms={plain:.4f} library_ms(sdpa bf16)={lib:.4f} "
          f"bound_ms(bf16 tensor cores)={b_ms:.4f} ({by}); {flops / ms / 1e9:.1f} TFLOP/s, "
          f"{ms / b_ms:.1f}x the bound, {ms / lib:.2f}x SDPA")
    return ms, plain, lib, b_ms, by


def check_k3_bf16(shapes, longest, heads: int):
    """K3's bfloat16 instantiation (a bfloat16 DiT) against its plain
    version on bfloat16 q, k, v (`dit_attention_plain`, the JAX XLA path
    dtype by dtype: bfloat16 scores, float32 softmax) at `k3_bf16_cases`.
    The plain version rounds the scores to bfloat16, the kernel does not,
    so both are held to the float32 attention of the same bfloat16 inputs:
    the kernel no farther from it than the plain version, and the two
    within 3e-2 of max|out| (the plain version's score rounding moves it
    ~1.4e-2). Each call is one launch of the bfloat16 instantiation and
    none of the float32 one. Masking is exact: with the k and v of every
    masked key replaced by other finite draws (x100), each row with a valid
    key keeps its bits. The main case repeats its bits on a second call
    and on contiguous copies of the strided views. Prints the kernel's
    registers and local (spill) bytes a thread, which must be 0. Timed
    (`time_k3_bf16`) at the main path, the longest segment and 16 rows."""
    import torch

    from indextts_tpu_torch.ops import dit_attention as k3

    g = torch.Generator(device="cuda").manual_seed(33)
    errs, inputs = {}, {}
    for name, t, rows in k3_bf16_cases(shapes, longest):
        q, k, v, mask, lens = inp = k3_bf16_inputs(g, name, t, rows, heads)
        B = len(rows)
        before = k3.bf16_counter.launches, k3.counter.launches
        got = k3.dit_attention(q, k, v, mask)
        if got.dtype != torch.bfloat16 or (k3.bf16_counter.launches, k3.counter.launches) != (
                before[0] + 1, before[1]):
            fail(f"K3-bf16 {name}: not one launch of the bfloat16 instantiation")
        want = k3.dit_attention_plain(q, k, v, mask).float()
        exact = k3.dit_attention_plain(q.float(), k.float(), v.float(), mask)
        top = exact.abs().max().item()
        err = (got.float() - want).abs().max().item()
        kern, plain = ((x - exact).abs().max().item() for x in (got.float(), want))
        errs[name] = err
        print(f"K3-bf16 {name}: B={B} H={heads} T={t} valid={lens} max_abs_err={err:.3g} "
              f"(tol {3e-2 * top:.3g}: 3e-2 of max|out| {top:.3g}); against the float32 "
              f"attention of the bf16 inputs: kernel {kern:.3g}, plain {plain:.3g}")
        if not (err <= 3e-2 * top and kern <= plain):
            fail(f"K3-bf16 {name} disagrees with its plain version: {err}, {kern} > {plain}")
        masked = ~mask[:, None, :, None]
        junk = [torch.where(masked, 100 * torch.randn(x.shape, generator=g, device="cuda")
                            .to(x.dtype), x) for x in (k, v)]
        again = k3.dit_attention(q, *junk, mask)
        kept = [bool(torch.equal(again[r], got[r])) for r, n in enumerate(lens) if n]
        print(f"K3-bf16 {name}: masked keys' k and v replaced by other draws (x100): rows "
              f"with a valid key keep their bits: {all(kept)} ({sum(kept)} of {len(kept)})")
        if not all(kept):
            fail(f"K3-bf16 {name}: the values at masked keys changed an output")
        inputs[name] = inp
    q, k, v, mask, lens = inputs["main"]
    got = k3.dit_attention(q, k, v, mask)
    same = [torch.equal(k3.dit_attention(q, k, v, mask), got),
            torch.equal(k3.dit_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                         mask), got)]
    print(f"K3-bf16 main: a second call and contiguous copies of the strided views give the "
          f"same bits: {same}")
    if not all(same):
        fail("K3-bf16: a repeated call or contiguous inputs changed the result")
    one_launch("K3-bf16", lambda: k3.dit_attention(q, k, v, mask))
    attrs = k3.bf16_attributes()
    for n, (regs, local) in attrs.items():
        print(f"K3-bf16, blocks of {n} consumer warpgroups: {regs} registers a thread at "
              f"launch, {local} bytes of local memory (spills) a thread")
    if any(local for _, local in attrs.values()):
        fail(f"K3-bf16 spills to local memory: {attrs}")

    ms, plain, lib, b_ms, by = time_k3_bf16("main", inputs["main"], heads)
    for name in inputs:
        if name.startswith("longest") or name == "batched 16 rows":
            time_k3_bf16(name, inputs[name], heads)
    return {"name": "K3-bf16 dit_attention", "route": "cuda",
            "source": "indextts_tpu_torch/csrc/dit_attention.cu",
            "replaces": "indextts_tpu/models/s2mel.py:141",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib}


def events_ms(fn, iters: int = 10) -> float:
    """Device time of one eager fn() call from CUDA events around `iters`
    calls after two warm-ups: for autograd calls, which this script does
    not capture in a graph."""
    import torch

    for _ in range(2):
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


def nonprefix_row(t: int):
    """A (t,) bool row of keys whose valid keys are no prefix: a whole
    128-key run masked between valid keys (keys 192-319: two of K9's 64-key
    blocks and four of K10's 32-key tiles), every seventh key masked
    elsewhere, and the last five."""
    import torch

    j = torch.arange(t, device="cuda")
    return ~(((j >= 192) & (j < 320)) | (j % 7 == 3) | (j >= t - 5))


def key_mask(t: int, rows):
    """(len(rows), t) bool key mask: a row n valid keys for an int n, the
    keys of `nonprefix_row` for "non-prefix", of `masked_head_row` for
    "masked-head"."""
    import torch

    j = torch.arange(t, device="cuda")
    special = {"non-prefix": nonprefix_row, "masked-head": masked_head_row}
    return torch.stack([special[r](t) if isinstance(r, str) else j < r for r in rows])


def k9_k10_cases(shapes, longest):
    """(name, T, rows) of K9's and K10's checks: the main path's solve
    (T=898, 774 valid, on the DiT's strided views), the longest segment's
    (T=2946, 2838 valid), T=37 below one tile, T=100, a row with one valid
    key, T=300, T=1000, a row with none (uniform softmax: a dV but no dQ,
    dK), a batched solve's 16 rows, and a row whose valid keys are no
    prefix beside a row with none."""
    T, tv = shapes["dit_T"], shapes["dit_valid"]
    long_T, long_v = longest["dit_T"], longest["dit_valid"]
    return [("main", T, [tv, tv]), (f"longest T={long_T}", long_T, [long_v, long_v]),
            ("T37", 37, [37, 20]), ("T100", 100, [100, 37]), ("T255", 255, [255, 1]),
            ("T300", 300, [300, 150]), ("T1000", 1000, [999, 600]),
            ("no-valid-key", 300, [300, 0]),
            ("batched 16 rows", T, shapes["batch_dit_valid"] * 2),
            ("non-prefix", T, ["non-prefix", 0])]


def k9_k10_inputs(g, name: str, t: int, rows, heads: int):
    """(q, k, v, mask, lens, out, stats, dout) of one case: the DiT's
    strided views at the main path's shapes, else contiguous draws; K3's
    output and row statistics; lens each row's valid keys."""
    import torch

    from indextts_tpu_torch.ops import dit_attention as k3

    B = len(rows)
    if name in ("main", "batched 16 rows") or name.startswith("longest"):
        q, k, v = dit_qkv(g, B, heads, t)
    else:
        q, k, v = (torch.randn((B, heads, t, 64), generator=g, device="cuda") for _ in range(3))
    dout = torch.randn((B, heads, t, 64), generator=g, device="cuda")
    mask = key_mask(t, rows)
    out, stats = k3.dit_attention_stats(q, k, v, mask)
    return q, k, v, mask, mask.sum(1).tolist(), out, stats, dout


def time_k9_k10(name: str, inputs, heads: int, full: bool = True):
    """K9, K10, D and K9 + K10 + D (CUDA events over graph replays) and
    SDPA's one backward of dq, dk and dv (events over eager autograd calls)
    on one case's inputs; with `full`, also K3 with its row statistics in
    turns with K3 without, and the plain versions (autograd of the plain
    graph with respect to each kernel's inputs: K9 k, v; K10 q). Bounds at
    K3's rate: 3xTF32, three TF32 products per product, on the tensor cores,
    over the valid keys (a row with no valid key still has a uniform dV over
    all T keys). Returns {"K9": (ms, plain, lib, bound, by), "K10": ...}."""
    import torch
    import torch.nn.functional as F

    from indextts_tpu_torch.ops import dit_attention as k3

    q, k, v, mask, lens, out, stats, dout = inputs
    B, _, t, _ = q.shape
    delta = (dout * out).sum(-1).contiguous()
    if full:
        turns = [cuda_ms(lambda: k3.dit_attention(q, k, v, mask)),
                 cuda_ms(lambda: k3.dit_attention_stats(q, k, v, mask)),
                 cuda_ms(lambda: k3.dit_attention_stats(q, k, v, mask)),
                 cuda_ms(lambda: k3.dit_attention(q, k, v, mask))]
        print(f"K3 with row statistics {name} B={B} H={heads} T={t}: kernel_ms="
              f"{(turns[1] + turns[2]) / 2:.4f}, without {(turns[0] + turns[3]) / 2:.4f} "
              f"(turns without, with, with, without: {', '.join(f'{x:.4f}' for x in turns)})")
    ms9 = cuda_ms(lambda: k3.dit_attention_bwd_dkv(q, k, v, mask, stats, dout, delta))
    ms10 = cuda_ms(lambda: k3.dit_attention_bwd_dq(q, k, v, mask, stats, dout, delta))
    ms_d = cuda_ms(lambda: (dout * out).sum(-1).contiguous())
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask[:, None, None, :])
    # SDPA's fused backward computes dq, dk and dv in one call whatever it
    # is asked for: the library's time is its whole backward, held against
    # K9 + K10 + D below, and stands in both rows
    lib = events_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dout, retain_graph=True))
    plain_out = k3.dit_attention_plain(qg, kg, vg, mask) if full else None
    res = {}
    for kname, ms, wrt, ops, nout in (("K9", ms9, (kg, vg), 8, 2), ("K10", ms10, (qg,), 6, 1)):
        plain = events_ms(lambda: torch.autograd.grad(plain_out, wrt, dout, retain_graph=True),
                          iters=5) if full else None
        # q, k, v, dO read, the gradients written; stats, D and the mask
        nbytes = 4 * B * heads * t * 64 * (4 + nout) + 12 * B * heads * t + B * t
        flops = sum(ops * heads * t * (n if n or kname == "K10" else t) * 64 for n in lens)
        fp32_ms, _ = bound(nbytes, flops)
        b_ms, by = bound(nbytes, 3 * flops, TF32_FLOPS)
        print(f"{kname} {name} B={B} H={heads} T={t}: kernel_ms={ms:.4f} "
              + (f"plain_ms(autograd of the plain graph)={plain:.4f} " if full else "")
              + f"bound_ms(3xTF32 tensor cores)={b_ms:.4f} ({by}) "
              f"bound_ms(fp32 CUDA cores)={fp32_ms:.4f}; {flops / ms / 1e9:.1f} TFLOP/s, "
              f"{ms / b_ms:.1f}x the bound")
        res[kname] = (ms, plain, lib, b_ms, by)
    total = ms9 + ms10 + ms_d
    plain_all = events_ms(lambda: torch.autograd.grad(plain_out, (qg, kg, vg), dout,
                                                      retain_graph=True), iters=5) if full else None
    print(f"K9 + K10 + D {name} B={B} H={heads} T={t}: {total:.4f} ms (D {ms_d:.4f}) "
          f"against library_ms(sdpa backward, dq dk dv)={lib:.4f}: {total / lib:.2f}x"
          + (f"; plain backward (dq dk dv) {plain_all:.4f}" if full else ""))
    return res


def check_k9_k10(shapes, longest, heads: int):
    """K3's row statistics, and K9 (dK, dV) and K10 (dQ), the backward of
    the float32 DiT attention, against autograd through
    `dit_attention_plain` at `k9_k10_cases`. Each gradient is held to 2e-5
    of max(1, max|plain|): both sum ~T float32 terms in another order, the
    kernels in 3xTF32 over K3's statistics. In a row with a valid key dK
    and dV are exactly 0 at every masked key (the kernels skip key tiles
    and warps that hold no valid key); in a row with none dq = dk = 0 and
    dv != 0. K3's output with statistics is the bits of K3's without, its
    m + log2 l within 1e-4 of the plain base-2 log-sum-exp (m = -1e9 and
    log2 l = log2 T in the row with no valid key). The main case repeats
    its bits on a second call. Prints each kernel's registers and local
    (spill) bytes a thread, which must be 0. Timed (`time_k9_k10`) at the
    main path, the longest segment and 16 rows; the library's fused
    backward of scaled_dot_product_attention computes dq, dk and dv in
    one call, so its time stands in both rows and is held against K9 +
    K10 + D. The bound is K3's: the 3xTF32 tensor-core rate."""
    import torch

    from indextts_tpu_torch.ops import dit_attention as k3

    g = torch.Generator(device="cuda").manual_seed(9)
    tol = 2e-5
    errs, inputs = {"K9": {}, "K10": {}}, {}
    for name, t, rows in k9_k10_cases(shapes, longest):
        inp = k9_k10_inputs(g, name, t, rows, heads)
        q, k, v, mask, lens, out, stats, dout = inp
        B = len(rows)
        if not torch.equal(out, k3.dit_attention(q, k, v, mask)):
            fail(f"K3 {name}: the output with statistics differs from the output without")
        scores = (torch.einsum("bhtd,bhsd->bhts", q, k) / 8.0).masked_fill(
            ~mask[:, None, None, :], k3.NEG_INF)
        lse2 = torch.logsumexp(scores, -1) / math.log(2.0)
        has = torch.tensor([n > 0 for n in lens], device="cuda")
        st_err = ((stats[..., 0] + stats[..., 1]) - lse2)[has].abs().max().item() \
            if any(lens) else 0.0
        if 0 in lens:
            r = lens.index(0)
            if not (bool((stats[r, ..., 0] == k3.NEG_INF).all())
                    and (stats[r, ..., 1] - math.log2(t)).abs().max().item() <= 1e-5):
                fail(f"K3 {name}: the row without a valid key has stats "
                     f"{stats[r, 0, :2].tolist()}")
        if not st_err <= 1e-4:
            fail(f"K3 {name}: row statistics off the plain log-sum-exp by {st_err}")
        del scores, lse2
        before = k3.bwd_dkv_counter.launches, k3.bwd_dq_counter.launches
        dq, dk, dv = k3.dit_attention_bwd(q, k, v, mask, out, stats, dout)
        if (k3.bwd_dkv_counter.launches, k3.bwd_dq_counter.launches) != (
                before[0] + 1, before[1] + 1):
            fail(f"K9/K10 {name}: not one launch of each")
        want = k3.dit_attention_bwd_plain(q, k, v, mask, dout)
        torch.cuda.synchronize()
        e = {}
        for label, got_t, want_t in (("dq", dq, want[0]), ("dk", dk, want[1]),
                                     ("dv", dv, want[2])):
            top = max(1.0, want_t.abs().max().item())
            e[label] = (got_t - want_t).abs().max().item() / top
        errs["K9"][name], errs["K10"][name] = max(e["dk"], e["dv"]), e["dq"]
        print(f"K9/K10 {name}: B={B} H={heads} T={t} valid={lens} err/max(1,max|plain|): "
              + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in e.items())
              + f" (tol {tol}); K3 stats off the plain base-2 log-sum-exp by {st_err:.3g}")
        if not all(x <= tol for x in e.values()):
            fail(f"K9/K10 {name} disagree with autograd of the plain version: {e}")
        for r, n in enumerate(lens):
            masked = ~mask[r]
            if n and (dk[r][:, masked].any() or dv[r][:, masked].any()):
                fail(f"K9 {name}: row {r} has a valid key, but dK or dV is not exactly 0 "
                     f"at its masked keys")
        if 0 in lens:
            r = lens.index(0)
            if dq[r].abs().max().item() != 0 or dk[r].abs().max().item() != 0 \
                    or dv[r].abs().max().item() == 0:
                fail(f"K9/K10 {name}: the row with no valid key must have dq = dk = 0 and "
                     f"dv != 0")
        inputs[name] = inp
    q, k, v, mask, lens, out, stats, dout = inputs["main"]
    got = k3.dit_attention_bwd(q, k, v, mask, out, stats, dout)
    again = k3.dit_attention_bwd(q, k, v, mask, out, stats, dout)
    same = [torch.equal(a, b) for a, b in zip(got, again)]
    print(f"K9/K10 main: a second call gives the same bits (dq, dk, dv): {same}")
    if not all(same):
        fail("K9/K10: a repeated call changed the result")
    delta = (dout * out).sum(-1).contiguous()
    one_launch("K9", lambda: k3.dit_attention_bwd_dkv(q, k, v, mask, stats, dout, delta))
    one_launch("K10", lambda: k3.dit_attention_bwd_dq(q, k, v, mask, stats, dout, delta))
    attrs = k3.bwd_attributes()
    for kname, (regs, local) in attrs.items():
        print(f"{kname}: {regs} registers a thread, {local} bytes of local memory (spills) a "
              f"thread")
    if any(local for _, local in attrs.values()):
        fail(f"K9/K10 spill to local memory: {attrs}")

    long_name = next(name for name in inputs if name.startswith("longest"))
    at_main = time_k9_k10("main", inputs["main"], heads)
    for name in (long_name, "batched 16 rows"):
        time_k9_k10(name, inputs[name], heads)
    rows = []
    for kname, label, what in (("K9", "K9 dit_attention_bwd_dkv", "dkv"),
                               ("K10", "K10 dit_attention_bwd_dq", "dq")):
        ms, plain, lib, b_ms, by = at_main[kname]
        rows.append({"name": label, "route": "cuda",
                    "source": "indextts_tpu_torch/csrc/dit_attention_bwd.cu",
                    "replaces": LIBRARY_FLASH + (":941" if what == "dkv" else ":1287"),
                    "max_abs_err": max(errs[kname].values()), "ms": ms, "plain_ms": plain,
                    "bound_ms": b_ms, "bound_by": by, "library_ms": lib})
    return rows


def check_k4(shapes, layers: int, heads: int):
    import torch

    from indextts_tpu_torch.models.gpt2 import quantize_kv
    from indextts_tpu_torch.ops import decode_attention as k4

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    tol = 2e-5  # as K1, over an int8 cache
    cap = shapes["decode_cap"]

    def make(B, c):
        q = torch.randn((B, heads, 64), generator=g, device=dev)
        k8, ksc = quantize_kv(torch.randn((B, heads, c, 64), generator=g, device=dev))
        v8, vsc = quantize_kv(torch.randn((B, heads, c, 64), generator=g, device=dev))
        return q, k8, v8, ksc, vsc

    cases = decode_cases(cap, *(shapes[k] for k in CASE_SHAPES)) + [
        ("valid-1", 3, cap, [1, 1, 1], [0, 0, 0], [0, 0, 0])]
    err = check_decode_cases("K4", k4.ragged_decode_attention_q8,
                             k4.ragged_decode_attention_q8_plain, cases, make, tol)
    main = time_k4(cap, layers, heads)[0]
    return {"name": "K4 ragged_decode_attention_q8", "route": "cuda",
            "source": "indextts_tpu_torch/csrc/decode_attention.cu",
            "replaces": "indextts_tpu/ops/decode_attention.py:429",
            "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain"],
            "bound_ms": main["bound"], "bound_by": main["by"], "library_ms": None}


def q8_weight(g, d: int, f: int):
    """A random (d, f) weight quantized as the engine does, with a bias."""
    import torch

    from indextts_tpu_torch.models.gpt2 import quantize_weight

    w_q, s = quantize_weight(torch.randn((d, f), generator=g, device="cuda") / d ** 0.5)
    return w_q, s, torch.randn((f,), generator=g, device="cuda") * 0.1


def q8_row(g, b: int, d: int):
    import torch

    from indextts_tpu_torch.models.gpt2 import quant_row

    return quant_row(torch.randn((b, d), generator=g, device="cuda"))


def int_mm_17(xq, w_q):
    """torch._int_mm on the activation padded to 17 rows (it takes more than
    16) and a column-major weight; int32 out, no float epilogue."""
    import torch

    x17 = torch.zeros((17, xq.shape[1]), dtype=torch.int8, device=xq.device)
    x17[:xq.shape[0]] = xq
    return x17, w_q.t().contiguous().t()


def gemv_cases(main: dict, d: int):
    """K5's and K7's cases: every main-path shape at 1, 3 and 16 rows (one
    launch's most), F=384, c_attn at D=2048 (2048 x 6144) at 1 and 16 rows,
    and c_attn at 17 and 40 rows (in chunks of 16)."""
    cases = [(f"{name} b={b}", b, di, f) for name, (di, f, _) in main.items()
             for b in (1, 3, 16)]
    cases.append(("F=384", 1, d, 384))
    cases += [(f"D=2048 c_attn b={b}", b, 2048, 6144) for b in (1, 16)]
    cases += [(f"c_attn b={b}", b, d, 3 * d) for b in (17, 40)]
    return cases


def cycle_copies(nbytes: int, per_step: int) -> int:
    """Weight copies a timing loop cycles through: at least one step's, and
    more than L2_CYCLE_BYTES in all, so that the weights come from device
    memory as in a decode step, not from the 50 MB L2."""
    return max(per_step, L2_CYCLE_BYTES // nbytes + 1)


def time_gemv(label: str, call, plain, main: dict, weight, lib_weight, g, packed: bool):
    """Per-shape and per-decode-step device times of K5 or K7 (`call`), its
    plain version and torch._int_mm over the same (unpacked) weights, the
    bound and the host us of an eager call; one launch (torch.profiler) and
    the same bits on repeated calls and graph replays at c_attn. Returns
    the step's totals."""
    import torch

    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0}
    for name, (di, f, per_step) in main.items():
        wbytes = di * f // (2 if packed else 1)
        copies = cycle_copies(wbytes, per_step)
        xq, a = q8_row(g, 1, di)
        args = [(xq, a, *weight(g, di, f)) for _ in range(copies)]
        if name == "c_attn":
            one_launch(label, cycled(call, args))
            replays_equal(label, lambda: call(*args[0]), call(*args[0]))
        ms = cuda_ms(cycled(call, args), iters=2 * copies)
        plain_ms = cuda_ms(cycled(plain, args), iters=copies, replays=2)
        lib_args = [int_mm_17(xq, lib_weight(w[2])) for w in args]
        lib = cuda_ms(cycled(torch._int_mm, lib_args), iters=2 * copies)
        del lib_args
        b_ms, _ = bound(wbytes + 8 * f + di + 4 + 4 * f, 2 * di * f, INT8_OPS)
        print(f"{label} {name} D={di} F={f}: kernel_ms={ms:.5f} plain_ms={plain_ms:.4f} "
              f"library_ms(_int_mm{' over the unpacked weight' if packed else ''}, 17 rows)="
              f"{lib:.5f} bound_ms={b_ms:.5f} (bytes) x{per_step} per step; {copies} copies "
              f"cycled ({copies * wbytes / 1e6:.1f} MB); host {host_us(cycled(call, args)):.2f} "
              f"us per eager call")
        for key, v in (("ms", ms), ("plain", plain_ms), ("lib", lib), ("bound", b_ms)):
            tot[key] += per_step * v
        del args
    launches = sum(n for _, _, n in main.values())
    print(f"{label} one decode step ({launches} launches): kernel_ms={tot['ms']:.4f} "
          f"({tot['ms'] / launches:.5f} per launch) plain_ms={tot['plain']:.4f} "
          f"library_ms(_int_mm, 17 rows)={tot['lib']:.4f} bound_ms={tot['bound']:.4f} (bytes)")
    return tot


def check_k5(layers: int, d: int, vocab: int):
    import torch

    from indextts_tpu_torch.ops import gemv as k5

    g = torch.Generator(device="cuda").manual_seed(5)
    rel_tol = 1e-6  # exact int32 sums, same float32 epilogue: equal in practice
    fpad = -(-vocab // 128) * 128
    main = {"c_attn": (d, 3 * d, layers), "attn c_proj": (d, d, layers), "head": (d, fpad, 1)}
    cases = gemv_cases(main, d) + [("attn c_proj at D=32768, three passes", 3, 32768, d)]
    errs = {}
    for name, b, di, f in cases:
        if not k5.supports(di, f):
            fail(f"K5 case {name}: supports({di}, {f}) is false")
        xq, a = q8_row(g, b, di)
        w = q8_weight(g, di, f)
        got = k5.gemv_w8(xq, a, *w)
        want = k5.gemv_w8_plain(xq, a, *w)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        errs[name] = err
        print(f"K5 {name}: D={di} F={f} rows={b} max_abs_err={err:.3g} of max|y| {scale:.3g} "
              f"(tol {rel_tol} relative)")
        if not err <= rel_tol * scale:
            fail(f"K5 {name} disagrees with its plain version: {err}")

    # one decode step: 24 x c_attn, 24 x attn c_proj, 1 x head
    tot = time_gemv("K5", k5.gemv_w8, k5.gemv_w8_plain, main, q8_weight, lambda w: w, g,
                    packed=False)
    return {"name": "K5 gemv_w8", "route": "cuda",
            "source": "indextts_tpu_torch/csrc/gemv.cu",
            "replaces": "indextts_tpu/ops/gemv.py:116",
            "max_abs_err": max(errs.values()), "ms": tot["ms"], "plain_ms": tot["plain"],
            "bound_ms": tot["bound"], "bound_by": "bytes", "library_ms": tot["lib"]}


def replays_equal(label: str, fn, got):
    """Two more fn() calls, then two replays of a CUDA graph of one call,
    must give `got` to the bit (the fused MLPs re-arm their counters). The
    graph is captured on the stream it was warmed up on, whose first call
    made the stream's counters."""
    import torch

    same = [torch.equal(fn(), got) for _ in range(2)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same.append(torch.equal(out, got))
    print(f"{label} repeated: 2 calls and 2 graph replays equal to the first call's bits: "
          f"{same}")
    if not all(same):
        fail(f"{label}: repeated calls or graph replays changed the result")


def check_mlp_cases(label: str, mlp, plain, weights, group, d: int, d_one: int, seed: int):
    """A fused MLP against its plain version at full width (1, 3 and 16
    rows, and 17 and 40 in chunks of 16), at D=512 (two groups), at d_one (FH=4*d_one is one group), and at
    D=1536 and D=2048 (48 and 32 hidden columns a block; D=2048 also at 16
    rows, the most shared memory of these cases), each within 1e-6
    of max|out| (exact int32 sums, the plain versions' float32 operations in
    their order); full width is also called again and replayed from a CUDA
    graph. Returns the largest error."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    rel_tol = 1e-6
    cases = [("full width", 1, d), ("full width b=3", 3, d), ("full width b=16", 16, d),
             ("full width b=17", 17, d), ("full width b=40", 40, d),
             ("D=512", 1, 512), ("D=512 b=3", 3, 512), ("one group", 1, d_one),
             ("D=1536", 1, 1536), ("D=2048", 1, 2048), ("D=2048 b=16", 16, 2048)]
    err_max = 0.0
    for name, b, di in cases:
        fh = 4 * di
        xq, a = q8_row(g, b, di)
        w = weights(g, di, fh)
        got = mlp(xq, a, *w)
        want = plain(xq, a, *w)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        err_max = max(err_max, err)
        print(f"{label} {name}: D={di} FH={fh} rows={b} groups={fh // group(di, fh)} "
              f"max_abs_err={err:.3g} of max|out| {scale:.3g} (tol {rel_tol} relative)")
        if not err <= rel_tol * scale:
            fail(f"{label} {name} disagrees with its plain version: {err}")
        if name == "full width":
            replays_equal(label, lambda: mlp(xq, a, *w), got)
    return err_max


def one_launch(label: str, call, tries: int = 3):
    """torch.profiler's count of the device kernels of one call: must be 1.
    A profile that saw fewer kernels than calls lost records (every call
    launches at least one kernel; one full run of this script saw 10 of
    K6's 48) and is taken again, up to `tries` profiles in all; a count
    above one fails at once. Where every profile lost device records, one
    kernel and no other was seen, and the host recorded exactly one launch
    call a call, the call is one launch: two full runs saw 47 of K3-bf16's
    48 device records in each of three profiles, which the kernel alone
    under the profiler never showed."""
    for _ in range(tries):
        kernels, host = profile_calls(call)
        for name, (n, ms) in kernels.items():
            print(f"{label} device kernel {name[:60]}: {n:g} per call, {ms:.5f} ms")
        n = sum(n for n, _ in kernels.values())
        print(f"{label} kernels launched per call: {n:g} (launch calls on the host: {host:g})")
        if n >= 1:
            break
        print(f"{label}: the profiler lost kernel records; profiling again")
    if 0 < n < 1 and host == 1 and len(kernels) == 1:
        print(f"{label}: device records lost in each of {tries} profiles; the host recorded "
              "one launch call a call, of the one kernel seen: one launch a call")
    elif n != 1:
        fail(f"{label} launches {n} kernels per call, not one")


def check_k6(layers: int, d: int):
    import torch

    from indextts_tpu_torch.ops import gemv as k6

    err = check_mlp_cases("K6", k6.mlp_w8, k6.mlp_w8_plain,
                          lambda g, di, fh: q8_weight(g, di, fh) + q8_weight(g, fh, di),
                          k6.mlp_group, d, 128, 6)
    g = torch.Generator(device="cuda").manual_seed(6)
    fh = 4 * d
    xq, a = q8_row(g, 1, d)
    args = [(xq, a, *q8_weight(g, d, fh), *q8_weight(g, fh, d)) for _ in range(layers)]
    one_launch("K6", cycled(k6.mlp_w8, args))
    ms = cuda_ms(cycled(k6.mlp_w8, args), iters=2 * layers)
    plain = cuda_ms(cycled(k6.mlp_w8_plain, args), iters=layers, replays=2)
    hq = torch.zeros((1, fh), dtype=torch.int8, device="cuda")
    lib_args = [int_mm_17(xq, w[2]) + int_mm_17(hq, w[5]) for w in args]
    lib = cuda_ms(cycled(lambda x, w1, h, w2: (torch._int_mm(x, w1), torch._int_mm(h, w2)),
                         lib_args), iters=2 * layers)
    b_ms, by = bound(2 * d * fh + 8 * fh + 8 * d + d + 4 + 4 * d, 4 * d * fh, INT8_OPS)
    print(f"K6 full width D={d} FH={fh}: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
          f"library_ms(2 x _int_mm, 17 rows)={lib:.4f} bound_ms={b_ms:.5f} ({by}); "
          f"host {host_us(cycled(k6.mlp_w8, args)):.2f} us per eager call")
    return {"name": "K6 mlp_w8", "route": "cuda",
            "source": "indextts_tpu_torch/csrc/gemv.cu",
            "replaces": "indextts_tpu/ops/gemv.py:232",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib}


def q4_weight(g, d: int, f: int, cols: bool = False):
    """A random (d, f) weight packed to int4 as the engine does, with a bias."""
    import torch

    from indextts_tpu_torch.models.gpt2 import quantize_weight_w4

    w_p, s = quantize_weight_w4(torch.randn((d, f), generator=g, device="cuda") / d ** 0.5,
                                cols)
    return w_p, s, torch.randn((f,), generator=g, device="cuda") * 0.1


def check_k7(layers: int, d: int):
    import torch

    from indextts_tpu_torch.ops import gemv as k7

    g = torch.Generator(device="cuda").manual_seed(7)
    main = {"c_attn": (d, 3 * d, layers), "attn c_proj": (d, d, layers)}
    cases = gemv_cases(main, d) + [("attn c_proj at D=65536, three passes", 3, 65536, d)]
    errs = {}
    for name, b, di, f in cases:
        if not k7.supports_w4(di, f):
            fail(f"K7 case {name}: supports_w4({di}, {f}) is false")
        xq, a = q8_row(g, b, di)
        w = q4_weight(g, di, f)
        got = k7.gemv_w4(xq, a, *w)
        want = k7.gemv_w4_plain(xq, a, *w)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        errs[name] = err
        print(f"K7 {name}: D={di} F={f} rows={b} max_abs_err={err:.3g} of max|y| "
              f"{want.abs().max().item():.3g} (tol 0: to the bit)")
        if not torch.equal(got, want):
            fail(f"K7 {name} disagrees with its plain version: {err}")

    # one decode step: 24 x c_attn, 24 x attn c_proj
    tot = time_gemv("K7", k7.gemv_w4, k7.gemv_w4_plain, main, q4_weight, k7.unpack_w4, g,
                    packed=True)
    return {"name": "K7 gemv_w4", "route": "cuda",
            "source": "indextts_tpu_torch/csrc/gemv.cu",
            "replaces": "indextts_tpu/ops/gemv.py:171",
            "max_abs_err": max(errs.values()), "ms": tot["ms"], "plain_ms": tot["plain"],
            "bound_ms": tot["bound"], "bound_by": "bytes", "library_ms": tot["lib"]}


def check_k8(layers: int, d: int):
    import torch

    from indextts_tpu_torch.ops import gemv as k8

    err = check_mlp_cases(
        "K8", k8.mlp_w4, k8.mlp_w4_plain,
        lambda g, di, fh: q4_weight(g, di, fh) + q4_weight(g, fh, di, cols=True),
        k8.mlp_group_w4, d, 256, 8)
    g = torch.Generator(device="cuda").manual_seed(8)
    fh = 4 * d
    xq, a = q8_row(g, 1, d)
    args = [(xq, a, *q4_weight(g, d, fh), *q4_weight(g, fh, d, cols=True))
            for _ in range(layers)]
    one_launch("K8", cycled(k8.mlp_w4, args))
    ms = cuda_ms(cycled(k8.mlp_w4, args), iters=2 * layers)
    plain = cuda_ms(cycled(k8.mlp_w4_plain, args), iters=layers, replays=2)
    hq = torch.zeros((1, fh), dtype=torch.int8, device="cuda")
    lib_args = [int_mm_17(xq, k8.unpack_w4(w[2])) + int_mm_17(hq, k8.unpack_w4(w[5], axis=1))
                for w in args]
    lib = cuda_ms(cycled(lambda x, w1, h, w2: (torch._int_mm(x, w1), torch._int_mm(h, w2)),
                         lib_args), iters=2 * layers)
    b_ms, by = bound(d * fh + 8 * fh + 8 * d + d + 4 + 4 * d, 4 * d * fh, INT8_OPS)
    print(f"K8 full width D={d} FH={fh}: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
          f"library_ms(2 x _int_mm over the unpacked weights, 17 rows)={lib:.4f} "
          f"bound_ms={b_ms:.5f} ({by}); host {host_us(cycled(k8.mlp_w4, args)):.2f} us "
          f"per eager call")
    return {"name": "K8 mlp_w4", "route": "cuda",
            "source": "indextts_tpu_torch/csrc/gemv.cu",
            "replaces": "indextts_tpu/ops/gemv.py:323",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib}


# ---------------------------------------------------------------------------
# phase 3: the slice
# ---------------------------------------------------------------------------


def speaker_wav(path: str, seed: int = 0):
    """A seeded synthetic voice-like prompt: a gliding harmonic tone with
    syllable-rate amplitude modulation and a little noise."""
    from indextts_tpu_torch.utils import audio as audio_utils

    rng = np.random.default_rng(seed)
    t = np.arange(PROMPT_SECONDS * PROMPT_SR) / PROMPT_SR
    f0 = 120 + 20 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / PROMPT_SR
    x = sum(np.sin(h * phase) / h for h in range(1, 8))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 4 * t) ** 2
    x += 0.01 * rng.standard_normal(t.shape)
    audio_utils.save_wav(path, (0.3 * x / np.abs(x).max()).astype(np.float32), PROMPT_SR)


def small_config(model_dim: int = 128):
    """A few layers, narrow widths, but 64-wide heads so K1 and K3 run."""
    from indextts_tpu_torch import config as C

    return C.IndexTTS2Config(
        gpt=C.GPTConfig(
            model_dim=model_dim, layers=2, heads=model_dim // 64, max_mel_tokens=64,
            max_text_tokens=32,
            number_text_tokens=50, number_mel_codes=36, start_mel_token=34,
            stop_mel_token=35,
            condition_module=C.ConditionModuleConfig(
                output_size=32, linear_units=48, attention_heads=4, num_blocks=1),
            emo_condition_module=C.ConditionModuleConfig(
                output_size=32, linear_units=32, attention_heads=2, num_blocks=1)),
        semantic_codec=C.SemanticCodecConfig(
            codebook_size=36, hidden_size=1024, codebook_dim=8, vocos_dim=24,
            vocos_intermediate_dim=32, vocos_num_layers=1),
        s2mel=C.S2MelConfig(
            length_regulator=C.LengthRegulatorConfig(channels=32, in_channels=1024),
            dit=C.DiTConfig(hidden_dim=128, num_heads=2, depth=3, in_channels=80,
                            content_dim=32, style_dim=192),
            wavenet=C.WaveNetConfig(hidden_dim=32, num_layers=2, kernel_size=5),
            gpt_dims=(model_dim, 16, 8, 1024)),
        vocoder=C.BigVGANConfig(
            num_mels=80, upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
            upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
            resblock_dilation_sizes=((1, 3), (1, 3))),
        w2vbert=C.W2VBertConfig(
            hidden_size=1024, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, tap_layer=2, conv_depthwise_kernel_size=7),
        campplus=C.CampPlusConfig(),
        runtime=C.RuntimeConfig(diffusion_steps=4, max_mel_tokens=24, num_beams=1,
                                do_sample=False))


def quantized(cfg, wbits: int = 8, gemv_impl: str = "pallas"):
    """`cfg` with the JAX package's quantized GPT route: W8A8 or W4A8 blocks,
    the int8 logits head and the int8 KV cache, and gemv_impl (W8 reaches
    K5 and K6 under "pallas", and under "auto" on the card)."""
    rt = dataclasses.replace(cfg.runtime, gpt_quantize=True, head_quant=True, kv_quant=True,
                             gpt_wbits=wbits, gemv_impl=gemv_impl)
    return dataclasses.replace(cfg, runtime=rt)


def small_reference(wav_path: str, cfg, label: str, mel_tol: float, wav_tol: float):
    """A small config greedy on the card (kernels) and on the CPU (plain
    versions), same weights (each module's seeded initialization, so the
    waveform stays off the clip) and CFM noise; codes equal, mel within
    mel_tol of its largest value, waveform within wav_tol of its peak. The
    same segment's deterministic beam search over BEAMS beams (captured on
    the card) gives the same codes on both."""
    from indextts_tpu_torch.runtime.engine import (
        EmotionConditioning,
        IndexTTS2Engine,
        random_params,
    )
    from indextts_tpu_torch.utils import audio as audio_utils

    params = random_params(cfg, seed=0, device="cpu")
    audio, sr = audio_utils.load_wav(wav_path)
    text = np.random.default_rng(0).integers(2, 50, 11)
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = IndexTTS2Engine(cfg, params, device=dev)
        noise_rng = np.random.default_rng(5)
        eng._noise_hook = lambda shape: noise_rng.standard_normal(shape).astype(np.float32)
        eng._mel_taps = []
        spk = eng.prepare_speaker(audio, sr)
        emo = EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
        _, codes, _ = eng._decode_segment_codes(spk, emo, text, seed=0)
        _, beam, _ = eng._decode_segment_codes(spk, emo, text, seed=0, num_beams=BEAMS,
                                               do_sample=False)
        res = eng.infer((audio, sr), [text], seed=0)
        seen = spy_codes(eng)
        try:
            batched = eng.infer((audio, sr), [text, text[:6], text[4:]], seed=0, batched=True)
        finally:
            eng.decoder.__dict__.pop("generate", None)
        outs[dev] = (codes, eng._mel_taps[0], res["audio"], beam, seen[0], batched["audio"])
    (c0, m0, w0, b0, s0, bw0), (c1, m1, w1, b1, s1, bw1) = outs["cpu"], outs["cuda"]
    if not all(np.array_equal(a, b) for a, b in zip(s0, s1)):
        fail(f"small config ({label}): batched codes differ on the card: {s0} vs {s1}")
    bpeak, berr = float(np.abs(bw0).max()), float(np.abs(bw0 - bw1).max())
    print(f"small config ({label}), card vs CPU: batched 3-segment codes equal (lengths "
          f"{s0[1].tolist()}), waveform max_abs_err={berr:.3g} of peak {bpeak:.3g} (tol "
          f"{wav_tol:g} relative)")
    if not (0 < bpeak < 1 and bw0.shape == bw1.shape and berr <= wav_tol * bpeak):
        fail(f"small config ({label}): the card's batched waveform disagrees with the CPU's")
    if not np.array_equal(c0, c1):
        fail(f"small config ({label}): greedy codes differ on the card: {c0} vs {c1}")
    if not np.array_equal(b0, b1):
        fail(f"small config ({label}): {BEAMS}-beam codes differ on the card: {b0} vs {b1}")
    print(f"small config ({label}), card vs CPU: deterministic {BEAMS}-beam codes equal "
          f"({len(b0)}: {b0.tolist()})")
    scale = float(np.abs(m0).max())
    peak = float(np.abs(w0).max())
    mel_err = float(np.abs(m0 - m1).max())
    wav_err = float(np.abs(w0 - w1).max())
    print(f"small config ({label}), card vs CPU: codes equal ({len(c0)}), mel "
          f"max_abs_err={mel_err:.3g} of |mel| {scale:.3g} (tol {mel_tol:g} relative), wav "
          f"max_abs_err={wav_err:.3g} of peak {peak:.3g} (tol {wav_tol:g} relative)")
    if not 0 < peak < 1:
        fail(f"small config ({label}): waveform peak {peak} says nothing (silent or clipped)")
    if not (np.isfinite(m1).all() and mel_err <= mel_tol * scale
            and wav_err <= wav_tol * peak):
        fail(f"small config ({label}): the card disagrees with the CPU reference")


class ServerThread:
    """The port's TTSServer on its own event loop, in a thread."""

    def __init__(self, server):
        self.server = server
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.task = self._call(self._start())
        t0 = time.perf_counter()
        while not server.ready:
            if self.task.done():
                self.task.result()
            if time.perf_counter() - t0 > 30:
                fail("server did not come up")
            time.sleep(0.05)

    def _call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=30)

    async def _start(self):
        return asyncio.ensure_future(self.server.serve())

    async def _cancel(self):
        self.task.cancel()
        await asyncio.gather(self.task, return_exceptions=True)

    def stop(self):
        self._call(self._cancel())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        self.server.pool.shutdown(wait=True)


def post_tts(port: int, payload: dict):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    conn.request("POST", "/tts", body=json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    body = r.read()
    conn.close()
    return r.status, body


def kernel_counters():
    """Every kernel's launch counter by its long name ("K5 gemv_w8"), from
    the package's one registry (`ops.KERNELS`)."""
    from indextts_tpu_torch.ops import launch_counters

    return launch_counters(long_names=True)


# ---------------------------------------------------------------------------
# phase train_phase: the training path at full width
# ---------------------------------------------------------------------------


def train_batches(cfg, shapes, g):
    """The main path's shapes as training batches, drawn on the card from
    `g`: the GPT's 8 rows of the batched phase's text ids (bucketed to 16)
    and codes (MAX_MEL_TOKENS - 37 b); the CFM's 8 rows of the solve's
    width (T=898) with the batched solve's valid frames (774 down) and the
    speaker prompt's mel frames."""
    import torch

    from indextts_tpu_torch.runtime.engine import next_bucket

    dev = torch.device("cuda")
    G, d = cfg.gpt, cfg.s2mel.dit
    B, texts, codes = len(shapes["batch_codes"]), shapes["batch_text"], shapes["batch_codes"]
    Lt, T = next_bucket(max(texts), 16, 16), shapes["dit_T"]

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev)

    gpt = {"spk_latents": normal(B, G.condition_num_latent, G.model_dim),
           "text_ids": ints(2, G.number_text_tokens, (B, Lt)),
           "text_lens": torch.tensor(texts, device=dev),
           "mel_codes": ints(0, G.start_mel_token, (B, max(codes))),
           "mel_lens": torch.tensor(codes, device=dev),
           "emovec": normal(B, G.model_dim)}
    cfm = {"x1": normal(B, d.in_channels, T),
           "x_lens": torch.tensor(shapes["batch_dit_valid"], device=dev),
           "prompt_lens": torch.full((B,), shapes["ref_mel"], device=dev),
           "mu": normal(B, T, d.content_dim), "style": normal(B, d.style_dim)}
    return gpt, cfm


def finetune_runs(target: str, tmp: str) -> None:
    """finetune.main on the card for `target`, full width, synthetic batches
    of 8: two steps with a save at step 2, then a resume for one more step
    (from step 2, to step 3, the checkpoint's meta at 3); finite losses."""
    from indextts_tpu_torch import finetune

    out_dir = os.path.join(tmp, target)
    argv = ["--target", target, "--synthetic", "8", "--out-dir", out_dir, "--log-every", "1"]
    runs = []
    for steps, more in ((2, ["--save-every", "2"]), (1, [])):
        t0 = time.perf_counter()
        out = finetune.main(argv + ["--steps", str(steps)] + more)
        ckpt = sum(f.stat().st_size for f in Path(out_dir, "latest").iterdir())
        print(f"[train] finetune {target}: {json.dumps(out)} in {time.perf_counter() - t0:.1f} "
              f"s; checkpoint {ckpt / 2**30:.2f} GiB")
        if not all(math.isfinite(x) for x in (out["loss_first"], out["loss_last"])):
            fail(f"[train] finetune {target}: a non-finite loss {out}")
        runs.append(out)
    meta = json.loads(Path(out_dir, "latest", "meta.json").read_text())["step"]
    if (runs[0]["final_step"], runs[1]["from_step"], runs[1]["final_step"], meta) != (2, 2, 3, 3):
        fail(f"[train] finetune {target}: the resume did not continue the step counter: "
             f"{runs}, meta {meta}")


def train_steps(label: str, model, step, batch, steps: int = TRAIN_STEPS):
    """`steps` optimizer steps on one fixed batch: the losses, the seconds of
    the first step and the steps/s of the rest (each step synchronized), and
    the peak device memory beyond what was allocated before the steps (the
    parameters and the batch are; the gradients and AdamW's state come with
    the first step)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step(batch).item())
        times.append(time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    rate = (steps - 1) / sum(times[1:])
    print(f"[train] {label}: {steps} steps, losses {[round(x, 5) for x in losses]}; first step "
          f"{times[0]:.3f} s, then {rate:.3f} steps/s ({1e3 / rate:.1f} ms a step); peak device "
          f"memory {peak:.2f} GiB beyond the {held / 2**30:.2f} GiB held before the steps; "
          f"{n_params / 1e6:.1f} M parameters")
    if not all(math.isfinite(x) for x in losses):
        fail(f"[train] {label}: a non-finite loss {losses}")
    return losses, rate, peak


def step_profile(label: str, fn, step_ms: float, calls: int = 3) -> None:
    """The device kernels of one training step (torch.profiler over `calls`
    steps after one): their device ms a step against the step's `step_ms`
    (the rest is the device's idle share), the share of K3, K9 and K10, and
    the largest kernels by device ms."""
    kernels = device_kernels(fn, calls=calls)
    total = sum(ms for _, ms in kernels.values())
    ours = {k: sum(ms for name, (_, ms) in kernels.items() if key in name)
            for k, key in (("K3", "dit_attn_kernel"), ("K9", "dit_attn_bwd_dkv"),
                           ("K10", "dit_attn_bwd_dq"))}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"[train] {label} step profile: {sum(n for n, _ in kernels.values()):g} kernels, "
          f"{total:.2f} device ms a step of {step_ms:.1f} ms ({100 * (1 - total / step_ms):.1f} % "
          f"idle); " + ", ".join(f"{k} {ms:.2f} ms ({100 * ms / total:.1f} %)"
                                  for k, ms in ours.items())
          + "; largest: " + "; ".join(f"{short_name(name)[:48]} {n:g} x {ms:.2f}"
                                      for name, (n, ms) in top))


def train_phase(shapes, card: str) -> dict:
    """Phase `train_phase`, the training path on one card at full width (GPT
    24L x 1280 with its text_head; S2Mel with the DiT 13L x 512), after the
    serving routes are freed: `finetune_runs` for each target, then
    TRAIN_STEPS steps of make_cfm_train_step on the main path's solve shape
    (8 rows of T=898, valid frames 774 down; CFM noise from a seeded
    generator) and of make_train_step on its text and codes (`train_batches`),
    AdamW at lr 1e-4, from seeded random weights. The counts of every kernel
    are set to 0 just before the CFM steps and read after: K3, K9 and K10
    once a DiT layer a step, no other kernel. The CFM loss at one fixed draw
    of t, z and drop must fall over the steps, the GPT's step loss (its
    batch fixed, its loss deterministic) too. Then a few more steps of each
    are profiled (`step_profile`). Returns K9's and K10's launches over the
    CFM steps."""
    import torch

    from indextts_tpu_torch.config import load_config
    from indextts_tpu_torch.runtime import train

    t0 = time.perf_counter()
    cfg = load_config()
    depth = cfg.s2mel.dit.depth
    with tempfile.TemporaryDirectory() as tmp:
        for target in ("gpt", "cfm"):
            finetune_runs(target, tmp)
            gc.collect()
            torch.cuda.empty_cache()
    print(f"[train] finetune runs done at {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    gpt_batch, cfm_batch = train_batches(cfg, shapes, g)

    model = train.train_model(cfg, "cfm", "cuda", seed=TRAIN_SEED)
    opt = train.adamw(model.parameters(), 1e-4)
    cfm_step = train.make_cfm_train_step(model, opt)
    fixed = train.cfm_noise(cfm_batch, g)

    def fixed_loss():
        with torch.no_grad():
            return train.cfm_loss(model, *(cfm_batch[k] for k in (
                "x1", "x_lens", "prompt_lens", "mu", "style")), *fixed)[0].item()

    before = fixed_loss()
    counters = kernel_counters()
    for cnt in counters.values():
        cnt.launches = 0
    losses, rate, peak = train_steps("cfm", model, lambda b: cfm_step(b, g), cfm_batch)
    launches = {name: cnt.launches for name, cnt in counters.items()}
    after = fixed_loss()
    print(f"[train] cfm: loss at a fixed t, z and drop {before:.5f} before the steps, "
          f"{after:.5f} after; launches over the steps {json.dumps(launches)}")
    want = {name: TRAIN_STEPS * depth if name.startswith(("K3 ", "K9 ", "K10 ")) else 0
            for name in counters}
    if launches != want:
        fail(f"[train] cfm: launches {launches}, not {want}")
    if not (math.isfinite(after) and after < before):
        fail(f"[train] cfm: the fixed-noise loss did not fall: {before} -> {after}")
    step_profile("cfm", lambda: cfm_step(cfm_batch, g), 1e3 / rate)
    del model, opt, cfm_step
    gc.collect()
    torch.cuda.empty_cache()

    model = train.train_model(cfg, "gpt", "cuda", seed=TRAIN_SEED)
    opt = train.adamw(model.parameters(), 1e-4)
    for cnt in counters.values():
        cnt.launches = 0
    gpt_losses, gpt_rate, gpt_peak = train_steps("gpt", model, train.make_train_step(model, opt),
                                                 gpt_batch)
    gpt_launches = {name: cnt.launches for name, cnt in counters.items() if cnt.launches}
    if gpt_launches:  # the GPT's training forward is full-sequence plain torch
        fail(f"[train] gpt: launched {gpt_launches}")
    if not gpt_losses[-1] < gpt_losses[0]:
        fail(f"[train] gpt: the loss on a fixed batch did not fall: {gpt_losses}")
    gpt_step = train.make_train_step(model, opt)
    step_profile("gpt", lambda: gpt_step(gpt_batch), 1e3 / gpt_rate)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] {card}: cfm {rate:.3f} steps/s, peak {peak:.2f} GiB, loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f} (fixed noise {before:.5f} -> {after:.5f}); gpt "
          f"{gpt_rate:.3f} steps/s, peak {gpt_peak:.2f} GiB, loss {gpt_losses[0]:.5f} -> "
          f"{gpt_losses[-1]:.5f}")
    print(f"phase train_phase done in {time.perf_counter() - t0:.1f} s")
    return {name: launches[name] for name in launches if name.startswith(("K9 ", "K10 "))}


# ---------------------------------------------------------------------------
# the checkpoint directory: the full-width weights in the reference's layout
# ---------------------------------------------------------------------------

def save_safetensors(path, tensors, metadata=None) -> None:
    """Write `tensors` in the safetensors format with the port's own writer
    (utils/safetensors.py `save_file`), which needs no `safetensors`
    package."""
    from indextts_tpu_torch.utils.safetensors import save_file

    save_file(tensors, path, metadata)


def weight_normed(name: str, key: str) -> bool:
    """Does the reference's checkpoint store the port's `key` of model
    `name` as a weight-norm pair (weight_g, weight_v)? The DiT's final
    linear, WaveNet's layers, RepCodec's projections and every BigVGAN
    convolution do."""
    if not key.endswith(".weight"):
        return False
    if name == "bigvgan":
        return True  # its only .weight tensors are the convolutions
    if name == "s2mel":
        return ".wavenet." in key or ".final_layer.linear." in key
    return name == "repcodec" and "_project." in key


def weight_norm_pairs(name: str, sd):
    """`sd` with each weight-normed layer's weight w as the pair g = ||w||
    over every axis but 0, v = w."""
    out = {}
    for key, w in sd.items():
        if weight_normed(name, key):
            layer = key[:-len(".weight")]
            out[f"{layer}.weight_g"] = w.norm(dim=tuple(range(1, w.ndim)), keepdim=True)
            out[f"{layer}.weight_v"] = w
        else:
            out[key] = w
    return out


def write_reference_dir(d: str, sds, text_head, semantic_stats, emo_matrix, spk_matrix,
                        w2v_layers: int, seed: int = 0):
    """Write the port's state dicts `sds` (CPU tensors, the six models of
    runtime/engine.py MODELS) into `d` in the reference's layout, as a real
    checkpoint directory holds them: gpt.pth with `text_head` (weight, bias),
    which no port module holds; s2mel.pth as {"net": {"cfm", "length_regulator",
    "gpt_layer"}} with DDP `module.` prefixes; the weight-normed layers as
    pairs; hf/w2v-bert-2.0/model.safetensors with `w2v_layers` layers (those
    past the port's copies of layer 0's tensors) and a `masked_spec_embed`
    drawn from `seed`; hf/semantic_codec.safetensors;
    hf/campplus_cn_common.bin; hf/bigvgan_generator.pt as {"generator": ...};
    wav2vec2bert_stats.pt {"mean", "std"}; feat1.pt (speaker bank) and
    feat2.pt (emotion bank). No config.yaml, bpe.model or Qwen directory.
    Returns {file: bytes written}."""
    import torch

    os.makedirs(os.path.join(d, "hf", "w2v-bert-2.0"), exist_ok=True)
    gpt = dict(sds["gpt"])
    gpt["text_head.weight"], gpt["text_head.bias"] = text_head
    s2mel = weight_norm_pairs("s2mel", sds["s2mel"])
    net = {m: {f"module.{k[len(m) + 1:]}": v for k, v in s2mel.items() if k.startswith(f"{m}.")}
           for m in ("cfm", "length_regulator", "gpt_layer")}
    w2v = dict(sds["w2vbert"])
    first = "encoder.layers.0."
    n = 1 + max(int(k.split(".")[2]) for k in w2v if k.startswith("encoder.layers."))
    for i in range(n, w2v_layers):
        w2v.update({f"encoder.layers.{i}.{k[len(first):]}": v
                    for k, v in sds["w2vbert"].items() if k.startswith(first)})
    hidden = sds["w2vbert"]["feature_projection.projection.weight"].shape[0]
    w2v["masked_spec_embed"] = torch.rand(hidden, generator=torch.Generator().manual_seed(seed))
    mean, std = semantic_stats
    files = {
        "gpt.pth": lambda p: torch.save(gpt, p),
        "s2mel.pth": lambda p: torch.save({"net": net}, p),
        "wav2vec2bert_stats.pt": lambda p: torch.save({"mean": mean, "std": std}, p),
        "feat1.pt": lambda p: torch.save(spk_matrix, p),
        "feat2.pt": lambda p: torch.save(emo_matrix, p),
        "hf/w2v-bert-2.0/model.safetensors": lambda p: save_safetensors(p, w2v),
        "hf/semantic_codec.safetensors": lambda p: save_safetensors(
            p, weight_norm_pairs("repcodec", sds["repcodec"])),
        "hf/campplus_cn_common.bin": lambda p: torch.save(sds["campplus"], p),
        "hf/bigvgan_generator.pt": lambda p: torch.save(
            {"generator": weight_norm_pairs("bigvgan", sds["bigvgan"])}, p),
    }
    written = {}
    for rel, write in files.items():
        path = os.path.join(d, rel)
        write(path)
        written[rel] = os.path.getsize(path)
    return written


def reference_dir(cfg, tmp: str):
    """Phase `reference_dir`: the full-width weights that serve.build drew
    before (random_params(cfg, seed=0) on the card), copied to the host and
    written into a checkpoint directory in the reference's layout
    (`write_reference_dir`), with a seeded text_head, the emotion phase's
    banks (EMO_SEED, unscaled: `emotion_banks` scales them) and the stats
    the engine took without a directory (mean 0, std 1), so every number
    after it stays comparable. Returns (directory, host copy of the
    state dicts, the aux tensors)."""
    import torch

    from indextts_tpu_torch.runtime.engine import random_params

    t0 = time.perf_counter()
    params = random_params(cfg, seed=0, device="cuda")
    host = {name: {k: v.cpu() for k, v in sd.items()} for name, sd in params.items()}
    del params
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(EMO_SEED)
    n = sum(cfg.emo_num)
    aux = {"emo_matrix": torch.randn((n, cfg.gpt.model_dim), generator=g, device="cuda").cpu(),
           "spk_matrix": torch.randn((n, 192), generator=g, device="cuda").cpu(),
           "mean": torch.zeros(cfg.w2vbert.hidden_size),
           "std": torch.ones(cfg.w2vbert.hidden_size)}
    head = torch.Generator().manual_seed(TEXT_HEAD_SEED)
    text_head = (0.02 * torch.randn((cfg.gpt.number_text_tokens + 1, cfg.gpt.model_dim),
                                    generator=head),
                 torch.zeros(cfg.gpt.number_text_tokens + 1))
    t1 = time.perf_counter()
    d = os.path.join(tmp, "checkpoints")
    free = shutil.disk_usage(tmp).free
    written = write_reference_dir(d, host, text_head, (aux["mean"], aux["std"]),
                                  aux["emo_matrix"], aux["spk_matrix"],
                                  cfg.w2vbert.num_hidden_layers)
    t2 = time.perf_counter()
    for rel, nbytes in written.items():
        print(f"reference_dir: {rel}: {nbytes / 1e9:.4f} GB")
    total = sum(written.values())
    print(f"reference_dir: {total / 1e9:.3f} GB in {len(written)} files written in "
          f"{t2 - t1:.1f} s ({total / 1e9 / (t2 - t1):.2f} GB/s; {free / 1e9:.0f} GB were "
          f"free) after {t1 - t0:.1f} s drawing the weights on the card and copying them "
          f"to the host; host peak resident {peak_rss_gib():.2f} GiB")
    return d, host, aux


def cache_phase(model_dir: str, cfg, wav_path: str, card: str) -> None:
    """Phase `cache_phase` (runtime/loader.py's converted-weights cache) on
    `reference_dir`'s full-width directory, float route: the free disk
    first; a cold load (the reference's files converted, then torch_cache/
    written) and a warm load (torch_cache/ read), each's read, write and
    build seconds and the cache's bytes; every tensor of every module of the
    warm engine, the banks and the stats equal to the cold engine's to the
    bit; one segment's greedy decode (the same seed) gives the same codes on
    both engines."""
    import torch

    from indextts_tpu_torch.frontend.tokenizer import byte_fallback_ids
    from indextts_tpu_torch.runtime import loader
    from indextts_tpu_torch.runtime.engine import MODELS, EmotionConditioning
    from indextts_tpu_torch.utils import audio as audio_utils

    t0 = time.perf_counter()
    free = shutil.disk_usage(model_dir).free
    print(f"[cache] {model_dir}: {free / 1e9:.1f} GB free before the cache is written")
    engines = {}
    for state in ("written", "read"):
        eng = loader.load_engine(model_dir, cfg=cfg, device="cuda")
        torch.cuda.synchronize()
        r = eng.load_report
        print(f"[cache] {'cold' if state == 'written' else 'warm'} load: torch_cache {r.cache}, "
              f"{r.cache_bytes / 1e9:.3f} GB; read {r.read_seconds:.2f} s"
              f"{' (the reference files converted)' if state == 'written' else ''}, cache "
              f"written in {r.write_seconds:.2f} s, engine built on the card in "
              f"{r.build_seconds:.2f} s; {card}")
        if r.cache != state:
            fail(f"[cache] the {'cold' if state == 'written' else 'warm'} load's cache is "
                 f"{r.cache!r}, not {state!r} ({free / 1e9:.1f} GB were free)")
        engines[state] = eng
    cold, warm = engines["written"], engines["read"]
    n = 0
    for name in MODELS:
        want, got = getattr(cold, name).state_dict(), getattr(warm, name).state_dict()
        if set(got) != set(want) or not all(torch.equal(got[k], v) for k, v in want.items()):
            fail(f"[cache] {name}: the warm engine's tensors are not the cold one's")
        n += len(want)
    for key in ("emo_matrix", "spk_matrix"):
        if not all(torch.equal(a, b) for a, b in zip(getattr(cold, key), getattr(warm, key))):
            fail(f"[cache] the warm engine's {key} is not the cold one's")
    if not (torch.equal(cold.semantic_mean, warm.semantic_mean)
            and torch.equal(cold.semantic_std, warm.semantic_std)):
        fail("[cache] the warm engine's semantic stats are not the cold one's")
    ids = byte_fallback_ids(request_text(0), cfg.gpt.number_text_tokens)
    codes = []
    for eng in (cold, warm):
        spk = eng.prepare_speaker(*audio_utils.load_wav(wav_path))
        codes.append(eng._decode_segment_codes(
            spk, EmotionConditioning(spk.spk_cond_emb, spk.cond_len), ids, seed=CACHE_SEED)[1])
    same = np.array_equal(codes[0], codes[1])
    print(f"[cache] warm against cold: {n} tensors of {len(MODELS)} models equal to the bit, "
          f"banks and stats equal; one segment's {np.asarray(codes[0]).shape[-1]} codes "
          f"(seed {CACHE_SEED}) equal: {same}; cache_phase done in "
          f"{time.perf_counter() - t0:.1f} s; {card}")
    if not same:
        fail("[cache] the warm engine's codes differ from the cold engine's")
    del cold, warm, engines, eng, spk
    gc.collect()
    torch.cuda.empty_cache()


def peak_rss_gib() -> float:
    """This process's peak resident memory (Linux: ru_maxrss in KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def check_loaded(engine, host, aux, label: str) -> None:
    """Every tensor of every module of the loaded engine against the host
    copy that was written: equal to the bit, or, where the checkpoint held
    a weight-norm pair, within 1e-6 of the tensor's largest |value| (the
    fold in float32); the banks and the stats to the bit."""
    import torch

    modules = {"gpt": engine.gpt, "s2mel": engine.s2mel, "bigvgan": engine.bigvgan,
               "repcodec": engine.repcodec, "campplus": engine.campplus,
               "w2vbert": engine.w2vbert}
    exact = folded = 0
    worst = 0.0
    for name, module in modules.items():
        got = module.state_dict()
        if set(got) != set(host[name]):
            fail(f"[{label}] {name}: the loaded keys differ from the written ones: "
                 f"{sorted(set(got) ^ set(host[name]))[:5]}")
        for key, want in host[name].items():
            want = want.to(got[key].device)
            if weight_normed(name, key):
                err = float((got[key] - want).abs().max()) / float(want.abs().max())
                worst = max(worst, err)
                folded += 1
                if not err <= 1e-6:
                    fail(f"[{label}] {name} {key}: folded weight {err:.3g} of its largest "
                         "|value| from the written one (tol 1e-6)")
            elif not torch.equal(got[key], want):
                fail(f"[{label}] {name} {key}: the loaded tensor is not the written one")
            else:
                exact += 1
    banks = {"emo_matrix": torch.cat(engine.emo_matrix), "spk_matrix": torch.cat(
        engine.spk_matrix), "mean": engine.semantic_mean, "std": engine.semantic_std}
    for key, got in banks.items():
        if not torch.equal(got.cpu(), aux[key]):
            fail(f"[{label}] the loaded {key} is not the written one")
    print(f"[{label}] loaded tensors against the written ones: {exact} equal to the bit, "
          f"{folded} folded from weight-norm pairs within {worst:.3g} of their largest "
          f"|value| (tol 1e-6); banks and stats equal")


def serve_full_width(wav_path: str, cfg, label: str, rise, stay, tmp: str, model_dir: str,
                     precompile: bool = False, written=None, decode_rounds: int = DECODE_ROUNDS,
                     *, card: str, server_test: bool = False):
    """Serve `cfg` with the port's server, its engine loaded from the
    checkpoint directory `model_dir` (no model may be filled with random
    weights; with `written`, the (host state dicts, aux) that
    `reference_dir` wrote, every loaded tensor is held to them:
    `check_loaded`), POST N_REQUESTS /tts requests, and check each answer.
    Every counter is set to 0 just before the requests and read just
    after: those in `rise` must have risen, those in `stay` must still be
    0. Each route has its own response cache, so no request
    is answered from another route's. With `precompile` the server's
    background precompile over the main path's envelope is waited for
    before the requests, which must then capture nothing new. The engine
    must be loaded from the directory's converted-weights cache
    (`cache_phase` wrote it). With `server_test`, the live-server smoke tool
    (indextts_tpu_torch/tools/run_server_test.py) runs against the server
    after the counted requests, in a process of its own. Returns the counts
    and the engine."""
    import torch

    from indextts_tpu_torch import serve
    from indextts_tpu_torch.runtime.engine import resolve_gemv

    os.environ["TARS_CACHE_DIR"] = os.path.join(tmp, f"cache-{label}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    os.environ["TARS_PRECOMPILE"] = "1" if precompile else "0"
    os.environ["TARS_PRECOMPILE_CODES"] = str(MAX_MEL_TOKENS)
    try:
        server, engine = serve.build(["--host", "127.0.0.1", "--port", str(port),
                                      "--reference-audio", wav_path, "--model-dir", model_dir],
                                     cfg=cfg)
    finally:
        os.environ["TARS_PRECOMPILE"] = "0"
    torch.cuda.synchronize()
    report = engine.load_report
    print(f"[{label}] full-width engine built and warmed up in {time.perf_counter() - t0:.1f} s "
          f"(peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    print(f"[{label}] loaded from {model_dir}: torch_cache {report.cache} "
          f"({report.cache_bytes / 1e9:.3f} GB) in {report.read_seconds:.2f} s (PR 16's "
          f"conversion from the reference's files: 3.09-5.66 s), engine built on the card in "
          f"{report.build_seconds:.2f} s; host peak resident {peak_rss_gib():.2f} GiB; models "
          f"filled with random weights: {report.filled or 'none'}; {card}")
    if report.filled:
        fail(f"[{label}] the checkpoint directory left {report.filled} to random weights")
    if report.cache != "read":
        fail(f"[{label}] the engine was not loaded from the converted-weights cache: "
             f"{report.cache}")
    if written is not None:
        check_loaded(engine, *written, label)
    if precompile:
        if server.precompiled is None:
            fail(f"[{label}] serve.build started no precompile under TARS_PRECOMPILE=1")
        jobs, seconds = server.precompiled.result(timeout=900)
        torch.cuda.synchronize()
        print(f"[{label}] precompile over {MAX_MEL_TOKENS} codes: {jobs} jobs in "
              f"{seconds:.1f} s (beside the warmup; {time.perf_counter() - t0:.1f} s from "
              f"the build's start); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; graphs (decode, latent, "
              f"s2mel, vocoder) {graph_counts(engine)}; keys latent "
              f"{list(engine.latent_runner.keys())}, s2mel {engine.s2mel_runner.shapes()}, "
              f"vocoder {list(engine.vocoder_runner.keys())}")
    graphs = graph_counts(engine)
    c = engine.cfg
    print(f"[{label}] config: GPT {c.gpt.layers}L x {c.gpt.model_dim} ({c.gpt.heads} heads), "
          f"DiT {c.s2mel.dit.depth}L x {c.s2mel.dit.hidden_dim}, BigVGAN "
          f"{c.vocoder.upsample_initial_channel} ch x{c.vocoder.total_upsample}, "
          f"w2v-BERT {c.w2vbert.tap_layer}/{c.w2vbert.num_hidden_layers} layers, "
          f"max_mel_tokens={c.runtime.max_mel_tokens}, gpt_quantize={c.runtime.gpt_quantize}, "
          f"head_quant={c.runtime.head_quant}, kv_quant={c.runtime.kv_quant}, "
          f"gpt_wbits={c.runtime.gpt_wbits}, gemv_impl={c.runtime.gemv_impl!r} "
          f"(kernels: {resolve_gemv(c, engine.device)})")
    thread = ServerThread(server)
    engine._mel_taps = []
    segments = []
    synthesize = engine.synthesize_segment

    def record_segment(*args, **kwargs):
        segments.append(synthesize(*args, **kwargs))
        return segments[-1]

    engine.synthesize_segment = record_segment
    counters = kernel_counters()
    for cnt in counters.values():
        cnt.launches = 0
    try:
        for i in range(N_REQUESTS):
            tok0, sec0 = engine.decoder.tokens, engine.decoder.seconds
            t0 = time.perf_counter()
            status, body = post_tts(port, {"text": request_text(i), "seed": i})
            wall = time.perf_counter() - t0
            if status != 200:
                fail(f"[{label}] request {i}: HTTP {status}: {body[:300]!r}")
            with wave.open(io.BytesIO(body)) as w:
                if (w.getnchannels(), w.getsampwidth()) != (1, 2):
                    fail(f"[{label}] request {i}: not a mono 16-bit WAV")
                sr, n = w.getframerate(), w.getnframes()
                pcm = np.frombuffer(w.readframes(n), dtype=np.int16)
            if n == 0 or int(np.abs(pcm.astype(np.int32)).max()) == 0:
                fail(f"[{label}] request {i}: silent or empty audio")
            toks = engine.decoder.tokens - tok0
            dsec = engine.decoder.seconds - sec0
            if toks == 0 or len(segments) != i + 1:
                fail(f"[{label}] request {i} was not synthesized (a cached answer?)")
            seg = segments[-1]
            print(f"[{label}] request {i}: wall_s={wall:.3f}")
            print(f"[{label}] request {i}: audio_s={n / sr:.3f} (sr {sr})")
            print(f"[{label}] request {i}: decode_tokens={toks} "
                  f"decode_tok_per_s={toks / dsec:.1f}")
            print(f"[{label}] request {i}: stages_s gpt_decode={seg.gpt_gen_time:.3f} "
                  f"gpt_latent={seg.gpt_forward_time:.3f} s2mel={seg.s2mel_time:.3f} "
                  f"bigvgan={seg.bigvgan_time:.3f}")
        launches = {name: cnt.launches for name, cnt in counters.items()}
        captured, mels = graph_counts(engine), list(engine._mel_taps)
        if server_test:
            run_server_test(port, tmp, label, card)
    finally:
        thread.stop()
    print(f"[{label}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if precompile and captured != graphs:
        fail(f"[{label}] the requests captured graphs the precompile had not: (decode, "
             f"latent, s2mel, vocoder) {graphs} before, {captured} after")
    if precompile:
        print(f"[{label}] the requests captured nothing new: graphs (decode, latent, s2mel, "
              f"vocoder) {graphs}")
    if len(mels) != N_REQUESTS or not all(np.isfinite(m).all() for m in mels):
        fail(f"[{label}] the requests' mels are missing or not finite")
    for name, n in launches.items():
        print(f"[{label}] {name}: launches={n} per_request={n / N_REQUESTS:.1f}")
        if name in rise and n == 0:
            fail(f"[{label}] {name} was never launched on the main path")
        if name in stay and n != 0:
            fail(f"[{label}] {name} was launched {n} times; it has no place on this path")
    keyed_prefill_gate(engine, wav_path, label)
    decode_turns(engine, wav_path, label, decode_rounds)
    return launches, engine


def run_server_test(port: int, tmp: str, label: str, card: str) -> None:
    """The live-server smoke tool against the server on `port`, from a
    directory of its own (it writes server_test.wav and .pcm there):
    healthz, readyz, a blocking WAV and a streamed PCM; fails unless it
    exits 0."""
    d = os.path.join(tmp, f"server_test-{label}")
    os.makedirs(d)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "indextts_tpu_torch.tools.run_server_test",
                          "--url", f"http://127.0.0.1:{port}"], cwd=d, env=env,
                         capture_output=True, text=True, timeout=300)
    for line in (out.stdout + out.stderr).splitlines():
        print(f"[{label}] run_server_test: {line}")
    print(f"[{label}] run_server_test exit {out.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; {card}")
    if out.returncode != 0:
        fail(f"[{label}] run_server_test exited {out.returncode}")


def keyed_prefill_errors(dec, conds, ids, pos, valid, prefix=None):
    """The keyed prefill (the prefix's KV, by default the conditioning
    prefix's from `cond_prefill`, the rest of the prompt's tail prefilled
    on top of it) against the monolithic one on the same prompt: the
    largest difference of the last logits and of the float KV of the
    prompt's S slots, each relative to the monolithic one's largest
    |value|. The KV is compared before any int8 quantization (a copy of the
    decoder with a float cache), as the prefill makes it."""
    import torch

    flat = copy.copy(dec)
    flat.kv_int8 = False
    with torch.inference_mode():
        lw, kv_w, _ = flat._prompt_prefill(conds, ids, pos, valid)
        lk, kv_k, _ = flat._prompt_prefill(conds, ids, pos, valid,
                                           flat.cond_prefill(conds) if prefix is None else prefix)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    return rel(lk, lw), max(rel(a, b) for a, b in zip(kv_k, kv_w))


def keyed_prefill_gate(engine, wav_path: str, label: str):
    """The keyed route's gate on the card: on request 0's first segment, its
    prefill's first-step logits and KV against the monolithic prefill's,
    within KEYED_TOL (float 1e-3, W8/W4 1e-2, relative). How many greedy
    codes of the two routes agree (MAX_MEL_TOKENS at most) is printed, not
    gated: the chunked tail sums in another order, which may flip a code at
    a near-tie of the random weights' logits."""
    import torch

    from indextts_tpu_torch.runtime.engine import EmotionConditioning
    from indextts_tpu_torch.serve import fallback_segments
    from indextts_tpu_torch.utils import audio as audio_utils

    c, dec = engine.cfg, engine.decoder
    if not dec.supports_cond_kv:
        fail(f"[{label}] the served decoder takes no keyed route (attn_impl "
             f"{c.runtime.attn_impl!r})")
    spk = engine.prepare_speaker(*audio_utils.load_wav(wav_path), cache_key=wav_path)
    emo = EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
    text = fallback_segments(request_text(0), c.gpt.number_text_tokens,
                             c.runtime.max_text_tokens_per_segment, c.gpt.max_text_tokens)[0]
    _, conds = engine.segment_conds(spk, emo)
    arrays = [engine._tensor(a) for a in dec.build_text_prompt_arrays(
        text[None], np.asarray([len(text)]), len(text))]
    logit_err, kv_err = keyed_prefill_errors(dec, conds, *arrays)
    tol = KEYED_TOL[c.runtime.gpt_quantize]
    print(f"[{label}] keyed prefill against the monolithic one (S={arrays[0].shape[1] + 34}): "
          f"logits max rel err {logit_err:.3g}, KV max rel err {kv_err:.3g} (tol {tol:g})")
    if not (logit_err <= tol and kv_err <= tol):
        fail(f"[{label}] the keyed prefill disagrees with the monolithic one")
    prefix = dec.cond_prefill(conds)
    torch.cuda.synchronize()
    rows = [engine._generate_codes(conds, text, kv, seed=DECODE_SEED, do_sample=False)
            for kv in (prefix, None)]
    same = next((i for i, (a, b) in enumerate(zip(*rows)) if a != b), min(map(len, rows)))
    print(f"[{label}] greedy codes, keyed and monolithic prefill: the first {same} of "
          f"{len(rows[0])} / {len(rows[1])} agree")


def prefix_phase(engine, wav_path: str, label: str, card: str) -> None:
    """Text-prefix KV reuse (runtime/engine.py `_lookup_text_prefix`) on the
    served engine, text_prefix_reuse turned on for the phase: two keyed
    greedy requests whose texts share their first PREFIX_SHARED ids (a miss
    that caches the 64-id grid prefix, then a hit on it), each with its
    K1/K4 launches (counters set to 0 just before it, read just after) and
    the tail prefilled on top of the prefix (the hit: [text[64:]][stop]
    [start_mel], its length against the whole prompt's); the cache's
    entries and MiB; the two texts again with the flag off (the
    conditioning prefix only; how many greedy codes agree is printed, not
    gated: the chunked tail sums in another order). On the hit's prompt,
    its last logits and float KV against the monolithic prefill's, within
    KEYED_TOL; and the prompt prefill's ms monolithic, keyed (conditioning
    prefix) and on the text prefix, PREFIX_ROUNDS rounds in turns, each
    way as device time (`cuda_ms`: replays of PREFIX_ITERS captured calls)
    and eagerly (CUDA events around PREFIX_ITERS eager calls, so the host's
    launches are in it, as in a request), beside text_prefix_prefill's
    eager ms (a miss's extra work). Last, end to end (`prefix_e2e_turns`):
    the second text's request without reuse, on a miss and on a hit,
    PREFIX_E2E_ROUNDS rounds in turns."""
    import torch

    from indextts_tpu_torch.runtime.engine import EmotionConditioning
    from indextts_tpu_torch.serve import fallback_segments
    from indextts_tpu_torch.utils import audio as audio_utils

    t_phase = time.perf_counter()
    c, dec = engine.cfg, engine.decoder
    if not dec.supports_cond_kv:
        fail(f"[{label}] the served decoder reuses no prefix (attn_impl "
             f"{c.runtime.attn_impl!r})")
    texts = [fallback_segments(PREFIX_TEXT + tail, c.gpt.number_text_tokens,
                               c.runtime.max_text_tokens_per_segment,
                               c.gpt.max_text_tokens) for tail in PREFIX_TAILS]
    if any(len(segs) != 1 for segs in texts):
        fail(f"[{label}] a prefix-phase text is more than one segment")
    ids = [segs[0] for segs in texts]
    g, shared = engine.TEXT_PREFIX_GRAN, len(PREFIX_TEXT)
    m = shared // g * g
    if not (m >= 64 and len(ids[0]) // g * g == m and len(ids[1]) // g * g > m):
        fail(f"[{label}] the prefix-phase texts ({list(map(len, ids))} ids) do not give a "
             f"miss at m={m}, then a hit")
    attn = "K4 ragged_decode_attention_q8" if dec.kv_int8 else "K1 ragged_decode_attention"
    counters = kernel_counters()
    codes, tails = [], []
    finish, with_past = engine._finish_from_codes, engine.gpt.gpt_prefill_with_past

    def record(spk, emovec, text_ids, row, seed, t_gen):
        codes.append(np.asarray(row).copy())
        return finish(spk, emovec, text_ids, row, seed, t_gen)

    def tail_spy(tail, mask, past):
        tails.append((past[0].shape[3], tail.shape[1]))
        return with_past(tail, mask, past)

    cfg0 = engine.cfg
    engine._finish_from_codes, engine.gpt.gpt_prefill_with_past = record, tail_spy
    engine._text_prefix_cache.clear()
    try:
        for reuse in (True, False):
            engine.cfg = dataclasses.replace(cfg0, runtime=dataclasses.replace(
                cfg0.runtime, text_prefix_reuse=reuse))
            for i, text in enumerate(ids):
                for cnt in counters.values():
                    cnt.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = engine.infer(wav_path, [text], seed=PREFIX_SEED, do_sample=False,
                                   num_beams=1)
                wall = time.perf_counter() - t0
                wav = np.asarray(out["audio"])
                if not (wav.size and np.isfinite(wav).all() and np.abs(wav).max() > 0):
                    fail(f"[{label}] prefix request {i} (reuse {reuse}): empty, silent or "
                         "not finite")
                launches = {k: n for k, n in ((k, c.launches) for k, c in counters.items())
                            if n}
                past, tail = tails[-1]
                S = past + tail
                stats = out["stats"][0]
                print(f"[{label} prefix] request {i} ({len(text)} ids), text_prefix_reuse="
                      f"{reuse}: wall_s={wall:.3f} gpt_decode_s={stats.gpt_gen_time:.3f} codes="
                      f"{len(codes[-1])}; prefill on top of {past} positions: a tail of {tail} "
                      f"of the prompt's {S}; launches {json.dumps(launches)}")
                if not launches.get(attn):
                    fail(f"[{label}] {attn} was not launched by prefix request {i}")
                want_past = P_COND + 1 + m if reuse else P_COND
                if past != want_past or tail != S - want_past:
                    fail(f"[{label}] prefix request {i} (reuse {reuse}) prefilled {tail} on "
                         f"top of {past}, not {S - want_past} on top of {want_past}")
                if reuse:
                    entries = engine._text_prefix_cache
                    mib = sum(t.numel() * t.element_size() for kv, _ in entries.values()
                              for t in kv) / 2**20
                    print(f"[{label} prefix] the prefix cache after request {i} ("
                          f"{'miss' if i == 0 else 'hit'}): {len(entries)} entries, "
                          f"m={[k[1] for k in entries]}, {mib:.2f} MiB")
                    if [k[1] for k in entries] != [m]:
                        fail(f"[{label}] the prefix cache holds m={[k[1] for k in entries]}, "
                             f"not [{m}]")
    finally:
        engine.cfg = cfg0
        engine.__dict__.pop("_finish_from_codes", None)
        engine.gpt.__dict__.pop("gpt_prefill_with_past", None)
        engine._text_prefix_cache.clear()
    for i in range(len(ids)):
        a, b = codes[i], codes[i + len(ids)]
        same = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        print(f"[{label} prefix] request {i}: greedy codes with and without text-prefix "
              f"reuse (seed {PREFIX_SEED}): the first {same} of {len(a)} / {len(b)} agree")

    spk = engine.prepare_speaker(*audio_utils.load_wav(wav_path), cache_key=wav_path)
    _, conds = engine.segment_conds(spk, EmotionConditioning(spk.spk_cond_emb, spk.cond_len))
    text = ids[1]
    with torch.inference_mode():
        text_kv = dec.text_prefix_prefill(conds, text[:m])
        cond_kv = dec.cond_prefill(conds)
    left, right = ([engine._tensor(a) for a in dec.build_text_prompt_arrays(
        text[None], np.asarray([len(text)]), len(text), align)] for align in ("left", "right"))
    logit_err, kv_err = keyed_prefill_errors(dec, conds, *left, text_kv)
    tol = KEYED_TOL[c.runtime.gpt_quantize]
    print(f"[{label} prefix] the hit's prefill against the monolithic one (m={m}, "
          f"S={P_COND + left[0].shape[1] + 1}): logits max rel err {logit_err:.3g}, KV max rel "
          f"err {kv_err:.3g} (tol {tol:g})")
    if not (logit_err <= tol and kv_err <= tol):
        fail(f"[{label}] the text-prefix prefill disagrees with the monolithic one")
    ways = {"monolithic": lambda: dec._prompt_prefill(conds, *right),
            "keyed": lambda: dec._prompt_prefill(conds, *right, cond_kv),
            "text-prefix hit": lambda: dec._prompt_prefill(conds, *left, text_kv)}
    times = {(k, how): [] for k in ways for how in ("device", "eager")}
    with torch.inference_mode():
        for r in range(PREFIX_ROUNDS):
            for k in (list(ways) if r % 2 == 0 else list(ways)[::-1]):
                times[k, "device"].append(cuda_ms(ways[k], iters=PREFIX_ITERS, replays=2))
                times[k, "eager"].append(events_ms(ways[k], PREFIX_ITERS))
        # eager only: its ids go to the card from the host
        miss_ms = events_ms(lambda: dec.text_prefix_prefill(conds, text[:m]), PREFIX_ITERS)
    for how in ("device", "eager"):
        print(f"[{label} prefix] prompt prefill ms, {how}, in turns ({PREFIX_ITERS} calls a "
              f"reading): " + "; ".join(f"{k} " + ", ".join(f"{x:.4f}" for x in times[k, how])
                                         for k in ways)
              + (f"; text_prefix_prefill of {m} ids {miss_ms:.4f}" if how == "eager" else "")
              + f" ({card})")
    prefix_e2e_turns(engine, wav_path, label, card, text)
    print(f"[{label}] the prefix phase took {time.perf_counter() - t_phase:.1f} s")


def prefix_e2e_turns(engine, wav_path: str, label: str, card: str, text) -> None:
    """One keyed greedy request of `text` three ways, PREFIX_E2E_ROUNDS
    rounds in turns (the order reversed every other round): "off"
    (text_prefix_reuse False: the conditioning prefix's KV), "miss" (reuse
    on, the prefix cache emptied first: text_prefix_prefill of the longest
    grid prefix, then the tail on top of it) and "hit" (reuse on, the
    cache holding only the miss's entry). Each request's wall seconds, its
    gpt_decode seconds and its seconds to the prompt's prefill (from the
    request's start until `GPTDecoder.prefill` returns, the card
    synchronized there: the miss's extra prefill is in it), every reading
    and the medians printed, with the hit's saving and the miss's cost
    against "off". The ways' code counts are printed, not gated (the
    chunked tail sums in another order)."""
    import torch

    dec, cfg0 = engine.decoder, engine.cfg
    ways = ("off", "miss", "hit")
    got = {w: {"wall": [], "gpt": [], "prefill": []} for w in ways}
    codes, saved, marks, t_req = {}, {}, [], [0.0]
    prefill = dec.prefill

    def prefill_spy(*a, **k):
        st = prefill(*a, **k)
        torch.cuda.synchronize()
        marks.append(time.perf_counter() - t_req[0])
        return st

    dec.prefill = prefill_spy
    try:
        for r in range(PREFIX_E2E_ROUNDS):
            for way in (ways if r % 2 == 0 else ways[::-1]):
                engine.cfg = dataclasses.replace(cfg0, runtime=dataclasses.replace(
                    cfg0.runtime, text_prefix_reuse=way != "off"))
                engine._text_prefix_cache.clear()
                if way == "hit":
                    engine._text_prefix_cache.update(saved)
                torch.cuda.synchronize()
                marks.clear()
                t_req[0] = time.perf_counter()
                out = engine.infer(wav_path, [text], seed=PREFIX_SEED, do_sample=False,
                                   num_beams=1)
                wall = time.perf_counter() - t_req[0]
                if way == "miss" and not saved:
                    saved.update(engine._text_prefix_cache)
                want = {"off": 0, "miss": 1, "hit": 1}[way]
                if len(marks) != 1 or len(engine._text_prefix_cache) != want or (
                        way == "hit" and engine._text_prefix_cache != saved):
                    fail(f"[{label}] prefix e2e round {r} ({way}): {len(marks)} prefills, "
                         f"{len(engine._text_prefix_cache)} cache entries")
                stats = out["stats"][0]
                codes.setdefault(way, stats.codes_len)
                got[way]["wall"].append(wall)
                got[way]["gpt"].append(stats.gpt_gen_time)
                got[way]["prefill"].append(marks[0])
    finally:
        engine.cfg = cfg0
        dec.__dict__.pop("prefill", None)
        engine._text_prefix_cache.clear()
    med = {w: {k: statistics.median(v) for k, v in got[w].items()} for w in ways}
    for w in ways:
        print(f"[{label} prefix e2e] {w} ({len(text)} ids, {codes[w]} codes), "
              f"{PREFIX_E2E_ROUNDS} rounds in turns: " + "; ".join(
                  f"{k}_s " + ", ".join(f"{x:.4f}" for x in got[w][k])
                  + f" (median {med[w][k]:.4f})" for k in ("wall", "gpt", "prefill"))
              + f" ({card})")
    print(f"[{label} prefix e2e] medians against off, ms: " + "; ".join(
        f"{w} " + ", ".join(f"{k} {1e3 * (med[w][k] - med['off'][k]):+.2f}"
                            for k in ("prefill", "gpt", "wall")) for w in ("hit", "miss"))
          + f" ({card})")


def native_dsp_phase(engine, wav_path: str, card: str) -> None:
    """The native host DSP (utils/native.py over csrc/dsp.cpp, built with
    g++ on first use), each of its three routes against the numpy/scipy one
    on the host, NATIVE_ROUNDS rounds of 10 calls in turns (the medians
    and every reading printed): the fbank of the 3-s prompt at 16 kHz
    (within 1e-4), `pcm16_bytes` of the prompt at 22.05 kHz as a streamed
    chunk (bit-equal) and `resample` of the prompt to 16 and 22.05 kHz as
    prepare_speaker does (within 1e-6 of scipy), each through the call
    site's dispatch with INDEXTTS_NATIVE_DSP set for the route; then which
    route the engine's features took (INDEXTTS_NATIVE_DSP as the script
    found it, unset: native), counted over one unkeyed prepare_speaker."""
    from indextts_tpu_torch.frontend import features as feat
    from indextts_tpu_torch.utils import audio as audio_utils
    from indextts_tpu_torch.utils import native

    t0 = time.perf_counter()
    native.lib()
    load_s = time.perf_counter() - t0
    audio, sr = audio_utils.load_wav(wav_path)
    wav = audio_utils.resample(audio, sr, 16000) * 2 ** 15
    chunk = audio_utils.resample(audio, sr, 22050)
    env0 = os.environ.get("INDEXTTS_NATIVE_DSP")
    # each operation: (its call, the switch's value for native, for numpy)
    ops = {"fbank": (lambda: feat._fbank_dispatch(wav), "1", "0"),
           "pcm16_bytes": (lambda: audio_utils.pcm16_bytes(chunk), "1", "0"),
           "resample": (lambda: [audio_utils.resample(audio, sr, r) for r in (16000, 22050)],
                        "all", "0")}
    per = {(op, route): [] for op in ops for route in ("native", "numpy")}
    out = {}
    try:
        for r in range(NATIVE_ROUNDS):
            for op, (fn, on, off) in ops.items():
                for route, value in ((("native", on), ("numpy", off)) if r % 2 == 0
                                     else (("numpy", off), ("native", on))):
                    os.environ["INDEXTTS_NATIVE_DSP"] = value
                    out[op, route] = fn()
                    t = time.perf_counter()
                    for _ in range(10):
                        fn()
                    per[op, route].append((time.perf_counter() - t) / 10 * 1e3)
    finally:
        if env0 is None:
            os.environ.pop("INDEXTTS_NATIVE_DSP", None)
        else:
            os.environ["INDEXTTS_NATIVE_DSP"] = env0
    got, want = native.kaldi_fbank(wav), feat.kaldi_fbank_core(wav)
    errs = {"fbank": float(np.abs(got - want).max()),
            "pcm16_bytes": float(np.abs(
                np.frombuffer(out["pcm16_bytes", "native"], np.int16).astype(np.int32)
                - np.frombuffer(out["pcm16_bytes", "numpy"], np.int16)).max()),
            "resample": max(float(np.abs(a - b).max()) for a, b in
                            zip(out["resample", "native"], out["resample", "numpy"]))}
    print(f"native DSP: loaded in {load_s:.2f} s ({native.so_path().name}); the "
          f"{PROMPT_SECONDS}-s prompt at {sr} Hz ({got.shape[0]} fbank frames at 16 kHz, "
          f"{len(chunk)} samples at 22.05 kHz), host ms a call, {NATIVE_ROUNDS} rounds of 10 "
          f"calls in turns ({card}):")
    for op in ops:
        med = {route: statistics.median(per[op, route]) for route in ("native", "numpy")}
        print(f"native DSP: {op}: native {med['native']:.4f} ms ("
              + ", ".join(f"{x:.4f}" for x in per[op, "native"]) + f"), numpy "
              f"{med['numpy']:.4f} ms (" + ", ".join(f"{x:.4f}" for x in per[op, "numpy"])
              + f"), native/numpy {med['native'] / med['numpy']:.3f}; max |diff| "
              f"{errs[op]:.3g}")
    if got.shape != want.shape or not errs["fbank"] <= 1e-4:
        fail(f"native fbank {got.shape} differs from numpy's {want.shape} by "
             f"{errs['fbank']:.3g}")
    if errs["pcm16_bytes"] != 0 or not errs["resample"] <= 1e-6:
        fail(f"native PCM16 or resample differs from numpy/scipy: {errs}")
    calls = []
    fbank = native.kaldi_fbank
    native.kaldi_fbank = lambda *a, **k: calls.append(1) or fbank(*a, **k)
    try:
        engine.prepare_speaker(audio, sr)
    finally:
        native.kaldi_fbank = fbank
    route = os.environ.get("INDEXTTS_NATIVE_DSP", "unset")
    print(f"native DSP: INDEXTTS_NATIVE_DSP={route}; the engine's prepare_speaker took the "
          f"native fbank {len(calls)} times (w2v-BERT features, CAMPPlus)")
    if len(calls) != 2:
        fail(f"the engine's features took the native fbank {len(calls)} times, not 2")


def dilation_phase(card: str) -> None:
    """A full-width BigVGAN whose resblocks differ in their dilations
    (DILATIONS; random weights from DILATION_SEED, conv_post scaled by 1e-3
    to keep the waveform off the clip) over a mel of the main path's 640
    frames: it runs each resblock alone. K2's launches counted over one call
    (6 stages x 9 dilations x 2 + 1 = 109), the waveform within 1e-3 of its
    peak of the same call with K2's plain version, and device ms (CUDA
    events over replays) beside the release config's lockstep call on
    weights of the same seed."""
    import torch

    from indextts_tpu_torch.config import BigVGANConfig
    from indextts_tpu_torch.models import bigvgan as bv
    from indextts_tpu_torch.ops import snake

    def model(dilations):
        with torch.random.fork_rng(devices=[0]):
            torch.manual_seed(DILATION_SEED)
            m = bv.BigVGAN(BigVGANConfig(resblock_dilation_sizes=dilations))
        m.conv_post.weight.data.mul_(1e-3)
        return m.to("cuda").eval().requires_grad_(False)

    t0 = time.perf_counter()
    voc = model(DILATIONS)
    if voc.lockstep:
        fail("a BigVGAN of differing dilations runs in lockstep")
    g = torch.Generator(device="cuda").manual_seed(DILATION_SEED)
    mel = torch.randn((1, 80, 640), device="cuda", generator=g) - 5.0
    want_launches = len(voc.cfg.upsample_rates) * sum(map(len, DILATIONS)) * 2 + 1
    with torch.inference_mode():
        snake.counter.launches = 0
        got = voc(mel)
        torch.cuda.synchronize()
        launches = snake.counter.launches
        bv.anti_alias_snake = snake.anti_alias_snake_plain
        try:
            want = voc(mel)
        finally:
            bv.anti_alias_snake = snake.anti_alias_snake
        peak = float(want.abs().max())
        err = float((got - want).abs().max())
        ms = cuda_ms(lambda: voc(mel), iters=2, replays=3)
        release = model(BigVGANConfig().resblock_dilation_sizes)
        release_ms = cuda_ms(lambda: release(mel), iters=2, replays=3)
    print(f"differing dilations {DILATIONS}: one vocoder call at 640 frames, K2 launches "
          f"{launches} (want {want_launches}), {ms:.3f} device ms (the release config in "
          f"lockstep {release_ms:.3f}); against plain K2: max |err| {err:.3g}, peak {peak:.3g}, "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    if launches != want_launches:
        fail(f"the differing-dilation vocoder launched K2 {launches} times, not {want_launches}")
    if not (torch.isfinite(got).all() and 0 < peak < 1.0 and err <= 1e-3 * peak):
        fail("the differing-dilation vocoder disagrees with its plain-K2 version")


# ---------------------------------------------------------------------------
# phase v1_phase: the IndexTTS v1 family at full width
# ---------------------------------------------------------------------------

V1_SEED = 47  # the v1 weights' seed (random_params_v1)
V1_TEXTS = ("The first segment.",
            "A second segment of the request, a little longer than the first one.",
            "The third segment, the middle one of the three in length.")
V1_LONG_TEXT = "A fourth segment joins the longest vocoder call of the v1 engine."
V1_LONGEST = 600  # the v1 engine's default max_mel_tokens
V1_EAGER_CODES = 128  # greedy codes decoded captured and eagerly, on each route


def v1_snake_shapes(voc, codes: int):
    """The (C, T) of every K2 launch of one BigVGAN v1 call over `codes`
    GPT latents (upsampled 4x first), its resblocks in lockstep: 37."""
    G = len(voc.resblock_kernel_sizes)
    ch, T = voc.upsample_initial_channel, 4 * codes
    shapes = []
    for u in voc.upsample_rates:
        ch //= 2
        T *= u
        shapes += [(G * ch, T)] * (2 * len(voc.resblock_dilation_sizes[0]))
    return shapes + [(ch, T)]


def v1_prompt(engine, texts):
    """The v1 decoder's prompt arrays for `texts` (right-aligned at the
    longest, as infer_fast builds a bucket) and each row's pad hole after
    the 32 conditioning positions."""
    from indextts_tpu_torch.frontend.tokenizer import byte_fallback_ids

    g = engine.gpt_cfg
    ids = [byte_fallback_ids(t, g.number_text_tokens, 200) for t in texts]
    L = max(map(len, ids))
    text = np.zeros((len(ids), L), np.int64)
    for b, row in enumerate(ids):
        text[b, :len(row)] = row
    lens = np.array([len(r) for r in ids])
    arrays = engine.decoder.build_text_prompt_arrays(text, lens, L)
    c0 = g.condition_num_latent
    return ([engine._tensor(a) for a in arrays], ids, c0 + L + 2 + 1,
            ([c0] * len(ids), [c0 + L - n for n in lens]))


def v1_request(engine, wav_path: str, label: str, card: str) -> dict:
    """infer_fast of the three V1_TEXTS (one bucket of 3 rows) at
    MAX_MEL_TOKENS, seed 0, twice (the first captures the decode step): audio finite at 24 kHz, codes inside the vocabulary; every
    kernel count set to 0 just before the last request and read just
    after. Prints wall, decode tokens/s and stage seconds of each, and
    ECAPA's device ms over the 3 rows' reference mel. Returns the counts."""
    import torch

    from indextts_tpu_torch.frontend.tokenizer import byte_fallback_ids
    from indextts_tpu_torch.utils import audio as audio_utils

    g = engine.gpt_cfg
    segs = [np.asarray(byte_fallback_ids(t, g.number_text_tokens, 200)) for t in V1_TEXTS]
    seen = []
    gen = engine.decoder.generate

    def spy(*a, **k):
        res = gen(*a, **k)
        seen.append(res.codes.cpu().numpy())
        return res

    engine.decoder.generate = spy
    counters = kernel_counters()
    try:
        for r in range(2):
            if r == 1:
                for c in counters.values():
                    c.launches = 0
            tok0 = engine.decoder.tokens
            t0 = time.perf_counter()
            out = engine.infer_fast(wav_path, segs, max_mel_tokens=MAX_MEL_TOKENS, seed=0)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            st = engine.last_stats
            toks = engine.decoder.tokens - tok0
            print(f"v1 {label} request {r + 1} ({'captures' if r == 0 else 'replays'} the "
                  f"decode step): wall {wall:.3f} s, {out['duration_sec']:.3f} s of audio, "
                  f"decode {toks} tokens over 3 rows, {toks / st['decode']:.1f} tok/s; stages "
                  f"(s) " + ", ".join(f"{k} {v:.4f}" for k, v in st.items()) + f" ({card})")
    finally:
        engine.decoder.generate = gen
    launches = {name: c.launches for name, c in counters.items()}
    audio = out["audio"]
    codes = seen[-1]
    if not (out["sampling_rate"] == 24000 and audio.size and np.isfinite(audio).all()):
        fail(f"v1 {label}: the audio is not finite 24 kHz audio")
    if not (codes.shape[0] == 3 and 0 <= codes.min() and codes.max() < g.number_mel_codes):
        fail(f"v1 {label}: codes outside the vocabulary or not one bucket of 3 rows")
    ref = engine.prepare_conditioning(*audio_utils.load_wav(wav_path), key=wav_path)[0]
    ref3 = ref.expand(3, -1, -1)
    with torch.inference_mode():
        ecapa = events_ms(lambda: engine.bigvgan.speaker_embedding(ref3), iters=5)
    print(f"v1 {label}: launches a request " + json.dumps({k: n for k, n in launches.items()
                                                           if n}) +
          f"; ECAPA {ecapa:.3f} device ms over 3 rows of {ref.shape[1]} frames; peak "
          f"|audio| {np.abs(audio).max():.4f} ({card})")
    return launches


def v1_decode_turns(engine, wav_path: str, label: str) -> None:
    """Greedy decode of the three V1_TEXTS, V1_EAGER_CODES codes, captured
    and eager: the same codes."""
    import torch

    from indextts_tpu_torch.utils import audio as audio_utils

    arrays = v1_prompt(engine, V1_TEXTS)[0]
    mel, n = engine.prepare_conditioning(*audio_utils.load_wav(wav_path), key=wav_path)
    with torch.inference_mode():
        conds = engine.gpt.get_conditioning(mel, engine._tensor([n])).expand(3, -1, -1)
        runs = {}
        for eager in (False, True):
            t0 = time.perf_counter()
            runs[eager] = engine.decoder.generate(conds.contiguous(), *arrays, 0,
                                                  max_new=V1_EAGER_CODES, do_sample=False,
                                                  eager=eager)
            torch.cuda.synchronize()
            print(f"v1 {label} greedy decode {'eager' if eager else 'captured'}: "
                  f"{V1_EAGER_CODES} codes x 3 rows in {time.perf_counter() - t0:.3f} s")
    same = torch.equal(runs[True].codes, runs[False].codes)
    print(f"v1 {label}: captured and eager greedy codes equal: {same}")
    if not same:
        fail(f"v1 {label}: captured and eager greedy decode differ")


def v1_attention_cases(engine):
    """K1's (and K4's) cases at the v1 path's shapes: a bucket of the three
    V1_TEXTS (B=3, a 32-position conditioning, each row its own pad hole)
    at its first and last step of MAX_MEL_TOKENS, and the longest call's 4
    rows at the last of V1_LONGEST."""
    from indextts_tpu_torch.runtime.decode import cache_cap

    _, _, S, holes = v1_prompt(engine, V1_TEXTS)
    _, _, S4, holes4 = v1_prompt(engine, V1_TEXTS + (V1_LONG_TEXT,))
    cap = cache_cap(S, MAX_MEL_TOKENS)
    return [("v1 B=3 first step", 3, cap, [S + 1] * 3, *holes),
            ("v1 B=3 last step", 3, cap, [S + MAX_MEL_TOKENS] * 3, *holes),
            ("v1 B=4 longest", 4, cache_cap(S4, V1_LONGEST), [S4 + V1_LONGEST] * 4, *holes4)]


def v1_kernel_checks(engine, heads: int) -> None:
    """K1 at the v1 decode's shapes and K2 at every shape of a v1 vocoder
    call at MAX_MEL_TOKENS codes (3 rows) and at V1_LONGEST (4 rows),
    against their plain versions at phase 2's tolerances; K2's device ms
    over one row's vocoder call (`time_k2`)."""
    import torch

    from indextts_tpu_torch.ops import decode_attention as k1
    from indextts_tpu_torch.ops import snake as k2

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(V1_SEED)

    def make(B, c):
        q = torch.randn((B, heads, 64), generator=g, device=dev)
        return q, *(torch.randn((B, heads, c, 64), generator=g, device=dev) for _ in range(2))

    check_decode_cases("K1", k1.ragged_decode_attention, k1.ragged_decode_attention_plain,
                       v1_attention_cases(engine), make, 2e-5)
    tol = 2e-5
    for rows, codes in ((3, MAX_MEL_TOKENS), (4, V1_LONGEST)):
        for C, T in dict.fromkeys(v1_snake_shapes(engine.voc_cfg, codes)):
            x, a, b = k2_inputs(g, rows, C, T)
            err = (k2.anti_alias_snake(x, a, b, True)
                   - k2.anti_alias_snake_plain(x, a, b, True)).abs().max().item()
            print(f"K2 v1 {codes} codes: B={rows} C={C} T={T} max_abs_err={err:.3g} "
                  f"(tol {tol})")
            if not err <= tol:
                fail(f"K2 at the v1 shape B={rows} C={C} T={T} disagrees with its plain "
                     f"version: {err}")
            del x, a, b
    torch.cuda.empty_cache()
    seq = v1_snake_shapes(engine.voc_cfg, MAX_MEL_TOKENS)
    ms, _, b_ms, by = time_k2(seq, g, plain=False)
    print(f"K2 v1 vocoder call, one row of {MAX_MEL_TOKENS} codes ({len(seq)} launches, each "
          f"on its own input): kernel_ms={ms:.4f} bound_ms={b_ms:.4f} ({by})")
    torch.cuda.empty_cache()


def v1_q8_checks(engine, heads: int, d: int, vocab: int) -> None:
    """K4 at the v1 decode's shapes, K5 (c_attn, attn c_proj, the head) and
    K6 at its 3 rows, against their plain versions at phase 2's
    tolerances."""
    import torch

    from indextts_tpu_torch.models.gpt2 import quantize_kv
    from indextts_tpu_torch.ops import decode_attention as k4
    from indextts_tpu_torch.ops import gemv

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(V1_SEED + 1)

    def make(B, c):
        q = torch.randn((B, heads, 64), generator=g, device=dev)
        k8, ksc = quantize_kv(torch.randn((B, heads, c, 64), generator=g, device=dev))
        v8, vsc = quantize_kv(torch.randn((B, heads, c, 64), generator=g, device=dev))
        return q, k8, v8, ksc, vsc

    check_decode_cases("K4", k4.ragged_decode_attention_q8, k4.ragged_decode_attention_q8_plain,
                       v1_attention_cases(engine), make, 2e-5)
    fpad = -(-vocab // 128) * 128
    for label, call, plain, wd in (
            ("K5 c_attn", gemv.gemv_w8, gemv.gemv_w8_plain, lambda: q8_weight(g, d, 3 * d)),
            ("K5 attn c_proj", gemv.gemv_w8, gemv.gemv_w8_plain, lambda: q8_weight(g, d, d)),
            ("K5 head", gemv.gemv_w8, gemv.gemv_w8_plain, lambda: q8_weight(g, d, fpad)),
            ("K6", gemv.mlp_w8, gemv.mlp_w8_plain,
             lambda: q8_weight(g, d, 4 * d) + q8_weight(g, 4 * d, d))):
        xq, a = q8_row(g, 3, d)
        w = wd()
        got, want = call(xq, a, *w), plain(xq, a, *w)
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        print(f"{label} v1 3 rows: D={d} max_abs_err={err:.3g} of max|y| {scale:.3g} "
              f"(tol 1e-6 relative)")
        if not err <= 1e-6 * scale:
            fail(f"{label} at the v1 decode's 3 rows disagrees with its plain version: {err}")


def v1_vocoder_check(engine, wav_path: str, card: str) -> None:
    """The float route's vocoder call over 3 rows of MAX_MEL_TOKENS latents
    (the GPT's latent pass over the three V1_TEXTS and seeded codes) with
    K2 (37 launches) against the same call with K2's plain version: the
    waveform within 1e-3 of its peak; device ms of each."""
    import torch

    from indextts_tpu_torch.models import bigvgan as bv
    from indextts_tpu_torch.ops import snake
    from indextts_tpu_torch.utils import audio as audio_utils

    g = engine.gpt_cfg
    arrays, ids, _, _ = v1_prompt(engine, V1_TEXTS)
    mel, n = engine.prepare_conditioning(*audio_utils.load_wav(wav_path), key=wav_path)
    rng = np.random.default_rng(V1_SEED)
    codes = rng.integers(0, g.stop_mel_token - 1, (3, MAX_MEL_TOKENS))
    L = max(map(len, ids))
    text = np.zeros((3, L), np.int64)
    for b, row in enumerate(ids):
        text[b, :len(row)] = row
    ref = mel.expand(3, -1, -1)
    t = engine._tensor
    with torch.inference_mode():
        lat = engine.gpt.forward_latent(ref, t([n] * 3), t(text), t([len(r) for r in ids]),
                                        t(codes), t([MAX_MEL_TOKENS * g.mel_length_compression] * 3))
        snake.counter.launches = 0
        got = engine.bigvgan(lat, ref)
        torch.cuda.synchronize()
        launches = snake.counter.launches
        bv.anti_alias_snake = snake.anti_alias_snake_plain
        try:
            want = engine.bigvgan(lat, ref)
            plain_ms = events_ms(lambda: engine.bigvgan(lat, ref), iters=2)
        finally:
            bv.anti_alias_snake = snake.anti_alias_snake
        ms = events_ms(lambda: engine.bigvgan(lat, ref), iters=3)
    peak = float(want.abs().max())
    err = float((got - want).abs().max())
    sat = float((want.abs() > 0.99).float().mean())
    print(f"v1 vocoder call, 3 rows x {MAX_MEL_TOKENS} codes ({got.shape[1]} samples a row): "
          f"K2 launches {launches} (want 37), {ms:.3f} device ms (with plain K2 "
          f"{plain_ms:.3f}); against plain K2: max |err| {err:.3g}, peak {peak:.3g}, "
          f"{100 * sat:.2f} % of samples past 0.99 ({card})")
    if launches != 37:
        fail(f"the v1 vocoder launched K2 {launches} times, not 37")
    if not (torch.isfinite(got).all() and 0 < peak and err <= 1e-3 * peak):
        fail("the v1 vocoder call with K2 disagrees with the call with K2's plain version")


def v1_dvae(wav_path: str, card: str) -> None:
    """One DVAE.get_codebook_indices at full width (DVAEConfig()) on the
    prompt's v1 mel, its codebook at the latents' scale: each code the
    nearest entry, within 1e-4 of the nearest distance, by the CPU's
    distances from the same weights."""
    import torch

    from indextts_tpu_torch.config import MelConfig
    from indextts_tpu_torch.models.dvae import DVAE, DVAEConfig
    from indextts_tpu_torch.ops.mel import mel_spectrogram_v1
    from indextts_tpu_torch.utils import audio as audio_utils

    audio, sr = audio_utils.load_wav(wav_path)
    y = audio_utils.resample(audio, sr, 24000)
    mel = mel_spectrogram_v1(torch.as_tensor(y[None]), MelConfig(
        sample_rate=24000, n_fft=1024, hop_length=256, win_length=1024, n_mels=100))
    mel = mel.transpose(1, 2).contiguous()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(V1_SEED)
        m = DVAE(DVAEConfig()).eval().requires_grad_(False)
    with torch.no_grad():
        m.codebook.embed.mul_(float(m.encode_latents(mel).std()))
        z = m.encode_latents(mel).reshape(-1, m.cfg.codebook_dim)
        e = m.codebook.embed
        dist = (z * z).sum(1, keepdim=True) - 2.0 * z @ e + (e * e).sum(0)[None]
    m.to("cuda")
    with torch.inference_mode():
        t0 = time.perf_counter()
        ids = m.get_codebook_indices(mel.to("cuda"))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    ids = ids.cpu()
    picked = dist.gather(1, ids.reshape(-1, 1))[:, 0]
    best = dist.min(dim=1).values
    gap = float(((picked - best) / best.abs().clamp(min=1e-6)).max())
    same = float((ids.reshape(-1) == dist.argmin(1)).float().mean())
    print(f"v1 DVAE (DVAEConfig()) on the card: {tuple(mel.shape)} mel -> {tuple(ids.shape)} "
          f"codes, {len(set(ids.reshape(-1).tolist()))} distinct, {secs * 1e3:.2f} ms; "
          f"{100 * same:.1f} % equal to the CPU's argmin, the picks' distance at most "
          f"{gap:.3g} above the nearest, relative ({card})")
    # two stride-2 convolutions of kernel 3 and pad 1: ceil(ceil(T / 2) / 2) codes
    if not (ids.shape == (1, -(-(-(-mel.shape[1] // 2)) // 2)) and gap <= 1e-4):
        fail("the DVAE on the card picked a code that is not the nearest")


def v1_phase(card: str) -> dict:
    """IndexTTS v1 at full width on the card (GPT 24L x 1280 over a 100-bin
    mel, BigVGAN v1 with ECAPA), seeded random weights (random_params_v1),
    the float route then W8 (quantize_gpt, kv_quant, head_quant,
    gemv_impl "pallas"). Returns each route's launches a request."""
    import torch

    from indextts_tpu_torch.config import ConditionModuleConfig, GPTConfig
    from indextts_tpu_torch.models.bigvgan_v1 import BigVGANv1Config
    from indextts_tpu_torch.runtime.engine_v1 import IndexTTSV1Engine, random_params_v1

    t0 = time.perf_counter()
    gcfg = GPTConfig(condition_module=ConditionModuleConfig(input_size=100))
    voc = BigVGANv1Config()
    params = random_params_v1(gcfg, voc, seed=V1_SEED, device="cuda")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        wav_path = os.path.join(tmp, "speaker.wav")
        speaker_wav(wav_path)
        for label, kw in (("float", {}), ("W8", dict(quantize_gpt=True, kv_quant=True,
                                                     head_quant=True, gemv_impl="pallas"))):
            engine = IndexTTSV1Engine(gcfg, voc, params, device="cuda", **kw)
            launches[label] = v1_request(engine, wav_path, label, card)
            v1_decode_turns(engine, wav_path, label)
            if label == "float":
                v1_kernel_checks(engine, gcfg.heads)
                v1_vocoder_check(engine, wav_path, card)
            else:
                v1_q8_checks(engine, gcfg.heads, gcfg.model_dim, gcfg.number_mel_codes)
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        v1_dvae(wav_path, card)
    want = {"float": ("K1 ragged_decode_attention", "K2 anti_alias_snake"),
            "W8": ("K2 anti_alias_snake", "K4 ragged_decode_attention_q8", "K5 gemv_w8",
                   "K6 mlp_w8")}
    for label, names in want.items():
        if not all(launches[label][k] for k in names):
            fail(f"v1 {label}: a kernel of the route was not launched: {launches[label]}")
        if launches[label]["K2 anti_alias_snake"] != 37:
            fail(f"v1 {label}: K2 launched {launches[label]['K2 anti_alias_snake']} times a "
                 "request, not 37 (one vocoder call)")
    print(f"v1 launches a request (3 segments, one bucket): " + json.dumps(
        {label: {k: n for k, n in c.items() if n} for label, c in launches.items()}))
    print(f"phase v1_phase done in {time.perf_counter() - t0:.1f} s ({card})")
    return launches


def step_kernels(fn, pad: int = 64):
    """The device kernels of one fn() call, from torch.profiler after one
    warm-up call: {name: (count, device ms)}. A profiler run loses
    the records of the first few and of about the last 35 kernels launched
    eagerly inside it (seen on eager decode steps and on K6), so `pad` spin
    kernels come before fn() and after it, and are left out of the
    result."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def spin():
        for _ in range(pad):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spin()
        fn()
        spin()
    return {e.key: (e.count, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_time_total > 0 and "spin_kernel" not in e.key}


def rng_replay_kernels():
    """The device kernels PyTorch adds to a replay of a graph that draws
    from a registered generator (it writes the generator's seed and offset
    for the graph before each launch): one replay's kernels by name and
    count less one eager draw's."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.empty(30, device="cuda")
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        x.exponential_(generator=gen)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph, stream=stream):
        x.exponential_(generator=gen)
    with torch.cuda.stream(stream):
        eager = step_kernels(lambda: x.exponential_(generator=gen))
        replay = step_kernels(graph.replay)
    extra = {k: n - eager.get(k, (0, 0))[0] for k, (n, _) in replay.items()}
    return {k: n for k, n in extra.items() if n}


# a graph may run a device-to-device copy node as the driver's kernel
# memcpy32_post where the eager step's copy is a copy-engine memcpy (seen
# on the batched step's logits copy)
GRAPH_COPY = {"memcpy32_post": "Memcpy DtoD (Device -> Device)"}


def replay_against_eager(eager_fn, graph, sampling: bool, label: str, tries: int = 3):
    """One eager step's device kernels and one replay's, by name and count,
    from torch.profiler (`step_kernels`): ({name: (count, ms)} eager,
    {name: (count, ms)} replay, the kernels PyTorch adds to the replay of a
    graph that draws from a registered generator, [eager counts, replay
    counts less those]). A profiler run can lose kernel records (the
    generator's two fills among them), so a difference, or a sampling
    step's generator kernels found missing, measures all three again, up
    to `tries` times: each try runs 4 steps."""
    for _ in range(tries):
        rng = rng_replay_kernels() if sampling else {}
        eager_k = step_kernels(eager_fn)
        graph_k = step_kernels(graph.replay)
        counts = [{k: n for k, (n, _) in eager_k.items()}, {}]
        for k, (n, _) in graph_k.items():
            k = GRAPH_COPY.get(k, k)
            counts[1][k] = counts[1].get(k, 0) + n - rng.get(k, 0)
        counts[1] = {k: n for k, n in counts[1].items() if n}
        if counts[0] == counts[1] and (rng or not sampling):
            break
        print(f"[{label}] replay against eager step, measured again: {kernel_diff(counts)} "
              f"(the generator's: {rng})")
    return eager_k, graph_k, rng, counts


def kernel_diff(counts) -> dict:
    """{short name: (eager count, replay count)} where they differ."""
    return {short_name(k): (counts[0].get(k), counts[1].get(k))
            for k in set(counts[0]) | set(counts[1]) if counts[0].get(k) != counts[1].get(k)}


def short_name(kernel: str) -> str:
    """The first 80 characters of a device kernel's name, less its
    namespaces and return type."""
    for cut in ("void ", "at::native::", "(anonymous namespace)::"):
        kernel = kernel.replace(cut, "")
    return kernel[:80]


def graph_counts(engine):
    """The engine's captured graphs: (decode steps, latent passes, CFM
    solves, vocoder calls)."""
    return tuple(engine.captured_graphs().values())


def replays_ms(graph, n: int) -> float:
    """Device ms of one replay of `graph`: n back to back on the current
    stream, timed with CUDA events."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def decode_turns(engine, wav_path: str, label: str, rounds: int = DECODE_ROUNDS):
    """The served engine's captured decode against its eager loop (the
    decoder's `eager` argument), on one request (the speaker prompt and
    request 0's text, seed DECODE_SEED), `rounds` rounds in turns
    (graph, eager; eager, graph; ...): each round's codes must equal the
    first's both ways, and each prints decode tokens/s, the request's wall
    time and its stage seconds. Then torch.profiler must find the same
    device kernels by name and count in one replay of the captured step as
    in one eager step, less those PyTorch adds to a sampling step's replay
    for its generator (`rng_replay_kernels`); 8 replays are timed with CUDA
    events; and the device memory the decode states hold (static caches
    and buffers, captured steps' pools) is printed as the reserved memory
    that dropping them frees."""
    import torch

    from indextts_tpu_torch.runtime.engine import EmotionConditioning
    from indextts_tpu_torch.serve import fallback_segments
    from indextts_tpu_torch.utils import audio as audio_utils

    c, dec = engine.cfg, engine.decoder
    spk = engine.prepare_speaker(*audio_utils.load_wav(wav_path), cache_key=wav_path)
    emo = EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
    ids = fallback_segments(request_text(0), c.gpt.number_text_tokens,
                            c.runtime.max_text_tokens_per_segment, c.gpt.max_text_tokens)[0]
    first = None
    for r in range(rounds):
        for mode in (("graph", "eager") if r % 2 == 0 else ("eager", "graph")):
            if mode == "eager":
                dec.generate = functools.partial(type(dec).generate, dec, eager=True)
            try:
                tok0, sec0 = dec.tokens, dec.seconds
                t0 = time.perf_counter()
                emovec, codes, t_gen = engine._decode_segment_codes(spk, emo, ids,
                                                                    seed=DECODE_SEED)
                seg = engine._finish_from_codes(spk, emovec, ids, codes, DECODE_SEED, t_gen)
                wall = time.perf_counter() - t0
            finally:
                dec.__dict__.pop("generate", None)
            toks, dsec = dec.tokens - tok0, dec.seconds - sec0
            print(f"[{label}] decode round {r} {mode}: decode_tokens={toks} "
                  f"decode_tok_per_s={toks / dsec:.1f} wall_s={wall:.3f} stages_s "
                  f"gpt_decode={seg.gpt_gen_time:.3f} gpt_latent={seg.gpt_forward_time:.3f} "
                  f"s2mel={seg.s2mel_time:.3f} bigvgan={seg.bigvgan_time:.3f}")
            if first is None:
                first = codes
            elif not np.array_equal(codes, first):
                fail(f"[{label}] decode round {r} {mode}: codes differ from round 0 graph's "
                     f"from the same seed ({len(codes)} vs {len(first)} codes)")
    print(f"[{label}] captured and eager decode: the same {len(first)} codes from seed "
          f"{DECODE_SEED} in all {2 * DECODE_ROUNDS} runs")

    st = next(reversed(dec._states.values()))  # the one these requests used
    do_sample = c.runtime.do_sample
    graph = st.graphs[do_sample][0]
    if int(st.start) + int(st.step) + 20 >= st.cap:
        fail(f"[{label}] no room in the cache to profile and time steps")
    # a replay of a sampling step also writes the generator's state
    with dec._lock, torch.inference_mode(), torch.cuda.stream(dec._stream):
        eager_k, graph_k, rng, counts = replay_against_eager(
            lambda: dec._advance(st, do_sample), graph, do_sample, label)
    (n_eager, ms_eager), (n_graph, ms_graph) = (
        [sum(v[i] for v in ks.values()) for i in (0, 1)] for ks in (eager_k, graph_k))
    print(f"[{label}] one decode step: {n_eager} device kernels ({len(eager_k)} names), "
          f"{ms_eager:.4f} device ms eager; one replay: {n_graph} ({len(graph_k)} names), "
          f"{ms_graph:.4f} device ms, of which the generator's state before the launch: "
          + (", ".join(f"{short_name(k)} x{n}" for k, n in rng.items()) or "none"))
    top = sorted(graph_k.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"[{label}] one replay's kernels by device ms: " + ", ".join(
        f"{short_name(k)} x{n} {ms:.4f}" for k, (n, ms) in top))
    if counts[0] != counts[1] or n_eager == 0:
        fail(f"[{label}] a replay's device kernels differ from an eager step's: "
             f"{kernel_diff(counts)} (the generator's, taken off the replay's: {rng})")
    # replays back to back, timed with CUDA events: the device's time a
    # step, against which its kernels' sum gives the idle share inside it
    with dec._lock, torch.inference_mode(), torch.cuda.stream(dec._stream):
        replay_ms = replays_ms(graph, 8)
    print(f"[{label}] 8 replays back to back: {replay_ms:.4f} ms a step (CUDA events); "
          f"its kernels' device time {ms_graph:.4f} ms, idle inside the step "
          f"{100 * (1 - ms_graph / replay_ms):.1f} %")

    del st, graph
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    shapes = [(key, st.cap, sorted(st.graphs)) for key, st in dec._states.items()]
    buffers = sum(t.nbytes for st in dec._states.values() for t in vars(st).values()
                  if isinstance(t, torch.Tensor)) + sum(
        t.nbytes for st in dec._states.values() for t in st.caches)
    with dec._lock:
        dec._states.clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{label}] decode states {shapes}: {buffers / 2**20:.1f} MiB of static buffers; "
          f"dropping them frees {(held - torch.cuda.memory_reserved()) / 2**20:.1f} MiB "
          "of reserved device memory (buffers and captured steps' pools)")


# ---------------------------------------------------------------------------
# the beam route: runtime/decode.py `generate_beam` through the engine and
# `serve.py --num-beams`
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def beam_server(engine, wav_path: str, label: str, tmp: str, beams: int):
    """A sequential server over `engine` built by `serve.build` with
    `--num-beams beams`, with its own response cache and no warm-up, on its
    own thread. Returns (the ServerThread, its port)."""
    from indextts_tpu_torch import serve

    port = free_port()
    os.environ["TARS_CACHE_DIR"] = os.path.join(tmp, f"cache-{label}-beams{beams}")
    warmup = os.environ.get("TARS_WARMUP")
    os.environ["TARS_WARMUP"] = "0"
    try:
        server, _ = serve.build(["--host", "127.0.0.1", "--port", str(port), "--reference-audio",
                                 wav_path, "--num-beams", str(beams)], engine=engine)
    finally:
        if warmup is None:
            del os.environ["TARS_WARMUP"]
        else:
            os.environ["TARS_WARMUP"] = warmup
    if server.service is not None:
        fail(f"[{label}] the --num-beams {beams} server is not sequential")
    return ServerThread(server), port


def served_segment(engine, port: int, label: str, what: str, seed: int):
    """One POST /tts of request 0's text with `seed`: it must answer 200 with
    a non-silent mono 16-bit WAV from a synthesized segment. Returns (its
    SegmentResult, wall seconds, audio seconds, decode tokens)."""
    segments = []
    synthesize = engine.synthesize_segment

    def record(*args, **kwargs):
        segments.append(synthesize(*args, **kwargs))
        return segments[-1]

    engine.synthesize_segment = record
    tok0 = engine.decoder.tokens
    t0 = time.perf_counter()
    try:
        status, body = post_tts(port, {"text": request_text(0), "seed": seed})
    finally:
        del engine.synthesize_segment
    wall = time.perf_counter() - t0
    if status != 200:
        fail(f"[{label}] {what} request: HTTP {status}: {body[:300]!r}")
    with wave.open(io.BytesIO(body)) as w:
        if (w.getnchannels(), w.getsampwidth()) != (1, 2):
            fail(f"[{label}] {what} request: not a mono 16-bit WAV")
        sr, n = w.getframerate(), w.getnframes()
        pcm = np.frombuffer(w.readframes(n), dtype=np.int16)
    if n == 0 or int(np.abs(pcm.astype(np.int32)).max()) == 0 or len(segments) != 1:
        fail(f"[{label}] {what} request: silent, empty or not synthesized")
    return segments[0], wall, n / sr, engine.decoder.tokens - tok0


def beam_request(engine, wav_path: str, label: str, tmp: str, rise, stay) -> dict:
    """One /tts request to a `--num-beams BEAMS` server over the route's
    engine (beam-multinomial, the config's do_sample), every kernel counter
    set to 0 just before it and read just after: those in `rise` must have
    risen, those in `stay` must be 0. Prints its stages and returns the
    launches."""
    counters = kernel_counters()
    thread, port = beam_server(engine, wav_path, label, tmp, BEAMS)
    try:
        for cnt in counters.values():
            cnt.launches = 0
        seg, wall, audio, toks = served_segment(engine, port, label, f"{BEAMS}-beam", 31)
        launches = {name: cnt.launches for name, cnt in counters.items()}
    finally:
        thread.stop()
    print(f"[{label}] {BEAMS}-beam /tts (--num-beams {BEAMS}, do_sample="
          f"{engine.cfg.runtime.do_sample}): wall_s={wall:.3f} audio_s={audio:.3f} "
          f"decode_tokens={toks} stages_s gpt_decode={seg.gpt_gen_time:.3f} "
          f"gpt_latent={seg.gpt_forward_time:.3f} s2mel={seg.s2mel_time:.3f} "
          f"bigvgan={seg.bigvgan_time:.3f}")
    for name, n in launches.items():
        print(f"[{label}] {BEAMS}-beam request {name}: launches={n}")
        if name in rise and n == 0:
            fail(f"[{label}] {name} was never launched on the beam route")
        if name in stay and n != 0:
            fail(f"[{label}] {name} was launched {n} times on the beam route; it has no "
                 "place there")
    return launches


def beam_phase(engine, wav_path: str, label: str, tmp: str, rise, stay) -> dict:
    """The beam route on the float route's full-width engine. Warm-up:
    `precompile(num_beams=BEAMS)` over the request text's 16-bucket (its
    beam-multinomial step captured, one decode graph more); then
    `beam_request` through a `--num-beams BEAMS` server, which must
    capture nothing (the graph counts do not move), beside a sampling
    request to a `--num-beams 1` server on the same text (their gpt_decode
    side by side); then `beam_turns`. Returns the beam request's launches."""
    import torch

    from indextts_tpu_torch.frontend.tokenizer import byte_fallback_ids
    from indextts_tpu_torch.runtime.engine import next_bucket
    from indextts_tpu_torch.utils import audio as audio_utils

    g = engine.cfg.gpt
    bucket = min(next_bucket(len(byte_fallback_ids(request_text(0), g.number_text_tokens,
                                                   200)), 16, 16), g.max_text_tokens)
    spk = engine.prepare_speaker(*audio_utils.load_wav(wav_path), cache_key=wav_path)
    before = graph_counts(engine)
    t0 = time.perf_counter()
    jobs = engine.precompile(spk, text_buckets=[bucket], code_lens=[MAX_MEL_TOKENS],
                             num_beams=BEAMS)
    torch.cuda.synchronize()
    warmed = graph_counts(engine)
    print(f"[{label}] precompile(num_beams={BEAMS}) over text bucket {bucket}: {jobs} jobs in "
          f"{time.perf_counter() - t0:.2f} s; graphs (decode, latent, s2mel, vocoder) "
          f"{before} -> {warmed}; decode states {list(engine.decoder._states)}")
    if warmed[0] != before[0] + 1:
        fail(f"[{label}] precompile(num_beams={BEAMS}) did not capture one beam step")
    launches = beam_request(engine, wav_path, label, tmp, rise, stay)
    if graph_counts(engine) != warmed:
        fail(f"[{label}] the beam request captured graphs the precompile had not: "
             f"{warmed} before, {graph_counts(engine)} after")
    print(f"[{label}] the {BEAMS}-beam request captured nothing new: graphs {warmed}")
    thread, port = beam_server(engine, wav_path, label, tmp, 1)
    try:
        seg, wall, audio, toks = served_segment(engine, port, label, "sampling", 32)
    finally:
        thread.stop()
    print(f"[{label}] sampling /tts (--num-beams 1) on the same text: wall_s={wall:.3f} "
          f"audio_s={audio:.3f} decode_tokens={toks} stages_s gpt_decode="
          f"{seg.gpt_gen_time:.3f} gpt_latent={seg.gpt_forward_time:.3f} "
          f"s2mel={seg.s2mel_time:.3f} bigvgan={seg.bigvgan_time:.3f}")
    beam_turns(engine, wav_path, label)
    return launches


def beam_turns(engine, wav_path: str, label: str):
    """Deterministic beam search over BEAMS beams on the served engine
    (request 0's text on the speaker prompt, keyed), captured and eager
    (the decoder's `eager` argument) in turns, BEAM_ROUNDS rounds: the
    same codes every time; each run prints decode tokens/s (codes of the
    best hypothesis a decode second) and its stages. Then one replay of
    the captured beam step against one eager step by device kernels' name
    and count (torch.profiler), its largest kernels, 8 replays timed
    (CUDA events) against its kernels' device time (the idle share
    inside the step), the reorder of every cache component by a beam
    index timed alone (CUDA events) against its bytes' bound, and the
    beam state's buffers and the memory that dropping the decode states
    frees."""
    import torch

    from indextts_tpu_torch.runtime.engine import EmotionConditioning
    from indextts_tpu_torch.serve import fallback_segments
    from indextts_tpu_torch.utils import audio as audio_utils

    c, dec = engine.cfg, engine.decoder
    spk = engine.prepare_speaker(*audio_utils.load_wav(wav_path), cache_key=wav_path)
    emo = EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
    key = (wav_path, "", 1.0, None)
    ids = fallback_segments(request_text(0), c.gpt.number_text_tokens,
                            c.runtime.max_text_tokens_per_segment, c.gpt.max_text_tokens)[0]
    first = None
    for r in range(BEAM_ROUNDS):
        for mode in (("graph", "eager") if r % 2 == 0 else ("eager", "graph")):
            if mode == "eager":
                dec.generate_beam = functools.partial(type(dec).generate_beam, dec, eager=True)
            try:
                tok0, sec0 = dec.tokens, dec.seconds
                t0 = time.perf_counter()
                emovec, codes, t_gen = engine._decode_segment_codes(
                    spk, emo, ids, seed=BEAM_SEED, cond_kv_key=key, num_beams=BEAMS,
                    do_sample=False)
                seg = engine._finish_from_codes(spk, emovec, ids, codes, BEAM_SEED, t_gen)
                wall = time.perf_counter() - t0
            finally:
                dec.__dict__.pop("generate_beam", None)
            toks, dsec = dec.tokens - tok0, dec.seconds - sec0
            print(f"[{label}] beam round {r} {mode}: decode_tokens={toks} "
                  f"decode_tok_per_s={toks / dsec:.1f} wall_s={wall:.3f} stages_s "
                  f"gpt_decode={seg.gpt_gen_time:.3f} gpt_latent={seg.gpt_forward_time:.3f} "
                  f"s2mel={seg.s2mel_time:.3f} bigvgan={seg.bigvgan_time:.3f}")
            if first is None:
                first = codes
            elif not np.array_equal(codes, first):
                fail(f"[{label}] beam round {r} {mode}: codes differ from round 0 graph's "
                     f"({len(codes)} vs {len(first)} codes)")
    print(f"[{label}] captured and eager {BEAMS}-beam search: the same {len(first)} codes "
          f"from seed {BEAM_SEED} in all {2 * BEAM_ROUNDS} runs")

    (key_st, st), = [(k, s) for k, s in dec._states.items() if k[0] == "beam"
                     and False in s.graphs]
    graph = st.graphs[False][0]
    if int(st.start) + int(st.step) + 40 >= st.cap:
        fail(f"[{label}] no room in the beam cache to profile and time steps")
    with dec._lock, torch.inference_mode(), torch.cuda.stream(dec._stream):
        eager_k, graph_k, _, counts = replay_against_eager(
            lambda: dec._beam_step(st, False), graph, False, label)
    (n_eager, ms_eager), (n_graph, ms_graph) = (
        [sum(v[i] for v in ks.values()) for i in (0, 1)] for ks in (eager_k, graph_k))
    print(f"[{label}] one beam step {key_st}: {n_eager} device kernels ({len(eager_k)} names), "
          f"{ms_eager:.4f} device ms eager; one replay: {n_graph} ({len(graph_k)} names), "
          f"{ms_graph:.4f} device ms")
    top = sorted(graph_k.items(), key=lambda kv: -kv[1][1])[:10]
    print(f"[{label}] one beam replay's kernels by device ms: " + ", ".join(
        f"{short_name(k)} x{n} {ms:.4f}" for k, (n, ms) in top))
    if counts[0] != counts[1] or n_eager == 0:
        fail(f"[{label}] a beam replay's device kernels differ from an eager step's: "
             f"{kernel_diff(counts)}")
    with dec._lock, torch.inference_mode(), torch.cuda.stream(dec._stream):
        replay_ms = replays_ms(graph, 8)
        beam_idx = torch.tensor([2, 0, 1], device="cuda")

        def reorder():
            for cache in st.caches:
                cache.copy_(cache.index_select(1, beam_idx))

        reorder_ms = cuda_ms(reorder, iters=8, replays=3)
    cache_bytes = sum(t.nbytes for t in st.caches)
    print(f"[{label}] 8 beam replays back to back: {replay_ms:.4f} ms a step (CUDA events); "
          f"its kernels' device time {ms_graph:.4f} ms, idle inside the step "
          f"{100 * (1 - ms_graph / replay_ms):.1f} %")
    print(f"[{label}] the cache reorder alone (index_select + copy_ of {len(st.caches)} "
          f"tensors, {cache_bytes / 2**20:.1f} MiB, 4 x its bytes moved): {reorder_ms:.4f} ms "
          f"(CUDA events), {100 * reorder_ms / replay_ms:.1f} % of a replayed step; bound "
          f"{4 * cache_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)")
    del st, graph
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    buffers = {k: sum(t.nbytes for t in s.tensors()) for k, s in dec._states.items()}
    with dec._lock:
        dec._states.clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{label}] decode states' static buffers (MiB): "
          + ", ".join(f"{k} {b / 2**20:.1f}" for k, b in buffers.items())
          + f"; dropping them frees {(held - torch.cuda.memory_reserved()) / 2**20:.1f} MiB "
          "of reserved device memory (buffers and captured steps' pools)")


def s2mel_flops(cfg, T: int, valid: int) -> float:
    """Float32 operations of one CFM solve at width T (runtime.diffusion_steps
    velocity calls on the CFG batch of 2): the DiT's and WaveNet's matrix
    products and convolutions, two a multiply-add, attention over `valid`
    keys; elementwise work and the few rows of the time and style
    projections left out."""
    d, w = cfg.s2mel.dit, cfg.s2mel.wavenet
    H, C, Cw = d.hidden_dim, d.in_channels, w.hidden_dim
    merge_in = 2 * C + H + (d.style_dim if d.style_condition and not d.style_as_token else 0)
    recv = sum(1 for i in range(d.depth) if d.uvit_skip_connection and i > d.depth // 2)
    layer = 3 * H * H + H * H + 3 * H * d.intermediate_size  # wqkv, wo, SwiGLU
    wavenet = sum(Cw * 2 * Cw * w.kernel_size + Cw * (2 * Cw if i < w.num_layers - 1 else Cw)
                  for i in range(w.num_layers))
    per_frame = (d.content_dim * H + merge_in * H + d.depth * layer + recv * 2 * H * H
                 + (H + C) * H + 2 * H * Cw + Cw * Cw + Cw * C + wavenet
                 + d.depth * 2 * valid * H)  # attention: QK^T and PV, every head
    return 2.0 * 2 * T * per_frame * cfg.runtime.diffusion_steps


def s2mel_turns(engine, wav_path: str, label: str):
    """The served engine's s2mel stage on one segment (the speaker prompt
    and request 0's text, decoded once from DECODE_SEED), its CFM solve a
    replay of the captured graph and the same solve eagerly on the same
    stream and buffers (the runner's `eager` argument), S2MEL_ROUNDS rounds
    in turns: every mel must equal the first replayed one to the bit, each
    run prints the stage's seconds (under TARS_STAGE_SYNC=1, so the card's
    time is in them), and K3 must count diffusion_steps x depth launches a
    stage either way. Then torch.profiler must find the same device kernels
    by name and count in one replay as in one eager solve
    (`replay_against_eager`); 4 replays are timed with CUDA events against
    the solve's float32 floor (`s2mel_flops` over 67 TFLOP/s); and the
    solve shapes cached and their graphs' pool are printed."""
    import torch

    from indextts_tpu_torch.ops import cuda_lib, dit_attention
    from indextts_tpu_torch.runtime.engine import EmotionConditioning
    from indextts_tpu_torch.serve import fallback_segments
    from indextts_tpu_torch.utils import audio as audio_utils

    t0 = time.perf_counter()
    c, runner = engine.cfg, engine.s2mel_runner
    spk = engine.prepare_speaker(*audio_utils.load_wav(wav_path), cache_key=wav_path)
    emo = EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
    ids = fallback_segments(request_text(0), c.gpt.number_text_tokens,
                            c.runtime.max_text_tokens_per_segment, c.gpt.max_text_tokens)[0]
    emovec, codes, t_gen = engine._decode_segment_codes(spk, emo, ids, seed=DECODE_SEED)
    per_stage = c.runtime.diffusion_steps * c.s2mel.dit.depth
    engine._finish_from_codes(spk, emovec, ids, codes, DECODE_SEED, t_gen)  # its graph
    first, times = None, {"graph": [], "eager": []}
    for r in range(S2MEL_ROUNDS):
        for mode in (("graph", "eager") if r % 2 == 0 else ("eager", "graph")):
            if mode == "eager":
                runner.solve = functools.partial(type(runner).solve, runner, eager=True)
            engine._mel_taps = []
            dit_attention.counter.launches = 0
            try:
                seg = engine._finish_from_codes(spk, emovec, ids, codes, DECODE_SEED, t_gen)
            finally:
                runner.__dict__.pop("solve", None)
            mel, launches = engine._mel_taps[0], dit_attention.counter.launches
            times[mode].append(seg.s2mel_time)
            print(f"[{label}] s2mel round {r} {mode}: s2mel_s={seg.s2mel_time:.4f} "
                  f"(gpt_latent {seg.gpt_forward_time:.4f}, bigvgan {seg.bigvgan_time:.4f}); "
                  f"K3 launches {launches}")
            if launches != per_stage:
                fail(f"[{label}] s2mel {mode}: K3 launched {launches} times, not "
                     f"{per_stage} ({c.runtime.diffusion_steps} steps x {c.s2mel.dit.depth} "
                     "layers)")
            if first is None:
                first = mel
            elif not np.array_equal(mel, first):
                err = float(np.abs(mel - first).max())
                fail(f"[{label}] s2mel round {r} {mode}: the mel differs from round 0's "
                     f"replay by up to {err:.3g} (largest value {np.abs(first).max():.3g})")
    engine._mel_taps = None
    print(f"[{label}] s2mel stage, the CFM solve replayed / eager: the same mel "
          f"{first.shape} in all {2 * S2MEL_ROUNDS} runs; s2mel_s "
          + " / ".join(", ".join(f"{t:.4f}" for t in times[m]) for m in ("graph", "eager")))

    prog = next(reversed(runner.programs.values()))  # the shape these stages used
    mu, x_lens, prompt_x, prompt_len, style, noise = prog.args
    B, _, T = noise.shape
    valid = int(x_lens[0])
    with runner.lock, torch.inference_mode(), torch.cuda.stream(runner.stream):
        eager_k, graph_k, _, counts = replay_against_eager(
            lambda: runner.fn(*prog.args), prog.graph, False, label)
        replay_ms = replays_ms(prog.graph, 4)
    (n_eager, ms_eager), (n_graph, ms_graph) = (
        [sum(v[i] for v in ks.values()) for i in (0, 1)] for ks in (eager_k, graph_k))
    print(f"[{label}] one CFM solve (B={B}, {2 * B} rows with CFG, T={T}, {valid} valid "
          f"frames): {n_eager} device kernels ({len(eager_k)} names), {ms_eager:.3f} device "
          f"ms eager; one replay: {n_graph} ({len(graph_k)} names), {ms_graph:.3f} device ms")
    print(f"[{label}] the replay's kernels by device ms, count eager / replay, replay ms: "
          + ", ".join(f"{short_name(k)} {counts[0].get(k)} / {counts[1].get(k)} "
                      f"{graph_k.get(k, (0, 0))[1]:.3f}"
                      for k in sorted(counts[1], key=lambda k: -graph_k.get(k, (0, 0))[1])))
    if counts[0] != counts[1] or n_eager == 0:
        fail(f"[{label}] a replay's device kernels differ from an eager solve's: "
             f"{kernel_diff(counts)}")
    floor_ms = s2mel_flops(c, valid, valid) / FP32_FLOPS * 1e3
    print(f"[{label}] 4 replays back to back: {replay_ms:.3f} ms a solve (CUDA events); its "
          f"kernels' device time {ms_graph:.3f} ms, idle inside the solve "
          f"{100 * (1 - ms_graph / replay_ms):.1f} %; float32 floor {floor_ms:.3f} ms at the "
          f"{valid} valid frames, {s2mel_flops(c, T, valid) / FP32_FLOPS * 1e3:.3f} ms at the "
          f"bucket's {T} (67 TFLOP/s)")
    torch.cuda.synchronize()
    print(f"[{label}] s2mel solves cached (B, T), least recently used first, with their "
          f"graph: {runner.shapes()}; the graphs' shared pool holds "
          f"{cuda_lib.pool_bytes(runner.pool) / 2**20:.1f} MiB; the s2mel phase took "
          f"{time.perf_counter() - t0:.1f} s")


def tail_turns(engine, wav_path: str, label: str):
    """The served engine's latent pass and vocoder call on one segment (the
    speaker prompt and request 0's text, decoded once from DECODE_SEED),
    each a replay of its runner's captured graph and the same call eagerly
    on the same stream and buffers (the runners' `eager` argument),
    TAIL_ROUNDS rounds in turns, eager first: every output must equal the
    first eager one to the bit, each run prints the stages' seconds (under
    TARS_STAGE_SYNC=1, so the card's time is in them), and K2 must count
    its launches of one vocoder call (37 at the default config) either
    way. Then, for each runner, torch.profiler must find the same device
    kernels by name and count in one replay as in one eager call
    (`replay_against_eager`); 4 replays are timed with CUDA events; and the
    keys cached and the graphs' pool are printed."""
    import torch

    from indextts_tpu_torch.ops import cuda_lib, snake
    from indextts_tpu_torch.runtime.engine import EmotionConditioning
    from indextts_tpu_torch.serve import fallback_segments
    from indextts_tpu_torch.utils import audio as audio_utils

    t0 = time.perf_counter()
    c, v = engine.cfg, engine.cfg.vocoder
    per_call = len(v.upsample_rates) * 2 * len(v.resblock_dilation_sizes[0]) + 1
    spk = engine.prepare_speaker(*audio_utils.load_wav(wav_path), cache_key=wav_path)
    emo = EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
    ids = fallback_segments(request_text(0), c.gpt.number_text_tokens,
                            c.runtime.max_text_tokens_per_segment, c.gpt.max_text_tokens)[0]
    emovec, codes, t_gen = engine._decode_segment_codes(spk, emo, ids, seed=DECODE_SEED)
    engine._finish_from_codes(spk, emovec, ids, codes, DECODE_SEED, t_gen)  # their graphs
    runners = {"latent": (engine.latent_runner, "latent"),
               "vocoder": (engine.vocoder_runner, "vocode")}
    outs, first, times = {}, {}, {"graph": [], "eager": []}

    def tap(name, runner, method, eager):
        call = functools.partial(getattr(type(runner), method), runner, eager=eager)

        def run(*args):
            outs[name] = call(*args)
            return outs[name]

        return run

    for r in range(TAIL_ROUNDS):
        for mode in (("eager", "graph") if r % 2 == 0 else ("graph", "eager")):
            for name, (runner, method) in runners.items():
                setattr(runner, method, tap(name, runner, method, mode == "eager"))
            snake.counter.launches = 0
            try:
                seg = engine._finish_from_codes(spk, emovec, ids, codes, DECODE_SEED, t_gen)
            finally:
                for runner, method in runners.values():
                    runner.__dict__.pop(method, None)
            launches = snake.counter.launches
            times[mode].append((seg.gpt_forward_time, seg.bigvgan_time))
            print(f"[{label}] tail round {r} {mode}: gpt_latent_s={seg.gpt_forward_time:.4f} "
                  f"bigvgan_s={seg.bigvgan_time:.4f} (s2mel {seg.s2mel_time:.4f}); K2 "
                  f"launches {launches}")
            if launches != per_call:
                fail(f"[{label}] vocoder {mode}: K2 launched {launches} times, not {per_call}")
            for name, out in outs.items():
                if name not in first:
                    first[name] = out
                elif not torch.equal(out, first[name]):
                    err = float((out.double() - first[name].double()).abs().max())
                    fail(f"[{label}] tail round {r} {mode}: the {name} output differs from "
                         f"round 0's eager one by up to {err:.3g}")
    print(f"[{label}] latent pass and vocoder replayed / eager: the same latent "
          f"{tuple(first['latent'].shape)} and waveform {tuple(first['vocoder'].shape)} "
          f"{first['vocoder'].dtype} in all {2 * TAIL_ROUNDS} runs; gpt_latent_s "
          + " / ".join(", ".join(f"{t[0]:.4f}" for t in times[m]) for m in ("graph", "eager"))
          + "; bigvgan_s "
          + " / ".join(", ".join(f"{t[1]:.4f}" for t in times[m]) for m in ("graph", "eager")))

    for name, (runner, _) in runners.items():
        prog = next(reversed(runner.programs.values()))  # the key this segment used
        with runner.lock, torch.inference_mode(), torch.cuda.stream(runner.stream):
            eager_k, graph_k, _, counts = replay_against_eager(
                lambda: runner.fn(*prog.args), prog.graph, False, f"{label} {name}")
            replay_ms = replays_ms(prog.graph, 4)
        (n_eager, ms_eager), (n_graph, ms_graph) = (
            [sum(x[i] for x in ks.values()) for i in (0, 1)] for ks in (eager_k, graph_k))
        print(f"[{label}] one {name} call (key {list(runner.keys())[-1]}): {n_eager} device "
              f"kernels ({len(eager_k)} names), {ms_eager:.3f} device ms eager; one replay: "
              f"{n_graph} ({len(graph_k)} names), {ms_graph:.3f} device ms; the largest: "
              + ", ".join(f"{short_name(k)} x{n} {ms:.3f}" for k, (n, ms) in
                          sorted(graph_k.items(), key=lambda kv: -kv[1][1])[:6]))
        if counts[0] != counts[1] or n_eager == 0:
            fail(f"[{label}] a {name} replay's device kernels differ from an eager call's: "
                 f"{kernel_diff(counts)}")
        print(f"[{label}] {name}: 4 replays back to back: {replay_ms:.3f} ms a call (CUDA "
              f"events); its kernels' device time {ms_graph:.3f} ms, idle inside "
              f"{100 * (1 - ms_graph / replay_ms):.1f} %; keys cached {list(runner.keys())}; "
              f"the graphs' pool holds {cuda_lib.pool_bytes(runner.pool) / 2**20:.1f} MiB")
    print(f"[{label}] the tail phase took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# batched segments: runtime/engine.py `synthesize_segments_batched`
# ---------------------------------------------------------------------------


def spy_codes(engine, eager: bool = False) -> list:
    """Wrap the engine's decoder's `generate` (run eagerly with `eager`) to
    record each decode's codes and lengths on the host; returns the list.
    `engine.decoder.__dict__.pop("generate")` undoes it."""
    dec, seen = engine.decoder, []
    gen = functools.partial(type(dec).generate, dec, eager=eager)

    def generate(*args, **kw):
        res = gen(*args, **kw)
        seen.append((res.codes.cpu().numpy(), res.lengths.cpu().numpy()))
        return res

    dec.generate = generate
    return seen


def batched_ids(engine) -> list:
    """The token ids of `batch_texts`, one segment each."""
    from indextts_tpu_torch.serve import fallback_segments

    c = engine.cfg
    return [fallback_segments(t, c.gpt.number_text_tokens, c.runtime.max_text_tokens_per_segment,
                              c.gpt.max_text_tokens)[0] for t in batch_texts()]


def batched_run(engine, wav_path: str, segs, eager: bool = False):
    """One batched request of `segs` from BATCH_SEED (`infer(...,
    batched=True)`, the decode eagerly with `eager`): (result, the decode's
    (codes, lengths), decode tokens, decode seconds, wall seconds)."""
    dec = engine.decoder
    seen = spy_codes(engine, eager)
    tok0, sec0 = dec.tokens, dec.seconds
    t0 = time.perf_counter()
    try:
        res = engine.infer(wav_path, segs, seed=BATCH_SEED, batched=True)
    finally:
        dec.__dict__.pop("generate", None)
    wall = time.perf_counter() - t0
    if len(seen) != 1 or seen[0][0].shape[0] != len(segs):
        fail(f"the batched request of {len(segs)} segments did not decode them in one loop")
    return res, seen[0], dec.tokens - tok0, dec.seconds - sec0, wall


def print_run(label: str, what: str, res, stages: dict, toks: int, dsec: float, wall: float):
    audio = res["duration_sec"]
    print(f"[{label}] {what}: wall_s={wall:.3f} audio_s={audio:.3f} "
          f"audio_s_per_wall_s={audio / wall:.3f} decode_tokens={toks} "
          f"decode_tok_per_s={toks / dsec:.1f} stages_s "
          + " ".join(f"{k}={v:.4f}" for k, v in stages.items()))
    if not (np.isfinite(res["audio"]).all() and np.abs(res["audio"]).max() > 0):
        fail(f"[{label}] {what}: silent or non-finite audio")


def check_launches(label: str, what: str, launches: dict, rise, stay) -> None:
    for name, n in launches.items():
        print(f"[{label}] {what} {name}: launches={n}")
        if name in rise and n == 0:
            fail(f"[{label}] {name} was never launched on the {what}")
        if name in stay and n != 0:
            fail(f"[{label}] {name} was launched {n} times on the {what}; it has no place there")


def counted_batched_run(engine, wav_path: str, segs, label: str, rise, stay):
    """`batched_run` with every kernel counter set to 0 just before it and
    read just after: those in `rise` must have risen, those in `stay` must
    be 0. Returns batched_run's tuple and the launches."""
    counters = kernel_counters()
    for cnt in counters.values():
        cnt.launches = 0
    out = batched_run(engine, wav_path, segs)
    launches = {name: cnt.launches for name, cnt in counters.items()}
    check_launches(label, f"batched {len(segs)}-segment request", launches, rise, stay)
    return out, launches


def batched_codes_check(engine, wav_path: str, segs, captured, label: str) -> None:
    """The batched decode eagerly from the same seed: the captured loop's
    codes and lengths."""
    _, (codes, lengths), toks, dsec, _ = batched_run(engine, wav_path, segs, eager=True)
    if not (np.array_equal(codes, captured[0]) and np.array_equal(lengths, captured[1])):
        fail(f"[{label}] the batched decode eager and captured differ from one seed")
    print(f"[{label}] batched decode captured and eager: the same codes on all {len(segs)} "
          f"rows from seed {BATCH_SEED} (lengths {lengths.tolist()}; eager "
          f"{toks / dsec:.1f} tokens/s)")


def batched_request(engine, wav_path: str, label: str, rise, stay,
                    eager_check: bool = False) -> dict:
    """A route's batched request of `batch_texts` after its other phases:
    one that captures its keys, then one counted (`counted_batched_run`),
    its wall, stages and launches printed; with `eager_check`,
    `batched_codes_check`. Returns the launches."""
    segs = batched_ids(engine)
    batched_run(engine, wav_path, segs)
    (res, codes, toks, dsec, wall), launches = counted_batched_run(
        engine, wav_path, segs, label, rise, stay)
    print_run(label, f"batched {len(segs)}-segment request", res, engine._last_batched_stats,
              toks, dsec, wall)
    if eager_check:
        batched_codes_check(engine, wav_path, segs, codes, label)
    return launches


def batched_phase(engine, wav_path: str, label: str, rise, stay) -> dict:
    """The float route's batched phase, after its other phases. First the
    warm-up at BATCH_CODES codes from nothing captured (the decode states
    and the tail runners' keys dropped): its jobs, seconds and peak memory.
    Then a batched request of `batch_texts` (8 segments of unequal length,
    MAX_MEL_TOKENS codes at most) captures its own keys: every key the
    warm-up captured must still be held with its graph, and a sequential
    request inside the envelope after it must capture nothing. Then
    BATCH_ROUNDS rounds of the batched request against the same segments
    on the sequential route (TARS_STAGE_SYNC=1), in turns: wall, audio
    seconds per wall second, stage seconds, decode tokens/s; the batched
    codes the same every round, the launches of a batched request counted
    (`counted_batched_run`), and its decode eagerly (`batched_codes_check`).
    Then the B-row CFM solve replayed against the eager solve on its
    buffers (the same bits), its kernels by name, count and ms against an
    eager solve's (`replay_against_eager`), 2 replays timed with CUDA
    events against its float32 floor; one replay of the latent pass and
    of the vocoder timed; the batched decode state's bytes, each runner's
    pool and the peak memory. Returns the launches of a batched request."""
    import torch

    from indextts_tpu_torch.ops import cuda_lib
    from indextts_tpu_torch.utils import audio as audio_utils

    t_phase = time.perf_counter()
    c, dec = engine.cfg, engine.decoder
    runners = {"latent": engine.latent_runner, "s2mel": engine.s2mel_runner,
               "vocoder": engine.vocoder_runner}
    spk = engine.prepare_speaker(*audio_utils.load_wav(wav_path), cache_key=wav_path)
    torch.cuda.synchronize()
    with dec._lock:
        dec._states.clear()
    for r in runners.values():
        with r.lock:
            r.programs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    jobs = engine.precompile(spk, max_code_len=BATCH_CODES)
    torch.cuda.synchronize()
    print(f"[{label}] precompile over {BATCH_CODES} codes from nothing captured: {jobs} jobs "
          f"in {time.perf_counter() - t0:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; graphs (decode, latent, "
          f"s2mel, vocoder) {graph_counts(engine)}")
    warmed = {name: r.keys() for name, r in runners.items()}

    segs = batched_ids(engine)
    B = len(segs)
    batched_run(engine, wav_path, segs)  # captures the B-row keys
    for name, r in runners.items():
        held = r.keys()
        lost = [k for k in warmed[name] if not held.get(k)]
        if lost:
            fail(f"[{label}] the batched request evicted the warmed {name} keys {lost}")
    graphs = graph_counts(engine)
    engine.infer(wav_path, [segs[0]], seed=BATCH_SEED)
    if graph_counts(engine) != graphs:
        fail(f"[{label}] a sequential request after the batched one captured graphs: (decode, "
             f"latent, s2mel, vocoder) {graphs} before, {graph_counts(engine)} after")
    print(f"[{label}] the batched request kept every warmed key ("
          + ", ".join(f"{n} {len(k)}" for n, k in warmed.items()) + ") and added "
          + ", ".join(f"{n} {[k for k in r.keys() if k not in warmed[n]]}"
                      for n, r in runners.items())
          + f"; a sequential request after it captured nothing: graphs {graphs}")

    first, launches = None, None
    for rnd in range(BATCH_ROUNDS):
        for mode in (("batched", "sequential") if rnd % 2 == 0 else ("sequential", "batched")):
            if mode == "batched":
                if launches is None:
                    (res, codes, toks, dsec, wall), launches = counted_batched_run(
                        engine, wav_path, segs, label, rise, stay)
                else:
                    res, codes, toks, dsec, wall = batched_run(engine, wav_path, segs)
                stages = dict(engine._last_batched_stats)
                if first is None:
                    first = codes
                elif not all(np.array_equal(a, b) for a, b in zip(codes, first)):
                    fail(f"[{label}] batched round {rnd}: codes differ from the first round's")
            else:
                tok0, sec0 = dec.tokens, dec.seconds
                t0 = time.perf_counter()
                res = engine.infer(wav_path, segs, seed=BATCH_SEED)
                wall = time.perf_counter() - t0
                toks, dsec = dec.tokens - tok0, dec.seconds - sec0
                stages = {k: sum(getattr(s, f) for s in res["stats"]) for k, f in (
                    ("gpt_decode", "gpt_gen_time"), ("gpt_latent", "gpt_forward_time"),
                    ("s2mel", "s2mel_time"), ("bigvgan", "bigvgan_time"))}
            print_run(label, f"batched round {rnd} {mode} ({B} segments)", res, stages, toks,
                      dsec, wall)
    batched_codes_check(engine, wav_path, segs, first, label)

    runner = engine.s2mel_runner
    prog = next(p for k, p in runner.programs.items() if k[0] == B)
    mu, x_lens, prompt_x, prompt_len, style, noise = prog.args
    T, valid = noise.shape[2], x_lens.tolist()
    with runner.lock, torch.inference_mode(), torch.cuda.stream(runner.stream):
        eager = runner.fn(*prog.args)
        prog.graph.replay()
        same = torch.equal(prog.out, eager)
        del eager
        eager_k, graph_k, _, counts = replay_against_eager(
            lambda: runner.fn(*prog.args), prog.graph, False, label)
        solve_ms = replays_ms(prog.graph, 2)
    if not same:
        fail(f"[{label}] the {B}-row CFM solve's replay differs from the eager solve")
    if counts[0] != counts[1]:
        fail(f"[{label}] a {B}-row solve replay's device kernels differ from an eager "
             f"solve's: {kernel_diff(counts)}")
    n_graph, ms_graph = (sum(v[i] for v in graph_k.values()) for i in (0, 1))
    floor_ms = sum(s2mel_flops(c, v, v) for v in valid) / FP32_FLOPS * 1e3
    bucket_ms = sum(s2mel_flops(c, T, v) for v in valid) / FP32_FLOPS * 1e3
    print(f"[{label}] one {B}-row CFM solve ({2 * B} rows with CFG, T={T}, valid {valid}): "
          f"replay equal to the eager solve to the bit; 2 replays back to back "
          f"{solve_ms:.3f} ms a solve (CUDA events), {solve_ms / B:.3f} ms a row; {n_graph} "
          f"device kernels, {ms_graph:.3f} device ms, idle inside "
          f"{100 * (1 - ms_graph / solve_ms):.1f} %; float32 floor {floor_ms:.3f} ms at the "
          f"valid frames, {bucket_ms:.3f} ms at the bucket's {T} (67 TFLOP/s)")
    print(f"[{label}] the {B}-row solve replay's largest kernels by device ms: " + ", ".join(
        f"{short_name(k)} x{n:g} {ms:.3f}"
        for k, (n, ms) in sorted(graph_k.items(), key=lambda kv: -kv[1][1])[:8]))
    for name in ("latent", "vocoder"):
        r = runners[name]
        p = next(p for k, p in r.programs.items() if k[0] == B)
        with r.lock, torch.inference_mode(), torch.cuda.stream(r.stream):
            ms = replays_ms(p.graph, 2)
        print(f"[{label}] one {B}-row {name} replay (key "
              f"{next(k for k in r.keys() if k[0] == B)}): {ms:.3f} ms (CUDA events)")
    st = next(s for k, s in dec._states.items() if k[0] == B)
    state_bytes = sum(t.nbytes for t in st.tensors())
    print(f"[{label}] the batched decode state ({B}, {st.cap}): {state_bytes / 2**20:.1f} MiB "
          "of static buffers; runner pools "
          + ", ".join(f"{n} {cuda_lib.pool_bytes(r.pool) / 2**20:.1f} MiB"
                      for n, r in runners.items())
          + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the "
          f"batched phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# the bfloat16 compute modes (gpt_dtype, s2mel_dtype, voc_dtype)
# ---------------------------------------------------------------------------


def bench_config(cfg, bf16: bool):
    """The JAX package's bench.py quantized serving configuration
    (BENCH_QUANT=1): W8 blocks, an int8 KV cache, the logits head float
    (TARS_HEAD_QUANT unset), gemv_impl "pallas" as this script's W8 route;
    with `bf16` the s2mel and the vocoder in bfloat16. The GPT's dtype is
    the engine's argument, as bench.py passes it."""
    dt = "bfloat16" if bf16 else "float32"
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, gpt_quantize=True, kv_quant=True, gpt_wbits=8, head_quant=False,
        gemv_impl="pallas", s2mel_dtype=dt, voc_dtype=dt))


def model_mib(engine) -> dict:
    """Each model's stored bytes in MiB (the float32 vocoder sibling apart
    where the engine keeps one)."""
    mods = {"gpt": engine.gpt, "s2mel": engine.s2mel, "bigvgan": engine.bigvgan,
            "repcodec": engine.repcodec, "campplus": engine.campplus,
            "w2vbert": engine.w2vbert}
    if engine.bigvgan_f32 is not engine.bigvgan:
        mods["bigvgan_f32"] = engine.bigvgan_f32
    return {name: round(sum(t.numel() * t.element_size() for t in m.state_dict().values())
                        / 2**20, 1) for name, m in mods.items()}


def bf16_engine(model_dir: str, cfg, label: str, gpt_dtype):
    """An engine loaded from the checkpoint directory with `gpt_dtype` (the
    constructor's argument; the others from cfg.runtime), none of its
    models filled with random weights; its load's seconds and each model's
    stored MiB printed."""
    import torch

    from indextts_tpu_torch.runtime.loader import load_engine

    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = load_engine(model_dir, cfg=cfg, device="cuda", gpt_dtype=gpt_dtype)
    torch.cuda.synchronize()
    rt = engine.cfg.runtime
    print(f"[{label}] loaded in {time.perf_counter() - t0:.1f} s: gpt_dtype "
          f"{engine.gpt.gpt.dtype}, s2mel_dtype {rt.s2mel_dtype}, voc_dtype {rt.voc_dtype} "
          f"(gpt_quantize={rt.gpt_quantize}, kv_quant={rt.kv_quant}, head_quant="
          f"{rt.head_quant}, gemv_impl={rt.gemv_impl!r}); MiB stored per model "
          f"{json.dumps(model_mib(engine))}; "
          f"{(torch.cuda.memory_allocated() - before) / 2**30:.2f} GiB allocated")
    if engine.load_report.filled:
        fail(f"[{label}] the checkpoint directory left {engine.load_report.filled} to random "
             "weights")
    return engine


def bf16_served(engine, wav_path: str, label: str, tmp: str, rise, stay):
    """One POST /tts through a sequential server over `engine` (its own
    response cache), every counter set to 0 just before and read just
    after: those in `rise` must have risen, those in `stay` be 0. Returns
    (the launches, the SegmentResult, the tail's inputs: spk, emovec, text
    ids, codes)."""
    from indextts_tpu_torch import serve

    os.environ["TARS_CACHE_DIR"] = os.path.join(tmp, f"cache-{label}")
    # no background precompile: its launches would count with the request's
    os.environ["TARS_PRECOMPILE"] = "0"
    port = free_port()
    server, _ = serve.build(["--host", "127.0.0.1", "--port", str(port),
                             "--reference-audio", wav_path], engine=engine)
    thread = ServerThread(server)
    tails = []
    finish = engine._finish_from_codes

    def record(spk, emovec, text_ids, codes, *rest):
        tails.append((spk, emovec, np.asarray(text_ids), np.asarray(codes)))
        return finish(spk, emovec, text_ids, codes, *rest)

    engine._finish_from_codes = record
    counters = kernel_counters()
    for cnt in counters.values():
        cnt.launches = 0
    try:
        seg, wall, audio, toks = served_segment(engine, port, label, "sequential /tts", 0)
    finally:
        launches = {name: cnt.launches for name, cnt in counters.items()}
        del engine._finish_from_codes
        thread.stop()
    check_launches(label, "sequential /tts request", launches, rise, stay)
    print(f"[{label}] sequential /tts: wall_s={wall:.3f} audio_s={audio:.3f} "
          f"decode_tokens={toks} decode_tok_per_s={toks / seg.gpt_gen_time:.1f} stages_s "
          f"gpt_decode={seg.gpt_gen_time:.3f} gpt_latent={seg.gpt_forward_time:.3f} "
          f"s2mel={seg.s2mel_time:.3f} bigvgan={seg.bigvgan_time:.3f}")
    return launches, seg, tails[-1]


def bf16_turns(engines: dict, wav_path: str, batched: bool) -> None:
    """BF16_ROUNDS rounds in turns over `engines` ({label: engine}, the
    float32 one first): a one-segment request (and with `batched` an
    8-segment batched one) from the same seed on each, its wall, decode
    tokens/s, stage seconds and the device memory it took beyond what was
    allocated before it printed."""
    import torch

    for r in range(BF16_ROUNDS):
        for label, engine in engines.items():
            segs = batched_ids(engine)
            runs = [("one segment", segs[:1])] + ([("batched", segs)] if batched else [])
            for what, ss in runs:
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                if what == "batched":
                    res, _, toks, dsec, wall = batched_run(engine, wav_path, ss)
                    stages = engine._last_batched_stats
                else:
                    tok0, sec0 = engine.decoder.tokens, engine.decoder.seconds
                    t0 = time.perf_counter()
                    res = engine.infer(wav_path, ss, seed=BF16_SEED + r)
                    wall = time.perf_counter() - t0
                    toks = engine.decoder.tokens - tok0
                    dsec = engine.decoder.seconds - sec0
                    st = res["stats"][0]
                    stages = {"gpt_decode": st.gpt_gen_time, "gpt_latent": st.gpt_forward_time,
                              "s2mel": st.s2mel_time, "bigvgan": st.bigvgan_time}
                print_run(label, f"turn {r} {what}", res, stages, toks, dsec, wall)
                print(f"[{label}] turn {r} {what}: peak device memory "
                      f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB beyond the "
                      f"{base / 2**30:.2f} GiB allocated before it")


def bf16_tail(e32, e16, wav_path: str, inputs, label: str) -> None:
    """The same codes (the bf16 engine's served request's) through the
    float32 tail (e32's s2mel and vocoder) and the bf16 tail (e16's bf16
    s2mel; its bf16 vocoder, and the float32 sibling that its sequential
    route takes), over one GPT latent (e16's latent pass) and the same CFM
    noise: the mel's and the waveform's relative L2 apart, and how many
    PCM16 steps the bf16 waveform's clip (in bfloat16, as the JAX engine's
    _vocode_pcm16) moves a sample from the float32 clip of the same
    waveform."""
    import torch

    from indextts_tpu_torch.models.bigvgan import to_pcm16
    from indextts_tpu_torch.runtime.engine import next_bucket
    from indextts_tpu_torch.utils import audio as audio_utils

    spk16, emovec, text_ids, codes = inputs
    spk32 = e32.prepare_speaker(*audio_utils.load_wav(wav_path))
    rt = e16.cfg.runtime
    row, n = e16.remove_long_silence(codes, e16.cfg.gpt.stop_mel_token,
                                     compress=rt.remove_long_silence)
    n = max(n, 1)
    latent, codes_t = e16._latent_pass(spk16, emovec, text_ids, row, n)
    exact = int(n * 1.72)
    target = next_bucket(exact, 128, 128)
    ref = spk16.ref_mel_len
    g = torch.Generator(device="cuda").manual_seed(BF16_SEED)
    noise = torch.randn((1, e16.cfg.s2mel.dit.in_channels, ref + target), generator=g,
                        device="cuda")
    with torch.inference_mode():
        mels = {k: e._s2mel_mel(spk, latent, codes_t, n, target, noise)[:, :, ref:ref + exact]
                for k, e, spk in (("fp32", e32, spk32), ("bf16", e16, spk16))}
        pad = {k: torch.nn.functional.pad(m, (0, target - exact), value=float(np.log(1e-5)))
               for k, m in mels.items()}
        wavs = {"fp32": e32._vocode_rows(pad["fp32"], [exact])[0],
                "bf16 s2mel, fp32 sibling": e16._vocode_rows(pad["bf16"], [exact])[0],
                "bf16 s2mel, bf16 vocoder": e16._vocode_rows(pad["bf16"], [exact],
                                                             e16.batch_vocoder_runner)[0],
                "fp32 mel, bf16 vocoder": e16._vocode_rows(pad["fp32"], [exact],
                                                           e16.batch_vocoder_runner)[0]}
        raw = e16.bigvgan(pad["bf16"])

        def pcm_steps(w):
            return (to_pcm16(w).int() - torch.clamp(w.float() * 32767.0, -32767.0, 32767.0)
                    .to(torch.int16).int()).abs()

        steps = pcm_steps(raw)
        # the same waveform scaled to a peak of 0.9, as a loud recording's
        peak = raw.float().abs().max().clamp_min(1e-12)
        loud = pcm_steps((raw.float() * (0.9 / peak)).to(torch.bfloat16))
    m32, m16 = (mels[k].float().cpu().numpy() for k in ("fp32", "bf16"))
    if not all(np.isfinite(x).all() for x in [m32, m16, *wavs.values()]):
        fail(f"[{label}] the tails' mels or waveforms are not finite")

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    print(f"[{label}] the same {n} codes through the float32 and the bf16 tail (one GPT "
          f"latent, one CFM noise): mel relative L2 {rel(m16, m32):.4g} (the JAX package "
          f"bounds its bf16 CFM at 0.08); waveform relative L2 against the float32 tail's: "
          + ", ".join(f"{k} {rel(w, wavs['fp32']):.4g}" for k, w in wavs.items() if k != "fp32")
          + " (the JAX package bounds its bf16 vocoder at 0.05)")
    for what, st in ((f"the bf16 waveform (peak {peak.item():.4g})", steps),
                     ("the same scaled to a peak of 0.9", loud)):
        print(f"[{label}] PCM16 clip in bfloat16 (the JAX engine's _vocode_pcm16) against a "
              f"float32 clip of the same samples, {what}: "
              f"{(st > 1).float().mean().item():.3%} of {st.numel()} samples move by more than "
              f"one PCM16 step, the largest by {int(st.max())}")


def bf16_phase(float_engine, wav_path: str, model_dir: str, cfg, tmp: str, names) -> dict:
    """Phase `bf16_phase`, after the float route's batched phase, its engine
    still loaded. First the float route with gpt_dtype bfloat16 (and the
    s2mel and vocoder in bfloat16): one counted /tts (K1 over its bf16
    cache, K3-bf16, K2 in float32 through the vocoder sibling), then
    BF16_ROUNDS rounds of a one-segment request against the float32 float
    route's engine, in turns. Then bench.py's quantized configuration
    (`bench_config`) in float32 and with gpt_dtype, s2mel and vocoder in
    bfloat16, both loaded: a counted /tts on each (the bf16 one: K3-bf16,
    K4-K6 and K2 through the sibling, not K3 nor K2-bf16), a counted
    batched 8-segment request on each (the bf16 one through K2-bf16, not
    K2), BF16_ROUNDS rounds of a one-segment and a batched request, in
    turns, the vocoder pools' MiB (the dual vocoder's two), and
    `bf16_tail`. Returns the launches of K2-bf16 (its batched request) and
    K3-bf16 (its /tts)."""
    import torch

    from indextts_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    K = dict(zip(("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K2b", "K3b"), names))
    quant = [K[k] for k in ("K4", "K5", "K6")]

    def others(rise):
        return [k for k in names if k not in rise]

    fcfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, s2mel_dtype="bfloat16", voc_dtype="bfloat16"))
    label = "float-bf16"
    e16 = bf16_engine(model_dir, fcfg, label, torch.bfloat16)
    rise = [K["K1"], K["K2"], K["K3b"]]
    bf16_served(e16, wav_path, label, tmp, rise, others(rise))
    cache = [st.caches[0].dtype for st in e16.decoder._states.values()]
    print(f"[{label}] decode caches: {cache}")
    if not cache or any(d != torch.bfloat16 for d in cache):
        fail(f"[{label}] the float route's bf16 GPT decoded over a {cache} cache")
    bf16_turns({"float": float_engine, label: e16}, wav_path, batched=False)
    del e16
    gc.collect()
    torch.cuda.empty_cache()
    print(f"bf16_phase: the float route done at {time.perf_counter() - t0:.1f} s")

    e32 = bf16_engine(model_dir, bench_config(cfg, False), "w8-fp32", torch.float32)
    w16 = bf16_engine(model_dir, bench_config(cfg, True), "w8-bf16", torch.bfloat16)
    rise32 = [K["K2"], K["K3"], *quant]
    bf16_served(e32, wav_path, "w8-fp32", tmp, rise32, others(rise32))
    rise = [K["K2"], K["K3b"], *quant]
    seq, _, tail_in = bf16_served(w16, wav_path, "w8-bf16", tmp, rise, others(rise))
    segs = batched_ids(w16)
    brise32 = [K["K2"], K["K3"], *quant]
    counted_batched_run(e32, wav_path, segs, "w8-fp32", brise32, others(brise32))
    brise = [K["K2b"], K["K3b"], *quant]
    _, batched = counted_batched_run(w16, wav_path, segs, "w8-bf16", brise, others(brise))
    bf16_turns({"w8-fp32": e32, "w8-bf16": w16}, wav_path, batched=True)
    bf16_tail(e32, w16, wav_path, tail_in, "w8-bf16")
    pools = {f"{lab} {name}": cuda_lib.pool_bytes(r.pool) / 2**20 for lab, e in (
        ("w8-fp32", e32), ("w8-bf16", w16)) for name, r in (
        ("vocoder", e.vocoder_runner), ("batch vocoder", e.batch_vocoder_runner),
        ("s2mel", e.s2mel_runner)) if name != "batch vocoder" or r is not e.vocoder_runner}
    print("bf16_phase: graph pools (MiB; the bf16 engine's vocoder pool is its float32 "
          "sibling's, its batch vocoder pool the bf16 model's): "
          + ", ".join(f"{k} {v:.1f}" for k, v in pools.items())
          + f"; keys vocoder {list(w16.vocoder_runner.keys())}, batch vocoder "
          f"{list(w16.batch_vocoder_runner.keys())}")
    del e32, w16
    gc.collect()
    torch.cuda.empty_cache()
    print(f"bf16_phase done in {time.perf_counter() - t0:.1f} s")
    return {K["K2b"]: batched[K["K2b"]], K["K3b"]: seq[K["K3b"]]}


def post_stream(port: int, payload: dict):
    """POST /tts/stream: (status, seconds to the first chunk of PCM, wall
    seconds, the PCM as int16)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    t0 = time.perf_counter()
    conn.request("POST", "/tts/stream", body=json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    first, data = None, []
    while True:
        chunk = r.read1(1 << 16)
        if not chunk:
            break
        if first is None:
            first = time.perf_counter() - t0
        data.append(chunk)
    wall = time.perf_counter() - t0
    conn.close()
    return r.status, first, wall, np.frombuffer(b"".join(data), np.int16)


def wav_pcm(body: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(body)) as w:
        if (w.getnchannels(), w.getsampwidth()) != (1, 2):
            fail("not a mono 16-bit WAV")
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def disconnect_after_first_chunk(port: int, payload: dict, label: str):
    """Open a /tts/stream, read its headers and the start of its first
    chunk, and close the connection."""
    body = json.dumps(payload).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=900) as s:
        s.sendall(b"POST /tts/stream HTTP/1.1\r\nHost: localhost\r\nContent-Type: "
                  b"application/json\r\nContent-Length: " + str(len(body)).encode()
                  + b"\r\n\r\n" + body)
        got = b""
        while b"\r\n\r\n" not in got or len(got.split(b"\r\n\r\n", 1)[1]) < 64:
            chunk = s.recv(1 << 16)
            if not chunk:
                fail(f"[{label}] the stream closed before its first chunk: {got[:200]!r}")
            got += chunk
    if not got.startswith(b"HTTP/1.1 200"):
        fail(f"[{label}] the stream to leave answered {got[:200]!r}")


def tts_after_disconnect(port: int, payload: dict, label: str):
    """POST /tts until it is not refused as busy (429; the server notices a
    client gone at its next write), for up to 120 s: it must answer 200."""
    t0, busy = time.perf_counter(), 0
    while True:
        status, body = post_tts(port, payload)
        if status != 429 or time.perf_counter() - t0 > 120:
            break
        busy += 1
        time.sleep(0.1)
    if status != 200:
        fail(f"[{label}] after a client left mid-stream, /tts answered {status}: {body[:200]!r}")
    print(f"[{label}] a client left a stream after its first chunk; the next /tts answered "
          f"200 in {time.perf_counter() - t0:.3f} s ({busy} busy answers before it)")


def stream_phase(engine, wav_path: str, label: str, tmp: str, card: str):
    """Streaming and the sequential tail overlap on the float route, over
    the same engine (a sequential server from serve.build(engine=...)),
    with TARS_STAGE_SYNC unset (it turns the overlap off) and restored
    after. STREAM_TEXT (2 segments) through POST /tts/stream and POST /tts
    with runtime.seq_tail_overlap on and off in turns, one seed: all four
    PCMs bit-equal (the stream's last 200 ms the silence after its last
    segment). Then with quick_streaming_tokens 40 (3 segments of 40/120/40
    ids) through /tts/stream, overlap on and off in turns, STREAM_ROUNDS
    rounds: bit-equal. Each request prints its first chunk's seconds, wall
    and audio seconds. Then one segment keyed (the prompt's path) and
    unkeyed (its (audio, sr)) in turns, printing the gpt_decode stage;
    and, once, the host-timed parts of a segment's conditioning and
    prefill that the keyed route skips or shortens."""
    import torch

    from indextts_tpu_torch import serve
    from indextts_tpu_torch.runtime.engine import EmotionConditioning
    from indextts_tpu_torch.utils import audio as audio_utils

    t_phase = time.perf_counter()
    stage_sync = os.environ.pop("TARS_STAGE_SYNC", None)
    os.environ["TARS_CACHE_DIR"] = os.path.join(tmp, f"cache-{label}-stream")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg0 = engine.cfg
    server = thread = None
    try:
        server, _ = serve.build(["--host", "127.0.0.1", "--port", str(port),
                                 "--reference-audio", wav_path], engine=engine)
        if server.service is not None:
            fail(f"[{label}] the stream phase's server is not sequential")
        thread = ServerThread(server)
        c = cfg0
        segs = {q: [len(x) for x in serve.fallback_segments(
            STREAM_TEXT, c.gpt.number_text_tokens, c.runtime.max_text_tokens_per_segment,
            c.gpt.max_text_tokens, quick=q)] for q in (0, STREAM_QUICK)}
        print(f"[{label}] stream phase ({card}): segments of {segs[0]} ids, {segs[STREAM_QUICK]} "
              f"with quick_streaming_tokens {STREAM_QUICK}")
        n_sil = int(c.runtime.sampling_rate * c.runtime.interval_silence_ms / 1000)
        sr = c.runtime.sampling_rate

        def overlap(on: bool):
            engine.cfg = dataclasses.replace(cfg0, runtime=dataclasses.replace(
                cfg0.runtime, seq_tail_overlap=on))

        pcms = []
        for turn, (path, on) in enumerate((("/tts/stream", True), ("/tts", True),
                                           ("/tts", False), ("/tts/stream", False))):
            overlap(on)
            payload = {"text": STREAM_TEXT, "seed": 21, "turn": turn}  # no cached answer
            if path == "/tts":
                t0 = time.perf_counter()
                status, body = post_tts(port, payload)
                wall, first = time.perf_counter() - t0, None
                pcm = wav_pcm(body) if status == 200 else None
            else:
                status, first, wall, pcm = post_stream(port, payload)
                pcm = pcm[:-n_sil] if status == 200 and not pcm[-n_sil:].any() else None
            if status != 200 or pcm is None or not pcm.size:
                fail(f"[{label}] {path} (overlap {on}): HTTP {status}, or no PCM with a "
                     "trailing silence")
            pcms.append(pcm)
            print(f"[{label}] {path} overlap={on}: "
                  + (f"first_chunk_s={first:.3f} " if first is not None else "")
                  + f"wall_s={wall:.3f} audio_s={len(pcm) / sr:.3f}")
        if not all(np.array_equal(p, pcms[0]) for p in pcms):
            fail(f"[{label}] /tts and /tts/stream, overlap on and off: the PCMs differ")
        print(f"[{label}] /tts and /tts/stream, overlap on and off: the same "
              f"{len(pcms[0])} samples (the stream's trailing silence aside)")

        quick, decode_s = [], []
        finish = engine._finish_from_codes

        def record(spk, emovec, text_ids, codes, seed, t_gen):
            decode_s.append(t_gen)  # the tails run in segment order
            return finish(spk, emovec, text_ids, codes, seed, t_gen)

        engine._finish_from_codes = record
        for r in range(STREAM_ROUNDS):
            for on in ((True, False) if r % 2 == 0 else (False, True)):
                overlap(on)
                decode_s.clear()
                status, first, wall, pcm = post_stream(
                    port, {"text": STREAM_TEXT, "seed": 22,
                           "quick_streaming_tokens": STREAM_QUICK})
                if status != 200 or not pcm.size:
                    fail(f"[{label}] quick stream (overlap {on}): HTTP {status}")
                quick.append(pcm)
                print(f"[{label}] quick stream round {r} overlap={on}: first_chunk_s="
                      f"{first:.3f} wall_s={wall:.3f} audio_s={len(pcm) / sr:.3f}; "
                      "gpt_decode s by segment " + ", ".join(f"{x:.3f}" for x in decode_s))
        if not all(np.array_equal(p, quick[0]) for p in quick):
            fail(f"[{label}] the quick streams differ between overlap on and off")
        print(f"[{label}] quick streams, overlap on and off: the same {len(quick[0])} samples")
    finally:
        engine.cfg = cfg0
        engine.__dict__.pop("_finish_from_codes", None)
        if thread is not None:
            thread.stop()
        if stage_sync is not None:
            os.environ["TARS_STAGE_SYNC"] = stage_sync

    # keyed against unkeyed, one segment (inline), in turns
    audio = audio_utils.load_wav(wav_path)
    text = serve.fallback_segments(request_text(0), c.gpt.number_text_tokens,
                                   c.runtime.max_text_tokens_per_segment,
                                   c.gpt.max_text_tokens)[0]
    decode_s = {True: [], False: []}
    for r in range(STREAM_ROUNDS):
        for keyed in ((True, False) if r % 2 == 0 else (False, True)):
            out = engine.infer(wav_path if keyed else audio, [text], seed=DECODE_SEED)
            decode_s[keyed].append(out["stats"][0].gpt_gen_time)
    print(f"[{label}] gpt_decode stage s, keyed: "
          + ", ".join(f"{x:.3f}" for x in decode_s[True]) + "; unkeyed: "
          + ", ".join(f"{x:.3f}" for x in decode_s[False]) + f" ({card})")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    dec = engine.decoder
    spk = engine.prepare_speaker(*audio, cache_key=wav_path)
    emo = EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
    arrays = [engine._tensor(a) for a in dec.build_text_prompt_arrays(
        text[None], np.asarray([len(text)]), len(text))]
    parts = {}
    with torch.inference_mode():
        for _ in range(2):  # the second of each
            (_, conds), parts["merge_emovec + build_conds_latent"] = timed(
                lambda: engine.segment_conds(spk, emo))
            prefix, parts["cond_prefill"] = timed(lambda: dec.cond_prefill(conds))
            _, parts["monolithic prefill"] = timed(
                lambda: dec._prompt_prefill(conds, *arrays))
            _, parts["keyed prefill (tail)"] = timed(
                lambda: dec._prompt_prefill(conds, *arrays, prefix))
    print(f"[{label}] a segment's prompt work, host-timed with a synchronize each: "
          + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in parts.items()))
    print(f"[{label}] the stream phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 3, float route: the emotion controls and the Qwen3 text-to-emotion model
# ---------------------------------------------------------------------------


def qwen_prompt(system: str, user: str) -> list:
    """The stand-in tokenizer's encode (no Qwen tokenizer is in the repo):
    Qwen3's chat template with thinking off, as UTF-8 bytes, one id each."""
    text = (f"<|im_start|>system\n{system}<|im_end|>\n<|im_start|>user\n{user}<|im_end|>\n"
            "<|im_start|>assistant\n<think>\n\n</think>\n\n")
    return list(text.encode())


def qwen_text(ids) -> str:
    """The stand-in tokenizer's decode: each id as a printable character."""
    return "".join(chr(32 + int(i) % 95) for i in ids)


def qwen_margins(dec, ids, n: int) -> float:
    """The smallest top-2 logit margin of a greedy decode of n tokens."""
    import torch

    from indextts_tpu_torch.runtime.decode import cache_cap

    st = dec._state(cache_cap(len(ids), n))
    out = []
    with dec._lock, torch.inference_mode(), torch.cuda.stream(dec._stream):
        dec.prefill(st, ids)
        for _ in range(n):
            top = torch.topk(st.logits, 2).values
            out.append(float(top[0] - top[1]))
            dec.step(st)
    return min(out)


def qwen_small_check(card: str):
    """A small Qwen3 (QWEN_SMALL) from one seed on the card and on the CPU:
    the prefill's logits within QWEN_LOGIT_TOL of the largest |logit|
    (float32, no TF32, summed in another order), and QWEN_SMALL_TOKENS
    greedy tokens equal: the CPU's, the card's captured steps' and its
    eager steps'. The token embedding is scaled by 0.01: at PyTorch's
    default N(0, 1) the tied head echoes the prompt's last token at every
    step, whatever the blocks compute."""
    import torch

    from indextts_tpu_torch.config import QwenEmoConfig
    from indextts_tpu_torch.models.qwen3 import Qwen3LM, QwenDecoder

    torch.manual_seed(QWEN_SEED)
    cpu = Qwen3LM(QwenEmoConfig(**QWEN_SMALL)).eval().requires_grad_(False)
    cpu.model.embed_tokens.weight.mul_(0.01)
    gpu = copy.deepcopy(cpu).cuda()
    ids = qwen_prompt("文本情感分类", EMO_TEXT)
    with torch.inference_mode():
        want, _ = cpu(torch.tensor([ids]), torch.arange(len(ids)))
        got, _ = gpu(torch.tensor([ids], device="cuda"), torch.arange(len(ids), device="cuda"))
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    dec = QwenDecoder(gpu)
    toks = {"cpu": QwenDecoder(cpu).generate(ids, QWEN_SMALL_TOKENS, -1),
            "captured": dec.generate(ids, QWEN_SMALL_TOKENS, -1),
            "eager": dec.generate(ids, QWEN_SMALL_TOKENS, -1, eager=True)}
    margin = qwen_margins(QwenDecoder(cpu), ids, QWEN_SMALL_TOKENS)
    print(f"[qwen] small config {QWEN_SMALL} card against CPU: prefill logits max |diff| "
          f"{err:.2e} of the largest (tolerance {QWEN_LOGIT_TOL}); {QWEN_SMALL_TOKENS} greedy "
          f"tokens ({len(set(toks['cpu'].tolist()))} distinct), smallest top-2 margin "
          f"{margin:.4f} ({card})")
    if err > QWEN_LOGIT_TOL:
        fail(f"[qwen] the card's logits differ from the CPU's by {err:.2e} of the largest")
    if not all(np.array_equal(t, toks["cpu"]) for t in toks.values()):
        fail(f"[qwen] greedy tokens differ between the CPU, the captured and the eager steps: "
             f"{ {k: v.tolist() for k, v in toks.items()} }")


def qwen_full_width(card: str):
    """QwenEmoConfig (Qwen3-0.6B: 28 layers, 1024 wide, 16/8 heads of 128,
    vocab 151936) with seeded random weights made on the card, behind a
    QwenEmotion over the stand-in tokenizer (`qwen_prompt`, `qwen_text`).
    Prints the prefill's ms; the captured and the eager decode in turns,
    QWEN_ROUNDS rounds of QWEN_MAX_NEW and QWEN_EAGER_NEW tokens (random
    weights rarely emit eos), ms a token each (the generate call's wall less
    the prefill's, over its steps), the tokens of each the first captured
    decode's; a replay's device kernels (torch.profiler)
    against 16 replays timed with CUDA events, the idle share inside the
    step, and the step's bound (the weights once, and the KV cache's valid
    slots); the seconds of one inference() call and the vector it read.
    Returns the QwenEmotion."""
    import torch

    from indextts_tpu_torch.config import QwenEmoConfig
    from indextts_tpu_torch.models.qwen3 import Qwen3LM
    from indextts_tpu_torch.runtime.decode import cache_cap
    from indextts_tpu_torch.runtime.qwen_emo import QwenEmotion, make_generate_fn

    t_phase = time.perf_counter()
    qc = QwenEmoConfig()
    torch.manual_seed(QWEN_SEED)
    with torch.device("cuda"):
        model = Qwen3LM(qc).eval().requires_grad_(False)
    params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    qe = QwenEmotion(make_generate_fn(model, qwen_prompt, qwen_text, QWEN_EOS, QWEN_MAX_NEW))
    dec = qe.generate_fn.decoder
    ids = qwen_prompt(qe.prompt, EMO_TEXT)
    cap = cache_cap(len(ids), QWEN_MAX_NEW)
    print(f"[qwen] full width: {qc.num_hidden_layers} layers x {qc.hidden_size}, "
          f"{qc.num_attention_heads}/{qc.num_key_value_heads} heads of {qc.head_dim}, vocab "
          f"{qc.vocab_size}: {params / 1e6:.1f} M parameters, {weight_bytes / 1e9:.3f} GB "
          f"float32; prompt {len(ids)} ids, cache capacity {cap}")
    first = dec.generate(ids, QWEN_MAX_NEW, QWEN_EOS)  # the capture
    st = dec._states[cap]
    if st.graph is None:
        fail("[qwen] the decode step was not captured")

    def prefill_ms() -> float:
        with dec._lock, torch.inference_mode(), torch.cuda.stream(dec._stream):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            dec.prefill(st, ids)
            b.record()
            b.synchronize()
            return a.elapsed_time(b)

    pre = statistics.median(prefill_ms() for _ in range(3))
    print(f"[qwen] prefill of {len(ids)} ids: {pre:.3f} ms (CUDA events, median of 3; {card})")
    per_token = {False: [], True: []}
    for r in range(QWEN_ROUNDS):
        for eager in ((False, True) if r % 2 == 0 else (True, False)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = dec.generate(ids, QWEN_EAGER_NEW if eager else QWEN_MAX_NEW, QWEN_EOS,
                                eager=eager)
            wall = time.perf_counter() - t0
            ms = (wall * 1e3 - pre) / max(1, len(toks) - 1)
            per_token[eager].append(ms)
            print(f"[qwen] decode round {r} {'eager' if eager else 'captured'}: {len(toks)} "
                  f"tokens in {wall:.3f} s, {ms:.3f} ms a token after the prefill ({card})")
            if not np.array_equal(toks, first[:len(toks)]):
                fail(f"[qwen] round {r} ({'eager' if eager else 'captured'}): tokens differ "
                     "from the first captured decode's")
    print(f"[qwen] captured and eager decode: the same tokens in all {2 * QWEN_ROUNDS + 1} "
          f"runs ({len(first)} captured, the first {min(len(first), QWEN_EAGER_NEW)} eager)")
    with dec._lock, torch.inference_mode(), torch.cuda.stream(dec._stream):
        dec.prefill(st, ids)  # room for the replays below: S + 18 < cap
        kernels = step_kernels(st.graph.replay)
        valid = int(st.valid)
        replay_ms = replays_ms(st.graph, 16)
    n_k, ms_k = sum(v[0] for v in kernels.values()), sum(v[1] for v in kernels.values())
    kv_bytes = 2 * qc.num_hidden_layers * qc.num_key_value_heads * valid * qc.head_dim * 4
    bound_w = weight_bytes / HBM_BYTES_PER_S * 1e3
    bound_kv = (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    print(f"[qwen] step: 16 replays back to back {replay_ms:.4f} ms a step (CUDA events); one "
          f"replay's {n_k} device kernels {ms_k:.4f} ms, idle inside the step "
          f"{100 * (1 - ms_k / replay_ms):.1f} %; bound {bound_w:.3f} ms for the weights "
          f"({weight_bytes / 1e9:.3f} GB at 3.35 TB/s), {bound_kv:.3f} ms with the KV cache's "
          f"{valid} valid slots; in the decode loop captured "
          + ", ".join(f"{x:.3f}" for x in per_token[False]) + " ms a token, eager "
          + ", ".join(f"{x:.3f}" for x in per_token[True]) + f" ({card})")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
    print("[qwen] one replay's kernels by device ms: " + ", ".join(
        f"{short_name(k)} x{n} {ms:.4f}" for k, (n, ms) in top))
    t0 = time.perf_counter()
    vec = qe.inference(EMO_TEXT)
    print(f"[qwen] one inference() call: {time.perf_counter() - t0:.3f} s ({card}); the vector "
          f"it read: {vec}; the Qwen phase took {time.perf_counter() - t_phase:.1f} s")
    return qe


def emotion_banks(engine, wav_path: str):
    """The engine's emotion banks, loaded from the checkpoint directory
    (seeded random rows of the real shapes: `reference_dir`), with the
    emotion rows (73 x 1280 at the default config) scaled to the spread of
    the speaker prompt's own emovec; the speaker rows (73 x 192) as loaded."""
    from indextts_tpu_torch.runtime.engine import EmotionConditioning
    from indextts_tpu_torch.utils import audio as audio_utils

    c = engine.cfg
    spk = engine.prepare_speaker(*audio_utils.load_wav(wav_path), cache_key=wav_path)
    emovec, _ = engine.segment_conds(spk, EmotionConditioning(spk.spk_cond_emb, spk.cond_len))
    scale = float(emovec.std())
    engine.emo_matrix = [scale * m for m in engine.emo_matrix]
    return sum(c.emo_num), c.gpt.model_dim


def emotion_phase(engine, wav_path: str, label: str, tmp: str, card: str, rise, stay):
    """The emotion controls on the float route's engine, after the stream
    phase. `qwen_small_check` and `qwen_full_width`; random banks of the
    real shapes (`emotion_banks`). Then, through a sequential server over
    the engine (every counter set to 0 just before the requests and read
    just after: `rise` must have risen, `stay` stayed 0): POST /tts with
    EMO_VECTOR twice (the first makes the key (prompt path, "", 1.0,
    vector), the second must hit it: no segment_conds call), a /tts
    without a vector (keyed), each printing its gpt_decode stage, and
    one unkeyed infer() with the vector ((audio, sr)); one /tts/stream
    with EMO_VECTOR; /tts with use_emo_text and no Qwen attached (400),
    then with the full-width Qwen attached (200), printing the vector it
    chose and the Qwen's seconds. Every answer a valid non-silent WAV or
    PCM, every mel finite. The Qwen is freed after: the device memory it
    releases must hold its weights."""
    import torch

    from indextts_tpu_torch import serve
    from indextts_tpu_torch.serve import fallback_segments
    from indextts_tpu_torch.utils import audio as audio_utils

    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    qwen_small_check(card)
    qe = qwen_full_width(card)
    rows, width = emotion_banks(engine, wav_path)
    os.environ["TARS_CACHE_DIR"] = os.path.join(tmp, f"cache-{label}-emotion")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server, _ = serve.build(["--host", "127.0.0.1", "--port", str(port),
                             "--reference-audio", wav_path], engine=engine)
    if server.service is not None:
        fail(f"[{label}] the emotion phase's server is not sequential")
    thread = ServerThread(server)
    conds_calls, decode_s = [], []
    segment_conds, finish = engine.segment_conds, engine._finish_from_codes

    def conds_spy(*a, **kw):
        conds_calls.append(a[3] if len(a) > 3 else kw.get("emo_vector"))
        return segment_conds(*a, **kw)

    def record(spk, emovec, text_ids, codes, seed, t_gen):
        decode_s.append(t_gen)
        return finish(spk, emovec, text_ids, codes, seed, t_gen)

    engine.segment_conds, engine._finish_from_codes = conds_spy, record
    engine._mel_taps = []
    counters = kernel_counters()
    for cnt in counters.values():
        cnt.launches = 0
    key = (wav_path, "", 1.0, tuple(EMO_VECTOR))
    try:
        engine._emoconds_cache.pop(key, None)
        gpt_decode = {}
        for name, payload in (("vector, first", {"emo_vector": EMO_VECTOR}),
                              ("vector, keyed hit", {"emo_vector": EMO_VECTOR, "turn": 1}),
                              ("no vector, keyed", {})):
            conds_calls.clear()
            decode_s.clear()
            status, body = post_tts(port, {"text": request_text(0), "seed": DECODE_SEED,
                                           **payload})
            pcm = wav_pcm(body) if status == 200 else None
            if pcm is None or not pcm.size or not np.abs(pcm.astype(np.int32)).max():
                fail(f"[{label}] emotion /tts ({name}): HTTP {status}, or silent: {body[:200]!r}")
            gpt_decode[name] = decode_s[0]
            if name == "vector, first" and (conds_calls != [EMO_VECTOR]
                                            or key not in engine._emoconds_cache):
                fail(f"[{label}] the first emo_vector request made no key {key}")
            if name == "vector, keyed hit" and conds_calls:
                fail(f"[{label}] the second emo_vector request missed its key")
        audio = audio_utils.load_wav(wav_path)
        text = fallback_segments(request_text(0), engine.cfg.gpt.number_text_tokens,
                                 engine.cfg.runtime.max_text_tokens_per_segment,
                                 engine.cfg.gpt.max_text_tokens)[0]
        decode_s.clear()
        engine.infer(audio, [text], emo_vector=EMO_VECTOR, seed=DECODE_SEED)
        gpt_decode["vector, unkeyed"] = decode_s[0]
        print(f"[{label}] emotion banks {rows} x {width} and {rows} x 192; /tts with emo_vector "
              f"{EMO_VECTOR}: gpt_decode s " + ", ".join(
                  f"{k} {v:.3f}" for k, v in gpt_decode.items()) + f" ({card})")
        status, first, wall, pcm = post_stream(port, {"text": STREAM_TEXT, "seed": 41,
                                                      "emo_vector": EMO_VECTOR})
        if status != 200 or not pcm.size or not np.abs(pcm.astype(np.int32)).max():
            fail(f"[{label}] emotion /tts/stream: HTTP {status}, or silent")
        print(f"[{label}] /tts/stream with emo_vector: first_chunk_s={first:.3f} "
              f"wall_s={wall:.3f} audio_s={len(pcm) / 22050:.3f} ({card})")
        payload = {"text": request_text(1), "seed": DECODE_SEED, "use_emo_text": True}
        status, body = post_tts(port, payload)
        if status != 400 or b"no Qwen emotion model" not in body:
            fail(f"[{label}] use_emo_text without a Qwen answered {status}: {body[:200]!r}")
        print(f"[{label}] /tts with use_emo_text and no Qwen attached: 400 {body.decode()}")
        read, inference = [], qe.inference

        def timed_inference(text_input):
            t0 = time.perf_counter()
            read.append(inference(text_input))
            read.append(time.perf_counter() - t0)
            return read[0]

        qe.inference = timed_inference
        engine.qwen_emo = qe
        t0 = time.perf_counter()
        status, body = post_tts(port, {**payload, "turn": 1})
        wall = time.perf_counter() - t0
        pcm = wav_pcm(body) if status == 200 else None
        if pcm is None or not pcm.size or len(read) != 2:
            fail(f"[{label}] use_emo_text with the Qwen attached: HTTP {status}: {body[:200]!r}")
        print(f"[{label}] /tts with use_emo_text and the full-width Qwen attached: the vector "
              f"{list(read[0].values())}, the Qwen {read[1]:.3f} s of the request's "
              f"{wall:.3f} s ({card})")
    finally:
        launches = {name: cnt.launches for name, cnt in counters.items()}
        thread.stop()
        engine.qwen_emo = None
        engine.__dict__.pop("segment_conds", None)
        engine.__dict__.pop("_finish_from_codes", None)
    mels = engine._mel_taps
    engine._mel_taps = None
    if not mels or not all(np.isfinite(m).all() for m in mels):
        fail(f"[{label}] the emotion requests' mels are missing or not finite")
    for name, n in launches.items():
        if name in rise and n == 0:
            fail(f"[{label}] emotion requests: {name} was never launched")
        if name in stay and n != 0:
            fail(f"[{label}] emotion requests: {name} was launched {n} times; it has no "
                 "place on this path")
    print(f"[{label}] emotion requests' launches: " + ", ".join(
        f"{name.split()[0]} {n}" for name, n in launches.items()))
    weights = sum(p.nbytes for p in qe.generate_fn.decoder.model.parameters())
    allocated = torch.cuda.memory_allocated()
    del qe, inference, timed_inference
    gc.collect()
    torch.cuda.empty_cache()
    released = allocated - torch.cuda.memory_allocated()
    print(f"[{label}] the emotion phase took {time.perf_counter() - t_phase:.1f} s; freeing "
          f"the Qwen released {released / 2**30:.2f} GiB (its weights {weights / 2**30:.2f}); "
          f"device memory allocated {held / 2**30:.2f} GiB before the phase, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} after it")
    if released < weights:
        fail(f"[{label}] freeing the Qwen released {released} bytes, less than its weights")


def emotion_continuous(port: int, engine, label: str, card: str):
    """One /tts with EMO_VECTOR through the continuous server: a valid
    non-silent WAV, the vector handed to segment_conds for each segment
    (the service's submit)."""
    seen, segment_conds = [], engine.segment_conds

    def spy(*a, **kw):
        seen.append(a[3] if len(a) > 3 else kw.get("emo_vector"))
        return segment_conds(*a, **kw)

    engine.segment_conds = spy
    try:
        t0 = time.perf_counter()
        status, body = post_tts(port, {"text": request_text(34), "seed": 34,
                                       "emo_vector": EMO_VECTOR})
        wall = time.perf_counter() - t0
    finally:
        engine.__dict__.pop("segment_conds", None)
    pcm = wav_pcm(body) if status == 200 else None
    if pcm is None or not pcm.size or not np.abs(pcm.astype(np.int32)).max():
        fail(f"[{label}] continuous /tts with emo_vector: HTTP {status}, or silent")
    if not seen or any(v != EMO_VECTOR for v in seen):
        fail(f"[{label}] continuous /tts with emo_vector: segment_conds saw {seen}")
    print(f"[{label}] continuous /tts with emo_vector {EMO_VECTOR}: wall_s={wall:.3f} "
          f"audio_s={len(pcm) / 22050:.3f} ({card})")


# ---------------------------------------------------------------------------
# phase 4: continuous batching (runtime/batcher.py)
# ---------------------------------------------------------------------------


def slot_tensors(st):
    """Every buffer of a SlotState, cloned."""
    import torch

    with torch.inference_mode():
        return [t.clone() for t in st.tensors()]


def set_slots(st, snap, seed: int):
    import torch

    with torch.inference_mode():
        for t, s in zip(st.tensors(), snap):
            t.copy_(s)
    st.generator.manual_seed(seed)


def batched_step_check(engine, wav_path: str, label: str):
    """(a) A 4-slot state at full width, on a decoder of its own over the
    served engine's GPT: rows admitted 17, 9 and 5 steps apart (unequal
    positions) with texts of 12, 47, 90 and 120 ids in the serving bucket of
    120 (unequal holes). One batched greedy step's logits against each
    row's single-row step on a copy of its caches (`SlotState.row`); the
    codes picked must be equal. Then, from one state and seed, CONT_STEPS
    sampling steps eagerly and captured (the capture taken while a tail,
    latent pass + s2mel + BigVGAN, runs on another thread) must leave every
    buffer the same bits, and a replay must run the eager step's device
    kernels by name and count, less the generator's two fills. 8 replays
    are timed with CUDA events."""
    import torch

    from indextts_tpu_torch.runtime.batcher import ContinuousBatcher
    from indextts_tpu_torch.runtime.decode import GPTDecoder
    from indextts_tpu_torch.runtime.engine import EmotionConditioning
    from indextts_tpu_torch.serve import fallback_segments
    from indextts_tpu_torch.utils import audio as audio_utils

    c, rt = engine.cfg, engine.cfg.runtime
    quantized = rt.gpt_quantize
    dec = GPTDecoder(engine.gpt, c.gpt, engine.decoder.sampling, kv_int8=engine.decoder.kv_int8)
    bat = ContinuousBatcher(dec, n_slots=4, text_bucket=rt.max_text_tokens_per_segment,
                            max_new=rt.max_mel_tokens, chunk_steps=CONT_STEPS, seed=1)
    st = bat.state
    spk = engine.prepare_speaker(*audio_utils.load_wav(wav_path), cache_key=wav_path)
    emo = EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
    ids = fallback_segments(request_text(0) * 4, c.gpt.number_text_tokens,
                            rt.max_text_tokens_per_segment, c.gpt.max_text_tokens)[0]
    emovec, conds = engine.segment_conds(spk, emo)
    torch.cuda.synchronize()  # conds come from the default stream
    with torch.inference_mode(), dec.on_stream():
        for n_text, steps in zip((12, 47, 90, 120), (17, 9, 5, 0)):
            bat.submit(conds, ids[:n_text])
            bat._admit()
            dec.step_chunk(st, steps, False, eager=True)
        rows = [st.row(b) for b in range(4)]
        dec.slot_step(st, False)
        errs = []
        for b, one in enumerate(rows):
            dec.slot_step(one, False)
            scale = float(one.logits.abs().max())
            errs.append(float((one.logits[0] - st.logits[b]).abs().max()) / scale)
            if not torch.equal(one.codes[0], st.codes[b]):
                fail(f"[{label}] batched step: row {b} picked another code than its "
                     "single-row step")
    torch.cuda.synchronize()
    pos, holes = st.pos.tolist(), list(zip(st.hole_s.tolist(), st.hole_e.tolist()))
    # float32: cuBLAS sums a 4-row product in another order than a 1-row
    # one, through 24 layers: 1e-4 of the row's largest logit. Quantized:
    # K4-K8 and the int8 head are exact per row (int32 sums, the same
    # epilogue), but one float difference before a row's int8 rounding
    # moves it by up to 1/127 of the row's largest value: 1e-2
    tol = 1e-2 if quantized else 1e-4
    print(f"[{label}] batched step (4 slots, pos {pos}, holes {holes}) against each row's "
          f"single-row step: logits max_abs_err {', '.join(f'{e:.3g}' for e in errs)} "
          f"of each row's largest (tol {tol:g} relative); codes equal")
    if max(errs) > tol:
        fail(f"[{label}] a batched step's logits disagree with the single-row steps'")
    captured_batched_step(engine, dec, st, spk, emovec, ids, label)
    slot_step_times(engine, dec, conds, ids, label)
    return dec


def captured_batched_step(engine, dec, st, spk, emovec, ids, label: str):
    """`batched_step_check`'s captured-against-eager half."""
    import torch

    c = engine.cfg
    snap = slot_tensors(st)
    codes = np.random.default_rng(0).integers(0, c.gpt.stop_mel_token, 120)
    runs = []
    with ThreadPoolExecutor(1) as pool:
        for eager in (True, False, False):
            set_slots(st, snap, 5)
            tail = pool.submit(engine._finish_from_codes, spk, emovec, ids[:12], codes, 0, 0.0)
            with torch.inference_mode(), dec.on_stream():
                dec.step_chunk(st, CONT_STEPS, True, eager=eager)
            # not torch.cuda.synchronize(): the tail may be capturing its
            # s2mel graph, and a device-wide wait would end that capture
            dec._stream.synchronize()
            tail.result(timeout=300)
            runs.append(slot_tensors(st))
    same = [all(torch.equal(a, b) for a, b in zip(r, runs[0])) for r in runs[1:]]
    print(f"[{label}] {CONT_STEPS} batched sampling steps from one state and seed: captured "
          f"(the capture beside a running tail) and replayed equal eager to the bit: {same}")
    if not all(same):
        fail(f"[{label}] a captured batched step disagrees with the eager one")
    graph = st.graphs[True][0]
    with torch.inference_mode(), dec.on_stream():
        eager_k, graph_k, rng, counts = replay_against_eager(
            lambda: dec.slot_step(st, True), graph, True, label, tries=5)
        replay_ms = replays_ms(graph, 8)
    n_k, ms_k = (sum(v[i] for v in graph_k.values()) for i in (0, 1))
    print(f"[{label}] one batched step (4 slots): {sum(counts[0].values())} device kernels "
          f"eager, {n_k} a replay ({ms_k:.4f} device ms), of which the generator's state "
          f"before the launch: " + (", ".join(f"{short_name(k)} x{n}" for k, n in rng.items())
                                    or "none") + f"; 8 replays: {replay_ms:.4f} ms a "
          f"step (CUDA events), idle inside the step {100 * (1 - ms_k / replay_ms):.1f} %")
    if counts[0] != counts[1]:
        fail(f"[{label}] a batched replay's device kernels differ from an eager step's: "
             f"{kernel_diff(counts)} (the generator's, taken off the replay's: {rng})")


def slot_step_times(engine, dec, conds, ids, label: str):
    """The captured batched sampling step at 1 and CONT_REQUESTS slots (4
    are timed by `captured_batched_step`),
    each row admitted 3 steps after the one before (unequal positions and,
    with texts of 12 + 13 b ids, unequal holes): 8 replays timed with CUDA
    events, and one replay's device kernels (torch.profiler)."""
    import torch

    from indextts_tpu_torch.runtime.batcher import ContinuousBatcher

    rt = engine.cfg.runtime
    for n_slots in (1, CONT_REQUESTS):
        bat = ContinuousBatcher(dec, n_slots=n_slots, text_bucket=rt.max_text_tokens_per_segment,
                                max_new=rt.max_mel_tokens, chunk_steps=2, seed=2)
        st = bat.state
        with torch.inference_mode(), dec.on_stream():
            for b in range(n_slots):
                bat.submit(conds, ids[:12 + 13 * b])
                bat._admit()
                dec.step_chunk(st, 3, True, eager=True)
            dec.step_chunk(st, 2, True)  # one eager step, the capture, a replay
            graph = st.graphs[True][0]
            kernels = step_kernels(graph.replay)
            ms = replays_ms(graph, 8)
        n_k, ms_k = (sum(v[i] for v in kernels.values()) for i in (0, 1))
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
        print(f"[{label}] batched step at {n_slots} slots (pos {st.pos.tolist()}): {ms:.4f} ms "
              f"a step over 8 replays (CUDA events), {1e3 * n_slots / ms:.1f} tokens/s if every "
              f"row decodes; a replay: {n_k} device kernels, {ms_k:.4f} device ms; largest: "
              + ", ".join(f"{short_name(k)} x{n} {t:.4f}" for k, (n, t) in top))
        del bat, st, graph
        gc.collect()


def post_batch(port: int, payloads, label: str, mode: str, results):
    """POST `payloads` to /tts at once, one thread each; every answer must
    be a 200 with a mono 16-bit WAV of finite samples as long as the
    waveform its segment's tail made (`results`, by seed). Returns (wall
    s of the batch, each request's wall s, audio s in all)."""
    walls, answers = [0.0] * len(payloads), [None] * len(payloads)

    def one(i):
        t0 = time.perf_counter()
        answers[i] = post_tts(port, payloads[i])
        walls[i] = time.perf_counter() - t0

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(payloads))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    audio = 0.0
    for i, (status, body) in enumerate(answers):
        if status != 200:
            fail(f"[{label}] {mode} request {i}: HTTP {status}: {body[:300]!r}")
        with wave.open(io.BytesIO(body)) as w:
            if (w.getnchannels(), w.getsampwidth()) != (1, 2):
                fail(f"[{label}] {mode} request {i}: not a mono 16-bit WAV")
            sr, n = w.getframerate(), w.getnframes()
            pcm = np.frombuffer(w.readframes(n), dtype=np.int16)
        seg = results.get(payloads[i]["seed"])
        if seg is None or n != len(seg.wav) or n == 0 or not np.isfinite(seg.wav).all():
            fail(f"[{label}] {mode} request {i}: {n} samples, not its tail's waveform")
        if int(np.abs(pcm.astype(np.int32)).max()) == 0:
            fail(f"[{label}] {mode} request {i}: silent audio")
        audio += n / sr
    return wall, walls, audio


def serve_continuous(wav_path: str, engine, label: str, rise, stay, tmp: str, card: str):
    """The route's engine served in continuous mode: the server built over
    it with TARS_MAX_CONCURRENCY=8, so TARS_CONTINUOUS_SLOTS "auto" gives 8
    slots, chunks of 32 steps, 2 tail workers; `batched_step_check` on the
    engine; then CONT_REQUESTS
    concurrent /tts requests through the continuous server and the same
    ones through a sequential server over the same engine, in turns
    (continuous, then sequential, each turn with fresh seeds, so no answer
    comes from a response cache). A continuous turn's stage seconds count
    from a segment's submit to its tail's start (`submit_to_tail`: queue,
    decode and the wait for a tail worker), as the JAX service passes them. Every counter is set to 0 just
    before each continuous turn and read just after: those in `rise` must
    have risen, those in `stay` must be 0. K6/K8's per-stream arrival
    counters made in this phase must belong to decoder streams only."""
    import torch

    from indextts_tpu_torch import serve
    from indextts_tpu_torch.ops import gemv
    from indextts_tpu_torch.runtime.server import ServerSettings, TTSServer

    os.environ["TARS_CACHE_DIR"] = os.path.join(tmp, f"cache-{label}-continuous")
    os.environ["TARS_MAX_CONCURRENCY"] = str(CONT_REQUESTS)
    arrived = set(gemv._arrived)
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        server, _ = serve.build(["--host", "127.0.0.1", "--port", str(ports[0]),
                                 "--reference-audio", wav_path], engine=engine)
    finally:
        del os.environ["TARS_MAX_CONCURRENCY"]
    svc = server.service
    if svc is None or svc.bat.B != CONT_REQUESTS:
        fail(f"[{label}] TARS_MAX_CONCURRENCY={CONT_REQUESTS} did not give "
             f"{CONT_REQUESTS} continuous slots")
    torch.cuda.synchronize()
    bat = svc.bat
    st_bytes = sum(t.nbytes for t in bat.state.tensors())
    print(f"[{label}] continuous server (TARS_MAX_CONCURRENCY={CONT_REQUESTS}, "
          f"TARS_CONTINUOUS_SLOTS auto -> {bat.B} slots, chunk {bat.chunk}, tail workers 2) "
          f"built and warmed up in {time.perf_counter() - t0:.1f} s; slot state: cap "
          f"{bat.cap} (S {bat.prompt_len} + max_new {bat.max_new}), "
          f"{st_bytes / 2**20:.1f} MiB")
    t_check = time.perf_counter()
    check_dec = batched_step_check(engine, wav_path, label)
    t_serve = time.perf_counter()
    print(f"[{label}] batched step checks and times took {t_serve - t_check:.1f} s")
    sequential = TTSServer(serve.make_synth(engine, wav_path), ServerSettings(
        host="127.0.0.1", port=ports[1], max_concurrency=CONT_REQUESTS,
        cache_dir=os.path.join(tmp, f"cache-{label}-sequential")))
    results = {}
    finish = engine._finish_from_codes

    def record(spk, emovec, text_ids, codes, seed, *rest):
        results[seed] = finish(spk, emovec, text_ids, codes, seed, *rest)
        return results[seed]

    engine._finish_from_codes = record
    threads = [ServerThread(server), ServerThread(sequential)]
    counters = kernel_counters()
    step_names = [k for k in counters if k[:2] in ("K1", "K4", "K5", "K6", "K7", "K8")]
    try:
        post_tts(ports[1], {"text": request_text(99), "seed": 99})  # capture the B=1 step
        for turn, mode in enumerate(("continuous", "sequential")):
            payloads = [{"text": request_text(i), "seed": 1000 * turn + i}
                        for i in range(CONT_REQUESTS)]
            dec = svc.decoder if mode == "continuous" else engine.decoder
            tok0, sec0, chunks0 = (bat.tokens, bat.seconds, bat.chunks) if mode == "continuous" \
                else (dec.tokens, dec.seconds, 0)
            for cnt in counters.values():
                cnt.launches = 0
            wall, walls, audio = post_batch(ports[0] if mode == "continuous" else ports[1],
                                            payloads, label, mode, results)
            launches = {name: cnt.launches for name, cnt in counters.items()}
            if mode == "continuous":
                toks, dsec, chunks = bat.tokens - tok0, bat.seconds - sec0, bat.chunks - chunks0
            else:
                toks, dsec, chunks = dec.tokens - tok0, dec.seconds - sec0, 0
            print(f"[{label}] {mode} turn {turn} ({card}): {CONT_REQUESTS} concurrent requests, wall "
                  f"{wall:.3f} s, audio {audio:.3f} s, aggregate audio_s_per_wall_s="
                  f"{audio / wall:.3f}, decode_tokens={toks} aggregate decode_tok_per_s="
                  f"{toks / wall:.1f} (per second in the decode loop {toks / dsec:.1f}), "
                  f"request wall p50 {statistics.median(walls):.3f} s max {max(walls):.3f} s"
                  + (f", chunks={chunks}" if chunks else ""))
            segs = [results[p["seed"]] for p in payloads]
            print(f"[{label}] {mode} turn {turn} stages_s mean / max over the requests: "
                  + ", ".join(f"{name} {statistics.mean(v):.3f} / {max(v):.3f}" for name, v in (
                      ("submit_to_tail" if mode == "continuous" else "gpt_decode",
                       [r.gpt_gen_time for r in segs]),
                      ("gpt_latent", [r.gpt_forward_time for r in segs]),
                      ("s2mel", [r.s2mel_time for r in segs]),
                      ("bigvgan", [r.bigvgan_time for r in segs]))))
            if mode != "continuous":
                continue
            print(f"[{label}] continuous turn {turn} launches per chunk: " + ", ".join(
                f"{name.split()[0]} {launches[name] / chunks:.1f}" for name in step_names))
            for name, n in launches.items():
                if name in rise and n == 0:
                    fail(f"[{label}] continuous: {name} was never launched")
                if name in stay and n != 0:
                    fail(f"[{label}] continuous: {name} was launched {n} times; it has no "
                         "place on this path")
        if label == "float":
            status, first, wall, pcm = post_stream(
                ports[0], {"text": STREAM_TEXT, "seed": 31,
                           "quick_streaming_tokens": STREAM_QUICK})
            if status != 200 or not pcm.size or not np.abs(pcm.astype(np.int32)).max():
                fail(f"[{label}] continuous /tts/stream: HTTP {status}, or silent")
            print(f"[{label}] continuous /tts/stream ({card}): first_chunk_s={first:.3f} "
                  f"wall_s={wall:.3f} audio_s={len(pcm) / 22050:.3f}")
            disconnect_after_first_chunk(ports[0], {"text": STREAM_TEXT, "seed": 32}, label)
            tts_after_disconnect(ports[0], {"text": request_text(33), "seed": 33}, label)
            emotion_continuous(ports[0], engine, label, card)
    finally:
        for th in threads:
            th.stop()
        svc.shutdown()
        engine._finish_from_codes = finish
    print(f"[{label}] serving turns took {time.perf_counter() - t_serve:.1f} s; the "
          f"continuous phase {time.perf_counter() - t0:.1f} s")
    print(f"[{label}] continuous phase peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    ours = {(torch.cuda.current_device(), d._stream.cuda_stream)
            for d in (svc.decoder, engine.decoder, check_dec)}
    # torch.cuda.Stream() hands out PyTorch's pooled streams in turn, so a
    # decoder's stream may be one that an earlier engine's decoder held,
    # counters and all: on a route without K6/K8 no counter may be made in
    # this phase, on one with them the service decoder's stream must have one
    made = set(gemv._arrived) - arrived
    fused = any(name[:2] in ("K6", "K8") for name in rise)
    svc_key = (torch.cuda.current_device(), svc.decoder._stream.cuda_stream)
    if not made <= ours or (made and not fused) or (fused and svc_key not in gemv._arrived):
        fail(f"[{label}] fused-MLP arrival counters on streams other than the decoders' "
             f"({made - ours}), made on a route without K6/K8 ({made}), or none for the "
             "service's decoder")
    print(f"[{label}] K6/K8 arrival counters made in this phase: {len(made)}, all on "
          f"decoder streams; the service decoder's stream has its own: {svc_key in gemv._arrived}")


# ---------------------------------------------------------------------------
# the decoder's sampling knobs (runtime/decode.py SamplingConfig) and
# parallel/ (torch.distributed) at full width
# ---------------------------------------------------------------------------


def sampling_phase(engine, wav_path: str, label: str, card: str) -> None:
    """Phase `sampling_phase`, on the float route's engine: decoders over its
    GPT (full width) with the JAX SamplingConfig's knobs, on the speaker
    prompt's conds and request 0's text. `ban_stop_token` decodes exactly
    MAX_MEL_TOKENS codes, none of them the stop code, captured; greedy
    decode captured against eager with each knob flipped on its own
    (SAMPLING_KNOBS), SAMPLING_CHECK_NEW codes, the same codes; a sampled
    decode with the typical filter, captured against eager from one seed,
    the same codes; then a captured step with the typical filter against
    one without (both banning the stop code, their states after 300
    codes), replays timed with CUDA events in turns."""
    import torch

    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig
    from indextts_tpu_torch.runtime.engine import EmotionConditioning
    from indextts_tpu_torch.serve import fallback_segments
    from indextts_tpu_torch.utils import audio as audio_utils

    t0 = time.perf_counter()
    c, rt = engine.cfg, engine.cfg.runtime
    stop = c.gpt.stop_mel_token
    spk = engine.prepare_speaker(*audio_utils.load_wav(wav_path), cache_key=wav_path)
    emo = EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
    ids = fallback_segments(request_text(0), c.gpt.number_text_tokens,
                            c.runtime.max_text_tokens_per_segment, c.gpt.max_text_tokens)[0]
    _, conds, _ = engine._segment_inputs(spk, emo, 1.0, None, seed=SAMPLING_SEED)
    arrays = [torch.as_tensor(a, device=engine.device)
              for a in engine.decoder.build_text_prompt_arrays(
                  np.asarray(ids)[None], np.asarray([len(ids)]), len(ids))]
    kw = dict(temperature=rt.temperature, top_p=rt.top_p,
              repetition_penalty_value=rt.repetition_penalty)

    def decoder(**knobs):
        return GPTDecoder(engine.gpt, c.gpt, SamplingConfig(top_k=rt.top_k, **knobs),
                          kv_int8=engine.decoder.kv_int8, attn_impl=engine.decoder.attn_impl)

    def run(dec, max_new, seed=None, eager=False):
        res = dec.generate(conds, *arrays, seed, max_new=max_new, eager=eager, **kw)
        return res.codes[0].cpu().numpy(), int(res.lengths[0])

    banned = decoder(ban_stop_token=True)
    codes, n = run(banned, MAX_MEL_TOKENS, SAMPLING_SEED)
    free_n = run(decoder(), MAX_MEL_TOKENS, SAMPLING_SEED)[1]
    print(f"[{label}] sampling: ban_stop_token decodes {n} codes of {MAX_MEL_TOKENS} "
          f"(stop codes among them: {int((codes == stop).sum())}); without the ban the "
          f"same seed decodes {free_n}")
    if n != MAX_MEL_TOKENS or (codes == stop).any():
        fail(f"[{label}] sampling: ban_stop_token gave {n} codes, "
             f"{int((codes == stop).sum())} of them stop")
    base = run(decoder(do_sample=False), SAMPLING_CHECK_NEW)[0]
    for knobs in SAMPLING_KNOBS:
        dec = decoder(do_sample=False, **knobs)
        (graph, n_g), (eager, n_e) = run(dec, SAMPLING_CHECK_NEW), run(
            dec, SAMPLING_CHECK_NEW, eager=True)
        print(f"[{label}] sampling greedy {knobs}: captured {n_g} codes, eager {n_e}, "
              f"equal {np.array_equal(graph, eager)}; differs from the default greedy "
              f"row: {not np.array_equal(graph, base)}")
        if not np.array_equal(graph, eager):
            fail(f"[{label}] sampling greedy {knobs}: captured and eager codes differ")
    typical = decoder(use_typical_sampling=True)
    (graph, n_g), (eager, n_e) = (run(typical, SAMPLING_CHECK_NEW, SAMPLING_SEED),
                                  run(typical, SAMPLING_CHECK_NEW, SAMPLING_SEED, eager=True))
    print(f"[{label}] sampling with the typical filter, seed {SAMPLING_SEED}: captured "
          f"{n_g} codes, eager {n_e}, equal {np.array_equal(graph, eager)}")
    if not np.array_equal(graph, eager):
        fail(f"[{label}] sampling: captured and eager typical sampling differ")

    typical_banned = decoder(ban_stop_token=True, use_typical_sampling=True)
    if run(typical_banned, MAX_MEL_TOKENS, SAMPLING_SEED)[1] != MAX_MEL_TOKENS:
        fail(f"[{label}] sampling: typical + ban_stop_token stopped early")
    steps = {}
    for dec in (banned, typical_banned):
        st = next(reversed(dec._states.values()))
        if int(st.start) + int(st.step) + 4 * 8 >= st.cap:
            fail(f"[{label}] sampling: no room in the cache to time steps")
        steps[dec] = (st.graphs[True][0], [])
    for dec in (banned, typical_banned, typical_banned, banned):
        graph, times = steps[dec]
        with dec._lock, torch.inference_mode(), torch.cuda.stream(dec._stream):
            times.append(replays_ms(graph, 8))
    (plain_ms, typical_ms) = (statistics.mean(steps[d][1]) for d in (banned, typical_banned))
    print(f"[{label}] sampling: a captured sampling step (GPT 24L x 1280, ban_stop_token) "
          f"{plain_ms:.4f} ms without the typical filter, {typical_ms:.4f} ms with it "
          f"(log_softmax, a stable argsort over {c.gpt.number_mel_codes}, cumsum, scatter): "
          f"+{typical_ms - plain_ms:.4f} ms a step; 8 replays a turn, two turns each, CUDA "
          f"events; {card}")
    print(f"[{label}] sampling_phase done in {time.perf_counter() - t0:.1f} s")


def parallel_gpt(cfg, w8: bool = False):
    """The full-width serving GPT from PARALLEL_SEED's PyTorch initialization
    on the card (the same bits in every process), float, or its W8 blocks
    on the plain contraction."""
    import torch

    from indextts_tpu_torch.models.unified_voice import UnifiedVoice
    from indextts_tpu_torch.runtime.engine import adopt
    from indextts_tpu_torch.weights import quantize_gpt_state_dict

    with torch.random.fork_rng(devices=[0]):
        torch.manual_seed(PARALLEL_SEED)
        with torch.device("cuda"):
            model = UnifiedVoice(cfg.gpt)
    if w8:
        sd = quantize_gpt_state_dict(model.state_dict(), head=False)
        with torch.device("meta"):
            model = UnifiedVoice(cfg.gpt, quantize=True)
        return adopt(model, sd, torch.device("cuda"))
    return model.eval().requires_grad_(False)


def parallel_s2mel(cfg, train: bool = False):
    """The full-width S2Mel from PARALLEL_SEED, for inference or training."""
    from indextts_tpu_torch.runtime import train as T

    model = T.train_model(cfg, "cfm", "cuda", seed=PARALLEL_SEED)
    return model if train else model.eval().requires_grad_(False)


def parallel_inputs(cfg, gpt):
    """The decode prompt (conds, text arrays for `gpt`'s decoder), the
    velocity's inputs at the main path's solve shape (the cond and null
    halves, T=898) and the CFM step's global batch of CFM_DP_ROWS rows with
    its noise, all from seeds on the card."""
    import torch

    from indextts_tpu_torch import finetune
    from indextts_tpu_torch.runtime import train as T
    from indextts_tpu_torch.runtime.decode import GPTDecoder
    from indextts_tpu_torch.serve import fallback_segments

    g = torch.Generator(device="cuda").manual_seed(PARALLEL_SEED)
    dev = torch.device("cuda")
    gc_ = cfg.gpt
    ids = fallback_segments(request_text(0), gc_.number_text_tokens,
                            cfg.runtime.max_text_tokens_per_segment, gc_.max_text_tokens)[0]
    arrays = GPTDecoder(gpt, gc_).build_text_prompt_arrays(
        np.asarray(ids)[None], np.asarray([len(ids)]), len(ids))
    decode = [torch.randn((1, gc_.condition_num_latent + 2, gc_.model_dim), generator=g,
                          device=dev)] + [torch.as_tensor(a, device=dev) for a in arrays]
    shapes = main_path_shapes(cfg, MAX_MEL_TOKENS)
    T_, valid, d = shapes["dit_T"], shapes["dit_valid"], cfg.s2mel.dit
    velocity = (torch.randn((2, d.in_channels, T_), generator=g, device=dev),
                torch.randn((2, d.in_channels, T_), generator=g, device=dev),
                torch.tensor([valid, valid], device=dev),
                torch.tensor([0.3, 0.3], device=dev),
                torch.randn((2, d.style_dim), generator=g, device=dev),
                torch.randn((2, T_, d.content_dim), generator=g, device=dev))
    batch = finetune.to_device(finetune.synthetic_cfm_batch(
        cfg, CFM_DP_ROWS, np.random.default_rng(PARALLEL_SEED)), dev)
    noise = T.cfm_noise(batch, torch.Generator(device="cuda").manual_seed(PARALLEL_SEED))
    return decode, velocity, batch, noise


class TimedCollectives:
    """While entered, torch.distributed's all_reduce and all_gather (which
    parallel/sharding.py calls) synchronize the card before and after each
    call and add its seconds to `seconds`; the functions are restored on
    exit. The synchronization serializes the card's work around every
    collective, so the share is an upper bound of what overlapping could
    hide."""

    def __enter__(self):
        import torch
        import torch.distributed as dist

        self.seconds, self._saved = 0.0, (dist.all_reduce, dist.all_gather)

        def timed(fn):
            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                return out
            return call

        dist.all_reduce, dist.all_gather = (timed(f) for f in self._saved)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce, dist.all_gather = self._saved


def parallel_decode(model, cfg, decode, mesh=None):
    """Greedy decode of PARALLEL_NEW codes, the stop code banned (so that
    every run takes PARALLEL_NEW - 1 steps), eager: (codes, the last
    logits, wall seconds, the collectives' seconds or None, the state).
    With `mesh`, its groups' first collective (which sets a communicator
    up) runs before the clock starts, and the decode's collectives are
    timed (`TimedCollectives`)."""
    import torch

    from indextts_tpu_torch.parallel.sharding import all_reduce
    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig

    dec = GPTDecoder(model, cfg.gpt, SamplingConfig(do_sample=False, ban_stop_token=True))
    if mesh is not None:
        all_reduce(torch.zeros(1, device="cuda"), mesh)
    timer = TimedCollectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timer if mesh is not None else contextlib.nullcontext():
        res = dec.generate(*decode, None, max_new=PARALLEL_NEW, eager=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = next(iter(dec._states.values()))
    return (res.codes[0].clone(), st.logits.clone(), wall,
            timer.seconds if mesh is not None else None, st)


def parallel_phase(card: str) -> None:
    """Phase `parallel_phase` (parallel/: multihost.py, sharding.py, tp.py,
    data.py) at full width (GPT 24L x 1280, 20 heads; DiT 13L x 512, 8
    heads), weights from PARALLEL_SEED. This process first makes the
    one-process references: greedy decode of PARALLEL_NEW codes (stop
    banned) on the float and the W8 GPT, the DiT velocity at the main
    path's solve shape, one CFM step at CFM_DP_ROWS rows. (a) NCCL at a world
    of 1 (tcp://127.0.0.1): the GPT cut by tensor_parallel over
    make_mesh(1, 1) gives the float decode's codes and last logits bit for
    bit. (b) and (c): two worker processes on the one card over gloo
    (`parallel_worker`), each under its own timeout."""
    import torch
    import torch.distributed as dist

    from indextts_tpu_torch.config import load_config
    from indextts_tpu_torch.parallel.sharding import GPT_PARTITION_RULES, make_mesh
    from indextts_tpu_torch.parallel.tp import tensor_parallel
    from indextts_tpu_torch.runtime import train as T

    t0 = time.perf_counter()
    cfg = load_config()
    gpt = parallel_gpt(cfg)
    decode, velocity, batch, noise = parallel_inputs(cfg, gpt)
    codes, logits, wall, _, _ = parallel_decode(gpt, cfg, decode)
    codes8, _, wall8, _, _ = parallel_decode(parallel_gpt(cfg, w8=True), cfg, decode)
    s2mel = parallel_s2mel(cfg)
    with torch.inference_mode():
        vel = s2mel.velocity(*velocity)
    del s2mel
    model = parallel_s2mel(cfg, train=True)
    opt = T.adamw(model.parameters(), 1e-4)
    grads = record_gradients(model, opt)
    loss = float(T.make_cfm_train_step(model, opt)(batch, noise=noise))
    ref = {"decode": decode, "codes": codes, "codes8": codes8, "velocity_in": velocity,
           "velocity": vel, "batch": batch, "noise": noise, "loss": loss, "grads": grads[0],
           "params": {k: v.detach() for k, v in model.state_dict().items()}}
    del model, opt, grads
    print(f"[parallel] one-process references: float decode {PARALLEL_NEW} codes eager "
          f"{wall:.3f} s, W8 {wall8:.3f} s; CFM step loss {loss:.6f}; "
          f"{time.perf_counter() - t0:.1f} s")

    # (a) NCCL at a world of 1
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        tp_codes, tp_logits, tp_wall, coll, _ = parallel_decode(
            tensor_parallel(gpt, mesh, GPT_PARTITION_RULES), cfg, decode, mesh)
        same = torch.equal(tp_codes, codes) and torch.equal(tp_logits, logits)
        print(f"[parallel] (a) NCCL world 1, make_mesh(1, 1): the cut GPT's {PARALLEL_NEW} "
              f"codes and last logits equal the one-process decode's bit for bit: {same}; "
              f"eager decode {tp_wall:.3f} s against {wall:.3f} s, its collectives "
              f"synchronized and timed: {coll:.3f} s; {card}")
        if not same:
            fail("parallel (a): the one-rank NCCL mesh changed the decode")
    finally:
        dist.destroy_process_group()
    del gpt
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reference.pt")
        torch.save(ref, path)
        del ref
        run_workers("parallel_worker", [path], "parallel")
    print(f"[parallel] parallel_phase done in {time.perf_counter() - t0:.1f} s")


def run_workers(func: str, args, label: str) -> None:
    """Two processes on the one card, each `chip_smoke.<func>(*args,
    coordinator, rank)` under PARALLEL_TIMEOUT; their output printed under
    `label`; fails unless both exit 0 having printed PARALLEL_WORKER_OK. A
    process still running at the end is killed."""
    coord = f"127.0.0.1:{free_port()}"
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import sys, chip_smoke; chip_smoke.{func}(*sys.argv[1:])",
         *args, coord, str(r)], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PARALLEL_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        for line in log.splitlines():
            print(f"[{label} rank {r}] {line}")
        if p.returncode != 0 or "PARALLEL_WORKER_OK" not in log:
            fail(f"{label}: worker {r} failed (exit {p.returncode})")


def record_gradients(model, opt) -> list:
    """A list that takes, at each of `opt`'s steps, every parameter's
    gradient as the step is given it (a step pre-hook)."""
    grads = []
    opt.register_step_pre_hook(lambda *_: grads.append(
        {k: p.grad.clone() for k, p in model.named_parameters()}))
    return grads


def parallel_worker(path: str, coord: str, rank: str) -> None:
    """One of parallel_phase's two processes on the one card, over gloo
    (torch.distributed.init_process_group at tcp://`coord`: NCCL refuses
    two ranks on one device; gloo's collectives take the CUDA tensors).
    (b) make_mesh(1, 2): the GPT cut by GPT_PARTITION_RULES (10 of 20 heads
    a rank) decodes the one-process float codes and the W8 codes (the plain
    W8A8 contraction) token for token; the DiT cut by DIT_PARTITION_RULES
    (4 of 8 heads) within 1e-4 of the largest value of the one-process
    velocity; K1's and K3's launches at the local heads counted (K1 once a
    layer a step, K3 once a layer a call) and each checked against its
    plain version at those shapes. (c) make_mesh(2, 1): one CFM step
    through finetune.data_parallel_step, each rank its rows of the global
    batch and its slice of the global noise, gradients averaged: the loss
    within 1e-5 relative of the one-process step's; the gradient AdamW is
    given, leaf by leaf, within 1e-4 of the largest |value| of the
    one-process step's leaf (a summed or wrongly scaled average is off by
    its whole size: the parameters alone cannot show it, an AdamW step
    ignoring the gradient's scale); every parameter within 1e-5 of the
    one-process step's (an AdamW step moves a weight by about the learning
    rate, 1e-4, whatever the size of its gradient, so float32 differences
    of the averaged gradients may move it by a part of that: 10 %). Each
    step's time and its collectives' share (`TimedCollectives`) are
    printed: two ranks share one card, so the times measure no scaling."""
    import torch
    import torch.distributed as dist

    from indextts_tpu_torch import finetune
    from indextts_tpu_torch.config import load_config
    from indextts_tpu_torch.ops import decode_attention, dit_attention
    from indextts_tpu_torch.parallel.sharding import (
        DIT_PARTITION_RULES,
        GPT_PARTITION_RULES,
        all_reduce,
        make_mesh,
    )
    from indextts_tpu_torch.parallel.tp import tensor_parallel
    from indextts_tpu_torch.runtime import train as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://{coord}", world_size=2, rank=int(rank))
    cfg = load_config()
    ref = torch.load(path, map_location="cuda", weights_only=False)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    note = f"two ranks sharing one card, which measures no scaling; {card}"
    L, depth = cfg.gpt.layers, cfg.s2mel.dit.depth
    mesh = make_mesh(1, 2)
    g = torch.Generator(device="cuda").manual_seed(PARALLEL_SEED + mesh.rank)

    for w8 in (False, True):
        label = "W8" if w8 else "float"
        model = tensor_parallel(parallel_gpt(cfg, w8), mesh, GPT_PARTITION_RULES)
        n0 = decode_attention.counter.launches
        codes, _, wall, coll, st = parallel_decode(model, cfg, ref["decode"], mesh)
        launches = decode_attention.counter.launches - n0
        heads = st.caches[0].shape[2]
        want = ref["codes8" if w8 else "codes"]
        print(f"(b) TP decode {label}: {heads} of {cfg.gpt.heads} heads a rank, "
              f"{PARALLEL_NEW} greedy codes equal the one-process run's: "
              f"{torch.equal(codes, want)}; K1 launches a decode {launches} (expected "
              f"{(PARALLEL_NEW - 1) * L}); {wall / PARALLEL_NEW * 1e3:.2f} ms a code, the "
              f"collectives synchronized and timed: {coll:.3f} s of {wall:.3f} s "
              f"({100 * coll / wall:.1f} %); {note}")
        if not torch.equal(codes, want) or heads != cfg.gpt.heads // 2 \
                or launches != (PARALLEL_NEW - 1) * L:
            fail(f"parallel (b): TP {label} decode")
        if not w8:
            cap = st.cap
            q = torch.randn((1, heads, 64), generator=g, device="cuda")
            k, v = (torch.randn((1, heads, cap, 64), generator=g, device="cuda")
                    for _ in range(2))
            args = (q, k, v, torch.tensor([cap - 7], device="cuda"),
                    torch.tensor([40], device="cuda"), torch.tensor([45], device="cuda"))
            err = (decode_attention.ragged_decode_attention(*args)
                   - decode_attention.ragged_decode_attention_plain(*args)).abs().max().item()
            print(f"(b) K1 at the local heads (B=1, H={heads}, cap={cap}): max_abs_err "
                  f"{err:.3g} against its plain version (tol 2e-5)")
            if not err <= 2e-5:
                fail("parallel (b): K1 at the local heads")
        del model, st
        gc.collect()
        torch.cuda.empty_cache()

    s2mel = tensor_parallel(parallel_s2mel(cfg), mesh, DIT_PARTITION_RULES)
    heads = s2mel.cfm.estimator.transformer.layers[0].attention.h

    def velocity():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = s2mel.velocity(*ref["velocity_in"])
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    n0 = dit_attention.counter.launches
    vel, _ = velocity()
    launches = dit_attention.counter.launches - n0
    vel, wall = velocity()
    with TimedCollectives() as timer:
        _, timed = velocity()
    want = ref["velocity"]
    rel = ((vel - want).abs().max() / want.abs().max()).item()
    print(f"(b) TP DiT velocity: {heads} of {cfg.s2mel.dit.num_heads} heads a rank, B=2 "
          f"T={want.shape[-1]}: max error {rel:.3g} of the largest value (tol 1e-4); K3 "
          f"launches a call {launches} (expected {depth}); {wall * 1e3:.2f} ms a call; "
          f"collectives timed: {timer.seconds * 1e3:.2f} ms of {timed * 1e3:.2f} "
          f"ms ({100 * timer.seconds / timed:.1f} %); {note}")
    if not rel <= 1e-4 or launches != depth or heads != cfg.s2mel.dit.num_heads // 2:
        fail("parallel (b): TP DiT velocity")
    x, _, _, _, _, _ = ref["velocity_in"]
    T_, valid = x.shape[-1], int(ref["velocity_in"][2][0])
    q, k, v = (torch.randn((2, heads, T_, 64), generator=g, device="cuda") for _ in range(3))
    mask = torch.arange(T_, device="cuda")[None] < torch.tensor([valid, valid // 2],
                                                                device="cuda")[:, None]
    err = (dit_attention.dit_attention(q, k, v, mask)
           - dit_attention.dit_attention_plain(q, k, v, mask)).abs().max().item()
    print(f"(b) K3 at the local heads (B=2, H={heads}, T={T_}): max_abs_err {err:.3g} "
          "against its plain version (tol 2e-5)")
    if not err <= 2e-5:
        fail("parallel (b): K3 at the local heads")
    del s2mel
    gc.collect()
    torch.cuda.empty_cache()

    dmesh = make_mesh(2, 1)
    model = parallel_s2mel(cfg, train=True)
    opt = T.adamw(model.parameters(), 1e-4)
    grads = record_gradients(model, opt)
    step = finetune.data_parallel_step("cfm", model, opt, dmesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with TimedCollectives() as timer:
        loss = step(ref["batch"], noise=ref["noise"])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loss = float(all_reduce(loss.clone(), dmesh, axis="data")) / 2
    (got,) = grads
    grad_err = max((got[k] - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                   for k, w in ref["grads"].items())
    diff = max((p - ref["params"][k]).abs().max().item()
               for k, p in model.state_dict().items())
    rel = abs(loss - ref["loss"]) / abs(ref["loss"])
    print(f"(c) DP CFM step, make_mesh(2, 1), {CFM_DP_ROWS // 2} of {CFM_DP_ROWS} rows a rank: "
          f"loss {loss:.6f} against the one-process {ref['loss']:.6f} (rel {rel:.3g}, tol "
          f"1e-5); the averaged gradient against the one-process step's, the worst leaf "
          f"{grad_err:.3g} of its largest value (tol 1e-4); largest parameter difference "
          f"{diff:.3g} (tol 1e-5); step {wall * 1e3:.1f} ms with its collectives timed: "
          f"{timer.seconds * 1e3:.1f} ms ({100 * timer.seconds / wall:.1f} %); {note}")
    if not (rel <= 1e-5 and grad_err <= 1e-4 and diff <= 1e-5 and set(got) == set(ref["grads"])):
        fail("parallel (c): the DP CFM step differs from the one-process step")
    dist.destroy_process_group()
    print("PARALLEL_WORKER_OK", flush=True)


# ---------------------------------------------------------------------------
# phase tp_train_phase: training over the model axis, two ranks on the card
# ---------------------------------------------------------------------------


def tp_train_phase(shapes, card: str) -> None:
    """Phase `tp_train_phase` (parallel/ f and g, train_model(mesh=),
    finetune.py --model-parallel), at full width (DiT 13L x 512, 4 of 8
    heads a rank; GPT 24L x 1280, 10 of 20): two processes on the one card
    over gloo (`tp_train_worker`), then, in this process, a resume at
    --model-parallel 1 of the checkpoint they wrote at 2. Two ranks share
    one card: the times measure no scaling."""
    from indextts_tpu_torch import finetune

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run_workers("tp_train_worker", [tmp], "tp_train")
        out = finetune.main(TP_FINETUNE + ["--out-dir", tmp])
        print(f"[tp_train] the --model-parallel 2 checkpoint resumed at 1: {json.dumps(out)}")
        if (out["from_step"], out["final_step"], out["mesh"]) != (
                1, 2, {"data": 1, "model": 1}) or not math.isfinite(out["loss_last"]):
            fail(f"[tp_train] the resume at --model-parallel 1: {out}")
    print(f"[tp_train] tp_train_phase done in {time.perf_counter() - t0:.1f} s; {card}")


def tp_train_worker(tmp: str, coord: str, rank: str) -> None:
    """One of tp_train_phase's two processes, over gloo, make_mesh(1, 2).
    For each target, rank 0 first takes the one-process step on the card
    (TF32 off): the CFM at the main path's solve (`train_batches`: 8 rows
    of T=898, CFM noise from TP_TRAIN_SEED), the GPT at TP_GPT_ROWS of its
    rows; then both ranks take the same step with the model cut
    (train_model(mesh=)) through finetune.data_parallel_step, every kernel
    count set to 0 just before and read after: the CFM step runs K3 with
    its statistics, K9 and K10 13 times each at 4 heads, the GPT step no
    kernel. The loss within 1e-5 relative of the one-process step's; the
    gradient AdamW was given, gathered to the full layout (tp.py
    full_state), within 1e-4 of the largest |value| of each leaf of the
    one-process step's gradient. Each step's ms and its collectives' share
    (`TimedCollectives`) printed. Rank 0 also holds K3 (with statistics), K9
    and K10 at the local heads to their plain versions (the main case of
    `k9_k10_cases`, 2e-5). A second step of each, past the first's
    set-up, is timed too (and the one-process one on rank 0). Then
    finetune.main --model-parallel 2 (the CFM, TP_FINETUNE's one step)
    writes its checkpoint under `tmp`."""
    import datetime

    import torch
    import torch.distributed as dist

    from indextts_tpu_torch import finetune
    from indextts_tpu_torch.config import load_config
    from indextts_tpu_torch.ops import dit_attention as k3
    from indextts_tpu_torch.parallel.sharding import make_mesh
    from indextts_tpu_torch.parallel.tp import full_state
    from indextts_tpu_torch.runtime import train as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://{coord}", world_size=2, rank=int(rank),
                            timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT))
    cfg = load_config()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    note = f"two ranks sharing one card, which measures no scaling; {card}"
    mesh = make_mesh(1, 2)
    lead = mesh.rank == 0
    shapes = main_path_shapes(cfg, MAX_MEL_TOKENS)
    g = torch.Generator(device="cuda").manual_seed(TP_TRAIN_SEED)
    gpt_batch, cfm_batch = train_batches(cfg, shapes, g)
    gpt_batch = {k: v[:TP_GPT_ROWS] for k, v in gpt_batch.items()}
    noise = T.cfm_noise(cfm_batch, g)
    depth = cfg.s2mel.dit.depth
    counters = kernel_counters()

    def agree(ok: bool, what: str) -> None:
        """Both ranks fail together when rank 0's check fails."""
        bad = torch.tensor([0 if ok else 1])
        dist.all_reduce(bad)
        if int(bad):
            fail(f"[tp_train] {what}")

    for target, batch in (("cfm", cfm_batch), ("gpt", gpt_batch)):
        rows = batch["x1" if target == "cfm" else "text_ids"].shape[0]
        ref = None
        if lead:
            model = T.train_model(cfg, target, "cuda", seed=TP_TRAIN_SEED)
            opt = T.adamw(model.parameters(), 1e-4)
            grads = record_gradients(model, opt)
            step = (T.make_cfm_train_step(model, opt) if target == "cfm"
                    else T.make_train_step(model, opt))
            ref_ms = []
            for _ in range(2):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                loss = float(step(batch, noise=noise) if target == "cfm" else step(batch))
                ref_ms.append((time.perf_counter() - t1) * 1e3)
                if len(ref_ms) == 1:
                    ref = (loss, {k: v.cpu() for k, v in grads[0].items()})
            del model, opt, grads, step
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
        model = T.train_model(cfg, target, "cuda", seed=TP_TRAIN_SEED, mesh=mesh)
        opt = T.adamw(model.parameters(), 1e-4)
        step = finetune.data_parallel_step(target, model, opt, mesh)
        for cnt in counters.values():
            cnt.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with TimedCollectives() as timer:
            loss = float(step(batch, noise=noise))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {name: cnt.launches for name, cnt in counters.items()}
        # the gradient AdamW was given (it stays until the next zero_grad)
        got = full_state(model, {k: p.grad for k, p in model.named_parameters()})
        heads = (model.cfm.estimator.transformer.layers[0].attention.h if target == "cfm"
                 else model.gpt.h[0].attn.n_head)
        want = {name: depth if target == "cfm" and name.startswith(("K3 ", "K9 ", "K10 "))
                else 0 for name in counters}
        print(f"({target}) TP step, make_mesh(1, 2), {heads} heads a rank, {rows} rows: "
              f"{wall * 1e3:.1f} ms, its collectives synchronized and timed "
              f"{timer.seconds * 1e3:.1f} ms ({100 * timer.seconds / wall:.1f} %); launches "
              f"{json.dumps({k: n for k, n in launches.items() if n})}; {note}")
        ok = launches == want
        if lead:
            ref_loss, ref_grads = ref
            rel = abs(loss - ref_loss) / abs(ref_loss)
            worst = max(((got[k].cpu() - w).abs().max().item() / max(w.abs().max().item(), 1e-30),
                         k) for k, w in ref_grads.items())
            print(f"({target}) loss {loss:.6f} against the one-process step's {ref_loss:.6f} "
                  f"(rel {rel:.3g}, tol 1e-5; that step {ref_ms[0]:.1f} ms, the first of its "
                  f"process, a second {ref_ms[1]:.1f} ms); the gathered gradient against the "
                  f"one-process step's, the worst "
                  f"leaf {worst[1]} {worst[0]:.3g} of its largest |value| (tol 1e-4); "
                  f"launches {'as' if ok else 'NOT as'} expected ({json.dumps(want)})")
            ok = ok and rel <= 1e-5 and worst[0] <= 1e-4 and set(got) == set(ref_grads)
        agree(ok, f"the {target} step over the model axis differs from the one-process step")
        # a second step, past the first's set-up of the kernels and the
        # ranks' connections
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with TimedCollectives() as timer:
            loss = float(step(batch, noise=noise))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        print(f"({target}) a second TP step: {wall * 1e3:.1f} ms, its collectives "
              f"{timer.seconds * 1e3:.1f} ms ({100 * timer.seconds / wall:.1f} %), loss "
              f"{loss:.6f}; {note}")
        agree(math.isfinite(loss), f"the {target} second step's loss {loss}")
        del model, opt, step, got
        gc.collect()
        torch.cuda.empty_cache()

    ok = True
    if lead:
        heads = cfg.s2mel.dit.num_heads // 2
        name, t, rows = k9_k10_cases(shapes, shapes)[0]
        q, k, v, mask, lens, out, stats, dout = k9_k10_inputs(g, name, t, rows, heads)
        errs = {"K3 (stats)": (out - k3.dit_attention_plain(q, k, v, mask)).abs().max().item()}
        got = k3.dit_attention_bwd(q, k, v, mask, out, stats, dout)
        want = k3.dit_attention_bwd_plain(q, k, v, mask, dout)
        for label, a, b in (("K10 dq", got[0], want[0]), ("K9 dk", got[1], want[1]),
                            ("K9 dv", got[2], want[2])):
            errs[label] = (a - b).abs().max().item() / max(1.0, b.abs().max().item())
        print(f"K3 (stats), K9 and K10 at the local heads (B={len(rows)}, H={heads}, T={t}, "
              f"valid {lens}): errors against the plain versions "
              + ", ".join(f"{k_} {e:.3g}" for k_, e in errs.items()) + " (tol 2e-5)")
        ok = all(e <= 2e-5 for e in errs.values())
    agree(ok, "K3, K9 or K10 at the local heads disagree with the plain versions")

    out = finetune.main(TP_FINETUNE + ["--out-dir", tmp, "--model-parallel", "2"])
    print(f"finetune --model-parallel 2: {json.dumps(out)}")
    agree(out["mesh"] == {"data": 1, "model": 2} and math.isfinite(out["loss_last"]),
          f"finetune --model-parallel 2: {out}")
    dist.destroy_process_group()
    print("PARALLEL_WORKER_OK", flush=True)


# ---------------------------------------------------------------------------
# phase dryrun_phase: the (data, model) dryrun, four ranks on the card
# ---------------------------------------------------------------------------


def dryrun_phase(card: str) -> None:
    """Phase `dryrun_phase` (parallel/dryrun.py): `dryrun_multichip` with
    DRYRUN_PROCS processes, mesh (2, 2), gloo ranks sharing the one card,
    every attention 64 wide (K1 and K3 take Dh=64), 300 s a worker
    (dryrun.WORKER_TIMEOUT):
    (a) the GPT step, (b) the TP decode, (c) the cascade, each rank's
    results and its launches of K1 ((b) and (c)), K3 and K2 ((c)), all of
    which must be above 0. Then, in this process, K1 and K3 against their
    plain versions at the shapes the ranks gave them (the local rows and
    heads, the decode's cache and its last valid length, the CFM's frames
    and valid lengths) on seeded inputs, and K2 at each call of one vocoder
    call of the cascade's BigVGAN on a seeded mel of a rank's rows: the
    inputs each K2 call got, held to 2e-5 + 1e-5 of the plain output (phase
    2's tolerance). Two ranks share the card, so no scaling is measured."""
    import torch

    from indextts_tpu_torch.models import bigvgan as bv
    from indextts_tpu_torch.ops import decode_attention, dit_attention, snake
    from indextts_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    try:
        results = dryrun.dryrun_multichip(DRYRUN_PROCS, "cuda",
                                          log=lambda line: print(f"[dryrun] {line}"))
    except RuntimeError as e:
        fail(f"[dryrun] {e}")
    wall = time.perf_counter() - t0
    for r in results:
        a, b, c = r["train"], r["decode"], r["cascade"]
        print(f"[dryrun] rank {r['rank']} mesh {r['mesh']} {r['backend']} on {r['device']}: "
              f"(a) GPT step loss {a['loss']:.6f} against one process {a['loss_one_process']:.6f}"
              f" (rel {a['rel']:.3g}, tol 1e-5), {a['seconds']:.2f} s; (b) TP decode codes equal "
              f"{b['ok']}, K1 launches {b['launches']['K1']}, {b['seconds']:.2f} s; (c) cascade "
              f"codes equal {c['codes_equal']}, waveform {c['max_rel']:.3g} of the unsharded "
              f"peak (tol 2e-4), launches {json.dumps(c['launches'])}, {c['seconds']:.2f} s; "
              f"{card}")
        if min(b["launches"]["K1"], *c["launches"].values()) <= 0:
            fail(f"[dryrun] rank {r['rank']}: a kernel of the path was not launched: "
                 f"(b) {b['launches']}, (c) {c['launches']}")
    g = torch.Generator(device="cuda").manual_seed(DRYRUN_SEED)
    dev = torch.device("cuda")
    errs = {}
    r = results[0]
    for part in ("decode", "cascade"):
        B, H, cap, Dh = r[part]["k1_shape"]
        q = torch.randn((B, H, Dh), generator=g, device=dev)
        k, v = (torch.randn((B, H, cap, Dh), generator=g, device=dev) for _ in range(2))
        valid = torch.full((B,), r[part]["k1_valid"], device=dev)
        zero = torch.zeros((B,), dtype=torch.long, device=dev)
        args = (q, k, v, valid, zero, zero)
        errs[f"K1 {part} {[B, H, cap, Dh]} valid {r[part]['k1_valid']}"] = (
            decode_attention.ragged_decode_attention(*args)
            - decode_attention.ragged_decode_attention_plain(*args)).abs().max().item(), 2e-5
    B, H, T, Dh = r["cascade"]["k3_shape"]
    q, k, v = (torch.randn((B, H, T, Dh), generator=g, device=dev) for _ in range(3))
    valid = torch.tensor(r["cascade"]["k3_valid"] * 2, device=dev)
    mask = torch.arange(T, device=dev)[None] < valid[:, None]
    errs[f"K3 {[B, H, T, Dh]} valid {r['cascade']['k3_valid']}"] = (
        dit_attention.dit_attention(q, k, v, mask)
        - dit_attention.dit_attention_plain(q, k, v, mask)).abs().max().item(), 2e-5
    voc = dryrun.cascade_models(dryrun.cascade_config(64), dev)["bigvgan"]
    calls = []

    def record(x, alpha, beta, logscale=True):
        calls.append((x.clone(), alpha, beta, logscale))
        return snake.anti_alias_snake(x, alpha, beta, logscale)

    bv.anti_alias_snake = record
    try:
        with torch.inference_mode():
            voc(torch.randn(r["cascade"]["mel_shape"], generator=g, device=dev))
    finally:
        bv.anti_alias_snake = snake.anti_alias_snake
    err = tol = 0.0
    for x, alpha, beta, logscale in calls:
        want = snake.anti_alias_snake_plain(x, alpha, beta, logscale)
        e = (snake.anti_alias_snake(x, alpha, beta, logscale) - want).abs().max().item()
        t = 2e-5 + 1e-5 * want.abs().max().item()
        if e / t > err / max(tol, 1e-30):
            err, tol = e, t
    errs[f"K2, the worst of the {len(calls)} calls of a vocoder call on "
         f"{r['cascade']['mel_shape']} against its tolerance 2e-5 + 1e-5 max|plain|"] = err, tol
    for what, (err, tol) in errs.items():
        print(f"[dryrun] {what}: max_abs_err {err:.3g} against its plain version (tol {tol:.3g})")
        if not err <= tol:
            fail(f"[dryrun] {what} disagrees with its plain version")
    print(f"[dryrun] dryrun_phase done in {time.perf_counter() - t0:.1f} s (the workers "
          f"{wall:.1f} s); ranks share one card, so no scaling is measured; {card}")


# ---------------------------------------------------------------------------
# phase tools_phase: the offline tools on the checkpoint directory
# ---------------------------------------------------------------------------


def tools_phase(model_dir: str, wav_path: str, tmp: str, card: str) -> None:
    """Phase `tools_phase` (indextts_tpu_torch/tools/) on `reference_dir`'s
    full-width directory, each tool through its main(argv) on the card:
    verify_checkpoint --synth (its own engine) reports ok with finite audio;
    then precompute, build_dataset and synthesize_clips share one engine,
    as one process would hold it (the loader's load_engine kept for the
    directory while the phase runs). A segment from the loaded .npz gives
    the fresh speaker's codes and waveform, bit for bit; build_dataset
    synthesizes 3 utterances on 2 threads (--deterministic), then a resume
    synthesizes nothing (no kernel launched); synth --batched writes 2
    clips of the phrase bank. Each tool's seconds printed."""
    import torch

    from indextts_tpu_torch.frontend.tokenizer import byte_fallback_ids
    from indextts_tpu_torch.runtime import loader
    from indextts_tpu_torch.runtime.engine import EmotionConditioning
    from indextts_tpu_torch.tools import (
        build_dataset,
        synthesize_clips,
        verify_checkpoint,
        voice_conditioning,
    )
    from indextts_tpu_torch.utils import audio as audio_utils

    t0 = time.perf_counter()
    d = os.path.join(tmp, "tools")
    os.makedirs(d)
    report_path = os.path.join(d, "verify.json")
    rc = verify_checkpoint.main(["--model-dir", model_dir, "--synth", "--spk-audio", wav_path,
                                 "--output", report_path])
    report = json.loads(Path(report_path).read_text())
    statuses = {k: c["status"] for k, c in report["components"].items()}
    t1 = time.perf_counter()
    print(f"[tools] verify_checkpoint --synth: exit {rc}, ok {report['ok']}, components "
          f"{json.dumps(statuses)}, synth {json.dumps(report['synth'])}; {t1 - t0:.1f} s")
    if rc or not report["ok"] or set(statuses.values()) != {"ok"} \
            or not report["synth"]["finite"] or report["synth"]["audio_s"] <= 0:
        fail(f"[tools] verify_checkpoint: {report}")
    gc.collect()
    torch.cuda.empty_cache()

    engines, real = {}, loader.load_engine

    def shared(path, *args, **kwargs):
        if path not in engines:
            engines[path] = real(path, *args, **kwargs)
        return engines[path]

    loader.load_engine = shared
    try:
        npz = os.path.join(d, "speaker.npz")
        if voice_conditioning.main(["precompute", "--audio", wav_path, "--output", npz,
                                    "--model-dir", model_dir]):
            fail("[tools] precompute failed")
        engine = engines[model_dir]
        print(f"[tools] the shared engine: torch_cache {engine.load_report.cache}, read in "
              f"{engine.load_report.read_seconds:.2f} s (PR 16's conversion: 3.09-5.66 s); "
              f"{card}")
        if engine.load_report.cache != "read":
            fail(f"[tools] the shared engine's cache: {engine.load_report.cache}")
        ids = byte_fallback_ids(request_text(0), engine.cfg.gpt.number_text_tokens)
        results = []
        for spk in (voice_conditioning.load_precomputed_speaker(npz, "cuda"),
                    engine.prepare_speaker(*audio_utils.load_wav(wav_path))):
            # synthesize_segment's two halves, so that the codes are seen
            emovec, codes, t_gen = engine._decode_segment_codes(
                spk, EmotionConditioning(spk.spk_cond_emb, spk.cond_len), ids, seed=TOOLS_SEED)
            res = engine._finish_from_codes(spk, emovec, ids, codes, TOOLS_SEED, t_gen)
            results.append((codes, res.wav))
        same = (np.array_equal(results[0][0], results[1][0])
                and np.array_equal(results[0][1], results[1][1]))
        t2 = time.perf_counter()
        print(f"[tools] precompute: {npz} ({os.path.getsize(npz) / 1e6:.2f} MB); a segment from "
              f"the loaded bundle ({results[0][0].shape[-1]} codes, {results[0][1].size} "
              f"samples) equals the fresh speaker's, codes and waveform: {same}; {t2 - t1:.1f} s")
        if not same:
            fail("[tools] the precomputed speaker's segment differs from the fresh one's")

        corpus = os.path.join(d, "corpus.jsonl")
        Path(corpus).write_text("".join(json.dumps({"id": f"u{i}", "text": request_text(i)})
                                        + "\n" for i in range(3)))
        out = os.path.join(d, "dataset")
        argv = ["--input", corpus, "--out-dir", out, "--workers", "2", "--deterministic",
                "--model-dir", model_dir, "--spk-audio", wav_path]
        build_dataset.main(argv)
        rows = [json.loads(line) for line in open(os.path.join(out, "manifest.jsonl"))]
        t3 = time.perf_counter()
        counters = kernel_counters()
        for cnt in counters.values():
            cnt.launches = 0
        build_dataset.main(argv)
        again = [json.loads(line) for line in open(os.path.join(out, "manifest.jsonl"))]
        launched = sum(cnt.launches for cnt in counters.values())
        t4 = time.perf_counter()
        brief = [{k: r.get(k) for k in ("id", "duration_sec", "worker", "error")} for r in rows]
        print(f"[tools] build_dataset, 3 utterances on 2 threads: {json.dumps(brief)}; "
              f"{t3 - t2:.1f} s; the resume: {len(again)} rows, {launched} kernel launches, "
              f"{t4 - t3:.1f} s")
        if sorted(r["id"] for r in rows) != ["u0", "u1", "u2"] or any("error" in r for r in rows) \
                or again != rows or launched:
            fail(f"[tools] build_dataset: {rows}, resumed {again}, {launched} launches")

        inp, clips = os.path.join(d, "clips.jsonl"), os.path.join(d, "clips")
        synthesize_clips.main(["make-input", "--output", inp, "--count", "2"])
        if synthesize_clips.main(["synth", "--input", inp, "--reference", wav_path,
                                  "--output-dir", clips, "--model-dir", model_dir,
                                  "--batched"]):
            fail("[tools] synthesize_clips synth failed")
        summary = json.loads(Path(clips, "manifest.json").read_text())
        t5 = time.perf_counter()
        print(f"[tools] synthesize_clips synth --batched: {summary['total_clips']} clips, "
              f"{summary['total_duration']:.2f} s of audio in "
              f"{summary['total_generation_time']:.2f} s; {t5 - t4:.1f} s")
        if summary["total_clips"] != 2 or any("error" in c for c in summary["clips"]):
            fail(f"[tools] synthesize_clips: {summary}")
    finally:
        loader.load_engine = real
        engines.clear()
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[tools] tools_phase done in {time.perf_counter() - t0:.1f} s; {card}")


# ---------------------------------------------------------------------------
# phases eval_phase and soak_phase: the quality harness and the soak gate
# ---------------------------------------------------------------------------


def eval_phase(model_dir: str, wav_path: str, tmp: str, card: str) -> None:
    """Phase `eval_phase` (indextts_tpu_torch/tools/eval_quality.py): main
    on `reference_dir`'s full-width directory, float route, one engine for
    both runs (the loader's load_engine kept for the directory). The 6
    cases of examples/cases.jsonl against the synthetic prompt, --asr mock,
    controls on, seed 0: every case present with WER 0, finite cosines and
    margins, and K1, K2 and K3 each launched in each case; then
    EVAL_DROP_CASE again with --mock-asr-drop 0.5, whose WER must be above
    0. Rows, aggregate, margins, meta flags, K1-K3 launches a case and the
    memory left allocated on the card before and after printed."""
    import torch

    from indextts_tpu_torch.runtime import loader
    from indextts_tpu_torch.tools import eval_quality

    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated() / 2**30
    d = os.path.join(tmp, "eval")
    os.makedirs(d)
    cases_path = str(Path(__file__).resolve().parent / "examples" / "cases.jsonl")
    cases = [json.loads(line) for line in open(cases_path) if line.strip()]
    counters = kernel_counters()
    names = {n.split()[0]: n for n in counters if n.split()[0] in ("K1", "K2", "K3")}
    launches, real_synth = {}, eval_quality._synthesize

    def counted(engine, case, spk, seed, gen_kwargs=None):
        for n in names.values():
            counters[n].launches = 0
        out = real_synth(engine, case, spk, seed, gen_kwargs)
        launches[case.get("id")] = {k: counters[n].launches for k, n in names.items()}
        return out

    engines, real_load = {}, loader.load_engine

    def shared(path, *args, **kwargs):
        if path not in engines:
            engines[path] = real_load(path, *args, **kwargs)
        return engines[path]

    eval_quality._synthesize, loader.load_engine = counted, shared
    try:
        out = os.path.join(d, "EVAL.json")
        res = eval_quality.main(["--cases", cases_path, "--model-dir", model_dir,
                                 "--spk-audio", wav_path, "--asr", "mock", "--seed", "0",
                                 "--output", out])
        t1 = time.perf_counter()
        for row in res["cases"]:
            print(f"[eval] {json.dumps(row)}; launches {json.dumps(launches.get(row['id']))}")
        ctl, meta = res.get("controls", {}), res["meta"]
        flags = {k: meta.get(k) for k in ("weights", "device", "max_mel_tokens", "asr",
                                           "spk_sim_discriminative", "emo_sim_discriminative")}
        print(f"[eval] aggregate {json.dumps(res['aggregate'])}; margins: spk "
              f"{ctl.get('spk_margin_mean')} (synthetic control "
              f"{ctl.get('spk_control_synthetic')}), emo {ctl.get('emo_margin_mean')}; meta "
              f"{json.dumps(flags)}; {t1 - t0:.1f} s for {len(cases)} cases; {card}")
        ids = [c["id"] for c in cases]
        cosines = [r[k] for r in res["cases"] for k in ("spk_sim", "emo_sim")] + [
            r["margin"] for part in ("spk", "emo") for r in ctl.get(part, [])]
        if [r["id"] for r in res["cases"]] != ids or not ctl.get("spk"):
            fail(f"[eval] cases {[r['id'] for r in res['cases']]} against {ids}")
        if res["aggregate"]["wer"] != 0 or any(r["wer"] != 0 for r in res["cases"]):
            fail(f"[eval] the exact mock ASR gave WER {res['aggregate']['wer']}")
        if not all(math.isfinite(c) for c in cosines):
            fail(f"[eval] a cosine is not finite: {cosines}")
        if any(launches.get(i, {}).get(k, 0) == 0 for i in ids for k in names):
            fail(f"[eval] a case launched no K1, K2 or K3: {launches}")

        one = os.path.join(d, "one.jsonl")
        Path(one).write_text(json.dumps(next(c for c in cases if c["id"] == EVAL_DROP_CASE))
                             + "\n")
        drop = eval_quality.main(["--cases", one, "--model-dir", model_dir,
                                  "--spk-audio", wav_path, "--asr", "mock", "--seed", "0",
                                  "--mock-asr-drop", "0.5",
                                  "--output", os.path.join(d, "EVAL_drop.json")])
        row = drop["cases"][0]
        print(f"[eval] {EVAL_DROP_CASE} under --mock-asr-drop 0.5: WER {row['wer']} "
              f"({row['wer_errors']} of {row['ref_tokens']} tokens); "
              f"{time.perf_counter() - t1:.1f} s")
        if not row["wer"] > 0:
            fail(f"[eval] --mock-asr-drop 0.5 gave WER {row['wer']}")
    finally:
        eval_quality._synthesize, loader.load_engine = real_synth, real_load
        engines.clear()
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[eval] eval_phase done in {time.perf_counter() - t0:.1f} s; allocated on the card "
          f"before it {before:.2f} GiB, after its engine was freed "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; {card}")


def soak_phase(model_dir: str, tmp: str, card: str) -> None:
    """Phase `soak_phase` (indextts_tpu_torch/tools/soak_server.py) in a
    process of its own, TARS_CHECKPOINT_DIR set to `reference_dir`'s
    directory and the soak's own environment defaults (this script's
    TARS_MAX_MEL_TOKENS and TARS_STAGE_SYNC taken out): SOAK_REQUESTS
    requests from 4 clients in SOAK_WAVES waves. It must exit 0 with its
    device gauge "memory_stats"; each wave's line and the summary printed."""
    t0 = time.perf_counter()
    out = os.path.join(tmp, "soak.json")
    env = dict(os.environ, TARS_CHECKPOINT_DIR=model_dir)
    for k in ("TARS_MAX_MEL_TOKENS", "TARS_STAGE_SYNC"):
        env.pop(k, None)
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "indextts_tpu_torch.tools.soak_server",
             "--requests", str(SOAK_REQUESTS), "--clients", "4", "--waves", str(SOAK_WAVES),
             "--port", str(free_port()), "--output", out],
            cwd=here, env=env, capture_output=True, text=True, timeout=SOAK_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        fail(f"[soak] no exit in {SOAK_TIMEOUT} s; stderr tail: {str(e.stderr)[-2000:]}")
    waves = [line for line in proc.stderr.splitlines() if line.startswith('{"wave"')]
    for line in waves:
        print(f"[soak] {line}")
    summary = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else "{}"
    print(f"[soak] {summary}")
    print(f"[soak] exit {proc.returncode} in {time.perf_counter() - t0:.1f} s (the process's "
          f"start, the W8 engine's warm load, its warm-up and {SOAK_REQUESTS} requests); {card}")
    if proc.returncode != 0 or len(waves) != SOAK_WAVES \
            or json.loads(summary).get("hbm_gauge") != "memory_stats":
        fail(f"[soak] exit {proc.returncode}, {len(waves)} waves, {summary}; stderr tail: "
             f"{proc.stderr[-3000:]}")


# ---------------------------------------------------------------------------
# phase bench_phase: the measurement tools, each in a process of its own
# ---------------------------------------------------------------------------

# the tools' short settings: the bench's one timed run with every section;
# a few hundred decode steps and one s2mel shape for the A/B tools
BENCH_TOOLS = {"bench_runs": "1", "w4_steps": "200", "decode_steps": "100",
               "decode_batches": "1,16", "s2mel_shape": "1x512", "s2mel_iters": "3",
               "server_clients": "2", "server_requests": "2", "server_segments": "1",
               "server_codes": "64"}
BENCH_MEL_TOKENS = "50"  # the bench's codes a segment (its default 400)
BENCH_TIMEOUT = 420  # seconds a tool's process may take (all seven run at once)
BENCH_STDERR_LINES = 12  # the last lines of a tool's stderr printed


def tool_start(label: str, cmd, env: dict, tmp: str):
    """Start a tool's command from the checkout's root, its stdout and
    stderr going to files under `tmp`: (label, process, the two paths, the
    start time)."""
    here = os.path.dirname(os.path.abspath(__file__))
    out, err = (os.path.join(tmp, f"{label}.{k}") for k in ("out", "err"))
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=fo, stderr=fe, text=True)
    return label, proc, out, err, time.perf_counter()


def tool_wait(started, card: str):
    """Wait for a `tool_start`ed tool: its stdout's JSON lines; the last
    lines of stderr printed. Fails on a timeout (the process killed), a
    non-zero exit or a stdout line that is not JSON."""
    label, proc, out, err, t0 = started
    try:
        proc.wait(timeout=max(1.0, BENCH_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"[bench] {label}: no exit in {BENCH_TIMEOUT} s; stderr tail: "
             f"{Path(err).read_text()[-2000:]}")
    stdout, stderr = Path(out).read_text(), Path(err).read_text()
    for line in stderr.splitlines()[-BENCH_STDERR_LINES:]:
        print(f"[bench] {label} stderr: {line[:300]}")
    print(f"[bench] {label}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s; {card}")
    if proc.returncode != 0:
        fail(f"[bench] {label} exited {proc.returncode}; stderr tail: {stderr[-3000:]}")
    try:
        return [json.loads(line) for line in stdout.splitlines() if line.strip()]
    except ValueError:
        fail(f"[bench] {label}: a line is not JSON: {stdout[-2000:]}")


def positive(label: str, what: str, x) -> None:
    if not (isinstance(x, (int, float)) and math.isfinite(x) and x > 0):
        fail(f"[bench] {label}: {what} = {x!r}, not a finite number above 0")


def check_bench_lines(lines, name: str, card: str, layers: int) -> dict:
    """`python -m indextts_tpu_torch.bench`'s lines: progressive supersets
    of the headline, every section landed, the numbers finite and above 0,
    exactly BENCH_MEL_TOKENS codes a timed run and tokens/s against them
    over the timed runs' gpt_gen seconds, the card's name, and the default
    route's kernels (K4's launches exactly those of `layers` layers a step).
    Returns the last line."""
    if not lines:
        fail("[bench] bench printed no line")
    head, last = lines[0], lines[-1]
    for line in lines[1:]:
        if any(line.get(k) != v for k, v in head.items()):
            fail(f"[bench] a later line is no superset of the headline: {line}")
    if last["sections_skipped"] or last["sections_failed"]:
        fail(f"[bench] sections skipped {last['sections_skipped']}, failed "
             f"{last['sections_failed']}")
    for key in ("value", "tokens_per_s", "rtf", "batched_decode_tok_s",
                "batched_decode_tok_s_b16", "batched_e2e_audio_s", "beam3_audio_s"):
        positive("bench", key, last.get(key))
    for section in ("stages", "seq_tail", "batched_stages"):
        for k, v in last.get(section, {}).items():
            if k == "host_trim":  # a host step, rounded to ms: 0 is allowed
                if not (math.isfinite(v) and v >= 0):
                    fail(f"[bench] {section}.{k} = {v}")
            elif k != "segments":
                positive("bench", f"{section}.{k}", v)
    if set(last.get("stages", {})) != {"gpt_gen", "gpt_fwd", "s2mel", "bigvgan"} or \
            set(last.get("seq_tail", {})) != {"overlap", "inline", "segments"}:
        fail(f"[bench] sections: {last}")
    timed = last["timed_stages"]
    for k, v in timed.items():
        positive("bench", f"timed_stages.{k}", v)
    runs = int(BENCH_TOOLS["bench_runs"])
    codes = int(BENCH_MEL_TOKENS) * runs
    if last["codes_decoded"] != codes:
        fail(f"[bench] the timed runs decoded {last['codes_decoded']} codes, not "
             f"BENCH_MEL_TOKENS x BENCH_RUNS = {codes}")
    expect = last["codes_decoded"] / timed["gpt_gen"]
    if abs(last["tokens_per_s"] - expect) > 0.1 * expect:
        fail(f"[bench] tokens_per_s {last['tokens_per_s']} against {codes} codes over the "
             f"timed runs' gpt_gen {timed['gpt_gen']} s = {expect:.1f}")
    if last["device"]["name"] != name or last["device"]["power_limit_w"] is None:
        fail(f"[bench] device {last['device']} on {card}")
    # the default route: W8 blocks on K5 and K6 ("auto" on the card), K4's
    # attention once a layer a step after the first code
    launched = last["launches"]
    k4 = layers * (int(BENCH_MEL_TOKENS) - 1) * runs
    if any(not launched.get(k) for k in ("K2", "K3-bf16", "K5", "K6")) or any(
            launched.get(k) for k in ("K1", "K7", "K8")) or launched.get("K4") != k4:
        fail(f"[bench] the default route's launches: {launched} (K4 should be {k4})")
    return last


def bench_phase(model_dir: str, wav_path: str, tmp: str, card: str) -> None:
    """Phase `bench_phase`: each measurement tool of the port in a process
    of its own at full width, as a user runs it, at BENCH_TOOLS's settings,
    all at once so that their processes' start-ups overlap (the card is
    shared while they run: their numbers are checked, not compared; the
    server's two modes run as the two processes that run_server_bench.sh
    runs one after the other); each output held as the module docstring
    says and its headline printed on a line of its own."""
    import torch

    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    d = os.path.join(tmp, "bench")
    os.makedirs(d)
    # each tool's own defaults: this script's TARS_MAX_MEL_TOKENS and
    # TARS_STAGE_SYNC taken out
    env = {k: v for k, v in os.environ.items()
           if k not in ("TARS_MAX_MEL_TOKENS", "TARS_STAGE_SYNC")}
    py = [sys.executable, "-m"]
    cases = os.path.join(d, "cases.jsonl")
    Path(cases).write_text(json.dumps({"text": request_text(0)}) + "\n" + json.dumps(
        {"text": request_text(1), "emo_alpha": 0.6}) + "\n")
    iters = int(BENCH_TOOLS["s2mel_iters"])
    server = ["indextts_tpu_torch.tools.bench_server_concurrent", "--clients",
              BENCH_TOOLS["server_clients"], "--requests", BENCH_TOOLS["server_requests"],
              "--segments", BENCH_TOOLS["server_segments"], "--blocking-pass"]
    server_env = dict(env, TARS_MAX_MEL_TOKENS=BENCH_TOOLS["server_codes"])
    started = [
        tool_start("bench", py + ["indextts_tpu_torch.bench"], dict(
            env, BENCH_RUNS=BENCH_TOOLS["bench_runs"], BENCH_MEL_TOKENS=BENCH_MEL_TOKENS), d),
        tool_start("benchmark_infer", py + [
            "indextts_tpu_torch.tools.benchmark_infer", "--cases", cases, "--model-dir",
            model_dir, "--spk-audio", wav_path, "--output", os.path.join(d, "infer.json")],
            dict(env, TARS_MAX_MEL_TOKENS=str(MAX_MEL_TOKENS)), d),
        *(tool_start(f"bench_server_concurrent {mode}",
                     py + server + ["--mode", mode, "--port", str(free_port())], server_env, d)
          for mode in ("sequential", "continuous")),
        tool_start("bench_s2mel", py + [
            "indextts_tpu_torch.tools.bench_s2mel", "--shapes", BENCH_TOOLS["s2mel_shape"],
            "--iters", str(iters)], env, d),
        tool_start("bench_w4", py + ["indextts_tpu_torch.tools.bench_w4"],
                   dict(env, BENCH_W4_STEPS=BENCH_TOOLS["w4_steps"]), d),
        tool_start("bench_decode_kernels", py + [
            "indextts_tpu_torch.tools.bench_decode_kernels", "--steps",
            BENCH_TOOLS["decode_steps"], "--batches", BENCH_TOOLS["decode_batches"]], env, d)]
    try:
        done = {s[0]: tool_wait(s, card) for s in started}
    finally:
        for s in started:
            if s[1].poll() is None:
                s[1].kill()
                s[1].wait()

    from indextts_tpu_torch.config import load_config

    lines = done["bench"]
    last = check_bench_lines(lines, name, card, load_config().gpt.layers)
    print(f"[bench] bench: {len(lines)} lines; last: {json.dumps(last)}")

    summary = done["benchmark_infer"][-1]
    print(f"[bench] benchmark_infer: {json.dumps(summary)}")
    if summary["cases"] != 2:
        fail(f"[bench] benchmark_infer: {summary}")
    for row in summary["results"]:
        for k in ("gen_time_s", "audio_dur_s", "rtf", "hbm_peak_gb"):
            positive("benchmark_infer", f"case {row['case']} {k}", row[k])

    n = int(BENCH_TOOLS["server_clients"]) * int(BENCH_TOOLS["server_requests"])
    for mode in ("sequential", "continuous"):
        res = done[f"bench_server_concurrent {mode}"][-1]
        print(f"[bench] bench_server_concurrent --mode {mode}: {json.dumps(res)}")
        if res["n_results"] != n or res["blocking"]["n_results"] != n or \
                res["device"]["name"] != name:
            fail(f"[bench] {mode}: {res}")
        for part, r in ((mode, res), (f"{mode} blocking", res["blocking"])):
            for k in ("wall_s", "aggregate_audio_s", "aggregate_audio_s_per_s",
                      "total_p50_s", "total_p95_s", "ttfb_p50_s", "ttfb_p95_s"):
                positive("bench_server_concurrent", f"{part} {k}", r[k])

    s2 = done["bench_s2mel"][-1]
    print(f"[bench] bench_s2mel: {json.dumps(s2)}")
    shape = BENCH_TOOLS["s2mel_shape"]
    for kind, kernel in (("fp32", "K3"), ("bf16", "K3-bf16")):
        positive("bench_s2mel", f"{shape}_{kind}_ms", s2.get(f"{shape}_{kind}_ms"))
        if s2["launches"][f"{shape}_{kind}"] != {kernel: 260 * iters}:
            fail(f"[bench] bench_s2mel {kind} launches: {s2['launches']}")

    w4 = done["bench_w4"][-1]
    print(f"[bench] bench_w4: {json.dumps(w4)}")
    positive("bench_w4", "w4_over_w8", w4["w4_over_w8"])
    for run in w4["runs"]:
        positive("bench_w4", f"{run['tag']} tok_s", run["tok_s"])
        gemv = {k for k in ("K5", "K6", "K7", "K8") if run["launches"].get(k)}
        if not run["launches"].get("K4") or gemv != ({"K7", "K8"} if run["gemv"] else set()):
            fail(f"[bench] bench_w4 {run['tag']} launches: {run['launches']}")

    dk = done["bench_decode_kernels"][-1]
    print(f"[bench] bench_decode_kernels: {json.dumps(dk)}")
    for run in dk["runs"]:
        positive("bench_decode_kernels", f"{run['tag']} B={run['B']} tok_s", run["tok_s"])
        want = {"K4" if run["cache"] == "int8" else "K1"} | (
            {"K5", "K6"} if run["gemv"] else set())
        got = {k for k in ("K1", "K4", "K5", "K6", "K7", "K8") if run["launches"].get(k)}
        if got != want:
            fail(f"[bench] bench_decode_kernels {run['tag']} B={run['B']} launches: "
                 f"{run['launches']}")
    print(f"[bench] bench_phase done in {time.perf_counter() - t0:.1f} s; {card}")


def main():
    if len(sys.argv) > 1:
        fail(f"takes no arguments, got {sys.argv[1:]}")
    t_start = time.perf_counter()
    card = environment()
    import torch

    from indextts_tpu_torch.config import load_config

    cfg = load_config()
    g = cfg.gpt
    shapes = main_path_shapes(cfg, MAX_MEL_TOKENS)
    print(f"main-path shapes: {json.dumps(shapes)}")
    # the longest segment the default config allows
    longest = main_path_shapes(cfg, cfg.runtime.max_mel_tokens)
    kernels = [check_k1(shapes, g.layers, g.heads),
               check_k2(shapes, longest["snake"]),
               check_k3(shapes, longest, cfg.s2mel.dit.num_heads),
               check_k4(shapes, g.layers, g.heads),
               check_k5(g.layers, g.model_dim, g.number_mel_codes),
               check_k6(g.layers, g.model_dim),
               check_k7(g.layers, g.model_dim),
               check_k8(g.layers, g.model_dim),
               check_k2_bf16(shapes, longest["snake"]),
               check_k3_bf16(shapes, longest, cfg.s2mel.dit.num_heads),
               *check_k9_k10(shapes, longest, cfg.s2mel.dit.num_heads)]
    print(f"phases 1-2 (environment, kernels) done at {time.perf_counter() - t_start:.1f} s")
    names = [k["name"] for k in kernels]
    k1, k6, bf16 = names[0], names[5], names[8:]
    routes = {  # label: (config change, kernels that must run, kernels that must not)
        "float": (lambda c: c, names[:3], names[3:]),
        "quantized": (quantized, names[1:6], [k1] + names[6:]),
        "w4": (lambda c: quantized(c, wbits=4, gemv_impl="auto"),
               names[1:5] + names[6:8], [k1, k6] + bf16),
    }
    with tempfile.TemporaryDirectory() as tmp:
        wav_path = os.path.join(tmp, "speaker.wav")
        speaker_wav(wav_path)
        # float32 on both sides, summed in another order by cuBLAS/cuDNN than
        # by the CPU kernels: 1e-4 of the largest mel value; the waveform adds
        # PCM16 rounding (3e-5 a step)
        small_reference(wav_path, small_config(), "float", 1e-4, 1e-3)
        # int8 rounding of activations, KV and the MLP hidden turns float32
        # noise between the devices into occasional one-step flips, each up
        # to 1/127 of a row's largest value: 1e-2
        small_reference(wav_path, quantized(small_config()), "quantized", 1e-2, 1e-2)
        # D=256 (4 heads of 64) opens K7's and K8's gates
        small_reference(wav_path, quantized(small_config(256), wbits=4), "w4", 1e-2, 1e-2)
        print(f"small configurations done at {time.perf_counter() - t_start:.1f} s")
        os.environ["TARS_MAX_MEL_TOKENS"] = str(MAX_MEL_TOKENS)
        # each stage's seconds hold its time on the card (runtime/engine.py)
        os.environ["TARS_STAGE_SYNC"] = "1"
        full = load_config()
        model_dir, host, aux = reference_dir(full, tmp)
        print(f"phase reference_dir done at {time.perf_counter() - t_start:.1f} s")
        cache_phase(model_dir, full, wav_path, card)
        print(f"phase cache_phase done at {time.perf_counter() - t_start:.1f} s")
        launches, beam_launches, batch_launches = {}, {}, {}
        for label, (change, rise, stay) in routes.items():
            # the quantized routes' decode turns at one round (graph,
            # eager), which keeps the script's time with bf16_phase added
            counts, engine = serve_full_width(
                wav_path, change(full), label, rise, stay, tmp, model_dir,
                precompile=label == "float",
                written=(host, aux) if label == "float" else None,
                decode_rounds=DECODE_ROUNDS if label == "float" else 1,
                card=card, server_test=label == "float")
            host = aux = None  # the float route held its engine to them
            if label == "float":  # the s2mel stage does not depend on the GPT's route
                s2mel_turns(engine, wav_path, label)
                tail_turns(engine, wav_path, label)
                native_dsp_phase(engine, wav_path, card)
                prefix_phase(engine, wav_path, label, card)
                stream_phase(engine, wav_path, label, tmp, card)
                emotion_phase(engine, wav_path, label, tmp, card, rise, stay)
                beam_launches[label] = beam_phase(engine, wav_path, label, tmp, rise, stay)
                batch_launches[label] = batched_phase(engine, wav_path, label, rise, stay)
                sampling_phase(engine, wav_path, label, card)
                launches.update(bf16_phase(engine, wav_path, model_dir, full, tmp, names))
                print(f"phase bf16_phase done at {time.perf_counter() - t_start:.1f} s")
            else:
                if label == "quantized":  # W8 + int8 KV, attn_impl "auto" (xla)
                    prefix_phase(engine, wav_path, label, card)
                beam_launches[label] = beam_request(engine, wav_path, label, tmp, rise, stay)
                batch_launches[label] = batched_request(engine, wav_path, label, rise, stay,
                                                        eager_check=label == "quantized")
            # each kernel's launches come from the route that runs it first
            for name in rise:
                launches.setdefault(name, counts[name])
            serve_continuous(wav_path, engine, label, rise, stay, tmp, card)
            # one engine on the card at a time
            del engine
            gc.collect()
            torch.cuda.empty_cache()
            print(f"{label} engine freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                  f"still allocated; route done at {time.perf_counter() - t_start:.1f} s")
        tools_phase(model_dir, wav_path, tmp, card)
        print(f"phase tools_phase done at {time.perf_counter() - t_start:.1f} s")
        eval_phase(model_dir, wav_path, tmp, card)
        print(f"phase eval_phase done at {time.perf_counter() - t_start:.1f} s")
        soak_phase(model_dir, tmp, card)
        print(f"phase soak_phase done at {time.perf_counter() - t_start:.1f} s")
        bench_phase(model_dir, wav_path, tmp, card)
        print(f"phase bench_phase done at {time.perf_counter() - t_start:.1f} s")
    v1_phase(card)
    print(f"phase v1_phase done at {time.perf_counter() - t_start:.1f} s")
    dilation_phase(card)
    print(f"phase dilation_phase done at {time.perf_counter() - t_start:.1f} s")
    launches.update(train_phase(shapes, card))
    parallel_phase(card)
    tp_train_phase(shapes, card)
    print(f"phase tp_train_phase done at {time.perf_counter() - t_start:.1f} s")
    dryrun_phase(card)
    print(f"phase dryrun_phase done at {time.perf_counter() - t_start:.1f} s")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(f"launches a {BEAMS}-beam request (beam-multinomial, {MAX_MEL_TOKENS} steps at "
          "most): " + json.dumps({label: {k: n for k, n in counts.items() if n}
                                  for label, counts in beam_launches.items()}))
    print(f"launches a batched {CONT_REQUESTS}-segment request ({MAX_MEL_TOKENS} codes a "
          "segment at most): " + json.dumps({label: {k: n for k, n in counts.items() if n}
                                             for label, counts in batch_launches.items()}))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
