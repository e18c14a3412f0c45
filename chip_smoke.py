#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py    # every phase (needs one card)

Phases (any failure exits non-zero and prints no result line):
  1. device: require CUDA; print `nvidia-smi` name and power limit;
  2. build: compile every CUDA kernel of the port from this checkout (the
     two flash sources and the paged decode source, one nvcc each, all
     started together), print each source's ptxas report (registers,
     shared memory, spills) and the count of tensor-core instructions in
     each flash kernel's SASS: HGMMA (wgmma) in the bf16 one and HMMA
     .TF32 (mma.sync, 3xTF32) in the f32 one, neither of which may be 0;
  3. kernels: hold each kernel against its plain PyTorch version on the
     card (flash: bf16 on the wgmma kernel, f32 on the 3xTF32 kernel;
     paged decode: its launch plan (cluster, stages, shared memory, the
     clusters the card holds at once) and ptxas report first, then both
     routes over ragged frontiers, an all-NULL row, stale tenants and a
     shared block, bt 16 and 64, D 128 and 64, and block counts around
     the cluster size, each case launched twice with bit-identical
     results), then time kernel, plain version and the PyTorch library
     call as device time (CUDA events around calls queued behind a spin
     kernel, so the card runs them back to back), beside the issue rate of
     back-to-back calls, the card's bound and the library call's backend;
     and both flash routes' device-meta form ({row, q_offset, valid_len}
     read on the card, what a captured prefill graph replays; D 64/128/256,
     fresh, append over row 2 of a pool at offsets 0, 256 and 3840, a
     ragged valid length) against the plain version, the host-int form
     under the same plan (bit for bit) and itself launched twice (bit for
     bit), with its device time beside the host-int form's at each timed
     shape;
  4. model parity: the flagship at full width and 2 layers in f32 prefills
     a 600-token prompt in chunks (fresh flash, append flash, masked tail)
     and decodes 16 greedy tokens, once into a contiguous cache and once
     through a paged pool (bt 16, decode on the paged kernel's f32 route),
     on the card, against the contiguous run on the CPU: logits agree
     within 2e-3 and the greedy tokens are identical;
  4b. graphs: the full flagship (28 layers, bf16, seed 0), 4 slots with
     ctx 4096, contiguous and paged (1024 blocks of 16): 16 replays of
     the decode step's captured CUDA graph equal 16 eager steps (tokens,
     logits, KV bytes, carries) over rows at different positions, one
     sampled (temperature 0.8, top_k 50) and one free; the replay's
     device and wall ms beside the eager step's; generate's captured
     16-step chunks equal the step-by-step loop, greedy and sampled;
  4c. prefill graphs: the same flagship, 4 slots with ctx 4096, contiguous
     and paged (1024 blocks of 16): a 600-token prompt's three chunks
     (fresh 256, append 256, masked tail 88 in bucket 128) into row 2,
     beside another tenant in row 0, through the pool's captured prefill
     programs (every start program captured, each warm-up and capture
     under torch.cuda.set_sync_debug_mode("error")) equal the eager
     host-int chunks bit for bit in logits and every KV byte; each
     chunk's replay device and wall ms beside the eager chunk's;
  5. serving: the full flagship (28 layers, bf16, seed 0) behind the
     port's HTTP server with 4 slots and ctx 4096 (contiguous pool, prefix
     cache on at its default; every decode step and every prefill chunk a
     graph replay) answers 4 concurrent chats and one SSE chat;
     each concurrent result equals the same request sent alone (a rerun
     may hit the prefix cache), and the bf16 flash kernel's launch counts
     show both modes ran;
  6. prefix and paged serving, same model and server: (a) a paged pool of
     1024 blocks of 16 tokens answers phase 5's chats, each equal to the
     same request alone, with 28 paged decode launches per replay of the
     engine's decode graph and both flash modes launched by the paged
     prefill;
     (b) four chats sharing a 560-character system message hit at least
     512 prompt tokens after the first, in both modes (blocks shared
     while they run, in paged mode), with tokens equal to the same mode
     with the cache off; (c) (a)'s chats on a 96-block pool, the last two
     arriving while the first two decode: at least one swap preemption,
     no failure, tokens equal to (a)'s; then the same under
     preempt_mode="recompute": at least one recompute preemption replayed
     through the prefill graphs, tokens equal to (a)'s;
  7. the flagship (4 of its 28 layers, cut for the whole run's time)
     written as a checkpoint directory, loaded bit for bit and served
     through `cli serve DIR`, contiguous and paged;
  8. OLMo2, EXAONE4 and Phi-4 at their published widths, depth cut:
     f32 card vs CPU, bf16 graph vs eager, EXAONE4 served paged;
  9. Gemma-3-1B at its published widths (head_dim 256, window 512, GQA
     4/1, sandwich (1+w) norms, GELU-tanh, local RoPE, vocab 262144):
     (a) f32 at 6 layers (one global) against the CPU on a 600-token
     prompt that wraps the 512-token rings, contiguous and paged; (b) 6
     of its 26 layers (one global; cut for the whole run's time) in bf16,
     written as a checkpoint with a Gemma-style
     byte-fallback tokenizer and loaded through build_text_model: 16
     captured decode replays equal 16 eager steps in both pools; (c) the
     same directory served through `cli serve DIR`, contiguous and paged:
     4 concurrent chats and one SSE chat, all 200, each equal alone and
     in company, the engine's prompt ids those of a fresh CPU tokenizer;
  10. fault drills (run after phase 6, on its model: the full flagship,
     28 layers, bf16, 4 slots, ctx 4096, chunk 256, prefix cache off),
     each driven by the port's own fault hook (serve/faults.py): (a)
     contiguous and (b) paged (1024 blocks of 16), three concurrent
     greedy chats of ~630 tokens under raise_on_step=6;kind=device
     (installed once all three decode) give
     the tokens of the same chats on the same engine with no plan, in one
     rebuild, whose replay raises the flash launches (fresh and append)
     and the prefill graph replays by exactly the replay's chunks, at
     unchanged addresses and graphs (and, paged, the paged decode kernel
     launching after it); the rebuild's wall ms and replayed tokens per
     slot printed; (c) over HTTP, a chat holding the poison token that
     joins two decoding chats answers 500 and they answer 200 with their
     tokens alone; (d) rebuild_budget=1 and restore_interval_s=0.5: 503
     with Retry-After on the JSON and the SSE path and /health 503 with
     engine.down, then, revived, the chat's undisturbed answer; (e)
     step_watchdog_s=0.25 and a 1.5 s stall: /health 503 while wedged,
     then 200, the tokens unchanged; (f) a device fault while a
     2000-token admission is still prefilling beside a decoding chat:
     one rebuild that replays the chat and restarts the admission, both
     answering the tokens of a run with no plan, the flash launches
     rising by the replay's plus the restart's repeated chunks;
  11. QoS, deadlines, tenants and the metrics plane (run after phase 10,
     on its model, over HTTP; 4 slots, ctx 4096, prefix cache off): (a)
     every slot held by a long batch chat (X-Cake-QoS: batch), 4 batch
     then 2 interactive chats queued: both interactive chats are admitted
     first (read from the timelines), every chat answers 200, and each
     interactive chat's tokens equal it alone; (b) a 96-block pool with
     two batch decoders: an interactive arrival preempts a batch slot,
     never itself, and every chat's tokens equal it alone, under swap and
     under recompute; (c) a queue deadline of 0.5 s with every slot busy
     answers 503 with Retry-After, a request deadline of 2 s answers 504
     within about an iteration of it and frees the slot, each timeout
     counter moving by exactly one; (d) tenant t1:rps=1,burst=1: its
     second chat answers 429 tenant_quota with Retry-After, another
     tenant 200; (e) with the span recorder on, phase 5's traffic:
     /api/v1/trace is a Chrome trace with serve.step and one
     serve.prefill_chunk per prefill graph replay, /metrics parses and
     holds non-zero TTFT / ITL / e2e histograms (by class too), a
     request's timeline runs enqueue -> admit -> prefill_chunk ->
     first_token -> finish, /api/v1/slo and /api/v1/flight answer; (f)
     each of those requests' TTFT split (template + encode, queue wait,
     its chunks' spans, the time between its chunks), and TTFT p50 with
     the recorder off and on in turns, 2 rounds each (smoke); flash and
     paged decode launch counts printed;
  12. speculative decoding (run after phase 11, on its model; k = 6):
     (a) the paged decode kernel on a verify's flattened rows (row (b, i)
     at frontier p + i) against its plain version, bf16 and f32, at 16/8
     D 128 and 4/1 D 256: drafts straddling a block boundary, a padded
     window, a one-token window, an inactive slot, a shared prefix block,
     4 slots at the serving frontier, deep rows; each launched twice, bit
     for bit; timed at 4 slots at p = 620 beside the plain version, the
     library call over gathered rows, the decode call, and the bounds
     over the unique bytes and over the bytes read; (b) the full
     flagship, 4 slots with ctx 4096, contiguous and paged: 16 replays of
     the captured verify equal 16 eager verify steps (packed ids, logits,
     KV bytes and positions, carries) with a row of right drafts, one of
     wrong drafts, a sampled row (0.8 / top_k 50) and a free one; the
     replay's device and wall ms beside the decode step's; (c) served over
     HTTP with the n-gram drafter, both pools (the paged one built by
     `cli serve --flagship` under CAKE_SPEC=ngram): 4 concurrent greedy
     chats of 64 tokens whose prompts state a passage twice, then each
     alone: every chat 200, drafts accepted, alone == in company, the
     paged verify launching 28 times per replay, one spec.verify span per
     replay in /api/v1/trace, the spec counters of /metrics moving, and
     the text equal to speculation off except after a near tie (a
     spec-off top-2 logit gap under 0.05, printed); then phase 6(c)'s
     96-block pool under swap with windows of 32 rejected drafts (tails
     trimmed before a swap), and two chats on a pool that runs out while
     they decode (windows degraded to plain steps), each chat's tokens
     its plain stream's; accept rate, tokens per verify and decode rate
     printed; (d) the 2-layer f32 parity model: generate with the n-gram
     drafter and with itself as draft model equals plain generate (every
     draft of the latter accepted), and (c)'s prompts served with
     speculation on equal speculation off exactly, in both pools;
  13. Qwen3-Next at Qwen3-Next-80B-A3B's widths (hidden 2048, 16/2 heads
     of D 256 with a sigmoid output gate and partial RoPE 0.25, Gated
     DeltaNet layers of 16x128 key and 32x128 value heads, 512 experts
     top 10 with a shared expert; seeded weights drawn on the card): (a)
     both flash routes at 16/2 D 256 (fresh, a ragged valid length,
     append, the device-meta form) and both paged routes on decode rows
     and on a verify's flattened rows, each against its plain version and
     launched twice bit for bit, and timed beside the library call and
     the bound; (b) f32 at 2 layers (linear, full): a 600-token prompt in
     chunks and 16 greedy steps, contiguous and paged on the card, against
     the CPU: logits within 2e-3, tokens identical; (c) bf16 at 4 of 48
     layers (3 linear, 1 full, all MoE; cut from 12 for the whole run's
     time), 4 slots, ctx 4096, both pools:
     16 decode replays equal 16 eager steps (KV, conv and recurrent state
     included), the prefill graphs equal the eager chunks, the captured
     verify (k 6) equals the eager verify with right and wrong drafts,
     and after the wrong row the linear state equals a plain step's;
     replay ms beside eager; (d) the same model over HTTP, contiguous then
     paged: 4 concurrent chats and one SSE chat equal alone, the shared
     system message hitting the prefix cache (tokens equal to the cache
     off), the 96-block pool under swap and recompute, and speculation:
     an oracle drafter proposing the plain stream (its partings printed:
     in bf16 a verify row's top-2 gap differs from the decode step's on
     the same prefix by more than the near tie), then CAKE_SPEC=ngram
     with tokens equal to speculation off; then in float32 at 2 layers
     (linear, full) the oracle's chats, arriving in a fixed order through
     both pools, equal to the plain stream, the drafts accepted; (e) 4 layers
     written as an HF checkpoint (in_proj_qkvz / in_proj_ba,
     experts.{e}.*), loaded bit for bit and served through `cli serve
     DIR`;
  14. quantized checkpoints: (a) the FP8 dequant kernel
     (csrc/fp8_dequant.cu) against its plain version at the flagship's
     q_proj and gate_proj, Qwen3-8B's gate_proj and down_proj, cropped
     edge blocks (200 x 300), a tail (129 x 17) and every e4m3 code, bf16
     and f32, each launched twice, bit for bit (NaN at the same places),
     timed beside the plain version and the bound; (b) the flagship in
     Qwen's FP8 layout (float8_e4m3fn projections with 128 x 128
     weight_scale_inv), loaded at load and native through
     build_text_model (device memory after each): 2 layers in f32 on the
     card against the CPU; in bf16 (4 of its 28 layers, cut for the
     whole run's time) native logits and tokens equal at load's, 16
     decode replays equal eager steps, the prefill graphs the
     eager chunks and the captured verify (k 6) the eager verify, in both
     pools, with replay device ms native beside at load; served through
     `cli serve DIR --fp8-native`, contiguous and paged (4 chats + 1 SSE,
     each equal alone), tokens equal to the at-load server's; (c)
     Qwen3-8B's widths (assumed) at 12 of its 36 layers (cut from 36 to
     keep the whole run inside its limit) in the same
     layout, drawn and quantized on the card: memory native against at
     load, native tokens equal at load's, 8 decode replays equal eager in
     both pools with replay device ms native beside at load, then served
     native, paged: 4 concurrent chats each equal alone; (d) AutoGPTQ
     4-bit (group 128; desc_act false, and true with a permuted g_idx)
     and (e) GGUF (Q8_0, and a Q4_K_M-style Q4_K / Q6_K mix) at the
     flagship's widths and 4 of its 28 layers (cut for the whole run's
     time), each served through `cli serve DIR` (the formats take the
     contiguous and the paged pool in turns), its card parameters equal
     to a CPU load bit for bit, each chat equal alone;
  15. expert offload (module 10b; run right after phase 13, on its 4-layer
     checkpoint, which it then deletes) at Qwen3-Next-80B-A3B's widths,
     the experts read from the checkpoint into an LRU of 32 per layer: (a)
     bf16, 4 of 48 layers: the resident model, then (freed) the
     offloaded one: memory after each load (the offloaded one the trunk
     alone), first-step logits equal, 16 greedy tokens of a 320-token
     prompt equal, one flash (bf16, fresh) launch per full-attention
     layer, the memory held at most the trunk plus the LRUs, TTFT, decode
     rate, expert reads per token, the LRU's hit share and the GB/s
     read; (b) Qwen's FP8 layout at 4 of 48 layers (cut from 12 to keep
     the whole run inside its limit; 7 GB written after
     a check of the free disk): the same against the resident model
     dequantized at load, three dequant launches per expert read, the
     dequant kernel at an expert's gate_proj against its plain version
     and timed, and the projection of the trunk and the LRUs to 48
     layers; (c) `cli serve DIR --expert-offload`: two concurrent chats
     answered one at a time, each equal to generate, SSE equal to JSON,
     `stop` trimming; then phase 7's 8-layer flagship checkpoint in
     float32 under
     CAKE_SERVE_SLOTS=0 (no engine: the locked path) and under
     CAKE_KV_BLOCKS=1024 (a paged pool of 1024 blocks), each locked
     answer equal to the engine's;
  16. float16 models (module 16): (a) the three f16 kernel routes
     against their plain versions and timed beside the bound and the
     library call: the flash kernel's f16 entry, fresh and append at the
     flagship's 16/8 D 128 and at 4/1 D 256, its device-meta form equal
     to its host-int form bit for bit; the paged decode kernel's f16
     route at 16/8 D 128, 4 rows at p = 620, and its verify form; the FP8
     dequant kernel's f16 output at every shape, bit for bit, timed at
     2048 x 1024 and 12288 x 4096; (b) the flagship at f16 (28 layers,
     seed 0): the hidden state finite after every layer of a 256-token
     prefill (its largest magnitude printed); then at 4 of its 28 layers
     (cut for the whole run's time) for (b)-(e): 16 decode replays equal
     eager steps and the prefill graphs the eager chunks, contiguous and
     paged; (c) generate with the n-gram drafter equal to plain generate
     up to a near tie, and the captured verify equal to eager verify
     steps in both pools; (d) served over HTTP, contiguous and paged: 4
     concurrent chats and one SSE chat, each equal alone, only the f16
     flash route launched, TTFT and tokens/s printed; then paged with the
     n-gram drafter (k 6): phase 12's 4 chats, each equal alone, tokens
     equal to the plain stream up to a near tie, one f16 paged verify
     launch per layer per verify replay; (e) the flagship
     in Qwen's FP8 layout served at f16 with native projections: tokens
     equal the model dequantized at load, the dequant kernel's f16 output
     launched inside the captured graphs;
  17. the layer-sharded cluster (module 13a): the flagship (16 of its 28
     layers, cut for the whole run's time; seed 0) written as a
     checkpoint and served across processes on the
     one card: worker w0 a `python3 -m cake_tpu_torch.cli worker`
     subprocess, w1 a WorkerServer on a thread of this process, a
     topology file on 127.0.0.1 giving them layers 4-7 and 8-11, the
     master (runtime.build_text_model with a cluster key) the rest,
     weights streamed with CRC32 (GB/s printed); (a) float32: 32 greedy
     tokens of a chat prompt and of a 1100-token prompt (pipelined
     prefill, 3 chunks) equal the single-process TextModel's; (b) w0
     SIGKILLed after token 10 and restarted by `cli worker`: exactly one
     replay, the continuation equal to the unfailed run; (c) bf16: TTFT
     and decode tokens/s against the single-process model, each hop's
     RTT split into read, deser, fwd, ser and wire, the flash launches of
     the master's local stages and of w1's chunks; (d) `cli serve
     --cluster-key --topology`: a chat answered, /api/v1/topology listing
     both nodes, /health 200;
  18. FLUX.1-dev text-to-image (module 14a): the FP8 dequant kernel's
     bf16 output against its plain version at every FLUX.1-dev weight
     shape (qkv 9216 x 3072 to linear1 21504 x 3072, and the cropped
     edges img_in 3072 x 64 and final_out 64 x 3072), with blockwise and
     with one per-tensor scale, launched twice, bit for bit, timed at the
     largest and the two edges beside the plain version and the bound;
     (a) `cli serve --flagship --layers 1 --slots 0 --image-model
     demo:flux1-dev --fp8-native`: FLUX.1-dev's full widths and depth (19
     + 38 blocks, T5-XXL, CLIP-L, the VAE) on seeded weights, the MMDiT's
     314 weights native FP8, the device memory against the parameters'
     bytes; a 512 x 512 image (4 steps) through /v1/images/generations
     as b64_json and a 1024 x 1024 one (2 steps) through /api/v1/image as
     a raw PNG, each a valid PNG of its size, with 314 dequant launches
     per step; seconds per step, text encoders and VAE decode, and peak
     memory printed; (b) the same FP8 values dequantized at load, weight
     by weight: latents equal the native model's bit for bit at the same
     seed; (c) FLUX.1-dev's widths at 2 double, 2 single and 2 T5 layers
     written as a ComfyUI bundle (FP8 with per-tensor scales) and loaded
     native through runtime.build_image_model: latents equal the seeded
     model's bit for bit, and a valid PNG;
  19. SD 1.5 and SDXL (module 14b; no hand-written kernel: the UNet's
     attention is the reference's plain float32 one): (a) SDXL base's
     published widths and depth (blocks 320 / 640 / 1280, heads 5 / 10 /
     20, depth 1 / 2 / 10, context 2048, text_time 2816, CLIP-L and
     OpenCLIP bigG, VAE 0.13025) seeded in bf16, written as a diffusers
     directory (bench/synth_sd.py) and served by `cli serve --flagship
     --layers 1 --slots 0 --image-model DIR`: a 1024 x 1024 image (4
     steps) with a negative prompt as b64_json and one with an empty
     negative prompt (the zeros path) as a raw PNG, each a valid PNG of
     its size; seconds per step, text encoders and VAE decode, device
     memory held against the parameters' bytes, and peak; (b) SD 1.5's
     published widths with a tokenizer/ of vocab.json + merges.txt only:
     img2img at 512 x 512, strength 0.6, from an RGBA PNG whose rows use
     all five filters, through `cli image DIR --init-image`; one txt2img
     (3 steps) through `cli serve --image-model DIR --sd-intermediate-every
     2 --sd-trace-dir T`: the intermediate PNG decodes, the trace parses,
     its kernel events are counted and a UNet step's device time is
     split by class (attention, conv, GEMM, other); (c) SD 1.5, SD 2.1 (v-prediction,
     per-level heads, gelu encoder) and SDXL at their widths cut to 2
     levels, transformer depth 1 and 2 encoder layers, float32 with TF32
     off (restored after): the UNet's output and a 3-step latent on the
     card against the card's machine's CPU, and each written directory
     loaded through runtime.build_image_model equal to the seeded model
     bit for bit (parameters and latents);
  20. FLUX.2-klein (module 14c; no hand-written kernel: its encoder and
     image attention are the reference's plain ones, and the flash launch
     counts must not move): (a) `cli serve --flagship --layers 1 --slots 0
     --image-model demo:flux2-klein`, klein-4B's transformer (hidden 3072,
     24 heads of 128, 5 double and 20 single blocks, MLP 9216, in 128,
     context 7680), its Qwen3-4B encoder's layers 0-26 (hidden 2560,
     32/8 heads of 128, intermediate 9728, vocab 151936; captures 8, 17
     and 26) and its 32-channel VAE (base 128, (1, 2, 4, 4), 3 res
     blocks) seeded in bf16 (the VAE float32): one 1024 x 1024 image as
     b64_json and one 512 x 512 raw PNG over HTTP, 4 steps each; seconds
     per step, encoder and VAE seconds, device memory held against the
     parameters' bytes; (b) the same widths cut to 1 + 1 blocks and
     encoder layers 0-2, float32 with TF32 off, card against the CPU: the
     encoder's three captures, one flux2_forward and 3 Euler steps at 128
     x 128 within 1e-4; (c) that cut seeded in bf16, written as a
     diffusers directory (bench/synth_flux2.py) and served through `cli
     serve --image-model DIR`: its tree equals the seeded one bit for bit
     and the served image the in-memory model's pixel for pixel;
  21. VibeVoice (module 14d's first part; no hand-written kernel: its
     LMs take the masked attention path, flash off, as the reference's):
     (a) `cli serve --flagship --layers 1 --slots 0 --audio-model
     demo:vibevoice-0.5b --voices-dir V`, VibeVoice-Realtime-0.5B's
     widths (Qwen2.5-0.5B's decoder, hidden 896, 14/2 heads, intermediate
     4864, split 4 + 20 layers (assumed), acoustic dim 64, ratios 8 5 5 4
     2 2, hop 3200, decoder depths 3-3-3-3-3-3-8) seeded in bf16 (the VAE
     float32): a WAV, a PCM (the WAV's data chunk), a voice_b64 clone of
     a 1 s WAV and a named voice-prompt file, each a valid answer;
     frames, seconds per frame, VAE seconds and the real-time factor; (b)
     those widths cut to 1 + 2 layers, float32 with TF32 off, card
     against the CPU: the served sentence's whole generate_speech (27
     frames over 3 text windows) from the same per-frame noise, the card
     teacher-forced with the CPU's latents so that the loop does not
     compound the roundings: the same frames, each frame's condition,
     latent and EOS probability within 1e-4, the VAE decoder on the same
     latents within 1e-4 and the waveforms within 1.5e-3 (the decoder's
     gain); with the EOS bias raised both stop after 3 frames;
     (c) that cut seeded in bf16, written as a checkpoint directory with
     a byte-level BPE tokenizer (bench/synth_vibevoice.py) and spoken by
     `cli tts DIR`: the WAV's header parses and its bytes equal the
     in-memory model's;
  22. LuxTTS (module 14d's remainder; no hand-written kernel: Zipformer
     attention, the depthwise convolutions and the GEMMs are plain
     PyTorch, as the reference's are plain XLA): (a) the published widths
     (text encoder 192 x 4, FM decoder 512 with stacks 2-2-4-4-4,
     downsampling 1-2-4-2-1 and kernels 31-15-7-15-31, Vocos 512 x 8, 100
     mels, n_fft 1024, hop 256 at 24 kHz) seeded in bf16, written by
     bench/synth_luxtts.py (the Vocos float32) and served by `cli serve
     --flagship --layers 1 --slots 0 --audio-model DIR`: a WAV, a PCM (the
     WAV's data chunk) and a voice_b64 clone of a 1 s 16 kHz WAV, each a
     valid 48 kHz answer; frames, seconds per velocity evaluation, the
     vocoder's and the host ISTFT's seconds, the real-time factor, the
     memory held against the parameters, and the eager operations of one
     velocity evaluation; (b) those widths cut to a 1-layer text encoder,
     FM stacks 1-1-1-1-1 and a 2-layer Vocos, float32 with TF32 off, card
     against the CPU from the same noise over 10 Euler steps: the text
     condition, x after each step and the vocoder's log-magnitude and
     phase on the same input within 1e-4, the waveforms within 1e-3; (c)
     that cut seeded in bf16, written with a tokens.txt and spoken by `cli
     tts DIR`: the WAV's header parses and its bytes equal the in-memory
     model's;
  23. the fleet (modules 15a and 15b): replicas of the flagship (28
     layers, bf16, seed 0, paged: 1024 blocks of 16, the KV-share tier
     on) on the one card behind a `cli route --autoscale` subprocess (no
     torch in it; 1 in flight per replica, 2 in all, a 0.5 s probe, 2
     replicas at least and at most): r1 this process's server (so its
     kernels' counts can be read), static, and the rest `cli serve
     --announce` processes the router's lifecycle spawns. (0) the
     below-min rule spawns r0 while r1 builds, admitted only after its
     /health answered 200 and found by one discover_replicas call with
     role "serve"; r1, ejected by the default policy while it built, is
     readmitted once it serves; (a) four two-turn greedy SSE
     conversations under ~600-token system heads of their own, two
     owned by each replica, each turn landing on its rendezvous owner
     (the router's timeline) with the content of the same request sent
     straight to that replica, turn 2 hitting its prefix there; (b) a
     burst of 6 concurrent chats: each a 200 or a 429 with shed_by
     "router" and Retry-After, at least one 429, and /metrics' shed
     counter equal to the 429s; (f) a follow-up warmed on r0 and sent to
     cold r1 with the peer directory of a second router in this process
     (its registry holds r0 and r1 as static replicas): r1 fetches r0's
     prefix blob under the 2 s fetch deadline, answers byte for byte as
     r0 did, splices the fetched tokens and prefills the suffix through
     flash append (chunks x 28 launches); the fetch's phases beside the
     cold TTFT; (c) a 96-token stream owned by r0, r0 SIGKILLed once the
     client holds 8 content events: its blob a source_miss, the one
     stream ends on r1 in one finish event and one [DONE], one resume
     counted, its resumed text equal to r1's own continuation of the
     partial the client received; the second router's default policy
     ejects r0 within its eject_fails probes, the lifecycle sweeps r0
     (died) and spawns its replacement r2 (below_min), and the next turn
     lands on its first candidate, not r0; (d) `cli top --once --plain`
     on the router shows r1 healthy and the autoscale row, on the second
     router r0 ejected and r1 healthy; the telemetry carries the burn
     rates, each replica's headroom and the loop's bounds; (e) r1's
     flash and paged-decode launches rose; (g) a 96-token stream owned
     by r2, r2 SIGTERMed (the lifecycle's retire signal) once the client
     holds 8 content events: its drain parks the stream, whose swap blob
     ships to r1, which continues it through the paged decode kernel
     (its launches rose, 28 a step) byte for byte as r2 answered alone,
     with the router's timeline stream_broken, kv_migrate(shipped),
     stream_resume, done; the lifecycle sweeps r2's exit (code 0);
     prints TTFT p50 through the router and direct, the resume gaps, the
     429s, the blob sizes, spawn-to-admit seconds and the seconds;
  then prints the whole run's seconds, the kernels line, the card line,
  and the result line last. `--only 12` runs phases 1, 2 and 12 alone,
  `--only 13` phases 1, 2 and 13, `--only 14` phases 1, 2 and 14,
  `--only 15` phases 1, 2 and 15 (writing its own checkpoints), `--only
  16` phases 1, 2 and 16, `--only 17` phases 1, 2 and 17, `--only 18`
  phases 1, 2 and 18, `--only 19` phases 1, 2 and 19, `--only 20`
  phases 1, 2 and 20, `--only 21` phases 1, 2 and 21, `--only 22` phases
  1, 2 and 22, `--only 23` phases 1, 2 and 23, and none of them prints a
  result line. `--only
  13d` is a diagnosis of 13(d)'s oracle: its bf16 chats with the order
  of arrivals fixed (together, chat 0 first, chat 0 last, chat 0
  alone), each run's partings, the
  iteration that parted chat 0 and the verify rows' logits against the
  decode step's on the same prefix, then 13(d)'s float32 check.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import collections
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

BF16_TOL = 2e-2     # bf16 output rounding (ulp 2^-7 near 1) + sum order
F16_TOL = 4e-3      # f16 output rounding (ulp 2^-10 near 1), P in f16
F32_TOL = 1e-4      # float32 summation order only
LOGIT_TOL = 2e-3    # f32 model on card vs CPU (cuBLAS vs MKL sum order)

H100_PEAK_FLOPS = {"bf16": 989e12,   # dense tensor-core peak, H100 SXM
                   "f16": 989e12,
                   "tf32": 495e12,
                   "f32": 67e12}     # float32 outside the tensor cores
# TF32 products per float32-accurate product on the f32 route (3xTF32:
# hi.hi + hi.lo + lo.hi)
TF32_PRODUCTS = 3
H100_HBM_BYTES_S = 3.35e12
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"   # the CUDA toolkit's

class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# -- phase 2: build ----------------------------------------------------------


def phase_build() -> dict:
    from cake_tpu_torch.kernels.build import build_all
    from cake_tpu_torch.ops import flash
    t = time.perf_counter()
    built = build_all()
    for name, info in built.items():
        print(f"build {name}: {info['seconds']:.1f}s", flush=True)
        if name == "paged_decode":
            continue              # its report opens phase 3b
        for ln in info["log"].splitlines():
            if any(w in ln for w in ("entry function", "registers", "spill",
                                     "smem", "wgmma", "arning")):
                print(f"  {ln.strip()}")
    print(f"build total {time.perf_counter() - t:.1f}s", flush=True)
    cuobjdump = shutil.which("cuobjdump") or (
        CUOBJDUMP if os.path.exists(CUOBJDUMP) else None)
    if cuobjdump is None:
        print("cuobjdump not found: tensor-core counts not taken",
              flush=True)
        return built
    for route, word, what in (("bf16", "HGMMA", "HGMMA (wgmma)"),
                              ("f32", "TF32", "HMMA .TF32 (mma.sync)")):
        sass = subprocess.run(
            [cuobjdump, "-sass", built[flash.LIBRARIES[route]]["path"]],
            capture_output=True, text=True, timeout=300)
        check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr}")
        n = sum(word in ln and "MMA" in ln for ln in sass.stdout.splitlines())
        print(f"{what} instructions in {flash.SOURCES[route]}: {n}",
              flush=True)
        check(n > 0, f"the {route} flash kernel has no {what} instruction")
    return built


# -- phase 3: kernels --------------------------------------------------------


def flash_case(name, dtype, sq=256, skv=None, hq=16, hkv=8, d=128,
               valid_len=None, q_offset=None, window=None, pool_rows=None):
    """Inputs of one flash case on the card. With pool_rows, K/V are a
    strided batch-1 view of row 1 of a [3, pool_rows, Hkv, D] pool, as
    in append mode."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(
        sum(map(ord, name)))
    skv = sq if skv is None else skv

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q = rnd(1, sq, hq, d)
    if pool_rows:
        k = rnd(3, pool_rows, hkv, d)[1:2]
        v = rnd(3, pool_rows, hkv, d)[1:2]
    else:
        k, v = rnd(1, skv, hkv, d), rnd(1, skv, hkv, d)
    kw = dict(valid_len=valid_len, q_offset=q_offset, window=window)
    return q, k, v, kw


FLASH_CASES = [
    ("fresh", {}),
    ("fresh_valid200", dict(valid_len=200)),
    ("sq300", dict(sq=300)),
    ("window128", dict(window=128)),
    ("append", dict(pool_rows=4096, q_offset=256, valid_len=256)),
    ("d64_mha", dict(hq=8, hkv=8, d=64)),
]

def family_flash_cases() -> list:
    """The checkpoint families' attention shapes at their published widths
    (synth_checkpoint.family_attention): fresh at the served chunk (Sq
    256) with the family's window (EXAONE4's and Gemma3's local layers),
    and append. A window shorter than 600 also gets a fresh case at Sq
    600, where the window masks: the chunk alone never reaches past it."""
    from cake_tpu_torch.bench.synth_checkpoint import (FAMILIES,
                                                       family_attention)
    cases = []
    for fam in FAMILIES:
        a = family_attention(fam)
        shape = dict(hq=a["hq"], hkv=a["hkv"], d=a["d"])
        fresh = dict(shape, window=a["window"])
        cases.append((f"{fam}_fresh", fresh))
        if a["window"] and a["window"] < 600:
            cases.append((f"{fam}_fresh_window", dict(fresh, sq=600)))
        cases.append((f"{fam}_append", dict(shape, **FLASH_CASES[4][1])))
    return cases


def visible_pairs(sq, limit, q_offset, window, skv) -> int:
    """(query, key) pairs the masks leave visible: the work this run's
    data needs."""
    import torch
    qp = q_offset + torch.arange(sq)[:, None]
    kp = torch.arange(min(limit, skv))[None, :]
    m = kp <= qp
    if window:
        m &= kp > qp - window
    return int(m.sum())


def flash_bound_ms(q, k, kw, peak_flops=None) -> tuple[float, str]:
    """Least time on an H100 SXM: the larger of FLOPs over the peak for
    q's type and bytes (q read, K/V rows below the limit read, output
    written, once each) over HBM bandwidth. bf16: the tensor cores' peak;
    float32: three TF32 products per product over the TF32 peak, the
    least time for float32-accurate products on this card (3xTF32).
    `peak_flops` overrides the FLOP rate (FLOPs counted once)."""
    import torch
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    off = kw.get("q_offset") or 0
    limit = off + (kw.get("valid_len") or sq)
    rows = min(limit, k.shape[1])
    flops = 4.0 * visible_pairs(sq, limit, off, kw.get("window"),
                                k.shape[1]) * hq * d * b
    el = q.element_size()
    nbytes = el * b * (2 * sq * hq * d + 2 * rows * hkv * d)
    if peak_flops is not None:
        t_ops = flops / peak_flops
    elif q.dtype in (torch.bfloat16, torch.float16):
        t_ops = flops / H100_PEAK_FLOPS["bf16"]     # f16: the same peak
    else:
        t_ops = TF32_PRODUCTS * flops / H100_PEAK_FLOPS["tf32"]
    t_bytes = nbytes / H100_HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _library_args(q, k, v, kw):
    """Arguments of scaled_dot_product_attention for the same function:
    [B, H, S, D] views, and a causal flag or an explicit mask."""
    import torch
    off = kw.get("q_offset") or 0
    limit = off + (kw.get("valid_len") or q.shape[1])
    qt = q.transpose(1, 2)
    kt = k[:, :limit].transpose(1, 2)
    vt = v[:, :limit].transpose(1, 2)
    if off == 0 and limit >= k.shape[1] and not kw.get("window"):
        return (qt, kt, vt), dict(is_causal=True, enable_gqa=True)
    qp = off + torch.arange(q.shape[1], device="cuda")[:, None]
    kp = torch.arange(kt.shape[2], device="cuda")[None, :]
    mask = kp <= qp
    if kw.get("window"):
        mask &= kp > qp - kw["window"]
    return (qt, kt, vt), dict(attn_mask=mask, enable_gqa=True)


def library_call(q, k, v, kw):
    """One PyTorch call computing the same function (yardstick only: the
    port never calls it): scaled_dot_product_attention on [B, H, S, D]."""
    import torch.nn.functional as F
    args, sdpa_kw = _library_args(q, k, v, kw)
    return lambda: F.scaled_dot_product_attention(*args, **sdpa_kw)


def library_backend(q, k, v, kw) -> str:
    """The backend scaled_dot_product_attention picks for these inputs
    (the choice its dispatcher makes, read without running it)."""
    import torch
    from torch.nn.attention import SDPBackend
    args, sdpa_kw = _library_args(q, k, v, kw)
    return SDPBackend(torch._fused_sdp_choice(*args, **sdpa_kw)).name


def _meta_form(q, k, v, kw):
    """The device-meta form of a timed case: fresh over the chunk, or
    append over the whole pool that k/v are row 1 of."""
    import torch
    from cake_tpu_torch.ops.flash import flash_attention_meta_kernel
    off = kw.get("q_offset") or 0
    vl = kw.get("valid_len") or q.shape[1]
    if off:
        pool_k, pool_v, row, mode = k._base, v._base, 1, "append"
    else:
        pool_k, pool_v, row, mode = k, v, 0, "fresh"
    meta = torch.tensor([row, off, vl], dtype=torch.int32, device="cuda")
    return lambda: flash_attention_meta_kernel(
        q, pool_k, pool_v, meta, mode, window=kw.get("window"))


def time_flash(entry: str, dtype, spec: dict) -> dict:
    """One flash case timed on the card and printed: device ms of the
    kernel, its device-meta form, the plain version and the library call,
    the kernel's issue ms, and the card's bound."""
    import torch
    from cake_tpu_torch.bench.timing import device_ms, issue_ms
    from cake_tpu_torch.ops.flash import (flash_attention_kernel,
                                          flash_attention_ref, kernel_route)
    q, k, v, kw = flash_case(entry, dtype, **spec)
    err = (flash_attention_kernel(q, k, v, **kw).float()
           - flash_attention_ref(q, k, v, **kw).float()).abs().max()

    def kern():
        return flash_attention_kernel(q, k, v, **kw)
    meta_form = _meta_form(q, k, v, kw)
    # device time: events around calls queued behind a spin, so the
    # host's issue rate (issue_ms) does not set it
    t = {
        "max_abs_err": err.item(), "ms": device_ms(kern),
        "meta_ms": device_ms(meta_form),
        "issue_ms": issue_ms(kern),
        "plain_ms": device_ms(
            lambda: flash_attention_ref(q, k, v, **kw), iters=10),
        "library_ms": device_ms(library_call(q, k, v, kw)),
    }
    t["bound_ms"], t["bound_by"] = flash_bound_ms(q, k, kw)
    fma_bound = ""
    if dtype == torch.float32:   # the bound on FMA (no tensor cores)
        t["fma_bound_ms"] = flash_bound_ms(
            q, k, kw, H100_PEAK_FLOPS["f32"])[0]
        fma_bound = f" (FMA bound {t['fma_bound_ms']:.5f})"
    print(f"flash timing {entry}: {kernel_route(dtype)} Sq={q.shape[1]} "
          f"Hq/Hkv="
          f"{q.shape[2]}/{k.shape[2]} D={q.shape[3]} window="
          f"{kw.get('window')} Skv_row={k.shape[1]} device ms: kernel "
          f"{t['ms']:.5f} (device-meta form {t['meta_ms']:.5f}) plain "
          f"{t['plain_ms']:.5f} library "
          f"{t['library_ms']:.5f}; kernel issue_ms {t['issue_ms']:.5f}; "
          f"bound_ms {t['bound_ms']:.5f} ({t['bound_by']}), share of "
          f"bound {t['bound_ms'] / t['ms']:.3f}{fma_bound}; max_abs_err "
          f"{t['max_abs_err']:.3e}", flush=True)
    print(f"  library backend: {library_backend(q, k, v, kw)}",
          flush=True)
    return t


def phase_kernels() -> dict:
    import torch
    from cake_tpu_torch.ops.flash import (flash_attention_kernel,
                                          flash_attention_ref, kernel_route,
                                          plan_flash)
    family = family_flash_cases()
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for name, spec in FLASH_CASES + family:
            q, k, v, kw = flash_case(name, dtype, **spec)
            got = flash_attention_kernel(q, k, v, **kw)
            again = flash_attention_kernel(q, k, v, **kw)
            torch.cuda.synchronize()
            want = flash_attention_ref(q, k, v, **kw)
            err = (got.float() - want.float()).abs().max().item()
            print(f"flash {name:15s} {kernel_route(dtype)} Hq/Hkv "
                  f"{q.shape[2]}/{k.shape[2]} D {q.shape[3]} max_abs_err "
                  f"{err:.3e} (tol {tol:g})", flush=True)
            check(err <= tol and torch.isfinite(got).all().item(),
                  f"flash {name} {dtype}: max_abs_err {err} > {tol}")
            check(torch.equal(got, again),
                  f"flash {name} {dtype}: two launches differ")
    from cake_tpu_torch.bench import flash_meta
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for case in flash_meta.META_CASES:
            r = flash_meta.check(flash_meta.meta_case(*case, dtype))
            print(f"flash meta {case[0]:18s} {kernel_route(dtype)} "
                  f"max_abs_err {r['max_abs_err']:.3e} (tol {tol:g}); "
                  f"bits equal to the host-int form {r['same_as_host_int']},"
                  f" across two launches {r['same_twice']}; split "
                  f"{r['split']}", flush=True)
            check(r["finite"] and r["max_abs_err"] <= tol,
                  f"flash meta {case[0]} {dtype}: max_abs_err "
                  f"{r['max_abs_err']} > {tol}")
            check(r["same_as_host_int"] and r["same_twice"],
                  f"flash meta {case[0]} {dtype}: bits differ {r}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d in (64, 128, 256):
        plan = plan_flash((1, 256, 4, d), (1, 256, 1, d), window=512)
        print(f"flash plan bf16 D {d} (Sq 256, Hq/Hkv 4/1): {plan.ctas} "
              f"CTAs of {plan.positions} positions, {plan.threads} "
              f"threads, {plan.stages}-stage K/V ring, shared memory "
              f"{plan.smem_bytes} B per CTA", flush=True)
        plan = plan_flash((1, 256, 4, d), (1, 256, 1, d), window=512,
                          route="f32", sms=sms)
        print(f"flash plan f32 D {d} (Sq 256, Hq/Hkv 4/1): {plan.ctas} "
              f"row groups of {plan.rows} packed rows, each over a cluster "
              f"of {plan.split} CTAs ({sms} SMs), {plan.threads} threads, "
              f"{plan.slots} slots of {plan.block_keys}-key tiles per warp, "
              f"shared memory {plan.smem_bytes} B per CTA", flush=True)
    timings = {}
    for entry, dtype, spec in (
            ("fresh", torch.bfloat16, {}),
            ("append", torch.bfloat16, FLASH_CASES[4][1]),
            ("f32", torch.float32, {}),
            ("f32_append", torch.float32, FLASH_CASES[4][1]),
            *((name, torch.bfloat16, spec) for name, spec in family),
            *((f"{fam}_f32{mode}", torch.float32,
               dict(family)[f"{fam}_{entry}"])
              for fam in ("phi4", "gemma3")
              for mode, entry in (("", "fresh"), ("_append", "append"))),
            ("gemma3_f32_window", torch.float32,
             dict(family)["gemma3_fresh_window"])):
        timings[entry] = time_flash(entry, dtype, spec)
    return timings


# -- phase 3b: the paged decode kernel ----------------------------------------


def ptxas_report(log: str) -> list[str]:
    """ptxas's lines for each kernel of a build log: the function, its
    registers and shared memory, and its spills."""
    return [ln.strip() for ln in log.splitlines()
            if any(w in ln for w in ("Compiling entry function",
                                     "registers", "spill"))]


def phase_paged_kernels(build_log: str) -> dict:
    """The paged decode kernel: its plan at the serving shape and how many
    of its clusters the card holds at once, ptxas's report, then the kernel
    against its plain version in every case, bit-identical across two
    launches, and timed at the serving shape (4 rows at p = 620, bt 16) in
    both routes and at 4 rows at p = 4000 in bf16."""
    import torch
    from cake_tpu_torch.bench import paged_timing
    from cake_tpu_torch.bench.paged_cases import (CARD_CASES, case_args,
                                                  paged_case)
    from cake_tpu_torch.ops import paged_attention as pa
    gemma = dict(hq=4, hkv=1, d=256)
    for dtype, shape in ((torch.bfloat16, {}), (torch.float32, {}),
                         (torch.bfloat16, gemma), (torch.float32, gemma)):
        c = paged_case([620] * 4, dtype=dtype, device="cuda", seed=620,
                       **shape)
        plan = pa.plan_paged(c["q"].shape, c["k"].shape, c["tables"].shape,
                             dtype)
        clusters = pa.active_clusters(*case_args(c))
        print(f"paged decode plan {pa.kernel_route(dtype)}: 4 rows, bt 16, "
              f"Hq/Hkv {c['q'].shape[2]}/{c['k'].shape[2]}, D "
              f"{c['q'].shape[3]}: grid {plan.grid}, cluster "
              f"{plan.cluster}, stages {plan.stages}, shared memory "
              f"{plan.smem_bytes} B per CTA, {plan.ctas_per_sm} CTAs per SM "
              f"by shared memory and threads; active clusters {clusters} "
              f"(the launch has {plan.grid[1] * plan.grid[2]})", flush=True)
        check(clusters >= 1, f"no cluster of the paged decode launch fits")
    print("paged decode ptxas report:", flush=True)
    for ln in ptxas_report(build_log):
        print(f"  {ln}", flush=True)
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for name, spec in CARD_CASES:
            c = paged_case(dtype=dtype, device="cuda", **spec)
            got = pa.paged_decode_attention_kernel(*case_args(c))
            again = pa.paged_decode_attention_kernel(*case_args(c))
            torch.cuda.synchronize()
            want = pa.paged_decode_attention_ref(*case_args(c))
            rows = c["visible_rows"]
            err = (got[rows].float() - want[rows].float()).abs().max().item()
            print(f"paged decode {name:22s} {pa.kernel_route(dtype)} "
                  f"max_abs_err {err:.3e} (tol {tol:g})", flush=True)
            check(err <= tol and torch.isfinite(got).all().item(),
                  f"paged decode {name} {dtype}: max_abs_err {err} > {tol}")
            check(torch.equal(got, again),
                  f"paged decode {name} {dtype}: two launches differ")
    timings = paged_timing.measure(
        with_plain=True,
        shapes=paged_timing.SHAPES + paged_timing.family_shapes() + (
            ("f32_gemma3", "float32", 620, dict(hq=4, hkv=1, d=256)),))
    for entry, t in timings.items():
        tol = F32_TOL if entry.startswith("f32") else BF16_TOL
        check(t["max_abs_err"] <= tol and t["same_bits"],
              f"paged decode timing {entry}: max_abs_err {t['max_abs_err']}"
              f" (tol {tol}), two launches equal {t['same_bits']}")
        print(f"paged decode timing {entry}: 4 rows at p={t['p']}, bt 16, "
              f"Hq/Hkv={t['hq']}/{t['hkv']} D={t['d']}, device ms: kernel "
              f"{t['ms']:.5f} plain "
              f"{t['plain_ms']:.5f} library {t['library_ms']:.5f} "
              f"({t['library_backend']}, over pre-gathered live rows: "
              f"gather not timed); kernel issue_ms {t['issue_ms']:.5f}; "
              f"bound_ms {t['bound_ms']:.5f} ({t['bound_by']}), share of "
              f"bound {t['bound_ms'] / t['ms']:.3f}; max_abs_err "
              f"{t['max_abs_err']:.3e}", flush=True)
    return timings


# -- phase 4: model parity ---------------------------------------------------


def _greedy(model, logits, n, decode, n_greedy):
    """n_greedy greedy tokens off prefill logits; decode(p, tok, pos,
    recent, carries) runs one batch-1 decode step at host position p, with
    carries (key, counter, sampling settings, active)."""
    import torch
    from cake_tpu_torch.ops.sampling import SamplingConfig
    dev = model.device
    recent = torch.full((1, 64), -1, dtype=torch.int32, device=dev)
    tok = model.sample_one(logits, 0, 0, SamplingConfig(), recent)
    toks = [int(tok[0])]
    pos = torch.tensor([n], dtype=torch.int32, device=dev)
    greedy = [torch.tensor([v], dtype=dt, device=dev) for v, dt in (
        (0, torch.int64), (1, torch.int64), (0.0, torch.float32),
        (model.cfg.vocab_size, torch.int32), (1.0, torch.float32),
        (1.0, torch.float32), (True, torch.bool))]
    while len(toks) < n_greedy:
        _, tok, pos, recent, greedy[1] = decode(n + len(toks) - 1, tok, pos,
                                                recent, greedy)
        toks.append(int(tok[0]))
    return toks


def chunked_prefill_and_greedy(model, ids, n_greedy=16):
    """Prefill `ids` in 256-token chunks into a 4096-row cache, then
    greedy-decode n_greedy tokens. Returns (last logits, tokens, flash
    launches by mode during the prefill)."""
    from cake_tpu_torch.ops import flash
    cache = model.new_cache(1, kv_len=4096)
    flash.reset_launches()
    logits = None
    for p0 in range(0, len(ids), 256):
        logits, cache = model.prefill(cache, ids[p0:p0 + 256], p0)
    launches = flash.launch_counts()
    toks = _greedy(model, logits, len(ids),
                   lambda p, tok, pos, rec, g: model.decode_slots(
                       cache["layers"], tok, pos, rec, *g), n_greedy)
    return logits.float().cpu(), toks, launches


def paged_prefill_and_greedy(model, ids, n_greedy=16):
    """The same through a paged pool (one slot, ctx 4096, blocks of 16):
    prefill_chunk_paged per chunk, decode_slots_paged per token, blocks
    reserved ahead as the engine does. Returns (last logits, tokens, paged
    decode launches by route)."""
    from cake_tpu_torch.ops import paged_attention as pa
    from cake_tpu_torch.serve.paged import PagedKV
    pk = PagedKV.build(model, 1, 4096, 64, 16, 256)
    pa.reset_launches()
    logits = None
    for p0 in range(0, len(ids), 256):
        chunk = ids[p0:p0 + 256]
        check(pk.reserve_range(0, p0, len(chunk)), "paged pool too small")
        logits = pk.prefill_into(0, chunk, p0)

    def decode(p, tok, pos, rec, g):
        check(pk.reserve_range(0, p, 1), "paged pool too small")
        return model.decode_slots_paged(pk.pool, pk.rows, pk.tables, tok,
                                        pos, rec, *g)
    toks = _greedy(model, logits, len(ids), decode, n_greedy)
    return logits.float().cpu(), toks, pa.launch_counts()


def phase_parity() -> tuple[dict, int]:
    """600 tokens in chunks of 256: fresh flash, append flash, then a
    88-token tail (bucket 128 < FLASH_MIN_SEQ) on the masked path, then 16
    greedy tokens; contiguous and paged on the card against contiguous on
    the CPU. Returns the f32 flash launches by mode and the f32 paged
    decode launches."""
    import torch
    from cake_tpu_torch.cli import build_flagship
    from cake_tpu_torch.models import TextModel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = build_flagship(layers=2, dtype="f32", seed=1, device="cpu")
    params = _to_device(cpu.params, "cuda")
    gpu = TextModel(cpu.cfg, params, dtype=torch.float32, device="cuda")
    ids = [int(x) for x in torch.randint(
        0, cpu.cfg.vocab_size, (600,),
        generator=torch.Generator().manual_seed(5))]
    lg, tg, launches = chunked_prefill_and_greedy(gpu, ids)
    lp, tp, paged_launches = paged_prefill_and_greedy(gpu, ids)
    lc, tc, _ = chunked_prefill_and_greedy(cpu, ids)
    err = (lg - lc).abs().max().item()
    err_p = (lp - lc).abs().max().item()
    print(f"parity flagship width, 2 layers, f32, 600-token chunked "
          f"prefill: flash launches {launches}; logits max_abs_err "
          f"{err:.3e} (tol {LOGIT_TOL:g}); 16 greedy tokens identical "
          f"{tg == tc}", flush=True)
    print(f"parity paged (bt 16): paged decode launches {paged_launches}; "
          f"logits max_abs_err {err_p:.3e} (tol {LOGIT_TOL:g}); 16 greedy "
          f"tokens identical {tp == tc}", flush=True)
    check(launches == {"bf16": {"fresh": 0, "append": 0},
                       "f16": {"fresh": 0, "append": 0},
                       "f32": {"fresh": 2, "append": 2}},
          f"unexpected flash launches {launches}")
    check(err <= LOGIT_TOL, f"logits differ by {err}")
    check(tg == tc, f"greedy tokens differ: {tg} vs {tc}")
    check(paged_launches == {"bf16": 0, "f16": 0, "f32": 2 * 15},
          f"unexpected paged decode launches {paged_launches}")
    check(err_p <= LOGIT_TOL, f"paged logits differ by {err_p}")
    check(tp == tc, f"paged greedy tokens differ: {tp} vs {tc}")
    return launches["f32"], paged_launches["f32"]


def _to_device(tree, device):
    if tree is None:                # an SD tree's structural None
        return None
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


# -- phase 4b: the decode step as a captured CUDA graph -----------------------


GRAPH_STEPS = 16
GEN_TOKENS = 32     # generate's tokens: two captured chunks of 16


def phase_graphs(model, card: str) -> None:
    """The full flagship (28 layers, bf16), 4 slots with ctx 4096,
    contiguous and paged (1024 blocks of 16): rows at positions 600, 1100
    and 300 (greedy, sampled at temperature 0.8 / top_k 50, greedy) and a
    free row. 16 replays of the captured step equal 16 eager steps in
    tokens, logits, every KV byte and every carry. Then each step's
    replay against the eager step, timed; then generate's captured chunks
    against the step-by-step loop, greedy and sampled."""
    import torch
    from cake_tpu_torch.bench.graph_cases import (build_state,
                                                  graph_vs_eager,
                                                  step_by_step)
    from cake_tpu_torch.bench.timing import (device_ms, issue_ms,
                                             kernel_times, wall_ms)
    from cake_tpu_torch.models.common.text_model import GEN_CHUNK
    from cake_tpu_torch.ops.sampling import SamplingConfig
    greedy = SamplingConfig(temperature=0.0)
    sampled = SamplingConfig(temperature=0.8, top_k=50)
    for mode, kv_blocks in (("contiguous", 0), ("paged", 1024)):
        state = build_state(model, [600, 1100, None, 300],
                            [greedy, sampled, greedy, greedy], 4096,
                            kv_blocks=kv_blocks, seed=6)
        r = graph_vs_eager(model, state, GRAPH_STEPS)
        sampled_toks = r["tokens"][:, 1, 1].tolist()
        print(f"graph {mode}: {GRAPH_STEPS} replays vs eager steps, rows at "
              f"600/1100/300 (row 1 sampled at 0.8, top_k 50) + 1 free: "
              f"tokens identical {r['tokens_equal']}, KV bytes identical "
              f"{r['kv_equal']}, carries identical {r['carries_equal']}, "
              f"max abs logit diff {r['max_logit_diff']:.3e}; launches per "
              f"replay {r['graph'].launches_per_step}; sampled row's tokens "
              f"{sampled_toks[:8]}...", flush=True)
        check(r["graph"].graph is not None, f"graph {mode}: not captured")
        check(r["tokens_equal"] and r["kv_equal"] and r["carries_equal"],
              f"graph {mode}: replays differ from eager steps")
        check(len(set(sampled_toks)) > 1,
              f"graph {mode}: the sampled row drew one token throughout")
        graph, eager = r["graph"], r["eager"].step_fn(model)
        replay_ms = device_ms(graph.step)
        replay_wall = wall_ms(graph.step, 20)
        eager_wall = wall_ms(eager, 5)
        # the eager step's ~1,000 launches fill the launch queue, so a spin
        # cannot hold them: its device time is the profiler's kernel sum
        kernels = sum(row[0] for row in kernel_times(eager, 2, warmup=1))
        eager_dev = (f"kernel sum {kernels:.4f} (idle "
                     f"{1 - kernels / eager_wall:.3f})" if kernels else
                     "device ms not measured (the profiler saw no kernel)")
        # two clocks: a replay's device ms can read above its wall ms
        print(f"graph {mode} step timing (4 slots, 28 layers, bf16): replay "
              f"device ms {replay_ms:.4f}, replay wall ms {replay_wall:.4f} "
              f"(idle {max(0.0, 1 - replay_ms / replay_wall):.3f}); eager "
              f"step wall ms "
              f"{eager_wall:.4f}, {eager_dev}; on {card}", flush=True)
        del state, r, graph, eager
        torch.cuda.empty_cache()
    ids = [int(x) for x in torch.randint(
        0, 256, (600,), generator=torch.Generator().manual_seed(9))]
    for label, scfg in (("greedy", greedy), ("sampled", sampled)):
        got, stats = model.generate(ids, GEN_TOKENS, scfg, seed=4)
        want = step_by_step(model, ids, GEN_TOKENS, scfg, seed=4)
        print(f"generate {label}: 600-token prompt, {GEN_TOKENS} tokens in "
              f"captured chunks of {GEN_CHUNK} equal to the step-by-step loop "
              f"{got == want}; {stats['tok_per_s']:.1f} tok/s", flush=True)
        check(got == want, f"generate {label}: {got} != {want}")
    run = next(iter(model._runners.values()))
    # a chunk's ~16,000 graph nodes do not queue behind a spin (the host
    # blocks until the card drains them), so events around back-to-back
    # replays time it: the slower of the host and the card
    chunk_ms = issue_ms(run.graph.step, iters=5, warmup=1)
    print(f"generate chunk replay: event ms {chunk_ms:.4f} per "
          f"{GEN_CHUNK} steps ({chunk_ms / GEN_CHUNK:.4f} per token, back to "
          f"back); wall per token {1e3 / stats['tok_per_s']:.4f} ms (the "
          f"sampled run); on {card}", flush=True)


# -- phase 4c: every prefill chunk as a captured CUDA graph ------------------


def phase_prefill_graphs(model, card: str) -> None:
    """The full flagship, 4 slots with ctx 4096, contiguous and paged
    (1024 blocks of 16): a 600-token prompt in three chunks into row 2
    (another tenant's 300 tokens in row 0) through the captured prefill
    programs and through the eager chunks; logits and KV bytes equal; each
    chunk's replay timed beside the eager chunk."""
    import torch
    from cake_tpu_torch.bench.graph_cases import prefill_vs_eager
    from cake_tpu_torch.bench.timing import (device_ms, kernel_times,
                                             wall_ms)
    gen = torch.Generator().manual_seed(11)
    ids = torch.randint(0, 256, (600,), generator=gen).tolist()
    tenant = torch.randint(0, 256, (300,), generator=gen).tolist()
    for kind, kv_blocks in (("contiguous", 0), ("paged", 1024)):
        case = prefill_vs_eager(model, ids, slot=2, slots=4, ctx=4096,
                                kv_blocks=kv_blocks, strict=True,
                                tenant=tenant)
        graphs = case.graphs
        print(f"prefill graphs {kind}: {len(graphs.graphs)} programs "
              f"{sorted(graphs.graphs)} captured in {case.capture_s:.2f} s "
              f"under sync debug mode 'error'; chunks "
              f"{[r['key'] for r in case.results]} logits identical "
              f"{[r['logits_equal'] for r in case.results]} (max abs diff "
              f"{max(r['max_logit_diff'] for r in case.results):.3e}), KV "
              f"bytes identical {case.kv_equal}", flush=True)
        check(all(g.graph is not None for g in graphs.graphs.values()),
              f"prefill graphs {kind}: not captured")
        check(all(r["logits_equal"] for r in case.results) and case.kv_equal,
              f"prefill graphs {kind}: replays differ from eager chunks")
        for i, r in enumerate(case.results):
            g, e = case.graph_chunk(i), case.eager_chunk(i)
            replay = device_ms(g, iters=10, warmup=2)
            replay_wall = wall_ms(g, 10)
            eager_wall = wall_ms(e, 3)
            # an eager chunk's ~1,000 launches do not queue behind a
            # spin: its device time is the profiler's kernel sum
            kernels = sum(row[0] for row in kernel_times(e, 2, warmup=1))
            eager_dev = (f"kernel sum {kernels:.4f} (idle "
                         f"{1 - kernels / eager_wall:.3f})" if kernels
                         else "device ms not measured (the profiler saw "
                         "no kernel)")
            print(f"prefill graph {kind} chunk {r['key']} at "
                  f"{case.chunks[i][0]} ({len(case.chunks[i][1])} tokens, "
                  f"28 layers, bf16): replay device ms {replay:.4f}, "
                  f"replay wall ms {replay_wall:.4f} (idle "
                  f"{max(0.0, 1 - replay / replay_wall):.3f}); eager wall ms "
                  f"{eager_wall:.4f}, {eager_dev}; on {card}", flush=True)
        del case, graphs
        torch.cuda.empty_cache()


# -- phases 5 and 6: serving -------------------------------------------------


def _post(url, body, timeout=600, headers=None):
    req = urllib.request.Request(
        url + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def _prompt(i: int) -> str:
    words = ("tensor", "kernel", "warp", "slot", "chunk", "prefill",
             "decode", "cache", "token", "stream")
    text = " ".join(words[(i * 7 + j * 3) % len(words)] for j in range(90))
    return f"request {i}: {text}"[:600]


SYSTEM = ("You are the support desk of a GPU cloud. Answer in short, plain "
          "sentences, name the card and its power limit beside every "
          "number, and never guess a figure you were not given. " * 4)[:560]


def chat_body(i: int, stream: bool = False, shared: bool = False) -> dict:
    """Phase 5's chat i, or (shared) a question under the common system
    message, whose first 512 prompt tokens are the same for every i."""
    messages = [{"role": "user", "content": _prompt(i)}]
    if shared:
        messages = [{"role": "system", "content": SYSTEM},
                    {"role": "user", "content": f"question {i}: which card "
                     f"serves slot {i} and at what limit?"}]
    return {"messages": messages, "temperature": 0, "max_tokens": 32,
            "stream": stream}


class Served:
    """A started server (`create_app`) and its engine; keeps every
    ServeRequest by id, for its token ids and prompt ids."""

    def __init__(self, app):
        self.app = app
        self.engine = app.state.engine
        self.reqs = {}
        submit = self.engine.submit

        def recording_submit(*a, **kw):
            r = submit(*a, **kw)
            self.reqs[r.id] = r
            return r
        self.engine.submit = recording_submit

    def chat(self, body: dict, headers: dict | None = None) -> dict:
        """POST one chat (with extra `headers`); returns {status, rid,
        resp (JSON) or events (SSE), tokens, stats, seconds}. The request
        is found by the id the server echoes (X-Cake-Request-Id)."""
        t = time.perf_counter()
        status, hdrs, raw = _post(self.app.url, body, headers=headers)
        out = {"status": status, "seconds": time.perf_counter() - t}
        if body.get("stream"):
            out["events"] = [ln[6:] for ln in raw.decode().splitlines()
                             if ln.startswith("data: ")]
        else:
            out["resp"] = json.loads(raw)
        rid = out["rid"] = hdrs["X-Cake-Request-Id"]
        out["tokens"] = self.reqs[rid].result["tokens"]
        out["stats"] = self.reqs[rid].result["stats"]
        return out

    def concurrent(self, bodies: list[dict], during=None,
                   headers: list | None = None) -> list[dict]:
        """POST the bodies at once (body i with headers[i]); `during()` is
        polled while they run. Fails on any error or hang."""
        results, errors = [None] * len(bodies), []

        def worker(i):
            try:
                results[i] = self.chat(bodies[i],
                                       headers and headers[i])
            except Exception as e:     # reported below, phase fails
                errors.append(f"request {i}: {e!r}")
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(bodies))]
        for th in threads:
            th.start()
        while during is not None and any(th.is_alive() for th in threads):
            during()
            time.sleep(0.005)
        for th in threads:
            th.join(timeout=900)
        check(not errors, f"serving errors: {errors}")
        check(all(not th.is_alive() for th in threads), "requests hung")
        for i, r in enumerate(results):
            check(r["status"] == 200, f"request {i}: HTTP {r['status']}")
        return results

    def close(self):
        self.app.stop()


def serve_model(model, **engine_kw) -> Served:
    """The model behind the port's HTTP server with one engine (4 slots,
    ctx 4096)."""
    from cake_tpu_torch.api import create_app
    from cake_tpu_torch.serve import ServeEngine
    engine = ServeEngine(model, slots=4, ctx_len=4096, **engine_kw)
    return Served(create_app(model, engine, model.tokenizer,
                             port=0).start())


def _check_chats(results: list[dict], label: str) -> None:
    for i, r in enumerate(results):
        if "events" in r:
            ev = r["events"]
            check(ev and ev[-1] == "[DONE]",
                  f"{label}: SSE stream did not end with [DONE]")
            n = sum(1 for e in ev[:-1]
                    if json.loads(e)["choices"][0]["delta"].get("content"))
            check(n > 0, f"{label}: SSE stream carried no content")
        else:
            check(r["resp"]["usage"]["completion_tokens"] > 0,
                  f"{label} request {i}: no completion tokens")


def _alone_equals_concurrent(served, bodies, results, label) -> list[int]:
    """Send each non-streamed body again alone; its tokens and content
    must equal the concurrent run's. Returns each rerun's prefix hit."""
    hits = []
    for i, body in enumerate(bodies):
        if body.get("stream"):
            continue
        alone = served.chat(body)
        check(alone["status"] == 200, f"{label} alone {i}: HTTP "
              f"{alone['status']}")
        check(alone["tokens"] == results[i]["tokens"],
              f"{label} request {i}: concurrent tokens "
              f"{results[i]['tokens']} != alone {alone['tokens']}")
        check(alone["resp"]["choices"][0]["message"]["content"]
              == results[i]["resp"]["choices"][0]["message"]["content"],
              f"{label} request {i}: content differs alone vs concurrent")
        hits.append(alone["stats"]["prefix_hit_tokens"])
    return hits


def _latency(results: list[dict]) -> tuple[float, float]:
    """(TTFT p50 ms, decode tok/s per request p50) of the chats."""
    stats = [r["stats"] for r in results]
    ttft = sorted(s["ttft_s"] for s in stats)
    tps = sorted(s["tok_per_s"] for s in stats)
    return ttft[len(ttft) // 2] * 1e3, tps[len(tps) // 2]


def phase_serve(model, card: str) -> tuple[dict, list]:
    """Phase 5: contiguous pool, prefix cache on at its default. Returns
    the flash launches and the 4 chats' results."""
    import torch
    from cake_tpu_torch.ops import flash
    served = serve_model(model)
    try:
        check(served.engine.graph.graph is not None,
              "phase 5: the engine captured no graph")
        pg = served.engine.prefill.graphs
        check(pg and all(g.graph is not None for g in pg.values()),
              "phase 5: the engine captured no prefill graph")
        print(f"serve: engine captured its decode step and prefill programs "
              f"{sorted(pg)} at start in {served.engine.capture_s:.2f} s",
              flush=True)
        bodies = [chat_body(i) for i in range(4)] + [chat_body(4, True)]
        flash.reset_launches()
        torch.cuda.synchronize()
        results = served.concurrent(bodies)
        torch.cuda.synchronize()
        counts = flash.launch_counts()
        _check_chats(results, "phase 5")
        print(f"serve flash launches (4 concurrent + 1 SSE, 28 layers): "
              f"{counts}", flush=True)
        launches = counts["bf16"]
        check(launches["fresh"] >= 28 * 4, f"fresh launches {counts}")
        check(launches["append"] > 0, f"append launches {counts}")
        check(sum(counts["f32"].values()) == 0,
              f"the f32 route ran while serving bf16: {counts}")
        replays = served.engine.prefill.replays
        check(replays > 0 and all(g.graph is not None for g in
                                  served.engine.prefill.graphs.values()),
              "phase 5: no prefill chunk was a graph replay")
        hits = _alone_equals_concurrent(served, bodies, results, "phase 5")
        ttft, tps = _latency(results[:4])
        n_prompt = results[0]["resp"]["usage"]["prompt_tokens"]
        print(f"serve: 4 concurrent chats, {n_prompt}-token prompts, 32 "
              f"tokens each: TTFT p50 {ttft:.1f} ms (of "
              f"{sorted(round(r['stats']['ttft_s'] * 1e3, 1) for r in results[:4])}"
              f"), decode tok/s per request p50 {tps:.1f}; {replays} prefill "
              f"chunks, each a graph replay; alone reruns' "
              f"prefix_hit_tokens {hits} (prefix cache 256 MB); on {card}",
              flush=True)
        return launches, results[:4]
    finally:
        served.close()


def phase_paged_serve(model, card: str, contiguous: list) -> int:
    """Phase 6 (a)-(c). Returns the paged decode kernel's bf16 launches in
    (a)."""
    import torch
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops import paged_attention as pa
    layers = model.cfg.num_hidden_layers
    # (a) paged pool with the capacity of the contiguous one
    paged = serve_model(model, kv_blocks=1024, kv_block_tokens=16)
    try:
        graph = paged.engine.graph
        check(graph.graph is not None, "phase 6a: the engine captured no "
              "graph")
        bodies = [chat_body(i) for i in range(4)] + [chat_body(4, True)]
        torch.cuda.synchronize()
        pa.reset_launches()
        flash.reset_launches()
        steps = graph.steps
        results = paged.concurrent(bodies)
        torch.cuda.synchronize()
        steps = graph.steps - steps
        launches = pa.launch_counts()
        flash_counts = flash.launch_counts()
        _check_chats(results, "phase 6a")
        print(f"paged serve (a): decode launches {launches} over "
              f"{steps} replays of the paged decode step's graph x {layers} "
              f"layers; flash launches {flash_counts}", flush=True)
        check(launches == {"bf16": layers * steps, "f16": 0, "f32": 0}
              and steps,
              f"paged decode launches {launches} != {layers} x {steps}")
        check(flash_counts["bf16"]["fresh"] >= layers * 4
              and flash_counts["bf16"]["append"] > 0
              and sum(flash_counts["f32"].values()) == 0,
              f"paged prefill flash launches {flash_counts}")
        hits = _alone_equals_concurrent(paged, bodies, results, "phase 6a")
        ttft, tps = _latency(results[:4])
        ttft5, tps5 = _latency(contiguous)
        same = sum(a == b for r, c in zip(results[:4], contiguous)
                   for a, b in zip(r["tokens"], c["tokens"]))
        total = sum(len(c["tokens"]) for c in contiguous)
        print(f"paged serve (a): TTFT p50 {ttft:.1f} ms, decode tok/s per "
              f"request p50 {tps:.1f} (contiguous, phase 5: {ttft5:.1f} ms, "
              f"{tps5:.1f}); alone reruns' prefix_hit_tokens {hits}; greedy "
              f"tokens equal to phase 5's contiguous ones: {same} of {total} "
              f"(reported, not gated: the kernel's bf16 sums differ from the "
              f"torch path's); on {card}", flush=True)
        want = [r["tokens"] for r in results[:4]]
        # (b) shared system prompt, both modes, cache on vs off
        shared_max = [0]

        def watch():
            shared_max[0] = max(shared_max[0],
                                paged.engine.health()["kv_pool"]["shared"])
        on = {"paged": _shared_run(paged, watch)}
    finally:
        paged.close()
    for mode, kw in (("contiguous", {}),
                     ("contiguous, cache off", {"prefix_cache_mb": 0}),
                     ("paged, cache off", {"prefix_cache_mb": 0,
                                           "kv_blocks": 1024,
                                           "kv_block_tokens": 16})):
        served = serve_model(model, **kw)
        try:
            on[mode] = _shared_run(served)
        finally:
            served.close()
    for mode in ("contiguous", "paged"):
        got = on[mode]
        hits = [r["stats"]["prefix_hit_tokens"] for r in got]
        same = [r["tokens"] for r in got] == \
            [r["tokens"] for r in on[f"{mode}, cache off"]]
        print(f"prefix (b) {mode}: {got[0]['resp']['usage']['prompt_tokens']}"
              f"-token prompts sharing a {len(SYSTEM)}-character system "
              f"message: prefix_hit_tokens {hits}; tokens equal to the "
              f"cache-off run {same}"
              + (f"; most shared blocks while they ran {shared_max[0]}"
                 if mode == "paged" else ""), flush=True)
        check(all(h >= 512 for h in hits[1:]),
              f"{mode}: prefix hits {hits} below 512 after the first")
        check(same, f"{mode}: tokens differ between prefix cache on and off")
    check(shared_max[0] > 0, "paged: no block was shared during the hits")
    # (c) swap, then recompute, under pressure: 96 blocks, two chats
    # decoding when the other two arrive
    for mode in ("swap", "recompute"):
        _pressure(model, mode, want)
    return launches["bf16"]


def _pressure(model, mode: str, want: list, resumed=None) -> None:
    """Phase 6(c) under one preemption mode: (a)'s chats on 96 blocks,
    the last two arriving while the first two decode. `resumed(prompt,
    tokens, preempted_at)`, when given, is a recompute-preempted chat's
    reference in place of (a)'s tokens."""
    tight = serve_model(model, kv_blocks=96, kv_block_tokens=16,
                        preempt_mode=mode)
    try:
        first = {}

        def send(i):
            first[i] = tight.chat(chat_body(i))
        threads = [threading.Thread(target=send, args=(i,)) for i in (0, 1)]
        for th in threads:
            th.start()
        deadline = time.perf_counter() + 600
        while time.perf_counter() < deadline:
            live = list(tight.reqs.values())
            if len(live) == 2 and all(r.tokens for r in live):
                break
            time.sleep(0.002)
        late = tight.concurrent([chat_body(2), chat_body(3)])
        for th in threads:
            th.join(timeout=900)
        check(len(first) == 2, "phase 6c: a first chat failed")
        results = [first[0], first[1]] + late
        got = [r["tokens"] for r in results]
        if resumed is not None and mode == "recompute":
            want = [resumed(tight.reqs[r["rid"]].prompt_ids, w,
                            r["stats"].get("preempted_at", []))
                    for r, w in zip(results, want)]
        health = tight.engine.health()
        pool = health["kv_pool"]
        print(f"paged {mode} (c): 96 blocks of 16 tokens, kv_pool {pool}; "
              f"prefill graph replays {health['prefill_graphs']['replays']};"
              f" tokens equal to (a)'s {got == want}"
              + (" (a recompute-preempted chat's: its resumed reference)"
                 if resumed is not None and mode == "recompute" else ""),
              flush=True)
        check(all(r["status"] == 200 for r in list(first.values()) + late),
              f"phase 6c {mode}: a request failed")
        if mode == "swap":
            check(pool["swaps"] >= 1, "phase 6c: no swap preemption")
        else:
            check(pool["preemptions"]["recompute"] >= 1
                  and pool["replays"] >= 1 and pool["swaps"] == 0,
                  f"phase 6c: no recompute preemption replayed: {pool}")
        check(got == want, f"phase 6c {mode}: tokens {got} != (a)'s {want}")
    finally:
        tight.close()


# -- phase 10: fault drills (the supervisor) ----------------------------------

FAULT_SLOTS = 4


def _post_any(url, body, timeout=600, headers=None
              ) -> tuple[int, dict, bytes]:
    """POST a chat; (status, headers, body) for any status."""
    import urllib.error
    try:
        return _post(url, body, timeout, headers)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _health(url) -> tuple[int, dict]:
    import urllib.error
    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _replay_launches(engine, layers: int) -> dict:
    """The bf16 flash launches the last rebuild's replays made: each
    replayed chunk through its program's key, `layers` launches per chunk
    whose program takes a flash mode (no prefix cache: every replay
    starts at position 0)."""
    want = {"fresh": 0, "append": 0}
    for n in engine.health()["last_rebuild"]["replayed_tokens"]:
        for pos in range(0, n, engine.chunk):
            mode = engine.prefill.key(min(engine.chunk, n - pos), pos)[1]
            if mode in want:
                want[mode] += layers
    return want


def _drill_rebuild(model, card: str, label: str, **engine_kw) -> None:
    """Phase 10 (a) / (b): three concurrent greedy chats, first on the
    engine with no plan, then on the same engine under
    raise_on_step=6;kind=device, installed once all three decode: the
    same tokens, one rebuild, the
    replay's chunks through the captured programs at unchanged addresses
    (flash launches and prefill replays rise by exactly the replay's),
    and, paged, the decode kernel launching after it."""
    import torch
    from cake_tpu_torch.bench.graph_cases import engine_addresses
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops import paged_attention as pa
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve import ServeEngine, faults
    layers = model.cfg.num_hidden_layers
    eng = ServeEngine(model, slots=FAULT_SLOTS, ctx_len=4096,
                      prefill_chunk=256, prefix_cache_mb=0, **engine_kw)
    greedy = SamplingConfig(temperature=0.0)
    prompts = [model.tokenizer.chat_prompt_ids(chat_body(i)["messages"])
               for i in range(3)]

    def run(plan=None):
        torch.cuda.synchronize()
        replays0, steps0 = eng.prefill.replays, eng.graph.steps
        flash.reset_launches()
        pa.reset_launches()
        reqs = [eng.submit(p, 32, greedy) for p in prompts]
        if plan is not None:
            # the plan counts decode dispatches from its install: once
            # every chat decodes, so that the failure always finds the
            # three slots decoding (how far the admissions got by a
            # dispatch count depends on when the scheduler saw each
            # submit)
            _until(lambda: all(r.tokens or r.done.is_set() for r in reqs),
                   f"phase 10 {label}: chats never decoded", 600)
            faults.install(plan)
        for r in reqs:
            check(r.wait(600), f"phase 10 {label}: a request hung")
            check("error" not in r.result,
                  f"phase 10 {label}: {r.result.get('error')!r}")
        torch.cuda.synchronize()
        counts = flash.launch_counts()["bf16"]
        return {"tokens": [r.result["tokens"] for r in reqs],
                "fresh": counts["fresh"], "append": counts["append"],
                "replays": eng.prefill.replays - replays0,
                "steps": eng.graph.steps - steps0,
                "paged": pa.launch_counts()["bf16"]}
    try:
        check(eng.graph.graph is not None,
              f"phase 10 {label}: no captured decode graph")
        check(min(len(p) for p in prompts) > 512,
              f"phase 10 {label}: prompts too short for an append chunk")
        calm = run()
        ptrs, graph = engine_addresses(eng), eng.graph
        programs = dict(eng.prefill.graphs)
        try:
            hit = run("raise_on_step=6;kind=device")
        finally:
            faults.clear()
        h = eng.health()
        last = h["last_rebuild"]
        want = _replay_launches(eng, layers)
        print(f"faults {label}: raise_on_step=6 kind=device with 3 "
              f"concurrent {[len(p) for p in prompts]}-token chats: "
              f"rebuilds {h['rebuilds']}, rebuild wall ms "
              f"{last['wall_ms']} (the replay waited for on the card), "
              f"replayed tokens per slot {last['replayed_tokens']} in "
              f"{last['replay_chunks']} prefill graph replays; flash "
              f"launches fresh/append {calm['fresh']}/{calm['append']} "
              f"undisturbed, {hit['fresh']}/{hit['append']} with the "
              f"rebuild (its replay {want}); decode replays "
              f"{calm['steps']} -> {hit['steps']}, paged decode launches "
              f"{calm['paged']} -> {hit['paged']}; tokens equal to the "
              f"run with no plan {hit['tokens'] == calm['tokens']}; "
              f"on {card}", flush=True)
        check(hit["tokens"] == calm["tokens"],
              f"phase 10 {label}: tokens after the rebuild differ")
        check(h["rebuilds"] == 1 and h["step_failures"]["device"] == 1,
              f"phase 10 {label}: rebuilds {h['rebuilds']}, failures "
              f"{h['step_failures']}")
        check(want["fresh"] > 0 and want["append"] > 0,
              f"phase 10 {label}: the replay ran no flash chunk {want}")
        check(hit["fresh"] - calm["fresh"] == want["fresh"]
              and hit["append"] - calm["append"] == want["append"],
              f"phase 10 {label}: flash launches rose by "
              f"{hit['fresh'] - calm['fresh']}/"
              f"{hit['append'] - calm['append']}, the replay's are {want}")
        check(hit["replays"] - calm["replays"] == last["replay_chunks"] > 0,
              f"phase 10 {label}: prefill replays rose by "
              f"{hit['replays'] - calm['replays']}, the replay ran "
              f"{last['replay_chunks']} chunks")
        check(engine_addresses(eng) == ptrs and eng.graph is graph
              and all(eng.prefill.graphs[k] is g
                      for k, g in programs.items())
              and len(eng.prefill.graphs) == len(programs),
              f"phase 10 {label}: a graph or an address changed")
        if eng.paged is not None:
            # 5 replays before the fault, the rest after the rebuild
            check(hit["paged"] == layers * hit["steps"]
                  and hit["steps"] > 5,
                  f"phase 10 {label}: paged decode launches "
                  f"{hit['paged']} over {hit['steps']} replays")
            eng.paged.alloc.check()
    finally:
        eng.close()


def _drill_prefill_fault(model, card: str) -> None:
    """Phase 10 (f): a device fault while an admission is still
    prefilling. A chat decodes beside a 2000-token admission (8 chunks of
    256); once the admission is past its first chunk and short of its
    last, raise_on_step=1;kind=device kills the next decode dispatch. The
    rebuild replays the decoding chat and restarts the admission (it has
    emitted nothing); both answer the tokens of the same requests with
    no plan. The flash launches rise by the replay's, plus the chunks the
    admission had prefilled before the fault, which its restart runs
    again: its one fresh chunk exactly once more, and a whole number of
    its append chunks (at most its own)."""
    import torch
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve import ServeEngine, faults
    layers = model.cfg.num_hidden_layers
    eng = ServeEngine(model, slots=FAULT_SLOTS, ctx_len=4096,
                      prefill_chunk=256, prefix_cache_mb=0)
    greedy = SamplingConfig(temperature=0.0)
    short = model.tokenizer.chat_prompt_ids(chat_body(0)["messages"])
    gen = torch.Generator().manual_seed(10)
    long = torch.randint(0, 256, (2000,), generator=gen).tolist()
    n_chunks = -(-len(long) // 256)

    def run(plan=None):
        torch.cuda.synchronize()
        flash.reset_launches()
        first = eng.submit(short, 200, greedy)
        _until(lambda: first.tokens or first.done.is_set(),
               "phase 10 (f): the decoding chat never decoded", 600)
        second = eng.submit(long, 16, greedy)
        if plan is not None:
            def midway():
                return any(p.req is second and 256 <= p.pos < p.n - 256
                           for p in list(eng._prefills))
            _until(midway, "phase 10 (f): the admission never reached the "
                   "middle of its prefill", 600)
            faults.install(plan)
        for r in (first, second):
            check(r.wait(600), "phase 10 (f): a request hung")
            check("error" not in r.result,
                  f"phase 10 (f): {r.result.get('error')!r}")
        torch.cuda.synchronize()
        counts = flash.launch_counts()["bf16"]
        return {"tokens": [first.result["tokens"], second.result["tokens"]],
                "fresh": counts["fresh"], "append": counts["append"]}
    try:
        calm = run()
        try:
            hit = run("raise_on_step=1;kind=device")
        finally:
            faults.clear()
        h = eng.health()
        last = h["last_rebuild"]
        want = _replay_launches(eng, layers)
        extra_fresh = hit["fresh"] - calm["fresh"] - want["fresh"]
        extra_append = hit["append"] - calm["append"] - want["append"]
        print(f"faults (f) a fault mid-prefill: a chat decoding beside a "
              f"{len(long)}-token admission ({n_chunks} chunks): rebuilds "
              f"{h['rebuilds']}, restarted admissions {last['restarted']}, "
              f"replayed tokens {last['replayed_tokens']}; flash launches "
              f"fresh/append {calm['fresh']}/{calm['append']} undisturbed, "
              f"{hit['fresh']}/{hit['append']} with the fault (the replay's "
              f"{want}, the restart's repeated chunks {extra_fresh}/"
              f"{extra_append}); tokens equal to the run with no plan "
              f"{hit['tokens'] == calm['tokens']}; on {card}", flush=True)
        check(hit["tokens"] == calm["tokens"],
              "phase 10 (f): tokens after the rebuild differ")
        check(h["rebuilds"] == 1 and last["restarted"] == 1
              and len(last["replayed_tokens"]) == 1,
              f"phase 10 (f): rebuilds {h['rebuilds']}, {last}")
        check(extra_fresh == layers,
              f"phase 10 (f): fresh launches rose by {extra_fresh} beyond "
              f"the replay's, the restart's first chunk is {layers}")
        check(extra_append % layers == 0
              and 0 <= extra_append <= (n_chunks - 1) * layers,
              f"phase 10 (f): append launches rose by {extra_append} beyond "
              f"the replay's, not a whole number of the admission's chunks")
    finally:
        eng.close()


def _drill_poison(model, card: str) -> None:
    """Phase 10 (c): two chats decoding when a third, whose prompt holds
    the poison token, joins them: 500 for it, 200 for the others with
    the tokens they give alone."""
    from cake_tpu_torch.serve import faults
    served = serve_model(model, prefix_cache_mb=0)
    try:
        bodies = [chat_body(i) for i in range(2)]
        poison = ord("~")
        check(all(poison not in model.tokenizer.chat_prompt_ids(
            b["messages"]) for b in bodies), "phase 10 (c): poison in body")
        alone = [served.chat(b)["tokens"] for b in bodies]
        out = {}

        def send(i):
            out[i] = served.chat(bodies[i])
        threads = [threading.Thread(target=send, args=(i,)) for i in (0, 1)]
        n0 = len(served.reqs)
        for th in threads:
            th.start()
        deadline = time.perf_counter() + 600
        while True:
            live = list(served.reqs.values())[n0:]
            if len(live) == 2 and all(r.tokens for r in live):
                break
            check(time.perf_counter() < deadline,
                  "phase 10 (c): the chats never decoded")
            time.sleep(0.002)
        # armed from here; 30 ms per decode step lets the poisoned chat
        # (one chunk) join the decode set before the poison fires
        faults.install(f"poison_token={poison};poison_after_ops=8;"
                       "delay_ms=30")
        try:
            status, _, raw = _post_any(served.app.url, {
                "messages": [{"role": "user", "content": "gamma ~ three"}],
                "temperature": 0, "max_tokens": 32})
            for th in threads:
                th.join(timeout=600)
        finally:
            faults.clear()
        h = served.engine.health()
        print(f"faults (c) poison over HTTP: the poisoned chat HTTP {status} "
              f"{json.loads(raw).get('error', '')[:80]!r}; the others "
              f"{[out[i]['status'] for i in (0, 1)]}, tokens equal alone "
              f"{[out[i]['tokens'] == alone[i] for i in (0, 1)]}; rebuilds "
              f"{h['rebuilds']}, quarantined {h.get('quarantined')}; "
              f"on {card}", flush=True)
        check(status == 500, f"phase 10 (c): poisoned chat HTTP {status}")
        check([out[i]["tokens"] for i in (0, 1)] == alone,
              "phase 10 (c): the innocent chats' tokens differ from alone")
        check(h.get("quarantined") == 1 and h["rebuilds"] <= 2,
              f"phase 10 (c): health {h}")
    finally:
        served.close()


def _drill_down(model, card: str) -> None:
    """Phase 10 (d): rebuild_budget=1, restore_interval_s=0.5. A chat
    under raise_on_step=3;times=2 answers 503 + Retry-After, so do a JSON
    and an SSE chat and /health (with engine.down) while DOWN; the restore
    loop revives the engine, and the chat then equals its undisturbed
    answer."""
    from cake_tpu_torch.serve import faults
    served = serve_model(model, prefix_cache_mb=0, rebuild_budget=1,
                         restore_interval_s=0.5)
    url = served.app.url
    try:
        body = chat_body(0)
        calm = served.chat(body)
        faults.install("raise_on_step=3;times=2;kind=device")
        try:
            first = _post_any(url, body)
            t_down = time.perf_counter()
            json_down = _post_any(url, body)
            sse_down = _post_any(url, dict(body, stream=True))
            health_down = _health(url)
            checked_s = time.perf_counter() - t_down
        finally:
            faults.clear()
        deadline = time.perf_counter() + 120
        while _health(url)[0] != 200:
            check(time.perf_counter() < deadline,
                  "phase 10 (d): the restore loop never revived the engine")
            time.sleep(0.05)
        revive_s = time.perf_counter() - t_down
        after = served.chat(body)
        statuses = [r[0] for r in (first, json_down, sse_down)]
        print(f"faults (d) budget 1, restore 0.5 s: HTTP {statuses} "
              f"(Retry-After {[r[1].get('Retry-After') for r in (first, json_down, sse_down)]}), "
              f"/health {health_down[0]} down={'down' in health_down[1]['engine']} "
              f"within {checked_s * 1e3:.0f} ms; /health 200 again "
              f"{revive_s:.2f} s after; tokens equal to the undisturbed "
              f"chat {after['tokens'] == calm['tokens']}; on {card}",
              flush=True)
        check(statuses == [503, 503, 503]
              and all(int(r[1].get("Retry-After", 0)) >= 1
                      for r in (first, json_down, sse_down)),
              f"phase 10 (d): statuses {statuses}")
        check(sse_down[1].get("Content-Type") == "application/json",
              "phase 10 (d): the SSE path committed a stream while DOWN")
        check(health_down[0] == 503
              and "down" in health_down[1]["engine"],
              f"phase 10 (d): /health while DOWN {health_down}")
        check(after["status"] == 200 and after["tokens"] == calm["tokens"],
              "phase 10 (d): the revived chat differs")
    finally:
        served.close()


def _drill_wedge(model, card: str) -> None:
    """Phase 10 (e): step_watchdog_s=0.25 and a 1.5 s stall: /health
    503 while wedged, then 200, and the chat's tokens unchanged."""
    from cake_tpu_torch.serve import faults
    served = serve_model(model, prefix_cache_mb=0, step_watchdog_s=0.25)
    url = served.app.url
    try:
        body = chat_body(1)
        calm = served.chat(body)
        faults.install("stall_on_step=3;stall_step_ms=1500")
        try:
            out = {}
            th = threading.Thread(target=lambda: out.update(
                r=served.chat(body)))
            th.start()
            seen = []
            while th.is_alive():
                status, h = _health(url)
                seen.append((status, h["engine"]["wedged"]))
                time.sleep(0.02)
            th.join(timeout=600)
        finally:
            faults.clear()
        final = _health(url)
        wedges = served.engine.health()["wedges"]
        print(f"faults (e) watchdog 0.25 s, 1.5 s stall: /health 503 "
              f"wedged in {sum(s == (503, True) for s in seen)} of "
              f"{len(seen)} polls, {final[0]} after; wedges {wedges}; "
              f"tokens equal {out['r']['tokens'] == calm['tokens']}; "
              f"on {card}", flush=True)
        check((503, True) in seen, "phase 10 (e): never flagged wedged")
        check(final[0] == 200 and not final[1]["engine"]["wedged"],
              "phase 10 (e): the wedge flag did not clear")
        check(out["r"]["tokens"] == calm["tokens"] and wedges >= 1,
              "phase 10 (e): the stalled chat differs")
    finally:
        served.close()


def phase_faults(model, card: str) -> None:
    """Phase 10: the supervisor's drills at full flagship size, each
    driven by the port's own fault hook (serve/faults.py)."""
    t0 = time.perf_counter()
    _drill_rebuild(model, card, "(a) contiguous")
    _drill_rebuild(model, card, "(b) paged", kv_blocks=1024,
                   kv_block_tokens=16)
    _drill_poison(model, card)
    _drill_down(model, card)
    _drill_wedge(model, card)
    _drill_prefill_fault(model, card)
    print(f"faults: phase 10 took {time.perf_counter() - t0:.1f} s on "
          f"{card}", flush=True)


# -- phase 11: QoS lanes, tenants, deadlines and the metrics plane ------------

QOS_HOLD_TOKENS = 160       # a holding chat decodes ~3 s on the flagship


def _get(url, path) -> tuple[int, dict, bytes]:
    import urllib.error
    try:
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _until(cond, what: str, timeout: float = 300) -> None:
    deadline = time.perf_counter() + timeout
    while not cond():
        check(time.perf_counter() < deadline, what)
        time.sleep(0.002)


def _send_async(served, body, headers, out: dict, key) -> threading.Thread:
    """POST a chat on a thread; its (status, headers, body) lands in
    out[key]."""
    def run():
        out[key] = _post_any(served.app.url, body, headers=headers)
    th = threading.Thread(target=run)
    th.start()
    return th


def _hold_slots(served, n: int, out: dict, tag: str) -> list:
    """n long batch chats decoding in every slot."""
    threads = [_send_async(served, dict(chat_body(i),
                                        max_tokens=QOS_HOLD_TOKENS),
                           {"X-Cake-QoS": "batch",
                            "X-Cake-Request-Id": f"{tag}-hold-{i}"},
                           out, f"hold-{i}") for i in range(n)]
    _until(lambda: sum(1 for r in served.reqs.values()
                       if r.id.startswith(f"{tag}-hold") and r.tokens) == n,
           f"phase 11 {tag}: the holding chats never decoded")
    return threads


def parse_prometheus(text: str) -> dict:
    """{series (name + labels): value} of a text exposition 0.0.4; fails
    on a malformed line."""
    import re
    # label values are quoted and may hold braces (a route template)
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
                        r'(\{(?:[^}"]|"(?:[^"\\]|\\.)*")*\})? '
                        r'(-?[0-9.e+-]+|[+-]Inf|NaN)$')
    out = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("# HELP ") or ln.startswith("# TYPE "):
            continue
        m = sample.match(ln)
        check(m is not None, f"/metrics: malformed line {ln!r}")
        out[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return out


def _qos_lanes(served, card: str) -> None:
    """(a): every slot held by a batch chat, 4 batch then 2 interactive
    chats queued; both interactive are admitted first (timelines), all
    answer 200, each interactive chat's tokens equal it alone."""
    from cake_tpu_torch.obs import TIMELINES
    eng = served.engine
    out = {}
    threads = _hold_slots(served, 4, out, "p11a")
    lanes = [("batch", 4 + i) for i in range(4)] + \
        [("interactive", 8 + i) for i in range(2)]
    for k, (qos, i) in enumerate(lanes):
        threads.append(_send_async(
            served, dict(chat_body(i), max_tokens=8),
            {"X-Cake-QoS": qos, "X-Cake-Request-Id": f"p11a-{qos}-{i}"},
            out, f"q-{i}"))
        _until(lambda: eng.queue.depth() == k + 1,
               "phase 11 (a): a chat did not queue behind the held slots")
    held = [r for r in served.reqs.values() if r.id.startswith("p11a-hold")]
    check(all(not r.done.is_set() for r in held),
          "phase 11 (a): a holding chat ended before the lanes filled")
    for th in threads:
        th.join(timeout=600)
    statuses = {k: v[0] for k, v in out.items()}
    check(all(v == 200 for v in statuses.values()),
          f"phase 11 (a): statuses {statuses}")

    def admitted(rid):
        return next(e["ts"] for e in TIMELINES.to_chrome(rid)["traceEvents"]
                    if e["name"] == "admit")
    queued = [f"p11a-{qos}-{i}" for qos, i in lanes]
    order = sorted(queued, key=admitted)
    alone = {}
    for i in (8, 9):
        r = served.chat(dict(chat_body(i), max_tokens=8))
        alone[i] = r["tokens"]
    same = [served.reqs[f"p11a-interactive-{i}"].result["tokens"] == alone[i]
            for i in (8, 9)]
    print(f"qos (a) lanes: 4 slots held by batch chats, queued "
          f"{[q for q, _ in lanes]}; admitted in the order "
          f"{[rid.split('-')[1] for rid in order]}; interactive tokens "
          f"equal alone {same}; on {card}", flush=True)
    check([rid.split("-")[1] for rid in order[:2]] ==
          ["interactive", "interactive"],
          f"phase 11 (a): admit order {order}")
    check(all(same), "phase 11 (a): an interactive chat differs alone")


def _qos_victims(model, card: str, mode: str) -> int:
    """(b): two batch chats decoding on 96 blocks when an interactive
    chat arrives: a batch slot is preempted, never the interactive one;
    every chat's tokens equal it alone. Returns the paged decode
    kernel's launches."""
    from cake_tpu_torch.obs import TIMELINES
    from cake_tpu_torch.ops import paged_attention as pa
    served = serve_model(model, kv_blocks=96, kv_block_tokens=16,
                         preempt_mode=mode, prefix_cache_mb=0)
    try:
        alone = {i: served.chat(chat_body(i))["tokens"] for i in (0, 1, 2)}
        pa.reset_launches()
        out = {}
        threads = [_send_async(served, chat_body(i),
                               {"X-Cake-QoS": "batch",
                                "X-Cake-Request-Id": f"p11b-{mode}-{i}"},
                               out, i) for i in (0, 1)]
        _until(lambda: all(f"p11b-{mode}-{i}" in served.reqs and
                           served.reqs[f"p11b-{mode}-{i}"].tokens
                           for i in (0, 1)),
               f"phase 11 (b) {mode}: the batch chats never decoded")
        inter = served.chat(chat_body(2), {
            "X-Cake-QoS": "interactive",
            "X-Cake-Request-Id": f"p11b-{mode}-2"})
        for th in threads:
            th.join(timeout=600)
        launches = pa.launch_counts()["bf16"]
        kinds = {i: [e["kind"] for e in
                     TIMELINES.get(f"p11b-{mode}-{i}")["events"]]
                 for i in (0, 1, 2)}
        got = {i: served.reqs[f"p11b-{mode}-{i}"].result["tokens"]
               for i in (0, 1, 2)}
        pool = served.engine.health()["kv_pool"]
        victims = [i for i in kinds if "preempt" in kinds[i]]
        print(f"qos (b) {mode}: 96 blocks, two batch decoders and an "
              f"interactive arrival: preempted {victims} "
              f"(0, 1 batch; 2 interactive), preemptions "
              f"{pool['preemptions']}; tokens equal alone "
              f"{[got[i] == alone[i] for i in (0, 1, 2)]}; paged decode "
              f"launches {launches}; on {card}", flush=True)
        check(all(out[i][0] == 200 for i in (0, 1))
              and inter["status"] == 200, f"phase 11 (b) {mode}: a chat "
              "failed")
        check("preempt" not in kinds[2],
              f"phase 11 (b) {mode}: the interactive chat was preempted")
        check(any("preempt" in kinds[i] and "resume" in kinds[i]
                  for i in (0, 1)),
              f"phase 11 (b) {mode}: no batch slot was preempted")
        check(got == alone, f"phase 11 (b) {mode}: tokens differ alone")
        check(launches > 0, f"phase 11 (b) {mode}: no paged launch")
        return launches
    finally:
        served.close()


def _qos_deadlines(model, card: str) -> None:
    """(c): the queue deadline (0.5 s, every slot busy) answers 503 with
    Retry-After; the request deadline (2 s) answers 504 within about an
    iteration of it and frees the slot; each counter moves by exactly
    the expiries sent."""
    from cake_tpu_torch.obs import (SERVE_QUEUE_TIMEOUTS,
                                    SERVE_REQUEST_TIMEOUTS)
    served = serve_model(model, prefix_cache_mb=0, queue_deadline_s=0.5)
    try:
        q0, r0 = SERVE_QUEUE_TIMEOUTS.value(), SERVE_REQUEST_TIMEOUTS.value()
        out = {}
        threads = _hold_slots(served, 4, out, "p11c")
        t = time.perf_counter()
        status, hdrs, raw = _post_any(served.app.url, chat_body(5))
        waited = time.perf_counter() - t
        for th in threads:
            th.join(timeout=600)
        q_delta = SERVE_QUEUE_TIMEOUTS.value() - q0
        print(f"qos (c) queue deadline 0.5 s, 4 slots busy: HTTP {status} "
              f"Retry-After {hdrs.get('Retry-After')} after "
              f"{waited * 1e3:.0f} ms; queue timeouts +{q_delta:g}; on "
              f"{card}", flush=True)
        check(status == 503 and int(hdrs.get("Retry-After", 0)) >= 1,
              f"phase 11 (c): queue deadline answered {status}")
        check(q_delta == 1 and SERVE_REQUEST_TIMEOUTS.value() == r0,
              f"phase 11 (c): queue timeouts moved by {q_delta}")
        check(all(v[0] == 200 for v in out.values()),
              "phase 11 (c): a holding chat failed")
    finally:
        served.close()
    served = serve_model(model, prefix_cache_mb=0, request_deadline_s=2.0)
    try:
        q0, r0 = SERVE_QUEUE_TIMEOUTS.value(), SERVE_REQUEST_TIMEOUTS.value()
        t = time.perf_counter()
        status, hdrs, raw = _post_any(
            served.app.url, dict(chat_body(6), max_tokens=3000),
            headers={"X-Cake-Request-Id": "p11c-late"})
        took = time.perf_counter() - t
        busy = served.engine.health()["slots_busy"]
        req = served.reqs["p11c-late"]
        nxt = served.chat(dict(chat_body(7), max_tokens=4))
        r_delta = SERVE_REQUEST_TIMEOUTS.value() - r0
        print(f"qos (c) request deadline 2 s, max_tokens 3000: HTTP "
              f"{status} after {took:.3f} s with {len(req.tokens)} tokens; "
              f"slots busy after {busy}; next chat HTTP {nxt['status']}; "
              f"request timeouts +{r_delta:g}; on {card}", flush=True)
        check(status == 504, f"phase 11 (c): request deadline {status}")
        check(2.0 <= took < 2.5, f"phase 11 (c): 504 after {took:.3f} s")
        check(busy == 0 and nxt["status"] == 200,
              "phase 11 (c): the expired slot was not freed")
        check(r_delta == 1 and SERVE_QUEUE_TIMEOUTS.value() == q0,
              f"phase 11 (c): request timeouts moved by {r_delta}")
    finally:
        served.close()


def _qos_tenants(served, card: str) -> None:
    """(d): t1:rps=1,burst=1: the second immediate chat of t1 answers 429
    tenant_quota with Retry-After; another tenant is unaffected."""
    from cake_tpu_torch.serve.admission import AdmissionPlane, TenantRegistry
    served.app.state.plane = AdmissionPlane(
        TenantRegistry("t1:rps=1,burst=1"))
    body = dict(chat_body(3), max_tokens=4)
    out = {}
    th = _send_async(served, body, {"X-Cake-Tenant": "t1",
                                    "X-Cake-Request-Id": "p11d-first"},
                     out, "first")
    # the second leaves as soon as the first holds its token (it is in
    # the engine), well inside the bucket's 1 s refill
    _until(lambda: "p11d-first" in served.reqs,
           "phase 11 (d): the first chat never reached the engine")
    second = _post_any(served.app.url, body,
                       headers={"X-Cake-Tenant": "t1"})
    th.join(timeout=600)
    first = out["first"]
    other = _post_any(served.app.url, body,
                      headers={"X-Cake-Tenant": "t2"})
    served.app.state.plane = None
    answer = json.loads(second[2])
    print(f"qos (d) tenant t1:rps=1,burst=1: HTTP {first[0]}, then "
          f"{second[0]} {answer.get('type')} Retry-After "
          f"{second[1].get('Retry-After')}; tenant t2 HTTP {other[0]}; on "
          f"{card}", flush=True)
    check(first[0] == 200 and other[0] == 200,
          "phase 11 (d): an admitted tenant's chat failed")
    check(second[0] == 429 and answer.get("type") == "tenant_quota"
          and int(second[1].get("Retry-After", 0)) >= 1,
          f"phase 11 (d): the throttled chat answered {second[0]}")


def _ttft_round(served, tag: str) -> tuple[float, list]:
    """Phase 5's traffic: 4 concurrent chats then one alone, each under
    its own request id. (TTFT p50 ms of the 4, request ids)."""
    bodies = [chat_body(i) for i in range(4)]
    rids = [f"{tag}-{i}" for i in range(5)]
    results = served.concurrent(
        bodies, headers=[{"X-Cake-Request-Id": r} for r in rids[:4]])
    served.chat(chat_body(4), {"X-Cake-Request-Id": rids[4]})
    _check_chats(results, f"phase 11 {tag}")
    return _latency(results)[0], rids


def _ttft_split(rid: str, spans: list) -> dict:
    """One request's TTFT split: the queue wait (enqueue to admit), the
    sum of its prefill-chunk spans, the time between its chunks (admit to
    first token, less the chunks: iterations spent behind other work),
    and the handler's template + encode span; ms."""
    from cake_tpu_torch.obs import TIMELINES
    ev = {}
    for e in TIMELINES.get(rid)["events"]:
        ev.setdefault(e["kind"], e["t_ms"])
    mine = [e for e in spans if e.get("args", {}).get("request_id") == rid]
    chunks = sum(e["dur"] for e in mine
                 if e["name"] == "serve.prefill_chunk") / 1e3
    prompt = sum(e["dur"] for e in mine
                 if e["name"] == "api.chat_prompt") / 1e3
    return {"ttft": round(ev["first_token"] - ev["received"], 2),
            "prompt": round(prompt, 3),
            "queue": round(ev["admit"] - ev["enqueue"], 2),
            "chunks": round(chunks, 2),
            "n_chunks": sum(1 for e in mine
                            if e["name"] == "serve.prefill_chunk"),
            "between": round(ev["first_token"] - ev["admit"] - chunks, 2)}


def _qos_plane(served, card: str) -> None:
    """(e) and (f): phase 5's traffic with the span recorder on; the
    routes of the metrics plane; each request's TTFT split; then TTFT
    p50 with the recorder on and off, in turns."""
    import torch
    from cake_tpu_torch.obs import RECORDER
    from cake_tpu_torch.ops import flash
    url = served.app.url
    RECORDER.enable()
    RECORDER.clear()
    eng = served.engine
    torch.cuda.synchronize()
    replays0 = eng.health()["prefill_graphs"]["replays"]
    flash.reset_launches()
    _, rids = _ttft_round(served, "p11f")
    torch.cuda.synchronize()
    replays = eng.health()["prefill_graphs"]["replays"] - replays0
    counts = flash.launch_counts()["bf16"]
    status, _, raw = _get(url, "/api/v1/trace")
    trace = json.loads(raw)
    spans = trace["traceEvents"]
    names = [e["name"] for e in spans]
    check(status == 200 and all({"name", "ph", "ts", "pid", "tid"} <= set(e)
                                for e in spans),
          "phase 11 (e): /api/v1/trace is not a Chrome trace")
    check(names.count("serve.prefill_chunk") == replays > 0
          and "serve.step" in names,
          f"phase 11 (e): {names.count('serve.prefill_chunk')} chunk spans "
          f"for {replays} prefill graph replays")
    status, hdrs, raw = _get(url, "/metrics")
    series = parse_prometheus(raw.decode())
    need = ['cake_serve_ttft_seconds_count{outcome="ok"}',
            'cake_serve_itl_seconds_count{outcome="ok"}',
            'cake_serve_e2e_seconds_count{outcome="ok"}',
            'cake_serve_qos_ttft_seconds_count{qos="interactive",'
            'outcome="ok"}',
            'cake_serve_qos_e2e_seconds_count{qos="interactive",'
            'outcome="ok"}']
    lacking = [k for k in need if not series.get(k)]
    check(status == 200 and not lacking,
          f"phase 11 (e): /metrics lacks {lacking}")
    status, _, raw = _get(url, f"/api/v1/requests/{rids[0]}")
    kinds = [e["kind"] for e in json.loads(raw)["events"]]
    at = [kinds.index(k) for k in ("enqueue", "admit", "prefill_chunk",
                                   "first_token", "finish")]
    check(status == 200 and at == sorted(at),
          f"phase 11 (e): timeline of {rids[0]}: {kinds}")
    slo, flight = _get(url, "/api/v1/slo"), _get(url, "/api/v1/flight?n=8")
    check(slo[0] == 200 and json.loads(slo[2])["cake_serve_ttft_seconds"]
          ["series"], "phase 11 (e): /api/v1/slo")
    check(flight[0] == 200 and json.loads(flight[2])["count"] == 8,
          "phase 11 (e): /api/v1/flight")
    print(f"plane (e): /api/v1/trace {len(spans)} events, serve.prefill_chunk "
          f"{names.count('serve.prefill_chunk')} = prefill graph replays "
          f"{replays}, serve.step {names.count('serve.step')}; /metrics "
          f"{len(series)} series; timeline {rids[0]}: {kinds[:6]}...; flash "
          f"launches {counts}; on {card}", flush=True)
    check(counts["fresh"] > 0, f"phase 11: no flash launch {counts}")
    for rid in rids:
        print(f"plane (f) TTFT split {rid} (ms): {_ttft_split(rid, spans)} "
              f"on {card}", flush=True)
    p50 = {"on": [], "off": []}
    for k in range(4):
        state = ("off", "on")[k % 2]
        RECORDER.enabled = state == "on"
        RECORDER.clear()
        p50[state].append(round(_ttft_round(served, f"p11t{k}")[0], 1))
    RECORDER.disable()
    print(f"plane (f) TTFT p50 of 4 concurrent chats, recorder off / on in "
          f"turns (smoke): off {p50['off']}, on {p50['on']} ms; on {card}",
          flush=True)


def phase_qos(model, card: str) -> None:
    """Phase 11: QoS lanes, victim classes, deadlines, tenants and the
    metrics plane, over HTTP on the full flagship."""
    from cake_tpu_torch.ops import flash
    t0 = time.perf_counter()
    served = serve_model(model, prefix_cache_mb=0)
    try:
        flash.reset_launches()
        _qos_lanes(served, card)
        lanes_flash = flash.launch_counts()["bf16"]
        check(lanes_flash["fresh"] > 0, "phase 11 (a): no flash launch")
        _qos_tenants(served, card)
        _qos_plane(served, card)
    finally:
        served.close()
    paged = [_qos_victims(model, card, mode)
             for mode in ("swap", "recompute")]
    _qos_deadlines(model, card)
    print(f"qos: phase 11 took {time.perf_counter() - t0:.1f} s; flash "
          f"launches in (a) {lanes_flash}, paged decode launches in (b) "
          f"{paged}; on {card}", flush=True)


# -- phase 12: speculative decoding -------------------------------------------


SPEC_K = 6          # the draft window (CAKE_SPEC_K's default)
SPEC_TOKENS = 64    # tokens per spec chat
NEAR_TIE = 0.05     # top-2 logit gap below which bf16 sums may flip a token
SPEC_WORDS = ("the", "card", "serves", "four", "slots", "at", "its", "limit",
              "and", "every", "draft", "that", "matches", "is", "kept")


def _passage(i: int, n: int = 230) -> str:
    words = " ".join(SPEC_WORDS[(i * 5 + j * 7) % len(SPEC_WORDS)]
                     for j in range(60))
    return f"passage {i}: {words}"[:n]


def spec_body(i: int) -> dict:
    """Phase 12's chat i: a passage stated twice, to be restated (the
    n-gram drafter finds what the output repeats)."""
    p = _passage(i)
    return {"messages": [{"role": "user", "content":
                          f"Restate this word for word. {p} Once more: {p}"}],
            "temperature": 0, "max_tokens": SPEC_TOKENS}


def _first_parting(on: list, off: list, gaps: list) -> list:
    """Where a spec-on stream parts from the spec-off one: [] when equal
    (or one ends early), else [(position, spec-off top-2 gap there)]."""
    n = min(len(on), len(off))
    j = next((i for i in range(n) if on[i] != off[i]), None)
    return [] if j is None else [(j, round(gaps[j], 5))]


def _parting(on: list, off: list, gaps: list, label: str) -> list:
    """_first_parting, which must be a near tie (the verify's wider GEMMs
    round differently in bf16), and equal lengths when equal."""
    n = min(len(on), len(off))
    j = next((i for i in range(n) if on[i] != off[i]), None)
    if j is None:
        check(len(on) == len(off), f"{label}: {len(on)} tokens with spec "
              f"on, {len(off)} off")
        return []
    check(gaps[j] < NEAR_TIE, f"{label}: spec on parts from spec off at "
          f"token {j}, where the spec-off top-2 logit gap is {gaps[j]:.4f} "
          f"(>= {NEAR_TIE})")
    return [(j, round(gaps[j], 5))]


class WrongDrafter:
    """Proposes a whole window of tokens after the last one shifted by 7:
    all but always rejected, so every verify reserves its window and
    commits one token, which leaves speculative tails for the pool's
    pressure path to trim. Stateless, so the engine's slots share it."""
    name = "wrong"
    shareable = True

    def __init__(self, vocab: int):
        self.vocab = vocab

    def propose(self, ids, k):
        return [(int(ids[-1]) + 7 + j) % self.vocab for j in range(k)]

    def reset(self):
        pass


def phase_spec_kernels(card: str) -> dict:
    """(a) The paged kernel on flattened verify rows against its plain
    version, bf16 and f32, at the flagship's 16/8 D 128 and Gemma3's 4/1
    D 256: drafts straddling a block boundary, a padded window, a
    one-token window, an inactive slot and a shared prefix block; 4 slots
    at the serving frontier; two deep rows. Each case launched twice, bit
    for bit. Then timed at the serving shape (4 slots at p = 620, k = 6):
    device ms beside the plain version, the library call over gathered
    rows, the decode call at the same frontier, and both bounds."""
    import torch
    from cake_tpu_torch.bench.spec_cases import case_args, verify_case
    from cake_tpu_torch.ops import paged_attention as pa
    s = SPEC_K + 1
    cases = (("mixed", dict(slots=[(620, s), (15, s), (300, 4), (40, 1),
                                   None], shared=True)),
             ("serving", dict(slots=[(620, s)] * 4)),
             ("deep", dict(slots=[(4000, s), (3989, s), None])))
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        route = pa.kernel_route(dtype)
        for shape_name, shape in (("16/8 D 128", {}),
                                  ("4/1 D 256", dict(hq=4, hkv=1, d=256))):
            for name, kw in cases:
                c = verify_case(s=s, dtype=dtype, device="cuda", seed=12,
                                **kw, **shape)
                args = case_args(c)
                got = pa.paged_verify_attention_kernel(*args)
                again = pa.paged_verify_attention_kernel(*args)
                torch.cuda.synchronize()
                want = pa.paged_verify_attention_ref(*args)
                vis = c["visible"].to("cuda")
                err = (got.float() - want.float())[vis].abs().max().item()
                print(f"paged verify {route} {shape_name} {name:8s}: slots "
                      f"{kw['slots']} (p, n_input), S {s}: max_abs_err "
                      f"{err:.3e} (tol {tol:g}); two launches equal "
                      f"{torch.equal(got, again)}", flush=True)
                check(torch.isfinite(got[vis]).all().item() and err <= tol,
                      f"paged verify {route} {shape_name} {name}: max_abs_err "
                      f"{err} > {tol}")
                check(torch.equal(got, again), f"paged verify {route} "
                      f"{shape_name} {name}: two launches differ")
    return {route: time_verify(dtype, {}, card) for route, dtype in (
        ("bf16", torch.bfloat16), ("f32", torch.float32))}


def time_verify(dtype, shape: dict, card: str) -> dict:
    """The paged kernel on a verify's flattened rows timed at the serving
    shape (4 slots at p = 620, k = SPEC_K, bt 16, heads `shape`): device
    ms beside the plain version, the library call over gathered rows, the
    decode call at the same frontier, and both bounds; printed."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend
    from cake_tpu_torch.bench.paged_cases import case_args as decode_args
    from cake_tpu_torch.bench.paged_cases import paged_case
    from cake_tpu_torch.bench.spec_cases import (case_args, library_args,
                                                 verify_bounds, verify_case)
    from cake_tpu_torch.bench.timing import device_ms, issue_ms
    from cake_tpu_torch.ops import paged_attention as pa
    s = SPEC_K + 1
    route = pa.kernel_route(dtype)
    c = verify_case([(620, s)] * 4, s, dtype=dtype, device="cuda",
                    seed=620, **shape)
    args = case_args(c)
    lib_args, lib_kw = library_args(c)
    err = (pa.paged_verify_attention_kernel(*args).float()
           - pa.paged_verify_attention_ref(*args).float()).abs().max()

    def kern():
        return pa.paged_verify_attention_kernel(*args)
    dc = paged_case([620] * 4, dtype=dtype, device="cuda", seed=620,
                    **shape)
    t = {"max_abs_err": err.item(), "ms": device_ms(kern),
         "issue_ms": issue_ms(kern),
         "plain_ms": device_ms(
             lambda: pa.paged_verify_attention_ref(*args), iters=10),
         "library_ms": device_ms(
             lambda: F.scaled_dot_product_attention(*lib_args, **lib_kw)),
         "library_backend": SDPBackend(torch._fused_sdp_choice(
             *lib_args, **lib_kw)).name,
         "decode_ms": device_ms(
             lambda: pa.paged_decode_attention_kernel(*decode_args(dc))),
         **verify_bounds(c)}
    tol = {"bf16": BF16_TOL, "f16": F16_TOL}.get(route, F32_TOL)
    check(t["max_abs_err"] <= tol, f"paged verify timing {route}: "
          f"max_abs_err {t['max_abs_err']} > {tol}")
    print(f"paged verify timing {route}: 4 slots at p=620, k={SPEC_K} "
          f"({4 * s} flattened rows), bt 16, "
          f"{c['q'].shape[2]}/{c['k'].shape[2]} D {c['q'].shape[3]}, "
          f"device ms: "
          f"kernel {t['ms']:.5f} (the decode call at p=620: "
          f"{t['decode_ms']:.5f}), plain {t['plain_ms']:.5f}, library "
          f"{t['library_ms']:.5f} ({t['library_backend']}, over rows "
          f"gathered beforehand); issue_ms {t['issue_ms']:.5f}; bound "
          f"ms over the unique bytes {t['unique_ms']:.5f}, over the "
          f"bytes read {t['read_ms']:.5f} ({t['bound_by']}); max_abs_err "
          f"{t['max_abs_err']:.3e}; on {card}", flush=True)
    return t


def phase_spec_graphs(model, card: str) -> None:
    """(b) The full flagship, 4 slots with ctx 4096, contiguous and paged
    (1024 blocks of 16), k = 6: 16 replays of the captured verify (the
    filtering form) equal 16 eager verify steps in packed ids (n_acc,
    tokens), logits, every KV byte and position, and every carry; rows at
    600 (greedy, drafts that are its plain continuation), 1100 (greedy,
    drafts all wrong), 300 (sampled at 0.8 / top_k 50) and a free row.
    The replay's device and wall ms beside the decode step's."""
    import torch
    from cake_tpu_torch.bench.graph_cases import build_state
    from cake_tpu_torch.bench.spec_cases import verify_vs_eager
    from cake_tpu_torch.bench.timing import device_ms, wall_ms
    from cake_tpu_torch.models.common.graphs import DecodeGraph
    from cake_tpu_torch.ops.sampling import SamplingConfig
    greedy = SamplingConfig(temperature=0.0)
    sampled = SamplingConfig(temperature=0.8, top_k=50)
    steps = 16
    for mode, kv_blocks in (("contiguous", 0), ("paged", 1024)):
        state = build_state(model, [600, 1100, 300, None],
                            [greedy, greedy, sampled, greedy], 4096,
                            kv_blocks=kv_blocks, headroom=1024, seed=6)
        r = verify_vs_eager(model, state, SPEC_K, steps,
                            ["right", "wrong", "right", None], True)
        n_acc = r["tokens"][:, 1].tolist()
        print(f"spec graph {mode}: {steps} verify replays vs eager verify "
              f"steps, k={SPEC_K}, rows at 600 (right drafts) / 1100 (wrong) "
              f"/ 300 (sampled 0.8, top_k 50) + 1 free: packed ids and "
              f"logits identical {r['equal']}, KV bytes identical "
              f"{r['kv_equal']}, carries identical {r['carries_equal']}, "
              f"max abs logit diff {r['max_logit_diff']:.3e}; accepted per "
              f"row {r['accepted']}; n_acc per step {n_acc[:4]}...; "
              f"launches per replay {r['graph'].launches_per_step}",
              flush=True)
        check(r["graph"].graph is not None, f"spec graph {mode}: not "
              "captured")
        check(r["equal"] and r["kv_equal"] and r["carries_equal"],
              f"spec graph {mode}: replays differ from eager verify steps")
        check(r["accepted"][0] > 0 and r["accepted"][1] == 0,
              f"spec graph {mode}: accepted {r['accepted']} (right drafts "
              "must be accepted, wrong ones rejected)")
        graph = r["graph"]
        replay_ms = device_ms(graph.step, iters=20)
        replay_wall = wall_ms(graph.step, 10)
        decode = DecodeGraph(state.step_fn(model), model.device)
        decode_ms = device_ms(decode.step, iters=20)
        decode_wall = wall_ms(decode.step, 10)
        print(f"spec graph {mode} timing (4 slots, 28 layers, bf16, k="
              f"{SPEC_K}): verify replay device ms {replay_ms:.4f}, wall ms "
              f"{replay_wall:.4f}; decode step replay device ms "
              f"{decode_ms:.4f}, wall ms {decode_wall:.4f}; on {card}",
              flush=True)
        del state, r, graph, decode
        torch.cuda.empty_cache()


def phase_spec_serve(model, card: str) -> int:
    """(c) The full flagship over HTTP with the n-gram drafter at k = 6,
    contiguous and paged (1024 blocks of 16; this one the server `cli
    serve --flagship` builds under CAKE_SPEC=ngram), prefix cache off: 4
    concurrent greedy chats of 64 tokens whose prompts state a passage
    twice, then each alone; the same chats with speculation off, and
    their plain stream (eager, with its top-2 logit gaps). Then the pool's
    pressure path (`_spec_pressure`). Returns the paged verify's bf16
    launches while serving."""
    import torch
    from cake_tpu_torch.bench.spec_cases import plain_stream
    from cake_tpu_torch.obs import RECORDER
    from cake_tpu_torch.ops import paged_attention as pa
    layers = model.cfg.num_hidden_layers
    bodies = [spec_body(i) for i in range(4)]
    paged_kw = dict(kv_blocks=1024, kv_block_tokens=16)
    launches = 0
    ref = {}
    for mode, kw in (("contiguous", {}), ("paged", paged_kw)):
        off = serve_model(model, prefix_cache_mb=0, **kw)
        try:
            off_res = off.concurrent(bodies)
            prompts = [off.reqs[r["rid"]].prompt_ids for r in off_res]
        finally:
            off.close()
        plain = plain_stream(model, prompts, SPEC_TOKENS, 4096,
                             kv_blocks=kw.get("kv_blocks", 0))
        for i, r in enumerate(off_res):
            check(r["tokens"] == plain[i]["tokens"][:len(r["tokens"])],
                  f"phase 12c {mode}: the served spec-off chat {i} differs "
                  "from its eager plain stream")
        ref[mode] = (off_res, plain)
        # paged: the server `cli serve --flagship` builds under CAKE_SPEC
        on = (serve_model(model, prefix_cache_mb=0, spec="ngram",
                          spec_k=SPEC_K) if not kw else _cli_spec_flagship())
        try:
            eng = on.engine
            check(eng.spec_k == SPEC_K and set(eng.verify_graphs) == {
                False, True} and all(g.graph is not None for g in
                                     eng.verify_graphs.values()),
                f"phase 12c {mode}: the verify graphs were not captured")
            url = on.app.url
            RECORDER.enable()
            RECORDER.clear()
            torch.cuda.synchronize()
            pa.reset_launches()
            replays0 = eng.health()["spec"]["verify_replays"]
            metrics0 = parse_prometheus(_get(url, "/metrics")[2].decode())
            on_res = on.concurrent(bodies)
            torch.cuda.synchronize()
            counts = pa.verify_launch_counts()
            h = eng.health()["spec"]
            replays = h["verify_replays"] - replays0
            metrics = parse_prometheus(_get(url, "/metrics")[2].decode())
            moved = {name: metrics.get(name, 0) - metrics0.get(name, 0)
                     for name in ("cake_serve_spec_proposed_total",
                                  "cake_serve_spec_accepted_total")}
            status, _, raw = _get(url, "/api/v1/trace")
            spans = [e["dur"] / 1e3 for e in json.loads(raw)["traceEvents"]
                     if e["name"] == "spec.verify"]
            RECORDER.disable()
            check(h["accepted"] > 0, f"phase 12c {mode}: no draft accepted "
                  f"({h})")
            check(status == 200 and len(spans) == replays > 0,
                  f"phase 12c {mode}: /api/v1/trace {status}, {len(spans)} "
                  f"spec.verify spans for {replays} replays")
            check(moved["cake_serve_spec_proposed_total"] > 0
                  and moved["cake_serve_spec_accepted_total"] > 0,
                  f"phase 12c {mode}: /metrics spec counters moved {moved}")
            if kw:
                check(counts == {"bf16": layers * replays, "f16": 0,
                                 "f32": 0},
                      f"phase 12c paged: verify launches {counts} != "
                      f"{layers} x {replays}")
                launches = counts["bf16"]
            else:
                check(sum(counts.values()) == 0, f"phase 12c contiguous: "
                      f"paged verify launches {counts}")
            _alone_equals_concurrent(on, bodies, on_res, f"phase 12c {mode}")
            parts = [_parting(r["tokens"], o["tokens"], p["gaps"],
                              f"phase 12c {mode} chat {i}")
                     for i, (r, o, p) in enumerate(zip(on_res, off_res,
                                                       plain))]
            _, tps_on = _latency(on_res)
            _, tps_off = _latency(off_res)
            spans.sort()
            print(f"spec serve (c) {mode}: 4 concurrent chats, "
                  f"{on_res[0]['resp']['usage']['prompt_tokens']}-token "
                  f"prompts, {SPEC_TOKENS} tokens: {h}; accept rate "
                  f"{h['accepted'] / max(h['proposed'], 1):.3f}, tokens per "
                  f"verify step {(h['accepted'] + h['steps']) / max(h['steps'], 1):.3f}; "
                  f"{replays} verify replays, verify launches {counts}; "
                  f"/metrics moved {moved}; "
                  f"spec.verify span ms min/median/max {spans[0]:.3f} / "
                  f"{spans[len(spans) // 2]:.3f} / {spans[-1]:.3f}; decode "
                  f"tok/s per request p50 spec on {tps_on:.1f}, off "
                  f"{tps_off:.1f} (smoke); spec on == off per chat "
                  f"{[not p for p in parts]}, partings at near ties "
                  f"(position, spec-off top-2 gap) {parts}; on {card}",
                  flush=True)
        finally:
            on.close()
    _spec_pressure(model, card)
    return launches


def _cli_spec_flagship() -> Served:
    """`cli serve --flagship` (seeded weights: phase 5's model) with a
    paged pool of 1024 blocks and the prefix cache off, under
    CAKE_SPEC=ngram and CAKE_SPEC_K=6, started."""
    from cake_tpu_torch import cli
    args = cli.parser().parse_args(
        ["serve", "--flagship", "--port", "0", "--slots", "4", "--ctx",
         "4096", "--prefix-cache-mb", "0", "--kv-blocks", "1024"])
    return _with_env({"CAKE_SPEC": "ngram", "CAKE_SPEC_K": str(SPEC_K)},
                     lambda: Served(cli.build_server(args).start()))


def _spec_pressure(model, card: str) -> None:
    """Phase 6(c)'s chats on its 96-block pool under swap, with windows
    of 32 rejected drafts (WrongDrafter): every decoding slot holds a
    speculative tail block, so the late chats' prefills trim tails before
    they preempt (a swap); then two chats of 64 tokens on a pool that runs
    out while they decode (k = 6): windows degrade to plain steps. Every
    chat's tokens are those of its plain stream but for near ties."""
    from cake_tpu_torch.bench.spec_cases import plain_stream
    tight = serve_model(model, prefix_cache_mb=0, kv_blocks=96,
                        kv_block_tokens=16, preempt_mode="swap",
                        spec=WrongDrafter(model.cfg.vocab_size), spec_k=32)
    try:
        first = {}

        def send(i):
            first[i] = tight.chat(chat_body(i))
        threads = [threading.Thread(target=send, args=(i,)) for i in (0, 1)]
        for th in threads:
            th.start()
        _until(lambda: len(tight.reqs) == 2 and all(
            r.tokens for r in tight.reqs.values()), "phase 12c: two chats "
            "decoding")
        late = tight.concurrent([chat_body(2), chat_body(3)])
        for th in threads:
            th.join(timeout=900)
        check(len(first) == 2 and all(r["status"] == 200 for r in
                                      first.values()),
              "phase 12c 96 blocks: a first chat failed")
        got = [first[0], first[1]] + late
        h = tight.engine.health()
        prompts = [tight.reqs[r["rid"]].prompt_ids for r in got]
    finally:
        tight.close()
    plain = plain_stream(model, prompts, 32, 4096, kv_blocks=1024)
    parts = [_parting(r["tokens"], p["tokens"][:32], p["gaps"],
                      f"phase 12c 96 blocks chat {i}")
             for i, (r, p) in enumerate(zip(got, plain))]
    print(f"spec serve (c) 96 blocks, swap, 32 rejected drafts: kv_pool "
          f"{h['kv_pool']}; spec {h['spec']}; spec on == plain per chat "
          f"{[not p for p in parts]}, partings {parts}; on {card}",
          flush=True)
    check(h["kv_pool"]["swaps"] >= 1, "phase 12c 96 blocks: no swap")
    check(h["spec"]["trimmed_blocks"] > 0, "phase 12c 96 blocks: no "
          "speculative tail was trimmed")
    # the pool's edge: two chats of 64 tokens on a pool that holds their
    # prompts and about 16 tokens more each, so that it runs out while
    # they decode: a window that does not fit degrades to a plain step
    body = dict(chat_body(0), max_tokens=64)
    n = len(prompts[0])
    edge = serve_model(model, prefix_cache_mb=0,
                       kv_blocks=2 * -(-(n + 16) // 16), kv_block_tokens=16,
                       preempt_mode="swap",
                       spec=WrongDrafter(model.cfg.vocab_size),
                       spec_k=SPEC_K)
    try:
        res = edge.concurrent([body, dict(chat_body(1), max_tokens=64)])
        h = edge.engine.health()
        prompts = [edge.reqs[r["rid"]].prompt_ids for r in res]
    finally:
        edge.close()
    plain = plain_stream(model, prompts, 64, 4096, kv_blocks=1024)
    parts = [_parting(r["tokens"], p["tokens"], p["gaps"],
                      f"phase 12c pool edge chat {i}")
             for i, (r, p) in enumerate(zip(res, plain))]
    print(f"spec serve (c) pool edge, {h['kv_pool']['blocks']} blocks: spec "
          f"{h['spec']}; swaps {h['kv_pool']['swaps']}; spec on == plain "
          f"per chat {[not p for p in parts]}, partings {parts}; on {card}",
          flush=True)
    check(h["spec"]["degraded"] > 0, "phase 12c pool edge: no window "
          "degraded to a plain step")


def phase_spec_generate(card: str) -> int:
    """(d) The 2-layer f32 parity model (TF32 off): generate with the
    n-gram drafter and with the model as its own draft model equals plain
    generate token for token, and the draft model's every draft is
    accepted; then phase (c)'s prompts served with speculation on and off
    (contiguous and paged, 48 tokens): equal exactly. Returns the paged
    verify's f32 launches."""
    import torch
    from cake_tpu_torch.cli import build_flagship
    from cake_tpu_torch.models import TextModel
    from cake_tpu_torch.ops import paged_attention as pa
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve import ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = build_flagship(layers=2, dtype="f32", seed=1, device="cpu")
    gpu = TextModel(cpu.cfg, _to_device(cpu.params, "cuda"),
                    dtype=torch.float32, device="cuda")
    del cpu
    prompts = [list(f"Restate: {_passage(i)} Again: {_passage(i)}".encode())
               for i in range(4)]
    plain, _ = gpu.generate(prompts[0], 48, spec=False)
    ngram, st = gpu.generate(prompts[0], 48, spec="ngram", spec_k=SPEC_K)
    own, st2 = gpu.generate(prompts[0], 48, spec=gpu, spec_k=SPEC_K)
    print(f"spec generate (d) f32, 2 layers: n-gram == plain {ngram == plain}"
          f" ({st['spec_steps']} verify steps, {st['spec_accepted']} of "
          f"{st['spec_proposed']} accepted); own draft model == plain "
          f"{own == plain} ({st2['spec_accepted']} of "
          f"{st2['spec_proposed']} accepted, {st2['spec_tokens_per_step']} "
          f"tokens per step)", flush=True)
    check(ngram == plain and own == plain,
          "phase 12d: generate under speculation differs from plain")
    check(st2["spec_accepted"] == st2["spec_proposed"] > 0,
          "phase 12d: the perfect drafter's drafts were not all accepted")
    greedy = SamplingConfig(temperature=0.0)
    launches = 0
    for mode, kw in (("contiguous", {}),
                     ("paged", dict(kv_blocks=1024, kv_block_tokens=16))):
        outs = {}
        for spec in (False, "ngram"):
            eng = ServeEngine(gpu, slots=4, ctx_len=4096, prefix_cache_mb=0,
                              spec=spec, spec_k=SPEC_K, **kw)
            try:
                torch.cuda.synchronize()
                pa.reset_launches()
                rs = [eng.submit(p, 48, greedy) for p in prompts]
                for r in rs:
                    check(r.wait(600) and "error" not in r.result,
                          f"phase 12d {mode}: a request failed")
                torch.cuda.synchronize()
                outs[spec] = [r.result["tokens"] for r in rs]
                if spec and kw:
                    launches = pa.verify_launch_counts()["f32"]
                    check(launches > 0, "phase 12d paged: no f32 verify "
                          "launch")
                h = eng.health()
            finally:
                eng.close()
        print(f"spec serve (d) f32 {mode}: spec on == off "
              f"{outs['ngram'] == outs[False]}; spec {h.get('spec')}",
              flush=True)
        check(outs["ngram"] == outs[False],
              f"phase 12d {mode}: f32 tokens differ with spec on")
    del gpu
    torch.cuda.empty_cache()
    return launches


def phase_spec(model, card: str) -> dict:
    """Phase 12: speculative decoding (a)-(d)."""
    t0 = time.perf_counter()
    timings = phase_spec_kernels(card)
    phase_spec_graphs(model, card)
    served = phase_spec_serve(model, card)
    f32 = phase_spec_generate(card)
    print(f"spec: phase 12 took {time.perf_counter() - t0:.1f} s; paged "
          f"verify launches served bf16 {served}, f32 {f32}; on {card}",
          flush=True)
    return {"timings": timings, "launches": {"bf16": served, "f32": f32}}


# -- phase 7: the flagship from a checkpoint directory ------------------------


def _tree_diff(a, b, path="") -> list[str]:
    """Paths where two parameter trees differ (keys, dtype, shape or
    bits)."""
    import torch
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [f"{path}: keys {sorted(a)} != {sorted(b)}"]
        return [d for k in a for d in _tree_diff(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, list):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _tree_diff(x, y, f"{path}.{i}")]
    same = (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a, b.to(a.device)))
    return [] if same else [path]


def _cli_server(model_dir: str, *extra: str) -> Served:
    """`cli serve MODEL_DIR` with 4 slots and ctx 4096, started."""
    from cake_tpu_torch import cli
    args = cli.parser().parse_args(
        ["serve", model_dir, "--port", "0", "--slots", "4", "--ctx", "4096",
         *extra])
    return Served(cli.build_server(args).start())


def _prompt_ids_match(served, model_dir: str, bodies, label) -> None:
    """The prompt ids each request reached the engine with equal a fresh
    CPU tokenizer's chat_prompt_ids of its messages."""
    from cake_tpu_torch.runtime import CakeTokenizer
    tok = CakeTokenizer(model_dir)
    want = sorted(tok.chat_prompt_ids(b["messages"]) for b in bodies)
    got = sorted(r.prompt_ids for r in served.reqs.values())
    check(all(w in got for w in want),
          f"{label}: the engine's prompt ids differ from the tokenizer's")


CKPT_LAYERS = 4     # phase 7's flagship checkpoint, of 28 (cut for the
                    # whole run's time); phase 15(c) serves it in float32


def phase_checkpoint(card: str, workdir: str) -> dict:
    """Phase 7. The flagship (seed 0, bf16, CKPT_LAYERS of its 28 layers)
    written as an HF
    directory (two safetensors shards and an index, config.json, a
    byte-level BPE tokenizer.json with Qwen3's ChatML ids and a ChatML
    template), loaded through runtime.build_text_model bit-identical to
    init_params(seed 0) (here: `model`, build_flagship(seed 0) at the
    same depth), then
    served through `cli serve DIR`, contiguous and paged (1024 blocks):
    4 concurrent chats and one SSE chat, all 200, each equal alone and in
    company, their prompt ids those of the CPU tokenizer; and generate's
    greedy tokens on a fixed id list equal `model`'s. The directory stays
    for phase 15. Returns the load's {seconds, gb, gb_s}."""
    import torch
    from cake_tpu_torch.bench import synth_checkpoint as sc
    from cake_tpu_torch.cli import build_flagship
    from cake_tpu_torch.runtime import build_text_model
    d = os.path.join(workdir, "qwen3-flagship")
    config = sc.flagship_config(CKPT_LAYERS)
    model = build_flagship(layers=CKPT_LAYERS, dtype="bf16", seed=0,
                           device="cuda")
    t = time.perf_counter()
    nbytes = sc.write_model(d, config, sc.model_params(config, seed=0),
                            shards=2)
    sc.write_tokenizer(d, sc.QWEN3_SPECIALS)
    print(f"checkpoint: flagship written to {len(os.listdir(d))} files "
          f"({nbytes / 1e9:.3f} GB of tensors) in "
          f"{time.perf_counter() - t:.1f}s", flush=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    loaded, tok, model_id = build_text_model(d, "bf16", device="cuda",
                                             max_cache_len=4096)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    load = {"seconds": load_s, "gb": nbytes / 1e9,
            "gb_s": nbytes / 1e9 / load_s}
    diff = _tree_diff(loaded.params, model.params)
    print(f"checkpoint load: {load['gb']:.3f} GB "
          f"({loaded.cfg.num_hidden_layers} layers, bf16, 2 "
          f"shards, page cache warm) in {load_s:.3f}s = {load['gb_s']:.2f} "
          f"GB/s through build_text_model; every tensor bit-identical to "
          f"init_params(seed 0): {not diff}; on {card}", flush=True)
    check(not diff, f"loaded params differ from init_params: {diff[:5]}")
    check(model_id == "qwen3-flagship", f"model id {model_id}")
    ids = [int(x) for x in torch.randint(
        0, config["vocab_size"], (300,),
        generator=torch.Generator().manual_seed(21))]
    got, _ = loaded.generate(ids, 32)
    want, _ = model.generate(ids, 32)
    print(f"checkpoint greedy: 32 tokens off a 300-id prompt equal to "
          f"build_flagship(seed=0)'s {got == want}", flush=True)
    check(got == want, f"checkpoint greedy {got} != flagship {want}")
    del loaded, model
    torch.cuda.empty_cache()
    bodies = [chat_body(i) for i in range(4)] + [chat_body(4, True)]
    for mode, extra in (("contiguous", ()),
                        ("paged", ("--kv-blocks", "1024"))):
        served = _cli_server(d, *extra)
        try:
            results = served.concurrent(bodies)
            _check_chats_any(results, f"phase 7 {mode}")
            check(all(r["resp"]["model"] == "qwen3-flagship"
                      for r in results[:4]), "phase 7: model id")
            _prompt_ids_match(served, d, bodies, f"phase 7 {mode}")
            _alone_equals_concurrent(served, bodies, results,
                                     f"phase 7 {mode}")
            first = results[0]["resp"]
            print(f"checkpoint serve {mode}: 4 concurrent chats + 1 SSE, all "
                  f"200, {first['usage']['prompt_tokens']}-token prompts "
                  f"(BPE), each equal alone and in company; first reply "
                  f"{first['choices'][0]['message']['content'][:60]!r}",
                  flush=True)
        finally:
            served.close()
    return load


def _check_chats_any(results: list[dict], label: str) -> None:
    """Phase 5's checks for a model whose tokenizer gives most sampled ids
    no text (random weights over a small BPE vocabulary): the SSE stream
    ends with [DONE] and carries chunks, each blocking chat has tokens."""
    for i, r in enumerate(results):
        if "events" in r:
            check(r["events"] and r["events"][-1] == "[DONE]"
                  and len(r["events"]) >= 3,
                  f"{label}: SSE stream did not end with [DONE]")
        else:
            check(r["resp"]["usage"]["completion_tokens"] > 0,
                  f"{label} request {i}: no completion tokens")


# -- phase 8: the checkpoint families at their published widths ---------------

# OLMo2 and Phi-4 at one layer (cut for the whole run's time), EXAONE4 at
# four so that its global NoPE layer (index 3) exists
FAMILY_LAYERS = {"olmo2": 1, "exaone4": 4, "phi4": 1}


def _family_dir(fam: str, workdir: str, layers: int | None,
                name: str | None = None) -> tuple[str, int]:
    """The family's config at `layers` depth (None: its own) with seeded
    weights and randomized norms, bf16, two shards; a BPE tokenizer with
    ChatML specials at the top of its vocabulary, or for Gemma3 the
    Gemma-style tokenizer. Returns (dir, bytes of tensors)."""
    from cake_tpu_torch.bench import synth_checkpoint as sc
    d = os.path.join(workdir, name or fam)
    config = sc.family_config(fam, layers)
    nbytes = sc.write_model(d, config, sc.model_params(
        config, seed=7, randomize_norms=True), shards=2)
    v = config["vocab_size"]
    if fam == "gemma3":
        sc.write_gemma_tokenizer(d, vocab_size=v)
    else:
        sc.write_tokenizer(d, {"<|endoftext|>": v - 3, "<|im_start|>": v - 2,
                               "<|im_end|>": v - 1})
    return d, nbytes


def phase_families(card: str, workdir: str) -> dict:
    """Phase 8. For each family: f32 on the card against f32 on this
    machine's CPU, both loaded through build_text_model, contiguous and
    paged (phase 4's chunked 600-token prefill and 16 greedy tokens);
    bf16: a 600-token prompt prefilled through flash (fresh and append
    launches counted) into a 2-slot pool, then 16 replays of the captured
    decode step equal 16 eager steps, contiguous and paged; EXAONE4 also
    served by the paged engine over HTTP, two chats each equal alone and
    in company. Returns {fam: launch counts by kernel entry}."""
    import torch
    from cake_tpu_torch.bench.graph_cases import build_state, graph_vs_eager
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops import paged_attention as pa
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.runtime import build_text_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    greedy = SamplingConfig(temperature=0.0)
    out = {}
    for fam in FAMILY_LAYERS:
        d, _ = _family_dir(fam, workdir, FAMILY_LAYERS[fam])
        counts = {"fresh": 0, "append": 0, "paged": 0, "f32": 0,
                  "f32_append": 0}
        cpu, _, _ = build_text_model(d, "f32", device="cpu",
                                     max_cache_len=4096)
        gpu, _, _ = build_text_model(d, "f32", device="cuda",
                                     max_cache_len=4096)
        cfg = gpu.cfg
        shape = (f"Hq/Hkv {cfg.num_attention_heads}/"
                 f"{cfg.num_key_value_heads} D {cfg.head_dim} rotary "
                 f"{cfg.rotary_dim} window {cfg.sliding_window} "
                 f"{cfg.num_hidden_layers} layers "
                 f"{[s.kind for s in cfg.layer_specs()]}")
        ids = [int(x) for x in torch.randint(
            0, cfg.vocab_size, (600,),
            generator=torch.Generator().manual_seed(5))]
        lg, tg, launches = chunked_prefill_and_greedy(gpu, ids)
        lp, tp, paged_launches = paged_prefill_and_greedy(gpu, ids)
        lc, tc, _ = chunked_prefill_and_greedy(cpu, ids)
        err, err_p = ((x - lc).abs().max().item() for x in (lg, lp))
        counts["f32"] = launches["f32"]["fresh"]
        counts["f32_append"] = launches["f32"]["append"]
        print(f"family {fam} ({shape}) f32 card vs CPU: flash launches "
              f"{launches}, paged {paged_launches}; logits max_abs_err "
              f"{err:.3e} contiguous, {err_p:.3e} paged (tol {LOGIT_TOL:g}); "
              f"16 greedy tokens identical {tg == tc} / {tp == tc}",
              flush=True)
        check(err <= LOGIT_TOL and err_p <= LOGIT_TOL,
              f"{fam}: f32 logits differ by {err} / {err_p}")
        check(tg == tc and tp == tc, f"{fam}: f32 greedy tokens differ")
        check(launches["f32"]["fresh"] > 0 and launches["f32"]["append"] > 0
              and paged_launches["f32"] > 0,
              f"{fam}: f32 kernels not launched: {launches} "
              f"{paged_launches}")
        del cpu, gpu
        torch.cuda.empty_cache()
        model, _, _ = build_text_model(d, "bf16", device="cuda",
                                       max_cache_len=4096)
        for mode, kv_blocks in (("contiguous", 0), ("paged", 1024)):
            flash.reset_launches()
            pa.reset_launches()
            state = build_state(model, [600, None], [greedy, greedy], 4096,
                                kv_blocks=kv_blocks, seed=3)
            fl = flash.launch_counts()["bf16"]
            check(fl["fresh"] > 0 and fl["append"] > 0,
                  f"{fam} {mode}: bf16 flash launches {fl}")
            r = graph_vs_eager(model, state, 16)
            torch.cuda.synchronize()
            paged_n = pa.launch_counts()["bf16"]
            print(f"family {fam} bf16 {mode}: 600-token prefill flash "
                  f"launches {fl}; 16 replays of the captured decode step "
                  f"vs eager: tokens {r['tokens_equal']}, KV bytes "
                  f"{r['kv_equal']}, carries {r['carries_equal']}; paged "
                  f"decode launches {paged_n}", flush=True)
            check(r["graph"].graph is not None
                  and r["tokens_equal"] and r["kv_equal"]
                  and r["carries_equal"],
                  f"{fam} {mode}: graph replays differ from eager steps")
            check(kv_blocks == 0 or paged_n > 0,
                  f"{fam}: no paged decode launch")
            counts["fresh"] += fl["fresh"]
            counts["append"] += fl["append"]
            counts["paged"] += paged_n
            del state, r
            torch.cuda.empty_cache()
        del model
        torch.cuda.empty_cache()
        if fam == "exaone4":
            flash.reset_launches()
            pa.reset_launches()
            served = _cli_server(d, "--kv-blocks", "1024")
            try:
                bodies = [chat_body(0), chat_body(1)]
                results = served.concurrent(bodies)
                _check_chats_any(results, "phase 8 exaone4")
                _alone_equals_concurrent(served, bodies, results,
                                         "phase 8 exaone4")
                _prompt_ids_match(served, d, bodies, "phase 8 exaone4")
            finally:
                served.close()
            fl = flash.launch_counts()["bf16"]
            paged_n = pa.launch_counts()["bf16"]
            print(f"family exaone4 served (paged, 1024 blocks): 2 chats "
                  f"equal alone and in company; flash launches {fl}, paged "
                  f"decode launches {paged_n}; on {card}", flush=True)
            check(paged_n > 0 and fl["fresh"] > 0,
                  "exaone4 serve: kernels not launched")
            counts["fresh"] += fl["fresh"]
            counts["append"] += fl["append"]
            counts["paged"] += paged_n
        shutil.rmtree(d, ignore_errors=True)
        out[fam] = counts
    return out


# -- phase 9: Gemma-3-1B at its published widths --------------------------------

GEMMA_PARITY_LAYERS = 6     # layer 5 is global: the paged pool needs one
GEMMA_CKPT_LAYERS = 6       # (b) and (c), of 26: one period of the
                            # sliding-window pattern, its global layer 5
                            # included (cut for the whole run's time)


def phase_gemma3(card: str, workdir: str) -> dict:
    """Phase 9 (a)-(c). Returns the launches of each kernel entry in it:
    fresh / append (bf16 flash, (b) and (c)), paged (bf16, (b) and (c)),
    f32 / f32_append (flash) and paged_f32, all in (a)."""
    import torch
    from cake_tpu_torch.bench.graph_cases import build_state, graph_vs_eager
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops import paged_attention as pa
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.runtime import build_text_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    greedy = SamplingConfig(temperature=0.0)
    out = {}
    # (a) f32 parity at 6 layers, card against CPU
    d, _ = _family_dir("gemma3", workdir, GEMMA_PARITY_LAYERS, "gemma3-6")
    cpu, _, _ = build_text_model(d, "f32", device="cpu", max_cache_len=4096)
    gpu, _, _ = build_text_model(d, "f32", device="cuda", max_cache_len=4096)
    cfg = gpu.cfg
    kinds = ["G" if s.window is None else "L" for s in cfg.layer_specs()]
    ids = [int(x) for x in torch.randint(
        0, cfg.vocab_size, (600,), generator=torch.Generator().manual_seed(5))]
    lg, tg, launches = chunked_prefill_and_greedy(gpu, ids)
    lp, tp, paged_launches = paged_prefill_and_greedy(gpu, ids)
    lc, tc, _ = chunked_prefill_and_greedy(cpu, ids)
    err, err_p = ((x - lc).abs().max().item() for x in (lg, lp))
    print(f"gemma3 (a) Hq/Hkv {cfg.num_attention_heads}/"
          f"{cfg.num_key_value_heads} D {cfg.head_dim} window "
          f"{cfg.sliding_window} layers {''.join(kinds)}, f32, 600-token "
          f"prompt (the 512-token rings wrap): flash launches {launches}, "
          f"paged {paged_launches}; logits max_abs_err {err:.3e} contiguous,"
          f" {err_p:.3e} paged (tol {LOGIT_TOL:g}); 16 greedy tokens "
          f"identical {tg == tc} / {tp == tc}", flush=True)
    check(kinds.count("G") == 1, f"gemma3 (a): layers {kinds}")
    check(err <= LOGIT_TOL and err_p <= LOGIT_TOL,
          f"gemma3 (a): f32 logits differ by {err} / {err_p}")
    check(tg == tc and tp == tc, "gemma3 (a): f32 greedy tokens differ")
    check(launches["f32"]["fresh"] > 0 and launches["f32"]["append"] > 0
          and paged_launches["f32"] > 0,
          f"gemma3 (a): f32 kernels not launched: {launches} "
          f"{paged_launches}")
    out["f32"] = launches["f32"]["fresh"]
    out["f32_append"] = launches["f32"]["append"]
    out["paged_f32"] = paged_launches["f32"]
    del cpu, gpu
    torch.cuda.empty_cache()
    shutil.rmtree(d, ignore_errors=True)
    # (b) the full model from its checkpoint: graph replays vs eager steps
    t = time.perf_counter()
    d, nbytes = _family_dir("gemma3", workdir, GEMMA_CKPT_LAYERS,
                            "gemma-3-1b")
    write_s = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    model, _, model_id = build_text_model(d, "bf16", device="cuda",
                                          max_cache_len=4096)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    print(f"gemma3 (b) checkpoint: {nbytes / 1e9:.3f} GB of bf16 tensors "
          f"written in {write_s:.1f}s, loaded through build_text_model in "
          f"{load_s:.3f}s = {nbytes / 1e9 / load_s:.2f} GB/s "
          f"({model.cfg.num_hidden_layers} layers); on {card}", flush=True)
    flash.reset_launches()
    pa.reset_launches()
    for mode, kv_blocks in (("contiguous", 0), ("paged", 1024)):
        state = build_state(model, [600, None], [greedy, greedy], 4096,
                            kv_blocks=kv_blocks, seed=3)
        r = graph_vs_eager(model, state, 16)
        torch.cuda.synchronize()
        print(f"gemma3 (b) bf16 {mode}: 600-token prefill, 16 replays of the"
              f" captured decode step vs eager: tokens {r['tokens_equal']}, "
              f"KV bytes {r['kv_equal']}, carries {r['carries_equal']}, max "
              f"abs logit diff {r['max_logit_diff']:.3e}", flush=True)
        check(r["graph"].graph is not None and r["tokens_equal"]
              and r["kv_equal"] and r["carries_equal"],
              f"gemma3 (b) {mode}: graph replays differ from eager steps")
        del state, r
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    # (c) served through `cli serve DIR`
    bodies = [chat_body(i) for i in range(4)] + [chat_body(4, True)]
    for mode, extra in (("contiguous", ()),
                        ("paged", ("--kv-blocks", "1024"))):
        served = _cli_server(d, *extra)
        try:
            results = served.concurrent(bodies)
            _check_chats_any(results, f"phase 9 {mode}")
            check(all(r["resp"]["model"] == "gemma-3-1b"
                      for r in results[:4]), "phase 9: model id")
            _prompt_ids_match(served, d, bodies, f"phase 9 {mode}")
            _alone_equals_concurrent(served, bodies, results,
                                     f"phase 9 {mode}")
            first = results[0]["resp"]
            ttft, tps = _latency(results[:4])
            print(f"gemma3 (c) served {mode}: 4 concurrent chats + 1 SSE, "
                  f"all 200, {first['usage']['prompt_tokens']}-token prompts "
                  f"(byte-fallback BPE), each equal alone and in company, "
                  f"prompt ids those of a CPU tokenizer; TTFT p50 {ttft:.1f} "
                  f"ms, decode tok/s per request p50 {tps:.1f} (smoke); on "
                  f"{card}", flush=True)
        finally:
            served.close()
    torch.cuda.synchronize()
    fl = flash.launch_counts()["bf16"]
    out.update(fresh=fl["fresh"], append=fl["append"],
               paged=pa.launch_counts()["bf16"])
    print(f"gemma3 (b)+(c) launches: bf16 flash {fl}, paged decode "
          f"{out['paged']}", flush=True)
    check(out["fresh"] > 0 and out["append"] > 0 and out["paged"] > 0,
          f"gemma3: bf16 kernels not launched: {out}")
    shutil.rmtree(d, ignore_errors=True)
    return out


# -- phase 13: Qwen3-Next, MoE and Gated DeltaNet -----------------------------

QNEXT_LAYERS = 4        # of 48, 13(c) and 13(d): 3 linear, 1 full, all
                        # MoE (cut from 12 for the whole run's time)
QNEXT_CKPT_LAYERS = 4   # the checkpoint round trip: 3 linear, 1 full
QNEXT_HEADS = dict(hq=16, hkv=2, d=256)
QNEXT_STEPS = 16
LINEAR_TOL = 2e-2       # bf16: a verify's wider GEMMs round differently


def qwen3_next(layers: int, dtype, seed: int = 0,
               layer_types: list | None = None):
    """Qwen3-Next-80B-A3B's widths (synth_checkpoint.FAMILIES) cut to
    `layers` blocks (or given `layer_types`), weights seeded from a
    torch.Generator on the card, the byte tokenizer, ctx 4096."""
    from cake_tpu_torch.bench.synth_checkpoint import family_config
    from cake_tpu_torch.models import TextModel
    from cake_tpu_torch.models.common.config import config_from_hf_dict
    from cake_tpu_torch.models.common.layers import init_params
    from cake_tpu_torch.tokenizer import ByteTokenizer
    d = family_config("qwen3_next", layers)
    if layer_types:
        d["layer_types"] = layer_types
    cfg = config_from_hf_dict(d)
    params = init_params(cfg, seed, dtype, "cuda", gen_device="cuda")
    return TextModel(cfg, params, tokenizer=ByteTokenizer(), dtype=dtype,
                     device="cuda", max_cache_len=4096)


def phase_qnext_kernels(card: str) -> dict:
    """13(a). Both flash routes at Qwen3-Next's heads (16/2, D 256, a GQA
    group of 8): fresh, a ragged valid length and append, each against
    the plain version and launched twice bit for bit, and the device-meta
    form (fresh, append at 256, ragged) against the plain version, the
    host-int form and itself; the paged decode kernel on decode rows and
    on a verify's flattened rows at the same heads, both routes, twice
    bit for bit. Then fresh and append, the decode and the verify timed
    beside the plain version, the library call and the bound."""
    import torch
    from cake_tpu_torch.bench import flash_meta, paged_timing
    from cake_tpu_torch.bench.paged_cases import case_args as decode_args
    from cake_tpu_torch.bench.paged_cases import paged_case
    from cake_tpu_torch.bench.spec_cases import case_args, verify_case
    from cake_tpu_torch.ops import paged_attention as pa
    from cake_tpu_torch.ops.flash import (flash_attention_kernel,
                                          flash_attention_ref, kernel_route)
    s = SPEC_K + 1
    cases = (("fresh", {}), ("fresh_valid200", dict(valid_len=200)),
             ("append", FLASH_CASES[4][1]))
    metas = [(f"qnext_{mode}{off or ''}{'_v200' if vl == 200 else ''}",
              256, 16, 2, mode, off, vl)
             for mode, off, vl in (("fresh", 0, 256), ("fresh", 0, 200),
                                   ("append", 256, 256),
                                   ("append", 256, 200))]
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        route = kernel_route(dtype)
        for name, spec in cases:
            q, k, v, kw = flash_case(f"qnext_{name}", dtype, **QNEXT_HEADS,
                                     **spec)
            got = flash_attention_kernel(q, k, v, **kw)
            again = flash_attention_kernel(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - flash_attention_ref(q, k, v, **kw).float()
                   ).abs().max().item()
            print(f"qwen3-next flash {name:15s} {route} 16/2 D 256 "
                  f"max_abs_err {err:.3e} (tol {tol:g}); two launches equal "
                  f"{torch.equal(got, again)}", flush=True)
            check(err <= tol and torch.isfinite(got).all().item(),
                  f"qwen3-next flash {name} {route}: max_abs_err {err}")
            check(torch.equal(got, again),
                  f"qwen3-next flash {name} {route}: two launches differ")
        for case in metas:
            r = flash_meta.check(flash_meta.meta_case(*case, dtype))
            print(f"qwen3-next flash meta {case[0]:18s} {route} max_abs_err "
                  f"{r['max_abs_err']:.3e}; bits equal to the host-int form "
                  f"{r['same_as_host_int']}, across two launches "
                  f"{r['same_twice']}", flush=True)
            check(r["finite"] and r["max_abs_err"] <= tol
                  and r["same_as_host_int"] and r["same_twice"],
                  f"qwen3-next flash meta {case[0]} {route}: {r}")
        for name, frontiers in (("decode", [600, 1100, 300, 2000]),
                                ("decode_stale_shared", [40, 620, 300])):
            c = paged_case(frontiers, dtype=dtype, device="cuda", seed=13,
                           stale=name != "decode", shared=name != "decode",
                           **QNEXT_HEADS)
            got = pa.paged_decode_attention_kernel(*decode_args(c))
            again = pa.paged_decode_attention_kernel(*decode_args(c))
            torch.cuda.synchronize()
            want = pa.paged_decode_attention_ref(*decode_args(c))
            rows = c["visible_rows"]
            err = (got[rows].float() - want[rows].float()).abs().max().item()
            print(f"qwen3-next paged {name} {route} rows at {frontiers}: "
                  f"max_abs_err {err:.3e}; two launches equal "
                  f"{torch.equal(got, again)}", flush=True)
            check(err <= tol and torch.equal(got, again),
                  f"qwen3-next paged {name} {route}: max_abs_err {err}")
        for name, slots in (("verify_mixed", [(620, s), (15, s), (300, 4),
                                              (40, 1), None]),
                            ("verify_serving", [(620, s)] * 4)):
            c = verify_case(slots, s, dtype=dtype, device="cuda", seed=13,
                            shared=name == "verify_mixed", **QNEXT_HEADS)
            args = case_args(c)
            got = pa.paged_verify_attention_kernel(*args)
            again = pa.paged_verify_attention_kernel(*args)
            torch.cuda.synchronize()
            vis = c["visible"].to("cuda")
            err = (got.float() - pa.paged_verify_attention_ref(*args).float()
                   )[vis].abs().max().item()
            print(f"qwen3-next paged {name} {route} slots {slots}: "
                  f"max_abs_err {err:.3e}; two launches equal "
                  f"{torch.equal(got, again)}", flush=True)
            check(err <= tol and torch.equal(got, again),
                  f"qwen3-next paged {name} {route}: max_abs_err {err}")
    timings = {
        "flash.fresh": time_flash("qnext_fresh", torch.bfloat16,
                                  QNEXT_HEADS),
        "flash.append": time_flash("qnext_append", torch.bfloat16,
                                   dict(QNEXT_HEADS, **FLASH_CASES[4][1])),
        "flash.f32": time_flash("qnext_f32", torch.float32, QNEXT_HEADS),
        "flash.f32_append": time_flash(
            "qnext_f32_append", torch.float32,
            dict(QNEXT_HEADS, **FLASH_CASES[4][1])),
        "verify.bf16": time_verify(torch.bfloat16, QNEXT_HEADS, card),
        "verify.f32": time_verify(torch.float32, QNEXT_HEADS, card)}
    timings["module10"] = time_module10(card)
    paged = paged_timing.measure(with_plain=True, shapes=(
        ("bf16", "bfloat16", 620, QNEXT_HEADS),
        ("f32", "float32", 620, QNEXT_HEADS)))
    for entry, t in paged.items():
        tol = F32_TOL if entry == "f32" else BF16_TOL
        check(t["max_abs_err"] <= tol and t["same_bits"],
              f"qwen3-next paged timing {entry}: {t['max_abs_err']}")
        print(f"qwen3-next paged decode timing {entry}: 4 rows at p=620, bt "
              f"16, 16/2 D 256, device ms: kernel {t['ms']:.5f} plain "
              f"{t['plain_ms']:.5f} library {t['library_ms']:.5f}; bound_ms "
              f"{t['bound_ms']:.5f} ({t['bound_by']}); on {card}",
              flush=True)
        timings[f"decode.{entry}"] = t
    return timings


def _graphed(fn):
    """fn captured as a CUDA graph (warmed up on a side stream); returns
    its replay."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def time_module10(card: str) -> dict:
    """Device ms of module 10's torch-op work at Qwen3-Next's widths in
    bf16, each captured as a CUDA graph and timed by events around
    back-to-back replays: the MoE block's routed experts on decode rows (4
    tokens), verify rows (28) and a 256-token chunk, beside the bound of
    reading the banks of the experts this data routes to once; one Gated
    DeltaNet layer over a 256-token chunk and over 4 decode rows."""
    import torch
    from cake_tpu_torch.bench.synth_checkpoint import family_config
    from cake_tpu_torch.bench.timing import issue_ms
    from cake_tpu_torch.models import qwen3_5
    from cake_tpu_torch.models.common.config import config_from_hf_dict
    from cake_tpu_torch.ops import moe
    cfg = config_from_hf_dict(family_config("qwen3_next", 4))
    gen = torch.Generator(device="cuda").manual_seed(2)

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * 0.02).to(torch.bfloat16)
    e, i, h = cfg.num_experts, cfg.moe_intermediate_size, cfg.hidden_size
    k = cfg.num_experts_per_tok
    bank = [normal(e, h), normal(e, i, h), normal(e, i, h), normal(e, h, i)]
    out = {}
    for name, t, route in (("moe.gathered.decode", 4, "gathered"),
                           ("moe.gathered.verify", 28, "gathered"),
                           ("moe.grouped.chunk", 256, "grouped")):
        x = normal(t, h) * 50
        idx = moe.router_topk(x.float() @ bank[0].float().t(), k, True)[1]
        experts = int(torch.unique(idx).numel())
        bound = experts * 3 * i * h * 2 / H100_HBM_BYTES_S * 1e3
        ms = issue_ms(_graphed(lambda x=x, route=route: moe.moe_ffn(
            x, *bank, k, True, route=route)), iters=20)
        out[name] = {"ms": ms, "bound_ms": bound, "experts": experts}
        print(f"module 10 timing {name}: {t} tokens x top {k} of {e} "
              f"experts ({experts} distinct): {ms:.4f} ms; bound (their "
              f"banks read once) {bound:.4f} ms; on {card}", flush=True)
    p = qwen3_5.init_gdn_params(cfg, normal, torch.bfloat16, "cuda")
    for name, b, s in (("gdn.chunk", 1, 256), ("gdn.decode", 4, 1)):
        x = normal(b, s, h) * 50
        lc = qwen3_5.init_linear_cache(cfg, b, torch.bfloat16, "cuda")
        rows = s == 1
        pos = torch.zeros(b, dtype=torch.int32, device="cuda") if rows else 0
        vl = torch.ones(b, dtype=torch.int32, device="cuda") if rows \
            else None
        ms = issue_ms(_graphed(lambda x=x, lc=lc, pos=pos, vl=vl:
                               qwen3_5.gdn_forward(cfg, p, x, lc, pos, vl)),
                      iters=10)
        out[name] = {"ms": ms}
        print(f"module 10 timing {name}: one Gated DeltaNet layer, {b} x "
              f"{s} tokens (Hv 32, Dk = Dv 128): {ms:.4f} ms; on {card}",
              flush=True)
    return out


def phase_qnext_parity() -> dict:
    """13(b). f32 at full width, 2 layers (linear, full; both MoE): a
    600-token prompt in chunks (fresh flash, append flash, masked tail)
    and 16 greedy decode steps, contiguous and paged on the card, against
    the contiguous run on the CPU (the same weights, drawn on the card):
    logits within 2e-3, tokens identical. Returns the f32 launches."""
    import torch
    from cake_tpu_torch.models import TextModel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    gpu = qwen3_next(2, torch.float32, seed=1,
                     layer_types=["linear_attention", "full_attention"])
    cpu = TextModel(gpu.cfg, _to_device(gpu.params, "cpu"),
                    dtype=torch.float32, device="cpu", max_cache_len=4096)
    ids = [int(x) for x in torch.randint(
        0, gpu.cfg.vocab_size, (600,),
        generator=torch.Generator().manual_seed(5))]
    lg, tg, launches = chunked_prefill_and_greedy(gpu, ids)
    lp, tp, paged_launches = paged_prefill_and_greedy(gpu, ids)
    tc0 = time.perf_counter()
    lc, tc, _ = chunked_prefill_and_greedy(cpu, ids)
    cpu_s = time.perf_counter() - tc0
    err = (lg - lc).abs().max().item()
    err_p = (lp - lc).abs().max().item()
    print(f"qwen3-next parity, 2 layers (linear, full), f32, 600-token "
          f"chunked prefill + 16 greedy: flash launches {launches}, paged "
          f"decode launches {paged_launches}; logits max_abs_err contiguous "
          f"{err:.3e}, paged {err_p:.3e} (tol {LOGIT_TOL:g}); tokens "
          f"identical {tg == tc}, {tp == tc}; CPU run {cpu_s:.1f} s, phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(launches == {"bf16": {"fresh": 0, "append": 0},
                       "f16": {"fresh": 0, "append": 0},
                       "f32": {"fresh": 1, "append": 1}},
          f"qwen3-next parity: flash launches {launches}")
    check(paged_launches == {"bf16": 0, "f16": 0, "f32": 15},
          f"qwen3-next parity: paged decode launches {paged_launches}")
    check(err <= LOGIT_TOL and err_p <= LOGIT_TOL,
          f"qwen3-next parity: logits differ by {err}, {err_p}")
    check(tg == tc and tp == tc,
          f"qwen3-next parity: tokens {tg} / {tp} vs {tc}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return {"flash": launches["f32"], "paged": paged_launches["f32"]}


def _linear_state(layers: list, rows: list, row: int) -> list:
    """Row `row` of every linear layer's conv carry and state."""
    return [lc[name][row].float() for lc in layers if "conv" in lc
            for name in ("conv", "state")] + \
        [rl[name][row].float() for rl in rows if "conv" in rl
         for name in ("conv", "state")]


def _wrong_row_equals_plain(model, state) -> tuple[bool, float]:
    """One verify with row 1's drafts all wrong, against the same verify
    with no drafts for row 1 (bit for bit: the plain step inside the
    verify program) and against one decode step (within LINEAR_TOL: other
    GEMM widths): row 1's linear state."""
    import torch
    from cake_tpu_torch.models.common.graphs import SpecCarries
    out = []
    for drafts in ("wrong", "none", "decode"):
        st = state.clone()
        st.activate()
        if drafts == "decode":
            st.step_fn(model)()
        else:
            spec = SpecCarries.build(st.carries, SPEC_K)
            n = [SPEC_K, SPEC_K if drafts == "wrong" else 0, 0, 0]
            spec.load([[7] * SPEC_K] * 4, n)
            if st.paged:
                model.spec_slots_paged_into(st.pool, st.rows, st.tables,
                                            spec, True)
            else:
                model.spec_slots_into(st.layers, spec, True)
            # the wrong row committed one token, as a plain step does
            check(int(spec.packed[1, 1]) == 0, "wrong drafts accepted")
        out.append(_linear_state(st.layers or [], st.rows, 1))
    same = all(torch.equal(a, b) for a, b in zip(out[0], out[1]))
    diff = max((a - b).abs().max().item() for a, b in zip(out[0], out[2]))
    return same, diff


def phase_qnext_graphs(model, card: str) -> None:
    """13(c). bf16 at 4 of 48 layers, 4 slots with ctx 4096, contiguous
    and paged (1024 blocks of 16): 16 decode replays equal 16 eager steps
    (tokens, logits, KV bytes, conv and recurrent state, carries); the
    captured prefill programs equal the eager chunks bit for bit; the
    captured verify (k = 6) equals the eager verify with a row of right
    drafts and a row of wrong ones; after the wrong row, its linear state
    equals a plain step's. Replay device ms beside the eager times."""
    import torch
    from cake_tpu_torch.bench.graph_cases import (build_state,
                                                  graph_vs_eager,
                                                  prefill_vs_eager)
    from cake_tpu_torch.bench.spec_cases import verify_vs_eager
    from cake_tpu_torch.bench.timing import device_ms, kernel_times, wall_ms
    from cake_tpu_torch.ops.sampling import SamplingConfig
    greedy = SamplingConfig(temperature=0.0)
    sampled = SamplingConfig(temperature=0.8, top_k=50)
    gen = torch.Generator().manual_seed(11)
    ids = torch.randint(0, 256, (600,), generator=gen).tolist()
    tenant = torch.randint(0, 256, (300,), generator=gen).tolist()
    for mode, kv_blocks in (("contiguous", 0), ("paged", 1024)):
        state = build_state(model, [600, 1100, None, 300],
                            [greedy, sampled, greedy, greedy], 4096,
                            kv_blocks=kv_blocks, headroom=1024, seed=6)
        r = graph_vs_eager(model, state.clone(), QNEXT_STEPS)
        print(f"qwen3-next graph {mode}: {QNEXT_STEPS} decode replays vs "
              f"eager steps, rows at 600/1100/300 (row 1 sampled) + 1 free: "
              f"tokens identical {r['tokens_equal']}, KV bytes and linear "
              f"state identical {r['kv_equal']}, carries identical "
              f"{r['carries_equal']}; launches per replay "
              f"{r['graph'].launches_per_step}", flush=True)
        check(r["graph"].graph is not None and r["tokens_equal"]
              and r["kv_equal"] and r["carries_equal"],
              f"qwen3-next graph {mode}: replays differ from eager steps")
        graph, eager = r["graph"], r["eager"].step_fn(model)
        replay_ms, replay_wall = device_ms(graph.step), wall_ms(graph.step,
                                                                10)
        eager_wall = wall_ms(eager, 5)
        kernels = sum(row[0] for row in kernel_times(eager, 2, warmup=1))
        print(f"qwen3-next decode step {mode} (4 slots, {QNEXT_LAYERS} "
              f"layers, bf16): replay device ms {replay_ms:.4f}, wall ms "
              f"{replay_wall:.4f}; eager wall ms {eager_wall:.4f}, kernel "
              f"sum {kernels:.4f}; on {card}", flush=True)
        del r, graph, eager
        v = verify_vs_eager(model, state.clone(), SPEC_K, QNEXT_STEPS,
                            ["right", "wrong", "right", None], True)
        print(f"qwen3-next spec graph {mode}: {QNEXT_STEPS} verify replays "
              f"vs eager, k={SPEC_K}, right / wrong / sampled right / free: "
              f"packed ids and logits identical {v['equal']}, KV bytes and "
              f"linear state identical {v['kv_equal']}, carries identical "
              f"{v['carries_equal']}; accepted per row {v['accepted']}",
              flush=True)
        check(v["graph"].graph is not None and v["equal"] and v["kv_equal"]
              and v["carries_equal"],
              f"qwen3-next spec graph {mode}: replays differ from eager")
        check(v["accepted"][0] > 0 and v["accepted"][1] == 0,
              f"qwen3-next spec graph {mode}: accepted {v['accepted']}")
        verify_ms = device_ms(v["graph"].step, iters=10)
        verify_wall = wall_ms(v["graph"].step, 5)
        eager_verify = wall_ms(v["eager_fn"], 3)
        print(f"qwen3-next verify step {mode}: replay device ms "
              f"{verify_ms:.4f}, wall ms {verify_wall:.4f}; eager wall ms "
              f"{eager_verify:.4f}; on {card}", flush=True)
        del v
        same, diff = _wrong_row_equals_plain(model, state)
        print(f"qwen3-next {mode}: after a verify of wrong drafts, the row's "
              f"conv and recurrent state equal the no-draft verify's "
              f"{same}, and differ from a decode step's by {diff:.3e} (tol "
              f"{LINEAR_TOL:g}: other GEMM widths)", flush=True)
        check(same and diff <= LINEAR_TOL,
              f"qwen3-next {mode}: linear state after wrong drafts {same}, "
              f"{diff}")
        del state
        torch.cuda.empty_cache()
        case = prefill_vs_eager(model, ids, slot=2, slots=4, ctx=4096,
                                kv_blocks=kv_blocks, strict=True,
                                tenant=tenant)
        print(f"qwen3-next prefill graphs {mode}: "
              f"{len(case.graphs.graphs)} programs captured in "
              f"{case.capture_s:.2f} s (sync debug 'error'); chunks "
              f"{[x['key'] for x in case.results]} logits identical "
              f"{[x['logits_equal'] for x in case.results]}, KV bytes and "
              f"linear state identical {case.kv_equal}", flush=True)
        check(all(x["logits_equal"] for x in case.results) and case.kv_equal,
              f"qwen3-next prefill graphs {mode}: replays differ")
        for i, x in enumerate(case.results):
            g, e = case.graph_chunk(i), case.eager_chunk(i)
            print(f"qwen3-next prefill chunk {mode} {x['key']} "
                  f"({len(case.chunks[i][1])} tokens): replay device ms "
                  f"{device_ms(g, iters=5, warmup=1):.4f}, wall ms "
                  f"{wall_ms(g, 5):.4f}; eager wall ms {wall_ms(e, 3):.4f}; "
                  f"on {card}", flush=True)
        del case
        torch.cuda.empty_cache()


def _resumed(model, prompt: list, tokens: list, preempted_at: list) -> list:
    """A greedy stream as recompute preemption resumes it, from the roomy
    pool's `tokens`: at each preemption after k tokens, prompt +
    tokens[:k-1] prefilled in 256-token chunks into a row of a 4-row
    paged pool and decode steps from tokens[k-1] on (the engine's replay:
    the recomputed state comes from prefill chunks, not from the decode
    steps that first built it, so in bf16 it differs in its last bits and
    a flat random model's stream may part after the resume)."""
    from cake_tpu_torch.models.common.graphs import DecodeCarries
    from cake_tpu_torch.serve.engine import RECENT_N
    from cake_tpu_torch.serve.paged import PagedKV
    n = len(tokens)
    for k in preempted_at:
        if k == 0 or k >= n:
            continue                    # a restart, or nothing left
        ids = prompt + tokens[:k - 1]
        pk = PagedKV.build(model, 4, 4096, 1024, 16, 256)
        check(pk.reserve_range(1, 0, len(ids) + n), "resume reference pool")
        for p0 in range(0, len(ids), 256):
            pk.prefill_into(1, ids[p0:p0 + 256], p0)
        c = DecodeCarries.build(4, model.cfg.vocab_size, RECENT_N,
                                model.device)
        c.toks[1] = tokens[k - 1]
        c.pos[1] = len(ids)
        c.active[1] = True
        out = tokens[:k]
        while len(out) < n:
            model.decode_slots_paged_into(pk.pool, pk.rows, pk.tables, c)
            out.append(int(c.toks[1]))
        tokens = out
        del pk
    return tokens


class Oracle:
    """Proposes each prompt's plain greedy continuation: every draft
    accepted, so every verify commits several tokens (the linear state
    after the accepted ones). Stateless, so the engine's slots share it."""
    name = "oracle"
    shareable = True

    def __init__(self, prompts: list, streams: list):
        self.streams = {tuple(p): s for p, s in zip(prompts, streams)}

    def propose(self, ids, k):
        for prompt, stream in self.streams.items():
            if tuple(ids[:len(prompt)]) == prompt:
                n = len(ids) - len(prompt)
                return list(stream[n:n + k])
        return []

    def reset(self):
        pass


def _shared_run(served, during=None) -> list:
    """Phase 6(b)'s traffic: the first shared-system chat alone, then
    three more at once."""
    bodies = [chat_body(i, shared=True) for i in range(4)]
    first = served.chat(bodies[0])
    check(first["status"] == 200, "a shared-prefix chat failed")
    return [first] + served.concurrent(bodies[1:], during)


def _with_env(env: dict, build):
    """build() with the environment variables `env` set, then restored."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return build()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_qnext_serve(model, card: str) -> dict:
    """13(d). The same model over HTTP, contiguous then paged (1024 blocks
    of 16): 4 concurrent chats and one SSE chat, all 200 and each equal
    alone; phase 6(b)'s shared system message hitting the prefix cache
    with tokens equal to the cache off; phase 6(c)'s 96-block pool under
    swap and recompute with tokens equal to the roomy pool's; and under
    CAKE_SPEC=ngram the greedy text of phase 12's chats equal to
    speculation off (a parting only at a near tie). Every decode step,
    chunk and verify is a graph replay. Returns the launches of every
    kernel while serving."""
    import torch
    from cake_tpu_torch.bench.spec_cases import plain_stream
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops import paged_attention as pa
    full = sum(s.kind == "full" for s in model.cfg.layer_specs())
    bodies = [chat_body(i) for i in range(4)] + [chat_body(4, True)]
    launches = {}
    for mode, kw in (("contiguous", {}),
                     ("paged", dict(kv_blocks=1024, kv_block_tokens=16))):
        served = serve_model(model, **kw)
        try:
            eng = served.engine
            check(eng.graph.graph is not None and all(
                g.graph is not None for g in eng.prefill.graphs.values()),
                f"qwen3-next serve {mode}: graphs not captured")
            torch.cuda.synchronize()
            flash.reset_launches()
            pa.reset_launches()
            steps = eng.graph.steps
            results = served.concurrent(bodies)
            torch.cuda.synchronize()
            steps = eng.graph.steps - steps
            fl, pg = flash.launch_counts(), pa.launch_counts()
            _check_chats(results, f"qwen3-next {mode}")
            check(fl["bf16"]["fresh"] >= full * 4 and fl["bf16"]["append"] > 0
                  and sum(fl["f32"].values()) == 0,
                  f"qwen3-next serve {mode}: flash launches {fl}")
            if kw:
                check(pg == {"bf16": full * steps, "f16": 0, "f32": 0}
                      and steps,
                      f"qwen3-next paged: decode launches {pg} != {full} x "
                      f"{steps}")
                launches["paged"] = pg["bf16"]
            else:
                launches.update(fresh=fl["bf16"]["fresh"],
                                append=fl["bf16"]["append"])
            _alone_equals_concurrent(served, bodies, results,
                                     f"qwen3-next {mode}")
            ttft, tps = _latency(results[:4])
            print(f"qwen3-next serve {mode}: engine start capture "
                  f"{eng.capture_s:.2f} s ({len(eng.prefill.graphs)} prefill "
                  f"programs + the decode step); 4 concurrent chats + 1 SSE, "
                  f"{results[0]['resp']['usage']['prompt_tokens']}-token "
                  f"prompts, all 200, each equal alone; flash {fl}, paged "
                  f"decode {pg} over {steps} replays; TTFT p50 {ttft:.1f} ms, "
                  f"decode tok/s per request p50 {tps:.1f} (smoke); on "
                  f"{card}", flush=True)
            # the pressure runs' reference: the roomy paged pool's tokens
            want = [r["tokens"] for r in results[:4]]
            shared = _shared_run(served)
        finally:
            served.close()
        off = serve_model(model, prefix_cache_mb=0, **kw)
        try:
            shared_off = _shared_run(off)
        finally:
            off.close()
        hits = [r["stats"]["prefix_hit_tokens"] for r in shared]
        same = [r["tokens"] for r in shared] == \
            [r["tokens"] for r in shared_off]
        print(f"qwen3-next prefix {mode}: shared system message, "
              f"prefix_hit_tokens {hits}; tokens equal to the cache-off run "
              f"{same}", flush=True)
        check(all(h >= 512 for h in hits[1:]) and same,
              f"qwen3-next prefix {mode}: hits {hits}, same {same}")
    for mode in ("swap", "recompute"):
        _pressure(model, mode, want, lambda prompt, toks, at: _resumed(
            model, prompt, toks, at))
    spec_bodies = [spec_body(i) for i in range(4)]
    prompts = [model.tokenizer.chat_prompt_ids(b["messages"])
               for b in spec_bodies]
    for mode, kw in (("contiguous", {}),
                     ("paged", dict(kv_blocks=1024, kv_block_tokens=16))):
        plain = plain_stream(model, prompts, SPEC_TOKENS, 4096,
                             kv_blocks=kw.get("kv_blocks", 0))
        oracle = Oracle(prompts, [p["tokens"] for p in plain])
        for label, build in (
                ("oracle", lambda: serve_model(model, prefix_cache_mb=0,
                                               spec=oracle, spec_k=SPEC_K,
                                               **kw)),
                ("CAKE_SPEC=ngram", lambda: _with_env(
                    {"CAKE_SPEC": "ngram"},
                    lambda: serve_model(model, prefix_cache_mb=0, **kw)))):
            on = build()
            try:
                eng = on.engine
                check(eng.spec_drafter is not None and all(
                    g.graph is not None for g in eng.verify_graphs.values()),
                    f"qwen3-next spec {mode} {label}: no captured verify")
                torch.cuda.synchronize()
                pa.reset_launches()
                on_res = on.concurrent(spec_bodies)
                torch.cuda.synchronize()
                h = eng.health()["spec"]
                vc = pa.verify_launch_counts()
                # in bf16 a verify row's logits part from the decode
                # step's on the same prefix by more than the near tie
                # (`--only 13d` measures it): the oracle's partings are
                # reported, and `_qnext_oracle_f32` holds its tokens to
                # the plain stream
                parts = [_first_parting(r["tokens"], p["tokens"], p["gaps"])
                         if label == "oracle" else
                         _parting(r["tokens"], p["tokens"], p["gaps"],
                                  f"qwen3-next spec {mode} {label} chat {i}")
                         for i, (r, p) in enumerate(zip(on_res, plain))]
                if label == "oracle":
                    check(h["accepted"] > 0 and h["verify_replays"] > 0,
                          f"qwen3-next spec {mode}: {h}")
                    if kw:
                        check(vc["bf16"] == full * h["verify_replays"],
                              f"qwen3-next spec paged: verify launches {vc}"
                              f" != {full} x {h['verify_replays']}")
                        launches["verify"] = vc["bf16"]
                print(f"qwen3-next spec {mode}, {label} drafter (k "
                      f"{eng.spec_k}): {h}; verify launches {vc}; greedy "
                      f"tokens equal to speculation off (the plain stream) "
                      f"per chat {[not p for p in parts]}, partings "
                      f"(position, spec-off top-2 gap) {parts}"
                      + (" (bf16: reported, not checked)" if label ==
                         "oracle" else "") + f"; on {card}", flush=True)
            finally:
                on.close()
    return launches


def _oracle_schedule(model, prompts: list, plain: list, schedule: list,
                     **kw) -> dict:
    """The oracle drafter (k 6) over `prompts` through one engine (4 slots,
    ctx 4096, prefix cache off, `kw`), greedy, SPEC_TOKENS each, chat i
    submitted just before the scheduler's worked iteration schedule[i],
    or once every chat submitted before it is done (on the scheduler's
    own thread, so that the order of arrivals is fixed). Returns {tokens,
    parts (against the plain stream), spec (the engine's counts), log:
    per worked iteration {chat: (slot, tokens so far)} before it, and,
    when the plain stream kept its logits, deltas: over every verify row
    whose prefix equals the plain stream's, the largest |logit|
    difference from the plain decode step's logits at that position, the
    largest difference of the plain top-2 tokens' gap, and the number of
    positions compared}."""
    import torch
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve import ServeEngine
    greedy = SamplingConfig(temperature=0.0)
    eng = ServeEngine(model, slots=4, ctx_len=4096, prefix_cache_mb=0,
                      spec=Oracle(prompts, [p["tokens"] for p in plain]),
                      spec_k=SPEC_K, **kw)
    reqs = [None] * len(prompts)
    log = []
    real = eng._step
    keep = "logits" in plain[0]
    deltas = {"logit": 0.0, "gap": 0.0, "positions": 0}

    def compare(before: dict) -> None:
        """The last verify's rows against the plain stream's logits."""
        for i, (slot, m, pending, prefilling) in before.items():
            want = plain[i]
            m += pending
            n = int(eng.spec.n_drafts[slot])
            drafts = eng.spec.drafts[slot, :n].tolist()
            if slot is None or prefilling \
                    or reqs[i].tokens[:m] != want["tokens"][:m]:
                continue
            for j in range(n + 1):
                if m + j >= len(want["tokens"]) or \
                        drafts[:j] != want["tokens"][m:m + j]:
                    break
                got, ref = eng.spec.logits[slot, j], want["logits"][m + j]
                a, b = torch.topk(ref, 2).indices.tolist()
                deltas["logit"] = max(deltas["logit"],
                                      (got - ref).abs().max().item())
                deltas["gap"] = max(deltas["gap"], abs(
                    (ref[a] - ref[b]).item() - (got[a] - got[b]).item()))
                deltas["positions"] += 1

    def step():
        idle = all(r is None or r.done.is_set() for r in reqs)
        for i, at in enumerate(schedule):
            if reqs[i] is None and (at <= len(log) or idle):
                reqs[i] = eng.submit(prompts[i], SPEC_TOKENS, greedy)
        prefilling = {p.slot for p in eng._prefills}
        before = {i: (r.slot, len(r.tokens), int(r._first_pending),
                      r.slot in prefilling)
                  for i, r in enumerate(reqs)
                  if r is not None and not r.done.is_set()}
        verifies = eng.verify_graphs[False].steps
        worked = real()
        if worked:
            log.append({i: v[:2] for i, v in before.items()})
            if keep and eng.verify_graphs[False].steps > verifies:
                compare(before)
        return worked
    try:
        eng._step = step
        eng._wake.set()
        t0 = time.perf_counter()
        while not all(r is not None and r.done.is_set() for r in reqs):
            check(time.perf_counter() - t0 < 300 and eng.dead is None,
                  f"oracle schedule {schedule}: the chats did not finish "
                  f"({eng.dead})")
            time.sleep(0.01)
        spec = eng.health()["spec"]
    finally:
        eng.close()
    for r in reqs:
        check("error" not in r.result, f"oracle schedule {schedule}: "
              f"{r.result.get('error')}")
    tokens = [list(r.tokens) for r in reqs]
    return {"tokens": tokens, "spec": spec, "log": log,
            "parts": [_first_parting(t, p["tokens"], p["gaps"])
                      for t, p in zip(tokens, plain)],
            **({"deltas": deltas} if keep else {})}


def _parting_step(run: dict, chat: int) -> str:
    """The worked iteration whose verify gave chat `chat` its first parted
    token, with every chat's (slot, tokens so far) before it."""
    j = run["parts"][chat][0][0]
    last = max((it for it, before in enumerate(run["log"])
                if chat in before and before[chat][1] <= j), default=None)
    return ("not found" if last is None else
            f"iteration {last}, (slot, tokens so far) per chat "
            f"{run['log'][last]}")


def _deltas(run: dict) -> str:
    d = run["deltas"]
    return (f"max |logit diff| {d['logit']:.4g}, max top-2 gap diff "
            f"{d['gap']:.4g} over {d['positions']} positions")


ORACLE_SCHEDULES = (("together", (0, 0, 0, 0)),
                    ("chat 0 first", (0, 7, 7, 7)),
                    ("chat 0 last", (7, 0, 0, 0)))


def qnext_oracle_arrivals(card: str) -> None:
    """`--only 13d`: phase 13(d)'s bf16 oracle chats (4 layers, seed 0,
    contiguous) with the order of arrivals fixed: all together (twice),
    chat 0 seven iterations before the others, and after them; then chat
    0 alone. Prints each run's partings from the plain stream and the
    iteration that parted chat 0. A diagnosis: it checks only that every
    chat finished."""
    import torch
    from cake_tpu_torch.bench.spec_cases import plain_stream
    model = qwen3_next(QNEXT_LAYERS, torch.bfloat16, seed=0)
    prompts = [model.tokenizer.chat_prompt_ids(spec_body(i)["messages"])
               for i in range(4)]
    plain = plain_stream(model, prompts, SPEC_TOKENS, 4096,
                         keep_logits=True)
    print(f"oracle arrivals: plain stream top-2 gaps of chat 0, tokens "
          f"0-23: {[round(g, 4) for g in plain[0]['gaps'][:24]]}",
          flush=True)
    for name, schedule in ORACLE_SCHEDULES[:1] + ORACLE_SCHEDULES:
        r = _oracle_schedule(model, prompts, plain, list(schedule))
        print(f"oracle arrivals, bf16, {name} {schedule}: spec "
              f"{r['spec']}; partings (position, plain top-2 gap) "
              f"{r['parts']}; verify rows on the plain prefix against the "
              f"plain decode step {_deltas(r)}; chat 0 parted at "
              + (_parting_step(r, 0) if r["parts"][0] else "no token")
              + f"; on {card}", flush=True)
    alone = _oracle_schedule(model, prompts[:1], plain[:1], [0])
    print(f"oracle arrivals, bf16, chat 0 alone: spec {alone['spec']}; "
          f"parting {alone['parts']}; {_deltas(alone)}; at "
          + (_parting_step(alone, 0) if alone["parts"][0] else "no token")
          + f"; on {card}", flush=True)
    del model
    torch.cuda.empty_cache()


def _qnext_oracle_f32(card: str) -> None:
    """13(d) in float32: 2 layers (linear, full; both MoE) at Qwen3-Next's
    widths, phase 12's 4 chats with the oracle drafter, contiguous with
    the chats arriving together, paged (1024 blocks of 16) with chat 0
    seven iterations first: greedy tokens equal to the plain stream up to
    a near tie, the drafts accepted. In bf16 (13(d) above) a verify row's
    top-2 gap differs from the decode step's on the same prefix by more
    than the near tie (`--only 13d`), so the token check is held here."""
    import torch
    from cake_tpu_torch.bench.spec_cases import plain_stream
    t0 = time.perf_counter()
    model = qwen3_next(2, torch.float32, seed=0,
                       layer_types=["linear_attention", "full_attention"])
    prompts = [model.tokenizer.chat_prompt_ids(spec_body(i)["messages"])
               for i in range(4)]
    for mode, kw, (name, schedule) in (
            ("contiguous", {}, ORACLE_SCHEDULES[0]),
            ("paged", dict(kv_blocks=1024, kv_block_tokens=16),
             ORACLE_SCHEDULES[1])):
        plain = plain_stream(model, prompts, SPEC_TOKENS, 4096,
                             kv_blocks=kw.get("kv_blocks", 0),
                             keep_logits=True)
        r = _oracle_schedule(model, prompts, plain, list(schedule), **kw)
        label = f"qwen3-next spec f32 {mode} oracle {name}"
        parts = [_parting(t, p["tokens"], p["gaps"], f"{label} chat {i}")
                 for i, (t, p) in enumerate(zip(r["tokens"], plain))]
        print(f"{label} {schedule}: spec {r['spec']}; greedy tokens equal "
              f"to the plain stream per chat {[not p for p in parts]}, "
              f"partings at near ties {parts}; verify rows against the "
              f"plain decode step {_deltas(r)}; on {card}", flush=True)
        check(r["spec"]["accepted"] > 0, f"{label}: {r['spec']}")
    del model
    torch.cuda.empty_cache()
    print(f"qwen3-next spec f32 in {time.perf_counter() - t0:.0f} s",
          flush=True)


def phase_qnext_checkpoint(card: str, workdir: str) -> str:
    """13(e). 4 layers (3 linear, 1 full; HF names: in_proj_qkvz /
    in_proj_ba, experts.{e}.*, shared_expert, (1+w) norms stored as w)
    written as a checkpoint directory with a byte-level BPE tokenizer,
    loaded through build_text_model bit for bit, then served through `cli
    serve DIR`: 4 concurrent chats and one SSE chat, all 200, each equal
    alone and in company. Returns the directory, which phase 15 reads
    and deletes."""
    import torch
    from cake_tpu_torch.runtime import build_text_model
    d, params, nbytes = _write_qnext_dir(workdir, QNEXT_CKPT_LAYERS)
    names = json.load(open(os.path.join(d, "model.safetensors.index.json")))
    names = " ".join(names["weight_map"])
    check("linear_attn.in_proj_qkvz" in names and "experts.511.down_proj"
          in names and "shared_expert_gate" in names,
          "qwen3-next checkpoint: HF names missing")
    torch.cuda.synchronize()
    t = time.perf_counter()
    loaded, _, _ = build_text_model(d, "bf16", device="cuda",
                                    max_cache_len=4096)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    diff = _tree_diff(loaded.params, params)
    print(f"qwen3-next checkpoint load: {load_s:.1f} s "
          f"({nbytes / 1e9 / load_s:.2f} GB/s) through build_text_model; "
          f"every tensor bit-identical {not diff}; on {card}", flush=True)
    check(not diff, f"qwen3-next checkpoint: loaded params differ {diff[:5]}")
    del loaded, params
    torch.cuda.empty_cache()
    bodies = [chat_body(i) for i in range(4)] + [chat_body(4, True)]
    served = _cli_server(d)
    try:
        results = served.concurrent(bodies)
        _check_chats_any(results, "qwen3-next cli serve")
        _prompt_ids_match(served, d, bodies, "qwen3-next cli serve")
        _alone_equals_concurrent(served, bodies, results,
                                 "qwen3-next cli serve")
        print(f"qwen3-next cli serve DIR: 4 concurrent chats + 1 SSE, all "
              f"200, each equal alone and in company", flush=True)
    finally:
        served.close()
    return d


def phase_qnext(card: str, workdir: str) -> dict:
    """Phase 13: Qwen3-Next at Qwen3-Next-80B-A3B's widths. Returns the
    kernel timings and the main path's launches."""
    import torch
    t0 = time.perf_counter()
    timings = phase_qnext_kernels(card)
    f32 = phase_qnext_parity()
    t = time.perf_counter()
    model = qwen3_next(QNEXT_LAYERS, torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    print(f"qwen3-next: {QNEXT_LAYERS} of 48 layers (full at 3; all MoE, "
          f"512 experts top 10 + shared), bf16, built on the card in "
          f"{time.perf_counter() - t:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB", flush=True)
    phase_qnext_graphs(model, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches = phase_qnext_serve(model, card)
    del model
    torch.cuda.empty_cache()
    _qnext_oracle_f32(card)
    ckpt = phase_qnext_checkpoint(card, workdir)
    print(f"phase 13 in {time.perf_counter() - t0:.0f} s", flush=True)
    return {"timings": timings, "launches": launches, "f32": f32,
            "checkpoint": ckpt}


def qnext_kernel_rows(q: dict) -> list:
    """The kernels line's rows of phase 13 (Qwen3-Next's heads)."""
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops import paged_attention as pa
    t, n = q["timings"], q["launches"]
    rows = []
    for entry, route, launches in (
            ("fresh", "bf16", n["fresh"]), ("append", "bf16", n["append"]),
            ("f32", "f32", q["f32"]["flash"]["fresh"]),
            ("f32_append", "f32", q["f32"]["flash"]["append"])):
        x = t[f"flash.{entry}"]
        rows.append({
            "name": f"flash_attention.{entry}.qwen3_next", "route": "cuda",
            "source": flash.SOURCES[route], "replaces": flash.REPLACES,
            "launches": launches, "max_abs_err": x["max_abs_err"],
            "ms": x["ms"], "meta_ms": x["meta_ms"],
            "issue_ms": x["issue_ms"], "plain_ms": x["plain_ms"],
            "bound_ms": x["bound_ms"], "bound_by": x["bound_by"],
            "library_ms": x["library_ms"]})
    for name, entry, launches, replaces in (
            ("bf16.qwen3_next", "decode.bf16", n["paged"], pa.REPLACES),
            ("f32.qwen3_next", "decode.f32", q["f32"]["paged"], pa.REPLACES),
            ("verify.bf16.qwen3_next", "verify.bf16", n["verify"],
             pa.VERIFY_REPLACES)):
        x = t[entry]
        rows.append({
            "name": f"paged_decode_attention.{name}", "route": "cuda",
            "source": pa.SOURCE, "replaces": replaces, "launches": launches,
            "max_abs_err": x["max_abs_err"], "ms": x["ms"],
            "issue_ms": x["issue_ms"], "plain_ms": x["plain_ms"],
            "bound_ms": x.get("unique_ms", x.get("bound_ms")),
            "bound_by": x["bound_by"], "library_ms": x["library_ms"]})
    return rows


# -- phase 14: quantized checkpoints (FP8, AutoGPTQ, GGUF) -------------------

FP8_TIMED = ("q_proj_0.6b", "gate_proj_8b", "down_proj_8b")
Q8B_HEADS = dict(hq=32, hkv=8, d=128)     # Qwen3-8B's attention
FP8_STEPS = 16          # decode replays against eager steps, the flagship
Q8B_STEPS = 8           # and Qwen3-8B's widths at Q8B_LAYERS layers
Q8B_LAYERS = 12         # of 36 (cut from 36 for the whole run's time)
FP8_FLAGSHIP_LAYERS = 4     # 14(b)'s bf16 flagship in the FP8 layout, of
                            # 28 (cut from 8 for the whole run's time)
QUANT_LAYERS = 4        # the GPTQ and GGUF flagships' depth, of 28 (cut
                        # for the whole run's time)


def phase_fp8_kernel(card: str, dtypes=None, timed=None) -> dict:
    """14(a). The dequant kernel against its plain version at every shape
    of bench/fp8_cases.SHAPES, bf16 and f32 (or `dtypes`), launched twice,
    bit for bit (NaN at the same places); timed at FP8_TIMED (or `timed`)
    beside the plain version and the bound. Returns {"shape.route":
    {...}}."""
    import torch
    from cake_tpu_torch.bench.fp8_cases import (SHAPES, dequant_bound_ms,
                                                dequant_bytes, fp8_case,
                                                same_bits)
    from cake_tpu_torch.bench.timing import device_ms
    from cake_tpu_torch.ops import fp8
    out = {}
    dtypes = dtypes or (torch.bfloat16, torch.float32)
    timed = FP8_TIMED if timed is None else timed
    for name, o, i in SHAPES:
        w, s = fp8_case(o, i, seed=o + i)
        for dt in dtypes:
            route = fp8.ROUTES[dt]
            first = fp8.dequant_fp8_blockwise_kernel(w, s, dt)
            second = fp8.dequant_fp8_blockwise_kernel(w, s, dt)
            plain = fp8.dequant_fp8_blockwise_plain(w, s, dt)
            torch.cuda.synchronize()
            nan = torch.isnan(plain)
            err = (first.float() - plain.float())[~nan].abs().max().item() \
                if (~nan).any() else 0.0
            same = same_bits(first, plain)
            twice = torch.equal(first.view(torch.uint8),
                                second.view(torch.uint8))
            entry = {"max_abs_err": err, "nan": int(nan.sum())}
            line = (f"fp8 dequant {name} [{o}, {i}] -> {route}: kernel == "
                    f"plain bit for bit {same} (max_abs_err {err:.1e}, "
                    f"{entry['nan']} NaN at the same places), launched "
                    f"twice identical {twice}")
            if name in timed:
                entry.update(
                    ms=device_ms(lambda: fp8.dequant_fp8_blockwise_kernel(
                        w, s, dt)),
                    plain_ms=device_ms(
                        lambda: fp8.dequant_fp8_blockwise_plain(w, s, dt),
                        iters=10),
                    bound_ms=dequant_bound_ms(o, i, dt), bound_by="bytes")
                line += (f"; device ms {entry['ms']:.5f} "
                         f"({dequant_bytes(o, i, dt) / entry['ms'] / 1e9:.3f}"
                         f" TB/s), plain {entry['plain_ms']:.5f}, bound "
                         f"{entry['bound_ms']:.5f} (bytes); on {card}")
            print(line, flush=True)
            check(same and twice, f"fp8 dequant {name} {route}: kernel "
                  f"differs from plain ({same}) or from itself ({twice})")
            out[f"{name}.{route}"] = entry
        del w, s
    return out


def _load_measured(d: str, nbytes: int, label: str, card: str,
                   dtype: str = "bf16", **kw):
    """build_text_model on the card, printing the load's seconds, GB/s of
    checkpoint bytes and the device memory it took. Returns (model,
    {seconds, gb_s, memory_gb})."""
    import torch
    from cake_tpu_torch.runtime import build_text_model
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    model, _, _ = build_text_model(d, dtype, device="cuda",
                                   max_cache_len=4096, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    mem = (torch.cuda.memory_allocated() - before) / 1e9
    print(f"{label}: {nbytes / 1e9:.3f} GB of checkpoint loaded through "
          f"build_text_model in {secs:.2f} s = {nbytes / 1e9 / secs:.2f} "
          f"GB/s (page cache warm); torch.cuda.memory_allocated() rose by "
          f"{mem:.3f} GB to {torch.cuda.memory_allocated() / 1e9:.3f} GB; "
          f"on {card}", flush=True)
    return model, {"seconds": secs, "gb_s": nbytes / 1e9 / secs,
                   "memory_gb": mem}


def _native_projections(model) -> bool:
    """Every attention and MLP projection a float8_e4m3fn pair."""
    import torch
    from cake_tpu_torch.ops.fp8 import is_fp8
    ws = [layer[blk][p]["weight"] for layer in model.params["layers"]
          for blk, projs in (("self_attn", ("q_proj", "k_proj", "v_proj",
                                            "o_proj")),
                             ("mlp", ("gate_proj", "up_proj", "down_proj")))
          for p in projs]
    return all(is_fp8(w) and w["fp8"].dtype == torch.float8_e4m3fn
               for w in ws)


def _replay_ms(model, kv_blocks: int, steps: int, label: str) -> float:
    """Capture the decode step over 4 slots (rows at 600 / 1100 / 300 and
    one free), hold `steps` replays against eager steps, and return the
    replay's device ms."""
    from cake_tpu_torch.bench.graph_cases import build_state, graph_vs_eager
    from cake_tpu_torch.bench.timing import device_ms
    from cake_tpu_torch.ops.sampling import SamplingConfig
    greedy = SamplingConfig(temperature=0.0)
    sampled = SamplingConfig(temperature=0.8, top_k=50)
    state = build_state(model, [600, 1100, None, 300],
                        [greedy, sampled, greedy, greedy], 4096,
                        kv_blocks=kv_blocks, seed=6)
    r = graph_vs_eager(model, state, steps)
    check(r["graph"].graph is not None and r["tokens_equal"]
          and r["kv_equal"] and r["carries_equal"],
          f"{label}: {steps} decode replays differ from eager steps")
    ms = device_ms(r["graph"].step, iters=10)
    print(f"{label}: {steps} decode replays == eager steps (tokens, KV "
          f"bytes, carries); replay device ms {ms:.4f}", flush=True)
    return ms


def _serve_dir(d: str, label: str, extra=(), cpu_params=None,
               alone: bool = True, stream: bool = True) -> list:
    """`cli serve d` (4 slots, ctx 4096) with `extra` flags: the loaded
    parameters equal `cpu_params` bit for bit when given; phase 5's 4
    concurrent chats (and one SSE chat), all 200, each equal alone.
    Returns the concurrent chats' tokens."""
    bodies = [chat_body(i) for i in range(4)] + (
        [chat_body(4, True)] if stream else [])
    served = _cli_server(d, *extra)
    try:
        if cpu_params is not None:
            diff = _tree_diff(served.app.state.model.params, cpu_params)
            check(not diff, f"{label}: card parameters differ from the "
                  f"CPU load's: {diff[:5]}")
        results = served.concurrent(bodies)
        _check_chats_any(results, label)
        if alone:
            _alone_equals_concurrent(served, bodies, results, label)
        first = results[0]["resp"]
        print(f"{label}: {len(bodies) - stream} concurrent chats"
              f"{' + 1 SSE' if stream else ''}, all 200, "
              f"{first['usage']['prompt_tokens']}-token prompts"
              f"{', each equal alone' if alone else ''}"
              f"{', parameters equal the CPU load bit for bit' if cpu_params is not None else ''}",
              flush=True)
        return [r["tokens"] for r in results]
    finally:
        served.close()


def phase_fp8_flagship(card: str, workdir: str) -> dict:
    """14(b). The flagship as a Qwen3-0.6B-FP8-layout checkpoint. Returns
    {"f32": launches of the f32 parity run, "bf16": launches of the
    native servers, memory and replay readings}."""
    import torch
    from cake_tpu_torch.bench import synth_checkpoint as sc
    from cake_tpu_torch.bench.graph_cases import build_state, prefill_vs_eager
    from cake_tpu_torch.bench.spec_cases import verify_vs_eager
    from cake_tpu_torch.ops import fp8
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.runtime import build_text_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    # f32 at 2 layers: the card against the CPU, contiguous and paged
    d2 = os.path.join(workdir, "qwen3-0.6b-fp8-2")
    cfg2 = sc.flagship_config(layers=2)
    sc.write_fp8_model(d2, cfg2, sc.model_params(cfg2, seed=1))
    cpu, _, _ = build_text_model(d2, "f32", device="cpu", fp8_native=True)
    gpu, _, _ = build_text_model(d2, "f32", device="cuda", fp8_native=True)
    ids = [int(x) for x in torch.randint(
        0, cfg2["vocab_size"], (600,),
        generator=torch.Generator().manual_seed(5))]
    fp8.reset_launches()
    lg, tg, _ = chunked_prefill_and_greedy(gpu, ids)
    lp, tp, _ = paged_prefill_and_greedy(gpu, ids)
    out["f32"] = fp8.launch_counts()["f32"]
    lc, tc, _ = chunked_prefill_and_greedy(cpu, ids)
    err, err_p = ((x - lc).abs().max().item() for x in (lg, lp))
    print(f"fp8 flagship width, 2 layers, f32, native: 600-token chunked "
          f"prefill + 16 greedy, card vs CPU: logits max_abs_err {err:.3e} "
          f"contiguous, {err_p:.3e} paged (tol {LOGIT_TOL:g}); tokens "
          f"identical {tg == tc} / {tp == tc}; f32 dequant launches "
          f"{out['f32']}", flush=True)
    check(err <= LOGIT_TOL and err_p <= LOGIT_TOL and tg == tc and tp == tc,
          f"fp8 f32 parity: {err} / {err_p}, tokens {tg == tc} {tp == tc}")
    check(out["f32"] > 0, "fp8 f32 parity: the dequant kernel never ran")
    del cpu, gpu
    shutil.rmtree(d2, ignore_errors=True)
    # the full flagship, bf16: at load and native
    d = os.path.join(workdir, "qwen3-0.6b-fp8")
    config = sc.flagship_config(FP8_FLAGSHIP_LAYERS)
    t = time.perf_counter()
    nbytes = sc.write_fp8_model(d, config, sc.model_params(config, seed=0),
                                shards=2)
    sc.write_tokenizer(d, sc.QWEN3_SPECIALS)
    print(f"fp8 flagship: {config['num_hidden_layers']} layers written in "
          f"Qwen's FP8 layout ({nbytes / 1e9:.3f} GB) in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    at_load, out["at_load"] = _load_measured(d, nbytes, "fp8 flagship at "
                                             "load", card)
    native, out["native"] = _load_measured(d, nbytes, "fp8 flagship native",
                                           card, fp8_native=True)
    check(_native_projections(native), "fp8 flagship: a projection of the "
          "native tree is not float8_e4m3fn")
    ids = ids[:300]
    la, _ = at_load.prefill(at_load.new_cache(), ids)
    ln, _ = native.prefill(native.new_cache(), ids)
    ta, tn = at_load.generate(ids, 16)[0], native.generate(ids, 16)[0]
    diff = (la - ln).abs().max().item()
    print(f"fp8 flagship bf16: native logits == at-load logits bit for bit "
          f"{torch.equal(la, ln)} (max diff {diff:.3e}), 16 greedy tokens "
          f"identical {ta == tn}", flush=True)
    check(diff <= BF16_TOL and ta == tn, "fp8 flagship: native differs "
          f"from at load by {diff}, tokens {ta == tn}")
    greedy = SamplingConfig(temperature=0.0)
    sampled = SamplingConfig(temperature=0.8, top_k=50)
    gen = torch.Generator().manual_seed(11)
    pids = torch.randint(0, 256, (600,), generator=gen).tolist()
    tenant = torch.randint(0, 256, (300,), generator=gen).tolist()
    for mode, kv in (("contiguous", 0), ("paged", 1024)):
        ms = {name: _replay_ms(m, kv, FP8_STEPS,
                               f"fp8 flagship {name} graph {mode}")
              for name, m in (("native", native), ("at_load", at_load))}
        out[f"replay_ms_{mode}"] = ms
        print(f"fp8 flagship decode replay {mode} (4 slots, "
              f"{FP8_FLAGSHIP_LAYERS} layers, "
              f"bf16): device ms native {ms['native']:.4f}, at load "
              f"{ms['at_load']:.4f} (x{ms['native'] / ms['at_load']:.2f}); "
              f"on {card}", flush=True)
        case = prefill_vs_eager(native, pids, slot=2, slots=4, ctx=4096,
                                kv_blocks=kv, strict=True, tenant=tenant)
        print(f"fp8 flagship native prefill graphs {mode}: "
              f"{len(case.graphs.graphs)} programs captured (sync debug "
              f"'error'); chunks {[x['key'] for x in case.results]} logits "
              f"identical {[x['logits_equal'] for x in case.results]}, KV "
              f"bytes identical {case.kv_equal}", flush=True)
        check(all(x["logits_equal"] for x in case.results) and case.kv_equal,
              f"fp8 flagship prefill graphs {mode}: replays differ")
        del case
        state = build_state(native, [600, 1100, None, 300],
                            [greedy, sampled, greedy, greedy], 4096,
                            kv_blocks=kv, seed=6)
        v = verify_vs_eager(native, state, SPEC_K, FP8_STEPS,
                            ["right", "wrong", "right", None], True)
        print(f"fp8 flagship native verify graph {mode}: {FP8_STEPS} "
              f"replays vs eager, k={SPEC_K}: packed ids and logits "
              f"identical {v['equal']}, KV bytes {v['kv_equal']}, carries "
              f"{v['carries_equal']}; accepted per row {v['accepted']}",
              flush=True)
        check(v["graph"].graph is not None and v["equal"] and v["kv_equal"]
              and v["carries_equal"] and v["accepted"][0] > 0
              and v["accepted"][1] == 0,
              f"fp8 flagship verify graph {mode}: replays differ")
        del state, v
        torch.cuda.empty_cache()
    del at_load, native
    torch.cuda.empty_cache()
    # served: native first (the kernel's main path, counted), then at load
    fp8.reset_launches()
    native_tokens = {
        mode: _serve_dir(d, f"fp8 flagship served native {mode}",
                         ("--fp8-native",) + extra)
        for mode, extra in (("contiguous", ()),
                            ("paged", ("--kv-blocks", "1024")))}
    out["bf16"] = fp8.launch_counts()["bf16"]
    for mode, extra in (("contiguous", ()),
                        ("paged", ("--kv-blocks", "1024"))):
        toks = _serve_dir(d, f"fp8 flagship served at load {mode}", extra,
                          alone=False)
        print(f"fp8 flagship served {mode}: native tokens == at-load tokens "
              f"{toks == native_tokens[mode]}", flush=True)
        check(toks == native_tokens[mode],
              f"fp8 flagship served {mode}: native tokens differ")
    print(f"fp8 flagship served native: bf16 dequant launches "
          f"{out['bf16']}", flush=True)
    check(out["bf16"] > 0, "fp8 flagship: the dequant kernel never ran")
    shutil.rmtree(d, ignore_errors=True)
    return out


def phase_q8b_kernels(card: str) -> dict:
    """14(c), first: the kernels Qwen3-8B's served path runs at its heads
    (32/8, D 128, bf16): flash fresh (its prompts fit one 256-token chunk
    and a masked tail) and paged decode, each against its plain version
    and launched twice bit for bit, then timed beside the plain version,
    the library call and the bound."""
    import torch
    from cake_tpu_torch.bench import paged_timing
    from cake_tpu_torch.bench.paged_cases import case_args, paged_case
    from cake_tpu_torch.ops import paged_attention as pa
    from cake_tpu_torch.ops.flash import (flash_attention_kernel,
                                          flash_attention_ref)
    q, k, v, kw = flash_case("q8b_fresh", torch.bfloat16, **Q8B_HEADS)
    got = flash_attention_kernel(q, k, v, **kw)
    again = flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (got.float() - flash_attention_ref(q, k, v, **kw).float()
           ).abs().max().item()
    c = paged_case([600, 1100, 300, 2000], dtype=torch.bfloat16,
                   device="cuda", seed=14, **Q8B_HEADS)
    pgot = pa.paged_decode_attention_kernel(*case_args(c))
    pagain = pa.paged_decode_attention_kernel(*case_args(c))
    torch.cuda.synchronize()
    rows = c["visible_rows"]
    perr = (pgot[rows].float() - pa.paged_decode_attention_ref(
        *case_args(c))[rows].float()).abs().max().item()
    print(f"qwen3-8b heads 32/8 D 128, bf16: flash fresh max_abs_err "
          f"{err:.3e}, two launches equal {torch.equal(got, again)}; paged "
          f"decode rows at [600, 1100, 300, 2000] max_abs_err {perr:.3e}, "
          f"two launches equal {torch.equal(pgot, pagain)} (tol "
          f"{BF16_TOL:g})", flush=True)
    check(err <= BF16_TOL and perr <= BF16_TOL and torch.equal(got, again)
          and torch.equal(pgot, pagain),
          f"qwen3-8b kernels: flash {err}, paged {perr}")
    timings = {"flash.fresh": time_flash("q8b_fresh", torch.bfloat16,
                                         Q8B_HEADS)}
    t = paged_timing.measure(with_plain=True, shapes=(
        ("bf16", "bfloat16", 620, Q8B_HEADS),))["bf16"]
    check(t["max_abs_err"] <= BF16_TOL and t["same_bits"],
          f"qwen3-8b paged timing: {t['max_abs_err']}")
    print(f"qwen3-8b paged decode timing: 4 rows at p=620, bt 16, 32/8 D "
          f"128, device ms: kernel {t['ms']:.5f} plain {t['plain_ms']:.5f} "
          f"library {t['library_ms']:.5f}; bound_ms {t['bound_ms']:.5f} "
          f"({t['bound_by']}); on {card}", flush=True)
    timings["decode.bf16"] = t
    return timings


def phase_fp8_8b(card: str, workdir: str) -> dict:
    """14(c). Qwen3-8B's widths at Q8B_LAYERS of its 36 layers in Qwen's FP8
    layout: loaded native and at load (memory after each), native tokens
    equal at-load tokens, Q8B_STEPS decode replays equal eager in both
    pools (the replay's device ms native beside at load), then served
    native over HTTP, paged: 4 concurrent chats each equal alone."""
    import torch
    from cake_tpu_torch.bench import synth_checkpoint as sc
    from cake_tpu_torch.ops import flash, fp8
    from cake_tpu_torch.ops import paged_attention as pa
    out = {"timings": phase_q8b_kernels(card)}
    d = os.path.join(workdir, "qwen3-8b-fp8")
    config = sc.family_config("qwen3_8b", Q8B_LAYERS)
    t = time.perf_counter()
    params = sc.model_params(config, seed=0, device="cuda",
                             gen_device="cuda")
    nbytes = sc.write_fp8_model(d, config, params, shards=4)
    del params
    torch.cuda.empty_cache()
    sc.write_tokenizer(d, sc.QWEN3_SPECIALS)
    print(f"qwen3-8b fp8: {config['num_hidden_layers']} layers drawn and "
          f"quantized on the card, written ({nbytes / 1e9:.3f} GB) in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    native, out["native"] = _load_measured(d, nbytes, "qwen3-8b fp8 native",
                                           card, fp8_native=True)
    check(_native_projections(native), "qwen3-8b: a projection of the "
          "native tree is not float8_e4m3fn")
    at_load, out["at_load"] = _load_measured(d, nbytes,
                                             "qwen3-8b fp8 at load", card)
    check(out["native"]["memory_gb"] < 0.7 * out["at_load"]["memory_gb"],
          f"qwen3-8b: native memory {out['native']} not well under at "
          f"load's {out['at_load']}")
    ids = [int(x) for x in torch.randint(
        0, 256, (300,), generator=torch.Generator().manual_seed(12))]
    tn, ta = native.generate(ids, 16)[0], at_load.generate(ids, 16)[0]
    print(f"qwen3-8b: 16 greedy tokens native == at load {tn == ta}",
          flush=True)
    check(tn == ta, f"qwen3-8b: native tokens {tn} != at load {ta}")
    for mode, kv in (("contiguous", 0), ("paged", 1024)):
        ms = {name: _replay_ms(m, kv, Q8B_STEPS, f"qwen3-8b {name} graph "
                               f"{mode}")
              for name, m in (("native", native), ("at_load", at_load))}
        out[f"replay_ms_{mode}"] = ms
        print(f"qwen3-8b decode replay {mode} (4 slots, {Q8B_LAYERS} layers,"
              f" bf16): "
              f"device ms native {ms['native']:.4f}, at load "
              f"{ms['at_load']:.4f} (x{ms['native'] / ms['at_load']:.2f}); "
              f"on {card}", flush=True)
        torch.cuda.empty_cache()
    del at_load
    torch.cuda.empty_cache()
    for counts in (fp8, flash, pa):
        counts.reset_launches()
    bodies = [chat_body(i) for i in range(4)]
    served = serve_model(native, kv_blocks=1024)
    try:
        results = served.concurrent(bodies)
        _check_chats_any(results, "qwen3-8b served")
        _alone_equals_concurrent(served, bodies, results, "qwen3-8b served")
        ttft, tps = _latency(results)
    finally:
        served.close()
    out["bf16"] = fp8.launch_counts()["bf16"]
    out["fresh"] = flash.launch_counts()["bf16"]["fresh"]
    out["paged"] = pa.launch_counts()["bf16"]
    print(f"qwen3-8b served native, paged (1024 blocks): 4 concurrent chats, "
          f"all 200, each equal alone; TTFT p50 {ttft:.1f} ms, decode tok/s "
          f"per request p50 {tps:.1f} (smoke); launches: bf16 dequant "
          f"{out['bf16']}, flash fresh {out['fresh']}, paged decode "
          f"{out['paged']}; on {card}", flush=True)
    check(out["bf16"] > 0 and out["fresh"] > 0 and out["paged"] > 0,
          f"qwen3-8b: a kernel of its path never ran: {out}")
    del native
    torch.cuda.empty_cache()
    shutil.rmtree(d, ignore_errors=True)
    return out


def phase_gptq_gguf(card: str, workdir: str) -> None:
    """14(d) and (e). AutoGPTQ 4-bit (group 128; desc_act false, and true
    with a permuted g_idx) and GGUF (Q8_0, and a Q4_K_M-style mix of
    Q4_K and Q6_K) at the flagship's widths, QUANT_LAYERS deep: each
    served through `cli serve DIR`, its card parameters equal to a CPU
    load bit for bit and each chat equal alone; the formats take the
    contiguous and the paged pool in turns (the pool does not depend on
    how the weights were stored)."""
    from cake_tpu_torch.bench import synth_checkpoint as sc
    from cake_tpu_torch.runtime import build_text_model
    config = sc.flagship_config(QUANT_LAYERS)
    writers = {
        "gptq": lambda d: sc.write_gptq_model(
            d, config, sc.model_params(config, seed=0), seed=8, shards=2),
        "gptq-act": lambda d: sc.write_gptq_model(
            d, config, sc.model_params(config, seed=0), seed=9,
            desc_act=True, shards=2),
        "gguf-q8_0": lambda d: sc.write_gguf_model(d, config, seed=10,
                                                   mix="q8_0"),
        "gguf-q4_k_m": lambda d: sc.write_gguf_model(d, config, seed=11,
                                                     mix="q4_k_m")}
    modes = (("contiguous", ()), ("paged", ("--kv-blocks", "1024")))
    for i, (name, write) in enumerate(writers.items()):
        d = os.path.join(workdir, f"qwen3-0.6b-{name}")
        t = time.perf_counter()
        nbytes = write(d)
        sc.write_tokenizer(d, sc.QWEN3_SPECIALS)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        cpu, _, _ = build_text_model(d, "bf16", device="cpu")
        print(f"{name}: flagship's widths at {QUANT_LAYERS} layers written "
              f"({nbytes / 1e9:.3f} GB) in "
              f"{write_s:.1f} s, loaded on the CPU in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        mode, extra = modes[i % 2]
        _serve_dir(d, f"{name} served {mode}", extra,
                   cpu_params=cpu.params, stream=False)
        del cpu
        shutil.rmtree(d, ignore_errors=True)


def phase_quant(card: str, workdir: str) -> dict:
    """Phase 14: (a) the dequant kernel, (b) the FP8 flagship, (c)
    Qwen3-8B-FP8's widths at Q8B_LAYERS layers, (d) AutoGPTQ, (e) GGUF."""
    import torch
    t0 = time.perf_counter()
    out = {"kernel": phase_fp8_kernel(card)}
    torch.cuda.empty_cache()
    out["flagship"] = phase_fp8_flagship(card, workdir)
    out["q8b"] = phase_fp8_8b(card, workdir)
    phase_gptq_gguf(card, workdir)
    print(f"phase 14 in {time.perf_counter() - t0:.0f} s", flush=True)
    return out


def quant_kernel_rows(q: dict) -> list:
    """The kernels line's rows of phase 14: the dequant kernel at the
    flagship's q_proj (bf16 served native, f32 parity) and at Qwen3-8B's
    gate_proj (bf16 served native; no single PyTorch call computes it),
    and the flash (fresh) and paged decode kernels at Qwen3-8B's heads,
    each with its launches while Qwen3-8B was served."""
    from cake_tpu_torch.ops import flash, fp8
    from cake_tpu_torch.ops import paged_attention as pa
    rows = []
    for name, entry, launches in (
            ("bf16", "q_proj_0.6b.bf16", q["flagship"]["bf16"]),
            ("f32", "q_proj_0.6b.f32", q["flagship"]["f32"]),
            ("bf16.qwen3_8b", "gate_proj_8b.bf16", q["q8b"]["bf16"])):
        x = q["kernel"][entry]
        rows.append({
            "name": f"dequant_fp8_blockwise.{name}", "route": "cuda",
            "source": fp8.SOURCE, "replaces": fp8.REPLACES,
            "launches": launches, "max_abs_err": x["max_abs_err"],
            "ms": x["ms"], "plain_ms": x["plain_ms"],
            "bound_ms": x["bound_ms"], "bound_by": x["bound_by"],
            "library_ms": None})
    t, n = q["q8b"]["timings"], q["q8b"]
    x = t["flash.fresh"]
    rows.append({
        "name": "flash_attention.fresh.qwen3_8b", "route": "cuda",
        "source": flash.SOURCES["bf16"], "replaces": flash.REPLACES,
        "launches": n["fresh"], "max_abs_err": x["max_abs_err"],
        "ms": x["ms"], "meta_ms": x["meta_ms"], "issue_ms": x["issue_ms"],
        "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"],
        "bound_by": x["bound_by"], "library_ms": x["library_ms"]})
    x = t["decode.bf16"]
    rows.append({
        "name": "paged_decode_attention.bf16.qwen3_8b", "route": "cuda",
        "source": pa.SOURCE, "replaces": pa.REPLACES,
        "launches": n["paged"], "max_abs_err": x["max_abs_err"],
        "ms": x["ms"], "issue_ms": x["issue_ms"], "plain_ms": x["plain_ms"],
        "bound_ms": x["bound_ms"], "bound_by": x["bound_by"],
        "library_ms": x["library_ms"]})
    return rows


# -- phase 15: expert offload (module 10b) and the locked path -----------------

OFFLOAD_LRU = 32            # experts per layer held on the card (default)
OFFLOAD_STEPS = 16          # greedy tokens compared, offloaded vs resident
OFFLOAD_PROMPT = 320        # tokens: a prefill of one 512 bucket, flash
OFFLOAD_FP8_LAYERS = 4      # of 48, in the FP8 layout (3 linear, 1 full;
                            # cut from 12 for the whole run's time)
OFFLOAD_CHAT_TOKENS = 16
GB = 1e9


def _offload_prompt() -> list[int]:
    import torch
    return [int(x) for x in torch.randint(
        0, 150000, (OFFLOAD_PROMPT,),
        generator=torch.Generator().manual_seed(15))]


def _trunk_bytes(tree) -> int:
    """Device bytes of every tensor of a parameter tree (an offloaded
    model's providers, which hold no tensor at load, skipped)."""
    import torch
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_trunk_bytes(v) for k, v in tree.items()
                   if k != "_provider")
    if isinstance(tree, (list, tuple)):
        return sum(_trunk_bytes(v) for v in tree)
    return 0


def _layer_bytes(tree) -> tuple[int, int]:
    """(bytes outside the layers, bytes of the layers) of a trunk."""
    layers = _trunk_bytes(tree["layers"])
    return _trunk_bytes(tree) - layers, layers


def _write_qnext_dir(workdir: str, layers: int, fp8: bool = False) -> tuple:
    """Qwen3-Next-80B-A3B's widths cut to `layers`, seeded on the card
    (seed 3, norms randomized), written under workdir (bf16, or Qwen's
    FP8 block-wise layout) with the byte-level BPE tokenizer, after a
    check of the free disk. Returns (dir, params or None, bytes)."""
    import torch
    from cake_tpu_torch.bench import synth_checkpoint as sc
    config = sc.family_config("qwen3_next", layers)
    cfg_experts = config["num_experts"] * 3 * config["hidden_size"] * \
        config["moe_intermediate_size"] * layers
    need = cfg_experts * (1 if fp8 else 2) * 1.15 + 4 * GB
    free = shutil.disk_usage(workdir).free
    check(free >= need, f"qwen3-next {layers} layers: {free / GB:.1f} GB "
          f"free under {workdir}, the checkpoint needs ~{need / GB:.1f} GB")
    d = os.path.join(workdir, f"qwen3-next-{layers}{'-fp8' if fp8 else ''}")
    t = time.perf_counter()
    params = sc.model_params(config, seed=3, device="cuda",
                             randomize_norms=True, gen_device="cuda")
    write = sc.write_fp8_model if fp8 else sc.write_model
    nbytes = write(d, config, params, shards=4)
    sc.write_tokenizer(d, sc.QWEN3_SPECIALS)
    print(f"qwen3-next checkpoint: {layers} layers written "
          f"{'in the FP8 layout ' if fp8 else ''}({nbytes / GB:.2f} GB, 4 "
          f"shards; {free / GB:.1f} GB free before) in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    if fp8:
        del params
        torch.cuda.empty_cache()
        params = None
    return d, params, nbytes


def _offload_compare(d: str, card: str, label: str, logits: bool) -> dict:
    """The checkpoint loaded resident, then (the first freed) with its
    experts offloaded (an LRU of OFFLOAD_LRU per layer): memory after
    each load, OFFLOAD_STEPS greedy tokens of a 320-token prompt (equal),
    with `logits` the first step's logits (within the bf16 bar), the
    flash and dequant launches of the offloaded run (one fresh flash per
    full-attention layer; three dequants per expert read of an FP8
    checkpoint), the device memory it held (at most the trunk plus the
    LRUs), TTFT, decode rate, expert reads per token, the LRU's hit share
    and the bytes read per second. Returns the readings."""
    import torch
    from cake_tpu_torch.ops import flash, fp8
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.runtime import build_text_model
    greedy = SamplingConfig(temperature=0.0)
    prompt = _offload_prompt()
    out = {}

    def load(**kw):
        torch.cuda.synchronize()
        # collect the earlier models' cycles first: freed during the load,
        # they would be counted against it
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        t = time.perf_counter()
        model, _, _ = build_text_model(d, "bf16", device="cuda",
                                       max_cache_len=4096, **kw)
        torch.cuda.synchronize()
        return (model, before, time.perf_counter() - t,
                torch.cuda.memory_allocated() - before)
    res, _, res_s, res_bytes = load()
    want, _ = res.generate(prompt, OFFLOAD_STEPS, greedy, spec=False)
    want_logits = res.prefill(res.new_cache(1, 512), prompt)[0].float() \
        if logits else None
    cfg = res.cfg
    del res
    off, base, off_s, off_bytes = load(expert_offload=True)
    check(all(p._lru_size == OFFLOAD_LRU for p in off.providers()),
          f"{label}: the providers' LRU is not the default {OFFLOAD_LRU}")
    trunk = _trunk_bytes(off.params) + _trunk_bytes(off.rope)
    expert = 3 * cfg.hidden_size * cfg.moe_intermediate_size * 2   # bf16
    moe_layers = len(off.providers())
    lru_cap = moe_layers * OFFLOAD_LRU * expert
    full = sum(1 for sp in cfg.layer_specs() if sp.kind == "full")
    print(f"{label}: resident load {res_s:.1f} s, "
          f"{res_bytes / GB:.3f} GB on the card; offloaded load {off_s:.1f} "
          f"s, {off_bytes / GB:.3f} GB (trunk {trunk / GB:.3f} GB; LRU cap "
          f"{moe_layers} x {OFFLOAD_LRU} x {expert / 1e6:.2f} MB = "
          f"{lru_cap / GB:.3f} GB); on {card}", flush=True)
    check(off_bytes <= trunk + 256e6, f"{label}: offloaded load holds "
          f"{off_bytes} bytes, the trunk is {trunk}")
    check(off_bytes < res_bytes / 3, f"{label}: offloaded memory "
          f"{off_bytes} not well under resident {res_bytes}")
    if logits:
        got_logits = off.prefill(off.new_cache(1, 512), prompt)[0].float()
        err = (got_logits - want_logits).abs().max().item()
        print(f"{label}: first-step logits offloaded vs resident max abs "
              f"err {err:.3g} (bar {BF16_TOL})", flush=True)
        check(err <= BF16_TOL, f"{label}: logits differ by {err}")
        out["logits_err"] = err
    flash.reset_launches()
    fp8.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    got, st = off.generate(prompt, OFFLOAD_STEPS, greedy)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    fresh = flash.launch_counts()["bf16"]["fresh"]
    dequant = fp8.launch_counts()["bf16"]
    dec_reads = st["expert_reads"] - st["expert_prefill_reads"]
    dec_hits = st["expert_hits"] - st["expert_prefill_hits"]
    dec_gets = dec_hits + st["expert_misses"] - st["expert_prefill_misses"]
    gbs = st["expert_bytes_read"] / GB / max(st["expert_read_s"], 1e-9)
    out.update(resident_gb=res_bytes / GB, offload_gb=off_bytes / GB,
               trunk_gb=trunk / GB, lru_cap_gb=lru_cap / GB,
               held_gb=held / GB, peak_gb=peak / GB, ttft_s=st["ttft_s"],
               tok_s=st["tok_per_s"],
               prefill_reads=st["expert_prefill_reads"],
               reads_per_token=dec_reads / max(st["decode_tokens"], 1),
               hit_share=dec_hits / max(dec_gets, 1),
               gb_read=st["expert_bytes_read"] / GB, gb_s=gbs,
               fresh=fresh, dequant=dequant, reads=st["expert_reads"],
               tokens_equal=got == want)
    print(f"{label}: {OFFLOAD_STEPS} greedy tokens offloaded == resident "
          f"{got == want}; TTFT {st['ttft_s']:.2f} s ({OFFLOAD_PROMPT} "
          f"tokens, {st['expert_prefill_reads']} expert reads), decode "
          f"{st['tok_per_s']:.2f} tok/s, {out['reads_per_token']:.1f} expert "
          f"reads per token, LRU hit share in decode {out['hit_share']:.3f}, "
          f"{out['gb_read']:.2f} GB read at {gbs:.2f} GB/s (host read time); "
          f"card memory held {held / GB:.3f} GB (peak {peak / GB:.3f}) <= "
          f"trunk + LRU {(trunk + lru_cap) / GB:.3f} GB; launches: flash "
          f"fresh {fresh} ({full} full-attention layers), bf16 dequant "
          f"{dequant} for {st['expert_reads']} expert reads; on {card}",
          flush=True)
    check(got == want, f"{label}: offloaded tokens {got} != resident {want}")
    check(held <= trunk + lru_cap + 256e6, f"{label}: {held} bytes held, "
          f"trunk + LRU is {trunk + lru_cap}")
    check(fresh == full, f"{label}: {fresh} flash launches for {full} "
          "full-attention layers")
    out["layer_split"] = _layer_bytes(off.params)
    out["expert_bytes"] = expert
    out["model"] = off
    return out


def _chat_locked(url: str, body: dict) -> dict:
    status, hdrs, raw = _post(url, body)
    check(status == 200, f"locked chat: HTTP {status}")
    if body.get("stream"):
        events = [ln[6:] for ln in raw.decode().splitlines()
                  if ln.startswith("data: ")]
        check(events[-1] == "[DONE]", "locked SSE: no [DONE]")
        chunks = [json.loads(e)["choices"][0] for e in events[:-1]]
        return {"content": "".join(c["delta"].get("content") or ""
                                   for c in chunks[1:-1]),
                "finish": chunks[-1]["finish_reason"]}
    r = json.loads(raw)
    return {"content": r["choices"][0]["message"]["content"],
            "finish": r["choices"][0]["finish_reason"],
            "completion_tokens": r["usage"]["completion_tokens"]}


def _locked_app(model_dir: str, *extra: str, env: dict | None = None):
    """`cli serve MODEL_DIR` (ctx 4096) under `env`, started."""
    from cake_tpu_torch import cli
    args = cli.parser().parse_args(
        ["serve", model_dir, "--port", "0", "--ctx", "4096", *extra])
    return _with_env(env or {}, lambda: cli.build_server(args)).start()


def _offload_http(d: str, card: str) -> None:
    """15(c). `cli serve DIR --expert-offload`: two concurrent chats
    answered one after the other (a counter inside generate), each equal
    to generate's greedy text; SSE equal to JSON; `stop` trims."""
    import torch
    from cake_tpu_torch.api.text import apply_stop
    from cake_tpu_torch.ops.sampling import SamplingConfig
    app = _locked_app(d, "--expert-offload")
    try:
        check(app.state.engine is None, "offloaded server built an engine")
        served = app.state.model
        seen = {"active": 0, "most": 0}
        inner = served.generate
        lock = threading.Lock()

        def counted(*a, **kw):
            with lock:
                seen["active"] += 1
                seen["most"] = max(seen["most"], seen["active"])
            try:
                return inner(*a, **kw)
            finally:
                with lock:
                    seen["active"] -= 1
        served.generate = counted
        msgs = [{"role": "user", "content": "Which card serves slot 3?"}]
        body = {"messages": msgs, "temperature": 0,
                "max_tokens": OFFLOAD_CHAT_TOKENS}
        results = [None, None]

        def chat(i):
            results[i] = _chat_locked(app.url, body)
        t = time.perf_counter()
        threads = [threading.Thread(target=chat, args=(i,)) for i in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        both_s = time.perf_counter() - t
        check(all(r is not None for r in results), "locked chats hung")
        ids = served.tokenizer.chat_prompt_ids(msgs)
        toks, _ = inner(ids, OFFLOAD_CHAT_TOKENS,
                        SamplingConfig(temperature=0.0))
        ended = served.cfg.is_eos(toks[-1])
        want = served.tokenizer.decode(toks[:-1] if ended else toks)
        sse = _chat_locked(app.url, {**body, "stream": True})
        content = results[0]["content"]
        stop = next((content[i:i + 2] for i in range(2, len(content) - 1)
                     if "\ufffd" not in content[i:i + 2]
                     and content.index(content[i:i + 2]) == i), None)
        check(stop is not None, f"no stop sequence in {content!r}")
        stopped = _chat_locked(app.url, {**body, "stop": stop})
        trimmed, _ = apply_stop(content, [stop])
        print(f"offload over HTTP (cli serve --expert-offload): 2 "
              f"concurrent chats in {both_s:.1f} s, at most "
              f"{seen['most']} generation at once, each == generate "
              f"{[r['content'] == want for r in results]}; SSE == JSON "
              f"{sse['content'] == content}; stop {stop!r} trims to "
              f"{len(stopped['content'])} of {len(content)} characters "
              f"(finish {stopped['finish']}); on {card}", flush=True)
        check(seen["most"] == 1, "locked chats overlapped")
        check(all(r["content"] == want for r in results),
              "offloaded chat differs from generate")
        check(sse["content"] == content and sse["finish"] ==
              results[0]["finish"], "offloaded SSE differs from JSON")
        check(stopped["content"] == trimmed and stopped["finish"] == "stop",
              "offloaded stop did not trim")
    finally:
        app.stop(drain_s=30)
    torch.cuda.empty_cache()


def _flagship_locked(card: str, workdir: str) -> None:
    """15(c) fault 6: the flagship checkpoint (phase 7's) served in
    float32 with CAKE_SERVE_SLOTS=0 (no engine: the locked path, whose
    generate prefills the prompt in one chunk and decodes a batch-1 cache)
    and with CAKE_KV_BLOCKS=1024 (a paged pool of 1024 blocks, chunks of
    256): two chats and an SSE chat, each locked answer equal to the
    engine's. In bf16 the two programs' roundings part the random
    flagship's greedy stream at near ties; float32 holds them to it."""
    from cake_tpu_torch.bench import synth_checkpoint as sc
    d = os.path.join(workdir, "qwen3-flagship")
    if not os.path.isdir(d):
        config = sc.flagship_config(CKPT_LAYERS)
        sc.write_model(d, config, sc.model_params(
            config, seed=0, device="cuda", gen_device="cuda"), shards=2)
        sc.write_tokenizer(d, sc.QWEN3_SPECIALS)
    bodies = [chat_body(0), chat_body(1), chat_body(2, True)]
    answers = {}
    for mode, env in (("locked", {"CAKE_SERVE_SLOTS": "0"}),
                      ("paged", {"CAKE_KV_BLOCKS": "1024"})):
        app = _locked_app(d, "--dtype", "f32", env=env)
        try:
            eng = app.state.engine
            if mode == "locked":
                check(eng is None, "CAKE_SERVE_SLOTS=0 built an engine")
            else:
                check(eng is not None and eng.paged is not None
                      and eng.paged.num_blocks == 1024,
                      "CAKE_KV_BLOCKS=1024 did not build a paged pool")
            answers[mode] = [_chat_locked(app.url, b) for b in bodies]
        finally:
            app.stop(drain_s=30)
    same = [a == b for a, b in zip(answers["locked"], answers["paged"])]
    print(f"flagship: CAKE_SERVE_SLOTS=0 serves with no engine (locked), "
          f"CAKE_KV_BLOCKS=1024 a paged pool of 1024 blocks; 2 chats + 1 "
          f"SSE, locked == engine {same}; on {card}", flush=True)
    check(all(same), "locked flagship answers differ from the engine's")


def _dequant_expert_timing(cfg, card: str) -> dict:
    """The dequant kernel at one expert's gate_proj (moe_intermediate x
    hidden), bf16: bit for bit with the plain version, device ms beside
    the plain version's and the bytes bound."""
    import torch
    from cake_tpu_torch.bench.fp8_cases import (dequant_bound_ms, fp8_case,
                                                same_bits)
    from cake_tpu_torch.bench.timing import device_ms
    from cake_tpu_torch.ops import fp8
    o, i = cfg.moe_intermediate_size, cfg.hidden_size
    w, s = fp8_case(o, i, seed=o + i)
    got = fp8.dequant_fp8_blockwise_kernel(w, s, torch.bfloat16)
    plain = fp8.dequant_fp8_blockwise_plain(w, s, torch.bfloat16)
    torch.cuda.synchronize()
    nan = torch.isnan(plain)
    err = (got.float() - plain.float())[~nan].abs().max().item()
    check(same_bits(got, plain), "dequant at the expert's shape differs")
    out = {"max_abs_err": err, "shape": [o, i],
           "ms": device_ms(lambda: fp8.dequant_fp8_blockwise_kernel(
               w, s, torch.bfloat16)),
           "plain_ms": device_ms(lambda: fp8.dequant_fp8_blockwise_plain(
               w, s, torch.bfloat16), iters=10),
           "bound_ms": dequant_bound_ms(o, i, torch.bfloat16),
           "bound_by": "bytes"}
    print(f"fp8 dequant at an expert's gate_proj [{o}, {i}] -> bf16: kernel "
          f"== plain bit for bit; device ms {out['ms']:.5f}, plain "
          f"{out['plain_ms']:.5f}, bound {out['bound_ms']:.5f} (bytes); on "
          f"{card}", flush=True)
    return out


def phase_offload(card: str, workdir: str, bf16_dir: str | None = None
                  ) -> dict:
    """Phase 15: expert offload at Qwen3-Next-80B-A3B's widths. (a) bf16
    at 4 of 48 layers (phase 13(e)'s checkpoint when given, else written
    here); (b) Qwen's FP8 layout at OFFLOAD_FP8_LAYERS of 48 layers, written here, with
    the projection of the trunk and the LRUs to 48 layers; (c) the
    offloaded model over HTTP, and the flagship on the locked path
    (CAKE_SERVE_SLOTS=0) against a paged engine (CAKE_KV_BLOCKS=1024).
    Returns the readings and the launches."""
    import torch
    t0 = time.perf_counter()
    out = {}
    if bf16_dir is None:
        bf16_dir, params, _ = _write_qnext_dir(workdir, QNEXT_CKPT_LAYERS)
        del params
        torch.cuda.empty_cache()
    a = _offload_compare(bf16_dir, card, "offload (a) bf16 4 layers",
                         logits=True)
    del a["model"]
    torch.cuda.empty_cache()
    _offload_http(bf16_dir, card)
    shutil.rmtree(bf16_dir, ignore_errors=True)
    out["a"] = a
    d, _, nbytes = _write_qnext_dir(workdir, OFFLOAD_FP8_LAYERS, fp8=True)
    b = _offload_compare(d, card, f"offload (b) fp8 {OFFLOAD_FP8_LAYERS} "
                         "layers", logits=False)
    off = b.pop("model")
    check(b["dequant"] == 3 * b["reads"], f"offload (b): {b['dequant']} "
          f"dequant launches for {b['reads']} expert reads")
    out["dequant"] = _dequant_expert_timing(off.cfg, card)
    outside, layers = b["layer_split"]
    trunk48 = outside + layers / OFFLOAD_FP8_LAYERS * 48
    lru48 = 48 * OFFLOAD_LRU * b["expert_bytes"]
    banks48 = 48 * off.cfg.num_experts * b["expert_bytes"]
    print(f"offload projection to 48 layers (bf16 on the card): trunk "
          f"{trunk48 / GB:.2f} GB + LRUs {lru48 / GB:.2f} GB = "
          f"{(trunk48 + lru48) / GB:.2f} GB offloaded, against "
          f"{(trunk48 + banks48) / GB:.1f} GB resident (banks "
          f"{banks48 / GB:.1f} GB); checkpoint {nbytes / GB:.2f} GB for "
          f"{OFFLOAD_FP8_LAYERS} layers", flush=True)
    out["projection_gb"] = {"offload": (trunk48 + lru48) / GB,
                            "resident": (trunk48 + banks48) / GB}
    del off
    torch.cuda.empty_cache()
    shutil.rmtree(d, ignore_errors=True)
    out["b"] = b
    _flagship_locked(card, workdir)
    print(f"phase 15 in {time.perf_counter() - t0:.0f} s", flush=True)
    return out


def offload_kernel_rows(o: dict, qnext: dict | None) -> list:
    """The kernels line's rows of phase 15: the flash kernel's fresh
    launches on the offloaded prefills (timed at Qwen3-Next's heads in
    phase 13) and the dequant kernel's launches on the FP8 experts' reads
    (timed at an expert's shape here)."""
    from cake_tpu_torch.ops import flash, fp8
    rows = []
    if qnext is not None:
        x = qnext["timings"]["flash.fresh"]
        rows.append({
            "name": "flash_attention.fresh.offload", "route": "cuda",
            "source": flash.SOURCES["bf16"], "replaces": flash.REPLACES,
            "launches": o["a"]["fresh"] + o["b"]["fresh"],
            "max_abs_err": x["max_abs_err"], "ms": x["ms"],
            "meta_ms": x["meta_ms"], "issue_ms": x["issue_ms"],
            "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"],
            "bound_by": x["bound_by"], "library_ms": x["library_ms"]})
    x = o["dequant"]
    rows.append({
        "name": "dequant_fp8_blockwise.bf16.offload", "route": "cuda",
        "source": fp8.SOURCE, "replaces": fp8.REPLACES,
        "launches": o["b"]["dequant"], "max_abs_err": x["max_abs_err"],
        "ms": x["ms"], "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"],
        "bound_by": x["bound_by"], "library_ms": None})
    return rows


# -- phase 16: float16 models (module 16) ----------------------------------

F16_FLASH = [("f16_fresh", {}),
             ("f16_append", dict(pool_rows=4096, q_offset=256,
                                 valid_len=256)),
             ("f16_d256_fresh", dict(hq=4, hkv=1, d=256)),
             ("f16_d256_append", dict(hq=4, hkv=1, d=256, pool_rows=4096,
                                      q_offset=256, valid_len=256))]
F16_DEQUANT_TIMED = ("q_proj_0.6b", "gate_proj_8b")   # 2048x1024, 12288x4096


def _f16_kernels(card: str) -> dict:
    """16(a). The three f16 routes against their plain versions on the
    card and timed: flash fresh and append at the flagship's 16/8 D 128
    and at 4/1 D 256, both forms (the device-meta form equal to the
    host-int form bit for bit); the paged decode kernel at 16/8 D 128, 4
    rows at p = 620, and its verify form; the dequant kernel's f16 output
    at every shape (bit for bit, twice), timed at 2048 x 1024 and 12288 x
    4096."""
    import torch
    from cake_tpu_torch.bench import paged_timing
    from cake_tpu_torch.ops.flash import flash_attention_kernel
    out = {"flash": {}}
    for entry, spec in F16_FLASH:
        t = time_flash(entry, torch.float16, spec)
        check(t["max_abs_err"] <= F16_TOL,
              f"flash {entry}: max_abs_err {t['max_abs_err']} > {F16_TOL}")
        q, k, v, kw = flash_case(entry, torch.float16, **spec)
        host = flash_attention_kernel(q, k, v, **kw)
        meta = _meta_form(q, k, v, kw)()
        check(torch.equal(host, meta), f"flash {entry}: the device-meta "
              "form differs from the host-int form")
        out["flash"][entry] = t
    paged = paged_timing.measure(with_plain=True,
                                 shapes=(("f16", "float16", 620, {}),))["f16"]
    check(paged["max_abs_err"] <= F16_TOL and paged["same_bits"],
          f"paged f16: max_abs_err {paged['max_abs_err']}, two launches "
          f"equal {paged['same_bits']}")
    print(f"paged decode timing f16: 4 rows at p=620, bt 16, 16/8 D 128, "
          f"device ms: kernel {paged['ms']:.5f} plain "
          f"{paged['plain_ms']:.5f} library {paged['library_ms']:.5f} "
          f"({paged['library_backend']}); issue_ms {paged['issue_ms']:.5f};"
          f" bound_ms {paged['bound_ms']:.5f} ({paged['bound_by']}), share "
          f"of bound {paged['bound_ms'] / paged['ms']:.3f}; max_abs_err "
          f"{paged['max_abs_err']:.3e}; on {card}", flush=True)
    out["paged"] = paged
    out["verify"] = time_verify(torch.float16, {}, card)
    out["dequant"] = phase_fp8_kernel(card, (torch.float16,),
                                      F16_DEQUANT_TIMED)
    return out


F16_LAYERS = 4      # 16(b)'s replays and graphs, (c), (d) and (e): the
                    # flagship at 4 of its 28 layers (cut for the whole
                    # run's time); the hidden-state walk keeps all 28


def _f16_hidden_states(model, ids: list[int]) -> list[float]:
    """The largest |hidden state| after the embeddings and after each
    layer of a fresh 256-token prefill (checked finite)."""
    import torch
    from cake_tpu_torch.models.common.layers import (block_forward,
                                                     embed_tokens)
    cfg = model.cfg
    cache = model.new_cache(1, kv_len=4096)
    x = embed_tokens(cfg, model.params,
                     torch.tensor([ids], device=model.device))
    peaks = [x.abs().max().item()]
    with torch.no_grad():
        for j, spec in enumerate(cfg.layer_specs()):
            x, _ = block_forward(cfg, spec, model.params["layers"][j], x,
                                 cache["layers"][j], 0, model.rope,
                                 len(ids), "fresh")
            check(torch.isfinite(x).all().item(),
                  f"16(b): the hidden state is not finite after layer {j}")
            peaks.append(x.abs().max().item())
    return peaks


def _f16_spec(model, card: str) -> None:
    """16(c). Speculation at f16: generate with the n-gram drafter equals
    plain generate up to a near tie (a plain top-2 logit gap under 0.05,
    printed), and the captured verify (k 6) equals the eager verify in
    both pools."""
    import torch
    from cake_tpu_torch.bench.graph_cases import build_state
    from cake_tpu_torch.bench.spec_cases import verify_vs_eager
    from cake_tpu_torch.ops.sampling import SamplingConfig
    greedy = SamplingConfig(temperature=0.0)
    ids = model.tokenizer.chat_prompt_ids(
        [{"role": "user", "content": _prompt(3) + " " + _prompt(3)}])
    plain, _ = model.generate(ids, 48, greedy, spec=False)
    spec, stats = model.generate(ids, 48, greedy, spec="ngram")
    part = next((i for i, (a, b) in enumerate(zip(plain, spec)) if a != b),
                None)
    gap = None
    if part is not None:
        logits, _ = model.prefill(model.new_cache(1, 4096),
                                  ids + plain[:part])
        top = torch.topk(logits.float()[0], 2).values
        gap = (top[0] - top[1]).item()
    print(f"f16 spec (c): generate with the n-gram drafter, {len(ids)}-"
          f"token prompt, 48 tokens: accept rate "
          f"{stats.get('spec_accept_rate')}, equal to plain "
          f"{part is None}" + (f" (parts at {part}, plain top-2 gap "
                               f"{gap:.4f})" if part is not None else ""),
          flush=True)
    check(stats.get("spec_steps", 0) > 0, "16(c): no verify step ran")
    check(part is None or gap < 0.05, f"16(c): speculation parts from the "
          f"plain stream at {part} with a top-2 gap of {gap}")
    for mode, kv_blocks in (("contiguous", 0), ("paged", 1024)):
        state = build_state(model, [600, 1100, 300, None],
                            [greedy] * 4, 4096, kv_blocks=kv_blocks,
                            headroom=1024, seed=6)
        r = verify_vs_eager(model, state, SPEC_K, 8,
                            ["right", "wrong", "right", None], False)
        print(f"f16 spec (c) {mode}: 8 verify replays == eager verify "
              f"steps {r['equal']} (KV {r['kv_equal']}, carries "
              f"{r['carries_equal']}), accepted per row {r['accepted']}",
              flush=True)
        check(r["graph"].graph is not None and r["equal"] and r["kv_equal"]
              and r["carries_equal"], f"16(c) {mode}: verify replays "
              "differ from eager verify steps")
        del state, r
        torch.cuda.empty_cache()


def _f16_spec_serve(model, card: str) -> int:
    """16(d), paged with the n-gram drafter at k = 6 (1024 blocks of 16,
    prefix cache off), as phase 12(c) serves bf16: phase 12's 4
    concurrent chats, all 200, each equal alone; greedy tokens equal to
    the eager plain stream up to a near tie; every verify a replay with
    one f16 paged verify launch per layer. Returns those launches."""
    import torch
    from cake_tpu_torch.bench.spec_cases import plain_stream
    from cake_tpu_torch.ops import paged_attention as pa
    layers = model.cfg.num_hidden_layers
    bodies = [spec_body(i) for i in range(4)]
    on = serve_model(model, prefix_cache_mb=0, spec="ngram", spec_k=SPEC_K,
                     kv_blocks=1024, kv_block_tokens=16)
    try:
        eng = on.engine
        check(eng.spec_k == SPEC_K and all(
            g.graph is not None for g in eng.verify_graphs.values()),
            "16(d) paged spec: the verify graphs were not captured")
        torch.cuda.synchronize()
        pa.reset_launches()
        replays0 = eng.health()["spec"]["verify_replays"]
        results = on.concurrent(bodies)
        torch.cuda.synchronize()
        counts = pa.verify_launch_counts()
        h = eng.health()["spec"]
        replays = h["verify_replays"] - replays0
        _check_chats(results, "16(d) paged spec")
        _alone_equals_concurrent(on, bodies, results, "16(d) paged spec")
        prompts = [on.reqs[r["rid"]].prompt_ids for r in results]
    finally:
        on.close()
    plain = plain_stream(model, prompts, SPEC_TOKENS, 4096, kv_blocks=1024)
    parts = [_parting(r["tokens"], p["tokens"], p["gaps"],
                      f"16(d) paged spec chat {i}")
             for i, (r, p) in enumerate(zip(results, plain))]
    _, tps = _latency(results)
    print(f"f16 (d) served paged, n-gram drafter (k {SPEC_K}): 4 concurrent "
          f"chats, {results[0]['resp']['usage']['prompt_tokens']}-token "
          f"prompts, {SPEC_TOKENS} tokens, all 200, alone == in company: "
          f"{h}; {replays} verify replays, verify launches {counts}; equal "
          f"to the plain stream per chat {[not p for p in parts]}, "
          f"partings at near ties {parts}; decode tok/s per request p50 "
          f"{tps:.1f}; on {card}", flush=True)
    check(h["accepted"] > 0, f"16(d) paged spec: no draft accepted ({h})")
    check(replays > 0 and counts == {"bf16": 0, "f16": layers * replays,
                                     "f32": 0},
          f"16(d) paged spec: verify launches {counts} != {layers} x "
          f"{replays}")
    return counts["f16"]


def _f16_fp8_native(card: str, workdir: str) -> int:
    """16(e). The flagship in Qwen's FP8 layout served at f16 with its
    projections native: the dequant kernel's f16 output inside every
    captured graph; greedy tokens equal the model dequantized at load.
    Returns the f16 dequant launches of the native generate."""
    import torch
    from cake_tpu_torch.bench import synth_checkpoint as sc
    from cake_tpu_torch.ops import fp8
    from cake_tpu_torch.runtime import build_text_model
    d = os.path.join(workdir, "qwen3-0.6b-fp8-f16")
    config = sc.flagship_config(F16_LAYERS)
    sc.write_fp8_model(d, config, sc.model_params(
        config, seed=0, device="cuda", gen_device="cuda"))
    ids = list(range(40, 340))
    loaded, _, _ = build_text_model(d, "f16", device="cuda",
                                    max_cache_len=4096)
    want, _ = loaded.generate(ids, 24)
    del loaded
    torch.cuda.empty_cache()
    native, _, _ = build_text_model(d, "f16", device="cuda",
                                    max_cache_len=4096, fp8_native=True)
    check(_native_projections(native), "16(e): a projection is not native")
    fp8.reset_launches()
    got, stats = native.generate(ids, 24)
    launches = fp8.launch_counts()["f16"]
    print(f"f16 FP8 native (e): flagship in Qwen's FP8 layout at f16, "
          f"300-token prompt, 24 greedy tokens native == dequantized at "
          f"load {got == want}; dequant f16 launches {launches} (7 per "
          f"layer per program); TTFT {stats['ttft_s'] * 1e3:.1f} ms, "
          f"{stats['tok_per_s']:.1f} tokens/s; on {card}", flush=True)
    check(launches > 0, "16(e): the f16 dequant route never launched")
    check(got == want, "16(e): native tokens differ from the at-load ones")
    del native
    torch.cuda.empty_cache()
    shutil.rmtree(d, ignore_errors=True)
    return launches


def phase_f16(card: str, workdir: str) -> dict:
    """Phase 16: (a) the three f16 kernel routes; (b) the flagship at f16
    (28 layers, seed 0): the hidden states finite layer by layer; then at
    F16_LAYERS for the rest: decode replays equal eager steps and the
    prefill graphs the eager chunks in both pools; (c) speculation (generate, and verify replays against
    eager verify steps); (d) served over HTTP, contiguous and paged, TTFT
    and tokens/s, then paged with the n-gram drafter; (e) FP8 native at
    f16. Returns the kernels' readings and launches."""
    import torch
    from cake_tpu_torch.bench.graph_cases import prefill_vs_eager
    from cake_tpu_torch.cli import build_flagship
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops import paged_attention as pa
    t0 = time.perf_counter()
    out = _f16_kernels(card)
    model = build_flagship(layers=None, dtype="f16", seed=0, device="cuda")
    check(model.dtype == torch.float16, "16(b): the flagship is not f16")
    gen = torch.Generator().manual_seed(16)
    ids = torch.randint(0, 256, (256,), generator=gen).tolist()
    peaks = _f16_hidden_states(model, ids)
    del model
    torch.cuda.empty_cache()
    model = build_flagship(layers=F16_LAYERS, dtype="f16", seed=0,
                           device="cuda")
    print(f"f16 (b): flagship 28 layers at f16, a 256-token prefill: "
          f"largest |hidden state| after the embeddings {peaks[0]:.3f}, "
          f"after layers 7/14/21/28 "
          f"{[round(peaks[i], 3) for i in (7, 14, 21, 28)]} (f16 stops at "
          f"65504); every layer finite; on {card}", flush=True)
    out["peak_hidden"] = max(peaks)
    for kind, kv_blocks in (("contiguous", 0), ("paged", 1024)):
        out[f"replay_ms_{kind}"] = _replay_ms(model, kv_blocks, 16,
                                              f"f16 (b) {kind}")
        case = prefill_vs_eager(model, torch.randint(
            0, 256, (600,), generator=gen).tolist(), slot=2, slots=4,
            ctx=4096, kv_blocks=kv_blocks, strict=True)
        check(all(r["logits_equal"] for r in case.results) and case.kv_equal,
              f"16(b) {kind}: prefill replays differ from eager chunks")
        print(f"f16 (b) {kind}: prefill chunks {[r['key'] for r in case.results]}"
              f" through the captured programs == eager bit for bit",
              flush=True)
        del case
        torch.cuda.empty_cache()
    _f16_spec(model, card)
    bodies = [chat_body(i) for i in range(4)] + [chat_body(4, True)]
    for kind, kw in (("contiguous", {}), ("paged", dict(kv_blocks=1024))):
        flash.reset_launches()
        pa.reset_launches()
        served = serve_model(model, **kw)
        try:
            results = served.concurrent(bodies)
            _check_chats(results, f"16(d) {kind}")
            torch.cuda.synchronize()
            counts = flash.launch_counts()
            paged = pa.launch_counts()
            _alone_equals_concurrent(served, bodies[:2], results[:2],
                                     f"16(d) {kind}")
            ttft, tps = _latency(results[:4])
            check(served.engine.graph.graph is not None,
                  f"16(d) {kind}: no captured decode graph")
        finally:
            served.close()
        print(f"f16 (d) served {kind}: 4 concurrent chats + 1 SSE, all 200, "
              f"alone == in company; TTFT p50 {ttft:.1f} ms, decode tokens/s "
              f"per request p50 {tps:.1f}; flash launches {counts['f16']}, "
              f"paged decode launches {paged['f16']}; on {card}", flush=True)
        check(counts["f16"]["fresh"] >= F16_LAYERS * 4
              and counts["f16"]["append"] > 0,
              f"16(d) {kind}: f16 flash launches {counts}")
        check(sum(counts["bf16"].values()) == 0,
              f"16(d) {kind}: the bf16 route ran at f16: {counts}")
        if kv_blocks := kw.get("kv_blocks"):
            check(paged["f16"] > 0, f"16(d) paged: no paged f16 launch")
            out["paged_launches"] = paged["f16"]
        else:
            out["flash_launches"] = dict(counts["f16"])
        out[f"ttft_ms_{kind}"], out[f"tok_s_{kind}"] = ttft, tps
    out["verify_launches"] = _f16_spec_serve(model, card)
    del model
    torch.cuda.empty_cache()
    out["dequant_launches"] = _f16_fp8_native(card, workdir)
    print(f"phase 16 in {time.perf_counter() - t0:.0f} s", flush=True)
    return out


def f16_kernel_rows(f: dict) -> list:
    """The kernels line's rows of phase 16: flash f16 fresh and append at
    the flagship's heads (launches: 16(d)'s served chats), the paged
    decode kernel's f16 route and its verify form (launches: 16(d)'s
    served paged chats, without and with the n-gram drafter), and the
    dequant f16 output at the flagship's q_proj (launches: 16(e))."""
    from cake_tpu_torch.ops import flash, fp8
    from cake_tpu_torch.ops import paged_attention as pa
    rows = []
    for mode in ("fresh", "append"):
        t = f["flash"][f"f16_{mode}"]
        rows.append({
            "name": f"flash_attention.f16_{mode}", "route": "cuda",
            "source": flash.SOURCES["f16"], "replaces": flash.REPLACES,
            "launches": f["flash_launches"][mode],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "meta_ms": t["meta_ms"], "issue_ms": t["issue_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    t = f["paged"]
    rows.append({
        "name": "paged_decode_attention.f16", "route": "cuda",
        "source": pa.SOURCE, "replaces": pa.REPLACES,
        "launches": f["paged_launches"], "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "issue_ms": t["issue_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]})
    t = f["verify"]
    rows.append({
        "name": "paged_decode_attention.verify.f16", "route": "cuda",
        "source": pa.SOURCE, "replaces": pa.VERIFY_REPLACES,
        "launches": f["verify_launches"], "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "issue_ms": t["issue_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["unique_ms"], "bound_read_ms": t["read_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    x = f["dequant"]["q_proj_0.6b.f16"]
    rows.append({
        "name": "dequant_fp8_blockwise.f16", "route": "cuda",
        "source": fp8.SOURCE, "replaces": fp8.REPLACES,
        "launches": f["dequant_launches"], "max_abs_err": x["max_abs_err"],
        "ms": x["ms"], "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"],
        "bound_by": x["bound_by"], "library_ms": None})
    return rows


# -- phase 17: the layer-sharded cluster (module 13a) -------------------------

CLUSTER_KEY = "chip-smoke-cluster"
# the topology's two worker ranges; the master keeps layers 0-3 and 20-27
# the flagship at 16 of its 28 layers (cut for the whole run's time): the
# master holds 0-3 and 12-15, the workers a range of 4 each
CLUSTER_LAYERS = 16
CLUSTER_RANGES = {"w0": (4, 8), "w1": (8, 12)}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_worker(name: str, port: int, cache_root: str, log_path: str):
    """`python3 -m cake_tpu_torch.cli worker` in a subprocess on this
    card, answering on 127.0.0.1:port; its log goes to log_path."""
    env = dict(os.environ, CAKE_TPU_CACHE=cache_root)
    log = open(log_path, "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cake_tpu_torch.cli", "worker", "--name",
         name, "--cluster-key", CLUSTER_KEY, "--host", "127.0.0.1",
         "--port", str(port), "--no-advertise"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc


def _wait_listening(port: int, proc, log_path: str, timeout: float = 180):
    import socket
    deadline = time.perf_counter() + timeout
    while True:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            pass
        if proc.poll() is not None:
            with open(log_path, errors="replace") as f:
                tail = f.read()[-3000:]
            check(False, f"17: worker process exited ({proc.returncode}): "
                  f"{tail}")
        check(time.perf_counter() < deadline, "17: the worker process never "
              "listened")
        time.sleep(0.2)


def _thread_worker(name: str, cache_root: str):
    """A WorkerServer on this process's card, on a thread with its own
    event loop (so its stats, and the kernels' counts, can be read);
    returns (server, loop, thread)."""
    import asyncio
    from cake_tpu_torch.cluster.worker import WorkerServer
    held, ready = {}, threading.Event()

    def run():
        async def main():
            held["server"] = await WorkerServer(
                name, CLUSTER_KEY, port=0, host="127.0.0.1",
                cache_root=cache_root, advertise=False,
                device="cuda").start()
            held["loop"] = asyncio.get_running_loop()
            ready.set()
            try:
                await held["server"].serve_forever()
            except asyncio.CancelledError:
                pass
        asyncio.run(main())
    th = threading.Thread(target=run, daemon=True, name=f"worker-{name}")
    th.start()
    check(ready.wait(60), "17: the thread worker never started")
    return held["server"], held["loop"], th


def _cluster_model(d: str, dtype: str, topo: str):
    from cake_tpu_torch.cluster.master import DistributedTextModel
    from cake_tpu_torch.runtime import build_text_model
    t = time.perf_counter()
    model, _, _ = build_text_model(d, dtype, device="cuda",
                                   max_cache_len=4096,
                                   cluster_key=CLUSTER_KEY,
                                   topology_path=topo)
    check(isinstance(model, DistributedTextModel),
          "17: build_text_model did not build a cluster master")
    chain = [(s.kind, s.start, s.end) for s in model.stages]
    want = [("local", 0, CLUSTER_RANGES["w0"][0]),
            *(("remote", *CLUSTER_RANGES[n]) for n in ("w0", "w1")),
            ("local", CLUSTER_RANGES["w1"][1], CLUSTER_LAYERS)]
    check(chain == want, f"17: stage chain {chain}")
    return model, time.perf_counter() - t


def _hop_split(stats: dict) -> str:
    parts = []
    for hop, r in stats["stage_rtts"].items():
        parts.append(f"{hop}: rtt p50 {r['p50_ms']} ms = read "
                     f"{r.get('read_p50_ms')} + deser {r.get('deser_p50_ms')}"
                     f" + fwd {r.get('fwd_p50_ms')} + ser "
                     f"{r.get('ser_p50_ms')} + wire {r.get('wire_p50_ms')} "
                     f"(p50s; {r['count']} ops)")
    return "; ".join(parts)


def _cluster_f32(d, topo, card, w0):
    """17(a)-(b) in float32: greedy tokens and the pipelined prefill
    equal the single-process TextModel's; w0 killed mid-decode and
    restarted costs one replay and the continuation equals the unfailed
    run."""
    import torch
    from cake_tpu_torch.runtime import build_text_model
    single, tok, _ = build_text_model(d, "f32", device="cuda",
                                      max_cache_len=4096)
    dist, setup_s = _cluster_model(d, "f32", topo)
    for name, st in dist.streams.items():
        print(f"cluster (a) {name}: {st['bytes'] / 1e9:.3f} GB of weights "
              f"streamed with CRC32 in {st['push_s']:.2f} s = "
              f"{st['bytes'] / 1e9 / max(st['push_s'], 1e-9):.3f} GB/s "
              f"({'uncompressed: no zstandard' if _no_zstd() else 'zstd where it pays'}), "
              f"ready {st['ready_s']:.2f} s later; on {card}", flush=True)
        check(st["bytes"] > 0 and not st["cached"],
              f"17(a): {name} received no weights")
    short = tok.chat_prompt_ids([{"role": "user", "content": _prompt(0)}])
    gen = torch.Generator().manual_seed(17)
    long = torch.randint(0, 256, (1100,), generator=gen).tolist()
    out = {"setup_s": setup_s, "streams": dist.streams}
    for label, ids in (("short", short), ("pipelined", long)):
        want, _ = single.generate(ids, 32)
        got, stats = dist.generate(ids, 32)
        print(f"cluster (a) f32 {label}: {len(ids)}-token prompt, prefill "
              f"{stats['prefill']}, 32 greedy tokens equal the "
              f"single-process TextModel's {got == want}; {_hop_split(stats)}",
              flush=True)
        check(got == want, f"17(a) {label}: cluster tokens {got} != "
              f"single-process {want}")
        check(stats["prefill"]["pipelined"] == (label == "pipelined"),
              f"17(a) {label}: prefill {stats['prefill']}")
        out[label] = want
    # (b) kill w0 mid-decode, restart it on the same port and cache
    dist.recovery_retries, dist.recovery_backoff_s = 8, 1.0
    killed = {}

    def on_token(t):
        if len(killed) == 0 and t is not None and on_token.n == 10:
            w0["proc"].kill()
            w0["proc"].wait(timeout=30)
            killed["at"] = time.perf_counter()
            w0["proc"] = _spawn_worker("w0", w0["port"], w0["cache"],
                                       w0["log"])
        on_token.n += 1
    on_token.n = 0
    got, stats = dist.generate(short, 32, on_token=on_token)
    recovered_s = time.perf_counter() - killed["at"]
    print(f"cluster (b) f32: w0 killed (SIGKILL) after token 10 and "
          f"restarted by `cli worker`: replays {stats['replays']}, "
          f"recoveries {stats['recoveries']}, continuation equal to the "
          f"unfailed run {got == out['short']}; the generation ended "
          f"{recovered_s:.1f} s after the kill (the new process's start "
          f"included); on {card}", flush=True)
    check(stats["replays"] == 1 and stats["recoveries"] == 1,
          f"17(b): replays {stats['replays']}, recoveries "
          f"{stats['recoveries']}")
    check(got == out["short"], "17(b): the continuation after the "
          "restart differs from the unfailed run")
    dist.close()
    del single, dist
    torch.cuda.empty_cache()
    return out


def _no_zstd() -> bool:
    from cake_tpu_torch.cluster import transfer
    return transfer.zstandard is None


def _cluster_bf16(d, topo, card, w1):
    """17(c) in bf16: TTFT and decode tokens/s against the single-process
    model, each hop's RTT split, and the flash launches of the master's
    local stages (8 layers: one fresh and two append launches each over
    the 3 chunks) and of w1 (its own chunks, by flash mode)."""
    import torch
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.runtime import build_text_model
    single, _, _ = build_text_model(d, "bf16", device="cuda",
                                    max_cache_len=4096)
    gen = torch.Generator().manual_seed(18)
    ids = torch.randint(0, 256, (1100,), generator=gen).tolist()
    single.generate(ids, 8)                     # first use of each program
    _, s_stats = single.generate(ids, 64)
    dist, setup_s = _cluster_model(d, "bf16", topo)
    check(all(st["cached"] for st in dist.streams.values()),
          "17(c): a worker's cache missed on the second setup")
    dist.generate(ids, 8)
    chunks0 = dict(w1.stats["chunks"])
    flash.reset_launches()
    torch.cuda.synchronize()
    _, stats = dist.generate(ids, 64)
    torch.cuda.synchronize()
    counts = flash.launch_counts()["bf16"]
    w1_chunks = {m: w1.stats["chunks"][m] - chunks0[m] for m in chunks0}
    w1_layers = CLUSTER_RANGES["w1"][1] - CLUSTER_RANGES["w1"][0]
    # the master keeps every layer the workers do not hold
    master_layers = CLUSTER_LAYERS - sum(hi - lo for lo, hi
                                         in CLUSTER_RANGES.values())
    w1_launches = {m: w1_chunks[m] * w1_layers for m in ("fresh", "append")}
    master = {m: counts[m] - w1_launches[m] for m in ("fresh", "append")}
    print(f"cluster (c) bf16, 1100-token prompt (pipelined {stats['prefill']})"
          f", 64 tokens: TTFT {stats['ttft_s'] * 1e3:.1f} ms against "
          f"{s_stats['ttft_s'] * 1e3:.1f} ms single-process, decode "
          f"{stats['tok_per_s']:.1f} tokens/s against "
          f"{s_stats['tok_per_s']:.1f}; host copies {stats['host_copy_s'] * 1e3:.1f}"
          f" ms; {_hop_split(stats)}; flash (bf16) launches in this process "
          f"{counts}: w1 ({w1_layers} layers) {w1_launches} from its chunks "
          f"{w1_chunks}, the master's {master_layers} local layers "
          f"{master}; second setup "
          f"{setup_s:.2f} s (weights cached); on {card}", flush=True)
    check(w1_chunks == {"fresh": 1, "append": 2, "off": 0},
          f"17(c): w1's chunks {w1_chunks}")
    check(master == {"fresh": master_layers, "append": 2 * master_layers},
          f"17(c): the master's local flash launches {master}")
    dist.close()
    del single, dist
    torch.cuda.empty_cache()
    return {"ttft_ms": stats["ttft_s"] * 1e3,
            "tok_s": stats["tok_per_s"],
            "single_ttft_ms": s_stats["ttft_s"] * 1e3,
            "single_tok_s": s_stats["tok_per_s"],
            "rtts": stats["stage_rtts"], "flash": counts,
            "w1_flash": w1_launches}


def _cluster_serve(d, topo, card):
    """17(d) `cli serve DIR --cluster-key --topology`: one chat answered,
    /api/v1/topology lists both nodes, /health answers 200."""
    from cake_tpu_torch import cli
    app = cli.build_server(cli.parser().parse_args(
        ["serve", d, "--port", "0", "--cluster-key", CLUSTER_KEY,
         "--topology", topo])).start()
    try:
        status, _, raw = _post(app.url, chat_body(1))
        resp = json.loads(raw)
        st, _, topo_raw = _get(app.url, "/api/v1/topology")
        nodes = json.loads(topo_raw)["nodes"]
        hs, _, health = _get(app.url, "/health")
        health = json.loads(health)
    finally:
        app.stop()
        app.state.model.close()
    print(f"cluster (d) `cli serve --cluster-key --topology`: chat HTTP "
          f"{status}, {resp['usage']['completion_tokens']} tokens; "
          f"/api/v1/topology nodes "
          f"{ {n: v['layer_range'] for n, v in nodes.items()} }; /health "
          f"{hs} {health['status']}, workers "
          f"{[(w['name'], w['ops']) for w in health['workers']]}; on {card}",
          flush=True)
    check(status == 200 and resp["usage"]["completion_tokens"] > 0,
          f"17(d): chat {status}")
    check({n: tuple(v["layer_range"]) for n, v in nodes.items()}
          == CLUSTER_RANGES, f"17(d): topology nodes {nodes}")
    check(hs == 200 and health["status"] == "ok", f"17(d): /health {hs}")


def phase_cluster(card: str, workdir: str) -> dict:
    """Phase 17: the flagship (CLUSTER_LAYERS of its 28 layers, seed 0)
    served across processes on the one card: w0 a `cli worker`
    subprocess, w1 a WorkerServer on a thread, a topology file giving them
    layers 4-7 and 8-11, the master
    the rest, weights streamed with CRC32. (a) float32: greedy tokens and
    the pipelined prefill equal the single-process TextModel's; (b) w0
    killed mid-decode and restarted: one replay, the continuation equal;
    (c) bf16 readings; (d) `cli serve` over the cluster."""
    import asyncio
    import torch
    from cake_tpu_torch.bench import synth_checkpoint as sc
    t0 = time.perf_counter()
    d = os.path.join(workdir, "qwen3-flagship-cluster")
    config = sc.flagship_config(CLUSTER_LAYERS)
    sc.write_model(d, config, sc.model_params(config, seed=0, device="cuda",
                                              gen_device="cuda"), shards=2)
    sc.write_tokenizer(d, sc.QWEN3_SPECIALS)
    torch.cuda.empty_cache()
    w0 = {"port": _free_port(), "cache": os.path.join(workdir, "w0-cache"),
          "log": os.path.join(workdir, "w0.log")}
    w0["proc"] = _spawn_worker("w0", w0["port"], w0["cache"], w0["log"])
    w1, loop, th = _thread_worker("w1", os.path.join(workdir, "w1-cache"))
    topo = os.path.join(workdir, "topology.yml")
    with open(topo, "w") as f:
        for name, port in (("w0", w0["port"]), ("w1", w1.port)):
            lo, hi = CLUSTER_RANGES[name]
            f.write(f"{name}:\n  host: 127.0.0.1:{port}\n  layers: "
                    f"[\"model.layers.{lo}-{hi - 1}\"]\n  backend: cuda\n")
    try:
        _wait_listening(w0["port"], w0["proc"], w0["log"])
        out = {"f32": _cluster_f32(d, topo, card, w0)}
        _wait_listening(w0["port"], w0["proc"], w0["log"])
        out["bf16"] = _cluster_bf16(d, topo, card, w1)
        _cluster_serve(d, topo, card)
    finally:
        w0["proc"].terminate()
        try:
            w0["proc"].wait(timeout=30)
        except subprocess.TimeoutExpired:
            w0["proc"].kill()
            w0["proc"].wait(timeout=30)
        asyncio.run_coroutine_threadsafe(w1.stop(), loop).result(timeout=30)
        th.join(timeout=30)
        shutil.rmtree(d, ignore_errors=True)
    print(f"phase 17 in {time.perf_counter() - t0:.0f} s", flush=True)
    return out


# -- phase 18: FLUX.1-dev text-to-image (module 14a) --------------------------

FLUX_SIZES = ((512, 4), (1024, 2))     # (side, denoising steps) served
FLUX_CHECK_SIDE = 512                  # 18(b) and 18(c): 2 steps there
FLUX_PROMPT = "w1 w2 w3 w5 w8 w13 w21 w34 w55 w89 a watercolor fox"
FLUX_CUT = dict(double=2, single=2, t5_layers=2)   # 18(c)'s checkpoint


def _tree_bytes(tree) -> int:
    """Bytes of a tree's tensors, each storage once (a tied embedding)."""
    from cake_tpu_torch.utils.mapping import flatten_tree
    seen = {t.data_ptr(): t.numel() * t.element_size()
            for t in flatten_tree(tree).values()
            if hasattr(t, "data_ptr")}
    return sum(seen.values())


def _fp8_leaves(tree) -> int:
    """Native FP8 pairs in a tree."""
    from cake_tpu_torch.utils.mapping import flatten_tree
    return sum(k.endswith(".fp8") for k in flatten_tree(tree))


def _png_pixels(data: bytes, side: int, label: str):
    """The PNG's pixels, checked: a valid 8-bit RGB PNG of side x side."""
    from cake_tpu_torch.utils.png import decode_png
    try:
        pix = decode_png(data)
    except ValueError as e:
        raise SmokeFailure(f"{label}: not a valid PNG: {e}")
    check(pix.shape == (side, side, 3), f"{label}: PNG {pix.shape}, want "
          f"{side} x {side} RGB")
    return pix


def phase_flux_kernel(card: str) -> dict:
    """18, kernels: the dequant kernel's bf16 output against its plain
    version at every FLUX.1-dev shape (bench/fp8_cases.FLUX_SHAPES), with
    blockwise scales and with one per-tensor scale over the grid, each
    launched twice, bit for bit; timed at FLUX_TIMED beside the plain
    version and the bound."""
    import torch
    from cake_tpu_torch.bench.fp8_cases import (FLUX_SHAPES, FLUX_TIMED,
                                                dequant_bound_ms,
                                                dequant_bytes, fp8_case,
                                                per_tensor_case, same_bits)
    from cake_tpu_torch.bench.timing import device_ms
    from cake_tpu_torch.ops import fp8
    out, dt = {}, torch.bfloat16
    for name, o, i in FLUX_SHAPES:
        for scales, case in (("blockwise", fp8_case),
                             ("per-tensor", per_tensor_case)):
            w, s = case(o, i, seed=o + 3 * i)
            first = fp8.dequant_fp8_blockwise_kernel(w, s, dt)
            second = fp8.dequant_fp8_blockwise_kernel(w, s, dt)
            plain = fp8.dequant_fp8_blockwise_plain(w, s, dt)
            torch.cuda.synchronize()
            nan = torch.isnan(plain)
            err = (first.float() - plain.float())[~nan].abs().max().item()
            same, twice = same_bits(first, plain), torch.equal(
                first.view(torch.uint8), second.view(torch.uint8))
            line = (f"fp8 dequant {name} [{o}, {i}] {scales} -> bf16: "
                    f"kernel == plain bit for bit {same} (max_abs_err "
                    f"{err:.1e}), launched twice identical {twice}")
            check(same and twice, f"fp8 dequant {name} {scales}: kernel "
                  f"differs from plain ({same}) or from itself ({twice})")
            if scales == "blockwise":
                entry = {"max_abs_err": err}
                if name in FLUX_TIMED:
                    entry.update(
                        ms=device_ms(lambda: fp8.dequant_fp8_blockwise_kernel(
                            w, s, dt)),
                        plain_ms=device_ms(
                            lambda: fp8.dequant_fp8_blockwise_plain(w, s, dt),
                            iters=10),
                        bound_ms=dequant_bound_ms(o, i, dt),
                        bound_by="bytes")
                    line += (f"; device ms {entry['ms']:.5f} ("
                             f"{dequant_bytes(o, i, dt) / entry['ms'] / 1e9:.3f}"
                             f" TB/s), plain {entry['plain_ms']:.5f}, bound "
                             f"{entry['bound_ms']:.5f} (bytes); on {card}")
                out[name] = entry
            print(line, flush=True)
            del w, s, first, second, plain
    return out


def _flux_request(url: str, path: str, side: int, steps: int, seed: int,
                  fmt: str | None = None):
    body = {"prompt": FLUX_PROMPT, "size": f"{side}x{side}", "steps": steps,
            "seed": seed}
    if fmt:
        body["response_format"] = fmt
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=900) as r:
        return r.status, r.headers.get("Content-Type"), r.read(), \
            time.perf_counter() - t


def _flux_served(card: str):
    """18(a): `cli serve --flagship --layers 1 --slots 0 --image-model
    demo:flux1-dev --fp8-native` (FLUX.1-dev's full widths and depth from
    seeded weights, the MMDiT native FP8), one 512 x 512 image as b64_json
    and one 1024 x 1024 raw PNG over HTTP. Returns (image model, the
    served dequant launches by weight shape, readings)."""
    import base64
    import torch
    from cake_tpu_torch import cli
    from cake_tpu_torch.ops import fp8
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args = cli.parser().parse_args(
        ["serve", "--flagship", "--layers", "1", "--slots", "0", "--port",
         "0", "--image-model", "demo:flux1-dev", "--fp8-native"])
    t0 = time.perf_counter()
    app = cli.build_server(args).start()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = app.state.image_model
    enc = model.text_encoder.params
    parts = {"mmdit": _tree_bytes(model.params["transformer"]),
             "t5": _tree_bytes(enc["t5"]), "clip": _tree_bytes(enc["clip"]),
             "vae": _tree_bytes(model.params["vae"]),
             "flagship_1_layer": _tree_bytes(app.state.model.params)}
    held = torch.cuda.memory_allocated() - base
    reckoned = sum(parts.values())
    n_fp8 = _fp8_leaves(model.params["transformer"])
    print(f"18(a) FLUX.1-dev seeded on the card in {build_s:.1f} s: "
          f"{n_fp8} native FP8 weights; device memory "
          f"{held / GB:.3f} GB held against {reckoned / GB:.3f} GB of "
          f"parameters ({', '.join(f'{k} {v / GB:.3f}' for k, v in parts.items())}"
          f" GB); on {card}", flush=True)
    check(n_fp8 == 314, f"18(a): {n_fp8} native FP8 weights, want 314 "
          "(19 x 10 + 38 x 3 + 10)")
    check(abs(parts["mmdit"] / GB - 11.9) < 0.3 and abs(parts["t5"] / GB
                                                        - 9.5) < 0.3,
          f"18(a): MMDiT {parts['mmdit'] / GB:.2f} GB / T5 "
          f"{parts['t5'] / GB:.2f} GB, want ~11.9 / ~9.5")
    check(reckoned <= held <= reckoned + 0.5 * GB,
          f"18(a): {held / GB:.3f} GB held for {reckoned / GB:.3f} GB of "
          "parameters")
    readings, served = {}, collections.Counter()
    try:
        for (side, steps), (path, fmt) in zip(
                FLUX_SIZES, (("/v1/images/generations", None),
                             ("/api/v1/image", None))):
            fp8.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            status, ctype, raw, wall = _flux_request(app.url, path, side,
                                                     steps, seed=side)
            launches = fp8.launch_counts()["bf16"]
            by_shape = fp8.shape_launch_counts()
            served.update(by_shape)
            check(status == 200, f"18(a) {side}: HTTP {status}")
            if path.endswith("/image"):
                check(ctype == "image/png", f"18(a) {side}: {ctype}")
                png = raw
            else:
                png = base64.b64decode(json.loads(raw)["data"][0]["b64_json"])
            pix = _png_pixels(png, side, f"18(a) {side}")
            st = dict(model.stats)
            peak = torch.cuda.max_memory_allocated() - base
            r = readings[side] = {
                "steps": steps, "s_per_step": st["denoise_s"] / steps,
                "encode_s": st["encode_s"], "decode_s": st["decode_s"],
                "wall_s": wall, "launches": launches,
                "peak_gb": peak / GB, "png_bytes": len(png)}
            print(f"18(a) {side} x {side} via {path}: {steps} steps, "
                  f"{r['s_per_step']:.4f} s per denoising step, text "
                  f"encoders {r['encode_s']:.4f} s, VAE decode "
                  f"{r['decode_s']:.4f} s, request {wall:.2f} s; PNG "
                  f"{len(png)} bytes, pixels {int(pix.min())}-"
                  f"{int(pix.max())}; {launches} dequant launches "
                  f"({steps} x {n_fp8}); peak device memory "
                  f"{peak / GB:.2f} GB over the start; on {card}",
                  flush=True)
            check(launches == steps * n_fp8
                  and sum(by_shape.values()) == launches,
                  f"18(a) {side}: {launches} dequant launches ("
                  f"{sum(by_shape.values())} by shape), want {steps} x "
                  f"{n_fp8}")
    finally:
        app.stop()
    return model, dict(served), readings


def _flux_native_vs_at_load(model, card: str) -> None:
    """18(b): the served model's latents (native FP8, the kernel per use)
    equal bit for bit those of the same FP8 values dequantized at load
    (utils/mapping.dequant_at_load, the loader's arithmetic), weight by
    weight in place, at the same seed."""
    import torch
    from cake_tpu_torch.ops import fp8
    from cake_tpu_torch.utils.mapping import dequant_at_load

    def at_load(node):
        if fp8.is_fp8(node):
            return dequant_at_load(node["fp8"], node["scale_inv"][0, 0],
                                   torch.bfloat16)
        if isinstance(node, dict):
            for k in list(node):
                node[k] = at_load(node[k])
        elif isinstance(node, list):
            for k in range(len(node)):
                node[k] = at_load(node[k])
        return node
    native = model.denoise(FLUX_PROMPT, FLUX_CHECK_SIDE, FLUX_CHECK_SIDE, steps=2, seed=7)
    native_s = model.stats["denoise_s"] / 2
    at_load(model.params["transformer"])
    gc.collect()
    torch.cuda.empty_cache()
    mem = torch.cuda.memory_allocated() / GB
    fp8.reset_launches()
    loaded = model.denoise(FLUX_PROMPT, FLUX_CHECK_SIDE, FLUX_CHECK_SIDE, steps=2, seed=7)
    same = torch.equal(native.view(torch.int16), loaded.view(torch.int16))
    print(f"18(b) native FP8 == dequantized at load, {FLUX_CHECK_SIDE}^2, "
          f"2 steps: "
          f"latents bit for bit {same} (finite "
          f"{bool(torch.isfinite(native).all())}); {mem:.3f} GB on the "
          f"card at load; {native_s:.4f} against "
          f"{model.stats['denoise_s'] / 2:.4f} s per step at load; on "
          f"{card}", flush=True)
    check(same and bool(torch.isfinite(native).all()),
          "18(b): native latents differ from at load's (or are not finite)")
    check(sum(fp8.launch_counts().values()) == 0,
          "18(b): the at-load model launched the dequant kernel")


def _flux_checkpoint(card: str, workdir: str) -> None:
    """18(c): FLUX.1-dev's widths at 2 double, 2 single and 2 T5 layers,
    seeded (the MMDiT native FP8), written as a ComfyUI bundle
    (bench/synth_flux.py: per-tensor `.scale_weight`, word-level
    tokenizers) and loaded through runtime.build_image_model with
    --fp8-native: its latents equal the seeded model's bit for bit, and
    it makes a valid PNG."""
    import torch
    from cake_tpu_torch.bench.synth_flux import cut_depth, \
        write_flux_checkpoint
    from cake_tpu_torch.models.image import flux1_dev_configs, seeded_flux1
    from cake_tpu_torch.runtime import build_image_model
    cfgs = cut_depth(flux1_dev_configs(), FLUX_CUT["double"],
                     FLUX_CUT["single"], FLUX_CUT["t5_layers"])
    seeded = seeded_flux1(cfgs, torch.bfloat16, "cuda", seed=11,
                          fp8_native=True)
    want = seeded.denoise(FLUX_PROMPT, FLUX_CHECK_SIDE, FLUX_CHECK_SIDE, steps=2, seed=3)
    d = os.path.join(workdir, "flux1_cut")
    t = time.perf_counter()
    n = write_flux_checkpoint(d, cfgs, {
        "transformer": seeded.params["transformer"],
        "vae": seeded.params["vae"], **seeded.text_encoder.params},
        layout="bundle", fp8="tree")
    write_s = time.perf_counter() - t
    del seeded
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    loaded = build_image_model(d, "bf16", fp8_native=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    got = loaded.denoise(FLUX_PROMPT, FLUX_CHECK_SIDE, FLUX_CHECK_SIDE, steps=2, seed=3)
    same = torch.equal(want.view(torch.int16), got.view(torch.int16))
    png = loaded.generate_image(FLUX_PROMPT, FLUX_CHECK_SIDE, FLUX_CHECK_SIDE, steps=2,
                                seed=3).png_bytes()
    _png_pixels(png, FLUX_CHECK_SIDE, "18(c)")
    print(f"18(c) FLUX.1-dev widths at {FLUX_CUT['double']} + "
          f"{FLUX_CUT['single']} blocks and {FLUX_CUT['t5_layers']} T5 "
          f"layers: {n / GB:.3f} GB written in {write_s:.1f} s, loaded "
          f"native in {load_s:.1f} s ({n / GB / load_s:.2f} GB/s, page "
          f"cache warm); latents equal the seeded model's bit for bit "
          f"{same}; PNG {len(png)} bytes; on {card}", flush=True)
    check(same, "18(c): the loaded checkpoint's latents differ from the "
          "seeded model's")
    shutil.rmtree(d, ignore_errors=True)


def phase_flux(card: str, workdir: str) -> dict:
    """18. FLUX.1-dev (module 14a): the dequant kernel at FLUX's shapes,
    then (a) served, (b) native == at load, (c) a checkpoint."""
    import torch
    t0 = time.perf_counter()
    out = {"kernel": phase_flux_kernel(card)}
    torch.cuda.empty_cache()
    model, out["launches"], out["served"] = _flux_served(card)
    _flux_native_vs_at_load(model, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    _flux_checkpoint(card, workdir)
    print(f"phase 18 in {time.perf_counter() - t0:.0f} s", flush=True)
    return out


def flux_kernel_rows(f: dict) -> list:
    """The kernels line's rows of phase 18: the dequant kernel's bf16
    output at the largest FLUX.1-dev shape and the two cropped edges,
    each with its own shape's launches in 18(a)'s two served images."""
    from cake_tpu_torch.bench.fp8_cases import FLUX_SHAPES, FLUX_TIMED
    from cake_tpu_torch.ops import fp8
    shapes = {name: (o, i) for name, o, i in FLUX_SHAPES}
    rows = []
    for name in FLUX_TIMED:
        x = f["kernel"][name]
        check(f["launches"].get(shapes[name], 0) > 0,
              f"18(a): no served dequant launch at {name} {shapes[name]}")
        rows.append({
            "name": f"dequant_fp8_blockwise.bf16.{name}", "route": "cuda",
            "source": fp8.SOURCE, "replaces": fp8.REPLACES,
            "launches": f["launches"].get(shapes[name], 0),
            "max_abs_err": x["max_abs_err"],
            "ms": x["ms"], "plain_ms": x["plain_ms"],
            "bound_ms": x["bound_ms"], "bound_by": x["bound_by"],
            "library_ms": None})
    return rows


# -- phase 19: SD 1.5 and SDXL (module 14b) ----------------------------------

SD_PROMPT = "a watercolor lighthouse on a cliff at dusk, soft light"
SD_NEGATIVE = "blurry, low quality, watermark"
SDXL_SIDE, SDXL_STEPS = 1024, 4        # 19(a): two images served
SD15_SIDE, SD15_STEPS = 512, 4         # 19(b): img2img
SD15_TRACED_STEPS = 3                  # 19(b): an intermediate at step 2
SD15_STRENGTH = 0.6
SD_CUT = dict(levels=2, depth=1, encoder_layers=2)     # 19(c)
SD_CHECK_SIDE = 128                                    # 19(c): latent 16
SD_UNET_TOL = 1e-4      # f32 card vs CPU, TF32 off: sum order only
SD_LATENT_TOL = 1e-4    # after 3 steps of DPM-Solver++ and CFG


class _TF32:
    """PyTorch's TF32 switches set for a block and restored after it."""

    def __init__(self, matmul: bool, cudnn: bool):
        self.want = (matmul, cudnn)

    def __enter__(self):
        import torch
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.want

    def __exit__(self, *exc):
        import torch
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def _sd_write(name: str, family: dict, workdir: str, seed: int) -> str:
    """A diffusers directory of `family` from seeded bf16 weights drawn on
    the card (the VAE float32), written under workdir."""
    import torch
    from cake_tpu_torch.bench import synth_sd
    t = time.perf_counter()
    model = synth_sd.seeded_sd(family, torch.bfloat16, "cuda", seed=seed)
    d = os.path.join(workdir, name)
    n = synth_sd.write_sd_checkpoint(d, family, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"19 {name}: {n / GB:.3f} GB of seeded weights written as a "
          f"diffusers directory in {time.perf_counter() - t:.1f} s",
          flush=True)
    return d


def _sd_request(url: str, side: int, steps: int, negative: str,
                fmt: str | None = None):
    body = {"prompt": SD_PROMPT, "negative_prompt": negative,
            "size": f"{side}x{side}", "steps": steps, "seed": side,
            "guidance": 7.0}
    if fmt:
        body["response_format"] = fmt
    req = urllib.request.Request(
        url + "/v1/images/generations", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=900) as r:
        return r.status, r.headers.get("Content-Type"), r.read(), \
            time.perf_counter() - t


def _sd_app(d: str, *extra: str):
    from cake_tpu_torch import cli
    args = cli.parser().parse_args(
        ["serve", "--flagship", "--layers", "1", "--slots", "0", "--port",
         "0", "--image-model", d, *extra])
    return cli.build_server(args).start()


def _sdxl_served(card: str, workdir: str) -> dict:
    """19(a): SDXL base's published widths and depth (blocks 320 / 640 /
    1280, heads 5 / 10 / 20, depth 1 / 2 / 10, context 2048, text_time
    2816, CLIP-L and OpenCLIP bigG, VAE 0.13025) seeded in bf16, written
    as a diffusers directory and served through `cli serve --flagship
    --layers 1 --slots 0 --image-model DIR`: a 1024 x 1024 image with a
    negative prompt as b64_json and one with an empty negative prompt
    (the zeros path) as a raw PNG."""
    import base64
    import torch
    from cake_tpu_torch.bench import synth_sd
    d = _sd_write("sdxl", synth_sd.FAMILIES["sdxl"], workdir, seed=19)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    app = _sd_app(d)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    model = app.state.image_model
    parts = {"unet": _tree_bytes(model.params["unet"]),
             "vae": _tree_bytes({k: model.params[k] for k in ("vae",
                                                              "vae_enc")}),
             "clip_l": _tree_bytes(model.text_encoder.params),
             "bigg": _tree_bytes(model.text_encoder2.params),
             "flagship_1_layer": _tree_bytes(app.state.model.params)}
    held = torch.cuda.memory_allocated() - base
    reckoned = sum(parts.values())
    print(f"19(a) SDXL loaded through cli serve in {load_s:.1f} s: "
          f"{type(model).__name__}; device memory {held / GB:.3f} GB held "
          f"against {reckoned / GB:.3f} GB of parameters ("
          f"{', '.join(f'{k} {v / GB:.3f}' for k, v in parts.items())} "
          f"GB); on {card}", flush=True)
    check(type(model).__name__ == "SDXLImageModel",
          f"19(a): {type(model).__name__}, want SDXLImageModel")
    check(abs(parts["unet"] / GB - 5.135) < 0.05,
          f"19(a): UNet {parts['unet'] / GB:.3f} GB, want ~5.135 (2.567 B "
          "parameters in bf16)")
    check(reckoned <= held <= reckoned + 0.5 * GB,
          f"19(a): {held / GB:.3f} GB held for {reckoned / GB:.3f} GB")
    ctx, _ = model._encode_prompt(SD_PROMPT, "", SDXL_SIDE, SDXL_SIDE)
    check(ctx.shape[-1] == 2048 and not bool(ctx[0].any()),
          "19(a): the empty negative prompt is not the zeros path")
    readings = {"load_s": load_s, "held_gb": held / GB,
                "params_gb": reckoned / GB}
    try:
        for negative, fmt in ((SD_NEGATIVE, None), ("", "png")):
            torch.cuda.reset_peak_memory_stats()
            status, ctype, raw, wall = _sd_request(
                app.url, SDXL_SIDE, SDXL_STEPS, negative, fmt)
            check(status == 200, f"19(a): HTTP {status}")
            if fmt == "png":
                check(ctype == "image/png", f"19(a): {ctype}")
                png = raw
            else:
                png = base64.b64decode(json.loads(raw)["data"][0]["b64_json"])
            pix = _png_pixels(png, SDXL_SIDE, "19(a)")
            st = dict(model.stats)
            peak = torch.cuda.max_memory_allocated() - base
            key = "negative" if negative else "zeros"
            r = readings[key] = {
                "s_per_step": st["denoise_s"] / st["steps"],
                "encode_s": st["encode_s"], "decode_s": st["decode_s"],
                "wall_s": wall, "peak_gb": peak / GB,
                "png_bytes": len(png)}
            print(f"19(a) SDXL {SDXL_SIDE} x {SDXL_SIDE}, "
                  f"{'a' if negative else 'an empty (zeros)'} negative "
                  f"prompt, {st['steps']} steps: {r['s_per_step']:.4f} s "
                  f"per denoising step (batch-2 CFG), text encoders "
                  f"{r['encode_s']:.4f} s, VAE decode {r['decode_s']:.4f} "
                  f"s, request {wall:.2f} s; PNG {len(png)} bytes, pixels "
                  f"{int(pix.min())}-{int(pix.max())}; peak device memory "
                  f"{peak / GB:.2f} GB over the start; on {card}",
                  flush=True)
    finally:
        app.stop()
    del model, app
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(d, ignore_errors=True)
    return readings


def _rgba_png(h: int, w: int, seed: int) -> tuple[bytes, "np.ndarray"]:
    """An 8-bit RGBA PNG whose rows cycle through the five filters (the
    port's encoder writes filter 0 only), and its pixels."""
    import struct
    import zlib
    import numpy as np
    from cake_tpu_torch.utils.png import SIGNATURE
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    rgba = np.stack([(xx * 255 // max(w - 1, 1)), (yy * 255 // max(h - 1, 1)),
                     (xx + yy) % 256, 128 + (xx % 64)], axis=-1)
    rgba = (rgba + rng.integers(0, 16, rgba.shape)).clip(0, 255) \
        .astype(np.uint8)
    raw = rgba.reshape(h, w * 4).astype(np.int16)
    a = np.concatenate([np.zeros((h, 4), np.int16), raw[:, :-4]], axis=1)
    b = np.concatenate([np.zeros((1, w * 4), np.int16), raw[:-1]], axis=0)
    c = np.concatenate([np.zeros((h, 4), np.int16), b[:, :-4]], axis=1)
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(raw), a, b, (a + b) // 2, paeth]
    kinds = np.arange(h) % 5
    filt = np.stack([preds[k][y] for y, k in enumerate(kinds)])
    rows = np.concatenate([kinds[:, None], (raw - filt) % 256], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    png = (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0,
                                                  0, 0))
           + chunk(b"IDAT", zlib.compress(rows.astype(np.uint8).tobytes()))
           + chunk(b"IEND", b""))
    return png, rgba


def _sd15(card: str, workdir: str) -> dict:
    """19(b): SD 1.5's published widths (blocks 320 / 640 / 1280 / 1280, 8
    heads, context 768, CLIP-L, a tokenizer/ of vocab.json + merges.txt
    only) seeded in bf16 and written: img2img at 512 x 512, strength 0.6,
    from an RGBA PNG with filtered rows through `cli image DIR
    --init-image`; then one txt2img of 3 steps through `cli serve
    --image-model DIR --sd-intermediate-every 2 --sd-trace-dir T`: the
    intermediate image decodes, the trace parses (its kernel events
    counted), and one UNet step's device time is split by class
    (obs/profile.kernel_split)."""
    import base64
    import numpy as np
    import torch
    from cake_tpu_torch import cli
    from cake_tpu_torch.bench import synth_sd
    from cake_tpu_torch.obs.profile import kernel_split
    from cake_tpu_torch.utils.png import decode_png
    d = _sd_write("sd15", synth_sd.FAMILIES["sd15"], workdir, seed=15)
    tok = sorted(os.listdir(os.path.join(d, "tokenizer")))
    check("tokenizer.json" not in tok and "merges.txt" in tok,
          f"19(b): tokenizer/ holds {tok}")
    png, rgba = _rgba_png(600, 440, seed=1)
    check(np.array_equal(decode_png(png), rgba[..., :3]),
          "19(b): the filtered RGBA PNG does not decode to its pixels")
    init = os.path.join(workdir, "init.png")
    with open(init, "wb") as f:
        f.write(png)
    out = os.path.join(workdir, "sd15_img2img.png")
    t = time.perf_counter()
    rc = cli.main(["image", d, SD_PROMPT, "--out", out, "--width",
                   str(SD15_SIDE), "--height", str(SD15_SIDE), "--steps",
                   str(SD15_STEPS), "--init-image", init, "--strength",
                   str(SD15_STRENGTH), "--seed", "1", "--negative-prompt",
                   SD_NEGATIVE])
    img2img_s = time.perf_counter() - t
    with open(out, "rb") as f:
        pix = _png_pixels(f.read(), SD15_SIDE, "19(b) img2img")
    print(f"19(b) SD 1.5 img2img {SD15_SIDE} x {SD15_SIDE} from a 440 x "
          f"600 RGBA PNG (rows filtered 0-4), strength {SD15_STRENGTH}, "
          f"{SD15_STEPS} steps: cli image exit {rc} in {img2img_s:.1f} s (load "
          f"included), pixels {int(pix.min())}-{int(pix.max())}; on {card}",
          flush=True)
    check(rc == 0, f"19(b): cli image exited {rc}")
    trace = os.path.join(workdir, "sd_trace")
    mids = os.path.join(workdir, "mids")
    os.makedirs(mids)
    app = _sd_app(d, "--sd-intermediate-every", "2", "--sd-trace-dir",
                  trace)
    cwd = os.getcwd()
    os.chdir(mids)          # the intermediate images go to the cwd
    try:
        status, _, raw, wall = _sd_request(app.url, SD15_SIDE,
                                           SD15_TRACED_STEPS, SD_NEGATIVE)
    finally:
        os.chdir(cwd)
        app.stop()
    check(status == 200, f"19(b) served: HTTP {status}")
    _png_pixels(base64.b64decode(json.loads(raw)["data"][0]["b64_json"]),
                SD15_SIDE, "19(b) served")
    st = dict(app.state.image_model.stats)
    names = sorted(os.listdir(mids))
    check(names == ["sd_intermediate_2.png"],
          f"19(b): intermediate images {names}, want sd_intermediate_2.png")
    with open(os.path.join(mids, names[0]), "rb") as f:
        _png_pixels(f.read(), SD15_SIDE, "19(b) intermediate")
    files = os.listdir(trace)
    check(len(files) == 1, f"19(b): trace files {files}")
    with open(os.path.join(trace, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    print(f"19(b) SD 1.5 txt2img served with --sd-intermediate-every 2 "
          f"--sd-trace-dir: {st['steps']} steps, "
          f"{st['denoise_s'] / st['steps']:.4f} s per step, VAE decode "
          f"{st['decode_s']:.4f} s, request {wall:.2f} s (the profiler "
          f"on); {names[0]} decodes; trace {files[0]} parses: "
          f"{len(events)} events, {kernels} kernel events; on {card}",
          flush=True)
    split = kernel_split(events, "sd.unet_step")
    check(split["ranges"] == SD15_TRACED_STEPS and split["total"] > 0,
          f"19(b): the trace's UNet steps hold no kernel: {split}")
    n = split["ranges"]
    print("19(b) SD 1.5 UNet step at 512 x 512 (batch-2 CFG), device ms "
          "by class from the trace: " + ", ".join(
              f"{k} {split[k] / n:.3f} ({split[k] / split['total']:.3f})"
              for k in ("attention", "conv", "gemm", "other"))
          + f"; total {split['total'] / n:.3f} ms per step against "
          f"{st['denoise_s'] / st['steps'] * 1e3:.1f} ms of wall (the "
          f"profiler on); on {card}", flush=True)
    del app
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(d, ignore_errors=True)
    return {"s_per_step": st["denoise_s"] / st["steps"],
            "decode_s": st["decode_s"], "img2img_s": img2img_s,
            "served_wall_s": wall,
            "trace_kernels": kernels,
            "step_split_ms": {k: v / n for k, v in split.items()
                              if k != "ranges"}}


def _sd_tree(model) -> dict:
    """An SD model's every parameter by path, structural Nones dropped
    (a mapped load has none)."""
    from cake_tpu_torch.utils.mapping import flatten_tree
    tree = {"pipe": model.params, "te": model.text_encoder.params}
    if hasattr(model, "text_encoder2"):
        tree["te2"] = model.text_encoder2.params
    return flatten_tree(tree)


def _sd_copy(model, device: str):
    """The same SD model with its parameters and encoders copied to
    `device`."""
    import copy
    import torch
    out = copy.copy(model)
    out.params = _to_device(model.params, device)
    for name in ("text_encoder", "text_encoder2"):
        if hasattr(model, name):
            enc = copy.copy(getattr(model, name))
            enc.params = _to_device(enc.params, device)
            setattr(out, name, enc)
    out.device = torch.device(device)
    return out


def _sd_parity(card: str, workdir: str) -> dict:
    """19(c): SD 1.5, SD 2.1 (v-prediction, per-level heads 5 / 10, a gelu
    encoder) and SDXL at their widths cut to 2 UNet levels, transformer
    depth 1 and 2 encoder layers, float32 with TF32 off: the UNet's output
    and a 3-step latent from the same noise on the card against the
    card's machine's CPU; then each written and loaded through
    runtime.build_image_model equal to the seeded model bit for bit."""
    import torch
    from cake_tpu_torch.bench import synth_sd
    from cake_tpu_torch.models.image import sd as tsd
    from cake_tpu_torch.runtime import build_image_model
    out = {}
    lat = SD_CHECK_SIDE // 8
    for i, name in enumerate(("sd15", "sd21", "sdxl")):
        fam = synth_sd.cut(synth_sd.FAMILIES[name], **SD_CUT)
        card_model = synth_sd.seeded_sd(fam, torch.float32, "cuda",
                                        seed=40 + i)
        cpu = _sd_copy(card_model, "cpu")
        noise = torch.randn((1, 4, lat, lat),
                            generator=torch.Generator().manual_seed(i))
        with _TF32(False, False):
            ctx, added = cpu._encode_prompt(SD_PROMPT, SD_NEGATIVE,
                                            SD_CHECK_SIDE, SD_CHECK_SIDE)
            x, t = torch.cat([noise, noise]), torch.tensor([0.6, 0.6])
            want = tsd.unet_forward(cpu.cfg.unet, cpu.params["unet"], x, t,
                                    ctx, added)
            want_z = cpu.denoise(SD_PROMPT, SD_CHECK_SIDE, SD_CHECK_SIDE, 3,
                                 negative_prompt=SD_NEGATIVE, noise=noise)
            d = os.path.join(workdir, f"{name}_cut")
            synth_sd.write_sd_checkpoint(d, fam, card_model)
            got = tsd.unet_forward(card_model.cfg.unet,
                                   card_model.params["unet"], x.cuda(),
                                   t.cuda(), ctx.cuda(),
                                   None if added is None else added.cuda())
            got_z = card_model.denoise(SD_PROMPT, SD_CHECK_SIDE,
                                       SD_CHECK_SIDE, 3,
                                       negative_prompt=SD_NEGATIVE,
                                       noise=noise)
            torch.cuda.synchronize()
        e_unet = float((got.cpu() - want).abs().max() / want.abs().max())
        e_lat = float((got_z.cpu() - want_z).abs().max()
                      / want_z.abs().max())
        loaded = build_image_model(d, "f32")
        want_t, got_t = _sd_tree(card_model), _sd_tree(loaded)
        diff = sorted(set(want_t) ^ set(got_t)) or [
            k for k, v in want_t.items()
            if v.dtype != got_t[k].dtype or not torch.equal(v, got_t[k])]
        same = torch.equal(
            loaded.denoise(SD_PROMPT, SD_CHECK_SIDE, SD_CHECK_SIDE, 2,
                           noise=noise),
            card_model.denoise(SD_PROMPT, SD_CHECK_SIDE, SD_CHECK_SIDE, 2,
                               noise=noise))
        out[name] = {"unet_rel": e_unet, "latent_rel": e_lat}
        print(f"19(c) {name} cut to {SD_CUT}: f32 card vs CPU (TF32 off): "
              f"UNet output max rel err {e_unet:.2e} (tol {SD_UNET_TOL}), "
              f"3-step latent {e_lat:.2e} (tol {SD_LATENT_TOL}); written "
              f"and loaded through build_image_model: parameters equal "
              f"{not diff}, latents bit for bit {same}; "
              f"{cpu.cfg.prediction_type}, heads {cpu.cfg.unet.num_heads}; "
              f"on {card}", flush=True)
        check(e_unet < SD_UNET_TOL and e_lat < SD_LATENT_TOL,
              f"19(c) {name}: card vs CPU {e_unet:.2e} / {e_lat:.2e}")
        check(not diff and same, f"19(c) {name}: the loaded directory "
              f"differs from the seeded model ({diff[:3]}, latents {same})")
        del cpu, card_model, loaded
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(d, ignore_errors=True)
    return out


def phase_sd(card: str, workdir: str) -> dict:
    """19. SD 1.5 and SDXL (module 14b): (a) SDXL served, (b) SD 1.5
    img2img through `cli image` and txt2img served with intermediates and
    a trace, (c) card-vs-CPU parity and the written directories. SD runs
    no hand-written kernel: its attention is the reference's plain
    float32 one, its products cuBLAS's and its convolutions cuDNN's, with
    PyTorch's default TF32 settings in (a) and (b) and TF32 off in (c)."""
    t0 = time.perf_counter()
    with _TF32(False, True):
        out = {"sdxl": _sdxl_served(card, workdir),
               "sd15": _sd15(card, workdir)}
    out["parity"] = _sd_parity(card, workdir)
    print(f"phase 19 in {time.perf_counter() - t0:.0f} s", flush=True)
    return out


# -- phase 20: FLUX.2-klein (module 14c) --------------------------------------


FLUX2_SIZES = ((1024, 4), (512, 4))    # 20(a): (side, steps) served
FLUX2_PROMPT = "a watercolor fox in the snow at dusk, soft light"
FLUX2_CUT = dict(double=1, single=1, captures=(0, 1, 2))   # 20(b), 20(c)
FLUX2_CHECK = dict(side=128, txt_len=64, steps=3)          # 20(b)
FLUX2_SERVED_CHECK = dict(side=256, steps=2, seed=9)       # 20(c)
FLUX2_TOL = 1e-4        # f32 card vs CPU, TF32 off: sum order only


def _flux2_cut(captures=FLUX2_CUT["captures"]) -> dict:
    """klein-4B's configs at their widths, the transformer cut to
    FLUX2_CUT's blocks and the encoder to the layers its captures run."""
    import dataclasses
    from cake_tpu_torch.models.image import klein_4b_configs
    cfgs = klein_4b_configs()
    cfgs["flux2"] = dataclasses.replace(
        cfgs["flux2"], depth_double=FLUX2_CUT["double"],
        depth_single=FLUX2_CUT["single"])
    cfgs["output_layers"] = captures
    return cfgs


def _flux2_post(url: str, body: dict):
    req = urllib.request.Request(
        url + "/v1/images/generations", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=900) as r:
        return r.status, r.headers.get("Content-Type"), r.read(), \
            time.perf_counter() - t


def _flux2_served(card: str) -> dict:
    """20(a): `cli serve --flagship --layers 1 --slots 0 --image-model
    demo:flux2-klein`: klein-4B's transformer, its Qwen3-4B encoder
    (layers 0-26) and its 32-channel VAE seeded in bf16 (the VAE float32)
    on the card; one 1024 x 1024 image as b64_json and one 512 x 512 raw
    PNG over HTTP, 4 steps each."""
    import base64
    import torch
    from cake_tpu_torch import cli
    from cake_tpu_torch.ops import flash
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args = cli.parser().parse_args(
        ["serve", "--flagship", "--layers", "1", "--slots", "0", "--port",
         "0", "--image-model", "demo:flux2-klein"])
    t0 = time.perf_counter()
    app = cli.build_server(args).start()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = app.state.image_model
    t, v, enc = model.cfg.transformer, model.cfg.vae, model.text_encoder
    e = enc.cfg
    widths = ((t.hidden_size, t.num_heads, t.head_dim, t.mlp_hidden,
               t.depth_double, t.depth_single, t.in_channels,
               t.context_in_dim, t.axes_dims, t.theta),
              (e.hidden_size, e.num_attention_heads, e.num_key_value_heads,
               e.head_dim, e.intermediate_size, e.vocab_size,
               len(enc.params["layers"]), enc.output_layers, enc.max_len),
              (v.latent_channels, v.base_channels, v.channel_mults,
               v.num_res_blocks))
    check(widths == ((3072, 24, 128, 9216, 5, 20, 128, 7680,
                      (32, 32, 32, 32), 2000.0),
                     (2560, 32, 8, 128, 9728, 151936, 27, (8, 17, 26), 512),
                     (32, 128, (1, 2, 4, 4), 3)),
          f"20(a): not klein-4B's widths: {widths}")
    parts = {"transformer": _tree_bytes(model.params["transformer"]),
             "qwen3_encoder": _tree_bytes(enc.params),
             "vae": _tree_bytes(model.params["vae"]),
             "flagship_1_layer": _tree_bytes(app.state.model.params)}
    held = torch.cuda.memory_allocated() - base
    reckoned = sum(parts.values())
    print(f"20(a) FLUX.2-klein-4B seeded on the card in {build_s:.1f} s "
          f"(transformer {t.depth_double} + {t.depth_single} blocks at "
          f"{t.hidden_size}, Qwen3-4B encoder layers 0-26 at "
          f"{e.hidden_size}, VAE {v.latent_channels} channels); device "
          f"memory {held / GB:.3f} GB held against {reckoned / GB:.3f} GB "
          f"of parameters ({', '.join(f'{k} {b / GB:.3f}' for k, b in parts.items())}"
          f" GB); on {card}", flush=True)
    check(reckoned <= held <= reckoned + 0.5 * GB,
          f"20(a): {held / GB:.3f} GB held for {reckoned / GB:.3f} GB of "
          "parameters")
    flash_before = dict(flash.launch_counts())
    readings = {}
    try:
        for (side, steps), fmt in zip(FLUX2_SIZES, (None, "png")):
            body = {"prompt": FLUX2_PROMPT, "size": f"{side}x{side}",
                    "steps": steps, "seed": side}
            if fmt:
                body["response_format"] = fmt
            torch.cuda.reset_peak_memory_stats()
            status, ctype, raw, wall = _flux2_post(app.url, body)
            check(status == 200, f"20(a) {side}: HTTP {status}")
            if fmt:
                check(ctype == "image/png", f"20(a) {side}: {ctype}")
                png = raw
            else:
                png = base64.b64decode(json.loads(raw)["data"][0]["b64_json"])
            pix = _png_pixels(png, side, f"20(a) {side}")
            st = dict(model.stats)
            peak = torch.cuda.max_memory_allocated() - base
            r = readings[side] = {
                "steps": steps, "s_per_step": st["denoise_s"] / steps,
                "encode_s": st["encode_s"], "decode_s": st["decode_s"],
                "wall_s": wall, "peak_gb": peak / GB,
                "png_bytes": len(png)}
            print(f"20(a) {side} x {side} ({'raw PNG' if fmt else 'b64_json'}"
                  f"): {steps} steps, {r['s_per_step']:.4f} s per denoising "
                  f"step, Qwen3 encoder {r['encode_s']:.4f} s, VAE decode "
                  f"{r['decode_s']:.4f} s, request {wall:.2f} s; PNG "
                  f"{len(png)} bytes, pixels {int(pix.min())}-"
                  f"{int(pix.max())}; peak device memory {peak / GB:.2f} GB "
                  f"over the start; on {card}", flush=True)
            check(int(pix.max()) > int(pix.min()),
                  f"20(a) {side}: a flat image")
    finally:
        app.stop()
    check(flash.launch_counts() == flash_before,
          "20(a): the FLUX.2 path launched the flash kernel (the "
          "reference's encoder and image attention are plain)")
    return readings


def _flux2_parity(card: str) -> dict:
    """20(b): klein-4B's widths cut to FLUX2_CUT, float32 with TF32 off,
    seeded on the card and copied to the card's machine's CPU: the Qwen3
    encoder's three captures of the templated prompt, one flux2_forward,
    and 3 Euler steps from the same noise and text."""
    import torch
    from cake_tpu_torch.models.image import (Flux2ImageModel,
                                             Flux2TextEncoder, seeded_flux2)
    from cake_tpu_torch.models.image.flux2 import (flux2_forward,
                                                   latent_grid,
                                                   make_img_ids4,
                                                   make_txt_ids4)
    side, steps = FLUX2_CHECK["side"], FLUX2_CHECK["steps"]
    with _TF32(False, False):
        card_m = seeded_flux2(_flux2_cut(), torch.float32, "cuda", seed=20,
                              max_txt_len=FLUX2_CHECK["txt_len"])
        enc = card_m.text_encoder
        cpu_enc = Flux2TextEncoder(enc.cfg, _to_device(enc.params, "cpu"),
                                   tokenizer=enc.tokenizer,
                                   max_len=enc.max_len,
                                   output_layers=enc.output_layers,
                                   pad_id=enc.pad_id, dtype=torch.float32)
        cpu_m = Flux2ImageModel(card_m.cfg,
                                params=_to_device(card_m.params, "cpu"),
                                text_encoder=cpu_enc,
                                bn_stats=(card_m.bn_mean.cpu(),
                                          card_m.bn_var.cpu()),
                                dtype=torch.float32, device="cpu")
        ids, real = enc.token_ids(FLUX2_PROMPT)
        want_txt = cpu_enc.encode_ids(ids, real)
        got_txt = enc.encode_ids(ids, real)
        cfg = card_m.cfg.transformer
        h_half, w_half = latent_grid(card_m.cfg, side, side)
        noise = torch.randn((1, h_half * w_half, cfg.in_channels),
                            generator=torch.Generator().manual_seed(20))
        t = torch.tensor([0.7])
        args = (make_img_ids4(h_half, w_half), want_txt,
                make_txt_ids4(want_txt.shape[1]))
        want_v = flux2_forward(cfg, cpu_m.params["transformer"], noise,
                               args[0], want_txt, args[2], t)
        got_v = flux2_forward(cfg, card_m.params["transformer"],
                              noise.cuda(), args[0].cuda(), want_txt.cuda(),
                              args[2].cuda(), t.cuda())
        want_z = cpu_m.denoise(FLUX2_PROMPT, side, side, steps, noise=noise,
                               text=want_txt)
        got_z = card_m.denoise(FLUX2_PROMPT, side, side, steps, noise=noise,
                               text=want_txt)
        torch.cuda.synchronize()

    def rel(got, want):
        return float((got.cpu() - want).abs().max() / want.abs().max())
    out = {"encoder_rel": rel(got_txt, want_txt),
           "forward_rel": rel(got_v, want_v),
           "latent_rel": rel(got_z, want_z)}
    print(f"20(b) klein-4B widths cut to {FLUX2_CUT['double']} + "
          f"{FLUX2_CUT['single']} blocks and encoder layers 0-"
          f"{max(FLUX2_CUT['captures'])}, f32 card vs CPU (TF32 off): "
          f"encoder captures ({real} real tokens of "
          f"{FLUX2_CHECK['txt_len']}) max rel err {out['encoder_rel']:.2e}, "
          f"flux2_forward {out['forward_rel']:.2e}, {steps} Euler steps at "
          f"{side} x {side} {out['latent_rel']:.2e} (tol {FLUX2_TOL}); on "
          f"{card}", flush=True)
    check(max(out.values()) < FLUX2_TOL, f"20(b): card vs CPU {out}")
    return out


def _flux2_checkpoint(card: str, workdir: str) -> dict:
    """20(c): klein-4B's widths cut to FLUX2_CUT, seeded in bf16 on the
    card, written as a diffusers directory (bench/synth_flux2.py) and
    served through `cli serve --image-model DIR`: the loaded tree equals
    the seeded one bit for bit and the served image the in-memory model's
    pixel for pixel."""
    import torch
    from cake_tpu_torch.bench.synth_flux2 import write_flux2_checkpoint
    from cake_tpu_torch.models.image import seeded_flux2
    from cake_tpu_torch.utils.mapping import flatten_tree
    import numpy as np
    from cake_tpu_torch.utils.png import decode_png
    seeded = seeded_flux2(_flux2_cut(), torch.bfloat16, "cuda", seed=21)
    d = os.path.join(workdir, "flux2_cut")
    t = time.perf_counter()
    n = write_flux2_checkpoint(d, seeded)
    write_s = time.perf_counter() - t
    c = FLUX2_SERVED_CHECK
    want = seeded.generate_image(FLUX2_PROMPT, c["side"], c["side"],
                                 c["steps"], seed=c["seed"])
    t = time.perf_counter()
    app = _sd_app(d)
    load_s = time.perf_counter() - t
    try:
        loaded = app.state.image_model
        a = flatten_tree({"pipe": seeded.params,
                          "enc": seeded.text_encoder.params})
        b = flatten_tree({"pipe": loaded.params,
                          "enc": loaded.text_encoder.params})
        diff = sorted(set(a) ^ set(b)) or [
            k for k, v in a.items()
            if v.dtype != b[k].dtype or not torch.equal(v, b[k])]
        status, _, raw, wall = _flux2_post(app.url, {
            "prompt": FLUX2_PROMPT, "size": f"{c['side']}x{c['side']}",
            "steps": c["steps"], "seed": c["seed"], "response_format": "png"})
    finally:
        app.stop()
    check(status == 200, f"20(c): HTTP {status}")
    same = np.array_equal(decode_png(raw), np.asarray(want))
    print(f"20(c) klein-4B widths at {FLUX2_CUT['double']} + "
          f"{FLUX2_CUT['single']} blocks, encoder layers 0-"
          f"{max(FLUX2_CUT['captures'])}: {n / GB:.3f} GB written in "
          f"{write_s:.1f} s, served through `cli serve --image-model DIR` "
          f"after {load_s:.1f} s (page cache warm); tree equal bit for bit "
          f"{not diff} ({len(a)} tensors, bn and post_quant_conv "
          f"included), served {c['side']} x {c['side']} image equal to the "
          f"in-memory model's {same} ({wall:.2f} s); on {card}", flush=True)
    check(not diff, f"20(c): loaded tree differs: {diff[:3]}")
    check(same, "20(c): the served image differs from the in-memory one")
    del seeded
    shutil.rmtree(d, ignore_errors=True)
    return {"written_gb": n / GB, "write_s": write_s, "load_s": load_s}


def phase_flux2(card: str, workdir: str) -> dict:
    """20. FLUX.2-klein (module 14c): (a) served at klein-4B's full widths
    and depth, (b) card vs CPU in float32 at a cut depth, (c) a written
    directory served. No hand-written kernel runs: the encoder's and the
    image's attention are the reference's plain ones."""
    import torch
    t0 = time.perf_counter()
    out = {"served": _flux2_served(card)}
    gc.collect()
    torch.cuda.empty_cache()
    out["parity"] = _flux2_parity(card)
    gc.collect()
    torch.cuda.empty_cache()
    out["checkpoint"] = _flux2_checkpoint(card, workdir)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 20 in {time.perf_counter() - t0:.0f} s", flush=True)
    return out


# -- phase 21: VibeVoice (module 14d, first part) ----------------------------


VV_TEXT = "Hello from the card, in a seeded voice."   # 27 frames (3.6 s)
VV_CUT = dict(base_layers=1, tts_layers=2)     # 21(b), 21(c)
VV_CLI_FRAMES = 6                              # 21(c)
VV_FRAME_TOL = 1e-4     # f32 card vs CPU, teacher-forced with the CPU's
                        # latents: each frame's condition, latent and EOS
                        # probability, and the VAE decoder on the same
                        # latents (sum order only)
# the two runs' waveforms: the VAE decoder multiplies a latent difference
# up to ~15x on the random weights (PERF.md §6), so 1e-4 on each latent
# allows 1.5e-3 on the waveform
VV_WAV_TOL = 1.5e-3


def _vv_post(url: str, body: dict):
    req = urllib.request.Request(
        url + "/v1/audio/speech", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=900) as r:
        return r.status, r.headers.get("Content-Type"), r.read(), \
            time.perf_counter() - t


def _vv_served(card: str, workdir: str) -> dict:
    """21(a): `cli serve --flagship --layers 1 --slots 0 --audio-model
    demo:vibevoice-0.5b --voices-dir V`: VibeVoice-Realtime-0.5B's widths
    seeded in bf16 (the VAE float32) on the card; a WAV, a PCM, a
    voice_b64 clone and a named voice over HTTP."""
    import base64
    import numpy as np
    import torch
    from cake_tpu_torch import cli
    from cake_tpu_torch.bench.synth_vibevoice import write_voice_prompt
    from cake_tpu_torch.models.audio import realtime_0_5b_config
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.utils.wav import decode_wav, encode_wav
    voices = os.path.join(workdir, "voices")
    os.makedirs(voices, exist_ok=True)
    write_voice_prompt(os.path.join(voices, "narrator.safetensors"),
                       realtime_0_5b_config(), seq=16, seed=1)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args = cli.parser().parse_args(
        ["serve", "--flagship", "--layers", "1", "--slots", "0", "--port",
         "0", "--audio-model", "demo:vibevoice-0.5b", "--voices-dir",
         voices])
    t0 = time.perf_counter()
    app = cli.build_server(args).start()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = app.state.audio_model
    cfg = model.cfg
    lm = cfg.lm_tts
    widths = (lm.hidden_size, lm.num_attention_heads, lm.num_key_value_heads,
              lm.intermediate_size, lm.vocab_size,
              cfg.lm_base.num_hidden_layers, lm.num_hidden_layers,
              cfg.acoustic_dim, cfg.vae_ratios, cfg.hop, cfg.vae_depths,
              cfg.vae_channels[0], cfg.head_layers)
    check(widths == (896, 14, 2, 4864, 151936, 4, 20, 64,
                     (8, 5, 5, 4, 2, 2), 3200, (3, 3, 3, 3, 3, 3, 8), 2048,
                     4), f"21(a): not the realtime 0.5B's widths: {widths}")
    p = model.params
    parts = {"lms": _tree_bytes({"b": p["base"], "t": p["tts"]}),
             "head_connector_eos": _tree_bytes(
                 {k: p[k] for k in ("head", "connector", "eos",
                                    "input_types")}),
             "vae_decoder": _tree_bytes(p["vae"]),
             "vae_encoder": _tree_bytes(p["vae_enc"]),
             "flagship_1_layer": _tree_bytes(app.state.model.params)}
    held = torch.cuda.memory_allocated() - base
    reckoned = sum(parts.values())
    print(f"21(a) VibeVoice-Realtime-0.5B widths seeded on the card in "
          f"{build_s:.1f} s (base {cfg.lm_base.num_hidden_layers} + TTS "
          f"{lm.num_hidden_layers} layers at {lm.hidden_size}, hop "
          f"{cfg.hop}); device memory {held / GB:.3f} GB held against "
          f"{reckoned / GB:.3f} GB of parameters ({', '.join(f'{k} {b / GB:.3f}' for k, b in parts.items())}"
          f" GB); on {card}", flush=True)
    check(reckoned <= held <= reckoned + 0.5 * GB,
          f"21(a): {held / GB:.3f} GB held for {reckoned / GB:.3f} GB")
    clone = encode_wav(0.5 * np.sin(np.arange(24000) * 2 * np.pi * 220
                                    / 24000).astype(np.float32))
    requests = (("wav", {}), ("pcm", {"response_format": "pcm"}),
                ("voice_b64 clone",
                 {"voice_b64": base64.b64encode(clone).decode()}),
                ("named voice", {"voice": "narrator"}))
    flash_before = dict(flash.launch_counts())
    readings, bodies = {}, {}
    try:
        for name, extra in requests:
            status, ctype, raw, wall = _vv_post(app.url, {"input": VV_TEXT,
                                                          **extra})
            check(status == 200, f"21(a) {name}: HTTP {status}")
            if name == "pcm":
                check(ctype == "application/octet-stream",
                      f"21(a) pcm: {ctype}")
                samples = np.frombuffer(raw, "<i2")
            else:
                check(ctype == "audio/wav", f"21(a) {name}: {ctype}")
                samples, rate = decode_wav(raw)
                check(rate == cfg.sample_rate, f"21(a) {name}: rate {rate}")
            st = dict(model.stats)
            frames = st["frames"]
            audio_s = frames * cfg.hop / cfg.sample_rate
            r = readings[name] = {
                "frames": frames, "s_per_frame": st["lm_s"] / frames,
                "vae_s": st["vae_s"], "wall_s": wall,
                "rtf": (st["lm_s"] + st["vae_s"]) / audio_s}
            bodies[name] = raw
            print(f"21(a) {name}: {frames} frames ({audio_s:.2f} s of "
                  f"audio), {r['s_per_frame']:.4f} s per frame (text "
                  f"windows, TTS LM steps and {cfg.solver_steps} diffusion "
                  f"steps), VAE decode {r['vae_s']:.4f} s, real-time factor "
                  f"{r['rtf']:.3f}, request {wall:.2f} s; {len(raw)} bytes; "
                  f"on {card}", flush=True)
            check(3 <= frames and len(samples) == frames * cfg.hop
                  and np.abs(samples.astype(np.float32)).max() > 0,
                  f"21(a) {name}: {frames} frames, {len(samples)} samples")
    finally:
        app.stop()
    check(bodies["pcm"] == bodies["wav"][44:],
          "21(a): the PCM answer is not the WAV's data chunk (same seed)")
    check(bodies["named voice"] != bodies["wav"]
          and bodies["voice_b64 clone"] != bodies["wav"],
          "21(a): a voice did not change the audio")
    check(flash.launch_counts() == flash_before,
          "21(a): the speech path launched the flash kernel")
    return readings


def _vv_parity(card: str) -> dict:
    """21(b): the realtime 0.5B's widths cut to VV_CUT, float32 with TF32
    off, seeded on the card and copied to the CPU: the served sentence's
    whole generate_speech on the CPU, then on the card from the same
    per-frame noise, teacher-forced with the CPU's latents (frame_latents),
    so that every frame, every text window and every EOS decision is held
    on the same inputs without the loop compounding the roundings; then
    the EOS stop itself, with the classifier's bias raised on both."""
    import numpy as np
    import torch
    from cake_tpu_torch.models.audio import (VibeVoiceTTS,
                                             realtime_0_5b_config)
    cfg = realtime_0_5b_config(**VV_CUT)
    gen = torch.Generator().manual_seed(21)
    noise = [torch.randn((1, cfg.acoustic_dim), generator=gen)
             for _ in range(8 + len(VV_TEXT) // 2)]
    seen, logs = {}, {"cpu": [], "card": []}
    with _TF32(False, False):
        card_m = VibeVoiceTTS(cfg, dtype=torch.float32, seed=21,
                              device="cuda")
        cpu_m = VibeVoiceTTS(cfg, params=_to_device(card_m.params, "cpu"),
                             dtype=torch.float32, device="cpu")

        def keep(key, real):
            def decode(lat):
                seen[key] = lat.cpu()
                seen[key + "_raw"] = real(lat)
                return seen[key + "_raw"]
            return decode

        for key, m in (("card", card_m), ("cpu", cpu_m)):
            m.decode_latents = keep(key, m.decode_latents)
        t_b = time.perf_counter()
        seen["cpu_wav"] = cpu_m.generate_speech(
            VV_TEXT, frame_noise=noise, frame_log=logs["cpu"]).samples
        seen["card_wav"] = card_m.generate_speech(
            VV_TEXT, frame_noise=noise, frame_log=logs["card"],
            frame_latents=[e["latent"] for e in logs["cpu"]]).samples
        torch.cuda.synchronize()
        lat, want = seen["card"], seen["cpu"]
        check(lat.shape == want.shape and len(logs["card"]) == len(
            logs["cpu"]), f"21(b): frames {lat.shape} against {want.shape}")
        # the CPU's run decoded `want` itself: the card decodes the same
        same_in = seen["cpu_raw"]
        same_in_card = card_m.decode_latents(want.cuda()).cpu()
        stops = {}
        for key, m in (("card", card_m), ("cpu", cpu_m)):
            m.params["eos"]["fc2"]["bias"].fill_(10.0)
            m.generate_speech(VV_TEXT, frame_noise=noise)
            stops[key] = m.stats["frames"]
        torch.cuda.synchronize()
        took = time.perf_counter() - t_b
    wav, want_wav = seen["card_wav"], seen["cpu_wav"]

    def worst(field):
        ref = torch.stack([e[field] for e in logs["cpu"]])
        got = torch.stack([e[field] for e in logs["card"]])
        errs = (got - ref).abs().flatten(1).max(1).values / ref.abs().max()
        return float(errs.max()), int(errs.argmax())

    eos_err = [abs(a["eos"] - b["eos"])
               for a, b in zip(logs["card"], logs["cpu"])]
    eos_p = [e["eos"] for e in logs["cpu"]]
    out = {"frames": lat.shape[1],
           "text_windows": -(-len(cpu_m._encode_text(VV_TEXT)) // 5),
           "cond_rel": worst("cond"), "latent_rel": worst("latent"),
           "eos_abs": max(eos_err), "eos_range": (min(eos_p), max(eos_p)),
           "stops": stops,
           "vae_rel": float((same_in_card - same_in).abs().max()
                            / same_in.abs().max()),
           "wav_rel": float(np.abs(wav - want_wav).max()
                            / np.abs(want_wav).max())}
    print(f"21(b) realtime 0.5B widths cut to base {VV_CUT['base_layers']} "
          f"+ TTS {VV_CUT['tts_layers']} layers, f32 card vs CPU (TF32 "
          f"off), the card teacher-forced with the CPU's latents: "
          f"{out['frames']} frames on both over {out['text_windows']} text "
          f"windows; worst frame's max rel err: condition "
          f"{out['cond_rel'][0]:.2e} (frame {out['cond_rel'][1] + 1}), "
          f"latent {out['latent_rel'][0]:.2e} (frame "
          f"{out['latent_rel'][1] + 1}), EOS probability abs "
          f"{out['eos_abs']:.2e} (p {out['eos_range'][0]:.4f}-"
          f"{out['eos_range'][1]:.4f}), all tol {VV_FRAME_TOL}; the VAE decoder on "
          f"the same latents {out['vae_rel']:.2e} (tol {VV_FRAME_TOL}); the "
          f"waveforms {out['wav_rel']:.2e} (tol {VV_WAV_TOL}); EOS bias "
          f"raised: stops after {stops['card']} frames on the card, "
          f"{stops['cpu']} on the CPU; {took:.1f} s; on {card}", flush=True)
    check(out["cond_rel"][0] < VV_FRAME_TOL
          and out["latent_rel"][0] < VV_FRAME_TOL
          and out["eos_abs"] < VV_FRAME_TOL and out["vae_rel"] < VV_FRAME_TOL
          and out["wav_rel"] < VV_WAV_TOL
          and stops["card"] == stops["cpu"] == 3,
          f"21(b): card vs CPU {out}")
    return out


def _vv_cli(card: str, workdir: str) -> dict:
    """21(c): the realtime 0.5B's widths cut to VV_CUT, seeded in bf16,
    written as a checkpoint directory with a byte-level BPE tokenizer
    (bench/synth_vibevoice.py) and spoken by `cli tts DIR`: the WAV's
    header parses and its bytes equal the in-memory model's."""
    import torch
    from cake_tpu_torch import cli
    from cake_tpu_torch.bench.synth_flux2 import qwen_tokenizer
    from cake_tpu_torch.bench.synth_vibevoice import \
        write_vibevoice_checkpoint
    from cake_tpu_torch.models.audio import (VibeVoiceTTS,
                                             realtime_0_5b_config)
    from cake_tpu_torch.utils.bpe import JsonTokenizer
    from cake_tpu_torch.utils.wav import decode_wav
    cfg = realtime_0_5b_config(**VV_CUT)
    seeded = VibeVoiceTTS(cfg, dtype=torch.bfloat16, seed=22, device="cuda")
    seeded.tokenizer = JsonTokenizer(qwen_tokenizer(cfg.lm_base.vocab_size))
    d = os.path.join(workdir, "vibevoice_cut")
    t = time.perf_counter()
    n = write_vibevoice_checkpoint(d, seeded)
    write_s = time.perf_counter() - t
    wav = os.path.join(workdir, "speech.wav")
    t = time.perf_counter()
    rc = cli.main(["tts", d, VV_TEXT, "--out", wav, "--frames",
                   str(VV_CLI_FRAMES)])
    tts_s = time.perf_counter() - t
    with open(wav, "rb") as f:
        data = f.read()
    samples, rate = decode_wav(data)
    want = seeded.generate_speech(VV_TEXT, max_frames=VV_CLI_FRAMES)
    same = data == want.wav_bytes()
    print(f"21(c) `cli tts DIR` on the realtime 0.5B's widths at base "
          f"{VV_CUT['base_layers']} + TTS {VV_CUT['tts_layers']} layers "
          f"({n / GB:.3f} GB written in {write_s:.1f} s): exit {rc}, "
          f"{len(samples)} samples at {rate} Hz ({len(samples) // cfg.hop} "
          f"frames) in {tts_s:.1f} s with the load; the WAV equals the "
          f"in-memory model's byte for byte {same}; on {card}", flush=True)
    check(rc == 0 and rate == cfg.sample_rate and samples.size > 0
          and samples.size % cfg.hop == 0, "21(c): a bad WAV")
    check(same, "21(c): the CLI's WAV differs from the in-memory model's")
    shutil.rmtree(d, ignore_errors=True)
    return {"write_s": write_s, "tts_s": tts_s}


def phase_tts(card: str, workdir: str) -> dict:
    """21. VibeVoice (module 14d, first part): (a) served at the realtime
    0.5B's widths, (b) card vs CPU in float32 at a cut depth, (c) `cli
    tts` on a written directory. No hand-written kernel runs: the LMs run
    the masked attention path (flash off), as the reference's do."""
    import torch
    t0 = time.perf_counter()
    out = {"served": _vv_served(card, workdir)}
    gc.collect()
    torch.cuda.empty_cache()
    out["parity"] = _vv_parity(card)
    gc.collect()
    torch.cuda.empty_cache()
    out["cli"] = _vv_cli(card, workdir)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 21 in {time.perf_counter() - t0:.0f} s", flush=True)
    return out


LUX_TEXT = "Hello from the card, in a seeded flow."    # 39 frames
LUX_CUT = dict(text_encoder_num_layers=1, fm_decoder_num_layers=(1,) * 5,
               vocos_layers=2)                  # 22(b), 22(c)
LUX_STEPS = 10          # the speech endpoint's default Euler steps
LUX_TOL = 1e-4          # f32 card vs CPU: the text condition, x after each
                        # Euler step, and the vocoder's log-magnitude and
                        # phase on the same input (sum order only)
# the two runs' waveforms: exp(log-magnitude) and cos / sin of the phase
# carry the vocoder's 1e-4 (of the largest phase, a few radians) into
# every overlap-added frame
LUX_WAV_TOL = 1e-3


def _dispatched_ops(fn) -> tuple[int, object]:
    """(aten operations dispatched by fn(), its result): a velocity
    evaluation's count of eager operations, views included; each
    non-view one is a kernel launch on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return Count.n, out


def _lux_served(card: str, workdir: str) -> dict:
    """22(a): LuxTTS at the published widths, seeded in bf16 on the card,
    written by bench/synth_luxtts.py (trunk bf16, Vocos float32) and served
    by `cli serve --flagship --layers 1 --slots 0 --audio-model DIR`: a WAV,
    a PCM and a voice_b64 clone of a 1 s 16 kHz WAV over HTTP."""
    import base64
    import numpy as np
    import torch
    from cake_tpu_torch import cli
    from cake_tpu_torch.bench.synth_luxtts import write_luxtts_checkpoint
    from cake_tpu_torch.models.audio import LuxTTS, LuxTTSConfig
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.utils.mapping import flatten_tree
    from cake_tpu_torch.utils.wav import decode_wav, encode_wav
    d = os.path.join(workdir, "luxtts")
    t = time.perf_counter()
    seeded = LuxTTS(LuxTTSConfig(), dtype=torch.bfloat16, seed=22,
                    device="cuda")
    written = write_luxtts_checkpoint(d, seeded)
    write_s = time.perf_counter() - t
    del seeded
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args = cli.parser().parse_args(
        ["serve", "--flagship", "--layers", "1", "--slots", "0", "--port",
         "0", "--audio-model", d])
    t0 = time.perf_counter()
    app = cli.build_server(args).start()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = app.state.audio_model
    cfg = model.cfg
    widths = (cfg.text_encoder_dim, cfg.text_encoder_num_layers,
              cfg.text_encoder_feedforward_dim, cfg.text_encoder_num_heads,
              cfg.text_encoder_cnn_module_kernel, cfg.fm_decoder_dim,
              cfg.fm_decoder_feedforward_dim, cfg.fm_decoder_num_heads,
              cfg.fm_decoder_num_layers, cfg.fm_decoder_downsampling_factor,
              cfg.fm_decoder_cnn_module_kernel, cfg.query_head_dim,
              cfg.value_head_dim, cfg.pos_head_dim, cfg.pos_dim,
              cfg.time_embed_dim, cfg.vocos_dim, cfg.vocos_layers,
              cfg.vocos_kernel, cfg.n_fft, cfg.hop_length, cfg.n_mels,
              cfg.sample_rate)
    check(type(model).__name__ == "LuxTTS" and widths == (
        192, 4, 512, 4, 9, 512, 1536, 4, (2, 2, 4, 4, 4), (1, 2, 4, 2, 1),
        (31, 15, 7, 15, 31), 32, 12, 4, 48, 192, 512, 8, 7, 1024, 256, 100,
        24000), f"22(a): not LuxTTS's published widths: {widths}")
    p = model.params
    check(p["embed"]["weight"].dtype == torch.bfloat16
          and p["vocos"]["embed"]["weight"].dtype == torch.float32,
          "22(a): the trunk is not bf16 or the Vocos not float32")
    n_params = sum(t.numel() for t in flatten_tree(p).values())
    parts = {"trunk_bf16": _tree_bytes({k: v for k, v in p.items()
                                        if k != "vocos"}),
             "vocos_f32": _tree_bytes(p["vocos"]),
             "flagship_1_layer": _tree_bytes(app.state.model.params)}
    held = torch.cuda.memory_allocated() - base
    reckoned = sum(parts.values())
    print(f"22(a) LuxTTS published widths ({n_params / 1e6:.1f} M "
          f"parameters) seeded in bf16 and written in {write_s:.1f} s "
          f"({written / GB:.3f} GB), served by `cli serve --audio-model "
          f"DIR` built in {build_s:.1f} s; device memory {held / GB:.3f} GB "
          f"held against {reckoned / GB:.3f} GB of parameters "
          f"({', '.join(f'{k} {b / GB:.3f}' for k, b in parts.items())} "
          f"GB); on {card}", flush=True)
    check(reckoned <= held <= reckoned + 0.5 * GB,
          f"22(a): {held / GB:.3f} GB held for {reckoned / GB:.3f} GB")
    clone = encode_wav(0.5 * np.sin(np.arange(16000) * 2 * np.pi * 220
                                    / 16000).astype(np.float32), 16000)
    requests = (("wav", {}), ("pcm", {"response_format": "pcm"}),
                ("voice_b64 clone",
                 {"voice_b64": base64.b64encode(clone).decode()}))
    flash_before = dict(flash.launch_counts())
    readings, bodies = {}, {}
    try:
        for name, extra in requests:
            status, ctype, raw, wall = _vv_post(app.url, {"input": LUX_TEXT,
                                                          **extra})
            check(status == 200, f"22(a) {name}: HTTP {status}")
            if name == "pcm":
                check(ctype == "application/octet-stream",
                      f"22(a) pcm: {ctype}")
                samples = np.frombuffer(raw, "<i2")
            else:
                check(ctype == "audio/wav", f"22(a) {name}: {ctype}")
                samples, rate = decode_wav(raw)
                check(rate == 2 * cfg.sample_rate,
                      f"22(a) {name}: rate {rate}")
            st = dict(model.stats)
            audio_s = len(samples) / (2 * cfg.sample_rate)
            gen_s = st["encode_s"] + st["fm_s"] + st["vocos_s"] + \
                st["istft_s"]
            r = readings[name] = {
                "frames": st["frames"], "steps": st["steps"],
                "encode_s": st["encode_s"], "s_per_eval": st["s_per_eval"],
                "vocos_s": st["vocos_s"], "istft_s": st["istft_s"],
                "gen_s": gen_s, "audio_s": audio_s, "rtf": gen_s / audio_s,
                "wall_s": wall}
            bodies[name] = raw
            print(f"22(a) {name}: {r['frames']} frames ({audio_s:.2f} s of "
                  f"48 kHz audio), {r['steps']} velocity evaluations at "
                  f"{r['s_per_eval']:.4f} s each, text encoder "
                  f"{r['encode_s']:.4f} s, vocoder {r['vocos_s']:.4f} s, "
                  f"host ISTFT and resampling {r['istft_s']:.4f} s, "
                  f"real-time factor {r['rtf']:.3f}, request {wall:.2f} s; "
                  f"{len(raw)} bytes; on {card}", flush=True)
            check(st["frames"] >= 3 and st["steps"] == LUX_STEPS
                  and len(samples) == 2 * st["frames"] * cfg.hop_length
                  and np.isfinite(samples.astype(np.float32)).all()
                  and np.abs(samples.astype(np.float32)).max() > 0,
                  f"22(a) {name}: {st['frames']} frames, {len(samples)} "
                  f"samples")
    finally:
        app.stop()
    check(bodies["pcm"] == bodies["wav"][44:],
          "22(a): the PCM answer is not the WAV's data chunk (same seed)")
    check(bodies["voice_b64 clone"] != bodies["wav"],
          "22(a): the cloned voice did not change the audio")
    check(flash.launch_counts() == flash_before,
          "22(a): the speech path launched the flash kernel")
    from cake_tpu_torch.models.audio.luxtts import fm_velocity
    frames = readings["wav"]["frames"]
    x = torch.randn((1, frames, cfg.feat_dim)).to(model.device,
                                                  model.dtype)
    with torch.inference_mode():
        ops, _ = _dispatched_ops(lambda: fm_velocity(cfg, p, x, x, x, 0.5))
    readings["ops_per_eval"] = ops
    print(f"22(a) one velocity evaluation at {frames} frames dispatches "
          f"{ops} eager aten operations (views included); on {card}",
          flush=True)
    shutil.rmtree(d, ignore_errors=True)
    return readings


def _lux_parity(card: str) -> dict:
    """22(b): the published widths cut to LUX_CUT, float32 with TF32 off,
    seeded on the card and copied to the CPU: the served sentence from
    the same noise on both, LUX_STEPS Euler steps."""
    import numpy as np
    import torch
    from cake_tpu_torch.models.audio import LuxTTS, LuxTTSConfig
    cfg = LuxTTSConfig(**LUX_CUT)

    def rel(got, want) -> float:
        got, want = got.float().cpu(), want.float().cpu()
        check(got.shape == want.shape,
              f"22(b): shapes {tuple(got.shape)} and {tuple(want.shape)}")
        return float((got - want).abs().max() / want.abs().max())

    t_b = time.perf_counter()
    with _TF32(False, False):
        card_m = LuxTTS(cfg, dtype=torch.float32, seed=23, device="cuda")
        cpu_m = LuxTTS(cfg, params=_to_device(card_m.params, "cpu"),
                       dtype=torch.float32, device="cpu")
        frames = len(cpu_m.phonemizer.tokenize(LUX_TEXT))
        noise = torch.randn((1, frames, cfg.feat_dim),
                            generator=torch.Generator().manual_seed(22))
        models = {"card": card_m, "cpu": cpu_m}
        vocode = {k: m.vocode for k, m in models.items()}
        text = {k: m.encode_text(LUX_TEXT) for k, m in models.items()}
        steps = {k: [] for k in models}
        wav = {k: m.generate_speech(LUX_TEXT, steps=LUX_STEPS, noise=noise,
                                    step_log=steps[k]).samples
               for k, m in models.items()}
        x_cpu = steps["cpu"][-1]
        voc = {k: vocode[k](x_cpu.to(m.device)) for k, m in models.items()}
        torch.cuda.synchronize()
    took = time.perf_counter() - t_b
    check(len(steps["card"]) == len(steps["cpu"]) == LUX_STEPS,
          "22(b): not every Euler step logged")
    per_step = [rel(a, b) for a, b in zip(steps["card"], steps["cpu"])]
    out = {"frames": frames, "steps": LUX_STEPS,
           "text_rel": rel(text["card"], text["cpu"]),
           "x_rel": max(per_step), "x_worst_step": per_step.index(
               max(per_step)) + 1,
           "log_mag_rel": rel(voc["card"][0], voc["cpu"][0]),
           "phase_rel": rel(voc["card"][1], voc["cpu"][1]),
           "wav_rel": float(np.abs(wav["card"] - wav["cpu"]).max()
                            / np.abs(wav["cpu"]).max()),
           "seconds": took}
    print(f"22(b) published widths cut to text encoder "
          f"{LUX_CUT['text_encoder_num_layers']} layer, FM stacks 1-1-1-1-1 "
          f"and Vocos {LUX_CUT['vocos_layers']} layers, f32 card vs CPU "
          f"(TF32 off), {frames} frames from the same noise: max rel err "
          f"text condition {out['text_rel']:.2e}, x after each of "
          f"{LUX_STEPS} Euler steps {out['x_rel']:.2e} (worst at step "
          f"{out['x_worst_step']}), the vocoder on the same input: "
          f"log-magnitude {out['log_mag_rel']:.2e}, phase "
          f"{out['phase_rel']:.2e}, all tol {LUX_TOL}; the waveforms "
          f"{out['wav_rel']:.2e} (tol {LUX_WAV_TOL}); {took:.1f} s; on "
          f"{card}", flush=True)
    check(out["text_rel"] < LUX_TOL and out["x_rel"] < LUX_TOL
          and out["log_mag_rel"] < LUX_TOL and out["phase_rel"] < LUX_TOL
          and out["wav_rel"] < LUX_WAV_TOL, f"22(b): card vs CPU {out}")
    return out


def _lux_cli(card: str, workdir: str) -> dict:
    """22(c): the cut of 22(b) seeded in bf16, written with a tokens.txt
    (bench/synth_luxtts.py) and spoken by `cli tts DIR`: the WAV's header
    parses and its bytes equal the in-memory model's on the card."""
    import torch
    from cake_tpu_torch import cli
    from cake_tpu_torch.bench.synth_luxtts import write_luxtts_checkpoint
    from cake_tpu_torch.models.audio import LuxTTS, LuxTTSConfig, Phonemizer
    from cake_tpu_torch.utils.wav import decode_wav
    cfg = LuxTTSConfig(**LUX_CUT)
    seeded = LuxTTS(cfg, dtype=torch.bfloat16, seed=24, device="cuda")
    d = os.path.join(workdir, "luxtts_cut")
    t = time.perf_counter()
    n = write_luxtts_checkpoint(d, seeded)
    write_s = time.perf_counter() - t
    seeded.phonemizer = Phonemizer(os.path.join(d, "tokens.txt"),
                                   vocab_size=cfg.vocab_size)
    wav = os.path.join(workdir, "luxtts.wav")
    t = time.perf_counter()
    rc = cli.main(["tts", d, LUX_TEXT, "--out", wav])
    tts_s = time.perf_counter() - t
    with open(wav, "rb") as f:
        data = f.read()
    samples, rate = decode_wav(data)
    want = seeded.generate_speech(LUX_TEXT)
    frames = seeded.stats["frames"]
    same = data == want.wav_bytes()
    print(f"22(c) `cli tts DIR` on the cut ({n / GB:.3f} GB written in "
          f"{write_s:.1f} s): exit {rc}, {len(samples)} samples at {rate} Hz "
          f"({frames} frames) in {tts_s:.1f} s with the load; the WAV "
          f"equals the in-memory model's byte for byte {same}; on {card}",
          flush=True)
    check(rc == 0 and rate == 2 * cfg.sample_rate
          and samples.size == 2 * frames * cfg.hop_length, "22(c): a bad WAV")
    check(same, "22(c): the CLI's WAV differs from the in-memory model's")
    shutil.rmtree(d, ignore_errors=True)
    return {"write_s": write_s, "tts_s": tts_s}


def phase_luxtts(card: str, workdir: str) -> dict:
    """22. LuxTTS (module 14d's remainder): (a) served at the published
    widths, (b) card vs CPU in float32 at a cut depth, (c) `cli tts` on a
    written directory. No hand-written kernel runs: Zipformer attention,
    the depthwise convolutions and the GEMMs are plain PyTorch, as the
    reference's are plain XLA."""
    import torch
    t0 = time.perf_counter()
    out = {"served": _lux_served(card, workdir)}
    gc.collect()
    torch.cuda.empty_cache()
    out["parity"] = _lux_parity(card)
    gc.collect()
    torch.cuda.empty_cache()
    out["cli"] = _lux_cli(card, workdir)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 22 in {out['seconds']:.0f} s", flush=True)
    return out



# -- phase 23: the fleet (modules 15a and 15b) --------------------------------

FLEET_KEY = "chip-smoke-fleet"
# router settings of phase 23: (b)'s shed bounds, a probe period short
# enough that (c)'s dead replica is swept within the phase, and the closed
# loop: two replicas (r1 static, the rest spawned from
# CAKE_SCALE_SPAWN_CMD). r1 is still building when the router starts, so
# the default policy ejects it (3 failed probes) until it serves; the
# ceiling of 2 keeps the below-min rule from spawning a second replica in
# its place meanwhile. The long cooldown leaves the below-min rule (which
# ignores it) as the only action.
FLEET_ENV = {"CAKE_FLEET_REPLICA_INFLIGHT": "1", "CAKE_FLEET_MAX_INFLIGHT": "2",
             "CAKE_FLEET_PROBE_S": "0.5", "CAKE_KVSHARE": "1",
             "CAKE_SCALE_MIN": "2", "CAKE_SCALE_MAX": "2",
             "CAKE_SCALE_COOLDOWN_S": "600"}
# the one prefix-fetch deadline of the phase (the reference's default)
FLEET_FETCH_TIMEOUT_S = "2.0"


def _fleet_head(k: int) -> list[dict]:
    """Conversation k's head: a ~600-token system message of its own (phase
    6(b)'s, told apart by its first line) and its first question."""
    return [{"role": "system", "content": f"Desk {k}. {SYSTEM}"},
            {"role": "user", "content": f"question {k}: which card serves "
             f"desk {k}, and at what power limit?"}]


def _fleet_owner(msgs: list[dict], names: list[str]) -> list[str]:
    from cake_tpu_torch.fleet import (affinity_key, conversation_head,
                                      rank_replicas)
    return rank_replicas(affinity_key(conversation_head(msgs), 64), names)


def _sse_chat(url: str, body: dict, on_event=None, timeout: float = 300,
              headers: dict | None = None):
    """POST a streamed chat and read its SSE events as they arrive: (status,
    headers, [(seconds since the send, payload)]). `on_event(events)` runs
    after each event."""
    import http.client
    from urllib.parse import urlsplit
    u = urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    events = []
    try:
        if resp.status != 200:
            return resp.status, dict(resp.headers), [(0.0, resp.read())]
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.decode("utf-8", "replace").strip()
            if not line.startswith("data: "):
                continue
            events.append((time.perf_counter() - t0, line[6:]))
            if on_event is not None:
                on_event(events)
    finally:
        conn.close()
    return resp.status, dict(resp.headers), events


def _sse_text(events) -> tuple[str, int, float | None]:
    """(content, content events, seconds to the first content event)."""
    text, n, first = "", 0, None
    for t, payload in events:
        if payload == "[DONE]":
            continue
        delta = json.loads(payload)["choices"][0]["delta"]
        if delta.get("content"):
            text += delta["content"]
            n += 1
            first = t if first is None else first
    return text, n, first


def _get_json(url: str, timeout: float = 30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _metric(text: str, prefix: str) -> float:
    """The value of one series of a /metrics text (0 when absent)."""
    for line in text.splitlines():
        if line.startswith(prefix + " "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def _metrics(url: str) -> str:
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        return r.read().decode()


def _router_trace(router: str, rid: str) -> dict:
    """The router's stitched timeline: {"router": events, "replica": the
    replica tier's events, "landed": the replica the router committed or
    finished on}."""
    body = _get_json(f"{router}/api/v1/requests/{rid}")
    tiers = body["tiers"]
    own = next(t for t in tiers if t.get("tier") == "router")
    landed = [e["replica"] for e in own["events"]
              if e["kind"] in ("commit", "attempt") and e.get("replica")]
    replica = [t for t in tiers if t.get("tier") != "router"]
    return {"router": own["events"], "replica":
            replica[0]["events"] if replica else [], "landed": landed}


def _spawn_fleet(args: list[str], log_path: str, env=None):
    log = open(log_path, "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cake_tpu_torch.cli", *args],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, **(env or {})), stdout=log,
        stderr=subprocess.STDOUT)
    log.close()
    return proc


def _wait_http(url: str, proc, log_path: str, label: str,
               timeout: float = 240) -> None:
    deadline = time.perf_counter() + timeout
    while True:
        try:
            with urllib.request.urlopen(url + "/health", timeout=2):
                return
        except urllib.error.HTTPError:
            return                  # answering (503: nothing routable yet)
        except OSError:
            pass
        if proc.poll() is not None:
            with open(log_path, errors="replace") as f:
                tail = f.read()[-3000:]
            check(False, f"23: {label} exited ({proc.returncode}): {tail}")
        check(time.perf_counter() < deadline, f"23: {label} never answered")
        time.sleep(0.1)


def _fleet_serve_args() -> list[str]:
    """The replica the lifecycle spawns: `cli serve --announce` of the
    flagship, paged ({port} and {name} filled per spawn)."""
    return ["serve", "--flagship", "--host", "127.0.0.1", "--port", "{port}",
            "--kv-blocks", "1024", "--kv-block-tokens", "16", "--announce",
            "--cluster-key", FLEET_KEY, "--announce-name", "{name}"]


def _autoscale_events(router: str, kind: str, name: str | None = None,
                      timeout: float = 240, proc=None, log_path=None
                      ) -> list[dict]:
    """The router's decisions ring once it holds a `kind` event (for
    replica `name` when given)."""
    deadline = time.perf_counter() + timeout
    while True:
        ring = _get_json(router + "/api/v1/fleet/autoscale")["decisions"]
        if any(e["kind"] == kind and (name is None
                                      or e.get("replica") == name)
               for e in ring):
            return ring
        if proc is not None and proc.poll() is not None:
            with open(log_path, errors="replace") as f:
                tail = f.read()[-3000:]
            check(False, f"23: the router exited ({proc.returncode}): "
                  f"{tail}")
        check(time.perf_counter() < deadline,
              f"23: no {kind} {name or ''} on the decisions ring: "
              f"{json.dumps(ring)[-1500:]}")
        time.sleep(0.2)


def _managed(router: str) -> dict:
    """name -> the lifecycle's view of each replica it manages."""
    snap = _get_json(router + "/api/v1/fleet/autoscale")
    return {m["name"]: m for m in snap["lifecycle"]["managed"]}


def _second_router(r0: str, url0: str, url1: str):
    """A FleetRouter in this process, served on a thread of its own, whose
    registry holds r0 and r1 as static replicas under the default
    membership policy: (f) reads its KV directory, (c) and (d) its
    ejection of the dead r0. Returns (router, its URL, probe, stop):
    probe() runs one probe cycle on its loop, stop() ends it."""
    import asyncio
    from cake_tpu_torch.fleet import (FleetRouter, ReplicaRegistry,
                                      create_router_app)
    registry = ReplicaRegistry()
    registry.add(r0, url0)
    registry.add("r1", url1)
    router = FleetRouter(registry, kvshare=True, autoscale=False,
                         probe_s=600.0)
    app = create_router_app(router)
    loop = asyncio.new_event_loop()
    th = threading.Thread(target=loop.run_forever, daemon=True)
    th.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(60)
    host, port = run(app.start("127.0.0.1", 0))

    def stop():
        try:
            run(app.stop())
        finally:
            loop.call_soon_threadsafe(loop.stop)
            th.join(10)
    return (router, f"http://{host}:{port}",
            lambda: run(router._probe_once()), stop)


def _fleet_fetch(card: str, r0: str, url0: str, r1, url1: str, names,
                 second, probe, out: dict) -> None:
    """23(f): a prefix chain warmed on r0 is fetched by cold r1, with the
    directory the second router builds for r1."""
    import torch
    from cake_tpu_torch.fleet.kvshare import KV_DIR_HEADER
    from cake_tpu_torch.obs import FLEET_KV_FETCHES
    from cake_tpu_torch.ops import flash
    k = next(k for k in range(400, 600)
             if _fleet_owner(_fleet_head(k), names)[0] == r0)
    msgs = _fleet_head(k)
    status, _, ev = _sse_chat(url0, {"messages": msgs, "temperature": 0,
                                     "max_tokens": 32, "stream": True})
    check(status == 200, f"23f: warming chat on {r0}: HTTP {status}")
    follow = msgs + [{"role": "assistant", "content": _sse_text(ev)[0]},
                     {"role": "user", "content": "and then?"}]
    body = {"messages": follow, "temperature": 0, "max_tokens": 32,
            "stream": True}
    status, _, ev0 = _sse_chat(url0, body)
    check(status == 200, f"23f: {r0}'s direct follow-up: HTTP {status}")
    want = _sse_text(ev0)[0]
    # the router's registry mirror: probed until r0's chain of the
    # follow-up shows in its inventory (the directory the router sends)
    ids = r1.engine.model.tokenizer.chat_prompt_ids(follow)
    pc = r1.engine.prefix_cache
    keys = [h.hex() for h in pc.chain_keys(ids)]
    registry = second.registry
    deadline = time.perf_counter() + 30
    while keys[-1] not in registry.get(r0).kv_inventory():
        check(time.perf_counter() < deadline, f"23f: {r0}'s chain never "
              f"reached the registry mirror: "
              f"{registry.get(r0).kv_inventory()[:4]}")
        time.sleep(0.2)
        probe()
    directory = second._kv_peers(registry.get("r1"))
    check(directory is not None and url0 in directory,
          f"23f: the directory for r1 does not name {r0}: {directory}")
    hits0 = FLEET_KV_FETCHES.value(outcome="hit")
    torch.cuda.synchronize()
    app0 = flash.launch_counts()["bf16"]["append"]
    status, hdrs, ev1 = _sse_chat(url1, body,
                                  headers={KV_DIR_HEADER: directory})
    check(status == 200, f"23f: r1's fetched follow-up: HTTP {status}")
    got, _, ttft_fetch = _sse_text(ev1)
    torch.cuda.synchronize()
    appended = flash.launch_counts()["bf16"]["append"] - app0
    rid = hdrs["X-Cake-Request-Id"]
    tl = _get_json(f"{url1}/api/v1/requests/{rid}")["events"]
    hit = max([e.get("hit_tokens", 0) for e in tl
               if e["kind"] == "prefill_done"] or [0])
    fetched = [e for e in tl if e["kind"] == "kv_fetch"]
    # a hit's event carries the fetch's phases
    split = fetched[0] if fetched else {}
    check(FLEET_KV_FETCHES.value(outcome="hit") == hits0 + 1
          and fetched and fetched[0]["outcome"] == "hit",
          f"23f: the fetch did not hit: {fetched} {split} (deadline "
          f"{FLEET_FETCH_TIMEOUT_S} s)")
    check(got == want, "23f: r1's fetched answer differs from "
          f"{r0}'s direct answer")
    check(hit > 0 and hit == split.get("tokens"),
          f"23f: r1 spliced {hit} prompt tokens, the fetch installed "
          f"{split.get('tokens')}")
    chunks = -(-(len(ids) - hit) // r1.engine.chunk)
    layers = r1.engine.model.cfg.num_hidden_layers
    check(appended == chunks * layers, f"23f: {appended} flash append "
          f"launches on r1, not {chunks} suffix chunks x {layers} layers")
    # the same shape, cold: a fresh conversation's follow-up on r1
    cold = _fleet_head(k + 1000) + follow[2:]
    status, _, evc = _sse_chat(url1, dict(body, messages=cold))
    check(status == 200, f"23f: r1's cold follow-up: HTTP {status}")
    out["kvshare"] = {
        "prompt_tokens": len(ids), "fetched_tokens": hit,
        "suffix_chunks": chunks, "flash_append_launches": appended,
        "blob_bytes": split.get("bytes"),
        # export and encode on the peer, wire = the GET's time less
        # them, decode and install here
        "fetch_ms": {x: split.get(x) for x in (
            "export_ms", "encode_ms", "wire_ms", "get_ms", "decode_ms",
            "install_ms", "total_ms")},
        "ttft_ms_fetched": round(ttft_fetch * 1e3, 3),
        "ttft_ms_cold": round(_sse_text(evc)[2] * 1e3, 3),
        "fetch_timeout_s": float(FLEET_FETCH_TIMEOUT_S)}
    print(f"23(f): r1 fetched {hit} of {len(ids)} prompt tokens from {r0} "
          f"({split.get('bytes')} blob bytes), answered equal to {r0}, "
          f"{appended} flash append launches; fetch "
          f"{out['kvshare']['fetch_ms']} ms, TTFT "
          f"{out['kvshare']['ttft_ms_fetched']} ms fetched against "
          f"{out['kvshare']['ttft_ms_cold']} ms cold on {card}", flush=True)


def phase_fleet(card: str, workdir: str) -> dict:
    """Phase 23: the fleet router (module 15a) with its KV-share tier and
    closed loop (module 15b) in front of flagship replicas on the one card:
    r1 in this process, r0 and its replacement r2 spawned by the router's
    lifecycle; returns the phase's readings."""
    import signal
    import torch
    from cake_tpu_torch.fleet import discover_replicas
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops import paged_attention as pa
    t_phase = time.perf_counter()
    out = {}
    procs = []
    children = []           # the replicas the router spawned (pids)
    r1 = None
    router = None
    stop_second = None
    saved = {k: os.environ.get(k) for k in ("CAKE_KVSHARE",
                                            "CAKE_KVSHARE_FETCH_TIMEOUT_S")}
    os.environ["CAKE_KVSHARE"] = "1"
    os.environ["CAKE_KVSHARE_FETCH_TIMEOUT_S"] = FLEET_FETCH_TIMEOUT_S
    try:
        # (0) the router first, with r1 (this process, not up yet) static
        # and the closed loop on: the below-min rule spawns r0 in its first
        # cycle, whose start-up overlaps r1's build here
        p1, pr = _free_port(), _free_port()
        url1 = f"http://127.0.0.1:{p1}"
        router = f"http://127.0.0.1:{pr}"
        logr = os.path.join(workdir, "router.log")
        spawn = " ".join([sys.executable, "-m", "cake_tpu_torch.cli",
                          *_fleet_serve_args()])
        t0 = time.perf_counter()
        rp = _spawn_fleet(["route", "--host", "127.0.0.1", "--port",
                           str(pr), "--replica", f"r1={url1}",
                           "--autoscale"], logr,
                          dict(FLEET_ENV, CAKE_SCALE_SPAWN_CMD=spawn,
                               CAKE_KVSHARE_FETCH_TIMEOUT_S=
                               FLEET_FETCH_TIMEOUT_S))
        procs.append(rp)
        from cake_tpu_torch.api import create_app
        from cake_tpu_torch.cli import build_flagship
        from cake_tpu_torch.serve import ServeEngine
        model = build_flagship(layers=None, dtype="bf16", seed=0,
                               device="cuda")
        r1 = Served(create_app(model, ServeEngine(
            model, slots=4, ctx_len=4096, kv_blocks=1024,
            kv_block_tokens=16), model.tokenizer, port=p1).start())
        check(r1.app.state.kvshare is not None, "23: r1 has no KV-share "
              "agent with CAKE_KVSHARE=1")
        _wait_http(router, rp, logr, "the router (cli route)")
        ring = _autoscale_events(router, "admitted", proc=rp, log_path=logr)
        kinds = [e["kind"] for e in ring]
        spawned = next(e for e in ring if e["kind"] == "spawned")
        admitted = next(e for e in ring if e["kind"] == "admitted")
        r0 = spawned["replica"]
        check(kinds.index("scale_out") < kinds.index("spawned")
              < kinds.index("admitted")
              and ring[kinds.index("scale_out")]["reason"] == "below_min"
              and admitted["replica"] == r0,
              f"23(0): the ring reads {json.dumps(ring)[-1200:]}")
        url0 = f"http://127.0.0.1:{spawned['port']}"
        check(_health(url0)[0] == 200, f"23(0): {r0} admitted but its "
              "/health is not 200")
        found = discover_replicas(FLEET_KEY, timeout=2.0, expected=1,
                                  addresses=["127.0.0.1"])
        check((r0, url0) in found, f"23(0): discovery found {found}, not "
              f"{r0} at {url0} with role serve")
        names = sorted([r0, "r1"])
        # r1 failed its probes while it built: the default policy ejected
        # it, and readmits it through half-open now that it serves
        deadline = time.perf_counter() + 30
        while True:
            row = next(r for r in _get_json(router + "/api/v1/fleet")[
                "replicas"] if r["name"] == "r1")
            if row["state"] == "healthy":
                break
            check(time.perf_counter() < deadline, f"23(0): r1 reads {row}")
            time.sleep(0.1)
        ring = _get_json(router + "/api/v1/fleet/autoscale")["decisions"]
        check(row["ejects"] >= 1 and row["readmits"] >= 1
              and [e["kind"] for e in ring].count("spawned") == 1,
              f"23(0): r1 {row}, the ring {json.dumps(ring)[-800:]}")
        out["spawn_to_admit_s"] = admitted["spawn_s"]
        out["startup_s"] = round(time.perf_counter() - t_phase, 3)
        print(f"23(0): the router (`cli route --autoscale`) spawned {r0} "
              f"(below_min), admitted after its /health answered 200, "
              f"{admitted['spawn_s']} s from spawn to admission; r1 serves "
              f"in this process, ejected {row['ejects']}x while it built "
              f"and readmitted; {out['startup_s']} s in", flush=True)
        urls = {r0: url0, "r1": url1}
        torch.cuda.synchronize()
        flash.reset_launches()
        pa.reset_launches()
        # (a) affinity and parity: four two-turn conversations, each head
        # owned by the replica rendezvous names; turn 2 hits its prefix
        heads, k = [], 0
        while len(heads) < 4:
            owner = _fleet_owner(_fleet_head(k), names)[0]
            if sum(h[1] == owner for h in heads) < 2:
                heads.append((k, owner))
            k += 1
        ttft = {"router": [], "direct": []}
        for n, (k, owner) in enumerate(heads):
            msgs = _fleet_head(k)
            for turn in range(2):
                body = {"messages": msgs, "temperature": 0,
                        "max_tokens": 32, "stream": True}
                runs = {}
                for via in (("router", "direct") if n % 2 == 0
                            else ("direct", "router")):
                    status, hdrs, ev = _sse_chat(
                        router if via == "router" else urls[owner], body)
                    check(status == 200 and ev and ev[-1][1] == "[DONE]",
                          f"23a: {via} chat {k}.{turn}: HTTP {status}")
                    runs[via] = _sse_text(ev)
                    ttft[via].append(runs[via][2])
                    if via == "router":
                        rid = hdrs["X-Cake-Request-Id"]
                trace = _router_trace(router, rid)
                check(trace["landed"] == [owner], f"23a: chat {k}.{turn} "
                      f"landed on {trace['landed']}, not its owner {owner}")
                check(runs["router"][0] == runs["direct"][0],
                      f"23a: chat {k}.{turn}: the router's content differs "
                      f"from {owner}'s direct answer")
                if turn == 1:
                    hit = max([e.get("hit_tokens", 0)
                               for e in trace["replica"]
                               if e["kind"] == "prefill_done"] or [0])
                    check(hit > 0, f"23a: turn 2 of chat {k} hit no prefix "
                          f"on {owner}: {trace['replica'][:6]}")
                    out.setdefault("turn2_hit_tokens", []).append(hit)
                msgs = msgs + [{"role": "assistant",
                                "content": runs["router"][0]},
                               {"role": "user", "content": "and then?"}]
        out["owners"] = ["r0" if o == r0 else o for _, o in heads]
        for via in ttft:
            xs = sorted(ttft[via])
            out[f"ttft_p50_ms_{via}"] = round(xs[len(xs) // 2] * 1e3, 3)
        print(f"23(a): 4 conversations x 2 turns on their owners "
              f"{out['owners']}, contents equal direct, turn 2 prefix hits "
              f"{out['turn2_hit_tokens']}; TTFT p50 "
              f"{out['ttft_p50_ms_router']} ms through the router, "
              f"{out['ttft_p50_ms_direct']} ms direct; "
              f"{time.perf_counter() - t_phase:.1f} s in", flush=True)
        # (b) shed: a burst of 6 concurrent chats against the router's
        # bounds (1 in flight per replica, 2 in all)
        answers = [None] * 6

        def fire(i):
            body = {"messages": _fleet_head(100 + i), "temperature": 0,
                    "max_tokens": 64}
            try:
                answers[i] = _post(router, body)
            except urllib.error.HTTPError as e:
                answers[i] = (e.code, dict(e.headers), e.read())
        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        sheds = 0
        for i, a in enumerate(answers):
            check(a is not None, f"23b: chat {i} never answered")
            status, hdrs, raw = a
            if status == 429:
                check(json.loads(raw).get("shed_by") == "router"
                      and hdrs.get("Retry-After"),
                      f"23b: a 429 without shed_by router and Retry-After")
                sheds += 1
            else:
                check(status == 200, f"23b: chat {i}: HTTP {status}")
        check(sheds >= 1, "23b: the burst shed nothing")
        metrics = _metrics(router)
        counted = sum(float(line.rsplit(" ", 1)[1])
                      for line in metrics.splitlines()
                      if line.startswith("cake_fleet_sheds_total"))
        check(counted == sheds, f"23b: /metrics counts {counted} sheds, the "
              f"client saw {sheds} 429s")
        out["burst_429"] = sheds
        print(f"23(b): burst of 6: {sheds} shed 429 by the router, "
              f"/metrics {counted:.0f}; "
              f"{time.perf_counter() - t_phase:.1f} s in", flush=True)
        # (f) prefix fetch: a chain warmed on r0, fetched by cold r1
        second, url_second, probe, stop_second = _second_router(
            r0, url0, url1)
        _fleet_fetch(card, r0, url0, r1, url1, names, second, probe, out)
        # (c) failover mid-stream: r0 SIGKILLed after 8 content events; its
        # blob cannot be fetched (source_miss), the splice onto r1 holds,
        # and the lifecycle's sweep replaces r0
        k = next(k for k in range(200, 400)
                 if _fleet_owner(_fleet_head(k), names)[0] == r0)
        body = {"messages": _fleet_head(k), "temperature": 0,
                "max_tokens": 96, "stream": True}
        pid0 = _managed(router)[r0]["pid"]
        killed = {}
        children.append(pid0)
        miss0 = _metric(_metrics(router), 'cake_fleet_kv_migrations_total'
                        '{outcome="source_miss"}')

        def kill_at_8(events):
            if "t" not in killed and _sse_text(events)[1] >= 8:
                os.kill(pid0, signal.SIGKILL)
                killed["t"] = events[-1][0]
        status, hdrs, ev = _sse_chat(router, body, kill_at_8)
        check("t" in killed and status == 200, f"23c: HTTP {status}, the "
              f"stream never reached 8 content events")
        rid = hdrs["X-Cake-Request-Id"]
        trace = _router_trace(router, rid)
        kinds = [e["kind"] for e in trace["router"]]
        check("stream_broken" in kinds and "resume_spliced" in kinds,
              f"23c: no splice in the router's timeline {kinds}")
        broken = next(e for e in trace["router"]
                      if e["kind"] == "stream_broken")
        spliced = next(e for e in trace["router"]
                       if e["kind"] == "resume_spliced")
        migrate = [e for e in trace["router"] if e["kind"] == "kv_migrate"]
        check(broken["replica"] == r0 and spliced["replica"] == "r1",
              f"23c: broke on {broken['replica']}, resumed on "
              f"{spliced['replica']}")
        check([e["outcome"] for e in migrate] == ["source_miss"],
              f"23c: the migration of a dead source read {migrate}")
        check(ev[-1][1] == "[DONE]" and sum(
            1 for _, p in ev if p != "[DONE]"
            and json.loads(p)["choices"][0]["finish_reason"]) == 1
            and sum(1 for _, p in ev if p == "[DONE]") == 1,
            "23c: the stream did not end in one finish event and one "
            "[DONE]")
        pre, post = ev[:broken["chunks"]], ev[broken["chunks"]:]
        pre_text, pre_n, _ = _sse_text(pre)
        post_text = _sse_text(post)[0]
        metrics = _metrics(router)
        check('cake_fleet_stream_resumes_total{outcome="ok"} 1' in metrics,
              "23c: the router did not count one resumed stream")
        check(_metric(metrics, 'cake_fleet_kv_migrations_total'
                      '{outcome="source_miss"}') == miss0 + 1,
              "23c: /metrics did not count the source_miss")
        cont = {"messages": body["messages"] + [
            {"role": "assistant", "content": pre_text, "continue": True}],
            "temperature": 0, "max_tokens": 96 - pre_n}
        direct = r1.chat(cont)["resp"]["choices"][0]["message"]["content"]
        check(post_text == direct, f"23c: the resumed text differs from "
              f"r1's own continuation of the same partial")
        out["resume_gap_ms"] = round(
            (post[0][0] - pre[-1][0]) * 1e3, 3)
        out["pre_kill_events"] = pre_n
        # the second router's registry holds r0 as a static replica: its
        # default policy ejects the dead r0 within eject_fails probes
        rep0 = second.registry.get(r0)
        for _ in range(rep0.policy.eject_fails):
            probe()
        check(rep0.snapshot()["state"] == "ejected",
              f"23c: {r0} is {rep0.snapshot()['state']} after "
              f"{rep0.policy.eject_fails} probes of the second router")
        print(f"23(c): {r0} SIGKILLed after {pre_n} content events, its "
              f"blob a source_miss, the stream spliced onto r1 "
              f"{out['resume_gap_ms']} ms later, equal to r1's own "
              f"continuation; ejected after {rep0.policy.eject_fails} "
              f"probes of the second router; "
              f"{time.perf_counter() - t_phase:.1f} s in", flush=True)
        ring = _autoscale_events(router, "died", r0, timeout=10)
        kinds = [e["kind"] for e in ring]
        died = kinds.index("died")
        check("spawned" in kinds[died:]
              and ring[died + kinds[died:].index("scale_out")]["reason"]
              == "below_min", f"23c: no replacement after {r0} died: "
              f"{json.dumps(ring[died:])}")
        r2 = ring[died + kinds[died:].index("spawned")]["replica"]
        fleet = _get_json(router + "/api/v1/fleet")
        check(r0 not in [r["name"] for r in fleet["replicas"]],
              f"23c: {r0} still in the registry after its death")
        status, hdrs, ev = _sse_chat(router, {
            "messages": body["messages"] + [
                {"role": "assistant", "content": pre_text + post_text},
                {"role": "user", "content": "and then?"}],
            "temperature": 0, "max_tokens": 16, "stream": True})
        trace = _router_trace(router, hdrs["X-Cake-Request-Id"])
        route = next(e for e in trace["router"] if e["kind"] == "route")
        check(status == 200 and len(trace["landed"]) == 1
              and trace["landed"][0] == route["candidates"][0]
              and r0 not in route["candidates"],
              f"23c: the next turn landed on {trace['landed']} of "
              f"{route['candidates']}")
        # (d) the dashboards: the router's with the loop's row, the second
        # router's with the dead r0 ejected
        tops = [subprocess.Popen(
            [sys.executable, "-m", "cake_tpu_torch.cli", "top", "--once",
             "--plain", "--api", api],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for api in (router, url_second)]
        (top_out, top_err), (top2_out, top2_err) = [
            p.communicate(timeout=60) for p in tops]
        rows = [ln for ln in top_out.splitlines() if ln.startswith("r1 ")]
        check(tops[0].returncode == 0 and len(rows) == 1
              and "healthy" in rows[0] and "autoscale" in top_out,
              f"23d: cli top exited {tops[0].returncode}: {top_out[-800:]}"
              f"{top_err[-800:]}")
        rows2 = {ln.split()[0]: ln for ln in top2_out.splitlines()
                 if ln.startswith((r0[:14] + " ", "r1 "))}
        check(tops[1].returncode == 0 and len(rows2) == 2
              and "ejected" in rows2[r0[:14]] and "healthy" in rows2["r1"],
              f"23d: cli top on the second router exited "
              f"{tops[1].returncode}: {top2_out[-800:]}{top2_err[-800:]}")
        tel = _get_json(router + "/api/v1/fleet/telemetry")
        check(set(tel["burn_rate"]) == {"fast", "slow"}
              and all("headroom_tokens_per_s" in r and "err_rate" in r
                      for r in tel["replicas"].values())
              and "r1" in tel["replicas"]
              and tel["autoscale"]["min"] == 2
              and tel["autoscale"]["max"] == 2,
              f"23d: telemetry {str(tel)[:400]}")
        out["burn_rate"] = tel["burn_rate"]
        out["headroom_tokens_per_s"] = tel["headroom_tokens_per_s"]
        # (e) the kernels behind the router: r1 runs in this process
        torch.cuda.synchronize()
        fl, pd = flash.launch_counts(), pa.launch_counts()
        check(fl["bf16"]["fresh"] > 0 and fl["bf16"]["append"] > 0
              and pd["bf16"] > 0,
              f"23e: r1's launches flash {fl}, paged {pd}")
        out["r1_launches"] = {"flash_bf16": fl["bf16"],
                              "paged_bf16": pd["bf16"]}
        print("fleet (phase 23) top:\n  " + "\n  ".join(
            top_out.splitlines()) + "\n  the second router's:\n  "
            + "\n  ".join(top2_out.splitlines()), flush=True)
        # (g) stream migration: a greedy stream owned by the replacement
        # r2, SIGTERMed (the signal of the lifecycle's retire) after 8
        # content events: its drain parks the stream, whose swap blob
        # ships to r1, which continues it through the paged decode kernel
        ring = _autoscale_events(router, "admitted", r2, proc=rp,
                                 log_path=logr)
        r2_admit = [e for e in ring if e["kind"] == "admitted"
                    and e["replica"] == r2][0]
        url2 = f"http://127.0.0.1:{_managed(router)[r2]['port']}"
        pid2 = _managed(router)[r2]["pid"]
        children.append(pid2)
        deadline = time.perf_counter() + 10
        while r2 not in [r["name"] for r in _get_json(
                router + "/api/v1/fleet")["replicas"]
                if r["state"] == "healthy"]:
            check(time.perf_counter() < deadline, f"23g: {r2} not healthy")
            time.sleep(0.1)
        k = next(k for k in range(600, 800)
                 if _fleet_owner(_fleet_head(k), sorted(["r1", r2]))[0]
                 == r2)
        body = {"messages": _fleet_head(k), "temperature": 0,
                "max_tokens": 96, "stream": True}
        status, _, ev = _sse_chat(url2, body)
        check(status == 200, f"23g: {r2} alone: HTTP {status}")
        alone = _sse_text(ev)[0]
        shipped0 = _metric(_metrics(router), 'cake_fleet_kv_migrations_total'
                           '{outcome="shipped"}')
        drained = {}

        def term_at_8(events):
            if "t" not in drained and _sse_text(events)[1] >= 8:
                os.kill(pid2, signal.SIGTERM)
                drained["t"] = events[-1][0]
        torch.cuda.synchronize()
        paged0 = pa.launch_counts()["bf16"]
        status, hdrs, ev = _sse_chat(router, body, term_at_8)
        torch.cuda.synchronize()
        resumed = pa.launch_counts()["bf16"] - paged0
        check("t" in drained and status == 200, f"23g: HTTP {status}")
        text = _sse_text(ev)[0]
        rid = hdrs["X-Cake-Request-Id"]
        trace = _router_trace(router, rid)
        kinds = [e["kind"] for e in trace["router"]]
        check(text == alone and not any(
            "error" in json.loads(p) for _, p in ev if p != "[DONE]"),
            f"23g: the migrated stream's body differs from {r2}'s alone")
        check(_metric(_metrics(router), 'cake_fleet_kv_migrations_total'
                      '{outcome="shipped"}') == shipped0 + 1,
              "23g: /metrics did not count the shipped blob")
        chain = [x for x in kinds if x in ("stream_broken", "kv_migrate",
                                           "stream_resume", "done")]
        check(set(chain) == {"stream_broken", "kv_migrate", "stream_resume",
                             "done"} and chain[0] == "stream_broken"
              and chain[-1] == "done", f"23g: the router's timeline {kinds}")
        mig = next(e for e in trace["router"] if e["kind"] == "kv_migrate")
        check(mig["outcome"] == "shipped" and mig["from"] == r2
              and mig["to"] == "r1", f"23g: {mig}")
        tl = _get_json(f"{url1}/api/v1/requests/{rid}")["events"]
        check(any(e["kind"] == "resume" and e.get("kv_migrated")
                  for e in tl), f"23g: r1's timeline {tl[:8]}")
        layers = r1.engine.model.cfg.num_hidden_layers
        check(resumed > 0 and resumed % layers == 0,
              f"23g: {resumed} paged decode launches on r1 for the "
              f"resumed leg, not a positive multiple of {layers}")
        broken = next(e for e in trace["router"]
                      if e["kind"] == "stream_broken")
        pre, post = ev[:broken["chunks"]], ev[broken["chunks"]:]
        # the lifecycle sweeps r2's exit after its drain
        ring = _autoscale_events(router, "died", r2, timeout=30, proc=rp,
                                 log_path=logr)
        exited = [e for e in ring if e["kind"] == "died"
                  and e["replica"] == r2][0]
        check(exited.get("exit_code") == 0,
              f"23g: {r2} exited with {exited} after its SIGTERM")
        # the events the client held when r2's drain parked the stream
        # (the SIGTERM went at the 8th)
        out["migration"] = {"blob_bytes": mig["bytes"],
                            "pre_break_events": _sse_text(pre)[1],
                            "resume_gap_ms": round(
                                (post[0][0] - pre[-1][0]) * 1e3, 3),
                            "r1_paged_launches": resumed,
                            "r1_decode_steps": resumed // layers}
        print(f"23(g): {r2} SIGTERMed at the client's 8th content event, "
              f"its stream parked after "
              f"{out['migration']['pre_break_events']}, its "
              f"{mig['bytes']}-byte swap blob shipped to r1, which continued "
              f"the stream equal to {r2}'s alone "
              f"{out['migration']['resume_gap_ms']} ms later through "
              f"{resumed} paged decode launches ({resumed // layers} steps); "
              f"{r2} exited 0 and was swept on {card}", flush=True)
        ring = _get_json(router + "/api/v1/fleet/autoscale")["decisions"]
        out["autoscale"] = {
            "r0_spawn_to_admit_s": out.pop("spawn_to_admit_s"),
            "r2_spawn_to_admit_s": r2_admit["spawn_s"],
            "ring": [e["kind"] + (f"({e['reason']})" if e.get("reason")
                                  else "")
                     + (f":{e['replica']}" if e.get("replica") else "")
                     for e in ring]}
    finally:
        if stop_second is not None:
            stop_second()
        if router is not None:
            try:                    # r2's replacement, if one is spawning
                children += [m["pid"] for m in _managed(router).values()]
            except Exception:
                pass
        for p in procs:
            if p.poll() is None:
                p.terminate()       # the router reaps what it spawned
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        for pid in children:        # in case the router could not reap
            try:
                os.killpg(pid, signal.SIGKILL)
            except OSError:
                pass
        if r1 is not None:
            r1.app.stop(drain_s=1)
        for key, v in saved.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
    out["seconds"] = round(time.perf_counter() - t_phase, 3)
    print(f"phase 23 in {out['seconds']:.0f} s", flush=True)
    return out


def main(argv: list[str]) -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from cake_tpu_torch.cli import build_flagship
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops import paged_attention as pa
    card = card_line()
    print(f"device: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    built = phase_build()
    # what exists now (the modules, the built libraries) lives for the
    # whole run: keep it out of every later full collection, each of which
    # walks every tracked object
    gc.collect()
    gc.freeze()
    if argv[:2] == ["--only", "13d"]:
        qnext_oracle_arrivals(card)
        _qnext_oracle_f32(card)
        print(f"chip_smoke: --only 13d done in "
              f"{time.perf_counter() - t_start:.0f} s (no result line: a "
              f"diagnosis)", flush=True)
        return 0
    if argv[:2] in (["--only", "16"], ["--only", "17"], ["--only", "18"],
                    ["--only", "19"], ["--only", "20"], ["--only", "21"],
                    ["--only", "22"], ["--only", "23"]):
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            if argv[1] == "16":
                rows = f16_kernel_rows(phase_f16(card, workdir))
            elif argv[1] == "18":
                rows = flux_kernel_rows(phase_flux(card, workdir))
            elif argv[1] == "19":
                phase_sd(card, workdir)
                rows = []
            elif argv[1] == "20":
                phase_flux2(card, workdir)
                rows = []
            elif argv[1] == "21":
                phase_tts(card, workdir)
                rows = []
            elif argv[1] == "22":
                phase_luxtts(card, workdir)
                rows = []
            elif argv[1] == "23":
                print(f"fleet (phase 23): "
                      f"{json.dumps(phase_fleet(card, workdir))} on {card}",
                      flush=True)
                rows = []
            else:
                phase_cluster(card, workdir)
                rows = []
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"kernels": rows}))
        print(f"chip_smoke: phase {argv[1]} passed in "
              f"{time.perf_counter() - t_start:.0f} s (no result line: "
              f"one phase)", flush=True)
        return 0
    if argv[:2] == ["--only", "15"]:
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            o = phase_offload(card, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"kernels": offload_kernel_rows(o, None)}))
        print(f"chip_smoke: phase 15 passed in "
              f"{time.perf_counter() - t_start:.0f} s (no result line: "
              f"one phase)", flush=True)
        return 0
    if argv[:2] == ["--only", "14"]:
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            q = phase_quant(card, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"kernels": quant_kernel_rows(q)}))
        print(f"chip_smoke: phase 14 passed in "
              f"{time.perf_counter() - t_start:.0f} s (no result line: "
              f"one phase)", flush=True)
        return 0
    if argv[:2] == ["--only", "13"]:
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            q = phase_qnext(card, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"kernels": qnext_kernel_rows(q)}))
        print(f"chip_smoke: phase 13 passed in "
              f"{time.perf_counter() - t_start:.0f} s (no result line: "
              f"one phase)", flush=True)
        return 0
    if argv[:2] == ["--only", "12"]:
        phase_spec(build_flagship(layers=None, dtype="bf16", seed=0,
                                  device="cuda"), card)
        print(f"chip_smoke: phase 12 passed in "
              f"{time.perf_counter() - t_start:.0f} s (no result line: "
              f"one phase)", flush=True)
        return 0
    check(not argv, f"unknown arguments {argv} (only: --only 12, --only 13, "
          "--only 13d, --only 14, --only 15, --only 16, --only 17, --only "
          "18, --only 19, --only 20, --only 21, --only 22, --only 23)")
    timings = phase_kernels()
    paged_timings = phase_paged_kernels(built[pa.LIBRARY]["log"])
    parity_launches, parity_paged = phase_parity()
    t0 = time.perf_counter()
    model = build_flagship(layers=None, dtype="bf16", seed=0, device="cuda")
    print(f"serve: flagship 28 layers bf16 built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    phase_graphs(model, card)
    phase_prefill_graphs(model, card)
    serve_launches, contiguous = phase_serve(model, card)
    paged_launches = phase_paged_serve(model, card, contiguous)
    phase_faults(model, card)
    phase_qos(model, card)
    spec = phase_spec(model, card)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        del model
        torch.cuda.empty_cache()
        load = phase_checkpoint(card, workdir)
        family_launches = phase_families(card, workdir)
        family_launches["gemma3"] = phase_gemma3(card, workdir)
        qnext = phase_qnext(card, workdir)
        offload = phase_offload(card, workdir, qnext["checkpoint"])
        quant = phase_quant(card, workdir)
        f16 = phase_f16(card, workdir)
        cluster = phase_cluster(card, workdir)
        flux = phase_flux(card, workdir)
        sd = phase_sd(card, workdir)
        flux2 = phase_flux2(card, workdir)
        tts = phase_tts(card, workdir)
        lux = phase_luxtts(card, workdir)
        fleet = phase_fleet(card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    kernels = []
    for entry, route, launches in (
            ("fresh", "bf16", serve_launches["fresh"]),
            ("append", "bf16", serve_launches["append"]),
            ("f32", "f32", parity_launches["fresh"]),
            ("f32_append", "f32", parity_launches["append"])):
        t = timings[entry]
        kernels.append({
            "name": f"flash_attention.{entry}", "route": "cuda",
            "source": flash.SOURCES[route], "replaces": flash.REPLACES,
            "launches": launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "meta_ms": t["meta_ms"], "issue_ms": t["issue_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    for fam, n in family_launches.items():
        for entry, route, launches in (
                (f"{fam}_fresh", "bf16", n["fresh"]),
                (f"{fam}_append", "bf16", n["append"]),
                *((f"{fam}_{mode}", "f32", n[mode])
                  for mode in ("f32", "f32_append")
                  if f"{fam}_{mode}" in timings)):
            t = timings[entry]
            mode = entry.split("_", 1)[1]
            kernels.append({
                "name": f"flash_attention.{mode}.{fam}", "route": "cuda",
                "source": flash.SOURCES[route], "replaces": flash.REPLACES,
                "launches": launches, "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "meta_ms": t["meta_ms"],
                "issue_ms": t["issue_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]})
    for name, entry, launches in (
            ("bf16", "bf16", paged_launches), ("f32", "f32", parity_paged),
            *((f"bf16.{fam}", f"bf16_{fam}", n["paged"])
              for fam, n in family_launches.items()),
            ("f32.gemma3", "f32_gemma3",
             family_launches["gemma3"]["paged_f32"])):
        t = paged_timings[entry]
        kernels.append({
            "name": f"paged_decode_attention.{name}", "route": "cuda",
            "source": pa.SOURCE, "replaces": pa.REPLACES,
            "launches": launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "issue_ms": t["issue_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    for route in ("bf16", "f32"):
        t = spec["timings"][route]
        kernels.append({
            "name": f"paged_decode_attention.verify.{route}",
            "route": "cuda", "source": pa.SOURCE,
            "replaces": pa.VERIFY_REPLACES,
            "launches": spec["launches"][route],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "issue_ms": t["issue_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["unique_ms"], "bound_read_ms": t["read_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    kernels += qnext_kernel_rows(qnext)
    kernels += quant_kernel_rows(quant)
    kernels += offload_kernel_rows(offload, qnext)
    kernels += f16_kernel_rows(f16)
    kernels += flux_kernel_rows(flux)
    print(f"checkpoint load (phase 7): {json.dumps(load)} on {card}")
    print(f"cluster (phase 17): {json.dumps(cluster['bf16'])} on {card}")
    print(f"FLUX.1-dev served (phase 18): {json.dumps(flux['served'])} on "
          f"{card}")
    print(f"SD served (phase 19): {json.dumps(sd)} on {card}")
    print(f"FLUX.2-klein (phase 20): {json.dumps(flux2)} on {card}")
    print(f"VibeVoice (phase 21): {json.dumps(tts)} on {card}")
    print(f"LuxTTS (phase 22): {json.dumps(lux)} on {card}")
    print(f"fleet (phase 23): {json.dumps(fleet)} on {card}")
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.0f} s (limit 1200 s)", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
