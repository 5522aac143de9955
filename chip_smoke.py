#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--out chiprun_out/chip_smoke.json]

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

  1. device: CUDA must be available; print the card's name and power limit.
  2. build: compile every kernel source under unidisc_tpu_torch/ops/csrc
     with nvcc, one process per source, all started together.
  3. kernels: hold each kernel against its plain PyTorch version on the
     card at the main paths' shapes and the other listed shapes, and time
     the kernel, the plain version and one PyTorch library call (ms: CUDA
     events around 20 calls of the Python wrapper; device_ms: the summed
     device time of the kernels those calls launch, from torch.profiler,
     or from CUDA events where every trace came back empty;
     host_us: the wrapper's host time per call): the
     attention forward (flash_fwd), the two attention backward kernels
     (flash_bwd_dq, flash_bwd_dkv), the int8 product (int8_matmul; fp32
     output bit-exact, bf16 within one ulp) at the five products of the
     int8 serve path, the fused quantize kernel (fused_qmm; scales
     within 1e-6 relative, int8 values within one step on at most 0.1% of
     the elements) in each of its modes, and the per-row quantize of the
     int8 path (dynamic_quantize; q and s bit-exact) at its three shapes;
     and the conditioning-frozen paths' shapes (attention Lq 256 against
     Lk 384, the products and row kernels at 4096, 3072 and 2048 rows),
     and the causal DIT-AR's ar_inpainting rows, (32, 12, 768, 64): the
     forward with the LSE and both backward kernels, against SDPA's
     causal flash forward and backward.
  4. serve path: build the flagship text->image engine at full width with
     random weights from the seed; check full-width logits through the
     kernel against the plain path; check the t2i sampler, the
     conditioning-frozen t2i sampler and the generic maskgit sampler on
     the card against the CPU on a tiny model (injected noise); then serve
     8 requests through InferenceEngine.run_batch, which runs the
     sampler's captured CUDA-graph program (sampling/graph.py): the first
     batch captures it, the counted batch replays it with the launch
     counts set to 0 just before and read just after (exact, counted from
     the replay), and the tokens are checked; the program is held to the
     eager sampler at the same seed, and captured and eager steady tok/s
     are printed on a line of their own. The same for 8 image->caption
     requests (gen_text: the generic maskgit sampler, CFG 2.0).
  4b. int8 serve path: the same weights quantized into the engine of
     build_engine(quantize="int8") with FLAGSHIP_INT8_OVERRIDES; check its
     full-width logits against the plain int8 path and the bf16 model,
     the int8 sampler on the card against the CPU on a tiny model, and
     serve 8 requests with the counts of all four serving kernels checked
     exactly.
  4c. graph_vs_eager: on a tiny model and at flagship width (4 steps),
     the captured programs of t2i bf16, t2i int8, conditioning-frozen
     int8, refresh-2 int8 with an int8 KV cache and generic maskgit give
     the eager samplers' tokens under the same injected noise.
  4d. the conditioning-frozen int8 engines (the frozen_cond overlay, 32
     steps, CFG 2.0; distilled_stack, 8 steps, dilation 2, no CFG) on the
     same int8 weights, served as in 4 with exact launch counts: step 0
     writes the KV cache and leaves the fused block path.
  4e. pixels: the LlamaGen VQ-16 codec (VQConfig(), random weights from
     get_codec's seed 0) in true fp32 (TF32 off, as set below): its encode
     latents, ids (where the CPU's top-2 margin exceeds 1e-4) and decoded
     pixels on the card against the same module on the CPU at 64 px; the
     flagship bf16 engine of phase 4's weights, and the int8 engine of
     4b's, built with codec_name="llamagen-vq16", serve 8 t2i requests
     as in 4 (counted launches exact) and return eight 256 x 256 PNGs
     that hold the decode of the returned ids; the batch is timed with
     and without the decode, and the decode's and the PNG encoding's own
     times are taken; then the eight PNGs go back through
     decode_image_b64 -> codec.encode -> prepare(image_ids=) -> gen_text
     for eight captions, the encode timed.
  4f. the serving front door (on phase 4's and 4b's weights): the rolling
     chunk program (sampling/graph.py::CapturedChunk) against the eager
     chunk under injected noise, generic and t2i, on a tiny model and at
     full width (4 steps, a staggered ragged run, every state field equal
     after every chunk), and a lockstep run against the whole-batch
     captured sampler (tiny); the keyed noise bit-identical on the card
     and the CPU, and a staggered run with per-row steps 8 and 32 on the
     card against the CPU (tiny, fp32: token agreement >= 0.95, as the
     samplers' CPU check); at full width 4 requests, then 8 more after the
     first chunk, through a RollingT2IBatcher, each equal to its solo run,
     launches exactly replays x a chunk's; the t2i and generic rolling
     programs' build s, memory and ms a chunk; the scaffold sampler (the
     flagship trunk, a 4-block trunk of its width) captured against eager
     with its flash_fwd launches exact; make_server on the bf16 and the
     int8 engines (with the VQ-16 codec), whole-batch and rolling=8: 8
     concurrent t2i requests in one batch with exact launches and 256-px
     PNGs, and on bf16 a caption of a data-URL image, an infill with an
     is_mask attachment, a cached repeat, a streamed answer, /health and
     /metrics; then 16 t2i requests 50 ms apart, whole-batch against
     rolling: per-request p50 / p95 latency and image tok/s (a line of
     its own, `front_door`).
  4g. AR serving: on tiny fp32 models the card equals the CPU (tokens,
     greedy and seeded under the keyed noise: the OpenELM continuous
     batcher with bf16 and int8 caches, the DIT-AR's batcher and decode
     loop); int8_matmul and dynamic_quantize at every decode and prefill
     shape of OpenELM-270M and the flagship DIT-AR equal their plain
     versions (device ms at the decode rows beside the bound, and
     torch._int_mm at M 32, which it takes); (a) OpenELM-270M at full
     width (ELM_PRESETS["270m"], random weights from seed 0) in bf16, then
     int8 W8A8 with the int8 KV cache, through build_engine /
     complete_text (the continuous batcher, 8 slots, its decode chunk of 8
     steps one captured CUDA graph): a second capture of the chunk equals
     the eager chunk field for field, 16 streamed requests 50 ms apart
     (prompts 16-512 tokens, 64-256 new, half greedy, half seeded at 0.8,
     four sharing a 256-token prefix) with exact launches and the prefix
     cache hit; the int8 logits through the kernels against the plain int8
     path; (d) 8 concurrent chat completions over HTTP to the bf16
     engine, half streamed, the deltas concatenating to the answer; (c)
     build_engine(preset="elm:450m", speculative="270m", spec_gamma=4) and
     elm:270m with speculative="lookup", SPEC_REQUESTS greedy requests
     each, their first SPEC_LOSSLESS_TOKENS new tokens equal to a plain
     batcher's in fp64, with the acceptance rate and tokens a target
     read;
     (b) the flagship DIT-AR (FLAGSHIP_OVERRIDES + parameterization ar,
     causal, ar_shift; L 384; 2 of its 12 blocks) in bf16 and int8 with
     the int8 KV cache:
     build_ar_sampler at batch 8 with CFG 2.0 as its captured program
     (equal to the eager loop, launches exact) and the same 16 requests
     (cut to fit 384 positions) through engine.continuous. Lines
     `ar_serving` (TTFT and TPOT p50 / p95, tok/s), `ar_speculative`,
     `ar_programs` (build s, memory, ms a replay) and `ar_kernels`.
  4h. the codecs left, on phase 4's randomize_ weights with the image
     vocabulary the codecs' 8,192 codes: MAGVITv2 (MagvitConfig(), the
     published widths) and titok256 (hidden 512, 8 layers, K 256), each
     behind build_engine(codec_name=): the codec module on the card against
     a CPU copy (fp32, TF32 off: latents and the decode of the CPU's ids
     within CODEC_ATOL / CODEC_RTOL, ids equal where the CPU's margin
     exceeds ID_MARGIN, at least CLEAR_SHARE of them; MAGVIT at 64 px,
     TiTok at its own 256 px on 2 images), 8 t2i requests served as in 4e
     (counted launches exact: flash_fwd once a block a forward; PNGs the
     decode of the returned ids; the batch with and without the decode;
     captured batches only, phase 4 having read the eager sampler),
     2 of the PNGs captioned back through the codec's encoder, and encode
     and decode ms at batch 8; load_magvit_foreign of the MAGVIT card
     module's weights under foreign names (a discriminator key beside
     them) decoding bit for bit as the original; get_video_codec() at its
     defaults (16 frames of 64 px) on the card against a CPU copy, 2 clips,
     as above; tokenize_t2i_batch over chameleon-vqgan with var-aspect
     crops (300 x 150 images to (128, 64)) on the card against the CPU,
     the streams equal where the VQ margin (relative to the top score) is
     clear. Line `codecs` (each codec's ms, the served batch s and tok/s);
     the kernels line's flash_fwd counts the paths codecs_magvit and
     codecs_titok.
  5. train path: check one full-width gradient (FLAGSHIP_TRAIN_OVERRIDES,
     batch 32) through the kernels against the plain path; then train the
     flagship for 20 steps through Trainer.fit on one synthetic batch with
     the launch counts set to 0 just before and read just after, check
     that the loss falls, the counts per step, the EMA, and that a
     checkpoint from step 10 gives step 11's loss again.
  5b. pixels from a trained run dir: unidisc_tpu_torch.generate.main
     serves the train phase's run dir with --use-ema and the VQ-16 codec:
     8 samples.jsonl lines and 8 PNGs, and the served weights equal the
     trainer's final EMA. Then the pixels line.
  5c. the ar, sedd and d3pm objectives on data, at full width (the
     flagship, FLAGSHIP_TRAIN_OVERRIDES, batch 32): 512 structured rows
     from the seed written as token shards and as stream shards; one
     gradient of the causal DIT-AR with ar_inpainting and the row flip
     (L 768 through the kernels) against the plain path, as in phase 5
     (batch 16); the loaders' host tok/s (--iterate-data-only); then
     unidisc_tpu_torch.train.main, each run with the launch counts set to
     0 just before and read just after (each train kernel once a block a
     step): the DIT-AR with ar_inpainting and the flip for 20 steps on
     the shards (--overfit; the loss falls), then served from its run
     dir by build_engine(checkpoint=) (the weights equal the trainer's
     final EMA; 8 streamed complete_text requests answer with ids in the
     text vocabulary); then at AR_SHORT_DEPTH (4 of the 12 blocks): the
     DIT-AR at L 384 (the flip only, 10 steps); --stream for 10 steps
     with a checkpoint at 5 and a run resumed from it alone (its batches
     the straight run's bit for bit, its losses within 1e-5 relative);
     sedd and d3pm on the time-conditioned non-causal flagship, 10 steps
     each (every loss finite; the overfit batch's loss under one fixed
     set of draws lower at the trainer's final parameters than at its
     initial ones).
     A line `ar_train`: tok/s, median step s and peak memory a run, the
     loaders' tok/s, the L 768 kernel times.
  5d. the rest of training, at full width (FLAGSHIP_TRAIN_OVERRIDES,
     batch 32), every counted run with the launch counts set to 0 just
     before and read just after: (a) one gradient without remat (twice:
     the run-to-run difference) and under remat "none", "dots" and
     "dots_all" (torch.utils.checkpoint, selective for dots: the attention
     kernel is recomputed under every policy), equal to it bit for bit
     where the two runs without remat are, else within twice their
     difference; flash_fwd 2 x 12 launches under remat, flash_bwd_dq and
     flash_bwd_dkv 12; the peak memory of each; (b) the same with dropout
     0.1 from one seed (off against "dots"), then 10 steps through
     Trainer.fit with dropout 0.1 under remat "dots" (the loss of the
     batch under fixed draws falls); (c) Lion, AdEMAMix, Adafactor, Muon
     and AdamW + muP: one full-width update (2 blocks) on the card
     against the CPU from the same parameters and gradients, then, on 4
     of the flagship's 12 blocks, 10 steps each through train.main (the
     loss under fixed draws falls), Adafactor checkpointed at 5 and a run
     resumed from it with the straight run's losses; (d)
     LoRA r16 over phase 5's run dir (base_checkpoint), 10 steps through
     Trainer.fit: the base bit-equal, the run dir served by
     build_engine(checkpoint=) as base + EMA adapter, 8 t2i requests as in
     phase 4; (e) host offload, on 4 of the flagship's blocks: chunked (8)
     = unchunked (1) and working = bf16(master) after 2 steps on the card,
     10 steps through Trainer.fit and its run dir served as in (d);
     extra_large at its width with 8 of its 24 blocks (XL_DEPTH) at
     batch 16, XL_STEPS steps each resident, resident with remat and
     offloaded with remat
     (peak memory and step time); (f) CFG distillation (guidance 2.0) of a
     4-block student from phase 5's run dir (the teacher's [cond || uncond]
     forward at batch 64 through the kernel), 10 steps, the KL falls; (g)
     the supervisor CLI over train.main (batch 8, 4 blocks): SIGTERM to
     the child after its 4th step, the child checkpoints and exits 143,
     is relaunched, resumes and finishes (on a thread while the mesh
     world of 5h-5l runs: it waits on its child processes, line
     `supervised`). Lines `remat`, `optimizers`,
     `train_rest` (step s, tok/s and peak GB a path) and `offload`.
  5e. interleaved documents end to end, at the flagship width with the
     interleaved experiment (L 1024: 128 text rope rows and one 16 x 16
     image block, indexed through rope_index; the runs and the served run
     dir at IL_DEPTH, 4 of the 12 blocks): (a) 640 documents from the
     seed (1-3 images of 256 tokens, text spans of 8-120 ids) written as 4
     ragged ishard files, each packed at L 1024 with EOS 2 by the native
     packer bit for bit as by the Python packer; (b) train.main --stream
     over them at batch 16 for 20 steps with a checkpoint at 10, counted
     (each train kernel once a block a step, with the batch's sample ids
     as segment ids), a run resumed from step 10 alone with the straight
     run's losses and loader batches bit for bit, the fixed-draw loss of
     the stream's first batch falling; (c) flash_fwd (with the LSE),
     flash_bwd_dq and flash_bwd_dkv at (16, 12, 1024, 64) with that
     batch's own sample ids (-1 padding, documents ending mid-tile)
     against their plain versions, padded rows and keys zero, times
     beside the bound over the allowed pairs and SDPA with the equivalent
     boolean mask; (d) the run dir served by build_engine(checkpoint=)
     with the VQ-16 codec behind make_server: three documents ([text,
     generated image]; [text, given image with a pixel_mask, 32 generated
     text tokens]; [given image, 32 generated text tokens]) through the
     interleaved route, counted (flash_fwd once a block a forward), equal
     to run_interleaved at the same seed, given tokens unchanged, image
     slots holding image ids and text slots text ids, 256-px PNGs; the
     captured packed program equal to the eager packed sampler under
     injected noise. Lines `interleaved_shards`, `interleaved_kernels`,
     `interleaved_serve`, `interleaved`.
  5f. the samplers left: (a) the caching sampler at the flagship t2i
     layout (L 384, bf16, CFG 2.0), recompute txt and img, bf16 and int8
     KV cache: the captured program equals the eager sampler under
     injected noise, with equal launches; (b) on a tiny fp32 model the
     analytic, Tweedie (reward_on tokens and tweedie_img) and semi-AR
     samplers (time-conditioned: each stride captured; without: eager)
     on the card against the CPU under the same injected noise (token
     agreement >= 0.95, equal NFE); (c) TransfusionDIT at the flagship
     width, 8 DDIM steps on the card against the CPU in fp32 (max abs
     error <= 1e-2 of the latents' largest magnitude).
  5g. the DIT variants and the data tail: (a) 64 procedural 256-px
     images encoded by the VQ-16 codec on the card into a token shard
     (data/precompute.py); one gradient of the MoE flagship
     (FLAGSHIP_TRAIN_OVERRIDES + 8 experts, top-2, capacity factor 1.25,
     aux weight 0.01, batch 32) through the kernels against the plain
     path; then at MOE_RUN_DEPTH (4 of the 12 blocks) 10 steps of it
     through train.main on that shard (--overfit),
     counted (each train kernel once a block a step), the fixed-draw loss
     falling, the balance auxiliary finite at the final parameters, s/step,
     tok/s and peak memory; (b) its run dir served by
     build_engine(checkpoint=) with the flagship's sampling: 8 t2i
     requests in bf16 and in int8 (quant_fused off: int8_matmul and
     dynamic_quantize on the attention and head products, the experts in
     floating point), launches exact, the captured program equal to the
     eager sampler at the same seed; the served weights' logits on the
     card in fp32 (plain attention) against the CPU's (within 1e-4 of the
     largest logit, routing agreement >= 0.999) and in bf16 through the
     kernels (within twice the plain bf16 path's distance), routing
     agreement shares printed; (f) DevicePrefetcher over the shard:
     batches on the card equal to the loader's, a resume exact; (c) the
     img_cond flagship (1D rope, no QK-norm or sandwich norm, 8
     conditioning blocks over 256 VQ-16 ids, batch 32): one gradient
     against the plain path (attention launches 2 x 12 + 8 a pass), 10
     train steps on one batch with x_cond (counted, the fixed-draw loss
     falling), then 4-step maskgit samples through the closure over x_cond
     (sampling/sampler.py::ConditionedModel), the captured program equal to
     the eager sampler under injected noise for two conditions that give
     different tokens; (d) flash_fwd (with the LSE), flash_bwd_dq and
     flash_bwd_dkv at the cross-attention's (32, 12, 384 x 256, 64) and the
     trunk's (32, 12, 256, 64) against their plain versions, times beside
     the bound and SDPA; (e) the split_embed and cond_label flagships,
     forward through the kernels within twice the plain bf16 path's
     distance of the plain fp32 path. Lines `moe_train_line`,
     `moe_logits`, `img_cond_train`, `img_cond_sample`, `kernel img_cond`
     and `variants`.
  5h. the device mesh: flash_fwd with the LSE alone at the ring's block
     shapes (2, 12, 2048, 64) and (16, 12, 256, 64) (ring_attention.py's
     _flash_block) against its plain version, timed beside the bound, the
     plain version and aten._scaled_dot_product_flash_attention (which
     returns the LSE); then, after 5i's one-rank part, one world of
     MESH_RANKS spawned ranks sharing card 0 over gloo that runs 5h's,
     5i's and 5k's work in turn (one start-up of the ranks, each part
     timed on rank 0 after a barrier; line `mesh_world`), every
     collective staged through host memory
     (parallel/comm.py; NCCL refuses two ranks on one device, and FSDP2's
     collectives move device tensors, so the world runs "seq" and
     data-parallel rows but no FSDP sharding on the card): (a) the
     flash-kernel ring at (2, 8192, 12, 64) bf16 over the 4 ranks (Lc
     2048), full, causal and with a packed batch's ids (documents across
     chunk edges, -1 padding), gathered and held to one flash_attention
     over the whole sequence (the error's RMS <= MESH_RING_RMS_TOL of the
     output's, no element off by more than MESH_RING_MAX_TOL of the
     largest output), two wrong rings (a block dropped, the blocks merged
     unweighted) failing that gate, each rank's flash_fwd
     launches the code's count (4 blocks full, rank + 1 causal); (b) its gradient (the plain ring recomputed) on a packed
     causal (2, 1024, 4, 64) slice against fp32 attention; (c)
     MESH_TRAIN_STEPS seq = 4 train steps of the flagship width at L 1024
     (phase 5e's packed batch of 16 rows, Lc 256, depth MESH_TRAIN_BLOCKS),
     losses within MESH_LOSS_RTOL of the one-rank step on the same batch
     and draws and the parameter update's cosine with it >=
     MESH_UPDATE_COSINE, flash_fwd launches exact; (d) on a dp 2 x seq 2
     mesh the flagship (depth MESH_SERVE_BLOCKS) t2i sampler under
     spmd_sampler with injected noise, in fp32 through the plain ring
     (the kernel takes bf16) equal token for token to the one-rank
     sampler, in bf16 through the kernel ring agreeing >=
     MESH_TOKEN_AGREEMENT, and build_engine(mesh="fsdp=2,seq=2") serving
     8 requests, agreeing >= MESH_TOKEN_AGREEMENT with the one-rank
     engine at the same seed (each rank draws the global batch's noise);
     every rank's tokens equal, launches exact (two ring blocks an
     attention, none in fp32). Line
     `mesh`; the kernels line's flash_fwd counts the paths mesh_ring,
     mesh_train and mesh_serve, summed over the ranks.
  5i. the rest of the mesh: flash_fwd, flash_bwd_dq and flash_bwd_dkv at
     a tensor rank's (16, 6, 384, 64) against their plain versions, timed
     beside the bound and SDPA; the t2i sampler's two draws of a step at
     the global batch's rows on dp 1, 2 and 4 (F2's cost); the bf16 MoE
     experts' fp32 accumulation against an fp64 reference (F1); then, in
     5h's world after 5h's work, at the flagship width (hidden 768, 12
     heads, L 384) with the depth cut to MESH2_BLOCKS (bf16 GEMMs reduced
     in fp32 on both sides of each comparison): (a) MESH_TRAIN_STEPS
     train steps at batch MESH2_TRAIN_BATCH on dcn 2 x pp 2 (2 microbatches, GPipe) and on dcn
     2 x tensor 2 (megatron, 6 heads a rank), and the MoE flagship (8
     experts, top-2) on dcn 2 x ep 2 (global routing, 4 experts a rank),
     from randomize_'s weights (drawn on the card; the adaLN gates and the
     head non-zero, so the trunk drives the losses and every leaf's
     gradient), each against the one-rank step that rank 0 runs after it
     on the same weights, batch and draws, within MESH2_TRAIN_LIMITS (set
     from sound and planted-fault readings of scripts/mesh2_readings.py):
     every rank's losses and gradient norms, the trunk's first moments
     (AdamW's mu, linear in both steps' gradients, over the blocks rank 0
     holds) and the update's cosine (fp64, over the parameters rank 0
     holds); flash_fwd / dq / dkv launches the code's count; (b) on pp 2 x
     tensor 2 (2
     microbatches, MESH2_SERVE_STEPS steps) the t2i sampler under
     spmd_sampler with injected noise, fp32 through the plain attention
     equal token for token to one rank, bf16 through the kernels agreeing
     >= MESH_TOKEN_AGREEMENT, and build_engine(mesh="pp=2,tensor=2,
     pp_microbatches=2") serving 8 requests agreeing >=
     MESH_TOKEN_AGREEMENT with the one-rank engine at the same seed,
     launches exact; (c) build_engine(mesh=MESH2_DP_ENGINE_SPEC), dense
     data parallelism, whose ranks run the t2i sampler's captured program
     on their rows (drawing the global batch's noise), serving 8 requests
     equal token for token (MESH2_DP_ENGINE_AGREEMENT) to the one-rank
     engine at the same seed, one program a rank, launches exact (the
     first call's warm run and its replay); (d) int8 W8A8 on the mesh:
     on pp 2 x tensor 2's tensor group each row-parallel product
     (attn_out's and mlp.2's K-slices at 2 x REQUESTS x L rows, bf16 out)
     through qdot_row_parallel bit for bit the one-rank qdot on every
     rank, then build_engine(quantize="int8", mesh=) serving 8 requests
     on its part of the one-rank int8 engine's weights, the int8 headline
     on pp 2 x tensor 2 and the int8 MoE flagship on dcn 2 x ep 2, each
     agreeing >= MESH_TOKEN_AGREEMENT with the one-rank int8 engine at the
     same seed, its ranks' ids equal, launches exact (a tensor rank's
     attn_out and mlp.2 a row_amax, a quantize_by_amax and an int32
     int8_matmul each). Before the world, the row-parallel kernels at a
     tensor-2 rank's shapes against their plain versions, exactly: the
     int32 form of int8_matmul at (6144, 384, 768) and (6144, 1536, 768),
     row_amax and quantize_by_amax at (6144, 384) and (6144, 1536) in bf16
     and fp32 (quantize_by_amax given the whole row's amax equal to
     dynamic_quantize of the whole row), timed beside the bound and
     torch._int_mm / torch.linalg.vector_norm. Line `mesh2`; the
     kernels line counts the paths mesh2_train_pp, mesh2_train_tensor,
     mesh2_train_moe, mesh2_serve, mesh2_engine, mesh2_dp_engine,
     mesh2_int8_engine and mesh2_moe_int8_engine, summed over the ranks.
  5j. evaluation: unidisc_tpu_torch.eval_run.main in-process on phase 5's
     run dir (its step-TRAIN_STEPS checkpoint copied into a run dir whose
     snapshot samples as the flagship serves: maskgit, 32 steps, CFG 2.0),
     on the card with --use-ema, 4 val batches of 16 rows of token shards
     from the seed, the VQ-16 codec, an FID reference of the shards' image
     ids decoded (32 images), a MAUVE reference of their captions, and an
     asset dir holding the CLIP ViT-L/14 and gpt2-large judges at their
     published widths with JUDGE_LAYERS layers of random weights (in HF's
     files, with a byte-level BPE learned from the captions) and no
     inception file; the launch counts set to 0 just before and read just
     after: every key of eval_results.json there and finite, the fallback
     (FID on random_conv) and the judges (MAUVE on gpt2-large features, the
     judge LM's perplexity, the CLIP score) printed and asserted, the step
     TRAIN_STEPS, flash_fwd launched the code's count (a block a forward:
     the val batches, the capture's warm run, every sampler call's NFE),
     val/nll within EVAL_VAL_RTOL of Trainer.validate on the same batches,
     FID over random_conv of the same images on the card within
     EVAL_FID_RTOL of the CPU's, and the CLIP and GPT-2 judges on the card
     within JUDGE_TOL of the CPU on the same inputs, their forward times
     beside. Line `eval` (eval_run's wall s, speed_eval's tok/s and p50
     latency, the judges' forward ms, the card).
  5k. the mesh's other modes (in 5h's world, after 5i's work): at the
     flagship width with the depth cut to MESH2_BLOCKS, MESH_TRAIN_STEPS
     steps at batch MESH2_TRAIN_BATCH from randomize_'s weights, each path
     (MESH3_PATHS_SPEC) held to the one-rank step rank 0 runs after it on
     the same weights, batch and draws within MESH3_LIMITS (set from sound
     and planted-fault readings of scripts/mesh2_readings.py): ar with
     ar_inpainting on dcn 2 x seq 2 (L 768 after the doubling; the causal
     flash ring), subs with joint AR+NAR and the AR-LLM loss on dcn 2 x
     seq 2, sedd on dcn 2 x tensor 2, d3pm on dcn 2 x pp 2, Adafactor on
     pp 2 x tensor 2, Muon with muP on dcn 2 x tensor 2, LoRA (rank 16,
     the default targets, B redrawn non-zero) on dcn 2 x tensor 2, the
     MoE flagship (8 experts, top-2) on seq 2 x ep 2: every rank's losses
     and gradient norms, the update's cosine (fp64, over the parameters
     rank 0 holds, or the adapter) and the optimizer state's relative
     distance over rank 0's part; flash_fwd / dq / dkv launches the
     code's count (mesh3_launches). FSDP does not run on one card (it
     needs NCCL and a card per rank), so bf16 parameters under FSDP and
     every fsdp mesh are held by the CPU tests only. Line `mesh3`; the
     kernels line counts the paths mesh3_*, summed over the ranks.
  5l. rolling admission and AR decoding in a mesh engine (in 5h's world,
     after 5k's work), at the flagship width with the depth cut to
     MESH2_BLOCKS, each engine led by rank 0 while the other ranks replay
     its batchers' ops, each against the one-rank engine rank 0 runs
     after it on the same weights and seeds, within MESH4_LIMITS (set
     from sound and planted-fault readings of scripts/mesh2_readings.py
     --runs 5l): (a) build_engine(mesh=MESH4_SPEC, rolling=8) (4 slots a
     data-parallel rank) serving MESH4_ROLLING requests (8 t2i, 2
     captions, 2 infills) through run_batch, arriving MESH4_GAP_S apart
     with MESH4_STEPS mixed, every rank's rolling chunks captured, the
     generated image ids and caption text agreeing >=
     MESH_TOKEN_AGREEMENT; then the 8 t2i requests at 8 steps at once in
     fp32 through the plain attention, equal token for token; (b) (a)'s
     four 8-step t2i requests on MESH4_PP_SPEC, eager chunks, bf16 >=
     MESH4_PP_AGREEMENT; (c) the DIT-AR of phase 4g at MESH2_BLOCKS on
     MESH4_SPEC, 8 streamed greedy completions (prompts of 16-256
     tokens, two sharing MESH4_AR_SHARED): bf16 (build_engine) agreeing
     >= MESH4_AR_AGREEMENT (bf16 near ties flip), then in fp64 (its K/V
     cache bf16, as served) plain and with prompt lookup (2-grams) equal
     token for token; the decode chunk captured on every rank, the
     streams equal to the tokens, the prefix cache hit. A request
     unanswered after MESH4_WAIT_S counts wrong. Every rank's launches
     equal the code's count (the rolling programs' warm run and replays,
     the eager chunks; none through the plain attention, the DIT-AR's
     cached attention among them). Line `mesh4` (each path's readings
     and seconds, per-request p50 / p95, chunks, harvests and row reads,
     drains, prefix hits, the ops each follower replayed, the card); the
     kernels line counts the bf16 paths mesh4_*, summed over the ranks.
  6. print the kernels line, the card line and the result line.

The full record is written to --out as JSON. Numbers are measured on the
card this run lands on; the bound uses the H100 SXM's published peaks.
"""

from __future__ import annotations

import argparse
import base64
import collections
import concurrent.futures
import copy
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from unidisc_tpu_torch.config import (FLAGSHIP_INT8_OVERRIDES,
                                      FLAGSHIP_OVERRIDES,
                                      FLAGSHIP_TRAIN_OVERRIDES, Config)
from unidisc_tpu_torch import train as train_cli
from unidisc_tpu_torch.data.interleaved import (Document, Segment,
                                                pack_documents)
from unidisc_tpu_torch.data.native_packer import pack_documents_native
from unidisc_tpu_torch.data.streaming import (StreamingShardReader,
                                              docs_from_ishard,
                                              write_interleaved_shard,
                                              write_stream_shards)
from unidisc_tpu_torch.data.synthetic import SyntheticDataLoader
from unidisc_tpu_torch.data.token_shards import (TokenShardDataset,
                                                 WeightedDatasetSampler,
                                                 write_shard)
from unidisc_tpu_torch.models.continuous import TransfusionDIT
from unidisc_tpu_torch.models.dit import DIT, randomize_
from unidisc_tpu_torch.ops import _build
from unidisc_tpu_torch.ops.flash_attention import (
    attention_backward_reference, attention_reference, bwd_launches,
    flash_attention)
from unidisc_tpu_torch.ops.fused_qmm import (fused_quantize,
                                             fused_quantize_reference)
from unidisc_tpu_torch.ops.int8_matmul import (int8_matmul,
                                               int8_matmul_reference)
from unidisc_tpu_torch.ops.quant import quantize_dit_params, quantize_model
from unidisc_tpu_torch.sampling.caching import build_caching_sampler
from unidisc_tpu_torch.sampling.continuous import build_continuous_sampler
from unidisc_tpu_torch.sampling import extras
from unidisc_tpu_torch.sampling.graph import CapturedChunk, captured
from unidisc_tpu_torch.sampling.sampler import build_sampler
from unidisc_tpu_torch.sampling.scaffold import build_scaffold_sampler
from unidisc_tpu_torch.sampling.t2i_fast import build_t2i_sampler
from unidisc_tpu_torch import generate
from unidisc_tpu_torch.serving.batcher import PAD_SIZES, RequestBatcher
from unidisc_tpu_torch.serving.engine import (InferenceEngine, build_engine,
                                              decode_image_b64,
                                              encode_image_b64, restore_run,
                                              to_uint8)
from unidisc_tpu_torch.serving.rolling import (RollingT2IBatcher,
                                               build_rolling_sampler,
                                               build_rolling_t2i,
                                               keyed_uniform)
from unidisc_tpu_torch.serving.server import make_server
from unidisc_tpu_torch.tokenizers.bpe import bytes_to_unicode
from unidisc_tpu_torch.tokenizers.chameleon import (ChameleonSpec,
                                                    build_crop_size_list,
                                                    decode_stream,
                                                    tokenize_t2i_batch,
                                                    var_center_crop)
from unidisc_tpu_torch.tokenizers.image_codecs import (get_codec,
                                                       get_video_codec)
from unidisc_tpu_torch.tokenizers.remap import load_magvit_foreign
from unidisc_tpu_torch.tokenizers.text import get_tokenizer
from unidisc_tpu_torch.training.train_state import (compute_batch_loss,
                                                    flat_parameters,
                                                    init_train_state,
                                                    make_apply_fn,
                                                    make_optimizer,
                                                    make_train_step)
from unidisc_tpu_torch.training.checkpoint import CheckpointManager
from unidisc_tpu_torch.training.trainer import Trainer
from unidisc_tpu_torch.utils.png import decode_png, encode_png

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16, published
INT8_OP_PER_S = 1979e12        # H100 SXM dense int8, published
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
OUT_TOL = 2e-2    # bf16 outputs of magnitude ~1 round at 4e-3; the kernel
#                   rounds unnormalised P, the reference normalised P
LSE_TOL = 1e-3    # fp32 on both sides: summation order of Q K^T
BWD_REL_TOL = 2e-2  # max abs error <= 2e-2 x max |grad|: the kernels round
#                     P and dS to bf16 before the second product of each
#                     pair and write bf16 gradients (2^-9 relative each)
BF16_ULP = 2.0 ** -7   # relative spacing of bf16 (8-bit significand)
Q_SCALE_RTOL = 1e-6    # fused_qmm scales: fp32 row sums in another order
Q_MOVED_SHARE = 1e-3   # ... can move a value on a rounding boundary by one
REQUESTS = 8      # batch 8 -> 16 rows under CFG
SERVE_ROUNDS = 1  # steady batches timed a served path (the time limit)
CODEC = "llamagen-vq16"
# the codec on the card against the CPU: fp32 on both sides (TF32 off), in
# another summation order; the bound of the JAX package's torch-mirror
# test (tests/test_vqgan.py)
CODEC_ATOL, CODEC_RTOL, ID_MARGIN = 1e-4, 1e-3, 1e-4
CODEC_CHECK_PX = 64   # every channel width, a 4 x 4 grid: cheap on the CPU
TRAIN_BATCH = 32
TRAIN_STEPS = 20
CKPT_STEP = 10

KERNELS = {
    "flash_fwd": {
        "route": "cuda",
        "source": "unidisc_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "unidisc_tpu/ops/pallas_attention.py:119",
        "also_replaces": "unidisc_tpu/ops/pallas_attention.py:47",
    },
    "flash_bwd_dq": {
        "route": "cuda",
        "source": "unidisc_tpu_torch/ops/csrc/flash_bwd_dq.cu",
        "replaces": "unidisc_tpu/ops/pallas_attention.py:449",
    },
    "flash_bwd_dkv": {
        "route": "cuda",
        "source": "unidisc_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
        "replaces": "unidisc_tpu/ops/pallas_attention.py:402",
    },
    "int8_matmul": {
        "route": "cuda",
        "source": "unidisc_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "unidisc_tpu/ops/int8_matmul.py:53",
    },
    "fused_qmm": {
        "route": "cuda",
        "source": "unidisc_tpu_torch/ops/csrc/fused_qmm.cu",
        "replaces": "unidisc_tpu/ops/fused_qmm.py:97",
    },
    # the int8 path's per-row activation quantize: no Pallas kernel in the
    # JAX package (XLA fuses it); an entry of the fused_qmm source
    "dynamic_quantize": {
        "route": "cuda",
        "source": "unidisc_tpu_torch/ops/csrc/fused_qmm.cu",
        "replaces": "unidisc_tpu/ops/quant.py:51",
    },
    # a tensor rank's row-parallel int8 product (phase 5i): the int8
    # kernel with its epilogue skipped (int32 out), and dynamic_quantize
    # split in two around the group's max of the row amax
    "int8_matmul_int32": {
        "route": "cuda",
        "source": "unidisc_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "unidisc_tpu/ops/int8_matmul.py:53",
    },
    "row_amax": {
        "route": "cuda",
        "source": "unidisc_tpu_torch/ops/csrc/fused_qmm.cu",
        "replaces": "unidisc_tpu/ops/quant.py:51",
    },
    "quantize_by_amax": {
        "route": "cuda",
        "source": "unidisc_tpu_torch/ops/csrc/fused_qmm.cu",
        "replaces": "unidisc_tpu/ops/quant.py:51",
    },
}
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# the served configurations, each one counted batch of REQUESTS
SERVE_PATHS = ("serve", "serve_gen_text", "serve_int8",
               "serve_int8_frozen_cond", "serve_int8_distilled_stack")
# the served paths with the codec behind them (phase 4e)
PIXEL_PATHS = ("pixels_serve", "pixels_serve_int8", "pixels_caption")
# the counted runs of phase 4f: the rolling batcher at full width, the
# scaffold program, and the server on bf16 and int8, whole-batch and rolling
FRONT_DOOR_PATHS = ("rolling_determinism", "scaffold", "front_door_bf16",
                    "front_door_bf16_rolling", "front_door_int8",
                    "front_door_int8_rolling")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# device_ms calls whose traces all came back empty and that were timed
# with CUDA events instead; printed and written to the record
DEVICE_MS_FALLBACKS = []


def device_ms(fn, iters: int = 20, warmup: int = 3, traces: int = 3) -> float:
    """Device time per call: the device time of every kernel (and device
    copy) that a call of fn launches, from torch.profiler's CUDA trace of
    `iters` calls. Unlike time_ms, host work between launches is not
    counted, so a kernel faster than its wrapper's host path is still
    timed. The trace can lose an event (19 of 20 launches were seen on the
    card), so each kernel name contributes its mean duration times the
    whole number of launches a call makes of it. A trace can also come
    back with no device event at all: it is then taken again, up to
    `traces` times, and if every trace is empty the calls are timed with
    CUDA events (time_ms, which counts host gaps between launches too) and
    the fallback is recorded in DEVICE_MS_FALLBACKS. Once a call has
    fallen back, later calls take one trace (a host whose traces came
    back empty keeps losing them)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    if DEVICE_MS_FALLBACKS:
        traces = 1
    for _ in range(traces):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = collections.defaultdict(list)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name].append(e.time_range.elapsed_us())
        per_call = {name: round(len(times) / iters)
                    for name, times in by_name.items()}
        if by_name and any(per_call.values()):
            return sum(statistics.fmean(times) * per_call[name]
                       for name, times in by_name.items()) / 1e3
    ms = time_ms(fn, iters=iters, warmup=0)
    DEVICE_MS_FALLBACKS.append(getattr(fn, "__qualname__", repr(fn)))
    print(f"device_ms: torch.profiler recorded no device time in {traces} "
          f"traces of {iters} calls of {DEVICE_MS_FALLBACKS[-1]}; timed "
          f"with CUDA events instead: {ms} ms", file=sys.stderr)
    return ms


def host_us(fn, iters: int = 50, warmup: int = 3) -> float:
    """Host time of one call of fn with the device idle (synchronised
    before and after each call, so a full launch queue never blocks the
    host): the median over `iters` calls, in microseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def phase_build() -> dict:
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        paths = list(ex.map(_build.build, names))
    for name in names:
        _build.load(name)
    seconds = time.perf_counter() - t0
    print(f"build: {len(names)} kernel source(s) in {seconds:.1f} s")
    for name in names:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "built" in line:
                print(f"  {name}: {line.strip()}")
    return {"seconds": seconds, "libraries": [p.name for p in paths]}


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # name, (B, H, L, D), causal, segments[, Lk]; the first is the serve
    # path's shape (16 rows = batch 8 under CFG, small preset: 12 heads of
    # 64), the second the train path's (batch 32); the frozen paths' image
    # rows (Lq 256) attend over [text K/V || image K/V] (Lk 384) at 16 rows
    # (frozen_cond, CFG) and 8 (distilled_stack)
    ("main_path", (16, 12, 384, 64), False, False),
    ("train_path", (32, 12, 384, 64), False, False),
    ("extra_large_head_dim", (4, 16, 384, 128), False, False),
    ("long_tiled_range", (2, 12, 1024, 64), False, False),
    ("causal_segments_padding", (2, 8, 512, 128), True, True),
    ("frozen_cond_path", (16, 12, 256, 64), False, False, 384),
    ("distilled_stack_path", (8, 12, 256, 64), False, False, 384),
    # the causal DIT-AR trained with ar_inpainting: [corrupted || clean]
    # rows, twice L 384 (phase 5c)
    ("ar_inpainting_path", (32, 12, 768, 64), True, False),
]


def attention_inputs(shape, causal, segs, gen, lk=None, seg=None):
    """q, k, v (bf16), the kernel's keyword arguments and the boolean mask
    of a case; with segs, the segment ids `seg` (B, L) when given, else
    three segments with a padded tail on row 0."""
    b, h, l, d = shape
    # q, k, v as views of one (B, L, 3, H, D) projection, as the DIT
    # hands them over (v keeps the projection's strides); with lk, k and v
    # are contiguous (B, lk, H, D), as the frozen paths concatenate them
    qkv = torch.randn((b, l, 3, h, d), generator=gen, device="cuda",
                      dtype=torch.float32).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    if lk is not None:
        k, v = (torch.randn((b, lk, h, d), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        return q, k, v, {"causal": causal}, None
    q, k = q.contiguous(), k.contiguous()
    kw = {"causal": causal}
    mask = None
    if segs:
        if seg is None:
            seg = torch.zeros((b, l), dtype=torch.int32, device="cuda")
            seg[:, l // 3:] = 1
            seg[:, 2 * l // 3:] = 2
            seg[0, l - l // 8:] = -1       # padding rows attend to nothing
        kw["segment_ids"] = (seg, seg)
        mask = ((seg[:, :, None] == seg[:, None, :])
                & (seg >= 0)[:, :, None])[:, None]
    if causal:
        cm = torch.ones((l, l), dtype=torch.bool, device="cuda").tril()
        mask = cm[None, None] if mask is None else (mask & cm)
    return q, k, v, kw, mask


def attention_bound(shape, mask, segs, lk=None):
    """Least time for the work: bytes of Q, K, V, O (and the segment ids)
    moved once, and 4 D FLOPs per allowed (query, key) pair."""
    b, h, l, d = shape
    lk = lk or l
    nbytes = 2 * b * (l + lk) * h * d * 2
    if segs:
        nbytes += 2 * b * l * 4
    if mask is not None:
        pairs = int(mask.expand(b, 1, l, l).sum().item()) * h
    else:
        pairs = b * h * l * lk
    flops = 4.0 * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def phase_kernels(seed: int, cases=None) -> list:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, shape, causal, segs, *lk in cases or ATTN_CASES:
        lk = lk[0] if lk else None
        q, k, v, kw, mask = attention_inputs(shape, causal, segs, gen, lk)
        need_lse = name != "main_path"   # training asks for the LSE
        out = flash_attention(q, k, v, need_lse=need_lse, **kw)
        ref = attention_reference(q, k, v, need_lse=need_lse, **kw)
        torch.cuda.synchronize()
        if need_lse:
            (out, lse), (ref, ref_lse) = out, ref
            lse_err = (lse - ref_lse).abs().max().item()
        else:
            lse_err = None
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all().item())
        if segs:
            pad = kw["segment_ids"][0] < 0
            if not bool((out[pad] == 0).all().item()):
                raise AssertionError(f"{name}: padding rows are not zero")
        if not finite or err > OUT_TOL or (lse_err is not None
                                           and lse_err > LSE_TOL):
            raise AssertionError(
                f"flash_fwd disagrees with attention_reference at {name} "
                f"{shape}: max_abs_err {err} (tol {OUT_TOL}), lse_err "
                f"{lse_err} (tol {LSE_TOL}), finite {finite}")
        def kernel():
            return flash_attention(q, k, v, **kw)

        plain_ms = time_ms(lambda: attention_reference(q, k, v, **kw),
                           iters=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library():
            if causal and not segs:     # SDPA's flash forward
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        bound_ms, bound_by, nbytes, flops = attention_bound(shape, mask,
                                                            segs, lk)
        row = {"case": name, "shape_bhld": list(shape), "lk": lk or shape[2],
               "causal": causal,
               "segments": segs, "max_abs_err": err, "tol": OUT_TOL,
               "lse_err": lse_err, "ms": time_ms(kernel),
               "device_ms": device_ms(kernel), "host_us": host_us(kernel),
               "plain_ms": plain_ms, "library_ms": time_ms(library),
               "library_device_ms": device_ms(library),
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "flops": flops}
        rows.append(row)
        print("kernel flash_fwd " + json.dumps(row))
    return rows


BWD_CASES = [
    # the train path's shape (batch 32, small preset) and the forward's
    # other cases
    ("train_path", (32, 12, 384, 64), False, False),
    ("extra_large_head_dim", (4, 16, 384, 128), False, False),
    ("long_tiled_range", (2, 12, 1024, 64), False, False),
    ("causal_segments_padding", (2, 8, 512, 128), True, True),
    ("ar_inpainting_path", (32, 12, 768, 64), True, False),
]


def backward_bounds(shape, mask, segs):
    """Least times of the backward's work: every tensor moved once at the
    HBM rate, or the products' FLOPs over allowed (query, key) pairs at the
    bf16 peak, whichever is longer. Returns the whole backward's bound (q,
    k, v, o, dO, dq, dk, dv, LSE and di; 10 D FLOPs a pair) and each
    kernel's: dq reads q, k, v, o, dO, LSE and writes dq, di (S, dP, dQ:
    6 D a pair); dkv reads q, k, v, dO, LSE, di and writes dk, dv (S, dP,
    dV, dK: 8 D a pair)."""
    b, h, l, d = shape
    act = b * l * h * d * 2
    rows = b * h * l * 4
    seg = 2 * b * l * 4 if segs else 0
    if mask is not None:
        pairs = int(mask.expand(b, 1, l, l).sum().item()) * h
    else:
        pairs = b * h * l * l

    def bound(nbytes, flops_per_pair):
        flops = flops_per_pair * d * pairs
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops}

    return {"backward": bound(8 * act + 2 * rows + seg, 10),
            "flash_bwd_dq": bound(6 * act + 2 * rows + seg, 6),
            "flash_bwd_dkv": bound(6 * act + 2 * rows + seg, 8)}


def sdpa_backward_fn(q, k, v, do, mask, causal_only=False):
    """One call of PyTorch's fused attention backward on the same inputs,
    in the (B, H, L, D) layout SDPA uses: FlashAttention-2's backward where
    nothing is masked or the mask is only causal (causal_only), the
    memory-efficient kernel's backward with the mask as an additive bias
    otherwise (what F.scaled_dot_product_attention dispatches to). The
    aten ops are called directly, so no autograd overhead is timed."""
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    aten = torch.ops.aten
    if mask is None or causal_only:
        (out, lse, cq, ck, mq, mk, seed, offset,
         _) = aten._scaled_dot_product_flash_attention(
             qt, kt, vt, 0.0, causal_only)
        bwd = aten._scaled_dot_product_flash_attention_backward
        return lambda: bwd(dot, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0,
                           causal_only, seed, offset)
    b, h, l, _ = qt.shape
    bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device) \
        .masked_fill(~mask, float("-inf")).expand(b, h, l, l)
    out, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
        qt, kt, vt, bias, True)
    bwd = aten._scaled_dot_product_efficient_attention_backward
    return lambda: bwd(dot, qt, kt, vt, bias, out, lse, seed, offset, 0.0,
                       [True, True, True, False])


def phase_bwd_kernels(seed: int, cases=None) -> list:
    """The two backward kernels against attention_backward_reference,
    computed in fp32 on the card from the same bf16 inputs (and the
    forward kernel's O and LSE)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    rows = []
    for name, shape, causal, segs in cases or BWD_CASES:
        q, k, v, kw, mask = attention_inputs(shape, causal, segs, gen)
        b, h, l, d = shape
        do = torch.randn((b, l, h, d), generator=gen, device="cuda",
                         dtype=torch.float32).to(torch.bfloat16)
        o, lse = flash_attention(q, k, v, need_lse=True, **kw)
        scale = d ** -0.5
        seg_ids = kw.get("segment_ids")
        grads, launch_dq, launch_dkv = bwd_launches(
            q, k, v, o, lse, do, seg_ids, causal, scale)
        launch_dq()
        launch_dkv()
        ref = attention_backward_reference(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(),
            **kw)
        torch.cuda.synchronize()
        errs = {}
        for gname, g, r in zip(("dq", "dk", "dv"), grads, ref):
            err = (g.float() - r).abs().max().item()
            top = r.abs().max().item()
            finite = bool(torch.isfinite(g.float()).all().item())
            errs[gname] = {"max_abs_err": err, "max_abs_ref": top}
            if not finite or err > BWD_REL_TOL * top:
                raise AssertionError(
                    f"flash_bwd disagrees with attention_backward_reference "
                    f"at {name} {shape}: {gname} max_abs_err {err} > "
                    f"{BWD_REL_TOL} x {top} (finite {finite})")
        if segs:
            pad = seg_ids[0] < 0    # padded rows (queries) and keys
            for gname, g in zip(("dq", "dk", "dv"), grads):
                if not bool((g[pad] == 0).all().item()):
                    raise AssertionError(f"{name}: {gname} is not zero on "
                                         f"padded rows / keys")
        bounds = backward_bounds(shape, mask, segs)
        library = sdpa_backward_fn(q, k, v, do, mask,
                                   causal_only=causal and not segs)
        row = {"case": name, "shape_bhld": list(shape), "causal": causal,
               "segments": segs, "errors": errs, "rel_tol": BWD_REL_TOL,
               "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
               "ms_dq": time_ms(launch_dq), "ms_dkv": time_ms(launch_dkv),
               "device_ms_dq": device_ms(launch_dq),
               "device_ms_dkv": device_ms(launch_dkv),
               "host_us_dq": host_us(launch_dq),
               "host_us_dkv": host_us(launch_dkv),
               "plain_ms": time_ms(lambda: attention_backward_reference(
                   q, k, v, o, lse, do, **kw), iters=5),
               "library_ms": time_ms(library),
               "library_device_ms": device_ms(library),
               "bounds": bounds}
        row["ms"] = row["ms_dq"] + row["ms_dkv"]
        rows.append(row)
        print("kernel flash_bwd " + json.dumps(row))
        del q, k, v, o, lse, do, grads, ref
    return rows


def frozen_rows(m) -> list:
    """(name, trunk rows) of the conditioning-frozen serve paths: the
    image rows under CFG (frozen_cond), distilled_stack's step 0 over the
    whole sequence (it writes the cache) and its image-row trunk (no
    CFG)."""
    return [("frozen_cond_trunk", 2 * REQUESTS * m.img_length),
            ("distilled_step0", REQUESTS * m.length),
            ("distilled_trunk", REQUESTS * m.img_length)]


def int8_gemm_shapes(m) -> list:
    """(name, M, K, N, bias) of the five int8 products of one denoise step
    of the int8 serve path: the four trunk products at 2 x REQUESTS rows
    of the whole sequence (CFG), and the head over the image rows after
    the CFG combine against the image vocabulary; then the four trunk
    products at the frozen paths' rows."""
    rows = 2 * REQUESTS * m.length
    d, f = m.hidden_size, m.mlp_ratio * m.hidden_size
    trunk = [("attn_qkv", d, 3 * d, False), ("attn_out", d, d, False),
             ("mlp_0", d, f, True), ("mlp_2", f, d, True)]
    return ([(name, rows, k, n, bias) for name, k, n, bias in trunk]
            + [("head", REQUESTS * m.img_length, d, m.image_vocab_size,
                True)]
            + [(f"{name}@{path}", mm, k, n, bias)
               for path, mm in frozen_rows(m)
               for name, k, n, bias in trunk])


def int8_gemm_bound(mm, k, n, bias, out_bytes):
    """Operands (int8 x and w, fp32 scales and bias) read once and the
    output written once at the HBM rate, or 2 M N K int8 operations at
    the int8 peak, whichever is longer."""
    nbytes = mm * k + n * k + 4 * mm + 4 * n * (2 if bias else 1) \
        + mm * n * out_bytes
    ops = 2.0 * mm * n * k
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def library_int8_fn(xq, s, wq, ws, b):
    """torch._int_mm (cuBLASLt int8 x int8 -> int32) with the epilogue in
    torch ops: the library's way to the same function; None where
    _int_mm refuses the shape."""
    def run():
        acc = torch._int_mm(xq, wq.t())
        out = acc.float() * s * ws
        if b is not None:
            out = out + b
        return out.to(torch.bfloat16)
    try:
        run()
    except RuntimeError as err:
        print(f"  torch._int_mm refused {tuple(xq.shape)} x "
              f"{tuple(wq.shape)}: {str(err).splitlines()[0]}")
        return None
    return run


def phase_int8_matmul(m, seed) -> list:
    """int8_matmul against int8_matmul_reference at the serve path's five
    products, with and without a bias, fp32 (bit-exact) and bf16 (within
    one ulp) output; times at the path's own bias setting, bf16 out."""
    # imported here: scripts/*_kernel_times.py load this file's helpers
    # over other trees, whose wrappers may have no plan
    from unidisc_tpu_torch.ops.int8_matmul import plan
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    rows = []
    for name, mm, k, n, path_bias in int8_gemm_shapes(m):
        kw = dict(generator=gen, device="cuda")
        xq = torch.randint(-127, 128, (mm, k), dtype=torch.int8, **kw)
        s = torch.rand((mm, 1), **kw) * 0.02 + 1e-3
        wq = torch.randint(-127, 128, (n, k), dtype=torch.int8, **kw)
        ws = torch.rand((n,), **kw) * 0.02 + 1e-3
        b = torch.randn((n,), **kw)
        errs = {}
        for bias in (False, True):
            for out_dtype in (torch.float32, torch.bfloat16):
                bb = b if bias else None
                got = int8_matmul(xq, s, wq, ws, bias=bb, out_dtype=out_dtype)
                want = int8_matmul_reference(xq, s, wq, ws, bias=bb,
                                             out_dtype=out_dtype)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                label = f"{'bias' if bias else 'no_bias'}_" \
                    f"{'fp32' if out_dtype == torch.float32 else 'bf16'}"
                errs[label] = diff.max().item()
                ok = (bool((diff == 0).all()) if out_dtype == torch.float32
                      else bool((diff <= BF16_ULP
                                 * want.float().abs()).all()))
                if not ok or not bool(torch.isfinite(got.float()).all()):
                    raise AssertionError(
                        f"int8_matmul disagrees with int8_matmul_reference "
                        f"at {name} ({mm}, {k}, {n}) {label}: max abs "
                        f"{errs[label]}")
                del got, want, diff
        bb = b if path_bias else None
        bound_ms, bound_by, nbytes, ops = int8_gemm_bound(mm, k, n,
                                                          path_bias, 2)

        def kernel():
            return int8_matmul(xq, s, wq, ws, bias=bb)

        library = library_int8_fn(xq, s, wq, ws, bb)
        block_n, tiles, grid = plan(mm, n, torch.cuda.get_device_properties(
            0).multi_processor_count)
        row = {"case": name, "shape_mkn": [mm, k, n], "bias": path_bias,
               "plan": {"block_n": block_n, "tiles": tiles, "grid": grid},
               "max_abs_err": max(errs.values()), "errors": errs,
               "ms": time_ms(kernel), "device_ms": device_ms(kernel),
               "host_us": host_us(kernel),
               "plain_ms": time_ms(lambda: int8_matmul_reference(
                   xq, s, wq, ws, bias=bb), iters=5),
               "library_ms": time_ms(library) if library else None,
               "library_device_ms": (device_ms(library) if library
                                     else None),
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "ops": ops}
        rows.append(row)
        print("kernel int8_matmul " + json.dumps(row))
        del xq, wq
    return rows


QUANT_CASES = [
    # name, mode, norm_type, conditioning: the first is the serve path's
    # (the flagship's rms prologue of attn_qkv and mlp.0)
    ("main_path", "adaln_norm", "rms", True),
    ("layernorm_cond", "adaln_norm", "layernorm", True),
    ("gelu", "gelu", "layernorm", False),
    ("none", "none", "layernorm", False),
]
# fp32 operations per element of each mode's passes (the bound's
# operation count; every mode is bound by bytes by a wide margin)
QUANT_OPS_PER_ELEMENT = {"adaln_norm": 14, "gelu": 13, "none": 4}


def phase_fused_qmm(m, seed) -> list:
    """fused_quantize against fused_quantize_reference at the serve path's
    (2 x REQUESTS x L, hidden) bf16 activations, with the adaLN rows as
    strided views of the block's modulation table and the serving
    modality layout (text rows 0, image rows 1); then the main path's mode
    at the frozen paths' image rows (all modality 1), whose trunks take the
    fused prologue (distilled_stack's step 0 writes the cache and does
    not)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    k = m.hidden_size
    norm_w = 1.0 + 0.1 * torch.randn((k,), generator=gen, device="cuda")
    # the width of the row kernel the wrapper picks (trees before the row
    # kernel have no plan)
    from unidisc_tpu_torch.ops import fused_qmm as fq_module
    plan = getattr(fq_module, "quantize_plan", None)

    def operands(b, txt, img):
        x = torch.randn((b * (txt + img), k), generator=gen,
                        device="cuda").bfloat16()
        table = (0.2 * torch.randn((b, 6 * k), generator=gen,
                                   device="cuda")).bfloat16()
        modality = torch.cat([torch.zeros((b, txt), dtype=torch.long),
                              torch.ones((b, img), dtype=torch.long)],
                             1).reshape(-1).float().cuda()
        return x, table, modality

    main = operands(2 * REQUESTS, m.txt_length, m.img_length)
    cases = [(name, mode, norm_type, cond, main)
             for name, mode, norm_type, cond in QUANT_CASES]
    for path, mm in frozen_rows(m):
        if path != "distilled_step0":
            cases.append((f"main_path@{path}", "adaln_norm", "rms", True,
                          operands(mm // m.img_length, 0, m.img_length)))
    rows = []
    for name, mode, norm_type, cond, (x, table, modality) in cases:
        mm = x.shape[0]
        kw = dict(mode=mode, norm_type=norm_type)
        nbytes = mm * k * 2 + mm * k + mm * 4
        if mode == "adaln_norm":
            kw["norm_w"] = norm_w
            nbytes += k * 4
        if cond:
            b = table.shape[0]
            kw.update(shift=table[:, :k], scale=table[:, k:2 * k],
                      modality=modality, rows_per_batch=mm // b)
            nbytes += 2 * b * k * 2 + mm * 4
        q, s = fused_quantize(x, **kw)
        q_ref, s_ref = fused_quantize_reference(x, **kw)
        torch.cuda.synchronize()
        s_err = ((s - s_ref).abs() / s_ref.abs()).max().item()
        moved = (q.int() - q_ref.int()).abs()
        moved_max = int(moved.max().item())
        moved_share = moved.float().mean().item()
        if (s_err > Q_SCALE_RTOL or moved_max > 1
                or moved_share > Q_MOVED_SHARE):
            raise AssertionError(
                f"fused_qmm disagrees with fused_quantize_reference at "
                f"{name}: scale rel err {s_err} (tol {Q_SCALE_RTOL}), int8 "
                f"max step {moved_max}, share moved {moved_share} (tol "
                f"{Q_MOVED_SHARE})")
        ops = QUANT_OPS_PER_ELEMENT[mode] * mm * k
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOP_PER_S * 1e3
        row = {"case": name, "shape_mk": [mm, k], "mode": mode,
               "norm_type": norm_type, "cond": cond,
               "plan": list(plan(x, kw.get("norm_w"), kw.get("shift"),
                                 kw.get("scale"))) if plan else None,
               "max_abs_err": float(moved_max), "scale_rel_err": s_err,
               "moved_share": moved_share,
               "ms": time_ms(lambda: fused_quantize(x, **kw)),
               "device_ms": device_ms(lambda: fused_quantize(x, **kw)),
               "host_us": host_us(lambda: fused_quantize(x, **kw)),
               "plain_ms": time_ms(lambda: fused_quantize_reference(x, **kw),
                                   iters=5),
               "library_ms": None,      # no single PyTorch call computes it
               "library_device_ms": None,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops}
        rows.append(row)
        print("kernel fused_qmm " + json.dumps(row))
    return rows


def dynamic_quantize_shapes(m) -> list:
    """(name, M, K) of the int8 serve path's per-row quantize calls (qdot):
    the inputs of attn_out and mlp.2 at 2 x REQUESTS rows of the whole
    sequence, and of the image head; then attn_out's and mlp.2's at the
    frozen paths' rows (distilled_stack's trunk shares the head's
    (2048, 768))."""
    rows = 2 * REQUESTS * m.length
    d, f = m.hidden_size, m.mlp_ratio * m.hidden_size
    out = [("attn_out", rows, d), ("mlp_2", rows, f),
           ("head", REQUESTS * m.img_length, d)]
    for path, mm in frozen_rows(m):
        out += [(f"{name}@{path}", mm, k) for name, k in
                (("attn_out", d), ("mlp_2", f))
                if (mm, k) != (REQUESTS * m.img_length, d)]
    return out


def dynamic_quantize_input(gen, mm, k) -> torch.Tensor:
    """(mm, k) bf16 rows of random scale, every 64th row zero."""
    x = torch.randn((mm, k), generator=gen, device="cuda") \
        * torch.rand((mm, 1), generator=gen, device="cuda") * 4
    x[::64] = 0.0
    return x.bfloat16()


def phase_dynamic_quantize(m, seed) -> list:
    """dynamic_quantize (the row kernel, dividing form) against
    dynamic_quantize_reference, q and s bit for bit, at the serve path's
    three shapes, bf16 in, every 64th row zero. plain_ms and
    plain_device_ms time the plain version: the eager chain of PyTorch ops
    that the kernel replaces."""
    # imported here: scripts/int8_kernel_times.py loads this file's helpers
    # over other trees, which may have no such kernel
    from unidisc_tpu_torch.ops.quant import (dynamic_quantize,
                                             dynamic_quantize_reference)
    from unidisc_tpu_torch.ops.fused_qmm import quantize_plan
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    rows = []
    for name, mm, k in dynamic_quantize_shapes(m):
        x = dynamic_quantize_input(gen, mm, k)
        q, s = dynamic_quantize(x)
        q_ref, s_ref = dynamic_quantize_reference(x)
        torch.cuda.synchronize()
        q_err = (q.int() - q_ref.int()).abs().max().item()
        s_err = (s - s_ref).abs().max().item()
        if not (torch.equal(q, q_ref) and torch.equal(s, s_ref)):
            raise AssertionError(
                f"dynamic_quantize differs from dynamic_quantize_reference "
                f"at {name} ({mm}, {k}): q max step {q_err}, s max abs "
                f"{s_err}")
        nbytes = mm * k * 2 + mm * k + mm * 4
        ops = QUANT_OPS_PER_ELEMENT["none"] * mm * k
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOP_PER_S * 1e3
        row = {"case": name, "shape_mk": [mm, k],
               "plan": list(quantize_plan(x)),
               "max_abs_err": float(max(q_err, s_err)),
               "ms": time_ms(lambda: dynamic_quantize(x)),
               "device_ms": device_ms(lambda: dynamic_quantize(x)),
               "host_us": host_us(lambda: dynamic_quantize(x)),
               "plain_ms": time_ms(lambda: dynamic_quantize_reference(x)),
               "plain_device_ms": device_ms(
                   lambda: dynamic_quantize_reference(x)),
               "library_ms": None,      # no single PyTorch call computes it
               "library_device_ms": None,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops}
        rows.append(row)
        print("kernel dynamic_quantize " + json.dumps(row))
        del x, q, s, q_ref, s_ref
    return rows


# ---------------------------------------------------------------------------
# serve path
# ---------------------------------------------------------------------------

def forward_inputs(engine, batch, seed):
    m = engine.m
    rng = np.random.RandomState(seed)
    prepared = [engine.prepare(text=f"a photograph of subject {i}")
                for i in range(batch)]
    x = np.stack([p["x0"] for p in prepared]).astype(np.int64)
    img = rng.randint(0, m.image_vocab_size, (batch, m.img_length))
    img = np.where(rng.rand(batch, m.img_length) < 0.5, m.mask_index,
                   img + m.text_vocab_size)
    x[:, m.txt_length:] = img
    modality = np.concatenate([np.zeros((batch, m.txt_length)),
                               np.ones((batch, m.img_length))], 1)
    sigma = rng.uniform(0.05, 3.0, batch).astype(np.float32)
    to = lambda a, dt: torch.from_numpy(a).to("cuda", dt)
    return to(x, torch.long), to(sigma, torch.float32), \
        to(modality.astype(np.int64), torch.long)


def phase_logits(engine, seed) -> dict:
    """Full-width logits through the kernel against the plain attention.

    Truth is the plain path in fp32; the kernel path (bf16) must be as
    close to it as the plain path in bf16 is, within a factor of 2."""
    cfg = engine.config.model
    state = engine.model.state_dict()
    plain = {}
    for dtype, logits in ((torch.bfloat16, cfg.logits_dtype),
                          (torch.float32, "float32")):
        mdl = DIT(dataclasses.replace(cfg, attn_backend="xla",
                                            logits_dtype=logits),
                  dtype, device="cuda", init=False).eval()
        mdl.load_state_dict(state)
        plain[dtype] = mdl
    x, sigma, modality = forward_inputs(engine, 2 * REQUESTS, seed)
    with torch.inference_mode():
        kern = engine.model(x, sigma, modality=modality).float()
        p16 = plain[torch.bfloat16](x, sigma, modality=modality).float()
        p32 = plain[torch.float32](x, sigma, modality=modality).float()
    torch.cuda.synchronize()
    scale = p32.abs().max().item()
    err_kernel = (kern - p32).abs().max().item()
    err_plain16 = (p16 - p32).abs().max().item()
    err_kernel_vs_plain16 = (kern - p16).abs().max().item()
    finite = bool(torch.isfinite(kern).all().item())
    rec = {"shape": list(kern.shape), "logit_scale": scale,
           "max_abs_err_kernel_bf16_vs_plain_fp32": err_kernel,
           "max_abs_err_plain_bf16_vs_plain_fp32": err_plain16,
           "max_abs_err_kernel_bf16_vs_plain_bf16": err_kernel_vs_plain16,
           "finite": finite}
    print("logits " + json.dumps(rec))
    if not finite or err_kernel > 2 * err_plain16 + 1e-3 * scale:
        raise AssertionError(f"full-width logits through the kernel are "
                             f"off: {rec}")
    del plain
    return rec


def phase_int8_logits(engine, qengine, seed) -> dict:
    """Full-width int8 logits through the kernels (int8_matmul, fused_qmm,
    flash_fwd) against the plain int8 path (plain products, unfused, plain
    attention) at the same int8 weights, and against the bf16 model.

    Truth for the kernels is the plain int8 path in fp32; the kernel path
    (bf16) must be as close to it as the plain int8 path in bf16 is,
    within a factor of 2, in mean absolute error (the max moves with the
    few rows whose int8 activations land a step apart). Against the bf16
    model the int8 logits must track it as tests/test_quant.py asks of the
    JAX int8 DIT: cosine > 0.99 and top-1 agreement > 0.9, the latter
    where the bf16 model's best logit leads its second by more than twice
    the mean |int8 - bf16| logit difference. Over every position top-1
    agreement is recorded, not gated: with random weights and bf16 logits
    the median lead of the best logit is one or two bf16 steps, and the
    JAX package's own int8 DIT agrees with its bf16 model on 0.87-0.91 of
    all positions at such weights (scripts/port_int8_top1.py)."""
    cfg = qengine.config.model
    state = qengine.model.state_dict()
    x, sigma, modality = forward_inputs(qengine, 2 * REQUESTS, seed)
    out = {}
    with torch.inference_mode():
        out["kernel"] = qengine.model(x, sigma, modality=modality).float()
        out["bf16_model"] = engine.model(x, sigma, modality=modality).float()
        for label, dtype, logits in (("plain_bf16", torch.bfloat16,
                                      cfg.logits_dtype),
                                     ("plain_fp32", torch.float32,
                                      "float32")):
            mdl = DIT(dataclasses.replace(
                cfg, attn_backend="xla", quant_backend="xla",
                quant_fused=False, logits_dtype=logits),
                dtype, device="cuda", init=False).eval()
            mdl.load_state_dict(state)
            out[label] = mdl(x, sigma, modality=modality).float()
            del mdl
    torch.cuda.synchronize()
    kern, truth = out["kernel"], out["plain_fp32"]
    err_kernel = (kern - truth).abs().mean().item()
    err_plain16 = (out["plain_bf16"] - truth).abs().mean().item()
    ref = out["bf16_model"]
    cos = ((kern.double() * ref.double()).sum()
           / (kern.double().norm() * ref.double().norm())).item()
    agree = kern.argmax(-1) == ref.argmax(-1)
    top1 = agree.float().mean().item()
    mean_diff = (kern - ref).abs().mean().item()
    best2 = ref.topk(2, dim=-1).values
    clear = (best2[..., 0] - best2[..., 1]) > 2 * mean_diff
    top1_clear = agree[clear].float().mean().item()
    lt, v0 = cfg.txt_length, cfg.text_vocab_size
    top1_img = (kern[:, lt:, v0:].argmax(-1) == ref[:, lt:, v0:].argmax(-1)
                ).float().mean().item()
    finite = bool(torch.isfinite(kern).all().item())
    rec = {"shape": list(kern.shape), "logit_scale": truth.abs().max().item(),
           "mean_abs_err_kernel_bf16_vs_plain_fp32": err_kernel,
           "mean_abs_err_plain_bf16_vs_plain_fp32": err_plain16,
           "max_abs_err_kernel_bf16_vs_plain_fp32":
               (kern - truth).abs().max().item(),
           "max_abs_err_plain_bf16_vs_plain_fp32":
               (out["plain_bf16"] - truth).abs().max().item(),
           "cosine_vs_bf16_model": cos, "top1_vs_bf16_model": top1,
           "top1_vs_bf16_model_image_span": top1_img,
           "top1_vs_bf16_model_clear_margin": top1_clear,
           "share_clear_margin": clear.float().mean().item(),
           "mean_abs_diff_vs_bf16_model": mean_diff, "finite": finite}
    print("int8_logits " + json.dumps(rec))
    del out, kern, truth, ref, agree, best2, clear
    if (not finite or err_kernel > 2 * err_plain16 or not cos > 0.99
            or not top1_clear > 0.9):
        raise AssertionError(f"full-width int8 logits through the kernels "
                             f"are off: {rec}")
    return rec


TINY_OVERRIDES = {
    "model.hidden_size": 128, "model.n_heads": 2, "model.n_blocks": 2,
    "model.cond_dim": 32, "model.length": 24, "model.txt_length": 8,
    "model.img_length": 16, "model.text_vocab_size": 24,
    "model.image_vocab_size": 40, "model.time_conditioning": True,
    "model.qk_norm": True, "model.norm_type": "rms",
    "model.sandwich_normalization": True, "model.modality_embed": True,
    "model.rope_2d": True, "model.dropout": 0.0,
    "model.force_argmax_valid_indices": True,
    "sampling.predictor": "maskgit", "sampling.steps": 5,
    "sampling.cfg": 2.0}
TINY_BATCH = 4


def build_sampler_of(kind, cfg, model, inject_noise, device="cuda"):
    """The t2i sampler (its cached_cond settings from cfg) or the generic
    one."""
    s = cfg.sampling
    if kind == "t2i":
        return build_t2i_sampler(model, cfg, inject_noise=inject_noise,
                                 cached_cond=s.cached_cond,
                                 cond_refresh=s.cached_cond_refresh,
                                 device=device)
    return build_sampler(model, cfg, inject_noise=inject_noise,
                         device=device)


def sampler_inputs(kind, m, batch, steps, gen):
    """(inputs, injected) of a sampler on the card, from `gen`: text
    tokens, or x0 / x0_unmask / modality with the text given on every row
    but one (a joint row); Gumbel and exponential noise of the injected
    contract."""
    kw = dict(generator=gen, device="cuda")
    txt = torch.randint(0, m.mask_index, (batch, m.txt_length), **kw)

    def gumbel(shape):
        return -torch.log(-torch.log(torch.rand(shape, **kw)))

    if kind == "t2i":
        return (txt,), {
            "gumbel_tok": gumbel((steps, batch, m.img_length,
                                  m.image_vocab_size)),
            "gumbel_conf": gumbel((steps, batch, m.img_length))}
    x0 = torch.cat([txt, torch.full((batch, m.img_length), m.mask_index,
                                    device="cuda")], 1)
    unmask = torch.zeros_like(x0, dtype=torch.bool)
    unmask[:, :m.txt_length] = True
    unmask[-1, :m.txt_length] = False
    modality = (torch.arange(m.length, device="cuda") >= m.txt_length) \
        .long().expand(batch, -1)
    shape = (steps, batch, m.length)
    return (x0, unmask, modality), {
        "exp": torch.empty(shape + (m.vocab_size,), device="cuda")
        .exponential_(generator=gen),
        "gumbel": gumbel(shape)}


def phase_sampler_cpu_agreement(seed, int8=False, kind="t2i",
                                cached_cond=False) -> dict:
    """The port's sampler on the card against the port on the CPU (which
    tests/test_torch_t2i.py and tests/test_torch_sampler.py hold token for
    token to the JAX samplers), on a tiny fp32 model with the same injected
    noise: the t2i sampler (with cached_cond, conditioning-frozen) or the
    generic maskgit sampler, CFG 2.0; with `int8`, on the model quantized
    with the flagship's int8 settings (the kernels on the card, their
    plain versions on the CPU)."""
    over = {**TINY_OVERRIDES, "model.attn_backend": "xla",
            "sampling.cached_cond": cached_cond}
    if int8:
        over.update({"model.quant_backend": "pallas",
                     "model.quant_fused": True})
    cfg = Config.make("tiny", **over)
    m = cfg.model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args, injected = sampler_inputs(kind, m, TINY_BATCH,
                                    cfg.sampling.steps, gen)
    cpu_model = DIT(m, compute_dtype=torch.float32).eval()
    gpu_model = DIT(m, compute_dtype=torch.float32).to("cuda").eval()
    randomize_(gpu_model, seed)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               gpu_model.state_dict().items()})
    if int8:
        cfg, cpu_model = quantize_model(cfg, cpu_model)
        gpu_model = DIT(cfg.model, compute_dtype=torch.float32) \
            .to("cuda").eval()
        gpu_model.load_state_dict(cpu_model.state_dict())
    toks = {}
    for dev, mdl in (("cpu", cpu_model), ("cuda", gpu_model)):
        sample = build_sampler_of(kind, cfg, mdl, True, device=dev)
        toks[dev] = sample(*(a.to(dev) for a in args),
                           injected={k: v.to(dev) for k, v in
                                     injected.items()}).tokens.cpu()
    agree = float((toks["cpu"] == toks["cuda"]).float().mean().item())
    rec = {"token_agreement": agree, "int8": int8, "sampler": kind,
           "cached_cond": cached_cond}
    print("sampler_cpu_vs_cuda " + json.dumps(rec))
    if agree < 0.95:
        raise AssertionError(f"the sampler on the card disagrees with the "
                             f"CPU: {rec}")
    return rec


# name, int8, sampler, overrides: the captured paths held to the eager
# samplers
GRAPH_CASES = [
    ("t2i_bf16", False, "t2i", {}),
    ("t2i_int8", True, "t2i", {}),
    ("frozen_int8", True, "t2i", {"sampling.cached_cond": True}),
    ("refresh_2_int8_kv_int8", True, "t2i", {
        "sampling.cached_cond": True, "sampling.cached_cond_refresh": 2,
        "model.kv_cache_dtype": "int8"}),
    ("generic_maskgit", False, "generic", {}),
]
GRAPH_STEPS = 4     # at flagship width: the injected noise is (steps, B,
#                     L, 48385) fp32 for the generic sampler


def phase_graph_vs_eager(models, label, batch, steps, seed) -> dict:
    """Each captured path (sampling/graph.py) against its eager sampler
    under the same injected noise: tokens and NFE equal. `models` maps
    int8 (False / True) to (config, model)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    rec = {}
    for name, int8, kind, extra in GRAPH_CASES:
        cfg, model = models[int8]
        cfg = cfg.override(**{"sampling.steps": steps, **extra})
        sample = build_sampler_of(kind, cfg, model, True)
        args, injected = sampler_inputs(kind, cfg.model, batch, steps, gen)
        want = sample(*args, injected=injected)
        program = captured(sample, batch)
        got = program(*args, injected=injected)
        torch.cuda.synchronize()
        agree = (got.tokens == want.tokens).float().mean().item()
        rec[name] = {"batch": batch, "steps": steps, "token_agreement":
                     agree, "nfe": [got.nfe, want.nfe],
                     "graph_build_s": program.build_s}
        if agree != 1.0 or got.nfe != want.nfe:
            raise AssertionError(f"graph_vs_eager {label} {name}: the "
                                 f"captured program differs from the "
                                 f"eager sampler: {rec[name]}")
        del sample, program, injected, want, got
        gc.collect()
    print(f"graph_vs_eager_{label} " + json.dumps(rec))
    return rec


def tiny_models(seed) -> dict:
    """The tiny bf16 model on the card and its int8 (flagship settings)
    quantization, for phase_graph_vs_eager."""
    cfg = Config.make("tiny", **TINY_OVERRIDES)
    model = DIT(cfg.model, torch.bfloat16, device="cuda", init=False).eval()
    randomize_(model, seed)
    qcfg = cfg.override(**{"model.quant_backend": "pallas",
                           "model.quant_fused": True})
    return {False: (cfg, model), True: quantize_model(qcfg, model)}


def batch_inputs(engine, prepared):
    """(t2i?, the sampler's inputs) of one served batch, as run_batch
    builds them."""
    m = engine.m
    x0 = np.stack([p["x0"] for p in prepared])
    if all(p["fastpath"] for p in prepared):
        return True, (torch.from_numpy(x0[:, :m.txt_length]),)
    unmask = np.stack([p["unmask"] for p in prepared])
    return False, (x0, unmask, engine._layout(len(prepared)))


def check_results(engine, prepared, results, tokens) -> None:
    """The served results: image ids in the codebook, every given token
    kept, a text prompt unchanged, the NFE the step count (plus one where
    the noise-removal pass ran); `tokens` (a captured run of the same
    batch) holds no mask and only its modality's ids."""
    m = engine.m
    steps = engine.config.sampling.steps
    lt, v0 = m.txt_length, m.text_vocab_size
    for i, (p, r) in enumerate(zip(prepared, results)):
        ids = r["image_ids"]
        if ids.shape != (1, m.img_length):
            raise AssertionError(f"image_ids shape {ids.shape}")
        if ids.min() < 0 or ids.max() >= m.image_vocab_size:
            raise AssertionError("image token outside the image codebook "
                                 "(a mask or text token was left)")
        known = p["unmask"][lt:]
        if not np.array_equal(ids[0][known] + v0, p["x0"][lt:][known]):
            raise AssertionError("a given image token changed")
        if p["task"] == "gen_image" and r["text"] != p["prompt"]:
            raise AssertionError(f"text span changed: {r['text']!r}")
        if r["nfe"] not in (steps, steps + 1):
            raise AssertionError(f"nfe {r['nfe']}")
        row = tokens[i].cpu().numpy()
        if (row == m.mask_index).any() or (row[:lt] >= v0).any() \
                or (row[lt:] < v0).any():
            raise AssertionError("a mask, or an id of the other modality, "
                                 "was left in the tokens")
        if not np.array_equal(row[p["unmask"]], p["x0"][p["unmask"]]):
            raise AssertionError("a given token changed")


def expected_serve_launches(m, s, nfe, t2i=True) -> dict:
    """Kernel launches of one served batch of `nfe` forwards, from the
    code. A forward is one trunk pass (at the CFG batch) and the head:
    each block one attention and, in int8, four products, the adaLN ones
    (attn_qkv, mlp.0) behind the fused prologue, the others and the head
    behind a per-row quantize; the t2i sampler applies guidance before its
    one head product. A forward that writes a KV cache leaves the fused
    prologue (four per-row quantizes a block): the frozen paths' step 0,
    and every forward of the refresh paths."""
    n = m.n_blocks

    # int8 products a block: attn_qkv, attn_out, mlp.0, mlp.2; under MoE
    # the experts stay in floating point (validate() keeps quant_fused off)
    products = 2 if m.moe_experts else 4

    def forward(fused):
        want = {"flash_fwd": n}
        if m.quant == "int8":
            if m.quant_backend == "pallas":
                want["int8_matmul"] = products * n + 1
            if fused:
                want["fused_qmm"] = 2 * n
            want["dynamic_quantize"] = (2 if fused else products) * n + 1
        return collections.Counter(want)

    fused = m.quant == "int8" and m.quant_fused
    total = collections.Counter()
    if t2i and s.cached_cond and s.cached_cond_refresh == 0:
        total += forward(False)
        for _ in range(nfe - 1):
            total += forward(fused)
    else:
        for _ in range(nfe):
            total += forward(fused and not (t2i and s.cached_cond))
    return dict(total)


def t2i_requests(engine) -> list:
    prompts = [f"a watercolor painting of a lighthouse, variant {i}"
               for i in range(REQUESTS)]
    out = []
    for text in prompts:
        p = engine.prepare(text=text)
        p["prompt"] = text
        out.append(p)
    return out


def gen_text_requests(engine, seed) -> list:
    """Image -> caption requests with given image ids."""
    m = engine.m
    rng = np.random.RandomState(seed)
    return [engine.prepare(image_ids=rng.randint(0, m.image_vocab_size,
                                                 m.img_length))
            for _ in range(REQUESTS)]


def phase_serve(engine, prepared, label="serve", eager=True) -> dict:
    """Serve one batch of REQUESTS through InferenceEngine.run_batch, which
    runs the sampler's captured program. The first batch captures it; the
    counted run (counts to 0 just before, read just after) then replays
    it, and its launches must be exactly those derived from the code. The
    captured program is held to the eager sampler at the same seed, and
    SERVE_ROUNDS steady batches of each are timed (eager=False: the
    captured batches only, for a path whose eager sampler an earlier
    phase already read; the eager batches are timed on phase 4's
    SERVE_PATHS only)."""
    m, s = engine.m, engine.config.sampling
    t2i, args = batch_inputs(engine, prepared)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_batch(prepared, seed=0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    sample = engine._samplers[("t2i" if t2i else "generic", s.steps)]
    program = sample.graphs[REQUESTS]

    # the counted run: counts to 0 just before, read just after
    _build.reset_launch_counts()
    results = engine.run_batch(prepared, seed=0)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    nfe = results[0]["nfe"]
    want = expected_serve_launches(m, s, nfe, t2i)
    if launches != want:
        raise AssertionError(f"{label}: the main path launched {launches}; "
                             f"expected {want} (n_blocks {m.n_blocks}, NFE "
                             f"{nfe})")
    tokens = program(*args, seed=0).tokens
    check_results(engine, prepared, results, tokens)

    def steady(run):
        times = []
        for i in range(SERVE_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(i + 1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times

    captured_s = steady(lambda i: engine.run_batch(prepared, seed=i))
    unmask = np.stack([p["unmask"] for p in prepared])
    gen_tokens = int((~unmask).sum())
    rec = {"requests": REQUESTS, "nfe": nfe, "sampler": "t2i" if t2i
           else f"generic {s.predictor}", "cached_cond": s.cached_cond,
           "launches": launches, "expected_launches": want,
           "generated_tokens": gen_tokens, "first_batch_s": first_s,
           "graph_build_s": program.build_s,
           "captured_launches_per_replay": dict(program.launches),
           "steady_batch_s": captured_s,
           "steady_tok_per_s": gen_tokens / min(captured_s),
           "distinct_outputs": len({tokens[i].cpu().numpy().tobytes()
                                    for i in range(REQUESTS)})}
    if eager:
        # the seeded comparison: the program's generator against the
        # eager sampler's at the same seed
        e_tokens = sample(*args, generator=torch.Generator(device="cuda")
                          .manual_seed(0)).tokens
        rec["eager_same_seed_token_agreement"] = (
            e_tokens == tokens).float().mean().item()
    if eager and label in SERVE_PATHS:
        eager_s = steady(lambda i: sample(*args, generator=torch.Generator(
            device="cuda").manual_seed(i)))
        rec.update(eager_steady_batch_s=eager_s,
                   eager_steady_tok_per_s=gen_tokens / min(eager_s))
    print(f"{label} " + json.dumps(rec))
    print(f"{label}_tok_per_s " + json.dumps({
        "captured_steady_tok_per_s": rec["steady_tok_per_s"],
        "eager_steady_tok_per_s": rec.get("eager_steady_tok_per_s")}))
    return rec


def free(*engines) -> None:
    """Drop engines and their captured programs' memory pools."""
    for engine in engines:
        engine._samplers.clear()
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# pixels: the VQ-16 codec behind the engine
# ---------------------------------------------------------------------------

def codec_flops(module, fn) -> float:
    """The multiply-adds x 2 of every convolution and product that fn runs
    in `module` (conv and linear hooks; the attention blocks' products
    counted from their shapes), from one call."""
    total = [0.0]

    def conv_hook(mod, inputs, out):
        k = mod.weight[0].numel()     # cin x kernel volume, or in_features
        total[0] += 2.0 * out.numel() * k

    def attn_hook(mod, inputs, out):
        b, c, h, w = inputs[0].shape
        total[0] += 2 * 2.0 * b * (h * w) ** 2 * c

    def vit_attn_hook(mod, inputs, out):
        # the packed q, k, v product and the two attention products (the
        # output projection is a Linear of its own)
        b, n, h = inputs[0].shape
        total[0] += 2.0 * b * n * 3 * h * h + 2 * 2.0 * b * n * n * h

    from unidisc_tpu_torch.tokenizers.titok import SelfAttention
    from unidisc_tpu_torch.tokenizers.vqgan import AttnBlock
    hook_of = {AttnBlock: attn_hook, SelfAttention: vit_attn_hook}
    hooks = [m.register_forward_hook(hook_of.get(type(m), conv_hook))
             for m in module.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d,
                               torch.nn.Linear, AttnBlock, SelfAttention))]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def close_record(got, want) -> dict:
    """The error of `got` against `want`, and its largest excess over
    CODEC_ATOL + CODEC_RTOL |want| (<= 0 within tolerance)."""
    excess = ((got - want).abs()
              - (CODEC_ATOL + CODEC_RTOL * want.abs())).max().item()
    return {"max_abs_err": (got - want).abs().max().item(),
            "max_abs": want.abs().max().item(),
            "max_excess_over_tol": excess}


def phase_codec_cpu_vs_card(codec, seed) -> dict:
    """The codec module on the card against a CPU copy, at
    CODEC_CHECK_PX: encode latents, ids where the CPU's top-2 margin
    exceeds ID_MARGIN, and the decode of the CPU's ids."""
    card = codec.module
    cpu = copy.deepcopy(card).cpu()
    gen = torch.Generator().manual_seed(seed)
    imgs = torch.rand((2, CODEC_CHECK_PX, CODEC_CHECK_PX, 3),
                      generator=gen) * 2 - 1
    with torch.no_grad():
        z_cpu = cpu.latents(imgs)
        z_card = card.latents(imgs.cuda())
        ids_cpu = cpu.quantize(z_cpu).reshape(2, -1)
        ids_card = card.quantize(z_card).reshape(2, -1).cpu()
        rec_cpu = cpu.decode(ids_cpu)
        rec_card = card.decode(ids_cpu.cuda()).cpu()
        cb = cpu._codes()
        zf = z_cpu.permute(0, 2, 3, 1).reshape(-1, z_cpu.shape[1])
        zf = zf / zf.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        top = (2.0 * (zf @ cb.T) - (cb ** 2).sum(-1)).topk(2, -1).values
        margin = (top[:, 0] - top[:, 1]).reshape(2, -1)
    z_card = z_card.cpu()
    clear = margin > ID_MARGIN
    rec = {"image_px": CODEC_CHECK_PX, "batch": 2,
           "latents": close_record(z_card, z_cpu),
           "pixels": close_record(rec_card, rec_cpu),
           "ids_clear_margin_share": clear.float().mean().item(),
           "ids_equal_share": (ids_card == ids_cpu).float().mean().item(),
           "ids_equal_where_clear": bool(torch.equal(ids_card[clear],
                                                     ids_cpu[clear])),
           "atol": CODEC_ATOL, "rtol": CODEC_RTOL, "id_margin": ID_MARGIN}
    print("codec_cpu_vs_cuda " + json.dumps(rec))
    torch.testing.assert_close(z_card, z_cpu, atol=CODEC_ATOL,
                               rtol=CODEC_RTOL)
    torch.testing.assert_close(rec_card, rec_cpu, atol=CODEC_ATOL,
                               rtol=CODEC_RTOL)
    if not rec["ids_equal_where_clear"] or rec["ids_clear_margin_share"] \
            < 0.9:
        raise AssertionError(f"codec ids on the card differ from the CPU's "
                             f"where the margin is clear: {rec}")
    return rec


def alternate_steady(runs: dict, rounds: int = 2) -> dict:
    """Seconds of each run, taken in turns (a, b, a, b, ...), each ending
    in a device sync."""
    times = {name: [] for name in runs}
    for i in range(rounds):
        for name, run in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(i + 1)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    return times


def phase_pixels_serve(engine, label, eager=True) -> tuple:
    """8 t2i requests through an engine with the codec: the counted,
    captured batch of phase_serve, then eight 256-px PNGs that hold the
    decode of the returned ids (to one step where an fp32 value lies on an
    integer boundary), and the batch timed with and without the decode.
    Returns (the served record, this phase's record, the results)."""
    prepared = t2i_requests(engine)
    served = phase_serve(engine, prepared, label, eager)
    results = engine.run_batch(prepared, seed=0)
    codec, m = engine.codec, engine.m
    size = math.isqrt(m.img_length) * codec.downsample
    pngs = []
    for r in results:
        if len(r.get("images_b64", [])) != 1:
            raise AssertionError(f"{label}: a t2i result without its PNG")
        pngs.append(decode_png(base64.b64decode(r["images_b64"][0])))
    pngs = np.stack(pngs)
    if pngs.shape != (REQUESTS, size, size, 3):
        raise AssertionError(f"{label}: PNGs of shape {pngs.shape}")
    ids = torch.from_numpy(np.concatenate([r["image_ids"] for r in results])
                           .clip(0, m.image_vocab_size - 1)).cuda()
    want = to_uint8(codec.decode(ids)).cpu().numpy()
    diff = np.abs(pngs.astype(np.int16) - want.astype(np.int16))
    if diff.max() > 1:
        raise AssertionError(f"{label}: the PNGs differ from the decode of "
                             f"the returned ids by {diff.max()}")

    decode_ms = time_ms(lambda: codec.decode(ids), iters=10, warmup=2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    codec.decode(ids)
    torch.cuda.synchronize()
    decode_peak = torch.cuda.max_memory_allocated() - base
    flops = codec_flops(codec.module, lambda: codec.decode(ids))
    t0 = time.perf_counter()
    for img in want:
        encode_image_b64(img)
    png_ms = (time.perf_counter() - t0) * 1e3

    def without_codec(i):
        engine.codec = None
        try:
            engine.run_batch(prepared, seed=i)
        finally:
            engine.codec = codec

    steady = alternate_steady({
        "with": lambda i: engine.run_batch(prepared, seed=i),
        "without": without_codec})
    with_s, without_s = min(steady["with"]), min(steady["without"])
    rec = {"requests": REQUESTS, "image_px": size,
           "png_equal_share": float((diff == 0).mean()),
           "png_max_diff": int(diff.max()),
           "decode_ms": decode_ms, "decode_conv_gflop": flops / 1e9,
           "decode_fp32_bound_ms": flops / FP32_FLOP_PER_S * 1e3,
           "decode_peak_bytes": decode_peak,
           "png_encode_host_ms": png_ms,
           "steady_batch_s_with_decode": steady["with"],
           "steady_batch_s_without_decode": steady["without"],
           "decode_share_of_batch": decode_ms / 1e3 / with_s,
           "with_minus_without_s": with_s - without_s}
    print(f"{label}_pixels " + json.dumps(rec))
    return served, rec, results


def phase_pixels_caption(engine, results) -> tuple:
    """The served PNGs back through decode_image_b64 -> codec.encode ->
    prepare(image_ids=) -> gen_text: eight captions, the given image ids
    kept and no PNG returned. Returns (the served record, this record)."""
    codec = engine.codec
    images = np.stack([decode_image_b64(r["images_b64"][0])
                       for r in results])
    images_dev = torch.from_numpy(images).cuda()
    ids = codec.encode(images_dev)
    if ids.shape != (REQUESTS, engine.m.img_length) or ids.min() < 0 or \
            ids.max() >= codec.vocab_size:
        raise AssertionError(f"encoded ids {tuple(ids.shape)}, range "
                             f"{ids.min().item()}..{ids.max().item()}")
    encode_ms = time_ms(lambda: codec.encode(images_dev), iters=10,
                        warmup=2)
    flops = codec_flops(codec.module, lambda: codec.encode(images_dev))
    # the codebook search: one (B x 256, 256) x (256, 16384) product
    search = 2.0 * ids.numel() * codec.module.cfg.codebook_dim \
        * codec.vocab_size
    prepared = [engine.prepare(image_ids=row) for row in ids.cpu().numpy()]
    served = phase_serve(engine, prepared, "pixels_caption", eager=False)
    captions = engine.run_batch(prepared, seed=0)
    for p, r in zip(prepared, captions):
        if r["task"] != "gen_text" or not isinstance(r["text"], str) or \
                "images_b64" in r:
            raise AssertionError(f"caption result {r['task']} {r.keys()}")
    rec = {"requests": REQUESTS, "encode_ms": encode_ms,
           "encode_conv_gflop": flops / 1e9,
           "encode_codebook_search_gflop": search / 1e9,
           "encode_fp32_bound_ms": (flops + search) / FP32_FLOP_PER_S * 1e3,
           "captions": [r["text"] for r in captions]}
    print("pixels_caption_text " + json.dumps(rec))
    return served, rec


def phase_pixels(seed, qstate) -> dict:
    """Phase 4e: the codec on the card against the CPU, served pixels in
    bf16 and int8, and captions from those pixels."""
    t0 = time.perf_counter()
    engine = build_engine(preset="small", overrides=FLAGSHIP_OVERRIDES,
                          codec_name=CODEC)
    randomize_(engine.model, seed)              # phase 4's weights
    rec = {"engine_build_s": time.perf_counter() - t0,
           "codec_params": sum(p.numel() for p in
                               engine.codec.module.parameters())}
    rec["cpu_vs_cuda"] = phase_codec_cpu_vs_card(engine.codec, seed)
    # phase 4's serve and serve_int8 read these engines' eager samplers
    served, rec["bf16"], results = phase_pixels_serve(engine,
                                                      "pixels_serve",
                                                      eager=False)
    served_caption, rec["caption"] = phase_pixels_caption(engine, results)
    free(engine)
    del engine
    qengine = build_engine(preset="small", overrides=FLAGSHIP_INT8_OVERRIDES,
                           quantize="int8", codec_name=CODEC)
    qengine.model.load_state_dict(qstate)      # 4b's int8 weights
    served_int8, rec["int8"], _ = phase_pixels_serve(
        qengine, "pixels_serve_int8", eager=False)
    free(qengine)
    del qengine
    free()
    return {"pixels": rec, "pixels_serve": served,
            "pixels_caption": served_caption,
            "pixels_serve_int8": served_int8}


def phase_generate(run_dir, final_ema, root) -> dict:
    """Phase 5b: the generate CLI on the train phase's run dir with its
    EMA weights and the VQ-16 codec."""
    out = os.path.join(root, "samples")
    prompt = "a watercolor painting of a lighthouse"
    meta = os.path.join(run_dir, "checkpoints", str(TRAIN_STEPS),
                        "meta.json")
    with open(meta) as f:
        img_length = json.load(f)["config"]["model"]["img_length"]
    size = math.isqrt(img_length) * 16             # VQ-16's downsample
    t0 = time.perf_counter()
    result = generate.main(["--ckpt", run_dir, "--out", out, "--codec",
                            CODEC, "--image-size", str(size), "--n",
                            str(REQUESTS), "--prompt", prompt, "--use-ema"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    engine = result["engine"]
    with open(os.path.join(out, "samples.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    pngs = sorted(n for n in os.listdir(out) if n.endswith(".png"))
    if len(lines) != REQUESTS or len(pngs) != REQUESTS:
        raise AssertionError(f"generate wrote {len(lines)} lines and "
                             f"{len(pngs)} PNGs")
    for name in pngs:
        with open(os.path.join(out, name), "rb") as f:
            shape = decode_png(f.read()).shape
        if shape != (size, size, 3):
            raise AssertionError(f"{name}: {shape}")
    if result["step"] != TRAIN_STEPS:
        raise AssertionError(f"generate restored step {result['step']}")
    for name, value in engine.model.state_dict().items():
        if not torch.equal(value.cpu(), final_ema[name]):
            raise AssertionError(f"generate's {name} is not the trainer's "
                                 f"final EMA")
    rec = {"step": result["step"], "samples": len(lines), "pngs": len(pngs),
           "weights_equal_final_ema": True, "wall_s": wall_s,
           "texts": sorted({r["text"] for r in lines})}
    free(engine)
    return rec


# ---------------------------------------------------------------------------
# 4h: the codecs left (MAGVITv2, TiTok, the video VQVAE, the Chameleon
# stream, the structural remap)
# ---------------------------------------------------------------------------

# the served codecs: (path label, codec name); the model's image vocabulary
# is the codec's 8,192 codes, as a model trained on its tokens has
CODECS_SERVED = (("codecs_magvit", "magvitv2"), ("codecs_titok", "titok256"))
CODECS_PATHS = tuple(label for label, _ in CODECS_SERVED)
CODECS_IMAGE_VOCAB = 8192
CODECS_CAPTIONS = 2        # served PNGs captioned back through the encoder
TITOK_CHECK_IMAGES = 2     # TiTok runs at its own 256 px only: its CPU copy
VIDEO_CLIPS = 2            # get_video_codec()'s 16 frames of 64 px
CLEAR_SHARE = 0.9          # ids compared where the margin is clear: at least
#                            this share of them must be


def lfq_margin(module, z):
    """MAGVIT's id is z's sign pattern: the smallest |z| of a position."""
    return z.abs().min(-1).values


def vq_margin(scores):
    top = scores.topk(2, -1).values
    return top[..., 0] - top[..., 1]


def titok_margin(module, z):
    cb = module._codes()
    return vq_margin(2.0 * (z @ cb.T) - (cb ** 2).sum(-1))


def video_margin(module, z):
    cb = module._codes()
    z = z / z.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    return vq_margin(z @ cb.T - 0.5 * (cb * cb).sum(-1))


def vqgan_margin(module, z):
    """The top-2 margin of a VQGAN's codebook scores over the top score's
    magnitude, (B, h, w) from latents (B, D, h, w): relative, because
    raw codes (chameleon-vqgan's) drawn uniform in [0, 2/N) make every
    score small."""
    cb = module._codes()
    zf = z.permute(0, 2, 3, 1)
    if module.cfg.l2_norm_codes:
        zf = zf / zf.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    scores = 2.0 * (zf @ cb.T) - (cb ** 2).sum(-1)
    return vq_margin(scores) / scores.abs().amax(-1).clamp_min(1e-30)


def module_cpu_vs_card(label, card, cpu, x, margin, decode=None) -> dict:
    """A codec module on the card against its CPU copy (fp32 on both
    sides): the encoder's latents within CODEC_ATOL / CODEC_RTOL, the ids
    equal where the CPU's margin exceeds ID_MARGIN (at least CLEAR_SHARE
    of them), and the decode of the CPU's ids within the same tolerance."""
    decode = decode or (lambda m, ids: m.decode(ids))
    with torch.no_grad():
        z_cpu = cpu.latents(x)
        z_card = card.latents(x.cuda())
        ids_cpu = cpu.quantize(z_cpu)
        ids_card = card.quantize(z_card).cpu()
        clear = margin(cpu, z_cpu) > ID_MARGIN
        b = x.shape[0]
        rec_cpu = decode(cpu, ids_cpu.reshape(b, -1))
        rec_card = decode(card, ids_cpu.reshape(b, -1).cuda()).cpu()
    z_card = z_card.cpu()
    rec = {"batch": b, "input_shape": list(x.shape[1:]),
           "latents": close_record(z_card, z_cpu),
           "decode": close_record(rec_card, rec_cpu),
           "ids_clear_margin_share": clear.float().mean().item(),
           "ids_equal_share": (ids_card == ids_cpu).float().mean().item(),
           "ids_equal_where_clear": bool(torch.equal(ids_card[clear],
                                                     ids_cpu[clear])),
           "atol": CODEC_ATOL, "rtol": CODEC_RTOL, "id_margin": ID_MARGIN}
    print(f"{label}_cpu_vs_cuda " + json.dumps(rec))
    torch.testing.assert_close(z_card, z_cpu, atol=CODEC_ATOL,
                               rtol=CODEC_RTOL)
    torch.testing.assert_close(rec_card, rec_cpu, atol=CODEC_ATOL,
                               rtol=CODEC_RTOL)
    if not rec["ids_equal_where_clear"] or \
            rec["ids_clear_margin_share"] < CLEAR_SHARE:
        raise AssertionError(f"{label}: ids on the card differ from the "
                             f"CPU's where the margin is clear: {rec}")
    return rec


def codec_times(codec, images) -> dict:
    """encode and decode ms (CUDA events) at the batch of `images`, and
    their convolution and product GFLOP beside the fp32 bound."""
    ids = codec.encode(images)
    rec = {"batch": int(images.shape[0]),
           "encode_ms": time_ms(lambda: codec.encode(images), iters=5,
                                warmup=1),
           "decode_ms": time_ms(lambda: codec.decode(ids), iters=5,
                                warmup=1)}
    for kind, fn in (("encode", lambda: codec.encode(images)),
                     ("decode", lambda: codec.decode(ids))):
        flops = codec_flops(codec.module, fn)
        rec[f"{kind}_gflop"] = flops / 1e9
        rec[f"{kind}_fp32_bound_ms"] = flops / FP32_FLOP_PER_S * 1e3
    return rec


def codec_captions(engine, results) -> dict:
    """CODECS_CAPTIONS served PNGs back through decode_image_b64 ->
    codec.encode -> prepare(image_ids=) -> gen_text: captions, the given
    ids kept, no PNG returned."""
    codec = engine.codec
    images = torch.from_numpy(np.stack([
        decode_image_b64(r["images_b64"][0])
        for r in results[:CODECS_CAPTIONS]])).cuda()
    ids = codec.encode(images)
    if ids.shape != (CODECS_CAPTIONS, engine.m.img_length) or \
            ids.min() < 0 or ids.max() >= codec.vocab_size:
        raise AssertionError(f"encoded ids {tuple(ids.shape)}, range "
                             f"{ids.min().item()}..{ids.max().item()}")
    rows = ids.cpu().numpy()
    captions = engine.run_batch([engine.prepare(image_ids=row)
                                 for row in rows], seed=0)
    for row, r in zip(rows, captions):
        if r["task"] != "gen_text" or not isinstance(r["text"], str) or \
                "images_b64" in r:
            raise AssertionError(f"caption result {r['task']} {r.keys()}")
        if not np.array_equal(r["image_ids"][0], row):
            raise AssertionError("a captioned image's ids changed")
    return {"captions": [r["text"] for r in captions]}


def phase_codec_served(label, name, seed) -> dict:
    """The flagship engine with codec `name` (phase 4's randomize_
    weights, the image vocabulary the codec's): its module on the card
    against a CPU copy, 8 t2i requests served as in 4e (counted launches
    exact, PNGs the decode of the returned ids, the batch with and without
    the decode), captions of CODECS_CAPTIONS of them, and the codec's
    encode and decode ms at batch 8. Returns (this phase's record, the
    served record, the codec)."""
    t0 = time.perf_counter()
    engine = build_engine(preset="small", codec_name=name, overrides={
        **FLAGSHIP_OVERRIDES, "model.image_vocab_size": CODECS_IMAGE_VOCAB})
    randomize_(engine.model, seed)
    codec = engine.codec
    rec = {"codec": codec.name, "engine_build_s": time.perf_counter() - t0,
           "codec_params": sum(p.numel() for p in codec.module.parameters()),
           "image_px": codec.image_size}
    gen = torch.Generator().manual_seed(seed)
    cpu = copy.deepcopy(codec.module).cpu()
    if name.startswith("titok"):
        x = torch.rand((TITOK_CHECK_IMAGES, codec.image_size,
                        codec.image_size, 3), generator=gen) * 2 - 1
        rec["cpu_vs_cuda"] = module_cpu_vs_card(label, codec.module, cpu, x,
                                                titok_margin)
    else:
        x = torch.rand((2, CODEC_CHECK_PX, CODEC_CHECK_PX, 3),
                       generator=gen) * 2 - 1
        rec["cpu_vs_cuda"] = module_cpu_vs_card(label, codec.module, cpu, x,
                                                lfq_margin)
    del cpu
    # 4's served batch read the flagship's eager sampler; 4h's paths differ
    # from it by the codec, which the eager sampler does not run
    served, rec["pixels"], results = phase_pixels_serve(engine, label,
                                                        eager=False)
    rec["caption"] = codec_captions(engine, results)
    images = torch.from_numpy(np.stack([decode_image_b64(r["images_b64"][0])
                                        for r in results])).cuda()
    rec["times_b8"] = codec_times(codec, images)
    free(engine)
    return rec, served, codec


def phase_video_codec(seed) -> dict:
    """get_video_codec() at its defaults on the card against a CPU copy
    (the same weights, drawn from the factory's seed), VIDEO_CLIPS clips;
    encode and decode ms."""
    card = get_video_codec()
    cpu = get_video_codec(device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    clips = torch.rand((VIDEO_CLIPS, card.frames, card.image_size,
                        card.image_size, 3), generator=gen) * 2 - 1
    d = card.downsample
    grids = (card.frames // d, card.image_size // d)
    rec = module_cpu_vs_card("video", card.module, cpu.module, clips,
                             video_margin,
                             decode=lambda m, ids: m.decode(ids, *grids))
    rec["times"] = codec_times(card, clips.cuda())
    rec["tokens_per_clip"] = grids[0] * grids[1] ** 2
    return rec


def phase_chameleon_stream(seed) -> dict:
    """tokenize_t2i_batch with chameleon-vqgan on the card against the
    same codec on the CPU: var-aspect crops (300 x 150 images: halved,
    then an antialiased resize to the (128, 64) crop of
    build_crop_size_list(max_grids=32)), the streams equal where the VQ
    margin is clear."""
    card = get_codec("chameleon-vqgan")
    cpu = get_codec("chameleon-vqgan", device="cpu")
    sizes = build_crop_size_list(patch_size=16, max_grids=32)
    rng = np.random.default_rng(seed)
    images = rng.random((4, 300, 150, 3)).astype(np.float32) * 2 - 1
    tok = get_tokenizer("byte")
    spec = ChameleonSpec(text_vocab=tok.vocab_size,
                         img_vocab=card.vocab_size, patch_size=16)
    captions = [f"a var-aspect picture, variant {i}" for i in range(4)]
    t0 = time.perf_counter()
    streams = {dev: tokenize_t2i_batch(
        spec, tok, codec, images, captions, 256, sizes,
        np.random.default_rng(seed + 1))
        for dev, codec in (("card", card), ("cpu", cpu))}
    card_s = time.perf_counter() - t0
    # the same crops again, for the CPU's margins
    crop_rng = np.random.default_rng(seed + 1)
    crops = np.stack([var_center_crop(im, sizes, crop_rng) for im in images])
    with torch.no_grad():
        margin = vqgan_margin(cpu.module, cpu.module.latents(
            torch.from_numpy(crops)))
    clear = (margin > ID_MARGIN).reshape(len(images), -1).numpy()
    (ids_card, mask_card), (ids_cpu, mask_cpu) = streams["card"], \
        streams["cpu"]
    if not np.array_equal(mask_card, mask_cpu):
        raise AssertionError("chameleon: the streams' masks differ")
    equal_where_clear = True
    for i in range(len(images)):
        text_a, grids_a = decode_stream(spec, ids_card[i][mask_card[i]])
        text_b, grids_b = decode_stream(spec, ids_cpu[i][mask_cpu[i]])
        if not np.array_equal(text_a, text_b) or len(grids_a) != 1 or \
                len(grids_b) != 1 or grids_a[0].shape != (8, 4):
            raise AssertionError(f"chameleon: stream {i} differs outside "
                                 f"its image ids")
        equal_where_clear &= bool(np.array_equal(
            grids_a[0].reshape(-1)[clear[i]], grids_b[0].reshape(-1)[clear[i]]))
    rec = {"images": len(images), "crop_hw": list(crops.shape[1:3]),
           "stream_length": int(mask_card[0].sum()),
           "ids_clear_margin_share": float(clear.mean()),
           "streams_equal_share": float((ids_card == ids_cpu).mean()),
           "equal_where_clear": equal_where_clear,
           "tokenize_s_card_and_cpu": card_s}
    print("chameleon_stream " + json.dumps(rec))
    if not equal_where_clear or rec["ids_clear_margin_share"] < CLEAR_SHARE:
        raise AssertionError(f"chameleon: streams differ where the margin "
                             f"is clear: {rec}")
    return rec


def foreign_magvit_name(key: str) -> str:
    """A mirror key in a taming / open-magvit2 flavoured naming: other
    section names, dotted block paths, renamed norm leaves; the order
    kept."""
    for a, b in (("encoder.", "enc_net."), ("decoder.", "dec_net."),
                 ("down_", "down."), ("up_", "up."), ("_block_", ".blk."),
                 ("_downsample", ".pool"), ("_upsample", ".unpool"),
                 ("mid_block_1", "middle.one"), ("mid_block_2", "middle.two"),
                 ("norm1.weight", "norm1.gamma"),
                 ("norm1.bias", "norm1.beta")):
        key = key.replace(a, b)
    return key


def phase_remap(codec) -> dict:
    """load_magvit_foreign of the card module's weights under foreign
    names (with a discriminator's keys beside them): a module loaded
    from the remapped state_dict decodes exactly as the original."""
    module = codec.module
    foreign = {foreign_magvit_name(k): v.cpu()
               for k, v in module.state_dict().items()}
    foreign["loss.discriminator.main.0.weight"] = torch.zeros(64, 3, 4, 4)
    t0 = time.perf_counter()
    state, report = load_magvit_foreign(module, foreign)
    remap_s = time.perf_counter() - t0
    fresh = copy.deepcopy(module)
    for p in fresh.parameters():
        p.data.zero_()
    fresh.load_state_dict(state)
    ids = torch.randint(0, codec.vocab_size, (2, 256),
                        generator=torch.Generator().manual_seed(5)).cuda()
    with torch.no_grad():
        same = bool(torch.equal(fresh.decode(ids), module.decode(ids)))
    rec = {"summary": report.summary(), "complete": report.complete,
           "skipped_foreign": report.skipped_foreign,
           "decode_equal": same, "remap_s": remap_s}
    print("codec_remap " + json.dumps(rec))
    if not (report.complete and same and report.skipped_foreign ==
            ["loss.discriminator.main.0.weight"]):
        raise AssertionError(f"remap: {rec}")
    return rec


def phase_codecs_left(seed) -> dict:
    """Phase 4h: MAGVITv2 and titok256 served at the flagship width, the
    video VQVAE, the Chameleon stream and the structural remap."""
    rec = {}
    for label, name in CODECS_SERVED:
        rec[name], rec[label], codec = phase_codec_served(label, name, seed)
        if name == "magvitv2":
            rec["remap"] = phase_remap(codec)
        del codec
        free()
    rec["video"] = phase_video_codec(seed)
    rec["chameleon"] = phase_chameleon_stream(seed)
    free()
    card = card_line()
    print("codecs " + json.dumps({
        "card": card,
        **{name: {"encode_ms_b8": rec[name]["times_b8"]["encode_ms"],
                  "decode_ms_b8": rec[name]["times_b8"]["decode_ms"],
                  "served_batch_s_with_decode": min(
                      rec[name]["pixels"]["steady_batch_s_with_decode"]),
                  "served_batch_s_without_decode": min(
                      rec[name]["pixels"]["steady_batch_s_without_decode"]),
                  "served_tok_per_s": rec[label]["steady_tok_per_s"],
                  "flash_fwd_launches": rec[label]["launches"].get(
                      "flash_fwd", 0)}
           for label, name in CODECS_SERVED},
        "video": {"clips": VIDEO_CLIPS,
                  "encode_ms": rec["video"]["times"]["encode_ms"],
                  "decode_ms": rec["video"]["times"]["decode_ms"]},
        "chameleon_streams_equal_where_clear":
            rec["chameleon"]["equal_where_clear"],
        "remap_decode_equal": rec["remap"]["decode_equal"]}))
    return rec


# ---------------------------------------------------------------------------
# 4f: the serving front door
# ---------------------------------------------------------------------------

ROLL_SLOTS = 8       # the rolling batchers' slots (--rolling 8)
ROLL_CHUNK = 8       # denoise steps a chunk replay
SCAFFOLD_BLOCKS = 4  # the scaffold trunk: the flagship's width and io
SCAFFOLD_STEPS, SCAFFOLD_SPLIT, SCAFFOLD_BATCH = 8, 3, 4
TIMED_REQUESTS, SPACING_S = 16, 0.05
TOKEN_AGREE = 0.95   # the card against the CPU, and whole-batch against
#                      rolling t2i, run other float operations (module
#                      docstring of phase 4f); captured against eager is exact


def build_rolling(kind, model, cfg, slots, chunk, inject_noise,
                  device="cuda"):
    fn = build_rolling_t2i if kind == "t2i" else build_rolling_sampler
    return fn(model, cfg, slots=slots, chunk=chunk,
              inject_noise=inject_noise, device=device)


def rolling_rows(kind, m, n, rng):
    """n requests' insert arguments after the slots: text prompts (t2i),
    or x0 / unmask / modality with the text given (one row infills part of
    its text), and seeds."""
    txt = rng.randint(1, m.mask_index, (n, m.txt_length))
    seeds = rng.randint(0, 2 ** 31 - 1, n)
    if kind == "t2i":
        return (txt, seeds)
    x0 = np.zeros((n, m.length), np.int64)
    x0[:, :m.txt_length] = txt
    unmask = np.zeros((n, m.length), bool)
    unmask[:, :m.txt_length] = True
    unmask[-1, 2:m.txt_length] = False
    modality = np.repeat((np.arange(m.length) >= m.txt_length)
                         .astype(np.int64)[None], n, 0)
    return (x0, unmask, modality, seeds)


def all_done(state, extra) -> bool:
    return bool(((state.step >= state.row_steps + extra)
                 | ~state.active).all())


def phase_rolling_graph_vs_eager(models, label, steps, seed,
                                 lockstep=False) -> dict:
    """The captured chunk program against the eager chunk under the same
    injected noise, generic and t2i: half the slots admitted at chunk 0
    (full steps), the other half at chunk 1 (half the steps, one padding
    row), every state field equal after every chunk. With `lockstep`, all
    slots admitted at once also give the whole-batch captured sampler's
    tokens (agreement >= TOKEN_AGREE for t2i: the whole-batch sampler
    skips the unconditional pass where every weight is 0, step 0; the
    rolling one always runs it)."""
    rec = {}
    for kind in ("t2i", "generic"):
        cfg, model = models
        cfg = cfg.override(**{"sampling.steps": steps})
        m = cfg.model
        S = ROLL_SLOTS
        built = build_rolling(kind, model, cfg, S, 2, True)
        gen = torch.Generator(device="cuda").manual_seed(seed + 11)
        injected = {}
        for name, shape in built.noise_shapes().items():
            u = torch.rand(shape, generator=gen, device="cuda")
            injected[name] = -torch.log(u) if name == "exp" else \
                -torch.log(-torch.log(u))
            del u
        program = CapturedChunk(built)
        eager = built.init_state()
        rng_a, rng_b = np.random.RandomState(seed), np.random.RandomState(seed)
        half = S // 2
        plan = {0: (list(range(half)), [steps] * half),
                1: (list(range(half, S)) + [S], [max(steps // 2, 1)]
                    * (S - half + 1))}
        chunks = 0
        while chunks < 2 or not all_done(eager, built.extra):
            if chunks in plan:
                slots, row_steps = plan[chunks]
                for st, rng in ((eager, rng_a), (program.state, rng_b)):
                    built.insert_many(st, slots, *rolling_rows(
                        kind, m, len(slots), rng), row_steps)
            built.step_chunk(eager, injected)
            program.step_chunk(program.state, injected)
            chunks += 1
            for name, a, b in zip(eager._fields, program.state, eager):
                if not torch.equal(a, b):
                    raise AssertionError(f"rolling_graph_vs_eager {label} "
                                         f"{kind}: {name} differs after "
                                         f"chunk {chunks}")
        r = {"slots": S, "steps": steps, "chunks": chunks,
             "graph_build_s": program.build_s, "state_equal": True}
        if lockstep:
            built.reset(program.state)
            rows = rolling_rows(kind, m, S, np.random.RandomState(seed + 1))
            built.insert_many(program.state, list(range(S)), *rows)
            while not all_done(program.state, built.extra):
                program.step_chunk(program.state, injected)
            sample = build_sampler_of(kind, cfg, model, True)
            args = (torch.from_numpy(rows[0]).cuda(),) if kind == "t2i" \
                else tuple(torch.from_numpy(a).cuda() for a in rows[:3])
            want = captured(sample, S)(*args, injected=injected).tokens
            agree = (program.state.x == want).float().mean().item()
            r["lockstep_vs_whole_batch_agreement"] = agree
            if agree < (1.0 if kind == "generic" else TOKEN_AGREE):
                raise AssertionError(f"rolling lockstep {label} {kind}: "
                                     f"{agree} of the whole-batch captured "
                                     f"sampler's tokens")
            del sample
        rec[kind] = r
        del built, program, eager, injected
        gc.collect()
        torch.cuda.empty_cache()
    print(f"rolling_graph_vs_eager_{label} " + json.dumps(rec))
    return rec


def phase_rolling_cpu_vs_card(seed) -> dict:
    """Keyed noise bit-identical on the CPU and the card; then a staggered
    run with per-row steps 8 and 32 on a tiny fp32 model (plain attention:
    the hand kernels take bf16), eager on the CPU and the captured chunk
    on the card, holding the tokens."""
    seeds = torch.tensor([0, 1, 2 ** 31 - 1, seed])
    steps = torch.tensor([0, 7, 31, 3])
    same = all(torch.equal(keyed_uniform(seeds, steps, tag, n),
                           keyed_uniform(seeds.cuda(), steps.cuda(), tag,
                                         n).cpu())
               for tag, n in ((1, 1 << 20), (2, 384)))
    if not same:
        raise AssertionError("the keyed noise differs on the card")
    cfg = Config.make("tiny", **{**TINY_OVERRIDES, "model.attn_backend": "xla",
                                 "sampling.steps": 32})
    m = cfg.model
    cpu_model = DIT(m, compute_dtype=torch.float32).eval()
    card_model = DIT(m, compute_dtype=torch.float32).to("cuda").eval()
    randomize_(card_model, seed)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               card_model.state_dict().items()})
    rec = {"keyed_uniforms_bit_identical": True}
    for kind in ("t2i", "generic"):
        out = {}
        for dev, mdl in (("cpu", cpu_model), ("cuda", card_model)):
            built = build_rolling(kind, mdl, cfg, 4, ROLL_CHUNK, False, dev)
            program = CapturedChunk(built) if dev == "cuda" else None
            st = program.state if program else built.init_state()
            step = program.step_chunk if program else built.step_chunk
            rng = np.random.RandomState(seed)
            built.insert_many(st, [0, 1], *rolling_rows(kind, m, 2, rng),
                              [8, 32])
            step(st)
            built.insert_many(st, [2, 3], *rolling_rows(kind, m, 2, rng),
                              [32, 8])
            while not all_done(st, built.extra):
                step(st)
            out[dev] = st.x.cpu()
        agree = (out["cpu"] == out["cuda"]).float().mean().item()
        rec[kind] = {"token_agreement": agree}
        if agree < TOKEN_AGREE:
            raise AssertionError(f"rolling {kind} on the card against the "
                                 f"CPU: {agree}")
    print("rolling_cpu_vs_cuda " + json.dumps(rec))
    return rec


def chunk_launches(m, s, t2i=True) -> dict:
    """The launches of one chunk replay: ROLL_CHUNK forwards of the serve
    path (CFG folded into one doubled batch)."""
    return expected_serve_launches(m, s, ROLL_CHUNK, t2i)


def program_memory_and_time(built) -> dict:
    """A rolling program's build s, its memory (what the capture keeps
    reserved: the graph's pool and the static state; and the peak
    allocated while it builds and replays) and the ms of a chunk replay
    (CUDA events around 5 replays)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base, reserved = torch.cuda.memory_allocated(), \
        torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    program = CapturedChunk(built)
    torch.cuda.synchronize()
    held = torch.cuda.memory_reserved() - reserved
    ms = time_ms(lambda: program.step_chunk(), iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() - base
    return {"build_s": program.build_s, "reserved_bytes": held,
            "peak_bytes": peak, "ms_per_chunk": ms,
            "launches_per_chunk": dict(program.launches)}


def phase_rolling_determinism(engine, seed) -> dict:
    """At full width through a RollingT2IBatcher: 4 requests, then 8 more
    once the first chunk has run (4 wait for slots); each request's tokens
    equal its solo run through the same program. The launches of the run
    are replays x the chunk's launches from the code. Then the t2i and
    generic rolling programs' build s, memory and chunk ms."""
    m, s = engine.m, engine.config.sampling
    batcher = RollingT2IBatcher(engine.model, engine.config,
                                slots=ROLL_SLOTS, chunk=ROLL_CHUNK,
                                dispatch_lock=engine._device_lock)
    program = batcher.program
    rng = np.random.RandomState(seed)
    txt = rng.randint(1, m.mask_index, (12, m.txt_length))
    seeds = [int(x) for x in rng.randint(0, 2 ** 31 - 1, 12)]
    try:
        _build.reset_launch_counts()
        replays0 = program.replays
        futs = [batcher.submit(txt[i], seed=seeds[i]) for i in range(4)]
        t0 = time.perf_counter()
        while program.replays == replays0:
            if time.perf_counter() - t0 > 60:
                raise AssertionError("the rolling batcher ran no chunk")
            time.sleep(0.001)
        futs += [batcher.submit(txt[i], seed=seeds[i]) for i in range(4, 12)]
        rows = [f.result(timeout=120) for f in futs]
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        replays = program.replays - replays0
    finally:
        batcher.shutdown()
    per_chunk = chunk_launches(m, s)
    want = {k: replays * n for k, n in per_chunk.items()}
    if dict(program.launches) != per_chunk or launches != want:
        raise AssertionError(f"rolling determinism: {replays} replays "
                             f"launched {launches}; a chunk launches "
                             f"{dict(program.launches)}, expected {per_chunk}")
    built, st = batcher.built, program.state
    for i in range(12):
        built.reset(st)
        built.insert_many(st, [0], txt[i:i + 1], [seeds[i]])
        while not all_done(st, built.extra):
            program.step_chunk()
        if not np.array_equal(st.x[0].cpu().numpy(), rows[i]):
            raise AssertionError(f"rolling determinism: request {i}'s "
                                 f"tokens differ from its solo run")
        if (rows[i][m.txt_length:] == m.mask_index).any():
            raise AssertionError("a mask was left in a rolling t2i row")
    rec = {"requests": 12, "slots": ROLL_SLOTS, "replays": replays,
           "launches": launches, "expected_launches": want,
           "solo_equal": True}
    del batcher, program, built, st
    gc.collect()
    torch.cuda.empty_cache()
    rec["t2i_program"] = program_memory_and_time(build_rolling(
        "t2i", engine.model, engine.config, ROLL_SLOTS, ROLL_CHUNK, False))
    gc.collect()
    torch.cuda.empty_cache()
    rec["generic_program"] = program_memory_and_time(build_rolling(
        "generic", engine.model, engine.config, ROLL_SLOTS, ROLL_CHUNK,
        False))
    gc.collect()
    torch.cuda.empty_cache()
    print("rolling_determinism " + json.dumps(rec))
    return rec


def http(url, path, req=None, timeout=120):
    """(status, content type, body bytes) of a GET, or of a POST of `req`
    as JSON."""
    data = None if req is None else json.dumps(req).encode()
    r = urllib.request.urlopen(urllib.request.Request(
        f"{url}{path}", data=data,
        headers={"Content-Type": "application/json"}), timeout=timeout)
    return r.status, r.headers.get("Content-Type"), r.read()


def chat(url, req):
    status, ctype, body = http(url, "/v1/chat/completions", req)
    if status != 200 or ctype != "application/json":
        raise AssertionError(f"POST answered {status} {ctype}")
    return json.loads(body)


def concurrent_chats(url, reqs) -> list:
    with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
        return [f.result(timeout=180) for f in
                [ex.submit(chat, url, r) for r in reqs]]


def png_of(item) -> np.ndarray:
    return decode_png(base64.b64decode(
        item["image_url"]["url"].split(",", 1)[1]))


def t2i_chat(text, seed):
    return {"messages": [{"role": "user", "content": text}], "seed": seed}


def phase_server(engine, label, full=True) -> dict:
    """make_server(engine, port=0) in a thread: 8 concurrent t2i requests
    warm the program, 8 more are counted (one batch, or one rolling
    group, launches exact) and return 256-px PNGs; with `full`, a caption
    of one PNG as a data URL, an infill with an is_mask attachment, a
    cached repeat, a streamed request, /health and /metrics."""
    m, s = engine.m, engine.config.sampling
    srv = make_server(engine, port=0, max_wait_ms=200)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    size = math.isqrt(m.img_length) * engine.codec.downsample
    rolling = bool(engine._rolling_slots)
    rec = {"rolling": rolling}
    try:
        t0 = time.perf_counter()
        concurrent_chats(url, [t2i_chat(f"a warm-up lighthouse {i}", i)
                               for i in range(REQUESTS)])
        rec["warm_s"] = time.perf_counter() - t0
        batches0 = srv.batcher.batches_run
        program = engine._rolling["t2i"].program if rolling else None
        replays0 = program.replays if rolling else 0
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = concurrent_chats(url, [
            t2i_chat(f"a watercolor painting of a lighthouse, variant {i}",
                     100 + i) for i in range(REQUESTS)])
        rec["counted_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        nfe = {r["usage"]["nfe"] for r in out}
        if rolling:
            replays = program.replays - replays0
            want = {k: replays * n for k, n in chunk_launches(m, s).items()}
            rec["replays"] = replays
            ok = nfe == {s.steps + 1}
        else:
            want = expected_serve_launches(m, s, max(nfe), True)
            ok = len(nfe) == 1
        if launches != want or not ok:
            raise AssertionError(f"{label}: launched {launches}, expected "
                                 f"{want}; nfe {nfe}")
        if srv.batcher.batches_run - batches0 != 1:
            raise AssertionError(f"{label}: 8 concurrent requests ran in "
                                 f"{srv.batcher.batches_run - batches0} "
                                 f"batches")
        for r in out:
            content = r["choices"][0]["message"]["content"]
            if [c["type"] for c in content] != ["text", "image_url"] or \
                    png_of(content[1]).shape != (size, size, 3):
                raise AssertionError(f"{label}: a t2i answer without its "
                                     f"{size}-px PNG")
        rec.update({"launches": launches, "expected_launches": want,
                    "nfe": sorted(nfe)})
        if full:
            png_url = out[0]["choices"][0]["message"]["content"][1][
                "image_url"]["url"]
            caption = {"messages": [{"role": "user", "content": [
                {"type": "image_url", "image_url": {"url": png_url}}]}],
                "seed": 5}
            got = chat(url, caption)
            if [c["type"] for c in got["choices"][0]["message"][
                    "content"]] != ["text"]:
                raise AssertionError(f"{label}: caption answer {got}")
            mask = np.zeros((size, size, 3), np.uint8)
            mask[:size // 2, :size // 2] = 255
            mask_url = "data:image/png;base64," + base64.b64encode(
                encode_png(mask)).decode()
            infill = {"messages": [{"role": "user", "content": [
                {"type": "text", "text": "a <mask:4> lighthouse"},
                {"type": "image_url", "image_url": {"url": png_url}},
                {"type": "image_url", "image_url": {"url": mask_url},
                 "is_mask": True}]}], "seed": 6}
            got = chat(url, infill)
            types = [c["type"] for c in got["choices"][0]["message"]
                     ["content"]]
            if types != ["text", "image_url"]:
                raise AssertionError(f"{label}: infill answer {types}")
            if chat(url, caption) != chat(url, caption):
                raise AssertionError(f"{label}: a cached answer changed")
            status, ctype, body = http(url, "/v1/chat/completions",
                                       {**caption, "stream": True})
            events = [e[len("data: "):] for e in body.decode().split("\n\n")
                      if e]
            deltas = [json.loads(e)["choices"][0]["delta"]
                      for e in events[:-1]]
            if ctype != "text/event-stream" or events[-1] != "[DONE]" or \
                    deltas[0] != {"role": "assistant"} or deltas[-1] != {}:
                raise AssertionError(f"{label}: stream {events}")
            if json.loads(http(url, "/health")[2]) != {"status": "ok"}:
                raise AssertionError(f"{label}: /health")
            metrics = http(url, "/metrics")[2].decode()
            if "unidisc_cache_hits_total" not in metrics or \
                    'route="diffusion"' not in metrics:
                raise AssertionError(f"{label}: /metrics {metrics}")
            rec["caption"] = got["choices"][0]["message"]["content"][0][
                "text"]
            rec["checked"] = ["caption", "infill_mask", "cache", "stream",
                              "health", "metrics"]
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.shutdown()
        for b in engine._rolling.values():
            b.shutdown()
    print(f"{label} " + json.dumps(rec))
    return rec


def phase_scaffold(engine, seed) -> dict:
    """The flagship trunk with a SCAFFOLD_BLOCKS-block trunk of the same
    width and io (random weights from the seed): its captured program gives
    its eager tokens under injected noise, and the flash_fwd launches of a
    captured call are split x 12 + the rest x SCAFFOLD_BLOCKS."""
    cfg = engine.config.override(**{"sampling.steps": SCAFFOLD_STEPS})
    small = DIT(cfg.override(**{"model.n_blocks": SCAFFOLD_BLOCKS})
                .model, torch.bfloat16, device="cuda", init=False).eval()
    randomize_(small, seed + 1)
    sample = build_scaffold_sampler(engine.model, small, cfg,
                                    split=SCAFFOLD_SPLIT, inject_noise=True)
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    args, injected = sampler_inputs("generic", cfg.model, SCAFFOLD_BATCH,
                                    SCAFFOLD_STEPS, gen)
    want = sample(*args, injected=injected)
    program = captured(sample, SCAFFOLD_BATCH)
    _build.reset_launch_counts()
    got = program(*args, injected=injected)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    n_big = sum(sample.big[:SCAFFOLD_STEPS]) + \
        (got.nfe - SCAFFOLD_STEPS) * sample.big[SCAFFOLD_STEPS]
    flash = n_big * engine.m.n_blocks + (got.nfe - n_big) * SCAFFOLD_BLOCKS
    rec = {"steps": SCAFFOLD_STEPS, "split": SCAFFOLD_SPLIT,
           "batch": SCAFFOLD_BATCH, "small_blocks": SCAFFOLD_BLOCKS,
           "big_steps": sample.big, "nfe": got.nfe, "launches": launches,
           "expected_flash_fwd": flash,
           "token_agreement": (got.tokens == want.tokens).float().mean()
           .item(), "graph_build_s": program.build_s}
    print("scaffold " + json.dumps(rec))
    if not torch.equal(got.tokens, want.tokens) or got.nfe != want.nfe \
            or launches != {"flash_fwd": flash} \
            or sample.big[:SCAFFOLD_SPLIT] != [True] * SCAFFOLD_SPLIT:
        raise AssertionError(f"scaffold: {rec}")
    del sample, program, small, injected
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def latencies(submit_all) -> dict:
    """Per-request latency (submit to result) of TIMED_REQUESTS requests
    arriving every SPACING_S, p50 and p95, and image tok/s over the wall
    time from the first arrival to the last answer. submit_all(i) returns
    a Future of request i's result."""
    done = [None] * TIMED_REQUESTS
    sent = [None] * TIMED_REQUESTS
    futs = []
    t0 = time.perf_counter()
    for i in range(TIMED_REQUESTS):
        delay = t0 + i * SPACING_S - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        sent[i] = time.perf_counter()
        fut = submit_all(i)
        fut.add_done_callback(
            lambda f, i=i: done.__setitem__(i, time.perf_counter()))
        futs.append(fut)
    for f in futs:
        f.result(timeout=180)
    torch.cuda.synchronize()
    lat = sorted(d - s for d, s in zip(done, sent))
    wall = max(done) - t0
    return {"p50_s": statistics.median(lat),
            "p95_s": lat[math.ceil(0.95 * len(lat)) - 1],
            "max_s": lat[-1], "wall_s": wall,
            "image_tok_per_s": TIMED_REQUESTS * 256 / wall}


def phase_serving_timing(engine) -> dict:
    """Whole-batch (RequestBatcher, max batch 16, 25 ms window, every pad
    size captured first) against rolling (8 slots, each request its own
    thread into the rolling batcher) on the same model without a codec:
    TIMED_REQUESTS t2i requests SPACING_S apart."""
    prompts = [f"a lighthouse at dusk, variant {i}"
               for i in range(TIMED_REQUESTS)]
    prepared = [engine.prepare(text=p) for p in prompts]
    for b in PAD_SIZES:
        engine.run_batch(prepared[:b], pad_to=b, seed=1)
    batcher = RequestBatcher(engine, max_batch=16, max_wait_ms=25.0)
    try:
        whole = latencies(lambda i: batcher.submit(text=prompts[i],
                                                   seed=i))
        whole["batches"] = batcher.batches_run
    finally:
        batcher.shutdown()
    rolling = InferenceEngine(engine.config, engine.model,
                              rolling=ROLL_SLOTS)
    pool = concurrent.futures.ThreadPoolExecutor(TIMED_REQUESTS)
    try:
        t0 = time.perf_counter()
        rolling.run_batch(prepared[:1], seed=0)        # builds the program
        build_s = time.perf_counter() - t0
        roll = latencies(lambda i: pool.submit(
            rolling.run_batch, [prepared[i]], seed=i))
        roll["replays"] = rolling._rolling["t2i"].program.replays
        roll["first_request_s_with_build"] = build_s
    finally:
        pool.shutdown(wait=True)
        for b in rolling._rolling.values():
            b.shutdown()
    rec = {"requests": TIMED_REQUESTS, "spacing_s": SPACING_S,
           "whole_batch": whole, "rolling": roll}
    print("serving_timing " + json.dumps(rec))
    return rec


def phase_front_door(seed, qstate) -> dict:
    """Phase 4f, on phase 4's random weights and 4b's int8 weights."""
    t0 = time.perf_counter()
    rec = {}
    rec["rolling_graph_vs_eager"] = {
        "tiny": phase_rolling_graph_vs_eager(
            tiny_models(seed)[False], "tiny", GRAPH_STEPS, seed,
            lockstep=True)}
    rec["rolling_cpu_vs_cuda"] = phase_rolling_cpu_vs_card(seed)
    engine = build_engine(preset="small", overrides=FLAGSHIP_OVERRIDES,
                          codec_name=CODEC)
    randomize_(engine.model, seed)              # phase 4's weights
    rec["rolling_graph_vs_eager"]["flagship"] = phase_rolling_graph_vs_eager(
        (engine.config, engine.model), "flagship", GRAPH_STEPS, seed)
    rec["rolling_determinism"] = phase_rolling_determinism(engine, seed)
    rec["scaffold"] = phase_scaffold(engine, seed)
    rec["front_door_bf16"] = phase_server(engine, "front_door_bf16")
    free(engine)
    rec["front_door_bf16_rolling"] = phase_server(InferenceEngine(
        engine.config, engine.model, codec=engine.codec, rolling=ROLL_SLOTS),
        "front_door_bf16_rolling")
    codec = engine.codec
    plain = InferenceEngine(engine.config, engine.model)
    rec["serving_timing"] = phase_serving_timing(plain)
    free(plain, engine)
    del engine, plain
    gc.collect()
    torch.cuda.empty_cache()
    qengine = build_engine(preset="small", overrides=FLAGSHIP_INT8_OVERRIDES,
                           quantize="int8")
    qengine.model.load_state_dict(qstate)      # 4b's int8 weights
    qengine.codec = codec
    rec["front_door_int8"] = phase_server(qengine, "front_door_int8",
                                          full=False)
    free(qengine)
    rec["front_door_int8_rolling"] = phase_server(InferenceEngine(
        qengine.config, qengine.model, codec=codec, rolling=ROLL_SLOTS),
        "front_door_int8_rolling", full=False)
    free(qengine)
    del qengine, codec
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    timing = rec["serving_timing"]
    det = rec["rolling_determinism"]
    print("front_door " + json.dumps({
        "card": card_line(), "seconds": rec["seconds"],
        "whole_batch": {k: timing["whole_batch"][k] for k in
                        ("p50_s", "p95_s", "image_tok_per_s", "batches")},
        "rolling": {k: timing["rolling"][k] for k in
                    ("p50_s", "p95_s", "image_tok_per_s", "replays")},
        "rolling_program": {kind: {k: det[f"{kind}_program"][k] for k in
                                   ("build_s", "reserved_bytes",
                                    "peak_bytes", "ms_per_chunk")}
                            for kind in ("t2i", "generic")}}))
    return rec


# ---------------------------------------------------------------------------
# 4g: AR serving
# ---------------------------------------------------------------------------

AR_SLOTS, AR_CHUNK = 8, 8       # the engines' continuous batchers
AR_REQUESTS, AR_SPACING_S = 16, 0.05
AR_SHARED = 256                 # the prefix four of the requests share
AR_TEMPERATURE = 0.8            # the seeded half of the requests
SPEC_REQUESTS = 1   # greedy requests an engine (the script's time limit)
# new tokens a request of the fp64 lossless check decodes (cut from the
# requests' 64-256 for the script's limit: every speculative round's
# acceptance is still held to plain decoding, over fewer rounds)
SPEC_LOSSLESS_TOKENS = 24
AR_SAMPLER_CHUNK = 16           # decode steps a replay of the AR sampler
AR_SAMPLER_PROMPT = 32          # prompt tokens of its 8 text rows
AR_OVERRIDES = {"trainer.parameterization": "ar", "trainer.ar_shift": True,
                "model.full_attention": False}
# the DIT-AR served in phase 4g: the flagship's width, 2 of its 12 blocks
AR_DIT_DEPTH = {"model.n_blocks": 2}
# the counted runs of phase 4g
AR_PATHS = ("ar_elm_bf16", "ar_elm_int8", "ar_http", "ar_spec_draft",
            "ar_spec_lookup", "ar_dit_sampler_bf16", "ar_dit_bf16",
            "ar_dit_sampler_int8", "ar_dit_int8")


def ar_requests(length: int, seed: int) -> list:
    """AR_REQUESTS completions: prompts of 16-512 tokens (with the BOS)
    and 64-256 new tokens, cut to fit a model of `length` positions
    (prompts to half of it, a shared prefix to a third, and the new
    tokens below the speculative rounds' stop cap, length - 8 at gamma
    up to 7); even requests
    greedy, odd ones seeded at AR_TEMPERATURE; requests 3, 7, 11 and 15
    share a prefix of AR_SHARED tokens."""
    rng = np.random.RandomState(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)

    def text(n):
        return bytes(rng.choice(letters, n)).decode()

    shared = text(min(AR_SHARED, length // 3) - 1)
    plens = [16, 512, 64, 0, 128, 256, 32, 0, 384, 48, 200, 0, 96, 320, 24,
             0]
    news = [64, 256, 128, 96, 192, 64, 256, 128, 96, 160, 64, 224, 128, 80,
            256, 112]
    reqs = []
    for i in range(AR_REQUESTS):
        body = shared + text(16 + 8 * i) if i % 4 == 3 \
            else text(min(plens[i], length // 2) - 1)
        reqs.append({"text": body,
                     "max_new_tokens": min(news[i], length - len(body) - 9),
                     "temperature": AR_TEMPERATURE if i % 2 else 0.0,
                     "seed": 1000 + i if i % 2 else None})
    return reqs


def run_ar_requests(engine, reqs) -> tuple:
    """Each request through engine.complete_text, AR_SPACING_S apart, each
    streaming: time to first token (submit to the first streamed tokens),
    time per output token ((last tokens - first tokens) / (n - 1)), and
    generated tok/s over the first submit to the last answer."""
    n = len(reqs)
    sent, first, last, done = ([None] * n for _ in range(4))
    streamed = [0] * n
    futs = []
    t0 = time.perf_counter()
    for i, r in enumerate(reqs):
        delay = t0 + i * AR_SPACING_S - time.perf_counter()
        if delay > 0:
            time.sleep(delay)

        def on_tokens(ids, i=i):
            now = time.perf_counter()
            if first[i] is None:
                first[i] = now
            last[i] = now
            streamed[i] += len(ids)

        sent[i] = time.perf_counter()
        fut = engine.complete_text(r["text"], stream_cb=on_tokens, **{
            k: r[k] for k in ("max_new_tokens", "temperature", "seed")})
        fut.add_done_callback(
            lambda f, i=i: done.__setitem__(i, time.perf_counter()))
        futs.append(fut)
    results = [f.result(timeout=600) for f in futs]
    torch.cuda.synchronize()
    ttft = sorted(f - s for f, s in zip(first, sent))
    tpot = sorted((la - f) / (k - 1) for f, la, k in
                  zip(first, last, streamed) if k > 1)
    generated = sum(len(r["tokens"]) for r in results)
    wall = max(done) - t0

    def pct(xs, q):
        return xs[math.ceil(q * len(xs)) - 1]

    timing = {"requests": n, "spacing_s": AR_SPACING_S,
              "ttft_p50_s": statistics.median(ttft),
              "ttft_p95_s": pct(ttft, 0.95),
              "tpot_p50_ms": 1e3 * statistics.median(tpot),
              "tpot_p95_ms": 1e3 * pct(tpot, 0.95),
              "generated_tokens": generated, "wall_s": wall,
              "tok_per_s": generated / wall}
    return timing, results


def int8_products_per_forward(model) -> int:
    """The int8 products (each one dynamic_quantize and one int8_matmul
    launch) of one forward, from the module: its QLinear layers and, in an
    int8 OpenELM, the head."""
    from unidisc_tpu_torch.models.dit import QLinear
    from unidisc_tpu_torch.models.elm import OpenELM
    n = sum(isinstance(mod, QLinear) for mod in model.modules())
    return n + int(isinstance(model, OpenELM) and model.cfg.quant == "int8")


def clone_state(state):
    def c(x):
        if isinstance(x, (list, tuple)):
            return type(x)(c(v) for v in x)
        return x.clone()
    return type(state)(*(c(f) for f in state))


def state_tensors(state) -> list:
    out = []
    for name, field in zip(state._fields, state):
        stack = [field]
        while stack:
            x = stack.pop()
            if isinstance(x, (list, tuple)):
                stack.extend(x)
            else:
                out.append((name, x))
    return out


def replay_profile(replay, n: int = 2, top: int = 10) -> dict:
    """Device time of one `replay()` by kernel name, from torch.profiler
    over n replays: the total, the kernels a replay, and the `top`
    largest names with their ms and launches a replay."""
    replay()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            replay()
        torch.cuda.synchronize()
    ms, count = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms[e.name] += e.time_range.elapsed_us() / 1e3 / n
            count[e.name] += 1 / n
    return {"device_ms": sum(ms.values()), "kernels": sum(count.values()),
            "top": [[name[:90], t, count[name]]
                    for name, t in ms.most_common(top)]}


def phase_decode_program(engine, label, seed) -> dict:
    """A second capture of the engine's decode chunk (the batcher keeps
    its own): its build s, what it holds (reserved) and the peak while it
    builds and replays, the ms of a replay (CUDA events over 5), and every
    field of its state equal to the eager chunk's after each of 3 chunks,
    with 3 requests of real lengths (greedy and seeded) admitted into both
    before the first and a fourth before the third."""
    decoder = engine.continuous.decoder
    rng = np.random.RandomState(seed)
    L, S = decoder.L, decoder.slots
    with engine._device_lock:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base, reserved = torch.cuda.memory_allocated(), \
            torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        program = CapturedChunk(decoder)
        torch.cuda.synchronize()
        build_s = program.build_s
        held = torch.cuda.memory_reserved() - reserved
        eager = clone_state(program.state)
        bucket = min(512, L // 2)
        for c in range(3):
            if c in (0, 2):
                slots = [0, 1, 2] if c == 0 else [S - 1]
                n = len(slots)
                args = (slots, rng.randint(4, 200, (n, bucket)),
                        np.zeros((n, L), np.int64),
                        rng.randint(bucket // 4, bucket, n),
                        rng.randint(40, 120, n),
                        np.asarray([0.0, AR_TEMPERATURE, 0.0][:n],
                                   np.float32), rng.randint(0, 999, n))
                for st in (eager, program.state):
                    decoder.insert_many(st, *args)
            decoder.step_chunk(eager)
            program.step_chunk()
            torch.cuda.synchronize()
            for (name, x), (_, y) in zip(state_tensors(eager),
                                         state_tensors(program.state)):
                if not torch.equal(x, y):
                    raise AssertionError(f"{label}: the captured decode "
                                         f"chunk differs from the eager "
                                         f"chunk in {name} after chunk {c}")
        ms = time_ms(lambda: program.step_chunk(), iters=5, warmup=1)
        peak = torch.cuda.max_memory_allocated() - base
        launches = dict(program.launches)
        profile = replay_profile(program.step_chunk)
        del program, eager
        gc.collect()
        torch.cuda.empty_cache()
    return {"build_s": build_s, "reserved_bytes": held,
            "peak_bytes": peak, "ms_per_replay": ms,
            "chunk_steps": decoder.chunk,
            "rounds_per_replay": decoder.rounds if decoder.speculative
            else None, "launches_per_replay": launches,
            "captured_equals_eager_chunks": 3, "profile": profile}


def decode_bytes(model, cache) -> dict:
    """The bytes a decode step must read: every projection of the module
    (its stored weights, scales and biases; fp32 for the DIT, whose dense
    casts at each call) and the head (an OpenELM's fp32 tables, or its
    int8 copy and scales); and the whole K/V `cache` of the batcher's
    slots, which the plain attention reads every step."""
    from unidisc_tpu_torch.models.dit import QLinear
    from unidisc_tpu_torch.models.elm import OpenELM
    from unidisc_tpu_torch.serving.continuous import _leaves
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    weights = nbytes(t for mod in model.modules()
                     if isinstance(mod, (torch.nn.Linear, QLinear))
                     for t in itertools.chain(mod.parameters(),
                                              mod.buffers()))
    if isinstance(model, OpenELM):
        weights += nbytes([model.lm_head_q, model.lm_head_scale]) \
            if model.cfg.quant == "int8" else nbytes(
                [model.token_embeddings, model.token_embeddings_extra])
    kv = nbytes(_leaves(cache))
    return {"weight_bytes": weights, "kv_cache_bytes": kv,
            "weight_bound_ms": weights / HBM_BYTES_PER_S * 1e3,
            "step_bound_ms": (weights + kv) / HBM_BYTES_PER_S * 1e3}


def phase_ar_path(engine, reqs, label, seed) -> dict:
    """AR_REQUESTS requests through engine.complete_text (the continuous
    batcher: the captured decode chunk, eager admissions), 50 ms apart,
    each streaming; the counted run's launches equal the code's (int8
    products a forward x the batcher's prefill forwards and chunk x its
    chunks); every answer's ids in the vocabulary; the prefix cache hit.
    That a request gives the same tokens alone, under load and from the
    prefix cache is held in fp64 (phase_ar_exactness) and on the tiny fp32
    models (phase_ar_cpu_vs_card): in bf16 a prefill of other rows or
    another bucket sums in another order, and a near tie can flip."""
    batcher = engine.continuous        # built and captured here
    t0 = time.perf_counter()
    engine.complete_text("warm up the prefill", max_new_tokens=4).result(
        timeout=600)
    warm_s = time.perf_counter() - t0
    rec = {"program": phase_decode_program(engine, label, seed),
           "warm_request_s": warm_s,
           "batcher_build_s": batcher.program.build_s}
    c0, p0, h0, r0 = (batcher.chunks, batcher.prefills,
                      batcher.prefix_hits, batcher.host_reads)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    timing, results = run_ar_requests(engine, reqs)
    launches = dict(_build.launch_counts)
    chunks, prefills = batcher.chunks - c0, batcher.prefills - p0
    per_fwd = int8_products_per_forward(engine.model)
    forwards = prefills + batcher.decoder.chunk * chunks
    want = {"int8_matmul": per_fwd * forwards,
            "dynamic_quantize": per_fwd * forwards} if per_fwd else {}
    if launches != want:
        raise AssertionError(f"{label}: the main path launched {launches}; "
                             f"expected {want} ({per_fwd} int8 products a "
                             f"forward, {prefills} prefills, {chunks} "
                             f"chunks of {batcher.decoder.chunk})")
    for r, res in zip(reqs, results):
        toks = res["tokens"]
        if len(toks) > r["max_new_tokens"] or any(
                not 0 <= t < engine.vocab_size for t in toks) or \
                not isinstance(res["text"], str):
            raise AssertionError(f"{label}: an answer out of bounds: {res}")
    hits = batcher.prefix_hits - h0
    if hits < 1:
        raise AssertionError(f"{label}: the shared prefix never hit")
    rec.update({"timing": timing, "launches": launches,
                "expected_launches": want, "chunks": chunks,
                "prefill_forwards": prefills, "prefix_hits": hits,
                "host_reads": batcher.host_reads - r0,
                "int8_products_per_forward": per_fwd,
                "distinct_outputs": len({tuple(r["tokens"])
                                         for r in results}),
                "decode_step": decode_bytes(engine.model,
                                            batcher.state.kv)})
    print(f"{label} " + json.dumps(rec))
    return rec


def batcher_exactness(make, reqs, label) -> dict:
    """reqs: (prompt ids, max new, temperature, seed). Each request alone
    (a fresh batcher without the prefix cache, one request at a time)
    gives the tokens it gives when all are submitted at once, and again
    when they come one after another through a batcher with the prefix
    cache, which must hit. make(prefix_min) builds a batcher."""
    def run(prefix_min, together):
        b = make(prefix_min)
        try:
            if together:
                futs = [b.submit(p, max_new_tokens=n, temperature=t, seed=s)
                        for p, n, t, s in reqs]
                return [f.result(timeout=600)["tokens"] for f in futs], 0
            out = [b.submit(p, max_new_tokens=n, temperature=t, seed=s)
                   .result(timeout=600)["tokens"] for p, n, t, s in reqs]
            return out, b.prefix_hits
        finally:
            b.shutdown()

    alone, _ = run(0, False)
    loaded, _ = run(0, True)
    cached, hits = run(16, False)
    rec = {"requests": len(reqs), "same_under_load": loaded == alone,
           "same_from_prefix_cache": cached == alone, "prefix_hits": hits,
           "tokens": sum(len(t) for t in alone)}
    if not (rec["same_under_load"] and rec["same_from_prefix_cache"]
            and hits >= 1):
        raise AssertionError(f"{label}: {rec}")
    return rec


def phase_ar_exactness(engine, reqs) -> dict:
    """The exactness of the continuous batcher at full width, on an fp64
    copy of the engine's OpenELM (its K/V cache bf16, as served): 8 of the
    requests (greedy and seeded, four sharing the 256-token prefix, 48 new
    tokens each) give the same tokens alone, under load and from the
    prefix cache. In fp64 the summation orders of prefills of other rows
    and buckets differ by ~1e-15 of a logit, below every gap."""
    from unidisc_tpu_torch.serving.continuous import elm_continuous_batcher
    model = fp64_copy(engine.model)
    tok = engine.tokenizer
    picked = [0, 1, 3, 5, 7, 9, 11, 15]
    gate = [(tok.encode(reqs[i]["text"], add_bos=True,
                        add_eos=False)[:engine.m.length - 2],
             min(48, reqs[i]["max_new_tokens"]), reqs[i]["temperature"],
             reqs[i]["seed"] if reqs[i]["seed"] is not None else 7 + i)
            for i in picked]
    rec = batcher_exactness(
        lambda pm: elm_continuous_batcher(
            model, slots=AR_SLOTS, chunk=AR_CHUNK,
            eos_id=tok.eos_token_id, prefix_min=pm,
            device_lock=engine._device_lock), gate, "ar_exactness_fp64")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print("ar_exactness_fp64 " + json.dumps(rec))
    return rec


def shutdown_ar(*engines) -> None:
    for engine in engines:
        if engine._continuous is not None:
            engine._continuous.shutdown()
            engine._continuous = None
    gc.collect()
    torch.cuda.empty_cache()


def phase_ar_sampler(engine, label, seed) -> dict:
    """build_ar_sampler over the engine's DIT at batch 8 with the config's
    CFG (16 rows), as its captured program (graph.py::captured_ar): 8
    text prompts of AR_SAMPLER_PROMPT tokens, the rest of the sequence
    generated (text span, then image span). The counted call's launches
    equal the code's (int8 products a forward x the steps replayed); its
    tokens equal the eager loop's at the same seed, keep the prompt and
    the modality of each position; a steady call is timed."""
    from unidisc_tpu_torch.sampling.ar_sampler import (build_ar_sampler,
                                                       make_apply_token)
    from unidisc_tpu_torch.sampling.graph import captured_ar
    cfg, m = engine.config, engine.m
    sampler = build_ar_sampler(make_apply_token(engine.model), cfg,
                               chunk=AR_SAMPLER_CHUNK, device=engine.device)
    rng = np.random.RandomState(seed)
    x0 = np.zeros((REQUESTS, m.length), np.int64)
    x0[:, :AR_SAMPLER_PROMPT] = rng.randint(
        4, min(260, m.text_vocab_size), (REQUESTS, AR_SAMPLER_PROMPT))
    unmask = np.zeros_like(x0, dtype=bool)
    unmask[:, :AR_SAMPLER_PROMPT] = True
    modality = np.concatenate([np.zeros((REQUESTS, m.txt_length)),
                               np.ones((REQUESTS, m.img_length))], 1)
    with engine._device_lock:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        program = captured_ar(sampler, REQUESTS)
        torch.cuda.synchronize()
        build_s = program.build_s
        held = torch.cuda.memory_reserved() - reserved
        _build.reset_launch_counts()
        out = program(x0, unmask, modality, seed=1)
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        per_fwd = int8_products_per_forward(engine.model)
        steps = sampler.chunk * sampler.n_chunks
        want = {"int8_matmul": per_fwd * steps,
                "dynamic_quantize": per_fwd * steps} if per_fwd else {}
        if launches != want:
            raise AssertionError(f"{label}: launched {launches}, expected "
                                 f"{want}")
        tokens = out.tokens.cpu().numpy()
        eager = sampler(x0, unmask, modality, seed=1).tokens.cpu().numpy()
        if not np.array_equal(tokens, eager):
            raise AssertionError(f"{label}: the captured AR sampler "
                                 f"differs from its eager loop")
        if not (np.array_equal(tokens[unmask], x0[unmask])
                and (tokens[:, :m.txt_length] < m.text_vocab_size).all()
                and (tokens[:, m.txt_length:] >= m.text_vocab_size).all()
                and (tokens < m.vocab_size).all()):
            raise AssertionError(f"{label}: tokens off their modality")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program(x0, unmask, modality, seed=2)
        torch.cuda.synchronize()
        times = [time.perf_counter() - t0]
        peak = torch.cuda.max_memory_allocated() - base
        ms = time_ms(lambda: program.graph.replay(), iters=5, warmup=1)
        _build.launch_counts.clear()
        sampler.graphs.clear()
        del program
    generated = int((~unmask).sum())
    batch_s = min(times)
    rec = {"batch": REQUESTS, "rows": 2 * REQUESTS if sampler.use_cfg
           else REQUESTS, "length": m.length, "steps": m.length - 1,
           "build_s": build_s, "launches": launches,
           "expected_launches": want, "int8_products_per_forward": per_fwd,
           "steady_batch_s": times, "generated_tokens": generated,
           "tok_per_s": generated / batch_s,
           # whole-batch: every token comes back at the end of the batch
           "ttft_s": batch_s,
           "tpot_ms": 1e3 * batch_s / (m.length - 1),
           "reserved_bytes": held, "peak_bytes": peak,
           "ms_per_replay": ms, "steps_per_replay": sampler.chunk,
           "distinct_outputs": len({r.tobytes() for r in tokens})}
    print(f"{label} " + json.dumps(rec))
    return rec


class IdTokenizer:
    """The byte tokenizer's encoding, with a decoding that writes every id
    as <id>: the answers of random weights are mostly ids past the 256
    bytes, which the byte tokenizer's decoding drops, and would stream no
    text."""

    def __init__(self):
        from unidisc_tpu_torch.tokenizers.text import get_tokenizer
        self.base = get_tokenizer("byte")
        self.eos_token_id = self.base.eos_token_id

    def encode(self, text, **kw):
        return self.base.encode(text, **kw)

    def decode(self, ids):
        return "".join(f"<{i}>" for i in ids)


def phase_ar_http(engine) -> dict:
    """make_server over an ElmEngine of the engine's model that writes
    every id (IdTokenizer): 8 concurrent chat completions, half streamed;
    each streamed answer's deltas concatenate to the text of the same
    request answered whole; /metrics shows the continuous batcher's
    gauges."""
    from unidisc_tpu_torch.serving.engine import ElmEngine
    engine = ElmEngine(engine.elm_cfg, engine.model, tokenizer=IdTokenizer(),
                       device=engine.device)
    srv = make_server(engine, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    reqs = [{"messages": [{"role": "user",
                           "content": f"tell me about lighthouses, {i}"}],
             "max_tokens": 32 + 8 * i, "stream": i % 2 == 0}
            for i in range(REQUESTS)]

    def ask(req):
        status, ctype, body = http(url, "/v1/chat/completions", req,
                                   timeout=300)
        if not req["stream"]:
            answer = json.loads(body)
            if not answer["usage"]["completion_tokens"] > 0:
                raise AssertionError(f"ar_http: an empty answer {answer}")
            return answer["choices"][0]["message"]["content"]
        if ctype != "text/event-stream":
            raise AssertionError(f"ar_http: stream answered {ctype}")
        events = [e[len("data: "):] for e in body.decode().split("\n\n")
                  if e]
        if events[-1] != "[DONE]":
            raise AssertionError("ar_http: a stream without [DONE]")
        text = ""
        for e in events[1:-2]:
            delta = json.loads(e)["choices"][0]["delta"]
            text = delta["content"] if delta.get("replace") \
                else text + delta["content"]
        return text

    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
            texts = list(ex.map(ask, reqs))
        wall = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
        if not all(texts):
            raise AssertionError("ar_http: an answer without text")
        for req, text in zip(reqs, texts):
            if req["stream"]:
                whole = ask({**req, "stream": False})
                if whole != text:
                    raise AssertionError("ar_http: the streamed deltas do "
                                         "not concatenate to the answer")
        metrics = http(url, "/metrics")[2].decode().splitlines()
        if f"unidisc_slots {AR_SLOTS}" not in metrics or not any(
                ln.startswith("unidisc_active_slots ") for ln in metrics):
            raise AssertionError(f"ar_http: /metrics {metrics}")
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.shutdown()
        shutdown_ar(engine)
    rec = {"requests": len(reqs), "streamed": sum(r["stream"] for r in reqs),
           "wall_s": wall, "launches": launches,
           "chars": [len(t) for t in texts]}
    print("ar_http " + json.dumps(rec))
    return rec


def fp64_copy(model):
    """An OpenELM's weights in an fp64-computing copy on the card."""
    from unidisc_tpu_torch.models.elm import OpenELM
    copy_ = OpenELM(model.cfg, compute_dtype=torch.float64, init_seed=None)
    copy_.load_state_dict(model.state_dict())
    return copy_.to("cuda").eval()


def speculative_lossless(engine, reqs, label) -> dict:
    """Greedy speculative (or lookup) rounds against plain decoding on
    fp64 copies of the engine's target and draft, token for token. The
    rule is lossless in exact arithmetic. A verify forward's gamma + 1
    rows a slot and a plain step's one are products of other shapes, which
    cuBLAS sums in other orders: in bf16, and measured in fp32 too (the
    first full-width runs), a near tie between the two best logits of
    these random 20-layer models flips, and the sequences part there. In
    fp64 the orders differ by ~1e-15 of a logit, below every gap."""
    from unidisc_tpu_torch.serving.continuous import elm_continuous_batcher
    target = fp64_copy(engine.model)
    kw = dict(draft=fp64_copy(engine._draft), gamma=engine._gamma) \
        if engine._draft is not None else \
        dict(lookup_ngram=engine._lookup_ngram, gamma=engine._gamma)
    ids = [engine.tokenizer.encode(r["text"], add_bos=True,
                                   add_eos=False)[:engine.m.length - 2]
           for r in reqs]
    toks = {}
    for name, extra in (("speculative", kw), ("plain", {})):
        b = elm_continuous_batcher(
            target, slots=AR_SLOTS, chunk=AR_CHUNK,
            eos_id=engine.tokenizer.eos_token_id,
            device_lock=engine._device_lock, **extra)
        try:
            futs = [b.submit(p, max_new_tokens=min(r["max_new_tokens"],
                                                   SPEC_LOSSLESS_TOKENS))
                    for p, r in zip(ids, reqs)]
            toks[name] = [f.result(timeout=600)["tokens"] for f in futs]
        finally:
            b.shutdown()
    del target, kw
    gc.collect()
    torch.cuda.empty_cache()
    if toks["speculative"] != toks["plain"]:
        raise AssertionError(f"{label}: greedy speculative tokens differ "
                             f"from plain decoding in fp64")
    return {"requests": len(reqs),
            "tokens": sum(len(t) for t in toks["plain"])}


def phase_ar_speculative(seed) -> dict:
    """(c) build_engine(preset="elm:450m", speculative="270m",
    spec_gamma=4) and build_engine(preset="elm:270m",
    speculative="lookup"): SPEC_REQUESTS greedy requests each through the
    engine (speculative rounds in the captured chunk), timed, with the
    acceptance rate and the tokens a target read from the state's
    counters; their greedy tokens equal plain decoding's in fp64
    (speculative_lossless)."""
    out = {}
    for label, kw in (("ar_spec_draft", dict(preset="elm:450m",
                                             speculative="270m",
                                             spec_gamma=4)),
                      ("ar_spec_lookup", dict(preset="elm:270m",
                                              speculative="lookup",
                                              spec_gamma=4))):
        t0 = time.perf_counter()
        engine = build_engine(**kw)
        build_s = time.perf_counter() - t0
        reqs = [{**r, "temperature": 0.0, "seed": None} for r in
                ar_requests(engine.m.length, seed)[:SPEC_REQUESTS]]
        batcher = engine.continuous
        engine.complete_text("warm up", max_new_tokens=4).result(timeout=600)
        stats0 = batcher.state.stats.clone()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        timing, _ = run_ar_requests(engine, reqs)
        launches = dict(_build.launch_counts)
        stats = (batcher.state.stats - stats0).tolist()
        lossless = speculative_lossless(engine, reqs, label)
        rows, accepted, drafted, advanced = stats
        rec = {"engine": kw, "engine_build_s": build_s, "timing": timing,
               "launches": launches, "lossless_fp64": lossless,
               "row_rounds": rows,
               "accepted": accepted, "drafted": drafted,
               "acceptance_rate": accepted / max(drafted, 1),
               "tokens_per_target_read": advanced / max(rows, 1),
               "rounds_per_replay": batcher.decoder.rounds}
        print(f"{label} " + json.dumps(rec))
        out[label] = rec
        shutdown_ar(engine)
        del engine, batcher
    return out


def elm_int8_logits(model, qmodel, seed) -> dict:
    """Full-width int8 OpenELM logits through the kernels (int8_matmul,
    dynamic_quantize) against the plain int8 path, as phase 4b holds the
    int8 DIT: the kernel path (bf16) within twice the plain bf16 path's
    mean error from the plain path in fp32, and against the bf16 model
    cosine > 0.99 and top-1 agreement > 0.9 where the bf16 lead is
    clear."""
    from unidisc_tpu_torch.models.elm import OpenELM
    cfg = qmodel.cfg
    state = qmodel.state_dict()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(4, 260, (2, 256), generator=gen, device="cuda")
    out = {}
    with torch.inference_mode():
        out["kernel"] = qmodel(ids).float()
        out["bf16_model"] = model(ids).float()
        for label, dtype in (("plain_bf16", torch.bfloat16),
                             ("plain_fp32", torch.float32)):
            mdl = OpenELM(cfg, compute_dtype=dtype, quant_backend="xla",
                          init_seed=None)
            mdl.load_state_dict(state)
            out[label] = mdl.to("cuda").eval()(ids).float()
            del mdl
    torch.cuda.synchronize()
    kern, truth, ref = out["kernel"], out["plain_fp32"], out["bf16_model"]
    err_kernel = (kern - truth).abs().mean().item()
    err_plain16 = (out["plain_bf16"] - truth).abs().mean().item()
    cos = ((kern.double() * ref.double()).sum()
           / (kern.double().norm() * ref.double().norm())).item()
    agree = kern.argmax(-1) == ref.argmax(-1)
    mean_diff = (kern - ref).abs().mean().item()
    best2 = ref.topk(2, dim=-1).values
    clear = (best2[..., 0] - best2[..., 1]) > 2 * mean_diff
    top1_clear = agree[clear].float().mean().item()
    finite = bool(torch.isfinite(kern).all().item())
    rec = {"shape": list(kern.shape), "logit_scale": truth.abs().max().item(),
           "mean_abs_err_kernel_bf16_vs_plain_fp32": err_kernel,
           "mean_abs_err_plain_bf16_vs_plain_fp32": err_plain16,
           "kernel_equals_plain_bf16": bool(torch.equal(kern,
                                                        out["plain_bf16"])),
           "cosine_vs_bf16_model": cos,
           "top1_vs_bf16_model": agree.float().mean().item(),
           "top1_vs_bf16_model_clear_margin": top1_clear,
           "share_clear_margin": clear.float().mean().item(),
           "finite": finite}
    print("elm_int8_logits " + json.dumps(rec))
    if (not finite or err_kernel > 2 * err_plain16 or not cos > 0.99
            or not top1_clear > 0.9):
        raise AssertionError(f"full-width int8 ELM logits through the "
                             f"kernels are off: {rec}")
    return rec


def ar_products() -> dict:
    """(K, N) of the AR path's int8 products by (model, product):
    OpenELM-270M's every projection width and its 48,385-wide head, and
    the flagship DIT-AR's four trunk products and head."""
    from unidisc_tpu_torch.models.elm import ELM_PRESETS
    c = ELM_PRESETS["270m"]
    hd, d = c.head_dim, c.model_dim
    out = collections.defaultdict(set)
    for q, kv, f in zip(c.layer_q_heads(), c.layer_kv_heads(),
                        c.layer_ffn_dims()):
        out["elm270m", "qkv"].add((d, (q + 2 * kv) * hd))
        out["elm270m", "out"].add((q * hd, d))
        out["elm270m", "proj_1"].add((d, 2 * f))
        out["elm270m", "proj_2"].add((f, d))
    out["elm270m", "head"].add((d, c.total_vocab))
    m = Config.make("small", **FLAGSHIP_OVERRIDES).model
    h, f = m.hidden_size, m.mlp_ratio * m.hidden_size
    for name, k, n in (("attn_qkv", h, 3 * h), ("attn_out", h, h),
                       ("mlp_0", h, f), ("mlp_2", f, h),
                       ("head", h, m.vocab_size)):
        out["dit_ar", name].add((k, n))
    return {key: sorted(v) for key, v in out.items()}


def ar_gemm_cases() -> list:
    """(model, product, M, K, N, decode) of the checked int8 products:
    every width at the decode rows (8 slots; 16 rows of the AR sampler
    under CFG), at one 512-token prompt's prefill (the DIT's: 8 x 384
    rows), and each product's widest at a group prefill of 8 x 512."""
    cases = []
    for (model, prod), shapes in ar_products().items():
        rows = [(8, True), (16, True)] + ([(512, False)] if model ==
                                          "elm270m" else [(8 * 384, False)])
        cases += [(model, prod, mm, k, n, decode) for mm, decode in rows
                  for k, n in shapes]
        if model == "elm270m" and prod != "head":
            cases.append((model, prod, 8 * 512, *max(
                shapes, key=lambda kn: kn[0] * kn[1]), False))
    return cases


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device ms of one call of fn: CUDA events around replays of a
    captured graph of `calls` calls (no host time between the launches,
    and no profiler trace to lose), the launches the capture counts taken
    out again."""
    before = collections.Counter(_build.launch_counts)
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    ms = time_ms(graph.replay, iters=replays, warmup=0) / calls
    _build.launch_counts.clear()
    _build.launch_counts.update(before)
    del graph
    return ms


def phase_ar_kernels(seed) -> dict:
    """int8_matmul and dynamic_quantize at every shape of ar_gemm_cases
    against their plain versions, bit for bit (bf16 out; fp32 for the
    heads, as the models call them); at the decode rows each one's device
    ms (graph_ms) beside its bound, and at M 32 (torch._int_mm refuses M
    <= 16 on the card) the library's product with a torch epilogue beside
    the kernel at the same M."""
    from unidisc_tpu_torch.ops.quant import (dynamic_quantize,
                                             dynamic_quantize_reference)
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    widest = {key: max(v, key=lambda kn: kn[0] * kn[1])
              for key, v in ar_products().items()}
    cases = ar_gemm_cases()
    gemm, quant, library, seen_q = [], [], [], set()
    for model, prod, mm, k, n, decode in cases:
        out_dtype = torch.float32 if prod == "head" else torch.bfloat16
        x = dynamic_quantize_input(gen, mm, k)
        xq, s = dynamic_quantize(x)
        rq, rs = dynamic_quantize_reference(x)
        wq = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                           generator=gen, device="cuda")
        ws = torch.rand((n,), generator=gen, device="cuda") * 0.02
        got = int8_matmul(xq, s, wq, ws, out_dtype=out_dtype)
        want = int8_matmul_reference(xq, s, wq, ws, out_dtype=out_dtype)
        torch.cuda.synchronize()
        if not (torch.equal(xq, rq) and torch.equal(s, rs)
                and torch.equal(got, want)):
            raise AssertionError(f"{model} {prod} ({mm}, {k}, {n}): a "
                                 f"kernel differs from its plain version")
        if decode:
            bound, by, nbytes, ops = int8_gemm_bound(
                mm, k, n, False, out_dtype.itemsize)
            gemm.append({"model": model, "product": prod,
                         "shape_mkn": [mm, k, n],
                         "device_ms": graph_ms(lambda: int8_matmul(
                             xq, s, wq, ws, out_dtype=out_dtype)),
                         "bound_ms": bound, "bound_by": by,
                         "weight_bytes": n * k})
            if (mm, k) not in seen_q:
                seen_q.add((mm, k))
                nb = mm * k * 2 + mm * k + mm * 4
                quant.append({"shape_mk": [mm, k], "device_ms": graph_ms(
                    lambda: dynamic_quantize(x)),
                    "bound_ms": nb / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes"})
            if mm == 8 and (k, n) == widest[model, prod]:
                x32 = dynamic_quantize_input(gen, 32, k)
                xq32, s32 = dynamic_quantize(x32)
                lib = library_int8_fn(xq32, s32, wq, ws, None)
                library.append({
                    "model": model, "product": prod, "shape_mkn": [32, k, n],
                    "kernel_device_ms": graph_ms(lambda: int8_matmul(
                        xq32, s32, wq, ws, out_dtype=out_dtype)),
                    "library_device_ms": None if lib is None
                    else graph_ms(lib),
                    "library": "torch._int_mm + torch epilogue, M 32"})
        del x, xq, s, rq, rs, wq, ws, got, want
    rec = {"checked_shapes": len(cases), "int8_matmul": gemm,
           "dynamic_quantize": quant, "library_m32": library}
    print("ar_kernels " + json.dumps({
        "card": card_line(), "checked_shapes": rec["checked_shapes"],
        "int8_matmul": [(g["model"], g["product"], g["shape_mkn"],
                         round(g["device_ms"], 5), round(g["bound_ms"], 5))
                        for g in gemm],
        "dynamic_quantize": [(q["shape_mk"], round(q["device_ms"], 5),
                              round(q["bound_ms"], 5)) for q in quant],
        "library_m32": [(lb["model"], lb["product"], lb["shape_mkn"],
                         lb["kernel_device_ms"], lb["library_device_ms"])
                        for lb in library]}))
    return rec


def tiny_elm_model(seed, device, quant=False):
    """The tiny OpenELM preset in fp32 with random weights from `seed`
    (tables widened 50x so that tokens vary), on `device`."""
    from unidisc_tpu_torch.models.elm import ELM_PRESETS, OpenELM
    from unidisc_tpu_torch.ops.quant import quantize_elm_params
    cfg = dataclasses.replace(ELM_PRESETS["tiny"],
                              quant="int8" if quant else None)
    state = OpenELM(ELM_PRESETS["tiny"], compute_dtype=torch.float32,
                    init_seed=seed).state_dict()
    state["token_embeddings"] = state["token_embeddings"] * 50
    if quant:
        state = quantize_elm_params(state)
    model = OpenELM(cfg, compute_dtype=torch.float32, init_seed=None)
    model.load_state_dict(state)
    return model.to(device).eval()


def phase_ar_cpu_vs_card(seed) -> dict:
    """The card against the CPU in fp32 (TF32 off), tiny models: the
    OpenELM continuous batcher (bf16 KV cache, and int8 weights with the
    int8 KV cache: the kernels on the card, their plain versions on the
    CPU) and the DIT-AR's (TINY_OVERRIDES, causal), 4 requests, two
    greedy and two seeded at temperature 2 under the keyed noise; and the
    DIT-AR's decode loop at batch 4 with CFG, seeded. Tokens equal. On
    the card the same batchers give each request's tokens alone, under
    load and from the prefix cache (batcher_exactness)."""
    from unidisc_tpu_torch.sampling.ar_sampler import (build_ar_sampler,
                                                       make_apply_token)
    from unidisc_tpu_torch.serving.continuous import (ContinuousBatcher,
                                                      elm_continuous_batcher)
    rng = np.random.RandomState(seed)
    reqs = [(rng.randint(4, 60, 3 + 2 * i).tolist(), 10 + i,
             0.0 if i % 2 == 0 else 2.0, 50 + i) for i in range(4)]
    rec = {}

    def through(make):
        toks = {}
        for dev in ("cpu", "cuda"):
            b = make(dev)
            try:
                futs = [b.submit(p, max_new_tokens=n, temperature=t, seed=s)
                        for p, n, t, s in reqs]
                toks[dev] = [f.result(timeout=300)["tokens"] for f in futs]
            finally:
                b.shutdown()
        return toks

    shared = rng.randint(4, 60, 17).tolist()
    exact_reqs = reqs + [(shared + [5, 6, 7], 8, 2.0, 60),
                         (shared + [9], 8, 0.0, 61)]
    for label, quant in (("elm_bf16_cache", False), ("elm_int8", True)):
        model = tiny_elm_model(seed, "cuda", quant)
        toks = through(lambda dev: elm_continuous_batcher(
            model if dev == "cuda" else tiny_elm_model(seed, dev, quant),
            slots=4, chunk=4, quant_cache=quant))
        rec[label] = toks["cuda"] == toks["cpu"]
        rec[f"{label}_exactness_on_card"] = batcher_exactness(
            lambda pm: elm_continuous_batcher(
                model, slots=4, chunk=4, quant_cache=quant, prefix_min=pm),
            exact_reqs, label)["same_under_load"]
    cfg = Config.make("tiny", **{**TINY_OVERRIDES, **AR_OVERRIDES,
                                 "model.attn_backend": "xla"})
    cpu = DIT(cfg.model, compute_dtype=torch.float32).eval()
    randomize_(cpu, seed)
    card = DIT(cfg.model, compute_dtype=torch.float32).to("cuda").eval()
    card.load_state_dict({k: v.to("cuda") for k, v in
                          cpu.state_dict().items()})
    models = {"cpu": cpu, "cuda": card}
    toks = through(lambda dev: ContinuousBatcher(models[dev], cfg, slots=4,
                                                 chunk=4))
    rec["dit_ar_continuous"] = toks["cuda"] == toks["cpu"]
    rec["dit_ar_exactness_on_card"] = batcher_exactness(
        lambda pm: ContinuousBatcher(card, cfg, slots=4, chunk=4,
                                     prefix_min=pm),
        [(p[:8], 6, t, s) for p, _, t, s in exact_reqs[:4]]
        + [(shared[:17] + [3], 4, 2.0, 62), (shared[:17], 4, 0.0, 63)],
        "dit_ar_tiny")["same_under_load"]
    m = cfg.model
    x0 = rng.randint(0, m.text_vocab_size, (TINY_BATCH, m.length))
    unmask = np.zeros_like(x0, dtype=bool)
    unmask[:, :3] = True
    mod = np.concatenate([np.zeros((TINY_BATCH, m.txt_length)),
                          np.ones((TINY_BATCH, m.img_length))], 1)
    sampled = {dev: build_ar_sampler(make_apply_token(models[dev]), cfg,
                                     chunk=5, device=dev)(
        x0, unmask, mod, seed=7).tokens.cpu() for dev in models}
    rec["dit_ar_sampler"] = bool(torch.equal(sampled["cpu"],
                                             sampled["cuda"]))
    print("ar_cpu_vs_cuda " + json.dumps(rec))
    if not all(rec.values()):
        raise AssertionError(f"AR decoding on the card differs from the "
                             f"CPU: {rec}")
    return rec


def phase_ar(seed) -> dict:
    """Phase 4g: AR serving (module docstring)."""
    t0 = time.perf_counter()
    rec, part_s = {}, {}

    def part(key, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        part_s[key] = time.perf_counter() - t
        return out

    rec["cpu_vs_card"] = part("cpu_vs_card", phase_ar_cpu_vs_card, seed)
    rec["kernels"] = part("kernels", phase_ar_kernels, seed)
    # (a) OpenELM-270M, bf16, then int8 W8A8 with the int8 KV cache
    engine = part("build_elm_bf16", lambda: build_engine(preset="elm:270m"))
    reqs = ar_requests(engine.m.length, seed)
    rec["ar_elm_bf16"] = part("ar_elm_bf16", phase_ar_path, engine, reqs,
                              "ar_elm_bf16", seed)
    rec["ar_http"] = part("ar_http", phase_ar_http, engine)
    qengine = part("build_elm_int8", lambda: build_engine(
        preset="elm:270m", quantize="int8", kv_cache="int8"))
    rec["elm_int8_logits"] = part("elm_int8_logits", elm_int8_logits,
                                  engine.model, qengine.model, seed)
    rec["ar_exactness_fp64"] = part("ar_exactness_fp64", phase_ar_exactness,
                                    engine, reqs)
    shutdown_ar(engine)
    del engine
    rec["ar_elm_int8"] = part("ar_elm_int8", phase_ar_path, qengine, reqs,
                              "ar_elm_int8", seed)
    shutdown_ar(qengine)
    del qengine
    # (c) speculative and prompt-lookup decoding
    rec.update(part("speculative", phase_ar_speculative, seed))
    # (b) the flagship DIT-AR, bf16, then int8 with the int8 KV cache
    dit = build_engine(preset="small",
                       overrides={**FLAGSHIP_OVERRIDES, **AR_OVERRIDES,
                                  **AR_DIT_DEPTH})
    randomize_(dit.model, seed)
    dreqs = ar_requests(dit.m.length, seed)
    rec["ar_dit_sampler_bf16"] = part("ar_dit_sampler_bf16",
                                      phase_ar_sampler, dit,
                                      "ar_dit_sampler_bf16", seed)
    rec["ar_dit_bf16"] = part("ar_dit_bf16", phase_ar_path, dit, dreqs,
                              "ar_dit_bf16", seed)
    qstate = quantize_dit_params(dit.model.state_dict())
    shutdown_ar(dit)
    del dit
    qdit = build_engine(preset="small",
                        overrides={**FLAGSHIP_INT8_OVERRIDES,
                                   **AR_OVERRIDES, **AR_DIT_DEPTH},
                        quantize="int8", kv_cache="int8")
    qdit.model.load_state_dict(qstate)
    rec["ar_dit_sampler_int8"] = part("ar_dit_sampler_int8",
                                      phase_ar_sampler, qdit,
                                      "ar_dit_sampler_int8", seed)
    rec["ar_dit_int8"] = part("ar_dit_int8", phase_ar_path, qdit, dreqs,
                              "ar_dit_int8", seed)
    shutdown_ar(qdit)
    del qdit, qstate
    rec["seconds_by_part"] = part_s
    rec["seconds"] = time.perf_counter() - t0
    card = card_line()
    print("ar_serving " + json.dumps({
        "card": card, "seconds": rec["seconds"],
        "seconds_by_part": part_s,
        **{label: {k: rec[label]["timing"][k] for k in
                   ("ttft_p50_s", "ttft_p95_s", "tpot_p50_ms",
                    "tpot_p95_ms", "tok_per_s")}
           for label in ("ar_elm_bf16", "ar_elm_int8", "ar_dit_bf16",
                         "ar_dit_int8")},
        **{label: {k: rec[label][k] for k in
                   ("ttft_s", "tpot_ms", "tok_per_s")}
           for label in ("ar_dit_sampler_bf16", "ar_dit_sampler_int8")}}))
    print("ar_speculative " + json.dumps({
        "card": card, **{label: {k: rec[label][k] for k in
                                 ("acceptance_rate",
                                  "tokens_per_target_read")}
                         | {"tok_per_s": rec[label]["timing"]["tok_per_s"]}
                         for label in ("ar_spec_draft", "ar_spec_lookup")}}))
    print("ar_programs " + json.dumps({
        "card": card,
        **{label: {k: rec[label]["program"][k] for k in
                   ("build_s", "reserved_bytes", "peak_bytes",
                    "ms_per_replay")}
           for label in ("ar_elm_bf16", "ar_elm_int8", "ar_dit_bf16",
                         "ar_dit_int8")},
        **{label: {k: rec[label][k] for k in
                   ("reserved_bytes", "peak_bytes", "ms_per_replay")}
           for label in ("ar_dit_sampler_bf16", "ar_dit_sampler_int8")}}))
    return rec


# ---------------------------------------------------------------------------
# train path
# ---------------------------------------------------------------------------

def train_config(**extra) -> Config:
    """The flagship training configuration with a 2-step warmup, so the LR
    is non-zero from the second step."""
    return Config.make("small", **{**FLAGSHIP_TRAIN_OVERRIDES,
                                   "trainer.warmup_steps": 2,
                                   **extra}).validate()


def fixed_draws(cfg, batch, seed, device):
    """Every draw of one compute_batch_loss, made once from a seed, so the
    kernel path and the plain path see the same corruption (and, on the
    ar path, the same row flips and inpainting mask)."""
    gen = torch.Generator().manual_seed(seed)
    b, l = batch, cfg.model.length
    shapes = {"t": (b,), "move": (b, l), "txt": (b, 1), "img": (b, 1),
              "flip": (b,), "inpaint": (b, 2 * l), "block": (b, l)}
    return {name: torch.rand(shape, generator=gen).to(device)
            for name, shape in shapes.items()}


def flat_grad(cfg, model, batch, draws) -> torch.Tensor:
    apply_fn = make_apply_fn(cfg, model)
    out = compute_batch_loss(cfg, apply_fn, None, batch, train=True,
                             draws=draws)
    params = [p for _, p in sorted(model.named_parameters())]
    grads = torch.autograd.grad(out.loss, params)
    return torch.cat([g.float().reshape(-1) for g in grads])


def phase_grad_check(cfg, batch_size, seed, device="cuda",
                     label="grad_check", extra=None) -> dict:
    """One compute_batch_loss + backward at full width through the kernels
    (bf16) against the plain path (plain attention, its autograd) in fp32.
    Truth is the plain path in fp32; the kernel path must be as close to
    it as the plain path in bf16 is, within a factor of 2. `extra`: more
    batch entries (an img_cond model's x_cond, whose trunk and
    cross-attention add attention launches)."""
    m = cfg.model
    loader = SyntheticDataLoader(cfg, batch_size, seed=seed)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in next(loader).items()}
    batch.update(extra or {})
    attentions = m.n_blocks
    if m.img_cond and "x_cond" in batch:
        attentions += m.n_blocks + m.n_cond_blocks
    draws = fixed_draws(cfg, batch_size, seed, device)
    state = None
    grads = {}
    for path, backend, dtype in (("kernel_bf16", "auto", torch.bfloat16),
                                 ("plain_bf16", "xla", torch.bfloat16),
                                 ("plain_fp32", "xla", torch.float32)):
        mcfg = dataclasses.replace(cfg, model=dataclasses.replace(
            m, attn_backend=backend))
        model = DIT(mcfg.model, dtype, device=device, init=False)
        if state is None:
            randomize_(model, seed)
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        _build.reset_launch_counts()
        grads[path] = flat_grad(mcfg, model, batch, draws)
        if device == "cuda":
            torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        if path == "kernel_bf16" and device == "cuda":
            want = {name: attentions for name in TRAIN_KERNELS}
            if launches != want:
                raise AssertionError(f"gradient check launched {launches}, "
                                     f"expected {want}")
        del model
    truth = grads["plain_fp32"]
    norm = truth.norm().item()
    rel = {k: (grads[k] - truth).norm().item() / norm
           for k in ("kernel_bf16", "plain_bf16")}
    finite = bool(torch.isfinite(grads["kernel_bf16"]).all().item())
    rec = {"batch": batch_size, "n_grad": truth.numel(), "grad_norm": norm,
           "rel_err_kernel_bf16_vs_plain_fp32": rel["kernel_bf16"],
           "rel_err_plain_bf16_vs_plain_fp32": rel["plain_bf16"],
           "finite": finite}
    print(f"{label} " + json.dumps(rec))
    if not finite or rel["kernel_bf16"] > 2 * rel["plain_bf16"]:
        raise AssertionError(f"{label}: the full-width gradient through the "
                             f"kernels is off: {rec}")
    return rec


def logged(run_dir) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_train(cfg, batch_size, steps, seed, root, device="cuda") -> tuple:
    """Trainer.fit on one synthetic batch, with the counts set to 0 just
    before and read just after; then a resume from the step-CKPT_STEP
    checkpoint must give the next step's loss again. The run dirs stay in
    `root` for phase 5b. Returns (the record, run A's dir, its final EMA
    on the host)."""
    m = cfg.model
    first = next(SyntheticDataLoader(cfg, batch_size, seed=seed))
    run_a = os.path.join(root, "a")
    trainer = Trainer(cfg, run_a, device=device, log_every=1,
                      ckpt_every=CKPT_STEP, max_ckpts=2)
    init = {k: v.detach().clone() for k, v in trainer.state.params.items()}
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(itertools.repeat(first), max_steps=steps)
    if device == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    recs = [r for r in logged(run_a) if "loss" in r]
    losses = [r["loss"] for r in recs]
    step_s = [r["step_s"] for r in recs]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train losses {losses}")
    early, late = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not late < early:
        raise AssertionError(f"the loss did not fall: first 5 mean "
                             f"{early}, last 5 mean {late}: {losses}")
    if device == "cuda":
        want = {name: m.n_blocks * steps for name in TRAIN_KERNELS}
        if launches != want:
            raise AssertionError(f"train path launched {launches}, "
                                 f"expected {want} (12 blocks x "
                                 f"{steps} steps each)")
    ema_moved = max((trainer.state.ema_params[k] - init[k].float())
                    .abs().max().item() for k in init)
    if not ema_moved > 0:
        raise AssertionError("the EMA did not move")
    final_ema = {k: v.detach().cpu().clone()
                 for k, v in trainer.state.ema_params.items()}
    trainer.close()
    del trainer

    # resume: only the step-CKPT_STEP checkpoint, then one more step
    run_b = os.path.join(root, "b")
    shutil.copytree(os.path.join(run_a, "checkpoints", str(CKPT_STEP)),
                    os.path.join(run_b, "checkpoints", str(CKPT_STEP)))
    resumed = Trainer(cfg, run_b, device=device, log_every=1,
                      ckpt_every=0)
    resumed.fit(itertools.repeat(first), max_steps=CKPT_STEP + 1)
    resumed.close()
    again = [r["loss"] for r in logged(run_b) if "loss" in r]
    want_loss = losses[CKPT_STEP]         # the loss of step CKPT_STEP + 1
    if len(again) != 1 or abs(again[0] - want_loss) > 1e-5 * abs(
            want_loss):
        raise AssertionError(f"resumed step {CKPT_STEP + 1} loss "
                             f"{again} != {want_loss}")
    del resumed
    steady = step_s[2:]
    median_s = statistics.median(steady)
    rec = {"batch": batch_size, "length": m.length, "steps": steps,
           "losses": losses, "loss_first5_mean": early,
           "loss_last5_mean": late, "launches": launches,
           "expected_launches_per_kernel": m.n_blocks * steps,
           "step_s": step_s, "median_steady_step_s": median_s,
           "train_tok_per_s": batch_size * m.length / median_s,
           "fit_wall_s": wall_s, "peak_memory_bytes": peak,
           "ema_max_change": ema_moved,
           "resumed_step_loss": again[0], "straight_step_loss": want_loss}
    print("train " + json.dumps(rec))
    return rec, run_a, final_ema


# ---------------------------------------------------------------------------
# 5c: the ar, sedd and d3pm objectives on token shards and stream shards
# ---------------------------------------------------------------------------

SHARD_ROWS = 512
STREAM_ROWS_PER_SHARD = 128
AR_TRAIN_STEPS, AR_SHORT_STEPS = 20, 10
STREAM_STEPS, STREAM_CKPT = 10, 5
LEGACY_STEPS = 10
AR_GRAD_BATCH = 16        # the fp32 plain path at L 768 holds ~25 GB
DATA_ONLY_BATCHES = 200
# the ar_baseline overlay (causal, shifted targets, no time conditioning)
AR_TRAIN_OVERRIDES = {"trainer.parameterization": "ar",
                      "trainer.ar_shift": True,
                      "model.full_attention": False,
                      "model.time_conditioning": False}
# ar_inpainting's [corrupted || clean] rows (L 768) with the row flip
AR_INPAINT = {"trainer.ar_inpainting": True,
              "trainer.rand_flip_ar_prob": 0.5}
# the 5c runs but the served DIT-AR at L 768: the flagship's width, 4 of
# its 12 blocks (each run's host init and checkpoints are most of its time)
AR_SHORT_DEPTH = {"model.n_blocks": 4}
# the counted CLI runs of phase 5c
AR_TRAIN_PATHS = ("ar_train_768", "ar_train_384", "ar_stream",
                  "ar_stream_resumed", "sedd_train", "d3pm_train")


def write_token_data(cfg, seed, root) -> dict:
    """SHARD_ROWS rows [text ids | image ids] with their modality (the
    structured synthetic rows of the seed), written as one token-shard
    directory and as stream shards of STREAM_ROWS_PER_SHARD rows."""
    rows = next(SyntheticDataLoader(cfg, SHARD_ROWS, seed=seed))
    dirs = {"shards": os.path.join(root, "shards"),
            "stream": os.path.join(root, "stream")}
    write_shard(dirs["shards"], rows["input_ids"], rows["modality"])
    write_stream_shards(dirs["stream"], rows["input_ids"], rows["modality"],
                        rows_per_shard=STREAM_ROWS_PER_SHARD)
    return dirs


def cli_args(run_dir, data, steps, batch, overrides, *extra) -> list:
    """The train CLI's arguments: the flagship (FLAGSHIP_TRAIN_OVERRIDES)
    with a 2-step warmup, `overrides` on top, one log line a step."""
    return ["--data", data, "--run-dir", run_dir, "--batch-size",
            str(batch), "--log-every", "1", "--ckpt-every", "0",
            "--flagship", f"trainer.max_steps={steps}",
            "trainer.warmup_steps=2",
            *(f"{k}={v}" for k, v in overrides.items()), *extra]


class KeepFinalState:
    """Trainer.__init__ and Trainer.close wrapped, while the block runs: the
    trainer's initial parameters as it drew them (before any restore; a
    bf16 copy on its device, what a bf16 model loads from its fp32
    masters) and its final EMA and parameters on the host."""

    def __enter__(self):
        self.initial = self.ema = self.params = None
        self._init, self._close = Trainer.__init__, Trainer.close

        def init(trainer, *args, **kw):
            self._init(trainer, *args, **kw)
            self.initial = {k: v.detach().to(torch.bfloat16, copy=True)
                            for k, v in trainer.state.params.items()}

        def close(trainer):
            self.ema, self.params = ({k: v.detach().cpu().clone()
                                      for k, v in tree.items()}
                                     for tree in (trainer.state.ema_params,
                                                  trainer.state.params))
            self._close(trainer)
        Trainer.__init__, Trainer.close = init, close
        return self

    def __exit__(self, *exc):
        Trainer.__init__, Trainer.close = self._init, self._close


def train_cli_run(label, args, steps, n_blocks, falls=True) -> tuple:
    """unidisc_tpu_torch.train.main(args), with the launch counts set to 0
    just before and read just after: each train kernel launched once a
    block a step, every loss finite, and (falls) the mean of the last 3
    logged losses below that of the first 3. Returns (the record, a
    KeepFinalState with the trainer's final EMA and parameters)."""
    run_dir = args[args.index("--run-dir") + 1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with KeepFinalState() as keep:
        result = train_cli.main(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    recs = [r for r in logged(run_dir) if "loss" in r]
    losses = [r["loss"] for r in recs]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label}: losses {losses}")
    early, late = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if falls and not late < early:
        raise AssertionError(f"{label}: the loss did not fall: first 3 mean "
                             f"{early}, last 3 mean {late}: {losses}")
    want = {name: n_blocks * steps for name in TRAIN_KERNELS}
    if launches != want:
        raise AssertionError(f"{label}: the train path launched {launches}, "
                             f"expected {want}")
    median_s = statistics.median([r["step_s"] for r in recs][2:])
    batch = int(args[args.index("--batch-size") + 1])
    rec = {"steps": steps, "result_step": result["step"], "losses": losses,
           "loss_first3_mean": early, "loss_last3_mean": late,
           "launches": launches, "median_steady_step_s": median_s,
           "batch": batch, "wall_s": wall_s, "peak_memory_bytes": peak}
    print(f"{label} " + json.dumps(rec))
    return rec, keep


def fixed_draw_loss_falls(label, cfg, shards, keep, seed) -> dict:
    """The loss of the overfit batch (the first of the shard sampler at
    the config's seed) under one fixed set of draws, at the trainer's
    initial parameters and at its final ones (a KeepFinalState): it must
    fall. A logged loss of the sedd and d3pm objectives is one draw of t
    per row, and its spread from step to step (weights dsigma / expm1 and
    T / t) is larger than 10 steps of training move it; the fixed draws
    take that spread out."""
    sampler = WeightedDatasetSampler([TokenShardDataset(shards)],
                                     batch_size=TRAIN_BATCH, seed=cfg.seed)
    return fixed_draw_batch_loss_falls(label, cfg, next(sampler),
                                       keep.initial, keep.params, seed)


def fixed_draw_batch_loss_falls(label, cfg, batch, initial_params,
                                final_params, seed) -> dict:
    """fixed_draw_loss_falls on a given host batch, from the trainer's
    initial and final parameters."""
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()
             if isinstance(v, np.ndarray)}
    draws = fixed_draws(cfg, batch["input_ids"].shape[0], seed, "cuda")
    model = DIT(cfg.model, torch.bfloat16, device="cuda", init=False)
    model.load_state_dict(initial_params)
    apply_fn = make_apply_fn(cfg, model)
    losses = []
    with torch.no_grad():
        for params in (None, final_params):
            if params is not None:
                model.load_state_dict(params)
            losses.append(compute_batch_loss(
                cfg, apply_fn, None, batch, train=True,
                draws=draws).loss.item())
    del model
    torch.cuda.empty_cache()
    rec = {"fixed_draw_loss_initial": losses[0],
           "fixed_draw_loss_final": losses[1]}
    if not all(map(math.isfinite, losses)) or not losses[1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall under fixed "
                             f"draws: {rec}")
    return rec


def phase_stream_resume(cfg, data, seed, root, n_blocks) -> dict:
    """--stream for STREAM_STEPS steps with a checkpoint at STREAM_CKPT;
    a run resumed from that checkpoint alone reads the straight run's
    batches bit for bit (the loader state in the checkpoint, replayed
    through StreamingShardReader) and logs its losses within phase 5's
    resume criterion. At AR_SHORT_DEPTH (n_blocks its blocks)."""
    over = {**AR_TRAIN_OVERRIDES, **AR_INPAINT, **AR_SHORT_DEPTH}
    straight = os.path.join(root, "stream_a")
    rec = {"straight": train_cli_run(
        "ar_stream", cli_args(straight, data, STREAM_STEPS, TRAIN_BATCH,
                              over, "--stream", "--ckpt-every",
                              str(STREAM_CKPT)),
        STREAM_STEPS, n_blocks, falls=False)[0]}
    resumed = os.path.join(root, "stream_b")
    shutil.copytree(os.path.join(straight, "checkpoints", str(STREAM_CKPT)),
                    os.path.join(resumed, "checkpoints", str(STREAM_CKPT)))
    rec["resumed"] = train_cli_run(
        "ar_stream_resumed", cli_args(resumed, data, STREAM_STEPS,
                                      TRAIN_BATCH, over, "--stream"),
        STREAM_STEPS - STREAM_CKPT, n_blocks, falls=False)[0]
    want = rec["straight"]["losses"][STREAM_CKPT:]
    got = rec["resumed"]["losses"]
    for g, w in zip(got, want):
        if abs(g - w) > 1e-5 * abs(w):
            raise AssertionError(f"resumed stream losses {got} != {want}")
    metas = [CheckpointManager(os.path.join(d, "checkpoints"))
             for d in (straight, resumed)]
    mid = metas[0].read_meta(STREAM_CKPT)["loader"]
    end = [m.read_meta(STREAM_STEPS)["loader"] for m in metas]
    if end[0] != end[1] or mid == end[0]:
        raise AssertionError(f"loader states: mid {mid}, ends {end}")
    # the batches: the straight sequence against one resumed from `mid`
    reader = StreamingShardReader(data, batch_size=TRAIN_BATCH,
                                  seed=cfg.seed)
    batches = list(itertools.islice(iter(reader), STREAM_STEPS))
    again = StreamingShardReader(data, batch_size=TRAIN_BATCH, seed=0)
    again.load_state_dict(mid)
    for want_b, got_b in zip(batches[STREAM_CKPT:],
                             itertools.islice(iter(again),
                                              STREAM_STEPS - STREAM_CKPT)):
        for k in want_b:
            if want_b[k].tobytes() != got_b[k].tobytes():
                raise AssertionError(f"a resumed stream batch differs ({k})")
    if again.state_dict() != end[0]:
        raise AssertionError(f"replayed loader state {again.state_dict()} "
                             f"!= {end[0]}")
    rec.update({"mid_state": mid, "end_state": end[0],
                "batches_equal": True, "resumed_losses": got,
                "straight_losses": want})
    for d in (straight, resumed):
        shutil.rmtree(d, ignore_errors=True)
    return rec


def phase_serve_trained(run_dir, final_ema, seed) -> dict:
    """build_engine(checkpoint=) on the DIT-AR run dir: the served weights
    equal the trainer's final EMA bit for bit, and 8 streamed
    complete_text requests (counts set to 0 just before, read just after)
    answer with ids in the text vocabulary."""
    t0 = time.perf_counter()
    engine = build_engine(checkpoint=run_dir)
    build_s = time.perf_counter() - t0
    for name, value in engine.model.state_dict().items():
        if not torch.equal(value.cpu(), final_ema[name]):
            raise AssertionError(f"served {name} is not the trainer's final "
                                 f"EMA")
    m = engine.m
    engine.complete_text("warm up the prefill", max_new_tokens=4).result(
        timeout=600)
    reqs = ar_requests(m.length, seed)[:REQUESTS]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    timing, results = run_ar_requests(engine, reqs)
    launches = dict(_build.launch_counts)
    for r, res in zip(reqs, results):
        toks = res["tokens"]
        if not toks or len(toks) > r["max_new_tokens"] or any(
                not 0 <= t < m.text_vocab_size for t in toks):
            raise AssertionError(f"a served answer out of bounds: {res}")
    rec = {"build_s": build_s, "weights_equal_final_ema": True,
           "timing": timing, "launches": launches,
           "tokens": [len(r["tokens"]) for r in results],
           "distinct_outputs": len({tuple(r["tokens"]) for r in results})}
    print("ar_served_run_dir " + json.dumps(rec))
    shutdown_ar(engine)
    free(engine)
    return rec


def phase_ar_train(seed, root, kernel_rows, bwd_rows) -> dict:
    """Phase 5c (module docstring)."""
    t0 = time.perf_counter()
    cfg = train_config(**AR_TRAIN_OVERRIDES, **AR_INPAINT)
    n_blocks = cfg.model.n_blocks
    data = write_token_data(cfg, seed, root)
    rec = {"grad_check": phase_grad_check(cfg, AR_GRAD_BATCH, seed)}
    torch.cuda.empty_cache()
    rec["data_only"] = {
        kind: train_cli.main(cli_args(
            os.path.join(root, "data_only"), data[kind], 0, TRAIN_BATCH,
            {}, "--iterate-data-only", str(DATA_ONLY_BATCHES),
            *(["--stream"] if kind == "stream" else [])))["data_tok_per_s"]
        for kind in ("shards", "stream")}
    run_768 = os.path.join(root, "ar_768")
    rec["ar_train_768"], final = train_cli_run(
        "ar_train_768", cli_args(run_768, data["shards"], AR_TRAIN_STEPS,
                                 TRAIN_BATCH, {**AR_TRAIN_OVERRIDES,
                                               **AR_INPAINT}, "--overfit"),
        AR_TRAIN_STEPS, n_blocks)
    rec["served"] = phase_serve_trained(run_768, final.ema, seed)
    del final
    shutil.rmtree(run_768, ignore_errors=True)
    short = AR_SHORT_DEPTH["model.n_blocks"]
    run_384 = os.path.join(root, "ar_384")
    rec["ar_train_384"] = train_cli_run(
        "ar_train_384", cli_args(run_384, data["shards"], AR_SHORT_STEPS,
                                 TRAIN_BATCH, {**AR_TRAIN_OVERRIDES,
                                               "trainer.rand_flip_ar_prob":
                                               0.5, **AR_SHORT_DEPTH},
                                 "--overfit"),
        AR_SHORT_STEPS, short)[0]
    shutil.rmtree(run_384, ignore_errors=True)
    rec["stream"] = phase_stream_resume(cfg, data["stream"], seed, root,
                                        short)
    for kind in ("sedd", "d3pm"):
        run = os.path.join(root, kind)
        over = {"trainer.parameterization": kind, **AR_SHORT_DEPTH}
        rec[f"{kind}_train"], final = train_cli_run(
            f"{kind}_train", cli_args(run, data["shards"], LEGACY_STEPS,
                                      TRAIN_BATCH, over, "--overfit"),
            LEGACY_STEPS, short, falls=False)
        shutil.rmtree(run, ignore_errors=True)
        rec[f"{kind}_train"].update(fixed_draw_loss_falls(
            kind, train_config(**over), data["shards"], final, seed))
        del final
    rec["seconds"] = time.perf_counter() - t0
    for label, paths in (("ar_stream", ("stream", "straight")),
                         ("ar_stream_resumed", ("stream", "resumed"))):
        rec[label] = rec[paths[0]][paths[1]]
    length = cfg.model.length

    def line(run, tokens_per_row):
        r = rec[run]
        return {"median_step_s": r["median_steady_step_s"],
                "train_tok_per_s": r["batch"] * tokens_per_row
                / r["median_steady_step_s"],
                "peak_memory_bytes": r["peak_memory_bytes"],
                "loss_first3_mean": r["loss_first3_mean"],
                "loss_last3_mean": r["loss_last3_mean"]}

    fwd = next(r for r in kernel_rows if r["case"] == "ar_inpainting_path")
    bwd = next(r for r in bwd_rows if r["case"] == "ar_inpainting_path")
    print("ar_train " + json.dumps({
        "card": card_line(), "seconds": rec["seconds"],
        # the model runs L 768 tokens a row under ar_inpainting; the data
        # rows are L 384
        "L768_inpainting": line("ar_train_768", 2 * length),
        "L384": line("ar_train_384", length),
        **{kind: line(f"{kind}_train", length)
           | {k: rec[f"{kind}_train"][k] for k in (
               "fixed_draw_loss_initial", "fixed_draw_loss_final")}
           for kind in ("sedd", "d3pm")},
        "loader_host_tok_per_s": rec["data_only"],
        "stream_resume_exact": rec["stream"]["batches_equal"],
        "served": {k: rec["served"]["timing"][k]
                   for k in ("ttft_p50_s", "tpot_p50_ms", "tok_per_s")},
        "grad_rel_err": {k: rec["grad_check"][k] for k in (
            "rel_err_kernel_bf16_vs_plain_fp32",
            "rel_err_plain_bf16_vs_plain_fp32")},
        "L768_kernels": {
            "flash_fwd": {k: fwd[k] for k in (
                "ms", "device_ms", "bound_ms", "library_ms",
                "library_device_ms", "max_abs_err", "lse_err")},
            "flash_bwd": {k: bwd[k] for k in (
                "ms_dq", "ms_dkv", "device_ms_dq", "device_ms_dkv",
                "library_ms", "library_device_ms", "max_abs_err")}
            | {"bound_ms": {n: bwd["bounds"][n]["bound_ms"] for n in (
                "flash_bwd_dq", "flash_bwd_dkv", "backward")}}}}))
    return rec


# ---------------------------------------------------------------------------
# 5d: the rest of training
# ---------------------------------------------------------------------------

REST_STEPS = 10
REST_CKPT = 5
REMAT_POLICIES = ("none", "dots", "dots_all")
REST_DROPOUT = 0.1
XL_BATCH, XL_STEPS = 16, 2   # the first step warms up
# extra_large's width, 8 of its 24 blocks (its host buffers, copies and
# inits are most of phase 5d's offload part)
XL_DEPTH = {"model.n_blocks": 8}
SUP_BATCH, SUP_STEPS, SUP_SIGNAL_AFTER, SUP_BLOCKS = 8, 16, 4, 4
# the optimizer runs and the flagship's offload runs: its width, 4 of its
# 12 blocks
REST_DEPTH = {"model.n_blocks": 4}
# the one update of each optimizer on the card against the CPU: its width,
# 2 blocks (the CPU's update is host time; every leaf kind is there)
UPDATE_CHECK_DEPTH = {"model.n_blocks": 2}
DISTILL_BLOCKS, DISTILL_GUIDANCE = 4, 2.0
# each optimizer's LR for its 10 steps (Lion wants ~3-10x less than AdamW,
# Adafactor's LR multiplies the parameters' RMS)
OPTIMIZER_RUNS = {
    "lion": {"trainer.optimizer": "lion", "trainer.lr": 1e-4},
    "ademamix": {"trainer.optimizer": "ademamix", "trainer.lr": 3e-4},
    "adafactor": {"trainer.optimizer": "adafactor", "trainer.lr": 1e-2},
    "muon": {"trainer.optimizer": "muon", "trainer.lr": 1e-3},
    "mup": {"model.mup": True, "trainer.lr": 1e-3},
}
# the served sampling of a trained run dir (the flagship serving config)
SERVE_OVER = {k: v for k, v in FLAGSHIP_OVERRIDES.items()
              if k.startswith("sampling.") or k == "model.logits_dtype"}
# the counted runs of phase 5d, each with its launch counts
TRAIN_REST_PATHS = ("rest_dropout_remat_fit", "rest_lion", "rest_ademamix",
                    "rest_adafactor", "rest_adafactor_resumed", "rest_muon",
                    "rest_mup", "rest_lora", "lora_serve", "rest_offload",
                    "offload_serve", "rest_distill")


def train_launches(n_fwd, n_bwd, steps) -> dict:
    return {"flash_fwd": n_fwd * steps, "flash_bwd_dq": n_bwd * steps,
            "flash_bwd_dkv": n_bwd * steps}


def check_launches(label, launches, want) -> None:
    if launches != want:
        raise AssertionError(f"{label}: launched {launches}, expected "
                             f"{want}")


def remat_grad(cfg, state, batch, draws, policy, seed,
               timed: int = 0) -> tuple:
    """The flat fp32 gradient of one compute_batch_loss of the flagship
    (bf16, through the kernels), with remat `policy` (None: off) and the
    dropout masks of seed `seed`; (grad, launches, peak bytes, the median
    s of `timed` more forward + backward passes)."""
    mcfg = dataclasses.replace(cfg.model, remat_policy=policy or "none")
    c = dataclasses.replace(cfg, model=mcfg)
    model = DIT(mcfg, torch.bfloat16, remat=policy is not None,
                device="cuda", init=False)
    model.load_state_dict(state)
    apply_fn = make_apply_fn(c, model)
    params = [p for _, p in sorted(model.named_parameters())]

    def grad():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        out = compute_batch_loss(c, apply_fn, None, batch, train=True,
                                 draws=draws, generator=gen)
        return torch.autograd.grad(out.loss, params)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    grads = grad()
    flat = torch.cat([g.float().reshape(-1) for g in grads])
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    del grads
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        grad()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    del model
    return flat, launches, peak, statistics.median(times) if times else None


def grads_agree(label, base, again, others) -> dict:
    """The remat gradients against the gradient without remat: bit for bit
    when two runs without remat are (the forward recomputed under remat
    runs the same kernels on the same inputs); else within twice their
    run-to-run difference."""
    noise = (again - base).abs().max().item()
    rec = {"no_remat_run_to_run_max_abs": noise}
    for name, g in others.items():
        err = (g - base).abs().max().item()
        rec[f"{name}_max_abs"] = err
        rec[f"{name}_bit_equal"] = bool(torch.equal(g, base))
        if not torch.isfinite(g).all() or err > 2 * noise:
            raise AssertionError(f"{label}: {name}'s gradient differs by "
                                 f"{err} (run to run {noise})")
    return rec


def phase_remat(seed) -> dict:
    """(a) the full-width gradient under every remat policy against the
    gradient without remat, with exact launch counts and peak memory;
    (b) with dropout 0.1 the same from one seed, remat "dots" against
    off."""
    cfg = train_config()
    n = cfg.model.n_blocks
    loader = SyntheticDataLoader(cfg, TRAIN_BATCH, seed=seed)
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(loader).items()}
    draws = fixed_draws(cfg, TRAIN_BATCH, seed, "cuda")
    model = DIT(cfg.model, torch.bfloat16, init=False)
    randomize_(model, seed)
    state = model.state_dict()
    del model
    rec = {"peak_bytes": {}, "launches": {}}
    for label, c in (("dropout_0", cfg),
                     ("dropout_0.1", train_config(
                         **{"model.dropout": REST_DROPOUT}))):
        grads = {}
        for name, policy in (("off", None), ("off_again", None),
                             *((p, p) for p in REMAT_POLICIES)):
            if label != "dropout_0" and policy not in (None, "dots"):
                continue
            g, launches, peak, grad_s = remat_grad(
                c, state, batch, draws, policy, seed + 1,
                timed=3 if name != "off_again" else 0)
            check_launches(f"{label} remat {policy}", launches,
                           train_launches(2 * n if policy else n, n, 1))
            grads[name] = g
            rec["peak_bytes"][f"{label}/{name}"] = peak
            rec["launches"][f"{label}/{name}"] = launches
            if grad_s is not None:
                rec.setdefault("grad_s", {})[f"{label}/{name}"] = grad_s
            torch.cuda.empty_cache()
        rec[label] = grads_agree(
            label, grads.pop("off"), grads.pop("off_again"), grads)
        del grads
        torch.cuda.empty_cache()
    print("remat " + json.dumps(rec))
    return rec


def cli_rest_args(run_dir, steps, overrides, *extra) -> list:
    """The train CLI on synthetic data (its first batch, --overfit): the
    flagship with a 2-step warmup, `overrides` on top."""
    return ["--run-dir", run_dir, "--batch-size", str(TRAIN_BATCH),
            "--log-every", "1", "--ckpt-every", "0", "--flagship",
            "--overfit", f"trainer.max_steps={steps}",
            "trainer.warmup_steps=2",
            *(f"{k}={v}" for k, v in overrides.items()), *extra]


def update_card_vs_cpu(name, over, params_cpu, grads_cpu) -> dict:
    """One update of optimizer `name` from the same parameters and
    gradients on the card and on the CPU. The updates (new - old) agree
    within 1e-3 of the largest update, except Lion's sign at elements
    whose interpolated momentum is within rounding of 0 (a share at most
    1e-5)."""
    cfg = train_config(**{**over, "trainer.warmup_steps": 0})
    out = {}
    for dev in ("cpu", "cuda"):
        params = {k: torch.nn.Parameter(v.to(dev, copy=True))
                  for k, v in params_cpu.items()}
        flat = flat_parameters(params)
        opt = make_optimizer(cfg)
        st = opt.init(flat, params)
        t0 = time.perf_counter()
        opt.apply(flat, grads_cpu.to(dev), st, params=params)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = ((flat.detach().cpu() - torch.cat(
            [v.reshape(-1) for v in params_cpu.values()])),
            time.perf_counter() - t0)
        del params, flat, st
    (upd_cpu, cpu_s), (upd_card, card_s) = out["cpu"], out["cuda"]
    scale = upd_cpu.abs().max().item()
    err = (upd_card - upd_cpu).abs()
    off = (err > 1e-3 * scale).float().mean().item()
    rec = {"max_abs_update": scale, "max_abs_err": err.max().item(),
           "rel_err": err.max().item() / scale, "share_off": off,
           "cpu_s": cpu_s, "card_s": card_s}
    if not scale > 0 or off > (1e-5 if name == "lion" else 0.0):
        raise AssertionError(f"{name}: the card's update differs from the "
                             f"CPU's: {rec}")
    return rec


def phase_optimizers(seed, root) -> dict:
    """(c) each optimizer and muP: one full-width update on the card
    against the CPU (UPDATE_CHECK_DEPTH's blocks), then 10 steps through
    train.main on REST_DEPTH's blocks whose loss under fixed draws falls;
    Adafactor also checkpointed at 5 and resumed."""
    cfg = train_config(**REST_DEPTH)
    n = cfg.model.n_blocks
    model = DIT(train_config(**UPDATE_CHECK_DEPTH).model, torch.float32,
                init=False)
    randomize_(model, seed)
    params_cpu = {k: v.detach().clone() for k, v in model.named_parameters()}
    del model
    gen = torch.Generator().manual_seed(seed)
    grads_cpu = 1e-3 * torch.randn(
        sum(v.numel() for v in params_cpu.values()), generator=gen)
    first = next(SyntheticDataLoader(cfg, TRAIN_BATCH, seed=cfg.seed))
    rec = {}
    for name, over in OPTIMIZER_RUNS.items():
        t0 = time.perf_counter()
        over = {**REST_DEPTH, **over}
        r = {"card_vs_cpu": update_card_vs_cpu(
            name, {**over, **UPDATE_CHECK_DEPTH}, params_cpu, grads_cpu)}
        run = os.path.join(root, f"opt_{name}")
        extra = ("--ckpt-every", str(REST_CKPT)) if name == "adafactor" \
            else ()
        r["run"], final = train_cli_run(
            f"rest_{name}", cli_rest_args(run, REST_STEPS, over, *extra),
            REST_STEPS, n, falls=False)
        r["run"].update(fixed_draw_batch_loss_falls(
            f"rest_{name}", train_config(**over), first, final.initial,
            final.params, seed))
        del final
        if name == "adafactor":
            resumed = os.path.join(root, "opt_adafactor_resumed")
            shutil.copytree(os.path.join(run, "checkpoints", str(REST_CKPT)),
                            os.path.join(resumed, "checkpoints",
                                         str(REST_CKPT)))
            r["resumed"] = train_cli_run(
                "rest_adafactor_resumed", cli_rest_args(resumed, REST_STEPS,
                                                        over),
                REST_STEPS - REST_CKPT, n, falls=False)[0]
            want = r["run"]["losses"][REST_CKPT:]
            got = r["resumed"]["losses"]
            if len(got) != len(want) or any(
                    abs(g - w) > 1e-5 * abs(w) for g, w in zip(got, want)):
                raise AssertionError(f"resumed adafactor losses {got} != "
                                     f"{want}")
            shutil.rmtree(resumed, ignore_errors=True)
        shutil.rmtree(run, ignore_errors=True)
        r["seconds"] = time.perf_counter() - t0
        rec[name] = r
        torch.cuda.empty_cache()
    print("optimizers " + json.dumps({k: {
        "card_vs_cpu_rel_err": v["card_vs_cpu"]["rel_err"],
        "fixed_draw_loss": [v["run"]["fixed_draw_loss_initial"],
                            v["run"]["fixed_draw_loss_final"]],
        "median_step_s": v["run"]["median_steady_step_s"],
        "seconds": v["seconds"]}
        for k, v in rec.items()}))
    return rec


def fit_counted(label, trainer, batch, steps, want) -> dict:
    """Trainer.fit on one host batch, the counts set to 0 just before and
    read just after; the step time, tok/s and peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    result = trainer.fit(itertools.repeat(batch), max_steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    check_launches(label, launches, want)
    recs = [r for r in logged(trainer.run_dir) if "loss" in r]
    losses = [r["loss"] for r in recs]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label}: losses {losses}")
    median_s = statistics.median([r["step_s"] for r in recs][2:])
    b, length = batch["input_ids"].shape
    rec = {"steps": steps, "result_step": result["step"], "losses": losses,
           "loss_first3_mean": statistics.mean(losses[:3]),
           "loss_last3_mean": statistics.mean(losses[-3:]),
           "launches": launches, "median_steady_step_s": median_s,
           "train_tok_per_s": b * length / median_s, "batch": b,
           "wall_s": wall, "peak_memory_bytes":
           torch.cuda.max_memory_allocated()}
    print(f"{label} " + json.dumps(rec))
    return rec


def phase_dropout_fit(seed, root) -> tuple:
    """(b) 10 steps through Trainer.fit with dropout 0.1 under remat
    "dots": twice the forward launches, the loss under fixed draws falls."""
    cfg = train_config(**{"model.dropout": REST_DROPOUT,
                          "trainer.use_gradient_checkpointing": True,
                          "model.remat_policy": "dots"})
    n = cfg.model.n_blocks
    first = next(SyntheticDataLoader(cfg, TRAIN_BATCH, seed=seed))
    with KeepFinalState() as keep:
        trainer = Trainer(cfg, os.path.join(root, "dropout_remat"),
                          log_every=1, ckpt_every=0)
        rec = fit_counted("rest_dropout_remat_fit", trainer, first,
                          REST_STEPS, train_launches(2 * n, n, REST_STEPS))
        trainer.close()
    del trainer
    rec.update(fixed_draw_batch_loss_falls("rest_dropout_remat_fit", cfg,
                                           first, keep.initial, keep.params,
                                           seed))
    shutil.rmtree(os.path.join(root, "dropout_remat"), ignore_errors=True)
    return rec


def serve_run_dir(label, run_dir, want_weights) -> dict:
    """build_engine(checkpoint=) with the flagship serving config: the
    served weights equal `want_weights` bit for bit; 8 t2i requests with
    exact launch counts (phase_serve)."""
    engine = build_engine(checkpoint=run_dir, overrides=SERVE_OVER)
    for name, value in engine.model.state_dict().items():
        if not torch.equal(value.cpu(), want_weights[name]):
            raise AssertionError(f"{label}: served {name} differs")
    rec = phase_serve(engine, t2i_requests(engine), label, eager=False)
    rec["weights_equal"] = True
    free(engine)
    del engine
    free()
    return rec


def phase_lora(seed, root, base_run) -> dict:
    """(d) LoRA r16 over phase 5's run dir (base_checkpoint), 10 steps: the
    base stays bit-equal; the run dir is served as base + EMA adapter."""
    from unidisc_tpu_torch.training.lora import merge_lora
    from unidisc_tpu_torch.training.trainer import restore_base_params
    cfg = train_config(**{"model.lora_rank": 16, "trainer.lr": 1e-3})
    n = cfg.model.n_blocks
    run = os.path.join(root, "lora")
    first = next(SyntheticDataLoader(cfg, TRAIN_BATCH, seed=seed))
    trainer = Trainer(cfg, run, log_every=1, ckpt_every=0,
                      base_checkpoint=base_run)
    base = restore_base_params(base_run)
    rec = fit_counted("rest_lora", trainer, first, REST_STEPS,
                      train_launches(n, n, REST_STEPS))
    for name, value in trainer.model.state_dict().items():
        if not torch.equal(value.cpu(), base[name]):
            raise AssertionError(f"LoRA changed the frozen base's {name}")
    adapter_ema = {k: v.detach().cpu().clone()
                   for k, v in trainer.state.ema_params.items()}
    rec["adapter_params"] = sum(v.numel() for v in adapter_ema.values())
    rec["adapter_file"] = os.path.exists(os.path.join(run,
                                                      "lora_adapter.npz"))
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    merged = merge_lora(base, adapter_ema, alpha=cfg.model.lora_alpha,
                        rank=cfg.model.lora_rank)
    rec["served"] = serve_run_dir("lora_serve", run, merged)
    shutil.rmtree(run, ignore_errors=True)
    return rec


def offload_state(cfg, seed, chunks, remat=False):
    """A flagship-width (or cfg's) offload train state from the seed's
    init, with its step function."""
    from unidisc_tpu_torch.training.offload import (init_offload_state,
                                                    make_offload_train_step)
    model = DIT(cfg.model, torch.bfloat16, remat=remat, init=False)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    state = init_offload_state(cfg, model, "cuda", chunks=chunks)
    return state, make_offload_train_step(cfg, model)


def timed_steps(step, state, batch, steps) -> tuple:
    """`steps` steps, each generator seeded by its index; (per-step s
    (host clock, synchronized), peak bytes, last loss)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, gen = [], torch.Generator(device="cuda")
    for i in range(steps):
        gen.manual_seed(i)
        t0 = time.perf_counter()
        state, metrics = step(state, batch, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, torch.cuda.max_memory_allocated(), metrics.loss.item()


def phase_offload(seed, root) -> dict:
    """(e) offload, on REST_DEPTH's blocks: chunked (8) = unchunked (1)
    and working = bf16(master) on the card; 10 steps through Trainer.fit,
    its run dir served; extra_large at batch 16, resident without and with
    remat and offloaded with remat, XL_STEPS steps each."""
    cfg = train_config(**{**REST_DEPTH,
                          "trainer.host_offload_optimizer": True})
    n = cfg.model.n_blocks
    first = next(SyntheticDataLoader(cfg, TRAIN_BATCH, seed=seed))
    batch = {k: torch.from_numpy(v).cuda() for k, v in first.items()}
    masters = {}
    for chunks in (8, 1):
        state, step = offload_state(cfg, cfg.seed, chunks)
        timed_steps(step, state, batch, 2)
        masters[chunks] = state.gathered("masters")
        work = {k: v.detach().clone() for k, v in state.params.items()}
        del state, step
        torch.cuda.empty_cache()
    for k, v in masters[8].items():
        if not torch.equal(v, masters[1][k]):
            raise AssertionError(f"offload: chunked {k} != unchunked")
        if not torch.equal(work[k].cpu(), v.to(torch.bfloat16)):
            raise AssertionError(f"offload: working {k} != bf16(master)")
    del masters, work
    run = os.path.join(root, "offload")
    trainer = Trainer(cfg, run, log_every=1, ckpt_every=0)
    rec = {"chunked_equals_unchunked": True,
           "working_equals_bf16_master": True,
           "fit": fit_counted("rest_offload", trainer, first, REST_STEPS,
                              train_launches(n, n, REST_STEPS))}
    spec = trainer.state.spec
    rec["fit"]["chunks"], rec["fit"]["chunk_size"] = spec.chunks, \
        spec.chunk_size
    rec["fit"]["pcie_bytes_per_step_each_way"] = 16 * spec.chunks \
        * spec.chunk_size
    ema = trainer.state.ema_params
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    rec["served"] = serve_run_dir("offload_serve", run, ema)
    shutil.rmtree(run, ignore_errors=True)
    del ema

    # extra_large: the model offload exists for
    xl = {}
    xcfg = Config.make("extra_large", **{
        **{k: v for k, v in FLAGSHIP_TRAIN_OVERRIDES.items()
           if not k.startswith("model.")}, **XL_DEPTH,
        "model.dropout": 0.0, "trainer.warmup_steps": 2}).validate()
    xbatch = {k: torch.from_numpy(v).cuda() for k, v in next(
        SyntheticDataLoader(xcfg, XL_BATCH, seed=seed)).items()}
    xn = xcfg.model.n_blocks
    # one host model, copied for each resident run, its weights drawn on
    # the card (the host's init of the whole 1.41B weights took 25 s)
    t0 = time.perf_counter()
    host_model = DIT(xcfg.model, torch.bfloat16, device="cuda", init=False)
    randomize_(host_model, seed)
    host_model = host_model.cpu()
    rec["extra_large_host_init_s"] = time.perf_counter() - t0
    for label, offload, remat in (("resident", False, False),
                                  ("resident_remat", False, True),
                                  ("offload_remat", True, True)):
        c = xcfg.override(**{"trainer.use_gradient_checkpointing": remat,
                             "trainer.host_offload_optimizer": offload})
        t0 = time.perf_counter()
        # the last run takes the host model itself
        model = host_model if offload else copy.deepcopy(host_model)
        model.remat = remat
        if offload:
            from unidisc_tpu_torch.training.offload import (
                init_offload_state, make_offload_train_step)
            state = init_offload_state(c, model, "cuda")
            step = make_offload_train_step(c, model)
        else:
            model = model.cuda()
            state = init_train_state(c, model)
            step = make_train_step(c, model)
        init_s = time.perf_counter() - t0
        rec["extra_large_params"] = sum(p.numel()
                                        for p in state.params.values())
        _build.reset_launch_counts()
        times, peak, loss = timed_steps(step, state, xbatch, XL_STEPS)
        check_launches(f"extra_large {label}", dict(_build.launch_counts),
                       train_launches(2 * xn if remat else xn, xn,
                                      XL_STEPS))
        if not math.isfinite(loss):
            raise AssertionError(f"extra_large {label}: loss {loss}")
        xl[label] = {"peak_memory_bytes": peak,
                     "median_step_s": statistics.median(times[1:]),
                     "step_s": times, "init_s": init_s, "last_loss": loss,
                     "train_tok_per_s": XL_BATCH * xcfg.model.length
                     / statistics.median(times[1:])}
        print(f"extra_large_{label} " + json.dumps(xl[label]))
        del state, step, model
        gc.collect()
        torch.cuda.empty_cache()
    del host_model
    rec["extra_large"] = xl
    return rec


def phase_distill(seed, root, teacher_run) -> dict:
    """(f) CFG distillation (guidance 2.0) of a 4-block student of the
    flagship's width from phase 5's run dir (its EMA), 10 steps: the
    teacher runs the [cond || uncond] forward at batch 64 under no_grad,
    launches exact, the KL falls."""
    from unidisc_tpu_torch.training.distill import make_distill_step
    tcfg = train_config()
    snap, weights, _ = restore_run(teacher_run)
    teacher = DIT(snap.model, torch.bfloat16, device="cuda", init=False).eval()
    teacher.load_state_dict(weights)
    scfg = train_config(**{"model.n_blocks": DISTILL_BLOCKS,
                           "model.zero_linear_init": False,
                           "trainer.lr": 1e-3})
    student = DIT(scfg.model, torch.bfloat16, init=False)
    student.reset_parameters(torch.Generator().manual_seed(scfg.seed))
    student = student.cuda()
    state = init_train_state(scfg, student)
    step = make_distill_step(
        scfg, student, lambda x, s, m: teacher(x, s, modality=m),
        guidance=DISTILL_GUIDANCE)
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(
        SyntheticDataLoader(scfg, TRAIN_BATCH, seed=seed)).items()}
    gen = torch.Generator(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    kls, times = [], []
    for i in range(REST_STEPS):
        gen.manual_seed(i)
        t0 = time.perf_counter()
        state, m = step(state, batch, generator=gen)
        kls.append(m.kl.item())
        times.append(time.perf_counter() - t0)
    launches = dict(_build.launch_counts)
    tn = tcfg.model.n_blocks
    check_launches("rest_distill", launches, {
        "flash_fwd": (tn + DISTILL_BLOCKS) * REST_STEPS,
        "flash_bwd_dq": DISTILL_BLOCKS * REST_STEPS,
        "flash_bwd_dkv": DISTILL_BLOCKS * REST_STEPS})
    early, late = statistics.mean(kls[:3]), statistics.mean(kls[-3:])
    if not all(map(math.isfinite, kls)) or not late < early:
        raise AssertionError(f"distill: the KL did not fall: {kls}")
    rec = {"kl": kls, "kl_first3_mean": early, "kl_last3_mean": late,
           "launches": launches, "guidance": DISTILL_GUIDANCE,
           "student_blocks": DISTILL_BLOCKS, "teacher_blocks": tn,
           "median_step_s": statistics.median(times[2:]),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    print("rest_distill " + json.dumps(rec))
    del teacher, student, state, step
    torch.cuda.empty_cache()
    return rec


def phase_supervised(root) -> dict:
    """(g) python -m unidisc_tpu_torch.training.supervisor -- python -m
    unidisc_tpu_torch.train (the flagship's width, SUP_BLOCKS blocks,
    batch 8): SIGTERM to the child after its 4th logged step; it
    checkpoints and exits 143, the supervisor relaunches it, it resumes
    and finishes."""
    run = os.path.join(root, "supervised")
    log = os.path.join(root, "supervisor.jsonl")
    args = ["--run-dir", run, "--batch-size", str(SUP_BATCH), "--log-every",
            "1", "--ckpt-every", "0", "--flagship", "--overfit",
            f"trainer.max_steps={SUP_STEPS}", "trainer.warmup_steps=2",
            f"model.n_blocks={SUP_BLOCKS}"]
    env = {**os.environ, "PYTHONPATH": os.path.dirname(
        os.path.abspath(__file__))}
    t0 = time.perf_counter()
    sup = subprocess.Popen(
        [sys.executable, "-m", "unidisc_tpu_torch.training.supervisor",
         "--backoff-s", "1", "--log", log, "--", sys.executable, "-m",
         "unidisc_tpu_torch.train", *args], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    metrics = os.path.join(run, "metrics.jsonl")
    try:
        while time.perf_counter() - t0 < 300:
            if os.path.exists(metrics) and len(open(metrics).readlines()) \
                    >= SUP_SIGNAL_AFTER:
                break
            if sup.poll() is not None:
                break
            time.sleep(0.1)
        with open(log) as f:
            pid = json.loads(f.readline())["pid"]
        os.kill(pid, signal.SIGTERM)
        out = sup.communicate(timeout=400)[0].decode()
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.wait()
    with open(log) as f:
        events = [json.loads(line) for line in f]
    steps = CheckpointManager(os.path.join(run, "checkpoints")).all_steps()
    rec = {"events": [e["event"] for e in events], "exit_code":
           sup.returncode, "checkpoints": steps, "wall_s":
           time.perf_counter() - t0,
           "child_codes": [e.get("code") for e in events
                           if e["event"] == "restart"]}
    print("supervised " + json.dumps(rec))
    if (sup.returncode != 0 or rec["events"] != ["launch", "restart",
                                                 "launch", "clean_exit"]
            or rec["child_codes"] != [128 + signal.SIGTERM]
            or len(steps) != 2 or steps[-1] != SUP_STEPS
            or not SUP_SIGNAL_AFTER <= steps[0] < SUP_STEPS
            or "resumed from step" not in out):
        raise AssertionError(f"supervised run: {rec}\n{out[-3000:]}")
    shutil.rmtree(run, ignore_errors=True)
    return rec


def train_rest_line(rec) -> dict:
    """The train_rest and offload lines' numbers."""
    def line(r):
        return {"median_step_s": r["median_steady_step_s"],
                "train_tok_per_s": r["batch"] * 384
                / r["median_steady_step_s"],
                "peak_gb": r["peak_memory_bytes"] / 1e9}
    out = {"dropout_remat_dots": line(rec["dropout_fit"]),
           **{f"opt_{k}": line(v["run"])
              for k, v in rec["optimizers"].items()},
           "lora": line(rec["lora"]),
           "distill": {"median_step_s": rec["distill"]["median_step_s"],
                       "peak_gb": rec["distill"]["peak_memory_bytes"] / 1e9},
           "remat_grad_peak_gb": {k: v / 1e9 for k, v in
                                  rec["remat"]["peak_bytes"].items()},
           "remat_grad_s": rec["remat"]["grad_s"]}
    off = rec["offload"]
    offload = {"flagship": line(off["fit"]) | {
        "pcie_gb_per_step_each_way":
        off["fit"]["pcie_bytes_per_step_each_way"] / 1e9},
        "extra_large_params": off["extra_large_params"],
        **{f"extra_large_{k}": {
            "median_step_s": v["median_step_s"],
            "train_tok_per_s": v["train_tok_per_s"],
            "peak_gb": v["peak_memory_bytes"] / 1e9}
           for k, v in off["extra_large"].items()}}
    return out, offload


def phase_train_rest(seed, root, base_run) -> dict:
    """Phase 5d (module docstring)."""
    t0 = time.perf_counter()
    rec, part_s = {}, {}
    for key, fn, args in (("remat", phase_remat, (seed,)),
                          ("dropout_fit", phase_dropout_fit, (seed, root)),
                          ("optimizers", phase_optimizers, (seed, root)),
                          ("lora", phase_lora, (seed, root, base_run)),
                          ("distill", phase_distill, (seed, root, base_run)),
                          ("offload", phase_offload, (seed, root))):
        t = time.perf_counter()
        rec[key] = fn(*args)
        free()
        part_s[key] = time.perf_counter() - t
    rec["seconds"] = time.perf_counter() - t0
    rec["seconds_by_part"] = part_s
    rest, offload = train_rest_line(rec)
    card = card_line()
    print("train_rest " + json.dumps({"card": card,
                                      "seconds": rec["seconds"],
                                      "seconds_by_part": part_s, **rest}))
    print("offload " + json.dumps({"card": card, **offload}))
    paths = {"rest_dropout_remat_fit": rec["dropout_fit"],
             "rest_lora": rec["lora"], "lora_serve": rec["lora"]["served"],
             "rest_offload": rec["offload"]["fit"],
             "offload_serve": rec["offload"]["served"],
             "rest_distill": rec["distill"],
             "rest_adafactor_resumed": rec["optimizers"]["adafactor"][
                 "resumed"]}
    for name in OPTIMIZER_RUNS:
        paths[f"rest_{name}"] = rec["optimizers"][name]["run"]
    rec["paths"] = {k: {"launches": v["launches"]} for k, v in paths.items()}
    return rec


# ---------------------------------------------------------------------------
# 5e: interleaved documents end to end
# ---------------------------------------------------------------------------

IL_BATCH, IL_STEPS, IL_CKPT = 16, 20, 10
IL_DOCS, IL_SHARDS = 640, 4     # ~110 packed rows a shard, 7 batches
# the flagship with the interleaved experiment at L 1024: the rope table is
# 128 text rows and one 16 x 16 image block, indexed through rope_index
IL_OVERRIDES = {"model.length": 1024, "model.txt_length": 128,
                "model.img_length": 256, "trainer.interleaved": True,
                "trainer.multimodal_batches": True,
                "model.modality_embed": True, "model.rope_2d": True}
IL_EOS = 2
# the interleaved runs and their served run dir: 4 of the flagship's 12
# blocks (the packed kernels' case keeps the (16, 12, 1024, 64) shape)
IL_DEPTH = {"model.n_blocks": 4}
# the counted runs of phase 5e and 5f
INTERLEAVED_PATHS = ("interleaved_train", "interleaved_train_resumed",
                     "interleaved_serve")
SAMPLERS_LEFT_PATHS = tuple(f"caching_{r}_{kv}" for r in ("txt", "img")
                            for kv in ("bf16", "int8"))


def interleaved_docs(m, n, seed) -> list:
    """n documents from a seeded generator: 1-3 images of 256 tokens (a
    16 x 16 grid), each after a text span of 8-120 ids in the text
    vocabulary, sometimes a closing span. The ids follow per-document
    patterns (byte ids on a stride, image ids on an affine raster) that
    a model can learn in a few steps."""
    rng = np.random.RandomState(seed)
    docs = []
    for _ in range(n):
        segs = []
        for _ in range(rng.randint(1, 4)):
            t = rng.randint(8, 121)
            start, stride = rng.randint(0, 200), rng.randint(1, 4)
            segs.append(Segment("text", (4 + (start + stride * np.arange(t))
                                         % 200).astype(np.int32)))
            base = rng.randint(0, 1024)
            segs.append(Segment("image", (m.text_vocab_size + (
                base + 13 * np.arange(256)) % 1024).astype(np.int32), 16))
        if rng.rand() < 0.5:
            t = rng.randint(8, 121)
            segs.append(Segment("text", (4 + (7 + np.arange(t)) % 200)
                                .astype(np.int32)))
        docs.append(Document(segs))
    return docs


def phase_ishards(cfg, seed, root) -> dict:
    """(a) IL_DOCS documents written as IL_SHARDS ragged shards; each
    shard's documents packed at model.length with EOS 2 by the native
    packer, bit for bit as by the Python packer (host ms of each)."""
    m = cfg.model
    data = os.path.join(root, "ishards")
    docs = interleaved_docs(m, IL_DOCS, seed)
    per = IL_DOCS // IL_SHARDS
    for s in range(IL_SHARDS):
        write_interleaved_shard(data, docs[s * per:(s + 1) * per],
                                shard_index=s)
    rec = {"documents": IL_DOCS, "shards": IL_SHARDS, "rows": 0,
           "native_ms": 0.0, "python_ms": 0.0}
    for s in range(IL_SHARDS):
        back = docs_from_ishard(os.path.join(data, f"ishard-{s:05d}.npz"))
        packed = {}
        for name, pack in (("native", pack_documents_native),
                           ("python", pack_documents)):
            t0 = time.perf_counter()
            packed[name] = pack(back, m.length, pad_id=0, eos_id=IL_EOS)
            rec[f"{name}_ms"] += (time.perf_counter() - t0) * 1e3
        for k, v in packed["python"].items():
            if v.dtype != packed["native"][k].dtype or \
                    v.tobytes() != packed["native"][k].tobytes():
                raise AssertionError(f"ishard {s}: the native packer's {k} "
                                     f"differs from the Python packer's")
        rec["rows"] += packed["python"]["input_ids"].shape[0]
        rec.setdefault("padding_share", []).append(
            float((packed["python"]["sample_ids"] < 0).mean()))
    rec["dir"] = data
    print("interleaved_shards " + json.dumps(
        {k: v for k, v in rec.items() if k != "dir"}))
    return rec


def phase_interleaved_train(cfg, data, seed, root) -> tuple:
    """(b) train.main --stream over the ragged shards, IL_STEPS steps at
    batch IL_BATCH, checkpoint at IL_CKPT; a run resumed from that
    checkpoint alone logs the straight run's losses (1e-5 relative) and
    its loader reads the straight run's batches bit for bit; the
    fixed-draw loss of the stream's first batch falls. Returns (the
    record, the straight run's dir, its final EMA, the first batch)."""
    n_blocks = cfg.model.n_blocks
    straight = os.path.join(root, "il_a")
    args = cli_args(straight, data, IL_STEPS, IL_BATCH,
                    {**IL_OVERRIDES, **IL_DEPTH}, "--stream",
                    "--ckpt-every", str(IL_CKPT))
    rec = {}
    rec["straight"], final = train_cli_run("interleaved_train", args,
                                           IL_STEPS, n_blocks, falls=False)
    resumed = os.path.join(root, "il_b")
    shutil.copytree(os.path.join(straight, "checkpoints", str(IL_CKPT)),
                    os.path.join(resumed, "checkpoints", str(IL_CKPT)))
    rec["resumed"] = train_cli_run(
        "interleaved_train_resumed",
        cli_args(resumed, data, IL_STEPS, IL_BATCH,
                 {**IL_OVERRIDES, **IL_DEPTH}, "--stream"),
        IL_STEPS - IL_CKPT, n_blocks, falls=False)[0]
    want = rec["straight"]["losses"][IL_CKPT:]
    got = rec["resumed"]["losses"]
    for g, w in zip(got, want):
        if abs(g - w) > 1e-5 * abs(w):
            raise AssertionError(f"resumed interleaved losses {got} != "
                                 f"{want}")
    metas = [CheckpointManager(os.path.join(d, "checkpoints"))
             for d in (straight, resumed)]
    mid = metas[0].read_meta(IL_CKPT)["loader"]
    end = [mt.read_meta(IL_STEPS)["loader"] for mt in metas]
    if end[0] != end[1] or mid == end[0]:
        raise AssertionError(f"loader states: mid {mid}, ends {end}")
    reader = train_cli.make_loaders(cfg, IL_BATCH, data, stream=True)[0]
    batches = list(itertools.islice(iter(reader), IL_STEPS))
    again = train_cli.make_loaders(cfg, IL_BATCH, data, stream=True)[0]
    again.load_state_dict(mid)
    for want_b, got_b in zip(batches[IL_CKPT:], itertools.islice(
            iter(again), IL_STEPS - IL_CKPT)):
        for k in want_b:
            if want_b[k].tobytes() != got_b[k].tobytes():
                raise AssertionError(f"a resumed interleaved batch differs "
                                     f"({k})")
    if again.state_dict() != end[0]:
        raise AssertionError(f"replayed loader state {again.state_dict()} "
                             f"!= {end[0]}")
    rec.update(fixed_draw_batch_loss_falls("interleaved_train", cfg,
                                           batches[0], final.initial,
                                           final.params, seed))
    first = batches[0]
    rec.update({"mid_state": mid, "end_state": end[0],
                "batches_equal": True,
                "documents_per_row": float(np.mean([
                    len(np.unique(r[r >= 0])) for r in first["sample_ids"]])),
                "padding_share_first_batch": float(
                    (first["sample_ids"] < 0).mean())})
    shutil.rmtree(resumed, ignore_errors=True)
    return rec, straight, final.ema, first


def phase_packed_kernels(seg, seed) -> dict:
    """(c) flash_fwd (with the LSE), flash_bwd_dq and flash_bwd_dkv at the
    packed shape (B, 12, 1024, 64) with the batch's own sample ids (-1
    padding, documents ending mid-tile) against their plain versions:
    padded query rows give output 0, LSE 0 and gradient 0, padded keys
    gradient 0. Times as phase 3's, with the bound over the allowed pairs
    and SDPA with the equivalent boolean mask as the library call."""
    b, l = seg.shape
    shape = (b, 12, l, 64)
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    q, k, v, kw, mask = attention_inputs(shape, False, True, gen, seg=seg)
    out, lse = flash_attention(q, k, v, need_lse=True, **kw)
    ref, ref_lse = attention_reference(q, k, v, need_lse=True, **kw)
    torch.cuda.synchronize()
    pad = seg < 0
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    if err > OUT_TOL or lse_err > LSE_TOL or not bool(
            (out[pad] == 0).all()) or not bool(
            (lse.transpose(1, 2)[pad] == 0).all()):
        raise AssertionError(f"packed flash_fwd: max_abs_err {err}, "
                             f"lse_err {lse_err}, padded rows zero "
                             f"{bool((out[pad] == 0).all())}")

    def kernel():
        return flash_attention(q, k, v, **kw)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fwd_bound = attention_bound(shape, mask, True)
    rec = {"shape_bhld": list(shape), "padded_rows": int(pad.sum()),
           "documents": int(sum(len(torch.unique(r[r >= 0]))
                                for r in seg)),
           "flash_fwd": {
               "max_abs_err": err, "lse_err": lse_err, "ms": time_ms(kernel),
               "device_ms": device_ms(kernel), "host_us": host_us(kernel),
               "plain_ms": time_ms(lambda: attention_reference(q, k, v,
                                                               **kw),
                                   iters=5),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=mask)),
               "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1]}}
    do = torch.randn((b, l, 12, 64), generator=gen, device="cuda",
                     dtype=torch.float32).to(torch.bfloat16)
    o, lse = flash_attention(q, k, v, need_lse=True, **kw)
    grads, launch_dq, launch_dkv = bwd_launches(q, k, v, o, lse, do,
                                                kw["segment_ids"], False,
                                                64 ** -0.5)
    launch_dq()
    launch_dkv()
    want = attention_backward_reference(q.float(), k.float(), v.float(),
                                        o.float(), lse, do.float(), **kw)
    torch.cuda.synchronize()
    errs = {}
    for gname, g, r in zip(("dq", "dk", "dv"), grads, want):
        e = (g.float() - r).abs().max().item()
        top = r.abs().max().item()
        errs[gname] = e
        if not bool(torch.isfinite(g.float()).all()) or \
                e > BWD_REL_TOL * top or not bool((g[pad] == 0).all()):
            raise AssertionError(f"packed flash_bwd {gname}: max_abs_err "
                                 f"{e} (tol {BWD_REL_TOL} x {top}), padded "
                                 f"rows zero {bool((g[pad] == 0).all())}")
    bounds = backward_bounds(shape, mask, True)
    library = sdpa_backward_fn(q, k, v, do, mask)
    lib_ms = time_ms(library)
    plain_ms = time_ms(lambda: attention_backward_reference(
        q, k, v, o, lse, do, **kw), iters=5)
    for name, launch, gn in (("flash_bwd_dq", launch_dq, ("dq",)),
                             ("flash_bwd_dkv", launch_dkv, ("dk", "dv"))):
        rec[name] = {"max_abs_err": max(errs[g] for g in gn),
                     "ms": time_ms(launch), "device_ms": device_ms(launch),
                     "host_us": host_us(launch), "plain_ms": plain_ms,
                     "library_ms": lib_ms, **bounds[name]}
    rec["backward_bound_ms"] = bounds["backward"]["bound_ms"]
    print("interleaved_kernels " + json.dumps(rec))
    return rec


def interleaved_requests(m, seed) -> list:
    """The three documents of phase 5e(d): [given text, generated image];
    [given text, given image with its top-left quarter to regenerate, 32
    generated text tokens]; [given image, 32 generated text tokens]."""
    rng = np.random.RandomState(seed)
    side = 16 * 16                      # the VQ-16 codec's 256 px
    pixel_mask = np.zeros((side, side), bool)
    pixel_mask[:side // 2, :side // 2] = True
    img = [rng.randint(0, m.image_vocab_size, 256).tolist()
           for _ in range(2)]
    return [
        [{"kind": "text", "text": "a red cube on a wooden table"},
         {"kind": "image", "generate": True, "grid": 16}],
        [{"kind": "text", "text": "two cats on a sofa"},
         {"kind": "image", "ids": img[0],
          "pixel_mask": pixel_mask.tolist()},
         {"kind": "text", "generate": 32}],
        [{"kind": "image", "ids": img[1]},
         {"kind": "text", "generate": 32}]]


def phase_interleaved_serve(run_dir, final_ema, seed) -> dict:
    """(d) build_engine(checkpoint=) on the interleaved run dir (its
    weights the trainer's final EMA, bit for bit) with the flagship
    serving sampling and the VQ-16 codec, behind make_server: the three
    documents through the interleaved route, counted (flash_fwd once a
    block a forward); the same documents through run_interleaved give the
    same answer; given tokens unchanged, image slots hold image ids, text
    slots text ids, every image a 256-px PNG; the captured packed program
    equals the eager packed sampler under injected noise (GRAPH_STEPS
    steps)."""
    t0 = time.perf_counter()
    engine = build_engine(checkpoint=run_dir, overrides=SERVE_OVER,
                          codec_name=CODEC)
    build_s = time.perf_counter() - t0
    for name, value in engine.model.state_dict().items():
        if not torch.equal(value.cpu(), final_ema[name]):
            raise AssertionError(f"served {name} is not the final EMA")
    m = engine.m
    docs = interleaved_requests(m, seed)
    t0 = time.perf_counter()
    engine.run_interleaved(docs[0], seed=0)     # captures the program
    capture_s = time.perf_counter() - t0
    srv = make_server(engine, port=0)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    answers, latency = [], []
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        for i, doc in enumerate(docs):
            t0 = time.perf_counter()
            status, ctype, body = http(url, "/v1/chat/completions",
                                       {"segments": doc, "seed": 100 + i})
            latency.append(time.perf_counter() - t0)
            if status != 200 or ctype != "application/json":
                raise AssertionError(f"interleaved POST answered {status}")
            answers.append(json.loads(body))
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.shutdown()
    nfe = [a["usage"]["nfe"] for a in answers]
    check_launches("interleaved_serve", launches,
                   {"flash_fwd": m.n_blocks * sum(nfe)})
    for i, (doc, ans) in enumerate(zip(docs, answers)):
        direct = engine.run_interleaved(doc, seed=100 + i)
        layout = engine.interleaved_row(doc)
        row, tokens = layout["row"], direct["tokens"]
        if ans["object"] != "interleaved.completion" or \
                direct["nfe"] != ans["usage"]["nfe"]:
            raise AssertionError(f"document {i}: {ans['object']}, nfe "
                                 f"{direct['nfe']} vs {ans['usage']}")
        for got, want in zip(ans["segments"], direct["segments"]):
            same = got["text"] == want["text"] if got["kind"] == "text" \
                else (got["ids"] == [int(x) for x in want["ids"]]
                      and got.get("image_b64") == want.get("image_b64"))
            if not same:
                raise AssertionError(f"document {i}: the HTTP answer "
                                     f"differs from run_interleaved")
        given = row["unmask"]
        end = layout["spans"][-1][2]
        img = (row["modality"] == 1)[:end]
        if not (tokens[given] == row["x0"][given]).all():
            raise AssertionError(f"document {i}: a given token changed")
        if not ((tokens[:end][img] >= m.text_vocab_size)
                & (tokens[:end][img] < m.text_vocab_size
                   + m.image_vocab_size)).all():
            raise AssertionError(f"document {i}: an image slot holds a "
                                 f"non-image id")
        if not (tokens[:end][~img] < m.text_vocab_size).all():
            raise AssertionError(f"document {i}: a text slot holds a "
                                 f"non-text id")
        for seg in ans["segments"]:
            if seg["kind"] == "image" and decode_png(base64.b64decode(
                    seg["image_b64"])).shape != (256, 256, 3):
                raise AssertionError(f"document {i}: no 256-px PNG")
    # the captured packed program against the eager packed sampler
    sampler = build_sampler(engine.model, engine.config,
                            num_steps=GRAPH_STEPS, inject_noise=True,
                            packed=True)
    row = engine.interleaved_row(docs[1])["row"]
    args = [torch.from_numpy(row[k][None]).cuda() for k in
            ("x0", "unmask", "modality", "sample_ids", "rope_index")]
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    shape = (GRAPH_STEPS, 1, m.length)
    injected = {"exp": torch.empty(shape + (m.vocab_size,), device="cuda")
                .exponential_(generator=gen),
                "gumbel": -torch.log(-torch.log(torch.rand(
                    shape, generator=gen, device="cuda")))}
    want = sampler(*args, injected=injected)
    program = captured(sampler, 1)
    got = program(*args, injected=injected)
    torch.cuda.synchronize()
    if not torch.equal(got.tokens, want.tokens) or got.nfe != want.nfe:
        raise AssertionError("the captured packed program differs from the "
                             "eager packed sampler")
    rec = {"build_s": build_s, "capture_s": capture_s,
           "weights_equal_final_ema": True, "launches": launches,
           "nfe": nfe, "latency_s": latency,
           "document_tokens": [engine.interleaved_row(d)["spans"][-1][2]
                               for d in docs],
           "graph_vs_eager_equal": True, "graph_steps": GRAPH_STEPS,
           "texts": [[s["text"] for s in a["segments"]
                      if s["kind"] == "text"] for a in answers]}
    print("interleaved_serve " + json.dumps(rec))
    del program, sampler, injected
    free(engine)
    return rec


def phase_interleaved(seed, root, kernel_seed) -> dict:
    """Phase 5e (module docstring)."""
    t0 = time.perf_counter()
    cfg = train_config(**IL_OVERRIDES, **IL_DEPTH)
    rec = {"shards": phase_ishards(cfg, seed, root)}
    data = rec["shards"].pop("dir")
    rec["train"], run_dir, final_ema, first = phase_interleaved_train(
        cfg, data, seed, root)
    torch.cuda.empty_cache()
    rec["kernels"] = phase_packed_kernels(
        torch.from_numpy(first["sample_ids"]).cuda(), kernel_seed)
    free()
    rec["serve"] = phase_interleaved_serve(run_dir, final_ema, seed)
    shutil.rmtree(run_dir, ignore_errors=True)
    rec["interleaved_train"] = rec["train"]["straight"]
    rec["interleaved_train_resumed"] = rec["train"]["resumed"]
    rec["interleaved_serve"] = rec["serve"]
    rec["seconds"] = time.perf_counter() - t0
    tr = rec["train"]["straight"]
    print("interleaved " + json.dumps({
        "card": card_line(), "seconds": rec["seconds"],
        "train": {"batch": IL_BATCH, "length": cfg.model.length,
                  "median_step_s": tr["median_steady_step_s"],
                  "train_tok_per_s": IL_BATCH * cfg.model.length
                  / tr["median_steady_step_s"],
                  "peak_memory_bytes": tr["peak_memory_bytes"],
                  "fixed_draw_loss": [rec["train"][k] for k in (
                      "fixed_draw_loss_initial", "fixed_draw_loss_final")],
                  "resume_exact": rec["train"]["batches_equal"]},
        "pack_ms_native_python": [rec["shards"]["native_ms"],
                                  rec["shards"]["python_ms"]],
        "serve_latency_s": rec["serve"]["latency_s"],
        "kernels_ms": {k: rec["kernels"][k]["ms"] for k in TRAIN_KERNELS}}))
    return rec


# ---------------------------------------------------------------------------
# 5f: the samplers left
# ---------------------------------------------------------------------------

CACHING_BATCH, CACHING_RATIO = 4, 2
TRANSFUSION_STEPS, TRANSFUSION_LATENT = 8, 16
# the transfusion DDIM trajectory on the card against the CPU, both in
# fp32 (TF32 off): max abs error over the final latents at most this share
# of their largest magnitude (the products of 8 steps x 12 blocks are
# summed in other orders; each step feeds its latents back)
TRANSFUSION_REL_TOL = 1e-2


def phase_caching(seed) -> dict:
    """(a) the caching sampler at the flagship t2i layout (random weights
    from the seed, bf16, CFG 2.0), recompute txt and img, with the bf16 and
    the int8 KV cache: the captured program equals the eager sampler under
    injected noise (GRAPH_STEPS steps, ratio CACHING_RATIO), launches
    counted from the replay."""
    cfg = Config.make("small", **FLAGSHIP_OVERRIDES)
    model = DIT(cfg.model, torch.bfloat16, device="cuda", init=False).eval()
    randomize_(model, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    args, injected = sampler_inputs("generic", cfg.model, CACHING_BATCH,
                                    GRAPH_STEPS, gen)
    rec = {}
    for recompute in ("txt", "img"):
        for kv in ("bf16", "int8"):
            c = cfg.override(**{"model.kv_cache_dtype": kv})
            sample = build_caching_sampler(
                model, c, txt_to_img_ratio=CACHING_RATIO,
                num_steps=GRAPH_STEPS, recompute=recompute,
                inject_noise=True)
            _build.reset_launch_counts()
            want = sample(*args, injected=injected)
            torch.cuda.synchronize()
            eager_launches = dict(_build.launch_counts)
            program = captured(sample, CACHING_BATCH)
            _build.reset_launch_counts()
            got = program(*args, injected=injected)
            torch.cuda.synchronize()
            launches = dict(_build.launch_counts)
            name = f"caching_{recompute}_{kv}"
            if not torch.equal(got.tokens, want.tokens) or \
                    got.nfe != want.nfe or launches != eager_launches:
                raise AssertionError(f"{name}: captured != eager (nfe "
                                     f"{got.nfe} / {want.nfe}, launches "
                                     f"{launches} / {eager_launches})")
            rec[name] = {"nfe": got.nfe, "launches": launches,
                         "graph_build_s": program.build_s}
            del sample, program, want, got
            gc.collect()
    del model, injected
    torch.cuda.empty_cache()
    print("caching_graph_vs_eager " + json.dumps(rec))
    return rec


def phase_extras_cpu_vs_card(seed) -> dict:
    """(b) semi-AR (time-conditioned: each stride a captured program on
    the card; and without time conditioning: eager, one flag read a step),
    the analytic sampler and Tweedie best-of-N (reward_on tokens and
    tweedie_img) on the card against the CPU: a tiny fp32 model (plain
    attention), the same injected noise; token agreement at least 0.95 as
    the samplers' CPU check, and the same NFE."""
    rec = {}
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)

    def models(**extra):
        cfg = Config.make("tiny", **{**TINY_OVERRIDES,
                                     "model.attn_backend": "xla", **extra})
        gpu = DIT(cfg.model, compute_dtype=torch.float32).to("cuda").eval()
        randomize_(gpu, seed)
        cpu = DIT(cfg.model, compute_dtype=torch.float32).eval()
        cpu.load_state_dict({k: v.cpu() for k, v in
                             gpu.state_dict().items()})
        fwd = {dev: (lambda mdl: lambda x, s, mod: mdl(x, s, modality=mod))(
            mdl) for dev, mdl in (("cpu", cpu), ("cuda", gpu))}
        return cfg, fwd

    def agree(name, outs):
        a = float((outs["cpu"].tokens == outs["cuda"].tokens.cpu())
                  .float().mean().item())
        rec[name] = {"token_agreement": a,
                     "nfe": [outs["cpu"].nfe, outs["cuda"].nfe]}
        if a < 0.95 or outs["cpu"].nfe != outs["cuda"].nfe:
            raise AssertionError(f"{name}: the card disagrees with the CPU: "
                                 f"{rec[name]}")

    cfg, fwd = models()
    m, steps = cfg.model, cfg.sampling.steps
    (x0, unmask, modality), _ = sampler_inputs("generic", m, TINY_BATCH,
                                               steps, gen)
    exp = torch.empty((steps + 1, TINY_BATCH, m.length, m.vocab_size),
                      device="cuda").exponential_(generator=gen)
    agree("analytic", {dev: extras.build_analytic_sampler(
        fwd[dev], cfg, device=dev)(x0.to(dev), unmask.to(dev),
                                   modality.to(dev),
                                   injected={"exp": exp.to(dev)})
        for dev in ("cpu", "cuda")})
    n = 3
    exp = torch.empty((steps, n, TINY_BATCH, m.length, m.vocab_size),
                      device="cuda").exponential_(generator=gen)
    for reward_on in ("tokens", "tweedie_img"):
        agree(f"tweedie_{reward_on}", {dev: extras.build_tweedie_sampler(
            fwd[dev], cfg, lambda t: (t % 5 == 2).sum(-1).float(),
            n_candidates=n, reward_on=reward_on, device=dev)(
                x0.to(dev), unmask.to(dev), modality.to(dev),
                injected={"exp": exp.to(dev)}) for dev in ("cpu", "cuda")})
    stride, strides, per = 4, 2, 4
    for tc in (True, False):
        cfg, fwd = models(**{"model.time_conditioning": tc})
        exp = torch.empty((strides + 1, per + 1, TINY_BATCH, m.length,
                           m.vocab_size), device="cuda").exponential_(
                               generator=gen)
        outs = {}
        for dev in ("cpu", "cuda"):
            sampler = extras.build_semi_ar_sampler(
                fwd[dev], cfg, stride_length=stride, num_strides=strides,
                steps_per_stride=per, device=dev)
            outs[dev] = sampler(TINY_BATCH, modality.to(dev),
                                injected={"exp": exp.to(dev)})
            if dev == "cuda" and sampler.captured != tc:
                raise AssertionError("semi-AR: a time-conditioned stride "
                                     "must run captured, else eager")
        agree(f"semi_ar_{'captured' if tc else 'eager'}", outs)
    print("extras_cpu_vs_cuda " + json.dumps(rec))
    return rec


def phase_transfusion(seed) -> dict:
    """(c) TransfusionDIT at the flagship width and t2i layout (fp32,
    random weights from the seed, latent_dim 16), TRANSFUSION_STEPS DDIM
    steps from the same starting noise on the card and on the CPU: the
    final latents within TRANSFUSION_REL_TOL of their largest magnitude;
    zero off the image."""
    cfg = Config.make("small", **FLAGSHIP_OVERRIDES)
    m = cfg.model
    gpu = TransfusionDIT(m, latent_dim=TRANSFUSION_LATENT,
                         compute_dtype=torch.float32).to("cuda").eval()
    randomize_(gpu, seed)
    cpu = TransfusionDIT(m, latent_dim=TRANSFUSION_LATENT,
                         compute_dtype=torch.float32).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    gen = torch.Generator().manual_seed(seed + 23)
    ids = torch.randint(4, 200, (1, m.length), generator=gen)
    modality = (torch.arange(m.length) >= m.txt_length).long()[None]
    z0 = torch.randn((1, m.length, TRANSFUSION_LATENT), generator=gen)
    out, secs = {}, {}
    for dev, mdl in (("cuda", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        out[dev] = build_continuous_sampler(
            mdl, cfg, latent_dim=TRANSFUSION_LATENT,
            num_steps=TRANSFUSION_STEPS, device=dev)(
                ids, modality, z=z0.to(dev)).cpu()
        secs[dev] = time.perf_counter() - t0
    top = out["cpu"].abs().max().item()
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    rec = {"steps": TRANSFUSION_STEPS, "max_abs_err": err,
           "max_abs_latent": top, "rel_err": err / top,
           "rel_tol": TRANSFUSION_REL_TOL, "seconds": secs}
    print("transfusion_cpu_vs_cuda " + json.dumps(rec))
    if not torch.isfinite(out["cuda"]).all() or err > TRANSFUSION_REL_TOL \
            * top or (out["cuda"][:, :m.txt_length] != 0).any():
        raise AssertionError(f"transfusion: the card's DDIM trajectory "
                             f"disagrees with the CPU's: {rec}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return rec


def phase_samplers_left(seed) -> dict:
    """Phase 5f (module docstring)."""
    t0 = time.perf_counter()
    rec = {"caching": phase_caching(seed)}
    rec.update({name: rec["caching"][name] for name in SAMPLERS_LEFT_PATHS})
    rec["extras"] = phase_extras_cpu_vs_card(seed)
    rec["transfusion"] = phase_transfusion(seed)
    rec["seconds"] = time.perf_counter() - t0
    print("samplers_left " + json.dumps({"seconds": rec["seconds"]}))
    return rec


# ---------------------------------------------------------------------------
# 5g: the DIT variants (MoE, img_cond, split embedding, class labels) and
# the data tail (precompute, prefetch)
# ---------------------------------------------------------------------------

MOE_OVERRIDES = {"model.moe_experts": 8, "model.moe_top_k": 2,
                 "model.moe_capacity_factor": 1.25,
                 "trainer.moe_aux_weight": 0.01}
MOE_STEPS = 10
# the MoE run through train.main, its served run dir and its logits: the
# flagship's width, 4 of its 12 blocks (its host init and checkpoints are
# the phase's largest costs; the gradient check runs all 12)
MOE_RUN_DEPTH = {"model.n_blocks": 4}
MOE_IMAGES = 64        # procedural 256-px images, VQ-16-encoded on the card
# img_cond at the flagship width: 1D rope, no QK-norm or sandwich norm
# (validate() rules them out), the reference's 8 conditioning blocks over
# the VQ-16 ids of a 256-px conditioning image
IMG_COND_OVERRIDES = {"model.img_cond": True,
                      "model.cond_image_vocab_size": 16384,
                      "model.cond_length": 256, "model.n_cond_blocks": 8,
                      "model.qk_norm": False,
                      "model.sandwich_normalization": False,
                      "model.rope_2d": False}
IMG_COND_STEPS = 10
# the served MoE run dir: the flagship's sampling settings
SERVE_SAMPLING = {k: v for k, v in FLAGSHIP_OVERRIDES.items()
                  if k.startswith("sampling.") or k == "model.logits_dtype"}
# the card's MoE logits against the CPU's (fp32 on both sides, TF32 off,
# the attention's plain path on the card): the same function in another
# summation order, so routing differs only on near ties of fp32 router
# probabilities; bf16 through the kernels on the card as far from the
# CPU's fp32 as the plain path in bf16 on the card is, within 2x
MOE_FP32_REL, MOE_ROUTE_AGREE, MOE_FLIP_REL = 1e-4, 0.999, 1e-2
# the cross-attention and the trunk's self-attention at training shape:
# (case, q (B, H, Lq, D), Lk)
CROSS_CASES = [("img_cond_cross", (32, 12, 384, 64), 256),
               ("img_cond_trunk", (32, 12, 256, 64), 256)]
VARIANT_PATHS = ("moe_train", "moe_serve", "moe_serve_int8",
                 "img_cond_train", "img_cond_sample")


def moe_data(cfg, root) -> str:
    """MOE_IMAGES procedural 256-px images through the VQ-16 codec on the
    card and captions through the byte tokenizer, written by
    data/precompute.py as the model's [text | image] token shard."""
    from unidisc_tpu_torch.data.precompute import (precompute_tokens,
                                                   procedural_samples)
    from unidisc_tpu_torch.tokenizers.image_codecs import get_codec
    from unidisc_tpu_torch.tokenizers.text import get_tokenizer
    m = cfg.model
    codec = get_codec(CODEC, image_size=256)
    t0 = time.perf_counter()
    dirs = precompute_tokens(
        procedural_samples(MOE_IMAGES, 256), os.path.join(root, "moe_data"),
        tokenizer=get_tokenizer("byte"), codec=codec,
        txt_length=m.txt_length, text_vocab_size=m.text_vocab_size)
    seconds = time.perf_counter() - t0
    data = TokenShardDataset(dirs[0])
    ids = np.asarray(data.tokens)
    if (len(dirs) != 1 or ids.shape != (MOE_IMAGES, m.length)
            or ids[:, :m.txt_length].max() >= m.text_vocab_size
            or ids[:, m.txt_length:].min() < m.text_vocab_size
            or ids.max() >= m.vocab_size):
        raise AssertionError(f"precompute wrote {dirs}, rows {ids.shape}")
    print("moe_precompute " + json.dumps({"images": MOE_IMAGES,
                                          "seconds": seconds}))
    del codec
    free()
    return dirs[0]


def forward_logits(model, ids, sigma, modality, **kw) -> torch.Tensor:
    with torch.no_grad():
        return model(ids, sigma, modality=modality, **kw).float()


def moe_routes(model, ids, sigma, modality) -> list:
    """Each block's top-k experts (S, k) of one forward: the router's
    inputs captured by a hook."""
    from unidisc_tpu_torch.models.moe import route
    out = []

    def hook(mod, args):
        x = args[0]
        probs = torch.softmax(F.linear(x.reshape(-1, x.shape[-1]).float(),
                                       mod.router.weight.float()), -1)
        k = min(mod.cfg.moe_top_k, mod.cfg.moe_experts)
        out.append(route(probs, k, probs.shape[0])[1].cpu())
    hooks = [blk.moe.register_forward_pre_hook(hook) for blk in model.blocks]
    forward_logits(model, ids, sigma, modality)
    for h in hooks:
        h.remove()
    return out


def phase_moe_logits(cfg, weights, seed) -> dict:
    """The trained MoE model's final weights (the live ones: after 10
    steps the EMA is still close to the zero-initialised head) at full
    width on the card against the same model on the CPU, 2 rows at L 384:
    fp32 with the plain attention on both sides (logits within
    MOE_FP32_REL of the largest where every route agrees, routing
    agreement share >= MOE_ROUTE_AGREE), and the bf16 kernel path against
    the CPU's fp32 within twice the plain bf16 path's distance."""
    m = cfg.model
    gen = torch.Generator().manual_seed(seed)
    b = 2
    ids = torch.cat([torch.randint(0, m.mask_index, (b, m.txt_length),
                                   generator=gen),
                     torch.randint(m.text_vocab_size, m.vocab_size,
                                   (b, m.img_length), generator=gen)], 1)
    sigma = torch.rand((b,), generator=gen) * 2
    modality = (torch.arange(m.length) >= m.txt_length).long().expand(b, -1)
    models, logits, routes = {}, {}, {}
    for label, dev, dtype, backend in (
            ("cpu_fp32", "cpu", torch.float32, "xla"),
            ("card_fp32", "cuda", torch.float32, "xla"),
            ("card_bf16_plain", "cuda", torch.bfloat16, "xla"),
            ("card_bf16_kernel", "cuda", torch.bfloat16, "auto")):
        model = DIT(dataclasses.replace(m, attn_backend=backend,
                                              logits_dtype="float32"), dtype,
                    device=dev, init=False).eval()
        model.load_state_dict(weights)
        args = (ids.to(dev), sigma.to(dev), modality.to(dev))
        logits[label] = forward_logits(model, *args).cpu()
        routes[label] = moe_routes(model, *args)
        del model
    free()
    truth = logits["cpu_fp32"]
    top = truth.abs().max().item()

    def agree(label):
        return statistics.fmean(
            (a == w).float().mean().item()
            for a, w in zip(routes[label], routes["cpu_fp32"]))

    rel = {label: (logits[label] - truth).norm().item() / truth.norm().item()
           for label in logits if label != "cpu_fp32"}
    rec = {"rows": b, "length": m.length,
           "card_fp32_max_abs_err": (logits["card_fp32"] - truth).abs()
           .max().item(), "max_abs_logit": top,
           "rel_l2_err": rel,
           "routing_agreement": {label: agree(label) for label in routes
                                 if label != "cpu_fp32"},
           "fp32_tol_rel": MOE_FP32_REL, "route_tol": MOE_ROUTE_AGREE}
    print("moe_logits " + json.dumps(rec))
    # a flipped near tie moves its token's logits by O(1) and the others'
    # through attention: the max-abs bound holds where every route agrees,
    # else the relative L2 distance stays within MOE_FLIP_REL
    agree32 = rec["routing_agreement"]["card_fp32"]
    fp32_ok = agree32 >= MOE_ROUTE_AGREE and (
        rec["card_fp32_max_abs_err"] <= MOE_FP32_REL * top if agree32 == 1.0
        else rel["card_fp32"] <= MOE_FLIP_REL)
    if not fp32_ok or rel["card_bf16_kernel"] > 2 * rel["card_bf16_plain"]:
        raise AssertionError(f"the MoE logits on the card disagree with the "
                             f"CPU: {rec}")
    return rec


def phase_moe(seed, root) -> dict:
    """(a) and (b) of phase 5g: the MoE flagship trained from precomputed
    shards, its run dir served in bf16 and int8."""
    cfg = train_config(**MOE_OVERRIDES)
    rec, seconds = {}, {}
    t0 = time.perf_counter()
    data = moe_data(cfg, root)
    seconds["precompute"] = time.perf_counter() - t0
    rec["grad_check"] = phase_grad_check(cfg, TRAIN_BATCH, seed,
                                         label="moe_grad_check")
    free()
    seconds["grad_check"] = time.perf_counter() - t0 - sum(seconds.values())
    # the run, its served run dir and its logits at MOE_RUN_DEPTH
    run_over = {**MOE_OVERRIDES, **MOE_RUN_DEPTH}
    cfg = train_config(**run_over)
    m = cfg.model
    run_dir = os.path.join(root, "moe_run")
    rec["train"], keep = train_cli_run(
        "moe_train", cli_args(run_dir, data, MOE_STEPS, TRAIN_BATCH,
                              run_over, "--overfit"),
        MOE_STEPS, m.n_blocks)
    rec["train"]["tok_per_s"] = (TRAIN_BATCH * m.length
                                 / rec["train"]["median_steady_step_s"])
    rec["train"].update(fixed_draw_loss_falls("moe_train", cfg, data,
                                              keep, seed))
    # the balance auxiliary at the final parameters, on the overfit batch
    model = DIT(m, torch.bfloat16, device="cuda", init=False).eval()
    model.load_state_dict(keep.params)
    batch = next(WeightedDatasetSampler([TokenShardDataset(data)],
                                        batch_size=TRAIN_BATCH,
                                        seed=cfg.seed))
    with torch.no_grad():
        _, aux = model(torch.from_numpy(batch["input_ids"]).cuda(),
                       torch.full((TRAIN_BATCH,), 1.0, device="cuda"),
                       modality=torch.from_numpy(batch["modality"]).cuda(),
                       return_moe_aux=True)
    rec["train"]["final_aux"] = aux.item()
    rec["params"] = sum(v.numel() for v in keep.params.values())
    if not math.isfinite(rec["train"]["final_aux"]) or not (
            0 < rec["train"]["final_aux"] <= m.moe_experts * m.n_blocks):
        raise AssertionError(f"the MoE auxiliary is off: {aux.item()}")
    final = keep.params
    del model, keep
    free()
    seconds["train"] = time.perf_counter() - t0 - sum(seconds.values())
    print("moe_train_line " + json.dumps({
        "card": card_line(), "s_per_step": rec["train"][
            "median_steady_step_s"], "tok_per_s": rec["train"]["tok_per_s"],
        "peak_gb": rec["train"]["peak_memory_bytes"] / 1e9,
        "final_aux": rec["train"]["final_aux"]}))

    # (b) the run dir served: bf16, then int8 with quant_fused off
    for label, kw in (("moe_serve", {}),
                      ("moe_serve_int8", {"quantize": "int8"})):
        over = dict(SERVE_SAMPLING)
        if kw:
            over.update({"model.quant_backend": "pallas",
                         "model.quant_fused": False})
        engine = build_engine(checkpoint=run_dir, overrides=over, **kw)
        served = phase_serve(engine, t2i_requests(engine), label)
        if served["eager_same_seed_token_agreement"] != 1.0:
            raise AssertionError(f"{label}: the captured program differs "
                                 f"from the eager sampler at the same seed")
        rec[label] = served
        free(engine)
        del engine
        free()
        seconds[label] = time.perf_counter() - t0 - sum(seconds.values())
    rec["logits"] = phase_moe_logits(cfg, final, seed)
    seconds["logits"] = time.perf_counter() - t0 - sum(seconds.values())
    rec["seconds"] = seconds
    print("moe_seconds " + json.dumps(seconds))
    return rec


def img_cond_batch(cfg, seed) -> dict:
    """One training batch of the img_cond model: the structured synthetic
    rows of the seed, and x_cond ids drawn from the seed."""
    m = cfg.model
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(
        SyntheticDataLoader(cfg, TRAIN_BATCH, seed=seed)).items()
        if isinstance(v, np.ndarray)}
    gen = torch.Generator().manual_seed(seed + 11)
    batch["x_cond"] = torch.randint(0, m.cond_image_vocab_size,
                                    (TRAIN_BATCH, m.cond_length),
                                    generator=gen).cuda()
    return batch


def phase_img_cond(seed) -> dict:
    """(c) of phase 5g: one gradient of the img_cond model through the
    kernels against the plain path, 10 train steps on one batch with
    x_cond (counted), the fixed-draw loss falling, then 4-step maskgit
    samples through the closure over x_cond, captured = eager under
    injected noise for two conditions that give different tokens."""
    from unidisc_tpu_torch.sampling.sampler import ConditionedModel
    cfg = train_config(**IMG_COND_OVERRIDES)
    m = cfg.model
    batch = img_cond_batch(cfg, seed)
    rec = {"grad_check": phase_grad_check(
        cfg, TRAIN_BATCH, seed, label="img_cond_grad_check",
        extra={"x_cond": batch["x_cond"]})}
    free()
    model = DIT(m, torch.bfloat16, init=False)
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    model = model.cuda()
    init = {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}
    state = init_train_state(cfg, model)
    step = make_train_step(cfg, model)
    gen = torch.Generator(device="cuda")
    attentions = 2 * m.n_blocks + m.n_cond_blocks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses, times = [], []
    for i in range(IMG_COND_STEPS):
        gen.manual_seed(seed * 1000 + i)
        t0 = time.perf_counter()
        state, metrics = step(state, batch, generator=gen)
        losses.append(metrics.loss.item())
        times.append(time.perf_counter() - t0)
    launches = dict(_build.launch_counts)
    want = {name: attentions * IMG_COND_STEPS for name in TRAIN_KERNELS}
    if launches != want or not all(map(math.isfinite, losses)):
        raise AssertionError(f"img_cond training launched {launches} "
                             f"(expected {want}), losses {losses}")
    final = {k: v.detach().cpu().clone() for k, v in
             model.state_dict().items()}
    draws = fixed_draws(cfg, TRAIN_BATCH, seed, "cuda")
    apply_fn = make_apply_fn(cfg, model)
    fixed = []
    with torch.no_grad():
        for params in (init, final):
            model.load_state_dict(params)
            fixed.append(compute_batch_loss(cfg, apply_fn, None, batch,
                                            train=True, draws=draws)
                         .loss.item())
    rec["train"] = {"steps": IMG_COND_STEPS, "losses": losses,
                    "launches": launches, "attentions_per_step": attentions,
                    "median_step_s": statistics.median(times[2:]),
                    "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                    "fixed_draw_loss_initial": fixed[0],
                    "fixed_draw_loss_final": fixed[1]}
    print("img_cond_train " + json.dumps(rec["train"]))
    if not fixed[1] < fixed[0]:
        raise AssertionError(f"img_cond: the fixed-draw loss did not fall: "
                             f"{fixed}")
    del state, step
    free()

    # sampling through the closure: generic maskgit, no CFG (JAX's closure
    # carries x_cond for the batch's own rows)
    model.eval()
    scfg = cfg.override(**{"sampling.predictor": "maskgit",
                           "sampling.steps": GRAPH_STEPS,
                           "sampling.cfg": None})
    sgen = torch.Generator(device="cuda").manual_seed(seed + 5)
    args, injected = sampler_inputs("generic", m, REQUESTS, GRAPH_STEPS,
                                    sgen)
    conds = [batch["x_cond"][:REQUESTS],
             (batch["x_cond"][:REQUESTS] + 1) % m.cond_image_vocab_size]
    cond_model = ConditionedModel(model, conds[0])
    sample = build_sampler(cond_model, scfg, inject_noise=True)
    program = captured(sample, REQUESTS)
    # each replay counted on its own (counts to 0 just before, read just
    # after, before the eager comparison): every forward runs the trunk's
    # and each main block's self- and cross-attention
    tokens, launches = [], collections.Counter()
    for cond in conds:
        cond_model.set_condition(cond)
        _build.reset_launch_counts()
        got = program(*args, injected=injected)
        torch.cuda.synchronize()
        replay = dict(_build.launch_counts)
        want = {"flash_fwd": got.nfe * attentions}
        if replay != want:
            raise AssertionError(f"img_cond_sample: a replay launched "
                                 f"{replay}, expected {want}")
        launches += collections.Counter(replay)
        want_t = sample(*args, injected=injected)
        if not torch.equal(got.tokens, want_t.tokens) \
                or got.nfe != want_t.nfe:
            raise AssertionError("img_cond: the captured program differs "
                                 "from the eager sampler")
        tokens.append(got.tokens)
    differ = (tokens[0] != tokens[1]).float().mean().item()
    rec["sample"] = {"batch": REQUESTS, "steps": GRAPH_STEPS,
                     "nfe": got.nfe, "replays": len(conds),
                     "captured_equals_eager": True,
                     "share_differing_between_conditions": differ,
                     "graph_build_s": program.build_s,
                     "launches": dict(launches),
                     "expected_launches_per_replay": want}
    print("img_cond_sample " + json.dumps(rec["sample"]))
    if differ == 0.0:
        raise AssertionError("img_cond: two conditions gave the same tokens")
    del program, sample, cond_model, model, injected
    free()
    return rec


def phase_cross_kernels(seed) -> list:
    """(d) of phase 5g: flash_fwd (with the LSE), flash_bwd_dq and
    flash_bwd_dkv at the img_cond shapes against their plain versions,
    timed beside the bound and SDPA."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    rows = []
    for name, shape, lk in CROSS_CASES:
        b, h, lq, d = shape
        q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for n in (lq, lk, lk))
        do = torch.randn((b, lq, h, d), generator=gen,
                         device="cuda").to(torch.bfloat16)
        out, lse = flash_attention(q, k, v, need_lse=True)
        ref, ref_lse = attention_reference(q, k, v, need_lse=True)
        grads, launch_dq, launch_dkv = bwd_launches(q, k, v, out, lse, do,
                                                    None, False, d ** -0.5)
        launch_dq()
        launch_dkv()
        gref = attention_backward_reference(q.float(), k.float(), v.float(),
                                            out.float(), lse, do.float())
        torch.cuda.synchronize()
        errs = {"o": (out.float() - ref.float()).abs().max().item(),
                "lse": (lse - ref_lse).abs().max().item()}
        for gname, g, r in zip(("dq", "dk", "dv"), grads, gref):
            errs[gname] = (g.float() - r).abs().max().item()
            errs[gname + "_ref_max"] = r.abs().max().item()
        bad = (errs["o"] > OUT_TOL or errs["lse"] > LSE_TOL or any(
            errs[g] > BWD_REL_TOL * errs[g + "_ref_max"]
            for g in ("dq", "dk", "dv")))
        if bad:
            raise AssertionError(f"attention kernels disagree with their "
                                 f"plain versions at {name}: {errs}")
        act_q, act_k = b * lq * h * d * 2, b * lk * h * d * 2
        pairs, rows_lse = b * h * lq * lk, b * h * lq * 4

        def bound(nbytes, flops_per_pair):
            flops = flops_per_pair * d * pairs
            tb, to = nbytes / HBM_BYTES_PER_S * 1e3, \
                flops / BF16_FLOP_PER_S * 1e3
            return {"bound_ms": max(tb, to),
                    "bound_by": "bytes" if tb >= to else "operations"}

        def fwd():
            return flash_attention(q, k, v, need_lse=True)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt)
        library_bwd = sdpa_backward_fn(q, k, v, do, None)
        row = {"case": name, "shape_bhld": list(shape), "lk": lk,
               "errors": errs, "tol": {"o": OUT_TOL, "lse": LSE_TOL,
                                       "bwd_rel": BWD_REL_TOL},
               "fwd": {"ms": time_ms(fwd), "device_ms": device_ms(fwd),
                       "plain_ms": time_ms(lambda: attention_reference(
                           q, k, v, need_lse=True), iters=5),
                       "library_ms": time_ms(sdpa),
                       "library_device_ms": device_ms(sdpa),
                       # q, k, v, o, lse moved once; 4 D flops a pair
                       **bound(2 * act_q + 2 * act_k + rows_lse, 4)},
               "dq": {"ms": time_ms(launch_dq),
                      "device_ms": device_ms(launch_dq),
                      # q, k, v, o, dO, lse read; dq, di written
                      **bound(4 * act_q + 2 * act_k + 2 * rows_lse, 6)},
               "dkv": {"ms": time_ms(launch_dkv),
                       "device_ms": device_ms(launch_dkv),
                       # q, k, v, dO, lse, di read; dk, dv written
                       **bound(2 * act_q + 4 * act_k + 2 * rows_lse, 8)},
               "backward_plain_ms": time_ms(
                   lambda: attention_backward_reference(q, k, v, out, lse,
                                                        do), iters=5),
               "backward_library_ms": time_ms(library_bwd),
               "backward_library_device_ms": device_ms(library_bwd)}
        rows.append(row)
        print("kernel img_cond " + json.dumps(row))
        del q, k, v, do, out, lse, grads, gref
    free()
    return rows


def phase_variant_forwards(seed) -> dict:
    """(e) of phase 5g: the split_embed (img_embed_dim 8) and cond_label
    (no time conditioning) flagships, forward only, through the kernels in
    bf16 against the plain path in fp32 on the card, within twice the
    plain bf16 path's distance (labels include 1000, the null slot)."""
    rec = {}
    b = REQUESTS
    for name, over in (("split_embed", {"model.split_embed": True,
                                        "model.img_embed_dim": 8}),
                       ("cond_label", {"model.cond_label": True,
                                       "model.time_conditioning": False})):
        cfg = Config.make("small", **{**FLAGSHIP_OVERRIDES, **over})
        m = cfg.model
        gen = torch.Generator(device="cuda").manual_seed(seed + 31)
        ids = torch.cat([torch.randint(0, m.mask_index, (b, m.txt_length),
                                       generator=gen, device="cuda"),
                         torch.randint(m.text_vocab_size, m.vocab_size,
                                       (b, m.img_length), generator=gen,
                                       device="cuda")], 1)
        ids[:, ::7] = m.mask_index
        sigma = torch.rand((b,), generator=gen, device="cuda")
        modality = (torch.arange(m.length, device="cuda")
                    >= m.txt_length).long().expand(b, -1)
        kw = {}
        if m.cond_label:     # 1000: the CFG null slot
            kw["label"] = torch.tensor([0, 1, 500, 999, 1000, 1000, 7, 3],
                                       device="cuda")[:b]
        state, out = None, {}
        _build.reset_launch_counts()
        for label, backend, dtype in (("kernel_bf16", "auto",
                                       torch.bfloat16),
                                      ("plain_bf16", "xla", torch.bfloat16),
                                      ("plain_fp32", "xla", torch.float32)):
            model = DIT(dataclasses.replace(m, attn_backend=backend,
                                                  logits_dtype="float32"),
                        dtype, device="cuda", init=False).eval()
            if state is None:
                randomize_(model, seed)
                state = model.state_dict()
            else:
                model.load_state_dict(state)
            out[label] = forward_logits(model, ids, sigma, modality, **kw)
            if label == "kernel_bf16":
                launches = dict(_build.launch_counts)
            del model
        truth = out["plain_fp32"]
        rel = {k: (out[k] - truth).norm().item() / truth.norm().item()
               for k in ("kernel_bf16", "plain_bf16")}
        rec[name] = {"rows": b, "rel_l2_err_vs_plain_fp32": rel,
                     "launches": launches}
        print(f"variant_forward_{name} " + json.dumps(rec[name]))
        if (launches != {"flash_fwd": m.n_blocks}
                or rel["kernel_bf16"] > 2 * rel["plain_bf16"]):
            raise AssertionError(f"{name}: the forward through the kernels "
                                 f"is off: {rec[name]}")
        del out, state
        free()
    return rec


def phase_prefetch(data, seed) -> dict:
    """(f) of phase 5g: DevicePrefetcher over the precomputed shard: its
    batches on the card equal the loader's, and a loader restored from
    its state after 2 batches gives batch 3."""
    from unidisc_tpu_torch.data.prefetch import DevicePrefetcher

    def loader():
        return WeightedDatasetSampler([TokenShardDataset(data)],
                                      batch_size=TRAIN_BATCH, seed=seed)
    straight = list(itertools.islice(loader(), 4))
    pf = DevicePrefetcher(loader(), depth=2)
    for i in range(2):
        got = next(pf)
        for k, v in straight[i].items():
            if isinstance(v, np.ndarray):
                if got[k].device.type != "cuda" or not np.array_equal(
                        got[k].cpu().numpy(), v):
                    raise AssertionError(f"prefetched batch {i} differs ({k})")
    state = pf.state_dict()
    pf.close()
    again = DevicePrefetcher(loader(), depth=2)
    again.load_state_dict(state)
    got = next(again)
    again.close()
    if not np.array_equal(got["input_ids"].cpu().numpy(),
                          straight[2]["input_ids"]):
        raise AssertionError("a resumed prefetcher did not give batch 3")
    rec = {"batches_on_card_equal": True, "resumed_exactly": True,
           "state": state}
    print("prefetch " + json.dumps(rec))
    return rec


def phase_variants(seed, root) -> dict:
    """Phase 5g (module docstring)."""
    t0 = time.perf_counter()
    rec = {"moe": phase_moe(seed, root)}
    free()
    rec["prefetch"] = phase_prefetch(os.path.join(
        root, "moe_data", "shard_00000"), seed)
    rec["img_cond"] = phase_img_cond(seed)
    free()
    rec["kernels"] = phase_cross_kernels(seed)
    rec["forwards"] = phase_variant_forwards(seed)
    rec["moe_train"] = rec["moe"]["train"]
    rec["moe_serve"] = rec["moe"]["moe_serve"]
    rec["moe_serve_int8"] = rec["moe"]["moe_serve_int8"]
    rec["img_cond_train"] = rec["img_cond"]["train"]
    rec["img_cond_sample"] = rec["img_cond"]["sample"]
    rec["seconds"] = time.perf_counter() - t0
    moe = rec["moe"]
    print("variants " + json.dumps({
        "card": card_line(), "seconds": rec["seconds"],
        "moe_params": moe["params"],
        "moe_s_per_step": moe["train"]["median_steady_step_s"],
        "moe_tok_per_s": moe["train"]["tok_per_s"],
        "moe_peak_gb": moe["train"]["peak_memory_bytes"] / 1e9,
        "moe_served_tok_per_s": {
            q: moe[q]["steady_tok_per_s"] for q in ("moe_serve",
                                                    "moe_serve_int8")},
        "moe_routing_agreement": moe["logits"]["routing_agreement"],
        "img_cond_s_per_step": rec["img_cond"]["train"]["median_step_s"],
        "img_cond_peak_gb": rec["img_cond"]["train"][
            "peak_memory_bytes"] / 1e9,
        "kernel_device_ms": {
            r["case"]: {p: r[p]["device_ms"] for p in ("fwd", "dq", "dkv")}
            for r in rec["kernels"]}}))
    return rec


# ---------------------------------------------------------------------------
# 5h: the device mesh
# ---------------------------------------------------------------------------

MESH_RANKS = 4
MESH_RING_SHAPE = (2, 8192, 12, 64)   # B, L, H, D: Lc 2048 on each rank
MESH_RING_BWD_SHAPE = (2, 1024, 4, 64)  # small enough for fp32 scores
# the ring against one kernel pass: each rounds an fp32 result to bf16,
# the ring its blocks' outputs too before it merges them in fp32, so an
# element differs by about a bf16 ulp of the larger of its blocks'
# outputs, which where they cancel is many ulps of the element (on the
# H100 a packed element exceeded 2^-6 |ref| + 2^-11). The outputs are small
# (unit-normal q, k, v: an element ~N(0, e / L), ~0.02 at full
# attention), so the gate is relative: the error's RMS within
# MESH_RING_RMS_TOL (one bf16 ulp) of the output's, and no element off by
# more than MESH_RING_MAX_TOL (two ulps) of the case's largest output. Two
# wrong rings (a block dropped, the blocks merged unweighted) are read
# against it on rank 0 and must fail it
MESH_RING_RMS_TOL, MESH_RING_MAX_TOL = 2 ** -7, 2 ** -6
MESH_BLOCK_SHAPES = ((2, 2048, 12, 64), (16, 256, 12, 64))  # B, Lc, H, D
MESH_TRAIN_BATCH, MESH_TRAIN_STEPS, MESH_TRAIN_BLOCKS = 16, 2, 2
MESH_SERVE_STEPS, MESH_SERVE_BLOCKS = 2, 4
# the mesh step against the one-rank step: bf16 compute, the attention a
# ring of four blocks against one pass. The losses agreed to one fp32 ulp
# (7e-8 relative) in the sound runs; the update's cosine read 0.9945
MESH_LOSS_RTOL, MESH_UPDATE_COSINE = 1e-5, 0.99
# bf16 through the kernel ring against one pass: a 1-ulp difference in an
# attention output flips a near-tie token now and then (the sound runs:
# the sampler 98.93%, the engine 98.49%); in fp32 through the plain ring
# (the kernel takes bf16) the tokens must be equal
MESH_TOKEN_AGREEMENT = 0.98
MESH_PATHS = ("mesh_ring", "mesh_train", "mesh_serve")


def mesh_train_config() -> Config:
    """The flagship at L 1024 with packed rows (phase 5e's settings),
    depth cut to MESH_TRAIN_BLOCKS."""
    return train_config(**IL_OVERRIDES,
                        **{"model.n_blocks": MESH_TRAIN_BLOCKS})


def mesh_packed_batch(cfg, seed) -> dict:
    docs = interleaved_docs(cfg.model, 3 * MESH_TRAIN_BATCH, seed)
    packed = pack_documents(docs, cfg.model.length, pad_id=0,
                            eos_id=IL_EOS, batch_size=MESH_TRAIN_BATCH)
    return {k: np.asarray(v) for k, v in dict(packed).items()}


MESH_SERVE_OVERRIDES = {**FLAGSHIP_OVERRIDES,
                        "sampling.steps": MESH_SERVE_STEPS,
                        "model.n_blocks": MESH_SERVE_BLOCKS}


def mesh_serve_config(plain: bool = False) -> Config:
    """The served flagship at depth MESH_SERVE_BLOCKS; `plain`: its
    attention (and the ring) the plain version, for fp32."""
    return Config.make("small", **MESH_SERVE_OVERRIDES, **(
        {"model.attn_backend": "xla"} if plain else {}))


def mesh_serve_inputs(cfg, seed):
    """REQUESTS text prompts and the t2i sampler's injected Gumbel noise,
    drawn from `seed` with numpy: the same on every rank and in the
    one-rank reference. Read only (each caller copies them to the card),
    so a process draws the arrays of one shape once."""
    m = cfg.model
    return _mesh_serve_draws(cfg.sampling.steps, m.txt_length, m.img_length,
                             m.text_vocab_size, m.image_vocab_size, seed)


@functools.lru_cache(maxsize=2)
def _mesh_serve_draws(steps, txt_length, img_length, text_vocab_size,
                      image_vocab_size, seed):
    rng = np.random.RandomState(seed)
    txt = rng.randint(0, text_vocab_size - 1,
                      (REQUESTS, txt_length)).astype(np.int64)
    injected = {"gumbel_tok": rng.gumbel(size=(
        steps, REQUESTS, img_length, image_vocab_size)
    ).astype(np.float32), "gumbel_conf": rng.gumbel(size=(
        steps, REQUESTS, img_length)).astype(np.float32)}
    return txt, injected


def mesh_ring_ids(b, l) -> torch.Tensor:
    """A packed batch's ids: documents across the chunk edges, then -1."""
    ids = torch.full((b, l), -1, dtype=torch.int32)
    ids[0, :3000], ids[0, 3000:5000], ids[0, 5000:7900] = 0, 1, 2
    ids[1, :1000], ids[1, 1000:8100] = 0, 1
    return ids


def mesh_ring_check(rank, world, seed) -> dict:
    """The ring op over the world at MESH_RING_SHAPE, causal, full and
    packed, gathered and held on rank 0 to one flash_attention over the
    whole sequence; counts per rank."""
    from unidisc_tpu_torch.parallel.comm import all_gather
    from unidisc_tpu_torch.parallel.ring_attention import (
        ring_attention_flash, ring_flash_blocks)
    b, l, h, d = MESH_RING_SHAPE
    lc = l // world
    sl = slice(rank * lc, (rank + 1) * lc)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(MESH_RING_SHAPE, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    ids = mesh_ring_ids(b, l).cuda()
    rec = {"launches": collections.Counter(), "cases": {}}
    for name, causal, segs in (("full", False, None),
                               ("causal", True, None),
                               ("packed", False, ids),
                               ("packed_causal", True, ids)):
        mine = None if segs is None else segs[:, sl].contiguous()
        _build.reset_launch_counts()
        with torch.no_grad():
            out = ring_attention_flash(q[:, sl], k[:, sl], v[:, sl], mine,
                                       group=None, causal=causal)
        torch.cuda.synchronize()
        n = _build.launch_counts["flash_fwd"]
        want = ring_flash_blocks(world, rank, causal)
        if n != want:
            raise AssertionError(f"mesh ring {name}: rank {rank} launched "
                                 f"flash_fwd {n} times, the code {want}")
        rec["launches"]["flash_fwd"] += n
        full = all_gather(out, None, dim=1)
        if rank == 0:
            with torch.no_grad():
                ref = flash_attention(
                    q, k, v, causal=causal,
                    segment_ids=None if segs is None else (segs, segs))
            gate = ring_gate(full, ref)
            if not gate["use"] <= 1:
                raise AssertionError(f"mesh ring {name}: {gate} over the "
                                     f"gate (RMS {MESH_RING_RMS_TOL}, max "
                                     f"{MESH_RING_MAX_TOL} x max |ref|)")
            rec["cases"][name] = {**gate, "launches_rank0": n}
            if name == "full":
                rec["wrong_rings"] = wrong_ring_uses(q, k, v, ref, world)
        del out, full
    _build.reset_launch_counts()
    return rec


def ring_gate(got, ref) -> dict:
    """The ring's readings against one pass: the error's RMS relative to
    the output's, the largest error and output, and the share of the
    gate used (the larger of the two ratios; the gate holds at <= 1)."""
    ref = ref.float()
    err = got.float() - ref
    rel_rms = float(err.norm() / ref.norm())
    max_err, max_ref = float(err.abs().max()), float(ref.abs().max())
    return {"rel_rms_err": rel_rms, "max_abs_err": max_err,
            "max_abs_ref": max_ref,
            "use": max(rel_rms / MESH_RING_RMS_TOL,
                       max_err / (MESH_RING_MAX_TOL * max_ref))}


def wrong_ring_uses(q, k, v, ref, world) -> dict:
    """Full attention as two wrong rings of `world` blocks would give it,
    read against the gate (each must fail it): the last block dropped from
    every row, and the blocks' outputs averaged without their LSE
    weights. Comparison launches: not counted."""
    lc = q.shape[1] // world
    with torch.no_grad():
        dropped = flash_attention(q, k[:, :-lc], v[:, :-lc])
        unweighted = sum(flash_attention(q, k[:, i * lc:(i + 1) * lc],
                                         v[:, i * lc:(i + 1) * lc]).float()
                         for i in range(world)) / world
    reads = {"block_dropped": ring_gate(dropped, ref),
             "merged_unweighted": ring_gate(unweighted, ref)}
    for name, gate in reads.items():
        if not gate["use"] > 1:
            raise AssertionError(f"mesh ring: a wrong ring ({name}) passes "
                                 f"the gate ({gate})")
    return reads


def mesh_ring_bwd_check(rank, world, seed) -> dict:
    """The ring's gradient (the plain ring recomputed) on a packed causal
    slice, gathered and held on rank 0 to fp32 attention's."""
    from unidisc_tpu_torch.parallel.comm import all_gather
    from unidisc_tpu_torch.parallel.ring_attention import \
        ring_attention_flash
    b, l, h, d = MESH_RING_BWD_SHAPE
    lc = l // world
    sl = slice(rank * lc, (rank + 1) * lc)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    q, k, v, g = (torch.randn(MESH_RING_BWD_SHAPE, generator=gen,
                              device="cuda", dtype=torch.bfloat16)
                  for _ in range(4))
    ids = torch.full((b, l), -1, dtype=torch.int32, device="cuda")
    ids[0, :400], ids[0, 400:1000] = 0, 1
    ids[1, :700], ids[1, 700:1020] = 0, 1
    mine = [x[:, sl].clone().requires_grad_() for x in (q, k, v)]
    out = ring_attention_flash(*mine, ids[:, sl].contiguous(), group=None,
                               causal=True)
    out.backward(g[:, sl])
    grads = [all_gather(x.grad, None, dim=1) for x in mine]
    rec = {}
    if rank == 0:
        ref = [x.float().requires_grad_() for x in (q, k, v)]
        attention_reference(*ref, segment_ids=(ids, ids),
                            causal=True).backward(g.float())
        for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
            scale = float(want.grad.abs().max())
            err = float((got.float() - want.grad).abs().max())
            if not err <= BWD_REL_TOL * scale:
                raise AssertionError(f"mesh ring backward {name}: max abs "
                                     f"error {err} > {BWD_REL_TOL} x {scale}")
            rec[name] = {"max_abs_err": err, "max_abs": scale}
    return rec


def mesh_train_rank(rank, world, seed) -> dict:
    """MESH_TRAIN_STEPS seq-parallel steps (seq = world) of the flagship
    width on the packed batch; rank 0's record holds its parameters."""
    from unidisc_tpu_torch.parallel.mesh import make_mesh
    from unidisc_tpu_torch.training.train_state import shard_train_step
    cfg = mesh_train_config()
    cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
        cfg.mesh, dcn=1, fsdp=1, seq=world))
    model = DIT(cfg.model, compute_dtype=torch.bfloat16, init=False)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.cuda()
    step, state, _ = shard_train_step(cfg, model, make_mesh(cfg.mesh))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in mesh_packed_batch(cfg, seed).items()}
    gen = torch.Generator(device="cuda")
    losses, norms = [], []
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(MESH_TRAIN_STEPS):
        gen.manual_seed(seed + i)
        state, m = step(state, batch, generator=gen)
        losses.append(float(m.loss))
        norms.append(float(m.grad_norm))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    # each forward: one ring a block, every block of the ring (full
    # attention); the backward recomputes the plain ring, no kernel
    want = {"flash_fwd": MESH_TRAIN_STEPS * cfg.model.n_blocks * world}
    if launches != want:
        raise AssertionError(f"mesh train: rank {rank} launches {launches}, "
                             f"the code {want}")
    params = {n: p.detach().cpu() for n, p in state.params.items()} \
        if rank == 0 else None
    return {"losses": losses, "grad_norms": norms, "launches": launches,
            "seconds": secs, "params": params}


def mesh_serve_rank(rank, world, seed) -> dict:
    """The flagship (depth MESH_SERVE_BLOCKS) on a dp 2 x seq 2 mesh: the
    t2i sampler under spmd_sampler with injected noise, in fp32 through
    the plain ring and in bf16 through the kernel ring, and
    build_engine(mesh=) serving REQUESTS t2i requests; each run's launches
    held to the code's count."""
    from unidisc_tpu_torch.parallel.mesh import MeshLayout, make_mesh
    from unidisc_tpu_torch.parallel.sample import spmd_sampler
    from unidisc_tpu_torch.sampling.t2i_fast import build_t2i_sampler
    spec = dict(dcn=1, fsdp=world // 2, seq=2)
    rec = {"launches": collections.Counter()}

    def launched(name, cfg, nfe, kernel):
        torch.cuda.synchronize()
        got = dict(_build.launch_counts)
        # a forward at the rank's rows: a ring of 2 blocks an attention
        per = expected_serve_launches(cfg.model, cfg.sampling, nfe)
        want = {"flash_fwd": 2 * per["flash_fwd"]} if kernel else {}
        if got != want:
            raise AssertionError(f"mesh serve {name}: rank {rank} launches "
                                 f"{got}, the code {want}")
        rec["launches"].update(got)

    for name, plain, dtype in (("fp32", True, torch.float32),
                               ("bf16", False, torch.bfloat16)):
        cfg = mesh_serve_config(plain)
        layout = MeshLayout.of(make_mesh(dataclasses.replace(cfg.mesh,
                                                             **spec)))
        model = DIT(cfg.model, compute_dtype=dtype, init=False)
        randomize_(model, seed)
        model.cuda().eval()
        txt, injected = mesh_serve_inputs(cfg, seed)
        sample = spmd_sampler(build_t2i_sampler(model, cfg,
                                                inject_noise=True),
                              cfg, layout)
        _build.reset_launch_counts()
        out = sample(torch.from_numpy(txt).cuda(),
                     injected={k: torch.from_numpy(v).cuda()
                               for k, v in injected.items()})
        launched(name, cfg, out.nfe, kernel=not plain)
        rec[name] = out.tokens.cpu().numpy()
        del model, sample
    engine = build_engine(preset="small", overrides=MESH_SERVE_OVERRIDES,
                          mesh=",".join(f"{k}={v}" for k, v in spec.items()))
    randomize_(engine.model, seed)
    prepared = t2i_requests(engine)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.run_batch(prepared, seed=seed)
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    launched("engine", engine.config, results[0]["nfe"], kernel=True)
    ids = np.stack([r["image_ids"][0] for r in results])
    if ids.shape != (REQUESTS, engine.m.img_length) or ids.min() < 0 or \
            ids.max() >= engine.m.image_vocab_size:
        raise AssertionError(f"mesh serve: image ids {ids.shape} out of "
                             f"range")
    return {**rec, "launches": dict(rec["launches"]), "engine_ids": ids,
            "engine_batch_s": served_s, "dp_size": engine.mesh.dp_size}


def mesh_rank_work(rank, world, seed) -> dict:
    """Phase 5h's work on one rank of a started world: the ring, its
    gradient, the seq-parallel steps (rank 0's parameters in its record)
    and the served mesh."""
    rec = {"ring": mesh_ring_check(rank, world, seed),
           "ring_bwd": mesh_ring_bwd_check(rank, world, seed)}
    free()
    rec["train"] = mesh_train_rank(rank, world, seed)
    free()
    rec["serve"] = mesh_serve_rank(rank, world, seed)
    return rec


MESH_TIMEOUT_S = 400


def ring_block_cases(seed) -> list:
    """_flash_block's kernel alone, one rank: flash_attention with the LSE
    at the ring's block shapes, against its plain version, timed beside
    the bound, the plain version and the flash SDPA entry that returns the
    LSE (aten._scaled_dot_product_flash_attention)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    rows = []
    for b, lc, h, d in MESH_BLOCK_SHAPES:
        q, k, v = (torch.randn((b, lc, h, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        out, lse = flash_attention(q, k, v, need_lse=True)
        ref, ref_lse = attention_reference(q.float(), k.float(), v.float(),
                                           need_lse=True)
        err = float((out.float() - ref).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        if not (err <= OUT_TOL and lse_err <= LSE_TOL):
            raise AssertionError(f"ring block {(b, lc, h, d)}: errors "
                                 f"{err}, lse {lse_err}")
        del ref, ref_lse
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = torch.ops.aten._scaled_dot_product_flash_attention

        def kernel():
            return flash_attention(q, k, v, need_lse=True)
        bound, by, nbytes, flops = attention_bound((b, h, lc, d), None,
                                                   False)
        nbytes += b * h * lc * 4                    # the LSE written
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound, by = max(bound, t_bytes), ("bytes" if t_bytes >= flops /
                                          BF16_FLOP_PER_S * 1e3
                                          else "operations")
        rows.append({"shape_bhld": [b, h, lc, d], "max_abs_err": err,
                     "lse_max_abs_err": lse_err,
                     "ms": time_ms(kernel), "device_ms": device_ms(kernel),
                     "plain_ms": time_ms(lambda: attention_reference(
                         q, k, v, need_lse=True), iters=3, warmup=1),
                     "library_ms": time_ms(lambda: lib(qt, kt, vt)),
                     "library_device_ms": device_ms(lambda: lib(qt, kt,
                                                                vt)),
                     "library": "aten._scaled_dot_product_flash_attention",
                     "bound_ms": bound, "bound_by": by})
    return rows


def mesh_serve_against_one_rank(recs, seed) -> dict:
    """Phase 5h (d) held to one rank on the card: the mesh sampler's
    tokens to the one-rank sampler's under the same injected noise (fp32:
    equal; bf16: agreement >= MESH_TOKEN_AGREEMENT), the mesh engine's
    to the one-rank engine's at the same seed (each rank draws the global
    batch's noise; agreement >= MESH_TOKEN_AGREEMENT); every rank's
    tokens equal."""
    r0 = recs[0]["serve"]
    for r in recs[1:]:
        for key in ("fp32", "bf16", "engine_ids"):
            if not np.array_equal(r["serve"][key], r0[key]):
                raise AssertionError(f"mesh serve: the ranks' {key} differ")
    out = {"launches": dict(sum((collections.Counter(r["serve"]["launches"])
                                 for r in recs), collections.Counter())),
           "engine_batch_s": r0["engine_batch_s"]}
    for name, plain, dtype in (("fp32", True, torch.float32),
                               ("bf16", False, torch.bfloat16)):
        cfg = mesh_serve_config(plain)
        model = DIT(cfg.model, compute_dtype=dtype, init=False)
        randomize_(model, seed)
        model.cuda().eval()
        txt, injected = mesh_serve_inputs(cfg, seed)
        want = build_t2i_sampler(model, cfg, inject_noise=True)(
            torch.from_numpy(txt).cuda(),
            injected={k: torch.from_numpy(v).cuda()
                      for k, v in injected.items()}).tokens.cpu().numpy()
        lt = cfg.model.txt_length
        agree = float((r0[name][:, lt:] == want[:, lt:]).mean())
        out[f"{name}_token_agreement"] = agree
        if plain and not np.array_equal(r0[name], want):
            raise AssertionError(f"mesh serve: fp32 tokens differ from the "
                                 f"one-rank sampler's ({agree} agree)")
        if not agree >= MESH_TOKEN_AGREEMENT:
            raise AssertionError(f"mesh serve: {name} token agreement "
                                 f"{agree} < {MESH_TOKEN_AGREEMENT}")
        del model
    engine = build_engine(preset="small", overrides=MESH_SERVE_OVERRIDES)
    randomize_(engine.model, seed)
    want = np.stack([r["image_ids"][0] for r in engine.run_batch(
        t2i_requests(engine), seed=seed)])
    agree = float((r0["engine_ids"] == want).mean())
    out["engine_token_agreement"] = agree
    if not agree >= MESH_TOKEN_AGREEMENT:
        raise AssertionError(f"mesh serve: the mesh engine's tokens agree "
                             f"{agree} with the one-rank engine's < "
                             f"{MESH_TOKEN_AGREEMENT}")
    del engine
    return out


def phase_mesh(seed, pre, world) -> dict:
    """Phase 5h (module docstring): `pre` its one-rank part
    (ring_block_cases, run before the world), `world` mesh_worlds'
    records; its seconds are its one-rank part's, its part of the world
    and its checks after."""
    t0 = time.perf_counter()
    rec = dict(pre)
    recs = world["5h"]
    r0 = recs[0]
    mesh_params = r0["train"].pop("params")
    rec["ring"] = {"cases": r0["ring"]["cases"], "launches": dict(sum(
        (r["ring"]["launches"] for r in recs), collections.Counter()))}
    rec["ring_bwd"] = r0["ring_bwd"]
    # the one-rank step on the same batch and draws
    cfg = mesh_train_config()
    model = DIT(cfg.model, compute_dtype=torch.bfloat16, init=False)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.cuda()
    before = {n: p.detach().cpu().clone() for n, p in
              model.named_parameters()}
    state = init_train_state(cfg, model)
    step = make_train_step(cfg, model)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in mesh_packed_batch(cfg, seed).items()}
    gen = torch.Generator(device="cuda")
    losses = []
    for i in range(MESH_TRAIN_STEPS):
        gen.manual_seed(seed + i)
        state, m = step(state, batch, generator=gen)
        losses.append(float(m.loss))
    mesh_losses = r0["train"]["losses"]
    for got, want in zip(mesh_losses, losses):
        if not abs(got - want) <= MESH_LOSS_RTOL * abs(want):
            raise AssertionError(f"mesh train losses {mesh_losses} against "
                                 f"the one-rank step's {losses}")
    up_mesh = torch.cat([(mesh_params[n].float() - before[n].float())
                         .reshape(-1) for n in before])
    up_one = torch.cat([(p.detach().cpu().float() - before[n].float())
                        .reshape(-1) for n, p in state.params.items()])
    cosine = float(F.cosine_similarity(up_mesh, up_one, dim=0))
    if not cosine >= MESH_UPDATE_COSINE:
        raise AssertionError(f"mesh train: update cosine {cosine} < "
                             f"{MESH_UPDATE_COSINE}")
    rec["mesh_train"] = {**r0["train"], "one_rank_losses": losses,
                         "update_cosine": cosine, "launches": dict(sum(
                             (collections.Counter(r["train"]["launches"])
                              for r in recs), collections.Counter()))}
    del model, state, step, before, mesh_params, up_mesh, up_one
    free()
    rec["mesh_serve"] = mesh_serve_against_one_rank(recs, seed)
    rec["mesh_ring"] = {"launches": rec["ring"]["launches"]}
    free()
    rec["world_part_s"] = world["part_s"]["5h"]
    rec["seconds"] = rec["before_world_s"] + rec["world_part_s"] + \
        time.perf_counter() - t0
    print("mesh " + json.dumps({
        "card": card_line(), "seconds": rec["seconds"],
        "ranks": MESH_RANKS, "transport": "gloo, staged through host memory",
        "ring": {k: {f: v[f] for f in ("rel_rms_err", "max_abs_err",
                                       "max_abs_ref", "use")}
                 for k, v in rec["ring"]["cases"].items()},
        "wrong_rings": r0["ring"]["wrong_rings"],
        "ring_bwd_max_abs_err": {k: v["max_abs_err"]
                                 for k, v in rec["ring_bwd"].items()},
        "train_losses": mesh_losses, "one_rank_losses": losses,
        "update_cosine": cosine,
        "serve": {k: v for k, v in rec["mesh_serve"].items()
                  if k != "launches"},
        "blocks": [{k: r[k] for k in ("shape_bhld", "ms", "device_ms",
                                      "bound_ms", "library_ms",
                                      "library_device_ms")}
                   for r in rec["blocks"]]}))
    return rec


# ---------------------------------------------------------------------------
# 5i: the rest of the mesh (pipeline, tensor and expert parallelism)
# ---------------------------------------------------------------------------

MESH2_BLOCKS = 4        # the flagship's 12 blocks cut to 4 (one world)
MESH2_TRAIN_MESHES = {
    "mesh2_train_pp": dict(dcn=2, fsdp=1, pp=2, pp_microbatches=2),
    "mesh2_train_tensor": dict(dcn=2, fsdp=1, tensor=2),
    "mesh2_train_moe": dict(dcn=2, fsdp=1, ep=2)}
MESH2_SERVE_SPEC = dict(dcn=1, fsdp=1, pp=2, tensor=2, pp_microbatches=2)
# dense data parallelism, whose engine runs its captured program
MESH2_DP_ENGINE_SPEC = "dcn=2,fsdp=2"
MESH2_RUNS = tuple(MESH2_TRAIN_MESHES) + ("mesh2_serve", "mesh2_dp_engine",
                                          "mesh2_int8")
MESH2_PATHS = tuple(MESH2_TRAIN_MESHES) + ("mesh2_serve", "mesh2_engine",
                                           "mesh2_dp_engine",
                                           "mesh2_int8_engine",
                                           "mesh2_moe_int8_engine")
# flash_fwd and the backward kernels at a tensor-parallel rank's heads:
# the flagship's 12 heads over tensor 2, batch 16
MESH2_TP_CASE = ("tensor_rank", (16, 6, 384, 64), False, False)
MESH2_TIMEOUT_S = 240
MESH2_TRAIN_BATCH = 8   # 5h's 16 halved: every collective here crosses
                        # the host (gloo), and 5i must stay near a minute
# The train paths' limits against the one-rank step (mesh2_train_readings),
# from scripts/mesh2_readings.py on an H100 80GB HBM3 at 700 W: the sound
# tree's largest readings in bf16 were a loss gap of 1.52e-5 (tensor; 0 on
# pp and ep), gradient-norm gaps of 1.8e-4, trunk-moment distances of
# 5.7e-3 and cosines of 0.99992 (fp32 through the plain attention: 7.5e-8,
# 9.9e-8, 1.1e-6: the bf16 gaps are rounding); five planted faults read
# loss gaps of 7.8e-4 to 3.0e-3 (one, gradients summed over every rank,
# the sound 1.52e-5: the first step's LR is 0, so both losses are of the
# initial weights), gradient-norm gaps of 0.014 to 1.34, trunk-moment
# distances of 0.40 to 0.94 and cosines of 0.29 to 0.91.
MESH2_TRAIN_LIMITS = {name: {"loss_rel": MESH_LOSS_RTOL,
                             "grad_norm_rel": 1e-3,
                             "trunk_moment_rel": 2e-2,
                             "update_cosine": MESH_UPDATE_COSINE}
                      for name in MESH2_TRAIN_MESHES}
MESH2_TRAIN_LIMITS["mesh2_train_tensor"]["loss_rel"] = 3e-5
# the dense data-parallel engine token for token (read 1.0; its program
# captured outside global_rows read 0.0005)
MESH2_DP_ENGINE_AGREEMENT = 1.0


def mesh2_train_config(name, plain: bool = False) -> Config:
    """The flagship training configuration at depth MESH2_BLOCKS; the MoE
    path's with phase 5g's MoE settings (8 experts, top-2); plain: through
    the plain attention (an fp32 run)."""
    return train_config(**{"model.n_blocks": MESH2_BLOCKS,
                           **(MOE_OVERRIDES if name.endswith("moe")
                              else {}),
                           **({"model.attn_backend": "xla"} if plain
                              else {})})


def mesh2_batch(cfg, seed) -> dict:
    """A [text | image] token batch of MESH2_TRAIN_BATCH rows."""
    m = cfg.model
    b = MESH2_TRAIN_BATCH
    rng = np.random.RandomState(seed)
    ids = np.concatenate([
        rng.randint(0, m.text_vocab_size - 1, (b, m.txt_length)),
        rng.randint(m.text_vocab_size, m.vocab_size, (b, m.img_length))],
        -1)
    modality = np.concatenate([np.zeros((b, m.txt_length)),
                               np.ones((b, m.img_length))], -1)
    return {"input_ids": torch.from_numpy(ids.astype(np.int64)).cuda(),
            "modality": torch.from_numpy(modality.astype(np.int64)).cuda()}


def mesh2_train_launches(name, cfg, steps) -> dict:
    """flash_fwd / dq / dkv launches of one rank's `steps` mesh steps, from
    the code: a pp rank runs its stage's blocks once a microbatch, forward
    and backward; a tensor or ep rank every block once."""
    mesh = MESH2_TRAIN_MESHES[name]
    per = cfg.model.n_blocks
    if mesh.get("pp", 1) > 1:
        per = per // mesh["pp"] * mesh["pp_microbatches"]
    return {k: steps * per for k in ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv")}


def mesh2_model(cfg, seed, dtype=torch.bfloat16):
    """A train path's model on the card with randomize_'s weights, drawn
    on the card: the adaLN gates and the head non-zero (the default init
    zeroes both), so the trunk drives the losses and every leaf has a
    gradient."""
    model = DIT(cfg.model, compute_dtype=dtype, init=False).cuda()
    randomize_(model, seed)
    return model


def mesh2_steps(step, state, batch, seed):
    """MESH_TRAIN_STEPS steps with the step's seeded draws: (state,
    losses, gradient norms, seconds)."""
    gen = torch.Generator(device="cuda")
    losses, norms = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(MESH_TRAIN_STEPS):
        gen.manual_seed(seed + i)
        state, m = step(state, batch, generator=gen)
        losses.append(float(m.loss))
        norms.append(float(m.grad_norm))
    torch.cuda.synchronize()
    return state, losses, norms, time.perf_counter() - t0


def update_cosine(after, before, params) -> float:
    """The cosine of two parameter updates (after - before by name, and
    params - before), in fp64 (an fp32 cosine over the MoE's ~10^8
    elements read 1.04)."""
    dot = na = nb = 0.0
    for n, p0 in before.items():
        a = (after[n].double() - p0.double()).reshape(-1)
        b = (params[n].detach().double() - p0.double()).reshape(-1)
        a = a.detach()
        dot += float(a @ b)
        na += float(a @ a)
        nb += float(b @ b)
    return dot / math.sqrt(na * nb)


def first_moments(state) -> dict:
    """AdamW's first moment by parameter name: after two steps
    (1 - b1) (b1 g1 + g2), linear in the two steps' gradients."""
    from unidisc_tpu_torch.training.train_state import flat_views
    return flat_views(state.opt_state.adam.mu, state.params)


def trunk_moment_error(mine, one) -> tuple:
    """(relative L2 distance, reference norm) of the first moments of the
    trunk's leaves (``blocks.*``) in `mine`, in fp64."""
    num = den = 0.0
    for n, m in mine.items():
        if n.startswith("blocks."):
            ref = one[n].double()
            num += float((m.double() - ref).square().sum())
            den += float(ref.square().sum())
    return math.sqrt(num / den), math.sqrt(den)


def mesh2_train_rank(rank, world, seed, name, plain=False) -> dict:
    """MESH_TRAIN_STEPS mesh steps of the path `name` on its mesh (plain:
    in fp32 through the plain attention); then on rank 0 the one-rank step
    from the same weights, batch and draws, its losses and gradient norms,
    the two updates' cosine and the trunk's first moments against it."""
    from unidisc_tpu_torch.parallel.mesh import make_mesh
    from unidisc_tpu_torch.training.train_state import shard_train_step
    t_start = time.perf_counter()
    dtype = torch.float32 if plain else torch.bfloat16
    cfg = mesh2_train_config(name, plain)
    mesh_cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
        cfg.mesh, **MESH2_TRAIN_MESHES[name]))
    model = mesh2_model(cfg, seed, dtype)
    before = {n: p.detach().clone() for n, p in model.named_parameters()} \
        if rank == 0 else None
    step, state, layout = shard_train_step(mesh_cfg, model,
                                           make_mesh(mesh_cfg.mesh))
    batch = mesh2_batch(cfg, seed)
    _build.reset_launch_counts()
    state, losses, norms, secs = mesh2_steps(step, state, batch, seed)
    launches = dict(_build.launch_counts)
    want = {} if plain else mesh2_train_launches(name, cfg,
                                                 MESH_TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"{name}: rank {rank} launches {launches}, "
                             f"the code {want}")
    rec = {"losses": losses, "grad_norms": norms, "launches": launches,
           "seconds": secs, "held": len(state.params)}
    if rank == 0:
        # what rank 0 holds (its stage, head shards and experts,
        # MeshShards.scatter's part of the whole) against the same part
        # of the one-rank step's
        one = mesh2_model(cfg, seed, dtype)
        (one_state, rec["one_rank_losses"], rec["one_rank_grad_norms"],
         rec["one_rank_s"]) = mesh2_steps(
            make_train_step(cfg, one), init_train_state(cfg, one), batch,
            seed)
        shards = model.mesh_shards
        rec["update_cosine"] = update_cosine(
            state.params, shards.scatter(before, layout, {}),
            shards.scatter(one_state.params, layout, {}))
        rec["trunk_moment_rel"], rec["trunk_moment_norm"] = \
            trunk_moment_error(first_moments(state), shards.scatter(
                first_moments(one_state), layout, {}))
        del one, one_state
    rec["path_s"] = time.perf_counter() - t_start
    return rec


MESH2_SERVE_STEPS = 2    # 5h's 4 halved: each step's collectives cross
                         # the host
MESH2_SERVE_OVERRIDES = {**FLAGSHIP_OVERRIDES,
                         "sampling.steps": MESH2_SERVE_STEPS,
                         "model.n_blocks": MESH2_BLOCKS}
# int8 W8A8 on the mesh: the int8 headline (the int8 kernel, the fused
# prologue) on MESH2_SERVE_SPEC, and the int8 MoE flagship (its experts in
# floating point, the fused prologue off) on dcn 2 x ep 2; label ->
# (overrides, mesh, the launch counts' path)
MESH2_INT8_OVERRIDES = {**FLAGSHIP_INT8_OVERRIDES,
                        "sampling.steps": MESH2_SERVE_STEPS,
                        "model.n_blocks": MESH2_BLOCKS}
MESH2_INT8_ENGINES = {
    "int8": (MESH2_INT8_OVERRIDES, MESH2_SERVE_SPEC, "mesh2_int8_engine"),
    "moe_int8": ({**MESH2_INT8_OVERRIDES, **MOE_OVERRIDES,
                  "model.quant_fused": False}, dict(dcn=2, fsdp=1, ep=2),
                 "mesh2_moe_int8_engine")}
MESH2_TP = 2             # the tensor width of the row-parallel checks


def mesh_spec(spec: dict) -> str:
    """build_engine's mesh= string of a dict of mesh fields."""
    return ",".join(f"{k}={v}" for k, v in spec.items())


def mesh2_serve_config(plain: bool = False) -> Config:
    return Config.make("small", **MESH2_SERVE_OVERRIDES, **(
        {"model.attn_backend": "xla"} if plain else {}))


def mesh2_weights(cfg, seed) -> dict:
    """The served flagship's random weights (randomize_ on the card, as
    the one-rank runs draw them)."""
    model = DIT(cfg.model, compute_dtype=torch.bfloat16, init=False).cuda()
    randomize_(model, seed)
    return {n: p.detach() for n, p in model.named_parameters()}


def mesh2_serve_rank(rank, world, seed) -> dict:
    """On pp 2 x tensor 2 (2 microbatches): the t2i sampler under
    spmd_sampler with injected noise in fp32 (plain attention) and bf16
    (the kernel), then build_engine(mesh=) serving REQUESTS requests;
    launches held to the code's count."""
    from unidisc_tpu_torch.parallel.mesh import (MeshLayout, make_mesh,
                                                 shard_model)
    from unidisc_tpu_torch.parallel.sample import spmd_sampler
    from unidisc_tpu_torch.sampling.t2i_fast import build_t2i_sampler
    rec = {}

    def launched(name, cfg, nfe, kernel):
        torch.cuda.synchronize()
        got = dict(_build.launch_counts)
        # a stage's blocks once a microbatch: with as many microbatches as
        # stages, the one-rank forward's count
        per = expected_serve_launches(cfg.model, cfg.sampling, nfe)
        want = {"flash_fwd": per["flash_fwd"]} if kernel else {}
        if got != want:
            raise AssertionError(f"mesh2 serve {name}: rank {rank} launches "
                                 f"{got}, the code {want}")
        return got

    launches = collections.Counter()
    t0 = time.perf_counter()
    for name, plain, dtype in (("fp32", True, torch.float32),
                               ("bf16", False, torch.bfloat16)):
        cfg = mesh2_serve_config(plain)
        cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, **MESH2_SERVE_SPEC))
        layout = MeshLayout.of(make_mesh(cfg.mesh))
        model = DIT(cfg.model, compute_dtype=dtype, init=False).cuda()
        randomize_(model, seed)
        shard_model(model.eval(), layout)
        txt, injected = mesh_serve_inputs(cfg, seed)
        sample = spmd_sampler(build_t2i_sampler(model, cfg,
                                                inject_noise=True),
                              cfg, layout)
        _build.reset_launch_counts()
        out = sample(torch.from_numpy(txt).cuda(),
                     injected={k: torch.from_numpy(v).cuda()
                               for k, v in injected.items()})
        launches.update(launched(name, cfg, out.nfe, kernel=not plain))
        rec[name] = out.tokens.cpu().numpy()
        rec[f"{name}_s"] = time.perf_counter() - t0
        del model, sample
    rec["sampler_s"] = time.perf_counter() - t0
    rec["serve_launches"] = dict(launches)
    t_engine = time.perf_counter()
    engine = build_engine(preset="small", overrides=MESH2_SERVE_OVERRIDES,
                          mesh=mesh_spec(MESH2_SERVE_SPEC))
    # the one-rank engine's weights, this rank's part of them
    mine = engine.model.mesh_shards.scatter(
        mesh2_weights(engine.config, seed), engine.mesh, {})
    with torch.no_grad():
        for n, p in engine.model.named_parameters():
            if n in mine:
                p.copy_(mine[n])
    prepared = t2i_requests(engine)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.run_batch(prepared, seed=seed)
    torch.cuda.synchronize()
    rec["engine_batch_s"] = time.perf_counter() - t0
    rec["engine_launches"] = launched("engine", engine.config,
                                      results[0]["nfe"], kernel=True)
    rec["engine_ids"] = np.stack([r["image_ids"][0] for r in results])
    rec["held"] = sum(p.numel() for p in engine.model.parameters())
    rec["engine_s"] = time.perf_counter() - t_engine
    return rec


def mesh2_dp_engine_rank(rank, world, seed) -> dict:
    """build_engine(mesh=MESH2_DP_ENGINE_SPEC), dense data parallelism:
    each rank's t2i sampler runs its captured program on its rows of
    REQUESTS requests, with the one-rank engine's weights; launches held
    to the code's count."""
    t0 = time.perf_counter()
    engine = build_engine(preset="small", overrides=MESH2_SERVE_OVERRIDES,
                          mesh=MESH2_DP_ENGINE_SPEC)
    with torch.no_grad():
        weights = mesh2_weights(engine.config, seed)
        for n, p in engine.model.named_parameters():
            p.copy_(weights[n])
    prepared = t2i_requests(engine)
    _build.reset_launch_counts()
    t_batch = time.perf_counter()
    results = engine.run_batch(prepared, seed=seed)
    torch.cuda.synchronize()
    rec = {"batch_s": time.perf_counter() - t_batch}
    got = dict(_build.launch_counts)
    # the first call captures the program: its warm run (eager) and one
    # replay both run on the card
    want = {"flash_fwd": 2 * expected_serve_launches(
        engine.config.model, engine.config.sampling,
        results[0]["nfe"])["flash_fwd"]}
    if got != want:
        raise AssertionError(f"mesh2 dp engine: rank {rank} launches {got}, "
                             f"the code {want}")
    programs = sum(len(s.graphs) for s in engine._samplers.values())
    if programs != 1:
        raise AssertionError(f"mesh2 dp engine: rank {rank} captured "
                             f"{programs} programs, not 1")
    rec.update(launches=got, seconds=time.perf_counter() - t0,
               ids=np.stack([r["image_ids"][0] for r in results]))
    return rec


def row_parallel_shapes(m, tensor=MESH2_TP) -> list:
    """(name, M, K-slice, N) of a tensor rank's row-parallel int8 products
    in the served batch (2 x REQUESTS x L rows): attn_out's and mlp.2's."""
    rows = 2 * REQUESTS * m.length
    d, f = m.hidden_size, m.mlp_ratio * m.hidden_size
    return [("attn_out", rows, d // tensor, d),
            ("mlp_2", rows, f // tensor, d)]


def row_parallel_input(gen, mm, k, dtype=torch.bfloat16) -> torch.Tensor:
    """(mm, k) rows of random scale: every 64th row zero, and every 64th
    from the second zero in its first half only (a tensor rank's K-slice
    all zero where the whole row is not)."""
    x = torch.randn((mm, k), generator=gen, device="cuda") \
        * torch.rand((mm, 1), generator=gen, device="cuda") * 4
    x[::64] = 0.0
    x[1::64, :k // 2] = 0.0
    return x.to(dtype)


def mesh2_int8_weights(overrides, seed) -> dict:
    """The one-rank int8 engine's weights: randomize_'s flagship weights
    (drawn on the card, as mesh2_weights) quantized whole by
    quantize_dit_params."""
    cfg = Config.make("small", **overrides)
    model = DIT(cfg.model, compute_dtype=torch.bfloat16, init=False).cuda()
    randomize_(model, seed)
    return quantize_dit_params(model.state_dict())


def expected_mesh_int8_launches(m, s, nfe, tensor) -> dict:
    """A mesh rank's launches of one served int8 batch (eager, at as many
    microbatches as stages: the one-rank forward's count): the one-rank
    counts, with a tensor rank's row-parallel products (attn_out, mlp.2)
    each a row_amax, a quantize_by_amax and an int32 int8_matmul in place
    of a dynamic_quantize and an int8_matmul."""
    want = collections.Counter(expected_serve_launches(m, s, nfe))
    if tensor > 1:
        rows = 2 * m.n_blocks * nfe
        want.subtract({"int8_matmul": rows, "dynamic_quantize": rows})
        want.update({"int8_matmul_int32": rows, "row_amax": rows,
                     "quantize_by_amax": rows})
    return {k: v for k, v in want.items() if v}


def mesh2_int8_rank(rank, world, seed) -> dict:
    """Phase 5i's int8 W8A8 work on one rank: (1) on MESH2_SERVE_SPEC's
    tensor group, each row-parallel product of row_parallel_shapes through
    qdot_row_parallel on the rank's K-slice of inputs every rank draws
    alike, against qdot of the whole rows on this rank, bit for bit; (2)
    each engine of MESH2_INT8_ENGINES, build_engine(quantize="int8",
    mesh=) serving REQUESTS requests with its part of the one-rank int8
    engine's weights, launches held to the code's count."""
    from unidisc_tpu_torch.ops.quant import qdot, qdot_row_parallel
    from unidisc_tpu_torch.parallel.mesh import MeshLayout, Part, make_mesh
    t0 = time.perf_counter()
    cfg = Config.make("small", **MESH2_INT8_OVERRIDES)
    tp = MeshLayout.of(make_mesh(dataclasses.replace(
        cfg.mesh, **MESH2_SERVE_SPEC))).tensor
    gen = torch.Generator(device="cuda").manual_seed(seed + 22)
    part = Part("tensor", 1)
    rec = {"products": {}}
    for name, mm, k, n in row_parallel_shapes(cfg.model, tp.size):
        x = row_parallel_input(gen, mm, k * tp.size)
        w_q = torch.randint(-127, 128, (n, k * tp.size), dtype=torch.int8,
                            generator=gen, device="cuda")
        w_s = torch.rand((n,), generator=gen, device="cuda") * 0.02 + 1e-3
        bias = torch.randn((n,), generator=gen, device="cuda") \
            if name == "mlp_2" else None
        want = qdot(x, w_q, w_s, bias=bias, backend="pallas")
        got = qdot_row_parallel(
            part.take(x, tp.rank, tp.size).contiguous(),
            part.take(w_q, tp.rank, tp.size).contiguous(), w_s, tp.group,
            bias=bias, out_dtype=torch.bfloat16, backend="pallas")
        torch.cuda.synchronize()
        rec["products"][name] = {
            "shape_mkn": [mm, k, n], "equal": bool(torch.equal(got, want)),
            "max_abs_err": float((got.float() - want.float()).abs().max())}
        del x, w_q, got, want
    rec["products_s"] = time.perf_counter() - t0
    for label, (over, spec, _) in MESH2_INT8_ENGINES.items():
        t0 = time.perf_counter()
        engine = build_engine(preset="small", overrides=over,
                              quantize="int8", mesh=mesh_spec(spec))
        # this rank's part of the one-rank engine's int8 weights
        mine = engine.model.mesh_shards.scatter(
            mesh2_int8_weights(over, seed), engine.mesh, {})
        with torch.no_grad():
            for n, t in itertools.chain(engine.model.named_parameters(),
                                        engine.model.named_buffers()):
                if n in mine:
                    t.copy_(mine[n])
        del mine
        prepared = t2i_requests(engine)
        _build.reset_launch_counts()
        t_batch = time.perf_counter()
        results = engine.run_batch(prepared, seed=seed)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t_batch
        got = dict(_build.launch_counts)
        want = expected_mesh_int8_launches(
            engine.config.model, engine.config.sampling, results[0]["nfe"],
            engine.mesh.tensor.size)
        if got != want:
            raise AssertionError(f"mesh2 {label} engine: rank {rank} "
                                 f"launches {got}, the code {want}")
        rec[label] = {"ids": np.stack([r["image_ids"][0] for r in results]),
                      "launches": got, "batch_s": batch_s,
                      "held": sum(t.numel() for t in itertools.chain(
                          engine.model.parameters(),
                          engine.model.buffers())),
                      "seconds": time.perf_counter() - t0}
        del engine
        free()
    return rec


def full_precision_gemms(on: bool = True) -> None:
    """TF32 off and bf16 GEMMs reduced in fp32 (no bf16 split-K
    partials), so a mesh path and its one-rank reference differ only in
    their summation order."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        not on


def mesh2_rank_work(rank, world, seed, runs=MESH2_RUNS,
                    plain=False) -> dict:
    """Phase 5i's work on one rank of a started world, with full-precision
    GEMMs: the runs named in `runs` (plain: the train paths in fp32
    through the plain attention)."""
    full_precision_gemms()
    rec = {}
    for name in MESH2_TRAIN_MESHES:
        if name in runs:
            rec[name] = mesh2_train_rank(rank, world, seed, name, plain)
            free()
    if "mesh2_serve" in runs:
        rec["serve"] = mesh2_serve_rank(rank, world, seed)
        free()
    if "mesh2_dp_engine" in runs:
        rec["dp_engine"] = mesh2_dp_engine_rank(rank, world, seed)
        free()
    if "mesh2_int8" in runs:
        rec["int8"] = mesh2_int8_rank(rank, world, seed)
    return rec


def world_rank(rank, world, work, timeout, parts):
    """One rank of a world of spawned processes sharing card 0 over gloo
    (NCCL refuses two ranks on one device; every collective stages
    through host memory, parallel/comm.py): each (name, fn, args) of
    `parts` in order, fn(rank, world, *args) its record, after a barrier
    and timed; the records, and each part's seconds under "part_s", saved
    to work/rank<r>.pt. Past `timeout` s the rank dumps its stacks and
    exits."""
    import faulthandler

    import torch.distributed as dist
    faulthandler.dump_traceback_later(timeout - 10, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store"), world), rank=rank, world_size=world)
    rec = {"part_s": {}}
    for name, fn, args in parts:
        dist.barrier()
        t0 = time.perf_counter()
        rec[name] = fn(rank, world, *args)
        free()
        rec["part_s"][name] = time.perf_counter() - t0
    torch.save(rec, os.path.join(work, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def spawn_world(parts, timeout, label, during=None):
    """world_rank(rank, MESH_RANKS, work, timeout, parts) on MESH_RANKS
    spawned processes sharing card 0; their records by rank. `during`:
    work this process does on the card while the ranks run (the one-rank
    references of their phases), its result in `during.result`. A rank
    that fails, or a world past `timeout` s, fails the phase `label`: the
    other ranks are stopped."""
    import torch.multiprocessing as mp
    work = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=world_rank,
                         args=(r, MESH_RANKS, work, timeout, parts))
             for r in range(MESH_RANKS)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        if during is not None:
            during.result = during()
        while any(p.is_alive() for p in procs):
            bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                raise AssertionError(f"phase {label}: a rank failed (exit "
                                     f"codes {[p.exitcode for p in procs]})")
            time.sleep(0.5)
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise AssertionError(f"phase {label}: exit codes {codes}")
        return [torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=False) for r in range(MESH_RANKS)]
    finally:
        for p in procs:
            if p.pid is None:
                continue
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(work, ignore_errors=True)


def mesh2_world(seed, runs=MESH2_RUNS, plain=False):
    """Phase 5i's work alone on a world of MESH_RANKS spawned ranks; their
    records by rank."""
    return [r["5i"] for r in spawn_world(
        (("5i", mesh2_rank_work, (seed, runs, plain)),), MESH2_TIMEOUT_S,
        "5i")]


def rel_gap(got, want) -> float:
    """The largest relative distance of two lists of numbers."""
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def mesh2_train_readings(name, recs) -> dict:
    """A train path against the one-rank step (rank 0 ran it on the same
    weights, batch and draws): the largest relative gap of any rank's
    losses and gradient norms, the update's cosine and the trunk's first
    moments' relative distance over rank 0's part."""
    r0 = recs[0][name]
    return {
        "loss_rel": max(rel_gap(rec[name]["losses"], r0["one_rank_losses"])
                        for rec in recs),
        "grad_norm_rel": max(rel_gap(rec[name]["grad_norms"],
                                     r0["one_rank_grad_norms"])
                             for rec in recs),
        "trunk_moment_rel": r0["trunk_moment_rel"],
        "trunk_moment_norm": r0["trunk_moment_norm"],
        "update_cosine": r0["update_cosine"]}


def mesh2_train_against_one_rank(name, recs) -> dict:
    """A train path held to the one-rank step: each reading of
    mesh2_train_readings within MESH2_TRAIN_LIMITS."""
    r0 = recs[0][name]
    readings = mesh2_train_readings(name, recs)
    for key, limit in MESH2_TRAIN_LIMITS[name].items():
        ok = readings[key] >= limit if key == "update_cosine" \
            else readings[key] <= limit
        if not ok:
            raise AssertionError(f"{name}: {key} {readings[key]} against "
                                 f"the limit {limit} (losses "
                                 f"{r0['losses']}, one rank "
                                 f"{r0['one_rank_losses']})")
    return {**readings, "losses": r0["losses"],
            "one_rank_losses": r0["one_rank_losses"],
            "grad_norms": r0["grad_norms"],
            "one_rank_grad_norms": r0["one_rank_grad_norms"],
            "mesh_s": [rec[name]["seconds"] for rec in recs],
            "path_s": r0["path_s"],
            "one_rank_s": r0["one_rank_s"], "held_params_rank0": r0["held"],
            "launches": dict(sum((collections.Counter(rec[name]["launches"])
                                  for rec in recs), collections.Counter()))}


def mesh2_serve_against_one_rank(recs, seed) -> dict:
    """The pp 2 x tensor 2 sampler and engine held to one rank: fp32
    tokens equal to the one-rank sampler's under the same injected noise,
    bf16 and the engine (at the same seed) agreeing >=
    MESH_TOKEN_AGREEMENT; every rank's tokens equal."""
    r0 = recs[0]["serve"]
    for r in recs[1:]:
        for key in ("fp32", "bf16", "engine_ids"):
            if not np.array_equal(r["serve"][key], r0[key]):
                raise AssertionError(f"mesh2 serve: the ranks' {key} differ")
    out = {"sampler_s": r0["sampler_s"], "fp32_s": r0["fp32_s"],
           "bf16_s": r0["bf16_s"], "engine_s": r0["engine_s"],
           "engine_batch_s": r0["engine_batch_s"],
           "held_params_rank0": r0["held"]}
    for name, plain, dtype in (("fp32", True, torch.float32),
                               ("bf16", False, torch.bfloat16)):
        cfg = mesh2_serve_config(plain)
        model = DIT(cfg.model, compute_dtype=dtype, init=False).cuda()
        randomize_(model, seed)
        model.eval()
        txt, injected = mesh_serve_inputs(cfg, seed)
        want = build_t2i_sampler(model, cfg, inject_noise=True)(
            torch.from_numpy(txt).cuda(),
            injected={k: torch.from_numpy(v).cuda()
                      for k, v in injected.items()}).tokens.cpu().numpy()
        lt = cfg.model.txt_length
        agree = float((r0[name][:, lt:] == want[:, lt:]).mean())
        out[f"{name}_token_agreement"] = agree
        if plain and not np.array_equal(r0[name], want):
            raise AssertionError(f"mesh2 serve: fp32 tokens differ from the "
                                 f"one-rank sampler's ({agree} agree)")
        if not agree >= MESH_TOKEN_AGREEMENT:
            raise AssertionError(f"mesh2 serve: {name} token agreement "
                                 f"{agree} < {MESH_TOKEN_AGREEMENT}")
        del model
    agree = float((r0["engine_ids"] == one_rank_engine_ids(seed)).mean())
    out["engine_token_agreement"] = agree
    if not agree >= MESH_TOKEN_AGREEMENT:
        raise AssertionError(f"mesh2 serve: the mesh engine's tokens agree "
                             f"{agree} with the one-rank engine's < "
                             f"{MESH_TOKEN_AGREEMENT}")
    return out


def one_rank_engine_ids(seed) -> np.ndarray:
    """The image ids of the one-rank engine (captured) serving REQUESTS
    requests at `seed` on the mesh engines' weights (kept after the first
    call)."""
    if seed not in _ONE_RANK_ENGINE_IDS:
        engine = build_engine(preset="small", overrides=MESH2_SERVE_OVERRIDES)
        randomize_(engine.model, seed)
        _ONE_RANK_ENGINE_IDS[seed] = np.stack([
            r["image_ids"][0] for r in engine.run_batch(
                t2i_requests(engine), seed=seed)])
        del engine
        free()
    return _ONE_RANK_ENGINE_IDS[seed]


_ONE_RANK_ENGINE_IDS: dict = {}


def mesh2_dp_engine_readings(recs, seed) -> dict:
    """The dense data-parallel engine's captured programs against the
    one-rank engine at the same seed: the share of image ids equal, and
    whether every rank gathered the same ids."""
    ids = recs[0]["dp_engine"]["ids"]
    return {"token_agreement": float((ids == one_rank_engine_ids(seed))
                                     .mean()),
            "ranks_equal": all(np.array_equal(r["dp_engine"]["ids"], ids)
                               for r in recs)}


def mesh2_dp_engine_against_one_rank(recs, seed) -> dict:
    """mesh2_dp_engine_readings within MESH2_DP_ENGINE_AGREEMENT."""
    out = mesh2_dp_engine_readings(recs, seed)
    if not out["ranks_equal"]:
        raise AssertionError("mesh2 dp engine: the ranks' ids differ")
    if not out["token_agreement"] >= MESH2_DP_ENGINE_AGREEMENT:
        raise AssertionError(
            f"mesh2 dp engine: the captured programs' tokens agree "
            f"{out['token_agreement']} with the one-rank engine's < "
            f"{MESH2_DP_ENGINE_AGREEMENT}")
    return {**out, "batch_s": [r["dp_engine"]["batch_s"] for r in recs],
            "seconds": [r["dp_engine"]["seconds"] for r in recs],
            "launches": dict(sum((collections.Counter(
                r["dp_engine"]["launches"]) for r in recs),
                collections.Counter()))}


def one_rank_int8_engine_ids(label, seed) -> np.ndarray:
    """The image ids of the one-rank int8 engine of MESH2_INT8_ENGINES[
    label] (captured) serving REQUESTS requests at `seed` on
    mesh2_int8_weights."""
    over = MESH2_INT8_ENGINES[label][0]
    engine = build_engine(preset="small", overrides=over, quantize="int8")
    engine.model.load_state_dict(mesh2_int8_weights(over, seed))
    ids = np.stack([r["image_ids"][0] for r in engine.run_batch(
        t2i_requests(engine), seed=seed)])
    del engine
    free()
    return ids


def mesh2_int8_readings(recs, seed) -> dict:
    """The int8 work of the world: whether each row-parallel product
    equalled the one-rank qdot on every rank (and its largest error), and
    each int8 engine's token agreement with the one-rank int8 engine at
    the same seed, whether its ranks' ids were equal, its seconds."""
    out = {"products": {
        name: {"equal_on_every_rank": all(
            r["int8"]["products"][name]["equal"] for r in recs),
            "max_abs_err": max(r["int8"]["products"][name]["max_abs_err"]
                               for r in recs),
            "shape_mkn": recs[0]["int8"]["products"][name]["shape_mkn"]}
        for name in recs[0]["int8"]["products"]},
        "products_s": recs[0]["int8"]["products_s"]}
    for label in MESH2_INT8_ENGINES:
        ids = recs[0]["int8"][label]["ids"]
        out[label] = {
            "token_agreement": float((ids == one_rank_int8_engine_ids(
                label, seed)).mean()),
            "ranks_equal": all(np.array_equal(r["int8"][label]["ids"], ids)
                               for r in recs),
            "batch_s": [r["int8"][label]["batch_s"] for r in recs],
            "seconds": [r["int8"][label]["seconds"] for r in recs],
            "held_rank0": recs[0]["int8"][label]["held"]}
    return out


def mesh2_int8_against_one_rank(recs, seed) -> dict:
    """mesh2_int8_readings within its limits: every row-parallel product
    bit for bit the one-rank qdot; every int8 engine's ranks equal and
    agreeing >= MESH_TOKEN_AGREEMENT with the one-rank int8 engine."""
    out = mesh2_int8_readings(recs, seed)
    for name, p in out["products"].items():
        if not p["equal_on_every_rank"]:
            raise AssertionError(f"mesh2 int8: the row-parallel {name} "
                                 f"product differs from the one-rank qdot "
                                 f"(max abs {p['max_abs_err']})")
    for label in MESH2_INT8_ENGINES:
        got = out[label]
        if not got["ranks_equal"]:
            raise AssertionError(f"mesh2 {label} engine: the ranks' ids "
                                 f"differ")
        if not got["token_agreement"] >= MESH_TOKEN_AGREEMENT:
            raise AssertionError(
                f"mesh2 {label} engine: its tokens agree "
                f"{got['token_agreement']} with the one-rank int8 engine's "
                f"< {MESH_TOKEN_AGREEMENT}")
    return out


ROW_AMAX_OPS_PER_ELEMENT = 2    # |x| and the max


def phase_row_parallel_kernels(seed) -> dict:
    """5i's one-rank checks of a tensor rank's row-parallel int8 kernels
    at row_parallel_shapes: the int32 form of int8_matmul against
    int8_matmul_reference(out_dtype=int32), equal; row_amax and
    quantize_by_amax on the rank's K-slice (bf16 and fp32 in, some rows
    zero, some zero in the slice only) against their plain versions,
    equal, and quantize_by_amax given the whole row's amax equal to
    dynamic_quantize of the whole row on the slice. Each timed at bf16
    in: ms, device_ms, host_us, the plain version, one library call where
    there is one, and the bound (bytes at HBM_BYTES_PER_S or operations
    at the int8 / fp32 peak)."""
    from unidisc_tpu_torch.ops.quant import (dynamic_quantize,
                                             quantize_by_amax,
                                             quantize_by_amax_reference,
                                             row_amax, row_amax_reference)
    m = Config.make("small", **FLAGSHIP_INT8_OVERRIDES).model
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    out = {"int8_matmul_int32": [], "row_amax": [], "quantize_by_amax": []}

    def bound(nbytes, ops, peak):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / peak * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "ops": ops}

    def timed(fn, plain, library):
        return {"ms": time_ms(fn), "device_ms": device_ms(fn),
                "host_us": host_us(fn), "plain_ms": time_ms(plain, iters=5),
                "library_ms": time_ms(library) if library else None,
                "library_device_ms": (device_ms(library) if library
                                      else None)}

    for name, mm, k, n in row_parallel_shapes(m):
        kw = dict(generator=gen, device="cuda")
        xq = torch.randint(-127, 128, (mm, k), dtype=torch.int8, **kw)
        wq = torch.randint(-127, 128, (n, k), dtype=torch.int8, **kw)

        def raw():
            return int8_matmul(xq, None, wq, None, out_dtype=torch.int32)

        got = raw()
        want = int8_matmul_reference(xq, None, wq, None,
                                     out_dtype=torch.int32)
        torch.cuda.synchronize()
        err = (got.long() - want.long()).abs().max().item()
        if got.dtype != torch.int32 or not torch.equal(got, want):
            raise AssertionError(f"int8_matmul int32 differs from "
                                 f"int8_matmul_reference at {name} ({mm}, "
                                 f"{k}, {n}): max abs {err}")

        def library():
            return torch._int_mm(xq, wq.t())
        try:
            if not torch.equal(library(), want):
                raise AssertionError("torch._int_mm differs")
        except RuntimeError as e:
            print(f"  torch._int_mm refused ({mm}, {k}) x ({k}, {n}): "
                  f"{str(e).splitlines()[0]}")
            library = None
        row = {"case": name, "shape_mkn": [mm, k, n],
               "max_abs_err": float(err),
               **timed(raw, lambda: int8_matmul_reference(
                   xq, None, wq, None, out_dtype=torch.int32), library),
               **bound(mm * k + n * k + 4 * mm * n, 2.0 * mm * n * k,
                       INT8_OP_PER_S)}
        out["int8_matmul_int32"].append(row)
        print("kernel int8_matmul_int32 " + json.dumps(row))
        del xq, wq, got, want

        errs = {"row_amax": 0.0, "quantize_by_amax": 0.0}
        for dtype in (torch.float32, torch.bfloat16):
            whole = row_parallel_input(gen, mm, MESH2_TP * k, dtype)
            x = whole[:, :k].contiguous()      # rank 0's K-slice
            a, a_ref = row_amax(x), row_amax_reference(x)
            amax = row_amax_reference(whole)   # the group's max
            q, sc = quantize_by_amax(x, amax)
            q_ref, sc_ref = quantize_by_amax_reference(x, amax)
            dq, ds = dynamic_quantize(whole)
            torch.cuda.synchronize()
            errs["row_amax"] = max(errs["row_amax"],
                                   (a - a_ref).abs().max().item())
            errs["quantize_by_amax"] = max(
                errs["quantize_by_amax"],
                (q.int() - q_ref.int()).abs().max().item(),
                (sc - sc_ref).abs().max().item())
            checks = {"row_amax": torch.equal(a, a_ref),
                      "quantize_by_amax": torch.equal(q, q_ref)
                      and torch.equal(sc, sc_ref),
                      "the whole row's dynamic_quantize": torch.equal(
                          q, dq[:, :k]) and torch.equal(sc, ds)}
            bad = [c for c, ok in checks.items() if not ok]
            if bad:
                raise AssertionError(f"row-parallel quantize at {name} "
                                     f"({mm}, {k}) {dtype}: differs from "
                                     f"{bad} (errors {errs})")
        x = whole[:, :k].contiguous()          # bf16, as the path's
        e = mm * k
        for kernel, fn, plain, library, nbytes, ops in (
                ("row_amax", lambda: row_amax(x),
                 lambda: row_amax_reference(x),
                 lambda: torch.linalg.vector_norm(x, float("inf"), dim=-1),
                 2 * e + 4 * mm, ROW_AMAX_OPS_PER_ELEMENT * e),
                ("quantize_by_amax", lambda: quantize_by_amax(x, amax),
                 lambda: quantize_by_amax_reference(x, amax), None,
                 2 * e + e + 8 * mm, QUANT_OPS_PER_ELEMENT["none"] * e)):
            row = {"case": name, "shape_mk": [mm, k],
                   "max_abs_err": float(errs[kernel]),
                   **timed(fn, plain, library),
                   **bound(nbytes, ops, FP32_FLOP_PER_S)}
            out[kernel].append(row)
            print(f"kernel {kernel} " + json.dumps(row))
        del whole, x, amax
    return out


def global_draw_ms(seed) -> dict:
    """F2's cost: a data-parallel rank's two draws of a t2i step at the
    served batch (REQUESTS rows, the image span) on a dp 2 and a dp 4 mesh:
    at the global batch's rows, the rank keeping its own (what it draws
    since F2), against its rows alone (what it drew before)."""
    from unidisc_tpu_torch.sampling.sampler import global_rows, gumbel
    m = Config.make("small", **FLAGSHIP_OVERRIDES).model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for dp in (2, 4):
        rows = REQUESTS // dp
        for kind, ranks in (("rank_rows", 1), ("global_rows", dp)):
            def draws():
                with global_rows(0, ranks):
                    gumbel((rows, m.img_length, m.image_vocab_size), gen,
                           "cuda")
                    gumbel((rows, m.img_length), gen, "cuda")
            draws()
            out[f"dp{dp}_{kind}_ms"] = time_ms(draws, iters=50)
    return out


def moe_fp32_accumulation(seed) -> dict:
    """F1 on the card: the bf16 MoE experts' products accumulate in fp32
    and take the fp32 bias before any rounding. Each first product is
    1000 + a small term and b1 = -1000 cancels the 1000: a product rounded
    to bf16 first (a step of 4 at 1000) would leave an error up to 2 in the
    pre-activation. Held to an fp64 reference of the same bf16 operands
    (the GELU output and the result rounded to bf16, as the layer does);
    tests/test_torch_moe.py holds the same check."""
    from unidisc_tpu_torch.models.moe import MoEMLP
    cfg = dataclasses.replace(Config.make("tiny").model, hidden_size=64,
                              mlp_ratio=4, moe_experts=2, moe_top_k=1,
                              moe_capacity_factor=8.0)
    gen = torch.Generator().manual_seed(seed)
    s, d, f = 64, 64, 256
    x = torch.rand((1, s, d), generator=gen) * 2 - 1
    x[..., 0] = 1.0
    w1 = torch.randn((2, d, f), generator=gen) * 0.05
    w1[:, 0, :] = 1000.0
    w2 = torch.randn((2, f, d), generator=gen) / 16
    b2 = torch.randn((2, 1, d), generator=gen) * 0.02
    router = torch.randn((2, d), generator=gen)
    mod = MoEMLP(cfg, compute_dtype=torch.bfloat16).cuda()
    with torch.no_grad():
        for name, value in (("w1", w1), ("w2", w2), ("b2", b2),
                            ("router.weight", router)):
            mod.get_parameter(name).copy_(value)
        mod.b1.fill_(-1000.0)
        y, _ = mod(x.cuda().bfloat16())
    xb = x.bfloat16().double()[0]
    expert = torch.argmax(x[0] @ router.t(), -1)
    h = torch.einsum("sd,sdf->sf", xb, w1.bfloat16().double()[expert]) \
        - 1000.0
    h = F.gelu(h, approximate="tanh").bfloat16().double()
    want = (torch.einsum("sf,sfd->sd", h, w2.bfloat16().double()[expert])
            + b2.double()[expert, 0]).bfloat16().float()
    err = float((y[0].float().cpu() - want).abs().max())
    top = float(want.abs().max())
    if not err <= 2e-2 * top:
        raise AssertionError(f"MoE experts: max abs error {err} > 2e-2 x "
                             f"{top} (a product rounded before its bias?)")
    return {"max_abs_err": err, "max_abs_ref": top}


def mesh_before_world(seed) -> dict:
    """The one-rank parts of phases 5h and 5i, run before their world:
    5h's ring block cases; 5i's kernels at a tensor rank's heads, its
    global draws and the MoE experts' fp32 accumulation."""
    t0 = time.perf_counter()
    out = {"5h": {"blocks": ring_block_cases(seed)}}
    free()
    out["5h"]["before_world_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["5i"] = {"tp_fwd": phase_kernels(seed, [MESH2_TP_CASE])[0],
                 "tp_bwd": phase_bwd_kernels(seed, [MESH2_TP_CASE])[0],
                 "global_draws": global_draw_ms(seed),
                 "moe_fp32_accumulation": moe_fp32_accumulation(seed),
                 "row_parallel": phase_row_parallel_kernels(seed)}
    free()
    out["5i"]["before_world_s"] = time.perf_counter() - t0
    return out


def phase_mesh2(seed, pre, world) -> dict:
    """Phase 5i (module docstring): `pre` its one-rank part
    (mesh_before_world), `world` mesh_worlds' records; its seconds as
    phase_mesh's."""
    t0 = time.perf_counter()
    rec = dict(pre)
    recs = world["5i"]
    rec["world_part_s"] = world["part_s"]["5i"]
    for name in MESH2_TRAIN_MESHES:
        rec[name] = mesh2_train_against_one_rank(name, recs)
    full_precision_gemms()
    try:
        serve = mesh2_serve_against_one_rank(recs, seed)
        rec["mesh2_dp_engine"] = mesh2_dp_engine_against_one_rank(recs, seed)
        int8 = mesh2_int8_against_one_rank(recs, seed)
    finally:
        full_precision_gemms(False)
    for label, (_, _, path) in MESH2_INT8_ENGINES.items():
        rec[path] = {**int8[label], "launches": dict(sum(
            (collections.Counter(r["int8"][label]["launches"])
             for r in recs), collections.Counter()))}
    rec["mesh2_serve"] = {**serve, "launches": dict(sum(
        (collections.Counter(r["serve"]["serve_launches"]) for r in recs),
        collections.Counter()))}
    rec["mesh2_engine"] = {"launches": dict(sum(
        (collections.Counter(r["serve"]["engine_launches"]) for r in recs),
        collections.Counter()))}
    free()
    rec["seconds"] = rec["before_world_s"] + rec["world_part_s"] + \
        time.perf_counter() - t0
    print("mesh2 " + json.dumps({
        "card": card_line(), "seconds": rec["seconds"],
        "before_world_s": rec["before_world_s"],
        "world_part_s": rec["world_part_s"], "ranks": MESH_RANKS,
        "depth": MESH2_BLOCKS,
        "transport": "gloo, staged through host memory",
        "train": {name: {k: rec[name][k] for k in (
            "losses", "one_rank_losses", "grad_norms",
            "one_rank_grad_norms", "loss_rel", "grad_norm_rel",
            "trunk_moment_rel", "trunk_moment_norm", "update_cosine",
            "mesh_s", "path_s", "one_rank_s", "held_params_rank0")}
            for name in MESH2_TRAIN_MESHES},
        "serve": serve, "dp_engine": {
            k: v for k, v in rec["mesh2_dp_engine"].items()
            if k != "launches"},
        "int8": int8, "int8_launches": {
            path: rec[path]["launches"]
            for _, _, path in MESH2_INT8_ENGINES.values()},
        "row_parallel_kernels": {
            kernel: [{k: row[k] for k in (
                "case", "shape_mkn" if "shape_mkn" in row else "shape_mk",
                "ms", "device_ms", "bound_ms", "bound_by", "plain_ms",
                "library_ms")} for row in rows]
            for kernel, rows in rec["row_parallel"].items()},
        "global_draws": rec["global_draws"],
        "moe_fp32_accumulation": rec["moe_fp32_accumulation"],
        "tensor_rank_kernels": {
            "shape_bhld": list(MESH2_TP_CASE[1]),
            "flash_fwd": {k: rec["tp_fwd"][k] for k in (
                "ms", "device_ms", "bound_ms", "plain_ms", "library_ms",
                "library_device_ms")},
            "flash_bwd": {k: rec["tp_bwd"][k] for k in (
                "ms_dq", "ms_dkv", "device_ms_dq", "device_ms_dkv",
                "plain_ms", "library_ms", "library_device_ms", "bounds")}}}))
    return rec


# ---------------------------------------------------------------------------
# 5k: the mesh's other modes (objectives, optimizers, LoRA, MoE under seq)
# ---------------------------------------------------------------------------

# path -> (configuration overrides, mesh), each at the flagship width with
# MESH2_BLOCKS blocks, MESH2_TRAIN_BATCH rows and MESH_TRAIN_STEPS steps
MESH3_PATHS_SPEC = {
    "mesh3_ar": ({**AR_TRAIN_OVERRIDES, "trainer.ar_inpainting": True},
                 dict(dcn=2, fsdp=1, seq=2)),
    "mesh3_joint": ({"trainer.joint_ar_nar_prob": 0.5,
                     "trainer.ar_llm_loss": True},
                    dict(dcn=2, fsdp=1, seq=2)),
    "mesh3_sedd": ({"trainer.parameterization": "sedd"},
                   dict(dcn=2, fsdp=1, tensor=2)),
    "mesh3_d3pm": ({"trainer.parameterization": "d3pm"},
                   dict(dcn=2, fsdp=1, pp=2, pp_microbatches=2)),
    "mesh3_adafactor": ({"trainer.optimizer": "adafactor"},
                        dict(dcn=1, fsdp=1, pp=2, tensor=2,
                             pp_microbatches=2)),
    "mesh3_muon": ({"trainer.optimizer": "muon", "model.mup": True},
                   dict(dcn=2, fsdp=1, tensor=2)),
    "mesh3_lora": ({"model.lora_rank": 16}, dict(dcn=2, fsdp=1, tensor=2)),
    "mesh3_moe": (MOE_OVERRIDES, dict(dcn=1, fsdp=1, seq=2, ep=2)),
}
MESH3_PATHS = tuple(MESH3_PATHS_SPEC)
MESH3_TIMEOUT_S = 240
# LoRA's B redrawn at this scale (the init's zero B leaves the first
# steps' losses blind to the adapter)
MESH3_LORA_B_STD = 0.02
# The paths' limits against the one-rank step (mesh3_train_readings),
# from scripts/mesh2_readings.py on an H100 80GB HBM3 at 700 W. The sound
# tree in bf16 (two runs, equal to every digit): loss gaps <= 1.8e-5,
# gradient-norm gaps <= 8.5e-4, optimizer-state distances <= 6.5e-3,
# cosines >= 0.99961 (the trunk's >= 0.99913; Muon's 0.99792); in fp32
# through the plain attention every path within 3.2e-7, 1.3e-6 and a
# cosine of 1 - 1e-10 (the bf16 gaps are rounding). The MoE under "seq"
# reads 9.7e-5, 5.7e-3, 0.077, 0.980 (trunk 0.961) in bf16 and 2e-7 in
# fp32: a bf16 rounding of a router input flips a near-tie expert choice.
# Eight planted faults (PLANTS of the script, one a path) read: the AR
# targets shifted inside a chunk a loss gap of 157; the loss's tensors
# cut from the wrong rows 0.075; sedd's sigma and d3pm's t from the wrong
# rows 55 and 1.18; Adafactor's statistics over the rank's part a cosine
# of 0.983 (trunk 0.991); Muon's Newton-Schulz on the rank's part a trunk
# cosine of 0.9942; the adapter's gradient parts unsummed a gradient-norm
# gap of 1.0; an MoE rank keeping another chunk's routing 1.5e-3, 0.023,
# 0.34, 0.734.
MESH3_LIMITS = {name: {"loss_rel": 1e-4, "grad_norm_rel": 2e-3,
                       "state_rel": 2e-2, "update_cosine": 0.999,
                       "trunk_update_cosine": 0.998}
                for name in MESH3_PATHS}
MESH3_LIMITS["mesh3_muon"]["trunk_update_cosine"] = 0.996
MESH3_LIMITS["mesh3_moe"] = {"loss_rel": 5e-4, "grad_norm_rel": 1.5e-2,
                             "state_rel": 0.2, "update_cosine": 0.95,
                             "trunk_update_cosine": 0.9}


def mesh3_config(name, plain: bool = False) -> Config:
    """The path's training configuration at depth MESH2_BLOCKS; plain:
    through the plain attention (an fp32 run)."""
    return train_config(**{"model.n_blocks": MESH2_BLOCKS,
                           **MESH3_PATHS_SPEC[name][0],
                           **({"model.attn_backend": "xla"} if plain
                              else {})})


def mesh3_launches(name, cfg, layout, steps) -> dict:
    """flash_fwd / dq / dkv launches of one rank's `steps` steps, from the
    code: under "seq" the flash ring's forward blocks an attention
    (``ring_flash_blocks``: the diagonal and the earlier chunks when
    causal) and no backward kernel (the ring's backward recomputes the
    plain ring); a pp rank its stage's blocks once a microbatch, forward
    and backward; otherwise every block once."""
    from unidisc_tpu_torch.parallel.ring_attention import ring_flash_blocks
    spec = MESH3_PATHS_SPEC[name][1]
    n = cfg.model.n_blocks
    if spec.get("seq", 1) > 1:
        per = ring_flash_blocks(spec["seq"], layout.seq_rank,
                                not cfg.model.full_attention)
        return {"flash_fwd": steps * n * per}
    if spec.get("pp", 1) > 1:
        n = n // spec["pp"] * spec["pp_microbatches"]
    return {k: steps * n for k in ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv")}


def mesh3_setup(cfg, seed, dtype):
    """A path's model with randomize_'s weights, and for LoRA its adapter
    (drawn from the whole base, B redrawn at MESH3_LORA_B_STD) and map:
    (model, param_map, adapter)."""
    from unidisc_tpu_torch.training.lora import (lora_from_config,
                                                 lora_param_map)
    model = mesh2_model(cfg, seed, dtype)
    if cfg.model.lora_rank == 0:
        return model, None, None
    base = dict(model.named_parameters())
    for p in base.values():
        p.requires_grad_(False)
    adapter = lora_from_config(base, cfg.model, seed + 1)
    gen = torch.Generator().manual_seed(seed + 2)
    for k, v in adapter.items():
        if k.endswith(".B"):
            v.copy_(torch.randn(v.shape, generator=gen) * MESH3_LORA_B_STD)
    return model, lora_param_map(base, alpha=cfg.model.lora_alpha,
                                 rank=cfg.model.lora_rank), adapter


def mesh3_state_parts(state, whole=None) -> dict:
    """The optimizer state this rank holds (tensors, by name), or, given
    a one-rank state's state_dict `whole`, this rank's part of it."""
    sd = state._local_state_dict()
    out = {}
    if "mu" in sd:                  # AdamW: the moments by parameter
        for key in ("mu", "nu"):
            if whole is None:
                src = sd[key]
            elif state.shards is None:
                src = whole[key]
            else:
                src = state.shards.scatter(whole[key], state.mesh, {})
            out.update({f"{key}/{n}": t for n, t in src.items()})
        return out
    for k, t in sd["opt_state"].items():
        if t.dim() == 0:
            continue
        if whole is None:
            out[k] = t
        elif state.shards is None:
            out[k] = whole["opt_state"][k]
        else:
            out[k] = state._opt_tensor(k, whole["opt_state"][k], whole=False)
    return out


def rel_distance(mine: dict, ref: dict) -> float:
    """The relative L2 distance of two sets of tensors, in fp64."""
    num = den = 0.0
    for k, r in ref.items():
        num += float((mine[k].double() - r.double()).square().sum())
        den += float(r.double().square().sum())
    return math.sqrt(num / den)


def mesh3_train_rank(rank, world, seed, name, plain=False) -> dict:
    """MESH_TRAIN_STEPS mesh steps of the path `name` on its mesh (plain:
    in fp32 through the plain attention); then on rank 0 the one-rank step
    from the same weights, batch and draws: its losses and gradient norms,
    the two updates' cosine (over the parameters rank 0 holds, or the
    adapter) and the optimizer state's relative distance over rank 0's
    part of it; the cosine also over the trunk alone."""
    from unidisc_tpu_torch.parallel.mesh import make_mesh
    from unidisc_tpu_torch.training.train_state import shard_train_step
    t_start = time.perf_counter()
    dtype = torch.float32 if plain else torch.bfloat16
    cfg = mesh3_config(name, plain)
    mesh_cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
        cfg.mesh, **MESH3_PATHS_SPEC[name][1]))
    model, pmap, adapter = mesh3_setup(cfg, seed, dtype)
    step, state, layout = shard_train_step(
        mesh_cfg, model, make_mesh(mesh_cfg.mesh), param_map=pmap,
        adapter=None if adapter is None else
        {k: v.clone() for k, v in adapter.items()})
    before = {n: p.detach().clone() for n, p in state.params.items()}
    batch = mesh2_batch(cfg, seed)
    _build.reset_launch_counts()
    state, losses, norms, secs = mesh2_steps(step, state, batch, seed)
    launches = dict(_build.launch_counts)
    want = {} if plain else mesh3_launches(name, cfg, layout,
                                           MESH_TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"{name}: rank {rank} launches {launches}, "
                             f"the code {want}")
    rec = {"losses": losses, "grad_norms": norms, "launches": launches,
           "seconds": secs}
    if rank == 0:
        one, one_map, one_adapter = mesh3_setup(cfg, seed, dtype)
        one_state = init_train_state(cfg, one if one_adapter is None
                                     else one_adapter)
        (one_state, rec["one_rank_losses"], rec["one_rank_grad_norms"],
         rec["one_rank_s"]) = mesh2_steps(
            make_train_step(cfg, one, param_map=one_map), one_state, batch,
            seed)
        one_sd = one_state.state_dict()
        ref = one_sd["params"] if state.shards is None else \
            state.shards.scatter(one_sd["params"], layout, {})
        rec["update_cosine"] = update_cosine(state.params, before, ref)
        # the trunk's (or the adapter's) parameters alone: Muon's and
        # Adafactor's block rules act there, where the embeddings' and the
        # head's Adam updates would outweigh them in the whole cosine
        trunk = [n for n in before if "blocks." in n]
        rec["trunk_update_cosine"] = update_cosine(
            state.params, {n: before[n] for n in trunk}, ref)
        rec["state_rel"] = rel_distance(mesh3_state_parts(state),
                                        mesh3_state_parts(state, one_sd))
        del one, one_state, one_sd
    rec["path_s"] = time.perf_counter() - t_start
    return rec


def mesh3_rank_work(rank, world, seed, runs=MESH3_PATHS,
                    plain=False) -> dict:
    """Phase 5k's work on one rank of a started world, with full-precision
    GEMMs: the paths named in `runs` (plain: in fp32 through the plain
    attention)."""
    full_precision_gemms()
    rec = {}
    for name in runs:
        rec[name] = mesh3_train_rank(rank, world, seed, name, plain)
        free()
    return rec


def mesh3_world(seed, runs=MESH3_PATHS, plain=False):
    """Phase 5k's work alone on a world of MESH_RANKS spawned ranks; their
    records by rank."""
    return [r["5k"] for r in spawn_world(
        (("5k", mesh3_rank_work, (seed, runs, plain)),), MESH3_TIMEOUT_S,
        "5k")]


def mesh_worlds(seed) -> dict:
    """Phases 5h, 5i, 5k and 5l on one world of MESH_RANKS spawned ranks
    (one start-up of the ranks, not four), 5l's one-rank references made
    in this process meanwhile: each phase's records by rank, the
    references, each part's seconds on rank 0 (after a barrier) and the
    world's seconds."""
    t0 = time.perf_counter()
    during = mesh4_during(seed)
    recs = spawn_world((("5h", mesh_rank_work, (seed,)),
                        ("5i", mesh2_rank_work, (seed,)),
                        ("5k", mesh3_rank_work, (seed,)),
                        ("5l", mesh4_rank_work, (seed,))),
                       MESH_TIMEOUT_S + MESH2_TIMEOUT_S + MESH3_TIMEOUT_S
                       + MESH4_TIMEOUT_S, "5h-5l", during)
    out = {part: [r[part] for r in recs]
           for part in ("5h", "5i", "5k", "5l")}
    out["5l_references"] = during.result
    out["references_s"] = during.seconds
    out["part_s"] = recs[0]["part_s"]
    out["world_s"] = time.perf_counter() - t0
    print("mesh_world " + json.dumps({
        "card": card_line(), "world_s": out["world_s"],
        "part_s": out["part_s"], "start_and_exit_s": out["world_s"]
        - sum(out["part_s"].values()),
        "references_meanwhile_s": out["references_s"]}))
    return out


def mesh3_train_readings(name, recs) -> dict:
    """A path against the one-rank step (rank 0 ran it on the same
    weights, batch and draws): the largest relative gap of any rank's
    losses and gradient norms, the update's cosine and the optimizer
    state's relative distance over rank 0's part."""
    r0 = recs[0][name]
    return {
        "loss_rel": max(rel_gap(rec[name]["losses"], r0["one_rank_losses"])
                        for rec in recs),
        "grad_norm_rel": max(rel_gap(rec[name]["grad_norms"],
                                     r0["one_rank_grad_norms"])
                             for rec in recs),
        "state_rel": r0["state_rel"], "update_cosine": r0["update_cosine"],
        "trunk_update_cosine": r0["trunk_update_cosine"]}


def mesh3_against_one_rank(name, recs) -> dict:
    """A path held to the one-rank step: each reading of
    mesh3_train_readings within MESH3_LIMITS."""
    r0 = recs[0][name]
    readings = mesh3_train_readings(name, recs)
    for key, limit in MESH3_LIMITS[name].items():
        ok = readings[key] >= limit if key.endswith("cosine") \
            else readings[key] <= limit
        if not ok:
            raise AssertionError(f"{name}: {key} {readings[key]} against "
                                 f"the limit {limit} (losses "
                                 f"{r0['losses']}, one rank "
                                 f"{r0['one_rank_losses']})")
    return {**readings, "losses": r0["losses"],
            "one_rank_losses": r0["one_rank_losses"],
            "grad_norms": r0["grad_norms"],
            "one_rank_grad_norms": r0["one_rank_grad_norms"],
            "mesh_s": [rec[name]["seconds"] for rec in recs],
            "path_s": r0["path_s"], "one_rank_s": r0["one_rank_s"],
            "launches": dict(sum((collections.Counter(rec[name]["launches"])
                                  for rec in recs), collections.Counter()))}


def phase_mesh3(world) -> dict:
    """Phase 5k (module docstring), on mesh_worlds' records; its seconds
    are its part of the world and its checks after."""
    t0 = time.perf_counter()
    recs = world["5k"]
    rec = {"world_part_s": world["part_s"]["5k"]}
    for name in MESH3_PATHS:
        rec[name] = mesh3_against_one_rank(name, recs)
    rec["seconds"] = rec["world_part_s"] + time.perf_counter() - t0
    print("mesh3 " + json.dumps({
        "card": card_line(), "seconds": rec["seconds"],
        "world_part_s": rec["world_part_s"], "ranks": MESH_RANKS,
        "depth": MESH2_BLOCKS, "batch": MESH2_TRAIN_BATCH,
        "steps": MESH_TRAIN_STEPS,
        "transport": "gloo, staged through host memory",
        "train": {name: {k: v for k, v in rec[name].items()
                         if k != "launches"} for name in MESH3_PATHS}}))
    return rec


# ---------------------------------------------------------------------------
# 5l: rolling admission and AR decoding in a mesh engine
# ---------------------------------------------------------------------------

MESH4_SPEC = "fsdp=2,seq=2"
MESH4_PP_SPEC = "pp=2,tensor=2,pp_microbatches=2"
MESH4_OVERRIDES = {**FLAGSHIP_OVERRIDES, "model.n_blocks": MESH2_BLOCKS}
MESH4_AR_OVERRIDES = {**FLAGSHIP_OVERRIDES, **AR_OVERRIDES,
                      "model.n_blocks": MESH2_BLOCKS}
MESH4_ROLLING = 12        # requests: 8 t2i, 2 captions (3rd, 9th), 2 infills
MESH4_STEPS = (32, 8)     # the requests' denoise steps, alternating
MESH4_GAP_S = 0.05        # the requests arrive this far apart
MESH4_WAIT_S = 60         # a request unanswered by then counts as wrong
MESH4_AR_NEW = 32         # new tokens a completion
MESH4_AR_SHARED = 128     # the shared prefix of two AR prompts
# the DIT-AR on fsdp 2 x seq 2 against one rank in bf16: the mean over the
# completions of the share of the one-rank tokens before the first that
# differs (a flipped near tie changes the rest of its completion). Set
# from the readings of scripts/mesh2_readings.py --runs 5l: sound 0.958
# and 1.0, the planted faults 0.583-0.625; the exact gate is fp64's
MESH4_AR_AGREEMENT = 0.8
# rolling t2i on pp 2 x tensor 2 against one rank in bf16: the
# row-parallel products' partial sums round apart from one rank's single
# product, and a flip early in a request cascades over its reveals. The
# readings: sound 0.9795 and 0.9834 (4 requests, 1,024 positions), the
# planted faults 0.827-0.865; the pipeline's and the tensor ranks' fp32
# exactness is phase 5i's (its sampler and engine on pp 2 x tensor 2)
MESH4_PP_AGREEMENT = 0.95
# each path's token agreement with one rank: bf16 near ties may flip
# (the rolling samplers' reveals cascade over the steps); fp32 through the
# plain attention equal token for token for rolling; the AR paths in
# fp64, whose K/V cache stays bf16 as served: in fp32 a decode product of
# 4 rows and one of 8 round apart, and the bf16 cache widens that to a
# flip (the readings: 0.88)
MESH4_LIMITS = {"rolling_bf16": MESH_TOKEN_AGREEMENT, "rolling_fp32": 1.0,
                "rolling_pp_bf16": MESH4_PP_AGREEMENT,
                "ar_bf16": MESH4_AR_AGREEMENT,
                "ar_fp64": 1.0, "ar_lookup_fp64": 1.0}
MESH4_RUNS = ("mesh4_rolling", "mesh4_rolling_pp", "mesh4_ar")
MESH4_TIMEOUT_S = 300


def mesh4_rolling_requests(engine, seed) -> list:
    """(kind, prepared, steps, seed) of the rolling runs: MESH4_ROLLING
    requests, t2i but a caption at i % 6 == 2 and an infill (the image's
    second half regenerated with a masked text span) at i % 6 == 5, steps
    alternating MESH4_STEPS, each its own seed."""
    m = engine.m
    rng = np.random.RandomState(seed)
    mask = np.zeros(m.img_length, bool)
    mask[m.img_length // 2:] = True
    out = []
    for i in range(MESH4_ROLLING):
        if i % 6 == 2:
            kind, kw = "caption", dict(image_ids=rng.randint(
                0, m.image_vocab_size, m.img_length))
        elif i % 6 == 5:
            kind, kw = "infill", dict(
                text="a <mask:6> harbour at dusk", image_mask=mask,
                image_ids=rng.randint(0, m.image_vocab_size, m.img_length))
        else:
            kind, kw = "t2i", dict(
                text=f"a watercolor painting of a lighthouse, variant {i}")
        out.append((kind, engine.prepare(**kw), MESH4_STEPS[i % 2],
                    1000 * seed + i))
    return out


def mesh4_led(engine, rank, lead_fn) -> dict:
    """Rank 0 leads `engine` through lead_fn(engine) and shuts it down
    (its batchers' workers, then the followers); the other ranks follow
    until then. {"lead": lead_fn's result on rank 0, "replayed": the ops
    a follower replayed}."""
    out = {"lead": None, "replayed": 0}
    if rank == 0:
        engine.lead()
        try:
            out["lead"] = lead_fn(engine)
        finally:
            engine.shutdown()
        return out
    replay = engine._batcher_op

    def counted(route, op, kw):
        out["replayed"] += 1
        return replay(route, op, kw)
    engine._batcher_op = counted
    engine.follow()
    return out


def mesh4_serve_rolling(engine, reqs, gap_s) -> dict:
    """Each request of `reqs` through engine.run_batch alone, on its own
    thread, started gap_s apart; at most MESH4_WAIT_S for the last. Per
    request its image ids and text, or None with the error where it was
    not answered (the gate counts it wrong), and its latency."""
    n = len(reqs)
    results, latency, errors = [None] * n, [None] * n, [None] * n

    def run(i, prepared, steps, seed):
        t0 = time.perf_counter()
        try:
            r = engine.run_batch([prepared], steps=steps, seed=seed)[0]
        except Exception as e:  # noqa: BLE001 — recorded; the gate fails
            errors[i] = f"{type(e).__name__}: {e}"
            return
        latency[i] = time.perf_counter() - t0
        results[i] = {"image_ids": r["image_ids"][0], "text": r["text"]}

    threads = []
    for i, (_, prepared, steps, seed) in enumerate(reqs):
        t = threading.Thread(target=run, args=(i, prepared, steps, seed),
                             daemon=True)
        t.start()
        threads.append(t)
        time.sleep(gap_s)
    deadline = time.monotonic() + MESH4_WAIT_S
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    return {"results": results, "latency_s": latency, "errors": errors}


def mesh4_agreement(got, want, reqs, txt_length) -> float:
    """The share of generated positions equal to the one-rank engine's:
    the image ids a t2i or infill request generates, a caption's text
    characters; an unanswered request counts every position unequal."""
    eq = tot = 0
    for g, w, (kind, prepared, _, _) in zip(got, want, reqs):
        if kind == "caption":
            a, b = ("" if g is None else g["text"]), w["text"]
            tot += max(len(a), len(b))
            eq += sum(x == y for x, y in zip(a, b))
            continue
        gen = ~prepared["unmask"][txt_length:]
        tot += int(gen.sum())
        if g is not None:
            eq += int(((g["image_ids"] == w["image_ids"]) & gen).sum())
    return eq / tot


def mesh4_rolling_launches(engine) -> dict:
    """The code's count of the rolling batchers' launches on this rank: a
    captured chunk's warm run and its replays, an eager one each chunk,
    ROLL_CHUNK forwards a chunk; none through the plain attention."""
    total = collections.Counter()
    if engine.m.attn_backend == "xla":
        return {}
    for kind, b in engine._rolling.items():
        runs = (1 + b.program.replays) if b.program is not None \
            else b.chunks
        per = chunk_launches(engine.m, engine.config.sampling, kind == "t2i")
        total.update({k: v * runs for k, v in per.items()})
    return dict(total)


def mesh4_one_rank_rolling(engine, reqs) -> list:
    """The one-rank rolling `engine`'s results for reqs, every request at
    once; the engine shut down after."""
    try:
        return mesh4_serve_rolling(engine, reqs, 0.0)["results"]
    finally:
        engine.shutdown()


def mesh4_rolling_part(rank, engine, reqs, gap_s) -> dict:
    """`engine` (a rolling mesh engine) led through reqs; this rank's
    launches against the code's, its programs, counters and seconds."""
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rec = mesh4_led(engine, rank,
                    lambda e: mesh4_serve_rolling(e, reqs, gap_s))
    torch.cuda.synchronize()
    rec.update(seconds=time.perf_counter() - t0,
               launches=dict(_build.launch_counts),
               want_launches=mesh4_rolling_launches(engine),
               captured={k: b.program is not None
                         for k, b in engine._rolling.items()},
               counters={k: {"chunks": b.chunks, "harvests": b.harvests,
                             "row_reads": b.row_reads}
                         for k, b in engine._rolling.items()})
    return rec


def exact_engine(cfg, weights, mesh=None, dtype=torch.float32, **kw):
    """An InferenceEngine computing in `dtype` (fp32 or fp64) through the
    plain attention over `weights` (a whole state dict), on `mesh` (a
    DeviceMesh; its rank's parts kept) or one rank."""
    cfg = cfg.override(**{"model.attn_backend": "xla"})
    model = DIT(cfg.model, compute_dtype=dtype, init=False).cuda()
    model.load_state_dict(weights)
    return InferenceEngine(cfg, model, mesh=mesh, **kw)


def mesh4_rolling_rank(rank, world, seed) -> dict:
    """(a): the flagship at depth MESH2_BLOCKS rolling on fsdp 2 x seq 2:
    bf16 (build_engine) with the staggered requests, and fp32 through
    the plain attention with the t2i ones at 8 steps at once (both data
    ranks' slots)."""
    engine = build_engine(preset="small", overrides=MESH4_OVERRIDES,
                          mesh=MESH4_SPEC, rolling=ROLL_SLOTS)
    randomize_(engine.model, seed)
    mesh, cfg = engine.mesh.mesh, engine.config
    reqs = mesh4_rolling_requests(engine, seed)
    rec = {"bf16": mesh4_rolling_part(rank, engine, reqs, MESH4_GAP_S)}
    weights = engine.model.state_dict()
    free(engine)
    del engine
    engine32 = exact_engine(cfg, weights, mesh, rolling=ROLL_SLOTS)
    rec["fp32"] = mesh4_rolling_part(rank, engine32, mesh4_fp32_requests(
        reqs), 0.0)
    free(engine32)
    return rec


def mesh4_fp32_requests(reqs) -> list:
    """(a)'s t2i requests at 8 steps: the fp32 run's."""
    return [(k, p, MESH4_STEPS[1], s) for k, p, _, s in reqs if k == "t2i"]


def mesh4_pp_requests(reqs) -> list:
    """(a)'s four 8-step t2i requests: (b)'s."""
    return [r for r in reqs if r[0] == "t2i" and r[2] == MESH4_STEPS[1]]


def mesh4_rolling_pp_rank(rank, world, seed) -> dict:
    """(b): rolling t2i on pp 2 x tensor 2 (eager chunks), bf16
    (build_engine), the one-rank weights' parts on each rank, (a)'s
    four 8-step t2i requests staggered."""
    engine = build_engine(preset="small", overrides=MESH4_OVERRIDES,
                          mesh=MESH4_PP_SPEC, rolling=ROLL_SLOTS)
    mine = engine.model.mesh_shards.scatter(
        mesh2_weights(engine.config, seed), engine.mesh, {})
    with torch.no_grad():
        for n, p in engine.model.named_parameters():
            if n in mine:
                p.copy_(mine[n])
    del mine
    reqs = mesh4_pp_requests(mesh4_rolling_requests(engine, seed))
    rec = {"bf16": mesh4_rolling_part(rank, engine, reqs, MESH4_GAP_S)}
    free(engine)
    return rec


def mesh4_ar_requests(seed) -> list:
    """The DIT-AR's 8 completions (text, new tokens): prompts of 16-256
    tokens (with the BOS), the first two sharing MESH4_AR_SHARED, greedy,
    MESH4_AR_NEW new tokens each."""
    rng = np.random.RandomState(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)

    def text(n):
        return bytes(rng.choice(letters, n)).decode()

    shared = text(MESH4_AR_SHARED - 1)
    bodies = [shared + text(16), shared + text(40)] + [
        text(n - 1) for n in (16, 256, 64, 32, 200, 96)]
    return [(b, MESH4_AR_NEW) for b in bodies]


def mesh4_complete(engine, reqs) -> dict:
    """The completions of `reqs` through engine.complete_text, streamed:
    the first alone (its prompt then resident in slot 0), the rest at
    once; at most MESH4_WAIT_S. Per request its tokens (None where not
    answered), the streamed ids and the latency; the batcher's chunks,
    drains and prefix hits."""
    n = len(reqs)
    tokens, streams, latency = [None] * n, [[] for _ in range(n)], [None] * n
    errors = [None] * n

    def submit(i):
        t0 = time.perf_counter()
        text, new = reqs[i]
        fut = engine.complete_text(text, max_new_tokens=new,
                                   stream_cb=streams[i].extend)

        def done(f):
            latency[i] = time.perf_counter() - t0
            if f.exception() is not None:
                errors[i] = repr(f.exception())
            else:
                tokens[i] = f.result()["tokens"]
        fut.add_done_callback(done)
        return fut

    deadline = time.monotonic() + MESH4_WAIT_S
    concurrent.futures.wait([submit(0)], timeout=MESH4_WAIT_S)
    futs = [submit(i) for i in range(1, n)]
    concurrent.futures.wait(futs, timeout=max(0.0, deadline
                                              - time.monotonic()))
    b = engine.continuous
    return {"tokens": tokens, "streams": [list(s) for s in streams],
            "latency_s": latency, "errors": errors, "chunks": b.chunks,
            "drains": b.host_reads, "prefix_hits": b.prefix_hits}


def mesh4_ar_agreement(got, want) -> float:
    """The mean over the completions of the share of the one-rank tokens
    before the first that differs (an unanswered completion: 0; extra
    tokens count as differing)."""
    shares = []
    for g, w in zip(got, want):
        g = g or []
        same = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                    min(len(g), len(w)))
        shares.append(same / max(len(g), len(w), 1))
    return float(np.mean(shares))


def mesh4_ar_part(rank, engine, reqs) -> dict:
    """`engine` (an AR mesh engine) led through reqs (``mesh4_complete``);
    this rank's launches (the DIT-AR's cached attention is the plain one:
    none), whether its decode chunk is captured, its seconds."""
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rec = mesh4_led(engine, rank, lambda e: mesh4_complete(e, reqs))
    torch.cuda.synchronize()
    rec.update(seconds=time.perf_counter() - t0,
               launches=dict(_build.launch_counts),
               captured=engine.continuous.program is not None)
    return rec


def mesh4_ar_rank(rank, world, seed) -> dict:
    """(c): the DIT-AR of phase 4g (at MESH2_BLOCKS) on fsdp 2 x seq 2,
    greedy: bf16 plain (build_engine), then fp64 plain and with prompt
    lookup (2-grams)."""
    engine = build_engine(preset="small", overrides=MESH4_AR_OVERRIDES,
                          mesh=MESH4_SPEC)
    randomize_(engine.model, seed)
    mesh, cfg = engine.mesh.mesh, engine.config
    reqs = mesh4_ar_requests(seed)
    rec = {"bf16": mesh4_ar_part(rank, engine, reqs)}
    weights = engine.model.state_dict()
    free(engine)
    del engine
    for name, kw in MESH4_AR_EXACT:
        eng = exact_engine(cfg, weights, mesh, dtype=torch.float64, **kw)
        rec[name] = mesh4_ar_part(rank, eng, reqs)
        free(eng)
    return rec


# the DIT-AR's exact runs: (name, the engine's decoding arguments)
MESH4_AR_EXACT = (("fp64", {}), ("lookup_fp64", {"lookup_ngram": 2}))


def mesh4_references(seed, runs=MESH4_RUNS) -> dict:
    """The one-rank engines' runs of 5l's requests on the same weights
    (this process, while the ranks run): by path, the requests and the
    results."""
    out = {}
    if {"mesh4_rolling", "mesh4_rolling_pp"} & set(runs):
        engine = build_engine(preset="small", overrides=MESH4_OVERRIDES,
                              rolling=ROLL_SLOTS)
        randomize_(engine.model, seed)
        reqs = mesh4_rolling_requests(engine, seed)
        weights = engine.model.state_dict()
        want = mesh4_one_rank_rolling(engine, reqs)
        by_seed = dict(zip((r[3] for r in reqs), want))
        out["rolling_bf16"] = (reqs, want)
        pp = mesh4_pp_requests(reqs)
        out["rolling_pp_bf16"] = (pp, [by_seed[r[3]] for r in pp])
        free(engine)
        del engine
        reqs32 = mesh4_fp32_requests(reqs)
        out["rolling_fp32"] = (reqs32, mesh4_one_rank_rolling(exact_engine(
            engine_cfg(MESH4_OVERRIDES), weights, rolling=ROLL_SLOTS),
            reqs32))
        free()
    if "mesh4_ar" in runs:
        engine = build_engine(preset="small", overrides=MESH4_AR_OVERRIDES)
        randomize_(engine.model, seed)
        reqs = mesh4_ar_requests(seed)
        weights = engine.model.state_dict()
        out["ar_bf16"] = (reqs, mesh4_complete(engine, reqs))
        engine.shutdown()
        free(engine)
        del engine
        for name, kw in MESH4_AR_EXACT:
            one = exact_engine(engine_cfg(MESH4_AR_OVERRIDES), weights,
                               dtype=torch.float64, **kw)
            out[f"ar_{name}"] = (reqs, mesh4_complete(one, reqs))
            one.shutdown()
            free(one)
    return out


def mesh4_during(seed, runs=MESH4_RUNS):
    """The work a 5l world's spawn_world does meanwhile: the one-rank
    references (``mesh4_references``) with full-precision GEMMs, as the
    ranks compute; its seconds in ``.seconds``."""
    def during():
        t = time.perf_counter()
        full_precision_gemms()
        try:
            return mesh4_references(seed, runs)
        finally:
            full_precision_gemms(False)
            during.seconds = time.perf_counter() - t
    return during


def engine_cfg(overrides) -> Config:
    """The config build_engine makes of the "small" preset and
    `overrides`."""
    return Config.make("small", **overrides)


def mesh4_rank_work(rank, world, seed, runs=MESH4_RUNS) -> dict:
    """Phase 5l's work on one rank of a started world, with full-precision
    GEMMs: the runs named in `runs`."""
    full_precision_gemms()
    rec = {}
    t0 = time.perf_counter()
    if "mesh4_rolling" in runs:
        rec["mesh4_rolling"] = mesh4_rolling_rank(rank, world, seed)
        free()
    if "mesh4_rolling_pp" in runs:
        rec["mesh4_rolling_pp"] = mesh4_rolling_pp_rank(rank, world, seed)
        free()
    if "mesh4_ar" in runs:
        rec["mesh4_ar"] = mesh4_ar_rank(rank, world, seed)
        free()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def mesh4_world(seed, runs=MESH4_RUNS):
    """Phase 5l's work alone on a world of MESH_RANKS spawned ranks, and
    its one-rank references made meanwhile: (the ranks' records, the
    references)."""
    during = mesh4_during(seed, runs)
    recs = spawn_world((("5l", mesh4_rank_work, (seed, runs)),),
                       MESH4_TIMEOUT_S, "5l", during)
    return [r["5l"] for r in recs], during.result


# (the gate's path name, the run, the part of the run's record)
MESH4_GATES = (("rolling_bf16", "mesh4_rolling", "bf16"),
               ("rolling_fp32", "mesh4_rolling", "fp32"),
               ("rolling_pp_bf16", "mesh4_rolling_pp", "bf16"),
               ("ar_bf16", "mesh4_ar", "bf16"),
               ("ar_fp64", "mesh4_ar", "fp64"),
               ("ar_lookup_fp64", "mesh4_ar", "lookup_fp64"))


def mesh4_readings(recs, refs, runs=MESH4_RUNS) -> dict:
    """What phase 5l holds to its gates, per path: the token agreement
    with the one-rank engine (`refs`, ``mesh4_references``), the
    unanswered requests, whether every rank captured its chunk programs
    (the pp path: ran them eager), whether every rank's launches are the
    code's count; for the AR paths the stream against the tokens and the
    prefix hits; the path's seconds on rank 0."""
    out = {}
    for name, run, part in MESH4_GATES:
        if run not in runs:
            continue
        lead = recs[0][run][part]
        ar = run == "mesh4_ar"
        reqs, want = refs[name]
        if ar:
            got = lead["lead"]["tokens"]
            agreement = mesh4_ar_agreement(got, want["tokens"])
        else:
            got = lead["lead"]["results"]
            agreement = mesh4_agreement(got, want, reqs,
                                        Config.make("small", **MESH4_OVERRIDES)
                                        .model.txt_length)
        r = {"token_agreement": agreement,
             "unanswered": sum(g is None for g in got),
             "errors": [e for e in lead["lead"]["errors"] if e],
             "captured": [rec[run][part]["captured"] if ar else
                          all(rec[run][part]["captured"].values())
                          for rec in recs],
             "launches_exact": all(
                 rec[run][part]["launches"] == ({} if ar else
                                                rec[run][part][
                                                    "want_launches"])
                 for rec in recs),
             "seconds": lead["seconds"]}
        if ar:
            r.update(streams_equal=lead["lead"]["streams"] == [
                t or [] for t in got],
                prefix_hits=lead["lead"]["prefix_hits"],
                one_rank_prefix_hits=want["prefix_hits"])
        out[name] = r
    return out


def phase_mesh4(world) -> dict:
    """Phase 5l (module docstring), on mesh_worlds' records: each path's
    readings within its gate; its seconds are its part of the world and
    its checks after."""
    t0 = time.perf_counter()
    recs = world["5l"]
    readings = mesh4_readings(recs, world["5l_references"])
    for name, r in readings.items():
        bad = [what for what, ok in (
            (f"token agreement {r['token_agreement']} < "
             f"{MESH4_LIMITS[name]}",
             r["token_agreement"] >= MESH4_LIMITS[name]),
            ("launches off the code's count", r["launches_exact"]),
            (f"programs captured {r['captured']}",
             not any(r["captured"]) if name.startswith("rolling_pp")
             else all(r["captured"])),
            ("the stream differs from the tokens",
             r.get("streams_equal", True)),
            ("no prefix hit", r.get("prefix_hits", 1) >= 1),
        ) if not ok]
        if bad:
            raise AssertionError(f"mesh4 {name}: {'; '.join(bad)} "
                                 f"({r['errors'][:3]})")
    r0 = recs[0]

    def lat(values):
        v = np.asarray([x for x in values if x is not None])
        return {"p50_s": float(np.percentile(v, 50)),
                "p95_s": float(np.percentile(v, 95))}

    counters = {}
    for name, run, part in MESH4_GATES:
        lead = r0[run][part]
        counters[name] = ({k: lead["lead"][k] for k in
                           ("chunks", "drains", "prefix_hits")}
                          if run == "mesh4_ar" else lead["counters"])
    rec = {"readings": readings, "world_part_s": world["part_s"]["5l"],
           "latency": {name: lat(r0[run][part]["lead"]["latency_s"])
                       for name, run, part in MESH4_GATES},
           "counters": counters,
           "replayed_ops": {name: [rec[run][part]["replayed"]
                                   for rec in recs[1:]]
                            for name, run, part in MESH4_GATES},
           "rank0_s": r0["seconds"]}
    # the kernels line's paths: the bf16 runs' launches, summed over the
    # ranks (the fp32 paths run the plain attention)
    for run in MESH4_RUNS:
        rec[run] = {"launches": dict(sum(
            (collections.Counter(r[run]["bf16"]["launches"]) for r in recs),
            collections.Counter()))}
    rec["seconds"] = rec["world_part_s"] + time.perf_counter() - t0
    print("mesh4 " + json.dumps({
        "card": card_line(), "seconds": rec["seconds"],
        "world_part_s": rec["world_part_s"], "ranks": MESH_RANKS,
        "depth": MESH2_BLOCKS, "slots": ROLL_SLOTS,
        "transport": "gloo, staged through host memory",
        **{k: rec[k] for k in ("readings", "latency", "counters",
                               "replayed_ops", "rank0_s")}}))
    return rec


# ---------------------------------------------------------------------------
# 5j: evaluation (eval_run on phase 5's run dir)
# ---------------------------------------------------------------------------

EVAL_BATCH = 16          # eval_run's --batch: the val and generated rows
EVAL_VAL_BATCHES = 4     # --max-batches
EVAL_GEN_BATCHES = 2     # --gen-batches: the timed sampler calls
EVAL_REF_ROWS = 32       # shard rows decoded into the FID reference
EVAL_VAL_RTOL = 1e-5     # val/nll against Trainer.validate: the same
#                          kernels, weights and draws
EVAL_FID_RTOL = 1e-3     # FID over random_conv, card against CPU (fp32)
JUDGE_TOL = 1e-4         # the judges card against CPU, fp32 on both sides
#                          (TF32 off): relative to the largest magnitude
JUDGE_LAYERS = 2
# the judges at their published widths (the config.json of HF's
# clip-vit-large-patch14 and gpt2-large), JUDGE_LAYERS layers a tower
CLIP_L14 = {"projection_dim": 768,
            "text_config": {"hidden_size": 768, "intermediate_size": 3072,
                            "num_attention_heads": 12,
                            "num_hidden_layers": JUDGE_LAYERS,
                            "max_position_embeddings": 77,
                            "vocab_size": 49408, "eos_token_id": 2},
            "vision_config": {"hidden_size": 1024,
                              "intermediate_size": 4096,
                              "num_attention_heads": 16,
                              "num_hidden_layers": JUDGE_LAYERS,
                              "image_size": 224, "patch_size": 14}}
GPT2_LARGE = {"n_embd": 1280, "n_head": 20, "n_layer": JUDGE_LAYERS,
              "n_positions": 1024, "vocab_size": 50257}
# the served sampling of the flagship, which the run dir's snapshot (a
# training config) lacks
FLAGSHIP_SAMPLING = {k: v for k, v in FLAGSHIP_OVERRIDES.items()
                     if k.startswith("sampling.")}
EVAL_PATHS = ("eval",)


def learn_merges(words: list, n: int) -> list:
    """n BPE merges learned greedily from words (lists of symbols)."""
    merges = []
    for _ in range(n):
        counts = collections.Counter(
            pair for w in words for pair in zip(w, w[1:]))
        if not counts:
            break
        best = counts.most_common(1)[0][0]
        merges.append(best)
        out = []
        for w in words:
            new, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    new.append(w[i] + w[i + 1])
                    i += 2
                else:
                    new.append(w[i])
                    i += 1
            out.append(new)
        words = out
    return merges


def write_bpe(path, texts, clip: bool) -> None:
    """A byte-level BPE in HF's files: the 256 byte symbols (CLIP: and
    their word-final forms), 64 merges learned from `texts`, the end token
    at the published id (CLIP: 49407 after the start token 49406; GPT-2:
    50256)."""
    bm = bytes_to_unicode()
    syms = [bm[b] for b in range(256)]
    words = []
    for t in texts:
        for w in t.lower().split() if clip else t.split():
            s = [bm[b] for b in w.encode()]
            words.append(s[:-1] + [s[-1] + "</w>"] if clip else s)
    vocab = {s: i for i, s in enumerate(
        syms + ([s + "</w>" for s in syms] if clip else []))}
    merges = learn_merges(words, 64)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    if clip:
        vocab.update({"<|startoftext|>": 49406, "<|endoftext|>": 49407})
    else:
        vocab["<|endoftext|>"] = 50256
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n"
                                            for a, b in merges))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "CLIPTokenizer" if clip else
                   "GPT2Tokenizer",
                   "model_max_length": 77 if clip else 1024}, f)


def judge_init_(module, seed: int) -> None:
    """Random judge weights from a seed: matrices N(0, 0.02), norm scales
    1, every other vector 0."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
            elif name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()


def write_judge_assets(root, texts, seed) -> str:
    """An asset dir with the CLIP and GPT-2 judges at their published
    widths (JUDGE_LAYERS layers of random weights), in HF's files
    (config.json, pytorch_model.bin, the BPE files); no inception file, so
    eval_run's FID takes the random-conv fallback."""
    from unidisc_tpu_torch.eval.judge_nets import (CLIP_PREPROCESS,
                                                   CLIPModel,
                                                   GPT2LMHeadModel)
    base = os.path.join(root, "assets")
    for name, conf, cls, clip in (
            ("clip-vit-large-patch14", CLIP_L14, CLIPModel, True),
            ("gpt2-large", GPT2_LARGE, GPT2LMHeadModel, False)):
        path = os.path.join(base, name)
        os.makedirs(path)
        model = cls(conf)
        judge_init_(model, seed)
        torch.save(model.state_dict(),
                   os.path.join(path, "pytorch_model.bin"))
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(conf, f)
        if clip:
            with open(os.path.join(path, "preprocessor_config.json"),
                      "w") as f:
                json.dump(CLIP_PREPROCESS, f)
        write_bpe(path, texts, clip)
        del model
    return base


def blob_images(n: int, seed: int, size: int) -> np.ndarray:
    """n images in [-1, 1]: a square of a random colour at a random place
    on black."""
    rng = np.random.RandomState(seed)
    imgs = np.full((n, size, size, 3), -1.0, np.float32)
    r = size // 8
    for img in imgs:
        cx, cy = rng.randint(size // 4, 3 * size // 4, 2)
        img[cy - r:cy + r, cx - r:cx + r] = rng.uniform(-1, 1, 3)
    return imgs


def eval_run_dir(run_dir, root) -> str:
    """Phase 5's latest checkpoint in a run dir of its own whose snapshot
    samples as the flagship serves (FLAGSHIP_SAMPLING)."""
    out = os.path.join(root, "eval_run")
    src = os.path.join(run_dir, "checkpoints", str(TRAIN_STEPS))
    dst = os.path.join(out, "checkpoints", str(TRAIN_STEPS))
    shutil.copytree(src, dst)
    with open(os.path.join(dst, "meta.json")) as f:
        meta = json.load(f)
    for key, value in FLAGSHIP_SAMPLING.items():
        meta["config"]["sampling"][key.split(".", 1)[1]] = value
    with open(os.path.join(dst, "meta.json"), "w") as f:
        json.dump(meta, f)
    return out


def judge_agreement(assets, images, texts) -> dict:
    """The CLIP and GPT-2 judges on the card against the CPU on the same
    inputs (fp32 on both sides): CLIP's image embeddings and scores,
    GPT-2's NLLs and embeddings; and the forward times of each judge's
    network on the card (CUDA events; the score call's host work, the
    tokenizer and the image processor, outside them)."""
    from unidisc_tpu_torch.eval import judges
    from unidisc_tpu_torch.eval.judge_nets import load_gpt2
    out = {}

    def gate(what, got, want):
        got = torch.as_tensor(np.asarray(got)).double()
        want = torch.as_tensor(np.asarray(want)).double()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if not err <= JUDGE_TOL * scale:
            raise AssertionError(f"{what}: card vs CPU {err} > "
                                 f"{JUDGE_TOL} x {scale}")
        out[f"{what}_max_abs_err"] = err

    clip_dir = os.path.join(assets, "clip-vit-large-patch14")
    clip = {dev: judges.ClipJudge(clip_dir, dev) for dev in ("cuda", "cpu")}
    gate("clip_image_embeds", clip["cuda"].image_embeds(images).cpu(),
         clip["cpu"].image_embeds(images))
    gate("clip_score", clip["cuda"].score(images, texts),
         clip["cpu"].score(images, texts))
    judge = clip["cuda"]
    pixels = judge.pixels(images)
    enc = judge.tokenizer(texts, padding="longest", truncation=True)
    ids = torch.from_numpy(enc["input_ids"]).cuda()
    mask = torch.from_numpy(enc["attention_mask"]).cuda()
    with torch.no_grad():
        out["clip_forward_ms"] = time_ms(
            lambda: judge.model(ids, pixels, mask), iters=10, warmup=2)
    out["clip_batch"] = len(texts)
    del clip, judge, pixels
    nll = {dev: judges.judge_lm(assets, device=dev) for dev in ("cuda",
                                                                "cpu")}
    gate("gpt2_nll", nll["cuda"][0](texts), nll["cpu"][0](texts))
    gate("gpt2_embed", nll["cuda"][1](texts), nll["cpu"][1](texts))
    del nll
    lm = load_gpt2(os.path.join(assets, "gpt2-large"), "cuda")
    row = torch.randint(0, GPT2_LARGE["vocab_size"], (1, 128),
                        generator=torch.Generator().manual_seed(0)).cuda()
    with torch.no_grad():
        out["gpt2_forward_ms_1x128"] = time_ms(lambda: lm(row), iters=10,
                                               warmup=2)
    del lm
    free()
    return out


def phase_eval(run_dir, root, seed) -> dict:
    """Phase 5j (module docstring): eval_run on phase 5's run dir."""
    from unidisc_tpu_torch import eval_run
    from unidisc_tpu_torch.eval import judges
    from unidisc_tpu_torch.eval.fid import FIDMetric
    from unidisc_tpu_torch.tokenizers.image_codecs import get_codec
    from unidisc_tpu_torch.tokenizers.text import get_tokenizer

    t_phase = time.perf_counter()
    cfg = train_config()
    m = cfg.model
    run = eval_run_dir(run_dir, root)
    rows = next(SyntheticDataLoader(cfg, EVAL_BATCH * EVAL_VAL_BATCHES,
                                    seed=seed + 9))
    shards = os.path.join(root, "eval_shards")
    write_shard(shards, rows["input_ids"], rows["modality"])
    size = math.isqrt(m.img_length) * 16          # VQ-16's downsample
    codec = get_codec(CODEC, image_size=size)
    ids = rows["input_ids"][:EVAL_REF_ROWS, m.txt_length:] - \
        m.text_vocab_size
    ref_imgs = codec.decode(np.clip(ids, 0, m.image_vocab_size - 1)
                            ).float().cpu().numpy()
    del codec
    np.save(os.path.join(root, "fid_ref.npy"), ref_imgs)
    tok = get_tokenizer()
    captions = [tok.decode(r[r < m.text_vocab_size - 1])
                for r in rows["input_ids"][:, :m.txt_length]]
    with open(os.path.join(root, "mauve_ref.txt"), "w") as f:
        f.write("\n".join(c.replace("\n", " ") for c in captions) + "\n")
    assets = write_judge_assets(root, captions, seed)
    setup_s = time.perf_counter() - t_phase

    args = ["--ckpt", run, "--data", shards, "--batch", str(EVAL_BATCH),
            "--max-batches", str(EVAL_VAL_BATCHES), "--gen-batches",
            str(EVAL_GEN_BATCHES), "--codec", CODEC, "--image-size",
            str(size), "--use-ema", "--fid-ref",
            os.path.join(root, "fid_ref.npy"), "--mauve-ref",
            os.path.join(root, "mauve_ref.txt"), "--assets", assets,
            "--clip"]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    results = eval_run.main(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)

    # every key JAX's eval_run writes with these flags, finite; the
    # fallback the missing inception file forces, and the judges found
    keys = {"step", "val/nll", "val/bpd", "val/ppl", "val/txt_ppl",
            "val/img_bpd", "p50_latency_s", "avg_time_per_sample",
            "avg_time_per_token", "tokens_per_sec", "avg_nfe_cnt",
            "gen/token_entropy", "gen/txt_vocab_respected",
            "fid/random_conv(seed7)", "mauve/features", "mauve/score",
            "gen/judge_ppl", "clip/score"}
    if set(results) != keys:
        raise AssertionError(f"eval_results keys {sorted(results)}")
    with open(os.path.join(run, "eval_results.json")) as f:
        if set(json.load(f)) != keys:
            raise AssertionError("eval_results.json keys")
    for k, v in results.items():
        if k != "mauve/features" and not math.isfinite(v):
            raise AssertionError(f"eval {k} = {v}")
    if results["mauve/features"] != "gpt2-large":
        raise AssertionError(f"MAUVE ran on {results['mauve/features']}")
    if results["step"] != TRAIN_STEPS:
        raise AssertionError(f"eval_run restored step {results['step']}")
    print("eval fallbacks: fid on random_conv(seed7) (no inception asset), "
          "mauve on gpt2-large features, clip score from the CLIP judge")

    # flash_fwd: a block a forward: the val batches, the capture's warm
    # run of the denoise loop, and every call's forwards (NFE each):
    # speed_eval's warmup and timed calls and the final sample
    s = FLAGSHIP_SAMPLING
    calls = 1 + max(EVAL_GEN_BATCHES, 2) + 1
    nfe = int(results["avg_nfe_cnt"])
    want = {"flash_fwd": m.n_blocks * (EVAL_VAL_BATCHES
                                       + s["sampling.steps"] + calls * nfe)}
    if launches != want:
        raise AssertionError(f"eval launched {launches}, expected {want}")

    # val/nll is the Trainer's validate on the same batches
    trainer = Trainer(cfg, run, device="cuda", log_every=1000)
    if trainer.maybe_restore() != TRAIN_STEPS:
        raise AssertionError("the Trainer restored another step")
    val = trainer.validate(WeightedDatasetSampler(
        [TokenShardDataset(shards)], batch_size=EVAL_BATCH, seed=7,
        shuffle=False), TRAIN_STEPS, max_batches=EVAL_VAL_BATCHES)
    trainer.close()
    del trainer
    free()
    val_err = abs(results["val/nll"] - val["val/nll"]) / abs(val["val/nll"])
    if not val_err <= EVAL_VAL_RTOL:
        raise AssertionError(f"eval_run val/nll {results['val/nll']} vs "
                             f"Trainer.validate {val['val/nll']}")

    # FID over random_conv features: the card against the CPU, on two sets
    # of blob images (the random codec's decodes are nearly alike: their
    # FID is ~0 and its relative error says nothing)
    fids = {}
    real, fake = blob_images(16, seed, size), blob_images(16, seed + 1, size)
    for dev in ("cuda", "cpu"):
        metric = FIDMetric(judges.random_conv_features(device=dev), 192)
        metric.update_real(real)
        metric.update_fake(fake)
        fids[dev] = metric.compute()
    fid_err = abs(fids["cuda"] - fids["cpu"]) / abs(fids["cpu"])
    if not fid_err <= EVAL_FID_RTOL:
        raise AssertionError(f"random_conv FID card {fids['cuda']} vs CPU "
                             f"{fids['cpu']}")

    u8 = ((np.clip(ref_imgs[:EVAL_BATCH], -1, 1) + 1) * 127.5).astype(
        np.uint8)
    agree = judge_agreement(assets, u8, captions[:EVAL_BATCH])
    rec = {"card": card_line(), "wall_s": wall_s, "setup_s": setup_s,
           "phase_s": time.perf_counter() - t_phase, "results": results,
           "launches": launches, "expected_launches": want,
           "trainer_val_nll": val["val/nll"], "val_nll_rel_err": val_err,
           "fid_random_conv": fids, "fid_rel_err": fid_err,
           "judges": agree}
    print("eval " + json.dumps(rec))
    return rec

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/chip_smoke.json")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a machine with an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    t_start = time.perf_counter()
    laps, t_lap = {}, [t_start]

    def lap(name):
        """The seconds since the last lap, under `name`."""
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    record["build"] = phase_build()
    lap("build")
    record["kernel_cases"] = phase_kernels(args.seed)
    record["bwd_kernel_cases"] = phase_bwd_kernels(args.seed)
    int8_model = Config.make("small", **FLAGSHIP_INT8_OVERRIDES).model
    record["int8_matmul_cases"] = phase_int8_matmul(int8_model, args.seed)
    record["fused_qmm_cases"] = phase_fused_qmm(int8_model, args.seed)
    record["dynamic_quantize_cases"] = phase_dynamic_quantize(int8_model,
                                                              args.seed)
    lap("kernels")

    t0 = time.perf_counter()
    engine = build_engine(preset="small", overrides=FLAGSHIP_OVERRIDES)
    randomize_(engine.model, args.seed)
    record["engine_build_s"] = time.perf_counter() - t0
    record["logits"] = phase_logits(engine, args.seed)
    record["sampler_cpu_vs_cuda"] = phase_sampler_cpu_agreement(args.seed)
    record["generic_sampler_cpu_vs_cuda"] = phase_sampler_cpu_agreement(
        args.seed, kind="generic")
    record["frozen_sampler_cpu_vs_cuda"] = phase_sampler_cpu_agreement(
        args.seed, cached_cond=True)
    record["serve"] = phase_serve(engine, t2i_requests(engine))
    record["serve_gen_text"] = phase_serve(
        engine, gen_text_requests(engine, args.seed), "serve_gen_text")

    # the int8 engine, its weights the bf16 engine's quantized
    t0 = time.perf_counter()
    qengine = build_engine(preset="small", overrides=FLAGSHIP_INT8_OVERRIDES,
                           quantize="int8")
    qstate = quantize_dit_params(engine.model.state_dict())
    qengine.model.load_state_dict(qstate)
    record["int8_engine_build_s"] = time.perf_counter() - t0
    record["int8_logits"] = phase_int8_logits(engine, qengine, args.seed)
    record["int8_sampler_cpu_vs_cuda"] = phase_sampler_cpu_agreement(
        args.seed, int8=True)
    record["serve_int8"] = phase_serve(qengine, t2i_requests(qengine),
                                       "serve_int8")
    free(engine, qengine)
    record["graph_vs_eager"] = {
        "tiny": phase_graph_vs_eager(tiny_models(args.seed), "tiny",
                                     TINY_BATCH, TINY_OVERRIDES[
                                         "sampling.steps"], args.seed),
        "flagship": phase_graph_vs_eager(
            {False: (engine.config, engine.model),
             True: (qengine.config, qengine.model)}, "flagship", REQUESTS,
            GRAPH_STEPS, args.seed)}
    record["graph_vs_eager"]["seeded"] = {
        label: record[label]["eager_same_seed_token_agreement"]
        for label in ("serve", "serve_gen_text", "serve_int8")}
    del engine, qengine
    free()

    # the conditioning-frozen int8 engines, on the same int8 weights
    for label, overlay in (("serve_int8_frozen_cond", "frozen_cond"),
                           ("serve_int8_distilled_stack",
                            "distilled_stack")):
        fengine = build_engine(preset="small",
                               overrides=FLAGSHIP_INT8_OVERRIDES,
                               experiments=(overlay,), quantize="int8")
        fengine.model.load_state_dict(qstate)
        record[label] = phase_serve(fengine, t2i_requests(fengine), label)
        free(fengine)
        del fengine
    free()
    print("serve_tok_per_s " + json.dumps({
        label: {"captured": record[label]["steady_tok_per_s"],
                "eager": record[label]["eager_steady_tok_per_s"]}
        for label in SERVE_PATHS}))
    lap("serve")

    # 4e: pixels, on phase 4's and 4b's weights
    record.update(phase_pixels(args.seed, qstate))
    free()
    lap("pixels")
    # 4f: the serving front door, on the same weights
    record["front_door"] = phase_front_door(args.seed, qstate)
    del qstate
    free()
    lap("front_door")
    # 4g: AR serving
    record["ar"] = phase_ar(args.seed)
    free()
    lap("ar")
    # 4h: the codecs left, on phase 4's weights
    record["codecs"] = phase_codecs_left(args.seed)
    free()
    lap("codecs")

    cfg = train_config()
    record["grad_check"] = phase_grad_check(cfg, TRAIN_BATCH, args.seed)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        record["train"], run_dir, final_ema = phase_train(
            cfg, TRAIN_BATCH, TRAIN_STEPS, args.seed, root)
        torch.cuda.empty_cache()
        record["pixels"]["generate"] = phase_generate(run_dir, final_ema,
                                                      root)
        del final_ema
        free()
        lap("train")
        # 5d: the rest of training, phase 5's run dir the LoRA base and
        # the distillation teacher
        record["train_rest"] = phase_train_rest(args.seed, root, run_dir)
        free()
        lap("train_rest")
        # 5j: evaluation, eval_run on phase 5's run dir
        record["eval"] = phase_eval(run_dir, root, args.seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free()
    lap("eval")
    # 5c: the ar, sedd and d3pm objectives on token shards and streams
    root = tempfile.mkdtemp(prefix="chip_smoke_ar_train_")
    try:
        record["ar_train"] = phase_ar_train(
            args.seed, root, record["kernel_cases"],
            record["bwd_kernel_cases"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free()
    lap("ar_train")
    # 5e: interleaved documents end to end; 5f: the samplers left
    root = tempfile.mkdtemp(prefix="chip_smoke_interleaved_")
    try:
        record["interleaved"] = phase_interleaved(args.seed, root,
                                                  args.seed + 3)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free()
    lap("interleaved")
    record["samplers_left"] = phase_samplers_left(args.seed)
    free()
    lap("samplers_left")
    # 5g: the DIT variants and the data tail
    root = tempfile.mkdtemp(prefix="chip_smoke_variants_")
    try:
        record["variants"] = phase_variants(args.seed, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free()
    lap("variants")
    # 5h (the device mesh), 5i (the rest of the mesh) and 5k (the mesh's
    # other modes): their one-rank parts, one world of spawned ranks for
    # the three, then each phase's checks against one rank
    # 5d's (g), the supervised run, waits on its child processes most of
    # its time: it runs on a thread while the mesh world does
    sup_root = tempfile.mkdtemp(prefix="chip_smoke_supervised_")
    meanwhile = concurrent.futures.ThreadPoolExecutor(1)
    try:
        supervised = meanwhile.submit(phase_supervised, sup_root)
        before = mesh_before_world(args.seed)
        lap("mesh_before_world")
        world = mesh_worlds(args.seed)
        record["mesh_world"] = {k: world[k] for k in ("part_s", "world_s")}
        lap("mesh_world")
        record["train_rest"]["supervised"] = supervised.result()
    finally:
        meanwhile.shutdown(wait=True)
        shutil.rmtree(sup_root, ignore_errors=True)
    lap("supervised_after_world")
    record["mesh"] = phase_mesh(args.seed, before["5h"], world)
    free()
    lap("mesh")
    record["mesh2"] = phase_mesh2(args.seed, before["5i"], world)
    free()
    lap("mesh2")
    record["mesh3"] = phase_mesh3(world)
    free()
    lap("mesh3")
    record["mesh4"] = phase_mesh4(world)
    del world
    free()
    lap("mesh4")
    record["phase_seconds"] = laps
    print("phase_seconds " + json.dumps(laps))
    pix = record["pixels"]
    print("pixels " + json.dumps({
        "card": card, "decode_ms_b8": {
            q: pix[q]["decode_ms"] for q in ("bf16", "int8")},
        "encode_ms_b8": pix["caption"]["encode_ms"],
        "served_batch_s_with_decode": {
            q: min(pix[q]["steady_batch_s_with_decode"])
            for q in ("bf16", "int8")},
        "served_batch_s_without_decode": {
            q: min(pix[q]["steady_batch_s_without_decode"])
            for q in ("bf16", "int8")},
        "decode_share_of_batch": {
            q: pix[q]["decode_share_of_batch"] for q in ("bf16", "int8")},
        "png_encode_host_ms_b8": pix["bf16"]["png_encode_host_ms"],
        "codec_cpu_vs_cuda_max_abs_err": {
            k: pix["cpu_vs_cuda"][k]["max_abs_err"]
            for k in ("latents", "pixels")},
        "captions": len(pix["caption"]["captions"]),
        "generate": {k: pix["generate"][k] for k in
                     ("step", "samples", "pngs",
                      "weights_equal_final_ema")}}))

    by_path = {name: {path: record[path]["launches"].get(name, 0)
                      for path in SERVE_PATHS + PIXEL_PATHS + ("train",)}
               for name in KERNELS}
    for name in KERNELS:
        for path in FRONT_DOOR_PATHS:
            by_path[name][path] = record["front_door"][path][
                "launches"].get(name, 0)
        for path in AR_PATHS:
            by_path[name][path] = record["ar"][path]["launches"].get(name, 0)
        for path in AR_TRAIN_PATHS:
            by_path[name][path] = record["ar_train"][path][
                "launches"].get(name, 0)
        for path in TRAIN_REST_PATHS:
            by_path[name][path] = record["train_rest"]["paths"][path][
                "launches"].get(name, 0)
        for path in INTERLEAVED_PATHS:
            by_path[name][path] = record["interleaved"][path][
                "launches"].get(name, 0)
        for path in SAMPLERS_LEFT_PATHS:
            by_path[name][path] = record["samplers_left"][path][
                "launches"].get(name, 0)
        for path in VARIANT_PATHS:
            by_path[name][path] = record["variants"][path][
                "launches"].get(name, 0)
        for path in MESH_PATHS:
            by_path[name][path] = record["mesh"][path]["launches"].get(
                name, 0)
        for path in MESH2_PATHS:
            by_path[name][path] = record["mesh2"][path]["launches"].get(
                name, 0)
        for path in MESH3_PATHS:
            by_path[name][path] = record["mesh3"][path]["launches"].get(
                name, 0)
        for path in MESH4_RUNS:
            by_path[name][path] = record["mesh4"][path]["launches"].get(
                name, 0)
        for path in EVAL_PATHS:
            by_path[name][path] = record[path]["launches"].get(name, 0)
        for path in CODECS_PATHS:
            by_path[name][path] = record["codecs"][path]["launches"].get(
                name, 0)
    idle = [name for name in KERNELS if not sum(by_path[name].values())]
    if idle:
        raise AssertionError(f"kernels launched no time on the main path: "
                             f"{idle}")
    fwd = record["kernel_cases"][0]          # the serve path's shape
    bwd = record["bwd_kernel_cases"][0]      # the train path's shape
    qmm = record["int8_matmul_cases"][0]     # attn_qkv of the int8 path
    fq = record["fused_qmm_cases"][0]        # its rms + adaLN prologue
    dq = record["dynamic_quantize_cases"][0]  # attn_out's input
    measured = {
        "flash_fwd": {"max_abs_err": fwd["max_abs_err"], "ms": fwd["ms"],
                      "device_ms": fwd["device_ms"],
                      "host_us": fwd["host_us"],
                      "bound_ms": fwd["bound_ms"],
                      "bound_by": fwd["bound_by"]},
        "flash_bwd_dq": {"max_abs_err": bwd["errors"]["dq"]["max_abs_err"],
                         "ms": bwd["ms_dq"], "device_ms": bwd["device_ms_dq"],
                         "host_us": bwd["host_us_dq"],
                         **bwd["bounds"]["flash_bwd_dq"]},
        "flash_bwd_dkv": {"max_abs_err": max(
            bwd["errors"][g]["max_abs_err"] for g in ("dk", "dv")),
            "ms": bwd["ms_dkv"], "device_ms": bwd["device_ms_dkv"],
            "host_us": bwd["host_us_dkv"],
            **bwd["bounds"]["flash_bwd_dkv"]},
        "int8_matmul": qmm, "fused_qmm": fq, "dynamic_quantize": dq,
    }
    # a tensor rank's row-parallel kernels at attn_out's K-slice (5i)
    row_parallel = {name: rows[0] for name, rows in
                    record["mesh2"]["row_parallel"].items()}
    measured.update(row_parallel)
    shape_key = {"int8_matmul": "shape_mkn", "fused_qmm": "shape_mk",
                 "dynamic_quantize": "shape_mk",
                 "int8_matmul_int32": "shape_mkn", "row_amax": "shape_mk",
                 "quantize_by_amax": "shape_mk"}
    kernels = []
    for name, meta in KERNELS.items():
        case = {"flash_fwd": fwd, "int8_matmul": qmm, "fused_qmm": fq,
                "dynamic_quantize": dq, **row_parallel}.get(name, bwd)
        key = shape_key.get(name, "shape_bhld")
        kernels.append({
            "name": name, "route": meta["route"], "source": meta["source"],
            "replaces": meta["replaces"],
            **({"also_replaces": meta["also_replaces"]}
               if "also_replaces" in meta else {}),
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            key: case[key],
            "max_abs_err": measured[name]["max_abs_err"],
            "ms": measured[name]["ms"],
            "device_ms": measured[name]["device_ms"],
            "host_us": measured[name]["host_us"],
            # the plain version and the library call compute the whole
            # backward (both kernels) for flash_bwd_dq and flash_bwd_dkv
            "plain_ms": case["plain_ms"],
            "bound_ms": measured[name]["bound_ms"],
            "bound_by": measured[name]["bound_by"],
            "library_ms": case["library_ms"],
            "library_device_ms": case["library_device_ms"]})
    record["kernels"] = kernels
    record["device_ms_fallbacks"] = DEVICE_MS_FALLBACKS
    record["seconds"] = time.perf_counter() - t_start
    print(f"chip_smoke: every phase passed in {record['seconds']:.1f} s")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)

    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
