#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Run from the repository root on a machine with a card and the CUDA toolkit.
It builds the kernels from ``vit_with_opencl_tpu_torch/csrc`` itself (first
use), then runs these phases; any failure exits non-zero before the last
line.

1. Device and build: the card's name and power limit, the build time.
2. Kernels against their plain versions at ViT-B/16 shapes (T = 197,
   D = 768, H = 3072) at the main path's batch of 16: both LN links, the four
   GEMMs of a layer, the packed attention and the whole bf16 encoder-layer
   chain. Each prints its max abs error beside its tolerance and its time
   (CUDA events) beside its bound, its plain version's time and a library
   yardstick: one PyTorch call where one computes the same function
   (``F.layer_norm``, ``torch.addmm``, ``F.scaled_dot_product_attention``),
   else ``torch.addmm`` followed by the rest of the epilogue as PyTorch ops.
2b. The int8 kernels the same way, on the W8A8 and weight-only chains' own
   intermediates: the row quantize at its four sites (bit-identical to its
   plain version), the four W8A8 GEMMs (bit-identical without GELU), the
   four int8-weight GEMMs, the W8A8 chain's two LN links (fp32 out) and
   both int8 chains; the W8A8 GEMMs on int8 weights stored K-major, as the
   W8A8 engine stores them. Yardsticks: ``torch._int_mm`` (cuBLASLt int8)
   on the same K-major weights with the epilogue as PyTorch ops for W8A8
   (printed beside it: ``_int_mm`` alone, and with the epilogue on the
   row-major weights), ``torch.mm`` on a bf16 copy of the weight with the
   epilogue as ops for weight-only int8; none for the quantize.
2c. The calibrated outlier-aware W8A8 kernels the same way, on the
   intermediates of layer 0 of calibrated adversarial ViT-B weights (the
   phase-3c workspace's): the split quantize at LN1, LN2 and the GELU'd
   hidden and the masked quantize at the context (bit-identical to their
   plain versions; the masked one also at B = 256 on a seeded context), the
   four W8A8 GEMMs with their bf16 side products, and
   the outlier chain. Yardsticks: ``torch._int_mm`` on the K-major weights
   plus ``torch.mm`` on the bf16 side, with the epilogue as PyTorch ops
   (printed beside it: the same on the row-major weights); none for the
   quantizes.
3. The main path: a reference-format workspace (seeded ViT-B/16 weights,
   40 seeded images) goes through ``cli.main --backend gpu --attention
   flash``; the answer file comes from the port's plain fp32 path on the
   card with TF32 off. Requires "Comparator: files match.", bf16
   probabilities within 1e-3 of the fp32 path, and the kernel launch counts
   of 3 batches x 12 layers.
3b. The int8 main path: the same workspace and answer file through
   ``--quantize int8-w8a8``, ``int8`` and ``auto`` (which resolves to W8A8
   on ViT-B). Each needs "Comparator: files match." and its launch counts;
   the W8A8 probabilities must be within 1e-3 of the same engine with the
   chain's links swapped for their plain versions. The bytes and device
   time of the W8A8 set-up's K-major copy of the int8 weights are printed.
3c. The calibrated outlier-aware W8A8 main path: a workspace of seeded
   adversarial ViT-B/16 weights (``fixtures.adversarial_params``, trained-ViT
   outlier channels; the head scaled by HEAD_SCALE so probabilities are
   confident), 40 decisive images, a seeded calibration binary, and an fp32
   answer file, through ``--quantize int8-w8a8 --calibrate`` and
   ``--quantize auto --calibrate``. Each needs "Comparator: files match."
   and the launch counts of 3 batches x 12 outlier chains; the
   probabilities must be within 1e-3 of the same engine on the chain's plain
   versions. How far plain (uncalibrated) W8A8 moves on the same weights is
   printed, not gated.
3d. The small configs' main path: a workspace of seeded ViT-Ti/16 (and
   ViT-S/16) weights, 40 decisive images and an fp32 answer file through
   the CLI with no flags, ``--quantize auto`` (unquantized on these
   configs) and ``--quantize int8``. Each needs "Comparator: files match."
   and the stack's launch counts: one stack call per forward, no per-layer
   chain; the probabilities must be within 1e-3 of the same engine on the
   stack's plain version. ``--quantize int8-w8a8`` on ViT-S runs the
   per-layer W8A8 chain (its counts), as in the JAX package.
3g. Serving on the card (``serve.InferenceServer`` on the phase-3
   weights, ``attention_impl="flash"``, ``quantize="auto"``: W8A8, batch
   32; the server on port 0, the engine warmed up first): four client
   threads send phase 3's 40 decisive images as 8-image requests through
   ``serve.classify`` (float32) and seeded raw pixels to a
   ``normalize_uint8`` engine (uint8); the answers against the same
   engine's ``run`` (labels exact, probabilities within 1e-3), the float32
   answers as a result file against phase 3b's ``auto`` result file (the
   comparator, 0 mismatches), the W8A8 chain's launches of exactly the
   served batches (the batcher's thread launches them); a garbage and a
   wrong-shape request each get an ``ERROR:`` line and the next request is
   answered; STATS counts what was served; ``DataParallelEngine`` on
   ``["cuda:0"] * 4`` behind a server, against the one-card labels and
   probabilities. Printed, not gated: served img/s and request latency
   p50/p99 at batch 32 and 256, uint8 and float32, 4 clients in a process
   of their own (host clock; a window closes at 200 answered requests or
   at 5 s (B = 32) / 10 s (B = 256); p99 only where it holds 100
   requests), the batcher's busy share in ``engine.run`` split into
   padding, upload, forward and copy back, the forward alone and
   ``np.stack`` of a full batch alone, beside the card's name and power
   limit.
3h. The input side: the CLI on phase 3's workspace with libvitio (its
   default; the ``loaded ... (libvitio io)`` line) and with
   ``--pure-python`` (``auto``), byte-identical result files; where PIL
   imports (a line says whether), ``--raw-images`` on 4 PNGs written from
   seeded arrays against the CLI on ``images_to_input_bin``'s file of the
   same PNGs (byte-identical result files, the W8A8 launches); phase 3's
   weights through ``io.export.to_torchvision_state_dict`` →
   ``torch.save`` → ``python -m vit_with_opencl_tpu_torch.io.export
   --from-pth`` → the CLI (bf16, flash) against phase 3's answer file (0
   mismatches).
2d. The whole-encoder stack of the small configs (ViT-Ti/16 and ViT-S/16,
   T = 197) the same way at batch 16: every kernel of phases 2 and 2b at
   these configs' shapes; the full-depth bf16 and int8-weight stacks
   against ``fused_encoder_stack_reference``, each also held nearer to it
   than the plain per-layer chain is (the stream rounded at every layer,
   the fault the stack exists to avoid); the stack at one layer
   (``fused_encoder_layer_flat``); the W8A8 stack and a ``group_size=2``
   layer group at depth 4 against theirs; for comparison the per-layer
   chain over the same 12 layers against its plain version. No yardstick
   for the stacks.
2e. Training: every kernel of the backward and the backward's stages
   against their plain versions at ViT-B shapes, B = 16, on the backward's
   own intermediates: the packed attention backward with bf16 and fp32
   dqkv (yardstick: the backward of ``F.scaled_dot_product_attention``
   alone), the GEMM forms at the four ViT-B shapes (dgrad, fc2's with the
   GELU gradient, wgrad into fp32, the fc1 recompute's two outputs;
   yardstick ``torch.mm``/``addmm`` with the epilogue as ops), the LN
   backward at LN2 and LN1 (autograd of ``F.layer_norm``; each also twice
   for the same bits), the column sum, the three stages and
   ``fused_encoder_layer_bwd``. fp32 outputs are held to a share of their
   own largest magnitude. The column sum also on LN2's partial dw rows (one
   a run of ``layernorm.bwd_partial_rows``' even split of the tokens), as
   the LN backward hands them on.
2 (fp32). The fp32 forms at ViT-B shapes, B = 16 and 256, on an fp32
   layer's own intermediates against their plain versions: the fp32 GEMM
   (``csrc/gemm_f32.cu``) at the forward's four sites and in the backward's
   forms (dgrad with fc2's GELU gradient and its fp32 second output, wgrad
   split over the tokens, the fc1 recompute's two fp32 outputs), the fp32
   slab attention (``vit_packed_attention_f32``; also at T = 577, B = 8)
   and the fp32 attention backward (``csrc/attention_bwd_f32.cu``), and the
   fp32 layer chain. Yardsticks: ``torch.addmm`` / ``torch.mm`` in fp32
   with TF32 off plus the epilogue as ops, SDPA in fp32 forward and
   backward (the backend it takes named). fp32 outputs within 1e-4 (the
   forward) or a share of their own largest magnitude (the gradients).
2k. The LN kernel's forms at the stacks' and ViT-L's widths (D = 192 and
   384 at B = 16 and 256, D = 1024 at ViT-L/16@384's B = 8 and 32) on the
   fp32 stream, bf16 and fp32 out, against its plain version (yardstick
   ``F.layer_norm``); the quantizes' forms (rows 5a and 6a) at the same
   configs' D and MLP widths and at ViT-H/14's and ViT-G/14's (B = 8), fp32
   and bf16 in, and the masked quantize (row 6b) at those configs' contexts
   (their heads, the default tail), bit-identical to their plain versions
   (no yardstick); the LN backward's forms (row 14b, LN2 and LN1) at ViT-Ti's,
   ViT-S's, ViT-H's and ViT-G's widths against its plain version and twice
   for the same bits; the registers and spills of each form of
   ``csrc/quantize.cu`` and ``csrc/layernorm.cu``, and of the ring step's
   (``csrc/attention_ring.cu``: the bf16 kernel, the fp32 body) and the
   single-pass attention's fp32 body (``csrc/attention_single.cu``), of the
   fp32 GEMM and the fp32 attention backward (``csrc/gemm_f32.cu``,
   ``csrc/attention_bwd_f32.cu``), and of the overlap probe's kernels (``csrc/probe_overlap.cu``: the wgmma GEMM
   kernels' warpgroups hold their ``setmaxnreg`` shares, printed beside),
   none of which may spill or have its ``setmaxnreg`` ignored (``nvcc
   -Xptxas -v``);
   then rows 2, 5d, 14b, 14c, 5a, 6a and 6b at ViT-B B = 16 traced
   alone with ``perf.device_kernel_table``: device time a call beside the
   same trace of ``F.layer_norm`` and ``x.float().sum(0)`` (none for the
   quantizes and the LN backward), and the trace's launches of the port's
   kernels against the calls.
3i. fp32 on the card: ``InferenceEngine(VIT_B_16_224,
   param_dtype=torch.float32, compute_dtype=torch.float32,
   attention_impl="flash")`` (the per-layer chain on the fp32 GEMM and the
   fp32 slab attention) at batch 16 on phase 3's 40 images, and the same
   engine on ViT-Ti/16 (the whole-encoder stack) on a workspace of phase
   3d's weights: the launches of each forward, the probabilities within
   1e-4 of the plain fp32 path (``vit.forward`` in fp32, the answer file's
   source; the error printed beside its budget) and 0 comparator
   mismatches against the answer file. Then ``Trainer(VIT_B_16_224,
   compute_dtype=torch.float32, optimizer="adamw")`` in ``fused`` and
   ``flash``, 4 steps at batch 16 on a memorised batch: the loss falls,
   the launches of those steps (every fp32 form), and one step against
   the plain links under phase 5's gates. After phase 5c, fp32 past padded
   T = 1024 at ViT-L/16@512 (full depth and widths): the fp32 engine at
   batch 16 on phase 3e's weights and decisive images (the per-op path, a
   ViT-L layer's fp32 weights being past the fused layer's bound: 24
   blockwise fp32 forwards a forward and no other kernel, probabilities
   within 1e-4 of the plain fp32 path, 0 comparator mismatches), and ``Trainer(compute_dtype=torch.float32)``
   in ``fused`` and ``flash``, 4 steps at batch 4 (the loss falls; the
   launches: the blockwise forward's fp32 form 72 a ``fused`` step, with the
   LSE and the fp32 blockwise backward 24 each a ``flash`` step), then one
   step of each from ``random_params`` seed 1 against the plain links,
   printed beside phase 5c's bf16 errors.
5. The training main path: ``Trainer(VIT_B_16_224, device="cuda",
   compute_dtype=bf16, optimizer="adamw")`` from seeded ``init_params``,
   8 steps at batch 32 on a memorised seeded batch, in each route
   (``fused``, ``flash``, ``xla``): the loss falls, and the launch counts of
   those steps are every backward kernel's 12 a step in its route; in
   ``fused`` and ``flash`` one step from seeded random params against the
   same Trainer on the plain links (loss, AdamW's first moment, the mean
   update); in ``fused`` save → resume restores step, params and AdamW
   state exactly, and ``export_reference`` → ``cli --backend gpu`` gives
   the trained params' top-1 labels on every decisive image.
5d. The DeiT recipe on the card: ``Trainer(VIT_B_16_224, device="cuda",
   optimizer="adamw", compute_dtype=bf16, attention_impl="fused",
   device_augment={}, mixup={}, ema_decay=0.999)`` from seeded random params
   (non-zero heads), 8 steps at batch 32 from ``augment_device.raw_batches``
   over 64 seeded 256x256 uint8 images, saved at step 4. The losses are
   finite; each step's batch equals ``device_augment`` then
   ``device_mixup_cutmix`` called directly on the generators of its (seed,
   step); a Trainer resumed from the step-4 checkpoint takes the same batches
   and gives the same losses for steps 5-8; ``export_reference(use_ema=True)``
   → ``cli --backend gpu`` gives the EMA params' top-1 labels; the launches
   of the 8 steps equal phase 5's ``fused`` ones (the pipeline adds no
   kernel). Printed beside the card's name and power limit:
   ``device_augment`` ms a batch at B = 64 and 128 and ``device_mixup_cutmix``
   ms (CUDA events), the ViT-B ``fused`` AdamW step at B = 64 with and
   without the pipeline in front and the pipeline's share (CUDA events, one
   thread) and ms a step through ``Trainer.fit`` from raw uint8 batches and
   from normalized fp32 ones (host clock), the host ``augmented_dataset``
   img/s at ``workers=1`` and at the host's cores against that step's
   img/s, whether ``_resize`` ran PIL or NumPy, the memory the captured
   pipelines held (released before the later phases), and the phase's own
   seconds.
4. Throughput of the full-depth bf16, W8A8, int8 and calibrated W8A8 flash
   forwards at batch 64 and 256, beside the sums of their kernels' times and
   bounds at the same batch; then ViT-Ti and ViT-S (bf16 and int8-weight
   stacks) at batch 64 and 256, beside the same engines on the per-layer
   chain, with the rows of phase 2d timed again at batch 256; and the fp32
   ``flash`` forward of phase 3i's engine at batch 64 beside the fp32
   ``xla`` route (cuBLAS fp32, TF32 off).
4b. Training throughput at batch 64: ms per AdamW step, img/s and peak
   memory in each route, the split of a ``fused`` step (forward chain, the
   three backward stages, AdamW, the rest), the fp32 ``fused`` and ``xla``
   steps, and phase 2e's rows again at batch 64.
2f. The training kernels of the larger presets: the streamed attention
   backward at ViT-L/16@384's T = 577 (hd 64, 16 heads; B = 8 and 32, bf16
   and fp32 dqkv), ViT-H/14's and ViT-G/14's T = 257 (hd 80 and 104, B =
   16) and ViT-B's T = 197 (B = 16 and 64, beside the earlier resident
   form's times), against ``packed_attention_bwd_reference`` with SDPA's backward
   as the yardstick, and dqkv bit-identical over two runs at ViT-B B = 64
   and ViT-L B = 32; the packed attention forward at ViT-L/16@384, B = 32
   (the ``fused`` chain's shape; SDPA beside it); the H-chunked MLP
   backward's light and wgrad stages at ViT-L width (B = 8 and 32) and
   ViT-H width (B = 8) against their plain versions, the pair equal to the
   mono stage on the card;
   ``fused_encoder_layer_bwd`` at ViT-L width with its stage launch counts;
   and the LN backward (LN2 and LN1) at ViT-L's width, B = 8 and 32, on
   seeded inputs (autograd of ``F.layer_norm`` beside it; twice for the same
   bits).
5b. The ViT-L/16@384 training main path: ``Trainer(VIT_L_16_384,
   compute_dtype=bf16, optimizer="adamw", attention_impl="fused")``, full
   depth (24) and widths, 8 steps at batch 16 on a memorised seeded batch:
   the loss falls, and the launch counts are 24 a step of every kernel of
   the route, the light and wgrad stages included and the mono MLP stage
   never; one ``fused`` and one ``flash`` step from seeded random params
   against the same step on the plain links.
4c. ViT-L/16@384 training throughput at batch 32: ms per AdamW step, img/s
   and peak memory of ``fused`` and ``flash``, and the split of a ``fused``
   step (forward chain, stage x2, light, wgrad, attention, AdamW, the rest).
2g. The blockwise attention kernels (the JAX package's route for padded T >
   1024) against their plain versions: the forward without and with the
   LSE and the backward (dq and dK/dV kernels) at ViT-L/16@512's T = 1025
   (16 heads of 64; B = 4 and 16), ViT-H/14@518's T = 1370 (hd 80), an
   odd tail (T = 1337) and hd 128 (T = 1153, 8 heads, B = 2); yardsticks
   SDPA's forward and its backward alone, each row's time printed as a
   factor of SDPA's and of its bound; the forward with the LSE and the
   backward give the same bits over two runs; and at ViT-L/16@512, B = 16, the streamed
   packed backward that the ``fused`` route's attention stage takes there.
   At each shape the forward's 256- and 512-key instances (``block_k``,
   JAX's key tile) on the slabs without and with the LSE and on split
   heads, under the 128-key rows' gate, with SDPA's time and the bound
   beside each; the LSE form of each gives the same bits over two runs.
   Then the fp32 forms at each shape (rows 9-fp32 and 12-fp32): the
   forward without and with the LSE at each key tile, on split heads, and
   the backward, against their plain versions (1e-4 forward, 2e-5 of scale
   backward), SDPA in fp32 beside each (its backend named), the same bits
   over two runs.
3e. The ViT-L/16@512 inference main path: ``InferenceEngine(vit_l_16_512,
   attention_impl="flash")`` in bf16 at batch 16, full depth and widths,
   on ``random_params`` seed 0 and 32 decisive images: 24 blockwise
   forwards and no packed one per forward, probabilities within 1e-3 of the
   port's plain fp32 path, and the comparator on the result files.
5c. The ViT-L/16@512 training main path: ``Trainer`` (bf16, AdamW) on
   ``flash`` and ``fused``, 8 steps at batch 8 on a memorised batch: the
   loss falls, and the launch counts (``flash``: the blockwise forward with
   its LSE and the blockwise backward, 24 a step; ``fused``: the blockwise
   forward 72 a step); one step of each route from phase 3e's random
   params against the plain links at batch 4, the ``fused`` one (through
   the LN backward) on batches of three seeds, each error printed beside
   ``step_noise.py``'s noise floor.
4d. ViT-L/16@512 training throughput at batch 16: ms per AdamW step, img/s
   and peak memory of ``fused`` and ``flash``, and the split of a ``fused``
   step; then fp32 ``fused``, ``flash`` and ``xla`` steps at batch 8.
2h. The kernel layer's public ops against their plain versions:
   ``flash_attention`` (the single-pass kernel) at ViT-B/16's heads (B = 16
   as split heads and as the permuted views of a packed GEMM output, B =
   256, fp32 at B = 16 and 256), T = 577 (B = 8) and 1024 (B = 4), and at T = 1025
   (the blockwise kernel on split heads, B = 4); ``packed_fused_attention``
   at T = 900 and 1024 (16 heads of 64, B = 4: the packed kernel on the
   slabs, where its first form's shared memory ended) and with per-head
   packing and ``true_seq_len`` 256 and 257 of T = 264 (ViT-B/16's heads, B
   = 16: the one-pass limit; the packed kernel's key-count entry); and ``residual_layer_norm`` at D = 768, M =
   3152 and 50432, bf16 and fp32 (``summed`` bit-identical). Yardsticks:
   SDPA on the same tensors (over the first ``true_seq_len`` keys); ``x +
   r`` then ``F.layer_norm`` (two calls). The single-pass rows (bf16, and
   the fp32 body's) give the same bits over two runs.
2i. The ring step kernel (``blockwise_ring_step``, the local step of ring
   attention) against its plain version at the ring's shard shapes:
   ViT-L/16@512 on 4 shards (t_loc 257, the last shard's 3 padded keys
   masked; B = 8 and 4, 16 heads of 64), on 8 shards (129), ViT-B/16 on one
   shard (197), ViT-H/14@518 on 4 shards (343, hd 80) and two 512-key
   blocks (1024); bf16 (the wgmma kernel) and fp32 (the register-tiled
   body), as a first rotation and 4 rotations chained, the first rotation
   the same bits over two calls, and in bf16 traced alone
   (``perf.device_kernel_table``: the card's time a call, one launch a
   call). SDPA on the same [n, t_loc, hd] is printed
   as a yardstick (it does not compute the carried function, so no library
   time is recorded).
2j. The W8A8 overlap probe's kernels (``csrc/probe_overlap.cu``: stream,
   vpu:q, vpu:ln, mxu, fused, indep with the quantize and with the LN)
   against their plain versions at a grid of 4 blocks and N = 3072, on the
   probe's data and on seeded random data (bit-identical; the LN within one
   bf16 ulp; the GEMM forms on w stored K-major, as ``probe.weights()``
   gives it: int8 wgmma reads no other layout); then the probe's ``main()``
   at its full grid of 256 blocks,
   the main path of these kernels (151 launches of each form); each form
   again on ``main()``'s own data at 256 blocks against its plain version
   (the same tolerances: the int8 rows past the int32 wrap reach the
   outputs there), and its time at 256 blocks over its time at 64 within
   [3, 5] (no block's work dropped). Yardsticks: ``torch._int_mm`` on the
   K-major w with the epilogue as ops (mxu), ``F.layer_norm`` (vpu:ln).
   Printed beside: mxu, indep:q and indep:ln at 256 blocks and N = 128 (the
   row warpgroup with 1/24 of the GEMM beside it: its own time).
3f. Multi-device inference on virtual meshes of the one card (every shard
   on cuda:0): ``sp_forward(kv="ring")`` at ViT-L/16@512, bf16, mesh (1, 4),
   B = 8 on phase 3e's weights and images (24 layers x 4 rotations x 4
   shards = 384 ring launches, nothing else; within 1e-3 of the plain fp32
   path, of ``kv="gather"`` and of the same ring on the plain step; phase
   3e's labels) and in fp32 at B = 2; at ViT-B/16 on phase 3's workspace,
   ``tp_forward`` and ``sp_tp_forward`` (flash, bf16, mesh (1, 4): the
   packed kernel's per-head entry once a layer a shard, T padded to 200 and
   masked in SP x TP; within 1e-3 of fp32 and phase 3's labels), W8A8 ``tp_forward``
   (within 1e-2 of fp32, 1e-3 of its plain attention) and
   ``DataParallelEngine`` on (4, 1) (phase 3's labels and probabilities).
4e. ms and img/s of phase 3f's ring forward at B = 8 and 16: 4 virtual
   shards on one card, a number about the kernel path, not multi-card
   scaling.
6d. ``perf.autotune.tune_and_save`` on ViT-L/16@512 at B = 16, bf16, into a
   temporary cache (its table of the blockwise forward's key tiles
   printed), then ``InferenceEngine(tuning_path=)`` on phase 3e's weights
   and decisive images: the winner bound, its forwards launching the
   winner's instance and no other (24 a forward), within 1e-3 of the plain
   fp32 path, 0 comparator mismatches; then the same with an entry naming
   each other key tile, so that every instance runs on the main path.
6. The public ops and the perf tools: one ViT-B/16 layer and its head
   composed of ``ops.layer_norm``, ``fused_linear``, ``flash_attention``,
   ``residual_layer_norm`` and ``softmax`` at B = 16, and ``flash_attention``
   at T = 1025 in bf16 and fp32 (their launches; the layer against the same
   composition of the plain versions); ``perf.profile_ops`` at ViT-B/16, bf16, ``flash``,
   B = 64 (the table, JAX's stage names, one single-pass launch);
   ``perf.device_kernel_table`` of the phase-3 engine's forward at B = 256,
   of the int8-weight and W8A8 engines' (phase 3b) at B = 256 and of the
   ViT-Ti/16 stack's at B = 16 (the table, each chain kernel's traced calls
   equal to its counter's rise, the card's busy share); the W8A8 forward
   runs no PyTorch op but views on an encoder int8 weight (no per-forward
   transpose or copy); and
   ``perf.throughput_report`` of phase 4's bf16 forward at B = 256 (MFU).
6c. Substitution attribution (``perf.attribute_forward``,
   ``perf.kernel_substitutions``): the stand-ins against their plain
   versions (JAX's stand-ins) at ViT-B/16, B = 16 and 256: row 4's
   constant-scale form on a seeded qkv, rows 5a's and 6a's cheap forms at
   the W8A8 and calibrated chains' sites (bit-identical; phase 2k prints the
   cheap forms' registers beside the real ones, and ``before_after.py
   --ptxas DIR`` holds the real forms' registers to the parent's); then
   ``scripts/probe_tiny_bound`` (JAX's lines and the card's peaks) on
   ViT-B/16 bf16 and W8A8 and the ViT-Ti/16 stack at B = 256, three runs
   each, every run and each share's spread printed; the launches of one
   real forward of phase 3's, 3b's, 2c's and 3d's engines (ViT-B/16 bf16,
   W8A8, calibrated W8A8, the ViT-Ti/16 stack) against the same forward
   under each substitution (every counter equal), and the real forward's
   bits after them as before; ``attribute_forward`` raising while its lock
   is held; and ``scripts/probe_midsize`` on ViT-S/16 at B = 256 (perop,
   fused, stack, group2). The stand-in rows at B = 256 join the kernels'
   record, their launches from the substituted forward that runs each.
7. The record-producing scripts as a user runs them: ``make_fixtures`` for
   ViT-B/16 with 4 images, then ``cli --backend gpu --attention flash`` on
   that workspace (the comparator green); ``soak`` of ViT-B/16 W8A8 at B =
   256, 2 windows of 5 (finite); ``trace_table`` of ViT-B/16 W8A8 at B = 64
   (the W8A8 form of the GEMM core in the table); ``bench_train`` of ViT-B/16
   ``fused`` at B = 32, 2 steps, with AUG=1 (a finite loss; the augment
   probe's host img/s and ``device_augment`` ms); ``recipe_smoke`` of
   ViT-B/16 ``fused`` at B = 32, 3 steps (a finite loss, the EMA export's 152
   files, the pipeline's share of a staged step); ``soak_serve`` of
   ViT-B/16 W8A8 at B = 64, 5 s, 2 clients (no failed request or batch);
   and ``InferenceEngine(check_numerics=True)`` on phase 3's weights
   (passes) and with one weight NaN (raises).

Counts are set to 0 just before each main-path run and read just after.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import io
import itertools
import json
import math
import os
import re
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

try:
    from vit_with_opencl_tpu_torch import (VIT_B_16_224, augment, augment_device, cli,
                                           data, ops, optim, perf, serve)
    from vit_with_opencl_tpu_torch.config import (VIT_G_14_224, VIT_H_14_224,
                                                  VIT_L_16_384, VIT_S_16_224,
                                                  VIT_TINY_16_224)
    from vit_with_opencl_tpu_torch.engine import DataParallelEngine, InferenceEngine
    from vit_with_opencl_tpu_torch.parallel import spmd
    from vit_with_opencl_tpu_torch.train import Trainer
    from vit_with_opencl_tpu_torch.harness import fixtures, results
    from vit_with_opencl_tpu_torch.io import binfmt, export, preprocess
    from vit_with_opencl_tpu_torch.models import quant, vit
    from vit_with_opencl_tpu_torch.ops import (_build, attention, fused_block,
                                               layernorm, linear, quantize)
    from vit_with_opencl_tpu_torch.scripts import (bench_train, make_fixtures,
                                                   probe_midsize, probe_tiny_bound,
                                                   recipe_smoke, soak, soak_serve,
                                                   trace_table)
    from vit_with_opencl_tpu_torch.scripts import probe_w8a8_overlap as probe
    from vit_with_opencl_tpu_torch.runtime import native
except ImportError as exc:  # run outside the repository
    print(f"FAIL: the port's package is not importable here: {exc}")
    sys.exit(1)

CFG = VIT_B_16_224
SMOKE_BATCH = 16  # the main path's batch (phase 3), hence phase 2's shapes
N_IMAGES = 40  # 3 batches of 16, the last one padded
THROUGHPUT_BATCHES = (64, 256)
REPS = 20
PLAIN_REPS = 5  # the plain versions are slow and no yardstick of speed
# Images whose fp32 top-2 logit gap is below this are left out of phases 3
# and 3b: with random weights over 1000 classes, near-ties are common, and
# bf16 rounding or int8 quantization may then swap the top-1 label although
# the probabilities agree to 1e-4. The comparator's exact-label gate should
# test the kernels, not a coin toss.
MIN_LOGIT_GAP = 0.05

# bf16 outputs: about 2 bf16 ulps; fp32 outputs: summation order.
BF16_TOL = (1.6e-2, 1e-2)  # (rtol, atol)
F32_TOL = (1e-4, 1e-4)
EXACT = (0.0, 0.0)
# A bf16 output must also be bit-identical to the plain version's almost
# everywhere: both round at the same points, and only another summation
# order may flip a rounding. A moved rounding point stays within 2 ulps but
# changes about half the elements. The chain compounds the flips of its 7
# launches (about 82% identical at ViT-B shapes on an H100).
MIN_SAME_KERNEL = 0.99
MIN_SAME_CHAIN = 0.7
# The int8 chains. Weight-only int8 rounds where the bf16 chain does (87%
# identical at ViT-B shapes on an H100). W8A8 adds four quantizes: an fp32
# LN output or GELU'd hidden one ulp off the plain version's (another
# summation order, a contracted multiply-add) now and then flips an int8
# decision, and a flip moves the products of its row by a quantum. Measured
# on an H100 80GB HBM3: 88-89% identical, max abs error 1.56e-2 at B = 16
# and 64, 1.76e-2 at B = 256, on outputs small enough that 2 bf16 ulps do
# not cover it; hence an atol of 3e-2 for this chain alone.
MIN_SAME_INT8_CHAIN = 0.8
W8A8_CHAIN_TOL = (1.6e-2, 3e-2)
PROB_TOL = 1e-3  # the reference's bf16 parity budget on probabilities
# The outlier-aware W8A8 GEMMs: the int8 sums are exact, but the bf16 side
# product sums in another order than the plain version's fp32 GEMM, so fp32
# outputs agree to summation order (44-58% bit-identical) and bf16 outputs
# almost always round the same way. The outlier chain compounds that with
# the int8 flips of the W8A8 chain, on the adversarial weights' larger
# activations. Measured on an H100 80GB HBM3: 91-94% identical, max abs
# error 0.078 / 0.109 / 0.125 at B = 16 / 64 / 256; hence an atol of 0.25.
OUTLIER_CHAIN_TOL = (1.6e-2, 0.25)
MIN_SAME_OUTLIER_CHAIN = 0.85
# Phase 3c's workspace: the adversarial fixture's classifier head is scaled
# so that quantization errors show in the probabilities. The JAX package's
# tests scale it by 6 at D = 256; at ViT-B width on an H100 80GB HBM3 that
# puts even unquantized bf16 0.030 from fp32 (the gate is 0.01), and at 3
# the calibrated plain chain is 0.0116 from it. At 1.5 the calibrated mode
# is 7e-4 from fp32 and plain W8A8 still flips 6 of 40 labels.
HEAD_SCALE = 1.5
N_CALIB = 16
# Phases 2d, 3d and 4: the configs whose whole encoder runs as the stack.
SMALL_CFGS = (VIT_TINY_16_224, VIT_S_16_224)
# The stacks carry the fp32 stream through every layer: a bf16 rounding of
# an LN output, qkv, the context or the hidden that another summation order
# flips moves the stream a little, and each later layer carries the move on.
# The outputs stay within 2 bf16 ulps, but the bit-identical share falls with
# depth. Measured on an H100 80GB HBM3 (first run of these phases): 12-layer
# stacks 68% (ViT-Ti) and 50% (ViT-S) identical, the 4-layer group 83% and
# 63%, the 4-layer W8A8 stack 71% and 26% (its int8 flips compound too).
# The per-layer chain over the same 12 layers, printed beside them, keeps
# less: 45% and 29%, max abs error 3.1e-2 and 4.7e-2. At one layer
# (fused_encoder_layer_flat: 99.6% and 96.4%) the stack is held to the
# chain's share.
MIN_SAME_STACK = 0.4
# The mean abs error of a bf16 or int8-weight stack or group against its
# plain version must also stay below this share of the distance between the
# plain per-layer chain (the stream rounded to the activation dtype at every
# layer) and the plain stack. Measured on an H100 80GB HBM3: the correct
# stacks 0.20 (ViT-Ti) and 0.38 (ViT-S), the groups 0.16 and 0.42; with the
# stream rounded at each fc2 of the kernel route, 1.0 for all four. The
# W8A8 stack is not held to it: its int8 flips alone put it at 0.25 and 0.73.
STACK_FAULT_SHARE = 0.8
STACK_W8A8_TOL = (1.6e-2, 6e-2)
MIN_SAME_STACK_W8A8 = 0.15
REDUCED_DEPTH = 4  # the W8A8 stack and the group in phase 2d

# _attn_bwd_kernel, whose links (LN1's backward among them) the attention
# stage's rows replace.
ATTN_BWD_STAGE = "vit_with_opencl_tpu/ops/fused_block.py:875"

# Phases 2e, 4b and 5: training. The backward's fp32 outputs (gradients,
# dx2, x2, hid_pre) are long sums that the kernels take in another order than
# the plain versions' library calls: each is held to GRAD_REL of its largest
# magnitude. The whole backward compounds bf16 flips through the attention
# (a flipped rounding of qkvc, ctx or dctx moves a gradient's summands), so
# its gradients get STAGE_GRAD_REL.
GRAD_REL = 1e-3
STAGE_GRAD_REL = 2e-2
MIN_SAME_ATTN_BWD = 0.9
TRAIN_ROUTES = ("fused", "flash", "xla")
TRAIN_BATCH = 32  # phase 5: one memorised batch of seeded images
TRAIN_STEPS = 8
TRAIN_LR = 1e-3
TRAIN_THROUGHPUT_BATCH = 64  # phase 4b
# Phase 5's step against the same step on the plain links, from random
# (non-zero-headed) params: the loss, and each layer leaf's first moment
# (AdamW's mu = 0.1·g after one step) within MU_REL of its largest magnitude
# (measured 1.5e-2 and 1.8e-2, fused and flash, on an H100 80GB HBM3). The
# update itself is ±lr wherever |g| is well above eps, so where a gradient
# is below the bf16 noise its sign, and the update, is a coin toss (the mean
# update difference was 0.31 and 0.28 lr there): the updates must agree, to
# UPDATE_ATOL·lr, where |mu| is above MU_REL of its leaf's largest (there the
# noise cannot flip the sign), and nowhere differ by more than 2·lr.
STEP_LOSS_REL = 1e-3
MU_REL = 5e-2
UPDATE_ATOL = 1e-2
# The launches of one training step, per layer, in each kernel route.
TRAIN_PER_LAYER = {
    "fused": {"fused_block": 1, "fused_bwd": 1, "fused_bwd_x2": 1,
              "fused_bwd_mlp": 1, "fused_bwd_attn": 1, "attention": 3,
              "attention_bwd": 1, "layernorm": 5, "linear": 7,
              "linear_gelu_pair": 1, "linear_dgrad": 4, "linear_wgrad": 4,
              "layernorm_bwd": 2, "column_sum": 8},
    "flash": {"attention": 1, "attention_bwd": 1},
    "xla": {},
}

# fp32 compute up to padded T = 1024: the fp32 GEMM (rows 3 and 14a in fp32),
# the fp32 slab entry of the packed attention (row 4) and the fp32 attention
# backward (row 11). Phase 2's fp32 rows at F32_ROW_BATCHES (row 4's fp32
# form also at ViT-L/16@384's T = 577, B = 8, its heads), phase 3i and the
# fp32 rows of phases 4 and 4b. Phase 3i holds the fp32 engines to the plain
# fp32 path (vit.forward in fp32 with TF32 off, the answer files' source)
# within F32_PROB_TOL of probability, and fp32 training to phase 5's gates.
F32_ROW_BATCHES = (SMOKE_BATCH, THROUGHPUT_BATCHES[-1])
F32_ATTN_LONG = (8, 577, 16, 64)  # (B, T, heads, head dim)
F32_PROB_TOL = 1e-4
# The fp32 backward rows' fp32 outputs, each held to F32_GRAD_REL of its
# largest magnitude (the cuda tests' F32_GEMM_REL): plain fp32 sums in
# another order stay below 1.1e-5 of scale, TF32 products would give 5e-4.
F32_GRAD_REL = 2e-5
F32_TRAIN_BATCH = 16
F32_TRAIN_STEPS = 4
F32_THROUGHPUT_BATCH = 64
F32_ROUTES = ("fused", "flash")
# The launches of one fp32 forward a ViT-B layer (the per-layer chain), and
# of one fp32 training step a layer in each kernel route.
F32_PER_LAYER = {"layernorm": 2, "linear_f32": 4, "attention_f32": 1, "fused_block": 1}
F32_TRAIN_PER_LAYER = {
    "fused": {"fused_block": 1, "fused_bwd": 1, "fused_bwd_x2": 1,
              "fused_bwd_mlp": 1, "fused_bwd_attn": 1, "attention_f32": 3,
              "attention_bwd_f32": 1, "layernorm": 5, "linear_f32": 7,
              "linear_gelu_pair_f32": 1, "linear_dgrad_f32": 4,
              "linear_wgrad_f32": 4, "layernorm_bwd": 2, "column_sum": 8},
    "flash": {"attention_f32": 1, "attention_bwd_f32": 1},
}

# Phase 5d: the DeiT recipe on the card. RECIPE_SOURCES seeded uint8 images
# at the 256-for-224 source size, RECIPE_STEPS steps at RECIPE_BATCH with a
# checkpoint at RECIPE_RESUME_AT; device_augment timed at RECIPE_TIME_BATCHES,
# the fused step with and without the pipeline at RECIPE_STEP_BATCH (phase
# 4b's), the host pipeline over RECIPE_HOST_BATCHES batches after one to warm.
RECIPE_SEED = 5
RECIPE_SOURCES = 64
RECIPE_SRC = 256
RECIPE_BATCH = 32
RECIPE_STEPS = 8
RECIPE_RESUME_AT = 4
RECIPE_EMA = 0.999
RECIPE_TIME_BATCHES = (64, 128)
RECIPE_STEP_BATCH = TRAIN_THROUGHPUT_BATCH
RECIPE_HOST_BATCHES = 2
RECIPE_FIT_STEPS = 6  # Trainer.fit steps timed at RECIPE_STEP_BATCH, after 2
RECIPE_SECONDS = 40.0

# Phases 2f, 5b and 4c: ViT-L/16@384, whose MLP backward takes the H-chunked
# pair. Its fused step launches what ViT-B's does, with the light and wgrad
# stages for the mono one, and LN2 once more (the wgrad stage recomputes it).
LARGE_CFG = VIT_L_16_384
LARGE_TRAIN_BATCH = 16  # phase 5b
LARGE_THROUGHPUT_BATCH = 32  # phase 4c
# Phase 2f's chunked-MLP rows: (config, batch, with the whole layer's
# backward and the pair against the mono stage).
LARGE_MLP_ROWS = ((VIT_L_16_384, 8, True), (VIT_L_16_384, 32, False),
                  (VIT_H_14_224, 8, False))
LARGE_PER_LAYER = dict(TRAIN_PER_LAYER["fused"], fused_bwd_mlp=0,
                       fused_bwd_mlp_light=1, fused_bwd_mlp_wgrad=1, layernorm=6)
# The streamed attention backward's predecessor, which held a whole head in
# shared memory, on an H100 80GB HBM3 at 700 W (PERF.md row 11), ViT-B's T =
# 197, bf16 dqkv: ms at B = 16, 64.
RESIDENT_ATTN_BWD_MS = {16: 0.2396, 64: 1.0585}
# Row 11's dqkv must be the same bits from run to run at these (config,
# batch) of phase 2f (no block sums into another's output).
BWD_SAME_BITS = ((VIT_B_16_224, 64), (VIT_L_16_384, 32))

# Phases 2g, 3e, 5c and 4d: ViT-L/16@512, torchvision's vit_l_16 at the
# resolution of its SWAG E2E weights (no preset: the JAX package's geometry
# of VIT_L_16_384 at img_size 512). 32^2 + 1 = 1025 tokens pad past
# SINGLE_PASS_MAX_T, so attention takes the blockwise kernels.
LONG_CFG = dataclasses.replace(VIT_L_16_384, name="vit_l_16_512", img_size=512)
LONG_BATCH = 16  # phases 3e and 4d
LONG_IMAGES = 32  # phase 3e
# Its pool of seeded images: 120 of the first 128 were decisive on an H100
# 80GB HBM3, so half as many again as it needs leaves a margin.
LONG_POOL = 48
LONG_TRAIN_BATCH = 8  # phase 5c
# Phase 5c's step against the plain links, whose attention holds [B, H, T,
# T] fp32 scores. The fused step runs through the LN backward's summation
# order and sits near its noise floor: it is checked on a batch of each of
# LONG_STEP_SEEDS, each error printed beside the floor that step_noise.py
# measured (the plain links with each key tile's sums reversed, on an H100
# 80GB HBM3 at 700 W).
LONG_STEP_BATCH = 4
LONG_STEP_SEEDS = (3, 4, 5)
STEP_NOISE_5C = 5.75e-4
# Phase 2g's rows: (config or its name, T, heads, head dim, batch). ViT-H/14
# at 518 (its SWAG E2E resolution: 37^2 + 1 tokens), JAX's own odd tail
# (tests/test_kernels.py: SINGLE_PASS_MAX_T + 313) and the widest head dim
# the kernels take, 128, one key past 9 whole key tiles, as kernel rows only.
FLASH_ROWS = ((LONG_CFG.name, 1025, 16, 64, 4), (LONG_CFG.name, 1025, 16, 64, 16),
              ("vit_h_14_518", 1370, 16, 80, 4), ("odd tail", 1337, 16, 64, 4),
              ("hd 128", 1153, 8, 128, 2))
LSE_TOL = (1e-5, 0.0)  # fp32 on both sides: m + log(l) in another order
# The blockwise forward's instances beside JAX's default key tile of 128:
# the block_k of JAX's sweep (phase 2g's rows, phase 6d's tuned engines).
FLASH_TUNED_KS = tuple(bk for bk in attention.FLASH_BLOCK_KS if bk != 128)
# A forward of the per-layer chain at T = 1025: the blockwise forward is its
# attention link, the packed kernel never runs.
LONG_PER_LAYER = {"layernorm": 2, "linear": 4, "attention_flash": 1,
                  "attention_flash_k128": 1, "fused_block": 1}
# A training step at T = 1025, per layer: `fused` as ViT-L/16@384's with the
# blockwise forward for the packed one (the chain and the two recomputes);
# `flash` the blockwise forward with its LSE and the blockwise backward.
LONG_TRAIN_PER_LAYER = {
    "fused": dict(LARGE_PER_LAYER, attention=0, attention_flash=3,
                  attention_flash_k128=3),
    "flash": {"attention_flash_lse": 1, "attention_flash_k128": 1,
              "attention_flash_bwd": 1},
}
# Phase 3i's ViT-L/16@512 runs in fp32 (the blockwise kernels' fp32 forms):
# the fp32 engine at LONG_BATCH on phase 3e's weights and decisive images;
# fp32 Trainer in `fused` and `flash`, F32_TRAIN_STEPS steps at
# LONG_F32_TRAIN_BATCH, then one step of each from random_params seed 1
# against the plain links (phase 5's gates); their launches per layer. A
# ViT-L layer's fp32 weights pass the fused layer's bound
# (`fused_block.supports`, JAX's rule), so the fp32 engine takes the per-op
# path: the attention core is its one kernel, the blockwise forward.
LONG_F32_TRAIN_BATCH = 4
LONG_F32_PER_LAYER = {"attention_flash_f32": 1, "attention_flash_k128": 1}
LONG_F32_TRAIN_PER_LAYER = {
    "fused": dict(F32_TRAIN_PER_LAYER["fused"], fused_bwd_mlp=0, fused_bwd_mlp_light=1,
                  fused_bwd_mlp_wgrad=1, layernorm=6, attention_f32=0,
                  attention_flash_f32=3, attention_flash_k128=3),
    "flash": {"attention_flash_lse_f32": 1, "attention_flash_k128": 1,
              "attention_flash_bwd_f32": 1},
}
# Phase 4d's fp32 AdamW steps at ViT-L/16@512 (beside its bf16 ones at
# LONG_BATCH).
LONG_F32_THROUGHPUT_BATCH = 8

# Phase 2h: the kernel layer's public ops against their plain versions.
# flash_attention's rows: (name, batch, heads, T, head dim, dtype, as the
# permuted views of a packed GEMM output): ViT-B/16 at B = 16 (contiguous
# and as views), B = 256 and fp32 at B = 16; ViT-L/16@384's T = 577 (B = 8);
# the single-pass route's last T, 1024 (B = 4); ViT-L/16@512's T = 1025, the
# split-head blockwise route (B = 4).
PUBLIC_ATTN_ROWS = (
    ("ViT-B/16", 16, 12, 197, 64, torch.bfloat16, False),
    ("ViT-B/16", 16, 12, 197, 64, torch.bfloat16, True),
    ("ViT-B/16", 256, 12, 197, 64, torch.bfloat16, False),
    ("ViT-B/16", 16, 12, 197, 64, torch.float32, False),
    ("ViT-B/16", 256, 12, 197, 64, torch.float32, False),
    ("ViT-L/16@384", 8, 16, 577, 64, torch.bfloat16, False),
    ("the single-pass route's last T", 4, 16, 1024, 64, torch.bfloat16, False),
    ("ViT-L/16@512", 4, 16, 1025, 64, torch.bfloat16, False),
)
# packed_fused_attention in its 849-1024 window (16 heads of 64, B = 4),
# where the packed kernel's first form ran out of shared memory: the packed
# kernel's slab entry.
WINDOW_TS = (900, 1024)
# packed_fused_attention with per-head packing (the TP layout) and
# true_seq_len at the packed body's one-pass limit: 256 keys (one pass) and
# 257 (two) of T = 264, ViT-B/16's heads, B = 16: the packed kernel's entry
# with a key count and a packing.
PER_HEAD_KV_LENS = (256, 257)
PER_HEAD_T = 264
# residual_layer_norm at ViT-B/16's width, M = 197 x 16 and x 256 tokens.
RESIDUAL_LN_ROWS = (3152, 50432)
# fp32 outputs of the single-pass kernel (plain FMA, no TF32): the plain
# version's library matmuls sum in another order; held to this share of the
# output's largest magnitude.
SINGLE_F32_REL = 1e-5
# Phase 6: the public ops composed into one ViT-B/16 layer and its head at
# B = 16 (and flash_attention at ViT-L/16@512's T = 1025, B = 4, bf16 and
# fp32): launches of that run.
PUBLIC_PATH_COUNTS = {"layernorm": 1, "linear": 5, "attention_single": 1,
                      "layernorm_residual": 1, "attention_flash_split": 1,
                      "attention_flash_split_f32": 1, "attention_flash_k128": 2}
PROFILE_BATCH = 64
PROFILE_STAGES = ["patch_embed(+cls+pos)", "layer_norm", "qkv_proj",
                  "attention_core(packed)", "out_proj", "mlp_fc1_gelu", "mlp_fc2",
                  "head+softmax"]
TRACE_ITERS = 3
# The kernel names (substrings of the demangled names in the trace) of the
# forward chains, with the counter of each.
TRACE_KERNELS = {"packed_attention_kernel": "attention",
                 "gemm_sm90_kernel<false, true, 0>": "linear",
                 "layernorm_kernel<": "layernorm"}
# The int8-weight and W8A8 chains: the GEMM core's int8-weight and W8A8
# forms (csrc/gemm_sm90.cuh Form), kernels of their own in the trace.
TRACE_KERNELS_INT8W = {"packed_attention_kernel": "attention",
                       "gemm_sm90_kernel<false, true, 1>": "linear_int8w",
                       "layernorm_kernel<": "layernorm"}
W8A8_GEMM_KERNEL = "gemm_sm90_kernel<false, false, 2>"
TRACE_KERNELS_W8A8 = {"packed_attention_kernel": "attention",
                      W8A8_GEMM_KERNEL: "linear_w8a8",
                      "quantize_rows_kernel": "quantize",
                      "layernorm_kernel<": "layernorm"}

# Phases 2i, 3f and 4e: ring attention and the multi-device forwards on a
# virtual mesh of the one card (MESH_SHARDS shards, all cuda:0): a real
# 4-step ring through the carried kernel, not multi-card scaling.
MESH_SHARDS = 4
RING_BATCH = 8  # phase 3f's bf16 ring forward at ViT-L/16@512
RING_F32_BATCH = 2  # and its fp32 one
RING_THROUGHPUT_BATCHES = (8, 16)  # phase 4e
# Phase 2i's rows: (name, batch, heads, t_loc, head dim, block_k, masked
# keys): ViT-L/16@512 (T = 1025) on 4 shards (t_loc 257, the last shard's
# 3 padded keys) at phase 3f's B = 8 and at B = 4, on 8 shards (129, 7
# padded), ViT-B/16 on one shard (197), ViT-H/14@518 (T = 1370) on 4 shards
# (343, hd 80, 2 padded), and two 512-key blocks in one call.
RING_ROWS = (
    ("ViT-L/16@512 4 shards", RING_BATCH, 16, 257, 64, 257, 3),
    ("ViT-L/16@512 4 shards", 4, 16, 257, 64, 257, 3),
    ("ViT-L/16@512 8 shards", 4, 16, 129, 64, 129, 7),
    ("ViT-B/16 1 shard", 16, 12, 197, 64, 197, 0),
    ("ViT-H/14@518 4 shards", 4, 16, 343, 80, 343, 2),
    ("two 512-key blocks", 4, 16, 1024, 64, 512, 0),
)
RING_ROTATIONS = 4
# The ring step's outputs are fp32: m and l the same sums in another order
# (1e-5 of scale); acc too at fp32, and at bf16 a p rounded the other way
# moves its term by a bf16 ulp (2e-3 of scale covers it).
RING_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
# Phase 3f's W8A8 tensor-parallel forward against fp32 (the comparator's
# probability gate): int8 activations move probabilities by more than the
# bf16 budget.
W8A8_TP_TOL = 1e-2

# Phase 2j: the W8A8 overlap probe's kernels (csrc/probe_overlap.cu, the
# last TPU kernels: scripts/probe_w8a8_overlap.py's six, the sixth in two
# forms) against their plain versions at a grid of PROBE_CHECK_GRID blocks
# and N = 3072, on the probe's data and on seeded random data: the int8
# values, the scales, the stream's output and the GEMMs' bf16 outputs
# bit-identical; the LN's bf16 outputs within one bf16 ulp (near 0, one fp32
# ulp of their unit scale: the row's mean carries its own rounding there)
# and MIN_SAME_KERNEL identical. Then the probe's main() at its full grid
# (256 blocks) is the main path; each form is held to its plain version
# again on main()'s data at that grid (the kernels line's max_abs_err), and
# its time there over its time at PROBE_RATIO_GRID blocks must lie in
# PROBE_RATIO (4 by the work; below it, blocks' work was dropped).
PROBE_CHECK_GRID = 4
PROBE_RATIO_GRID = 64
PROBE_RATIO = (3.0, 5.0)
# form (probe.FORMS) -> (its counter here, its PERF.md row, the TPU kernel's line)
PROBE_FORMS = {
    "stream": ("probe_stream", "18a", 88),
    "vpu:q": ("probe_vpu_quant", "18b", 92),
    "vpu:ln": ("probe_vpu_ln", "18c", 100),
    "mxu": ("probe_mxu", "18d", 106),
    "fused": ("probe_fused", "18e", 116),
    "indep:q": ("probe_indep_quant", "18f quant", 126),
    "indep:ln": ("probe_indep_ln", "18f ln", 126),
}
# Phase 3g: serving on the card. The batch is serve.py's default; requests
# of 8 images from 4 clients let the batcher fill a batch from several.
SERVE_BATCH = 32
SERVE_PAYLOAD = 8
SERVE_CLIENTS = 4
SERVE_WAIT_MS = 5.0  # serve.py's default --max-wait-ms
SERVE_SHARDS = 4  # DataParallelEngine on a virtual mesh of the card
# Printed, not gated: served img/s and request latency at these batches,
# each request batch / SERVE_CLIENTS images (soak_serve's split). A window
# closes once it has answered SERVE_RATE_REQUESTS requests, or at its
# batch's time limit; a percentile is printed only where the window holds
# enough requests for it (p99: 100, soak_serve.percentile_ms).
SERVE_RATE_BATCHES = (32, 256)
SERVE_RATE_REQUESTS = 200
SERVE_RATE_SECONDS = {32: 5.0, 256: 10.0}
# engine.run's stages, timed on the batcher's thread (split_run).
RUN_STAGES = ("pad", "upload", "forward", "copy back")
# Phase 3h: --raw-images on PNGs of these sizes (seeded uint8 pixels).
RAW_IMAGE_SHAPES = ((250, 270, 3), (300, 240, 3), (224, 224, 3), (400, 300, 3))
# Phase 7: the record-producing scripts on the card.
FIXTURE_IMAGES = 4
SOAK_ARGS = [CFG.name, "256", "10", "5", "int8-w8a8"]  # 2 windows of 5
TRACE_ARGS = [CFG.name, "64", "2", "15", "int8-w8a8"]
BENCH_TRAIN_ARGS = [CFG.name, "32", "2", "fused"]  # with AUG=1
RECIPE_SMOKE_ARGS = [CFG.name, "32", "3"]
SOAK_SERVE_ARGS = [CFG.name, "64", "5", "2", "int8-w8a8"]

# Published dense peaks (NVIDIA data sheets): tensor-core bf16 FLOP/s,
# CUDA-core fp32 FLOP/s, tensor-core int8 OP/s, memory bytes/s.
PEAKS = {
    "H100 PCIe": {"bf16": 756e12, "fp32": 51e12, "int8": 1513e12, "bytes": 2.0e12},
    "H100 NVL": {"bf16": 835e12, "fp32": 60e12, "int8": 1671e12, "bytes": 3.9e12},
    "H100": {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12, "bytes": 3.35e12},
}

# Each kernel's launch counter: (module, attribute).
COUNTERS = {
    "layernorm": (layernorm, "LAUNCHES"),
    "linear": (linear, "LAUNCHES"),
    "attention": (attention, "LAUNCHES"),
    "fused_block": (fused_block, "LAUNCHES"),
    "quantize": (quantize, "LAUNCHES"),
    "linear_w8a8": (linear, "LAUNCHES_W8A8"),
    "linear_int8w": (linear, "LAUNCHES_INT8W"),
    "fused_block_w8a8": (fused_block, "LAUNCHES_W8A8"),
    "fused_block_int8w": (fused_block, "LAUNCHES_INT8W"),
    "quantize_split": (quantize, "LAUNCHES_SPLIT"),
    "quantize_masked": (quantize, "LAUNCHES_MASKED"),
    "linear_w8a8_hi": (linear, "LAUNCHES_W8A8_HI"),
    "fused_block_w8a8_outlier": (fused_block, "LAUNCHES_W8A8_OUTLIER"),
    "fused_block_stack": (fused_block, "LAUNCHES_STACK"),
    "fused_block_stack_int8w": (fused_block, "LAUNCHES_STACK_INT8W"),
    "fused_block_stack_w8a8": (fused_block, "LAUNCHES_STACK_W8A8"),
    "fused_block_group": (fused_block, "LAUNCHES_GROUP"),
    "attention_bwd": (attention, "LAUNCHES_BWD"),
    "linear_dgrad": (linear, "LAUNCHES_DGRAD"),
    "linear_wgrad": (linear, "LAUNCHES_WGRAD"),
    "linear_gelu_pair": (linear, "LAUNCHES_GELU_PAIR"),
    "layernorm_bwd": (layernorm, "LAUNCHES_BWD"),
    "column_sum": (layernorm, "LAUNCHES_COLSUM"),
    "fused_bwd_x2": (fused_block, "LAUNCHES_BWD_X2"),
    "fused_bwd_mlp": (fused_block, "LAUNCHES_BWD_MLP"),
    "fused_bwd_mlp_light": (fused_block, "LAUNCHES_BWD_MLP_LIGHT"),
    "fused_bwd_mlp_wgrad": (fused_block, "LAUNCHES_BWD_MLP_WGRAD"),
    "fused_bwd_attn": (fused_block, "LAUNCHES_BWD_ATTN"),
    "fused_bwd": (fused_block, "LAUNCHES_BWD"),
    "attention_flash": (attention, "LAUNCHES_FLASH"),
    "attention_flash_lse": (attention, "LAUNCHES_FLASH_LSE"),
    "attention_flash_bwd": (attention, "LAUNCHES_FLASH_BWD"),
    "attention_single": (attention, "LAUNCHES_SINGLE"),
    "attention_flash_split": (attention, "LAUNCHES_FLASH_SPLIT"),
    "layernorm_residual": (layernorm, "LAUNCHES_RESIDUAL"),
    "attention_ring": (attention, "LAUNCHES_RING"),
    # The fp32 forms: the fp32 GEMM's four, the fp32 slab attention and the
    # fp32 attention backward.
    "linear_f32": (linear, "LAUNCHES_F32"),
    "linear_dgrad_f32": (linear, "LAUNCHES_DGRAD_F32"),
    "linear_wgrad_f32": (linear, "LAUNCHES_WGRAD_F32"),
    "linear_gelu_pair_f32": (linear, "LAUNCHES_GELU_PAIR_F32"),
    "attention_f32": (attention, "LAUNCHES_PACKED_F32"),
    "attention_bwd_f32": (attention, "LAUNCHES_BWD_F32"),
    # The blockwise kernels' fp32 forms: the forward on the slabs without
    # and with the LSE, on split heads, and the backward.
    "attention_flash_f32": (attention, "LAUNCHES_FLASH_F32"),
    "attention_flash_lse_f32": (attention, "LAUNCHES_FLASH_LSE_F32"),
    "attention_flash_split_f32": (attention, "LAUNCHES_FLASH_SPLIT_F32"),
    "attention_flash_bwd_f32": (attention, "LAUNCHES_FLASH_BWD_F32"),
    # The blockwise forward's launches by key tile (its three forms together,
    # bf16 and fp32).
    **{f"attention_flash_k{bk}": (attention, f"LAUNCHES_FLASH_K{bk}")
       for bk in attention.FLASH_BLOCK_KS},
    **{counter: (probe, probe.FORMS[form].counter)
       for form, (counter, *_) in PROBE_FORMS.items()},
}
_QUANTIZED_LAYER = "vit_with_opencl_tpu/ops/fused_block.py:198"
REPLACES = {
    "layernorm": "vit_with_opencl_tpu/ops/layernorm.py:33",
    "linear": "vit_with_opencl_tpu/ops/linear.py:36",
    "attention": "vit_with_opencl_tpu/ops/attention.py:872",
    "fused_block": "vit_with_opencl_tpu/ops/fused_block.py:198",
    "quantize": _QUANTIZED_LAYER, "linear_w8a8": _QUANTIZED_LAYER,
    "linear_int8w": _QUANTIZED_LAYER, "fused_block_w8a8": _QUANTIZED_LAYER,
    "fused_block_int8w": _QUANTIZED_LAYER,
    # _block_kernel with outlier=True: _mm with hi_ref (its quantize at :111,
    # its side GEMM at :114) and _mm_ctx_masked (:128).
    "quantize_split": "vit_with_opencl_tpu/ops/fused_block.py:111",
    "quantize_masked": "vit_with_opencl_tpu/ops/fused_block.py:128",
    "linear_w8a8_hi": "vit_with_opencl_tpu/ops/fused_block.py:109",
    "fused_block_w8a8_outlier": _QUANTIZED_LAYER,
    "fused_block_stack": "vit_with_opencl_tpu/ops/fused_block.py:471",
    "fused_block_stack_int8w": "vit_with_opencl_tpu/ops/fused_block.py:471",
    "fused_block_stack_w8a8": "vit_with_opencl_tpu/ops/fused_block.py:471",
    "fused_block_group": _QUANTIZED_LAYER,
    # Training: _packed_bwd_kernel, and the three kernels of
    # fused_encoder_layer_bwd; the GEMM forms, the LN backward and the column
    # sum are links of the MLP-backward kernel (and of _attn_bwd_kernel).
    "attention_bwd": "vit_with_opencl_tpu/ops/attention.py:463",
    "fused_bwd_x2": "vit_with_opencl_tpu/ops/fused_block.py:744",
    "fused_bwd_mlp": "vit_with_opencl_tpu/ops/fused_block.py:762",
    "fused_bwd_mlp_light": "vit_with_opencl_tpu/ops/fused_block.py:815",
    "fused_bwd_mlp_wgrad": "vit_with_opencl_tpu/ops/fused_block.py:852",
    "fused_bwd_attn": "vit_with_opencl_tpu/ops/fused_block.py:875",
    "linear_dgrad": "vit_with_opencl_tpu/ops/fused_block.py:762",
    "linear_wgrad": "vit_with_opencl_tpu/ops/fused_block.py:762",
    "linear_gelu_pair": "vit_with_opencl_tpu/ops/fused_block.py:762",
    "layernorm_bwd": "vit_with_opencl_tpu/ops/fused_block.py:762",
    "column_sum": "vit_with_opencl_tpu/ops/fused_block.py:762",
    # The blockwise route: _flash_kernel, _flash_kernel_lse, and the pair
    # _flash_bwd_dq_kernel (:586) and _flash_bwd_dkv_kernel (:614).
    "attention_flash": "vit_with_opencl_tpu/ops/attention.py:85",
    "attention_flash_lse": "vit_with_opencl_tpu/ops/attention.py:140",
    "attention_flash_bwd": "vit_with_opencl_tpu/ops/attention.py:586",
    # The kernel layer's public ops: _single_pass_kernel (flash_attention up
    # to T = 1024), _flash_kernel on split heads, _ln_residual_kernel.
    "attention_single": "vit_with_opencl_tpu/ops/attention.py:146",
    "attention_flash_split": "vit_with_opencl_tpu/ops/attention.py:85",
    "layernorm_residual": "vit_with_opencl_tpu/ops/layernorm.py:44",
    # The ring-attention local step (blockwise_ring_step).
    "attention_ring": "vit_with_opencl_tpu/ops/attention.py:354",
    # The fp32 forms: _linear_kernel and the encoder's _mm in fp32, the
    # backward's _dot forms, _packed_kernel's slabs and _packed_bwd_kernel.
    "linear_f32": "vit_with_opencl_tpu/ops/linear.py:36",
    "linear_dgrad_f32": "vit_with_opencl_tpu/ops/fused_block.py:704",
    "linear_wgrad_f32": "vit_with_opencl_tpu/ops/fused_block.py:704",
    "linear_gelu_pair_f32": "vit_with_opencl_tpu/ops/fused_block.py:704",
    "attention_f32": "vit_with_opencl_tpu/ops/attention.py:872",
    "attention_bwd_f32": "vit_with_opencl_tpu/ops/attention.py:463",
    # _flash_kernel, _flash_kernel_lse and the backward pair in fp32.
    "attention_flash_f32": "vit_with_opencl_tpu/ops/attention.py:85",
    "attention_flash_lse_f32": "vit_with_opencl_tpu/ops/attention.py:140",
    "attention_flash_split_f32": "vit_with_opencl_tpu/ops/attention.py:85",
    "attention_flash_bwd_f32": "vit_with_opencl_tpu/ops/attention.py:586",
    # _flash_kernel at each key tile (JAX's block_k).
    **{f"attention_flash_k{bk}": "vit_with_opencl_tpu/ops/attention.py:85"
       for bk in attention.FLASH_BLOCK_KS},
}
_CSRC = "vit_with_opencl_tpu_torch/csrc/"
SOURCES = {
    "layernorm": _CSRC + "layernorm.cu",
    "linear": _CSRC + "gemm_sm90.cuh",
    "attention": _CSRC + "attention.cu",
    "fused_block": "vit_with_opencl_tpu_torch/ops/fused_block.py",
    "quantize": _CSRC + "quantize.cu",
    "linear_w8a8": _CSRC + "gemm_sm90.cuh",
    "linear_int8w": _CSRC + "gemm_sm90.cuh",
    "fused_block_w8a8": "vit_with_opencl_tpu_torch/ops/fused_block.py",
    "fused_block_int8w": "vit_with_opencl_tpu_torch/ops/fused_block.py",
    "quantize_split": _CSRC + "quantize.cu",
    "quantize_masked": _CSRC + "quantize.cu",
    "linear_w8a8_hi": _CSRC + "gemm_sm90.cuh",
    "fused_block_w8a8_outlier": "vit_with_opencl_tpu_torch/ops/fused_block.py",
    "fused_block_stack": "vit_with_opencl_tpu_torch/ops/fused_block.py",
    "fused_block_stack_int8w": "vit_with_opencl_tpu_torch/ops/fused_block.py",
    "attention_bwd": _CSRC + "attention_bwd.cu",
    "linear_dgrad": _CSRC + "gemm_sm90.cuh",
    "linear_wgrad": _CSRC + "gemm_sm90.cuh",
    "linear_gelu_pair": _CSRC + "gemm_sm90.cuh",
    "layernorm_bwd": _CSRC + "layernorm.cu",
    "column_sum": _CSRC + "reduce.cu",
    "fused_bwd_x2": "vit_with_opencl_tpu_torch/ops/fused_block.py",
    "fused_bwd_mlp": "vit_with_opencl_tpu_torch/ops/fused_block.py",
    "fused_bwd_mlp_light": "vit_with_opencl_tpu_torch/ops/fused_block.py",
    "fused_bwd_mlp_wgrad": "vit_with_opencl_tpu_torch/ops/fused_block.py",
    "fused_bwd_attn": "vit_with_opencl_tpu_torch/ops/fused_block.py",
    "attention_flash": _CSRC + "attention_flash.cu",
    "attention_flash_lse": _CSRC + "attention_flash.cu",
    "attention_flash_bwd": _CSRC + "attention_flash.cu",
    # bf16: the packed kernel's body (single_pass_attention_kernel); the
    # fp32 rows name csrc/attention_single.cu themselves.
    "attention_single": _CSRC + "attention.cu",
    "attention_flash_split": _CSRC + "attention_flash.cu",
    "layernorm_residual": _CSRC + "layernorm.cu",
    "attention_ring": _CSRC + "attention_ring.cu",
    "linear_f32": _CSRC + "gemm_f32.cu",
    "linear_dgrad_f32": _CSRC + "gemm_f32.cu",
    "linear_wgrad_f32": _CSRC + "gemm_f32.cu",
    "linear_gelu_pair_f32": _CSRC + "gemm_f32.cu",
    "attention_f32": _CSRC + "attention_single.cu",
    "attention_bwd_f32": _CSRC + "attention_bwd_f32.cu",
    "attention_flash_f32": _CSRC + "attention_flash_f32.cu",
    "attention_flash_lse_f32": _CSRC + "attention_flash_f32.cu",
    "attention_flash_split_f32": _CSRC + "attention_flash_f32.cu",
    "attention_flash_bwd_f32": _CSRC + "attention_bwd_f32.cu",
    **{f"attention_flash_k{bk}": _CSRC + "attention_flash.cu"
       for bk in attention.FLASH_BLOCK_KS},
    **{counter: _CSRC + "probe_overlap.cu" for counter, *_ in PROBE_FORMS.values()},
}
# The main-path runs: phase name → CLI flags (the outlier runs add
# --calibrate with their workspace's calibration binary).
MODES = {"bf16": [], "w8a8": ["--quantize", "int8-w8a8"],
         "int8": ["--quantize", "int8"], "auto": ["--quantize", "auto"],
         "w8a8_outlier": ["--quantize", "int8-w8a8"],
         "auto_outlier": ["--quantize", "auto"]}
# Which run each kernel's launch count is read from, and its count per layer.
PER_LAYER = {
    "bf16": {"layernorm": 2, "linear": 4, "attention": 1, "fused_block": 1},
    "w8a8": {"layernorm": 2, "quantize": 4, "linear_w8a8": 4, "attention": 1,
             "fused_block_w8a8": 1},
    "int8": {"layernorm": 2, "linear_int8w": 4, "attention": 1,
             "fused_block_int8w": 1},
}
PER_LAYER["auto"] = PER_LAYER["w8a8"]
PER_LAYER["w8a8_outlier"] = PER_LAYER["auto_outlier"] = {
    "layernorm": 2, "quantize_split": 3, "quantize_masked": 1,
    "linear_w8a8_hi": 4, "attention": 1, "fused_block_w8a8_outlier": 1}

failures: list[str] = []


T_START = time.perf_counter()


def phase(title: str) -> None:
    """A phase's heading, with the seconds since the script started."""
    print(f"{title} [{time.perf_counter() - T_START:.1f} s]", flush=True)


def check(ok: bool, what: str) -> None:
    print(f"{'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        failures.append(what)


def peaks() -> dict:
    name = torch.cuda.get_device_name(0)
    for key, value in PEAKS.items():
        if key in name:
            return value
    return PEAKS["H100"]


def time_ms(fn, reps: int = REPS) -> float:
    """Mean device time of one call, by CUDA events around ``reps`` calls
    after a warm-up."""
    for _ in range(3):
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


def bound(nbytes: float, ops: dict) -> tuple:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peaks ({kind: count})."""
    peak = peaks()
    t_bytes = nbytes / peak["bytes"]
    t_ops = sum(count / peak[kind] for kind, count in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(out: torch.Tensor, ref: torch.Tensor, tol: tuple) -> tuple:
    """(max abs error, within tolerance, share of elements bit-identical to
    the plain version's, mean abs error)."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    rtol, atol = tol
    within = bool((diff <= atol + rtol * ref.abs()).all())
    # The share from an exact count: a float32 mean of ones over millions of
    # elements (a sum times 1/N) can come out one ulp below 1.
    return (float(diff.max()), within, int((diff == 0).sum()) / diff.numel(),
            float(diff.mean()))


def layer_params(gen: torch.Generator, dev, cfg=CFG) -> dict:
    d, h = cfg.embed_dim, cfg.hidden_dim

    def rnd(*shape, std=0.02, mean=0.0, dtype=torch.bfloat16):
        t = torch.randn(shape, generator=gen, device=dev) * std + mean
        return t.to(dtype).contiguous()

    return {"ln1_w": rnd(d, mean=1.0, dtype=torch.float32),
            "ln1_b": rnd(d, dtype=torch.float32),
            "qkv_w": rnd(d, 3 * d), "qkv_b": rnd(3 * d, dtype=torch.float32),
            "out_w": rnd(d, d), "out_b": rnd(d, dtype=torch.float32),
            "ln2_w": rnd(d, mean=1.0, dtype=torch.float32),
            "ln2_b": rnd(d, dtype=torch.float32),
            "fc1_w": rnd(d, h), "fc1_b": rnd(h, dtype=torch.float32),
            "fc2_w": rnd(h, d), "fc2_b": rnd(d, dtype=torch.float32)}


def ln_case(name, counter, x, w, b, out_dtype, library, eps=CFG.eps):
    m, d = x.numel() // x.shape[-1], x.shape[-1]
    out_b = 2 if out_dtype == torch.bfloat16 else 4
    return dict(name=name, counter=counter,
                tol=BF16_TOL if out_dtype == torch.bfloat16 else F32_TOL,
                min_same=MIN_SAME_KERNEL if out_dtype == torch.bfloat16 else 0.0,
                kernel=lambda: layernorm.layer_norm(x, w, b, eps, out_dtype=out_dtype),
                plain=lambda: layernorm.layer_norm_reference(x, w, b, eps,
                                                             out_dtype=out_dtype),
                library=library, bytes=m * d * (x.element_size() + out_b) + 2 * d * 4,
                ops={"fp32": 8 * m * d})


def epilogue_ops(y, kw, n, out_dtype):
    """The rest of a GEMM's epilogue as PyTorch ops (library yardsticks)."""
    if kw.get("residual") is not None:
        y = kw["residual"].reshape(-1, n) + y
    if kw.get("fuse_gelu"):
        y = torch.nn.functional.gelu(y, approximate="tanh")
    return y.to(out_dtype)


def attn_fwd_case(qkv, nh: int, hd: int) -> dict:
    """The packed attention (row 4) on qkv [B, T, 3D] against its plain
    version; yardstick SDPA on the same q, k, v. Bound: q, k, v read and the
    context written once; 4·T²·hd operations a head."""
    b, t, _ = qkv.shape
    q, k, v = qkv.reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
    return dict(name="packed_fused_attention (bf16)", counter="attention",
                tol=BF16_TOL, min_same=MIN_SAME_KERNEL,
                kernel=lambda: attention.packed_fused_attention(qkv, num_heads=nh,
                                                                head_dim=hd),
                plain=lambda: attention.packed_fused_attention_reference(qkv, nh, hd),
                library=lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
                bytes=b * t * 4 * nh * hd * 2, ops={"bf16": 4 * b * nh * t * t * hd})


def quantize_case(site: str, inp: torch.Tensor) -> dict:
    """Row 5a (``quantize_rows``) on ``inp`` against its plain version:
    codes and scales bit-identical. Bound: each value read once, each code
    and scale written once."""
    rows = inp.numel() // inp.shape[-1]
    return dict(
        name=f"quantize_rows {site} ({'bf16' if inp.dtype == torch.bfloat16 else 'fp32'} in)",
        counter="quantize", tol=EXACT, min_same=1.0,
        kernel=lambda: quantize.quantize_rows(inp),
        plain=lambda: quantize.quantize_rows_reference(inp), library=None,
        bytes=inp.numel() * (inp.element_size() + 1) + 4 * rows,
        ops={"fp32": 3 * inp.numel()})


def split_case(site: str, inp: torch.Tensor, mq: int) -> dict:
    """Row 6a (``quantize_rows_split``) on the fp32 ``inp``, its leading
    ``mq`` columns quantized: codes, scales and the bf16 tail bit-identical
    to its plain version."""
    k, rows, bf = inp.shape[-1], inp.numel() // inp.shape[-1], torch.bfloat16
    return dict(
        name=f"quantize_rows_split {site} (fp32 in, int8 [{mq}] + bf16 [{k - mq}] out)",
        counter="quantize_split", tol=EXACT, min_same=1.0,
        kernel=lambda: quantize.quantize_rows_split(inp, mq, bf),
        plain=lambda: quantize.quantize_rows_split_reference(inp, mq, bf),
        library=None, bytes=rows * (k * 4 + mq + (k - mq) * 2 + 4),
        ops={"fp32": 3 * rows * mq})


def masked_case(site: str, ctx: torch.Tensor, nh: int, hd: int, kh: int) -> dict:
    """Row 6b (``quantize_rows_masked``) on the bf16 context ``ctx``: codes,
    scales and the nh x kh tails bit-identical to its plain version. Bound:
    the context read once, its codes, tails and scales written once."""
    rows, d = ctx.numel() // ctx.shape[-1], ctx.shape[-1]
    return dict(
        name=f"quantize_rows_masked {site} (bf16 in, {nh} x {kh} tails out)",
        counter="quantize_masked", tol=EXACT, min_same=1.0,
        kernel=lambda: quantize.quantize_rows_masked(ctx, nh, hd, kh),
        plain=lambda: quantize.quantize_rows_masked_reference(ctx, nh, hd, kh),
        library=None, bytes=rows * (d * 3 + nh * kh * 2 + 4), ops={"fp32": 3 * rows * d})


def seeded_context(cfg, batch: int, gen: torch.Generator, dev) -> torch.Tensor:
    """A bf16 attention context [batch, T, D] at unit scale whose heads'
    last columns are 30x (outlier channels in the tails, as calibrated)."""
    ctx = torch.randn((batch, cfg.num_tokens, cfg.embed_dim), generator=gen, device=dev)
    ctx[..., cfg.head_dim - 1::cfg.head_dim] *= 30.0
    return ctx.to(torch.bfloat16)


def default_kh(cfg) -> int:
    """The calibrated planner's default tail a head (models/quant.py)."""
    return max(2, cfg.head_dim // 8)


def kernel_rows(batch: int, dev, seed: int = 0, cfg=CFG) -> list[dict]:
    """Every kernel of the bf16 chain on the chain's own intermediates at
    ``batch`` images: error against the plain version, times, bound."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lp = layer_params(gen, dev, cfg)
    d, h, t, nh, hd, eps = (cfg.embed_dim, cfg.hidden_dim, cfg.num_tokens,
                            cfg.num_heads, cfg.head_dim, cfg.eps)
    m, bf, f32 = batch * t, torch.bfloat16, torch.float32
    x = (torch.randn((batch, t, d), generator=gen, device=dev) * 0.5).to(bf)
    # The chain's intermediates, from the plain versions.
    h1 = layernorm.layer_norm_reference(x, lp["ln1_w"], lp["ln1_b"], eps)
    qkv = linear.fused_linear_reference(h1, lp["qkv_w"], lp["qkv_b"])
    ctx = attention.packed_fused_attention_reference(qkv, nh, hd)
    x1 = linear.fused_linear_reference(ctx, lp["out_w"], lp["out_b"],
                                       residual=x, out_dtype=f32)
    h2 = layernorm.layer_norm_reference(x1, lp["ln2_w"], lp["ln2_b"], eps,
                                        out_dtype=bf)
    hid = linear.fused_linear_reference(h2, lp["fc1_w"], lp["fc1_b"],
                                        fuse_gelu=True)
    b16 = {key: lp[key].to(bf) for key in ("ln1_w", "ln1_b")}
    F = torch.nn.functional

    def gemm(name, inp, wkey, bkey, n, k_dim, out_dtype, **kw):
        res_b = kw["residual"].element_size() if "residual" in kw else 0
        out_b = 2 if out_dtype == bf else 4
        nbytes = m * k_dim * 2 + k_dim * n * 2 + n * 4 + m * n * (res_b + out_b)
        bias = lp[bkey].to(bf)

        def library():
            # cuBLAS with a bias epilogue, then any further epilogue as
            # library ops (no single call fuses a residual or a GELU).
            y = torch.addmm(bias, inp.reshape(m, k_dim), lp[wkey])
            return epilogue_ops(y, kw, n, out_dtype)

        return dict(
            name=name, counter="linear",
            tol=BF16_TOL if out_dtype == bf else F32_TOL,
            min_same=MIN_SAME_KERNEL if out_dtype == bf else 0.0,
            kernel=lambda: linear.fused_linear(inp, lp[wkey], lp[bkey],
                                               out_dtype=out_dtype, **kw),
            plain=lambda: linear.fused_linear_reference(inp, lp[wkey], lp[bkey],
                                                        out_dtype=out_dtype, **kw),
            library=library, bytes=nbytes, ops={"bf16": 2 * m * n * k_dim})

    cases = [
        ln_case("layer_norm LN1 (bf16 in, bf16 out)", "layernorm", x,
                lp["ln1_w"], lp["ln1_b"], bf,
                lambda: F.layer_norm(x, (d,), b16["ln1_w"], b16["ln1_b"], eps),
                eps=eps),
        gemm("fused_linear qkv (+bias, bf16 out)", h1, "qkv_w", "qkv_b", 3 * d, d, bf),
        attn_fwd_case(qkv, nh, hd),
        gemm("fused_linear out-proj (+bf16 residual, +bias, fp32 out)", ctx,
             "out_w", "out_b", d, d, f32, residual=x),
        ln_case("layer_norm LN2 (fp32 in, bf16 out)", "layernorm", x1,
                lp["ln2_w"], lp["ln2_b"], bf,
                lambda: F.layer_norm(x1, (d,), lp["ln2_w"], lp["ln2_b"], eps),
                eps=eps),
        gemm("fused_linear fc1 (+bias, _gelu_fast, bf16 out)", h2, "fc1_w", "fc1_b",
             h, d, bf, fuse_gelu=True),
        gemm("fused_linear fc2 (+fp32 residual, +bias, bf16 out)", hid, "fc2_w",
             "fc2_b", d, h, bf, residual=x1),
    ]
    weight_bytes = (4 * d * d + 2 * d * h) * 2 + (9 * d + h) * 4
    cases.append(dict(
        name="fused_encoder_layer (the chain of the 7 launches above)",
        counter="fused_block", tol=BF16_TOL, min_same=MIN_SAME_CHAIN,
        kernel=lambda: fused_block.fused_encoder_layer(x, lp, cfg),
        plain=lambda: fused_block.fused_encoder_layer_reference(x, lp, cfg),
        library=None, bytes=2 * m * d * 2 + weight_bytes,
        ops={"bf16": 2 * m * d * (4 * d + 2 * h) + 4 * batch * t * t * d}))
    return run_cases(cases, batch, prefix(cfg))


def int8_kernel_rows(batch: int, dev, seed: int = 0, cfg=CFG) -> list[dict]:
    """The int8 kernels on the W8A8 and weight-only chains' own intermediates
    (from the plain versions) at ``batch`` images."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lp = layer_params(gen, dev, cfg)
    for key in ("qkv_w", "out_w", "fc1_w", "fc2_w"):
        lp[key] = quant.quantize_weight_device(lp[key])
    # The W8A8 chain's weights in its GEMM's layout (K-major, as the engine
    # stores them); the weight-only chain keeps the row-major ones.
    lp8 = quant.w8a8_layout({"layers": lp})["layers"]
    d, h, t, nh, hd = (cfg.embed_dim, cfg.hidden_dim, cfg.num_tokens,
                       cfg.num_heads, cfg.head_dim)
    m, bf, f32 = batch * t, torch.bfloat16, torch.float32
    x = (torch.randn((batch, t, d), generator=gen, device=dev) * 0.5).to(bf)
    F = torch.nn.functional
    eps = cfg.eps

    def w8(key, inp, **kw):
        xq, sx = quant.quantize_act(inp)
        return linear.fused_linear_w8a8_reference(
            xq, sx, lp[key]["q"], lp[key]["scale"], lp[key[:-1] + "b"], **kw)

    # The W8A8 chain's intermediates.
    a1 = layernorm.layer_norm_reference(x, lp["ln1_w"], lp["ln1_b"], eps, out_dtype=f32)
    aqkv = w8("qkv_w", a1, out_dtype=bf)
    actx = attention.packed_fused_attention_reference(aqkv, nh, hd)
    ax1 = w8("out_w", actx, residual=x, out_dtype=f32)
    a2 = layernorm.layer_norm_reference(ax1, lp["ln2_w"], lp["ln2_b"], eps, out_dtype=f32)
    ahid = w8("fc1_w", a2, fuse_gelu=True, out_dtype=f32)
    quantized = {name: quant.quantize_act(inp) for name, inp in
                 (("qkv", a1), ("out", actx), ("fc1", a2), ("fc2", ahid))}

    # The weight-only chain's intermediates.
    def iw(key, inp, **kw):
        return linear.fused_linear_reference(inp, lp[key]["q"], lp[key[:-1] + "b"],
                                             w_scale=lp[key]["scale"], **kw)

    b1 = layernorm.layer_norm_reference(x, lp["ln1_w"], lp["ln1_b"], eps)
    bctx = attention.packed_fused_attention_reference(iw("qkv_w", b1), nh, hd)
    bx1 = iw("out_w", bctx, residual=x, out_dtype=f32)
    b2 = layernorm.layer_norm_reference(bx1, lp["ln2_w"], lp["ln2_b"], eps, out_dtype=bf)
    bhid = iw("fc1_w", b2, fuse_gelu=True)

    def w8a8_case(name, site, wkey, n, k_dim, out_dtype, **kw):
        xq, sx = quantized[site]
        wq, sw, bias = lp8[wkey]["q"], lp8[wkey]["scale"], lp8[wkey[:-1] + "b"]
        w_rows = lp[wkey]["q"]  # the same values row-major
        res_b = kw["residual"].element_size() if "residual" in kw else 0
        out_b = 2 if out_dtype == bf else 4
        gelu = kw.get("fuse_gelu", False)

        def library(w=wq):
            acc = torch._int_mm(xq.reshape(m, k_dim), w)
            y = acc.float() * sx.reshape(m, 1) * sw + bias
            return epilogue_ops(y, kw, n, out_dtype)

        return dict(
            name=name, counter="linear_w8a8",
            tol=F32_TOL if gelu else EXACT, min_same=MIN_SAME_KERNEL if gelu else 1.0,
            kernel=lambda: linear.fused_linear_w8a8(xq, sx, wq, sw, bias,
                                                    out_dtype=out_dtype, **kw),
            plain=lambda: linear.fused_linear_w8a8_reference(
                xq, sx, wq, sw, bias, out_dtype=out_dtype, **kw),
            library=library,
            yardsticks={"torch._int_mm alone, K-major w":
                        lambda: torch._int_mm(xq.reshape(m, k_dim), wq),
                        "torch._int_mm + epilogue ops, row-major w":
                        lambda: library(w_rows)},
            bytes=m * k_dim + k_dim * n + 4 * m + 8 * n + m * n * (res_b + out_b),
            ops={"int8": 2 * m * n * k_dim})

    def int8w_case(name, inp, wkey, n, k_dim, out_dtype, **kw):
        wq, sw, bias = lp[wkey]["q"], lp[wkey]["scale"], lp[wkey[:-1] + "b"]
        w_bf16 = wq.to(bf)
        res_b = kw["residual"].element_size() if "residual" in kw else 0
        out_b = 2 if out_dtype == bf else 4

        def library():
            y = torch.mm(inp.reshape(m, k_dim), w_bf16).float() * sw + bias
            return epilogue_ops(y, kw, n, out_dtype)

        return dict(
            name=name, counter="linear_int8w",
            tol=BF16_TOL if out_dtype == bf else F32_TOL,
            min_same=MIN_SAME_KERNEL if out_dtype == bf else 0.0,
            kernel=lambda: linear.fused_linear(inp, wq, bias, w_scale=sw,
                                               out_dtype=out_dtype, **kw),
            plain=lambda: linear.fused_linear_reference(
                inp, wq, bias, w_scale=sw, out_dtype=out_dtype, **kw),
            library=library,
            bytes=m * k_dim * 2 + k_dim * n + 8 * n + m * n * (res_b + out_b),
            ops={"bf16": 2 * m * n * k_dim})

    weight_bytes = (4 * d * d + 2 * d * h) + (6 * d + 2 * h) * 4 + (9 * d + h) * 4
    attn_ops = 4 * batch * t * t * d
    gemm_ops = 2 * m * d * (4 * d + 2 * h)
    cases = [
        ln_case("layer_norm LN1 (bf16 in, fp32 out; W8A8)", "layernorm", x,
                lp["ln1_w"], lp["ln1_b"], f32,
                lambda: F.layer_norm(x.float(), (d,), lp["ln1_w"], lp["ln1_b"], eps),
                eps=eps),
        ln_case("layer_norm LN2 (fp32 in, fp32 out; W8A8)", "layernorm", ax1,
                lp["ln2_w"], lp["ln2_b"], f32,
                lambda: F.layer_norm(ax1, (d,), lp["ln2_w"], lp["ln2_b"], eps),
                eps=eps),
        quantize_case("LN1 out", a1),
        quantize_case("context", actx),
        quantize_case("LN2 out", a2),
        quantize_case("GELU'd hidden", ahid),
        w8a8_case("fused_linear_w8a8 qkv (+bias, bf16 out)", "qkv", "qkv_w",
                  3 * d, d, bf),
        w8a8_case("fused_linear_w8a8 out-proj (+bf16 residual, +bias, fp32 out)",
                  "out", "out_w", d, d, f32, residual=x),
        w8a8_case("fused_linear_w8a8 fc1 (+bias, _gelu_fast, fp32 out)", "fc1",
                  "fc1_w", h, d, f32, fuse_gelu=True),
        w8a8_case("fused_linear_w8a8 fc2 (+fp32 residual, +bias, bf16 out)", "fc2",
                  "fc2_w", d, h, bf, residual=ax1),
        int8w_case("fused_linear int8 w qkv (+bias, bf16 out)", b1, "qkv_w",
                   3 * d, d, bf),
        int8w_case("fused_linear int8 w out-proj (+bf16 residual, +bias, fp32 out)",
                   bctx, "out_w", d, d, f32, residual=x),
        int8w_case("fused_linear int8 w fc1 (+bias, _gelu_fast, bf16 out)", b2,
                   "fc1_w", h, d, bf, fuse_gelu=True),
        int8w_case("fused_linear int8 w fc2 (+fp32 residual, +bias, bf16 out)",
                   bhid, "fc2_w", d, h, bf, residual=bx1),
        dict(name="fused_encoder_layer W8A8 (the chain of 11 launches)",
             counter="fused_block_w8a8", tol=W8A8_CHAIN_TOL,
             min_same=MIN_SAME_INT8_CHAIN,
             kernel=lambda: fused_block.fused_encoder_layer(x, lp8, cfg, w8a8=True),
             plain=lambda: fused_block.fused_encoder_layer_reference(x, lp8, cfg,
                                                                     w8a8=True),
             library=None, bytes=2 * m * d * 2 + weight_bytes,
             ops={"int8": gemm_ops, "bf16": attn_ops}),
        dict(name="fused_encoder_layer int8 weights (the chain of 7 launches)",
             counter="fused_block_int8w", tol=BF16_TOL,
             min_same=MIN_SAME_INT8_CHAIN,
             kernel=lambda: fused_block.fused_encoder_layer(x, lp, cfg),
             plain=lambda: fused_block.fused_encoder_layer_reference(x, lp, cfg),
             library=None, bytes=2 * m * d * 2 + weight_bytes,
             ops={"bf16": gemm_ops + attn_ops}),
    ]
    return run_cases(cases, batch, prefix(cfg))


def outlier_kernel_rows(batch: int, dev, params: dict, seed: int = 0) -> list[dict]:
    """The outlier-aware W8A8 kernels on the intermediates (from the plain
    versions) of layer 0 of the calibrated ``params`` at ``batch`` seeded
    images, embedded by the forward's own code."""
    lp = vit._layer(params, 0)
    d, h, nh, hd = CFG.embed_dim, CFG.hidden_dim, CFG.num_heads, CFG.head_dim
    m = batch * CFG.num_tokens
    bf, f32, eps = torch.bfloat16, torch.float32, CFG.eps
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randn((batch, 3, CFG.img_size, CFG.img_size), generator=gen,
                         device=dev)
    x = vit.embed(images, params, CFG, bf)
    kh = lp["out_w"]["hi"].shape[0] // nh

    def w8(key, inp_q, **kw):
        q, s, hi = inp_q
        w = lp[key]
        return linear.fused_linear_w8a8_reference(
            q, s, w["q"], w["scale"], lp[key[:-1] + "b"], x_hi=hi,
            w_hi=w["hi"], **kw)

    def split(inp, key):
        return quantize.quantize_rows_split_reference(inp, lp[key]["q"].shape[0], bf)

    # The outlier chain's intermediates.
    a1 = layernorm.layer_norm_reference(x, lp["ln1_w"], lp["ln1_b"], eps, out_dtype=f32)
    q1 = split(a1, "qkv_w")
    qkv = w8("qkv_w", q1, out_dtype=bf)
    ctx = attention.packed_fused_attention_reference(qkv, nh, hd)
    qc = quantize.quantize_rows_masked_reference(ctx, nh, hd, kh)
    x1 = w8("out_w", qc, residual=x, out_dtype=f32)
    a2 = layernorm.layer_norm_reference(x1, lp["ln2_w"], lp["ln2_b"], eps, out_dtype=f32)
    q2 = split(a2, "fc1_w")
    hid = w8("fc1_w", q2, fuse_gelu=True, out_dtype=f32)
    q3 = split(hid, "fc2_w")
    quantized = {"qkv": q1, "out": qc, "fc1": q2, "fc2": q3}

    def side_case(name, site, wkey, n, out_dtype, **kw):
        xq, sx, x_hi = quantized[site]
        k_dim, k_hi = xq.shape[-1], x_hi.shape[-1]
        w, bias = lp[wkey], lp[wkey[:-1] + "b"]
        w_rows = w["q"].contiguous()  # the same values row-major
        res_b = kw["residual"].element_size() if "residual" in kw else 0
        out_b = 2 if out_dtype == bf else 4

        def library(wq=w["q"]):  # K-major, as calibrated
            acc = torch._int_mm(xq.reshape(m, k_dim), wq)
            side = torch.mm(x_hi.reshape(m, k_hi), w["hi"])
            y = acc.float() * sx.reshape(m, 1) * w["scale"] + side.float() + bias
            return epilogue_ops(y, kw, n, out_dtype)

        return dict(
            name=name, counter="linear_w8a8_hi",
            tol=BF16_TOL if out_dtype == bf else F32_TOL,
            min_same=MIN_SAME_KERNEL if out_dtype == bf else 0.0,
            kernel=lambda: linear.fused_linear_w8a8(
                xq, sx, w["q"], w["scale"], bias, x_hi=x_hi, w_hi=w["hi"],
                out_dtype=out_dtype, **kw),
            plain=lambda: linear.fused_linear_w8a8_reference(
                xq, sx, w["q"], w["scale"], bias, x_hi=x_hi, w_hi=w["hi"],
                out_dtype=out_dtype, **kw),
            library=library,
            yardsticks={"torch._int_mm + torch.mm + epilogue ops, row-major w":
                        lambda: library(w_rows)},
            bytes=(m * k_dim + k_dim * n + 4 * m + 8 * n + (m * k_hi + k_hi * n) * 2
                   + m * n * (res_b + out_b)),
            ops={"int8": 2 * m * n * k_dim, "bf16": 2 * m * n * k_hi})

    # int8 and bf16 weight elements of the layer; scales, biases and LN
    # parameters in fp32.
    k_d, k_h = d - lp["qkv_w"]["q"].shape[0], h - lp["fc2_w"]["q"].shape[0]
    int8_w = (d - k_d) * (3 * d + h) + d * d + (h - k_h) * d
    bf16_w = k_d * (3 * d + h) + nh * kh * d + k_h * d
    weight_bytes = int8_w + 2 * bf16_w + (5 * d + h) * 4 + (9 * d + h) * 4
    cases = [
        split_case("LN1 out", a1, lp["qkv_w"]["q"].shape[0]),
        masked_case("context", ctx, nh, hd, kh),
        split_case("LN2 out", a2, lp["fc1_w"]["q"].shape[0]),
        split_case("GELU'd hidden", hid, lp["fc2_w"]["q"].shape[0]),
        side_case("fused_linear_w8a8 + bf16 side qkv (+bias, bf16 out)", "qkv",
                  "qkv_w", 3 * d, bf),
        side_case("fused_linear_w8a8 + bf16 side out-proj (+bf16 residual, +bias, "
                  "fp32 out)", "out", "out_w", d, f32, residual=x),
        side_case("fused_linear_w8a8 + bf16 side fc1 (+bias, _gelu_fast, fp32 out)",
                  "fc1", "fc1_w", h, f32, fuse_gelu=True),
        side_case("fused_linear_w8a8 + bf16 side fc2 (+fp32 residual, +bias, bf16 out)",
                  "fc2", "fc2_w", d, bf, residual=x1),
        dict(name="fused_encoder_layer outlier-aware W8A8 (the chain of 11 launches)",
             counter="fused_block_w8a8_outlier", tol=OUTLIER_CHAIN_TOL,
             min_same=MIN_SAME_OUTLIER_CHAIN,
             kernel=lambda: fused_block.fused_encoder_layer(x, lp, CFG, w8a8=True),
             plain=lambda: fused_block.fused_encoder_layer_reference(x, lp, CFG,
                                                                     w8a8=True),
             library=None, bytes=2 * m * d * 2 + weight_bytes,
             ops={"int8": 2 * m * int8_w,
                  "bf16": 2 * m * bf16_w + 4 * batch * CFG.num_tokens ** 2 * d}),
    ]
    return run_cases(cases, batch)


# Phase 2c: row 6b again at B = 256 on a seeded context (ViT-B's heads, the
# calibrated plan's default tail).
MASKED_BATCH = 256


def masked_kernel_rows(dev) -> list[dict]:
    """Phase 2c: row 6b at MASKED_BATCH on a seeded ViT-B context."""
    gen = torch.Generator(device=dev).manual_seed(MASKED_BATCH)
    ctx = seeded_context(CFG, MASKED_BATCH, gen, dev)
    return run_cases([masked_case("seeded context", ctx, CFG.num_heads, CFG.head_dim,
                                  default_kh(CFG))], MASKED_BATCH)


@functools.lru_cache(maxsize=None)
def small_params(cfg, dev) -> tuple:
    """Seeded stacked bf16 weights of ``cfg`` on the card and their int8
    form (host quantization, as the engine's), made once per config."""
    params = vit.stack_params(fixtures.random_params(cfg, seed=3), cfg, device=dev)
    return params, quant.quantize_stacked_params(params, cfg)


def stack_ops(cfg, batch: int, depth: int) -> int:
    """Multiply-add operations (x2) of ``depth`` layers at ``batch`` images."""
    d, h, t = cfg.embed_dim, cfg.hidden_dim, cfg.num_tokens
    return depth * (2 * batch * t * d * (4 * d + 2 * h) + 4 * batch * t * t * d)


def stack_weight_bytes(cfg, depth: int, wbytes: int) -> int:
    d, h = cfg.embed_dim, cfg.hidden_dim
    scales = (6 * d + 2 * h) * 4 if wbytes == 1 else 0
    return depth * ((4 * d * d + 2 * d * h) * wbytes + scales + (9 * d + h) * 4)


def stack_kernel_rows(cfg, batch: int, dev, seed: int = 0) -> tuple:
    """Phase 2d for ``cfg`` at ``batch`` images: every kernel of its chains
    at their shapes (``kernel_rows``, ``int8_kernel_rows``); then the stacks
    of ``cfg`` (the W8A8 stack and the layer group at REDUCED_DEPTH) and the
    stack at one layer against their plain versions, with the per-layer
    chain over every layer beside them. Returns the three lists of rows."""
    kernels = kernel_rows(batch, dev, seed, cfg)
    int8_kernels = int8_kernel_rows(batch, dev, seed, cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, t, m = cfg.embed_dim, cfg.num_tokens, batch * cfg.num_tokens
    params, params8 = small_params(cfg, dev)
    x = (torch.randn((batch, t, d), generator=gen, device=dev) * 0.5).to(torch.bfloat16)

    def per_layer(fn, layers=None, conf=cfg, **kw):
        """The per-layer chain over every layer of ``conf`` (kernels or
        plain)."""
        stacked = params if layers is None else {"layers": layers}

        def run():
            y = x
            for layer in range(conf.depth):
                y = fn(y, vit._layer(stacked, layer), conf, **kw)
            return y
        return run

    def stack(name, counter, layers, tol, min_same, wbytes, depth=cfg.depth,
              ops_kind="bf16", w8a8=False, **kw):
        conf = dataclasses.replace(cfg, depth=depth)
        fn = fused_block.fused_encoder_stack
        ref = fused_block.fused_encoder_stack_reference
        if "group_size" in kw:
            fn = fused_block.fused_encoder_group
            ref = fused_block.fused_encoder_group_reference
        ops = stack_ops(cfg, batch, depth)
        attn = depth * 4 * batch * t * t * d
        # The fault the stack exists to avoid: the stream rounded to the
        # activation dtype at every layer (the plain per-layer chain).
        fault = max_err(per_layer(fused_block.fused_encoder_layer_reference, layers,
                                  conf, w8a8=w8a8)(),
                        ref(x, layers, conf, w8a8=w8a8, **kw), tol)
        print(f"  B={batch} {cfg.name} {name}: the plain per-layer chain (stream "
              f"rounded at each layer) vs the plain version: max_abs_err "
              f"{fault[0]:.3e}, mean {fault[3]:.3e}, {fault[2]:.2%} bit-identical",
              flush=True)
        return dict(
            name=name, counter=counter, tol=tol, min_same=min_same,
            max_mean=float("inf") if w8a8 else STACK_FAULT_SHARE * fault[3],
            kernel=lambda: fn(x, layers, conf, w8a8=w8a8, **kw),
            plain=lambda: ref(x, layers, conf, w8a8=w8a8, **kw),
            library=None,
            bytes=2 * m * d * 2 + stack_weight_bytes(cfg, depth, wbytes),
            ops={"bf16": ops} if ops_kind == "bf16" else {"int8": ops - attn, "bf16": attn})

    def first(layers, depth):
        return {k: ({kk: vv[:depth] for kk, vv in v.items()} if isinstance(v, dict)
                    else v[:depth]) for k, v in layers.items()}

    L, r = cfg.depth, REDUCED_DEPTH
    lp0 = vit._layer(params, 0)
    cases = [
        stack(f"fused_encoder_stack bf16 ({L} layers, {7 * L} launches)",
              "fused_block_stack", params["layers"], BF16_TOL, MIN_SAME_STACK, 2),
        stack(f"fused_encoder_stack int8 weights ({L} layers, {7 * L} launches)",
              "fused_block_stack_int8w", params8["layers"], BF16_TOL,
              MIN_SAME_STACK, 1),
        dict(name="fused_encoder_layer_flat bf16 (the stack at one layer, 7 "
                  "launches)", counter="stack_flat", tol=BF16_TOL,
             min_same=MIN_SAME_CHAIN,
             kernel=lambda: fused_block.fused_encoder_layer_flat(x, lp0, cfg),
             plain=lambda: fused_block.fused_encoder_stack_reference(
                 x, first(params["layers"], 1), cfg, num_layers=1),
             library=None, bytes=2 * m * d * 2 + stack_weight_bytes(cfg, 1, 2),
             ops={"bf16": stack_ops(cfg, batch, 1)}),
        dict(name=f"fused_encoder_layer bf16 x {L} (the per-layer chain over "
                  f"every layer, {7 * L} launches; for comparison)",
             counter="per_layer_chain", tol=BF16_TOL, min_same=0.0, gate=False,
             kernel=per_layer(fused_block.fused_encoder_layer),
             plain=per_layer(fused_block.fused_encoder_layer_reference),
             library=None, bytes=2 * m * d * 2 + stack_weight_bytes(cfg, L, 2),
             ops={"bf16": stack_ops(cfg, batch, L)}),
        stack(f"fused_encoder_stack W8A8 ({r} layers, {11 * r} launches)",
              "fused_block_stack_w8a8", first(quant.w8a8_layout(params8)["layers"], r),
              STACK_W8A8_TOL,
              MIN_SAME_STACK_W8A8, 1, depth=r, ops_kind="int8", w8a8=True),
        stack(f"fused_encoder_group bf16 (2 groups of 2 layers, {7 * r} launches)",
              "fused_block_group", first(params["layers"], r), BF16_TOL,
              MIN_SAME_STACK, 2, depth=r, group_size=2),
    ]
    return kernels, int8_kernels, run_cases(cases, batch, prefix(cfg))


def _outputs(value) -> list:
    return list(value) if isinstance(value, tuple) else [value]


def prefix(cfg) -> str:
    """Row names of the small configs start with the config's name."""
    return "" if cfg is CFG else f"{cfg.name} "


def run_cases(cases: list[dict], batch: int, name_prefix: str = "") -> list[dict]:
    """Each case against its plain version, then timed. A case with several
    outputs may give each its own tolerance and share (lists); a case with
    ``gate=False`` is printed for comparison and not checked."""
    rows = []
    for case in cases:
        case = dict(case, name=name_prefix + case["name"])
        outs, refs = _outputs(case["kernel"]()), _outputs(case["plain"]())
        torch.cuda.synchronize()
        tols = case["tol"] if isinstance(case["tol"], list) else [case["tol"]] * len(outs)
        mins = (case["min_same"] if isinstance(case["min_same"], list)
                else [case["min_same"]] * len(outs))
        errs = [max_err(o, r, tol) for o, r, tol in zip(outs, refs, tols)]
        if len(outs) > 1:
            for i, (e, tol) in enumerate(zip(errs, tols)):
                rel = e[0] / max(float(refs[i].float().abs().max()), 1e-30)
                print(f"  B={batch} {case['name']} output {i} ({outs[i].dtype}): "
                      f"max_abs_err {e[0]:.3e}, relative {rel:.3e} (tol rtol "
                      f"{tol[0]} atol {tol[1]:.3g}), {e[2]:.2%} bit-identical",
                      flush=True)
        err = max(e[0] for e in errs)
        within = all(e[1] for e in errs)
        same = min(e[2] for e in errs)
        mean_err = max(e[3] for e in errs)
        share_ok = all(e[2] >= low for e, low in zip(errs, mins))
        max_mean = case.get("max_mean", float("inf"))
        scale = max(float(r.float().abs().max()) for r in refs)
        bound_ms, bound_by = bound(case["bytes"], case["ops"])
        library_ms = None
        if case["library"] is not None:
            try:
                library_ms = time_ms(case["library"])
            except RuntimeError as exc:  # e.g. _int_mm refusing a shape
                print(f"  library call refused: {str(exc).splitlines()[0]}")
        row = dict(name=case["name"], counter=case["counter"],
                   replaces=case.get("replaces"), source=case.get("source"),
                   record=case.get("record", True),
                   max_abs_err=err,
                   mean_abs_err=mean_err, tol=tols[0], within=within, same=same,
                   ms=time_ms(case["kernel"]),
                   plain_ms=time_ms(case["plain"], reps=PLAIN_REPS),
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        rows.append(row)
        lib = ("-" if library_ms is None
               else f"{library_ms:.4f} ms ({row['ms'] / library_ms:.2f}x the kernel's)")
        print(f"  B={batch} {row['name']}: max_abs_err {err:.3e} "
              f"(mean {mean_err:.3e}; |plain| up to {scale:.3g}; "
              f"tol rtol {row['tol'][0]} atol {row['tol'][1]}; "
              f"{same:.2%} bit-identical) "
              f"{row['ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
              f"{row['ms'] / bound_ms:.2f}x), plain {row['plain_ms']:.4f} ms, "
              f"library {lib}", flush=True)
        row["yardsticks_ms"] = {}
        for label, fn in case.get("yardsticks", {}).items():
            try:
                ms = row["yardsticks_ms"][label] = time_ms(fn)
                print(f"  B={batch} {row['name']}: yardstick {label} {ms:.4f} ms "
                      f"({row['ms'] / ms:.2f}x the kernel's)", flush=True)
            except RuntimeError as exc:
                print(f"  yardstick {label} refused: {str(exc).splitlines()[0]}")
        if "kernel_ops" in case:
            print(f"  B={batch} {row['name']}: {sum(case['ops'].values()) / row['ms'] / 1e9:.1f} "
                  f"TFLOP/s of the function's work, "
                  f"{case['kernel_ops'] / row['ms'] / 1e9:.1f} TFLOP/s of the kernels' "
                  f"own (recomputation included)", flush=True)
        if case.get("gate", True):
            check(within and share_ok and mean_err <= max_mean,
                  f"B={batch} {row['name']} within tolerance of its plain version, "
                  f"bit-identical share {same:.4f} >= {min(mins)}, mean abs error "
                  f"{mean_err:.3e} <= {max_mean:.3e}")
    return rows


def train_layer(gen: torch.Generator, dev, cfg=CFG) -> dict:
    """One layer's fp32 master weights, as training holds them."""
    return {k: v.float() for k, v in layer_params(gen, dev, cfg).items()}


def sdpa_backward(qkvc, dctx, nh, hd):
    """The library yardstick of the attention backward: autograd of
    ``F.scaled_dot_product_attention``, the backward alone."""
    b, t, _ = qkvc.shape
    with torch.enable_grad():
        q, k, v = (z.detach().clone().requires_grad_(True) for z in
                   qkvc.reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4))
        out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    g = dctx.reshape(b, t, nh, hd).permute(0, 2, 1, 3)
    return lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True)


def ln_autograd(x, dy, w, b, eps):
    """The library yardstick of the LN backward: autograd of F.layer_norm."""
    with torch.enable_grad():
        xs = x.float().detach().requires_grad_(True)
        ws, bs = w.detach().clone().requires_grad_(True), b.detach().clone().requires_grad_(True)
        y = torch.nn.functional.layer_norm(xs, (x.shape[-1],), ws, bs, eps)
    return lambda: torch.autograd.grad(y, (xs, ws, bs), dy, retain_graph=True)


def ln_bwd_case(name, xin, dy, w, b, eps, residual, out_dtype, library=True,
                replaces=None, rel=GRAD_REL) -> dict:
    """Row 14b (``layer_norm_bwd``: dx + residual, dw, db) against its plain
    version; yardstick the autograd of ``F.layer_norm`` (outside inference
    mode). Bound: x, dy and the residual read, dx written once."""
    m, d = xin.numel() // xin.shape[-1], xin.shape[-1]
    out_b = 2 if out_dtype == torch.bfloat16 else 4
    print(f"  {name}: {layernorm.bwd_partial_rows(m, d)} partial rows of dw and db "
          f"for [{m}, {d}]", flush=True)
    return _grad_case(
        name, "layernorm_bwd",
        lambda: layernorm.layer_norm_bwd(xin, dy, w, eps, residual=residual,
                                         out_dtype=out_dtype),
        lambda: layernorm.layer_norm_bwd_reference(xin, dy, w, eps, residual=residual,
                                                   out_dtype=out_dtype),
        rel=rel, library=ln_autograd(xin, dy, w, b, eps) if library else None,
        bytes=m * d * (xin.element_size() + 4 + residual.element_size() + out_b)
        + 3 * d * 4,
        ops={"fp32": 16 * m * d}, replaces=replaces)


def ln_bwd_same_bits(tag: str, xin, dy, w, eps, residual, out_dtype) -> None:
    """Two calls of ``layer_norm_bwd`` on the same inputs give the same
    bits: dx, dw and db (every sum in an order fixed by the shape)."""
    first = layernorm.layer_norm_bwd(xin, dy, w, eps, residual=residual,
                                     out_dtype=out_dtype)
    again = layernorm.layer_norm_bwd(xin, dy, w, eps, residual=residual,
                                     out_dtype=out_dtype)
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f"{tag} layer_norm_bwd (dx, dw, db) bit-identical over two calls")


def ln_bwd_rows(cfg, batch: int, dev, library: bool = True) -> list[dict]:
    """Row 14b at ``cfg``'s width and ``batch`` images on seeded inputs in
    the two chain forms: LN2 (the fp32 stream x2, dy from fc1's dgrad, the
    bf16 dOut added, fp32 dx2) and LN1 (bf16 x, dy from qkv's dgrad, the
    fp32 dx2 added, bf16 dx); each also twice for the same bits."""
    gen = torch.Generator(device=dev).manual_seed(batch + cfg.embed_dim)
    shape, f32, bf = (batch, cfg.num_tokens, cfg.embed_dim), torch.float32, torch.bfloat16
    w = torch.randn(cfg.embed_dim, generator=gen, device=dev) * 0.02 + 1.0
    b = torch.randn(cfg.embed_dim, generator=gen, device=dev) * 0.02
    x2 = torch.randn(shape, generator=gen, device=dev)
    x = (torch.randn(shape, generator=gen, device=dev) * 0.5).to(bf)
    dh = torch.randn(shape, generator=gen, device=dev) * 0.01
    dout = (torch.randn(shape, generator=gen, device=dev) * 0.01).to(bf)
    dx2 = torch.randn(shape, generator=gen, device=dev) * 0.01
    tag = f"{cfg.name} B={batch}"
    cases = [ln_bwd_case(f"{tag} layer_norm_bwd LN2 (fp32 x2, + dOut, fp32 dx2)", x2, dh,
                         w, b, cfg.eps, dout, f32, library),
             ln_bwd_case(f"{tag} layer_norm_bwd LN1 (bf16 x, + dx2, bf16 dx)", x, dh, w,
                         b, cfg.eps, dx2, bf, library, replaces=ATTN_BWD_STAGE)]
    ln_bwd_same_bits(f"{tag} LN2", x2, dh, w, cfg.eps, dout, f32)
    ln_bwd_same_bits(f"{tag} LN1", x, dh, w, cfg.eps, dx2, bf)
    return run_cases(cases, batch)


def _scaled_tol(ref, rel=GRAD_REL) -> tuple:
    """(rtol, atol) for an fp32 output: rel of its largest magnitude."""
    return (0.0, rel * max(float(ref.float().abs().max()), 1e-30))


def _grad_case(name, counter, kernel, plain, rel=GRAD_REL, **kw):
    """A case whose outputs are fp32 sums (each held to ``rel`` of its own
    scale) and bf16 roundings (BF16_TOL, its atol taken relative to the
    output's scale as gradients are small, and the kernel's share)."""
    refs = _outputs(plain())
    tols = [(BF16_TOL[0], _scaled_tol(r, BF16_TOL[1])[1])
            if r.dtype == torch.bfloat16 else _scaled_tol(r, rel) for r in refs]
    low = kw.pop("min_same", MIN_SAME_KERNEL)
    mins = [low if r.dtype == torch.bfloat16 else 0.0 for r in refs]
    return dict(name=name, counter=counter, kernel=kernel, plain=plain, tol=tols,
                min_same=mins, **kw)


def attn_bwd_case(qkvc, dctx, nh: int, hd: int, out_dtype) -> dict:
    """The packed attention backward on (qkvc, dctx) against its plain
    version; yardstick: the backward of ``F.scaled_dot_product_attention``
    alone. Bound: qkv and dO read, dqkv written; 10·T²·hd operations a head
    (the products s, dp, dv, dq, dk)."""
    b, t, _ = qkvc.shape
    d = nh * hd
    tag = "bf16" if out_dtype == torch.bfloat16 else "fp32"
    return _grad_case(
        f"packed_attention_bwd (bf16 in, {tag} dqkv)", "attention_bwd",
        lambda: attention.packed_attention_bwd(qkvc, dctx, nh, hd, out_dtype=out_dtype),
        lambda: attention.packed_attention_bwd_reference(qkvc, dctx, nh, hd,
                                                         out_dtype=out_dtype),
        min_same=MIN_SAME_ATTN_BWD, library=sdpa_backward(qkvc, dctx, nh, hd),
        bytes=b * t * (3 * d * 2 + d * 2 + 3 * d * (2 if tag == "bf16" else 4)),
        ops={"bf16": 10 * b * t * t * d})


def train_kernel_rows(batch: int, dev, seed: int = 0, cfg=CFG) -> list[dict]:
    """Phase 2e: every kernel of the training backward and the three stages
    on the backward's own intermediates (from the plain versions) at
    ``batch`` images, against their plain versions."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lp = train_layer(gen, dev, cfg)
    d, h, t, nh, hd, eps = (cfg.embed_dim, cfg.hidden_dim, cfg.num_tokens,
                            cfg.num_heads, cfg.head_dim, cfg.eps)
    m, bf, f32 = batch * t, torch.bfloat16, torch.float32
    x = (torch.randn((batch, t, d), generator=gen, device=dev) * 0.5).to(bf)
    dout = (torch.randn((batch, t, d), generator=gen, device=dev) * 0.01).to(bf)
    wb = {k: lp[k].to(bf) for k in ("qkv_w", "out_w", "fc1_w", "fc2_w")}
    # The backward's intermediates, from the plain versions.
    h1c = layernorm.layer_norm_reference(x, lp["ln1_w"], lp["ln1_b"], eps)
    qkvc = linear.fused_linear_reference(h1c, wb["qkv_w"], lp["qkv_b"])
    ctx = attention.packed_fused_attention_reference(qkvc, nh, hd)
    x2 = linear.fused_linear_reference(ctx, wb["out_w"], lp["out_b"], residual=x,
                                       out_dtype=f32)
    h2c = layernorm.layer_norm_reference(x2, lp["ln2_w"], lp["ln2_b"], eps,
                                         out_dtype=bf)
    hid_pre, hidc = linear.fused_linear_with_gelu_reference(h2c, wb["fc1_w"],
                                                            lp["fc1_b"])
    dhid_pre, dhpc = linear.linear_dgrad_reference(dout, wb["fc2_w"],
                                                   gelu_grad_of=hid_pre,
                                                   out2_dtype=bf)
    dh2 = linear.linear_dgrad_reference(dhpc, wb["fc1_w"])
    dx2 = layernorm.layer_norm_bwd_reference(x2, dh2, lp["ln2_w"], eps,
                                             residual=dout, out_dtype=f32)[0]
    dac = dx2.to(bf)
    dctx = linear.linear_dgrad_reference(dac, wb["out_w"], out_dtype=bf)
    dqkv = attention.packed_attention_bwd_reference(qkvc, dctx, nh, hd,
                                                    out_dtype=f32)
    dqkv_c = dqkv.to(bf)
    dh1 = linear.linear_dgrad_reference(dqkv_c, wb["qkv_w"])
    attn_case = functools.partial(attn_bwd_case, qkvc, dctx, nh, hd)
    attn_stage = ATTN_BWD_STAGE

    def dgrad_case(name, dy, wkey, out_dtype, gelu=False):
        n, k = wb[wkey].shape[1], wb[wkey].shape[0]
        kw = dict(out_dtype=out_dtype)
        if gelu:
            kw.update(gelu_grad_of=hid_pre, out2_dtype=bf)
        out_b = (2 if out_dtype == bf else 4) + (6 if gelu else 0)

        def library():
            y = torch.mm(dy.reshape(m, n), wb[wkey].t())
            if gelu:
                y = y.float() * fused_block._gelu_fast_grad(hid_pre.reshape(m, k))
                return y, y.to(bf)
            return y.to(out_dtype)

        return _grad_case(
            name, "linear_dgrad",
            lambda: linear.linear_dgrad(dy, wb[wkey], **kw),
            lambda: linear.linear_dgrad_reference(dy, wb[wkey], **kw),
            library=library, bytes=m * n * 2 + k * n * 2 + m * k * out_b,
            ops={"bf16": 2 * m * n * k},
            replaces=attn_stage if wkey in ("qkv_w", "out_w") else None)

    def wgrad_case(name, xin, dy):
        k, n = xin.shape[-1], dy.shape[-1]
        return _grad_case(
            name, "linear_wgrad", lambda: linear.linear_wgrad(xin, dy),
            lambda: linear.linear_wgrad_reference(xin, dy),
            library=lambda: torch.mm(xin.reshape(m, k).t(), dy.reshape(m, n)).float(),
            bytes=m * (k + n) * 2 + k * n * 4, ops={"bf16": 2 * m * n * k},
            replaces=attn_stage if xin is h1c or xin is ctx else None)

    def colsum_case(name, xin):
        c = xin.shape[-1]
        rows = xin.numel() // c
        return _grad_case(
            name, "column_sum", lambda: layernorm.column_sum(xin),
            lambda: layernorm.column_sum_reference(xin),
            library=lambda: xin.reshape(rows, c).float().sum(0),
            bytes=rows * c * xin.element_size() + c * 4, ops={"fp32": rows * c},
            replaces=attn_stage if xin is dqkv else None)

    # The LN backward's partial rows (bwd_partial_rows: the tokens split
    # evenly into that many runs, a row each), which column_sum finishes into
    # dw and db: LN2's dw partials.
    xhat2 = fused_block._ln_fwd_stats(x2.float(), lp["ln2_w"],
                                      torch.zeros_like(lp["ln2_w"]), eps)[0]
    dw_rows = (dh2.float() * xhat2).reshape(m, d)
    n = layernorm.bwd_partial_rows(m, d)
    ln_partial = torch.stack([dw_rows[i * m // n:(i + 1) * m // n].sum(0)
                              for i in range(n)])
    ln_bwd_same_bits(f"{cfg.name} B={batch} LN2", x2, dh2, lp["ln2_w"], eps, dout, f32)
    ln_bwd_same_bits(f"{cfg.name} B={batch} LN1", x, dh1, lp["ln1_w"], eps, dx2, bf)

    wbytes_attn, wbytes_mlp, (stage_x2_ops, stage_mlp_ops, stage_attn_ops) = \
        stage_work(cfg, batch)

    cases = [
        attn_case(bf), attn_case(f32),
        dgrad_case("linear_dgrad qkv (dqkv_c . qkv_w^T, fp32 out)", dqkv_c, "qkv_w", f32),
        dgrad_case("linear_dgrad out-proj (dx2_c . out_w^T, bf16 out)", dac, "out_w", bf),
        dgrad_case("linear_dgrad fc1 (dhpc . fc1_w^T, fp32 out)", dhpc, "fc1_w", f32),
        dgrad_case("linear_dgrad fc2 (dOut . fc2_w^T * gelu', fp32 + bf16)", dout,
                   "fc2_w", f32, gelu=True),
        wgrad_case("linear_wgrad qkv (h1c^T . dqkv_c)", h1c, dqkv_c),
        wgrad_case("linear_wgrad out-proj (ctx^T . dx2_c)", ctx, dac),
        wgrad_case("linear_wgrad fc1 (h2c^T . dhpc)", h2c, dhpc),
        wgrad_case("linear_wgrad fc2 (hidc^T . dOut)", hidc, dout),
        _grad_case("fused_linear_with_gelu fc1 recompute (fp32 + bf16 GELU)",
                   "linear_gelu_pair",
                   lambda: linear.fused_linear_with_gelu(h2c, wb["fc1_w"], lp["fc1_b"]),
                   lambda: linear.fused_linear_with_gelu_reference(
                       h2c, wb["fc1_w"], lp["fc1_b"]),
                   library=lambda: (lambda y: (y, torch.nn.functional.gelu(
                       y, approximate="tanh").to(bf)))(
                           torch.addmm(lp["fc1_b"], h2c.reshape(m, d).float(),
                                       lp["fc1_w"])),
                   bytes=m * d * 2 + d * h * 2 + h * 4 + m * h * 6,
                   ops={"bf16": 2 * m * d * h}),
        ln_bwd_case("layer_norm_bwd LN2 (fp32 x2, + dOut, fp32 dx2)", x2, dh2,
                    lp["ln2_w"], lp["ln2_b"], eps, dout, f32),
        ln_bwd_case("layer_norm_bwd LN1 (bf16 x, + dx2, bf16 dx)", x, dh1, lp["ln1_w"],
                    lp["ln1_b"], eps, dx2, bf, replaces=attn_stage),
        colsum_case("column_sum dqkv (fp32)", dqkv),
        colsum_case("column_sum dOut (bf16)", dout),
        colsum_case(f"column_sum LN2 partial dw rows (fp32, "
                    f"{ln_partial.shape[0]} x {d})", ln_partial),
        _grad_case("fused_bwd_stage_x2 (_attn_half_fwd_kernel: 4 launches)",
                   "fused_bwd_x2",
                   lambda: fused_block.fused_bwd_stage_x2(x, lp, cfg),
                   lambda: fused_block.fused_bwd_stage_x2_reference(x, lp, cfg),
                   library=None, bytes=m * d * (2 + 4) + wbytes_attn,
                   ops={"bf16": stage_x2_ops}),
        _grad_case("fused_bwd_stage_mlp_mono (_mlp_bwd_kernel: 11 launches)",
                   "fused_bwd_mlp",
                   lambda: flat(fused_block.fused_bwd_stage_mlp_mono(x2, dout, lp, cfg)),
                   lambda: flat(fused_block.fused_bwd_stage_mlp_mono_reference(
                       x2, dout, lp, cfg)),
                   rel=STAGE_GRAD_REL, library=None,
                   bytes=m * d * (4 + 2 + 4) + wbytes_mlp + wbytes_mlp * 2,
                   ops={"bf16": stage_mlp_ops}),
        _grad_case("fused_bwd_stage_attn (_attn_bwd_kernel: 13 launches)",
                   "fused_bwd_attn",
                   lambda: flat(fused_block.fused_bwd_stage_attn(x, dx2, lp, cfg)),
                   lambda: flat(fused_block.fused_bwd_stage_attn_reference(
                       x, dx2, lp, cfg)),
                   rel=STAGE_GRAD_REL, min_same=MIN_SAME_CHAIN, library=None,
                   bytes=m * d * (2 + 4 + 2) + wbytes_attn + wbytes_attn * 2,
                   ops={"bf16": stage_attn_ops}),
        layer_bwd_case(x, lp, dout, cfg),
    ]
    return run_cases(cases, batch, "train ")


def sdpa_backend(q, k, v) -> str:
    """The backend that ``F.scaled_dot_product_attention`` takes for q, k
    and v: the first of PyTorch's that accepts them, in the order flash,
    cuDNN, memory-efficient, math (fp32 rules out the first two)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            # A backend that refuses the inputs warns why; the refusal is the
            # answer here.
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                torch.nn.functional.scaled_dot_product_attention(q, k, v)
            return backend.name
        except RuntimeError:
            continue
    return "none"


def attn_f32_case(qkv, nh: int, hd: int, record: bool = True) -> dict:
    """Row 4's fp32 form (the fp32 slab entry) on qkv [B, T, 3D] against its
    plain version; yardstick SDPA in fp32 on the same q, k, v (its backend
    named). Bound: q, k, v read and the context written once; 4·T²·hd
    operations a head at the fp32 peak."""
    b, t, _ = qkv.shape
    q, k, v = qkv.reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
    backend = sdpa_backend(q, k, v)
    return dict(name=f"packed_fused_attention (fp32 slab; SDPA takes {backend})",
                counter="attention_f32", tol=F32_TOL, min_same=0.0, record=record,
                kernel=lambda: attention.packed_fused_attention(qkv, num_heads=nh,
                                                                head_dim=hd),
                plain=lambda: attention.packed_fused_attention_reference(qkv, nh, hd),
                library=lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
                bytes=b * t * 4 * nh * hd * 4, ops={"fp32": 4 * b * nh * t * t * hd})


def fp32_kernel_rows(batch: int, dev, seed: int = 0, cfg=CFG) -> list[dict]:
    """Phase 2's fp32 rows: the fp32 GEMM's forward at the chain's four
    sites and its backward forms at the backward's, the fp32 slab attention
    the fp32 attention backward and the LN backward's fp32 dtype set (its
    general form) at LN2 and LN1, on an fp32 layer's own intermediates
    (from the plain versions) at ``batch`` images, against their plain
    versions (the backward's fp32 outputs within F32_GRAD_REL); yardsticks ``torch.addmm`` / ``torch.mm`` in fp32 with TF32
    off plus the epilogue as ops, SDPA in fp32 forward and backward. The
    fp32 layer (the chain of the forward's 7 launches) is held to its plain
    version too (printed, not recorded)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lp = train_layer(gen, dev, cfg)
    d, h, t, nh, hd, eps = (cfg.embed_dim, cfg.hidden_dim, cfg.num_tokens,
                            cfg.num_heads, cfg.head_dim, cfg.eps)
    m, f32 = batch * t, torch.float32
    x = torch.randn((batch, t, d), generator=gen, device=dev) * 0.5
    dout = torch.randn((batch, t, d), generator=gen, device=dev) * 0.01
    # The layer's intermediates, from the plain versions.
    h1 = layernorm.layer_norm_reference(x, lp["ln1_w"], lp["ln1_b"], eps)
    qkv = linear.fused_linear_reference(h1, lp["qkv_w"], lp["qkv_b"])
    ctx = attention.packed_fused_attention_reference(qkv, nh, hd)
    x2 = linear.fused_linear_reference(ctx, lp["out_w"], lp["out_b"], residual=x)
    h2 = layernorm.layer_norm_reference(x2, lp["ln2_w"], lp["ln2_b"], eps)
    hid_pre, hid = linear.fused_linear_with_gelu_reference(h2, lp["fc1_w"], lp["fc1_b"])
    dhid_pre, dhp = linear.linear_dgrad_reference(dout, lp["fc2_w"], gelu_grad_of=hid_pre,
                                                  out2_dtype=f32)
    dh2 = linear.linear_dgrad_reference(dhp, lp["fc1_w"])
    dx2 = layernorm.layer_norm_bwd_reference(x2, dh2, lp["ln2_w"], eps, residual=dout,
                                             out_dtype=f32)[0]
    dctx = linear.linear_dgrad_reference(dx2, lp["out_w"])
    dqkv = attention.packed_attention_bwd_reference(qkv, dctx, nh, hd)
    dh1 = linear.linear_dgrad_reference(dqkv, lp["qkv_w"])

    def gemm(name, inp, wkey, bkey, n, k_dim, **kw):
        res_b = 4 if "residual" in kw else 0

        def library():
            y = torch.addmm(lp[bkey], inp.reshape(m, k_dim), lp[wkey])
            return epilogue_ops(y, kw, n, f32)

        return dict(
            name=f"fp32 {name}", counter="linear_f32", tol=F32_TOL, min_same=0.0,
            kernel=lambda: linear.fused_linear(inp, lp[wkey], lp[bkey], **kw),
            plain=lambda: linear.fused_linear_reference(inp, lp[wkey], lp[bkey], **kw),
            library=library,
            bytes=m * k_dim * 4 + k_dim * n * 4 + n * 4 + m * n * (res_b + 4),
            ops={"fp32": 2 * m * n * k_dim})

    def dgrad_case(name, dy, wkey, gelu=False):
        n, k = lp[wkey].shape[1], lp[wkey].shape[0]
        kw = dict(gelu_grad_of=hid_pre, out2_dtype=f32) if gelu else {}

        def library():
            y = torch.mm(dy.reshape(m, n), lp[wkey].t())
            if gelu:
                y = y * fused_block._gelu_fast_grad(hid_pre.reshape(m, k))
                return y, y.clone()
            return y

        return _grad_case(
            f"fp32 {name}", "linear_dgrad_f32",
            lambda: linear.linear_dgrad(dy, lp[wkey], **kw),
            lambda: linear.linear_dgrad_reference(dy, lp[wkey], **kw),
            rel=F32_GRAD_REL, library=library, bytes=m * n * 4 + k * n * 4 + m * k * (12 if gelu else 4),
            ops={"fp32": 2 * m * n * k})

    def wgrad_case(name, xin, dy):
        k, n = xin.shape[-1], dy.shape[-1]
        return _grad_case(
            f"fp32 {name}", "linear_wgrad_f32", lambda: linear.linear_wgrad(xin, dy),
            lambda: linear.linear_wgrad_reference(xin, dy), rel=F32_GRAD_REL,
            library=lambda: torch.mm(xin.reshape(m, k).t(), dy.reshape(m, n)),
            bytes=m * (k + n) * 4 + k * n * 4, ops={"fp32": 2 * m * n * k})

    cases = [
        gemm("fused_linear qkv (+bias)", h1, "qkv_w", "qkv_b", 3 * d, d),
        attn_f32_case(qkv, nh, hd),
        gemm("fused_linear out-proj (+fp32 residual, +bias)", ctx, "out_w", "out_b",
             d, d, residual=x),
        gemm("fused_linear fc1 (+bias, _gelu_fast)", h2, "fc1_w", "fc1_b", h, d,
             fuse_gelu=True),
        gemm("fused_linear fc2 (+fp32 residual, +bias)", hid, "fc2_w", "fc2_b", d, h,
             residual=x2),
        _grad_case("fp32 packed_attention_bwd (fp32 dqkv)", "attention_bwd_f32",
                   lambda: attention.packed_attention_bwd(qkv, dctx, nh, hd),
                   lambda: attention.packed_attention_bwd_reference(qkv, dctx, nh, hd),
                   rel=F32_GRAD_REL, library=sdpa_backward(qkv, dctx, nh, hd),
                   bytes=batch * t * 7 * d * 4, ops={"fp32": 10 * batch * t * t * d}),
        dgrad_case("linear_dgrad qkv (dqkv . qkv_w^T)", dqkv, "qkv_w"),
        dgrad_case("linear_dgrad out-proj (dx2 . out_w^T)", dx2, "out_w"),
        dgrad_case("linear_dgrad fc1 (dhp . fc1_w^T)", dhp, "fc1_w"),
        dgrad_case("linear_dgrad fc2 (dOut . fc2_w^T * gelu', fp32 + fp32)", dout,
                   "fc2_w", gelu=True),
        wgrad_case("linear_wgrad qkv (h1^T . dqkv)", h1, dqkv),
        wgrad_case("linear_wgrad out-proj (ctx^T . dx2)", ctx, dx2),
        wgrad_case("linear_wgrad fc1 (h2^T . dhp)", h2, dhp),
        wgrad_case("linear_wgrad fc2 (hid^T . dOut)", hid, dout),
        _grad_case("fp32 fused_linear_with_gelu fc1 recompute (fp32 + fp32 GELU)",
                   "linear_gelu_pair_f32",
                   lambda: linear.fused_linear_with_gelu(h2, lp["fc1_w"], lp["fc1_b"]),
                   lambda: linear.fused_linear_with_gelu_reference(h2, lp["fc1_w"],
                                                                   lp["fc1_b"]),
                   rel=F32_GRAD_REL, library=lambda: (lambda y: (y, torch.nn.functional.gelu(
                       y, approximate="tanh")))(torch.addmm(lp["fc1_b"], h2.reshape(m, d),
                                                            lp["fc1_w"])),
                   bytes=m * d * 4 + d * h * 4 + h * 4 + m * h * 8,
                   ops={"fp32": 2 * m * d * h}),
        ln_bwd_case("fp32 layer_norm_bwd LN2 (fp32 x2, + fp32 dOut, fp32 dx2)", x2, dh2,
                    lp["ln2_w"], lp["ln2_b"], eps, dout, f32, rel=F32_GRAD_REL),
        ln_bwd_case("fp32 layer_norm_bwd LN1 (fp32 x, + fp32 dx2, fp32 dx)", x, dh1,
                    lp["ln1_w"], lp["ln1_b"], eps, dx2, f32, replaces=ATTN_BWD_STAGE,
                    rel=F32_GRAD_REL),
        dict(name="fp32 fused_encoder_layer (the chain of the 7 launches)",
             counter="fused_block", tol=F32_TOL, min_same=0.0, record=False,
             kernel=lambda: fused_block.fused_encoder_layer(x, lp, cfg),
             plain=lambda: fused_block.fused_encoder_layer_reference(x, lp, cfg),
             library=None, bytes=2 * m * d * 4 + (4 * d * d + 2 * d * h + 9 * d + h) * 4,
             ops={"fp32": 2 * m * d * (4 * d + 2 * h) + 4 * batch * t * t * d}),
    ]
    ln_bwd_same_bits(f"fp32 B={batch} LN2", x2, dh2, lp["ln2_w"], eps, dout, f32)
    ln_bwd_same_bits(f"fp32 B={batch} LN1", x, dh1, lp["ln1_w"], eps, dx2, f32)
    with torch.inference_mode():
        forward = run_cases(cases[:5], batch)
    rows = forward + run_cases(cases[5:-1], batch)
    with torch.inference_mode():
        rows += run_cases(cases[-1:], batch)
    return rows


def fp32_rows(dev) -> list[dict]:
    """Phase 2's fp32 rows at F32_ROW_BATCHES (those at SMOKE_BATCH first)
    and row 4's fp32 form at F32_ATTN_LONG (printed, not recorded)."""
    rows = []
    for batch in F32_ROW_BATCHES:
        batch_rows = fp32_kernel_rows(batch, dev, seed=batch)
        if batch == SMOKE_BATCH:
            rows = batch_rows
        torch.cuda.empty_cache()
    b, t, nh, hd = F32_ATTN_LONG
    gen = torch.Generator(device=dev).manual_seed(t)
    qkv = torch.randn((b, t, 3 * nh * hd), generator=gen, device=dev)
    with torch.inference_mode():
        run_cases([attn_f32_case(qkv, nh, hd, record=False)], b, f"T={t} ")
    return rows


def flat(value):
    """A stage's (output(s), {leaf: gradient}) as one tuple of tensors."""
    *outs, grads = value
    return (*outs, *grads.values())


def stage_work(cfg, batch: int) -> tuple:
    """(bytes of the attention half's weights, of the MLP's, and the
    operations of stages x2, MLP and attention at ``batch`` images)."""
    d, h, t = cfg.embed_dim, cfg.hidden_dim, cfg.num_tokens
    m = batch * t
    return ((4 * d * d) * 2 + 8 * d * 4, (2 * d * h) * 2 + (3 * d + h) * 4,
            (2 * m * d * 4 * d + 4 * batch * t * t * d, 10 * m * d * h,
             22 * m * d * d + 14 * batch * t * t * d))


def layer_bwd_case(x, lp, dout, cfg) -> dict:
    """``fused_encoder_layer_bwd`` against its plain version (no one TPU
    kernel: printed, not recorded)."""
    batch, t, d = x.shape
    wbytes_attn, wbytes_mlp, ops = stage_work(cfg, batch)
    stages = "x2, light, wgrad, attention" if fused_block._pick_mlp_chunks(
        d, cfg.hidden_dim, 2) > 1 else "the three stages"
    return _grad_case(f"fused_encoder_layer_bwd ({stages})", "fused_bwd",
                      lambda: flat(fused_block.fused_encoder_layer_bwd(x, lp, dout, cfg)),
                      lambda: flat(fused_block.fused_encoder_layer_bwd_reference(
                          x, lp, dout, cfg)),
                      rel=STAGE_GRAD_REL, min_same=MIN_SAME_CHAIN, library=None,
                      bytes=batch * t * d * (2 + 2 + 2) + 3 * (wbytes_attn + wbytes_mlp),
                      ops={"bf16": sum(ops)})


def large_kernel_rows(dev) -> list[dict]:
    """Phase 2f: the streamed attention backward at the presets' T, the
    chunked MLP pair at ViT-L and ViT-H widths, and a ViT-L-width layer
    backward, against their plain versions."""
    bf = torch.bfloat16
    rows = []
    for cfg, batch, dtypes in ((CFG, 16, (bf,)), (CFG, 64, (bf,)),
                               (LARGE_CFG, 8, (bf, torch.float32)),
                               (LARGE_CFG, 32, (bf, torch.float32)),
                               (VIT_H_14_224, 16, (bf,)), (VIT_G_14_224, 16, (bf,))):
        gen = torch.Generator(device=dev).manual_seed(batch)
        t, d = cfg.num_tokens, cfg.embed_dim
        qkvc = torch.randn((batch, t, 3 * d), generator=gen, device=dev).to(bf)
        dctx = (torch.randn((batch, t, d), generator=gen, device=dev) * 0.01).to(bf)
        nh, hd = cfg.num_heads, cfg.head_dim
        cases = [attn_bwd_case(qkvc, dctx, nh, hd, o) for o in dtypes]
        if (cfg, batch) == (LARGE_CFG, LARGE_THROUGHPUT_BATCH):
            # Row 4 at the `fused` chain's forward shape of phase 4c.
            cases.append(attn_fwd_case(qkvc, nh, hd))
        got = run_cases(cases, batch, f"{cfg.name} B={batch} T={t} hd={hd} ")
        if (cfg, batch) in BWD_SAME_BITS:
            for o in dtypes:
                first = attention.packed_attention_bwd(qkvc, dctx, nh, hd, out_dtype=o)
                again = attention.packed_attention_bwd(qkvc, dctx, nh, hd, out_dtype=o)
                check(torch.equal(first, again),
                      f"{cfg.name} B={batch} packed_attention_bwd ({o} dqkv) "
                      f"bit-identical over two runs")
        if cfg is CFG:
            print(f"  B={batch} ViT-B attention backward: streamed {got[0]['ms']:.4f} ms, "
                  f"the earlier resident form (H100 80GB HBM3, 700 W) "
                  f"{RESIDENT_ATTN_BWD_MS[batch]:.4f} ms", flush=True)
        rows += got
    for cfg, batch, whole_layer in LARGE_MLP_ROWS:
        rows += chunked_mlp_rows(cfg, batch, dev, whole_layer)
    for batch in (8, LARGE_THROUGHPUT_BATCH):
        rows += ln_bwd_rows(LARGE_CFG, batch, dev)
    return rows


def flash_kernel_rows(dev) -> list[dict]:
    """Phase 2g: the blockwise forward, without and with the LSE, and its
    backward at FLASH_ROWS' shapes against their plain versions (the
    backward on the plain forward's out and lse); yardsticks SDPA's forward
    and its backward alone. Bounds: qkv (and out, lse, dO) read and the
    outputs written once; 4·T²·hd a head forward, 10·T²·hd backward (the
    products s, dp, dq, dk and dv, as row 11's). The backward's kernels do
    14·T²·hd (the dK/dV kernel computes s and dp again); their rate on that
    work is printed beside the function's."""
    bf, F = torch.bfloat16, torch.nn.functional
    rows = []
    for name, t, nh, hd, batch in FLASH_ROWS:
        gen = torch.Generator(device=dev).manual_seed(t + batch)
        d, n = nh * hd, batch * nh
        qkv = torch.randn((batch, t, 3 * d), generator=gen, device=dev).to(bf)
        do = (torch.randn((batch, t, d), generator=gen, device=dev) * 0.01).to(bf)
        out, lse = attention.blockwise_attention_fwd_reference(qkv, nh, hd,
                                                               return_lse=True)
        q, k, v = qkv.reshape(batch, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
        fwd_ops = {"bf16": 4 * n * t * t * hd}
        cases = [
            dict(name="blockwise_attention_fwd (bf16)", counter="attention_flash",
                 tol=BF16_TOL, min_same=MIN_SAME_KERNEL,
                 kernel=lambda: attention.blockwise_attention_fwd(qkv, nh, hd)[0],
                 plain=lambda: attention.blockwise_attention_fwd_reference(
                     qkv, nh, hd)[0],
                 library=lambda: F.scaled_dot_product_attention(q, k, v),
                 bytes=batch * t * 4 * d * 2, ops=fwd_ops),
            dict(name="blockwise_attention_fwd with LSE (bf16 out, fp32 lse)",
                 counter="attention_flash_lse", tol=[BF16_TOL, LSE_TOL],
                 min_same=[MIN_SAME_KERNEL, 0.0],
                 kernel=lambda: attention.blockwise_attention_fwd(
                     qkv, nh, hd, return_lse=True),
                 plain=lambda: attention.blockwise_attention_fwd_reference(
                     qkv, nh, hd, return_lse=True),
                 library=lambda: F.scaled_dot_product_attention(q, k, v),
                 bytes=batch * t * 4 * d * 2 + n * t * 4, ops=fwd_ops),
            _grad_case("blockwise_attention_bwd (bf16 dqkv)", "attention_flash_bwd",
                       lambda: attention.blockwise_attention_bwd(qkv, out, lse, do,
                                                                 nh, hd),
                       lambda: attention.blockwise_attention_bwd_reference(
                           qkv, out, lse, do, nh, hd),
                       min_same=MIN_SAME_ATTN_BWD,
                       library=sdpa_backward(qkv, do, nh, hd),
                       bytes=batch * t * 8 * d * 2 + n * t * 4,
                       ops={"bf16": 10 * n * t * t * hd},
                       kernel_ops=14 * n * t * t * hd),
        ]
        if name == LONG_CFG.name and batch == LONG_BATCH:
            # The `fused` route's attention backward at this T (row 11's
            # streamed kernels, fp32 dqkv as its attention stage takes it).
            cases.append(attn_bwd_case(qkv, do, nh, hd, torch.float32))
        cases += tuned_flash_cases(qkv, q, k, v, nh, hd, batch, t)
        rows += run_cases(cases, batch, f"{name} B={batch} T={t} hd={hd} ")
        rows += flash_f32_rows(qkv.float(), do.float(), nh, hd, f"{name} B={batch} "
                                                               f"T={t} hd={hd} ")
        for bk in FLASH_TUNED_KS:
            first, again = (attention.blockwise_attention_fwd(qkv, nh, hd, return_lse=True,
                                                              block_k=bk)
                            for _ in range(2))
            check(torch.equal(first[0], again[0]) and torch.equal(first[1], again[1]),
                  f"{name} B={batch} T={t} hd={hd} blockwise_attention_fwd block_k={bk} "
                  f"with LSE: the same bits over two runs")
        first, again = (attention.blockwise_attention_fwd(qkv, nh, hd, return_lse=True)
                        for _ in range(2))
        check(torch.equal(first[0], again[0]) and torch.equal(first[1], again[1]),
              f"{name} B={batch} T={t} hd={hd} blockwise_attention_fwd with LSE: the "
              f"same bits over two runs")
        first, again = (attention.blockwise_attention_bwd(qkv, out, lse, do, nh, hd)
                        for _ in range(2))
        check(torch.equal(first, again),
              f"{name} B={batch} T={t} hd={hd} blockwise_attention_bwd: the same bits "
              f"over two runs (no atomics)")
        del qkv, do, out, lse, q, k, v, cases, first, again
        torch.cuda.empty_cache()
    return rows


def flash_f32_rows(qkv, do, nh: int, hd: int, name_prefix: str) -> list[dict]:
    """Phase 2g's fp32 rows (rows 9-fp32 and 12-fp32) on fp32 qkv and dO:
    the blockwise forward's fp32 form on the slabs without and with the LSE
    at each key tile (one kernel; the tile is a run-time step of its
    running max), on split heads (``flash_attention``), and the fp32
    blockwise backward on the plain fp32 forward's out and lse, each
    against its plain version (F32_TOL and LSE_TOL forward, F32_GRAD_REL
    backward); yardsticks SDPA in fp32 forward and backward, its backend
    named. Bounds: the tensors read and written once; 4·T²·hd a head at the
    fp32 peak forward, 10·T²·hd backward (the kernels' own work is 6 and
    14). The 128-key slab, LSE, split-head and backward rows go into the
    record (launches from phase 3i's ViT-L/16@512 runs and phase 6a); the
    same bits over two calls for each tile with the LSE and for the
    backward."""
    F = torch.nn.functional
    batch, t, three_d = qkv.shape
    d, n = three_d // 3, batch * nh
    out, lse = attention.blockwise_attention_fwd_reference(qkv, nh, hd, return_lse=True)
    q, k, v = qkv.reshape(batch, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
    backend = sdpa_backend(q, k, v)
    cfg = heads_cfg(nh, hd)
    fwd_ops, fwd_bytes = {"fp32": 4 * n * t * t * hd}, batch * t * 4 * d * 4
    cases = []
    for bk in attention.FLASH_BLOCK_KS:
        tag = "" if bk == 128 else f" block_k={bk}"
        cases += [
            dict(name=f"blockwise_attention_fwd{tag} (fp32; SDPA takes {backend})",
                 counter="attention_flash_f32", tol=F32_TOL, min_same=0.0,
                 record=bk == 128,
                 kernel=lambda bk=bk: attention.blockwise_attention_fwd(
                     qkv, nh, hd, block_k=bk)[0],
                 plain=lambda bk=bk: attention.blockwise_attention_fwd_reference(
                     qkv, nh, hd, block_k=bk)[0],
                 library=lambda: F.scaled_dot_product_attention(q, k, v),
                 bytes=fwd_bytes, ops=fwd_ops),
            dict(name=f"blockwise_attention_fwd{tag} with LSE (fp32 out, fp32 lse)",
                 counter="attention_flash_lse_f32", tol=[F32_TOL, LSE_TOL],
                 min_same=[0.0, 0.0], record=bk == 128,
                 kernel=lambda bk=bk: attention.blockwise_attention_fwd(
                     qkv, nh, hd, return_lse=True, block_k=bk),
                 plain=lambda bk=bk: attention.blockwise_attention_fwd_reference(
                     qkv, nh, hd, return_lse=True, block_k=bk),
                 library=lambda: F.scaled_dot_product_attention(q, k, v),
                 bytes=fwd_bytes + n * t * 4, ops=fwd_ops),
        ]
    cases += [
        dict(name="flash_attention (split heads, fp32)", counter="attention_flash_split_f32",
             tol=F32_TOL, min_same=0.0,
             kernel=lambda: attention.flash_attention(q, k, v, cfg),
             plain=lambda: attention.flash_attention_reference(q, k, v, cfg),
             library=lambda: F.scaled_dot_product_attention(q, k, v),
             bytes=fwd_bytes, ops=fwd_ops),
        _grad_case(f"blockwise_attention_bwd (fp32 dqkv; SDPA takes {backend})",
                   "attention_flash_bwd_f32",
                   lambda: attention.blockwise_attention_bwd(qkv, out, lse, do, nh, hd),
                   lambda: attention.blockwise_attention_bwd_reference(
                       qkv, out, lse, do, nh, hd),
                   rel=F32_GRAD_REL, library=sdpa_backward(qkv, do, nh, hd),
                   bytes=batch * t * 8 * d * 4 + n * t * 4,
                   ops={"fp32": 10 * n * t * t * hd}, kernel_ops=14 * n * t * t * hd),
    ]
    with torch.inference_mode():
        rows = run_cases(cases[:-1], batch, name_prefix)
    rows += run_cases(cases[-1:], batch, name_prefix)
    for bk in attention.FLASH_BLOCK_KS:
        first, again = (attention.blockwise_attention_fwd(qkv, nh, hd, return_lse=True,
                                                          block_k=bk) for _ in range(2))
        check(torch.equal(first[0], again[0]) and torch.equal(first[1], again[1]),
              f"{name_prefix}blockwise_attention_fwd (fp32) block_k={bk} with LSE: the "
              f"same bits over two runs")
    first, again = (attention.blockwise_attention_bwd(qkv, out, lse, do, nh, hd)
                    for _ in range(2))
    check(torch.equal(first, again),
          f"{name_prefix}blockwise_attention_bwd (fp32): the same bits over two runs "
          f"(no atomics)")
    return rows


def tuned_flash_cases(qkv, q, k, v, nh: int, hd: int, batch: int, t: int) -> list[dict]:
    """Phase 2g's rows of the blockwise forward's 256- and 512-key
    instances (``block_k``, JAX's key tile, part of the function) on the
    slabs without and with the LSE and on split heads, each against its
    plain version at the same tile under the 128-key instance's gate;
    yardstick SDPA. Bound as the 128-key rows': it depends on T and hd, not
    on the tile. Only the slab form without the LSE, the one an engine's
    forward runs, goes into the record (its launches from phase 6d)."""
    F, d, n = torch.nn.functional, nh * hd, batch * nh
    fwd_ops = {"bf16": 4 * n * t * t * hd}
    cfg = heads_cfg(nh, hd)
    cases = []
    for bk in FLASH_TUNED_KS:
        counter = f"attention_flash_k{bk}"
        cases += [
            dict(name=f"blockwise_attention_fwd block_k={bk} (bf16)", counter=counter,
                 tol=BF16_TOL, min_same=MIN_SAME_KERNEL,
                 kernel=lambda bk=bk: attention.blockwise_attention_fwd(
                     qkv, nh, hd, block_k=bk)[0],
                 plain=lambda bk=bk: attention.blockwise_attention_fwd_reference(
                     qkv, nh, hd, block_k=bk)[0],
                 library=lambda: F.scaled_dot_product_attention(q, k, v),
                 bytes=batch * t * 4 * d * 2, ops=fwd_ops),
            dict(name=f"blockwise_attention_fwd block_k={bk} with LSE (bf16 out, fp32 "
                      f"lse)", counter=counter, record=False,
                 tol=[BF16_TOL, LSE_TOL], min_same=[MIN_SAME_KERNEL, 0.0],
                 kernel=lambda bk=bk: attention.blockwise_attention_fwd(
                     qkv, nh, hd, return_lse=True, block_k=bk),
                 plain=lambda bk=bk: attention.blockwise_attention_fwd_reference(
                     qkv, nh, hd, return_lse=True, block_k=bk),
                 library=lambda: F.scaled_dot_product_attention(q, k, v),
                 bytes=batch * t * 4 * d * 2 + n * t * 4, ops=fwd_ops),
            dict(name=f"flash_attention block_k={bk} (split heads, bf16)", counter=counter,
                 record=False, tol=BF16_TOL, min_same=MIN_SAME_KERNEL,
                 kernel=lambda bk=bk: attention.flash_attention(q, k, v, cfg, block_k=bk),
                 plain=lambda bk=bk: attention.flash_attention_reference(q, k, v, cfg,
                                                                         block_k=bk),
                 library=lambda: F.scaled_dot_product_attention(q, k, v),
                 bytes=batch * t * 4 * d * 2, ops=fwd_ops),
        ]
    return cases


def heads_cfg(nh: int, hd: int):
    """A config whose only use is its head dim (flash_attention's scale)."""
    return dataclasses.replace(CFG, name=f"heads {nh}x{hd}", embed_dim=nh * hd,
                               num_heads=nh)


def public_op_rows(dev) -> list[dict]:
    """Phase 2h: ``flash_attention`` at PUBLIC_ATTN_ROWS' shapes,
    ``packed_fused_attention`` with per-head packing at PER_HEAD_KV_LENS
    and in its 849-1024 window, and ``residual_layer_norm`` at ViT-B/16's
    width, against their plain versions. Yardsticks: SDPA on the same [B, H, T, hd] tensors; ``x + r``
    then ``F.layer_norm`` (two calls). Bounds: q, k, v read and the output
    written once, 4·T²·hd a head (the function's; the single-pass kernel
    does 6, recomputing the scores); the LN's inputs read and outputs
    written once."""
    F, bf, f32 = torch.nn.functional, torch.bfloat16, torch.float32
    rows = []
    for name, batch, nh, t, hd, dtype, as_view in PUBLIC_ATTN_ROWS:
        gen = torch.Generator(device=dev).manual_seed(t + batch)
        cfg = heads_cfg(nh, hd)
        n = batch * nh
        if as_view:
            qkv = torch.randn((batch, t, 3 * nh * hd), generator=gen,
                              device=dev).to(dtype)
            q, k, v = qkv.reshape(batch, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
        else:
            q, k, v = (torch.randn((batch, nh, t, hd), generator=gen,
                                   device=dev).to(dtype) for _ in range(3))
        long_route = t > attention.SINGLE_PASS_MAX_T
        ref = attention.flash_attention_reference(q, k, v, cfg)
        bf16 = dtype == bf
        what = ("split-head blockwise" if long_route else "single-pass") + (
            ", permuted views of the qkv GEMM output" if as_view else "")
        case = dict(
            name=f"flash_attention {name} B={batch} T={t} hd={hd} ({what}, "
                 f"{'bf16' if bf16 else 'fp32'})",
            counter="attention_flash_split" if long_route else "attention_single",
            source=None if bf16 else _CSRC + "attention_single.cu",
            tol=BF16_TOL if bf16 else _scaled_tol(ref, SINGLE_F32_REL),
            min_same=MIN_SAME_KERNEL if bf16 else 0.0,
            kernel=lambda q=q, k=k, v=v, cfg=cfg: ops.flash_attention(q, k, v, cfg),
            plain=lambda q=q, k=k, v=v, cfg=cfg: attention.flash_attention_reference(
                q, k, v, cfg),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v),
            bytes=4 * n * t * hd * q.element_size(),
            ops={"bf16" if bf16 else "fp32": 4 * n * t * t * hd})
        rows += run_cases([case], batch)
        check(torch.equal(case["kernel"](), case["kernel"]()),
              f"{case['name']}: the same bits over two runs")
        del q, k, v, ref, case
    for kv_len in PER_HEAD_KV_LENS:
        batch, nh, hd, t = SMOKE_BATCH, CFG.num_heads, CFG.head_dim, PER_HEAD_T
        gen = torch.Generator(device=dev).manual_seed(kv_len)
        qkv = torch.randn((batch, t, 3 * nh * hd), generator=gen, device=dev).to(bf)
        q, k, v = qkv.reshape(batch, t, nh, 3, hd).permute(3, 0, 2, 1, 4)
        case = dict(
            name=f"packed_fused_attention per_head B={batch} T={t} hd={hd} true_seq_len="
                 f"{kv_len} (the packed kernel's key-count entry, "
                 f"{'one pass' if kv_len <= 256 else 'two passes'})",
            counter="attention", tol=BF16_TOL, min_same=MIN_SAME_KERNEL,
            kernel=lambda qkv=qkv, kv_len=kv_len: attention.packed_fused_attention(
                qkv, num_heads=nh, head_dim=hd, packing="per_head", true_seq_len=kv_len),
            plain=lambda qkv=qkv, kv_len=kv_len: attention.packed_fused_attention_reference(
                qkv, nh, hd, packing="per_head", true_seq_len=kv_len),
            # The same function: SDPA over the first kv_len keys.
            library=lambda q=q, k=k, v=v, kv_len=kv_len: F.scaled_dot_product_attention(
                q, k[:, :, :kv_len], v[:, :, :kv_len]),
            bytes=(2 * t + 2 * kv_len) * batch * nh * hd * 2,
            ops={"bf16": 4 * batch * nh * t * kv_len * hd})
        rows += run_cases([case], batch)
        check(torch.equal(case["kernel"](), case["kernel"]()),
              f"{case['name']}: the same bits over two runs")
        del qkv, q, k, v, case
    for t in WINDOW_TS:
        batch, nh, hd = 4, 16, 64
        gen = torch.Generator(device=dev).manual_seed(t)
        qkv = torch.randn((batch, t, 3 * nh * hd), generator=gen, device=dev).to(bf)
        q, k, v = qkv.reshape(batch, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
        rows += run_cases([dict(
            name=f"packed_fused_attention B={batch} T={t} hd={hd} (the packed kernel "
                 f"on the slabs, the first form's window)", counter="attention",
            tol=BF16_TOL, min_same=MIN_SAME_KERNEL,
            kernel=lambda qkv=qkv: attention.packed_fused_attention(
                qkv, num_heads=nh, head_dim=hd),
            plain=lambda qkv=qkv: attention.packed_fused_attention_reference(
                qkv, nh, hd),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v),
            bytes=4 * batch * nh * t * hd * 2,
            ops={"bf16": 4 * batch * nh * t * t * hd})], batch)
    d, eps = CFG.embed_dim, CFG.eps
    for m in RESIDUAL_LN_ROWS:
        for dtype in (bf, f32):
            gen = torch.Generator(device=dev).manual_seed(m)
            x = (torch.randn((m, d), generator=gen, device=dev) * 0.5).to(dtype)
            r = torch.randn((m, d), generator=gen, device=dev).to(dtype)
            w = torch.randn(d, generator=gen, device=dev) * 0.02 + 1.0
            b = torch.randn(d, generator=gen, device=dev) * 0.02
            w_lib, b_lib = w.to(dtype), b.to(dtype)
            bf16 = dtype == bf
            rows += run_cases([dict(
                name=f"residual_layer_norm M={m} D={d} ({'bf16' if bf16 else 'fp32'}; "
                     f"normalized, summed)", counter="layernorm_residual",
                tol=[BF16_TOL if bf16 else F32_TOL, EXACT],
                min_same=[MIN_SAME_KERNEL if bf16 else 0.0, 1.0],
                kernel=lambda x=x, r=r, w=w, b=b: ops.residual_layer_norm(
                    x, r, w, b, eps),
                plain=lambda x=x, r=r, w=w, b=b:
                    layernorm.residual_layer_norm_reference(x, r, w, b, eps),
                library=lambda x=x, r=r, w=w_lib, b=b_lib: F.layer_norm(
                    x + r, (d,), w, b, eps),
                bytes=4 * m * d * x.element_size() + 2 * d * 4,
                ops={"fp32": 9 * m * d})], m // CFG.num_tokens)
    return rows


def chunked_mlp_rows(cfg, batch: int, dev, whole_layer: bool) -> list[dict]:
    """The light and wgrad stages at ``cfg``'s width against their plain
    versions (wgrad on the plain light stage's streams); with
    ``whole_layer`` also the pair against the mono stage and the whole
    layer backward with its stage counts."""
    gen = torch.Generator(device=dev).manual_seed(batch)
    lp = train_layer(gen, dev, cfg)
    d, h, t = cfg.embed_dim, cfg.hidden_dim, cfg.num_tokens
    m, bf = batch * t, torch.bfloat16
    x2 = torch.randn((batch, t, d), generator=gen, device=dev) * 0.5
    dout = (torch.randn((batch, t, d), generator=gen, device=dev) * 0.01).to(bf)
    _, hid, dhp, _ = fused_block.fused_bwd_stage_mlp_light_reference(x2, dout, lp, cfg)
    cases = [
        _grad_case("fused_bwd_stage_mlp_light (_mlp_light_bwd_kernel: 9 launches)",
                   "fused_bwd_mlp_light",
                   lambda: flat(fused_block.fused_bwd_stage_mlp_light(x2, dout, lp, cfg)),
                   lambda: flat(fused_block.fused_bwd_stage_mlp_light_reference(
                       x2, dout, lp, cfg)),
                   rel=STAGE_GRAD_REL, library=None,
                   bytes=m * d * (4 + 2 + 4) + m * h * 2 * 2 + 2 * d * h * 2,
                   ops={"bf16": 6 * m * d * h}),
        _grad_case("fused_bwd_stage_mlp_wgrad (_mlp_wgrad_kernel: 3 launches)",
                   "fused_bwd_mlp_wgrad",
                   lambda: fused_block.fused_bwd_stage_mlp_wgrad(x2, dout, hid, dhp, lp, cfg),
                   lambda: fused_block.fused_bwd_stage_mlp_wgrad_reference(
                       x2, dout, hid, dhp, lp, cfg),
                   library=None, bytes=m * d * (4 + 2) + m * h * 2 * 2 + 2 * d * h * 4,
                   ops={"bf16": 4 * m * d * h}),
    ]
    if whole_layer:
        x = (torch.randn((batch, t, d), generator=gen, device=dev) * 0.5).to(bf)
        cases.append(layer_bwd_case(x, lp, dout, cfg))
    rows = run_cases(cases, batch, f"{cfg.name} B={batch} ")
    if whole_layer:
        dx2, hid_k, dhp_k, small = fused_block.fused_bwd_stage_mlp_light(x2, dout, lp, cfg)
        wg = fused_block.fused_bwd_stage_mlp_wgrad(x2, dout, hid_k, dhp_k, lp, cfg)
        mdx2, mono = fused_block.fused_bwd_stage_mlp_mono(x2, dout, lp, cfg)
        check(torch.equal(dx2, mdx2) and torch.equal(wg[0], mono["fc1_w"])
              and torch.equal(wg[1], mono["fc2_w"])
              and all(torch.equal(v, mono[k]) for k, v in small.items()),
              f"B={batch} {cfg.name}: light -> wgrad equals the mono MLP stage bit "
              f"for bit on the card")
        names = ("fused_bwd_mlp", "fused_bwd_mlp_light", "fused_bwd_mlp_wgrad",
                 "fused_bwd_attn", "fused_bwd")
        before = read_counts()
        fused_block.fused_encoder_layer_bwd(x, lp, dout, cfg)
        torch.cuda.synchronize()
        after = read_counts()
        moved = [after[n] - before[n] for n in names]
        check(moved == [0, 1, 1, 1, 1],
              f"{cfg.name}: one fused_encoder_layer_bwd launches {dict(zip(names, moved))} "
              f"(light and wgrad once, the mono stage never)")
    return rows


def train_batch(n: int, seed: int, cfg=CFG) -> tuple:
    """Seeded images, all of one seeded label. A few steps from the
    zero-initialised head learn a batch's label frequencies first (with 32
    distinct labels the loss sat at ln 32 after 8 steps, every image's
    top-2 logits tied, on an H100 80GB HBM3), so one label is what makes the
    trained model's top-1 margin decisive and its exported labels
    checkable."""
    images = fixtures.random_images(cfg, n=n, seed=seed)
    return images, np.full(n, seed % cfg.num_classes)


def start_params(cfg, seed: int, dev) -> dict:
    """Stacked fp32 params on the card from ``fixtures.random_params``
    (non-zero heads, unlike a Trainer's own initialisation)."""
    return vit.stack_params(fixtures.random_params(cfg, seed=seed), cfg,
                            param_dtype=torch.float32, device=dev)


# Each step check's errors, by (config name, route): (loss, mu, update
# where resolved, update anywhere), so that a later phase can print its own
# beside an earlier one's.
STEP_ERRORS: dict = {}


def one_step_vs_plain(tr: Trainer, route: str, images, labels, start: dict,
                      cfg=CFG) -> float:
    """One AdamW step of the Trainer ``tr`` (built on ``route``) from
    ``start`` against the same step with its links swapped for their plain
    versions. ``tr`` restarts from a copy of ``start`` with a fresh AdamW
    state and step count before each (one Trainer serves both: building
    another would only initialise weights that are replaced). Returns the
    losses' relative difference."""
    def step():
        tr.params = optim.tree_map(torch.clone, start)
        tr.opt_state = tr._init_opt(tr.params)
        tr.step_idx = 0
        tr.fit(iter([(images, labels)]), steps=1)
        torch.cuda.synchronize()
        return tr.last_loss, tr.params["layers"], tr.opt_state["mu"]["layers"]

    loss, params, mus = step()
    # Every link of the training routes on its plain version.
    with plain_chain("packed_fused_attention", "packed_attention_bwd",
                     "blockwise_attention_fwd", "blockwise_attention_bwd",
                     module=attention), \
            plain_chain("fused_encoder_layer", "fused_encoder_layer_bwd"):
        plain_loss, plain_params, plain_mus = step()
    loss_err = abs(loss - plain_loss) / abs(plain_loss)
    mu_err, sure_err, any_err, mean_err = 0.0, 0.0, 0.0, 0.0
    for key in start["layers"]:
        mu, mu_plain = mus[key], plain_mus[key]
        scale = max(float(mu_plain.abs().max()), 1e-30)
        mu_err = max(mu_err, float((mu - mu_plain).abs().max()) / scale)
        diff = (params[key] - plain_params[key]).abs() / TRAIN_LR
        sure = mu_plain.abs() > MU_REL * scale
        sure_err = max(sure_err, float(diff[sure].max()))
        any_err = max(any_err, float(diff.max()))
        mean_err = max(mean_err, float(diff.mean()))
    STEP_ERRORS.setdefault((cfg.name, route), []).append(
        (loss_err, mu_err, sure_err, any_err))
    print(f"  {cfg.name} {route}: one step vs the plain links: loss {loss:.6f} vs "
          f"{plain_loss:.6f} (rel {loss_err:.2e}); layer mu max rel err "
          f"{mu_err:.3e}; update difference {sure_err:.3e} lr where |mu| > "
          f"{MU_REL} of its leaf's largest, {any_err:.3f} lr at most, "
          f"{mean_err:.3f} lr on average", flush=True)
    check(loss_err <= STEP_LOSS_REL and mu_err <= MU_REL
          and sure_err <= UPDATE_ATOL and any_err <= 2.0 + UPDATE_ATOL,
          f"{cfg.name} {route} step within tolerance of its plain links (loss {loss_err:.2e} "
          f"<= {STEP_LOSS_REL}, mu {mu_err:.2e} <= {MU_REL}, updates "
          f"{sure_err:.2e} lr <= {UPDATE_ATOL} lr where the gradient is "
          f"resolved, {any_err:.3f} lr <= 2 lr anywhere)")
    return loss_err


def training_main_path(dev, tmp: Path) -> dict:
    """Phase 5: ViT-B/16 at full width through Trainer in each route: the
    loss falls over TRAIN_STEPS steps on a memorised batch, the launch
    counts of those steps, a step against the plain links, save → resume,
    and export → the CLI's labels."""
    images, labels = train_batch(TRAIN_BATCH, seed=3)
    start = start_params(CFG, 1, dev)
    counts = {}
    for route in TRAIN_ROUTES:
        logs = []
        t0 = time.perf_counter()
        tr = Trainer(CFG, device=dev, lr=TRAIN_LR, optimizer="adamw",
                     compute_dtype=torch.bfloat16, attention_impl=route,
                     log_every=1, log_fn=logs.append, seed=0,
                     checkpoint_dir=str(tmp / f"ck_{route}"))
        setup = time.perf_counter() - t0
        batches = data.memory_dataset(images, labels, TRAIN_BATCH, epochs=None,
                                      seed=1)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        tr.fit(batches, steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts[route] = read_counts()
        losses = [float(line.split("loss ")[1].split(",")[0]) for line in logs]
        print(f"  {route}: Trainer set up in {setup:.1f} s; {TRAIN_STEPS} steps at "
              f"B={TRAIN_BATCH} in {elapsed:.2f} s; losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
        check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses))
              and losses[-1] < losses[0],
              f"{route}: the loss falls over {TRAIN_STEPS} steps "
              f"({losses[0]:.4f} -> {losses[-1]:.4f})")
        expected = {key: TRAIN_PER_LAYER[route].get(key, 0) * CFG.depth * TRAIN_STEPS
                    for key in COUNTERS}
        check(counts[route] == expected,
              f"{route}: launches of {TRAIN_STEPS} steps {counts[route]}, expected "
              f"{expected}")
        if route == "fused":
            resume_and_export(tr, dev, tmp, images)
        if route != "xla":
            one_step_vs_plain(tr, route, images, labels, start)
        del tr
        torch.cuda.empty_cache()
    return counts


def fit_and_count(cfg, route: str, batch: int, per_layer: dict, dev, images,
                  labels) -> tuple:
    """TRAIN_STEPS steps of ``Trainer(cfg)`` on ``route`` at ``batch`` on one
    memorised batch: the loss falls, and the launches of those steps are
    ``per_layer`` a layer a step. Returns the counts and the Trainer."""
    logs = []
    t0 = time.perf_counter()
    tr = Trainer(cfg, device=dev, lr=TRAIN_LR, optimizer="adamw",
                 compute_dtype=torch.bfloat16, attention_impl=route,
                 log_every=1, log_fn=logs.append, seed=0)
    setup = time.perf_counter() - t0
    batches = data.memory_dataset(images, labels, batch, epochs=None, seed=1)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tr.fit(batches, steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    losses = [float(line.split("loss ")[1].split(",")[0]) for line in logs]
    print(f"  {cfg.name} {route}: Trainer set up in {setup:.1f} s; {TRAIN_STEPS} "
          f"steps at B={batch} in {elapsed:.2f} s; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses))
          and losses[-1] < losses[0],
          f"{cfg.name} {route}: the loss falls over {TRAIN_STEPS} steps "
          f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    expected = {key: per_layer.get(key, 0) * cfg.depth * TRAIN_STEPS
                for key in COUNTERS}
    check(counts == expected,
          f"{cfg.name} {route}: launches of {TRAIN_STEPS} steps {counts}, "
          f"expected {expected}")
    return counts, tr


def large_training_main_path(dev) -> dict:
    """Phase 5b: ViT-L/16@384 at full depth and widths through Trainer on
    the fused route: the loss falls over TRAIN_STEPS steps on a memorised
    batch, the launch counts of those steps (the chunked MLP pair, never the
    mono stage), and one fused and one flash step against the plain
    links."""
    cfg, batch = LARGE_CFG, LARGE_TRAIN_BATCH
    images, labels = train_batch(batch, seed=3, cfg=cfg)
    counts, tr = fit_and_count(cfg, "fused", batch, LARGE_PER_LAYER, dev, images,
                               labels)
    start = start_params(cfg, 1, dev)
    one_step_vs_plain(tr, "fused", images, labels, start, cfg)
    del tr
    tr = Trainer(cfg, device=dev, lr=TRAIN_LR, optimizer="adamw",
                 compute_dtype=torch.bfloat16, attention_impl="flash",
                 log_every=0, seed=0)
    one_step_vs_plain(tr, "flash", images, labels, start, cfg)
    del tr, start
    torch.cuda.empty_cache()
    return counts


def long_training_main_path(dev, host_params: dict) -> dict:
    """Phase 5c: ViT-L/16@512 at full depth and widths through Trainer on
    ``flash`` and ``fused``: the loss falls over TRAIN_STEPS steps at
    LONG_TRAIN_BATCH on a memorised batch, with each route's launch counts
    (the blockwise forward with its LSE and the blockwise backward in
    ``flash``; the blockwise forward in ``fused``'s chain and recomputes);
    one step of each route from ``host_params`` (phase 3e's random params)
    against the plain links at LONG_STEP_BATCH, the ``fused`` one on a
    batch of each of LONG_STEP_SEEDS. Returns the counts by route."""
    cfg, batch = LONG_CFG, LONG_TRAIN_BATCH
    images, labels = train_batch(batch, seed=3, cfg=cfg)
    start = vit.stack_params(host_params, cfg, param_dtype=torch.float32, device=dev)
    counts = {}
    for route in ("flash", "fused"):
        counts[route], tr = fit_and_count(cfg, route, batch,
                                          LONG_TRAIN_PER_LAYER[route], dev, images,
                                          labels)
        if route == "flash":
            one_step_vs_plain(tr, route, images[:LONG_STEP_BATCH],
                              labels[:LONG_STEP_BATCH], start, cfg)
        for seed in LONG_STEP_SEEDS if route == "fused" else ():
            err = one_step_vs_plain(tr, route, *train_batch(LONG_STEP_BATCH, seed, cfg),
                                    start, cfg)
            print(f"  {cfg.name} fused, batch seed {seed}: loss rel err {err:.3e}, "
                  f"{err / STEP_NOISE_5C:.2f}x the plain links' reordering noise "
                  f"{STEP_NOISE_5C:.2e} (step_noise.py), gate {STEP_LOSS_REL}", flush=True)
        del tr
        torch.cuda.empty_cache()
    return counts


def long_fp32_main_path(dev, tmp: Path, params: dict, images: np.ndarray,
                        ref_probs: np.ndarray) -> dict:
    """Phase 3i at ViT-L/16@512 (T = 1025): fp32 past padded T = 1024 on the
    blockwise kernels' fp32 forms, full depth and widths. The fp32 engine
    (``InferenceEngine(LONG_CFG, param_dtype=torch.float32,
    compute_dtype=torch.float32, attention_impl="flash")``) on phase 3e's
    weights and decisive images at LONG_BATCH (``fp32_engine_run``), then
    ``fp32_training`` at LONG_F32_TRAIN_BATCH, its step checks printed beside
    phase 5c's bf16 ones. Returns {run: counts}."""
    cfg = LONG_CFG
    results.write_results(tmp / "answer.txt", ref_probs)
    engine = InferenceEngine(cfg, params, batch_size=LONG_BATCH,
                             param_dtype=torch.float32, compute_dtype=torch.float32,
                             attention_impl="flash", device=dev)
    counts = {"engine": fp32_engine_run(
        engine, tmp, images, ref_probs, cfg,
        {key: n * cfg.depth for key, n in LONG_F32_PER_LAYER.items()},
        f"{cfg.name} fp32 flash engine")}
    del engine
    torch.cuda.empty_cache()
    counts.update(fp32_training(dev, cfg, LONG_F32_TRAIN_BATCH, LONG_F32_TRAIN_PER_LAYER))
    return counts


def resume_and_export(tr, dev, tmp: Path, images) -> None:
    """save → resume restores step, params and AdamW state exactly; the
    exported weights through the CLI give the trained params' labels."""
    tr.save()
    back = Trainer(CFG, device=dev, lr=TRAIN_LR, optimizer="adamw",
                   compute_dtype=torch.bfloat16, attention_impl="fused",
                   log_every=0, seed=5, checkpoint_dir=tr.checkpoint_dir)
    def state(t):
        return optim.tree_leaves({"params": t.params, **t.opt_state})

    same = back.resume() and back.step_idx == tr.step_idx and all(
        torch.equal(a, b) for a, b in zip(state(tr), state(back)))
    check(same, f"save -> resume restores step {tr.step_idx}, params and the "
                f"AdamW state exactly")
    del back
    export_through_cli(tr, dev, tmp / "trained", images)


def export_through_cli(tr, dev, ws: Path, images, use_ema: bool = False) -> None:
    """``tr.export_reference`` (the EMA shadow with ``use_ema``) → ``cli
    --backend gpu`` on ``images``: the CLI's top-1 labels are those of the
    exported params' own forward on every decisive image."""
    what = "EMA params" if use_ema else "trained params"
    files = tr.export_reference(str(ws / "Network"), use_ema=use_ema)
    binfmt.save_image_data(ws / "input.bin", images)
    with torch.no_grad():
        logits = vit.forward(torch.from_numpy(images).to(dev),
                             tr.ema_params if use_ema else tr.params, CFG,
                             compute_dtype=torch.bfloat16,
                             kernels=vit.resolve_kernels("flash"),
                             return_logits=True).float()
    top2 = logits.topk(2, dim=-1)
    decisive = (top2.values[:, 0] - top2.values[:, 1]) >= MIN_LOGIT_GAP
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--input", str(ws / "input.bin"), "--weights",
                       str(ws / "Network"), "--output", str(ws / "result.txt"),
                       "--backend", "gpu", "--attention", "flash", "--config",
                       CFG.name, "--batch-size", str(SMOKE_BATCH)])
    lines = [results.parse_result_line(line) for line in
             (ws / "result.txt").read_text().splitlines()]
    want = top2.indices[:, 0].tolist()
    agree = [lab == w for (lab, _), w, dec in zip(lines, want, decisive.tolist())
             if dec]
    probs = torch.softmax(logits, -1).max(-1).values.tolist()
    prob_err = max((abs(p - q) for (_, p), q in zip(lines, probs)), default=1.0)
    print(f"  exported {len(files)} weight files; the CLI's top-1 labels vs the "
          f"{what}' forward: {sum(agree)} of {len(agree)} decisive images "
          f"(top-2 logit gap >= {MIN_LOGIT_GAP}) agree, {len(images) - len(agree)} "
          f"near-ties left out; top-1 probabilities within {prob_err:.3e}",
          flush=True)
    check(rc == 0 and len(lines) == len(images) and agree and all(agree)
          and prob_err <= PROB_TOL,
          f"export_reference{'(use_ema=True)' if use_ema else ''} -> cli --backend "
          f"gpu: the {what}' labels, probabilities within {PROB_TOL}")


def recording(tr: Trainer) -> list:
    """Wrap ``tr``'s step to keep each step's batch (as the step got it:
    after the input pipeline) and its loss tensor."""
    seen, step = [], tr._step

    def wrapped(*args):
        out = step(*args)
        seen.append((args[-2].clone(), args[-1].clone(), out[-1]))
        return out

    tr._step = wrapped
    return seen


def recipe_trainer(dev, ck: Path) -> Trainer:
    return Trainer(CFG, device=dev, lr=TRAIN_LR, optimizer="adamw",
                   compute_dtype=torch.bfloat16, attention_impl="fused",
                   device_augment={}, mixup={}, ema_decay=RECIPE_EMA,
                   log_every=0, seed=0, checkpoint_dir=str(ck))


def recipe_main_path(dev, tmp: Path, smi_line: str, fused_counts: dict) -> None:
    """Phase 5d: the DeiT recipe on the card. ``Trainer(device_augment={},
    mixup={}, ema_decay=RECIPE_EMA)`` (fused, bf16, AdamW) from seeded random
    params takes RECIPE_STEPS steps at RECIPE_BATCH from ``raw_batches`` over
    RECIPE_SOURCES seeded uint8 images, saving at RECIPE_RESUME_AT. Gates:
    finite losses; each step's batch equals ``device_augment`` then
    ``device_mixup_cutmix`` called directly on its step's generators; a
    Trainer resumed from the checkpoint takes the same batches and gives the
    same losses; the EMA export through the CLI gives the EMA params'
    labels; the launches equal phase 5's fused ones (the pipeline adds no
    kernel). Then the pipeline's times beside a ViT-B fused step at
    RECIPE_STEP_BATCH, and the host pipeline's img/s."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(RECIPE_SEED)
    raw = rng.integers(0, 256, (RECIPE_SOURCES, RECIPE_SRC, RECIPE_SRC, 3),
                       dtype=np.uint8)
    labels = rng.integers(0, CFG.num_classes, RECIPE_SOURCES)

    def batches():
        return augment_device.raw_batches(raw, labels, RECIPE_BATCH, epochs=None,
                                          seed=RECIPE_SEED)

    ck = tmp / "ck_recipe"
    tr = recipe_trainer(dev, ck)
    # Random params with non-zero heads: the EMA of a zero head after a few
    # steps has near-tied logits, and its exported labels could not be held.
    tr.params = start_params(CFG, 1, dev)
    tr.opt_state = tr._init_opt(tr.params)
    tr.ema_params = optim.tree_map(torch.clone, tr.params)
    plain_step = tr._step
    seen = recording(tr)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tr.fit(batches(), steps=RECIPE_RESUME_AT)
    torch.cuda.synchronize()
    t_save = time.perf_counter()
    tr.save()
    t_save = time.perf_counter() - t_save
    tr.fit(itertools.islice(batches(), RECIPE_RESUME_AT, None), steps=RECIPE_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0 - t_save
    counts = read_counts()
    losses = [float(loss) for *_, loss in seen]
    print(f"  {RECIPE_STEPS} recipe steps at B={RECIPE_BATCH} in {elapsed:.2f} s "
          f"(+ a save in {t_save:.2f} s); losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    check(len(losses) == RECIPE_STEPS and all(np.isfinite(losses)),
          f"the recipe's {RECIPE_STEPS} losses are finite")
    expected = {k: v * RECIPE_STEPS // TRAIN_STEPS for k, v in fused_counts.items()}
    check(counts == expected,
          f"recipe launches of {RECIPE_STEPS} steps "
          f"{ {k: v for k, v in counts.items() if v} } equal phase 5's fused "
          f"steps' (the pipeline adds no kernel)")

    key_seed = 0 + 101  # Trainer(seed=0): seed + 101
    same = []
    for i, (x, y) in enumerate(itertools.islice(batches(), RECIPE_STEPS)):
        g_aug, g_mix = augment_device.step_generators(key_seed, i)
        want = augment_device.device_augment(torch.from_numpy(x).to(dev), g_aug,
                                             img_size=CFG.img_size)
        want_x, want_y = augment.device_mixup_cutmix(
            g_mix, want, torch.from_numpy(y).to(dev), CFG.num_classes)
        same.append(torch.equal(seen[i][0], want_x)
                    and torch.equal(seen[i][1], want_y))
    check(all(same), f"each step's batch is device_augment + device_mixup_cutmix "
                     f"of its (seed {key_seed}, step) ({sum(same)} of "
                     f"{len(same)} equal)")

    back = recipe_trainer(dev, ck)
    resumed = back.resume() and back.step_idx == RECIPE_RESUME_AT
    again = recording(back)
    back.fit(itertools.islice(batches(), RECIPE_RESUME_AT, None), steps=RECIPE_STEPS)
    after = [float(loss) for *_, loss in again]
    check(resumed and after == losses[RECIPE_RESUME_AT:] and all(
        torch.equal(a[0], b[0]) for a, b in zip(again, seen[RECIPE_RESUME_AT:])),
        f"resumed at step {RECIPE_RESUME_AT}: steps {RECIPE_RESUME_AT + 1}-"
        f"{RECIPE_STEPS} take the same batches and give the same losses "
        f"({' '.join(f'{v:.6f}' for v in after)})")
    del back, again
    tr._step = plain_step
    export_through_cli(tr, dev, tmp / "recipe_ema", fixtures.random_images(
        CFG, n=TRAIN_BATCH, seed=RECIPE_SEED), use_ema=True)
    del seen
    torch.cuda.empty_cache()
    t_gates = time.perf_counter() - t_phase

    # The pipeline's times on the card (CUDA events).
    times = {}
    for batch in RECIPE_TIME_BATCHES:
        xb = torch.from_numpy(np.resize(raw, (batch,) + raw.shape[1:])).to(dev)
        gen = torch.Generator()
        times[f"device_augment_ms_b{batch}"] = time_ms(
            lambda: augment_device.device_augment(xb, gen, img_size=CFG.img_size),
            reps=5)
    xb = torch.from_numpy(np.resize(raw, (RECIPE_STEP_BATCH,) + raw.shape[1:])).to(dev)
    yb = torch.from_numpy(np.resize(labels, RECIPE_STEP_BATCH)).to(dev)
    xf = augment_device.device_augment(xb, torch.Generator(), img_size=CFG.img_size)
    gen = torch.Generator()
    times["device_mixup_cutmix_ms"] = time_ms(
        lambda: augment.device_mixup_cutmix(gen, xf, yb, CFG.num_classes), reps=5)
    step_ms = time_ms(lambda: tr._step(tr.params, tr.opt_state, xf, yb), reps=5)
    prep_step_ms = time_ms(lambda: tr._step(tr.params, tr.opt_state,
                                            *tr._prep(xb, yb, tr.step_idx)), reps=5)
    share = (prep_step_ms - step_ms) / prep_step_ms
    # Through Trainer.fit (host clock): raw uint8 batches through the
    # pipeline against normalized fp32 ones (their upload) on one Trainer.
    fit_ms = {}
    normalized = fixtures.random_images(CFG, n=RECIPE_STEP_BATCH, seed=RECIPE_SEED)
    for what in ("pipeline", "fp32"):
        prep = tr._prep
        if what == "fp32":
            tr._prep = None

            def feed():
                return data.memory_dataset(
                    normalized, np.resize(labels, RECIPE_STEP_BATCH),
                    RECIPE_STEP_BATCH, epochs=None)
        else:
            def feed():
                return augment_device.raw_batches(raw, labels, RECIPE_STEP_BATCH,
                                                  epochs=None)
        tr.fit(feed(), steps=tr.step_idx + 2)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.fit(feed(), steps=tr.step_idx + RECIPE_FIT_STEPS)
        torch.cuda.synchronize()
        fit_ms[what] = (time.perf_counter() - t0) / RECIPE_FIT_STEPS * 1e3
        tr._prep = prep
    times["fit_ms"] = fit_ms
    print(f"  device_augment (RRC, flip, RandAugment 2 ops at 9, normalize; "
          f"{RECIPE_SRC}x{RECIPE_SRC} uint8 -> {CFG.img_size}): "
          + ", ".join(f"B={b} {times[f'device_augment_ms_b{b}']:.3f} ms"
                      for b in RECIPE_TIME_BATCHES)
          + f"; device_mixup_cutmix B={RECIPE_STEP_BATCH} "
          f"{times['device_mixup_cutmix_ms']:.3f} ms", flush=True)
    print(f"  {CFG.name} fused AdamW step at B={RECIPE_STEP_BATCH}: {step_ms:.2f} ms "
          f"on a normalized batch, {prep_step_ms:.2f} ms with the pipeline in front "
          f"({share * 100:.1f}% of it, in one thread); "
          f"{RECIPE_STEP_BATCH / prep_step_ms * 1e3:.1f} img/s; through Trainer.fit: "
          f"{fit_ms['pipeline']:.2f} ms a "
          f"step from raw uint8, {fit_ms['fp32']:.2f} ms from normalized fp32 "
          f"({(fit_ms['pipeline'] / fit_ms['fp32'] - 1) * 100:+.1f}%)", flush=True)
    del xb, yb, xf
    rates = {}
    for workers in (1, os.cpu_count() or 1):
        it = augment.augmented_dataset(raw, labels, RECIPE_STEP_BATCH,
                                       CFG.num_classes, img_size=CFG.img_size,
                                       epochs=None, seed=0, mix="device",
                                       workers=workers)
        try:
            next(it)
            t0 = time.perf_counter()
            for _ in range(RECIPE_HOST_BATCHES):
                next(it)
            rates[workers] = RECIPE_HOST_BATCHES * RECIPE_STEP_BATCH / (
                time.perf_counter() - t0)
        finally:
            it.close()
    step_rate = RECIPE_STEP_BATCH / step_ms * 1e3
    print("  host augmented_dataset (mix on the card): " + ", ".join(
        f"workers={w} {r:.1f} img/s ({r / step_rate:.3f}x the step's {step_rate:.1f})"
        for w, r in rates.items())
        + f"; _resize ran {augment.resize_backend()} (card: {smi_line})", flush=True)
    # The captured pipelines hold their pools: released here, so the later
    # phases' peak memory is what it was before this phase.
    gc.collect()
    held = torch.cuda.memory_allocated()
    augment_device.release_graphs()
    gc.collect()
    times["graphs_gib"] = (held - torch.cuda.memory_allocated()) / 2**30
    print(f"  the captured pipelines held {times['graphs_gib']:.2f} GiB "
          f"(B={RECIPE_BATCH}, {', '.join(map(str, RECIPE_TIME_BATCHES))})",
          flush=True)
    took = time.perf_counter() - t_phase
    print(json.dumps({"recipe": {
        "config": CFG.name, "card": smi_line, "batch": RECIPE_STEP_BATCH,
        **times, "step_ms": step_ms, "step_with_pipeline_ms": prep_step_ms,
        "pipeline_share": share,
        "host_img_per_s": {str(w): r for w, r in rates.items()},
        "step_img_per_s": step_rate, "resize": augment.resize_backend(),
        "gates_s": t_gates, "phase_s": took}}), flush=True)
    print(f"  phase 5d took {took:.1f} s (gates {t_gates:.1f} s; budget "
          f"{RECIPE_SECONDS:.0f} s)", flush=True)


def training_throughput(dev, cfg=CFG, batch: int = TRAIN_THROUGHPUT_BATCH,
                        routes=TRAIN_ROUTES,
                        compute_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Phases 4b and 4c: ms per AdamW step, img/s and peak memory of each
    route at ``batch``, and (bf16) the split of a fused step."""
    images, labels = train_batch(batch, seed=4, cfg=cfg)
    ti = torch.from_numpy(images).to(dev)
    tl = torch.from_numpy(labels).to(dev)
    # Initialised once on the host; each route gets its own copy on the card.
    host = vit.init_params(cfg, seed=0, device="cpu")
    out = {}
    for route in routes:
        init, step = spmd.make_train_step(cfg, device=dev, lr=TRAIN_LR,
                                          compute_dtype=compute_dtype,
                                          optimizer="adamw", attention_impl=route)
        params = optim.tree_map(lambda t: t.to(dev), host)
        state = init(params)
        step(params, state, ti, tl)  # warm-up (and a non-zero head)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: step(params, state, ti, tl), reps=5)
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[route] = ms
        tag = "" if compute_dtype == torch.bfloat16 else " fp32"
        print(f"throughput train {cfg.name} {route}{tag} B={batch}: {ms:.2f} ms per "
              f"AdamW step, {batch / ms * 1e3:.1f} img/s, peak memory {peak:.2f} GiB",
              flush=True)
        print(json.dumps({"train_throughput": {
            "config": cfg.name, "route": route, "batch": batch, "step_ms": ms,
            "img_per_s": batch / ms * 1e3, "peak_gib": peak,
            "compute_dtype": str(compute_dtype).split(".")[-1]}}), flush=True)
        if route == "fused" and compute_dtype == torch.bfloat16:
            fused_step_split(dev, params, state, ti, tl, ms, cfg)
        del params, state, init, step
        torch.cuda.empty_cache()
    return out


def fused_step_split(dev, params, state, images, labels, step_ms, cfg=CFG) -> None:
    """Where a fused step's time goes: the forward chain, each backward
    stage (the chunked MLP pair as two) over all layers, the AdamW update,
    the rest."""
    batch = images.shape[0]
    fb = fused_block
    with torch.no_grad():
        x = vit.embed(images, params, cfg, torch.bfloat16)
        lps = vit._layer_list(params)
        fwd = time_ms(lambda: [fb.fused_encoder_layer(x, lp, cfg) for lp in lps], reps=3)
        x2 = fb.fused_bwd_stage_x2(x, lps[0], cfg)
        dout = torch.full_like(x, 1e-3)
        stages = {"x2": lambda lp: fb.fused_bwd_stage_x2(x, lp, cfg)}
        if fb._pick_mlp_chunks(cfg.embed_dim, cfg.hidden_dim, 2) > 1:
            dx2, hid, dhp, _ = fb.fused_bwd_stage_mlp_light(x2, dout, lps[0], cfg)
            stages["mlp_light"] = lambda lp: fb.fused_bwd_stage_mlp_light(x2, dout, lp, cfg)
            stages["mlp_wgrad"] = lambda lp: fb.fused_bwd_stage_mlp_wgrad(
                x2, dout, hid, dhp, lp, cfg)
        else:
            dx2, _ = fb.fused_bwd_stage_mlp_mono(x2, dout, lps[0], cfg)
            stages["mlp"] = lambda lp: fb.fused_bwd_stage_mlp_mono(x2, dout, lp, cfg)
        stages["attn"] = lambda lp: fb.fused_bwd_stage_attn(x, dx2, lp, cfg)
        times = {name: time_ms(lambda: [fn(lp) for lp in lps], reps=3)
                 for name, fn in stages.items()}
        tx = optim.adamw(TRAIN_LR, weight_decay=0.05)
        grads = optim.tree_map(lambda p: torch.full_like(p, 1e-4), params)
        t_opt = time_ms(lambda: optim.apply_updates(params, tx.update(grads, state, params)[0]),
                        reps=3)
    rest = step_ms - (fwd + sum(times.values()) + t_opt)
    print(f"  {cfg.name} fused step split at B={batch} (ms): forward chain {fwd:.2f}, "
          + ", ".join(f"stage {name} {ms:.2f}" for name, ms in times.items())
          + f" ({cfg.depth} layers each), AdamW {t_opt:.2f}, the rest (embedding, "
          f"head, loss, autograd) {rest:.2f}; step {step_ms:.2f}", flush=True)
    print(json.dumps({"fused_step_split": {
        "config": cfg.name, "batch": batch, "forward_chain_ms": fwd,
        **{f"stage_{name}_ms": ms for name, ms in times.items()},
        "adamw_ms": t_opt, "rest_ms": rest, "step_ms": step_ms}}), flush=True)


def fp32_layer_norm_check(dev) -> None:
    """The LN kernel is the one link with an fp32 variant: hold it tightly."""
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((SMOKE_BATCH * CFG.num_tokens, CFG.embed_dim), generator=gen,
                    device=dev) * 2
    w = torch.randn(CFG.embed_dim, generator=gen, device=dev) * 0.1 + 1
    b = torch.randn(CFG.embed_dim, generator=gen, device=dev) * 0.1
    err, within, *_ = max_err(layernorm.layer_norm(x, w, b, CFG.eps),
                             layernorm.layer_norm_reference(x, w, b, CFG.eps), F32_TOL)
    check(within, f"layer_norm fp32 in/out: max_abs_err {err:.3e} "
                  f"(tol rtol {F32_TOL[0]} atol {F32_TOL[1]})")


# Phase 2k: the LN kernel's compile-time forms at the stacks' and ViT-L's
# widths, with fp32 in (config, batch): ViT-Ti and ViT-S at the stacks' B
# = 16 and 256, ViT-L/16@384 at its training batches.
LN_WIDTH_ROWS = ((VIT_TINY_16_224, 16), (VIT_TINY_16_224, 256), (VIT_S_16_224, 16),
                 (VIT_S_16_224, 256), (LARGE_CFG, 8), (LARGE_CFG, 32))
DEVICE_TIME_ITERS = 20


def ln_width_rows(dev) -> list[dict]:
    """Phase 2k: ``layer_norm`` on the fp32 stream (the stack's LNs, the
    chain's LN2) with bf16 and fp32 out at LN_WIDTH_ROWS' widths and rows,
    against the plain version; yardstick ``F.layer_norm`` in fp32."""
    rows = []
    for cfg, batch in LN_WIDTH_ROWS:
        gen = torch.Generator(device=dev).manual_seed(batch)
        d = cfg.embed_dim
        x = torch.randn((batch, cfg.num_tokens, d), generator=gen, device=dev) * 0.5
        w = torch.randn(d, generator=gen, device=dev) * 0.02 + 1.0
        b = torch.randn(d, generator=gen, device=dev) * 0.02
        cases = [ln_case(f"layer_norm D={d} (fp32 in, {tag} out)", "layernorm", x, w, b,
                         out_dtype,
                         lambda: torch.nn.functional.layer_norm(x, (d,), w, b, cfg.eps),
                         eps=cfg.eps)
                 for tag, out_dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32))]
        rows += run_cases(cases, batch, f"{cfg.name} ")
    return rows


# Phase 2k: rows 5a and 6a's compile-time forms at the same widths (each
# config's D and MLP width H), and at ViT-H/14's and ViT-G/14's (H = 5120
# and 8192: four warps a row in fp32) at QUANT_WIDE_BATCH; the split's bf16 tail of
# QUANT_TAIL columns (64 of 192), as ViT-B's calibrated plan leaves.
QUANT_WIDE_BATCH = 8
QUANT_TAIL = 128


def quantize_width_rows(dev) -> list[dict]:
    """Phase 2k: ``quantize_rows`` on fp32 rows of D and H and bf16 rows of
    D (the context), and ``quantize_rows_split`` on fp32 rows of D and H,
    against their plain versions, bit for bit. Seeded rows at unit scale
    with every 97th column 30x (outlier channels)."""
    rows = []
    for cfg, batch in LN_WIDTH_ROWS + ((VIT_H_14_224, QUANT_WIDE_BATCH),
                                       (VIT_G_14_224, QUANT_WIDE_BATCH)):
        gen = torch.Generator(device=dev).manual_seed(batch + cfg.embed_dim)
        cases = []
        for k in (cfg.embed_dim, cfg.hidden_dim):
            x = torch.randn((batch * cfg.num_tokens, k), generator=gen, device=dev)
            x[:, ::97] *= 30.0
            cases.append(quantize_case(f"K={k}", x))
            if k == cfg.embed_dim:
                cases.append(quantize_case(f"K={k}", x.to(torch.bfloat16)))
            cases.append(split_case(f"K={k}", x, k - (64 if k == 192 else QUANT_TAIL)))
        rows += run_cases(cases, batch, f"{cfg.name} ")
    return rows


def ln_bwd_width_rows(dev) -> list[dict]:
    """Phase 2k: row 14b's forms at the stacks' widths (ViT-Ti and ViT-S at
    B = 16 and 256) and at ViT-H/14's and ViT-G/14's (QUANT_WIDE_BATCH)
    against the plain version, LN2 and LN1, and the same bits over two
    calls (ViT-L's width: phase 2f)."""
    rows = []
    for cfg, batch in LN_WIDTH_ROWS + ((VIT_H_14_224, QUANT_WIDE_BATCH),
                                       (VIT_G_14_224, QUANT_WIDE_BATCH)):
        if cfg is not LARGE_CFG:
            rows += ln_bwd_rows(cfg, batch, dev, library=False)
    return rows


def masked_width_rows(dev) -> list[dict]:
    """Phase 2k: row 6b's forms at the ViT-Ti, S, L, H and G contexts (each
    config's heads and default tail), bit for bit against the plain
    version."""
    rows = []
    for cfg, batch in LN_WIDTH_ROWS + ((VIT_H_14_224, QUANT_WIDE_BATCH),
                                       (VIT_G_14_224, QUANT_WIDE_BATCH)):
        gen = torch.Generator(device=dev).manual_seed(batch + cfg.embed_dim)
        case = masked_case(f"K={cfg.embed_dim} hd={cfg.head_dim}",
                           seeded_context(cfg, batch, gen, dev), cfg.num_heads,
                           cfg.head_dim, default_kh(cfg))
        rows += run_cases([case], batch, f"{cfg.name} ")
    return rows


# Phase 2k's ptxas reports: (source, whether a spill or an ignored
# setmaxnreg fails the run).
USAGE_SOURCES = (("quantize.cu", False), ("layernorm.cu", False),
                 ("attention_ring.cu", True), ("attention_single.cu", True),
                 ("probe_overlap.cu", True), ("gemm_f32.cu", True),
                 ("attention_bwd_f32.cu", True), ("attention_flash_f32.cu", True))


def resource_usages(sources) -> list:
    """``_build.resource_usage`` of each source, the nvcc runs all at once."""
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        return list(pool.map(_build.resource_usage, sources))


def print_resource_usage(source: str, kernels: list, no_spills: bool = False) -> None:
    """Phase 2k: each kernel of ``csrc/<source>`` (``kernels``, its
    ``_build.resource_usage``): its registers a thread and spills, as ptxas
    reports them for the build's flags (and its warnings), and the source's
    ``k*Regs = n`` setmaxnreg shares where it names them; with
    ``no_spills``, a check that no form spills and none has its setmaxnreg
    ignored (a warpgroup's share ptxas cannot fit spills, one it cannot
    determine is dropped with warning C7508)."""
    for k in kernels:
        print(f"  ptxas {source}: {k['name'][:110]}: {k['registers']} registers, "
              f"{k['spill_stores']} bytes spill stores, {k['spill_loads']} bytes spill "
              f"loads", flush=True)
        for warning in k["warnings"]:
            print(f"    {warning[:160]}", flush=True)
    shares = re.findall(r"\b(k\w*Regs) = (\d+)", (_build.CSRC_DIR / source).read_text())
    if shares:
        print(f"  {source} setmaxnreg shares (registers a thread): "
              f"{', '.join(f'{name} {n}' for name, n in shares)}", flush=True)
    if no_spills:
        spilled = [k["name"][:80] for k in kernels if k["spill_stores"] or k["spill_loads"]]
        check(bool(kernels) and not spilled,
              f"ptxas {source}: {len(kernels)} kernel forms, none spills "
              f"(spilled: {spilled or 'none'})")
        ignored = [k["name"][:80] for k in kernels
                   if any("setmaxnreg" in w for w in k["warnings"])]
        check(not ignored, f"ptxas {source}: no setmaxnreg ignored (ignored in: "
                           f"{ignored or 'none'})")


def reduction_device_times(dev) -> None:
    """Phase 2k: the device time of one call of each LN form (rows 2 and
    5d), of the LN backward at LN2 and LN1 (row 14b: its row kernel and the
    two column sums of its partial rows), of ``column_sum`` (row 14c), of
    the quantizes at the GELU'd hidden (rows 5a and 6a) and of the masked
    quantize at the context (row 6b) at ViT-B/16 B = 16, from a
    ``perf.device_kernel_table`` trace of the call alone (DEVICE_TIME_ITERS
    calls), beside the same trace of its library call where one computes
    the function (``F.layer_norm``, ``x.float().sum(0)``; none quantizes,
    and the LN backward's is autograd, which inference mode refuses) and
    the calls' CUDA-event times. Checks that the traced kernels are the
    port's and launched as often as the calls say."""
    gen = torch.Generator(device=dev).manual_seed(15)
    bf, f32 = torch.bfloat16, torch.float32
    d, m, eps = CFG.embed_dim, SMOKE_BATCH * CFG.num_tokens, CFG.eps
    w = torch.randn(d, generator=gen, device=dev) * 0.02 + 1.0
    b = torch.randn(d, generator=gen, device=dev) * 0.02
    F = torch.nn.functional
    cases = []
    for name, x_dtype, out_dtype in (("row 2 LN1 (bf16 in, bf16 out)", bf, bf),
                                     ("row 2 LN2 (fp32 in, bf16 out)", f32, bf),
                                     ("row 5d LN1 (bf16 in, fp32 out)", bf, f32),
                                     ("row 5d LN2 (fp32 in, fp32 out)", f32, f32)):
        x = (torch.randn((m, d), generator=gen, device=dev) * 0.5).to(x_dtype)
        wl, bl = (w.to(bf), b.to(bf)) if x_dtype == bf else (w, b)
        cases.append((name, x, "layernorm_kernel<", 1, 0,
                      functools.partial(layernorm.layer_norm, x, w, b, eps,
                                        out_dtype=out_dtype),
                      functools.partial(F.layer_norm, x, (d,), wl, bl, eps)))
    for name, shape, dtype in (("row 14c dqkv (fp32)", (m, 3 * d), f32),
                               ("row 14c dOut (bf16)", (m, d), bf),
                               ("row 14c LN partial rows (fp32)",
                                (layernorm.bwd_partial_rows(m, d), d), f32)):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        per_chunk = layernorm.column_sum_rows_per_chunk(shape[0], shape[1],
                                                        x.element_size())
        cases.append((f"{name} [{shape[0]}, {shape[1]}]", x, "column_sum_kernel<",
                      1 if per_chunk >= shape[0] else 2, 0,
                      functools.partial(layernorm.column_sum, x),
                      lambda x=x: x.float().sum(0)))
    k, mq = CFG.hidden_dim, CFG.hidden_dim - QUANT_TAIL
    hid = torch.randn((m, k), generator=gen, device=dev)
    cases += [("row 5a GELU'd hidden (fp32 in)", hid, "quantize_rows_kernel<", 1, 0,
               functools.partial(quantize.quantize_rows, hid), None),
              (f"row 6a GELU'd hidden (fp32 in, int8 [{mq}] + bf16 [{k - mq}] out)", hid,
               "quantize_rows_split_kernel<", 1, 0,
               functools.partial(quantize.quantize_rows_split, hid, mq, bf), None)]
    # Row 14b: the row kernel, then one column-sum launch for each of dw and
    # db (its partial rows are within the column sum's one pass).
    dy = torch.randn((m, d), generator=gen, device=dev) * 0.01
    for name, x_dtype, g_dtype, out_dtype in (
            ("row 14b LN2 (fp32 x2, + bf16 dOut, fp32 dx2)", f32, bf, f32),
            ("row 14b LN1 (bf16 x, + fp32 dx2, bf16 dx)", bf, f32, bf)):
        x = torch.randn((m, d), generator=gen, device=dev).to(x_dtype)
        g = (torch.randn((m, d), generator=gen, device=dev) * 0.01).to(g_dtype)
        cases.append((name, x, "layernorm_bwd_row_kernel<", 1, 2,
                      functools.partial(layernorm.layer_norm_bwd, x, dy, w, eps,
                                        residual=g, out_dtype=out_dtype), None))
    ctx = seeded_context(CFG, SMOKE_BATCH, gen, dev)
    nh, hd, kh = CFG.num_heads, CFG.head_dim, default_kh(CFG)
    cases.append((f"row 6b context (bf16 in, {nh} x {kh} tails out)", ctx,
                  "quantize_rows_masked_row_kernel<", 1, 0,
                  functools.partial(quantize.quantize_rows_masked, ctx, nh, hd, kh), None))
    out = []
    for name, x, kernel_name, launches, others, kernel, library in cases:
        def traced(fn):
            table = perf.device_kernel_table(lambda _x: fn(), (x,), iters=DEVICE_TIME_ITERS)
            return sum(s.total_ms for s in table) / DEVICE_TIME_ITERS, table

        dev_ms, table = traced(kernel)
        calls = sum(s.calls for s in table if kernel_name in s.name)
        check(calls == launches * DEVICE_TIME_ITERS
              and sum(s.calls for s in table) == (launches + others) * DEVICE_TIME_ITERS,
              f"B={SMOKE_BATCH} {name}: the trace holds {calls} launches of "
              f"{kernel_name!r} ({launches} a call) and {others} other launches a call")
        own_ms = sum(s.total_ms for s in table if kernel_name in s.name) / DEVICE_TIME_ITERS
        row = dict(name=name, device_ms=dev_ms, kernel_device_ms=own_ms, ms=time_ms(kernel))
        lib = "no library call"
        if library is not None:
            lib_dev_ms, lib_table = traced(library)
            row.update(library_device_ms=lib_dev_ms, library_ms=time_ms(library),
                       library_kernels=[s.name[:80] for s in lib_table])
            lib = (f"library {lib_dev_ms:.4f} ms ({lib_dev_ms / dev_ms:.2f}x the "
                   f"kernel's; {', '.join(row['library_kernels'])}), CUDA events "
                   f"{row['library_ms']:.4f} ms")
        out.append(row)
        own = f" ({kernel_name} {own_ms:.4f})" if others else ""
        print(f"  B={SMOKE_BATCH} {name}: device {dev_ms:.4f} ms a call{own}, CUDA events "
              f"{row['ms']:.4f} ms; {lib}", flush=True)
    print(json.dumps({"device_times": {"batch": SMOKE_BATCH, "iters": DEVICE_TIME_ITERS,
                                       "rows": out}}), flush=True)


def read_counts() -> dict:
    return {key: getattr(mod, attr) for key, (mod, attr) in COUNTERS.items()}


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def fp32_logits(params: dict, images: np.ndarray, dev, cfg=CFG) -> torch.Tensor:
    stacked = vit.stack_params(params, cfg, param_dtype=torch.float32, device=dev)
    out = []
    for start in range(0, len(images), SMOKE_BATCH):
        batch = torch.from_numpy(images[start:start + SMOKE_BATCH]).to(dev)
        out.append(vit.forward(batch, stacked, cfg, compute_dtype=torch.float32,
                               return_logits=True))
    return torch.cat(out)


def decisive_images(params: dict, dev, cfg=CFG, n: int = N_IMAGES,
                    pool_size: int | None = None) -> tuple:
    """``n`` seeded images on which the fp32 plain model's top-2 logits are
    at least MIN_LOGIT_GAP apart, drawn in order from a seeded pool of
    ``pool_size`` (4n by default), and that model's probabilities on them
    (the port's plain fp32 path: ``vit.forward`` in fp32)."""
    pool = fixtures.random_images(cfg, n=pool_size or 4 * n, seed=1)
    logits = fp32_logits(params, pool, dev, cfg)
    top2 = logits.topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    keep = np.flatnonzero(gaps >= MIN_LOGIT_GAP)[:n]
    print(f"  {cfg.name}: {int((gaps >= MIN_LOGIT_GAP).sum())} of {len(pool)} pool "
          f"images have a top-2 logit gap >= {MIN_LOGIT_GAP} (median gap "
          f"{float(np.median(gaps)):.4f})", flush=True)
    if len(keep) < n:
        raise RuntimeError(f"only {len(keep)} decisive images in the pool")
    probs = torch.softmax(logits[torch.from_numpy(keep).to(logits.device)], dim=-1)
    return pool[keep], probs.cpu().numpy()


@contextlib.contextmanager
def plain_chain(*names: str, module=fused_block):
    """The functions ``module.<name>`` (by default the per-layer chain,
    ``fused_block.fused_encoder_layer``) swapped for their plain versions."""
    names = names or ("fused_encoder_layer",)
    kernel_versions = [getattr(module, name) for name in names]
    for name in names:
        setattr(module, name, getattr(module, name + "_reference"))
    try:
        yield
    finally:
        for name, fn in zip(names, kernel_versions):
            setattr(module, name, fn)


@contextlib.contextmanager
def per_layer_chain():
    """The stack-class configs routed to the per-layer chain instead, for
    comparison (int8 weights ignore a forced ``encoder_block``, so the route
    is switched where ``models/vit.encoder`` chooses it)."""
    kernel_version = fused_block.supports_stack
    fused_block.supports_stack = lambda *_args, **_kw: False
    try:
        yield
    finally:
        fused_block.supports_stack = kernel_version


def adversarial_weights() -> dict:
    """Phase 3c's weights: seeded adversarial ViT-B/16 weights with the
    classifier head scaled by HEAD_SCALE."""
    params = fixtures.adversarial_params(CFG, seed=0)
    params["heads_head_weight"] = params["heads_head_weight"] * HEAD_SCALE
    return params


def make_workspace(ws: Path, dev, params: dict, cfg=CFG) -> tuple:
    """Weights, decisive images and the fp32 answer file in ``ws``, and a
    seeded calibration binary."""
    t0 = time.perf_counter()
    ws.mkdir(parents=True, exist_ok=True)
    binfmt.save_weights(ws / "Network", fixtures.params_to_positional(params, cfg),
                        cfg)
    binfmt.save_image_data(ws / "calib.bin",
                           fixtures.random_images(cfg, n=N_CALIB, seed=99))
    # The answer: the weights as the loader sees them (6-decimal rounded),
    # through the port's plain fp32 path on the card.
    rounded = {k: binfmt.round_6dp(v) for k, v in params.items()}
    with torch.inference_mode():
        images, ref_probs = decisive_images(rounded, dev, cfg)
    binfmt.save_image_data(ws / "input.bin", images)
    results.write_results(ws / "answer.txt", ref_probs)
    print(f"  workspace: {cfg.name} weights, {N_IMAGES} images, fp32 answer "
          f"file in {time.perf_counter() - t0:.1f} s", flush=True)
    return rounded, images, ref_probs


def run_cli(ws: Path, mode: str, ref_probs: np.ndarray, cfg=CFG,
            per_forward: dict | None = None, extra: tuple = (), tag: str = "",
            weights: str = "Network") -> tuple:
    """One main-path run through the CLI: the counts of exactly this run, the
    max abs error of its result file's probabilities, and what the CLI
    printed. The expected counts are ``per_forward`` launches for each of
    the run's forwards, by default PER_LAYER[mode] for each layer. ``extra``
    flags are added (the result file is then ``result_<mode><tag>.txt``);
    ``weights`` names the weight directory in ``ws``."""
    flags = list(MODES[mode]) + list(extra)
    if mode.endswith("_outlier"):
        flags += ["--calibrate", str(ws / "calib.bin")]
    argv = ["--input", str(ws / "input.bin"), "--weights", str(ws / weights),
            "--output", str(ws / f"result_{mode}{tag}.txt"),
            "--answer", str(ws / "answer.txt"), "--backend", "gpu",
            "--attention", "flash", "--config", cfg.name,
            "--batch-size", str(SMOKE_BATCH), *flags]
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    counts = read_counts()
    print("  " + out.getvalue().strip().replace("\n", "\n  "))
    check(rc == 0 and "Comparator: files match." in out.getvalue(),
          f"cli --config {cfg.name} --backend gpu --attention flash "
          f"{' '.join(flags)}: rc {rc}, comparator green")
    batches = -(-N_IMAGES // SMOKE_BATCH)
    if per_forward is None:
        per_forward = {key: n * cfg.depth for key, n in PER_LAYER[mode].items()}
    expected = {key: per_forward.get(key, 0) * batches for key in COUNTERS}
    check(counts == expected, f"launches on the {cfg.name} {mode} main path "
                              f"{counts}, expected {expected}")
    lines = [results.parse_result_line(line) for line in
             (ws / f"result_{mode}{tag}.txt").read_text().splitlines()]
    file_err = max(abs(p - float(ref_probs[i].max())) for i, (_, p) in
                   enumerate(lines))
    print(f"  {cfg.name} {mode}{tag}: result-file probabilities vs the fp32 answer: "
          f"max abs err {file_err:.3e}", flush=True)
    return counts, file_err, out.getvalue()


def main_path(ws: Path, dev, rounded, images, ref_probs) -> tuple:
    counts, file_err, _ = run_cli(ws, "bf16", ref_probs)
    engine = InferenceEngine(CFG, rounded, batch_size=SMOKE_BATCH,
                             attention_impl="flash", device=dev)
    probs = engine.run(images)
    prob_err = float(np.abs(probs - ref_probs).max())
    check(prob_err <= PROB_TOL and file_err <= PROB_TOL,
          f"bf16 flash probabilities vs fp32 plain: max abs err {prob_err:.3e} "
          f"(result file {file_err:.3e}), budget {PROB_TOL}")
    return counts, engine


def fp32_engine_run(engine, ws: Path, images, ref_probs, cfg, per_forward: dict,
                    what: str) -> dict:
    """One fp32 engine's run over the workspace's images: its launches (each
    of ``per_forward`` once a forward), its probabilities against the plain
    fp32 path's (the answer file's source) within F32_PROB_TOL, and its
    result file against the answer file (the comparator)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    probs = engine.run(images)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    forwards = -(-len(images) // engine.batch_size)
    expected = {key: per_forward.get(key, 0) * forwards for key in COUNTERS}
    check(counts == expected, f"{what}: launches of {forwards} forwards in {elapsed:.2f} s "
                              f"(host clock, the first forward included) {counts}, "
                              f"expected {expected}")
    err = float(np.abs(probs - ref_probs).max())
    print(f"  {what}: probabilities vs the plain fp32 path: max abs err {err:.3e} "
          f"(budget {F32_PROB_TOL})", flush=True)
    check(err <= F32_PROB_TOL, f"{what}: max abs probability error {err:.3e} <= "
                               f"{F32_PROB_TOL}")
    result = ws / f"result_fp32_{cfg.name}.txt"
    results.write_results(result, probs)
    mismatches = results.compare_result_files(result, ws / "answer.txt", verbose=False)
    check(mismatches == 0, f"{what}: comparator against the fp32 answer file: "
                           f"{mismatches} mismatches")
    return counts


def fp32_training(dev, cfg=CFG, batch: int = F32_TRAIN_BATCH,
                  per_layer: dict = F32_TRAIN_PER_LAYER) -> dict:
    """Phase 3i's training: ``Trainer(compute_dtype=torch.float32)`` on
    ``cfg`` in each of F32_ROUTES, F32_TRAIN_STEPS AdamW steps at ``batch``
    on a memorised batch (the loss falls; the launches of those steps,
    ``per_layer[route]`` a layer a step), then one step from
    ``random_params`` seed 1 against the plain links (phase 5's gates), its
    errors printed beside an earlier bf16 step check's of ``cfg`` and the
    route (phase 5c's at ViT-L/16@512)."""
    images, labels = train_batch(batch, seed=3, cfg=cfg)
    start = start_params(cfg, 1, dev)
    counts = {}
    for route in F32_ROUTES:
        logs = []
        tr = Trainer(cfg, device=dev, lr=TRAIN_LR, optimizer="adamw",
                     compute_dtype=torch.float32, attention_impl=route,
                     log_every=1, log_fn=logs.append, seed=0)
        batches = data.memory_dataset(images, labels, batch, epochs=None, seed=1)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        tr.fit(batches, steps=F32_TRAIN_STEPS)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts[route] = read_counts()
        losses = [float(line.split("loss ")[1].split(",")[0]) for line in logs]
        print(f"  {cfg.name} fp32 {route}: {F32_TRAIN_STEPS} steps at B={batch} in "
              f"{elapsed:.2f} s; losses {' '.join(f'{v:.4f}' for v in losses)}",
              flush=True)
        check(len(losses) == F32_TRAIN_STEPS and all(np.isfinite(losses))
              and losses[-1] < losses[0],
              f"{cfg.name} fp32 {route}: the loss falls over {F32_TRAIN_STEPS} steps "
              f"({losses[0]:.4f} -> {losses[-1]:.4f})")
        expected = {key: per_layer[route].get(key, 0) * cfg.depth * F32_TRAIN_STEPS
                    for key in COUNTERS}
        check(counts[route] == expected,
              f"{cfg.name} fp32 {route}: launches of {F32_TRAIN_STEPS} steps "
              f"{counts[route]}, expected {expected}")
        one_step_vs_plain(tr, f"{route} fp32", images, labels, start, cfg)
        fp32_errs = STEP_ERRORS[(cfg.name, f"{route} fp32")][-1]
        for bf16_errs in STEP_ERRORS.get((cfg.name, route), []):
            print(f"  {cfg.name} {route} step vs the plain links, (loss, mu, update "
                  f"where resolved, update anywhere): fp32 "
                  f"({', '.join(f'{e:.3e}' for e in fp32_errs)}) beside bf16 "
                  f"({', '.join(f'{e:.3e}' for e in bf16_errs)}); gates ({STEP_LOSS_REL}, "
                  f"{MU_REL}, {UPDATE_ATOL}, 2)", flush=True)
        del tr
        torch.cuda.empty_cache()
    del start
    torch.cuda.empty_cache()
    return counts


def fp32_main_path(ws: Path, dev, rounded, images, ref_probs, tmp: Path) -> tuple:
    """Phase 3i: fp32 compute on the card up to padded T = 1024. The fp32
    ViT-B/16 engine (``InferenceEngine(param_dtype=torch.float32,
    compute_dtype=torch.float32, attention_impl="flash")``: the per-layer
    chain on the fp32 GEMM and the fp32 slab attention) on phase 3's
    images, the fp32 ViT-Ti/16 stack on its own workspace (phase 3d's
    weights), each against the plain fp32 path; then fp32 training. Returns
    ({run: counts}, the ViT-B fp32 engine)."""
    counts = {}
    kw = dict(batch_size=SMOKE_BATCH, param_dtype=torch.float32,
              compute_dtype=torch.float32, attention_impl="flash", device=dev)
    engine = InferenceEngine(CFG, rounded, **kw)
    counts["vit_b"] = fp32_engine_run(
        engine, ws, images, ref_probs, CFG,
        {key: n * CFG.depth for key, n in F32_PER_LAYER.items()},
        f"{CFG.name} fp32 flash engine (per-layer chain)")
    tiny = VIT_TINY_16_224
    tiny_ws = tmp / f"{tiny.name}_fp32"
    tiny_rounded, tiny_images, tiny_ref = make_workspace(
        tiny_ws, dev, fixtures.random_params(tiny, seed=0), tiny)
    tiny_engine = InferenceEngine(tiny, tiny_rounded, **kw)
    counts["vit_ti"] = fp32_engine_run(
        tiny_engine, tiny_ws, tiny_images, tiny_ref, tiny,
        {"layernorm": 2 * tiny.depth, "linear_f32": 4 * tiny.depth,
         "attention_f32": tiny.depth, "fused_block_stack": 1},
        f"{tiny.name} fp32 flash engine (the stack)")
    del tiny_engine
    counts.update(fp32_training(dev))
    return counts, engine


def fp32_throughput(engine, rounded: dict, dev) -> None:
    """Phase 4's fp32 row: the fp32 flash engine's forward at
    F32_THROUGHPUT_BATCH beside the same forward on the xla route (plain
    PyTorch, cuBLAS fp32 with TF32 off)."""
    batch = F32_THROUGHPUT_BATCH
    gen = torch.Generator(device=dev).manual_seed(batch)
    images = torch.randn((batch, 3, CFG.img_size, CFG.img_size), generator=gen,
                         device=dev)
    xla = InferenceEngine(CFG, rounded, batch_size=batch, param_dtype=torch.float32,
                          compute_dtype=torch.float32, attention_impl="xla", device=dev)
    ms = time_ms(lambda: engine.forward(images), reps=5)
    ms_xla = time_ms(lambda: xla.forward(images), reps=5)
    print(f"throughput fp32 B={batch}: flash {batch / ms * 1e3:.1f} img/s ({ms:.3f} ms "
          f"per forward); xla {batch / ms_xla * 1e3:.1f} img/s ({ms_xla:.3f} ms); "
          f"flash/xla time {ms / ms_xla:.3f}x", flush=True)
    print(json.dumps({"throughput": {
        "mode": "fp32", "batch": batch, "img_per_s": batch / ms * 1e3, "forward_ms": ms,
        "xla_img_per_s": batch / ms_xla * 1e3, "xla_forward_ms": ms_xla}}), flush=True)
    del xla
    torch.cuda.empty_cache()


def long_inference_main_path(dev, tmp: Path, params: dict) -> dict:
    """Phase 3e: ``InferenceEngine(LONG_CFG, attention_impl="flash")`` in
    bf16 at LONG_BATCH, full depth and widths, on ``params``
    (``random_params`` seed 0) and LONG_IMAGES decisive images: the
    launches of that run, the probabilities within PROB_TOL of the port's
    plain fp32 path, and the comparator on the two result files. Returns
    the counts, the images, the fp32 path's and the engine's
    probabilities."""
    cfg = LONG_CFG
    t0 = time.perf_counter()
    with torch.inference_mode():
        images, ref_probs = decisive_images(params, dev, cfg, n=LONG_IMAGES,
                                            pool_size=LONG_POOL)
    engine = InferenceEngine(cfg, params, batch_size=LONG_BATCH,
                             attention_impl="flash", device=dev)
    print(f"  {cfg.name}: weights, {LONG_IMAGES} decisive images, the fp32 "
          f"answer and the engine in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    probs = engine.run(images)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    forwards = -(-LONG_IMAGES // LONG_BATCH)
    expected = {key: LONG_PER_LAYER.get(key, 0) * cfg.depth * forwards
                for key in COUNTERS}
    check(counts == expected, f"launches of the {cfg.name} flash run ({forwards} "
                              f"forwards in {elapsed:.2f} s) {counts}, expected {expected}")
    err = float(np.abs(probs - ref_probs).max())
    check(err <= PROB_TOL, f"{cfg.name} bf16 flash probabilities vs fp32 plain: "
                           f"max abs err {err:.3e}, budget {PROB_TOL}")
    results.write_results(tmp / "long_answer.txt", ref_probs)
    results.write_results(tmp / "long_result.txt", probs)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        errors = results.compare_result_files(tmp / "long_result.txt",
                                              tmp / "long_answer.txt")
    if out.getvalue().strip():
        print("  " + out.getvalue().strip().replace("\n", "\n  "))
    check(errors == 0, f"{cfg.name}: comparator on {LONG_IMAGES} images, "
                       f"{errors} mismatches")
    del engine
    torch.cuda.empty_cache()
    return counts, images, ref_probs, probs


def tuned_long_inference(dev, tmp: Path, params: dict, images: np.ndarray,
                         ref_probs: np.ndarray, smi_line: str) -> dict:
    """Phase 6d: ``perf.autotune.tune_and_save`` on LONG_CFG at LONG_BATCH,
    bf16, into a cache of its own (its table printed), then
    ``InferenceEngine(tuning_path=)`` on phase 3e's weights and decisive
    images: the winner bound (``engine.tuning``), its forwards launching
    the winner's instance of the blockwise forward and no other, the
    probabilities within PROB_TOL of the port's plain fp32 path, 0
    comparator mismatches. Then the same with an entry naming each other
    instance, so that every key tile runs on the main path. Returns each
    key tile's run's counts."""
    cfg = LONG_CFG
    path = tmp / "tuning.json"
    t0 = time.perf_counter()
    result = perf.autotune.tune_and_save(cfg, LONG_BATCH, dtype=torch.bfloat16,
                                         path=path, device=dev)
    table = result.get("blockwise_table_ms", {})
    print(f"  tune_and_save {cfg.name} B={LONG_BATCH} bf16 in "
          f"{time.perf_counter() - t0:.1f} s: blockwise_block_k "
          f"{result.get('blockwise_block_k')}, table (ms a forward's attention, "
          f"{LONG_BATCH} x {cfg.num_heads} heads) {table} (card: {smi_line})", flush=True)
    print(json.dumps({"autotune": result, "card": smi_line}), flush=True)
    winner = result.get("blockwise_block_k")
    check(winner in attention.FLASH_BLOCK_KS and len(table) == len(attention.FLASH_BLOCK_KS)
          and all(math.isfinite(v) for v in table.values()),
          f"tune_and_save {cfg.name}: every key tile measured, winner {winner}")
    if winner not in attention.FLASH_BLOCK_KS:
        return {}
    results.write_results(tmp / "tuned_answer.txt", ref_probs)
    forwards = -(-len(images) // LONG_BATCH)
    runs = {}
    for bk in [winner] + [b for b in attention.FLASH_BLOCK_KS if b != winner]:
        tuning = path
        if bk != winner:  # an entry naming this instance, as a sweep would write it
            tuning = tmp / f"tuning_{bk}.json"
            perf.autotune.save_tuning(
                tuning, perf.autotune.tuning_key(cfg, LONG_BATCH, torch.bfloat16),
                dict(result, blockwise_block_k=bk))
        engine = InferenceEngine(cfg, params, batch_size=LONG_BATCH, attention_impl="flash",
                                 device=dev, tuning_path=str(tuning))
        what = f"{cfg.name} engine tuned to block_k={bk}" + (" (the winner)"
                                                            if bk == winner else "")
        check(engine.tuning.get("blockwise_block_k") == bk,
              f"{what}: engine.tuning {engine.tuning.get('blockwise_block_k')}")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        probs = engine.run(images)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = runs[bk] = read_counts()
        per_layer = {**LONG_PER_LAYER, "attention_flash_k128": 0,
                     f"attention_flash_k{bk}": 1}
        expected = {key: per_layer.get(key, 0) * cfg.depth * forwards for key in COUNTERS}
        check(counts == expected, f"{what}: launches of {forwards} forwards in "
                                  f"{elapsed:.2f} s {counts}, expected {expected}")
        err = float(np.abs(probs - ref_probs).max())
        check(err <= PROB_TOL, f"{what}: probabilities vs fp32 plain: max abs err "
                               f"{err:.3e}, budget {PROB_TOL}")
        results.write_results(tmp / f"tuned_result_{bk}.txt", probs)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            errors = results.compare_result_files(tmp / f"tuned_result_{bk}.txt",
                                                  tmp / "tuned_answer.txt")
        if out.getvalue().strip():
            print("  " + out.getvalue().strip().replace("\n", "\n  "))
        check(errors == 0, f"{what}: comparator on {len(images)} images, {errors} "
                           f"mismatches")
        del engine
        torch.cuda.empty_cache()
    return runs


def int8_main_path(ws: Path, dev, rounded, images, ref_probs) -> tuple:
    # "auto" must resolve to W8A8 on ViT-B: its run's launch counts are the
    # W8A8 chain's (PER_LAYER).
    counts = {mode: run_cli(ws, mode, ref_probs)[0]
              for mode in ("w8a8", "int8", "auto")}
    engines = {mode: InferenceEngine(CFG, rounded, batch_size=SMOKE_BATCH,
                                     attention_impl="flash", device=dev,
                                     quantize=flag)
               for mode, flag in (("w8a8", "int8-w8a8"), ("int8", "int8"))}
    w8a8 = engines["w8a8"]
    w8a8_layout_cost(engines["int8"].params, w8a8)
    probs = w8a8.run(images)
    with plain_chain():
        plain_probs = w8a8.run(images)
    err = float(np.abs(probs - plain_probs).max())
    check(err <= PROB_TOL, f"W8A8 flash probabilities vs the plain W8A8 chain: "
                           f"max abs err {err:.3e}, budget {PROB_TOL}")
    # What the int8 modes move against fp32, in logits: the basis of
    # MIN_LOGIT_GAP.
    with torch.inference_mode():
        log_int8_logit_errors(engines, rounded, images, ref_probs, dev)
    return counts, engines


def w8a8_layout_cost(params: dict, engine: InferenceEngine) -> None:
    """Phase 3b: what the W8A8 engine's set-up pays to store the encoder's
    int8 weights K-major (``quant.w8a8_layout`` of the row-major int8
    ``params``, on the card): bytes copied and device time, beside the
    engine's whole set-up time; the copy holds every value."""
    keys = ("qkv_w", "out_w", "fc1_w", "fc2_w")
    nbytes = sum(params["layers"][key]["q"].numel() for key in keys)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    moved = quant.w8a8_layout(params)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(moved["layers"][k]["q"], params["layers"][k]["q"])
               and quant.is_k_major(moved["layers"][k]["q"]) for k in keys)
    print(f"  W8A8 set-up: the K-major copy of {nbytes} bytes of int8 encoder weights "
          f"{start.elapsed_time(end):.4f} ms on the card ({host_ms:.3f} ms host clock); "
          f"the W8A8 engine's whole set-up {engine.setup_time:.3f} s", flush=True)
    check(same, "W8A8 set-up: the K-major copy holds every value of the int8 weights")


def outlier_main_path(ws: Path, dev, rounded, images, ref_probs,
                      engine: InferenceEngine) -> dict:
    """Phase 3c. ``engine`` is the calibrated W8A8 engine of phase 2c, built
    from the same weights and calibration images as the CLI runs."""
    counts = {mode: run_cli(ws, mode, ref_probs)[0]
              for mode in ("w8a8_outlier", "auto_outlier")}
    probs = engine.run(images)
    with plain_chain():
        plain_probs = engine.run(images)
    err = float(np.abs(probs - plain_probs).max())
    check(err <= PROB_TOL, f"calibrated W8A8 flash probabilities vs its plain "
                           f"chain: max abs err {err:.3e}, budget {PROB_TOL}")
    print(f"  calibrated W8A8 vs the fp32 answer: max abs err "
          f"{float(np.abs(probs - ref_probs).max()):.3e} (kernels), "
          f"{float(np.abs(plain_probs - ref_probs).max()):.3e} (plain chain); "
          f"the comparator's bound is 0.01", flush=True)
    # What the calibration fixes (printed, not gated): plain per-token W8A8
    # on the same weights.
    uncalibrated = InferenceEngine(CFG, rounded, batch_size=SMOKE_BATCH,
                                   attention_impl="flash", device=dev,
                                   quantize="int8-w8a8")
    with torch.inference_mode():
        log_int8_logit_errors({"w8a8_outlier": engine,
                               "w8a8 uncalibrated": uncalibrated},
                              rounded, images, ref_probs, dev)
    return counts


@contextlib.contextmanager
def serving(engine):
    """``engine`` behind a ``serve.InferenceServer`` on a free port, served
    from a background thread; yields the port."""
    srv = serve.InferenceServer(engine, port=0, max_wait_ms=SERVE_WAIT_MS)
    srv.start_background()
    try:
        yield srv.address[1]
    finally:
        srv.shutdown()


def served(port: int, images: np.ndarray) -> list:
    """``images`` sent by SERVE_CLIENTS client threads as SERVE_PAYLOAD-image
    requests (thread t sends requests t, t + SERVE_CLIENTS, ...); the
    (label, prob) answers in image order."""
    chunks = [images[i:i + SERVE_PAYLOAD] for i in range(0, len(images), SERVE_PAYLOAD)]
    got = [None] * len(chunks)
    errors = []

    def client(t):
        try:
            for c in range(t, len(chunks), SERVE_CLIENTS):
                got[c] = serve.classify(chunks[c], port=port)
        except Exception as exc:  # reported on the main thread
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"serving clients failed or hung: {errors[:3]}")
    return [pair for chunk in got for pair in chunk]


def check_served(engine, port: int, images: np.ndarray, what: str,
                 ref: np.ndarray | None = None) -> list:
    """One served run of ``images`` (``served``) with the counts set to 0
    just before it and read just after: the W8A8 chain's launches for
    exactly the batches the server ran, each a forward on each of the
    engine's devices (the batcher's thread launches them); the answers
    against ``ref`` probabilities, by default ``engine.run`` on the same
    images: labels exact, probabilities within PROB_TOL. Returns the
    answers."""
    before = serve.stats(port=port)["batches_run"]
    answers, counts, secs = counted(lambda: served(port, images))
    batches = serve.stats(port=port)["batches_run"] - before
    forwards = batches * getattr(engine, "n_devices", 1)
    expect_only(counts, f"{what} ({len(images)} images in {batches} served batches, "
                        f"{secs:.2f} s)",
                **{key: n * CFG.depth * forwards for key, n in PER_LAYER["w8a8"].items()})
    probs = engine.run(images) if ref is None else ref
    err = max(abs(p - float(probs[i].max())) for i, (_, p) in enumerate(answers))
    check([label for label, _ in answers] == [int(p.argmax()) for p in probs]
          and err <= PROB_TOL,
          f"{what}: {len(answers)} answers, labels equal the reference's, "
          f"probabilities max abs err {err:.3e} (budget {PROB_TOL})")
    return answers


def serve_request(mode: str, batch: int, img_size: int) -> np.ndarray:
    """Phase 3g's rate request for an engine of ``batch``: batch /
    SERVE_CLIENTS seeded images, raw uint8 pixels or float32."""
    shape = (batch // SERVE_CLIENTS, 3, img_size, img_size)
    rng = np.random.default_rng(batch)
    return (rng.integers(0, 256, shape, np.uint8) if mode == "uint8"
            else rng.standard_normal(shape).astype(np.float32))


# Phase 3g's clients as a program of their own: one process loads each
# server in turn (argv: JSON [[port, mode, batch, img_size], ...]).
_REMOTE_LOAD = """
import json, sys
import chip_smoke
from vit_with_opencl_tpu_torch.scripts import soak_serve
for port, mode, batch, img_size in json.loads(sys.argv[1]):
    print(json.dumps(soak_serve.load(
        port, chip_smoke.serve_request(mode, batch, img_size), chip_smoke.SERVE_CLIENTS,
        chip_smoke.SERVE_RATE_SECONDS[batch], chip_smoke.SERVE_RATE_REQUESTS)), flush=True)
"""


def split_run(engine, spent: dict):
    """``engine.run`` for the one batch the batcher hands it (at most the
    engine's batch), each stage timed on the calling thread and added to
    ``spent``: padding to the engine's batch, the upload, the forward and the
    copy back, the card synchronised after the upload and the forward (the
    copy back waits for the forward in ``engine.run`` too)."""
    def run(images: np.ndarray) -> np.ndarray:
        marks = [time.perf_counter()]
        n = len(images)
        if n < engine.batch_size:
            images = np.concatenate([images, np.zeros(
                (engine.batch_size - n, *images.shape[1:]), images.dtype)])
        marks.append(time.perf_counter())
        x = torch.from_numpy(images).to(engine.device)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        probs = engine.forward(x)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        out = probs.cpu().numpy()[:n]
        marks.append(time.perf_counter())
        for stage, t0, t1 in zip(RUN_STAGES, marks, marks[1:]):
            spent[stage] += t1 - t0
        return out
    return run


def serve_rates(engines: dict, rounded: dict, dev, smi_line: str) -> None:
    """Phase 3g, printed and not gated: the B = 32 ``engines`` (mode, batch)
    and B = 256 engines set up here, each behind a server; SERVE_CLIENTS
    clients in a process of their own send ``serve_request``s to each in turn
    (``soak_serve.load``: SERVE_RATE_REQUESTS requests or the batch's
    SERVE_RATE_SECONDS): served img/s and request latency on the host clock;
    beside them the batcher's time in ``engine.run`` split into its stages
    (``split_run``), the forward alone on a batch already on the card (CUDA
    events) and ``np.stack`` of a full batch of request images alone."""
    t0 = time.perf_counter()
    engines = dict(engines)
    for mode in ("float32", "uint8"):
        for batch in SERVE_RATE_BATCHES:
            if (mode, batch) not in engines:
                engines[mode, batch] = InferenceEngine(
                    CFG, rounded, batch_size=batch, attention_impl="flash",
                    device=dev, quantize="auto", normalize_uint8=mode == "uint8")
                engines[mode, batch].warmup()  # before its server starts
    check(all(e.quantize == "int8-w8a8" for e in engines.values()),
          f"quantize='auto' on {CFG.name} serves W8A8 at every rate batch")
    print(f"  rate engines at B = {', '.join(map(str, SERVE_RATE_BATCHES[1:]))} set up "
          f"and warmed in {time.perf_counter() - t0:.1f} s", flush=True)
    forward_ms, stack_ms, spent = {}, {}, {}
    for key, engine in engines.items():
        requests = [serve_request(*key, CFG.img_size).copy() for _ in range(SERVE_CLIENTS)]
        views = [r[i] for r in requests for i in range(len(r))]
        stack_s = []
        for _ in range(3):
            t1 = time.perf_counter()
            np.stack(views)
            stack_s.append(time.perf_counter() - t1)
        stack_ms[key] = sorted(stack_s)[1] * 1e3
        on_card = torch.from_numpy(np.stack(views)).to(dev)
        forward_ms[key] = time_ms(lambda: engine.forward(on_card), reps=5)
        del on_card
        spent[key] = dict.fromkeys(RUN_STAGES, 0.0)
        run = split_run(engine, dict(spent[key]))
        check(np.array_equal(run(requests[0]), type(engine).run(engine, requests[0])),
              f"{key[0]} B={key[1]}: split_run's probabilities equal engine.run's "
              f"on one request")
        engine.run = split_run(engine, spent[key])  # the batcher's thread calls it
    try:
        with contextlib.ExitStack() as servers:
            ports = {key: servers.enter_context(serving(engine))
                     for key, engine in engines.items()}
            before = {key: serve.stats(port=port) for key, port in ports.items()}
            proc = subprocess.run(
                [sys.executable, "-c", _REMOTE_LOAD,
                 json.dumps([[port, *key, CFG.img_size] for key, port in ports.items()])],
                capture_output=True, text=True, timeout=300,
                cwd=Path(__file__).resolve().parent)
            check(proc.returncode == 0, f"phase 3g's client process: exit "
                                        f"{proc.returncode} {proc.stderr[-300:]}")
            windows = dict(zip(ports, map(json.loads,
                                          proc.stdout.strip().splitlines()[-len(ports):])))
            after = {key: serve.stats(port=port) for key, port in ports.items()}
    finally:
        for engine in engines.values():
            vars(engine).pop("run", None)
    rows = []
    for key, res in windows.items():
        mode, batch = key
        batches = max(1, after[key]["batches_run"] - before[key]["batches_run"])
        images = after[key]["images_served"] - before[key]["images_served"]
        busy = sum(spent[key].values())
        stages = " + ".join(f"{stage} {spent[key][stage] / batches * 1e3:.2f}"
                            for stage in RUN_STAGES)
        p99 = (f"p99 {res['p99_ms']:.2f} ms" if res["p99_ms"] is not None
               else f"p99 not printed ({res['requests']} < 100 requests)")
        print(f"  served {mode} W8A8 B={batch}, {SERVE_CLIENTS} clients (own "
              f"process) x {batch // SERVE_CLIENTS} images a request: "
              f"{res['img_per_s']:.1f} img/s, {res['requests']} requests in "
              f"{res['seconds']:.2f} s, latency p50 {res['p50_ms']:.2f} ms, {p99} "
              f"(max {res['max_ms']:.2f}); {batches} batches of "
              f"{images / batches:.1f} images on average; engine.run busy "
              f"{busy / res['seconds']:.3f} of the window, {busy / batches * 1e3:.2f} "
              f"ms a batch: {stages}; the forward alone {forward_ms[key]:.3f} ms; "
              f"np.stack of a full batch alone {stack_ms[key]:.2f} ms ({smi_line})",
              flush=True)
        rows.append(dict(res, mode=mode, batch=batch, batches=batches,
                         images_a_batch=images / batches,
                         run_busy_share=busy / res["seconds"],
                         run_ms_a_batch={stage: v / batches * 1e3
                                         for stage, v in spent[key].items()},
                         forward_ms=forward_ms[key], stack_ms=stack_ms[key]))
    check(all(after[key]["batch_errors"] == 0 for key in engines),
          f"served rates: no failed batch ({len(windows)} windows)")
    print(json.dumps({"serving": rows, "card": smi_line}), flush=True)


def serving_main_path(ws: Path, dev, rounded: dict, images: np.ndarray,
                      smi_line: str) -> None:
    """Phase 3g: ``serve.InferenceServer`` on W8A8 engines (``quantize=
    "auto"``) of phase 3's weights, float32 and uint8, one card and a
    virtual mesh; then ``serve_rates``."""
    t0 = time.perf_counter()
    engines = {}
    for mode in ("float32", "uint8"):
        engine = InferenceEngine(CFG, rounded, batch_size=SERVE_BATCH,
                                 attention_impl="flash", device=dev,
                                 quantize="auto", normalize_uint8=mode == "uint8")
        engine.warmup()  # on this thread, before any server starts
        engines[mode, SERVE_BATCH] = engine
    check(all(e.quantize == "int8-w8a8" for e in engines.values()),
          f"quantize='auto' on {CFG.name} serves W8A8")
    print(f"  {len(engines)} engines set up and warmed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    one = engines["float32", SERVE_BATCH]
    with serving(one) as port:
        answers = check_served(one, port, images, f"served float32 B={SERVE_BATCH}")
        (ws / "result_served.txt").write_text("".join(
            results.format_result_line(i, label, prob) + "\n"
            for i, (label, prob) in enumerate(answers)))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            errors = results.compare_result_files(ws / "result_served.txt",
                                                  ws / "result_auto.txt")
        check(errors == 0, f"served answers as a result file vs phase 3b's "
                           f"--quantize auto result file: {errors} mismatches "
                           f"{out.getvalue().strip()}")
        with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
            garbage = b"not an image binary"
            sock.sendall(struct.pack("<I", len(garbage)) + garbage)
            reply = serve._recv_msg(sock).decode()
        try:
            serve.classify(np.zeros((1, 3, 16, 16), np.float32), port=port)
            wrong = "an answer"
        except RuntimeError as exc:
            wrong = str(exc)
        again = serve.classify(images[:2], port=port)
        stats = serve.stats(port=port)
        check(reply.startswith("ERROR:") and wrong.startswith("ERROR: expected images")
              and again == answers[:2],
              f"a garbage request ({reply!r}) and a wrong-shape one ({wrong!r}) get "
              f"ERROR lines; the next request is answered as before")
        check(stats["images_served"] == len(images) + 2 and stats["batch_errors"] == 0
              and stats["n_devices"] == 1,
              f"STATS counts what was served: {stats}")
    u8 = engines["uint8", SERVE_BATCH]
    raw = np.random.default_rng(7).integers(
        0, 256, (N_IMAGES, 3, CFG.img_size, CFG.img_size), np.uint8)
    with serving(u8) as port:
        check_served(u8, port, raw, f"served uint8 B={SERVE_BATCH}")
    dp = DataParallelEngine(CFG, rounded, batch_size=SERVE_BATCH,
                            devices=[dev] * SERVE_SHARDS, attention_impl="flash",
                            quantize="auto")
    dp.warmup()
    with serving(dp) as port:
        check_served(dp, port, images, f"served DataParallelEngine ({SERVE_SHARDS}, 1) "
                                       f"float32 B={SERVE_BATCH} vs the one-card engine",
                     ref=one.run(images))
        check(serve.stats(port=port)["n_devices"] == SERVE_SHARDS,
              f"STATS of the DP server: n_devices {SERVE_SHARDS}")
    del dp
    serve_rates(engines, rounded, dev, smi_line)
    del engines, one, u8
    torch.cuda.empty_cache()


def input_side_main_path(ws: Path, dev, rounded: dict, ref_probs: np.ndarray) -> None:
    """Phase 3h: the CLI's io layers, ``--raw-images`` and the checkpoint
    converter on the card."""
    runs = {}
    for tag, extra in (("_libvitio", ()), ("_numpy", ("--pure-python",))):
        counts, _err, text = run_cli(ws, "auto", ref_probs, extra=extra, tag=tag)
        io_line = "(numpy io)" if extra else "(libvitio io)"
        check(io_line in text, f"cli {' '.join(extra) or '(default)'} loads with "
                               f"{io_line}")
        runs[tag] = (ws / f"result_auto{tag}.txt").read_bytes()
    check(runs["_libvitio"] == runs["_numpy"] == (ws / "result_auto.txt").read_bytes(),
          "libvitio and --pure-python: byte-identical result files (and phase "
          "3b's --quantize auto file)")
    try:
        import PIL  # noqa: F401  (decoding --raw-images needs it)
        have_pil = True
    except ImportError:
        have_pil = False
    print(f"  PIL {'imports: --raw-images runs' if have_pil else 'is absent: --raw-images is not run'}",
          flush=True)
    if have_pil:
        from PIL import Image

        rng = np.random.default_rng(11)
        pngs = []
        for i, shape in enumerate(RAW_IMAGE_SHAPES):
            pngs.append(ws / f"raw{i}.png")
            Image.fromarray(rng.integers(0, 256, shape, np.uint8)).save(pngs[-1])
        preprocess.images_to_input_bin(pngs, ws / "raw.bin", CFG.img_size,
                                       round(CFG.img_size * 256 / 224))
        common = ["--weights", str(ws / "Network"), "--backend", "gpu",
                  "--attention", "flash", "--config", CFG.name, "--batch-size",
                  str(SMOKE_BATCH), "--quantize", "auto"]
        outs = {}
        for tag, source in (("raw", ["--raw-images", *map(str, pngs)]),
                            ("bin", ["--input", str(ws / "raw.bin")])):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                result = counted(lambda: cli.main(
                    [*source, "--output", str(ws / f"result_{tag}.txt"), *common]))
            print("  " + out.getvalue().strip().replace("\n", "\n  "), flush=True)
            outs[tag] = result
        rc, counts, secs = outs["raw"]
        expect_only(counts, f"cli --raw-images ({len(pngs)} PNGs, one forward, "
                            f"{secs:.2f} s)",
                    **{key: n * CFG.depth for key, n in PER_LAYER["w8a8"].items()})
        raw_text = (ws / "result_raw.txt").read_bytes()
        check(rc == 0 and outs["bin"][0] == 0 and raw_text.count(b"\n") == len(pngs)
              and raw_text == (ws / "result_bin.txt").read_bytes(),
              "cli --raw-images and cli on images_to_input_bin's file of the same "
              "PNGs: byte-identical result files")
    t0 = time.perf_counter()
    state = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in export.to_torchvision_state_dict(rounded, CFG).items()}
    torch.save(state, ws / "vit_b_16.pth")
    del state
    proc = subprocess.run(
        [sys.executable, "-m", "vit_with_opencl_tpu_torch.io.export", "--config",
         CFG.name, "--out", str(ws / "Exported"), "--from-pth",
         str(ws / "vit_b_16.pth")], capture_output=True, text=True, timeout=300,
        cwd=Path(__file__).resolve().parent)
    print(f"  {proc.stdout.strip()} (torch.save and export in "
          f"{time.perf_counter() - t0:.1f} s) {proc.stderr.strip()[-500:]}", flush=True)
    check(proc.returncode == 0, "python -m vit_with_opencl_tpu_torch.io.export "
                                "--from-pth: exit 0")
    run_cli(ws, "bf16", ref_probs, tag="_exported", weights="Exported")


def stack_per_forward(cfg, mode: str) -> dict:
    """Launches of one forward through the stack: per layer LN1, qkv,
    attention, out-proj, LN2, fc1 and fc2, and one stack call."""
    depth = cfg.depth
    suffix = "_int8w" if mode == "int8" else ""
    return {"layernorm": 2 * depth, "attention": depth,
            ("linear_int8w" if mode == "int8" else "linear"): 4 * depth,
            "fused_block_stack" + suffix: 1}


def small_main_path(ws: Path, dev, cfg) -> tuple:
    """Phase 3d for one stack-class config: the CLI runs and their counts,
    and the bf16 and int8-weight engines held to their plain stacks."""
    rounded, images, ref_probs = make_workspace(
        ws, dev, fixtures.random_params(cfg, seed=0), cfg)
    counts = {mode: run_cli(ws, mode, ref_probs, cfg, stack_per_forward(cfg, mode))[0]
              for mode in ("bf16", "auto", "int8")}
    forwards = -(-N_IMAGES // SMOKE_BATCH)
    check(counts["bf16"]["fused_block_stack"] == forwards
          and counts["int8"]["fused_block_stack_int8w"] == forwards
          and not any(c["fused_block"] or c["fused_block_int8w"] for c in counts.values()),
          f"{cfg.name}: one stack call per forward ({forwards}), no per-layer chain")
    if cfg.name == VIT_S_16_224.name:
        # W8A8 stays per-layer on the stack-class configs, as in JAX.
        counts["w8a8"] = run_cli(ws, "w8a8", ref_probs, cfg)[0]
    engines = {mode: InferenceEngine(cfg, rounded, batch_size=SMOKE_BATCH,
                                     attention_impl="flash", device=dev,
                                     quantize=flag)
               for mode, flag in (("bf16", None), ("int8", "int8"))}
    for mode, engine in engines.items():
        probs = engine.run(images)
        with plain_chain("fused_encoder_stack"):
            plain_probs = engine.run(images)
        err = float(np.abs(probs - plain_probs).max())
        check(err <= PROB_TOL, f"{cfg.name} {mode} stack probabilities vs the plain "
                               f"stack: max abs err {err:.3e}, budget {PROB_TOL}")
        print(f"  {cfg.name} {mode}: probabilities vs the fp32 answer: max abs err "
              f"{float(np.abs(probs - ref_probs).max()):.3e} (kernels), "
              f"{float(np.abs(plain_probs - ref_probs).max()):.3e} (plain stack)",
              flush=True)
    return counts, engines


def small_throughput(cfg, engines: dict, dev) -> None:
    """Phase 4 for one stack-class config: img/s of the stack engines beside
    the same engines on the per-layer chain; the stack rows at B = 256."""
    for batch in THROUGHPUT_BATCHES:
        gen = torch.Generator(device=dev).manual_seed(batch)
        images = torch.randn((batch, 3, cfg.img_size, cfg.img_size),
                             generator=gen, device=dev)
        if batch == THROUGHPUT_BATCHES[-1]:
            stack_kernel_rows(cfg, batch, dev, seed=batch)
        for mode, engine in engines.items():
            ms = time_ms(lambda: engine.forward(images), reps=10)
            with per_layer_chain():
                ms_layer = time_ms(lambda: engine.forward(images), reps=10)
            print(f"throughput {cfg.name} {mode} B={batch}: stack {batch / ms * 1e3:.1f} "
                  f"img/s ({ms:.3f} ms per forward); per-layer chain "
                  f"{batch / ms_layer * 1e3:.1f} img/s ({ms_layer:.3f} ms); "
                  f"stack/chain {ms_layer / ms:.3f}x", flush=True)
            print(json.dumps({"throughput": {
                "config": cfg.name, "mode": mode, "batch": batch,
                "img_per_s": batch / ms * 1e3, "forward_ms": ms,
                "per_layer_img_per_s": batch / ms_layer * 1e3,
                "per_layer_forward_ms": ms_layer}}), flush=True)


def log_int8_logit_errors(engines, rounded, images, ref_probs, dev) -> None:
    ref_logits = fp32_logits(rounded, images, dev)
    top2 = ref_logits.topk(2, dim=-1).values
    for mode, engine in engines.items():
        logits = torch.cat([
            vit.forward(torch.from_numpy(images[s:s + SMOKE_BATCH]).to(dev),
                        engine.params, CFG, kernels=engine.kernels,
                        return_logits=True)
            for s in range(0, N_IMAGES, SMOKE_BATCH)])
        flips = int((logits.argmax(-1) != ref_logits.argmax(-1)).sum())
        print(f"  {mode}: logits vs fp32 max abs err "
              f"{float((logits - ref_logits).abs().max()):.4e}; probabilities "
              f"vs the fp32 answer {float(np.abs(engine.run(images) - ref_probs).max()):.3e}; "
              f"top-1 flips {flips} of {N_IMAGES}; smallest fp32 top-2 gap "
              f"{float((top2[:, 0] - top2[:, 1]).min()):.4f}", flush=True)


def throughput(engines: dict, dev) -> dict:
    """The engines' forwards at THROUGHPUT_BATCHES beside their kernels' rows:
    ms per forward by (mode, batch)."""
    forward_ms = {}
    for batch in THROUGHPUT_BATCHES:
        gen = torch.Generator(device=dev).manual_seed(batch)
        images = torch.randn((batch, 3, CFG.img_size, CFG.img_size),
                             generator=gen, device=dev)
        rows = kernel_rows(batch, dev, seed=batch)
        int8_rows = int8_kernel_rows(batch, dev, seed=batch)
        outlier_rows = outlier_kernel_rows(batch, dev,
                                           engines["w8a8_outlier"].params,
                                           seed=batch)
        attn = [r for r in rows if r["counter"] == "attention"]
        w8a8_ln = [r for r in int8_rows if r["counter"] == "layernorm"]
        layer_rows = {
            "bf16": [r for r in rows if r["counter"] != "fused_block"],
            "w8a8": attn + [r for r in int8_rows if r["counter"] in
                            ("layernorm", "quantize", "linear_w8a8")],
            "int8": [r for r in rows if r["counter"] in ("layernorm", "attention")]
                    + [r for r in int8_rows if r["counter"] == "linear_int8w"],
            "w8a8_outlier": attn + w8a8_ln + outlier_rows[:-1],
        }
        chains = {"bf16": rows[-1], "w8a8": int8_rows[-2], "int8": int8_rows[-1],
                  "w8a8_outlier": outlier_rows[-1]}
        for mode, engine in engines.items():
            engine.forward(images)  # warm-up
            ms = time_ms(lambda: engine.forward(images), reps=10)
            forward_ms[mode, batch] = ms
            per_layer = sum(r["ms"] for r in layer_rows[mode])
            bound_layer = sum(r["bound_ms"] for r in layer_rows[mode])
            print(f"throughput {mode} B={batch}: {batch / ms * 1e3:.1f} img/s "
                  f"({ms:.3f} ms per forward); kernels {CFG.depth} x "
                  f"{per_layer:.3f} ms = {CFG.depth * per_layer:.3f} ms; chain "
                  f"{CFG.depth} x {chains[mode]['ms']:.3f} ms; kernel bounds "
                  f"{CFG.depth} x {bound_layer:.3f} ms = "
                  f"{CFG.depth * bound_layer:.3f} ms", flush=True)
            print(json.dumps({"throughput": {
                "mode": mode, "batch": batch, "img_per_s": batch / ms * 1e3,
                "forward_ms": ms,
                "kernels": [{k: r[k] for k in ("name", "ms", "plain_ms",
                                               "library_ms", "bound_ms",
                                               "bound_by", "max_abs_err", "same")}
                            for r in layer_rows[mode] + [chains[mode]]]}}),
                  flush=True)
    return forward_ms


def public_layer(x, lp, cfg, fns) -> tuple:
    """One pre-norm encoder layer and the classifier head as a user of the
    kernel layer composes its public ops (``fns``: the ops or their plain
    versions): LN1, the qkv GEMM, ``flash_attention`` on the permuted views
    of its output, the out-proj GEMM, ``residual_layer_norm`` (LN2 and the
    residual sum), fc1 with GELU, fc2 with the residual, the head GEMM on the
    CLS row and ``softmax``. Returns (the layer's output, probabilities)."""
    b, t, d = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    h1 = fns["layer_norm"](x, lp["ln1_w"], lp["ln1_b"], cfg.eps)
    qkv = fns["fused_linear"](h1, lp["qkv_w"], lp["qkv_b"])
    q, k, v = qkv.reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
    ctx = fns["flash_attention"](q, k, v, cfg).permute(0, 2, 1, 3).reshape(b, t, d)
    a = fns["fused_linear"](ctx, lp["out_w"], lp["out_b"])
    h2, x1 = fns["residual_layer_norm"](a, x, lp["ln2_w"], lp["ln2_b"], cfg.eps)
    hid = fns["fused_linear"](h2, lp["fc1_w"], lp["fc1_b"], fuse_gelu=True)
    y = fns["fused_linear"](hid, lp["fc2_w"], lp["fc2_b"], residual=x1)
    logits = fns["fused_linear"](y[:, 0].contiguous(), lp["head_w"], lp["head_b"],
                                 out_dtype=torch.float32)
    return y, fns["softmax"](logits)


PUBLIC_OPS = {"layer_norm": ops.layer_norm, "fused_linear": ops.fused_linear,
              "flash_attention": ops.flash_attention,
              "residual_layer_norm": ops.residual_layer_norm, "softmax": ops.softmax}
PLAIN_OPS = {"layer_norm": layernorm.layer_norm_reference,
             "fused_linear": linear.fused_linear_reference,
             "flash_attention": attention.flash_attention_reference,
             "residual_layer_norm": layernorm.residual_layer_norm_reference,
             "softmax": ops.softmax}


def public_ops_main_path(dev) -> dict:
    """Phase 6a: the kernel layer's public ops driven as a user calls them,
    at ViT-B/16's full width (one layer and the head at B = 16, seeded
    weights) and ``flash_attention`` at ViT-L/16@512's T = 1025 (B = 4),
    in bf16 and in fp32: the launches of that run, the layer and its
    probabilities against the same composition of the plain versions."""
    gen = torch.Generator(device=dev).manual_seed(6)
    lp = layer_params(gen, dev)
    lp["head_w"] = (torch.randn((CFG.embed_dim, CFG.num_classes), generator=gen,
                                device=dev) * 0.02).to(torch.bfloat16)
    lp["head_b"] = torch.zeros(CFG.num_classes, device=dev)
    x = (torch.randn((SMOKE_BATCH, CFG.num_tokens, CFG.embed_dim), generator=gen,
                     device=dev) * 0.5).to(torch.bfloat16)
    long_cfg = heads_cfg(LONG_CFG.num_heads, LONG_CFG.head_dim)
    q, k, v = (torch.randn((4, LONG_CFG.num_heads, LONG_CFG.num_tokens,
                            LONG_CFG.head_dim), generator=gen, device=dev
                           ).to(torch.bfloat16) for _ in range(3))
    q32, k32, v32 = (z.float() for z in (q, k, v))
    reset_counts()
    y, probs = public_layer(x, lp, CFG, PUBLIC_OPS)
    long_ctx = ops.flash_attention(q, k, v, long_cfg)
    long_ctx32 = ops.flash_attention(q32, k32, v32, long_cfg)
    torch.cuda.synchronize()
    counts = read_counts()
    expected = {key: PUBLIC_PATH_COUNTS.get(key, 0) for key in COUNTERS}
    check(counts == expected, f"launches of the public ops' run {counts}, "
                              f"expected {expected}")
    y_ref, probs_ref = public_layer(x, lp, CFG, PLAIN_OPS)
    err, within, same, _ = max_err(y, y_ref, BF16_TOL)
    check(within and same >= MIN_SAME_CHAIN,
          f"the public ops' ViT-B layer vs the same plain composition: max abs err "
          f"{err:.3e}, {same:.2%} bit-identical (>= {MIN_SAME_CHAIN})")
    prob_err = float((probs - probs_ref).abs().max())
    check(bool(torch.isfinite(probs).all()) and prob_err <= PROB_TOL,
          f"the public ops' probabilities vs the plain composition's: max abs err "
          f"{prob_err:.3e}, budget {PROB_TOL}")
    err, within, same, _ = max_err(
        long_ctx, attention.flash_attention_reference(q, k, v, long_cfg), BF16_TOL)
    check(within and same >= MIN_SAME_KERNEL,
          f"flash_attention at T = {LONG_CFG.num_tokens} vs its plain version: max "
          f"abs err {err:.3e}, {same:.2%} bit-identical")
    err, within, _, _ = max_err(
        long_ctx32, attention.flash_attention_reference(q32, k32, v32, long_cfg), F32_TOL)
    check(within, f"flash_attention in fp32 at T = {LONG_CFG.num_tokens} vs its plain "
                  f"version: max abs err {err:.3e} (tol {F32_TOL})")
    return counts


def profile_main_path(engine, dev) -> dict:
    """Phase 6b: ``perf.profile_ops`` at ViT-B/16, bf16, ``flash``, B =
    PROFILE_BATCH on the phase-3 engine's weights: the table, JAX's stage
    names, and the launches of the run (the generic slot's one
    ``flash_attention`` call on the permuted qkv views before timing)."""
    gen = torch.Generator(device=dev).manual_seed(PROFILE_BATCH)
    images = torch.randn((PROFILE_BATCH, 3, CFG.img_size, CFG.img_size),
                         generator=gen, device=dev)
    reset_counts()
    stages = perf.profile_ops(CFG, engine.params, images,
                              compute_dtype=torch.bfloat16, attention_impl="flash")
    torch.cuda.synchronize()
    counts = read_counts()
    print("  " + perf.format_profile(stages, PROFILE_BATCH).replace("\n", "\n  "),
          flush=True)
    names = [s.name for s in stages]
    check(names == PROFILE_STAGES, f"profile_ops stages {names}")
    check(counts["attention_single"] == 1,
          f"profile_ops: the single-pass kernel launched "
          f"{counts['attention_single']} time(s), expected 1 (the generic slot)")
    return counts


# Phase 6c: substitution attribution. The stand-ins against their plain
# versions at these batches; attribute_forward (through
# scripts/probe_tiny_bound, as a user runs it) at ATTR_BATCH, ATTR_RUNS times
# a forward so that the spread shows beside the shares; probe_midsize's
# routes on ViT-S/16.
ATTR_BATCH = 256
ATTR_RUNS = 3
ATTR_ITERS = 10
ATTR_STAND_IN_BATCHES = (SMOKE_BATCH, ATTR_BATCH)
ATTR_FORWARDS = (("ViT-B/16 bf16", "vit_b_16_224", None),
                 ("ViT-B/16 W8A8", "vit_b_16_224", "int8-w8a8"),
                 ("ViT-Ti/16 stack bf16", "vit_tiny_16_224", None))
ATTR_SHARES = ("gelu_share", "softmax_share", "quantize_share", "vpu_share")
MIDSIZE_ARGS = ["vit_s_16_224", str(ATTR_BATCH), "5", "perop,fused,stack,group2"]
SUBSTITUTIONS = ((True, False, False), (False, True, False), (True, True, False))
SUBSTITUTIONS_W8A8 = SUBSTITUTIONS + ((False, False, True), (True, True, True))


def stand_in_rows(batch: int, dev) -> list[dict]:
    """Phase 6c (a): row 4's constant-scale form on a seeded ViT-B/16 qkv,
    rows 5a's and 6a's cheap forms at the W8A8 and calibrated chains'
    ViT-B/16 sites (seeded inputs at 4x unit scale: codes across a few
    tens), each under its substitution against its plain version (JAX's
    stand-in). Their bytes are the real rows'; the quantizes' operations one
    convert a value."""
    gen = torch.Generator(device=dev).manual_seed(batch + 6)
    nh, hd, t, d, h = (CFG.num_heads, CFG.head_dim, CFG.num_tokens, CFG.embed_dim,
                       CFG.hidden_dim)
    bf, f32 = torch.bfloat16, torch.float32
    qkv = torch.randn((batch, t, 3 * d), generator=gen, device=dev).to(bf)
    attn = dict(attn_fwd_case(qkv, nh, hd), library=None,
                name="packed_fused_attention constant-scale stand-in (softmax_identity, "
                     "bf16)")
    with perf.kernel_substitutions(False, True):
        rows = run_cases([attn], batch)

    def rnd(k, dtype):
        return (torch.randn((batch, t, k), generator=gen, device=dev) * 4.0).to(dtype)

    cases = [dict(quantize_case(site, inp), ops={"fp32": inp.numel()},
                  name=f"quantize_rows cheap stand-in (quant_cheap) {site} "
                       f"({'bf16' if inp.dtype == bf else 'fp32'} in)")
             for site, inp in (("LN1", rnd(d, f32)), ("context", rnd(d, bf)),
                               ("GELU'd hidden", rnd(h, f32)))]
    cases += [dict(split_case(site, inp, mq), ops={"fp32": inp.numel()},
                   name=f"quantize_rows_split cheap stand-in (quant_cheap) {site} "
                        f"(fp32 in, int8 [{mq}] + bf16 [{inp.shape[-1] - mq}] out)")
              for site, inp, mq in (("LN1", rnd(d, f32), 640),
                                    ("GELU'd hidden", rnd(h, f32), h - 128))]
    with perf.kernel_substitutions(False, False, True):
        rows += run_cases(cases, batch)
    return rows


def substituted_counts(what: str, forward, images, combos) -> dict:
    """Phase 6c (c) and (d): the launches of one real forward and of the
    same forward under each substitution (every counter equal: the same GEMM,
    attention and quantize launches, the stand-ins counted as their real
    kernels), and the real forward's bits after them as before. Returns
    {combo: counts}, the real forward's under (False, False, False)."""
    reset_counts()
    before = forward(images)
    torch.cuda.synchronize()
    counts = {(False, False, False): read_counts()}
    for combo in combos:
        with perf.kernel_substitutions(*combo):
            reset_counts()
            out = forward(images)
            torch.cuda.synchronize()
            counts[combo] = read_counts()
        check(out.shape == before.shape and bool(torch.isfinite(out).all()),
              f"{what} under {combo}: finite {tuple(out.shape)}")
    real = counts[(False, False, False)]
    shown = {k: v for k, v in real.items() if v}
    print(f"  {what}: real forward's launches {shown}", flush=True)
    for combo in combos:
        check(counts[combo] == real,
              f"{what} under (gelu_identity, softmax_identity, quant_cheap) = {combo}: "
              f"the same launches as the real forward "
              f"({ {k: v for k, v in counts[combo].items() if v} })")
    check(torch.equal(forward(images), before),
          f"{what}: the real forward after the substitutions gives the bits it gave "
          f"before them")
    return counts


def attribution_phase(dev, engines: dict, tiny_engine, smi_line: str) -> tuple:
    """Phase 6c: (a) the stand-ins against their plain versions; (b)
    ``attribute_forward`` through ``scripts/probe_tiny_bound`` on ViT-B/16
    bf16 and W8A8 and the ViT-Ti/16 stack at B = ATTR_BATCH, ATTR_RUNS runs
    each, every run printed; (c, d) the launch counts of real and
    substituted forwards of the main path's engines and the restore; (e)
    the re-entry guard; (f) ``scripts/probe_midsize`` on ViT-S/16. Returns
    (the stand-in rows at ATTR_BATCH, the launches of the substituted
    forwards that drive each)."""
    rows = {batch: stand_in_rows(batch, dev) for batch in ATTR_STAND_IN_BATCHES}

    results = {}
    for label, name, quant_mode in ATTR_FORWARDS:
        results[label] = []
        for run in range(ATTR_RUNS):
            print(f"  {label} B={ATTR_BATCH}, run {run + 1} of {ATTR_RUNS} "
                  f"(scripts/probe_tiny_bound {ATTR_BATCH} {ATTR_ITERS} {name}"
                  f"{' ' + quant_mode if quant_mode else ''}; card: {smi_line}):",
                  flush=True)
            a = probe_tiny_bound.main([str(ATTR_BATCH), str(ATTR_ITERS), name]
                                      + ([quant_mode] if quant_mode else []))
            results[label].append(a)
            check(all(0.0 <= a[k] <= 1.0 for k in ATTR_SHARES if k in a)
                  and a["gemm_skeleton_ms"] > 0,
                  f"{label}: attribution shares in [0, 1]")
        for key in ("total_ms", "gemm_skeleton_ms") + ATTR_SHARES:
            if key in results[label][0]:
                vals = [r[key] for r in results[label]]
                print(f"  {label} {key}: runs {', '.join(f'{v:.4f}' for v in vals)}; "
                      f"median {float(np.median(vals)):.4f}, spread "
                      f"{max(vals) - min(vals):.4f}", flush=True)
    print(json.dumps({"attribution": results, "batch": ATTR_BATCH,
                      "iters": ATTR_ITERS, "card": smi_line}), flush=True)

    gen = torch.Generator(device=dev).manual_seed(61)
    images = torch.randn((SMOKE_BATCH, 3, CFG.img_size, CFG.img_size), generator=gen,
                         device=dev)
    tiny = VIT_TINY_16_224
    tiny_images = torch.randn((SMOKE_BATCH, 3, tiny.img_size, tiny.img_size),
                              generator=gen, device=dev)
    counts = {
        "bf16": substituted_counts(f"{CFG.name} bf16", engines["bf16"].forward, images,
                                   SUBSTITUTIONS),
        "w8a8": substituted_counts(f"{CFG.name} W8A8", engines["w8a8"].forward, images,
                                   SUBSTITUTIONS_W8A8),
        "w8a8_outlier": substituted_counts(f"{CFG.name} calibrated W8A8",
                                           engines["w8a8_outlier"].forward, images,
                                           SUBSTITUTIONS_W8A8),
        "tiny": substituted_counts(f"{tiny.name} bf16 stack", tiny_engine.forward,
                                   tiny_images, SUBSTITUTIONS),
    }

    params = engines["bf16"].params
    assert perf.profiler._ATTRIBUTION_LOCK.acquire(blocking=False)
    try:
        perf.attribute_forward(CFG, params, images, iters=1)
        check(False, "attribute_forward inside the lock: ran")
    except RuntimeError as exc:
        check("already running" in str(exc),
              f"attribute_forward inside the lock raises: {str(exc)[:70]}...")
    finally:
        perf.profiler._ATTRIBUTION_LOCK.release()

    print(f"  scripts/probe_midsize {' '.join(MIDSIZE_ARGS)} (card: {smi_line}):",
          flush=True)
    mid = probe_midsize.main(MIDSIZE_ARGS)
    check(all(v is not None and v > 0 for v in mid.values()),
          f"probe_midsize: every variant ran ({', '.join(mid)})")
    # Each stand-in row's launches: from the substituted forward that runs it
    # (one forward, counts set to 0 just before it and read just after).
    launches = {"attention": counts["bf16"][(False, True, False)],
                "quantize": counts["w8a8"][(False, False, True)],
                "quantize_split": counts["w8a8_outlier"][(False, False, True)]}
    for counter, run in launches.items():
        check(run[counter] > 0, f"the {counter} stand-in launched {run[counter]} times "
                                f"in its substituted forward")
    return rows[ATTR_BATCH], launches


def traced_forward(name: str, fn, images, kernels: dict = TRACE_KERNELS) -> None:
    """Phase 6c: ``perf.device_kernel_table`` of ``fn(images)`` (one run
    outside the trace, TRACE_ITERS between its marks and one before and
    one after them): the table; each chain kernel's
    traced calls (``kernels``: name substring → counter) against its
    counter's rise over the traced runs; the
    card's busy share, the table's device total over the CUDA-event time of
    the same runs."""
    events = []

    def timed(im):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(im)
        end.record()
        events.append((start, end))
        return out

    before = read_counts()
    table = perf.device_kernel_table(timed, (images,), iters=TRACE_ITERS)
    torch.cuda.synchronize()
    after = read_counts()
    print("  " + perf.format_kernel_table(table, iters=TRACE_ITERS).replace(
        "\n", "\n  "), flush=True)
    for sub, counter in kernels.items():
        calls = sum(s.calls for s in table if sub in s.name)
        rise = after[counter] - before[counter]  # TRACE_ITERS + 3 runs
        traced = rise * TRACE_ITERS // (TRACE_ITERS + 3)
        check(calls == traced and calls > 0,
              f"{name}: {calls} traced launches of {sub!r}, {traced} by the "
              f"{counter!r} counter")
    device_ms = sum(s.total_ms for s in table)
    window_ms = events[2][0].elapsed_time(events[-2][1])
    print(f"  {name}: device busy share {device_ms / window_ms:.4f} (kernels "
          f"{device_ms:.3f} ms of {window_ms:.3f} ms by CUDA events over the "
          f"{TRACE_ITERS} traced runs)", flush=True)
    print(json.dumps({"trace": {"name": name, "iters": TRACE_ITERS,
                                "device_ms": device_ms, "window_ms": window_ms,
                                "busy_share": device_ms / window_ms,
                                "kernels": [dataclasses.asdict(s) for s in table]}}),
          flush=True)


def weight_ops_in_forward(engine, images) -> None:
    """Phase 6c: the PyTorch ops of one forward of the W8A8 ``engine`` that
    make a new tensor from an encoder int8 weight (a dispatch mode sees
    every op; a view shares the weight's storage): there must be none (the
    GEMM reads the K-major weights as stored, so no forward transposes or
    copies one)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    storages = {engine.params["layers"][key]["q"].untyped_storage().data_ptr()
                for key in ("qkv_w", "out_w", "fc1_w", "fc2_w")}
    seen = []

    def ptrs(tree):
        return {t.untyped_storage().data_ptr()
                for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)}

    class WeightOps(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            read = ptrs((args, kwargs)) & storages
            if read and not ptrs(out) <= read:
                seen.append(str(func))
            return out

    with WeightOps():
        engine.forward(images)
    torch.cuda.synchronize()
    check(not seen and all(quant.is_k_major(engine.params["layers"][key]["q"])
                           for key in ("qkv_w", "out_w", "fc1_w", "fc2_w")),
          f"W8A8 forward: the encoder's int8 weights stored K-major, no op makes "
          f"a tensor of one in a forward (ops that did: {sorted(set(seen)) or 'none'})")


def ring_device_time(call, tensor: torch.Tensor, row: dict, batch: int) -> None:
    """Phase 2i: the card's time of one ring step ``call()`` (``row``'s
    kernel) from a ``perf.device_kernel_table`` trace of DEVICE_TIME_ITERS
    calls alone, into ``row["device_ms"]``, and a check that the trace
    holds one launch a call: CUDA events around the wrapper measure its
    host work at the smaller shapes."""
    table = perf.device_kernel_table(lambda _x: call(), (tensor,), iters=DEVICE_TIME_ITERS)
    own = [s for s in table if "ring_step" in s.name]
    calls = sum(s.calls for s in own)
    row["device_ms"] = sum(s.total_ms for s in own) / DEVICE_TIME_ITERS
    check(calls == DEVICE_TIME_ITERS,
          f"{row['name']}: the trace holds {calls} ring step launches for "
          f"{DEVICE_TIME_ITERS} calls ({sorted({s.name[:60] for s in own})})")
    print(f"  B={batch} first rotation: device {row['device_ms']:.4f} ms a call (a trace "
          f"of {DEVICE_TIME_ITERS} calls), CUDA events {row['ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms", flush=True)


def ring_kernel_rows(dev) -> list[dict]:
    """Phase 2i: the ring step kernel against its plain version at
    RING_ROWS' shapes, bf16 and fp32, as a first rotation from (-inf, 0, 0)
    with the shard's padded keys masked, and as RING_ROTATIONS rotations
    chained (each side carrying its own state). Bound: q, k, v and the bias
    read, m and l read and written, acc read and written in fp32, once a
    rotation; 4·t_loc²·hd a row. No library call computes the carried
    function; SDPA on the same [n, t_loc, hd] (the same QKᵀ and PV work) is
    printed as a yardstick."""
    F = torch.nn.functional
    rows = []
    for name, batch, heads, t_loc, hd, block, masked in RING_ROWS:
        n = batch * heads
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(n + t_loc + hd)
            qkvs = [tuple(torch.randn((n, t_loc, hd), generator=gen,
                                      device=dev).to(dtype) for _ in range(3))
                    for _ in range(RING_ROTATIONS)]
            bias = torch.zeros((1, t_loc), device=dev)
            if masked:
                bias[:, t_loc - masked:] = attention.MASK_VALUE
            live = torch.zeros_like(bias)
            start = (torch.full((n, t_loc), -float("inf"), device=dev),
                     torch.zeros((n, t_loc), device=dev),
                     torch.zeros((n, t_loc, hd), device=dev))
            kw = dict(scale=float(1.0 / np.sqrt(hd)), block_q=block, block_k=block)
            kind = "bf16" if dtype == torch.bfloat16 else "fp32"

            def first(step, qkv=qkvs[0], bias=bias, start=start, kw=kw):
                return step(*qkv, bias, *start, **kw)

            def chained(step, qkvs=qkvs, bias=bias, live=live, start=start, kw=kw):
                state = start
                for i, qkv in enumerate(qkvs):
                    state = step(*qkv, bias if i == len(qkvs) - 1 else live,
                                 *state, **kw)
                return state

            one_bytes = (3 * n * t_loc * hd * qkvs[0][0].element_size() + t_loc * 4
                         + 4 * n * t_loc * 4 + 2 * n * t_loc * hd * 4)
            cases = []
            for what, fn, reps in (("first rotation", first, 1),
                                   (f"{RING_ROTATIONS} rotations chained", chained,
                                    RING_ROTATIONS)):
                refs = fn(attention.blockwise_ring_step_reference)
                cases.append(dict(
                    name=f"blockwise_ring_step {name} B={batch} n={n} t_loc={t_loc} "
                         f"hd={hd} block {block} ({kind}, {what})",
                    counter="attention_ring",
                    tol=[_scaled_tol(refs[0], 1e-5), _scaled_tol(refs[1], 1e-5),
                         _scaled_tol(refs[2], RING_REL[dtype])],
                    min_same=0.0,
                    kernel=lambda fn=fn: fn(attention.blockwise_ring_step),
                    plain=lambda fn=fn: fn(attention.blockwise_ring_step_reference),
                    library=None, bytes=reps * one_bytes,
                    ops={kind: reps * 4 * n * t_loc * t_loc * hd}))
                del refs
            rows += run_cases(cases, batch)
            once, twice = first(attention.blockwise_ring_step), first(
                attention.blockwise_ring_step)
            check(all(torch.equal(a, b) for a, b in zip(once, twice)),
                  f"{cases[0]['name']}: the same bits over two calls")
            del once, twice
            if kind == "bf16":  # fp32's calls outlast their host work
                ring_device_time(lambda: first(attention.blockwise_ring_step),
                                 qkvs[0][0], rows[-2], batch)
            q, k, v = qkvs[0]
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            print(f"  B={batch} yardstick: SDPA on the same [n, t_loc, hd] ({kind}; "
                  f"softmax(q·kᵀ)·v, not the carried function): {sdpa:.4f} ms "
                  f"(ring step, first rotation {rows[-2]['ms']:.4f} ms)", flush=True)
            del qkvs, cases
        torch.cuda.empty_cache()
    return rows


def counted(fn) -> tuple:
    """``fn()`` with the counts set to 0 just before it and read just after:
    (its result, the counts, its seconds on the host clock)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(), time.perf_counter() - t0


def expect_only(counts: dict, what: str, **launches) -> None:
    expected = {key: launches.get(key, 0) for key in COUNTERS}
    check(counts == expected, f"launches of {what} {counts}, expected {expected}")


@contextlib.contextmanager
def swapped(module, name: str, replacement):
    """``module.<name>`` replaced for the duration."""
    kernel_version = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield
    finally:
        setattr(module, name, kernel_version)


def virtual_mesh(dev, data: int, model: int):
    return spmd.make_mesh(data=data, model=model, devices=[dev] * (data * model))


def ring_main_path(dev, params: dict, images: np.ndarray, ref_probs: np.ndarray,
                   engine_probs: np.ndarray) -> dict:
    """Phase 3f's ring part: ``sp_forward(kv="ring")`` at ViT-L/16@512, full
    depth and widths, on a (1, MESH_SHARDS) virtual mesh of the card, on
    phase 3e's weights and first RING_BATCH decisive images, bf16: the
    launches (every layer's ring: depth x shards x shards kernels, nothing
    else), within PROB_TOL of the port's plain fp32 path, of
    ``kv="gather"`` and of the same ring on the plain step, phase 3e's
    engine's labels; then one fp32 ring forward at RING_F32_BATCH. Returns
    the bf16 and fp32 runs' counts."""
    cfg, s = LONG_CFG, MESH_SHARDS
    mesh = virtual_mesh(dev, 1, s)
    per_forward = cfg.depth * s * s
    out = {}
    for dtype, batch in ((torch.bfloat16, RING_BATCH), (torch.float32, RING_F32_BATCH)):
        kind = "bf16" if dtype == torch.bfloat16 else "fp32"
        params_d = vit.stack_params(params, cfg, param_dtype=dtype, device=dev)
        x = torch.from_numpy(images[:batch]).to(dev)

        def ring(x=x, params_d=params_d, dtype=dtype):
            return spmd.sp_forward(x, params_d, cfg, mesh, compute_dtype=dtype,
                                   kv="ring")

        probs, counts, secs = counted(ring)
        probs = probs.cpu().numpy()
        out[kind] = counts
        expect_only(counts, f"the {cfg.name} {kind} ring forward (B={batch}, "
                            f"{secs:.2f} s)", attention_ring=per_forward)
        err = float(np.abs(probs - ref_probs[:batch]).max())
        check(err <= PROB_TOL, f"{cfg.name} {kind} sp_forward(kv='ring') on {s} "
                               f"virtual shards vs fp32 plain: max abs err "
                               f"{err:.3e}, budget {PROB_TOL}")
        if dtype == torch.bfloat16:
            same = (probs.argmax(-1) == engine_probs[:batch].argmax(-1)).all()
            check(bool(same), f"{cfg.name} ring forward: phase 3e's engine's top-1 "
                              f"labels on all {batch} images")
            gather = spmd.sp_forward(x, params_d, cfg, mesh, compute_dtype=dtype,
                                     kv="gather").cpu().numpy()
            with swapped(attention, "blockwise_ring_step",
                         attention.blockwise_ring_step_reference):
                plain = ring().cpu().numpy()
            for what, other in (("kv='gather'", gather), ("the plain ring step", plain)):
                err = float(np.abs(probs - other).max())
                check(err <= PROB_TOL, f"{cfg.name} bf16 ring forward vs {what}: max "
                                       f"abs err {err:.3e}, budget {PROB_TOL}")
        del params_d
        torch.cuda.empty_cache()
    return out


def tensor_parallel_main_path(dev, rounded: dict, images: np.ndarray,
                              ref_probs: np.ndarray, engine) -> dict:
    """Phase 3f's ViT-B/16 part, on phase 3's workspace weights and 40
    decisive images, on virtual meshes of the card: ``tp_forward`` and
    ``sp_tp_forward`` (flash, bf16; T = 197 padded to 200 and masked by
    ``true_seq_len`` in SP x TP) on (1, MESH_SHARDS): the single-pass
    kernel once a layer a shard, within PROB_TOL of the port's plain fp32
    path and phase 3's engine's labels; W8A8 ``tp_forward`` within
    W8A8_TP_TOL of fp32 and PROB_TOL of the same forward on the plain
    attention; ``DataParallelEngine`` on (MESH_SHARDS, 1) with phase 3's
    labels, within PROB_TOL of its probabilities, and the chain's launches."""
    cfg, s = CFG, MESH_SHARDS
    mesh = virtual_mesh(dev, 1, s)
    stacked = vit.stack_params(rounded, cfg, param_dtype=torch.bfloat16, device=dev)
    x = torch.from_numpy(images).to(dev)
    engine_probs = engine.run(images)
    labels = engine_probs.argmax(-1)
    shards = spmd.shard_params_tp(stacked, mesh, cfg)
    runs = {}
    for name, fwd in (("tp_forward", spmd.tp_forward),
                      ("sp_tp_forward", spmd.sp_tp_forward)):
        probs, counts, secs = counted(lambda fwd=fwd: fwd(
            x, shards, cfg, mesh, attention_impl="flash").cpu().numpy())
        runs[name] = counts
        expect_only(counts, f"{cfg.name} {name} flash bf16 on {s} virtual shards "
                            f"({len(images)} images, {secs:.2f} s)",
                    attention=cfg.depth * s)
        err = float(np.abs(probs - ref_probs).max())
        check(err <= PROB_TOL and bool((probs.argmax(-1) == labels).all()),
              f"{cfg.name} {name}: max abs err {err:.3e} vs fp32 plain (budget "
              f"{PROB_TOL}), phase 3's engine's labels")
    qshards = spmd.shard_params_tp(quant.quantize_stacked_params(stacked, cfg), mesh, cfg)

    def w8a8():
        return spmd.tp_forward(x, qshards, cfg, mesh, attention_impl="flash",
                               w8a8=True).cpu().numpy()

    probs = w8a8()
    with swapped(attention, "packed_fused_attention",
                 lambda qkv, **kw: attention.packed_fused_attention_reference(
                     qkv, kw["num_heads"], kw["head_dim"], packing=kw["packing"],
                     true_seq_len=kw.get("true_seq_len"))):
        plain = w8a8()
    err, plain_err = (float(np.abs(probs - ref_probs).max()),
                      float(np.abs(probs - plain).max()))
    check(err <= W8A8_TP_TOL and plain_err <= PROB_TOL,
          f"{cfg.name} W8A8 tp_forward: max abs err {err:.3e} vs fp32 (budget "
          f"{W8A8_TP_TOL}), {plain_err:.3e} vs its plain attention (budget {PROB_TOL})")
    dp = DataParallelEngine(cfg, rounded, batch_size=SMOKE_BATCH, devices=[dev] * s,
                            attention_impl="flash")
    probs, counts, secs = counted(lambda: dp.run(images))
    forwards = -(-len(images) // SMOKE_BATCH) * s
    expect_only(counts, f"DataParallelEngine on ({s}, 1) virtual devices "
                        f"({forwards} shard forwards, {secs:.2f} s)",
                **{key: n * cfg.depth * forwards for key, n in PER_LAYER["bf16"].items()})
    err = float(np.abs(probs - engine_probs).max())
    check(err <= PROB_TOL and bool((probs.argmax(-1) == labels).all()),
          f"DataParallelEngine ({s}, 1): max abs err {err:.3e} vs phase 3's engine "
          f"(budget {PROB_TOL}), its labels")
    del stacked, shards, qshards, dp
    torch.cuda.empty_cache()
    return runs


def ring_throughput(dev, params: dict) -> None:
    """Phase 4e: ms and img/s of phase 3f's bf16 ring forward at
    RING_THROUGHPUT_BATCHES, CUDA events around 3 forwards after a warm-up:
    MESH_SHARDS virtual shards on one card (the kernel path's cost, not
    multi-card scaling); at RING_BATCH the kernels of a traced forward
    (``perf.device_kernel_table``), the ring step's share and the card's
    busy share."""
    cfg = LONG_CFG
    mesh = virtual_mesh(dev, 1, MESH_SHARDS)
    params16 = vit.stack_params(params, cfg, param_dtype=torch.bfloat16, device=dev)
    for batch in RING_THROUGHPUT_BATCHES:
        gen = torch.Generator(device=dev).manual_seed(batch)
        x = torch.randn((batch, 3, cfg.img_size, cfg.img_size), generator=gen,
                        device=dev)
        ms = time_ms(lambda: spmd.sp_forward(x, params16, cfg, mesh,
                                             compute_dtype=torch.bfloat16,
                                             kv="ring"), reps=3)
        print(f"ring throughput {cfg.name} bf16 sp_forward(kv='ring'), "
              f"{MESH_SHARDS} virtual shards on one card, B={batch}: "
              f"{batch / ms * 1e3:.2f} img/s ({ms:.2f} ms per forward)", flush=True)
        print(json.dumps({"ring_throughput": {
            "config": cfg.name, "shards": MESH_SHARDS, "virtual": True,
            "batch": batch, "forward_ms": ms, "img_per_s": batch / ms * 1e3}}),
            flush=True)
        if batch != RING_BATCH:
            continue
        # Where one forward's card time goes: the kernels of a traced run.
        full = perf.device_kernel_table(
            lambda im: spmd.sp_forward(im, params16, cfg, mesh,
                                       compute_dtype=torch.bfloat16, kv="ring"),
            (x,), iters=1)
        device_ms = sum(k.total_ms for k in full)
        ring_ms = sum(k.total_ms for k in full if "ring_step" in k.name)
        print("  " + perf.format_kernel_table(full[:12]).replace("\n", "\n  "),
              flush=True)
        print(f"  B={batch} ring forward: kernels {device_ms:.2f} ms of {ms:.2f} ms "
              f"(busy share {device_ms / ms:.4f}); the ring step kernel "
              f"{ring_ms:.2f} ms ({ring_ms / device_ms:.2%} of the kernels' time)",
              flush=True)
    del params16
    torch.cuda.empty_cache()


def probe_data(dev, kind: str, grid: int, seed: int = 0) -> dict:
    """The probe's operands at ``grid`` blocks: its own data (main()'s) or
    seeded random data (x ~ N(0, 2), int8 uniform in [-127, 127], sw > 0)."""
    rows = grid * probe.M_BLOCK
    if kind == "probe":
        w, sw = probe.weights(dev)
        return dict(xf=probe._x_f32(rows, 7, dev), xq=probe._x_i8(rows, 11, dev),
                    w=w, sw=sw)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    return dict(xf=torch.randn((rows, probe.K), generator=gen, device=dev) * 2.0,
                xq=i8(rows, probe.K), w=quant.k_major(i8(probe.K, probe.N)),
                sw=torch.rand((1, probe.N), generator=gen, device=dev) * 9e-4 + 1e-4)


def probe_compare(form: str, outs: list, refs: list) -> tuple:
    """(max abs error, within tolerance) of a form's outputs: bit-identical,
    but the LN's bf16 output within one bf16 ulp (floored at one fp32 ulp of
    1.0) and MIN_SAME_KERNEL identical."""
    err, ok = 0.0, True
    for i, (out, ref) in enumerate(zip(outs, refs)):
        o, r = out.float(), ref.float()
        diff = (o - r).abs()
        err = max(err, float(diff.max()))
        if form.endswith("ln") and i == 0:
            _, exp = torch.frexp(r.abs())
            ulp = torch.clamp_min(torch.ldexp(torch.ones_like(r), exp - 8), 2.0 ** -23)
            ok = (ok and bool((diff <= ulp).all())
                  and float((diff == 0).float().mean()) >= MIN_SAME_KERNEL)
        else:
            ok = ok and out.dtype == ref.dtype and torch.equal(out, ref)
    return err, ok


# One PyTorch call (and the epilogue as ops) computing a form's function over
# every block, where one exists: timed as yardsticks, never called by the port.
PROBE_LIBRARY = {
    "mxu": lambda d: (torch._int_mm(d["xq"], d["w"]).float() * d["sw"]).to(torch.bfloat16),
    "vpu:ln": lambda d: torch.nn.functional.layer_norm(
        d["xf"], (probe.K,), eps=probe.EPS).to(torch.bfloat16),
}


def probe_phase(dev) -> tuple:
    """Phase 2j: every form against its plain version (see PROBE_CHECK_GRID),
    the probe's main() at full size with the counts of exactly that run,
    every form against its plain version again on main()'s data at full
    size, the GRID 256 / 64 time ratios, and each form's plain and library
    times at the full size. Returns (the record's rows, main()'s counts)."""
    for kind in ("probe", "random"):
        d = probe_data(dev, kind, PROBE_CHECK_GRID)
        for form in PROBE_FORMS:
            outs, refs = probe.run(form, d), probe.run(form, d, plain=True)
            torch.cuda.synchronize()
            err, ok = probe_compare(form, outs, refs)
            t4 = probe._call(lambda: probe.run(form, d), dev) * 1e3
            check(ok, f"probe {form} GRID={PROBE_CHECK_GRID} N={probe.N} ({kind} data): "
                      f"max abs err {err:.3e}, bit-identical (LN: one bf16 ulp, "
                      f">= {MIN_SAME_KERNEL} identical); {t4:.4f} ms")
        del d
    times, counts, secs = counted(lambda: probe.main([]))
    launches = 1 + probe.REPS * probe.CHAIN
    for form, (counter, *_rest) in PROBE_FORMS.items():
        check(counts[counter] == launches,
              f"probe main() launched {form} {counts[counter]} times, expected {launches}")
    print(f"  probe main() at GRID={probe.GRID}: {secs:.1f} s", flush=True)
    big = probe_data(dev, "probe", probe.GRID)
    small = dict(big, xf=big["xf"][:PROBE_RATIO_GRID * probe.M_BLOCK],
                 xq=big["xq"][:PROBE_RATIO_GRID * probe.M_BLOCK])
    rows = []
    for form, (counter, row, line) in PROBE_FORMS.items():
        outs, refs = probe.run(form, big), probe.run(form, big, plain=True)
        torch.cuda.synchronize()
        err, ok = probe_compare(form, outs, refs)
        del outs, refs
        check(ok, f"probe {form} GRID={probe.GRID} N={probe.N} (main()'s data): "
                  f"max abs err {err:.3e}, bit-identical (LN: one bf16 ulp, "
                  f">= {MIN_SAME_KERNEL} identical)")
        t_small = probe._call(lambda: probe.run(form, small), dev) * 1e3
        ratio = times[form] / t_small
        check(PROBE_RATIO[0] <= ratio <= PROBE_RATIO[1],
              f"probe {form}: {times[form]:.4f} ms at GRID={probe.GRID} over "
              f"{t_small:.4f} ms at GRID={PROBE_RATIO_GRID} = {ratio:.3f}, in {PROBE_RATIO}")
        plain_ms = time_ms(lambda: probe.run(form, big, plain=True), reps=PLAIN_REPS)
        library = PROBE_LIBRARY.get(form)
        library_ms = time_ms(lambda: library(big)) if library else None
        bound_ms, bound_by = probe.bound(*probe.work(form, probe.GRID * probe.M_BLOCK))
        rows.append(dict(
            name=f"probe_w8a8_overlap {form} ({row}) GRID={probe.GRID} N={probe.N}",
            counter=counter, replaces=f"scripts/probe_w8a8_overlap.py:{line}",
            max_abs_err=err, ms=times[form], plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by))
        lib = "-" if library_ms is None else f"{library_ms:.4f}"
        print(f"  {rows[-1]['name']}: {times[form]:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), plain {plain_ms:.4f} ms, library {lib} ms, "
              f"GRID={PROBE_RATIO_GRID} {t_small:.4f} ms", flush=True)
    # The row warpgroup nearly alone: indep at N = 128 does 1/24 of the GEMM's
    # work beside all of its row work (printed beside mxu at N = 128 and the
    # row kernels alone: whether indep's time at N = 3072 is the GEMM's or
    # the row warpgroup's own).
    narrow = dict(big, w=big["w"][:, :128], sw=big["sw"][:, :128])
    alone = {form: probe._call(lambda: probe.run(form, narrow), dev) * 1e3
             for form in ("mxu", "indep:q", "indep:ln")}
    print(f"  probe GRID={probe.GRID} N=128 (the row warpgroup nearly alone): "
          + ", ".join(f"{form} {ms:.4f} ms" for form, ms in alone.items())
          + f"; at N={probe.N}: vpu:q {times['vpu:q']:.4f}, vpu:ln {times['vpu:ln']:.4f}, "
          f"mxu {times['mxu']:.4f}, indep:q {times['indep:q']:.4f}, indep:ln "
          f"{times['indep:ln']:.4f} ms", flush=True)
    del big, small, narrow
    torch.cuda.empty_cache()
    return rows, counts


def scripts_phase(dev, rounded: dict, images: np.ndarray) -> None:
    """Phase 7: the record-producing scripts on the card, as a user runs
    them (``main(argv)``, the card by default), and the engine's NaN guard
    on phase 3's weights."""
    with tempfile.TemporaryDirectory() as tmp:
        ws = Path(tmp) / "fixtures"
        rc = make_fixtures.main(["--out", str(ws), "--config", CFG.name,
                                 "--images", str(FIXTURE_IMAGES)])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_rc = cli.main([
                "--input", str(ws / f"input-{FIXTURE_IMAGES}.bin"),
                "--weights", str(ws / "Network"), "--output", str(ws / "result.txt"),
                "--answer", str(ws / "answer_result.txt"), "--backend", "gpu",
                "--attention", "flash", "--config", CFG.name,
                "--batch-size", str(FIXTURE_IMAGES)])
        print("  " + out.getvalue().strip().replace("\n", "\n  "), flush=True)
        check(rc == 0 and cli_rc == 0 and "Comparator: files match." in out.getvalue(),
              f"make_fixtures --config {CFG.name} --images {FIXTURE_IMAGES}, then cli "
              f"--backend gpu --attention flash on it: comparator green")
    res = soak.main(SOAK_ARGS)
    check(len(res["rates"]) == 2 and res["finite"],
          f"soak {' '.join(SOAK_ARGS)}: 2 windows, finite={res['finite']}")
    table = trace_table.main(TRACE_ARGS)
    check(bool(table) and any(W8A8_GEMM_KERNEL in s.name for s in table),
          f"trace_table {' '.join(TRACE_ARGS)}: {len(table)} rows, the W8A8 form of "
          f"the GEMM core among them")
    os.environ["AUG"] = "1"
    try:
        res = bench_train.main(BENCH_TRAIN_ARGS)
    finally:
        del os.environ["AUG"]
    loss = res.get("fused", {}).get("loss", float("nan"))
    aug = res.get("augment", {})
    check(math.isfinite(loss) and aug.get("device_augment_ms", 0) > 0
          and all(r > 0 for r in aug.get("host_img_per_s", {0: 0}).values()),
          f"AUG=1 bench_train {' '.join(BENCH_TRAIN_ARGS)}: loss {loss}, the augment "
          f"probe's rates {aug.get('host_img_per_s')} img/s, device_augment "
          f"{aug.get('device_augment_ms')} ms")
    res = recipe_smoke.main(RECIPE_SMOKE_ARGS)
    check(math.isfinite(res["loss"]) and res["export_files"] == len(
        binfmt.weight_names(CFG)),
          f"recipe_smoke {' '.join(RECIPE_SMOKE_ARGS)}: loss {res['loss']:.4f}, "
          f"{res['export_files']} EMA weight files, the pipeline "
          f"{res['pipeline_share'] * 100:.1f}% of a staged step")
    res = soak_serve.main(SOAK_SERVE_ARGS)
    check(res["images"] > 0 and res["stats"]["batch_errors"] == 0,
          f"soak_serve {' '.join(SOAK_SERVE_ARGS)}: {res['images']} images, "
          f"{res['img_per_s']:.1f} img/s, no failed request or batch")
    batch = images[:SMOKE_BATCH]
    guarded = InferenceEngine(CFG, rounded, batch_size=SMOKE_BATCH,
                              attention_impl="flash", device=dev, check_numerics=True)
    probs = guarded.run(batch)
    check(bool(np.isfinite(probs).all()),
          "InferenceEngine(check_numerics=True) passes on phase 3's weights")
    bad = dict(rounded, heads_head_weight=rounded["heads_head_weight"].copy())
    bad["heads_head_weight"].flat[0] = np.nan
    try:
        InferenceEngine(CFG, bad, batch_size=SMOKE_BATCH, attention_impl="flash",
                        device=dev, check_numerics=True).run(batch)
        caught = "nothing"
    except FloatingPointError as exc:
        caught = str(exc)
    check(caught.endswith("non-finite output values"),
          f"InferenceEngine(check_numerics=True) with one weight NaN raises: {caught}")


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: chip_smoke needs a card")
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("== phase 1: device and build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    smi_line = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
                else f"nvidia-smi: {smi.stderr.strip()}")
    print(smi_line, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, peaks {peaks()}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)

    with torch.inference_mode():
        phase(f"== phase 2: kernels vs plain versions, B={SMOKE_BATCH}")
        rows = kernel_rows(SMOKE_BATCH, dev)
        fp32_layer_norm_check(dev)
        phase(f"== phase 2b: int8 kernels vs plain versions, B={SMOKE_BATCH}")
        int8_rows = int8_kernel_rows(SMOKE_BATCH, dev)
        phase(f"== phase 2d: the whole-encoder stack of ViT-Ti/16 and ViT-S/16 vs "
              f"plain versions, B={SMOKE_BATCH}")
        small_rows = {cfg.name: stack_kernel_rows(cfg, SMOKE_BATCH, dev)
                      for cfg in SMALL_CFGS}
    # Outside inference mode: the yardsticks of the backward are autograd.
    phase(f"== phase 2e: training kernels and backward stages vs plain versions, "
          f"B={SMOKE_BATCH}")
    train_rows = train_kernel_rows(SMOKE_BATCH, dev)
    phase(f"== phase 2 (fp32): the fp32 forms of rows 3, 14a, 4 and 11 and row 14b's "
          f"fp32 dtype set vs plain versions, B={' and '.join(map(str, F32_ROW_BATCHES))}; row 4 also at "
          f"T={F32_ATTN_LONG[1]}, B={F32_ATTN_LONG[0]}")
    f32_rows = fp32_rows(dev)
    with torch.inference_mode():
        phase(f"== phase 2k: the LN, LN backward and quantize kernels at the stacks', "
              f"ViT-L's (and all but the LN at ViT-H's and ViT-G's) widths vs their "
              f"plain versions; the quantize, LN, ring step, fp32 attention, fp32 GEMM and probe "
              f"kernels' registers; device times of "
              f"rows 2, 5d, 14b, 14c, 5a, 6a and 6b at B={SMOKE_BATCH} (torch.profiler)")
        ln_width_rows(dev)
        quantize_width_rows(dev)
        masked_width_rows(dev)
        ln_bwd_width_rows(dev)
        usages = resource_usages([src for src, _ in USAGE_SOURCES])
        for (src, no_spills), kernels in zip(USAGE_SOURCES, usages):
            print_resource_usage(src, kernels, no_spills)
        reduction_device_times(dev)
    phase("== phase 2f: training kernels at the larger presets' shapes (ViT-L/16@384, "
          "ViT-H/14, ViT-G/14) vs plain versions")
    large_rows = large_kernel_rows(dev)
    torch.cuda.empty_cache()
    phase("== phase 2g: the blockwise attention kernels at ViT-L/16@512's T = 1025 "
          "(ViT-H/14@518's 1370, an odd tail, hd 128) vs plain versions, bf16 and fp32")
    flash_rows = flash_kernel_rows(dev)
    torch.cuda.empty_cache()
    with torch.inference_mode():
        phase("== phase 2h: the kernel layer's public ops (flash_attention, "
              "residual_layer_norm) and the packed attention's 849-1024 window "
              "vs plain versions")
        public_rows = public_op_rows(dev)
        phase("== phase 2i: the ring step kernel (blockwise_ring_step) vs its plain "
              "version at the ring's shard shapes")
        ring_rows = ring_kernel_rows(dev)
        torch.cuda.empty_cache()
        phase("== phase 2j: the W8A8 overlap probe's kernels vs plain versions, then "
              "the probe's main() (scripts/probe_w8a8_overlap)")
        probe_rows, probe_counts = probe_phase(dev)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        phase(f"== phase 2c: outlier-aware W8A8 kernels vs plain versions, "
              f"B={SMOKE_BATCH}")
        t0 = time.perf_counter()
        adv_ws = Path(tmp) / "adversarial"
        adv_rounded, adv_images, adv_ref = make_workspace(adv_ws, dev,
                                                          adversarial_weights())
        outlier_engine = InferenceEngine(
            CFG, adv_rounded, batch_size=SMOKE_BATCH, attention_impl="flash",
            device=dev, quantize="int8-w8a8",
            calibrate=binfmt.load_image_data(adv_ws / "calib.bin"))
        print(f"  calibrated W8A8 engine set up in {outlier_engine.setup_time:.1f} s "
              f"(workspace and engine {time.perf_counter() - t0:.1f} s)", flush=True)
        with torch.inference_mode():
            outlier_rows = outlier_kernel_rows(SMOKE_BATCH, dev,
                                               outlier_engine.params)
            outlier_rows += masked_kernel_rows(dev)

        ws = Path(tmp) / "random"
        phase("== phase 3: main path (cli, ViT-B/16, bf16, flash)")
        # libvitio, the CLI's default io layer: its first use in a checkout
        # compiles it (g++), outside the CLI's "loaded ... in" span.
        t0 = time.perf_counter()
        fresh = not native.library_path().exists()
        check(native.get_native_io() is not None,
              f"libvitio {'compiled and ' if fresh else ''}loaded in "
              f"{time.perf_counter() - t0:.2f} s ({native.library_path().name})")
        rounded, images, ref_probs = make_workspace(
            ws, dev, fixtures.random_params(CFG, seed=0))
        counts, engine = main_path(ws, dev, rounded, images, ref_probs)
        phase("== phase 3b: int8 main path (cli --quantize int8-w8a8, int8, auto)")
        int8_counts, engines = int8_main_path(ws, dev, rounded, images, ref_probs)
        phase("== phase 3c: calibrated outlier-aware W8A8 main path (cli "
              "--quantize int8-w8a8|auto --calibrate)")
        outlier_counts = outlier_main_path(adv_ws, dev, adv_rounded, adv_images,
                                           adv_ref, outlier_engine)
        phase("== phase 3d: the stack's main path (cli --config vit_tiny_16_224|"
              "vit_s_16_224, no flags, --quantize auto, int8; int8-w8a8 on ViT-S)")
        small = {cfg.name: small_main_path(Path(tmp) / cfg.name, dev, cfg)
                 for cfg in SMALL_CFGS}
        phase(f"== phase 3g: serving on the card (serve.InferenceServer, {CFG.name}, "
              f"W8A8 by --quantize auto, float32 and uint8, one card and "
              f"DataParallelEngine on {SERVE_SHARDS} virtual shards)")
        serving_main_path(ws, dev, rounded, images, smi_line)
        phase("== phase 3h: the input side (libvitio and --pure-python, --raw-images, "
              "io.export --from-pth → cli)")
        input_side_main_path(ws, dev, rounded, ref_probs)
        phase(f"== phase 3i: fp32 on the card (InferenceEngine(param_dtype=float32, "
              f"compute_dtype=float32, attention_impl='flash') on {CFG.name} and "
              f"{VIT_TINY_16_224.name}; Trainer(compute_dtype=float32) on {CFG.name} "
              f"{' and '.join(F32_ROUTES)}, B={F32_TRAIN_BATCH})")
        f32_counts, f32_engine = fp32_main_path(ws, dev, rounded, images, ref_probs,
                                                Path(tmp))
        phase(f"== phase 5: training main path (Trainer, ViT-B/16, bf16, AdamW; "
              f"routes {', '.join(TRAIN_ROUTES)})")
        train_counts = training_main_path(dev, Path(tmp))
        phase(f"== phase 5d: the DeiT recipe on the card (Trainer(device_augment, "
              f"mixup, ema_decay), {CFG.name}, fused, B={RECIPE_BATCH}; "
              f"raw_batches of {RECIPE_SRC}x{RECIPE_SRC} uint8)")
        recipe_main_path(dev, Path(tmp), smi_line, train_counts["fused"])
    phase("== phase 5b: training main path (Trainer, ViT-L/16@384, bf16, AdamW, "
          "fused; a fused and a flash step vs the plain links)")
    large_counts = large_training_main_path(dev)
    # Phases 3e and 5c share one draw of ViT-L/16@512's random weights.
    long_params = fixtures.random_params(LONG_CFG, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        phase(f"== phase 3e: ViT-L/16@512 inference main path (InferenceEngine, bf16, "
              f"flash, B={LONG_BATCH})")
        long_counts, long_images, long_ref, long_probs = long_inference_main_path(
            dev, Path(tmp), long_params)
    with torch.inference_mode():
        phase(f"== phase 3f: multi-device inference on virtual meshes of the card "
              f"(sp_forward kv='ring' at {LONG_CFG.name}; tp_forward, sp_tp_forward, "
              f"W8A8 TP and DataParallelEngine at {CFG.name})")
        ring_counts = ring_main_path(dev, long_params, long_images, long_ref, long_probs)
        tp_counts = tensor_parallel_main_path(dev, rounded, images, ref_probs, engine)
    phase("== phase 5c: ViT-L/16@512 training main path (Trainer, bf16, AdamW; "
          "flash and fused; a step of each vs the plain links)")
    long_train_counts = long_training_main_path(dev, long_params)
    with tempfile.TemporaryDirectory() as tmp:
        phase(f"== phase 3i ({LONG_CFG.name}): fp32 past padded T = 1024 "
              f"(InferenceEngine(param_dtype=float32, compute_dtype=float32, "
              f"attention_impl='flash') B={LONG_BATCH}; Trainer(compute_dtype=float32) "
              f"{' and '.join(F32_ROUTES)}, B={LONG_F32_TRAIN_BATCH})")
        long_f32_counts = long_fp32_main_path(dev, Path(tmp), long_params, long_images,
                                              long_ref)

    phase("== phase 4: throughput")
    with torch.inference_mode():
        forward_ms = throughput({"bf16": engine, **engines,
                                 "w8a8_outlier": outlier_engine}, dev)
        for cfg in SMALL_CFGS:
            small_throughput(cfg, small[cfg.name][1], dev)
        fp32_throughput(f32_engine, rounded, dev)
    del f32_engine
    phase("== phase 4b: training throughput")
    training_throughput(dev)
    training_throughput(dev, routes=("fused", "xla"), compute_dtype=torch.float32)
    print(f"  the training kernels at B={TRAIN_THROUGHPUT_BATCH}:", flush=True)
    train_kernel_rows(TRAIN_THROUGHPUT_BATCH, dev, seed=TRAIN_THROUGHPUT_BATCH)
    torch.cuda.empty_cache()
    phase("== phase 4c: ViT-L/16@384 training throughput")
    training_throughput(dev, LARGE_CFG, LARGE_THROUGHPUT_BATCH, ("fused", "flash"))
    phase("== phase 4d: ViT-L/16@512 training throughput")
    training_throughput(dev, LONG_CFG, LONG_BATCH, ("fused", "flash"))
    training_throughput(dev, LONG_CFG, LONG_F32_THROUGHPUT_BATCH, ("fused", "flash", "xla"),
                        compute_dtype=torch.float32)
    torch.cuda.empty_cache()
    with torch.inference_mode():
        phase(f"== phase 4e: {LONG_CFG.name} ring forward throughput, {MESH_SHARDS} "
              f"virtual shards on one card")
        ring_throughput(dev, long_params)
    with tempfile.TemporaryDirectory() as tmp:
        phase(f"== phase 6d: perf.autotune on {LONG_CFG.name} (tune_and_save B={LONG_BATCH} "
              f"bf16: the blockwise forward's key tile) and InferenceEngine(tuning_path=) "
              f"on phase 3e's weights and images at each key tile")
        tuned_runs = tuned_long_inference(dev, Path(tmp), long_params, long_images,
                                          long_ref, smi_line)
    del long_params

    with torch.inference_mode():
        phase("== phase 6: the kernel layer's public ops and the perf tools "
              "(profile_ops, device_kernel_table, throughput_report)")
        public_counts = public_ops_main_path(dev)
        profile_counts = profile_main_path(engine, dev)
        big = THROUGHPUT_BATCHES[-1]
        gen = torch.Generator(device=dev).manual_seed(big)
        big_images = torch.randn((big, 3, CFG.img_size, CFG.img_size), generator=gen,
                                 device=dev)
        traced_forward(f"{CFG.name} bf16 flash forward B={big}", engine.forward, big_images)
        traced_forward(f"{CFG.name} int8 flash forward B={big}", engines["int8"].forward,
                       big_images, TRACE_KERNELS_INT8W)
        traced_forward(f"{CFG.name} W8A8 flash forward B={big}", engines["w8a8"].forward,
                       big_images, TRACE_KERNELS_W8A8)
        weight_ops_in_forward(engines["w8a8"], big_images[:SMOKE_BATCH])
        del big_images
        tiny = VIT_TINY_16_224
        traced_forward(f"{tiny.name} bf16 stack forward B={SMOKE_BATCH}",
                       small[tiny.name][1]["bf16"].forward,
                       torch.randn((SMOKE_BATCH, 3, tiny.img_size, tiny.img_size),
                                   generator=gen, device=dev))
        report = perf.throughput_report(CFG, big, forward_ms["bf16", big] / 1e3, 1)
        print(f"  throughput_report {CFG.name} bf16 flash B={big} (phase 4): "
              f"{report['images_per_sec']:.1f} img/s, "
              f"{report['achieved_tflops']:.2f} TFLOP/s, MFU {report['mfu']:.4f} "
              f"of {perf.profiler.PEAK_BF16_TFLOPS['h100']} TFLOP/s "
              f"(card: {smi_line})", flush=True)
        print(json.dumps({"throughput_report": dict(report, card=smi_line)}),
              flush=True)
    torch.cuda.empty_cache()
    with torch.inference_mode():
        phase(f"== phase 6c: substitution attribution (perf.attribute_forward, "
              f"kernel_substitutions; scripts/probe_tiny_bound on {CFG.name} bf16 and "
              f"W8A8 and the ViT-Ti/16 stack at B={ATTR_BATCH}, scripts/probe_midsize "
              f"on ViT-S/16) and the stand-ins vs their plain versions")
        stand_in, stand_in_runs = attribution_phase(
            dev, {"bf16": engine, **engines, "w8a8_outlier": outlier_engine},
            small[VIT_TINY_16_224.name][1]["bf16"], smi_line)
    torch.cuda.empty_cache()
    phase("== phase 7: the record-producing scripts (make_fixtures, soak, trace_table, "
          "bench_train with AUG=1, recipe_smoke, soak_serve) and "
          "InferenceEngine(check_numerics=True)")
    scripts_phase(dev, rounded, images)

    # Each row's launches: from the main-path run that drives its kernel.
    runs = [(counts, r) for r in rows] + [
        (int8_counts["int8" if r["counter"].endswith("int8w") else "w8a8"], r)
        for r in int8_rows] + [(outlier_counts["w8a8_outlier"], r)
                               for r in outlier_rows]
    # The small configs' rows, from the CLI run of their config that drives
    # them (bf16, int8 weights, and W8A8 on ViT-S); rows of chains that no
    # small-config run drives (the per-layer bf16 and int8-weight chains,
    # W8A8 on ViT-Ti, the W8A8 stack and the group, as in the JAX package)
    # are printed above, not recorded.
    def int8w(r):
        return r["counter"].endswith("int8w")

    for name, (kernels_, int8_kernels_, stacks_) in small_rows.items():
        cli = small[name][0]
        pairs = ([(cli["bf16"], r) for r in kernels_]
                 + [(cli["int8"] if int8w(r) else cli.get("w8a8"), r)
                    for r in int8_kernels_]
                 + [(cli["int8"] if int8w(r) else cli["bf16"], r) for r in stacks_])
        runs += [(run, r) for run, r in pairs
                 if run and r["counter"] in SOURCES and run[r["counter"]]]
    # The training rows, from the phase-5 run of their route (the attention
    # backward from flash, where it is the route's one backward kernel); the
    # whole-backward row is printed above, not recorded (no one TPU kernel).
    runs += [(train_counts["flash" if r["counter"] == "attention_bwd" else "fused"], r)
             for r in train_rows if r["counter"] != "fused_bwd"]
    # Phase 2f's rows at the ViT-L shapes, from phase 5b's run (the other
    # presets' rows are printed above).
    runs += [(large_counts, r) for r in large_rows
             if r["name"].startswith(LARGE_CFG.name) and r["counter"] != "fused_bwd"]
    # Phase 2g's rows at ViT-L/16@512 shapes, from the run that drives each:
    # the forward from phase 3e's, the forward with the LSE and the blockwise
    # backward from phase 5c's flash run, the packed backward from its fused
    # run (the other shapes are printed above).
    # The 256- and 512-key instances' slab rows from phase 6d's engine tuned
    # to each (their LSE and split-head rows are printed above). The fp32
    # forms' rows from phase 3i's ViT-L/16@512 runs: the forward from the
    # fp32 engine's, the forward with the LSE and the backward from the
    # fp32 flash steps'; the split-head row from phase 6a's public ops.
    long_runs = {"attention_flash": long_counts,
                 "attention_flash_lse": long_train_counts["flash"],
                 "attention_flash_bwd": long_train_counts["flash"],
                 "attention_bwd": long_train_counts["fused"],
                 "attention_flash_f32": long_f32_counts["engine"],
                 "attention_flash_lse_f32": long_f32_counts["flash"],
                 "attention_flash_bwd_f32": long_f32_counts["flash"],
                 "attention_flash_split_f32": public_counts,
                 **{f"attention_flash_k{bk}": tuned_runs.get(bk, {})
                    for bk in FLASH_TUNED_KS}}
    runs += [(long_runs[r["counter"]], r) for r in flash_rows
             if r["name"].startswith(LONG_CFG.name) and r["record"]]
    # Phase 2h's rows: the single-pass kernel's from phase 6's profile_ops
    # run, residual_layer_norm's and the split-head blockwise forward's from
    # its public ops' run; the packed kernel's per-head key-count rows from
    # phase 3f's sp_tp_forward (per-head packing, a key count), its window
    # rows from phase 3's run (the slab entry).
    def public_run(r):
        if r["counter"] == "attention":
            return tp_counts["sp_tp_forward"] if "per_head" in r["name"] else counts
        return profile_counts if r["counter"] == "attention_single" else public_counts

    runs += [(public_run(r), r) for r in public_rows]
    # Phase 2i's first-rotation rows at phase 3f's shape (ViT-L/16@512, 4
    # shards, B = 8), from phase 3f's bf16 and fp32 ring forwards.
    runs += [(ring_counts["bf16" if "(bf16," in r["name"] else "fp32"], r)
             for r in ring_rows
             if r["name"].startswith(f"blockwise_ring_step ViT-L/16@512 4 shards "
                                     f"B={RING_BATCH} ") and "first rotation" in r["name"]]
    # Phase 2j's rows, from the probe's main() at its full grid.
    runs += [(probe_counts, r) for r in probe_rows]
    # Phase 2's fp32 rows at B = 16, from phase 3i: the forward forms from
    # the fp32 ViT-B engine's run, the backward GEMM forms and the LN
    # backward from the fp32 fused steps, the attention backward from the fp32 flash steps (its
    # route's one backward kernel).
    f32_runs = {"linear_f32": f32_counts["vit_b"], "attention_f32": f32_counts["vit_b"],
                "attention_bwd_f32": f32_counts["flash"]}
    runs += [(f32_runs.get(r["counter"], f32_counts["fused"]), r) for r in f32_rows
             if r["record"]]
    # Phase 6c's stand-in rows at B = ATTR_BATCH, from the substituted
    # forward of the main path's engine that runs each.
    runs += [(stand_in_runs[r["counter"]], r) for r in stand_in]
    record = {"kernels": [
        {"name": r["name"], "route": "cuda",
         "source": r.get("source") or SOURCES[r["counter"]],
         "replaces": r["replaces"] or REPLACES[r["counter"]],
         "launches": run.get(r["counter"], 0),
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]} for run, r in runs]}
    print(f"total {time.perf_counter() - T_START:.1f} s", flush=True)
    if failures:
        print(f"FAILED: {len(failures)} check(s): {failures}")
        return 1
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
