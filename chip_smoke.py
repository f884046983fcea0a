#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each printed as one JSON line:

1. ``env``: the card (``nvidia-smi``), torch / CUDA / nvcc versions, and the
   build of every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all at once, into ``build/repro_torch``), with ptxas's
   registers and spills (kept beside each library, so a library built
   before is reported too).  Fails if the sm90 flash-attention body (its
   four instances: dh 80, 128, 160 and 256), its
   fp32 mma_tf32x3 body (every head dim, 8 warps a CTA at 160 and 256), a
   kernel of the SSD mma, mma_tf32x3 or RG-LRU segmented bodies or a
   backward kernel (the scans' too; flash's pair kernels above dh 80 and
   its bf16 sm90 backward at dh 80, 128, 160 and 256) spills, or ptxas
   ignored a ``setmaxnreg`` (C7508).
2. ``kernels``: each kernel against its plain PyTorch version on the card,
   at the JAX suite's own tolerances: fp32 2e-5 and bf16 2e-2, the RG-LRU
   scan 1e-4 fp32 / 2e-2 bf16, the SSD scan 2e-3 fp32 / 5e-2 bf16 (y and
   the final state).  Flash attention at every head dim of the config
   registry, and the sm90 body (bf16, dh 80, 120, 128, 160 and 256) at
   ragged S, GQA 7:1, stablelm-12b's 32:8, MQA 16:1, window and chunk
   edges, no causal mask, views of a
   fused projection and the MoE serves' prefill shapes (moonshot-v1-16b-a3b's
   MHA 16/16, llama4-scout-17b-a16e's GQA 40/8 with its chunk of 8192 and
   without), each at S 512 and a ragged 300; rmsnorm's one-read body at D
   768, 1536, 2048, 3584, 4096 and 5120 (bf16; fp32 up to 4096) and the
   generic body at an odd width and an fp32 row of 5120 (the MoE shapes
   from a generator of their own); every RG-LRU case (S 1, 37, 512 and
   2176, W 4096 and 200, with and without h0) on both bodies (segmented
   against ``rglru_assoc``, serial against ``rglru_sequential``) and every
   SSD case on each body that takes it (bf16: mma and fma; fp32:
   mma_tf32x3 and fma), with each of the mma body's three phase kernels
   against its plain phase.  The fp32 forwards on the TF32 tensor cores
   (the train paths' mma_tf32x3 bodies): SSD at mamba2-130m's train shape
   (x (8,1024,24,64)) on both fp32 bodies and its chunk scan against the
   plain phases with every product split as the kernel splits it
   (``ssd_fp32_kernels``); flash attention at the 100m step's shape, its
   window / chunk masks, GQA 8, MQA and ragged S at every head dim, o and
   the log-sum-exp against ``mha_ref`` and the fp32 body forced
   (``flash_fp32_kernels``); each then timed against its previous
   body (fma / fp32), its plain version, SDPA's fp32 forward (flash) and
   its bounds (3xTF32 operations at the TF32 rate, bytes; the fp32-FMA
   bound beside).
   Each case records the body that ran.  The two backward kernels
   (RMSNorm: dx and dscale, on its warp_rows body at the train widths, its
   cta_rows body at 2048 and 3584 and its generic body at an odd width,
   and in fp32 at the recurrent train steps' shapes, (8192, 768) on
   warp_rows, (8192, 1536) and (2048, 4096) on cta_rows, each asserting its
   body; flash attention: dq,
   dk, dv on the tensor cores, with the forward's log-sum-exp) against
   autograd of their plain versions on the same inputs (flash attention's
   in fp32, RMSNorm's in fp64: rmsnorm_ref's own fp32 dscale strays past
   2e-5 at 8192 rows), fp32 and
   bf16, at every head dim of the registry (16-80, and 120, 128, 160 and
   256: bf16 at 128 and 256 as views of a fused projection that the
   forward's mma body takes, its log-sum-exp feeding the backward),
   causal / window / chunk masks (a window of
   2048 that bites at S 2200, dh 256), GQA groups up to 8, MQA and S that
   is not a multiple of the 64-row tiles, each called twice (the same
   bits).  The scans' backward kernels (SSD:
   dx, ddt, dA, dB, dC, dD, on its mma body (asserted) and on the fma body
   forced beside it; RG-LRU: d log_a, d gx, dh0) against their plain
   backwards (``ssd_chunked_bwd``, ``rglru_bwd``) on the card, fp32 and
   bf16, at the scans' tolerances, at mamba2-130m's train shape (x
   (8,1024,24,64), chunk 128), a ragged S = 1000 with a gradient of the
   final state and grouped B/C; recurrentgemma-9b's (4,512,4096), S 37
   and ragged S of one, two and three 512-step windows with h0 and a
   gradient of h_last, on the RG-LRU backward's segmented body (S >= 64)
   and the serial body forced beside it; each called twice (the same
   bits) and once through its autograd Function.  Then kernel,
   plain and library
   (``F.rms_norm`` / SDPA; none computes the RG-LRU or the SSD scan) times
   at the serving shapes of qwen2-7b, recurrentgemma-9b (and its decode
   shape for the RG-LRU) and mamba2-130m, and the backwards at the 100m
   preset's training shapes (the library: the backward alone of F.rms_norm
   and of SDPA, through autograd; the RMSNorm backward's cta_rows body also
   at (8192, 1536) and (2048, 4096)), beside the least time the card
   could take (bytes over 3.35 TB/s or operations over the peak rate of
   their type; the SSD row also gives the fp32-operations bound of its fma
   body, the flash backward's row the bound of its split products at the
   TF32 rate and ``fma_bound_ms``, its five products at the fp32 FMA rate),
   and each backward's device time by kernel (``kernel_ms``); the scans'
   backwards at mamba2-130m's and recurrentgemma-9b's train shapes (fp32),
   the SSD's mma body bounded by ``ssd_bwd_split_macs`` at the TF32 rate
   and by bytes (``fma_bound_ms``: ``ssd_bwd_macs`` at the fp32 rate, the
   fma body's); the RG-LRU's segmented body beside its serial body.  Flash
   attention in fp32 at recurrentgemma-9b's train step (q (4,512,16,256),
   k/v (4,512,1,256), window 2048) and at stablelm-12b's heads (q
   (4,512,32,160), k/v (4,512,8,160)): the mma_tf32x3 forward beside the
   FMA body, the pair backward by kernel, its head splits one by one, each
   beside SDPA's fp32 call and the plain version
   (``flash_rgemma_kernels``; ``ms_windows``: each profiler window's total
   beside the median).  The bf16 backward at dh 256 and 160 on the sm90
   body's column halves (``sm90_bwd_kernels``): at those two shapes
   and at the train_4k steps of recurrentgemma-9b (q (1,4096,16,256), k/v
   (1,4096,1,256), window 2048, biting) and stablelm-12b (q
   (1,4096,32,160), k/v (1,4096,8,160)), against autograd of ``mha_ref``
   in fp32, two runs bit for bit, every head split held, by kernel, beside
   the pair kernels forced as its previous body and held to the same limit,
   SDPA's bf16 backward (and where the window bites its ``is_causal``
   call) and the plain one; then held at ragged S 1100 with windows that
   bite.  The same function (``SM90_BWD_SHAPES``) times and holds the
   sm90 backward at qwen2-vl-2b's and stablelm-3b's train shapes, and
   times the forward each shape's train path runs; the sm90 forward's
   dh-160 instance (``Sm90<160>``) gets a kernels-line entry of its own,
   ``flash_attention_sm90_dh160``, beside the mma body it replaced.
   The mma body's chunk scan is also held, at one bf16 step of y
   (2^-7), against its plain phase with the fp32 operands split as the
   kernel splits them (a scan that dropped the lo halves fails there).
   ``ms``,
   ``plain_ms`` and ``library_ms`` are device time: the kernels one call
   runs, summed under ``torch.profiler`` over 20 calls after warm-up, per
   call, the median of 3 profiler windows; ``event_ms`` and ``library_event_ms`` are the CUDA-event median of
   30 calls, which includes the host's launch path when that is longer than
   the kernel.  ``previous_body_ms`` times, on the same inputs, the body
   these shapes took before this round of redesigns (flash attention's mma
   body, rmsnorm's generic body, the SSD scan's fma body, the RG-LRU's
   serial body, the RMSNorm backward's generic body, the SSD backward's fma
   body), called through the C entry point or the wrapper's ``body=``; the
   SSD row times each phase too.  Each kernel's
   ``profiler_windows`` counts its timings and the profiler windows they
   took (more than 3 a timing: the profiler dropped a window, which is
   then taken again).
3. ``serve_check``, once per served arch, at full width, fp32, random
   weights from the seed: the last-position logits of ``prefill`` and 8
   ``decode_step``s against ``forward_train`` on the same tokens, within
   2e-4 relative.  qwen2-7b at 4 layers, batch 2, prompt 128;
   recurrentgemma-9b at 3 layers (one superblock), batch 1, a 2176-token
   prompt (longer than its 2048-token window, so the ring cache rolls);
   mamba2-130m at all 24 layers, batch 2, a 1000-token prompt (not a
   multiple of the 128-token chunk, so the SSD kernel pads its last chunk
   and hands its final state to the decode steps); moonshot-v1-16b-a3b at 4
   layers, batch 2, prompt 128, and llama4-scout-17b-a16e at 4 layers (its
   first superblock: 3 chunked-attention layers, 1 global NoPE one; 43.5
   GB of fp32 weights, alone on the card), batch 1, prompt 512, both at a
   capacity factor of ``num_experts`` (no capacity drops, which differ
   between a forward pass and decode by design), each printing the
   smallest top-k routing margin it met and the (token, layer) routes that
   differ between the forward and the served tokens.
   Then ``ssd_bodies``: one bf16 mamba2-130m prefill wave (24 layers,
   batch 4, prompt 512) through the SSD scan's mma body and again with the
   fma body forced: the logits within ``SSD_BODIES_REL`` of the largest
   (beside the same wave through the plain phases with the fp32 operands
   split, and with them rounded to plain bf16).
4. ``serve``, once per served arch: the full model (qwen2-7b 28 layers,
   recurrentgemma-9b 38, mamba2-130m 24, moonshot-v1-16b-a3b 48; bf16
   weights and cache), and llama4-scout-17b-a16e cut to 4 layers (its line
   says so in ``reduced``), through the ``serve_batch`` wave loop: 12
   requests, 3 waves of batch 4, 512-token prompts, 32 greedy new tokens.
   Every kernel's launch counter is reset just before and must equal the
   analytic count just after, by body too: every flash launch on the sm90
   body, every rmsnorm launch on the one-read body, every SSD launch on
   the mma body, RG-LRU prefill on the segmented body and decode on the
   serial body.
5. ``profile``, after each serve: one more prefill wave and 8 decode steps
   under ``torch.profiler``: wall time, summed kernel time, the card's idle
   share and the costliest kernels; for the MoE models split into the
   routing bookkeeping, the router's product, the expert products, the
   experts' elementwise ops (activation, g·u, the trash slot's pad), the
   shared expert, flash attention, rmsnorm and the host gap.
6. ``train_check``: one train step of the 100m preset at 2 layers, fp32,
   on the card against the same step on the CPU (same weights, same
   ``SyntheticLM`` batch): loss and gradients within ``TRAIN_REL``, the
   updated parameters as ``phase_train_check`` states.
7. ``train``: the 100m preset at full width and depth (80.75 M parameters,
   fp32, TF32 off) through ``examples/train_lm_torch.py``'s Trainer and
   ``run_with_restarts``, with transactional checkpoints through CannyFS
   (1 ms simulated storage latency): the loss falls by more than 0.05 and
   ends below ln V; launches equal 25 RMSNorm and 12 flash a step, each
   way, every flash forward on the mma_tf32x3 body; a second Trainer
   restores the last step bit for bit; a run whose
   step fails restarts from the last commit.  Step time against its FLOP
   bound, one profiled step, peak memory and each checkpoint's ACK time.
   Before it, ``train_check`` of the two recurrent families and of
   qwen2-7b, as the 100m's (fp32, the same checks and limits): mamba2-130m
   at 2 layers and full width, recurrentgemma-9b at 3 layers (its first
   superblock, attention at head dim 256) narrowed to
   ``RGEMMA_CHECK_WIDTH``, qwen2-7b at 2 layers (head dim 128) narrowed
   to ``QWEN2_CHECK_WIDTH`` and moonshot-v1-16b-a3b at 2 layers narrowed to
   ``MOONSHOT_CHECK_WIDTH`` (64 experts, top-6, printing its routing margin
   and flipped routes), all batch 2 x 256.
8. ``train_mamba2``: mamba2-130m at full width and depth (24 SSD layers,
   fp32) through the port's launcher, ``python -m repro_torch.launch.train
   --arch mamba2-130m --steps 100 --batch 8 --seq 1024 --ckpt-every 25
   --io-latency-ms 1``: the loss falls (mean of the last 10 steps below the
   first 10's), every step finite, the 4 checkpoints commit, the last step
   restores bit for bit; 24 SSD and 49 RMSNorm launches a step, each way,
   every SSD forward on its mma_tf32x3 body, every SSD backward on its mma
   body and the gated norms' 24 RMSNorm backwards a step on cta_rows (the
   other 25 on warp_rows).  Step ms, peak memory, checkpoint ACK s, and one
   more step profiled with each kernel family's device ms and share of the
   step (the SSD forward's own launches, the state pass both ways share,
   the SSD backward's, RMSNorm's).
9. ``train_rgemma_3l``: recurrentgemma-9b at full width cut to 3 layers,
   its first superblock (rglru, rglru, attn_local at head dim 256, MQA,
   window 2048), fp32, batch 4 x 512, 10 steps of ``make_train_step``, no
   checkpoint: every loss finite, 2 RG-LRU, 1 flash and 7 RMSNorm launches
   a step, each way, the RG-LRU on its segmented bodies both ways, flash
   forward and backward on mma_tf32x3, every RMSNorm backward on cta_rows.
   Step ms, peak memory, its bounds, one more step profiled by kernel
   family.

10. ``train_qwen2vl_bf16``: qwen2-vl-2b at full width and depth (28
   layers, 1.544 B parameters), bf16 (fp32 weights, gradients and
   moments), batch 4 x 1024 with 512 patch embeddings a row, 10 steps of
   ``make_train_step``, no checkpoint: every loss finite, the first
   batch's loss lower after the steps; 28 flash forwards on the sm90 body
   (with its log-sum-exp) and 28 sm90 backwards a step, 57 RMSNorm
   launches each way (the backwards on cta_rows).  Step ms, peak memory,
   the bf16 step bound, one more step profiled by kernel family.
11. ``encode_hubert``: hubert-xlarge at full width and depth (48 layers),
   bf16, one 32768-frame sequence through ``make_encode_step`` (the
   dry-run's prefill_32k, its batch of 32 cut to 1): logits finite, 48
   flash forwards on the sm90 body at dh 80 with no causal mask and 97
   RMSNorm forwards; ms an encode, peak memory, its bound.
12. (run after 10, before 11) ``train_qwen2vl_remat``: qwen2-vl-2b as
   in 10, 3 steps under each of the four remat policies
   (``parallel.POLICIES``) from the same weights and batches: the first
   batch's gradients the ``none`` call's bits (or
   within ``TRAIN_CHECK_LIMITS[bfloat16]``), the peak memory of that call
   and of a whole step, step ms, the launches a step by body (flash
   forwards L or 2L, RMSNorm forwards 2L + 1 or 4L + 1: the backward
   reruns each superblock's kernels under every policy but ``none``).
13. (then) ``train_stablelm3b_bf16``: stablelm-3b at full width and
   depth (32 layers, 2.80 B parameters, dh 80), ``TrainConfig()``'s (bf16,
   ``dots_no_batch``), batch 4 x 1024, 10 steps: losses finite, the first
   batch's loss falling; 64 sm90 flash forwards at dh 80, 32 sm90
   backwards at dh 80, 129 RMSNorm forwards and 65 cta_rows backwards a
   step.  Step ms, peak memory beside 16 B and 28 B a parameter, the
   loss-and-gradient call's peak, one more step profiled.
14. (right after qwen2-7b's serve, on its weights) ``mesh``: the mesh
   path at world size 1 over NCCL (``launch.mesh.make_debug_mesh``, a
   (1, 1) ("data", "model") ``DeviceMesh``): qwen2-7b's first serve wave
   again through the mesh steps on ``serve_shardings``' shards (the same
   tokens, logits within 2e-2 (1 + |x|)); stablelm-3b at full width cut
   to 2 layers, one bf16 (``TrainConfig()``, ZeRO-1, ``dots_no_batch``)
   and one fp32 loss-and-gradient call and step through ``mesh=`` against
   the plain ones (``TRAIN_CHECK_LIMITS``; fp32 parameters within 2 lr);
   ``seq_sharded_decode_attention`` at qwen2-7b's decode shape against
   ``mha_ref``, ``int8_psum`` against its quantize-dequantize and a
   one-stage ``pp_forward`` against the stack; its launches (the wave's
   plus the plain steps' own) go to the kernels line as ``mesh``.
15. (after 9) ``train_rgemma_bf16``: recurrentgemma-9b at full width cut
   to 3 layers (its first superblock), ``TrainConfig()`` (bf16,
   ``dots_no_batch``), batch 1 x 4096 (``train_4k``'s sequence: the
   window of 2048 bites), 5 steps: losses finite, the first batch's loss
   falling; 2 sm90 flash forwards and 1 sm90 backward at dh 256 a step
   (the sm90 backward's column halves), 4 RG-LRU forwards and 2 backwards
   on the segmented bodies, 13 RMSNorm forwards and 7 cta_rows backwards.
   Step ms, peak memory beside 16 B and 28 B a parameter, the
   loss-and-gradient call's peak, one more step profiled.
16. (after 13) ``train_stablelm12b_bf16``: stablelm-12b at full width cut
   to 2 layers the same way (5 steps): 4 flash forwards on the sm90 body
   at dh 160 (with its log-sum-exp) and 2 sm90 backwards at dh 160 a step,
   9 RMSNorm forwards and 5 cta_rows backwards.
17. (after the serves) ``mesh_blocks``: the blocks that the mesh runs
   since the eleventh slice, at world size 1 over NCCL on a process group
   of their own, each through ``mesh=`` against the plain call on the same
   weights and inputs: moonshot-v1-16b-a3b at full width cut to 2 layers
   (bf16 ``TrainConfig()``, 2 x 1024; the loss and gradients within
   ``TRAIN_CHECK_LIMITS``, flipped routes counted, then 3 mesh steps whose
   loss falls, step ms and peak memory beside 16 B a parameter),
   recurrentgemma-9b's first superblock at full width (1 x 4096, through
   the RG-LRU kernels both ways), hubert-xlarge's encode cut to 2 layers
   (1 x 32768 frames) and a qwen2-vl-2b wave cut to 2 layers with an image
   block (the same tokens, logits within 2e-2 (1 + |x|)); each part's mesh
   launches, counted from 0 in its own window, equal its plain run's, and
   join ``mesh``'s in the kernels line.
18. (after the train and encode phases) ``dryrun``: ``launch/dryrun.py``
   in processes of its own, no kernel launched: qwen2-7b x train_4k x
   16x16 through the CLI (a 256-rank fake group, fake CUDA tensors, the
   kernels' shape-only twins), then the cells of 15 and 16 at world size
   1, each record's peak, step time and FLOPs beside what that phase
   measured; ``model_flops`` must equal ``train_bounds``' and each twin's
   launches the launches a step that phase counted; the SSD twins'
   workspace sizes must equal the library's.
19. (after the serves) ``serve_mamba2_p128``: mamba2-130m at full width
   and depth at ``MAMBA2_P128`` (12 heads of 128, states of 128, the
   upstream module's chunk of 256, run at a tile of 128), built with
   ``dataclasses.replace`` on the registry's config: one bf16 wave (batch
   4, prompt 512, 32 new tokens) on the SSD mma body at head dim 128,
   held against its fp32 wave (within ``SERVE_REL`` of ``forward_train``)
   no further than 1.1 x the same wave with the fma body forced; its
   launches counted as the serves' are.
20. (after 8) ``train_mamba2_p128``: ``train_mamba2`` at ``MAMBA2_P128``,
   batch 8 x 1024, 10 steps, one checkpoint: the loss falls, 24 SSD
   launches a step each way, every forward on mma_tf32x3 and every
   backward on mma (two slabs of P) at head dim 128; step ms, peak memory
   and the SSD backward's device ms and share of a profiled step.  Before
   it ``train_check`` holds the same config at 2 layers (batch 2 x 256)
   against the CPU within the fp32 limits, and ``kernels`` holds the SSD
   forward at P, N and chunk 128 and at chunk 256 (head dims 64 and 128)
   on every body, the backward at (8,1024,12,128) chunk 128 and
   (2,1000,12,128) chunk 256 with the final state's gradient on the mma
   body (fp32 and bf16, twice: the same bits), and times the backward
   there (``ssd_bwd_p128``, beside the fma body at chunk 64, the only body
   that took P 128 before) and the fp32 forward at chunk 256
   (``ssd_fwd_fp32_p128``, beside the fma body).

The shapes the train and encode phases cut from (train_4k's 4096,
prefill_32k's 32768) are ``launch/specs.py``'s ``SHAPES``, and every
kernel's bound comes from its cost function in the package
(``launch/roofline.py``'s constants and ``bound_ms``).

Every train phase before 12 runs ``remat_policy="none"``, as it did before
the port had remat, so its counts, step times and peaks stay comparable;
``train_check`` adds stablelm-3b at full width cut to 2 layers in bf16
under ``dots_no_batch`` (and recurrentgemma-9b at its check width and 3
layers the same way: the sm90 backward at dh 256), and ``kernels`` holds
rmsnorm at rows of 2560 both ways, the sm90 forward with its lse and the
bf16 backward at stablelm-3b's train shape (q, k, v (4, 1024, 32, 80)): the sm90 body's
dh-80 instance (``Sm90Bwd<80>``), by kernel and two runs bit for bit,
beside mma_bf16's 4-warp kernels forced as its previous body.

This slice also adds, to ``kernels``, the sm90 body's log-sum-exp
(``sm90_lse_kernels``: at the prefill shapes of qwen2-7b,
recurrentgemma-9b, moonshot-v1-16b-a3b and llama4-scout-17b-a16e, S 300,
window, chunk, no mask and qwen2-vl-2b's train shape: the lse against
the plain one in fp32 within 2e-5 (1 + |lse|), O bit-equal with and
without it, and the gradients of the sm90 forward and the backward
(the sm90 backward body at dh 80 / 120 / 128, which each such case
must take) against autograd of mha_ref in fp32 within 2e-2 (1 + |x|); the
sm90 time with and without lse, and at qwen2-vl-2b's train shape the
forward and the sm90 backward (by kernel, at each head split of its dK/dV
launch, two runs bit for bit, beside the pair kernels forced as its
previous body) beside SDPA's bf16 ones (``library_ok``: whether SDPA's
own gradient holds the same tolerance) and their bounds, and the bf16
backward at dh 80 at stablelm-3b's heads), and the
kernels at this slice's own shapes (``modality_kernels``: rmsnorm at
hubert-xlarge's D 1280, its bf16 cta_rows backward at qwen2-vl-2b's step,
the flash sm90 body at hubert's 32k encode against mha_ref on its first
and last query rows, timed beside the mma body and SDPA's bf16 call, and
at dh 80 and 120 against mha_ref and timed at stablelm-3b's and
h2o-danube-3-4b's causal prefill); to
``serve_check`` and ``serve`` qwen2-vl-2b (4 layers fp32, also held
against the CPU; 28 layers bf16; a 16 x 16 image block in every prompt
of the serve, 8 x 8 in the check); to ``train_check`` qwen2-vl-2b and
hubert-xlarge at full width cut to 2 layers in fp32 (hubert's backward
non-causal at dh 80 on mma_tf32x3) and qwen2-vl-2b's step in bf16 against
the port's CPU step in bf16 (loss within 2e-2 relative, every gradient
leaf within 5e-2 in relative L2 norm).

Then a ``kernels`` summary line (launches summed over the serve and train
phases, and per path: each serve (the two MoE configs and qwen2-vl-2b
too, and serve-mamba2-p128), train-100m, train-mamba2, train-mamba2-p128,
train-rgemma-3l, train-qwen2vl-bf16,
train-qwen2vl-remat, train-stablelm3b-bf16, train-rgemma-bf16,
train-stablelm12b-bf16, encode-hubert, mesh), the card's
name and power limit as ``nvidia-smi`` prints them, and ``{"ok": true,
"device": {...}}`` last.  Any failed check exits non-zero; so does a
machine without a card.
"""
import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the card's constants and every kernel's bytes and operations come from
# the package (launch/roofline.py, each kernels/<name>/kernel.py)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_bwd_cost, flash_attention_cost)
from repro_torch.kernels.rglru.kernel import (  # noqa: E402
    rglru_bwd_cost, rglru_cost)
from repro_torch.kernels.rmsnorm.kernel import (  # noqa: E402
    rmsnorm_bwd_cost, rmsnorm_cost)
from repro_torch.kernels.ssd.kernel import (  # noqa: E402
    ssd_bwd_cost, ssd_bwd_macs, ssd_bwd_split_macs, ssd_cost, ssd_macs,
    ssd_split_macs)
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    bound_ms as bound, cost_bound_ms)
from repro_torch.launch.specs import SHAPES  # noqa: E402

# the reference's cells the train and encode phases cut from: train_4k's
# sequence (its global batch of 256 cut to 1) and prefill_32k's
TRAIN_4K = SHAPES["train_4k"].seq_len
PREFILL_32K = SHAPES["prefill_32k"].seq_len

HBM_BYTES_PER_S = roofline.HBM_BW
PEAK_OPS_PER_S = {torch.bfloat16: roofline.PEAK_OPS_PER_S["bf16"],
                  torch.float32: roofline.PEAK_OPS_PER_S["fp32"],
                  "tf32": roofline.PEAK_OPS_PER_S["tf32"]}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
RGLRU_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}
BF16_STEP = 2.0 ** -7     # one bf16 step (ulp) relative to the value
# the bf16 mamba2-130m prefill logits of the SSD mma body against the fma
# body, relative to the largest logit (phase_ssd_bodies): between the sound
# mma-vs-fma readings (0.0296-0.0321) and that of the plain phases with
# plain-bf16 operands (0.0371) on the H100 at seed 0 (PERF.md)
SSD_BODIES_REL = 0.035
SERVE_REL = 2e-4
# the card's train step against the CPU's: the loss and every gradient leaf,
# relative to the leaf's largest value (the JAX suite's decode-vs-forward
# bound, tests/test_models.py)
TRAIN_REL = 2e-4
# the serve phase's models, each (arch, layers, the cut): the dense and
# recurrent ones whole, then the MoE configs, moonshot-v1-16b-a3b whole
# (57.78 GB of bf16 weights) and llama4-scout-17b-a16e cut to its first
# superblock (3 chunked-attention layers and 1 global NoPE one), then
# qwen2-vl-2b whole, its prompts holding an image block (last, so that the
# others draw the weights they drew before it)
SERVES = (
    ("qwen2-7b", None, None),
    ("recurrentgemma-9b", None, None),
    ("mamba2-130m", None, None),
    ("moonshot-v1-16b-a3b", None, None),
    ("llama4-scout-17b-a16e", 4,
     "num_layers 48→4: 215.5 GB of bf16 weights exceed one 80 GB card"),
    ("qwen2-vl-2b", None, None))


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, msg: str):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def time_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


# the profiler windows each device_ms timing took (3 unless one was
# refused), each timing's sound windows' totals, ms a call, and how each
# timing was read: "windows", "launch_means" or "events"
PROFILER_WINDOWS = []
WINDOW_MS = []
TIMED_BY = []


def window_counts(start: int) -> dict:
    """Timings and profiler windows since ``PROFILER_WINDOWS[start]``, and
    how many of those timings were read otherwise than from whole windows."""
    w, by = PROFILER_WINDOWS[start:], TIMED_BY[start:]
    return dict(timings=len(w), windows=sum(w),
                by_launch_means=by.count("launch_means"),
                by_events=by.count("events"))


def _profiled_window(fn, calls: int) -> dict:
    """{name: (launches, device us)} of every kernel and copy ``calls``
    calls of ``fn`` ran on the card, under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            n, t = out.get(e.key, (0, 0.0))
            out[e.key] = (n + e.count, t + e.self_device_time_total)
    return out


def device_ms(fn, iters: int = 20, warmup: int = 3, windows: int = 3,
              tries: int = 10) -> float:
    """Device time of one call: every kernel and copy the call runs on the
    card, summed under torch.profiler over ``iters`` calls, per call; the
    median of ``windows`` profiler windows.  The profiler now and then
    keeps only part of a window's launches (6 of 20 SDPA calls once; one
    in three of the hubert-xlarge encode's attention, which it read at a
    third of its time) or none.  So the last warmup call, profiled alone
    (never the first call, which may run one-time kernels: cuDNN's SDPA
    ran 4 where later calls ran 2), counts each kernel's launches a call
    (or a window does, where that call lost some), and a window that holds
    other than ``iters`` times that of any kernel is refused and taken
    again, up to ``tries`` windows; the median of the whole ones is taken.
    Where none is whole, each kernel's mean time over the launches the
    windows kept, times its launches a call; where a kernel was never
    kept, ``time_ms``'s CUDA-event time.  Never a window known to be short.
    ``TIMED_BY`` records which, ``PROFILER_WINDOWS`` the windows each
    timing took, ``WINDOW_MS`` the whole windows' totals."""
    for _ in range(max(warmup - 1, 1)):
        fn()
    torch.cuda.synchronize()
    per_call = {k: n for k, (n, _) in _profiled_window(fn, 1).items()}
    taken, totals = [], []
    for window in range(1, tries + 1):
        taken.append(_profiled_window(fn, iters))
        for k, (n, _) in taken[-1].items():
            per_call[k] = max(per_call.get(k, 0), round(n / iters))
        calls = {k: m for k, m in per_call.items() if m}
        totals = [sum(w[k][1] for k in calls) / iters / 1e3 for w in taken
                  if calls and all(w.get(k, (0,))[0] == iters * m
                                   for k, m in calls.items())]
        if len(totals) == windows:
            break
    PROFILER_WINDOWS.append(window)
    WINDOW_MS.append(totals)
    kept = {k: (sum(w[k][0] for w in taken if k in w),
                sum(w[k][1] for w in taken if k in w)) for k in calls}
    if totals:
        TIMED_BY.append("windows")
        return statistics.median(totals)
    if calls and all(n for n, _ in kept.values()):
        TIMED_BY.append("launch_means")
        return sum(t / n * calls[k] for k, (n, t) in kept.items()) / 1e3
    TIMED_BY.append("events")
    return time_ms(fn, iters=iters, warmup=0)


def kernel_breakdown(fn, iters: int = 20, warmup: int = 3) -> dict:
    """Device time of each kernel one call runs, by kernel name (shortened
    to its name before the template arguments), per call: its mean over
    the launches a profiled window of ``iters`` calls kept, times its
    launches in the last warmup call, profiled alone.  The profiler drops
    launches from a window now and then (``device_ms``): a window's sum
    over ``iters`` read the sm90 backward's kernels 15-23% under
    ``device_ms`` (NVIDIA H100 80GB HBM3, 700.00 W)."""
    for _ in range(max(warmup - 1, 1)):
        fn()
    torch.cuda.synchronize()
    per_call = {k: n for k, (n, _) in _profiled_window(fn, 1).items()}
    out = {}
    for key, (n, t) in _profiled_window(fn, iters).items():
        if n and t > 0:
            name = key.replace("(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0].split()[-1]
            calls = per_call.get(key) or max(1, round(n / iters))
            out[name] = out.get(name, 0.0) + t / n * calls / 1e3
    return out


def ptxas_functions(log: str) -> dict:
    """{kernel: {"spills": ..., "registers": ...}} from ``-Xptxas=-v``."""
    out, lines = {}, log.splitlines()
    for i, line in enumerate(lines[:-2]):
        if "Function properties for" in line:
            out[line.split("Function properties for")[-1].strip()] = dict(
                spills=lines[i + 1].strip(),
                registers=lines[i + 2].split("info    : ")[-1])
    return out


def prefill_bound_ms(cfg, batch: int, prompt: int) -> float:
    """Least time of one prefill wave: the bf16 matmul FLOPs (every layer's
    parameters once per token, the attention of ``flops_parts``, the lm_head
    for the last position only) over the bf16 peak, plus the work the
    references keep in fp32 over the fp32 peak: the RG-LRU's two
    block-diagonal gates; the SSD scans count as the served (mma) body runs
    them, on the bf16 tensor cores (``ssd_split_macs``).  An MoE layer
    counts its active parameters (the router, the top-k experts of each
    token, the shared expert): the stacked expert products also run the
    capacity buffers' empty slots (E x C slots a row at a capacity factor
    of 1.25, so up to 1.25x the routed pairs), which lie above this bound,
    as the decode step's E x 1 slots lie above the weights-read bound of
    decode."""
    tokens = batch * prompt
    lm_head = cfg.vocab_size * cfg.d_model
    body = cfg.active_param_count() - lm_head * (1 if cfg.tie_embeddings
                                                 else 2)
    bf16 = (2 * tokens * body + 2 * batch * lm_head
            + cfg.flops_parts(tokens, training=False, seq_len=prompt)["attn"])
    kinds = cfg._layer_kinds()
    W = cfg.resolved_lru_width
    fp32 = kinds.count("rglru") * 2 * 2 * tokens * W * (W // cfg.num_heads)
    bf16 += kinds.count("ssd") * 2 * ssd_split_macs(
        batch, prompt, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
        cfg.ssm_state, cfg.ssm_chunk)
    return (bf16 / PEAK_OPS_PER_S[torch.bfloat16]
            + fp32 / PEAK_OPS_PER_S[torch.float32]) * 1e3


def ssd_inputs(randn, B, S, H, P, G, N, dtype):
    """(x, dt, A, Bm, Cm, D) of an SSD scan, drawn by ``randn(*shape,
    dtype=)``: x in ``dtype``, dt = softplus of a normal, A < 0, Bm and Cm
    of scale 0.3 in ``dtype``, D; dt, A and D fp32."""
    f32 = torch.float32
    return (randn(B, S, H, P, dtype=dtype),
            F.softplus(randn(B, S, H, dtype=f32)),
            -torch.exp(randn(H, dtype=f32) * 0.5),
            randn(B, S, G, N, dtype=f32).mul(0.3).to(dtype),
            randn(B, S, G, N, dtype=f32).mul(0.3).to(dtype),
            randn(H, dtype=f32))


def compare(got, want, dtype, tol=TOL) -> tuple:
    """(max abs error, within tolerance) with |got - want| <= t + t·|want|,
    in fp64 when ``want`` is fp64, else in fp32."""
    as_dtype = torch.float64 if want.dtype == torch.float64 else torch.float32
    got, want = got.to(as_dtype), want.to(as_dtype)
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= tol[dtype] * (1 + want.abs())).all())
    return float(err.max()), ok


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env(build):
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc_version = run([build.nvcc(), "--version"]).splitlines()[-1]
    t0 = time.monotonic()
    built = build.build()
    build_s = time.monotonic() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logs = {name: build.log_path(name).read_text() for name in build.sources()}
    ptxas = {name: [ln.split("info    : ")[-1] for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    sm90 = {name: f for name, f in
            ptxas_functions(logs["flash_attention"]).items()
            if "flash_attn_sm90_kernel" in name}
    emit("env", nvidia_smi=smi, python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc_version,
         tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                   cudnn=torch.backends.cudnn.allow_tf32),
         built=sorted(built), build_s=build_s, ptxas=ptxas, sm90_ptxas=sm90)
    # the sm90 forward's instances: dh 80, 128 (120 too), 160 and 256
    check(len(sm90) == 4 and all(
        "0 bytes spill stores, 0 bytes spill loads" in f["spills"]
        for f in sm90.values()), f"sm90 flash body spills: {sm90}")
    check("C7508" not in logs["flash_attention"],
          "ptxas ignored setmaxnreg (C7508) in flash_attention.cu")
    # the bf16 mma body's three kernels, the fp32 mma_tf32x3 body's chunk
    # scan (2: P up to 64 and up to 128; its chunk-state and C B^T kernels
    # are the backward's, below) and the RG-LRU segmented body's (2)
    scans = {name: f for src in ("ssd", "rglru")
             for name, f in ptxas_functions(logs[src]).items()
             if any(k in name for k in ("ssd_chunk_state", "ssd_state_pass",
                                        "ssd_chunk_scan", "rglru_segmented"))}
    emit("env", scan_ptxas=scans)
    check(len(scans) == 8 and all(
        "0 bytes spill stores, 0 bytes spill loads" in f["spills"]
        for f in scans.values()), f"a scan body spills: {scans}")
    # the backward kernels: flash's dQ and dK/dV at 4 compiled head dims up
    # to 80 (16, 32, 64, 80) and their pair kernels at 3 above (128 (120
    # too), 160, 256) x 2 dtypes (28), the bf16 sm90 body's dQ and dK/dV
    # kernels at 80, 128 (120 too), 160 and 256 (8) and the sum of the
    # dK/dV head split's partials (2); rmsnorm's warp_rows body (14: 4 type
    # pairs x vectors a lane 1,
    # 2, 4 and, for fp32 x, 8) and its dscale tree (2), its cta_rows body
    # (12: 2 scale types x vectors a lane 5-8 for fp32 x and 3-4 for bf16),
    # and the generic body (4 type pairs and 2 dscale sums)
    bwd = {name: f for src in ("flash_attention", "rmsnorm")
           for name, f in ptxas_functions(logs[src]).items()
           if any(k in name for k in (
               "flash_bwd_", "rmsnorm_bwd_kernel", "rmsnorm_dscale_kernel",
               "rmsnorm_bwd_rows_kernel", "rmsnorm_dscale_tree_kernel",
               "rmsnorm_bwd_cta_kernel"))}
    emit("env", backward_ptxas=bwd)
    check(len(bwd) == 72 and all(
        "0 bytes spill stores, 0 bytes spill loads" in f["spills"]
        for f in bwd.values()), f"a backward kernel spills: {bwd}")
    # the fp32 forward's mma_tf32x3 flash kernels, one a compiled head dim
    # (16, 32, 64, 80, 128 and, 8 warps a CTA, 160 and 256)
    tf32 = {name: f for name, f in
            ptxas_functions(logs["flash_attention"]).items()
            if "flash_attn_tf32_kernel" in name}
    emit("env", tf32_ptxas=tf32)
    check(len(tf32) == 7 and all(
        "0 bytes spill stores, 0 bytes spill loads" in f["spills"]
        for f in tf32.values()), f"an mma_tf32x3 flash kernel spills: {tf32}")
    # the scans' backward kernels: the SSD's chunk states, reverse state
    # pass, chunk gradients, parameter and slab sums (7: two dtypes each
    # but the two passes and the two sums), its group sums (4: two dtypes
    # x one or two slabs of P), the mma body's chunk states and C B^T
    # (ssd_state_mma_kernel and ssd_cb_kernel, which the fp32 forward's
    # mma_tf32x3 body shares: 6 and 3, two dtypes x one or two slabs for
    # the backward, the forward's one at each x stride) and chunk gradients
    # (6: two dtypes, at mamba2-130m's tile counts, at its P-128 variant's
    # and at any) and the RG-LRU's serial and segmented bodies (2 dtypes
    # each)
    scan_bwd = {name: f for src in ("ssd", "rglru")
                for name, f in ptxas_functions(logs[src]).items()
                if any(k in name for k in ("ssd_bwd_", "ssd_state_mma_kernel",
                                           "ssd_cb_kernel",
                                           "rglru_bwd_kernel",
                                           "rglru_bwd_segmented_kernel"))}
    emit("env", scan_backward_ptxas=scan_bwd)
    check(len(scan_bwd) == 30,
          f"{len(scan_bwd)} scan backward kernels built, not 30: "
          f"{sorted(scan_bwd)}")
    check(all("0 bytes spill stores, 0 bytes spill loads" in f["spills"]
              for f in scan_bwd.values()),
          f"a scan backward kernel spills: {scan_bwd}")
    return smi


def phase_kernels(dev, gen, seed):
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.kernel import \
        select_body as flash_body
    from repro_torch.kernels.flash_attention.ref import attention_mask, mha_ref
    from repro_torch.kernels.rglru import kernel as lru
    from repro_torch.kernels.rglru.kernel import rglru_cuda
    from repro_torch.kernels.rglru.kernel import select_body as lru_body
    from repro_torch.kernels.rglru.ref import rglru_assoc, rglru_sequential
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.kernel import select_body as rms_body
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.kernels.ssd.kernel import select_body as ssd_body
    from repro_torch.kernels.ssd.kernel import ssd_cuda
    from repro_torch.kernels.ssd.ref import (split_bf16, ssd_chunk_scan,
                                             ssd_chunk_state, ssd_chunked,
                                             ssd_sequential,
                                             ssd_state_passing)
    f32 = torch.float32

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cases, summary = [], {}

    # ---- rmsnorm: the served widths (mamba2-130m 768 and its gated norm's
    # 1536, qwen2-7b 3584, recurrentgemma-9b 4096) through the one-read
    # body, and an odd width (a 260-byte bf16 row) through the generic one;
    # decode rows (4) and prefill rows (4·512)
    eps = 1e-6

    def rms_cases(D, rnd):
        for dtype in (torch.float32, torch.bfloat16):
            for rows in (4, 4 * 512):
                x, s, r = rnd(rows, D, dtype=dtype), rnd(D, dtype=dtype), \
                    rnd(rows, D, dtype=dtype)
                for res in (None, r):
                    body = rms_body(x, s, res)[0]
                    err, ok = compare(
                        rmsnorm_cuda(x, s, eps=eps, residual=res),
                        rmsnorm_ref(x, s, eps=eps, residual=res), dtype)
                    want_body = ("generic" if D == 130 or D * x.itemsize
                                 > 16 * 32 * rms.VECTORS_PER_LANE[-1]
                                 else "one_read")
                    cases.append(dict(kernel="rmsnorm", body=body,
                                      dtype=str(dtype), rows=rows, D=D,
                                      residual=res is not None,
                                      max_abs_err=err, tol=TOL[dtype],
                                      ok=ok and body == want_body))

    for D in (768, 1536, 3584, 4096, 130):
        rms_cases(D, randn)
    timings, mark = {}, len(PROFILER_WINDOWS)
    # prefill rows at D 3584 first: the summary's shape
    for rows, D in ((4 * 512, 3584), (4, 3584), (4 * 512, 768),
                    (4 * 512, 1536), (4 * 512, 4096)):
        x, s = randn(rows, D, dtype=torch.bfloat16), \
            randn(D, dtype=torch.bfloat16)
        t_bound, by = cost_bound_ms(rmsnorm_cost(rows, D, x.dtype, s.dtype))
        kernel = lambda: rmsnorm_cuda(x, s, eps=eps)  # noqa: E731
        library = lambda: F.rms_norm(x, (D,), s, eps)  # noqa: E731
        y = torch.empty_like(x)
        generic = lambda: rms._entry()(  # noqa: E731
            x.data_ptr(), s.data_ptr(), None, y.data_ptr(), rows, D, eps, 1, 1,
            0, torch.cuda.current_stream().cuda_stream)
        timings[f"rows={rows} D={D} bf16"] = dict(
            body=rms_body(x, s)[0],
            ms=device_ms(kernel), event_ms=time_ms(kernel),
            previous_body_ms=device_ms(generic),
            plain_ms=device_ms(lambda: rmsnorm_ref(x, s, eps=eps)),
            library_ms=device_ms(library), library_event_ms=time_ms(library),
            bound_ms=t_bound, bound_by=by,
            max_abs_err=compare(kernel(), rmsnorm_ref(x, s, eps=eps),
                                torch.bfloat16)[0])
    summary["rmsnorm"] = dict(
        name="rmsnorm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm/kernel.py:33",
        shape="x (2048, 3584) bf16, scale bf16",
        **timings["rows=2048 D=3584 bf16"],
        profiler_windows=window_counts(mark))
    emit("kernels", kernel="rmsnorm", timings=timings)

    # ---- flash attention: qwen2-7b prefill shapes, ragged S, every head
    # dim of the registry (16 smoke, 80 stablelm-3b / hubert, 120
    # h2o-danube, 160 stablelm-12b, 256 recurrentgemma), window and chunk
    attn_cases = [
        (4, 512, 28, 4, 128, dict(causal=True)),
        (4, 512, 16, 1, 256, dict(causal=True, window=2048)),
        (1, 200, 28, 4, 128, dict(causal=True)),
        (2, 24, 28, 4, 128, dict(causal=True)),
        (2, 256, 8, 2, 32, dict(causal=True)),
        (2, 256, 8, 2, 64, dict(causal=True)),
        (1, 512, 8, 2, 128, dict(causal=True, window=100)),
        (1, 512, 8, 2, 128, dict(causal=True, chunk=128)),
        (2, 100, 4, 1, 16, dict(causal=True)),
        (1, 300, 32, 32, 80, dict(causal=True)),
        (1, 300, 32, 8, 120, dict(causal=True)),
        (1, 300, 32, 8, 160, dict(causal=True)),
        (1, 700, 16, 1, 256, dict(causal=True, window=300)),
        (1, 130, 4, 1, 256, dict(causal=False)),
    ]
    # the sm90 body (bf16, dh 128 and 256; dh 80 and 120 in
    # modality_kernels, dh 160 in SM90_LSE_CASES): ragged S, GQA 7:1 and
    # MQA 16:1, window and chunk edges inside tiles, no causal mask
    sm90_cases = [
        (1, 200, 28, 4, 128, dict(causal=True)),
        (1, 1000, 28, 4, 128, dict(causal=True)),
        (1, 200, 16, 1, 256, dict(causal=True)),
        (1, 1000, 16, 1, 256, dict(causal=True, window=2048)),
        (2, 512, 28, 4, 128, dict(causal=True, window=100)),
        (1, 1000, 16, 1, 256, dict(causal=True, window=300)),
        (1, 512, 28, 4, 128, dict(causal=True, chunk=96)),
        (1, 1000, 16, 1, 256, dict(causal=True, chunk=128)),
        (2, 300, 28, 4, 128, dict(causal=False)),
        (1, 200, 16, 1, 256, dict(causal=False)),
    ]

    def attn_case(q, k, v, kw, want_body=None, **info):
        body = flash_body(q, k, v)
        err, ok = compare(flash_attention_cuda(q, k, v, **kw),
                          mha_ref(q, k, v, **kw), q.dtype)
        B, S, H, dh = q.shape
        cases.append(dict(kernel="flash_attention", body=body,
                          dtype=str(q.dtype), B=B, S=S, H=H, K=k.shape[2],
                          dh=dh, **kw, **info, max_abs_err=err,
                          tol=TOL[q.dtype],
                          ok=ok and body == (want_body or body)))

    for B, S, H, K, dh, kw in attn_cases:
        for dtype in (torch.float32, torch.bfloat16):
            attn_case(randn(B, S, H, dh, dtype=dtype),
                      randn(B, S, K, dh, dtype=dtype),
                      randn(B, S, K, dh, dtype=dtype), kw)

    def sm90_case(B, S, H, K, dh, kw, rnd, **info):
        attn_case(rnd(B, S, H, dh, dtype=torch.bfloat16),
                  rnd(B, S, K, dh, dtype=torch.bfloat16),
                  rnd(B, S, K, dh, dtype=torch.bfloat16), kw, "sm90", **info)

    for B, S, H, K, dh, kw in sm90_cases:
        sm90_case(B, S, H, K, dh, kw, randn)
    for H, K, dh in ((28, 4, 128), (16, 1, 256)):
        # q, k, v as views of one fused projection, read through strides
        qkv = randn(2, 300, (H + 2 * K) * dh, dtype=torch.bfloat16)
        q, k, v = (t.unflatten(-1, (-1, dh))
                   for t in qkv.split([H * dh, K * dh, K * dh], dim=-1))
        attn_case(q, k, v, dict(causal=True), "sm90", fused_views=True)
    # the MoE serves' shapes, from a generator of their own so the later
    # phases draw what they drew before: rmsnorm at moonshot-v1-16b-a3b's D
    # 2048 and llama4-scout-17b-a16e's 5120 (bf16: one-read, 20 of its 32
    # vectors a lane in use; an fp32 row of 5120, 20 KB, is past the
    # body's 16 KB and takes the generic one); the sm90 body at their
    # prefill shapes and a ragged S of each: moonshot's MHA 16/16,
    # llama4's GQA 40/8 in its chunked layers (chunk 8192) and its global
    # NoPE one
    moe_gen = torch.Generator(device=dev).manual_seed(seed + 4)

    def moe_randn(*shape, dtype):
        return torch.randn(shape, generator=moe_gen, device=dev).to(dtype)

    for D in (2048, 5120):
        rms_cases(D, moe_randn)
    for arch, (B, S, H, K, dh, kw) in (
            ("moonshot-v1-16b-a3b", (4, 512, 16, 16, 128, dict(causal=True))),
            ("moonshot-v1-16b-a3b", (1, 300, 16, 16, 128, dict(causal=True))),
            ("llama4-scout-17b-a16e",
             (4, 512, 40, 8, 128, dict(causal=True, chunk=8192))),
            ("llama4-scout-17b-a16e",
             (1, 300, 40, 8, 128, dict(causal=True, chunk=8192))),
            ("llama4-scout-17b-a16e",
             (4, 512, 40, 8, 128, dict(causal=True)))):
        sm90_case(B, S, H, K, dh, kw, moe_randn, arch=arch)
    timings, mark = {}, len(PROFILER_WINDOWS)
    for arch, (B, S, H, K, dh, kw) in zip(("qwen2-7b", "recurrentgemma-9b"),
                                          attn_cases[:2]):
        q, k, v = randn(B, S, H, dh, dtype=torch.bfloat16), \
            randn(B, S, K, dh, dtype=torch.bfloat16), \
            randn(B, S, K, dh, dtype=torch.bfloat16)
        pos = torch.arange(S, device=dev)
        pairs = int(attention_mask(pos, pos, **kw).sum())
        t_bound, by = cost_bound_ms(flash_attention_cost(
            B, S, H, K, dh, q.dtype, pairs))
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        kernel = lambda: flash_attention_cuda(q, k, v, **kw)  # noqa: E731
        # SDPA with is_causal: the window of 2048 covers all 512 keys
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        out = torch.empty_like(q)
        mma = lambda: flash._entry("flash_attention_fwd")(  # noqa: E731
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
            K, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], 1,
            kw.get("window", 0), 0, dh ** -0.5, dh, 1, None,
            torch.cuda.current_stream().cuda_stream)
        timings[arch] = dict(
            shape=f"q ({B},{S},{H},{dh}) k/v ({B},{S},{K},{dh}) bf16 "
                  + " ".join(f"{n}={x}" for n, x in kw.items()),
            body=flash_body(q, k, v),
            ms=device_ms(kernel), event_ms=time_ms(kernel),
            previous_body_ms=device_ms(mma),
            previous_body_event_ms=time_ms(mma),
            plain_ms=device_ms(lambda: mha_ref(q, k, v, **kw)),
            library_ms=device_ms(library), library_event_ms=time_ms(library),
            bound_ms=t_bound, bound_by=by,
            max_abs_err=compare(kernel(), mha_ref(q, k, v, **kw),
                                torch.bfloat16)[0])
    summary["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:99",
        **timings["qwen2-7b"], by_arch=timings,
        profiler_windows=window_counts(mark))
    emit("kernels", kernel="flash_attention", timings=timings)
    # the fp32 forward (the train path's body, mma_tf32x3), from a
    # generator of its own
    flash_fp32_kernels(dev, torch.Generator(device=dev).manual_seed(seed + 3),
                       cases, summary)

    # ---- RG-LRU scan: recurrentgemma-9b widths (W 4096) and a ragged W,
    # prefill (S 512), the serve_check prompt (2176), ragged S and decode
    # (S 1), with and without h0, on both bodies: the segmented body against
    # rglru_assoc, the serial body against rglru_sequential
    plain_lru = {"segmented": rglru_assoc, "serial": rglru_sequential}
    for dtype in (torch.float32, torch.bfloat16):
        for S in (1, 37, 512, 2176):
            for W in (4096, 200):
                la = -F.softplus(randn(4, S, W, dtype=torch.float32)).to(dtype)
                gx = randn(4, S, W, dtype=dtype)
                for h0 in (None, randn(4, W, dtype=torch.float32)):
                    for body, plain in plain_lru.items():
                        y, h_last = rglru_cuda(la, gx, h0, body=body)
                        want_y, want_h = plain(la, gx, h0)
                        err_y, ok_y = compare(y, want_y, dtype, RGLRU_TOL)
                        err_h, ok_h = compare(h_last, want_h, torch.float32,
                                              RGLRU_TOL)
                        cases.append(dict(
                            kernel="rglru", body=body,
                            selected=lru_body(la, gx, h0), dtype=str(dtype),
                            B=4, S=S, W=W, h0=h0 is not None,
                            max_abs_err=max(err_y, err_h),
                            tol=RGLRU_TOL[dtype], ok=ok_y and ok_h))
    timings, mark = {}, len(PROFILER_WINDOWS)
    for S in (512, 1):
        B, W = 4, 4096
        la = -F.softplus(randn(B, S, W, dtype=torch.float32))
        gx, h0 = randn(B, S, W, dtype=torch.float32), \
            randn(B, W, dtype=torch.float32)
        # bytes: la, gx and h0 read once, y and h_last written once; about 9
        # operations an element (2 exp, sqrt, max, sub, 3 mul, add)
        t_bound, by = cost_bound_ms(rglru_cost(B, S, W, gx.dtype, h0=True))
        y, h_last = torch.empty_like(gx), torch.empty_like(h0)
        stream = torch.cuda.current_stream().cuda_stream

        serial = lambda: lru._entry("rglru_fwd")(  # noqa: E731
            la.data_ptr(), gx.data_ptr(), h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), B, S, W, 0, stream)

        kernel = lambda: rglru_cuda(la, gx, h0)  # noqa: E731
        body = lru_body(la, gx, h0)
        t = dict(shape=f"log_a, gx ({B},{S},{W}) fp32, h0 ({B},{W}) fp32",
                 body=body, ms=device_ms(kernel), event_ms=time_ms(kernel))
        if body == "segmented":
            t["previous_body_ms"] = device_ms(serial)
        plain = plain_lru[body]
        t.update(plain_ms=device_ms(lambda: plain(la, gx, h0), iters=5),
                 library_ms=None, bound_ms=t_bound, bound_by=by,
                 max_abs_err=compare(kernel()[0], plain(la, gx, h0)[0],
                                     torch.float32, RGLRU_TOL)[0])
        timings[f"S={S}"] = t
    summary["rglru"] = dict(
        name="rglru", route="cuda", source="src/repro_torch/csrc/rglru.cu",
        replaces="src/repro/kernels/rglru/kernel.py:50",
        **timings["S=512"], decode=timings["S=1"],
        profiler_windows=window_counts(mark))
    emit("kernels", kernel="rglru", timings=timings)

    # ---- SSD scan: mamba2-130m's head and state dims (P 64, N 128), a
    # ragged S (padded last chunk), two groups, chunk 64 and 128, a chunk
    # that is not a multiple of 16; y and the fp32 final state against
    # ssd_chunked (S a multiple of the chunk) or ssd_sequential (ragged S),
    # on each body that takes the inputs (mma: bf16; mma_tf32x3: fp32;
    # fma: both)
    def ssd_holds(draw, shapes, picks=False):
        """Each shape on each body, fp32 and bf16; with ``picks`` the body
        ``select_body`` picks must be the dtype's tensor-core body."""
        for dtype in (torch.float32, torch.bfloat16):
            for B, S, H, P, G, N, chunk in shapes:
                args = ssd_inputs(draw, B, S, H, P, G, N, dtype)
                want_y, want_state = (
                    ssd_chunked(*args, chunk=chunk) if S % chunk == 0
                    else ssd_sequential(*args))
                selected = ssd_body(*args, chunk)
                for body in ssd.bodies_for(*args, chunk):
                    y, state = ssd_cuda(*args, chunk=chunk, body=body)
                    err_y, ok_y = compare(y, want_y, dtype, SSD_TOL)
                    err_s, ok_s = compare(state, want_state, dtype, SSD_TOL)
                    cases.append(dict(
                        kernel="ssd", body=body, selected=selected,
                        dtype=str(dtype), B=B, S=S, H=H, P=P, G=G, N=N,
                        chunk=chunk, tile=ssd.ssd_tile(chunk),
                        max_abs_err=max(err_y, err_s), tol=SSD_TOL[dtype],
                        ok=ok_y and ok_s and (not picks or selected == (
                            "mma_tf32x3" if dtype == f32 else "mma"))))

    ssd_holds(randn, [(4, 512, 24, 64, 1, 128, 128),
                      (2, 1000, 24, 64, 1, 128, 128),
                      (2, 256, 8, 64, 2, 128, 64),
                      (1, 300, 4, 32, 2, 64, 64),
                      (1, 90, 3, 24, 3, 8, 20),
                      (1, 64, 2, 128, 1, 32, 32)])
    # head, state and chunk 128 (mamba2-130m at MAMBA2_P128's head dim), and
    # its chunk of 256, run at a tile of 128 and held against the plain scan
    # at 256 (ragged: the sequential scan), at head dims 128 and 64; from a
    # generator of their own, so the later phases draw what they drew
    # before these cases
    g_p128 = torch.Generator(device=dev).manual_seed(seed + 7)
    ssd_holds(lambda *shape, dtype: torch.randn(
        shape, generator=g_p128, device=dev).to(dtype),
        [(2, 512, 12, 128, 1, 128, 128), (2, 1024, 12, 128, 1, 128, 256),
         (2, 1000, 12, 128, 1, 128, 256), (2, 1024, 24, 64, 1, 128, 256)],
        picks=True)
    # fp32 at mamba2-130m's train shape (the body its train step runs:
    # mma_tf32x3, and the fma body forced, its previous one), drawn from a
    # generator of its own so the later phases draw what they drew before
    # this case existed; then the fp32 forward timed there
    g_train = torch.Generator(device=dev).manual_seed(seed + 2)
    B, S, H, P, G, N, chunk = 8, 1024, 24, 64, 1, 128, 128
    train_args = ssd_inputs(lambda *shape, dtype: torch.randn(
        shape, generator=g_train, device=dev).to(dtype),
        B, S, H, P, G, N, f32)
    want_y, want_state = ssd_chunked(*train_args, chunk=chunk)
    for body in ssd.bodies_for(*train_args, chunk):
        y, state = ssd_cuda(*train_args, chunk=chunk, body=body)
        err_y, ok_y = compare(y, want_y, f32, SSD_TOL)
        err_s, ok_s = compare(state, want_state, f32, SSD_TOL)
        cases.append(dict(kernel="ssd", body=body,
                          selected=ssd_body(*train_args, chunk),
                          dtype=str(f32), B=B, S=S, H=H, P=P, G=G, N=N,
                          chunk=chunk, max_abs_err=max(err_y, err_s),
                          tol=SSD_TOL[f32], ok=ok_y and ok_s and ssd_body(
                              *train_args, chunk) == "mma_tf32x3"))
    ssd_fp32_kernels(dev, train_args, chunk, cases, summary)
    del train_args, want_y, want_state, y, state
    B, S, H, P, G, N, Q = 4, 512, 24, 64, 1, 128, 128
    args = ssd_inputs(randn, B, S, H, P, G, N, torch.bfloat16)
    x, dt, A, Bm, Cm, D = args
    nc = -(-S // Q)
    stream = torch.cuda.current_stream().cuda_stream
    y, state = torch.empty_like(x), torch.empty(B, H, P, N, device=dev)
    states = torch.empty(B, nc, H, P, N, device=dev)
    cum = torch.empty(B, H, nc * Q, device=dev)
    ptr = {n: t.data_ptr() for n, t in dict(
        x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, D=D, y=y, state=state, states=states,
        cum=cum).items()}

    def phase(name):
        e = ssd._entry(name)
        a = {"ssd_chunk_state": ("x", "dt", "A", "Bm", "states", "cum"),
             "ssd_state_pass": ("states", "cum", "state"),
             "ssd_chunk_scan": ("x", "dt", "Bm", "Cm", "D", "cum", "states",
                                "y")}[name]
        dims = {"ssd_chunk_state": (B, S, H, P, G, N, Q),
                "ssd_state_pass": (B, S, H, P, N, Q),
                "ssd_chunk_scan": (B, S, H, P, G, N, Q)}[name]
        return lambda: check(e(*(ptr[n] for n in a), *dims, stream) == 0,
                             f"{name} launch failed")

    # each phase kernel against its plain phase, on the kernel's own inputs
    phase("ssd_chunk_state")()
    want_states, want_cum = ssd_chunk_state(x, dt, A, Bm, chunk=Q)
    local_states = states.clone()
    phase("ssd_state_pass")()
    want_in, want_state = ssd_state_passing(local_states, cum, chunk=Q)
    phase("ssd_chunk_scan")()
    scan_in = states.clone()
    scan_in[:, 0] = 0   # the state entering chunk 0, which the kernel skips
    want_y = ssd_chunk_scan(x, dt, Bm, Cm, D, cum, scan_in, chunk=Q)
    # the same with the fp32 operands (scores, state) split into bf16 hi +
    # lo as the kernel splits them: y within one bf16 step (2^-7) of it,
    # which rounding them to plain bf16 exceeds at mamba2's widths
    # (tests/test_torch_kernels.py::test_ssd_one_bf16_step_tells_split_...)
    want_y_split = ssd_chunk_scan(x, dt, Bm, Cm, D, cum, scan_in, chunk=Q,
                                  round_operand=split_bf16)
    for name, got, want, tol in (
            ("ssd_chunk_scan split", y, want_y_split, BF16_STEP),
            ("ssd_chunk_state", local_states, want_states, SSD_TOL[f32]),
            ("ssd_chunk_state cum", cum, want_cum, SSD_TOL[f32]),
            # the state entering chunk 0 is zero; the kernel neither writes
            # nor reads it
            ("ssd_state_pass", states[:, 1:], want_in[:, 1:], SSD_TOL[f32]),
            ("ssd_state_pass final", state, want_state, SSD_TOL[f32]),
            ("ssd_chunk_scan", y, want_y, SSD_TOL[torch.bfloat16])):
        err, ok = compare(got, want, f32, {f32: tol})
        cases.append(dict(kernel="ssd", body="mma", phase=name, B=B, S=S,
                          H=H, P=P, G=G, N=N, chunk=Q, max_abs_err=err,
                          tol=tol, ok=ok))
    # bytes: x, dt, Bm, Cm, A, D read once, y and the fp32 state written
    # once; operations: the mma body's products on the bf16 tensor cores,
    # the split operands' twice.  The fp32 multiply-adds the function needs
    # on the FMA units (the fma body's way) are a bound of that body only.
    t_bound, by = cost_bound_ms(ssd_cost(B, S, H, P, G, N, Q, x.dtype))
    kernel = lambda: ssd_cuda(*args, chunk=Q)  # noqa: E731
    mark = len(PROFILER_WINDOWS)
    fma = lambda: ssd._entry("ssd_fwd")(  # noqa: E731
        ptr["x"], ptr["dt"], ptr["A"], ptr["Bm"], ptr["Cm"], ptr["D"],
        ptr["y"], ptr["state"], B, S, H, P, G, N, Q, 1, stream)
    summary["ssd"] = dict(
        name="ssd", route="cuda", source="src/repro_torch/csrc/ssd.cu",
        replaces="src/repro/kernels/ssd/kernel.py:71",
        shape=f"x ({B},{S},{H},{P}) bf16, dt ({B},{S},{H}) fp32, "
              f"Bm/Cm ({B},{S},{G},{N}) bf16, chunk {Q}",
        body=ssd_body(*args, Q), ms=device_ms(kernel),
        event_ms=time_ms(kernel), previous_body_ms=device_ms(fma),
        phase_ms={n: device_ms(phase(n)) for n in (
            "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")},
        plain_ms=device_ms(lambda: ssd_chunked(*args, chunk=Q), iters=10),
        library_ms=None, bound_ms=t_bound, bound_by=by,
        fma_bound_fp32_ops_ms=2 * ssd_macs(B, S, H, P, G, N, Q)
        / PEAK_OPS_PER_S[torch.float32] * 1e3,
        max_abs_err=compare(kernel()[0], ssd_chunked(*args, chunk=Q)[0],
                            torch.bfloat16, SSD_TOL)[0])
    summary["ssd"]["profiler_windows"] = window_counts(mark)
    emit("kernels", kernel="ssd", timings={
        summary["ssd"]["shape"]: {k: v for k, v in summary["ssd"].items()
                                  if k not in ("name", "route", "source",
                                               "replaces", "shape")}})
    # a generator of its own, so the later phases draw what they drew
    # before the backward cases existed
    backward_kernels(dev, torch.Generator(device=dev).manual_seed(seed + 1),
                     cases, summary)
    sm90_lse_kernels(dev, torch.Generator(device=dev).manual_seed(seed + 5),
                     cases, summary)
    modality_kernels(dev, torch.Generator(device=dev).manual_seed(seed + 6),
                     cases, summary)
    emit("kernels", cases=cases)
    bad = [c for c in cases if not c["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")
    return summary


def ssd_fp32_kernels(dev, args, Q, cases, summary):
    """The fp32 SSD forward at mamba2-130m's train shape (``args``, x
    (8,1024,24,64), chunk ``Q``): the mma_tf32x3 body's chunk scan against
    the plain phases with every product formed as it forms them
    (``product=split_einsum(..., truncate_tf32)``) and against the exact
    fp32 phases (both from the split chunk states), at the SSD tolerance;
    then its device
    time (and by kernel) beside the fma body's (its previous body), the
    plain scan's and its bounds: operations, ``ssd_macs`` each three TF32
    products at the TF32 rate (``fma_bound_ms``: the same once each at the
    fp32 FMA rate, the fma body's), bytes."""
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.kernels.ssd.ref import (split_einsum, ssd_chunk_scan,
                                             ssd_chunk_state, ssd_chunked,
                                             ssd_state_passing,
                                             truncate_tf32)
    f32 = torch.float32
    x, dt, A, Bm, Cm, D = args
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]

    def split(eq, a, b):
        return split_einsum(eq, a, b, truncate_tf32)

    y, _ = ssd.ssd_cuda(*args, chunk=Q)
    states, cum = ssd_chunk_state(x, dt, A, Bm, chunk=Q, product=split)
    states_in, _ = ssd_state_passing(states, cum, chunk=Q)
    for name, product in (("split products", split),
                          ("exact fp32", torch.einsum)):
        want = ssd_chunk_scan(x, dt, Bm, Cm, D, cum, states_in, chunk=Q,
                              product=product)
        err, ok = compare(y, want, f32, SSD_TOL)
        cases.append(dict(kernel="ssd", body="mma_tf32x3",
                          phase=f"chunk scan vs plain phases, {name}", B=B,
                          S=S, H=H, P=P, G=G, N=N, chunk=Q, max_abs_err=err,
                          tol=SSD_TOL[f32], ok=ok))
    del states, cum, states_in, want
    macs = ssd_macs(B, S, H, P, G, N, Q)
    # bytes: x, dt, Bm, Cm (A, D) read once, y and the fp32 state written once
    cost = ssd_cost(B, S, H, P, G, N, Q, f32)
    t_bound, by = cost_bound_ms(cost)
    fma_bound, fma_by = bound(cost.bytes, cost.flops, f32)
    kernel = lambda: ssd.ssd_cuda(*args, chunk=Q)  # noqa: E731
    previous = lambda: ssd.ssd_cuda(*args, chunk=Q,  # noqa: E731
                                    body="fma")
    mark = len(PROFILER_WINDOWS)
    summary["ssd_fwd_fp32"] = dict(
        name="ssd_fwd_fp32", route="cuda",
        source="src/repro_torch/csrc/ssd.cu",
        replaces="src/repro/kernels/ssd/kernel.py:71",
        shape=f"x ({B},{S},{H},{P}) fp32, dt ({B},{S},{H}), Bm/Cm "
              f"({B},{S},{G},{N}) fp32, chunk {Q} (the mamba2-130m step)",
        counted_as=("ssd", "mma_tf32x3"),
        body=ssd.select_body(*args, Q), ms=device_ms(kernel),
        event_ms=time_ms(kernel), kernel_ms=kernel_breakdown(kernel),
        previous_body="fma", previous_body_ms=device_ms(previous),
        previous_body_event_ms=time_ms(previous),
        plain_ms=device_ms(lambda: ssd_chunked(*args, chunk=Q), iters=5,
                           warmup=1),
        library_ms=None, bound_ms=t_bound, bound_by=by,
        fma_bound_ms=fma_bound, fma_bound_by=fma_by, macs=macs,
        max_abs_err=compare(kernel()[0], ssd_chunked(*args, chunk=Q)[0], f32,
                            SSD_TOL)[0],
        profiler_windows=window_counts(mark))
    emit("kernels", kernel="ssd_fwd_fp32", timings={
        summary["ssd_fwd_fp32"]["shape"]: summary["ssd_fwd_fp32"]})


def flash_fp32_kernels(dev, gen, cases, summary):
    """The fp32 flash-attention forward's mma_tf32x3 body against
    ``mha_ref`` and the fp32 FMA body forced on the same inputs (o and the
    log-sum-exp, 2e-5) at the 100m step's shape and at window / chunk
    masks, GQA 8, MQA and ragged S at every head dim (8 warps a CTA at 160
    and 256); then its device
    time with the log-sum-exp (the train path's call) at the 100m shape
    beside the fp32 body's (its previous body), the plain version's and
    SDPA's fp32 forward (TF32 off), and its bounds: bytes (q, k, v read, o
    and lse written) or operations, the two products of the visible pairs
    each three TF32 products at the TF32 rate (``fma_bound_ms``: once each
    at the fp32 FMA rate)."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         lse_ref, mha_ref)
    f32 = torch.float32

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for B, S, H, K, dh, kw in [
            (16, 256, 8, 4, 64, dict(causal=True)),
            (16, 256, 8, 4, 64, dict(causal=True, window=50)),
            (16, 256, 8, 4, 64, dict(causal=True, chunk=48)),
            (2, 100, 4, 1, 16, dict(causal=True)),
            (2, 128, 8, 4, 32, dict(causal=True, window=33)),
            (1, 300, 32, 32, 80, dict(causal=True)),
            (2, 190, 16, 2, 80, dict(causal=True, chunk=40)),
            (1, 200, 8, 1, 120, dict(causal=True)),
            (1, 333, 8, 2, 128, dict(causal=True, window=100)),
            (1, 130, 4, 4, 128, dict(causal=False)),
            # 8 warps a CTA: GQA, MQA, window, chunk, ragged S
            (1, 200, 8, 2, 160, dict(causal=True)),
            (1, 130, 4, 4, 160, dict(causal=True, chunk=48)),
            (2, 300, 8, 1, 256, dict(causal=True, window=100)),
            (1, 100, 4, 1, 256, dict(causal=False))]:
        q, k, v = randn(B, S, H, dh), randn(B, S, K, dh), randn(B, S, K, dh)
        body = flash.select_body(q, k, v)
        out, lse = flash.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        prev, prev_lse = flash.flash_attention_cuda(
            q, k, v, return_lse=True, body="fp32", **kw)
        errs = [compare(out, mha_ref(q, k, v, **kw), f32),
                compare(lse, lse_ref(q, k, **kw), f32),
                compare(out, prev, f32), compare(lse, prev_lse, f32)]
        cases.append(dict(kernel="flash_attention", body=body,
                          dtype=str(f32), B=B, S=S, H=H, K=K, dh=dh, **kw,
                          max_abs_err=max(e for e, _ in errs),
                          errs=[e for e, _ in errs], tol=TOL[f32],
                          ok=all(ok for _, ok in errs)
                          and body == "mma_tf32x3"))
    B, S, H, K, dh = 16, 256, 8, 4, 64
    q, k, v = randn(B, S, H, dh), randn(B, S, K, dh), randn(B, S, K, dh)
    pos = torch.arange(S, device=dev)
    pairs = int(attention_mask(pos, pos, causal=True).sum())
    cost = flash_attention_cost(B, S, H, K, dh, f32, pairs, lse=True)
    t_bound, by = cost_bound_ms(cost)
    fma_bound, fma_by = bound(cost.bytes, cost.flops, f32)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    kernel = lambda: flash.flash_attention_cuda(  # noqa: E731
        q, k, v, return_lse=True)
    previous = lambda: flash.flash_attention_cuda(  # noqa: E731
        q, k, v, return_lse=True, body="fp32")
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    mark = len(PROFILER_WINDOWS)
    summary["flash_attention_fwd_fp32"] = dict(
        name="flash_attention_fwd_fp32", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:99",
        shape=f"q ({B},{S},{H},{dh}) k/v ({B},{S},{K},{dh}) fp32 causal, "
              "with lse (the 100m step)",
        counted_as=("flash_attention", "mma_tf32x3", (dh,)),
        body=flash.select_body(q, k, v), ms=device_ms(kernel),
        event_ms=time_ms(kernel), previous_body="fp32",
        previous_body_ms=device_ms(previous),
        previous_body_event_ms=time_ms(previous),
        plain_ms=device_ms(lambda: mha_ref(q, k, v)),
        library="F.scaled_dot_product_attention fp32, TF32 off",
        library_ms=device_ms(library), library_event_ms=time_ms(library),
        bound_ms=t_bound, bound_by=by, fma_bound_ms=fma_bound,
        fma_bound_by=fma_by,
        max_abs_err=compare(kernel()[0], mha_ref(q, k, v), f32)[0],
        library_max_abs_err=compare(library().transpose(1, 2),
                                    mha_ref(q, k, v), f32)[0],
        profiler_windows=window_counts(mark))
    emit("kernels", kernel="flash_attention_fwd_fp32", timings={
        summary["flash_attention_fwd_fp32"]["shape"]:
            summary["flash_attention_fwd_fp32"]})


def _grad_ms(out, inputs, grad_out):
    """The backward alone of a recorded graph: a function that computes
    d(out)/d(inputs) for ``grad_out`` (the graph is kept for the next call)."""
    return lambda: torch.autograd.grad(out, inputs, grad_out,
                                       retain_graph=True)


def backward_kernels(dev, gen, cases, summary):
    """The backward kernels against their plain versions on the same inputs
    (bf16 inputs too: the plain versions then compute in fp32 from them),
    at the kernel tolerances: RMSNorm against autograd of its function in
    fp64 (``rmsnorm_f64``), flash attention against autograd of mha_ref,
    the SSD and RG-LRU scans against
    ssd_chunked_bwd / rglru_bwd; then timed at their training shapes (the
    100m preset's; mamba2-130m's and recurrentgemma-9b's for the scans)
    beside the plain version and the library call where there is one
    (autograd of F.rms_norm / SDPA at the same dtype; none for the
    scans)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention.kernel import (
        SM90_BWD_HEAD_DIMS, SM90_HEAD_DIMS as SM90_DH,
        flash_attention_bwd_cuda, flash_attention_cuda, select_bwd_body)
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         lse_ref, mha_ref)
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.kernels.rmsnorm.kernel import (RMSNormFunction,
                                                    rmsnorm_bwd_cuda)
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    f32 = torch.float32

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def plain_grads(fn, inputs, grad_out, dtype=f32, **kw):
        leaves = [t.to(dtype).requires_grad_() for t in inputs]
        return torch.autograd.grad(fn(*leaves, **kw), leaves,
                                   grad_out.to(dtype))

    def rmsnorm_f64(x, scale, residual=None):
        """rmsnorm_ref's function in fp64: the plain version the RMSNorm
        backward is held against, since rmsnorm_ref's own fp32 dscale
        strays from the exact sum by up to 1.7x the 2e-5 tolerance at
        8192 rows."""
        y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * scale
        return y if residual is None else y + residual

    f64 = torch.float64

    # ---- rmsnorm backward: the train widths (64, 256, 512: smoke, small,
    # 100m) and the served 768 on the warp_rows body; the served 3584 and a
    # 2048 on the cta_rows body, an odd width on the generic body; the 100m
    # step's rows; in fp32 also the recurrent train steps' shapes:
    # mamba2-130m's norm1 (8192, 768, warp_rows) and gated norm (8192,
    # 1536, cta_rows), recurrentgemma-9b's (2048, 4096, cta_rows)
    recurrent_train = ((8192, 768), (8192, 1536), (2048, 4096))
    for dtype in (f32, torch.bfloat16):
        for rows, D in ((4096, 512), (1024, 256), (64, 64), (300, 768),
                        (8, 3584), (33, 130), (6, 2048),
                        *(recurrent_train if dtype == f32 else ())):
            x, dy = (randn(rows, D, dtype=dtype) for _ in range(2))
            s = randn(D, dtype=dtype)
            body = rms.select_bwd_body(x, s, dy)[0]
            got = rmsnorm_bwd_cuda(x, s, dy)
            want = plain_grads(rmsnorm_f64, (x, s), dy, f64)
            errs = [compare(g, w, dtype) for g, w in zip(got, want)]
            again = rmsnorm_bwd_cuda(x, s, dy)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            want_body = ("generic" if D == 130 else "warp_rows" if D <= 1024
                         else "cta_rows")
            cases.append(dict(kernel="rmsnorm_bwd", body=body,
                              dtype=str(dtype), rows=rows, D=D,
                              max_abs_err=max(e for e, _ in errs),
                              tol=TOL[dtype], deterministic=same,
                              ok=all(ok for _, ok in errs) and same
                              and body == want_body))
    # through the autograd Function with a residual: d_residual is dy
    x, r, dy = (randn(64, 512, dtype=f32) for _ in range(3))
    s = randn(512, dtype=f32)
    xg, rg, sg = (t.clone().requires_grad_() for t in (x, r, s))
    RMSNormFunction.apply(xg, sg, rg, 1e-6).backward(dy)
    want = plain_grads(rmsnorm_f64, (x, s, r), dy, f64)
    errs = [compare(g, w, f32) for g, w in zip((xg.grad, sg.grad, rg.grad),
                                               want)]
    cases.append(dict(kernel="rmsnorm_bwd", dtype="torch.float32", rows=64,
                      D=512, residual=True,
                      max_abs_err=max(e for e, _ in errs), tol=TOL[f32],
                      ok=all(ok for _, ok in errs)))

    rows, D = 4096, 512
    x, dy = (randn(rows, D, dtype=f32) for _ in range(2))
    s = randn(D, dtype=f32)
    xr, sr = x.clone().requires_grad_(), s.clone().requires_grad_()
    plain_out = rmsnorm_ref(xr, sr)
    lib_out = F.rms_norm(xr, (D,), sr, 1e-6)
    kernel = lambda: rmsnorm_bwd_cuda(x, s, dy)  # noqa: E731
    # PR 16's body (the generic one) on the same inputs, through its entry
    dx, ds = torch.empty_like(x), torch.empty_like(s)
    partial = torch.empty((2, rms.BWD_MAX_BLOCKS, D), device=dev)
    generic = lambda: rms._bwd_entry("generic")(  # noqa: E731
        x.data_ptr(), s.data_ptr(), dy.data_ptr(), dx.data_ptr(), ds.data_ptr(),
        partial.data_ptr(), rows, D, 1e-6, 0, 0, rms.BWD_MAX_BLOCKS,
        torch.cuda.current_stream().cuda_stream)
    mark = len(PROFILER_WINDOWS)
    # bytes: x, dy and scale read once, dx and dscale written once; about
    # 10 operations an element
    t_bound, by = cost_bound_ms(rmsnorm_bwd_cost(rows, D, x.dtype, s.dtype))
    summary["rmsnorm_bwd"] = dict(
        name="rmsnorm_bwd", route="cuda",
        source="src/repro_torch/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm/kernel.py:33 (its gradient: "
                 "JAX differentiates the jnp reference)",
        shape="x, dy (4096, 512) fp32, scale fp32 (the 100m step)",
        body=rms.select_bwd_body(x, s, dy)[0],
        ms=device_ms(kernel), event_ms=time_ms(kernel),
        kernel_ms=kernel_breakdown(kernel),
        previous_body_ms=device_ms(generic),
        previous_body_event_ms=time_ms(generic),
        plain_ms=device_ms(_grad_ms(plain_out, (xr, sr), dy)),
        library_ms=device_ms(_grad_ms(lib_out, (xr, sr), dy)),
        library_event_ms=time_ms(_grad_ms(lib_out, (xr, sr), dy)),
        bound_ms=t_bound, bound_by=by,
        max_abs_err=max(compare(g, w, f32)[0] for g, w in zip(
            kernel(), plain_grads(rmsnorm_f64, (x, s), dy, f64))),
        profiler_windows=window_counts(mark))
    # the cta_rows body at the recurrent train steps' wider rows, beside
    # the generic body (the previous body there, through its entry), the
    # plain and the library backwards
    for rows, D, name in ((8192, 1536, "mamba2_gated"),
                          (2048, 4096, "rgemma")):
        x, dy = (randn(rows, D, dtype=f32) for _ in range(2))
        s = randn(D, dtype=f32)
        xr, sr = x.clone().requires_grad_(), s.clone().requires_grad_()
        plain_out = rmsnorm_ref(xr, sr)
        lib_out = F.rms_norm(xr, (D,), sr, 1e-6)
        kernel = lambda: rmsnorm_bwd_cuda(x, s, dy)  # noqa: E731
        dx, ds = torch.empty_like(x), torch.empty_like(s)
        partial = torch.empty((2, rms.BWD_MAX_BLOCKS, D), device=dev)
        generic = lambda: rms._bwd_entry("generic")(  # noqa: E731
            x.data_ptr(), s.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            ds.data_ptr(), partial.data_ptr(), rows, D, 1e-6, 0, 0,
            rms.BWD_MAX_BLOCKS, torch.cuda.current_stream().cuda_stream)
        t_bound, by = cost_bound_ms(rmsnorm_bwd_cost(rows, D, x.dtype,
                                                     s.dtype))
        body = rms.select_bwd_body(x, s, dy)
        check(body[0] == "cta_rows", f"rmsnorm_bwd ({rows}, {D}): {body}")
        summary["rmsnorm_bwd"][name] = dict(
            shape=f"x, dy ({rows}, {D}) fp32, scale fp32",
            body=body[0], vectors_per_lane=body[1],
            warps=rms.cta_shape(D, f32)[0],
            ms=device_ms(kernel), event_ms=time_ms(kernel),
            kernel_ms=kernel_breakdown(kernel),
            previous_body_ms=device_ms(generic),
            previous_body_event_ms=time_ms(generic),
            plain_ms=device_ms(_grad_ms(plain_out, (xr, sr), dy)),
            library_ms=device_ms(_grad_ms(lib_out, (xr, sr), dy)),
            library_event_ms=time_ms(_grad_ms(lib_out, (xr, sr), dy)),
            bound_ms=t_bound, bound_by=by,
            max_abs_err=max(compare(g, w, f32)[0] for g, w in zip(
                kernel(), plain_grads(rmsnorm_f64, (x, s), dy, f64))))
    summary["rmsnorm_bwd"]["profiler_windows"] = window_counts(mark)
    emit("kernels", kernel="rmsnorm_bwd", timings={
        summary["rmsnorm_bwd"]["shape"]: summary["rmsnorm_bwd"]})

    # ---- flash-attention backward (and the forward's log-sum-exp): head
    # dims 16, 32, 64, 80; causal, window, chunk, no mask; GQA; ragged S;
    # the 100m shapes
    attn_cases = [
        (16, 256, 8, 4, 64, dict(causal=True)),
        (2, 100, 4, 1, 16, dict(causal=True)),
        (2, 128, 8, 4, 32, dict(causal=True)),
        (1, 300, 32, 32, 80, dict(causal=True)),
        (2, 200, 8, 2, 64, dict(causal=True, window=50)),
        (2, 200, 8, 2, 64, dict(causal=True, chunk=48)),
        (1, 130, 4, 4, 80, dict(causal=False)),
        (1, 333, 6, 3, 32, dict(causal=True, window=100)),
        # GQA groups of 8 and S not a multiple of the 64-row tiles, at the
        # head dims 64, 16 and 80
        (2, 190, 16, 2, 64, dict(causal=True)),
        (1, 129, 8, 1, 16, dict(causal=True, chunk=40)),
        (1, 65, 16, 2, 80, dict(causal=True, window=33)),
        # the head dims above 80: 120 (padded to 128), 128, 160 and 256
        # (MQA; recurrentgemma-9b's train step; a window of 2048 that bites
        # past S 2048)
        (1, 150, 8, 2, 120, dict(causal=True)),
        (2, 190, 8, 2, 128, dict(causal=True, window=70)),
        (1, 130, 4, 4, 160, dict(causal=True, chunk=48)),
        (1, 100, 4, 4, 160, dict(causal=False)),
        (2, 190, 8, 2, 160, dict(causal=True, window=70)),
        (1, 129, 8, 1, 120, dict(causal=True, chunk=40)),
        (2, 200, 16, 1, 256, dict(causal=True)),
        (4, 512, 16, 1, 256, dict(causal=True, window=2048)),
        (1, 2200, 4, 1, 256, dict(causal=True, window=2048)),
    ]
    for B, S, H, K, dh, kw in attn_cases:
        def heads(t):
            """q, k, v as views of a fused projection one element wider
            than its heads: the forward's mma body, which writes the
            log-sum-exp (aligned bf16 inputs at ``SM90_HEAD_DIMS`` take
            sm90, whose log-sum-exp ``sm90_lse_kernels`` holds)."""
            return [x.unflatten(-1, (-1, dh)) for x in t[..., :-1].split(
                [H * dh, K * dh, K * dh], -1)]

        for dtype in (f32, torch.bfloat16):
            fused = dtype == torch.bfloat16 and dh in SM90_DH
            if fused:
                qkv = randn(B, S, (H + 2 * K) * dh + 1, dtype=dtype)
                q, k, v = heads(qkv)
                do = randn(B, S, H, dh, dtype=dtype)
            else:
                q, do = (randn(B, S, H, dh, dtype=dtype) for _ in range(2))
                k, v = (randn(B, S, K, dh, dtype=dtype) for _ in range(2))
            with torch.no_grad():
                out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
            err_lse, ok_lse = compare(lse, lse_ref(q, k, **kw), dtype)
            if fused:
                base = qkv.clone().requires_grad_()
                ops.flash_attention(*heads(base), **kw).backward(do)
                got = heads(base.grad)
            else:
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                ops.flash_attention(*leaves, **kw).backward(do)
                got = [t.grad for t in leaves]
            want = plain_grads(mha_ref, (q, k, v), do, **kw)
            errs = [compare(g, w, dtype) for g, w in zip(got, want)]
            again = flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
            same = all(torch.equal(a, b) for a, b in zip(
                flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw), again))
            body = select_bwd_body(q, k, v)
            want_body = ("mma_tf32x3" if dtype == f32 else "sm90"
                         if dh in SM90_BWD_HEAD_DIMS else "mma_bf16")
            cases.append(dict(
                kernel="flash_attention_bwd", body=body,
                dtype=str(dtype), B=B, S=S, H=H, K=K, dh=dh, **kw,
                max_abs_err=max(e for e, _ in errs), lse_err=err_lse,
                tol=TOL[dtype], deterministic=same,
                ok=all(ok for _, ok in errs) and ok_lse and same
                and body == want_body))

    B, S, H, K, dh = attn_cases[0][:5]
    q, do = (randn(B, S, H, dh, dtype=f32) for _ in range(2))
    k, v = (randn(B, S, K, dh, dtype=f32) for _ in range(2))
    with torch.no_grad():
        out, lse = flash_attention_cuda(q, k, v, return_lse=True)
    pos = torch.arange(S, device=dev)
    pairs = int(attention_mask(pos, pos, causal=True).sum())
    # the five products of pairs x dh a head, each three TF32 products on
    # the tensor cores (flash_bwd_split_macs), 2 operations a multiply-add;
    # bytes: q, k, v, o, dO and lse read, dq, dk and dv written.  The same
    # five products once each at the fp32 FMA rate: fma_bound_ms, the bound
    # of PR 16's body
    cost = flash_attention_bwd_cost(B, S, H, K, dh, f32, pairs)
    t_bound, by = cost_bound_ms(cost)
    fma_bound = cost.flops / PEAK_OPS_PER_S[f32] * 1e3
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain_out = mha_ref(*leaves)
    lib_out = F.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in leaves), is_causal=True,
        enable_gqa=True)
    kernel = lambda: flash_attention_bwd_cuda(  # noqa: E731
        q, k, v, out, do, lse)
    forward = lambda: flash_attention_cuda(  # noqa: E731
        q, k, v, return_lse=True)
    mark = len(PROFILER_WINDOWS)
    summary["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:99 (its "
                 "gradient: JAX differentiates the jnp reference)",
        shape=f"q ({B},{S},{H},{dh}) k/v ({B},{S},{K},{dh}) fp32 causal "
              "(the 100m step)",
        body=select_bwd_body(q, k, v), ms=device_ms(kernel),
        event_ms=time_ms(kernel), kernel_ms=kernel_breakdown(kernel),
        forward_lse_ms=device_ms(forward),
        forward_ms=device_ms(lambda: flash_attention_cuda(q, k, v)),
        plain_ms=device_ms(_grad_ms(plain_out, leaves, do)),
        library_ms=device_ms(_grad_ms(lib_out, leaves, do.transpose(1, 2))),
        library_event_ms=time_ms(_grad_ms(lib_out, leaves,
                                          do.transpose(1, 2))),
        bound_ms=t_bound, bound_by=by, fma_bound_ms=fma_bound,
        max_abs_err=max(compare(g, w, f32)[0] for g, w in zip(
            kernel(), plain_grads(mha_ref, (q, k, v), do))),
        profiler_windows=window_counts(mark))
    flash_rgemma_kernels(dev, gen, summary)
    emit("kernels", kernel="flash_attention_bwd", timings={
        summary["flash_attention_bwd"]["shape"]:
            summary["flash_attention_bwd"]})
    scan_backward_kernels(dev, gen, cases, summary)


# the sm90 body's cases with its log-sum-exp (bf16, dh 80, 120, 128, 160
# and 256): the prefill shapes of qwen2-7b, recurrentgemma-9b,
# moonshot-v1-16b-a3b, llama4-scout-17b-a16e (chunk 8192), stablelm-3b and
# h2o-danube-3-4b, hubert-xlarge's heads at S 2048 (no mask), S 300 (a
# ragged last tile), window, chunk and no mask, qwen2-vl-2b's train step
# (batch 4 x 1024), and then the dh-160 instance's (Sm90<160>):
# stablelm-12b's GQA 32:8 at its prefill shape, a ragged S, a window and a
# chunk edge inside tiles, no mask, and (an eighth field, true) q, k and v
# as views of one fused projection
SM90_LSE_CASES = [
    ("stablelm-3b", 4, 512, 32, 32, 80, dict(causal=True)),
    ("hubert-xlarge", 1, 2048, 16, 16, 80, dict(causal=False)),
    ("h2o-danube-3-4b", 4, 512, 32, 8, 120, dict(causal=True)),
    ("ragged", 1, 300, 28, 4, 80, dict(causal=True)),
    ("qwen2-7b", 4, 512, 28, 4, 128, dict(causal=True)),
    ("recurrentgemma-9b", 4, 512, 16, 1, 256, dict(causal=True, window=2048)),
    ("moonshot-v1-16b-a3b", 4, 512, 16, 16, 128, dict(causal=True)),
    ("llama4-scout-17b-a16e", 4, 512, 40, 8, 128,
     dict(causal=True, chunk=8192)),
    ("ragged", 1, 300, 28, 4, 128, dict(causal=True)),
    ("ragged", 1, 300, 16, 1, 256, dict(causal=True)),
    ("window", 2, 512, 28, 4, 128, dict(causal=True, window=100)),
    ("window", 1, 1000, 16, 1, 256, dict(causal=True, window=300)),
    ("chunk", 1, 512, 28, 4, 128, dict(causal=True, chunk=96)),
    ("chunk", 1, 1000, 16, 1, 256, dict(causal=True, chunk=128)),
    ("no mask", 2, 300, 28, 4, 128, dict(causal=False)),
    ("no mask", 1, 200, 16, 1, 256, dict(causal=False)),
    ("qwen2-vl-2b", 4, 1024, 12, 2, 128, dict(causal=True)),
    ("stablelm-12b", 4, 512, 32, 8, 160, dict(causal=True)),
    ("ragged", 1, 300, 32, 8, 160, dict(causal=True)),
    ("window", 1, 1000, 32, 8, 160, dict(causal=True, window=300)),
    ("chunk", 1, 512, 32, 8, 160, dict(causal=True, chunk=96)),
    ("no mask", 2, 300, 32, 8, 160, dict(causal=False)),
    ("fused views", 2, 300, 32, 8, 160, dict(causal=True), True),
]
# the lse's limit: the fp32 kernel tolerance, 2e-5 (1 + |lse|), against
# the plain lse in fp32 from the same bf16 inputs
LSE_TOL = {torch.bfloat16: 2e-5}


def sm90_lse_kernels(dev, gen, cases, summary):
    """The sm90 body with its log-sum-exp, at ``SM90_LSE_CASES``: O against
    ``mha_ref`` within 2e-2 (1 + |x|), the lse against ``lse_ref`` within
    ``LSE_TOL``, O bit-equal to the call without lse, and (dq, dk, dv) of
    ``FlashAttentionFunction`` (the sm90 forward, the backward the inputs
    take: sm90 at ``SM90_BWD_HEAD_DIMS``, else mma_bf16) against autograd
    of mha_ref in fp32 on the same bf16 inputs within 2e-2 (1 + |x|); a
    case marked ``fused`` takes q, k and v
    as views of one projection, and its gradient as the projection's.
    Then the sm90 device time with and without lse at qwen2-7b's prefill
    shape and at qwen2-vl-2b's train shape beside SDPA's bf16 forward, the
    plain version and the bound (``summary["flash_attention_sm90_lse"]``);
    last the bf16 backward at its train shapes (``sm90_bwd_kernels``)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         lse_ref, mha_ref)
    bf16 = torch.bfloat16
    inputs = {}

    def lse_case(label, B, S, H, K, dh, kw, fused=False):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(bf16)

        def heads(t):
            return [x.unflatten(-1, (-1, dh))
                    for x in t.split([H * dh, K * dh, K * dh], dim=-1)]
        if fused:
            qkv = randn(B, S, (H + 2 * K) * dh)
            q, k, v = heads(qkv)
            do = randn(B, S, H, dh)
        else:
            q, k, v, do = (randn(B, S, n, dh) for n in (H, K, K, H))
        with torch.no_grad():
            out, lse = flash.flash_attention_cuda(q, k, v, return_lse=True,
                                                  **kw)
            plain_o = flash.flash_attention_cuda(q, k, v, **kw)
        lse_err, lse_ok = compare(lse, lse_ref(q, k, **kw), bf16, LSE_TOL)
        if fused:
            base = qkv.clone().requires_grad_()
            ops.flash_attention(*heads(base), **kw).backward(do)
            grads = heads(base.grad)
        else:
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            ops.flash_attention(*leaves, **kw).backward(do)
            grads = [t.grad for t in leaves]
        fl = [t.float().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(mha_ref(*fl, **kw), fl, do.float())
        errs = [compare(t, w, bf16) for t, w in zip(grads, want)]
        o_err, o_ok = compare(out, mha_ref(q, k, v, **kw), bf16)
        bwd_body = flash.select_bwd_body(q, k, v)
        cases.append(dict(
            kernel="flash_attention_sm90_lse", case=label,
            body=flash.select_body(q, k, v), bwd_body=bwd_body,
            dtype=str(bf16), B=B, S=S, H=H, K=K, dh=dh, **kw,
            lse_err=lse_err, lse_tol=LSE_TOL[bf16],
            o_bit_equal=torch.equal(out, plain_o),
            o_err=o_err,
            max_abs_err=max(e for e, _ in errs), tol=TOL[bf16],
            ok=lse_ok and torch.equal(out, plain_o)
            and all(ok for _, ok in errs) and o_ok
            and flash.select_body(q, k, v) == "sm90"
            and bwd_body == ("sm90" if dh in flash.SM90_BWD_HEAD_DIMS
                             else "mma_bf16")))
        if label in ("qwen2-7b", "qwen2-vl-2b"):
            inputs[label] = (q, k, v, do, kw)

    for case in SM90_LSE_CASES:
        lse_case(*case)
    mark = len(PROFILER_WINDOWS)
    timings = {}
    for label, (q, k, v, do, kw) in inputs.items():
        B, S, H, dh = q.shape
        K = k.shape[2]
        pos = torch.arange(S, device=dev)
        pairs = int(attention_mask(pos, pos, **kw).sum())
        with_lse = lambda: flash.flash_attention_cuda(  # noqa: E731
            q, k, v, return_lse=True, **kw)
        without = lambda: flash.flash_attention_cuda(q, k, v, **kw)  # noqa: E731
        out, lse = with_lse()
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        t_bound, by = cost_bound_ms(flash_attention_cost(
            B, S, H, K, dh, q.dtype, pairs, lse=True))
        timings[label] = dict(
            shape=f"q ({B},{S},{H},{dh}) k/v ({B},{S},{K},{dh}) bf16 causal, "
                  "with lse", body=flash.select_body(q, k, v),
            ms=device_ms(with_lse), ms_windows=WINDOW_MS[-1],
            no_lse_ms=device_ms(without), no_lse_ms_windows=WINDOW_MS[-1],
            event_ms=time_ms(with_lse), no_lse_event_ms=time_ms(without),
            plain_ms=device_ms(lambda: mha_ref(q, k, v, **kw)),
            library="F.scaled_dot_product_attention bf16",
            library_ms=device_ms(library), bound_ms=t_bound, bound_by=by,
            lse_bytes=lse.nbytes,
            max_abs_err=compare(out, mha_ref(q, k, v, **kw), bf16)[0],
            lse_err=compare(lse, lse_ref(q, k, **kw), bf16, LSE_TOL)[0])
    summary["flash_attention_sm90_lse"] = dict(
        name="flash_attention_sm90_lse", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:99",
        counted_as=("flash_attention", "sm90", (128, 256)),
        **timings["qwen2-vl-2b"], qwen2_7b_prefill=timings["qwen2-7b"],
        profiler_windows=window_counts(mark))
    emit("kernels", kernel="flash_attention_sm90_lse", timings=timings)

    sm90_bwd_kernels(dev, gen, summary)


# hubert-xlarge's encode (prefill_32k on one card): one layer's attention,
# and the query rows the plain version is held on (its logits over all
# 32768 keys, in fp32, are 2 GB for every 1024 query rows).  q is drawn at
# HUBERT_Q_SCALE: unit-normal scores over 32768 keys spread the softmax so
# flat that |O| is near 0.01 and 2e-2 (1 + |O|) cannot see a wrong kernel;
# at std 4 a few keys carry each row, |O| is O(1) (mean 0.24), and a kernel
# that drops one 64-key tile of 512 or is 10% off fails (a CPU model of the
# body read 0.25 of the limit there)
HUBERT_ATTN = (1, PREFILL_32K, 16, 16, 80)
HUBERT_ROWS = 256
HUBERT_Q_SCALE = 4.0
# the sm90 body at dh 80 and 120 (tiles of 128 columns, the columns past dh
# zero-filled by TMA): ragged S, MHA (hubert-xlarge, stablelm-3b), GQA 7:1
# and 4:1 (h2o-danube-3-4b), MQA, window, chunk and no mask
SM90_NARROW_CASES = [
    (1, 200, 16, 16, 80, dict(causal=True)),
    (1, 1000, 28, 4, 80, dict(causal=True)),
    (2, 512, 16, 2, 80, dict(causal=True, window=100)),
    (1, 512, 16, 4, 80, dict(causal=True, chunk=96)),
    (2, 300, 16, 16, 80, dict(causal=False)),
    (1, 700, 16, 1, 80, dict(causal=False)),
    (1, 200, 32, 8, 120, dict(causal=True)),
    (1, 1000, 28, 4, 120, dict(causal=True, window=300)),
    (1, 512, 32, 8, 120, dict(causal=True, chunk=96)),
    (2, 300, 16, 16, 120, dict(causal=False)),
]
# their causal prefill at batch 4 x 512, timed beside the mma body and SDPA
SM90_NARROW_SHAPES = {
    "stablelm-3b": (4, 512, 32, 32, 80, dict(causal=True)),
    "h2o-danube-3-4b": (4, 512, 32, 8, 120, dict(causal=True)),
}


# stablelm-3b's attention in its train step (batch 4 x 1024, MHA 32 / 32
# at head dim 80)
STABLELM_TRAIN_ATTN = (4, 1024, 32, 32, 80)


def modality_kernels(dev, gen, cases, summary):
    """The kernels of this slice's paths at their own shapes: rmsnorm's
    one-read body at hubert-xlarge's D 1280 (bf16 and fp32) and the
    cta_rows backward in bf16 at qwen2-vl-2b's train step ((4096, 1536):
    the bf16 backward on a path for the first time) and fp32 at hubert's
    train_check ((512, 1280)), against their plain versions (the backward
    against fp64 autograd, as ``backward_kernels`` holds it); the flash
    sm90 body at dh 80 and 120 (``SM90_NARROW_CASES``, and views of a
    fused projection) against mha_ref; at hubert's encode shape
    (``HUBERT_ATTN``, bf16, no causal mask, q drawn at ``HUBERT_Q_SCALE``)
    against mha_ref on the first and last ``HUBERT_ROWS`` query rows (rows
    are independent without a mask), with |O|'s largest and mean printed
    beside the limit, then timed beside the mma body (``body="mma"``, the
    previous body), SDPA's bf16 call, the plain version walked over all
    rows by 1024-row chunks and its bound
    (``summary["flash_attention_bidir"]``); last at ``SM90_NARROW_SHAPES``
    beside the mma body, SDPA, the plain version and the bound
    (``summary["flash_attention"]["by_arch"]``)."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         lse_ref, mha_ref)
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for dtype, rows in ((f32, 4), (f32, 4 * 512), (bf16, 4), (bf16, 4 * 512),
                        (bf16, HUBERT_ATTN[1])):
        x, s = randn(rows, 1280, dtype=dtype), randn(1280, dtype=dtype)
        body = rms.select_body(x, s)[0]
        err, ok = compare(rms.rmsnorm_cuda(x, s, eps=1e-6),
                          rmsnorm_ref(x, s, eps=1e-6), dtype)
        cases.append(dict(kernel="rmsnorm", body=body, dtype=str(dtype),
                          rows=rows, D=1280, arch="hubert-xlarge",
                          max_abs_err=err, tol=TOL[dtype],
                          ok=ok and body == "one_read"))
    # stablelm-3b's train step: rows of 2560 both ways (one_read forward)
    x, s = randn(4096, 2560, dtype=bf16), randn(2560, dtype=bf16)
    body = rms.select_body(x, s)[0]
    err, ok = compare(rms.rmsnorm_cuda(x, s, eps=1e-6),
                      rmsnorm_ref(x, s, eps=1e-6), bf16)
    cases.append(dict(kernel="rmsnorm", body=body, dtype=str(bf16),
                      rows=4096, D=2560, arch="stablelm-3b",
                      max_abs_err=err, tol=TOL[bf16],
                      ok=ok and body == "one_read"))
    for dtype, rows, D, arch in ((bf16, 4096, 1536, "qwen2-vl-2b"),
                                 (bf16, 4096, 2560, "stablelm-3b"),
                                 (f32, 512, 1280, "hubert-xlarge")):
        x, dy = (randn(rows, D, dtype=dtype) for _ in range(2))
        s = randn(D, dtype=dtype)
        body = rms.select_bwd_body(x, s, dy)[0]
        got = rms.rmsnorm_bwd_cuda(x, s, dy)
        leaves = [t.to(f64).requires_grad_() for t in (x, s)]
        y = leaves[0] * torch.rsqrt(leaves[0].square().mean(-1, keepdim=True)
                                    + 1e-6) * leaves[1]
        want = torch.autograd.grad(y, leaves, dy.to(f64))
        errs = [compare(g, w, dtype) for g, w in zip(got, want)]
        cases.append(dict(kernel="rmsnorm_bwd", body=body, dtype=str(dtype),
                          rows=rows, D=D, arch=arch,
                          max_abs_err=max(e for e, _ in errs), tol=TOL[dtype],
                          ok=all(ok for _, ok in errs) and body == "cta_rows"))

    def attn_case(q, k, v, kw, **info):
        body = flash.select_body(q, k, v)
        err, ok = compare(flash.flash_attention_cuda(q, k, v, **kw),
                          mha_ref(q, k, v, **kw), bf16)
        B, S, H, dh = q.shape
        cases.append(dict(kernel="flash_attention", body=body,
                          dtype=str(bf16), B=B, S=S, H=H, K=k.shape[2], dh=dh,
                          **kw, **info, max_abs_err=err, tol=TOL[bf16],
                          ok=ok and body == "sm90"))

    for B, S, H, K, dh, kw in SM90_NARROW_CASES:
        attn_case(*(randn(B, S, n, dh, dtype=bf16) for n in (H, K, K)), kw)
    for H, K, dh in ((16, 16, 80), (32, 8, 120)):
        qkv = randn(2, 300, (H + 2 * K) * dh, dtype=bf16)
        attn_case(*(t.unflatten(-1, (-1, dh)) for t in qkv.split(
            [H * dh, K * dh, K * dh], dim=-1)), dict(causal=True),
            fused_views=True)

    B, S, H, K, dh = HUBERT_ATTN
    q = (HUBERT_Q_SCALE * randn(B, S, H, dh, dtype=f32)).to(bf16)
    k, v = (randn(B, S, K, dh, dtype=bf16) for _ in range(2))
    kernel = lambda: flash.flash_attention_cuda(  # noqa: E731
        q, k, v, causal=False)
    out = kernel()
    n = HUBERT_ROWS
    held = [(out[:, rows], mha_ref(q[:, rows], k, v, causal=False))
            for rows in (slice(0, n), slice(S - n, S))]
    errs = [compare(got, want, bf16) for got, want in held]
    # the largest |got - want| / (tol (1 + |want|)): 1 is the limit
    share = max(float(((got.float() - want.float()).abs() / (
        TOL[bf16] * (1 + want.float().abs()))).max()) for got, want in held)
    del held
    body = flash.select_body(q, k, v)
    cases.append(dict(kernel="flash_attention", body=body, dtype=str(bf16),
                      B=B, S=S, H=H, K=K, dh=dh, causal=False,
                      arch="hubert-xlarge", rows_held=f"first and last {n}",
                      q_scale=HUBERT_Q_SCALE,
                      max_abs_out=float(out.float().abs().max()),
                      mean_abs_out=float(out.float().abs().mean()),
                      max_abs_err=max(e for e, _ in errs), tol=TOL[bf16],
                      limit_share=share,
                      ok=all(ok for _, ok in errs) and body == "sm90"))

    def plain():
        for r0 in range(0, S, 1024):
            mha_ref(q[:, r0:r0 + 1024], k, v, causal=False)

    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=False)
    mma = lambda: flash.flash_attention_cuda(  # noqa: E731
        q, k, v, causal=False, body="mma")
    t_bound, by = cost_bound_ms(flash_attention_cost(
        B, S, H, k.shape[2], dh, q.dtype, S * S))
    mark = len(PROFILER_WINDOWS)
    summary["flash_attention_bidir"] = dict(
        name="flash_attention_bidir", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:99",
        counted_as=("flash_attention", "sm90", (dh,)),
        shape=f"q ({B},{S},{H},{dh}) k/v ({B},{S},{K},{dh}) bf16, no mask "
              "(one hubert-xlarge layer of the 32k encode)",
        body=body, ms=device_ms(kernel, iters=3, warmup=1),
        event_ms=time_ms(kernel, iters=3, warmup=1),
        previous_body="mma", previous_body_ms=device_ms(mma, iters=3,
                                                        warmup=1),
        previous_body_event_ms=time_ms(mma, iters=3, warmup=1),
        plain="mha_ref by 1024-row query chunks",
        plain_ms=device_ms(plain, iters=1, warmup=1),
        library="F.scaled_dot_product_attention bf16",
        library_ms=device_ms(library, iters=3, warmup=1),
        bound_ms=t_bound, bound_by=by,
        max_abs_err=max(e for e, _ in errs),
        library_max_abs_err=compare(
            library().transpose(1, 2)[:, :n],
            mha_ref(q[:, :n], k, v, causal=False), bf16)[0],
        profiler_windows=window_counts(mark))
    emit("kernels", kernel="flash_attention_bidir", timings={
        summary["flash_attention_bidir"]["shape"]:
            summary["flash_attention_bidir"]})
    del q, k, v, out, qt, kt, vt

    timings, mark = {}, len(PROFILER_WINDOWS)
    for arch, (B, S, H, K, dh, kw) in SM90_NARROW_SHAPES.items():
        q, k, v = (randn(B, S, n, dh, dtype=bf16) for n in (H, K, K))
        pos = torch.arange(S, device=dev)
        pairs = int(attention_mask(pos, pos, **kw).sum())
        t_bound, by = cost_bound_ms(flash_attention_cost(
            B, S, H, K, dh, q.dtype, pairs))
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        kernel = lambda: flash.flash_attention_cuda(q, k, v, **kw)  # noqa: E731
        mma = lambda: flash.flash_attention_cuda(  # noqa: E731
            q, k, v, body="mma", **kw)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        timings[arch] = dict(
            shape=f"q ({B},{S},{H},{dh}) k/v ({B},{S},{K},{dh}) bf16 "
                  + " ".join(f"{n}={x}" for n, x in kw.items()),
            body=flash.select_body(q, k, v),
            ms=device_ms(kernel), event_ms=time_ms(kernel),
            previous_body="mma", previous_body_ms=device_ms(mma),
            previous_body_event_ms=time_ms(mma),
            plain_ms=device_ms(lambda: mha_ref(q, k, v, **kw)),
            library="F.scaled_dot_product_attention bf16",
            library_ms=device_ms(library), library_event_ms=time_ms(library),
            bound_ms=t_bound, bound_by=by,
            max_abs_err=compare(kernel(), mha_ref(q, k, v, **kw), bf16)[0])
    summary["flash_attention"]["by_arch"].update(timings)
    summary["flash_attention"]["narrow_profiler_windows"] = window_counts(mark)
    emit("kernels", kernel="flash_attention", timings=timings)

    # stablelm-3b's training forward: sm90 at dh 80, causal, with the
    # log-sum-exp its backward reads (from this slice on most of the dh-80
    # row's launches), against mha_ref and lse_ref, beside SDPA's bf16 call
    B, S, H, K, dh = STABLELM_TRAIN_ATTN
    q, k, v = (randn(B, S, n, dh, dtype=bf16) for n in (H, K, K))
    pos = torch.arange(S, device=dev)
    pairs = int(attention_mask(pos, pos, causal=True).sum())
    kernel = lambda: flash.flash_attention_cuda(  # noqa: E731
        q, k, v, return_lse=True)
    out, lse = kernel()
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    t_bound, by = cost_bound_ms(flash_attention_cost(
        B, S, H, K, dh, q.dtype, pairs, lse=True))
    err, ok = compare(out, mha_ref(q, k, v), bf16)
    lse_err, lse_ok = compare(lse, lse_ref(q, k), bf16, LSE_TOL)
    mark = len(PROFILER_WINDOWS)
    train = summary["flash_attention_bidir"]["stablelm-3b_train"] = dict(
        shape=f"q ({B},{S},{H},{dh}) k/v ({B},{S},{K},{dh}) bf16 causal, "
              "with lse (the stablelm-3b step)",
        body=flash.select_body(q, k, v), ms=device_ms(kernel),
        event_ms=time_ms(kernel), plain_ms=device_ms(lambda: mha_ref(q, k, v)),
        library="F.scaled_dot_product_attention bf16",
        library_ms=device_ms(library), library_event_ms=time_ms(library),
        bound_ms=t_bound, bound_by=by, max_abs_err=err, lse_err=lse_err,
        profiler_windows=window_counts(mark))
    check(ok and lse_ok and train["body"] == "sm90",
          f"flash sm90 forward at {train['shape']}: body {train['body']}, "
          f"error {err}, lse error {lse_err}")
    emit("kernels", kernel="flash_attention_bidir", timings={
        train["shape"]: train})


# recurrentgemma-9b's train step and stablelm-12b's heads at the same batch:
# the two shapes whose fp32 bodies run 8 warps a CTA (dh 256 and 160)
FLASH_WIDE_SHAPES = {
    "rgemma": (4, 512, 16, 1, 256, dict(causal=True, window=2048),
               "the recurrentgemma-9b step"),
    "stablelm": (4, 512, 32, 8, 160, dict(causal=True), "stablelm-12b's heads"),
}


def flash_wide_timings(dev, gen, B, S, H, K, dh, kw, label):
    """(forward, backward) timings of flash attention in fp32 at one train
    shape whose bodies run 8 warps a CTA: the mma_tf32x3 forward with its
    log-sum-exp beside the FMA body it replaced (``body="fp32"``), and the
    pair backward, by kernel, each beside the plain version (``mha_ref``,
    its autograd) and SDPA's fp32 call (TF32 off), by kernel; the dK/dV
    launch's head splits timed one by one (``head_split_ms``).  Bounds:
    bytes, or the products of the visible pairs (five backward, two
    forward) each three TF32 products at the TF32 rate (``fma_bound_ms``:
    once each at the fp32 FMA rate).  (The bf16 backward at these shapes:
    ``sm90_bwd_kernels``.)"""
    from repro_torch.device import multiprocessors
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.flash_attention.ref import attention_mask, mha_ref
    f32 = torch.float32
    check(kw.get("window", 0) in (0,) or kw["window"] >= S,
          "SDPA's is_causal call stands for the mask only where the window "
          "does not bite")
    q, do = (torch.randn(B, S, H, dh, generator=gen, device=dev)
             for _ in range(2))
    k, v = (torch.randn(B, S, K, dh, generator=gen, device=dev)
            for _ in range(2))
    with torch.no_grad():
        out, lse = flash.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    pos = torch.arange(S, device=dev)
    pairs = int(attention_mask(pos, pos, **kw).sum())
    shape = (f"q ({B},{S},{H},{dh}) k/v ({B},{S},{K},{dh}) fp32 causal"
             + (f" window={kw['window']}" if kw.get("window") else "")
             + f" ({label})")
    sms = multiprocessors(dev)

    # ---- backward
    bwd_cost = flash_attention_bwd_cost(B, S, H, K, dh, f32, pairs)
    t_bound, by = cost_bound_ms(bwd_cost)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain_out = mha_ref(*leaves, **kw)
    lib_out = F.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in leaves), is_causal=True, enable_gqa=True)
    want = torch.autograd.grad(plain_out, leaves, do, retain_graph=True)
    kernel = lambda: flash.flash_attention_bwd_cuda(  # noqa: E731
        q, k, v, out, do, lse, **kw)
    splits = [s for s in (1, 2, 4, 8, 16) if (H // K) % s == 0]
    mark = len(PROFILER_WINDOWS)
    bwd = dict(
        shape=shape, body=flash.select_bwd_body(q, k, v),
        # S, dP and dQ in the dQ launch; S^T, dP^T, dK and dV in the dK/dV
        # launch, each once a pair of tiles
        full_width_products=7,
        head_split=flash.bwd_head_split(B, S, H, K, dh, sms),
        # each timing's three window totals beside its median
        ms=device_ms(kernel), ms_windows=WINDOW_MS[-1],
        event_ms=time_ms(kernel),
        kernel_ms=kernel_breakdown(kernel),
        head_split_ms={s: device_ms(lambda s=s: flash.flash_attention_bwd_cuda(
            q, k, v, out, do, lse, head_split=s, **kw)) for s in splits},
        plain_ms=device_ms(_grad_ms(plain_out, leaves, do)),
        library="SDPA's fp32 backward, TF32 off",
        library_ms=device_ms(_grad_ms(lib_out, leaves, do.transpose(1, 2))),
        library_ms_windows=WINDOW_MS[-1],
        library_event_ms=time_ms(_grad_ms(lib_out, leaves,
                                          do.transpose(1, 2))),
        bound_ms=t_bound, bound_by=by,
        fma_bound_ms=bwd_cost.flops / PEAK_OPS_PER_S[f32] * 1e3,
        pairs=pairs, max_abs_err=max(compare(g, w, f32)[0]
                                     for g, w in zip(kernel(), want)))
    check(all(compare(g, w, f32)[1] for g, w in zip(kernel(), want)),
          f"flash backward at {shape}: max error {bwd['max_abs_err']}")
    del plain_out, lib_out, leaves

    bwd["profiler_windows"] = window_counts(mark)

    # ---- forward, with the log-sum-exp (the train path's call)
    cost = flash_attention_cost(B, S, H, K, dh, f32, pairs, lse=True)
    t_bound, by = cost_bound_ms(cost)
    fma_bound, fma_by = bound(cost.bytes, cost.flops, f32)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    forward = lambda: flash.flash_attention_cuda(  # noqa: E731
        q, k, v, return_lse=True, **kw)
    previous = lambda: flash.flash_attention_cuda(  # noqa: E731
        q, k, v, return_lse=True, body="fp32", **kw)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    want = mha_ref(q, k, v, **kw)
    err, ok = compare(forward()[0], want, f32)
    check(ok, f"flash mma_tf32x3 forward at {shape}: max error {err}")
    mark = len(PROFILER_WINDOWS)
    fwd = dict(
        shape=shape + ", with lse", body=flash.select_body(q, k, v),
        ms=device_ms(forward), event_ms=time_ms(forward),
        previous_body="fp32", previous_body_ms=device_ms(previous),
        previous_body_event_ms=time_ms(previous),
        plain_ms=device_ms(lambda: mha_ref(q, k, v, **kw)),
        library="F.scaled_dot_product_attention fp32, TF32 off",
        library_ms=device_ms(library), library_event_ms=time_ms(library),
        bound_ms=t_bound, bound_by=by, fma_bound_ms=fma_bound,
        fma_bound_by=fma_by, max_abs_err=err,
        previous_max_abs_err=compare(previous()[0], want, f32)[0],
        profiler_windows=window_counts(mark))
    return fwd, bwd


def flash_rgemma_kernels(dev, gen, summary):
    """Flash attention in fp32 at recurrentgemma-9b's train step (q
    (4,512,16,256), k/v (4,512,1,256), causal, window 2048) and at
    stablelm-12b's heads (q (4,512,32,160), k/v (4,512,8,160), causal):
    ``flash_wide_timings`` at each, the backward into
    ``summary["flash_attention_bwd"]["rgemma" / "stablelm"]``, the forward
    into ``summary["flash_attention_fwd_fp32_wide"]``, the mma_tf32x3
    body at the head dims where its CTA has 8 warps (160 and 256): the
    recurrentgemma-9b shape's timings at the top, whose head dim the train
    path runs, stablelm's under ``"stablelm"``; its launches are those at
    dh 160 and 256 (``launches_by_head_dim``)."""
    for name, shape in FLASH_WIDE_SHAPES.items():
        fwd, bwd = flash_wide_timings(dev, gen, *shape)
        summary["flash_attention_bwd"][name] = bwd
        if name == "rgemma":
            summary["flash_attention_fwd_fp32_wide"] = dict(
                name="flash_attention_fwd_fp32_wide", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:99",
                counted_as=("flash_attention", "mma_tf32x3", (160, 256)),
                **fwd)
        else:
            summary["flash_attention_fwd_fp32_wide"][name] = fwd
        emit("kernels", kernel="flash_attention_wide", timings={
            bwd["shape"]: dict(forward=fwd, backward=bwd)})
    summary["flash_attention_bwd"]["head_split_gqa"] = splits = \
        flash_split_timings(dev, gen)
    emit("kernels", kernel="flash_attention_bwd_head_split", timings=splits)


# GQA heads above dh 80 whose dK/dV launch bwd_head_split splits, at the
# train batch of the shapes above: qwen2-vl-2b's (12 over 2, dh 128) and
# h2o-danube-3-4b's (32 over 8, dh 120)
FLASH_SPLIT_SHAPES = {"qwen2-vl-2b": (4, 512, 12, 2, 128),
                      "h2o-danube-3-4b": (4, 512, 32, 8, 120)}


def flash_split_timings(dev, gen):
    """The fp32 backward at ``FLASH_SPLIT_SHAPES``, causal, at every head
    split of powers of two that divides the group (1 is none), beside the
    split ``bwd_head_split`` picks and the fp32 partial buffer it
    allocates."""
    from repro_torch.device import multiprocessors
    from repro_torch.kernels.flash_attention import kernel as flash
    out = {}
    for name, (B, S, H, K, dh) in FLASH_SPLIT_SHAPES.items():
        q, do = (torch.randn(B, S, H, dh, generator=gen, device=dev)
                 for _ in range(2))
        k, v = (torch.randn(B, S, K, dh, generator=gen, device=dev)
                for _ in range(2))
        with torch.no_grad():
            o, lse = flash.flash_attention_cuda(q, k, v, return_lse=True)
        split = flash.bwd_head_split(B, S, H, K, dh, multiprocessors(dev))
        out[name] = dict(
            shape=f"q ({B},{S},{H},{dh}) k/v ({B},{S},{K},{dh}) fp32 causal",
            head_split=split, partial_bytes=2 * split * k.nbytes
            if split > 1 else 0,
            head_split_ms={s: device_ms(
                lambda s=s: flash.flash_attention_bwd_cuda(
                    q, k, v, o, do, lse, head_split=s))
                for s in (1, 2, 4, 8, 16) if (H // K) % s == 0})
    return out


# the bf16 backward on the sm90 body at the train shapes of its paths, by
# kernels-line entry: (the head dims its launches are counted at, the
# previous body forced beside it, its shapes, the first the entry's top).
# dh 128: qwen2-vl-2b's step (batch 4 x 1024); dh 80: stablelm-3b's (MHA,
# nothing to split); dh 256 and 160 (column halves): the timed shapes of
# FLASH_WIDE_SHAPES and the train_4k steps (seq 4096,
# src/repro/launch/specs.py) of recurrentgemma-9b (window 2048, biting) and
# stablelm-12b, the first the shape of its train phase
PAIR_KERNELS = ("mma_bf16 (the pair kernels: mma.sync, P and dS in hi + lo "
                "bf16 products)")
SM90_BWD_SHAPES = {
    "flash_attention_bwd_bf16": ((120, 128), PAIR_KERNELS, {
        "qwen2-vl-2b": (4, 1024, 12, 2, 128, dict(causal=True))}),
    "flash_attention_bwd_bf16_dh80": ((80,), (
        "mma_bf16 (BwdCfg's 4-warp kernels: mma.sync, 32-row streamed "
        "tiles)"), {"stablelm-3b": (*STABLELM_TRAIN_ATTN, dict(causal=True))}),
    "flash_attention_bwd_bf16_wide": ((160, 256), PAIR_KERNELS, {
        "rgemma_train_4k": (1, TRAIN_4K, 16, 1, 256, dict(causal=True,
                                                          window=2048)),
        "stablelm12b_train_4k": (1, TRAIN_4K, 32, 8, 160,
                                 dict(causal=True)),
        "rgemma": (4, 512, 16, 1, 256, dict(causal=True, window=2048)),
        "stablelm": (4, 512, 32, 8, 160, dict(causal=True))}),
}
# ragged S with a window that bites at dh 256 and 160, held only (dh 80 to
# 128 are held ragged in SM90_LSE_CASES)
SM90_WIDE_BWD_CHECKS = [(1, 1100, 16, 1, 256, dict(causal=True, window=700)),
                        (1, 1100, 32, 8, 160, dict(causal=True, window=300))]


def sm90_bwd_kernels(dev, gen, summary):
    """The bf16 backward's sm90 body at ``SM90_BWD_SHAPES`` (``Sm90Bwd<80>``
    to ``Sm90Bwd<256>``; at 160 and 256 column halves), on the forward's o
    and lse (the body the train path runs there: sm90): dq, dk,
    dv against autograd of ``mha_ref`` in fp32 within 2e-2 (1 + |x|), two
    runs bit for bit, every head split of the dK/dV launch within the same
    limit and dq the same bits at each, by kernel, beside the previous body
    it replaced, forced (``body="mma_bf16"``) and held to the same limit,
    SDPA's bf16 backward (a boolean ``attn_mask`` where the window bites:
    SDPA then skips no tile, so ``library_causal_ms`` also times its
    ``is_causal`` call, which skips tiles but visits ``library_causal_pairs``,
    more pairs than the window leaves), the plain backward and the bound
    (bytes, or ``flash_bwd_bf16_ops`` at the bf16 rate); and the forward
    the train path runs there (with its log-sum-exp), O held against
    ``mha_ref`` within 2e-2 (1 + |x|) and its lse against ``lse_ref``
    within ``LSE_TOL``, beside SDPA's bf16 forward and its bound, by the
    profiler and CUDA events, above dh 128 also beside the mma body forced,
    its previous body, whose O is held to the same limit (``forward``);
    then held (not timed) at
    ``SM90_WIDE_BWD_CHECKS``.  One kernels-line entry (``summary[name]``)
    each: its first shape at the top, the others under ``shapes``; and one
    for the forward's dh-160 instance (``flash_attention_sm90_dh160``,
    stablelm-12b's train_4k step at the top, batch 4 x 512 under
    ``shapes``)."""
    from repro_torch.device import multiprocessors
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         lse_ref, mha_ref)
    bf16 = torch.bfloat16
    sms = multiprocessors(dev)
    dh160 = []  # the forward's dh-160 timings, for its own entry

    def inputs(B, S, H, K, dh, kw):
        q, k, v, do = (torch.randn(B, S, n, dh, generator=gen,
                                   device=dev).to(bf16) for n in (H, K, K, H))
        with torch.no_grad():
            out, lse = flash.flash_attention_cuda(q, k, v, return_lse=True,
                                                  **kw)
        fl = [t.float().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(mha_ref(*fl, **kw), fl, do.float())
        return (q, k, v, do, out, lse), want

    def errors(got, want):
        """(max abs error, every gradient within the limit)."""
        errs = [compare(g, w, bf16) for g, w in zip(got, want)]
        return max(e for e, _ in errs), all(ok for _, ok in errs)

    def held(t, want, kw):
        """(max abs error, within the limit, deterministic, split errors)
        of the default call, and every head split agreeing."""
        q, k, v, do, out, lse = t
        G = q.shape[2] // k.shape[2]
        got = flash.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
        again = flash.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
        splits, unsplit = {}, None
        for d in (d for d in range(1, G + 1) if G % d == 0):
            gd = flash.flash_attention_bwd_cuda(q, k, v, out, do, lse,
                                                head_split=d, **kw)
            unsplit = gd if unsplit is None else unsplit
            e, ok = errors(gd, want)
            splits[d] = dict(max_abs_err=e,
                             ok=ok and torch.equal(gd[0], unsplit[0]))
        return (*errors(got, want),
                all(torch.equal(a, b) for a, b in zip(got, again)), splits)

    for name, (head_dims, previous_body, shapes) in SM90_BWD_SHAPES.items():
        entries = {}
        for label, (B, S, H, K, dh, kw) in shapes.items():
            t, want = inputs(B, S, H, K, dh, kw)
            q, k, v, do, out, lse = t
            pos = torch.arange(S, device=dev)
            mask = attention_mask(pos, pos, **kw)
            pairs = int(mask.sum())
            bites = 0 < kw.get("window", 0) < S
            err, ok, same, splits = held(t, want, kw)

            def bwd(**force):
                return lambda: flash.flash_attention_bwd_cuda(  # noqa: E731
                    q, k, v, out, do, lse, **kw, **force)
            kernel, previous = bwd(), bwd(body="mma_bf16")
            previous_err, previous_ok = errors(previous(), want)
            leaves = [a.clone().requires_grad_() for a in (q, k, v)]
            plain_out = mha_ref(*leaves, **kw)
            lt = [a.transpose(1, 2) for a in leaves]
            sdpa_mask = dict(attn_mask=mask) if bites else dict(is_causal=True)
            lib_out = F.scaled_dot_product_attention(*lt, enable_gqa=True,
                                                     **sdpa_mask)
            library = _grad_ms(lib_out, leaves, do.transpose(1, 2))
            lib_err, lib_ok = errors(library(), want)
            extra = {}
            if bites:
                causal_out = F.scaled_dot_product_attention(
                    *lt, enable_gqa=True, is_causal=True)
                extra = dict(
                    library_causal="SDPA's bf16 backward, is_causal (no "
                                   "window: more pairs, tiles skipped)",
                    library_causal_ms=device_ms(_grad_ms(
                        causal_out, leaves, do.transpose(1, 2))),
                    library_causal_pairs=S * (S + 1) // 2)
                del causal_out
            t_bound, by = cost_bound_ms(flash_attention_bwd_cost(
                B, S, H, K, dh, q.dtype, pairs))
            mark = len(PROFILER_WINDOWS)
            # the train path's forward at this shape (with its log-sum-exp),
            # beside SDPA's bf16 forward and its bound
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
            f_bound, f_by = cost_bound_ms(flash_attention_cost(
                B, S, H, K, dh, q.dtype, pairs, lse=True))
            fwd = lambda **force: flash.flash_attention_cuda(  # noqa: E731
                q, k, v, return_lse=True, **kw, **force)
            library_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, enable_gqa=True, **sdpa_mask)
            want_o = mha_ref(q, k, v, **kw)
            o_err, o_ok = compare(out, want_o, bf16)
            lse_err, lse_ok = compare(lse, lse_ref(q, k, **kw), bf16, LSE_TOL)
            forward = dict(
                shape=f"q ({B},{S},{H},{dh}) k/v ({B},{S},{K},{dh}) bf16 "
                      "causal" + (f" window={kw['window']}"
                                  if kw.get("window") else "")
                      + ", with lse", body=flash.select_body(q, k, v),
                with_lse=True, ms=device_ms(fwd), event_ms=time_ms(fwd),
                plain_ms=device_ms(lambda: mha_ref(q, k, v, **kw)),
                library="F.scaled_dot_product_attention bf16",
                library_ms=device_ms(library_fwd),
                library_event_ms=time_ms(library_fwd),
                bound_ms=f_bound, bound_by=f_by, tol=TOL[bf16],
                max_abs_err=o_err, ok=o_ok, lse_err=lse_err, lse_ok=lse_ok,
                previous_ok=True)
            if dh > 128:  # the mma body forced, the forward's previous body
                previous_fwd_err, previous_fwd_ok = compare(
                    fwd(body="mma")[0], want_o, bf16)
                forward.update(
                    previous_body="mma",
                    previous_body_ms=device_ms(lambda: fwd(body="mma")),
                    previous_body_event_ms=time_ms(lambda: fwd(body="mma")),
                    previous_max_abs_err=previous_fwd_err,
                    previous_ok=previous_fwd_ok)
            del want_o
            if dh == 160:
                dh160.append(forward)
            entries[label] = e = dict(
                shape=f"q ({B},{S},{H},{dh}) k/v ({B},{S},{K},{dh}) bf16 "
                      "causal" + (f" window={kw['window']}"
                                  if kw.get("window") else "")
                      + f", on the {forward['body']} forward's o and lse "
                      f"(the {label} step)",
                body=flash.select_bwd_body(q, k, v),
                head_split=flash.bwd_head_split(B, S, H, K, dh, sms, "sm90"),
                ms=device_ms(kernel), ms_windows=WINDOW_MS[-1],
                event_ms=time_ms(kernel), kernel_ms=kernel_breakdown(kernel),
                head_split_ms={d: device_ms(bwd(head_split=d))
                               for d in splits},
                previous_body=previous_body,
                previous_body_head_split=flash.bwd_head_split(B, S, H, K, dh,
                                                              sms),
                previous_body_ms=device_ms(previous),
                previous_kernel_ms=kernel_breakdown(previous),
                plain_ms=device_ms(_grad_ms(plain_out, leaves, do)),
                library="SDPA's bf16 backward" + (
                    ", the mask as a boolean attn_mask" if bites else ""),
                library_ms=device_ms(library),
                library_ms_windows=WINDOW_MS[-1], **extra,
                bound_ms=t_bound, bound_by=by, pairs=pairs, tol=TOL[bf16],
                max_abs_err=err, deterministic=same, head_splits_held=splits,
                previous_max_abs_err=previous_err, previous_ok=previous_ok,
                library_max_abs_err=lib_err, library_ok=lib_ok,
                forward=forward, profiler_windows=window_counts(mark))
            check(e["body"] == "sm90" and ok and same and previous_ok
                  and all(x["ok"] for x in splits.values()),
                  f"flash bf16 backward at {e['shape']}: body {e['body']}, "
                  f"error {err}, deterministic {same}, head splits {splits}, "
                  f"previous body's error {previous_err}")
            check(forward["ok"] and forward["lse_ok"]
                  and forward["previous_ok"],
                  f"flash bf16 forward at {forward['shape']}: body "
                  f"{forward['body']}, O error {o_err}, lse error {lse_err}, "
                  f"previous body's O error "
                  f"{forward.get('previous_max_abs_err')}")
            del t, want, q, k, v, do, out, lse, leaves, lt, plain_out, \
                lib_out, library, mask, qt, kt, vt, fwd, library_fwd
        for B, S, H, K, dh, kw in (SM90_WIDE_BWD_CHECKS if 256 in head_dims
                                   else ()):
            t, want = inputs(B, S, H, K, dh, kw)
            err, ok, same, splits = held(t, want, kw)
            entries[f"ragged S {S}, dh {dh}, {kw}"] = dict(
                max_abs_err=err, ok=ok, deterministic=same,
                head_splits_held=splits)
            check(ok and same and all(x["ok"] for x in splits.values()),
                  f"flash bf16 backward at ragged S {S}, dh {dh}, {kw}: "
                  f"error {err}, deterministic {same}, head splits {splits}")
            del t, want
        emit("kernels", kernel=name, timings=entries)
        top = entries.pop(next(iter(shapes)))
        summary[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:99 (its "
                     "gradient: JAX differentiates the jnp reference)",
            counted_as=("flash_attention_bwd", "sm90", head_dims), **top,
            shapes=entries)
    # the forward's dh-160 instance (Sm90<160>) at stablelm-12b's train_4k
    # step and at batch 4 x 512, beside the mma body it replaced
    summary["flash_attention_sm90_dh160"] = dict(
        name="flash_attention_sm90_dh160", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:99",
        counted_as=("flash_attention", "sm90", (160,)), **dh160[0],
        shapes=dh160[1:])


def scan_backward_kernels(dev, gen, cases, summary):
    """The SSD and RG-LRU backward kernels against ssd_chunked_bwd /
    rglru_bwd on the card on the same inputs, fp32 and bf16, at the scans'
    tolerances (SSD_TOL, RGLRU_TOL), each called twice (the same bits), and
    once through its autograd Function (ops.ssd_scan / ops.rglru_scan with
    inputs that require grad); then timed at mamba2-130m's train step (x
    (8,1024,24,64) fp32, chunk 128) and recurrentgemma-9b's (log_a, gx
    (4,512,4096) fp32, no h0) beside their plain backwards, with their
    device time by kernel.  The RG-LRU backward runs the body
    ``select_bwd_body`` picks (segmented from 64 steps) and the serial body
    forced beside it, and is timed beside the serial body (its previous
    one)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rglru.kernel import rglru_bwd_cuda
    from repro_torch.kernels.rglru.kernel import \
        select_bwd_body as rglru_select_bwd
    from repro_torch.kernels.rglru.ref import rglru_bwd
    from repro_torch.kernels.ssd.kernel import (bwd_bodies_for, bwd_slabs,
                                                select_bwd_body,
                                                ssd_bwd_cuda, ssd_tile)
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd
    f32 = torch.float32

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # ---- SSD backward: mamba2-130m's train shape, a ragged last chunk,
    # grouped B/C; with and without the final state's gradient; the fma
    # body forced beside the mma body where its block fits
    def ssd_bwd_holds(draw, shapes):
        for dtype in (f32, torch.bfloat16):
            for (B, S, H, P, G, N, Q), with_state in shapes:
                args = ssd_inputs(draw, B, S, H, P, G, N, dtype)
                dy = draw(B, S, H, P, dtype=dtype)
                ds = draw(B, H, P, N, dtype=f32) if with_state else None
                body = select_bwd_body(*args, dy, Q, ds)
                got = ssd_bwd_cuda(*args, dy, ds, chunk=Q)
                again = ssd_bwd_cuda(*args, dy, ds, chunk=Q)
                want = ssd_chunked_bwd(*args, dy, ds, chunk=Q)
                errs = [compare(g, w, dtype, SSD_TOL)
                        for g, w in zip(got, want)]
                fma_errs = [compare(g, w, dtype, SSD_TOL) for g, w in zip(
                    ssd_bwd_cuda(*args, dy, ds, chunk=Q, body="fma"), want)
                ] if "fma" in bwd_bodies_for(*args, dy, Q, ds) else []
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                cases.append(dict(kernel="ssd_bwd", body=body,
                                  dtype=str(dtype), B=B, S=S, H=H, P=P, G=G,
                                  N=N, chunk=Q, tile=ssd_tile(Q),
                                  slabs=bwd_slabs(P), d_state=with_state,
                                  max_abs_err=max(e for e, _ in errs),
                                  errs=[e for e, _ in errs],
                                  fma_errs=[e for e, _ in fma_errs],
                                  tol=SSD_TOL[dtype], deterministic=same,
                                  ok=all(ok for _, ok in errs + fma_errs)
                                  and same and body == "mma"))

    ssd_bwd_holds(lambda *shape, dtype=f32: randn(*shape, dtype=dtype), (
        ((8, 1024, 24, 64, 1, 128, 128), False),
        ((2, 1000, 24, 64, 1, 128, 128), True),
        ((2, 200, 4, 16, 2, 16, 64), True)))
    # mamba2-130m at MAMBA2_P128: head dim 128 (two slabs of P, where the
    # fma body's block does not fit) at chunk 128, and at its chunk of 256
    # (a tile of 128; ragged, with the final state's gradient); from a
    # generator of their own, so the later cases draw what they drew before
    g_p128 = torch.Generator(device=dev).manual_seed(gen.initial_seed() + 7)
    ssd_bwd_holds(lambda *shape, dtype=f32: torch.randn(
        shape, generator=g_p128, device=dev).to(dtype), (
        ((8, 1024, 12, 128, 1, 128, 128), False),
        ((2, 1000, 12, 128, 1, 128, 256), True)))
    # through SSDFunction: ops.ssd_scan with inputs that require grad
    args = ssd_inputs(randn, 2, 300, 4, 16, 2, 16, f32)
    dy = randn(2, 300, 4, 16)
    leaves = [t.clone().requires_grad_() for t in args]
    before = ssd_bwd_cuda.launches_by_body["mma"]
    (ops.ssd_scan(*leaves, chunk=64)[0] * dy).sum().backward()
    errs = [compare(t.grad, w, f32, SSD_TOL) for t, w in zip(
        leaves, ssd_chunked_bwd(*args, dy, chunk=64))]
    cases.append(dict(kernel="ssd_bwd", body="mma", through="SSDFunction",
                      dtype=str(f32), B=2, S=300, H=4, P=16, G=2, N=16,
                      chunk=64, max_abs_err=max(e for e, _ in errs),
                      tol=SSD_TOL[f32], ok=all(ok for _, ok in errs)
                      and ssd_bwd_cuda.launches_by_body["mma"] == before + 1))

    B, S, H, P, G, N, Q = 8, 1024, 24, 64, 1, 128, 128
    args = ssd_inputs(randn, B, S, H, P, G, N, f32)
    dy = randn(B, S, H, P)
    x, dt, _, Bm, Cm, _ = args
    # bytes: x, dt, Bm, Cm, dy (A, D) read once, dx, ddt, dB, dC (dA, dD)
    # written once; operations: the mma body's, ssd_bwd_split_macs on the
    # TF32 tensor cores; fma_bound_ms, ssd_bwd_macs on the fp32 FMA units,
    # bounds the fma body (the previous body)
    cost = ssd_bwd_cost(B, S, H, P, G, N, Q, x.dtype)
    t_bound, by = cost_bound_ms(cost)
    fma_bound, fma_by = bound(cost.bytes, cost.flops, f32)
    body = select_bwd_body(*args, dy, Q)
    check(body == "mma", f"ssd_bwd at the mamba2-130m step: body {body}")
    kernel = lambda: ssd_bwd_cuda(*args, dy, chunk=Q)  # noqa: E731
    previous = lambda: ssd_bwd_cuda(*args, dy, chunk=Q,  # noqa: E731
                                    body="fma")
    mark = len(PROFILER_WINDOWS)
    summary["ssd_bwd"] = dict(
        name="ssd_bwd", route="cuda", source="src/repro_torch/csrc/ssd.cu",
        replaces="src/repro/kernels/ssd/kernel.py:71 (its gradient: JAX "
                 "differentiates the jnp reference)",
        shape=f"x, dy ({B},{S},{H},{P}) fp32, dt ({B},{S},{H}), Bm/Cm "
              f"({B},{S},{G},{N}) fp32, chunk {Q} (the mamba2-130m step)",
        body=body, ms=device_ms(kernel), event_ms=time_ms(kernel),
        kernel_ms=kernel_breakdown(kernel),
        previous_body_ms=device_ms(previous),
        previous_body_event_ms=time_ms(previous),
        previous_body_kernel_ms=kernel_breakdown(previous),
        plain_ms=device_ms(lambda: ssd_chunked_bwd(*args, dy, chunk=Q),
                           iters=5, warmup=1),
        library_ms=None, bound_ms=t_bound, bound_by=by,
        fma_bound_ms=fma_bound, fma_bound_by=fma_by,
        bwd_macs=ssd_bwd_macs(B, S, H, P, G, N, Q),
        bwd_split_macs=ssd_bwd_split_macs(B, S, H, P, G, N, Q),
        max_abs_err=max(compare(g, w, f32, SSD_TOL)[0] for g, w in zip(
            kernel(), ssd_chunked_bwd(*args, dy, chunk=Q))),
        profiler_windows=window_counts(mark))
    emit("kernels", kernel="ssd_bwd", timings={
        summary["ssd_bwd"]["shape"]: summary["ssd_bwd"]})
    ssd_p128_kernels(dev, torch.Generator(device=dev).manual_seed(
        gen.initial_seed() + 8), summary)

    # ---- RG-LRU backward: recurrentgemma-9b's shape, a short sequence
    # (serial), ragged ones of one, two and three 512-step windows
    # (segmented, and the serial body forced beside it), with h0 and a
    # gradient of h_last
    for dtype in (f32, torch.bfloat16):
        for B, S, W in ((4, 512, 4096), (2, 37, 200), (3, 1000, 130),
                        (2, 300, 33), (1, 1100, 4096)):
            la = -F.softplus(randn(B, S, W)).to(dtype)
            gx, dy = randn(B, S, W, dtype=dtype), randn(B, S, W, dtype=dtype)
            h0, dh = randn(B, W), randn(B, W)
            body = rglru_select_bwd(la, gx, h0)
            want = rglru_bwd(la, gx, dy, h0, dh)
            for run_body in dict.fromkeys((body, "serial")):
                got = rglru_bwd_cuda(la, gx, dy, h0, dh, body=run_body)
                again = rglru_bwd_cuda(la, gx, dy, h0, dh, body=run_body)
                errs = [compare(g, w, dtype, RGLRU_TOL)
                        for g, w in zip(got, want)]
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                cases.append(dict(
                    kernel="rglru_bwd", body=run_body, selected=body,
                    dtype=str(dtype), B=B, S=S, W=W,
                    max_abs_err=max(e for e, _ in errs),
                    tol=RGLRU_TOL[dtype], deterministic=same,
                    ok=all(ok for _, ok in errs) and same
                    and body == ("segmented" if S >= 64 else "serial")))
    la = -F.softplus(randn(2, 300, 64))
    gx, dy = randn(2, 300, 64), randn(2, 300, 64)
    leaves = [la.clone().requires_grad_(), gx.clone().requires_grad_()]
    before = rglru_bwd_cuda.launches_by_body["segmented"]
    (ops.rglru_scan(*leaves)[0] * dy).sum().backward()
    errs = [compare(t.grad, w, f32, RGLRU_TOL) for t, w in zip(
        leaves, rglru_bwd(la, gx, dy))]
    cases.append(dict(kernel="rglru_bwd", body="segmented",
                      through="RGLRUFunction", dtype=str(f32), B=2, S=300,
                      W=64, max_abs_err=max(e for e, _ in errs),
                      tol=RGLRU_TOL[f32], ok=all(ok for _, ok in errs)
                      and rglru_bwd_cuda.launches_by_body["segmented"]
                      == before + 1))

    B, S, W = 4, 512, 4096
    la = -F.softplus(randn(B, S, W))
    gx, dy = randn(B, S, W), randn(B, S, W)
    # bytes: log_a, gx, dy read once, d log_a and d gx written once; about
    # 30 operations an element (recompute and reverse step)
    t_bound, by = cost_bound_ms(rglru_bwd_cost(B, S, W, la.dtype))
    kernel = lambda: rglru_bwd_cuda(la, gx, dy)  # noqa: E731
    serial = lambda: rglru_bwd_cuda(la, gx, dy, body="serial")  # noqa: E731
    mark = len(PROFILER_WINDOWS)
    summary["rglru_bwd"] = dict(
        name="rglru_bwd", route="cuda",
        source="src/repro_torch/csrc/rglru.cu",
        replaces="src/repro/kernels/rglru/kernel.py:50 (its gradient: JAX "
                 "differentiates the jnp reference)",
        shape=f"log_a, gx, dy ({B},{S},{W}) fp32, no h0 (the "
              "recurrentgemma-9b step)",
        body=rglru_select_bwd(la, gx), ms=device_ms(kernel),
        event_ms=time_ms(kernel), previous_body="serial",
        previous_body_ms=device_ms(serial),
        previous_body_event_ms=time_ms(serial),
        plain_ms=device_ms(lambda: rglru_bwd(la, gx, dy), iters=3,
                           warmup=1),
        library_ms=None, bound_ms=t_bound, bound_by=by,
        max_abs_err=max(compare(g, w, f32, RGLRU_TOL)[0] for g, w in zip(
            kernel()[:2], rglru_bwd(la, gx, dy)[:2])),
        profiler_windows=window_counts(mark))
    emit("kernels", kernel="rglru_bwd", timings={
        summary["rglru_bwd"]["shape"]: summary["rglru_bwd"]})


def ssd_p128_kernels(dev, gen, summary):
    """The SSD kernels at mamba2-130m's train step at ``MAMBA2_P128``'s
    head dim (x, dy (8,1024,12,128) fp32, Bm/Cm (8,1024,1,128)), the
    ``train_mamba2_p128`` path's, timed and held: the backward's mma body
    (two slabs of P) at chunk 128 beside the fma body at chunk 64 (the only
    body that took P 128 before: its block at a tile of 128 passes 227 KB),
    the plain backward and its bounds (``ssd_bwd_split_macs`` at the TF32
    rate, bytes; ``fma_bound_ms``: ``ssd_bwd_macs`` at the fp32 rate), and
    at the path's chunk of 256 (a tile of 128); the fp32 forward at chunk
    256 on its mma_tf32x3 body beside the fma body (its previous body), the
    plain scan at 256 and its bounds.  Launches: the train_mamba2_p128
    path's, on the body each row runs at head dim 128."""
    from repro_torch.kernels.ssd.kernel import (bwd_slabs, select_body,
                                                select_bwd_body,
                                                ssd_bwd_cuda, ssd_cuda,
                                                ssd_tile)
    from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_chunked_bwd
    f32 = torch.float32

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    B, S, H, P, G, N = 8, 1024, 12, 128, 1, 128
    args = ssd_inputs(randn, B, S, H, P, G, N, f32)
    dy = randn(B, S, H, P)
    shape = (f"x, dy ({B},{S},{H},{P}) fp32, dt ({B},{S},{H}), Bm/Cm "
             f"({B},{S},{G},{N}) fp32")
    Q, path_q = 128, MAMBA2_P128["ssm_chunk"]
    cost = ssd_bwd_cost(B, S, H, P, G, N, Q, f32)
    t_bound, by = cost_bound_ms(cost)
    fma_bound, fma_by = bound(cost.bytes, cost.flops, f32)
    body = select_bwd_body(*args, dy, Q)
    check(body == "mma", f"ssd_bwd at head dim 128: body {body}")
    kernel = lambda: ssd_bwd_cuda(*args, dy, chunk=Q)  # noqa: E731
    at_256 = lambda: ssd_bwd_cuda(*args, dy, chunk=path_q)  # noqa: E731
    previous = lambda: ssd_bwd_cuda(*args, dy, chunk=64,  # noqa: E731
                                    body="fma")
    want = ssd_chunked_bwd(*args, dy, chunk=Q)
    mark = len(PROFILER_WINDOWS)
    summary["ssd_bwd_p128"] = dict(
        name="ssd_bwd_p128", route="cuda",
        source="src/repro_torch/csrc/ssd.cu",
        replaces="src/repro/kernels/ssd/kernel.py:71 (its gradient: JAX "
                 "differentiates the jnp reference)",
        shape=f"{shape}, chunk {Q} (mamba2-130m's step at head dim 128)",
        counted_as=("ssd_bwd", "mma", (P,)), body=body, slabs=bwd_slabs(P),
        ms=device_ms(kernel), event_ms=time_ms(kernel),
        kernel_ms=kernel_breakdown(kernel),
        chunk_256_ms=device_ms(at_256), chunk_256_tile=ssd_tile(path_q),
        previous_body="fma at chunk 64",
        previous_body_ms=device_ms(previous),
        previous_body_event_ms=time_ms(previous),
        previous_body_kernel_ms=kernel_breakdown(previous),
        plain_ms=device_ms(lambda: ssd_chunked_bwd(*args, dy, chunk=Q),
                           iters=5, warmup=1),
        library_ms=None, bound_ms=t_bound, bound_by=by,
        fma_bound_ms=fma_bound, fma_bound_by=fma_by,
        bwd_macs=ssd_bwd_macs(B, S, H, P, G, N, Q),
        bwd_split_macs=ssd_bwd_split_macs(B, S, H, P, G, N, Q),
        max_abs_err=max(compare(g, w, f32, SSD_TOL)[0]
                        for g, w in zip(kernel(), want)),
        chunk_256_max_abs_err=max(
            compare(g, w, f32, SSD_TOL)[0] for g, w in zip(
                at_256(), ssd_chunked_bwd(*args, dy, chunk=path_q))),
        previous_body_max_abs_err=max(compare(g, w, f32, SSD_TOL)[0]
                                      for g, w in zip(previous(), want)),
        profiler_windows=window_counts(mark))
    del want
    emit("kernels", kernel="ssd_bwd_p128", timings={
        summary["ssd_bwd_p128"]["shape"]: summary["ssd_bwd_p128"]})

    cost = ssd_cost(B, S, H, P, G, N, path_q, f32)
    t_bound, by = cost_bound_ms(cost)
    fma_bound, fma_by = bound(cost.bytes, cost.flops, f32)
    kernel = lambda: ssd_cuda(*args, chunk=path_q)  # noqa: E731
    previous = lambda: ssd_cuda(*args, chunk=path_q,  # noqa: E731
                                body="fma")
    want = ssd_chunked(*args, chunk=path_q)
    mark = len(PROFILER_WINDOWS)
    summary["ssd_fwd_fp32_p128"] = dict(
        name="ssd_fwd_fp32_p128", route="cuda",
        source="src/repro_torch/csrc/ssd.cu",
        replaces="src/repro/kernels/ssd/kernel.py:71",
        shape=f"x ({B},{S},{H},{P}) fp32, dt ({B},{S},{H}), Bm/Cm "
              f"({B},{S},{G},{N}) fp32, chunk {path_q} at a tile of "
              f"{ssd_tile(path_q)} (mamba2-130m's step at MAMBA2_P128)",
        counted_as=("ssd", "mma_tf32x3", (P,)),
        body=select_body(*args, path_q), ms=device_ms(kernel),
        event_ms=time_ms(kernel), kernel_ms=kernel_breakdown(kernel),
        previous_body="fma", previous_body_ms=device_ms(previous),
        previous_body_event_ms=time_ms(previous),
        plain_ms=device_ms(lambda: ssd_chunked(*args, chunk=path_q),
                           iters=5, warmup=1),
        library_ms=None, bound_ms=t_bound, bound_by=by,
        fma_bound_ms=fma_bound, fma_bound_by=fma_by,
        macs=ssd_macs(B, S, H, P, G, N, path_q),
        max_abs_err=max(compare(g, w, f32, SSD_TOL)[0]
                        for g, w in zip(kernel(), want)),
        profiler_windows=window_counts(mark))
    emit("kernels", kernel="ssd_fwd_fp32_p128", timings={
        summary["ssd_fwd_fp32_p128"]["shape"]:
            summary["ssd_fwd_fp32_p128"]})


def route_stats(pairs, records, k: int) -> dict:
    """The smallest top-k margin p_(k) - p_(k+1) over ``records`` ((probs,
    sel) of every MoE call) and the (token, layer) routes that differ
    between the two runs of each pair of ``sel``: a route that flips at a
    near-tie changes the expert, and the error then looks like a fault."""
    from repro_torch.models.blocks import routes_differ, topk_margin
    return dict(route_margin=min(topk_margin(p, k) for p, _ in records),
                routes_differ=sum(routes_differ(a, b) for a, b in pairs))


def vision_prompt(cfg, B: int, P: int, grid: int, offset: int, gen, dev,
                  dtype) -> dict:
    """The image inputs of a qwen2-vl-2b prompt of P tokens (test data made
    here, not a feature of the port): a grid x grid block of patch
    embeddings (random normals) at positions [offset, offset + grid^2),
    ``vision_mask`` True there, and 3-D positions: the text before counts
    0 .. offset - 1 on all three axes, the block has t = offset, h = offset
    + its row and w = offset + its column, the text after continues from
    the largest id + 1."""
    n = grid * grid
    mask = torch.zeros(B, P, dtype=torch.bool, device=dev)
    mask[:, offset:offset + n] = True
    rows = torch.arange(n, device=dev) // grid
    cols = torch.arange(n, device=dev) % grid
    after = torch.arange(P - offset - n, device=dev) + offset + grid
    before = torch.arange(offset, device=dev)
    p3 = torch.stack([
        torch.cat([before, torch.full((n,), offset, device=dev), after]),
        torch.cat([before, offset + rows, after]),
        torch.cat([before, offset + cols, after])]).to(torch.int32)
    return {"vision_embeds": torch.randn(B, n, cfg.d_model, generator=gen,
                                         device=dev).to(dtype),
            "vision_mask": mask,
            "positions3": p3[:, None].expand(3, B, P).contiguous()}


# the image block of the qwen2-vl-2b prompts: a 16 x 16 patch grid after 16
# text tokens in the serve phase, 8 x 8 in its serve_check (prompt 128)
VISION_GRID = {"serve": (16, 16), "serve_check": (8, 16)}


def phase_serve_check(dev, gen, arch: str, layers: int, B: int, P: int,
                      n_dec: int = 8):
    """Decode against forward at full width, fp32.  An MoE config runs at a
    capacity factor of ``num_experts`` (no drops: capacity drops differ
    between a forward pass and decode by design, as in the JAX suite's
    test) and prints its routing margin and flipped routes.  qwen2-vl-2b's
    prompt holds an image block (``vision_prompt``); decode runs at text
    positions, as the reference decodes, so the forward's positions for
    the decoded tokens are their indices; its card forward is also held
    against the CPU's on the same weights, within the same bound."""
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, forward_train, init_cache,
                                    init_params, prefill)
    from repro_torch.models.blocks import record_routes, routes_by_layer
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    params = init_params(cfg, device=dev, dtype=torch.float32, generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (B, P + n_dec), generator=gen,
                         device=dev)
    prompt, whole = {"tokens": toks[:, :P]}, {"tokens": toks}
    if cfg.modality == "vision_stub":
        prompt.update(vision_prompt(cfg, B, P, *VISION_GRID["serve_check"],
                                    gen, dev, torch.float32))
        whole = dict(prompt, tokens=toks, vision_mask=torch.cat(
            [prompt["vision_mask"], torch.zeros(B, n_dec, dtype=torch.bool,
                                                device=dev)], 1))
        dec_pos = torch.arange(P, P + n_dec, dtype=torch.int32, device=dev)
        whole["positions3"] = torch.cat(
            [prompt["positions3"], dec_pos.expand(3, B, n_dec)], 2)
    with torch.inference_mode(), record_routes() as routes:
        full, _ = forward_train(params, whole, cfg, dtype=torch.float32)
        cache = init_cache(cfg, B, P + n_dec + 8, torch.float32, device=dev)
        last, cache = prefill(params, prompt, cache, cfg,
                              dtype=torch.float32)
        errs = [(last - full[:, P - 1]).abs().max()]
        for t in range(P, P + n_dec):
            logits, cache = decode_step(params, toks[:, t:t + 1], cache, cfg,
                                        dtype=torch.float32)
            errs.append((logits - full[:, t]).abs().max())
    scale = float(full.abs().max())
    rel = float(torch.stack(errs).max()) / scale
    finite = bool(torch.isfinite(full).all())
    moe = route_stats(routes_by_layer(routes, n_dec + 2), routes,
                      cfg.experts_per_token) if routes else {}
    cpu = {}
    if cfg.modality == "vision_stub":
        with torch.inference_mode():
            on_cpu, _ = forward_train(_to(params, "cpu"), _to(whole, "cpu"),
                                      cfg, dtype=torch.float32)
        cpu = dict(card_vs_cpu_rel_err=float(
            (full.cpu() - on_cpu).abs().max() / on_cpu.abs().max()),
            image=dict(grid=VISION_GRID["serve_check"][0],
                       offset=VISION_GRID["serve_check"][1]))
        del on_cpu
    emit("serve_check", arch=arch, layers=cfg.num_layers, dtype="float32",
         batch=B, prompt=P, window=cfg.window, decode_steps=n_dec,
         max_rel_err=rel, bound=SERVE_REL, finite=finite, **moe, **cpu)
    check(finite and rel < SERVE_REL
          and cpu.get("card_vs_cpu_rel_err", 0.0) < SERVE_REL,
          f"serve_check {arch}: decode vs forward rel err {rel} "
          f"(bound {SERVE_REL}) {moe} {cpu}")


def phase_serve(dev, gen, seed, arch: str, layers: int | None = None,
                reduced: str | None = None):
    """The full model (or cut to ``layers``, the cut said in ``reduced``)
    in bf16 through the wave loop; launches against their analytic count."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.rglru import kernel as lru
    from repro_torch.kernels.rglru.kernel import rglru_cuda
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.kernels.ssd.kernel import ssd_cuda
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.config import ATTN_KINDS
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    batch, requests, prompt_len, max_new = 4, 12, 512, 32
    max_len = prompt_len + max_new + 8
    dtype = torch.bfloat16
    t0 = time.monotonic()
    params = init_params(cfg, device=dev, dtype=dtype, generator=gen)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    weight_bytes = sum(t.nbytes for t in _leaves(params))
    rng = np.random.default_rng(seed)
    queue = [rng.integers(0, cfg.vocab_size, size=prompt_len).astype(np.int64)
             for _ in range(requests)]
    pre = make_prefill_step(cfg, dtype=dtype)
    dec = make_decode_step(cfg, dtype=dtype)
    # qwen2-vl-2b's prompts hold an image block (one for every wave)
    image = vision_prompt(cfg, batch, prompt_len, *VISION_GRID["serve"], gen,
                          dev, dtype) if cfg.modality == "vision_stub" else {}
    kernels = {"rmsnorm": rmsnorm_cuda, "flash_attention": flash_attention_cuda,
               "rglru": rglru_cuda, "ssd": ssd_cuda}

    torch.cuda.reset_peak_memory_stats()
    for module in (flash, rms, lru, ssd):
        module.reset_counts()
    prefill_ms, decode_ms, decode_s, outs, first = [], [], 0.0, [], None
    with torch.inference_mode():
        finite = torch.ones((), dtype=torch.bool, device=dev)
        while queue:
            wave = [queue.pop(0) for _ in range(min(batch, len(queue)))]
            toks = torch.from_numpy(np.stack(wave)).to(dev)
            cache = init_cache(cfg, batch, max_len, dtype, device=dev)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            last, cache = pre(params, {"tokens": toks, **image}, cache)
            torch.cuda.synchronize()
            t1 = time.monotonic()
            prefill_ms.append((t1 - t0) * 1e3)
            finite &= torch.isfinite(last).all()
            tok = torch.argmax(last, -1)[:, None].to(torch.int32)
            new, seen = [], [last] if first is None else None
            for _ in range(max_new):
                tok, logits, cache = dec(params, tok, cache)
                finite &= torch.isfinite(logits).all()
                new.append(tok)
                if seen is not None:
                    seen.append(logits)
            torch.cuda.synchronize()
            decode_ms.append((time.monotonic() - t1) * 1e3)
            decode_s += decode_ms[-1] / 1e3
            outs.append(torch.cat(new, 1).cpu())
            if first is None:   # the first wave, for the mesh phase
                first = dict(prompt=toks, tokens=outs[-1],
                             logits=torch.stack(seen),
                             prefill_ms=prefill_ms, decode_ms=decode_ms)
    launches = {name: fn.launches for name, fn in kernels.items()}
    by_body = {name: dict(fn.launches_by_body) for name, fn in kernels.items()}
    waves = len(outs)
    steps = waves * max_new
    kinds = cfg._layer_kinds()
    n_attn = sum(k in ATTN_KINDS for k in kinds)
    # rmsnorm, in prefill and decode: norm1 of every layer, norm2 of every
    # layer with an FFN or an MoE, the gated norm of every SSD layer, the
    # final norm;
    # flash attention: prefill only (decode attention over the cache is
    # mha_ref, as in the JAX package); RG-LRU: prefill (the segmented body)
    # and decode (the serial body); SSD: prefill only, bf16, so the mma body
    # (decode is ssd_decode_step, as in the JAX package)
    norm2 = sum(bool(cfg.d_ff or (cfg.num_experts and i >= cfg.first_k_dense))
                for i in range(len(kinds)))
    norms = len(kinds) + norm2 + kinds.count("ssd") + 1
    want = {"rmsnorm": norms * (waves + steps),
            "flash_attention": n_attn * waves,
            "rglru": kinds.count("rglru") * (waves + steps),
            "ssd": kinds.count("ssd") * waves}
    tokens = torch.cat(outs)
    emit("serve", arch=cfg.name, layers=cfg.num_layers,
         **({"reduced": reduced} if reduced else {}), dtype="bfloat16",
         **({"image": dict(grid=VISION_GRID["serve"][0],
                           offset=VISION_GRID["serve"][1])} if image else {}),
         requests=requests, waves=waves, batch=batch, prompt=prompt_len,
         new_tokens=max_new, init_s=init_s, prefill_ms=prefill_ms,
         prefill_bound_ms=prefill_bound_ms(cfg, batch, prompt_len),
         decode_tok_per_s=batch * steps / decode_s,
         decode_ms_per_step=decode_s * 1e3 / steps,
         decode_bound_ms_per_step=weight_bytes / HBM_BYTES_PER_S * 1e3,
         weight_bytes=weight_bytes,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         launches=launches, launches_expected=want,
         launches_by_body=by_body, sample=tokens[0, :10].tolist())
    check(bool(finite), f"serve {arch}: non-finite logits")
    check(tokens.shape == (requests, max_new)
          and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size,
          f"serve {arch}: bad tokens {tuple(tokens.shape)}")
    check(launches == want and all(launches[k] for k, n in want.items() if n),
          f"serve {arch}: launches {launches}, expected {want}")
    want_by_body = {
        "rmsnorm": {"one_read": want["rmsnorm"], "generic": 0},
        "flash_attention": {"sm90": want["flash_attention"], "mma": 0,
                            "mma_tf32x3": 0, "fp32": 0},
        "rglru": {"segmented": kinds.count("rglru") * waves,
                  "serial": kinds.count("rglru") * steps},
        "ssd": {"mma": want["ssd"], "mma_tf32x3": 0, "fma": 0}}
    check(by_body == want_by_body,
          f"serve {arch}: launches by body {by_body}, expected "
          f"{want_by_body}")
    return launches, by_body, (cfg, params, pre, dec,
                               {"tokens": toks, **image}, max_len), first


def phase_ssd_bodies(dev, gen, batch: int = 4, prompt: int = 512):
    """One bf16 mamba2-130m prefill wave at full depth (24 layers) through
    the SSD scan's mma body, and again with ``ssd_cuda(..., body="fma")``
    forced: the last-position logits of the two within ``SSD_BODIES_REL``
    of the largest logit (``serve_check``'s metric).  Beside them, the same
    wave with the scan run by its plain phases on the card, once with the
    fp32 operands split into bf16 hi + lo as the mma body splits them and
    once with them rounded to plain bf16 (what the limit must tell apart),
    and in fp32 (the mma_tf32x3 body, fp32 weights): how far each bf16 run
    is."""
    import functools

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.kernels.ssd.ref import (split_bf16, ssd_chunk_scan,
                                             ssd_chunk_state,
                                             ssd_state_passing)
    from repro_torch.models import init_cache, init_params, prefill

    def plain(rnd):
        def scan(x, dt, A, Bm, Cm, D, *, chunk=128):
            states, cum = ssd_chunk_state(x, dt, A, Bm, chunk=chunk,
                                          round_operand=rnd)
            states_in, state = ssd_state_passing(states, cum, chunk=chunk)
            return ssd_chunk_scan(x, dt, Bm, Cm, D, cum, states_in,
                                  chunk=chunk, round_operand=rnd), state
        return scan

    cfg = get_config("mamba2-130m")
    params = init_params(cfg, device=dev, dtype=torch.float32, generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev)
    scans = {"mma": functools.partial(ssd.ssd_cuda, body="mma"),
             "fma": functools.partial(ssd.ssd_cuda, body="fma"),
             "split_plain": plain(split_bf16),
             "bf16_plain": plain(lambda v: v.bfloat16().float()),
             "fp32": ssd.ssd_cuda}
    logits, counts = {}, {}
    for run, scan in scans.items():
        dtype = torch.float32 if run == "fp32" else torch.bfloat16
        ssd.reset_counts()
        ops.ssd_cuda = scan
        try:
            with torch.inference_mode():
                p = _cast(params, dtype)
                cache = init_cache(cfg, batch, prompt + 8, dtype, device=dev)
                logits[run], _ = prefill(p, {"tokens": toks}, cache, cfg,
                                         dtype=dtype)
        finally:
            ops.ssd_cuda = ssd.ssd_cuda
        counts[run] = dict(ssd.ssd_cuda.launches_by_body)

    def rel(a, b):
        return float((logits[a].float() - logits[b].float()).abs().max()
                     / logits[b].float().abs().max())

    errs = {f"{a}_vs_{b}": rel(a, b) for a, b in (
        ("mma", "fma"), ("split_plain", "fma"), ("bf16_plain", "fma"),
        ("mma", "fp32"), ("fma", "fp32"))}
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in logits.values())
    emit("ssd_bodies", arch=cfg.name, layers=cfg.num_layers, dtype="bfloat16",
         batch=batch, prompt=prompt, max_rel_err=errs, tol=SSD_BODIES_REL,
         bf16_plain_over_tol=errs["bf16_plain_vs_fma"] >= SSD_BODIES_REL,
         launches_by_body=counts, finite=finite)
    body_of = {"mma": "mma", "fma": "fma", "fp32": "mma_tf32x3"}
    want = {run: {b: cfg.num_layers * (b == body_of.get(run))
                  for b in ssd.BODIES} for run in scans}
    check(finite and errs["mma_vs_fma"] < SSD_BODIES_REL and counts == want,
          f"ssd_bodies: logits rel err {errs}, finite {finite}, launches "
          f"{counts} (expected {want})")
    ssd.reset_counts()


def phase_serve_mamba2_p128(dev, seed, batch: int = 4, prompt: int = 512,
                            new: int = 32):
    """mamba2-130m at ``MAMBA2_P128`` (full width and depth) served: one
    bf16 wave (batch 4, a 512-token prompt, 32 greedy new tokens) through
    ``make_prefill_step`` / ``make_decode_step``, its prefill on the SSD
    mma body at head dim 128 and a tile of 128 (the chunk of 256); every
    launch counted from 0 just before and read just after (24 SSD on the
    mma body, 49 RMSNorm on one_read for the prefill and each decode
    step).  Held against its fp32 wave as ``serve_check`` holds the served
    archs: the same prompt and the bf16 wave's tokens through the fp32
    weights and cache (prefill on the mma_tf32x3 body, then decode), whose
    33 logit rows lie within ``SERVE_REL`` of ``forward_train``'s on the
    same tokens; and the bf16 wave's rows against the fp32 wave's, no
    further (relative to the largest fp32 logit) than 1.1 x the same bf16
    wave with the SSD forward's fma body forced (its previous body) is,
    both printed."""
    import functools

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.rglru import kernel as lru
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.models import (decode_step, forward_train, init_cache,
                                    init_params, prefill)
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    cfg = dataclasses.replace(get_config("mamba2-130m"), **MAMBA2_P128)
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    params = init_params(cfg, device=dev, dtype=torch.float32, generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev)
    max_len = prompt + new + 8
    bf16 = torch.bfloat16
    p16 = _cast(params, bf16)
    pre, dec = make_prefill_step(cfg, dtype=bf16), make_decode_step(
        cfg, dtype=bf16)
    kernels = {"rmsnorm": rms.rmsnorm_cuda,
               "flash_attention": flash.flash_attention_cuda,
               "rglru": lru.rglru_cuda, "ssd": ssd.ssd_cuda}
    with torch.inference_mode():
        for module in (flash, rms, lru, ssd):
            module.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        last, cache = pre(p16, {"tokens": toks},
                          init_cache(cfg, batch, max_len, bf16, device=dev))
        torch.cuda.synchronize()
        prefill_ms = (time.monotonic() - t0) * 1e3
        rows, out = [last], []
        tok = torch.argmax(last, -1)[:, None].to(torch.int32)
        t0 = time.monotonic()
        for _ in range(new):
            out.append(tok)
            tok, logits, cache = dec(p16, tok, cache)
            rows.append(logits)
        torch.cuda.synchronize()
        decode_ms = (time.monotonic() - t0) * 1e3 / new
        launches = {name: fn.launches for name, fn in kernels.items()}
        by_body = {name: dict(fn.launches_by_body)
                   for name, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        waves = {"mma": torch.stack(rows).float()}
        fed = torch.cat(out, 1)

        def forced(p, dtype):
            """The wave again on the same tokens (prefill, then the bf16
            wave's tokens fed one by one): its 33 logit rows."""
            got, cache = prefill(p, {"tokens": toks}, init_cache(
                cfg, batch, max_len, dtype, device=dev), cfg, dtype=dtype)
            got = [got]
            for t in range(new):
                logits, cache = decode_step(p, fed[:, t:t + 1], cache, cfg,
                                            dtype=dtype)
                got.append(logits)
            return torch.stack(got).float()

        ops.ssd_cuda = functools.partial(ssd.ssd_cuda, body="fma")
        try:
            waves["fma"] = forced(p16, bf16)
        finally:
            ops.ssd_cuda = ssd.ssd_cuda
        before = dict(ssd.ssd_cuda.launches_by_body)
        waves["fp32"] = forced(params, torch.float32)
        fp32_body = {b: n - before[b]
                     for b, n in ssd.ssd_cuda.launches_by_body.items()}
        full, _ = forward_train(params, {"tokens": torch.cat([toks, fed], 1)},
                                cfg, dtype=torch.float32)
        full = full[:, prompt - 1:].transpose(0, 1).float()
    scale = float(waves["fp32"].abs().max())

    def rel(a, b):
        return float((a - b).abs().max()) / scale

    errs = dict(fp32_vs_forward=rel(waves["fp32"], full),
                mma_vs_fp32=rel(waves["mma"], waves["fp32"]),
                fma_vs_fp32=rel(waves["fma"], waves["fp32"]),
                mma_vs_fma=rel(waves["mma"], waves["fma"]))
    finite = all(bool(torch.isfinite(w).all()) for w in waves.values())
    L = cfg.num_layers
    want = {"rmsnorm": (2 * L + 1) * (1 + new), "flash_attention": 0,
            "rglru": 0, "ssd": L}
    want_by_body = {"rmsnorm": {"one_read": want["rmsnorm"], "generic": 0},
                    "ssd": {"mma": L, "mma_tf32x3": 0, "fma": 0}}
    emit("serve_mamba2_p128", arch=cfg.name, variant=MAMBA2_P128, layers=L,
         ssm_heads=cfg.ssm_heads, dtype="bfloat16", batch=batch,
         prompt=prompt, new_tokens=new, prefill_ms=prefill_ms,
         decode_ms_per_step=decode_ms, peak_mem_bytes=peak,
         max_rel_err=errs, serve_bound=SERVE_REL,
         bf16_bound=1.1 * errs["fma_vs_fp32"], finite=finite,
         fp32_wave_ssd_by_body=fp32_body, launches=launches,
         launches_expected=want, launches_by_body=by_body,
         sample=fed[0, :10].tolist())
    check(finite and errs["fp32_vs_forward"] < SERVE_REL
          and errs["mma_vs_fp32"] <= 1.1 * errs["fma_vs_fp32"],
          f"serve_mamba2_p128: rel errs {errs}, finite {finite}")
    check(launches == want and {k: by_body[k] for k in want_by_body}
          == want_by_body and fp32_body["mma_tf32x3"] == L,
          f"serve_mamba2_p128: launches {launches} by body {by_body}, "
          f"expected {want} {want_by_body}; fp32 wave {fp32_body}")
    by_body["ssd_by_head_dim"] = {"mma": {cfg.ssm_head_dim: L}}
    return launches, by_body


def _lm_example():
    """The training example (``examples/train_lm_torch.py``): its presets,
    its engine mount and its step settings."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import train_lm_torch
    finally:
        sys.path.pop(0)
    return train_lm_torch


# the card-against-CPU step's limits by the step's dtype: the loss,
# relative, and each gradient leaf, by its largest difference over its
# largest value (fp32) or in relative L2 norm (bf16: a bf16 step's single
# elements differ by whole bf16 steps between two orders of summation)
TRAIN_CHECK_LIMITS = {torch.float32: dict(loss=TRAIN_REL, grad=TRAIN_REL,
                                          grad_metric="max"),
                      torch.bfloat16: dict(loss=2e-2, grad=5e-2,
                                           grad_metric="l2")}


def phase_train_check(dev, seed, cfg, tc, batch: int, seq: int,
                      want_flash: dict | None = None, **label):
    """One train step of ``cfg`` in ``tc.dtype`` on the card (CUDA kernels
    forward and backward) against the same step of the port on the CPU
    (plain versions, autograd) in the same dtype: the same weights (fp32,
    drawn on the CPU from the seed, copied to both) and the same
    ``SyntheticLM`` batch.  The loss and every gradient leaf within
    ``TRAIN_CHECK_LIMITS[tc.dtype]``, the largest reading and its leaf
    printed beside each limit.  In fp32 also: AdamW on the card applied to
    the CPU's gradients lands on the CPU's parameters within 1e-6 of the
    largest; the card's own updated parameters within 2 lr of the CPU's
    (AdamW's g / (|g| + eps) turns a gradient difference near eps into a
    whole step), with their largest difference printed (the optimizer
    runs on fp32 state in either dtype, so the bf16 step skips them).  An
    MoE config also prints the smallest top-k margin of either run and the
    (token, layer) routes that differ between them.  ``want_flash``,
    where given, is the flash launches of the card's loss-and-gradient
    call (forward by body and head dim, backward by body), which must
    match.  ``label`` goes into the line."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.models.blocks import record_routes
    from repro_torch.optim import adamw_update, init_opt_state
    from repro_torch.train.steps import make_loss_and_grad, make_train_step
    limits = TRAIN_CHECK_LIMITS[tc.dtype]
    fp32 = tc.dtype == torch.float32
    params = init_params(cfg, device="cpu", dtype=torch.float32,
                         generator=torch.Generator().manual_seed(seed))
    data = next(iter(SyntheticLM(cfg, batch=batch, seq_len=seq, seed=seed)))
    lr = torch.tensor(1e-3)
    out, routes = {}, {}
    for d in ("cpu", dev):
        prm = _to(params, d)
        b = {k: torch.from_numpy(v).to(d) for k, v in data.items()}
        t0 = time.monotonic()
        _reset_launches()
        with record_routes() as routes[str(d)]:
            total, _, grads = make_loss_and_grad(cfg, tc)(prm, b)
        flash = _flash_launches()
        new_p = make_train_step(cfg, tc)(prm, init_opt_state(prm), b,
                                         lr)[0] if fp32 else None
        out[str(d)] = dict(loss=float(total), grads=_to(grads, "cpu"),
                           new=_to(new_p, "cpu") if fp32 else None,
                           s=time.monotonic() - t0)
    cpu, card = out["cpu"], out[str(dev)]

    # (recurrentgemma at 2 layers stacks no superblock: its leaves are empty)
    def pairs(a, b):
        return [(x, y) for x, y in zip(_leaves(a), _leaves(b)) if y.numel()]

    def rel(a, b):
        return max(float((x - y).abs().max()) / max(float(y.abs().max()),
                                                     1e-30)
                   for x, y in pairs(a, b))

    def rel_l2(x, y):
        return float((x.float() - y.float()).norm()
                     / max(float(y.float().norm()), 1e-30))

    def rel_max(x, y):
        return rel([x], [y])

    metric = rel_max if limits["grad_metric"] == "max" else rel_l2
    readings = [(metric(x, y), i) for i, (x, y) in
                enumerate(pairs(card["grads"], cpu["grads"]))]
    grad_rel, leaf = max(readings)
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    finite = all(bool(torch.isfinite(g).all()) for g in _leaves(card["grads"]))
    ok = finite and loss_rel < limits["loss"] and grad_rel < limits["grad"]
    step = {}
    if fp32:
        p_card = _to(params, dev)
        on_cpu_grads, _, _ = adamw_update(_to(cpu["grads"], dev),
                                          init_opt_state(p_card), p_card, lr)
        step = dict(adamw_on_cpu_grads_rel_err=rel(_to(on_cpu_grads, "cpu"),
                                                   cpu["new"]),
                    param_max_abs_err=max(float((x - y).abs().max())
                                          for x, y in pairs(card["new"],
                                                            cpu["new"])),
                    param_bound=2 * float(lr),
                    param_rel_err=rel(card["new"], cpu["new"]))
        ok = ok and step["adamw_on_cpu_grads_rel_err"] < 1e-6 \
            and step["param_max_abs_err"] <= 2 * float(lr)
    on_cpu, on_card = routes["cpu"], routes[str(dev)]
    moe = route_stats([(a[1], b[1]) for a, b in zip(on_cpu, on_card)],
                      on_cpu + on_card, cfg.experts_per_token) \
        if on_cpu else {}
    emit("train_check", **label, layers=cfg.num_layers, d_model=cfg.d_model,
         params=cfg.param_count(), dtype=str(tc.dtype).split(".")[-1],
         batch=batch, seq=seq, loss_cpu=cpu["loss"], loss_card=card["loss"],
         loss_rel_err=loss_rel, loss_tol=limits["loss"],
         grad_metric=limits["grad_metric"], grad_rel_err=grad_rel,
         grad_leaf=leaf, grad_rel_median=statistics.median(
             r for r, _ in readings), grad_tol=limits["grad"], finite=finite,
         **step, cpu_s=cpu["s"], card_s=card["s"], flash_launches=flash,
         flash_launches_expected=want_flash, **moe)
    check(ok, f"train_check {label} {tc.dtype}: loss {loss_rel}, grads "
          f"{grad_rel} at leaf {leaf} (limits {limits}), finite {finite}, "
          f"{step} {moe}")
    check(want_flash is None or flash == want_flash,
          f"train_check {label}: flash launches {flash}, expected "
          f"{want_flash}")


def _flash_launches() -> dict:
    """The flash launches since the counts were reset: the forward's by
    body and head dim, the backward's by body (the bodies that launched)."""
    from repro_torch.kernels.flash_attention import kernel as flash
    return dict(forward=_flash_by_head_dim(), backward={
        b: n for b, n in flash.flash_attention_bwd_cuda.launches_by_body.items()
        if n})


# the widths of the card-against-CPU steps of recurrentgemma-9b and
# qwen2-7b: the full-width steps (1.45 B and 1.2 B parameters at 3 and 2
# layers) are too slow on the CPU; the head dims stay the published ones
# (256 with 16 query heads and MQA; 128 with 28 and 4 KV heads), so the
# flash backward runs at them
RGEMMA_CHECK_WIDTH = dict(d_model=1024, lru_width=1024, d_ff=3072,
                          head_dim=256)
QWEN2_CHECK_WIDTH = dict(d_model=1024, d_ff=3072, head_dim=128)
# moonshot-v1-16b-a3b's step at 2 layers is 1.85 B parameters at full
# width; narrowed like qwen2-7b's (head dim 128), its experts kept whole:
# 64 of them, top-6, expert d_ff 1408, the shared expert's 2816
MOONSHOT_CHECK_WIDTH = dict(d_model=1024, num_heads=8, num_kv_heads=8,
                            head_dim=128)


def train_checks(dev, seed):
    """``phase_train_check`` of the 100m preset at 2 layers (its own batch,
    16 x 256, and the example's step settings), and of mamba2-130m (full
    width) at 2 layers, recurrentgemma-9b (``RGEMMA_CHECK_WIDTH``) at 3
    layers (rglru, rglru, attn_local: one superblock), qwen2-7b
    (``QWEN2_CHECK_WIDTH``) and moonshot-v1-16b-a3b
    (``MOONSHOT_CHECK_WIDTH``: the gradient through the MoE's scatter,
    gather and aux loss) at 2 layers, batch 2 x 256 (two 128-token SSD
    chunks), ``TrainConfig(float32)``.  Then the modality stubs at full
    width cut to 2 layers, batch 2 x 256 (``SyntheticLM``'s inputs:
    qwen2-vl-2b's 128 patch embeddings a row and 3-D positions, hubert's
    frame features and loss mask): qwen2-vl-2b in fp32 and in bf16
    (against the CPU's bf16 step; the sm90 forward with its
    log-sum-exp and the sm90 backward at dh 128), hubert-xlarge in
    fp32 (no causal mask, dh 80 on mma_tf32x3 both ways); and stablelm-3b
    at full width cut to 2 layers in bf16 under ``TrainConfig()``'s
    ``dots_no_batch`` (the sm90 forward and backward at dh 80), and
    recurrentgemma-9b (``RGEMMA_CHECK_WIDTH``, 3 layers) the same way (the
    sm90 forward and backward at dh 256)."""
    from repro_torch.configs import get_config
    from repro_torch.train.steps import TrainConfig
    ex = _lm_example()
    p = ex.PRESETS["100m"]
    phase_train_check(dev, seed, ex.preset_config("100m", num_layers=2),
                      ex.train_config(), p["batch"], p["seq"], preset="100m")
    for arch, layers, narrowed in (
            ("mamba2-130m", 2, {}),
            ("recurrentgemma-9b", 3, RGEMMA_CHECK_WIDTH),
            ("qwen2-7b", 2, QWEN2_CHECK_WIDTH),
            ("moonshot-v1-16b-a3b", 2, MOONSHOT_CHECK_WIDTH)):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  **narrowed)
        phase_train_check(dev, seed, cfg, TrainConfig(
            dtype=torch.float32, remat_policy="none"), 2, 256, arch=arch,
            narrowed=narrowed)
    # mamba2-130m at MAMBA2_P128 the same way: the SSD backward's two slabs
    # of P, and its chunk of 256 at a tile of 128 both ways
    cfg = dataclasses.replace(get_config("mamba2-130m"), num_layers=2,
                              **MAMBA2_P128)
    phase_train_check(dev, seed, cfg, TrainConfig(
        dtype=torch.float32, remat_policy="none"), 2, 256, arch=cfg.name,
        variant=MAMBA2_P128)
    for arch in ("qwen2-vl-2b", "hubert-xlarge"):
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
        dh = cfg.resolved_head_dim
        phase_train_check(dev, seed, cfg, TrainConfig(
                              dtype=torch.float32, remat_policy="none"),
                          2, 256, want_flash=dict(
                              forward={"mma_tf32x3": {dh: 2}},
                              backward={"mma_tf32x3": 2}),
                          arch=arch, causal=cfg.causal)
        if arch == "qwen2-vl-2b":
            phase_train_check(dev, seed, cfg,
                              TrainConfig(dtype=torch.bfloat16,
                                          remat_policy="none"), 2, 256,
                              want_flash=dict(forward={"sm90": {dh: 2}},
                                              backward={"sm90": 2}),
                              arch=arch)
    # stablelm-3b at full width cut to 2 layers, under TrainConfig()'s
    # defaults (bf16, dots_no_batch: each layer's attention runs again in
    # the backward), against the CPU's step under the same policy
    cfg = dataclasses.replace(get_config("stablelm-3b"), num_layers=2)
    tc = TrainConfig()
    phase_train_check(dev, seed, cfg, tc, 2, 256, want_flash=dict(
        forward={"sm90": {cfg.resolved_head_dim: 4}},
        backward={"sm90": 2}), arch=cfg.name,
        remat_policy=tc.remat_policy)
    # recurrentgemma-9b at RGEMMA_CHECK_WIDTH and 3 layers the same way: the
    # sm90 forward at dh 256 (twice: the rerun) and the sm90 backward's
    # column halves, the RG-LRU's fp32 gates
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=3,
                              **RGEMMA_CHECK_WIDTH)
    phase_train_check(dev, seed, cfg, tc, 2, 256, want_flash=dict(
        forward={"sm90": {cfg.resolved_head_dim: 2}},
        backward={"sm90": 1}), arch=cfg.name, narrowed=RGEMMA_CHECK_WIDTH,
        remat_policy=tc.remat_policy)


def phase_train(dev, seed, steps: int = 300, ckpt_every: int = 40):
    """The full 100m preset (12 layers, d_model 512, fp32) through the
    example's Trainer and ``run_with_restarts``, on CannyFS over a
    LocalBackend in a directory under ``build/`` behind the example's 1 ms
    LatencyBackend: the example's documented 100m run, ``steps`` steps, a
    checkpoint every ``ckpt_every`` (its default).  (60 steps left the loss
    at 10.549, above ln V = 10.397, on the H100: PERF.md.)
    Every kernel count is reset just before and read just after: 25
    RMSNorm and 12 flash launches a step, each way.  Then a second Trainer
    restores the last step (parameters and moments bit-identical to the
    saved ones), one more step is profiled, and a run that fails at a
    step restarts from the last commit."""
    import shutil
    import tempfile

    from repro_torch.data import Prefetcher, SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.train.loop import LoopConfig, Trainer, run_with_restarts
    ex = _lm_example()
    p = ex.PRESETS["100m"]
    cfg = ex.preset_config("100m")
    (ROOT / "build").mkdir(exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=ROOT / "build")
    step_ms, trainers = [], []

    class Timed(Trainer):
        """The example's Trainer; each step's time on the card, from a
        synchronize before to one after."""
        def init_state(self, sample_batch):
            super().init_state(sample_batch)
            trainers.append(self)
            step_fn = self.untimed = self.step_fn

            def timed(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step_fn(*args)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            self.step_fn = timed

    def factory(fs, total, every, cls=Timed):
        data = Prefetcher(iter(SyntheticLM(cfg, batch=p["batch"],
                                           seq_len=p["seq"], seed=seed)),
                          depth=2)
        return cls(cfg, fs, data, tc=ex.train_config(),
                   lc=LoopConfig(total_steps=total, ckpt_every=every,
                                 log_every=1, warmup=20, seed=seed),
                   device=dev)

    try:
        fs = ex.make_fs(workdir + "/run", 1.0)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.monotonic()
        run_with_restarts(lambda: factory(fs, steps, ckpt_every),
                          max_restarts=0)
        wall_s = time.monotonic() - t0
        launches = _count_launches()
        by_body = {"rmsnorm": dict(rms.rmsnorm_cuda.launches_by_body),
                   "rmsnorm_bwd": dict(rms.rmsnorm_bwd_cuda.launches_by_body),
                   "flash_attention": dict(
                       flash.flash_attention_cuda.launches_by_body),
                   "flash_attention_bwd": dict(
                       flash.flash_attention_bwd_cuda.launches_by_body),
                   "flash_attention_by_head_dim": _flash_by_head_dim()}
        peak = torch.cuda.max_memory_allocated()
        L = cfg.num_layers
        want = {"rmsnorm": ((2 * L + 1) * steps,) * 2,
                "flash_attention": (L * steps,) * 2, "rglru": (0, 0),
                "ssd": (0, 0)}
        trainer = trainers[0]
        fs.drain()
        log = [json.loads(line) for line in
               fs.read_file("logs/metrics.jsonl").decode().splitlines()]
        losses = [r["loss"] for r in log if "loss" in r]
        ack_s = [r["ckpt_ack_s"] for r in log if "ckpt_ack_s" in r]
        results = trainer.ckpt.results
        saved = {"params": trainer.state["params"],
                 "opt": trainer.state["opt"]}

        # a second trainer restores the last commit, bit for bit
        second = factory(fs, steps, ckpt_every)
        second.init_state(next(second.data))
        restored = {"params": second.state["params"],
                    "opt": second.state["opt"]}
        identical = second.step == steps and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(_leaves(saved), _leaves(restored)))
        del trainers[1:], second, restored

        # one more step, profiled
        batch = trainer.put_batch(next(trainer.data))
        prof = _profiled(lambda: trainer.untimed(
            trainer.state["params"], trainer.state["opt"], batch,
            torch.tensor(1e-3)))
        fs.close()
        del trainer, saved, trainers[:]

        # a run whose step fails after the second commit restarts from it
        crash = {"at": 2 * ckpt_every + ckpt_every // 2, "done": False}
        resumed = []

        class Failing(Timed):
            def init_state(self, sample_batch):
                super().init_state(sample_batch)
                resumed.append(self.step)
                step_fn = self.step_fn

                def failing(*args):
                    if not crash["done"] and self.step == crash["at"]:
                        crash["done"] = True
                        self.ckpt.wait_for_save()   # the last COMMIT landed
                        raise RuntimeError("injected step failure")
                    return step_fn(*args)
                self.step_fn = failing

        fs2 = ex.make_fs(workdir + "/crash", 1.0)
        n_timed = len(step_ms)
        crash_metrics = run_with_restarts(
            lambda: factory(fs2, 3 * ckpt_every, ckpt_every, Failing),
            max_restarts=1)
        fs2.close()
        del step_ms[n_timed:], trainers[:]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    warm = step_ms[5:]
    flops = cfg.model_flops(p["batch"] * p["seq"], training=True,
                            seq_len=p["seq"])
    emit("train", preset="100m", layers=cfg.num_layers, d_model=cfg.d_model,
         params=cfg.param_count(), dtype="float32", batch=p["batch"],
         seq=p["seq"], steps=steps, ckpt_every=ckpt_every,
         io_latency_ms=1.0, wall_s=wall_s,
         loss_first=losses[0], loss_last=losses[-1],
         loss_every_20=losses[::20],
         ln_vocab=math.log(cfg.vocab_size),
         step_ms_median=statistics.median(warm), step_ms_min=min(warm),
         step_ms_max=max(warm),
         step_flop_bound_ms=flops / PEAK_OPS_PER_S[torch.float32] * 1e3,
         step_flops=flops, profile=prof, peak_mem_bytes=peak,
         ckpt_ack_s=ack_s, ckpt_ok=[r.ok for r in results],
         ckpt_commit_s=[r.commit_s for r in results],
         ckpt_bytes=[r.bytes for r in results],
         restored_bit_identical=identical,
         launches={k: dict(forward=f, backward=b)
                   for k, (f, b) in launches.items()},
         launches_expected={k: dict(forward=f, backward=b)
                            for k, (f, b) in want.items()},
         launches_by_body=by_body, crash_at_step=crash["at"],
         crash_resumed_at=resumed, crash_final_loss=crash_metrics.get("loss"))
    check(all(math.isfinite(x) for x in losses) and len(losses) == steps
          and losses[-1] < losses[0] - 0.05
          and losses[-1] < math.log(cfg.vocab_size),
          f"train: loss {losses[0]} -> {losses[-1]} (must fall by 0.05 and "
          f"end below ln V = {math.log(cfg.vocab_size)})")
    check(launches == want, f"train: launches {launches}, expected {want}")
    check(by_body["rmsnorm"]["one_read"] == want["rmsnorm"][0]
          and by_body["rmsnorm_bwd"]["warp_rows"] == want["rmsnorm"][1]
          and by_body["flash_attention"]["mma_tf32x3"]
          == want["flash_attention"][0]
          and by_body["flash_attention"]["fp32"] == 0
          and by_body["flash_attention_by_head_dim"] == {"mma_tf32x3": {
              cfg.resolved_head_dim: want["flash_attention"][0]}}
          and by_body["flash_attention_bwd"]["mma_tf32x3"]
          == want["flash_attention"][1],
          f"train: launches by body {by_body}")
    check(identical, "train: the restored step differs from the saved one")
    want_saves = sorted({*range(ckpt_every, steps + 1, ckpt_every), steps})
    check([r.step for r in results] == want_saves
          and all(r.ok for r in results),
          f"train: checkpoints {[(r.step, r.ok, r.error) for r in results]}"
          f", expected steps {want_saves}")
    check(resumed == [0, 2 * ckpt_every] and crash_metrics
          and math.isfinite(crash_metrics["loss"]),
          f"train: the failed run resumed at {resumed}, expected "
          f"[0, {2 * ckpt_every}]")
    return launches, by_body


def _count_launches():
    """(forward, backward) launches of every kernel, by name."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.rglru import kernel as lru
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.kernels.ssd import kernel as ssd
    return {"rmsnorm": (rms.rmsnorm_cuda.launches,
                        rms.rmsnorm_bwd_cuda.launches),
            "flash_attention": (flash.flash_attention_cuda.launches,
                                flash.flash_attention_bwd_cuda.launches),
            "rglru": (lru.rglru_cuda.launches, lru.rglru_bwd_cuda.launches),
            "ssd": (ssd.ssd_cuda.launches, ssd.ssd_bwd_cuda.launches)}


def _flash_by_head_dim(backward: bool = False):
    """The flash forward's (with ``backward``, the backward's) launches by
    body and head dim, the bodies that launched only."""
    from repro_torch.kernels.flash_attention import kernel as flash
    fn = flash.flash_attention_bwd_cuda if backward else \
        flash.flash_attention_cuda
    return {body: dict(by_dh) for body, by_dh in
            fn.launches_by_head_dim.items() if by_dh}


def _reset_launches():
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.rglru import kernel as lru
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.kernels.ssd import kernel as ssd
    for module in (flash, rms, lru, ssd):
        module.reset_counts()


def train_bounds(cfg, batch: int, seq: int, dtype=torch.float32) -> dict:
    """Least step time and memory of a train step of ``cfg`` in ``dtype``,
    at the rate of the units each part runs on: the projections of
    ``flops_parts`` plus the tied unembedding's matmuls, which it leaves
    out (3 x 2 x tokens x V x d_model), at ``dtype``'s rate; the SSD scans
    (forward ``ssd_macs`` and backward ``ssd_bwd_macs``, 2 FLOPs a
    multiply-add, each SSD layer) and the attention of ``flops_parts``
    (forward and backward), in fp32 as three TF32 products each (the
    mma_tf32x3 bodies at every head dim) at the TF32 rate, in bf16 once at
    the bf16 rate; 16 B a parameter (fp32 weights, gradients and both
    moments, whatever the step's dtype)."""
    tokens = batch * seq
    parts = cfg.flops_parts(tokens, training=True, seq_len=seq)
    tied = 6 * tokens * cfg.vocab_size * cfg.d_model \
        if cfg.tie_embeddings else 0
    shape = (batch, seq, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
             cfg.ssm_state, cfg.ssm_chunk)
    n_ssd = cfg._layer_kinds().count("ssd")
    scans = parts["attn"] + (n_ssd * 2 * (ssd_macs(*shape) + ssd_bwd_macs(
        *shape)) if n_ssd else 0)
    if dtype == torch.float32:
        seconds = (parts["base"] + tied) / PEAK_OPS_PER_S[torch.float32] \
            + 3 * scans / PEAK_OPS_PER_S["tf32"]
    else:
        seconds = (parts["base"] + tied + scans) / PEAK_OPS_PER_S[dtype]
    return dict(step_bound_ms=seconds * 1e3,
                step_flops=parts["base"] + tied + scans,
                model_flops=parts["base"] + parts["attn"],
                tied_unembed_flops=tied, scan_flops=scans,
                peak_mem_bound_bytes=16 * cfg.param_count())


def phase_train_mamba2(dev, seed, steps: int = 100, ckpt_every: int = 25,
                       variant: dict | None = None,
                       phase: str = "train_mamba2"):
    """mamba2-130m at full width and depth (24 SSD layers, fp32) through the
    port's launcher, as a user runs it:

        python -m repro_torch.launch.train --arch mamba2-130m --steps 100 \
            --batch 8 --seq 1024 --ckpt-every 25 --io-latency-ms 1

    in a directory under ``build/`` (removed at the end), its Trainer
    recording each step's loss and time; ``variant`` (fields of the
    config, the launcher's ``get_config`` patched to return them) trains
    the registry's config with them replaced.  Every kernel count is reset
    just before and read just after: 24 SSD launches a step each way and 2L
    + 1 = 49 RMSNorm launches (norm1 and the gated norm of each layer, the
    final norm) each way.  The loss falls (the mean of the last 10 steps,
    or of the last half of fewer than 20, below that of as many first
    ones), every step is finite, the ``steps / ckpt_every`` checkpoints
    commit, and a Trainer on the same directory restores the last step bit
    for bit."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core import CannyFS, LocalBackend
    from repro_torch.launch import train as launcher
    from repro_torch.train.loop import LoopConfig, Trainer
    cfg = dataclasses.replace(get_config("mamba2-130m"), **(variant or {}))
    (ROOT / "build").mkdir(exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_mamba2_", dir=ROOT / "build")
    step_ms, losses, trainers = [], [], []

    class Recorded(Trainer):
        """The launcher's Trainer; each step's loss, and its time on the
        card from a synchronize before to one after."""
        def init_state(self, sample_batch):
            super().init_state(sample_batch)
            trainers.append(self)
            step_fn = self.untimed = self.step_fn

            def recorded(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step_fn(*args)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(out[2]["loss"]))
                return out
            self.step_fn = recorded

    argv = ["--arch", "mamba2-130m", "--steps", str(steps), "--batch", "8",
            "--seq", "1024", "--ckpt-every", str(ckpt_every),
            "--io-latency-ms", "1", "--remat", "none", "--workdir", workdir,
            "--device", str(dev)]
    launcher.Trainer = Recorded
    if variant:
        launcher.get_config = lambda arch: cfg
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.monotonic()
        launcher.main(argv)
        wall_s = time.monotonic() - t0
        launches = _count_launches()
        from repro_torch.kernels.rmsnorm import kernel as rms
        from repro_torch.kernels.ssd import kernel as ssd
        by_body = {"ssd": dict(ssd.ssd_cuda.launches_by_body),
                   "ssd_bwd": dict(ssd.ssd_bwd_cuda.launches_by_body),
                   "rmsnorm": dict(rms.rmsnorm_cuda.launches_by_body),
                   "rmsnorm_bwd": dict(rms.rmsnorm_bwd_cuda.launches_by_body)}
        peak = torch.cuda.max_memory_allocated()
        trainer = trainers[0]
        results = trainer.ckpt.results
        # one more step, profiled (after the counts were read): the SSD
        # forward's share of the step
        batch = trainer.put_batch(next(trainer.data))
        prof = _profiled(lambda: trainer.untimed(
            trainer.state["params"], trainer.state["opt"], batch,
            torch.tensor(1e-3)), groups=MAMBA2_GROUPS)
        del batch
        saved = {"params": trainer.state["params"],
                 "opt": trainer.state["opt"]}
        # a Trainer on the same directory restores the last commit
        fs = CannyFS(LocalBackend(workdir), max_inflight=4000, workers=32)
        second = Trainer(cfg, fs, iter(()), lc=LoopConfig(total_steps=steps),
                         device=dev)
        second.init_state(None)
        identical = second.step == steps and all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
                _leaves(saved), _leaves({"params": second.state["params"],
                                         "opt": second.state["opt"]})))
        fs.close()
        del trainer, saved, second, trainers[:]
    finally:
        launcher.Trainer = Trainer
        launcher.get_config = get_config
        shutil.rmtree(workdir, ignore_errors=True)
    if variant:     # every SSD launch at the variant's head dim
        by_body["ssd_by_head_dim"] = {
            b: {cfg.ssm_head_dim: n} for b, n in by_body["ssd"].items() if n}
        by_body["ssd_bwd_by_head_dim"] = {
            b: {cfg.ssm_head_dim: n} for b, n in by_body["ssd_bwd"].items()
            if n}
    L = cfg.num_layers
    want = {"rmsnorm": ((2 * L + 1) * steps,) * 2,
            "flash_attention": (0, 0), "rglru": (0, 0),
            "ssd": (L * steps,) * 2}
    # the SSD forward on its mma_tf32x3 body and backward on its mma body;
    # RMSNorm's backward on warp_rows at norm1 and the final norm (768) and
    # cta_rows at the gated norm (1536)
    want_by_body = {"ssd": {"mma": 0, "mma_tf32x3": L * steps, "fma": 0},
                    "ssd_bwd": {"mma": L * steps, "fma": 0},
                    "rmsnorm_bwd": {"warp_rows": (L + 1) * steps,
                                    "cta_rows": L * steps, "generic": 0}}
    warm = step_ms[min(5, steps // 2):]
    k = min(10, steps // 2)
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    emit(phase, arch=cfg.name, **({"variant": variant} if variant else {}),
         layers=L, d_model=cfg.d_model, ssm_heads=cfg.ssm_heads,
         ssm_head_dim=cfg.ssm_head_dim, ssm_state=cfg.ssm_state,
         ssm_chunk=cfg.ssm_chunk, params=cfg.param_count(), dtype="float32",
         batch=8, seq=1024, steps=steps, ckpt_every=ckpt_every,
         io_latency_ms=1.0, wall_s=wall_s, loss_first=losses[0],
         loss_last=losses[-1], **{f"loss_mean_first{k}": first,
                                  f"loss_mean_last{k}": last},
         loss_every_10=losses[::10], ln_vocab=math.log(cfg.vocab_size),
         step_ms_median=statistics.median(warm), step_ms_min=min(warm),
         step_ms_max=max(warm), peak_mem_bytes=peak,
         **train_bounds(cfg, 8, 1024), profile=prof,
         ckpt_ack_s=[r.ack_s for r in results],
         ckpt_ok=[r.ok for r in results],
         ckpt_commit_s=[r.commit_s for r in results],
         ckpt_bytes=[r.bytes for r in results],
         restored_bit_identical=identical,
         launches={k: dict(forward=f, backward=b)
                   for k, (f, b) in launches.items()},
         launches_expected={k: dict(forward=f, backward=b)
                            for k, (f, b) in want.items()},
         launches_by_body=by_body, launches_by_body_expected=want_by_body)
    check(len(losses) == steps and all(math.isfinite(x) for x in losses)
          and last < first,
          f"{phase}: {len(losses)} steps, loss mean {first} -> {last}")
    check(launches == want, f"{phase}: launches {launches}, expected {want}")
    check({k: by_body[k] for k in want_by_body} == want_by_body,
          f"{phase}: launches by body {by_body}, expected {want_by_body}")
    want_saves = list(range(ckpt_every, steps + 1, ckpt_every))
    check([r.step for r in results] == want_saves
          and all(r.ok for r in results),
          f"{phase}: checkpoints {[(r.step, r.ok) for r in results]}, "
          f"expected steps {want_saves}")
    check(identical, f"{phase}: the restored step differs from the saved "
          "one")
    return launches, by_body


# mamba2-130m with 128-wide heads (12 over its d_inner of 1536), states of
# 128 (its own) and the upstream Mamba-2 module's default chunk of 256
# (mamba_ssm/modules/mamba2.py): the SSD backward's two slabs of P, and
# every SSD kernel at a tile of 128 for the larger chunk
MAMBA2_P128 = dict(ssm_head_dim=128, ssm_state=128, ssm_chunk=256)


def phase_train_mamba2_p128(dev, seed, steps: int = 10,
                            ckpt_every: int = 10):
    """``phase_train_mamba2`` at ``MAMBA2_P128`` (the registry's config
    with those fields replaced, full width and depth), batch 8 x 1024, 10
    steps and one checkpoint through CannyFS: every loss finite and
    falling, 24 SSD launches a step each way, every forward on mma_tf32x3
    and every backward on mma at head dim 128, the restore bit for bit;
    step ms, peak memory and the SSD backward's device ms and share of one
    profiled step."""
    return phase_train_mamba2(dev, seed, steps, ckpt_every,
                              variant=MAMBA2_P128, phase="train_mamba2_p128")


def phase_train_rgemma_3l(dev, seed, steps: int = 10, batch: int = 4,
                          seq: int = 512, lr: float = 3e-4):
    """recurrentgemma-9b at full width (d_model 4096, lru_width 4096, GeGLU
    d_ff 12288, vocabulary 256000, tied, logit softcap 30) cut to 3 layers,
    its first full superblock (rglru, rglru, attn_local: local attention at
    head dim 256, 16 query heads, MQA, window 2048).  ``steps`` fp32 steps
    of ``make_train_step`` on ``SyntheticLM`` batches, no checkpoint: the
    loss finite at every step; 2 RG-LRU, 1 flash and 2L + 1 = 7 RMSNorm
    launches a step, each way, by body: the RG-LRU on its segmented bodies
    both ways, flash forward and backward on mma_tf32x3 (8 warps a CTA at
    dh 256), every RMSNorm backward on cta_rows."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.rglru import kernel as lru
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.models import init_params
    from repro_torch.optim import init_opt_state
    from repro_torch.train.steps import TrainConfig, make_train_step
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=3)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, device=dev, dtype=torch.float32, generator=gen)
    opt = init_opt_state(params)
    step = make_train_step(cfg, TrainConfig(dtype=torch.float32,
                                            remat_policy="none"))
    data = iter(SyntheticLM(cfg, batch=batch, seq_len=seq, seed=seed))
    losses, step_ms = [], []
    _reset_launches()
    for _ in range(steps):
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b, torch.tensor(lr))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    launches = _count_launches()
    by_body = {"rmsnorm_bwd": dict(rms.rmsnorm_bwd_cuda.launches_by_body),
               "rglru": dict(lru.rglru_cuda.launches_by_body),
               "rglru_bwd": dict(lru.rglru_bwd_cuda.launches_by_body),
               "flash_attention": dict(
                   flash.flash_attention_cuda.launches_by_body),
               "flash_attention_bwd": dict(
                   flash.flash_attention_bwd_cuda.launches_by_body),
               "flash_attention_by_head_dim": _flash_by_head_dim()}
    peak = torch.cuda.max_memory_allocated()
    # one more step, profiled (after the counts were read): each kernel
    # family's device ms and share of the step
    b = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
    prof = _profiled(lambda: step(params, opt, b, torch.tensor(lr)),
                     groups=RGEMMA_GROUPS)
    del params, opt, b
    kinds = cfg._layer_kinds()
    L, n_lru, n_attn = len(kinds), kinds.count("rglru"), kinds.count(
        "attn_local")
    want = {"rmsnorm": ((2 * L + 1) * steps,) * 2,
            "flash_attention": (n_attn * steps,) * 2,
            "rglru": (n_lru * steps,) * 2, "ssd": (0, 0)}
    # every norm is 4096 wide: the cta_rows backward; attention at dh 256
    # in fp32: the 3xTF32 forward and backward
    want_by_body = {
        "rmsnorm_bwd": {"warp_rows": 0, "cta_rows": (2 * L + 1) * steps,
                        "generic": 0},
        "rglru": {"segmented": n_lru * steps, "serial": 0},
        "rglru_bwd": {"segmented": n_lru * steps, "serial": 0},
        "flash_attention": {"sm90": 0, "mma": 0,
                            "mma_tf32x3": n_attn * steps, "fp32": 0},
        "flash_attention_bwd": {"mma_tf32x3": n_attn * steps,
                                "mma_bf16": 0, "sm90": 0},
        "flash_attention_by_head_dim": {"mma_tf32x3": {
            cfg.resolved_head_dim: n_attn * steps}}}
    emit("train_rgemma_3l", arch=cfg.name, layers=L, layer_kinds=kinds,
         reduced="num_layers 38 -> 3 (one superblock): 38 layers of fp32 "
                 "weights, gradients and AdamW moments are about 144 GB",
         d_model=cfg.d_model, lru_width=cfg.resolved_lru_width,
         d_ff=cfg.d_ff, head_dim=cfg.resolved_head_dim,
         heads=cfg.num_heads, kv_heads=cfg.num_kv_heads, window=cfg.window,
         vocab=cfg.vocab_size, params=cfg.param_count(),
         dtype="float32", batch=batch, seq=seq, steps=steps, lr=lr,
         losses=losses, step_ms_median=statistics.median(step_ms[2:]),
         step_ms_min=min(step_ms), step_ms_max=max(step_ms),
         step_ms_all=step_ms, peak_mem_bytes=peak,
         **train_bounds(cfg, batch, seq), profile=prof,
         launches={k: dict(forward=f, backward=b)
                   for k, (f, b) in launches.items()},
         launches_expected={k: dict(forward=f, backward=b)
                            for k, (f, b) in want.items()},
         launches_by_body=by_body, launches_by_body_expected=want_by_body)
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"train_rgemma_3l: losses {losses}")
    check(launches == want, f"train_rgemma_3l: launches {launches}, "
          f"expected {want}")
    check(by_body == want_by_body, f"train_rgemma_3l: launches by body "
          f"{by_body}, expected {want_by_body}")
    return launches, by_body


# kernel families of the bf16 phases (the qwen2-vl-2b train step, the
# hubert-xlarge encode), by the kernel's name with its spaces removed
# (cuBLAS's Hopper GEMMs are nvjet / sm90_xmma ones)
BF16_GROUPS = {
    "flash_forward": ("flash_attn_",),
    "flash_backward": ("flash_bwd_",),
    "rmsnorm": ("rmsnorm",),
    "gemm": ("nvjet", "gemm", "xmma", "cutlass"),
    "elementwise": ("elementwise", "foreach"),
    "reduce": ("reduce_kernel",),
}


def phase_train_qwen2vl_bf16(dev, seed, steps: int = 10, batch: int = 4,
                             seq: int = 1024, lr: float = 3e-4):
    """qwen2-vl-2b at full width and depth (28 layers, 1.544 B parameters,
    nothing cut), bf16 (``TrainConfig(bfloat16)``, fp32 weights, gradients
    and moments: 24.7 GB), ``steps`` steps of ``make_train_step`` on
    ``SyntheticLM`` batches (512 patch embeddings a row at positions 1-512,
    3-D positions), no checkpoint (one would hold 24.7 GB): every loss
    finite, and the loss on the first step's batch (``make_eval_step``:
    cross-entropy, no z-loss) lower after the ``steps`` steps than before
    them (the losses of ten different batches spread by about as much as
    ten steps move them); a step launches 28 flash
    forwards on the sm90 body (with the log-sum-exp) and 28 sm90
    backwards, 2L + 1 = 57 RMSNorm forwards and 57 cta_rows backwards
    (rows of 1536).  Step ms, peak memory, ``train_bounds``, one more
    step profiled by kernel family."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.optim import init_opt_state
    from repro_torch.train.steps import (TrainConfig, make_eval_step,
                                         make_train_step)
    cfg = get_config("qwen2-vl-2b")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, device=dev, dtype=torch.float32, generator=gen)
    opt = init_opt_state(params)
    tc = TrainConfig(dtype=torch.bfloat16, remat_policy="none")
    step, evaluate = make_train_step(cfg, tc), make_eval_step(cfg, tc)
    data = iter(SyntheticLM(cfg, batch=batch, seq_len=seq, seed=seed))
    first = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
    eval_before = float(evaluate(params, first)["loss"])
    losses, step_ms = [], []
    _reset_launches()
    for i in range(steps):
        b = first if i == 0 else {k: torch.from_numpy(v).to(dev)
                                  for k, v in next(data).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b, torch.tensor(lr))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    launches, by_body = _count_launches(), _bf16_by_body()
    peak = torch.cuda.max_memory_allocated()
    eval_after = float(evaluate(params, first)["loss"])
    b = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
    prof = _profiled(lambda: step(params, opt, b, torch.tensor(lr)),
                     groups=BF16_GROUPS)
    n_img = int(b["vision_mask"][0].sum())
    del params, opt, b, first
    L = cfg.num_layers
    want, want_by_body = _bf16_remat_launches(
        L, cfg.resolved_head_dim, steps, tc.remat_policy, "sm90")
    emit("train_qwen2vl_bf16", arch=cfg.name, layers=L, reduced=None,
         d_model=cfg.d_model, d_ff=cfg.d_ff, head_dim=cfg.resolved_head_dim,
         heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
         vocab=cfg.vocab_size, params=cfg.param_count(), dtype="bfloat16",
         batch=batch, seq=seq, image_positions=n_img, steps=steps, lr=lr,
         losses=losses, first_batch_loss_before=eval_before,
         first_batch_loss_after=eval_after,
         step_ms_median=statistics.median(step_ms[2:]),
         step_ms_min=min(step_ms), step_ms_max=max(step_ms),
         step_ms_all=step_ms, peak_mem_bytes=peak,
         **train_bounds(cfg, batch, seq, torch.bfloat16), profile=prof,
         launches={k: dict(forward=f, backward=b)
                   for k, (f, b) in launches.items()},
         launches_expected={k: dict(forward=f, backward=b)
                            for k, (f, b) in want.items()},
         launches_by_body=by_body, launches_by_body_expected=want_by_body)
    check(len(losses) == steps and all(math.isfinite(x) for x in losses)
          and eval_after < eval_before,
          f"train_qwen2vl_bf16: losses {losses}, first batch's loss "
          f"{eval_before} -> {eval_after}")
    check(launches == want, f"train_qwen2vl_bf16: launches {launches}, "
          f"expected {want}")
    check(by_body == want_by_body, f"train_qwen2vl_bf16: launches by body "
          f"{by_body}, expected {want_by_body}")
    return launches, by_body


def _bf16_by_body(rglru: bool = False) -> dict:
    """The launches by body of the bf16 train phases that remat: RMSNorm
    and flash attention, each way, and flash attention by head dim, each
    way; with ``rglru`` the RG-LRU's each way too."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.rglru import kernel as lru
    from repro_torch.kernels.rmsnorm import kernel as rms
    return {**({"rglru": dict(lru.rglru_cuda.launches_by_body),
                "rglru_bwd": dict(lru.rglru_bwd_cuda.launches_by_body)}
               if rglru else {}),
            "rmsnorm": dict(rms.rmsnorm_cuda.launches_by_body),
            "rmsnorm_bwd": dict(rms.rmsnorm_bwd_cuda.launches_by_body),
            "flash_attention": dict(
                flash.flash_attention_cuda.launches_by_body),
            "flash_attention_bwd": dict(
                flash.flash_attention_bwd_cuda.launches_by_body),
            "flash_attention_by_head_dim": _flash_by_head_dim(),
            "flash_attention_bwd_by_head_dim": _flash_by_head_dim(True)}


def _bf16_remat_launches(L: int, dh: int, steps: int, policy: str,
                         bwd_body: str, fwd_body: str = "sm90",
                         n_lru: int = 0) -> tuple:
    """(launches, launches by body) of ``steps`` bf16 steps of a stack of L
    layers, ``n_lru`` of them RG-LRU layers and the rest attention at head
    dim ``dh``: the backward reruns each superblock's forward under every
    policy but ``none``, and with it its kernels (opaque to the policy:
    their autograd Functions launch through ctypes), so the forwards
    double: flash A → 2A for A attention layers, the RG-LRU n_lru → 2
    n_lru, RMSNorm 2L + 1 → 4L + 1 (the final norm outside the stack); the
    backwards stay A, n_lru and 2L + 1.  The flash forwards on
    ``fwd_body``, RMSNorm's on one_read, the RMSNorm backwards on cta_rows
    (rows past 1024 elements), the RG-LRU on its segmented bodies (S >=
    64; its gates stay fp32 in a bf16 step)."""
    again = 1 if policy == "none" else 2
    A = L - n_lru
    fwd_flash, fwd_rms = again * A * steps, (again * 2 * L + 1) * steps
    fwd_lru = again * n_lru * steps
    want = {"rmsnorm": (fwd_rms, (2 * L + 1) * steps),
            "flash_attention": (fwd_flash, A * steps),
            "rglru": (fwd_lru, n_lru * steps), "ssd": (0, 0)}
    by_body = {
        **({"rglru": {"segmented": fwd_lru, "serial": 0},
            "rglru_bwd": {"segmented": n_lru * steps, "serial": 0}}
           if n_lru else {}),
        "rmsnorm": {"one_read": fwd_rms, "generic": 0},
        "rmsnorm_bwd": {"warp_rows": 0, "cta_rows": (2 * L + 1) * steps,
                        "generic": 0},
        "flash_attention": {"sm90": 0, "mma": 0, "mma_tf32x3": 0, "fp32": 0,
                            fwd_body: fwd_flash},
        "flash_attention_bwd": {"mma_tf32x3": 0, "mma_bf16": 0, "sm90": 0,
                                bwd_body: A * steps},
        "flash_attention_by_head_dim": {fwd_body: {dh: fwd_flash}},
        "flash_attention_bwd_by_head_dim": {bwd_body: {dh: A * steps}}}
    return want, by_body


def _summed(a, b):
    """Two launch records (dicts of counts or tuples of counts) added."""
    if isinstance(a, dict):
        return {k: _summed(a[k], b[k]) if k in a and k in b else
                a.get(k, b.get(k)) for k in {**a, **b}}
    if isinstance(a, tuple):
        return tuple(x + y for x, y in zip(a, b))
    return a + b


def phase_train_qwen2vl_remat(dev, seed, steps: int = 3, batch: int = 4,
                              seq: int = 1024, lr: float = 3e-4):
    """qwen2-vl-2b at full width and depth in bf16, as
    ``train_qwen2vl_bf16`` (fp32 weights, gradients and moments, batch 4 x
    1024 from ``SyntheticLM``), under each of the four remat policies
    (``parallel.POLICIES``), each from the same weights (drawn on the card
    from the seed) and the same batches.  For each policy: the first
    batch's loss and gradients alone (``make_loss_and_grad``, beside fp32
    moments as in a step) with that call's peak memory, every gradient leaf
    held against the ``none`` call's, kept on the card and left out of the
    peaks (the same bits, or the largest relative L2 printed and held
    within ``TRAIN_CHECK_LIMITS[bfloat16]``);
    then ``steps`` steps of ``make_train_step``: step ms, the whole step's
    peak memory (AdamW's functional update holds the old and the new
    weights and moments at its end: 28 B a parameter) beside
    ``train_bounds``' 16 B a parameter, and the launches a step by body
    (``_bf16_remat_launches``).  Launches are counted over the steps only;
    returns their sum over the four policies."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.optim import init_opt_state
    from repro_torch.parallel import POLICIES
    from repro_torch.train.steps import (TrainConfig, make_loss_and_grad,
                                         make_train_step)
    cfg = get_config("qwen2-vl-2b")
    L, dh = cfg.num_layers, cfg.resolved_head_dim
    limits = TRAIN_CHECK_LIMITS[torch.bfloat16]
    data = iter(SyntheticLM(cfg, batch=batch, seq_len=seq, seed=seed))
    host_batches = [next(data) for _ in range(steps)]
    ref, kept, rows, total_launches, total_by_body = None, 0, {}, None, None
    for policy in POLICIES:
        gc.collect()
        torch.cuda.empty_cache()
        t_policy = time.monotonic()
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, device=dev, dtype=torch.float32,
                             generator=gen)
        opt = init_opt_state(params)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in hb.items()}
                   for hb in host_batches]
        tc = TrainConfig(dtype=torch.bfloat16, remat_policy=policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        total, _, grads = make_loss_and_grad(cfg, tc)(params, batches[0])
        torch.cuda.synchronize()
        grad_ms = (time.perf_counter() - t0) * 1e3
        # the peaks leave out the none call's gradients, kept on the card
        # to hold the others against
        grad_peak = torch.cuda.max_memory_allocated() - kept
        leaves = _leaves(grads)
        del grads
        if ref is None:
            ref = dict(loss=float(total), leaves=leaves)
            kept = sum(t.nbytes for t in leaves)
            held = dict(same_bits=True, grad_rel_l2=0.0)
        else:
            same = float(total) == ref["loss"] and all(
                torch.equal(a, b) for a, b in zip(leaves, ref["leaves"]))
            rel = 0.0 if same else max(
                float((a.float() - b.float()).norm()
                      / max(float(b.float().norm()), 1e-30))
                for a, b in zip(leaves, ref["leaves"]))
            held = dict(same_bits=same, grad_rel_l2=rel,
                        loss_rel_err=abs(float(total) - ref["loss"])
                        / abs(ref["loss"]))
        del leaves
        step = make_train_step(cfg, tc)
        step_ms = []
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b, torch.tensor(lr))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches, by_body = _count_launches(), _bf16_by_body()
        peak = torch.cuda.max_memory_allocated() - kept
        del params, opt, batches, m
        want, want_by_body = _bf16_remat_launches(L, dh, steps, policy,
                                                  "sm90")
        rows[policy] = dict(
            loss=float(total), **held, grad_call_ms=grad_ms,
            grad_peak_mem_bytes=grad_peak, step_ms_all=step_ms,
            step_ms_median=statistics.median(step_ms[1:]),
            step_ms_min=min(step_ms), peak_mem_bytes=peak,
            launches_per_step={k: dict(forward=f / steps, backward=b / steps)
                               for k, (f, b) in launches.items() if f or b},
            launches_by_body=by_body, launches_ok=launches == want,
            launches_by_body_ok=by_body == want_by_body,
            launches_by_body_expected=want_by_body,
            seconds=time.monotonic() - t_policy)
        total_launches = launches if total_launches is None else _summed(
            total_launches, launches)
        total_by_body = by_body if total_by_body is None else _summed(
            total_by_body, by_body)
        row = rows[policy]
        check(math.isfinite(row["loss"]) and row["launches_ok"]
              and row["launches_by_body_ok"]
              and (row["same_bits"] or (row["grad_rel_l2"] < limits["grad"]
                                        and row["loss_rel_err"]
                                        < limits["loss"])),
              f"train_qwen2vl_remat {policy}: {row}")
    del ref
    bounds = train_bounds(cfg, batch, seq, torch.bfloat16)
    emit("train_qwen2vl_remat", arch=cfg.name, layers=L, reduced=None,
         dtype="bfloat16", batch=batch, seq=seq, steps=steps, lr=lr,
         params=cfg.param_count(), step_bound_ms=bounds["step_bound_ms"],
         peak_mem_bound_bytes=bounds["peak_mem_bound_bytes"],
         adamw_end_bytes=28 * cfg.param_count(), grad_limits=limits,
         reference_grad_bytes_left_out=kept, policies=rows)
    return total_launches, total_by_body


@contextlib.contextmanager
def _expandable_segments():
    """The caching allocator growing its segments in place inside the
    block (every cached segment released at both ends), fixed segments,
    the default, after it."""
    def settings(value: str):
        gc.collect()
        torch.cuda.empty_cache()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            torch.cuda.memory._set_allocator_settings(
                f"expandable_segments:{value}")
    settings("True")
    try:
        yield
    finally:
        settings("False")


def phase_train_stablelm3b_bf16(dev, seed, steps: int = 10, batch: int = 4,
                                seq: int = 1024, lr: float = 3e-4):
    """stablelm-3b at full width and depth, nothing cut (32 layers, 2.80 B
    parameters, MHA 32 / 32 at head dim 80, untied 50304-word vocabulary),
    under ``TrainConfig()``'s defaults: bf16 and the reference's remat
    policy ``dots_no_batch`` (each layer checkpointed, its products without
    batch dims kept), through ``_train_bf16``: a step launches 2L = 64
    flash forwards on the sm90 body at dh 80 (the backward reruns each
    layer's), L = 32 flash backwards on sm90 at dh 80, 4L + 1 = 129 RMSNorm
    forwards on one_read and 2L + 1 = 65 backwards on cta_rows.  16 B a
    parameter are 44.74 GB, AdamW's 28 B at the end of its functional update
    78.27 GB."""
    from repro_torch.configs import get_config
    return _train_bf16(dev, seed, "train_stablelm3b_bf16",
                       get_config("stablelm-3b"), None, steps, batch, seq, lr)


def phase_train_rgemma_bf16(dev, seed, steps: int = 5, batch: int = 1,
                            seq: int = TRAIN_4K, lr: float = 3e-4):
    """recurrentgemma-9b at full width (d_model 4096, 16 heads of 256, MQA,
    window 2048, RG-LRU width 4096, GeGLU 12288, tied vocabulary 256000)
    cut to 3 layers, its first superblock (rglru, rglru, attn_local), under
    ``TrainConfig()`` (bf16, ``dots_no_batch``), batch 1 x 4096 (the
    reference's ``train_4k`` sequence, where the window bites), through
    ``_train_bf16``: a step launches 2 flash forwards on sm90 at dh 256 and
    1 backward on sm90 at dh 256 (column halves), 4 RG-LRU forwards and 2
    backwards on the segmented bodies, 13 RMSNorm forwards on one_read and
    7 backwards on cta_rows."""
    from repro_torch.configs import get_config
    return _train_bf16(
        dev, seed, "train_rgemma_bf16",
        dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=3),
        "num_layers 38 -> 3; global batch 256 -> 1 (38 layers at 28 B a "
        "parameter, AdamW's end, are 238.7 GB)", steps, batch, seq, lr)


def phase_train_stablelm12b_bf16(dev, seed, steps: int = 5, batch: int = 1,
                                 seq: int = TRAIN_4K, lr: float = 3e-4):
    """stablelm-12b at full width (d_model 5120, GQA 32 / 8 at head dim
    160, SwiGLU 13824, untied vocabulary 100352) cut to 2 layers, under
    ``TrainConfig()`` (bf16, ``dots_no_batch``), batch 1 x 4096, through
    ``_train_bf16``: a step launches 4 flash forwards on the sm90 body at
    dh 160 (``Sm90<160>``, with its log-sum-exp; the backward reruns each
    layer's) and 2 backwards on sm90 at dh 160 (column halves), 9 RMSNorm
    forwards on one_read and 5 backwards on cta_rows."""
    from repro_torch.configs import get_config
    return _train_bf16(
        dev, seed, "train_stablelm12b_bf16",
        dataclasses.replace(get_config("stablelm-12b"), num_layers=2),
        "num_layers 40 -> 2; global batch 256 -> 1 (40 layers at 28 B a "
        "parameter are 340.0 GB)", steps, batch, seq, lr)


# what the bf16 train phases measured, by phase: the dry-run phase's
# predictions stand beside these
MEASURED: dict[str, dict] = {}


def _train_bf16(dev, seed, name: str, cfg, reduced, steps: int, batch: int,
                seq: int, lr: float):
    """``cfg`` at full width under ``TrainConfig()``'s defaults: bf16 and
    the reference's remat policy ``dots_no_batch`` (each superblock
    checkpointed, its products without batch dims kept).  ``steps`` steps
    of ``make_train_step`` on ``SyntheticLM`` batches, no checkpoint: every
    loss finite, and the first batch's loss (``make_eval_step``) lower after
    the steps than before them; the launches a step, each way and by body
    and head dim, those ``_bf16_remat_launches`` gives (the flash forward
    on the body the forward's ``select_body`` takes at this head dim, every
    flash backward on sm90).  Step ms (median of steps 3 on), peak memory
    beside ``train_bounds`` (16 B a parameter) and AdamW's 28 B a parameter
    at the end of its functional update, the peak of one loss-and-gradient
    call alone before the steps (where remat acts), one more step profiled
    by kernel family.  The phase grows the allocator's segments in place
    (``expandable_segments``) and puts the default back after: with fixed
    segments, stablelm-3b's AdamW end failed for want of 2.11 GiB with 5.58
    GiB reserved but unallocated (PERF.md).  Emits line ``name``
    (``reduced``: the cuts, or None)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models import init_params
    from repro_torch.optim import init_opt_state
    from repro_torch.train.steps import (TrainConfig, make_eval_step,
                                         make_loss_and_grad, make_train_step)
    tc = TrainConfig()
    kinds = cfg._layer_kinds()
    L, n_lru, dh = len(kinds), kinds.count("rglru"), cfg.resolved_head_dim
    with _expandable_segments():
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, device=dev, dtype=torch.float32,
                             generator=gen)
        opt = init_opt_state(params)
        step, evaluate = make_train_step(cfg, tc), make_eval_step(cfg, tc)
        data = iter(SyntheticLM(cfg, batch=batch, seq_len=seq, seed=seed))
        first = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(data).items()}
        eval_before = float(evaluate(params, first)["loss"])
        # the loss-and-gradient call alone, beside the weights and moments
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        make_loss_and_grad(cfg, tc)(params, first)
        torch.cuda.synchronize()
        grad_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        _reset_launches()
        for i in range(steps):
            b = first if i == 0 else {k: torch.from_numpy(v).to(dev)
                                      for k, v in next(data).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b, torch.tensor(lr))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        launches, by_body = _count_launches(), _bf16_by_body(rglru=n_lru > 0)
        peak = torch.cuda.max_memory_allocated()
        eval_after = float(evaluate(params, first)["loss"])
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        prof = _profiled(lambda: step(params, opt, b, torch.tensor(lr)),
                         groups={**BF16_GROUPS, **(
                             {k: RGEMMA_GROUPS[k] for k in (
                                 "rglru_forward", "rglru_backward")}
                             if n_lru else {})})
        fwd_body = flash.select_body(*(torch.empty(
            (1, 1, n, dh), dtype=torch.bfloat16, device=dev) for n in (
            cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads)))
        del params, opt, b, first, m
    want, want_by_body = _bf16_remat_launches(L, dh, steps, tc.remat_policy,
                                              "sm90", fwd_body, n_lru)
    # a step's launches by kernel, under the names the twins charge
    per_step = {k + suffix: n / steps for k, fb in launches.items()
                for suffix, n in zip(("", "_bwd"), fb) if n}
    MEASURED[name] = dict(arch=cfg.name, layers=L, batch=batch, seq=seq,
                          peak_mem_bytes=peak,
                          step_ms_median=statistics.median(step_ms[2:]),
                          model_flops=train_bounds(
                              cfg, batch, seq, torch.bfloat16)["model_flops"],
                          launches_a_step=per_step)
    emit(name, arch=cfg.name, layers=L, layer_kinds=kinds, reduced=reduced,
         d_model=cfg.d_model, d_ff=cfg.d_ff, head_dim=dh,
         heads=cfg.num_heads, kv_heads=cfg.num_kv_heads, window=cfg.window,
         lru_width=cfg.resolved_lru_width if n_lru else None,
         vocab=cfg.vocab_size, params=cfg.param_count(), dtype="bfloat16",
         remat_policy=tc.remat_policy, batch=batch, seq=seq, steps=steps,
         lr=lr, losses=losses, first_batch_loss_before=eval_before,
         first_batch_loss_after=eval_after,
         step_ms_median=statistics.median(step_ms[2:]),
         step_ms_min=min(step_ms), step_ms_max=max(step_ms),
         step_ms_all=step_ms, resident_bytes_before=resident,
         grad_peak_mem_bytes=grad_peak, peak_mem_bytes=peak,
         adamw_end_bytes=28 * cfg.param_count(),
         allocator="expandable_segments:True",
         card_bytes=torch.cuda.get_device_properties(dev).total_memory,
         **train_bounds(cfg, batch, seq, torch.bfloat16), profile=prof,
         launches={k: dict(forward=f, backward=b)
                   for k, (f, b) in launches.items()},
         launches_expected={k: dict(forward=f, backward=b)
                            for k, (f, b) in want.items()},
         launches_by_body=by_body, launches_by_body_expected=want_by_body)
    check(len(losses) == steps and all(math.isfinite(x) for x in losses)
          and eval_after < eval_before,
          f"{name}: losses {losses}, first batch's loss "
          f"{eval_before} -> {eval_after}")
    check(launches == want, f"{name}: launches {launches}, "
          f"expected {want}")
    check(by_body == want_by_body, f"{name}: launches by "
          f"body {by_body}, expected {want_by_body}")
    return launches, by_body


def phase_encode_hubert(dev, seed, batch: int = 1, seq: int = PREFILL_32K,
                        repeats: int = 3):
    """hubert-xlarge at full width and depth (48 layers, bidirectional
    attention at head dim 80, GELU FFN, the audio stub frontend), bf16,
    through ``make_encode_step`` on random frame features (batch x seq x
    512): the dry-run's prefill_32k sequence, its global batch of 32 over a
    pod cut to ``batch`` on one card.  Logits finite; one encode launches
    48 flash forwards on the sm90 body at dh 80 (no causal mask) and 2L + 1
    = 97 RMSNorm forwards.  ms an encode (the median of ``repeats`` after
    the counted one), peak memory and the bound: the projections and the
    frontend (2 x tokens x parameters) and the attention of
    ``flops_parts`` (no mask: every pair) over 989 TFLOP/s; one more encode
    profiled by kernel family."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.models import init_params
    from repro_torch.train import make_encode_step
    cfg = get_config("hubert-xlarge")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, device=dev, dtype=torch.bfloat16, generator=gen)
    feats = torch.randn(batch, seq, 512, generator=gen, device=dev).to(
        torch.bfloat16)
    encode = make_encode_step(cfg, dtype=torch.bfloat16)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = encode(params, {"features": feats})
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = _count_launches()
    by_body = {"flash_attention": dict(
                   flash.flash_attention_cuda.launches_by_body),
               "flash_attention_by_head_dim": _flash_by_head_dim(),
               "rmsnorm": dict(rms.rmsnorm_cuda.launches_by_body)}
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    del logits
    ms = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode(params, {"features": feats})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    prof = _profiled(lambda: encode(params, {"features": feats}),
                     groups=BF16_GROUPS)
    tokens = batch * seq
    parts = cfg.flops_parts(tokens, training=False, seq_len=seq)
    frontend = 2 * tokens * 512 * cfg.d_model
    flops = parts["base"] + parts["attn"] + frontend
    del params, feats
    L = cfg.num_layers
    want = {"rmsnorm": (2 * L + 1, 0), "flash_attention": (L, 0),
            "rglru": (0, 0), "ssd": (0, 0)}
    want_by_body = {
        "flash_attention": {"sm90": L, "mma": 0, "mma_tf32x3": 0, "fp32": 0},
        "flash_attention_by_head_dim": {"sm90": {cfg.resolved_head_dim: L}},
        "rmsnorm": {"one_read": 2 * L + 1, "generic": 0}}
    emit("encode_hubert", arch=cfg.name, layers=L,
         reduced="global batch 32 (the dry-run's prefill_32k over a pod) -> "
                 f"{batch} on one card; sequence {seq} kept",
         d_model=cfg.d_model, d_ff=cfg.d_ff, head_dim=cfg.resolved_head_dim,
         heads=cfg.num_heads, causal=cfg.causal, act=cfg.act,
         params=cfg.param_count(), dtype="bfloat16", batch=batch, seq=seq,
         logits_shape=shape, finite=finite, first_ms=first_ms,
         encode_ms_median=statistics.median(ms), encode_ms_all=ms,
         bound_ms=flops / PEAK_OPS_PER_S[torch.bfloat16] * 1e3,
         flops=flops, attn_flops=parts["attn"], peak_mem_bytes=peak,
         profile=prof,
         launches={k: dict(forward=f, backward=b)
                   for k, (f, b) in launches.items()},
         launches_expected={k: dict(forward=f, backward=b)
                            for k, (f, b) in want.items()},
         launches_by_body=by_body, launches_by_body_expected=want_by_body)
    check(finite and shape == (batch, seq, cfg.vocab_size),
          f"encode_hubert: logits {shape}, finite {finite}")
    check(not cfg.causal and launches == want,
          f"encode_hubert: launches {launches}, expected {want}")
    check(by_body == want_by_body, f"encode_hubert: launches by body "
          f"{by_body}, expected {want_by_body}")
    return launches, by_body


# the mesh phase: the serve whose weights and first wave it takes, and the
# train step it runs (stablelm-3b at full width cut to 2 layers)
MESH_SERVE = "qwen2-7b"
MESH_TRAIN_LAYERS = 2
# the flash-decode check at qwen2-7b's decode shape: q (B, 1, H, dh) over
# a cache of S slots (K heads), the first FILLED slots filled
MESH_DECODE = dict(B=4, H=28, K=4, dh=128, S=544, filled=272)


def phase_mesh(dev, seed, served, first):
    """The port's mesh path on the card, in this process: NCCL at world
    size 1 (``launch.mesh.make_debug_mesh``: a (1, 1) ("data", "model")
    mesh on ``cuda``, an in-process store), the reference's
    ``make_debug_mesh(1)``.

    1. ``MESH_SERVE`` (qwen2-7b whole, bf16, the serve phase's weights)
       serves the serve phase's first wave (batch 4, prompt 512, 32
       greedy tokens) through ``make_prefill_step`` / ``make_decode_step``
       with ``mesh=`` on the shards of ``serve_shardings``: its tokens
       equal the serve phase's, its logits within 2e-2 (1 + |x|).
    2. stablelm-3b at full width cut to ``MESH_TRAIN_LAYERS`` layers,
       ``TrainConfig()`` (bf16, ``dots_no_batch``, ZeRO-1) and the same in
       fp32: ``make_loss_and_grad`` and ``make_train_step`` with ``mesh=``
       on ``train_shardings``' shards against the plain ones on the same
       weights and batch (4 x 1024), within ``TRAIN_CHECK_LIMITS``; the fp32
       step's parameters within 2 lr of the plain step's.
    3. ``seq_sharded_decode_attention`` on CUDA tensors at qwen2-7b's decode
       shape (``MESH_DECODE``) against ``mha_ref`` (bf16, 2e-2 (1 + |x|)),
       ``int8_psum`` against its quantize-dequantize (exactly), and
       ``pp_forward`` with one stage against the stack (fp32, 2e-4 of the
       largest value).

    Times (host clock, synchronised): first one all-reduce on each axis's
    group, the communicators' set-up (``comm_warm_s``); the mesh wave
    beside the serve phase's waves (its first one cold), each mesh step (a
    loss-and-gradient call and a train step) beside the plain one before
    it (cold), then each mesh step and plain step again (warm).  The
    launch counts are zeroed before 1 and read after 2 (the
    plain steps run before and after, the checks of 3 after): they must be
    the wave's
    (2L + 1 RMSNorms a position, L sm90 flash forwards at dh 128 in
    prefill) plus the plain steps' own.  The process group is destroyed at
    the end.  Returns (launches, launches by body) as a train phase does."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_cache, init_params, param_specs
    from repro_torch.models.model import _make_ctx, _run_stack
    from repro_torch.optim import init_opt_state
    from repro_torch.parallel.compress import int8_psum
    from repro_torch.parallel.flash_decode import seq_sharded_decode_attention
    from repro_torch.parallel.pipeline import pp_forward, pp_stage_body
    from repro_torch.parallel.sharding import shard_tree
    from repro_torch.train.steps import (TrainConfig, make_decode_step,
                                         make_loss_and_grad, make_prefill_step,
                                         make_train_step, serve_shardings,
                                         train_shardings)
    t_phase = time.monotonic()
    mesh = make_debug_mesh(device=dev)
    init_s = time.monotonic() - t_phase
    backend = dist.get_backend()
    try:
        # NCCL brings a communicator up at its first collective: one
        # all-reduce on each axis's group here, timed apart, so that no
        # timed step below pays for it
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for axis in mesh.mesh_dim_names:
            dist.all_reduce(torch.zeros(1, device=dev),
                            group=mesh.get_group(axis))
        torch.cuda.synchronize()
        comm_warm_s = time.monotonic() - t0
        # ---- the plain steps (the reference; before the counted window)
        cfg_t = dataclasses.replace(get_config("stablelm-3b"),
                                    num_layers=MESH_TRAIN_LAYERS)
        tcs = {"bfloat16": TrainConfig(),
               "float32": TrainConfig(dtype=torch.float32)}
        params = init_params(cfg_t, device=dev, dtype=torch.float32,
                             generator=torch.Generator(device=dev)
                             .manual_seed(seed))
        data = next(iter(SyntheticLM(cfg_t, batch=4, seq_len=1024,
                                     seed=seed)))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
        lr = torch.tensor(1e-3)
        opt = init_opt_state(params)
        _reset_launches()
        plain = {}
        for name, tc in tcs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            total, _, grads = make_loss_and_grad(cfg_t, tc)(params, batch)
            new_p, _, m = make_train_step(cfg_t, tc)(params, opt, batch, lr)
            torch.cuda.synchronize()
            plain[name] = dict(loss=float(total), grads=grads, new=new_p,
                               step_loss=float(m["loss"]),
                               ms=(time.perf_counter() - t0) * 1e3)
        plain_launches = (_count_launches(), _bf16_by_body())

        # ---- the counted window: the mesh wave, then the mesh steps
        cfg, w_params, _, _, _, max_len = served
        prompt = first["prompt"]
        B, max_new = prompt.shape[0], len(first["logits"]) - 1
        cache = init_cache(cfg, B, max_len, torch.bfloat16, device=dev)
        sh = serve_shardings(cfg, mesh, w_params, cache, B, max_len)
        lp, lc = shard_tree(w_params, sh["params"]), shard_tree(cache,
                                                                sh["cache"])
        kw = dict(dtype=torch.bfloat16, mesh=mesh, batch=B, max_len=max_len)
        pre, dec = make_prefill_step(cfg, **kw), make_decode_step(cfg, **kw)
        _reset_launches()
        with torch.inference_mode():
            torch.cuda.synchronize()
            w0 = time.monotonic()
            last, lc = pre(lp, {"tokens": prompt}, lc)
            torch.cuda.synchronize()
            w1 = time.monotonic()
            seen, toks = [last], []
            tok = torch.argmax(last, -1)[:, None].to(torch.int32)
            for _ in range(max_new):
                tok, logits, lc = dec(lp, tok, lc)
                seen.append(logits)
                toks.append(tok)
            torch.cuda.synchronize()
            w2 = time.monotonic()
        del lp, lc, cache
        seen, toks = torch.stack(seen), torch.cat(toks, 1).cpu()
        wave_err = _wave_err(seen, first["logits"])
        wave_same = bool(torch.equal(toks, first["tokens"]))
        del seen

        tsh = train_shardings(cfg_t, mesh, param_specs(cfg_t), batch,
                              zero1=True)
        local = shard_tree({"p": params, "o": opt, "b": batch},
                           {"p": tsh["params"], "o": tsh["opt"],
                            "b": tsh["batch"]})
        on_mesh = {}
        for name, tc in tcs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            total, _, grads = make_loss_and_grad(cfg_t, tc, mesh=mesh)(
                local["p"], local["b"])
            new_p, _, m = make_train_step(cfg_t, tc, mesh=mesh)(
                local["p"], local["o"], local["b"], lr)
            torch.cuda.synchronize()
            on_mesh[name] = dict(loss=float(total), grads=grads, new=new_p,
                                 step_loss=float(m["loss"]),
                                 ms=(time.perf_counter() - t0) * 1e3)
        launches, by_body = _count_launches(), _bf16_by_body()
        for name, tc in tcs.items():    # each step again, warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            make_loss_and_grad(cfg_t, tc, mesh=mesh)(local["p"], local["b"])
            make_train_step(cfg_t, tc, mesh=mesh)(local["p"], local["o"],
                                                  local["b"], lr)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            make_loss_and_grad(cfg_t, tc)(params, batch)
            make_train_step(cfg_t, tc)(params, opt, batch, lr)
            torch.cuda.synchronize()
            on_mesh[name]["ms_again"] = (t1 - t0) * 1e3
            plain[name]["ms_again"] = (time.perf_counter() - t1) * 1e3
        L = cfg.num_layers
        wave_want = {"rmsnorm": ((2 * L + 1) * (1 + max_new), 0),
                     "flash_attention": (L, 0), "rglru": (0, 0),
                     "ssd": (0, 0)}
        wave_by_body = {
            "rmsnorm": {"one_read": (2 * L + 1) * (1 + max_new),
                        "generic": 0},
            "flash_attention": {"sm90": L, "mma": 0, "mma_tf32x3": 0,
                                "fp32": 0},
            "flash_attention_by_head_dim": {
                "sm90": {cfg.resolved_head_dim: L}}}
        want_launches = _summed(plain_launches[0], wave_want)
        want_by_body = _summed(plain_launches[1], wave_by_body)

        # ---- the steps against the plain ones
        steps = {}
        ok_steps = True
        for name, tc in tcs.items():
            a, b = on_mesh[name], plain[name]
            limits = TRAIN_CHECK_LIMITS[tc.dtype]
            grad = _grad_rel(a["grads"], b["grads"], limits["grad_metric"])
            loss = abs(a["loss"] - b["loss"]) / abs(b["loss"])
            step_loss = abs(a["step_loss"] - b["step_loss"]) / abs(
                b["step_loss"])
            param = max(float((x.float() - y.float()).abs().max())
                        for x, y in zip(_leaves(a["new"]),
                                        _leaves(b["new"])))
            finite = all(bool(torch.isfinite(x).all())
                         for x in _leaves(a["new"]))
            steps[name] = dict(loss_mesh=a["loss"], loss_plain=b["loss"],
                               loss_rel_err=loss, step_loss_rel_err=step_loss,
                               grad_metric=limits["grad_metric"],
                               grad_rel_err=grad, loss_tol=limits["loss"],
                               grad_tol=limits["grad"],
                               param_max_abs_err=param,
                               param_bound=2 * float(lr), finite=finite,
                               ms_plain=b["ms"], ms_mesh=a["ms"],
                               ms_mesh_again=a["ms_again"],
                               ms_plain_again=b["ms_again"])
            ok_steps &= (finite and loss < limits["loss"]
                         and step_loss < limits["loss"]
                         and grad < limits["grad"]
                         and (tc.dtype != torch.float32
                              or param <= 2 * float(lr)))
        del on_mesh, plain, local, params, opt, grads, new_p

        # ---- flash-decode, int8_psum, the one-stage pipeline
        g = torch.Generator(device=dev).manual_seed(seed)
        d = MESH_DECODE
        bf = dict(device=dev, dtype=torch.bfloat16, generator=g)
        q = torch.randn(d["B"], 1, d["H"], d["dh"], **bf)
        k = torch.randn(d["B"], d["S"], d["K"], d["dh"], **bf)
        v = torch.randn(d["B"], d["S"], d["K"], d["dh"], **bf)
        slots = torch.arange(d["S"], device=dev, dtype=torch.int32)
        k_pos = torch.where(slots < d["filled"], slots, -1)
        t = d["filled"] - 1
        got = seq_sharded_decode_attention(mesh, ("model",), q, k, v, k_pos,
                                           t, causal=True)
        ref = mha_ref(q, k, v, causal=True,
                      q_positions=torch.full((d["B"], 1), t,
                                             dtype=torch.int32, device=dev),
                      k_positions=k_pos[None].expand(d["B"], d["S"]))
        decode_err = float(((got.float() - ref.float()).abs()
                            / (1 + ref.float().abs())).max())
        x = torch.randn(4096, 2560, device=dev, generator=g)
        scale = x.abs().max() / 127.0
        qd = torch.clamp(torch.round(x / scale), -127, 127) * scale
        psum_same = bool(torch.equal(int8_psum(x, mesh, "data"), qd))
        mesh3 = init_device_mesh(mesh.device_type, (1, 1, 1),
                                 mesh_dim_names=("pod", "data", "model"))
        p32 = init_params(cfg_t, device=dev, dtype=torch.float32,
                          generator=g)
        xm = torch.randn(2, 2, 256, cfg_t.d_model, device=dev, generator=g)
        pos = torch.arange(256, dtype=torch.int32, device=dev).expand(2, 256)
        ctx = _make_ctx(cfg_t, pos, None, 0)
        with torch.no_grad():
            pp = pp_forward(mesh3, pp_stage_body(cfg_t, ctx, torch.float32),
                            p32["blocks"], xm)
            seq = torch.stack([_run_stack(p32, xm[i], cfg_t, ctx, None)[0]
                               for i in range(xm.shape[0])])
        pp_err = float((pp - seq).abs().max() / seq.abs().max())
        del p32, xm, pp, seq, x, qd
    finally:
        dist.destroy_process_group()
    emit("mesh", mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
         backend=backend, world_size=1, init_s=init_s,
         comm_warm_s=comm_warm_s,
         serve=dict(arch=cfg.name, layers=cfg.num_layers, batch=B,
                    prompt=prompt.shape[1], new_tokens=max_new,
                    tokens_equal=wave_same, logits_err=wave_err,
                    logits_tol=2e-2, prefill_ms_mesh=(w1 - w0) * 1e3,
                    prefill_ms_plain_waves=first["prefill_ms"],
                    decode_ms_mesh=(w2 - w1) * 1e3,
                    decode_ms_plain_waves=first["decode_ms"],
                    cache_spec=str(sh["cache_specs"]["blocks"][0]["k"])),
         train=dict(arch=cfg_t.name, layers=cfg_t.num_layers,
                    d_model=cfg_t.d_model, batch=4, seq=1024, zero1=True,
                    remat_policy=tcs["bfloat16"].remat_policy, **steps),
         flash_decode=dict(shape=d, max_abs_err_rel=decode_err, tol=2e-2),
         int8_psum_equal=psum_same, pp_forward_rel_err=pp_err,
         pp_tol=2e-4, launches={k: dict(forward=f, backward=b)
                                for k, (f, b) in launches.items()},
         launches_expected={k: dict(forward=f, backward=b)
                            for k, (f, b) in want_launches.items()},
         launches_by_body=by_body,
         launches_by_body_expected=want_by_body,
         seconds=time.monotonic() - t_phase)
    check(wave_same and wave_err <= 2e-2,
          f"mesh: {cfg.name} wave: tokens equal {wave_same}, logits "
          f"{wave_err}")
    check(ok_steps, f"mesh: {cfg_t.name} steps against the plain: {steps}")
    check(decode_err <= 2e-2, f"mesh: flash_decode {decode_err}")
    check(psum_same, "mesh: int8_psum differs from its quantize-dequantize")
    check(pp_err <= 2e-4, f"mesh: pp_forward {pp_err}")
    check(launches == want_launches and by_body == want_by_body,
          f"mesh: launches {launches} by body {by_body}, expected "
          f"{want_launches} / {want_by_body}")
    return launches, by_body


# the mesh phase's blocks (``phase_mesh_blocks``): moonshot-v1-16b-a3b's
# train step (layers, batch, seq, steps), recurrentgemma-9b's first
# superblock (batch, seq), hubert-xlarge's encode (layers, frames) and
# qwen2-vl-2b's wave with an image block (layers, batch, prompt, new tokens)
MESH_MOE = dict(layers=2, batch=2, seq=1024, steps=3)
MESH_RGEMMA = dict(batch=1, seq=TRAIN_4K)
MESH_HUBERT = dict(layers=2, seq=PREFILL_32K)
MESH_VL = dict(layers=2, batch=4, prompt=512, new=32)


def _mesh_part(plain_fn, mesh_fn, rglru: bool = False):
    """(plain result, mesh result, mesh launches, mesh launches by body,
    plain launches, plain launches by body): each run with the counts set
    to 0 just before it and read just after."""
    out = []
    for fn in (plain_fn, mesh_fn):
        _reset_launches()
        out.append((fn(), _count_launches(), _bf16_by_body(rglru=rglru)))
    (p, pl, pb), (m, ml, mb) = out
    return p, m, ml, mb, pl, pb


def _grad_rel(a, b, metric: str) -> float:
    """The largest relative error over the leaves of two gradient trees:
    in L2 norm (``l2``) or of the largest element (``max``)."""
    def one(x, y):
        x, y = x.float(), y.float()
        if metric == "l2":
            return float((x - y).norm()) / max(float(y.norm()), 1e-30)
        return float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
    return max(one(x, y) for x, y in zip(_leaves(a), _leaves(b))
               if y.numel())


def _wave_err(got, want) -> float:
    want = want.float()
    return float(((got.float() - want).abs() / (1 + want.abs())).max())


def phase_mesh_blocks(dev, seed):
    """The blocks that run on a mesh since the eleventh slice (expert
    parallelism and the MoE over data ranks, the RG-LRU width, the audio
    frontend and the vision scatter on ``model``), on the card at world
    size 1 over NCCL (``launch.mesh.make_debug_mesh``, a (1, 1) ("data",
    "model") mesh; its own process group, destroyed at the end), each
    through the entry points with ``mesh=`` on the shards of
    ``train_shardings`` / ``serve_shardings`` against the plain call on the
    same weights and inputs:

    a. moonshot-v1-16b-a3b at full width cut to 2 layers (64 experts,
       top-6, 2 shared; 1.85 B parameters), ``TrainConfig()`` (bf16,
       ``dots_no_batch``, ZeRO-1), batch 2 x 1024: ``make_loss_and_grad``
       within ``TRAIN_CHECK_LIMITS[bfloat16]`` of the plain call, the
       (token, layer) routes that flipped between them counted; then 3
       mesh train steps on that batch, whose loss falls; step ms and peak
       memory beside 16 B a parameter.
    b. recurrentgemma-9b's first superblock at full width (rglru, rglru,
       attn_local), bf16, 1 x 4096: the mesh loss-and-gradient against the
       plain one, through the RG-LRU forward and backward kernels.
    c. hubert-xlarge cut to 2 layers: ``make_encode_step`` of 1 x 32768
       frames on the mesh against the plain encode, within 2e-2 (1 + |x|).
    d. qwen2-vl-2b cut to 2 layers: one wave (batch 4, prompt 512 with a
       16 x 16 image block, 32 greedy tokens) through the mesh's prefill
       and decode steps against the plain wave: the same tokens, the
       logits within 2e-2 (1 + |x|).

    Each part's mesh launches, counted from 0 in its own window, equal the
    plain run's, counted the same way, and are not zero for any kernel the
    part runs (flash and RMSNorm each way in a and b, the RG-LRU each way
    in b, flash and RMSNorm forwards in c and d).  Returns (launches,
    launches by body) summed over the parts' mesh runs."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_cache, init_params, param_specs
    from repro_torch.models.blocks import record_routes
    from repro_torch.optim import init_opt_state
    from repro_torch.parallel.sharding import batch_pspecs, shard_tree
    from repro_torch.train.steps import (TrainConfig, make_decode_step,
                                         make_encode_step, make_loss_and_grad,
                                         make_prefill_step, make_train_step,
                                         serve_shardings, train_shardings)
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_debug_mesh(device=dev)
    tc = TrainConfig()
    limits = TRAIN_CHECK_LIMITS[tc.dtype]
    totals, parts, oks = None, {}, {}

    def add(launches, by_body):
        nonlocal totals
        totals = (launches, by_body) if totals is None else (
            _summed(totals[0], launches), _summed(totals[1], by_body))

    def ran(launches, kernels, backward: bool):
        return all(launches[k][0] > 0 and (not backward or launches[k][1] > 0)
                   for k in kernels)

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def train_data(cfg, batch, seq):
        data = next(iter(SyntheticLM(cfg, batch=batch, seq_len=seq,
                                     seed=seed)))
        return {k: torch.from_numpy(v).to(dev) for k, v in data.items()}

    def loss_and_grad_pair(cfg, batch, kernels):
        """The plain and the mesh loss-and-gradient call on the same
        weights and batch; the weights, the batch and their shards."""
        params = init_params(cfg, device=dev, dtype=torch.float32,
                             generator=torch.Generator(device=dev)
                             .manual_seed(seed))
        sh = train_shardings(cfg, mesh, param_specs(cfg), batch, zero1=True)
        local = shard_tree({"p": params, "b": batch},
                           {"p": sh["params"], "b": sh["batch"]})
        routes = {}

        def run(name, fn):
            def call():
                with record_routes() as routes[name]:
                    total, (_, aux), grads = fn()
                return float(total), float(aux), grads
            return lambda: synced(call)
        (p, p_ms), (m, m_ms), ml, mb, pl, pb = _mesh_part(
            run("plain", lambda: make_loss_and_grad(cfg, tc)(params, batch)),
            run("mesh", lambda: make_loss_and_grad(cfg, tc, mesh=mesh)(
                local["p"], local["b"])), rglru="rglru" in kernels)
        add(ml, mb)
        grad = _grad_rel(m[2], p[2], limits["grad_metric"])
        loss = abs(m[0] - p[0]) / abs(p[0])
        finite = all(bool(torch.isfinite(g).all()) for g in _leaves(m[2]))
        res = dict(loss_mesh=m[0], loss_plain=p[0], aux_mesh=m[1],
                   aux_plain=p[1], loss_rel_err=loss, loss_tol=limits["loss"],
                   grad_metric=limits["grad_metric"], grad_rel_err=grad,
                   grad_tol=limits["grad"], finite=finite, ms_plain=p_ms,
                   ms_mesh=m_ms, launches=ml, launches_plain=pl,
                   launches_by_body=mb, launches_by_body_plain=pb)
        if routes["plain"]:
            res.update(route_stats(
                [(a[1], b[1]) for a, b in zip(routes["plain"],
                                              routes["mesh"])],
                routes["plain"] + routes["mesh"], cfg.experts_per_token))
        ok = finite and loss < limits["loss"] and grad < limits["grad"] \
            and ml == pl and mb == pb and ran(ml, kernels, True)
        return res, ok, params, local, sh

    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for axis in mesh.mesh_dim_names:    # the communicators, apart
            dist.all_reduce(torch.zeros(1, device=dev),
                            group=mesh.get_group(axis))
        torch.cuda.synchronize()
        comm_warm_s = time.monotonic() - t0

        # ---- a. moonshot-v1-16b-a3b: EP / MoE over data, then 3 steps
        m = MESH_MOE
        cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                                  num_layers=m["layers"])
        with _expandable_segments():
            batch = train_data(cfg, m["batch"], m["seq"])
            res, ok, params, local, sh = loss_and_grad_pair(
                cfg, batch, ("rmsnorm", "flash_attention"))
            del params
            gc.collect()
            opt = shard_tree(init_opt_state(local["p"]), sh["opt"])
            step = make_train_step(cfg, tc, mesh=mesh)
            lr = torch.tensor(1e-3)
            prm, lb = local["p"], local["b"]
            del local, batch
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            losses, step_ms = [], []
            for _ in range(m["steps"]):
                (prm, opt, met), ms = synced(
                    lambda: step(prm, opt, lb, lr))
                losses.append(float(met["loss"]))
                step_ms.append(ms)
            step_launches = _count_launches()
            step_by_body = _bf16_by_body()
            peak = torch.cuda.max_memory_allocated()
            del prm, opt, lb, met
        add(step_launches, step_by_body)
        want = {k: tuple(m["steps"] * n for n in v)
                for k, v in res["launches_plain"].items()}
        falls = all(math.isfinite(x) for x in losses) and \
            losses[-1] < losses[0]
        parts["moonshot"] = dict(
            arch=cfg.name, layers=cfg.num_layers,
            reduced=f"num_layers 48 -> {cfg.num_layers}; global batch "
                    f"-> {m['batch']} x {m['seq']} on one card",
            params=cfg.param_count(), experts=cfg.num_experts,
            top_k=cfg.experts_per_token, batch=m["batch"], seq=m["seq"],
            **res, steps=m["steps"], step_losses=losses, step_ms=step_ms,
            step_peak_mem_bytes=peak,
            peak_mem_bound_bytes=16 * cfg.param_count(),
            step_launches=step_launches, step_launches_expected=want)
        oks["moonshot"] = ok and falls and step_launches == want

        # ---- b. recurrentgemma-9b's first superblock: the RG-LRU width
        m = MESH_RGEMMA
        cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                                  num_layers=3)
        batch = train_data(cfg, m["batch"], m["seq"])
        res, ok, params, local, _ = loss_and_grad_pair(
            cfg, batch, ("rmsnorm", "flash_attention", "rglru"))
        del params, local, batch
        parts["rgemma"] = dict(arch=cfg.name, layers=3,
                               layer_kinds=cfg._layer_kinds(),
                               reduced="num_layers 38 -> 3",
                               params=cfg.param_count(), **res, **m)
        oks["rgemma"] = ok
        gc.collect()
        torch.cuda.empty_cache()

        # ---- c. hubert-xlarge: the audio frontend on the mesh's encode
        m = MESH_HUBERT
        cfg = dataclasses.replace(get_config("hubert-xlarge"),
                                  num_layers=m["layers"])
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, device=dev, dtype=torch.bfloat16,
                             generator=gen)
        feats = {"features": torch.randn(1, m["seq"], 512, generator=gen,
                                         device=dev).to(torch.bfloat16)}
        sh = train_shardings(cfg, mesh, param_specs(cfg), feats)
        lp, lf = shard_tree(params, sh["params"]), shard_tree(feats,
                                                              sh["batch"])
        (p, p_ms), (got, m_ms), ml, mb, pl, pb = _mesh_part(
            lambda: synced(lambda: make_encode_step(cfg)(params, feats)),
            lambda: synced(lambda: make_encode_step(cfg, mesh=mesh)(lp, lf)))
        add(ml, mb)
        err = _wave_err(got, p)
        parts["hubert"] = dict(arch=cfg.name, layers=cfg.num_layers,
                               reduced=f"num_layers 48 -> {cfg.num_layers}",
                               frames=m["seq"], logits_shape=list(got.shape),
                               logits_err=err, logits_tol=2e-2,
                               ms_plain=p_ms, ms_mesh=m_ms, launches=ml,
                               launches_plain=pl, launches_by_body=mb)
        oks["hubert"] = err <= 2e-2 and ml == pl and mb == pb and \
            ran(ml, ("rmsnorm", "flash_attention"), False)
        del params, feats, lp, lf, p, got

        # ---- d. qwen2-vl-2b: a wave whose prompts hold an image block
        m = MESH_VL
        cfg = dataclasses.replace(get_config("qwen2-vl-2b"),
                                  num_layers=m["layers"])
        B, P, max_len = m["batch"], m["prompt"], m["prompt"] + m["new"] + 8
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, device=dev, dtype=torch.bfloat16,
                             generator=gen)
        prompt = {"tokens": torch.randint(0, cfg.vocab_size, (B, P),
                                          generator=gen, device=dev),
                  **vision_prompt(cfg, B, P, *VISION_GRID["serve"], gen, dev,
                                  torch.bfloat16)}
        cache = init_cache(cfg, B, max_len, torch.bfloat16, device=dev)
        sh = serve_shardings(cfg, mesh, params, cache, B, max_len)
        lp = shard_tree(params, sh["params"])
        lb = shard_tree(prompt, batch_pspecs(cfg, prompt, mesh), mesh)

        def wave(pre, dec, prm, inputs, c):
            with torch.inference_mode():
                last, c = pre(prm, inputs, c)
                seen, toks = [last], []
                tok = torch.argmax(last, -1)[:, None].to(torch.int32)
                for _ in range(m["new"]):
                    tok, logits, c = dec(prm, tok, c)
                    seen.append(logits)
                    toks.append(tok)
            return torch.stack(seen), torch.cat(toks, 1)
        kw = dict(dtype=torch.bfloat16)
        mkw = dict(kw, mesh=mesh, batch=B, max_len=max_len)
        (p, p_ms), (got, m_ms), ml, mb, pl, pb = _mesh_part(
            lambda: synced(lambda: wave(
                make_prefill_step(cfg, **kw), make_decode_step(cfg, **kw),
                params, prompt, init_cache(cfg, B, max_len, torch.bfloat16,
                                           device=dev))),
            lambda: synced(lambda: wave(
                make_prefill_step(cfg, **mkw), make_decode_step(cfg, **mkw),
                lp, lb, shard_tree(cache, sh["cache"]))))
        add(ml, mb)
        err = _wave_err(got[0], p[0])
        same = bool(torch.equal(got[1], p[1]))
        parts["qwen2vl"] = dict(arch=cfg.name, layers=cfg.num_layers,
                                reduced=f"num_layers 28 -> {cfg.num_layers}",
                                batch=B, prompt=P, new_tokens=m["new"],
                                image=dict(grid=VISION_GRID["serve"][0],
                                           offset=VISION_GRID["serve"][1]),
                                tokens_equal=same, logits_err=err,
                                logits_tol=2e-2, ms_plain=p_ms, ms_mesh=m_ms,
                                launches=ml, launches_plain=pl,
                                launches_by_body=mb)
        oks["qwen2vl"] = same and err <= 2e-2 and ml == pl and mb == pb \
            and ran(ml, ("rmsnorm", "flash_attention"), False)
        del params, lp, cache, prompt, lb, p, got
    finally:
        dist.destroy_process_group()
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).strip()
    emit("mesh_blocks", card=smi, mesh=dict(zip(mesh.mesh_dim_names,
                                                mesh.shape)),
         world_size=1, comm_warm_s=comm_warm_s, **parts, ok=oks,
         seconds=time.monotonic() - t_phase)
    for name, good in oks.items():
        check(good, f"mesh_blocks: {name}: {parts[name]}")
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


# kernel families of the recurrentgemma-9b train step (3 layers), by the
# kernel's name with its spaces removed
RGEMMA_GROUPS = {
    "rglru_forward": ("rglru_segmented_kernel",),
    "rglru_backward": ("rglru_bwd_",),
    "flash_forward": ("flash_attn_",),
    "flash_backward": ("flash_bwd_",),
    "rmsnorm": ("rmsnorm",),
}


# kernel families of the mamba2-130m train step, by the kernel's name with
# its spaces removed: the SSD forward's own launches (its state pass is the
# backward's too, and is given apart), the SSD backward's, RMSNorm's
MAMBA2_GROUPS = {
    "ssd_forward": ("ssd_state_mma_kernel<float,false",
                    "ssd_cb_kernel<float,false>", "ssd_chunk_scan_tf32_kernel"),
    "ssd_state_pass": ("ssd_state_pass_kernel",),
    "ssd_backward": ("ssd_bwd_", "ssd_state_mma_kernel<float,true",
                     "ssd_cb_kernel<float,true>"),
    "rmsnorm": ("rmsnorm",),
}


# the serve profile of an MoE model: the port's kernels by name; the MoE
# block's kernels by the profiler ranges ``_moe_span`` puts around it and
# around its experts and shared expert (see ``_span_split``)
MOE_GROUPS = {"flash_attention": ("flash_attn_",), "rmsnorm": ("rmsnorm",)}
MOE_SPAN = "moe_forward"
# the ranges inside ``MOE_SPAN``: the functions of ``repro_torch.models.
# blocks`` that ``moe_forward`` calls, by range
MOE_RANGES = {"moe_experts": "expert_ffn", "moe_shared_expert": "gated_mlp"}


def _span_split(prof, span: str) -> dict:
    """Device ms and launches of the kernels launched inside the profiler
    range ``span``, by the range and the outermost aten op under ``span``
    that launched them: inside ``moe_experts`` the expert products
    (``aten::einsum``) and the experts' elementwise ops (the activation,
    g·u, the pad that restores the trash slot); inside ``moe_shared_expert``
    the shared expert (its products and elementwise ops); outside both the
    router's product (``aten::matmul``) and the rest, the routing
    bookkeeping (softmax, topk, the stable sort, searchsorted, the
    gathers, scatters and ``index_put_``, the dispatch buffer's zero fill,
    the combine's weighting and sum over k, the aux loss)."""
    from torch.autograd import DeviceType
    out = {k: dict(ms=0.0, launches=0) for k in (
        "expert_products", "expert_elementwise", "shared_expert",
        "router_product", "router_bookkeeping")}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        chain, parent = [], e
        while parent is not None:
            chain.append(parent.name)
            parent = parent.cpu_parent
        if span not in chain:
            continue
        inner = chain[:chain.index(span)]
        below = [n for n in inner if n.startswith("aten::")]
        top = below[-1] if below else ""
        part = ("shared_expert" if "moe_shared_expert" in inner else
                ("expert_products" if top == "aten::einsum" else
                 "expert_elementwise") if "moe_experts" in inner else
                "router_product" if top == "aten::matmul" else
                "router_bookkeeping")
        out[part]["ms"] += sum(k.duration for k in e.kernels) / 1e3
        out[part]["launches"] += len(e.kernels)
    return out


def _moe_span(fn):
    """``fn`` with every ``moe_forward`` call inside the profiler range
    ``MOE_SPAN``, and the functions of ``MOE_RANGES`` inside theirs (module
    attributes that ``apply_block`` and ``moe_forward`` call, swapped for
    the call and put back; ``gated_mlp``'s range outside ``MOE_SPAN``, the
    dense layers', is not read)."""
    from repro_torch.models import blocks
    names = {MOE_SPAN: "moe_forward", **MOE_RANGES}
    inner = {fname: getattr(blocks, fname) for fname in names.values()}

    def traced(label, f):
        def call(*args, **kw):
            with torch.profiler.record_function(label):
                return f(*args, **kw)
        return call

    def run():
        for label, fname in names.items():
            setattr(blocks, fname, traced(label, inner[fname]))
        try:
            return fn()
        finally:
            for fname, f in inner.items():
                setattr(blocks, fname, f)

    return run


def _profiled(fn, groups=None, span=None) -> dict:
    """Wall time, summed kernel time, idle share and the costliest kernels
    of one call, from torch.profiler (device time "not measured" if the
    trace holds no kernel); with ``groups`` ({label: name parts}), each
    group's device ms, launches and share of the wall time; with ``span``
    (a profiler range in ``fn``), ``_span_split`` of it; ``host_gap_ms``
    is the wall time the card was idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    # the ranges show on the card's timeline too (as user annotations
    # spanning their kernels): not kernels, so not counted
    ranges = {span, *MOE_RANGES} if span else set()
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0
                      and e.key not in ranges),
                     reverse=True)
    if not kernels:
        return dict(wall_ms=wall_ms, device_ms="not measured")
    device_ms = sum(k[0] for k in kernels)
    out = dict(wall_ms=wall_ms, device_ms=device_ms,
               idle_share=1 - device_ms / wall_ms,
               host_gap_ms=wall_ms - device_ms,
               top=[dict(ms=ms, count=n, kernel=name[:80])
                    for ms, n, name in kernels[:8]])
    if groups:
        out["groups"] = {}
        for label, parts in groups.items():
            hit = [(ms, n) for ms, n, name in kernels
                   if any(q in name.replace(" ", "") for q in parts)]
            ms = sum(h[0] for h in hit)
            out["groups"][label] = dict(ms=ms, launches=sum(h[1] for h in hit),
                                        share_of_wall=ms / wall_ms)
    if span:
        for label, part in _span_split(prof, span).items():
            out.setdefault("groups", {})[label] = dict(
                part, share_of_wall=part["ms"] / wall_ms)
    return out


def phase_profile(dev, cfg, params, pre, dec, prompt, max_len,
                  n_dec: int = 8):
    """Where the serve phase's time goes: one prefill wave and ``n_dec``
    decode steps again, under the profiler (after the launch counts were
    read, so they do not count).  An MoE model's are split into the
    routing bookkeeping, the router's product, the expert products, the
    experts' elementwise ops, the shared expert, flash attention, rmsnorm
    and the host gap."""
    from repro_torch.models import init_cache
    with torch.inference_mode():
        cache = init_cache(cfg, prompt["tokens"].shape[0], max_len,
                           torch.bfloat16, device=dev)
        state = {}

        def run_prefill():
            state["last"], _ = pre(params, prompt, cache)

        def run_decode():
            tok = torch.argmax(state["last"], -1)[:, None].to(torch.int32)
            for _ in range(n_dec):
                tok, _, _ = dec(params, tok, cache)

        if cfg.num_experts:
            split = dict(groups=MOE_GROUPS, span=MOE_SPAN)
            run_prefill, run_decode = (_moe_span(run_prefill),
                                       _moe_span(run_decode))
        else:
            split = {}
        emit("profile", arch=cfg.name, prefill=_profiled(run_prefill, **split),
             decode_steps=n_dec, decode=_profiled(run_decode, **split))

# the dry-run phase: one production cell through the CLI (a 256-rank fake
# group), then the bf16 train phases' cells at world size 1
DRYRUN_CELL = ("qwen2-7b", "train_4k")
DRYRUN_PHASES = (("train_rgemma_bf16", "recurrentgemma-9b"),
                 ("train_stablelm12b_bf16", "stablelm-12b"))
# the phases' cells at world size 1, as the reference's own mini dry-run
# patches its mesh and shapes: a (1, 1) mesh over a fake group of one rank,
# train_4k's batch 1, the phase's cut in depth
DRYRUN_WS1 = """
import json, sys
import repro_torch.launch.dryrun as D
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_debug_mesh
D.start_fake_group(1)
D.make_production_mesh = lambda multi_pod=False, device="cuda": \\
    make_debug_mesh(1, device=device)
cell = S.SHAPES["train_4k"]
S.SHAPES["train_4k"] = S.ShapeCell(cell.name, cell.seq_len, 1, cell.step)
for arch, layers in json.loads(sys.argv[1]):
    rec = D.run_cell(arch, "train_4k", multi_pod=False, verbose=False,
                     cfg_overrides={"num_layers": layers})
    print("DRYRUN " + json.dumps(rec))
"""


def _dryrun(args: list, timeout: int = 300) -> tuple[str, float]:
    """(stdout, seconds) of one dry-run process on this checkout."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    check(out.returncode == 0, f"dryrun {args[:3]}: rc {out.returncode}: "
          f"{out.stderr[-2000:]}")
    return out.stdout, seconds


def phase_dryrun():
    """``launch/dryrun.py`` on this card's torch, in processes of its own
    (this one holds an NCCL default group): (a) one production cell,
    qwen2-7b x train_4k x 16x16, through the CLI (a 256-rank fake group,
    fake CUDA tensors, the kernels' shape-only twins); (b) the cells the
    bf16 train phases measured in this run, recurrentgemma-9b cut to 3
    layers and stablelm-12b cut to 2 at train_4k's 1 x 4096, at world size
    1.  For each of (b): the predicted per-device peak beside the phase's
    ``peak_mem_bytes`` and their ratio (recorded, not gated), the roofline
    ``step_time_s`` beside the measured step, ``model_flops`` beside
    ``train_bounds``' (must be equal), the traced FLOPs over it, and each
    twin's launches beside the launches a step the phase counted on the
    card (must be equal: the traced path is the path the card ran).  Fails
    on a status other than ok.  Then the SSD twins' workspace sizes
    (``fwd_tf32_workspace_floats``, ``bwd_workspace_floats``, mirrors of
    ``csrc/ssd.cu``'s) against the library's own host functions at
    mamba2-130m's train and serve shapes (must be equal).  Launches no
    kernel here."""
    out_dir = ROOT / "build" / "dryrun_torch" / "smoke"
    arch, shape = DRYRUN_CELL
    _, cli_s = _dryrun(["-m", "repro_torch.launch.dryrun", "--arch", arch,
                        "--shape", shape, "--single-pod-only", "--force",
                        "--out", str(out_dir)])
    cell = json.loads((out_dir / f"{arch}__{shape}__16x16.json").read_text())
    check(cell["status"] == "ok", f"dryrun {arch} x {shape}: {cell}")
    cells = [(a, MEASURED[name]["layers"]) for name, a in DRYRUN_PHASES]
    stdout, ws1_s = _dryrun(["-c", DRYRUN_WS1, json.dumps(cells)])
    recs = [json.loads(line[len("DRYRUN "):]) for line in stdout.splitlines()
            if line.startswith("DRYRUN ")]
    check(len(recs) == len(cells), f"dryrun at world size 1: {stdout}")
    compared = {}
    for (name, _), rec in zip(DRYRUN_PHASES, recs):
        m = MEASURED[name]
        check(rec["status"] == "ok", f"dryrun {name}: {rec}")
        executed = rec["flops_per_device"] * rec["chips"]
        compared[name] = dict(
            arch=rec["arch"], layers=m["layers"], batch=m["batch"],
            seq=m["seq"], status=rec["status"],
            predicted_peak_bytes=rec["peak_memory_per_device"],
            measured_peak_bytes=m["peak_mem_bytes"],
            peak_ratio=rec["peak_memory_per_device"] / m["peak_mem_bytes"],
            step_time_ms=rec["step_time_s"] * 1e3,
            measured_step_ms=m["step_ms_median"],
            bottleneck=rec["bottleneck"],
            compute_ms=rec["compute_s"] * 1e3,
            memory_ms=rec["memory_s"] * 1e3, model_flops=rec["model_flops"],
            train_bounds_model_flops=m["model_flops"],
            executed_over_model_flops=executed / rec["model_flops"],
            kernels=rec["kernels"], measured_launches_a_step=m[
                "launches_a_step"], trace_s=rec["trace_s"])
        check(math.isclose(rec["model_flops"], m["model_flops"],
                           rel_tol=1e-12),
              f"dryrun {name}: model_flops {rec['model_flops']} against "
              f"train_bounds' {m['model_flops']}")
        twins = {k: v["launches"] for k, v in rec["kernels"].items()}
        check(twins == m["launches_a_step"], f"dryrun {name}: the twins' "
              f"launches {twins}, the card's a step {m['launches_a_step']}")
    from repro_torch.kernels.ssd import kernel as ssd
    workspaces = {}
    # mamba2-130m's train step (8 x 1024) and serve wave (4 x 512), and its
    # train step at MAMBA2_P128 (the backward's two slabs; the tile of 128)
    for dims in ((8, 1024, 24, 64, 1, 128, 128),
                 (4, 512, 24, 64, 1, 128, 128),
                 (8, 1024, 12, 128, 1, 128, 128)):
        mirror = dict(fwd_mma_tf32=ssd.fwd_tf32_workspace_floats(*dims),
                      **{f"bwd_{b}": ssd.bwd_workspace_floats(b, *dims)
                         for b in ssd.BWD_BODIES})
        library = dict(fwd_mma_tf32=ssd._entry(
            "ssd_fwd_mma_tf32_workspace_floats")(*dims),
            bwd_mma=ssd._entry("ssd_bwd_mma_workspace_floats")(*dims),
            bwd_fma=ssd._entry("ssd_bwd_workspace_floats")(*dims))
        workspaces[str(dims)] = dict(mirror=mirror, library=library)
        check(mirror == library, f"ssd workspace floats at {dims}: the "
              f"twins' {mirror}, the library's {library}")
    emit("dryrun", cell=dict(
        arch=arch, shape=shape, mesh=cell["mesh"], status=cell["status"],
        device=cell["device"], peak_memory_per_device=cell[
            "peak_memory_per_device"], bottleneck=cell["bottleneck"],
        compute_ms=cell["compute_s"] * 1e3, memory_ms=cell["memory_s"] * 1e3,
        collective_ms=cell["collective_s"] * 1e3,
        useful_flops_ratio=cell["useful_flops_ratio"],
        trace_s=cell["trace_s"], kernels=cell["kernels"]),
        cli_s=cli_s, world_size_1_s=ws1_s, seconds=cli_s + ws1_s,
        world_size_1=compared, ssd_workspace_floats=workspaces)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing to run", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    smi = phase_env(_build)
    summary = phase_kernels(dev, gen, args.seed)
    phase_serve_check(dev, gen, "qwen2-7b", layers=4, B=2, P=128)
    phase_serve_check(dev, gen, "recurrentgemma-9b", layers=3, B=1, P=2176)
    phase_serve_check(dev, gen, "mamba2-130m", layers=24, B=2, P=1000)
    phase_serve_check(dev, gen, "moonshot-v1-16b-a3b", layers=4, B=2, P=128)
    gc.collect()
    torch.cuda.empty_cache()
    # 43.5 GB of fp32 weights: nothing else resident
    phase_serve_check(dev, gen, "llama4-scout-17b-a16e", layers=4, B=1,
                      P=512)
    gc.collect()
    torch.cuda.empty_cache()
    phase_ssd_bodies(dev, gen)
    # after ssd_bodies, whose limit was set on the weights it draws
    phase_serve_check(dev, gen, "qwen2-vl-2b", layers=4, B=2, P=128)
    launches, by_body = {}, {}
    train, train_by_body = {}, {}
    for arch, layers, reduced in SERVES:
        gc.collect()
        torch.cuda.empty_cache()
        launches[arch], by_body[arch], served, first = phase_serve(
            dev, gen, args.seed, arch, layers, reduced)
        phase_profile(dev, *served)
        if arch == MESH_SERVE:  # on this serve's weights, while they last
            train["mesh"], train_by_body["mesh"] = phase_mesh(
                dev, args.seed, served, first)
        del served, first   # free this model's weights before the next one
    gc.collect()
    torch.cuda.empty_cache()
    launches["serve-mamba2-p128"], by_body["serve-mamba2-p128"] = \
        phase_serve_mamba2_p128(dev, args.seed)
    blocks = phase_mesh_blocks(dev, args.seed)
    train["mesh"] = _summed(train["mesh"], blocks[0])
    train_by_body["mesh"] = _summed(train_by_body["mesh"], blocks[1])
    gc.collect()
    torch.cuda.empty_cache()
    train_checks(dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    for path, phase in (("train-100m", phase_train),
                        ("train-mamba2", phase_train_mamba2),
                        ("train-mamba2-p128", phase_train_mamba2_p128),
                        ("train-rgemma-3l", phase_train_rgemma_3l),
                        ("train-rgemma-bf16", phase_train_rgemma_bf16),
                        ("train-qwen2vl-bf16", phase_train_qwen2vl_bf16),
                        ("train-qwen2vl-remat", phase_train_qwen2vl_remat),
                        ("train-stablelm3b-bf16",
                         phase_train_stablelm3b_bf16),
                        ("train-stablelm12b-bf16",
                         phase_train_stablelm12b_bf16),
                        ("encode-hubert", phase_encode_hubert)):
        train[path], train_by_body[path] = phase(dev, args.seed)
    phase_dryrun()
    for name, entry in summary.items():
        # one body of a kernel, at the head dims given if any: its launches
        if "counted_as" in entry:
            kernel, body, *dims = entry["counted_as"]
            paths = [*by_body.items(), *train_by_body.items()]
            entry["launches_by_path"] = {
                path: b[kernel][body] for path, b in paths if kernel in b
            } if not dims else {
                path: sum(b[kernel + "_by_head_dim"].get(body, {}).get(d, 0)
                          for d in dims[0])
                for path, b in paths if kernel + "_by_head_dim" in b}
            entry["launches"] = sum(entry["launches_by_path"].values())
            if dims:
                entry["launches_by_head_dim"] = {d: sum(
                    b[kernel + "_by_head_dim"].get(body, {}).get(d, 0)
                    for _, b in paths if kernel + "_by_head_dim" in b)
                    for d in dims[0]}
            continue
        if name.endswith("_bwd"):
            entry["launches_by_path"] = {
                path: n[name[:-len("_bwd")]][1] for path, n in train.items()}
            entry["launches"] = sum(entry["launches_by_path"].values())
            entry["launches_by_body"] = {
                path: b[name] for path, b in train_by_body.items()
                if name in b}
            continue
        entry["launches_by_path"] = {a: n[name] for a, n in launches.items()}
        entry["launches_by_path"].update(
            {path: n[name][0] for path, n in train.items()})
        entry["launches"] = sum(entry["launches_by_path"].values())
        entry["launches_by_body"] = {
            body: sum(b[name][body] for b in by_body.values())
            for body in by_body[SERVES[0][0]][name]}
    print(json.dumps({"kernels": list(summary.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
