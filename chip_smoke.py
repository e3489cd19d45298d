#!/usr/bin/env python3
"""Drive the PyTorch port of EfficientSAM3 on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, TF32 settings, and the build of the CUDA kernels
     (csrc/*.cu, one nvcc per source, all started together); for each
     wgmma kernel (flash_sdpa_h and flash_sdpa_h_fp32 at d=32, 64, 80 and
     256, the bank kernel flash_memattn_h and its int8-key instantiation
     flash_memattn_q8_h, each in bf16 and fp32, flash_sdpa_bwd_h and
     flash_sdpa_bwd_dq_h at d=32, 64 and 80, flash_sdpa_bwd_h_fp32 and
     flash_sdpa_bwd_dq_h_fp32 at d=32, 64 and 80, the bf16 d=256 pair
     flash_sdpa_bwd_dq_wide_h / flash_sdpa_bwd_dkv_wide_h and the fp32 one
     flash_sdpa_bwd_dq_wide_f32 / flash_sdpa_bwd_dkv_wide_f32, and
     flash_xattn_rpb in bf16 and fp32 at the decoder's 72 x 72 map and its
     rule's key splits) one line of registers, spilled bytes and shared
     memory a block, and blocks an SM, as the runtime reports them
     (flash_xattn_rpb's also the clusters resident at once and its K / V
     stages); the layer_norm forward's registers, spills, vectors a lane
     and blocks an SM at 256 channels in its four dtype pairs;
  2. the main path at full width: EfficientViT-b1 ("EV-M") at 1008^2 with
     the MobileCLIP-S0 text tower at context 32, bf16, seeded random
     weights, through the port's Sam3Processor (set_image on a non-square
     uint8 image, text token ids encoded into state["text"], one box
     prompt). Every kernel launch counter is set to 0 just before and read
     just after: layer_norm 27, flash_sdpa 6 and flash_xattn_rpb 6 launches
     per ground call. encode_image, ground and the whole call are timed
     with CUDA events, and torch.profiler splits one encode_image and one
     ground into device time by kernel (tables under chiprun_out/);
  3. each kernel against its plain PyTorch version, on the inputs of its
     largest launch on the main path (captured in a warm-up run), with the
     tolerance stated; timed inside a CUDA graph (20 calls per graph, median
     of 20 replays, so the host's launch cost drops out) beside the plain
     version, one
     PyTorch library call computing the same function, and the least time
     the card could take (bytes or operations); the per-call time from the
     host (median of 50 between CUDA events) and the profiler's device
     time per launch on the main path are printed beside them (the ground's
     profile checks that flash_xattn_rpb is one kernel launch a call and
     layer_norm the CUDA forward); layer_norm's row also gives the
     profiler's device time of one call at its own shape, eager and over a
     CUDA-graph replay;
  4. output checks: finite outputs of the expected shapes, masks at the
     original resolution, and a small-input run of the tiny test config on
     the card held against the same model in fp32 on the CPU;
  5. [video] the tracker path at full width: build_efficientsam3_video_model
     (EV-M b1 with the SAM2 neck, TrackerCore at 1008^2: 72x72 tokens,
     d_model 256, 7 memories, 16 pointers, 4 memory-attention layers), bf16,
     seed 0, 12 synthetic 1008x1008 frames, TrackerPredictor with 8 object
     slots. Session A (the cached bank, the default): 3 objects prompted on
     frame 0 (a box, a click, a click pair), then propagate_in_video over all
     12 frames; per tracked frame flash_sdpa (d=256) 4, flash_memattn 4,
     layer_norm 13 and depthwise_conv2d 2 launches, flash_xattn_rpb 0.
     Session B (the plain path): the same objects plus a 4th added by
     add_new_mask on frame 6, whose memory frames differ from the others',
     propagated from frame 6; per tracked frame flash_sdpa 8 (4 self, 4
     cross over 36352 keys), flash_memattn 0. Counters are set to 0 just
     before each propagate and read just after. Frame encode, a prompted
     frame, a tracked frame of each session, the whole propagation and the
     peak memory are timed; torch.profiler splits one tracked frame of
     session A by kernel, and times each d=256 launch of one of session B.
     The three tracker kernels are held against their plain versions on the
     inputs of their largest launch in session A (flash_sdpa d=256 the
     wgmma kernel of csrc/flash_sdpa_h.cu, flash_memattn that of
     csrc/flash_memattn_h.cu, timed again over 1-8 live slots and 1-7 valid
     entries), flash_sdpa d=256 also on session B's
     cross-attention (a row of its own, library: SDPA with the bool key
     mask), and timed as in phase 3; the tiny tracker runs bf16 on the card
     against fp32 on the CPU;
  6. [train] Stage-3 training at full width: the EV-M 1008^2 model with
     MobileCLIP-S0 at context 32 in bf16 (fp32 parameters), seed 0, the
     default Stage3Config (trunk and text tower trained, heads frozen), a
     seeded synthetic batch of 4 shaped as Stage3MixedDataset makes it
     (Prompt.empty(4, 8, 8), 40 target slots with 2-5 objects an image,
     masks at 288x288). Trainer.run over stage3_train_step takes 6 steps
     (log_every 1, partial checkpoints of trunk and text tower every 3);
     a fresh model and optimizer take the same 6 steps from the same seed
     through a Trainer without checkpoints, and the two runs' losses,
     gradients, parameters, statistics and optimizer state must be equal
     bit for bit (the backward adds without atomics, and Trainer.run takes
     cuDNN's deterministic algorithms); a second Trainer on a fresh model
     resumes at step 6 and takes 2 more.
     Counters are set to 0 just before each step and read just after: per
     step flash_sdpa 6 (forward), flash_sdpa_bwd_dq 6, flash_sdpa_bwd_dkv 6,
     layer_norm 27 and layer_norm_bwd 27, flash_xattn_rpb 0. Checks: finite
     loss and grad_norm every step, frozen heads bit-identical, trunk and
     text tower changed, the resume, the trunk's gradient through the
     kernels against the same through the plain versions (batch 1; the
     same with the kernels' outputs cut from the graph shows the check
     would see a cut), and a tiny step on the card against the CPU (fp32
     and bf16). The step (median of
     steps 3-6) and its forward / loss / backward / optimizer parts, the
     matcher's host solve and the peak memory are timed; torch.profiler
     splits one step by kernel (the wgmma d=32 dq kernel, 6 launches); the
     three backward kernels are held against their plain versions on the
     inputs of their largest launch and timed as in phase 3 (in bf16 at d=32
     flash_sdpa_bwd_dq is the wgmma kernel of csrc/flash_sdpa_bwd_dq_h.cu and
     flash_sdpa_bwd_dkv that of csrc/flash_sdpa_bwd_h.cu), the dq + dkv pair
     beside SDPA's backward.

  7. [pcs] text-prompted video concept segmentation at full width:
     EfficientSam3System over build_efficientsam3_video_model (EV-M b1 at
     1008^2, MobileCLIP-S0 at context 32, bf16, seed 0; the object-score
     head's last bias raised by 10, so that random weights track objects
     instead of declaring them gone), video_predictor(obj_slots=8) with
     VideoPCSConfig(hotstart_delay=4, fill_hole_area=16), the prompt given
     as token ids, 12 synthetic frames (600x800 0-255 frames through
     Sam3Processor.preprocess, as the video entry points make them; the
     detector's image features of frame 0 must equal encode_frame's bit
     for bit). Every frame runs the real detector (set_preprocessed_image
     + ground on the card); since random weights detect nothing
     usable, its result is replaced by three seeded squares (score 0.9 on
     frame 0, where they spawn three masklets; 0.55 afterwards, below the
     spawn threshold). After a warm-up session, three sessions over the same
     frames: the exact bank, quantize_bank=True, and the plain path
     (cache_memory_kv=False). Counters are set to 0 just before each frame
     and read just after: per tracked frame flash_memattn_q8 4 (exact
     session: flash_memattn 4; plain path: 4 more flash_sdpa), flash_sdpa
     4 + 6, layer_norm 13 + 27, depthwise_conv2d 2, flash_xattn_rpb 6.
     Checks: finite masks of the right shapes, stable object ids, hole
     filling ran, a few VideoPredictorServer requests, and the mask IoU of
     the int8 session against the exact one per frame and object. The plain
     path computes the exact bank's attention with bf16 roundings at other
     places, so its IoU against the exact bank is the noise floor of this
     random bf16 model: the int8 bank's smallest IoU must stay within 0.02
     of the smaller of 0.98 (the bound the CPU tests hold in fp32) and that
     floor, and its mean above 0.98. A frame's time is split into detector,
     tracker step, quantize_rows and host association + emission; a detector
     call that keeps 3 queries is timed beside (this random model keeps
     most of the 200); torch.profiler splits one q8 frame by kernel (the int8 bank's
     wgmma kernel of csrc/flash_memattn_h.cu, 4 launches). flash_memattn_q8 is
     held against its plain version on the inputs of its largest launch,
     with and without the log-sum-exp, and against flash_memattn over the
     dequantized keys, and timed as in phase 3 beside flash_memattn on the
     same keys and over the number of live slots;
  8. [probe] the int8 / bf16 tensor-core probe (ops/mma_probe.bench_dot,
     the wgmma kernel of csrc/mma_probe.cu): 64 chained (768, 256) @ (256,
     2048) products a launch, against its plain version, each chain beside
     its bound, with torch._int_mm / torch.matmul as the library time, the
     int8 : bf16 rate and each chain's clock64 sections (staging, waiting
     on the tensor cores, converting);
  9. [tracker_train] the tracker's training path at full width: the [video]
     configuration (fuser layer scales set to 1, so that the depthwise
     branch carries gradient, and the object-score head's last bias raised
     by 10 as in [pcs], so that tracked frames keep their objects and pass
     gradient), every TrackerCore parameter trained, training
     mode (dropout 0.1), an 8-frame clip over 8 object slots with the 3
     objects of [video] prompted on frame 0 and frames 1-7 tracked on the
     plain path over the predictor's fixed-width bank (frame 7: 7 memories
     and 64 pointer tokens, 36352 keys); the loss is a seeded projection of
     the live slots' low-res masks, one backward. Counters are set to 0
     just before the clip and read after its forward and after its
     backward: forward flash_sdpa 8 and layer_norm 13 per tracked frame,
     depthwise_conv2d 2 per memory encode; backward flash_sdpa_bwd_dq /
     _dkv 8 and layer_norm_bwd 13 per tracked frame, depthwise_conv2d_bwd 2
     per memory a later frame reads; flash_memattn, flash_memattn_q8 and
     flash_xattn_rpb 0. Checks: finite loss, masks and gradients, every
     module group reached; two runs of the clip from one seed give the same
     loss and gradients bit for bit (runs 1-3 under cuDNN's deterministic
     algorithms, as the port's training entry points take them); the
     gradient of a 3-frame clip over the 3 live
     slots through the kernels, through the plain versions and with the
     kernels' outputs cut from the graph (same dropout bits). The clip's
     forward, backward and peak memory are timed and torch.profiler splits
     one backward by kernel (one line: the backward's ms, its device time
     and the d=256 pair's share of it). The d=256 backward kernels (bf16:
     the wgmma kernels of csrc/flash_sdpa_bwd_wide_h.cu; at the largest
     cross-attention and at the self-attention, each beside SDPA's
     backward), the depthwise backward and
     rms_norm_2d forward and backward (kernel level, at (8, 72, 72, 256)
     and (4, 63, 63, 128) bf16 and (8, 72, 72, 256) fp32; the backward the
     one-launch RMS mode of csrc/layer_norm.cu, the same bits twice, one
     kernel a call in a graph replay) are held against their plain
     versions and timed as in phase 3. The three
     backward kernels that finish dw / db by atomic tickets (depthwise,
     LayerNorm, RMSNorm) run on two streams at once: the bits of each call
     alone, each stream's ticket buffer its own, every buffer back at 0.

  10. [fp32] the port's default builds (no dtype: fp32 compute, every
     kernel through its fp32 instantiation on split bf16 parts) at full
     width: one ground (launches 27 / 6 / 6) held against the same model and
     inputs in fp32 on the host's CPU (plain versions; 1e-2 of each output's
     largest magnitude) and set beside phase 2's bf16 ground (scores, boxes,
     mask IoU, printed: the fp32 full-width reference of the bf16 build);
     one tracked frame on the cached exact bank and one with
     quantize_bank=True (launches per tracked frame as session A, the bank
     kernel flash_memattn or flash_memattn_q8; int8 vs exact mask IoU mean >
     0.98); one Stage-3 step at batch 4 (launches as [train]); a 3-frame
     tracker training clip on a compact bank (forward and backward launches
     as [tracker_train]; one line: the backward's wall ms, its device time
     and the fp32 d=256 pair's share of it, the split passes of
     csrc/flash_sdpa_bwd_wide_h_fp32.cu charged to the kernel launched after
     them). Counters are set to 0 just before each and read
     just after. Each fp32 instantiation (flash_sdpa d=32 and d=256 (the
     split-bf16 wgmma kernels of csrc/flash_sdpa_h_fp32.cu), its dq
     and dkv at d=32 and d=256, flash_memattn, flash_memattn_q8,
     flash_xattn_rpb, layer_norm, depthwise_conv2d forward and backward) is
     held against its fp32 plain version on the inputs of its largest launch there, at
     FP32_TOL, and timed as in phase 3 (library: fp32 SDPA, fp32 F.conv2d
     with cuDNN's TF32 off); at the clip's cross shape the d=256 pair's
     split pass (split_parts) is held bit for bit to split_parts_plain on
     the rows its kernels read. Phase 3's flash_sdpa row is the wgmma kernel
     (csrc/flash_sdpa_h.cu); [train] times it again at the step's
     (4, 8, 5184, 32).
  11. [sam3] the SAM3 teacher at full width (ViTDet ViT-H trunk: 32 blocks,
     width 1024, 16 heads of 64, window 24, global blocks 7, 15, 23, 31;
     24-layer CLIP text tower at context 32; seed 0). The bf16 build
     (build_sam3_image_model) through Sam3Processor on phase 2's image,
     tokens and box: launches counted per set_image (flash_sdpa 4, all at
     d=64: the global blocks' (1, 16, 5184, 64) attention; layer_norm and
     flash_xattn_rpb 0) and per encode_text + ground (27 / 6 / 6 as phase
     2); set_image, encode_text, ground, the whole call and the peak memory
     timed with CUDA events, torch.profiler splitting one encode_image.
     The default build (no dtype: fp32) runs the same, its set_image and
     ground held against the same model on the host's CPU (plain versions;
     1e-2 of each output's largest magnitude) and set beside the bf16
     build. flash_sdpa at d=64, bf16 and fp32, is held against its plain
     version on the inputs of its launches (1e-2, FP32_TOL) and timed as in
     phase 3 (library: SDPA); bf16 is the wgmma kernel (csrc/flash_sdpa_h.cu),
     fp32 its split-bf16 form (csrc/flash_sdpa_h_fp32.cu). The bf16 video
     build (build_sam3_video_model)
     tracks 2 objects prompted on frame 0 over SAM3_TRACKED synthetic
     frames on the cached bank: per tracked frame [video] session A's
     launches plus 4 d=64 flash_sdpa for the frame's encode; finite masks,
     frame time and peak memory.
  12. [sam1] the SAM1 students through student_sam.SamStudentPredictor on
     phase 2's image (set_image, then predict with 3 points and with a box),
     bf16, seed 0: EdgeSAM (RepViT-M1.1), TinyViT-5M and EfficientViT-b1
     from sam_model_registry at 1024^2 (no kernel launches on their paths);
     vit_h and vit_b at 1120^2 (the registry's model, whose windowed blocks
     raise at its own 1024^2 as the JAX trunk asserts there, under heads
     for a 1120^2 input: 70x70 tokens, 5x5 windows of 196 tokens on the
     matmul path), flash_sdpa 4 launches a set_image at d=80 (vit_h) and
     d=64 (vit_b); set_image and predict timed with CUDA events,
     torch.profiler splitting one vit_h encode_image. The default (fp32)
     build of vit_h at full width cut to 4 blocks (block 3 global) held
     against the same model on the host's CPU (1e-3 of max(1, |largest|)
     on the embedding, the low-res masks and the IoUs). flash_sdpa at d=80
     (bf16: the wgmma kernel of csrc/flash_sdpa_h.cu; fp32: its split-bf16
     form, csrc/flash_sdpa_h_fp32.cu) held against its plain version
     with its LSE on the inputs of its
     launches (1e-2, FP32_TOL) and timed as in phase 3 (library: SDPA, fp32
     with TF32 off), with its registers and spills; vit_b's d=64
     launches held against the plain version at their own inputs (12
     heads, 4900 keys: a 36-key tail). Each student's set_image and
     predict split by torch.profiler (device-busy share). Then
     AutomaticMaskGenerator over the EV-M tracker's interactive predictor
     (amg_models, amg_predictor: bf16, 1008^2, changed as the CPU test
     changes the seeded model: the object-score bias, the hypernetworks'
     last layers, a projection of the pixels on the finest features) on
     amg_image's 600x800 scene: 32x32 points and one crop layer (4 crops
     at 16x16) in batches of 64, the lowered thresholds of AMG_KW
     (printed), at least AMG_MIN_RECORDS records, each checked (RLE area,
     box inside the image), ms an image; the fp32 build at 12x12 points
     held record by record against the same generator over a CPU copy of
     the predictor (amg_agree).
  13. [stage1] Stage-1 distillation (bf16 compute over fp32 parameters,
     seeded weights): the SAM3 teacher's ViT-H trunk exports 8 seeded
     1008^2 images (made in memory: no PIL on the card's path) in batches
     of 4 through train.stage1.teacher_embedder (flash_sdpa 4 launches a
     batch), SA1BDistillationDataset.write_records stores them, and every
     record comes back from native.RecordStore bit for bit (ms an image);
     the recipe's student (Stage1ImageConfig: EfficientViT-b1 + projection
     head, 1008^2 -> 72x72x1024) takes 4 steps at batch 8 on the records
     through data.sa1b.batch_iterator and Trainer (checkpoints every 2), a
     fresh model resumes at step 4 and takes 2 more (no kernel of ours on
     its path: every counter 0), and a fresh student takes the same 4
     steps through a Trainer: the same bits; one ViT-H step twice from one
     start: the same bits; the teacher's ViTTrunk at drop path 0
     (batch 2, against the records) and vit_h's trunk from
     build_sam_vit_student (1120^2, batch 1, a seeded (70, 70, 1280)
     target) take stage1_train_step with their blocks checkpointed:
     launches checked every step (flash_sdpa 8: each global block's
     forward and its recompute; flash_sdpa_bwd_dq 4 and _dkv 4), every
     gradient finite, every parameter moved; step, forward, backward and
     optimizer ms, peak memory, torch.profiler's busy share and a ViT-H
     step's device time by kernel family. fp32 4-block cuts (block 3
     global) of both take one step on the card (launches 2 / 1 / 1), the
     teacher's against the same step on the host's CPU (loss 1e-5
     relative, every gradient 1e-4 of its largest magnitude), and a further
     cut step on the card is profiled: one launch each of the fp32 dq and
     dkv kernels. The dq and dkv rows at d=64 and d=80 (bf16: the wgmma
     kernels of csrc/flash_sdpa_bwd_dq_h.cu and csrc/flash_sdpa_bwd_h.cu,
     the dq kernel's 4 launches a step checked in the profile; fp32: the
     split-bf16 wgmma kernels of csrc/flash_sdpa_bwd_dq_h_fp32.cu and
     csrc/flash_sdpa_bwd_h_fp32.cu, with the cut step's device ms),
     bf16 at a global block's captured inputs of the bf16 steps (2e-2 of
     each gradient's largest magnitude, dK and dV the same bits when run
     again, SDPA's backward as the library time) and fp32 at the cuts'
     (FP32_TOL, fp32 SDPA's backward).
  14. [text] the MobileCLIP towers (LiteText students): the SAM3 CLIP text
     tower (24 layers, width 1024, bf16) makes the teacher's token features
     of 64 seeded prompts and of their word-permuted copies; the
     MobileCLIP-S1, MobileCLIP2-L and MobileCLIP-B students (context 32)
     each held in fp32 on the card against the same tower on the host's CPU
     (TEXT_TOL of the largest magnitude) and timed in bf16 at batch 64;
     MobileCLIP-S1 takes 3 stage1_text_train_steps at batch 64 (step ms and
     loss parts printed), and the same 3 again from its start and seed:
     the same bits; EV-M 1008^2 built with the MobileCLIP2-L tower
     through Sam3Processor (a ground's launches as phase 2's);
  15. [geometry] the Stage-1 geometry-aware finetune: 3
     geometry_finetune_steps of EV-M 1008^2 with MobileCLIP-S0 at context
     32, bf16, batch 4, one box prompt a sample from seeded ground truth,
     seeded teacher embeddings and masks. Launches a step derived from the
     model and asserted: flash_sdpa, dq and dkv one a fusion layer (6),
     layer_norm and layer_norm_bwd one a FusedLayerNorm (27),
     flash_xattn_rpb 0 (the eval-mode heads pass gradient to the trunk);
     every parameter outside the trunk bit-identical, the trunk moved, the
     3 steps again from the same start and seed the same bits; an
     eval ground under no_grad launches flash_xattn_rpb once a decoder
     layer (6); the fp32 trunk gradient of a step (batch 1) through the
     kernels against the plain versions (GEOM_GRAD_BOUND) and with their
     outputs cut from the graph (must move by over twice it);
  16. [interactive] interactive_grounding_loss with one corrective step
     (two grounding passes) and its backward: EV-M 1008^2, bf16, batch 4,
     training mode; launches asserted (forward 12 flash_sdpa and 54
     layer_norm, backward 12 dq, 12 dkv and 54 layer_norm_bwd, no
     flash_xattn_rpb), the warm-up run and the timed one from one start
     and seed the same loss, gradients and statistics bit for bit, forward
     and backward ms and the clicks placed printed;
  17. [assoc] 50 assoc_train_steps of AssocHead (d_model 256) over
     FramePairDataset (200 detection and 8 track queries, batch 8): the
     loss must fall below half its start, and the 50 steps again from the
     same start and seed give the same bits;
  18. [eval] the evaluation stack and the agent: EV-M 1008^2 (bf16,
     MobileCLIP-S0 at context 32, strings tokenized over a stub merge
     table) grounds the 8 (image, query) pairs of a 4-image shapes fixture
     through eval.gold.run_gold_inference, eval.postprocess_image turns the
     raw outputs on the card into COCO records, scored by
     evaluate_cgf1_files and CocoMAPEvaluator (random weights: the values
     mean nothing; the oracle's records must score cgF1 and mask AP >=
     0.95); the card's records held against postprocess_image on a CPU
     copy (mask pixels may differ only within 1e-3 of 0 in the CPU's
     logit); box-prompt mIoU with the [sam1] AMG's interactive predictor;
     phase 7's exact session scored against its squares (HOTA, TETA, J&F;
     the truth against itself 1) and through postprocess_video; the tool
     loop (agent_inference) and SegmentationAgent over the processor with
     scripted MLLMs; eval.distributed at world size 1. Launches asserted
     per ground (6 / 27 / 6).
  19. [parallel] the multi-GPU layer (efficientsam3_tpu_torch/parallel) on
     a one-rank NCCL group over a file:// rendezvous: 2 Stage-3 steps of
     [train]'s model and batch through Trainer with a dp mesh of 1 against
     the same steps without a mesh (after each step the metrics, grad_norm
     among them, and every parameter and statistic bit for bit; [train]'s
     launches a step); phase 2's ground on the model, its
     fusion encoder's and decoder's biases seeded, under shard_params at
     tp=1 (246 sharded leaves; 6 / 27 / 6 launches; against the unsharded
     ground within PAR_TP_BOUNDS, from the card's spread); 4 frames
     of [video]'s tracker (8 slots, 3 objects) on an objects mesh, the
     plain path (VIDEO_COUNTS["B"] a tracked frame; masks equal to the
     unmeshed plain path's); 4 frames through frame_parallel against single
     grounds. Then a world of two on the one card over gloo (two processes
     of this script, ``--parallel-rank``; NCCL takes one rank a device):
     tp=2 (4 of 8 heads a rank) and objects=2 (4 of 8 slots a rank)
     against the same references (mask IoU > 0.98). It prints the wall ms
     of each path.
  20. [cli] the port's entry points (efficientsam3_tpu_torch/scripts and
     examples), each main(argv) called in this process on the card with
     its default device, on a shapes fixture written as COCO json + PNGs
     (4 images of 256^2), a 6-frame video folder with its ground truth and
     the synthetic byte-level BPE file: the overfit-to-quality run
     shortened to 100 + 30 steps at its own tiny config (its loss must
     fall to CLI_LOSS_FALL of its first step's), eval_quality --trained
     (the oracle's cgF1 >= CLI_ORACLE_MIN), standalone_cgf1 on the records
     eval_quality wrote (the same cgF1), verify_checkpoint on the overfit
     checkpoint (exit 0) and on copies with a NaN and a wrong shape (exit
     1), train_stage3 (EV-M 1008^2 bf16, 3 steps at batch 4, then one
     resumed), the ViT-H teacher's export of the 4 images and its
     --check-saved-embed (a bf16 ulp), train_image_encoder_stage1 (2 steps
     on that store), eval_coco, eval_video (the seeded detector grounds
     every frame; its outputs are replaced by the frames' red squares so
     the tracker follows objects), data_engine (stub), and the seven
     examples at their defaults. The counters are set to 0 before each and
     read after; one JSON line each (wall s, launches, key outputs).
  The launches of phases 15, 16, 18, 19 and 20 are added to the rows of the
  kernels they run (flash_sdpa, flash_sdpa_bwd_dq, flash_sdpa_bwd_dkv,
  layer_norm, layer_norm_bwd, flash_xattn_rpb; the tracker's
  flash_sdpa_d256, flash_sdpa_d256_cross and depthwise_conv2d).

Each phase prints its seconds. The line before the last is the kernels
JSON (forty-five rows), the last {"ok": true, "device": {...}}. Any
failure raises and exits non-zero. Imports nothing of JAX and nothing of
the JAX package.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper), at 700 W.
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s
PEAK_INT8 = 1979e12  # dense int8 tensor-core operations/s
PEAK_TF32 = 495e12  # dense tf32 tensor-core FLOP/s: the tensor rate for fp32 operands
PEAK_FP32 = 67e12  # fp32 FLOP/s outside the tensor cores
PEAK_SFU = 132 * 16 * 1.98e9  # exponentials/s: 16 per SM per clock at 1.98 GHz

ATOL = RTOL = 1e-2  # kernel vs plain, bf16 outputs: about one bf16 ulp (2^-7 relative)
# kernel vs plain in fp32: the fp32 instantiations multiply split bf16 parts
# (hi hi + hi lo + lo hi, about 2^-16 of a product's magnitude), depthwise
# in fp32 FMA: 1e-4 as atol and rtol, and of a gradient's largest magnitude
FP32_TOL = 1e-4
MAIN_COUNTS = {"layer_norm": 27, "flash_sdpa": 6, "flash_xattn_rpb": 6}
# per tracked frame on the tracker's two paths
VIDEO_COUNTS = {
    "A": {"flash_sdpa": 4, "flash_memattn": 4, "layer_norm": 13, "depthwise_conv2d": 2,
          "flash_xattn_rpb": 0},
    "B": {"flash_sdpa": 8, "flash_memattn": 0, "layer_norm": 13, "depthwise_conv2d": 2,
          "flash_xattn_rpb": 0},
}
N_FRAMES = 12


def log(*a):
    print(*a, flush=True)


def cuda_time(fn, iters, warmup=3):
    """Median milliseconds of fn() over iters runs, each between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_time(fn, per_graph=20, replays=20):
    """Device milliseconds per fn() call: per_graph calls captured in one
    CUDA graph, each replay timed between CUDA events, the median of the
    replays divided by per_graph; the host's launch cost of each call
    (Python, ctypes, Triton's launcher) drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    del graph
    return statistics.median(times)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def write_out(name, text):
    """Write a long report under chiprun_out/ beside this script."""
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, name), "w") as f:
        f.write(text + "\n")


def charge_helpers(prof, owners, helper):
    """Device us of each owner kernel (a name pattern) in a profile, with
    every launch whose name holds `helper` charged to the next owner launch
    after it on the device timeline (a wrapper's pre-pass and its kernel):
    {owner: us}. Raises if an owner or the helper has no launch."""
    import torch

    launches = sorted((ev.time_range.start, ev.name, ev.time_range.elapsed_us())
                      for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA)
    out, pending = {o: 0.0 for o in owners}, 0.0
    seen = dict.fromkeys((*owners, helper), 0)
    for _, name, us in launches:
        if helper in name:
            pending += us
            seen[helper] += 1
            continue
        for o in owners:
            if o in name:
                out[o] += us + pending
                pending = 0.0
                seen[o] += 1
    if not all(seen.values()):
        raise AssertionError(f"profile: no launch of {[k for k, n in seen.items() if not n]}")
    return out


def launch_us(fn, pattern):
    """Device us of each launch of a kernel whose name holds `pattern` in
    one fn() call under torch.profiler (inference mode, after a warm-up),
    in launch order: the launches of one kernel at different shapes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((ev.time_range.start, ev.time_range.elapsed_us()) for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA and pattern in ev.name)
    return [us for _, us in evs]


def profile_kernels(fn, train=False):
    """Device kernels of one fn() call under torch.profiler, after a warm-up
    (under inference mode unless train):
    ([(name, device us, launches)] by time, total launches, total device us).
    The optimizer's profiler range ("Optimizer.step#...", a device-side
    annotation spanning the kernels it launches) is not a kernel and is left
    out, or it would count the optimizer's device time twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with torch.inference_mode(not train), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith("Optimizer."):
            continue
        kernels.append((e.key, e.self_device_time_total, e.count))
    kernels.sort(key=lambda r: -r[1])
    return kernels, sum(n for _, _, n in kernels), sum(us for _, us, _ in kernels)


def replay_profile(fn, per_graph=20):
    """(device ms a call, {kernel: device ms a call}) of fn() captured
    per_graph times in one CUDA graph, under torch.profiler over one
    replay: where the device time of a call inside a graph goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    names = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.key] = names.get(e.key, 0.0) + e.self_device_time_total / 1e3 / per_graph
    del graph
    return sum(names.values()), names


class Capture:
    """Record, per kernel wrapper and head dim (the first tensor's last
    axis), the arguments of its largest call (by the sizes of the first two
    tensors; the latest of equal calls, so a tracked video's last, fullest
    memory bank) as the model modules make it, without changing what runs:
    args[(name, d)] = (args, kwargs), and the number of calls per key in
    ``calls``. ``key(name, args)`` may group the calls otherwise, and
    ``size(name, args)`` rank them otherwise."""

    def __init__(self, modules, key=None, size=None):
        self.modules = modules  # [(module, attribute name), ...]
        self.key = key or (lambda name, a: (name, a[0].shape[-1]))
        self.size = size or (lambda name, a: sum(t.numel() for t in a[:2]))
        self.args = {}
        self.calls = {}  # calls per key
        self.saved = []

    def __enter__(self):
        for mod, name in self.modules:
            orig = getattr(mod, name)

            def wrapped(*a, orig_=orig, name_=name, **kw):
                key = self.key(name_, a)
                self.calls[key] = self.calls.get(key, 0) + 1
                prev = self.args.get(key)
                if prev is None or self.size(name_, a) >= self.size(name_, prev[0]):
                    self.args[key] = (a, kw)
                return orig_(*a, **kw)

            if hasattr(orig, "launches"):  # the wrapper counts on its module name
                wrapped.launches = orig.launches
            self.saved.append((mod, name, orig))
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


def bound(nbytes, mma_flops=0.0, exps=0.0, fp32_ops=0.0, int8_ops=0.0, tf32_flops=0.0):
    """(least ms the card could take, "bytes" or "operations"); bf16, tf32
    (the products of fp32 operands) and int8 tensor-core work add up, the
    other units run beside them."""
    parts = {"bytes": nbytes / PEAK_BYTES,
             "operations": max(mma_flops / PEAK_BF16 + tf32_flops / PEAK_TF32
                               + int8_ops / PEAK_INT8, exps / PEAK_SFU, fp32_ops / PEAK_FP32)}
    by = max(parts, key=parts.get)
    return parts[by] * 1e3, by


def attn_bound(q_elems, live_pairs, d, dv=None, kv_elems=0):
    """fp32 attention: 4-byte operands (q, the output, kv_elems of keys and
    values) read or written once; the function's own products at the tensor
    rate for fp32 operands (the kernels' split into three bf16 products is
    their cost, not the function's), the exponentials, ~6 FMA-pipe
    operations a score."""
    dv = d if dv is None else dv
    nb = 4 * (q_elems + q_elems * dv // d + kv_elems)
    return bound(nb, exps=1.0 * live_pairs, fp32_ops=6.0 * live_pairs,
                 tf32_flops=2.0 * live_pairs * (d + dv))


def check(name, got, want, tol=ATOL):
    """Max abs error of a kernel against its plain version; raises past the
    stated tolerance (atol = rtol = tol)."""
    import torch

    err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
    log(f"[kernel] {name}: max|kernel - plain| = {err:.3e} "
        f"(atol {tol}, rtol {tol}) -> {'pass' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def check_rel(name, got, want, tol=2e-2):
    """Max abs error of a gradient kernel against its plain version; raises
    past tol of the plain version's largest magnitude (bf16 sums over
    thousands of terms in other orders make an elementwise rtol
    meaningless near 0)."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = err <= tol * scale
    log(f"[kernel] {name}: max|kernel - plain| = {err:.3e}, {err / max(scale, 1e-30):.3e} of "
        f"the largest magnitude {scale:.3e} (bound {tol}) -> {'pass' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def training_bits(model, opt=None, metrics=()):
    """{name: tensor} of what a run of training steps leaves, cloned: each
    step's metrics, every parameter's gradient, the model's parameters and
    buffers, and the optimizer's state (its tensors and numbers)."""
    import torch

    out = {}

    def add(prefix, obj):
        if isinstance(obj, torch.Tensor):
            out[prefix] = obj.detach().clone()
        elif isinstance(obj, dict):
            for k, v in obj.items():
                add(f"{prefix}.{k}", v)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                add(f"{prefix}.{i}", v)
        elif isinstance(obj, (bool, int, float)):
            out[prefix] = torch.tensor(obj)

    for i, m in enumerate(metrics):
        add(f"step {i + 1}", {k: torch.as_tensor(v) for k, v in m.items()})
    for k, p in model.named_parameters():
        if p.grad is not None:
            out[f"grad {k}"] = p.grad.detach().clone()
    add("state", model.state_dict())
    if opt is not None:
        add("optimizer", opt.state_dict())
    return out


def assert_same_bits(what, first, second):
    """Raises unless two runs' training_bits hold the same names, dtypes,
    shapes and bits; logs what was compared."""
    import torch

    def raw(t):
        return t.reshape(-1).view(torch.uint8) if t.dtype != torch.bool else t.reshape(-1)

    differ = sorted(k for k in first.keys() | second.keys()
                    if k not in first or k not in second or first[k].dtype != second[k].dtype
                    or first[k].shape != second[k].shape
                    or not torch.equal(raw(first[k]), raw(second[k])))
    kinds = {kind: sum(k.startswith(kind) for k in first)
             for kind in ("step", "grad", "state", "optimizer")}
    log(f"{what}: two runs from one seed, {len(first)} tensors ({kinds['step']} step metrics, "
        f"{kinds['grad']} gradients, {kinds['state']} parameters and buffers, "
        f"{kinds['optimizer']} optimizer entries): {len(differ)} differ"
        + (f" ({differ[:6]})" if differ else ", bit for bit"))
    if differ:
        raise AssertionError(f"{what}: {len(differ)} tensors differ between two runs from one "
                             f"seed, e.g. {differ[:6]}")


def resize_backward_ms(shape, size, antialias=False):
    """(ms of ops.interpolate.resize_bilinear's backward, ms of
    F.interpolate's, their largest difference over its largest magnitude)
    at a seeded fp32 shape -> size on the card, each a median of CUDA-event
    timings; F.interpolate's backward adds by atomics."""
    import torch
    import torch.nn.functional as F

    from efficientsam3_tpu_torch.ops.interpolate import resize_bilinear

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(shape, generator=gen, device=dev).requires_grad_()
    g = torch.randn((*shape[:2], *size), generator=gen, device=dev)
    y_new = resize_bilinear(x, size, antialias=antialias)
    y_lib = F.interpolate(x, size=size, mode="bilinear", antialias=antialias)

    def new():
        return torch.autograd.grad(y_new, x, g, retain_graph=True)[0]

    def lib():
        return torch.autograd.grad(y_lib, x, g, retain_graph=True)[0]

    want = lib()
    err = ((new() - want).abs().max() / want.abs().max()).item()
    return cuda_time(new, 20), cuda_time(lib, 20), err


def sdpa_h_measure(name, q, k, v, key_bias, scale, launches, err, lse_err):
    """The row of the wgmma flash_sdpa kernel (bf16, d=32) at q/k/v: graph
    and call time, its bound, the plain version and one SDPA call, and the
    host's own time a call (100 calls enqueued back to back, read before
    the card finishes them: the wrapper, its four tensor maps, the launch)."""
    import torch
    import torch.nn.functional as F

    from efficientsam3_tpu_torch.ops import flash_attention as fa

    b, h, lq, d = q.shape
    live = int((key_bias > fa.NEG_INF / 2).sum().item()) // b  # skipped tiles do no work
    nb = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * key_bias.numel()
    bms, by = bound(nb, 4.0 * b * h * lq * live * d, 1.0 * b * h * lq * live,
                    6.0 * b * h * lq * live)
    new = lambda: fa.flash_sdpa(q, k, v, key_bias, scale)  # noqa: E731
    new()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(100):
        new()
    host_ms = (time.perf_counter() - t) * 10
    torch.cuda.synchronize()
    row = dict(
        name=name, route="cuda", source="efficientsam3_tpu_torch/csrc/flash_sdpa_h.cu",
        replaces="efficientsam3_tpu/ops/pallas/flash_attention.py:304",
        launches=launches, max_abs_err=err, ms=graph_time(new), call_ms=cuda_time(new, 50),
        plain_ms=graph_time(lambda: fa.flash_sdpa_plain(q, k, v, key_bias, scale), 5, 10),
        bound_ms=bms, bound_by=by,
        library_ms=graph_time(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
        shape=f"q/k/v {tuple(q.shape)} bf16, wgmma + TMA; host {host_ms:.4f} ms a call; "
              f"lse max err {lse_err:.2e}",
        **{"pass": True})
    log(f"[kernel] flash_sdpa d=32 bf16 at {tuple(q.shape)}: wgmma kernel {row['ms']:.4f} ms | "
        f"SDPA {row['library_ms']:.4f} ms | bound {bms:.4f} ms ({by}) (CUDA graph) | host "
        f"{host_ms:.4f} ms a call")
    return row


def log_row(r, smi):
    lib = "not measured" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    log(f"[kernel] {r['name']}: {r['ms']:.4f} ms in a CUDA graph | {r['call_ms']:.4f} ms "
        f"per call from the host | profiler {r['device_ms']} ms | plain {r['plain_ms']:.4f} ms | "
        f"library {lib} | bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
        f"| {r['launches']} launches | {r['shape']} | {smi}")


def main():
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
    from efficientsam3_tpu_torch.models import common
    from efficientsam3_tpu_torch.models.geometry import Prompt
    from efficientsam3_tpu_torch.ops import _build
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.ops import layer_norm as ln
    from efficientsam3_tpu_torch.processor import Sam3Processor

    # ---------------------------------------------------------------- 1
    t_run = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(smi)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"[env] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    t_build = time.perf_counter()
    reports = _build.build_all()
    log(f"[build] nvcc {sorted(reports)} in {time.perf_counter() - t_build:.2f} s (parallel)")
    for name, rep in reports.items():
        write_out(f"ptxas_{name}.txt", rep)  # registers, shared memory, spills by kernel
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    # the wgmma kernels as the runtime holds them, at the main path's 5184 keys
    # (the d=256 forward and dq kernels at the clip's 36352 keys: their tile
    # lists grow with them; the bank kernels, exact and int8, at the padded
    # bank's 36864; the d=80 ones at vit_h's 4900)
    for kernel, d, lk in (("flash_sdpa_h", 32, 5184), ("flash_sdpa_h", 64, 5184),
                          ("flash_sdpa_h", 80, 4900), ("flash_sdpa_h", 256, 36352),
                          ("flash_sdpa_h_fp32", 32, 5184), ("flash_sdpa_h_fp32", 64, 5184),
                          ("flash_sdpa_h_fp32", 80, 4900), ("flash_sdpa_h_fp32", 256, 36352),
                          ("flash_memattn_h", 256, 36864), ("flash_memattn_h_fp32", 256, 36864),
                          ("flash_memattn_q8_h", 256, 36864),
                          ("flash_memattn_q8_h_fp32", 256, 36864),
                          ("flash_sdpa_bwd_h", 32, 5184),
                          ("flash_sdpa_bwd_h", 64, 5184), ("flash_sdpa_bwd_h", 80, 4900),
                          ("flash_sdpa_bwd_dq_h", 32, 5184),
                          ("flash_sdpa_bwd_dq_h", 64, 5184), ("flash_sdpa_bwd_dq_h", 80, 4900),
                          *((kernel, d, lk) for kernel in (
                              "flash_sdpa_bwd_h_fp32", "flash_sdpa_bwd_dq_h_fp32")
                            for d, lk in ((32, 5184), (64, 5184), (80, 4900))),
                          ("flash_sdpa_bwd_dq_wide_h", 256, 36352),
                          ("flash_sdpa_bwd_dkv_wide_h", 256, 36352),
                          ("flash_sdpa_bwd_dq_wide_f32", 256, 36352),
                          ("flash_sdpa_bwd_dkv_wide_f32", 256, 36352)):
        r = fa.kernel_resources(kernel, d, lk)
        log(f"[build] {kernel} d={d}: {r['registers']} registers a thread, {r['spill_bytes']} "
            f"bytes of local memory (spills) a thread, {r['smem_bytes']} bytes of shared memory "
            f"a block, {r['blocks_per_sm']} blocks an SM")
    # the decoder's cross-attention at its 72 x 72 map, 8 heads, 201 queries
    for dtype in (torch.bfloat16, torch.float32):
        xattn_splits = fa.xattn_splits_for(dtype, 8, 201, (72, 72))
        r = fa.xattn_resources(dtype, (72, 72), xattn_splits)
        log(f"[build] flash_xattn_rpb {str(dtype)[6:]} 72x72 in {xattn_splits} key splits: "
            f"{r['registers']} registers a thread, {r['spill_bytes']} bytes spilled, "
            f"{r['smem_bytes']} bytes of shared memory a block, {r['blocks_per_sm']} blocks an SM, "
            f"{r['max_clusters']} clusters of {xattn_splits} resident at once "
            f"({-(-201 // 64) * 8} in the grid), {r['stages']} K/V stages")
        if r["spill_bytes"]:
            raise AssertionError(f"flash_xattn_rpb {dtype} spills {r['spill_bytes']} bytes")
    for x_dtype, y_dtype in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                             (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)):
        for col_stride, what in ((1, "rows"), (5184, "a channel-major map's columns")):
            r = ln.kernel_resources(x_dtype, y_dtype, 256, col_stride)
            log(f"[build] layer_norm {str(x_dtype)[6:]} -> {str(y_dtype)[6:]} at 256 channels "
                f"({what}): path {r['path']} (vectors a lane; -1 the column path), "
                f"{r['registers']} registers a thread, {r['spill_bytes']} bytes spilled, "
                f"{r['blocks_per_sm']} blocks an SM")
            if r["spill_bytes"]:
                raise AssertionError(f"layer_norm {x_dtype} -> {y_dtype} spills")
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- 2
    model = build_efficientsam3_image_model(
        backbone_type="efficientvit", model_name="b1", text_encoder_type="MobileCLIP-S0",
        text_encoder_context_length=32, dtype=torch.bfloat16, device=dev, seed=0,
    )
    proc = Sam3Processor(model, resolution=1008, context_length=32)
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (600, 800, 3), dtype=np.uint8)
    tokens = np.zeros((1, 32), np.int64)
    tokens[0, :5] = [49406, 320, 1125, 3309, 49407]
    box = [0.45, 0.5, 0.3, 0.4]

    def main_path():
        state = proc.set_image(image)
        state["text"] = proc.encode_tokens(tokens)
        return proc.add_geometric_prompt(box, True, state)

    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    capture = Capture([(common, "flash_sdpa"), (common, "flash_xattn_rpb"),
                       (common, "layer_norm")])
    with capture:  # warm-up run: Triton compile, cuDNN plans, captured inputs
        main_path()
    t1.record()
    t1.synchronize()
    log(f"[main] first run (Triton compile and warm-up) {t0.elapsed_time(t1):.1f} ms")

    wrappers = {"layer_norm": ln.layer_norm, "flash_sdpa": fa.flash_sdpa,
                "flash_xattn_rpb": fa.flash_xattn_rpb}
    for w in wrappers.values():
        w.launches = 0
    state = main_path()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"[main] launches per ground call: {launches}")
    for k, want in MAIN_COUNTS.items():
        if launches[k] != want:
            raise AssertionError(f"{k}: {launches[k]} launches on the main path, want {want}")
    h0, w0 = image.shape[:2]
    if state["masks"].shape[1:] != (h0, w0):
        raise AssertionError(f"masks {state['masks'].shape} not at the original {h0}x{w0}")
    for k in ("scores", "boxes", "masks_logits"):
        if not np.isfinite(state[k]).all():
            raise AssertionError(f"non-finite {k}")
    log(f"[main] kept {len(state['scores'])} of 200 queries at threshold 0.5; "
        f"masks {state['masks'].shape}")

    img = proc.preprocess(image)
    with torch.inference_mode():
        feats = model.encode_image(img)
        tm, tmask = state["text"]
        prompt = state["geometric_prompt"]
        enc_ms = cuda_time(lambda: model.encode_image(img), 20)
        ground_ms = cuda_time(
            lambda: model.ground(feats["fpn"], feats["pos"], tm, tmask, prompt), 20)
    whole_ms = cuda_time(main_path, 10, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    main_path()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[main] encode_image {enc_ms:.3f} ms | ground {ground_ms:.3f} ms | whole call "
        f"(set_image + encode text + add_geometric_prompt, host postprocess included) "
        f"{whole_ms:.3f} ms | peak memory {peak:.2f} GiB | {smi}")

    # device time by kernel (torch.profiler), one encode_image and one ground
    device_ms = {}
    for stage, fn, wall_ms in (
        ("encode_image", lambda: model.encode_image(img), enc_ms),
        ("ground", lambda: model.ground(feats["fpn"], feats["pos"], tm, tmask, prompt), ground_ms),
    ):
        kernels, launches_n, total_us = profile_kernels(fn)
        if total_us == 0:
            log(f"[profile] {stage}: the profiler recorded no device time: not measured")
            continue
        busy = total_us / 1e3 / wall_ms
        log(f"[profile] {stage}: {launches_n} kernel launches, {total_us / 1e3:.3f} ms of "
            f"device time in a {wall_ms:.3f} ms call: device busy {busy:.1%}, idle {1 - busy:.1%}")
        for name, us, n in kernels[:8]:
            log(f"[profile] {stage}:   {us / 1e3:8.4f} ms  x{n:<4d} {name[:90]}")
        for name, us, n in kernels:
            for key, pattern in (("flash_sdpa", "flash_sdpa_h_kernel<32>"),
                                 ("flash_xattn_rpb", "flash_xattn_rpb_kernel<"),
                                 ("layer_norm", "ln_fwd_")):
                if pattern in name:
                    device_ms[key] = device_ms.get(key, 0.0) + us / 1e3 / MAIN_COUNTS[key]
        if stage == "ground":  # each wrapper call is one launch of its kernel
            for key, family, pattern in (("flash_xattn_rpb", "flash_xattn_rpb", "flash_xattn_rpb_kernel<"),
                                         ("layer_norm", "ln_fwd", "ln_fwd_")):
                seen = sum(n for name, _, n in kernels if family in name)
                own = sum(n for name, _, n in kernels if pattern in name)
                if seen != own or own != MAIN_COUNTS[key]:
                    raise AssertionError(f"[profile] ground: {own} launches of {pattern} ({seen} "
                                         f"of {family}*), want {MAIN_COUNTS[key]}: one a call")
            log(f"[profile] ground: flash_xattn_rpb {MAIN_COUNTS['flash_xattn_rpb']} kernel "
                f"launches (one a call), layer_norm {MAIN_COUNTS['layer_norm']} (the CUDA forward)")
        write_out(f"profile_{stage}.txt",
                  "\n".join(f"{us:12.2f} us  x{n:<5d} {name}" for name, us, n in kernels))
    log(f"[profile] device ms per wrapper call on the main path, our kernels: "
        f"{ {k: round(v, 5) for k, v in device_ms.items()} }")

    # ---------------------------------------------------------------- 3
    rows = []

    # flash_sdpa at the fusion-encoder self-attention
    (q, k, v, key_bias, scale), _ = capture.args[("flash_sdpa", 32)]
    b, h, lq, d = q.shape
    lk = k.shape[2]
    got = fa.flash_sdpa(q, k, v, key_bias, scale)
    err = check("flash_sdpa", got, fa.flash_sdpa_plain(q, k, v, key_bias, scale))
    got_o, got_lse = fa.flash_sdpa(q, k, v, key_bias, scale, return_lse=True)
    _, want_lse = fa.flash_sdpa_plain(q, k, v, key_bias, scale, return_lse=True)
    lse_err = (got_lse - want_lse).abs().max().item()
    log(f"[kernel] flash_sdpa lse: max err {lse_err:.3e} (atol 1e-2)")
    if lse_err > 1e-2:
        raise AssertionError("flash_sdpa lse disagrees with its plain version")
    sdpa_h_row = sdpa_h_measure("flash_sdpa", q, k, v, key_bias, scale, launches["flash_sdpa"],
                                err, lse_err)
    rows.append(sdpa_h_row)

    # flash_xattn_rpb at the decoder's image cross-attention
    (q, k, v, ey, ex, feat_hw, scale), _ = capture.args[("flash_xattn_rpb", 32)]
    b, h, lq, d = q.shape
    lk = k.shape[2]
    got = fa.flash_xattn_rpb(q, k, v, ey, ex, feat_hw, scale)
    err = check("flash_xattn_rpb", got, fa.flash_xattn_rpb_plain(q, k, v, ey, ex, feat_hw, scale))
    full_bias = fa.rpb_bias(ey, ex, feat_hw).to(q.dtype)
    nb = 2 * (q.numel() + k.numel() + v.numel() + got.numel()) + 4 * (ey.numel() + ex.numel())
    bms, by = bound(nb, 4.0 * b * h * lq * lk * d, 1.0 * b * h * lq * lk, 8.0 * b * h * lq * lk)
    splits = fa.xattn_splits_for(q.dtype, b * h, lq, feat_hw)
    res = fa.xattn_resources(q.dtype, feat_hw, splits)
    if not torch.equal(fa.flash_xattn_rpb(q, k, v, ey, ex, feat_hw, scale), got):
        raise AssertionError("flash_xattn_rpb: two calls differ (its merge sums in a fixed order)")
    rows.append(dict(
        name="flash_xattn_rpb", route="cuda",
        source="efficientsam3_tpu_torch/csrc/flash_xattn_rpb.cu",
        replaces="efficientsam3_tpu/ops/pallas/flash_attention.py:898",
        launches=launches["flash_xattn_rpb"], max_abs_err=err,
        ms=graph_time(lambda: fa.flash_xattn_rpb(q, k, v, ey, ex, feat_hw, scale)),
        call_ms=cuda_time(lambda: fa.flash_xattn_rpb(q, k, v, ey, ex, feat_hw, scale), 50),
        plain_ms=graph_time(lambda: fa.flash_xattn_rpb_plain(q, k, v, ey, ex, feat_hw, scale)),
        bound_ms=bms, bound_by=by,
        library_ms=graph_time(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=full_bias, scale=scale)),
        shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16, ey/ex f32, {splits} key splits "
              f"= the cluster size ({res['registers']} registers, {res['spill_bytes']} bytes "
              f"spilled, {res['smem_bytes']} B shared, {res['blocks_per_sm']} blocks an SM, "
              f"{res['stages']} K/V stages, {res['max_clusters']} clusters resident); two calls "
              f"bit-identical", **{"pass": True},
    ))

    # layer_norm at the fusion encoder's (5184, 256) norms
    (x, wt, bs, eps, out_dtype), _ = capture.args[("layer_norm", 256)]
    got = ln.layer_norm(x, wt, bs, eps, out_dtype)
    wt_x, bs_x = wt.to(x.dtype), bs.to(x.dtype)
    err = check("layer_norm", got, ln.layer_norm_plain(x, wt, bs, eps, out_dtype))
    rows_, c = x.numel() // x.shape[-1], x.shape[-1]
    nb = x.numel() * x.element_size() + got.numel() * got.element_size() + 8 * c
    bms, by = bound(nb, fp32_ops=8.0 * rows_ * c)
    ln_call = lambda: ln.layer_norm(x, wt, bs, eps, out_dtype)  # noqa: E731
    _, _, eager_us = profile_kernels(ln_call)
    replay_ms, replay_kernels = replay_profile(ln_call)
    res = ln.kernel_resources(x.dtype, out_dtype, c, x.stride(-1))
    rows.append(dict(
        name="layer_norm", route="cuda", source="efficientsam3_tpu_torch/csrc/layer_norm.cu",
        replaces="efficientsam3_tpu/ops/pallas/layer_norm.py:71",
        launches=launches["layer_norm"], max_abs_err=err,
        ms=graph_time(ln_call), call_ms=cuda_time(ln_call, 50),
        plain_ms=graph_time(lambda: ln.layer_norm_plain(x, wt, bs, eps, out_dtype)),
        bound_ms=bms, bound_by=by,
        library_ms=graph_time(lambda: F.layer_norm(x, (c,), wt_x, bs_x, eps)),
        shape=f"x {tuple(x.shape)} strides {x.stride()} {x.dtype} -> {out_dtype}, w/b "
              f"{wt.dtype}; profiler at this shape: {eager_us / 1e3:.4f} ms eager, "
              f"{replay_ms:.4f} ms a call in a graph replay "
              f"({', '.join(f'{k[:40]} {v:.4f}' for k, v in replay_kernels.items())}); "
              f"path {res['path']} (-1: the column path), {res['registers']} registers, "
              f"{res['blocks_per_sm']} blocks an SM", **{"pass": True},
    ))
    for r in rows:
        # per-launch device time on the main path (profiler), beside the
        # CUDA-event time per wrapper call, which includes the host's launch
        r["device_ms"] = device_ms.get(r["name"])
        log_row(r, smi)

    # ---------------------------------------------------------------- 4
    with torch.inference_mode():
        out = model.ground(feats["fpn"], feats["pos"], tm, tmask, prompt)
    torch.cuda.synchronize()
    want = {"pred_logits": (1, 200, 1), "pred_boxes": (1, 200, 4),
            "pred_masks": (1, 200, 288, 288), "presence_logit_dec": (1,)}
    for key, shape in want.items():
        t = out[key]
        if tuple(t.shape) != shape or not torch.isfinite(t.float()).all():
            raise AssertionError(f"{key}: shape {tuple(t.shape)} (want {shape}) or non-finite")
    boxes = out["pred_boxes"].float()
    if not ((boxes >= 0) & (boxes <= 1)).all():
        raise AssertionError("pred_boxes outside [0, 1]")
    state = proc.set_confidence_threshold(0.0, state)
    if state["masks"].shape != (200, h0, w0) or not np.isfinite(state["masks_logits"]).all():
        raise AssertionError(f"all-query masks {state['masks'].shape}, want (200, {h0}, {w0})")
    log(f"[check] full-width outputs finite with expected shapes; 200 masks at {h0}x{w0}")
    main_ref = dict(image=image, tokens=tokens, box=box, ground_ms=ground_ms,
                    bf16_out={k: out[k].float().cpu() for k in GROUND_KEYS})

    # small input: tiny test config, bf16 on the card vs fp32 on the CPU
    tiny = dict(backbone_type="efficientvit", model_name="b0", embed_size=8,
                text_encoder_context_length=16, fusion_layers=2, decoder_layers=2, seed=1)
    ref_model = build_efficientsam3_image_model(device="cpu", **tiny)
    gpu_model = build_efficientsam3_image_model(device=dev, dtype=torch.bfloat16, **tiny)
    gpu_model.load_state_dict(ref_model.state_dict())
    timg = torch.from_numpy(rng.standard_normal((1, 64, 64, 3)).astype(np.float32))
    ttok = torch.zeros((1, 16), dtype=torch.long)
    ttok[0, :4] = torch.tensor([49406, 320, 1125, 49407])
    tprompt = Prompt.empty(1, 2, 2).with_box(0, 0, [0.5, 0.45, 0.4, 0.3])
    with torch.inference_mode():
        ref = ref_model(timg, ttok, tprompt)
        got = gpu_model(timg.to(dev), ttok.to(dev), tprompt.to(dev))
    # bf16 end to end against fp32: the boxes are sigmoid outputs in [0, 1]
    # and the logits clamp at 12; 5e-2 / 2.5e-1 are about 2^-4 of each range
    errs = {}
    for key, tol in (("pred_boxes", 5e-2), ("pred_logits", 2.5e-1),
                     ("presence_logit_dec", 2.5e-1)):
        errs[key] = (got[key].float().cpu() - ref[key]).abs().max().item()
        if not errs[key] <= tol:
            raise AssertionError(f"tiny config on the card: {key} off by {errs[key]} (tol {tol})")
    log(f"[check] tiny config, bf16 on the card vs fp32 on the CPU: max abs err {errs}")
    del model, proc, feats, state, capture, ref_model, gpu_model
    torch.cuda.empty_cache()

    log(f"[time] phases 1-4 (build, main path, kernels, checks) {time.perf_counter() - t_run:.1f} s")

    # ---------------------------------------------------------------- 5-19
    new_launches = {}  # the launches of phases 15, 16, 18 and 19, added to the kernels' rows
    pcs_ref = {}  # phase 7's exact session, scored in phase 18
    for name, phase in (("video", lambda: video_phase(smi, rng)), ("train", lambda: train_phase(smi)),
                        ("pcs", lambda: pcs_phase(smi, pcs_ref)), ("probe", lambda: probe_phase(smi)),
                        ("tracker_train", lambda: tracker_train_phase(smi)),
                        ("fp32", lambda: fp32_phase(smi, main_ref)),
                        ("sam3", lambda: sam3_phase(smi, main_ref)),
                        ("sam1", lambda: sam1_phase(smi, main_ref)),
                        ("stage1", lambda: stage1_phase(smi)),
                        ("text", lambda: text_phase(smi, main_ref)),
                        ("geometry", lambda: geometry_phase(smi, new_launches)),
                        ("interactive", lambda: interactive_phase(smi, new_launches)),
                        ("assoc", lambda: assoc_phase(smi)),
                        ("eval", lambda: eval_phase(smi, new_launches, pcs_ref)),
                        ("parallel", lambda: parallel_phase(smi, new_launches)),
                        ("cli", lambda: cli_phase(smi, new_launches))):
        t_phase = time.perf_counter()
        rows += phase()
        torch.cuda.empty_cache()
        log(f"[time] phase [{name}] {time.perf_counter() - t_phase:.1f} s")
    # the bf16 d=32 rows (phase 3's forward and LayerNorm, phase 6's
    # backward rows) and flash_xattn_rpb take the launches of the geometry
    # finetune, the interactive steps, the evaluation stack's grounds and
    # the parallel paths; the tracker's rows those of the object-parallel
    # tracking
    for r in rows:
        if r["name"] in new_launches:
            r["launches"] += new_launches.pop(r["name"])
    if new_launches:
        raise AssertionError(f"launches with no kernel row: {new_launches}")
    log(f"[kernel] launches with phases 15, 16, 18, 19 and 20's added: "
        f"{ {r['name']: r['launches'] for r in rows} }")
    log(f"[time] whole run {time.perf_counter() - t_run:.1f} s")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def video_phase(smi, rng):
    """Phase 5: the tracker at full width; returns the three kernel rows."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
    from efficientsam3_tpu_torch.models import common, memory_encoder
    from efficientsam3_tpu_torch.ops import depthwise as dw
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.ops import layer_norm as ln
    from efficientsam3_tpu_torch.video.predictor import TrackerPredictor

    dev = torch.device("cuda")
    wrappers = {"flash_sdpa": fa.flash_sdpa, "flash_memattn": fa.flash_memattn,
                "layer_norm": ln.layer_norm, "depthwise_conv2d": dw.depthwise_conv2d,
                "flash_xattn_rpb": fa.flash_xattn_rpb}

    def reset():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(fn):
        t0, t1 = events()
        t0.record()
        out = fn()
        t1.record()
        t1.synchronize()
        return out, t0.elapsed_time(t1)

    image, core = build_efficientsam3_video_model(model_name="b1", dtype=torch.bfloat16,
                                                  device=dev, seed=0)
    frames = np.random.default_rng(7).standard_normal((N_FRAMES, 1008, 1008, 3)).astype(np.float32)
    mask6 = np.zeros((1008, 1008), bool)
    mask6[600:800, 150:420] = True

    def predictor():
        return TrackerPredictor(core, image.encode_image, obj_slots=8)

    def prompt(pred, state):
        ms = []
        for obj_id, kw in ((1, dict(box=[100, 150, 400, 520])),
                           (2, dict(points=[[700, 300]], labels=[1])),
                           (3, dict(points=[[500, 800], [560, 760]], labels=[1, 0]))):
            _, ms_one = timed(lambda: pred.add_new_points_or_box(state, 0, obj_id, **kw))
            ms.append(ms_one)
        return ms

    def propagate(pred, state, start=None):
        return [(t, m.float()) for t, _, m in pred.propagate_in_video(state, start)]

    def check_outputs(outs, n_obj, what):
        for t, m in outs:
            if tuple(m.shape) != (n_obj, 1, 288, 288) or not torch.isfinite(m).all():
                raise AssertionError(f"{what} frame {t}: masks {tuple(m.shape)} or non-finite")

    # ---- session A: the cached bank (the default), counted and captured
    torch.cuda.reset_peak_memory_stats()
    pred_a = predictor()
    st_a = pred_a.init_state(frames)
    prompt_ms = prompt(pred_a, st_a)
    capture = Capture([(common, "flash_sdpa"), (common, "flash_memattn"),
                       (memory_encoder, "depthwise_conv2d")])
    reset()
    with capture:
        outs_a = propagate(pred_a, st_a)
    torch.cuda.synchronize()
    launches_a = counts()
    peak_a = torch.cuda.max_memory_allocated() / 2**30
    check_outputs(outs_a, 3, "session A")
    tracked = N_FRAMES - 1
    log(f"[video] session A (cached bank): launches over {tracked} tracked frames {launches_a}")
    for k, per in VIDEO_COUNTS["A"].items():
        if launches_a[k] != per * tracked:
            raise AssertionError(f"session A: {k} {launches_a[k]} launches, want {per} x {tracked}")
    if "kv_bank" not in st_a:
        raise AssertionError("session A did not build the cached bank")
    # a second session, warm: the whole 12-frame propagation timed
    st_a2 = pred_a.init_state(frames)
    prompt(pred_a, st_a2)
    outs_a2, prop_ms = timed(lambda: propagate(pred_a, st_a2))
    for (t, m1), (_, m2) in zip(outs_a, outs_a2):
        if not torch.equal(m1, m2):
            raise AssertionError(f"session A is not deterministic at frame {t}")

    def track_frame(pred, state):
        """One more tracked frame at the last frame (its memory is in place)."""
        with torch.inference_mode():
            return pred._run_track_frame(state, N_FRAMES - 1)

    img = torch.as_tensor(frames[0], device=dev)[None]
    with torch.inference_mode():
        enc_ms = cuda_time(lambda: image.encode_image(img), 10)
    track_a_ms = cuda_time(lambda: track_frame(pred_a, st_a), 5, warmup=1)

    # ---- session B: a 4th object by add_new_mask -> the plain path
    pred_b = predictor()
    st_b = pred_b.init_state(frames)
    st_b["feat_cache"] = st_a["feat_cache"]  # the frames' features, encoded once
    prompt(pred_b, st_b)
    _, mask_ms = timed(lambda: pred_b.add_new_mask(st_b, 6, 4, mask6))
    capture_b = Capture([(common, "flash_sdpa")])
    reset()
    with capture_b:
        outs_b = propagate(pred_b, st_b, 6)
    torch.cuda.synchronize()
    launches_b = counts()
    check_outputs(outs_b, 4, "session B")
    tracked_b = N_FRAMES - 1 - 6
    log(f"[video] session B (plain path): launches over {tracked_b} tracked frames {launches_b}")
    for k, per in VIDEO_COUNTS["B"].items():
        if launches_b[k] != per * tracked_b:
            raise AssertionError(f"session B: {k} {launches_b[k]} launches, want {per} x {tracked_b}")
    track_b_ms = cuda_time(lambda: track_frame(pred_b, st_b), 3, warmup=1)
    log(f"[video] frame encode {enc_ms:.3f} ms | prompted frame (3 prompts on frame 0: "
        f"{', '.join(f'{x:.3f}' for x in prompt_ms)} ms, the first with the frame encode) | "
        f"add_new_mask {mask_ms:.3f} ms | tracked frame A (cached) {track_a_ms:.3f} ms | "
        f"tracked frame B (plain) {track_b_ms:.3f} ms | whole {N_FRAMES}-frame propagation "
        f"(A, warm) {prop_ms:.3f} ms | peak memory (session A) {peak_a:.2f} GiB | {smi}")

    # ---- one tracked frame of session A under the profiler
    kernels, n_launch, total_us = profile_kernels(lambda: track_frame(pred_a, st_a))
    device_ms = {}
    if total_us == 0:
        log("[profile] tracked frame: the profiler recorded no device time: not measured")
    else:
        busy = total_us / 1e3 / track_a_ms
        log(f"[profile] tracked frame (A): {n_launch} kernel launches, {total_us / 1e3:.3f} ms of "
            f"device time in a {track_a_ms:.3f} ms frame: device busy {busy:.1%}, idle {1 - busy:.1%}")
        for name, us, n in kernels[:10]:
            log(f"[profile] tracked frame:   {us / 1e3:8.4f} ms  x{n:<4d} {name[:90]}")
        for name, us, n in kernels:
            for key, pattern, per in (("flash_sdpa_d256", "flash_sdpa_h_kernel<256>", 4),
                                      ("flash_memattn", "flash_memattn_h_kernel<1>", 4),
                                      ("depthwise_conv2d", "dw7_fwd_kernel", 2)):
                if pattern in name:
                    device_ms[key] = device_ms.get(key, 0.0) + us / 1e3 / per
        write_out("profile_tracked_frame.txt",
                  "\n".join(f"{us:12.2f} us  x{n:<5d} {name}" for name, us, n in kernels))
    # a tracked frame of session B: its 8 d=256 launches are 4 self-attentions
    # and 4 cross-attentions over the 36352-key bank, the longer 4 (7x the keys)
    b_us = launch_us(lambda: track_frame(pred_b, st_b), "flash_sdpa_h_kernel<256>")
    log(f"[profile] tracked frame (B): flash_sdpa_h_kernel<256> launches, device us: "
        f"{[round(u, 1) for u in b_us]}")
    if len(b_us) == 2 * VIDEO_COUNTS["A"]["flash_sdpa"]:
        device_ms["flash_sdpa_d256_cross"] = sum(sorted(b_us)[len(b_us) // 2:]) / 1e3 / (
            len(b_us) // 2)

    # ---- the tracker kernels against their plain versions
    rows = []

    def live_keys(key_bias):
        return int((key_bias > fa.NEG_INF / 2).sum().item())  # summed over the batch

    # flash_sdpa at d=256: session A's self-attention (3 active slots of 8)
    (q, k, v, key_bias, scale), _ = capture.args[("flash_sdpa", 256)]
    b, h, lq, d = q.shape
    got, lse = fa.flash_sdpa(q, k, v, key_bias, scale, return_lse=True)
    want, want_lse = fa.flash_sdpa_plain(q, k, v, key_bias, scale, return_lse=True)
    err = check("flash_sdpa_d256", got, want)
    lse_err = (lse - want_lse).abs().max().item()
    if lse_err > 1e-2:
        raise AssertionError(f"flash_sdpa_d256 lse off by {lse_err}")
    live = live_keys(key_bias)
    nb = 2 * (q.numel() + got.numel() + 2 * live * d) + 4 * key_bias.numel()
    bms, by = bound(nb, 4.0 * h * lq * live * d, 1.0 * h * lq * live, 6.0 * h * lq * live)
    mask = (key_bias > fa.NEG_INF / 2)[:, None, None, :]
    res = fa.kernel_resources("flash_sdpa_h", 256, k.shape[2])
    rows.append(dict(
        name="flash_sdpa_d256", route="cuda", source="efficientsam3_tpu_torch/csrc/flash_sdpa_h.cu",
        replaces="efficientsam3_tpu/ops/pallas/flash_attention.py:144",
        launches=launches_a["flash_sdpa"], max_abs_err=err,
        ms=graph_time(lambda: fa.flash_sdpa(q, k, v, key_bias, scale), 5, 10),
        call_ms=cuda_time(lambda: fa.flash_sdpa(q, k, v, key_bias, scale), 10),
        plain_ms=cuda_time(lambda: fa.flash_sdpa_plain(q, k, v, key_bias, scale), 3, warmup=1),
        bound_ms=bms, bound_by=by,
        library_ms=graph_time(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale), 5, 10),
        device_ms=device_ms.get("flash_sdpa_d256"),
        shape=f"q/k/v {tuple(q.shape)} bf16, {live} live keys over {b} slots "
              f"(lse max err {lse_err:.2e}); wgmma + TMA, {res['registers']} registers, "
              f"{res['spill_bytes']} bytes spilled, {res['smem_bytes']} B shared, "
              f"{res['blocks_per_sm']} blocks an SM", **{"pass": True}))
    del q, k, v, got, want, lse, want_lse

    # and session B's plain cross-attention over the 36352-key bank: the same
    # kernel, 4 of the 8 d=256 launches of a plain-path frame
    (q, k, v, key_bias, scale), _ = capture_b.args[("flash_sdpa", 256)]
    b, h, lq, d = q.shape
    got, lse = fa.flash_sdpa(q, k, v, key_bias, scale, return_lse=True)
    want, want_lse = fa.flash_sdpa_plain(q, k, v, key_bias, scale, return_lse=True)
    err = check("flash_sdpa_d256_cross", got, want)
    lse_err = (lse - want_lse).abs().max().item()
    if lse_err > 1e-2:
        raise AssertionError(f"flash_sdpa_d256_cross lse off by {lse_err}")
    del want, want_lse, lse
    live = live_keys(key_bias)
    nb = 2 * (q.numel() + got.numel() + 2 * live * d) + 4 * key_bias.numel()
    bms, by = bound(nb, 4.0 * h * lq * live * d, 1.0 * h * lq * live, 6.0 * h * lq * live)
    mask = (key_bias > fa.NEG_INF / 2)[:, None, None, :]
    res = fa.kernel_resources("flash_sdpa_h", 256, k.shape[2])
    rows.append(dict(
        name="flash_sdpa_d256_cross", route="cuda",
        source="efficientsam3_tpu_torch/csrc/flash_sdpa_h.cu",
        replaces="efficientsam3_tpu/ops/pallas/flash_attention.py:144",
        launches=launches_b["flash_sdpa"] // 2, max_abs_err=err,
        ms=graph_time(lambda: fa.flash_sdpa(q, k, v, key_bias, scale), 3, 5),
        call_ms=cuda_time(lambda: fa.flash_sdpa(q, k, v, key_bias, scale), 5),
        plain_ms=cuda_time(lambda: fa.flash_sdpa_plain(q, k, v, key_bias, scale), 2, warmup=1),
        bound_ms=bms, bound_by=by,
        library_ms=graph_time(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale), 2, 5),
        device_ms=device_ms.get("flash_sdpa_d256_cross"),
        shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16, {live} live keys over {b} slots "
              f"(lse max err {lse_err:.2e}); library = SDPA, bool key mask; wgmma + TMA, "
              f"{res['registers']} registers, {res['spill_bytes']} bytes spilled, "
              f"{res['smem_bytes']} B shared, {res['blocks_per_sm']} blocks an SM",
        **{"pass": True}))
    del q, k, v, got, mask

    # flash_memattn: session A's bank attention (LSE variant)
    (q, k, v, key_bias, scale), kw = capture.args[("flash_memattn", 256)]
    got, lse = fa.flash_memattn(q, k, v, key_bias, scale, return_lse=True)
    want, want_lse = fa.flash_memattn_plain(q, k, v, key_bias, scale, return_lse=True)
    err = check("flash_memattn", got, want)
    lse_err = (lse - want_lse).abs().max().item()
    if lse_err > 1e-2:
        raise AssertionError(f"flash_memattn lse off by {lse_err}")
    del want, want_lse
    b, h, lq, dk = q.shape
    dv = v.shape[-1]
    live = live_keys(key_bias)
    nb = 2 * (q.numel() + got.numel() + live * (dk + dv)) + 4 * (key_bias.numel() + lse.numel())
    bms, by = bound(nb, 2.0 * h * lq * live * (dk + dv), 1.0 * h * lq * live, 6.0 * h * lq * live)
    bias4 = key_bias[:, None, None, :].to(q.dtype)
    res = fa.kernel_resources("flash_memattn_h", 256, k.shape[2])
    rows.append(dict(
        name="flash_memattn", route="cuda",
        source="efficientsam3_tpu_torch/csrc/flash_memattn_h.cu",
        replaces="efficientsam3_tpu/ops/pallas/flash_attention.py:536",
        launches=launches_a["flash_memattn"], max_abs_err=err,
        ms=graph_time(lambda: fa.flash_memattn(q, k, v, key_bias, scale, return_lse=True), 5, 10),
        call_ms=cuda_time(lambda: fa.flash_memattn(q, k, v, key_bias, scale, return_lse=True), 10),
        plain_ms=cuda_time(lambda: fa.flash_memattn_plain(q, k, v, key_bias, scale, True), 3,
                           warmup=1),
        bound_ms=bms, bound_by=by,
        library_ms=graph_time(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias4, scale=scale), 5, 10),
        device_ms=device_ms.get("flash_memattn"),
        shape=f"q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} bf16, "
              f"{live} live keys over {b} slots (lse max err {lse_err:.2e}); wgmma + TMA, "
              f"{res['registers']} registers, {res['spill_bytes']} bytes spilled, "
              f"{res['smem_bytes']} B shared, {res['blocks_per_sm']} blocks an SM",
        **{"pass": True}))
    # how the kernel's time follows the bank's live keys: valid entries at
    # the session's active slots, then active slots with every entry valid
    # (1, 3 and 8 slots: whether a slot's bank stays in the L2 as more
    # slots stream theirs)
    s_e = core.feat_size ** 2
    n_act = int((key_bias > fa.NEG_INF / 2).any(-1).sum().item())
    sweep = []
    for n_slots, n_entries in ([(n_act, e) for e in (1, 3, 5, 7)]
                               + [(n, core.num_maskmem) for n in (1, 2, 3, 4, 8)]):
        kb = torch.full_like(key_bias, fa.NEG_INF)
        kb[:n_slots, :n_entries * s_e] = 0.0
        t_ms = graph_time(lambda: fa.flash_memattn(q, k, v, kb, scale, return_lse=True), 3, 5)
        sweep.append(f"{n_slots} slots x {n_entries} entries {t_ms:.4f} ms")
    log(f"[kernel] flash_memattn sweep (CUDA graph): {'; '.join(sweep)} | {smi}")
    del q, k, v, got, lse, bias4

    # depthwise_conv2d: the fuser's 7x7 at (8, 72, 72, 256)
    (x, kernel, bias), _ = capture.args[("depthwise_conv2d", 256)]
    got = dw.depthwise_conv2d(x, kernel, bias)
    err = check("depthwise_conv2d", got, dw.depthwise_conv2d_plain(x, kernel, bias))
    c = x.shape[-1]
    w_nchw = kernel.permute(3, 2, 0, 1).to(x.dtype).contiguous()
    b_x = bias.to(x.dtype)
    x_cl = x.permute(0, 3, 1, 2)  # a channels-last NCHW view
    nb = 2 * (x.numel() + got.numel()) + 4 * (kernel.numel() + bias.numel())
    bms, by = bound(nb, fp32_ops=2.0 * 49 * x.numel())
    res = dw.kernel_resources(x.dtype)
    replay_ms, replay_k = replay_profile(lambda: dw.depthwise_conv2d(x, kernel, bias))
    replay_top = ", ".join(f"{k[:40]} {v:.4f}" for k, v in
                           sorted(replay_k.items(), key=lambda kv: -kv[1])[:2])
    rows.append(dict(
        name="depthwise_conv2d", route="cuda",
        source="efficientsam3_tpu_torch/csrc/depthwise_conv2d.cu",
        replaces="efficientsam3_tpu/ops/pallas/depthwise.py:53",
        launches=launches_a["depthwise_conv2d"], max_abs_err=err,
        ms=graph_time(lambda: dw.depthwise_conv2d(x, kernel, bias)),
        call_ms=cuda_time(lambda: dw.depthwise_conv2d(x, kernel, bias), 50),
        plain_ms=graph_time(lambda: dw.depthwise_conv2d_plain(x, kernel, bias), 5, 10),
        bound_ms=bms, bound_by=by,
        library_ms=graph_time(lambda: F.conv2d(x_cl, w_nchw, b_x, padding=3, groups=c)),
        device_ms=device_ms.get("depthwise_conv2d"),
        shape=f"x {tuple(x.shape)} {x.dtype} strides {x.stride()}, 7x7, taps {kernel.dtype} "
              f"strides {tuple(kernel.stride())}; dev {replay_ms:.4f} ms a call in a graph "
              f"replay ({replay_top}); "
              f"{res['registers']} registers, {res['spill_bytes']} bytes spilled, "
              f"{res['smem_bytes']} B shared, {res['blocks_per_sm']} blocks an SM",
        **{"pass": True}))
    for r in rows:
        log_row(r, smi)
    del capture, capture_b, pred_a, pred_b, st_a, st_a2, st_b, image, core
    torch.cuda.empty_cache()

    # ---- the tiny tracker: bf16 on the card against fp32 on the CPU
    # seed 5: both objects score above 0 on every frame, so the masks
    # compared are real masks and not the no-object fill
    tiny = dict(model_name="b0", embed_size=8, text_encoder_context_length=16, seed=5)
    ref_image, ref_core = build_efficientsam3_video_model(device="cpu", **tiny)
    gpu_image, gpu_core = build_efficientsam3_video_model(device=dev, dtype=torch.bfloat16, **tiny)
    gpu_image.load_state_dict(ref_image.state_dict())
    gpu_core.load_state_dict(ref_core.state_dict())
    tframes = rng.standard_normal((3, 112, 112, 3)).astype(np.float32)
    states = {}
    for key, img_m, core_m in (("cpu", ref_image, ref_core), ("gpu", gpu_image, gpu_core)):
        pred = TrackerPredictor(core_m, img_m.encode_image, obj_slots=4, max_point_prompts=4)
        st = pred.init_state(tframes)
        pred.add_new_points_or_box(st, 0, 1, box=[20, 24, 70, 90])
        pred.add_new_points_or_box(st, 0, 2, points=[[80, 30]], labels=[1])
        for _ in pred.propagate_in_video(st):
            pass
        states[key] = st
    # each frame's outputs of the 2 valid slots (the 2 empty ones differ by
    # design: 0 rows from the kernels against uniform averages on the CPU).
    # bf16 through the trunk, neck, memory attention, heads and memory
    # encoder against fp32 leaves ~1-3% of each output's range (the same
    # model in bf16 on the CPU drifts as far); the tolerance is 5% of the
    # range. The spatial memory is held by its mean error: the prompted
    # frame's masks are binarised before encoding, and pixels whose logits
    # lie within bf16 noise of 0 flip (max error ~0.5 of a range of ~2.5)
    errs = {}
    for t in range(3):
        want_o = states["cpu"]["non_cond_frames" if t else "cond_frames"][t]
        got_o = states["gpu"]["non_cond_frames" if t else "cond_frames"][t]
        valid = np.flatnonzero(want_o["slot_valid"])
        if not (want_o["object_score_logits"][valid] > 0).all():
            raise AssertionError(f"tiny tracker frame {t}: an object scored <= 0 on the CPU")
        for k in ("low_res_masks", "obj_ptr", "object_score_logits", "maskmem"):
            want = want_o[k][valid].float()
            diff = (got_o[k][valid].float().cpu() - want).abs()
            err = (diff.mean() if k == "maskmem" else diff.max()).item()
            tol = 5e-2 * max(1.0, want.abs().max().item())
            errs[f"{k}@{t}"] = round(err / tol, 4)
            if not err <= tol:
                raise AssertionError(f"tiny tracker frame {t} {k}: off by {err} (tol {tol})")
    log(f"[check] tiny tracker, bf16 on the card vs fp32 on the CPU, valid slots: max abs err "
        f"(mean for maskmem) as a share of its tolerance (5% of the range) per output and "
        f"frame: {errs}; object "
        f"scores on the CPU {states['cpu']['non_cond_frames'][2]['object_score_logits'][:2, 0].tolist()}")
    return rows


# per Stage-3 training step at batch 4 (the fusion encoder's 6 self-attentions
# and its 18 + the geometry encoder's 9 norms, all needing a gradient)
TRAIN_COUNTS = {"flash_sdpa": 6, "flash_sdpa_bwd_dq": 6, "flash_sdpa_bwd_dkv": 6,
                "layer_norm": 27, "layer_norm_bwd": 27, "flash_xattn_rpb": 0,
                "flash_memattn": 0, "depthwise_conv2d": 0}
TRAIN_BATCH, TRAIN_STEPS, RESUME_STEPS = 4, 6, 2
FROZEN = ("neck", "geometry_encoder", "fusion_encoder", "decoder", "seg_head", "scoring")


def stage3_batch(batch, ctx, device, seed=11):
    """A synthetic Stage-3 batch shaped as Stage3MixedDataset pads it:
    normalised 1008^2 images, token ids, an empty geometric prompt, 40
    target slots of which 2-5 an image are objects (cxcywh boxes, and
    their 288x288 masks filled over each box)."""
    import numpy as np
    import torch

    from efficientsam3_tpu_torch.models.geometry import Prompt

    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, 1008, 1008, 3)).astype(np.float32)
    tokens = np.zeros((batch, ctx), np.int64)
    boxes = np.zeros((batch, 40, 4), np.float32)
    valid = np.zeros((batch, 40), bool)
    masks = np.zeros((batch, 40, 288, 288), np.float32)
    for b in range(batch):
        words = rng.integers(320, 49000, 1 + b % 3)
        tokens[b, :len(words) + 2] = [49406, *words, 49407]
        n = 2 + b % 4
        xy = rng.uniform(0.2, 0.8, (n, 2))
        wh = rng.uniform(0.05, 0.4, (n, 2))
        boxes[b, :n] = np.concatenate([xy, wh], -1)
        valid[b, :n] = True
        for i in range(n):
            x0, y0 = ((xy[i] - wh[i] / 2).clip(0, 1) * 288).astype(int)
            x1, y1 = ((xy[i] + wh[i] / 2).clip(0, 1) * 288).astype(int)
            masks[b, i, y0:y1 + 1, x0:x1 + 1] = 1.0
    return {
        "images": torch.from_numpy(images).to(device),
        "tokens": torch.from_numpy(tokens).to(device),
        "prompt": Prompt.empty(batch, 8, 8, device=device),
        "targets": {"boxes": torch.from_numpy(boxes).to(device),
                    "valid": torch.from_numpy(valid).to(device),
                    "masks": torch.from_numpy(masks).to(device)},
    }


def train_phase(smi):
    """Phase 6: Stage-3 training at full width; returns the three rows of
    the backward kernels."""
    import itertools
    import tempfile

    import torch
    import torch.nn.functional as F

    from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
    from efficientsam3_tpu_torch.ops import depthwise as dw
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.ops import layer_norm as ln
    from efficientsam3_tpu_torch.train import losses, stage3
    from efficientsam3_tpu_torch.train.trainer import Trainer, TrainerConfig
    from efficientsam3_tpu_torch.utils.checkpoint import assert_frozen_unchanged

    dev = torch.device("cuda")
    # counters looked up by name at each step: Capture swaps the functions
    # in their modules during the first trainer's run
    counters = {"flash_sdpa": fa, "flash_sdpa_bwd_dq": fa, "flash_sdpa_bwd_dkv": fa,
                "layer_norm": ln, "layer_norm_bwd": ln, "flash_xattn_rpb": fa,
                "flash_memattn": fa, "depthwise_conv2d": dw}

    def build():
        return build_efficientsam3_image_model(
            backbone_type="efficientvit", model_name="b1", text_encoder_type="MobileCLIP-S0",
            text_encoder_context_length=32, dtype=torch.bfloat16, device=dev, seed=0)

    batch = stage3_batch(TRAIN_BATCH, 32, dev)
    model = build()
    opt = stage3.make_stage3_optimizer(stage3.Stage3Config(), model)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}

    # CUDA events at the edges of the step's parts, recorded by wrappers
    # around what stage3_train_step calls (nothing it runs changes)
    marks, solve_ms = {}, []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks[name] = e

    def instrument(m, o):
        m.register_forward_pre_hook(lambda *_: mark("fwd0"))
        m.register_forward_hook(lambda *_: mark("fwd1"))
        step = o.step

        def timed_opt_step():
            mark("opt0")
            step()
            mark("opt1")

        o.step = timed_opt_step

    instrument(model, opt)
    loss_fn, match_fn = stage3.sam3_detection_loss, losses.hungarian_match

    def timed_loss(*a, **kw):
        out = loss_fn(*a, **kw)
        mark("loss1")
        return out

    def timed_match(*a, **kw):
        torch.cuda.synchronize()  # the copy in the matcher waits for this anyway
        t0 = time.perf_counter()
        out = match_fn(*a, **kw)
        solve_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    stage3.sam3_detection_loss, losses.hungarian_match = timed_loss, timed_match
    per_step = []

    def counted_step(model_, opt_, batch_):
        for name, mod in counters.items():
            getattr(mod, name).launches = 0
        mark("step0")
        metrics = stage3.stage3_train_step(model_, opt_, batch_)
        mark("step1")
        torch.cuda.synchronize()
        rec = {name: getattr(mod, name).launches for name, mod in counters.items()}
        rec["metrics"] = {k: float(v) for k, v in metrics.items()}
        rec["ms"] = {part: marks[a].elapsed_time(marks[b]) for part, a, b in (
            ("step", "step0", "step1"), ("forward", "fwd0", "fwd1"), ("loss", "fwd1", "loss1"),
            ("backward", "loss1", "opt0"), ("optimizer", "opt0", "opt1"))}
        rec["ms"]["matcher"] = solve_ms[-1]
        per_step.append(rec)
        return metrics

    capture = Capture([(fa, "flash_sdpa_bwd_dq"), (fa, "flash_sdpa_bwd_dkv"),
                       (ln, "layer_norm_bwd")])
    tmp = tempfile.TemporaryDirectory()
    try:
        cfg = dict(log_every=1, checkpoint_every=3, checkpoint_dir=os.path.join(tmp.name, "ckpt"),
                   save_param_prefixes=("trunk", "text_encoder"),
                   log_dir=os.path.join(tmp.name, "logs"))
        torch.cuda.reset_peak_memory_stats()
        torch.manual_seed(0)  # the dropout bits
        with capture:
            reached = Trainer(counted_step, TrainerConfig(max_steps=TRAIN_STEPS, **cfg)).run(
                model, opt, itertools.repeat(batch))
        peak = torch.cuda.max_memory_allocated() / 2**30
        if reached != TRAIN_STEPS or len(per_step) != TRAIN_STEPS:
            raise AssertionError(f"trainer stopped at step {reached}")
        write_out("train_metrics.jsonl", open(os.path.join(cfg["log_dir"], "metrics.jsonl")).read())

        # the same steps again from the same seed: a fresh model and optimizer
        # through a Trainer without checkpoints leave the same bits (losses,
        # every gradient, parameter and statistic, the optimizer's state)
        first = training_bits(model, opt, [r["metrics"] for r in per_step])
        again, again_metrics = build(), []
        opt_again = stage3.make_stage3_optimizer(stage3.Stage3Config(), again)

        def step_again(m, o, b):
            again_metrics.append(stage3.stage3_train_step(m, o, b))
            return again_metrics[-1]

        torch.manual_seed(0)
        Trainer(step_again, TrainerConfig(max_steps=TRAIN_STEPS, log_every=TRAIN_STEPS,
                                          handle_preemption_signals=False)).run(
            again, opt_again, itertools.repeat(batch))
        assert_same_bits(f"[train] {TRAIN_STEPS} Stage-3 steps (EV-M 1008^2, bf16, batch "
                         f"{TRAIN_BATCH}) through Trainer", first, training_bits(
                             again, opt_again, [{k: float(v) for k, v in m.items()}
                                                for m in again_metrics]))
        del first, again, opt_again, again_metrics
        torch.cuda.empty_cache()
        new_ms, lib_ms, err = resize_backward_ms((TRAIN_BATCH, 1024, 63, 63), (72, 72))
        log(f"[train] the student head's upsample backward ({TRAIN_BATCH}, 1024, 63, 63) -> "
            f"72^2 fp32, once a step: two matmuls {new_ms:.4f} ms, F.interpolate's (atomics) "
            f"{lib_ms:.4f} ms, apart by {err:.2e} of the largest magnitude | {smi}")

        # a fresh model and optimizer resume at step 6 and take 2 more
        resumed = build()
        opt2 = stage3.make_stage3_optimizer(stage3.Stage3Config(), resumed)
        instrument(resumed, opt2)
        reached2 = Trainer(counted_step, TrainerConfig(
            max_steps=TRAIN_STEPS + RESUME_STEPS, **cfg)).run(resumed, opt2, itertools.repeat(batch))
        if reached2 != TRAIN_STEPS + RESUME_STEPS or opt2.count != reached2:
            raise AssertionError(f"resume reached step {reached2}, optimizer count {opt2.count}")
    finally:
        tmp.cleanup()
        stage3.sam3_detection_loss, losses.hungarian_match = loss_fn, match_fn
    for i, rec in enumerate(per_step):
        m = rec["metrics"]
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"step {i + 1}: loss {m['loss']} grad_norm {m['grad_norm']}")
        for k, want in TRAIN_COUNTS.items():
            if rec[k] != want:
                raise AssertionError(f"step {i + 1}: {k} {rec[k]} launches, want {want}")
        if rec["layer_norm_bwd"] != rec["layer_norm"]:
            raise AssertionError(f"step {i + 1}: layer_norm_bwd launches differ from forward's")
    log(f"[train] launches per step (each of {len(per_step)} steps): "
        f"{ {k: per_step[0][k] for k in TRAIN_COUNTS} }")
    log("[train] loss / grad_norm per step: " + "; ".join(
        f"{i + 1}: {r['metrics']['loss']:.4f} / {r['metrics']['grad_norm']:.2f}"
        for i, r in enumerate(per_step)) + " (steps 7-8 by the resumed trainer)")
    after = dict(model.named_parameters())
    assert_frozen_unchanged(before, {k: p.detach() for k, p in after.items()}, FROZEN)
    for top in ("trunk", "text_encoder"):
        moved = sum(int((after[k].detach() != v).sum()) for k, v in before.items()
                    if k.split(".")[0] == top)
        if moved == 0:
            raise AssertionError(f"{top} did not change in {TRAIN_STEPS} steps")
        log(f"[train] {top}: {moved} parameter elements changed; frozen heads bit-identical")
    parts = {p: statistics.median(r["ms"][p] for r in per_step[2:TRAIN_STEPS])
             for p in per_step[0]["ms"]}
    log(f"[train] step {parts['step']:.1f} ms (median of steps 3-{TRAIN_STEPS}): forward "
        f"{parts['forward']:.1f} | loss (matcher included) {parts['loss']:.1f} | backward "
        f"{parts['backward']:.1f} | optimizer {parts['optimizer']:.1f} | matcher on the host "
        f"(cost copy, native Hungarian, device idle) {parts['matcher']:.1f} ms | first step "
        f"{per_step[0]['ms']['step']:.1f} ms | peak memory {peak:.2f} GiB | batch {TRAIN_BATCH} "
        f"| {smi}")
    del opt2, resumed

    # one step under the profiler, by kernel
    kernels, n_launch, total_us = profile_kernels(
        lambda: stage3.stage3_train_step(model, opt, batch), train=True)
    device_ms = {}
    if total_us == 0:
        log("[profile] train step: the profiler recorded no device time: not measured")
    else:
        busy = total_us / 1e3 / parts["step"]
        log(f"[profile] train step: {n_launch} kernel launches, {total_us / 1e3:.3f} ms of device "
            f"time in a {parts['step']:.1f} ms step: device busy {busy:.1%}, idle {1 - busy:.1%}")
        for name, us, n in kernels[:12]:
            log(f"[profile] train step:   {us / 1e3:8.4f} ms  x{n:<4d} {name[:90]}")
        n_dq = sum(n for name, _, n in kernels if "flash_bwd_dq_h_kernel<32>" in name)
        if n_dq != TRAIN_COUNTS["flash_sdpa_bwd_dq"]:
            raise AssertionError(f"[profile] train step: {n_dq} launches of the wgmma d=32 dq "
                                 f"kernel, want {TRAIN_COUNTS['flash_sdpa_bwd_dq']}")
        for name, us, n in kernels:
            for key, pattern in (("flash_sdpa_bwd_dq", "flash_bwd_dq_h_kernel<32>"),
                                 ("flash_sdpa_bwd_dkv", "flash_bwd_dkv_h_kernel"),
                                 ("layer_norm_bwd", "ln_bwd_"),
                                 ("flash_sdpa", "flash_sdpa_h_kernel<32>")):
                if pattern in name:
                    device_ms[key] = device_ms.get(key, 0.0) + us / 1e3 / TRAIN_COUNTS[key]
        write_out("profile_train_step.txt",
                  "\n".join(f"{us:12.2f} us  x{n:<5d} {name}" for name, us, n in kernels))

    # nothing cut from the graph: the trunk's gradient of a fixed random
    # projection of the fusion encoder's output (6 flash attentions, 18
    # norms on its path), through the kernels, through the plain versions,
    # and with the kernels' outputs cut from the graph; batch 1, the same
    # dropout bits in each run. Kernels and plain versions round to bf16 at
    # other points over 6 layers' backward: ~5% of the gradient's norm
    # apart on the H100; a cut moves it by ~90%. The bound, 0.2, lies
    # between, and the cut must exceed twice it
    from efficientsam3_tpu_torch.models import common
    from efficientsam3_tpu_torch.models.geometry import Prompt

    one = (batch["images"][:1], batch["tokens"][:1], Prompt.empty(1, 8, 8, device=dev))
    proj = torch.randn((1, 5184, 256), generator=torch.Generator(device=dev).manual_seed(5),
                       device=dev)

    def trunk_grad():
        torch.manual_seed(3)
        model.train()
        model.zero_grad(set_to_none=True)
        memory = model(*one)["encoder_hidden_states"]
        (memory.float() * proj).sum().backward()
        return torch.cat([p.grad.float().flatten() for k, p in model.named_parameters()
                          if k.startswith("trunk.") and p.grad is not None])

    n_fwd = fa.flash_sdpa.launches
    grads = {"kernels": trunk_grad()}
    if fa.flash_sdpa.launches == n_fwd:
        raise AssertionError("the kernel run launched no flash_sdpa")
    saved = common.flash_sdpa, common.layer_norm
    for name, attn, norm in (
            ("plain", fa.flash_sdpa_plain, ln.layer_norm_plain),
            ("cut", lambda *a, **k: fa.flash_sdpa(*a, **k).detach(),
             lambda *a, **k: ln.layer_norm(*a, **k).detach())):
        common.flash_sdpa, common.layer_norm = attn, norm
        try:
            grads[name] = trunk_grad()
        finally:
            common.flash_sdpa, common.layer_norm = saved
    rel = {k: ((grads[k] - grads["plain"]).norm() / grads["plain"].norm()).item()
           for k in ("kernels", "cut")}
    log(f"[train] trunk gradient through the fusion encoder (batch 1), |g - g_plain| / "
        f"|g_plain|: kernels {rel['kernels']:.3e} (bound 0.2), the kernels' outputs cut from "
        f"the graph {rel['cut']:.3e} (must exceed 0.4, so the check can see a cut)")
    if not (rel["kernels"] <= 0.2 and rel["cut"] > 0.4):
        raise AssertionError(f"trunk gradient through the kernels: {rel}")
    model.zero_grad(set_to_none=True)
    del grads, proj

    rows = []
    # the dq and dkv kernels at the fusion encoder's self-attention
    (q, k, v, key_bias, o, lse, do, scale), _ = capture.args[("flash_sdpa_bwd_dq", 32)]
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dq, delta = fa.flash_sdpa_bwd_dq(q, k, v, key_bias, o, lse, do, scale)
    want_dq, want_delta = fa.flash_sdpa_bwd_dq_plain(q, k, v, key_bias, o, lse, do, scale)
    err_dq = check_rel("flash_sdpa_bwd_dq", dq, want_dq)
    delta_err = (delta - want_delta).abs().max().item()
    if delta_err > 1e-2:
        raise AssertionError(f"flash_sdpa_bwd_dq delta off by {delta_err}")
    dk, dv = fa.flash_sdpa_bwd_dkv(q, k, v, key_bias, do, lse, delta, scale)
    want_dk, want_dv = fa.flash_sdpa_bwd_dkv_plain(q, k, v, key_bias, do, lse, want_delta, scale)
    err_dkv = max(check_rel("flash_sdpa_bwd_dkv (dk)", dk, want_dk),
                  check_rel("flash_sdpa_bwd_dkv (dv)", dv, want_dv))
    del want_dq, want_dk, want_dv
    live = int((key_bias > fa.NEG_INF / 2).sum().item()) // b
    scores = b * h * lq * live
    nb_dq = 2 * (5 * q.numel() + 2 * k.numel()) + 4 * (key_bias.numel() + 2 * lse.numel())
    nb_dkv = 2 * (2 * q.numel() + 4 * k.numel()) + 4 * (key_bias.numel() + 2 * lse.numel())
    bms_dq, by_dq = bound(nb_dq, 3 * 2.0 * scores * d, 1.0 * scores, 6.0 * scores)
    bms_dkv, by_dkv = bound(nb_dkv, 4 * 2.0 * scores * d, 1.0 * scores, 6.0 * scores)
    # the library yardstick: SDPA's backward with the key bias as a float
    # mask (one call computes dq, dk and dv: it stands beside both rows)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=key_bias[:, None, None, :].to(
        q.dtype), scale=scale)
    lib_ms = cuda_time(lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True), 20)
    res_dq = fa.kernel_resources(fa.bwd_dq_kernel(q.dtype, d), d, lk)
    shape = f"q/k/v/o/dO {tuple(q.shape)} bf16 (dO strided), lse f32, {live} live keys a row"
    shape_dq = (f"{shape}; the wgmma dq kernel: {res_dq['registers']} registers at launch, "
                f"{res_dq['spill_bytes']} bytes spilled, {res_dq['smem_bytes']} B shared, "
                f"{res_dq['blocks_per_sm']} blocks an SM")
    for name, fn, plain, err, bms, by, src_line, src, shape_ in (
        ("flash_sdpa_bwd_dq", lambda: fa.flash_sdpa_bwd_dq(q, k, v, key_bias, o, lse, do, scale),
         lambda: fa.flash_sdpa_bwd_dq_plain(q, k, v, key_bias, o, lse, do, scale),
         err_dq, bms_dq, by_dq, 1082, "flash_sdpa_bwd_dq_h.cu", shape_dq),
        ("flash_sdpa_bwd_dkv",
         lambda: fa.flash_sdpa_bwd_dkv(q, k, v, key_bias, do, lse, delta, scale),
         lambda: fa.flash_sdpa_bwd_dkv_plain(q, k, v, key_bias, do, lse, delta, scale),
         err_dkv, bms_dkv, by_dkv, 1098, "flash_sdpa_bwd_h.cu", shape)):
        rows.append(dict(
            name=name, route="cuda", source=f"efficientsam3_tpu_torch/csrc/{src}",
            replaces=f"efficientsam3_tpu/ops/pallas/flash_attention.py:{src_line}",
            launches=sum(r[name] for r in per_step[:TRAIN_STEPS]), max_abs_err=err,
            ms=graph_time(fn, 5, 10), call_ms=cuda_time(fn, 20),
            plain_ms=cuda_time(plain, 3, warmup=1), bound_ms=bms, bound_by=by,
            library_ms=lib_ms, device_ms=device_ms.get(name), shape=shape_, **{"pass": True}))
    log(f"[kernel] d=32 backward pair (dq + dkv) {rows[0]['ms'] + rows[1]['ms']:.4f} ms in CUDA "
        f"graphs against SDPA backward's {lib_ms:.4f} ms a call (all three gradients) | {smi}")
    del ql, kl, vl, ol, dq, dk, dv
    # the wgmma forward kernel at the step's (4, 8, 5184, 32), beside SDPA
    # (the row of phase 3 is at batch 1)
    got, lse_ = fa.flash_sdpa(q, k, v, key_bias, scale, return_lse=True)
    want, want_lse = fa.flash_sdpa_plain(q, k, v, key_bias, scale, return_lse=True)
    err_f = check("flash_sdpa (Stage-3 shape)", got, want)
    step_row = sdpa_h_measure("flash_sdpa (Stage-3 shape)", q, k, v, key_bias, scale,
                              sum(r["flash_sdpa"] for r in per_step[:TRAIN_STEPS]), err_f,
                              (lse_ - want_lse).abs().max().item())
    step_row["device_ms"] = device_ms.get("flash_sdpa")
    log_row(step_row, smi)
    del got, lse_, want, want_lse

    # layer_norm backward at the fusion encoder's (4 x 5184, 256) norms
    (x, wt, g, eps), _ = capture.args[("layer_norm_bwd", 256)]
    dx, dw_, db_ = ln.layer_norm_bwd(x, wt, g, eps)
    want = ln.layer_norm_bwd_plain(x, wt, g, eps)
    err = check_rel("layer_norm_bwd (dx)", dx, want[0])
    for name, got_, want_ in (("dw", dw_, want[1]), ("db", db_, want[2])):
        rel_ = ((got_ - want_).abs().max() / want_.abs().max()).item()
        log(f"[kernel] layer_norm_bwd ({name}): max error {rel_:.3e} of its range (bound 1e-3)")
        if rel_ > 1e-3:
            raise AssertionError(f"layer_norm_bwd {name} disagrees with its plain version")
    c = x.shape[-1]
    nb = x.numel() * x.element_size() + g.numel() * g.element_size() + dx.numel() * dx.element_size()
    bms, by = bound(nb, fp32_ops=16.0 * x.numel())
    cmajor = x.stride(-1) != 1
    res = ln.bwd_kernel_resources(x.dtype, g.dtype, c, col_stride=x.stride(-1))
    replay_ms, _ = replay_profile(lambda: ln.layer_norm_bwd(x, wt, g, eps))
    log(f"[train] layer_norm_bwd's largest call: x {tuple(x.shape)} strides {x.stride()}, dy "
        f"strides {g.stride()} ({'channel-major: the column path' if cmajor else 'row-major'})")
    xl = x.detach().clone().requires_grad_()
    wl = wt.detach().to(x.dtype).clone().requires_grad_()
    bl = torch.zeros_like(wl, requires_grad=True)
    yl = F.layer_norm(xl, (c,), wl, bl, eps)
    gl = g.to(yl.dtype)
    rows.append(dict(
        name="layer_norm_bwd", route="cuda", source="efficientsam3_tpu_torch/csrc/layer_norm.cu",
        replaces="efficientsam3_tpu/ops/pallas/layer_norm.py:88",
        launches=sum(r["layer_norm_bwd"] for r in per_step[:TRAIN_STEPS]), max_abs_err=err,
        ms=graph_time(lambda: ln.layer_norm_bwd(x, wt, g, eps)),
        call_ms=cuda_time(lambda: ln.layer_norm_bwd(x, wt, g, eps), 50),
        plain_ms=graph_time(lambda: ln.layer_norm_bwd_plain(x, wt, g, eps)), bound_ms=bms,
        bound_by=by,
        library_ms=cuda_time(lambda: torch.autograd.grad(yl, (xl, wl, bl), gl, retain_graph=True),
                             50),
        device_ms=device_ms.get("layer_norm_bwd"),
        shape=f"x {tuple(x.shape)} {x.dtype} strides {x.stride()}, dy {g.dtype} strides "
              f"{g.stride()}; dev {replay_ms:.4f} ms a call in a graph replay; path "
              f"{res['path']}, {res['registers']} registers, {res['spill_bytes']} bytes spilled, "
              f"{res['blocks_per_sm']} blocks an SM", **{"pass": True}))
    for r in rows:
        log_row(r, smi)
    del capture, model, opt, batch, x, g, dx
    torch.cuda.empty_cache()

    # the tiny config: one step on the card against the same on the CPU
    tiny = dict(backbone_type="efficientvit", model_name="b0", embed_size=8,
                text_encoder_context_length=16, fusion_layers=2, decoder_layers=2, seed=1,
                dropout=0.0)
    ref = build_efficientsam3_image_model(device="cpu", **tiny)
    tb = stage3_batch(2, 16, "cpu", seed=12)
    tb["images"] = F.interpolate(tb["images"].permute(0, 3, 1, 2), size=(64, 64),
                                 mode="area").permute(0, 2, 3, 1)
    tb["targets"]["masks"] = F.interpolate(tb["targets"]["masks"], size=(32, 32),
                                           mode="area").round()
    res = {}
    for device, dtype in (("cpu", torch.float32), ("cpu", torch.bfloat16), ("cuda", torch.float32),
                          ("cuda", torch.bfloat16)):
        m = build_efficientsam3_image_model(device=device, dtype=dtype, **tiny)
        m.load_state_dict(ref.state_dict())
        b = {"images": tb["images"].to(device), "tokens": tb["tokens"].to(device),
             "prompt": tb["prompt"].to(device),
             "targets": {k: v.to(device) for k, v in tb["targets"].items()}}
        met = stage3.stage3_train_step(m, stage3.make_stage3_optimizer(stage3.Stage3Config(), m), b)
        res[(device, dtype)] = {k: float(v) for k, v in met.items()}

    def rel(a, b_, key):
        return abs(res[a][key] - res[b_][key]) / max(abs(res[b_][key]), 1e-6)

    f32, b16 = torch.float32, torch.bfloat16
    # fp32 on the card against fp32 on the CPU: the same matching and losses,
    # gradients summed in other orders (1e-3, 1e-2). bf16 moves this random
    # tiny model far from fp32 on either device (its grad_norm more than
    # doubles, and Hungarian assignments flip), so the card's bf16 step is
    # held to the CPU's bf16 step (15%), and to fp32 on the CPU only
    # loosely (loss 25%, grad_norm within a factor of 4)
    checks = (
        ("cuda fp32 vs cpu fp32, loss", rel(("cuda", f32), ("cpu", f32), "loss"), 1e-3),
        ("cuda fp32 vs cpu fp32, grad_norm", rel(("cuda", f32), ("cpu", f32), "grad_norm"), 1e-2),
        ("cuda bf16 vs cpu bf16, loss", rel(("cuda", b16), ("cpu", b16), "loss"), 0.15),
        ("cuda bf16 vs cpu bf16, grad_norm", rel(("cuda", b16), ("cpu", b16), "grad_norm"), 0.15),
        ("cuda bf16 vs cpu fp32, loss", rel(("cuda", b16), ("cpu", f32), "loss"), 0.25),
        ("cuda bf16 vs cpu fp32, grad_norm", rel(("cuda", b16), ("cpu", f32), "grad_norm"), 3.0),
    )
    log("[check] tiny Stage-3 step, relative error (bound): " + "; ".join(
        f"{name} {err:.3e} ({tol})" for name, err, tol in checks))
    for name, err, tol in checks:
        if not err <= tol:
            raise AssertionError(f"tiny Stage-3 step: {name} off by {err} (bound {tol})")
    for part in res[("cpu", f32)]:
        if part.startswith("loss_") and rel(("cuda", f32), ("cpu", f32), part) > 1e-3:
            raise AssertionError(f"tiny Stage-3 step: {part} on the card in fp32 differs")
    return rows


# per frame of a video-PCS session: the detector's ground on every frame,
# the tracker's step on every frame after the one that spawned the masklets
PCS_DETECTOR = {"flash_sdpa": 6, "flash_xattn_rpb": 6, "layer_norm": 27}
PCS_TRACKER = {"flash_sdpa": 4, "layer_norm": 13, "depthwise_conv2d": 2}
PCS_OBJECTS = 3


def pcs_squares(t, size=1008):
    """Three seeded squares drifting 6 px a frame: (masks (3, size, size) bool,
    scores, boxes). Score 0.9 on frame 0 (above the spawn threshold 0.6), 0.55
    afterwards (detections that may match but never spawn)."""
    import numpy as np

    masks = np.zeros((PCS_OBJECTS, size, size), bool)
    boxes = np.zeros((PCS_OBJECTS, 4), np.float32)
    for i, (y, x, side) in enumerate(((120, 140, 260), (560, 180, 300), (300, 620, 280))):
        y, x = y + 6 * t, x + 6 * t
        masks[i, y:y + side, x:x + side] = True
        boxes[i] = (x, y, x + side, y + side)
    return masks, np.full(PCS_OBJECTS, 0.9 if t == 0 else 0.55, np.float32), boxes


def pcs_frames(proc):
    """N_FRAMES frames of a synthetic video as the video entry points hand
    them over: 0-255 frames (noise in 60-120 with pcs_squares' squares in
    red, as scripts/_common.write_video_fixture draws its videos) through
    the processor's preprocess, 1008^2 and normalised; the first value of
    each holds its index, read back by the scripted detector."""
    import numpy as np

    rng = np.random.default_rng(7)
    frames = []
    for t in range(N_FRAMES):
        img = rng.integers(60, 120, (1008, 1008, 3), dtype=np.uint8)
        img[pcs_squares(t)[0].any(0)] = (210, 40, 40)
        frame = proc.preprocess(img)[0].cpu().numpy()
        frame[0, 0, 0] = t / 100.0
        frames.append(frame)
    return np.stack(frames)


def pcs_phase(smi, pcs_ref):
    """Phase 7: video PCS at full width, the exact and the int8 bank; returns
    the flash_memattn_q8 row, and puts the exact session's emitted frames in
    ``pcs_ref["outs"]`` (phase 18 scores them)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
    from efficientsam3_tpu_torch.models import common
    from efficientsam3_tpu_torch.ops import depthwise as dw
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.ops import layer_norm as ln
    from efficientsam3_tpu_torch.processor import Sam3Processor
    from efficientsam3_tpu_torch.system import EfficientSam3System
    from efficientsam3_tpu_torch.video import pipeline, tracker
    from efficientsam3_tpu_torch.video.pipeline import VideoPCSConfig

    dev = torch.device("cuda")
    counters = {"flash_sdpa": fa, "flash_memattn": fa, "flash_memattn_q8": fa,
                "flash_xattn_rpb": fa, "layer_norm": ln, "depthwise_conv2d": dw}

    image, core = build_efficientsam3_video_model(
        model_name="b1", text_encoder_context_length=32, dtype=torch.bfloat16, device=dev, seed=0)
    with torch.no_grad():  # random weights score every object as gone: see the docstring
        core.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += 10.0
    system = EfficientSam3System(image, core)
    proc = system.processor()
    tokens = np.zeros((1, 32), np.int64)
    tokens[0, :5] = [49406, 320, 1125, 3309, 49407]
    text_state = {"text": proc.encode_tokens(tokens)}
    frames = pcs_frames(proc)
    cfg = VideoPCSConfig(obj_slots=8, hotstart_delay=4, hotstart_unmatch_thresh=100,
                         fill_hole_area=16)

    # the detector reads a frame as the tracker does: its image features
    # are encode_frame's of the same frame, bit for bit
    seen, ground = {}, Sam3Processor.run_grounding

    def grounded(self, state):
        seen["feats"] = state["image_feats"]
        return ground(self, state)

    Sam3Processor.run_grounding = grounded
    try:
        system.video_predictor(cfg, obj_slots=8).detector(frames[0], text_state)
    finally:
        Sam3Processor.run_grounding = ground
    want = system.encode_frame(torch.as_tensor(frames[0], device=dev)[None])
    pairs = [(f"{k}[{i}]", g, w) for k in want for i, (g, w) in
             enumerate(zip(seen["feats"].get(k, []), want[k]))]
    differ = [name for name, g, w in pairs if g.dtype != w.dtype or not torch.equal(g, w)]
    if seen["feats"].keys() != want.keys() or differ or len(pairs) != sum(map(len, want.values())):
        raise AssertionError(f"[pcs] the detector's image features differ from encode_frame's: "
                             f"{differ or sorted(seen['feats'])}")
    log(f"[pcs] frames: 0-255 through Sam3Processor.preprocess; the detector's image features "
        f"equal encode_frame's of frame 0 bit for bit ({len(pairs)} tensors: "
        f"{', '.join(sorted(want))})")
    del seen, want, pairs

    def session(capture=None, **tracker_kw):
        """One 12-frame session; per-frame launch counts and times, outputs."""
        pipe = system.video_predictor(cfg, obj_slots=8, **tracker_kw)
        real_detector, run_track, step, emit = (pipe.detector, pipe.tracker._run_track_frame,
                                                pipe._step, pipe._emit)
        quantize, fill = tracker.quantize_rows, pipeline.fill_holes_in_mask_scores_host
        rec = {"frames": [], "fills": 0, "real_dets": []}
        cur = {}

        def detector(frame, state):
            t0 = time.perf_counter()
            out = real_detector(frame, state)  # set_image + ground on the card, host postprocess
            for k in ("masks", "scores", "boxes"):
                if not np.isfinite(np.asarray(out[k], np.float32)).all():
                    raise AssertionError(f"[pcs] detector output {k} is not finite")
            if out["masks"].shape[1:] != (1008, 1008) and len(out["masks"]):
                raise AssertionError(f"[pcs] detector masks {out['masks'].shape}")
            cur["detector"] = (time.perf_counter() - t0) * 1e3
            rec["real_dets"].append(len(out["scores"]))
            masks, scores, boxes = pcs_squares(int(round(float(frame[0, 0, 0]) * 100)))
            return {"masks": masks, "scores": scores, "boxes": boxes}

        def timed_track(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_track(*a, **kw)
            torch.cuda.synchronize()
            cur["tracker"] = (time.perf_counter() - t0) * 1e3
            return out

        def timed_quantize(x, *a, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = quantize(x, *a, **kw)
            e1.record()
            cur.setdefault("quantize_events", []).append((e0, e1))
            return out

        def counted_step(sess, t, reverse=False):
            for name, mod in counters.items():
                getattr(mod, name).launches = 0
            cur.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            raw = step(sess, t, reverse)
            torch.cuda.synchronize()
            cur["step"] = (time.perf_counter() - t0) * 1e3
            cur["quantize"] = sum(a.elapsed_time(b) for a, b in cur.pop("quantize_events", []))
            cur["launches"] = {name: getattr(mod, name).launches for name, mod in counters.items()}
            cur["tracked"] = "tracker" in cur
            rec["frames"].append(dict(cur))
            return raw

        def timed_emit(sess, raw, reverse=False):
            t0 = time.perf_counter()
            out = emit(sess, raw, reverse)
            rec["frames"][raw["frame_idx"]]["emit"] = (time.perf_counter() - t0) * 1e3
            return out

        def counted_fill(*a, **kw):
            rec["fills"] += 1
            return fill(*a, **kw)

        pipe.detector, pipe.tracker._run_track_frame = detector, timed_track
        pipe._step, pipe._emit = counted_step, timed_emit
        tracker.quantize_rows, pipeline.fill_holes_in_mask_scores_host = timed_quantize, counted_fill
        torch.cuda.reset_peak_memory_stats()
        try:
            sess = pipe.init_session(frames, text_state)
            if capture is not None:
                with capture:
                    rec["outs"] = list(pipe.propagate(sess))
            else:
                rec["outs"] = list(pipe.propagate(sess))
        finally:
            tracker.quantize_rows, pipeline.fill_holes_in_mask_scores_host = quantize, fill
        rec["peak"] = torch.cuda.max_memory_allocated() / 2**30
        rec["pipe"], rec["session"], rec["step"] = pipe, sess, step
        return rec

    def check_session(rec, name, bank_kernel):
        outs = rec["outs"]
        if [o["frame_idx"] for o in outs] != list(range(N_FRAMES)):
            raise AssertionError(f"[pcs] {name}: emitted frames {[o['frame_idx'] for o in outs]}")
        for o in outs:
            m = o["masks"]
            if list(o["obj_ids"]) != list(range(PCS_OBJECTS)):
                raise AssertionError(f"[pcs] {name} frame {o['frame_idx']}: ids {o['obj_ids']}")
            if m.shape != (PCS_OBJECTS, 288, 288) or not np.isfinite(m).all():
                raise AssertionError(f"[pcs] {name} frame {o['frame_idx']}: masks {m.shape}")
        if rec["fills"] != N_FRAMES:
            raise AssertionError(f"[pcs] {name}: hole filling ran {rec['fills']} times")
        for t, fr in enumerate(rec["frames"]):
            want = dict(PCS_DETECTOR, flash_memattn=0, flash_memattn_q8=0, depthwise_conv2d=0)
            if t == 0:  # the spawning frame: one memory encoding per add_new_mask
                want["depthwise_conv2d"] = 2 * PCS_OBJECTS
            else:
                for k, n in PCS_TRACKER.items():
                    want[k] = want.get(k, 0) + n
                if bank_kernel is None:  # the plain path: 4 more flash_sdpa over the bank
                    want["flash_sdpa"] += 4
                else:
                    want[bank_kernel] = 4
            if fr["launches"] != want or fr["tracked"] != (t > 0):
                raise AssertionError(f"[pcs] {name} frame {t}: launches {fr['launches']}, want {want}")
        total = {k: sum(fr["launches"][k] for fr in rec["frames"]) for k in counters}
        log(f"[pcs] {name}: launches per tracked frame {rec['frames'][-1]['launches']} "
            f"(asserted on each of {N_FRAMES - 1} tracked frames; frame 0 spawns "
            f"{PCS_OBJECTS} masklets), over the session {total}; the real detector kept "
            f"{rec['real_dets']} of 200 queries a frame (replaced by {PCS_OBJECTS} seeded squares)")
        return total

    def split(rec):
        fr = rec["frames"][2:]  # steady frames: the first two compile and plan
        med = lambda k: statistics.median(f[k] for f in fr)  # noqa: E731
        frame = statistics.median(f["step"] + f["emit"] for f in fr)
        host = statistics.median(f["step"] + f["emit"] - f["detector"] - f["tracker"] for f in fr)
        return (f"frame {frame:.3f} ms = detector {med('detector'):.3f} + tracker step "
                f"{med('tracker'):.3f} (quantize_rows {med('quantize'):.3f} of it, device time) "
                f"+ host association and emission {host:.3f} | peak memory {rec['peak']:.2f} GiB")

    warm = session()  # Triton compiles, cuDNN plans, the build of the host library
    del warm
    exact = session()
    total_exact = check_session(exact, "exact bank", "flash_memattn")
    pcs_ref["outs"] = exact["outs"]
    capture = Capture([(common, "flash_memattn_q8")])
    q8 = session(capture, quantize_bank=True)
    total_q8 = check_session(q8, "int8 bank", "flash_memattn_q8")
    plain = session(cache_memory_kv=False)  # the same attention without the cached bank
    check_session(plain, "plain path", None)
    log(f"[pcs] exact bank: {split(exact)} | {smi}")
    log(f"[pcs] int8 bank:  {split(q8)} | {smi}")
    log(f"[pcs] plain path: {split(plain)} | {smi}")

    # the sessions' masks against the exact bank's, per frame and object. The
    # plain path computes the exact bank's attention with bf16 roundings at
    # other places: its IoU is the noise floor of this random bf16 model,
    # which the int8 bank's drift is held against.
    def ious_against_exact(rec, name):
        table = []
        for oe, oq in zip(exact["outs"], rec["outs"]):
            row = []
            for me, mq in zip(oe["masks"] > 0, oq["masks"] > 0):
                if me.any() or mq.any():
                    row.append(float((me & mq).sum() / (me | mq).sum()))
                else:
                    row.append(None)
            table.append(row)
        log(f"[pcs] mask IoU, {name} vs exact bank, per frame and object (None: both empty): "
            + "; ".join(f"{t}: {[None if x is None else round(x, 4) for x in row]}"
                        for t, row in enumerate(table)))
        flat = [x for row in table for x in row if x is not None]
        if len(flat) < PCS_OBJECTS * (N_FRAMES - 1) // 2:
            raise AssertionError(f"[pcs] {name}: only {len(flat)} non-empty mask pairs to compare")
        return flat

    iou_q8 = ious_against_exact(q8, "int8 bank")
    iou_plain = ious_against_exact(plain, "plain path (bf16 noise floor)")
    floor = min(0.98, min(iou_plain))
    log(f"[pcs] int8 bank vs exact bank: min IoU {min(iou_q8):.4f}, mean {statistics.mean(iou_q8):.4f} "
        f"over {len(iou_q8)} non-empty pairs; plain path vs exact bank: min {min(iou_plain):.4f}, "
        f"mean {statistics.mean(iou_plain):.4f}. Bounds: int8 min > {floor - 0.02:.4f} (0.02 under "
        f"the smaller of 0.98 and the noise floor), int8 mean > 0.98")
    if not (min(iou_q8) > floor - 0.02 and statistics.mean(iou_q8) > 0.98):
        raise AssertionError(f"[pcs] int8 bank drifts from the exact bank: min IoU {min(iou_q8)}")

    # the detector keeps most or all of the 200 queries of this random model at
    # the processor's threshold 0.5, so each call upsamples and copies them. A
    # call that keeps 3, as a trained model would keep a few: the same entry
    # points with the threshold moved between the 3rd and 4th score
    proc = system.processor()
    st = proc.set_preprocessed_image(frames[1], dict(text_state))
    proc._ensure_text(st)
    proc.confidence_threshold = 0.0
    scores = np.sort(proc._forward_grounding(st)["scores"])[::-1]
    proc.confidence_threshold = float(scores[2] + scores[3]) / 2

    def detect_few():
        state = proc.set_preprocessed_image(frames[1], dict(text_state))
        proc._ensure_text(state)
        return proc._forward_grounding(state)

    kept = len(detect_few()["scores"])
    few_ms = cuda_time(detect_few, 5, warmup=1)
    log(f"[pcs] a detector call that keeps {kept} of 200 queries (threshold "
        f"{proc.confidence_threshold:.4f}): {few_ms:.3f} ms, against "
        f"{statistics.median(f['detector'] for f in exact['frames'][2:]):.3f} ms keeping "
        f"{exact['real_dets'][-1]} | {smi}")

    # one more q8 frame under the profiler (the last frame's step again)
    last = N_FRAMES - 1
    kernels, n_launch, total_us = profile_kernels(lambda: q8["step"](q8["session"], last))
    step_ms = statistics.median(f["step"] for f in q8["frames"][2:])
    device_ms = None
    if total_us == 0:
        log("[profile] pcs frame (int8 bank): the profiler recorded no device time: not measured")
    else:
        busy = total_us / 1e3 / step_ms
        log(f"[profile] pcs frame (int8 bank): {n_launch} kernel launches, {total_us / 1e3:.3f} ms "
            f"of device time in a {step_ms:.3f} ms step: device busy {busy:.1%}, idle {1 - busy:.1%}")
        for name, us, n in kernels[:12]:
            log(f"[profile] pcs frame:   {us / 1e3:8.4f} ms  x{n:<4d} {name[:90]}")
        q8_us = sum(us for name, us, _ in kernels if "flash_memattn_q8_h_kernel<1>" in name)
        n_q8 = sum(n for name, _, n in kernels if "flash_memattn_q8_h_kernel<1>" in name)
        if n_q8 != 4:
            raise AssertionError(f"[profile] pcs frame: {n_q8} launches of the int8 bank "
                                 f"kernel, want 4")
        device_ms = q8_us / 1e3 / 4 if q8_us else None
        write_out("profile_pcs_frame_q8.txt",
                  "\n".join(f"{us:12.2f} us  x{n:<5d} {name}" for name, us, n in kernels))

    # a few requests through the session server (exact bank, hole filling on)
    server = system.server(obj_slots=8, fill_hole_area=16)
    sid = server.start_session(frames[:6])
    server.add_points(sid, 0, 1, box=[100, 150, 400, 520])
    server.add_points(sid, 0, 2, points=[[700, 300]], labels=[1])
    replies = list(server.propagate_in_video(sid))
    server.remove_object(sid, 1)
    after = list(server.propagate_in_video(sid, start_frame_idx=3))
    stats = server.session_stats()
    server.close_session(sid)
    ok = ([r["masks"].shape for r in replies] == [(2, 1, 288, 288)] * 6
          and [r["obj_ids"] for r in after] == [[2]] * 3
          and all(np.isfinite(r["masks"]).all() for r in replies + after)
          and stats["num_sessions"] == 1 and server.session_stats()["num_sessions"] == 0)
    if not ok:
        raise AssertionError(f"[pcs] server replies: {[r['masks'].shape for r in replies]}, {stats}")
    log(f"[pcs] VideoPredictorServer: start_session, 2 x add_points, propagate ({len(replies)} "
        f"frames), remove_object, propagate ({len(after)} frames), close: ok on {stats['devices']}")

    # ---- flash_memattn_q8 against its plain version and flash_memattn
    (q, k_i8, ks, v, key_bias, scale), kw = capture.args[("flash_memattn_q8", 256)]
    got, lse = fa.flash_memattn_q8(q, k_i8, ks, v, key_bias, scale, return_lse=True)
    want, want_lse = fa.flash_memattn_q8_plain(q, k_i8, ks, v, key_bias, scale, return_lse=True)
    err = check("flash_memattn_q8", got, want)
    lse_err = (lse - want_lse).abs().max().item()
    if lse_err > 1e-2:
        raise AssertionError(f"flash_memattn_q8 lse off by {lse_err}")
    if not torch.equal(fa.flash_memattn_q8(q, k_i8, ks, v, key_bias, scale), got):
        raise AssertionError("flash_memattn_q8 without the LSE differs from the LSE variant")
    del want, want_lse
    k_deq = (k_i8.float() * ks[:, None, :, None]).to(q.dtype)
    exact_o = fa.flash_memattn(q, k_deq, v, key_bias, scale)
    rel = ((got.float() - exact_o.float()).abs().max() / exact_o.float().abs().max()).item()
    log(f"[kernel] flash_memattn_q8 vs flash_memattn over the dequantized keys (q's int8 "
        f"rounding): {rel:.3e} of the output's largest magnitude (bound 2e-2); lse max err "
        f"{lse_err:.2e}")
    if rel >= 2e-2:
        raise AssertionError("flash_memattn_q8 drifts from flash_memattn")
    b, h, lq, dk = q.shape
    dv = v.shape[-1]
    live = int((key_bias > fa.NEG_INF / 2).sum().item())
    nb = (2 * (q.numel() + got.numel()) + live * (dk + 4 + 2 * dv)
          + 4 * (key_bias.numel() + lse.numel()))
    bms, by = bound(nb, mma_flops=2.0 * h * lq * live * dv, exps=1.0 * h * lq * live,
                    fp32_ops=8.0 * h * lq * live, int8_ops=2.0 * h * lq * live * dk)
    bias4 = key_bias[:, None, None, :].to(q.dtype)
    q8_ms = graph_time(lambda: fa.flash_memattn_q8(q, k_i8, ks, v, key_bias, scale,
                                                   return_lse=True), 5, 10)
    res = fa.kernel_resources(fa.memattn_q8_kernel(q.dtype), dk, k_i8.shape[2])
    bf16_ms = graph_time(lambda: fa.flash_memattn(q, k_deq, v, key_bias, scale, return_lse=True),
                         5, 10)
    quant_ms = graph_time(lambda: fa.quantize_rows(k_deq[:, 0]), 5, 10)
    log(f"[kernel] same call, same keys: flash_memattn_q8 {q8_ms:.4f} ms | flash_memattn (bf16) "
        f"{bf16_ms:.4f} ms | quantize_rows of one layer's bank {tuple(k_deq[:, 0].shape)} "
        f"{quant_ms:.4f} ms (eager, in a CUDA graph) | {smi}")
    row = dict(
        name="flash_memattn_q8", route="cuda",
        source="efficientsam3_tpu_torch/csrc/flash_memattn_h.cu",
        replaces="efficientsam3_tpu/ops/pallas/flash_attention.py:739",
        launches=total_q8["flash_memattn_q8"], max_abs_err=err, ms=q8_ms,
        call_ms=cuda_time(lambda: fa.flash_memattn_q8(q, k_i8, ks, v, key_bias, scale,
                                                      return_lse=True), 10),
        plain_ms=cuda_time(lambda: fa.flash_memattn_q8_plain(q, k_i8, ks, v, key_bias, scale, True),
                           3, warmup=1),
        bound_ms=bms, bound_by=by,
        library_ms=graph_time(lambda: F.scaled_dot_product_attention(
            q, (k_i8.float() * ks[:, None, :, None]).to(q.dtype), v, attn_mask=bias4,
            scale=scale), 5, 10),
        device_ms=device_ms,
        shape=f"q {tuple(q.shape)} bf16, k {tuple(k_i8.shape)} int8 + f32 scales, v "
              f"{tuple(v.shape)} bf16, {live} live keys over {b} slots (the int8 wgmma kernel: "
              f"{res['registers']} registers at launch, {res['spill_bytes']} bytes spilled, "
              f"{res['smem_bytes']} B shared, {res['blocks_per_sm']} blocks an SM); library = "
              f"dequantize + SDPA; flash_memattn on the same keys {bf16_ms:.4f} ms",
        **{"pass": True})
    log_row(row, smi)
    # both bank kernels against the number of live slots (every entry valid),
    # in turns within this call: q8, bf16, bf16, q8
    s_tot = core.num_maskmem * core.feat_size ** 2
    sweep = []
    for n_slots in (1, 2, 3, 4, 8):
        kb = torch.full_like(key_bias, fa.NEG_INF)
        kb[:n_slots, :s_tot] = 0.0
        run_q8 = lambda: fa.flash_memattn_q8(q, k_i8, ks, v, kb, scale, return_lse=True)  # noqa: E731
        run_bf = lambda: fa.flash_memattn(q, k_deq, v, kb, scale, return_lse=True)  # noqa: E731
        t = [graph_time(f, 3, 5) for f in (run_q8, run_bf, run_bf, run_q8)]
        sweep.append(f"{n_slots} slots q8 {min(t[0], t[3]):.4f} bf16 {min(t[1], t[2]):.4f} ms")
    log(f"[kernel] flash_memattn_q8 / flash_memattn sweep over live slots (CUDA graph, the "
        f"faster of two turns): {'; '.join(sweep)} | {smi}")
    if total_exact["flash_memattn"] != total_q8["flash_memattn_q8"]:
        raise AssertionError("[pcs] the two sessions attended the bank a different number of times")
    return [row]


def probe_phase(smi):
    """Phase 8: the tensor-core probe on wgmma; returns the mma_probe rows
    (int8 and bf16)."""
    import torch

    from efficientsam3_tpu_torch.ops import mma_probe

    dev = torch.device("cuda")
    mma_probe.dot_chain.launches = 0
    call_ms = {dt: mma_probe.bench_dot(dt, device=dev) for dt in (torch.bfloat16, torch.int8)}
    launches = mma_probe.dot_chain.launches
    m, k, n, n_iter = 768, 256, 2048, 64
    ops = 2.0 * m * k * n * n_iter
    res = {}
    for dt in (torch.bfloat16, torch.int8):
        x, y = mma_probe.probe_operands(dt, m, k, n, device=dev)
        got = mma_probe.dot_chain(x, y, n_iter)
        want = mma_probe.dot_chain_plain(x, y, n_iter)
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        name = str(dt).replace("torch.", "")
        log(f"[kernel] mma_probe ({name}): max|kernel - plain| = {err:.3e}, {rel:.3e} of the "
            f"largest magnitude (bound 1e-5) -> {'pass' if rel <= 1e-5 else 'FAIL'}")
        if rel > 1e-5:
            raise AssertionError(f"mma_probe ({name}) disagrees with its plain version")
        one = (lambda: torch._int_mm(x, y)) if dt == torch.int8 else (lambda: torch.matmul(x, y))
        r = dict(err=err, x=x, y=y, ms=graph_time(lambda: mma_probe.dot_chain(x, y, n_iter)),
                 plain_ms=graph_time(lambda: mma_probe.dot_chain_plain(x, y, n_iter), 2, 5),
                 library_ms=graph_time(one, n_iter, 10) * n_iter,
                 bound=bound(x.numel() * x.element_size() + y.numel() * y.element_size()
                             + 4 * m * n, **{"int8_ops" if dt == torch.int8 else "mma_flops": ops}),
                 res=mma_probe.kernel_resources(dt), clocks=mma_probe.chain_clocks(x, y, n_iter)[0])
        res[dt] = r
    i8, bf = res[torch.int8], res[torch.bfloat16]

    def sections(c):
        return (f"staging {c['staging']:.0f}, waiting {c['waiting']:.0f}, converting "
                f"{c['converting']:.0f} of {c['block']:.0f} clocks a block "
                f"({c['converting'] / n_iter:.0f} a product converted)")

    def kres(r):
        return (f"{r['registers']} registers, {r['spill_bytes']} bytes spilled, "
                f"{r['smem_bytes']} B shared, {r['blocks_per_sm']} blocks an SM")

    log(f"[probe] {n_iter} chained ({m}, {k}) @ ({k}, {n}) products a launch on wgmma, in a CUDA "
        f"graph: bf16 {bf['ms']:.4f} ms = {ops / bf['ms'] / 1e9:.1f} TFLOP/s "
        f"({ops / bf['ms'] / 1e9 / (PEAK_BF16 / 1e12):.1%} of the bf16 peak; bound "
        f"{bf['bound'][0]:.4f}) | int8 {i8['ms']:.4f} ms = {ops / i8['ms'] / 1e9:.1f} TOP/s "
        f"({ops / i8['ms'] / 1e9 / (PEAK_INT8 / 1e12):.1%} of the int8 peak; bound "
        f"{i8['bound'][0]:.4f}) | int8 : bf16 rate {bf['ms'] / i8['ms']:.2f}x | per call from "
        f"the host bf16 "
        f"{call_ms[torch.bfloat16]:.4f}, int8 {call_ms[torch.int8]:.4f} ms | library, {n_iter} "
        f"calls: torch.matmul bf16 {bf['library_ms']:.4f} ms = "
        f"{ops / bf['library_ms'] / 1e9:.1f} TFLOP/s, torch._int_mm {i8['library_ms']:.4f} ms = "
        f"{ops / i8['library_ms'] / 1e9:.1f} TOP/s | {smi}")
    log(f"[probe] clock64: bf16 {sections(bf['clocks'])}; int8 {sections(i8['clocks'])} | "
        f"kernels: bf16 {kres(bf['res'])}; int8 {kres(i8['res'])}")
    rows = []
    for dt, r in ((torch.int8, i8), (torch.bfloat16, bf)):
        name = str(dt).replace("torch.", "")
        lib = "torch._int_mm" if dt == torch.int8 else "torch.matmul"
        rows.append(dict(
            name="mma_probe" if dt == torch.int8 else "mma_probe_bf16", route="cuda",
            source="efficientsam3_tpu_torch/csrc/mma_probe.cu",
            replaces="scripts/probe_int8_mxu.py:52", launches=launches, max_abs_err=r["err"],
            ms=r["ms"], call_ms=call_ms[dt], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"], device_ms=None,
            shape=f"{name} x ({m}, {k}) @ y ({k}, {n}) x {n_iter} -> f32 on wgmma; library = "
                  f"{n_iter} x {lib}; {kres(r['res'])}; int8 : bf16 rate "
                  f"{bf['ms'] / i8['ms']:.2f}x", **{"pass": True}))
        log_row(rows[-1], smi)
    return rows


# the tracker's training clip: 8 frames over 8 object slots, 3 of them live,
# prompted on frame 0 as in [video]; per tracked frame (plain path) 4 self-
# and 4 cross-attentions and 13 norms, per memory encode the fuser's 2
# depthwise convs; the backward runs each attention's and norm's once, and
# the depthwise backward of every memory a later frame reads
TT_FRAMES, TT_SLOTS, TT_LIVE, TT_CHECK_FRAMES = 8, 8, 3, 3
TT_FWD = {"flash_sdpa": 8, "layer_norm": 13}
TT_BWD = {"flash_sdpa_bwd_dq": 8, "flash_sdpa_bwd_dkv": 8, "layer_norm_bwd": 13}
TT_PROMPTS = (([[100, 150], [400, 520]], [2, 3]), ([[700, 300]], [1]),
              ([[500, 800], [560, 760]], [1, 0]))
# kernels against plain versions in the clip's gradient, |g - g_plain| /
# |g_plain| over every parameter: bf16 P and dS in the attention backward,
# bf16 dx of the depthwise, against the plain versions' fp32 autograd, over
# 3 frames: 3-5% in each group on the H100 (PERF.md); a cut from the graph
# moves each group by 29% or more. The bound holds on each group and on
# all, and each group's cut must exceed twice it
TT_GRAD_BOUND = 0.1
TT_GROUPS = {"memory_attention": ("memory_attention",), "memory_encoder": ("memory_encoder",),
             "sam_heads": ("sam_mask_decoder", "sam_prompt_encoder", "obj_ptr_proj",
                           "obj_ptr_tpos_proj")}
RMS_SHAPES = ((8, 72, 72, 256), (4, 63, 63, 128))
# the rms_norm_2d drive: both shapes in bf16, the tracker's map in fp32
RMS_CASES = tuple((s, dt) for s, dt in ((RMS_SHAPES[0], "bf16"), (RMS_SHAPES[1], "bf16"),
                                        (RMS_SHAPES[0], "fp32")))


def ticket_streams_check(calls, smi, rounds=3):
    """The backward kernels that take atomic tickets ({name: call}),
    launched on two streams at once, rounds times on each: every result is
    the bits of the same call alone on the current stream, the two streams'
    ticket buffers are apart, and every buffer is back at 0. Raises
    otherwise."""
    import torch

    from efficientsam3_tpu_torch.ops import _build

    dev = torch.device("cuda")
    alone = {name: fn() for name, fn in calls.items()}
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(rounds):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append({name: fn() for name, fn in calls.items()})
    held = []
    for s in streams:
        with torch.cuda.stream(s):
            held.append(_build.tickets(dev, 1).data_ptr())
    torch.cuda.synchronize()
    differ = sorted({name for out in outs for name, got in out.items()
                     if not all(torch.equal(a, b) for a, b in zip(got, alone[name]))})
    left = sum(int((b != 0).sum().item()) for b in _build.ticket_buffers())
    log(f"[tickets] {', '.join(calls)} on two streams at once, {rounds} rounds each: results "
        f"that differ from the call alone {differ or 'none'}; the streams' buffers "
        f"{'apart' if held[0] != held[1] else 'SHARED'}; {left} tickets left nonzero over "
        f"{len(_build.ticket_buffers())} buffers | {smi}")
    if differ or left or held[0] == held[1]:
        raise AssertionError("backward kernels on two streams shared or left tickets")


def tracker_bank(t, n_mem, n_ptr):
    """The predictor's bank at frame t of a clip prompted on frame 0:
    memory columns [(source frame, tpos)] (the prompted frame at tpos 0,
    then the recent frames oldest first at tpos n_mem - distance) and
    pointer sources [(frame, distance)] (the prompted frame, then the
    recent frames newest first)."""
    recent = list(range(max(1, t - (n_mem - 1)), t))
    cols = [(0, 0)] + [(s, n_mem - (t - s)) for s in recent]
    ptrs = [(0, t)] + [(s, t - s) for s in range(t - 1, 0, -1)][:n_ptr - 1]
    return cols, ptrs


def tracker_clip(core, feats, pos, proj, n_live, compact=False):
    """The tracker's training clip through TrackerCore's methods (the
    caller sets training mode): feats [(tokens (1, HW, C), neck level 0,
    neck level 1)] a frame; S = proj.shape[1] object slots, the first
    n_live prompted on frame 0 by TT_PROMPTS, the rest empty padding.
    Frame 0: no_mem_features -> forward_sam_heads (no multimask: the
    decoder's training flag takes mask 0) -> encode_memory. Frames 1..:
    condition_features (the plain path) over the predictor's fixed-width
    bank of stacked memories and pointers, masked where a column is empty
    or a slot holds no object (compact: only the columns that hold a frame)
    -> forward_sam_heads (multimask) -> encode_memory. The loss is the
    fixed projection proj (T, S, 1, 288, 288) of the live slots' low-res
    masks. Returns (loss, [low-res masks a frame])."""
    import torch

    dev = pos.device
    s_n = proj.shape[1]
    fs, d, n_mem, n_ptr = core.feat_size, core.d_model, core.num_maskmem, core.max_obj_ptrs
    live = torch.arange(s_n, device=dev) < n_live

    def frame(t):  # one frame's features, shared by the slots (the predictor's tiling)
        tokens, f0, f1 = feats[t]
        tile = lambda x: x.expand(s_n, *x.shape[1:])  # noqa: E731
        s0, s1 = core.sam_mask_decoder.high_res_convs(f0, f1)
        return tile(tokens), (tile(s0), tile(s1))

    coords = torch.zeros((s_n, 3, 2), device=dev)
    labels = -torch.ones((s_n, 3), dtype=torch.long, device=dev)
    for slot, (pts, labs) in enumerate(TT_PROMPTS[:n_live]):
        coords[slot, :len(pts)] = torch.tensor(pts, dtype=torch.float32)
        labels[slot, :len(labs)] = torch.tensor(labs)
    tokens, hr = frame(0)
    heads = core.forward_sam_heads(core.no_mem_features(tokens).reshape(s_n, fs, fs, d), coords,
                                   labels, hr, False)
    mems = {0: core.encode_memory(tokens, heads["high_res_masks"], heads["object_score_logits"],
                                  True)}
    ptrs = {0: heads["obj_ptr"]}
    outs = [heads["low_res_masks"]]
    for t in range(1, proj.shape[0]):
        cols, psrc = tracker_bank(t, n_mem, n_ptr)
        width, pwidth = (len(cols), len(psrc)) if compact else (n_mem, n_ptr)
        mem = torch.stack([mems[f] for f, _ in cols]
                          + [torch.zeros_like(mems[0])] * (width - len(cols)), 1)
        tpos = torch.zeros((s_n, width), dtype=torch.long, device=dev)
        tpos[:, :len(cols)] = torch.tensor([tp for _, tp in cols])
        valid = (torch.arange(width, device=dev) < len(cols))[None] & live[:, None]
        obj_ptrs = torch.stack([ptrs[f] for f, _ in psrc]
                               + [torch.zeros_like(ptrs[0])] * (pwidth - len(psrc)), 1)
        tdiff = torch.zeros((s_n, pwidth), device=dev)
        tdiff[:, :len(psrc)] = torch.tensor([float(x) for _, x in psrc])
        pvalid = (torch.arange(pwidth, device=dev) < len(psrc))[None] & live[:, None]
        tokens, hr = frame(t)
        cond = core.condition_features(tokens, pos, mem, tpos, valid, obj_ptrs, tdiff, pvalid,
                                       float(min(proj.shape[0], n_ptr)))
        heads = core.forward_sam_heads(
            cond.reshape(s_n, fs, fs, d), torch.zeros((s_n, 1, 2), device=dev),
            -torch.ones((s_n, 1), dtype=torch.long, device=dev), hr, True)
        mems[t] = core.encode_memory(tokens, heads["high_res_masks"],
                                     heads["object_score_logits"], False)
        ptrs[t] = heads["obj_ptr"]
        outs.append(heads["low_res_masks"])
    loss = sum((m[:n_live].float() * p[:n_live]).sum() for m, p in zip(outs, proj))
    return loss, outs


def tracker_train_phase(smi):
    """Phase 9: the tracker's training path at full width, and rms_norm_2d at
    kernel level; returns the rows of the d=256 backward kernels, the
    depthwise backward and rms_norm_2d forward and backward."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
    from efficientsam3_tpu_torch.models import common, memory_encoder
    from efficientsam3_tpu_torch.models.common import sine_pos_embed_2d
    from efficientsam3_tpu_torch.ops import depthwise as dw
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.ops import layer_norm as ln
    from efficientsam3_tpu_torch.ops import rms_norm as rn
    from efficientsam3_tpu_torch.train.trainer import deterministic_cudnn

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    counters = {"flash_sdpa": fa, "flash_sdpa_bwd_dq": fa, "flash_sdpa_bwd_dkv": fa,
                "layer_norm": ln, "layer_norm_bwd": ln, "depthwise_conv2d": dw,
                "depthwise_conv2d_bwd": dw, "flash_memattn": fa, "flash_memattn_q8": fa,
                "flash_xattn_rpb": fa}

    def reset():
        for name, mod in counters.items():
            getattr(mod, name).launches = 0

    def counts():
        return {name: getattr(mod, name).launches for name, mod in counters.items()}

    def events(n):
        return [torch.cuda.Event(enable_timing=True) for _ in range(n)]

    # the [video] configuration: EV-M b1 with the SAM2 neck, TrackerCore at
    # 1008^2, bf16, seed 0. The fuser's layer scales go from 1e-6 to 1, so
    # that the depthwise branch carries gradient the checks can see
    image, core = build_efficientsam3_video_model(model_name="b1", dtype=torch.bfloat16,
                                                  device=dev, seed=0)
    with torch.no_grad():
        for blk in core.memory_encoder.fuser:
            blk.gamma.fill_(1.0)
        # random weights score every object as gone on tracked frames, whose
        # masks are then the constant no-object fill and pass no gradient:
        # the object-score head's last bias is raised by 10, as in [pcs]
        core.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += 10.0
    core.train().requires_grad_(True)
    fs, d = core.feat_size, core.d_model
    frames = np.random.default_rng(7).standard_normal((TT_FRAMES, 1008, 1008, 3)).astype(np.float32)
    feats = []
    with torch.no_grad():  # the image model is not trained here: features as the predictor's
        for t in range(TT_FRAMES):
            fpn = image.encode_image(torch.as_tensor(frames[t], device=dev)[None])["sam2_fpn"]
            feats.append((fpn[2].reshape(1, fs * fs, d), fpn[0], fpn[1]))
    del image, fpn
    pos = sine_pos_embed_2d(fs, fs, d, device=dev).reshape(fs * fs, d)
    gen = torch.Generator(device=dev).manual_seed(5)
    proj = torch.randn((TT_FRAMES, TT_SLOTS, 1, 4 * fs, 4 * fs), generator=gen, device=dev)

    def clip(seed=0, **kw):
        torch.manual_seed(seed)  # the dropout bits
        core.zero_grad(set_to_none=True)
        return tracker_clip(core, feats, pos, proj, TT_LIVE, **kw)

    # ---- run 1: counted, and the backward kernels' inputs captured (the
    # attention with the most live keys, cross and self, and the depthwise)
    def live_keys(a):
        return int((a[3] > fa.NEG_INF / 2).sum().item())

    capture = Capture(
        [(fa, "flash_sdpa_bwd_dq"), (dw, "depthwise_conv2d_bwd")],
        key=lambda name, a: (name, "self" if a[0].shape[2] == a[1].shape[2] else "cross")
        if name.startswith("flash") else (name, a[0].shape[-1]),
        size=lambda name, a: live_keys(a) if name.startswith("flash") else a[0].numel())
    # runs 1-3 train as the port's training entry points do, with cuDNN's
    # deterministic algorithms (without them three of the clip's weight
    # gradients, of convolutions, differ from run to run on an H100)
    torch.cuda.reset_peak_memory_stats()
    with capture, deterministic_cudnn():
        reset()
        loss, outs = clip()
        fwd = counts()
        loss.backward()
        torch.cuda.synchronize()
        total = counts()
    bwd = {k: total[k] - fwd[k] for k in total}
    tracked, encodes = TT_FRAMES - 1, TT_FRAMES
    want_fwd = {k: 0 for k in counters}
    want_fwd.update({k: n * tracked for k, n in TT_FWD.items()}, depthwise_conv2d=2 * encodes)
    want_bwd = {k: 0 for k in counters}
    want_bwd.update({k: n * tracked for k, n in TT_BWD.items()},
                    depthwise_conv2d_bwd=2 * (encodes - 1))
    log(f"[tracker_train] launches over the {TT_FRAMES}-frame clip ({tracked} tracked frames, "
        f"{encodes} memory encodes): forward {fwd}; backward {bwd}")
    if fwd != want_fwd or bwd != want_bwd:
        raise AssertionError(f"[tracker_train] launches: forward {fwd} (want {want_fwd}), "
                             f"backward {bwd} (want {want_bwd})")
    if not math.isfinite(loss.item()):
        raise AssertionError(f"[tracker_train] loss {loss.item()}")
    for t, m in enumerate(outs):
        if tuple(m.shape) != (TT_SLOTS, 1, 288, 288) or not torch.isfinite(m).all():
            raise AssertionError(f"[tracker_train] frame {t}: masks {tuple(m.shape)} or non-finite")
    moved = {}
    for name, p in core.named_parameters():
        if p.grad is None:
            continue
        if not torch.isfinite(p.grad.float()).all():
            raise AssertionError(f"[tracker_train] non-finite gradient of {name}")
        top = name.split(".")[0]
        moved[top] = moved.get(top, 0) + int((p.grad != 0).sum())
    for top in ("memory_attention", "memory_encoder", "sam_mask_decoder", "sam_prompt_encoder"):
        if not moved.get(top):
            raise AssertionError(f"[tracker_train] no gradient reached {top}")
    log(f"[tracker_train] loss {loss.item():.4f}; non-zero gradient elements by module {moved}")
    first = training_bits(core, None, [{"loss": loss.detach()}])
    del loss, outs

    # ---- run 2: timed (the same dropout bits), and the same bits as run 1
    torch.cuda.synchronize()
    e = events(3)
    with deterministic_cudnn():
        e[0].record()
        loss, outs = clip()
        e[1].record()
        loss.backward()
        e[2].record()
        e[2].synchronize()
    fwd_ms, bwd_ms = e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[tracker_train] clip of {TT_FRAMES} frames, {TT_SLOTS} slots ({TT_LIVE} live), bf16: "
        f"forward {fwd_ms:.1f} ms | backward {bwd_ms:.1f} ms | peak memory {peak:.2f} GiB "
        f"(runs 1-2) | {smi}")
    assert_same_bits(f"[tracker_train] the {TT_FRAMES}-frame clip's loss and gradients (runs 1 "
                     f"and 2)", first, training_bits(core, None, [{"loss": loss.detach()}]))
    del loss, outs, first
    for what, shape, size in (("the memory encoder's", (TT_SLOTS, 1, 1008, 1008), (1152, 1152)),
                              ("the SAM heads' mask", (TT_SLOTS, 1, 288, 288), (1008, 1008))):
        new_ms, lib_ms, err = resize_backward_ms(shape, size)
        log(f"[tracker_train] {what} upsample backward {shape} -> {size[0]}^2 fp32, once a "
            f"frame: two matmuls {new_ms:.4f} ms, F.interpolate's (atomics) {lib_ms:.4f} ms, "
            f"apart by {err:.2e} of the largest magnitude | {smi}")

    # ---- run 3: the backward by kernel under the profiler
    with deterministic_cudnn():
        loss, _ = clip()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loss.backward()
            torch.cuda.synchronize()
    del loss
    kernels = sorted(((ev.key, ev.self_device_time_total, ev.count) for ev in prof.key_averages()
                      if ev.device_type == torch.autograd.DeviceType.CUDA), key=lambda r: -r[1])
    total_us = sum(us for _, us, _ in kernels)
    device_ms = {}
    if total_us == 0:
        log("[profile] tracker backward: the profiler recorded no device time: not measured")
    else:
        busy = total_us / 1e3 / bwd_ms
        log(f"[profile] tracker clip backward: {sum(n for _, _, n in kernels)} kernel launches, "
            f"{total_us / 1e3:.3f} ms of device time in a {bwd_ms:.1f} ms backward: device busy "
            f"{busy:.1%}, idle {1 - busy:.1%}")
        for name, us, n in kernels[:12]:
            log(f"[profile] tracker backward:   {us / 1e3:8.4f} ms  x{n:<4d} {name[:90]}")
        for name, us, n in kernels:
            for key, pattern in (("flash_sdpa_bwd_dq_d256", "flash_bwd_dq_wide_h_kernel"),
                                 ("flash_sdpa_bwd_dkv_d256", "flash_bwd_dkv_wide_h_kernel"),
                                 ("depthwise_conv2d_bwd", "dw7_bwd_kernel")):
                if pattern in name:
                    device_ms[key] = device_ms.get(key, 0.0) + us / 1e3 / n
        pair = {key: [(us, n) for name, us, n in kernels if pattern in name]
                for key, pattern in (("dq", "flash_bwd_dq_wide_h_kernel"),
                                     ("dkv", "flash_bwd_dkv_wide_h_kernel"))}
        if not all(pair.values()):
            raise AssertionError(f"[profile] tracker backward: no d=256 wgmma kernel by name: {pair}")
        pair_ms = {key: sum(us for us, _ in v) / 1e3 for key, v in pair.items()}
        log(f"[profile] tracker clip backward: {bwd_ms:.1f} ms, {total_us / 1e3:.3f} ms of device "
            f"time; the d=256 pair {pair_ms['dq'] + pair_ms['dkv']:.3f} ms of it "
            f"({(pair_ms['dq'] + pair_ms['dkv']) / (total_us / 1e3):.1%}: dq {pair_ms['dq']:.3f} "
            f"ms x{sum(n for _, n in pair['dq'])}, dkv {pair_ms['dkv']:.3f} ms "
            f"x{sum(n for _, n in pair['dkv'])}) | {smi}")
        write_out("profile_tracker_backward.txt",
                  "\n".join(f"{us:12.2f} us  x{n:<5d} {name}" for name, us, n in kernels))
    del prof

    # ---- nothing cut from the graph: the gradient of a 3-frame clip over
    # the 3 live slots (a compact bank, so that the plain versions' logits
    # fit) through the kernels, through the plain versions, and with the
    # kernels' outputs cut from the graph; the same dropout bits each time
    feats_all, proj_all = feats, proj
    feats, proj = feats_all[:TT_CHECK_FRAMES], proj_all[:TT_CHECK_FRAMES, :TT_LIVE]

    def grads():
        loss, _ = clip(seed=1, compact=True)
        loss.backward()
        # a parameter the run leaves without a gradient counts as zeros (the
        # cut run reaches no memory-encoder parameter), so the runs' vectors align
        named = [(k, (p.grad if p.grad is not None else torch.zeros_like(p)).float().flatten())
                 for k, p in core.named_parameters()]
        out = {g: torch.cat([v for k, v in named if k.split(".")[0] in tops])
               for g, tops in TT_GROUPS.items()}
        out["all"] = torch.cat([v for _, v in named])
        return out

    reset()
    g_runs = {"kernels": grads()}
    launched = counts()
    if min(launched[k] for k in ("flash_sdpa_bwd_dq", "depthwise_conv2d_bwd", "layer_norm_bwd")) == 0:
        raise AssertionError(f"[tracker_train] the kernel run did not launch the kernels: {launched}")
    saved = common.flash_sdpa, memory_encoder.depthwise_conv2d
    for name, attn, conv in (
            ("plain", fa.flash_sdpa_plain, dw.depthwise_conv2d_plain),
            ("cut", lambda *a, **k: fa.flash_sdpa(*a, **k).detach(),
             lambda *a: dw.depthwise_conv2d(*a).detach())):
        common.flash_sdpa, memory_encoder.depthwise_conv2d = attn, conv
        reset()
        try:
            g_runs[name] = grads()
        finally:
            common.flash_sdpa, memory_encoder.depthwise_conv2d = saved
        if name == "plain" and any(counts()[k] for k in ("flash_sdpa", "depthwise_conv2d")):
            raise AssertionError(f"[tracker_train] the plain run launched a kernel: {counts()}")
    rel = {run: {g: ((g_runs[run][g] - g_runs["plain"][g]).norm()
                     / g_runs["plain"][g].norm()).item() for g in g_runs["plain"]}
           for run in ("kernels", "cut")}
    log(f"[tracker_train] gradient of a {TT_CHECK_FRAMES}-frame clip over the {TT_LIVE} live "
        f"slots, |g - g_plain| / |g_plain| by group: kernels "
        f"{ {g: round(x, 5) for g, x in rel['kernels'].items()} } (bound {TT_GRAD_BOUND} on each); "
        f"the kernels' outputs cut from the graph "
        f"{ {g: round(x, 5) for g, x in rel['cut'].items()} } (each must exceed {2 * TT_GRAD_BOUND})")
    if not all(rel["kernels"][g] <= TT_GRAD_BOUND and rel["cut"][g] > 2 * TT_GRAD_BOUND
               for g in rel["kernels"]):
        raise AssertionError(f"[tracker_train] gradient through the kernels: {rel}")
    del g_runs, feats, feats_all, proj, proj_all
    core.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # ---- the d=256 backward kernels against their plain versions, at the
    # captured cross-attention (the most live keys) and self-attention
    rows = []
    for which in ("cross", "self"):
        (q, k, v, key_bias, o, lse, do, scale), _ = capture.args[("flash_sdpa_bwd_dq", which)]
        b, h, lq, dd = q.shape
        dq, delta = fa.flash_sdpa_bwd_dq(q, k, v, key_bias, o, lse, do, scale)
        want_dq, want_delta = fa.flash_sdpa_bwd_dq_plain(q, k, v, key_bias, o, lse, do, scale)
        err_dq = check_rel(f"flash_sdpa_bwd_dq_d256 ({which})", dq, want_dq)
        delta_err = (delta - want_delta).abs().max().item()
        if delta_err > 1e-2:
            raise AssertionError(f"flash_sdpa_bwd_dq_d256 delta off by {delta_err}")
        del want_dq
        dk, dv = fa.flash_sdpa_bwd_dkv(q, k, v, key_bias, do, lse, delta, scale)
        want_dk, want_dv = fa.flash_sdpa_bwd_dkv_plain(q, k, v, key_bias, do, lse, want_delta,
                                                       scale)
        err_dkv = max(check_rel(f"flash_sdpa_bwd_dkv_d256 ({which}, dk)", dk, want_dk),
                      check_rel(f"flash_sdpa_bwd_dkv_d256 ({which}, dv)", dv, want_dv))
        del want_dk, want_dv, want_delta, dq, dk, dv
        torch.cuda.empty_cache()
        live = int((key_bias > fa.NEG_INF / 2).sum().item())  # summed over the slots
        scores = h * lq * live  # skipped tiles do no work
        nb_dq = 2 * (4 * q.numel() + 2 * h * live * dd) + 4 * (key_bias.numel() + 2 * lse.numel())
        nb_dkv = 2 * (2 * q.numel() + 4 * h * live * dd) + 4 * (key_bias.numel() + 2 * lse.numel())
        bms_dq, by_dq = bound(nb_dq, 3 * 2.0 * scores * dd, 1.0 * scores, 6.0 * scores)
        bms_dkv, by_dkv = bound(nb_dkv, 4 * 2.0 * scores * dd, 1.0 * scores, 6.0 * scores)
        per, reps = (2, 5) if which == "cross" else (5, 10)
        run_dq = lambda: fa.flash_sdpa_bwd_dq(q, k, v, key_bias, o, lse, do, scale)  # noqa: E731
        run_dkv = lambda: fa.flash_sdpa_bwd_dkv(q, k, v, key_bias, do, lse, delta, scale)  # noqa: E731
        ms_dq, ms_dkv = graph_time(run_dq, per, reps), graph_time(run_dkv, per, reps)
        # the library yardstick: SDPA's backward with a boolean key mask (one
        # call computes dq, dk and dv: it stands beside both rows)
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        ol = F.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=(key_bias > fa.NEG_INF / 2)[:, None, None, :], scale=scale)
        lib_ms = cuda_time(lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True),
                           5 if which == "cross" else 20)
        del ql, kl, vl, ol
        shape = (f"{which}-attention q/o/dO {tuple(q.shape)} k/v {tuple(k.shape)} bf16 (dO "
                 f"strided), {live} live keys over {b} slots")
        log(f"[kernel] flash_sdpa_bwd_d256 at the {shape}: dq {ms_dq:.4f} ms (bound "
            f"{bms_dq:.4f}, {by_dq}; {ms_dq / bms_dq:.2f}x) | dkv {ms_dkv:.4f} ms (bound "
            f"{bms_dkv:.4f}, {by_dkv}; {ms_dkv / bms_dkv:.2f}x) | dq + dkv {ms_dq + ms_dkv:.4f} "
            f"ms against SDPA backward's {lib_ms:.4f} ms | max rel err dq {err_dq:.3e} dkv "
            f"{err_dkv:.3e} | {smi}")
        if which == "self":
            continue
        for name, fn, err, ms, bms, by, line in (
                ("flash_sdpa_bwd_dq_d256", run_dq, err_dq, ms_dq, bms_dq, by_dq, 1082),
                ("flash_sdpa_bwd_dkv_d256", run_dkv, err_dkv, ms_dkv, bms_dkv, by_dkv, 1098)):
            plain = (lambda: fa.flash_sdpa_bwd_dq_plain(q, k, v, key_bias, o, lse, do, scale)) \
                if "dq" in name else \
                (lambda: fa.flash_sdpa_bwd_dkv_plain(q, k, v, key_bias, do, lse, delta, scale))
            rows.append(dict(
                name=name, route="cuda",
                source="efficientsam3_tpu_torch/csrc/flash_sdpa_bwd_wide_h.cu",
                replaces=f"efficientsam3_tpu/ops/pallas/flash_attention.py:{line}",
                launches=bwd[name.replace("_d256", "")], max_abs_err=err, ms=ms,
                call_ms=cuda_time(fn, 5), plain_ms=cuda_time(plain, 2, warmup=1), bound_ms=bms,
                bound_by=by, library_ms=lib_ms, device_ms=device_ms.get(name),
                shape=shape + "; profiler: mean over the clip's launches (cross and self)",
                **{"pass": True}))
            torch.cuda.empty_cache()
        del q, k, v, o, lse, do, delta

    # ---- the depthwise backward at the memory encoder's (8, 72, 72, 256)
    (x, kernel, g), _ = capture.args[("depthwise_conv2d_bwd", 256)]
    dx, dwt, db = dw.depthwise_conv2d_bwd(x, kernel, g)
    want = dw.depthwise_conv2d_bwd_plain(x, kernel, g)
    # dx is a gradient of the loss, of no set scale: held relative to its
    # largest magnitude, as the attention gradients are
    err = check_rel("depthwise_conv2d_bwd (dx)", dx, want[0])
    for name, got_, want_ in (("dw", dwt, want[1]), ("db", db, want[2])):
        rel_ = ((got_ - want_).abs().max() / want_.abs().max()).item()
        log(f"[kernel] depthwise_conv2d_bwd ({name}): max error {rel_:.3e} of its range (bound 1e-4)")
        if rel_ > 1e-4:
            raise AssertionError(f"depthwise_conv2d_bwd {name} disagrees with its plain version")
    c = x.shape[-1]
    res = dw.kernel_resources(x.dtype, backward=True)
    replay_ms, replay_k = replay_profile(lambda: dw.depthwise_conv2d_bwd(x, kernel, g))
    replay_top = ", ".join(f"{k[:40]} {v:.4f}" for k, v in
                           sorted(replay_k.items(), key=lambda kv: -kv[1])[:3])
    eager_ms = graph_time(lambda: dw._dw_db(x, g, 7), 5, 10)
    nb = 2 * (x.numel() + g.numel() + dx.numel()) + 4 * (kernel.numel() + c)
    bms, by = bound(nb, fp32_ops=4.0 * 49 * x.numel())
    x_cl = x.permute(0, 3, 1, 2).detach().clone().requires_grad_()
    w_l = kernel.permute(3, 2, 0, 1).to(x.dtype).detach().clone().requires_grad_()
    b_l = torch.zeros(c, dtype=x.dtype, device=dev, requires_grad=True)
    y_l = F.conv2d(x_cl, w_l, b_l, padding=3, groups=c)
    g_l = g.permute(0, 3, 1, 2)
    rows.append(dict(
        name="depthwise_conv2d_bwd", route="cuda",
        source="efficientsam3_tpu_torch/csrc/depthwise_conv2d.cu",
        replaces="efficientsam3_tpu/ops/pallas/depthwise.py:84",
        launches=bwd["depthwise_conv2d_bwd"], max_abs_err=err,
        ms=graph_time(lambda: dw.depthwise_conv2d_bwd(x, kernel, g), 5, 10),
        call_ms=cuda_time(lambda: dw.depthwise_conv2d_bwd(x, kernel, g), 20),
        plain_ms=graph_time(lambda: dw.depthwise_conv2d_bwd_plain(x, kernel, g), 2, 5),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_time(lambda: torch.autograd.grad(y_l, (x_cl, w_l, b_l), g_l,
                                                         retain_graph=True), 20),
        device_ms=device_ms.get("depthwise_conv2d_bwd"),
        shape=f"x / dy {tuple(x.shape)} bf16 strides {x.stride()} / {g.stride()}, 7x7 taps: dx, "
              f"dw and db in one kernel, dev {replay_ms:.4f} ms a call in a graph replay "
              f"({replay_top}); {res['registers']} registers, "
              f"{res['spill_bytes']} bytes spilled, {res['smem_bytes']} B shared, "
              f"{res['blocks_per_sm']} blocks an SM (dw / db as 49 eager fp32 products and sums "
              f"{eager_ms:.4f} ms); library = F.conv2d (groups=C) backward",
        **{"pass": True}))
    # ---- the three kernels that take tickets on two streams at once: the
    # depthwise backward at these inputs, LayerNorm's at the Stage-3 step's
    # norms, RMSNorm's at the tracker's map
    xl, gl = (torch.randn((4 * 5184, c), generator=gen, device=dev).to(x.dtype)
              for _ in range(2))
    wl = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
    xr = (3 * torch.randn(x.shape, generator=gen, device=dev)).to(x.dtype)
    _, rstd_r = rn.rms_norm_2d_plain(xr, wl, wl, return_rstd=True)
    ticket_streams_check({
        "depthwise_conv2d_bwd": lambda: dw.depthwise_conv2d_bwd(x, kernel, g),
        "layer_norm_bwd": lambda: ln.layer_norm_bwd(xl, wl, gl, 1e-5),
        "rms_norm_2d_bwd": lambda: rn.rms_norm_2d_bwd(xr, wl, rstd_r, g)}, smi)
    del x, kernel, g, dx, x_cl, w_l, b_l, y_l, g_l, capture, core, xl, gl, xr

    # ---- rms_norm_2d at kernel level (no model calls it): forward and
    # backward under autograd at the tracker's map and EV-M's stride-16 map
    # at the Stage-3 batch of 4 (15876 rows: a ragged last program) in bf16,
    # and at the tracker's map in fp32
    rms = []
    for shape, dname in RMS_CASES:
        dtype = torch.float32 if dname == "fp32" else torch.bfloat16
        c = shape[-1]
        x = (3 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
        w = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
        b = 0.1 * torch.randn(c, generator=gen, device=dev)
        g = torch.randn(shape, generator=gen, device=dev).to(dtype)
        rms.append((x, w, b, g))
    rn.rms_norm_2d.launches = rn.rms_norm_2d_bwd.launches = 0
    for x, w, b, g in rms:
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        grads_ = torch.autograd.grad(rn.rms_norm_2d(*leaves), leaves, g)
        if not all(torch.isfinite(t.float()).all() for t in grads_):
            raise AssertionError("rms_norm_2d: non-finite gradients")
    torch.cuda.synchronize()
    rms_launches = (rn.rms_norm_2d.launches, rn.rms_norm_2d_bwd.launches)
    if rms_launches != (len(RMS_CASES), len(RMS_CASES)):
        raise AssertionError(f"rms_norm_2d launches {rms_launches}")
    have_lib = hasattr(F, "rms_norm")
    for i, (x, w, b, g) in enumerate(rms):
        c = x.shape[-1]
        fp32 = x.dtype == torch.float32
        dname = "fp32" if fp32 else "bf16"
        out, rstd = rn._fwd(x, w, b, 1e-5)
        want_out, want_rstd = rn.rms_norm_2d_plain(x, w, b, 1e-5, return_rstd=True)
        tol = FP32_TOL if fp32 else ATOL
        err_f = check(f"rms_norm_2d {dname} {tuple(x.shape)}", out, want_out, tol)
        rstd_err = ((rstd - want_rstd).abs().max() / want_rstd.abs().max()).item()
        dx, dw_, db_ = rn.rms_norm_2d_bwd(x, w, rstd, g)
        want = rn.rms_norm_2d_bwd_plain(x, w, want_rstd, g)
        err_b = check(f"rms_norm_2d_bwd {dname} {tuple(x.shape)} (dx)", dx, want[0], tol)
        rel_w = max(((a - e).abs().max() / e.abs().max()).item()
                    for a, e in ((dw_, want[1]), (db_, want[2])))
        again = rn.rms_norm_2d_bwd(x, w, rstd, g)
        same = all(torch.equal(a, e) for a, e in zip(again, (dx, dw_, db_)))
        log(f"[kernel] rms_norm_2d {dname} {tuple(x.shape)}: rstd {rstd_err:.3e}, dw / db "
            f"{rel_w:.3e} of their ranges (bound 1e-4); the backward's bits again: {same}")
        if rstd_err > 1e-4 or rel_w > 1e-4 or not same:
            raise AssertionError("rms_norm_2d rstd / dw / db disagree with the plain version, "
                                 "or the backward's bits differ run to run")
        rows_n = x.numel() // c
        esz = x.element_size()
        w_x = w.to(x.dtype)
        fwd_ms = graph_time(lambda: rn.rms_norm_2d(x, w, b))
        bwd_ms_ = graph_time(lambda: rn.rms_norm_2d_bwd(x, w, rstd, g))
        lib_f = graph_time(lambda: F.rms_norm(x, (c,), w_x, 1e-5)) if have_lib else None
        if have_lib:
            xl = x.clone().requires_grad_()
            wl = w_x.clone().requires_grad_()
            yl = F.rms_norm(xl, (c,), wl, 1e-5)
            lib_b = cuda_time(lambda: torch.autograd.grad(yl, (xl, wl), g, retain_graph=True), 50)
        else:
            lib_b = None
        nb_f = 2 * esz * x.numel() + 4 * rows_n + 8 * c
        nb_b = 3 * esz * x.numel() + 4 * rows_n + 12 * c
        res = rn.bwd_kernel_resources(x.dtype, g.dtype, c)
        # one kernel a call, beside the graph's zero fill of its tickets (one
        # a graph of 20 calls). The profiler's sum of that kernel over the
        # replay is printed, not kept as the row's device time: it has read
        # under the byte bound (PERF.md §7)
        _, replay_k = replay_profile(lambda: rn.rms_norm_2d_bwd(x, w, rstd, g))
        kernels = [k for k in replay_k if "FillFunctor" not in k]
        if len(kernels) != 1 or "ln_bwd" not in kernels[0]:
            raise AssertionError(f"rms_norm_2d_bwd: {sorted(replay_k)} kernels a call, not one")
        shape = f"x {tuple(x.shape)} {dname} ({rows_n} rows of {c}), w / b f32"
        lib_note = ("" if have_lib else "; this PyTorch has no F.rms_norm: library not measured")
        bwd_note = (f"; one kernel a call in a graph replay (the profiler's sum "
                    f"{replay_k[kernels[0]]:.4f} ms a call), path {res['path']}, "
                    f"{res['registers']} registers, {res['spill_bytes']} bytes spilled, "
                    f"{res['blocks_per_sm']} blocks an SM")
        if i == 1:
            log(f"[kernel] rms_norm_2d at {shape}: forward {fwd_ms:.4f} ms, backward "
                f"{bwd_ms_:.4f} ms (graph; bound {bound(nb_b)[0]:.4f}){bwd_note}; F.rms_norm "
                f"{lib_f} ms, its backward {lib_b} ms | {smi}")
            continue
        suffix = "_fp32" if fp32 else ""
        for name, ms, fn, plain, err_, nb_, flops, lib, line in (
                ("rms_norm_2d", fwd_ms, lambda: rn.rms_norm_2d(x, w, b),
                 lambda: rn.rms_norm_2d_plain(x, w, b), err_f, nb_f, 4.0, lib_f, 59),
                ("rms_norm_2d_bwd", bwd_ms_, lambda: rn.rms_norm_2d_bwd(x, w, rstd, g),
                 lambda: rn.rms_norm_2d_bwd_plain(x, w, rstd, g), err_b, nb_b, 10.0, lib_b, 83)):
            bms, by = bound(nb_, fp32_ops=flops * x.numel())
            is_bwd = name.endswith("bwd")
            rows.append(dict(
                name=name + suffix, route="cuda" if is_bwd else "triton",
                source="efficientsam3_tpu_torch/csrc/layer_norm.cu" if is_bwd else
                "efficientsam3_tpu_torch/ops/rms_norm.py",
                replaces=f"efficientsam3_tpu/ops/pallas/rms_norm.py:{line}",
                launches=rms_launches[is_bwd], max_abs_err=err_, ms=ms,
                call_ms=cuda_time(fn, 50), plain_ms=graph_time(plain, 5, 10), bound_ms=bms,
                bound_by=by, library_ms=lib, device_ms=None,
                shape=shape + ("; library = F.rms_norm backward (dx, dw)" + bwd_note if is_bwd
                               else "; library = F.rms_norm (no bias)") + lib_note,
                **{"pass": True}))
    for r in rows:
        log_row(r, smi)
    torch.cuda.empty_cache()
    return rows


# the [fp32] phase: the default builds (no dtype: fp32 compute), one of each
# path at full width, every kernel launched through its fp32 instantiation
FP32_VIDEO_FRAMES = 2  # frame 0 prompted, one tracked frame
FP32_CLIP_FRAMES = 3
GROUND_KEYS = ("pred_logits", "pred_boxes", "pred_masks", "presence_logit_dec")


def fp32_phase(smi, main_ref):
    """Phase 10: the port's default (fp32) builds on the card. A ground
    (launches 27 / 6 / 6) held against the same model in fp32 on the host's
    CPU (plain versions) and set beside the bf16 build's ground of phase 2;
    a tracked frame on the cached exact bank and one with quantize_bank; a
    Stage-3 step (batch 4) through the fp32 backward kernels; a 3-frame
    tracker training clip (compact bank) through the d=256 and depthwise
    backward. Counters are set to 0 just before each and read just after.
    Returns the rows of the fp32 instantiations, each held to its fp32 plain
    version at FP32_TOL and timed as in phase 3 (library: fp32 SDPA, fp32
    F.conv2d, TF32 off)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from efficientsam3_tpu_torch.build import (build_efficientsam3_image_model,
                                               build_efficientsam3_video_model)
    from efficientsam3_tpu_torch.models import common, memory_encoder
    from efficientsam3_tpu_torch.models.common import sine_pos_embed_2d
    from efficientsam3_tpu_torch.ops import depthwise as dw
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.ops import layer_norm as ln
    from efficientsam3_tpu_torch.processor import Sam3Processor
    from efficientsam3_tpu_torch.train import stage3
    from efficientsam3_tpu_torch.video.predictor import TrackerPredictor

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    counters = {"flash_sdpa": fa, "flash_sdpa_bwd_dq": fa, "flash_sdpa_bwd_dkv": fa,
                "flash_memattn": fa, "flash_memattn_q8": fa, "flash_xattn_rpb": fa,
                "layer_norm": ln, "layer_norm_bwd": ln, "depthwise_conv2d": dw,
                "depthwise_conv2d_bwd": dw}

    def reset():
        for name, mod in counters.items():
            getattr(mod, name).launches = 0

    def counts():
        return {name: getattr(mod, name).launches for name, mod in counters.items()}

    def expect(what, got, want):
        want = {k: want.get(k, 0) for k in counters}
        log(f"[fp32] {what}: launches {got}")
        if got != want:
            raise AssertionError(f"[fp32] {what}: launches {got}, want {want}")

    def per_launch(fn, patterns, train=False, exact=()):
        """Profiler device ms a launch, by row name: {name: (pattern, launches a call)};
        the rows named in exact must show exactly that many launches."""
        kernels, _, total_us = profile_kernels(fn, train)
        if total_us == 0:
            return {}
        out = {}
        for name, (pattern, per) in patterns.items():
            us = sum(u for k, u, _ in kernels if pattern in k)
            seen = sum(n for k, _, n in kernels if pattern in k)
            if name in exact and seen != per:
                raise AssertionError(f"[fp32] profile: {seen} launches of {pattern}, not {per}")
            if us:
                out[name] = us / 1e3 / per
        return out

    def row(name, source, line, launches, err, fn, plain, library, bms, by, shape, device):
        r = dict(name=name, route="cuda", source=f"efficientsam3_tpu_torch/csrc/{source}",
                 replaces=f"efficientsam3_tpu/ops/pallas/{line}", launches=launches,
                 max_abs_err=err, ms=graph_time(fn, 5, 10), call_ms=cuda_time(fn, 10),
                 plain_ms=cuda_time(plain, 3, warmup=1), bound_ms=bms, bound_by=by,
                 library_ms=library, device_ms=device, shape=shape, **{"pass": True})
        log_row(r, smi)
        return r

    rows = []
    # ---------------------------------------------------------------- ground
    t0 = time.perf_counter()
    model = build_efficientsam3_image_model(
        backbone_type="efficientvit", model_name="b1", text_encoder_type="MobileCLIP-S0",
        text_encoder_context_length=32, device=dev, seed=0)
    if {p.dtype for p in model.parameters()} != {torch.float32}:
        raise AssertionError("[fp32] the default build is not fp32")
    proc = Sam3Processor(model, resolution=1008, context_length=32)
    image, tokens, box = main_ref["image"], main_ref["tokens"], main_ref["box"]

    def main_path():
        state = proc.set_image(image)
        state["text"] = proc.encode_tokens(tokens)
        return proc.add_geometric_prompt(box, True, state)

    capture = Capture([(common, "flash_sdpa"), (common, "flash_xattn_rpb"),
                       (common, "layer_norm")])
    with capture:  # warm-up: cuDNN plans, captured inputs
        main_path()
    torch.cuda.synchronize()
    reset()
    state = main_path()
    torch.cuda.synchronize()
    expect("per ground call", counts(), MAIN_COUNTS)
    for k in ("scores", "boxes", "masks_logits"):
        if not np.isfinite(state[k]).all():
            raise AssertionError(f"[fp32] non-finite {k}")
    img = proc.preprocess(image)
    tm, tmask = state["text"]
    prompt = state["geometric_prompt"]
    with torch.inference_mode():
        feats = model.encode_image(img)
        ground = lambda: model.ground(feats["fpn"], feats["pos"], tm, tmask, prompt)  # noqa: E731
        res = ground()
        out = {k: res[k].float().cpu() for k in GROUND_KEYS}
        ground_ms = cuda_time(ground, 10)
    # the fp32 ground runs only fp32 kernels: flash_xattn_rpb one launch a call
    # (after its two split passes), layer_norm the fp32 CUDA forward
    dev_ground = per_launch(ground, {"flash_sdpa_fp32": ("flash_sdpa_h_f32_kernel<32>", 6),
                                     "flash_xattn_rpb_fp32": ("flash_xattn_rpb_kernel<float>", 6),
                                     "layer_norm_fp32": ("ln_fwd_", 27)},
                            exact=("flash_xattn_rpb_fp32", "layer_norm_fp32"))
    log(f"[fp32] ground {ground_ms:.3f} ms (bf16 build: {main_ref['ground_ms']:.3f} ms); kept "
        f"{len(state['scores'])} of 200 queries | {smi}")

    # the same model and inputs in fp32 on the host's CPU (the plain versions):
    # the fp32 kernels' split products (~2^-16) and cuDNN's fp32 convolutions
    # against the CPU's, through the whole network; bound 1e-2 of each
    # output's largest magnitude (at least 1)
    cpu_model = build_efficientsam3_image_model(
        backbone_type="efficientvit", model_name="b1", text_encoder_type="MobileCLIP-S0",
        text_encoder_context_length=32, device="cpu", seed=0)
    cpu_model.load_state_dict(model.state_dict())
    t_cpu = time.perf_counter()
    with torch.inference_mode():
        cf = cpu_model.encode_image(img.cpu())
        ref = cpu_model.ground(cf["fpn"], cf["pos"], tm.cpu(), tmask.cpu(), prompt.to("cpu"))
    cpu_s = time.perf_counter() - t_cpu
    errs = {}
    for key in GROUND_KEYS:
        want = ref[key].float()
        errs[key] = (out[key] - want).abs().max().item() / max(1.0, want.abs().max().item())
    log(f"[fp32] ground on the card (fp32 kernels) vs the CPU (plain versions, {cpu_s:.1f} s), "
        f"max abs err over max(1, |largest|): { {k: f'{v:.2e}' for k, v in errs.items()} } "
        f"(bound 1e-2)")
    if not all(e <= 1e-2 for e in errs.values()):
        raise AssertionError(f"[fp32] ground on the card drifts from the CPU: {errs}")
    del cpu_model, cf, ref

    # the bf16 build against this fp32 reference: scores, boxes, masks
    b16 = main_ref["bf16_out"]
    s32 = torch.sigmoid(out["pred_logits"][0, :, 0])
    s16 = torch.sigmoid(b16["pred_logits"][0, :, 0])
    l32, l16 = out["pred_masks"][0], b16["pred_masks"][0]
    m32, m16 = l32 > 0, l16 > 0
    inter = (m32 & m16).flatten(1).sum(1).float()
    union = (m32 | m16).flatten(1).sum(1).float()
    iou = inter[union > 0] / union[union > 0]
    top32 = set(torch.topk(s32, 10).indices.tolist())
    top16 = set(torch.topk(s16, 10).indices.tolist())
    log(f"[fp32] bf16 build vs fp32 build, ground on the same image and prompt (200 queries): "
        f"scores max abs diff {(s32 - s16).abs().max().item():.4f}, mean "
        f"{(s32 - s16).abs().mean().item():.4f}; boxes max abs diff "
        f"{(out['pred_boxes'] - b16['pred_boxes']).abs().max().item():.4f}; mask logits max abs "
        f"diff {(l32 - l16).abs().max().item():.4f} of {l32.abs().max().item():.4f}, signs agree "
        f"on {(m32 == m16).float().mean().item():.4%} of pixels; mask IoU (logits > 0) over "
        f"the {len(iou)} non-empty pairs: mean "
        f"{iou.mean().item() if len(iou) else float('nan'):.4f} min "
        f"{iou.min().item() if len(iou) else float('nan'):.4f}; top-10 queries shared "
        f"{len(top32 & top16)} of 10; presence logit {out['presence_logit_dec'].item():.4f} vs "
        f"{b16['presence_logit_dec'].item():.4f}")

    # the fp32 instantiations at the ground's inputs
    (q, k, v, key_bias, scale), _ = capture.args[("flash_sdpa", 32)]
    b, h, lq, d = q.shape
    got, lse = fa.flash_sdpa(q, k, v, key_bias, scale, return_lse=True)
    want, want_lse = fa.flash_sdpa_plain(q, k, v, key_bias, scale, return_lse=True)
    err = max(check("flash_sdpa_fp32", got, want, FP32_TOL),
              check("flash_sdpa_fp32 lse", lse, want_lse, FP32_TOL))
    live = int((key_bias > fa.NEG_INF / 2).sum().item()) * h * lq
    bms, by = attn_bound(q.numel(), live, d, kv_elems=k.numel() + v.numel())
    res = fa.kernel_resources("flash_sdpa_h_fp32", d, k.shape[2])
    rows.append(row("flash_sdpa_fp32", "flash_sdpa_h_fp32.cu", "flash_attention.py:304",
                    MAIN_COUNTS["flash_sdpa"], err,
                    lambda: fa.flash_sdpa(q, k, v, key_bias, scale),
                    lambda: fa.flash_sdpa_plain(q, k, v, key_bias, scale),
                    graph_time(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 5, 10),
                    bms, by, f"q/k/v {tuple(q.shape)} fp32 (split-bf16 wgmma; graph and call ms "
                    f"with the two split passes, dev the kernel alone; {res['registers']} "
                    f"registers, {res['spill_bytes']} bytes spilled, {res['smem_bytes']} B shared, "
                    f"{res['blocks_per_sm']} blocks an SM); library = fp32 SDPA",
                    dev_ground.get("flash_sdpa_fp32")))
    (q, k, v, ey, ex, feat_hw, scale), _ = capture.args[("flash_xattn_rpb", 32)]
    b, h, lq, d = q.shape
    got = fa.flash_xattn_rpb(q, k, v, ey, ex, feat_hw, scale)
    err = check("flash_xattn_rpb_fp32", got, fa.flash_xattn_rpb_plain(q, k, v, ey, ex, feat_hw,
                                                                      scale), FP32_TOL)
    full_bias = fa.rpb_bias(ey, ex, feat_hw)
    bms, by = attn_bound(q.numel(), b * h * lq * k.shape[2], d, kv_elems=k.numel() + v.numel())
    splits = fa.xattn_splits_for(q.dtype, b * h, lq, feat_hw)
    res = fa.xattn_resources(q.dtype, feat_hw, splits)
    if not torch.equal(fa.flash_xattn_rpb(q, k, v, ey, ex, feat_hw, scale), got):
        raise AssertionError("[fp32] flash_xattn_rpb: two calls differ")
    rows.append(row("flash_xattn_rpb_fp32", "flash_xattn_rpb.cu", "flash_attention.py:898",
                    MAIN_COUNTS["flash_xattn_rpb"], err,
                    lambda: fa.flash_xattn_rpb(q, k, v, ey, ex, feat_hw, scale),
                    lambda: fa.flash_xattn_rpb_plain(q, k, v, ey, ex, feat_hw, scale),
                    graph_time(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=full_bias, scale=scale), 5, 10),
                    bms, by, f"q {tuple(q.shape)} k/v {tuple(k.shape)} fp32 (split-bf16 wgmma; "
                    f"graph and call ms with the two split passes, dev the kernel alone), ey/ex "
                    f"f32, {splits} key splits = the cluster size ({res['registers']} registers, "
                    f"{res['spill_bytes']} bytes spilled, {res['smem_bytes']} B shared, "
                    f"{res['blocks_per_sm']} blocks an SM, {res['stages']} K/V stages, "
                    f"{res['max_clusters']} clusters resident); two calls bit-identical; "
                    f"library = fp32 SDPA, full bias",
                    dev_ground.get("flash_xattn_rpb_fp32")))
    (x, wt, bs, eps, out_dtype), _ = capture.args[("layer_norm", 256)]
    got = ln.layer_norm(x, wt, bs, eps, out_dtype)
    err = check("layer_norm_fp32", got, ln.layer_norm_plain(x, wt, bs, eps, out_dtype), FP32_TOL)
    c = x.shape[-1]
    bms, by = bound(x.numel() * 4 + got.numel() * got.element_size() + 8 * c,
                    fp32_ops=8.0 * x.numel())
    ln_call = lambda: ln.layer_norm(x, wt, bs, eps, out_dtype)  # noqa: E731
    replay_ms, _ = replay_profile(ln_call)
    rows.append(row("layer_norm_fp32", "layer_norm.cu", "layer_norm.py:71",
                    MAIN_COUNTS["layer_norm"], err, ln_call,
                    lambda: ln.layer_norm_plain(x, wt, bs, eps, out_dtype),
                    graph_time(lambda: F.layer_norm(x, (c,), wt, bs, eps), 5, 10),
                    bms, by, f"x {tuple(x.shape)} {x.dtype} -> {out_dtype}; the profiler's "
                    f"{replay_ms:.4f} ms a call in a graph replay; library = fp32 F.layer_norm",
                    dev_ground.get("layer_norm_fp32")))
    del capture, q, k, v, got, want, lse, want_lse, full_bias, feats, proc, state, x
    torch.cuda.empty_cache()
    log(f"[fp32] ground part {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- Stage-3 step
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    opt = stage3.make_stage3_optimizer(stage3.Stage3Config(), model)
    batch = stage3_batch(TRAIN_BATCH, 32, dev)
    capture = Capture([(fa, "flash_sdpa_bwd_dq"), (fa, "flash_sdpa_bwd_dkv"),
                       (ln, "layer_norm_bwd")])
    with capture:  # warm-up step: captured inputs
        stage3.stage3_train_step(model, opt, batch)
    torch.cuda.synchronize()
    reset()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    metrics = stage3.stage3_train_step(model, opt, batch)
    e1.record()
    e1.synchronize()
    expect("per Stage-3 step (batch 4)", counts(), TRAIN_COUNTS)
    if not (math.isfinite(float(metrics["loss"])) and math.isfinite(float(metrics["grad_norm"]))):
        raise AssertionError(f"[fp32] Stage-3 step: {metrics}")
    step_ms = e0.elapsed_time(e1)
    log(f"[fp32] Stage-3 step (batch 4) {step_ms:.1f} ms, loss {float(metrics['loss']):.4f}, "
        f"grad_norm {float(metrics['grad_norm']):.3f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}")
    # the dq and dkv kernels are the split-bf16 wgmma kernels of
    # csrc/flash_sdpa_bwd_dq_h_fp32.cu and csrc/flash_sdpa_bwd_h_fp32.cu (their
    # profile names checked: 6 launches each a step), fed by 24 split passes
    # (K and V for dq, Q and dO for dkv), and the forward's 12 (K and V)
    dev_step = per_launch(lambda: stage3.stage3_train_step(model, opt, batch),
                          {"flash_sdpa_bwd_dq_fp32": ("flash_bwd_dq_h_f32_kernel<32>", 6),
                           "flash_sdpa_bwd_dkv_fp32": ("flash_bwd_dkv_h_f32_kernel<32>", 6),
                           "split_parts_d32": ("split_parts_kernel<32>", 36),
                           "layer_norm_bwd_fp32": ("ln_bwd_", TRAIN_COUNTS["layer_norm_bwd"])},
                          train=True, exact=("flash_sdpa_bwd_dq_fp32", "flash_sdpa_bwd_dkv_fp32",
                                             "split_parts_d32", "layer_norm_bwd_fp32"))
    log(f"[fp32] Stage-3 step profile, device ms a launch: {dev_step}")
    (q, k, v, key_bias, o, lse, do, scale), _ = capture.args[("flash_sdpa_bwd_dq", 32)]
    (x, wt, g, eps), _ = capture.args[("layer_norm_bwd", 256)]
    del opt, batch, model, capture
    torch.cuda.empty_cache()
    rows += bwd_rows_fp32(q, k, v, key_bias, o, lse, do, scale, TRAIN_COUNTS["flash_sdpa_bwd_dq"],
                          "", dev_step, row)
    del q, k, v, key_bias, o, lse, do
    # layer_norm's backward at the fusion encoder's (4 x 5184, 256) fp32 norms
    dx, dw_, db_ = ln.layer_norm_bwd(x, wt, g, eps)
    want = ln.layer_norm_bwd_plain(x, wt, g, eps)
    err = check_rel("layer_norm_bwd_fp32 (dx)", dx, want[0], FP32_TOL)
    for name, got_, want_ in (("dw", dw_, want[1]), ("db", db_, want[2])):
        err = max(err, check_rel(f"layer_norm_bwd_fp32 ({name})", got_, want_, FP32_TOL))
    c = x.shape[-1]
    res = ln.bwd_kernel_resources(x.dtype, g.dtype, c, col_stride=x.stride(-1))
    bms, by = bound(4 * (x.numel() + g.numel() + dx.numel()), fp32_ops=16.0 * x.numel())
    xl = x.detach().clone().requires_grad_()
    wl = wt.detach().float().clone().requires_grad_()
    bl = torch.zeros_like(wl, requires_grad=True)
    yl = F.layer_norm(xl, (c,), wl, bl, eps)
    rows.append(row("layer_norm_bwd_fp32", "layer_norm.cu", "layer_norm.py:88",
                    TRAIN_COUNTS["layer_norm_bwd"], err, lambda: ln.layer_norm_bwd(x, wt, g, eps),
                    lambda: ln.layer_norm_bwd_plain(x, wt, g, eps),
                    cuda_time(lambda: torch.autograd.grad(yl, (xl, wl, bl), g, retain_graph=True),
                              10),
                    bms, by, f"x {tuple(x.shape)} fp32 strides {x.stride()}, dy {g.dtype} "
                    f"strides {g.stride()}; path {res['path']}, {res['registers']} registers, "
                    f"{res['spill_bytes']} bytes spilled, {res['blocks_per_sm']} blocks an SM; "
                    f"library = fp32 F.layer_norm backward", dev_step.get("layer_norm_bwd_fp32")))
    del x, g, dx, xl, wl, bl, yl
    log(f"[fp32] Stage-3 part {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- tracker
    t0 = time.perf_counter()
    image_m, core = build_efficientsam3_video_model(model_name="b1", device=dev, seed=0)
    with torch.no_grad():  # random weights score every object as gone: see [pcs]
        core.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += 10.0
    frames = np.random.default_rng(7).standard_normal(
        (FP32_VIDEO_FRAMES, 1008, 1008, 3)).astype(np.float32)
    tracked = FP32_VIDEO_FRAMES - 1
    sessions = {}

    def run_frame(pred, st):  # one more tracked frame at the last frame (its memory in place)
        with torch.inference_mode():
            return pred._run_track_frame(st, tracked)

    for quantize in (False, True):
        pred = TrackerPredictor(core, image_m.encode_image, obj_slots=8, quantize_bank=quantize)
        st = pred.init_state(frames)
        if quantize:
            st["feat_cache"] = sessions[False][1]["feat_cache"]
        for obj_id, kw in ((1, dict(box=[100, 150, 400, 520])),
                           (2, dict(points=[[700, 300]], labels=[1])),
                           (3, dict(points=[[500, 800], [560, 760]], labels=[1, 0]))):
            pred.add_new_points_or_box(st, 0, obj_id, **kw)
        capture = Capture([(common, "flash_sdpa"), (common, "flash_memattn"),
                           (common, "flash_memattn_q8"), (memory_encoder, "depthwise_conv2d")])
        reset()
        with capture:
            outs = [m.float() for _, _, m in pred.propagate_in_video(st)]
        torch.cuda.synchronize()
        bank = "flash_memattn_q8" if quantize else "flash_memattn"
        want = {k: n * tracked for k, n in VIDEO_COUNTS["A"].items() if k != "flash_memattn"}
        want[bank] = 4 * tracked
        expect(f"{'int8' if quantize else 'exact'} bank, {tracked} tracked frame(s)", counts(), want)
        if "kv_bank" not in st:
            raise AssertionError("[fp32] the session did not build the cached bank")
        for m in outs:
            if tuple(m.shape) != (3, 1, 288, 288) or not torch.isfinite(m).all():
                raise AssertionError(f"[fp32] tracker masks {tuple(m.shape)} or non-finite")
        track_ms = cuda_time(lambda: run_frame(pred, st), 3, warmup=1)
        log(f"[fp32] tracked frame ({'int8' if quantize else 'exact'} bank) {track_ms:.3f} ms | {smi}")
        sessions[quantize] = (pred, st, outs, capture)
    me = sessions[False][2][-1][:, 0] > 0
    mq = sessions[True][2][-1][:, 0] > 0
    union = (me | mq).flatten(1).sum(1)
    iou = [(i / u) for i, u in zip((me & mq).flatten(1).sum(1).tolist(), union.tolist()) if u]
    log(f"[fp32] tracked frame {tracked}, int8 bank vs exact bank: mask IoU per object "
        f"{[round(x, 4) for x in iou]} over {len(iou)} non-empty of 3 (mean bound 0.98, as the "
        f"CPU tests hold in fp32)")
    if not iou or sum(iou) / len(iou) <= 0.98:
        raise AssertionError(f"[fp32] int8 bank drifts from the exact bank, or no mask: {iou}")

    pred_e, st_e, _, cap_e = sessions[False]
    pred_q, st_q, _, cap_q = sessions[True]
    dev_e = per_launch(lambda: run_frame(pred_e, st_e),
                       {"flash_sdpa_d256_fp32": ("flash_sdpa_h_f32_wide_kernel", 4),
                        "flash_memattn_fp32": ("flash_memattn_h_kernel<2>", 4),
                        "depthwise_conv2d_fp32": ("dw7_fwd_kernel<float>", 2)})
    dev_q = per_launch(lambda: run_frame(pred_q, st_q),
                       {"flash_memattn_q8_fp32": ("flash_memattn_q8_h_kernel<2>", 4)},
                       exact=("flash_memattn_q8_fp32",))
    (q, k, v, key_bias, scale), _ = cap_e.args[("flash_sdpa", 256)]
    got, lse = fa.flash_sdpa(q, k, v, key_bias, scale, return_lse=True)
    want, want_lse = fa.flash_sdpa_plain(q, k, v, key_bias, scale, return_lse=True)
    err = max(check("flash_sdpa_d256_fp32", got, want, FP32_TOL),
              check("flash_sdpa_d256_fp32 lse", lse, want_lse, FP32_TOL))
    live = int((key_bias > fa.NEG_INF / 2).sum().item())
    mask = (key_bias > fa.NEG_INF / 2)[:, None, None, :]
    bms, by = attn_bound(q.numel(), live * q.shape[1] * q.shape[2], 256,
                         kv_elems=2 * live * q.shape[1] * 256)
    res = fa.kernel_resources("flash_sdpa_h_fp32", 256, k.shape[2])
    rows.append(row("flash_sdpa_d256_fp32", "flash_sdpa_h_fp32.cu", "flash_attention.py:144",
                    4 * tracked, err, lambda: fa.flash_sdpa(q, k, v, key_bias, scale),
                    lambda: fa.flash_sdpa_plain(q, k, v, key_bias, scale),
                    graph_time(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, scale=scale), 5, 10),
                    bms, by, f"q/k/v {tuple(q.shape)} fp32 (split-bf16 wgmma; graph and call ms "
                    f"with the two split passes, dev the kernel alone; {res['registers']} "
                    f"registers, {res['spill_bytes']} bytes spilled, {res['smem_bytes']} B shared, "
                    f"{res['blocks_per_sm']} blocks an SM), {live} live keys over {q.shape[0]} "
                    f"slots; library = fp32 SDPA, bool key mask",
                    dev_e.get("flash_sdpa_d256_fp32")))
    del q, k, v, got, want, lse, want_lse, mask
    (q, k, v, key_bias, scale), _ = cap_e.args[("flash_memattn", 256)]
    got, lse = fa.flash_memattn(q, k, v, key_bias, scale, return_lse=True)
    want, want_lse = fa.flash_memattn_plain(q, k, v, key_bias, scale, return_lse=True)
    err = max(check("flash_memattn_fp32", got, want, FP32_TOL),
              check("flash_memattn_fp32 lse", lse, want_lse, FP32_TOL))
    del want, want_lse
    live = int((key_bias > fa.NEG_INF / 2).sum().item())
    bias4 = key_bias[:, None, None, :]
    bms, by = attn_bound(q.numel(), live * q.shape[2], 256, 64, live * (256 + 64))
    res = fa.kernel_resources("flash_memattn_h_fp32", 256, k.shape[2])
    rows.append(row("flash_memattn_fp32", "flash_memattn_h.cu", "flash_attention.py:536",
                    4 * tracked, err,
                    lambda: fa.flash_memattn(q, k, v, key_bias, scale, return_lse=True),
                    lambda: fa.flash_memattn_plain(q, k, v, key_bias, scale, True),
                    graph_time(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=bias4, scale=scale), 5, 10),
                    bms, by, f"q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} fp32 "
                    f"(split-bf16 wgmma; graph and call ms with the two split passes, dev the "
                    f"kernel alone; {res['registers']} registers, {res['spill_bytes']} bytes "
                    f"spilled, {res['smem_bytes']} B shared, {res['blocks_per_sm']} blocks an "
                    f"SM), {live} live keys; library = fp32 SDPA, raw v",
                    dev_e.get("flash_memattn_fp32")))
    del q, k, v, got, lse, bias4
    (q, k_i8, ks, v, key_bias, scale), _ = cap_q.args[("flash_memattn_q8", 256)]
    got, lse = fa.flash_memattn_q8(q, k_i8, ks, v, key_bias, scale, return_lse=True)
    want, want_lse = fa.flash_memattn_q8_plain(q, k_i8, ks, v, key_bias, scale, return_lse=True)
    err = max(check("flash_memattn_q8_fp32", got, want, FP32_TOL),
              check("flash_memattn_q8_fp32 lse", lse, want_lse, FP32_TOL))
    del want, want_lse
    live = int((key_bias > fa.NEG_INF / 2).sum().item())
    hq, lqq = q.shape[1], q.shape[2]
    # q and the output fp32, int8 keys, their scale and bias, fp32 values, the lse
    nb = 4 * q.numel() + q.numel() + hq * live * (256 + 8 + 4 * 64) + 4 * lse.numel()
    bms, by = bound(nb, tf32_flops=2.0 * hq * lqq * live * 64, exps=1.0 * hq * lqq * live,
                    fp32_ops=8.0 * hq * lqq * live, int8_ops=2.0 * hq * lqq * live * 256)
    bias4 = key_bias[:, None, None, :]
    res = fa.kernel_resources(fa.memattn_q8_kernel(torch.float32), 256, k_i8.shape[2])
    rows.append(row("flash_memattn_q8_fp32", "flash_memattn_h.cu", "flash_attention.py:739",
                    4 * tracked, err,
                    lambda: fa.flash_memattn_q8(q, k_i8, ks, v, key_bias, scale, return_lse=True),
                    lambda: fa.flash_memattn_q8_plain(q, k_i8, ks, v, key_bias, scale, True),
                    graph_time(lambda: F.scaled_dot_product_attention(
                        q, k_i8.float() * ks[:, None, :, None], v, attn_mask=bias4, scale=scale),
                        5, 10),
                    bms, by, f"q {tuple(q.shape)} fp32, k {tuple(k_i8.shape)} int8, v "
                    f"{tuple(v.shape)} fp32 (int8 wgmma for Q K^T, P V on split bf16 parts; graph "
                    f"and call ms with v's split pass, dev the kernel alone; {res['registers']} "
                    f"registers, {res['spill_bytes']} bytes spilled, {res['smem_bytes']} B shared, "
                    f"{res['blocks_per_sm']} blocks an SM), {live} live keys; library = "
                    f"dequantize + fp32 SDPA",
                    dev_q.get("flash_memattn_q8_fp32")))
    del q, k_i8, ks, v, got, lse, bias4
    (x, kernel, bias), _ = cap_e.args[("depthwise_conv2d", 256)]
    got = dw.depthwise_conv2d(x, kernel, bias)
    err = check("depthwise_conv2d_fp32", got, dw.depthwise_conv2d_plain(x, kernel, bias), FP32_TOL)
    c = x.shape[-1]
    w_nchw = kernel.permute(3, 2, 0, 1).float().contiguous()
    x_cl = x.permute(0, 3, 1, 2)
    bms, by = bound(4 * (x.numel() + got.numel()) + 4 * (kernel.numel() + c),
                    fp32_ops=2.0 * 49 * x.numel())
    res = dw.kernel_resources(x.dtype)
    rows.append(row("depthwise_conv2d_fp32", "depthwise_conv2d.cu", "depthwise.py:53",
                    2 * tracked, err, lambda: dw.depthwise_conv2d(x, kernel, bias),
                    lambda: dw.depthwise_conv2d_plain(x, kernel, bias),
                    graph_time(lambda: F.conv2d(x_cl, w_nchw, bias.float(), padding=3, groups=c)),
                    bms, by, f"x {tuple(x.shape)} fp32, 7x7 (fp32 FMA; {res['registers']} registers, "
                    f"{res['spill_bytes']} bytes spilled, {res['smem_bytes']} B shared, "
                    f"{res['blocks_per_sm']} blocks an SM); library = fp32 F.conv2d (groups=C), "
                    f"cuDNN TF32 off", dev_e.get("depthwise_conv2d_fp32")))
    del x, got, x_cl, sessions, pred_e, st_e, cap_e, pred_q, st_q, cap_q, image_m, core
    torch.cuda.empty_cache()
    log(f"[fp32] tracker part {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- tracker clip
    # fresh modules: the inference-mode frames above leave inference tensors
    # in the core's caches, which autograd cannot save
    t0 = time.perf_counter()
    image_m, core = build_efficientsam3_video_model(model_name="b1", device=dev, seed=0)
    with torch.no_grad():  # as [tracker_train]
        for blk in core.memory_encoder.fuser:
            blk.gamma.fill_(1.0)
        core.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += 10.0
    core.train().requires_grad_(True)
    fs, d = core.feat_size, core.d_model
    feats = []
    with torch.no_grad():
        for t in range(FP32_CLIP_FRAMES):
            img = torch.as_tensor(np.random.default_rng(7 + t).standard_normal(
                (1008, 1008, 3)).astype(np.float32), device=dev)[None]
            fpn = image_m.encode_image(img)["sam2_fpn"]
            feats.append((fpn[2].reshape(1, fs * fs, d), fpn[0], fpn[1]))
    del image_m
    pos = sine_pos_embed_2d(fs, fs, d, device=dev).reshape(fs * fs, d)
    proj = torch.randn((FP32_CLIP_FRAMES, TT_SLOTS, 1, 4 * fs, 4 * fs),
                       generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    capture = Capture(
        [(fa, "flash_sdpa_bwd_dq"), (dw, "depthwise_conv2d_bwd")],
        key=lambda name, a: (name, "self" if a[0].shape[2] == a[1].shape[2] else "cross")
        if name.startswith("flash") else (name, a[0].shape[-1]),
        size=lambda name, a: int((a[3] > fa.NEG_INF / 2).sum().item()) if name.startswith("flash")
        else a[0].numel())

    def clip():
        torch.manual_seed(0)
        core.zero_grad(set_to_none=True)
        return tracker_clip(core, feats, pos, proj, TT_LIVE, compact=True)

    with capture:
        reset()
        loss, _ = clip()
        fwd = counts()
        loss.backward()
        torch.cuda.synchronize()
        total = counts()
    bwd = {k: total[k] - fwd[k] for k in total}
    n_tr = FP32_CLIP_FRAMES - 1
    expect(f"clip forward ({FP32_CLIP_FRAMES} frames)", fwd,
           {**{k: n * n_tr for k, n in TT_FWD.items()}, "depthwise_conv2d": 2 * FP32_CLIP_FRAMES})
    expect("clip backward", bwd, {**{k: n * n_tr for k, n in TT_BWD.items()},
                                  "depthwise_conv2d_bwd": 2 * (FP32_CLIP_FRAMES - 1)})
    grads = [p.grad for p in core.parameters() if p.grad is not None]
    if not (math.isfinite(loss.item()) and grads and all(torch.isfinite(g).all() for g in grads)):
        raise AssertionError("[fp32] tracker clip: non-finite loss or gradients")
    del loss, grads

    # the backward alone: its wall time and the clip's peak memory, then
    # under the profiler its device time and device ms a launch (the d=256
    # kernels with the split passes their wrappers launch just before them;
    # the depthwise backward's one kernel a call)
    torch.cuda.reset_peak_memory_stats()
    loss, _ = clip()
    torch.cuda.synchronize()
    t_bwd = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    bwd_wall_ms = (time.perf_counter() - t_bwd) * 1e3
    clip_peak = torch.cuda.max_memory_allocated() / 2**30
    core.zero_grad(set_to_none=True)
    loss, _ = clip()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss.backward()
        torch.cuda.synchronize()
    del loss
    evs = [(ev.key, ev.self_device_time_total, ev.count) for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    bwd_dev_us = sum(u for _, u, _ in evs)
    owned = charge_helpers(prof, ("flash_bwd_dq_wide_f32_kernel", "flash_bwd_dkv_wide_f32_kernel"),
                           "split_parts_kernel")
    dev_clip = {}
    for name, patterns, calls in (
            ("flash_sdpa_bwd_dq_d256_fp32", ("flash_bwd_dq_wide_f32_kernel",), 8 * n_tr),
            ("flash_sdpa_bwd_dkv_d256_fp32", ("flash_bwd_dkv_wide_f32_kernel",), 8 * n_tr),
            ("depthwise_conv2d_bwd_fp32", ("dw7_bwd_kernel<float>",), 2 * n_tr)):
        us = sum(u for key, u, _ in evs if any(pt in key for pt in patterns))
        if not us:
            raise AssertionError(f"[fp32] clip backward: no device time matches {patterns}")
        us = owned.get(patterns[0], us)  # with its split passes
        dev_clip[name] = us / 1e3 / calls
    pair_us = sum(owned.values())
    log(f"[fp32] clip backward ({FP32_CLIP_FRAMES} frames): {bwd_wall_ms:.1f} ms wall, "
        f"{bwd_dev_us / 1e3:.1f} ms of device time; the d=256 pair with its split passes "
        f"{pair_us / 1e3:.1f} ms of it ({100 * pair_us / bwd_dev_us:.1f}%); the clip's peak "
        f"memory {clip_peak:.2f} GiB | {smi}")
    del prof, evs
    core.zero_grad(set_to_none=True)
    (q, k, v, key_bias, o, lse, do, scale), _ = capture.args[("flash_sdpa_bwd_dq", "cross")]
    rows += bwd_rows_fp32(q, k, v, key_bias, o, lse, do, scale, 8 * n_tr, "_d256", dev_clip,
                          row)
    del q, k, v, o, lse, do
    (x, kernel, g), _ = capture.args[("depthwise_conv2d_bwd", 256)]
    dx, dwt, db = dw.depthwise_conv2d_bwd(x, kernel, g)
    want = dw.depthwise_conv2d_bwd_plain(x, kernel, g)
    err = check_rel("depthwise_conv2d_bwd_fp32 (dx)", dx, want[0], FP32_TOL)
    for name, got_, want_ in (("dw", dwt, want[1]), ("db", db, want[2])):
        err = max(err, check_rel(f"depthwise_conv2d_bwd_fp32 ({name})", got_, want_, FP32_TOL))
    c = x.shape[-1]
    x_cl = x.permute(0, 3, 1, 2).detach().clone().requires_grad_()
    w_l = kernel.permute(3, 2, 0, 1).float().detach().clone().requires_grad_()
    b_l = torch.zeros(c, device=dev, requires_grad=True)
    y_l = F.conv2d(x_cl, w_l, b_l, padding=3, groups=c)
    g_l = g.permute(0, 3, 1, 2)
    bms, by = bound(4 * (x.numel() + g.numel() + dx.numel()) + 4 * (kernel.numel() + c),
                    fp32_ops=4.0 * 49 * x.numel())
    res = dw.kernel_resources(x.dtype, backward=True)
    rows.append(row("depthwise_conv2d_bwd_fp32", "depthwise_conv2d.cu", "depthwise.py:84",
                    bwd["depthwise_conv2d_bwd"], err,
                    lambda: dw.depthwise_conv2d_bwd(x, kernel, g),
                    lambda: dw.depthwise_conv2d_bwd_plain(x, kernel, g),
                    cuda_time(lambda: torch.autograd.grad(y_l, (x_cl, w_l, b_l), g_l,
                                                          retain_graph=True), 10),
                    bms, by, f"x / dy {tuple(x.shape)} fp32, 7x7, one kernel ({res['registers']} "
                    f"registers, {res['spill_bytes']} bytes spilled, {res['smem_bytes']} B shared, "
                    f"{res['blocks_per_sm']} blocks an SM); library = F.conv2d (groups=C) backward",
                    dev_clip.get("depthwise_conv2d_bwd_fp32")))
    del x, g, dx, x_cl, w_l, b_l, y_l, capture, core, feats
    torch.cuda.empty_cache()
    log(f"[fp32] tracker clip part {time.perf_counter() - t0:.1f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return rows


# the [sam3] phase: the SAM3 teacher (ViTDet ViT-H trunk + CLIP text tower)
SAM3_SET_IMAGE = {"flash_sdpa": 4}  # the trunk's four global blocks, d=64
SAM3_TRACKED = 4  # tracked frames after the prompted frame 0


def sam3_phase(smi, main_ref):
    """Phase 11: the SAM3 teacher at full width. The bf16 build through
    Sam3Processor (launches per set_image and per ground counted, times,
    a profiler split of encode_image); the default (fp32) build's set_image
    and ground held against the same model on the host's CPU and set
    beside the bf16 build; the bf16 video build tracking 2 objects over
    SAM3_TRACKED frames on the cached bank. Returns the flash_sdpa d=64
    rows, bf16 and fp32, each held against its plain version."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from efficientsam3_tpu_torch.build import build_sam3_image_model, build_sam3_video_model
    from efficientsam3_tpu_torch.models import common
    from efficientsam3_tpu_torch.ops import depthwise as dw
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.ops import layer_norm as ln
    from efficientsam3_tpu_torch.processor import Sam3Processor
    from efficientsam3_tpu_torch.video.predictor import TrackerPredictor

    dev = torch.device("cuda")
    counters = {"flash_sdpa": fa, "flash_memattn": fa, "flash_memattn_q8": fa,
                "flash_xattn_rpb": fa, "layer_norm": ln, "depthwise_conv2d": dw}

    def reset():
        for name, mod in counters.items():
            getattr(mod, name).launches = 0

    def counts():
        return {name: getattr(mod, name).launches for name, mod in counters.items()}

    def expect(what, got, want):
        want = {k: want.get(k, 0) for k in counters}
        log(f"[sam3] {what}: launches {got}")
        if got != want:
            raise AssertionError(f"[sam3] {what}: launches {got}, want {want}")

    def d64_calls(capture, what):
        """The trunk's d=64 attentions all go to flash_sdpa (the warm-up's
        calls by head dim: 4 at d=64 a set_image, 6 at d=32 a ground)."""
        calls = {d: n for (name, d), n in capture.calls.items() if name == "flash_sdpa"}
        log(f"[sam3] {what}: flash_sdpa calls by head dim {calls}")
        if calls != {64: 4, 32: 6}:
            raise AssertionError(f"[sam3] {what}: flash_sdpa calls by head dim {calls}")

    image, tokens, box = main_ref["image"], main_ref["tokens"], main_ref["box"]
    rows = []

    def ground_call(proc, state):
        state["text"] = proc.encode_tokens(tokens)
        return proc.add_geometric_prompt(box, True, state)

    def d64_row(name, tol, q, k, v, key_bias, scale, launches, device_ms, fp32):
        got, lse = fa.flash_sdpa(q, k, v, key_bias, scale, return_lse=True)
        want, want_lse = fa.flash_sdpa_plain(q, k, v, key_bias, scale, return_lse=True)
        err = max(check(name, got, want, tol), check(f"{name} lse", lse, want_lse, tol))
        del got, lse, want, want_lse
        b, h, lq, d = q.shape
        live = int((key_bias > fa.NEG_INF / 2).sum().item()) * h * lq  # scores, over the batch
        if fp32:
            bms, by = attn_bound(q.numel(), live, d, kv_elems=k.numel() + v.numel())
        else:
            nb = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * key_bias.numel()
            bms, by = bound(nb, 4.0 * live * d, 1.0 * live, 6.0 * live)
        fn = lambda: fa.flash_sdpa(q, k, v, key_bias, scale)  # noqa: E731
        kernel = fa.sdpa_kernel(q.dtype, d)
        res = fa.kernel_resources(kernel, d, k.shape[2])
        r = dict(name=name, route="cuda",
                 source=f"efficientsam3_tpu_torch/csrc/{kernel}.cu",
                 replaces="efficientsam3_tpu/ops/pallas/flash_attention.py:304",
                 launches=launches, max_abs_err=err, ms=graph_time(fn, 5, 10),
                 call_ms=cuda_time(fn, 10),
                 plain_ms=cuda_time(lambda: fa.flash_sdpa_plain(q, k, v, key_bias, scale), 3,
                                    warmup=1),
                 bound_ms=bms, bound_by=by,
                 library_ms=graph_time(
                     lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 5, 10),
                 device_ms=device_ms,
                 shape=f"q/k/v {tuple(q.shape)} {str(q.dtype)[6:]} (v a strided view of the "
                       f"packed qkv), wgmma + TMA{', split bf16 products' if fp32 else ''}; "
                       f"{res['registers']} registers, {res['spill_bytes']} bytes spilled, "
                       f"{res['smem_bytes']} B shared, {res['blocks_per_sm']} blocks an SM; "
                       f"library = {'fp32 ' if fp32 else ''}SDPA", **{"pass": True})
        log_row(r, smi)
        return r

    def encode_profile(model, img, what, pattern, wall_ms):
        """torch.profiler split of one encode_image (wall_ms long between
        CUDA events); device ms a d=64 launch."""
        kernels, n_launch, total_us = profile_kernels(lambda: model.encode_image(img))
        if total_us == 0:
            log(f"[profile] {what}: the profiler recorded no device time: not measured")
            return None
        busy = total_us / 1e3 / wall_ms
        log(f"[profile] {what}: {n_launch} kernel launches, {total_us / 1e3:.3f} ms of device "
            f"time in a {wall_ms:.3f} ms call: device busy {busy:.1%}, idle {1 - busy:.1%}")
        for name, us, n in kernels[:10]:
            log(f"[profile] {what}:   {us / 1e3:8.4f} ms  x{n:<4d} {name[:90]}")
        write_out(f"profile_{what.replace(' ', '_')}.txt",
                  "\n".join(f"{us:12.2f} us  x{n:<5d} {name}" for name, us, n in kernels))
        us = sum(u for name, u, _ in kernels if pattern in name)
        return us / 1e3 / SAM3_SET_IMAGE["flash_sdpa"] if us else None

    # ---------------------------------------------------------------- bf16 image path
    t0 = time.perf_counter()
    model = build_sam3_image_model(text_encoder_context_length=32, dtype=torch.bfloat16,
                                   device=dev, seed=0)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    proc = Sam3Processor(model, resolution=1008, context_length=32)
    capture = Capture([(common, "flash_sdpa")])
    with capture:  # warm-up: cuBLAS and cuDNN plans, captured inputs
        ground_call(proc, proc.set_image(image))
    torch.cuda.synchronize()
    d64_calls(capture, "bf16 warm-up")
    reset()
    state = proc.set_image(image)
    torch.cuda.synchronize()
    expect("per set_image (bf16)", counts(), SAM3_SET_IMAGE)
    reset()
    state = ground_call(proc, state)
    torch.cuda.synchronize()
    expect("per encode_text + ground (bf16)", counts(), MAIN_COUNTS)
    h0, w0 = image.shape[:2]
    if state["masks"].shape[1:] != (h0, w0):
        raise AssertionError(f"[sam3] masks {state['masks'].shape} not at {h0}x{w0}")
    for key in ("scores", "boxes", "masks_logits"):
        if not np.isfinite(state[key]).all():
            raise AssertionError(f"[sam3] non-finite {key}")
    img = proc.preprocess(image)
    tm, tmask = state["text"]
    prompt = state["geometric_prompt"]
    with torch.inference_mode():
        set_ms = cuda_time(lambda: proc.set_image(image), 5, warmup=1)
        enc_ms = cuda_time(lambda: model.encode_image(img), 5, warmup=1)
        text_ms = cuda_time(lambda: proc.encode_tokens(tokens), 10)
        feats = model.encode_image(img)
        ground = lambda: model.ground(feats["fpn"], feats["pos"], tm, tmask, prompt)  # noqa: E731
        ground_ms = cuda_time(ground, 10)
        res = ground()
        b16 = {k: res[k].float().cpu() for k in GROUND_KEYS}
    whole_ms = cuda_time(lambda: ground_call(proc, proc.set_image(image)), 5, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    ground_call(proc, proc.set_image(image))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[sam3] bf16 teacher ({n_params / 1e6:.1f} M parameters, built in {build_s:.1f} s): "
        f"set_image {set_ms:.3f} ms (encode_image {enc_ms:.3f}) | encode_text (context 32, "
        f"once) {text_ms:.3f} ms | ground {ground_ms:.3f} ms | whole call (set_image + encode "
        f"text + add_geometric_prompt) {whole_ms:.3f} ms | peak memory {peak:.2f} GiB | kept "
        f"{len(state['scores'])} of 200 queries | {smi}")
    dev_b16 = encode_profile(model, img, "sam3 encode_image", "flash_sdpa_h_kernel<64>", enc_ms)
    (q, k, v, key_bias, scale), _ = capture.args[("flash_sdpa", 64)]
    del capture, feats, state, proc, model, res
    torch.cuda.empty_cache()
    rows.append(d64_row("flash_sdpa_d64", ATOL, q, k, v, key_bias, scale,
                        SAM3_SET_IMAGE["flash_sdpa"], dev_b16, False))
    del q, k, v, key_bias
    torch.cuda.empty_cache()
    log(f"[sam3] bf16 image part {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- fp32 default build
    t0 = time.perf_counter()
    model = build_sam3_image_model(text_encoder_context_length=32, device=dev, seed=0)
    if {p.dtype for p in model.parameters()} != {torch.float32}:
        raise AssertionError("[sam3] the default build is not fp32")
    proc = Sam3Processor(model, resolution=1008, context_length=32)
    capture = Capture([(common, "flash_sdpa")])
    with capture:
        ground_call(proc, proc.set_image(image))
    torch.cuda.synchronize()
    d64_calls(capture, "fp32 warm-up")
    reset()
    state = proc.set_image(image)
    torch.cuda.synchronize()
    expect("per set_image (fp32)", counts(), SAM3_SET_IMAGE)
    reset()
    state = ground_call(proc, state)
    torch.cuda.synchronize()
    expect("per encode_text + ground (fp32)", counts(), MAIN_COUNTS)
    img = proc.preprocess(image)
    prompt = state["geometric_prompt"]
    with torch.inference_mode():
        set_ms = cuda_time(lambda: proc.set_image(image), 3, warmup=1)
        enc_ms = cuda_time(lambda: model.encode_image(img), 3, warmup=1)
        feats = model.encode_image(img)
        tm, tmask = state["text"]
        ground_ms = cuda_time(lambda: model.ground(feats["fpn"], feats["pos"], tm, tmask,
                                                   prompt), 5)
        res = model.ground(feats["fpn"], feats["pos"], tm, tmask, prompt)
        out = {k: res[k].float().cpu() for k in GROUND_KEYS}
    log(f"[sam3] fp32 teacher: set_image {set_ms:.3f} ms (encode_image {enc_ms:.3f}) | ground "
        f"{ground_ms:.3f} ms | {smi}")
    dev_f32 = encode_profile(model, img, "sam3 fp32 encode_image",
                             "flash_sdpa_h_f32_kernel<64>", enc_ms)

    # the same model in fp32 on the host's CPU (the plain versions), text included
    cpu_model = build_sam3_image_model(text_encoder_context_length=32, device="meta")
    cpu_model = cpu_model.to_empty(device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    t_cpu = time.perf_counter()
    with torch.inference_mode():
        cf = cpu_model.encode_image(img.cpu())
        ctm, ctmask = cpu_model.encode_text(torch.as_tensor(tokens))
        ref = cpu_model.ground(cf["fpn"], cf["pos"], ctm, ctmask, prompt.to("cpu"))
    cpu_s = time.perf_counter() - t_cpu
    errs = {}
    for key in GROUND_KEYS:
        want = ref[key].float()
        errs[key] = (out[key] - want).abs().max().item() / max(1.0, want.abs().max().item())
    log(f"[sam3] fp32 set_image + ground on the card vs the CPU (plain versions, {cpu_s:.1f} s), "
        f"max abs err over max(1, |largest|): { {k: f'{v:.2e}' for k, v in errs.items()} } "
        f"(bound 1e-2)")
    if not all(e <= 1e-2 for e in errs.values()):
        raise AssertionError(f"[sam3] fp32 teacher on the card drifts from the CPU: {errs}")
    del cpu_model, cf, ref, ctm, ctmask

    # the bf16 build against this fp32 reference
    s32 = torch.sigmoid(out["pred_logits"][0, :, 0])
    s16 = torch.sigmoid(b16["pred_logits"][0, :, 0])
    l32, l16 = out["pred_masks"][0], b16["pred_masks"][0]
    m32, m16 = l32 > 0, l16 > 0
    union = (m32 | m16).flatten(1).sum(1).float()
    iou = (m32 & m16).flatten(1).sum(1).float()[union > 0] / union[union > 0]
    top = len(set(torch.topk(s32, 10).indices.tolist()) & set(torch.topk(s16, 10).indices.tolist()))
    log(f"[sam3] bf16 build vs fp32 build, ground on the same image and prompt (200 queries): "
        f"scores max abs diff {(s32 - s16).abs().max().item():.4f}; boxes max abs diff "
        f"{(out['pred_boxes'] - b16['pred_boxes']).abs().max().item():.4f}; mask logits max abs "
        f"diff {(l32 - l16).abs().max().item():.4f} of {l32.abs().max().item():.4f}, signs agree "
        f"on {(m32 == m16).float().mean().item():.4%} of pixels; mask IoU over the {len(iou)} "
        f"non-empty pairs: mean {iou.mean().item() if len(iou) else float('nan'):.4f}; top-10 "
        f"queries shared {top} of 10")
    (q, k, v, key_bias, scale), _ = capture.args[("flash_sdpa", 64)]
    del capture, feats, state, proc, model, res
    torch.cuda.empty_cache()
    rows.append(d64_row("flash_sdpa_d64_fp32", FP32_TOL, q, k, v, key_bias, scale,
                        SAM3_SET_IMAGE["flash_sdpa"], dev_f32, True))
    del q, k, v, key_bias
    torch.cuda.empty_cache()
    log(f"[sam3] fp32 image part {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- video
    t0 = time.perf_counter()
    image_m, core = build_sam3_video_model(text_encoder_context_length=32, dtype=torch.bfloat16,
                                           device=dev, seed=0)
    frames = np.random.default_rng(7).standard_normal(
        (SAM3_TRACKED + 1, 1008, 1008, 3)).astype(np.float32)
    pred = TrackerPredictor(core, image_m.encode_image, obj_slots=8)
    st = pred.init_state(frames)
    for obj_id, kw in ((1, dict(box=[100, 150, 400, 520])),
                       (2, dict(points=[[700, 300]], labels=[1]))):
        pred.add_new_points_or_box(st, 0, obj_id, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    capture = Capture([(common, "flash_sdpa")])
    reset()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    with capture:
        outs = [m.float() for _, _, m in pred.propagate_in_video(st)]
    e1.record()
    e1.synchronize()
    prop_ms = e0.elapsed_time(e1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: n * SAM3_TRACKED for k, n in VIDEO_COUNTS["A"].items()}
    want["flash_sdpa"] += SAM3_SET_IMAGE["flash_sdpa"] * SAM3_TRACKED  # each frame's encode
    expect(f"{SAM3_TRACKED} tracked frames (cached bank)", counts(), want)
    calls = {d: n for (_, d), n in capture.calls.items()}
    if calls != {64: 4 * SAM3_TRACKED, 256: 4 * SAM3_TRACKED}:
        raise AssertionError(f"[sam3] video: flash_sdpa calls by head dim {calls}")
    if "kv_bank" not in st:
        raise AssertionError("[sam3] the session did not build the cached bank")
    for m in outs:
        if tuple(m.shape) != (2, 1, 288, 288) or not torch.isfinite(m).all():
            raise AssertionError(f"[sam3] tracker masks {tuple(m.shape)} or non-finite")

    def track_frame():  # the tracker step again at the last frame, its features cached
        with torch.inference_mode():
            return pred._run_track_frame(st, SAM3_TRACKED)

    step_ms = cuda_time(track_frame, 3, warmup=1)
    img = torch.as_tensor(frames[0], device=dev)[None]
    with torch.inference_mode():
        enc_ms = cuda_time(lambda: image_m.encode_image(img), 3, warmup=1)
    log(f"[sam3] video: {SAM3_TRACKED} tracked frames (2 objects, 8 slots) in {prop_ms:.3f} ms, "
        f"{prop_ms / SAM3_TRACKED:.3f} ms a frame with its encode (frame encode {enc_ms:.3f} ms, "
        f"tracker step {step_ms:.3f} ms); masks finite; peak memory {peak:.2f} GiB | {smi}")
    del pred, st, outs, capture, image_m, core
    torch.cuda.empty_cache()
    log(f"[sam3] video part {time.perf_counter() - t0:.1f} s")
    return rows


# the [sam1] phase: the SAM1 students (student_sam.sam_model_registry) through
# SamStudentPredictor, and automatic mask generation over the EV-M tracker
SAM1_SET_IMAGE = {"flash_sdpa": 4}  # a ViT student's four global blocks
SAM1_CNN = ("edge_sam", "tinyvit", "efficientvit")
SAM1_VIT_SIZE = 1120  # 70x70 tokens: the nearest size above 1024 the 14-token windows split
SAM1_POINTS = ([[200.0, 150.0], [420.0, 300.0], [650.0, 480.0]], [1, 1, 0])  # xy, labels
SAM1_BOX = [150.0, 120.0, 560.0, 470.0]
# automatic mask generation over the seeded EV-M tracker (amg_predictor) on
# amg_image's scene, with one crop layer (four overlapping crops at 16x16
# points each): the IoU threshold lowered below the seeded IoU head's
# predictions; at least AMG_MIN_RECORDS records after NMS; the fp32 build on
# the card held against the CPU at AMG_CHECK_SIDE^2 points
AMG_KW = dict(points_per_side=32, points_per_batch=64, pred_iou_thresh=0.6,
              stability_score_thresh=0.9, crop_n_layers=1, crop_n_points_downscale_factor=2)
AMG_MIN_RECORDS = 3
AMG_CHECK_SIDE = 12


def amg_image(h, w, seed=3):
    """(h, w, 3) uint8: a flat background and, in each corner, a rectangle
    and an ellipse of flat colours, made from seed. Each corner's shapes lie
    inside one crop of the first crop layer and more than the edge margin
    from its inner sides, so a mask of those shapes survives that crop's
    edge test with a box of its own."""
    import numpy as np

    rng = np.random.default_rng(seed)
    img = np.empty((h, w, 3), np.uint8)
    img[:] = rng.integers(0, 256, 3)
    yy, xx = np.mgrid[:h, :w]
    zw, zh = int(0.29 * w), int(0.23 * h)  # corner zones of 232 x 138 at 800 x 600
    for x0 in (30, w - 30 - zw):
        for y0 in (30, h - 30 - zh):
            for ellipse in (False, True):
                ry, rx = rng.integers(zh // 6, zh // 2), rng.integers(zw // 6, zw // 2)
                cy, cx = rng.integers(y0 + ry, y0 + zh - ry + 1), rng.integers(x0 + rx,
                                                                               x0 + zw - rx + 1)
                if ellipse:
                    region = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
                else:
                    region = (abs(yy - cy) <= ry) & (abs(xx - cx) <= rx)
                img[region] = rng.integers(0, 256, 3)
    return img


def amg_models(dtype, dev):
    """The EV-M image model and tracker (build_efficientsam3_video_model,
    1008^2, seed 0) with the CPU test's two changes to the seeded heads: the
    object-score head's last bias + 10 (else every mask is "no object", as
    in [pcs]) and the hypernetworks' last layers x 30 (mask logits of tens,
    beyond the stability offset of 1)."""
    import torch

    from efficientsam3_tpu_torch.build import build_efficientsam3_video_model

    image_m, core = build_efficientsam3_video_model(text_encoder_context_length=32, dtype=dtype,
                                                    device=dev, seed=0)
    dec = core.sam_mask_decoder
    with torch.no_grad():
        dec.pred_obj_score_head.layers[-1].bias += 10.0
        for mlp in dec.output_hypernetworks_mlps:
            mlp.layers[-1].weight.mul_(30.0)
    return image_m, core


def amg_predictor(image_m, core):
    """sam1_task.InteractiveImagePredictor over the system's encode_frame,
    with a seeded projection (x 3) of the frame's pixels, pooled to the
    finest SAM2-neck level, added to that level, as the CPU test's frame
    encoder adds one. Without it the seeded neck's features (about 1e-3)
    carry no trace of the image: every mask is the same blocky pattern,
    its box the whole image, and per-crop NMS leaves one record."""
    import torch
    import torch.nn.functional as F

    from efficientsam3_tpu_torch.sam1_task import InteractiveImagePredictor
    from efficientsam3_tpu_torch.system import EfficientSam3System

    system = EfficientSam3System(image_m, core)
    proj = 3.0 * torch.randn(3, core.d_model, generator=torch.Generator().manual_seed(5))

    def encode(img):
        fpn = list(system.encode_frame(img)["sam2_fpn"])
        h, w = fpn[0].shape[1:3]
        pix = F.adaptive_avg_pool2d(img.permute(0, 3, 1, 2).float(), (h, w)).permute(0, 2, 3, 1)
        fpn[0] = fpn[0] + (pix @ proj.to(pix.device)).to(fpn[0].dtype)
        return {"sam2_fpn": fpn}

    return InteractiveImagePredictor(core, encode)


def amg_agree(got, want, least):
    """Records of one AutomaticMaskGenerator on the card (got) and on the
    CPU (want): equal in count (at least ``least``), each CPU record
    matched to the card record with its point and the nearest predicted
    IoU; crop boxes equal, masks differing on at most 0.5% of the area
    (pixels whose logit lies within rounding of 0), boxes within 1 px,
    predicted IoU within 1e-4 and stability within 2e-2 (a pixel count at
    the offset may flip). Raises, else returns the worst of each."""
    import numpy as np

    from efficientsam3_tpu_torch.eval.coco_format import rle_to_mask

    if len(got) != len(want) or len(want) < least:
        raise AssertionError(f"[sam1] AMG: {len(got)} records on the card, {len(want)} on the "
                             f"CPU (at least {least})")
    worst = dict(mask=0.0, box=0.0, iou=0.0, stability=0.0)
    free = list(range(len(got)))
    for w in want:
        same = [i for i in free if np.allclose(got[i]["point_coords"], w["point_coords"],
                                               atol=1e-3)]
        if not same:
            raise AssertionError(f"[sam1] AMG: no card record at the CPU's point "
                                 f"{w['point_coords']}")
        i = min(same, key=lambda j: abs(got[j]["predicted_iou"] - w["predicted_iou"]))
        free.remove(i)
        g = got[i]
        wm = rle_to_mask(w["segmentation"])
        diffs = dict(mask=float((rle_to_mask(g["segmentation"]) != wm).sum()) / w["area"],
                     box=float(np.abs(np.subtract(g["bbox"], w["bbox"])).max()),
                     iou=abs(g["predicted_iou"] - w["predicted_iou"]),
                     stability=abs(g["stability_score"] - w["stability_score"]))
        bounds = dict(mask=5e-3, box=1.0, iou=1e-4, stability=2e-2)
        if g["crop_box"] != w["crop_box"] or any(diffs[k] > bounds[k] for k in bounds):
            raise AssertionError(f"[sam1] AMG record at {w['point_coords']} differs from the "
                                 f"CPU's: {diffs} (bounds {bounds}), crop boxes "
                                 f"{g['crop_box']} / {w['crop_box']}")
        worst = {k: max(worst[k], diffs[k]) for k in worst}
    return worst


def sam1_phase(smi, main_ref):
    """Phase 12: the SAM1 students at full width in bf16 through
    SamStudentPredictor (set_image + predict with 3 points, and with a box):
    EdgeSAM (RepViT-M1.1), TinyViT-5M and EfficientViT-b1 at 1024^2 (no
    kernel on their paths); vit_h and vit_b at 1120^2 (flash_sdpa 4
    launches a set_image, at d=80 and d=64); vit_h at the registry's
    1024^2 raising. The default (fp32) build of vit_h cut to 4 blocks (one
    global) held against the same model on the host's CPU. The d=80 rows,
    bf16 and fp32, each held against the plain version; vit_b's d=64
    launches likewise. Automatic mask generation over the EV-M tracker's
    interactive predictor (bf16, 1008^2) on amg_image's scene: records, ms
    an image; the fp32 build's records held against a CPU copy's."""
    import copy

    import numpy as np
    import torch
    import torch.nn.functional as F

    from efficientsam3_tpu_torch.automatic_mask_generator import AutomaticMaskGenerator
    from efficientsam3_tpu_torch.build import init_parameters
    from efficientsam3_tpu_torch.eval.coco_format import rle_to_mask
    from efficientsam3_tpu_torch.models import common
    from efficientsam3_tpu_torch.models.vitdet import ViTTrunk
    from efficientsam3_tpu_torch.ops import depthwise as dw
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.ops import layer_norm as ln
    from efficientsam3_tpu_torch.student_sam import (
        SamStudentModel,
        SamStudentPredictor,
        sam_model_registry,
    )

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    counters = {"flash_sdpa": fa, "flash_memattn": fa, "flash_memattn_q8": fa,
                "flash_xattn_rpb": fa, "layer_norm": ln, "depthwise_conv2d": dw}

    def reset():
        for name, mod in counters.items():
            getattr(mod, name).launches = 0

    def counts():
        return {name: getattr(mod, name).launches for name, mod in counters.items()}

    def expect(what, got, want):
        want = {k: want.get(k, 0) for k in counters}
        log(f"[sam1] {what}: launches {got}")
        if got != want:
            raise AssertionError(f"[sam1] {what}: launches {got}, want {want}")

    image = main_ref["image"]
    h0, w0 = image.shape[:2]
    points, labels = (np.array(a) for a in SAM1_POINTS)
    box = np.array(SAM1_BOX)

    def predict_both(pred):
        return (pred.predict(point_coords=points, point_labels=labels),
                pred.predict(box=box, multimask_output=False))

    def drive(pred, what, build_s, n_params):
        """One set_image and the two prompts: shapes, finite values, times."""
        pred.set_image(image)
        (m3, i3, l3), (m1, i1, l1) = predict_both(pred)
        side = pred.model.embed_size * 4
        for m, i, lo, n in ((m3, i3, l3, 3), (m1, i1, l1, 1)):
            if m.shape != (n, h0, w0) or m.dtype != bool or lo.shape != (n, side, side):
                raise AssertionError(f"[sam1] {what}: masks {m.shape} low {lo.shape}")
            if not (np.isfinite(i).all() and np.isfinite(lo).all()):
                raise AssertionError(f"[sam1] {what}: non-finite outputs")
        set_ms = cuda_time(lambda: pred.set_image(image), 5, warmup=1)
        pt_ms = cuda_time(lambda: pred.predict(point_coords=points, point_labels=labels), 10)
        box_ms = cuda_time(lambda: pred.predict(box=box, multimask_output=False), 10)
        torch.cuda.reset_peak_memory_stats()
        pred.set_image(image)
        predict_both(pred)
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy = []  # torch.profiler's device time of one call over its CUDA-event time
        for stage, fn, ms in (("set_image", lambda: pred.set_image(image), set_ms),
                              ("predict 3 points", lambda: pred.predict(
                                  point_coords=points, point_labels=labels), pt_ms)):
            _, n_launch, us = profile_kernels(fn)
            busy.append(f"{stage} {n_launch} launches, {us / 1e3:.3f} ms device, busy "
                        f"{us / 1e3 / ms:.1%}" if us else f"{stage} not measured")
        log(f"[sam1] {what} ({n_params / 1e6:.1f} M parameters, built in {build_s:.1f} s): "
            f"set_image {set_ms:.3f} ms | predict 3 points {pt_ms:.3f} ms | predict box "
            f"{box_ms:.3f} ms | peak memory {peak:.2f} GiB | IoU predictions (points) "
            f"{np.round(i3, 4).tolist()} | {smi}")
        log(f"[profile] {what}: {'; '.join(busy)}")

    def d80_row(name, tol, q, k, v, key_bias, scale, launches, device_ms, fp32):
        got, lse = fa.flash_sdpa(q, k, v, key_bias, scale, return_lse=True)
        want, want_lse = fa.flash_sdpa_plain(q, k, v, key_bias, scale, return_lse=True)
        err = max(check(name, got, want, tol), check(f"{name} lse", lse, want_lse, tol))
        del got, lse, want, want_lse
        b, h, lq, d = q.shape
        live = int((key_bias > fa.NEG_INF / 2).sum().item()) * h * lq  # scores, over the batch
        if fp32:
            bms, by = attn_bound(q.numel(), live, d, kv_elems=k.numel() + v.numel())
        else:
            nb = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * key_bias.numel()
            bms, by = bound(nb, 4.0 * live * d, 1.0 * live, 6.0 * live)
        kernel = fa.sdpa_kernel(q.dtype, d)
        res = fa.kernel_resources(kernel, d, k.shape[2])
        fn = lambda: fa.flash_sdpa(q, k, v, key_bias, scale)  # noqa: E731
        r = dict(name=name, route="cuda",
                 source=f"efficientsam3_tpu_torch/csrc/{kernel}.cu",
                 replaces="efficientsam3_tpu/ops/pallas/flash_attention.py:144",
                 launches=launches, max_abs_err=err, ms=graph_time(fn, 5, 10),
                 call_ms=cuda_time(fn, 10),
                 plain_ms=cuda_time(lambda: fa.flash_sdpa_plain(q, k, v, key_bias, scale), 3,
                                    warmup=1),
                 bound_ms=bms, bound_by=by,
                 library_ms=graph_time(
                     lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 5, 10),
                 device_ms=device_ms,
                 shape=f"q/k/v {tuple(q.shape)} {str(q.dtype)[6:]} (v a strided view of the "
                       f"packed qkv), "
                       f"wgmma + TMA, 32-byte slabs{', split bf16 products' if fp32 else ''}"
                       f"; {res['registers']} registers, {res['spill_bytes']} bytes spilled, "
                       f"{res['smem_bytes']} B shared, "
                       f"{res['blocks_per_sm']} blocks an SM; library = "
                       f"{'fp32 ' if fp32 else ''}SDPA", **{"pass": True})
        log_row(r, smi)
        return r

    def encode_dev_ms(model, what, pattern, launches):
        """torch.profiler split of one encode_image at 1120^2; device ms a
        launch of the kernels matching pattern."""
        img = torch.zeros((1, SAM1_VIT_SIZE, SAM1_VIT_SIZE, 3), device=dev)
        with torch.inference_mode():
            enc_ms = cuda_time(lambda: model.encode_image(img), 5, warmup=1)
        kernels, n_launch, total_us = profile_kernels(lambda: model.encode_image(img))
        if not total_us:
            log(f"[profile] {what}: the profiler recorded no device time: not measured")
            return None
        busy = total_us / 1e3 / enc_ms
        log(f"[profile] {what}: {n_launch} kernel launches, {total_us / 1e3:.3f} ms of device "
            f"time in a {enc_ms:.3f} ms call: device busy {busy:.1%}, idle {1 - busy:.1%}")
        for name, u, n in kernels[:10]:
            log(f"[profile] {what}:   {u / 1e3:8.4f} ms  x{n:<4d} {name[:90]}")
        write_out(f"profile_{what.replace(' ', '_')}.txt",
                  "\n".join(f"{u:12.2f} us  x{n:<5d} {name}" for name, u, n in kernels))
        us = sum(u for name, u, _ in kernels if pattern in name)
        return us / 1e3 / launches if us else None

    rows = []
    # ---------------------------------------------------------------- CNN students
    t0 = time.perf_counter()
    for key in SAM1_CNN:
        tb = time.perf_counter()
        model = sam_model_registry[key](dtype=bf16, device=dev)
        build_s = time.perf_counter() - tb
        pred = SamStudentPredictor(model)
        pred.set_image(image)  # warm-up: cuDNN plans
        predict_both(pred)
        torch.cuda.synchronize()
        reset()
        pred.set_image(image)
        predict_both(pred)
        torch.cuda.synchronize()
        expect(f"{key} set_image + 2 predicts", counts(), {})
        drive(pred, f"{key} bf16 1024^2", build_s, sum(p.numel() for p in model.parameters()))
        del model, pred
        torch.cuda.empty_cache()
    log(f"[sam1] CNN students part {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- ViT students
    captured = {}
    for key, d in (("vit_h", 80), ("vit_b", 64)):
        t0 = time.perf_counter()
        reg = sam_model_registry[key](dtype=bf16, device=dev)  # the registry's 1024^2
        build_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in reg.parameters())
        try:
            SamStudentPredictor(reg).set_image(image)
        except ValueError as e:
            log(f"[sam1] {key} at the registry's 1024^2 raises, as the JAX trunk asserts: {e}")
        else:
            raise AssertionError(f"[sam1] {key} at 1024^2 did not raise")
        # the same weights at 1120^2: the registry's trunk under heads for the larger input
        model = SamStudentModel(trunk=reg.trunk, image_size=SAM1_VIT_SIZE, dtype=bf16)
        model.load_state_dict(reg.state_dict())
        model = model.requires_grad_(False).eval().to(dev)
        del reg
        pred = SamStudentPredictor(model)
        capture = Capture([(common, "flash_sdpa")])
        with capture:  # warm-up
            pred.set_image(image)
            predict_both(pred)
        torch.cuda.synchronize()
        calls = {dd: n for (_, dd), n in capture.calls.items()}
        log(f"[sam1] {key} warm-up: flash_sdpa calls by head dim {calls}")
        if calls != {d: 4}:
            raise AssertionError(f"[sam1] {key}: flash_sdpa calls by head dim {calls}")
        reset()
        pred.set_image(image)
        torch.cuda.synchronize()
        expect(f"{key} per set_image", counts(), SAM1_SET_IMAGE)
        reset()
        predict_both(pred)
        torch.cuda.synchronize()
        expect(f"{key} per 2 predicts", counts(), {})
        drive(pred, f"{key} bf16 {SAM1_VIT_SIZE}^2", build_s, n_params)
        if key == "vit_h":
            captured["dev"] = encode_dev_ms(model, "vit_h encode_image",
                                            "flash_sdpa_h_kernel<80>", SAM1_SET_IMAGE["flash_sdpa"])
            captured["bf16"] = capture.args[("flash_sdpa", 80)][0]
        else:  # the wgmma d=64 kernel at vit_b's own inputs: 12 heads, a 36-row / 36-key tail
            q, k, v, key_bias, scale = capture.args[("flash_sdpa", 64)][0]
            got, lse = fa.flash_sdpa(q, k, v, key_bias, scale, return_lse=True)
            want, want_lse = fa.flash_sdpa_plain(q, k, v, key_bias, scale, return_lse=True)
            check(f"flash_sdpa_d64 at vit_b's {tuple(q.shape)}", got, want)
            check(f"flash_sdpa_d64 lse at vit_b's {tuple(q.shape)}", lse, want_lse)
            del q, k, v, key_bias, got, lse, want, want_lse
        del model, pred, capture
        torch.cuda.empty_cache()
        log(f"[sam1] {key} part {time.perf_counter() - t0:.1f} s")
    q, k, v, key_bias, scale = captured.pop("bf16")
    rows.append(d80_row("flash_sdpa_d80", ATOL, q, k, v, key_bias, scale,
                        SAM1_SET_IMAGE["flash_sdpa"], captured["dev"], False))
    del q, k, v, key_bias
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- fp32 vit_h cut
    t0 = time.perf_counter()
    trunk = ViTTrunk(patch_size=16, embed_dim=1280, depth=4, num_heads=16, mlp_ratio=4.0,
                     window_size=14, global_att_blocks=(3,), pretrain_grid=64)
    cpu_model = init_parameters(SamStudentModel(trunk, image_size=SAM1_VIT_SIZE), 0).eval()
    cpu_model.requires_grad_(False)
    model = copy.deepcopy(cpu_model).to(dev)
    pred = SamStudentPredictor(model)
    capture = Capture([(common, "flash_sdpa")])
    with capture:
        pred.set_image(image)
    torch.cuda.synchronize()
    reset()
    pred.set_image(image)
    (m3, i3, l3), _ = predict_both(pred)
    torch.cuda.synchronize()
    expect("fp32 vit_h cut (4 blocks, 1 global) set_image + 2 predicts", counts(),
           {"flash_sdpa": 1})
    set_ms = cuda_time(lambda: pred.set_image(image), 3, warmup=1)
    dev_f32 = encode_dev_ms(model, "vit_h cut fp32 encode_image",
                            "flash_sdpa_h_f32_kernel<80>", 1)
    cpu_pred = SamStudentPredictor(cpu_model)
    t_cpu = time.perf_counter()
    cpu_pred.set_image(image)
    (cm3, ci3, cl3), _ = predict_both(cpu_pred)
    cpu_s = time.perf_counter() - t_cpu
    errs = {}
    for what, got, want in (("embedding", pred._emb.float().cpu(), cpu_pred._emb),
                            ("low-res masks", torch.from_numpy(l3), torch.from_numpy(cl3)),
                            ("IoU predictions", torch.from_numpy(i3), torch.from_numpy(ci3))):
        errs[what] = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
    log(f"[sam1] fp32 vit_h cut on the card vs the CPU (plain versions, {cpu_s:.1f} s): "
        f"set_image {set_ms:.3f} ms on the card; max abs err over max(1, |largest|) "
        f"{ {k_: f'{v_:.2e}' for k_, v_ in errs.items()} } (bound 1e-3) | {smi}")
    if not all(e <= 1e-3 for e in errs.values()):
        raise AssertionError(f"[sam1] fp32 vit_h cut on the card drifts from the CPU: {errs}")
    (q, k, v, key_bias, scale), _ = capture.args[("flash_sdpa", 80)]
    del capture, pred, cpu_pred, model, cpu_model
    torch.cuda.empty_cache()
    rows.append(d80_row("flash_sdpa_d80_fp32", FP32_TOL, q, k, v, key_bias, scale, 1, dev_f32,
                        True))
    del q, k, v, key_bias
    torch.cuda.empty_cache()
    log(f"[sam1] fp32 part {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- AMG
    t0 = time.perf_counter()
    scene = amg_image(h0, w0)
    image_m, core = amg_models(bf16, dev)
    amg = AutomaticMaskGenerator(amg_predictor(image_m, core), **AMG_KW)
    amg.generate(scene)  # warm-up
    torch.cuda.synchronize()
    reset()
    t1 = time.perf_counter()
    records = amg.generate(scene)
    torch.cuda.synchronize()
    amg_ms = (time.perf_counter() - t1) * 1e3
    n_points = sum(len(g) * 4 ** i for i, g in enumerate(amg.point_grids))
    expect(f"one generate ({n_points} points)", counts(), {})
    if len(records) < AMG_MIN_RECORDS:
        raise AssertionError(f"[sam1] automatic mask generation left {len(records)} records, "
                             f"want at least {AMG_MIN_RECORDS}")
    for rec in records:
        m = rle_to_mask(rec["segmentation"])
        x, y, bw, bh = rec["bbox"]
        if m.shape != (h0, w0) or int(m.sum()) != rec["area"] or not (
                0 <= x and 0 <= y and x + bw <= w0 and y + bh <= h0):
            raise AssertionError(f"[sam1] AMG record inconsistent: area {rec['area']} "
                                 f"bbox {rec['bbox']}")
    amg_ms2 = cuda_time(lambda: amg.generate(scene), 2, warmup=0)
    n_crops = len({tuple(r["crop_box"]) for r in records})
    log(f"[sam1] AMG over the EV-M tracker (bf16, 1008^2) on the {h0}x{w0} scene, {AMG_KW}, "
        f"{n_points} points: {len(records)} records from {n_crops} crops (areas "
        f"{[r['area'] for r in records][:12]}), {amg_ms:.1f} ms an image (again: "
        f"{amg_ms2:.1f}) | {smi}")
    del amg, image_m, core
    torch.cuda.empty_cache()

    # the default (fp32) build's records on the card against a copy of the
    # same predictor on the host's CPU (plain versions)
    kw = dict(AMG_KW, points_per_side=AMG_CHECK_SIDE)
    image_m, core = amg_models(None, dev)
    got = AutomaticMaskGenerator(amg_predictor(image_m, core), **kw).generate(scene)
    cpu_m, cpu_core = copy.deepcopy(image_m).cpu(), copy.deepcopy(core).cpu()
    del image_m, core
    torch.cuda.empty_cache()
    t_cpu = time.perf_counter()
    want = AutomaticMaskGenerator(amg_predictor(cpu_m, cpu_core), **kw).generate(scene)
    cpu_s = time.perf_counter() - t_cpu
    worst = amg_agree(got, want, AMG_MIN_RECORDS)
    log(f"[sam1] AMG fp32 on the card vs the CPU ({AMG_CHECK_SIDE}^2 points and 4 crops at "
        f"{AMG_CHECK_SIDE // 2}^2, CPU {cpu_s:.1f} s): {len(got)} records, equal in count, "
        f"points and crop boxes; worst: {worst} (bounds: masks 0.5% of the area, boxes 1 px, "
        f"predicted IoU 1e-4, stability 2e-2)")
    del cpu_m, cpu_core
    log(f"[sam1] AMG part {time.perf_counter() - t0:.1f} s")
    return rows


# the [stage1] phase: Stage-1 distillation at full width and the ViT trunks
# in training (the d=64 and d=80 backward kernels' path)
STAGE1_IMAGES = 8  # seeded images the teacher exports, in batches of
STAGE1_EXPORT_BATCH = 4
STAGE1_BATCH = 8  # the EV-M student's batch
STAGE1_STEPS, STAGE1_RESUMED = 4, 2  # Trainer steps, then a resumed trainer's
VIT_STEP = {"flash_sdpa": 8, "flash_sdpa_bwd_dq": 4, "flash_sdpa_bwd_dkv": 4}  # 4 global blocks
VIT_CUT_STEP = {"flash_sdpa": 2, "flash_sdpa_bwd_dq": 1, "flash_sdpa_bwd_dkv": 1}  # 1 global block
VITH_STEPS, VITH_BATCH = 2, 1
TEACHER_STEPS, TEACHER_BATCH = 3, 2
# kernel families of a Stage-1 step's profile (lower-case name patterns), first match wins
KERNEL_FAMILIES = (("flash_sdpa backward (dq + dkv) and the split passes",
                    ("bwd_dq_kernel<", "bwd_dkv_h_kernel<", "bwd_dq_h_kernel<",
                     "bwd_dkv_h_f32_kernel<", "bwd_dq_h_f32_kernel<", "split_parts_kernel<")),
                   ("flash_sdpa forward", ("flash_sdpa_h_kernel<", "flash_sdpa_h_f32_kernel<")),
                   ("GEMM", ("gemm", "cutlass", "xmma", "nvjet")),
                   ("softmax", ("softmax",)),
                   ("bf16 casts", ("bfloat16_copy",)),
                   ("copies", ("direct_copy", "copy_kernel", "cat", "index")),
                   ("GELU", ("gelu",)),
                   ("optimizer", ("multi_tensor_apply",)),
                   ("reductions", ("reduce",)),
                   ("other elementwise", ("elementwise",)))


def stage1_phase(smi):
    """Phase 13: Stage-1 distillation on the card. The SAM3 teacher's ViT-H
    trunk (bf16 compute, seeded) exports STAGE1_IMAGES seeded images to the
    record store and the records come back bit for bit; the recipe's
    student (Stage1ImageConfig: EfficientViT-b1 + projection head, 1008^2
    -> 72x72x1024) trains on them through Trainer with a resume; the
    teacher's ViTTrunk (drop path 0) and vit_h's trunk (1120^2) take
    Stage-1 steps against the exported and seeded targets, launches counted
    per step; fp32 4-block cuts of both take one step, the teacher's held
    against the CPU. Returns the rows of the dq and dkv kernels at d=64 and
    d=80, bf16 and fp32, each held against its plain version."""
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from efficientsam3_tpu_torch.build import init_parameters
    from efficientsam3_tpu_torch.data.sa1b import SA1BDistillationDataset, batch_iterator
    from efficientsam3_tpu_torch.models.common import DropPath
    from efficientsam3_tpu_torch.models.vitdet import ViTTrunk
    from efficientsam3_tpu_torch.native import RecordStore
    from efficientsam3_tpu_torch.ops import depthwise as dw
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.ops import layer_norm as ln
    from efficientsam3_tpu_torch.student_sam import VIT_STUDENTS, build_sam_vit_student
    from efficientsam3_tpu_torch.train import stage1
    from efficientsam3_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    counters = {"flash_sdpa": fa, "flash_sdpa_bwd_dq": fa, "flash_sdpa_bwd_dkv": fa,
                "flash_memattn": fa, "flash_memattn_q8": fa, "flash_xattn_rpb": fa,
                "layer_norm": ln, "layer_norm_bwd": ln, "depthwise_conv2d": dw,
                "depthwise_conv2d_bwd": dw}

    def reset():
        for name, mod in counters.items():
            getattr(mod, name).launches = 0

    def counts():  # looked up by name: Capture swaps the wrappers in their module
        return {name: getattr(mod, name).launches for name, mod in counters.items()}

    def expect(what, got, want):
        want = {k: want.get(k, 0) for k in counters}
        if got != want:
            raise AssertionError(f"[stage1] {what}: launches {got}, want {want}")

    def trunk_on_card(make, seed):
        """make(bf16) seeded on the host, its parameters then fp32 (bf16
        compute over fp32 parameters), on the card."""
        return init_parameters(make(bf16), seed).float().to(dev)

    # CUDA events at the edges of a step's parts, recorded by a forward hook
    # pair on the model and a wrapper around the optimizer's step
    marks = {}

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks[name] = e

    def instrument(model, opt):
        model.register_forward_pre_hook(lambda *_: mark("fwd0"))
        model.register_forward_hook(lambda *_: mark("fwd1"))
        step = opt.step

        def timed_opt_step():
            mark("opt0")
            step()
            mark("opt1")

        opt.step = timed_opt_step

    def timed_step(model, opt, batch, want=None, what=""):
        """One stage1_train_step, its launches counted (checked against
        want) and its parts timed: {metrics, ms: step / forward / backward /
        optimizer, launches}."""
        reset()
        mark("step0")
        metrics = stage1.stage1_train_step(model, opt, batch)
        mark("step1")
        torch.cuda.synchronize()
        got = counts()
        if want is not None:
            expect(what, got, want)
        ms = {part: marks[a].elapsed_time(marks[b]) for part, a, b in (
            ("step", "step0", "step1"), ("forward", "fwd0", "fwd1"),
            ("backward", "fwd1", "opt0"), ("optimizer", "opt0", "opt1"))}
        metrics = {k: float(v) for k, v in metrics.items()}
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"[stage1] {what}: non-finite metrics {metrics}")
        return dict(metrics=metrics, ms=ms, launches=got)

    def busy(fn, what, tag, wall_ms, top=0):
        """torch.profiler's device time of one fn() over its wall ms (the
        table written as profile_<tag>.txt by write_out)."""
        kernels, n_launch, total_us = profile_kernels(fn, train=True)
        if not total_us:
            log(f"[profile] {what}: the profiler recorded no device time: not measured")
            return kernels
        log(f"[profile] {what}: {n_launch} kernel launches, {total_us / 1e3:.3f} ms of device "
            f"time in a {wall_ms:.3f} ms step: device busy {total_us / 1e3 / wall_ms:.1%}")
        for name, us, n in kernels[:top]:
            log(f"[profile] {what}:   {us / 1e3:8.4f} ms  x{n:<4d} {name[:90]}")
        write_out(f"profile_{tag}.txt",
                  "\n".join(f"{us:12.2f} us  x{n:<5d} {name}" for name, us, n in kernels))
        return kernels

    class MemoryRecords(SA1BDistillationDataset):
        """SA1BDistillationDataset's items over the exported records, the
        images from memory (no image files, and no PIL, on the card's path)."""

        def __init__(self, images, store, **kw):
            super().__init__([""] * len(images), store, **kw)
            self.images = images

        def __getitem__(self, idx):
            _, embed = self.record(idx)
            return {"image": self.images[idx], "teacher": embed,
                    "valid": np.ones((self.embed_size, self.embed_size), np.float32)}

    rows = []
    rng = np.random.default_rng(21)
    tmp = tempfile.TemporaryDirectory()
    try:
        # ------------------------------------------------------------ teacher export
        t0 = time.perf_counter()
        teacher = trunk_on_card(lambda dt: ViTTrunk(dtype=dt), 0).eval()
        build_s = time.perf_counter() - t0
        images = rng.uniform(-1.0, 1.0, (STAGE1_IMAGES, 1008, 1008, 3)).astype(np.float32)
        seeds = rng.integers(0, 2**32 - 1, size=STAGE1_IMAGES, dtype=np.uint32)
        embed = stage1.teacher_embedder(teacher)
        embed(images[:1])  # warm-up: cuBLAS plans
        reset()
        torch.cuda.synchronize()
        t_exp = time.perf_counter()
        targets = np.concatenate([embed(images[i:i + STAGE1_EXPORT_BATCH])
                                  for i in range(0, STAGE1_IMAGES, STAGE1_EXPORT_BATCH)])
        export_ms = (time.perf_counter() - t_exp) * 1e3 / STAGE1_IMAGES
        expect("teacher export", counts(),
               {"flash_sdpa": 4 * STAGE1_IMAGES // STAGE1_EXPORT_BATCH})
        if targets.shape != (STAGE1_IMAGES, 72, 72, 1024) or not np.isfinite(targets).all():
            raise AssertionError(f"[stage1] teacher embeddings {targets.shape} or non-finite")
        store = os.path.join(tmp.name, "teacher_records.bin")
        SA1BDistillationDataset.write_records(store, seeds, targets)
        rs = RecordStore(store)
        for i in range(STAGE1_IMAGES):
            raw = rs.read(i)
            if (raw[:4] != np.uint32(seeds[i]).tobytes()
                    or raw[4:] != targets[i].astype(np.float16).tobytes()):
                raise AssertionError(f"[stage1] record {i} did not come back bit for bit")
        log(f"[stage1] teacher export: ViT-H (bf16 compute, built and seeded in {build_s:.1f} "
            f"s) over {STAGE1_IMAGES} seeded 1008^2 images in batches of "
            f"{STAGE1_EXPORT_BATCH}: {export_ms:.3f} ms an image (host to host, the fp16 "
            f"records included); {rs.count} records of {rs.item_size} B read back bit for bit "
            f"| {smi}")
        del teacher, embed
        torch.cuda.empty_cache()
        data = MemoryRecords(images, store)

        # ------------------------------------------------------------ EV-M Stage 1
        cfg = stage1.Stage1ImageConfig()
        spe = STAGE1_IMAGES // STAGE1_BATCH

        def student():
            return trunk_on_card(lambda dt: stage1.make_student(cfg, dt), 0)

        model = student()
        opt = stage1.make_optimizer(cfg, spe, model)
        instrument(model, opt)
        per_step = []

        def counted(m, o, b):
            per_step.append(timed_step(m, o, b, {}, "EV-M Stage-1 step"))
            return per_step[-1]["metrics"]

        ckpt = dict(checkpoint_every=2, checkpoint_dir=os.path.join(tmp.name, "ckpt"),
                    log_every=1, handle_preemption_signals=False)
        torch.cuda.reset_peak_memory_stats()
        reached = Trainer(counted, TrainerConfig(max_steps=STAGE1_STEPS, **ckpt)).run(
            model, opt, batch_iterator(data, STAGE1_BATCH, seed=0))
        peak = torch.cuda.max_memory_allocated() / 2**30
        if reached != STAGE1_STEPS:
            raise AssertionError(f"[stage1] trainer stopped at step {reached}")
        # the same steps again: a fresh student and optimizer through a
        # Trainer without checkpoints, over the same batches, the same bits
        again, again_metrics = student(), []
        opt_again = stage1.make_optimizer(cfg, spe, again)

        def step_again(m, o, b):
            again_metrics.append({k: float(v) for k, v in
                                  stage1.stage1_train_step(m, o, b).items()})
            return again_metrics[-1]

        Trainer(step_again, TrainerConfig(max_steps=STAGE1_STEPS, log_every=STAGE1_STEPS,
                                          handle_preemption_signals=False)).run(
            again, opt_again, batch_iterator(data, STAGE1_BATCH, seed=0))
        assert_same_bits(f"[stage1] {STAGE1_STEPS} EV-M Stage-1 steps through Trainer",
                         training_bits(model, opt, [r["metrics"] for r in per_step]),
                         training_bits(again, opt_again, again_metrics))
        del again, opt_again
        saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
        resumed = student()
        opt2 = stage1.make_optimizer(cfg, spe, resumed)
        instrument(resumed, opt2)
        trainer = Trainer(counted, TrainerConfig(max_steps=STAGE1_STEPS + STAGE1_RESUMED, **ckpt))
        if trainer.resume(resumed, opt2) != STAGE1_STEPS or opt2.count != STAGE1_STEPS:
            raise AssertionError("[stage1] the resume did not restore step and optimizer")
        if any(not torch.equal(v, saved[k]) for k, v in resumed.state_dict().items()):
            raise AssertionError("[stage1] the resumed model differs from the saved one")
        reached = trainer.run(resumed, opt2, batch_iterator(data, STAGE1_BATCH, seed=1))
        if reached != STAGE1_STEPS + STAGE1_RESUMED or opt2.count != reached:
            raise AssertionError(f"[stage1] the resumed trainer stopped at step {reached}")
        steady = per_step[1:STAGE1_STEPS]
        med = {p: statistics.median(r["ms"][p] for r in steady) for p in steady[0]["ms"]}
        batch = next(batch_iterator(data, STAGE1_BATCH, seed=2))
        busy(lambda: stage1.stage1_train_step(resumed, opt2, batch), "stage1 EV-M step",
             "stage1_evm_step", med["step"])
        log(f"[stage1] EV-M Stage-1 step (Stage1ImageConfig: b1 + head, 1008^2 -> 72x72x1024, "
            f"batch {STAGE1_BATCH}, bf16 compute, fp32 parameters, lr "
            f"{opt.schedule(0):.3e}): {med['step']:.3f} ms (forward {med['forward']:.3f}, "
            f"backward {med['backward']:.3f}, optimizer {med['optimizer']:.3f}; median of steps "
            f"2-{STAGE1_STEPS}) | peak {peak:.2f} GiB | losses "
            f"{[round(r['metrics']['loss'], 5) for r in per_step]} (steps "
            f"{STAGE1_STEPS + 1}-{reached} resumed) | no kernel of ours on its path | {smi}")
        del model, opt, resumed, opt2, trainer, saved
        torch.cuda.empty_cache()

        # ------------------------------------------------------------ ViT trunks in training
        def vit_run(what, tag, trunk, batches, n_steps, lr_steps):
            """n_steps Stage-1 steps of a ViT trunk (drop path 0) against
            its targets, launches checked per step; every parameter's
            gradient finite and every parameter moved. (ms, peak GiB,
            captured bwd inputs, launches, profile kernels)."""
            opt = stage1.make_optimizer(cfg, lr_steps, trunk)
            instrument(trunk, opt)
            before = {k: p.detach().clone() for k, p in trunk.named_parameters()}
            capture = Capture([(fa, "flash_sdpa_bwd_dq"), (fa, "flash_sdpa_bwd_dkv")])
            with capture:  # warm-up step: cuBLAS plans, captured inputs
                first = timed_step(trunk, opt, next(batches), VIT_STEP, f"{what} step")
            done = [first]
            torch.cuda.reset_peak_memory_stats()
            for _ in range(n_steps - 1):
                done.append(timed_step(trunk, opt, next(batches), VIT_STEP, f"{what} step"))
            peak = torch.cuda.max_memory_allocated() / 2**30
            bad = [k for k, p in trunk.named_parameters()
                   if p.grad is None or not torch.isfinite(p.grad).all()]
            still = [k for k, p in trunk.named_parameters() if torch.equal(p, before[k])]
            if bad or still:
                raise AssertionError(f"[stage1] {what}: gradients missing or non-finite {bad[:4]}, "
                                     f"parameters unmoved {still[:4]}")
            steady = done[1:] if len(done) > 1 else done
            med = {p: statistics.median(r["ms"][p] for r in steady) for p in steady[0]["ms"]}
            batch = next(batches)
            kernels = busy(lambda: stage1.stage1_train_step(trunk, opt, batch),
                           f"stage1 {what} step", tag, med["step"], top=12)
            n_par = sum(p.numel() for p in trunk.parameters())
            log(f"[stage1] {what} Stage-1 step ({n_par / 1e6:.1f} M parameters, bf16 compute, "
                f"fp32 parameters, blocks checkpointed): {med['step']:.3f} ms (forward "
                f"{med['forward']:.3f}, backward {med['backward']:.3f} with the recompute, "
                f"optimizer {med['optimizer']:.3f}; median of steps 2-{n_steps}) | peak "
                f"{peak:.2f} GiB | losses {[round(r['metrics']['loss'], 5) for r in done]} | "
                f"launches a step {first['launches']['flash_sdpa']} / "
                f"{first['launches']['flash_sdpa_bwd_dq']} / "
                f"{first['launches']['flash_sdpa_bwd_dkv']} (forward / dq / dkv) | {smi}")
            del opt, before
            # (dq inputs of a global block, dq launches over the run, profile)
            hd = trunk.embed_dim // trunk.blocks[0].attn.num_heads
            return (capture.args[("flash_sdpa_bwd_dq", hd)][0],
                    sum(r["launches"]["flash_sdpa_bwd_dq"] for r in done), kernels)

        def seeded_batches(size, target, seed):
            """Seeded images at size with a seeded target, batch 1."""
            r = np.random.default_rng(seed)
            while True:
                yield {"image": r.uniform(-1.0, 1.0, (1, size, size, 3)).astype(np.float32),
                       "teacher": target, "valid": np.ones(target.shape[:3], np.float32)}

        t0 = time.perf_counter()
        vit = trunk_on_card(lambda dt: ViTTrunk(drop_path_rate=0.0, dtype=dt), 1)
        # one Stage-1 step twice from the trunk's start: the same loss,
        # gradients and parameters
        start = {k: v.detach().clone() for k, v in vit.state_dict().items()}
        one = next(batch_iterator(data, TEACHER_BATCH, seed=5))
        runs = []
        for _ in range(2):
            vit.load_state_dict(start)
            opt_one = stage1.make_optimizer(cfg, 1, vit)
            torch.manual_seed(0)
            met = {k: float(v) for k, v in stage1.stage1_train_step(vit, opt_one, one).items()}
            runs.append(training_bits(vit, None, [met]))
        assert_same_bits(f"[stage1] a ViT-H (teacher trunk, batch {TEACHER_BATCH}) Stage-1 step",
                         *runs)
        vit.load_state_dict(start)
        del runs, start, opt_one
        torch.cuda.empty_cache()
        vit_in = {64: vit_run("ViT-H (teacher trunk, batch 2)", "stage1_vit_h_step", vit,
                              batch_iterator(data, TEACHER_BATCH, seed=3), TEACHER_STEPS,
                              STAGE1_IMAGES // TEACHER_BATCH)}
        del vit
        torch.cuda.empty_cache()
        log(f"[stage1] ViT-H part {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        vith = build_sam_vit_student("vit_h", dtype=bf16, device=dev, seed=2).trunk.float()
        for m in vith.modules():  # the registry's trunk at the Stage-1 step's rate 0
            if isinstance(m, DropPath):
                m.rate = 0.0
        vith_target = rng.standard_normal((1, 70, 70, 1280)).astype(np.float32)
        vit_in[80] = vit_run("vit_h (1120^2, batch 1)", "stage1_sam1_vit_h_step", vith,
                             seeded_batches(1120, vith_target, 4), VITH_STEPS, 8)
        del vith
        torch.cuda.empty_cache()
        log(f"[stage1] vit_h part {time.perf_counter() - t0:.1f} s")
        for d, what in ((64, "ViT-H"), (80, "vit_h")):  # where a step's device time goes
            fam = {}
            for name, us, _ in vit_in[d][2]:
                low = name.lower()
                key = next((f for f, pats in KERNEL_FAMILIES if any(p in low for p in pats)),
                           "other")
                fam[key] = fam.get(key, 0.0) + us / 1e3
            log(f"[profile] {what} Stage-1 step, device ms by kernel family: "
                f"{ {k: round(v, 3) for k, v in sorted(fam.items(), key=lambda kv: -kv[1])} }")

        # ------------------------------------------------------------ fp32 cuts
        t0 = time.perf_counter()
        cut_in = {}
        vith_cfg = dict(patch_size=16, window_size=14, pretrain_grid=64, mlp_ratio=4.0,
                        **VIT_STUDENTS["vit_h"])
        for d, make, size, seed in (
                (64, lambda dt: ViTTrunk(depth=4, global_att_blocks=(3,), drop_path_rate=0.0,
                                         dtype=dt), 1008, 5),
                (80, lambda dt: ViTTrunk(dtype=dt, **dict(vith_cfg, depth=4,
                                                           global_att_blocks=(3,),
                                                           drop_path_rate=0.0)), 1120, 6)):
            cpu_ref = init_parameters(make(None), seed)
            card = make(None).to(dev)
            card.load_state_dict(cpu_ref.state_dict())
            side = size // (14 if d == 64 else 16)
            batch = {"image": rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32),
                     "teacher": (targets[:1] if d == 64 else
                                 rng.standard_normal((1, side, side, card.embed_dim))
                                 .astype(np.float32)),
                     "valid": np.ones((1, side, side), np.float32)}
            grads = {}
            for where, m in (("card", card), ("cpu", cpu_ref)) if d == 64 else (("card", card),):
                o = stage1.make_optimizer(cfg, 1, m)
                step_ = o.step

                def keep(m=m, step_=step_, where=where):  # the gradients before the clip
                    grads[where] = {k: p.grad.detach().float().cpu().clone()
                                    for k, p in m.named_parameters()}
                    step_()

                o.step = keep
                t_s = time.perf_counter()
                capture = Capture([(fa, "flash_sdpa_bwd_dq"), (fa, "flash_sdpa_bwd_dkv")])
                with capture:
                    reset()
                    met = stage1.stage1_train_step(m, o, batch)
                    torch.cuda.synchronize()
                    got = counts()
                grads[where + "_loss"] = float(met["loss"])
                grads[where + "_s"] = time.perf_counter() - t_s
                if where == "card":
                    expect(f"fp32 d={d} cut step", got, VIT_CUT_STEP)
                    cut_in[d] = (capture.args[("flash_sdpa_bwd_dq", d)][0],
                                 got["flash_sdpa_bwd_dq"])
            if d == 64:
                rel = abs(grads["card_loss"] - grads["cpu_loss"]) / abs(grads["cpu_loss"])
                worst, worst_k = max(
                    (((grads["card"][k] - w).abs().max() / w.abs().max().clamp_min(1e-30)).item(),
                     k) for k, w in grads["cpu"].items())
                log(f"[stage1] fp32 ViT-H cut (4 blocks, block 3 global, 1008^2, batch 1): one "
                    f"Stage-1 step on the card ({grads['card_s']:.2f} s, the first) against "
                    f"the CPU ({grads['cpu_s']:.1f} s): loss {grads['card_loss']:.6f} vs "
                    f"{grads['cpu_loss']:.6f} ({rel:.2e} relative, bound 1e-5), worst gradient "
                    f"{worst:.2e} of its tensor's largest magnitude ({worst_k}; bound 1e-4)")
                if not (rel <= 1e-5 and worst <= 1e-4):
                    raise AssertionError("[stage1] the fp32 cut's step on the card differs from "
                                         "the CPU's")
            else:
                log(f"[stage1] fp32 vit_h cut (4 blocks, block 3 global, 1120^2, batch 1): one "
                    f"Stage-1 step on the card, loss {grads['card_loss']:.6f}, launches "
                    f"{VIT_CUT_STEP}")
            # a further cut step on the card under the profiler: the split-bf16
            # wgmma dq and dkv kernels launch once each; their device ms a launch
            # go to the fp32 rows below
            o = stage1.make_optimizer(cfg, 1, card)
            prof_cut, _, _ = profile_kernels(lambda: stage1.stage1_train_step(card, o, batch),
                                             train=True)
            cut_dev = {}
            for name, key, pattern in (
                    (f"flash_sdpa_bwd_dq_d{d}_fp32", "flash_sdpa_bwd_dq",
                     f"flash_bwd_dq_h_f32_kernel<{d}>"),
                    (f"flash_sdpa_bwd_dkv_d{d}_fp32", "flash_sdpa_bwd_dkv",
                     f"flash_bwd_dkv_h_f32_kernel<{d}>")):
                n_seen = sum(n for k_, _, n in prof_cut if pattern in k_)
                if prof_cut and n_seen != VIT_CUT_STEP[key]:
                    raise AssertionError(f"[stage1] fp32 d={d} cut step profile: {n_seen} "
                                         f"launches of {pattern}, not {VIT_CUT_STEP[key]}")
                if n_seen:
                    cut_dev[name] = sum(u for k_, u, _ in prof_cut if pattern in k_) / 1e3 / n_seen
            log(f"[stage1] fp32 d={d} cut step profile: 1 launch each of "
                f"flash_bwd_dq_h_f32_kernel<{d}> and flash_bwd_dkv_h_f32_kernel<{d}>, device ms "
                f"a launch {cut_dev}")
            cut_in[d] = (*cut_in[d], cut_dev)
            del o, prof_cut
            del cpu_ref, card, grads
            torch.cuda.empty_cache()
        log(f"[stage1] fp32 cuts {time.perf_counter() - t0:.1f} s")
    finally:
        tmp.cleanup()

    # ---------------------------------------------------------------- kernel rows
    def bf16_rows(d, dq_args, launches, prof):
        """The bf16 dq and dkv rows at one global block's captured inputs
        (2e-2 of each output's largest magnitude; dK and dV the same bits
        when run again), SDPA's backward (no mask: every key live) as the
        library time, and the device ms a launch in the profiled Stage-1
        step (prof, where the dq kernel must show its VIT_STEP launches).
        dq is the wgmma kernel of csrc/flash_sdpa_bwd_dq_h.cu, dkv the wgmma
        kernel of csrc/flash_sdpa_bwd_h.cu."""
        q, k, v, key_bias, o, lse, do, scale = dq_args
        b, h, lq, _ = q.shape
        dq, delta = fa.flash_sdpa_bwd_dq(q, k, v, key_bias, o, lse, do, scale)
        want_dq, want_delta = fa.flash_sdpa_bwd_dq_plain(q, k, v, key_bias, o, lse, do, scale)
        err_dq = max(check_rel(f"flash_sdpa_bwd_dq_d{d}", dq, want_dq),
                     check_rel(f"flash_sdpa_bwd_dq_d{d} (delta)", delta, want_delta, 1e-4))
        dk, dv = fa.flash_sdpa_bwd_dkv(q, k, v, key_bias, do, lse, delta, scale)
        want_dk, want_dv = fa.flash_sdpa_bwd_dkv_plain(q, k, v, key_bias, do, lse, want_delta,
                                                       scale)
        err_dkv = max(check_rel(f"flash_sdpa_bwd_dkv_d{d} (dk)", dk, want_dk),
                      check_rel(f"flash_sdpa_bwd_dkv_d{d} (dv)", dv, want_dv))
        dk2, dv2 = fa.flash_sdpa_bwd_dkv(q, k, v, key_bias, do, lse, delta, scale)
        if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            raise AssertionError(f"flash_sdpa_bwd_dkv_d{d}: a second run differs")
        log(f"[kernel] flash_sdpa_bwd_dkv_d{d}: dK and dV the same bits when run again")
        del dq, dk, dv, dk2, dv2, want_dq, want_dk, want_dv, want_delta
        torch.cuda.empty_cache()
        live = int((key_bias > fa.NEG_INF / 2).sum().item())  # summed over the batch
        scores = h * lq * live
        nb_dq = 2 * (5 * q.numel() + 2 * h * live * d) + 4 * (key_bias.numel() + 2 * lse.numel())
        nb_dkv = 2 * (2 * q.numel() + 4 * h * live * d) + 4 * (key_bias.numel() + 2 * lse.numel())
        bms_dq, by_dq = bound(nb_dq, 3 * 2.0 * scores * d, 1.0 * scores, 6.0 * scores)
        bms_dkv, by_dkv = bound(nb_dkv, 4 * 2.0 * scores * d, 1.0 * scores, 6.0 * scores)
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
        lib_ms = cuda_time(lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True),
                           10)
        del ol, ql, kl, vl
        dq_pattern = f"flash_bwd_dq_h_kernel<{d}>"
        n_prof = sum(n for k_, _, n in prof if dq_pattern in k_)
        if prof and n_prof != VIT_STEP["flash_sdpa_bwd_dq"]:
            raise AssertionError(f"[stage1] d={d} step profile: {n_prof} launches of "
                                 f"{dq_pattern}, not {VIT_STEP['flash_sdpa_bwd_dq']}")
        log(f"[stage1] d={d} step profile: {n_prof} launches of {dq_pattern}")
        res = {"flash_sdpa_bwd_dq": fa.kernel_resources(fa.bwd_dq_kernel(bf16, d), d,
                                                        k.shape[2]),
               "flash_sdpa_bwd_dkv": fa.kernel_resources(fa.bwd_dkv_kernel(bf16, d), d,
                                                         k.shape[2])}
        shape = (f"q/k/v/o/dO {tuple(q.shape)} bf16 (q, k, v views of the packed qkv, dO "
                 f"strided), {live} live keys over {b} rows; library = SDPA backward (all "
                 f"three gradients)")
        out = []
        for name, fn, plain, err, bms, by, line, source, pattern, design in (
                (f"flash_sdpa_bwd_dq_d{d}",
                 lambda: fa.flash_sdpa_bwd_dq(q, k, v, key_bias, o, lse, do, scale),
                 lambda: fa.flash_sdpa_bwd_dq_plain(q, k, v, key_bias, o, lse, do, scale),
                 err_dq, bms_dq, by_dq, 1082, fa.bwd_dq_kernel(bf16, d), dq_pattern,
                 "wgmma + TMA"),
                (f"flash_sdpa_bwd_dkv_d{d}",
                 lambda: fa.flash_sdpa_bwd_dkv(q, k, v, key_bias, do, lse, delta, scale),
                 lambda: fa.flash_sdpa_bwd_dkv_plain(q, k, v, key_bias, do, lse, delta, scale),
                 err_dkv, bms_dkv, by_dkv, 1098, fa.bwd_dkv_kernel(bf16, d),
                 f"bwd_dkv_h_kernel<{d}>", "wgmma + TMA")):
            r_ = res[name.rsplit("_", 1)[0]]
            r = dict(name=name, route="cuda",
                     source=f"efficientsam3_tpu_torch/csrc/{source}.cu",
                     replaces=f"efficientsam3_tpu/ops/pallas/flash_attention.py:{line}",
                     launches=launches, max_abs_err=err, ms=graph_time(fn, 5, 10),
                     call_ms=cuda_time(fn, 10), plain_ms=cuda_time(plain, 3, warmup=1),
                     bound_ms=bms, bound_by=by, library_ms=lib_ms,
                     device_ms=next((us / n / 1e3 for k_, us, n in prof if pattern in k_), None),
                     shape=f"{shape}; {design}, {r_['registers']} registers, "
                           f"{r_['spill_bytes']} bytes spilled, {r_['smem_bytes']} B shared, "
                           f"{r_['blocks_per_sm']} blocks an SM", **{"pass": True})
            log_row(r, smi)
            out.append(r)
            torch.cuda.empty_cache()
        log(f"[kernel] d={d} backward pair (dq + dkv) {out[0]['ms'] + out[1]['ms']:.4f} ms in "
            f"CUDA graphs against SDPA backward's {lib_ms:.4f} ms a call | {smi}")
        return out

    def fp32_row(name, source, line, launches, err, fn, plain, library, bms, by, shape, device):
        r = dict(name=name, route="cuda", source=f"efficientsam3_tpu_torch/csrc/{source}",
                 replaces=f"efficientsam3_tpu/ops/pallas/{line}", launches=launches,
                 max_abs_err=err, ms=graph_time(fn, 5, 10), call_ms=cuda_time(fn, 10),
                 plain_ms=cuda_time(plain, 3, warmup=1), bound_ms=bms, bound_by=by,
                 library_ms=library, device_ms=device, shape=shape, **{"pass": True})
        log_row(r, smi)
        return r

    for d in (64, 80):
        dq_args, launches, prof = vit_in.pop(d)
        rows += bf16_rows(d, dq_args, launches, prof)
        del dq_args
        q, k, v, key_bias, o, lse, do, scale = cut_in[d][0]
        rows += bwd_rows_fp32(q, k, v, key_bias, o, lse, do, scale, cut_in[d][1], f"_d{d}",
                              cut_in[d][2], fp32_row)
        del q, k, v, key_bias, o, lse, do
        torch.cuda.empty_cache()
    return rows


# the text towers and the rest of training (phases 14-17)
TEXT_TOWERS = ("MobileCLIP-S1", "MobileCLIP2-L", "MobileCLIP-B")
TEXT_BATCH, TEXT_STEPS = 64, 3
# a tower's fp32 forward on the card against the same tower on the host's
# CPU (TF32 off): sums in other orders over 12 layers, ~1e-6 of the
# output's largest magnitude expected; the bound 1e-4 of it
TEXT_TOL = 1e-4
GEOM_BATCH, GEOM_STEPS = 4, 3
# the trunk's gradient of a geometry step at fp32 (batch 1) through the
# kernels against the plain versions, |g - g_plain| / |g_plain|: the fp32
# kernels multiply split bf16 parts (~2^-16 a product); the bound 1e-2, and
# with the kernels' outputs cut from the graph it must move by over twice that
GEOM_GRAD_BOUND = 1e-2
ASSOC_STEPS, ASSOC_BATCH = 50, 8


def text_tokens(batch, ctx, seed=21):
    """Seeded prompts as token ids (start, 1-12 words, end) and the same
    prompts with their words permuted (``stage1_text.permute_words`` on
    ids): (tokens, tokens_perm), int64 numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tok = np.zeros((batch, ctx), np.int64)
    perm = np.zeros_like(tok)
    for b in range(batch):
        words = rng.integers(320, 49000, int(rng.integers(1, 13)))
        tok[b, :len(words) + 2] = [49406, *words, 49407]
        perm[b, :len(words) + 2] = [49406, *rng.permutation(words), 49407]
    return tok, perm


def kernel_counters():
    """{name: wrapper} of the kernels on the training paths, each counting
    its own launches."""
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.ops import layer_norm as ln

    return {"flash_sdpa": fa.flash_sdpa, "flash_sdpa_bwd_dq": fa.flash_sdpa_bwd_dq,
            "flash_sdpa_bwd_dkv": fa.flash_sdpa_bwd_dkv, "layer_norm": ln.layer_norm,
            "layer_norm_bwd": ln.layer_norm_bwd, "flash_xattn_rpb": fa.flash_xattn_rpb}


def model_launches(model):
    """(fusion layers, kernel LayerNorms, decoder layers) of an image
    model: a ground launches flash_sdpa once a fusion layer and layer_norm
    once a FusedLayerNorm (fusion and geometry encoders), and, where no
    gradient is recorded, flash_xattn_rpb once a decoder layer."""
    from efficientsam3_tpu_torch.models.common import FusedLayerNorm

    return (len(model.fusion_encoder.layers),
            sum(isinstance(m, FusedLayerNorm) for m in model.modules()),
            len(model.decoder.layers))


def text_phase(smi, main_ref):
    """Phase 14: the MobileCLIP towers. Returns no row (no kernel of ours
    runs in a tower at context 32)."""
    import copy

    import numpy as np
    import torch

    from efficientsam3_tpu_torch.build import build_efficientsam3_image_model, init_parameters
    from efficientsam3_tpu_torch.models.mobile_clip import MOBILECLIP_TEXT_CFGS
    from efficientsam3_tpu_torch.models.text_encoder import VETextEncoder
    from efficientsam3_tpu_torch.processor import Sam3Processor
    from efficientsam3_tpu_torch.train import stage1_text as st

    dev = torch.device("cuda")
    tok_np, perm_np = text_tokens(TEXT_BATCH, 32)
    tok, perm = torch.from_numpy(tok_np).to(dev), torch.from_numpy(perm_np).to(dev)
    # the teacher's token features: the SAM3 CLIP tower (24 layers, width 1024)
    teacher = init_parameters(VETextEncoder(256, 32, dtype=torch.bfloat16), seed=7).to(dev).eval()
    with torch.no_grad():  # the targets enter the students' autograd graph
        teacher_ms = cuda_time(lambda: teacher(tok), 5)
        target, target_perm = teacher(tok)[0].float(), teacher(perm)[0].float()
    log(f"[text] teacher CLIP tower (24 layers, width 1024) bf16 at batch {TEXT_BATCH}: "
        f"{teacher_ms:.3f} ms a forward | {smi}")
    del teacher
    batch = {"tokens": tok, "tokens_perm": perm, "teacher": target, "teacher_perm": target_perm}
    for name in TEXT_TOWERS:
        cfg = st.Stage1TextConfig(backbone_type=name, context_length=32)
        cpu = init_parameters(st.make_text_student(cfg), seed=3).eval()
        card = copy.deepcopy(cpu).to(dev)
        small = tok[:4].cpu()
        with torch.inference_mode():
            want, got = cpu(small)[0], card(small.to(dev))[0].cpu()
        err = ((got - want).abs().max() / want.abs().max()).item()
        log(f"[text] {name} fp32 on the card against the CPU (batch 4): max error {err:.3e} of "
            f"the largest magnitude (bound {TEXT_TOL})")
        if not err <= TEXT_TOL:
            raise AssertionError(f"{name}: fp32 on the card off the CPU by {err}")
        del cpu, card
        student = init_parameters(st.make_text_student(cfg, dtype=torch.bfloat16), seed=3).to(dev)
        n_params = sum(p.numel() for p in student.parameters())
        with torch.inference_mode():
            fwd_ms = cuda_time(lambda: student.eval()(tok), 10)
        log(f"[text] {name} ({MOBILECLIP_TEXT_CFGS[name]}): {n_params / 1e6:.1f} M "
            f"parameters, bf16 forward at batch {TEXT_BATCH} {fwd_ms:.3f} ms | {smi}")
        if name != "MobileCLIP-S1":
            del student
            continue
        start = {k: v.detach().clone() for k, v in student.state_dict().items()}
        opt = st.make_text_optimizer(cfg, student)
        per_step = []
        torch.manual_seed(0)
        for i in range(TEXT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = st.stage1_text_train_step(student, opt, cfg, batch)
            torch.cuda.synchronize()
            m = {k: float(v) for k, v in m.items()}
            per_step.append(((time.perf_counter() - t0) * 1e3, m))
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"Stage-1 text step {i + 1}: {m}")
        log(f"[text] {name} stage1_text_train_step at batch {TEXT_BATCH}: " + "; ".join(
            f"step {i + 1} {ms:.1f} ms, loss {m['loss']:.4f} (mse {m['mse']:.4f}, cosine "
            f"{m['cosine']:.4f}, perm {m['perm']:.4f})" for i, (ms, m) in enumerate(per_step))
            + f" | {smi}")
        # the same steps again from the same start and seed: the same bits
        first = training_bits(student, opt, [m for _, m in per_step])
        student.load_state_dict(start)
        opt = st.make_text_optimizer(cfg, student)
        torch.manual_seed(0)
        again = [{k: float(v) for k, v in st.stage1_text_train_step(student, opt, cfg,
                                                                    batch).items()}
                 for _ in range(TEXT_STEPS)]
        assert_same_bits(f"[text] {name}: {TEXT_STEPS} stage1_text_train_steps", first,
                         training_bits(student, opt, again))
        del student, opt, first, start
    torch.cuda.empty_cache()

    # EV-M with the MobileCLIP2-L tower through the processor: the tower
    # adds no launch to a ground's
    model = build_efficientsam3_image_model(
        backbone_type="efficientvit", model_name="b1", text_encoder_type="MobileCLIP2-L",
        text_encoder_context_length=32, dtype=torch.bfloat16, device=dev, seed=0)
    proc = Sam3Processor(model, resolution=1008, context_length=32)

    def call():
        state = proc.set_image(main_ref["image"])
        state["text"] = proc.encode_tokens(main_ref["tokens"])
        return proc.add_geometric_prompt(main_ref["box"], True, state)

    call()
    counters = kernel_counters()
    for w in counters.values():
        w.launches = 0
    state = call()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in counters.items()}
    for k, want in MAIN_COUNTS.items():
        if launches[k] != want:
            raise AssertionError(f"[text] MobileCLIP2-L ground: {k} {launches[k]}, want {want}")
    if not all(np.isfinite(state[k]).all() for k in ("scores", "boxes", "masks_logits")):
        raise AssertionError("[text] MobileCLIP2-L ground: non-finite outputs")
    tok1 = torch.from_numpy(main_ref["tokens"]).to(dev)
    with torch.inference_mode():
        text_ms = cuda_time(lambda: model.encode_text(tok1), 20)
    whole_ms = cuda_time(call, 5, warmup=1)
    log(f"[text] EV-M 1008^2 with MobileCLIP2-L through Sam3Processor: launches "
        f"{ {k: launches[k] for k in MAIN_COUNTS} }, encode_text {text_ms:.3f} ms, whole call "
        f"{whole_ms:.3f} ms, kept {len(state['scores'])} of 200 | {smi}")
    return []


def geometry_batch(batch, device, seed=31):
    """A Stage-3 synthetic batch (``stage3_batch``) with one box prompt a
    sample from its first ground-truth box, a seeded teacher embedding of
    the trunk's (72, 72, 1024) output (valid everywhere) and the first
    object's 288x288 mask as the teacher mask."""
    import torch

    from efficientsam3_tpu_torch.models.geometry import Prompt

    b = stage3_batch(batch, 32, device, seed=seed)
    prompt = Prompt.empty(batch, 8, 8, device=device)
    for i in range(batch):
        prompt = prompt.with_box(i, 0, b["targets"]["boxes"][i, 0].tolist())
    gen = torch.Generator(device=device).manual_seed(seed)
    return {"images": b["images"], "tokens": b["tokens"], "prompt": prompt,
            "teacher_embed": torch.randn((batch, 72, 72, 1024), generator=gen, device=device),
            "valid": torch.ones((batch, 72, 72), device=device),
            "teacher_mask": b["targets"]["masks"][:, 0], "targets": b["targets"]}


def geometry_phase(smi, new_launches):
    """Phase 15: the geometry-aware finetune; adds its launches to
    ``new_launches``, returns no row (phase 6 holds the kernels at the
    step's shapes)."""
    import torch

    from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
    from efficientsam3_tpu_torch.models import common
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.ops import layer_norm as ln
    from efficientsam3_tpu_torch.train import geometry_finetune as gf
    from efficientsam3_tpu_torch.utils.checkpoint import assert_frozen_unchanged

    dev = torch.device("cuda")

    def build(dtype):
        return build_efficientsam3_image_model(
            backbone_type="efficientvit", model_name="b1", text_encoder_type="MobileCLIP-S0",
            text_encoder_context_length=32, dtype=dtype, device=dev, seed=0)

    model = build(torch.bfloat16)
    cfg = gf.GeometryFinetuneConfig()
    opt = gf.make_geometry_optimizer(cfg, model)
    batch = geometry_batch(GEOM_BATCH, dev)
    n_fusion, n_ln, n_dec = model_launches(model)
    want = {"flash_sdpa": n_fusion, "flash_sdpa_bwd_dq": n_fusion, "flash_sdpa_bwd_dkv": n_fusion,
            "layer_norm": n_ln, "layer_norm_bwd": n_ln, "flash_xattn_rpb": 0}
    log(f"[geometry] launches a step, from the model ({n_fusion} fusion layers, {n_ln} kernel "
        f"LayerNorms, {n_dec} decoder layers; the eval-mode heads pass gradient to the trunk, so "
        f"the boxRPB cross-attention takes the matmul path): {want}")
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    counters = kernel_counters()
    per_step = []
    torch.cuda.reset_peak_memory_stats()
    torch.manual_seed(0)
    for i in range(GEOM_STEPS):
        for w in counters.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = gf.geometry_finetune_step(model, opt, cfg, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: w.launches for k, w in counters.items()}
        if got != want:
            raise AssertionError(f"[geometry] step {i + 1}: launches {got}, want {want}")
        m = {k: float(v) for k, v in m.items()}
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"[geometry] step {i + 1}: {m}")
        per_step.append((ms, m))
        for k, n in got.items():
            new_launches[k] = new_launches.get(k, 0) + n
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("[geometry] geometry_finetune_step (EV-M 1008^2, MobileCLIP-S0, bf16, batch "
        f"{GEOM_BATCH}, box prompts): " + "; ".join(
            f"step {i + 1} {ms:.1f} ms, loss {m['loss']:.4f} (embed {m['embed']:.4f}, bce "
            f"{m['bce']:.4f}, dice {m['dice']:.4f})" for i, (ms, m) in enumerate(per_step))
        + f" | peak memory {peak:.2f} GiB | {smi}")
    after = {k: v.detach() for k, v in model.state_dict().items()}
    frozen = tuple({k.split(".")[0] for k in after} - {"trunk"})
    assert_frozen_unchanged(before, after, frozen)
    moved = sum(int((after[k] != v).sum()) for k, v in before.items() if k.startswith("trunk."))
    if moved == 0:
        raise AssertionError("[geometry] the trunk did not move")
    log(f"[geometry] trunk: {moved} elements changed; {sorted(frozen)} bit-identical")
    # the same steps again from the same start and seed: the same bits
    first = training_bits(model, opt, [m for _, m in per_step])
    model.load_state_dict(before)
    opt = gf.make_geometry_optimizer(cfg, model)
    torch.manual_seed(0)
    again = [{k: float(v) for k, v in gf.geometry_finetune_step(model, opt, cfg, batch).items()}
             for _ in range(GEOM_STEPS)]
    assert_same_bits(f"[geometry] {GEOM_STEPS} geometry_finetune_steps", first,
                     training_bits(model, opt, again))
    del first

    # the eval ground without a gradient takes the boxRPB kernel
    for w in counters.values():
        w.launches = 0
    with torch.no_grad():
        out = model(batch["images"], batch["tokens"], batch["prompt"])
    torch.cuda.synchronize()
    got = {k: w.launches for k, w in counters.items()}
    want_eval = {"flash_sdpa": n_fusion, "layer_norm": n_ln, "flash_xattn_rpb": n_dec}
    if any(got[k] != n for k, n in want_eval.items()) or not torch.isfinite(
            out["pred_masks"].float()).all():
        raise AssertionError(f"[geometry] eval ground under no_grad: launches {got}, want "
                             f"{want_eval}")
    for k in want_eval:
        new_launches[k] = new_launches.get(k, 0) + got[k]
    log(f"[geometry] eval ground under no_grad after the steps: {want_eval} launches")
    del model, opt, batch, out, before, after
    torch.cuda.empty_cache()

    # the trunk's gradient at fp32 (batch 1) through the kernels, the plain
    # versions, and the kernels' outputs cut from the graph; each run from
    # the same BatchNorm statistics (pass 1 updates them)
    m32 = build(None)
    gf.make_geometry_optimizer(cfg, m32)
    one = geometry_batch(1, dev)
    stats = {k: v.clone() for k, v in m32.named_buffers()}

    def trunk_grad():
        with torch.no_grad():
            for k, v in m32.named_buffers():
                v.copy_(stats[k])
        m32.zero_grad(set_to_none=True)
        loss, _ = gf.geometry_finetune_loss(m32, one, cfg)
        loss.backward()
        return torch.cat([p.grad.flatten() for p in m32.trunk.parameters()])

    n_fwd = fa.flash_sdpa.launches
    grads = {"kernels": trunk_grad()}
    if fa.flash_sdpa.launches == n_fwd:
        raise AssertionError("[geometry] the fp32 run launched no flash_sdpa")
    saved = common.flash_sdpa, common.layer_norm
    for name, attn, norm in (
            ("plain", fa.flash_sdpa_plain, ln.layer_norm_plain),
            ("cut", lambda *a, **k: fa.flash_sdpa(*a, **k).detach(),
             lambda *a, **k: ln.layer_norm(*a, **k).detach())):
        common.flash_sdpa, common.layer_norm = attn, norm
        try:
            grads[name] = trunk_grad()
        finally:
            common.flash_sdpa, common.layer_norm = saved
    rel = {k: ((grads[k] - grads["plain"]).norm() / grads["plain"].norm()).item()
           for k in ("kernels", "cut")}
    log(f"[geometry] fp32 trunk gradient of a step (batch 1), |g - g_plain| / |g_plain|: "
        f"kernels {rel['kernels']:.3e} (bound {GEOM_GRAD_BOUND}), the kernels' outputs cut "
        f"from the graph {rel['cut']:.3e} (must exceed {2 * GEOM_GRAD_BOUND})")
    if not (rel["kernels"] <= GEOM_GRAD_BOUND and rel["cut"] > 2 * GEOM_GRAD_BOUND):
        raise AssertionError(f"[geometry] fp32 trunk gradient through the kernels: {rel}")
    del m32, grads
    torch.cuda.empty_cache()
    return []


def interactive_phase(smi, new_launches):
    """Phase 16: interactive-steps training, one corrective step; adds its
    launches to ``new_launches``, returns no row."""
    import torch

    from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
    from efficientsam3_tpu_torch.train import interactive as it

    dev = torch.device("cuda")
    model = build_efficientsam3_image_model(
        backbone_type="efficientvit", model_name="b1", text_encoder_type="MobileCLIP-S0",
        text_encoder_context_length=32, dtype=torch.bfloat16, device=dev, seed=0)
    model.train().requires_grad_(True)
    batch = geometry_batch(GEOM_BATCH, dev, seed=41)
    n_fusion, n_ln, _ = model_launches(model)
    passes = 2  # num_interactive_steps + 1
    want_fwd = {"flash_sdpa": passes * n_fusion, "layer_norm": passes * n_ln,
                "flash_xattn_rpb": 0}
    want_bwd = {"flash_sdpa_bwd_dq": passes * n_fusion, "flash_sdpa_bwd_dkv": passes * n_fusion,
                "layer_norm_bwd": passes * n_ln}
    counters = kernel_counters()
    clicks = []
    sample = it.sample_correction_click

    def recorded(*a):
        out = sample(*a)
        clicks.append([t.cpu() for t in out])
        return out

    def run():
        for w in counters.values():
            w.launches = 0
        model.zero_grad(set_to_none=True)
        torch.manual_seed(0)  # the dropout bits
        t0, t1, t2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0.record()
        total, parts = it.interactive_grounding_loss(
            model, batch["images"], batch["tokens"], batch["prompt"], batch["targets"],
            num_interactive_steps=1)
        t1.record()
        fwd = {k: w.launches for k, w in counters.items()}
        total.backward()
        t2.record()
        t2.synchronize()
        bwd = {k: counters[k].launches - fwd[k] for k in counters}
        return float(total.detach()), parts, fwd, bwd, t0.elapsed_time(t1), t1.elapsed_time(t2)

    it.sample_correction_click = recorded
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    try:
        first = run()  # warm-up: cuDNN plans, the allocator
        first = training_bits(model, None, [{"loss": first[0]}])
        model.load_state_dict(start)  # the forward moved the BatchNorm statistics
        clicks.clear()
        torch.cuda.reset_peak_memory_stats()
        total, parts, fwd, bwd, fwd_ms, bwd_ms = run()
    finally:
        it.sample_correction_click = sample
    # the two runs from one start and seed: the same loss, gradients and statistics
    assert_same_bits("[interactive] interactive_grounding_loss and its backward", first,
                     training_bits(model, None, [{"loss": total}]))
    del first, start
    peak = torch.cuda.max_memory_allocated() / 2**30
    if any(fwd[k] != n for k, n in want_fwd.items()) or any(
            bwd[k] != n for k, n in want_bwd.items()):
        raise AssertionError(f"[interactive] launches forward {fwd} (want {want_fwd}), "
                             f"backward {bwd} (want {want_bwd})")
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not (math.isfinite(total) and len(parts) == passes and grads and all(
            torch.isfinite(g.float()).all() for g in grads)):
        raise AssertionError(f"[interactive] loss {total}, {len(parts)} passes, non-finite grads")
    for k, n in {**want_fwd, **want_bwd}.items():
        new_launches[k] = new_launches.get(k, 0) + n
    (xy, labels, has), = clicks
    log(f"[interactive] interactive_grounding_loss (EV-M 1008^2, bf16, batch {GEOM_BATCH}, 1 "
        f"corrective step = {passes} grounding passes, training mode): loss {total:.4f} "
        f"(each pass's weighted sam3_detection_loss, summed), forward "
        f"{fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms, peak memory {peak:.2f} GiB | {smi}")
    log(f"[interactive] launches forward {fwd}, backward {bwd}")
    log("[interactive] clicks placed (x, y in [0, 1], label 1 = add, 0 = remove): " + "; ".join(
        f"sample {i}: ({float(x):.3f}, {float(y):.3f}) label {int(lb)}" if bool(h)
        else f"sample {i}: none (no error)" for i, ((x, y), lb, h) in enumerate(
            zip(xy.tolist(), labels, has))))
    del model, batch, grads
    torch.cuda.empty_cache()
    return []


def assoc_phase(smi):
    """Phase 17: the video association head's training; no kernel of ours
    on its path, returns no row."""
    import numpy as np
    import torch

    from efficientsam3_tpu_torch.build import init_parameters
    from efficientsam3_tpu_torch.train.video_assoc import (
        AssocHead,
        FramePairDataset,
        assoc_train_step,
    )

    dev = torch.device("cuda")
    head = init_parameters(AssocHead(256), seed=0).to(dev)
    start = {k: v.detach().clone() for k, v in head.state_dict().items()}
    data = FramePairDataset(q_det=200, q_trk=8, d_model=256, seed=0)
    opt = torch.optim.Adam(head.parameters(), lr=3e-3)
    step = assoc_train_step(head, opt)
    batches = [data.batch(ASSOC_BATCH) for _ in range(ASSOC_STEPS)]
    torch.manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(b) for b in batches]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / ASSOC_STEPS
    losses = [float(v) for v in losses]
    # the same steps again from the same start and seed: the same bits
    first = training_bits(head, opt, [{"loss": v} for v in losses])
    head.load_state_dict(start)
    opt = torch.optim.Adam(head.parameters(), lr=3e-3)
    step = assoc_train_step(head, opt)
    torch.manual_seed(0)
    again = [{"loss": float(step(b))} for b in batches]
    assert_same_bits(f"[assoc] {ASSOC_STEPS} assoc_train_steps", first,
                     training_bits(head, opt, again))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    log(f"[assoc] AssocHead (d_model 256, 200 detection and 8 track queries, batch "
        f"{ASSOC_BATCH}) over FramePairDataset: {ASSOC_STEPS} assoc_train_steps, {ms:.3f} ms a "
        f"step (batches made beforehand); loss, mean of the first 5 {first:.4f}, of the last "
        f"5 {last:.3e} | {smi}")
    if not (np.isfinite(losses).all() and last < 0.5 * first):
        raise AssertionError(f"[assoc] the loss did not fall: {losses}")
    return []


# the [eval] phase: a shapes fixture of EVAL_IMAGES images at EVAL_SIZE^2
# (two queries an image), the stub merge table the tokenizer reads in place
# of the CLIP vocab (the repo has none), and the bound on the share of mask
# pixels the card's postprocessing may flip against the CPU's (each within
# EVAL_BAND of 0 in the CPU's upsampled logit)
EVAL_IMAGES = 4
EVAL_SIZE = 256
EVAL_BPE = "#version\na b\n"
EVAL_BAND = 1e-3
EVAL_FLIP_SHARE = 1e-4
EVAL_ORACLE_MIN = 0.95


class ScriptedAgentLLM:
    """The tool loop's MLLM, scripted: segment 'animal', examine each mask
    (accept the first, reject the rest), select masks [1, 7] (7 is dropped);
    report no mask where a step leaves none."""

    def __init__(self):
        self.checks = 0

    def __call__(self, messages):
        if "verification" in messages[0]["content"]:
            self.checks += 1
            return "<verdict>Accept</verdict>" if self.checks == 1 else "<verdict>Reject</verdict>"
        last = [c["text"] for m in messages if isinstance(m.get("content"), list)
                for c in m["content"] if isinstance(c, dict) and c.get("type") == "text"][-1]
        if "user query is" in last:
            return '<tool>{"name": "segment_phrase", "parameters": {"text_prompt": "animal"}}</tool>'
        if "segment_phrase produced" in last:
            return '<tool>{"name": "examine_each_mask", "parameters": {}}</tool>'
        if "remain" in last:
            return ('<tool>{"name": "select_masks_and_return", "parameters": '
                    '{"final_answer_masks": [1, 7]}}</tool>')
        return '<tool>{"name": "report_no_mask", "parameters": {}}</tool>'


def refine_llm(messages):
    """SegmentationAgent's MLLM, scripted: 'dog', then 'a yellow dog' while
    a phrase finds nothing, else done."""
    last = messages[-1]["content"]
    if "Goal" in last:
        return json.dumps({"phrase": "dog"})
    if ": 0 detections" in last:
        return json.dumps({"phrase": "a yellow dog"})
    return json.dumps({"done": True, "best_phrase": "a yellow dog"})


def eval_phase(smi, new_launches, pcs_ref):
    """Phase 18: the evaluation stack and the agent on the card. EV-M
    1008^2 (bf16, MobileCLIP-S0 at context 32, seed 0) grounds each (image,
    query) pair of a shapes fixture through run_gold_inference; the raw
    ground outputs, still on the card, go through eval.postprocess_image
    into COCO records, then evaluate_cgf1_files and CocoMAPEvaluator; the
    oracle's records through the same must score >= EVAL_ORACLE_MIN; the
    card's postprocessing held against a CPU copy's. Box-prompt mIoU over
    the fixture with amg_predictor's InteractiveImagePredictor. Phase 7's
    exact PCS session scored against its seeded squares (HOTA, TETA, J&F;
    the ground truth against itself must give 1). The tool-loop agent and
    SegmentationAgent over the port's Sam3Processor with scripted MLLMs.
    eval.distributed at world size 1. Launches asserted per ground (6 / 27
    / 6) and added to ``new_launches``; returns no row."""
    import gzip
    import tempfile

    import numpy as np
    import torch

    from efficientsam3_tpu_torch.agent import SegmentationAgent, agent_inference
    from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
    from efficientsam3_tpu_torch.eval import distributed
    from efficientsam3_tpu_torch.eval.coco_format import CocoDataset, ann_to_mask, rle_to_mask
    from efficientsam3_tpu_torch.eval.coco_map import CocoMAPEvaluator
    from efficientsam3_tpu_torch.eval.eval_coco import evaluate_box_prompt_miou
    from efficientsam3_tpu_torch.eval.fixtures import make_shapes_fixture, oracle_predict_fn
    from efficientsam3_tpu_torch.eval.gold import evaluate_cgf1_files, run_gold_inference
    from efficientsam3_tpu_torch.eval.postprocess import postprocess_image, postprocess_video
    from efficientsam3_tpu_torch.eval.video_eval import evaluate_video_predictions
    from efficientsam3_tpu_torch.ops import depthwise as dw
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.ops import layer_norm as ln
    from efficientsam3_tpu_torch.ops.interpolate import resize_bilinear
    from efficientsam3_tpu_torch.processor import Sam3Processor

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    counters = {"flash_sdpa": fa, "flash_memattn": fa, "flash_memattn_q8": fa,
                "flash_xattn_rpb": fa, "layer_norm": ln, "depthwise_conv2d": dw}

    def reset():
        for name, mod in counters.items():
            getattr(mod, name).launches = 0

    def grounds(what):
        """The grounds since reset(), from the launches, each asserted at
        MAIN_COUNTS and added to new_launches."""
        got = {name: getattr(mod, name).launches for name, mod in counters.items()}
        n = got["flash_xattn_rpb"] // MAIN_COUNTS["flash_xattn_rpb"]
        want = {k: n * MAIN_COUNTS.get(k, 0) for k in counters}
        if got != want or n == 0:
            raise AssertionError(f"[eval] {what}: launches {got}, want {n} grounds' {want}")
        for k, v in got.items():
            if v:
                new_launches[k] = new_launches.get(k, 0) + v
        return n

    model = build_efficientsam3_image_model(
        backbone_type="efficientvit", model_name="b1", text_encoder_type="MobileCLIP-S0",
        text_encoder_context_length=32, dtype=torch.bfloat16, device=dev, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        bpe = os.path.join(tmp, "vocab.txt.gz")
        with gzip.open(bpe, "wt") as f:
            f.write(EVAL_BPE)
        proc = Sam3Processor(model, resolution=1008, context_length=32, bpe_path=bpe)
        tokenizer = proc.tokenizer  # read while the file is there
    images, gt, pairs = make_shapes_fixture(num_images=EVAL_IMAGES, size=EVAL_SIZE, seed=3)
    hw = (EVAL_SIZE, EVAL_SIZE)

    def load(info):
        return images[info["image_index"]]

    # ---- a. the gold path: ground -> postprocess_image on the card -> metrics
    raw, pair_ms = {}, []

    def predict(img, phrase, pair_id):
        reset()
        t0 = time.perf_counter()
        state = proc.set_image(img)
        with torch.inference_mode():
            tm, tmask = proc.encode_tokens(tokenizer([phrase], 32))
            out = model.ground(state["image_feats"]["fpn"], state["image_feats"]["pos"], tm,
                               tmask, proc._empty_prompt())
        records = postprocess_image(out, pair_id, orig_hw=img.shape[:2])
        pair_ms.append((time.perf_counter() - t0) * 1e3)
        grounds(f"pair {pair_id}")
        raw[pair_id] = out
        return records

    def metrics(records):
        cg = evaluate_cgf1_files(records, [gt], iou_type="segm")
        by_pair = {}
        for a in gt["annotations"]:
            by_pair.setdefault(a["image_id"], []).append(a)
        ev = CocoMAPEvaluator("segm")
        for pair_id, _, _ in pairs:
            recs = [r for r in records if r["image_id"] == pair_id]
            gts = [ann_to_mask(a, *hw) for a in by_pair.get(pair_id, [])]
            if not recs and not gts:
                continue
            ev.add_image(1, [r["score"] for r in recs],
                         np.stack([ann_to_mask(r, *hw) for r in recs]) if recs
                         else np.zeros((0, *hw), bool),
                         np.stack(gts) if gts else np.zeros((0, *hw), bool))
        return cg, ev.summarize()

    records = run_gold_inference(predict, gt, load)
    cg, ap = metrics(records)
    for k in ("cgF1", "IL_MCC", "positive_micro_F1"):
        if not np.isfinite(cg[k]):
            raise AssertionError(f"[eval] model's {k} is not finite: {cg}")
    cg_o, ap_o = metrics(run_gold_inference(oracle_predict_fn(images, gt), gt, load))
    if not (cg_o["cgF1"] >= EVAL_ORACLE_MIN and ap_o["AP"] >= EVAL_ORACLE_MIN):
        raise AssertionError(f"[eval] the oracle scores cgF1 {cg_o['cgF1']}, AP {ap_o['AP']}")
    log(f"[eval] gold path: {len(pairs)} (image, query) pairs of {EVAL_SIZE}^2 shapes, "
        f"{len(records)} records (top 100 a pair); model (random weights: the values mean "
        f"nothing): cgF1 {cg['cgF1']:.4f} IL_MCC {cg['IL_MCC']:.4f} mask AP {ap['AP']:.4f}; "
        f"oracle: cgF1 {cg_o['cgF1']:.4f} IL_MCC {cg_o['IL_MCC']:.4f} mask AP {ap_o['AP']:.4f}")
    log(f"[eval] gold ms a pair (set_image + text + ground + postprocess_image, host clock): "
        f"first {pair_ms[0]:.1f}, median {statistics.median(pair_ms):.1f} over {len(pair_ms)} | "
        f"{smi}")

    # the card's postprocessing against the same function on a CPU copy
    flipped = compared = 0
    for pair_id, out in raw.items():
        cpu = {k: out[k].cpu() for k in GROUND_KEYS}
        want = postprocess_image(cpu, pair_id, orig_hw=hw)
        got = [r for r in records if r["image_id"] == pair_id]
        if len(got) != len(want):
            raise AssertionError(f"[eval] pair {pair_id}: {len(got)} records on the card, "
                                 f"{len(want)} on the CPU")
        scores = torch.sigmoid(cpu["pred_logits"][0, :, 0].double()).numpy()
        order = np.argsort(-scores)  # record i is query order[i] (presence scales all alike)
        for i, (g, w) in enumerate(zip(got, want)):
            if g["score"] != w["score"] or g["bbox"] != w["bbox"]:
                raise AssertionError(f"[eval] pair {pair_id} record {i}: {g['score']} "
                                     f"{g['bbox']} on the card, {w['score']} {w['bbox']} on the CPU")
            diff = rle_to_mask(g["segmentation"]) != rle_to_mask(w["segmentation"])
            compared += diff.size
            if diff.any():
                logit = resize_bilinear(cpu["pred_masks"][0, order[i]].float()[None, None], hw)
                near = np.abs(logit[0, 0].numpy()[diff])
                if not (near < EVAL_BAND).all():
                    raise AssertionError(f"[eval] pair {pair_id} record {i}: a mask pixel "
                                         f"differs with the CPU's logit at {near.max()}")
                flipped += int(diff.sum())
    if flipped > EVAL_FLIP_SHARE * compared:
        raise AssertionError(f"[eval] {flipped} of {compared} mask pixels differ")
    log(f"[eval] postprocess_image on the card vs a CPU copy of the same outputs: scores and "
        f"boxes equal, {flipped} of {compared} mask pixels differ (each within {EVAL_BAND} of "
        f"0 in the CPU's upsampled logit)")

    # ---- b. box-prompt mIoU over the fixture's annotations
    image_m, core = amg_models(torch.bfloat16, dev)
    pred = amg_predictor(image_m, core)
    data = CocoDataset(gt)
    evaluate_box_prompt_miou(pred, data, load, max_images=1)  # warm-up
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    miou = evaluate_box_prompt_miou(pred, data, load)
    miou_ms = (time.perf_counter() - t0) * 1e3 / max(miou["num_images"], 1)
    got = {name: getattr(mod, name).launches for name, mod in counters.items()}
    if any(got.values()) or not (0.0 <= miou["miou"] <= 1.0):
        raise AssertionError(f"[eval] box-prompt mIoU {miou}, launches {got} (want none)")
    log(f"[eval] box-prompt mIoU (InteractiveImagePredictor over the EV-M tracker, bf16): "
        f"{miou['miou']:.4f} over {miou['num_instances']} instances in {miou['num_images']} "
        f"images, {miou_ms:.1f} ms an image | {smi}")
    del image_m, core, pred

    # ---- c. the exact PCS session against its seeded squares
    side = pcs_ref["outs"][0]["masks"].shape[-1]
    idx = ((np.arange(side) + 0.5) * 1008 / side).astype(int)  # nearest source pixel
    truth = [{"obj_ids": list(range(PCS_OBJECTS)), "masks": pcs_squares(t)[0][:, idx][:, :, idx]}
             for t in range(N_FRAMES)]
    emitted = [{"obj_ids": list(o["obj_ids"]), "masks": o["masks"]} for o in pcs_ref["outs"]]
    vm = evaluate_video_predictions(emitted, truth)
    self_m = evaluate_video_predictions(truth, truth)
    if abs(self_m["HOTA"] - 1) > 1e-9 or abs(self_m["J&F"] - 1) > 1e-9:
        raise AssertionError(f"[eval] the ground truth against itself: {self_m}")
    tracks = postprocess_video(pcs_ref["outs"], video_id=0)
    if (sorted(r["track_id"] for r in tracks) != list(range(PCS_OBJECTS))
            or any(len(r["segmentations"]) != N_FRAMES for r in tracks)):
        raise AssertionError(f"[eval] postprocess_video: {len(tracks)} tracks")
    log(f"[eval] video PCS (phase 7's exact session, {N_FRAMES} frames at {side}^2) against its "
        f"seeded squares: HOTA {vm['HOTA']:.4f} TETA {vm['TETA']:.4f} J&F {vm['J&F']:.4f}; the "
        f"ground truth against itself HOTA {self_m['HOTA']} J&F {self_m['J&F']}; "
        f"postprocess_video: {len(tracks)} tracks of {N_FRAMES} frames")

    # ---- d. the agents over the port's Sam3Processor
    scene = images[0]
    reset()
    state = proc.set_image(scene)
    proc.confidence_threshold = 0.0
    s = np.sort(proc.set_text_prompt("animal", state)["scores"])[::-1]
    proc.confidence_threshold = float(s[2] + s[3]) / 2  # 'animal' keeps 3 masks
    grounds("the threshold's calibration")
    reset()
    t0 = time.perf_counter()
    llm = ScriptedAgentLLM()
    messages, final, rendered = agent_inference(scene, "the red square", llm, processor=proc)
    tool_ms = (time.perf_counter() - t0) * 1e3
    n_tool = grounds("agent_inference")
    if len(final["masks"]) != 1 or final["masks"][0].shape != hw or rendered.shape != scene.shape:
        raise AssertionError(f"[eval] agent_inference ended with {len(final['masks'])} masks")
    reset()
    t0 = time.perf_counter()
    result = SegmentationAgent(proc, refine_llm, max_iterations=5).run(scene, "a yellow dog")
    refine_ms = (time.perf_counter() - t0) * 1e3
    n_refine = grounds("SegmentationAgent")
    if result is None or result.masks.shape[1:] != hw:
        raise AssertionError(f"[eval] SegmentationAgent ended with {result}")
    log(f"[eval] agent_inference (scripted MLLM, threshold {proc.confidence_threshold:.4f}: "
        f"segment, examine {llm.checks} masks, select): {len(final['masks'])} mask, "
        f"{n_tool} ground calls, {len(messages)} messages, {tool_ms:.1f} ms; SegmentationAgent: "
        f"phrase '{result.phrase}' with {len(result.scores)} detections after "
        f"{result.iterations} iterations, {n_refine} ground calls, {refine_ms:.1f} ms | {smi}")

    # ---- e. eval.distributed at world size 1 (no process group)
    x = np.arange(6.0).reshape(2, 3)
    if (torch.distributed.is_initialized() or distributed.shard_for_process(pairs) != pairs
            or distributed.all_gather_array(x) is not x):
        raise AssertionError("[eval] eval.distributed at world size 1")
    log(f"[eval] eval.distributed without a process group: rank 0 of 1, shard keeps all "
        f"{len(pairs)} pairs, all_gather_array returns its input")
    log(f"[eval] phase wall time {time.perf_counter() - t_phase:.1f} s")
    del model, proc, raw
    torch.cuda.empty_cache()
    return []


PAR_STEPS = 2  # Stage-3 steps with and without the dp mesh
PAR_FRAMES = 4  # frames of the object-parallel tracking (3 tracked) and of the detection
PAR_PROMPTS = ((1, dict(box=[100, 150, 400, 520])), (2, dict(points=[[700, 300]], labels=[1])),
               (3, dict(points=[[500, 800], [560, 760]], labels=[1, 0])))
# a batched ground against single ones in bf16: phase 4's bounds (about
# 2^-4 of each output's range), and the share of mask pixels whose sign differs
PAR_BOUNDS = {"pred_boxes": 5e-2, "pred_logits": 2.5e-1, "presence_logit_dec": 2.5e-1}
PAR_MASK_FLIPS = 1e-2
# a tensor-parallel ground (seeded biases) against the unsharded one: 2.3-3.7x
# the largest error an H100 showed at tp=1 and tp=2 (boxes 4.3e-3, logits
# 1.1e-2, presence 8.1e-4; the same bf16 products summed in another order),
# and PAR_MASK_FLIPS (2x 4.9e-3); a row layer's bias added tp times moved
# them by 3.1e-2 / 0.13 / 6.8e-2, never added by 9.1e-2 / 0.20 / 8.8e-2
PAR_TP_BOUNDS = {"pred_boxes": 1e-2, "pred_logits": 3e-2, "presence_logit_dec": 3e-3}
PAR_TP_BIAS_STD = 0.1  # the seeded biases of the sharded scopes (init_parameters zeroes them)
PAR_IOU = 0.98  # object-parallel masks over two ranks against one: [pcs]'s bound
PAR_RANK_TIMEOUT_S = 300


def par_counters():
    """{name: module} of every kernel wrapper the parallel paths launch."""
    from efficientsam3_tpu_torch.ops import depthwise as dw
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.ops import layer_norm as ln

    return {"flash_sdpa": fa, "flash_sdpa_bwd_dq": fa, "flash_sdpa_bwd_dkv": fa,
            "layer_norm": ln, "layer_norm_bwd": ln, "flash_xattn_rpb": fa,
            "flash_memattn": fa, "depthwise_conv2d": dw}


def par_counted(fn):
    """(fn's result, its launches by kernel): the counters are set to 0 just
    before and read just after."""
    import torch

    counters = par_counters()
    for name, mod in counters.items():
        getattr(mod, name).launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: getattr(mod, name).launches for name, mod in counters.items()}


def par_main_inputs():
    """Phase 2's image, token ids and box (the first draw of its seeded rng)."""
    import numpy as np

    image = np.random.default_rng(0).integers(0, 256, (600, 800, 3), dtype=np.uint8)
    tokens = np.zeros((1, 32), np.int64)
    tokens[0, :5] = [49406, 320, 1125, 3309, 49407]
    return image, tokens, [0.45, 0.5, 0.3, 0.4]


def par_image_model():
    import torch

    from efficientsam3_tpu_torch.build import build_efficientsam3_image_model

    return build_efficientsam3_image_model(
        backbone_type="efficientvit", model_name="b1", text_encoder_type="MobileCLIP-S0",
        text_encoder_context_length=32, dtype=torch.bfloat16, device=torch.device("cuda"), seed=0)


def par_tp_model():
    """par_image_model with every bias of the tensor-parallel scopes drawn
    from a seeded normal, so that a bias a sharded layer adds more or less
    than once shows in the ground."""
    import numpy as np
    import torch

    from efficientsam3_tpu_torch.parallel.tensor_parallel import TP_SCOPES

    model = par_image_model()
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.split(".")[0] in TP_SCOPES and name.endswith(".bias"):
                p.copy_(torch.from_numpy(PAR_TP_BIAS_STD * rng.standard_normal(tuple(p.shape))))
    return model


def par_ground(model):
    """One ground through Sam3Processor on phase 2's inputs: (its raw
    outputs, its launches)."""
    from efficientsam3_tpu_torch.processor import Sam3Processor

    image, tokens, box = par_main_inputs()
    proc = Sam3Processor(model, resolution=1008, context_length=32)
    outs = []
    ground = model.ground

    def kept(*a, **kw):
        outs.append(ground(*a, **kw))
        return outs[-1]

    model.ground = kept
    try:
        def run():
            state = proc.set_image(image)
            state["text"] = proc.encode_tokens(tokens)
            return proc.add_geometric_prompt(box, True, state)

        _, launches = par_counted(run)
    finally:
        del model.ground
    return {k: outs[-1][k].float().cpu() for k in GROUND_KEYS}, launches


def par_track(mesh=None):
    """PAR_FRAMES frames of EV-M's tracker (bf16, seed 0, 8 slots, the plain
    path) with [video]'s three objects prompted on frame 0: (the masks of
    each frame, the propagation's launches, its ms)."""
    import numpy as np
    import torch

    from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
    from efficientsam3_tpu_torch.video.predictor import TrackerPredictor

    image, core = build_efficientsam3_video_model(model_name="b1", dtype=torch.bfloat16,
                                                  device=torch.device("cuda"), seed=0)
    frames = np.random.default_rng(7).standard_normal(
        (PAR_FRAMES, 1008, 1008, 3)).astype(np.float32)
    pred = TrackerPredictor(core, image.encode_image, obj_slots=8, cache_memory_kv=False,
                            mesh=mesh)
    state = pred.init_state(frames)
    for obj_id, kw in PAR_PROMPTS:
        pred.add_new_points_or_box(state, 0, obj_id, **kw)
    t0 = time.perf_counter()
    outs, launches = par_counted(
        lambda: [(t, m.float().cpu()) for t, _, m in pred.propagate_in_video(state)])
    return outs, launches, (time.perf_counter() - t0) * 1e3


def par_check_ground(what, got, want, bounds=PAR_BOUNDS):
    """A ground against a reference within ``bounds``; the errors."""
    errs = {k: (got[k] - want[k]).abs().max().item() for k in bounds}
    flips = ((got["pred_masks"] > 0) != (want["pred_masks"] > 0)).float().mean().item()
    for k, tol in bounds.items():
        if not errs[k] <= tol:
            raise AssertionError(f"[parallel] {what}: {k} off by {errs[k]} (bound {tol})")
    if not flips <= PAR_MASK_FLIPS:
        raise AssertionError(f"[parallel] {what}: {flips:.2e} of mask pixels flip sign")
    return dict(errs, mask_flips=flips)


def par_check_launches(what, got, want, n=1):
    """got's counts of want's kernels are n times want's; returns them."""
    got = {k: got[k] for k in want}
    if got != {k: n * v for k, v in want.items()}:
        raise AssertionError(f"[parallel] {what}: launches {got}, want {n} x {want}")
    return got


def par_add_launches(new_launches, got):
    for k, v in got.items():
        if v:
            new_launches[k] = new_launches.get(k, 0) + v


def par_add_tracker_launches(new_launches, got):
    """A plain-path frame's flash_sdpa launches are half self-attention
    (the flash_sdpa_d256 row) and half cross-attention over the bank (the
    flash_sdpa_d256_cross row)."""
    got = dict(got)
    n = got.pop("flash_sdpa")
    par_add_launches(new_launches, dict(got, flash_sdpa_d256=n // 2, flash_sdpa_d256_cross=n // 2))


def par_mask_ious(got, want):
    ious = []
    for (t, g), (_, w) in zip(got, want):
        for o in range(w.shape[0]):
            a, b = g[o] > 0, w[o] > 0
            union = (a | b).sum().item()
            if union:
                ious.append((a & b).sum().item() / union)
    return ious


def parallel_rank(rank, rdzv, work):
    """A rank of [parallel]'s world of two on one card: gloo, whose CUDA
    collectives take two processes on one device (NCCL refuses that). The
    tensor-parallel ground at tp=2 and the object-parallel tracking at
    objects=2; results to ``work``/rank<rank>.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    from efficientsam3_tpu_torch import parallel

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + rdzv, rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=PAR_RANK_TIMEOUT_S))
    try:
        model = par_tp_model()
        spec = parallel.tp_param_spec(model)
        parallel.shard_params(model, parallel.make_mesh({"tp": 2}), spec)
        t0 = time.perf_counter()
        out, launches = par_ground(model)
        res = {"tp": dict(out=out, launches=launches, count=parallel.count_sharded(spec),
                          ms=(time.perf_counter() - t0) * 1e3)}
        del model
        torch.cuda.empty_cache()
        outs, launches, ms = par_track(parallel.make_mesh({"objects": 2}))
        res["objects"] = dict(outs=outs, launches=launches, ms=ms)
        torch.save(res, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def parallel_phase(smi, new_launches):
    """Phase 19: the multi-GPU layer on the card. A one-rank NCCL group (a
    file:// rendezvous in a temporary directory): PAR_STEPS Stage-3 steps
    of EV-M 1008^2 (bf16, batch 4, as [train]) through Trainer with a dp
    mesh of 1 against the same steps without one (after each step the
    metrics, grad_norm among them, and every parameter and statistic bit
    for bit; launches a step as [train]); the ground
    of phase 2 on par_tp_model under shard_params at tp=1 (246 sharded
    leaves; 6 / 27 / 6 launches; against the unsharded ground within
    PAR_TP_BOUNDS); PAR_FRAMES frames of EV-M's tracker on an objects mesh
    (VIDEO_COUNTS["B"] a tracked frame; masks equal to the unmeshed plain
    path's); PAR_FRAMES frames through frame_parallel against single
    grounds. Then a world of two on the one card over gloo (two processes
    of this script): tp=2 and objects=2 against the same references.
    Launches go to ``new_launches``; returns no row."""
    import itertools
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from efficientsam3_tpu_torch import parallel
    from efficientsam3_tpu_torch.models.geometry import Prompt
    from efficientsam3_tpu_torch.train import stage3
    from efficientsam3_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    walls = {}
    tmp = tempfile.TemporaryDirectory()
    dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp.name, "rdzv"),
                            rank=0, world_size=1)
    try:
        # ---- data-parallel Stage 3 at dp=1 against the unmeshed steps
        batch = stage3_batch(TRAIN_BATCH, 32, dev)

        def train(mesh):
            torch.manual_seed(0)  # the dropout bits, the same in every run
            model = par_image_model()
            opt = stage3.make_stage3_optimizer(stage3.Stage3Config(), model)
            per = []

            def step(m, o, b):
                metrics, got = par_counted(lambda: stage3.stage3_train_step(m, o, b))
                per.append(({k: float(v) for k, v in metrics.items()}, got,
                            {k: v.detach().clone() for k, v in m.state_dict().items()}))
                return metrics

            t0 = time.perf_counter()
            Trainer(step, TrainerConfig(max_steps=PAR_STEPS, log_every=1, mesh=mesh,
                                        handle_preemption_signals=False)).run(
                model, opt, itertools.repeat(batch))
            ms = (time.perf_counter() - t0) * 1e3
            del model, opt
            torch.cuda.empty_cache()
            return per, ms

        ref, _ = train(None)
        dp, walls["dp_steps"] = train(parallel.make_mesh({"dp": 1}))
        if len(dp) != PAR_STEPS:
            raise AssertionError(f"[parallel] dp=1: {len(dp)} steps, want {PAR_STEPS}")
        # the backward adds without atomics and the Trainer takes cuDNN's
        # deterministic algorithms, so a mesh of one rank (no gradient mean
        # to take) leaves every step's bits: metrics (grad_norm too), every
        # parameter and statistic
        for i, ((m_ref, _, s_ref), (m_dp, got, s_dp)) in enumerate(zip(ref, dp)):
            if not all(math.isfinite(v) for v in m_dp.values()):
                raise AssertionError(f"[parallel] dp=1 step {i + 1}: {m_dp}")
            differ = sorted(k for k in m_ref.keys() | m_dp.keys()
                            if m_ref.get(k) != m_dp.get(k))
            differ += sorted(k for k, v in s_ref.items() if not torch.equal(v, s_dp[k]))
            if differ:
                raise AssertionError(f"[parallel] dp=1 step {i + 1}: {len(differ)} metrics or "
                                     f"state tensors differ from the unmeshed step's, e.g. "
                                     f"{differ[:6]}")
            par_add_launches(new_launches, par_check_launches(f"dp step {i + 1}", got,
                                                              TRAIN_COUNTS))
        log(f"[parallel] dp=1 Trainer, {PAR_STEPS} Stage-3 steps (EV-M 1008^2, bf16, batch "
            f"{TRAIN_BATCH}): after each step the loss, its {len(ref[0][0]) - 2} parts, "
            f"grad_norm ({dp[0][0]['grad_norm']} at step 1) and all {len(ref[0][2])} parameter "
            f"and statistic tensors bit for bit as without the mesh (one rank: no gradient mean "
            f"to take); launches a step { {k: dp[0][1][k] for k in TRAIN_COUNTS} }; "
            f"{walls['dp_steps']:.1f} ms for the dp run")
        del ref, dp, batch
        torch.cuda.empty_cache()

        # ---- tensor-parallel ground at tp=1 against the unsharded one
        model = par_tp_model()
        want, _ = par_ground(model)
        spec = parallel.tp_param_spec(model)
        if parallel.count_sharded(spec) != 246:
            raise AssertionError(f"[parallel] {parallel.count_sharded(spec)} sharded leaves, want 246")
        parallel.shard_params(model, parallel.make_mesh({"tp": 1}), spec)
        t0 = time.perf_counter()
        got, launches = par_ground(model)
        walls["tp_ground"] = (time.perf_counter() - t0) * 1e3
        par_add_launches(new_launches, par_check_launches("tp=1 ground", launches, MAIN_COUNTS))
        errs = par_check_ground("tp=1 ground", got, want, PAR_TP_BOUNDS)
        log(f"[parallel] tp=1 ground (shard_params, 246 sharded leaves, seeded biases): launches "
            f"{launches}, against the unsharded ground {errs}; {walls['tp_ground']:.1f} ms")

        # ---- frame-parallel detection against single grounds
        frames = torch.from_numpy(np.random.default_rng(17).standard_normal(
            (PAR_FRAMES, 1008, 1008, 3)).astype(np.float32)).to(dev)
        _, tokens, _ = par_main_inputs()
        tokens = torch.from_numpy(tokens).to(dev)
        detector = par_image_model()

        def detect_batch(f, tok):
            n = f.shape[0]
            with torch.inference_mode():
                return detector(f, tok.expand(n, -1), Prompt.empty(n, 8, 8, device=dev))

        fp = parallel.frame_parallel(detect_batch, parallel.make_mesh({"frames": 1}))
        t0 = time.perf_counter()
        gathered, launches = par_counted(lambda: fp(frames, tokens))
        walls["frames"] = (time.perf_counter() - t0) * 1e3
        par_add_launches(new_launches, par_check_launches(
            f"frame_parallel over {PAR_FRAMES} frames", launches, MAIN_COUNTS))
        ferrs = []
        for i in range(PAR_FRAMES):
            one = detect_batch(frames[i:i + 1], tokens)
            ferrs.append(par_check_ground(
                f"frame {i}", {k: gathered[k][i:i + 1].float().cpu() for k in GROUND_KEYS},
                {k: one[k].float().cpu() for k in GROUND_KEYS}))
        log(f"[parallel] frame_parallel over {PAR_FRAMES} frames (one batched call at frames=1): "
            f"launches {launches}; against {PAR_FRAMES} single grounds, worst "
            f"{ {k: max(e[k] for e in ferrs) for k in ferrs[0]} }; {walls['frames']:.1f} ms")
        del model, detector, frames, gathered
        torch.cuda.empty_cache()

        # ---- object-parallel tracking at objects=1 against the unmeshed plain path
        plain, _, _ = par_track()
        torch.cuda.empty_cache()
        outs, launches, walls["objects"] = par_track(parallel.make_mesh({"objects": 1}))
        tracked = PAR_FRAMES - 1
        par_add_tracker_launches(new_launches, par_check_launches(
            "objects=1 tracking", launches, VIDEO_COUNTS["B"], tracked))
        for (t, m), (_, w) in zip(outs, plain):
            if not torch.equal(m, w):
                raise AssertionError(f"[parallel] objects=1 frame {t}: masks differ from the "
                                     f"unmeshed plain path's by {(m - w).abs().max().item()}")
        log(f"[parallel] objects=1 tracking, {PAR_FRAMES} frames ({tracked} tracked, 8 slots, 3 "
            f"objects): launches {launches}, masks equal to the unmeshed plain path's; "
            f"{walls['objects']:.1f} ms")
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # ---- a world of two on the one card (gloo)
    try:
        rdzv = os.path.join(tmp.name, "rdzv2")
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank",
                                   str(r), rdzv, tmp.name], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=PAR_RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        walls["world2"] = (time.perf_counter() - t0) * 1e3
        write_out("parallel_ranks.txt", "\n".join(logs))
        if [p.returncode for p in procs] != [0, 0]:
            raise AssertionError(f"[parallel] world of two: exit codes "
                                 f"{[p.returncode for p in procs]}\n{logs[0][-3000:]}")
        ranks = [torch.load(os.path.join(tmp.name, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    finally:
        tmp.cleanup()
    for r, res in enumerate(ranks):
        tp = res["tp"]
        if tp["count"] != 246:
            raise AssertionError(f"[parallel] rank {r}: {tp['count']} sharded leaves")
        tp_launches = par_check_launches(f"rank {r} tp=2 ground", tp["launches"], MAIN_COUNTS)
        errs = par_check_ground(f"rank {r} tp=2 ground", tp["out"], want, PAR_TP_BOUNDS)
        ob = res["objects"]
        ob_launches = par_check_launches(f"rank {r} objects=2 tracking", ob["launches"],
                                         VIDEO_COUNTS["B"], PAR_FRAMES - 1)
        ious = par_mask_ious(ob["outs"], plain)
        if not ious or min(ious) <= PAR_IOU:
            raise AssertionError(f"[parallel] rank {r} objects=2: mask IoUs {ious}")
        par_add_launches(new_launches, tp_launches)
        par_add_tracker_launches(new_launches, ob_launches)
        log(f"[parallel] world of two on one card (gloo), rank {r}: tp=2 ground (4 of 8 heads "
            f"a rank) launches {tp['launches']}, against the unsharded ground {errs}, "
            f"{tp['ms']:.1f} ms; objects=2 tracking (4 of 8 slots a rank) launches "
            f"{ob['launches']}, mask IoU against one rank's min {min(ious):.4f}, "
            f"{ob['ms']:.1f} ms")
    log(f"[parallel] {smi}; wall ms: {walls}")
    return []


CLI_SIZE = 256  # the fixtures' image side (the CLIs resize to their models' 1008)
CLI_FRAMES = 6
CLI_MASK_SIDE = 288  # the video pipeline's masks at 1008^2
CLI_OVERFIT = ("--steps", "100", "--heads-steps", "30", "--scan", "50")
# the shortened overfit run's loss must fall to this share of its first
# step's (0.018-0.021 measured over 100 steps on an H100 80GB HBM3)
CLI_LOSS_FALL = 0.25
CLI_ORACLE_MIN = 0.9999
CLI_EMBED_ULP = 2.0 ** -7 + 2.0 ** -11  # a bf16 ulp and the record's fp16 rounding


def cli_counters():
    """{name: module} of every kernel wrapper an entry point may launch."""
    from efficientsam3_tpu_torch.ops import depthwise as dw
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.ops import layer_norm as ln

    return dict(par_counters(), depthwise_conv2d_bwd=dw, flash_memattn_q8=fa, split_parts=fa)


def cli_red_squares(frame):
    """The red squares of a normalised frame as a detector's outputs."""
    import numpy as np
    from scipy import ndimage

    rgb = (np.asarray(frame) * 0.5 + 0.5) * 255
    lab, n = ndimage.label((rgb[..., 0] > 180) & (rgb[..., 1] < 80) & (rgb[..., 2] < 80))
    masks = np.stack([lab == k for k in range(1, n + 1)]) if n else np.zeros((0, *lab.shape), bool)
    boxes = np.asarray([[xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
                        for ys, xs in (np.nonzero(m) for m in masks)], np.float32).reshape(-1, 4)
    return {"masks": masks, "scores": np.full(n, 0.9, np.float32), "boxes": boxes}


def cli_phase(smi, new_launches):
    """Phase 20: [cli] the port's entry points, each ``main(argv)`` called
    in this process on the card (``--device`` left at its default, cuda),
    on files written under a temp dir: the shapes fixture as a COCO json
    with PNGs, a 6-frame video folder with its ground truth, and the
    synthetic byte-level BPE file (``EFFICIENTSAM3_BPE_PATH``). Models at
    the scripts' defaults: EV-M at 1008^2 with MobileCLIP-S0 at 32, seeded.
    The counters are set to 0 just before each entry point and read just
    after; each prints one JSON line (wall s, launches, key outputs) and
    its own output goes to chiprun_out/cli_<name>.log. train_stage3's
    launches (TRAIN_COUNTS a step) and the bf16 examples' grounds
    (MAIN_COUNTS each: 3 image_predictor, 4 batch_processor, 7
    video_pcs: a frame's and the text prompt's) are added to the kernels'
    rows."""
    import contextlib
    import gzip
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from efficientsam3_tpu_torch import build
    from efficientsam3_tpu_torch.eval.fixtures import make_shapes_fixture
    from efficientsam3_tpu_torch.examples import (
        agent_example, batch_processor_example, edge_sam_example, image_predictor_example,
        sam1_task_example, video_pcs_example, video_tracking_example)
    from efficientsam3_tpu_torch.scripts import (
        _common, data_engine, eval_coco, eval_quality, eval_video, save_embedding_image_stage1,
        standalone_cgf1, train_image_encoder_stage1, train_overfit_quality, train_stage3,
        verify_checkpoint)
    from efficientsam3_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    t_phase = time.perf_counter()
    counters = cli_counters()
    lines = []

    def run(name, fn, want=None, some=(), **show):
        """fn's result; the launches of its run checked: exactly ``want``
        where given (0 for a kernel it does not name), else at least one
        launch of each kernel in ``some``."""
        for k, mod in counters.items():
            getattr(mod, k).launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        write_out(f"cli_{name}.log", out.getvalue())
        got = {k: getattr(mod, k).launches for k, mod in counters.items()}
        if want is not None and got != {k: want.get(k, 0) for k in counters}:
            raise AssertionError(f"[cli] {name}: launches {got}, want {want}")
        if any(got[k] == 0 for k in some):
            raise AssertionError(f"[cli] {name}: launches {got}, want some of each of {some}")
        line = {"cli": name, "wall_s": round(wall, 3),
                "launches": {k: v for k, v in got.items() if v}}
        line.update(show_fn(result) if (show_fn := show.get("show")) else {})
        log(json.dumps(line))
        lines.append(line)
        return result

    memo = {}

    def cached(builder):
        """The builder's model, built once for each set of arguments (the
        examples and the evaluation scripts build the same models)."""
        def build_once(**kw):
            key = (builder.__name__, tuple(sorted((k, str(v)) for k, v in kw.items())))
            if key not in memo:
                memo[key] = builder(**kw)
            return memo[key]
        return build_once

    patched = [(m, "build_efficientsam3_image_model", cached(build.build_efficientsam3_image_model))
               for m in (image_predictor_example, batch_processor_example, agent_example)]
    patched += [(m, "build_efficientsam3_video_model", cached(build.build_efficientsam3_video_model))
                for m in (sam1_task_example, video_tracking_example, video_pcs_example,
                          eval_video, eval_coco)]
    real_detector = eval_video.make_detector

    def squares_detector(proc, text_state):
        detect = real_detector(proc, text_state)

        def detector(frame, ts):
            detect(frame, ts)  # the seeded detector grounds every frame ...
            return cli_red_squares(frame)  # ... and the tracker follows the red squares
        return detector

    patched.append((eval_video, "make_detector", squares_detector))
    saved = [(m, n, getattr(m, n)) for m, n, _ in patched]
    tmp = tempfile.mkdtemp(prefix="cli_")
    old_bpe = os.environ.get("EFFICIENTSAM3_BPE_PATH")
    try:
        for m, n, v in patched:
            setattr(m, n, v)
        os.environ["EFFICIENTSAM3_BPE_PATH"] = _common.write_byte_level_bpe(
            os.path.join(tmp, "bpe.txt.gz"))
        coco = _common.write_shapes_coco(os.path.join(tmp, "coco"), num_images=4,
                                         size=CLI_SIZE)
        images_dir = os.path.dirname(coco)
        videos = _common.write_video_fixture(os.path.join(tmp, "video"), frames=CLI_FRAMES,
                                             size=CLI_SIZE, mask_side=CLI_MASK_SIDE)
        frames_dir = os.path.join(tmp, "video", "frames")

        # ---- the overfit-to-quality proof, shortened, and its evaluation
        out = os.path.join(tmp, "overfit")
        summary = run("train_overfit_quality", lambda: train_overfit_quality.main(
            ["--out", out, *CLI_OVERFIT]),
            show=lambda r: {k: r[k] for k in ("loss_first", "loss_last", "heads_loss_first",
                                              "heads_loss_last", "detector_s")})
        if not (summary["loss_last"] <= CLI_LOSS_FALL * summary["loss_first"]
                and summary["heads_loss_last"] < summary["heads_loss_first"]):
            raise AssertionError(f"[cli] the overfit run's losses did not fall: {summary}")
        qpath = os.path.join(tmp, "quality.json")
        quality = run("eval_quality", lambda: eval_quality.main(["--trained", out, "--out", qpath]),
                      some=("flash_xattn_rpb", "layer_norm"),
                      show=lambda r: {"oracle_cgF1": r["harness_oracle"]["perfect"]["cgF1"],
                                      **{k: r["model"][k] for k in (
                                          "cgF1", "IL_MCC", "mask_AP", "box_prompt_miou")}})
        model_q = quality["model"]
        if not (quality["harness_oracle"]["perfect"]["cgF1"] >= CLI_ORACLE_MIN
                and all(0.0 <= model_q[k] <= 1.0 for k in ("cgF1", "mask_AP", "box_prompt_miou"))):
            raise AssertionError(f"[cli] eval_quality: {quality}")
        gt_path = os.path.join(tmp, "fixture_gt.json")
        with open(gt_path, "w") as f:
            json.dump(make_shapes_fixture(**train_overfit_quality.FIXTURE)[1], f)
        cg = run("standalone_cgf1", lambda: standalone_cgf1.main(
            ["--pred_file", os.path.join(tmp, "quality_records.json"), "--gt_files", gt_path]),
            want={}, show=lambda r: {"cgF1": r["cgF1"]})
        if abs(cg["cgF1"] - model_q["cgF1"]) > 1e-9:
            raise AssertionError(f"[cli] standalone_cgf1 {cg['cgF1']} vs eval_quality "
                                 f"{model_q['cgF1']} on the same records")

        # ---- checkpoints: the overfit detector, a NaN copy, a wrong-shape copy
        det = os.path.join(out, "detector")
        vargs = ["--model-name", "b0", "--context-length", "16"]
        codes = {"good": run("verify_checkpoint", lambda: verify_checkpoint.main(
            ["--ckpt-dir", det, *vargs]), want={}, show=lambda r: {"exit": r})}
        state, step = load_checkpoint(det)
        name = next(k for k in state["params"] if k.startswith("trunk"))
        for case in ("nan", "shape"):
            bad = dict(state, params=dict(state["params"]))
            p = bad["params"][name].clone()
            if case == "nan":
                p.view(-1)[0] = float("nan")
            else:
                p = torch.zeros(p.shape[0] + 1, *p.shape[1:])
            bad["params"][name] = p
            path = os.path.join(tmp, f"ckpt_{case}")
            save_checkpoint(path, step, bad)
            codes[case] = run(f"verify_checkpoint_{case}", lambda: verify_checkpoint.main(
                ["--ckpt-dir", path, *vargs]), want={}, show=lambda r: {"exit": r})
        if codes != {"good": 0, "nan": 1, "shape": 1}:
            raise AssertionError(f"[cli] verify_checkpoint exit codes {codes}")

        # ---- Stage 3: 3 steps at batch 4, then one more resumed
        sources = os.path.join(tmp, "sources.json")
        with open(sources, "w") as f:
            json.dump([{"name": "shapes", "ann": coco, "image_root": images_dir}], f)
        s3 = ["--sources", sources, "--batch-size", "4", "--checkpoint-dir",
              os.path.join(tmp, "stage3")]
        steps = run("train_stage3", lambda: train_stage3.main(s3 + ["--max-steps", "3"]),
                    want={k: 3 * v for k, v in TRAIN_COUNTS.items()}, show=lambda r: {"steps": r})
        resumed = run("train_stage3_resume", lambda: train_stage3.main(s3 + ["--max-steps", "4"]),
                      want=TRAIN_COUNTS, show=lambda r: {"steps": r})
        if (steps, resumed) != (3, 4):
            raise AssertionError(f"[cli] train_stage3 reached {steps}, then {resumed}")
        for k, v in TRAIN_COUNTS.items():
            if v:
                new_launches[k] = new_launches.get(k, 0) + 4 * v

        # ---- Stage 1: the ViT-H teacher's export and check, then 2 student steps
        store = os.path.join(tmp, "embeds.bin")
        e1 = ["--images-dir", images_dir, "--store", store]
        run("save_embedding_image_stage1", lambda: save_embedding_image_stage1.main(e1),
            want={"flash_sdpa": 4}, show=lambda r: {"records": r})
        err, mag = run("save_embedding_check", lambda: save_embedding_image_stage1.main(
            e1 + ["--check-saved-embed"]), want={"flash_sdpa": 16},
            show=lambda r: {"max_err": r[0], "max_abs": r[1]})
        if not (0.0 < mag and err <= CLI_EMBED_ULP * mag):
            raise AssertionError(f"[cli] saved embeddings off by {err} (largest {mag})")
        s1 = run("train_image_encoder_stage1", lambda: train_image_encoder_stage1.main(
            e1 + ["--batch-size", "2", "--epochs", "1", "--checkpoint-dir",
                  os.path.join(tmp, "stage1")]), want={}, show=lambda r: {"steps": r})
        if s1 != 2:
            raise AssertionError(f"[cli] train_image_encoder_stage1 reached step {s1}")

        # ---- evaluation on the fixtures
        miou = run("eval_coco", lambda: eval_coco.main(["--ann", coco, "--images-dir",
                                                        images_dir]), want={},
                   show=lambda r: {"miou": r["miou"], "instances": r["num_instances"]})
        vm = run("eval_video", lambda: eval_video.main(
            ["--dataset", videos, "--out", os.path.join(tmp, "veval.json")]),
            some=("flash_sdpa", "flash_xattn_rpb", "layer_norm", "flash_memattn",
                  "depthwise_conv2d"),
            show=lambda r: {"J&F": r["per_video_JF"]["0"]["J&F"], "HOTA": r["HOTA"],
                            "TETA": r["TETA"]})
        for k, v in (("miou", miou["miou"]), ("J&F", vm["per_video_JF"]["0"]["J&F"]),
                     ("HOTA", vm["HOTA"]), ("TETA", vm["TETA"])):
            if not 0.0 <= v <= 1.0:
                raise AssertionError(f"[cli] {k} {v} out of [0, 1]")
        engine = run("data_engine", lambda: data_engine.main(
            ["--ann", coco, "--image-root", images_dir, "--output-root",
             os.path.join(tmp, "pseudo")]), want={}, show=lambda r: r)
        if not (0 < engine["num_images"] <= 4 and engine["num_records"] > 0):
            raise AssertionError(f"[cli] data_engine: {engine}")

        # ---- the examples, at their defaults (bf16 EV-M grounds: MAIN_COUNTS each,
        # added to the kernels' rows)
        def grounds(n):
            for k, v in MAIN_COUNTS.items():
                new_launches[k] = new_launches.get(k, 0) + n * v
            return {k: n * v for k, v in MAIN_COUNTS.items()}

        run("image_predictor_example", lambda: image_predictor_example.main([]),
            want=grounds(3), show=lambda r: {"masks": list(r["masks"].shape)})
        run("batch_processor_example", lambda: batch_processor_example.main([]),
            want=grounds(4), show=lambda r: {"images": len(r["masks"])})
        run("agent_example", lambda: agent_example.main([]),
            some=("flash_sdpa", "flash_xattn_rpb", "layer_norm"),
            show=lambda r: {"final_masks": len(r[1]["masks"])})
        run("edge_sam_example", lambda: edge_sam_example.main([]), want={},
            show=lambda r: {"masks": list(r[0].shape)})
        run("sam1_task_example", lambda: sam1_task_example.main([]), want={},
            show=lambda r: {"amg_masks": len(r[2])})
        run("video_tracking_example", lambda: video_tracking_example.main([]),
            some=("flash_sdpa", "flash_memattn", "layer_norm", "depthwise_conv2d"),
            show=lambda r: {"frames": len(r)})
        run("video_pcs_example", lambda: video_pcs_example.main([frames_dir, "a red square"]),
            want=grounds(CLI_FRAMES + 1), show=lambda r: {"frames": len(r)})
    finally:
        for m, n, v in saved:
            setattr(m, n, v)
        if old_bpe is None:
            os.environ.pop("EFFICIENTSAM3_BPE_PATH", None)
        else:
            os.environ["EFFICIENTSAM3_BPE_PATH"] = old_bpe
        shutil.rmtree(tmp, ignore_errors=True)
        memo.clear()
    write_out("cli_lines.jsonl", "".join(json.dumps(x) + "\n" for x in lines))
    log(f"[cli] {len(lines)} entry-point runs | {smi}")
    log(f"[cli] phase wall time {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return []


def split_parts_check(q, k, v, key_bias, do):
    """The split pass of the fp32 wgmma backward as its wrappers launch it
    (d=256: K and V, the rows of live key tiles, and Q and dO, every row;
    d=32, 64 and 80: Q and dO for the dkv kernel and K and V for the dq
    kernel, every row), held bit for bit to split_parts_plain on the rows
    the kernels read."""
    import torch

    from efficientsam3_tpu_torch.ops import flash_attention as fa

    if q.shape[-1] != 256:
        for name, x in (("q", q), ("do", do), ("k", k), ("v", v)):
            if not torch.equal(fa.split_parts(x).view(torch.int16),
                               fa.split_parts_plain(x).view(torch.int16)):
                raise AssertionError(f"split_parts ({name}, {tuple(x.shape)}) differs from "
                                     f"split_parts_plain")
        log(f"[fp32] split_parts: q, dO {tuple(q.shape)}, k, v {tuple(k.shape)} bit-identical "
            f"to split_parts_plain")
        return
    b, lk, tile = k.shape[0], k.shape[2], fa._WIDE_F32_TILE
    kb, _ = fa._tma_rows(key_bias, fa.NEG_INF)
    nt = -(-lk // tile)
    live = torch.zeros((b, nt * tile), dtype=torch.bool, device=k.device)
    live[:, :lk] = kb[:, :lk] > fa.NEG_INF / 2
    rows = live.reshape(b, nt, tile).any(-1).repeat_interleave(tile, 1)[:, :lk]
    for name, x, args in (("k", k, (kb, tile)), ("v", v, (kb, tile)), ("q", q, ()),
                          ("do", do, ())):
        got = fa.split_parts(x, *args).view(torch.int16)
        want = fa.split_parts_plain(x).view(torch.int16)
        if args:
            sel = rows[None, :, None, :, None].expand_as(got)
            got, want = got[sel], want[sel]
        if not torch.equal(got, want):
            bad = int((got != want).sum().item())
            raise AssertionError(f"split_parts ({name}, {tuple(x.shape)}): {bad} of "
                                 f"{want.numel()} parts differ from split_parts_plain")
        del got, want
    log(f"[fp32] split_parts: k, v ({int(rows.sum().item())} rows of live {tile}-key tiles in "
        f"{b} batch rows), q, dO {tuple(q.shape)} bit-identical to split_parts_plain")


def bwd_rows_fp32(q, k, v, key_bias, o, lse, do, scale, launches, suffix, device, row):
    """The dq and dkv rows of the fp32 backward kernels at captured inputs
    (each row's source the one ``bwd_dq_kernel`` / ``bwd_dkv_kernel``
    names): each held to its plain version at FP32_TOL of the largest
    magnitude (their split pass too, bit for bit: split_parts_check),
    SDPA's fp32 backward (bool key mask) as the library time. The wrappers'
    split passes (two before each kernel) are in their graph and call
    times."""
    import torch
    import torch.nn.functional as F

    from efficientsam3_tpu_torch.ops import flash_attention as fa

    b, h, lq, d = q.shape
    dq, delta = fa.flash_sdpa_bwd_dq(q, k, v, key_bias, o, lse, do, scale)
    want_dq, want_delta = fa.flash_sdpa_bwd_dq_plain(q, k, v, key_bias, o, lse, do, scale)
    err_dq = max(check_rel(f"flash_sdpa_bwd_dq{suffix}_fp32", dq, want_dq, FP32_TOL),
                 check_rel(f"flash_sdpa_bwd_dq{suffix}_fp32 (delta)", delta, want_delta, FP32_TOL))
    dk, dv = fa.flash_sdpa_bwd_dkv(q, k, v, key_bias, do, lse, delta, scale)
    want_dk, want_dv = fa.flash_sdpa_bwd_dkv_plain(q, k, v, key_bias, do, lse, want_delta, scale)
    err_dkv = max(check_rel(f"flash_sdpa_bwd_dkv{suffix}_fp32 (dk)", dk, want_dk, FP32_TOL),
                  check_rel(f"flash_sdpa_bwd_dkv{suffix}_fp32 (dv)", dv, want_dv, FP32_TOL))
    del want_dq, want_dk, want_dv, dq, dk, dv
    if d in fa._SPLIT_D:
        split_parts_check(q, k, v, key_bias, do)
    torch.cuda.empty_cache()
    live = int((key_bias > fa.NEG_INF / 2).sum().item())  # summed over the batch
    scores = h * lq * live
    nb_dq = 4 * (4 * q.numel() + 2 * h * live * d) + 4 * (key_bias.numel() + 2 * lse.numel())
    nb_dkv = 4 * (2 * q.numel() + 4 * h * live * d) + 4 * (key_bias.numel() + 2 * lse.numel())
    bms_dq, by_dq = bound(nb_dq, exps=1.0 * scores, fp32_ops=6.0 * scores,
                          tf32_flops=3 * 2.0 * scores * d)
    bms_dkv, by_dkv = bound(nb_dkv, exps=1.0 * scores, fp32_ops=6.0 * scores,
                            tf32_flops=4 * 2.0 * scores * d)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ol = F.scaled_dot_product_attention(
        ql, kl, vl, attn_mask=(key_bias > fa.NEG_INF / 2)[:, None, None, :], scale=scale)
    lib_ms = cuda_time(lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True), 5)
    del ol, ql, kl, vl
    shape = (f"q {tuple(q.shape)} k/v {tuple(k.shape)} fp32 (dO strided), {live} live keys over "
             f"{b} rows; library = SDPA backward (all three gradients)")
    out = []
    for name, fn, plain, err, bms, by, line, kernel in (
            (f"flash_sdpa_bwd_dq{suffix}_fp32",
             lambda: fa.flash_sdpa_bwd_dq(q, k, v, key_bias, o, lse, do, scale),
             lambda: fa.flash_sdpa_bwd_dq_plain(q, k, v, key_bias, o, lse, do, scale),
             err_dq, bms_dq, by_dq, 1082, fa.bwd_dq_kernel(torch.float32, d)),
            (f"flash_sdpa_bwd_dkv{suffix}_fp32",
             lambda: fa.flash_sdpa_bwd_dkv(q, k, v, key_bias, do, lse, delta, scale),
             lambda: fa.flash_sdpa_bwd_dkv_plain(q, k, v, key_bias, do, lse, delta, scale),
             err_dkv, bms_dkv, by_dkv, 1098, fa.bwd_dkv_kernel(torch.float32, d))):
        out.append(row(name, f"{kernel}.cu", f"flash_attention.py:{line}", launches, err, fn,
                       plain, lib_ms, bms, by, shape, device.get(name)))
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:  # a rank of [parallel]'s world of two
        sys.exit(parallel_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
