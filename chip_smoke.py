#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (implicit_image_tpu_torch) on one
NVIDIA GPU. Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing its own line:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from implicit_image_tpu_torch/csrc/ (seconds);
  3. each kernel against its plain-torch version at the main path's shapes
     (512^2 pixels, SIREN depth 8, width 128) in both precision modes, with
     the tolerances below, and the time of each (CUDA events) beside its
     FLOPs and bound; as controls, the other mode's kernel must fail each
     mode's tolerances, and so must the plain chain run with 1-pass TF32
     products (torch.backends.cuda.matmul.allow_tf32) the fp32 ones. The
     same at width 182 (the finals width, run on the kernels of width 192,
     whose wgmma backward sums dW itself); bounds count the model's width
     (the work the function needs), the padded bound the kernel width (the
     work the kernel does). At every width the forward and the backward run
     twice and must repeat bit for bit.
     K1 over a member axis (sine_mlp_fwd_batched, the vmapped render of
     decode_runs) at widths 128 and 182: 8 SIRENs on one 512² grid in one
     launch, in both modes, each member the bits of its single launch and
     within FWD_TOL of the plain version (the other mode's batched kernel
     outside it), timed in turns with one single launch; its bound is 8
     forwards' work. K2 over a member axis (sine_mlp_bwd_batched, the
     vmapped backward of the batched fit and the ladder) the same way: 8
     SIRENs, one cotangent each, both modes, each member's dx, dW and db the
     bits of its single launch and within BWD_TOL of the plain version (the
     other mode's outside it), timed in turns with one single launch (bound:
     8 backwards' work); its member-axis partial sum alone (the bits of the
     mirror, SUM_TOL of partials.sum(1), timed from CUDA graphs in turns with
     it).
     K1 and K2 over a member axis in "+mixed" (train.mixed_precision, PR
     15) at widths 128 and 182: 8 SIRENs, each member's forward and dx, dW,
     db the bits of its single "+mixed" launch (fp32+mixed and bf16+mixed),
     within phase 12b's mixed limits (the bf16 mode's FWD_TOL and BWD_TOL)
     of the plain "+mixed" chain, and timed in turns with one single launch
     (the kernels line's sine_mlp_fwd_batched+mixed and
     sine_mlp_bwd_batched+mixed rows; their bound counts a.W as one bf16
     pass, the products with the fp32 cotangent as three); bf16+mixed
     against the plain chain too. Phase 2 prints
     ptxas's registers and spills of every kernel and fails if a batched
     instantiation (forward, backward, partial sum) spills more than its
     single launch, if a "+mixed" batched one spills at all, or if any
     instantiation of the wgmma kernels (the forward and backward at widths
     128 and 192) or of the layer-wise kernels spills.
     Above width 192, the layer-wise kernels at 256, 300 (kernel width
     384), 512, 640 and 1024, 512², d8 (300: the pairs, their member axis
     and their autograd form only, its times printed, no kernels-line row:
     no path runs it): K1 and K2 in fp32, bf16, fp32+mixed and bf16+mixed
     against the
     plain chain (LAYER_TOL: fp32 1e-4 / 1e-4, the others 1.5e-3 / 2e-2),
     their launches (depth of sine_mlp_layer_fwd per K1 band, depth - 1
     more in K2's recompute, depth of sine_mlp_layer_bwd, depth - 2 of
     sine_mlp_layer_dw, one sum_partials), bit-for-bit repeats, the other
     mode's kernels failing the fp32 and bf16 limits, and over 2 members
     each member the bits of its single launches; the pair under autograd
     as a fit step runs it (K1 fills the z stash, K2 takes it and launches
     no sine_mlp_layer_fwd), in every mode, single and over 2 members: K1's
     stash the bits of K2's recompute (sine_mlp_layer_stash), out, dx and
     every gradient the API pair's bits; times (CUDA events) of the fp32 and
     bf16 modes beside their bounds, the member-axis launches in turns with
     one single launch, the autograd pair in turns with the API's calls
     beside the bounds of the JAX pair's work and of the port's (K1 writing
     the stash, K2 reading it: `_bounds`); sine_mlp_layer_dw alone on one layer's own dW operands
     against its plain version (DW_TOL), twice for bits, in turns with one
     fp32 torch.mm; one hidden sine_mlp_layer_fwd and one hidden
     sine_mlp_layer_bwd (with and without dW_0) alone on the chain's own
     operands against their plain versions (LAYER_TOL), twice for bits,
     each in turns with one fp32 torch.mm of its product; the first and
     last layers' launches alone (sine_mlp_layer_fwd first and last,
     sine_mlp_layer_bwd last and first: the streaming passes) on the
     chain's own operands in every mode against their plain versions
     (LAYER_TOL), twice for bits, over 2 members each the bits of its
     single launch, the fp32 ones timed from CUDA graphs in turns with
     torch.addmm / torch.mm where one computes the same function, beside
     their bytes bounds (_kind_bounds); fp32 K2's kernels under
     torch.profiler (the API's and under autograd),
     sine_mlp_layer_bwd_kernel by kind beside its bound, and K1's under
     autograd, sine_mlp_layer_fwd_kernel by kind; the backward's partial buffer against its plain mirror
     (siren_chain_layer_partials, at 256) and sum_partials over it bit for
     bit its mirror's order; then one fp32 K1/K2 pair at w2048 (its z stash of
     3.76e9 floats is past 2^31: the 64-bit offsets) and one at w4096 on
     128² rows against the plain chain, with their peak memory;
  4. the dense path through the port's entry points: compress.main
     (masking=none: fit -> k-means finetune -> plain container -> decode) at
     full width, then decompress.decode_run on its run dir. Every kernel of
     the path must have launched during this phase; the decoded PSNR must be
     finite and >= 20 dB, the container exactly the size its shapes imply;
  5. the default path, compress.main with the composed defaults (RigL,
     density 0.5, a mask update every 20 steps: 10 in 200 steps) at the
     same size, then decode_run: every kernel launched, each layer's weight
     count in mask.npz equal to its count at init (RigL without
     redistribution conserves it) while the masks moved, every pruned weight
     exactly 0 in model.npz and in the decoded params, decoded PSNR >= 20 dB,
     the expected container size, decoded MS-SSIM in (0, 1];
  6. short runs of the other masking presets (SNFS, Pruning = GMP,
     Small_Dense at width 57): finite decoded PSNR, every kernel launched,
     the expected container size, and GMP's density below 1 after its first
     update;
  7. two codebook finetunes from phase 5's fit params and masks must agree
     bit for bit (centroids, labels, quant PSNR);
  8. the bench flagship recipe through the entry points at full width:
     compress.main with CoordX s5/w96, RigL at density 0.85,
     train.init_path=auto, quant.delta, quant.row_stride=4 and
     entropy_coding=auto (300 fit + 20 finetune steps, cut from 1200 + 100),
     then decompress.decode_run. The auto-init must pick
     coordx_s5w96_512_tf32.npz, the manifest must carry `delta` with that
     file's sha256, every stream backend must round-trip this run's raw
     payload bit-exactly with the native codecs loaded, the container must
     be the size compress.main returned, and the decoded PSNR finite and
     >= 20 dB. CoordX's products are torch.matmul in fp32 (no Pallas kernel
     lies on this path in the JAX package), so the SIREN kernels must
     launch 0 times in this phase;
  9. the reference's finals operating point for its harder images
     (scripts/finals.sh: img=big_building, SIREN d8/w182, quant.bits=9,
     entropy_coding=zstd, train.multiplier=5, RigL 0.5; 40 x 5 fit + 20
     finetune steps, cut from 2000 x 5 + 100) through compress.main and
     decompress.decode_run: every kernel launched, each layer's RigL weight
     count conserved, the zstd container re-encodes from what it decodes to
     the same bytes, its labels are 9-bit, every quantized weight decodes to
     one of its layer's centroids and every pruned one to 0, decoded PSNR
     finite and >= 20 dB;
 10. the repo's wide SIREN runs through compress.main, all on the
     layer-wise kernels: the d8/w256 member of scripts/width_depth.sh and
     the tracked w512 row of scripts/tracked_r5.sh (lr 1e-4), 20 fit steps
     each (dense, no quantization or container), and `compress.main` with
     mlp.hidden_size=640 and =1024 (dense, lr 1e-4, 20 fit + 20 k-means
     finetune steps, zstd) and decode_run: only the layer-wise kernels and
     sum_partials launch, K2 once a step, K1 fills the z stash once a step
     and never under no_grad (decode_run grows the device memory by less
     than a stash), sine_mlp_layer_fwd launches only in K1 (depth a band:
     K2 recomputes nothing), each layer-wise launch of the kind the chain
     needs (sm.LAUNCHES_BY_KIND: K2's last and first layer once a step, K1's
     first and last once a band; the kernels line's rows of those kinds
     count them), the peak memory is printed, and the fit PSNR (the
     decoded PSNR, decode_run's, where a container is written) is finite;
 11. the reference's other model families at full width (d8/w128, 512²,
     img=synthetic; scripts/run_studies_r5.sh), each through compress.main
     and, where it writes a container, decompress.decode_run: (a)
     wavelet-SIREN dense, k-means, zstd (200 + 20 steps, cut from
     2000 + 100); (b) the same under RigL at density 0.25 (200 + 20, 10
     mask updates); (c) Feathermap at density 0.2 over SIREN, 5x steps,
     zstd (40 x 5 + 20, cut from 2000 x 5 + 100); (d) Fourier features,
     the d8/w128 member of the width x depth grid, no quantization or
     container (200, cut from 2000). First K1/K2 against the plain chain
     at the wavelet's DWT lattice (258² = 66,564 rows, no whole number of
     tiles). K1, K2 and sum_partials launch in (a)-(c), K2 exactly twice
     per fit and finetune step in (a) and (b) (once per sub-SIREN) and once
     in (c); no kernel launches in (d). Decoded PSNR ((d): fit PSNR)
     finite and >= 20 dB ((c): 12 dB, FAMILY_PSNR_FLOOR); (a) and (b)
     re-encode their zstd container from what it decodes to the same
     bytes; (c)'s container holds V1, V2 and the scalers and no codebook;
     (b)'s RigL weight counts are conserved over all 16 layers of both
     sub-SIRENs. Each run prints its ms per fit step.
 12. the fit's options and the last model family, each through
     compress.main (and decode_run where it writes a container) at 512²,
     printing its seconds, PSNR, bytes and launches per mode, its PSNR
     finite and above its floor (P12_FLOOR, from the JAX package's CPU
     runs of the same configurations at 128², tests/phase12_floors.py):
     (a) the precision schedule (train.matmul_precision_early=bfloat16) on
     the RigL default, 200 + 20 steps: K1/K2/sum_partials launch in the bf16
     mode exactly for the planned steps [0, 150) and the eval among them,
     in fp32 for the rest, the finetune and the renders; ms per step of a
     bf16 and an fp32 segment of an 80-step fit beside phase 5's; and a
     20-step d8/w182 fit switching at 0.5 (the width-192 kernels);
     (b) train.mixed_precision, 200 + 20 steps, every launch in the fp32
     mode, after K1/K2 under fp32+mixed against the plain chain at w128 and
     w182 within phase 3's bf16 limits; (c) train.stop_at_psnr=30 with a
     400-step budget and a check every 25 steps: stops early at a boundary,
     one bf16 forward per check; (d) a 100-step RigL fit (a mask update
     every 20) against the same fit stopped at 50 with a checkpoint and
     resumed: model.npz and mask.npz of the same sha256; (e) the tracked
     d8/w512 SIREN at lr 3e-4 with optim.grad_clip=1.0, 20 steps (the
     layer-wise kernels): finite, the clip's scale printed; (f) mlp.fast_sine=false, 200 + 20 steps:
     no kernel launch, ms per step beside phase 4's; (g) CoordX s5/w96 at
     train.matmul_precision=bfloat16, cold, 300 + 20 steps: no kernel
     launch; (h) hashgrid at its default config (quant.skip_layers=[],
     lr 1e-2, epsilon 1e-15, k-means, zstd), 300 + 20 steps, its device rows
     over 30 profiled steps (profile_fit), and two 50-step fits of the same
     sha256.
 13. the compress and decode CLIs' run tools: (a) quant.bit_alloc=auto on
     phase 5's configuration and on phase 9's (the finals point): the
     allocation, adopted or not, both arms' decoded dB and bytes, the quant
     wall against the run without it; the uniform arm is that run's
     container bit for bit, and the probes launch K1 in the bf16 mode (JAX's
     default pass) and K2 never in it; (b) entropy_coding.progressive=true
     (with its base finetune) on phase 5's configuration under the `auto`
     stream: its bytes against the flat `auto` container of phase 5's state,
     the full decode phase 5's bit for bit, the base
     prefix's dB before (the same container without the finetune) and after
     (better), and a second finetune giving the stored books' sha256; (c)
     from phase 5's run dir, decode_run at --scale 4 (2048², one K1 launch),
     in --tile-rows 256 bands and a window of it: bands and window equal the
     full render's slices bit for bit; Mpix/s of each and of the launch
     alone; (d) the run packed into an .iic file decodes to the run dir's
     image bit for bit; (e) a -m sweep of 8 seeds at w128 and 2 at w182
     (20 steps each, launcher.n_jobs=2) through compress.cli, and the w182
     sweep again at n_jobs=1: each member's stream the same sha256; then
     decode_runs over each width's runs alone (one batched K1 launch each,
     the counts the kernels line prints) and over the 10: one batched K1
     launch per group and no single one, each image its single decode's
     bits; (f) profile=True on a 20-step
     fit: the trace in <run>/profile/ holds K1, K2 and sum_partials rows.
 14. the batched fit, the pipeline and the density ladder (full width,
     512² d8/w128): (a) the RigL ladder of scripts/sparsify.sh through
     `python -m implicit_image_tpu_torch.parallel.ladder` (its cli, in
     process; densities 0.05-0.75, zstd, cut to 200 fit + 20 finetune steps
     from 2,000 x 5 + 100): per fit and finetune step one batched K1 and
     one batched K2 launch and no single K2 (the codebook finetune runs over
     the member axis too), each member's RigL weight counts (mask.npz)
     conserved and its density within LADDER_DENSITY_TOL of its target,
     bytes rising with density, decoded PSNR finite and above its floor
     (LADDER_FLOOR, from tests/ladder_floors.py), the member at 0.25 the
     bits of a single fit with its generator, and the five run dirs decoded
     by decode_runs in one batched K1 launch, each image its decode_run's
     bits; the ladder's fit wall (its summary.json), ms per step per member
     against phase 5's single fit; (b) the GMP ladder (final densities 0.1-0.5, the
     same cut, masking.end_when cut to 150 with the steps): each member's
     end density within GMP_DENSITY_TOL of its own target; (c)
     batched_compress on 4 seeded 512² images (100 + 10 steps): member 0's
     container the sha256 of a B = 1 run; (d) a 2-member RigL ladder at
     w182 for 20 steps: the member-axis width-192 backward on the path;
     (e) and (f) the same at w256 and w640: the member-axis layer-wise
     kernels, one K2 over the members a fit and finetune step, no single K2,
     the z stash from K1 once a step, sine_mlp_layer_fwd only in K1.

 15. the compress CLI's last options (PR 12), each through compress.main
     (and decode_run where it writes a container) at 512², phase 5's
     configuration unless named, 200 + 20 steps unless named, its PSNR
     above its floor (P15_FLOOR, from the JAX package's CPU runs at 128²,
     tests/phase15_floors.py): (a) quant=qat entropy_coding=zstd with
     masking=none (scripts/run_measurements_r4.sh:11): int8 codes and an
     fp16 qscale for each quantized layer; then the QAT finetune repeated
     in this process from the run's fit params, its launches counted (K2
     and sum_partials once per step, K1 once more for its eval), its
     codes and scales the container's bit for bit and the render of them
     decode_run's image bit for bit; (b) quant.qscheme=per_tensor under
     RigL: uint8 labels and a 256-entry codebook, the same checks, and
     every pruned weight exactly 0 after the finetune and in the decoded
     state; (c) optim=shampoo (lr 0.1, graft_norm): RigL's counts
     conserved, ms per step beside phase 5's, and one update refreshing
     its inverse roots (the batched eigh) against one reusing them; (d)
     optim.preconditioner=ekfac (interval 10, eps 0.1): ms per step beside
     phase 5's, one preconditioning with and without the bases'
     recompute, then 20 steps on the chunked capture (pixel_chunks=2);
     (e) the EKFAC fit stopped at 100 with a checkpoint and resumed to 200:
     model.npz and mask.npz of (d)'s sha256; (f) Fourier at
     train.matmul_precision=bfloat16 (no kernel launch) and Feathermap
     0.2 under the precision schedule (K1/K2/sum_partials in the bf16
     mode for steps [0, 15) and the eval among them, fp32 after), 20 steps
     each.
 16. the many-image and search tools at 512², SIREN d8/w128 and
     the RigL default unless named, each part's wall and ms per step per
     member printed beside phase 5's single fit and phase 14a's ladder:
     (a) the fleet CLI (fleet.run) on the Makefile's
     fleet.images=flower,big_building,bridge, 200 + 20 steps: one batched
     K1 per fit step and eval and one batched K2 and partial sum per fit
     and finetune step, no single K2 launch; each
     member's run dir decodes through decode_run to its reported PSNR bit
     for bit, and decode_runs over the three in one batched K1 launch; (b)
     the API: compress_image of the synthetic stand-in as an array is
     compress.main with img=synthetic (bytes, decoded PSNR, bitstream),
     its .iic (save) decodes to the run dir's image bit for bit, and
     compress_images of two more images (100 + 10 steps) runs over the
     member axis, each decoding to its reported PSNR; (c)
     compress_to_target(target.bytes=60000) (target.py's example, zstd)
     with a ladder of 5 and one refinement: the probes printed, one batched
     K2 per fit step and ladder, and when met the chosen member within the
     budget, its stream decoding to its reported PSNR; (d) a density sweep
     (n_trials=8 batch=4 masking.density='loguniform(0.05,0.95)', 100 + 10
     steps): two ladders, then relaunched with the same arguments it
     replays all 8 trials with no kernel launch; and a 2-trial serial sweep
     over optim.lr through compress.main; (e) meta_train of SIREN (pool 8,
     4 images x 20 inner x 4 outer steps): one batched K1 and K2 per inner
     step plus one batched K1 per meta-step, no single launch; a 200-step
     fit from its artifact through train.init_path starts from its weights
     (the first loss is the artifact's, bit for bit); CoordX s5/w96
     meta-training (2 outer steps) launches no SIREN kernel.
 17. sequence coding through sequence.encode_sequence and
     decode_sequence at 512², SIREN d8/w128, RigL 0.5, k-means with ECVQ,
     the `auto` stream, cut to 200 I-fit / 50 P-fit / 20 finetune steps,
     each frame's K1 / K2 / sum_partials launches printed per I- and
     P-frame: (a) the Makefile's sequence target (8 frames at motion
     0.01): every frame but frame 0 a P-frame, each decoded >= 20 dB, each
     P-frame's nonzero weights per layer its I-frame's (RigL's topology
     frozen), and decode_sequence of the dir each frame the encode side's
     render bit for bit, one K1 launch per frame; (b) the same with an
     I-frame every 4: frames 0 and 4 are I; the CLI's pack, decode_sequence
     of the .iiv (each frame the encode side's render; its size against
     the frame payloads; the steady decode rate after the first frame,
     host entropy decode included) and a seek to frame 6 equal to the
     full decode's frame that extracts frames 4-6 only; (c) the scene-cut
     guard at motion 0.5 and 2 P steps: under the default 3 dB a P attempt
     falls back to an I-frame, under max_drop=none none does; (d)
     stop_at_psnr=20: every P-frame stops at its first check (25 of 50
     steps), its K2 launches its steps plus the finetune's; (e)
     benchmarks/sequence_decode.py's CoordX s5/w96 sequence (RigL 0.85, an
     I-frame every 4, 100 / 25 / 20 steps): no SIREN kernel launch, and its
     decode rate.
 18. the member axis beyond the fused SIREN, each part's wall
     printed: (a) bench.py's batched arm (SIREN d8/w128, 64 x 256²,
     pixel_chunks=8, the bf16 -> fp32 schedule at 0.75; 2,000 steps cut to
     200) through batched_compress with no finetune and `plain` containers:
     s per fit, mean PSNR,
     member-axis launches per step (8 chunks: 8 K1, 8 K2, 8 partial sums),
     K2 in the bf16 mode for steps [0, 150); then 4 steps of the same fit
     under torch.profiler (3 bf16, 1 fp32): device ms per step, idle share
     and the top device rows, the chrome trace beside its run; (b)
     benchmarks/batched_flagship.py (CoordX s5/w96, RigL 0.85, B = 8 at
     512², k-means 8-bit, huffman; 1,200 + 100 steps cut to 200 + 20)
     through batched_compress, the finetune over the member axis: ms per
     step per member beside phase 8's single flagship fit, decoded dB and
     bytes per member, no SIREN kernel launch; (c) a 5-member RigL ladder
     (0.05-0.75) at 512² under train.mixed_precision (150 + 10 steps) and
     a 2-member one at w182 (20 + 5): every fit step's K1/K2 over the
     member axis in fp32+mixed (LAUNCHES_MIXED), the finetune's in fp32;
     (d) 2-member RigL ladders (0.25, 0.5, masks frozen at their init;
     50 + 5 steps) for hashgrid,
     wavelet-SIREN, Fourier, the exact sine, loss=ms-ssim,
     optim.grad_clip, Shampoo and EKFAC, at 128², one member's fit (the
     k-th ladder's member k % 2, so each density is held in four) within
     P18_PSNR_TOL and P18_PARAM_TOL of the single fit with its generator
     (and whether it has its bits). Every part decodes its members from
     their written containers: >= 20 dB in (a)-(c) (12 dB for the w182
     20-step leg), >= 12 dB in (d)'s 50-step fits.
 19. the multi-device layer at phase 5's configuration (the RigL
     default, 512², d8/w128, 200 + 20 steps), each part's wall printed:
     (a) a world-size-1 NCCL group (make_mesh(1, 1)): sharded_fit is the
     single fit bit for bit (params, masks) with the same K1 / K2 /
     sum_partials launches; sharded_render of it is the single render bit
     for bit; sharded_compress decodes >= 20 dB (P19_FLOOR) and writes the
     single pipeline's container (fit, finetune, container) byte for byte;
     its launches over the three are the kernels line's
     `sharded_launches`; (b) two processes sharing the card over gloo
     (run_group, pixel = 2): each fits rows 256 of 512 with one K2 launch a
     step (the single fit with pixel_chunks=2 two), and both ranks' params
     and masks are that single fit's bit for bit; (c) two processes over
     gloo, image = 2: a 4-member batched_fit (4 seeded 512² images) is the
     one without a mesh bit for bit, and ladder_compress (densities 0.25,
     0.5) writes the containers of the ladder without a mesh, byte for
     byte; (d) launch_dryrun(2) on the card over gloo: both workers report
     the same fleet PSNRs, each its image's single fit's; (e) the port's
     rate-distortion scoring reads phase 5's run dir and returns the
     decoded PSNR and MS-SSIM its summary.json records, and the host
     MS-SSIM of the decoded image within 1e-4 of it (cv2 and matplotlib
     are not needed); (f) the full-grid wavelet-SIREN (phase 11 (a)'s, its
     fit cut to 60 steps): at world size 1 in (a)'s NCCL group the single
     fit bit for bit and its render the single render; over 2 gloo processes
     on the card (pixel = 2) each rank runs the sub-SIRENs on 129 of the DWT
     lattices' 258 rows, K2 twice a step, and both ranks' params and PSNRs
     are the single fit's within P19_WAVELET_DB and P19_WAVELET_REL (the
     gradients add over the ranks in another order), each rank's sharded
     render the single render of its params bit for bit.

Each of phases 4-19 sets the launch counts to 0 just before its run and
reads them just after: every kernel of the path must have launched, and
sine_mlp_fwd_batched in 13 (e), 14, 16 and 18 only; the member-axis K2
(sine_mlp_bwd_batched, sum_partials_batched) in 14, 16 and 18 only, in
"+mixed" in 18 (c) only; the layer-wise kernels in 10 and the w512 run of
12 (e) and in 14 (e) and (f) only (over the member axis in 14 (e) and (f)
only, with no fused K1 or K2 there); nothing in phase 8, in 11 (d), in 12 (f)-(h), in 15 (f)'s Fourier
run, in 16 (e)'s CoordX meta-training, in 17 (e) and in 18 (b). In
phase 3, sum_partials must equal its plain mirror sum_partials_reference
(the kernel's order of additions) bit for bit on the main path's partial
buffer, give the same bits twice, and be
within SUM_TOL of partials.sum(0), the library call for the same function;
the kernel and the library call are timed in turns (5 rounds of 20
launches each), replayed from CUDA graphs (device time: the kernels line
reports these medians) and launched from Python (host included), and
every round is printed beside the medians and their share of the bound.

Then one JSON line describing the kernels (each kernel once per width of
phase 3, with the launches of the phase that runs that width: 4 and 9;
the layer-wise kernels at 256, 512, 640 and 1024 with 10's, over the
member axis at 256 and 640 with 14 (e)'s and (f)'s;
the batched K1 at 128 and 182 with 13 (e)'s; the batched K2 and its
partial sum with 14 (a)'s and 14 (d)'s; the single K1,
K2 and sum_partials at 128 also with 17 (a)'s, as `sequence_launches`,
and with 19 (a)'s sharded path's, as `sharded_launches`),
and as the last line
{"ok": true, "device": {...}}. Any failure raises: nothing is caught, the
exit code is non-zero and no result line is printed. Without a CUDA device
the script exits non-zero before doing anything.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

# Tolerances of phase 3, kernel vs plain torch on the same card and inputs.
# fp32: only the summation order and FMA contraction differ (~1e-6 relative
# per layer, amplified by omega = 30 through 7 sine layers).
# bf16: additionally an fp32 value that lies at a bf16 rounding boundary
# may round the other way in one version, a one-ulp (2^-8) step that the
# next layers carry on.
# Each limit sits between the sound reading and the control's (the other
# mode's kernel), with a margin of 2 or more on both sides; on an H100 at
# these shapes the bf16 mode reads 5.9e-4 / 6.5e-3 sound and 4.5e-3 / 9.0e-2
# for the fp32 kernel.
FWD_TOL = {"fp32": 1e-4, "bf16": 1.5e-3}  # max abs error of the raw chain output
BWD_TOL = {"fp32": 1e-4, "bf16": 2e-2}  # max abs error / max |plain|, per gradient
SUM_TOL = 1e-6  # sum_partials vs partials.sum(0), relative
# sine_mlp_layer_dw vs its plain version: max abs error / max |plain|, the
# fp32 mode's gradient limit (each split's dW sums ~2,000 rows that cancel)
DW_TOL = BWD_TOL["fp32"]

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense): the bound of a
# kernel is max(bytes / memory rate, operations / peak rate of their type).
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12  # tensor cores; the fp32 mode takes 3 passes
BF16_FLOP_PER_S = 989e12  # tensor cores, dense
FP32_FLOP_PER_S = 67e12   # FMA outside the tensor cores

N_SIDE, DEPTH, WIDTH = 512, 8, 128
KERNEL_WIDTHS_CHECKED = (WIDTH, 182)  # phase 3's fused widths; 182 runs on the kernels of width 192
SMOKE_OVERRIDES = [
    "masking=none", "train.num_steps=200", "train.log_steps=100",
    "quant.num_steps=20", "entropy_coding=plain", "output_dir=outputs/chip_smoke",
]
DEFAULT_OVERRIDES = [
    "train.num_steps=200", "train.log_steps=100", "quant.num_steps=20",
    "entropy_coding=plain", "output_dir=outputs/chip_smoke_default",
]
PRESET_OVERRIDES = [
    "train.num_steps=60", "train.log_steps=10", "quant.num_steps=10", "entropy_coding=plain",
]
PRESETS = ("SNFS", "Pruning", "Small_Dense")
SMALL_DENSE_WIDTH = 57  # int(128 * sqrt(0.2))
# the JAX bench's flagship (bench.py), cut from 1200 + 100 steps
FLAGSHIP_OVERRIDES = [
    "mlp=coordx", "mlp.hidden_size=96", "mlp.split_depth=5", "masking.density=0.85",
    "train.num_steps=300", "train.log_steps=100", "train.init_path=auto", "quant.delta=true",
    "quant.row_stride=4", "quant.num_steps=20", "entropy_coding=auto",
    "output_dir=outputs/chip_smoke_flagship",
]
FLAGSHIP_ARTIFACT = "coordx_s5w96_512_tf32.npz"
# the reference's finals for big_building and bridge (scripts/finals.sh), one
# density, cut from 2000 x 5 + 100 steps
FINALS_WIDTH, FINALS_BITS = 182, 9
FINALS_OVERRIDES = [
    "img=big_building", f"mlp.hidden_size={FINALS_WIDTH}", f"quant.bits={FINALS_BITS}",
    "entropy_coding=zstd", "train.multiplier=5", "masking=RigL", "masking.density=0.5",
    "train.num_steps=40", "train.log_steps=100", "quant.num_steps=20",
    "output_dir=outputs/chip_smoke_finals",
]
# phase 10, cut from 2000 steps: the d8/w256 member of the width/depth study
# (scripts/width_depth.sh) and the tracked w512 row (scripts/tracked_r5.sh),
# both on the layer-wise kernels
WIDE_OVERRIDES = {
    256: ["mlp.hidden_size=256"],
    512: ["mlp.hidden_size=512", "optim.lr=1e-4"],
}
# phase 10 above 512: `python -m
# implicit_image_tpu_torch.compress mlp.hidden_size=W` at d8, dense, with the
# default k-means finetune and a zstd container, cut to 20 fit + 20 finetune
# steps, at the tracked w512 row's lr
LAYER_PATH_COMMON = ["img=synthetic", "masking=none", "optim.lr=1e-4", "train.num_steps=20",
                     "train.log_steps=10", "quant.num_steps=20", "entropy_coding=zstd"]
WIDE_COMMON = ["img=synthetic", "masking=none", "quant=none", "entropy_coding=none",
               "train.num_steps=20", "train.log_steps=10"]
# phase 11: the reference's other model families (scripts/run_studies_r5.sh),
# each cut from its script's steps
FAMILY_COMMON = ["img=synthetic", "train.log_steps=100", "quant.num_steps=20"]
FAMILY_RUNS = {
    "a wavelet dense": ["mlp=wavelet_siren", "masking=none", "quant=kmeans",
                        "entropy_coding=zstd", "train.num_steps=200"],
    "b wavelet RigL": ["mlp=wavelet_siren", "masking=RigL", "masking.density=0.25",
                       "quant=kmeans", "entropy_coding=zstd", "train.num_steps=200"],
    "c Feathermap": ["masking=Feathermap", "masking.density=0.2", "train.multiplier=5",
                     "entropy_coding=zstd", "train.num_steps=40"],
    "d Fourier": ["mlp=fourier", "masking=none", "quant=none", "entropy_coding=none",
                  "train.num_steps=200"],
}
# PSNR floors (dB). 200 steps leave Feathermap far from converged: the JAX
# package's own CPU run of (c)'s configuration and steps, its lattice cut to
# 128² (the synthetic image samples the same function at any size), decodes
# 15.08 dB, so (c) is held to 12 dB; the others to 20 dB (the JAX package
# reads 34.55, 32.63 and 29.52 dB at 128² for a, b and d).
FAMILY_PSNR_FLOOR = {"c Feathermap": 12.0}
FEATHER_NAMES = {"layers.0.weight", "layers.1.weight", "layers.2.bias"}  # V1, V2, scalers


# phase 12: the fit options and the last model family, at full width (512²,
# SIREN d8/w128 unless named), each cut from its recipe's steps
P12 = "outputs/chip_smoke_p12"
SCHEDULE_OVERRIDES = DEFAULT_OVERRIDES[:-1] + [
    "train.matmul_precision_early=bfloat16", f"output_dir={P12}_schedule"]
SCHEDULE_WIDE_OVERRIDES = WIDE_COMMON + [
    f"mlp.hidden_size={FINALS_WIDTH}", "train.matmul_precision_early=bfloat16",
    "train.matmul_precision_switch=0.5", f"output_dir={P12}_schedule_w182"]
MIXED_OVERRIDES = DEFAULT_OVERRIDES[:-1] + ["train.mixed_precision=true",
                                            f"output_dir={P12}_mixed"]
STOP_TARGET = 30.0  # dB; the 400-step budget reaches it early
STOP_OVERRIDES = DEFAULT_OVERRIDES[:-1] + [
    "train.num_steps=400", "train.segment_steps=25", f"train.stop_at_psnr={STOP_TARGET}",
    f"output_dir={P12}_stop"]
RESUME_COMMON = ["masking=RigL", "quant=none", "entropy_coding=none", "train.log_steps=50"]
CLIP_OVERRIDES = WIDE_COMMON + ["mlp.hidden_size=512", "optim.lr=3e-4", "optim.grad_clip=1.0",
                                f"output_dir={P12}_clip"]
EXACT_SINE_OVERRIDES = SMOKE_OVERRIDES[:-1] + ["mlp.fast_sine=false",
                                               f"output_dir={P12}_exact_sine"]
COORDX_BF16_OVERRIDES = [o for o in FLAGSHIP_OVERRIDES
                         if not o.startswith(("train.init_path", "quant.delta", "output_dir"))] + [
    "train.matmul_precision=bfloat16", f"output_dir={P12}_coordx_bf16"]
HASHGRID_OVERRIDES = ["mlp=hashgrid", "quant.skip_layers=[]", "optim.lr=1e-2",
                      "optim.epsilon=1e-15", "train.num_steps=300", "train.log_steps=100",
                      "quant.num_steps=20", "entropy_coding=zstd", f"output_dir={P12}_hashgrid"]
# PSNR floors (dB; decoded, or the fit's where the run writes no container),
# set from the JAX package's own CPU run of each configuration at 128²
# (tests/phase12_floors.py; JAX on the CPU runs every product in fp32), its
# reading beside each: 20 dB where it reads 30 or more, as in phase 11; the
# 20-step fits, far from converged, at 12 dB. The resume and repeat runs of
# 12d and 12h are held to their bits, and to finite PSNRs.
P12_FLOOR = {
    "12a schedule": 20.0,       # JAX 36.985 dB
    "12a w182": 12.0,           # JAX 21.944 dB (fit)
    "12b mixed": 20.0,          # JAX 36.438 dB
    "12c stop": 20.0,           # JAX 30.145 dB (stopped at step 50 at 128²)
    "12e clip": 12.0,           # JAX 22.543 dB (fit)
    "12f exact sine": 20.0,     # JAX 41.302 dB
    "12g coordx bf16": 20.0,    # JAX 39.263 dB
    "12h hashgrid": 20.0,       # JAX 35.023 dB
}


# phase 3's K1 over a member axis (the vmapped render of decode_runs): M
# members of one shape, each 512² rows, at these widths, both modes
BATCH_MEMBERS, BATCH_WIDTHS = 8, (WIDTH, FINALS_WIDTH)
# phase 3 above 192 (the layer-wise kernels): K1 and K2 at these widths in
# every mode (limits: the fused kernels' fp32 ones, the bf16 ones for bf16
# and "+mixed", as phase 12b), single and over LAYER_MEMBERS members; at
# LAYER_PAIR_WIDTHS (300: kernel width 384, which no path runs) the pairs
# alone; one fp32 pair at each (width, side) of LAYER_WIDE: w2048 at 512²,
# whose z stash ((D-1) x 512² x 2,048 = 3.76e9 floats) is past 2^31, and
# w4096 at 128² (the fp32 limits at K = 4,096). Phase 10 runs LAYER_WIDTHS
# (256 and 512 as WIDE_OVERRIDES, 640 and 1024 as LAYER_PATH_COMMON)
LAYER_WIDTHS, LAYER_MEMBERS = (256, 512, 640, 1024), 2
LAYER_PAIR_WIDTHS = (300,)
LAYER_WIDE = ((2048, 512), (4096, 128))
LAYER_TOL = {"fp32": (1e-4, 1e-4), "bf16": (1.5e-3, 2e-2), "fp32+mixed": (1.5e-3, 2e-2),
             "bf16+mixed": (1.5e-3, 2e-2)}

# phase 13: the run tools of the two CLIs, at full width (512², SIREN
# d8/w128 unless named); (a) and (b) on phase 5's configuration, so the
# uniform arm, the rejected allocation and the flat container are phase 5's
P13 = "outputs/chip_smoke_p13"
ALLOC_OVERRIDES = DEFAULT_OVERRIDES[:-1] + ["quant.bit_alloc=auto", f"output_dir={P13}_alloc"]
ALLOC_FINALS_OVERRIDES = FINALS_OVERRIDES[:-1] + ["quant.bit_alloc=auto",
                                                  f"output_dir={P13}_alloc_finals"]
# the stream of the repo's progressive A/B (benchmarks/progressive_delta_ab.py):
# a plain stream stores each nibble plane in a whole byte
PROGRESSIVE_STREAM = "auto"
PROGRESSIVE_OVERRIDES = [o for o in DEFAULT_OVERRIDES[:-1] if not o.startswith("entropy")] + [
    f"entropy_coding={PROGRESSIVE_STREAM}", "entropy_coding.progressive=true",
    f"output_dir={P13}_progressive"]
SCALE, TILE_ROWS, ROI = 4, 256, (300, 1800, 77, 2001)  # 13c on the 2048² lattice
SWEEP_SEEDS = 8  # 13e: a -m sweep of 8 seeds at w128 and 2 at the finals width
SWEEP_COMMON = ["masking=none", "train.num_steps=20", "train.log_steps=10",
                "quant.num_steps=5", "entropy_coding=plain"]
PROFILE_OVERRIDES = SMOKE_OVERRIDES[:-1] + ["train.num_steps=20", "quant=none",
                                            "entropy_coding=none", "profile=True",
                                            f"output_dir={P13}_profile"]


# phase 14: the batched fit, the pipeline and the density ladder at full width
# (512², SIREN d8/w128 unless named). (a) and (b) are the ladders of
# scripts/sparsify.sh:13-19 (train.multiplier=5, 2,000 x 5 fit + 100
# finetune steps), cut to 200 fit + 20 finetune steps at multiplier 1; GMP's
# schedule end (masking.end_when 1,500 steps) is cut with the steps to 150
P14 = "outputs/chip_smoke_p14"
LADDER_CUT = ["train.num_steps=200", "train.multiplier=1", "train.log_steps=100",
              "quant.num_steps=20"]
LADDER_RUNS = {
    "14a RigL": ["img=synthetic", "entropy_coding=zstd", "masking=RigL",
                 "masking.density=0.05,0.1,0.25,0.5,0.75"],
    "14b GMP": ["img=synthetic", "entropy_coding=zstd", "masking=Pruning", "masking.density=1.0",
                "masking.final_density=0.1,0.25,0.5", "masking.end_when=150"],
}
# decoded PSNR floors (dB) per member: 20 dB where the JAX package's own CPU
# ladder of the same cut at 128² (PYTHONPATH=. python tests/ladder_floors.py;
# every product fp32 there) reads 30 or more, as in phases 11 and 12, and
# 12 dB below that; its reading beside each
LADDER_FLOOR = {
    "14a RigL": {0.05: 12.0,   # JAX 26.138 dB
                 0.1: 20.0,    # JAX 31.383 dB
                 0.25: 20.0,   # JAX 34.830 dB
                 0.5: 20.0,    # JAX 36.592 dB
                 0.75: 20.0},  # JAX 39.610 dB
    "14b GMP": {0.1: 20.0,    # JAX 32.717 dB
                0.25: 20.0,   # JAX 39.607 dB
                0.5: 20.0},   # JAX 41.877 dB
}
LADDER_DENSITY_TOL = 0.005  # |final density - target|: ERK's rounding is 0.0034 at d8/w128
GMP_DENSITY_TOL = 0.01
BATCH_IMAGES, BATCH_STEPS = 4, 100  # 14c: batched_compress, 100 fit + 10 finetune steps
WIDE_LADDER = ["img=synthetic", f"mlp.hidden_size={FINALS_WIDTH}", "entropy_coding=zstd",
               "masking=RigL", "masking.density=0.25,0.5", "train.num_steps=20",
               "train.log_steps=10", "quant.num_steps=5"]
# 14e and 14f: the same ladder at w256 (the narrowest width on the layer-wise
# kernels) and at w640, on the member-axis layer-wise kernels
LAYER_LADDER_WIDTHS = {"e": 256, "f": 640}

# phase 15: the compress CLI's last options at full width (512², SIREN
# d8/w128 unless named), in phase 5's configuration (RigL 0.5) unless named,
# each cut to 200 fit + 20 finetune steps unless named: (a) QAT as
# scripts/run_measurements_r4.sh:11 runs it (masking=none, zstd; per
# channel), (b) QAT per tensor, (c) Shampoo (conf/optim/shampoo.yaml: lr
# 0.1, graft_norm), (d) the EKFAC preconditioner (interval 10, eps 0.1) and
# a 20-step fit on its chunked capture, (e) an EKFAC resume, (f) Fourier at
# bfloat16 and Feathermap under the precision schedule, 20 steps each
P15 = "outputs/chip_smoke_p15"
P15_CUT = ["train.num_steps=200", "train.log_steps=100", "quant.num_steps=20"]
P15_RUNS = {
    "15a qat": P15_CUT + ["masking=none", "quant=qat", "entropy_coding=zstd"],
    "15b qat per_tensor": P15_CUT + ["quant=qat", "quant.qscheme=per_tensor",
                                     "entropy_coding=zstd"],
    "15c shampoo": P15_CUT + ["optim=shampoo", "entropy_coding=plain"],
    "15d ekfac": P15_CUT + ["+optim.preconditioner=ekfac", "entropy_coding=plain"],
    "15d ekfac chunks": ["+optim.preconditioner=ekfac", "train.pixel_chunks=2",
                         "train.num_steps=20", "train.log_steps=10", "quant=none",
                         "entropy_coding=none"],
    "15f fourier bf16": ["mlp=fourier", "train.matmul_precision=bfloat16", "masking=none",
                         "quant=none", "entropy_coding=none", "train.num_steps=20",
                         "train.log_steps=10"],
    "15f feathermap schedule": ["masking=Feathermap", "masking.density=0.2",
                                "train.matmul_precision_early=bfloat16", "quant=none",
                                "entropy_coding=none", "train.num_steps=20",
                                "train.log_steps=10"],
}
EKFAC_RESUME = ["+optim.preconditioner=ekfac", "quant=none", "entropy_coding=none",
                "train.log_steps=100"]
# PSNR floors (dB; decoded, or the fit's where the run writes no container)
# from the JAX package's own CPU run of each configuration at 128²
# (PYTHONPATH=. python tests/phase15_floors.py; every product fp32 there),
# its reading beside each: 20 dB where it reads 30 or more, 12 dB below
# that and for the 20-step fits, as in phases 11, 12 and 14
P15_FLOOR = {
    "15a qat": 12.0,                  # JAX 28.660 dB (fit 42.242)
    "15b qat per_tensor": 12.0,       # JAX 27.241 dB (fit 43.652)
    "15c shampoo": 12.0,              # JAX 22.668 dB (fit 28.649)
    "15d ekfac": 20.0,                # JAX 38.043 dB
    "15d ekfac chunks": 12.0,         # JAX 20.393 dB (fit)
    "15f fourier bf16": 12.0,         # JAX 15.422 dB (fit)
    "15f feathermap schedule": 12.0,  # JAX 15.403 dB (fit)
}

# phase 16: the many-image and search tools at full width (512²
# seeded synthetic stand-ins, SIREN d8/w128, the RigL default unless named),
# fits cut to 200 + 20 steps unless named
P16 = "outputs/chip_smoke_p16"
P16_CUT = ["train.num_steps=200", "train.log_steps=100", "quant.num_steps=20"]
# (a) the Makefile's fleet target (Makefile:55-59), cut from 2,000 + 100 steps
FLEET_ARGV = ["fleet.images=flower,big_building,bridge", *P16_CUT, f"output_dir={P16}_fleet",
              "exp_name=smoke"]
# (b) the API on the synthetic stand-in; compress_images on two more images
API_OVERRIDES = P16_CUT + ["entropy_coding=plain"]
API_BATCH_SEEDS, API_BATCH_STEPS = (1, 2), 100  # 100 + 10 steps
# (c) target.py's example (target.py:28, img=flower target.bytes=60000) with
# the default ladder of 5 and one refinement; zstd, since a plain
# container's bytes do not move with density
TARGET_BYTES, TARGET_LADDER, TARGET_REFINE = 60000, 5, 1
TARGET_OVERRIDES = ["img=flower", "entropy_coding=zstd", *P16_CUT]
# (d) the Makefile's sweep target (Makefile:46-48: 15 trials over
# masking.density), cut to 8 trials in rounds of 4 at 100 + 10 steps: two
# ladders; then 2 serial trials over optim.lr
SWEEP_CUT = ["train.num_steps=100", "train.log_steps=50", "quant.num_steps=10"]
SWEEP_ARGV = ["n_trials=8", "batch=4", "masking.density='loguniform(0.05,0.95)'", *SWEEP_CUT,
              f"output_dir={P16}_sweep_runs", f"dir={P16}_sweep"]
SERIAL_SWEEP_ARGV = ["n_trials=2", "optim.lr='loguniform(1e-4,1e-3)'", *SWEEP_CUT,
                     f"output_dir={P16}_serial_runs", f"dir={P16}_serial"]
# (e) the Makefile's meta target (Makefile:51-54), MetaConfig's pool 16,
# 50 inner x 300 outer steps cut to pool 8, 20 x 4 (SIREN) and 20 x 2
# (CoordX s5/w96, the flagship's shape), 4 images per meta-step
META_CUT = ["meta.pool_size=8", "meta.meta_batch=4", "meta.inner_steps=20"]
META_SIREN_ARGV = META_CUT + ["meta.outer_steps=4", f"meta.out={P16}_meta/siren_d8w128.npz"]
META_COORDX_ARGV = META_CUT + ["mlp=coordx", "mlp.hidden_size=96", "mlp.split_depth=5",
                               "meta.outer_steps=2", f"meta.out={P16}_meta/coordx_s5w96.npz"]
WARM_STEPS = 200  # (e): the fit from the meta-trained artifact

# phase 17: sequence coding at full width (512², SIREN d8/w128, RigL 0.5,
# k-means 8-bit with ECVQ λ=1: the composed defaults). (a) the Makefile's
# sequence target (Makefile:66-69: sequence.video=seqbench quant=kmeans
# entropy_coding=auto; 8 frames at motion 0.01), its I-fit, P-fit and
# finetune cut from 2,000 / 500 / 100 steps to 200 / 50 / 20; (b) the same
# with an I-frame every 4; (c) the scene-cut guard (JAX's
# test_sequence_max_drop_fallback_and_disable at full width: motion 0.5, 2
# P steps, 3 frames) with the default 3 dB and with max_drop=none; (d)
# sequence.stop_at_psnr at 20 dB, which the warm start meets by the first
# check; (e) benchmarks/sequence_decode.py's configuration
# (scripts/run_studies_r5.sh:69: CoordX s5/w96, RigL 0.85, auto, gop 4, 8
# frames), cut from 1,000 / 250 / 100 to 100 / 25 / 20 steps
P17 = "outputs/chip_smoke_p17"
SEQ_STEPS0, SEQ_STEPS_P, SEQ_QUANT = 200, 50, 20
SEQ_ARGV = ["sequence.video=seqbench", "quant=kmeans", "entropy_coding=auto",
            f"train.num_steps={SEQ_STEPS0}", "train.log_steps=100",
            f"sequence.steps0={SEQ_STEPS0}", f"sequence.steps={SEQ_STEPS_P}",
            f"quant.num_steps={SEQ_QUANT}"]
SEQ_FRAMES, SEQ_GOP, SEQ_SEEK, SEQ_FLOOR = 8, 4, 6, 20.0
SCENECUT_ARGV = ["sequence.video=scenecut", "sequence.frames=3", "sequence.motion=0.5",
                 "sequence.steps=2"]
SEQ_STOP_DB = 20.0
SEQDEC_ARGV = ["mlp=coordx", "mlp.hidden_size=96", "mlp.split_depth=5", "masking=RigL",
               "masking.density=0.85", "quant=kmeans", "quant.num_steps=20",
               "entropy_coding=auto", "sequence.video=benchclip", "sequence.frames=8",
               "sequence.gop=4", "sequence.steps0=100", "sequence.steps=25",
               "train.num_steps=100", "train.log_steps=250"]

def _time_ms(fn, reps: int = 10) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _interleaved_ms(fns, rounds: int = 5, reps: int = 20) -> list:
    """ms per launch of each function in every round, timed in turns:
    `rounds` rounds, each timing `reps` launches of every function in order."""
    times = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn in zip(times, fns):
            t.append(_time_ms(fn, reps))
    return times


def _graph_interleaved_ms(fns, rounds: int = 5, reps: int = 20) -> list:
    """As _interleaved_ms, but each function's `reps` launches are captured
    in one CUDA graph and replayed between the events: the device's time
    alone, with no host time between launches. (A loop of ~0.02 ms
    launches from Python measures the host's enqueue instead.)"""
    import torch

    graphs = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graphs.append(graph)
    times = [[] for _ in fns]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(rounds + 1):  # the first round warms up
        for t, graph in zip(times, graphs):
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            t.append(start.elapsed_time(end) / reps)
    return [t[1:] for t in times]


def phase_card() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1 card] {line}", flush=True)
    return line


def phase_build() -> float:
    from implicit_image_tpu_torch.ops import cuda_build
    from implicit_image_tpu_torch.ops.sine_mlp import KERNEL_WIDTHS, MAX_ROWS
    from implicit_image_tpu_torch.tools.kernel_breakdown import layer_kind

    t0 = time.perf_counter()
    lib = cuda_build.load_library()
    seconds = time.perf_counter() - t0
    print(f"[2 build] {seconds:.2f} s -> {cuda_build.BUILD_DIR}", flush=True)
    # the wrappers' row guard is the kernels' own limit
    if lib.sine_mlp_max_rows() != MAX_ROWS:
        raise AssertionError(f"sine_mlp.MAX_ROWS {MAX_ROWS} is not the library's "
                             f"{lib.sine_mlp_max_rows()}")
    table = cuda_build.ptxas_table(cuda_build.ptxas_report())
    for name, row in table.items():
        if name.startswith("void"):  # the kernels (entry functions)
            print(f"[2 build] {row.get('registers')} registers, {row.get('spill_stores')} B "
                  f"spill stores, {row.get('spill_loads')} B spill loads: {name[:160]}",
                  flush=True)
    # the wgmma kernels (the forward and backward at widths 128 and 192;
    # every mode, single and over the member axis) spill nothing
    for what, key in (("width-128 forward", "sine_mlp_fwd_kernel<"),
                      ("width-128 backward", "sine_mlp_bwd_kernel<"),
                      ("width-192 forward", "sine_mlp_fwd_wg192_kernel<"),
                      ("width-192 backward", "sine_mlp_bwd_wg192_kernel<")):
        rows = {n: r for n, r in table.items() if n.startswith("void") and key in n}
        for name, row in rows.items():
            print(f"[2 build] {what}: {row.get('registers')} registers, "
                  f"{row.get('spill_stores', 0)} B spill stores, {row.get('spill_loads', 0)} B "
                  f"spill loads: {name[:120]}", flush=True)
        if table and len(rows) != 8:
            raise AssertionError(f"{len(rows)} {what} instantiations, expected 8 (4 modes, "
                                 "single and over the member axis)")
        for name, row in rows.items():
            if row.get("spill_stores", 0) or row.get("spill_loads", 0):
                raise AssertionError(f"the {what} spills: {name} {row}")
    # the layer-wise kernels (widths above 192): 12 forward instantiations (4
    # modes x first, hidden, last), 20 backward (4 modes x last and hidden,
    # each with and without dW_0, and first), 4 dW (4 modes); none spills
    # (the first and last passes unroll their loops for 3 outputs and 2
    # inputs inside each instantiation: no instantiation of their own).
    # The wgmma ones (the hidden forward and backward, kind 1, and dW;
    # warpgroups apart, setmaxnreg) each printed with their registers and
    # spills
    rows = {n: r for n, r in table.items() if n.startswith("void") and "sine_mlp_layer_" in n}
    spilling = {n: r for n, r in rows.items() if r.get("spill_stores", 0) or r.get("spill_loads", 0)}
    regs = sorted(r.get("registers", 0) for r in rows.values())
    print(f"[2 build] {len(rows)} layer-wise kernel instantiations, {regs[0] if regs else 0}-"
          f"{regs[-1] if regs else 0} registers, {len(spilling)} spilling", flush=True)
    wg_rows = {n: r for n, r in rows.items()
               if "sine_mlp_layer_dw_kernel<" in n or layer_kind(n) == 1}
    for name, row in wg_rows.items():
        print(f"[2 build] layer-wise wgmma: {row.get('registers')} registers, "
              f"{row.get('spill_stores', 0)} B spill stores, {row.get('spill_loads', 0)} B spill "
              f"loads: {name[:120]}", flush=True)
    # the first and last layers' streaming passes (kinds 0 and 2): 8
    # forward (4 modes x first, last), 12 backward (4 modes x last with and
    # without dW_0, first)
    pass_rows = {n: r for n, r in rows.items() if layer_kind(n) in (0, 2)}
    for name, row in pass_rows.items():
        print(f"[2 build] layer-wise first/last pass: {row.get('registers')} registers, "
              f"{row.get('spill_stores', 0)} B spill stores, {row.get('spill_loads', 0)} B spill "
              f"loads: {name[:120]}", flush=True)
    if table and (len(rows) != 36 or len(wg_rows) != 16 or len(pass_rows) != 20 or spilling):
        raise AssertionError(f"layer-wise kernels: {len(rows)} instantiations (expected 36), "
                             f"{len(wg_rows)} on wgmma (expected 16), {len(pass_rows)} first/last "
                             f"passes (expected 20), spilling {spilling}")
    # K1 and K2 over a member axis are template instantiations (last argument
    # MB) of each fused forward and backward (widths 128 and 192) and of the
    # partial sum: each must spill no more than its single launch. The
    # forward and backward have one in each of the four modes (bf16 or not,
    # "+mixed" or not: template arguments BF16, MX); the "+mixed" ones (MX =
    # 1) print their spills beside their single launch's
    kinds = {"sine_mlp_fwd": 4 * len(KERNEL_WIDTHS), "sine_mlp_bwd": 4 * len(KERNEL_WIDTHS),
             "sum_partials": 1}
    for kind, expected in kinds.items():
        batched = {n: r for n, r in table.items()
                   if f"{kind}_" in n and n.startswith("void") and "(bool)1>(" in n}
        for name, row in batched.items():
            single = table.get(name.replace("(bool)1>(", "(bool)0>("))
            if single is None or row.get("spill_stores", 0) > single.get("spill_stores", 0):
                raise AssertionError(f"a batched kernel spills more than its single launch: "
                                     f"{name} {row} vs {single}")
        mixed = {n: r for n, r in batched.items() if kind in MIXED_KINDS and _is_mixed(n)}
        for name, row in mixed.items():
            single = table[name.replace("(bool)1>(", "(bool)0>(")]
            print(f"[2 build] batched +mixed: {row.get('registers')} registers, "
                  f"{row.get('spill_stores', 0)} B spill stores, {row.get('spill_loads', 0)} B "
                  f"spill loads (its single launch: {single.get('spill_stores', 0)} B, "
                  f"{single.get('spill_loads', 0)} B): {name[:160]}", flush=True)
        for name, row in mixed.items():
            if row.get("spill_stores", 0):
                raise AssertionError(f"a batched +mixed kernel spills {row.get('spill_stores')}"
                                     f" B: {name}")
        spilling = sum(1 for r in mixed.values() if r.get("spill_stores", 0))
        print(f"[2 build] {len(batched)} batched {kind} instantiations ({len(mixed)} +mixed, "
              f"{spilling} of them spilling), none spilling more than its single launch",
              flush=True)
        if table and len(batched) != expected:
            raise AssertionError(f"{len(batched)} batched {kind} instantiations, expected "
                                 f"{expected} (each mode at each of its widths)")
        if table and kind in MIXED_KINDS and len(mixed) != expected // 2:
            raise AssertionError(f"{len(mixed)} batched +mixed {kind} instantiations, expected "
                                 f"{expected // 2}")
    return seconds


# the kernels with a "+mixed" (MX) template argument: <BF16, MX, ...>
MIXED_KINDS = ("sine_mlp_fwd", "sine_mlp_bwd")


def _is_mixed(name: str) -> bool:
    """A ptxas name of a forward or backward instantiation whose MX argument
    (the second template argument) is 1."""
    args = name[name.index("<") + 1:].split(",")
    return args[1].strip().startswith("(bool)1")


def _grad_floats(in_size: int, hidden: int, out_size: int, depth: int) -> int:
    """Floats in one gradient of a SIREN: dW0, dWm, dWl, dbs, dbl."""
    return (in_size * hidden + (depth - 2) * hidden * hidden + hidden * out_size
            + (depth - 1) * hidden + out_size)


def _bounds(n: int, in_size: int, out_size: int, depth: int, hidden: int, blocks: int,
            n_part: int, members: int = BATCH_MEMBERS, mixed: bool = False,
            bf16: bool = False) -> dict:
    """FLOPs, bytes and least times of each kernel at these shapes, counted
    from csrc/sine_mlp.cu: the hidden products (tensor cores, 3 TF32 passes
    in the fp32 mode) apart from the first layer (K = in), the last
    (N = out) and dx (FMA). Bytes: each input read once, each output
    written once; n_part floats of partial gradient per block.

    `mixed` (fp32+mixed): W and every activation are bf16, so a.W (the
    forward's, and the backward's recompute) is one bf16 pass; dW = a^T gz
    and ga = gz W^T take the fp32 cotangent gz against a bf16 operand,
    which three bf16 pieces of gz give exactly: 3 bf16 passes, less than
    the 2 TF32 passes of one split. `bf16` (the bf16 mode): every hidden
    product is one bf16 pass.

    Above 192 under autograd the port does less than the JAX pair's work:
    "sine_mlp_fwd_stash" is K1 that also writes the z stash ((depth - 1) n
    hidden floats), "sine_mlp_bwd_stashed" K2 that reads it in place of the
    recompute (dW and ga only, the first layer's dW_0 and dx); "_batched"
    the same over `members` members."""
    hidden_mm = 2 * n * hidden * hidden * (depth - 2)  # one product over all hidden layers
    # least seconds of the hidden products: a.W, and dW or ga (gz as operand)
    if bf16:
        fwd_s = dw_s = hidden_mm / BF16_FLOP_PER_S
    elif mixed:
        fwd_s = hidden_mm / BF16_FLOP_PER_S
        dw_s = 3 * hidden_mm / BF16_FLOP_PER_S
    else:
        fwd_s = dw_s = 3 * hidden_mm / TF32_FLOP_PER_S
    bwd_s = fwd_s + 2 * dw_s
    weights = 4 * (in_size * hidden + (depth - 2) * hidden * hidden + hidden * out_size
                   + (depth - 1) * hidden + out_size)
    # name: (tensor-core flops, their seconds, FMA flops, bytes)
    kernels = {
        # forward: first layer, hidden a.W, last layer
        "sine_mlp_fwd": (hidden_mm, fwd_s, 2 * n * hidden * (in_size + out_size),
                         4 * n * (in_size + out_size) + weights),
        # backward: a.W recomputed, dW = a^T gz, ga = gz W^T; first layer twice
        # (forward, and z_0 again), dWl, ga of the last layer, dW0, dx
        "sine_mlp_bwd": (3 * hidden_mm, bwd_s, 2 * n * hidden * (4 * in_size + 2 * out_size),
                         4 * n * (2 * in_size + out_size) + weights + 4 * blocks * n_part),
        "sum_partials": (0, 0.0, blocks * n_part, 4 * (blocks + 1) * n_part),
        # the hidden layers' dW (the layer-wise sine_mlp_layer_dw over the L
        # layers): read A and G (L, n, hidden) once, write each split's (L,
        # hidden, hidden)
        "hidden_dw": (hidden_mm, dw_s, 0, 4 * (depth - 2) * hidden * (2 * n + blocks * hidden)),
        # K1 over `members` members of one shape: the forward's work each; x
        # (shared) read once, each member's weights and output once
        "sine_mlp_fwd_batched": (members * hidden_mm, members * fwd_s,
                                 members * 2 * n * hidden * (in_size + out_size),
                                 4 * n * in_size + members * (4 * n * out_size + weights)),
        # K2 over `members` members: the backward's work each; x (shared) read
        # once, each member's g, weights and dx once, its partial slices written
        "sine_mlp_bwd_batched": (members * 3 * hidden_mm, members * bwd_s,
                                 members * 2 * n * hidden * (4 * in_size + 2 * out_size),
                                 4 * n * in_size + members * (4 * n * (in_size + out_size)
                                                              + weights + 4 * blocks * n_part)),
        "sum_partials_batched": (0, 0.0, members * blocks * n_part,
                                 4 * members * (blocks + 1) * n_part),
    }
    stash = 4 * (depth - 1) * n * hidden
    kernels["sine_mlp_fwd_stash"] = (hidden_mm, fwd_s, 2 * n * hidden * (in_size + out_size),
                                     4 * n * (in_size + out_size) + weights + stash)
    kernels["sine_mlp_bwd_stashed"] = (2 * hidden_mm, 2 * dw_s,
                                       2 * n * hidden * (2 * in_size + 2 * out_size),
                                       4 * n * (2 * in_size + out_size) + weights
                                       + 4 * blocks * n_part + stash)
    for name in ("sine_mlp_fwd_stash", "sine_mlp_bwd_stashed"):  # x shared, read once
        tc, tc_s, fma, nbytes = kernels[name]
        kernels[name + "_batched"] = (members * tc, members * tc_s, members * fma,
                                      members * (nbytes - 4 * n * in_size) + 4 * n * in_size)
    out = {}
    for name, (tc, tc_s, fma, nbytes) in kernels.items():
        mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = (tc_s + fma / FP32_FLOP_PER_S) * 1e3
        out[name] = {
            "flop": tc + fma, "bytes": nbytes,
            "bound_ms": max(mem_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= mem_ms else "bytes",
            "ffma_bound_ms": max(mem_ms, (tc + fma) / FP32_FLOP_PER_S * 1e3),
        }
    return out


def _max_rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _errors(kernel, plain):
    """(forward max abs error, {gradient: max rel error}, gradients' max abs
    error) of kernel results (out, dx, grads) against plain ones."""
    (out_k, dx_k, gr_k), (out_p, dx_p, gr_p) = kernel, plain
    pairs = [("dx", dx_k, dx_p)] + [
        (f"{i}.{k}", gr_k[i][k], gr_p[i][k]) for i in range(DEPTH) for k in ("w", "b")
    ]
    rel = {name: _max_rel(a, b) for name, a, b in pairs}
    bwd_abs = max(float((a - b).abs().max()) for _, a, b in pairs)
    return float((out_k - out_p).abs().max()), rel, bwd_abs


def phase_kernels(width: int = WIDTH) -> dict:
    """Kernel vs plain at the main path's shapes (at hidden width `width`)
    in both precision modes; returns per-kernel records for the fp32 mode
    (the main path's).

    Each mode also reads a control: the other mode's kernel held to this
    mode's plain chain. The control must fail this mode's limits, so a
    kernel that got the precision wrong cannot pass them. The fp32 mode
    reads a second one: the plain chain with 1-pass TF32 products."""
    import torch

    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    dev = torch.device("cuda")
    mdef, mcfg = build_model("siren", depth=DEPTH, hidden_size=width)
    kernel_width = sm.kernel_width(width)
    gen = torch.Generator().manual_seed(0)
    params = mdef.init(gen, mcfg, dev)
    x = (get_grid(N_SIDE, N_SIDE, dev).reshape(-1, 2) - 0.5) * 2.0
    g = (torch.randn((x.shape[0], 3), generator=gen) / x.shape[0]).to(dev)
    kernel = {}
    for prec in sm.PRECISIONS:
        out_k = sm.sine_mlp_fwd(params, x, mcfg, prec)
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        dx_k, gr_k = sm.sine_mlp_bwd(params, x, g, mcfg, prec)
        torch.cuda.synchronize()
        for name, t in [("out", out_k), ("dx", dx_k)] + [
                (f"{i}.{k}", gr_k[i][k]) for i in range(DEPTH) for k in ("w", "b")]:
            if not torch.isfinite(t).all():
                raise AssertionError(f"{prec}: kernel result {name} is not finite")
        if float(dx_k.abs().max()) == 0.0:
            raise AssertionError(f"{prec}: coordinate gradient dx is zero")
        # a run repeats bit for bit (fixed orders of sums, no float atomics)
        again = (sm.sine_mlp_fwd(params, x, mcfg, prec),
                 *sm.sine_mlp_bwd(params, x, g, mcfg, prec))
        torch.cuda.synchronize()
        pairs = [(out_k, again[0]), (dx_k, again[1])] + [
            (gr_k[i][k], again[2][i][k]) for i in range(DEPTH) for k in ("w", "b")]
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"w{width} {prec}: the kernels do not repeat bit for bit")
        print(f"[3 kernels w{width} {prec}] forward and backward repeat bit for bit", flush=True)
        kernel[prec] = (out_k, dx_k, gr_k)

    records = {}
    for prec in sm.PRECISIONS:
        other = next(p for p in sm.PRECISIONS if p != prec)
        plain = (sm.siren_chain_reference(params, x, mcfg, prec),
                 *sm.siren_chain_backward_reference(params, x, g, mcfg, prec))
        torch.cuda.synchronize()
        fwd_err, rel, bwd_abs = _errors(kernel[prec], plain)
        worst = max(rel, key=rel.get)
        ctl_fwd, ctl_rel, _ = _errors(kernel[other], plain)
        ctl_worst = max(ctl_rel, key=ctl_rel.get)

        # the partial-gradient buffer the main path's backward hands sum_partials:
        # the kernel against its mirror (same order, bit for bit), against
        # itself, and against the library call (another order, SUM_TOL)
        in_size, out_size = params[0]["w"].shape[0], params[-1]["w"].shape[1]
        blocks, n_part, sizes = sm.partial_layout(x.shape[0], DEPTH, in_size, width, out_size,
                                                  dev)
        # the bound counts the model's width (the work the function needs);
        # the padded bound the kernel width it runs at (the work it does)
        bounds = _bounds(x.shape[0], in_size, out_size, DEPTH, width, blocks,
                         _grad_floats(in_size, width, out_size, DEPTH))
        padded = _bounds(x.shape[0], in_size, out_size, DEPTH, kernel_width, blocks, n_part)
        partials = torch.randn((blocks, n_part), generator=gen).to(dev)
        sum_k, sum_again = sm.sum_partials(partials), sm.sum_partials(partials)
        sum_m = sm.sum_partials_reference(partials)
        sum_p = partials.sum(0)
        torch.cuda.synchronize()
        groups = sm._lib().sum_partials_groups()
        sum_mirror_err = float((sum_k - sum_m).abs().max())
        sum_same = torch.equal(sum_k, sum_m) and torch.equal(sum_k, sum_again)
        sum_rel = float((sum_k - sum_p).abs().max()) / float(sum_p.abs().max())

        tag = f"w{width} (kernel width {kernel_width}) {prec}"
        fwd_ms = _time_ms(lambda: sm.sine_mlp_fwd(params, x, mcfg, prec))
        fwd_plain_ms = _time_ms(lambda: sm.siren_chain_reference(params, x, mcfg, prec))
        step_ms = _time_ms(lambda: (sm.sine_mlp_fwd(params, x, mcfg, prec),
                                    sm.sine_mlp_bwd(params, x, g, mcfg, prec)))
        step_plain_ms = _time_ms(lambda: (
            sm.siren_chain_reference(params, x, mcfg, prec),
            sm.siren_chain_backward_reference(params, x, g, mcfg, prec)))
        bwd_ms = _time_ms(lambda: sm.sine_mlp_bwd(params, x, g, mcfg, prec))
        bwd_plain_ms = _time_ms(
            lambda: sm.siren_chain_backward_reference(params, x, g, mcfg, prec))
        sum_plain_ms = _time_ms(lambda: sm.sum_partials_reference(partials))
        sum_fns = [lambda: sm.sum_partials(partials), lambda: partials.sum(0)]
        eager = _interleaved_ms(sum_fns)
        (sum_rounds, lib_rounds) = _graph_interleaved_ms(sum_fns)
        sum_ms, lib_ms = statistics.median(sum_rounds), statistics.median(lib_rounds)
        sum_bound = bounds["sum_partials"]["bound_ms"]
        print(
            f"[3 kernels {tag}] fwd max_abs_err {fwd_err:.3e} (tol {FWD_TOL[prec]:g}); "
            f"bwd max rel err {rel[worst]:.3e} at {worst} (tol {BWD_TOL[prec]:g}), "
            f"max abs err {bwd_abs:.3e}; sum_partials ({blocks} x {n_part}, {groups} row "
            f"groups) vs its mirror max abs err {sum_mirror_err:.3e}, "
            f"{'the same bits twice' if sum_same else 'BITS DIFFER'}; vs partials.sum(0) "
            f"rel err {sum_rel:.3e} (tol {SUM_TOL:g})",
            flush=True,
        )
        for how, (k_rounds, l_rounds) in (("from CUDA graphs (device time)",
                                           (sum_rounds, lib_rounds)),
                                          ("from Python (host included)", eager)):
            k_ms, l_ms = statistics.median(k_rounds), statistics.median(l_rounds)
            print(
                f"[3 kernels {tag}] sum_partials in turns with partials.sum(0), 5 rounds x 20 "
                f"launches {how}, ms: kernel {' '.join(f'{t:.4f}' for t in k_rounds)} (median "
                f"{k_ms:.4f} = {sum_bound / k_ms:.1%} of the {sum_bound:.4f} ms bound); library "
                f"{' '.join(f'{t:.4f}' for t in l_rounds)} (median {l_ms:.4f} = "
                f"{sum_bound / l_ms:.1%})",
                flush=True,
            )
        print(f"[3 kernels {tag}] sum_partials_reference (the mirror): {sum_plain_ms:.4f} ms",
              flush=True)
        print(
            f"[3 kernels {tag}] control, the {other} kernel vs the {prec} plain chain: "
            f"fwd max_abs_err {ctl_fwd:.3e}; bwd max rel err {ctl_rel[ctl_worst]:.3e} "
            f"at {ctl_worst}",
            flush=True,
        )
        print(
            f"[3 kernels {tag}] ms per forward: kernel {fwd_ms:.3f}, plain "
            f"{fwd_plain_ms:.3f}; ms per forward+backward: kernel {step_ms:.3f}, "
            f"plain {step_plain_ms:.3f}; backward alone: kernel {bwd_ms:.3f}, plain "
            f"{bwd_plain_ms:.3f}",
            flush=True,
        )
        if prec == "bf16":
            b16 = _bounds(x.shape[0], in_size, out_size, DEPTH, width, blocks,
                          _grad_floats(in_size, width, out_size, DEPTH), bf16=True)
            b16 = b16["sine_mlp_bwd"]
            print(f"[3 kernels {tag}] sine_mlp_bwd: {b16['flop'] / 1e9:.3f} GFLOP; bound "
                  f"{b16['bound_ms']:.4f} ms ({b16['bound_by']}; one bf16 pass a product); "
                  f"kernel {bwd_ms:.4f} ms = {b16['bound_ms'] / bwd_ms:.1%} of bound",
                  flush=True)
        if not fwd_err <= FWD_TOL[prec]:
            raise AssertionError(f"{prec}: forward kernel disagrees: {fwd_err}")
        if not rel[worst] <= BWD_TOL[prec]:
            raise AssertionError(f"{prec}: backward kernel disagrees at {worst}: {rel}")
        if not (ctl_fwd > FWD_TOL[prec] and ctl_rel[ctl_worst] > BWD_TOL[prec]):
            raise AssertionError(f"{prec}: the limits pass the {other} kernel as well")
        if groups != sm.SUM_PARTIALS_GROUPS:
            raise AssertionError(f"the library splits rows into {groups} groups, the mirror "
                                 f"into {sm.SUM_PARTIALS_GROUPS}")
        if not sum_same:
            raise AssertionError(f"sum_partials is not its mirror's bits, or does not repeat "
                                 f"(max abs err {sum_mirror_err})")
        if not sum_rel <= SUM_TOL:
            raise AssertionError(f"sum_partials disagrees with partials.sum(0): {sum_rel}")
        if prec == "fp32":
            # the second control: 1-pass TF32 products in the plain chain        if prec == "fp32":
            # the second control: 1-pass TF32 products in the plain chain
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = (sm.siren_chain_reference(params, x, mcfg, prec),
                        *sm.siren_chain_backward_reference(params, x, g, mcfg, prec))
                torch.cuda.synchronize()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            tf32_fwd, tf32_rel, _ = _errors(tf32, plain)
            tf32_worst = max(tf32_rel, key=tf32_rel.get)
            print(
                f"[3 kernels {tag}] control, the plain chain with 1-pass TF32 products: "
                f"fwd max_abs_err {tf32_fwd:.3e}; bwd max rel err {tf32_rel[tf32_worst]:.3e} "
                f"at {tf32_worst}",
                flush=True,
            )
            if not (tf32_fwd > FWD_TOL[prec] or tf32_rel[tf32_worst] > BWD_TOL[prec]):
                raise AssertionError("fp32: the limits pass 1-pass TF32 products as well")
            records = {
                "sine_mlp_fwd": (fwd_err, fwd_ms, fwd_plain_ms, None),
                "sine_mlp_bwd": (bwd_abs, bwd_ms, bwd_plain_ms, None),
                # plain: the mirror; partials.sum(0) is one PyTorch call for
                # the same function
                "sum_partials": (sum_mirror_err, sum_ms, sum_plain_ms, lib_ms),
            }
            for name, (_, ms, _, _) in records.items():
                b, pb = bounds[name], padded[name]
                print(
                    f"[3 kernels {tag}] {name}: {b['flop'] / 1e9:.3f} GFLOP, "
                    f"{b['bytes'] / 1e6:.3f} MB at width {width}; bound {b['bound_ms']:.4f} ms "
                    f"({b['bound_by']}; FFMA-only bound {b['ffma_bound_ms']:.4f} ms); "
                    f"kernel {ms:.4f} ms = {b['bound_ms'] / ms:.1%} of bound; at the kernel "
                    f"width {kernel_width}: {pb['flop'] / 1e9:.3f} GFLOP, bound "
                    f"{pb['bound_ms']:.4f} ms (FFMA-only {pb['ffma_bound_ms']:.4f})",
                    flush=True,
                )
            records = {name: (*rec, bounds[name], padded[name]["bound_ms"])
                       for name, rec in records.items()}
    return records


def phase_batched_kernel(width: int) -> tuple:
    """Phase 3, K1 over a member axis: BATCH_MEMBERS SIRENs of hidden width
    `width` on one 512² grid in one launch, in both modes: each member the
    bits of its single launch, within FWD_TOL of the plain version (and the
    other mode's batched kernel outside it); timed in turns with one single
    launch. Returns the kernels line's record of the fp32 mode."""
    import torch

    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    dev = torch.device("cuda")
    mdef, mcfg = build_model("siren", depth=DEPTH, hidden_size=width)
    gen = torch.Generator().manual_seed(10)
    members = [mdef.init(gen, mcfg, dev) for _ in range(BATCH_MEMBERS)]
    x = (get_grid(N_SIDE, N_SIDE, dev).reshape(-1, 2) - 0.5) * 2.0
    outs = {p: sm.sine_mlp_fwd_batched(members, x, mcfg, p) for p in sm.PRECISIONS}
    torch.cuda.synchronize()
    tag = f"[3 kernels w{width} batched x{BATCH_MEMBERS}]"
    record = None
    for prec in sm.PRECISIONS:
        other = next(p for p in sm.PRECISIONS if p != prec)
        singles = torch.stack([sm.sine_mlp_fwd(p, x, mcfg, prec) for p in members])
        plain = sm.siren_chain_reference_batched(members, x, mcfg, prec)
        torch.cuda.synchronize()
        same = torch.equal(outs[prec], singles)
        err = float((outs[prec] - plain).abs().max())
        ctl = float((outs[other] - plain).abs().max())
        print(f"{tag} {prec}: {'the bits of' if same else 'BITS DIFFER FROM'} "
              f"{BATCH_MEMBERS} single launches; vs plain max_abs_err {err:.3e} (tol "
              f"{FWD_TOL[prec]:g}); control, the {other} batched kernel: {ctl:.3e}", flush=True)
        if not same:
            raise AssertionError(f"{tag} {prec}: not the bits of the single launches")
        if not err <= FWD_TOL[prec] < ctl:
            raise AssertionError(f"{tag} {prec}: max abs err {err}, control {ctl}")
        if prec == "fp32":
            single_r, batched_r = _interleaved_ms(
                [lambda: sm.sine_mlp_fwd(members[0], x, mcfg, prec),
                 lambda: sm.sine_mlp_fwd_batched(members, x, mcfg, prec)], rounds=3, reps=5)
            plain_ms = _time_ms(lambda: sm.siren_chain_reference_batched(members, x, mcfg,
                                                                         prec), 1)
            single_ms, ms = statistics.median(single_r), statistics.median(batched_r)
            in_size, out_size = params_io = (members[0][0]["w"].shape[0],
                                             members[0][-1]["w"].shape[1])
            blocks, n_part, _ = sm.partial_layout(x.shape[0], DEPTH, in_size, width, out_size,
                                                  dev)
            bound = _bounds(x.shape[0], *params_io, DEPTH, width, blocks,
                            _grad_floats(in_size, width, out_size, DEPTH))["sine_mlp_fwd_batched"]
            padded = _bounds(x.shape[0], *params_io, DEPTH, sm.kernel_width(width), blocks,
                             n_part)["sine_mlp_fwd_batched"]["bound_ms"]
            print(f"{tag} ms in turns (3 rounds x 5 launches, CUDA events): batched "
                  f"{' '.join(f'{t:.3f}' for t in batched_r)} (median {ms:.3f} = "
                  f"{ms / BATCH_MEMBERS:.4f} per member); one single launch "
                  f"{' '.join(f'{t:.3f}' for t in single_r)} (median {single_ms:.4f}); plain "
                  f"{plain_ms:.3f}; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}) = "
                  f"{bound['bound_ms'] / ms:.1%}", flush=True)
            record = (err, ms, plain_ms, None, bound, padded)
    return record


def phase_mixed_batched(width: int) -> dict:
    """Phase 3, K1 and K2 over a member axis in "+mixed" (train.mixed_precision
    in the fp32 mode, the batched fit's): BATCH_MEMBERS SIRENs of hidden
    width `width` on one 512² grid, each member the bits of its single
    "+mixed" launch (forward, and dx, dW, db of the backward), within the
    mixed limits of phase 12b against the plain "+mixed" chain; the
    bf16+mixed instantiations for their bits too. Timed in turns with one
    single launch. Returns the kernels line's records."""
    import torch

    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    dev = torch.device("cuda")
    mdef, mcfg = build_model("siren", depth=DEPTH, hidden_size=width)
    gen = torch.Generator().manual_seed(13)
    members = [mdef.init(gen, mcfg, dev) for _ in range(BATCH_MEMBERS)]
    x = (get_grid(N_SIDE, N_SIDE, dev).reshape(-1, 2) - 0.5) * 2.0
    n = x.shape[0]
    g = (torch.randn((BATCH_MEMBERS, n, 3), generator=gen) / n).to(dev)
    tag = f"[3 kernels w{width} batched +mixed x{BATCH_MEMBERS}]"
    records = {}
    for mode in sm.PRECISIONS:
        prec = mode + sm.MIXED
        fwd = sm.sine_mlp_fwd_batched(members, x, mcfg, prec)
        bwd = _bwd_pairs(*sm.sine_mlp_bwd_batched(members, x, g, mcfg, prec))
        same_f = torch.equal(fwd, torch.stack([sm.sine_mlp_fwd(p, x, mcfg, prec)
                                               for p in members]))
        same_b = True
        for m, params in enumerate(members):
            single = _bwd_pairs(*sm.sine_mlp_bwd(params, x, g[m], mcfg, prec))
            same_b &= all(torch.equal(t[m], s) for (_, t), (_, s) in zip(bwd, single))
        torch.cuda.synchronize()
        print(f"{tag} {prec}: forward {'the bits of' if same_f else 'BITS DIFFER FROM'} and "
              f"backward {'the bits of' if same_b else 'BITS DIFFER FROM'} {BATCH_MEMBERS} "
              "single launches", flush=True)
        if not (same_f and same_b):
            raise AssertionError(f"{tag} {prec}: not the bits of the single launches")
        plain_f = sm.siren_chain_reference_batched(members, x, mcfg, prec)
        plain_b = _bwd_pairs(*sm.siren_chain_backward_reference_batched(members, x, g, mcfg,
                                                                        prec))
        torch.cuda.synchronize()
        fwd_err = float((fwd - plain_f).abs().max())
        worst, rel = max(((name, _max_rel(t, p)) for (name, t), (_, p) in zip(bwd, plain_b)),
                         key=lambda e: e[1])
        bwd_abs = max(float((t - p).abs().max()) for (_, t), (_, p) in zip(bwd, plain_b))
        print(f"{tag} {prec} vs plain: fwd max_abs_err {fwd_err:.3e} (tol {FWD_TOL['bf16']:g}); "
              f"bwd max rel err {rel:.3e} at {worst} (tol {BWD_TOL['bf16']:g})", flush=True)
        if not (fwd_err <= FWD_TOL["bf16"] and rel <= BWD_TOL["bf16"]):
            raise AssertionError(f"{tag}: the kernels disagree with the plain chain: "
                                 f"{fwd_err}, {rel}")
        del plain_b
        if mode != "fp32":
            continue
        blocks, n_part, _ = sm.partial_layout(n, DEPTH, 2, width, 3, dev)
        bounds = _bounds(n, 2, 3, DEPTH, width, blocks, _grad_floats(2, width, 3, DEPTH),
                         mixed=True)
        padded = _bounds(n, 2, 3, DEPTH, sm.kernel_width(width), blocks, n_part, mixed=True)
        for name, batched_fn, single_fn, plain_fn, err in (
                ("sine_mlp_fwd_batched",
                 lambda: sm.sine_mlp_fwd_batched(members, x, mcfg, prec),
                 lambda: sm.sine_mlp_fwd(members[0], x, mcfg, prec),
                 lambda: sm.siren_chain_reference_batched(members, x, mcfg, prec), fwd_err),
                ("sine_mlp_bwd_batched",
                 lambda: sm.sine_mlp_bwd_batched(members, x, g, mcfg, prec),
                 lambda: sm.sine_mlp_bwd(members[0], x, g[0], mcfg, prec),
                 lambda: sm.siren_chain_backward_reference_batched(members, x, g, mcfg, prec),
                 bwd_abs)):
            single_r, batched_r = _interleaved_ms([single_fn, batched_fn], rounds=3, reps=5)
            plain_ms = _time_ms(plain_fn, 1)
            ms, single_ms = statistics.median(batched_r), statistics.median(single_r)
            bound = bounds[name]
            print(f"{tag} {name} ms in turns (3 rounds x 5 launches, CUDA events): batched "
                  f"{' '.join(f'{t:.3f}' for t in batched_r)} (median {ms:.3f} = "
                  f"{ms / BATCH_MEMBERS:.4f} per member); one single launch "
                  f"{' '.join(f'{t:.3f}' for t in single_r)} (median {single_ms:.4f}); plain "
                  f"{plain_ms:.3f}; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}) = "
                  f"{bound['bound_ms'] / ms:.1%}", flush=True)
            records[name + sm.MIXED] = (err, ms, plain_ms, None, bound,
                                        padded[name]["bound_ms"])
    torch.cuda.empty_cache()
    return records


def _bwd_pairs(dx, grads):
    return [("dx", dx)] + [(f"{i}.{k}", layer[k]) for i, layer in enumerate(grads)
                           for k in ("w", "b")]


def phase_batched_backward(width: int) -> dict:
    """Phase 3, K2 over a member axis: BATCH_MEMBERS SIRENs of hidden width
    `width` on one 512² grid, one cotangent each, in both modes: each
    member's dx, dW and db the bits of its single launch and within BWD_TOL
    of the plain version (the other mode's batched kernels outside it); the
    batched backward timed in turns with one single launch, its bound 8
    backwards' work. The member-axis partial sum alone, on this backward's
    shapes: the bits of its plain mirror, timed from CUDA graphs in turns
    with one PyTorch call for the same function (the member-axis
    layer-wise sine_mlp_layer_dw: phase_layer_kernels). Returns the kernels
    line's records (fp32 mode)."""
    import torch

    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    dev = torch.device("cuda")
    mdef, mcfg = build_model("siren", depth=DEPTH, hidden_size=width)
    kw = sm.kernel_width(width)
    gen = torch.Generator().manual_seed(11)
    members = [mdef.init(gen, mcfg, dev) for _ in range(BATCH_MEMBERS)]
    x = (get_grid(N_SIDE, N_SIDE, dev).reshape(-1, 2) - 0.5) * 2.0
    n = x.shape[0]
    g = (torch.randn((BATCH_MEMBERS, n, 3), generator=gen) / n).to(dev)
    outs = {p: sm.sine_mlp_bwd_batched(members, x, g, mcfg, p) for p in sm.PRECISIONS}
    torch.cuda.synchronize()
    tag = f"[3 kernels w{width} batched backward x{BATCH_MEMBERS}]"
    blocks, n_part, _ = sm.partial_layout(n, DEPTH, 2, width, 3, dev)
    records = {}
    for prec in sm.PRECISIONS:
        other = next(p for p in sm.PRECISIONS if p != prec)
        same = True
        for m, params in enumerate(members):
            single = _bwd_pairs(*sm.sine_mlp_bwd(params, x, g[m], mcfg, prec))
            same &= all(torch.equal(t[m], s) for (_, t), (_, s) in
                        zip(_bwd_pairs(*outs[prec]), single))
        plain = _bwd_pairs(*sm.siren_chain_backward_reference_batched(members, x, g, mcfg, prec))
        torch.cuda.synchronize()

        def rel(result):
            return max(((name, _max_rel(t, p)) for (name, t), (_, p) in
                        zip(_bwd_pairs(*result), plain)), key=lambda e: e[1])

        (worst, err), (ctl_at, ctl) = rel(outs[prec]), rel(outs[other])
        abs_err = max(float((t - p).abs().max()) for (_, t), (_, p) in
                      zip(_bwd_pairs(*outs[prec]), plain))
        print(f"{tag} {prec}: {'the bits of' if same else 'BITS DIFFER FROM'} "
              f"{BATCH_MEMBERS} single launches; vs plain max rel err {err:.3e} at {worst} "
              f"(tol {BWD_TOL[prec]:g}), max abs err {abs_err:.3e}; control, the {other} "
              f"batched kernels: {ctl:.3e} at {ctl_at}", flush=True)
        if not same:
            raise AssertionError(f"{tag} {prec}: not the bits of the single launches")
        if not err <= BWD_TOL[prec] < ctl:
            raise AssertionError(f"{tag} {prec}: max rel err {err}, control {ctl}")
        if prec != "fp32":
            continue
        single_r, batched_r = _interleaved_ms(
            [lambda: sm.sine_mlp_bwd(members[0], x, g[0], mcfg, prec),
             lambda: sm.sine_mlp_bwd_batched(members, x, g, mcfg, prec)], rounds=3, reps=5)
        plain_ms = _time_ms(lambda: sm.siren_chain_backward_reference_batched(
            members, x, g, mcfg, prec), 1)
        single_ms, ms = statistics.median(single_r), statistics.median(batched_r)
        bounds = _bounds(n, 2, 3, DEPTH, width, blocks, _grad_floats(2, width, 3, DEPTH))
        padded = _bounds(n, 2, 3, DEPTH, kw, blocks, n_part)
        bound = bounds["sine_mlp_bwd_batched"]
        print(f"{tag} ms in turns (3 rounds x 5 launches, CUDA events): batched "
              f"{' '.join(f'{t:.3f}' for t in batched_r)} (median {ms:.3f} = "
              f"{ms / BATCH_MEMBERS:.4f} per member); one single launch "
              f"{' '.join(f'{t:.3f}' for t in single_r)} (median {single_ms:.4f}); plain "
              f"{plain_ms:.3f}; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}, "
              f"{bound['flop'] / 1e9:.1f} GFLOP, {bound['bytes'] / 1e6:.1f} MB) = "
              f"{bound['bound_ms'] / ms:.1%}", flush=True)
        records["sine_mlp_bwd_batched"] = (abs_err, ms, plain_ms, None, bound,
                                           padded["sine_mlp_bwd_batched"]["bound_ms"])

        # the member-axis partial sum alone, on buffers of this backward's shape
        partials = torch.randn((BATCH_MEMBERS, blocks, n_part), device=dev,
                               generator=torch.Generator(dev).manual_seed(12))
        sums = sm.sum_partials_batched(partials)
        mirror = torch.stack([sm.sum_partials_reference(t) for t in partials])
        lib = partials.sum(1)
        torch.cuda.synchronize()
        sum_same = torch.equal(sums, mirror) and torch.equal(sums, sm.sum_partials_batched(
            partials))
        sum_err = float((sums - mirror).abs().max())
        sum_rel = float((sums - lib).abs().max()) / float(lib.abs().max())
        k_r, l_r = _graph_interleaved_ms([lambda: sm.sum_partials_batched(partials),
                                          lambda: partials.sum(1)])
        k_ms, l_ms = statistics.median(k_r), statistics.median(l_r)
        m_ms = _time_ms(lambda: [sm.sum_partials_reference(t) for t in partials], 1)
        sb = bounds["sum_partials_batched"]
        print(f"{tag} sum_partials_batched ({BATCH_MEMBERS} x {blocks} x {n_part}): "
              f"{'the bits of its mirror, twice' if sum_same else 'BITS DIFFER'} (max abs err "
              f"{sum_err:.3e}); vs "
              f"partials.sum(1) rel err {sum_rel:.3e} (tol {SUM_TOL:g}); in turns from CUDA "
              f"graphs, ms: kernel {' '.join(f'{t:.4f}' for t in k_r)} (median {k_ms:.4f} = "
              f"{sb['bound_ms'] / k_ms:.1%} of the {sb['bound_ms']:.4f} ms bound); "
              f"partials.sum(1) {' '.join(f'{t:.4f}' for t in l_r)} (median {l_ms:.4f}); "
              f"mirror {m_ms:.3f}", flush=True)
        if not sum_same or not sum_rel <= SUM_TOL:
            raise AssertionError(f"{tag} sum_partials_batched: same {sum_same}, rel {sum_rel}")
        records["sum_partials_batched"] = (sum_err, k_ms, m_ms, l_ms, sb,
                                           padded["sum_partials_batched"]["bound_ms"])
        del partials

    torch.cuda.empty_cache()
    return records


def _layer_pair(params, x, g, mcfg, prec):
    """K1 and K2 of one SIREN on the card, synchronised: (out, dx, grads)."""
    import torch

    from implicit_image_tpu_torch.ops import sine_mlp as sm

    out = sm.sine_mlp_fwd(params, x, mcfg, prec)
    torch.cuda.synchronize()  # a fault in the kernels surfaces here
    dx, grads = sm.sine_mlp_bwd(params, x, g, mcfg, prec)
    torch.cuda.synchronize()
    return out, dx, grads


def _autograd_forward(members, x, mcfg, prec):
    """K1 under autograd as a fit step runs it above 192, on one params
    tuple or over a member axis (a list; x shared): the Function with the
    stash, on leaves and x that require grad -> (out, x, leaves). Its node
    (out.grad_fn) holds the z stash until the backward uses it up."""
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    batched = isinstance(members, list)
    leaves = [{k: layer[k].detach().clone().requires_grad_(True) for k in ("w", "b")}
              for layer in (sm.stack_members(members) if batched else members)]
    xg = x.detach().clone().requires_grad_(True)
    fn = sm.SineMLPBatchedFunction if batched else sm.SineMLPFunction
    out = fn.apply(xg, mcfg, prec, True, *[layer[k] for layer in leaves for k in ("w", "b")])
    return out, xg, leaves


def _autograd_pair(members, x, g, mcfg, prec):
    """K1 and K2 under autograd (`_autograd_forward`, then out.backward(g)),
    synchronised: ((out, dx, grads), whether K1's stash is the bits of K2's
    recompute (`sine_mlp_layer_stash`, the same members and x), the
    launches K1 added, those K2 added)."""
    import torch

    from implicit_image_tpu_torch.ops import sine_mlp as sm

    before = dict(sm.LAUNCHES)
    out, xg, leaves = _autograd_forward(members, x, mcfg, prec)
    torch.cuda.synchronize()
    k1 = {k: sm.LAUNCHES[k] - before[k] for k in before}
    recompute = sm.sine_mlp_layer_stash(members if isinstance(members, list) else [members], x,
                                        mcfg, prec)
    same_stash = torch.equal(out.grad_fn.z, recompute)
    del recompute
    before = dict(sm.LAUNCHES)
    out.backward(g)
    torch.cuda.synchronize()
    k2 = {k: sm.LAUNCHES[k] - before[k] for k in before}
    if out.grad_fn.z is not None:
        raise AssertionError("the Function kept the z stash after its backward")
    grads = [{k: v.grad for k, v in layer.items()} for layer in leaves]
    return (out.detach(), xg.grad, grads), same_stash, k1, k2


def _autograd_ms(members, x, g, mcfg, prec, rounds: int = 3) -> dict:
    """Medians (ms) over `rounds` rounds after one to warm up, each timing in
    turns, one call each between CUDA events: the API's K1 and K2
    (sine_mlp_fwd / sine_mlp_bwd, or their member-axis forms over a list),
    then K1 under autograd (filling the stash) and K2 under autograd
    (out.backward, taking it), twice: "k1_first" / "k2_first" straight
    after the API's calls, then "k1" / "k2", the reading, after that pair,
    as a fit step runs the pair after the step before."""
    import torch

    from implicit_image_tpu_torch.ops import sine_mlp as sm

    if isinstance(members, list):
        api_fwd = lambda: sm.sine_mlp_fwd_batched(members, x, mcfg, prec)  # noqa: E731
        api_bwd = lambda: sm.sine_mlp_bwd_batched(members, x, g, mcfg, prec)  # noqa: E731
    else:
        api_fwd = lambda: sm.sine_mlp_fwd(members, x, mcfg, prec)  # noqa: E731
        api_bwd = lambda: sm.sine_mlp_bwd(members, x, g, mcfg, prec)  # noqa: E731
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(fn):
        torch.cuda.synchronize()
        start.record()
        got = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), got

    times = {"api_k1": [], "api_k2": [], "k1_first": [], "k2_first": [], "k1": [], "k2": []}
    for _ in range(rounds + 1):
        times["api_k1"].append(timed(api_fwd)[0])
        times["api_k2"].append(timed(api_bwd)[0])
        for suffix in ("_first", ""):
            ms, (out, _, _) = timed(lambda: _autograd_forward(members, x, mcfg, prec))
            times["k1" + suffix].append(ms)
            times["k2" + suffix].append(timed(lambda: out.backward(g))[0])
            del out
    return {k: statistics.median(t[1:]) for k, t in times.items()}


def _same_bits(a, b) -> bool:
    """(out, dx, grads) triples equal bit for bit."""
    import torch

    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and all(torch.equal(x[k], y[k]) for x, y in zip(a[2], b[2]) for k in ("w", "b")))


def phase_layer_kernels(width: int, pairs_only: bool = False):
    """Phase 3 above 192: the layer-wise kernels at hidden width `width` on
    the main path's shapes (512², d8): K1 and K2 against the plain chain in
    every mode (LAYER_TOL; as controls the other mode's kernels fail the
    fp32 and bf16 limits), repeating bit for bit; over LAYER_MEMBERS members
    (one launch each of the member-axis kernels), each member the bits of
    its single launches, in every mode, timed in turns with one single
    launch; sine_mlp_layer_dw alone on the chain's own dW operands of one
    layer against its plain version (DW_TOL), twice for bits, in turns with
    one fp32 torch.mm from CUDA graphs; one hidden layer of K1 and one of
    K2 alone the same way (_layer_bwd_alone); the backward's partial buffer
    against its plain mirror (siren_chain_layer_partials, the same slices
    and splits) and sum_partials over it bit for bit its mirror's order.
    Returns the kernels line's records (fp32). With `pairs_only` (a width
    no path runs) it stops after the pairs, their member axis, their
    autograd form and their times, and returns None."""
    import torch
    import torch.nn.functional as F

    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    dev = torch.device("cuda")
    mdef, mcfg = build_model("siren", depth=DEPTH, hidden_size=width)
    kw = sm.kernel_width(width)
    gen = torch.Generator().manual_seed(0)
    members = [mdef.init(gen, mcfg, dev) for _ in range(LAYER_MEMBERS)]
    params = members[0]
    x = (get_grid(N_SIDE, N_SIDE, dev).reshape(-1, 2) - 0.5) * 2.0
    n = x.shape[0]
    gs = (torch.randn((LAYER_MEMBERS, n, 3), generator=gen) / n).to(dev)
    g = gs[0]
    slices, n_part, sizes = sm.partial_layout(n, DEPTH, 2, width, 3, dev)
    bounds = _bounds(n, 2, 3, DEPTH, width, slices, _grad_floats(2, width, 3, DEPTH),
                     members=LAYER_MEMBERS)
    padded = _bounds(n, 2, 3, DEPTH, kw, slices, n_part, members=LAYER_MEMBERS)
    tag = f"[3 layer kernels w{width} (kernel width {kw}, {slices} slices)]"
    kernel, plains, records = {}, {}, {}
    for prec in LAYER_TOL:
        sm.reset_launch_counts()
        first = _layer_pair(params, x, g, mcfg, prec)
        launched = dict(sm.LAUNCHES)
        again = _layer_pair(params, x, g, mcfg, prec)
        want = {k: 0 for k in launched} | {
            "sine_mlp_layer_fwd": DEPTH * -(-n // sm.layer_band_rows(kw)) + DEPTH - 1,
            "sine_mlp_layer_bwd": DEPTH, "sine_mlp_layer_dw": DEPTH - 2, "sum_partials": 1}
        if launched != want:
            raise AssertionError(f"{tag} {prec}: launches {launched}, expected {want}")
        if not _same_bits(first, again):
            raise AssertionError(f"{tag} {prec}: the kernels do not repeat bit for bit")
        for name, t in [("out", first[0]), ("dx", first[1])] + [
                (f"{i}.{k}", first[2][i][k]) for i in range(DEPTH) for k in ("w", "b")]:
            if not torch.isfinite(t).all():
                raise AssertionError(f"{tag} {prec}: kernel result {name} is not finite")
        kernel[prec] = first
        # over the member axis: each member its single launches' bits
        out_b = sm.sine_mlp_fwd_batched(members, x, mcfg, prec)
        dx_b, gr_b = sm.sine_mlp_bwd_batched(members, x, gs, mcfg, prec)
        torch.cuda.synchronize()
        same = True
        for m, p in enumerate(members):
            one = first if m == 0 else _layer_pair(p, x, gs[m], mcfg, prec)
            same = same and _same_bits((out_b[m], dx_b[m], [{k: v[k][m] for k in ("w", "b")}
                                                             for v in gr_b]), one)
        # under autograd, as a fit step runs them: K1 fills the z stash, K2
        # takes it (no recompute); each member's results the API's bits
        ag, stash_same, ag_k1, ag_k2 = _autograd_pair(params, x, g, mcfg, prec)
        agb, stash_same_b, agb_k1, agb_k2 = _autograd_pair(members, x, gs, mcfg, prec)
        ag_same = _same_bits(ag, first) and _same_bits(agb, (out_b, dx_b.sum(0), gr_b))
        del out_b, dx_b, gr_b, ag, agb
        ag_want = [{k: 0 for k in launched} | {
            "sine_mlp_layer_fwd" + sfx: DEPTH * -(-n // sm.layer_band_rows(kw, mm))}
            for sfx, mm in (("", 1), ("_batched", LAYER_MEMBERS))]
        ag_want += [{k: 0 for k in launched} | {
            "sine_mlp_layer_bwd" + sfx: DEPTH, "sine_mlp_layer_dw" + sfx: DEPTH - 2,
            "sum_partials" + sfx: 1} for sfx in ("", "_batched")]
        print(f"{tag} {prec} under autograd (K1 fills the z stash, K2 takes it): out, dx and "
              f"grads {'the bits of' if ag_same else 'DIFFER FROM'} the API pair's, single "
              f"and over {LAYER_MEMBERS} members; K1's stash "
              f"{'the bits of' if stash_same and stash_same_b else 'DIFFERS FROM'} K2's "
              f"recompute (one pass over the rows, K1 in {-(-n // sm.layer_band_rows(kw))} / "
              f"{-(-n // sm.layer_band_rows(kw, LAYER_MEMBERS))} bands); K2's launches "
              f"{ {k: v for k, v in ag_k2.items() if v} }, over the members "
              f"{ {k: v for k, v in agb_k2.items() if v} }", flush=True)
        if not (ag_same and stash_same and stash_same_b):
            raise AssertionError(f"{tag} {prec}: autograd bits {ag_same}, stash bits "
                                 f"{stash_same} / {stash_same_b}")
        if [ag_k1, agb_k1, ag_k2, agb_k2] != ag_want:
            raise AssertionError(f"{tag} {prec}: autograd launches {[ag_k1, agb_k1, ag_k2, agb_k2]},"
                                 f" expected {ag_want}")
        plain = (sm.siren_chain_reference(params, x, mcfg, prec),
                 *sm.siren_chain_backward_reference(params, x, g, mcfg, prec))
        torch.cuda.synchronize()
        fwd_err, rel, bwd_abs = _errors(first, plain)
        worst = max(rel, key=rel.get)
        fwd_tol, bwd_tol = LAYER_TOL[prec]
        print(f"{tag} {prec}: fwd max_abs_err {fwd_err:.3e} (tol {fwd_tol:g}); bwd max rel "
              f"err {rel[worst]:.3e} at {worst} (tol {bwd_tol:g}), max abs err {bwd_abs:.3e}; "
              f"repeats bit for bit; {LAYER_MEMBERS} members over the member axis "
              f"{'each the bits of its single launches' if same else 'BITS DIFFER'}",
              flush=True)
        if not (fwd_err <= fwd_tol and rel[worst] <= bwd_tol and same):
            raise AssertionError(f"{tag} {prec}: fwd {fwd_err}, bwd {rel}, member bits {same}")
        if prec not in sm.PRECISIONS:  # "+mixed": held above, timed in its modes' rows
            continue
        plains[prec] = plain  # outputs and gradients only: MBs
        fwd_ms = _time_ms(lambda: sm.sine_mlp_fwd(params, x, mcfg, prec), 3)
        bwd_ms = _time_ms(lambda: sm.sine_mlp_bwd(params, x, g, mcfg, prec), 3)
        fwd_plain = _time_ms(lambda: sm.siren_chain_reference(params, x, mcfg, prec), 2)
        bwd_plain = _time_ms(
            lambda: sm.siren_chain_backward_reference(params, x, g, mcfg, prec), 2)
        bf16, mixed = sm.precision_modes(prec)
        own = _bounds(n, 2, 3, DEPTH, width, slices, _grad_floats(2, width, 3, DEPTH),
                      members=LAYER_MEMBERS, mixed=mixed and not bf16, bf16=bf16)
        f_b, b_b = own["sine_mlp_fwd"]["bound_ms"], own["sine_mlp_bwd"]["bound_ms"]
        print(f"{tag} {prec}: ms per K1 {fwd_ms:.3f} = {f_b / fwd_ms:.1%} of its {f_b:.3f} ms "
              f"bound, K2 {bwd_ms:.3f} = {b_b / bwd_ms:.1%} of {b_b:.3f}; plain chain "
              f"{fwd_plain:.3f} / {bwd_plain:.3f}", flush=True)
        # the member-axis launches in turns with one single launch
        (fb, fs), (bb, bs) = (
            _interleaved_ms([lambda: sm.sine_mlp_fwd_batched(members, x, mcfg, prec),
                             lambda: sm.sine_mlp_fwd(params, x, mcfg, prec)], rounds=2, reps=2),
            _interleaved_ms([lambda: sm.sine_mlp_bwd_batched(members, x, gs, mcfg, prec),
                             lambda: sm.sine_mlp_bwd(params, x, g, mcfg, prec)], rounds=2,
                            reps=2))
        fb_ms, bb_ms = statistics.median(fb), statistics.median(bb)
        print(f"{tag} {prec} x{LAYER_MEMBERS}: K1 over the member axis {fb_ms:.3f} ms (single "
              f"in turns {statistics.median(fs):.3f}), K2 {bb_ms:.3f} (single "
              f"{statistics.median(bs):.3f})", flush=True)
        # under autograd, in turns with the API's calls, against the bounds
        # of the JAX pair's work and of the work the port now does
        ag_ms = _autograd_ms(params, x, g, mcfg, prec)
        agb_ms = _autograd_ms(members, x, gs, mcfg, prec, rounds=2)
        s_f, s_b = own["sine_mlp_fwd_stash"]["bound_ms"], own["sine_mlp_bwd_stashed"]["bound_ms"]
        pair = ag_ms["k1"] + ag_ms["k2"]
        print(f"{tag} {prec} under autograd, in turns (one call each, CUDA events): K1 filling "
              f"the stash {ag_ms['k1']:.3f} ms = {s_f / ag_ms['k1']:.1%} of its {s_f:.3f} ms "
              f"bound (the API's K1 {ag_ms['api_k1']:.3f}); K2 from the stash "
              f"{ag_ms['k2']:.3f} ms = {s_b / ag_ms['k2']:.1%} of its {s_b:.3f} ms bound, "
              f"{b_b / ag_ms['k2']:.1%} of the API K2's {b_b:.3f} (the API's K2 "
              f"{ag_ms['api_k2']:.3f}); K1 + K2 {pair:.3f} ms = {(f_b + b_b) / pair:.1%} of the "
              f"JAX pair's bound {f_b + b_b:.3f}, {(s_f + s_b) / pair:.1%} of the port's work's "
              f"{s_f + s_b:.3f}; the pair straight after the API's calls {ag_ms['k1_first']:.3f} "
              f"/ {ag_ms['k2_first']:.3f}; x{LAYER_MEMBERS}: K1 {agb_ms['k1']:.3f} (API "
              f"{agb_ms['api_k1']:.3f}), K2 {agb_ms['k2']:.3f} (API {agb_ms['api_k2']:.3f})",
              flush=True)
        if prec == "fp32":
            _layer_k2_split(lambda: sm.sine_mlp_bwd(params, x, g, mcfg, prec), tag, width, n)
            _layer_k2_split(lambda out: out.backward(g), tag + " under autograd", width, n,
                            prepare=lambda: _autograd_forward(params, x, mcfg, prec)[0])
            _layer_k1_split(lambda: _autograd_forward(params, x, mcfg, prec), tag, width, n)
            records["sine_mlp_layer_fwd"] = (fwd_err, ag_ms["k1"], fwd_plain, None)
            records["sine_mlp_layer_bwd"] = (bwd_abs, ag_ms["k2"], bwd_plain, None)
            batched = {
                "sine_mlp_layer_fwd_batched": (fwd_err, agb_ms["k1"], LAYER_MEMBERS * fwd_plain,
                                               None),
                "sine_mlp_layer_bwd_batched": (bwd_abs, agb_ms["k2"], LAYER_MEMBERS * bwd_plain,
                                               None)}
        torch.cuda.empty_cache()
    # controls: each mode's limits fail the other mode's kernels
    for prec, other in zip(sm.PRECISIONS, reversed(sm.PRECISIONS)):
        ctl_fwd, ctl_rel, _ = _errors(kernel[other], plains[prec])
        ctl_worst = max(ctl_rel, key=ctl_rel.get)
        print(f"{tag} control, the {other} kernels vs the {prec} plain chain: fwd max_abs_err "
              f"{ctl_fwd:.3e}; bwd max rel err {ctl_rel[ctl_worst]:.3e} at {ctl_worst}",
              flush=True)
        if not (ctl_fwd > LAYER_TOL[prec][0] and ctl_rel[ctl_worst] > LAYER_TOL[prec][1]):
            raise AssertionError(f"{tag} {prec}: the limits pass the {other} kernels as well")
    del kernel, plains
    if pairs_only:
        torch.cuda.empty_cache()
        return None

    # sine_mlp_layer_dw alone: one hidden layer's own operands, zero-padded
    prec = "fp32"
    ops = sm.siren_chain_dw_operands(params, x, g, mcfg, prec)
    # A_1 and G_1 (layer 1's dW operands), G_2 (the hidden backward's below)
    a, gz, g2 = (F.pad(t, (0, kw - width)).contiguous() for t in (ops[0][0], ops[1][0], ops[1][1]))
    del ops
    runs = []
    for _ in range(2):
        part = torch.zeros((slices, n_part), device=dev)
        sm.sine_mlp_layer_dw(a, gz, part, sizes[0], prec)
        runs.append(part[:, sizes[0]: sizes[0] + kw * kw].reshape(slices, kw, kw))
    plain_dw = sm.layer_dw_reference(a[None], gz[None], slices, prec)[:, 0]
    torch.cuda.synchronize()
    dw_err, scale = float((runs[0] - plain_dw).abs().max()), float(plain_dw.abs().max())
    dw_same = torch.equal(runs[0], runs[1])
    part = torch.empty((slices, n_part), device=dev)
    part_b = torch.empty((LAYER_MEMBERS, slices, n_part), device=dev)
    ab, gzb = a.expand(LAYER_MEMBERS, -1, -1).contiguous(), gz.expand(LAYER_MEMBERS, -1, -1).contiguous()
    k_r, kb_r, l_r = _graph_interleaved_ms(
        [lambda: sm.sine_mlp_layer_dw(a, gz, part, sizes[0], prec),
         lambda: sm.sine_mlp_layer_dw(ab, gzb, part_b, sizes[0], prec),
         lambda: torch.mm(a.t(), gz)], rounds=3, reps=3)
    dw_ms, dwb_ms, lib_ms = (statistics.median(r) for r in (k_r, kb_r, l_r))
    dw_plain = _time_ms(lambda: sm.layer_dw_reference(a[None], gz[None], slices, prec), 2)
    layers = DEPTH - 2
    # one layer's share of the hidden layers' dW bound
    dw_bound = dict(bounds["hidden_dw"], bound_ms=bounds["hidden_dw"]["bound_ms"] / layers,
                    flop=bounds["hidden_dw"]["flop"] // layers)
    print(f"{tag} sine_mlp_layer_dw (one layer, {slices} row splits) vs its plain version: "
          f"max abs err {dw_err:.3e} = {dw_err / scale:.3e} of max |plain| (tol {DW_TOL:g}), "
          f"{'the same bits twice' if dw_same else 'BITS DIFFER'}; in turns from CUDA graphs, "
          f"ms: kernel {' '.join(f'{t:.4f}' for t in k_r)} (median {dw_ms:.4f} = "
          f"{dw_bound['bound_ms'] / dw_ms:.1%} of the {dw_bound['bound_ms']:.4f} ms bound), over "
          f"{LAYER_MEMBERS} members {dwb_ms:.4f}, one fp32 torch.mm "
          f"{' '.join(f'{t:.4f}' for t in l_r)} (median {lib_ms:.4f}); plain {dw_plain:.3f}",
          flush=True)
    if not (dw_err <= DW_TOL * scale and dw_same):
        raise AssertionError(f"{tag} sine_mlp_layer_dw: err {dw_err}, same bits {dw_same}")
    records["sine_mlp_layer_dw"] = (dw_err, dw_ms, dw_plain, lib_ms)
    batched["sine_mlp_layer_dw_batched"] = (dw_err, dwb_ms, LAYER_MEMBERS * dw_plain, lib_ms)
    del ab, gzb, part, part_b, runs, plain_dw

    # one hidden layer of K1 alone (sine_mlp_layer_fwd, kind hidden) on the
    # chain's own a_0 and W_1, zero-padded: z and a_1 against its plain
    # version (LAYER_TOL), twice for bits; in turns with one fp32 torch.mm(a,
    # W) of its product from CUDA graphs (W's planes made once, outside)
    omega = sm._omegas(mcfg, DEPTH)[1]
    w1 = F.pad(params[1]["w"].float(), (0, kw - width, 0, kw - width)).contiguous()
    b1 = F.pad(params[1]["b"].float(), (0, kw - width)).contiguous()
    z_k, a_k = sm.sine_mlp_layer_fwd(a, w1, b1, omega, prec, stash=True)
    again = sm.sine_mlp_layer_fwd(a, w1, b1, omega, prec, stash=True)
    z_p, a_p = sm.layer_fwd_reference(a, w1, b1, omega, prec)
    torch.cuda.synchronize()
    lf_err = max(float((z_k - z_p).abs().max()), float((a_k - a_p).abs().max()))
    lf_same = torch.equal(z_k, again[0]) and torch.equal(a_k, again[1])
    del z_k, a_k, again, z_p, a_p
    planes = sm._layer_planes(w1[None], False, False)[0]
    lf_r, mm_r = _graph_interleaved_ms([lambda: sm.sine_mlp_layer_fwd(a, planes, b1, omega, prec),
                                        lambda: torch.mm(a, w1)], rounds=3, reps=3)
    lf_ms, mm_ms = statistics.median(lf_r), statistics.median(mm_r)
    lf_plain = _time_ms(lambda: sm.layer_fwd_reference(a, w1, b1, omega, prec), 2)
    lf_bound = dw_bound["bound_ms"]  # the same product: 2 n h^2 FLOP, 3 TF32 passes
    print(f"{tag} one hidden sine_mlp_layer_fwd (a_0 W_1, {slices} slices) vs its plain "
          f"version: max abs err {lf_err:.3e} (tol {LAYER_TOL[prec][0]:g}), "
          f"{'the same bits twice' if lf_same else 'BITS DIFFER'}; in turns from CUDA graphs, "
          f"ms: kernel {' '.join(f'{t:.4f}' for t in lf_r)} (median {lf_ms:.4f} = "
          f"{lf_bound / lf_ms:.1%} of the {lf_bound:.4f} ms bound), one fp32 torch.mm(a, W) "
          f"{' '.join(f'{t:.4f}' for t in mm_r)} (median {mm_ms:.4f}); plain {lf_plain:.3f}",
          flush=True)
    if not (lf_err <= LAYER_TOL[prec][0] and lf_same):
        raise AssertionError(f"{tag} one hidden sine_mlp_layer_fwd: err {lf_err}, same bits "
                             f"{lf_same}")
    del planes
    _layer_bwd_alone(params, x, a, gz, g2, w1, b1, mcfg, tag, kw, width, slices,
                     dw_bound["bound_ms"])
    del a, gz, g2, w1, b1
    kind_records = _layer_kinds_alone(members, x, gs, mcfg, tag, width, slices)
    _layer_kinds_other_counts(width)

    # the backward's partial buffer against its plain mirror, and sum_partials'
    # order over it (at the first width: the mirror holds every layer's
    # activations and cotangents, 8 GB at 640)
    if width != LAYER_WIDTHS[0]:
        return _layer_records(records, batched, bounds, padded, dw_bound, layers, kind_records)
    _, part = sm.sine_mlp_layer_partials(params, x, g, mcfg, prec)
    mirror = sm.siren_chain_layer_partials(params, x, g, mcfg, prec, slices)
    # the slices' floats past the gradients (their 16-byte padding) are not written
    used, mirror = part[:, : sum(sizes)], mirror[:, : sum(sizes)]
    p_err = float((used - mirror).abs().max()) / float(mirror.abs().max())
    exact = torch.equal(sm.sum_partials(part), sm.sum_partials_reference(part))
    print(f"{tag} the backward's partials ({slices} x {n_part}) vs their plain mirror: max "
          f"abs err {p_err:.3e} of max |mirror| (tol {BWD_TOL['fp32']:g}); sum_partials over "
          f"them {'bit for bit' if exact else 'NOT'} its mirror's order", flush=True)
    if not (p_err <= BWD_TOL["fp32"] and exact):
        raise AssertionError(f"{tag} partials vs mirror {p_err}, sum_partials exact {exact}")
    del part, mirror, used
    torch.cuda.empty_cache()
    return _layer_records(records, batched, bounds, padded, dw_bound, layers, kind_records)


def _layer_bwd_alone(params, x, a1, g1, g2, w1, b1, mcfg, tag: str, kw: int, width: int,
                     slices: int, bound_ms: float) -> None:
    """One hidden layer of K2's backward alone (sine_mlp_layer_bwd, kind
    hidden) on the chain's own operands, zero-padded to the kernel width kw:
    at l = 2 (G_2 W_2^T over z_1 = A_1 W_1 + b_1) G_1, A_1 and the slices'
    db, and at l = 1 (G_1 W_1^T over z_0, with x: dW_0) the same and dW_0,
    each against its plain version (layer_bwd_reference) within
    LAYER_TOL's fp32 backward limit of its largest value, twice for bits;
    l = 2 timed in turns with one fp32 torch.mm(G, W^T) of its product from
    CUDA graphs (W^T's planes made once, outside; A_1 written over a copy of
    z_1 each launch, as K2 does)."""
    import torch
    import torch.nn.functional as F

    from implicit_image_tpu_torch.ops import sine_mlp as sm

    prec, limit = "fp32", LAYER_TOL["fp32"][1]
    om = sm._omegas(mcfg, DEPTH)
    pad = (0, kw - width, 0, kw - width)
    w0 = F.pad(params[0]["w"].float(), (0, kw - width))
    z0 = (x @ w0 + F.pad(params[0]["b"].float(), (0, kw - width))).contiguous()
    z1 = sm.layer_fwd_reference(a1, w1, b1, om[1], prec)[0]
    w2 = F.pad(params[2]["w"].float(), pad).contiguous()
    errs, same = {}, True
    for l, (gl, wl, zl, xl) in ((2, (g2, w2, z1, None)), (1, (g1, w1, z0, x))):
        got = sm.sine_mlp_layer_bwd(gl, wl, zl, om[l - 1], prec, x=xl)
        again = sm.sine_mlp_layer_bwd(gl, wl, zl, om[l - 1], prec, x=xl)
        ref = sm.layer_bwd_reference(gl, wl, zl, om[l - 1], prec, x=xl)
        torch.cuda.synchronize()
        for what, k, r in zip(("G", "A", "db", "dW_0"), got, ref):
            if r is not None:
                k = k.sum(0) if what in ("db", "dW_0") else k
                errs[f"l{l} {what}"] = float((k - r).abs().max()) / float(r.abs().max())
        same = same and all(u is None or torch.equal(u, v) for u, v in zip(got, again))
        del got, again, ref
    planes = sm._layer_planes(w2.t()[None], False, False)[0]
    zt = z1.clone()
    k_r, mm_r = _graph_interleaved_ms(
        [lambda: sm.sine_mlp_layer_bwd(g2, planes, zt, om[1], prec, inplace=True),
         lambda: torch.mm(g2, w2.t())], rounds=3, reps=3)
    k_ms, mm_ms = statistics.median(k_r), statistics.median(mm_r)
    plain = _time_ms(lambda: sm.layer_bwd_reference(g2, w2, z1, om[1], prec), 2)
    worst = max(errs, key=errs.get)
    print(f"{tag} one hidden sine_mlp_layer_bwd ({slices} slices) vs its plain version: max "
          f"rel err {errs[worst]:.3e} at {worst} (tol {limit:g}; "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + "), "
          f"{'the same bits twice' if same else 'BITS DIFFER'}; G_2 W_2^T in turns from CUDA "
          f"graphs, ms: kernel {' '.join(f'{t:.4f}' for t in k_r)} (median {k_ms:.4f} = "
          f"{bound_ms / k_ms:.1%} of the {bound_ms:.4f} ms bound), one fp32 torch.mm(G, W^T) "
          f"{' '.join(f'{t:.4f}' for t in mm_r)} (median {mm_ms:.4f}); plain {plain:.3f}",
          flush=True)
    if not (errs[worst] <= limit and same):
        raise AssertionError(f"{tag} one hidden sine_mlp_layer_bwd: errs {errs}, same bits {same}")
    del planes, zt, z0, z1, w2
    torch.cuda.empty_cache()


def _layer_k1_split(k1, tag: str, width: int, n: int) -> dict:
    """One layer-wise K1 call under autograd (k1: it fills the z stash)
    under torch.profiler: each kernel's device ms and launches
    (tools/kernel_breakdown.kernel_split: sine_mlp_layer_fwd_kernel by
    kind), beside the first and last layers' bytes bounds (_kind_bounds,
    times the launches: one a band)."""
    from implicit_image_tpu_torch.tools.kernel_breakdown import kernel_split

    split = kernel_split(k1)
    kb = _kind_bounds(n, width, 2, 3, 1)
    parts = []
    for kind, name in (("first", "sine_mlp_layer_fwd first"), ("last", "sine_mlp_layer_fwd last")):
        ms, count = split.get(f"sine_mlp_layer_fwd_kernel {kind}", (float("nan"), 0))
        parts.append(f"its {kind} layers {ms:.3f} ms / {count} = "
                     f"{kb[name]['bound_ms'] / ms:.1%} of their {kb[name]['bound_ms']:.3f} ms bytes "
                     "bound")
    print(f"{tag} fp32 K1's kernels under autograd (one call under torch.profiler, device ms / "
          "launches): " + "; ".join(f"{k} {ms:.3f} / {c}" for k, (ms, c) in split.items())
          + "; " + "; ".join(parts), flush=True)
    return split


def _layer_k2_split(k2, tag: str, width: int, n: int, prepare=None) -> dict:
    """One layer-wise K2 call (k2; with `prepare`, k2(prepare()), prepare
    outside the profile) under torch.profiler: each kernel's device ms and
    launches (tools/kernel_breakdown.kernel_split: sine_mlp_layer_bwd_kernel by
    kind), so that sine_mlp_layer_bwd_kernel has a time of its own beside
    its bound: its hidden launches' gz·Wᵀ products (3 TF32 passes of 2 n h²
    a hidden layer) and its FMA (g·Wᵀ and dW of the last layer, dW_0 and dx:
    2 n h (2 out + 2 in))."""
    from implicit_image_tpu_torch.tools.kernel_breakdown import kernel_split

    split = kernel_split(k2, prepare)
    kb = _kind_bounds(n, width, 2, 3, 1)
    hidden_ops = (DEPTH - 2) * 3 * 2 * n * width * width / TF32_FLOP_PER_S * 1e3
    bwd_ops = hidden_ops + 2 * n * width * (2 * 3 + 2 * 2) / FP32_FLOP_PER_S * 1e3
    bwd_ms = sum(ms for k, (ms, _) in split.items() if k.startswith("sine_mlp_layer_bwd_kernel"))
    hid_ms = split.get("sine_mlp_layer_bwd_kernel hidden", (float("nan"), 0))[0]
    kinds = []
    for kind in ("last", "first"):
        ms = split.get(f"sine_mlp_layer_bwd_kernel {kind}", (float("nan"), 0))[0]
        bound = kb[f"sine_mlp_layer_bwd {kind}"]["bound_ms"]
        kinds.append(f"its {kind} layer {ms:.3f} ms = {bound / ms:.1%} of its {bound:.3f} ms "
                     "bytes bound")
    print(f"{tag} fp32 K2's kernels (one call under torch.profiler, device ms / launches): "
          + "; ".join(f"{k} {ms:.3f} / {c}" for k, (ms, c) in split.items())
          + f"; sine_mlp_layer_bwd_kernel {bwd_ms:.3f} ms, bound {bwd_ops:.3f} ms (operations) "
          f"= {bwd_ops / bwd_ms:.1%}; its hidden launches {hid_ms:.3f} ms, bound "
          f"{hidden_ops:.3f} = {hidden_ops / hid_ms:.1%}; " + "; ".join(kinds), flush=True)
    return split


def _layer_records(records, batched, bounds, padded, dw_bound, layers, kinds) -> dict:
    """phase_layer_kernels' kernels-line records, each with its bound and
    padded bound: K1's and K2's those of the work they do under autograd
    (K1 writing the z stash, K2 reading it in place of the recompute), dW's
    one layer's share of the hidden layers' dW (times the members); then
    the first and last layers' kinds alone (`kinds`, with their own)."""
    def bound_of(name):
        base = {"sine_mlp_layer_fwd": "sine_mlp_fwd_stash",
                "sine_mlp_layer_bwd": "sine_mlp_bwd_stashed",
                "sine_mlp_layer_fwd_batched": "sine_mlp_fwd_stash_batched",
                "sine_mlp_layer_bwd_batched": "sine_mlp_bwd_stashed_batched"}.get(name)
        if base is None:  # dW of one layer (over the members)
            m = LAYER_MEMBERS if name.endswith("_batched") else 1
            return (dict(dw_bound, bound_ms=m * dw_bound["bound_ms"]),
                    m * padded["hidden_dw"]["bound_ms"] / layers)
        return bounds[base], padded[base]["bound_ms"]

    return {"single": {**{k: (*v, *bound_of(k)) for k, v in records.items()}, **kinds},
            "batched": {k: (*v, *bound_of(k)) for k, v in batched.items()}}


def _kind_bounds(n: int, hidden: int, in_size: int, out_size: int, slices: int) -> dict:
    """The first and last layers' kinds alone (the kernels line's rows
    "sine_mlp_layer_fwd first" ...): FLOPs (their FMAs: 2 per multiply-add),
    bytes (each input read once, each output written once) and the least
    time, the larger of bytes / HBM_BYTES_PER_S and FLOPs / FP32_FLOP_PER_S.
    The forward's first layer writes z_0 too (the stash, as under autograd);
    the backward's last reads g and z_L, writes G_L and its slices' sums."""
    kinds = {
        "sine_mlp_layer_fwd first": (2 * n * hidden * in_size,
                                     4 * (n * in_size + in_size * hidden + hidden
                                          + 2 * n * hidden)),
        "sine_mlp_layer_fwd last": (2 * n * hidden * out_size,
                                    4 * (n * hidden + hidden * out_size + out_size
                                         + n * out_size)),
        "sine_mlp_layer_bwd last": (2 * n * hidden * 2 * out_size,
                                    4 * (n * out_size + hidden * out_size + 2 * n * hidden
                                         + slices * (hidden + hidden * out_size + out_size))),
        "sine_mlp_layer_bwd first": (2 * n * hidden * in_size,
                                     4 * (n * hidden + in_size * hidden + n * in_size)),
    }
    out = {}
    for name, (flop, nbytes) in kinds.items():
        mem_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flop / FP32_FLOP_PER_S * 1e3
        out[name] = {"flop": flop, "bytes": nbytes, "bound_ms": max(mem_ms, ops_ms),
                     "bound_by": "operations" if ops_ms >= mem_ms else "bytes"}
    return out


def _layer_kinds_alone(members, x, gs, mcfg, tag: str, width: int, slices: int,
                       depth: int = DEPTH, timed: bool = True) -> dict:
    """The first and last layers' launches alone (the streaming passes:
    sine_mlp_layer_fwd first, with the stash, and last; sine_mlp_layer_bwd
    last and first) on the first member's own chain operands (x, g, z_L,
    a_L, G_0 of the plain chain in each mode; the kernel width is `width`)
    in every mode: each against its plain version (layer_*_reference)
    within LAYER_TOL (its forward limit, absolute, for out; its backward
    limit of the largest value for z_0, a_0, G_L, dx and the slices' db_L,
    dW_{D-1}, db_{D-1} added up), twice for bits; over LAYER_MEMBERS members
    (the members' weights, cotangents gs and the same activations) each
    member the bits of its single launch. At depth 2 the backward's last
    layer also sums dW_0 (x given). With `timed`, the fp32 launches timed
    from CUDA graphs in turns with one fp32 PyTorch call where one computes
    the same function (torch.addmm for out, torch.mm for dx), beside their
    bytes bound (_kind_bounds). Returns the kernels line's records."""
    import torch

    from implicit_image_tpu_torch.ops import sine_mlp as sm

    n, in_size = x.shape
    om = sm._omegas(mcfg, depth)
    bounds = _kind_bounds(n, width, in_size, gs.shape[-1], slices)
    xl = x if depth == 2 else None
    records = {}
    for prec in LAYER_TOL:
        bf16, mixed = sm.precision_modes(prec)
        fwd_tol, bwd_tol = LAYER_TOL[prec]
        ws = [sm._rnd_params(p, mixed) for p in members]
        params = ws[0]
        out_p, zs = sm._chain_forward(members[0], x, mcfg, prec, keep=True)
        z_l = zs[-1]
        a_l = sm._rnd(sm.fast_sin(om[-2] * z_l), bf16 or mixed)
        hooked = {}
        sm._chain_backward(params, x, gs[0], mcfg, prec,
                           lambda i, a_prev, gzb, gz: hooked.__setitem__(i, gzb) if i == 0 else None,
                           zs)
        g0 = hooked[0]
        del zs, hooked
        w = lambda l, k: torch.stack([p[l][k] for p in ws])  # noqa: E731
        m = len(members)
        calls = {  # name: (launch, plain, over the members, member i alone)
            "sine_mlp_layer_fwd first": (
                lambda: sm.sine_mlp_layer_fwd_first(x, params[0]["w"], params[0]["b"], om[0],
                                                    prec, stash=True),
                lambda: sm.layer_fwd_first_reference(x, params[0]["w"], params[0]["b"], om[0],
                                                     prec),
                lambda: sm.sine_mlp_layer_fwd_first(x, w(0, "w"), w(0, "b"), om[0], prec,
                                                    stash=True),
                lambda i: sm.sine_mlp_layer_fwd_first(x, ws[i][0]["w"], ws[i][0]["b"], om[0],
                                                      prec, stash=True)),
            "sine_mlp_layer_fwd last": (
                lambda: (sm.sine_mlp_layer_fwd_last(a_l, params[-1]["w"], params[-1]["b"],
                                                    prec),),
                lambda: (sm.layer_fwd_last_reference(a_l, params[-1]["w"], params[-1]["b"],
                                                     prec),),
                lambda: (sm.sine_mlp_layer_fwd_last(a_l.expand(m, -1, -1).contiguous(),
                                                    w(-1, "w"), w(-1, "b"), prec),),
                lambda i: (sm.sine_mlp_layer_fwd_last(a_l, ws[i][-1]["w"], ws[i][-1]["b"],
                                                      prec),)),
            "sine_mlp_layer_bwd last": (
                lambda: sm.sine_mlp_layer_bwd_last(gs[0], params[-1]["w"], z_l, om[-2], prec,
                                                   x=xl),
                lambda: sm.layer_bwd_last_reference(gs[0], params[-1]["w"], z_l, om[-2], prec,
                                                    x=xl),
                lambda: sm.sine_mlp_layer_bwd_last(
                    gs, w(-1, "w"), z_l.expand(m, -1, -1).contiguous(), om[-2], prec,
                    x=None if xl is None else xl.expand(m, -1, -1).contiguous()),
                lambda i: sm.sine_mlp_layer_bwd_last(gs[i], ws[i][-1]["w"], z_l, om[-2], prec,
                                                     x=xl)),
            "sine_mlp_layer_bwd first": (
                lambda: (sm.sine_mlp_layer_bwd_first(g0, params[0]["w"], prec),),
                lambda: (sm.layer_bwd_first_reference(g0, params[0]["w"], prec),),
                lambda: (sm.sine_mlp_layer_bwd_first(g0.expand(m, -1, -1).contiguous(),
                                                     w(0, "w"), prec),),
                lambda i: (sm.sine_mlp_layer_bwd_first(g0, ws[i][0]["w"], prec),)),
        }
        for name, (call, plain, over, alone) in calls.items():
            got, again, ref = call(), call(), plain()
            torch.cuda.synchronize()
            same = all(u is None or torch.equal(u, v) for u, v in zip(got, again))
            errs, abs_err = [], 0.0
            for i, (k, r) in enumerate(zip(got, ref)):
                if r is None:
                    continue
                k = k.sum(0) if name == "sine_mlp_layer_bwd last" and i > 0 else k
                err = float((k - r).abs().max())
                abs_err = max(abs_err, err)
                errs.append(err if name == "sine_mlp_layer_fwd last"
                            else err / float(r.abs().max()))
            tol = fwd_tol if name == "sine_mlp_layer_fwd last" else bwd_tol
            batched = over()
            torch.cuda.synchronize()
            members_same = all(
                all(u is None or torch.equal(u[i], v) for u, v in zip(batched, alone(i)))
                for i in range(m))
            del got, again, ref, batched
            print(f"{tag} {name} alone {prec} vs its plain version: errors "
                  f"{' '.join(f'{e:.3e}' for e in errs)} (tol {tol:g}, "
                  f"{'absolute' if name == 'sine_mlp_layer_fwd last' else 'of the largest value'}), "
                  f"{'the same bits twice' if same else 'BITS DIFFER'}; over {m} members "
                  f"{'each the bits of its single launch' if members_same else 'BITS DIFFER'}",
                  flush=True)
            if not (max(errs) <= tol and same and members_same):
                raise AssertionError(f"{tag} {name} {prec}: errors {errs}, same bits {same}, "
                                     f"members {members_same}")
            if prec == "fp32":
                records[name] = abs_err
        if prec == "fp32" and timed:
            wl, bl, w0 = params[-1]["w"], params[-1]["b"], params[0]["w"]
            fns = [calls[name][0] for name in calls] + [
                lambda: torch.addmm(bl, a_l, wl), lambda: torch.mm(g0, w0.t())]
            rounds = _graph_interleaved_ms(fns, rounds=3, reps=3)
            ms = [statistics.median(r) for r in rounds]
            libs = {"sine_mlp_layer_fwd last": ms[4], "sine_mlp_layer_bwd first": ms[5]}
            for i, name in enumerate(calls):
                plain_ms = _time_ms(calls[name][1], 2)
                b = bounds[name]
                print(f"{tag} {name} alone, fp32, in turns from CUDA graphs, ms: "
                      f"{' '.join(f'{t:.4f}' for t in rounds[i])} (median {ms[i]:.4f} = "
                      f"{b['bound_ms'] / ms[i]:.1%} of its {b['bound_ms']:.4f} ms bound, "
                      f"{b['bytes'] / 1e9:.3f} GB, by {b['bound_by']}); "
                      + (f"one fp32 PyTorch call {libs[name]:.4f}; " if name in libs else "")
                      + f"plain {plain_ms:.3f}", flush=True)
                records[name] = (records[name], ms[i], plain_ms, libs.get(name), b,
                                 b["bound_ms"])
        del out_p, z_l, a_l, g0, ws, params
        torch.cuda.empty_cache()
    return records


def _layer_kinds_other_counts(width: int) -> None:
    """The first and last layers' kinds alone, held as _layer_kinds_alone
    holds them (every mode, bits twice, the member axis), at input and
    output counts other than an image's 2 and 3: the passes' bodies that
    run their loops to MAX_IO under a guard. 3 in and 6 out at depth 4, 3 in
    and 4 out at depth 2 (the backward's last layer summing dW_0), on 4,096
    rows."""
    import torch

    from implicit_image_tpu_torch.models import build_model
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    dev = torch.device("cuda")
    n = 4096
    for depth, in_size, out_size in ((4, 3, 6), (2, 3, 4)):
        mdef, mcfg = build_model("siren", depth=depth, hidden_size=width, input_size=in_size,
                                 output_size=out_size)
        gen = torch.Generator().manual_seed(depth)
        members = [mdef.init(gen, mcfg, dev) for _ in range(LAYER_MEMBERS)]
        x = (torch.rand((n, in_size), generator=gen) * 2 - 1).to(dev)
        gs = (torch.randn((LAYER_MEMBERS, n, out_size), generator=gen) / n).to(dev)
        slices = sm.partial_layout(n, depth, in_size, width, out_size, dev)[0]
        tag = f"[3 layer kernels w{width} d{depth}, {in_size} in, {out_size} out]"
        _layer_kinds_alone(members, x, gs, mcfg, tag, width, slices, depth=depth, timed=False)


def phase_layer_wide() -> None:
    """Phase 3 at each (width, side) of LAYER_WIDE (d8, fp32): one K1/K2
    pair against the plain chain. At w2048 the z stash holds (D-1) x
    262,144 x 2,048 = 3.76e9 floats, past 2^31: the kernels' 64-bit
    offsets; w4096 holds the fp32 limits at K = 4,096."""
    import torch

    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    dev = torch.device("cuda")
    for width, side in LAYER_WIDE:
        mdef, mcfg = build_model("siren", depth=DEPTH, hidden_size=width)
        gen = torch.Generator().manual_seed(0)
        params = mdef.init(gen, mcfg, dev)
        x = (get_grid(side, side, dev).reshape(-1, 2) - 0.5) * 2.0
        n = x.shape[0]
        g = (torch.randn((n, 3), generator=gen) / n).to(dev)
        prec = "fp32"
        slices, n_part, _ = sm.partial_layout(n, DEPTH, 2, width, 3, dev)
        bounds = _bounds(n, 2, 3, DEPTH, width, slices, _grad_floats(2, width, 3, DEPTH))
        torch.cuda.reset_peak_memory_stats(dev)
        first = _layer_pair(params, x, g, mcfg, prec)
        peak = torch.cuda.max_memory_allocated(dev)
        fwd_ms = _time_ms(lambda: sm.sine_mlp_fwd(params, x, mcfg, prec), 2)
        bwd_ms = _time_ms(lambda: sm.sine_mlp_bwd(params, x, g, mcfg, prec), 1)
        torch.cuda.empty_cache()
        out_p = sm.siren_chain_reference(params, x, mcfg, prec)
        fwd_plain = _time_ms(lambda: sm.siren_chain_reference(params, x, mcfg, prec), 1)
        plain = (out_p, *sm.siren_chain_backward_reference(params, x, g, mcfg, prec))
        torch.cuda.synchronize()
        fwd_err, rel, _ = _errors(first, plain)
        worst = max(rel, key=rel.get)
        del plain, first
        torch.cuda.empty_cache()
        bwd_plain = _time_ms(lambda: sm.siren_chain_backward_reference(params, x, g, mcfg, prec),
                             1)
        f_b, b_b = bounds["sine_mlp_fwd"], bounds["sine_mlp_bwd"]
        print(f"[3 layer kernels w{width} {side}² fp32] z stash {(DEPTH - 1) * n * width:.3e} "
              f"floats, peak {peak / 2**30:.2f} GiB; fwd max_abs_err {fwd_err:.3e} (tol "
              f"{FWD_TOL['fp32']:g}); bwd max rel err {rel[worst]:.3e} at {worst} (tol "
              f"{BWD_TOL['fp32']:g}); K1 {f_b['flop'] / 1e12:.3f} TFLOP {fwd_ms:.3f} ms = "
              f"{f_b['bound_ms'] / fwd_ms:.1%} of its {f_b['bound_ms']:.3f} ms bound; K2 "
              f"{b_b['flop'] / 1e12:.3f} TFLOP {bwd_ms:.3f} ms = {b_b['bound_ms'] / bwd_ms:.1%} "
              f"of {b_b['bound_ms']:.3f}; plain chain {fwd_plain:.3f} / {bwd_plain:.3f} ms",
              flush=True)
        if not (fwd_err <= FWD_TOL["fp32"] and rel[worst] <= BWD_TOL["fp32"]):
            raise AssertionError(f"w{width}: fwd {fwd_err}, bwd {rel}")
        del params, x, g, out_p
        torch.cuda.empty_cache()


def _expected_container_bytes(cfg) -> int:
    """Plain container size from the shapes (half=auto): unquantized
    weights and all biases fp32, quantized layers uint8 labels + fp16
    centroids."""
    import numpy as np

    from implicit_image_tpu_torch.models import build_model_from_config

    _, mcfg = build_model_from_config(cfg)
    dims = mcfg.layer_dims
    bits = int(cfg.quant.bits)
    total = 0
    for i, (fan_in, fan_out) in enumerate(dims):
        quantized = 0 < i < len(dims) - 1 and fan_in * fan_out >= 2**bits
        if quantized:
            label_bytes = 1 if 2**bits <= 256 else 2
            total += fan_in * fan_out * label_bytes + 2**bits * np.dtype(np.float16).itemsize
        else:
            total += fan_in * fan_out * 4
        total += fan_out * 4
    return total


LAYER_KERNELS = ("sine_mlp_layer_fwd", "sine_mlp_layer_bwd", "sine_mlp_layer_dw")


@contextlib.contextmanager
def _layer_forwards():
    """While open, counts K1's calls above 192 (the layer-wise forward,
    sm._layer_fwd, wrapped): {"stash": calls that filled the z stash,
    "plain": calls that did not, "launches": {kernel: the launches of
    sine_mlp_layer_fwd(_batched) those calls make, depth a band}}. K2
    takes K1's stash on these paths, so nothing else launches
    sine_mlp_layer_fwd there: the path's counts must equal these."""
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    calls = {"stash": 0, "plain": 0, "launches": {}}
    inner = sm._layer_fwd

    def counted(members, x, cfg, bf16, mixed, name, stash=False):
        first = sm._first_member(members)
        bands = -(-x.shape[-2] // sm.layer_band_rows(sm.kernel_width(first[0]["w"].shape[-1]),
                                                     sm._member_count(members)))
        calls["stash" if stash else "plain"] += 1
        calls["launches"][name] = calls["launches"].get(name, 0) + len(first) * bands
        return inner(members, x, cfg, bf16, mixed, name, stash=stash)

    sm._layer_fwd = counted
    try:
        yield calls
    finally:
        sm._layer_fwd = inner


def _check_launches(launches: dict, what: str, batched: bool = False,
                    layer: bool = False) -> None:
    """Every kernel launched on the path; sine_mlp_fwd_batched (K1 over a
    member axis) exactly when it decodes runs together (`batched`), and
    never K2 over a member axis (the fits of phases 14 and 16 only;
    _check_ladder_launches). A path above width 192 (`layer`) runs the
    layer-wise kernels and sum_partials instead of the fused K1 and K2; no
    other path runs them."""
    fused = ("sine_mlp_fwd", "sine_mlp_bwd")
    for name, count in launches.items():
        if ((name == "sine_mlp_fwd_batched" and not batched)
                or name in ("sine_mlp_bwd_batched", "sum_partials_batched")
                or (name.startswith("sine_mlp_layer") and (not layer or name.endswith("_batched")))
                or (layer and name in fused)):
            if count != 0:
                raise AssertionError(f"{name} launched {count} times on the {what}, which "
                                     "does not run it")
        elif count <= 0:
            raise AssertionError(f"kernel {name} did not launch on the {what}")


def phase_main_path() -> dict:
    import numpy as np
    import torch

    from implicit_image_tpu_torch import compress, decompress
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    cfg = compress.compose(SMOKE_OVERRIDES)
    if int(cfg.mlp.depth) != DEPTH or int(cfg.mlp.hidden_size) != WIDTH:
        raise AssertionError("the smoke run must use the full-width SIREN")
    run_dir = cfg.output_dir
    shutil.rmtree(run_dir, ignore_errors=True)  # metrics.jsonl appends
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    psnr, nbytes = compress.main(cfg, run_dir=run_dir)
    t1 = time.perf_counter()
    img, stats = decompress.decode_run(run_dir, device="cuda")
    t2 = time.perf_counter()
    launches = dict(sm.LAUNCHES)

    summary = json.loads(open(f"{run_dir}/summary.json").read())
    expected = _expected_container_bytes(cfg)
    print(
        f"[4 main path] compress.main {t1 - t0:.2f} s (fit {summary['fit_wall_s']:.3f} s, "
        f"quant {summary['quant_wall_s']:.3f} s, encode {summary['encode_wall_s']:.3f} s, "
        f"decode+render {summary['decode_wall_s']:.3f} s); decode_run {t2 - t1:.3f} s "
        f"(render {stats['render_s'] * 1e3:.2f} ms)",
        flush=True,
    )
    print(
        f"[4 main path] fit PSNR {summary['PSNR']:.3f} dB, quant PSNR "
        f"{summary['Quant PSNR']:.3f} dB, decoded PSNR {psnr:.3f} dB, "
        f"bytes {nbytes} (expected {expected}); launches {launches}",
        flush=True,
    )
    _check_launches(launches, "main path")
    if not (math.isfinite(psnr) and psnr >= 20.0):
        raise AssertionError(f"decoded PSNR {psnr} is not finite or below 20 dB")
    if nbytes != expected:
        raise AssertionError(f"container is {nbytes} B, shapes imply {expected} B")
    img = np.asarray(img)
    if img.shape != (N_SIDE, N_SIDE, 3) or not np.isfinite(img).all():
        raise AssertionError(f"decoded image has shape {img.shape} or non-finite values")
    target = compress._load_image(cfg.img)
    redecoded = 10.0 * np.log10(1.0 / np.mean((img.astype(np.float64) - target) ** 2))
    if abs(redecoded - psnr) > 1e-3:
        raise AssertionError(f"decode_run gives {redecoded} dB, compress reported {psnr}")
    return launches, summary


def phase_default_path(dense_summary: dict) -> str:
    """Phase 5; returns its run dir."""
    import numpy as np
    import torch

    from implicit_image_tpu_torch import compress, decompress
    from implicit_image_tpu_torch.coding import decompress_state_dict
    from implicit_image_tpu_torch.models import build_model_from_config
    from implicit_image_tpu_torch.ops import sine_mlp as sm
    from implicit_image_tpu_torch.sparsity import create_mask_state

    cfg = compress.compose(DEFAULT_OVERRIDES)
    masking = compress.masking_config(cfg)
    if masking is None or masking.name != "RigL":
        raise AssertionError(f"the composed default masking is {masking}, not RigL")
    if int(cfg.mlp.depth) != DEPTH or int(cfg.mlp.hidden_size) != WIDTH:
        raise AssertionError("the smoke run must use the full-width SIREN")
    num_steps = int(cfg.train.num_steps)
    updates = sum(1 for s in range(num_steps)
                  if (s + 1) % masking.interval == 0 and s <= masking.end_when)
    # the initial masks as the fit draws them: init weights, then masks, from
    # one CPU generator seeded with cfg.seed
    gen = torch.Generator().manual_seed(int(cfg.seed))
    mdef, mcfg = build_model_from_config(cfg)
    init = create_mask_state(gen, mdef.init(gen, mcfg, "cpu"), masking)
    init_counts = {i: int(m.sum()) for i, m in enumerate(init.masks) if m is not None}
    init_density = float(init.baseline_nonzero / init.total_params)

    run_dir = cfg.output_dir
    shutil.rmtree(run_dir, ignore_errors=True)
    sm.reset_launch_counts()
    psnr, nbytes = compress.main(cfg, run_dir=run_dir)
    img, stats = decompress.decode_run(run_dir, device=cfg.get("device", "cuda"))
    launches = dict(sm.LAUNCHES)

    summary = json.loads(open(f"{run_dir}/summary.json").read())
    train = [x for x in map(json.loads, open(f"{run_dir}/metrics.jsonl")) if x["prefix"] == "Train"]
    masks = np.load(f"{run_dir}/mask.npz")
    model = np.load(f"{run_dir}/model.npz")
    decoded = decompress_state_dict(f"{run_dir}/model_quantized", "plain")
    final_counts = {int(k.split(".")[1]): int(masks[k].sum()) for k in masks.files}
    moved = sum(int((masks[f"layers.{i}.mask"] != init.masks[i].numpy()).sum())
                for i in init_counts)
    expected = _expected_container_bytes(cfg)
    ms_step = summary["fit_wall_s"] / num_steps * 1e3
    dense_ms_step = dense_summary["fit_wall_s"] / int(
        compress.compose(SMOKE_OVERRIDES).train.num_steps) * 1e3
    print(
        f"[5 default path] RigL, {updates} mask updates; fit {summary['fit_wall_s']:.3f} s = "
        f"{ms_step:.3f} ms/step (phase 4, masking=none: {dense_ms_step:.3f} ms/step), quant "
        f"{summary['quant_wall_s']:.3f} s; decode_run render {stats['render_s'] * 1e3:.2f} ms",
        flush=True,
    )
    print(
        f"[5 default path] density at init {init_density:.6f}, "
        f"logged {[x['Density'] for x in train]}; layer counts init {init_counts}, final "
        f"{final_counts}; {moved} mask entries moved; fit PSNR {summary['PSNR']:.3f} dB, "
        f"quant PSNR {summary['Quant PSNR']:.3f} dB, decoded PSNR {psnr:.3f} dB, "
        f"MS-SSIM {summary['Decoded MS-SSIM']:.6f}, bytes {nbytes} (expected {expected}); "
        f"launches {launches}",
        flush=True,
    )
    _check_launches(launches, "default path")
    if updates != 10:
        raise AssertionError(f"{updates} mask updates, expected 10")
    if any(abs(x["Density"] - init_density) > 1e-6 for x in train):
        raise AssertionError("the logged density is not the initial masks' density")
    if final_counts != init_counts:
        raise AssertionError(f"RigL changed a layer's weight count: {init_counts} -> "
                             f"{final_counts}")
    if moved == 0:
        raise AssertionError("no mask entry changed over the updates")
    for i in init_counts:
        pruned = masks[f"layers.{i}.mask"] == 0
        if np.any(model[f"layers.{i}.w"][pruned] != 0.0):
            raise AssertionError(f"layer {i}: a pruned weight is not 0 in model.npz")
        if np.any(decoded[f"layers.{i}.weight"][pruned] != 0.0):
            raise AssertionError(f"layer {i}: a pruned weight decodes to nonzero")
    if not (math.isfinite(psnr) and psnr >= 20.0):
        raise AssertionError(f"decoded PSNR {psnr} is not finite or below 20 dB")
    if nbytes != expected:
        raise AssertionError(f"container is {nbytes} B, shapes imply {expected} B")
    if not 0.0 < summary["Decoded MS-SSIM"] <= 1.0:
        raise AssertionError(f"decoded MS-SSIM {summary['Decoded MS-SSIM']} outside (0, 1]")
    img = np.asarray(img)
    target = compress._load_image(cfg.img)
    redecoded = 10.0 * np.log10(1.0 / np.mean((img.astype(np.float64) - target) ** 2))
    if abs(redecoded - psnr) > 1e-3:
        raise AssertionError(f"decode_run gives {redecoded} dB, compress reported {psnr}")
    return run_dir


def phase_presets() -> None:
    """Phase 6: SNFS, Pruning (GMP) and Small_Dense, 60 fit + 10 quant steps."""
    from implicit_image_tpu_torch import compress
    from implicit_image_tpu_torch.models import build_model_from_config
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    for preset in PRESETS:
        cfg = compress.compose(PRESET_OVERRIDES + [
            f"masking={preset}", f"output_dir=outputs/chip_smoke_{preset.lower()}"])
        _, mcfg = build_model_from_config(cfg)
        shutil.rmtree(cfg.output_dir, ignore_errors=True)
        sm.reset_launch_counts()
        psnr, nbytes = compress.main(cfg, run_dir=cfg.output_dir)
        launches = dict(sm.LAUNCHES)
        summary = json.loads(open(f"{cfg.output_dir}/summary.json").read())
        train = [x for x in map(json.loads, open(f"{cfg.output_dir}/metrics.jsonl"))
                 if x["prefix"] == "Train"]
        density = [round(x["Density"], 6) for x in train if "Density" in x]
        expected = _expected_container_bytes(cfg)
        print(
            f"[6 {preset}] width {mcfg.layer_dims[1][1]}; fit {summary['fit_wall_s']:.3f} s "
            f"({summary['fit_wall_s'] / int(cfg.train.num_steps) * 1e3:.3f} ms/step); "
            f"density at the log steps "
            f"{density}; decoded PSNR {psnr:.3f} dB, MS-SSIM "
            f"{summary['Decoded MS-SSIM']:.6f}, bytes {nbytes} (expected {expected}); "
            f"launches {launches}",
            flush=True,
        )
        _check_launches(launches, f"masking={preset} path")
        if not math.isfinite(psnr):
            raise AssertionError(f"masking={preset}: decoded PSNR {psnr} is not finite")
        if nbytes != expected:
            raise AssertionError(f"masking={preset}: container {nbytes} B, expected {expected}")
        if preset == "Small_Dense" and mcfg.layer_dims[1][1] != SMALL_DENSE_WIDTH:
            raise AssertionError(f"Small_Dense built width {mcfg.layer_dims[1][1]}, "
                                 f"expected {SMALL_DENSE_WIDTH}")
        if preset == "Pruning" and not density[0] < 1.0:
            raise AssertionError(f"GMP density after its first update is {density[0]}")


def phase_repeat(run_dir: str) -> None:
    """Phase 7: two codebook finetunes from phase 5's fit params and masks."""
    import numpy as np
    import torch

    from implicit_image_tpu_torch import compress
    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model_from_config
    from implicit_image_tpu_torch.ops import sine_mlp as sm
    from implicit_image_tpu_torch.training.quant_phase import quant_finetune

    cfg = compress.compose(DEFAULT_OVERRIDES)
    mdef, mcfg = build_model_from_config(cfg)
    model, mask = np.load(f"{run_dir}/model.npz"), np.load(f"{run_dir}/mask.npz")
    dev = torch.device(cfg.get("device", "cuda"))
    params = tuple({k: torch.from_numpy(model[f"layers.{i}.{k}"]).to(dev) for k in ("w", "b")}
                   for i in range(len(mcfg.layer_dims)))
    masks = tuple(torch.from_numpy(mask[f"layers.{i}.mask"]).to(dev)
                  if f"layers.{i}.mask" in mask.files else None
                  for i in range(len(mcfg.layer_dims)))
    img = compress._load_image(cfg.img)
    grid = get_grid(*img.shape[:2], dev)
    sm.reset_launch_counts()
    runs = [quant_finetune(params, img, mdef, mcfg, grid, compress._quant_config(cfg.quant),
                           compress._optim_config(cfg), precision="fp32", masks=masks)
            for _ in range(2)]
    launches = dict(sm.LAUNCHES)
    psnrs = [r.metrics["quant_psnr"] for r in runs]
    same = all(
        a is None and b is None
        or torch.equal(a.centroids, b.centroids) and torch.equal(a.labels, b.labels)
        for a, b in zip(runs[0].codebooks, runs[1].codebooks))
    print(f"[7 repeat] quant PSNR {psnrs[0]!r} / {psnrs[1]!r} dB; codebooks and labels "
          f"{'identical' if same else 'DIFFER'}; launches {launches}", flush=True)
    _check_launches(launches, "codebook finetune")
    if not same or psnrs[0] != psnrs[1]:
        raise AssertionError("the codebook finetune does not repeat bit for bit")


def phase_flagship() -> float:
    """Phase 8: the flagship recipe through compress.main and decode_run.
    Returns its fit's ms per step."""
    import hashlib

    import numpy as np

    from implicit_image_tpu_torch import compress, decompress
    from implicit_image_tpu_torch.coding import huffman, parsers, range_coder, rans
    from implicit_image_tpu_torch.ops import sine_mlp as sm
    from implicit_image_tpu_torch.training.metainit import default_meta_dir

    cfg = compress.compose(FLAGSHIP_OVERRIDES)
    if (cfg.mlp.name, int(cfg.mlp.hidden_size), int(cfg.mlp.split_depth)) != ("coordx", 96, 5):
        raise AssertionError("the flagship run must use CoordX s5/w96")
    run_dir = cfg.output_dir
    shutil.rmtree(run_dir, ignore_errors=True)
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    psnr, nbytes = compress.main(cfg, run_dir=run_dir)
    t1 = time.perf_counter()
    img, stats = decompress.decode_run(run_dir, device="cuda")
    t2 = time.perf_counter()
    launches = dict(sm.LAUNCHES)

    summary = json.loads(open(f"{run_dir}/summary.json").read())
    container = f"{run_dir}/model_quantized"
    manifest = json.loads(open(f"{container}/meta_data.json").read())
    delta = manifest["__meta__"].get("delta", {})
    artifact = default_meta_dir() / FLAGSHIP_ARTIFACT
    blob = open(f"{container}/compressed_weights.data", "rb").read()
    expected_raw = sum(int(np.prod(v["shape"], dtype=np.int64)) * np.dtype(v["dtype"]).itemsize
                       for k, v in manifest.items() if k != "__meta__")
    raw = parsers.decode_stream("auto", blob, expected_size=expected_raw)
    libs = [m.load_native() for m in (huffman, range_coder, rans)]  # raises if not built
    sizes, round_trip = {}, {}
    for name in parsers.backend_names:
        enc = parsers.encode_stream(name, raw)
        sizes[name] = len(enc)
        round_trip[name] = parsers.decode_stream(name, enc, expected_size=len(raw)) == raw
    chosen = parsers._AUTO_ORDER[blob[0]]
    print(
        f"[8 flagship] compress.main {t1 - t0:.2f} s (fit {summary['fit_wall_s']:.3f} s = "
        f"{summary['fit_wall_s'] / int(cfg.train.num_steps) * 1e3:.3f} ms/step, quant "
        f"{summary['quant_wall_s']:.3f} s, encode {summary['encode_wall_s']:.3f} s, "
        f"decode+render {summary['decode_wall_s']:.3f} s; codec build "
        f"{summary['codec_build_s']:.3f} s apart); decode_run {t2 - t1:.3f} s "
        f"(render {stats['render_s'] * 1e3:.2f} ms); launches {launches}",
        flush=True,
    )
    print(
        f"[8 flagship] init {Path(delta.get('artifact', '?')).name}, sha256 "
        f"{delta.get('sha256', '?')[:12]}, {len(delta.get('layers', []))} delta layers, "
        f"{len(delta.get('xor', []))} XOR tensors; raw payload {len(raw)} B; auto chose "
        f"{chosen}; backend sizes {sizes}; round trips {round_trip}; native libraries "
        f"{[Path(lib._name).name for lib in libs]}",
        flush=True,
    )
    print(
        f"[8 flagship] fit PSNR {summary['PSNR']:.3f} dB, quant PSNR "
        f"{summary['Quant PSNR']:.3f} dB (rows 0, 4, 8, ...), decoded PSNR {psnr:.3f} dB, "
        f"MS-SSIM {summary['Decoded MS-SSIM']:.6f}, bytes {nbytes}",
        flush=True,
    )
    if Path(delta.get("artifact", "")).name != FLAGSHIP_ARTIFACT:
        raise AssertionError(f"init_path=auto picked {delta.get('artifact')}, not "
                             f"{FLAGSHIP_ARTIFACT}")
    if delta.get("sha256") != hashlib.sha256(artifact.read_bytes()).hexdigest():
        raise AssertionError("the manifest's delta sha256 is not the artifact's")
    if not all(round_trip.values()):
        raise AssertionError(f"a stream backend does not round-trip: {round_trip}")
    if sizes["auto"] != nbytes or len(blob) != nbytes or summary["Compressed Bytes"] != nbytes:
        raise AssertionError(f"container {len(blob)} B, auto {sizes['auto']} B, "
                             f"compress.main returned {nbytes} B")
    if any(launches.values()):
        raise AssertionError(f"a SIREN kernel launched on the CoordX path: {launches}")
    if not (math.isfinite(psnr) and psnr >= 20.0):
        raise AssertionError(f"decoded PSNR {psnr} is not finite or below 20 dB")
    img = np.asarray(img)
    if img.shape != (N_SIDE, N_SIDE, 3) or not np.isfinite(img).all():
        raise AssertionError(f"decoded image has shape {img.shape} or non-finite values")
    target = compress._load_image(cfg.img)
    redecoded = 10.0 * np.log10(1.0 / np.mean((img.astype(np.float64) - target) ** 2))
    if abs(redecoded - psnr) > 1e-3:
        raise AssertionError(f"decode_run gives {redecoded} dB, compress reported {psnr}")
    return summary["fit_wall_s"] / int(cfg.train.num_steps) * 1e3


def _initial_counts(cfg, masking) -> dict:
    """Each masked layer's weight count at init, the masks drawn as the fit
    draws them: init weights, then masks, from one CPU generator seeded with
    cfg.seed."""
    import torch

    from implicit_image_tpu_torch.models import build_model_from_config
    from implicit_image_tpu_torch.sparsity import create_mask_state

    gen = torch.Generator().manual_seed(int(cfg.seed))
    mdef, mcfg = build_model_from_config(cfg)
    init = create_mask_state(gen, mdef.init(gen, mcfg, "cpu"), masking)
    return {i: int(m.sum()) for i, m in enumerate(init.masks) if m is not None}


def phase_finals() -> dict:
    """Phase 9: the finals operating point through compress.main and
    decode_run; returns its launch counts."""
    import tempfile

    import numpy as np

    from implicit_image_tpu_torch import compress, decompress
    from implicit_image_tpu_torch.coding import (compress_state_dict, decompress_state_dict,
                                                 read_raw_container)
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    cfg = compress.compose(FINALS_OVERRIDES)
    masking = compress.masking_config(cfg)
    if (int(cfg.mlp.depth), int(cfg.mlp.hidden_size), int(cfg.quant.bits),
            cfg.entropy_coding.stream_name, int(cfg.train.multiplier)) != (
                DEPTH, FINALS_WIDTH, FINALS_BITS, "zstd", 5):
        raise AssertionError("the finals run must be SIREN d8/w182, 9-bit, zstd, 5x steps")
    if masking is None or masking.name != "RigL" or masking.interval != 5 * 20:
        raise AssertionError(f"the finals masking is {masking}, not RigL at 5x its interval")
    init_counts = _initial_counts(cfg, masking)
    run_dir = cfg.output_dir
    shutil.rmtree(run_dir, ignore_errors=True)
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    psnr, nbytes = compress.main(cfg, run_dir=run_dir)
    t1 = time.perf_counter()
    img, stats = decompress.decode_run(run_dir, device="cuda")
    t2 = time.perf_counter()
    launches = dict(sm.LAUNCHES)

    summary = json.loads(open(f"{run_dir}/summary.json").read())
    num_steps = int(cfg.train.num_steps) * int(cfg.train.multiplier)
    masks = np.load(f"{run_dir}/mask.npz")
    final_counts = {int(k.split(".")[1]): int(masks[k].sum()) for k in masks.files}
    container = Path(run_dir) / "model_quantized"
    blob = (container / "compressed_weights.data").read_bytes()
    raw = read_raw_container(container, "zstd")
    decoded = decompress_state_dict(container, "zstd")
    with tempfile.TemporaryDirectory() as tmp:
        compress_state_dict(raw, tmp, "zstd")
        same_bytes = (Path(tmp) / "compressed_weights.data").read_bytes() == blob
    labeled = sorted(k for k in raw if k.endswith(".labeled_weight"))
    print(
        f"[9 finals] compress.main {t1 - t0:.2f} s (fit {summary['fit_wall_s']:.3f} s = "
        f"{summary['fit_wall_s'] / num_steps * 1e3:.3f} ms/step over {num_steps} steps, quant "
        f"{summary['quant_wall_s']:.3f} s, encode {summary['encode_wall_s']:.3f} s, "
        f"decode+render {summary['decode_wall_s']:.3f} s); decode_run {t2 - t1:.3f} s "
        f"(render {stats['render_s'] * 1e3:.2f} ms); launches {launches}",
        flush=True,
    )
    print(
        f"[9 finals] layer counts init {init_counts}, final {final_counts}; {len(labeled)} "
        f"labeled layers ({', '.join(str(raw[k].dtype) for k in labeled)}, at most "
        f"{max(int(raw[k].max()) for k in labeled) + 1} labels); container re-encodes to "
        f"{'the same bytes' if same_bytes else 'OTHER BYTES'}; fit PSNR {summary['PSNR']:.3f} "
        f"dB, quant PSNR {summary['Quant PSNR']:.3f} dB, decoded PSNR {psnr:.3f} dB, MS-SSIM "
        f"{summary['Decoded MS-SSIM']:.6f}, bytes {nbytes}",
        flush=True,
    )
    _check_launches(launches, "finals path")
    if final_counts != init_counts:
        raise AssertionError(f"RigL changed a layer's weight count: {init_counts} -> "
                             f"{final_counts}")
    if not same_bytes or len(blob) != nbytes:
        raise AssertionError("the zstd container does not hold what compress.main wrote")
    if len(labeled) != DEPTH - 2 or any(int(raw[k].max()) >= 2**FINALS_BITS for k in labeled):
        raise AssertionError(f"expected {DEPTH - 2} layers of {FINALS_BITS}-bit labels")
    for k in labeled:
        i = k.split(".")[1]
        weight = decoded[f"layers.{i}.weight"]
        if not np.all(np.isin(weight, raw[f"layers.{i}.centroids"].astype(np.float32))):
            raise AssertionError(f"layer {i}: a decoded weight is not a centroid")
        if np.any(weight[masks[f"layers.{i}.mask"] == 0] != 0.0):
            raise AssertionError(f"layer {i}: a pruned weight decodes to nonzero")
    if not (math.isfinite(psnr) and psnr >= 20.0):
        raise AssertionError(f"decoded PSNR {psnr} is not finite or below 20 dB")
    img = np.asarray(img)
    target = compress._load_image(cfg.img)
    redecoded = 10.0 * np.log10(1.0 / np.mean((img.astype(np.float64) - target) ** 2))
    if img.shape != (N_SIDE, N_SIDE, 3) or abs(redecoded - psnr) > 1e-3:
        raise AssertionError(f"decode_run gives {img.shape}, {redecoded} dB; compress "
                             f"reported {psnr}")
    return launches


def phase_layer_path(width: int) -> dict:
    """Phase 10 on the layer-wise kernels: compress.main at d8/w`width`
    (the repo's scripts' runs at 256 and 512, WIDE_COMMON + WIDE_OVERRIDES:
    20 fit steps, no quantization or container; above 512
    LAYER_PATH_COMMON: 20 fit + 20 finetune steps, k-means, zstd, then
    decode_run): only the layer-wise kernels and sum_partials launch, K2
    exactly once a fit and finetune step (depth launches of
    sine_mlp_layer_bwd, depth - 2 of sine_mlp_layer_dw, one sum_partials),
    K1 fills the z stash once a step and not in the decode (which grows the
    memory by less than a stash), sine_mlp_layer_fwd launches in K1 only
    (`_layer_forwards`), each launch of the kind the chain needs, and the
    fit PSNR is finite (the decoded PSNR decode_run's, where a container is
    written); prints the peak memory; returns the launch counts."""
    import numpy as np

    import torch

    from implicit_image_tpu_torch import compress, decompress
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    overrides = (WIDE_COMMON + WIDE_OVERRIDES[width] if width in WIDE_OVERRIDES
                 else LAYER_PATH_COMMON + [f"mlp.hidden_size={width}"])
    cfg = compress.compose(overrides + [f"output_dir=outputs/chip_smoke_w{width}"])
    if (int(cfg.mlp.depth), int(cfg.mlp.hidden_size)) != (DEPTH, width):
        raise AssertionError(f"the w{width} run must be SIREN d8/w{width}")
    if sm.kernel_width(width) <= sm.KERNEL_WIDTHS[-1]:
        raise AssertionError(f"w{width} does not run on the layer-wise kernels")
    quant = (cfg.get("quant") or {}).get("name", "none") != "none"
    container = (cfg.get("entropy_coding") or {}).get("stream_name", "none") != "none"
    shutil.rmtree(cfg.output_dir, ignore_errors=True)
    dev = torch.device("cuda")
    stash_bytes = 4 * (DEPTH - 1) * N_SIDE * N_SIDE * sm.kernel_width(width)
    with _layer_forwards() as forwards:
        torch.cuda.reset_peak_memory_stats(dev)
        sm.reset_launch_counts()
        t0 = time.perf_counter()
        psnr, nbytes = compress.main(cfg, run_dir=cfg.output_dir)
        t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated(dev)
        # the decode runs under no_grad: K1 keeps no stash
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        decode_stash = forwards["stash"]
        img = decompress.decode_run(cfg.output_dir, device="cuda")[0] if container else None
        decode_grew = torch.cuda.max_memory_allocated(dev) - base
        launches = dict(sm.LAUNCHES)
        by_kind = dict(sm.LAUNCHES_BY_KIND)
    summary = json.loads(open(f"{cfg.output_dir}/summary.json").read())
    steps = int(cfg.train.num_steps) + (int(cfg.quant.num_steps) if quant else 0)
    print(f"[10 w{width}] lr {cfg.optim.lr}; compress.main {t1 - t0:.2f} s (fit "
          f"{summary['fit_wall_s']:.3f} s = "
          f"{summary['fit_wall_s'] / int(cfg.train.num_steps) * 1e3:.3f} ms/step, quant "
          f"{summary.get('quant_wall_s', 0.0):.3f} s); fit PSNR {summary['PSNR']:.3f} dB, "
          f"{f'decoded {psnr:.3f} dB, {nbytes} B' if container else 'no container'}; "
          f"peak memory {peak / 2**30:.3f} GiB (the z stash "
          f"{stash_bytes / 2**30:.3f} GiB), decode_run's growth {decode_grew / 2**30:.3f} GiB; "
          f"K1 {forwards['stash']} times with the stash, {forwards['plain']} without; "
          f"launches {launches}", flush=True)
    _check_launches(launches, f"w{width} path", layer=True)
    want = {"sine_mlp_layer_bwd": DEPTH * steps, "sine_mlp_layer_dw": (DEPTH - 2) * steps,
            "sum_partials": steps, "sine_mlp_layer_fwd": forwards["launches"]["sine_mlp_layer_fwd"]}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"w{width}: launches {launches}, expected {want}")
    if not (forwards["stash"] == decode_stash == steps and decode_grew < stash_bytes):
        raise AssertionError(f"w{width}: {forwards['stash']} stashes ({decode_stash} before the "
                             f"decode) for {steps} steps; the decode grew {decode_grew} B")
    if not (math.isfinite(psnr) and math.isfinite(summary["PSNR"])):
        raise AssertionError(f"w{width}: PSNR {psnr} / fit PSNR {summary['PSNR']}")
    if container:
        target = compress._load_image(cfg.img)
        redecoded = 10.0 * np.log10(1.0 / np.mean((np.asarray(img, np.float64) - target) ** 2))
        if abs(redecoded - psnr) > 1e-3:
            raise AssertionError(f"w{width}: decoded PSNR {psnr}, decode_run {redecoded}")
    # the layer-wise kernels by kind: K2's last and first layer once a step,
    # K1's first and last once a band of each K1 call (the fit's, the
    # finetune's and the decode's)
    kinds = {k: v for k, v in by_kind.items() if not k.split()[0].endswith("_batched")}
    k1_bands = launches["sine_mlp_layer_fwd"] // DEPTH
    want = {"sine_mlp_layer_bwd last": steps, "sine_mlp_layer_bwd first": steps,
            "sine_mlp_layer_bwd hidden": (DEPTH - 2) * steps,
            "sine_mlp_layer_fwd first": k1_bands, "sine_mlp_layer_fwd last": k1_bands,
            "sine_mlp_layer_fwd hidden": (DEPTH - 2) * k1_bands}
    print(f"[10 w{width}] the layer-wise kernels' launches by kind {kinds}", flush=True)
    if kinds != want:
        raise AssertionError(f"w{width}: launches by kind {kinds}, expected {want}")
    return launches | {k: v for k, v in kinds.items() if not k.endswith("hidden")}


def _wavelet_lattice_kernels() -> None:
    """K1/K2 against the plain chain (fp32) at the wavelet-SIREN's LF
    shapes: 258² = 66,564 rows, d8/w128, out 3."""
    import torch

    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    dev = torch.device("cuda")
    mdef, mcfg = build_model("wavelet_siren", depth=DEPTH, hidden_size=WIDTH,
                             height=N_SIDE, width=N_SIDE)
    gen = torch.Generator().manual_seed(0)
    params = mdef.init(gen, mcfg, dev)[: mcfg.n_lf_layers]
    lf = mcfg.lf_config
    x = (get_grid(*mcfg.lf_shape, dev).reshape(-1, 2) - 0.5) * 2.0
    g = (torch.randn((x.shape[0], 3), generator=gen) / x.shape[0]).to(dev)
    kernel = (sm.sine_mlp_fwd(params, x, lf, "fp32"), *sm.sine_mlp_bwd(params, x, g, lf, "fp32"))
    plain = (sm.siren_chain_reference(params, x, lf, "fp32"),
             *sm.siren_chain_backward_reference(params, x, g, lf, "fp32"))
    torch.cuda.synchronize()
    fwd_err, rel, _ = _errors(kernel, plain)
    worst = max(rel, key=rel.get)
    print(f"[11 families] K1/K2 at the DWT lattice {mcfg.lf_shape} ({x.shape[0]} rows): fwd "
          f"max_abs_err {fwd_err:.3e} (tol {FWD_TOL['fp32']:g}); bwd max rel err "
          f"{rel[worst]:.3e} at {worst} (tol {BWD_TOL['fp32']:g})", flush=True)
    if not (fwd_err <= FWD_TOL["fp32"] and rel[worst] <= BWD_TOL["fp32"]):
        raise AssertionError(f"the kernels disagree at the wavelet lattice: {fwd_err}, {rel}")


def phase_families() -> None:
    """Phase 11: wavelet-SIREN dense and under RigL, Feathermap over SIREN
    and Fourier features through compress.main and decode_run."""
    import tempfile

    import numpy as np

    from implicit_image_tpu_torch import compress, decompress
    from implicit_image_tpu_torch.coding import compress_state_dict, read_raw_container
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    _wavelet_lattice_kernels()
    for run, overrides in FAMILY_RUNS.items():
        tag = f"[11 {run}]"
        cfg = compress.compose(FAMILY_COMMON + overrides + [
            f"output_dir=outputs/chip_smoke_{run.split()[0]}"])
        if (int(cfg.mlp.depth), int(cfg.mlp.hidden_size), int(cfg.img.height)) != (
                DEPTH, WIDTH, N_SIDE):
            raise AssertionError(f"{tag} must run d{DEPTH}/w{WIDTH} at {N_SIDE}²")
        masking = compress.masking_config(cfg)
        init_counts = _initial_counts(cfg, masking) if masking is not None else None
        fit_steps = int(cfg.train.num_steps) * int(cfg.train.get("multiplier", 1))
        quant_steps = int(cfg.quant.num_steps) if cfg.quant.name != "none" else 0
        stream = cfg.entropy_coding.stream_name
        run_dir = cfg.output_dir
        shutil.rmtree(run_dir, ignore_errors=True)
        sm.reset_launch_counts()
        t0 = time.perf_counter()
        psnr, nbytes = compress.main(cfg, run_dir=run_dir)
        t1 = time.perf_counter()
        img = decompress.decode_run(run_dir, device="cuda")[0] if stream != "none" else None
        launches = dict(sm.LAUNCHES)

        summary = json.loads(open(f"{run_dir}/summary.json").read())
        print(f"{tag} {cfg.mlp.name}, masking={(cfg.get('masking') or {}).get('name')}; "
              f"compress.main {t1 - t0:.2f} s (fit {summary['fit_wall_s']:.3f} s = "
              f"{summary['fit_wall_s'] / fit_steps * 1e3:.3f} ms/step over {fit_steps} steps, "
              f"quant {summary.get('quant_wall_s', 0.0):.3f} s over {quant_steps} steps); "
              f"launches {launches}", flush=True)
        if run.startswith("d"):
            if any(launches.values()):
                raise AssertionError(f"{tag} a SIREN kernel launched on the Fourier path")
        else:
            _check_launches(launches, f"{run} path")
            per_step = 2 if cfg.mlp.name == "wavelet_siren" else 1
            if launches["sine_mlp_bwd"] != per_step * (fit_steps + quant_steps) or (
                    launches["sum_partials"] != launches["sine_mlp_bwd"]):
                raise AssertionError(f"{tag} K2 launched {launches['sine_mlp_bwd']} times, "
                                     f"not {per_step} per step of {fit_steps + quant_steps}")
        if stream != "none":
            container = Path(run_dir) / "model_quantized"
            blob = (container / "compressed_weights.data").read_bytes()
            raw = read_raw_container(container, stream)
            with tempfile.TemporaryDirectory() as tmp:
                compress_state_dict(raw, tmp, stream)
                same_bytes = (Path(tmp) / "compressed_weights.data").read_bytes() == blob
            names = set(raw)
            print(f"{tag} container {nbytes} B, {len(names)} tensors, "
                  f"{sum(k.endswith('.labeled_weight') for k in names)} with a codebook; "
                  f"re-encodes to {'the same bytes' if same_bytes else 'OTHER BYTES'}; fit "
                  f"PSNR {summary['PSNR']:.3f} dB, quant PSNR {summary['Quant PSNR']:.3f} dB, "
                  f"decoded PSNR {psnr:.3f} dB, MS-SSIM {summary['Decoded MS-SSIM']:.6f}",
                  flush=True)
            if not same_bytes or len(blob) != nbytes:
                raise AssertionError(f"{tag} the container does not hold what compress.main "
                                     "wrote")
            if run.startswith("c") and names != FEATHER_NAMES:
                raise AssertionError(f"{tag} the container holds {sorted(names)}, not V1, V2 "
                                     "and the scalers alone")
            img = np.asarray(img)
            target = compress._load_image(cfg.img)
            redecoded = 10.0 * np.log10(1.0 / np.mean((img.astype(np.float64) - target) ** 2))
            if img.shape != (N_SIDE, N_SIDE, 3) or abs(redecoded - psnr) > 1e-3:
                raise AssertionError(f"{tag} decode_run gives {img.shape}, {redecoded} dB; "
                                     f"compress reported {psnr}")
        else:
            print(f"{tag} fit PSNR {psnr:.3f} dB", flush=True)
        if init_counts is not None:
            masks = np.load(f"{run_dir}/mask.npz")
            final_counts = {int(k.split(".")[1]): int(masks[k].sum()) for k in masks.files}
            print(f"{tag} RigL layer counts init {init_counts}, final {final_counts}",
                  flush=True)
            if final_counts != init_counts or len(init_counts) != 2 * DEPTH:
                raise AssertionError(f"{tag} RigL changed a layer's weight count, or masks "
                                     f"do not cover both sub-SIRENs: {init_counts} -> "
                                     f"{final_counts}")
        floor = FAMILY_PSNR_FLOOR.get(run, 20.0)
        if not (math.isfinite(psnr) and psnr >= floor):
            raise AssertionError(f"{tag} PSNR {psnr} is not finite or below {floor} dB")


def _p12_run(tag: str, overrides, decode: bool = True, floors=None) -> dict:
    """One phase-12 (or 15) run through compress.main (and
    decompress.decode_run when it writes a container), the launch counts set
    to 0 just before it; its PSNR held to floors[tag] (P12_FLOOR by
    default)."""
    import numpy as np

    from implicit_image_tpu_torch import compress, decompress
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    cfg = compress.compose(list(overrides))
    if cfg.mlp.name != "coordx" and int(cfg.img.height) != N_SIDE:
        raise AssertionError(f"{tag} must run at {N_SIDE}²")
    run_dir = cfg.output_dir
    shutil.rmtree(run_dir, ignore_errors=True)
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    psnr, nbytes = compress.main(cfg, run_dir=run_dir)
    seconds = time.perf_counter() - t0
    stream = (cfg.get("entropy_coding") or {}).get("stream_name", "none")
    if decode and stream != "none":
        img = np.asarray(decompress.decode_run(run_dir, device="cuda")[0])
        target = compress._load_image(cfg.img)
        redecoded = 10.0 * np.log10(1.0 / np.mean((img.astype(np.float64) - target) ** 2))
        if img.shape != target.shape or abs(redecoded - psnr) > 1e-3:
            raise AssertionError(f"{tag} decode_run gives {img.shape}, {redecoded} dB; "
                                 f"compress reported {psnr}")
    launches = dict(sm.LAUNCHES)
    by_mode = {k: dict(v) for k, v in sm.LAUNCHES_BY_MODE.items()}
    summary = json.loads(open(f"{run_dir}/summary.json").read())
    steps = int(summary.get("stopped_at") or int(cfg.train.num_steps) * int(
        cfg.train.get("multiplier", 1)))
    ms_step = summary["fit_wall_s"] / steps * 1e3
    print(f"{tag} compress.main {seconds:.2f} s (fit {summary['fit_wall_s']:.3f} s = "
          f"{ms_step:.3f} ms/step over {steps} steps, quant "
          f"{summary.get('quant_wall_s', 0.0):.3f} s); fit PSNR {summary['PSNR']:.3f} dB, "
          f"{'decoded' if stream != 'none' else 'fit'} PSNR {psnr:.3f} dB, bytes {nbytes}; "
          f"launches by mode {by_mode}", flush=True)
    floor = (P12_FLOOR if floors is None else floors).get(tag.strip("[]"), -math.inf)
    if not (math.isfinite(psnr) and psnr >= floor):
        raise AssertionError(f"{tag} PSNR {psnr} is not finite or below {floor} dB")
    return {"cfg": cfg, "psnr": psnr, "bytes": nbytes, "summary": summary, "ms_step": ms_step,
            "launches": launches, "by_mode": by_mode, "run_dir": run_dir}


def _expected_modes(n: int, switch: int, log_steps: int, tail_fwd: int, tail_bwd: int) -> dict:
    """Launches per mode of a scheduled SIREN fit of n steps (evals at the
    log cadence and the last step) and what runs after it in fp32 (tail_fwd
    forwards, tail_bwd backwards: the finetune, its eval, the renders)."""
    evals = [s for s in range(n) if (s + 1) % log_steps == 0 or s == n - 1]
    early_evals = sum(s < switch for s in evals)
    bwd = {"bf16": switch, "fp32": n - switch + tail_bwd}
    return {"sine_mlp_fwd": {"bf16": switch + early_evals,
                             "fp32": n - switch + len(evals) - early_evals + tail_fwd},
            "sine_mlp_bwd": bwd, "sum_partials": dict(bwd)}


def _segment_ms(overrides, n: int, seg: int, **train) -> dict:
    """ms per step of each boundary-to-boundary segment of a fit of n steps
    (fit() with the run's config; a watch callback synchronizes and stamps
    each boundary): {segment end: ms per step}."""
    import torch

    from implicit_image_tpu_torch import compress
    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model_from_config
    from implicit_image_tpu_torch.training.fit import TrainConfig, fit

    cfg = compress.compose(list(overrides))
    mdef, mcfg = build_model_from_config(cfg)
    img = compress._load_image(cfg.img)
    stamps = []

    def watch(params, opt_state, step):
        torch.cuda.synchronize()
        stamps.append((step, time.perf_counter()))

    torch.cuda.synchronize()
    stamps.append((0, time.perf_counter()))
    fit(torch.Generator().manual_seed(int(cfg.seed)), mdef, mcfg, get_grid(N_SIDE, N_SIDE, "cuda"),
        img, TrainConfig(num_steps=n, log_steps=n, segment_steps=seg, **train),
        compress._optim_config(cfg), compress.masking_config(cfg), device="cuda", watch=watch)
    return {b: (tb - ta) / (b - a) * 1e3 for (a, ta), (b, tb) in zip(stamps, stamps[1:])}


def phase_schedule(default_ms_step: float) -> None:
    """12a: the precision schedule on the RigL default (200 + 20 steps), and
    a d8/w182 fit switching at 0.5 (the width-192 forward and backward on
    wgmma; the backward sums its dW itself)."""
    from implicit_image_tpu_torch.training.fit import TrainConfig, plan_precision_schedule

    r = _p12_run("[12a schedule]", SCHEDULE_OVERRIDES)
    n, quant = int(r["cfg"].train.num_steps), int(r["cfg"].quant.num_steps)
    early, switch = plan_precision_schedule(
        TrainConfig(num_steps=n, matmul_precision_early="bfloat16"), n)
    # after the fit, in fp32: the finetune's steps, its eval, compress's
    # render of the container and decode_run's
    expect = _expected_modes(n, switch, int(r["cfg"].train.log_steps), quant + 3, quant)
    got = {k: r["by_mode"][k] for k in expect}
    print(f"[12a schedule] plan: {early} for steps [0, {switch}), fp32 after; launches by "
          f"mode {got}, planned {expect}", flush=True)
    if (early, switch) != ("bf16", 150) or got != expect:
        raise AssertionError(f"[12a schedule] the launches do not follow the plan: {got} != "
                             f"{expect}")
    ms = _segment_ms(SCHEDULE_OVERRIDES, 80, 20, matmul_precision_early="bfloat16",
                     matmul_precision_switch=0.5)
    print(f"[12a schedule] ms/step by segment (80 steps, switch at 40): "
          f"{ {k: round(v, 3) for k, v in ms.items()} }; bf16 steps 20-39 {ms[40]:.3f}, fp32 "
          f"steps 60-79 {ms[80]:.3f} ms/step (phase 5, all fp32: {default_ms_step:.3f})",
          flush=True)

    w = _p12_run("[12a w182]", SCHEDULE_WIDE_OVERRIDES)
    expect = _expected_modes(20, 10, 10, 0, 0)
    got = {k: w["by_mode"][k] for k in expect}
    print(f"[12a w182] launches by mode {got}, planned {expect}", flush=True)
    if got != expect:
        raise AssertionError(f"[12a w182] the launches do not follow the plan: {got}")


def _mixed_kernels(width: int) -> None:
    """The kernels under fp32+mixed against the plain chain at 512², d8."""
    import torch

    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    prec = "fp32" + sm.MIXED
    mdef, mcfg = build_model("siren", depth=DEPTH, hidden_size=width)
    gen = torch.Generator().manual_seed(3)
    params = mdef.init(gen, mcfg, "cuda")
    x = (get_grid(N_SIDE, N_SIDE, "cuda").reshape(-1, 2) - 0.5) * 2.0
    g = (torch.randn((x.shape[0], 3), generator=gen) / x.shape[0]).cuda()
    kernel = (sm.sine_mlp_fwd(params, x, mcfg, prec), *sm.sine_mlp_bwd(params, x, g, mcfg, prec))
    plain = (sm.siren_chain_reference(params, x, mcfg, prec),
             *sm.siren_chain_backward_reference(params, x, g, mcfg, prec))
    torch.cuda.synchronize()
    fwd_err, rel, _ = _errors(kernel, plain)
    worst = max(rel, key=rel.get)
    print(f"[12b mixed] kernels vs plain at w{width} ({prec}): fwd max_abs_err {fwd_err:.3e} "
          f"(tol {FWD_TOL['bf16']:g}); bwd max rel err {rel[worst]:.3e} at {worst} (tol "
          f"{BWD_TOL['bf16']:g})", flush=True)
    if not (fwd_err <= FWD_TOL["bf16"] and rel[worst] <= BWD_TOL["bf16"]):
        raise AssertionError(f"[12b mixed] the kernels disagree with the plain chain at "
                             f"w{width}: {fwd_err}, {rel}")


def phase_mixed() -> None:
    """12b: train.mixed_precision on the RigL default (200 + 20 steps)."""
    for width in (WIDTH, FINALS_WIDTH):
        _mixed_kernels(width)
    r = _p12_run("[12b mixed]", MIXED_OVERRIDES)
    _check_launches(r["launches"], "mixed-precision path")
    if any(v["bf16"] for v in r["by_mode"].values()):
        raise AssertionError("[12b mixed] a kernel launched in the bf16 mode")


def phase_stop() -> None:
    """12c: train.stop_at_psnr with a 400-step budget, a check every 25."""
    r = _p12_run("[12c stop]", STOP_OVERRIDES)
    stop = r["summary"].get("stopped_at")
    stop = None if stop is None else int(stop)
    checks = (stop or 400) // 25
    print(f"[12c stop] stopped at step {stop} of 400 at {r['summary']['PSNR']:.3f} dB (target "
          f"{STOP_TARGET}; {checks} checks, one bf16 forward each)", flush=True)
    if stop is None or stop % 25 or stop >= 400 or r["summary"]["PSNR"] < STOP_TARGET:
        raise AssertionError(f"[12c stop] no early stop at a boundary: {stop}")
    if r["by_mode"]["sine_mlp_fwd"]["bf16"] != checks:
        raise AssertionError(f"[12c stop] {r['by_mode']['sine_mlp_fwd']['bf16']} bf16 "
                             f"forwards, not one per check ({checks})")


def _sha256(path) -> str:
    import hashlib

    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def phase_resume() -> None:
    """12d: a 100-step RigL fit (a mask update every 20 steps) interrupted at
    step 50 and resumed, against the uninterrupted run: the same bits."""
    full = _p12_run("[12d full]", RESUME_COMMON + ["train.num_steps=100",
                                                   f"output_dir={P12}_resume_full"])
    half = _p12_run("[12d first 50]", RESUME_COMMON + [
        "train.num_steps=50", "train.checkpoint=true", "train.segment_steps=25",
        f"output_dir={P12}_resume_half"])
    rest = _p12_run("[12d resumed]", RESUME_COMMON + [
        "train.num_steps=100", f"train.resume={half['run_dir']}/checkpoint.npz",
        f"output_dir={P12}_resume_rest"])
    shas = {name: (_sha256(f"{r['run_dir']}/model.npz"), _sha256(f"{r['run_dir']}/mask.npz"))
            for name, r in (("full", full), ("resumed", rest))}
    print(f"[12d resume] sha256 of model.npz / mask.npz: uninterrupted "
          f"{shas['full'][0][:16]} / {shas['full'][1][:16]}, resumed at 50 "
          f"{shas['resumed'][0][:16]} / {shas['resumed'][1][:16]}", flush=True)
    if shas["full"] != shas["resumed"]:
        raise AssertionError("[12d resume] the resumed fit's params differ from the "
                             "uninterrupted fit's")


def phase_clip() -> None:
    """12e: the tracked d8/w512 SIREN at lr 3e-4 with optim.grad_clip=1.0,
    on the layer-wise kernels."""
    r = _p12_run("[12e clip]", CLIP_OVERRIDES)
    s = r["summary"]
    print(f"[12e clip] clip scale: min {s['clip_scale_min']:.6g}, last step "
          f"{s['clip_scale_last']:.6g}", flush=True)
    _check_launches(r["launches"], "clipped w512 path", layer=True)


def phase_exact_sine(dense_ms_step: float) -> None:
    """12f: mlp.fast_sine=false, the torch.sin chain (200 + 20 steps)."""
    r = _p12_run("[12f exact sine]", EXACT_SINE_OVERRIDES)
    print(f"[12f exact sine] {r['ms_step']:.3f} ms/step through torch.sin (phase 4, the "
          f"kernels: {dense_ms_step:.3f} ms/step); launches {r['launches']}", flush=True)
    if any(r["launches"].values()):
        raise AssertionError("[12f exact sine] a SIREN kernel launched on the torch.sin path")


def phase_coordx_bf16() -> None:
    """12g: CoordX at train.matmul_precision=bfloat16, cold, phase 8's shape."""
    r = _p12_run("[12g coordx bf16]", COORDX_BF16_OVERRIDES)
    if any(r["launches"].values()):
        raise AssertionError("[12g coordx bf16] a SIREN kernel launched on the CoordX path")


def phase_hashgrid() -> None:
    """12h: hashgrid at its default config (300 + 20 steps, k-means, zstd),
    its device rows over 30 profiled steps, and two 50-step fits' bits."""
    from implicit_image_tpu_torch import profile_fit

    r = _p12_run("[12h hashgrid]", HASHGRID_OVERRIDES)
    if any(r["launches"].values()):
        raise AssertionError("[12h hashgrid] a SIREN kernel launched on the hashgrid path")
    trace = Path(f"{P12}_hashgrid.trace.json")
    prof = profile_fit.profile_steps(HASHGRID_OVERRIDES, profile_fit.STEPS, trace)
    print(f"[12h hashgrid] {profile_fit.STEPS} profiled steps: {prof['ms_per_step']:.3f} "
          f"ms/step unprofiled ({prof['ms_per_step_dense']:.3f} with masking=none), device "
          f"{prof['device_ms_per_step']:.3f} ms/step, idle share {prof['idle_share']:.4f}; "
          f"top rows " + "; ".join(f"{row['ms_per_step']:.4f} ms/step {row['count']}x "
                                   f"{row['name'][:60]}" for row in prof["rows"][:6]),
          flush=True)
    short = [o for o in HASHGRID_OVERRIDES if not o.startswith(("train.num_steps", "output_dir"))]
    shas = []
    for i in (1, 2):
        r = _p12_run(f"[12h repeat {i}]", short + [
            "train.num_steps=50", "quant=none", "entropy_coding=none",
            f"output_dir={P12}_hashgrid_{i}"])
        shas.append(_sha256(f"{r['run_dir']}/model.npz"))
    print(f"[12h hashgrid] two 50-step fits: model.npz sha256 {shas[0][:16]} / {shas[1][:16]}",
          flush=True)
    if shas[0] != shas[1]:
        raise AssertionError("[12h hashgrid] two fits of one config gave different params")


def _decoded_db(img, target) -> float:
    import numpy as np

    err = np.mean((np.asarray(img, np.float64) - np.asarray(target, np.float64)) ** 2)
    return float(10.0 * np.log10(1.0 / err))


def phase_bit_alloc(tag: str, overrides, flat_run: str) -> None:
    """13a: quant.bit_alloc=auto through compress.main: the allocation, adopted
    or not, each arm's decoded dB and bytes, the quant wall it adds over the
    same run without it (`flat_run`, which it equals up to the search: its
    uniform arm must be that run's container, bit for bit), and the probe
    renders in JAX's default bf16 pass."""
    from implicit_image_tpu_torch import compress
    from implicit_image_tpu_torch.coding import decode_and_render
    from implicit_image_tpu_torch.models import build_model_from_config

    r = _p12_run(tag, overrides)
    s, cfg = r["summary"], r["cfg"]
    base = json.loads(open(f"{flat_run}/summary.json").read())
    mdef, mcfg = build_model_from_config(cfg)
    target = compress._load_image(cfg.img)
    stream = cfg.entropy_coding.stream_name
    arms = {}
    for arm in ("auto", "uniform"):
        d = Path(r["run_dir"]) / f"bit_alloc_{arm}"
        if d.is_dir():
            img, _ = decode_and_render(d, stream, mdef, mcfg, *target.shape[:2])
            arms[arm] = (_decoded_db(img, target), (d / "compressed_weights.data").stat().st_size)
    same = _sha256(f"{r['run_dir']}/model_quantized/compressed_weights.data")
    flat = _sha256(f"{flat_run}/model_quantized/compressed_weights.data")
    uniform_is_flat = ("uniform" not in arms or _sha256(
        f"{r['run_dir']}/bit_alloc_uniform/compressed_weights.data") == flat)
    adopted = same != flat
    verdict = ("adopted" if adopted else "rejected: the uniform books dominate" if arms
               else "the search chose the uniform books")
    print(f"{tag} allocation {s['Bit Allocation']} ({verdict}); arms "
          + "; ".join(f"{a} {db:.3f} dB @ {nb} B" for a, (db, nb) in arms.items())
          + f"; search {s['bit_alloc_search_s']:.3f} s, quant wall {s['quant_wall_s']:.3f} s "
          f"against {base['quant_wall_s']:.3f} s without bit_alloc; K1 launches by mode "
          f"{r['by_mode']['sine_mlp_fwd']}", flush=True)
    if not uniform_is_flat or (not adopted and r["bytes"] != base["Compressed Bytes"]):
        raise AssertionError(f"{tag}: the uniform arm is not the run without bit_alloc")
    if r["by_mode"]["sine_mlp_fwd"]["bf16"] <= 0 or r["by_mode"]["sine_mlp_bwd"]["bf16"]:
        raise AssertionError(f"{tag}: the probes must render K1 in the bf16 mode, and only "
                             f"they: {r['by_mode']}")


def phase_progressive(default_run: str) -> None:
    """13b: the progressive container with its base finetune on phase 5's
    configuration under the `auto` stream: its bytes against the flat
    container of phase 5's state under the same stream, the full decode
    phase 5's flat decode bit for bit, the base prefix's dB before (the same
    container written without the finetune) and after, and a second
    finetune of the same base section gives the stored books' sha256."""
    import hashlib

    import numpy as np

    from implicit_image_tpu_torch import compress, decompress
    from implicit_image_tpu_torch.coding import (compress_state_dict, progressive,
                                                 read_raw_container)
    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model_from_config
    from implicit_image_tpu_torch.quant.base_layer import finetune_base_codebooks

    r = _p12_run("[13b progressive]", PROGRESSIVE_OVERRIDES)
    _check_launches(r["launches"], "progressive path")
    cfg, run_dir = r["cfg"], r["run_dir"]
    container = Path(run_dir) / "model_quantized"
    flat_img, _ = decompress.decode_run(default_run, out_path=f"{P13}_flat.png")
    full_img, _ = decompress.decode_run(run_dir)
    base_img, _ = decompress.decode_run(run_dir, base=True)
    target = compress._load_image(cfg.img)
    # the same container without the finetune: re-split what it stores (the
    # rank labels against the sorted books split to the same hi planes)
    stored = read_raw_container(container, PROGRESSIVE_STREAM)
    base_entries, _ = progressive._split_entries(stored)
    before_dir = Path(f"{P13}_progressive_no_finetune")
    shutil.rmtree(before_dir, ignore_errors=True)
    before_dir.mkdir(parents=True)
    shutil.copy(Path(run_dir) / "config.json", before_dir / "config.json")
    progressive.compress_progressive(stored, before_dir / "model_quantized", PROGRESSIVE_STREAM)
    before_img, _ = decompress.decode_run(before_dir, base=True)
    flat_bytes = compress_state_dict(
        read_raw_container(Path(default_run) / "model_quantized", "plain"),
        Path(f"{P13}_flat_{PROGRESSIVE_STREAM}"), PROGRESSIVE_STREAM)
    mdef, mcfg = build_model_from_config(cfg)
    grid = get_grid(*target.shape[:2], "cuda")
    t0 = time.perf_counter()
    again = finetune_base_codebooks(mdef, mcfg, grid, target, base_entries)
    ft_s = time.perf_counter() - t0
    stored_base = progressive.read_progressive(container, PROGRESSIVE_STREAM, base_only=True)

    def books_sha(books):
        h = hashlib.sha256()
        for name in sorted(books):
            h.update(np.ascontiguousarray(books[name]).tobytes())
        return h.hexdigest()

    run_sha = books_sha({n: stored_base[n.replace("base_centroids", "centroids")]
                         for n in again})
    print(f"[13b progressive] {r['bytes']} B ({r['bytes'] / flat_bytes - 1:+.2%} on the flat "
          f"{PROGRESSIVE_STREAM} container's {flat_bytes}), base prefix "
          f"{r['summary']['base_bytes']:.0f} B; full "
          f"decode {'the bits of' if np.array_equal(full_img, flat_img) else 'DIFFERS FROM'} "
          f"the flat decode, {_decoded_db(full_img, target):.3f} dB; base prefix "
          f"{_decoded_db(before_img, target):.3f} dB before the finetune, "
          f"{_decoded_db(base_img, target):.3f} dB after; base finetune "
          f"{r['summary']['base_finetune_wall_s']:.3f} s in the run, {ft_s:.3f} s again; "
          f"books sha256 {run_sha[:16]} / {books_sha(again)[:16]}", flush=True)
    if not np.array_equal(full_img, flat_img):
        raise AssertionError("[13b progressive] the full decode is not the flat decode")
    if books_sha(again) != run_sha:
        raise AssertionError("[13b progressive] two base finetunes differ")
    if not _decoded_db(base_img, target) > _decoded_db(before_img, target):
        raise AssertionError("[13b progressive] the base finetune did not improve the prefix")


def phase_geometry(default_run: str) -> None:
    """13c, 13d: from phase 5's run dir, a --scale 4 render (2048²: one K1
    launch of 4.2 M rows), the same lattice in --tile-rows 256 bands and a
    window of it, equal to the full render's slices bit for bit; Mpix/s of
    each and of the launch alone; then the run packed into an .iic file,
    whose decode is the run dir's."""
    import numpy as np
    import torch

    from implicit_image_tpu_torch import decompress
    from implicit_image_tpu_torch.coding import (container_file, decompress_state_dict,
                                                 params_from_state_dict)
    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model_from_config
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    out = {}
    for name, geo in (("scale", {}), ("bands", {"tile_rows": TILE_ROWS}),
                      ("window", {"roi": ROI, "tile_rows": TILE_ROWS})):
        decompress.decode_run(default_run, out_path=f"{P13}_{name}.png", scale=SCALE, **geo)
        sm.reset_launch_counts()
        img, stats = decompress.decode_run(default_run, out_path=f"{P13}_{name}.png",
                                           scale=SCALE, **geo)
        out[name] = (np.asarray(img), stats, sm.LAUNCHES["sine_mlp_fwd"])
    full = out["scale"][0]
    r0, r1, c0, c1 = ROI
    side = full.shape[0]
    cfg = json.loads(open(f"{default_run}/config.json").read())
    mdef, mcfg = build_model_from_config(cfg)
    params = params_from_state_dict(decompress_state_dict(
        Path(default_run) / "model_quantized", "plain"), "cuda")
    x = (get_grid(side, side, "cuda").reshape(-1, 2) - 0.5) * 2.0
    launch_ms = _time_ms(lambda: sm.sine_mlp_fwd(params, x, mcfg, "fp32"), 5)
    del x
    print(f"[13c geometry] --scale {SCALE}: {full.shape[0]}x{full.shape[1]} in "
          + "; ".join(f"{n} {o[1]['render_s'] * 1e3:.2f} ms = {o[1]['mpix_per_s']:.1f} Mpix/s "
                      f"({o[2]} K1 launches)" for n, o in out.items())
          + f"; one K1 launch of {side * side} rows {launch_ms:.3f} ms = "
          f"{side * side / launch_ms / 1e3:.1f} Mpix/s (the render without the host copy)",
          flush=True)
    if full.shape != (N_SIDE * SCALE, N_SIDE * SCALE, 3) or not np.isfinite(full).all():
        raise AssertionError(f"[13c geometry] the render is {full.shape} or not finite")
    if not np.array_equal(out["bands"][0], full):
        raise AssertionError("[13c geometry] the bands are not the full render")
    if not np.array_equal(out["window"][0], full[r0:r1, c0:c1]):
        raise AssertionError("[13c geometry] the window is not the full render's slice")
    if (out["scale"][2], out["bands"][2]) != (1, -(-side // TILE_ROWS)):
        raise AssertionError(f"[13c geometry] launches {out['scale'][2]}, {out['bands'][2]}")

    iic = container_file.pack_run(default_run, f"{P13}_default.iic")
    from_file, _ = decompress.decode_run(iic)
    from_dir, _ = decompress.decode_run(default_run, out_path=f"{P13}_dir.png")
    print(f"[13d iic] {iic} {iic.stat().st_size} B: its decode "
          f"{'is' if np.array_equal(from_file, from_dir) else 'IS NOT'} the run dir's, bit for "
          "bit", flush=True)
    if not np.array_equal(from_file, from_dir):
        raise AssertionError("[13d iic] the packed run decodes differently")


def phase_batched_decode() -> dict:
    """13e: a -m sweep of SWEEP_SEEDS seeds at w128 and 2 at the finals width
    through compress.cli at launcher.n_jobs=2, and the finals-width sweep
    again at n_jobs=1: each member's stream is the same bytes at either. Then
    decode_runs over each width's runs, its launches counted alone, and over
    all of them: one K1 launch per group over its member axis, each image its
    single decode's bits. Returns the batched launches measured per width."""
    import hashlib

    import numpy as np

    from implicit_image_tpu_torch import compress, decompress
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    def sweep(width: int, seeds: int, n_jobs: int) -> list:
        root = f"{P13}_sweep_w{width}_j{n_jobs}"
        shutil.rmtree(root, ignore_errors=True)
        t0 = time.perf_counter()
        compress.cli(["-m", *SWEEP_COMMON, f"launcher.n_jobs={n_jobs}",
                      f"mlp.hidden_size={width}", "seed=" + ",".join(map(str, range(seeds))),
                      f"output_dir={root}"])
        run_dirs = sorted(str(d) for d in Path(root).iterdir() if d.is_dir())
        print(f"[13e sweep] w{width}: {len(run_dirs)} runs in {time.perf_counter() - t0:.2f} "
              f"s (launcher.n_jobs={n_jobs})", flush=True)
        return run_dirs

    def stream_sha(run_dir: str) -> str:
        data = Path(run_dir, "model_quantized", "compressed_weights.data").read_bytes()
        return hashlib.sha256(data).hexdigest()

    dirs = {WIDTH: sweep(WIDTH, SWEEP_SEEDS, 2), FINALS_WIDTH: sweep(FINALS_WIDTH, 2, 2)}
    serial = sweep(FINALS_WIDTH, 2, 1)
    threaded_sha = [stream_sha(d) for d in dirs[FINALS_WIDTH]]
    serial_sha = [stream_sha(d) for d in serial]
    print(f"[13e n_jobs] w{FINALS_WIDTH} streams at n_jobs=2 {[h[:16] for h in threaded_sha]}, "
          f"at n_jobs=1 {[h[:16] for h in serial_sha]}", flush=True)
    if len(serial_sha) != 2 or threaded_sha != serial_sha:
        raise AssertionError("[13e n_jobs] the members' streams depend on launcher.n_jobs")

    runs = dirs[WIDTH] + dirs[FINALS_WIDTH]
    decompress.decode_runs(runs)  # the first call sets up
    per_width = {}
    for width in (WIDTH, FINALS_WIDTH):
        sm.reset_launch_counts()
        decompress.decode_runs(dirs[width])
        per_width[width] = dict(sm.LAUNCHES)
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    images = decompress.decode_runs(runs)
    seconds = time.perf_counter() - t0
    launches = dict(sm.LAUNCHES)
    singles = [np.asarray(decompress.decode_run(d, out_path=f"{d}/single.png")[0]) for d in runs]
    same = [np.array_equal(a, b) for a, b in zip(images, singles)]
    psnrs = [json.loads(open(f"{d}/summary.json").read())["Decoded PSNR"] for d in runs]
    print(f"[13e decode_runs] launches per width alone {per_width}; {len(runs)} runs in 2 "
          f"groups, {seconds:.3f} s; launches {launches}; each image its single decode's "
          f"bits: {same}; decoded PSNRs {[round(p, 3) for p in psnrs]}", flush=True)

    def one_batched(counts: dict, n: int) -> bool:
        return counts == {k: n if k == "sine_mlp_fwd_batched" else 0 for k in counts}

    if not all(one_batched(c, 1) for c in per_width.values()) or not one_batched(launches, 2):
        raise AssertionError(f"[13e decode_runs] expected one batched K1 launch per group "
                             f"and no other launch: {per_width}, {launches}")
    if not all(same) or not all(math.isfinite(p) for p in psnrs) or len(runs) != SWEEP_SEEDS + 2:
        raise AssertionError("[13e decode_runs] an image is not its single decode's, or a run "
                             "failed")
    return {width: counts["sine_mlp_fwd_batched"] for width, counts in per_width.items()}


def phase_profile() -> None:
    """13f: profile=True on a 20-step dense fit: the trace in <run>/profile/
    holds K1's and K2's device rows."""
    from implicit_image_tpu_torch import profile_fit

    r = _p12_run("[13f profile]", PROFILE_OVERRIDES)
    trace_file = Path(r["run_dir"]) / "profile" / "trace.json"
    rows = profile_fit.trace_breakdown(trace_file, 20)["rows"]
    kernels = {name: [row for row in rows if name in row["name"]]
               for name in ("sine_mlp_fwd_kernel", "sine_mlp_bwd_kernel", "sum_partials")}
    print(f"[13f profile] {trace_file} {trace_file.stat().st_size} B; "
          + "; ".join(f"{k}: {sum(x['count'] for x in v)} rows, "
                      f"{sum(x['ms'] for x in v):.3f} ms" for k, v in kernels.items()), flush=True)
    if not all(kernels.values()):
        raise AssertionError(f"[13f profile] the trace lacks K1/K2 rows: {kernels}")


def _ladder_cli(name: str, extra) -> tuple:
    """One ladder through its CLI (ladder.cli in this process, launches
    counted from 0): (composed cfg, densities, run dirs, summaries, launches,
    seconds)."""
    from implicit_image_tpu_torch.ops import sine_mlp as sm
    from implicit_image_tpu_torch.parallel import ladder

    out = f"{P14}_{name.split()[0]}"
    argv = extra + [f"output_dir={out}", "exp_name=smoke"]
    cfg, densities, _ = ladder.parse_ladder_cli(argv)
    shutil.rmtree(out, ignore_errors=True)
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    ladder.cli(argv)
    seconds = time.perf_counter() - t0
    launches = dict(sm.LAUNCHES)
    mname = cfg.masking.name
    dirs = [Path(out) / cfg.img.name / f"ladder_{mname}_smoke" / f"d{d}" for d in densities]
    summaries = [json.loads((d / "summary.json").read_text()) for d in dirs]
    return cfg, densities, dirs, summaries, launches, seconds


def _check_ladder_launches(tag: str, launches: dict, members: int, steps: int, evals: int,
                           quant_steps: int) -> None:
    """The fit and the codebook finetune over the member axis: one batched K1
    per fit step and eval and per finetune step, one more for the
    finetune's eval; one batched K2 (and partial sum) per fit and finetune
    step; no single K2 launch (the members' single K1 launches are their
    decodes)."""
    want = {"sine_mlp_fwd_batched": steps + evals + quant_steps + 1,
            "sine_mlp_bwd_batched": steps + quant_steps,
            "sum_partials_batched": steps + quant_steps,
            "sine_mlp_bwd": 0, "sum_partials": 0}
    got = {k: launches[k] for k in want}
    if got != want or launches["sine_mlp_fwd"] <= 0:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")


def _ladder_members(name: str, tag: str, dirs, summaries, densities, axis: str,
                    tol: float) -> list:
    """Each member: finite decoded PSNR above its floor (LADDER_FLOOR[name]),
    bytes rising with density, final density (mask.npz) within tol of its
    target; returns the final masks."""
    import numpy as np

    masks = []
    for d, run, summ in zip(densities, dirs, summaries):
        floor = LADDER_FLOOR[name][d]
        mk = np.load(run / "mask.npz")
        masks.append({int(k.split(".")[1]): mk[k] for k in mk.files})
        density = sum(float(v.sum()) for v in masks[-1].values()) / sum(
            v.size for v in masks[-1].values())
        cfg_d = json.loads((run / "config.json").read_text())
        print(f"{tag} d={d}: fit {summ['PSNR']:.3f} dB, quant {summ['Quant PSNR']:.3f} dB, "
              f"decoded {summ['Decoded PSNR']:.3f} dB @ {summ['Compressed Bytes']} B; final "
              f"density {density:.4f}", flush=True)
        if cfg_d["masking"][axis] != d:
            raise AssertionError(f"{tag} {run}/config.json has {axis} {cfg_d['masking'][axis]}")
        if not (math.isfinite(summ["Decoded PSNR"]) and summ["Decoded PSNR"] >= floor):
            raise AssertionError(f"{tag} d={d}: decoded PSNR {summ['Decoded PSNR']} (floor "
                                 f"{floor})")
        if abs(density - d) > tol:
            raise AssertionError(f"{tag} d={d}: final density {density}")
    nbytes = [summ["Compressed Bytes"] for summ in summaries]
    if nbytes != sorted(nbytes) or len(set(nbytes)) != len(nbytes):
        raise AssertionError(f"{tag} bytes do not rise with density: {nbytes}")
    return masks


def phase_ladder_rigl(default_run: str) -> dict:
    """14a: the RigL ladder of scripts/sparsify.sh through
    `python -m implicit_image_tpu_torch.parallel.ladder` (its cli, in this
    process), cut as LADDER_CUT says. Batched K1/K2 only in the fit; each
    member's RigL weight count conserved and its density at its target;
    bytes rising with density; decoded PSNR finite and above its floor; the
    member at 0.25 the bits of a single fit (weights, masks) with its
    generator; the five run dirs decoded by decode_runs in one batched K1
    launch, each image its decode_run's bits. Returns the launches."""
    import numpy as np
    import torch

    from implicit_image_tpu_torch import decompress
    from implicit_image_tpu_torch.ops import sine_mlp as sm
    from implicit_image_tpu_torch.parallel import ladder, member_generators
    from implicit_image_tpu_torch.training.fit import fit, init_fit_state

    tag = "[14a RigL ladder]"
    print(f"{tag} cut: train.num_steps 2000 x train.multiplier 5 -> 200 x 1, quant.num_steps "
          f"100 -> 20 ({' '.join(LADDER_CUT)})", flush=True)
    cfg, densities, dirs, summaries, launches, seconds = _ladder_cli(
        "14a RigL", LADDER_RUNS["14a RigL"] + LADDER_CUT)
    steps, q = int(cfg.train.num_steps), int(cfg.quant.num_steps)
    evals = len([s for s in range(steps) if (s + 1) % int(cfg.train.log_steps) == 0
                 or s == steps - 1])
    print(f"{tag} {len(densities)} members in {seconds:.2f} s; launches {launches}", flush=True)
    _check_ladder_launches(tag, launches, len(densities), steps, evals, q)
    masks = _ladder_members("14a RigL", tag, dirs, summaries, densities, "density",
                            LADDER_DENSITY_TOL)

    args = ladder.build_ladder_args(cfg)
    gens = member_generators(torch.Generator().manual_seed(int(cfg.seed)), len(densities))
    for i, d in enumerate(densities):  # the init counts, drawn as the member's fit draws them
        cfg_d = dataclasses.replace(args["masking"], density=d)
        init = init_fit_state(gens[i], args["mdef"], args["mcfg"], args["optim_cfg"], cfg_d,
                              None, "cpu")[2]
        counts = {j: int(m.sum()) for j, m in enumerate(init.masks) if m is not None}
        final = {j: int(m.sum()) for j, m in masks[i].items()}
        if counts != final:
            raise AssertionError(f"{tag} d={d}: RigL weight counts {final}, at init {counts}")
    print(f"{tag} every member's per-layer weight count conserved", flush=True)

    i = densities.index(0.25)
    gens = member_generators(torch.Generator().manual_seed(int(cfg.seed)), len(densities))
    single = fit(gens[i], args["mdef"], args["mcfg"], args["grid"], args["img"],
                 args["train_cfg"], args["optim_cfg"],
                 dataclasses.replace(args["masking"], density=0.25), device="cuda")
    model = np.load(dirs[i] / "model.npz")
    same = all(np.array_equal(model[f"layers.{j}.{k}"], v.cpu().numpy())
               for j, layer in enumerate(single.params) for k, v in layer.items())
    same &= all(np.array_equal(masks[i][j], m.cpu().numpy())
                for j, m in enumerate(single.mask_state.masks) if m is not None)
    default = json.loads(open(f"{default_run}/summary.json").read())
    default_steps = json.loads(open(f"{default_run}/config.json").read())["train"]["num_steps"]
    ms_single = single.wall_seconds / steps * 1e3
    ms_ladder = summaries[0]["fit_wall_s"] / steps * 1e3
    print(f"{tag} member d=0.25 {'has' if same else 'DOES NOT HAVE'} the bits of a single fit "
          f"with its generator (weights and masks). The ladder's fit over the member axis "
          f"{summaries[0]['fit_wall_s']:.3f} s = {ms_ladder:.3f} ms/step = "
          f"{ms_ladder / len(densities):.3f} ms per step per member; that single fit "
          f"{ms_single:.3f} ms/step, phase 5's {default['fit_wall_s'] / int(default_steps) * 1e3:.3f}"
          " ms/step", flush=True)
    if not same:
        raise AssertionError(f"{tag} member 0.25 differs from its single fit")

    sm.reset_launch_counts()
    images = decompress.decode_runs(dirs, device="cuda")
    decode_launches = dict(sm.LAUNCHES)
    alone = [np.asarray(decompress.decode_run(d, out_path=d / "single.png", device="cuda")[0])
             for d in dirs]
    decoded_same = all(np.array_equal(a, b) for a, b in zip(images, alone))
    print(f"{tag} decode_runs over the {len(dirs)} run dirs: launches {decode_launches}; each "
          f"image {'is' if decoded_same else 'IS NOT'} its decode_run's, bit for bit",
          flush=True)
    if decode_launches != {k: int(k == "sine_mlp_fwd_batched") for k in decode_launches}:
        raise AssertionError(f"{tag} decode_runs launched {decode_launches}")
    if not decoded_same:
        raise AssertionError(f"{tag} a decode_runs image differs from its decode_run")
    return launches


def phase_ladder_gmp() -> None:
    """14b: the GMP ladder (masking=Pruning over final densities) through the
    CLI with 14a's cut: each member's end density near its own target."""
    tag = "[14b GMP ladder]"
    cfg, densities, dirs, summaries, launches, seconds = _ladder_cli(
        "14b GMP", LADDER_RUNS["14b GMP"] + LADDER_CUT)
    steps, q = int(cfg.train.num_steps), int(cfg.quant.num_steps)
    print(f"{tag} cut as 14a, masking.end_when 1500 -> 150; {len(densities)} members in "
          f"{seconds:.2f} s; launches {launches}", flush=True)
    _check_ladder_launches(tag, launches, len(densities), steps, 2, q)
    _ladder_members("14b GMP", tag, dirs, summaries, densities, "final_density",
                    GMP_DENSITY_TOL)


def phase_batched_compress() -> None:
    """14c: batched_compress on BATCH_IMAGES seeded 512² synthetic images
    (RigL 0.5, k-means 8-bit, zstd): member 0's container the bytes of a
    B = 1 run with its generator."""
    import numpy as np
    import torch

    from implicit_image_tpu_torch.compress import _quant_config, compose, masking_config
    from implicit_image_tpu_torch.data import get_grid, synthetic_image
    from implicit_image_tpu_torch.models import build_model
    from implicit_image_tpu_torch.ops import sine_mlp as sm
    from implicit_image_tpu_torch.parallel import batched_compress
    from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig

    tag = "[14c batched_compress]"
    cfg = compose(["quant.num_steps=10"])
    mdef, mcfg = build_model("siren", depth=DEPTH, hidden_size=WIDTH)
    imgs = np.stack([synthetic_image(N_SIDE, N_SIDE, seed=s) for s in range(BATCH_IMAGES)])
    grid = get_grid(N_SIDE, N_SIDE, "cuda")
    kw = dict(masking_cfg=masking_config(cfg), quant_cfg=_quant_config(cfg.quant),
              stream_name="zstd", coding_kwargs={"level": 22})
    tc = TrainConfig(num_steps=BATCH_STEPS, log_steps=50)
    shutil.rmtree(P14 + "_batched", ignore_errors=True)
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    many = batched_compress(torch.Generator().manual_seed(0), mdef, mcfg, grid, imgs, tc,
                            OptimConfig(), stream_root=f"{P14}_batched/b{BATCH_IMAGES}", **kw)
    seconds = time.perf_counter() - t0
    launches = dict(sm.LAUNCHES)
    one = batched_compress(torch.Generator().manual_seed(0), mdef, mcfg, grid, imgs[:1], tc,
                           OptimConfig(), stream_root=f"{P14}_batched/b1", **kw)
    shas = [_sha256(Path(r.stream_dir) / "compressed_weights.data") for r in many + one]
    print(f"{tag} {BATCH_IMAGES} images, {BATCH_STEPS} + 10 steps in {seconds:.2f} s; launches "
          f"{launches}; decoded " + ", ".join(f"{r.decoded_psnr:.3f} dB @ {r.compressed_bytes} B"
                                             for r in many)
          + f"; member 0 sha256 {shas[0][:16]}, the B = 1 run's {shas[-1][:16]}", flush=True)
    if shas[0] != shas[-1]:
        raise AssertionError(f"{tag} member 0 differs from its B = 1 run")
    if launches["sine_mlp_bwd_batched"] != BATCH_STEPS + 10 or launches["sine_mlp_bwd"] or not all(
            math.isfinite(r.decoded_psnr) and r.decoded_psnr >= 20.0 for r in many):
        raise AssertionError(f"{tag} launches {launches} or a decoded PSNR below 20 dB")


def phase_wide_ladder(width: int, part: str) -> dict:
    """14d: a 2-member RigL ladder at w182 (kernel width 192: the
    member-axis width-192 backward, which sums its dW itself), 20 steps."""
    tag = f"[14{part} wide ladder]"
    argv = [a if not a.startswith("mlp.hidden_size=") else f"mlp.hidden_size={width}"
            for a in WIDE_LADDER]
    cfg, densities, dirs, summaries, launches, seconds = _ladder_cli(f"14{part} wide", argv)
    print(f"{tag} w{width}, {len(densities)} members in {seconds:.2f} s; launches "
          f"{launches}; decoded " + ", ".join(f"{s['Decoded PSNR']:.3f} dB" for s in summaries),
          flush=True)
    _check_ladder_launches(tag, launches, len(densities), 20, 2, 5)
    if not all(math.isfinite(s["Decoded PSNR"]) for s in summaries):
        raise AssertionError(f"{tag} a decoded PSNR is not finite")
    return launches


def phase_layer_ladder(part: str) -> dict:
    """14e / 14f: the 2-member RigL ladder of 14d at w256 / w640
    (LAYER_LADDER_WIDTHS): the member-axis layer-wise kernels, per fit and finetune step one K2 over the members
    (depth launches of sine_mlp_layer_bwd_batched, depth - 2 of
    sine_mlp_layer_dw_batched, one sum_partials_batched) from the z stash
    that K1 over the members filled, sine_mlp_layer_fwd(_batched) in K1
    only (`_layer_forwards`), no single K2, no fused kernel; decoded PSNRs
    finite. Returns the launch counts."""
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    tag, width = f"[14{part} layer ladder]", LAYER_LADDER_WIDTHS[part]
    argv = [a if not a.startswith("mlp.hidden_size=") else f"mlp.hidden_size={width}"
            for a in WIDE_LADDER]
    with _layer_forwards() as forwards:
        cfg, densities, dirs, summaries, launches, seconds = _ladder_cli(f"14{part} layer", argv)
    print(f"{tag} w{width}, {len(densities)} members in {seconds:.2f} s; K1 "
          f"{forwards['stash']} times with the stash, {forwards['plain']} without; launches "
          f"{launches}; decoded " + ", ".join(f"{s['Decoded PSNR']:.3f} dB" for s in summaries),
          flush=True)
    steps = 20 + 5
    want = {"sine_mlp_layer_bwd_batched": DEPTH * steps,
            "sine_mlp_layer_dw_batched": (DEPTH - 2) * steps,
            "sum_partials_batched": steps, "sine_mlp_layer_bwd": 0, "sine_mlp_layer_dw": 0,
            "sum_partials": 0, "sine_mlp_fwd": 0, "sine_mlp_bwd": 0, "sine_mlp_fwd_batched": 0,
            "sine_mlp_bwd_batched": 0, **forwards["launches"]}
    if ({k: launches[k] for k in want} != want or launches["sine_mlp_layer_fwd"] <= 0
            or launches["sine_mlp_layer_fwd_batched"] <= 0 or forwards["stash"] != steps):
        raise AssertionError(f"{tag} launches {launches}, expected {want}; "
                             f"{forwards['stash']} stashes for {steps} steps")
    if not all(math.isfinite(s["Decoded PSNR"]) for s in summaries):
        raise AssertionError(f"{tag} a decoded PSNR is not finite")
    return launches


def phase_parallel(default_run: str) -> dict:
    """Phase 14; returns the launches of the w128 (14a), w182 (14d), w256
    (14e) and w640 (14f) ladders by width."""
    rigl = phase_ladder_rigl(default_run)
    phase_ladder_gmp()
    phase_batched_compress()
    return {WIDTH: rigl, FINALS_WIDTH: phase_wide_ladder(FINALS_WIDTH, "d"),
            **{width: phase_layer_ladder(part) for part, width in LAYER_LADDER_WIDTHS.items()}}


def phase_run_tools(default_run: str) -> dict:
    """Phase 13: the compress and decode CLIs' run tools; returns 13e's
    batched launches per width."""
    phase_bit_alloc("[13a bit_alloc]", ALLOC_OVERRIDES, default_run)
    phase_bit_alloc("[13a bit_alloc finals]", ALLOC_FINALS_OVERRIDES,
                    compress_dir(FINALS_OVERRIDES))
    phase_progressive(default_run)
    phase_geometry(default_run)
    batched = phase_batched_decode()
    phase_profile()
    return batched


def compress_dir(overrides) -> str:
    return next(o.split("=", 1)[1] for o in overrides if o.startswith("output_dir="))


def phase_fit_options(dense_run: str, default_run: str) -> None:
    """Phase 12: the fit options and hashgrid, each through compress.main;
    phases 4 and 5's run dirs give their ms per step beside these."""
    def ms_step(run_dir: str) -> float:
        summary = json.loads(open(f"{run_dir}/summary.json").read())
        steps = json.loads(open(f"{run_dir}/config.json").read())["train"]["num_steps"]
        return summary["fit_wall_s"] / int(steps) * 1e3

    dense_ms_step = ms_step(dense_run)
    phase_schedule(ms_step(default_run))
    phase_mixed()
    phase_stop()
    phase_resume()
    phase_clip()
    phase_exact_sine(dense_ms_step)
    phase_coordx_bf16()
    phase_hashgrid()


def _p15(tag: str) -> dict:
    """One phase-15 run of P15_RUNS (its floor P15_FLOOR's)."""
    name = tag.strip("[]")
    out = f"{P15}_{name.split(' ', 1)[1].replace(' ', '_')}"
    return _p12_run(tag, P15_RUNS[name] + [f"output_dir={out}"], floors=P15_FLOOR)


def _load_run_params(run_dir: str, mcfg, device):
    """(params, masks or None) of a run dir's model.npz / mask.npz on device."""
    import numpy as np
    import torch

    model = np.load(f"{run_dir}/model.npz")
    n = len(mcfg.layer_dims)
    params = tuple({k: torch.from_numpy(model[f"layers.{i}.{k}"]).to(device) for k in ("w", "b")}
                   for i in range(n))
    if not Path(f"{run_dir}/mask.npz").is_file():
        return params, None
    mask = np.load(f"{run_dir}/mask.npz")
    return params, tuple(torch.from_numpy(mask[f"layers.{i}.mask"]).to(device)
                         if f"layers.{i}.mask" in mask.files else None for i in range(n))


def _phase_qat(tag: str, qscheme: str) -> None:
    """15a / 15b: QAT through compress.main and decode_run; the container's
    layout; the finetune repeated in this process from the run's fit params
    and masks, counting its launches (K1 and K2 run its STE steps): its codes
    and scales (or labels and codebook) are the container's bit for bit,
    pruned weights stay exactly 0, and the render of the container's rule
    from those codebooks is decode_run's image bit for bit."""
    import numpy as np
    import torch

    from implicit_image_tpu_torch import compress, decompress
    from implicit_image_tpu_torch.coding import decompress_state_dict, read_raw_container
    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model_from_config
    from implicit_image_tpu_torch.ops import sine_mlp as sm
    from implicit_image_tpu_torch.quant import quantized_layer_indices
    from implicit_image_tpu_torch.training.quant_phase import quant_finetune

    r = _p15(tag)
    cfg, run_dir = r["cfg"], r["run_dir"]
    _check_launches(r["launches"], f"{tag} path")
    mdef, mcfg = build_model_from_config(cfg)
    quant_cfg = compress._quant_config(cfg.quant)
    container = f"{run_dir}/model_quantized"
    raw = read_raw_container(container, "zstd")
    params, masks = _load_run_params(run_dir, mcfg, "cuda")
    qidx = quantized_layer_indices(params, quant_cfg)
    for i in qidx:
        lw = raw[f"layers.{i}.labeled_weight"]
        if qscheme == "per_channel":
            ok = (lw.dtype == np.int8 and f"layers.{i}.qscale" in raw
                  and raw[f"layers.{i}.qscale"].shape == (lw.shape[1],)
                  and f"layers.{i}.centroids" not in raw)
        else:
            ok = (lw.dtype == np.uint8 and raw[f"layers.{i}.centroids"].shape == (256,)
                  and f"layers.{i}.qscale" not in raw)
        if not ok:
            entries = {k: (v.dtype, v.shape) for k, v in raw.items()
                       if k.startswith(f"layers.{i}.")}
            raise AssertionError(f"{tag} layer {i}: container entries {entries}")
    img = compress._load_image(cfg.img)
    grid = get_grid(*img.shape[:2], "cuda")
    sm.reset_launch_counts()
    qres = quant_finetune(params, img, mdef, mcfg, grid, quant_cfg, compress._optim_config(cfg),
                          precision="fp32", masks=masks)
    launches = dict(sm.LAUNCHES)
    steps = quant_cfg.num_steps
    dec_params = []
    for i, (layer, book) in enumerate(zip(qres.params, qres.codebooks)):
        if book is None:
            dec_params.append(dict(layer))
            continue
        if qscheme == "per_channel":
            same = (np.array_equal(book.codes.cpu().numpy(), raw[f"layers.{i}.labeled_weight"])
                    and np.array_equal(book.scales.cpu().numpy().astype(np.float16),
                                       raw[f"layers.{i}.qscale"]))
            w = book.codes.float() * book.scales.half().float()[None, :]
        else:
            same = (np.array_equal(book.labels.cpu().numpy(), raw[f"layers.{i}.labeled_weight"])
                    and np.array_equal(book.centroids.cpu().numpy().astype(np.float16),
                                       raw[f"layers.{i}.centroids"]))
            w = book.centroids.half().float()[book.labels.long()]
        if not same:
            raise AssertionError(f"{tag} layer {i}: the repeated finetune's codebook is not "
                                 "the container's")
        dec_params.append({**layer, "w": w})
    with torch.no_grad():
        in_process = mdef.apply(tuple(dec_params), grid, mcfg, "fp32").cpu().numpy()
    decoded, _ = decompress.decode_run(run_dir, device="cuda")
    dec_state = decompress_state_dict(container, "zstd")
    zeros = 0
    if masks is not None:
        for i, m in enumerate(masks):
            if m is None:
                continue
            pruned = m.cpu().numpy() == 0
            zeros += int(pruned.sum())
            if (qres.params[i]["w"].cpu().numpy()[pruned].any()
                    or dec_state[f"layers.{i}.weight"][pruned].any()):
                raise AssertionError(f"{tag} layer {i}: a pruned weight is not 0 after QAT")
    print(f"{tag} {qscheme}: {len(qidx)} quantized layers; the finetune repeated in process: "
          f"quant PSNR {qres.metrics['quant_psnr']:.3f} dB (compress.main "
          f"{r['summary']['Quant PSNR']:.3f}), codebooks the container's, {zeros} pruned "
          f"weights 0; its launches {launches}; in-process render "
          f"{'==' if np.array_equal(in_process, decoded) else '!='} decode_run's", flush=True)
    if (launches["sine_mlp_bwd"] != steps or launches["sum_partials"] != steps
            or launches["sine_mlp_fwd"] != steps + 1):
        raise AssertionError(f"{tag} the QAT finetune's launches {launches}: expected K2 and "
                             f"sum_partials {steps}, K1 {steps + 1}")
    if qres.metrics["quant_psnr"] != r["summary"]["Quant PSNR"]:
        raise AssertionError(f"{tag} the QAT finetune does not repeat bit for bit")
    if not np.array_equal(in_process, decoded):
        raise AssertionError(f"{tag} decode_run's image is not the in-process render")


def _rigl_counts(tag: str, r: dict) -> None:
    import numpy as np

    from implicit_image_tpu_torch import compress

    cfg = r["cfg"]
    init = _initial_counts(cfg, compress.masking_config(cfg))
    masks = np.load(f"{r['run_dir']}/mask.npz")
    final = {int(k.split(".")[1]): int(masks[k].sum()) for k in masks.files}
    print(f"{tag} RigL counts init {init}, final {final}", flush=True)
    if final != init:
        raise AssertionError(f"{tag} RigL changed a layer's weight count")


def _wall_ms(fn, reps: int) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _shampoo_parts(cfg) -> dict:
    """ms of one Shampoo update on the d8/w128 SIREN's leaves (random grads)
    that refreshes every inverse root (update_freq 1: the batched eigh and
    the roots) and of one that reuses them, wall clock with the card
    synchronized, 20 updates each."""
    import torch

    from implicit_image_tpu_torch import compress
    from implicit_image_tpu_torch.models import build_model_from_config
    from implicit_image_tpu_torch.optim.shampoo import shampoo_init, shampoo_update

    mdef, mcfg = build_model_from_config(cfg)
    ocfg = compress._optim_config(cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, freq in (("refresh", 1), ("cached", 10**9)):
        params = mdef.init(torch.Generator().manual_seed(0), mcfg, "cuda")
        grads = tuple({k: torch.randn(v.shape, device="cuda", generator=g) * 1e-3
                       for k, v in layer.items()} for layer in params)
        state = shampoo_init(params, ocfg.epsilon)
        shampoo_update(grads, state, params, 1e-4, update_freq=freq)  # the first step refreshes

        def step():
            shampoo_update(grads, state, params, 1e-4, update_freq=freq)

        out[name] = _wall_ms(step, 20)
    return out


def _ekfac_parts(cfg, run_dir: str) -> dict:
    """ms of one EKFAC preconditioning of the run's fit params (capture, the
    moments, the KFE products) with the bases recomputed and without,
    wall clock with the card synchronized, 5 calls each."""
    import torch

    from implicit_image_tpu_torch import compress
    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model_from_config
    from implicit_image_tpu_torch.optim.ekfac import ekfac_init
    from implicit_image_tpu_torch.training.fit import EkfacFit

    mdef, mcfg = build_model_from_config(cfg)
    params, _ = _load_run_params(run_dir, mcfg, "cuda")
    img = compress._load_image(cfg.img)
    coords = get_grid(*img.shape[:2], "cuda").reshape(-1, 2)
    target = torch.as_tensor(img, device="cuda").reshape(-1, 3)
    grads = tuple({k: torch.ones_like(v) * 1e-3 for k, v in layer.items()} for layer in params)
    ek = EkfacFit(mdef, mcfg, coords, target, compress._optim_config(cfg), 1, ekfac_init(params))
    ek.precondition(0, params, grads)
    return {"recompute": _wall_ms(lambda: ek.precondition(0, params, grads), 5),
            "moments only": _wall_ms(lambda: ek.precondition(1, params, grads), 5)}


def phase_optimizers(default_ms_step: float) -> None:
    """15c-e: Shampoo and EKFAC through compress.main, their ms per step
    beside phase 5's Adam step, the eigh share; the chunked capture; an EKFAC
    resume of the same bits as the straight run."""
    tag = "[15c shampoo]"
    r = _p15(tag)
    _check_launches(r["launches"], f"{tag} path")
    _rigl_counts(tag, r)
    parts = _shampoo_parts(r["cfg"])
    print(f"{tag} fit {r['ms_step']:.3f} ms/step against phase 5's Adam {default_ms_step:.3f}; "
          f"one Shampoo update refreshing its inverse roots (batched eigh) "
          f"{parts['refresh']:.3f} ms, reusing them {parts['cached']:.3f} ms: the eigh and "
          f"roots {parts['refresh'] - parts['cached']:.3f} ms of each step", flush=True)

    tag = "[15d ekfac]"
    r = _p15(tag)
    _check_launches(r["launches"], f"{tag} path")
    _rigl_counts(tag, r)
    parts = _ekfac_parts(r["cfg"], r["run_dir"])
    print(f"{tag} fit {r['ms_step']:.3f} ms/step against phase 5's Adam {default_ms_step:.3f}; "
          f"one preconditioning (the capture at 512², the moments, the KFE products) "
          f"recomputing the bases {parts['recompute']:.3f} ms, without "
          f"{parts['moments only']:.3f} ms (a recompute every 10 steps)", flush=True)
    c = _p15("[15d ekfac chunks]")
    _check_launches(c["launches"], "[15d ekfac chunks] path")

    tag = "[15e ekfac resume]"
    half = _p12_run("[15e first 100]", EKFAC_RESUME + [
        "train.num_steps=100", "train.checkpoint=true", f"output_dir={P15}_resume_half"])
    rest = _p12_run("[15e resumed]", EKFAC_RESUME + [
        "train.num_steps=200", f"train.resume={half['run_dir']}/checkpoint.npz",
        f"output_dir={P15}_resume_rest"])
    shas = {name: (_sha256(f"{x['run_dir']}/model.npz"), _sha256(f"{x['run_dir']}/mask.npz"))
            for name, x in (("straight", r), ("resumed", rest))}
    print(f"{tag} sha256 of model.npz / mask.npz: straight 200 (15d) {shas['straight'][0][:16]} "
          f"/ {shas['straight'][1][:16]}, resumed at 100 {shas['resumed'][0][:16]} / "
          f"{shas['resumed'][1][:16]}", flush=True)
    if shas["straight"] != shas["resumed"]:
        raise AssertionError(f"{tag} the resumed EKFAC fit's params differ from the straight "
                             "run's")


def phase_precision_families() -> None:
    """15f: Fourier at bfloat16 (no kernel) and Feathermap under the
    precision schedule (its base SIREN's K1/K2 in the bf16 mode for the
    planned steps, fp32 after)."""
    f = _p15("[15f fourier bf16]")
    if any(f["launches"].values()):
        raise AssertionError(f"[15f fourier bf16] a kernel launched: {f['launches']}")
    r = _p15("[15f feathermap schedule]")
    n = int(r["cfg"].train.num_steps)
    expect = _expected_modes(n, int(round(n * 0.75)), int(r["cfg"].train.log_steps), 0, 0)
    got = {k: r["by_mode"][k] for k in expect}
    print(f"[15f feathermap schedule] launches by mode {got}, planned {expect}", flush=True)
    if got != expect:
        raise AssertionError(f"[15f feathermap schedule] the launches do not follow the plan")


def phase_last_options(default_run: str) -> None:
    """Phase 15: QAT, Shampoo, EKFAC, Fourier and Feathermap beyond fp32."""
    summary = json.loads(open(f"{default_run}/summary.json").read())
    steps = json.loads(open(f"{default_run}/config.json").read())["train"]["num_steps"]
    _phase_qat("[15a qat]", "per_channel")
    _phase_qat("[15b qat per_tensor]", "per_tensor")
    phase_optimizers(summary["fit_wall_s"] / int(steps) * 1e3)
    phase_precision_families()


def _member_ms(wall_s: float, steps: int, members: int) -> str:
    return f"{wall_s:.3f} s = {wall_s / steps * 1e3 / members:.3f} ms per step per member"


def _yardsticks(default_run: str) -> str:
    """Phase 5's single fit and phase 14a's ladder, in ms per step (per
    member), for the lines of phase 16."""
    single = json.loads(open(f"{default_run}/summary.json").read())
    steps = int(json.loads(open(f"{default_run}/config.json").read())["train"]["num_steps"])
    ladder = json.loads((Path(f"{P14}_14a") / "synthetic" / "ladder_RigL_smoke" / "d0.05"
                         / "summary.json").read_text())
    return (f"phase 5's single fit {single['fit_wall_s'] / steps * 1e3:.3f} ms/step, phase 14a's "
            f"ladder {ladder['fit_wall_s'] / 200 * 1e3 / ladder['members']:.3f}")


def _psnr_db(img, target) -> float:
    """decoded PSNR as the pipeline and compress.main compute it."""
    import numpy as np

    mse = float(np.mean((np.asarray(img, np.float64) - np.asarray(target, np.float64)) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def phase_fleet(yardsticks: str) -> None:
    """16a: the fleet CLI's run (fleet.run, in process) on the Makefile's
    three images: one batched K1 per fit step and eval and one batched K2
    per step (the single K2 launches the members' finetune steps exactly);
    each member's run dir decodes through decode_run to its reported PSNR
    bit for bit; decode_runs over the three dirs in one batched K1 launch."""
    from implicit_image_tpu_torch import compress, decompress, fleet
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    tag = "[16a fleet]"
    cfg = compress.compose(FLEET_ARGV)
    root = Path(cfg.output_dir) / "fleet_smoke"
    shutil.rmtree(root, ignore_errors=True)
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    rows = fleet.run(FLEET_ARGV)
    seconds = time.perf_counter() - t0
    launches = dict(sm.LAUNCHES)
    steps, q = int(cfg.train.num_steps), int(cfg.quant.num_steps)
    _check_ladder_launches(tag, launches, len(rows), steps, 2, q)
    base = [a for a in FLEET_ARGV if not a.startswith("fleet.")]
    dirs = []
    for name, psnr, nbytes in rows:
        run_dir = root / name
        dirs.append(run_dir)
        target = compress._load_image(compress.compose(base + fleet._member_overrides(name)[0]).img)
        img, _ = decompress.decode_run(run_dir, device="cuda")
        again = _psnr_db(img, target)
        summary = json.loads((run_dir / "summary.json").read_text())
        print(f"{tag} {name}: fit {summary['PSNR']:.3f} dB, decoded {psnr:.3f} dB @ {nbytes} B; "
              f"decode_run {again:.6f} dB", flush=True)
        if again != psnr or not (math.isfinite(psnr) and psnr >= 20.0):
            raise AssertionError(f"{tag} {name}: decode_run gives {again} dB, the fleet reported "
                                 f"{psnr} (floor 20 dB)")
    sm.reset_launch_counts()
    decompress.decode_runs(dirs, device="cuda")
    decode_launches = dict(sm.LAUNCHES)
    if decode_launches != {k: int(k == "sine_mlp_fwd_batched") for k in decode_launches}:
        raise AssertionError(f"{tag} decode_runs launched {decode_launches}")
    print(f"{tag} {len(rows)} images in {seconds:.2f} s; the fit over the member axis "
          f"{_member_ms(summary['fit_wall_s'], steps, len(rows))} ({yardsticks}); launches "
          f"{launches}; decode_runs {decode_launches}", flush=True)


def phase_api() -> None:
    """16b: compress_image of the synthetic stand-in as an array against
    compress.main with img=synthetic (bytes, decoded PSNR and the bitstream
    equal); its .iic (save) decodes to the run dir's image bit for bit;
    compress_images of two more images over the member axis."""
    import numpy as np

    import implicit_image_tpu_torch as iit
    from implicit_image_tpu_torch import compress
    from implicit_image_tpu_torch.data import synthetic_image
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    tag = "[16b api]"
    cfg = compress.compose(["img=synthetic", *API_OVERRIDES, f"output_dir={P16}_main"])
    shutil.rmtree(cfg.output_dir, ignore_errors=True)
    shutil.rmtree(f"{P16}_api", ignore_errors=True)
    ref = compress.main(cfg, run_dir=cfg.output_dir)
    img = compress._load_image(cfg.img)
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    res = iit.compress_image(img, overrides=API_OVERRIDES, out_dir=f"{P16}_api/run")
    seconds = time.perf_counter() - t0
    launches = dict(sm.LAUNCHES)
    _check_launches(launches, f"{tag} compress_image")
    same_stream = res.bitstream == (Path(cfg.output_dir) / "model_quantized"
                                    / "compressed_weights.data").read_bytes()
    packed = res.save(f"{P16}_api/run.iic")
    from_iic = iit.decompress_image(packed)
    same_iic = np.array_equal(from_iic, res.decode())
    print(f"{tag} compress_image {seconds:.2f} s: {res.psnr:.6f} dB @ {res.nbytes} B; "
          f"compress.main img=synthetic {ref[0]:.6f} dB @ {ref[1]} B; bitstreams "
          f"{'equal' if same_stream else 'DIFFER'}; {packed.name} ({packed.stat().st_size} B) "
          f"decodes {'==' if same_iic else '!='} the run dir's image; launches {launches}",
          flush=True)
    if (res.psnr, res.nbytes) != ref or not same_stream or not same_iic:
        raise AssertionError(f"{tag} the API's run is not compress.main's")

    imgs = [synthetic_image(N_SIDE, N_SIDE, seed=s) for s in API_BATCH_SEEDS]
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    many = iit.compress_images(imgs, overrides=[f"train.num_steps={API_BATCH_STEPS}",
                                                "train.log_steps=50", "quant.num_steps=10",
                                                "entropy_coding=plain"],
                               out_dir=f"{P16}_api/fleet")
    seconds = time.perf_counter() - t0
    launches = dict(sm.LAUNCHES)
    _check_ladder_launches(f"{tag} compress_images", launches, len(imgs), API_BATCH_STEPS, 2, 10)
    dbs = [_psnr_db(r.decode(), src) for r, src in zip(many, imgs)]
    summary = json.loads((many[0].run_dir / "summary.json").read_text())
    print(f"{tag} compress_images of {len(imgs)} in {seconds:.2f} s (fit "
          f"{_member_ms(summary['fit_wall_s'], API_BATCH_STEPS, len(imgs))}): "
          + ", ".join(f"{r.psnr:.3f} dB (decode {d:.3f}) @ {r.nbytes} B"
                      for r, d in zip(many, dbs)) + f"; launches {launches}", flush=True)
    if [r.psnr for r in many] != dbs or not all(d >= 20.0 for d in dbs):
        raise AssertionError(f"{tag} compress_images: decoded {dbs}, reported "
                             f"{[r.psnr for r in many]} (floor 20 dB)")


def phase_target() -> None:
    """16c: compress_to_target(target.bytes=60000) with a ladder of 5 and
    one refinement: one batched K2 per fit step and ladder; the probes
    printed; when met, the chosen member's bytes within the budget and its
    stream decoding to its reported PSNR."""
    from implicit_image_tpu_torch import compress, target
    from implicit_image_tpu_torch.coding import decode_and_render
    from implicit_image_tpu_torch.models import build_model_from_config
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    tag = "[16c target]"
    cfg = compress.compose(TARGET_OVERRIDES)
    root = f"{P16}_target"
    shutil.rmtree(root, ignore_errors=True)
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    res = target.compress_to_target(cfg, target_bytes=TARGET_BYTES, ladder_size=TARGET_LADDER,
                                    refine=TARGET_REFINE, out_root=root)
    seconds = time.perf_counter() - t0
    launches = dict(sm.LAUNCHES)
    probes = res["probes"]
    ladders = 1 + (len(probes) > TARGET_LADDER)
    steps = int(cfg.train.num_steps)
    for p in probes:
        print(f"{tag} probe d={p['density']}: decoded {p['decoded_psnr']:.3f} dB @ "
              f"{p['bytes']} B", flush=True)
    print(f"{tag} chose d={res.density}: {res.decoded_psnr:.3f} dB @ {res.compressed_bytes} B, "
          f"target {TARGET_BYTES} B {'met' if res.target_met else 'MISSED'}; {ladders} ladders "
          f"of {len(probes)} members in {seconds:.2f} s = "
          f"{seconds / steps * 1e3 / len(probes):.3f} ms per fit step per member, finetunes and "
          f"containers included; launches {launches}", flush=True)
    if (launches["sine_mlp_bwd_batched"] != ladders * (steps + int(cfg.quant.num_steps))
            or launches["sine_mlp_bwd"]):
        raise AssertionError(f"{tag} launches {launches} for {ladders} ladders")
    if res.target_met:
        mdef, mcfg = build_model_from_config(cfg)
        img, _ = decode_and_render(f"{res.stream_dir}/model_quantized", "zstd", mdef, mcfg,
                                   N_SIDE, N_SIDE, device="cuda", precision="fp32")
        again = _psnr_db(img, compress._load_image(cfg.img))
        if res.compressed_bytes > TARGET_BYTES or again != res.decoded_psnr:
            raise AssertionError(f"{tag} the chosen member: {res.compressed_bytes} B, decodes "
                                 f"{again} dB against {res.decoded_psnr}")


def _sweep(argv) -> tuple:
    """sweep.cli in process from the launch counts 0: (trials, launches,
    seconds)."""
    from implicit_image_tpu_torch import sweep
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    sm.reset_launch_counts()
    t0 = time.perf_counter()
    sweep.cli(argv)
    seconds = time.perf_counter() - t0
    trials = json.loads(Path("outputs/sweep_results.json").read_text())["trials"]
    return trials, dict(sm.LAUNCHES), seconds


def phase_sweep() -> None:
    """16d: a density sweep of 8 trials in rounds of 4 (two ladders: one
    batched K2 per fit step each), relaunched with the same arguments:
    every trial replayed from the store, no kernel launch; then 2 serial
    trials over optim.lr through compress.main."""
    tag = "[16d sweep]"
    for d in (f"{P16}_sweep", f"{P16}_sweep_runs", f"{P16}_serial", f"{P16}_serial_runs"):
        shutil.rmtree(d, ignore_errors=True)
    trials, launches, seconds = _sweep(SWEEP_ARGV)
    steps = 100
    for t in trials:
        print(f"{tag} trial {t['trial']}: density {float(t['values']['masking.density']):.4f}, "
              f"{t['psnr']:.3f} dB @ {t['bytes']} B", flush=True)
    print(f"{tag} {len(trials)} trials in {seconds:.2f} s = "
          f"{seconds / steps * 1e3 / len(trials):.3f} ms per fit step per trial, finetunes and "
          f"containers included; launches {launches}", flush=True)
    if launches["sine_mlp_bwd_batched"] != 2 * (steps + 10) or len(trials) != 8:
        raise AssertionError(f"{tag} {len(trials)} trials, launches {launches}: expected two "
                             "ladders")
    if not all(math.isfinite(t["psnr"]) and t["psnr"] >= 12.0 for t in trials):
        raise AssertionError(f"{tag} a trial's PSNR is below 12 dB")
    again, relaunched, seconds = _sweep(SWEEP_ARGV)
    print(f"{tag} relaunched: {len(again)} trials replayed in {seconds:.2f} s, launches "
          f"{relaunched}", flush=True)
    if again != trials or any(relaunched.values()):
        raise AssertionError(f"{tag} the relaunch did not replay the store: {relaunched}")
    serial, launches, seconds = _sweep(SERIAL_SWEEP_ARGV)
    print(f"{tag} serial: " + ", ".join(f"lr {float(t['values']['optim.lr']):.3g}: "
                                        f"{t['psnr']:.3f} dB" for t in serial)
          + f" in {seconds:.2f} s; launches {launches}", flush=True)
    _check_launches(launches, f"{tag} serial trials")
    if len(serial) != 2 or launches["sine_mlp_bwd"] != 2 * (steps + 10):
        raise AssertionError(f"{tag} serial: {len(serial)} trials, launches {launches}")


def _meta(argv) -> tuple:
    """meta_train.run in process from the launch counts 0: (cfg, artifact,
    launches, seconds)."""
    from implicit_image_tpu_torch import compress, meta_train
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    cfg = compress.compose(list(argv))
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    out = meta_train.run(cfg)
    return cfg, out, dict(sm.LAUNCHES), time.perf_counter() - t0


def phase_meta(yardsticks: str, cold_run: str) -> None:
    """16e: REPTILE meta-training of SIREN d8/w128 (one batched K1 and K2
    per inner step, one more batched K1 per meta-step for the post-adaptation
    loss, no single launch); a 200-step fit from the artifact starts from its
    weights (its first loss is the artifact's own, bit for bit); CoordX
    s5/w96 meta-training launches no SIREN kernel."""
    import torch

    from implicit_image_tpu_torch import compress
    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model_from_config
    from implicit_image_tpu_torch.ops.metrics import mse
    from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit, forward_flat

    tag = "[16e meta_train]"
    cfg, art, launches, seconds = _meta(META_SIREN_ARGV)
    inner, outer, batch = (int(cfg.meta[k]) for k in ("inner_steps", "outer_steps",
                                                      "meta_batch"))
    want = {k: 0 for k in launches}
    want.update(sine_mlp_fwd_batched=outer * (inner + 1), sine_mlp_bwd_batched=outer * inner,
                sum_partials_batched=outer * inner)
    print(f"{tag} SIREN d{DEPTH}/w{WIDTH} at {N_SIDE}², pool 8, {outer} meta-steps x {inner} "
          f"inner x {batch} images: {_member_ms(seconds, outer * inner, batch)} ({yardsticks}); "
          f"launches {launches}", flush=True)
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")

    mdef, mcfg = build_model_from_config(cfg)
    # train.init_path as compress.main reads it
    params, _ = compress._warm_start(compress.compose(META_SIREN_ARGV + [f"train.init_path={art}"]),
                                     mdef, mcfg, WARM_STEPS, "cuda")
    img = compress._load_image(cfg.img)
    grid = get_grid(N_SIDE, N_SIDE, "cuda")
    coords = grid.reshape(-1, 2)
    target = torch.as_tensor(img, device="cuda").reshape(-1, 3)
    with torch.no_grad():
        own = float(mse(forward_flat(mdef, mcfg, params, coords, (N_SIDE, N_SIDE), "fp32"),
                        target))
    res = fit(torch.Generator().manual_seed(0), mdef, mcfg, grid, img,
              TrainConfig(num_steps=WARM_STEPS, log_steps=100), OptimConfig(),
              init_params=params, device="cuda")
    cold = json.loads(open(f"{cold_run}/summary.json").read())["PSNR"]
    print(f"{tag} a {WARM_STEPS}-step dense fit from train.init_path={art}: first loss "
          f"{float(res.metrics['loss'][0])!r}, the artifact's own {own!r}; fit PSNR "
          f"{res.metrics['psnr'][-1]:.3f} dB (phase 4's "
          f"cold dense fit {cold:.3f} dB)", flush=True)
    if float(res.metrics["loss"][0]) != own:
        raise AssertionError(f"{tag} the warm fit does not start from the artifact's weights")

    cfg, art, launches, seconds = _meta(META_COORDX_ARGV)
    outer = int(cfg.meta.outer_steps)
    print(f"{tag} CoordX s5/w96, {outer} meta-steps: {_member_ms(seconds, outer * inner, batch)};"
          f" SIREN launches {launches}", flush=True)
    if any(launches.values()):
        raise AssertionError(f"{tag} CoordX meta-training launched a SIREN kernel: {launches}")


def phase_tools(default_run: str, cold_run: str) -> None:
    """Phase 16: the fleet CLI, the API, compress-to-target, the sweeper and
    meta-training, each part's wall beside phase 5's single fit and phase
    14a's ladder."""
    yardsticks = _yardsticks(default_run)
    for part, fn in (("a", lambda: phase_fleet(yardsticks)), ("b", phase_api),
                     ("c", phase_target), ("d", phase_sweep),
                     ("e", lambda: phase_meta(yardsticks, cold_run))):
        t0 = time.perf_counter()
        fn()
        print(f"[16{part}] wall {time.perf_counter() - t0:.2f} s", flush=True)

def _encode_sequence(tag: str, argv) -> dict:
    """sequence.encode_sequence in process from the launch counts 0, each
    I- and P-frame's launches (its fit, finetune, container and decode;
    the render after it adds one K1) read around the frame coder's calls:
    {rows, renders, root, launches, frames: [(kind, launches)], seconds}."""
    from implicit_image_tpu_torch import compress, sequence
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    cfg = compress.compose(list(argv))
    root = Path(cfg.output_dir) / f"seq_{cfg.sequence.video}"
    shutil.rmtree(cfg.output_dir, ignore_errors=True)
    frames = []
    coder = sequence._FrameCoder
    methods = {"I": coder.iframe, "P": coder.pframe}

    masks = {}  # each frame's fit masks (the last call's for a fallback frame)

    def counted(kind):
        def call(self, *a, **k):
            before = dict(sm.LAUNCHES)
            out = methods[kind](self, *a, **k)
            frames.append((kind, {n: sm.LAUNCHES[n] - before[n] for n in before}))
            if out.fit.mask_state is not None:
                masks[out.dir.name] = [None if m is None else m.cpu().numpy()
                                       for m in out.fit.mask_state.masks]
            return out

        return call

    renders = {}
    coder.iframe, coder.pframe = counted("I"), counted("P")
    try:
        sm.reset_launch_counts()
        t0 = time.perf_counter()
        rows = sequence.encode_sequence(argv, device="cuda", renders=renders)
        seconds = time.perf_counter() - t0
        launches = dict(sm.LAUNCHES)
    finally:
        coder.iframe, coder.pframe = methods["I"], methods["P"]
    summary = json.loads((root / "seq_summary.json").read_text())
    print(f"{tag} {len(rows)} frames in {seconds:.2f} s: {summary['bytes_per_frame']} B per "
          f"frame, mean decoded {summary['mean_decoded_psnr']} dB; launches {launches}",
          flush=True)
    return dict(rows=rows, renders=renders, root=root, launches=launches, frames=frames,
                seconds=seconds, masks=masks)


def _frame_launches(tag: str, frames) -> None:
    """Print the K1 / K2 / sum_partials launches of each kind of frame (each
    call of the frame coder; a max_drop fallback is a P call then an I)."""
    for kind in ("I", "P"):
        seen = sorted({tuple(d[n] for n in ("sine_mlp_fwd", "sine_mlp_bwd", "sum_partials"))
                       for k, d in frames if k == kind})
        if seen:
            print(f"{tag} per {kind}-frame K1 / K2 / sum_partials: "
                  + ", ".join(" / ".join(map(str, c)) for c in seen), flush=True)


def _decode_rate(frame_s) -> float:
    """Frames per second of decode_sequence after its first frame (host
    entropy decode, upload, render and copy back)."""
    return (len(frame_s) - 1) / sum(frame_s[1:])


def _frozen_topology(tag: str, root: Path, names, masks) -> list:
    """Each P-frame's fit masks are its resume masks, the previous frame's
    decoded nonzeros, and a masked-in weight decodes to 0 only where its
    residual centroid cancels its offset exactly ((offset + c) == 0 in fp32,
    both fp16 values): the codec's own rule, the JAX package's too. Returns
    each frame's nonzero weights per layer and the cancellations per
    P-frame."""
    import numpy as np

    from implicit_image_tpu_torch.coding import decompress_state_dict, read_raw_container

    counts, cancelled, prev = [], [], None
    for name in names:
        path = root / name / "model_quantized"
        state = decompress_state_dict(path, "auto", prev_state=prev)
        meta = json.loads((path / "meta_data.json").read_text())["__meta__"]
        if "prev" in meta.get("delta", {}):
            raw = read_raw_container(path, "auto")
            n = 0
            for i, mask in enumerate(masks[name]):
                if mask is None:
                    continue
                w_prev, w = prev[f"layers.{i}.weight"], state[f"layers.{i}.weight"]
                if not np.array_equal(mask != 0, w_prev != 0):
                    raise AssertionError(f"{tag} {name} layer {i}: the fit's masks are not the "
                                         "previous frame's decoded nonzeros")
                lost = (mask != 0) & (w == 0)
                labels = raw.get(f"layers.{i}.labeled_weight")
                if lost.any():
                    cents = raw[f"layers.{i}.centroids"].astype(np.float32)[labels]
                    if not ((labels[lost] != 0) & (cents[lost] + w_prev[lost] == 0)).all():
                        raise AssertionError(f"{tag} {name} layer {i}: a masked-in weight "
                                             "decodes to 0 without an exact cancellation")
                if ((mask == 0) & (w != 0)).any():
                    raise AssertionError(f"{tag} {name} layer {i}: a pruned weight decodes "
                                         "nonzero")
                n += int(lost.sum())
            cancelled.append(n)
        counts.append([int(np.count_nonzero(v)) for k, v in state.items()
                       if k.endswith(".weight")])
        prev = state
    return counts, cancelled


def phase_sequence_default() -> dict:
    """17a: the Makefile's sequence target: every frame but frame 0 a
    P-frame, each decoding >= 20 dB; RigL's topology frozen in every P-fit
    (_frozen_topology); decode_sequence of the dir gives each frame the encode
    side's render bit for bit. Returns the encode's launches."""
    import numpy as np

    from implicit_image_tpu_torch import sequence
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    tag = "[17a sequence]"
    run = _encode_sequence(tag, SEQ_ARGV + [f"sequence.frames={SEQ_FRAMES}",
                                            f"output_dir={P17}_a"])
    rows = run["rows"]
    for r in rows:
        print(f"{tag} {json.dumps(r)}", flush=True)
    _frame_launches(tag, run["frames"])
    _check_launches(run["launches"], f"{tag} encode")
    kinds = [r["kind"] for r in rows]
    if kinds != ["I"] + ["P"] * (SEQ_FRAMES - 1):
        raise AssertionError(f"{tag} kinds {kinds}: a P-frame fell back to an I-frame")
    if not all(math.isfinite(r["decoded_psnr"]) and r["decoded_psnr"] >= SEQ_FLOOR
               for r in rows):
        raise AssertionError(f"{tag} a frame decodes below {SEQ_FLOOR} dB")
    stats = {}
    sm.reset_launch_counts()
    frames, names = sequence.decode_sequence(run["root"], device="cuda", stats=stats)
    decode_launches = dict(sm.LAUNCHES)
    same = [bool(np.array_equal(frames[t], run["renders"][n])) for t, n in enumerate(names)]
    counts, cancelled = _frozen_topology(tag, run["root"], names, run["masks"])
    print(f"{tag} decode_sequence: {_decode_rate(stats['frame_s']):.1f} frames/s after the "
          f"first; each frame the encode side's render: {same}; launches {decode_launches}; "
          f"nonzero weights per layer, I-frame {counts[0]}, last P-frame {counts[-1]}; each "
          f"P-fit's masks its resume masks; masked-in weights decoding to 0 by an exact "
          f"offset + centroid cancellation, per P-frame: {cancelled}", flush=True)
    if not all(same):
        raise AssertionError(f"{tag} decode_sequence differs from the encode side's renders")
    if decode_launches["sine_mlp_fwd"] != SEQ_FRAMES or decode_launches["sine_mlp_bwd"]:
        raise AssertionError(f"{tag} decode launches {decode_launches}")
    return run["launches"]


def phase_sequence_gop() -> None:
    """17b: an I-frame every 4: frames 0 and 4 are I; the seq dir packed
    (the CLI's pack), decoded from the .iiv, and a seek to frame 6 that
    equals the full decode's frame bit for bit and extracts frames 4-6
    only."""
    import numpy as np

    from implicit_image_tpu_torch import sequence
    from implicit_image_tpu_torch.coding import container_file

    tag = "[17b gop]"
    run = _encode_sequence(tag, SEQ_ARGV + [f"sequence.frames={SEQ_FRAMES}",
                                            f"sequence.gop={SEQ_GOP}", f"output_dir={P17}_b"])
    _frame_launches(tag, run["frames"])
    kinds = [r["kind"] for r in run["rows"]]
    want = ["I" if t % SEQ_GOP == 0 else "P" for t in range(SEQ_FRAMES)]
    print(f"{tag} kinds {kinds}; decoded dB {[r['decoded_psnr'] for r in run['rows']]}",
          flush=True)
    if kinds != want:
        raise AssertionError(f"{tag} kinds {kinds}, expected {want}")
    root = run["root"]
    sequence.cli(["pack", str(root)])
    iiv = root.with_suffix(".iiv")
    payloads = sum((root / r["frame"] / "model_quantized" / "compressed_weights.data")
                   .stat().st_size for r in run["rows"])
    stats = {}
    frames, names = sequence.decode_sequence(iiv, device="cuda", stats=stats)
    same = all(np.array_equal(frames[t], run["renders"][n]) for t, n in enumerate(names))
    seen = []
    real = container_file.unpack_sequence

    def spy(path, dest=None, frames=None):
        out = real(path, dest, frames=frames)
        seen.append(sorted(d.name for d in out.iterdir() if d.is_dir()))
        return out

    container_file.unpack_sequence = spy
    try:
        t0 = time.perf_counter()
        img, name = sequence.decode_sequence(iiv, frame=SEQ_SEEK, device="cuda")
        seek_s = time.perf_counter() - t0
    finally:
        container_file.unpack_sequence = real
    chain = [f"frame_{t:04d}" for t in range(SEQ_SEEK // SEQ_GOP * SEQ_GOP, SEQ_SEEK + 1)]
    print(f"{tag} {iiv.name} {iiv.stat().st_size} B against {payloads} B of frame payloads; "
          f"decoded from the file at {_decode_rate(stats['frame_s']):.1f} frames/s after the "
          f"first, each frame the encode side's render: {same}; seek to frame {SEQ_SEEK} "
          f"({name}) in {seek_s:.3f} s extracted {seen[-1]}, "
          f"{'==' if np.array_equal(img, frames[SEQ_SEEK]) else '!='} the full decode's",
          flush=True)
    if not same or not np.array_equal(img, frames[SEQ_SEEK]) or seen != [chain]:
        raise AssertionError(f"{tag} the .iiv decode or the seek is wrong (extracted {seen})")


def phase_sequence_scenecut() -> None:
    """17c: at motion 0.5 and 2 P steps, a P attempt falls back to an
    I-frame under the default 3 dB guard; with max_drop=none none does."""
    tag = "[17c scene cut]"
    base = SEQ_ARGV + SCENECUT_ARGV
    guarded = _encode_sequence(f"{tag} max_drop=3", base + [f"output_dir={P17}_c"])
    free = _encode_sequence(f"{tag} max_drop=none",
                            base + ["sequence.max_drop=none", f"output_dir={P17}_c_none"])
    for what, run in (("max_drop=3", guarded), ("max_drop=none", free)):
        print(f"{tag} {what}: " + ", ".join(f"{r['kind']} {r['decoded_psnr']} dB @ {r['bytes']} B"
                                            for r in run["rows"])
              + f"; coder calls {[k for k, _ in run['frames']]}", flush=True)
    if [r["kind"] for r in guarded["rows"]][1:].count("I") < 1:
        raise AssertionError(f"{tag} no P attempt fell back to an I-frame")
    if [r["kind"] for r in free["rows"]] != ["I", "P", "P"]:
        raise AssertionError(f"{tag} max_drop=none still fell back")


def phase_sequence_stop() -> None:
    """17d: sequence.stop_at_psnr at a target the warm start meets: every
    P-frame stops at the first check (25 of 50 steps), and its K2 launches
    are its steps plus the finetune's."""
    tag = "[17d stop_at_psnr]"
    run = _encode_sequence(tag, SEQ_ARGV + ["sequence.frames=3",
                                            f"sequence.stop_at_psnr={SEQ_STOP_DB}",
                                            f"output_dir={P17}_d"])
    _frame_launches(tag, run["frames"])
    rows = run["rows"]
    print(f"{tag} steps {[r['steps'] for r in rows]}; decoded dB "
          f"{[r['decoded_psnr'] for r in rows]}", flush=True)
    for r, (_, d) in zip(rows[1:], run["frames"][1:]):
        if (r["kind"] != "P" or r["steps"] >= SEQ_STEPS_P
                or d["sine_mlp_bwd"] != r["steps"] + SEQ_QUANT):
            raise AssertionError(f"{tag} {r}: launches {d}")


def phase_sequence_coordx() -> None:
    """17e: benchmarks/sequence_decode.py's CoordX sequence: no SIREN kernel
    launches; its decode rate."""
    from implicit_image_tpu_torch import sequence
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    tag = "[17e coordx]"
    run = _encode_sequence(tag, SEQDEC_ARGV + [f"output_dir={P17}_e"])
    print(f"{tag} " + ", ".join(f"{r['kind']} {r['decoded_psnr']} dB @ {r['bytes']} B "
                                f"{r['wall_s']} s" for r in run["rows"]), flush=True)
    stats = {}
    sm.reset_launch_counts()
    frames, names = sequence.decode_sequence(run["root"], device="cuda", stats=stats)
    print(f"{tag} decode_sequence {_decode_rate(stats['frame_s']):.1f} frames/s after the first; "
          f"SIREN launches {dict(sm.LAUNCHES)}", flush=True)
    if any(run["launches"].values()) or any(sm.LAUNCHES.values()):
        raise AssertionError(f"{tag} CoordX launched a SIREN kernel: {run['launches']}")
    if not all(math.isfinite(r["decoded_psnr"]) for r in run["rows"]) or len(frames) != 8:
        raise AssertionError(f"{tag} rows {run['rows']}")


def phase_sequences() -> dict:
    """Phase 17: the port's sequence path; returns 17a's launches."""
    launches = {}

    def default():
        launches.update(phase_sequence_default())

    for part, fn in (("a", default), ("b", phase_sequence_gop), ("c", phase_sequence_scenecut),
                     ("d", phase_sequence_stop), ("e", phase_sequence_coordx)):
        t0 = time.perf_counter()
        fn()
        print(f"[17{part}] wall {time.perf_counter() - t0:.2f} s", flush=True)
    return launches


# phase 18: the member axis beyond the fused SIREN at full width.
# (a) bench.py's batched arm (SIREN d8/w128, 64 x 256², pixel_chunks=8, the
# bf16 -> fp32 schedule at 0.75), 2,000 steps cut to 200; (b)
# benchmarks/batched_flagship.py (CoordX s5/w96, RigL 0.85, B = 8 at 512²,
# k-means 8-bit, huffman), 1,200 + 100 steps cut to 200 + 20; (c) a 5-member
# RigL ladder at 512² under train.mixed_precision (150 + 10 steps), and a
# 2-member one at w182 (20 + 5 steps) for the w182 "+mixed" kernels; (d)
# 2-member RigL ladders (0.25, 0.5) of 50 + 5 steps at 128² for every other
# family and fit option, one member of each against its single fit (the
# k-th ladder's member k % 2: both densities are held, in four ladders each,
# at half the single fits' time).
P18 = "outputs/chip_smoke_p18"
P18_BENCH = dict(members=64, side=256, steps=200, chunks=8)
P18_FLAGSHIP = dict(members=8, steps=200, quant_steps=20)
P18_MIXED_DENSITIES = (0.05, 0.1, 0.25, 0.5, 0.75)
P18_SHORT_DENSITIES = (0.25, 0.5)
# (d)'s masks stay at their ERK init (masking.end_when=0: no topology
# update): RigL's update ranks magnitudes, and on the card a batched product
# of the vmapped families may differ from its single twin in the last bits,
# enough to flip a near-tie and move a weight (1.4e-2 of the largest
# magnitude in a wavelet-SIREN member under updates, its fit PSNR 2e-3 dB
# from its single fit's), which would read as a fault of the member axis.
# RigL's updates over the member axis run in 14a, 18b and 18c.
P18_SHORT = ["img=synthetic", "img.height=128", "img.width=128", "masking=RigL",
             "masking.end_when=0", "train.num_steps=50", "train.log_steps=50",
             "quant.num_steps=5", "entropy_coding=zstd"]
# (d): each ladder's overrides, and the TrainConfig fields the ladder CLI
# does not carry (the JAX package's build_ladder_args carries neither)
P18_RUNS = {
    "hashgrid": (["mlp=hashgrid", "quant.skip_layers=[]", "optim.lr=1e-2",
                  "optim.epsilon=1e-15"], {}),
    "wavelet_siren": (["mlp=wavelet_siren"], {}),
    "fourier": (["mlp=fourier"], {}),
    "exact sine": (["mlp.fast_sine=false"], {}),
    "ms-ssim": ([], {"loss": "ms-ssim"}),
    "grad_clip": (["optim.grad_clip=0.05"], {}),
    # epsilon 0.1: under masks at the conf's 1e-4 Shampoo is chaotic in one
    # package alone (tests/test_torch_shampoo.py), so a member and its single
    # fit would part by more than their last bits
    "shampoo": (["optim=shampoo", "optim.epsilon=0.1"], {}),
    "ekfac": (["+optim.preconditioner=ekfac"], {}),
}
# (d)'s limits, member against its single fit: the fit PSNR within 0.05 dB
# (the CPU tests' JAX bar) and each leaf within 1e-3 in relative L2 norm
# (||member - single|| / ||single||). The CPU tests' max-abs measure (1e-3
# of the largest magnitude) is printed too but not held: Adam moves a
# hashgrid table entry whose gradient is near 0 by a whole lr step whatever
# the last bits of that gradient, and on the card a batched product's last
# bits differ from the single one's (1.27e-3 of the largest entry in the
# table at 0.5, its relative L2 difference 4.5e-5; the fit PSNRs equal). The
# decoded PSNR floor of the short fits (PERF.md section 2: 12 dB for the
# 20-step fits and 16d's 100-step trials), 20 dB for (a)-(c)'s 200-step
# fits.
P18_PSNR_TOL, P18_PARAM_TOL = 0.05, 1e-3


def _p18_checks(tag: str, results, floor: float) -> None:
    bad = [r.decoded_psnr for r in results if not (math.isfinite(r.decoded_psnr)
                                                   and r.decoded_psnr >= floor)]
    if bad:
        raise AssertionError(f"{tag} decoded PSNR below {floor} dB: {bad}")


def phase_bench_batched(card: str) -> None:
    """18a: bench.py's batched arm through batched_compress (the fit, then
    each member's `plain` container without a finetune, as the arm runs no
    quant), cut to 200 steps."""
    import numpy as np
    import torch

    from implicit_image_tpu_torch.data import get_grid, synthetic_image
    from implicit_image_tpu_torch.models import build_model
    from implicit_image_tpu_torch.ops import sine_mlp as sm
    from implicit_image_tpu_torch.parallel import batched_compress
    from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig

    tag = "[18a bench batched arm]"
    b, side, steps, chunks = (P18_BENCH[k] for k in ("members", "side", "steps", "chunks"))
    mdef, mcfg = build_model("siren", depth=DEPTH, hidden_size=WIDTH)
    imgs = np.stack([synthetic_image(side, side, seed=s) for s in range(b)])
    tc = TrainConfig(num_steps=steps, log_steps=steps, pixel_chunks=chunks,
                     matmul_precision="tensorfloat32", matmul_precision_early="bfloat16",
                     matmul_precision_switch=0.75)
    shutil.rmtree(f"{P18}_bench", ignore_errors=True)
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    res = batched_compress(torch.Generator().manual_seed(0), mdef, mcfg,
                           get_grid(side, side, "cuda"), imgs, tc, OptimConfig(),
                           stream_root=f"{P18}_bench", stream_name="plain")
    seconds = time.perf_counter() - t0
    launches, by_mode = dict(sm.LAUNCHES), {k: dict(v) for k, v in sm.LAUNCHES_BY_MODE.items()}
    fit_s = res[0].fit_wall_s
    psnr = np.array([r.psnr for r in res])
    dec = np.array([r.decoded_psnr for r in res])
    print(f"{tag} cut: train.num_steps 2000 -> {steps}; {b} x {side}² SIREN d{DEPTH}/w{WIDTH}, "
          f"pixel_chunks={chunks}, bf16 -> fp32 at 0.75 ({card})", flush=True)
    print(f"{tag} fit {fit_s:.3f} s = {fit_s / b:.4f} s per fit = "
          f"{fit_s / steps / b * 1e3:.4f} ms per step per member; mean fit PSNR "
          f"{psnr.mean():.3f} dB (min {psnr.min():.3f}), mean decoded {dec.mean():.3f} dB; "
          f"batched_compress {seconds:.2f} s in all; member-axis launches per step: K1 "
          f"{(launches['sine_mlp_fwd_batched'] - 1) / steps:g}, K2 "
          f"{launches['sine_mlp_bwd_batched'] / steps:g}, sum_partials "
          f"{launches['sum_partials_batched'] / steps:g}; launches {launches}; by mode "
          f"{by_mode['sine_mlp_bwd_batched']}", flush=True)
    early = round(steps * 0.75)
    want = {"sine_mlp_fwd_batched": steps * chunks + 1, "sine_mlp_bwd_batched": steps * chunks,
            "sum_partials_batched": steps * chunks, "sine_mlp_bwd": 0, "sum_partials": 0,
            "sine_mlp_fwd": b}
    if ({k: launches[k] for k in want} != want
            or by_mode["sine_mlp_bwd_batched"] != {"bf16": early * chunks,
                                                   "fp32": (steps - early) * chunks}):
        raise AssertionError(f"{tag} launches {launches}, by mode {by_mode}, expected {want}")
    _p18_checks(tag, res, 20.0)
    _trace_bench_batched(mdef, mcfg, imgs, tc, side)


def _trace_bench_batched(mdef, mcfg, imgs, tc, side: int, steps: int = 4) -> None:
    """`steps` steps of 18a's fit (3 in bf16, 1 in fp32) under torch.profiler:
    the device time per step, the device's idle share over the traced span
    and the top device rows (profile_fit.trace_breakdown)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from implicit_image_tpu_torch import profile_fit
    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.parallel import batched_fit
    from implicit_image_tpu_torch.training.fit import OptimConfig

    tag = "[18a trace]"
    short = dataclasses.replace(tc, num_steps=steps, log_steps=steps)
    grid = get_grid(side, side, "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = batched_fit(torch.Generator().manual_seed(0), mdef, mcfg, grid, imgs, short,
                          OptimConfig())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace = Path(f"{P18}_bench.trace.json")
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    br = profile_fit.trace_breakdown(trace, steps)
    top = "; ".join(f"{r['name'][:60]} {r['ms_per_step']:.3f} ms x {r['count'] // steps}"
                    for r in br["rows"][:6])
    print(f"{tag} {steps} steps profiled in {wall:.3f} s (fit {res.wall_seconds:.3f} s = "
          f"{res.wall_seconds / steps * 1e3:.3f} ms/step); device {br['device_ms_per_step']:.3f} "
          f"ms per step, idle share {br['idle_share']:.4f} of {br['span_ms']:.1f} ms; per step: "
          f"{top}; trace {trace}", flush=True)
    _k2_wrapper_costs(mdef, mcfg, tc, imgs.shape[0], side * side // tc.pixel_chunks, tag,
                      br["device_ms_per_step"])


def _k2_wrapper_costs(mdef, mcfg, tc, members: int, n: int, tag: str, device_ms: float,
                      dev: str = "cuda") -> dict:
    """K2 over the member axis at one pixel chunk's shapes, as the fit calls
    it (stacked leaves), by CUDA events: the wrapper in each mode, and its
    parts outside the kernels: W's bf16 planes (`weight_planes`, packed
    once per K1/K2 pair, in the forward, and handed to the backward) and
    dW's rows turned back (`_unturn_dw`, every call). Per step:
    the fit's calls in each mode (pixel_chunks a step, bf16 before the
    switch)."""
    import torch

    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    gen = torch.Generator().manual_seed(1)
    ps = [mdef.init(gen, mcfg, dev) for _ in range(members)]
    stacked = tuple({k: torch.stack([p[i][k] for p in ps]) for k in ps[0][i]}
                    for i in range(len(ps[0])))
    x = (get_grid(n, 1, dev).reshape(-1, 2) - 0.5) * 2.0
    g = (torch.randn((members, n, 3), generator=gen) / n).to(dev)
    wm = torch.randn((members, DEPTH - 2, WIDTH, WIDTH), generator=gen).to(dev)
    early = round(tc.num_steps * tc.matmul_precision_switch) / tc.num_steps
    calls = {"bf16": early * tc.pixel_chunks, "fp32": (1 - early) * tc.pixel_chunks}
    ms = {}
    for prec in calls:
        ms[prec] = {
            "wrapper": _time_ms(lambda: sm.sine_mlp_bwd_batched(stacked, x, g, mcfg, prec), 5),
            "planes": _time_ms(lambda: sm.weight_planes(wm, 1 if prec == "bf16" else 3)),
            "turn": _time_ms(lambda: sm._unturn_dw(wm)),
        }
    step = {part: sum(calls[p] * ms[p][part] for p in calls) for part in ms["fp32"]}
    print(f"{tag} K2 over {members} members x {n} px a call (CUDA events): the wrapper "
          f"bf16 {ms['bf16']['wrapper']:.3f} ms, fp32 {ms['fp32']['wrapper']:.3f} ms; of it "
          f"W's planes bf16 {ms['bf16']['planes']:.4f}, fp32 {ms['fp32']['planes']:.4f}, dW's "
          f"rows turned back {ms['fp32']['turn']:.4f}; a step ({calls['bf16']:g} bf16 + "
          f"{calls['fp32']:g} fp32 calls): the wrapper {step['wrapper']:.3f} ms, the planes "
          f"{step['planes']:.3f} ms, the turn {step['turn']:.3f} ms "
          f"({(step['planes'] + step['turn']) / device_ms:.1%} of {device_ms:.3f} ms of "
          f"device rows)", flush=True)
    return {"ms": ms, "step": step}


def phase_batched_flagship(card: str, flagship_ms: float) -> None:
    """18b: benchmarks/batched_flagship.py through batched_compress: CoordX
    s5/w96 over the member axis (vmapped products), its k-means finetune
    over the member axis, the huffman stream; no SIREN kernel launches."""
    import numpy as np
    import torch

    from implicit_image_tpu_torch.data import get_grid, stable_seed, synthetic_image
    from implicit_image_tpu_torch.models import build_model
    from implicit_image_tpu_torch.ops import sine_mlp as sm
    from implicit_image_tpu_torch.parallel import batched_compress
    from implicit_image_tpu_torch.quant import QuantConfig
    from implicit_image_tpu_torch.sparsity import MaskingConfig
    from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig

    tag = "[18b batched flagship]"
    b, steps, q = (P18_FLAGSHIP[k] for k in ("members", "steps", "quant_steps"))
    names = ["flower", "big_building", "bridge"]
    seeds = [stable_seed(names[i]) if i < 3 else i for i in range(b)]
    imgs = np.stack([synthetic_image(N_SIDE, N_SIDE, seed=s) for s in seeds])
    mdef, mcfg = build_model("coordx", depth=8, hidden_size=96, split_depth=5)
    shutil.rmtree(f"{P18}_flagship", ignore_errors=True)
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    res = batched_compress(torch.Generator().manual_seed(0), mdef, mcfg,
                           get_grid(N_SIDE, N_SIDE, "cuda"), imgs,
                           TrainConfig(num_steps=steps, log_steps=steps), OptimConfig(),
                           MaskingConfig(density=0.85),
                           quant_cfg=QuantConfig(bits=8, num_steps=q),
                           stream_name="huffman", stream_root=f"{P18}_flagship")
    seconds = time.perf_counter() - t0
    launches = dict(sm.LAUNCHES)
    ms = res[0].fit_wall_s / steps / b * 1e3
    print(f"{tag} cut: {steps} + {q} steps from 1,200 + 100; CoordX s5/w96, RigL 0.85, "
          f"B = {b} at {N_SIDE}², huffman ({card})", flush=True)
    print(f"{tag} fit {res[0].fit_wall_s:.3f} s = {ms:.4f} ms per step per member (phase 8's "
          f"single flagship fit: {flagship_ms:.4f} ms per step); batched_compress {seconds:.2f} "
          f"s in all; per member: " + ", ".join(
              f"{r.decoded_psnr:.3f} dB @ {r.compressed_bytes} B" for r in res), flush=True)
    if any(launches.values()):
        raise AssertionError(f"{tag} a SIREN kernel launched on the CoordX path: {launches}")
    _p18_checks(tag, res, 20.0)


def phase_mixed_ladder(card: str) -> dict:
    """18c: ladder_compress under train.mixed_precision (the fit's K1/K2 over
    the member axis in fp32+mixed; the finetune in fp32, as the JAX package's
    pipeline passes it only matmul_precision): the 5-member RigL ladder at
    w128, 150 + 10 steps, then 2 members at w182, 20 + 5 steps. Returns the
    "+mixed" launches of each width."""
    import dataclasses

    import torch

    from implicit_image_tpu_torch import compress
    from implicit_image_tpu_torch.ops import sine_mlp as sm
    from implicit_image_tpu_torch.parallel import ladder

    out = {}
    for width, steps, q, dens, floor in ((WIDTH, 150, 10, P18_MIXED_DENSITIES, 20.0),
                                         (FINALS_WIDTH, 20, 5, (0.25, 0.5), 12.0)):
        tag = f"[18c mixed ladder w{width}]"
        cfg = compress.compose(["img=synthetic", "masking=RigL", f"mlp.hidden_size={width}",
                                f"train.num_steps={steps}", "train.log_steps=100",
                                f"quant.num_steps={q}", "entropy_coding=zstd"])
        a = ladder.build_ladder_args(cfg)
        tc = dataclasses.replace(a["train_cfg"], mixed_precision=True)
        root = f"{P18}_mixed_w{width}"
        shutil.rmtree(root, ignore_errors=True)
        sm.reset_launch_counts()
        t0 = time.perf_counter()
        fit_res, res = ladder._ladder_run(
            torch.Generator().manual_seed(0), a["mdef"], a["mcfg"], a["grid"], a["img"], tc,
            a["optim_cfg"], a["masking"], dens, a["quant_cfg"], a["stream_name"], root,
            a["half"], a["coding_kwargs"], None, None, "cuda")
        seconds = time.perf_counter() - t0
        launches, mixed = dict(sm.LAUNCHES), dict(sm.LAUNCHES_MIXED)
        evals = len([s for s in range(steps) if (s + 1) % 100 == 0 or s == steps - 1])
        print(f"{tag} {len(dens)} members, {steps} + {q} steps in {seconds:.2f} s; fit "
              f"{fit_res.wall_seconds / steps / len(dens) * 1e3:.4f} ms per step per member; "
              f"per member: " + ", ".join(f"d={d}: {r.decoded_psnr:.3f} dB @ "
                                          f"{r.compressed_bytes} B" for d, r in zip(dens, res))
              + f"; launches {launches}; +mixed {mixed} ({card})", flush=True)
        want = {"sine_mlp_fwd_batched": steps + evals, "sine_mlp_bwd_batched": steps,
                "sum_partials_batched": steps}
        if {k: mixed[k] for k in want} != want or any(
                mixed[k] for k in ("sine_mlp_fwd", "sine_mlp_bwd", "sum_partials")):
            raise AssertionError(f"{tag} +mixed launches {mixed}, expected {want}")
        if launches["sine_mlp_bwd_batched"] != steps + q:
            raise AssertionError(f"{tag} launches {launches}: the finetune is not over the "
                                 "member axis")
        _p18_checks(tag, res, floor)
        out[width] = mixed
    return out


def phase_short_ladders(card: str) -> None:
    """18d: a 2-member RigL ladder (ladder_compress, 50 + 5 steps) of every
    other family and fit option; the k-th ladder's member k % 2 against the
    single fit with its generator, and every member's decoded PSNR above the
    short fits' floor."""
    import dataclasses

    import torch

    from implicit_image_tpu_torch import compress
    from implicit_image_tpu_torch.ops import sine_mlp as sm
    from implicit_image_tpu_torch.parallel import ladder, member_generators
    from implicit_image_tpu_torch.training.fit import fit

    for case, (name, (overrides, train)) in enumerate(P18_RUNS.items()):
        tag = f"[18d {name}]"
        cfg = compress.compose(P18_SHORT + overrides)
        a = ladder.build_ladder_args(cfg)
        tc = dataclasses.replace(a["train_cfg"], **train)
        root = f"{P18}_short_{name.replace(' ', '_')}"
        shutil.rmtree(root, ignore_errors=True)
        sm.reset_launch_counts()
        t0 = time.perf_counter()
        fit_res, res = ladder._ladder_run(
            torch.Generator().manual_seed(0), a["mdef"], a["mcfg"], a["grid"], a["img"], tc,
            a["optim_cfg"], a["masking"], P18_SHORT_DENSITIES, a["quant_cfg"],
            a["stream_name"], root, a["half"], a["coding_kwargs"], None, None, "cuda")
        seconds = time.perf_counter() - t0
        launches = dict(sm.LAUNCHES)
        steps = tc.num_steps
        gens = member_generators(torch.Generator().manual_seed(0), len(P18_SHORT_DENSITIES))
        i = case % len(P18_SHORT_DENSITIES)
        d = P18_SHORT_DENSITIES[i]
        single = fit(gens[i], a["mdef"], a["mcfg"], a["grid"], a["img"], tc, a["optim_cfg"],
                     dataclasses.replace(a["masking"], density=d), device="cuda")
        dp = abs(float(fit_res.metrics["psnr"][i][-1]) - float(single.metrics["psnr"][-1]))
        rel, l2, same = 0.0, 0.0, True
        for la, lb in zip(fit_res.params, single.params):
            for k, v in lb.items():
                same &= bool(torch.equal(la[k][i], v))
                rel = max(rel, float((la[k][i] - v).abs().max() / v.abs().max().clamp_min(
                    1e-30)))
                l2 = max(l2, float((la[k][i] - v).norm() / v.norm().clamp_min(1e-30)))
        print(f"{tag} {len(res)} members, {steps} + {int(cfg.quant.num_steps)} steps in "
              f"{seconds:.2f} s ({fit_res.wall_seconds / steps / len(res) * 1e3:.4f} ms per fit "
              f"step per member); decoded " + ", ".join(
                  f"d={dd}: {r.decoded_psnr:.3f} dB @ {r.compressed_bytes} B"
                  for dd, r in zip(P18_SHORT_DENSITIES, res))
              + f"; d={d} vs its single fit: {'the same bits' if same else 'not the same bits'}"
              f", fit PSNR {dp:.2e} dB apart, params {l2:.2e} apart in relative L2 ({rel:.2e} "
              f"of the largest entry); launches {launches} ({card})", flush=True)
        if not (dp <= P18_PSNR_TOL and l2 <= P18_PARAM_TOL):
            raise AssertionError(f"{tag} member d={d} is not its single fit: {dp}, {l2}")
        _p18_checks(tag, res, 12.0)


def phase_member_axis(card: str, flagship_ms: float) -> dict:
    """Phase 18; returns 18c's "+mixed" launches per width."""
    mixed = {}

    def c():
        mixed.update(phase_mixed_ladder(card))

    for part, fn in (("a", lambda: phase_bench_batched(card)),
                     ("b", lambda: phase_batched_flagship(card, flagship_ms)), ("c", c),
                     ("d", lambda: phase_short_ladders(card))):
        t0 = time.perf_counter()
        fn()
        print(f"[18{part}] wall {time.perf_counter() - t0:.2f} s", flush=True)
    return mixed


# phase 19: the multi-device layer on the one card, at phase 5's
# configuration (the RigL default, 512², SIREN d8/w128, 200 + 20 steps):
# (a) a world-size-1 NCCL group, (b) two processes sharing the card over
# gloo with the image's rows split over them, (c) two processes over gloo
# with the members split over them, (d) the multi-process fleet dryrun,
# (e) the rate-distortion scoring without JAX, cv2 or matplotlib.
P19 = "outputs/chip_smoke_p19"
P19_MEMBERS = 4
P19_DENSITIES = (0.25, 0.5)
P19_FLEET = 3  # images of (d)'s dryrun fleet (16², d3/w8, 20 steps)
P19_FLOOR = 20.0  # dB, (a)'s decoded PSNR, as phase 5's
# (f): phase 11 (a)'s wavelet-SIREN (d8/w128, 512², dense), its fit cut to 60
# steps; over 2 pixel ranks each runs the sub-SIRENs on 129 of the DWT
# lattices' 258 rows and the gradients add over the ranks: the single fit up
# to that sum's order, held to the JAX-parity limits of
# tests/test_torch_parallel.py (0.05 dB, 1e-3 of each leaf's largest
# magnitude)
P19_WAVELET = ["img=synthetic", "mlp=wavelet_siren", "masking=none", "train.num_steps=60",
               "train.log_steps=30"]
P19_WAVELET_DB, P19_WAVELET_REL = 0.05, 1e-3


def _p19_pieces(overrides=None) -> dict:
    """Phase 5's configuration (or `overrides`) as the entry points'
    arguments, built as compress.main builds them."""
    from implicit_image_tpu_torch import compress
    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model_from_config
    from implicit_image_tpu_torch.training.fit import TrainConfig

    cfg = compress.compose(overrides or DEFAULT_OVERRIDES)
    img = compress._load_image(cfg.img)
    h, w = img.shape[:2]
    mdef, mcfg = build_model_from_config(cfg)
    train = TrainConfig(
        num_steps=int(cfg.train.num_steps), log_steps=int(cfg.train.log_steps),
        pixel_chunks=compress._resolve_pixel_chunks(cfg.train.get("pixel_chunks", "auto"), h, w),
        matmul_precision=cfg.train.get("matmul_precision") or None,
        segment_steps=compress.auto_segment_steps(cfg))
    return dict(img=img, h=h, w=w, grid=get_grid(h, w), mdef=mdef, mcfg=mcfg, train=train,
                optim=compress._optim_config(cfg), masking=compress.masking_config(cfg),
                quant=compress._quant_config(cfg.quant), seed=int(cfg.seed),
                stream=cfg.entropy_coding.stream_name, half=compress._half_policy(cfg.entropy_coding))


def _p19_generator(p):
    import torch

    return torch.Generator().manual_seed(p["seed"])


def _p19_launched(launches: dict, what: str) -> None:
    """K1, K2 and sum_partials launched, and nothing over a member axis."""
    for name in ("sine_mlp_fwd", "sine_mlp_bwd", "sum_partials"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} did not launch on {what}: {launches}")


def _p19_same(a, b, what: str) -> None:
    """Two params (or masks) trees equal bit for bit, on any devices."""
    import torch

    for i, (x, y) in enumerate(zip(a, b)):
        if x is None or y is None:
            if not (x is None and y is None):
                raise AssertionError(f"{what}: layer {i} masked in one only")
            continue
        for k in (x.keys() if isinstance(x, dict) else [None]):
            u, v = (x[k], y[k]) if k is not None else (x, y)
            if not torch.equal(u.cpu(), v.cpu()):
                raise AssertionError(f"{what}: layer {i} {k} differs by "
                                     f"{(u.cpu().float() - v.cpu().float()).abs().max():.3e}")


def _p19_digest(root) -> dict:
    import hashlib

    root = Path(root)
    return {str(f.relative_to(root)): hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(root.rglob("*")) if f.is_file()}


def phase_world1(p, device="cuda", backend="nccl") -> dict:
    """19 (a); returns the launches of the sharded path (fit, render and
    pipeline)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from implicit_image_tpu_torch.ops import sine_mlp as sm
    from implicit_image_tpu_torch.parallel import (
        make_mesh,
        pipeline,
        sharded_compress,
        sharded_fit,
        sharded_render,
    )
    from implicit_image_tpu_torch.parallel.multihost import init_multihost
    from implicit_image_tpu_torch.training.fit import fit
    from implicit_image_tpu_torch.training.quant_phase import quant_finetune

    root = Path(P19) / "a"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    init_multihost(f"file://{(root / 'rendezvous').resolve()}", 1, 0, backend, device)
    mesh = make_mesh(1, 1, device=device)
    args = (p["mdef"], p["mcfg"], p["grid"], p["img"], p["train"], p["optim"], p["masking"])
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    single = fit(_p19_generator(p), *args, device=mesh.device)
    single_s = time.perf_counter() - t0
    single_launches = dict(sm.LAUNCHES)
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    sharded = sharded_fit(_p19_generator(p), mesh, *args)
    fit_s = time.perf_counter() - t0
    fit_launches = dict(sm.LAUNCHES)
    render = sharded_render(mesh, p["mdef"], p["mcfg"], sharded.params, p["h"], p["w"])
    t0 = time.perf_counter()
    res = sharded_compress(_p19_generator(p), mesh, *args, p["quant"], stream_name=p["stream"],
                           stream_dir=str(root / "sharded"), half=p["half"])
    compress_s = time.perf_counter() - t0
    launches = dict(sm.LAUNCHES)
    print(f"[19a world 1] backend {dist.get_backend()}, mesh {mesh.shape}: sharded fit "
          f"{fit_s:.2f} s (the single fit {single_s:.2f} s; fit walls {sharded.wall_seconds:.3f} "
          f"/ {single.wall_seconds:.3f} s), sharded_compress {compress_s:.2f} s, decoded "
          f"{res.decoded_psnr:.3f} dB, {res.compressed_bytes} B; fit launches "
          f"{fit_launches} (single fit {single_launches}); path launches {launches}", flush=True)
    if dist.get_backend() != backend:
        raise AssertionError(f"the group runs {dist.get_backend()}, not {backend}")
    _p19_same(sharded.params, single.params, "19a sharded fit params")
    _p19_same(sharded.mask_state.masks, single.mask_state.masks, "19a sharded fit masks")
    if fit_launches != single_launches:
        raise AssertionError(f"19a sharded fit launched {fit_launches}, the single fit "
                             f"{single_launches}")
    _p19_launched(launches, "19a's sharded path")
    with torch.no_grad():
        plain = p["mdef"].apply(single.params, p["grid"].to(mesh.device), p["mcfg"], "fp32")
    if not torch.equal(render, plain):
        raise AssertionError("19a sharded_render is not the single render")
    from implicit_image_tpu_torch.ops.sine_mlp import precision_from_config

    q = quant_finetune(single.params, p["img"], p["mdef"], p["mcfg"], p["grid"], p["quant"],
                       p["optim"], precision=precision_from_config(p["train"].matmul_precision),
                       masks=single.mask_state.masks)
    nbytes, dec = pipeline._encode_decode(
        q.params, q.codebooks, p["mdef"], p["mcfg"], p["h"], p["w"],
        np.asarray(p["img"], np.float64), root / "single", p["stream"], p["half"],
        device=mesh.device)
    ours, theirs = _p19_digest(root / "sharded"), _p19_digest(root / "single")
    print(f"[19a world 1] single pipeline {nbytes} B, {dec:.3f} dB; streams {ours}", flush=True)
    if ours != theirs or (res.compressed_bytes, res.decoded_psnr) != (nbytes, dec):
        raise AssertionError(f"19a sharded_compress wrote {ours}, the single pipeline {theirs}")
    if not (math.isfinite(res.decoded_psnr) and res.decoded_psnr >= P19_FLOOR):
        raise AssertionError(f"19a decoded PSNR {res.decoded_psnr} below {P19_FLOOR} dB")
    # the wavelet-SIREN at world size 1: the single fit bit for bit
    wp = _p19_pieces(P19_WAVELET)
    wargs = (wp["mdef"], wp["mcfg"], wp["grid"], wp["img"], wp["train"], wp["optim"], None)
    wsingle = fit(_p19_generator(wp), *wargs, device=mesh.device)
    sm.reset_launch_counts()
    wsharded = sharded_fit(_p19_generator(wp), mesh, *wargs)
    wlaunches = dict(sm.LAUNCHES)
    wrender = sharded_render(mesh, wp["mdef"], wp["mcfg"], wsharded.params, wp["h"], wp["w"])
    print(f"[19a world 1] wavelet-SIREN: sharded fit PSNR {wsharded.metrics['psnr'][-1]:.3f} dB "
          f"(single {wsingle.metrics['psnr'][-1]:.3f}); launches {wlaunches}", flush=True)
    _p19_same(wsharded.params, wsingle.params, "19a wavelet sharded fit params")
    with torch.no_grad():
        wplain = wp["mdef"].apply(wsingle.params, wp["grid"].to(mesh.device), wp["mcfg"], "fp32")
    if not torch.equal(wrender, wplain):
        raise AssertionError("19a the wavelet sharded_render is not the single render")
    if wlaunches["sine_mlp_bwd"] != 2 * wp["train"].num_steps:
        raise AssertionError(f"19a wavelet: K2 {wlaunches['sine_mlp_bwd']} launches, expected "
                             f"two a step")
    dist.destroy_process_group()
    return launches


def _p19_rank_setup(device, overrides):
    """A phase 19 rank: the kernels (built by the parent) and the pieces."""
    import torch

    if torch.device(device).type == "cuda":
        from implicit_image_tpu_torch.ops.cuda_build import open_device

        open_device(torch.device("cuda", torch.cuda.current_device()))
    return _p19_pieces(overrides)


def _p19_pixel_rank(rank, device, overrides):
    """19 (b) on one rank: the sharded fit over 2 pixel ranks."""
    from implicit_image_tpu_torch.ops import sine_mlp as sm
    from implicit_image_tpu_torch.parallel import make_mesh, sharded_fit
    from implicit_image_tpu_torch.training.fit import pixel_rows, synchronize

    p = _p19_rank_setup(device, overrides)
    mesh = make_mesh(1, 2, device=device)
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    res = sharded_fit(_p19_generator(p), mesh, p["mdef"], p["mcfg"], p["grid"], p["img"],
                      p["train"], p["optim"], p["masking"])
    synchronize(mesh.device)
    rows = pixel_rows(p["h"], mesh.pixel)
    return dict(params=res.params, masks=res.mask_state.masks, launches=dict(sm.LAUNCHES),
                rows=(rows.start, rows.stop), wall=time.perf_counter() - t0,
                fit_wall=res.wall_seconds, psnr=float(res.metrics["psnr"][-1]))


def _p19_wavelet_rank(rank, device):
    """19 (f) on one rank: the wavelet-SIREN's sharded fit and render over 2
    pixel ranks (the DWT lattices' rows split)."""
    import torch

    from implicit_image_tpu_torch.models.wavelet_siren import lattice_share
    from implicit_image_tpu_torch.ops import sine_mlp as sm
    from implicit_image_tpu_torch.parallel import make_mesh, sharded_fit, sharded_render

    p = _p19_rank_setup(device, P19_WAVELET)
    mesh = make_mesh(1, 2, device=device)
    sm.reset_launch_counts()
    t0 = time.perf_counter()
    res = sharded_fit(_p19_generator(p), mesh, p["mdef"], p["mcfg"], p["grid"], p["img"],
                      p["train"], p["optim"])
    wall = time.perf_counter() - t0
    launches = dict(sm.LAUNCHES)
    render = sharded_render(mesh, p["mdef"], p["mcfg"], res.params, p["h"], p["w"])
    with torch.no_grad():
        single_render = p["mdef"].apply(res.params, p["grid"].to(mesh.device), p["mcfg"], "fp32")
    share = lattice_share(p["mcfg"].lf_shape[0], mesh.pixel.rank, 2)
    return dict(params=res.params, psnr=res.metrics["psnr"], wall=wall, launches=launches,
                render_same=bool(torch.equal(render, single_render)),
                share=(share.start, share.stop))


def phase_wavelet_ranks(device="cuda") -> None:
    """19 (f): the full-grid wavelet-SIREN over 2 pixel ranks sharing the
    card over gloo, against the single fit (P19_WAVELET_DB, _REL); each
    rank's sharded render the single render of its params bit for bit."""
    import numpy as np

    from implicit_image_tpu_torch.parallel.multihost import run_group
    from implicit_image_tpu_torch.training.fit import fit

    p = _p19_pieces(P19_WAVELET)
    t0 = time.perf_counter()
    ranks = run_group(_p19_wavelet_rank, 2, (device,), device=device, backend="gloo",
                      timeout=600.0, workdir=P19)
    spawn_s = time.perf_counter() - t0
    single = fit(_p19_generator(p), p["mdef"], p["mcfg"], p["grid"], p["img"], p["train"],
                 p["optim"], device=device)
    logged = ~np.isnan(single.metrics["psnr"])
    for r, out in enumerate(ranks):
        db = float(np.abs(out["psnr"][logged] - single.metrics["psnr"][logged]).max())
        rel = max(float((a[k].cpu() - b[k].cpu()).abs().max() / b[k].abs().max().cpu())
                  for a, b in zip(out["params"], single.params) for k in a)
        print(f"[19f wavelet pixel 2] rank {r}: lattice rows {out['share']} of "
              f"{p['mcfg'].lf_shape[0]}, fit {out['wall']:.2f} s (the single fit "
              f"{single.wall_seconds:.2f} s), PSNR {out['psnr'][-1]:.4f} dB (single "
              f"{single.metrics['psnr'][-1]:.4f}; max diff {db:.2e} dB), params max rel diff "
              f"{rel:.2e}; launches {out['launches']}; render "
              f"{'the single render bit for bit' if out['render_same'] else 'DIFFERS'}",
              flush=True)
        if not (db <= P19_WAVELET_DB and rel <= P19_WAVELET_REL and out["render_same"]):
            raise AssertionError(f"19f rank {r}: {db} dB, {rel} rel, render {out['render_same']}")
        if out["launches"]["sine_mlp_bwd"] != 2 * p["train"].num_steps:
            raise AssertionError(f"19f rank {r}: K2 launches {out['launches']}")
    if ranks[0]["share"][1] != ranks[1]["share"][0]:
        raise AssertionError(f"19f the ranks' lattice shares {[o['share'] for o in ranks]}")
    print(f"[19f wavelet pixel 2] spawn to results {spawn_s:.2f} s", flush=True)


def _p19_members(p):
    import numpy as np

    from implicit_image_tpu_torch.data import synthetic_image

    return np.stack([synthetic_image(p["h"], p["w"], seed=s) for s in range(P19_MEMBERS)])


def _p19_image_rank(rank, device, overrides, root):
    """19 (c) on one rank: the batched fit and the ladder over 2 image ranks,
    the ladder's run dirs under root/ladder_mesh."""
    from implicit_image_tpu_torch.parallel import batched_fit, make_mesh
    from implicit_image_tpu_torch.parallel.ladder import ladder_compress

    p = _p19_rank_setup(device, overrides)
    mesh = make_mesh(2, 1, device=device)
    t0 = time.perf_counter()
    res = batched_fit(_p19_generator(p), p["mdef"], p["mcfg"], p["grid"], _p19_members(p),
                      p["train"], p["optim"], p["masking"], mesh=mesh)
    fit_s = time.perf_counter() - t0
    ladder = ladder_compress(_p19_generator(p), p["mdef"], p["mcfg"], p["grid"], p["img"],
                             p["train"], p["optim"], p["masking"], P19_DENSITIES,
                             quant_cfg=p["quant"], stream_name=p["stream"],
                             stream_root=str(Path(root) / "ladder_mesh"), half=p["half"],
                             mesh=mesh)
    return dict(params=res.params, masks=res.mask_state.masks, fit_s=fit_s,
                ladder=[(r.compressed_bytes, r.decoded_psnr) for r in ladder])


def phase_pixel_ranks(p, device="cuda", overrides=None) -> None:
    """19 (b)."""
    import dataclasses

    from implicit_image_tpu_torch.ops import sine_mlp as sm
    from implicit_image_tpu_torch.parallel.multihost import run_group
    from implicit_image_tpu_torch.training.fit import fit

    t0 = time.perf_counter()
    ranks = run_group(_p19_pixel_rank, 2, (device, overrides), device=device, backend="gloo",
                      timeout=600.0, workdir=P19)
    spawn_s = time.perf_counter() - t0
    sm.reset_launch_counts()
    single = fit(_p19_generator(p), p["mdef"], p["mcfg"], p["grid"], p["img"],
                 dataclasses.replace(p["train"], pixel_chunks=2 * p["train"].pixel_chunks),
                 p["optim"], p["masking"], device=device)
    single_launches = dict(sm.LAUNCHES)
    print(f"[19b pixel 2] the single fit with pixel_chunks=2: fit wall "
          f"{single.wall_seconds:.3f} s", flush=True)
    for r, out in enumerate(ranks):
        print(f"[19b pixel 2] rank {r}: rows {out['rows']} of {p['h']}, fit {out['wall']:.2f} s "
              f"(fit wall {out['fit_wall']:.3f} s), "
              f"PSNR {out['psnr']:.3f} dB, launches {out['launches']}", flush=True)
        _p19_launched(out["launches"], f"19b rank {r}")
        _p19_same(out["params"], single.params, f"19b rank {r} params")
        _p19_same(out["masks"], single.mask_state.masks, f"19b rank {r} masks")
        if out["rows"] != (r * p["h"] // 2, (r + 1) * p["h"] // 2):
            raise AssertionError(f"19b rank {r} fit rows {out['rows']}")
        # one chunk a rank: K2 once a step (the single fit with 2 chunks twice)
        if 2 * out["launches"]["sine_mlp_bwd"] != single_launches["sine_mlp_bwd"]:
            raise AssertionError(f"19b rank {r} K2 launches {out['launches']['sine_mlp_bwd']}, "
                                 f"the single fit with 2 chunks {single_launches}")
    print(f"[19b pixel 2] both ranks the single fit with pixel_chunks=2 bit for bit "
          f"(its launches {single_launches}); spawn to results {spawn_s:.2f} s", flush=True)


def phase_image_ranks(p, device="cuda", overrides=None) -> None:
    """19 (c)."""
    from implicit_image_tpu_torch.parallel import batched_fit
    from implicit_image_tpu_torch.parallel.ladder import ladder_compress
    from implicit_image_tpu_torch.parallel.multihost import run_group

    root = Path(P19) / "c"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    ranks = run_group(_p19_image_rank, 2, (device, overrides, str(root)), device=device,
                      backend="gloo", timeout=600.0, workdir=P19)
    spawn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = batched_fit(_p19_generator(p), p["mdef"], p["mcfg"], p["grid"], _p19_members(p),
                        p["train"], p["optim"], p["masking"], device=device)
    fit_s = time.perf_counter() - t0
    ladder = ladder_compress(_p19_generator(p), p["mdef"], p["mcfg"], p["grid"], p["img"],
                             p["train"], p["optim"], p["masking"], P19_DENSITIES,
                             quant_cfg=p["quant"], stream_name=p["stream"],
                             stream_root=str(root / "ladder_plain"), half=p["half"],
                             device=device)
    for r, out in enumerate(ranks):
        _p19_same(out["params"], plain.params, f"19c rank {r} params")
        _p19_same(out["masks"], plain.mask_state.masks, f"19c rank {r} masks")
        if out["ladder"] != [(x.compressed_bytes, x.decoded_psnr) for x in ladder]:
            raise AssertionError(f"19c rank {r} ladder {out['ladder']}")
    mesh_streams = _p19_digest(root / "ladder_mesh")
    if mesh_streams != _p19_digest(root / "ladder_plain") or not mesh_streams:
        raise AssertionError("19c the mesh ladder's containers are not the plain ladder's")
    print(f"[19c image 2] {P19_MEMBERS}-member batched fit over 2 ranks "
          f"({ranks[0]['fit_s']:.2f} s; without the mesh {fit_s:.2f} s) and the "
          f"{len(P19_DENSITIES)}-member ladder ({ranks[0]['ladder']}) the runs without the mesh "
          f"bit for bit; spawn to results {spawn_s:.2f} s", flush=True)


def phase_fleet_dryrun(device="cuda") -> None:
    """19 (d)."""
    import numpy as np
    import torch

    from implicit_image_tpu_torch.data import get_grid, synthetic_image
    from implicit_image_tpu_torch.models import build_model
    from implicit_image_tpu_torch.parallel import member_generators
    from implicit_image_tpu_torch.parallel.multihost import launch_dryrun
    from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

    t0 = time.perf_counter()
    reports = launch_dryrun(2, fleet_size=P19_FLEET, steps=20, timeout=600.0, device=device,
                            backend="gloo")
    wall = time.perf_counter() - t0
    mdef, mcfg = build_model("siren", depth=3, hidden_size=8)
    gens = member_generators(torch.Generator().manual_seed(0), P19_FLEET)
    single = [float(np.float32(fit(gens[i], mdef, mcfg, get_grid(16, 16), synthetic_image(
        16, 16, seed=i), TrainConfig(num_steps=20, log_steps=20), OptimConfig(lr=1e-3),
        device=device).metrics["psnr"][-1])) for i in range(P19_FLEET)]
    print(f"[19d fleet] launch_dryrun(2) {wall:.2f} s: {reports}; single fits {single}",
          flush=True)
    for r in reports:
        if r["fleet_psnrs"] != single or not r["collective_ok"]:
            raise AssertionError(f"19d worker {r['process_id']} reports {r['fleet_psnrs']}, "
                                 f"the single fits {single}")


def phase_rate_distortion(default_run: str, overrides=None, device="cuda") -> None:
    """19 (e)."""
    import importlib.util

    import numpy as np

    from implicit_image_tpu_torch import compress, decompress
    from implicit_image_tpu_torch.visualize.rate_distortion import _ms_ssim_np, ours_rate_distortion

    summary = json.loads((Path(default_run) / "summary.json").read_text())
    kb = summary["Compressed Bytes"] / 1024.0
    points = {m: ours_rate_distortion(default_run, metric=m) for m in ("psnr", "ms_ssim")}
    img, _ = decompress.decode_run(default_run, device=device)
    target = compress._load_image(compress.compose(overrides or DEFAULT_OVERRIDES).img)
    host = _ms_ssim_np(np.asarray(img), target)
    missing = [m for m in ("cv2", "matplotlib", "jax") if importlib.util.find_spec(m) is None]
    print(f"[19e rate-distortion] {points}; summary.json: {kb} KB, "
          f"{summary['Decoded PSNR']} dB, MS-SSIM {summary['Decoded MS-SSIM']}; the host "
          f"scoring of the decoded image {host} (diff "
          f"{host - summary['Decoded MS-SSIM']:.2e}); absent here: {missing}", flush=True)
    if points != {"psnr": [(kb, summary["Decoded PSNR"])],
                  "ms_ssim": [(kb, summary["Decoded MS-SSIM"])]}:
        raise AssertionError(f"19e the run store reads {points}")
    if abs(host - summary["Decoded MS-SSIM"]) > 1e-4:
        raise AssertionError(f"19e host MS-SSIM {host} against {summary['Decoded MS-SSIM']}")


def phase_multi_device(default_run: str) -> dict:
    """Phase 19; returns (a)'s launches of the sharded path."""
    p = _p19_pieces()
    t0 = time.perf_counter()
    launches = phase_world1(p)
    for part, fn in (("b", lambda: phase_pixel_ranks(p)), ("c", lambda: phase_image_ranks(p)),
                     ("d", phase_fleet_dryrun), ("e", lambda: phase_rate_distortion(default_run)),
                     ("f", phase_wavelet_ranks)):
        t1 = time.perf_counter()
        fn()
        print(f"[19{part}] wall {time.perf_counter() - t1:.2f} s", flush=True)
    print(f"[19 multi-device] wall {time.perf_counter() - t0:.2f} s", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU",
              file=sys.stderr)
        return 2
    from implicit_image_tpu_torch.ops import sine_mlp as sm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    started = time.perf_counter()
    card = phase_card()
    phase_build()
    records = {width: phase_kernels(width) for width in KERNEL_WIDTHS_CHECKED}
    for width in BATCH_WIDTHS:
        records[width]["sine_mlp_fwd_batched"] = phase_batched_kernel(width)
        records[width].update(phase_batched_backward(width))
        records[width].update(phase_mixed_batched(width))
    layer_records = {width: phase_layer_kernels(width) for width in LAYER_WIDTHS}
    for width in LAYER_PAIR_WIDTHS:
        phase_layer_kernels(width, pairs_only=True)
    for width, recs in layer_records.items():
        records[width] = dict(recs["single"])
    for width in LAYER_LADDER_WIDTHS.values():
        records[width].update(layer_records[width]["batched"])
    phase_layer_wide()
    print(f"[3 kernels] phases 1-3 took {time.perf_counter() - started:.1f} s", flush=True)
    launches, dense_summary = phase_main_path()
    default_dir = phase_default_path(dense_summary)
    phase_presets()
    phase_repeat(default_dir)
    flagship_ms = phase_flagship()
    # the launches of each width on the path that runs it
    path_launches = {WIDTH: launches, FINALS_WIDTH: phase_finals(),
                     **{width: phase_layer_path(width) for width in LAYER_WIDTHS}}
    phase_families()
    phase_fit_options(compress_dir(SMOKE_OVERRIDES), default_dir)
    # K1 over a member axis launches on the batched decode of phase 13 (e)
    for width, count in phase_run_tools(default_dir).items():
        path_launches[width]["sine_mlp_fwd_batched"] = count
    # K2 over a member axis launches on the ladders of phase 14 (a, d, e, f)
    for width, counts in phase_parallel(default_dir).items():
        for name in ("sine_mlp_bwd_batched", "sum_partials_batched",
                     *(k + "_batched" for k in LAYER_KERNELS)):
            path_launches[width][name] = counts[name]
    phase_last_options(default_dir)
    phase_tools(default_dir, compress_dir(SMOKE_OVERRIDES))
    sequence_launches = phase_sequences()
    # K1 and K2 over a member axis in "+mixed" launch on phase 18 (c)'s ladders
    for width, counts in phase_member_axis(card, flagship_ms).items():
        for name in ("sine_mlp_fwd_batched", "sine_mlp_bwd_batched"):
            path_launches[width][name + sm.MIXED] = counts[name]
    sharded_launches = phase_multi_device(default_dir)

    sources = {"sine_mlp_fwd": 81, "sine_mlp_fwd_batched": 81, "sine_mlp_bwd": 128,
               "sine_mlp_bwd_batched": 128, "sum_partials": 179, "sum_partials_batched": 179,
               # the layer-wise kernels (widths above 192): K1's, K2's and its dW
               "sine_mlp_layer_fwd": 81, "sine_mlp_layer_fwd_batched": 81,
               "sine_mlp_layer_bwd": 128, "sine_mlp_layer_bwd_batched": 128,
               "sine_mlp_layer_dw": 128, "sine_mlp_layer_dw_batched": 128,
               # their first- and last-layer kinds (the streaming passes)
               "sine_mlp_layer_fwd first": 81, "sine_mlp_layer_fwd last": 81,
               "sine_mlp_layer_bwd last": 128, "sine_mlp_layer_bwd first": 128}
    sources.update({name + sm.MIXED: sources[name]
                    for name in ("sine_mlp_fwd_batched", "sine_mlp_bwd_batched")})

    kernels = [
        {
            "name": name,
            "hidden": width,
            "kernel_width": sm.kernel_width(width),
            "route": "cuda",
            "source": "implicit_image_tpu_torch/csrc/sine_mlp.cu",
            "replaces": f"implicit_image_tpu/ops/sine_mlp.py:{sources[name]}",
            "launches": path_launches[width][name],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"],
            "padded_bound_ms": padded_bound_ms,
            "library_ms": library_ms,
            # the single launches at w128 on phase 17a's sequence encode
            **({"sequence_launches": sequence_launches[name],
                "sharded_launches": sharded_launches[name]}
               if width == WIDTH and name in ("sine_mlp_fwd", "sine_mlp_bwd", "sum_partials")
               else {}),
        }
        for width, by_name in records.items()
        for name, (err, ms, plain_ms, library_ms, bound, padded_bound_ms) in by_name.items()
    ]
    print(f"[chip_smoke] wall {time.perf_counter() - started:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
