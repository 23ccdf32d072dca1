#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dl4ds_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs nvcc

Phases, each of which exits non-zero on failure:
  1. check for a CUDA device, print the card's name and power limit, build
     every kernel from `dl4ds_tpu_torch/csrc/` with nvcc (one process per
     source, all started together);
  2. hold K1 (the channel-attention gate) against its plain PyTorch version
     on the card at the shapes the flagship path gives it (f32 and bf16),
     forward and backward (the backward against the plain version run in
     float64, each gradient within 1e-5 of its max |ref|, the same bits
     twice), also at the training gates' shapes and on its other paths; check
     that the shapes ran every regime of its launch plan (block, stream)
     and that each launches the kernels it should (the kernel
     library's own count of its launches);
     time both directions with CUDA events, and check the gate's autograd
     backward;
  3. drive the flagship path: full-width `predict` of the resnet_spc x4
     model (128x128 LR -> 512x512 HR, 2 static variables, 1 predictor) on 16
     grids at batch 8, count the kernel launches it made, and compare grid 0
     with the same model and weights run on the CPU;
  4. hold K2 (the ConvLSTM layer, inference variant) against its plain
     version with TF32 off at the six layer shapes of the recresnet_spc
     model and at width 64, time both, check its other paths (T = 1, the
     input launch alone; other kernel sizes; channel counts that are not
     multiples of 4 or 8; Cin 1 and 2; F 4, 5, 12 and 72; frames of 5x7
     and 17x17 and wider than a tile; both channel slices, chunk widths
     and stage depths of the launch plan) and that its bits repeat, and
     check that a layer whose weights require grad runs K2's training
     variant and K3 for its gradient;
  5. drive the spatio-temporal path: full-width `predict(time_window=4)` of
     the recresnet_spc x4 model on 19 grids (16 windows of 4) at batch 8,
     count its launches, and compare grid 0 and the last 4 grids with the
     same model run on the CPU;
  6. hold K2's training variant (ys and the cs, zs residuals) and K3 (the
     BPTT backward: dx, dWx, dbx, dWh; the chain steps and dx in the tile
     of csrc/convlstm_seq.cu, the weight gradients in csrc/convlstm_bwd.cu)
     against their plain versions with TF32 off at the six layer shapes of
     a recresnet_spc training step (batch 128, T 4, 16x16 LR patches), at
     width 64 and on their other paths (T = 1, odd F, F = 12, 1x3, 3x5, 7x7
     and 9x9 kernels, ragged tiles, 5x7 and 17x17 frames with Cin 1 and 2,
     x without a gradient, dx at 16 and 32 channels a block), check that
     two runs of K2-train and of K3 give the same bits, and time both
     kernels against their plain versions and their two bounds (float32,
     3xTF32), K3 also by launch kind (chain, dx, weight gradients, reduce;
     torch.profiler); then hold K4 (the same chain steps, writing dzs)
     against its plain version run in float64 and the split route (K4, then
     the float32 GEMM tail) against the plain BPTT in float64, at the six
     layer shapes of the width-64 training step and on K4's other paths
     (T = 1, odd F, F = 12, 16, 32 and 72, 1x3, 3x5 and 7x7), with K2's
     training variant that feeds them, check that their bits repeat, time
     K2-train, K4 and the tail against their bounds and K2-train and K4
     against their plain versions, and check that the shapes ran every
     compiled body and stage kind of the chain-step and dx tile;
  7. drive recurrent training: `SupervisedTrainer(time_window=4)` on the
     recresnet_spc x4 configuration of bench_suite.py (256 grids of
     128x128, 64x64 patches, batch 128, mae) for 2 epochs of 20 steps with
     validation and test, its steps replayed as captured CUDA graphs, under
     torch.profiler; count the launches of K2 (both variants), K3 and K4
     in the run's device trace (a step's launches times each graph's
     warm-up calls and replays) and the wrappers' calls (a step's launches
     times each graph's warm-up calls and its capture), against what
     `dispatch_info` routes; require finite losses, time the
     steps (patches/s on the host clock, one step on CUDA events), then run
     3 steps at batch 16 from one seed on the GPU (TF32 off, PyTorch's own
     convolutions) and on the CPU in float64 and compare the losses and
     the parameters;
  8. drive the same training at width 64 (bench_suite.py's
     recresnet_spc_width64: n_filters 64, attention) for 2 epochs of 10
     steps at batch 128, print each ConvLSTM layer's route, count the
     launches against the routes, require finite losses, time the steps,
     and compare 3 steps at batch 4 on the GPU with the CPU;
  9. hold K6 (the fused per-image SSIM) against its plain version run in
     float64 at the DSSIM loss's shape in a flagship training step
     ([128, 64, 64, 1]) and on its other paths (the minimal 11x11 image,
     ragged tiles, a 512x512 grid, channels folded, a 5-D input, other
     filter sizes), and its backward against `ssim_backward_reference` in
     float64 for both images and max_val; check that its bits repeat, that
     both regimes (image, tiles) ran each way and launched what they should,
     time it against its plain version and its bound, and check dssim_mae's
     value and y_pred gradient through K6 against the same loss on the plain
     path (CPU);
 10. drive the flagship training: `SupervisedTrainer('resnet', 'spc',
     scale=4, patch_size=64, batch_size=128, n_filters=8, n_blocks=6,
     attention=True, loss='dssim_mae')` (bench.py's configuration) on 256
     grids of 128x128 for 2 epochs of 20 steps with validation and test;
     first hold and time K1 at the step's gate shapes (forward and
     backward against their plain versions), then count the launches of K1
     (its gates per forward x the forwards; its backward a gate a training
     step) and K6 (one a loss each way), require finite losses, time the
     steps, and compare 3 steps at batch 16 on the GPU (PyTorch's own
     convolutions) with the CPU in float64;
 11. hold the replayed graphs against eager steps: for the flagship with
     `dssim_mae`, the same with EMA, gradient accumulation over 2
     microbatches and a cosine schedule, and recurrent training at
     n_filters 8 and 64, run 8 steps through `run()`'s graphs and 8 eager
     `train_step`s from the same weights and plan (cuDNN deterministic) and
     require the same bits in every loss, parameter and EMA weight; check
     the graphed run's launches in its device trace and its wrapper calls
     as phases 7, 8 and 10 do, and that the kernels' arrival counters are
     left at zero; print the
     speed of the three training paths graphed and eager, which phases 7,
     8 and 10 measure on their trainers (patches/s on the host clock, one
     replay and one eager step on CUDA events, the device's busy share
     over a chunk of replays, in which torch.profiler must see every
     replay run the port's kernels);
 12. the bfloat16 model dtype: hold K1's mixed mode (bfloat16 x, float32 y
     and dy) forward and backward in every regime and pack width of its
     plan, K2 (both variants, held step by step: each plain step from the
     kernel's own previous h and c), K3 and K4 with the bfloat16 tail (the
     chain held step by step, dx and the weight gradients against the
     plain tail in float64 on the chain's dzs) against their plain
     versions, within 2 bfloat16 ulps of max |ref| (float32 values within
     1e-3), the same bits twice, every compiled bfloat16 body run; time
     them against their plain versions and their bounds (the dense
     bfloat16 rate and the measured mma.sync peak); drive bfloat16
     `predict` of both models (launches, a float32 return holding
     bfloat16 values, grid 0 against the CPU: mean |d| at most half the
     float32 model's distance) and two epochs of bfloat16 training of the
     flagship with mae (beside the float32 flagship with mae) and of
     recresnet_spc at n_filters 8 and 64 through `run()`'s replayed
     graphs, with their launches in the device trace as phases 7-11 count
     them, and print the rates beside float32's;
 13. the MOS path, training and serving from given LR arrays: the flagship
     (resnet_spc x4, attention, n_filters 8, n_blocks 6) trained by
     `SupervisedTrainer(data_train_lr=..., data_val_lr=..., data_test_lr=
     ..., time_metadata=...)` on phase 10's 256 HR grids (as temperatures)
     and LR grids that are their inter_area coarsening plus noise, with 2
     statics, a predictor at LR, daily time metadata (all four seasons) and
     the port's StandardScaler: one batch held against the given LR crop
     and the samples' seasons (8 LR channels, 6 aux), 2 epochs of 20 steps
     with validation and test through `run()`'s replayed graphs with K1's
     launches both ways counted in the device trace, finite losses, the
     speed, 8 replayed steps against 8 eager ones bit for bit (phase 11's
     helper), 3 steps at batch 16 against the CPU in float64; then
     `predict(array_in_hr=False)` of 16 LR grids of 128x128 into 512x512 at
     batch 8 with statics, a predictor, time metadata and the scaler (K1 14
     launches), grid 0 against the CPU, again with pad_to_multiple=48; and
     `compute_metrics(y_true, y_hat, save_path=None)` on the served grids
     on the card: K6 launched once, the per-grid SSIM against the plain
     ssim in float64, the PSNR, the maps against device='cpu', K6 timed at
     [16, 512, 512, 1];
 14. the pre-upsampled models and the 'rc' and 'dc' heads: BASELINE
     configs 1 and 3 (convnet_pin: n_blocks 6; unet_pin: n_blocks 4, the
     'rc' decoder; n_filters 8) trained as phase 10 with mae: K1 held and
     timed at the step's gate (the output head's, [128, 64, 64, 8]) both
     ways and in the mixed mode, 2 epochs of 20 steps with validation and
     test through `run()`'s replayed graphs with K1's launches both ways in
     the device trace, finite losses, the speed, 3 steps against the CPU in
     float64, 8 replayed steps against 8 eager ones bit for bit, then 2
     epochs in bfloat16; `predict` of each trained model on 16 HR grids of
     128x128 at batch 8 (K1 2 launches), the U-Net also on grids of
     100x100 (max-pool floors, pad_concat pads), grid 0 against the CPU,
     and the same weights in bfloat16 by the mean criterion; then
     `predict` of net_postupsampling('resnet', 'rc' | 'dc', x4, n_blocks
     6, attention) on 16 LR grids of 128x128 into 512x512 (K1 14
     launches) and of recnet_postupsampling('resnet', 'dc', time_window=4)
     on 19 grids (K2 48 launches), grid 0 against the CPU;
 15. train-mode state, ConvNeXt and the localized layer, at the bench's
     full width (n_filters 8, n_blocks 6, scale 4): (a) net_postupsampling(
     'convnext', 'spc', localcon_layer=True) with 2 statics and a
     predictor, trained on whole 128x128 grids (the localized weights fix
     the grid) at batch 32 for 2 epochs of 10 steps with validation and
     test through `run()`'s replayed graphs, K1's launches both ways in the
     device trace, finite losses, the speed, 3 steps at batch 4 against
     the CPU in float64 (the third step's parameters also held to 4x the
     CPU's own float32 run), 8 replayed steps against 8 eager ones bit for
     bit, 2 epochs in bfloat16, and `predict` of 16 grids at batch 8 (K1 2
     launches), grid 0 against the CPU in float64; (b) the flagship with
     bn, 'mcdrop' dropout at 0.2 and an EMA of 0.999, trained as phase 10
     with mae but for 2 epochs of 10 steps, as are (a) and (c) (the CPU
     steps consume the masks the card drew, through
     `_dropout_mask`; the running statistics compared with the
     parameters), replayed against eager bit for bit with dropout on, then
     `predict` twice (the same bits: one fixed member) and
     `predict_mc(n_members=8)` of 16 LR grids of 128x128 at batch 8 (K1 14
     launches a member, the members differing, std > 0, one seed the same
     bits twice); (c) recresnet_spc (T 4, n_blocks 2) with ln and
     'mcspatialdrop' at 0.2 trained as phase 7 (K2 and K3 counted against
     `dispatch_info`, the CPU steps on the card's masks), then
     `predict_mc(n_members=4, time_window=4)` on 19 grids (K2 48 launches a
     member);
 16. CGAN training, BASELINE config 5: (a) bench_suite.py's
     cgan_resnet_spc_4x (G resnet_spc x4 with n_filters 8, n_blocks 6 and
     attention; D n_filters 32, 4 residual blocks) trained by
     `CGANTrainer.run()` on phase 7's data for 2 epochs of 10 fused G+D
     steps replayed as a captured CUDA graph, under torch.profiler: K1's
     launches both ways in the device trace (G's 7 gates a step each way,
     and the test loss's eager gates), finite losses, the speed; 3 steps
     at batch 4 against the CPU in float64 on the card's dropout masks; 8
     replayed steps against 8 eager ones bit for bit; the same 2 epochs in
     bfloat16; `predict(trainer)` (the raw generator) of 16 LR grids of
     128x128 into 512x512 against the CPU, the float32-trained weights in
     bfloat16 by the mean, the bfloat16-trained weights in float32; (b)
     the spatio-temporal pair (recresnet_spc with n_filters 8, T 4; D with
     its recurrent layer-norm stem and attention) trained the same way for
     2 epochs of 10 steps, K1 in D's gates and K2's training variant and
     K3 in G and D's stem counted against `dispatch_info`'s routes, D's
     gates and stem layers held against their plain versions and timed
     first, 3 steps at batch 2 against the CPU; (c) checkpoints every
     epoch with an EMA, `load_checkpoint` giving the trained generator's
     output and D's weights, and a resumed run;
 17. the rest of the spatio-temporal zoo and the streaming tier: (a)
     recresnet_pin x4 (`SupervisedTrainer('resnet', 'pin', scale=4,
     time_window=4, patch_size=64, batch_size=128, n_filters=8, n_blocks=6,
     loss='mae')` on phase 7's data), whose 14 ConvLSTM layers run on the
     64x64 HR frames: each layer's route printed (float32 and bfloat16), K2's
     training variant and K3 held against their plain versions and timed at
     its three HR layer shapes, 2 epochs of 10 steps through `run()`'s
     replayed graphs with K2, K3 and K4 counted in the device trace against
     `dispatch_info`'s routes, finite losses, the speed, the peak device
     memory, 3 steps at batch 8 against the CPU in float64, 2 epochs in
     bfloat16, `predict(time_window=4)` of 19 HR grids of 128x128 (K2 112
     launches) against the CPU, K2 at its serving layers held and timed;
     (b) recconvnet_spc and recdensenet_spc (phase 7's configuration with
     the merge swapped) trained the same way for 2 epochs of 10 steps, 3
     steps against the CPU, served on 19 LR grids; (c) the streaming tier
     (`data_in_hbm=False`) at STREAM.json's size, the flagship on 1024
     grids of 128x128: the native host library loaded, three batches
     streamed through the pinned slots equal to `BatchSynthesizer.build` at
     the same indices and offsets, a batch's gather + crop (host clock) and
     copy to the card (CUDA events) from host RAM and from a memmapped
     .npy (kept a view), `run()` from host RAM, from the memmap and in
     device memory with the replayed patches/s and the device's busy share
     of each tier, 8 streamed steps through `run()`'s graph bit for bit
     against 8 eager steps with K1's launches in the device trace, then
     CGAN (a) and recresnet_pin streamed for one epoch of 4 steps with their
     launches in the device trace;
 18. one-card parallelism: (a) the flagship (bench.py's widths, attention)
     served by `predict(tile=128, halo=32, batch_size=8)` on 2 grids of
     the 0.25-degree global ERA5 grid (721x1440 LR, HR grids coarsened on
     the card; 72 windows of 192x192 a grid, the clipped border windows
     included): K1's launches (7 a dispatch, no backward), the output's
     shape, grids/s on the host clock and a dispatch's forward on CUDA
     events, grid 0 against the same tiled call on the CPU (TF32 off) and
     the attention-free twin tiled against untiled on the card, within
     1e-4; K1 at the window gates against its plain version and timed; (b)
     recresnet_spc (T 4) with tile 128 and halo 64 on 5 grids: K2's
     launches (24 a dispatch), the speed, the attention-free twin tiled
     against untiled, K2 at the [8, 4, 256, 256, C] window layers held and
     timed; (c) a 4-member ensemble of the flagship
     (`parallel.init_ensemble`, `make_ensemble_step`, `predict_ensemble`)
     on phase 10's data: 3 steps (bootstrap off) and one dssim_mae step at
     batch 16 against the port's CPU ensemble step in float64 at phase 7's
     tolerances (K1 one member-mode launch a gate each way, K6 one a member
     each way), 3 bootstrapped steps from 4 copies of one member (finite,
     the members part), 10 eager steps at batch 128 (member-patches/s
     beside 4x phase 12's single model; K1 7 launches a step each way),
     `predict_ensemble` of 16 grids (K1 7 launches; two members against
     the member served alone) fed to `compute_prob_metrics`; (d) K1's
     member mode alone at [512, 16, 16, 8] and [64, 128, 128, 8], float32
     and the mixed mode, forward and backward: the bits of 4 one-member
     launches, the per-member plain version's values, timed against it
     and the byte bound;
 19. frozen serving artifacts and the HTTP model server: (a) the flagship
     (phase 3's model and grids) exported by `save_serving_artifact` with
     a symbolic batch (7 `dl4ds_tpu_torch.channel_attention` nodes in its
     graph), loaded by `serve.ModelServer` and called at batches 1, 8 and
     13 with pow2 padding off and on: K1 7 launches a device batch, the
     output within 1e-5 of max |y| of `predict` on the same grids (TF32
     off), the artifact call timed on CUDA events; (b) the same artifact
     over HTTP on 127.0.0.1: 64 one-grid npz requests from 8 client
     threads under eager micro-batching (`batch_window_ms=2`), each answer
     within 1e-5 of max |y| of the in-process one, requests/s, p50 and p99
     latency, device batches and the mean merge size; one npy request and
     one JSON request to an aux-free flagship artifact (an npy body
     carries no aux), bit for bit against the in-process answers; (c)
     recresnet_spc (phase 5's model and grids) exported with a symbolic
     batch and with batch 8 (6 `dl4ds_tpu_torch.convlstm` nodes), served
     on its 16 windows: K2 T launches a layer a device batch, the output
     against `predict(time_window=4)`; (d) the bfloat16 flagship's
     artifact against bfloat16 `predict` by phase 12's mean criterion, its
     7 K1 nodes in the mixed mode; then K1 (float32 and mixed) and K2
     through their operators at the shapes of an artifact call at batch 8,
     against their plain versions and timed;
 20. int8 post-training quantization: (a) K7 (the int8 convolution,
     csrc/conv_int8.cu, one fused launch a site: the float input's
     quantization, the sums, the rescale and the bias) held against its
     plain version at every site of the flagship's int8 forward at batch 8
     (phase 3's grids), of the same flagship in bfloat16 (bfloat16
     inputs), of the width-64 flagship, of recresnet_spc and of a tiled
     window dispatch, and at the extra sites: a width-64 3x3, a depthwise
     7x7, a transposed 'dc' site and eight that take the dense kernel's
     other routes (at the flagships' and the extra sites the fused
     float32 and bfloat16 outputs bit for bit and the int32 sums of the
     int8 codes, on the other paths the output in the model dtype); the
     checked launches required to take between them every route of the
     dense kernel (`launch_plan`: TMA over NHWC or over rows of (w, c),
     cp.async, plain loads; each epilogue; a resident and a streamed
     weight; ldmatrix or not); each distinct site of the two flagships
     and the extra sites timed (40 CUDA-event
     medians, L2 flushed) against the plain version, its bounds (int8
     tensor cores, HBM: the float input read once, and beside it the int8
     codes' bound of the unfused form), torch._int_mm on the unfolded
     matrix of the site's codes (the unfold beside) and cuDNN's bfloat16
     convolution at the site, with the launch's plan (`launch_plan`); (b)
     the flagship's `predict(quantize='int8')`
     on phase 3's grids (K7 its sites a batch, K1 7 a batch and 7 in the
     calibration forward; in a device trace the int8 forward's kernels a
     batch, and its site modules called alone one kernel each, K7's; the
     same for the bfloat16 flagship, its first batch against its quantized
     forward) and 'weight-only' (no K7), the card's activation
     scales against the port's own calibration on the CPU (rtol 1e-4),
     one sample's output against the card's quantized network run on the
     CPU (within 5% of the CPU's own int8 error), and int8, weight-only,
     float32
     and bfloat16 `predict` in grids/s; (c) the same four rates at width
     64; (d) recresnet_spc's int8 `predict` on phase 5's grids (K2's
     inference launches, K7's, a window against the CPU); (e) the int8
     flagship tiled on one 0.25-degree global grid (K7 its sites a
     dispatch, grids/s); (f) an int8 artifact at batch 8 saved, loaded and
     served by `serve.ModelServer` (K7 and K1 launches a device batch, the
     output within 1e-5 of max |y| of (b)'s `predict`);
 21. the command-line app on the flagship: (a) phase 10's data written as
     a data module and a flag file (bench.py's flagship at full width,
     `--loss=dssim_mae --debug`: 2 epochs of 6 steps at batch 128, the
     test phase on 16 HR grids of 128x128, `--nometrics`, an int8 artifact
     at batch 8) run in process through `app.main(argv)` under
     torch.profiler with every launch counter at 0 just before: the
     training graphs' K1 and K6 launches both ways in the device trace and
     the wrappers' calls as phase 10 counts them, plus the test phase's
     and the int8 calibration's eager gates; finite losses; the test
     phase's y_hat.npy equal to `predict` of the saved model on the same
     grids at the same batch; the int8 artifact served by
     `serve.ModelServer` on 8 grids (K7 its sites, K1 7, every K7 call held
     against its plain version and timed) within 1e-5 of max |y| of
     `predict(quantize='int8')` on the same calibration; (b) `python -m
     dl4ds_tpu_torch.app --notrain --trained_model_path=... --test` in a
     subprocess, its y_hat.npy equal to (a)'s; (c) `ops.flops.count_flops`
     of the flagship's dssim_mae training step at batch 16, its forward at
     batch 8 and recresnet_spc's training step at batch 16 on the card and
     on the CPU, equal, and the flagship step's FLOPs at batch 128 over one
     replay of (a)'s graph (CUDA events): its FLOP/s and share of the
     float32 and TF32 peaks. PyTorch's default TF32 settings throughout,
     which the subprocess runs with;
 22. data parallelism over processes, at the card's count of one: an NCCL
     process group of one rank (`distributed.initialize`, tcp on
     127.0.0.1) and `distributed.global_mesh()`; phase 10's flagship
     (dssim_mae), the same with bn, and phase 7's recresnet_spc trained by
     `SupervisedTrainer(mesh=mesh)` and without a mesh from one seed (2
     epochs of 10 steps, 5 for recresnet_spc, cuDNN deterministic), each
     under torch.profiler with every launch counter at 0 just before: K1,
     K6, K2-train and K3 counted in the device trace and the wrappers'
     calls as phases 7 and 10 count them, the same in both runs; fithist,
     test_loss and every parameter and buffer equal bit for bit (the bn
     run within rtol 1e-6 if not); one replay of each step traced: the
     mesh step's device work beyond the plain step's printed by name, which
     must hold NCCL's kernel (the gradients' average, captured in the
     graph; at one rank NCCL's sums and extremes run nothing on the
     device); both replays timed (median of 20, CUDA events) beside the
     card's name and power limit; the process group destroyed;
 23. the rest of data parallelism over processes, at the card's count of
     one, in a fresh NCCL group of one rank: (a) phase 16's flagship CGAN
     with a dssim_mae pixel loss trained by `CGANTrainer(mesh=mesh)` and
     without a mesh (2 epochs of 10 steps at batch 128, cuDNN
     deterministic), each traced with every launch counter at 0 just
     before: K1 and K6 both ways in the trace and the wrappers' calls, the
     same in both runs; the four losses, the test loss and G's and D's
     parameters equal bit for bit; NCCL's kernels in one replay of the
     mesh step by name (the one average of G's and D's gradients); both
     replays timed; (b) `predict(mesh=)` of phase 12's flagship (16 grids)
     and recresnet_spc (19) in float32, K1 and K2 launches counted, equal
     bit for bit to `predict`; (c) `predict_tiled(mesh=)` of the flagship
     on one 0.25-degree grid (phase 18's), float32 and int8, launches of K1
     and K7 counted, equal bit for bit to the call without a mesh, and K7
     at the window dispatch's sites held against its plain version and
     timed; (d) a 4-member flagship ensemble trained (3 bootstrapped steps
     at batch 128) and served under an ('ensemble',) mesh of 1 and an
     ('ensemble', 'data') mesh of (1, 1), K1's member-mode launches
     counted, losses, stacks and members equal bit for bit to the run
     without a mesh; the process group destroyed;
 24. spatial parallelism at the card's count of one: (a) K1's band mode
     (the gate on a band of rows with its mean over the whole grid, two
     launches each way between which the ranks all-reduce [B, C] vectors)
     at the flagship training step's 7 gates and the 7 serving gates, each
     image cut into 2 and 4 bands in one process with the partial sums
     added in place of the all-reduces: forward and backward against the
     plain version in float64 and against fused K1 on the whole image
     (f32), the mixed mode against its plain version on the same bands,
     the same bits twice; timed at one band (the card's count) against
     the plain version and fused K1, the bound by bytes; (b) phase 10's
     flagship (dssim_mae) and phase 7's recresnet_spc trained by
     `SupervisedTrainer(mesh=distributed.spatial_mesh(1, 1))` over a fresh
     NCCL group of one rank and without a mesh (2 epochs of 4 and 3 steps,
     cuDNN deterministic), each traced with every launch counter at 0 just
     before: the band mode's stages (two a gate each way), K6, K2-train
     and K3 in the trace and the wrappers' calls; losses and parameters
     within SP_RTOL of the run without a mesh (the band mode sums in the
     stream regime's order, the convolutions take their halo rows); NCCL's
     kernels in one replay of the mesh step by name; both replays timed;
     (c) `predict(spatial_mesh=)` of the flagship without aux inputs on 4
     grids at one rank against `predict`, and
     `make_spatial_sharded_step`'s loss and gradients at one rank against
     the plain ones; the process group destroyed;
 25. tensor and pipeline parallelism at the card's count of one: (a) phase
     10's flagship (dssim_mae) and phase 7's recresnet_spc trained by
     `SupervisedTrainer(mesh=distributed.tensor_mesh(1, 1))` over a fresh
     NCCL group of one rank and without a mesh, as phase 24 (b) (every
     tensor rule routes at one rank: column-parallel convs, the gate and
     the ConvLSTM layers on gathered weights, K1 fused and K2-K4 as
     without the mesh); (b) `make_tensor_sharded_step` at one rank against
     the plain loss and gradients, its K1 launches; (c) the pipeline's
     stage program (`parallel._pipeline_trunk_local`: NCCL takes no two
     ranks on one card, and a pipeline of one stage is refused) of
     recresnet_spc at widths 8 and 64, 2 stages of one trunk block, 2
     microbatches of 64 at the training batch: its K2-train, K3 and K4
     launches against the routes' count (the stem on the batch, each
     trunk block once a microbatch) and K2-train's by (tick, stage); the
     loss and gradients against the card's unpipelined step and, at batch
     4, the unpipelined program in float64 on the CPU; a microbatch's
     trunk layers held against their plain versions and timed (K2-train
     and K3, or K4 at width 64); the process group destroyed;
 26. recurrent deep ensembles: BASELINE config 4 (recresnet_spc x4, T 4,
     n_blocks 2, n_filters 8) as a 4-member ensemble. (a) the member mode
     of K2 (both variants), K3 and K4 at the step's layers on 4 members of
     128 samples (16x16 frames), widths 8 ('fused': K3) and 64 ('split':
     K4), float32 and bfloat16: each call the bits of 4 one-member
     launches, its launches those of one member's call, against the plain
     version run member by member (float32 as phase 6, bfloat16 as phase
     12), float32 timed beside one member's launch; (b) 3 ensemble steps
     on the card (TF32 off, PyTorch's own convolutions) against the CPU in
     float64, K2-train's and K3's launches a step those of one model's
     step; (c) member-patches/s of eager bootstrapped steps at batch 128
     beside one model's eager step, 2 steps at width 64 (K4's launches),
     and `predict_ensemble` of 16 windows of 128x128 (19 grids), K2's
     launches one a layer-step, two members against the member served
     alone; (d) the ('ensemble',) mesh of one NCCL rank against no mesh,
     bit for bit; the process group destroyed;
 27. print the `kernels` JSON line, then, last, the device JSON line. In
     the `kernels` line, `launches` of a training kernel (K2_convlstm_train,
     K3, K4, K1_channel_attention_train, K6, K1_channel_attention_mos_train,
     K1_channel_attention_convnet_pin_train,
     K1_channel_attention_unet_pin_train,
     K1_channel_attention_convnext_train, K1_channel_attention_bn_train,
     K2_convlstm_train_ln_dropout, K3_convlstm_bptt_ln_dropout,
     K1_channel_attention_cgan_train, K1_channel_attention_cgan_disc_train,
     K2_convlstm_train_cgan, K3_convlstm_bptt_cgan,
     K2_convlstm_train_recnet_pin, K3_convlstm_bptt_recnet_pin,
     K2_convlstm_train_recconvnet, K3_convlstm_bptt_recconvnet,
     K2_convlstm_train_recdensenet, K3_convlstm_bptt_recdensenet,
     K1_channel_attention_stream_train, K1_channel_attention_dp_train,
     K6_ssim_dp_train, K2_convlstm_train_dp, K3_convlstm_bptt_dp,
     K1_channel_attention_cgan_dp_train, K6_ssim_cgan_dp_train,
     K1_channel_attention_band_train, K6_ssim_space_train,
     K2_convlstm_train_space, K3_convlstm_bptt_space,
     K1_channel_attention_model_train, K6_ssim_model_train,
     K2_convlstm_train_model, K3_convlstm_bptt_model) is what
     the device trace of its
     phase's run holds, and `wrapper_calls` what its wrapper
     counted (the warm-up calls and the capture: a replay calls no
     wrapper; a CGAN run's eager test loss adds to both); the serving
     kernels (K1_channel_attention, K2_convlstm,
     K1_channel_attention_mos_serve, K1_channel_attention_pin_serve,
     K1_channel_attention_rc_dc_serve, K1_channel_attention_convnext_serve,
     K1_channel_attention_mc_serve, K2_convlstm_mc_serve,
     K1_channel_attention_cgan_serve, K2_convlstm_recnet_pin_serve,
     K1_channel_attention_tiled_serve, K2_convlstm_tiled_serve,
     K1_channel_attention_member_serve,
     K1_channel_attention_artifact_serve,
     K1_channel_attention_artifact_bf16_serve, K2_convlstm_artifact_serve,
     K1_channel_attention_dp_predict, K2_convlstm_dp_predict,
     K1_channel_attention_dp_tiled, K7_conv_int8_dp_tiled),
     K6_ssim_metrics and the ensemble
     step's kernels (K1_channel_attention_member_train, K6_ssim_ensemble,
     K1_member_dp_ensemble)
     and K7_conv_int8 (its `launches_other_paths` beside) and
     K7_conv_int8_cli_artifact run eagerly, and their `launches` are their
     wrappers' counts; K1_channel_attention_cli_train and
     K6_ssim_cli_train count phase 21 (a)'s device trace, eager launches
     included; K2_convlstm_train_pipe, K3_convlstm_bptt_pipe and
     K4_convlstm_seq_pipe count phase 25 (c)'s wrapper calls, eager;
     K2_convlstm_member_train, K3_convlstm_bptt_member and
     K4_convlstm_seq_member phase 26 (c)'s eager ensemble steps, and
     K2_convlstm_member_serve its `predict_ensemble`.

Imports nothing of JAX. Weights come from the port's own seeded init.
"""

import contextlib
import copy
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
# 3xTF32: three TF32 products for each float32 one, at the 495 TFLOP/s of
# dense TF32 on the tensor cores (K2's products)
TF32X3_FLOPS = 495e12 / 3
BATCH = 8
LR, SCALE = 128, 4
N_FILTERS, N_BLOCKS = 8, 6
N_GRIDS = 16
# per-sample gate shapes (H, W, C) of one flagship forward: six residual
# blocks at LR, then the output head at HR
K1_SHAPES = ([(LR, LR, N_FILTERS * (i + 1)) for i in range(N_BLOCKS)]
             + [(LR * SCALE, LR * SCALE, N_FILTERS)])
K1_TOL = {'float32': dict(atol=1e-5, rtol=0.0),      # f32 sum order only
          'bfloat16': dict(atol=1e-6, rtol=1e-2)}    # ~2 bf16 ulps
# K1's backward against `_channel_attention_backward` run in float64 on the
# same inputs: each gradient's max |d| within K1_BWD_TOL of its max |ref|
# (float32 sums over up to 512*512 pixels and 128 samples); a bfloat16 dx is
# rounded to bfloat16, half an ulp: up to BF16_RTOL of |ref| more
K1_BWD_TOL, BF16_RTOL = 1e-5, 2.0 ** -8
# The serving head's weight gradients (K1_SHAPES[-1] at batch 8) sum 8
# per-sample terms of about +-300 to a few units (db1 3.5), so the terms'
# float32 rounding exceeds K1_BWD_TOL of max |ref| (float32 db1 4.6e-5 from
# float64 on the H100); there the scale is the largest sum of the samples'
# terms in magnitude (`_check_k1_backward`), both readings printed.
K1_CANCELLING = (BATCH,) + K1_SHAPES[-1]
# K1's other paths, ((B, H, W, C), Cr): H*W*C not a multiple of a 16-byte
# pack (4-byte copies), samples of 35 and 561 pixels, a channel
# count whose pack period passes the block's 512 threads (a thread sums a
# whole channel), Cr 1; float32 and bfloat16 each, with the weights at the
# model's Glorot scale (at 0.5, C = 1030 puts the gate's pre-activations in
# the hundreds, where two float32 orders of its 1030-term dot products
# already differ by more than K1_TOL)
K1_OTHER_PATHS = [((3, 5, 7, 5), 2), ((1, 33, 17, 3), 1),
                  ((1, 4, 4, 1030), 257), ((2, 9, 9, 600), 150)]
# the regimes of K1's launch plan (`_ca_plan`), every one of which phase 2
# must run, and the kernel launches a call of each makes, each way
CA_REGIMES = {'block': 1, 'stream': 2}
# GPU (TF32 off) vs CPU forward of the whole model: f32 convs summed in
# other orders over ~20 layers, as in the CPU parity tests against JAX
PREDICT_TOL = dict(atol=1e-4, rtol=1e-4)
# spatio-temporal path: recresnet_spc x4 (BASELINE config 4), 2 recurrent
# blocks after the stem, 16 windows of 4 from 19 grids
REC_T, REC_BLOCKS, REC_GRIDS = 4, 2, 19
# (Cin, F, k) of the six ConvLSTM layers of one forward: the stem block
# takes the grid and the predictor, every block is a 5x5 then a 3x3 layer
K2_LAYERS = [layer for cin in [2] + [N_FILTERS] * REC_BLOCKS
             for layer in ((cin, N_FILTERS, 5), (N_FILTERS, N_FILTERS, 3))]
K2_WIDE = [(64, 64, 5), (64, 64, 3)]    # production width, bench_suite.py
K2_WIDE_LR = 32
# (B, T, H, W, Cin, F, kh, kw) of the kernel's other paths: T = 1 (the input
# launch alone), 1x3 and 7x7 kernels, channel counts that are not multiples
# of 4 (4-byte copies), frames of 5x7 and 17x17 (pixel counts that are not
# a multiple of the tile) and wider than a tile, Cin 1 and 2 (one k-step a
# stage), F 4, 5, 12 and 72 (channels past F in the last slice). With the
# shapes above they run both channel slices (8 and 16 channels a block),
# both chunk widths and both stage depths of the launch plan.
K2_OTHER_PATHS = [(2, 1, 9, 41, 3, 6, 1, 3), (4, 1, 16, 16, 8, 72, 5, 5),
                  (8, 3, 72, 100, 4, 4, 5, 5), (8, 3, 72, 100, 5, 5, 7, 7),
                  (8, 2, 40, 40, 6, 12, 3, 3), (4, 3, 5, 7, 1, 4, 3, 3),
                  (4, 3, 17, 17, 2, 5, 5, 5), (64, 2, 17, 17, 1, 12, 5, 5),
                  (16, 3, 5, 7, 2, 72, 3, 3), (32, 2, 16, 16, 64, 72, 5, 5),
                  (128, 2, 16, 16, 16, 16, 7, 7)]
# kernel vs plain version with TF32 off: f32 sums in another order. The
# training variant's zs residual (the pre-activations, sums of up to
# kh*kw*(Cin + F) products, printed with their max |zs|) is held to
# K2_TOL times max(1, max |zs|)
K2_TOL = 1e-5
# training path: recresnet_spc x4 trained as bench_suite.py's
# measure_supervised does (256 grids of 128x128, 64x64 HR patches, batch
# 128, mae), float32; 2 epochs of 20 steps, 2 validation and 2 test steps
TRAIN_GRIDS, TRAIN_HR, TRAIN_PATCH, TRAIN_BATCH = 256, 128, 64, 128
TRAIN_LR = TRAIN_PATCH // SCALE
TRAIN_EPOCHS, TRAIN_STEPS, TRAIN_VAL_STEPS, TRAIN_TEST_STEPS = 2, 20, 2, 2
# the K1 gates of a flagship training step (batch 128, 16x16 LR patches):
# six residual blocks at C = 8..48, then the 64x64x8 head; phase 10 checks
# them against the model's own gates
K1_TRAIN_SHAPES = ([(TRAIN_BATCH, TRAIN_LR, TRAIN_LR, N_FILTERS * (i + 1))
                    for i in range(N_BLOCKS)]
                   + [(TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, N_FILTERS)])
# (Cin, F, k) of the six ConvLSTM layers of a training step: the stem block
# takes the one grid channel (no predictors, no statics)
K3_LAYERS = [layer for cin in [1] + [N_FILTERS] * REC_BLOCKS
             for layer in ((cin, N_FILTERS, 5), (N_FILTERS, N_FILTERS, 3))]
# (B, T, H, W, Cin, F, kh, kw, x needs a gradient) of K2-train's and K3's
# other paths: T = 1 (no chain, no dWh), 1x3 and odd F (4-byte copies in
# the chain, dx and weight-gradient tiles), 3x5 with ragged tiles, 5x7 and
# 17x17 frames with Cin 1 and 2 (K2's ragged pixel tiles), two gate chunks
# in the weight gradient (F = 12), 7x7 (4 channels a weight-gradient
# chunk, more than 48 KB of shared memory), 9x9 (two tap chunks), x without
# a gradient (no dx launch), frames wider than a tile, dx at 16 (Cin 13,
# 4-byte copies) and 32 channels a block, and K3's chain at 16, 32 and 64
# channels a block (batch 72: enough blocks to keep them). With the
# training shapes and those of K4 below they run every compiled body of
# the chain-step and dx tile (K3's chain, K4's chain and dx, each at 8,
# 16, 32 and 64 channels a block) and every stage kind of its plan; phase
# 6 checks that (`PLAN_BODIES`).
K3_OTHER_PATHS = [(2, 1, 9, 41, 3, 6, 1, 3, True),
                  (3, 3, 20, 37, 5, 5, 3, 5, True),
                  (4, 3, 5, 7, 1, 4, 3, 3, True),
                  (3, 2, 17, 17, 2, 5, 5, 5, True),
                  (2, 3, 40, 40, 6, 12, 3, 3, True),
                  (2, 2, 19, 23, 8, 4, 7, 7, True),
                  (4, 3, 16, 16, 2, 8, 5, 5, False),
                  (2, 2, 12, 20, 4, 8, 5, 5, True),
                  (8, 2, 72, 100, 4, 4, 5, 5, True),
                  (16, 2, 64, 96, 5, 5, 3, 3, True),
                  (8, 2, 72, 100, 3, 6, 7, 7, True),
                  (2, 2, 12, 12, 8, 8, 9, 9, True),
                  (64, 2, 16, 16, 32, 8, 3, 3, True),
                  (48, 3, 16, 16, 13, 8, 5, 5, True),
                  (72, 2, 16, 16, 8, 16, 5, 5, True),
                  (72, 2, 16, 16, 8, 32, 3, 3, True),
                  (72, 2, 16, 16, 8, 64, 3, 3, True)]
# K3 against its plain version run in float64 on the same inputs (cuDNN's
# float32 weight gradient is itself off by 9e-3 of max |ref| at 5x5 and 64
# channels, TF32 off, deterministic or not; float64 on the card agrees with
# float64 on the CPU within 1e-15), each gradient's max |d| over its max
# |ref|: float32 sums of kh*kw*4F products (dx) or of all B*T*H*W pixels in
# 256-pixel partials (the weights)
K3_DX_TOL, K3_W_TOL = 1e-5, 1e-5
# GPU (TF32 off) against CPU training steps: the losses are means over
# 16*4*64*64 pixels; Adam's update lr*g/(|g|+1e-7) turns a difference of
# 1e-9 in a small gradient into up to 1e-5 in a parameter each step. Every
# training phase holds the GPU, with PyTorch's own convolutions, against
# the CPU in float64: at n_filters 8 too a float32 run is no reference,
# since the CPU's float32 run ends 1.7e-4 from float64 after 3 steps while
# the GPU's, with K2's 3xTF32 products, ends 1.6e-7 from it (3.7e-7 with
# cuDNN; tools/torch_train_parity.py --width 8 --batch 16 on an H100 80GB
# HBM3 at 700 W)
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL = 1e-5, 1e-4
# width-64 training path: bench_suite.py's recresnet_spc_width64 (n_filters
# 64, attention, which adds nothing without aux inputs) trained as phase 7,
# 2 epochs of 10 steps; 3 steps at batch 4 against the CPU in float64, at
# the same tolerances. At width 64 a float32 run is not a reference: Adam's
# lr*g/(|g|+1e-7) turns float32 noise in near-zero gradients into
# parameter differences of up to lr a step, so the CPU's own float32 run
# ends 3.3e-4 from its float64 one; and the GPU's convolutions there are
# PyTorch's own, since cuDNN's float32 ones at 64 channels (TF32 off) put
# the head's parameters 1.2e-3 from float64 (with PyTorch's: 3.0e-5;
# tools/torch_train_parity.py on an H100 SXM at 700 W)
WIDE_F, WIDE_STEPS, WIDE_CPU_BATCH = 64, 10, 4
WIDE_LAYERS = [layer for cin in [1] + [WIDE_F] * REC_BLOCKS
               for layer in ((cin, WIDE_F, 5), (WIDE_F, WIDE_F, 3))]
# (B, T, H, W, Cin, F, kh, kw, x needs a gradient) of K4's other paths: T = 1
# (no recurrent sum, the gate epilogue only), 1x3 with odd F and no dx, 3x5
# with odd F and ragged tiles, F = 12 (two slices of 8 channels), 7x7 with
# F = 4 (half the block's channels past F), F = 16 at 3x3 at batch 16 (8
# channels a block: too few blocks at 16) and 128 (16 a block), F = 32 (32
# a block), F = 72 (slices of 8; at batch 40 two slices of 64 with one tap
# row a stage; also on 17x17 frames with Cin 1, K2's ragged pixel tiles
# feeding it).
K4_OTHER_PATHS = [(2, 1, 9, 41, 3, 6, 3, 3, True),
                  (2, 2, 17, 17, 1, 72, 3, 3, True),
                  (2, 3, 9, 11, 3, 5, 1, 3, False),
                  (3, 3, 20, 37, 5, 5, 3, 5, True),
                  (2, 3, 40, 40, 6, 12, 3, 3, True),
                  (2, 2, 19, 23, 8, 4, 7, 7, True),
                  (16, 4, 16, 16, 16, 16, 3, 3, True),
                  (2, 3, 12, 20, 4, 72, 5, 5, True),
                  (128, 2, 16, 16, 16, 16, 3, 3, True),
                  (128, 2, 16, 16, 8, 32, 5, 5, True),
                  (40, 2, 16, 16, 4, 72, 7, 7, True)]
# the chain-step and dx tile's compiled bodies (kernel: K3's chain, K4's
# chain, dx; channels a block) and its plan's stage kinds (cw, all or one
# tap row), every one of which phase 6 must run
PLAN_BODIES = {(kind, ns) for kind in ('chain', 'split chain', 'dx')
               for ns in (8, 16, 32, 64)}
PLAN_STAGES = {(8, 'all'), (4, 'all'), (8, 'one')}
# K4's dzs against its plain version run in float64, to K2_TOL times
# max(1, max |dzs|); the split route's gradients against the plain BPTT in
# float64 to K3's tolerances (float32 GEMMs over up to 131,072 pixels)
K4_TOL = 1e-5
# fused SSIM (K6): the DSSIM loss's shape in a flagship training step, then
# the kernel's other paths: the minimal image (one output), ragged tiles, a
# full 512x512 grid (many row and column tiles), channels folded into the
# image axis, and a 5-D input; then other filter sizes, (shape, taps,
# sigma): the compiled maximum and a small one
K6_SHAPES = [(TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 1), (1, 11, 11, 1),
             (3, 13, 37, 1), (8, 512, 512, 1), (4, 64, 64, 3),
             (2, 3, 64, 64, 1)]
K6_FILTERS = [((2, 40, 40, 1), 25, 3.0), ((2, 20, 33, 1), 3, 0.8)]
# K6 against its plain version run in float64, per image: float32 sums of
# 11 taps of moments up to max_val^2 and of up to 512*512 SSIM terms
K6_TOL = 1e-5
# K6's backward against `ssim_backward_reference` run in float64: each
# gradient's max |d| within K6_BWD_TOL of its max |ref| (the derivative
# maps divide by B2, small where a patch is flat: relative to max |ref|),
# or within twice the plain version's own float32 error
# (`_check_k6_backward`)
K6_BWD_TOL = 1e-5
# K6's regimes (`_ssim_plan`), each of which phase 9 must run both ways,
# and the launches a call of each makes, forward and backward
SSIM_REGIMES = {('fwd', 'image'): 1, ('fwd', 'tiles'): 1,
                ('bwd', 'image'): 1, ('bwd', 'tiles'): 2}
# the loss through K6 against the plain path: value rtol, gradient atol of
# max |g| (float32 sums in another order)
LOSS_RTOL, LOSS_GRAD_TOL = 1e-5, 1e-4
# flagship training: bench.py's configuration (resnet_spc x4, n_filters 8,
# n_blocks 6, attention) trained with dssim_mae on the data of phase 7; 3
# steps at batch 16 against the CPU in float64, at the tolerances of phase
# 7. A float32 run is no reference here either: with cuDNN's float32
# convolutions (TF32 off) 3 Adam steps end 2.6e-4 from float64 (1.0e-3 with
# mae), with PyTorch's own 4.8e-7, and the CPU's float32 run 9.0e-6 (3.0e-4
# with mae) (tools/torch_train_parity.py --model resnet_spc --batch 16 on an
# H100 SXM at 700 W)
FLAG_LOSS, FLAG_CPU_BATCH = 'dssim_mae', 16


def fail(msg):
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


@functools.cache
def card_line():
    """The card's name and power limit, as nvidia-smi gives them, read
    once: each query starts a process, and the run prints the line beside
    every time."""
    out = subprocess.run(
        ['nvidia-smi', '--id=0', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True, timeout=60)
    return out.stdout.strip()


def device_times(torch, fn, reps=20, l2_flush=None,
                 sleep_cycles=100_000_000):
    """Device times of `reps` calls of fn() in ms, from CUDA events around
    each call. A device sleep of `sleep_cycles` is queued first, so the
    host has enqueued every call before the device reaches them: host
    overhead stays out of the events. With `l2_flush` (a buffer larger
    than L2), it is rewritten before each call, so each call finds its
    input in device memory, not in L2."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(sleep_cycles)
    for start, end in events:
        if l2_flush is not None:
            l2_flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def paired_ms(torch, kernel, plain, l2_flush, **times):
    """Median device ms of the kernel and of its plain version, timed in
    turns (plain, kernel, kernel, plain) so that clock drift falls on both;
    `times` go to `device_times`."""
    p1 = device_times(torch, plain, l2_flush=l2_flush, **times)
    k = (device_times(torch, kernel, l2_flush=l2_flush, **times)
         + device_times(torch, kernel, l2_flush=l2_flush, **times))
    p2 = device_times(torch, plain, l2_flush=l2_flush, **times)
    return statistics.median(k), statistics.median(p1 + p2)


def kernel_launches(torch, lib, fn):
    """The kernels one call of fn() launches, by the kernel library's own
    count of its successful launches (`dl4ds_ca_launched`,
    `dl4ds_ssim_launched`), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    before = lib()
    fn()
    torch.cuda.synchronize()
    return lib() - before


def _gate_case(torch, gen, dev, shape, cr, dtype, glorot=False):
    """x, the gate's weights (float32) and dy for K1 at x's shape; the
    weights' scale 0.5, or with `glorot` that of the model's Glorot init,
    sqrt(2 / (C + Cr))."""
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    scale = (2.0 / (c + cr)) ** 0.5 if glorot else 0.5
    weights = (torch.randn((c, cr), generator=gen, device=dev) * scale,
               torch.randn((cr,), generator=gen, device=dev) * 0.1,
               torch.randn((cr, c), generator=gen, device=dev) * scale,
               torch.randn((c,), generator=gen, device=dev) * 0.1)
    return x, weights, torch.randn(shape, generator=gen, device=dev).to(dtype)


def k1_bwd_bound_ms(x, cr):
    """K1's backward by bytes: x and dy read once, dx written once, and the
    weights and their gradients."""
    c = x.shape[-1]
    return ((3 * x.numel() * x.element_size() + 4 * (2 * c * cr + c + cr))
            / HBM_BYTES_PER_S * 1e3)


def _check_k1_backward(torch, fo, x, weights, dy, label):
    """K1's backward kernel (on the forward kernel's saved mean and gate)
    against `_channel_attention_backward` run in float64 on the same
    inputs, each gradient within K1_BWD_TOL of its scale (a bfloat16 dx
    also within BF16_RTOL of |ref|), and the same bits twice. The scale is
    max |ref|; for the weight gradients at K1_CANCELLING, sums of a term a
    sample that cancel, it is the largest sum of the samples' terms in
    magnitude. Returns {gradient: (max|d| / scale, max|d| / max|ref|)}."""
    _, m, g = fo._launch(x, *weights)
    got = fo._launch_backward(x, *weights, dy, m, g)
    again = fo._launch_backward(x, *weights, dy, m, g)
    x64, dy64 = x.double(), dy.double()
    w64 = [t.double() for t in weights]
    ref = fo._channel_attention_backward(x64, *w64, dy64)
    maxes = [r.abs().max().item() for r in ref]
    scales = list(maxes)
    if tuple(x.shape) == K1_CANCELLING:
        mags = [torch.zeros_like(r) for r in ref[1:]]
        for i in range(x.shape[0]):
            terms = fo._channel_attention_backward(x64[i:i + 1], *w64,
                                                   dy64[i:i + 1])[1:]
            for mag, t in zip(mags, terms):
                mag += t.abs()
        scales[1:] = [t.max().item() for t in mags]
    torch.cuda.synchronize()
    errs = {}
    for name, a, a2, r, scale, biggest in zip(
            ('dx', 'dw1', 'db1', 'dw2', 'db2'), got, again, ref, scales,
            maxes):
        if not torch.equal(a, a2):
            fail(f'K1 backward {label} {name}: two runs gave different bits')
        d = (a.double() - r).abs()
        rtol = BF16_RTOL if name == 'dx' and x.dtype == torch.bfloat16 \
            else 0.0
        if not bool((d <= K1_BWD_TOL * scale + rtol * r.abs()).all()):
            fail(f'K1 backward {label} {name}: max|d| {d.max().item():.3e} '
                 f'against the float64 plain version, scale {scale:.3e} '
                 f'(max|ref| {biggest:.3e}; tolerance {K1_BWD_TOL} of the '
                 f'scale' + (f', rtol {rtol}' if rtol else '') + ')')
        worst = d.max().item()
        errs[name] = (worst / scale if scale else worst,
                      worst / biggest if biggest else worst)
    return errs


def _k1_bwd_errors(errs):
    """`_check_k1_backward`'s readings as text: max|d| over the scale, and
    over max|ref| where the scale differs."""
    return ', '.join(f'{k} {a:.1e}' + (f' ({b:.1e} of max|ref|)'
                                        if b != a else '')
                     for k, (a, b) in errs.items())


def phase_kernels(torch, tds, report):
    """Phase 2: K1 against its plain versions at the path's shapes, forward
    and backward, in every regime of its launch plan."""
    from dl4ds_tpu_torch.ops import fused_ops as fo
    from dl4ds_tpu_torch.ops.fused_ops import FusedChannelAttention
    fca, ref = tds.fused_channel_attention, tds.channel_attention_reference
    dev = torch.device('cuda')
    limits = fo._ca_limits(dev)
    print(f'K1 plan limits: {limits[0]} SMs, {limits[1]} bytes of dynamic '
          f'shared memory a block', flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    cases = []
    for h, w, c in K1_SHAPES:
        cr = max(int(c / 4), 1)
        x32, weights, dy32 = _gate_case(torch, gen, dev, (BATCH, h, w, c), cr,
                                        torch.float32)
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((str(dtype).split('.')[-1], x32.to(dtype), weights,
                          dy32.to(dtype)))

    rows = []
    for name, x, weights, dy in cases:      # every shape checked first
        y = fca(x, *weights)
        y_ref = ref(x, *weights)
        torch.cuda.synchronize()
        if y.shape != x.shape or y.dtype != x.dtype:
            fail(f'K1 {name} {tuple(x.shape)}: got {y.shape} {y.dtype}')
        diff = (y.float() - y_ref.float()).abs()
        tol = K1_TOL[name]
        err = diff.max().item()
        if not bool((diff <= tol['atol']
                     + tol['rtol'] * y_ref.float().abs()).all()):
            fail(f'K1 {name} {tuple(x.shape)}: max|d| {err:.3e} outside '
                 f'atol {tol["atol"]} rtol {tol["rtol"]}')
        bwd_err = _check_k1_backward(torch, fo, x, weights, dy,
                                     f'{name} x{list(x.shape)}')
        plan = fo._ca_plan(tuple(x.shape), weights[0].shape[1], x.dtype,
                           *limits)
        rows.append(dict(dtype=name, shape=list(x.shape),
                         cr=weights[0].shape[1], max_abs_err=err,
                         bwd_rel_err=bwd_err, regime=plan['regime'],
                         parts=plan['parts']))

    for row, (name, x, weights, dy) in zip(rows, cases):   # then timed
        c, cr = x.shape[-1], weights[0].shape[1]
        ms, plain_ms = paired_ms(torch, lambda: fca(x, *weights),
                                 lambda: ref(x, *weights), flush)
        _, m, g = fo._launch(x, *weights)
        bwd_ms, bwd_plain_ms = paired_ms(
            torch, lambda: fo._launch_backward(x, *weights, dy, m, g),
            lambda: fo._channel_attention_backward(x, *weights, dy, m, g),
            flush)
        n_bytes = 2 * x.numel() * x.element_size() + 4 * (2 * c * cr + c + cr)
        n_ops = 2 * x.numel() + 4 * BATCH * c * cr
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS) * 1e3
        row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   library_ms=None, bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
                   bwd_bound_ms=k1_bwd_bound_ms(x, cr))
        print(f'K1 {name:8s} x{row["shape"]} cr={cr:2d} {row["regime"]} '
              f'({row["parts"]} blocks a sample)  max|d| '
              f'{row["max_abs_err"]:.3e}  kernel {ms:.4f} ms  plain '
              f'{plain_ms:.4f} ms  bound {bound_ms:.4f} ms  library_ms null '
              f'(no single PyTorch call computes the gate); backward '
              f'max|d|/scale ' + _k1_bwd_errors(row['bwd_rel_err'])
              + f' (same bits twice)  kernel {bwd_ms:.4f} ms  plain '
              f'{bwd_plain_ms:.4f} ms  bound {row["bwd_bound_ms"]:.4f} ms',
              flush=True)

    # the training gates and the other paths, both dtypes: forward and
    # backward against the plain versions; then every regime's launches
    ran = {}
    other = [(shape, max(int(shape[-1] / 4), 1)) for shape in K1_TRAIN_SHAPES]
    for (shape, cr), dtype in [(case, dt) for case in other + K1_OTHER_PATHS
                               for dt in (torch.float32, torch.bfloat16)]:
        x, weights, dy = _gate_case(torch, gen, dev, shape, cr, dtype,
                                    glorot=(shape, cr) in K1_OTHER_PATHS)
        name = str(dtype).split('.')[-1]
        err = (fca(x, *weights).float() - ref(x, *weights).float()).abs()
        tol = K1_TOL[name]
        if not bool((err <= tol['atol'] + tol['rtol']
                     * ref(x, *weights).float().abs()).all()):
            fail(f'K1 {name} x{list(shape)}: max|d| {err.max().item():.3e}')
        bwd_err = _check_k1_backward(torch, fo, x, weights, dy,
                                     f'{name} x{list(shape)}')
        plan = fo._ca_plan(shape, cr, dtype, *limits)
        ran.setdefault(plan['regime'], (x, weights, dy, plan))
        print(f'K1 {name:8s} x{list(shape)} cr={cr} {plan["regime"]} '
              f'({plan["parts"]} blocks a sample, {plan["vec"]}-element '
              f'packs): max|d| {err.max().item():.3e}; backward '
              + _k1_bwd_errors(bwd_err),
              flush=True)
    for row, (_, x, weights, dy) in zip(rows, cases):
        plan = fo._ca_plan(tuple(x.shape), weights[0].shape[1], x.dtype,
                           *limits)
        ran.setdefault(plan['regime'], (x, weights, dy, plan))
    if set(ran) != set(CA_REGIMES):
        fail(f'phase 2 ran K1 in the regimes {sorted(ran)}, not all of '
             f'{sorted(CA_REGIMES)}')
    lib = fo._ca_lib().dl4ds_ca_launched
    for regime, (x, weights, dy, plan) in sorted(ran.items()):
        _, m, g = fo._launch(x, *weights)
        fwd = kernel_launches(torch, lib, lambda: fo._launch(x, *weights))
        bwd = kernel_launches(
            torch, lib, lambda: fo._launch_backward(x, *weights, dy, m, g))
        print(f'K1 {regime} regime at x{list(x.shape)}: {fwd} forward and '
              f'{bwd} backward kernel launches a call', flush=True)
        if fwd != CA_REGIMES[regime] or bwd != CA_REGIMES[regime]:
            fail(f'K1 {regime} regime launched {fwd} forward and {bwd} '
                 f'backward kernels, expected {CA_REGIMES[regime]} each')

    # gradient: the autograd.Function's backward against autograd through
    # the plain version, on the card
    c, cr = 16, 4
    x = torch.randn((2, LR, LR, c), generator=gen, device=dev)
    params = [torch.randn(s, generator=gen, device=dev) * 0.5
              for s in ((c, cr), (cr,), (cr, c), (c,))]
    dy = torch.randn_like(x)
    leaves = [t.clone().requires_grad_() for t in [x] + params]
    got = torch.autograd.grad(FusedChannelAttention.apply(*leaves), leaves, dy)
    leaves = [t.clone().requires_grad_() for t in [x] + params]
    want = torch.autograd.grad(ref(*leaves), leaves, dy)
    grad_err = 0.0
    for name, g, r in zip(('x', 'w1', 'b1', 'w2', 'b2'), got, want):
        d = (g - r).abs().max().item()
        grad_err = max(grad_err, d)
        if not torch.allclose(g, r, atol=1e-4, rtol=1e-4):
            fail(f'K1 backward d{name}: max|d| {d:.3e}')
    print(f'K1 backward through autograd vs autograd through the plain '
          f'version: max|d| {grad_err:.3e} (atol 1e-4, rtol 1e-4)', flush=True)
    report['k1_rows'] = rows
    report['k1_limits'] = dict(n_sm=limits[0], smem=limits[1])


def phase_predict(torch, tds, report):
    """Phase 3: the main path, full-width predict on the card."""
    import numpy as np
    fca = tds.fused_channel_attention
    model = tds.net_postupsampling(
        'resnet', 'spc', scale=SCALE, n_channels=4, n_aux_channels=2,
        lr_size=(LR, LR), n_filters=N_FILTERS, n_blocks=N_BLOCKS,
        attention=True)
    net = model.init(seed=0, device='cuda')
    rng = np.random.default_rng(0)
    hr_size = LR * SCALE
    hr = rng.standard_normal((N_GRIDS, hr_size, hr_size)).astype('float32')
    topo = rng.standard_normal((hr_size, hr_size)).astype('float32')
    mask = (rng.random((hr_size, hr_size)) > 0.5).astype('float32')
    pred = rng.standard_normal((N_GRIDS, hr_size, hr_size, 1)).astype(
        'float32')
    kwargs = dict(scale=SCALE, array_in_hr=True, static_vars=[topo, mask],
                  predictors=[pred], batch_size=BATCH)

    fca.launches = fca.bwd_launches = 0
    y = tds.predict((model, net), hr, **kwargs)
    launches, bwd_launches = fca.launches, fca.bwd_launches
    expected = len(K1_SHAPES) * (-(-N_GRIDS // BATCH))
    print(f'predict: {model.param_count(net)} parameters, output '
          f'{y.shape}, K1 launches {launches} (expected {expected}), K1 '
          f'backward launches {bwd_launches} (expected 0)', flush=True)
    if y.shape != (N_GRIDS, hr_size, hr_size, 1):
        fail(f'predict output shape {y.shape}')
    if not np.isfinite(y).all():
        fail('predict output is not finite')
    if launches != expected:
        fail(f'K1 launched {launches} times on the main path, expected '
             f'{expected}')
    if bwd_launches != 0:
        fail(f"K1's backward launched {bwd_launches} times while serving")
    report['k1_launches'] = launches
    report['k1_bwd_launches'] = bwd_launches

    t0 = time.perf_counter()
    tds.predict((model, net), hr, **kwargs)
    predict_s = time.perf_counter() - t0
    x = torch.randn((BATCH, LR, LR, 4), device='cuda')
    aux = torch.randn((BATCH, hr_size, hr_size, 2), device='cuda')
    with torch.inference_mode():
        fwd_ms = statistics.median(
            device_times(torch, lambda: net(x, aux), reps=10))
    card = torch.cuda.get_device_name(0)
    print(f'predict {N_GRIDS} grids 512x512 at batch {BATCH} (TF32 convs, '
          f'the default): {N_GRIDS / predict_s:.2f} grids/s end to end '
          f'(host clock, data assembly and copy out included); forward '
          f'alone {fwd_ms:.3f} ms = {BATCH / fwd_ms * 1e3:.2f} grids/s '
          f'(CUDA events); {card}', flush=True)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    y32 = tds.predict((model, net), hr, **kwargs)
    net_cpu = copy.deepcopy(net).cpu()
    y_cpu = tds.predict((model, net_cpu), hr[:1], device='cpu',
                        **dict(kwargs, predictors=[pred[:1]]))
    diff = np.abs(y32[0] - y_cpu[0])
    err = float(diff.max())
    ok = bool((diff <= PREDICT_TOL['atol']
               + PREDICT_TOL['rtol'] * np.abs(y_cpu[0])).all())
    print(f'predict grid 0, GPU (TF32 off) vs CPU: max|d| {err:.3e}, '
          f'max|y| {float(np.abs(y_cpu).max()):.3e} (atol '
          f'{PREDICT_TOL["atol"]}, rtol {PREDICT_TOL["rtol"]})', flush=True)
    if not ok:
        fail(f'predict on the GPU disagrees with the CPU: max|d| {err:.3e}')
    report.update(predict_grids_per_s=N_GRIDS / predict_s,
                  forward_ms=fwd_ms)


def k2_work(x, wx, wh):
    """(flops, bytes) a ConvLSTM layer needs: the input conv at every step,
    the recurrent conv from the second step on (h_{-1} = 0), x and the
    weights read once, ys written once. K2's bound_ms counts these flops
    at the float32 rate outside the tensor cores, as every kernel's does;
    `bound_3xtf32_ms` at the 3xTF32 rate its products run at."""
    b, t, h, w, cin = x.shape
    kh, kw, _, f4 = wx.shape
    flops = 2 * b * h * w * kh * kw * f4 * (t * cin + (t - 1) * (f4 // 4))
    n_bytes = 4 * (x.numel() + wx.numel() + f4 + wh.numel()
                   + b * t * h * w * f4 // 4)
    return flops, n_bytes


def phase_convlstm(torch, tds, report):
    """Phase 4: K2 against its plain version with TF32 off, at the layer
    shapes of the recresnet_spc forward and at width 64."""
    from dl4ds_tpu_torch.models.blocks import ConvLSTM2D
    from dl4ds_tpu_torch.ops.convlstm import _fwd_plan
    fcl, ref = tds.fused_convlstm, tds.convlstm_reference
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    cases = [(shape, LR) for shape in dict.fromkeys(K2_LAYERS)]
    cases += [(shape, K2_WIDE_LR) for shape in K2_WIDE]
    rows = []
    for i, ((cin, f, k), size) in enumerate(cases):
        layer = ConvLSTM2D(cin, f, (k, k))      # Keras init: glorot, orth.
        layer.reset_parameters(torch.Generator().manual_seed(i))
        wx, bx, wh = (p.detach().to(dev) for p in (
            layer.input_conv.kernel, layer.input_conv.bias,
            layer.cell.recurrent_conv.kernel))
        x = torch.randn((BATCH, REC_T, size, size, cin), generator=gen,
                        device=dev)
        with torch.no_grad():
            ys = fcl(x, wx, bx, wh)
            want = ref(x, wx, bx, wh)[0]
        torch.cuda.synchronize()
        err = (ys - want).abs().max().item()
        if ys.shape != want.shape or not err <= K2_TOL:
            fail(f'K2 x{list(x.shape)} F={f} k={k}: shape {tuple(ys.shape)}, '
                 f'max|d| {err:.3e} against atol {K2_TOL}')
        with torch.no_grad():
            ms, plain_ms = paired_ms(torch, lambda: fcl(x, wx, bx, wh),
                                     lambda: ref(x, wx, bx, wh), flush)
        flops, n_bytes = k2_work(x, wx, wh)
        bound_ms = max(flops / F32_FLOPS, n_bytes / HBM_BYTES_PER_S) * 1e3
        bound_3x = max(flops / TF32X3_FLOPS, n_bytes / HBM_BYTES_PER_S) * 1e3
        rows.append(dict(x=list(x.shape), f=f, k=k, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_3xtf32_ms=bound_3x, gflop=flops / 1e9,
                         bound_by=('operations' if flops / F32_FLOPS
                                   >= n_bytes / HBM_BYTES_PER_S
                                   else 'bytes')))
        print(f'K2 x{list(x.shape)} F={f} k={k}  max|d| {err:.3e}  kernel '
              f'{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} '
              f'ms, 3xTF32 {bound_3x:.4f} ms ({flops / 1e9:.2f} GFLOP)  '
              f'library_ms null (no single PyTorch call computes a ConvLSTM '
              f'layer)', flush=True)

    # the kernel's other paths, checked and not timed (K2_OTHER_PATHS), with
    # the launch plan each takes; two runs must give the same bits
    for i, (b, t, h, w, cin, f, kh, kw) in enumerate(K2_OTHER_PATHS):
        layer = ConvLSTM2D(cin, f, (kh, kw))
        layer.reset_parameters(torch.Generator().manual_seed(len(cases) + i))
        wx, bx, wh = (p.detach().to(dev) for p in (
            layer.input_conv.kernel, layer.input_conv.bias,
            layer.cell.recurrent_conv.kernel))
        x = torch.randn((b, t, h, w, cin), generator=gen, device=dev)
        with torch.no_grad():
            ys = fcl(x, wx, bx, wh)
            again = fcl(x, wx, bx, wh)
            err = (ys - ref(x, wx, bx, wh)[0]).abs().max().item()
        plan = _fwd_plan(b, t, h, w, kh, kw, f, n_sm)
        print(f'K2 x{list(x.shape)} F={f} k={kh}x{kw} (plan: {plan["fs"]} '
              f'channels a block, {plan["th"]}x{plan["tw"]} pixels, '
              f'{plan["cw"]} channels x {plan["rps"]} tap rows a stage)  '
              f'max|d| {err:.3e}', flush=True)
        if not err <= K2_TOL:
            fail(f'K2 x{list(x.shape)} F={f} k={kh}x{kw}: max|d| {err:.3e} '
                 f'against atol {K2_TOL}')
        if not torch.equal(ys, again):
            fail(f'K2 x{list(x.shape)} F={f} k={kh}x{kw}: two runs gave '
                 f'different bits')

    # weights that require grad: the layer runs K2's training variant (2
    # step launches) and its gradient K3 (2 chain steps, the Wx and Wh
    # passes and their reduction; x needs no gradient, so no dx)
    layer = ConvLSTM2D(2, N_FILTERS, (3, 3))
    layer.reset_parameters(torch.Generator().manual_seed(99))
    layer = layer.to(dev)
    before = (fcl.launches, fcl.train_launches, fcl.bwd_launches)
    layer(torch.randn((1, 2, 8, 8, 2), device=dev)).square().sum().backward()
    torch.cuda.synchronize()
    got = tuple(n - m for n, m in zip(
        (fcl.launches, fcl.train_launches, fcl.bwd_launches), before))
    grads = [p.grad for p in layer.parameters()]
    print(f'K2 with CUDA weights that require grad: K2 inference, training '
          f'and K3 launches {got} (expected (0, 2, 5))', flush=True)
    if got != (0, 2, 5) or not all(
            g is not None and bool(torch.isfinite(g).all()) for g in grads):
        fail(f'a ConvLSTM layer with weights that require grad launched '
             f'{got} (expected (0, 2, 5)) or gave non-finite gradients')
    by_shape = {(r['x'][-1], r['f'], r['k']): r for r in rows
                if r['x'][2] == LR}
    report['k2_rows'] = rows
    report['k2_forward'] = [by_shape[shape] for shape in K2_LAYERS]


def phase_recurrent_predict(torch, tds, report):
    """Phase 5: the spatio-temporal path, full-width predict(time_window=4)
    of recresnet_spc on the card."""
    import numpy as np
    fca, fcl = tds.fused_channel_attention, tds.fused_convlstm
    model = tds.recnet_postupsampling(
        'resnet', 'spc', scale=SCALE, n_channels=2, n_aux_channels=2,
        lr_size=(LR, LR), time_window=REC_T, n_filters=N_FILTERS,
        n_blocks=REC_BLOCKS)
    net = model.init(seed=0, device='cuda')
    rng = np.random.default_rng(1)
    hr_size = LR * SCALE
    hr = rng.standard_normal((REC_GRIDS, hr_size, hr_size)).astype('float32')
    topo = rng.standard_normal((hr_size, hr_size)).astype('float32')
    mask = (rng.random((hr_size, hr_size)) > 0.5).astype('float32')
    pred = rng.standard_normal((REC_GRIDS, hr_size, hr_size, 1)).astype(
        'float32')
    kwargs = dict(scale=SCALE, time_window=REC_T, static_vars=[topo, mask],
                  predictors=[pred], batch_size=BATCH)
    n_windows = REC_GRIDS - REC_T + 1

    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    fca.launches = fcl.launches = 0
    y = tds.predict((model, net), hr, **kwargs)
    k2_launches, k1_launches = fcl.launches, fca.launches
    expected = len(K2_LAYERS) * REC_T * (-(-n_windows // BATCH))
    print(f'recurrent predict: {model.name}, {model.param_count(net)} '
          f'parameters, output {y.shape}, K2 launches {k2_launches} '
          f'(expected {expected}), K1 launches {k1_launches} (expected 0)',
          flush=True)
    if y.shape != (REC_GRIDS, hr_size, hr_size, 1):
        fail(f'recurrent predict output shape {y.shape}')
    if not np.isfinite(y).all():
        fail('recurrent predict output is not finite')
    if k2_launches != expected or k1_launches != 0:
        fail(f'the recurrent path launched K2 {k2_launches} times and K1 '
             f'{k1_launches} times, expected {expected} and 0')
    report['k2_launches'] = k2_launches

    t0 = time.perf_counter()
    tds.predict((model, net), hr, **kwargs)
    predict_s = time.perf_counter() - t0
    x = torch.randn((BATCH, REC_T, LR, LR, 2), device='cuda')
    aux = torch.randn((BATCH, hr_size, hr_size, 2), device='cuda')
    with torch.inference_mode():
        fwd_ms = statistics.median(
            device_times(torch, lambda: net(x, aux), reps=10))
    card = torch.cuda.get_device_name(0)
    print(f'recurrent predict {REC_GRIDS} grids 512x512 ({n_windows} '
          f'windows of {REC_T}) at batch {BATCH} (TF32 convs in the head, '
          f'the default; K2 is float32 FMA): '
          f'{REC_GRIDS / predict_s:.2f} grids/s end to end (host clock, data '
          f'assembly and copy out included); forward alone {fwd_ms:.3f} ms = '
          f'{BATCH / fwd_ms * 1e3:.2f} windows/s (CUDA events); {card}',
          flush=True)

    torch.backends.cudnn.allow_tf32 = False
    y32 = tds.predict((model, net), hr, **kwargs)
    net_cpu = copy.deepcopy(net).cpu()
    err = 0.0
    for name, sl, got in (('grid 0', slice(0, REC_T), y32[:1]),
                          (f'the last {REC_T} grids',
                           slice(REC_GRIDS - REC_T, REC_GRIDS),
                           y32[-REC_T:])):
        want = tds.predict((model, net_cpu), hr[sl], device='cpu',
                           **dict(kwargs, predictors=[pred[sl]]))[:len(got)]
        diff = np.abs(got - want)
        ok = bool((diff <= PREDICT_TOL['atol']
                   + PREDICT_TOL['rtol'] * np.abs(want)).all())
        print(f'recurrent predict {name}, GPU (TF32 off) vs CPU: max|d| '
              f'{float(diff.max()):.3e}, max|y| {float(np.abs(want).max()):.3e}'
              f' (atol {PREDICT_TOL["atol"]}, rtol {PREDICT_TOL["rtol"]})',
              flush=True)
        if not ok:
            fail(f'recurrent predict on the GPU disagrees with the CPU on '
                 f'{name}: max|d| {float(diff.max()):.3e}')
        err = max(err, float(diff.max()))
    report.update(rec_predict_grids_per_s=REC_GRIDS / predict_s,
                  rec_forward_ms=fwd_ms, rec_cpu_err=err)


# torch.profiler keeps a device kernel only when its time, on the host's
# clock, falls inside the trace's window (kineto drops the rest as out of
# range); with the clocks a little apart, a trace that launched work at
# once lost the first 3 ms of a chunk of replays on the H100. The host
# waits this long after the trace starts and before it stops.
PROFILE_GUARD_S = 0.05


@contextlib.contextmanager
def _device_trace(torch):
    """torch.profiler over the CPU and the device, the device synchronised
    before and at the end, with PROFILE_GUARD_S of quiet at either end.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_GUARD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_GUARD_S)


def kernel_split_ms(torch, fn, groups, reps=10):
    """Device ms a call of fn() spends in each group of kernels ({group:
    name fragments}; kernels of no group fall under 'other'), from
    torch.profiler's device events over `reps` calls after 3 warm-up ones.
    Fails when the profiler records no device kernel."""
    from torch.autograd import DeviceType
    for _ in range(3):
        fn()
    with _device_trace(torch) as prof:
        for _ in range(reps):
            fn()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False)]
    if not kernels:
        fail('the profiler recorded no device kernel')
    out = dict.fromkeys(list(groups) + ['other'], 0.0)
    for e in kernels:
        group = next((g for g, keys in groups.items()
                      if any(k in e.name for k in keys)), 'other')
        out[group] += (e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


# K3's kernels by launch kind (csrc/convlstm_seq.cu, csrc/convlstm_bwd.cu)
K3_KERNELS = {'chain': ('chain_step',), 'dx': ('dx_frames',),
              'wgrad': ('wgrad_tile',), 'reduce': ('wgrad_reduce',)}


def _note_plans(conv, reached, b, t, h, w, cin, f, kh, kw, need_dx, n_sm,
                elem=4, route='fused'):
    """Add the chain-step and dx tile's bodies (kernel, channels a block)
    and stage kinds that this layer's backward by `route` runs to
    `reached` (elem: the element size, 2 for the bfloat16 bodies); returns
    them as text. The split route's chain is K4's kernel and its dx the
    GEMM tail's."""
    chain = 'chain' if route == 'fused' else 'split chain'
    plans = [(chain, conv._seq_plan(b, h, w, kh, kw, f, n_sm, elem))]
    if need_dx and route == 'fused':
        plans.append(('dx', conv._seq_plan(b * t, h, w, kh, kw, cin, n_sm,
                                           elem)))
    for kind, p in plans:
        reached.add((kind, p['ns']))
        reached.add((p['cw'], 'all' if p['rps'] == kh else 'one'))
    return ', '.join(f'{kind} {p["ns"]} channels x {p["th"]}x{p["tw"]} '
                     f'pixels, stage {p["cw"]} x {p["rps"]}'
                     for kind, p in plans)


def k3_work(x, wx, wh, need_dx):
    """(flops, bytes) of the layer's BPTT: dx (when x needs it) and dWx
    over all T steps, the dh chain and dWh over T-1 (h_{-1} = 0, and no
    recurrent term at the last step); x, the weights, zs, cs, ys and dys
    read once, dx and the three parameter gradients written once."""
    b, t, h, w, cin = x.shape
    kh, kw, _, f4 = wx.shape
    f = f4 // 4
    per_x = 2 * b * t * h * w * kh * kw * cin * f4
    per_h = 2 * b * (t - 1) * h * w * kh * kw * f * f4
    flops = (2 if need_dx else 1) * per_x + 2 * per_h
    n_bytes = 4 * ((2 if need_dx else 1) * x.numel() + 2 * wx.numel() + f4
                   + 2 * wh.numel() + b * t * h * w * (f4 + 3 * f))
    return flops, n_bytes


def _layer_weights(torch, cin, f, kh, kw, seed, dev):
    from dl4ds_tpu_torch.models.blocks import ConvLSTM2D
    layer = ConvLSTM2D(cin, f, (kh, kw))          # Keras init
    layer.reset_parameters(torch.Generator().manual_seed(seed))
    return tuple(p.detach().to(dev) for p in (
        layer.input_conv.kernel, layer.input_conv.bias,
        layer.cell.recurrent_conv.kernel))


def _check_k2_train(torch, conv, x, wx, bx, wh, label):
    """K2's training variant against its plain version on one input, and
    the same bits in a second run. Returns the residuals (ys, cs, zs) and
    [max |d| of ys, cs, zs, max |zs|]."""
    with torch.no_grad():
        got = conv._launch(x, wx, bx, wh, train=True)
        again = conv._launch(x, wx, bx, wh, train=True)
        want = conv.convlstm_train_reference(x, wx, bx, wh)
    torch.cuda.synchronize()
    fwd_err = [(a - b).abs().max().item() for a, b in zip(got, want)]
    zs_scale = max(1.0, want[2].abs().max().item())
    if not (max(fwd_err[:2]) <= K2_TOL and fwd_err[2] <= K2_TOL * zs_scale):
        fail(f'K2-train {label}: ys, cs, zs max|d| {fwd_err} against atol '
             f'{K2_TOL} ({K2_TOL * zs_scale:.2e} for zs)')
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f'K2-train {label}: two runs gave different bits')
    return got, fwd_err + [zs_scale]


def _check_grads(torch, grads, again, ref, need_dx, what):
    """Each of the backward's gradients (dx, dwx, dbx, dwh; dx None without
    need_dx) against the plain BPTT in float64, max |d| over max |ref|
    within K3's tolerances, and the same bits in a second run. Returns the
    errors by name."""
    errs = {}
    for name, g, r, tol in zip(('dx', 'dwx', 'dbx', 'dwh'), grads, ref,
                               (K3_DX_TOL, K3_W_TOL, K3_W_TOL, K3_W_TOL)):
        if g is None:
            if need_dx or name != 'dx':
                fail(f'{what}: no {name}')
            continue
        if g.shape != r.shape:
            fail(f'{what}: {name} shape {tuple(g.shape)}, expected '
                 f'{tuple(r.shape)}')
        scale = max(r.abs().max().item(), 1e-30)
        errs[name] = (g.double() - r).abs().max().item() / scale
        if not errs[name] <= tol:
            fail(f'{what}: {name} max|d| / max|ref| {errs[name]:.3e} '
                 f'against {tol}')
    if not all(torch.equal(a, b) for a, b in zip(grads, again)
               if a is not None):
        fail(f'{what}: two runs gave different bits')
    return errs


def _check_k3_case(torch, conv, x, wx, bx, wh, dys, need_dx, label):
    """K2's training variant and K3 against their plain versions on one
    input; the plain backward takes the kernel's residuals, in float64 (and
    in float32, whose own error is returned). Returns the errors and the
    kernel's outputs."""
    (ys, cs, zs), fwd_err = _check_k2_train(torch, conv, x, wx, bx, wh,
                                            label)
    with torch.no_grad():
        args = (x, wx, wh, zs, cs, ys, dys)
        grads = conv._launch_backward(*args, need_dx)
        again = conv._launch_backward(*args, need_dx)
        ref = conv.convlstm_backward_reference(*(u.double() for u in args))
        ref32 = conv.convlstm_backward_reference(*args)
    torch.cuda.synchronize()
    errs = _check_grads(torch, grads, again, ref, need_dx, f'K3 {label}')
    errs['plain_f32'] = max(
        (g.double() - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
        for g, r in zip(ref32, ref))
    return fwd_err, errs, (ys, cs, zs)


def phase_convlstm_grad(torch, tds, report):
    """Phase 6: K2's training variant and K3 against their plain versions
    with TF32 off, at the layer shapes of a recresnet_spc training step, at
    width 64 and on their other paths; timed at the first two."""
    import dl4ds_tpu_torch.ops.convlstm as conv
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    reached = report.setdefault('plan_reached', set())
    cases = [((cin, f, k, k), TRAIN_BATCH, TRAIN_LR, cin != 1)
             for cin, f, k in dict.fromkeys(K3_LAYERS)]
    cases += [((cin, f, k, k), BATCH, K2_WIDE_LR, True)
              for cin, f, k in K2_WIDE]
    rows = []
    for i, ((cin, f, kh, kw), b, size, need_dx) in enumerate(cases):
        wx, bx, wh = _layer_weights(torch, cin, f, kh, kw, 100 + i, dev)
        x = torch.randn((b, REC_T, size, size, cin), generator=gen, device=dev)
        dys = torch.randn((b, REC_T, size, size, f), generator=gen,
                          device=dev)
        label = f'x{list(x.shape)} F={f} k={kh}'
        fwd_err, errs, (ys, cs, zs) = _check_k3_case(
            torch, conv, x, wx, bx, wh, dys, need_dx, label)
        with torch.no_grad():
            k2_ms, k2_plain_ms = paired_ms(
                torch, lambda: conv._launch(x, wx, bx, wh, train=True),
                lambda: conv.convlstm_train_reference(x, wx, bx, wh), flush)
            k3_ms, k3_plain_ms = paired_ms(
                torch, lambda: conv._launch_backward(
                    x, wx, wh, zs, cs, ys, dys, need_dx),
                lambda: conv.convlstm_backward_reference(
                    x, wx, wh, zs, cs, ys, dys), flush)
        flops, n_bytes = k2_work(x, wx, wh)
        n_bytes += 4 * 5 * ys.numel()                # cs and zs written
        k2_bound = max(flops / F32_FLOPS, n_bytes / HBM_BYTES_PER_S) * 1e3
        k2_bound_3x = max(flops / TF32X3_FLOPS,
                          n_bytes / HBM_BYTES_PER_S) * 1e3
        k3_flops, k3_bytes = k3_work(x, wx, wh, need_dx)
        k3_bound = max(k3_flops / F32_FLOPS,
                       k3_bytes / HBM_BYTES_PER_S) * 1e3
        k3_bound_3x = max(k3_flops / TF32X3_FLOPS,
                          k3_bytes / HBM_BYTES_PER_S) * 1e3
        with torch.no_grad():
            k3_split = kernel_split_ms(torch, lambda: conv._launch_backward(
                x, wx, wh, zs, cs, ys, dys, need_dx), K3_KERNELS)
        plans = _note_plans(conv, reached, b, REC_T, size, size, cin, f, kh,
                            kw, need_dx, n_sm)
        rows.append(dict(
            x=list(x.shape), f=f, k=kh, dx=need_dx, ys_cs_zs_err=fwd_err[:3],
            max_abs_zs=fwd_err[3],
            grad_rel_err=errs, k2_ms=k2_ms, k2_plain_ms=k2_plain_ms,
            k2_bound_ms=k2_bound, k2_bound_3xtf32_ms=k2_bound_3x,
            k2_gflop=flops / 1e9, k3_ms=k3_ms,
            k3_plain_ms=k3_plain_ms, k3_bound_ms=k3_bound,
            k3_bound_3xtf32_ms=k3_bound_3x, k3_split_ms=k3_split,
            k3_gflop=k3_flops / 1e9))
        print(f'K2-train {label}  ys, cs, zs max|d| '
              + ' '.join(f'{e:.3e}' for e in fwd_err[:3])
              + f' (max|zs| {fwd_err[3]:.2f})  same bits twice  kernel '
              f'{k2_ms:.4f} ms  plain {k2_plain_ms:.4f} ms  bound '
              f'{k2_bound:.4f} ms, 3xTF32 {k2_bound_3x:.4f} ms '
              f'({flops / 1e9:.3f} GFLOP)', flush=True)
        print(f'K3 {label}{"" if need_dx else " (no dx)"}  max|d|/max|ref| '
              + ' '.join(f'{k} {v:.2e}' for k, v in errs.items())
              + f'  same bits twice  kernel {k3_ms:.4f} ms  plain '
              f'{k3_plain_ms:.4f} ms  bound {k3_bound:.4f} ms, 3xTF32 '
              f'{k3_bound_3x:.4f} ms ({k3_flops / 1e9:.3f} GFLOP)  by launch '
              + ' '.join(f'{k} {v:.4f}' for k, v in k3_split.items())
              + f' ms (profiler)  plans: {plans}  library_ms null (no '
              f'single PyTorch call computes a ConvLSTM layer or its BPTT)',
              flush=True)

    for i, (b, t, h, w, cin, f, kh, kw, need_dx) in enumerate(
            K3_OTHER_PATHS):
        wx, bx, wh = _layer_weights(torch, cin, f, kh, kw, 200 + i, dev)
        x = torch.randn((b, t, h, w, cin), generator=gen, device=dev)
        dys = torch.randn((b, t, h, w, f), generator=gen, device=dev)
        label = f'x{list(x.shape)} F={f} k={kh}x{kw}'
        fwd_err, errs, _ = _check_k3_case(torch, conv, x, wx, bx, wh, dys,
                                          need_dx, label)
        plans = _note_plans(conv, reached, b, t, h, w, cin, f, kh, kw,
                            need_dx, n_sm)
        print(f'K2-train/K3 {label} ({plans}{"" if need_dx else "; no dx"})'
              f'  ys, cs, zs max|d| ' + ' '.join(f'{e:.3e}' for e in fwd_err[:3])
              + f' (max|zs| {fwd_err[3]:.2f})'
              + f'  max|d|/max|ref| '
              + ' '.join(f'{k} {v:.2e}' for k, v in errs.items()), flush=True)
    by_shape = {(r['x'][-1], r['f'], r['k']): r for r in rows
                if r['x'][0] == TRAIN_BATCH}
    report['k3_rows'] = rows
    report['k3_step'] = [by_shape[shape] for shape in K3_LAYERS]


def k4_work(zs, wh):
    """(flops, bytes) of K4, the sequential chain: the recurrent convT from
    the second-to-last step down (no recurrent term at the last); zs, cs,
    dys and wh read once, dzs written once."""
    b, t, h, w, f4 = zs.shape
    kh, kw = wh.shape[:2]
    flops = 2 * b * (t - 1) * h * w * kh * kw * f4 * (f4 // 4)
    return flops, 4 * (2 * zs.numel() + zs.numel() // 2 + wh.numel())


def tail_work(x, wx, wh, need_dx):
    """(flops, bytes) of the split route's GEMM tail: dWx (and dx) over all
    T steps, dWh over T-1; x, ys (T-1 steps), dzs and the weights read
    once, dx and the three parameter gradients written once."""
    b, t, h, w, cin = x.shape
    kh, kw, _, f4 = wx.shape
    f = f4 // 4
    per_x = 2 * b * t * h * w * kh * kw * cin * f4
    per_h = 2 * b * (t - 1) * h * w * kh * kw * f * f4
    flops = (2 if need_dx else 1) * per_x + per_h
    n_bytes = 4 * ((2 if need_dx else 1) * x.numel() + b * (t - 1) * h * w * f
                   + b * t * h * w * f4 + 2 * (wx.numel() + wh.numel() + f4))
    return flops, n_bytes


def _check_k4_case(torch, conv, x, wx, bx, wh, dys, need_dx, label):
    """K2's training variant against its plain version, K4 against its
    plain version in float64, and the split route's four gradients against
    the plain BPTT in float64, on one input; two runs of each must give the
    same bits. Returns (dzs error over max(1, max |ref|), the f32 plain
    chain's own, the gradients' errors over max |ref|, K2's training
    variant's errors), and the residuals."""
    (ys, cs, zs), fwd_err = _check_k2_train(torch, conv, x, wx, bx, wh,
                                            label)
    with torch.no_grad():
        dzs = conv._launch_seq(zs, cs, dys, wh)
        dzs_again = conv._launch_seq(zs, cs, dys, wh)
        seq64 = conv.convlstm_seq_reference(zs.double(), cs.double(),
                                            dys.double(), wh.double())
        seq32 = conv.convlstm_seq_reference(zs, cs, dys, wh)
        args = (x, wx, wh, zs, cs, ys, dys)
        grads = conv._backward('split', *args, need_dx)
        again = conv._backward('split', *args, need_dx)
        ref = conv.convlstm_backward_reference(*(u.double() for u in args))
    torch.cuda.synchronize()
    scale = max(1.0, seq64.abs().max().item())
    dzs_err = (dzs.double() - seq64).abs().max().item() / scale
    plain_err = (seq32.double() - seq64).abs().max().item() / scale
    if dzs.shape != seq64.shape or not dzs_err <= K4_TOL:
        fail(f'K4 {label}: dzs shape {tuple(dzs.shape)}, max|d| / max(1, '
             f'max|ref|) {dzs_err:.3e} against {K4_TOL}')
    if not torch.equal(dzs, dzs_again):
        fail(f'K4 {label}: two runs gave different bits')
    errs = _check_grads(torch, grads, again, ref, need_dx,
                        f'split route {label}')
    return (dzs_err, plain_err, errs, fwd_err), (ys, cs, zs, dzs)


def phase_convlstm_split(torch, tds, report):
    """Phase 6, second part: K4 and the split route against their plain
    versions in float64 at the six layer shapes of the width-64 training
    step and on K4's other paths, with K2's training variant that feeds
    them; K2-train, K4 and the tail timed at the first."""
    import dl4ds_tpu_torch.ops.convlstm as conv
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    reached = report.setdefault('plan_reached', set())
    rows = []
    for i, (cin, f, k) in enumerate(dict.fromkeys(WIDE_LAYERS)):
        wx, bx, wh = _layer_weights(torch, cin, f, k, k, 400 + i, dev)
        x = torch.randn((TRAIN_BATCH, REC_T, TRAIN_LR, TRAIN_LR, cin),
                        generator=gen, device=dev)
        dys = torch.randn((TRAIN_BATCH, REC_T, TRAIN_LR, TRAIN_LR, f),
                          generator=gen, device=dev)
        need_dx = cin != 1
        label = f'x{list(x.shape)} F={f} k={k}'
        errors, (ys, cs, zs, dzs) = _check_k4_case(
            torch, conv, x, wx, bx, wh, dys, need_dx, label)
        dzs_err, plain_err, errs, fwd_err = errors
        with torch.no_grad():
            k2_ms, k2_plain_ms = paired_ms(
                torch, lambda: conv._launch(x, wx, bx, wh, train=True),
                lambda: conv.convlstm_train_reference(x, wx, bx, wh), flush)
            k4_ms, k4_plain_ms = paired_ms(
                torch, lambda: conv._launch_seq(zs, cs, dys, wh),
                lambda: conv.convlstm_seq_reference(zs, cs, dys, wh), flush)
            tail_ms = statistics.median(device_times(
                torch, lambda: conv.convlstm_backward_tail(
                    x, wx, wh, ys, dzs, need_dx), l2_flush=flush))
        k2_flops, k2_bytes = k2_work(x, wx, wh)
        k2_bytes += 4 * 5 * ys.numel()               # cs and zs written
        k2_bound = max(k2_flops / F32_FLOPS, k2_bytes / HBM_BYTES_PER_S) * 1e3
        k2_bound_3x = max(k2_flops / TF32X3_FLOPS,
                          k2_bytes / HBM_BYTES_PER_S) * 1e3
        flops, n_bytes = k4_work(zs, wh)
        k4_bound = max(flops / F32_FLOPS, n_bytes / HBM_BYTES_PER_S) * 1e3
        k4_bound_3x = max(flops / TF32X3_FLOPS,
                          n_bytes / HBM_BYTES_PER_S) * 1e3
        plans = _note_plans(conv, reached, TRAIN_BATCH, REC_T, TRAIN_LR,
                            TRAIN_LR, cin, f, k, k, False, n_sm,
                            route='split')
        t_flops, t_bytes = tail_work(x, wx, wh, need_dx)
        tail_bound = max(t_flops / F32_FLOPS, t_bytes / HBM_BYTES_PER_S) * 1e3
        rows.append(dict(x=list(x.shape), f=f, k=k, dx=need_dx,
                         dzs_rel_err=dzs_err, plain_f32_dzs_err=plain_err,
                         grad_rel_err=errs, ys_cs_zs_err=fwd_err[:3],
                         max_abs_zs=fwd_err[3], k2_ms=k2_ms,
                         k2_plain_ms=k2_plain_ms, k2_bound_ms=k2_bound,
                         k2_bound_3xtf32_ms=k2_bound_3x,
                         k2_gflop=k2_flops / 1e9, k4_ms=k4_ms,
                         k4_plain_ms=k4_plain_ms, k4_bound_ms=k4_bound,
                         k4_bound_3xtf32_ms=k4_bound_3x,
                         k4_gflop=flops / 1e9, tail_ms=tail_ms,
                         tail_bound_ms=tail_bound, tail_gflop=t_flops / 1e9))
        print(f'K2-train {label}  ys, cs, zs max|d| '
              + ' '.join(f'{e:.3e}' for e in fwd_err[:3])
              + f' (max|zs| {fwd_err[3]:.2f})  same bits twice  kernel '
              f'{k2_ms:.4f} ms  plain {k2_plain_ms:.4f} ms  bound '
              f'{k2_bound:.4f} ms, 3xTF32 {k2_bound_3x:.4f} ms '
              f'({k2_flops / 1e9:.2f} GFLOP)', flush=True)
        print(f'K4 {label}  dzs max|d|/max(1, max|ref|) {dzs_err:.2e} '
              f'(plain f32 {plain_err:.2e}); split route'
              f'{"" if need_dx else " (no dx)"} max|d|/max|ref| '
              + ' '.join(f'{n} {v:.2e}' for n, v in errs.items())
              + f'  same bits twice  K4 {k4_ms:.4f} ms  plain '
              f'{k4_plain_ms:.4f} ms  bound {k4_bound:.4f} ms, 3xTF32 '
              f'{k4_bound_3x:.4f} ms ({flops / 1e9:.2f} GFLOP; {plans})  '
              f'tail (float32 GEMMs) '
              f'{tail_ms:.4f} ms  bound {tail_bound:.4f} ms '
              f'({t_flops / 1e9:.2f} GFLOP)  library_ms null (no single '
              f'PyTorch call computes the chain)', flush=True)
        del x, dys, ys, cs, zs, dzs
        torch.cuda.empty_cache()

    for i, (b, t, h, w, cin, f, kh, kw, need_dx) in enumerate(K4_OTHER_PATHS):
        wx, bx, wh = _layer_weights(torch, cin, f, kh, kw, 500 + i, dev)
        x = torch.randn((b, t, h, w, cin), generator=gen, device=dev)
        dys = torch.randn((b, t, h, w, f), generator=gen, device=dev)
        label = f'x{list(x.shape)} F={f} k={kh}x{kw}'
        (dzs_err, plain_err, errs, _), _ = _check_k4_case(
            torch, conv, x, wx, bx, wh, dys, need_dx, label)
        rows.append(dict(x=list(x.shape), f=f, k=[kh, kw], dx=need_dx,
                         dzs_rel_err=dzs_err, plain_f32_dzs_err=plain_err,
                         grad_rel_err=errs))
        plans = _note_plans(conv, reached, b, t, h, w, cin, f, kh, kw, False,
                            n_sm, route='split')
        print(f'K4/split {label}{"" if need_dx else " (no dx)"} ({plans})  dzs '
              f'max|d|/max(1, max|ref|) {dzs_err:.2e} (plain f32 '
              f'{plain_err:.2e})  max|d|/max|ref| '
              + ' '.join(f'{n} {v:.2e}' for n, v in errs.items()), flush=True)
    by_shape = {(r['x'][-1], r['f'], r['k']): r for r in rows
                if 'k4_ms' in r}
    missing = (PLAN_BODIES | PLAN_STAGES) - reached
    print(f'chain-step and dx tile: ran bodies and stage kinds '
          f'{sorted(map(str, reached))}', flush=True)
    if missing:
        fail(f'phase 6 ran no shape of the chain-step and dx tile\'s '
             f'{sorted(map(str, missing))}')
    report['plan_reached'] = sorted(map(str, reached))
    report['k4_rows'] = rows
    report['k4_step'] = [by_shape[shape] for shape in WIDE_LAYERS]


def _counters(tds):
    """(name, function, attribute) of every launch counter of the port."""
    from dl4ds_tpu_torch.ops import fused_ops as fo
    fcl = tds.fused_convlstm
    return [('K2-train', fcl, 'train_launches'),
            ('K2 inference', fcl, 'launches'), ('K3', fcl, 'bwd_launches'),
            ('K4', fcl, 'seq_launches'),
            ('K1', tds.fused_channel_attention, 'launches'),
            ('K1 backward', tds.fused_channel_attention, 'bwd_launches'),
            ('K6', tds.fused_ssim_per_image, 'launches'),
            ('K6 backward', tds.fused_ssim_per_image, 'bwd_launches'),
            ('K1 band', fo.fused_channel_attention_band, 'launches'),
            ('K1 band backward', fo.fused_channel_attention_band,
             'bwd_launches')]


def _expected_launches(conv, layers, steps, eval_steps, itemsize=4,
                       hw=TRAIN_LR):
    """{counter: launches} of `steps` training steps and `eval_steps`
    validation or test steps of a recurrent model with these (Cin, F, k)
    ConvLSTM layers on hw x hw frames, by `dispatch_info`'s route of each
    (for the model dtype's `itemsize`): K3 a layer is T chain steps, dx
    (not for the stem, whose input needs no gradient), the Wx and Wh passes
    and one reduction; K4 a layer is T chain steps. With (1, 0) and (0, 1),
    the launches a captured step must hold."""
    k3 = k4 = 0
    for cin, f, k in layers:
        x_shape = (TRAIN_BATCH, REC_T, hw, hw, cin)
        route = conv.dispatch_info(x_shape, (k, k, cin, 4 * f),
                                   (k, k, f, 4 * f), itemsize)['path']
        if route == 'fused':
            k3 += REC_T + (cin != 1) + 3
        else:
            k4 += REC_T
    n = len(layers) * REC_T
    return {'K2-train': steps * n, 'K2 inference': eval_steps * n,
            'K3': steps * k3, 'K4': steps * k4, 'K1': 0, 'K1 backward': 0,
            'K6': 0, 'K6 backward': 0}


def _training_config(backbone='resnet', upsampling='spc', **model):
    """SupervisedTrainer arguments of a training phase: 256 seeded grids of
    128x128, 64x64 HR patches, scale 4, and the model's `model` options."""
    import numpy as np
    rng = np.random.default_rng(0)
    data = rng.standard_normal(
        (TRAIN_GRIDS, TRAIN_HR, TRAIN_HR, 1)).astype('float32')
    return dict(backbone=backbone, upsampling=upsampling, data_train=data,
                data_val=data[:64], data_test=data[:64], scale=SCALE,
                patch_size=TRAIN_PATCH, verbose=False, **model)


# (name fragment, counter) of the port's kernels in a device trace, first
# match first; a call of the stream regime of K1 and of the tile regime of
# K6's backward launches a second kernel (ca_stream_apply, ssim_pixels_bwd),
# which is counted under None, so that a counter counts calls as its
# wrapper does (K1's band mode: its forward's second stage launches
# ca_band_gate and ca_band_apply, counted once); a pair is chosen from by
# the kernel's last template flag (BWD for ca_stream_sums and the band
# mode's, TRAIN for convlstm_tile); a chain step is K3's
# (`chain_step`) or K4's (`split_chain`, the same tile under its own name)
KERNEL_COUNTERS = (
    ('ca_band_sums', ('K1 band', 'K1 band backward')),
    ('ca_band_gate', 'K1 band'), ('ca_band_apply', (None, 'K1 band backward')),
    ('ca_fwd_resident', 'K1'), ('ca_bwd_resident', 'K1 backward'),
    ('ca_stream_sums', ('K1', 'K1 backward')), ('ca_stream_apply', None),
    ('ssim_image_bwd', 'K6 backward'), ('ssim_tiles_bwd', 'K6 backward'),
    ('ssim_pixels_bwd', None), ('ssim_image', 'K6'), ('ssim_tiles', 'K6'),
    ('convlstm_tile', ('K2 inference', 'K2-train')), ('chain_step', 'K3'),
    ('split_chain', 'K4'), ('dx_frames', 'K3'), ('wgrad_tile', 'K3'),
    ('wgrad_reduce', 'K3'))
# the last bool in a kernel's name: demangled (`<16, true, true>`), as a
# [with ... TRAIN=true] list, or mangled (`Lb1E`)
_TEMPLATE_BOOL = re.compile(r'\b(true|false)\b|Lb([01])E')


def _kernel_counter(name):
    """The counter of `_counters` under which a device kernel of this name
    counts: None for the second kernel of a call or a kernel that is not
    the port's."""
    for fragment, counter in KERNEL_COUNTERS:
        if fragment in name:
            if isinstance(counter, tuple):
                flags = _TEMPLATE_BOOL.findall(name)
                if not flags:
                    fail(f'no template flag in the kernel name {name!r}')
                word, bit = flags[-1]
                counter = counter[word == 'true' or bit == '1']
            return counter
    return None


def _device_kernels(torch, prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)]


def _device_launches(tds, kernels):
    """{counter: launches} of the port's kernels among the profiler's
    device `kernels`."""
    counts = dict.fromkeys((name for name, _, _ in _counters(tds)), 0)
    for e in kernels:
        counter = _kernel_counter(e.name)
        if counter is not None:
            counts[counter] += 1
    return counts


def _traced_run(torch, tds, tr):
    """`tr.run()` under torch.profiler, with every launch counter set to 0
    just before and read just after. Returns (the run's seconds, the
    wrappers' calls {counter: n}, the device kernels of the trace)."""
    counters = _counters(tds)
    for _, fn, attr in counters:
        setattr(fn, attr, 0)
    with _device_trace(torch) as prof:
        t0 = time.perf_counter()
        tr.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    calls = {name: getattr(fn, attr) for name, fn, attr in counters}
    return run_s, calls, _device_kernels(torch, prof)


def _check_launches(tds, runner, label, per_step, replays, calls, kernels,
                    outside=None):
    """Hold a traced run's launches of the port's kernels against the
    launches a step should make (`per_step`: {'train': {counter: n},
    'eval': ...}) and each graph's replays against `replays` ({graph: n}).
    A graph's wrappers are called in its warm-up calls and its capture
    (a step x (WARMUP_CALLS + 1)); its kernels run on the device in the
    warm-up calls and the replays (a step x (WARMUP_CALLS + replays)), as
    the device trace must show. `outside` ({counter: n}) are the launches
    the run makes eagerly, outside its graphs (the CGAN trainer's test
    loss), counted in both. Returns the launches the trace holds."""
    from dl4ds_tpu_torch.training.graphs import WARMUP_CALLS
    want_calls = dict.fromkeys(calls, 0)
    want = dict.fromkeys(calls, 0)
    for name, n in (outside or {}).items():
        want_calls[name] += n
        want[name] += n
    for gname, graph in runner.graphs.items():
        if graph.replays != replays[gname]:
            fail(f'{label}: graph {gname!r} replayed {graph.replays} times, '
                 f'expected {replays[gname]}')
        step = per_step['eval' if gname in ('val', 'test') else 'train']
        for name in want:
            want_calls[name] += step.get(name, 0) * (WARMUP_CALLS + 1)
            want[name] += step.get(name, 0) * (WARMUP_CALLS + graph.replays)
    launches = _device_launches(tds, kernels)
    print(f'{label}: graphs {sorted(runner.graphs)} replayed '
          f'{ {g: c.replays for g, c in runner.graphs.items()} } times; '
          f'wrapper calls {calls} (expected a training step '
          f'{per_step["train"]}, an evaluation step {per_step["eval"]}, x '
          f'({WARMUP_CALLS} warm-up calls + the capture) a graph: '
          f'{want_calls})', flush=True)
    print(f'{label}: launches of the port\'s kernels in the device trace '
          f'{launches} (expected a step x ({WARMUP_CALLS} warm-up calls + '
          f'the replays) a graph: {want})', flush=True)
    if calls != want_calls:
        fail(f'{label}: the wrappers were called {calls} times, expected '
             f'{want_calls}')
    if launches != want:
        fail(f'{label}: the device trace holds {launches} launches of the '
             f'port\'s kernels, expected {want}')
    return launches


@contextlib.contextmanager
def _dropout_draws(torch, feed=None):
    """Record the port's dropout draws (`_dropout_mask`) in call order into
    the list it yields, or with `feed` (a list of earlier draws) return
    those in order instead, each moved to the device the call asks for (a
    noise draw cast to its dtype), so that a CPU run consumes the masks of
    a GPU run."""
    from dl4ds_tpu_torch.models import blocks
    real = blocks._dropout_mask
    log = []

    def record(shape, keep, generator, dtype, device, kind='bernoulli'):
        log.append(real(shape, keep, generator, dtype, device, kind))
        return log[-1]

    def replay(shape, keep, generator, dtype, device, kind='bernoulli'):
        if not feed or tuple(feed[0].shape) != tuple(shape):
            fail(f'dropout draw {tuple(shape)} ({kind}) has no recorded '
                 f'counterpart')
        value = feed.pop(0)
        return value.to(device=device, dtype=(
            torch.bool if value.dtype == torch.bool else dtype))
    blocks._dropout_mask = record if feed is None else replay
    try:
        yield log
    finally:
        blocks._dropout_mask = real
    if feed:
        fail(f'{len(feed)} recorded dropout draws were not consumed')


def _drive_training(torch, tds, config, label, steps, per_step, cpu_batch,
                    shares, keep_model=False, f32_yardstick=False,
                    batch=TRAIN_BATCH, draws=False, retraces=0):
    """Drive training through SupervisedTrainer(**config) on the card at
    batch 128 (2 epochs of `steps` steps, validation and test, replayed as
    captured CUDA graphs) under torch.profiler, with every launch counter
    set to 0 just before and read just after: the wrappers' calls and the
    launches in the device trace against the launches a step should make
    (`per_step`, {'train': {counter: launches}, 'eval': ...},
    `_check_launches`); require finite losses; time eager steps
    (host clock, and one step on CUDA events, with the kernels' shares of it
    from `shares`, {name: ms}; phase 11 times the graphs); then 3 steps at
    `cpu_batch` from one seed on the GPU (TF32 off, PyTorch's own float32
    convolutions, not cuDNN's) and on the CPU in float64 (with
    `f32_yardstick` also in float32 on the CPU, the yardstick of the third
    step's parameters; with `f32_yardstick='all'` of the losses and the
    first step's parameters too, where one float32 step already lands
    farther than the atol). Returns the launches in the device trace, the
    wrappers' calls and the numbers, and with `keep_model` the trained
    (model, net) under the numbers' 'model'. `batch` is the training
    batch; with `draws` (a model with dropout) the CPU runs consume the
    dropout draws of the GPU run (`_dropout_draws`). The running
    statistics of a model with batch norm are compared as the
    parameters are."""
    import numpy as np
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = tds.SupervisedTrainer(
        batch_size=batch, epochs=TRAIN_EPOCHS, steps_per_epoch=steps,
        validation_steps=TRAIN_VAL_STEPS, test_steps=TRAIN_TEST_STEPS,
        **config)
    run_s, calls, kernels = _traced_run(torch, tds, tr)
    losses = tr.fithist['loss'] + tr.fithist['val_loss'] + [tr.test_loss]
    print(f'training: {tr.model.name}, {label}, '
          f'{tr.model.param_count(tr.net)} parameters, batch {batch}, '
          f'{TRAIN_EPOCHS} epochs of {steps} steps in {run_s:.2f} s under '
          f'torch.profiler; history {tr.fithist}, test loss '
          f'{tr.test_loss:.6f}', flush=True)
    got = _check_launches(
        tds, tr.runner, f'training ({label})', per_step,
        {'step': TRAIN_EPOCHS * steps,
         'val': TRAIN_EPOCHS * TRAIN_VAL_STEPS, 'test': TRAIN_TEST_STEPS},
        calls, kernels)
    if not all(np.isfinite(v) for v in losses):
        fail(f'training ({label}) gave non-finite losses {losses}')

    # speed: steps with their batch synthesis on the host clock, and one
    # step alone on CUDA events
    gen = torch.Generator().manual_seed(1)
    idx = tr.ds_train.epoch_indices(gen, steps=steps)
    tr.net.train()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(steps):
        tr.train_step(tr.ds_train(idx[c], generator=gen))
    torch.cuda.synchronize()
    patches_per_s = steps * batch / (time.perf_counter() - t0)
    one = tr.ds_train(idx[0], generator=gen)
    step_ms = statistics.median(
        device_times(torch, lambda: tr.train_step(one), reps=10))
    graphed = _graphed_speed(torch, tds, tr, steps, per_step, label, batch,
                             retraces)
    trained = (tr.model, tr.net) if keep_model else None
    del tr, one
    print(f'training step at batch {batch}, {label} (TF32 convs, the '
          f'default; the port\'s kernels and the GEMM tail are float32): '
          f'{patches_per_s:.1f} patches/s end to end eager (host clock, batch '
          f'synthesis included); one eager step {step_ms:.3f} ms (CUDA '
          f'events) = {batch / step_ms * 1e3:.1f} patches/s; of which '
          + ', '.join(f'{name} {ms:.3f} ms ({100 * ms / step_ms:.1f}%)'
                      for name, ms in shares.items())
          + f', timed alone above; replayed: {graphed["patches_per_s"]:.1f} '
          f'patches/s (host clock), one replay {graphed["replay_ms"]:.3f} ms '
          f'(CUDA events), device busy {100 * graphed["busy_share"]:.1f}% '
          f'of {steps} replays\' span; {torch.cuda.get_device_name(0)}',
          flush=True)

    # 3 steps from one seed on the GPU and on the CPU
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    sides = [('cuda', torch.float32), ('cpu', torch.float64)]
    if f32_yardstick:
        sides.append(('cpu', torch.float32))
    drawn = []
    for device, dtype in sides:
        torch.backends.cudnn.enabled = device == 'cpu'
        small = tds.SupervisedTrainer(batch_size=cpu_batch, epochs=1,
                                      device=device, **config)
        small.setup_datagen()
        small.setup_model()
        small.net.to(dtype)
        small.setup_optimizer()
        small.net.train()
        gen = torch.Generator().manual_seed(3)
        idx = small.ds_train.epoch_indices(gen, steps=3)
        losses, params = [], []
        feed = None if device == 'cuda' or not draws else list(drawn)
        with _dropout_draws(torch, feed) as log:
            for c in range(3):
                step = small.ds_train(idx[c], generator=gen)
                losses.append(small.train_step(
                    {k: None if v is None else v.to(dtype)
                     for k, v in step.items()}).item())
                # copies: .double() of a float64 parameter is the parameter
                params.append({
                    n: p.detach().to('cpu', torch.float64, copy=True)
                    for n, p in list(small.net.named_parameters())
                    + list(small.net.named_buffers())})
        if device == 'cuda':
            drawn = log
        if draws and not drawn:
            fail(f'{label}: the GPU steps drew no dropout mask')
        runs[device, dtype] = (losses, params)
    torch.backends.cudnn.enabled = True
    (gpu_losses, gpu_params), (cpu_losses, cpu_params) = (
        runs['cuda', torch.float32], runs['cpu', torch.float64])

    def distance(params, step):
        return max((params[step][n] - cpu_params[step][n]).abs().max().item()
                   for n in cpu_params[step])
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gpu_losses,
                                                       cpu_losses))
    param_err = distance(gpu_params, 2)
    print(f'3 training steps at batch {cpu_batch}, {label}, GPU (TF32 off, '
          f'PyTorch\'s own float32 convolutions, not cuDNN\'s) vs CPU '
          f'(float64): losses {gpu_losses} vs {cpu_losses}, max relative '
          f'difference {loss_err:.3e} (rtol {TRAIN_LOSS_RTOL}); parameters '
          f'max|d| {param_err:.3e} (atol {TRAIN_PARAM_ATOL})', flush=True)
    ok = loss_err <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_ATOL
    yardstick = {}
    if f32_yardstick:
        # where float32 itself lands farther than the atol from float64
        # after 3 steps (F32_YARDSTICK), the first step is held to the atol
        # and the third to the CPU's own float32 run
        first = distance(gpu_params, 0)
        own = distance(runs['cpu', torch.float32][1], 2)
        own_first = distance(runs['cpu', torch.float32][1], 0)
        print(f'{label}: parameters after one step max|d| {first:.3e} from '
              f'float64 (atol {TRAIN_PARAM_ATOL}; the CPU\'s float32 run '
              f'{own_first:.3e}); after three {param_err:.3e}, the CPU\'s '
              f'float32 run {own:.3e} (at most {F32_YARDSTICK_RATIO}x it '
              f'required)', flush=True)
        ok = (loss_err <= TRAIN_LOSS_RTOL and first <= TRAIN_PARAM_ATOL
              and param_err <= max(TRAIN_PARAM_ATOL,
                                   F32_YARDSTICK_RATIO * own))
        yardstick = dict(cpu_first_step_param_err=first,
                         cpu_f32_param_err=own,
                         cpu_f32_first_step_param_err=own_first)
        if f32_yardstick == 'all':
            f32_losses, f32_params = runs['cpu', torch.float32]
            own_loss = max(abs(a - b) / abs(b) for a, b in zip(f32_losses,
                                                               cpu_losses))
            worst = max(cpu_params[0], key=lambda n: (
                f32_params[0][n] - cpu_params[0][n]).abs().max().item())
            gpu_worst = max(cpu_params[2], key=lambda n: (
                gpu_params[2][n] - cpu_params[2][n]).abs().max().item())
            apart = max((gpu_params[2][n] - f32_params[2][n]).abs().max()
                        .item() for n in cpu_params[2])
            print(f'{label}: losses {loss_err:.3e} from float64, the CPU\'s '
                  f'float32 run {own_loss:.3e}; the CPU\'s float32 run '
                  f'lands farthest after one step at {worst}, the GPU '
                  f'after three at {gpu_worst}; GPU vs the CPU\'s float32 '
                  f'run after three steps max|d| {apart:.3e}', flush=True)
            ok = (loss_err <= max(TRAIN_LOSS_RTOL,
                                  F32_YARDSTICK_RATIO * own_loss)
                  and first <= max(TRAIN_PARAM_ATOL,
                                   F32_YARDSTICK_RATIO * own_first)
                  and param_err <= max(TRAIN_PARAM_ATOL,
                                       F32_YARDSTICK_RATIO * own))
            yardstick.update(cpu_f32_loss_rel_err=own_loss,
                             cpu_f32_worst_first_step=worst)
    if not ok:
        fail(f'GPU training steps ({label}) disagree with the CPU: losses '
             f'{loss_err:.3e}, parameters {param_err:.3e}')
    numbers = dict(patches_per_s=patches_per_s, step_ms=step_ms, run_s=run_s,
                   cpu_loss_rel_err=loss_err, cpu_param_err=param_err,
                   graphed=graphed, **yardstick)
    if keep_model:
        numbers['model'] = trained
    return got, calls, numbers


def _graphed_speed(torch, tds, tr, steps, per_step, label,
                   batch=TRAIN_BATCH, retraces=0):
    """The replayed training graph of a run trainer: a chunk of `steps`
    replays with its plan upload on the host clock (after one warm chunk),
    one replay on CUDA events, and a chunk under torch.profiler: the
    device's busy share of its span, and the port's kernels, which must
    have run in every replay. With `retraces`, a trace that misses
    launches (the profiler lost 2 of 480 K2 launches in one of five runs
    of phase 15 (c) on the H100; a replay cannot skip a kernel) is taken
    again, up to that many times, and every trace is printed."""
    gen = torch.Generator().manual_seed(7)
    plans = [tr.ds_train.plan(gen, steps) for _ in range(2)]
    tr.runner.train(plans[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.runner.train(plans[1])
    torch.cuda.synchronize()
    rate = steps * batch / (time.perf_counter() - t0)
    graph = tr.runner.graphs['step']

    def replay():
        tr._row.zero_()
        graph.replay()
    replay_ms = statistics.median(device_times(torch, replay, reps=10))
    want = {name: per_step['train'].get(name, 0) * steps
            for name, _, _ in _counters(tds)}
    for attempt in range(retraces + 1):
        kernels, busy_ms, span_ms = _replay_profile(torch, tr.runner,
                                                    plans[0])
        port = _device_launches(tds, kernels)
        if port == want:
            break
        print(f'{label}: trace {attempt + 1} of {steps} replays holds '
              f'{port} launches of the port\'s kernels, expected {want}',
              flush=True)
    if port != want:
        fail(f'{label}: the profiler saw {port} launches of the port\'s '
             f'kernels in {steps} replays, expected {per_step["train"]} in '
             f'each')
    return dict(patches_per_s=rate, replay_ms=replay_ms,
                busy_ms_per_step=busy_ms / steps,
                span_ms_per_step=span_ms / steps,
                busy_share=busy_ms / span_ms,
                port_launches_per_replay=sum(port.values()) / steps,
                launches_per_replay=len(kernels) / steps)


def _print_routes(conv, layers, hw=TRAIN_LR, itemsize=4):
    routes = {}
    for cin, f, k in dict.fromkeys(layers):
        info = conv.dispatch_info(
            (TRAIN_BATCH, REC_T, hw, hw, cin), (k, k, cin, 4 * f),
            (k, k, f, 4 * f), itemsize)
        routes[f'Cin {cin}, F {f}, {k}x{k}'] = info['path']
        print(f'ConvLSTM layer (Cin {cin}, F {f}, {k}x{k}) at batch '
              f'{TRAIN_BATCH}, {hw}x{hw} frames, itemsize {itemsize}: '
              f'backward route {info["path"]} ({info["reason"]})',
              flush=True)
    return routes


def _recurrent_per_step(conv, layers, itemsize=4, hw=TRAIN_LR):
    return {'train': _expected_launches(conv, layers, 1, 0, itemsize, hw),
            'eval': _expected_launches(conv, layers, 0, 1, itemsize, hw)}


def phase_training(torch, tds, report):
    """Phase 7: recurrent training of BASELINE config 4 on the card."""
    import dl4ds_tpu_torch.ops.convlstm as conv
    step = report['k3_step']
    _print_routes(conv, K3_LAYERS)
    got, calls, numbers = _drive_training(
        torch, tds, _training_config(loss='mae', time_window=REC_T,
                                     n_blocks=REC_BLOCKS,
                                     n_filters=N_FILTERS),
        f'n_filters {N_FILTERS}', TRAIN_STEPS, _recurrent_per_step(
            conv, K3_LAYERS), 16, {'K2-train': sum(r['k2_ms'] for r in step),
             'K3': sum(r['k3_ms'] for r in step)})
    report.update(k2_train_launches=got['K2-train'],
                  train_k2_inference_launches=got['K2 inference'],
                  k3_launches=got['K3'], train_k4_launches=got['K4'],
                  k2_train_calls=calls['K2-train'], k3_calls=calls['K3'])
    report.update({f'train_{k}': v for k, v in numbers.items()})


def phase_wide_training(torch, tds, report):
    """Phase 8: recurrent training at width 64 on the card."""
    import dl4ds_tpu_torch.ops.convlstm as conv
    step = report['k4_step']
    _print_routes(conv, WIDE_LAYERS)
    got, calls, numbers = _drive_training(
        torch, tds, _training_config(loss='mae', time_window=REC_T,
                                     n_blocks=REC_BLOCKS, n_filters=WIDE_F,
                                     attention=True),
        f'n_filters {WIDE_F}', WIDE_STEPS,
        _recurrent_per_step(conv, WIDE_LAYERS), WIDE_CPU_BATCH,
        {'K2-train': sum(r['k2_ms'] for r in step),
         'K4': sum(r['k4_ms'] for r in step),
         'the GEMM tail': sum(r['tail_ms'] for r in step)})
    report.update(wide_k2_train_launches=got['K2-train'],
                  wide_k2_inference_launches=got['K2 inference'],
                  wide_k3_launches=got['K3'], k4_launches=got['K4'],
                  k4_calls=calls['K4'])
    report.update({f'wide_{k}': v for k, v in numbers.items()})


def k6_work(shape, k):
    """(flops, bytes) of K6 on [..., H, W, C] images with k taps: the five
    moments' horizontal pass over every row (H x Wv outputs) and vertical
    pass (Hv x Wv), k multiply-adds each, for every image and channel; both
    images read once, one float per output written."""
    *lead, h, w, c = shape
    n_out = math.prod(lead)
    hv, wv = h - k + 1, w - k + 1
    flops = 2 * 5 * k * (h * wv + hv * wv) * n_out * c
    return flops, 4 * (2 * n_out * c * h * w + n_out)


def k6_bwd_work(shape, k, n_grads):
    """(flops, bytes) of K6's backward with n_grads image gradients: the
    forward's moments again, then `2 + n_grads` derivative maps (d mu11 =
    d mu22, d mu12, and d mu1 or d mu2 for each image asked) filtered back,
    vertically over H x Wv and horizontally over H x W, k multiply-adds
    each; both images and g read once, the gradients written once."""
    *lead, h, w, c = shape
    n_img = math.prod(lead) * c
    flops = k6_work(shape, k)[0] + 2 * (2 + n_grads) * k * (
        h * (w - k + 1) + h * w) * n_img
    return flops, 4 * ((2 + n_grads) * n_img * h * w + 2 * math.prod(lead))


def _ssim_pair(torch, shape, gen, dev):
    """An image in [0, 1) and a noisy copy clipped to [0, 1]."""
    a = torch.rand(shape, generator=gen, device=dev)
    b = (a + 0.1 * torch.randn(shape, generator=gen, device=dev)).clamp(0, 1)
    return a, b


def _check_k6_backward(torch, fo, a, b, max_val, g, k, sigma, label):
    """K6's backward kernel against `ssim_backward_reference` run in float64
    on the same inputs, for both images and max_val, and the same bits
    twice. Each gradient's max |d| is within K6_BWD_TOL of its max |ref|,
    or no further from float64 than twice the plain version run in float32
    on the same inputs: max_val's sums S's derivatives in c1 and c2, which
    hold 1 - L and 1 - C, cancelling where the images agree. Returns
    {gradient: (max|d| / max|ref|, the plain float32 version's)}."""
    from dl4ds_tpu_torch.ops.ssim import ssim_backward_reference
    args = (k, sigma, 0.01, 0.03)
    got = fo._launch_ssim_backward(a, b, max_val, g, *args)
    again = fo._launch_ssim_backward(a, b, max_val, g, *args)
    ref = ssim_backward_reference(a.double(), b.double(), max_val.double(),
                                  g.double(), *args)
    plain = ssim_backward_reference(a, b, max_val, g, *args)
    torch.cuda.synchronize()
    errs = {}
    for name, x, x2, r, p in zip(('img1', 'img2', 'max_val'), got, again,
                                 ref, plain):
        if not torch.equal(x, x2):
            fail(f'K6 backward {label} {name}: two runs gave different bits')
        d = (x.double() - r).abs().max().item()
        dp = (p.double() - r).abs().max().item()
        scale = r.abs().max().item()
        if not (d <= K6_BWD_TOL * scale or d <= 2 * dp):
            fail(f'K6 backward {label} {name}: max|d| {d:.3e} against the '
                 f'float64 plain version, max|ref| {scale:.3e} (tolerance '
                 f'{K6_BWD_TOL} of max|ref|, or twice the plain float32 '
                 f'version\'s {dp:.3e})')
        errs[name] = (d / scale, dp / scale)
    return errs


def phase_ssim(torch, tds, report):
    """Phase 9: K6 against its plain versions in float64 at the DSSIM loss's
    shape and on its other paths, forward and backward; timed at the first;
    dssim_mae through K6 against the plain path."""
    from dl4ds_tpu_torch.ops import fused_ops as fo
    from dl4ds_tpu_torch.ops.ssim import ssim, ssim_backward_reference
    fss = tds.fused_ssim_per_image
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(9)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    cases = [(shape, 11, 1.5) for shape in K6_SHAPES] + K6_FILTERS
    rows, ran = [], {}
    for i, (shape, k, sigma) in enumerate(cases):
        a, b = _ssim_pair(torch, shape, gen, dev)
        # the loss passes its data range as a device scalar
        max_val = (torch.maximum(a.amax(), b.amax())
                   - torch.minimum(a.amin(), b.amin())) if i == 0 else 1.0
        kw = dict(filter_size=k, filter_sigma=sigma)
        got = fss(a, b, max_val, **kw)
        again = fss(a, b, max_val, **kw)
        m64 = max_val.double() if torch.is_tensor(max_val) else max_val
        ref = ssim(a.double(), b.double(), m64, **kw)
        ref32 = ssim(a, b, max_val, **kw)
        torch.cuda.synchronize()
        label = f'x{list(shape)} {k} taps'
        if got.shape != ref.shape:
            fail(f'K6 {label}: shape {tuple(got.shape)}, expected '
                 f'{tuple(ref.shape)}')
        err = (got.double() - ref).abs().max().item()
        plain_err = (ref32.double() - ref).abs().max().item()
        if not err <= K6_TOL:
            fail(f'K6 {label}: max|d| {err:.3e} against the float64 plain '
                 f'version, atol {K6_TOL}')
        if not torch.equal(got, again):
            fail(f'K6 {label}: two runs gave different bits')
        mv = max_val if torch.is_tensor(max_val) else torch.full(
            (), max_val, device=dev)
        g = torch.rand(got.shape, generator=gen, device=dev) + 0.5
        bwd_err = _check_k6_backward(torch, fo, a, b, mv, g, k, sigma, label)
        plan = fo._ssim_plan(shape, k, fo._ssim_limit(dev))
        for direction in ('fwd', 'bwd'):
            ran.setdefault((direction, plan[direction]['regime']),
                           (a, b, mv, g, k, sigma))
        row = dict(shape=list(shape), taps=k, max_abs_err=err,
                   plain_f32_err=plain_err, bwd_rel_err=bwd_err,
                   regimes=[plan['fwd']['regime'], plan['bwd']['regime']])
        if i == 0:
            ms, plain_ms = paired_ms(torch, lambda: fss(a, b, max_val),
                                     lambda: ssim(a, b, max_val), flush)
            # the backward as the loss takes it: the prediction's and the
            # range's gradients
            need = (False, True, True)
            bwd_ms, bwd_plain_ms = paired_ms(
                torch, lambda: fo._launch_ssim_backward(
                    a, b, max_val, g, 11, 1.5, 0.01, 0.03, need),
                lambda: ssim_backward_reference(a, b, max_val, g, need=need),
                flush)
            # what the parent ran: autograd through the plain version
            leaves = [b.clone().requires_grad_(),
                      max_val.clone().requires_grad_()]
            autograd_ms = statistics.median(device_times(
                torch, lambda: torch.autograd.grad(ssim(a, *leaves), leaves,
                                                   g), l2_flush=flush))
            flops, n_bytes = k6_work(shape, k)
            bound_ms = max(flops / F32_FLOPS, n_bytes / HBM_BYTES_PER_S) * 1e3
            bflops, bbytes = k6_bwd_work(shape, k, 1)
            bwd_bound_ms = max(bflops / F32_FLOPS,
                               bbytes / HBM_BYTES_PER_S) * 1e3
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=('operations' if flops / F32_FLOPS
                                 >= n_bytes / HBM_BYTES_PER_S else 'bytes'),
                       mflop=flops / 1e6, mbytes=n_bytes / 1e6,
                       bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
                       bwd_bound_ms=bwd_bound_ms,
                       bwd_bound_by=('operations' if bflops / F32_FLOPS
                                     >= bbytes / HBM_BYTES_PER_S
                                     else 'bytes'),
                       autograd_bwd_ms=autograd_ms)
        rows.append(row)
        print(f'K6 {label} {row["regimes"][0]}/{row["regimes"][1]}  max|d| '
              f'{err:.3e} against float64 (plain f32 {plain_err:.3e})  same '
              f'bits twice; backward max|d|/max|ref| (plain f32) '
              + ', '.join(f'{n} {v[0]:.1e} ({v[1]:.1e})'
                          for n, v in bwd_err.items())
              + (f'  kernel {row["ms"]:.4f} ms  plain {row["plain_ms"]:.4f} '
                 f'ms  bound {row["bound_ms"]:.4f} ms ({row["mflop"]:.1f} '
                 f'MFLOP, {row["mbytes"]:.2f} MB)  library_ms null (no '
                 f'single PyTorch call computes SSIM); backward (img2, '
                 f'max_val) kernel {row["bwd_ms"]:.4f} ms  plain '
                 f'{row["bwd_plain_ms"]:.4f} ms  bound '
                 f'{row["bwd_bound_ms"]:.4f} ms ({row["bwd_bound_by"]}); '
                 f'autograd through the plain version '
                 f'{row["autograd_bwd_ms"]:.4f} ms' if i == 0 else ''),
              flush=True)
    if set(ran) != set(SSIM_REGIMES):
        fail(f'phase 9 ran K6 in {sorted(ran)}, not all of '
             f'{sorted(SSIM_REGIMES)}')
    lib = fo._ssim_lib().dl4ds_ssim_launched
    for (direction, regime), (a, b, mv, g, k, sigma) in sorted(ran.items()):
        args = (a, b, mv, k, sigma, 0.01, 0.03)
        n = kernel_launches(
            torch, lib, (lambda: fo._launch_ssim(*args)) if direction == 'fwd'
            else (lambda: fo._launch_ssim_backward(a, b, mv, g, *args[3:])))
        print(f'K6 {direction} {regime} at x{list(a.shape)}: {n} kernel '
              f'launches a call', flush=True)
        if n != SSIM_REGIMES[(direction, regime)]:
            fail(f'K6 {direction} {regime} launched {n} kernels, expected '
                 f'{SSIM_REGIMES[(direction, regime)]}')

    # dssim_mae through K6, forward and backward, against the same loss on
    # the CPU, which runs the plain versions
    shape = K6_SHAPES[0]
    y_true = torch.randn(shape, generator=gen, device=dev)
    y_pred = torch.randn(shape, generator=gen, device=dev)
    lossf = getattr(tds.losses, FLAG_LOSS)
    results = []
    for d in ('cuda', 'cpu'):
        pred = y_pred.detach().to(d).requires_grad_()
        before = (fss.launches, fss.bwd_launches)
        value = lossf(y_true.to(d), pred)
        value.backward()
        launched = (fss.launches - before[0], fss.bwd_launches - before[1])
        results.append((value.item(), pred.grad.cpu(), launched))
    (v_gpu, g_gpu, n_gpu), (v_cpu, g_cpu, n_cpu) = results
    loss_err = abs(v_gpu - v_cpu) / abs(v_cpu)
    grad_err = ((g_gpu - g_cpu).abs().max() / g_cpu.abs().max()).item()
    print(f'{FLAG_LOSS} x{list(shape)} (standard normal, so both arrays '
          f'are shifted) through K6 vs the plain path (CPU): loss '
          f'{v_gpu:.8f} vs '
          f'{v_cpu:.8f}, relative {loss_err:.2e} (rtol {LOSS_RTOL}); y_pred '
          f'gradient max|d|/max|g| {grad_err:.2e} (atol {LOSS_GRAD_TOL} of '
          f'max|g|); K6 (forward, backward) launches {n_gpu} on the GPU, '
          f'{n_cpu} on the CPU', flush=True)
    if (n_gpu, n_cpu) != ((1, 1), (0, 0)):
        fail(f'{FLAG_LOSS} launched K6 {n_gpu} times on the GPU and {n_cpu} '
             f'on the CPU, expected (1, 1) and (0, 0)')
    if not (loss_err <= LOSS_RTOL and grad_err <= LOSS_GRAD_TOL):
        fail(f'{FLAG_LOSS} through K6 disagrees with the plain path: loss '
             f'{loss_err:.3e}, gradient {grad_err:.3e}')
    report['k6_rows'] = rows
    report['k6_loss_check'] = dict(loss_rel_err=loss_err,
                                   grad_rel_err=grad_err)


def _gate_inputs(torch, tds, config, batch=TRAIN_BATCH):
    """The input shapes of the flagship's K1 gates in a training step, in
    order, read by hooks on one forward of a training batch."""
    from dl4ds_tpu_torch.models.blocks import ChannelAttention2D
    tr = tds.SupervisedTrainer(batch_size=batch, epochs=1, **config)
    tr.setup_datagen()
    tr.setup_model()
    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append(tuple(inp[0].shape)))
        for m in tr.net.modules() if isinstance(m, ChannelAttention2D)]
    gen = torch.Generator().manual_seed(0)
    batch = tr.ds_train(tr.ds_train.epoch_indices(gen, steps=1)[0],
                        generator=gen)
    with torch.no_grad():
        tr.net(batch['lr'], batch['aux'])
    for h in hooks:
        h.remove()
    return shapes


def _flagship_per_step(per_forward, ssim=True):
    """The launches of a flagship training step (a gate's forward and
    backward per gate, K6 once each way with a DSSIM loss, `ssim`) and of
    an evaluation step."""
    none = {'K2-train': 0, 'K2 inference': 0, 'K3': 0, 'K4': 0}
    k6 = int(ssim)
    return {'train': dict(none, **{'K1': per_forward,
                                   'K1 backward': per_forward, 'K6': k6,
                                   'K6 backward': k6}),
            'eval': dict(none, **{'K1': per_forward, 'K1 backward': 0,
                                  'K6': k6, 'K6 backward': 0})}


def phase_flagship_training(torch, tds, report):
    """Phase 10: the flagship training with dssim_mae on the card: K1 timed
    at the step's gate shapes (kernel and plain, forward and backward, the
    backward also held against the float64 plain version), then the
    trainer driven as phases 7 and 8."""
    from dl4ds_tpu_torch.ops import fused_ops as fo
    fca, ref = tds.fused_channel_attention, tds.channel_attention_reference
    config = _training_config(loss=FLAG_LOSS, n_filters=N_FILTERS,
                              n_blocks=N_BLOCKS, attention=True)
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(10)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    shapes = _gate_inputs(torch, tds, config)
    if shapes != K1_TRAIN_SHAPES:
        fail(f'the flagship step\'s gates are {shapes}, not the '
             f'{K1_TRAIN_SHAPES} phase 2 checked')
    rows = []
    for shape in shapes:
        c = shape[-1]
        cr = max(int(c / 4), 1)
        x, weights, dy = _gate_case(torch, gen, dev, shape, cr, torch.float32)
        err = (fca(x, *weights) - ref(x, *weights)).abs().max().item()
        if not err <= K1_TOL['float32']['atol']:
            fail(f'K1 x{list(shape)}: max|d| {err:.3e}')
        bwd_err = _check_k1_backward(torch, fo, x, weights, dy,
                                     f'training gate x{list(shape)}')
        ms, plain_ms = paired_ms(torch, lambda: fca(x, *weights),
                                 lambda: ref(x, *weights), flush)
        _, m, g = fo._launch(x, *weights)
        bwd_ms, bwd_plain_ms = paired_ms(
            torch, lambda: fo._launch_backward(x, *weights, dy, m, g),
            lambda: fo._channel_attention_backward(x, *weights, dy, m, g),
            flush)
        n_bytes = 2 * x.numel() * 4 + 4 * (2 * c * cr + c + cr)
        n_ops = 2 * x.numel() + 4 * shape[0] * c * cr
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS) * 1e3
        rows.append(dict(shape=list(shape), cr=cr, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bwd_rel_err=bwd_err, bwd_ms=bwd_ms,
                         bwd_plain_ms=bwd_plain_ms,
                         bwd_bound_ms=k1_bwd_bound_ms(x, cr)))
        print(f'K1 training gate x{list(shape)} cr={cr}  max|d| {err:.3e}  '
              f'kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound '
              f'{bound_ms:.4f} ms (bytes); backward max|d|/max|ref| '
              + _k1_bwd_errors(bwd_err)
              + f'  kernel {bwd_ms:.4f} ms  plain {bwd_plain_ms:.4f} ms  '
              f'bound {rows[-1]["bwd_bound_ms"]:.4f} ms (bytes)', flush=True)
    report['k1_train_rows'] = rows
    per_forward = len(rows)
    k6 = report['k6_rows'][0]
    got, calls, numbers = _drive_training(
        torch, tds, config, f'n_filters {N_FILTERS}, {FLAG_LOSS}',
        TRAIN_STEPS, _flagship_per_step(per_forward), FLAG_CPU_BATCH,
        {'K1 forward': sum(r['ms'] for r in rows),
         'K1 backward': sum(r['bwd_ms'] for r in rows),
         'K6': k6['ms'], 'K6 backward': k6['bwd_ms']})
    report.update(flag_k1_launches=got['K1'],
                  flag_k1_bwd_launches=got['K1 backward'],
                  k6_launches=got['K6'], k6_bwd_launches=got['K6 backward'],
                  flag_k1_calls=calls['K1'],
                  flag_k1_bwd_calls=calls['K1 backward'],
                  k6_calls=calls['K6'], k6_bwd_calls=calls['K6 backward'],
                  flag_k1_per_forward=per_forward)
    report.update({f'flag_{k}': v for k, v in numbers.items()})


# phase 11: steps of each eager-vs-graphed comparison
GRAPH_STEPS = 8


def _max_diff(a, b):
    return max((x.double() - y.double()).abs().max().item()
               for x, y in zip(a, b))


def _replay_profile(torch, runner, plan, run=None):
    """(the device kernels, busy ms, span ms) of one `runner.train(plan)`
    (a chunk of replays with its plan upload), or of `run()`, under
    torch.profiler; busy is the union of the kernels' intervals. The chunk
    runs twice in the trace,
    PROFILE_GUARD_S apart, and the second is read (the kernels after the
    widest gap on the device): the first is the profiler's warm-up. A
    trace of one chunk lost 4 of 400 K2 launches (one layer's T) both
    times it was taken in one full run of this script (phase 16 (b) on the
    H100), and 2 of 480 once in phase 15 (c)."""
    run = run or (lambda: runner.train(plan))
    with _device_trace(torch) as prof:
        run()
        torch.cuda.synchronize()
        time.sleep(PROFILE_GUARD_S)
        run()
    kernels = sorted(_device_kernels(torch, prof),
                     key=lambda e: e.time_range.start)
    if not kernels:
        fail('torch.profiler recorded no kernel of the replays')
    gaps, end = [], kernels[0].time_range.end
    for i, e in enumerate(kernels[1:], 1):
        gaps.append((e.time_range.start - end, i))
        end = max(end, e.time_range.end)
    gap, split = max(gaps)
    if gap < PROFILE_GUARD_S * 1e6 / 2:
        fail(f'no gap between the two traced chunks of replays (widest '
             f'{gap} us)')
    kernels = kernels[split:]
    busy, end = 0, None
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in kernels):
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    return kernels, busy / 1e3, span / 1e3


def _graphs_vs_eager(torch, tds, fo, config, label, per_step,
                     batch=TRAIN_BATCH):
    """GRAPH_STEPS training steps of `config` at batch TRAIN_BATCH through
    `run()`'s captured graphs and as many eager `train_step`s from the same
    seed (weights) and plan: the same bits in every loss, parameter and EMA
    weight. Checks the graphed run's launches and replays (`_check_launches`)
    and the arrival counters. Returns the row."""
    args = dict(batch_size=batch, epochs=1, steps_per_epoch=GRAPH_STEPS,
                validation_steps=1, test_steps=1, **config)
    graphed = tds.SupervisedTrainer(**args)
    _, calls, kernels = _traced_run(torch, tds, graphed)
    runner = graphed.runner
    k = graphed.gradient_accumulation_steps
    replays = ({'step': GRAPH_STEPS} if k == 1 else
               {'accumulate': GRAPH_STEPS - GRAPH_STEPS // k,
                'commit': GRAPH_STEPS // k})
    got = _check_launches(tds, runner, f'phase 11 ({label})', per_step,
                          dict(replays, val=1, test=1), calls, kernels)
    busy = [name for name, t in fo._COUNTERS.items()
            if int(t.count_nonzero()) != 0]
    if busy:
        fail(f'phase 11 ({label}): arrival counters {busy} not left at 0')

    eager = tds.SupervisedTrainer(**args)
    eager.setup_datagen()
    eager.setup_model()
    eager.setup_optimizer()
    eager.train_net.train()
    plan = eager.ds_train.plan(torch.Generator().manual_seed(eager.seed),
                               GRAPH_STEPS)
    # whole grids (patch_size None) have no offsets in the plan
    losses = torch.stack([eager.train_step(eager.ds_train(
        plan['idx'][c], offsets=((plan['ys'][c], plan['xs'][c])
                                 if 'ys' in plan else None)))
        for c in range(GRAPH_STEPS)])
    pairs = {'losses': ([losses], [graphed.train_losses]),
             'parameters': (list(eager.train_net.parameters()),
                            list(graphed.train_net.parameters()))}
    if eager.ema_net is not None:
        pairs['EMA'] = (list(eager.ema_net.parameters()),
                        list(graphed.ema_net.parameters()))
    diffs = {what: _max_diff(a, b) for what, (a, b) in pairs.items()}
    row = dict(label=label, graphs=sorted(runner.graphs), launches=got,
               wrapper_calls=calls, per_step=per_step,
               replays={g: c.replays for g, c in runner.graphs.items()},
               max_abs_diff=diffs, n_updates=graphed.n_updates)
    print(f'phase 11, {label}: {GRAPH_STEPS} steps through run()\'s graphs '
          f'{sorted(runner.graphs)} against {GRAPH_STEPS} eager train_steps '
          f'from the same weights and plan: max|d| {diffs} (bit-identical '
          f'required)', flush=True)
    if any(d != 0 for d in diffs.values()):
        fail(f'phase 11 ({label}): graphed and eager steps differ: max|d| '
             f'{diffs}')
    if k > 1:
        # the two graphs' replays: what the commit adds (the update, the
        # rate, the EMA) is what one graph blending the two would spend on
        # every microbatch
        for name in ('accumulate', 'commit'):
            graph = runner.graphs[name]

            def replay(graph=graph):
                graphed._row.zero_()
                graph.replay()
            row[f'{name}_replay_ms'] = statistics.median(
                device_times(torch, replay, reps=10))
        print(f'phase 11, {label}: one replay of the accumulate graph '
              f'{row["accumulate_replay_ms"]:.3f} ms, of the commit graph '
              f'{row["commit_replay_ms"]:.3f} ms (CUDA events, cuDNN '
              f'deterministic); {card_line()}', flush=True)
    return row


def phase_graphs(torch, tds, report):
    """Phase 11: the replayed graphs against eager steps, bit for bit, on
    the three training paths and the flagship with EMA, accumulation and
    a cosine schedule, with their launches; then the speed of the graphs
    of phases 7, 8 and 10 beside their eager steps."""
    import dl4ds_tpu_torch.ops.convlstm as conv
    from dl4ds_tpu_torch.ops import fused_ops as fo
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    flagship = _training_config(loss=FLAG_LOSS, n_filters=N_FILTERS,
                                n_blocks=N_BLOCKS, attention=True)
    flag_steps = _flagship_per_step(report['flag_k1_per_forward'])
    rows = [
        _graphs_vs_eager(torch, tds, fo, flagship,
                         f'resnet_spc, {FLAG_LOSS}', flag_steps),
        _graphs_vs_eager(
            torch, tds, fo, dict(flagship, ema_decay=0.99,
                                 gradient_accumulation_steps=2,
                                 lr_schedule='cosine'),
            f'resnet_spc, {FLAG_LOSS}, EMA 0.99, 2 microbatches, cosine',
            flag_steps),
        _graphs_vs_eager(
            torch, tds, fo, _training_config(
                loss='mae', time_window=REC_T, n_blocks=REC_BLOCKS,
                n_filters=N_FILTERS),
            f'recresnet_spc, n_filters {N_FILTERS}',
            _recurrent_per_step(conv, K3_LAYERS)),
        _graphs_vs_eager(
            torch, tds, fo, _training_config(
                loss='mae', time_window=REC_T, n_blocks=REC_BLOCKS,
                n_filters=WIDE_F, attention=True),
            f'recresnet_spc, n_filters {WIDE_F}',
            _recurrent_per_step(conv, WIDE_LAYERS))]
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved
    report['graph_rows'] = rows
    card = card_line()
    for prefix, label in (('flag', f'resnet_spc, {FLAG_LOSS}'),
                          ('train', f'recresnet_spc, n_filters {N_FILTERS}'),
                          ('wide', f'recresnet_spc, n_filters {WIDE_F}')):
        g = report[f'{prefix}_graphed']
        print(f'phase 11, {label}, batch {TRAIN_BATCH} (phases 7, 8, 10\'s '
              f'trainer, cuDNN as PyTorch defaults it): graphed '
              f'{g["patches_per_s"]:.1f} patches/s, eager '
              f'{report[prefix + "_patches_per_s"]:.1f} patches/s (host '
              f'clock); one replay {g["replay_ms"]:.3f} ms, one eager step '
              f'{report[prefix + "_step_ms"]:.3f} ms (CUDA events); the '
              f'device busy {100 * g["busy_share"]:.1f}% of the replays\' '
              f'span; {card}', flush=True)


# ---------------------------------------------------------------------------
# Phase 12: the bfloat16 model dtype
# ---------------------------------------------------------------------------

# the bfloat16 products' ceilings: mma.sync m16n8k16, which the bfloat16
# forms of K2, K3 and K4 run on, measured at 643.0 TFLOP/s
# (tools/torch_mma_peak.py on an NVIDIA H100 80GB HBM3 at 700 W), and the
# published dense bfloat16 rate of the tensor cores (wgmma), the bound_ms of
# the kernels line
BF16_MMA_SYNC_FLOPS = 643e12
BF16_FLOPS = 989e12
# a stored bfloat16 value against its plain version at the same rounding
# points: within 2 bfloat16 ulps of max |ref| (a float32 sum in another
# order flips a rounding now and then); a recurrence is held step by step
# (each plain step from the kernel's own previous states), since one flip
# near a gate's steep part is carried through the later steps
BF16_STORED_TOL = 1e-2
# ... and at most this share of them differ at all: summing the products
# in another order flips 1.1e-5 to 1.2e-4 of the stored values of a plain
# layer or chain (float64 sums against float32, on the CPU), while a kernel
# that kept float32 between the gate ops, rounding only what it stores,
# would differ at 53-61% of them (the plain versions run in float32; both
# held step by step; tests/test_torch_bf16.py
# test_differ_share_bound_tells_rounding_points_from_sum_order). Each check
# plants that variant as a control, which must fail the bound.
BF16_DIFFER_SHARE = 1e-2
# float32 values formed after the bfloat16 rounding points (K1's mixed y,
# db1, db2) from the same bfloat16 values: float32 sums in another order.
# Leaving m @ w1 unrounded, as the jitted JAX gate does, moves y by 1.6e-4
# (tests/test_torch_bf16.py)
BF16_F32_TOL = 1e-5
# bfloat16 predict's grid 0 against the CPU's: mean |d| / mean |y| at most
# this share of the float32 model's. A mean, not a max: the bfloat16
# flagship moves with the order of its convolutions' sums alone by 1.4e-3
# in the mean and 5.6e-3 of max |y| in the max, against the float32
# model's 8.9e-3 and 1.2e-2 (on the CPU; tests/test_torch_bf16_models.py
# test_bf16_flagship_output_moves_with_the_sum_order_alone), and on the
# card neither the plain gate in place of K1 nor CPU-style convolutions in
# place of cuDNN's close its gap to the CPU (tools/torch_bf16_gap.py,
# PERF.md)
BF16_PREDICT_RATIO = 0.5
# K1's mixed mode on a sample whose float32 dy does not fit a block and
# whose H*W*C is odd: the stream regime with 1-element packs
K1_MIXED_PATHS = [((1, 157, 131, 3), 1)]


def _rel_err(a, ref):
    ref = ref.double()
    return ((a.double() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


def _bf16_bounds(flops, n_bytes):
    """(bound_ms at the dense bfloat16 rate, bound_ms at the mma.sync
    bfloat16 peak, what bounds it) of work of `flops` and `n_bytes`."""
    mem = n_bytes / HBM_BYTES_PER_S
    return (max(flops / BF16_FLOPS, mem) * 1e3,
            max(flops / BF16_MMA_SYNC_FLOPS, mem) * 1e3,
            'operations' if flops / BF16_FLOPS >= mem else 'bytes')


def _check_k1_mixed(torch, fo, x, weights, dy, label):
    """K1's mixed mode (bfloat16 x, float32 y and dy, bfloat16 dx) against
    its plain versions: y within BF16_F32_TOL of max |ref| of
    `channel_attention_reference(..., out_dtype=float32)`; the backward, on
    the forward kernel's mean and gate, against `_backward_mixed` with
    float64 sums: dx and the bfloat16-rounded dw1 and dw2 within
    BF16_STORED_TOL, db1 and db2 within BF16_F32_TOL; the same bits twice
    each way. Returns the errors."""
    f32 = torch.float32
    y, m, g = fo._launch(x, *weights, mixed=True)
    y2, _, _ = fo._launch(x, *weights, mixed=True)
    ref = fo.channel_attention_reference(x, *weights, out_dtype=f32)
    grads = fo._launch_backward(x, *weights, dy, m, g, mixed=True)
    again = fo._launch_backward(x, *weights, dy, m, g, mixed=True)
    want = fo._backward_mixed(x, *(t.double() for t in weights), dy.double(),
                              m.double(), g.double())
    torch.cuda.synchronize()
    if y.dtype != f32 or grads[0].dtype != torch.bfloat16:
        fail(f'K1 mixed {label}: y {y.dtype}, dx {grads[0].dtype}')
    if not torch.equal(y, y2):
        fail(f'K1 mixed {label}: two forward runs gave different bits')
    errs = {'y': _rel_err(y, ref)}
    tols = {'y': BF16_F32_TOL}
    for name, a, a2, r, tol in zip(
            ('dx', 'dw1', 'db1', 'dw2', 'db2'), grads, again, want,
            (BF16_STORED_TOL, BF16_STORED_TOL, BF16_F32_TOL, BF16_STORED_TOL,
             BF16_F32_TOL)):
        if not torch.equal(a, a2):
            fail(f'K1 mixed backward {label} {name}: two runs gave '
                 f'different bits')
        errs[name], tols[name] = _rel_err(a, r), tol
    bad = {k: v for k, v in errs.items() if not v <= tols[k]}
    if bad:
        fail(f'K1 mixed {label}: max|d| / max|ref| {bad} over {tols}')
    return errs


def _differ_share(got, want):
    """The share of stored values of `got` that differ from `want` at all,
    the largest over the tensors."""
    return max((a != b).float().mean().item() for a, b in zip(got, want))


def _check_share(got, want, control, label):
    """`got` (a kernel's stored bfloat16 tensors) differs from `want` (its
    plain version's, held step by step) at no more than BF16_DIFFER_SHARE
    of its values, and `control` (the plain version with float32 between
    the ops, its stored tensors rounded) at more. Returns both shares."""
    share = _differ_share(got, want)
    control_share = _differ_share([u.to(w.dtype) for u, w in
                                   zip(control, want)], want)
    if not share <= BF16_DIFFER_SHARE < control_share:
        fail(f'{label}: {share:.2e} of the stored values differ from the '
             f'plain version, the float32-within-a-step control '
             f'{control_share:.2e}; the bound {BF16_DIFFER_SHARE} must '
             f'hold the first and not the second')
    return share, control_share


def _check_k2_bf16(torch, conv, x, wx, bx, wh, label):
    """K2's bfloat16 training variant held step by step against its plain
    version (ys, cs, zs within BF16_STORED_TOL of max |ref|, at most
    BF16_DIFFER_SHARE of them differing, `_check_share`), its inference
    variant's ys equal to the training variant's, and the same bits twice.
    Returns the residuals (ys, cs, zs), the three errors and (the differing
    share, the control's)."""
    with torch.no_grad():
        got = conv._launch(x, wx, bx, wh, train=True)
        again = conv._launch(x, wx, bx, wh, train=True)
        ys_inf = conv._launch(x, wx, bx, wh)
        want = conv.convlstm_train_reference(x, wx, bx, wh, states=got[:2])
        control = conv.convlstm_train_reference(
            *(u.float() for u in (x, wx, bx, wh)),
            states=[u.float() for u in got[:2]])
    torch.cuda.synchronize()
    errs = [_rel_err(a, r) for a, r in zip(got, want)]
    if any(u.dtype != torch.bfloat16 for u in got) or not \
            max(errs) <= BF16_STORED_TOL:
        fail(f'K2 bf16 {label}: ys, cs, zs max|d| / max|ref| {errs} '
             f'(dtypes {[str(u.dtype) for u in got]}) against '
             f'{BF16_STORED_TOL}')
    shares = _check_share(got, want, control, f'K2 bf16 {label}')
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f'K2 bf16 {label}: two runs gave different bits')
    if not torch.equal(ys_inf, got[0]):
        fail(f'K2 bf16 {label}: the inference variant\'s ys differ from the '
             f'training variant\'s')
    return got, errs, shares


def _check_bptt_bf16(torch, conv, x, wx, bx, wh, dys, need_dx, route, label):
    """One bfloat16 layer's BPTT by `route` ('fused': K3; 'split': K4 and
    the GEMM tail) on K2's residuals: the route's own chain kernel's dzs
    held step by step against the plain chain (at most BF16_DIFFER_SHARE
    of them differing, `_check_share`), and dx, dWx, dbx and dWh against
    the plain tail run in float64 on those dzs (each within
    BF16_STORED_TOL of max |ref|: one rounding to bfloat16); the same bits
    twice. Returns the errors."""
    (ys, cs, zs), fwd, fwd_shares = _check_k2_bf16(torch, conv, x, wx, bx,
                                                   wh, label)
    with torch.no_grad():
        args = (x, wx, wh, zs, cs, ys, dys)
        grads = conv._backward(route, *args, need_dx)
        again = conv._backward(route, *args, need_dx)
        dzs = conv._chain(zs, cs, dys, wh, 'bwd_launches' if route == 'fused'
                          else 'seq_launches')
        chain = conv.convlstm_seq_reference(zs, cs, dys, wh, given=dzs)
        control = conv.convlstm_seq_reference(
            *(u.float() for u in (zs, cs, dys, wh)), given=dzs.float())
        ref = conv.convlstm_backward_tail(
            *(u.double() for u in (x, wx, wh, ys, dzs)), need_dx)
    torch.cuda.synchronize()
    errs = {'chain': _rel_err(dzs, chain)}
    shares = _check_share([dzs], [chain], [control],
                          f'{route} bf16 {label} chain')
    for name, a, a2, r in zip(('dx', 'dwx', 'dbx', 'dwh'), grads, again, ref):
        if a is None:
            if need_dx or name != 'dx':
                fail(f'{route} bf16 {label}: no {name}')
            continue
        if a.dtype != torch.bfloat16 or a.shape != r.shape:
            fail(f'{route} bf16 {label}: {name} {a.dtype} {tuple(a.shape)}')
        if not torch.equal(a, a2):
            fail(f'{route} bf16 {label}: {name} differs between two runs')
        errs[name] = _rel_err(a, r)
    if not max(errs.values()) <= BF16_STORED_TOL:
        fail(f'{route} bf16 {label}: max|d| / max|ref| {errs} against '
             f'{BF16_STORED_TOL}')
    return dict(ys_cs_zs_err=fwd, grad_rel_err=errs,
                differ_share=dict(k2=fwd_shares, chain=shares))


def _bf16_kernels(torch, tds, report):
    """Phase 12, the kernels: K1's mixed mode in both regimes of its plan,
    K2 (both variants), K3 and K4 with the GEMM tail in bfloat16, each
    against its plain version; every compiled bfloat16 body run; times
    against the plain versions and the bounds."""
    from dl4ds_tpu_torch.ops import convlstm as conv
    from dl4ds_tpu_torch.ops import fused_ops as fo
    bf, f32 = torch.bfloat16, torch.float32
    dev = torch.device('cuda')
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    limits = fo._ca_limits(dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    torch.backends.cudnn.allow_tf32 = False      # plain float32 sums
    torch.backends.cuda.matmul.allow_tf32 = False

    # K1's mixed mode: the serving and training gates and the other paths
    k1_rows, ran = [], {}
    serving = [(BATCH,) + shape for shape in K1_SHAPES]
    cases = ([(shape, max(int(shape[-1] / 4), 1), False)
              for shape in serving + K1_TRAIN_SHAPES]
             + [(shape, cr, True) for shape, cr in K1_OTHER_PATHS
                + K1_MIXED_PATHS])
    for shape, cr, glorot in cases:
        x, weights, dy = _gate_case(torch, gen, dev, shape, cr, f32,
                                    glorot=glorot)
        x = x.to(bf)
        errs = _check_k1_mixed(torch, fo, x, weights, dy, f'x{list(shape)}')
        plan = fo._ca_plan(shape, cr, bf, *limits, out_dtype=f32)
        ran.setdefault((plan['regime'], plan['vec']), (x, weights, dy))
        row = dict(shape=list(shape), cr=cr, regime=plan['regime'],
                   vec=plan['vec'], rel_err=errs)
        if not glorot:
            ms, plain_ms = paired_ms(
                torch, lambda: fo._launch(x, *weights, mixed=True),
                lambda: fo.channel_attention_reference(x, *weights,
                                                       out_dtype=f32), flush)
            _, m, g = fo._launch(x, *weights, mixed=True)
            bwd_ms, bwd_plain_ms = paired_ms(
                torch, lambda: fo._launch_backward(x, *weights, dy, m, g,
                                                   mixed=True),
                lambda: fo._backward_mixed(x, *weights, dy, m, g), flush)
            c, w_bytes = shape[-1], 4 * (2 * shape[-1] * cr + shape[-1] + cr)
            n_ops = 2 * x.numel() + 4 * shape[0] * c * cr
            row.update(
                ms=ms, plain_ms=plain_ms, bwd_ms=bwd_ms,
                bwd_plain_ms=bwd_plain_ms,
                bound_ms=max((6 * x.numel() + w_bytes) / HBM_BYTES_PER_S,
                             n_ops / F32_FLOPS) * 1e3,
                bwd_bound_ms=(8 * x.numel() + 2 * w_bytes)
                / HBM_BYTES_PER_S * 1e3)
        k1_rows.append(row)
        print(f'K1 mixed x{list(shape)} cr={cr} {plan["regime"]} '
              f'({plan["vec"]}-element packs): max|d|/max|ref| '
              + ', '.join(f'{k} {v:.1e}' for k, v in errs.items())
              + (f'  kernel {row["ms"]:.4f} ms (plain {row["plain_ms"]:.4f}, '
                 f'bound {row["bound_ms"]:.4f}), backward {row["bwd_ms"]:.4f} '
                 f'ms (plain {row["bwd_plain_ms"]:.4f}, bound '
                 f'{row["bwd_bound_ms"]:.4f})' if 'ms' in row else ''),
              flush=True)
    want_bodies = {(r, v) for r in CA_REGIMES for v in (8, 1)}
    if set(ran) != want_bodies:
        fail(f'phase 12 ran K1\'s mixed mode in {sorted(ran)}, not all of '
             f'{sorted(want_bodies)}')
    lib = fo._ca_lib().dl4ds_ca_launched
    for (regime, vec), (x, weights, dy) in sorted(ran.items()):
        _, m, g = fo._launch(x, *weights, mixed=True)
        fwd = kernel_launches(torch, lib,
                              lambda: fo._launch(x, *weights, mixed=True))
        bwd = kernel_launches(torch, lib, lambda: fo._launch_backward(
            x, *weights, dy, m, g, mixed=True))
        if fwd != CA_REGIMES[regime] or bwd != CA_REGIMES[regime]:
            fail(f'K1 mixed {regime} regime launched {fwd} forward and {bwd} '
                 f'backward kernels, expected {CA_REGIMES[regime]} each')
    print(f'K1 mixed mode ran every body: {sorted(ran)}', flush=True)

    # K2 in bfloat16: the serving layers, the training layers at both
    # widths, width 64 at 32x32 (16 channels a block in inference) and the
    # other paths; every body (fs, variant, launch kind) must run
    bodies, k2_rows = set(), []
    shapes = ([(BATCH, REC_T, LR, LR) + layer for layer in
               dict.fromkeys(K2_LAYERS)]
              + [(BATCH, REC_T, K2_WIDE_LR, K2_WIDE_LR) + layer
                 for layer in K2_WIDE]
              + [(TRAIN_BATCH, REC_T, TRAIN_LR, TRAIN_LR) + layer for layer in
                 dict.fromkeys(K3_LAYERS + WIDE_LAYERS)])
    shapes = [(b, t, h, w, cin, f, k, k) for b, t, h, w, cin, f, k in shapes]
    for i, (b, t, h, w, cin, f, kh, kw) in enumerate(shapes + K2_OTHER_PATHS):
        wx, bx, wh = (u.to(bf) for u in _layer_weights(
            torch, cin, f, kh, kw, 1200 + i, dev))
        x = torch.randn((b, t, h, w, cin), generator=gen, device=dev).to(bf)
        _, errs, shares = _check_k2_bf16(
            torch, conv, x, wx, bx, wh, f'x{[b, t, h, w, cin]} F={f} '
            f'{kh}x{kw}')
        plan = conv._fwd_plan(b, t, h, w, kh, kw, f, n_sm, 2)
        for train in (0, 1):
            bodies.add((plan['fs'], train, 'input'))
            if t > 1:
                bodies.add((plan['fs'], train, 'step'))
        k2_rows.append(dict(x=[b, t, h, w, cin], f=f, k=[kh, kw],
                            fs=plan['fs'], ys_cs_zs_err=errs,
                            differ_share=shares))
    want_bodies = {(fs, tr, kind) for fs in (8, 16) for tr in (0, 1)
                   for kind in ('input', 'step')}
    if bodies != want_bodies:
        fail(f'phase 12 ran K2\'s bfloat16 bodies {sorted(bodies)}, not all '
             f'of {sorted(want_bodies)}')
    print(f'K2 bf16: {len(k2_rows)} shapes held step by step, max|d| / '
          f'max|ref| of ys, cs, zs '
          f'{max(max(r["ys_cs_zs_err"]) for r in k2_rows):.3e}, differing '
          f'at most {max(r["differ_share"][0] for r in k2_rows):.2e} of '
          f'them (the float32-within-a-step control at least '
          f'{min(r["differ_share"][1] for r in k2_rows):.2e}); every body '
          f'ran ({len(bodies)})', flush=True)

    def k2_time(layers, b, size, train):
        rows = []
        for j, (cin, f, k) in enumerate(layers):
            wx, bx, wh = (u.to(bf) for u in _layer_weights(
                torch, cin, f, k, k, 1300 + j, dev))
            x = torch.randn((b, REC_T, size, size, cin), generator=gen,
                            device=dev).to(bf)
            with torch.no_grad():
                ms, plain_ms = paired_ms(
                    torch, lambda: conv._launch(x, wx, bx, wh, train=train),
                    lambda: conv.convlstm_train_reference(x, wx, bx, wh),
                    flush)
            flops, n_bytes = k2_work(x, wx, wh)
            bound, bound_mma, by = _bf16_bounds(flops, n_bytes / 2)
            rows.append(dict(x=list(x.shape), f=f, k=k, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound,
                             bound_mma_sync_ms=bound_mma, bound_by=by))
        return rows
    k2_serve = k2_time(K2_LAYERS, BATCH, LR, False)
    k2_step = k2_time(K3_LAYERS, TRAIN_BATCH, TRAIN_LR, True)
    k2_wide = k2_time(WIDE_LAYERS, TRAIN_BATCH, TRAIN_LR, True)
    for name, rows in (('serving (batch 8, 128x128)', k2_serve),
                       ('width-8 step', k2_step), ('width-64 step', k2_wide)):
        print(f'K2 bf16 {name}, {len(rows)} layers: kernel '
              f'{sum(r["ms"] for r in rows):.4f} ms, plain '
              f'{sum(r["plain_ms"] for r in rows):.4f} ms, bound '
              f'{sum(r["bound_ms"] for r in rows):.4f} ms (mma.sync '
              f'{sum(r["bound_mma_sync_ms"] for r in rows):.4f})', flush=True)

    # K3 ('fused') and K4 + the tail ('split') in bfloat16
    reached, k3_rows, k4_rows = set(), [], []
    k3_cases = [(TRAIN_BATCH, REC_T, TRAIN_LR, TRAIN_LR, cin, f, k, k,
                 cin != 1) for cin, f, k in dict.fromkeys(K3_LAYERS
                                                          + WIDE_LAYERS)]
    for i, (b, t, h, w, cin, f, kh, kw, need_dx) in enumerate(
            k3_cases + K3_OTHER_PATHS):
        wx, bx, wh = (u.to(bf) for u in _layer_weights(
            torch, cin, f, kh, kw, 1400 + i, dev))
        x = torch.randn((b, t, h, w, cin), generator=gen, device=dev).to(bf)
        dys = torch.randn((b, t, h, w, f), generator=gen,
                          device=dev).to(bf)
        row = _check_bptt_bf16(torch, conv, x, wx, bx, wh, dys, need_dx,
                               'fused', f'x{[b, t, h, w, cin]} F={f} '
                               f'{kh}x{kw}')
        row.update(x=[b, t, h, w, cin], f=f, k=[kh, kw], plans=_note_plans(
            conv, reached, b, t, h, w, cin, f, kh, kw, need_dx, n_sm, 2))
        k3_rows.append(row)
    k4_cases = [(TRAIN_BATCH, REC_T, TRAIN_LR, TRAIN_LR, cin, f, k, k,
                 cin != 1) for cin, f, k in dict.fromkeys(WIDE_LAYERS)]
    for i, (b, t, h, w, cin, f, kh, kw, need_dx) in enumerate(
            k4_cases + K4_OTHER_PATHS):
        wx, bx, wh = (u.to(bf) for u in _layer_weights(
            torch, cin, f, kh, kw, 1500 + i, dev))
        x = torch.randn((b, t, h, w, cin), generator=gen, device=dev).to(bf)
        dys = torch.randn((b, t, h, w, f), generator=gen,
                          device=dev).to(bf)
        row = _check_bptt_bf16(torch, conv, x, wx, bx, wh, dys, need_dx,
                               'split', f'x{[b, t, h, w, cin]} F={f} '
                               f'{kh}x{kw}')
        row.update(x=[b, t, h, w, cin], f=f, k=[kh, kw], plans=_note_plans(
            conv, reached, b, t, h, w, cin, f, kh, kw, False, n_sm, 2,
            'split'))
        k4_rows.append(row)
    bodies = {r for r in reached if r[0] in ('chain', 'split chain', 'dx')}
    if bodies != PLAN_BODIES:
        fail(f'phase 12 ran the chain-step tile\'s bfloat16 bodies '
             f'{sorted(bodies)}, not all of {sorted(PLAN_BODIES)}')
    print(f'K3 bf16: {len(k3_rows)} layers, max|d| / max|ref| '
          f'{max(max(r["grad_rel_err"].values()) for r in k3_rows):.3e}; K4 '
          f'and the tail bf16: {len(k4_rows)} layers, '
          f'{max(max(r["grad_rel_err"].values()) for r in k4_rows):.3e}; '
          f'chain dzs differing at most '
          f'{max(r["differ_share"]["chain"][0] for r in k3_rows + k4_rows):.2e}'
          f' (the float32-within-a-step control at least '
          f'{min(r["differ_share"]["chain"][1] for r in k3_rows + k4_rows):.2e}'
          f'); the chain tile ran every bfloat16 body ({len(bodies)})',
          flush=True)

    def bptt_time(layers, route):
        rows = []
        for j, (cin, f, k) in enumerate(layers):
            wx, bx, wh = (u.to(bf) for u in _layer_weights(
                torch, cin, f, k, k, 1600 + j, dev))
            x = torch.randn((TRAIN_BATCH, REC_T, TRAIN_LR, TRAIN_LR, cin),
                            generator=gen, device=dev).to(bf)
            need_dx = cin != 1
            with torch.no_grad():
                ys, cs, zs = conv._launch(x, wx, bx, wh, train=True)
                dys = torch.randn_like(ys)
                if route == 'fused':
                    args = (x, wx, wh, zs, cs, ys, dys)
                    ms, plain_ms = paired_ms(
                        torch, lambda: conv._launch_backward(*args, need_dx),
                        lambda: conv.convlstm_backward_reference(*args),
                        flush)
                    flops, n_bytes = k3_work(x, wx, wh, need_dx)
                    row = dict(ms=ms, plain_ms=plain_ms)
                else:
                    ms, plain_ms = paired_ms(
                        torch, lambda: conv._launch_seq(zs, cs, dys, wh),
                        lambda: conv.convlstm_seq_reference(zs, cs, dys, wh),
                        flush)
                    dzs = conv._launch_seq(zs, cs, dys, wh)
                    tail_ms = statistics.median(device_times(
                        torch, lambda: conv.convlstm_backward_tail(
                            x, wx, wh, ys, dzs, need_dx), l2_flush=flush))
                    flops, n_bytes = k4_work(zs, wh)
                    tf, tb = tail_work(x, wx, wh, need_dx)
                    row = dict(ms=ms, plain_ms=plain_ms, tail_ms=tail_ms,
                               tail_bound_ms=_bf16_bounds(tf, tb / 2)[0])
            bound, bound_mma, by = _bf16_bounds(flops, n_bytes / 2)
            row.update(x=list(x.shape), f=f, k=k, bound_ms=bound,
                       bound_mma_sync_ms=bound_mma, bound_by=by)
            rows.append(row)
        return rows
    # each width-64 layer timed on the route that the bfloat16 step takes
    wide = {route: [layer for layer in WIDE_LAYERS if conv.dispatch_info(
        (TRAIN_BATCH, REC_T, TRAIN_LR, TRAIN_LR, layer[0]),
        (layer[2], layer[2], layer[0], 4 * layer[1]),
        (layer[2], layer[2], layer[1], 4 * layer[1]), 2)['path'] == route]
        for route in ('fused', 'split')}
    k3_step = bptt_time(K3_LAYERS, 'fused')
    k3_wide = bptt_time(wide['fused'], 'fused')
    k4_step = bptt_time(wide['split'], 'split')

    def total(rows):
        return (f'kernel {sum(r["ms"] for r in rows):.4f} ms, plain '
                f'{sum(r["plain_ms"] for r in rows):.4f} ms, bound '
                f'{sum(r["bound_ms"] for r in rows):.4f} ms (mma.sync '
                f'{sum(r["bound_mma_sync_ms"] for r in rows):.4f})')
    print(f'K3 bf16 width-8 step, {len(k3_step)} layers: {total(k3_step)}; '
          f'K3 bf16 width-64 step, its {len(k3_wide)} fused layers '
          f'{wide["fused"]}: {total(k3_wide)}; K4 bf16 width-64 step, its '
          f'{len(k4_step)} split layers {wide["split"]}: {total(k4_step)}; '
          f'the bf16 tail {sum(r["tail_ms"] for r in k4_step):.4f} ms '
          f'(bound {sum(r["tail_bound_ms"] for r in k4_step):.4f}); '
          f'{card_line()}', flush=True)
    torch.backends.cudnn.allow_tf32 = True
    report.update(bf16_k1_rows=k1_rows, bf16_k2_rows=k2_rows,
                  bf16_k2_serve=k2_serve, bf16_k2_step=k2_step,
                  bf16_k2_wide=k2_wide, bf16_k3_rows=k3_rows,
                  bf16_k4_rows=k4_rows, bf16_k3_step=k3_step,
                  bf16_k3_wide=k3_wide, bf16_k4_step=k4_step)


def _serving_case(tds, recurrent):
    """Phase 12's serving case: the full-width flagship (16 grids) or
    recresnet_spc (19 grids, windows of 4) at batch 8 with statics and a
    predictor from a seeded generator, as a dict: `make` (dtype -> model),
    `hr`, `kwargs` of `predict`, `n` grids, the launches `want`ed, `label`,
    and `cpu_slice`, the grids that give grid 0's output on the CPU."""
    import numpy as np
    hr_size = LR * SCALE
    rng = np.random.default_rng(12 + recurrent)
    n = REC_GRIDS if recurrent else N_GRIDS
    hr = rng.standard_normal((n, hr_size, hr_size)).astype('float32')
    topo = rng.standard_normal((hr_size, hr_size)).astype('float32')
    mask = (rng.random((hr_size, hr_size)) > 0.5).astype('float32')
    pred = rng.standard_normal((n, hr_size, hr_size, 1)).astype('float32')
    kwargs = dict(scale=SCALE, static_vars=[topo, mask], predictors=[pred],
                  batch_size=BATCH)
    if recurrent:
        make = lambda dt: tds.recnet_postupsampling(  # noqa: E731
            'resnet', 'spc', scale=SCALE, n_channels=2, n_aux_channels=2,
            lr_size=(LR, LR), time_window=REC_T, n_filters=N_FILTERS,
            n_blocks=REC_BLOCKS, dtype=dt)
        kwargs['time_window'] = REC_T
        want = dict(K2=len(K2_LAYERS) * REC_T * -(-(n - REC_T + 1) // BATCH),
                    K1=0)
        label = 'recresnet_spc'
    else:
        make = lambda dt: tds.net_postupsampling(  # noqa: E731
            'resnet', 'spc', scale=SCALE, n_channels=4, n_aux_channels=2,
            lr_size=(LR, LR), n_filters=N_FILTERS, n_blocks=N_BLOCKS,
            attention=True, dtype=dt)
        kwargs['array_in_hr'] = True
        want = dict(K2=0, K1=len(K1_SHAPES) * -(-n // BATCH))
        label = 'resnet_spc'
    return dict(make=make, hr=hr, kwargs=kwargs, n=n, want=want, label=label,
                cpu_slice=slice(0, REC_T) if recurrent else slice(0, 1))


def _bf16_predict(torch, tds, recurrent):
    """Phase 12, serving: full-width bfloat16 predict of the flagship (16
    grids) or of recresnet_spc (19 grids, windows of 4) at batch 8, its
    launches, a float32 return of bfloat16 values, its speed beside the
    float32 model's, and grid 0 against the same bfloat16 model on the CPU
    (the plain versions): mean |d| at most BF16_PREDICT_RATIO of the card's
    own float32-to-bfloat16 distance."""
    import numpy as np
    fca, fcl = tds.fused_channel_attention, tds.fused_convlstm
    case = _serving_case(tds, recurrent)
    make, hr, kwargs, n, want, label, sl = (case[k] for k in (
        'make', 'hr', 'kwargs', 'n', 'want', 'label', 'cpu_slice'))
    hr_size = LR * SCALE
    pred = kwargs['predictors'][0]
    model, model32 = make(torch.bfloat16), make(torch.float32)
    net, net32 = model.init(seed=0, device='cuda'), model32.init(seed=0,
                                                                 device='cuda')
    fca.launches = fca.bwd_launches = fcl.launches = 0
    y = tds.predict((model, net), hr, **kwargs)
    got = dict(K2=fcl.launches, K1=fca.launches)
    if got != want or fca.bwd_launches:
        fail(f'bf16 predict ({label}) launched {got} (and K1 backward '
             f'{fca.bwd_launches}), expected {want}')
    if y.dtype != np.float32 or y.shape != (n, hr_size, hr_size, 1) \
            or not np.isfinite(y).all():
        fail(f'bf16 predict ({label}): {y.dtype} {y.shape}, finite '
             f'{bool(np.isfinite(y).all())}')
    yt = torch.from_numpy(y)
    if not torch.equal(yt, yt.to(torch.bfloat16).float()):
        fail(f'bf16 predict ({label}) returned values that are not '
             f'bfloat16')
    rates = {}
    for dt, (m_, n_) in (('bfloat16', (model, net)),
                         ('float32', (model32, net32))):
        tds.predict((m_, n_), hr, **kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tds.predict((m_, n_), hr, **kwargs)
        rates[dt] = n / (time.perf_counter() - t0)
        xb = torch.randn((BATCH,) + tuple(m_.input_shape), device='cuda')
        ab = torch.randn((BATCH, hr_size, hr_size, 2), device='cuda')
        with torch.inference_mode():
            rates[dt + '_forward_ms'] = statistics.median(
                device_times(torch, lambda: n_(xb, ab), reps=10))
    y32 = tds.predict((model32, net32), hr, **kwargs)
    net_cpu = copy.deepcopy(net).cpu()
    y_cpu = tds.predict((model, net_cpu), hr[sl], device='cpu',
                        **dict(kwargs, predictors=[pred[sl]]))[:1]
    # mean |d| over mean |y| (BF16_PREDICT_RATIO)
    scale = float(np.abs(y_cpu).mean())
    port = float(np.abs(y[:1] - y_cpu).mean()) / scale
    own = float(np.abs(y32[:1] - y[:1]).mean()) / scale
    port_max = float(np.abs(y[:1] - y_cpu).max()) / float(
        np.abs(y_cpu).max())
    own_max = float(np.abs(y32[:1] - y[:1]).max()) / float(
        np.abs(y_cpu).max())
    print(f'bf16 predict ({label}, {n} grids at batch {BATCH}): launches '
          f'{got}; {rates["bfloat16"]:.2f} grids/s against '
          f'{rates["float32"]:.2f} in float32 (host clock); forward '
          f'{rates["bfloat16_forward_ms"]:.3f} ms against '
          f'{rates["float32_forward_ms"]:.3f} (CUDA events); grid 0 against '
          f'the CPU in bfloat16 mean|d|/mean|y| {port:.3e}, the card\'s '
          f'float32 model {own:.3e} from it (at most {BF16_PREDICT_RATIO} '
          f'of it required; max|d|/max|y| {port_max:.3e} and '
          f'{own_max:.3e}); {card_line()}', flush=True)
    if not port <= BF16_PREDICT_RATIO * own:
        fail(f'bf16 predict ({label}) on the card is {port:.3e} from the '
             f'CPU, more than {BF16_PREDICT_RATIO} of the float32 model\'s '
             f'{own:.3e}')
    return dict(launches=got, rates=rates, cpu_mean_rel_err=port,
                f32_mean_rel_dist=own, cpu_max_rel_err=port_max,
                f32_max_rel_dist=own_max)


def _bf16_training(torch, tds, config, label, steps, per_step,
                   batch=TRAIN_BATCH, retraces=0, phase=12):
    """Phase 12, training: `run()` at batch 128 for 2 epochs of `steps`
    steps with validation and test through the replayed graphs, under
    torch.profiler with the counters zeroed just before: the launches in
    its device trace and the wrappers' calls (`_check_launches`), finite
    losses; then the eager steps' and the replays' speed."""
    import numpy as np
    tr = tds.SupervisedTrainer(
        batch_size=batch, epochs=TRAIN_EPOCHS, steps_per_epoch=steps,
        validation_steps=TRAIN_VAL_STEPS, test_steps=TRAIN_TEST_STEPS,
        **config)
    run_s, calls, kernels = _traced_run(torch, tds, tr)
    losses = tr.fithist['loss'] + tr.fithist['val_loss'] + [tr.test_loss]
    got = _check_launches(
        tds, tr.runner, f'phase {phase} ({label})', per_step,
        {'step': TRAIN_EPOCHS * steps,
         'val': TRAIN_EPOCHS * TRAIN_VAL_STEPS, 'test': TRAIN_TEST_STEPS},
        calls, kernels)
    if not all(np.isfinite(v) for v in losses):
        fail(f'phase {phase} ({label}) gave non-finite losses {losses}')
    gen = torch.Generator().manual_seed(1)
    idx = tr.ds_train.epoch_indices(gen, steps=steps)
    tr.net.train()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(steps):
        tr.train_step(tr.ds_train(idx[c], generator=gen))
    torch.cuda.synchronize()
    eager = steps * batch / (time.perf_counter() - t0)
    graphed = _graphed_speed(torch, tds, tr, steps, per_step, label, batch,
                             retraces)
    print(f'phase {phase}, {label}: history {tr.fithist}, test loss '
          f'{tr.test_loss:.6f}; replayed {graphed["patches_per_s"]:.1f} '
          f'patches/s, eager {eager:.1f} (host clock); one replay '
          f'{graphed["replay_ms"]:.3f} ms (CUDA events), '
          f'{graphed["launches_per_replay"]:.0f} launches a replay, device '
          f'busy {100 * graphed["busy_share"]:.1f}%; {card_line()}',
          flush=True)
    return dict(launches=got, wrapper_calls=calls, eager_patches_per_s=eager,
                graphed=graphed, losses=losses)


def phase_bf16(torch, tds, report):
    """Phase 12: the bfloat16 model dtype: its kernels against their plain
    versions, then the two models served and the three training paths
    trained in bfloat16, with their launches, beside float32."""
    import dl4ds_tpu_torch.ops.convlstm as conv
    _bf16_kernels(torch, tds, report)
    serve = {'resnet_spc': _bf16_predict(torch, tds, False),
             'recresnet_spc': _bf16_predict(torch, tds, True)}
    bf = dict(dtype=torch.bfloat16)
    flagship = _training_config(loss='mae', n_filters=N_FILTERS,
                                n_blocks=N_BLOCKS, attention=True)
    flag_steps = _flagship_per_step(report['flag_k1_per_forward'],
                                    ssim=False)
    train = {
        'resnet_spc, mae, bfloat16': _bf16_training(
            torch, tds, dict(flagship, **bf), 'resnet_spc, mae, bfloat16',
            TRAIN_STEPS, flag_steps),
        'resnet_spc, mae, float32': _bf16_training(
            torch, tds, flagship, 'resnet_spc, mae, float32', TRAIN_STEPS,
            flag_steps),
        f'recresnet_spc, n_filters {N_FILTERS}, bfloat16': _bf16_training(
            torch, tds, _training_config(
                loss='mae', time_window=REC_T, n_blocks=REC_BLOCKS,
                n_filters=N_FILTERS, **bf),
            f'recresnet_spc, n_filters {N_FILTERS}, bfloat16', TRAIN_STEPS,
            _recurrent_per_step(conv, K3_LAYERS, 2)),
        f'recresnet_spc, n_filters {WIDE_F}, bfloat16': _bf16_training(
            torch, tds, _training_config(
                loss='mae', time_window=REC_T, n_blocks=REC_BLOCKS,
                n_filters=WIDE_F, attention=True, **bf),
            f'recresnet_spc, n_filters {WIDE_F}, bfloat16', WIDE_STEPS,
            _recurrent_per_step(conv, WIDE_LAYERS, 2))}
    f32_rates = {f'recresnet_spc, n_filters {N_FILTERS}': report[
                     'train_graphed'],
                 f'recresnet_spc, n_filters {WIDE_F}': report['wide_graphed']}
    card = card_line()
    for name, row in train.items():
        g = row['graphed']
        base = f32_rates.get(name.rsplit(', ', 1)[0])
        print(f'phase 12 rates, {name}: replayed {g["patches_per_s"]:.1f} '
              f'patches/s, one replay {g["replay_ms"]:.3f} ms, '
              f'{g["launches_per_replay"]:.0f} launches a replay'
              + (f'; float32 (phases 7, 8, this call): '
                 f'{base["patches_per_s"]:.1f} patches/s, one replay '
                 f'{base["replay_ms"]:.3f} ms, '
                 f'{base["launches_per_replay"]:.0f} launches a replay'
                 if base else '') + f'; {card}', flush=True)
    report.update(bf16_serve=serve, bf16_train=train)


def _bf16_kernel_rows(report):
    """The `kernels` line's rows of the bfloat16 forms: K1's mixed mode at
    the gates of a bfloat16 flagship training step, K2 at a bfloat16
    recresnet_spc forward (inference) and width-8 step (training), K3 at
    the width-8 step and at the width-64 step's fused layers, K4 at its
    split layers; `launches` from phase 12's runs (training: the device
    trace, where K3's chain steps and K4's have kernels of their own)."""
    train = report['bf16_train']
    flag = train['resnet_spc, mae, bfloat16']
    width8 = train[f'recresnet_spc, n_filters {N_FILTERS}, bfloat16']
    width64 = train[f'recresnet_spc, n_filters {WIDE_F}, bfloat16']
    serve = report['bf16_serve']['recresnet_spc']
    gates = [r for r in report['bf16_k1_rows']
             if r['shape'][0] == TRAIN_BATCH and 'ms' in r]

    def total(rows, key):
        return sum(r[key] for r in rows)

    def row(name, source, replaces, launches, err, rows, work, **extra):
        return dict(
            name=name, route='cuda', source=source, replaces=replaces,
            launches=launches, max_abs_err=err, ms=total(rows, 'ms'),
            plain_ms=total(rows, 'plain_ms'),
            bound_ms=total(rows, 'bound_ms'),
            bound_by=rows[0]['bound_by'] if 'bound_by' in rows[0]
            else 'bytes', library_ms=None, work=work, **extra)

    k2_err = max(max(r['ys_cs_zs_err']) for r in report['bf16_k2_rows'])
    rows = [
        row('K1_channel_attention_mixed_bf16', 'dl4ds_tpu_torch/csrc/'
            'channel_attention.cu', 'dl4ds_tpu/ops/pallas_ops.py:39',
            flag['launches']['K1'],
            max(r['rel_err']['y'] for r in report['bf16_k1_rows']), gates,
            f'the {len(gates)} gates of one bfloat16 flagship training '
            f'step at batch {TRAIN_BATCH} in the mixed mode (bfloat16 x, '
            f'float32 y), summed; max_abs_err is max|d| / max|ref| of y; '
            f'bwd_* the backward (float32 dy, bfloat16 dx)',
            bwd_ms=total(gates, 'bwd_ms'),
            bwd_plain_ms=total(gates, 'bwd_plain_ms'),
            bwd_bound_ms=total(gates, 'bwd_bound_ms'),
            bwd_launches=flag['launches']['K1 backward'],
            wrapper_calls=flag['wrapper_calls']['K1']),
        row('K2_convlstm_bf16', 'dl4ds_tpu_torch/csrc/convlstm.cu',
            'dl4ds_tpu/ops/pallas_convlstm.py:219',
            serve['launches']['K2'], k2_err, report['bf16_k2_serve'],
            f'the {len(report["bf16_k2_serve"])} ConvLSTM layers of one '
            f'bfloat16 recresnet_spc forward at batch {BATCH}, summed; '
            f'bfloat16 m16n8k16 products (bound_mma_sync_ms at '
            f'{BF16_MMA_SYNC_FLOPS / 1e12:.0f} TFLOP/s, bound_ms at '
            f'{BF16_FLOPS / 1e12:.0f}); max_abs_err is max|d| / max|ref| '
            f'held step by step',
            bound_mma_sync_ms=total(report['bf16_k2_serve'],
                                    'bound_mma_sync_ms')),
        row('K2_convlstm_train_bf16', 'dl4ds_tpu_torch/csrc/convlstm.cu',
            'dl4ds_tpu/ops/pallas_convlstm.py:219',
            width8['launches']['K2-train'], k2_err, report['bf16_k2_step'],
            f'the {len(report["bf16_k2_step"])} layers of one bfloat16 '
            f'width-8 training step at batch {TRAIN_BATCH}; at width '
            f'{WIDE_F} {total(report["bf16_k2_wide"], "ms"):.4f} ms (plain '
            f'{total(report["bf16_k2_wide"], "plain_ms"):.4f}, bound '
            f'{total(report["bf16_k2_wide"], "bound_ms"):.4f})',
            bound_mma_sync_ms=total(report['bf16_k2_step'],
                                    'bound_mma_sync_ms'),
            wrapper_calls=width8['wrapper_calls']['K2-train']),
        row('K3_convlstm_bptt_bf16', 'dl4ds_tpu_torch/csrc/convlstm_bwd.cu',
            'dl4ds_tpu/ops/pallas_convlstm.py:335',
            width8['launches']['K3'],
            max(max(r['grad_rel_err'].values())
                for r in report['bf16_k3_rows']), report['bf16_k3_step'],
            f'the BPTT of the {len(report["bf16_k3_step"])} layers of one '
            f'bfloat16 width-8 training step (chain and dx in '
            f'convlstm_seq.cu, weight gradients in convlstm_bwd.cu); '
            f'max_abs_err is max|d| / max|ref| against the plain tail in '
            f'float64 on the kernels\' dzs and of the chain held step by '
            f'step',
            bound_mma_sync_ms=total(report['bf16_k3_step'],
                                    'bound_mma_sync_ms'),
            wrapper_calls=width8['wrapper_calls']['K3']),
        row('K3_convlstm_bptt_bf16_width64',
            'dl4ds_tpu_torch/csrc/convlstm_bwd.cu',
            'dl4ds_tpu/ops/pallas_convlstm.py:335',
            width64['launches']['K3'],
            max(max(r['grad_rel_err'].values())
                for r in report['bf16_k3_rows']), report['bf16_k3_wide'],
            f'the BPTT of the {len(report["bf16_k3_wide"])} layers of one '
            f'bfloat16 width-{WIDE_F} training step that take the fused '
            f'route ({WIDE_F} -> {WIDE_F}); errors as K3_convlstm_bptt_bf16',
            bound_mma_sync_ms=total(report['bf16_k3_wide'],
                                    'bound_mma_sync_ms'),
            wrapper_calls=width64['wrapper_calls']['K3']),
        row('K4_convlstm_seq_bf16', 'dl4ds_tpu_torch/csrc/convlstm_seq.cu',
            'dl4ds_tpu/ops/pallas_convlstm.py:269',
            width64['launches']['K4'],
            max(max(r['grad_rel_err'].values())
                for r in report['bf16_k4_rows']), report['bf16_k4_step'],
            f'the chain of the {len(report["bf16_k4_step"])} layer(s) of '
            f'one bfloat16 width-{WIDE_F} training step that take the split '
            f'route (1 -> {WIDE_F}); the bfloat16 GEMM tail '
            f'(cuBLAS, not a kernel of the port) '
            f'{total(report["bf16_k4_step"], "tail_ms"):.4f} ms against '
            f'a {total(report["bf16_k4_step"], "tail_bound_ms"):.4f} ms '
            f'bound',
            bound_mma_sync_ms=total(report['bf16_k4_step'],
                                    'bound_mma_sync_ms'),
            wrapper_calls=width64['wrapper_calls']['K4'])]
    return rows


# ---------------------------------------------------------------------------
# Phase 13: MOS, training and serving from given LR arrays
# ---------------------------------------------------------------------------

# the MOS configuration: the flagship trained on given LR arrays. Each HR
# grid of phase 10's data, as a temperature in degrees C (MOS_MEAN + MOS_STD
# times it; a small mean keeps float32 SSIM's moments from cancelling), is
# coarsened to 32x32 with inter_area plus Gaussian noise of MOS_NOISE times
# the HR standard deviation, so that the LR input is not the coarsened HR;
# two statics at 128x128, one predictor at 32x32, daily time metadata from
# MOS_START (256 days: all four seasons), a StandardScaler of the port
# fitted on the HR training split
MOS_MEAN, MOS_STD, MOS_NOISE = 15.0, 5.0, 0.1
MOS_START = '2000-01-01'
MOS_VAL = 64
# the LR input: the grid, the predictor, 2 statics, 4 season channels; aux:
# the 2 statics and the season
MOS_CHANNELS, MOS_AUX = 1 + 1 + 2 + 4, 2 + 4
# MOS serving: 16 LR grids of 128x128 into 512x512 at batch 8, again with
# pad_to_multiple (128 -> 144)
MOS_PAD = 48
# compute_metrics on the card against its plain versions: the per-grid SSIM
# against the plain ssim run in float64 (K6_TOL), the PSNR (float32 means of
# 512*512 squared errors) within MOS_PSNR_RTOL of the float64 one, the three
# maps (numpy on the host in both) against device='cpu' within MOS_MAP_TOL
MOS_PSNR_RTOL, MOS_MAP_TOL = 1e-5, 1e-5


def _mos_config(tds):
    """SupervisedTrainer arguments of phase 13's MOS training, and the
    fitted scaler."""
    import numpy as np
    rng = np.random.default_rng(0)
    hr = MOS_MEAN + MOS_STD * rng.standard_normal(
        (TRAIN_GRIDS, TRAIN_HR, TRAIN_HR, 1)).astype('float32')
    mos = np.random.default_rng(13)
    lr_hw = TRAIN_HR // SCALE
    lr = tds.resize_array(hr, (lr_hw, lr_hw), 'inter_area', squeezed=False)
    lr = (lr + MOS_NOISE * hr.std() * mos.standard_normal(lr.shape)).astype(
        'float32')
    topo = mos.standard_normal((TRAIN_HR, TRAIN_HR)).astype('float32')
    mask = (mos.random((TRAIN_HR, TRAIN_HR)) > 0.5).astype('float32')
    pred = mos.standard_normal((TRAIN_GRIDS, lr_hw, lr_hw, 1)).astype(
        'float32')
    days = np.datetime64(MOS_START) + np.arange(TRAIN_GRIDS)
    scaler = tds.StandardScaler().fit(hr)
    hr_s = scaler.transform(hr)[..., None].astype('float32')
    lr_s = scaler.transform(lr)[..., None].astype('float32')
    v = slice(0, MOS_VAL)
    config = dict(
        backbone='resnet', upsampling='spc', data_train=hr_s,
        data_val=hr_s[v], data_test=hr_s[v], data_train_lr=lr_s,
        data_val_lr=lr_s[v], data_test_lr=lr_s[v], static_vars=[topo, mask],
        predictors_train=[pred], predictors_val=[pred[v]],
        predictors_test=[pred[v]], time_metadata=(days, days[v], days[v]),
        scale=SCALE, patch_size=TRAIN_PATCH, loss='mae', n_filters=N_FILTERS,
        n_blocks=N_BLOCKS, attention=True, verbose=False)
    return config, scaler, hr_s, lr_s


def _check_mos_batch(torch, tds, config, hr_s, lr_s):
    """One MOS batch on the card: LR channel 0 is the given LR array's
    crop, not the coarsened HR crop; the channels [lr | predictor | statics
    | season] and aux [statics | season] with the season of each sample's
    day; returns the season ids of the training split."""
    import numpy as np
    tr = tds.SupervisedTrainer(batch_size=4, epochs=1, **config)
    tr.setup_datagen()
    synth = tr.ds_train
    if (synth.n_channels_lr, synth.n_channels_aux) != (MOS_CHANNELS,
                                                       MOS_AUX):
        fail(f'phase 13: the MOS batches have {synth.n_channels_lr} LR and '
             f'{synth.n_channels_aux} aux channels, expected {MOS_CHANNELS} '
             f'and {MOS_AUX}')
    idx, ys, xs = [0, 100, 200, 255], [0, 5, 16, 9], [3, 0, 16, 12]
    batch = synth(torch.tensor(idx), offsets=(ys, xs))
    plr, p = TRAIN_LR, TRAIN_PATCH
    want = np.stack([lr_s[i, y:y + plr, x:x + plr] for i, y, x in
                     zip(idx, ys, xs)])
    coarse = tds.resize_array(np.stack(
        [hr_s[i, SCALE * y:SCALE * y + p, SCALE * x:SCALE * x + p]
         for i, y, x in zip(idx, ys, xs)]), (plr, plr), 'inter_area',
        squeezed=False)
    got = batch['lr'][..., :1].cpu().numpy()
    seasons = synth.season_ids.cpu().numpy()
    onehot = batch['lr'][:, 0, 0, -4:].argmax(-1).cpu().numpy()
    aux_onehot = batch['aux'][:, 0, 0, -4:].argmax(-1).cpu().numpy()
    dist = float(np.abs(got - coarse).max())
    print(f'phase 13, a MOS batch on the card: lr {tuple(batch["lr"].shape)}, '
          f'aux {tuple(batch["aux"].shape)}; LR channel 0 against the given '
          f'LR crop max|d| {float(np.abs(got - want).max()):.3e}, against '
          f'the coarsened HR crop {dist:.3e}; seasons {onehot.tolist()} (LR) '
          f'{aux_onehot.tolist()} (aux), table {seasons[idx].tolist()}',
          flush=True)
    if not np.array_equal(got, want):
        fail('phase 13: the MOS batch\'s LR channel is not the given LR '
             'array\'s crop')
    if not dist > MOS_NOISE * 0.1:
        fail(f'phase 13: the given LR array is the coarsened HR ({dist:.3e})')
    if not (np.array_equal(onehot, seasons[idx])
            and np.array_equal(aux_onehot, seasons[idx])):
        fail('phase 13: the season channels are not the samples\' seasons')
    if sorted(set(seasons.tolist())) != [0, 1, 2, 3]:
        fail(f'phase 13: the training days cover seasons {set(seasons)}')
    return seasons


def _mos_serving(torch, tds, scaler, report):
    """Phase 13, serving: `predict(array_in_hr=False)` of 16 LR grids with
    statics at 512x512, a predictor at 128x128, time metadata and the
    scaler, its K1 launches, its speed, grid 0 against the CPU, and again
    with pad_to_multiple. Returns (the truth, the served grids)."""
    import numpy as np
    fca, fss = tds.fused_channel_attention, tds.fused_ssim_per_image
    hr_size = LR * SCALE
    rng = np.random.default_rng(15)
    truth = MOS_MEAN + MOS_STD * rng.standard_normal(
        (N_GRIDS, hr_size, hr_size, 1)).astype('float32')
    lr = tds.resize_array(truth, (LR, LR), 'inter_area', squeezed=False)
    lr = lr + MOS_NOISE * MOS_STD * rng.standard_normal(lr.shape)
    lr_s = scaler.transform(lr)[..., None].astype('float32')
    topo = rng.standard_normal((hr_size, hr_size)).astype('float32')
    mask = (rng.random((hr_size, hr_size)) > 0.5).astype('float32')
    pred = rng.standard_normal((N_GRIDS, LR, LR, 1)).astype('float32')
    days = np.datetime64('2001-03-10') + np.arange(N_GRIDS)
    model = tds.net_postupsampling(
        'resnet', 'spc', scale=SCALE, n_channels=MOS_CHANNELS,
        n_aux_channels=MOS_AUX, lr_size=(LR, LR), n_filters=N_FILTERS,
        n_blocks=N_BLOCKS, attention=True)
    net = model.init(seed=0, device='cuda')
    kwargs = dict(scale=SCALE, array_in_hr=False, static_vars=[topo, mask],
                  predictors=[pred], time_metadata=days, scaler=scaler,
                  batch_size=BATCH)
    torch.backends.cudnn.allow_tf32 = True       # PyTorch's default
    torch.backends.cuda.matmul.allow_tf32 = False
    fca.launches = fca.bwd_launches = fss.launches = 0
    y = tds.predict((model, net), lr_s, **kwargs)
    launches = dict(K1=fca.launches, K1_backward=fca.bwd_launches,
                    K6=fss.launches)
    want = dict(K1=len(K1_SHAPES) * -(-N_GRIDS // BATCH), K1_backward=0,
                K6=0)
    print(f'phase 13, MOS predict: {N_GRIDS} LR grids {LR}x{LR} -> '
          f'{y.shape}, launches {launches} (expected {want})', flush=True)
    if launches != want:
        fail(f'phase 13: MOS predict launched {launches}, expected {want}')
    if y.shape != (N_GRIDS, hr_size, hr_size) or not np.isfinite(y).all():
        fail(f'phase 13: MOS predict gave {y.shape}, finite '
             f'{bool(np.isfinite(y).all())}')
    t0 = time.perf_counter()
    tds.predict((model, net), lr_s, **kwargs)
    predict_s = time.perf_counter() - t0

    torch.backends.cudnn.allow_tf32 = False
    net_cpu = copy.deepcopy(net).cpu()
    one = dict(kwargs, predictors=[pred[:1]], time_metadata=days[:1])
    errs = {}
    for pad in (None, MOS_PAD):
        fca.launches = 0
        y32 = tds.predict((model, net), lr_s, pad_to_multiple=pad, **kwargs)
        if fca.launches != want['K1']:
            fail(f'phase 13: MOS predict (pad_to_multiple={pad}) launched K1 '
                 f'{fca.launches} times, expected {want["K1"]}')
        y_cpu = tds.predict((model, net_cpu), lr_s[:1], device='cpu',
                            pad_to_multiple=pad, **one)
        y_cpu = y_cpu.reshape(y32[:1].shape)
        diff = np.abs(y32[:1] - y_cpu)
        err = float(diff.max())
        ok = bool((diff <= PREDICT_TOL['atol']
                   + PREDICT_TOL['rtol'] * np.abs(y_cpu)).all())
        errs[str(pad)] = err
        print(f'phase 13, MOS predict grid 0 (pad_to_multiple={pad}), GPU '
              f'(TF32 off) vs CPU: max|d| {err:.3e}, max|y| '
              f'{float(np.abs(y_cpu).max()):.3e} (atol '
              f'{PREDICT_TOL["atol"]}, rtol {PREDICT_TOL["rtol"]})',
              flush=True)
        if not ok:
            fail(f'phase 13: MOS predict (pad_to_multiple={pad}) on the GPU '
                 f'disagrees with the CPU: max|d| {err:.3e}')
    torch.backends.cudnn.allow_tf32 = True
    report['mos_predict'] = dict(launches=launches,
                                 grids_per_s=N_GRIDS / predict_s,
                                 cpu_max_abs_err=errs)
    print(f'phase 13, MOS predict {N_GRIDS} grids at batch {BATCH} (TF32 '
          f'convs, the default): {N_GRIDS / predict_s:.2f} grids/s end to end '
          f'(host clock, the HR stand-in resize, data assembly and copy out '
          f'included); {card_line()}', flush=True)
    return truth, y[..., None].astype('float32')


def _mos_metrics(torch, tds, truth, y_hat, report):
    """Phase 13, metrics: compute_metrics on the served grids on the card,
    its K6 launches, the per-grid SSIM and PSNR against float64, the maps
    against device='cpu', and K6 timed at the metrics' shape."""
    import numpy as np
    from dl4ds_tpu_torch.ops.ssim import psnr, ssim
    fss = tds.fused_ssim_per_image
    fss.launches = fss.bwd_launches = 0
    maps = tds.compute_metrics(truth, y_hat, save_path=None)
    launches = (fss.launches, fss.bwd_launches)
    maps_cpu = tds.compute_metrics(truth, y_hat, save_path=None,
                                   device='cpu')
    # the second call of each on the host clock, in turns
    seconds = {}
    for device in ('cuda', 'cpu', 'cpu', 'cuda'):
        t0 = time.perf_counter()
        tds.compute_metrics(truth, y_hat, save_path=None, device=device)
        seconds.setdefault(device, []).append(time.perf_counter() - t0)
    metrics_s, metrics_cpu_s = min(seconds['cuda']), min(seconds['cpu'])
    print(f'phase 13, compute_metrics on {N_GRIDS} grids {truth.shape[1:]}: '
          f'{metrics_s:.3f} s on the card, {metrics_cpu_s:.3f} s with '
          f'device=\'cpu\' (host clock, the faster of two calls each); K6 '
          f'(forward, backward) launches {launches} (expected (1, 0))',
          flush=True)
    if launches != (1, 0):
        fail(f'phase 13: compute_metrics launched K6 {launches}, expected '
             f'(1, 0)')
    map_err = max(float(np.nanmax(np.abs(a - b)))
                  for a, b in zip(maps, maps_cpu))
    if not (map_err <= MOS_MAP_TOL and all(
            np.array_equal(np.isnan(a), np.isnan(b))
            for a, b in zip(maps, maps_cpu))):
        fail(f'phase 13: compute_metrics\' maps on the card differ from '
             f'device=\'cpu\' by {map_err:.3e}')
    drange = float(max(truth.max(), y_hat.max())
                   - min(truth.min(), y_hat.min()))
    psnr_vals, ssim_vals = tds.metrics._psnr_ssim(truth, y_hat, drange,
                                                  'cuda')
    a = torch.as_tensor(truth, device='cuda')
    b = torch.as_tensor(y_hat, device='cuda')
    ssim64 = ssim(a.double(), b.double(), drange).cpu().numpy()
    psnr64 = psnr(a.double(), b.double(), drange).cpu().numpy()
    ssim_err = float(np.abs(ssim_vals - ssim64).max())
    psnr_err = float((np.abs(psnr_vals - psnr64) / np.abs(psnr64)).max())
    print(f'phase 13, per-grid SSIM through K6 against the plain ssim in '
          f'float64: max|d| {ssim_err:.3e} (atol {K6_TOL}); PSNR max|d|/|ref| '
          f'{psnr_err:.3e} (rtol {MOS_PSNR_RTOL}); maps against '
          f'device=\'cpu\' max|d| {map_err:.3e} (atol {MOS_MAP_TOL}); mean '
          f'SSIM {float(ssim_vals.mean()):.6f}, PSNR '
          f'{float(psnr_vals.mean()):.4f} dB', flush=True)
    if not ssim_err <= K6_TOL:
        fail(f'phase 13: the metrics\' SSIM through K6 is {ssim_err:.3e} '
             f'from float64')
    if not psnr_err <= MOS_PSNR_RTOL:
        fail(f'phase 13: the metrics\' PSNR is {psnr_err:.3e} from float64')
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device='cuda')
    mv = torch.tensor(drange, dtype=torch.float32, device='cuda')
    ms, plain_ms = paired_ms(torch, lambda: fss(a, b, mv),
                             lambda: ssim(a, b, mv), flush)
    flops, n_bytes = k6_work(tuple(truth.shape), 11)
    bound_ms = max(flops / F32_FLOPS, n_bytes / HBM_BYTES_PER_S) * 1e3
    bound_by = ('operations' if flops / F32_FLOPS >= n_bytes / HBM_BYTES_PER_S
                else 'bytes')
    print(f'K6 x{list(truth.shape)} (compute_metrics) kernel {ms:.4f} ms  '
          f'plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}; '
          f'{flops / 1e6:.1f} MFLOP, {n_bytes / 1e6:.2f} MB)  library_ms '
          f'null; {card_line()}', flush=True)
    report['mos_metrics'] = dict(
        k6_launches=launches[0], seconds=metrics_s, cpu_seconds=metrics_cpu_s,
        ssim_max_abs_err=ssim_err, psnr_max_rel_err=psnr_err,
        map_max_abs_err=map_err, shape=list(truth.shape), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_mos(torch, tds, report):
    """Phase 13: the MOS path on the card. The flagship trained from given
    LR arrays with statics, a predictor, season channels from daily time
    metadata and the port's StandardScaler (2 epochs of 20 steps through
    run()'s replayed graphs, K1 counted in the device trace, 8 replayed
    steps against 8 eager ones bit for bit, 3 steps against the CPU in
    float64); then MOS serving of LR grids and compute_metrics on the
    served grids, with K6 on the card."""
    from dl4ds_tpu_torch.ops import fused_ops as fo
    config, scaler, hr_s, lr_s = _mos_config(tds)
    _check_mos_batch(torch, tds, config, hr_s, lr_s)
    shapes = _gate_inputs(torch, tds, config)
    if shapes != K1_TRAIN_SHAPES:
        fail(f'phase 13: the MOS step\'s gates are {shapes}, not the '
             f'{K1_TRAIN_SHAPES} phases 2 and 10 checked and timed')
    per_step = _flagship_per_step(len(shapes), ssim=False)
    gates = report['k1_train_rows']
    label = f'MOS resnet_spc, n_filters {N_FILTERS}, mae'
    got, calls, numbers = _drive_training(
        torch, tds, config, label, TRAIN_STEPS, per_step, FLAG_CPU_BATCH,
        {'K1 forward': sum(r['ms'] for r in gates),
         'K1 backward': sum(r['bwd_ms'] for r in gates)})
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    row = _graphs_vs_eager(torch, tds, fo, config, label, per_step)
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved
    g = numbers['graphed']
    print(f'phase 13, {label}, batch {TRAIN_BATCH}: graphed '
          f'{g["patches_per_s"]:.1f} patches/s, eager '
          f'{numbers["patches_per_s"]:.1f} patches/s (host clock); one replay '
          f'{g["replay_ms"]:.3f} ms, one eager step {numbers["step_ms"]:.3f} '
          f'ms (CUDA events); the device busy {100 * g["busy_share"]:.1f}% '
          f'of the replays\' span; {card_line()}', flush=True)
    report['mos_train'] = dict(launches=got, wrapper_calls=calls,
                               graphs_vs_eager=row['max_abs_diff'],
                               **numbers)
    truth, y_hat = _mos_serving(torch, tds, scaler, report)
    _mos_metrics(torch, tds, truth, y_hat, report)


def _mos_kernel_rows(report):
    """The `kernels` line's rows of phase 13: K1 in the MOS training step
    and in MOS serving (launches from phase 13's runs; times at the same
    gate shapes from phases 10 and 2) and K6 at compute_metrics' shape."""
    train = report['mos_train']
    gates = report['k1_train_rows']
    serve = [r for r in report['k1_rows'] if r['dtype'] == 'float32']
    met = report['mos_metrics']

    def total(rows, key):
        return sum(r[key] for r in rows)

    k1 = dict(route='cuda', source='dl4ds_tpu_torch/csrc/channel_attention.cu',
              replaces='dl4ds_tpu/ops/pallas_ops.py:39', bound_by='bytes',
              library_ms=None)
    return [
        dict(k1, name='K1_channel_attention_mos_train',
             launches=train['launches']['K1'],
             wrapper_calls=train['wrapper_calls']['K1'],
             max_abs_err=max(r['max_abs_err'] for r in gates),
             ms=total(gates, 'ms'), plain_ms=total(gates, 'plain_ms'),
             bound_ms=total(gates, 'bound_ms'), bwd_ms=total(gates, 'bwd_ms'),
             bwd_plain_ms=total(gates, 'bwd_plain_ms'),
             bwd_bound_ms=total(gates, 'bwd_bound_ms'),
             bwd_launches=train['launches']['K1 backward'],
             work=f'the {len(gates)} gates of one MOS flagship training step '
                  f'at batch {TRAIN_BATCH} (the shapes of phase 10\'s step, '
                  f'timed there), summed; launches from phase 13\'s device '
                  f'trace'),
        dict(k1, name='K1_channel_attention_mos_serve',
             launches=report['mos_predict']['launches']['K1'],
             max_abs_err=max(r['max_abs_err'] for r in serve),
             ms=total(serve, 'ms'), plain_ms=total(serve, 'plain_ms'),
             bound_ms=total(serve, 'bound_ms'),
             work=f'the {len(serve)} gates of one MOS serving forward at '
                  f'batch {BATCH} (phase 2\'s shapes, timed there), summed; '
                  f'launches of predict(array_in_hr=False) on {N_GRIDS} '
                  f'grids'),
        dict(name='K6_ssim_metrics', route='cuda',
             source='dl4ds_tpu_torch/csrc/ssim.cu',
             replaces='dl4ds_tpu/ops/pallas_ops.py:145',
             launches=met['k6_launches'],
             max_abs_err=met['ssim_max_abs_err'], ms=met['ms'],
             plain_ms=met['plain_ms'], bound_ms=met['bound_ms'],
             bound_by=met['bound_by'], library_ms=None,
             work=f'the per-grid SSIM of compute_metrics on the {N_GRIDS} '
                  f'served grids, x{met["shape"]}, 11 taps; max_abs_err per '
                  f'grid against the plain ssim in float64')]


# ---------------------------------------------------------------------------
# Phase 14: the pre-upsampled models and the 'rc' and 'dc' heads
# ---------------------------------------------------------------------------

# BASELINE configs 1 and 3 (bench_suite.py's convnet_pin_4x and unet_pin_4x:
# n_filters 8, default normalisation and dropout, the U-Net's decoder 'rc')
# trained as phase 10 (256 grids of 128x128, 64x64 patches, batch 128, 2
# epochs of 20 steps) with mae, and served on 16 HR grids of 128x128; the
# U-Net again on grids of PIN_ODD, which 2**4 does not divide (pad_concat)
PIN_CONFIGS = {'convnet_pin': dict(backbone='convnet', n_blocks=6),
               'unet_pin': dict(backbone='unet', n_blocks=4)}
PIN_ODD = 100
# The pin models' mae gradients are small (max |g| about 2e-5 at batch 16)
# and many of their elements cancel to 1e-8 or less, where float32's sums
# set their sign; Adam's g / (|g| + 1e-7) turns that into parameter steps of
# up to lr, so after 3 steps even the CPU's own float32 run of convnet_pin
# lands 5.5e-4 from float64 (after one step 1.6e-5; on the CPU). There the
# first step is held to TRAIN_PARAM_ATOL and the third to at most
# F32_YARDSTICK_RATIO times the CPU's float32 run's distance; the losses stay
# at TRAIN_LOSS_RTOL
F32_YARDSTICK_RATIO = 4
# the output head's gate is the only K1 gate of both models (attention is
# off in their bodies): [128, 64, 64, 8] in a training step, [8, H, W, 8]
# serving 128x128 HR grids and [8, 512, 512, 8] behind the x4 'rc' and 'dc'
# heads
PIN_TRAIN_GATES = [(TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, N_FILTERS)]


def _pin_config(name, **extra):
    return _training_config(upsampling='pin', loss='mae', n_filters=N_FILTERS,
                            **PIN_CONFIGS[name], **extra)


def _k1_gate_rows(torch, tds, shapes, label):
    """K1 at the gate `shapes` of a path, float32 forward and backward
    against their plain versions (the backward against the plain one in
    float64, `_check_k1_backward`) and the mixed mode (`_check_k1_mixed`),
    each timed against its plain version (float32). Returns the rows."""
    from dl4ds_tpu_torch.ops import fused_ops as fo
    fca, ref = tds.fused_channel_attention, tds.channel_attention_reference
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(14)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = []
    for shape in shapes:
        c = shape[-1]
        cr = max(int(c / 4), 1)
        # the inputs of phases 2, 10 and 12 at these shapes
        x, weights, dy = _gate_case(torch, gen, dev, shape, cr, torch.float32)
        err = (fca(x, *weights) - ref(x, *weights)).abs().max().item()
        if not err <= K1_TOL['float32']['atol']:
            fail(f'K1 {label} x{list(shape)}: max|d| {err:.3e}')
        bwd_err = _check_k1_backward(torch, fo, x, weights, dy,
                                     f'{label} x{list(shape)}')
        mixed_err = _check_k1_mixed(torch, fo, x.to(torch.bfloat16), weights,
                                    dy, f'{label} x{list(shape)}')
        ms, plain_ms = paired_ms(torch, lambda: fca(x, *weights),
                                 lambda: ref(x, *weights), flush)
        _, m, g = fo._launch(x, *weights)
        bwd_ms, bwd_plain_ms = paired_ms(
            torch, lambda: fo._launch_backward(x, *weights, dy, m, g),
            lambda: fo._channel_attention_backward(x, *weights, dy, m, g),
            flush)
        n_bytes = 2 * x.numel() * 4 + 4 * (2 * c * cr + c + cr)
        n_ops = 2 * x.numel() + 4 * shape[0] * c * cr
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS) * 1e3
        rows.append(dict(shape=list(shape), cr=cr, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bwd_rel_err=bwd_err, bwd_ms=bwd_ms,
                         bwd_plain_ms=bwd_plain_ms,
                         bwd_bound_ms=k1_bwd_bound_ms(x, cr),
                         mixed_rel_err=mixed_err))
        print(f'K1 {label} x{list(shape)} cr={cr}  max|d| {err:.3e}  kernel '
              f'{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms '
              f'(bytes); backward max|d|/max|ref| ' + _k1_bwd_errors(bwd_err)
              + f'  kernel {bwd_ms:.4f} ms  plain {bwd_plain_ms:.4f} ms  '
              f'bound {rows[-1]["bwd_bound_ms"]:.4f} ms; mixed mode max|d|/'
              f'max|ref| {max(mixed_err.values()):.2e}; {card_line()}',
              flush=True)
    return rows


def _pin_training(torch, tds, name, report):
    """Phase 14, training one pin configuration: its gates held and timed
    (`_k1_gate_rows`), 2 epochs through run()'s graphs in float32 with the
    launches in the device trace, 3 steps against the CPU in float64
    (`_drive_training`), 8 replayed steps against 8 eager ones bit for bit
    (`_graphs_vs_eager`), then 2 epochs in bfloat16. Returns the trained
    float32 (model, net)."""
    from dl4ds_tpu_torch.ops import fused_ops as fo
    config = _pin_config(name)
    shapes = _gate_inputs(torch, tds, config)
    if shapes != PIN_TRAIN_GATES:
        fail(f'phase 14: the {name} step\'s gates are {shapes}, not '
             f'{PIN_TRAIN_GATES}')
    rows = _k1_gate_rows(torch, tds, shapes, f'{name} training gate')
    per_step = _flagship_per_step(len(shapes), ssim=False)
    label = f'{name}, n_filters {N_FILTERS}, mae'
    got, calls, numbers = _drive_training(
        torch, tds, config, label, TRAIN_STEPS, per_step, FLAG_CPU_BATCH,
        {'K1 forward': sum(r['ms'] for r in rows),
         'K1 backward': sum(r['bwd_ms'] for r in rows)}, keep_model=True,
        f32_yardstick=True)
    trained = numbers.pop('model')
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    graphs = _graphs_vs_eager(torch, tds, fo, config, label, per_step)
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved
    bf16 = _bf16_training(torch, tds, dict(config, dtype=torch.bfloat16),
                          f'{label}, bfloat16', TRAIN_STEPS, per_step)
    g = numbers['graphed']
    print(f'phase 14, {label}, batch {TRAIN_BATCH}: float32 graphed '
          f'{g["patches_per_s"]:.1f} patches/s, eager '
          f'{numbers["patches_per_s"]:.1f} (host clock); one replay '
          f'{g["replay_ms"]:.3f} ms, one eager step {numbers["step_ms"]:.3f} '
          f'ms (CUDA events), device busy {100 * g["busy_share"]:.1f}%, '
          f'{g["launches_per_replay"]:.0f} launches a replay; bfloat16 '
          f'graphed {bf16["graphed"]["patches_per_s"]:.1f} patches/s, one '
          f'replay {bf16["graphed"]["replay_ms"]:.3f} ms; {card_line()}',
          flush=True)
    report['pin_train'][name] = dict(
        gates=rows, launches=got, wrapper_calls=calls,
        graphs_vs_eager=graphs['max_abs_diff'], bf16=bf16, **numbers)
    return trained


def _check_served(torch, tds, label, model, net, grids, kwargs, want,
                  cpu_slice=slice(0, 1), bf16=None, phase=14, hold=True):
    """`predict` of `grids` on the card: its launches ({'K1': n, 'K2': n},
    K1's backward none), a finite output of the grids' shape, its speed
    (host clock, and one forward on CUDA events), and grid 0 against the
    same model on the CPU (TF32 off, PREDICT_TOL; `cpu_slice` the grids
    whose windows give grid 0). With `bf16`, a bfloat16 model with the
    same weights: grid 0 against the CPU in bfloat16 by the mean criterion
    (at most BF16_PREDICT_RATIO of the float32 model's distance; with
    `hold` False the distances are printed and returned, not held).
    Returns the numbers."""
    import numpy as np
    fca, fcl = tds.fused_channel_attention, tds.fused_convlstm
    torch.backends.cudnn.allow_tf32 = True       # PyTorch's default
    torch.backends.cuda.matmul.allow_tf32 = False
    fca.launches = fca.bwd_launches = fcl.launches = 0
    y = tds.predict((model, net), grids, **kwargs)
    got = {'K1': fca.launches, 'K2': fcl.launches}
    out_hw = tuple(s * (SCALE if not kwargs.get('array_in_hr', True) else 1)
                   for s in grids.shape[1:3])
    print(f'phase {phase}, {label}: {model.param_count(net)} parameters, '
          f'output '
          f'{y.shape}, launches {got} (expected {want}), K1 backward '
          f'{fca.bwd_launches}', flush=True)
    if got != want or fca.bwd_launches:
        fail(f'phase {phase}: {label} launched {got} (K1 backward '
             f'{fca.bwd_launches}), expected {want}')
    if y.shape[1:3] != out_hw or not np.isfinite(y).all():
        fail(f'phase {phase}: {label} gave {y.shape}, finite '
             f'{bool(np.isfinite(y).all())}')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tds.predict((model, net), grids, **kwargs)
    grids_per_s = len(grids) / (time.perf_counter() - t0)

    torch.backends.cudnn.allow_tf32 = False
    y32 = tds.predict((model, net), grids, **kwargs)
    net_cpu = copy.deepcopy(net).cpu()
    one = {k: ([v[0][cpu_slice]] if k == 'predictors' else v)
           for k, v in kwargs.items()}
    y_cpu = tds.predict((model, net_cpu), grids[cpu_slice], device='cpu',
                        **one)[:1]
    diff = np.abs(y32[:1] - y_cpu)
    err = float(diff.max())
    ok = bool((diff <= PREDICT_TOL['atol']
               + PREDICT_TOL['rtol'] * np.abs(y_cpu)).all())
    print(f'phase {phase}, {label}: {grids_per_s:.2f} grids/s end to end '
          f'(host '
          f'clock, TF32 convs); grid 0, GPU (TF32 off) vs CPU: max|d| '
          f'{err:.3e}, max|y| {float(np.abs(y_cpu).max()):.3e} (atol '
          f'{PREDICT_TOL["atol"]}, rtol {PREDICT_TOL["rtol"]}); '
          f'{card_line()}', flush=True)
    if not ok:
        fail(f'phase {phase}: {label} on the GPU disagrees with the CPU: '
             f'max|d| '
             f'{err:.3e}')
    out = dict(launches=got, grids_per_s=grids_per_s, cpu_max_abs_err=err)
    if bf16 is not None:
        model16 = bf16
        net16 = model16.init(0, device='cuda')
        net16.load_state_dict(net.state_dict())
        fca.launches = fcl.launches = 0
        y16 = tds.predict((model16, net16), grids, **kwargs)
        got16 = {'K1': fca.launches, 'K2': fcl.launches}
        if got16 != want:
            fail(f'phase {phase}: bfloat16 {label} launched {got16}, expected '
                 f'{want}')
        y16_cpu = tds.predict((model16, copy.deepcopy(net16).cpu()),
                              grids[cpu_slice], device='cpu', **one)[:1]
        scale = float(np.abs(y16_cpu).mean())
        port = float(np.abs(y16[:1] - y16_cpu).mean()) / scale
        own = float(np.abs(y32[:1] - y16[:1]).mean()) / scale
        print(f'phase {phase}, bfloat16 {label}: launches {got16}; grid 0 '
              f'against '
              f'the CPU in bfloat16 mean|d|/mean|y| {port:.3e}, the card\'s '
              f'float32 model {own:.3e} from it ('
              + (f'at most {BF16_PREDICT_RATIO} of it required' if hold
                 else 'recorded, not held: PERF.md section 7')
              + f'); {card_line()}', flush=True)
        if hold and not port <= BF16_PREDICT_RATIO * own:
            fail(f'phase {phase}: bfloat16 {label} on the card is {port:.3e} '
                 f'from the CPU, more than {BF16_PREDICT_RATIO} of the '
                 f'float32 model\'s {own:.3e}')
        out.update(bf16_launches=got16, bf16_cpu_mean_rel_err=port,
                   bf16_f32_mean_rel_dist=own)
    torch.backends.cudnn.allow_tf32 = True
    return out


def phase_pin(torch, tds, report):
    """Phase 14: BASELINE configs 1 and 3 trained (float32 and bfloat16)
    and served on the card, and the 'rc' and 'dc' heads served."""
    import numpy as np
    report['pin_train'] = {}
    serve = report['pin_serve'] = {}
    rng = np.random.default_rng(14)
    hr = rng.standard_normal((N_GRIDS, LR, LR)).astype('float32')
    odd = rng.standard_normal((N_GRIDS, PIN_ODD, PIN_ODD)).astype('float32')
    batches = -(-N_GRIDS // BATCH)
    for name in PIN_CONFIGS:
        model, net = _pin_training(torch, tds, name, report)
        spec = dict(n_channels=1, n_aux_channels=0,
                    hr_size=model.input_shape[:2], n_filters=N_FILTERS,
                    n_blocks=model.config['n_blocks'], dtype=torch.bfloat16)
        factory = tds.unet_pin if name == 'unet_pin' else tds.net_pin
        bf16 = factory(PIN_CONFIGS[name]['backbone'], **spec)
        kwargs = dict(scale=SCALE, array_in_hr=True, batch_size=BATCH)
        serve[name] = _check_served(
            torch, tds, f'{name} predict, {N_GRIDS} HR grids {LR}x{LR}',
            model, net, hr, kwargs, {'K1': batches, 'K2': 0}, bf16=bf16)
        if name == 'unet_pin':
            serve[f'{name}_odd'] = _check_served(
                torch, tds, f'{name} predict, {N_GRIDS} HR grids '
                f'{PIN_ODD}x{PIN_ODD}', model, net, odd, kwargs,
                {'K1': batches, 'K2': 0})
    report['pin_serve_gates'] = _k1_gate_rows(
        torch, tds, [(BATCH, LR, LR, N_FILTERS)], 'pin serving gate')
    lr_grids = rng.standard_normal((N_GRIDS, LR, LR)).astype('float32')
    for ups in ('rc', 'dc'):
        model = tds.net_postupsampling(
            'resnet', ups, scale=SCALE, n_channels=1, n_aux_channels=0,
            lr_size=(LR, LR), n_filters=N_FILTERS, n_blocks=N_BLOCKS,
            attention=True)
        serve[f'resnet_{ups}'] = _check_served(
            torch, tds, f'resnet_{ups} predict, {N_GRIDS} LR grids '
            f'{LR}x{LR} -> {LR * SCALE}', model, model.init(0, 'cuda'),
            lr_grids, dict(scale=SCALE, array_in_hr=False, batch_size=BATCH),
            {'K1': len(K1_SHAPES) * batches, 'K2': 0})
    model = tds.recnet_postupsampling(
        'resnet', 'dc', scale=SCALE, n_channels=1, n_aux_channels=0,
        lr_size=(LR, LR), time_window=REC_T, n_filters=N_FILTERS,
        n_blocks=REC_BLOCKS)
    rec = rng.standard_normal((REC_GRIDS, LR * SCALE, LR * SCALE)).astype(
        'float32')
    n_windows = REC_GRIDS - REC_T + 1
    serve['recresnet_dc'] = _check_served(
        torch, tds, f'recresnet_dc predict(time_window={REC_T}), '
        f'{REC_GRIDS} HR grids {LR * SCALE}x{LR * SCALE}', model,
        model.init(0, 'cuda'), rec,
        dict(scale=SCALE, time_window=REC_T, batch_size=BATCH),
        {'K1': 0, 'K2': len(K2_LAYERS) * REC_T * -(-n_windows // BATCH)},
        cpu_slice=slice(0, REC_T))
    head = [r for r in report['k1_rows'] if r['dtype'] == 'float32'
            and r['shape'] == [BATCH, LR * SCALE, LR * SCALE, N_FILTERS]]
    if len(head) != 1:
        fail(f'phase 2 timed no gate at the x4 heads\' shape: {head}')
    report['rc_dc_head_gate'] = head[0]


def _pin_kernel_rows(report):
    """The `kernels` line's rows of phase 14: K1 in the training steps of
    BASELINE configs 1 and 3 (launches from the float32 runs' device
    traces, times at the step's gate shape measured in phase 14) and K1
    serving the pin models and the 'rc'/'dc' heads (launches from their
    wrappers; the pin serving gate timed in phase 14, the x4 heads' gates
    at phase 2's shapes, timed there)."""
    k1 = dict(route='cuda', source='dl4ds_tpu_torch/csrc/channel_attention.cu',
              replaces='dl4ds_tpu/ops/pallas_ops.py:39', bound_by='bytes',
              library_ms=None)
    rows = []
    for name, train in report['pin_train'].items():
        gates = train['gates']
        rows.append(dict(
            k1, name=f'K1_channel_attention_{name}_train',
            launches=train['launches']['K1'],
            wrapper_calls=train['wrapper_calls']['K1'],
            max_abs_err=max(r['max_abs_err'] for r in gates),
            ms=sum(r['ms'] for r in gates),
            plain_ms=sum(r['plain_ms'] for r in gates),
            bound_ms=sum(r['bound_ms'] for r in gates),
            bwd_ms=sum(r['bwd_ms'] for r in gates),
            bwd_plain_ms=sum(r['bwd_plain_ms'] for r in gates),
            bwd_bound_ms=sum(r['bwd_bound_ms'] for r in gates),
            bwd_launches=train['launches']['K1 backward'],
            bf16_launches=train['bf16']['launches']['K1'],
            work=f'the output head\'s gate of one float32 {name} training '
                 f'step at batch {TRAIN_BATCH}, x{gates[0]["shape"]}, '
                 f'forward and backward; launches from phase 14\'s device '
                 f'trace'))
    serve = report['pin_serve']
    gate = report['pin_serve_gates'][0]
    rows.append(dict(
        k1, name='K1_channel_attention_pin_serve',
        launches=serve['convnet_pin']['launches']['K1']
        + serve['unet_pin']['launches']['K1'],
        max_abs_err=gate['max_abs_err'], ms=gate['ms'],
        plain_ms=gate['plain_ms'], bound_ms=gate['bound_ms'],
        work=f'the output head\'s gate of one pin serving forward at batch '
             f'{BATCH}, x{gate["shape"]}; launches of predict on {N_GRIDS} '
             f'grids of convnet_pin and unet_pin'))
    head = report['rc_dc_head_gate']
    rows.append(dict(
        k1, name='K1_channel_attention_rc_dc_serve',
        launches=serve['resnet_rc']['launches']['K1']
        + serve['resnet_dc']['launches']['K1'],
        max_abs_err=head['max_abs_err'], ms=head['ms'],
        plain_ms=head['plain_ms'], bound_ms=head['bound_ms'],
        work=f'the output head\'s gate behind the x4 rc and dc heads at '
             f'batch {BATCH}, x{head["shape"]} (phase 2\'s shape, timed '
             f'there); launches of predict on {N_GRIDS} grids of resnet_rc '
             f'and resnet_dc, whose six residual gates are phase 2\'s too'))
    return rows


# ---------------------------------------------------------------------------
# Phase 15: train-mode state (bn, ln, every dropout, MC dropout), ConvNeXt
# and the localized layer, trained and served
# ---------------------------------------------------------------------------

# (a) convnext_spc x4 with the localized layer at full width (n_filters 8,
# n_blocks 6, 2 statics, a predictor), trained on whole 128x128 HR grids
# (its per-pixel weights fix the grid) at batch 32: the pixels of bench.py's
# 128 patches of 64x64. Its one K1 gate is the output head's: [32, 128, 128,
# 8] in a training step, [8, 128, 128, 8] serving (phase 14's pin serving
# gate, timed there)
CNX_BATCH, CNX_CPU_BATCH = 32, 4
CNX_GATES = [(CNX_BATCH, TRAIN_HR, TRAIN_HR, N_FILTERS)]
# (b) the flagship with batch norm, MC dropout at the reference factory's
# default rate and an EMA, trained as phase 10 with mae and served as an
# ensemble of MC_MEMBERS members; (c) recresnet_spc with layer norm and MC
# spatial dropout, trained as phase 7, served as REC_MC_MEMBERS members
MC_RATE, MC_EMA = 0.2, 0.999
MC_MEMBERS, REC_MC_MEMBERS = 8, 4
# the steps of an epoch in phase 15's training runs (half of TRAIN_STEPS):
# each step is checked as before, a run traces, times and replays half as
# many (the phase took 104-111 s with 20)
STATE_STEPS = 10
# (a)'s served grid 0 against float64 where float32 is ill-conditioned:
# the bound of its worst pixels, in units of PREDICT_TOL (float32's sum
# order alone moved them up to 4.9e-4 in runs of this phase on the H100)
SERVE_ILL_FACTOR = 100


def _convnext_config():
    """(a)'s SupervisedTrainer arguments: phase 7's 256 seeded grids of
    128x128, whole grids, 2 statics and a predictor."""
    import numpy as np
    config = _training_config(backbone='convnext', loss='mae',
                              n_filters=N_FILTERS, n_blocks=N_BLOCKS,
                              localcon_layer=True)
    rng = np.random.default_rng(15)
    topo = rng.standard_normal((TRAIN_HR, TRAIN_HR)).astype('float32')
    mask = (rng.random((TRAIN_HR, TRAIN_HR)) > 0.5).astype('float32')
    pred = rng.standard_normal(
        (TRAIN_GRIDS, TRAIN_HR, TRAIN_HR, 1)).astype('float32')
    v = slice(0, 64)
    config.update(patch_size=None, static_vars=[topo, mask],
                  predictors_train=[pred], predictors_val=[pred[v]],
                  predictors_test=[pred[v]])
    return config


def _state_config(name):
    """The SupervisedTrainer arguments of phase 15's (a) 'convnext', (b)
    'bn_mc' and (c) 'recurrent' training (also read by
    torch_train_profile.py --state)."""
    if name == 'convnext':
        return _convnext_config()
    if name == 'bn_mc':
        return _training_config(loss='mae', n_filters=N_FILTERS,
                                n_blocks=N_BLOCKS, attention=True,
                                normalization='bn', dropout_rate=MC_RATE,
                                dropout_variant='mcdrop', ema_decay=MC_EMA)
    return _training_config(loss='mae', time_window=REC_T,
                            n_blocks=REC_BLOCKS, n_filters=N_FILTERS,
                            normalization='ln', dropout_rate=MC_RATE,
                            dropout_variant='mcspatialdrop')


def _served_vs_float64(torch, tds, label, model, net, grids, kwargs, y32):
    """Grid 0 of `y32` (the card's `predict`, TF32 off) against the same
    model run on the CPU in float64 on the same assembled input: every
    pixel within PREDICT_TOL of max(1, max|y|), or, where float32 itself
    lands farther at single pixels (a layer norm with eps 1e-6 over
    ConvNeXt's 2 static channels: where they nearly agree, float32's sum
    order alone moves its output by up to 1e-2, and the 7x7 head spreads
    that over a few hundred pixels), 99% of the pixels within it and every
    pixel within SERVE_ILL_FACTOR times it. The CPU's own float32 run is
    printed beside."""
    import numpy as np
    preds = kwargs.get('predictors')
    x, aux, _ = tds.inference._assemble_inputs(
        model, grids[:1], kwargs['scale'], kwargs.get('array_in_hr', True),
        kwargs.get('static_vars'), None if preds is None else [preds[0][:1]],
        None, 'inter_area', torch.device('cpu'))
    with torch.no_grad():
        y64 = copy.deepcopy(net).cpu().double().eval()(
            x.double(), None if aux is None else aux.double()).numpy()[0]
        y_f32 = copy.deepcopy(net).cpu().eval()(x, aux).numpy()[0]
    gpu, own = np.abs(y32[0] - y64), np.abs(y_f32 - y64)
    tol = PREDICT_TOL['atol'] * max(1.0, float(np.abs(y64).max()))
    numbers = dict(cpu_f64_max_abs_err=float(gpu.max()),
                   cpu_f32_max_abs_err=float(own.max()),
                   cpu_f64_p99_abs_err=float(np.quantile(gpu, 0.99)),
                   cpu_f32_p99_abs_err=float(np.quantile(own, 0.99)),
                   cpu_f64_mean_abs_err=float(gpu.mean()),
                   cpu_f32_mean_abs_err=float(own.mean()))
    print(f'phase 15, {label}: grid 0, GPU (TF32 off) vs CPU float64 max|d| '
          f'{gpu.max():.3e}, 99th percentile '
          f'{numbers["cpu_f64_p99_abs_err"]:.3e}, mean {gpu.mean():.3e}; the '
          f'CPU\'s float32 run {own.max():.3e}, '
          f'{numbers["cpu_f32_p99_abs_err"]:.3e}, {own.mean():.3e} from it '
          f'(max|y| {float(np.abs(y64).max()):.3e}; every pixel within '
          f'{tol:.3g}, or 99% within it and all within '
          f'{SERVE_ILL_FACTOR * tol:.3g} required); {card_line()}',
          flush=True)
    if not (gpu.max() <= tol or (numbers['cpu_f64_p99_abs_err'] <= tol
                                 and gpu.max() <= SERVE_ILL_FACTOR * tol)):
        fail(f'phase 15: {label} on the GPU is {gpu.max():.3e} (99th '
             f'percentile {numbers["cpu_f64_p99_abs_err"]:.3e}) from the CPU '
             f'in float64, the CPU\'s float32 run {own.max():.3e}')
    return numbers


def _serve_counted(torch, tds, fn):
    """`fn()` with the launch counters zeroed just before and read just
    after; returns (its result, {counter: launches}, seconds)."""
    counters = _counters(tds)
    for _, c, attr in counters:
        setattr(c, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, {name: getattr(c, attr) for name, c, attr in counters}, \
        seconds


def _state_convnext(torch, tds, report):
    """(a): convnext_spc with the localized layer trained (float32 and
    bfloat16), replayed against eager, and served."""
    import numpy as np
    from dl4ds_tpu_torch.ops import fused_ops as fo
    config = _convnext_config()
    shapes = _gate_inputs(torch, tds, config, batch=CNX_BATCH)
    if shapes != CNX_GATES:
        fail(f'phase 15: the convnext step\'s gates are {shapes}, not '
             f'{CNX_GATES}')
    rows = _k1_gate_rows(torch, tds, shapes, 'convnext training gate')
    per_step = _flagship_per_step(len(shapes), ssim=False)
    label = (f'convnext_spc + localized layer, n_filters {N_FILTERS}, '
             f'n_blocks {N_BLOCKS}, whole {TRAIN_HR}x{TRAIN_HR} grids, mae')
    got, calls, numbers = _drive_training(
        torch, tds, config, label, STATE_STEPS, per_step, CNX_CPU_BATCH,
        {'K1 forward': sum(r['ms'] for r in rows),
         'K1 backward': sum(r['bwd_ms'] for r in rows)}, keep_model=True,
        f32_yardstick='all', batch=CNX_BATCH, retraces=1)
    model, net = numbers.pop('model')
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    graphs = _graphs_vs_eager(torch, tds, fo, config, label, per_step,
                              batch=CNX_BATCH)
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved
    bf16 = _bf16_training(torch, tds, dict(config, dtype=torch.bfloat16),
                          f'{label}, bfloat16', STATE_STEPS, per_step,
                          batch=CNX_BATCH, retraces=1)
    # serving: 16 HR grids of the training grid with the statics and a
    # predictor, at batch 8
    rng = np.random.default_rng(151)
    grids = rng.standard_normal((N_GRIDS, TRAIN_HR, TRAIN_HR)).astype(
        'float32')
    pred = rng.standard_normal((N_GRIDS, TRAIN_HR, TRAIN_HR, 1)).astype(
        'float32')
    kwargs = dict(scale=SCALE, array_in_hr=True,
                  static_vars=config['static_vars'], predictors=[pred],
                  batch_size=BATCH)
    torch.backends.cudnn.allow_tf32 = True
    y, served, serve_s = _serve_counted(
        torch, tds, lambda: tds.predict((model, net), grids, **kwargs))
    want = -(-N_GRIDS // BATCH)
    print(f'phase 15, convnext_spc predict, {N_GRIDS} HR grids '
          f'{TRAIN_HR}x{TRAIN_HR} at batch {BATCH}: output {y.shape}, '
          f'launches {served} (K1 {want} expected, no backward), '
          f'{N_GRIDS / serve_s:.2f} grids/s end to end (host clock, the '
          f'first call); {card_line()}', flush=True)
    if (served['K1'] != want or served['K1 backward']
            or y.shape != (N_GRIDS, TRAIN_HR, TRAIN_HR, 1)
            or not np.isfinite(y).all()):
        fail(f'phase 15: convnext predict launched {served}, output '
             f'{y.shape}, finite {bool(np.isfinite(y).all())}')
    torch.backends.cudnn.allow_tf32 = False
    y32 = tds.predict((model, net), grids, **kwargs)
    cpu = _served_vs_float64(torch, tds, 'convnext_spc predict', model, net,
                             grids, kwargs, y32)
    torch.backends.cudnn.allow_tf32 = True
    g = numbers['graphed']
    print(f'phase 15, {label}, batch {CNX_BATCH}: float32 graphed '
          f'{g["patches_per_s"]:.1f} grids/s, eager '
          f'{numbers["patches_per_s"]:.1f} (host clock); one replay '
          f'{g["replay_ms"]:.3f} ms, one eager step {numbers["step_ms"]:.3f} '
          f'ms (CUDA events), device busy {100 * g["busy_share"]:.1f}%; '
          f'bfloat16 graphed {bf16["graphed"]["patches_per_s"]:.1f} grids/s; '
          f'{card_line()}', flush=True)
    report['state']['convnext'] = dict(
        gates=rows, launches=got, wrapper_calls=calls,
        graphs_vs_eager=graphs['max_abs_diff'], bf16=bf16,
        serve_launches=served, serve_grids_per_s=N_GRIDS / serve_s, **cpu,
        **numbers)


def _mc_serve(torch, tds, label, model, net, grids, kwargs, members,
              per_member, seed=0, probe=None):
    """`predict` of an 'mc*' model twice (the same bits), then
    `predict_mc(n_members=members)` with the launches counted ({counter:
    n} a member, `per_member`), one seed giving the same bits twice, and
    the members differing with std > 0 somewhere. With `probe` (a
    submodule's name) the members are told apart by that submodule's
    output instead, for a model whose output does not depend on its
    dropout (an 'ln' model with one output channel: see phase 15 (c)).
    Returns the numbers."""
    import numpy as np
    a, first, _ = _serve_counted(
        torch, tds, lambda: tds.predict((model, net), grids, SCALE,
                                        **kwargs))
    b = tds.predict((model, net), grids, SCALE, **kwargs)
    if not np.array_equal(a, b):
        fail(f'phase 15: {label} predict gave other bits the second time')
    sums = []
    hook = None if probe is None else net.get_submodule(probe)\
        .register_forward_hook(lambda m, i, o: sums.append(
            float(o.double().abs().sum())))

    def ensemble():
        return tds.predict_mc((model, net), grids, SCALE, n_members=members,
                              seed=seed, return_members=True, **kwargs)
    (mean, std, stack), got, seconds = _serve_counted(torch, tds, ensemble)
    if hook is not None:
        hook.remove()
    want = {name: n * members for name, n in per_member.items()}
    again = ensemble()[2]
    same_seed = bool(np.array_equal(again, stack))
    if probe is None:
        differ = all(not np.array_equal(stack[0], stack[k])
                     for k in range(1, members))
    else:
        # one probe output a batch: member k's are sums[k * per : ...]
        per = len(sums) // members
        rows = [tuple(sums[k * per:(k + 1) * per]) for k in range(members)]
        differ = len(set(rows)) == members
    spread = float((std > 0).mean())
    print(f'phase 15, {label}: predict twice the same bits, launches '
          f'{first}; predict_mc({members} members) output {stack.shape}, '
          f'launches {got} (expected {want}), members differ {differ}'
          + (f' (by {probe}\'s output)' if probe else '')
          + f', std > 0 at {100 * spread:.1f}% of the values (mean std '
          f'{float(std.mean()):.3e}), the same seed the same bits '
          f'{same_seed}; {members / seconds:.2f} members/s '
          f'({members * stack.shape[1] / seconds:.2f} grids/s, host clock); '
          f'{card_line()}', flush=True)
    kept = {k: v for k, v in got.items() if v or want.get(k)}
    if (kept != {k: v for k, v in want.items() if v} or not differ
            or not (spread > 0 or probe) or not same_seed
            or not np.isfinite(stack).all()):
        fail(f'phase 15: {label} predict_mc launched {got}, expected '
             f'{want}; members differ {differ}, std > 0 at {spread}, '
             f'same seed same bits {same_seed}')
    return dict(predict_launches=first, mc_launches=got,
                members_per_s=members / seconds, std_share=spread,
                mean_std=float(std.mean()), members_differ=differ)


def _state_bn_mc(torch, tds, report):
    """(b): the flagship with bn, MC dropout and an EMA, trained (the CPU
    steps on the card's masks, the running statistics compared), replayed
    against eager, and served as one fixed member and as an ensemble."""
    import numpy as np
    from dl4ds_tpu_torch.ops import fused_ops as fo
    config = _state_config('bn_mc')
    shapes = _gate_inputs(torch, tds, config)
    if shapes != K1_TRAIN_SHAPES:
        fail(f'phase 15: the bn flagship step\'s gates are {shapes}, not '
             f'{K1_TRAIN_SHAPES}')
    rows = report['k1_train_rows']      # phase 10's, at the same shapes
    per_step = _flagship_per_step(len(shapes), ssim=False)
    label = (f'resnet_spc bn + mcdrop {MC_RATE} + EMA {MC_EMA}, n_filters '
             f'{N_FILTERS}, mae')
    got, calls, numbers = _drive_training(
        torch, tds, config, label, STATE_STEPS, per_step, FLAG_CPU_BATCH,
        {'K1 forward': sum(r['ms'] for r in rows),
         'K1 backward': sum(r['bwd_ms'] for r in rows)}, keep_model=True,
        f32_yardstick='all', draws=True, retraces=1)
    model, net = numbers.pop('model')
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    graphs = _graphs_vs_eager(torch, tds, fo, config, label, per_step)
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved
    lr_grids = np.random.default_rng(152).standard_normal(
        (N_GRIDS, LR, LR)).astype('float32')
    batches = -(-N_GRIDS // BATCH)
    serve = _mc_serve(torch, tds, f'{label}, {N_GRIDS} LR grids {LR}x{LR} '
                      f'-> {LR * SCALE}', model, net, lr_grids,
                      dict(array_in_hr=False, batch_size=BATCH), MC_MEMBERS,
                      {'K1': len(K1_SHAPES) * batches})
    report['state']['bn_mc'] = dict(
        launches=got, wrapper_calls=calls,
        graphs_vs_eager=graphs['max_abs_diff'], serve=serve, **numbers)


def _state_recurrent(torch, tds, report):
    """(c): recresnet_spc with ln and MC spatial dropout trained as phase 7
    (the CPU steps on the card's masks) and served as an ensemble. Its
    output ConvBlock normalizes its one output channel with a layer norm,
    as the JAX package's does, so the model's output is that norm's bias
    whatever its input: the members are told apart by the backbone's
    output, where the ConvLSTM layers (K2) run on the dropped channels."""
    import numpy as np
    import dl4ds_tpu_torch.ops.convlstm as conv
    step = report['k3_step']
    config = _state_config('recurrent')
    label = (f'recresnet_spc ln + mcspatialdrop {MC_RATE}, n_filters '
             f'{N_FILTERS}')
    got, calls, numbers = _drive_training(
        torch, tds, config, label, STATE_STEPS,
        _recurrent_per_step(conv, K3_LAYERS), 16,
        {'K2-train': sum(r['k2_ms'] for r in step),
         'K3': sum(r['k3_ms'] for r in step)}, keep_model=True,
        f32_yardstick='all', draws=True, retraces=1)
    model, net = numbers.pop('model')
    rec = np.random.default_rng(153).standard_normal(
        (REC_GRIDS, LR * SCALE, LR * SCALE)).astype('float32')
    n_windows = REC_GRIDS - REC_T + 1
    serve = _mc_serve(
        torch, tds, f'{label}, {REC_GRIDS} HR grids {LR * SCALE}x'
        f'{LR * SCALE}, time_window {REC_T}', model, net, rec,
        dict(time_window=REC_T, batch_size=BATCH), REC_MC_MEMBERS,
        {'K2 inference': len(K2_LAYERS) * REC_T * -(-n_windows // BATCH)},
        probe='_RecBackbone_0')
    report['state']['recurrent'] = dict(launches=got, wrapper_calls=calls,
                                        serve=serve, **numbers)


def phase_state(torch, tds, report):
    """Phase 15: train-mode state, ConvNeXt and the localized layer."""
    report['state'] = {}
    _state_convnext(torch, tds, report)
    _state_bn_mc(torch, tds, report)
    _state_recurrent(torch, tds, report)


def _state_kernel_rows(report):
    """The `kernels` line's rows of phase 15. Training kernels: `launches`
    from the phase's device traces, `wrapper_calls` their wrappers'
    counts; serving: the wrappers' counts of the `predict_mc` runs. Times
    at shapes an earlier phase timed come from that phase (the bn
    flagship's gates are phase 10's, the MC serving gates phase 2's, the
    recurrent layers phases 6 and 4's), the convnext training gate's from
    phase 15 and its serving gate's from phase 14."""
    st = report['state']
    k1 = dict(route='cuda', source='dl4ds_tpu_torch/csrc/channel_attention.cu',
              replaces='dl4ds_tpu/ops/pallas_ops.py:39', bound_by='bytes',
              library_ms=None)

    def k1_row(name, rows, launches, work, **extra):
        row = dict(k1, name=name, launches=launches,
                   max_abs_err=max(r['max_abs_err'] for r in rows),
                   ms=sum(r['ms'] for r in rows),
                   plain_ms=sum(r['plain_ms'] for r in rows),
                   bound_ms=sum(r['bound_ms'] for r in rows), work=work,
                   **extra)
        if 'bwd_ms' in rows[0] and 'bwd_launches' in extra:
            row.update(bwd_ms=sum(r['bwd_ms'] for r in rows),
                       bwd_plain_ms=sum(r['bwd_plain_ms'] for r in rows),
                       bwd_bound_ms=sum(r['bwd_bound_ms'] for r in rows))
        return row
    cnx, bn, rec = st['convnext'], st['bn_mc'], st['recurrent']
    f32 = [r for r in report['k1_rows'] if r['dtype'] == 'float32']
    out = [
        k1_row('K1_channel_attention_convnext_train', cnx['gates'],
               cnx['launches']['K1'],
               f'the output head\'s gate of one float32 convnext_spc '
               f'(localized layer) training step at batch {CNX_BATCH}, '
               f'x{cnx["gates"][0]["shape"]}, forward and backward; '
               f'launches from phase 15\'s device trace',
               wrapper_calls=cnx['wrapper_calls']['K1'],
               bwd_launches=cnx['launches']['K1 backward'],
               bf16_launches=cnx['bf16']['launches']['K1']),
        k1_row('K1_channel_attention_convnext_serve',
               report['pin_serve_gates'], cnx['serve_launches']['K1'],
               f'the output head\'s gate serving convnext_spc at batch '
               f'{BATCH}, x{report["pin_serve_gates"][0]["shape"]} (phase '
               f'14\'s pin serving gate, timed there); launches of predict '
               f'on {N_GRIDS} grids'),
        k1_row('K1_channel_attention_bn_train', report['k1_train_rows'],
               bn['launches']['K1'],
               f'the {len(report["k1_train_rows"])} gates of one float32 '
               f'training step of the flagship with bn, MC dropout and an '
               f'EMA at batch {TRAIN_BATCH} (phase 10\'s shapes, timed '
               f'there), forward and backward; launches from phase 15\'s '
               f'device trace', wrapper_calls=bn['wrapper_calls']['K1'],
               bwd_launches=bn['launches']['K1 backward']),
        k1_row('K1_channel_attention_mc_serve', f32,
               bn['serve']['mc_launches']['K1'],
               f'the {len(f32)} gates of one float32 forward at batch '
               f'{BATCH} (phase 2\'s shapes, timed there); launches of '
               f'predict_mc with {MC_MEMBERS} members on {N_GRIDS} grids'),
    ]
    step = report['k3_step']
    conv = dict(route='cuda', bound_by='operations', library_ms=None)
    out.append(dict(
        conv, name='K2_convlstm_train_ln_dropout',
        source='dl4ds_tpu_torch/csrc/convlstm.cu',
        replaces='dl4ds_tpu/ops/pallas_convlstm.py:219',
        launches=rec['launches']['K2-train'],
        wrapper_calls=rec['wrapper_calls']['K2-train'],
        max_abs_err=max(max(r['ys_cs_zs_err'][:2]) for r in
                        report['k3_rows'] if 'ys_cs_zs_err' in r),
        ms=sum(r['k2_ms'] for r in step),
        plain_ms=sum(r['k2_plain_ms'] for r in step),
        bound_ms=sum(r['k2_bound_ms'] for r in step),
        work=f'the {len(step)} ConvLSTM layers of one float32 recresnet_spc '
             f'training step at batch {TRAIN_BATCH} (phase 6\'s shapes, '
             f'timed there), under ln and MC spatial dropout; launches '
             f'from phase 15\'s device trace'))
    out.append(dict(
        conv, name='K3_convlstm_bptt_ln_dropout',
        source='dl4ds_tpu_torch/csrc/convlstm_bwd.cu',
        replaces='dl4ds_tpu/ops/pallas_convlstm.py:335',
        launches=rec['launches']['K3'],
        wrapper_calls=rec['wrapper_calls']['K3'],
        max_abs_err=max(max(v for k, v in r['grad_rel_err'].items()
                            if k != 'plain_f32') for r in report['k3_rows']),
        ms=sum(r['k3_ms'] for r in step),
        plain_ms=sum(r['k3_plain_ms'] for r in step),
        bound_ms=sum(r['k3_bound_ms'] for r in step),
        work='the BPTT of the same layers (phase 6\'s timing); launches '
             'from phase 15\'s device trace'))
    fwd = report['k2_forward']
    out.append(dict(
        conv, name='K2_convlstm_mc_serve',
        source='dl4ds_tpu_torch/csrc/convlstm.cu',
        replaces='dl4ds_tpu/ops/pallas_convlstm.py:219',
        launches=rec['serve']['mc_launches']['K2 inference'],
        max_abs_err=max(r['max_abs_err'] for r in report['k2_rows']),
        ms=sum(r['ms'] for r in fwd),
        plain_ms=sum(r['plain_ms'] for r in fwd),
        bound_ms=sum(r['bound_ms'] for r in fwd),
        work=f'the {len(fwd)} ConvLSTM layers of one float32 forward at '
             f'batch {BATCH} (phase 4\'s shapes, timed there); launches of '
             f'predict_mc with {REC_MC_MEMBERS} members on {REC_GRIDS} '
             f'grids'))
    return out


# ---------------------------------------------------------------------------
# Phase 16: CGAN training (BASELINE config 5)
# ---------------------------------------------------------------------------

# (a) bench_suite.py's cgan_resnet_spc_4x (measure_cgan, bench_suite.py:
# 149-175): G resnet_spc x4 (n_filters 8, n_blocks 6, attention), D
# n_filters 32 and n_res_blocks 4 without attention, both Adam(2e-4, b1
# 0.5, eps 1e-7), on phase 7's 256 grids of 128x128, 64x64 patches, batch
# 128, mae; trained in float32 and bfloat16 (the bench's dtype), its test
# loss on CGAN_TEST grids; 3 steps at CGAN_CPU_BATCH against the CPU in
# float64. Its K1 gates are G's, at phase 10's shapes
CGAN_G = dict(n_filters=N_FILTERS, n_blocks=N_BLOCKS, attention=True)
CGAN_D = dict(n_filters=32, n_res_blocks=4)
CGAN_TEST, CGAN_CPU_BATCH = 64, 4
# (a)'s runs, float32 and bfloat16: 2 epochs of CGAN_STEPS steps (half of
# TRAIN_STEPS: the phase was the longest; every check is kept)
CGAN_STEPS = 10
# (b) the spatio-temporal pair: recresnet_spc x4 (n_filters 8, REC_BLOCKS
# blocks, T 4) and D with its recurrent stem (layer norm, F 32), attention
# in both (G's recurrent head gates are plain tensor math, so K1 runs in D
# alone): 2 epochs of CGAN_REC_STEPS steps; its D flattens [B, T] to 512
# frames, so its gates are [512, 16, 16, 32] (branch 1), [512, 64, 64, 32]
# (branch 2) and [512, 16, 16, 64] (the merge)
CGAN_REC_STEPS, CGAN_REC_CPU_BATCH = 10, 2
CGAN_D_GATES = [(TRAIN_BATCH * REC_T, TRAIN_LR, TRAIN_LR, 32),
                (TRAIN_BATCH * REC_T, TRAIN_PATCH, TRAIN_PATCH, 32),
                (TRAIN_BATCH * REC_T, TRAIN_LR, TRAIN_LR, 64)]
# (Cin, F, k, x needs a gradient) of D's recurrent stem: the LR input (no
# gradient), then F -> F
CGAN_D_STEM = [(1, 32, 5, False), (32, 32, 3, True)]
# (c) checkpoints of (a)'s float32 pair with D's gates on too (the JAX
# `load_checkpoint`'s one `attention` flag builds both networks), an EMA,
# 2 epochs of CGAN_CKPT_STEPS steps, then one resumed epoch
CGAN_CKPT_STEPS, CGAN_EMA = 5, 0.999


def _cgan_config(recurrent=False, dtype=None):
    """CGANTrainer arguments of phase 16's (a) or, with `recurrent`, (b)
    (also read by torch_train_profile.py --cgan)."""
    import numpy as np
    data = np.random.default_rng(0).standard_normal(
        (TRAIN_GRIDS, TRAIN_HR, TRAIN_HR, 1)).astype('float32')
    gen, disc = dict(CGAN_G), dict(CGAN_D)
    if recurrent:
        gen.update(n_blocks=REC_BLOCKS)
        disc.update(attention=True)
    if dtype is not None:
        gen.update(dtype=dtype)
        disc.update(dtype=dtype)
    return dict(backbone='resnet', upsampling='spc', data_train=data,
                data_test=data[:CGAN_TEST], scale=SCALE,
                patch_size=TRAIN_PATCH, batch_size=TRAIN_BATCH, loss='mae',
                learning_rates=(2e-4, 2e-4),
                time_window=REC_T if recurrent else None,
                generator_params=gen, discriminator_params=disc,
                verbose=False, save_loss_history=False)


def _cgan_per_step(tr):
    """({'train': {counter: launches}, 'eval': ...}, {counter: launches of
    the eager test loss}) of a set-up CGAN trainer, read from its
    networks: K1 a gate of G's forward and two of D's (D(fake), D(real));
    its backward G's gates, D(fake)'s gates on the way to the generated
    grids (branch 2 and the merge) in G's pass, and every gate of both D
    calls in D's pass; K2's training variant T launches a ConvLSTM layer
    of G and two of D's stem, and by `dispatch_info`'s route K3 (T chain
    steps, dx where the layer's input needs a gradient, the two weight
    passes and the reduction) or K4 (T chain steps) as many times. The
    test loss runs G's gates and its ConvLSTM layers in eval mode over
    chunks of min(batch, n_test)."""
    import dl4ds_tpu_torch.ops.convlstm as conv
    from dl4ds_tpu_torch.models.blocks import ChannelAttention2D, ConvLSTM2D

    def gates(net, where=lambda name: True):
        return sum(1 for n, m in net.named_modules()
                   if isinstance(m, ChannelAttention2D) and where(n)
                   and not (m.time_window and m.time_window > 1))

    def layers(net, first):
        return [(m.input_conv.kernel.shape, m.cell.recurrent_conv.kernel
                 .shape, n != first) for n, m in net.named_modules()
                if isinstance(m, ConvLSTM2D)]
    g, d = gates(tr.gen_net), gates(tr.disc_net)
    d_fake = gates(tr.disc_net, lambda n: n.startswith('ResidualBlock_0')
                   or '_branch2' in n)
    train = {'K2-train': 0, 'K2 inference': 0, 'K3': 0, 'K4': 0,
             'K1': g + 2 * d, 'K1 backward': g + d_fake + 2 * d, 'K6': 0,
             'K6 backward': 0}
    itemsize = 2 if str(tr.generator.dtype).endswith('bfloat16') else 4
    g_layers = layers(tr.gen_net, '_RecBackbone_0.RecurrentConvBlock1.'
                      'ConvLSTM2D_0')
    d_layers = layers(tr.disc_net, 'RecurrentConvBlock_0.ConvLSTM2D_0')
    for calls, group in ((1, g_layers), (2, d_layers)):
        for wx, wh, need_dx in group:
            x = (TRAIN_BATCH, REC_T, TRAIN_LR, TRAIN_LR, wx[2])
            route = conv.dispatch_info(x, tuple(wx), tuple(wh),
                                       itemsize)['path']
            train['K2-train'] += calls * REC_T
            if route == 'fused':
                train['K3'] += calls * (REC_T + int(need_dx) + 3)
            else:
                train['K4'] += calls * REC_T
    n_test = CGAN_TEST - (REC_T if tr.time_window else 0)
    chunks = -(-n_test // min(TRAIN_BATCH, n_test))
    outside = {'K1': g * chunks, 'K2 inference': len(g_layers) * REC_T
               * chunks}
    evaluation = dict.fromkeys(train, 0)
    return {'train': train, 'eval': evaluation}, outside


def _drive_cgan(torch, tds, config, label, steps, shares):
    """CGANTrainer(**config).run() on the card, 2 epochs of `steps` steps
    replayed, under torch.profiler with every launch counter set to 0 just
    before: the wrappers' calls and the launches in the device trace
    against what a step makes (`_cgan_per_step`, `_check_launches`),
    finite losses and test loss; then eager steps (host clock, one on CUDA
    events, with the kernels' shares of it from `shares`) and the replays
    (`_graphed_speed`). Returns the trainer and the numbers."""
    import numpy as np
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = tds.CGANTrainer(epochs=TRAIN_EPOCHS, steps_per_epoch=steps,
                         **config)
    run_s, calls, kernels = _traced_run(torch, tds, tr)
    per_step, outside = _cgan_per_step(tr)
    got = _check_launches(tds, tr.runner, f'phase 16 ({label})', per_step,
                          {'step': TRAIN_EPOCHS * steps}, calls, kernels,
                          outside)
    losses = np.array([tr.gentotal, tr.gengan, tr.gen_pxloss, tr.disc])
    print(f'phase 16, {label}: G {tr.generator.name} '
          f'{tr.generator.param_count(tr.gen_net)} parameters, D '
          f'{tr.discriminator.param_count(tr.disc_net)}, batch '
          f'{TRAIN_BATCH}, {TRAIN_EPOCHS} epochs of {steps} steps in '
          f'{run_s:.2f} s under torch.profiler; losses (gentotal, gengan, '
          f'gen_pxloss, disc) by epoch {losses.tolist()}, test loss '
          f'{tr.test_loss:.6f}', flush=True)
    if not (np.isfinite(losses).all() and np.isfinite(tr.test_loss)):
        fail(f'phase 16 ({label}) gave non-finite losses {losses.tolist()}, '
             f'test loss {tr.test_loss}')
    gen = torch.Generator().manual_seed(1)
    idx = tr.ds_train.epoch_indices(gen, steps=steps)
    tr.train_net.train()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(steps):
        tr.train_step(tr.ds_train(idx[c], generator=gen))
    torch.cuda.synchronize()
    eager = steps * TRAIN_BATCH / (time.perf_counter() - t0)
    one = tr.ds_train(idx[0], generator=gen)
    step_ms = statistics.median(
        device_times(torch, lambda: tr.train_step(one), reps=10))
    graphed = _graphed_speed(torch, tds, tr, steps, per_step, label,
                             TRAIN_BATCH, retraces=1)
    print(f'phase 16, {label}, batch {TRAIN_BATCH}: replayed '
          f'{graphed["patches_per_s"]:.1f} patches/s, eager {eager:.1f} '
          f'(host clock); one replay {graphed["replay_ms"]:.3f} ms, one '
          f'eager step {step_ms:.3f} ms (CUDA events), of which '
          + ', '.join(f'{name} {ms:.3f} ms' for name, ms in shares.items())
          + f' timed alone; {graphed["launches_per_replay"]:.0f} launches a '
          f'replay ({graphed["port_launches_per_replay"]:.0f} of the '
          f'port\'s kernels), device busy {100 * graphed["busy_share"]:.1f}%'
          f' of the replays\' span; {card_line()}', flush=True)
    return tr, dict(launches=got, wrapper_calls=calls, per_step=per_step,
                    run_s=run_s, losses=losses.tolist(),
                    test_loss=tr.test_loss, eager_patches_per_s=eager,
                    step_ms=step_ms, graphed=graphed)


def _cgan_vs_cpu(torch, tds, config, label, cpu_batch):
    """3 fused steps at `cpu_batch` from one seed on the card (TF32 off,
    PyTorch's own convolutions, not cuDNN's) and on the CPU in float64 and
    float32, the CPU runs on the card's dropout masks: the four losses
    within TRAIN_LOSS_RTOL and G's and D's parameters within
    TRAIN_PARAM_ATOL of float64, or, where float32 itself lands farther,
    within F32_YARDSTICK_RATIO times the CPU's float32 run (losses, the
    first and the third step's parameters). Returns the numbers."""
    import numpy as np
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs, drawn = {}, []
    for device, dtype in (('cuda', torch.float32), ('cpu', torch.float64),
                          ('cpu', torch.float32)):
        torch.backends.cudnn.enabled = device == 'cpu'
        small = tds.CGANTrainer(**dict(config, batch_size=cpu_batch,
                                       epochs=1, device=device))
        small.setup_datagen()
        small.setup_model()
        small.train_net.to(dtype)
        small.setup_optimizer(3)
        small.train_net.train()
        gen = torch.Generator().manual_seed(3)
        idx = small.ds_train.epoch_indices(gen, steps=3)
        losses, params = [], []
        with _dropout_draws(torch, None if device == 'cuda'
                            else list(drawn)) as log:
            for c in range(3):
                batch = small.ds_train(idx[c], generator=gen)
                losses.append(small.train_step(
                    {k: None if v is None else v.to(dtype)
                     for k, v in batch.items()}).tolist())
                params.append({n: p.detach().to('cpu', torch.float64,
                                                copy=True)
                               for n, p in small.train_net.named_parameters()})
        if device == 'cuda':
            drawn = log
            if not drawn:
                fail(f'phase 16 ({label}): the GPU steps drew no dropout '
                     f'mask')
        runs[device, dtype] = (np.array(losses), params)
    torch.backends.cudnn.enabled = True
    (gpu_l, gpu_p), (ref_l, ref_p), (f32_l, f32_p) = (
        runs['cuda', torch.float32], runs['cpu', torch.float64],
        runs['cpu', torch.float32])

    def distance(params, step):
        return max((params[step][n] - ref_p[step][n]).abs().max().item()
                   for n in ref_p[step])
    loss_err = float((np.abs(gpu_l - ref_l) / np.abs(ref_l)).max())
    own_loss = float((np.abs(f32_l - ref_l) / np.abs(ref_l)).max())
    first, third = distance(gpu_p, 0), distance(gpu_p, 2)
    own_first, own_third = distance(f32_p, 0), distance(f32_p, 2)
    print(f'phase 16, {label}: 3 fused steps at batch {cpu_batch}, GPU (TF32 '
          f'off, PyTorch\'s own convolutions) vs CPU float64 on the GPU\'s '
          f'dropout masks: losses {gpu_l.tolist()} vs {ref_l.tolist()}, max '
          f'relative difference {loss_err:.3e} (the CPU\'s float32 run '
          f'{own_loss:.3e}; rtol {TRAIN_LOSS_RTOL}); G and D parameters '
          f'after one step max|d| {first:.3e} (CPU float32 {own_first:.3e}), '
          f'after three {third:.3e} (CPU float32 {own_third:.3e}; atol '
          f'{TRAIN_PARAM_ATOL}, or at most {F32_YARDSTICK_RATIO}x the CPU\'s '
          f'float32 run)', flush=True)
    if not (loss_err <= max(TRAIN_LOSS_RTOL, F32_YARDSTICK_RATIO * own_loss)
            and first <= max(TRAIN_PARAM_ATOL,
                             F32_YARDSTICK_RATIO * own_first)
            and third <= max(TRAIN_PARAM_ATOL,
                             F32_YARDSTICK_RATIO * own_third)):
        fail(f'phase 16 ({label}): GPU steps disagree with the CPU: losses '
             f'{loss_err:.3e}, parameters {first:.3e} and {third:.3e}')
    return dict(cpu_loss_rel_err=loss_err, cpu_f32_loss_rel_err=own_loss,
                cpu_first_step_param_err=first, cpu_param_err=third,
                cpu_f32_first_step_param_err=own_first,
                cpu_f32_param_err=own_third)


def _cgan_graphs_vs_eager(torch, tds, config, label):
    """GRAPH_STEPS fused steps through `run()`'s captured graph and as many
    eager `train_step`s from the same seed and plan (cuDNN deterministic):
    the same bits in every loss and in G's and D's parameters; the graphed
    run's launches and the arrival counters left at zero."""
    from dl4ds_tpu_torch.ops import fused_ops as fo
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    args = dict(config, epochs=1, steps_per_epoch=GRAPH_STEPS)
    graphed = tds.CGANTrainer(**args)
    _, calls, kernels = _traced_run(torch, tds, graphed)
    per_step, outside = _cgan_per_step(graphed)
    _check_launches(tds, graphed.runner, f'phase 16 ({label}, graphs)',
                    per_step, {'step': GRAPH_STEPS}, calls, kernels, outside)
    busy = [name for name, t in fo._COUNTERS.items()
            if int(t.count_nonzero()) != 0]
    if busy:
        fail(f'phase 16 ({label}): arrival counters {busy} not left at 0')
    eager = tds.CGANTrainer(**args)
    eager.setup_datagen()
    eager.setup_model()
    eager.setup_optimizer(GRAPH_STEPS)
    eager.train_net.train()
    plan = eager.ds_train.plan(torch.Generator().manual_seed(eager.seed),
                               GRAPH_STEPS)
    losses = torch.stack([eager.train_step(eager.ds_train(
        plan['idx'][c], offsets=(plan['ys'][c], plan['xs'][c])))
        for c in range(GRAPH_STEPS)])
    diffs = {'losses': _max_diff([losses], [graphed.train_losses]),
             'parameters': _max_diff(list(eager.train_net.parameters()),
                                     list(graphed.train_net.parameters()))}
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved
    print(f'phase 16, {label}: {GRAPH_STEPS} fused steps through run()\'s '
          f'graph against {GRAPH_STEPS} eager train_steps from the same '
          f'weights and plan: max|d| {diffs} (bit-identical required)',
          flush=True)
    if any(d != 0 for d in diffs.values()):
        fail(f'phase 16 ({label}): graphed and eager steps differ: {diffs}')
    return diffs


def _k3_layer_rows(torch, layers, label, seed=300, hw=TRAIN_LR,
                   batch=TRAIN_BATCH):
    """K2's training variant and K3 at a path's (Cin, F, k, x needs a
    gradient) layers at `batch`, T REC_T, hw x hw frames (LR
    patches by default), held against their plain versions
    (`_check_k3_case`, TF32 off) and timed against them and their bounds.
    Returns the rows, with phase 6's keys."""
    import dl4ds_tpu_torch.ops.convlstm as conv
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = []
    for i, (cin, f, k, need_dx) in enumerate(layers):
        wx, bx, wh = _layer_weights(torch, cin, f, k, k, seed + i, dev)
        x = torch.randn((batch, REC_T, hw, hw, cin), generator=gen,
                        device=dev)
        dys = torch.randn((batch, REC_T, hw, hw, f), generator=gen,
                          device=dev)
        what = f'{label} x{list(x.shape)} F={f} k={k}'
        fwd_err, errs, (ys, cs, zs) = _check_k3_case(
            torch, conv, x, wx, bx, wh, dys, need_dx, what)
        with torch.no_grad():
            k2_ms, k2_plain_ms = paired_ms(
                torch, lambda: conv._launch(x, wx, bx, wh, train=True),
                lambda: conv.convlstm_train_reference(x, wx, bx, wh), flush)
            k3_ms, k3_plain_ms = paired_ms(
                torch, lambda: conv._launch_backward(
                    x, wx, wh, zs, cs, ys, dys, need_dx),
                lambda: conv.convlstm_backward_reference(
                    x, wx, wh, zs, cs, ys, dys), flush)
        flops, n_bytes = k2_work(x, wx, wh)
        n_bytes += 4 * 5 * ys.numel()                # cs and zs written
        k3_flops, k3_bytes = k3_work(x, wx, wh, need_dx)
        rows.append(dict(
            x=list(x.shape), f=f, k=k, dx=need_dx,
            ys_cs_zs_err=fwd_err[:3], grad_rel_err=errs, k2_ms=k2_ms,
            k2_plain_ms=k2_plain_ms,
            k2_bound_ms=max(flops / F32_FLOPS, n_bytes / HBM_BYTES_PER_S)
            * 1e3,
            k3_ms=k3_ms, k3_plain_ms=k3_plain_ms,
            k3_bound_ms=max(k3_flops / F32_FLOPS, k3_bytes / HBM_BYTES_PER_S)
            * 1e3))
        print(f'K2-train/K3 {what}{"" if need_dx else " (no dx)"}: ys, cs, '
              f'zs max|d| ' + ' '.join(f'{e:.3e}' for e in fwd_err[:3])
              + '  grads max|d|/max|ref| '
              + ' '.join(f'{n} {v:.2e}' for n, v in errs.items())
              + f'  K2-train {k2_ms:.4f} ms (plain {k2_plain_ms:.4f}, bound '
              f'{rows[-1]["k2_bound_ms"]:.4f})  K3 {k3_ms:.4f} ms (plain '
              f'{k3_plain_ms:.4f}, bound {rows[-1]["k3_bound_ms"]:.4f}); '
              f'{card_line()}', flush=True)
    return rows


def _cgan_serving(torch, tds, tr, tr16, report):
    """`predict` of the trained generators on N_GRIDS LR grids of LRxLR into
    the x4 grid at batch BATCH (`_check_served`): `predict(trainer)` is the
    raw generator's output (the same bits as `predict((generator,
    gen_net))`), K1 its gates a batch, grid 0 against the CPU (phase 3's
    criteria), and the float32-trained weights in the bfloat16 model by the
    mean criterion, as phase 14 serves its trained weights; the bfloat16-
    trained weights served in float32 by phase 3's criteria, their
    bfloat16 serving distance recorded."""
    import numpy as np
    grids = np.random.default_rng(16).standard_normal(
        (N_GRIDS, LR, LR)).astype('float32')
    kwargs = dict(scale=SCALE, array_in_hr=False, batch_size=BATCH)
    want = {'K1': len(K1_SHAPES) * -(-N_GRIDS // BATCH), 'K2': 0}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    same = np.array_equal(tds.predict(tr, grids, **kwargs), tds.predict(
        (tr.generator, tr.gen_net), grids, **kwargs))
    torch.backends.cudnn.deterministic = False
    if not same:
        fail('phase 16: predict(trainer) is not the raw generator\'s output')
    bf16 = tds.net_postupsampling(
        'resnet', 'spc', scale=SCALE, n_channels=1, n_aux_channels=0,
        lr_size=(TRAIN_LR, TRAIN_LR), dtype=torch.bfloat16, **CGAN_G)
    serve = _check_served(torch, tds, 'CGAN generator predict, '
                          f'{N_GRIDS} LR grids {LR}x{LR} -> {LR * SCALE}',
                          tr.generator, tr.gen_net, grids, kwargs, want,
                          bf16=bf16, phase=16)
    f32 = tds.net_postupsampling('resnet', 'spc', scale=SCALE, n_channels=1,
                                 n_aux_channels=0, lr_size=(TRAIN_LR,
                                                            TRAIN_LR),
                                 **CGAN_G)
    net32 = f32.init(0, 'cuda')
    net32.load_state_dict(tr16.gen_net.state_dict())
    serve16 = _check_served(torch, tds, 'bfloat16-trained CGAN generator '
                            f'predict, {N_GRIDS} LR grids', f32, net32,
                            grids, kwargs, want, bf16=tr16.generator,
                            phase=16, hold=False)
    return dict(f32=serve, bf16=serve16)


def _cgan_checkpoints(torch, tds):
    """(c): (a)'s float32 pair with D's gates and an EMA, checkpointed
    every epoch under the git-ignored build/; `load_checkpoint` of 'final'
    gives the trained raw generator's `predict` output and D's weights;
    a trainer resumed from it runs on from its update count."""
    import shutil
    import numpy as np
    root = Path(__file__).resolve().parent / 'build' / 'phase16'
    shutil.rmtree(root, ignore_errors=True)
    config = _cgan_config()
    config['discriminator_params'] = dict(CGAN_D, attention=True)
    torch.backends.cudnn.allow_tf32 = False
    tr = tds.CGANTrainer(epochs=TRAIN_EPOCHS, steps_per_epoch=CGAN_CKPT_STEPS,
                         checkpoints_frequency=1, ema_decay=CGAN_EMA,
                         save_path=str(root) + '/', **config).run()
    saved = sorted(p.name for p in (root / 'checkpoints').iterdir())
    g, gnet, d, dnet = tds.load_checkpoint(
        str(root), None, 'resnet', 'spc', SCALE, (TRAIN_LR, TRAIN_LR),
        n_blocks=(N_BLOCKS, CGAN_D['n_res_blocks']),
        n_filters=(N_FILTERS, CGAN_D['n_filters']), attention=True)
    grids = np.random.default_rng(161).standard_normal(
        (BATCH, LR, LR)).astype('float32')
    kwargs = dict(scale=SCALE, array_in_hr=False, batch_size=BATCH)
    torch.backends.cudnn.deterministic = True
    same_g = np.array_equal(tds.predict((g, gnet), grids, **kwargs),
                            tds.predict(tr, grids, **kwargs))
    torch.backends.cudnn.deterministic = False
    same_d = all(torch.equal(a, b) for a, b in zip(
        dnet.state_dict().values(), tr.disc_net.state_dict().values()))
    resumed = tds.CGANTrainer(
        epochs=1, steps_per_epoch=CGAN_CKPT_STEPS, ema_decay=CGAN_EMA,
        resume_from_checkpoint=str(root / 'checkpoints' / 'final'),
        save_path=str(root / 'resumed') + '/', **config).run()
    print(f'phase 16 (c), checkpoints: {saved}; load_checkpoint(final) '
          f'predicts the trained generator\'s bits {same_g}, holds its D '
          f'{same_d}; resumed from final at update {tr.n_updates}, ran on to '
          f'{resumed.n_updates} with losses {resumed.gentotal} (G) '
          f'{resumed.disc} (D); {card_line()}', flush=True)
    if (saved != ['epoch-1', 'epoch-2', 'final'] or not same_g or not same_d
            or resumed.n_updates != tr.n_updates + CGAN_CKPT_STEPS
            or not np.isfinite(resumed.gentotal + resumed.disc).all()):
        fail(f'phase 16 (c): checkpoints {saved}, load_checkpoint G {same_g}'
             f' D {same_d}, resumed at {resumed.n_updates}')
    shutil.rmtree(root, ignore_errors=True)
    return dict(checkpoints=saved, load_checkpoint_same_bits=same_g,
                resumed_updates=resumed.n_updates)


def phase_cgan(torch, tds, report):
    """Phase 16: CGAN training, BASELINE config 5: (a) the bench's pair in
    float32 and bfloat16, against the CPU, replayed against eager, served;
    (b) the spatio-temporal pair; (c) checkpoints."""
    out = report['cgan'] = {}
    gates = report['k1_train_rows']      # phase 10's: G's gates
    k1 = {'K1 forward': sum(r['ms'] for r in gates),
          'K1 backward': sum(r['bwd_ms'] for r in gates)}
    label = (f'cgan resnet_spc x{SCALE} (n_filters {N_FILTERS}, n_blocks '
             f'{N_BLOCKS}, attention) + D (n_filters {CGAN_D["n_filters"]}, '
             f'{CGAN_D["n_res_blocks"]} blocks), mae')
    tr, out['f32'] = _drive_cgan(torch, tds, _cgan_config(), label,
                                 CGAN_STEPS, k1)
    if out['f32']['per_step']['train']['K1'] != len(K1_TRAIN_SHAPES):
        fail(f'phase 16: {out["f32"]["per_step"]["train"]} K1 launches a '
             f'step, not G\'s {len(K1_TRAIN_SHAPES)} gates')
    out['f32'].update(_cgan_vs_cpu(torch, tds, _cgan_config(), label,
                                   CGAN_CPU_BATCH))
    out['graphs_vs_eager'] = _cgan_graphs_vs_eager(torch, tds, _cgan_config(),
                                                   label)
    tr16, out['bf16'] = _drive_cgan(
        torch, tds, _cgan_config(dtype=torch.bfloat16), f'{label}, bfloat16',
        CGAN_STEPS, k1)
    out['serve'] = _cgan_serving(torch, tds, tr, tr16, report)
    del tr, tr16

    # (b) the spatio-temporal pair: D's gates and stem timed first
    out['d_gates'] = _k1_gate_rows(torch, tds, CGAN_D_GATES,
                                   'CGAN discriminator gate')
    out['d_stem'] = _k3_layer_rows(torch, CGAN_D_STEM, 'CGAN D stem')
    step = report['k3_step']
    rec_label = (f'cgan recresnet_spc x{SCALE} (n_filters {N_FILTERS}, T '
                 f'{REC_T}) + recurrent D (attention), mae')
    shares = {'K2-train': sum(r['k2_ms'] for r in step)
              + 2 * sum(r['k2_ms'] for r in out['d_stem']),
              'K3': sum(r['k3_ms'] for r in step)
              + 2 * sum(r['k3_ms'] for r in out['d_stem']),
              'K1 forward': 2 * sum(r['ms'] for r in out['d_gates']),
              'K1 backward': 2 * sum(r['bwd_ms'] for r in out['d_gates'])}
    rec, out['recurrent'] = _drive_cgan(
        torch, tds, _cgan_config(recurrent=True), rec_label, CGAN_REC_STEPS,
        shares)
    del rec
    out['recurrent'].update(_cgan_vs_cpu(
        torch, tds, _cgan_config(recurrent=True), rec_label,
        CGAN_REC_CPU_BATCH))
    out['checkpoints'] = _cgan_checkpoints(torch, tds)
    card = card_line()
    for key, what in (('f32', 'float32'), ('bf16', 'bfloat16'),
                      ('recurrent', 'spatio-temporal float32')):
        g = out[key]['graphed']
        print(f'phase 16 summary, {what}: replayed {g["patches_per_s"]:.1f} '
              f'patches/s, eager {out[key]["eager_patches_per_s"]:.1f} (host '
              f'clock); one replay {g["replay_ms"]:.3f} ms (CUDA events); '
              f'{g["launches_per_replay"]:.0f} launches a replay; device busy '
              f'{100 * g["busy_share"]:.1f}%; {card}', flush=True)
    serve = out['serve']
    print(f'phase 16 summary, predict: {serve["f32"]["grids_per_s"]:.2f}'
          f' grids/s (float32-trained), '
          f'{serve["bf16"]["grids_per_s"]:.2f} (bfloat16-trained, '
          f'served in float32); {card}', flush=True)


def _cgan_kernel_rows(report):
    """The `kernels` line's rows of phase 16: K1 in (a)'s training step
    (G's gates, phase 10's shapes and times; launches from (a)'s float32
    device trace) and serving (phase 2's shapes and times; launches of the
    float32-trained generator's predict), K1 in (b)'s discriminator (its
    gates timed in phase 16), and K2's training variant and K3 in (b)'s
    step (G's layers at phase 6's shapes and times, D's stem at phase 16's,
    counted twice: D runs on the real and the generated grids)."""
    cg = report['cgan']
    k1 = dict(route='cuda', source='dl4ds_tpu_torch/csrc/channel_attention.cu',
              replaces='dl4ds_tpu/ops/pallas_ops.py:39', bound_by='bytes',
              library_ms=None)

    def k1_row(name, rows, launches, work, times=1, **extra):
        row = dict(k1, name=name, launches=launches,
                   max_abs_err=max(r['max_abs_err'] for r in rows),
                   ms=times * sum(r['ms'] for r in rows),
                   plain_ms=times * sum(r['plain_ms'] for r in rows),
                   bound_ms=times * sum(r['bound_ms'] for r in rows),
                   work=work, **extra)
        if 'bwd_launches' in extra:
            row.update(bwd_ms=times * sum(r['bwd_ms'] for r in rows),
                       bwd_plain_ms=times * sum(r['bwd_plain_ms']
                                                for r in rows),
                       bwd_bound_ms=times * sum(r['bwd_bound_ms']
                                                for r in rows))
        return row
    gates = report['k1_train_rows']
    f32 = [r for r in report['k1_rows'] if r['dtype'] == 'float32']
    a, rec = cg['f32'], cg['recurrent']
    out = [
        k1_row('K1_channel_attention_cgan_train', gates, a['launches']['K1'],
               f'the {len(gates)} gates of G in one float32 CGAN step at '
               f'batch {TRAIN_BATCH} (phase 10\'s shapes and times), forward '
               f'and backward; launches from phase 16\'s device trace',
               wrapper_calls=a['wrapper_calls']['K1'],
               bwd_launches=a['launches']['K1 backward'],
               bf16_launches=cg['bf16']['launches']['K1']),
        k1_row('K1_channel_attention_cgan_serve', f32,
               cg['serve']['f32']['launches']['K1'],
               f'the {len(f32)} gates of one float32 generator forward at '
               f'batch {BATCH} (phase 2\'s shapes and times); launches of '
               f'predict on {N_GRIDS} grids'),
        k1_row('K1_channel_attention_cgan_disc_train', cg['d_gates'],
               rec['launches']['K1'],
               f'the {len(cg["d_gates"])} gates of the spatio-temporal D, '
               f'x{[r["shape"] for r in cg["d_gates"]]}, twice (D(fake), '
               f'D(real)) in one float32 step, forward and backward (the '
               f'backward a third time on D(fake)\'s way to G: launches '
               f'{rec["per_step"]["train"]["K1 backward"]} a step); '
               f'launches from phase 16\'s device trace', times=2,
               wrapper_calls=rec['wrapper_calls']['K1'],
               bwd_launches=rec['launches']['K1 backward'])]
    conv = dict(route='cuda', bound_by='operations', library_ms=None)
    step, stem = report['k3_step'], cg['d_stem']

    def total(key):
        return (sum(r[key] for r in step) + 2 * sum(r[key] for r in stem))
    out.append(dict(
        conv, name='K2_convlstm_train_cgan',
        source='dl4ds_tpu_torch/csrc/convlstm.cu',
        replaces='dl4ds_tpu/ops/pallas_convlstm.py:219',
        launches=rec['launches']['K2-train'],
        wrapper_calls=rec['wrapper_calls']['K2-train'],
        max_abs_err=max(max(r['ys_cs_zs_err'][:2]) for r in stem),
        ms=total('k2_ms'), plain_ms=total('k2_plain_ms'),
        bound_ms=total('k2_bound_ms'),
        work=f'the {len(step)} ConvLSTM layers of G (phase 6\'s shapes and '
             f'times) and twice the {len(stem)} of D\'s stem (phase 16\'s) '
             f'in one float32 spatio-temporal CGAN step; launches from '
             f'phase 16\'s device trace'))
    out.append(dict(
        conv, name='K3_convlstm_bptt_cgan',
        source='dl4ds_tpu_torch/csrc/convlstm_bwd.cu',
        replaces='dl4ds_tpu/ops/pallas_convlstm.py:335',
        launches=rec['launches']['K3'],
        wrapper_calls=rec['wrapper_calls']['K3'],
        max_abs_err=max(max(v for k, v in r['grad_rel_err'].items()
                            if k != 'plain_f32') for r in stem),
        ms=total('k3_ms'), plain_ms=total('k3_plain_ms'),
        bound_ms=total('k3_bound_ms'),
        work='the BPTT of the same layers (D\'s stem without dx at its LR '
             'input); launches from phase 16\'s device trace'))
    return out


# phase 17: the rest of the spatio-temporal zoo, and the streaming tier.
# (a) recresnet_pin x4: SupervisedTrainer('resnet', 'pin', scale=4,
# time_window=4, patch_size=64, batch_size=128, n_filters=8, n_blocks=6,
# loss='mae'), n_blocks 6 being recnet_pin's default
# (dl4ds_tpu/models/__init__.py:187), on phase 7's data (bench_suite.py:
# 111-121): its 14 ConvLSTM layers (a 5x5 and a 3x3 a block, the stem's
# input the one pre-upsampled channel) run on the 64x64 HR frames, 16
# times the pixels of recresnet_spc's LR frames; 2 epochs of PINREC_STEPS
# steps in float32 and bfloat16, 3 steps at PINREC_CPU_BATCH against the
# CPU in float64, `predict(time_window=4)` of 19 HR grids of 128x128
PINREC_BLOCKS, PINREC_STEPS, PINREC_CPU_BATCH = 6, 10, 8
PINREC_LAYERS = [layer for cin in [1] + [N_FILTERS] * PINREC_BLOCKS
                 for layer in ((cin, N_FILTERS, 5), (N_FILTERS, N_FILTERS, 3))]
# (b) bench_suite.py's recresnet_spc_4x_tw4 (bench_suite.py:224-226) with
# the convnet and the densenet merge: phase 7's layers, 2 epochs of
# MERGE_STEPS steps, 3 steps at batch 16 against the CPU, predict
MERGE_STEPS = 10
# (c) the streaming tier at STREAM.json's size: the flagship (resnet_spc
# x4, attention, n_filters 8, n_blocks 6, mae) on 1024 grids of 128x128
# (67 MB), 64x64 patches at batch 128, from host RAM and from a memmapped
# .npy file, beside the in-device tier; then CGAN (a) and configuration (a)
# streamed for one epoch of STREAM_SHORT steps each
STREAM_GRIDS, STREAM_VAL, STREAM_EPOCHS, STREAM_SHORT = 1024, 256, 3, 4
STREAM_HOST_REPS = 20


def _pinrec_config(**extra):
    """SupervisedTrainer arguments of phase 17 (a)."""
    return _training_config(backbone='resnet', upsampling='pin', loss='mae',
                            time_window=REC_T, n_blocks=PINREC_BLOCKS,
                            n_filters=N_FILTERS, **extra)


def _layer_totals(rows, layers, key):
    """The sum of `key` over a step's (Cin, F, k) `layers`, each timed in
    `rows` (phase 6's keys) at its shape."""
    by_shape = {(r['x'][-1], r['f'], r['k']): r for r in rows}
    return sum(by_shape[layer][key] for layer in layers)


def _k2_serve_rows(torch, tds, layers, hw, label, seed=170):
    """K2 (inference) at serving shapes [BATCH, REC_T, hw, hw, Cin] of the
    (Cin, F, k) `layers`, held against its plain version with TF32 off
    (K2_TOL) and timed against it and its bound, as phase 4 does."""
    from dl4ds_tpu_torch.models.blocks import ConvLSTM2D
    fcl, ref = tds.fused_convlstm, tds.convlstm_reference
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = []
    for i, (cin, f, k) in enumerate(dict.fromkeys(layers)):
        layer = ConvLSTM2D(cin, f, (k, k))
        layer.reset_parameters(torch.Generator().manual_seed(seed + i))
        wx, bx, wh = (p.detach().to(dev) for p in (
            layer.input_conv.kernel, layer.input_conv.bias,
            layer.cell.recurrent_conv.kernel))
        x = torch.randn((BATCH, REC_T, hw, hw, cin), generator=gen,
                        device=dev)
        with torch.no_grad():
            err = (fcl(x, wx, bx, wh) - ref(x, wx, bx, wh)[0]).abs().max()
            err = err.item()
            ms, plain_ms = paired_ms(torch, lambda: fcl(x, wx, bx, wh),
                                     lambda: ref(x, wx, bx, wh), flush)
        if not err <= K2_TOL:
            fail(f'K2 {label} x{list(x.shape)} F={f} k={k}: max|d| '
                 f'{err:.3e}')
        flops, n_bytes = k2_work(x, wx, wh)
        rows.append(dict(x=list(x.shape), f=f, k=k, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=max(
                             flops / F32_FLOPS, n_bytes / HBM_BYTES_PER_S)
                         * 1e3))
        print(f'K2 {label} x{list(x.shape)} F={f} k={k}  max|d| {err:.3e}  '
              f'kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound '
              f'{rows[-1]["bound_ms"]:.4f} ms; {card_line()}', flush=True)
    return rows


def _pinrec(torch, tds, report):
    """(a): recresnet_pin trained and served."""
    import numpy as np
    import dl4ds_tpu_torch.ops.convlstm as conv
    out = report['pinrec'] = {}
    hw = TRAIN_PATCH
    out['routes'] = _print_routes(conv, PINREC_LAYERS, hw)
    out['routes_bf16'] = _print_routes(conv, PINREC_LAYERS, hw, itemsize=2)
    rows = out['layers'] = _k3_layer_rows(
        torch, [(cin, f, k, cin != 1)
                for cin, f, k in dict.fromkeys(PINREC_LAYERS)],
        'recresnet_pin HR layer', seed=170, hw=hw)
    shares = {name: _layer_totals(rows, PINREC_LAYERS, key)
              for name, key in (('K2-train', 'k2_ms'), ('K3', 'k3_ms'))}
    per_step = _recurrent_per_step(conv, PINREC_LAYERS, hw=hw)
    label = (f'recresnet_pin x{SCALE} (n_filters {N_FILTERS}, '
             f'{PINREC_BLOCKS} blocks, T {REC_T}, {hw}x{hw} HR frames), mae')
    torch.cuda.reset_peak_memory_stats()
    got, calls, numbers = _drive_training(
        torch, tds, _pinrec_config(), label, PINREC_STEPS, per_step,
        PINREC_CPU_BATCH, shares, keep_model=True)
    model, net = numbers.pop('model')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'phase 17 (a): peak device memory {peak:.2f} GiB over the run, '
          f'its replays and the eager steps; {card_line()}', flush=True)
    per16 = _recurrent_per_step(conv, PINREC_LAYERS, itemsize=2, hw=hw)
    bf16 = _bf16_training(torch, tds, _pinrec_config(dtype=torch.bfloat16),
                          f'{label}, bfloat16', PINREC_STEPS, per16,
                          phase=17)
    grids = np.random.default_rng(17).standard_normal(
        (REC_GRIDS, LR, LR)).astype('float32')
    n_windows = REC_GRIDS - REC_T + 1
    want = {'K1': 0, 'K2': len(PINREC_LAYERS) * REC_T
            * -(-n_windows // BATCH)}
    model16 = tds.recnet_pin('resnet', 1, 0, model.input_shape[1:3], REC_T,
                             n_filters=N_FILTERS, n_blocks=PINREC_BLOCKS,
                             dtype=torch.bfloat16)
    out['serve'] = _check_served(
        torch, tds, f'recresnet_pin predict(time_window={REC_T}), '
        f'{REC_GRIDS} HR grids {LR}x{LR}', model, net, grids,
        dict(scale=SCALE, time_window=REC_T, batch_size=BATCH,
             array_in_hr=True), want, cpu_slice=slice(0, REC_T),
        bf16=model16, phase=17)
    out['serve_layers'] = _k2_serve_rows(
        torch, tds, PINREC_LAYERS, LR, 'phase 17: recresnet_pin serving layer')
    out.update(launches=got, wrapper_calls=calls, peak_gib=peak, bf16=bf16,
               **numbers)


def _merges(torch, tds, report):
    """(b): the convnet and densenet recurrent merges trained and served."""
    import numpy as np
    import dl4ds_tpu_torch.ops.convlstm as conv
    out = report['merges'] = {}
    step = report['k3_step']      # phase 6's rows, at these layer shapes
    shares = {'K2-train': sum(r['k2_ms'] for r in step),
              'K3': sum(r['k3_ms'] for r in step)}
    per_step = _recurrent_per_step(conv, K3_LAYERS)
    grids = np.random.default_rng(171).standard_normal(
        (REC_GRIDS, LR, LR)).astype('float32')
    n_windows = REC_GRIDS - REC_T + 1
    for backbone in ('convnet', 'densenet'):
        config = _training_config(backbone=backbone, loss='mae',
                                  time_window=REC_T, n_blocks=REC_BLOCKS,
                                  n_filters=N_FILTERS)
        label = (f'rec{backbone}_spc x{SCALE} (n_filters {N_FILTERS}, '
                 f'{REC_BLOCKS} blocks, T {REC_T}), mae')
        got, calls, numbers = _drive_training(
            torch, tds, config, label, MERGE_STEPS, per_step, 16, shares,
            keep_model=True)
        model, net = numbers.pop('model')
        serve = _check_served(
            torch, tds, f'rec{backbone}_spc predict(time_window={REC_T}), '
            f'{REC_GRIDS} LR grids {LR}x{LR} -> {LR * SCALE}', model, net,
            grids, dict(scale=SCALE, time_window=REC_T, batch_size=BATCH,
                        array_in_hr=False),
            {'K1': 0, 'K2': len(K3_LAYERS) * REC_T * -(-n_windows // BATCH)},
            cpu_slice=slice(0, REC_T), phase=17)
        out[backbone] = dict(launches=got, wrapper_calls=calls, serve=serve,
                             **numbers)


def _stream_config(data, **extra):
    """SupervisedTrainer arguments of phase 17 (c) on `data`."""
    return dict(backbone='resnet', upsampling='spc', data_train=data,
                data_val=data[:STREAM_VAL], data_test=data[:STREAM_VAL],
                scale=SCALE, patch_size=TRAIN_PATCH, batch_size=TRAIN_BATCH,
                loss='mae', n_filters=N_FILTERS, n_blocks=N_BLOCKS,
                attention=True, verbose=False, **extra)


def _stream_batches_equal(torch, tds, data):
    """Three batches streamed through the pinned slots and the side
    stream equal `BatchSynthesizer.build` at the indices and offsets the
    streamer drew (its permutation, then each batch's ys and xs)."""
    st = tds.HostStreamer(data, 'spc', SCALE, TRAIN_BATCH,
                          patch_size=TRAIN_PATCH, seed=11)
    synth = tds.BatchSynthesizer(data, None, 'spc', SCALE, TRAIN_BATCH,
                                 patch_size=TRAIN_PATCH)
    probe = copy.deepcopy(st.rng)
    perm = probe.permutation(st.n)
    plr, b = TRAIN_PATCH // SCALE, TRAIN_BATCH
    same = []
    for i, raw in enumerate(st.stream(1, 3)):
        idx = perm[i * b:(i + 1) * b]
        ys = probe.integers(0, max(st.lr_y - plr, 1), size=b)
        xs = probe.integers(0, max(st.lr_x - plr, 1), size=b)
        want = synth.build(*(torch.as_tensor(a, device='cuda')
                             for a in (idx, ys, xs)))
        got = st.build(**raw)
        same.append(all(torch.equal(got[k], want[k]) for k in ('lr', 'hr'))
                    and got['aux'] is None and want['aux'] is None)
    print(f'phase 17 (c): 3 streamed batches (native gather/crop into pinned '
          f'slots, side-stream copies) equal BatchSynthesizer.build at the '
          f'streamer\'s indices and offsets: {same}', flush=True)
    if not all(same):
        fail(f'phase 17 (c): streamed batches differ from the device '
             f'tier\'s: {same}')
    return st, perm


def _host_times(torch, st, perm, label):
    """Host ms of a batch's gather + crop into a pinned slot, and of its
    copy to the card (CUDA events), each the median of STREAM_HOST_REPS."""
    slot = st._ring()[0]
    arrays = {k: v.numpy() for k, v in slot.items()}
    idx = perm[:TRAIN_BATCH]
    gather = []
    for _ in range(STREAM_HOST_REPS):
        t0 = time.perf_counter()
        st._host_batch(idx, arrays)
        gather.append((time.perf_counter() - t0) * 1e3)
    copy_ms = statistics.median(device_times(
        torch, lambda: [v.to('cuda', non_blocking=True)
                        for v in slot.values()], reps=STREAM_HOST_REPS))
    n_bytes = sum(v.numel() * v.element_size() for v in slot.values())
    out = dict(gather_crop_ms=statistics.median(gather), h2d_ms=copy_ms,
               batch_bytes=n_bytes)
    print(f'phase 17 (c), {label}: a batch of {n_bytes / 2 ** 20:.2f} MiB: '
          f'gather + crop {out["gather_crop_ms"]:.3f} ms (host clock, '
          f'{n_bytes / out["gather_crop_ms"] / 1e6:.2f} GB/s), copy to the '
          f'card {copy_ms:.3f} ms (CUDA events, '
          f'{n_bytes / copy_ms / 1e6:.2f} GB/s); {card_line()}', flush=True)
    return out


def _tier_speed(torch, tr, streaming):
    """patches/s of STREAM_EPOCHS epochs of a run trainer's replayed steps
    (host clock, the streaming or the plan upload included); the device's
    busy share of that time, one replay's CUDA-event time a step
    (`clock_busy_share`), and of one epoch under torch.profiler
    (`busy_share`, which the profiler's host overhead lowers where the
    host feeds the steps)."""
    steps = tr._steps()
    gen = torch.Generator().manual_seed(5)
    if streaming:
        def epoch():
            tr.runner.train_stream(tr.ds_train, steps)
    else:
        def epoch():
            tr.runner.train(tr.ds_train.plan(gen, steps))
    epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STREAM_EPOCHS):
        epoch()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    rate = STREAM_EPOCHS * steps * TRAIN_BATCH / wall_s
    graph = tr.runner.graphs['step']

    def replay():
        tr._row.zero_()
        graph.replay()
    replay_ms = statistics.median(device_times(torch, replay, reps=10))
    _, busy_ms, span_ms = _replay_profile(torch, tr.runner, None, run=epoch)
    return dict(patches_per_s=rate, replay_ms=replay_ms,
                clock_busy_share=replay_ms * STREAM_EPOCHS * steps
                / (wall_s * 1e3),
                busy_share=busy_ms / span_ms,
                busy_ms_per_step=busy_ms / steps,
                span_ms_per_step=span_ms / steps)


def _stream(torch, tds, report):
    """(c): the streaming tier against the in-device tier."""
    import shutil
    import numpy as np
    from dl4ds_tpu_torch import native
    from dl4ds_tpu_torch.ops import fused_ops as fo
    out = report['stream'] = {}
    if not native.available():
        fail('phase 17 (c): the native host gather/crop did not build')
    print(f'phase 17 (c): native host library {native.lib_path()}',
          flush=True)
    data = np.random.default_rng(0).standard_normal(
        (STREAM_GRIDS, TRAIN_HR, TRAIN_HR, 1)).astype('float32')
    st, perm = _stream_batches_equal(torch, tds, data)
    out['host'] = _host_times(torch, st, perm, 'host RAM')
    root = Path(__file__).resolve().parent / 'build' / 'phase17'
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    np.save(root / 'stream.npy', data)
    mm = np.load(root / 'stream.npy', mmap_mode='r')
    mst = tds.HostStreamer(mm, 'spc', SCALE, TRAIN_BATCH,
                           patch_size=TRAIN_PATCH, seed=11)
    if not np.shares_memory(mst.array, mm):
        fail('phase 17 (c): the memmapped dataset was copied into RAM')
    out['memmap_host'] = _host_times(torch, mst, perm, 'memmap')
    del st, mst

    # the three tiers, each trained through run() and then timed
    torch.backends.cudnn.allow_tf32 = True
    tiers = {}
    for tier, train, hbm in (('in-device', data, True),
                             ('host RAM', data, False),
                             ('memmap', mm, False)):
        tr = tds.SupervisedTrainer(
            epochs=TRAIN_EPOCHS, validation_steps=1, test_steps=1,
            data_in_hbm=hbm, **_stream_config(train))
        t0 = time.perf_counter()
        tr.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        losses = tr.fithist['loss'] + tr.fithist['val_loss'] + [tr.test_loss]
        if not np.isfinite(losses).all():
            fail(f'phase 17 (c), {tier}: non-finite losses {losses}')
        if tier == 'memmap' and not np.shares_memory(tr.ds_train.array, mm):
            fail('phase 17 (c): the trainer copied the memmap into RAM')
        tiers[tier] = dict(run_s=run_s, losses=losses,
                           **_tier_speed(torch, tr, not hbm))
        print(f'phase 17 (c), {tier}: run() of {TRAIN_EPOCHS} epochs of '
              f'{tr._steps()} steps with validation and test in {run_s:.2f} '
              f's, losses {losses}; replayed '
              f'{tiers[tier]["patches_per_s"]:.1f} patches/s over '
              f'{STREAM_EPOCHS} epochs (host clock); one replay '
              f'{tiers[tier]["replay_ms"]:.3f} ms (CUDA events), so the '
              f'device busy {100 * tiers[tier]["clock_busy_share"]:.1f}% of '
              f'the epochs\' time; under torch.profiler busy '
              f'{100 * tiers[tier]["busy_share"]:.1f}% of an epoch '
              f'({tiers[tier]["busy_ms_per_step"]:.3f} of '
              f'{tiers[tier]["span_ms_per_step"]:.3f} ms a step); '
              f'{card_line()}', flush=True)
        del tr
    out['tiers'] = tiers

    # 8 replayed streaming steps against 8 eager ones, bit for bit
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    args = dict(epochs=1, steps_per_epoch=GRAPH_STEPS, validation_steps=1,
                test_steps=1, data_in_hbm=False, **_stream_config(data))
    graphed = tds.SupervisedTrainer(**args)
    _, calls, kernels = _traced_run(torch, tds, graphed)
    per_step = _flagship_per_step(len(K1_TRAIN_SHAPES), ssim=False)
    out['launches'] = _check_launches(
        tds, graphed.runner, 'phase 17 (c), streamed flagship', per_step,
        {'step': GRAPH_STEPS, 'val': 1, 'test': 1}, calls, kernels)
    out['wrapper_calls'] = calls
    busy = [name for name, t in fo._COUNTERS.items()
            if int(t.count_nonzero()) != 0]
    if busy:
        fail(f'phase 17 (c): arrival counters {busy} not left at 0')
    eager = tds.SupervisedTrainer(**args)
    eager.setup_datagen()
    eager.setup_model()
    eager.setup_optimizer()
    eager.train_net.train()
    losses = torch.stack([eager.train_step(eager.ds_train.build(**raw))
                          for raw in eager.ds_train.stream(1, GRAPH_STEPS)])
    diffs = {'losses': _max_diff([losses], [graphed.train_losses]),
             'parameters': _max_diff(list(eager.train_net.parameters()),
                                     list(graphed.train_net.parameters()))}
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved
    print(f'phase 17 (c): {GRAPH_STEPS} streamed steps replayed through '
          f'run()\'s graph against {GRAPH_STEPS} eager train_steps on the '
          f'same streamed batches: max|d| {diffs} (bit-identical required)',
          flush=True)
    if any(d != 0 for d in diffs.values()):
        fail(f'phase 17 (c): streamed replays and eager steps differ: '
             f'{diffs}')
    out['graphs_vs_eager'] = diffs
    del graphed, eager, mm
    shutil.rmtree(root, ignore_errors=True)

    # CGAN (a) and configuration (a), streamed for one short epoch each
    cg = tds.CGANTrainer(epochs=1, steps_per_epoch=STREAM_SHORT,
                         data_in_hbm=False, **_cgan_config())
    run_s, calls, kernels = _traced_run(torch, tds, cg)
    cg_step, outside = _cgan_per_step(cg)
    cg_launches = _check_launches(
        tds, cg.runner, 'phase 17 (c), streamed CGAN (a)', cg_step,
        {'step': STREAM_SHORT}, calls, kernels, outside)
    if not np.isfinite(cg.gentotal + cg.disc + [cg.test_loss]).all():
        fail(f'phase 17 (c): streamed CGAN losses {cg.gentotal} {cg.disc}')
    out['cgan'] = dict(run_s=run_s, launches=cg_launches,
                       losses=[cg.gentotal, cg.disc], test_loss=cg.test_loss)
    del cg
    import dl4ds_tpu_torch.ops.convlstm as conv
    # the streaming tier draws whole batches: val and test of 160 grids
    # (156 windows of 4)
    config = _pinrec_config()
    config.update(data_val=config['data_train'][:160],
                  data_test=config['data_train'][:160])
    pr = tds.SupervisedTrainer(
        epochs=1, steps_per_epoch=STREAM_SHORT, validation_steps=1,
        test_steps=1, batch_size=TRAIN_BATCH, data_in_hbm=False, **config)
    pr_s, calls, kernels = _traced_run(torch, tds, pr)
    pr_launches = _check_launches(
        tds, pr.runner, 'phase 17 (c), streamed recresnet_pin',
        _recurrent_per_step(conv, PINREC_LAYERS, hw=TRAIN_PATCH),
        {'step': STREAM_SHORT, 'val': 1, 'test': 1}, calls, kernels)
    pr_losses = pr.fithist['loss'] + pr.fithist['val_loss'] + [pr.test_loss]
    if not np.isfinite(pr_losses).all():
        fail(f'phase 17 (c): streamed recresnet_pin losses {pr_losses}')
    out['pinrec'] = dict(run_s=pr_s, launches=pr_launches, losses=pr_losses)
    print(f'phase 17 (c): streamed for one epoch of {STREAM_SHORT} steps '
          f'(run(), captures and traces included): CGAN (a) in {run_s:.2f} '
          f's, losses {out["cgan"]["losses"]}; recresnet_pin in {pr_s:.2f} '
          f's, losses {pr_losses}; {card_line()}', flush=True)


def phase_zoo_stream(torch, tds, report):
    """Phase 17: (a) recresnet_pin, (b) the recurrent convnet and densenet
    merges, (c) the streaming tier."""
    t0 = time.perf_counter()
    _pinrec(torch, tds, report)
    t1 = time.perf_counter()
    _merges(torch, tds, report)
    t2 = time.perf_counter()
    _stream(torch, tds, report)
    t3 = time.perf_counter()
    report['zoo_stream_seconds'] = dict(a=t1 - t0, b=t2 - t1, c=t3 - t2)
    a, tiers = report['pinrec'], report['stream']['tiers']
    card = card_line()
    print(f'phase 17 summary (a): recresnet_pin replayed '
          f'{a["graphed"]["patches_per_s"]:.1f} patches/s, one replay '
          f'{a["graphed"]["replay_ms"]:.3f} ms, device busy '
          f'{100 * a["graphed"]["busy_share"]:.1f}%; bfloat16 '
          f'{a["bf16"]["graphed"]["patches_per_s"]:.1f} patches/s; predict '
          f'{a["serve"]["grids_per_s"]:.2f} grids/s; peak '
          f'{a["peak_gib"]:.2f} GiB; {card}', flush=True)
    for backbone, m in report['merges'].items():
        print(f'phase 17 summary (b): rec{backbone}_spc replayed '
              f'{m["graphed"]["patches_per_s"]:.1f} patches/s, one replay '
              f'{m["graphed"]["replay_ms"]:.3f} ms; predict '
              f'{m["serve"]["grids_per_s"]:.2f} grids/s; {card}', flush=True)
    print('phase 17 summary (c): ' + '; '.join(
        f'{tier} {t["patches_per_s"]:.1f} patches/s (busy '
        f'{100 * t["clock_busy_share"]:.1f}%, under the profiler '
        f'{100 * t["busy_share"]:.1f}%)' for tier, t in tiers.items())
        + f'; seconds (a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, (c) '
        f'{t3 - t2:.1f}; {card}', flush=True)


def _zoo_stream_kernel_rows(report):
    """The `kernels` line's rows of phase 17: K2's training variant and K3
    at (a)'s HR layers (launches from (a)'s float32 device trace), K2 at
    (a)'s serving layers (launches of its predict), K2-train and K3 in
    (b)'s steps (phase 6's shapes and times; launches from each merge's
    trace), and K1 in the streamed flagship step (phase 10's shapes and
    times; launches from (c)'s graphed trace)."""
    a, rows = report['pinrec'], report['pinrec']['layers']
    conv = dict(route='cuda', bound_by='operations', library_ms=None)
    k2 = dict(conv, source='dl4ds_tpu_torch/csrc/convlstm.cu',
              replaces='dl4ds_tpu/ops/pallas_convlstm.py:219')
    k3 = dict(conv, source='dl4ds_tpu_torch/csrc/convlstm_bwd.cu',
              replaces='dl4ds_tpu/ops/pallas_convlstm.py:335')

    def totals(rows, layers, prefix):
        return {name: _layer_totals(rows, layers, f'{prefix}_{key}')
                for name, key in (('ms', 'ms'), ('plain_ms', 'plain_ms'),
                                  ('bound_ms', 'bound_ms'))}
    hr_work = (f'the {len(PINREC_LAYERS)} ConvLSTM layers of one float32 '
               f'recresnet_pin step at batch {TRAIN_BATCH}, T {REC_T}, '
               f'{TRAIN_PATCH}x{TRAIN_PATCH} HR frames, summed from the '
               f'{len(rows)} layer shapes timed in phase 17')
    out = [
        dict(k2, name='K2_convlstm_train_recnet_pin',
             launches=a['launches']['K2-train'],
             wrapper_calls=a['wrapper_calls']['K2-train'],
             bf16_launches=a['bf16']['launches']['K2-train'],
             max_abs_err=max(max(r['ys_cs_zs_err'][:2]) for r in rows),
             work=hr_work + '; launches from phase 17 (a)\'s device trace',
             **totals(rows, PINREC_LAYERS, 'k2')),
        dict(k3, name='K3_convlstm_bptt_recnet_pin',
             launches=a['launches']['K3'],
             wrapper_calls=a['wrapper_calls']['K3'],
             bf16_launches=a['bf16']['launches']['K3'],
             k4_launches=a['launches']['K4'],
             max_abs_err=max(max(v for k, v in r['grad_rel_err'].items()
                                 if k != 'plain_f32') for r in rows),
             work='the BPTT of the same layers (the stem without dx); '
                  'launches from phase 17 (a)\'s device trace',
             **totals(rows, PINREC_LAYERS, 'k3'))]
    serve = a['serve_layers']
    out.append(dict(
        k2, name='K2_convlstm_recnet_pin_serve',
        launches=a['serve']['launches']['K2'],
        max_abs_err=max(r['max_abs_err'] for r in serve),
        ms=_layer_totals(serve, PINREC_LAYERS, 'ms'),
        plain_ms=_layer_totals(serve, PINREC_LAYERS, 'plain_ms'),
        bound_ms=_layer_totals(serve, PINREC_LAYERS, 'bound_ms'),
        work=f'the {len(PINREC_LAYERS)} ConvLSTM layers of one recresnet_pin '
             f'forward at batch {BATCH}, T {REC_T}, {LR}x{LR}; launches of '
             f'predict on {REC_GRIDS} grids'))
    step = report['k3_step']
    for backbone, m in report['merges'].items():
        for base, key, kind in ((k2, 'K2-train', 'k2'), (k3, 'K3', 'k3')):
            name = ('K2_convlstm_train' if kind == 'k2'
                    else 'K3_convlstm_bptt')
            out.append(dict(
                base, name=f'{name}_rec{backbone}',
                launches=m['launches'][key],
                wrapper_calls=m['wrapper_calls'][key],
                max_abs_err=max(
                    max(r['ys_cs_zs_err'][:2]) if kind == 'k2' else
                    max(v for k, v in r['grad_rel_err'].items()
                        if k != 'plain_f32') for r in step),
                ms=sum(r[f'{kind}_ms'] for r in step),
                plain_ms=sum(r[f'{kind}_plain_ms'] for r in step),
                bound_ms=sum(r[f'{kind}_bound_ms'] for r in step),
                work=f'the {len(step)} ConvLSTM layers of one float32 '
                     f'rec{backbone}_spc step (phase 6\'s shapes and times); '
                     f'launches from phase 17 (b)\'s device trace'))
    gates = report['k1_train_rows']
    st = report['stream']
    out.append(dict(
        route='cuda', name='K1_channel_attention_stream_train',
        source='dl4ds_tpu_torch/csrc/channel_attention.cu',
        replaces='dl4ds_tpu/ops/pallas_ops.py:39', bound_by='bytes',
        library_ms=None, launches=st['launches']['K1'],
        wrapper_calls=st['wrapper_calls']['K1'],
        bwd_launches=st['launches']['K1 backward'],
        max_abs_err=max(r['max_abs_err'] for r in gates),
        ms=sum(r['ms'] for r in gates),
        plain_ms=sum(r['plain_ms'] for r in gates),
        bound_ms=sum(r['bound_ms'] for r in gates),
        bwd_ms=sum(r['bwd_ms'] for r in gates),
        bwd_plain_ms=sum(r['bwd_plain_ms'] for r in gates),
        bwd_bound_ms=sum(r['bwd_bound_ms'] for r in gates),
        work=f'the {len(gates)} gates of one streamed float32 flagship step '
             f'(phase 10\'s shapes and times), forward and backward; '
             f'launches from phase 17 (c)\'s graphed trace of '
             f'{GRAPH_STEPS} streamed steps'))
    return out


# phase 18: one-card parallelism. Tiled serving on the 0.25-degree global
# ERA5 grid (721 x 1440 LR, x4 to 2884 x 5760; HR grids coarsened on the
# card): the flagship in 192x192 windows (tile 128, halo 32), 72 a grid, the
# clipped border windows included; recresnet_spc (T 4) with halo 64, which
# covers its receptive field (`parallel.receptive_field_radius`). Then a
# 4-member ensemble of the flagship on phase 10's data, 3 steps (batch
# ENS_CPU_BATCH) against the port's CPU ensemble step in float64 at phase
# 7's tolerances, and K1's member mode alone at the step's and the serving
# gate's shapes.
TILED_GRID = (721, 1440)
TILED_GRIDS, TILED_REC_GRIDS = 2, 5
TILE, TILE_HALO, REC_TILE_HALO = 128, 32, 64
TILE_WINDOW = TILE + 2 * TILE_HALO
REC_TILE_WINDOW = TILE + 2 * REC_TILE_HALO
# the K1 gates of a tiled flagship dispatch: phase 2's on a window batch
TILED_GATES = [(BATCH, TILE_WINDOW * (hh // LR), TILE_WINDOW * (ww // LR), c)
               for hh, ww, c in K1_SHAPES]
# K2's layers in recresnet_spc with one input channel (the stem takes the
# grid alone)
TILED_K2_LAYERS = K3_LAYERS
ENS_M, ENS_STEPS, ENS_CPU_BATCH, ENS_SPEED_STEPS = 4, 3, FLAG_CPU_BATCH, 10
# K1's member mode alone: the ensemble step's first gate and the serving
# forward's first gate, M members of TRAIN_BATCH and N_GRIDS samples
MEMBER_SHAPES = [(ENS_M * TRAIN_BATCH, TRAIN_LR, TRAIN_LR, N_FILTERS),
                 (ENS_M * N_GRIDS, LR, LR, N_FILTERS)]


def _tiled_gate_rows(torch, tds):
    """K1's forward at the gates of a tiled flagship dispatch (stream
    regime), against its plain version and timed; serving runs no
    backward."""
    fca, ref = tds.fused_channel_attention, tds.channel_attention_reference
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(18)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = []
    for shape in TILED_GATES:
        c = shape[-1]
        cr = max(int(c / 4), 1)
        x, weights, _ = _gate_case(torch, gen, dev, shape, cr, torch.float32)
        err = (fca(x, *weights) - ref(x, *weights)).abs().max().item()
        if not err <= K1_TOL['float32']['atol']:
            fail(f'K1 tiled window gate x{list(shape)}: max|d| {err:.3e}')
        ms, plain_ms = paired_ms(torch, lambda: fca(x, *weights),
                                 lambda: ref(x, *weights), flush)
        n_bytes = 2 * x.numel() * 4 + 4 * (2 * c * cr + c + cr)
        n_ops = 2 * x.numel() + 4 * shape[0] * c * cr
        rows.append(dict(shape=list(shape), cr=cr, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=max(
                             n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS)
                         * 1e3))
        print(f'K1 tiled window gate x{list(shape)} cr={cr}  max|d| '
              f'{err:.3e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  '
              f'bound {rows[-1]["bound_ms"]:.4f} ms (bytes); {card_line()}',
              flush=True)
    return rows


def _compare(got, want, label, tol=PREDICT_TOL):
    import numpy as np
    diff = np.abs(got - want)
    err = float(diff.max())
    print(f'{label}: max|d| {err:.3e}, max|y| {float(np.abs(want).max()):.3e}'
          f' (atol {tol["atol"]}, rtol {tol["rtol"]})', flush=True)
    if not bool((diff <= tol['atol'] + tol['rtol'] * np.abs(want)).all()):
        fail(f'{label}: max|d| {err:.3e}')
    return err


def _tiled_flagship(torch, tds, report):
    """(a): the flagship served tiled on 2 global grids; its gated model
    against the same tiled call on the CPU, its attention-free twin tiled
    against untiled on the card."""
    import numpy as np
    fca = tds.fused_channel_attention
    h, w = TILED_GRID
    hr = np.random.default_rng(18).standard_normal(
        (TILED_GRIDS, h * SCALE, w * SCALE)).astype('float32')
    kwargs = dict(scale=SCALE, array_in_hr=True, tile=TILE, halo=TILE_HALO,
                  batch_size=BATCH)

    def build(**kw):
        return tds.net_postupsampling(
            'resnet', 'spc', scale=SCALE, n_channels=1, n_aux_channels=0,
            lr_size=TILED_GRID, n_filters=N_FILTERS, n_blocks=N_BLOCKS, **kw)
    model = build(attention=True)
    net = model.init(seed=0, device='cuda')
    n_win = TILED_GRIDS * (-(-h // TILE)) * (-(-w // TILE))
    dispatches = -(-n_win // BATCH)
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    fca.launches = fca.bwd_launches = 0
    y = tds.predict((model, net), hr, **kwargs)
    launches, bwd = fca.launches, fca.bwd_launches
    expected = len(K1_SHAPES) * dispatches
    print(f'tiled predict: {TILED_GRIDS} grids {h}x{w} -> {y.shape}, '
          f'{n_win} windows of {TILE_WINDOW}x{TILE_WINDOW} in {dispatches} '
          f'dispatches of {BATCH}; K1 launches {launches} (expected '
          f'{expected}), backward {bwd} (expected 0)', flush=True)
    if y.shape != (TILED_GRIDS, h * SCALE, w * SCALE, 1):
        fail(f'tiled predict output shape {y.shape}')
    if not np.isfinite(y).all():
        fail('tiled predict output is not finite')
    if launches != expected or bwd != 0:
        fail(f'tiled predict launched K1 {launches} and its backward {bwd} '
             f'times, expected {expected} and 0')
    t0 = time.perf_counter()
    tds.predict((model, net), hr, **kwargs)
    predict_s = time.perf_counter() - t0
    win = torch.randn((BATCH, TILE_WINDOW, TILE_WINDOW, 1), device='cuda')
    with torch.inference_mode():
        fwd_ms = statistics.median(device_times(torch, lambda: net(win),
                                                reps=10))
    print(f'tiled predict of {TILED_GRIDS} global grids (TF32 convs, the '
          f'default): {TILED_GRIDS / predict_s:.4f} grids/s end to end (host '
          f'clock, data assembly, window gather and copy out included); a '
          f'window dispatch\'s forward {fwd_ms:.3f} ms (CUDA events), '
          f'{dispatches} of them {dispatches * fwd_ms:.1f} ms; '
          f'{card_line()}', flush=True)

    torch.backends.cudnn.allow_tf32 = False
    y32 = tds.predict((model, net), hr[:1], **kwargs)
    net_cpu = copy.deepcopy(net).cpu()
    t0 = time.perf_counter()
    y_cpu = tds.predict((model, net_cpu), hr[:1], device='cpu', **kwargs)
    cpu_s = time.perf_counter() - t0
    del net_cpu
    gated_err = _compare(y32[0], y_cpu[0], f'tiled predict grid 0, GPU (TF32 '
                         f'off) vs the same tiled call on the CPU '
                         f'({cpu_s:.1f} s there)')
    free = build(attention=False, output_attention=False)
    fnet = free.init(seed=0, device='cuda')
    tiled = tds.predict((free, fnet), hr, **kwargs)
    untiled = tds.predict((free, fnet), hr, **dict(kwargs, tile=None))
    free_err = _compare(tiled, untiled, 'attention-free twin, tiled vs '
                        'untiled on the card (TF32 off)')
    report['tiled'] = dict(launches=launches, bwd_launches=bwd,
                           grids_per_s=TILED_GRIDS / predict_s,
                           window_forward_ms=fwd_ms, dispatches=dispatches,
                           cpu_err=gated_err, twin_err=free_err)


def _tiled_recurrent(torch, tds, report):
    """(b): recresnet_spc served tiled (halo 64) on 5 global grids, K2 on
    [8, 4, 256, 256, C] windows; its attention-free twin tiled against
    untiled on the card."""
    import numpy as np
    from dl4ds_tpu_torch.parallel import receptive_field_radius
    fcl = tds.fused_convlstm
    h, w = TILED_GRID
    hr = np.random.default_rng(19).standard_normal(
        (TILED_REC_GRIDS, h * SCALE, w * SCALE)).astype('float32')
    kwargs = dict(scale=SCALE, array_in_hr=True, time_window=REC_T,
                  tile=TILE, halo=REC_TILE_HALO, batch_size=BATCH)

    def build(**kw):
        return tds.recnet_postupsampling(
            'resnet', 'spc', scale=SCALE, n_channels=1, n_aux_channels=0,
            lr_size=TILED_GRID, time_window=REC_T, n_filters=N_FILTERS,
            n_blocks=REC_BLOCKS, **kw)
    model = build()
    net = model.init(seed=0, device='cuda')
    samples = TILED_REC_GRIDS - REC_T + 1
    n_win = samples * (-(-h // TILE)) * (-(-w // TILE))
    dispatches = -(-n_win // BATCH)
    torch.backends.cudnn.allow_tf32 = True
    fcl.launches = 0
    y = tds.predict((model, net), hr, **kwargs)
    launches = fcl.launches
    expected = len(TILED_K2_LAYERS) * REC_T * dispatches
    print(f'tiled recurrent predict: {TILED_REC_GRIDS} grids {h}x{w} '
          f'({samples} windows of {REC_T}) -> {y.shape}, {n_win} windows of '
          f'{REC_TILE_WINDOW}x{REC_TILE_WINDOW} (halo {REC_TILE_HALO}; the '
          f'receptive-field estimate {receptive_field_radius(REC_BLOCKS, time_window=REC_T)})'
          f' in {dispatches} dispatches; K2 launches {launches} (expected '
          f'{expected})', flush=True)
    if y.shape != (TILED_REC_GRIDS, h * SCALE, w * SCALE, 1):
        fail(f'tiled recurrent predict output shape {y.shape}')
    if not np.isfinite(y).all():
        fail('tiled recurrent predict output is not finite')
    if launches != expected:
        fail(f'tiled recurrent predict launched K2 {launches} times, '
             f'expected {expected}')
    t0 = time.perf_counter()
    tds.predict((model, net), hr, **kwargs)
    predict_s = time.perf_counter() - t0
    win = torch.randn((BATCH, REC_T, REC_TILE_WINDOW, REC_TILE_WINDOW, 1),
                      device='cuda')
    with torch.inference_mode():
        fwd_ms = statistics.median(device_times(torch, lambda: net(win),
                                                reps=5))
    print(f'tiled recurrent predict of {TILED_REC_GRIDS} global grids: '
          f'{TILED_REC_GRIDS / predict_s:.4f} grids/s end to end (host '
          f'clock); a window dispatch\'s forward {fwd_ms:.3f} ms (CUDA '
          f'events); {card_line()}', flush=True)
    torch.backends.cudnn.allow_tf32 = False
    free = build(attention=False, output_attention=False)
    fnet = free.init(seed=0, device='cuda')
    tiled = tds.predict((free, fnet), hr, **kwargs)
    untiled = tds.predict((free, fnet), hr, **dict(kwargs, tile=None))
    free_err = _compare(tiled, untiled, 'recurrent attention-free twin, '
                        'tiled vs untiled on the card (TF32 off)')
    report['tiled_rec'] = dict(launches=launches,
                               grids_per_s=TILED_REC_GRIDS / predict_s,
                               window_forward_ms=fwd_ms,
                               dispatches=dispatches, twin_err=free_err)
    report['tiled_k2_rows'] = _k2_serve_rows(
        torch, tds, TILED_K2_LAYERS, REC_TILE_WINDOW,
        'phase 18: tiled window layer')


def _ensemble_batches(torch, tds, config, batch, n):
    """n training batches of `batch` from the flagship's synthesizer (phase
    10's data and patches), on the card."""
    tr = tds.SupervisedTrainer(batch_size=batch, epochs=1, **config)
    tr.setup_datagen()
    tr.setup_model()
    gen = torch.Generator().manual_seed(3)
    idx = tr.ds_train.epoch_indices(gen, steps=n)
    return tr.model, [tr.ds_train(idx[c], generator=gen) for c in range(n)]


def _ensemble_vs_cpu(torch, tds, model, stacked, batches, loss, label,
                     counters=None):
    """ENS_STEPS ensemble steps (bootstrap off) on the card (TF32 off,
    PyTorch's own convolutions) and on the CPU in float64 from the same
    stack and batches: the losses and the parameters after the last step
    at phase 7's tolerances. The card's launches: K1's and K6's, or with
    `counters` (`_counters`) each that moved, by name."""
    from dl4ds_tpu_torch import parallel
    fca, fss = tds.fused_channel_attention, tds.fused_ssim_per_image
    es = parallel.make_ensemble_step(model, loss=loss, bootstrap=False)
    runs = {}
    counts = {}
    for device, dtype in (('cuda', torch.float32), ('cpu', torch.float64)):
        torch.backends.cudnn.enabled = device == 'cpu'
        torch.backends.cudnn.allow_tf32 = False
        st = {k: v.detach().to(device, dtype, copy=True)
              for k, v in stacked.items()}
        opt = es.init_opt(st)
        fca.launches = fca.bwd_launches = 0
        fss.launches = fss.bwd_launches = 0
        for _, o, a in counters or ():
            setattr(o, a, 0)
        losses = []
        for c, b in enumerate(batches):
            st, opt, ls = es.step(st, opt, b['lr'].to(device),
                                  b['hr'].to(device), c)
            losses.append(ls.double().cpu())
        if device == 'cuda':
            counts = dict(k1=fca.launches, k1_bwd=fca.bwd_launches,
                          k6=fss.launches, k6_bwd=fss.bwd_launches)
            if counters:
                counts = {n: getattr(o, a) for n, o, a in counters
                          if getattr(o, a)}
        runs[device] = (torch.stack(losses), {
            k: v.detach().to('cpu', torch.float64) for k, v in st.items()})
    torch.backends.cudnn.enabled = True
    (gl, gp), (cl, cp) = runs['cuda'], runs['cpu']
    loss_err = ((gl - cl).abs() / cl.abs()).max().item()
    param_err = max((gp[k] - cp[k]).abs().max().item() for k in cp)
    print(f'{label}: {len(batches)} ensemble steps of {ENS_M} members at '
          f'batch {batches[0]["lr"].shape[0]}, GPU (TF32 off, PyTorch\'s own '
          f'convolutions) vs CPU (float64): losses max relative difference '
          f'{loss_err:.3e} (rtol {TRAIN_LOSS_RTOL}), parameters max|d| '
          f'{param_err:.3e} (atol {TRAIN_PARAM_ATOL}); launches on the card '
          f'{counts}', flush=True)
    if not (loss_err <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_ATOL):
        fail(f'{label}: ensemble steps on the GPU disagree with the CPU: '
             f'losses {loss_err:.3e}, parameters {param_err:.3e}')
    return dict(loss_rel_err=loss_err, param_err=param_err, launches=counts)


def _ensemble(torch, tds, report):
    """(c): a 4-member ensemble of the flagship trained and served."""
    import numpy as np
    from dl4ds_tpu_torch import parallel
    fca = tds.fused_channel_attention
    config = _training_config(loss='mae', n_filters=N_FILTERS,
                              n_blocks=N_BLOCKS, attention=True)
    model, small = _ensemble_batches(torch, tds, config, ENS_CPU_BATCH,
                                     ENS_STEPS)
    stacked = parallel.init_ensemble(model, ENS_M, seed=0)
    gates = len(K1_TRAIN_SHAPES)
    out = {'mae_vs_cpu': _ensemble_vs_cpu(
        torch, tds, model, stacked, small, 'mae', 'ensemble, mae')}
    ssim = _ensemble_vs_cpu(torch, tds, model, stacked, small[:1],
                            'dssim_mae', 'ensemble, dssim_mae')
    # one K6 launch a member each way: each member's data range is its own
    if ssim['launches'] != dict(k1=gates, k1_bwd=gates, k6=ENS_M,
                                k6_bwd=ENS_M):
        fail(f'ensemble dssim_mae step launched {ssim["launches"]}, expected '
             f'K1 {gates} each way and K6 {ENS_M} each way')
    out['dssim_vs_cpu'] = ssim

    # bootstrap: 4 copies of member 0, each on its own resample
    _, big = _ensemble_batches(torch, tds, config, TRAIN_BATCH,
                               ENS_SPEED_STEPS)
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    same = {k: v[:1].repeat(ENS_M, *[1] * (v.dim() - 1))
            for k, v in stacked.items()}
    es = parallel.make_ensemble_step(model, loss='mae', bootstrap=True)
    opt = es.init_opt(same)
    gen = torch.Generator(device='cuda').manual_seed(18)
    boot = []
    for b in big[:ENS_STEPS]:
        same, opt, ls = es.step(same, opt, b['lr'], b['hr'], gen)
        boot.append(ls.tolist())
    spread = max((v[1:] - v[:1]).abs().max().item() for v in same.values())
    print(f'ensemble, bootstrap: losses {boot}; members from one init '
          f'apart by {spread:.3e} after {ENS_STEPS} steps', flush=True)
    if not (np.isfinite(boot).all() and spread > 0):
        fail(f'bootstrapped ensemble: losses {boot}, members apart by '
             f'{spread}')

    # speed: eager ensemble steps at batch 128, launches counted
    st = {k: v.clone() for k, v in stacked.items()}
    opt = es.init_opt(st)
    es.step(st, opt, big[0]['lr'], big[0]['hr'], gen)
    torch.cuda.synchronize()
    fca.launches = fca.bwd_launches = 0
    t0 = time.perf_counter()
    for b in big:
        st, opt, ls = es.step(st, opt, b['lr'], b['hr'], gen)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / len(big)
    launches, bwd = fca.launches, fca.bwd_launches
    if launches != gates * len(big) or bwd != gates * len(big):
        fail(f'ensemble steps launched K1 {launches} and its backward {bwd} '
             f'times, expected {gates * len(big)} each (one member-mode '
             f'launch a gate)')
    step_ms = statistics.median(device_times(
        torch, lambda: es.step(st, opt, big[0]['lr'], big[0]['hr'], gen),
        reps=5))
    rate = ENS_M * TRAIN_BATCH / step_s
    single = report.get('bf16_train', {}).get('resnet_spc, mae, float32')
    print(f'ensemble training, {ENS_M} members at batch {TRAIN_BATCH}, mae, '
          f'eager: {rate:.1f} member-patches/s (host clock), one step '
          f'{step_ms:.3f} ms (CUDA events); K1 {launches} launches and '
          f'{bwd} backward in {len(big)} steps; '
          + (f'{ENS_M}x phase 12\'s single model: eager '
             f'{ENS_M * single["eager_patches_per_s"]:.1f}, replayed '
             f'{ENS_M * single["graphed"]["patches_per_s"]:.1f} patches/s'
             if single else 'phase 12 did not run in this call')
          + f'; {card_line()}', flush=True)
    out.update(k1_launches=launches, k1_bwd_launches=bwd,
               member_patches_per_s=rate, step_ms=step_ms)

    # serving: one vmapped forward of 16 grids, its members checked
    rng = np.random.default_rng(20)
    x = rng.standard_normal((N_GRIDS, LR, LR, 1)).astype('float32')
    truth = rng.standard_normal((N_GRIDS, LR * SCALE, LR * SCALE, 1)).astype(
        'float32')
    torch.backends.cudnn.allow_tf32 = False
    fca.launches = 0
    _, std, members = parallel.predict_ensemble(model, st, x,
                                                return_members=True)
    serve_launches = fca.launches
    if serve_launches != gates:
        fail(f'predict_ensemble launched K1 {serve_launches} times, '
             f'expected {gates}')
    if members.shape != (ENS_M, N_GRIDS, LR * SCALE, LR * SCALE, 1) or not (
            np.isfinite(members).all() and std.max() > 0):
        fail(f'predict_ensemble: members {members.shape}, std max '
             f'{std.max()}')
    net = model.init(0, device='cuda').eval()
    with torch.no_grad():
        for i in (0, ENS_M - 1):
            for name, p in net.named_parameters():
                p.copy_(st[name][i])
            with torch.inference_mode():
                alone = net(torch.from_numpy(x).cuda()).float().cpu().numpy()
            _compare(members[i], alone, f'predict_ensemble member {i} vs the '
                     f'member served alone (TF32 off)')
    torch.backends.cudnn.allow_tf32 = True
    parallel.predict_ensemble(model, st, x, return_members=True)
    t0 = time.perf_counter()
    parallel.predict_ensemble(model, st, x, return_members=True)
    serve_s = time.perf_counter() - t0
    crps, ratio, counts = tds.compute_prob_metrics(truth, members,
                                                   save_path=None)
    print(f'predict_ensemble of {N_GRIDS} grids {LR}x{LR} -> members '
          f'{members.shape}, K1 {serve_launches} launches; '
          f'{N_GRIDS / serve_s:.2f} grids/s (host clock, {ENS_M} members, '
          f'TF32 convs); compute_prob_metrics: CRPS map {np.shape(crps)} '
          f'mean {float(np.mean(crps)):.4f}, spread-skill {float(ratio):.4f}, '
          f'rank histogram {np.asarray(counts).tolist()}; {card_line()}',
          flush=True)
    if not (np.isfinite(crps).all() and np.isfinite(ratio)
            and int(np.sum(counts)) == truth.size):
        fail(f'compute_prob_metrics: CRPS finite {np.isfinite(crps).all()}, '
             f'ratio {ratio}, {int(np.sum(counts))} ranks')
    out.update(serve_launches=serve_launches, serve_grids_per_s=N_GRIDS /
               serve_s)
    report['ensemble'] = out


def _member_scales(torch, fo, x64, w64, dy64):
    """The weight gradients' scales of a member: the largest sum of the
    samples' terms in magnitude (they cancel; `_check_k1_backward`)."""
    mags = None
    for i in range(x64.shape[0]):
        terms = fo._channel_attention_backward(x64[i:i + 1], *w64,
                                               dy64[i:i + 1])[1:]
        mags = ([t.abs() for t in terms] if mags is None
                else [m + t.abs() for m, t in zip(mags, terms)])
    return [m.max().item() for m in mags]


def _member_rows(torch, tds):
    """(d): K1's member mode alone at MEMBER_SHAPES, forward and backward,
    float32 and the mixed mode: the same bits as ENS_M one-member launches,
    the per-member plain version's values (float32 forward 1e-5; backward
    against float64, K1_BWD_TOL of each gradient's scale; mixed mode
    `_check_k1_mixed`'s tolerances), timed against the plain version and
    the byte bound."""
    from dl4ds_tpu_torch.ops import fused_ops as fo
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(21)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = []
    for shape in MEMBER_SHAPES:
        c = shape[-1]
        cr = max(int(c / 4), 1)
        per = shape[0] // ENS_M
        scale = (2.0 / (c + cr)) ** 0.5
        x = torch.randn(shape, generator=gen, device=dev)
        dy = torch.randn(shape, generator=gen, device=dev)
        ws = [torch.randn((ENS_M,) + s, generator=gen, device=dev) * k
              for s, k in (((c, cr), scale), ((cr,), 0.1), ((cr, c), scale),
                           ((c,), 0.1))]

        def member(t, i):
            return t[i * per:(i + 1) * per].contiguous()
        errs = {}
        for mixed, xt, dyt in ((False, x, dy),
                               (True, x.to(torch.bfloat16), dy)):
            y, m, g = fo._launch(xt, *ws, mixed=mixed)
            grads = fo._launch_backward(xt, *ws, dyt, m, g, mixed=mixed)
            ones = [fo._launch(member(xt, i), *[w[i] for w in ws],
                               mixed=mixed) for i in range(ENS_M)]
            gones = [fo._launch_backward(
                member(xt, i), *[w[i] for w in ws], member(dyt, i),
                member(m, i), member(g, i), mixed=mixed)
                for i in range(ENS_M)]
            same = (all(torch.equal(a, torch.cat([o[k] for o in ones]))
                        for k, a in enumerate((y, m, g)))
                    and torch.equal(grads[0], torch.cat([o[0] for o in gones]))
                    and all(torch.equal(grads[k], torch.stack(
                        [o[k] for o in gones])) for k in range(1, 5)))
            mode = 'mixed' if mixed else 'float32'
            if not same:
                fail(f'K1 member mode x{list(shape)} {mode}: not the bits of '
                     f'{ENS_M} one-member launches')
            if mixed:
                errs[mode] = max(max(_check_k1_mixed(
                    torch, fo, member(xt, i), [w[i] for w in ws],
                    member(dyt, i), f'member {i} x{list(shape)}').values())
                    for i in range(ENS_M))
                continue
            y_ref = fo._plain_forward(x, *ws)[0]
            fwd_err = (y - y_ref).abs().max().item()
            if not fwd_err <= K1_TOL['float32']['atol']:
                fail(f'K1 member mode x{list(shape)}: max|d| {fwd_err:.3e}')
            bwd_err = 0.0
            for i in range(ENS_M):
                x64, dy64 = member(x, i).double(), member(dy, i).double()
                w64 = [w[i].double() for w in ws]
                ref = fo._channel_attention_backward(x64, *w64, dy64)
                scales = ([ref[0].abs().max().item()]
                          + [max(a, r.abs().max().item()) for a, r in zip(
                              _member_scales(torch, fo, x64, w64, dy64),
                              ref[1:])])
                for k, (a, r, sc) in enumerate(zip(
                        (gones[i][0],) + tuple(gones[i][1:]), ref, scales)):
                    d = (a.double() - r).abs().max().item()
                    d = d / sc if sc else d      # a dead relu: all zero
                    bwd_err = max(bwd_err, d)
                    if not d <= K1_BWD_TOL:
                        fail(f'K1 member mode backward x{list(shape)} member '
                             f'{i} gradient {k}: max|d| / scale {d:.3e}')
            errs[mode] = fwd_err
            errs['backward'] = bwd_err
        ms, plain_ms = paired_ms(torch, lambda: fo._launch(x, *ws),
                                 lambda: fo._plain_forward(x, *ws), flush)
        _, m, g = fo._launch(x, *ws)
        bwd_ms, bwd_plain_ms = paired_ms(
            torch, lambda: fo._launch_backward(x, *ws, dy, m, g),
            lambda: fo._plain_backward(x, *ws, dy, m, g), flush)
        w_bytes = 4 * ENS_M * (2 * c * cr + c + cr)
        bound_ms = max((2 * x.numel() * 4 + w_bytes) / HBM_BYTES_PER_S,
                       (2 * x.numel() + 4 * shape[0] * c * cr) / F32_FLOPS
                       ) * 1e3
        bwd_bound_ms = (3 * x.numel() * 4 + 2 * w_bytes) / HBM_BYTES_PER_S * 1e3
        plan = fo._ca_plan(shape, cr, torch.float32, *fo._ca_limits(dev),
                           members=ENS_M)
        rows.append(dict(shape=list(shape), members=ENS_M, cr=cr,
                         regime=plan['regime'], max_abs_err=errs['float32'],
                         bwd_rel_err=errs['backward'],
                         mixed_rel_err=errs['mixed'], ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, bwd_ms=bwd_ms,
                         bwd_plain_ms=bwd_plain_ms, bwd_bound_ms=bwd_bound_ms))
        print(f'K1 member mode x{list(shape)} ({ENS_M} members, '
              f'{plan["regime"]}) cr={cr}: the bits of {ENS_M} one-member '
              f'launches both ways, f32 and mixed; max|d| {errs["float32"]:.3e}'
              f', backward max|d|/scale {errs["backward"]:.2e}, mixed '
              f'{errs["mixed"]:.2e}; kernel {ms:.4f} ms  plain {plain_ms:.4f} '
              f'ms  bound {bound_ms:.4f} ms (bytes); backward kernel '
              f'{bwd_ms:.4f} ms  plain {bwd_plain_ms:.4f} ms  bound '
              f'{bwd_bound_ms:.4f} ms; {card_line()}', flush=True)
    return rows


def phase_parallel(torch, tds, report):
    """Phase 18: one-card parallelism: tiled serving of the flagship and of
    recresnet_spc on global grids, a 4-member flagship ensemble trained and
    served, K1's member mode alone."""
    _tiled_flagship(torch, tds, report)
    report['tiled_k1_rows'] = _tiled_gate_rows(torch, tds)
    _tiled_recurrent(torch, tds, report)
    _ensemble(torch, tds, report)
    report['member_rows'] = _member_rows(torch, tds)


def _parallel_kernel_rows(report):
    """The `kernels` line's rows of phase 18: K1 and K2 at the tiled window
    shapes (launches of (a)'s and (b)'s first predict), K1's member mode in
    the ensemble step and in predict_ensemble (launches of (c)'s timed
    steps and of its first serving call; times of (d)), and K6 under the
    ensemble's dssim_mae step."""
    k1 = dict(route='cuda', source='dl4ds_tpu_torch/csrc/channel_attention.cu',
              replaces='dl4ds_tpu/ops/pallas_ops.py:39', bound_by='bytes',
              library_ms=None)
    gates = report['tiled_k1_rows']
    k2 = report['tiled_k2_rows']
    ens = report['ensemble']
    step, serve = report['member_rows']
    out = [
        dict(k1, name='K1_channel_attention_tiled_serve',
             launches=report['tiled']['launches'],
             max_abs_err=max(r['max_abs_err'] for r in gates),
             ms=sum(r['ms'] for r in gates),
             plain_ms=sum(r['plain_ms'] for r in gates),
             bound_ms=sum(r['bound_ms'] for r in gates),
             work=f'the {len(gates)} gates of one tiled flagship dispatch, '
                  f'{BATCH} windows of {TILE_WINDOW}x{TILE_WINDOW}; launches '
                  f'of predict(tile={TILE}, halo={TILE_HALO}) on '
                  f'{TILED_GRIDS} grids {TILED_GRID[0]}x{TILED_GRID[1]}'),
        dict(route='cuda', name='K2_convlstm_tiled_serve',
             source='dl4ds_tpu_torch/csrc/convlstm.cu',
             replaces='dl4ds_tpu/ops/pallas_convlstm.py:219',
             bound_by='operations', library_ms=None,
             launches=report['tiled_rec']['launches'],
             max_abs_err=max(r['max_abs_err'] for r in k2),
             ms=_layer_totals(k2, TILED_K2_LAYERS, 'ms'),
             plain_ms=_layer_totals(k2, TILED_K2_LAYERS, 'plain_ms'),
             bound_ms=_layer_totals(k2, TILED_K2_LAYERS, 'bound_ms'),
             work=f'the {len(TILED_K2_LAYERS)} ConvLSTM layers of one tiled '
                  f'recresnet_spc dispatch, [{BATCH}, {REC_T}, '
                  f'{REC_TILE_WINDOW}, {REC_TILE_WINDOW}, C]; launches of '
                  f'predict(tile={TILE}, halo={REC_TILE_HALO}) on '
                  f'{TILED_REC_GRIDS} grids'),
        dict(k1, name='K1_channel_attention_member_train',
             launches=ens['k1_launches'], bwd_launches=ens['k1_bwd_launches'],
             max_abs_err=step['max_abs_err'], ms=step['ms'],
             plain_ms=step['plain_ms'], bound_ms=step['bound_ms'],
             bwd_ms=step['bwd_ms'], bwd_plain_ms=step['bwd_plain_ms'],
             bwd_bound_ms=step['bwd_bound_ms'],
             work=f'the member mode at the ensemble step\'s first gate '
                  f'x{step["shape"]} ({ENS_M} members, {step["regime"]}), '
                  f'the plain version the per-member gate; launches of '
                  f'{ENS_SPEED_STEPS} ensemble steps (one a gate each way)'),
        dict(k1, name='K1_channel_attention_member_serve',
             launches=ens['serve_launches'], max_abs_err=serve['max_abs_err'],
             ms=serve['ms'], plain_ms=serve['plain_ms'],
             bound_ms=serve['bound_ms'], bwd_ms=serve['bwd_ms'],
             bwd_plain_ms=serve['bwd_plain_ms'],
             bwd_bound_ms=serve['bwd_bound_ms'],
             work=f'the member mode at predict_ensemble\'s first gate '
                  f'x{serve["shape"]} ({ENS_M} members, {serve["regime"]}); '
                  f'launches of predict_ensemble on {N_GRIDS} grids'),
    ]
    k6 = report.get('k6_rows')
    if k6:
        row = k6[0]
        out.append(dict(
            route='cuda', name='K6_ssim_ensemble',
            source='dl4ds_tpu_torch/csrc/ssim.cu',
            replaces='dl4ds_tpu/ops/pallas_ops.py:145',
            bound_by=row['bound_by'], library_ms=None,
            launches=ens['dssim_vs_cpu']['launches']['k6'],
            bwd_launches=ens['dssim_vs_cpu']['launches']['k6_bwd'],
            max_abs_err=max(r['max_abs_err'] for r in k6), ms=row['ms'],
            plain_ms=row['plain_ms'], bound_ms=row['bound_ms'],
            work=f'one launch a member each way in the ensemble\'s dssim_mae '
                 f'step (each member\'s own data range); times of phase 9 at '
                 f'x{row["shape"]}'))
    return out


# phase 19: frozen serving artifacts and the HTTP model server. The flagship
# (phase 3's model: resnet_spc x4 with n_filters 8, n_blocks 6, attention, 2
# statics and a predictor) exported with a symbolic batch and served by
# `serve.ModelServer` at batches 1, 8 and 13 (pow2 padding off and on) and
# over HTTP on 127.0.0.1; recresnet_spc (phase 5's model) exported with a
# symbolic batch and with batch 8; the bfloat16 flagship. Every output is
# held against `predict` of the same grids on the card (TF32 off).
SERVE_BATCHES = (1, 8, 13)
SERVE_MAX_BATCH = 16
# artifact against predict, both on the card: cuDNN may pick other
# convolution algorithms at other batch sizes (float32 sums in other orders)
SERVE_REL = 1e-5
HTTP_REQUESTS, HTTP_THREADS, HTTP_WINDOW_MS = 64, 8, 2
K1_OP = 'dl4ds_tpu_torch.channel_attention.default'
K2_OP = 'dl4ds_tpu_torch.convlstm.default'


def _phase3_grids():
    """Phase 3's grids, statics and predictor (the same seeded draws)."""
    import numpy as np
    rng = np.random.default_rng(0)
    hr_size = LR * SCALE
    hr = rng.standard_normal((N_GRIDS, hr_size, hr_size)).astype('float32')
    topo = rng.standard_normal((hr_size, hr_size)).astype('float32')
    mask = (rng.random((hr_size, hr_size)) > 0.5).astype('float32')
    pred = rng.standard_normal((N_GRIDS, hr_size, hr_size, 1)).astype(
        'float32')
    return hr, dict(scale=SCALE, array_in_hr=True, static_vars=[topo, mask],
                    predictors=[pred], batch_size=BATCH)


def _served_inputs(torch, model, hr, kwargs, time_window=None):
    """The (x, aux) numpy batch that `predict` builds from `hr` on the
    card, the input a client of the artifact sends."""
    from dl4ds_tpu_torch.inference import _assemble_inputs
    x, aux, _ = _assemble_inputs(
        model, hr, SCALE, kwargs.get('array_in_hr', True),
        kwargs.get('static_vars'), kwargs.get('predictors'), time_window,
        'inter_area', torch.device('cuda', torch.cuda.current_device()))
    return x.cpu().numpy(), None if aux is None else aux.cpu().numpy()


def _graph_ops(torch, path):
    """{operator: nodes} of the kernels' operators in the artifact's graph,
    and the `mixed` flags of its K1 nodes."""
    ep = torch.export.load(str(Path(path) / 'forward.pt2'))
    nodes = [n for n in ep.graph.nodes if n.op == 'call_function']
    k1 = [n for n in nodes if str(n.target) == K1_OP]
    return ({K1_OP: len(k1),
             K2_OP: sum(str(n.target) == K2_OP for n in nodes)},
            [bool(n.args[-1]) for n in k1])


def _save_artifact(torch, tds, model, net, path, label, **opts):
    t0 = time.perf_counter()
    nbytes = tds.save_serving_artifact(model, net, str(path), **opts)
    seconds = time.perf_counter() - t0
    ops, mixed = _graph_ops(torch, path)
    print(f'artifact {label}: {nbytes} bytes, exported and saved in '
          f'{seconds:.1f} s; operator nodes {ops}', flush=True)
    return ops, mixed, seconds


def _held(got, want, label, rel=SERVE_REL):
    import numpy as np
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    if got.shape != want.shape or not np.isfinite(got).all() \
            or not err <= rel * scale:
        fail(f'{label}: output {got.shape} against {want.shape}, max|d| '
             f'{err:.3e}, {rel} of max|y| {scale:.3e} allowed')
    return err / scale


def _artifact_flagship(torch, tds, root, report):
    """(a): the flagship artifact through ModelServer at batches 1, 8 and
    13, pow2 padding off and on, against predict; K1's launches a device
    batch."""
    from dl4ds_tpu_torch.serve import ModelServer
    fca = tds.fused_channel_attention
    model = tds.net_postupsampling(
        'resnet', 'spc', scale=SCALE, n_channels=4, n_aux_channels=2,
        lr_size=(LR, LR), n_filters=N_FILTERS, n_blocks=N_BLOCKS,
        attention=True)
    net = model.init(seed=0, device='cuda')
    hr, kwargs = _phase3_grids()
    x, aux = _served_inputs(torch, model, hr, kwargs)
    path = root / 'flagship'
    ops, _, export_s = _save_artifact(torch, tds, model, net, path,
                                      'resnet_spc (batch poly)')
    if ops != {K1_OP: len(K1_SHAPES), K2_OP: 0}:
        fail(f'flagship artifact holds {ops}, expected {len(K1_SHAPES)} K1 '
             f'nodes')
    y_pred = tds.predict((model, net), hr, **kwargs)
    rows, launches, servers = [], 0, []
    for pad in (False, True):
        srv = ModelServer(str(path), pad_pow2=pad,
                          max_batch=SERVE_MAX_BATCH)
        servers.append(srv)
        for n in SERVE_BATCHES:
            fca.launches = fca.bwd_launches = 0
            y = srv.predict(x[:n], aux[:n])
            got = fca.launches
            launches += got
            if got != len(K1_SHAPES) or fca.bwd_launches:
                fail(f'flagship artifact at batch {n} (pad_pow2 {pad}) '
                     f'launched K1 {got} times and its backward '
                     f'{fca.bwd_launches}, expected {len(K1_SHAPES)} and 0')
            rel = _held(y, y_pred[:n], f'flagship artifact at batch {n} '
                        f'(pad_pow2 {pad}) against predict')
            rows.append(dict(batch=n, pad_pow2=pad, k1_launches=got,
                             rel_err=rel))
            print(f'flagship artifact via ModelServer, batch {n}, pad_pow2 '
                  f'{pad}: K1 {got} launches, max|d| / max|y| against '
                  f'predict {rel:.3e}', flush=True)
    call, _ = tds.load_serving_artifact(str(path))
    xb = torch.from_numpy(x[:BATCH]).cuda()
    ab = torch.from_numpy(aux[:BATCH]).cuda()
    call_ms = statistics.median(device_times(torch, lambda: call(xb, ab),
                                             reps=10))
    with torch.inference_mode():
        net_ms = statistics.median(device_times(torch, lambda: net(xb, ab),
                                                reps=10))
    print(f'flagship artifact call at batch {BATCH}: {call_ms:.3f} ms, the '
          f'network\'s own forward {net_ms:.3f} ms (CUDA events); '
          f'{card_line()}', flush=True)
    report['artifact'] = dict(rows=rows, k1_launches=launches,
                              export_s=export_s, call_ms=call_ms,
                              forward_ms=net_ms)
    return servers[0], path, x, aux


def _http_round(torch, tds, ref, path, x, aux, report):
    """(b): HTTP on 127.0.0.1: HTTP_REQUESTS one-grid npz requests from
    HTTP_THREADS client threads under eager micro-batching, each answer held
    against the in-process one at batch 1 (`ref`, a ModelServer of the same
    artifact without micro-batching)."""
    import io
    import threading
    import urllib.request
    import numpy as np
    from dl4ds_tpu_torch.serve import make_http_server
    want = [ref.predict(x[i:i + 1], aux[i:i + 1]) for i in range(len(x))]
    httpd, srv = make_http_server(str(path), host='127.0.0.1', port=0,
                                  batch_window_ms=HTTP_WINDOW_MS,
                                  max_batch=SERVE_MAX_BATCH, eager=True)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f'http://127.0.0.1:{httpd.server_address[1]}/predict'

    def post(body, ctype):
        req = urllib.request.Request(url, data=body, method='POST',
                                     headers={'Content-Type': ctype})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.read()

    bodies = []
    for i in range(len(x)):
        buf = io.BytesIO()
        np.savez(buf, data=x[i:i + 1], aux=aux[i:i + 1])
        bodies.append(buf.getvalue())
    try:
        post(bodies[0], 'application/x-npz')          # the first connection
        before = srv.health()
        lat, answers, errors = {}, {}, []
        start = threading.Barrier(HTTP_THREADS)

        def client(k):
            start.wait()
            for j in range(k, HTTP_REQUESTS, HTTP_THREADS):
                t1 = time.perf_counter()
                try:
                    raw = post(bodies[j % len(x)], 'application/x-npz')
                except Exception as exc:   # counted, then failed below
                    errors.append(f'{j}: {exc}')
                    continue
                lat[j] = (t1 - t0, time.perf_counter() - t1)
                answers[j] = np.load(io.BytesIO(raw))
        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(HTTP_THREADS)]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        wall = time.perf_counter() - t0
        after = srv.health()
        if errors or len(answers) != HTTP_REQUESTS:
            fail(f'HTTP: {len(answers)} of {HTTP_REQUESTS} answers, errors '
                 f'{errors[:3]}')
        worst, same = 0.0, 0
        for j, y in answers.items():
            w = want[j % len(x)]
            worst = max(worst, _held(y, w, f'HTTP answer {j}'))
            same += bool(np.array_equal(y, w))
        batches = after['device_batches'] - before['device_batches']
        samples = after['samples'] - before['samples']
        waits = [w for _, w in lat.values()]
        q = statistics.quantiles(waits, n=100)
        slowest = sorted(lat.items(), key=lambda kv: -kv[1][1])[:4]
        http = dict(requests_per_s=HTTP_REQUESTS / wall,
                    p50_ms=statistics.median(waits) * 1e3,
                    p99_ms=q[98] * 1e3, device_batches=batches,
                    mean_merge=samples / batches, max_rel_err=worst,
                    bit_equal=same,
                    slowest=[(j, round(a * 1e3, 1), round(w * 1e3, 1))
                             for j, (a, w) in slowest])
        print(f'HTTP on 127.0.0.1: {HTTP_REQUESTS} one-grid npz requests '
              f'(128x128x4 LR and 512x512x2 aux in, 512x512 out) from '
              f'{HTTP_THREADS} client threads, batch_window_ms '
              f'{HTTP_WINDOW_MS}, eager: {http["requests_per_s"]:.2f} '
              f'requests/s, latency p50 {http["p50_ms"]:.1f} ms, p99 '
              f'{http["p99_ms"]:.1f} ms (host clock); {batches} device '
              f'batches, mean merge {http["mean_merge"]:.2f} samples; '
              f'answers against the in-process ones max|d| / max|y| '
              f'{worst:.3e}, {same} of {HTTP_REQUESTS} bit for bit; the '
              f'slowest (request, sent at ms, took ms) {http["slowest"]}; '
              f'{card_line()}', flush=True)
    finally:
        httpd.shutdown()
        th.join(timeout=30)
    report['http'] = http


def _http_npy(torch, tds, root, report):
    """(b), the npy and the JSON request, bit for bit against the
    in-process answers: an npy body carries no aux, so both go to the
    flagship's widths without statics (one input channel, no aux)."""
    import io
    import threading
    import urllib.request
    import numpy as np
    from dl4ds_tpu_torch.serve import make_http_server, _npy_bytes
    model = tds.net_postupsampling(
        'resnet', 'spc', scale=SCALE, n_channels=1, n_aux_channels=0,
        lr_size=(LR, LR), n_filters=N_FILTERS, n_blocks=N_BLOCKS,
        attention=True)
    net = model.init(seed=0, device='cuda')
    path = root / 'flagship_noaux'
    ops, _, _ = _save_artifact(torch, tds, model, net, path,
                               'resnet_spc without aux (batch poly)')
    if ops[K1_OP] != len(K1_SHAPES):
        fail(f'aux-free flagship artifact holds {ops}')
    x = np.random.default_rng(19).standard_normal(
        (2, LR, LR, 1)).astype('float32')
    httpd, srv = make_http_server(str(path), host='127.0.0.1', port=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        req = urllib.request.Request(
            f'http://127.0.0.1:{httpd.server_address[1]}/predict',
            data=_npy_bytes(x), method='POST',
            headers={'Content-Type': 'application/x-npy'})
        with urllib.request.urlopen(req, timeout=120) as resp:
            y = np.load(io.BytesIO(resp.read()))
        req = urllib.request.Request(
            f'http://127.0.0.1:{httpd.server_address[1]}/predict',
            data=json.dumps({'data': x[:1].tolist()}).encode(),
            method='POST', headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
    finally:
        httpd.shutdown()
        th.join(timeout=30)
    want = srv.predict(x)
    if not np.array_equal(y, want):
        fail('HTTP npy answer differs from the in-process one')
    if out['shape'] != [1, LR * SCALE, LR * SCALE, 1] or not np.array_equal(
            np.asarray(out['prediction'], np.float32), srv.predict(x[:1])):
        fail('HTTP JSON answer differs from the in-process one')
    y_pred = tds.predict((model, net), x, scale=SCALE, array_in_hr=False,
                         batch_size=2)
    rel = _held(y, y_pred, 'aux-free flagship artifact over HTTP against '
                'predict')
    print(f'HTTP npy request (aux-free flagship, 2 grids) and JSON request '
          f'(1 grid): the in-process answers bit for bit; max|d| / max|y| '
          f'against predict {rel:.3e}', flush=True)
    report['http']['npy_rel_err'] = rel


def _artifact_recurrent(torch, tds, root, report):
    """(c): recresnet_spc exported with a symbolic batch and with batch 8,
    served on phase 5's 16 windows: K2's inference operator in the graph,
    T launches a layer a device batch, the collapsed output against
    predict(time_window=4)."""
    import numpy as np
    from dl4ds_tpu_torch.serve import ModelServer
    from dl4ds_tpu_torch.utils import spatiotemporal_to_spatial_samples
    fca, fcl = tds.fused_channel_attention, tds.fused_convlstm
    model = tds.recnet_postupsampling(
        'resnet', 'spc', scale=SCALE, n_channels=2, n_aux_channels=2,
        lr_size=(LR, LR), time_window=REC_T, n_filters=N_FILTERS,
        n_blocks=REC_BLOCKS)
    net = model.init(seed=0, device='cuda')
    rng = np.random.default_rng(1)
    hr_size = LR * SCALE
    hr = rng.standard_normal((REC_GRIDS, hr_size, hr_size)).astype('float32')
    topo = rng.standard_normal((hr_size, hr_size)).astype('float32')
    mask = (rng.random((hr_size, hr_size)) > 0.5).astype('float32')
    pred = rng.standard_normal((REC_GRIDS, hr_size, hr_size, 1)).astype(
        'float32')
    kwargs = dict(scale=SCALE, time_window=REC_T, static_vars=[topo, mask],
                  predictors=[pred], batch_size=BATCH)
    x, aux = _served_inputs(torch, model, hr, kwargs, time_window=REC_T)
    y_pred = tds.predict((model, net), hr, **kwargs)
    out = {}
    for batch in ('poly', BATCH):
        path = root / f'recurrent_{batch}'
        ops, _, _ = _save_artifact(torch, tds, model, net, path,
                                   f'recresnet_spc (batch {batch})',
                                   batch=batch)
        if ops != {K1_OP: 0, K2_OP: len(K2_LAYERS)}:
            fail(f'recurrent artifact (batch {batch}) holds {ops}, expected '
                 f'{len(K2_LAYERS)} K2 nodes')
        srv = ModelServer(str(path))
        fca.launches = fcl.launches = fcl.train_launches = 0
        y = srv.predict(x, aux)
        calls = 1 if batch == 'poly' else -(-len(x) // BATCH)
        want = len(K2_LAYERS) * REC_T * calls
        got = fcl.launches
        if got != want or fcl.train_launches or fca.launches:
            fail(f'recurrent artifact (batch {batch}) launched K2 {got} '
                 f'times (training variant {fcl.train_launches}, K1 '
                 f'{fca.launches}), expected {want}')
        grids = spatiotemporal_to_spatial_samples(y, REC_T)
        rel = _held(grids, y_pred, f'recurrent artifact (batch {batch}) '
                    f'against predict(time_window={REC_T})')
        print(f'recresnet_spc artifact (batch {batch}) via ModelServer on '
              f'{len(x)} windows: {calls} device calls, K2 {got} launches '
              f'(expected {want}), max|d| / max|y| against predict '
              f'{rel:.3e}', flush=True)
        out[str(batch)] = dict(k2_launches=got, rel_err=rel)
    report['artifact_rec'] = out


def _artifact_bf16(torch, tds, root, report):
    """(d): the bfloat16 flagship's artifact against bfloat16 predict by the
    mean criterion of phase 12, K1 in its mixed mode."""
    import numpy as np
    from dl4ds_tpu_torch.serve import ModelServer
    fca = tds.fused_channel_attention
    make = lambda dt: tds.net_postupsampling(  # noqa: E731
        'resnet', 'spc', scale=SCALE, n_channels=4, n_aux_channels=2,
        lr_size=(LR, LR), n_filters=N_FILTERS, n_blocks=N_BLOCKS,
        attention=True, dtype=dt)
    model, model32 = make(torch.bfloat16), make(torch.float32)
    net, net32 = (m.init(seed=0, device='cuda') for m in (model, model32))
    hr, kwargs = _phase3_grids()
    x, aux = _served_inputs(torch, model, hr, kwargs)
    path = root / 'flagship_bf16'
    ops, mixed, _ = _save_artifact(torch, tds, model, net, path,
                                   'resnet_spc bfloat16 (batch poly)')
    if ops[K1_OP] != len(K1_SHAPES) or not all(mixed):
        fail(f'bfloat16 artifact holds {ops}, mixed flags {mixed}')
    srv = ModelServer(str(path))
    fca.launches = 0
    y = srv.predict(x[:BATCH], aux[:BATCH])
    if fca.launches != len(K1_SHAPES):
        fail(f'bfloat16 artifact launched K1 {fca.launches} times, '
             f'expected {len(K1_SHAPES)}')
    y_pred = tds.predict((model, net), hr[:BATCH],
                         **dict(kwargs, predictors=[kwargs['predictors'][0]
                                                    [:BATCH]]))
    y32 = tds.predict((model32, net32), hr[:BATCH],
                      **dict(kwargs, predictors=[kwargs['predictors'][0]
                                                 [:BATCH]]))
    yt = torch.from_numpy(y)
    if y.shape != y_pred.shape or not torch.equal(
            yt, yt.to(torch.bfloat16).float()):
        fail(f'bfloat16 artifact output {y.shape}: not the bfloat16 values '
             f'of a {y_pred.shape} batch')
    scale = float(np.abs(y_pred).mean())
    port = float(np.abs(y - y_pred).mean()) / scale
    own = float(np.abs(y32 - y_pred).mean()) / scale
    print(f'bfloat16 flagship artifact via ModelServer at batch {BATCH}: K1 '
          f'{len(K1_SHAPES)} launches in the mixed mode; mean|d|/mean|y| '
          f'against bfloat16 predict {port:.3e}, the float32 model '
          f'{own:.3e} from it (at most {BF16_PREDICT_RATIO} of it '
          f'required); {card_line()}', flush=True)
    if not port <= BF16_PREDICT_RATIO * own:
        fail(f'bfloat16 artifact is {port:.3e} from bfloat16 predict, more '
             f'than {BF16_PREDICT_RATIO} of the float32 model\'s {own:.3e}')
    report['artifact_bf16'] = dict(k1_launches=len(K1_SHAPES),
                                   mean_rel_err=port, f32_mean_rel_dist=own)


def _op_gate_rows(torch, tds, dtype):
    """K1 through its operator at the gates of one flagship artifact call
    at batch BATCH (the mixed mode for a bfloat16 x), against the plain
    version and timed against it and the byte bound."""
    op = torch.ops.dl4ds_tpu_torch.channel_attention
    ref = tds.channel_attention_reference
    mixed = dtype == torch.bfloat16
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(190)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = []
    for hh, ww, c in K1_SHAPES:
        shape = (BATCH, hh, ww, c)
        cr = max(int(c / 4), 1)
        x, weights, _ = _gate_case(torch, gen, dev, shape, cr, dtype,
                                   glorot=True)
        out = torch.float32 if mixed else None
        y = op(x, *weights, mixed)[0]
        want = ref(x, *weights, out_dtype=out)
        err = _rel_err(y, want) if mixed else (y - want).abs().max().item()
        tol = BF16_F32_TOL if mixed else K1_TOL['float32']['atol']
        if not err <= tol:
            fail(f'K1 operator x{list(shape)} {dtype}: error {err:.3e}')
        ms, plain_ms = paired_ms(torch, lambda: op(x, *weights, mixed),
                                 lambda: ref(x, *weights, out_dtype=out),
                                 flush)
        n_bytes = (x.numel() * (x.element_size() + y.element_size())
                   + 4 * (2 * c * cr + c + cr))
        n_ops = 2 * x.numel() + 4 * BATCH * c * cr
        rows.append(dict(shape=list(shape), max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=max(
                             n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS)
                         * 1e3))
        print(f'K1 operator x{list(shape)} {str(dtype)[6:]} cr={cr}  error '
              f'{err:.3e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  '
              f'bound {rows[-1]["bound_ms"]:.4f} ms; {card_line()}',
              flush=True)
    return rows


def phase_serving(torch, tds, report):
    """Phase 19: frozen serving artifacts on the card, served in process
    and over HTTP."""
    import tempfile
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    parts = {}
    t0 = time.perf_counter()

    def done(name):
        nonlocal t0
        parts[name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ref, path, x, aux = _artifact_flagship(torch, tds, root, report)
        done('a')
        _http_round(torch, tds, ref, path, x, aux, report)
        _http_npy(torch, tds, root, report)
        done('b')
        _artifact_recurrent(torch, tds, root, report)
        done('c')
        _artifact_bf16(torch, tds, root, report)
        done('d')
    report['artifact_k1_rows'] = _op_gate_rows(torch, tds, torch.float32)
    report['artifact_k1_bf16_rows'] = _op_gate_rows(torch, tds,
                                                    torch.bfloat16)
    report['artifact_k2_rows'] = _k2_serve_rows(torch, tds, K2_LAYERS, LR,
                                                'artifact layer', seed=190)
    done('kernels')
    print(f'phase 19 parts (s): {parts}', flush=True)


def _serving_kernel_rows(report):
    """The `kernels` line's rows of phase 19: K1 and K2 launched from loaded
    artifacts (launches of (a)'s six ModelServer calls, (c)'s two runs and
    (d)'s call), each kernel's time an artifact call at batch BATCH through
    its operator."""
    k1 = dict(route='cuda', source='dl4ds_tpu_torch/csrc/channel_attention.cu',
              replaces='dl4ds_tpu/ops/pallas_ops.py:39', bound_by='bytes',
              library_ms=None)
    art = report['artifact']
    rec = report['artifact_rec']
    k2 = report['artifact_k2_rows']

    def gates(rows, **extra):
        return dict(max_abs_err=max(r['max_abs_err'] for r in rows),
                    ms=sum(r['ms'] for r in rows),
                    plain_ms=sum(r['plain_ms'] for r in rows),
                    bound_ms=sum(r['bound_ms'] for r in rows), **extra)
    return [
        dict(k1, name='K1_channel_attention_artifact_serve',
             launches=art['k1_launches'],
             artifact_call_ms=art['call_ms'],
             **gates(report['artifact_k1_rows']),
             work=f'the {len(K1_SHAPES)} gates of one flagship artifact '
                  f'call at batch {BATCH} through the operator '
                  f'dl4ds_tpu_torch::channel_attention, summed; launches of '
                  f'{len(art["rows"])} ModelServer calls at batches '
                  f'{list(SERVE_BATCHES)}, pow2 padding off and on; '
                  f'artifact_call_ms the whole call'),
        dict(k1, name='K1_channel_attention_artifact_bf16_serve',
             launches=report['artifact_bf16']['k1_launches'],
             **gates(report['artifact_k1_bf16_rows']),
             work=f'the {len(K1_SHAPES)} gates of one bfloat16 flagship '
                  f'artifact call at batch {BATCH} in the mixed mode; '
                  f'max_abs_err is max|d| / max|ref|'),
        dict(route='cuda', name='K2_convlstm_artifact_serve',
             source='dl4ds_tpu_torch/csrc/convlstm.cu',
             replaces='dl4ds_tpu/ops/pallas_convlstm.py:219',
             bound_by='operations', library_ms=None,
             launches=sum(r['k2_launches'] for r in rec.values()),
             max_abs_err=max(r['max_abs_err'] for r in k2),
             ms=_layer_totals(k2, K2_LAYERS, 'ms'),
             plain_ms=_layer_totals(k2, K2_LAYERS, 'plain_ms'),
             bound_ms=_layer_totals(k2, K2_LAYERS, 'bound_ms'),
             work=f'the {len(K2_LAYERS)} ConvLSTM layers of one recresnet_spc '
                  f'artifact call at batch {BATCH}, [{BATCH}, {REC_T}, {LR}, '
                  f'{LR}, C], through the operator dl4ds_tpu_torch::convlstm; '
                  f'launches of the batch-poly and batch-{BATCH} artifacts '
                  f'on 16 windows'),
    ]



# phase 20: int8 post-training quantization on the card. K7 (the int8
# convolution, csrc/conv_int8.cu: a site's quantization, sums, rescale and
# bias in one launch) held against its plain version at every site of the
# flagship's int8 forward at batch 8 (phase 3's grids), of the width-64
# flagship, of recresnet_spc and of a tiled window dispatch, and at a
# width-64 3x3, a depthwise 7x7 and a transposed 'dc' site: at the
# flagship's and the extra sites the fused float32 and bfloat16 outputs bit
# for bit and the int32 sums of the codes, on the other paths the output
# in the model dtype. The flagship's distinct sites and the extra ones
# timed against the plain version, the bounds (the float input's, and the
# int8 codes' of the unfused form), torch._int_mm on the unfolded matrix of
# the site's codes (the GEMM alone; the unfold beside) and cuDNN's bfloat16
# convolution at the same site (the float path int8 replaces). Then int8
# serving through
# the entry points: the flagship's predict(quantize='int8' | 'weight-only')
# beside float32 and bfloat16 predict at widths 8 and 64, recresnet_spc,
# the tiled global grid and an int8 artifact served by ModelServer.
INT8_OPS = 1979e12              # H100 SXM dense int8 tensor-core rate
Q_WIDE = 64                     # the width of (c)
Q_RATE_RUNS = 3                 # timed predict calls a mode (after one warm)
Q_OUT_SHARE = 0.05              # rel(card, its CPU copy) / CPU int8 error
Q_SCALE_RTOL = 1e-4             # act_scales, card against CPU
K7_SLEEP_CYCLES = 25_000_000    # (a)'s device sleep before each timing, a
                                # quarter of `device_times`' default: one
                                # site's calls are few and short to enqueue
# (a)'s extra sites, each as a site calls it (a seeded input, its scale
# s_x and a bias in the site's dtype; int8 codes take neither and give the
# int32 sums): (x shape, (Co, Cin / groups, kh, kw), stride, dilation,
# pads, groups, x dtype, the first of x's channels the site reads, or None
# for all of them). The first three are sites of the zoo, timed in PERF.md:
# the width-64 3x3 at phase 3's LR grid, the ConvNeXt depthwise 7x7 and
# the 'dc' head's 9x9 stride-2 transposed conv. The rest take the dense
# kernel's routes that the models' shapes leave out (`_k7_routes`): a
# channel slice at a 4-byte offset (cp.async of 4 bytes over strided
# pixels), Cin 5 and 15 (a part-filled channel chunk; cp.async of 4 bytes),
# a bfloat16 Cin 3 on rows of 21 pixels (plain loads), int8 codes at Cin 40
# (cp.async of 8 bytes), transposed sites of dilation 3 and 4, and 1536
# columns of Cin 384 (a streamed weight in 12 chunks, the epilogue from the
# registers).
Q_EXTRA_SITES = {
    'width-64 3x3': ((BATCH, LR, LR, 64), (64, 64, 3, 3), 1, 1,
                     (1, 1, 1, 1), 1, 'float32', None),
    'depthwise 7x7': ((2, 64, 64, 8), (8, 1, 7, 7), 1, 1, (3, 3, 3, 3), 8,
                      'float32', None),
    "'dc' 9x9 stride 2": ((2, 32, 32, 8), (8, 8, 9, 9), 1, 2,
                          (4, 5, 4, 5), 1, 'float32', None),
    'channels 1-48 of 64': ((2, 40, 36, 64), (48, 48, 3, 3), 1, 1,
                            (1, 1, 1, 1), 1, 'float32', 1),
    'Cin 5': ((2, 20, 21, 5), (8, 5, 3, 3), 1, 1, (1, 1, 1, 1), 1,
              'float32', None),
    'Cin 15': ((2, 20, 24, 15), (16, 15, 3, 3), 1, 1, (1, 1, 1, 1), 1,
               'float32', None),
    'bfloat16 Cin 3': ((2, 20, 21, 3), (5, 3, 3, 3), 1, 1, (1, 1, 1, 1), 1,
                       'bfloat16', None),
    'int8 Cin 40': ((2, 20, 24, 40), (32, 40, 3, 3), 1, 1, (1, 1, 1, 1), 1,
                    'int8', None),
    'dilation 3 5x5': ((2, 9, 7, 5), (6, 5, 5, 5), 1, 3, (3, 3, 3, 3), 1,
                       'float32', None),
    'dilation 4 17x17': ((1, 13, 11, 8), (8, 8, 17, 17), 1, 4,
                         (10, 9, 10, 9), 1, 'float32', None),
    'Co 1536': ((1, 12, 16, 384), (1536, 384, 3, 3), 1, 1, (1, 1, 1, 1), 1,
                'float32', None),
}
# the dense kernel's routes (`ops.conv_int8.launch_plan`) that (a)'s sites
# must take between them: how the window arrives (3 TMA over rows of (w,
# c), 2 TMA over NHWC, 1 cp.async, 0 plain loads), the epilogue (0 staged
# in the spent stage, 1 staged apart, 2 from the registers), the weight
# resident in shared memory or streamed, ldmatrix fragments or not
K7_ROUTES = {'load': {0, 1, 2, 3}, 'epilogue': {0, 1, 2},
             'resident': {0, 1}, 'ldmatrix': {0, 1}}


def _rel_err_q(a, b):
    """tests/test_quantization.py's rel: RMS(a - b) / std(b)."""
    import numpy as np
    a, b = np.asarray(a, 'float32'), np.asarray(b, 'float32')
    return float(np.sqrt(np.mean((a - b) ** 2)) / (np.std(b) + 1e-12))


@contextlib.contextmanager
def _k7_calls():
    """The K7 launches made inside the block, each as the arguments of
    `ops.conv_int8._launch` (x, w, scale, kh, kw, stride, dilation, pads,
    groups, out_dtype, s_x, bias): x the site's float input (or int8
    codes), s_x its scale, bias the site's, in out_dtype."""
    from dl4ds_tpu_torch.ops import conv_int8 as ci
    calls, real = [], ci._launch

    def spy(*args):
        calls.append(args)
        return real(*args)
    ci._launch = spy
    try:
        yield calls
    finally:
        ci._launch = real


def _real_taps(n, k, stride, dil, before, out):
    """The (output, tap) pairs of one dimension whose input index lands on
    one of the n real pixels: not on the padding, and not on a zero that
    the input dilation of a transposed convolution inserts."""
    return sum(1 for o in range(out) for t in range(k)
               if (p := o * stride + t - before) >= 0 and p % dil == 0
               and p // dil < n)


def _k7_work(x, co, kh, kw, stride, dil, pads, groups, out_bytes,
             bias_bytes=0):
    """(operations, bytes, the old form's bytes) of one K7 call: 2
    multiply-adds' worth for each tap that lands on a real input pixel, B
    x Co x Cin / groups x the taps of each dimension; x as given (the
    site's float input, or int8 codes), s_x, the unpadded weight [Co, kh,
    kw, Cin / groups], the scale and the bias read once, y written once;
    and the same with x's int8 codes in place of x and no bias (the bytes
    of K7 before its quantization and bias were fused)."""
    from dl4ds_tpu_torch.ops import conv_int8 as ci
    b, h, wd, cin = x.shape
    ho = ci.conv_out_size(h, kh, stride, dil, pads[0], pads[1])
    wo = ci.conv_out_size(wd, kw, stride, dil, pads[2], pads[3])
    taps = (_real_taps(h, kh, stride, dil, pads[0], ho)
            * _real_taps(wd, kw, stride, dil, pads[2], wo))
    ops = 2 * b * co * cin // groups * taps
    rest = co * kh * kw * cin // groups + 4 * co + b * ho * wo * co * out_bytes
    n_bytes = x.numel() * x.element_size() + 4 + bias_bytes + rest
    return ops, n_bytes, x.numel() + rest


def _k7_unfold(torch, x, kh, kw, stride, dil, pads, k_pad):
    """The site's im2col matrix [B Ho Wo (padded to 8), k_pad] int8, k in
    the packed weight's order (ky, kx, ci), zero-padded: torch._int_mm's
    operand."""
    import torch.nn.functional as F
    b, h, w, c = x.shape
    if dil > 1:
        xd = x.new_zeros((b, (h - 1) * dil + 1, (w - 1) * dil + 1, c))
        xd[:, ::dil, ::dil] = x
        x = xd
    x = F.pad(x, (0, 0, pads[2], pads[3], pads[0], pads[1]))
    ho = (x.shape[1] - kh) // stride + 1
    wo = (x.shape[2] - kw) // stride + 1
    sb, sh, sw, sc = x.stride()
    cols = x.as_strided((b, ho, wo, kh, kw, c),
                        (sb, sh * stride, sw * stride, sh, sw, sc))
    m = b * ho * wo
    out = x.new_zeros((-(-m // 8) * 8, k_pad))
    out[:m, :kh * kw * c] = cols.reshape(m, kh * kw * c)
    return out


def _k7_cudnn_bf16(torch, x, w_oihw, kh, kw, stride, dil, pads, groups):
    """A callable of cuDNN's bfloat16 convolution at the site (the port's
    bfloat16 `Conv`/`ConvTranspose` path, channels-last), the input
    pre-padded where the padding is asymmetric."""
    import torch.nn.functional as F
    xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    if dil > 1:
        wt = torch.flip(w_oihw, (2, 3)).permute(1, 0, 2, 3).contiguous(
            memory_format=torch.channels_last).to(torch.bfloat16)
        p = (kh - 1 - pads[0], kw - 1 - pads[2])
        out = [(n - 1) * dil + 1 + pads[2 * i] + pads[2 * i + 1] - k + 1
               for i, (n, k) in enumerate(zip(x.shape[1:3], (kh, kw)))]
        opad = [max(o - ((n - 1) * dil - 2 * pp + k), 0) for o, n, pp, k in
                zip(out, x.shape[1:3], p, (kh, kw))]
        return lambda: F.conv_transpose2d(xb, wt, stride=dil, padding=p,
                                          output_padding=tuple(opad))
    wb = w_oihw.to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    if pads[0] == pads[1] and pads[2] == pads[3]:
        return lambda: F.conv2d(xb, wb, stride=stride,
                                padding=(pads[0], pads[2]), groups=groups)
    xp = F.pad(xb, (pads[2], pads[3], pads[0], pads[1]))
    return lambda: F.conv2d(xp, wb, stride=stride, groups=groups)


def _k7_held(torch, ci, label, x, w, scale, geo, dtype, s_x, bias):
    """K7 against its plain version on one call: equal, or fail."""
    got = ci.conv_int8(x, w, scale, *geo, out_dtype=dtype, s_x=s_x,
                       bias=bias)
    want = ci.conv_int8_reference(x, w, scale, *geo, out_dtype=dtype,
                                  s_x=s_x, bias=bias)
    if not torch.equal(got, want):
        err = (got.double() - want.double()).abs().max().item()
        fail(f'K7 {label} x{list(x.shape)} {x.dtype} geometry {geo} '
             f'{dtype}: max|d| {err:.3e}, equal required')


def _k7_codes(torch, ci, x, made, s_x):
    """The int8 codes of a call's input, as the fused site forms them."""
    if x.dtype == torch.int8:
        return x
    return ci.quantize_activation(ci._site_input(x, made), s_x)


def _k7_rows(torch, calls, label, flush=None, reps=10):
    """Hold every K7 call against its plain version: with `flush` (an
    L2-sized buffer) the fused site's float32 and bfloat16 outputs (its
    float input, s_x and bias) and the int32 sums of its int8 codes equal,
    and without it the output in the dtype the call made; with `flush`
    also time each distinct site: K7 as the site calls it (40 CUDA-event
    medians, L2 flushed), the plain version, torch._int_mm on the unfolded
    matrix of the codes, the unfold and cuDNN's bfloat16 convolution
    (`reps` each), and its bounds, the fused one and that of the int8
    codes (`_k7_work`). Returns one row a distinct site, with the number
    of calls it stands for."""
    from dl4ds_tpu_torch.ops import conv_int8 as ci
    rows, seen = [], {}

    def timed(fn, n):
        return statistics.median(device_times(
            torch, fn, reps=n, l2_flush=flush,
            sleep_cycles=K7_SLEEP_CYCLES))
    for (x, w, scale, kh, kw, stride, dil, pads, groups, made, s_x,
         bias) in calls:
        geo = (kh, kw, stride, dil, tuple(pads), groups)
        for dtype in ((torch.float32, torch.bfloat16)
                      if flush is not None and s_x is not None else (made,)):
            _k7_held(torch, ci, label, x, w, scale, geo, dtype, s_x,
                     None if bias is None else bias.to(dtype))
        if flush is not None:
            _k7_held(torch, ci, label, _k7_codes(torch, ci, x, made, s_x), w, scale,
                     geo, torch.int32, None, None)
        key = (tuple(x.shape), x.dtype, tuple(w.shape), scale.shape[0], geo,
               made, bias is None)
        if key in seen:
            seen[key]['calls'] += 1
            continue
        if flush is None:
            seen[key] = dict(label=label, x=list(x.shape), co=scale.shape[0],
                             kernel=[kh, kw], calls=1)
            rows.append(seen[key])
            continue
        co = scale.shape[0]
        args = (x, w, scale, *geo, made, s_x, bias)
        ms = timed(lambda: ci.conv_int8(*args), 40)
        plain_ms = timed(lambda: ci.conv_int8_reference(*args), reps)
        ops, n_bytes, old_bytes = _k7_work(
            x, co, *geo, made.itemsize,
            0 if bias is None else bias.numel() * bias.element_size())
        ops_ms, bytes_ms = ops / INT8_OPS * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
        old_bytes_ms = old_bytes / HBM_BYTES_PER_S * 1e3
        bound_ms, bound_old_ms = max(ops_ms, bytes_ms), max(ops_ms,
                                                            old_bytes_ms)
        cin = x.shape[-1]
        w_oihw = ci._unpack(w, co, cin, kh, kw, groups, stride, dil).float()
        conv_bf16 = _k7_cudnn_bf16(torch, x, w_oihw, kh, kw, stride, dil,
                                   pads, groups)
        cudnn_ms = timed(conv_bf16, reps)
        library_ms = unfold_ms = library_n = None
        if groups == 1:
            # the GEMM alone on the codes' im2col matrix, k in (ky, kx,
            # ci) order, and the weight as [K, Co]
            x_q = _k7_codes(torch, ci, x, made, s_x)
            k = kh * kw * cin
            k_pad = -(-k // 32) * 32
            unfold_ms = timed(lambda: _k7_unfold(torch, x_q, kh, kw, stride,
                                                 dil, pads, k_pad), reps)
            a = _k7_unfold(torch, x_q, kh, kw, stride, dil, pads, k_pad)
            w_nk = torch.zeros((-(-co // 64) * 64, k_pad), dtype=torch.int8,
                               device=x.device)
            w_nk[:co, :k] = w_oihw.permute(0, 2, 3, 1).reshape(co, k).to(
                torch.int8)
            # Co padded to _int_mm's multiple of 8; cuBLASLt refused some
            # (40 on the H100), so to 16, 32, 64 where it does
            for step in (8, 16, 32, 64):
                b = w_nk[:-(-co // step) * step].t()
                try:
                    torch._int_mm(a, b)
                    break
                except RuntimeError:
                    continue
            library_ms = timed(lambda: torch._int_mm(a, b), reps)
            library_n = b.shape[1]
        plan = ci.launch_plan(*args)
        row = dict(label=label, x=list(x.shape), x_dtype=str(x.dtype)[6:],
                   w=list(w.shape), co=co, out_dtype=str(made)[6:],
                   bias=bias is not None,
                   kernel=[kh, kw], stride=stride, dilation=dil,
                   pads=list(pads), groups=groups, calls=1, max_abs_err=0.0,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_ops_ms=ops_ms, bound_bytes_ms=bytes_ms,
                   bound_old_ms=bound_old_ms,
                   bound_old_bytes_ms=old_bytes_ms,
                   bound_by='operations' if ops_ms > bytes_ms else 'bytes',
                   library_ms=library_ms, library_n=library_n,
                   unfold_ms=unfold_ms, cudnn_bf16_ms=cudnn_ms, plan=plan)
        seen[key] = row
        rows.append(row)
        lib = ('depthwise: no GEMM' if library_ms is None else
               f'_int_mm {library_ms:.4f} ms (N {library_n}; unfold '
               f'{unfold_ms:.4f})')
        print(f'K7 {label} x{list(x.shape)} {row["x_dtype"]} -> {co} '
              f'{row["out_dtype"]} {kh}x{kw} s{stride} d{dil} pads '
              f'{list(pads)} g{groups} bias {row["bias"]}: equal (fused '
              f'f32, bf16; int32 of the codes); kernel {ms:.4f} ms  plain '
              f'{plain_ms:.4f} ms  bound {bound_ms:.4g} ms '
              f'({row["bound_by"]}; the int8 codes\' {bound_old_ms:.4g})  '
              f'{lib}  cuDNN bf16 {cudnn_ms:.4f} ms; plan {plan}; '
              f'{card_line()}', flush=True)
    kinds = ('the fused float32 and bfloat16 outputs, the int32 sums of '
             'the codes' if flush is not None else 'their output dtype')
    print(f'K7 {label}s: {len(calls)} calls, all equal to the plain '
          f'version ({kinds}), at {len(rows)} distinct shapes; calls a '
          f'shape {[r["calls"] for r in rows]}', flush=True)
    return rows


def _k7_totals(rows):
    """A forward's K7 numbers: each distinct site's times its calls."""
    def total(key):
        vals = [r[key] for r in rows]
        if any(v is None for v in vals):
            return None
        return sum(r[key] * r['calls'] for r in rows)
    out = {k: total(k) for k in ('ms', 'plain_ms', 'bound_ms', 'bound_ops_ms',
                                 'bound_bytes_ms', 'bound_old_ms',
                                 'library_ms', 'unfold_ms', 'cudnn_bf16_ms')}
    for key in ('library_ms', 'unfold_ms'):   # depthwise sites: no GEMM
        if out[key] is None:
            out[key] = sum(r[key] * r['calls'] for r in rows
                           if r[key] is not None)
    out['calls'] = sum(r['calls'] for r in rows)
    return out


def _flagship_int8(tds, width=N_FILTERS, **dtype):
    """Phase 3's flagship at `width` (and `dtype`), weights from seed 0."""
    model = tds.net_postupsampling(
        'resnet', 'spc', scale=SCALE, n_channels=4, n_aux_channels=2,
        lr_size=(LR, LR), n_filters=width, n_blocks=N_BLOCKS,
        attention=True, **dtype)
    return model, model.init(seed=0, device='cuda')


def _rates(torch, tds, pairs, hr, kwargs, label):
    """grids/s of predict in each mode ({mode: (model, net, quantize)}),
    the median of Q_RATE_RUNS timed calls after a warm one, host clock;
    and the forward alone at batch 8 (CUDA events)."""
    import numpy as np
    out = {}
    for mode, (model, net, q) in pairs.items():
        tds.predict((model, net), hr, quantize=q, **kwargs)
        runs = []
        for _ in range(Q_RATE_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tds.predict((model, net), hr, quantize=q, **kwargs)
            torch.cuda.synchronize()
            runs.append(N_GRIDS / (time.perf_counter() - t0))
        out[mode] = statistics.median(runs)
    print(f'phase 20 {label}: predict of {N_GRIDS} grids at batch {BATCH} '
          + ', '.join(f'{m} {r:.2f}' for m, r in out.items())
          + f' grids/s (host clock, median of {Q_RATE_RUNS}; int8 and '
          f'weight-only calibrate in each call); int8 / bf16 '
          f'{out["int8"] / out["bf16"]:.3f}; {card_line()}', flush=True)
    return out


def _forward_ms(torch, fns):
    with torch.inference_mode():
        return {k: statistics.median(device_times(torch, f, reps=10))
                for k, f in fns.items()}


def _card_vs_cpu(torch, tds, model, net, qf, calibration, y_card0, part):
    """The card's int8 network against the port's on the CPU, each side
    calibrating itself on the same weights and batch: every site's weight
    codes and weight scales equal, the activation scales within
    Q_SCALE_RTOL. Then sample 0 (`y_card0`, the card's output) against
    the CPU's own quantized network, and against the card's network
    copied to the CPU (its scales): the check, at most Q_OUT_SHARE of the
    CPU's int8 error. The two CPU outputs differ only in the scales; their
    distance is what the scales' float difference alone does."""
    from dl4ds_tpu_torch.quantization import _Int8Conv
    net_cpu = copy.deepcopy(net).cpu().eval()
    t0 = time.perf_counter()
    args_cpu = tuple(None if a is None else a.cpu() for a in calibration)
    qf_cpu = tds.quantize_forward(model, net_cpu, *args_cpu)
    scale_err = max(abs(a - b) / b for a, b in zip(qf.act_scales,
                                                    qf_cpu.act_scales))
    n_equal = sum(a == b for a, b in zip(qf.act_scales, qf_cpu.act_scales))
    card_sites, cpu_sites = (
        [m for m in q.module.modules() if isinstance(m, _Int8Conv)]
        for q in (qf, qf_cpu))
    codes_equal = len(card_sites) == len(cpu_sites) and all(
        torch.equal(a.w.cpu(), b.w) and torch.equal(a.w_scale.cpu(),
                                                    b.w_scale)
        and torch.equal(a.scale.cpu(), a.s_x.cpu()[:, None] * b.w_scale)
        for a, b in zip(card_sites, cpu_sites))
    sample = tuple(None if a is None else a[:1] for a in args_cpu)
    with torch.inference_mode():
        y_own = qf_cpu.module.eval()(*sample).numpy()
        y_same = copy.deepcopy(qf.module).cpu().eval()(*sample).numpy()
        y_cpu_f = net_cpu(*sample).numpy()
    seconds = time.perf_counter() - t0
    own = _rel_err_q(y_own, y_cpu_f)
    rel_own, rel = _rel_err_q(y_card0, y_own), _rel_err_q(y_card0, y_same)
    alone = _rel_err_q(y_same, y_own)
    print(f'phase 20 {part}: {len(card_sites)} site modules, weight codes '
          f'and weight scales card vs CPU equal: {codes_equal}; act_scales '
          f'max relative difference {scale_err:.3e} (rtol {Q_SCALE_RTOL}), '
          f'{n_equal} of {qf.n_sites} equal; sample 0, the CPU int8 vs its '
          f'float32 {own:.4f}; the card vs the CPU on its own scales '
          f'{rel_own:.3e} (ratio {rel_own / own:.3e}); on the CPU, its own '
          f'scales vs the card\'s {alone:.3e} (ratio {alone / own:.3e}: '
          f'the scales alone); the card vs the CPU on the card\'s scales '
          f'{rel:.3e} (ratio {rel / own:.3e}, at most {Q_OUT_SHARE}) '
          f'({seconds:.1f} s on the CPU)', flush=True)
    if not (codes_equal and scale_err <= Q_SCALE_RTOL
            and rel <= Q_OUT_SHARE * own):
        fail(f'phase 20 {part}: card vs CPU codes equal {codes_equal}, '
             f'act_scales {scale_err:.3e}, output ratio {rel / own:.3e}')
    return dict(scale_err=scale_err, scales_equal=n_equal, cpu_rel=rel,
                cpu_int8_err=own, cpu_rel_own_scales=rel_own,
                cpu_scales_alone=alone)


def _int8_site_calls(torch, qf, inputs):
    """(module, its cursor, its input) of every int8 site call of one
    forward of the quantized forward `qf` on `inputs`."""
    from dl4ds_tpu_torch.quantization import _Int8Conv
    calls = []

    def hook(module, args):
        calls.append((module, module.call, args[0]))
    handles = [m.register_forward_pre_hook(hook) for m in qf.module.modules()
               if isinstance(m, _Int8Conv)]
    try:
        with torch.inference_mode():
            qf(*inputs)
    finally:
        for h in handles:
            h.remove()
    return calls


def _call_kernels(torch, fn):
    """The names of the device kernels of one call of fn() (copies and
    fills left out): two calls PROFILE_GUARD_S apart in one trace, the
    second read (`_replay_profile`); a short trace alone lost kernels here
    (38 of the int8 forward's 70, and every one of its 29 sites' called
    next, in one full run)."""
    with torch.inference_mode():
        fn()
        traced, _, _ = _replay_profile(torch, None, None, run=fn)
    return [e.name for e in traced
            if not e.name.startswith(('Memcpy', 'Memset'))]


def _int8_forward_launches(torch, qf, inputs, part):
    """(b)'s device trace (torch.profiler) of the int8 forward at batch 8:
    its kernels a batch, and of its site modules called alone, one after
    another on the inputs they met in the forward: one kernel a site, K7's
    (no quantize, cast or bias pass beside it)."""
    sites = _int8_site_calls(torch, qf, inputs)

    def each_site():
        for m, i, x in sites:
            m.call = i
            m(x)
    fwd = _call_kernels(torch, lambda: qf(*inputs))
    alone = _call_kernels(torch, each_site)
    k7, k7_fwd = (sum('conv_s8' in n for n in names) for names in (alone, fwd))
    print(f'phase 20 {part}: the int8 forward at batch {BATCH} in a device '
          f'trace: {len(fwd)} kernels ({k7_fwd} K7); its {len(sites)} site '
          f'modules called alone: {len(alone)} kernels, {k7} of them K7 '
          f'({sorted(set(alone))}); {card_line()}', flush=True)
    if (k7 != len(sites) or len(alone) != len(sites) or k7_fwd != len(sites)
            or len(sites) != qf.n_sites):
        fail(f'phase 20 {part}: {len(sites)} site calls ran {len(alone)} '
             f'kernels, {k7} K7 ({k7_fwd} K7 in the forward): '
             f'{sorted(set(alone))}')
    return dict(int8_forward_kernels=len(fwd), site_kernels=len(alone))


def _quant_flagship(torch, tds, flush, report):
    """(a) at the flagship's sites and (b): int8 and weight-only predict,
    the launches, the card against the CPU, the four rates."""
    import numpy as np
    from dl4ds_tpu_torch.ops import conv_int8 as ci
    fca = tds.fused_channel_attention
    model, net = _flagship_int8(tds)
    hr, kwargs = _phase3_grids()
    x, aux = (torch.from_numpy(a).cuda()
              for a in _served_inputs(torch, model, hr, kwargs))
    xb, ab = x[:BATCH], aux[:BATCH]
    torch.backends.cudnn.allow_tf32 = False
    qf = tds.quantize_forward(model, net, xb, ab)
    with _k7_calls() as calls:
        y_card = qf(xb, ab)
    rows = _k7_rows(torch, calls, 'flagship site', flush)
    del calls
    if qf.n_sites != sum(r['calls'] for r in rows):
        fail(f'phase 20: {qf.n_sites} sites, {len(rows)} K7 calls')
    # (b) the main path: predict(quantize=) with the counters zeroed
    batches = -(-N_GRIDS // BATCH)
    ci.conv_int8.launches = fca.launches = fca.bwd_launches = 0
    y8 = tds.predict((model, net), hr, quantize='int8', **kwargs)
    k7, k1 = ci.conv_int8.launches, fca.launches
    ci.conv_int8.launches = fca.launches = 0
    yw = tds.predict((model, net), hr, quantize='weight-only', **kwargs)
    k7_w, k1_w = ci.conv_int8.launches, fca.launches
    want_k1 = len(K1_SHAPES) * (batches + 1)      # the calibration forward
    print(f'phase 20 (b): flagship predict(quantize=\'int8\') output '
          f'{y8.shape}, {qf.n_sites} sites; K7 {k7} launches (expected '
          f'{qf.n_sites * batches}: the sites a batch), K1 {k1} (expected '
          f'{want_k1}: 7 a batch and 7 in the calibration forward), K1 '
          f'backward {fca.bwd_launches}; weight-only: K7 {k7_w} (expected '
          f'0), K1 {k1_w}', flush=True)
    if (k7 != qf.n_sites * batches or k1 != want_k1 or fca.bwd_launches
            or k7_w != 0 or k1_w != want_k1 or y8.shape != yw.shape
            or not np.isfinite(y8).all() or not np.isfinite(yw).all()):
        fail(f'phase 20 (b): launches K7 {k7}/{k7_w}, K1 {k1}/{k1_w}')
    y_f = tds.predict((model, net), hr, **kwargs)
    _held(y8[:BATCH], y_card.float().cpu().numpy(), 'phase 20 (b): predict('
          'quantize=\'int8\') against the quantized forward on its first '
          'batch')
    traced = _int8_forward_launches(torch, qf, (xb, ab), '(b)')
    cmp = _card_vs_cpu(torch, tds, model, net, qf, (xb, ab), y8[:1],
                       '(b)')
    print(f'phase 20 (b): weight-only vs float32 on the card rel '
          f'{_rel_err_q(yw, y_f):.4f}, int8 {_rel_err_q(y8, y_f):.4f}',
          flush=True)
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    m16, n16 = _flagship_int8(tds, dtype=torch.bfloat16)
    n16.load_state_dict(net.state_dict())
    # the same flagship in bfloat16: its sites' K7 calls (bfloat16 inputs,
    # and float32 ones where the network hands a site float32, which K7
    # rounds to bfloat16 first) held and timed, one kernel a site in a
    # trace, and predict(quantize='int8')'s launches
    qf16 = tds.quantize_forward(m16, n16, xb, ab)
    with _k7_calls() as calls:
        y_card16 = qf16(xb, ab)
    rows16 = _k7_rows(torch, calls, 'bfloat16 flagship site', flush)
    n_bf16 = sum(c[0].dtype == torch.bfloat16 for c in calls)
    del calls
    if (qf16.n_sites != sum(r['calls'] for r in rows16)
            or n_bf16 == 0
            or any(r['out_dtype'] != 'bfloat16' for r in rows16)):
        fail(f'phase 20 (b) bfloat16: {qf16.n_sites} sites, '
             f'{sum(r["calls"] for r in rows16)} K7 calls, {n_bf16} of them '
             f'on a bfloat16 input')
    traced16 = _int8_forward_launches(torch, qf16, (xb, ab), '(b) bfloat16')
    ci.conv_int8.launches = 0
    y16 = tds.predict((m16, n16), hr, quantize='int8', **kwargs)
    k7_16 = ci.conv_int8.launches
    print(f'phase 20 (b): bfloat16 flagship predict(quantize=\'int8\') '
          f'output {y16.shape}, {qf16.n_sites} sites ({n_bf16} on a bfloat16 '
          f'input); K7 {k7_16} launches (expected {qf16.n_sites * batches}); '
          f'int8 vs float32 on the card rel {_rel_err_q(y16, y_f):.4f}',
          flush=True)
    if (k7_16 != qf16.n_sites * batches or y16.shape != y8.shape
            or not np.isfinite(y16).all()):
        fail(f'phase 20 (b) bfloat16: K7 {k7_16} launches, output '
             f'{y16.shape}')
    _held(y16[:BATCH], y_card16.float().cpu().numpy(), 'phase 20 (b): '
          'bfloat16 predict(quantize=\'int8\') against the quantized '
          'forward on its first batch')
    rates = _rates(torch, tds, {'int8': (model, net, 'int8'),
                                'weight-only': (model, net, 'weight-only'),
                                'f32': (model, net, None),
                                'bf16': (m16, n16, None)},
                   hr, kwargs, f'flagship, width {N_FILTERS}')
    qw = tds.quantize_forward(model, net, xb, ab, mode='weight-only')
    fwd = _forward_ms(torch, {'int8': lambda: qf(xb, ab),
                              'weight-only': lambda: qw(xb, ab),
                              'f32': lambda: net(xb, ab),
                              'bf16': lambda: n16(xb, ab),
                              'int8 bf16': lambda: qf16(xb, ab)})
    print(f'phase 20 (b): forward at batch {BATCH} (CUDA events) '
          + ', '.join(f'{m} {v:.3f} ms' for m, v in fwd.items())
          + f'; {card_line()}', flush=True)
    report['quant'] = dict(
        k7_launches=k7, k1_launches=k1, n_sites=qf.n_sites, **traced,
        **cmp,
        int8_vs_f32=_rel_err_q(y8, y_f), weight_only_vs_f32=_rel_err_q(yw, y_f),
        rates_w8=rates, forward_ms_w8=fwd, y8=y8, calibration=(xb, ab),
        bf16_k7_launches=k7_16, bf16_n_sites=qf16.n_sites,
        bf16_int8_vs_f32=_rel_err_q(y16, y_f),
        **{f'bf16_{k}': v for k, v in traced16.items()})
    report['k7_rows'] = rows
    report['k7_bf16_rows'] = rows16
    return model, net, hr, kwargs


def _quant_wide(torch, tds, flush, report):
    """(c): the flagship at width 64, its sites held and timed, the four
    rates."""
    from dl4ds_tpu_torch.ops import conv_int8 as ci
    model, net = _flagship_int8(tds, width=Q_WIDE)
    m16, n16 = _flagship_int8(tds, width=Q_WIDE, dtype=torch.bfloat16)
    n16.load_state_dict(net.state_dict())
    hr, kwargs = _phase3_grids()
    x, aux = (torch.from_numpy(a).cuda() for a in _served_inputs(
        torch, model, hr[:BATCH], dict(kwargs, predictors=[
            kwargs['predictors'][0][:BATCH]])))
    qf = tds.quantize_forward(model, net, x, aux)
    with _k7_calls() as calls:
        qf(x, aux)
    _k7_rows(torch, calls, f'width-{Q_WIDE} flagship site')
    del calls
    ci.conv_int8.launches = 0
    tds.predict((model, net), hr, quantize='int8', **kwargs)
    k7 = ci.conv_int8.launches
    if k7 != qf.n_sites * -(-N_GRIDS // BATCH):
        fail(f'phase 20 (c): K7 {k7} launches, {qf.n_sites} sites a batch')
    rates = _rates(torch, tds, {'int8': (model, net, 'int8'),
                                'weight-only': (model, net, 'weight-only'),
                                'f32': (model, net, None),
                                'bf16': (m16, n16, None)},
                   hr, kwargs, f'flagship, width {Q_WIDE}')
    qw = tds.quantize_forward(model, net, x, aux, mode='weight-only')
    fwd = _forward_ms(torch, {'int8': lambda: qf(x, aux),
                              'weight-only': lambda: qw(x, aux),
                              'f32': lambda: net(x, aux),
                              'bf16': lambda: n16(x, aux)})
    print(f'phase 20 (c): width {Q_WIDE}, K7 {k7} launches in predict; '
          f'forward at batch {BATCH} (CUDA events) '
          + ', '.join(f'{m} {v:.3f} ms' for m, v in fwd.items())
          + f'; {card_line()}', flush=True)
    report['quant'].update(k7_launches_w64=k7, rates_w64=rates,
                           forward_ms_w64=fwd, n_sites_w64=qf.n_sites)


def _quant_recurrent(torch, tds, flush, report):
    """(d): recresnet_spc int8 predict on phase 5's grids: K2's inference
    launches, K7's, one window against the CPU."""
    import numpy as np
    from dl4ds_tpu_torch.ops import conv_int8 as ci
    fcl = tds.fused_convlstm
    model = tds.recnet_postupsampling(
        'resnet', 'spc', scale=SCALE, n_channels=2, n_aux_channels=2,
        lr_size=(LR, LR), time_window=REC_T, n_filters=N_FILTERS,
        n_blocks=REC_BLOCKS)
    net = model.init(seed=0, device='cuda')
    rng = np.random.default_rng(1)
    hr_size = LR * SCALE
    hr = rng.standard_normal((REC_GRIDS, hr_size, hr_size)).astype('float32')
    topo = rng.standard_normal((hr_size, hr_size)).astype('float32')
    mask = (rng.random((hr_size, hr_size)) > 0.5).astype('float32')
    pred = rng.standard_normal((REC_GRIDS, hr_size, hr_size, 1)).astype(
        'float32')
    kwargs = dict(scale=SCALE, time_window=REC_T, static_vars=[topo, mask],
                  predictors=[pred], batch_size=BATCH)
    batches = -(-(REC_GRIDS - REC_T + 1) // BATCH)
    torch.backends.cudnn.allow_tf32 = False
    ci.conv_int8.launches = fcl.launches = 0
    y8 = tds.predict((model, net), hr, quantize='int8', **kwargs)
    k7, k2 = ci.conv_int8.launches, fcl.launches
    from dl4ds_tpu_torch.inference import _assemble_inputs
    x, aux, _ = _assemble_inputs(model, hr, SCALE, True, [topo, mask],
                                 [pred], REC_T, 'inter_area',
                                 torch.device('cuda', 0))
    qf = tds.quantize_forward(model, net, x[:BATCH], aux[:BATCH])
    want_k2 = len(K2_LAYERS) * REC_T * (batches + 1)
    print(f'phase 20 (d): recresnet_spc predict(quantize=\'int8\', '
          f'time_window={REC_T}) output {y8.shape}, {qf.n_sites} sites; K7 '
          f'{k7} launches (expected {qf.n_sites * batches}), K2 inference '
          f'{k2} (expected {want_k2}: {len(K2_LAYERS) * REC_T} a batch and as '
          f'many in the calibration forward)', flush=True)
    if (k7 != qf.n_sites * batches or k2 != want_k2
            or not np.isfinite(y8).all()):
        fail(f'phase 20 (d): launches K7 {k7}, K2 {k2}')
    with _k7_calls() as calls:
        y_card = qf(x[:BATCH], aux[:BATCH])
    _k7_rows(torch, calls, 'recresnet_spc site')
    del calls
    cmp = _card_vs_cpu(torch, tds, model, net, qf,
                       (x[:BATCH], aux[:BATCH]), y_card[:1].cpu().numpy(),
                       '(d)')
    t0 = time.perf_counter()
    tds.predict((model, net), hr, quantize='int8', **kwargs)
    rate = REC_GRIDS / (time.perf_counter() - t0)
    report['quant'].update(rec_k7_launches=k7, rec_k2_launches=k2,
                           **{f'rec_{k}': v for k, v in cmp.items()},
                           rec_grids_per_s=rate, rec_n_sites=qf.n_sites)


def _quant_tiled(torch, tds, flush, report):
    """(e): the flagship int8 and tiled on one 0.25-degree global grid."""
    import numpy as np
    from dl4ds_tpu_torch.ops import conv_int8 as ci
    h, w = TILED_GRID
    hr = np.random.default_rng(18).standard_normal(
        (1, h * SCALE, w * SCALE)).astype('float32')
    model = tds.net_postupsampling(
        'resnet', 'spc', scale=SCALE, n_channels=1, n_aux_channels=0,
        lr_size=TILED_GRID, n_filters=N_FILTERS, n_blocks=N_BLOCKS,
        attention=True)
    net = model.init(seed=0, device='cuda')
    kwargs = dict(scale=SCALE, array_in_hr=True, tile=TILE, halo=TILE_HALO,
                  batch_size=BATCH)
    n_win = (-(-h // TILE)) * (-(-w // TILE))
    dispatches = -(-n_win // BATCH)
    ci.conv_int8.launches = 0
    y = tds.predict((model, net), hr, quantize='int8', **kwargs)
    k7 = ci.conv_int8.launches
    win = torch.randn((BATCH, TILE_WINDOW, TILE_WINDOW, 1), device='cuda')
    qf = tds.quantize_forward(model, net, win)
    if (k7 != qf.n_sites * dispatches or not np.isfinite(y).all()
            or y.shape != (1, h * SCALE, w * SCALE, 1)):
        fail(f'phase 20 (e): tiled int8 output {y.shape}, K7 {k7} launches, '
             f'{qf.n_sites} sites x {dispatches} dispatches expected')
    t0 = time.perf_counter()
    tds.predict((model, net), hr, quantize='int8', **kwargs)
    rate = 1 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    tds.predict((model, net), hr, **kwargs)
    rate_f32 = 1 / (time.perf_counter() - t0)
    with _k7_calls() as calls:
        qf(win)
    _k7_rows(torch, calls, 'tiled window site')
    del calls
    print(f'phase 20 (e): tiled int8 flagship on a {h}x{w} grid -> '
          f'{y.shape}: {n_win} windows in {dispatches} dispatches, K7 {k7} '
          f'launches ({qf.n_sites} a dispatch); {rate:.4f} grids/s int8, '
          f'{rate_f32:.4f} float32 (TF32 off; host clock, one call each); '
          f'{card_line()}', flush=True)
    report['quant'].update(tiled_k7_launches=k7, tiled_grids_per_s=rate,
                           tiled_f32_grids_per_s=rate_f32,
                           tiled_dispatches=dispatches)


def _quant_artifact(torch, tds, model, net, report):
    """(f): an int8 artifact at batch 8 on (b)'s calibration batch, served
    by ModelServer in process: K7 and K1 launches a device batch, the
    output against (b)'s predict."""
    import tempfile
    import numpy as np
    from dl4ds_tpu_torch.ops import conv_int8 as ci
    from dl4ds_tpu_torch.serve import ModelServer
    fca = tds.fused_channel_attention
    xb, ab = report['quant']['calibration']
    y8 = report['quant']['y8']
    n_sites = report['quant']['n_sites']
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / 'int8'
        t0 = time.perf_counter()
        tds.save_serving_artifact(model, net, str(path), batch=BATCH,
                                  quantize='int8', calibration=xb,
                                  calibration_aux=ab)
        export_s = time.perf_counter() - t0
        ep = torch.export.load(str(path / 'forward.pt2'))
        nodes = [str(n.target) for n in ep.graph.nodes
                 if n.op == 'call_function']
        k7_nodes = nodes.count('dl4ds_tpu_torch.conv_int8.default')
        k1_nodes = nodes.count(K1_OP)
        srv = ModelServer(str(path))
        x, aux = xb.cpu().numpy(), ab.cpu().numpy()
        counts = []
        for n in (BATCH, 1):
            ci.conv_int8.launches = fca.launches = 0
            y = srv.predict(x[:n], aux[:n])
            counts.append((ci.conv_int8.launches, fca.launches))
            _held(y, y8[:n], f'phase 20 (f): int8 artifact at batch {n} '
                  f'against predict(quantize=\'int8\')')
        info = srv.health()
        call, _ = tds.load_serving_artifact(str(path))
        call_ms = statistics.median(device_times(torch, lambda: call(xb, ab),
                                                 reps=10))
    print(f'phase 20 (f): int8 artifact at batch {BATCH}: {k7_nodes} '
          f'conv_int8 and {k1_nodes} channel_attention nodes, exported and '
          f'saved in {export_s:.1f} s; ModelServer (quantize '
          f'{info["quantize"]!r}) K7/K1 launches a device batch {counts} '
          f'(requests of {BATCH} and 1), output within {SERVE_REL} of max|y| '
          f'of predict; a call {call_ms:.3f} ms (CUDA events); {card_line()}',
          flush=True)
    if (k7_nodes != n_sites or k1_nodes != len(K1_SHAPES)
            or any(c != (n_sites, len(K1_SHAPES)) for c in counts)
            or info['quantize'] != 'int8'):
        fail(f'phase 20 (f): nodes K7 {k7_nodes} K1 {k1_nodes}, launches '
             f'{counts}, quantize {info["quantize"]!r}')
    report['quant'].update(artifact_k7_launches=sum(c[0] for c in counts),
                           artifact_call_ms=call_ms,
                           artifact_export_s=export_s)


def _quant_extra_sites(torch, flush, report):
    """(a)'s sites beyond the models' (Q_EXTRA_SITES), each held and timed
    as a site calls it: a seeded normal input (a float one quantized at
    the scale of its absmax, with a bias in its dtype; int8 codes summed
    in int32), seeded weight codes."""
    from dl4ds_tpu_torch.ops import conv_int8 as ci
    gen = torch.Generator(device='cuda').manual_seed(20)
    calls = []
    for xs, ws, stride, dil, pads, groups, x_dtype, c0 in \
            Q_EXTRA_SITES.values():
        dtype = getattr(torch, x_dtype)
        wq = torch.randint(-127, 128, ws, generator=gen, device='cuda',
                           dtype=torch.int32).to(torch.int8)
        scale = torch.rand(ws[0], generator=gen, device='cuda') * 1e-4
        if dtype == torch.int8:
            x = torch.randint(-127, 128, xs, generator=gen, device='cuda',
                              dtype=torch.int32).to(torch.int8)
            s_x = bias = None
            made = torch.int32
        else:
            x = torch.randn(xs, generator=gen, device='cuda').to(dtype)
            s_x = x.abs().max().float() / 127
            bias = torch.randn(ws[0], generator=gen, device='cuda').to(dtype)
            made = dtype
        if c0 is not None:
            x = x[..., c0:c0 + ws[1]]
        calls.append((x, ci.pack_weight(wq, groups, stride, dil), scale,
                      ws[2], ws[3], stride, dil, pads, groups, made, s_x,
                      bias))
    report['k7_extra_rows'] = _k7_rows(torch, calls, 'extra site', flush)


def _k7_routes(rows):
    """Fail unless the dense kernel's launches in `rows` (each with its
    `launch_plan`) took every route of K7_ROUTES between them."""
    plans = [r['plan'] for r in rows if r['groups'] == 1]
    seen = {k: sorted({p[k] for p in plans}) for k in K7_ROUTES}
    seen['unit'] = sorted({p['unit'] for p in plans if p['load'] == 1})
    seen['stages'] = sorted({p['stages'] for p in plans})
    missing = {k: sorted(v - set(seen[k])) for k, v in K7_ROUTES.items()
               if v - set(seen[k])}
    print(f'phase 20 (a): the dense K7 launches of {len(plans)} distinct '
          f'sites took the routes {seen}; every one of {K7_ROUTES} '
          f'required', flush=True)
    if missing:
        fail(f'phase 20 (a): no checked K7 launch took the routes {missing}')
    return seen


def phase_quantization(torch, tds, report):
    """Phase 20: int8 post-training quantization on the card."""
    parts = {}
    t0 = time.perf_counter()

    def done(name):
        nonlocal t0
        parts[name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device='cuda')
    model, net, _, _ = _quant_flagship(torch, tds, flush, report)
    done('a, b')
    _quant_extra_sites(torch, flush, report)
    report['quant']['k7_routes'] = _k7_routes(
        report['k7_rows'] + report['k7_bf16_rows'] + report['k7_extra_rows'])
    done('a extra')
    _quant_wide(torch, tds, flush, report)
    done('c')
    _quant_recurrent(torch, tds, flush, report)
    done('d')
    _quant_tiled(torch, tds, flush, report)
    done('e')
    _quant_artifact(torch, tds, model, net, report)
    done('f')
    torch.backends.cudnn.allow_tf32 = True
    q = report['quant']
    q.pop('y8')
    q.pop('calibration')
    r8, r64 = (q[k]['int8'] / q[k]['bf16'] for k in ('rates_w8', 'rates_w64'))
    print(f'phase 20: int8 / bfloat16 predict rate {r8:.3f} at width '
          f'{N_FILTERS}, {r64:.3f} at width {Q_WIDE} (the narrow-width '
          f'warning of quantization.py states these); {card_line()}',
          flush=True)
    print(f'phase 20 parts (s): {parts}', flush=True)


def _quant_kernel_rows(report):
    """The `kernels` line's row of phase 20: K7, its launches those of the
    main path's run (the flagship's predict(quantize='int8')) and, beside
    them, of the other int8 paths; its times the sum over one flagship
    forward's K7 calls (each distinct site timed, times its calls)."""
    q, rows = report['quant'], report['k7_rows']
    t = _k7_totals(rows)
    return [dict(
        name='K7_conv_int8', route='cuda',
        source='dl4ds_tpu_torch/csrc/conv_int8.cu',
        sources=['dl4ds_tpu_torch/csrc/conv_int8.cu',
                 'dl4ds_tpu_torch/csrc/s8_mma.cuh'],
        replaces='dl4ds_tpu/quantization.py:276 (XLA\'s s8 convolution in '
                 'the int8 replay; no Pallas kernel)',
        launches=q['k7_launches'],
        int8_forward_device_kernels=q['int8_forward_kernels'],
        launches_other_paths={
            f'width-{Q_WIDE} predict': q['k7_launches_w64'],
            'recresnet_spc predict': q['rec_k7_launches'],
            'tiled global grid': q['tiled_k7_launches'],
            'artifact via ModelServer': q['artifact_k7_launches']},
        max_abs_err=0.0, ms=t['ms'], plain_ms=t['plain_ms'],
        bound_ms=t['bound_ms'], bound_old_ms=t['bound_old_ms'],
        bound_by=('operations' if t['bound_ops_ms'] > t['bound_bytes_ms']
                  else 'bytes'),
        library_ms=t['library_ms'], unfold_ms=t['unfold_ms'],
        cudnn_bf16_ms=t['cudnn_bf16_ms'],
        work=f'the {q["n_sites"]} int8 sites of one flagship forward at '
             f'batch {BATCH} (phase 3\'s grids), each one fused launch (the '
             f'codes of the float input, the sums, the rescale and the '
             f'bias), {len(rows)} distinct shapes timed and summed over '
             f'their calls; launches of predict(quantize=\'int8\') on '
             f'{N_GRIDS} grids; bound_ms reads the float input once, '
             f'bound_old_ms its int8 codes (the unfused form); library_ms '
             f'torch._int_mm on each site\'s unfolded matrix of codes '
             f'(unfold_ms beside), cudnn_bf16_ms the bfloat16 float path at '
             f'the same sites; max_abs_err 0: the fused float32 and '
             f'bfloat16 outputs and the int32 sums of the codes equal the '
             f'plain version at every call of the flagship forward and at '
             f'the extra sites, the outputs in the model dtype at every '
             f'call of the width-{Q_WIDE}, recurrent and tiled forwards')]


# phase 21: the flagship through the command-line app. The data module
# holds phase 10's data (TRAIN_GRIDS seeded grids, validation and test the
# first 64) and CLI_GRIDS HR inference grids; `--debug` is the app's 2
# epochs of 6 steps with 6 validation and 6 test steps
# (dl4ds_tpu_torch/app.py); the int8 artifact serves CLI_EXPORT_BATCH of
# the inference inputs; (c) counts FLOPs at CLI_COUNT_BATCH on the card and
# on the CPU
CLI_GRIDS, CLI_EXPORT_BATCH, CLI_COUNT_BATCH = 16, 8, 16
CLI_EPOCHS, CLI_STEPS = 2, 6
TF32_FLOPS = 495e12             # H100 SXM dense TF32 on the tensor cores
CLI_DATA_MODULE = f"""import numpy as np
_all = np.random.default_rng(0).standard_normal(
    ({TRAIN_GRIDS}, {TRAIN_HR}, {TRAIN_HR}, 1)).astype('float32')
data_train = _all
data_val = data_test = _all[:64]
data_train_lr = data_val_lr = data_test_lr = None
predictors_train = predictors_val = predictors_test = None
static_vars = None
inference_data = np.random.default_rng(21).standard_normal(
    ({CLI_GRIDS}, {TRAIN_HR}, {TRAIN_HR}, 1)).astype('float32')
inference_scaler = None
inference_predictors = None
gt_holdout_dataset = inference_data
gt_mask = None
"""


def _cli_flags(root):
    """The flag-file lines phase 21's runs share: the flagship at full
    width (bench.py's), trained with --debug, served on the HR inference
    grids, no metrics phase (it draws with matplotlib)."""
    return [f'--device=GPU', f'--data_module={root}/cli_data.py',
            '--backbone=resnet', '--upsampling=spc', f'--scale={SCALE}',
            '--attention', f'--n_filters={N_FILTERS}',
            f'--n_blocks={N_BLOCKS}', f'--patch_size={TRAIN_PATCH}',
            f'--batch_size={TRAIN_BATCH}', f'--loss={FLAG_LOSS}', '--debug',
            '--inference_array_in_hr', f'--save_path={root}/results/',
            '--nometrics']


def _cli_step_flops(torch, tds, count_flops, config, device):
    """count_flops of one eager training step at CLI_COUNT_BATCH of a
    trainer of `config` on `device` (seeded weights and batch)."""
    tr = tds.SupervisedTrainer(batch_size=CLI_COUNT_BATCH, epochs=1,
                               device=device, **config)
    tr.setup_datagen()
    tr.setup_model()
    tr.setup_optimizer()
    tr.net.train()
    gen = torch.Generator().manual_seed(3)
    batch = tr.ds_train(tr.ds_train.epoch_indices(gen, steps=1)[0],
                        generator=gen)
    return count_flops(tr.train_step, batch)


def phase_cli(torch, tds, report):
    """Phase 21: (a) the flagship through `app.main(argv)` with a flag
    file, under the launch counters and torch.profiler: the launches of
    the training graphs, the test phase and the int8 export's calibration,
    finite losses, the test phase's y_hat.npy against `predict` of the
    saved model, the int8 artifact's call (K7 at every site, held and
    timed) against `predict(quantize='int8')`; (b) `python -m
    dl4ds_tpu_torch.app` on the saved model in a subprocess, its y_hat.npy
    equal to (a)'s; (c) `count_flops` of the flagship's step and batch-8
    forward and of recresnet_spc's step on the card and on the CPU, equal,
    and the flagship step's FLOP/s at batch 128 on one replay."""
    import tempfile
    import numpy as np
    from dl4ds_tpu_torch import app
    from dl4ds_tpu_torch.inference import _assemble_inputs
    from dl4ds_tpu_torch.ops import conv_int8 as ci
    from dl4ds_tpu_torch.ops.flops import count_flops
    from dl4ds_tpu_torch.serve import ModelServer
    fca, ssim = tds.fused_channel_attention, tds.fused_ssim_per_image
    # PyTorch's defaults, which the subprocess of (b) runs with
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    repo = Path(__file__).resolve().parent
    dev = torch.device('cuda')
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    grids = np.random.default_rng(21).standard_normal(
        (CLI_GRIDS, TRAIN_HR, TRAIN_HR, 1)).astype('float32')
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / 'cli_data.py').write_text(CLI_DATA_MODULE)
        train_cfg = root / 'train.cfg'
        train_cfg.write_text('\n'.join(
            ['# phase 21 (a): train, test, export'] + _cli_flags(root)
            + ['--inference_save_fname=y_hat.npy',
               f'--export_artifact={root}/artifact',
               '--export_quantize=int8',
               f'--export_batch={CLI_EXPORT_BATCH}']) + '\n')
        # (a) in process, every counter at 0 just before and read after
        counters = _counters(tds)
        for _, fn, attr in counters:
            setattr(fn, attr, 0)
        ci.conv_int8.launches = 0
        with _device_trace(torch) as prof:
            t0 = time.perf_counter()
            tr = app.main(['dl4ds_tpu_torch.app', f'--flagfile={train_cfg}'])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        calls = {name: getattr(fn, attr) for name, fn, attr in counters}
        k7_run = ci.conv_int8.launches
        gates = len(K1_TRAIN_SHAPES)
        per_step = _flagship_per_step(gates)
        # eager: the test phase's predict (one batch) and the int8
        # export's calibration forward, a forward's gates each
        got = _check_launches(
            tds, tr.runner, 'phase 21 (a)', per_step,
            {'step': CLI_EPOCHS * CLI_STEPS, 'val': CLI_EPOCHS * CLI_STEPS,
             'test': CLI_STEPS}, calls, _device_kernels(torch, prof),
            outside={'K1': 2 * gates})
        losses = tr.fithist['loss'] + tr.fithist['val_loss'] + [tr.test_loss]
        patches = CLI_EPOCHS * CLI_STEPS * TRAIN_BATCH
        print(f'phase 21 (a): app.main on the flag file: {tr.model.name}, '
              f'{tr.model.param_count(tr.net)} parameters, {CLI_EPOCHS} '
              f'epochs of {CLI_STEPS} steps at batch {TRAIN_BATCH}, test, '
              f'int8 export in {run_s:.2f} s under torch.profiler '
              f'({patches / run_s:.1f} training patches/s over the whole '
              f'command, host clock); history {tr.fithist}, test loss '
              f'{tr.test_loss:.6f}; K7 launches in the run {k7_run}; '
              f'{card_line()}', flush=True)
        if not all(np.isfinite(v) for v in losses) or k7_run:
            fail(f'phase 21 (a): losses {losses}, K7 launches {k7_run}')
        y_a = np.load(root / 'results' / 'y_hat.npy')
        saved = str(root / 'results' / f'{tr.model.name}')
        model, net = pair = tds.load_model(saved)
        fca.launches = 0
        want = tds.predict(pair, grids, scale=SCALE, array_in_hr=True,
                           batch_size=TRAIN_BATCH)
        if fca.launches != gates or not np.isfinite(y_a).all():
            fail(f'phase 21 (a): predict of the saved model launched K1 '
                 f'{fca.launches} times, y_hat finite '
                 f'{np.isfinite(y_a).all()}')
        if y_a.shape != want.shape or not np.array_equal(y_a, want):
            fail(f'phase 21 (a): y_hat.npy {y_a.shape} differs from predict '
                 f'of the saved model {want.shape} by max|d| '
                 f'{np.abs(y_a - want).max() if y_a.shape == want.shape else None}')
        # the int8 artifact on the calibration batch, against predict
        cx, _, _ = _assemble_inputs(model, grids, SCALE, True, None, None,
                                    None, 'inter_area', dev)
        xb = cx[:CLI_EXPORT_BATCH]
        n_sites = tds.quantize_forward(model, net, xb).n_sites
        # calibrated on its first batch, the artifact's calibration batch
        y8 = tds.predict(pair, grids, scale=SCALE, array_in_hr=True,
                         batch_size=CLI_EXPORT_BATCH,
                         quantize='int8')[:CLI_EXPORT_BATCH]
        srv = ModelServer(str(root / 'artifact'))
        srv.predict(xb.cpu().numpy())             # warm
        ci.conv_int8.launches = fca.launches = fca.bwd_launches = 0
        with _k7_calls() as k7_calls:
            y_art = srv.predict(xb.cpu().numpy())
        k7, k1 = ci.conv_int8.launches, fca.launches
        print(f'phase 21 (a): the int8 artifact ({srv.health()["quantize"]}, '
              f'batch {srv.batch}) on {CLI_EXPORT_BATCH} grids: K7 {k7} '
              f'launches (expected {n_sites}: its sites), K1 {k1} (expected '
              f'{gates}), K1 backward {fca.bwd_launches}', flush=True)
        if k7 != n_sites or k1 != gates or fca.bwd_launches:
            fail(f'phase 21 (a): artifact launches K7 {k7}, K1 {k1}')
        _held(y_art, y8, 'phase 21 (a): the CLI\'s int8 artifact against '
              'predict(quantize=\'int8\') on the same calibration')
        rows = _k7_rows(torch, k7_calls, 'CLI artifact site', flush)
        del k7_calls

        # (b) the module entry point on the saved model, as users call it
        test_cfg = root / 'test.cfg'
        test_cfg.write_text('\n'.join(
            _cli_flags(root) + ['--inference_save_fname=y_hat_b.npy'])
            + '\n')
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, '-m', 'dl4ds_tpu_torch.app',
             f'--flagfile={test_cfg}', '--notrain',
             f'--trained_model_path={saved}', '--test', '--nometrics'],
            capture_output=True, text=True, timeout=300, cwd=str(repo),
            env=dict(os.environ, PYTHONPATH=str(repo)))
        sub_s = time.perf_counter() - t0
        if res.returncode != 0:
            fail(f'phase 21 (b): python -m dl4ds_tpu_torch.app exited '
                 f'{res.returncode}: {res.stderr[-3000:]}')
        y_b = np.load(root / 'results' / 'y_hat_b.npy')
        print(f'phase 21 (b): python -m dl4ds_tpu_torch.app --notrain '
              f'--trained_model_path on {CLI_GRIDS} grids in {sub_s:.2f} s '
              f'(a new process: import, load, predict); y_hat equal to (a)\'s '
              f'{np.array_equal(y_b, y_a)}', flush=True)
        if not np.array_equal(y_b, y_a):
            fail(f'phase 21 (b): y_hat differs from (a)\'s by max|d| '
                 f'{np.abs(y_b - y_a).max()}')

    # (c) count_flops on the card against the CPU, the kernels counted by
    # their formulas on the card and their plain versions hidden on the CPU
    flag = _training_config(loss=FLAG_LOSS, n_filters=N_FILTERS,
                            n_blocks=N_BLOCKS, attention=True)
    rec = _training_config(loss='mae', time_window=REC_T,
                           n_blocks=REC_BLOCKS, n_filters=N_FILTERS)
    cpu_net = copy.deepcopy(net).cpu()
    counts = {}
    for name, fn in (
            ('flagship step', lambda d: _cli_step_flops(
                torch, tds, count_flops, flag, d)),
            (f'flagship forward at batch {CLI_EXPORT_BATCH}', lambda d: (
                count_flops(net, xb, None) if d == 'cuda'
                else count_flops(cpu_net, xb.cpu(), None))),
            ('recresnet_spc step', lambda d: _cli_step_flops(
                torch, tds, count_flops, rec, d))):
        counts[name] = {d: fn(d) for d in ('cuda', 'cpu')}
    print(f'phase 21 (c): count_flops on the card and on the CPU (batch '
          f'{CLI_COUNT_BATCH} steps): {counts}', flush=True)
    if any(c['cuda'] != c['cpu'] or not c['cuda'] > 0
           for c in counts.values()):
        fail(f'phase 21 (c): the counts differ by device: {counts}')
    # the flagship step at batch 128 against one replay of (a)'s graph
    gen = torch.Generator().manual_seed(7)
    tr.runner.train(tr.ds_train.plan(gen, CLI_STEPS))
    graph = tr.runner.graphs['step']

    def replay():
        tr._row.zero_()
        graph.replay()
    replay_ms = statistics.median(device_times(torch, replay, reps=10))
    one = tr.ds_train(tr.ds_train.epoch_indices(gen, steps=1)[0],
                      generator=gen)
    step_flops = count_flops(tr.train_step, one)
    rate = step_flops / (replay_ms * 1e-3)
    print(f'phase 21 (c): the flagship {FLAG_LOSS} step at batch '
          f'{TRAIN_BATCH}: {step_flops:.6e} FLOPs (count_flops); one replay '
          f'{replay_ms:.4f} ms (CUDA events): {rate / 1e12:.4f} TFLOP/s, '
          f'{100 * rate / F32_FLOPS:.3f}% of the {F32_FLOPS / 1e12:.0f} '
          f'TFLOP/s float32 peak ({100 * rate / TF32_FLOPS:.3f}% of TF32\'s '
          f'{TF32_FLOPS / 1e12:.0f}); {card_line()}', flush=True)
    out.update(run_s=run_s, patches_per_s=patches / run_s,
               launches=got, wrapper_calls=calls, losses=losses,
               artifact_k7_launches=k7, artifact_k1_launches=k1,
               n_sites=n_sites, subprocess_s=sub_s, flop_counts=counts,
               step_flops=step_flops, replay_ms=replay_ms,
               tflops=rate / 1e12, f32_peak_share=rate / F32_FLOPS,
               tf32_peak_share=rate / TF32_FLOPS, k7_rows=rows)
    report['cli'] = out


def _cli_kernel_rows(report):
    """The `kernels` line's rows of phase 21: K1 and K6 in the CLI's
    training (launches from its device trace, times those of phase 10's
    gates and phase 9's DSSIM shape, the same shapes), and K7 in the CLI's
    int8 artifact (launches of one call, its sites held and timed here)."""
    cli, gates, k6 = report['cli'], report['k1_train_rows'], \
        report['k6_rows'][0]
    t = _k7_totals(cli['k7_rows'])
    k1 = dict(name='K1_channel_attention_cli_train', route='cuda',
              source='dl4ds_tpu_torch/csrc/channel_attention.cu',
              replaces='dl4ds_tpu/ops/pallas_ops.py:39',
              launches=cli['launches']['K1'],
              wrapper_calls=cli['wrapper_calls']['K1'],
              max_abs_err=max(r['max_abs_err'] for r in gates),
              ms=sum(r['ms'] for r in gates),
              plain_ms=sum(r['plain_ms'] for r in gates),
              bound_ms=sum(r['bound_ms'] for r in gates), bound_by='bytes',
              library_ms=None, bwd_ms=sum(r['bwd_ms'] for r in gates),
              bwd_bound_ms=sum(r['bwd_bound_ms'] for r in gates),
              bwd_plain_ms=sum(r['bwd_plain_ms'] for r in gates),
              bwd_launches=cli['launches']['K1 backward'],
              bwd_wrapper_calls=cli['wrapper_calls']['K1 backward'],
              work='the gates of one flagship training step at batch '
                   f'{TRAIN_BATCH} (phase 10\'s shapes and times); launches '
                   'of `python -m dl4ds_tpu_torch.app`\'s run in process '
                   '(app.main): training graphs, test predict, int8 '
                   'calibration')
    k6_row = dict(name='K6_ssim_cli_train', route='cuda',
                  source='dl4ds_tpu_torch/csrc/ssim.cu',
                  replaces='dl4ds_tpu/ops/pallas_ops.py:145',
                  launches=cli['launches']['K6'],
                  wrapper_calls=cli['wrapper_calls']['K6'],
                  max_abs_err=k6['max_abs_err'], ms=k6['ms'],
                  plain_ms=k6['plain_ms'], bound_ms=k6['bound_ms'],
                  bound_by=k6['bound_by'], library_ms=None,
                  bwd_ms=k6['bwd_ms'], bwd_bound_ms=k6['bwd_bound_ms'],
                  bwd_plain_ms=k6['bwd_plain_ms'],
                  bwd_launches=cli['launches']['K6 backward'],
                  bwd_wrapper_calls=cli['wrapper_calls']['K6 backward'],
                  work=f'the {FLAG_LOSS} loss of the CLI\'s flagship '
                       f'training (phase 9\'s shape and times)')
    k7 = dict(name='K7_conv_int8_cli_artifact', route='cuda',
              source='dl4ds_tpu_torch/csrc/conv_int8.cu',
              replaces='dl4ds_tpu/quantization.py:276 (XLA\'s s8 '
                       'convolution in the int8 replay; no Pallas kernel)',
              launches=cli['artifact_k7_launches'], max_abs_err=0.0,
              ms=t['ms'], plain_ms=t['plain_ms'], bound_ms=t['bound_ms'],
              bound_by=('operations' if t['bound_ops_ms'] > t['bound_bytes_ms']
                        else 'bytes'),
              library_ms=t['library_ms'], unfold_ms=t['unfold_ms'],
              cudnn_bf16_ms=t['cudnn_bf16_ms'],
              work=f'the {cli["n_sites"]} sites of one call of the CLI\'s '
                   f'int8 artifact at batch {CLI_EXPORT_BATCH} '
                   f'({TRAIN_HR // SCALE}x{TRAIN_HR // SCALE} LR), '
                   f'{len(cli["k7_rows"])} distinct shapes held (int32 '
                   'sums and outputs equal the plain version) and timed, '
                   'summed over their calls')
    return [k1, k6_row, k7]


# phase 22: data parallelism over processes at world size 1
DP_STEPS, DP_REC_STEPS = 10, 5      # steps an epoch of each pair of runs
DP_REPLAYS = 20                     # replays timed a graph (CUDA events)
DP_BN_RTOL = 1e-6                   # a bn run that is not bit for bit


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _state_of(tr):
    """Every parameter and buffer of a trained network, on the CPU."""
    return {n: t.detach().cpu() for n, t in
            list(tr.train_net.named_parameters())
            + list(tr.train_net.named_buffers())}


def _short_name(name):
    """A device kernel's name without its return type, template arguments
    and parameters."""
    name = re.sub(r'^void ', '', name).replace('(anonymous namespace)::', '')
    depth, out = 0, []
    for ch in name:
        if ch in '<(':
            if ch == '(' and depth == 0 and out:
                break
            depth += 1
        elif ch in '>)':
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return ''.join(out).strip() or name


def _kernel_names(torch, graph, tr):
    """{short device kernel name: launches} of one replay of `graph`."""
    import collections
    tr._row.zero_()
    graph.replay()
    with _device_trace(torch) as prof:
        tr._row.zero_()
        graph.replay()
    return collections.Counter(_short_name(e.name)
                               for e in _device_kernels(torch, prof))


def _dp_pair(torch, tds, mesh, config, label, steps, per_step, rtol=0.0):
    """The same run without a mesh and with `mesh` (NCCL, world size 1),
    from one seed, each traced with every launch counter at 0 just before
    (`_traced_run`) and its launches held against `per_step`: fithist,
    test_loss and every parameter and buffer must be equal bit for bit,
    or, with `rtol`, within it (the max |d| printed either way); then the
    collective's device work (the kernels one replay of the mesh step
    runs beyond the plain step's) and both replays' times."""
    import numpy as np
    runs = {}
    for name, m in (('plain', None), ('mesh', mesh)):
        tr = tds.SupervisedTrainer(
            batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
            steps_per_epoch=steps, validation_steps=TRAIN_VAL_STEPS,
            test_steps=TRAIN_TEST_STEPS, mesh=m, **config)
        run_s, calls, kernels = _traced_run(torch, tds, tr)
        got = _check_launches(
            tds, tr.runner, f'phase 22 ({label}, {name})', per_step,
            {'step': TRAIN_EPOCHS * steps,
             'val': TRAIN_EPOCHS * TRAIN_VAL_STEPS,
             'test': TRAIN_TEST_STEPS}, calls, kernels)
        runs[name] = dict(tr=tr, launches=got, calls=calls, run_s=run_s)
    plain, dp = runs['plain']['tr'], runs['mesh']['tr']
    if dp.n_data_shards != 1 or dp.data_group is None:
        fail(f'phase 22 ({label}): the mesh trainer has no data group of '
             f'one rank')
    if runs['plain']['launches'] != runs['mesh']['launches']:
        fail(f'phase 22 ({label}): the mesh run launched '
             f'{runs["mesh"]["launches"]}, the plain run '
             f'{runs["plain"]["launches"]}')
    losses = {'fithist': (plain.fithist['loss'] + plain.fithist['val_loss'],
                          dp.fithist['loss'] + dp.fithist['val_loss']),
              'test_loss': ([plain.test_loss], [dp.test_loss])}
    if not all(np.isfinite(v) for v in losses['fithist'][1]):
        fail(f'phase 22 ({label}): non-finite losses {dp.fithist}')
    a, b = _state_of(plain), _state_of(dp)
    diffs = {k: max(abs(x - y) for x, y in zip(*v))
             for k, v in losses.items()}
    diffs['parameters and buffers'] = _max_diff(list(a.values()),
                                                list(b.values()))
    rel = max((a[n].double() - b[n].double()).abs().max().item()
              / max(a[n].double().abs().max().item(), 1e-30) for n in a)
    rel = max([rel] + [abs(x - y) / abs(x) for v in losses.values()
                       for x, y in zip(*v)])
    exact = all(d == 0 for d in diffs.values())
    print(f'phase 22 ({label}): mesh vs plain, {TRAIN_EPOCHS} epochs of '
          f'{steps} steps at batch {TRAIN_BATCH}: max|d| {diffs} '
          f'(max relative {rel:.3e}; '
          + ('bit for bit' if exact else f'within rtol {rtol} required')
          + f'); histories {dp.fithist}, test loss {dp.test_loss}',
          flush=True)
    if not (exact or rel <= rtol):
        fail(f'phase 22 ({label}): the mesh run differs from the plain run: '
             f'max|d| {diffs}, relative {rel:.3e}')
    names = {k: _kernel_names(torch, runs[k]['tr'].runner.graphs['step'],
                              runs[k]['tr']) for k in runs}
    extra = names['mesh'] - names['plain']
    # NCCL's kernels; its one-rank kernel comes mangled
    # (`..._onerank_cu_..._oneRankReduceI13FuncPreMulSumIfEE...`)
    nccl = {k: n for k, n in extra.items()
            if 'nccl' in k.lower() or 'onerank' in k.lower()}
    if not nccl:
        fail(f'phase 22 ({label}): one replay of the mesh step runs no NCCL '
             f'kernel (its device work beyond the plain step\'s: '
             f'{dict(extra)}): the gradients\' all-reduce is not in the '
             f'graph')
    replay_ms = {}
    for k, run in runs.items():
        graph, tr = run['tr'].runner.graphs['step'], run['tr']

        def replay(graph=graph, tr=tr):
            tr._row.zero_()
            graph.replay()
        replay_ms[k] = statistics.median(device_times(torch, replay,
                                                      reps=DP_REPLAYS))
    print(f'phase 22 ({label}): NCCL\'s kernels in one replay of the mesh '
          f'step {nccl} (by name: launches a replay; at one rank the '
          f'gradients\' average is NCCL\'s one-rank kernel and the sums '
          f'and extremes are no-ops on the device); all its device work '
          f'beyond the plain step\'s {dict(extra)}; one replay '
          f'{replay_ms["mesh"]:.3f} ms with the mesh, '
          f'{replay_ms["plain"]:.3f} ms without (median of {DP_REPLAYS}, '
          f'CUDA events); {card_line()}', flush=True)
    return dict(label=label, steps=steps, launches=runs['mesh']['launches'],
                wrapper_calls=runs['mesh']['calls'],
                plain_launches=runs['plain']['launches'],
                max_abs_diff=diffs, max_rel_diff=rel, bit_for_bit=exact,
                nccl_kernels=nccl, extra_kernels=dict(extra),
                replay_ms=replay_ms,
                run_s={k: v['run_s'] for k, v in runs.items()},
                card=card_line())


def phase_data_parallel(torch, tds, report):
    """Phase 22: SupervisedTrainer(mesh=) over an NCCL process group of one
    rank (the card's count), against the same runs without a mesh: the
    flagship with dssim_mae (K1, K6 both ways), a bn flagship and
    recresnet_spc (K2-train, K3)."""
    import dl4ds_tpu_torch.ops.convlstm as conv
    from dl4ds_tpu_torch.ops import fused_ops as fo
    dev = tds.distributed.initialize(f'127.0.0.1:{_free_port()}', 1, 0,
                                     device='cuda', timeout=300)
    if torch.distributed.get_backend() != 'nccl':
        fail(f'phase 22: the process group runs '
             f'{torch.distributed.get_backend()}, not NCCL')
    mesh = tds.distributed.global_mesh()
    print(f'phase 22: process group {torch.distributed.get_backend()} on '
          f'{dev}, mesh {mesh}', flush=True)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    per_forward = report['flag_k1_per_forward']
    rows = []
    try:
        flag = _training_config(loss=FLAG_LOSS, n_filters=N_FILTERS,
                                n_blocks=N_BLOCKS, attention=True)
        rows.append(_dp_pair(torch, tds, mesh, flag, f'flagship, {FLAG_LOSS}',
                             DP_STEPS, _flagship_per_step(per_forward)))
        rows.append(_dp_pair(
            torch, tds, mesh, dict(flag, normalization='bn'),
            f'bn flagship, {FLAG_LOSS}', DP_STEPS,
            _flagship_per_step(per_forward), rtol=DP_BN_RTOL))
        rec = _training_config(loss='mae', time_window=REC_T,
                               n_blocks=REC_BLOCKS, n_filters=N_FILTERS)
        rows.append(_dp_pair(torch, tds, mesh, rec,
                             f'recresnet_spc n_filters {N_FILTERS}',
                             DP_REC_STEPS, _recurrent_per_step(conv,
                                                               K3_LAYERS)))
        busy = [name for name, t in fo._COUNTERS.items()
                if int(t.count_nonzero()) != 0]
        if busy:
            fail(f'phase 22: arrival counters {busy} not left at 0')
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
        torch.distributed.destroy_process_group()
    if torch.distributed.is_initialized():
        fail('phase 22: the process group outlived the phase')
    report['dp'] = rows


def _dp_kernel_rows(report):
    """The `kernels` line's rows of phase 22: the mesh runs' launches from
    their device traces; the kernels' times and errors those of the same
    shapes in phases 6, 9 and 10 (the path runs them unchanged)."""
    flag, _, rec = report['dp']
    gates, k6 = report['k1_train_rows'], report['k6_rows'][0]
    step, k3_rows = report['k3_step'], report['k3_rows']
    common = dict(route='cuda', library_ms=None)
    k1 = dict(common, name='K1_channel_attention_dp_train',
              source='dl4ds_tpu_torch/csrc/channel_attention.cu',
              replaces='dl4ds_tpu/ops/pallas_ops.py:39',
              launches=flag['launches']['K1'],
              wrapper_calls=flag['wrapper_calls']['K1'],
              max_abs_err=max(r['max_abs_err'] for r in gates),
              ms=sum(r['ms'] for r in gates),
              plain_ms=sum(r['plain_ms'] for r in gates),
              bound_ms=sum(r['bound_ms'] for r in gates), bound_by='bytes',
              bwd_ms=sum(r['bwd_ms'] for r in gates),
              bwd_bound_ms=sum(r['bwd_bound_ms'] for r in gates),
              bwd_plain_ms=sum(r['bwd_plain_ms'] for r in gates),
              bwd_launches=flag['launches']['K1 backward'],
              bwd_wrapper_calls=flag['wrapper_calls']['K1 backward'],
              work=f'the gates of one flagship training step at batch '
                   f'{TRAIN_BATCH} under SupervisedTrainer(mesh=) at world '
                   f'size 1, NCCL (phase 10\'s shapes and times)')
    k6_row = dict(common, name='K6_ssim_dp_train',
                  source='dl4ds_tpu_torch/csrc/ssim.cu',
                  replaces='dl4ds_tpu/ops/pallas_ops.py:145',
                  launches=flag['launches']['K6'],
                  wrapper_calls=flag['wrapper_calls']['K6'],
                  max_abs_err=k6['max_abs_err'], ms=k6['ms'],
                  plain_ms=k6['plain_ms'], bound_ms=k6['bound_ms'],
                  bound_by=k6['bound_by'], bwd_ms=k6['bwd_ms'],
                  bwd_bound_ms=k6['bwd_bound_ms'],
                  bwd_plain_ms=k6['bwd_plain_ms'],
                  bwd_launches=flag['launches']['K6 backward'],
                  bwd_wrapper_calls=flag['wrapper_calls']['K6 backward'],
                  work=f'the {FLAG_LOSS} loss of the flagship under the '
                       f'mesh, its range over the global batch (phase 9\'s '
                       f'shape and times)')
    rec_work = (f'recresnet_spc under SupervisedTrainer(mesh=) at world '
                f'size 1 (phase 7\'s layers, batch {TRAIN_BATCH}, T {REC_T}; '
                f'phase 6\'s times)')
    k2 = dict(common, name='K2_convlstm_train_dp',
              source='dl4ds_tpu_torch/csrc/convlstm.cu',
              replaces='dl4ds_tpu/ops/pallas_convlstm.py:219',
              launches=rec['launches']['K2-train'],
              wrapper_calls=rec['wrapper_calls']['K2-train'],
              max_abs_err=max(max(r['ys_cs_zs_err'][:2]) for r in k3_rows
                              if 'ys_cs_zs_err' in r),
              ms=sum(r['k2_ms'] for r in step),
              plain_ms=sum(r['k2_plain_ms'] for r in step),
              bound_ms=sum(r['k2_bound_ms'] for r in step),
              bound_by='operations', work=rec_work)
    k3 = dict(common, name='K3_convlstm_bptt_dp',
              source='dl4ds_tpu_torch/csrc/convlstm_bwd.cu',
              replaces='dl4ds_tpu/ops/pallas_convlstm.py:335',
              launches=rec['launches']['K3'],
              wrapper_calls=rec['wrapper_calls']['K3'],
              max_abs_err=max(max(v for k, v in r['grad_rel_err'].items()
                                  if k != 'plain_f32') for r in k3_rows),
              ms=sum(r['k3_ms'] for r in step),
              plain_ms=sum(r['k3_plain_ms'] for r in step),
              bound_ms=sum(r['k3_bound_ms'] for r in step),
              bound_by='operations', work=rec_work)
    return [k1, k6_row, k2, k3]


# phase 23: the rest of data parallelism over processes at world size 1
DPX_ENS_STEPS = 3                   # ensemble steps of (d), bootstrapped


def _equal_or_fail(label, pairs):
    """Fail unless every (plain, mesh) pair of arrays or tensors is equal
    bit for bit; returns the largest |d| seen (0.0)."""
    import numpy as np
    worst = 0.0
    for a, b in pairs:
        a, b = (np.asarray(v.detach().cpu() if hasattr(v, 'detach') else v,
                           dtype='float64') for v in (a, b))
        if a.shape != b.shape:
            fail(f'{label}: shapes {a.shape} and {b.shape}')
        worst = max(worst, float(np.abs(a - b).max()) if a.size else 0.0)
    if worst != 0.0:
        fail(f'{label}: the mesh run differs from the plain run by max|d| '
             f'{worst:.3e}; bit for bit required')
    return worst


def _dpx_cgan(torch, tds, mesh):
    """(a): phase 16's flagship CGAN with a dssim_mae pixel loss, with and
    without the mesh, each traced with every counter at 0 just before."""
    config = dict(_cgan_config(), loss=FLAG_LOSS)
    chunks = -(-CGAN_TEST // min(TRAIN_BATCH, CGAN_TEST))
    runs = {}
    for name, m in (('plain', None), ('mesh', mesh)):
        tr = tds.CGANTrainer(epochs=TRAIN_EPOCHS, steps_per_epoch=CGAN_STEPS,
                             mesh=m, **config)
        run_s, calls, kernels = _traced_run(torch, tds, tr)
        per_step, outside = _cgan_per_step(tr)
        # the pixel loss: K6 once each way a step, once a test chunk
        per_step['train'].update({'K6': 1, 'K6 backward': 1})
        outside['K6'] = chunks
        got = _check_launches(tds, tr.runner, f'phase 23 (a, {name})',
                              per_step, {'step': TRAIN_EPOCHS * CGAN_STEPS},
                              calls, kernels, outside)
        runs[name] = dict(tr=tr, launches=got, calls=calls, run_s=run_s)
    plain, dp = runs['plain']['tr'], runs['mesh']['tr']
    if dp.n_data_shards != 1 or dp.data_group is None:
        fail('phase 23 (a): the mesh trainer has no data group of one rank')
    if runs['plain']['launches'] != runs['mesh']['launches']:
        fail(f'phase 23 (a): the mesh run launched '
             f'{runs["mesh"]["launches"]}, the plain run '
             f'{runs["plain"]["launches"]}')
    history = [(getattr(plain, k), getattr(dp, k)) for k in
               ('gentotal', 'gengan', 'gen_pxloss', 'disc', 'test_loss')]
    a, b = _state_of(plain), _state_of(dp)
    _equal_or_fail('phase 23 (a)', history + [(a[n], b[n]) for n in a])
    if not all(math.isfinite(v) for v in dp.gentotal + dp.disc):
        fail(f'phase 23 (a): non-finite losses {dp.gentotal}, {dp.disc}')
    names = {k: _kernel_names(torch, runs[k]['tr'].runner.graphs['step'],
                              runs[k]['tr']) for k in runs}
    extra = names['mesh'] - names['plain']
    nccl = {k: n for k, n in extra.items()
            if 'nccl' in k.lower() or 'onerank' in k.lower()}
    if not nccl:
        fail(f'phase 23 (a): one replay of the mesh step runs no NCCL kernel '
             f'(its device work beyond the plain step\'s: {dict(extra)})')
    replay_ms = {}
    for k, run in runs.items():
        graph, tr = run['tr'].runner.graphs['step'], run['tr']

        def replay(graph=graph, tr=tr):
            tr._row.zero_()
            graph.replay()
        replay_ms[k] = statistics.median(device_times(torch, replay,
                                                      reps=DP_REPLAYS))
    print(f'phase 23 (a): CGAN (flagship G, {FLAG_LOSS}) mesh vs plain, '
          f'{TRAIN_EPOCHS} epochs of {CGAN_STEPS} steps at batch '
          f'{TRAIN_BATCH}: losses, test loss ({dp.test_loss:.6f}) and G\'s '
          f'and D\'s parameters bit for bit; launches in each trace '
          f'{runs["mesh"]["launches"]}; NCCL\'s kernels in one replay of '
          f'the mesh step {nccl} (the one average of G\'s and D\'s '
          f'gradients; all device work beyond the plain step\'s '
          f'{dict(extra)}); one replay {replay_ms["mesh"]:.3f} ms with the '
          f'mesh, {replay_ms["plain"]:.3f} ms without (median of '
          f'{DP_REPLAYS}, CUDA events); runs {runs["plain"]["run_s"]:.1f} '
          f'and {runs["mesh"]["run_s"]:.1f} s traced; {card_line()}',
          flush=True)
    return dict(launches=runs['mesh']['launches'],
                wrapper_calls=runs['mesh']['calls'],
                plain_launches=runs['plain']['launches'],
                losses=[dp.gentotal, dp.gengan, dp.gen_pxloss, dp.disc],
                test_loss=dp.test_loss, nccl_kernels=nccl,
                extra_kernels=dict(extra), replay_ms=replay_ms,
                run_s={k: v['run_s'] for k, v in runs.items()},
                bit_for_bit=True)


def _dpx_counted(tds, fn):
    """fn() with K1's, K2's and K7's wrapper counts set to 0 just before;
    returns (its output, {counter: launches})."""
    from dl4ds_tpu_torch.ops import conv_int8 as ci
    fca, fcl = tds.fused_channel_attention, tds.fused_convlstm
    fca.launches = fca.bwd_launches = fcl.launches = 0
    ci.conv_int8.launches = 0
    out = fn()
    return out, {'K1': fca.launches, 'K1 backward': fca.bwd_launches,
                 'K2': fcl.launches, 'K7': ci.conv_int8.launches}


def _dpx_predict(torch, tds, mesh):
    """(b): predict(mesh=) of phase 12's float32 flagship and
    recresnet_spc against predict without a mesh."""
    out = {}
    for recurrent in (False, True):
        case = _serving_case(tds, recurrent)
        model = case['make'](torch.float32)
        net = model.init(seed=0, device='cuda')
        args = ((model, net), case['hr'])
        y = tds.predict(*args, **case['kwargs'])
        t0 = time.perf_counter()
        y_dp, got = _dpx_counted(tds, lambda: tds.predict(
            *args, mesh=mesh, **case['kwargs']))
        dp_s = time.perf_counter() - t0
        want = dict(case['want'], **{'K1 backward': 0, 'K7': 0})
        if got != want:
            fail(f'phase 23 (b, {case["label"]}): predict(mesh=) launched '
                 f'{got}, expected {want}')
        _equal_or_fail(f'phase 23 (b, {case["label"]})', [(y, y_dp)])
        print(f'phase 23 (b): predict(mesh=) of {case["label"]}, '
              f'{case["n"]} grids at batch {BATCH}: {y_dp.shape}, bit for '
              f'bit against predict; launches {got}; {dp_s:.3f} s (host '
              f'clock, one call); {card_line()}', flush=True)
        out[case['label']] = dict(launches=got, seconds=dp_s)
    return out


def _dpx_tiled(torch, tds, mesh, flush):
    """(c): predict(tile=, mesh=) of the flagship on one global grid,
    float32 and int8, against the call without a mesh; K7 at a window
    dispatch's sites held and timed."""
    import numpy as np
    h, w = TILED_GRID
    hr = np.random.default_rng(18).standard_normal(
        (1, h * SCALE, w * SCALE)).astype('float32')
    model = tds.net_postupsampling(
        'resnet', 'spc', scale=SCALE, n_channels=1, n_aux_channels=0,
        lr_size=TILED_GRID, n_filters=N_FILTERS, n_blocks=N_BLOCKS,
        attention=True)
    net = model.init(seed=0, device='cuda')
    kwargs = dict(scale=SCALE, array_in_hr=True, tile=TILE, halo=TILE_HALO,
                  batch_size=BATCH)
    n_win = (-(-h // TILE)) * (-(-w // TILE))
    dispatches = -(-n_win // BATCH)
    win = torch.randn((BATCH, TILE_WINDOW, TILE_WINDOW, 1), device='cuda')
    qf = tds.quantize_forward(model, net, win)
    gates = len(K1_SHAPES)
    out = {}
    for mode in (None, 'int8'):
        y = tds.predict((model, net), hr, quantize=mode, **kwargs)
        t0 = time.perf_counter()
        y_dp, got = _dpx_counted(tds, lambda: tds.predict(
            (model, net), hr, quantize=mode, mesh=mesh, **kwargs))
        dp_s = time.perf_counter() - t0
        # int8: the calibration's float forward, then the quantized one
        want = {'K1': gates * (dispatches + (mode is not None)),
                'K1 backward': 0, 'K2': 0,
                'K7': qf.n_sites * dispatches if mode else 0}
        if got != want or not np.isfinite(y_dp).all():
            fail(f'phase 23 (c, {mode}): predict(tile=, mesh=) launched '
                 f'{got}, expected {want}; finite '
                 f'{bool(np.isfinite(y_dp).all())}')
        _equal_or_fail(f'phase 23 (c, {mode})', [(y, y_dp)])
        print(f'phase 23 (c): predict(tile={TILE}, mesh=, quantize={mode}) '
              f'of a {h}x{w} grid -> {y_dp.shape}: {n_win} windows in '
              f'{dispatches} dispatches, bit for bit against the call '
              f'without a mesh; launches {got}; {dp_s:.3f} s (host clock, '
              f'one call); {card_line()}', flush=True)
        out[str(mode)] = dict(launches=got, seconds=dp_s)
    with _k7_calls() as calls:
        qf(win)
    rows = _k7_rows(torch, calls, 'tiled window site (phase 23)', flush=flush)
    del calls
    return out, rows


def _dpx_ensembles(torch, tds, meshes):
    """(d): a 4-member flagship ensemble trained and served under each of
    `meshes` ({name: DeviceMesh}) and without a mesh, from one seed."""
    from dl4ds_tpu_torch import parallel
    config = _training_config(loss='mae', n_filters=N_FILTERS,
                              n_blocks=N_BLOCKS, attention=True)
    model, batches = _ensemble_batches(torch, tds, config, TRAIN_BATCH,
                                       DPX_ENS_STEPS)
    x = batches[0]['lr'][:N_GRIDS]
    gates = len(K1_TRAIN_SHAPES)
    runs = {}
    for name, m in (('plain', None), *meshes.items()):
        st = parallel.init_ensemble(model, ENS_M, seed=0, mesh=m)
        es = parallel.make_ensemble_step(model, m, loss='mae', bootstrap=True)
        opt = es.init_opt(st)

        def train(st=st, opt=opt, es=es):
            return [es.step(st, opt, b['lr'], b['hr'], 23 + c)[2]
                    for c, b in enumerate(batches)]
        losses, got = _dpx_counted(tds, train)
        served, serve_got = _dpx_counted(tds, lambda st=st, m=m: (
            parallel.predict_ensemble(model, st, x, mesh=m,
                                      return_members=True)))
        want = {'K1': gates * len(batches), 'K1 backward': gates * len(
            batches), 'K2': 0, 'K7': 0}
        if got != want or serve_got != dict(want, K1=gates,
                                            **{'K1 backward': 0}):
            fail(f'phase 23 (d, {name}): {len(batches)} ensemble steps '
                 f'launched {got} (expected {want}: one member-mode launch a '
                 f'gate each way), predict_ensemble {serve_got}')
        runs[name] = dict(losses=torch.stack(losses), stack=st,
                          served=served, launches=got, serve=serve_got)
    plain = runs['plain']
    for name in meshes:
        run = runs[name]
        _equal_or_fail(f'phase 23 (d, {name})', [
            (plain['losses'], run['losses'])]
            + [(plain['stack'][k], run['stack'][k]) for k in plain['stack']]
            + list(zip(plain['served'], run['served'])))
        print(f'phase 23 (d): {ENS_M}-member flagship ensemble under the '
              f'{name} mesh, {len(batches)} bootstrapped steps at batch '
              f'{TRAIN_BATCH} and predict_ensemble of {N_GRIDS} grids: '
              f'losses {run["losses"].tolist()}, the stack and the members '
              f'served bit for bit against no mesh; K1 member-mode launches '
              f'{run["launches"]} training, {run["serve"]} serving; '
              f'{card_line()}', flush=True)
    return {name: dict(launches=runs[name]['launches'],
                       serve_launches=runs[name]['serve'],
                       losses=runs[name]['losses'].tolist())
            for name in meshes}


def phase_more_data_parallel(torch, tds, report):
    """Phase 23: CGANTrainer(mesh=), predict(mesh=), predict_tiled(mesh=)
    and the ensembles over a fresh NCCL process group of one rank, each
    against the same call without a mesh."""
    dev = tds.distributed.initialize(f'127.0.0.1:{_free_port()}', 1, 0,
                                     device='cuda', timeout=300)
    if torch.distributed.get_backend() != 'nccl':
        fail(f'phase 23: the process group runs '
             f'{torch.distributed.get_backend()}, not NCCL')
    mesh = tds.distributed.global_mesh()
    meshes = {"('ensemble',) of 1": tds.distributed.ensemble_mesh(),
              "('ensemble', 'data') of (1, 1)":
                  tds.distributed.ensemble_mesh(1, 1)}
    print(f'phase 23: a fresh process group {torch.distributed.get_backend()}'
          f' on {dev} after phase 22\'s was destroyed; meshes {mesh}, '
          f'{list(meshes.values())}', flush=True)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    parts, out = {}, {}
    t0 = time.perf_counter()

    def done(name):
        nonlocal t0
        parts[name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
    try:
        out['cgan'] = _dpx_cgan(torch, tds, mesh)
        done('a')
        out['predict'] = _dpx_predict(torch, tds, mesh)
        done('b')
        flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device='cuda')
        out['tiled'], report['dpx_k7_rows'] = _dpx_tiled(torch, tds, mesh,
                                                         flush)
        del flush
        done('c')
        out['ensembles'] = _dpx_ensembles(torch, tds, meshes)
        done('d')
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
        torch.backends.cudnn.allow_tf32 = True
        torch.distributed.destroy_process_group()
    if torch.distributed.is_initialized():
        fail('phase 23: the process group outlived the phase')
    out['parts_s'] = parts
    print(f'phase 23 parts (s): {parts}', flush=True)
    report['dpx'] = out


def _dpx_kernel_rows(report):
    """The `kernels` line's rows of phase 23: each path's launches from its
    run under the mesh; the kernels' times and errors those of the same
    shapes in phases 2, 4, 9, 10 and 18, K7's at the window dispatch timed
    in phase 23."""
    d = report['dpx']
    cg = d['cgan']
    gates, k6 = report['k1_train_rows'], report['k6_rows'][0]
    f32 = [r for r in report['k1_rows'] if r['dtype'] == 'float32']
    fwd, tiled = report['k2_forward'], report['tiled_k1_rows']
    step, serve = report['member_rows']
    k7 = _k7_totals(report['dpx_k7_rows'])
    k1 = dict(route='cuda', source='dl4ds_tpu_torch/csrc/channel_attention.cu',
              replaces='dl4ds_tpu/ops/pallas_ops.py:39', bound_by='bytes',
              library_ms=None)

    def k1_row(name, rows, launches, work, **extra):
        return dict(k1, name=name, launches=launches,
                    max_abs_err=max(r['max_abs_err'] for r in rows),
                    ms=sum(r['ms'] for r in rows),
                    plain_ms=sum(r['plain_ms'] for r in rows),
                    bound_ms=sum(r['bound_ms'] for r in rows), work=work,
                    **extra)
    ens = next(iter(d['ensembles'].values()))
    return [
        k1_row('K1_channel_attention_cgan_dp_train', gates,
               cg['launches']['K1'],
               f'the {len(gates)} gates of G in one CGAN step at batch '
               f'{TRAIN_BATCH} under CGANTrainer(mesh=) at world size 1, '
               f'NCCL (phase 10\'s shapes and times); launches from phase '
               f'23 (a)\'s device trace',
               wrapper_calls=cg['wrapper_calls']['K1'],
               bwd_launches=cg['launches']['K1 backward'],
               bwd_wrapper_calls=cg['wrapper_calls']['K1 backward'],
               bwd_ms=sum(r['bwd_ms'] for r in gates),
               bwd_bound_ms=sum(r['bwd_bound_ms'] for r in gates),
               bwd_plain_ms=sum(r['bwd_plain_ms'] for r in gates)),
        dict(route='cuda', name='K6_ssim_cgan_dp_train',
             source='dl4ds_tpu_torch/csrc/ssim.cu',
             replaces='dl4ds_tpu/ops/pallas_ops.py:145', library_ms=None,
             launches=cg['launches']['K6'],
             wrapper_calls=cg['wrapper_calls']['K6'],
             max_abs_err=k6['max_abs_err'], ms=k6['ms'],
             plain_ms=k6['plain_ms'], bound_ms=k6['bound_ms'],
             bound_by=k6['bound_by'], bwd_ms=k6['bwd_ms'],
             bwd_bound_ms=k6['bwd_bound_ms'],
             bwd_plain_ms=k6['bwd_plain_ms'],
             bwd_launches=cg['launches']['K6 backward'],
             bwd_wrapper_calls=cg['wrapper_calls']['K6 backward'],
             work=f'the {FLAG_LOSS} pixel loss of the CGAN step under the '
                  f'mesh, its range over the global batch, and of the test '
                  f'loss (phase 9\'s shape and times)'),
        k1_row('K1_channel_attention_dp_predict', f32,
               d['predict']['resnet_spc']['launches']['K1'],
               f'the {len(f32)} gates of one float32 flagship forward at '
               f'batch {BATCH} (phase 2\'s shapes and times); launches of '
               f'predict(mesh=) on {N_GRIDS} grids'),
        dict(route='cuda', name='K2_convlstm_dp_predict',
             source='dl4ds_tpu_torch/csrc/convlstm.cu',
             replaces='dl4ds_tpu/ops/pallas_convlstm.py:219',
             bound_by='operations', library_ms=None,
             launches=d['predict']['recresnet_spc']['launches']['K2'],
             max_abs_err=max(r['max_abs_err'] for r in report['k2_rows']),
             ms=sum(r['ms'] for r in fwd),
             plain_ms=sum(r['plain_ms'] for r in fwd),
             bound_ms=sum(r['bound_ms'] for r in fwd),
             work=f'the {len(fwd)} ConvLSTM layers of one float32 '
                  f'recresnet_spc forward at batch {BATCH} (phase 4\'s shapes '
                  f'and times); launches of predict(mesh=) on {REC_GRIDS} '
                  f'grids'),
        k1_row('K1_channel_attention_dp_tiled', tiled,
               d['tiled']['None']['launches']['K1'],
               f'the {len(tiled)} gates of one tiled flagship dispatch '
               f'(phase 18\'s shapes and times); launches of predict(tile='
               f'{TILE}, mesh=) on one {TILED_GRID[0]}x{TILED_GRID[1]} grid'),
        dict(route='cuda', name='K7_conv_int8_dp_tiled',
             source='dl4ds_tpu_torch/csrc/conv_int8.cu',
             replaces='dl4ds_tpu/quantization.py:276 (XLA\'s s8 convolution '
                      'in the int8 replay; no Pallas kernel)',
             launches=d['tiled']['int8']['launches']['K7'], max_abs_err=0.0,
             ms=k7['ms'], plain_ms=k7['plain_ms'], bound_ms=k7['bound_ms'],
             bound_by=('operations' if k7['bound_ops_ms']
                       > k7['bound_bytes_ms'] else 'bytes'),
             library_ms=k7['library_ms'], unfold_ms=k7['unfold_ms'],
             cudnn_bf16_ms=k7['cudnn_bf16_ms'],
             work=f'the int8 sites of one tiled flagship dispatch, {BATCH} '
                  f'windows of {TILE_WINDOW}x{TILE_WINDOW}, timed in phase 23 '
                  f'and summed over their calls (int32 sums and outputs equal '
                  f'the plain version); launches of predict(tile={TILE}, '
                  f'mesh=, quantize=\'int8\') on one global grid'),
        k1_row('K1_member_dp_ensemble', [step], ens['launches']['K1'],
               f'the member mode at the ensemble step\'s first gate '
               f'x{step["shape"]} ({ENS_M} members; phase 18\'s times); '
               f'launches of {DPX_ENS_STEPS} steps under the '
               f'{next(iter(d["ensembles"]))} mesh (one a gate each way), '
               f'serve_launches of predict_ensemble on {N_GRIDS} grids',
               bwd_launches=ens['launches']['K1 backward'],
               serve_launches=ens['serve_launches']['K1'],
               bwd_ms=step['bwd_ms'], bwd_plain_ms=step['bwd_plain_ms'],
               bwd_bound_ms=step['bwd_bound_ms'])]


# phase 24: spatial parallelism at the card's count of one
SP_BANDS = (2, 4)                   # band cuts of (a), in one process
SP_STEPS, SP_REC_STEPS = 4, 3       # steps an epoch of (b)'s pairs
# (b): the mesh run against the plain one: the losses relative, the first
# step's gradients in norm; the parameters after the run in norm (Adam
# steps a parameter whose gradient is near zero by up to its rate either
# way, in two runs whose gradients differ in their last bits)
SP_RTOL, SP_GRAD_RTOL, SP_PARAM_RTOL = 1e-3, 1e-4, 1e-2
SP_SLEEP = 30_000_000               # (a): device_times' sleep, cycles
SP_PREDICT_GRIDS = 4                # (c): LR grids of 128x128 served
SP_STEP_BATCH, SP_STEP_LR = 4, 64   # (c): the standalone step's batch


def _band_stages(torch, fo, x, weights, dy, n, mixed, plain=False):
    """K1's band mode on x cut into n bands of rows (dim 1), the stages'
    partial sums and dm added where the ranks' all-reduces add them:
    [y, dx, dw1, db1, dw2, db2] of the whole image. `plain`: the plain
    versions of the stages on the same tensors (float64 sums for float64
    inputs), else the wrappers (the kernels on the card)."""
    hw = x.shape[1] * x.shape[2]
    xs = [b.contiguous() for b in x.chunk(n, dim=1)]
    dys = [d.contiguous() for d in dy.chunk(n, dim=1)]
    if plain:
        acc = fo._acc_dtype(dy)
        sums = sum(b.to(acc).sum(dim=(-3, -2)) for b in xs)
        m, g = fo._gate_of_mean(sums / hw, *weights, mixed)
        ys = [b.to(acc) * g[:, None, None, :] if mixed
              else b * g.to(b.dtype)[:, None, None, :] for b in xs]
        parts = [fo._partial_grads(b, *weights, d, m, g, mixed)
                 for b, d in zip(xs, dys)]
        dm = sum(p[0] for p in parts)
        dxs = [fo._dx_of(b, d, g, dm, hw, mixed) for b, d in zip(xs, dys)]
    else:
        sums = sum(fo.ca_band_sums(b) for b in xs)
        outs = [fo.ca_band_apply(b, sums, hw, *weights, mixed) for b in xs]
        _, m, g = outs[0]
        ys = [o[0] for o in outs]
        parts = [fo.ca_band_grads(b, *weights, d, m, g, mixed)
                 for b, d in zip(xs, dys)]
        dm = sum(p[0] for p in parts)
        dxs = [fo.ca_band_dx(b, d, g, dm, hw, mixed)
               for b, d in zip(xs, dys)]
    return ([torch.cat(ys, dim=1), torch.cat(dxs, dim=1)]
            + [sum(p[k] for p in parts) for k in range(1, 5)])


def _band_scales(torch, fo, x64, w64, dy64, ref):
    """The scale each of `ref`'s tensors (y, dx, dw1, db1, dw2, db2) is
    held to: max |ref|; at K1_CANCELLING the weight gradients' largest
    sum of the samples' terms in magnitude (`_check_k1_backward`)."""
    scales = [r.abs().max().item() for r in ref]
    if tuple(x64.shape) == K1_CANCELLING:
        mags = [torch.zeros_like(r) for r in ref[2:]]
        for i in range(x64.shape[0]):
            terms = fo._channel_attention_backward(x64[i:i + 1], *w64,
                                                   dy64[i:i + 1])[1:]
            for mag, t in zip(mags, terms):
                mag += t.abs()
        scales[2:] = [t.max().item() for t in mags]
    return scales


SP_NAMES = ('y', 'dx', 'dw1', 'db1', 'dw2', 'db2')


def _check_band_case(torch, fo, x, weights, dy, label):
    """(a) at one gate shape: the band stages over SP_BANDS cuts against
    the plain version in float64 (f32: y within K1_TOL, each gradient
    within K1_BWD_TOL of its scale) and on the same bands (mixed: y, db1,
    db2 within BF16_F32_TOL of max |ref|, dx, dw1, dw2 within
    BF16_STORED_TOL), against fused K1 on the whole image (f32, the same
    tolerances), the same bits twice. Returns {check: error}."""
    x64, dy64 = x.double(), dy.double()
    w64 = [t.double() for t in weights]
    ref = _band_stages(torch, fo, x64, w64, dy64, 1, False, plain=True)
    scales = _band_scales(torch, fo, x64, w64, dy64, ref)
    y_f, m_f, g_f = fo._launch(x, *weights)
    fused = [y_f] + list(fo._launch_backward(x, *weights, dy, m_f, g_f))
    errs = {}
    for n in SP_BANDS:
        got = _band_stages(torch, fo, x, weights, dy, n, False)
        again = _band_stages(torch, fo, x, weights, dy, n, False)
        xb = x.to(torch.bfloat16)
        mixed = _band_stages(torch, fo, xb, weights, dy, n, True)
        mixed_ref = _band_stages(torch, fo, xb, w64, dy64, n, True,
                                 plain=True)
        torch.cuda.synchronize()
        for name, a, a2, r, scale in zip(SP_NAMES, got, again, ref, scales):
            if not torch.equal(a, a2):
                fail(f'K1 band {label} {n} bands {name}: two runs gave '
                     f'different bits')
            d = (a.double() - r).abs().max().item()
            tol = K1_TOL['float32']['atol'] if name == 'y' \
                else K1_BWD_TOL * scale
            if not d <= tol:
                fail(f'K1 band {label} {n} bands {name}: max|d| {d:.3e} '
                     f'against the float64 plain version, tolerance '
                     f'{tol:.3e}')
            errs[f'{name}/{n}'] = d if name == 'y' or not scale \
                else d / scale
        for name, a, r in zip(SP_NAMES, mixed, mixed_ref):
            tol = (BF16_F32_TOL if name in ('y', 'db1', 'db2')
                   else BF16_STORED_TOL)
            e = _rel_err(a, r)
            if not e <= tol:
                fail(f'K1 band mixed {label} {n} bands {name}: max|d| / '
                     f'max|ref| {e:.3e} over {tol}')
            errs[f'mixed {name}/{n}'] = e
        for name, a, b, scale in zip(SP_NAMES, got, fused, scales):
            d = (a.double() - b.double()).abs().max().item()
            tol = (2 * K1_TOL['float32']['atol'] if name == 'y'
                   else 2 * K1_BWD_TOL * scale)
            if not d <= tol:
                fail(f'K1 band {label} {n} bands {name}: max|d| {d:.3e} '
                     f'against fused K1 on the whole image, tolerance '
                     f'{tol:.3e}')
            errs[f'vs fused {name}/{n}'] = (d if name == 'y' or not scale
                                           else d / scale)
    return errs


def _band_gate_rows(torch, tds, shapes, label, flush):
    """(a) K1's band mode at the gate `shapes`: checked
    (`_check_band_case`), then timed at one band (what a rank of one runs:
    the forward's sums and apply, the backward's partial gradients and dx)
    against its plain version on the card (float32) in turns and against
    fused K1 at the same shape; the bound by bytes (x read once, y or dx
    written once, dy read once, the weights and their gradients)."""
    from dl4ds_tpu_torch.ops import fused_ops as fo
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(24)
    rows = []
    for shape in shapes:
        c = shape[-1]
        cr = max(int(c / 4), 1)
        x, weights, dy = _gate_case(torch, gen, dev, shape, cr, torch.float32)
        errs = _check_band_case(torch, fo, x, weights, dy,
                                f'{label} x{list(shape)}')
        hw = shape[1] * shape[2]

        def fwd():
            return fo.ca_band_apply(x, fo.ca_band_sums(x), hw, *weights)

        def plain_fwd():
            m, g = fo._gate_of_mean(x.sum(dim=(1, 2)) / hw, *weights)
            return x * g[:, None, None, :]
        _, m, g = fwd()

        def bwd():
            dm, *dws = fo.ca_band_grads(x, *weights, dy, m, g)
            return fo.ca_band_dx(x, dy, g, dm, hw), dws

        def plain_bwd():
            dm, *dws = fo._partial_grads(x, *weights, dy, m, g)
            return fo._dx_of(x, dy, g, dm, hw), dws
        quick = dict(sleep_cycles=SP_SLEEP)
        ms, plain_ms = paired_ms(torch, fwd, plain_fwd, flush, **quick)
        bwd_ms, bwd_plain_ms = paired_ms(torch, bwd, plain_bwd, flush,
                                         **quick)
        fused_ms = statistics.median(device_times(
            torch, lambda: fo._launch(x, *weights), l2_flush=flush, **quick))
        _, mf, gf = fo._launch(x, *weights)
        fused_bwd_ms = statistics.median(device_times(
            torch, lambda: fo._launch_backward(x, *weights, dy, mf, gf),
            l2_flush=flush, **quick))
        n_bytes = 2 * x.numel() * 4 + 4 * (2 * c * cr + c + cr)
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        rows.append(dict(
            shape=list(shape), cr=cr, bands=list(SP_BANDS),
            max_abs_err=max(v for k, v in errs.items()
                            if k.startswith('y/')),
            errors=errs, ms=ms, plain_ms=plain_ms, fused_ms=fused_ms,
            bound_ms=bound_ms, bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
            fused_bwd_ms=fused_bwd_ms, bwd_bound_ms=k1_bwd_bound_ms(x, cr),
            card=card_line()))
        grads = max(v for k, v in errs.items() if k[0] == 'd')
        mixed = max(v for k, v in errs.items() if k.startswith('mixed'))
        print(f'K1 band {label} x{list(shape)} cr={cr}: {SP_BANDS} bands '
              f'against float64, max|d| y {rows[-1]["max_abs_err"]:.2e}, '
              f'gradients / scale {grads:.2e}, mixed max|d|/max|ref| '
              f'{mixed:.2e}; one band forward {ms:.4f} ms (plain {plain_ms:.4f}, fused '
              f'K1 {fused_ms:.4f}, bound {bound_ms:.4f} ms by bytes), '
              f'backward {bwd_ms:.4f} ms (plain {bwd_plain_ms:.4f}, fused K1 '
              f'{fused_bwd_ms:.4f}, bound {rows[-1]["bwd_bound_ms"]:.4f}); '
              f'{card_line()}', flush=True)
    return rows


def _band_per_step(per_forward, ssim=True):
    """A flagship step's launches under a 'space' dim: each gate's forward
    two band stages and its backward two (`fused_channel_attention_band`'s
    counts), no fused K1, K6 as without it."""
    steps = _flagship_per_step(per_forward, ssim)
    for kind, bwd in (('train', True), ('eval', False)):
        steps[kind].update({'K1': 0, 'K1 backward': 0,
                            'K1 band': 2 * per_forward,
                            'K1 band backward': 2 * per_forward * bwd})
    return steps


def _sp_pair(torch, tds, mesh, config, label, steps, per_step, mesh_step,
             phase=24, dim='space'):
    """(b) the same run without a mesh and with `mesh` (a spatial mesh of
    one NCCL rank), from one seed, each traced with every launch counter
    at 0 just before (`_traced_run`) and its launches held against
    `per_step` (the mesh run's `mesh_step`): fithist and test_loss within
    SP_RTOL relative, the first step's gradients (`_sp_first_grads`)
    within SP_GRAD_RTOL and the parameters and buffers after the run
    within SP_PARAM_RTOL, each in the norm of the difference over the
    plain run's norm (a zero-initialised bias whose gradient is near zero
    takes Adam steps of either sign in two runs that differ in the last
    bits: its own relative error, printed with the worst tensor's name, is
    no criterion); the NCCL kernels of one replay of the mesh step and
    both replays' times. `phase` names the phase in the messages and `dim`
    the mesh dim of one rank that the trainer must hold ('space' or
    'model')."""
    import numpy as np
    runs = {}
    for name, m, want in (('plain', None, per_step),
                          ('mesh', mesh, mesh_step)):
        tr = tds.SupervisedTrainer(
            batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
            steps_per_epoch=steps, validation_steps=TRAIN_VAL_STEPS,
            test_steps=TRAIN_TEST_STEPS, mesh=m, **config)
        run_s, calls, kernels = _traced_run(torch, tds, tr)
        got = _check_launches(
            tds, tr.runner, f'phase {phase} ({label}, {name})', want,
            {'step': TRAIN_EPOCHS * steps,
             'val': TRAIN_EPOCHS * TRAIN_VAL_STEPS,
             'test': TRAIN_TEST_STEPS}, calls, kernels)
        runs[name] = dict(tr=tr, launches=got, calls=calls, run_s=run_s)
    plain, sp = runs['plain']['tr'], runs['mesh']['tr']
    if getattr(sp, f'{dim}_group') is None or getattr(sp, f'n_{dim}') != 1:
        fail(f'phase {phase} ({label}): the mesh trainer has no {dim} group '
             f'of one rank')
    losses = (plain.fithist['loss'] + plain.fithist['val_loss']
              + [plain.test_loss],
              sp.fithist['loss'] + sp.fithist['val_loss'] + [sp.test_loss])
    if not all(np.isfinite(v) for v in losses[1]):
        fail(f'phase {phase} ({label}): non-finite losses {sp.fithist}')
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(*losses))
    a, b = _state_of(plain), _state_of(sp)
    diff = sum(((a[n].double() - b[n].double()) ** 2).sum().item()
               for n in a)
    norm = sum((a[n].double() ** 2).sum().item() for n in a)
    param_rel = (diff / norm) ** 0.5
    worst = max(a, key=lambda n: (a[n].double() - b[n].double()).abs().max()
                .item() / max(a[n].double().abs().max().item(), 1e-30))
    worst_rel = ((a[worst].double() - b[worst].double()).abs().max().item()
                 / max(a[worst].double().abs().max().item(), 1e-30))
    grad_rel = _sp_first_grads(torch, tds, mesh, config)
    print(f'phase {phase} ({label}): mesh vs plain, {TRAIN_EPOCHS} epochs of '
          f'{steps} steps at batch {TRAIN_BATCH}: losses max relative '
          f'{loss_rel:.3e} (within {SP_RTOL} required), the first step\'s '
          f'gradients |d| / |plain| {grad_rel:.3e} (within {SP_GRAD_RTOL}), '
          f'parameters and buffers after the run {param_rel:.3e} (within '
          f'{SP_PARAM_RTOL}; the worst tensor {worst} max|d|/max|ref| '
          f'{worst_rel:.3e}); histories '
          f'{sp.fithist}, test loss {sp.test_loss} (plain {plain.fithist}, '
          f'{plain.test_loss})', flush=True)
    if not (loss_rel <= SP_RTOL and grad_rel <= SP_GRAD_RTOL
            and param_rel <= SP_PARAM_RTOL):
        fail(f'phase {phase} ({label}): the mesh run differs from the plain '
             f'run by {loss_rel:.3e} in the losses, {grad_rel:.3e} in the '
             f'first gradients, {param_rel:.3e} in the parameters')
    names = {k: _kernel_names(torch, runs[k]['tr'].runner.graphs['step'],
                              runs[k]['tr']) for k in runs}
    extra = names['mesh'] - names['plain']
    # at one rank NCCL's all-gathers, reduce-scatters and sums are device
    # copies, beside any kernel of its own
    nccl = {k: n for k, n in extra.items()
            if 'nccl' in k.lower() or 'onerank' in k.lower()
            or k == 'Memcpy DtoD'}
    if not nccl:
        fail(f'phase {phase} ({label}): one replay of the mesh step runs no '
             f'collective (its device work beyond the plain step\'s: '
             f'{dict(extra)})')
    replay_ms = {}
    for k, run in runs.items():
        graph, tr = run['tr'].runner.graphs['step'], run['tr']

        def replay(graph=graph, tr=tr):
            tr._row.zero_()
            graph.replay()
        replay_ms[k] = statistics.median(device_times(torch, replay,
                                                      reps=DP_REPLAYS))
    print(f'phase {phase} ({label}): the collectives\' device work in one '
          f'replay of the mesh step {nccl} ({sum(nccl.values())} a replay, '
          f'by name); all its device work beyond the plain step\'s '
          f'{dict(extra)}; one replay '
          f'{replay_ms["mesh"]:.3f} ms with the mesh, '
          f'{replay_ms["plain"]:.3f} ms without (median of {DP_REPLAYS}, '
          f'CUDA events); {card_line()}', flush=True)
    return dict(label=label, steps=steps, launches=runs['mesh']['launches'],
                wrapper_calls=runs['mesh']['calls'],
                plain_launches=runs['plain']['launches'],
                loss_rel=loss_rel, first_grad_rel=grad_rel,
                param_rel=param_rel, worst_tensor=worst,
                worst_tensor_rel=worst_rel,
                nccl_kernels=nccl, nccl_per_replay=sum(nccl.values()),
                extra_kernels=dict(extra), replay_ms=replay_ms,
                run_s={k: v['run_s'] for k, v in runs.items()},
                card=card_line())


def _sp_first_grads(torch, tds, mesh, config):
    """(b) one eager training step of the trainer without a mesh and with
    `mesh` from one seed on the same batch: the norm of the gradients'
    difference over the norm of the plain step's gradients."""
    trainers = []
    for m in (None, mesh):
        tr = tds.SupervisedTrainer(batch_size=TRAIN_BATCH, epochs=1, mesh=m,
                                   **config)
        tr.setup_datagen()
        tr.setup_model()
        tr.setup_optimizer()
        tr.train_net.train()
        trainers.append(tr)
    gen = torch.Generator().manual_seed(0)
    synth = trainers[0].ds_train
    batch = synth(synth.epoch_indices(gen, steps=1)[0], generator=gen)
    for tr in trainers:
        tr.train_step(batch)
    torch.cuda.synchronize()
    pairs = [(a.grad.double(), b.grad.double()) for a, b in
             zip(trainers[0]._params, trainers[1]._params)]
    diff = sum(((a - b) ** 2).sum().item() for a, b in pairs)
    return (diff / sum((a ** 2).sum().item() for a, _ in pairs)) ** 0.5


def _sp_serving(torch, tds, mesh):
    """(c) `predict(spatial_mesh=)` of the flagship without aux inputs at
    one rank against `predict`, and `make_spatial_sharded_step` at one rank
    against the plain loss and gradients of the same network."""
    import numpy as np
    from dl4ds_tpu_torch import parallel
    from dl4ds_tpu_torch.models import build_model
    model = build_model('resnet', 'spc', scale=SCALE, n_channels=1,
                        n_aux_channels=0, lr_size=(LR, LR),
                        hr_size=(LR * SCALE, LR * SCALE),
                        n_filters=N_FILTERS, n_blocks=N_BLOCKS,
                        attention=True)
    net = model.init(24, device='cuda')
    rng = np.random.default_rng(24)
    x = rng.standard_normal((SP_PREDICT_GRIDS, LR, LR, 1)).astype('float32')
    counters = _counters(tds)
    for _, fn, attr in counters:
        setattr(fn, attr, 0)
    y_sp = tds.predict((model, net), x, scale=SCALE, array_in_hr=False,
                       spatial_mesh=mesh, batch_size=BATCH)
    launches = {name: getattr(fn, attr) for name, fn, attr in counters}
    y = tds.predict((model, net), x, scale=SCALE, array_in_hr=False,
                    batch_size=BATCH)
    pred_err = float(np.abs(y_sp - y).max())
    if y_sp.shape != (SP_PREDICT_GRIDS, LR * SCALE, LR * SCALE, 1) or \
            not np.isfinite(y_sp).all() or not pred_err <= \
            PREDICT_TOL['atol']:
        fail(f'phase 24 (c): predict(spatial_mesh=) {y_sp.shape}, max|d| '
             f'{pred_err:.3e} from predict')
    step = parallel.make_spatial_sharded_step(model, mesh, halo=8)
    params = {k: v.detach().clone() for k, v in net.named_parameters()}
    xs = rng.standard_normal((SP_STEP_BATCH, SP_STEP_LR, SP_STEP_LR, 1)
                             ).astype('float32')
    ys = rng.standard_normal((SP_STEP_BATCH, SP_STEP_LR * SCALE,
                              SP_STEP_LR * SCALE, 1)).astype('float32')
    loss, grads = step.loss_and_grads(params, xs, ys, 0)
    net.train()
    out = net(torch.from_numpy(xs).cuda(), None)
    want = (out.float() - torch.from_numpy(ys).cuda()).abs().mean()
    ref = torch.autograd.grad(want, list(net.parameters()))
    net.eval()
    loss_rel = abs(loss.item() - want.item()) / abs(want.item())
    grad_rel = max(_rel_err(grads[k], r) for (k, _), r in
                   zip(net.named_parameters(), ref))
    print(f'phase 24 (c): predict(spatial_mesh=) of {SP_PREDICT_GRIDS} '
          f'{LR}x{LR} grids at one rank, max|d| {pred_err:.3e} from predict '
          f'(launches {launches}); the standalone step at batch '
          f'{SP_STEP_BATCH}, {SP_STEP_LR}x{SP_STEP_LR}: loss relative '
          f'{loss_rel:.3e}, gradients max|d|/max|ref| {grad_rel:.3e} from '
          f'the plain ones', flush=True)
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-4):
        fail(f'phase 24 (c): the standalone step differs from the plain '
             f'loss ({loss_rel:.3e}) or gradients ({grad_rel:.3e})')
    return dict(predict_max_abs_diff=pred_err, predict_launches=launches,
                step_loss_rel=loss_rel, step_grad_rel=grad_rel)


def phase_spatial_parallel(torch, tds, report):
    """Phase 24: spatial parallelism at the card's count of one: (a) K1's
    band mode at the flagship step's and the serving gates, (b) the
    flagship and recresnet_spc trained on a spatial mesh of one NCCL rank
    against no mesh, (c) `predict(spatial_mesh=)` and the standalone step
    at one rank."""
    import dl4ds_tpu_torch.ops.convlstm as conv
    parts = {}
    t0 = time.perf_counter()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device='cuda')
    report['sp_train_rows'] = _band_gate_rows(torch, tds, K1_TRAIN_SHAPES,
                                              'train', flush)
    report['sp_serve_rows'] = _band_gate_rows(
        torch, tds, [(BATCH,) + s for s in K1_SHAPES], 'serve', flush)
    del flush
    parts['a'] = round(time.perf_counter() - t0, 1)
    print(f'phase 24 (a): {parts["a"]} s', flush=True)
    dev = tds.distributed.initialize(f'127.0.0.1:{_free_port()}', 1, 0,
                                     device='cuda', timeout=300)
    mesh = tds.distributed.spatial_mesh(1, 1)
    space = tds.distributed.spatial_mesh()
    print(f'phase 24: a fresh process group '
          f'{torch.distributed.get_backend()} on {dev}; meshes {mesh}, '
          f'{space}', flush=True)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    per_forward = report['flag_k1_per_forward']
    out = {}
    try:
        t0 = time.perf_counter()
        flag = _training_config(loss=FLAG_LOSS, n_filters=N_FILTERS,
                                n_blocks=N_BLOCKS, attention=True)
        out['flagship'] = _sp_pair(
            torch, tds, mesh, flag, f'flagship, {FLAG_LOSS}', SP_STEPS,
            _flagship_per_step(per_forward), _band_per_step(per_forward))
        rec = _training_config(loss='mae', time_window=REC_T,
                               n_blocks=REC_BLOCKS, n_filters=N_FILTERS)
        rec_step = _recurrent_per_step(conv, K3_LAYERS)
        out['recurrent'] = _sp_pair(
            torch, tds, mesh, rec, f'recresnet_spc n_filters {N_FILTERS}',
            SP_REC_STEPS, rec_step, rec_step)
        parts['b'] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        out['serving'] = _sp_serving(torch, tds, space)
        parts['c'] = round(time.perf_counter() - t0, 1)
        from dl4ds_tpu_torch.ops import fused_ops as fo
        busy = [name for name, t in fo._COUNTERS.items()
                if int(t.count_nonzero()) != 0]
        if busy:
            fail(f'phase 24: arrival counters {busy} not left at 0')
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
        torch.distributed.destroy_process_group()
    if torch.distributed.is_initialized():
        fail('phase 24: the process group outlived the phase')
    out['parts_s'] = parts
    print(f'phase 24 parts (s): {parts}', flush=True)
    report['sp'] = out


def _sp_kernel_rows(report):
    """The `kernels` line's rows of phase 24: K1's band mode at the
    flagship step's gates (timed in (a), launched in (b)'s mesh run, whose
    device trace counts them), and the kernels that (b) runs as without a
    mesh, K6 on the joined rows and K2-train and K3 under the replicate
    rule, with the times of phases 6 and 9 at their shapes."""
    sp = report['sp']
    flag, rec = sp['flagship'], sp['recurrent']
    rows = report['sp_train_rows']
    k6 = report['k6_rows'][0]
    step, k3_rows = report['k3_step'], report['k3_rows']
    common = dict(route='cuda', library_ms=None)
    k1 = dict(common, name='K1_channel_attention_band_train',
              source='dl4ds_tpu_torch/csrc/channel_attention.cu',
              replaces='dl4ds_tpu/ops/pallas_ops.py:39',
              launches=flag['launches']['K1 band'],
              wrapper_calls=flag['wrapper_calls']['K1 band'],
              max_abs_err=max(r['max_abs_err'] for r in rows),
              ms=sum(r['ms'] for r in rows),
              plain_ms=sum(r['plain_ms'] for r in rows),
              bound_ms=sum(r['bound_ms'] for r in rows), bound_by='bytes',
              fused_ms=sum(r['fused_ms'] for r in rows),
              bwd_ms=sum(r['bwd_ms'] for r in rows),
              bwd_plain_ms=sum(r['bwd_plain_ms'] for r in rows),
              bwd_bound_ms=sum(r['bwd_bound_ms'] for r in rows),
              fused_bwd_ms=sum(r['fused_bwd_ms'] for r in rows),
              bwd_launches=flag['launches']['K1 band backward'],
              bwd_wrapper_calls=flag['wrapper_calls']['K1 band backward'],
              serve_ms=sum(r['ms'] for r in report['sp_serve_rows']),
              serve_fused_ms=sum(r['fused_ms']
                                 for r in report['sp_serve_rows']),
              work=f'the {len(rows)} gates of one flagship training step at '
                   f'batch {TRAIN_BATCH} in the band mode at one band (the '
                   f'card\'s count), summed: ms the forward\'s two stages, '
                   f'bwd_ms the backward\'s, fused_* fused K1 at the same '
                   f'shapes; launches one a stage (two each way a gate) in '
                   f'SupervisedTrainer(mesh=spatial_mesh(1, 1))\'s device '
                   f'trace; max_abs_err y against float64 over '
                   f'{list(SP_BANDS)} bands; serve_* the serving gates')
    k6_row = dict(common, name='K6_ssim_space_train',
                  source='dl4ds_tpu_torch/csrc/ssim.cu',
                  replaces='dl4ds_tpu/ops/pallas_ops.py:145',
                  launches=flag['launches']['K6'],
                  wrapper_calls=flag['wrapper_calls']['K6'],
                  max_abs_err=k6['max_abs_err'], ms=k6['ms'],
                  plain_ms=k6['plain_ms'], bound_ms=k6['bound_ms'],
                  bound_by=k6['bound_by'], bwd_ms=k6['bwd_ms'],
                  bwd_bound_ms=k6['bwd_bound_ms'],
                  bwd_plain_ms=k6['bwd_plain_ms'],
                  bwd_launches=flag['launches']['K6 backward'],
                  work=f'the {FLAG_LOSS} loss of the flagship under the '
                       f'spatial mesh, on the joined rows (phase 9\'s shape '
                       f'and times)')
    rec_work = (f'recresnet_spc under SupervisedTrainer(mesh=spatial_mesh('
                f'1, 1)), the ConvLSTM layers by the replicate rule (phase '
                f'7\'s layers; phase 6\'s times)')
    k2 = dict(common, name='K2_convlstm_train_space',
              source='dl4ds_tpu_torch/csrc/convlstm.cu',
              replaces='dl4ds_tpu/ops/pallas_convlstm.py:219',
              launches=rec['launches']['K2-train'],
              max_abs_err=max(max(r['ys_cs_zs_err'][:2]) for r in k3_rows
                              if 'ys_cs_zs_err' in r),
              ms=sum(r['k2_ms'] for r in step),
              plain_ms=sum(r['k2_plain_ms'] for r in step),
              bound_ms=sum(r['k2_bound_ms'] for r in step),
              bound_by='operations', work=rec_work)
    k3 = dict(common, name='K3_convlstm_bptt_space',
              source='dl4ds_tpu_torch/csrc/convlstm_bwd.cu',
              replaces='dl4ds_tpu/ops/pallas_convlstm.py:335',
              launches=rec['launches']['K3'],
              max_abs_err=max(max(v for k, v in r['grad_rel_err'].items()
                                  if k != 'plain_f32') for r in k3_rows),
              ms=sum(r['k3_ms'] for r in step),
              plain_ms=sum(r['k3_plain_ms'] for r in step),
              bound_ms=sum(r['k3_bound_ms'] for r in step),
              bound_by='operations', work=rec_work)
    return [k1, k6_row, k2, k3]


# phase 25: tensor and pipeline parallelism at the card's count of one
TP_STEPS, TP_REC_STEPS = 4, 3       # steps an epoch of (a)'s pairs
TP_STEP_BATCH, TP_STEP_LR = 4, 64   # (b): the standalone step's batch
# (c): the stage program of two stages and two microbatches, in one process
# (`parallel._pipeline_trunk_local`: a pipeline of one stage is refused,
# and NCCL takes no two ranks on one card), at the training batch; held
# against the card's own unpipelined step on the same batch (the trunk's
# weight gradients are summed over two microbatches, not one batch: max
# |d| within PP_GRAD_RTOL of max |ref|) and, at PP_CPU_BATCH, against the
# unpipelined program in float64 on the CPU, the loss within
# TRAIN_LOSS_RTOL and each gradient within PP_CPU_RTOL of its max |ref| or
# within twice the card's own unpipelined float32 step's distance from
# float64 (both on PyTorch's own convolutions, as phases 7-8 run theirs: at
# width 64 the card's float32 step itself lands up to 1e-2 of max |ref|
# from float64 in a small gradient)
PP_STAGES, PP_MICRO, PP_CPU_BATCH = 2, 2, 4
PP_GRAD_RTOL, PP_CPU_RTOL = 1e-4, 1e-4


def _tp_step(torch, tds, mesh, per_forward):
    """(b) `make_tensor_sharded_step` of the flagship at one rank against
    the plain loss and gradients of the same network; its K1 launches."""
    import numpy as np
    from dl4ds_tpu_torch import parallel
    from dl4ds_tpu_torch.models import build_model
    model = build_model('resnet', 'spc', scale=SCALE, n_channels=1,
                        n_aux_channels=0, lr_size=(TP_STEP_LR, TP_STEP_LR),
                        hr_size=(TP_STEP_LR * SCALE, TP_STEP_LR * SCALE),
                        n_filters=N_FILTERS, n_blocks=N_BLOCKS,
                        attention=True)
    net = model.init(25, device='cuda')
    step = parallel.make_tensor_sharded_step(model, mesh)
    params = parallel.place_params(
        {k: v.detach() for k, v in net.named_parameters()},
        step.param_shardings, mesh)
    rng = np.random.default_rng(25)
    xs = rng.standard_normal((TP_STEP_BATCH, TP_STEP_LR, TP_STEP_LR, 1)
                             ).astype('float32')
    ys = rng.standard_normal((TP_STEP_BATCH, TP_STEP_LR * SCALE,
                              TP_STEP_LR * SCALE, 1)).astype('float32')
    counters = _counters(tds)
    for _, fn, attr in counters:
        setattr(fn, attr, 0)
    loss, grads = step.loss_and_grads(params, xs, ys, 0)
    torch.cuda.synchronize()
    launches = {name: getattr(fn, attr) for name, fn, attr in counters
                if getattr(fn, attr)}
    net.train()
    out = net(torch.from_numpy(xs).cuda(), None)
    want = (out.float() - torch.from_numpy(ys).cuda()).abs().mean()
    ref = torch.autograd.grad(want, list(net.parameters()))
    net.eval()
    loss_rel = abs(loss.item() - want.item()) / abs(want.item())
    grad_rel = max(_rel_err(grads[k], r) for (k, _), r in
                   zip(net.named_parameters(), ref))
    n_sharded = sum(d is not None for d in step.param_shardings.values())
    print(f'phase 25 (b): make_tensor_sharded_step at one rank, batch '
          f'{TP_STEP_BATCH}, {TP_STEP_LR}x{TP_STEP_LR}: {n_sharded} of '
          f'{len(params)} parameters sharded; loss relative {loss_rel:.3e}, '
          f'gradients max|d|/max|ref| {grad_rel:.3e} from the plain ones; '
          f'launches {launches}', flush=True)
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-4):
        fail(f'phase 25 (b): the standalone step differs from the plain '
             f'loss ({loss_rel:.3e}) or gradients ({grad_rel:.3e})')
    if launches != {'K1': per_forward, 'K1 backward': per_forward}:
        fail(f'phase 25 (b): launches {launches}, expected K1 and its '
             f'backward {per_forward} each (the gates on gathered weights)')
    return dict(loss_rel=loss_rel, grad_rel=grad_rel, launches=launches,
                n_sharded=n_sharded)


def _pp_expected(conv, layers, batch):
    """{counter: launches} of one training call of each (Cin, F, k) layer
    at `batch` (`_expected_launches`' rule, the route of each layer at this
    batch)."""
    k3 = k4 = 0
    for cin, f, k in layers:
        route = conv.dispatch_info((batch, REC_T, TRAIN_LR, TRAIN_LR, cin),
                                   (k, k, cin, 4 * f), (k, k, f, 4 * f),
                                   4)['path']
        if route == 'fused':
            k3 += REC_T + (cin != 1) + 3
        else:
            k4 += REC_T
    return {'K2-train': len(layers) * REC_T, 'K3': k3, 'K4': k4}


def _k4_layer_rows(torch, layers, label, batch, seed=350):
    """K2's training variant and K4 at (Cin, F, k) layers at `batch`, T
    REC_T, TRAIN_LR frames, held against their plain versions
    (`_check_k4_case`) and timed against them and their bounds."""
    import dl4ds_tpu_torch.ops.convlstm as conv
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = []
    for i, (cin, f, k) in enumerate(layers):
        wx, bx, wh = _layer_weights(torch, cin, f, k, k, seed + i, dev)
        x = torch.randn((batch, REC_T, TRAIN_LR, TRAIN_LR, cin),
                        generator=gen, device=dev)
        dys = torch.randn((batch, REC_T, TRAIN_LR, TRAIN_LR, f),
                          generator=gen, device=dev)
        what = f'{label} x{list(x.shape)} F={f} k={k}'
        (dzs_err, _, errs, fwd_err), (ys, cs, zs, _) = _check_k4_case(
            torch, conv, x, wx, bx, wh, dys, True, what)
        with torch.no_grad():
            k2_ms, k2_plain_ms = paired_ms(
                torch, lambda: conv._launch(x, wx, bx, wh, train=True),
                lambda: conv.convlstm_train_reference(x, wx, bx, wh), flush)
            k4_ms, k4_plain_ms = paired_ms(
                torch, lambda: conv._launch_seq(zs, cs, dys, wh),
                lambda: conv.convlstm_seq_reference(zs, cs, dys, wh), flush)
        k2_flops, k2_bytes = k2_work(x, wx, wh)
        k2_bytes += 4 * 5 * ys.numel()
        flops, n_bytes = k4_work(zs, wh)
        rows.append(dict(
            x=list(x.shape), f=f, k=k, ys_cs_zs_err=fwd_err[:3],
            dzs_rel_err=dzs_err, grad_rel_err=errs, k2_ms=k2_ms,
            k2_plain_ms=k2_plain_ms,
            k2_bound_ms=max(k2_flops / F32_FLOPS,
                            k2_bytes / HBM_BYTES_PER_S) * 1e3,
            k4_ms=k4_ms, k4_plain_ms=k4_plain_ms,
            k4_bound_ms=max(flops / F32_FLOPS,
                            n_bytes / HBM_BYTES_PER_S) * 1e3))
        print(f'K2-train/K4 {what}: dzs max|d|/max(1, max|ref|) '
              f'{dzs_err:.2e}  K2-train {k2_ms:.4f} ms (plain '
              f'{k2_plain_ms:.4f}, bound {rows[-1]["k2_bound_ms"]:.4f})  K4 '
              f'{k4_ms:.4f} ms (plain {k4_plain_ms:.4f}, bound '
              f'{rows[-1]["k4_bound_ms"]:.4f}); {card_line()}', flush=True)
        del x, dys, ys, cs, zs
        torch.cuda.empty_cache()
    return rows


def _pp_case(torch, tds, f, layers, label):
    """(c) recresnet_spc at width `f` (REC_BLOCKS trunk blocks, one a
    stage): the stage program of PP_STAGES stages and PP_MICRO microbatches
    in one process at the training batch, its launches counted (every
    counter at 0 just before, read just after; the forward's a tick, by a
    wrapper around `_stage_tick`) and its loss and gradients held against
    the card's unpipelined step; at PP_CPU_BATCH against the unpipelined
    program in float64 on the CPU; one microbatch's trunk layers timed
    against their plain versions and bounds."""
    import numpy as np
    import dl4ds_tpu_torch.ops.convlstm as conv
    from dl4ds_tpu_torch import parallel
    from dl4ds_tpu_torch.models import build_model
    model = build_model('resnet', 'spc', scale=SCALE, n_channels=1,
                        n_aux_channels=0, lr_size=(TRAIN_LR, TRAIN_LR),
                        hr_size=(TRAIN_PATCH, TRAIN_PATCH),
                        time_window=REC_T, n_filters=f, n_blocks=REC_BLOCKS)
    net = model.init(25, device='cuda')
    named = {k: v.detach() for k, v in net.named_parameters()}
    parts = parallel._split_trunk(named, REC_BLOCKS)
    rng = np.random.default_rng(25)
    x = rng.standard_normal((TRAIN_BATCH, REC_T, TRAIN_LR, TRAIN_LR, 1)
                            ).astype('float32')
    y = rng.standard_normal((TRAIN_BATCH, REC_T, TRAIN_PATCH, TRAIN_PATCH, 1)
                            ).astype('float32')
    counters = [c for c in _counters(tds)
                if c[0] in ('K2-train', 'K3', 'K4')]
    ticks = []
    real_tick = parallel._stage_tick

    def counted_tick(block, local, d, n_micro, t, x0_mb, slot, gen_for):
        before = tds.fused_convlstm.train_launches
        out = real_tick(block, local, d, n_micro, t, x0_mb, slot, gen_for)
        ticks.append((t, d, tds.fused_convlstm.train_launches - before))
        return out
    for _, fn, attr in counters:
        setattr(fn, attr, 0)
    parallel._stage_tick = counted_tick
    try:
        loss, grads = parallel._pipeline_trunk_local(
            model, parts, x, y, 0, n_stages=PP_STAGES, n_micro=PP_MICRO)
        torch.cuda.synchronize()
    finally:
        parallel._stage_tick = real_tick
    launches = {name: getattr(fn, attr) for name, fn, attr in counters}
    micro = TRAIN_BATCH // PP_MICRO
    stem = _pp_expected(conv, layers[:2], TRAIN_BATCH)
    block = _pp_expected(conv, layers[2:4], micro)
    want = {k: stem[k] + PP_MICRO * REC_BLOCKS * block[k] for k in stem}
    want_ticks = [(t, d, block['K2-train'] * (REC_BLOCKS // PP_STAGES)
                   if 0 <= t - d < PP_MICRO else 0)
                  for t in range(PP_MICRO + PP_STAGES - 1)
                  for d in range(PP_STAGES)]
    print(f'phase 25 (c) {label}: {PP_STAGES} stages x {PP_MICRO} '
          f'microbatches of {micro}: launches {launches} (expected {want}: '
          f'the stem {stem} on the batch, a trunk block {block} a '
          f'microbatch); K2-train a (tick, stage) {ticks}', flush=True)
    if launches != want or ticks != want_ticks:
        fail(f'phase 25 (c) {label}: launches {launches} and by tick '
             f'{ticks}, expected {want} and {want_ticks}')
    net.train()
    out = net(torch.from_numpy(x).cuda(), None)
    ref_loss = (out.float() - torch.from_numpy(y).cuda()).abs().mean()
    ref = dict(zip(named, torch.autograd.grad(ref_loss,
                                              list(net.parameters()))))
    net.eval()
    got = parallel._merge_trunk(*grads, REC_BLOCKS, list(named))
    loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    grad_rel = max(_rel_err(got[k], ref[k]) for k in named)
    # the CPU in float64 at PP_CPU_BATCH: the pipelined program and the
    # unpipelined step on the card, their convolutions PyTorch's own
    xs, ys = x[:PP_CPU_BATCH], y[:PP_CPU_BATCH]
    torch.backends.cudnn.enabled = False
    try:
        loss_s, grads_s = parallel._pipeline_trunk_local(
            model, parts, xs, ys, 0, n_stages=PP_STAGES, n_micro=PP_MICRO)
        net.train()
        out_s = net(torch.from_numpy(xs).cuda(), None)
        plain_loss = (out_s.float() - torch.from_numpy(ys).cuda()).abs(
            ).mean()
        plain = dict(zip(named, torch.autograd.grad(
            plain_loss, list(net.parameters()))))
        net.eval()
    finally:
        torch.backends.cudnn.enabled = True
    got_s = parallel._merge_trunk(*grads_s, REC_BLOCKS, list(named))
    cpu = model.init(25, device='cpu').double().train()
    with torch.no_grad():
        for k, p in cpu.named_parameters():
            p.copy_(named[k].double().cpu())
    out64 = cpu(torch.from_numpy(xs).double(), None)
    loss64 = (out64 - torch.from_numpy(ys).double()).abs().mean()
    ref64 = dict(zip(named, torch.autograd.grad(loss64,
                                                list(cpu.parameters()))))
    cpu_loss_rel = abs(loss_s.item() - loss64.item()) / abs(loss64.item())
    errs = {k: (_rel_err(got_s[k].cpu(), ref64[k]),
                _rel_err(plain[k].cpu(), ref64[k])) for k in named}
    worst = max(errs, key=lambda k: errs[k][0])
    cpu_grad_rel = errs[worst][0]
    off = [k for k, (e, own) in errs.items()
           if not e <= max(PP_CPU_RTOL, 2 * own)]
    print(f'phase 25 (c) {label}: against the card\'s unpipelined step at '
          f'batch {TRAIN_BATCH}: loss relative {loss_rel:.3e}, gradients '
          f'max|d|/max|ref| {grad_rel:.3e} (within {PP_GRAD_RTOL}); at batch '
          f'{PP_CPU_BATCH} against the CPU in float64: loss '
          f'{cpu_loss_rel:.3e} (within {TRAIN_LOSS_RTOL}), gradients up to '
          f'{cpu_grad_rel:.3e} ({worst}; the card\'s unpipelined step '
          f'{errs[worst][1]:.3e} there, its largest '
          f'{max(e[1] for e in errs.values()):.3e}; each within '
          f'{PP_CPU_RTOL} or twice the unpipelined step\'s)', flush=True)
    if not (loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= PP_GRAD_RTOL
            and cpu_loss_rel <= TRAIN_LOSS_RTOL and not off):
        fail(f'phase 25 (c) {label}: the pipelined step differs: loss '
             f'{loss_rel:.3e} / {cpu_loss_rel:.3e}, gradients '
             f'{grad_rel:.3e} / {cpu_grad_rel:.3e} (past their bound: '
             f'{ {k: errs[k] for k in off} })')
    del net, out, grads, got, ref
    torch.cuda.empty_cache()
    trunk = [(cin, ff, k) for cin, ff, k in layers[2:4]]
    if block['K4']:
        rows = _k4_layer_rows(torch, trunk, f'phase 25 (c) {label}', micro)
    else:
        rows = _k3_layer_rows(torch, [layer + (True,) for layer in trunk],
                              f'phase 25 (c) {label}', seed=360,
                              batch=micro)
    return dict(label=label, launches=launches, expected=want,
                ticks=ticks, loss_rel=loss_rel, grad_rel=grad_rel,
                cpu_loss_rel=cpu_loss_rel, cpu_grad_rel=cpu_grad_rel,
                cpu_worst=worst, cpu_plain_rel=errs[worst][1],
                micro_rows=rows, card=card_line())


def phase_tensor_pipeline_parallel(torch, tds, report):
    """Phase 25: tensor and pipeline parallelism at the card's count of
    one: (a) the flagship (dssim_mae) and recresnet_spc trained on a
    ('data', 'model') mesh of one NCCL rank against no mesh, (b) the
    standalone tensor-sharded step at one rank, (c) the pipeline's stage
    program at two stages in one process, at widths 8 and 64."""
    import dl4ds_tpu_torch.ops.convlstm as conv
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    torch.backends.cuda.matmul.allow_tf32 = False
    parts = {}
    dev = tds.distributed.initialize(f'127.0.0.1:{_free_port()}', 1, 0,
                                     device='cuda', timeout=300)
    mesh = tds.distributed.tensor_mesh(1, 1)
    print(f'phase 25: a fresh process group '
          f'{torch.distributed.get_backend()} on {dev}; mesh {mesh}',
          flush=True)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    per_forward = report['flag_k1_per_forward']
    out = {}
    try:
        t0 = time.perf_counter()
        flag = _training_config(loss=FLAG_LOSS, n_filters=N_FILTERS,
                                n_blocks=N_BLOCKS, attention=True)
        step = _flagship_per_step(per_forward)
        out['flagship'] = _sp_pair(
            torch, tds, mesh, flag, f'flagship, {FLAG_LOSS}', TP_STEPS,
            step, step, phase=25, dim='model')
        rec = _training_config(loss='mae', time_window=REC_T,
                               n_blocks=REC_BLOCKS, n_filters=N_FILTERS)
        rec_step = _recurrent_per_step(conv, K3_LAYERS)
        out['recurrent'] = _sp_pair(
            torch, tds, mesh, rec, f'recresnet_spc n_filters {N_FILTERS}',
            TP_REC_STEPS, rec_step, rec_step, phase=25, dim='model')
        parts['a'] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        out['step'] = _tp_step(torch, tds, tds.distributed.tensor_mesh(),
                               per_forward)
        parts['b'] = round(time.perf_counter() - t0, 1)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
        torch.distributed.destroy_process_group()
    if torch.distributed.is_initialized():
        fail('phase 25: the process group outlived the phase')
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False     # (c) holds float32 sums
    out['pipe8'] = _pp_case(torch, tds, N_FILTERS, K3_LAYERS,
                            f'recresnet_spc n_filters {N_FILTERS}')
    out['pipe64'] = _pp_case(torch, tds, WIDE_F, WIDE_LAYERS,
                             f'recresnet_spc n_filters {WIDE_F}')
    parts['c'] = round(time.perf_counter() - t0, 1)
    out['parts_s'] = parts
    print(f'phase 25 parts (s): {parts}', flush=True)
    report['tp'] = out


def _tp_kernel_rows(report):
    """The `kernels` line's rows of phase 25: K1 fused on gathered weights
    and K6 in the flagship's mesh run (phases 10 and 9's times at their
    shapes), K2-train and K3 under the tensor rules in the recurrent mesh
    run (phase 6's), and K2-train, K3 and K4 on the pipeline's microbatches
    (timed in (c) at a microbatch's trunk layers)."""
    tp = report['tp']
    flag, rec = tp['flagship'], tp['recurrent']
    gates = report['k1_train_rows']
    k6 = report['k6_rows'][0]
    step, k3_rows = report['k3_step'], report['k3_rows']
    p8, p64 = tp['pipe8'], tp['pipe64']
    r8, r64 = p8['micro_rows'], p64['micro_rows']
    common = dict(route='cuda', library_ms=None)
    micro = TRAIN_BATCH // PP_MICRO
    pipe_work = (f'one microbatch ({micro} of {TRAIN_BATCH}) through a trunk '
                 f'block\'s two layers, timed in phase 25 (c); launches of '
                 f'the stage program, {PP_STAGES} stages x {PP_MICRO} '
                 f'microbatches, stem included')
    return [
        dict(common, name='K1_channel_attention_model_train',
             source='dl4ds_tpu_torch/csrc/channel_attention.cu',
             replaces='dl4ds_tpu/ops/pallas_ops.py:39',
             launches=flag['launches']['K1'],
             wrapper_calls=flag['wrapper_calls']['K1'],
             max_abs_err=max(r['max_abs_err'] for r in gates),
             ms=sum(r['ms'] for r in gates),
             plain_ms=sum(r['plain_ms'] for r in gates),
             bound_ms=sum(r['bound_ms'] for r in gates), bound_by='bytes',
             bwd_ms=sum(r['bwd_ms'] for r in gates),
             bwd_plain_ms=sum(r['bwd_plain_ms'] for r in gates),
             bwd_bound_ms=sum(r['bwd_bound_ms'] for r in gates),
             bwd_launches=flag['launches']['K1 backward'],
             work=f'the {len(gates)} gates of a flagship step under '
                  f'SupervisedTrainer(mesh=tensor_mesh(1, 1)), fused on the '
                  f'gathered weights (phase 10\'s shapes and times)'),
        dict(common, name='K6_ssim_model_train',
             source='dl4ds_tpu_torch/csrc/ssim.cu',
             replaces='dl4ds_tpu/ops/pallas_ops.py:145',
             launches=flag['launches']['K6'], max_abs_err=k6['max_abs_err'],
             ms=k6['ms'], plain_ms=k6['plain_ms'], bound_ms=k6['bound_ms'],
             bound_by=k6['bound_by'], bwd_ms=k6['bwd_ms'],
             bwd_bound_ms=k6['bwd_bound_ms'],
             bwd_plain_ms=k6['bwd_plain_ms'],
             bwd_launches=flag['launches']['K6 backward'],
             work=f'the {FLAG_LOSS} loss of the flagship under the tensor '
                  f'mesh (phase 9\'s shape and times)'),
        dict(common, name='K2_convlstm_train_model',
             source='dl4ds_tpu_torch/csrc/convlstm.cu',
             replaces='dl4ds_tpu/ops/pallas_convlstm.py:219',
             launches=rec['launches']['K2-train'],
             max_abs_err=max(max(r['ys_cs_zs_err'][:2]) for r in k3_rows
                             if 'ys_cs_zs_err' in r),
             ms=sum(r['k2_ms'] for r in step),
             plain_ms=sum(r['k2_plain_ms'] for r in step),
             bound_ms=sum(r['k2_bound_ms'] for r in step),
             bound_by='operations',
             work='recresnet_spc under tensor_mesh(1, 1), the ConvLSTM '
                  'layers on gathered weights (phase 6\'s times)'),
        dict(common, name='K3_convlstm_bptt_model',
             source='dl4ds_tpu_torch/csrc/convlstm_bwd.cu',
             replaces='dl4ds_tpu/ops/pallas_convlstm.py:335',
             launches=rec['launches']['K3'],
             max_abs_err=max(max(v for k, v in r['grad_rel_err'].items()
                                 if k != 'plain_f32') for r in k3_rows),
             ms=sum(r['k3_ms'] for r in step),
             plain_ms=sum(r['k3_plain_ms'] for r in step),
             bound_ms=sum(r['k3_bound_ms'] for r in step),
             bound_by='operations',
             work='recresnet_spc under tensor_mesh(1, 1) (phase 6\'s times)'),
        dict(common, name='K2_convlstm_train_pipe',
             source='dl4ds_tpu_torch/csrc/convlstm.cu',
             replaces='dl4ds_tpu/ops/pallas_convlstm.py:219',
             launches=p8['launches']['K2-train'],
             wide_launches=p64['launches']['K2-train'],
             max_abs_err=max(max(r['ys_cs_zs_err'][:2]) for r in r8 + r64),
             ms=sum(r['k2_ms'] for r in r8),
             plain_ms=sum(r['k2_plain_ms'] for r in r8),
             bound_ms=sum(r['k2_bound_ms'] for r in r8),
             wide_ms=sum(r['k2_ms'] for r in r64),
             wide_plain_ms=sum(r['k2_plain_ms'] for r in r64),
             wide_bound_ms=sum(r['k2_bound_ms'] for r in r64),
             bound_by='operations',
             work=f'width {N_FILTERS} (wide_*: width {WIDE_F}), ' + pipe_work),
        dict(common, name='K3_convlstm_bptt_pipe',
             source='dl4ds_tpu_torch/csrc/convlstm_bwd.cu',
             replaces='dl4ds_tpu/ops/pallas_convlstm.py:335',
             launches=p8['launches']['K3'],
             max_abs_err=max(max(v for k, v in r['grad_rel_err'].items()
                                 if k != 'plain_f32') for r in r8),
             ms=sum(r['k3_ms'] for r in r8),
             plain_ms=sum(r['k3_plain_ms'] for r in r8),
             bound_ms=sum(r['k3_bound_ms'] for r in r8),
             bound_by='operations',
             work=f'width {N_FILTERS}, the \'fused\' route, ' + pipe_work),
        dict(common, name='K4_convlstm_seq_pipe',
             source='dl4ds_tpu_torch/csrc/convlstm_seq.cu',
             replaces='dl4ds_tpu/ops/pallas_convlstm.py:269',
             launches=p64['launches']['K4'],
             max_abs_err=max(r['dzs_rel_err'] for r in r64),
             ms=sum(r['k4_ms'] for r in r64),
             plain_ms=sum(r['k4_plain_ms'] for r in r64),
             bound_ms=sum(r['k4_bound_ms'] for r in r64),
             bound_by='operations',
             work=f'width {WIDE_F}, the \'split\' route, ' + pipe_work)]


# phase 26: recurrent deep ensembles. BASELINE config 4 (recresnet_spc x4,
# T 4, n_blocks 2, n_filters 8; bench_suite.py) as an ENS_M-member ensemble
# on phase 7's data: (a) the member mode of K2, K3 and K4 alone at the
# step's distinct layers, ENS_M members of TRAIN_BATCH samples, at widths 8
# and 64, float32 and bfloat16; (b) REC_ENS_STEPS steps against the CPU in
# float64 at batch REC_ENS_CPU_BATCH; (c) ENS_SPEED_STEPS eager steps at
# batch TRAIN_BATCH, REC_ENS_WIDE_STEPS at width 64, and predict_ensemble of
# REC_GRIDS grids; (d) the ('ensemble',) mesh at one NCCL rank.
REC_ENS_STEPS, REC_ENS_CPU_BATCH, REC_ENS_WIDE_STEPS = 3, 8, 2
REC_ENS_MESH_STEPS = 2
# the distinct (Cin, F, k) layers of config 4's step at each width, and
# whether x needs a gradient (the stem's input does not)
REC_MEMBER_LAYERS = {N_FILTERS: sorted(set(K3_LAYERS)),
                     WIDE_F: sorted(set(WIDE_LAYERS))}


def _member_stack(torch, cin, f, k, seed, dev, dtype):
    """ENS_M members' (wx, bx, wh) of one layer, Keras-initialised from
    seeds seed .. seed + ENS_M - 1, stacked [ENS_M, ...]."""
    members = [_layer_weights(torch, cin, f, k, k, seed + i, dev)
               for i in range(ENS_M)]
    return tuple(torch.stack([m[j] for m in members]).to(dtype)
                 for j in range(3))


def _counted(tds, fn):
    """fn() with every launch counter set to 0 just before; returns its
    result and the counters it moved, by name."""
    for _, o, a in _counters(tds):
        setattr(o, a, 0)
    out = fn()
    return out, {n: getattr(o, a) for n, o, a in _counters(tds)
                 if getattr(o, a)}


def _same_as_members(torch, label, got, ones, per_sample):
    """`got` (a member-mode call's outputs) the bits of `ones` (the M
    one-member calls' outputs): the per-sample outputs (the first
    `per_sample`) concatenated, the others (weight gradients) stacked."""
    for k, a in enumerate(got):
        if a is None:
            continue
        parts = [o[k] for o in ones]
        want = torch.cat(parts) if k < per_sample else torch.stack(parts)
        if a.dtype != want.dtype or not torch.equal(a, want):
            fail(f'{label}: output {k} is not the bits of {ENS_M} '
                 f'one-member calls')


def _member_layer(torch, tds, conv, cin, f, k, dtype, seed, flush):
    """One layer's member mode, `_rec_member_rows`' row."""
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = ENS_M * TRAIN_BATCH
    x = torch.randn((b, REC_T, TRAIN_LR, TRAIN_LR, cin), generator=gen,
                    device=dev).to(dtype)
    dys = torch.randn((b, REC_T, TRAIN_LR, TRAIN_LR, f), generator=gen,
                      device=dev).to(dtype)
    wx, bx, wh = _member_stack(torch, cin, f, k, seed, dev, dtype)
    need_dx = cin != 1
    elem = x.element_size()
    route = conv._route(x, wx, wh)
    counter = 'K3' if route == 'fused' else 'K4'
    bf16 = dtype == torch.bfloat16
    label = (f'member mode x{list(x.shape)} ({ENS_M} members) F={f} k={k} '
             f'{"bf16" if bf16 else "f32"} {route}')

    def member(t, i):
        return t[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]

    def one(i):
        return (member(x, i), wx[i], bx[i], wh[i])

    def bwd(args, w):
        xs, wxs, _, whs = w
        if route == 'fused':
            return conv._launch_backward(xs, wxs, whs, *args, need_dx)
        return (conv._launch_seq(args[0], args[1], args[3], whs),)

    with torch.no_grad():
        (ys, cs, zs), n_fwd = _counted(
            tds, lambda: conv._launch(x, wx, bx, wh, train=True))
        res = (zs, cs, ys, dys)
        grads, n_bwd = _counted(tds, lambda: bwd(res, (x, wx, bx, wh)))
        ys_inf, n_inf = _counted(tds, lambda: conv._launch(x, wx, bx, wh))
        fwd_ones, bwd_ones, inf_ones = [], [], []
        for i in range(ENS_M):
            o, n_fwd1 = _counted(tds, lambda: conv._launch(*one(i),
                                                           train=True))
            fwd_ones.append(o)
            bwd_ones.append(bwd([member(u, i) for u in res], one(i)))
            inf_ones.append((conv._launch(*one(i)),))
        n_bwd1 = _counted(tds, lambda: bwd([member(u, 0) for u in res],
                                           one(0)))[1]
        n_inf1 = _counted(tds, lambda: conv._launch(*one(0)))[1]
    torch.cuda.synchronize()
    _same_as_members(torch, f'K2-train {label}', (ys, cs, zs), fwd_ones, 3)
    _same_as_members(torch, f'K2 {label}', (ys_inf,), inf_ones, 1)
    _same_as_members(torch, f'{counter} {label}', grads, bwd_ones, 1)
    if (n_fwd, n_bwd, n_inf) != (n_fwd1, n_bwd1, n_inf1):
        fail(f'{label}: the member mode launched {n_fwd}, {n_bwd}, {n_inf}; '
             f'one member\'s calls {n_fwd1}, {n_bwd1}, {n_inf1}')
    row = dict(x=list(x.shape), cin=cin, f=f, k=k, route=route,
               dtype=str(dtype).replace('torch.', ''), dx=need_dx,
               launches=dict(k2_train=n_fwd, k2=n_inf, backward=n_bwd))
    if bf16:
        # phase 12's holds, on the member mode (the plain versions run
        # member by member)
        out = _check_bptt_bf16(torch, conv, x, wx, bx, wh, dys, need_dx,
                               route, label)
        row.update(ys_cs_zs_err=out['ys_cs_zs_err'],
                   grad_rel_err=out['grad_rel_err'])
        print(f'{label}: the bits of {ENS_M} one-member calls each way, '
              f'launches {row["launches"]} (one member\'s); plain version '
              f'{out["ys_cs_zs_err"]}, {out["grad_rel_err"]}; {card_line()}',
              flush=True)
        return row
    with torch.no_grad():
        want = conv.convlstm_train_reference(x, wx, bx, wh)
        args64 = [u.double() for u in (x, wx, wh, zs, cs, ys, dys)]
        if route == 'fused':
            ref = conv.convlstm_backward_reference(*args64)
        else:
            ref = (conv.convlstm_seq_reference(
                args64[3], args64[4], args64[6], args64[2]),)
    torch.cuda.synchronize()
    fwd_err = [(a - w).abs().max().item() for a, w in zip((ys, cs, zs),
                                                          want)]
    zs_scale = max(1.0, want[2].abs().max().item())
    if not (max(fwd_err[:2]) <= K2_TOL and fwd_err[2] <= K2_TOL * zs_scale):
        fail(f'K2-train {label}: ys, cs, zs max|d| {fwd_err}')
    if (ys_inf - want[0]).abs().max().item() > K2_TOL:
        fail(f'K2 {label}: ys max|d| against the plain version')
    if route == 'fused':
        errs = _check_grads(torch, grads, grads, ref, need_dx,
                            f'K3 {label}')
    else:
        scale = max(1.0, ref[0].abs().max().item())
        errs = {'dzs': (grads[0].double() - ref[0]).abs().max().item()
                / scale}
        if not errs['dzs'] <= K4_TOL:
            fail(f'K4 {label}: dzs max|d| / max(1, max|ref|) '
                 f'{errs["dzs"]:.3e}')
    w0 = one(0)
    zs0, cs0, ys0, dys0 = (member(u, 0) for u in res)
    if route == 'fused':
        kern = lambda: conv._launch_backward(x, wx, wh, zs, cs, ys, dys,  # noqa: E731
                                             need_dx)
        plain = lambda: conv.convlstm_backward_reference(  # noqa: E731
            x, wx, wh, zs, cs, ys, dys)
        kern1 = lambda: conv._launch_backward(  # noqa: E731
            w0[0], w0[1], w0[3], zs0, cs0, ys0, dys0, need_dx)
        flops, n_bytes = k3_work(x, wx[0], wh[0], need_dx)
    else:
        kern = lambda: conv._launch_seq(zs, cs, dys, wh)  # noqa: E731
        plain = lambda: conv.convlstm_seq_reference(zs, cs, dys, wh)  # noqa: E731
        kern1 = lambda: conv._launch_seq(zs0, cs0, dys0, w0[3])  # noqa: E731
        flops, n_bytes = k4_work(zs, wh[0])
    w_bytes = 4 * (ENS_M - 1) * (wx[0].numel() + 4 * f + wh[0].numel())
    with torch.no_grad():
        k2_ms, k2_plain_ms = paired_ms(
            torch, lambda: conv._launch(x, wx, bx, wh, train=True),
            lambda: conv.convlstm_train_reference(x, wx, bx, wh), flush)
        k2i_ms, k2i_plain_ms = paired_ms(
            torch, lambda: conv._launch(x, wx, bx, wh),
            lambda: conv.convlstm_reference(x, wx, bx, wh), flush)
        bwd_ms, bwd_plain_ms = paired_ms(torch, kern, plain, flush)
        times = {}
        for name, fn in (('k2', lambda: conv._launch(*w0, train=True)),
                         ('k2i', lambda: conv._launch(*w0)),
                         ('bwd', kern1)):
            times[name] = statistics.median(device_times(
                torch, fn, reps=40, l2_flush=flush))
    k2_flops, k2_bytes = k2_work(x, wx[0], wh[0])

    def bounds(key, n_ops, n_bytes):
        """`key`_bound_ms at the float32 rate outside the tensor cores and
        `key`_bound_3xtf32_ms at the 3xTF32 rate the products run at."""
        return {f'{key}_bound{sfx}_ms': max(n_ops / rate,
                                            n_bytes / HBM_BYTES_PER_S) * 1e3
                for sfx, rate in (('', F32_FLOPS), ('_3xtf32', TF32X3_FLOPS))}
    row.update(
        ys_cs_zs_err=fwd_err, grad_rel_err=errs, k2_ms=k2_ms,
        k2_plain_ms=k2_plain_ms, k2_one_ms=times['k2'],
        k2i_ms=k2i_ms, k2i_plain_ms=k2i_plain_ms, k2i_one_ms=times['k2i'],
        bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms, bwd_one_ms=times['bwd'],
        **bounds('k2', k2_flops, k2_bytes + w_bytes + 4 * 5 * ys.numel()),
        **bounds('k2i', k2_flops, k2_bytes + w_bytes),
        **bounds('bwd', flops, n_bytes + w_bytes))
    print(f'{label}: the bits of {ENS_M} one-member calls each way, launches '
          f'{row["launches"]} (one member\'s); ys, cs, zs max|d| '
          + ' '.join(f'{e:.2e}' for e in fwd_err) + f', {counter} '
          + ' '.join(f'{n} {v:.2e}' for n, v in errs.items())
          + f'; K2-train {k2_ms:.4f} ms (one member {times["k2"]:.4f}, plain '
          f'{k2_plain_ms:.4f}, bound {row["k2_bound_ms"]:.4f}, 3xTF32 '
          f'{row["k2_bound_3xtf32_ms"]:.4f}), K2 {k2i_ms:.4f} ms (one member '
          f'{times["k2i"]:.4f}), {counter} {bwd_ms:.4f} ms (one member '
          f'{times["bwd"]:.4f}, plain {bwd_plain_ms:.4f}, bound '
          f'{row["bwd_bound_ms"]:.4f}, 3xTF32 '
          f'{row["bwd_bound_3xtf32_ms"]:.4f}); '
          f'{card_line()}', flush=True)
    return row


def _rec_member_rows(torch, tds):
    """(a): the member mode of K2, K3 and K4 at config 4's distinct layers,
    widths 8 and 64, float32 (timed) and bfloat16."""
    import dl4ds_tpu_torch.ops.convlstm as conv
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device='cuda')
    rows = []
    for width, layers in REC_MEMBER_LAYERS.items():
        for dtype in (torch.float32, torch.bfloat16):
            for i, (cin, f, k) in enumerate(layers):
                rows.append(_member_layer(torch, tds, conv, cin, f, k, dtype,
                                          400 + 10 * i + width, flush))
                torch.cuda.empty_cache()
    routes = {(r['f'], r['dtype'], r['route']) for r in rows}
    if not {(N_FILTERS, 'float32', 'fused'), (WIDE_F, 'float32', 'split'),
            (N_FILTERS, 'bfloat16', 'fused'), (WIDE_F, 'bfloat16', 'split')
            } <= routes:
        fail(f'phase 26 (a) ran the routes {sorted(routes)}: both routes '
             f'in both dtypes are needed')
    return rows


def _rec_step_totals(rows, width, key):
    """The sum of `key` over config 4's six layers at `width`, float32."""
    by = {(r['cin'], r['f'], r['k']): r for r in rows
          if r['dtype'] == 'float32' and r['f'] == width}
    layers = K3_LAYERS if width == N_FILTERS else WIDE_LAYERS
    return sum(by[layer][key] for layer in layers)


def _rec_config(width=N_FILTERS):
    return _training_config(loss='mae', time_window=REC_T,
                            n_blocks=REC_BLOCKS, n_filters=width,
                            **({'attention': True} if width == WIDE_F
                               else {}))


def _rec_ensemble(torch, tds, report):
    """(b) and (c): the ensemble against the CPU, its speed and its
    launches, width 64's launches, predict_ensemble."""
    import numpy as np
    import dl4ds_tpu_torch.ops.convlstm as conv
    from dl4ds_tpu_torch import parallel
    out = {}
    per_step = _recurrent_per_step(conv, K3_LAYERS)['train']
    per_step = {k: v for k, v in per_step.items() if v}
    model, small = _ensemble_batches(torch, tds, _rec_config(),
                                     REC_ENS_CPU_BATCH, REC_ENS_STEPS)
    stacked = parallel.init_ensemble(model, ENS_M, seed=0)
    fcl = tds.fused_convlstm
    out['vs_cpu'] = _ensemble_vs_cpu(
        torch, tds, model, stacked, small, 'mae', 'recurrent ensemble, mae',
        counters=_counters(tds))
    want = {k: REC_ENS_STEPS * v for k, v in per_step.items()}
    if out['vs_cpu']['launches'] != want:
        fail(f'phase 26 (b): {REC_ENS_STEPS} ensemble steps launched '
             f'{out["vs_cpu"]["launches"]}, expected {want} (one '
             f'member-mode launch where one model\'s step launches one)')

    # (c) speed: eager bootstrapped steps at batch 128
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    _, big = _ensemble_batches(torch, tds, _rec_config(), TRAIN_BATCH,
                               ENS_SPEED_STEPS)
    es = parallel.make_ensemble_step(model, loss='mae', bootstrap=True)
    st = {k: v.clone() for k, v in stacked.items()}
    opt = es.init_opt(st)
    gen = torch.Generator(device='cuda').manual_seed(26)
    es.step(st, opt, big[0]['lr'], big[0]['hr'], gen)
    torch.cuda.synchronize()

    def steps():
        for b in big:
            es.step(st, opt, b['lr'], b['hr'], gen)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, got = _counted(tds, steps)
    step_s = (time.perf_counter() - t0) / len(big)
    want = {k: len(big) * v for k, v in per_step.items()}
    if got != want:
        fail(f'phase 26 (c): {len(big)} ensemble steps launched {got}, '
             f'expected {want}')
    losses = es.step(st, opt, big[0]['lr'], big[0]['hr'], gen)[2]
    if not bool(torch.isfinite(losses).all()):
        fail(f'phase 26 (c): ensemble losses {losses.tolist()}')
    step_ms = statistics.median(device_times(
        torch, lambda: es.step(st, opt, big[0]['lr'], big[0]['hr'], gen),
        reps=5))
    # one model's eager step on the same batches, plain autograd and Adam
    net = model.init(0, device='cuda').train()
    adam = torch.optim.Adam(net.parameters(), lr=1e-4, eps=1e-8)

    def single():
        for b in big:
            loss = tds.losses.mae(b['hr'], net(b['lr']).float())
            adam.zero_grad()
            loss.backward()
            adam.step()
        torch.cuda.synchronize()
    single()
    t0 = time.perf_counter()
    single()
    single_s = (time.perf_counter() - t0) / len(big)
    rate = ENS_M * TRAIN_BATCH / step_s
    single_rate = TRAIN_BATCH / single_s
    print(f'phase 26 (c): recurrent ensemble of {ENS_M} members at batch '
          f'{TRAIN_BATCH}, mae, bootstrapped, eager: {rate:.1f} '
          f'member-patches/s (host clock), one step {step_ms:.3f} ms (CUDA '
          f'events); launches {got} in {len(big)} steps; one model\'s eager '
          f'step {single_rate:.1f} patches/s, {ENS_M}x '
          f'{ENS_M * single_rate:.1f}'
          f'; {card_line()}', flush=True)
    out.update(launches=got, member_patches_per_s=rate, step_ms=step_ms,
               single_patches_per_s=single_rate)

    # width 64: K4 and the tail under the member mode
    wide_model, wide = _ensemble_batches(torch, tds, _rec_config(WIDE_F),
                                         TRAIN_BATCH, REC_ENS_WIDE_STEPS)
    wst = parallel.init_ensemble(wide_model, ENS_M, seed=1)
    wes = parallel.make_ensemble_step(wide_model, loss='mae', bootstrap=True)
    wopt = wes.init_opt(wst)
    (wl, _), wgot = _counted(tds, lambda: (
        [wes.step(wst, wopt, b['lr'], b['hr'], gen)[2] for b in wide],
        torch.cuda.synchronize()))
    wide_step = _recurrent_per_step(conv, WIDE_LAYERS)['train']
    wwant = {k: REC_ENS_WIDE_STEPS * v for k, v in wide_step.items() if v}
    if wgot != wwant or not all(bool(torch.isfinite(v).all()) for v in wl):
        fail(f'phase 26 (c): {REC_ENS_WIDE_STEPS} width-{WIDE_F} ensemble '
             f'steps launched {wgot} (expected {wwant}), losses '
             f'{[v.tolist() for v in wl]}')
    print(f'phase 26 (c): width-{WIDE_F} ensemble, {REC_ENS_WIDE_STEPS} '
          f'steps at batch {TRAIN_BATCH}: launches {wgot}, losses '
          f'{[v.tolist() for v in wl]}', flush=True)
    out['wide_launches'] = wgot
    del wst, wopt, wes, wide

    # serving: 16 windows of 4 from REC_GRIDS grids of LR x LR
    rng = np.random.default_rng(26)
    grids = rng.standard_normal((REC_GRIDS, LR, LR, 1)).astype('float32')
    x = np.stack([grids[i:i + REC_T] for i in range(REC_GRIDS - REC_T + 1)])
    torch.backends.cudnn.allow_tf32 = False
    (_, std, members), serve_got = _counted(
        tds, lambda: parallel.predict_ensemble(model, st, x,
                                               return_members=True))
    serve_want = {'K2 inference': REC_T * len(K3_LAYERS)}
    if serve_got != serve_want:
        fail(f'phase 26 (c): predict_ensemble launched {serve_got}, expected '
             f'{serve_want} (one member-mode launch a layer-step)')
    shape = (ENS_M, len(x), REC_T, LR * SCALE, LR * SCALE, 1)
    if members.shape != shape or not (np.isfinite(members).all()
                                      and std.max() > 0):
        fail(f'predict_ensemble: members {members.shape} (expected {shape}),'
             f' std max {std.max()}')
    net = model.init(0, device='cuda').eval()
    with torch.no_grad():
        for i in (0, ENS_M - 1):
            for name, p in net.named_parameters():
                p.copy_(st[name][i])
            with torch.inference_mode():
                alone = net(torch.from_numpy(x).cuda()).float().cpu().numpy()
            _compare(members[i], alone, f'phase 26 (c): predict_ensemble '
                     f'member {i} vs the member served alone (TF32 off)')
    torch.backends.cudnn.allow_tf32 = True
    del members, std
    parallel.predict_ensemble(model, st, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parallel.predict_ensemble(model, st, x)
    serve_s = time.perf_counter() - t0
    print(f'phase 26 (c): predict_ensemble of {len(x)} windows of {REC_T} '
          f'({REC_GRIDS} grids {LR}x{LR} -> {LR * SCALE}x{LR * SCALE}), '
          f'{ENS_M} members: launches {serve_got}; {len(x) / serve_s:.2f} '
          f'windows/s, {REC_GRIDS / serve_s:.2f} grids/s (host clock, TF32 '
          f'convs); {card_line()}', flush=True)
    out.update(serve_launches=serve_got, serve_windows_per_s=len(x) / serve_s,
               serve_grids_per_s=REC_GRIDS / serve_s)
    return out, model, big


def _rec_ensemble_mesh(torch, tds, model, batches):
    """(d): the ensemble under an ('ensemble',) mesh of one NCCL rank and
    without a mesh, bootstrapped steps and predict_ensemble, bit for
    bit."""
    from dl4ds_tpu_torch import parallel
    dev = tds.distributed.initialize(f'127.0.0.1:{_free_port()}', 1, 0,
                                     device='cuda', timeout=300)
    if torch.distributed.get_backend() != 'nccl':
        fail(f'phase 26: the process group runs '
             f'{torch.distributed.get_backend()}, not NCCL')
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    batches = batches[:REC_ENS_MESH_STEPS]
    x = batches[0]['lr'][:N_GRIDS]
    runs = {}
    try:
        mesh = tds.distributed.ensemble_mesh()
        for name, m in (('plain', None), ('mesh', mesh)):
            st = parallel.init_ensemble(model, ENS_M, seed=0, mesh=m)
            es = parallel.make_ensemble_step(model, m, loss='mae',
                                             bootstrap=True)
            opt = es.init_opt(st)
            (losses, served), got = _counted(tds, lambda: (
                [es.step(st, opt, b['lr'], b['hr'], 26 + c)[2]
                 for c, b in enumerate(batches)],
                parallel.predict_ensemble(model, st, x, mesh=m,
                                          return_members=True)))
            runs[name] = dict(losses=torch.stack(losses), stack=st,
                              served=served, launches=got)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
        torch.distributed.destroy_process_group()
    if torch.distributed.is_initialized():
        fail('phase 26: the process group outlived the phase')
    plain, run = runs['plain'], runs['mesh']
    _equal_or_fail('phase 26 (d)', [(plain['losses'], run['losses'])]
                   + [(plain['stack'][k], run['stack'][k])
                      for k in plain['stack']]
                   + list(zip(plain['served'], run['served'])))
    if plain['launches'] != run['launches']:
        fail(f'phase 26 (d): launches {run["launches"]} under the mesh, '
             f'{plain["launches"]} without')
    print(f'phase 26 (d): {ENS_M}-member recurrent ensemble under the '
          f'(\'ensemble\',) mesh of one rank on {dev}, {len(batches)} '
          f'bootstrapped steps at batch {TRAIN_BATCH} and predict_ensemble '
          f'of {len(x)} windows: losses {run["losses"].tolist()}, the stack '
          f'and the members served bit for bit against no mesh; launches '
          f'{run["launches"]}; {card_line()}', flush=True)
    return dict(launches=run['launches'], losses=run['losses'].tolist())


def phase_recurrent_ensembles(torch, tds, report):
    """Phase 26: recurrent deep ensembles (BASELINE config 4, 4 members):
    (a) the member mode of K2, K3 and K4 alone, (b) steps against the CPU,
    (c) speed, width 64 and predict_ensemble, (d) the ('ensemble',) mesh of
    one NCCL rank."""
    parts, out = {}, {}
    t0 = time.perf_counter()
    report['rec_member_rows'] = _rec_member_rows(torch, tds)
    parts['a'] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    ens, model, big = _rec_ensemble(torch, tds, report)
    out.update(ens)
    parts['b_c'] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    out['mesh'] = _rec_ensemble_mesh(torch, tds, model, big)
    parts['d'] = round(time.perf_counter() - t0, 1)
    torch.backends.cudnn.allow_tf32 = True
    out['parts_s'] = parts
    print(f'phase 26 parts (s): {parts}', flush=True)
    report['rec_ens'] = out


def _rec_ens_kernel_rows(report):
    """The `kernels` line's rows of phase 26: the member mode of K2 (both
    variants), K3 and K4, launches from (c)'s eager ensemble steps and its
    predict_ensemble, times from (a) summed over config 4's six layers."""
    rows, ens = report['rec_member_rows'], report['rec_ens']
    f32 = [r for r in rows if r['dtype'] == 'float32']
    width8 = [r for r in f32 if r['f'] == N_FILTERS]
    wide = [r for r in f32 if r['f'] == WIDE_F]

    def tot(width, key):
        return _rec_step_totals(rows, width, key)
    work = (f'the member mode at config 4\'s six ConvLSTM layers, {ENS_M} '
            f'members of {TRAIN_BATCH} samples, T {REC_T}, '
            f'{TRAIN_LR}x{TRAIN_LR}, summed; one_member_ms one member\'s '
            f'launches at {TRAIN_BATCH}; launches of phase 26 (c)\'s '
            f'{ENS_SPEED_STEPS} eager ensemble steps; products in 3xTF32 '
            f'(bound_3xtf32_ms at {TF32X3_FLOPS / 1e12:.0f} TFLOP/s)')
    base = dict(route='cuda', bound_by='operations', library_ms=None)
    k2 = dict(base, source='dl4ds_tpu_torch/csrc/convlstm.cu',
              replaces='dl4ds_tpu/ops/pallas_convlstm.py:219')
    return [
        dict(k2, name='K2_convlstm_member_train',
             launches=ens['launches']['K2-train'],
             max_abs_err=max(max(r['ys_cs_zs_err'][:2]) for r in f32),
             ms=tot(N_FILTERS, 'k2_ms'), plain_ms=tot(N_FILTERS,
                                                     'k2_plain_ms'),
             bound_ms=tot(N_FILTERS, 'k2_bound_ms'),
             bound_3xtf32_ms=tot(N_FILTERS, 'k2_bound_3xtf32_ms'),
             one_member_ms=tot(N_FILTERS, 'k2_one_ms'),
             wide_ms=tot(WIDE_F, 'k2_ms'),
             wide_one_member_ms=tot(WIDE_F, 'k2_one_ms'),
             wide_bound_ms=tot(WIDE_F, 'k2_bound_ms'),
             wide_bound_3xtf32_ms=tot(WIDE_F, 'k2_bound_3xtf32_ms'),
             work=work + f' (wide_*: width {WIDE_F})'),
        dict(k2, name='K2_convlstm_member_serve',
             launches=ens['serve_launches']['K2 inference'],
             max_abs_err=max(max(r['ys_cs_zs_err'][:2]) for r in f32),
             ms=tot(N_FILTERS, 'k2i_ms'),
             plain_ms=tot(N_FILTERS, 'k2i_plain_ms'),
             bound_ms=tot(N_FILTERS, 'k2i_bound_ms'),
             bound_3xtf32_ms=tot(N_FILTERS, 'k2i_bound_3xtf32_ms'),
             one_member_ms=tot(N_FILTERS, 'k2i_one_ms'),
             work=f'the inference variant\'s member mode at the same shapes; '
                  f'launches of predict_ensemble of {REC_GRIDS - REC_T + 1} '
                  f'windows ({REC_GRIDS} grids)'),
        dict(base, name='K3_convlstm_bptt_member',
             source='dl4ds_tpu_torch/csrc/convlstm_bwd.cu',
             sources=['dl4ds_tpu_torch/csrc/convlstm_seq.cu',
                      'dl4ds_tpu_torch/csrc/convlstm_bwd.cu'],
             replaces='dl4ds_tpu/ops/pallas_convlstm.py:335',
             launches=ens['launches']['K3'],
             max_abs_err=max(max(r['grad_rel_err'].values())
                             for r in width8),
             ms=tot(N_FILTERS, 'bwd_ms'),
             plain_ms=tot(N_FILTERS, 'bwd_plain_ms'),
             bound_ms=tot(N_FILTERS, 'bwd_bound_ms'),
             bound_3xtf32_ms=tot(N_FILTERS, 'bwd_bound_3xtf32_ms'),
             one_member_ms=tot(N_FILTERS, 'bwd_one_ms'),
             work=work + '; max_abs_err max|d| / max|ref| against the plain '
                         'version in float64'),
        dict(base, name='K4_convlstm_seq_member',
             source='dl4ds_tpu_torch/csrc/convlstm_seq.cu',
             replaces='dl4ds_tpu/ops/pallas_convlstm.py:269',
             launches=ens['wide_launches']['K4'],
             max_abs_err=max(r['grad_rel_err']['dzs'] for r in wide),
             ms=tot(WIDE_F, 'bwd_ms'), plain_ms=tot(WIDE_F, 'bwd_plain_ms'),
             bound_ms=tot(WIDE_F, 'bwd_bound_ms'),
             bound_3xtf32_ms=tot(WIDE_F, 'bwd_bound_3xtf32_ms'),
             one_member_ms=tot(WIDE_F, 'bwd_one_ms'),
             work=f'the member mode of the chain at width {WIDE_F}\'s six '
                  f'layers, {ENS_M} members of {TRAIN_BATCH}; launches of '
                  f'phase 26 (c)\'s {REC_ENS_WIDE_STEPS} width-{WIDE_F} '
                  f'ensemble steps; max_abs_err dzs max|d| / max(1, '
                  f'max|ref|) against float64'),
    ]


def main():
    import torch
    if not torch.cuda.is_available():
        fail('no CUDA device (torch.cuda.is_available() is False)')
    repo = Path(__file__).resolve().parent
    if not (repo / 'dl4ds_tpu_torch' / '__init__.py').is_file():
        fail(f'no dl4ds_tpu_torch package beside {Path(__file__).name}')
    sys.path.insert(0, str(repo))
    import dl4ds_tpu_torch as tds
    import dl4ds_tpu_torch.export  # noqa: F401
    import dl4ds_tpu_torch.serve  # noqa: F401
    from dl4ds_tpu_torch.ops import _build
    if any(m == 'jax' or m.startswith(('jax.', 'dl4ds_tpu.'))
           or m == 'dl4ds_tpu' for m in sys.modules):
        fail('the port imported JAX or the JAX package')

    card = card_line()
    print(f'card: {card}', flush=True)
    start = t0 = time.perf_counter()
    built = _build.build_all()
    for name, (seconds, log) in built.items():
        print(f'built {name} in {seconds:.1f} s', flush=True)
        print(log, file=sys.stderr, flush=True)
    print(f'kernel build: {time.perf_counter() - t0:.1f} s', flush=True)

    report = {'phase_seconds': {}}
    # (number, function) in the docstring's numbering: phase 6 is K2-train
    # and K3, then K4 and the split route
    phases = ((2, phase_kernels), (3, phase_predict), (4, phase_convlstm),
              (5, phase_recurrent_predict), (6, phase_convlstm_grad),
              (6, phase_convlstm_split), (7, phase_training),
              (8, phase_wide_training), (9, phase_ssim),
              (10, phase_flagship_training), (11, phase_graphs),
              (12, phase_bf16), (13, phase_mos), (14, phase_pin),
              (15, phase_state), (16, phase_cgan), (17, phase_zoo_stream),
              (18, phase_parallel), (19, phase_serving),
              (20, phase_quantization), (21, phase_cli),
              (22, phase_data_parallel), (23, phase_more_data_parallel),
              (24, phase_spatial_parallel),
              (25, phase_tensor_pipeline_parallel),
              (26, phase_recurrent_ensembles))
    for number, phase in phases:
        t0 = time.perf_counter()
        phase(torch, tds, report)
        seconds = time.perf_counter() - t0
        report['phase_seconds'][phase.__name__] = seconds
        print(f'phase {number} ({phase.__name__}): {seconds:.1f} s',
              flush=True)

    f32 = [r for r in report['k1_rows'] if r['dtype'] == 'float32']
    k1 = {'name': 'K1_channel_attention', 'route': 'cuda',
          'source': 'dl4ds_tpu_torch/csrc/channel_attention.cu',
          'replaces': 'dl4ds_tpu/ops/pallas_ops.py:39',
          'launches': report['k1_launches'],
          'max_abs_err': max(r['max_abs_err'] for r in f32),
          'ms': sum(r['ms'] for r in f32),
          'plain_ms': sum(r['plain_ms'] for r in f32),
          'bound_ms': sum(r['bound_ms'] for r in f32),
          'bound_by': 'bytes', 'library_ms': None,
          'bwd_ms': sum(r['bwd_ms'] for r in f32),
          'bwd_bound_ms': sum(r['bwd_bound_ms'] for r in f32),
          'bwd_plain_ms': sum(r['bwd_plain_ms'] for r in f32),
          'bwd_launches': report['k1_bwd_launches'],
          'work': f'the {len(f32)} gates of one float32 forward at batch '
                  f'{BATCH}, summed (regimes '
                  f'{[r["regime"] for r in f32]}); bwd_* the backward '
                  f'kernel at the same shapes (serving runs none)'}
    fwd = report['k2_forward']
    k2 = {'name': 'K2_convlstm', 'route': 'cuda',
          'source': 'dl4ds_tpu_torch/csrc/convlstm.cu',
          'sources': ['dl4ds_tpu_torch/csrc/convlstm.cu',
                      'dl4ds_tpu_torch/csrc/tf32_mma.cuh'],
          'replaces': 'dl4ds_tpu/ops/pallas_convlstm.py:219',
          'launches': report['k2_launches'],
          'max_abs_err': max(r['max_abs_err'] for r in report['k2_rows']),
          'ms': sum(r['ms'] for r in fwd),
          'plain_ms': sum(r['plain_ms'] for r in fwd),
          'bound_ms': sum(r['bound_ms'] for r in fwd),
          'bound_3xtf32_ms': sum(r['bound_3xtf32_ms'] for r in fwd),
          'bound_by': 'operations', 'library_ms': None,
          'work': f'the {len(fwd)} ConvLSTM layers of one float32 '
                  f'recresnet_spc forward at batch {BATCH}, T {REC_T}, '
                  f'summed; products in 3xTF32 on the tensor cores '
                  f'(bound_3xtf32_ms at {TF32X3_FLOPS / 1e12:.0f} TFLOP/s)'}
    step = report['k3_step']
    k3_rows = report['k3_rows']
    step_work = (f'the {len(step)} ConvLSTM layers of one float32 '
                 f'recresnet_spc training step at batch {TRAIN_BATCH}, T '
                 f'{REC_T}, {TRAIN_LR}x{TRAIN_LR}, summed')
    k2_train = {'name': 'K2_convlstm_train', 'route': 'cuda',
                'source': 'dl4ds_tpu_torch/csrc/convlstm.cu',
                'sources': ['dl4ds_tpu_torch/csrc/convlstm.cu',
                            'dl4ds_tpu_torch/csrc/tf32_mma.cuh'],
                'replaces': 'dl4ds_tpu/ops/pallas_convlstm.py:219',
                'launches': report['k2_train_launches'],
                'wrapper_calls': report['k2_train_calls'],
                'max_abs_err': max(max(r['ys_cs_zs_err'][:2])
                                   for r in k3_rows + report['k4_rows']
                                   if 'ys_cs_zs_err' in r),
                'ms': sum(r['k2_ms'] for r in step),
                'plain_ms': sum(r['k2_plain_ms'] for r in step),
                'bound_ms': sum(r['k2_bound_ms'] for r in step),
                'bound_3xtf32_ms': sum(r['k2_bound_3xtf32_ms']
                                       for r in step),
                'bound_by': 'operations', 'library_ms': None,
                'work': step_work + ' (save_residuals=True: ys, cs, zs); '
                        'max_abs_err is that of ys and cs; at width '
                        f'{WIDE_F} the six layers took '
                        f'{sum(r["k2_ms"] for r in report["k4_step"]):.4f} '
                        f'ms (plain '
                        f'{sum(r["k2_plain_ms"] for r in report["k4_step"]):.4f}'
                        f', bound '
                        f'{sum(r["k2_bound_ms"] for r in report["k4_step"]):.4f}'
                        f', 3xTF32 '
                        f'{sum(r["k2_bound_3xtf32_ms"] for r in report["k4_step"]):.4f}'
                        f' ms)'}
    k3 = {'name': 'K3_convlstm_bptt', 'route': 'cuda',
          'source': 'dl4ds_tpu_torch/csrc/convlstm_bwd.cu',
          'sources': ['dl4ds_tpu_torch/csrc/convlstm_seq.cu',
                      'dl4ds_tpu_torch/csrc/convlstm_bwd.cu',
                      'dl4ds_tpu_torch/csrc/tf32_mma.cuh'],
          'replaces': 'dl4ds_tpu/ops/pallas_convlstm.py:335',
          'launches': report['k3_launches'],
          'wrapper_calls': report['k3_calls'],
          'max_abs_err': max(max(v for k, v in r['grad_rel_err'].items()
                                 if k != 'plain_f32') for r in k3_rows),
          'ms': sum(r['k3_ms'] for r in step),
          'plain_ms': sum(r['k3_plain_ms'] for r in step),
          'bound_ms': sum(r['k3_bound_ms'] for r in step),
          'bound_3xtf32_ms': sum(r['k3_bound_3xtf32_ms'] for r in step),
          'bound_by': 'operations', 'library_ms': None,
          'split_ms': {k: sum(r['k3_split_ms'][k] for r in step)
                       for k in list(K3_KERNELS) + ['other']},
          'work': step_work + '; the chain steps and dx run the tile of '
                  'convlstm_seq.cu, the weight gradients and their '
                  'reduction convlstm_bwd.cu; split_ms is the time by launch '
                  'kind (torch.profiler); products in 3xTF32 '
                  f'(bound_3xtf32_ms at {TF32X3_FLOPS / 1e12:.0f} TFLOP/s); '
                  'max_abs_err is max|d| / max|ref| of dx, dWx, dbx and dWh '
                  'against the plain version in float64'}
    wide = report['k4_step']
    k4 = {'name': 'K4_convlstm_seq', 'route': 'cuda',
          'source': 'dl4ds_tpu_torch/csrc/convlstm_seq.cu',
          'sources': ['dl4ds_tpu_torch/csrc/convlstm_seq.cu',
                      'dl4ds_tpu_torch/csrc/tf32_mma.cuh'],
          'replaces': 'dl4ds_tpu/ops/pallas_convlstm.py:269',
          'launches': report['k4_launches'],
          'wrapper_calls': report['k4_calls'],
          'max_abs_err': max(r['dzs_rel_err'] for r in report['k4_rows']),
          'ms': sum(r['k4_ms'] for r in wide),
          'plain_ms': sum(r['k4_plain_ms'] for r in wide),
          'bound_ms': sum(r['k4_bound_ms'] for r in wide),
          'bound_3xtf32_ms': sum(r['k4_bound_3xtf32_ms'] for r in wide),
          'bound_by': 'operations', 'library_ms': None,
          'work': f'the sequential BPTT chain of the {len(wide)} ConvLSTM '
                  f'layers of one float32 recresnet_spc training step at '
                  f'width {WIDE_F}, batch {TRAIN_BATCH}, T {REC_T}, '
                  f'{TRAIN_LR}x{TRAIN_LR}, summed; products in 3xTF32; '
                  f'max_abs_err is max|d| / '
                  f'max(1, max|ref|) of dzs against the plain chain in '
                  f'float64; the split route\'s float32 GEMM tail (cuBLAS, '
                  f'not a kernel of the port) took '
                  f'{sum(r["tail_ms"] for r in wide):.4f} ms against a '
                  f'{sum(r["tail_bound_ms"] for r in wide):.4f} ms bound'}
    gates = report['k1_train_rows']
    k1_train = {'name': 'K1_channel_attention_train', 'route': 'cuda',
                'source': 'dl4ds_tpu_torch/csrc/channel_attention.cu',
                'replaces': 'dl4ds_tpu/ops/pallas_ops.py:39',
                'launches': report['flag_k1_launches'],
                'wrapper_calls': report['flag_k1_calls'],
                'max_abs_err': max(r['max_abs_err'] for r in gates),
                'ms': sum(r['ms'] for r in gates),
                'plain_ms': sum(r['plain_ms'] for r in gates),
                'bound_ms': sum(r['bound_ms'] for r in gates),
                'bound_by': 'bytes', 'library_ms': None,
                'bwd_ms': sum(r['bwd_ms'] for r in gates),
                'bwd_bound_ms': sum(r['bwd_bound_ms'] for r in gates),
                'bwd_plain_ms': sum(r['bwd_plain_ms'] for r in gates),
                'bwd_launches': report['flag_k1_bwd_launches'],
                'bwd_wrapper_calls': report['flag_k1_bwd_calls'],
                'work': f'the {len(gates)} gates of one float32 flagship '
                        f'training step at batch {TRAIN_BATCH}, summed, '
                        f'forward and backward (bwd_*, held against the '
                        f'float64 plain version)'}
    k6_rows = report['k6_rows']
    k6_step = k6_rows[0]
    k6 = {'name': 'K6_ssim', 'route': 'cuda',
          'source': 'dl4ds_tpu_torch/csrc/ssim.cu',
          'replaces': 'dl4ds_tpu/ops/pallas_ops.py:145',
          'launches': report['k6_launches'],
          'wrapper_calls': report['k6_calls'],
          'max_abs_err': max(r['max_abs_err'] for r in k6_rows),
          'ms': k6_step['ms'], 'plain_ms': k6_step['plain_ms'],
          'bound_ms': k6_step['bound_ms'], 'bound_by': k6_step['bound_by'],
          'library_ms': None,
          'bwd_ms': k6_step['bwd_ms'], 'bwd_bound_ms': k6_step['bwd_bound_ms'],
          'bwd_plain_ms': k6_step['bwd_plain_ms'],
          'bwd_launches': report['k6_bwd_launches'],
          'bwd_wrapper_calls': report['k6_bwd_calls'],
          'work': f'the per-image SSIM of the {FLAG_LOSS} loss of one '
                  f'flagship training step, x{k6_step["shape"]}, 11 taps; '
                  f'max_abs_err is per image against the plain version in '
                  f'float64 over {len(k6_rows)} shapes; bwd_* the backward '
                  f'kernel for y_pred and the range (bwd_plain_ms '
                  f'ssim_backward_reference; autograd through the plain ssim '
                  f'took {k6_step["autograd_bwd_ms"]:.4f} ms)'}
    kernels = ([k1, k2, k2_train, k3, k4, k1_train, k6]
               + _bf16_kernel_rows(report) + _mos_kernel_rows(report)
               + _pin_kernel_rows(report) + _state_kernel_rows(report)
               + _cgan_kernel_rows(report) + _zoo_stream_kernel_rows(report)
               + _parallel_kernel_rows(report)
               + _serving_kernel_rows(report) + _quant_kernel_rows(report)
               + _cli_kernel_rows(report) + _dp_kernel_rows(report)
               + _dpx_kernel_rows(report) + _sp_kernel_rows(report)
               + _tp_kernel_rows(report) + _rec_ens_kernel_rows(report))
    print(json.dumps({'k1_shapes': report['k1_rows']}), flush=True)
    print(json.dumps({'k2_shapes': report['k2_rows']}), flush=True)
    print(json.dumps({'k3_shapes': k3_rows}), flush=True)
    print(json.dumps({'k4_shapes': report['k4_rows']}), flush=True)
    print(json.dumps({'k6_shapes': k6_rows}), flush=True)
    print(json.dumps({'k1_train_shapes': gates}), flush=True)
    print(json.dumps({'graphs': report['graph_rows']}), flush=True)
    print(json.dumps({'bf16_shapes': {k: v for k, v in report.items()
                                      if k.startswith('bf16_k')}}),
          flush=True)
    print(json.dumps({k: v for k, v in report.items()
                      if not k.startswith(('k1_', 'k2_', 'k3_', 'k4_',
                                           'k6_rows', 'graph_rows',
                                           'bf16_k', 'tiled_k', 'member_',
                                           'artifact_k', 'k7_', 'cli',
                                           'dp', 'sp', 'tp', 'rec_'))}),
          flush=True)
    print(json.dumps({'phase18_shapes': {k: report[k] for k in (
        'tiled_k1_rows', 'tiled_k2_rows', 'member_rows')}}), flush=True)
    print(json.dumps({'phase19_shapes': {k: report[k] for k in (
        'artifact_k1_rows', 'artifact_k1_bf16_rows', 'artifact_k2_rows')}}),
        flush=True)
    print(json.dumps({'phase20_shapes': {k: report[k] for k in (
        'k7_rows', 'k7_bf16_rows', 'k7_extra_rows')}}), flush=True)
    print(json.dumps({'phase21': report['cli']}), flush=True)
    print(json.dumps({'phase22': report['dp']}), flush=True)
    print(json.dumps({'phase23': report['dpx'],
                      'phase23_k7_shapes': report['dpx_k7_rows']}),
          flush=True)
    print(json.dumps({'phase24': report['sp'],
                      'phase24_shapes': {k: report[k] for k in (
                          'sp_train_rows', 'sp_serve_rows')}}), flush=True)
    print(json.dumps({'phase25': report['tp']}), flush=True)
    print(json.dumps({'phase26': report['rec_ens'],
                      'phase26_shapes': report['rec_member_rows']}),
          flush=True)
    print(f'chip_smoke.py: {time.perf_counter() - start:.1f} s from the '
          f'kernel build to the end of phase 26; phase seconds '
          f'{ {k: round(v, 1) for k, v in report["phase_seconds"].items()} }',
          flush=True)
    print(card, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
