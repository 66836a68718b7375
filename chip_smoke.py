#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ganslate_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: the card's name and power limit (`nvidia-smi`), torch and CUDA
   versions. Exits 1 when PyTorch sees no CUDA device.
2. build: compiles the instance-norm kernels from `ganslate_tpu_torch/csrc/`.
3. kernels: every kernel against its plain PyTorch version on the card, at
   the slab shapes of CycleGAN-256 at batch 16 and 1, in float32 and bfloat16, for
   each activation; with the kernel's time and achieved TB/s, the plain
   version's time, the time of `torch.nn.functional.instance_norm` on the
   same input (a yardstick the port never calls) and the bound (bytes over
   the card's memory rate). One-pass records carry the cluster geometry
   (G, K, blocks, shared memory per block), split records the tile
   geometry (tile rows, row segment, threads, blocks, order). Then the
   one-pass kernel at every feasible geometry at its two main slabs, each
   checked and timed: the record from which `onepass_geometry`'s rule was
   chosen. Then the split kernels at every tile size, thread count and
   order at the four split slabs, likewise (`split_geometry`'s record);
   the split form's stats and normalise kernels timed apart; two calls of
   the split form on one input, which must agree bit for bit; and the
   one-pass kernel at the (16,128,128,128) split slab (G = 16, K = 8).
4. slice: the horse2zebra CycleGAN `G_AB` (Resnet2D, 9 residual blocks,
   ngf 64, bf16 mixed precision, bf16 wire) at 256x256 with seeded random
   weights, served through the deployment `Inferer`: 4 requests at batch 1
   and 4 at batch 16. Each output is checked (shape, finite, in [-1, 1],
   agreement with the same G run with the plain norm on the card) and so
   are the launch counters (23 norm launches per forward, both kernels
   used). A float32 run (TF32 off) checks the slice at a tight tolerance.
5. profile: one batch-16 forward under `torch.profiler`, device time by
   kernel family.
6. train: the horse2zebra CycleGAN train step at full width (G_AB and G_BA:
   Resnet2D, 9 blocks, ngf 64; D_B and D_A: PatchGAN2D, ndf 64, 3 layers;
   lsgan, lambda 10, Adam 2e-4) through the model's entry points (`setup`,
   `set_input`, `optimize_parameters`, `get_loggable_data`,
   `save_checkpoint`). One step with the kernel norms against one with the
   plain norms from the same state and batch, in fp32 (TF32 off) and in bf16
   mixed precision, at batch 2: losses and every gradient (in bf16, each
   run's distance from the fp32 gradient). Then timed steps
   in bf16 with pool 50 and metrics on, at batch 1 and 16: step time (CUDA
   events), images/s, peak memory, finite losses and the norm launches of
   every step. The trained batch-16 `G_AB` served from its checkpoint by a
   deployment `Inferer`. One step at each batch under `torch.profiler`:
   device time by family (conv forward, data and weight gradients, norm
   kernels, the plain norm backward, pad gathers and their backward, bias
   adds, casts, Adam, losses, metrics) and the device's idle share. Before
   all of it, each norm's gradient alone at the step's slabs, elementwise.
6b. trainer: the horse2zebra experiment (`projects/horse2zebra/experiments/
   default.yaml` field for field, built in Python, with its loop lengths and
   frequencies cut and `logging.wandb` left out) through the port's engines:
   `init_engine("train", ...)` from a YAML that the port's `Conf.to_yaml`
   wrote (the engine class itself where PyYAML is missing), over seeded
   256x256 PNG folders read by the port's data plane (or, without Pillow,
   this script's synthetic datasets over the same arrays). At batch 1 (the
   YAML's) and 16: images/s over the timed iterations, the tracker's t_data
   and t_comp, plain iterations against log, checkpoint and validation ones,
   host time by range, peak memory, finite losses at every log, the
   checkpoints and their data-state sidecars, the norm launches of every
   step and validation, and the idle share of the Trainer's own
   `logging.profiler` trace of its last 5 iterations. Then `Inferer.run()`
   and the `Tester` from the batch-1 run's last checkpoint, and
   `Inferer.run()` again with the plain norms: outputs finite, in [-1, 1],
   of the input's shape and within the slice's bf16 limits.
7. sliding_window: the BRaTS CycleGAN's `G_AB` (Vnet3D, down blocks
   (2, 2, 3), up blocks (3, 3, 3), 16 first-layer channels, 8,070,257
   parameters, bf16 mixed precision, bf16 wire) with seeded random weights,
   served through the deployment `Inferer`'s sliding window (windows of
   (32, 176, 176), 28 a batch, overlap 0.25, gaussian blend): requests of 2
   volumes of (155, 240, 240, 1). Each output is checked (shape, finite, in
   [-1, 1]), two against the same network with plain norms on the card, and
   the norm launches of every request (14 one-pass, 66 split). A float32
   run (TF32 off) on a smaller volume checks it tightly. Then vols/s, the
   device time of one 28-window forward (also with cuDNN's autotuner on, a
   yardstick the port does not use), peak memory, the level-0 coupling conv
   alone in two layouts with and without the autotuner, and one request
   under `torch.profiler`: device time by family and the idle share.

Before phase 8, the BRaTS NIfTI root of phases 8, 10 and 11: 4 synthetic
BRaTS-shaped scans (4 sequences of (155, 240, 240), float32) from the seed,
written by the port's `medio.write` as 4-D `.nii.gz` files (3 for
training, 1 for validation) into a temporary directory, each write timed,
one read back bit for bit. Those phases read them through the BRaTS
project's datasets, which the port's config loader takes from its twin
(`ganslate_tpu_torch/projects/brats_mri_sequence_translation/`).

7b. native: the host data ops (`ganslate_tpu_torch/native/dataops.cpp`,
   host C++ built by g++ with `ops/build.py:HOST_FLAGS`): the build's
   seconds, library, compiler version, the host's CPU model and cores and
   the card's `nvidia-smi` line; each of the five ops against its plain
   numpy version on the validation scan's flair sequence (155, 240, 240)
   (clip and masked fill also on an HX4 padded (64, 512, 512) CT and its
   body mask), masked fill and patch copy equal, clip
   and z-score within 2^-22, `mean_std` within 1e-6 relative, each timed
   against its plain version; then one BRaTS validation `__getitem__` on
   the NIfTI root as shipped and with the plain ops swapped in by the
   script: the sample's seconds, the z-scores' ms, the calls that reached
   the library (at least one as shipped, none with the plain ops) and
   both samples within 2^-22 of each other.

8. revgan: the BRaTS RevGAN experiment (`projects/brats_mri_sequence_
   translation/experiments/revgan.yaml` field for field, built in Python:
   Piresnet3D of depth 5 with 32 first-layer channels and memory saving,
   PatchGAN3D with 2 layers, (32, 176, 176) patches, batch 1, bf16), with
   its loop lengths and frequencies cut and its datasets' roots on the
   NIfTI root: flair -> t1w patch pairs through the project's
   `BratsDataset`, and the validation scan through the sliding window with
   cycle metrics (the inverted generator). (a) The
   memory-saving config from `init_engine("train", ...)`: plain iterations,
   log, checkpoint and validation ones, finite losses and validation
   metrics, the norm launches of every step and validation; then
   model-level steps (CUDA events, peak memory), the recompute checked bit
   for bit and its rebuilt inputs' error, conv FLOPs, and 3 steps under
   `torch.profiler` by family (convs, norm kernels, the plain norm backward,
   pads, the couplings' recompute and layout copies). (b) The same config
   with stored activations: steps and peak memory, which must exceed (a)'s.
   (c) `init_engine("infer")` from (a)'s checkpoint: `run()` over the
   volume, and `infer` AB and BA through the sliding window against the
   plain norms. Then one step of memory saving against stored activations
   from the same state and batch (fp32 within 1e-4 per network; bf16 each
   against the fp32 gradient) and one against the plain norms (fp32, 1e-2).
9. pix2pix: the Cityscapes label->photo Pix2Pix experiment (`projects/
   cityscapes_label2photo/experiments/pix2pix.yaml` field for field, built
   in Python: Unet2D of 7 levels, ngf 128 and dropout, 167,275,267
   parameters; the conditional PatchGAN2D of 4 layers on 6 channels;
   256x512, batch 1, bf16), through `init_engine("train", ...)` over
   seeded synthetic paired 256x512 PNG folders, with its loop lengths and
   frequencies cut, `logging.wandb` left out, a seed set and the
   validation size cut from [286, 572], which a 7-level U-Net cannot take,
   to [256, 512] (`PIX2PIX_LEFT_OUT`): images/s, plain iterations against
   log, checkpoint and validation ones, t_data, peak memory, finite losses
   at every log, the norm launches of every step (14 one-pass, 5 split)
   and validation, paired validation metrics. Then on its model:
   model-level steps (CUDA events), dropout bit for bit from one generator
   state and not from another, conv FLOPs, and 3 steps under
   `torch.profiler` by family (convs, norm kernels, the plain norm
   backward, concat, dropout, casts, Adam, layout copies) with the idle
   share. From its checkpoint: the `Tester`, `Inferer.run()` over the
   validation folder and a deployment `infer` against the plain norms.
   The Trainer again with the loader's threads off (where a plain
   iteration's host time goes). One step against the plain norms from the
   same state, batch and dropout masks, in fp32 (losses 1e-4, gradients
   1e-2) and bf16 (each against the fp32 gradient). Last, the HX4 PET
   Pix2Pix's networks (`projects/maastro_hx4_pet_translation/experiments/
   pix2pix.yaml`: Unet3D of 4 levels, ngf 64, 2 -> 1 channels; PatchGAN3D
   of 3 layers, k4) model-level on synthetic (32, 128, 128) patches at
   batch 1 in bf16: steps, peak memory, finite losses, norm launches, one
   forward against the plain norms.
10. cut: the BRaTS CUT experiment (`projects/brats_mri_sequence_translation/
   experiments/cut.yaml` field for field, built in Python: Vnet3D, down
   blocks (2, 2, 3), up blocks (3, 3, 3), 8,070,257 parameters; PatchGAN3D
   with 2 layers; PatchNCE on the encoder taps [0, 1, 2, 3], 256 patches, an
   MLP of 256; (32, 176, 176) patches, batch 1, bf16), with its loop lengths
   and frequencies cut, a seed set and its datasets' roots on the NIfTI
   root (`CUT_LEFT_OUT`). (a) The port's command line in a subprocess:
   `python -m ganslate_tpu_torch train config=<yaml>` for 4 iterations with
   a checkpoint and one validation through the sliding window, then
   `infer config=<yaml>` from the checkpoint; exit codes, the losses D, G,
   NCE and NCE_idt finite at every log, finite validation metrics, and G,
   D and mlp in the checkpoint. (b) The same experiment through
   `init_engine("train")` in this process, measured: patches/s, plain
   iterations against log, checkpoint and validation ones, t_data, peak
   memory, the norm launches of every step and validation; then on its
   model: model-level steps, conv FLOPs, and 3 steps under
   `torch.profiler` by family (convs, norm kernels, the plain norm
   backward, the NCE work, Adam, casts, layout copies) with the idle
   share. (c) One step against the plain norms from the same state, batch
   and patch ids, in fp32 (losses 1e-4, gradients 1e-2) and bf16 (each
   against the fp32 gradient). (d) From (b)'s checkpoint,
   `init_engine("infer")`: `run()` over the volume and `infer` A->B
   through the sliding window against the plain norms; B->A raises. (e)
   The 2D CUT and FastCUT at the CUT paper's width, model-level (Resnet2D
   of 9 blocks, ngf 64, PatchGAN2D of 3 layers, taps (0, 4, 8, 12, 16),
   256x256, batch 1, bf16): steps, peak memory, finite losses, the flips
   drawn, the norm launches of every step, and one tap call at index 8,
   whose norms run the kernels without their ReLU.
11. brats_cyclegan: the BRaTS CycleGAN experiment loaded from its YAML
   (`projects/brats_mri_sequence_translation/experiments/cyclegan.yaml`:
   two Vnet3Ds of 8,070,257 parameters, two PatchGAN3Ds with 2 layers,
   (32, 176, 176) patches, batch 1, bf16, lambda 5) by
   `init_engine("train", ["config=<yaml>", ...])` with only these
   overrides: the datasets' roots (the NIfTI root), the loop lengths, the
   logging, checkpoint and validation frequencies, a seed and
   `logging.wandb` off; from a working directory whose `projects` links to
   the checkout's, so that the YAML's relative paths resolve. Patches/s
   over the timed iterations, plain iterations against log, checkpoint and
   validation ones, t_data and the loader's wait against one sample's time
   on one thread, peak memory, finite losses at every log, one validation
   with cycle metrics, the norm launches of every step and validation;
   model-level steps, conv FLOPs and 3 steps under `torch.profiler` by
   family (convs, norm kernels, the plain norm backward, PReLU, the rest)
   with the idle share. The checkpoint's `G_AB` served by the deployment
   `Inferer` through the sliding window against the plain norms. One step
   against the plain norms from the same state and batch (fp32 losses 1e-4,
   gradients 1e-2; bf16 each against the fp32 gradient). A step of
   `cyclegan_s2d.yaml` equal bit for bit to the plain YAML's from the same
   seed and batch, and a shorter Trainer run from that YAML.

12. hx4: the HX4 PET project's experiments loaded from their YAMLs
   (`projects/maastro_hx4_pet_translation/experiments/`) by `init_engine(
   "train", ["config=<yaml>", ...])` with only the overrides of
   `project_args` (the datasets' roots, the loop lengths and frequencies, a
   seed, `logging.wandb` off), on 3 + 1 synthetic patients that the phase
   writes with the port's `medio` (NRRD volumes of (48, 256, 256) and
   `SUVmean_aorta_HX4.csv`; `utils/synthetic_data.write_hx4_root`), read
   through the project twin. (a) `cyclegan_balanced.yaml`, the custom
   `HX4CycleGANBalanced` (two Unet3Ds of 24,659,329 parameters, 2 -> 1
   channels; two PatchGAN3Ds on the 1-channel PET; (32, 128, 128), batch
   1, bf16): patches/s, plain iterations against log, checkpoint and
   validation ones, t_data and the loader wait against one sample's time
   on one thread, peak memory, finite losses at every log, the norm
   launches of every step and validation; one validation through the
   sliding window (18 windows) with its six metrics and its NRRD `save`;
   then on its model: model-level steps, the zero CT channel of the
   fakes and reconstructions exactly 0, 3 steps under `torch.profiler` by
   family with the idle share; the checkpoint's `G_AB` served by the
   `Tester` through the sliding window against the plain norms; one step
   against the plain norms (fp32 losses 1e-4, gradients 1e-2; bf16 each
   against the fp32 gradient, with two more plain controls). (b)
   `pix2pix.yaml` (the Pix2Pix; its conditional PatchGAN3D on 3
   channels): a Trainer run whose validation supplies the BODY and GTV
   masks, whose masked metrics it checks.
13. cleargrasp: the ClearGrasp project's experiments likewise
   (`projects/cleargrasp_depth_estimation/experiments/`), on 4 + 1
   synthetic samples of 960x540 (RGB JPEGs, EXR normal and depth maps;
   `write_cleargrasp_root`), with OpenCV's EXR codec switched on
   (`OPENCV_IO_ENABLE_OPENEXR`, set by `main`) and checked. (a)
   `cyclegan_balanced.yaml`, the custom `CycleGANMultiModalV3` (Resnet2Ds
   of 11,381,313 and 11,381,315 parameters, 6 -> 1 and 4 -> 3; PatchGAN2Ds
   on the 1-channel depth and the 3-channel normal map; 256x512, batch 1,
   bf16), measured and checked as (a) of phase 12, its validation writing
   an EXR depth map, its zero RGB channels checked, its `G_AB` served by
   the `Tester` directly. (b) `pix2pix_new.yaml` (Unet2D of 7 levels, ngf
   64, 41,824,641 parameters; the conditional PatchGAN2D on 7 channels).
14. fid: a model trained elsewhere, imported and tested with FID. A seeded
   port InceptionV3 (23,834,568 parameters, random batch-norm statistics)
   saved as a torchvision `.pth` and converted by `python -m
   ganslate_tpu_torch convert-fid-weights` in a subprocess (the `.npz`
   read back bit for bit); an original-ganslate `.pth` of the horse2zebra
   CycleGAN's four networks (seeded, the Resnet2D alias included) through
   `import-torch-checkpoint`, every tensor checked bit for bit; then
   `test config=<yaml> test.metrics.fid=true test.metrics.fid_weights=
   <npz>` through the command line in this process over 4 seeded 256x256
   pairs: its FID finite and >= 0, `G_AB`'s norm launches (both kernels),
   its `fake_B` within the slice's bf16 limits of the plain norms', its
   seconds against the same test without FID. One BRaTS-shaped volume
   (155, 240, 240) through the Tester's slicewise FID (chunks of 32).
   Inception on the card (fp32, TF32 off) within 1e-4 of max|feature| of
   its CPU forward; |FID(real, real)| < 1e-6 FID(real, real + 0.5) over
   2,112 images a side (a full-rank covariance); the TF32 differences;
   the forward's device time at batch 32, the resize's share, features/s,
   peak memory and the Frechet solve's host seconds.

15. zoo (run after phase 11, while the NIfTI root exists): the rest of the
   network zoo from the BRaTS YAMLs, copied into the run's working
   directory with only their network sections replaced (`ZOO_NETS`) and
   loaded by `init_engine("train", ["config=<copy>", ...])` with phase 11's
   overrides. `SelfAttentionBlock` first, on the card in fp32 (TF32 off)
   with gamma 0.5 at the path's four attention shapes, within 1e-4 of
   max|out| of its CPU forward. (a) `revgan.yaml` with
   `SelfAttentionVnet3D` (its config's defaults: 16 first-layer channels,
   down (1, 2, 3, 2), up (2, 2, 1, 1), attention at levels 2 and 3, memory
   saving and the inverse; 24,335,492 parameters) against
   `SelfAttentionPatchGAN3D` (2 layers; 2,745,251), (32, 176, 176), batch
   1, bf16, trained with `train.steps_per_dispatch=2` after the same run at
   k = 1 (chunked against unchunked plain-iteration ms); validation through
   the sliding window with cycle metrics through the inverted G; model-level
   steps, conv FLOPs and a profile by family (the attention's q/k/v GEMM,
   its two products and its softmax are families); both directions served
   from the checkpoint by a deployment `Inferer` against the plain norms;
   2 fp32 steps in a chunk of 2 against single steps from one seed under
   deterministic algorithms, every parameter bit for bit; one step against
   the plain norms (fp32 and bf16, phase 11's limits; gammas 0.5, since at
   their zero init the attention's convs get no gradient). (b)
   `cyclegan.yaml` with `is_separable: true` (2,046,355 parameters a
   generator) against `MultiScalePatchGAN3D` (scales 2, 2 layers;
   5,284,738), each discriminator call on a fresh random (16, 88, 88) crop
   at scale 2: the Trainer at k = 1, steps, FLOPs (the separable convs'
   TFLOP/s against the bf16 peak), profile, and the step against the plain
   norms. The norm launches of every step, pass and request are counted.

16. distributed (last): data parallelism across processes on the one card,
   each rank a child process of this script (`--distributed-child`) with
   `DIST_CHILD_TIMEOUT` seconds before its process group is killed; a
   failed child fails the run. (a) `projects/horse2zebra/experiments/
   default.yaml` at full width, in fp32, with only the roots, the loop
   lengths (4 iterations) and frequencies, a seed, `logging.wandb` and
   `val.metrics.fid` (no Inception weights) overridden, through the
   port's `train` command (`interface.main`) under `python -m
   torch.distributed.run --standalone --nproc_per_node 1`, one NCCL rank,
   with deterministic algorithms: its losses and last checkpoint bit for
   bit against the same child without torchrun (no process group), run
   at the same time on the card, and the NCCL kernels of one profiled
   iteration counted. (b) The same
   CycleGAN model-level, fp32, global batch 2 on 2 gloo ranks (NCCL
   refuses two ranks on one device) with its pool of 50, 3 steps, against
   1 process at batch 2: losses per step (1e-5 relative), gradients of
   step 1 (1e-2 relative L2, beside the one-ulp control) and each weight
   tensor after step 3 (1e-2, or 3 times that tensor's own gap in the
   one-ulp control where that is larger); step and all-reduce times, which
   are two ranks sharing a card, beside the 1-rank reference, and no
   scaling figure. (c) The Cityscapes
   Pix2Pix YAML (Unet2D, 7 levels, ngf 128) with batch norm and dropout, 2
   steps, likewise. (d) The BRaTS Vnet3D request of phase 7 through the
   deployment `Inferer`'s generator and its sliding window with the
   library's grid split over 2 gloo ranks turned on (no entry point turns
   it on), bf16 and fp32, against 1 process. The torchrun children's norm
   launches are the `distributed` path of the kernels line.
17. spatial (run after phase 15, while the NIfTI root exists): spatial
   sharding across processes on the one card. (a) The split stats kernel's
   (mean, M2) mode against its plain version at a full-width level-0 slab
   of one shard, (1, 16, 176, 176, 16), bf16 and fp32; then on 2 gloo
   ranks the sharded instance norm (each rank's slab's (mean, M2), the
   ranks' slots summed, folded, normalised by the split kernel) against the
   1-rank kernel on the whole (1, 32, 176, 176, 16) tensor. (b)
   `cyclegan.yaml` under `torchrun --nproc_per_node 2` through the port's
   `train` command with `train.spatial_mesh=2` (each rank a (16, 176, 176)
   slab of the (32, 176, 176) patch), 4 iterations on the synthetic NIfTI
   scans, against the same command in one process: the step-1 losses and
   every gradient in fp32 (model-level, from the same seed) within 3 times
   their own one-ulp control gap or the fixed bounds of phase 16 (b), each
   rank's peak memory (at most 65% of the 1-process run's), step time, the
   halo-exchange and collective time of one step, the gathers of each
   network (none on a generator) and the norm launches (all split, with
   cross-rank statistics). (c) A (64, 176, 176) volume through the
   deployment `Inferer` with `infer.spatial_sharding` method `gspmd` (bf16
   and fp32, held to phase 16 (d)'s bounds) and `halo` (bf16, its gaps
   near the shard boundary and away from it reported) on 2 ranks, against
   the direct forward in one process. (d) Every other family model-level
   at the widths and patch of its own phase (`SPATIAL_ZOO`: the BRaTS
   RevGAN with memory saving, the Cityscapes Pix2Pix, the BRaTS CUT, the
   zoo's SA V-Net RevGAN and separable V-Net CycleGAN, the HX4 and
   ClearGrasp balanced CycleGANs) on one synthetic batch: a bf16 warm-up
   and a timed step (step ms, peak memory a rank, exchanges by network and
   by declared replicated section, norm launches), then an fp32 step 1
   held against one process (losses 1e-4; each gradient tensor 1e-2
   relative L2, or 3 times its one-ulp control's gap; a cancelling one
   within 1e-4 of its network's gradient norm) whose halo and collective
   seconds are timed; RevGAN's peak at most `SPATIAL_MEMORY_MAX` of one
   process's; the SA V-Net's attention energies a rank. The 2-rank
   children's norm launches are the `spatial` path of the kernels line.

The kernels phase also checks and times both kernels at the V-Net's, the
RevGAN's, the Pix2Pix's, the CUT's and the HX4 and ClearGrasp networks'
norm slabs (in both dtypes for the Pix2Pix's; the BRaTS CycleGAN's are the
CUT's Vnet3D slabs and the RevGAN's PatchGAN3D ones), and
checks a channel count that is not a multiple of the kernels' channel
block (C = 20), which the wrappers pad.

The last lines are the card's `nvidia-smi` line, one JSON object listing
every kernel, and `{"ok": true, "device": {...}}`.
"""

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 0
BATCHES = (1, 1, 1, 1, 16, 16, 16, 16)
SIZE = 256
# Slab shapes (N, H, W, C) of the G's norms at the served batches 16 and 1:
# stem and up1, down0 and up0, down1 and the 18 residual norms.
SLABS = tuple((n, s, s, c) for n in (16, 1)
              for s, c in ((256, 64), (128, 128), (64, 256)))
MAIN_SLAB = {"onepass": (16, 64, 64, 256), "split": (16, 256, 256, 64)}
NORMS_PER_FORWARD = 23
# Checked, not timed: S = 1073 (one-pass below 48 KB of shared memory),
# a 3D volume, S = 6400 (the largest one-pass slab), S = 4097 (one-pass with
# S % K != 0: ranks of unequal rows), S = 6401 and 70000 (split, with a
# ragged last tile), a 3D split volume, a 96-byte bf16 row (6 vectors, which
# do not divide a warp: 96 threads), and a 1 KB float32 row (cut into two
# 512-byte segments).
EDGE_SHAPES = ((2, 37, 29, 32), (2, 4, 6, 6, 16), (1, 6400, 1, 16), (1, 4097, 1, 64),
               (1, 6401, 1, 16), (2, 70000, 1, 32), (1, 32, 32, 32, 16), (2, 9000, 1, 48),
               (1, 7000, 1, 256))

# The one-pass geometries timed at the main slabs: row segments of G
# channels (bytes) and cluster sizes K (16 needs the non-portable attribute).
SWEEP_SEGMENT_BYTES = (128, 64, 32)
SWEEP_CLUSTER_SIZES = (1, 2, 4, 8, 16)
# The split geometries timed at the split slabs: tile bytes, threads per
# block, and the normalise pass's order (reverse or not).
SWEEP_SPLIT_TILE_BYTES = (8 * 1024, 16 * 1024, 32 * 1024, 64 * 1024)
SWEEP_SPLIT_THREADS = (64, 128, 256)
# The one-pass kernel at a split slab, for the one-pass/split boundary:
# 32-byte segments and clusters of 8, 64 KB a block.
ONEPASS_AT_SPLIT_SLAB = ((16, 128, 128, 128), 16, 8)

# Kernel vs plain version on the card, same input. Both take fp32 statistics,
# summed in another order, so mean and rstd differ by a few fp32 ulps. The
# float32 output differs by that relative error times |y| <= ~6. A bfloat16
# output may round to the neighbouring bf16 value: one bf16 ulp is at most
# 2**-7 of the value.
TOL = {"float32": dict(rtol=1e-5, atol=1e-4), "bfloat16": dict(rtol=2 ** -7, atol=1e-5)}
STAT_RTOL = 1e-4

# The slice, kernel norms vs plain norms (same G, same input, bf16). Each
# norm's bf16 output may round one way or the other, and the flips travel
# through 9 residual blocks; outputs lie in [-1, 1], where a bf16 ulp is at
# most 2**-8.
SLICE_BF16_MAX = 32 * 2 ** -8
SLICE_BF16_MEAN = 2 * 2 ** -8
# The slice in float32 with TF32 off: only the norms' summation order
# differs.
SLICE_FP32_MAX = 1e-3

# The discriminators' norm slabs (N, H, W, C) in training at 256x256: down1,
# down2 and penultimate of PatchGAN2D (ndf 64, 3 layers; S = 961 is odd and
# leaves the cluster ranks unequal rows), at N = 1 and 16 (the G step) and
# 2 and 32 (the D step, real and fake in one forward). Checked in both
# dtypes; bf16 leaky_relu timed.
D_SLABS = tuple((n, s, s, c) for n in (1, 2, 16, 32)
                for s, c in ((64, 128), (32, 256), (31, 512)))

# The train phase.
TRAIN_BATCHES = (1, 16)
TRAIN_WARM_STEPS = 3
TRAIN_TIMED_STEPS = 10
# Norm launches per train step: 4 G passes (fake_B, fake_A, rec_A, rec_B)
# of 19 one-pass and 4 split norms; 3 one-pass norms in each of 2 D passes
# in the G step and 2 in the D step (real and fake in one forward). The
# backward launches none: it is plain PyTorch.
TRAIN_LAUNCHES = {"onepass": 4 * 19 + 2 * 3 + 2 * 3, "split": 4 * 4}
# Kernel norms vs plain norms over one train step (same state and batch).
# fp32, TF32 off, cuDNN deterministic: only the norms' summation order
# differs (a few fp32 ulps of the statistics; the plain run also takes its
# backward from autograd through the plain forward). Losses are means over
# 10^5-10^6 elements: 1e-4 relative. The gradients are not: the kernels'
# outputs differ from the plain version's by about one ulp here and there,
# and one-ulp noise on the outputs moves full-width gradients by several
# 1e-3 relative L2. The check prints that scale
# (`grad_rel_l2_one_ulp_output_noise_max`), the gap that the kernels'
# statistics alone make, and a repeat of the kernels' run, beside the
# kernels' gap (4.5e-3 on an H100). Bound: 1e-2 relative L2 per tensor. `NORM_BACKWARD_*` checks
# each norm's gradient alone, elementwise, tightly.
TRAIN_FP32_LOSS_RTOL = 1e-4
TRAIN_FP32_GRAD_MAX = 1e-2
# bf16: each norm's output may round to the neighbouring bf16 value (2**-8
# relative) and the flips travel through both cycles; the losses average
# them out: 1e-2 relative (the CPU tests see 5e-4 against JAX over one
# residual block). The gradients do not: the flips cascade through every
# bf16 conv, and the kernel-vs-plain relative L2 measured 0.27 (H100).
# So each bf16 run (kernels, plain) is held against the fp32 plain run's
# gradient on the same state and batch, and the kernels' run may be no
# farther from it than `TRAIN_BF16_GRAD_RATIO` times the plain run, per
# tensor at the median and at the worst tensor.
TRAIN_BF16_LOSS_RTOL = 1e-2
# A gradient that is zero in exact arithmetic (`kernel_vs_plain_steps`'
# `cancelling`), of its network's gradient norm, in fp32: rounding noise.
CANCELLING_GRAD_MAX = 1e-4
TRAIN_BF16_GRAD_RATIO = 1.5
# Each norm's gradient alone on the card, at the train step's slabs (batch
# 2): the kernel's statistics with `instance_norm_backward` against autograd
# through the plain version, elementwise. Both statistics agree to a few
# fp32 ulps, which dx = rstd * (gy - mean(gy) - y * mean(gy * y)) carries
# into ~1e-6 of max|dx| (fp32); a bf16 dx may round to the neighbouring
# value (2**-7 relative). Elements within 1e-3 of an activation's kink are
# left out (their derivative jumps), at most 1% of a slab.
NORM_BACKWARD_SLABS = (((2, 256, 256, 64), "relu"), ((2, 128, 128, 128), "relu"),
                       ((2, 64, 64, 256), "relu"), ((2, 64, 64, 256), "none"),
                       ((4, 64, 64, 128), "leaky_relu"), ((4, 32, 32, 256), "leaky_relu"),
                       ((4, 31, 31, 512), "leaky_relu"))
NORM_BACKWARD_TOL = {"float32": dict(rtol=0, atol=1e-5),
                     "bfloat16": dict(rtol=2 ** -7, atol=1e-5)}

# The V-Net's norm slabs (N, D, H, W, C) of one 28-window forward: level 0
# (input, up conv and coupling norms at 16 channels; the out block's at
# 32), level 1 (coupling halves of 16, down and up convs and couplings of
# 32), level 2, and level 3 (the one-pass slabs). Checked and timed in bf16,
# and one in float32. Then a channel count that the wrappers pad (C = 20).
VNET_SLABS = tuple((28, *s, c) for s, c in (
    ((32, 176, 176), 16), ((32, 176, 176), 32), ((16, 88, 88), 16), ((16, 88, 88), 32),
    ((8, 44, 44), 32), ((8, 44, 44), 64), ((4, 22, 22), 64), ((4, 22, 22), 128)))
VNET_FP32_SLAB = (28, 16, 88, 88, 32)
PADDED_C_SLABS = ((2, 16, 64, 64, 20), (4, 8, 22, 22, 20))
# The RevGAN's norm slabs (N, D, H, W, C) at its (32, 176, 176) patches,
# batch 1, with their activations: Piresnet3D's level 0 (the down path's
# first norm and the up path's), its down path's second norm, and its core's
# halves (a block's first norm, then its second with the ReLU); PatchGAN3D's
# two (n_layers 2) in the G step, and at batch 2 (real and fake) in the D
# step. Every one takes the split form.
REVGAN_SLABS = (((1, 32, 176, 176, 32), "relu"), ((1, 16, 88, 88, 64), "relu"),
                ((1, 16, 88, 88, 32), "none"), ((1, 16, 88, 88, 32), "relu"),
                ((1, 8, 44, 44, 128), "leaky_relu"), ((1, 7, 43, 43, 256), "leaky_relu"),
                ((2, 8, 44, 44, 128), "leaky_relu"), ((2, 7, 43, 43, 256), "leaky_relu"))

# The sliding-window phase: the BRaTS CycleGAN's G_AB at full width, served
# at `bench.py`'s volume (2 volumes of 155 x 240 x 240 a request).
SW_VOLUMES = (2, 155, 240, 240, 1)
SW_REQUESTS = 5                 # the first is cold; vols/s from the other 4
SW_PLAIN_CHECKS = (0, SW_REQUESTS - 1)
SW_PARAMS = 8_070_257
# Norm launches per request: one 28-window forward per volume, with 7
# one-pass (level 3) and 33 split norms (levels 0-2).
SW_LAUNCHES = {"onepass": 2 * 7, "split": 2 * 33}
# Kernel norms vs plain norms (same network, same volume, bf16): each
# norm's bf16 output may round to the neighbouring value and the flips
# travel through 40 norms; the blend averages overlapping windows. Outputs
# lie in [-1, 1], where a bf16 ulp is at most 2**-8.
SW_BF16_MAX = 32 * 2 ** -8
SW_BF16_MEAN = 2 * 2 ** -8
# float32, TF32 off, on one smaller volume (8 windows): only the norms'
# summation order differs.
SW_FP32_VOLUME = (1, 40, 200, 200, 1)
SW_FP32_MAX = 1e-3

# The revgan phase: the BRaTS RevGAN experiment
# (`projects/brats_mri_sequence_translation/experiments/revgan.yaml`) at full
# width through the port's Trainer, on synthetic BRaTS-shaped volumes.
REVGAN_PATCH = (32, 176, 176)
REVGAN_VOLUME = (4, 155, 240, 240)      # 4 MRI sequences of one BRaTS scan
REVGAN_VOLUMES = 3                      # training scans; one more for validation
REVGAN_NETS = {"depth": 5, "n_layers_D": 2}     # the YAML's; widths are defaults
REVGAN_YAML_LENGTHS = {"n_iters": 20000, "n_iters_decay": 20000, "logging.freq": 50,
                       "checkpointing.freq": 5000, "val.freq": 40000}
# (warm-up iterations, timed iterations, logging.freq, checkpointing.freq,
#  val.freq): one validation and one checkpoint inside the timed span.
REVGAN_RUN = (5, 10, 5, 15, 10)
REVGAN_MODEL_STEPS = (2, 5)             # (warm, timed) model-level steps a config
REVGAN_PROFILED_STEPS = 3
REVGAN_LEFT_OUT = {
    "train.dataset.root, val.dataset.root": "synthetic BRaTS-shaped 4-D NIfTI scans that the "
                                            "port's medio wrote (no BRaTS volumes in the "
                                            "repo)"}
# Memory saving against stored activations, one step from the same state
# and batch: fp32 (TF32 off, cuDNN deterministic) differs only by the
# rebuilt core inputs' rounding, a few fp32 ulps (max 2.9e-5 at values up
# to 14.3 on an NVIDIA H100 80GB HBM3 at 700 W). The losses and the Ds'
# gradients agree exactly; the G's full-width gradient, whose weight sums
# cancel over millions of elements, moves by ~1e-3 relative L2 for such
# noise (8.1e-4 on that card; one-ulp noise on the norm outputs moves it
# by several 1e-3, as in the train phase), so the step bound is the train
# phase's 1e-2 per
# network, with that control printed. The CPU tests hold the same backward
# exactly in float64 and to 1e-5 against the JAX custom VJP in fp32. In
# bf16 the rebuilt inputs round in bf16, so each run is held against the
# fp32 stored run's gradient: no farther than `TRAIN_BF16_GRAD_RATIO` times
# the stored run, at the median tensor and at the worst.
REVGAN_FP32_GRAD_MAX = TRAIN_FP32_GRAD_MAX

# The pix2pix phase: the Cityscapes label->photo Pix2Pix experiment
# (`projects/cityscapes_label2photo/experiments/pix2pix.yaml`) at full width
# through the port's Trainer, on seeded synthetic paired PNG folders.
PIX2PIX_SIZE = (256, 512)               # the YAML's final_size (H, W)
PIX2PIX_TRAIN_PAIRS = 16
PIX2PIX_VAL_PAIRS = 2
PIX2PIX_YAML_LENGTHS = {"n_iters": 297500, "n_iters_decay": 5000, "logging.freq": 100,
                        "checkpointing.freq": 5000, "val.freq": 5000}
# (warm-up iterations, timed iterations, logging.freq, checkpointing.freq,
#  val.freq): one validation and one checkpoint inside the timed span.
PIX2PIX_RUN = (5, 20, 5, 20, 15)
PIX2PIX_MODEL_STEPS = (2, 5)
# The Trainer again with the loader's threads off (`num_workers: 0`), its
# iterations (warm-up, timed): where a plain iteration's host time goes.
PIX2PIX_SYNC_RUN = (5, 15)
PIX2PIX_PROFILED_STEPS = 3
PIX2PIX_LEFT_OUT = {
    "train.logging.wandb": "the wandb package would contact its server",
    "train.dataset.root, val.dataset.root": "seeded synthetic paired PNG folders (no "
                                            "Cityscapes images in the repo)",
    "val.dataset.load_size": "[286, 572] -> [256, 512]: 7 levels need multiples of 128; "
                             "the YAML's size fails in the JAX package too",
    "train.seed": "unset in the YAML (drawn) -> the script's seed, so that a run repeats"}
# Norm launches of one Cityscapes G forward (11: downs 1-5, ups 6-1; the
# slabs of S <= 6400 rows take the one-pass form: downs 2-5 and ups 6-3),
# and of one PatchGAN2D forward (4 layers: down1 split, down2, down3 and
# the penultimate one-pass). A train step: G, D in the G step, and D on
# real and fake as one forward of batch 2.
PIX2PIX_G_LAUNCHES = {"onepass": 8, "split": 3}
PIX2PIX_D_LAUNCHES = {"onepass": 3, "split": 1}
PIX2PIX_LAUNCHES = {k: PIX2PIX_G_LAUNCHES[k] + 2 * PIX2PIX_D_LAUNCHES[k]
                    for k in PIX2PIX_G_LAUNCHES}
PIX2PIX_PARAMS = {"G": 167_275_267, "D": 6_962_625}
# The new slabs (N, *spatial, C) of the pix2pix phase, with their
# activations: the U-Net's 1024-channel levels (S = 32, 128, 512) and its
# up1; the PatchGAN2D's down1 in the D step (batch 2) and its penultimate;
# the HX4 Unet3D's up1.
PIX2PIX_SLABS = (((1, 4, 8, 1024), "none"), ((1, 8, 16, 1024), "none"),
                 ((1, 16, 32, 1024), "none"), ((1, 128, 256, 128), "none"),
                 ((2, 64, 128, 128), "leaky_relu"), ((1, 15, 31, 512), "leaky_relu"),
                 ((1, 16, 64, 64, 64), "none"))
# The HX4 PET Pix2Pix (`projects/maastro_hx4_pet_translation/experiments/
# pix2pix.yaml`): Unet3D of 4 levels, ngf 64, 2 -> 1 channels (5 norms:
# down2 and up3 one-pass, down1, up2 and up1 split; its 4 levels have no
# dropout level); PatchGAN3D of 3 layers, k4, ndf 64, 3 input channels (3
# norms: down1 split, down2 and the penultimate one-pass); lambda 10;
# (32, 128, 128) patches at batch 1, bf16.
HX4_PATCH = (32, 128, 128)
HX4_NETS = dict(spatial_dims=3, num_downs=4, ngf=64, use_dropout=True, ndf=64,
                n_layers_D=3, kernel_size_D=(4, 4, 4), in_out_channels=(2, 1),
                lambda_pix2pix=10.0, n_iters=30000, n_iters_decay=30000)
HX4_STEPS = (2, 5)
HX4_G_LAUNCHES = {"onepass": 2, "split": 3}
HX4_D_LAUNCHES = {"onepass": 2, "split": 1}
HX4_LAUNCHES = {k: HX4_G_LAUNCHES[k] + 2 * HX4_D_LAUNCHES[k] for k in HX4_G_LAUNCHES}
HX4_PARAMS = {"G": 24_659_329, "D": 11_056_065}

# The cut phase: the BRaTS CUT experiment
# (`projects/brats_mri_sequence_translation/experiments/cut.yaml`: the BRaTS
# Vnet3D, PatchNCE on its 4 encoder taps, PatchGAN3D with 2 layers, (32,
# 176, 176) patches, batch 1, bf16) at full width through the port's
# command line, on the synthetic BRaTS-shaped volumes of the revgan phase.
CUT_YAML_LENGTHS = {"n_iters": 20000, "n_iters_decay": 20000, "logging.freq": 50,
                    "checkpointing.freq": 5000, "val.freq": 40000}
# The command line's run in a subprocess: (iterations, logging.freq,
# checkpointing.freq, val.freq): a checkpoint and one validation at its end.
CUT_CLI_RUN = (4, 2, 4, 4)
# The measured run in this process: (warm-up iterations, timed iterations,
# logging.freq, checkpointing.freq, val.freq).
CUT_RUN = (5, 10, 5, 15, 10)
CUT_MODEL_STEPS = (2, 5)
CUT_PROFILED_STEPS = 3
CUT_LEFT_OUT = {
    **REVGAN_LEFT_OUT,
    "train.seed": "unset in the YAML (drawn) -> the script's seed, so that a run repeats"}
# Norm launches of one Vnet3D pass (`SW_LAUNCHES` per window: 7 one-pass at
# level 3, 33 split), of its tap pass at nce_layers [0, 1, 2, 3] (the input
# block and the 3 down blocks: 7 one-pass, 11 split) and of one PatchGAN3D
# pass (2 split). A train step: G on real_A (fake_B) and on real_B (idt_B);
# 4 tap passes (the sources and targets of NCE and identity NCE); D on real
# and fake as one forward in the D step, and on fake_B in the G step.
CUT_G_LAUNCHES = {"onepass": 7, "split": 33}
CUT_TAP_LAUNCHES = {"onepass": 7, "split": 11}
CUT_D_LAUNCHES = {"onepass": 0, "split": 2}
CUT_LAUNCHES = {k: 2 * CUT_G_LAUNCHES[k] + 4 * CUT_TAP_LAUNCHES[k] + 2 * CUT_D_LAUNCHES[k]
                for k in CUT_G_LAUNCHES}
CUT_PARAMS = {"G": 8_070_257, "D": 2_642_369, "mlp": 325_632}
# The BRaTS CUT's Vnet3D norm slabs (N, D, H, W, C) at batch 1 in
# training: level 0 (16 channels; the out block's 32), levels 1 and 2, and
# level 3 (the one-pass slab); level 0 in fp32 too (the step check).
CUT_SLABS = tuple((s, "bfloat16") for s in (
    (1, 32, 176, 176, 16), (1, 32, 176, 176, 32), (1, 16, 88, 88, 32), (1, 8, 44, 44, 64),
    (1, 4, 22, 22, 128))) + (((1, 32, 176, 176, 16), "float32"),)
# Backward nodes of the NCE work (`cut_family`).
CUT_NCE_BACKWARD = ("AddmmBackward", "MmBackward", "BmmBackward", "LogSoftmaxBackward",
                    "MaskedFillBackward", "IndexSelectBackward", "ReluBackward",
                    "SqrtBackward", "DivBackward")
# The 2D CUT and FastCUT at the CUT paper's width (Park et al., ECCV 2020):
# Resnet2D of 9 blocks, ngf 64, 3 -> 3; PatchGAN2D, ndf 64, 3 layers; taps
# (0, 4, 8, 12, 16), 256 patches, an MLP of 256; 256x256, batch 1, bf16.
# CUT with identity NCE at 0.5; FastCUT with the flip, no identity NCE and
# lambda_nce 10.
CUT2D_SIZE = 256
CUT2D_NETS = dict(
    generator={"_target_": "ganslate.nn.generators.Resnet2D", "n_residual_blocks": 9,
               "ngf": 64, "in_out_channels": {"AB": [3, 3]}},
    discriminator={"_target_": "ganslate.nn.discriminators.PatchGAN2D", "ndf": 64,
                   "n_layers": 3, "in_channels": {"B": 3}},
    nce_layers=(0, 4, 8, 12, 16), num_patches=256, mlp_nc=256)
CUT2D_CONFIGS = {
    "cut": dict(use_equivariance_flip=False, lambda_nce=1.0, lambda_nce_idt=0.5),
    "fastcut": dict(use_equivariance_flip=True, lambda_nce=10.0, lambda_nce_idt=0.0)}
CUT2D_STEPS = (2, 6)
CUT2D_PARAMS = {"G": 11_378_179, "D": 2_764_737}

# The BRaTS NIfTI root of the revgan, cut and brats_cyclegan phases: the
# synthetic scans of `brats_volumes` (4 sequences of (155, 240, 240),
# float32), written once per run as 4-D `.nii.gz` files by the port's
# `medio.write` (`write_brats_root`): REVGAN_VOLUMES in `imagesTr/`, one in
# `imagesTs/`. The phases read them through the project's datasets, which
# the port's config loader takes from its twin
# (`ganslate_tpu_torch/projects/brats_mri_sequence_translation/`).
HERE = Path(__file__).resolve().parent
BRATS_PROJECT = HERE / "projects" / "brats_mri_sequence_translation"
BRATS_DATASETS = {"train": "project.datasets.train_dataset.BratsDataset",
                  "val": "project.datasets.val_test_dataset.BratsValTestDataset"}
BRATS_SPLITS = {"train": "imagesTr", "val": "imagesTs"}
_BRATS_ROOT = []
# The native phase: the host data ops (`ganslate_tpu_torch/native/`, host
# C++ built by g++) against their plain numpy versions on one sequence of
# the validation scan, (155, 240, 240), and on an HX4 padded validation
# volume (a CT in HU and its body mask). `masked_fill` and `extract_patch`
# copy bits: equal. Clip and z-score outputs lie in [-1, 1] and the plain
# versions fuse the multiply-adds that GCC contracts, so they differ only
# where the compiler contracts otherwise: 2 ulps of 1.0 (2^-22), absolute.
# `mean_std` sums in float64 in another order: 1e-6 relative. Times: the
# median of NATIVE_REPS calls after a warm one, on the host's clock.
NATIVE_HX4_VOLUME = (64, 512, 512)
NATIVE_PATCH = ((61, 32, 32), REVGAN_PATCH)
NATIVE_CLIP = {"brats": (0.0, 500.0), "hx4": (-1000.0, 2000.0)}      # HU for the CT
NATIVE_ATOL = 2.0 ** -22
NATIVE_MEAN_STD_RTOL = 1e-6
NATIVE_REPS = 5
# The training batches that the revgan, cut and brats_cyclegan phases hold
# their model-level steps and checks on: 4, drawn once per run from the
# NIfTI root (`brats_batches`).
BRATS_BATCHES = (4, SEED + 41)
_BRATS_BATCHES = {}

# The brats_cyclegan phase: the BRaTS CycleGAN experiment
# (`projects/brats_mri_sequence_translation/experiments/cyclegan.yaml`: two
# Vnet3Ds, down blocks (2, 2, 3), up blocks (3, 3, 3), 16 first-layer
# channels; two PatchGAN3Ds with 2 layers; (32, 176, 176) patches, batch 1,
# bf16, lambda_AB and lambda_BA 5), loaded from its YAML by `init_engine`
# with only the overrides of `brats_cyclegan_overrides`, on the NIfTI root.
# Runs: (warm-up iterations, timed iterations, logging.freq,
# checkpointing.freq, val.freq); `cyclegan_s2d.yaml` repeats it shorter.
BRATS_CYCLEGAN_YAML_LENGTHS = {"n_iters": 20000, "n_iters_decay": 20000, "logging.freq": 50,
                               "checkpointing.freq": 5000, "val.freq": 40000}
BRATS_CYCLEGAN_RUN = (5, 10, 5, 15, 10)
BRATS_CYCLEGAN_S2D_RUN = (2, 4, 2, 6, 6)
BRATS_CYCLEGAN_MODEL_STEPS = (2, 5)
BRATS_CYCLEGAN_PROFILED_STEPS = 3
# Norm launches of a CycleGAN step: 4 Vnet3D passes (fake_B, rec_A, fake_A,
# rec_B) of `CUT_G_LAUNCHES`; PatchGAN3D on fake_B and fake_A in the G step
# and, in the D step, each D on real and fake as one forward, of
# `CUT_D_LAUNCHES`. A validation runs G_AB and, for the cycle metrics, G_BA
# over every window.
BRATS_CYCLEGAN_LAUNCHES = {k: 4 * CUT_G_LAUNCHES[k] + 4 * CUT_D_LAUNCHES[k]
                           for k in CUT_G_LAUNCHES}
BRATS_CYCLEGAN_PARAMS = {"G_AB": 8_070_257, "G_BA": 8_070_257, "D_B": 2_642_369,
                         "D_A": 2_642_369}
# Inert biases: the conv before each norm of both Gs and both Ds.
BRATS_CYCLEGAN_INERT = 2 * sum(CUT_G_LAUNCHES.values()) + 2 * sum(CUT_D_LAUNCHES.values())

# Published peaks (NVIDIA data sheets): HBM bytes/s, fp32 (non-tensor)
# FLOP/s and dense bf16 tensor FLOP/s, by card.
CARDS = (("H100 PCIe", 2.0e12, 51e12, 756e12), ("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H100", 3.35e12, 67e12, 989e12), ("H200", 4.8e12, 67e12, 989e12))

def check(ok, what):
    """Raise when a check fails (unlike `assert`, also under `python -O`)."""
    if not ok:
        raise AssertionError(what)


def emit(obj):
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def card_peaks(name: str):
    """(bytes/s, fp32 FLOP/s, dense bf16 tensor FLOP/s) of the card."""
    for key, *peaks in CARDS:
        if key in name:
            return peaks
    raise RuntimeError(f"no published peaks for card {name!r}")


# ---------------------------------------------------------------- timing


def time_ms(fn, iters=20, reps=5, spin_cycles=20_000_000):
    """Median device time of `fn` in ms, with CUDA events around `iters`
    back-to-back calls. A spin kernel queued first keeps the device busy
    while the host enqueues the calls, so the events time the device, not
    the host's launch overhead; `host_bound` says if the enqueue outlasted
    the spin (`spin_cycles` of the SM clock, 20M being ~10 ms on an H100)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, host_bound = [], False
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        host_bound |= enqueue_ms > 0.8 * spin_cycles / 2e6
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times), host_bound


# ------------------------------------------------------------- phase 3


def onepass_geometry_record(shape, dtype, g, k):
    """G, K, blocks per launch and slab bytes per block of the one-pass
    kernel at (g, k) on `shape`."""
    n, c, s = shape[0], shape[-1], math.prod(shape[1:-1])
    return {"G": g, "K": k, "blocks": k * (c // g) * n,
            "smem_bytes": -(-s // k) * g * dtype.itemsize}


def chosen_geometry(kernel, shape, dtype):
    """The geometry record of `onepass_geometry`'s choice; {} for the split
    form."""
    from ganslate_tpu_torch.ops import instance_norm as inorm
    if kernel != "onepass":
        return {}
    return onepass_geometry_record(shape, dtype, *inorm.onepass_geometry(shape, dtype)[:2])


def split_geometry_record(shape, dtype, tile_rows, seg_bytes, threads, reverse):
    """Tile rows, row segment, threads, blocks per launch, stats shared
    memory per block and order of the split kernels on `shape`."""
    from ganslate_tpu_torch.ops import instance_norm as inorm
    n, c, s = shape[0], shape[-1], math.prod(shape[1:-1])
    tile_rows = min(tile_rows, s)
    return {"tile_rows": tile_rows, "seg_bytes": seg_bytes, "threads": threads,
            "blocks": n * (c * dtype.itemsize // seg_bytes) * -(-s // tile_rows),
            "smem_bytes": inorm.split_stats_smem(dtype, tile_rows, seg_bytes, threads),
            "reverse": reverse}


def geometry_record(kernel, shape, dtype):
    """The geometry record of the kernel's chosen geometry on `shape`."""
    from ganslate_tpu_torch.ops import instance_norm as inorm
    if kernel == "onepass":
        return chosen_geometry(kernel, shape, dtype)
    return split_geometry_record(shape, dtype, *inorm.split_geometry(shape, dtype)[:3],
                                 inorm.SPLIT_REVERSE)


def compare_kernel(kernel, x, act, fn=None):
    """One kernel (or `fn`, a call of it) against the plain version on the
    same input; raises when they disagree beyond `TOL` / `STAT_RTOL`."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    fn = fn or (lambda: inorm.KERNELS[kernel](x, 1e-5, act, 0.2))
    with torch.inference_mode():
        got = fn()
        want = inorm.instance_norm_reference(x, 1e-5, act, 0.2)
    torch.cuda.synchronize()
    dname = str(x.dtype).split(".")[1]
    tol = TOL[dname]
    out_err = (got[0].float() - want[0].float()).abs()
    limit = tol["atol"] + tol["rtol"] * want[0].float().abs()
    mean_err = float(((got[1] - want[1]).abs() / want[1].abs().clamp_min(1e-3)).max())
    rstd_err = float(((got[2] - want[2]).abs() / want[2].abs()).max())
    ok = bool((out_err <= limit).all()) and mean_err <= STAT_RTOL and rstd_err <= STAT_RTOL
    rec = {"kernel": kernel, "shape": list(x.shape), "dtype": dname, "activation": act,
           "max_abs_err": float(out_err.max()), "mean_rel_err": mean_err,
           "rstd_rel_err": rstd_err, "tol": tol, "stat_rtol": STAT_RTOL, "ok": ok}
    if not ok:
        emit({"phase": "kernel", **rec})
        raise AssertionError(f"{kernel} disagrees with the plain version: {rec}")
    return rec


def check_kernels(bandwidth, flops):
    import torch
    import torch.nn.functional as F
    from ganslate_tpu_torch.ops import instance_norm as inorm

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def activations(shape, dtype):
        # Post-conv activations: non-zero mean, std of a few units.
        return (torch.randn(shape, generator=gen, device="cuda") * 3 + 1.5).to(dtype)

    summary = {name: {"max_abs_err": 0.0} for name in inorm.KERNELS}
    for shape in SLABS:
        for dtype in (torch.bfloat16, torch.float32):
            x = activations(shape, dtype)
            kernel = inorm.pick_kernel(x.shape, x.dtype)
            n, c = shape[0], shape[-1]
            nbytes = 2 * x.numel() * x.element_size() + 2 * n * c * 4
            # Per element: sum, (x - mean)^2 accumulate (2), subtract,
            # multiply, activation: about 6 fp32 operations.
            nops = 6 * x.numel()
            bound_bytes_ms, bound_ops_ms = nbytes / bandwidth * 1e3, nops / flops * 1e3
            bound_ms = max(bound_bytes_ms, bound_ops_ms)
            bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
            geometry = geometry_record(kernel, shape, dtype)
            nchw = x.permute(0, 3, 1, 2)   # the same tensor, as torch's norms see it
            for act in inorm.ACTIVATIONS:
                rec = compare_kernel(kernel, x, act)
                summary[kernel]["max_abs_err"] = max(summary[kernel]["max_abs_err"],
                                                     rec["max_abs_err"])
                act_fn = {"none": lambda y: y, "relu": F.relu,
                          "leaky_relu": lambda y: F.leaky_relu(y, 0.2)}[act]
                with torch.inference_mode():
                    ms, hb1 = time_ms(lambda: inorm.KERNELS[kernel](x, 1e-5, act, 0.2))
                    plain_ms, hb2 = time_ms(
                        lambda: inorm.instance_norm_reference(x, 1e-5, act, 0.2))
                    library_ms, hb3 = time_ms(lambda: F.instance_norm(nchw, eps=1e-5))
                    library_act_ms, hb4 = time_ms(
                        lambda: act_fn(F.instance_norm(nchw, eps=1e-5)))
                rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           library_act_ms=library_act_ms, bound_ms=bound_ms,
                           bound_by=bound_by, bytes=nbytes, tb_per_s=nbytes / ms / 1e9,
                           host_bound=hb1 or hb2 or hb3 or hb4, **geometry)
                emit({"phase": "kernel", **rec})
                if tuple(shape) == MAIN_SLAB[kernel] and dtype == torch.bfloat16 \
                        and act == "none":
                    summary[kernel].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                           bound_ms=bound_ms, bound_by=bound_by,
                                           tb_per_s=rec["tb_per_s"], **geometry)
            del x, nchw

    # The discriminators' slabs (train phase): checked, bf16 leaky_relu timed.
    for shape in D_SLABS:
        for dtype in (torch.bfloat16, torch.float32):
            x = activations(shape, dtype)
            kernel = inorm.pick_kernel(x.shape, x.dtype)
            geometry = geometry_record(kernel, shape, dtype)
            for act in inorm.ACTIVATIONS:
                rec = compare_kernel(kernel, x, act)
                summary[kernel]["max_abs_err"] = max(summary[kernel]["max_abs_err"],
                                                     rec["max_abs_err"])
                if dtype == torch.bfloat16 and act == "leaky_relu":
                    nchw = x.permute(0, 3, 1, 2)
                    with torch.inference_mode():
                        rec["ms"], hb1 = time_ms(
                            lambda: inorm.KERNELS[kernel](x, 1e-5, act, 0.2))
                        rec["plain_ms"], hb2 = time_ms(
                            lambda: inorm.instance_norm_reference(x, 1e-5, act, 0.2))
                        rec["library_ms"], hb3 = time_ms(
                            lambda: F.leaky_relu(F.instance_norm(nchw, eps=1e-5), 0.2))
                    nbytes = 2 * x.numel() * x.element_size() + 2 * shape[0] * shape[-1] * 4
                    rec.update(bound_ms=nbytes / bandwidth * 1e3, host_bound=hb1 or hb2 or hb3)
                    del nchw
                emit({"phase": "kernel_d", **rec, **geometry})
            del x

    def timed_slab(phase, shape, dtype, act, iters=5):
        """A slab checked and timed against the plain version, the library
        call (`F.instance_norm` and the activation) and the bound."""
        x = activations(shape, dtype)
        kernel = inorm.pick_kernel(x.shape, x.dtype)
        rec = compare_kernel(kernel, x, act)
        summary[kernel]["max_abs_err"] = max(summary[kernel]["max_abs_err"], rec["max_abs_err"])
        nc = x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))    # the same tensor, as torch sees it
        act_fn = {"none": lambda y: y, "relu": F.relu,
                  "leaky_relu": lambda y: F.leaky_relu(y, 0.2)}[act]
        with torch.inference_mode():
            ms, hb1 = time_ms(lambda: inorm.KERNELS[kernel](x, 1e-5, act, 0.2), iters=iters)
            plain_ms, hb2 = time_ms(lambda: inorm.instance_norm_reference(x, 1e-5, act, 0.2),
                                    iters=iters)
            library_ms, hb3 = time_ms(lambda: act_fn(F.instance_norm(nc, eps=1e-5)),
                                      iters=iters)
        nbytes = 2 * x.numel() * x.element_size() + 2 * shape[0] * shape[-1] * 4
        bound_bytes_ms, bound_ops_ms = nbytes / bandwidth * 1e3, 6 * x.numel() / flops * 1e3
        emit({"phase": phase, **rec, **geometry_record(kernel, shape, dtype), "ms": ms,
              "plain_ms": plain_ms, "library_ms": library_ms,
              "bound_ms": max(bound_bytes_ms, bound_ops_ms),
              "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
              "bytes": nbytes, "tb_per_s": nbytes / ms / 1e9, "host_bound": hb1 or hb2 or hb3})

    # The V-Net's slabs (sliding-window phase): checked and timed, activation
    # none (the V-Net's PReLU follows the norm), against the plain version,
    # `F.instance_norm` and the bound.
    for shape, dtype in [(s, torch.bfloat16) for s in VNET_SLABS] + [(VNET_FP32_SLAB,
                                                                     torch.float32)]:
        timed_slab("kernel_vnet", shape, dtype, "none")

    # The RevGAN's slabs (revgan phase), with their activations: timed in
    # bf16, checked in fp32 too.
    for shape, act in REVGAN_SLABS:
        timed_slab("kernel_revgan", shape, torch.bfloat16, act)
        x = activations(shape, torch.float32)
        rec = compare_kernel(inorm.pick_kernel(x.shape, x.dtype), x, act)
        summary[rec["kernel"]]["max_abs_err"] = max(summary[rec["kernel"]]["max_abs_err"],
                                                   rec["max_abs_err"])
        emit({"phase": "kernel_revgan", **rec})
        del x

    # The Pix2Pix slabs (pix2pix phase), with their activations: checked and
    # timed in both dtypes.
    for shape, act in PIX2PIX_SLABS:
        for dtype in (torch.bfloat16, torch.float32):
            timed_slab("kernel_pix2pix", shape, dtype, act, iters=20)

    # The BRaTS CUT's Vnet3D slabs at batch 1 in training (cut phase):
    # checked and timed, level 0 in fp32 too.
    for shape, dtype in CUT_SLABS:
        timed_slab("kernel_cut", shape, getattr(torch, dtype), "none")

    # The HX4 and ClearGrasp slabs (hx4 and cleargrasp phases), with their
    # activations: checked and timed in bf16.
    for shape, act in PROJECT_SLABS:
        timed_slab("kernel_project", shape, torch.bfloat16, act, iters=10)

    # Channel counts that are not a multiple of the channel block: the
    # wrappers pad them (checked in both dtypes, each form).
    for shape in PADDED_C_SLABS:
        for dtype in (torch.bfloat16, torch.float32):
            x = activations(shape, dtype)
            kernel = inorm.pick_kernel(x.shape, x.dtype)
            for act in inorm.ACTIVATIONS:
                emit({"phase": "kernel_padded_c", **compare_kernel(kernel, x, act)})
            del x

    # Shapes off the slice's path, checked only: ragged row tiles, a 3D
    # volume, both sides of the one-pass limit.
    for shape in EDGE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = activations(shape, dtype)
            kernel = inorm.pick_kernel(x.shape, x.dtype)
            geometry = geometry_record(kernel, shape, dtype)
            for act in inorm.ACTIVATIONS:
                emit({"phase": "kernel_edge", **compare_kernel(kernel, x, act), **geometry})
    return summary


def sweep_onepass_geometry(bandwidth):
    """The one-pass kernel at every (G, K) whose slab fits, at the two main
    one-pass slabs in both dtypes: each checked against the plain version
    and timed, beside `onepass_geometry`'s choice."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for shape in ((16, 64, 64, 256), (1, 64, 64, 256)):
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1.5).to(dtype)
            nbytes = 2 * x.numel() * x.element_size() + 2 * shape[0] * shape[-1] * 4
            chosen = inorm.onepass_geometry(shape, dtype)[:2]
            s, c = math.prod(shape[1:-1]), shape[-1]
            for seg in SWEEP_SEGMENT_BYTES:
                g = seg // dtype.itemsize
                for k in SWEEP_CLUSTER_SIZES:
                    if c % g or k > s or -(-s // k) * seg > inorm.ONEPASS_MAX_SMEM:
                        continue
                    fn = lambda: inorm._launch_onepass(x, g, k, 1e-5, "none", 0.2)  # noqa: E731
                    rec = compare_kernel("onepass", x, "none", fn)
                    with torch.inference_mode():
                        ms, host_bound = time_ms(fn)
                    emit({"phase": "onepass_geometry", "shape": list(shape),
                          "dtype": rec["dtype"], **onepass_geometry_record(shape, dtype, g, k),
                          "chosen": (g, k) == chosen, "ms": ms,
                          "tb_per_s": nbytes / ms / 1e9,
                          "bound_ms": nbytes / bandwidth * 1e3, "host_bound": host_bound,
                          "max_abs_err": rec["max_abs_err"]})
            del x


def split_slabs():
    """The slabs of `SLABS` that take the split form."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    return [s for s in SLABS if inorm.pick_kernel(s, torch.bfloat16) == "split"]


def sweep_split_geometry(bandwidth):
    """The split kernels at every tile size, thread count and order at the
    four split slabs in both dtypes: each checked against the plain version
    and timed, beside `split_geometry`'s choice."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for shape in split_slabs():
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1.5).to(dtype)
            nbytes = 2 * x.numel() * x.element_size() + 2 * shape[0] * shape[-1] * 4
            rows_c, seg, threads_c, _ = inorm.split_geometry(shape, dtype)
            chosen = (rows_c, threads_c, inorm.SPLIT_REVERSE)
            s = math.prod(shape[1:-1])
            for tile_bytes in SWEEP_SPLIT_TILE_BYTES:
                rows = min(s, tile_bytes // seg)
                for threads in SWEEP_SPLIT_THREADS:
                    if threads % math.lcm(seg // 16, 32):
                        continue
                    for reverse in (False, True):
                        fn = lambda: inorm._launch_split(  # noqa: E731
                            x, rows, seg, threads, reverse, 1e-5, "none", 0.2)
                        rec = compare_kernel("split", x, "none", fn)
                        with torch.inference_mode():
                            ms, host_bound = time_ms(fn)
                        emit({"phase": "split_geometry", "shape": list(shape),
                              "dtype": rec["dtype"],
                              **split_geometry_record(shape, dtype, rows, seg, threads, reverse),
                              "chosen": (rows, threads, reverse) == chosen, "ms": ms,
                              "tb_per_s": nbytes / ms / 1e9,
                              "bound_ms": nbytes / bandwidth * 1e3, "host_bound": host_bound,
                              "max_abs_err": rec["max_abs_err"]})
            del x


def split_parts(bandwidth, summary):
    """At the four split slabs in both dtypes, at `split_geometry`'s choice:
    the stats kernel (with its fold) and the normalise kernel timed apart,
    each beside its own bound (stats reads x; normalise reads x and writes
    y); and two calls of the split form on one input, which must give equal
    outputs and statistics bit for bit. Adds the main slab's times to
    `summary`."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for shape in split_slabs():
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1.5).to(dtype)
            rows, seg, threads, _ = inorm.split_geometry(shape, dtype)
            with torch.inference_mode():
                out, mean, rstd = inorm._outputs(x)
                stats_ms, hb1 = time_ms(lambda: inorm._split_stats(
                    x, mean, rstd, rows, seg, threads, 1e-5))
                norm_ms, hb2 = time_ms(lambda: inorm._split_norm(
                    x, mean, rstd, out, rows, seg, threads, inorm.SPLIT_REVERSE, "relu", 0.2))
                first = inorm.split(x, 1e-5, "relu", 0.2)
                second = inorm.split(x, 1e-5, "relu", 0.2)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(first, second))
            xbytes = x.numel() * x.element_size()
            rec = {"phase": "split_parts", "shape": list(shape),
                   "dtype": str(dtype).split(".")[1],
                   **geometry_record("split", shape, dtype),
                   "stats_ms": stats_ms, "stats_bound_ms": xbytes / bandwidth * 1e3,
                   "stats_tb_per_s": xbytes / stats_ms / 1e9,
                   "norm_ms": norm_ms, "norm_bound_ms": 2 * xbytes / bandwidth * 1e3,
                   "norm_tb_per_s": 2 * xbytes / norm_ms / 1e9,
                   "host_bound": hb1 or hb2, "deterministic": same}
            emit(rec)
            check(same, f"two split calls on one input differ: {rec}")
            if tuple(shape) == MAIN_SLAB["split"] and dtype == torch.bfloat16:
                summary["split"].update(stats_ms=stats_ms, norm_ms=norm_ms)
            del x, out, mean, rstd, first, second


def onepass_at_split_slab(bandwidth):
    """The one-pass cluster kernel at a split slab, beside the split form on
    the same input: whether the slab should move to the one-pass form."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm

    shape, g, k = ONEPASS_AT_SPLIT_SLAB
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1.5).to(dtype)
    nbytes = 2 * x.numel() * x.element_size() + 2 * shape[0] * shape[-1] * 4
    fn = lambda: inorm._launch_onepass(x, g, k, 1e-5, "none", 0.2)  # noqa: E731
    rec = compare_kernel("onepass", x, "none", fn)
    with torch.inference_mode():
        ms, hb1 = time_ms(fn)
        split_ms, hb2 = time_ms(lambda: inorm.split(x, 1e-5, "none", 0.2))
    emit({"phase": "onepass_at_split_slab", "shape": list(shape), "dtype": rec["dtype"],
          **onepass_geometry_record(shape, dtype, g, k), "ms": ms, "split_ms": split_ms,
          "bound_ms": nbytes / bandwidth * 1e3, "tb_per_s": nbytes / ms / 1e9,
          "host_bound": hb1 or hb2, "max_abs_err": rec["max_abs_err"]})


# ------------------------------------------------------------- phase 4


@contextlib.contextmanager
def plain_norms():
    """Run the port's layers with the plain instance norm (the reference
    run of this script; the port itself has no such switch)."""
    from ganslate_tpu_torch.nn import layers
    from ganslate_tpu_torch.ops.instance_norm import instance_norm_reference
    kernel_fn = layers.instance_norm

    def plain(x, eps, act, slope, shards=None):
        check(shards is None, "plain_norms serves unsharded layers only")
        return instance_norm_reference(x, eps, act, slope)[0]

    layers.instance_norm = plain
    try:
        yield
    finally:
        layers.instance_norm = kernel_fn


def make_conf(out_dir, mixed_precision=True, wire_dtype="bfloat16"):
    """The horse2zebra G_AB serving config at full width, built in Python
    (no PyYAML) through the port's config loader."""
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    raw = {
        "train": {
            "output_dir": str(out_dir), "batch_size": 1, "cuda": True,
            "mixed_precision": mixed_precision, "n_iters": 117700, "n_iters_decay": 117700,
            "seed": SEED,
            "gan": {
                "_target_": "ganslate.nn.gans.unpaired.CycleGAN",
                "generator": {"_target_": "ganslate.nn.generators.Resnet2D",
                              "n_residual_blocks": 9, "ngf": 64,
                              "in_out_channels": {"AB": [3, 3]}},
                "optimizer": {"lambda_AB": 10.0, "lambda_BA": 10.0, "lambda_identity": 0,
                              "proportion_ssim": 0, "lr_D": 0.0002, "lr_G": 0.0002},
            },
        },
        "infer": {"is_deployment": True, "wire_dtype": wire_dtype,
                  "checkpointing": {"load_iter": 1}},
    }
    return init_config(Conf.create(raw), Config)


def serve_slice(out_dir):
    import numpy as np
    import torch
    from ganslate_tpu_torch.engines.inferer import Inferer
    from ganslate_tpu_torch.ops import instance_norm as inorm
    from ganslate_tpu_torch.utils.builders import build_G

    conf = make_conf(out_dir)
    g = build_G(conf, "AB", torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in g.parameters())
    (out_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
    torch.save({"G_AB": g.state_dict()}, out_dir / "checkpoints" / "1.pth")
    del g

    inferer = Inferer(conf)
    rng = np.random.default_rng(SEED)
    latencies = {1: [], 16: []}
    totals = {name: 0 for name in inorm.LAUNCHES}
    for i, batch in enumerate(BATCHES):
        x = rng.uniform(-1, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)
        inorm.reset_launches()
        t0 = time.perf_counter()
        y = inferer.infer(x)            # returns on the host: synchronised
        latency_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(inorm.LAUNCHES)

        with plain_norms():
            inorm.reset_launches()
            ref = inferer.infer(x)
            check(sum(inorm.LAUNCHES.values()) == 0, "the plain run launched a kernel")
        yf, rf = y.float(), ref.float()
        err = (yf - rf).abs()
        rec = {"phase": "slice", "request": i, "batch": batch, "shape": list(y.shape),
               "dtype": str(y.dtype), "latency_ms": latency_ms, "launches": launches,
               "max_abs_err_vs_plain": float(err.max()),
               "mean_abs_err_vs_plain": float(err.mean()),
               "out_min": float(yf.min()), "out_max": float(yf.max()),
               "out_std": float(yf.std())}
        emit(rec)
        check(tuple(y.shape) == (batch, SIZE, SIZE, 3), rec)
        check(y.dtype == torch.bfloat16 and y.device.type == "cpu", rec)
        check(bool(torch.isfinite(yf).all()) and -1 <= rec["out_min"] <= rec["out_max"] <= 1, rec)
        check(rec["out_std"] > 0.01, f"degenerate output: {rec}")
        check(sum(launches.values()) == NORMS_PER_FORWARD, rec)
        check(launches["onepass"] == 19 and launches["split"] == 4, rec)
        check(rec["max_abs_err_vs_plain"] <= SLICE_BF16_MAX, rec)
        check(rec["mean_abs_err_vs_plain"] <= SLICE_BF16_MEAN, rec)
        latencies[batch].append(latency_ms)
        for name, count in launches.items():
            totals[name] += count

    # Device time of one G forward at batch 16 (requests excluded: no wire).
    model = inferer.model
    x16 = torch.from_numpy(rng.uniform(-1, 1, (16, SIZE, SIZE, 3)).astype(np.float32)) \
        .to(model.device, torch.bfloat16)
    forward_ms, host_bound = time_ms(lambda: model.infer(x16), iters=5, reps=5,
                                     spin_cycles=200_000_000)
    fwd1_ms, host_bound1 = time_ms(lambda: model.infer(x16[:1]), iters=5, reps=5,
                                   spin_cycles=200_000_000)
    stats = {"phase": "slice_summary", "params": n_params,
             "latency_ms_batch1": latencies[1], "latency_ms_batch16": latencies[16],
             "median_latency_ms_batch1": statistics.median(latencies[1]),
             "median_latency_ms_batch16": statistics.median(latencies[16]),
             "images_per_s_batch16": 16 / statistics.median(latencies[16]) * 1e3,
             "images_per_s_batch1": 1 / statistics.median(latencies[1]) * 1e3,
             "forward_device_ms_batch16": forward_ms, "forward_host_bound_batch16": host_bound,
             "forward_device_ms_batch1": fwd1_ms, "forward_host_bound_batch1": host_bound1,
             "launches_total": totals}
    emit(stats)
    return inferer, x16, totals


def check_fp32_slice(out_dir):
    """The slice in float32 (TF32 off, so that convs are exact fp32 and only
    the norms' summation order differs) at batch 2: kernel norms vs plain.
    Serves the checkpoint that `serve_slice` wrote to `out_dir`."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.engines.inferer import Inferer

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        inferer = Inferer(make_conf(out_dir, mixed_precision=False, wire_dtype="float32"))
        x = np.random.default_rng(SEED + 1).uniform(-1, 1, (2, SIZE, SIZE, 3)) \
            .astype(np.float32)
        y = inferer.infer(x)
        with plain_norms():
            ref = inferer.infer(x)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    err = float((y - ref).abs().max())
    rec = {"phase": "slice_fp32", "batch": 2, "dtype": str(y.dtype),
           "max_abs_err_vs_plain": err, "tol": SLICE_FP32_MAX}
    emit(rec)
    check(y.dtype == torch.float32 and bool(torch.isfinite(y).all()), rec)
    check(err <= SLICE_FP32_MAX, rec)


# ------------------------------------------------------------- phase 5


def profile_forward(inferer, x16):
    """Device time of one batch-16 G forward by kernel family."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    model = inferer.model
    model.infer(x16)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.infer(x16)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = {"inorm": 0.0, "conv": 0.0, "other": 0.0}
    kernels = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us or "CUDA" not in str(getattr(ev, "device_type", "")):
            continue            # host-side ops; only kernels carry device time
        name = ev.key
        low = name.lower()
        fam = ("inorm" if "inorm" in low else
               "conv" if any(k in low for k in ("conv", "gemm", "xmma", "cudnn", "sm90",
                                                "implicit", "dgrad", "wgrad", "fprop",
                                                "cutlass")) else "other")
        families[fam] += us / 1e3
        kernels.append((us / 1e3, ev.count, name[:90]))
    busy = sum(families.values())
    rec = {"phase": "profile", "batch": 16, "wall_ms": wall_ms,
           "device_busy_ms": busy if busy else "not measured",
           "device_ms_by_family": families if busy else "not measured",
           "device_idle_share": (1 - busy / wall_ms) if busy else "not measured",
           "top_kernels": [list(k) for k in sorted(kernels, reverse=True)[:12]]}
    emit(rec)


# ------------------------------------------------------------- phase 6


def train_conf(out_dir, batch, mixed_precision):
    """The horse2zebra CycleGAN training config at full width (pool 50),
    metrics on, built in Python (`utils/testing.py:make_cyclegan_conf`)."""
    from ganslate_tpu_torch.utils.testing import make_cyclegan_conf
    conf = make_cyclegan_conf(str(out_dir), batch_size=batch, mixed_precision=mixed_precision,
                              n_iters=117700, seed=SEED)
    conf.train.metrics.discriminator_evolution = True
    conf.train.metrics.ssim = True
    return conf


def train_batch(rng, batch):
    import numpy as np
    return {k: rng.uniform(-1, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)
            for k in ("A", "B")}


def build_trainer(conf, batch):
    from ganslate_tpu_torch.utils.builders import build_gan
    model = build_gan(conf)
    model.setup(batch)
    return model


@contextlib.contextmanager
def plain_forward(ulp_noise=False, kernel_stats=False):
    """The port's norms with the plain forward under `InstanceNormFunction`,
    whose backward stays. `ulp_noise` moves each element of every norm
    output by -1, 0 or +1 times 2**-23 of its value (at most about one fp32
    ulp), drawn from a seeded generator: the size of the difference between
    two correct forwards that round in another order. `kernel_stats` hands
    the backward the kernels' statistics instead of the plain ones."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    forward = inorm.instance_norm_forward
    gens = {}

    def plain(x, eps, activation, negative_slope):
        out, mean, rstd = inorm.instance_norm_reference(x, eps, activation, negative_slope)
        if kernel_stats:
            mean, rstd = forward(x, eps, activation, negative_slope)[1:]
        if ulp_noise:
            if out.device not in gens:
                gens[out.device] = torch.Generator(device=out.device).manual_seed(SEED + 10)
            sign = torch.randint(-1, 2, out.shape, generator=gens[out.device],
                                 device=out.device)
            out = out * (1 + sign * 2.0 ** -23)
        return out, mean, rstd

    inorm.instance_norm_forward = plain
    try:
        yield
    finally:
        inorm.instance_norm_forward = forward


@contextlib.contextmanager
def plain_reordered(kind):
    """The port's norms with another correct plain forward, which rounds
    in another order than `instance_norm_reference`: its statistics summed
    over the rows in reverse (`kind` "reversed"), or taken in float64
    ("float64"). In bf16 each flips some outputs to the neighbouring value,
    as the kernels do: the controls of a bf16 comparison."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    forward = inorm.instance_norm_forward

    def plain(x, eps, activation, negative_slope):
        if kind == "reversed":
            rows = x.flatten(1, -2).flip(1).reshape(x.shape)
            out, mean, rstd = inorm.instance_norm_reference(rows, eps, activation,
                                                            negative_slope)
            return out.flatten(1, -2).flip(1).reshape(x.shape), mean, rstd
        x64 = x.double()
        axes = tuple(range(1, x.ndim - 1))
        mean = x64.mean(axes, keepdim=True)
        rstd = torch.rsqrt((x64 - mean).square().mean(axes, keepdim=True) + eps)
        out = ((x64 - mean) * rstd).float()
        if activation == "relu":
            out = out.clamp_min(0)
        elif activation == "leaky_relu":
            out = torch.where(out >= 0, out, out * negative_slope)
        n = x.shape[0]
        return out.to(x.dtype), mean.float().reshape(n, -1), rstd.float().reshape(n, -1)

    inorm.instance_norm_forward = plain
    try:
        yield
    finally:
        inorm.instance_norm_forward = forward


def one_step(conf, batch, norms):
    """Losses, gradients and norm launches of one train step of a fresh
    model (its state made from the seed) on `batch`, inside the context
    manager `norms` (which may swap the norms)."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    model = build_trainer(conf, batch)
    model.set_input(batch)
    inorm.reset_launches()
    with norms:
        model.optimize_parameters()
    torch.cuda.synchronize()
    launches = dict(inorm.LAUNCHES)
    losses = {k: float(v) for k, v in model.losses.items()}
    grads = {f"{name}.{k}": p.grad for name, net in model.networks.items()
             for k, p in net.named_parameters()}
    return losses, grads, launches


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def check_train_step(out_dir, mixed_precision, fp32_grads=None):
    """One train step with the kernel norms against one with the plain norms
    (`plain_norms`), from the same state and batch, at batch 2: losses and
    the relative L2 error of every gradient. cuDNN deterministic; in fp32
    with TF32 off. In bf16, both runs' gradients are also held against
    `fp32_grads`, the fp32 plain run's. Returns the plain run's gradients."""
    import numpy as np
    import torch
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    if not mixed_precision:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        conf = train_conf(out_dir, 2, mixed_precision)
        batch = train_batch(np.random.default_rng(SEED + 6), 2)
        losses, grads, launches = one_step(conf, batch, contextlib.nullcontext())
        ref_losses, ref_grads, ref_launches = one_step(conf, batch, plain_norms())
        if not mixed_precision:
            # The scale of the gap: the kernels' run repeated (atomics in the
            # pad backward); the port's backward under the plain forward
            # against autograd; that run with the kernels' statistics, and
            # with one-ulp noise on every norm output.
            repeat = one_step(conf, batch, contextlib.nullcontext())[1]
            plain_fwd = one_step(conf, batch, plain_forward())[1]
            kernel_stats = one_step(conf, batch, plain_forward(kernel_stats=True))[1]
            one_ulp = one_step(conf, batch, plain_forward(ulp_noise=True))[1]
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    dname = "bfloat16" if mixed_precision else "float32"
    loss_rtol = TRAIN_BF16_LOSS_RTOL if mixed_precision else TRAIN_FP32_LOSS_RTOL
    loss_err = {k: abs(losses[k] - ref_losses[k]) / abs(ref_losses[k]) for k in ref_losses}
    grad_err, no_grad = {}, []
    for k, ref in ref_grads.items():
        if ref is None:
            check(grads[k] is None, f"{k}: a gradient where the plain run has none")
            no_grad.append(k)
            continue
        grad_err[k] = rel_l2(grads[k], ref)
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:5]
    rec = {"phase": "train_check", "dtype": dname, "batch": 2, "losses": losses,
           "loss_rel_err_vs_plain": loss_err, "loss_rtol": loss_rtol,
           "grad_rel_l2_max": worst[0][1], "grad_rel_l2_worst": worst,
           "grad_rel_l2_median": statistics.median(grad_err.values()),
           "n_grads": len(grad_err), "n_inert_biases": len(no_grad), "launches": launches}
    if mixed_precision:
        # Each bf16 run's distance from the fp32 gradient, per tensor.
        kernel = {k: rel_l2(grads[k], fp32_grads[k]) for k in grad_err}
        plain = {k: rel_l2(ref_grads[k], fp32_grads[k]) for k in grad_err}
        ratio = statistics.median(kernel[k] / plain[k] for k in grad_err)
        rec.update(grad_vs_fp32_kernel_max=max(kernel.values()),
                   grad_vs_fp32_plain_max=max(plain.values()),
                   grad_vs_fp32_kernel_median=statistics.median(kernel.values()),
                   grad_vs_fp32_plain_median=statistics.median(plain.values()),
                   grad_vs_fp32_median_ratio=ratio, grad_ratio_tol=TRAIN_BF16_GRAD_RATIO)
    else:
        def worst_of(a, b):
            return max(rel_l2(a[k], b[k]) for k in grad_err)
        rec.update(grad_tol=TRAIN_FP32_GRAD_MAX,
                   grad_rel_l2_kernel_repeat_max=worst_of(repeat, grads),
                   grad_rel_l2_backward_vs_autograd_max=worst_of(plain_fwd, ref_grads),
                   grad_rel_l2_kernel_stats_max=worst_of(kernel_stats, plain_fwd),
                   grad_rel_l2_one_ulp_output_noise_max=worst_of(one_ulp, plain_fwd))
    emit(rec)
    check(sorted(losses) == sorted(ref_losses), rec)
    check(all(math.isfinite(v) for v in losses.values()), rec)
    check(launches == TRAIN_LAUNCHES and sum(ref_launches.values()) == 0, rec)
    check(max(loss_err.values()) <= loss_rtol, rec)
    if mixed_precision:
        check(rec["grad_vs_fp32_median_ratio"] <= TRAIN_BF16_GRAD_RATIO, rec)
        check(rec["grad_vs_fp32_kernel_max"]
              <= TRAIN_BF16_GRAD_RATIO * rec["grad_vs_fp32_plain_max"], rec)
    else:
        check(worst[0][1] <= TRAIN_FP32_GRAD_MAX, rec)
    # Inert biases: 23 in each G (initial, down0, down1, 18 residual convs,
    # up0, up1), 3 in each D (down1, down2, penultimate).
    check(len(no_grad) == 2 * 23 + 2 * 3, f"inert biases without a gradient: {no_grad}")
    return ref_grads


def check_norm_backward():
    """Each norm's gradient alone at the train step's slabs: the kernel's
    statistics through `InstanceNormFunction` against autograd through the
    plain version, elementwise (`NORM_BACKWARD_TOL`), kinks left out."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    for shape, act in NORM_BACKWARD_SLABS:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1.5).to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
            inorm.instance_norm(xk, 1e-5, act, 0.2).backward(g)
            out, mean, rstd = inorm.instance_norm_reference(xp, 1e-5, act, 0.2)
            out.backward(g)
            with torch.no_grad():
                stat = (shape[0],) + (1,) * (len(shape) - 2) + (shape[-1],)
                y = (x.float() - mean.reshape(stat)) * rstd.reshape(stat)
                keep = y.abs() >= 1e-3 if act != "none" else torch.ones_like(y, dtype=torch.bool)
                want, got = xp.grad.float(), xk.grad.float()
                dname = str(dtype).split(".")[1]
                tol = NORM_BACKWARD_TOL[dname]
                scale = float(want.abs().max())
                err = (got - want).abs()
                limit = tol["atol"] * scale + tol["rtol"] * want.abs()
                ok = bool((err <= limit)[keep].all()) and float(keep.float().mean()) >= 0.99
            rec = {"phase": "norm_backward", "shape": list(shape), "dtype": dname,
                   "activation": act, "max_abs_err": float(err[keep].max()),
                   "dx_scale": scale, "kept": float(keep.float().mean()), "tol": tol,
                   "grad_dtype": str(xk.grad.dtype), "ok": ok}
            emit(rec)
            check(ok and xk.grad.dtype == dtype, rec)
            del x, g, xk, xp, out, y, keep, want, got, err, limit


class Labelled:
    """Calls `obj` inside a `torch.profiler.record_function(label)` range and
    passes attribute reads through: marks the losses, metrics and pools of a
    profiled step."""

    def __init__(self, obj, label):
        self._obj, self._label = obj, label

    def __call__(self, *args, **kwargs):
        from torch.profiler import record_function
        with record_function(self._label):
            return self._obj(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._obj, name)


def label_step(model):
    """Mark the loss, metric and pool calls of `model`'s train step."""
    for name in ("criterion_adv", "criterion_G", "criterion_pix2pix"):
        if hasattr(model, name):
            setattr(model, name, Labelled(getattr(model, name), "losses"))
    tm = model.training_metrics
    tm.compute_metrics_G = Labelled(tm.compute_metrics_G, "metrics")
    tm.compute_metrics_D = Labelled(tm.compute_metrics_D, "metrics")
    for pool in model.pools.values():
        pool.query = Labelled(pool.query, "pool")


def family(chain, kernel):
    """The family of a device kernel, from its name and the names of the
    host ranges and ops that launched it (`chain`, innermost first)."""
    low = kernel.lower()
    if "inorm" in low:
        return "norm_kernels"
    for name in chain:
        if name.startswith("Optimizer."):
            return "adam"
        if name in ("losses", "metrics", "pool"):
            return name
        if name.startswith("autograd::engine::evaluate_function: "):
            node = name.split(": ", 1)[1]
            if node.startswith("ConvolutionBackward"):
                if "wgrad" in low:
                    return "conv_wgrad"
                if any(k in low for k in ("dgrad", "fprop", "implicit_convolve")):
                    return "conv_dgrad"
                return "conv_backward_other"
            if node.startswith("InstanceNormFunctionBackward"):
                return "norm_backward_plain"
            if node.startswith("IndexSelectBackward"):
                return "pad_backward"
            if node.startswith("ToCopyBackward"):
                return "cast_backward"
            return "backward_other"
    ops = [n for n in chain if n.startswith("aten::")]
    if any(n in ("aten::convolution", "aten::_convolution") for n in ops):
        return "bias_add" if ops[0] in ("aten::add", "aten::add_") else "conv_forward"
    if "aten::index_select" in ops:
        return "pad_gather"
    if "aten::to" in ops or "aten::_to_copy" in ops:
        return "cast"
    return "forward_other"


def classify(events):
    """Device time (ms) by family, and the largest kernels and backward
    nodes of each family, from a profile's events."""
    fams, top = {}, {}
    for ev in events:
        if not getattr(ev, "kernels", None):
            continue
        chain, parent = [], ev
        while parent is not None:
            chain.append(parent.name)
            parent = parent.cpu_parent
        for k in ev.kernels:
            fam = family(chain, k.name)
            fams[fam] = fams.get(fam, 0.0) + k.duration / 1e3
            node = next((n.split(": ", 1)[1] for n in chain
                         if n.startswith("autograd::engine::evaluate_function: ")), chain[0])
            key = (fam, node, k.name[:70])
            top[key] = top.get(key, 0.0) + k.duration / 1e3
    best = sorted(top.items(), key=lambda kv: -kv[1])
    return fams, [[f, n, k, ms] for (f, n, k), ms in best[:25]]


def profile_train_step(model, batch):
    """Device time of one train step by family, and the device's idle share
    (the profiler's own host overhead included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    label_step(model)
    model.set_input(batch)
    model.optimize_parameters()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.optimize_parameters()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    busy = sum(ev.device_time_total for ev in events
               if "CUDA" in str(getattr(ev, "device_type", ""))) / 1e3
    fams, top = classify(events)
    linked = sum(fams.values())
    rec = {"phase": "train_profile", "batch": batch["A"].shape[0], "wall_ms": wall_ms,
           "device_busy_ms": busy if busy else "not measured",
           "device_idle_share": (1 - busy / wall_ms) if busy else "not measured",
           "device_ms_by_family": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
           "device_ms_unattributed": busy - linked if busy else "not measured",
           "top": top}
    emit(rec)
    check(busy > 0 and fams.get("norm_kernels", 0) > 0, "the profile saw no norm kernel")


def time_train(out_dir, batch_size, totals):
    """Timed train steps at `batch_size` (bf16, pool 50, metrics on): CUDA
    events around each step, peak memory, finite losses and the norm
    launches of every step (added to `totals`). Returns the model and a
    device batch."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    rng = np.random.default_rng(SEED + 7 + batch_size)
    conf = train_conf(out_dir, batch_size, True)
    host = [train_batch(rng, batch_size) for _ in range(2)]
    model = build_trainer(conf, host[0])
    device = [{k: torch.from_numpy(v).to(model.device) for k, v in b.items()} for b in host]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, launches, losses = [], [], []
    t0 = time.perf_counter()
    for i in range(TRAIN_WARM_STEPS + TRAIN_TIMED_STEPS):
        if i == TRAIN_WARM_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        model.set_input(device[i % 2])          # on the device already: no copy
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        inorm.reset_launches()
        start.record()
        model.optimize_parameters()
        end.record()
        launches.append(dict(inorm.LAUNCHES))
        losses.append(model.losses)
        steps.append((start, end))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED_STEPS
    step_ms = [s.elapsed_time(e) for s, e in steps[TRAIN_WARM_STEPS:]]
    finite = all(math.isfinite(float(v)) for step in losses for v in step.values())
    lrs, last_losses, visuals, metrics = model.get_loggable_data()
    rec = {"phase": "train_steps", "batch": batch_size, "dtype": "bfloat16", "pool_size": 50,
           "step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
           "images_per_s": batch_size / statistics.median(step_ms) * 1e3,
           "host_wall_ms_per_step": wall_ms,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches_per_step": launches[-1], "losses": {k: float(v) for k, v in
                                                         last_losses.items()},
           "metrics": {k: float(v) for k, v in metrics.items()}, "lrs": lrs,
           "visuals": {k: [list(v.shape), str(v.dtype)] for k, v in visuals.items()}}
    emit(rec)
    check(finite, f"a train step gave a non-finite loss: {rec}")
    check(all(step == TRAIN_LAUNCHES for step in launches), f"launches per step: {launches}")
    # The loggable visuals stay on the device in the step's dtypes (bf16
    # fakes); the training tracker reads them to the host as fp32.
    from ganslate_tpu_torch.utils.trackers.utils import to_numpy
    check(all(v.device.type == "cuda" and tuple(v.shape) == (batch_size, SIZE, SIZE, 3)
              and v.dtype in (torch.float32, torch.bfloat16)
              and to_numpy(v[:1]).dtype == np.float32 for v in visuals.values()), rec)
    for step in launches:
        for name, count in step.items():
            totals[name] += count
    return model, device[0]


def serve_trained(out_dir, model, iter_idx):
    """`save_checkpoint`, then a deployment `Inferer` on that checkpoint
    serves one batch-1 request; it must agree with `model.infer`."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    from ganslate_tpu_torch.engines.inferer import Inferer

    model.save_checkpoint(iter_idx)
    raw = model.conf.to_container(resolve=False)
    raw["infer"] = {"is_deployment": True, "wire_dtype": "bfloat16",
                    "checkpointing": {"load_iter": iter_idx}}
    inferer = Inferer(init_config(Conf.create(raw), Config))
    x = np.random.default_rng(SEED + 9).uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    y = inferer.infer(x)
    want = model.infer(torch.from_numpy(x)).cpu()
    err = float((y.float() - want).abs().max())
    rec = {"phase": "train_serve", "iter": iter_idx, "shape": list(y.shape),
           "dtype": str(y.dtype), "max_abs_err_vs_model_infer": err, "tol": SLICE_BF16_MAX}
    emit(rec)
    check(tuple(y.shape) == (1, SIZE, SIZE, 3) and bool(torch.isfinite(y.float()).all()), rec)
    check(err <= SLICE_BF16_MAX, rec)


def train_phase(out_dir):
    """Phase 6; returns the norm launches of the timed steps."""
    import torch
    check_norm_backward()
    fp32_grads = check_train_step(out_dir, mixed_precision=False)
    torch.cuda.empty_cache()
    check_train_step(out_dir, mixed_precision=True, fp32_grads=fp32_grads)
    del fp32_grads
    torch.cuda.empty_cache()
    totals = {"onepass": 0, "split": 0}
    for batch_size in TRAIN_BATCHES:
        model, batch = time_train(out_dir, batch_size, totals)
        if batch_size == TRAIN_BATCHES[-1]:
            serve_trained(out_dir, model, TRAIN_WARM_STEPS + TRAIN_TIMED_STEPS)
        profile_train_step(model, batch)
        del model, batch
        torch.cuda.empty_cache()
    return totals


# ------------------------------------------------------------- phase 6b


# The trainer phase: `projects/horse2zebra/experiments/default.yaml` field for
# field, built in Python, through the port's engines. Only the loop lengths
# and frequencies are cut (printed as `cuts`); `logging.wandb` is left out,
# because the wandb package would contact its server. Validation: the
# paired test folder, cycle metrics on, FID off (no Inception weights here).
TRAINER_IMAGES = 32             # per training domain (>= batch 16)
TRAINER_TEST_IMAGES = 4         # paired, for validation, testing, inference
TRAINER_RUNS = {
    # batch: (warm-up iterations, timed iterations, profiled iterations,
    #         logging.freq, checkpointing.freq, val.freq)
    1: (5, 40, 5, 10, 20, 25),
    16: (3, 20, 5, 5, 10, 10),
}
TRAINER_YAML_LENGTHS = {"n_iters": 117700, "n_iters_decay": 117700, "logging.freq": 500,
                        "checkpointing.freq": 20000, "val.freq": 20000}
TRAINER_LEFT_OUT = {"train.logging.wandb": "the wandb package would contact its server",
                    "val.metrics.fid": "no Inception weights in the repo"}
# Norm launches of one G forward (validation and inference): 19 one-pass,
# 4 split.
G_LAUNCHES = {"onepass": 19, "split": 4}
# The host ranges of a profiled trainer iteration (`trainer_ranges`).
TRAINER_RANGES = ("loader_wait", "set_input", "step", "tracker", "checkpoint", "validation")


def trainer_dataset(kind):
    """The dataset node: the port's image folders where Pillow is installed,
    else this script's `SyntheticUnpairedDataset` / `SyntheticPairedDataset`
    over the same arrays."""
    if kind == "image_folder":
        return {"unpaired": "ganslate.data.UnpairedImageDataset",
                "paired": "ganslate.data.PairedImageDataset"}
    return {"unpaired": "chip_smoke.SyntheticUnpairedDataset",
            "paired": "chip_smoke.SyntheticPairedDataset"}


def trainer_images(seed, n, size):
    """`n` smooth RGB images (uint8, (size, size, 3)) from `seed`: a random
    low-resolution field, upsampled, plus noise (PNGs of plain noise do not
    compress, unlike photographs)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    low = rng.uniform(0, 255, (n, size // 16, size // 16, 3))
    img = np.repeat(np.repeat(low, 16, axis=1), 16, axis=2) + rng.normal(0, 8, (n, size, size, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def write_trainer_data(root, kind, splits=("train", "test")):
    """`train/{A,B}` and `test/{A,B}` (of `splits`) of SIZE x SIZE images
    under `root`, from the seed: PNGs written by the port's own writer
    (image folders), or `.npy` stacks (the synthetic datasets)."""
    import numpy as np
    from ganslate_tpu_torch.utils.trackers.utils import save_image
    for split, n, seed in (("train", TRAINER_IMAGES, SEED + 20), ("test", TRAINER_TEST_IMAGES,
                                                                  SEED + 30)):
        if split not in splits:
            continue
        for d, domain in enumerate("AB"):
            folder = root / split / domain
            folder.mkdir(parents=True)
            images = trainer_images(seed + d, n, SIZE)
            if kind == "image_folder":
                for i, img in enumerate(images):
                    save_image(img / 255.0, folder / f"{i:04d}.png")
            else:
                np.save(folder / "images.npy", images)


def __getattr__(name):
    """`SyntheticUnpairedDatasetConfig` and `SyntheticPairedDatasetConfig`,
    the schemas that the config loader reads for `_target_:
    chip_smoke.Synthetic*Dataset`; made on request, because they need the
    port, which this file does not import at module level."""
    from dataclasses import dataclass, field
    from typing import Tuple
    if name not in ("SyntheticUnpairedDatasetConfig", "SyntheticPairedDatasetConfig"):
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from ganslate_tpu_torch import configs

    @dataclass
    class SyntheticDatasetConfig(configs.base.BaseDatasetConfig):
        image_channels: int = 3
        preprocess: Tuple[str] = ("resize", "random_flip")
        load_size: Tuple[int, int] = field(default_factory=lambda: [SIZE, SIZE])
        final_size: Tuple[int, int] = field(default_factory=lambda: [SIZE, SIZE])
    return SyntheticDatasetConfig


class SyntheticUnpairedDataset:
    """The `{A, B}` samples of `UnpairedImageDataset` without Pillow: the
    same seeded images as float32 (H, W, 3) in [-1, 1], B drawn and each
    image flipped with the loader's per-sample `rng` (`random_flip`, train
    mode only)."""
    paired = False

    def __init__(self, conf):
        import numpy as np
        from pathlib import Path
        dataset_conf = conf[conf.mode].dataset
        root = Path(dataset_conf.root)
        self.flip = conf.mode == "train" and "random_flip" in dataset_conf.preprocess
        self.images = {d: np.load(root / d / "images.npy") for d in "AB"}

    def __len__(self):
        return max(len(v) for v in self.images.values())

    def _array(self, img, flip):
        import numpy as np
        arr = (img.astype(np.float32) / 255.0 - 0.5) / 0.5
        return np.ascontiguousarray(arr[:, ::-1]) if flip else arr

    def __getitem__(self, index, rng=None):
        a = self.images["A"][index % len(self.images["A"])]
        if self.paired:
            b = self.images["B"][index % len(self.images["B"])]
            flips = [self.flip and bool(rng.integers(0, 2))] * 2
        else:
            b = self.images["B"][int(rng.integers(0, len(self.images["B"])))]
            flips = [self.flip and bool(rng.integers(0, 2)) for _ in range(2)]
        return {"A": self._array(a, flips[0]), "B": self._array(b, flips[1])}


class SyntheticPairedDataset(SyntheticUnpairedDataset):
    """The `{A, B}` pairs of `PairedImageDataset` without Pillow."""
    paired = True


def trainer_raw(out_dir, data_root, kind, batch, load_iter=None):
    """The horse2zebra experiment as a raw config tree, at `batch`, with the
    run's cut loop lengths and frequencies."""
    warm, timed, profiled, log_freq, ckpt_freq, val_freq = TRAINER_RUNS[batch]
    n_iters = warm + timed + profiled
    targets = trainer_dataset(kind)

    def dataset(split, target, preprocess):
        return {"_target_": target, "root": str(data_root / split), "num_workers": 16,
                "image_channels": 3, "preprocess": preprocess, "load_size": [SIZE, SIZE],
                "final_size": [SIZE, SIZE]}

    return {
        "train": {
            "output_dir": str(out_dir), "cuda": True,
            "n_iters": n_iters - n_iters // 2, "n_iters_decay": n_iters // 2,
            "batch_size": batch, "mixed_precision": True, "seed": SEED + 1,
            "logging": {"freq": log_freq,
                        # Profiles the last `profiled` iterations.
                        "profiler": {"start_iter": warm + timed, "end_iter": n_iters,
                                     "output_dir": str(out_dir / "profile")}},
            "checkpointing": {"freq": ckpt_freq, "load_iter": load_iter},
            "dataset": dataset("train", targets["unpaired"], ["resize", "random_flip"]),
            "gan": {
                "_target_": "ganslate.nn.gans.unpaired.CycleGAN",
                "generator": {"_target_": "ganslate.nn.generators.Resnet2D",
                              "n_residual_blocks": 9, "in_out_channels": {"AB": [3, 3]}},
                "discriminator": {"_target_": "ganslate.nn.discriminators.PatchGAN2D",
                                  "n_layers": 3, "in_channels": {"B": 3}},
                "optimizer": {"lambda_AB": 10.0, "lambda_BA": 10.0, "lambda_identity": 0,
                              "proportion_ssim": 0, "lr_D": 0.0002, "lr_G": 0.0002},
            },
            "metrics": {"discriminator_evolution": True, "ssim": True},
        },
        "val": {"freq": val_freq,
                "dataset": dataset("test", targets["paired"], ["resize"]),
                "metrics": {"cycle_metrics": True, "fid": False}},
        "test": {"checkpointing": {"load_iter": load_iter},
                 "dataset": dataset("test", targets["paired"], ["resize"])},
        "infer": {"checkpointing": {"load_iter": load_iter}, "is_deployment": False,
                  "dataset": dataset("test", targets["unpaired"], ["resize"])},
    }


def engine(mode, raw, out_dir):
    """The port's engine for `mode`, through `init_engine` from a YAML that
    the port's own `Conf.to_yaml` wrote, where PyYAML (which parses it) is
    installed; else the same engine class from the config built in Python."""
    import importlib.util
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    from ganslate_tpu_torch.engines.utils import init_engine
    conf = init_config(Conf.create(raw), Config)
    if importlib.util.find_spec("yaml"):
        path = out_dir / f"{mode}_{time.perf_counter_ns()}.yaml"
        path.write_text(conf.to_yaml())
        return init_engine(mode, [f"config={path}"]), "init_engine"
    from ganslate_tpu_torch.engines.inferer import Inferer
    from ganslate_tpu_torch.engines.trainer import Trainer
    from ganslate_tpu_torch.engines.validator_tester import Tester
    return {"train": Trainer, "test": Tester, "infer": Inferer}[mode](conf), "engine_class"


class Ranged:
    """Calls `fn` inside a `torch.profiler.record_function(label)` range,
    and hands its host time in seconds to `add(label, seconds)`."""

    def __init__(self, fn, label, add):
        self.fn, self.label, self.add = fn, label, add

    def __call__(self, *args, **kwargs):
        from torch.profiler import record_function
        t0 = time.perf_counter()
        with record_function(self.label):
            out = self.fn(*args, **kwargs)
        self.add(self.label, time.perf_counter() - t0)
        return out


def instrument_trainer(trainer):
    """Per-iteration records of a Trainer's run: the iteration's start, the
    tracker's t_data and t_comp, its kind (log, checkpoint, validation), the
    host time of its ranges (`TRAINER_RANGES`; the loader wait that precedes
    it counts to it), and the losses of log iterations. The ranges are also
    named ranges of the profiler's trace."""
    records = {}
    current = {"ranges": {}}
    conf = trainer.conf

    def add(label, seconds):
        ranges = current["ranges"]
        ranges[label] = ranges.get(label, 0.0) + seconds

    def batches(it):
        wait = Ranged(lambda: next(it), "loader_wait", add)
        while True:
            try:
                yield wait()
            except StopIteration:
                return

    trainer._data_iter = batches(trainer._data_iter)
    set_iter_idx = trainer._set_iter_idx

    def start(i):
        set_iter_idx(i)
        wait = current["ranges"].pop("loader_wait", None)
        records[i] = {"t0": time.perf_counter(), "ranges": {}}
        if wait is not None:
            records[i]["ranges"]["loader_wait"] = wait
        current["ranges"] = records[i]["ranges"]

    trainer._set_iter_idx = start
    trainer.model.set_input = Ranged(trainer.model.set_input, "set_input", add)
    trainer.model.set_input_multi = Ranged(trainer.model.set_input_multi, "set_input", add)
    trainer.model.optimize_parameters = Ranged(trainer.model.optimize_parameters, "step",
                                               add)
    log_iter = Ranged(trainer.tracker.log_iter, "tracker", add)

    def log(lrs, losses, visuals, metrics):
        i = trainer.iter_idx
        rec = records[i]
        rec["log"] = i % conf.train.logging.freq == 0
        rec["checkpoint"] = i % conf.train.checkpointing.freq == 0
        rec["validation"] = i % conf.val.freq == 0
        rec["plain"] = not (rec["log"] or rec["checkpoint"] or rec["validation"])
        if rec["log"]:
            rec["losses"] = {k: float(v) for k, v in losses.items()}
        log_iter(lrs, losses, visuals, metrics)
        rec["t_data"], rec["t_comp"] = trainer.tracker.t_data, trainer.tracker.t_comp

    trainer.tracker.log_iter = log
    trainer._save_checkpoint = Ranged(trainer._save_checkpoint, "checkpoint", add)
    trainer._run_validation = Ranged(trainer._run_validation, "validation", add)
    return records


def read_trace(out_dir):
    """Device busy time, the window and the host ranges (ms) of the Chrome
    trace that the Trainer's `logging.profiler` wrote to `out_dir`."""
    traces = sorted(out_dir.glob("*.pt.trace.json"))
    check(len(traces) == 1, f"the Trainer's profiler wrote {len(traces)} traces to {out_dir}")
    events = [e for e in json.loads(traces[0].read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -math.inf
    for t0, t1 in device:                   # union of the device intervals
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    host = [e for e in events if e.get("cat") == "user_annotation"]
    by_range = {}
    for e in host:
        if e["name"] in TRAINER_RANGES:
            by_range[e["name"]] = by_range.get(e["name"], 0.0) + e["dur"] / 1e3
    steps = [e for e in host if e["name"] == "step"]
    starts = [e["ts"] for e in host if e["name"] in TRAINER_RANGES]
    window = (max([t1 for _, t1 in device] + [e["ts"] + e["dur"] for e in host])
              - min(starts)) if starts else 0.0
    return {"trace": traces[0].name, "trace_bytes": traces[0].stat().st_size,
            "window_ms": window / 1e3, "steps": len(steps),
            "device_busy_ms": busy / 1e3 if device else "not measured",
            "device_idle_share": 1 - busy / window if device and window else "not measured",
            "host_ms_by_range": by_range,
            "kernels": sum(1 for e in events if e.get("cat") == "kernel")}


def _ms_stats(values):
    values = sorted(values)
    return {"mean": statistics.fmean(values) * 1e3,
            "p90": values[min(len(values) - 1, int(0.9 * len(values)))] * 1e3}


def train_from_config(root, data_root, kind, batch):
    """One Trainer run at `batch`, from `init_engine("train")` to `run()`'s
    end; returns its norm launches, its last checkpoint's iteration and its
    output directory."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    warm, timed, profiled, log_freq, ckpt_freq, val_freq = TRAINER_RUNS[batch]
    n_iters = warm + timed + profiled
    out_dir = root / f"batch{batch}"
    t_build = time.perf_counter()
    raw = trainer_raw(out_dir, data_root, kind, batch)
    trainer, entry = engine("train", raw, root)
    build_s = time.perf_counter() - t_build
    records = instrument_trainer(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    inorm.reset_launches()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = dict(inorm.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    check(sorted(records) == list(range(1, n_iters + 1)), f"iterations run: {sorted(records)}")
    starts = [records[i]["t0"] for i in range(1, n_iters + 1)] + [t_end]
    for i in range(1, n_iters + 1):
        records[i]["ms"] = (starts[i] - starts[i - 1]) * 1e3
    timed_iters = range(warm + 1, warm + timed + 1)
    span_s = starts[warm + timed] - starts[warm]
    plain_iters = [i for i in timed_iters if records[i]["plain"]]
    plain = [records[i]["ms"] for i in plain_iters]
    logged = [records[i] for i in range(1, n_iters + 1) if records[i]["log"]]
    finite = all(math.isfinite(v) for r in logged for v in r["losses"].values())
    ckpt_dir = out_dir / "checkpoints"
    ckpts = sorted(int(p.stem) for p in ckpt_dir.glob("*.pth"))
    sidecars = sorted(int(p.stem.split("_")[-1]) for p in ckpt_dir.glob("data_state_*.json"))
    # Launches: every train step's, and two G forwards (fake_B, then its
    # cycle) of each validation batch.
    val_runs = n_iters // val_freq
    n_val_batches = -(-TRAINER_TEST_IMAGES // batch)
    want = {k: n_iters * TRAIN_LAUNCHES[k] + val_runs * n_val_batches * 2 * G_LAUNCHES[k]
            for k in TRAIN_LAUNCHES}
    profile = read_trace(out_dir / "profile")
    rec = {"phase": "trainer_run", "batch": batch, "entry": entry, "dataset": kind,
           "cuts": {"from": TRAINER_YAML_LENGTHS, "left_out": TRAINER_LEFT_OUT,
                    "to": {"n_iters": raw["train"]["n_iters"],
                           "n_iters_decay": raw["train"]["n_iters_decay"],
                           "logging.freq": log_freq, "checkpointing.freq": ckpt_freq,
                           "val.freq": val_freq}},
           "build_s": build_s, "run_s": t_end - t0,
           "iterations": n_iters, "timed_iterations": [timed_iters.start, timed_iters.stop - 1],
           "timed_wall_s": span_s, "images_per_s": timed * batch / span_s,
           "t_data_ms": _ms_stats([records[i]["t_data"] for i in timed_iters]),
           "t_comp_ms_per_image": _ms_stats([records[i]["t_comp"] for i in timed_iters]),
           "t_comp_ms_per_image_log_iterations": [records[i]["t_comp"] * 1e3 for i in
                                                  timed_iters if records[i]["log"]],
           "plain_iteration_ms": {"median": statistics.median(plain), "n": len(plain),
                                  **_ms_stats([p / 1e3 for p in plain])},
           "log_iteration_ms": {i: records[i]["ms"] for i in timed_iters if records[i]["log"]},
           "checkpoint_iteration_ms": {i: records[i]["ms"] for i in timed_iters
                                       if records[i]["checkpoint"]},
           "validation_iteration_ms": {i: records[i]["ms"] for i in timed_iters
                                       if records[i]["validation"]},
           "plain_host_ranges_ms": {r: statistics.fmean(records[i]["ranges"].get(r, 0.0)
                                                        for i in plain_iters) * 1e3
                                    for r in TRAINER_RANGES},
           "host_ranges_ms": {i: {r: v * 1e3 for r, v in records[i]["ranges"].items()}
                              for i in timed_iters if not records[i]["plain"]},
           "peak_memory_bytes": peak, "peak_memory_gib": peak / 2 ** 30,
           "losses_at_logs": {i: records[i]["losses"] for i in range(1, n_iters + 1)
                              if records[i]["log"]},
           "checkpoints": ckpts, "data_state_sidecars": sidecars,
           "launches": launches, "launches_expected": want,
           "profile": {"iterations": [warm + timed + 1, n_iters], **profile}}
    emit(rec)
    check(finite and logged, f"a logged loss is not finite: {rec['losses_at_logs']}")
    want_ckpts = [i for i in range(1, n_iters + 1) if i % ckpt_freq == 0]
    check(ckpts == want_ckpts and sidecars == want_ckpts, rec)
    state = json.loads((ckpt_dir / f"data_state_{ckpts[-1]}.json").read_text())
    check(state["position"] == ckpts[-1] * batch and state["world_size"] == 1, state)
    check((out_dir / "train" / "train_config.yaml").is_file(), "no train_config.yaml")
    check(len(list((out_dir / "train" / "images").glob("*.png"))) == n_iters // log_freq,
          "the training tracker's PNGs")
    check(len(list((out_dir / "val" / "images").rglob("*.png"))) == val_runs
          * TRAINER_TEST_IMAGES, "the validator's PNGs")
    check(launches == want, f"norm launches {launches}, expected {want}")
    check(profile["steps"] == profiled, f"the profile holds {profile['steps']} steps")
    # The wrappers above make reference cycles through the engine: collect
    # them, so that its model and optimizers leave the device now and do
    # not count in a later phase's peak memory.
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches, ckpts[-1], out_dir


def serve_from_checkpoint(root, data_root, kind, out_dir, load_iter):
    """`Inferer.run()` and the `Tester` from the batch-1 run's last
    checkpoint; `Inferer.run()` again with the plain norms."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    raw = trainer_raw(out_dir, data_root, kind, 1, load_iter=load_iter)
    launches = {}

    def run_infer():
        inferer, entry = engine("infer", raw, root)
        outputs = []
        save = inferer.save_generated_tensor

        def keep(generated_tensor, **kwargs):
            outputs.append(np.array(generated_tensor))
            return save(generated_tensor=generated_tensor, **kwargs)

        inferer.save_generated_tensor = keep
        t0 = time.perf_counter()
        inferer.run()
        return np.concatenate(outputs), time.perf_counter() - t0, entry

    inorm.reset_launches()
    out, infer_s, entry = run_infer()
    launches["infer"] = dict(inorm.LAUNCHES)
    with plain_norms():
        inorm.reset_launches()
        ref, _, _ = run_infer()
        check(sum(inorm.LAUNCHES.values()) == 0, "the plain run launched a kernel")
    err = np.abs(out - ref)
    rec = {"phase": "trainer_infer", "entry": entry, "load_iter": load_iter,
           "shape": list(out.shape), "dtype": str(out.dtype), "run_s": infer_s,
           "out_min": float(out.min()), "out_max": float(out.max()),
           "max_abs_err_vs_plain": float(err.max()), "mean_abs_err_vs_plain": float(err.mean()),
           "tol": {"max": SLICE_BF16_MAX, "mean": SLICE_BF16_MEAN},
           "launches": launches["infer"]}
    emit(rec)
    check(out.shape == (TRAINER_TEST_IMAGES, SIZE, SIZE, 3) and out.dtype == np.float32, rec)
    check(bool(np.isfinite(out).all()) and -1 <= rec["out_min"] <= rec["out_max"] <= 1, rec)
    check(rec["max_abs_err_vs_plain"] <= SLICE_BF16_MAX, rec)
    check(rec["mean_abs_err_vs_plain"] <= SLICE_BF16_MEAN, rec)
    check(launches["infer"] == {k: TRAINER_TEST_IMAGES * v for k, v in G_LAUNCHES.items()},
          rec)

    inorm.reset_launches()
    tester, entry = engine("test", raw, root)
    metrics = {}
    log_samples = tester.tracker.log_samples

    def keep_metrics(*args, **kwargs):
        for m in tester.tracker.metrics:
            for name, values in m.items():
                metrics.setdefault(name, []).extend(values)
        return log_samples(*args, **kwargs)

    tester.tracker.log_samples = keep_metrics
    tester.run()
    launches["test"] = dict(inorm.LAUNCHES)
    csv_rows = (out_dir / "test" / "metrics.csv").read_text().splitlines()
    rec = {"phase": "trainer_test", "entry": entry, "load_iter": load_iter,
           "metrics_mean": {k: statistics.fmean(v) for k, v in metrics.items()},
           "csv_rows": len(csv_rows) - 1, "launches": launches["test"]}
    emit(rec)
    check(all(len(v) == TRAINER_TEST_IMAGES and all(math.isfinite(x) for x in v)
              for v in metrics.values()) and metrics, rec)
    check(rec["csv_rows"] == TRAINER_TEST_IMAGES, rec)
    del tester
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def trainer_phase(root):
    """Phase 6b; returns the norm launches of its runs."""
    import importlib.util
    import torch
    t0 = time.perf_counter()
    allocated = torch.cuda.memory_allocated()
    kind = "image_folder" if importlib.util.find_spec("PIL") else "synthetic_no_pillow"
    data_root = root / "data"
    write_trainer_data(data_root, kind)
    emit({"phase": "trainer_data", "dataset": kind, "seconds": time.perf_counter() - t0,
          "train_images_per_domain": TRAINER_IMAGES, "test_pairs": TRAINER_TEST_IMAGES})
    totals = {"onepass": 0, "split": 0}
    last = None
    for batch in TRAINER_RUNS:
        launches, load_iter, out_dir = train_from_config(root, data_root, kind, batch)
        for k, v in launches.items():
            totals[k] += v
        if last is None:
            last = (out_dir, load_iter)
    for launches in serve_from_checkpoint(root, data_root, kind, *last).values():
        for k, v in launches.items():
            totals[k] += v
    left = torch.cuda.memory_allocated() - allocated
    emit({"phase": "trainer_summary", "seconds": time.perf_counter() - t0,
          "launches_total": totals, "device_bytes_left_allocated": left})
    check(left < 2 ** 28, f"the trainer phase left {left} bytes allocated on the device")
    return totals


# ------------------------------------------------------------- phase 7


def conv_flops(net, x, **kwargs):
    """FLOPs of the convolutions and transposed convolutions of one forward
    of `net` on `x` (N, C, *spatial), `kwargs` to its forward: 2 x (output
    elements x input channels x kernel volume), and for a transposed conv 2
    x (input elements x output channels x kernel volume)."""
    import torch
    from ganslate_tpu_torch.nn.layers import Conv, ConvTranspose
    counts = {"conv": 0, "conv_transpose": 0}

    def hook(module, inputs, output):
        k = math.prod(module.weight.shape[2:])
        if isinstance(module, ConvTranspose):
            counts["conv_transpose"] += 2 * inputs[0].numel() * module.weight.shape[1] * k
        else:
            counts["conv"] += 2 * output.numel() * module.weight.shape[1] * k

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (Conv, ConvTranspose))]
    try:
        with torch.inference_mode():
            net(x, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return counts


def sw_family(chain, kernel):
    """The family of a device kernel of a served sliding-window request,
    from its name and the host ranges and ops that launched it (`chain`,
    innermost first; the network's calls run inside a `network` range)."""
    if "inorm" in kernel.lower():
        return "norm_kernels"
    if kernel.startswith("Memcpy"):
        return "transfers"
    ops = [n for n in chain if n.startswith("aten::")]
    inner = ops[0] if ops else ""
    if "network" not in chain:
        if "aten::stack" in ops:
            return "window_slicing"
        if inner in ("aten::to", "aten::_to_copy", "aten::copy_") and "aten::div" not in ops:
            return "casts"
        return "blend"
    if inner in ("aten::copy_", "aten::clone", "aten::contiguous") \
            and not ({"aten::to", "aten::_to_copy"} & set(ops)):
        return "copies"
    if "aten::cudnn_convolution_transpose" in ops or "aten::conv_transpose3d" in ops:
        return "bias_add" if inner in ("aten::add", "aten::add_") else "conv_transpose"
    if "aten::convolution" in ops or "aten::_convolution" in ops:
        return "bias_add" if inner in ("aten::add", "aten::add_") else "conv_forward"
    if "aten::prelu" in ops or "aten::_prelu_kernel" in ops:
        return "prelu"
    if "aten::cat" in ops:
        return "concat"
    if "aten::to" in ops or "aten::_to_copy" in ops:
        return "casts"
    if inner in ("aten::add", "aten::sub", "aten::add_"):
        return "residual_adds"
    return "network_other"


def profile_request(inferer, x):
    """Device time of one request by family, the largest kernels, and the
    device's idle share (the profiler's host overhead included).

    The device's busy time is the sum of its kernels and copies, without
    the `network` range's own device span. The norm kernels are launched
    from ctypes, outside any PyTorch op, so the profiler links them to no
    host event: they are read from the device events by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    model = inferer.model
    model.infer = Labelled(model.infer, "network")
    try:
        inferer.infer(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            inferer.infer(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del model.infer
    events = prof.events()
    device = [ev for ev in events if "CUDA" in str(getattr(ev, "device_type", ""))
              and not getattr(ev, "is_user_annotation", False) and ev.name != "network"]
    busy = sum(ev.device_time_total for ev in device) / 1e3
    norms = [ev for ev in device if "inorm" in ev.name]
    fams = {"norm_kernels": sum(ev.device_time_total for ev in norms) / 1e3}
    top = {("norm_kernels", "ctypes", ev.name[:80]): 0.0 for ev in norms}
    for ev in norms:
        top[("norm_kernels", "ctypes", ev.name[:80])] += ev.device_time_total / 1e3
    for ev in events:
        if not getattr(ev, "kernels", None):
            continue
        chain, parent = [], ev
        while parent is not None:
            chain.append(parent.name)
            parent = parent.cpu_parent
        for k in ev.kernels:
            fam = sw_family(chain, k.name)
            if fam == "norm_kernels":
                continue            # counted from the device events above
            fams[fam] = fams.get(fam, 0.0) + k.duration / 1e3
            key = (fam, chain[0], k.name[:80])
            top[key] = top.get(key, 0.0) + k.duration / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy if busy else "not measured",
            "norm_kernel_launches_seen": len(norms),
            "device_idle_share": (1 - busy / wall_ms) if busy else "not measured",
            "device_ms_by_family": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
            "device_ms_unattributed": busy - sum(fams.values()) if busy else "not measured",
            "top": [[f, op, k, ms] for (f, op, k), ms in
                    sorted(top.items(), key=lambda kv: -kv[1])[:25]]}


def conv_probe(bf16_peak):
    """The V-Net's costliest conv alone (k5, 16 -> 16 channels, padding 2, on
    a level-0 window batch (28, 16, 32, 176, 176), bf16): device time and
    TFLOP/s in channels_last_3d and in NCDHW, with cuDNN's heuristics and
    with its autotuner."""
    import torch
    import torch.nn.functional as F
    shape, k = (28, 16, 32, 176, 176), 5
    flop = 2 * math.prod(shape) * shape[1] * k ** 3
    out = {}
    for layout in ("channels_last_3d", "ncdhw"):
        fmt = torch.channels_last_3d if layout != "ncdhw" else torch.contiguous_format
        x = torch.randn(shape, device="cuda", dtype=torch.bfloat16).contiguous(memory_format=fmt)
        w = (torch.randn((16, 16, k, k, k), device="cuda", dtype=torch.bfloat16) * 0.02) \
            .contiguous(memory_format=fmt)
        for benchmark in (False, True):
            torch.backends.cudnn.benchmark = benchmark
            try:
                with torch.inference_mode():
                    ms, _ = time_ms(lambda: F.conv3d(x, w, padding=2), iters=3, reps=3,
                                    spin_cycles=200_000_000)
            finally:
                torch.backends.cudnn.benchmark = False
            name = f"{layout}{'_benchmark' if benchmark else ''}"
            out[name] = {"ms": ms, "tflop_per_s": flop / ms / 1e9,
                         "share_of_bf16_peak": flop / ms * 1e3 / bf16_peak}
        del x, w
    return out


def sw_output_check(rec, y, shape):
    """Adds the output's shape, dtype and range to `rec`; raises unless it
    is a finite host tensor of `shape` in [-1, 1], not constant."""
    import torch
    yf = y.float()
    rec.update(shape=list(y.shape), dtype=str(y.dtype), out_min=float(yf.min()),
               out_max=float(yf.max()), out_std=float(yf.std()))
    check(tuple(y.shape) == tuple(shape) and y.device.type == "cpu", rec)
    check(bool(torch.isfinite(yf).all()) and -1 <= rec["out_min"] <= rec["out_max"] <= 1, rec)
    check(rec["out_std"] > 1e-3, f"degenerate output: {rec}")


def sliding_window_phase(out_dir, bf16_peak):
    """Phase 7; returns the norm launches of its requests."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.engines.inferer import Inferer
    from ganslate_tpu_torch.ops import instance_norm as inorm
    from ganslate_tpu_torch.utils.builders import build_G
    from ganslate_tpu_torch.utils.sliding_window_inferer import _scan_interval, dense_patch_slices
    from ganslate_tpu_torch.utils.testing import make_vnet_conf

    conf = make_vnet_conf(str(out_dir), load_iter=1)
    g = build_G(conf, "AB", torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in g.parameters())
    check(n_params == SW_PARAMS, f"Vnet3D has {n_params} parameters, not {SW_PARAMS}")
    (out_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
    torch.save({"G_AB": g.state_dict()}, out_dir / "checkpoints" / "1.pth")
    del g

    inferer = Inferer(conf)
    model = inferer.model
    rng = np.random.default_rng(SEED + 20)
    totals = {name: 0 for name in inorm.LAUNCHES}
    latencies, peaks = [], []
    x = None
    for i in range(SW_REQUESTS):
        x = rng.uniform(-1, 1, SW_VOLUMES).astype(np.float32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        inorm.reset_launches()
        t0 = time.perf_counter()
        y = inferer.infer(x)            # returns on the host: synchronised
        latency_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(inorm.LAUNCHES)
        peaks.append(torch.cuda.max_memory_allocated())
        rec = {"phase": "sliding_window", "request": i, "cold": i == 0,
               "latency_ms": latency_ms, "launches": launches, "peak_memory_bytes": peaks[-1]}
        sw_output_check(rec, y, SW_VOLUMES)
        if i in SW_PLAIN_CHECKS:
            with plain_norms():
                inorm.reset_launches()
                ref = inferer.infer(x)
                check(sum(inorm.LAUNCHES.values()) == 0, "the plain run launched a kernel")
            err = (y.float() - ref.float()).abs()
            rec.update(max_abs_err_vs_plain=float(err.max()),
                       mean_abs_err_vs_plain=float(err.mean()),
                       tol_max=SW_BF16_MAX, tol_mean=SW_BF16_MEAN)
            del ref, err
        emit(rec)
        check(launches == SW_LAUNCHES, rec)
        if i in SW_PLAIN_CHECKS:
            check(rec["max_abs_err_vs_plain"] <= SW_BF16_MAX, rec)
            check(rec["mean_abs_err_vs_plain"] <= SW_BF16_MEAN, rec)
        if i > 0:
            latencies.append(latency_ms)
        for name, count in launches.items():
            totals[name] += count
        del y

    # One forward of a volume's windows on the device (the request's
    # slicing and blend excluded).
    roi = tuple(conf.infer.sliding_window.window_size)
    spatial = SW_VOLUMES[1:-1]
    starts = dense_patch_slices(spatial, roi, _scan_interval(spatial, roi, 0.25))
    vol = torch.from_numpy(x[0]).to(model.device, torch.bfloat16)
    windows = torch.stack([vol[tuple(slice(s, s + r) for s, r in zip(st, roi))]
                           for st in starts])
    forward_ms, host_bound = time_ms(lambda: model.infer(windows, out_dtype=None), iters=3,
                                     reps=3, spin_cycles=400_000_000)
    net = model._serving_network("G_AB")
    # The same forward with cuDNN's autotuner on (a yardstick: the port
    # leaves `torch.backends.cudnn.benchmark` at its default, off).
    torch.backends.cudnn.benchmark = True
    try:
        tuned_ms, _ = time_ms(lambda: model.infer(windows, out_dtype=None), iters=3, reps=3,
                              spin_cycles=400_000_000)
    finally:
        torch.backends.cudnn.benchmark = False
    probe = conv_probe(bf16_peak)
    flops = conv_flops(net, windows[:1].permute(0, 4, 1, 2, 3))
    flops = {k: v * windows.shape[0] for k, v in flops.items()}
    profile = profile_request(inferer, x)
    fam = profile["device_ms_by_family"]
    achieved = {k: flops[k] / (fam[f] * 1e-3) / 1e12 for k, f in
                (("conv", "conv_forward"), ("conv_transpose", "conv_transpose")) if fam.get(f)}
    stats = {"phase": "sliding_window_summary", "params": n_params, "volumes": list(SW_VOLUMES),
             "windows_per_volume": windows.shape[0], "latency_ms": latencies,
             "median_latency_ms": statistics.median(latencies),
             "vols_per_s": SW_VOLUMES[0] / statistics.median(latencies) * 1e3,
             "forward_device_ms_28_windows": forward_ms, "forward_host_bound": host_bound,
             "forward_device_ms_28_windows_cudnn_benchmark": tuned_ms, "conv_probe": probe,
             "peak_memory_bytes": max(peaks), "peak_memory_gib": max(peaks) / 2 ** 30,
             "conv_tflop_per_forward": {k: v / 1e12 for k, v in flops.items()},
             "conv_tflop_per_s_profiled": achieved,
             "conv_share_of_bf16_peak": {k: v * 1e12 / bf16_peak for k, v in achieved.items()},
             "profile": profile, "launches_total": totals}
    emit(stats)
    check(profile["device_busy_ms"] != "not measured" and fam.get("norm_kernels", 0) > 0,
          "the profile saw no norm kernel")
    del inferer, model, net, vol, windows
    torch.cuda.empty_cache()
    check_fp32_sliding_window(out_dir)
    return totals


def check_fp32_sliding_window(out_dir):
    """The sliding window in float32 (TF32 off) on one smaller volume (8
    windows): kernel norms vs plain norms. Serves the checkpoint that
    `sliding_window_phase` wrote."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.engines.inferer import Inferer
    from ganslate_tpu_torch.utils.testing import make_vnet_conf

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        inferer = Inferer(make_vnet_conf(str(out_dir), load_iter=1, mixed_precision=False,
                                         wire_dtype="float32"))
        x = np.random.default_rng(SEED + 21).uniform(-1, 1, SW_FP32_VOLUME).astype(np.float32)
        y = inferer.infer(x)
        with plain_norms():
            ref = inferer.infer(x)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    err = float((y - ref).abs().max())
    rec = {"phase": "sliding_window_fp32", "volume": list(SW_FP32_VOLUME), "dtype": str(y.dtype),
           "max_abs_err_vs_plain": err, "tol": SW_FP32_MAX}
    sw_output_check(rec, y, SW_FP32_VOLUME)
    emit(rec)
    check(y.dtype == torch.float32 and err <= SW_FP32_MAX, rec)


# ------------------------------------------------------------- phase 8


BRATS_SEQUENCES = {"flair": 0, "t1w": 1, "t1gd": 2, "t2w": 3}


def revgan_launches(memory_saving):
    """Norm launches of one RevGAN train step, all of the split form (every
    slab is over the one-pass limit): 4 Piresnet3D passes of 2 down-path, 4
    per coupling block and 1 up-path norm; in the memory-saving backward, 8
    per block and use of the core (4 rebuild the block's input, 4 rerun
    it); 2 PatchGAN3D passes in the G step and 2 in the D step (real and
    fake in one forward), of one norm per layer."""
    depth = REVGAN_NETS["depth"]
    split = 4 * piresnet_launches()["split"] + 4 * REVGAN_NETS["n_layers_D"]
    return {"onepass": 0, "split": split + (4 * 8 * depth if memory_saving else 0)}


def piresnet_launches():
    """Norm launches of one Piresnet3D pass (serving, validation)."""
    return {"onepass": 0, "split": 2 + 4 * REVGAN_NETS["depth"] + 1}


def brats_volumes(seed, n, shape):
    """`n` BRaTS-shaped scans (`shape`: 4 MRI sequences of (155, 240, 240),
    float32) from `seed`, one at a time: per sequence a smooth random field
    (a coarse normal field, trilinearly upsampled 8x) of positive MR-like
    intensities inside an ellipsoidal head, and a zero background."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    rng = np.random.default_rng(seed)
    c, *spatial = shape
    grid = np.ogrid[tuple(slice(0, d) for d in spatial)]
    head = sum(((g - d / 2) / (0.45 * d)) ** 2 for g, d in zip(grid, spatial)) <= 1
    for _ in range(n):
        coarse = rng.normal(size=(1, c, *(-(-d // 8) for d in spatial))).astype(np.float32)
        field = F.interpolate(torch.from_numpy(coarse), size=tuple(spatial),
                              mode="trilinear", align_corners=False)[0].numpy()
        yield np.maximum(300 + 100 * field, 0) * head


def write_brats_root(root):
    """The BRaTS NIfTI root of this run: `brats_volumes` written by the
    port's `medio.write` as 4-D `.nii.gz` files, REVGAN_VOLUMES training
    scans in `imagesTr/` and one validation scan in `imagesTs/`; each file's
    write timed, and one read back by `medio.load`, which must give the
    same array bit for bit."""
    import numpy as np
    from ganslate_tpu_torch.utils import medio
    t0 = time.perf_counter()
    writes, sizes, generate_s = [], [], 0.0
    first = None
    volumes = brats_volumes(SEED + 40, REVGAN_VOLUMES + 1, REVGAN_VOLUME)
    for i in range(REVGAN_VOLUMES + 1):
        t = time.perf_counter()
        volume = next(volumes)
        generate_s += time.perf_counter() - t
        split = BRATS_SPLITS["train" if i < REVGAN_VOLUMES else "val"]
        path = root / split / f"BRATS_{i:03d}.nii.gz"
        t = time.perf_counter()
        medio.write(medio.MedicalImage(volume), path)
        writes.append(time.perf_counter() - t)
        sizes.append(path.stat().st_size)
        if first is None:
            first = (path, volume)
    t = time.perf_counter()
    back = medio.load(first[0])
    read_s = time.perf_counter() - t
    rec = {"phase": "brats_data", "root": str(root), "splits": BRATS_SPLITS,
           "volumes": [REVGAN_VOLUMES + 1, *REVGAN_VOLUME], "dtype": str(first[1].dtype),
           "generate_s": generate_s, "write_s": writes, "write_s_total": sum(writes),
           "file_bytes": sizes, "raw_bytes": int(first[1].nbytes),
           "read_back_s": read_s, "seconds": time.perf_counter() - t0}
    emit(rec)
    check(back.array.dtype == first[1].dtype and back.array.shape == first[1].shape
          and np.array_equal(back.array, first[1]), "medio.load did not give back the scan")
    _BRATS_ROOT[:] = [root]
    return rec


def brats_root(split):
    """The directory of the NIfTI root's `split` ("train" or "val")."""
    check(bool(_BRATS_ROOT), "the BRaTS NIfTI root is not written yet")
    return _BRATS_ROOT[0] / BRATS_SPLITS[split]


def brats_datasets():
    """The BRaTS project's training and validation datasets over the NIfTI
    root, as a raw config's `dataset` entries."""
    return ({"_target_": BRATS_DATASETS["train"], "root": str(brats_root("train")),
             "num_workers": 8, "patch_size": list(REVGAN_PATCH)},
            {"_target_": BRATS_DATASETS["val"], "root": str(brats_root("val"))})


def host_ms(fn, reps=NATIVE_REPS):
    """Median host time of `fn` in ms over `reps` calls after a warm one."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def host_cpu_record():
    """The host's CPU as `lscpu` names it (vendor, model name, family and
    model number: a virtual machine may name its model "unknown") and its
    core counts."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=60).stdout
    except OSError:
        out = Path("/proc/cpuinfo").read_text()
    fields = {}
    for line in out.splitlines():
        key, _, value = line.partition(":")
        fields.setdefault(key.strip().lower(), value.strip())
    cpu = {k: fields.get(k) for k in ("vendor id", "model name", "cpu family", "model")}
    return {"cpu": cpu, "cpu_count": os.cpu_count(),
            "cpus_usable": len(os.sched_getaffinity(0))}


def native_val_sample(dataset, swap_plain):
    """One BRaTS validation `__getitem__` over the NIfTI root's scan: its
    seconds, the z-scores' ms inside it and the calls that reached the
    native library; with `swap_plain`, each native op is swapped for its
    plain version for the call (here only; the package has no switch)."""
    from ganslate_tpu_torch import native
    from ganslate_tpu_torch.projects.brats_mri_sequence_translation.datasets import (
        val_test_dataset)
    shipped = val_test_dataset.z_score_normalize
    norm_s = []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = shipped(*args, **kwargs)
        norm_s.append(time.perf_counter() - t0)
        return out

    swaps = [(name, getattr(native, name)) for name in native.CALLS]
    val_test_dataset.z_score_normalize = timed
    if swap_plain:
        for name, _ in swaps:
            setattr(native, name, getattr(native, name + "_plain"))
    native.reset_calls()
    try:
        t0 = time.perf_counter()
        sample = dataset[0]
        seconds = time.perf_counter() - t0
    finally:
        val_test_dataset.z_score_normalize = shipped
        for name, fn in swaps:
            setattr(native, name, fn)
    return sample, {"sample_s": seconds, "normalise_ms": sum(norm_s) * 1e3,
                    "normalise_calls": len(norm_s), "native_calls": dict(native.CALLS)}


def native_phase(smi):
    """The host data ops: build the library, hold each op against its plain
    version and time both, then one BRaTS validation sample as shipped and
    with the plain versions swapped in."""
    import numpy as np
    from ganslate_tpu_torch import native
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.ops import build
    from ganslate_tpu_torch.projects.brats_mri_sequence_translation import datasets
    from ganslate_tpu_torch.projects.brats_mri_sequence_translation.datasets.train_dataset \
        import get_mri_sequence
    from ganslate_tpu_torch.utils import sitk_utils
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    lib_path = build.build_host(native.SOURCE)
    native.library()
    build_s = time.perf_counter() - t0
    cxx = build.find_cxx()
    rec = {"phase": "native", "build_s": build_s, "library": str(lib_path),
           "compiler": cxx, "compiler_version": build.compiler_version(cxx),
           "flags": list(build.HOST_FLAGS), **host_cpu_record(), "card": smi}

    conf = Conf.create({"mode": "val", "val": {"dataset": {
        "root": str(brats_root("val")), "source_sequence": "flair",
        "target_sequence": "t1w"}}})
    dataset = datasets.BratsValTestDataset(conf)
    scan = sitk_utils.load(dataset.paths_brats[0])
    volume = np.ascontiguousarray(sitk_utils.get_tensor(get_mri_sequence(scan, "flair")),
                                  dtype=np.float32)
    del scan
    rng = np.random.default_rng(SEED + 50)
    grid = np.ogrid[tuple(slice(0, d) for d in NATIVE_HX4_VOLUME)]
    body = sum(((g - d / 2) / (0.45 * d)) ** 2
               for g, d in zip(grid[1:], NATIVE_HX4_VOLUME[1:])) <= 1
    body = np.broadcast_to(body, NATIVE_HX4_VOLUME)
    ct = np.where(body, rng.normal(40, 300, NATIVE_HX4_VOLUME), -1000).astype(np.float32)
    cases = {
        "clip_minmax_normalize": (volume, *NATIVE_CLIP["brats"]),
        "clip_minmax_normalize_hx4": (ct, *NATIVE_CLIP["hx4"]),
        "mean_std": (volume,),
        "z_score_normalize": (volume, (-1, 1)),
        "extract_patch": (volume, *NATIVE_PATCH),
        "masked_fill": (volume, volume > 0, -1.0),
        "masked_fill_hx4": (ct, body, -1024.0),
    }
    ops = {}
    for case, args in cases.items():
        name = case.replace("_hx4", "")
        fn, plain = getattr(native, name), getattr(native, name + "_plain")
        got, want = fn(*args), plain(*args)
        got, want = np.asarray(got), np.asarray(want)
        if name == "mean_std":
            err = float(np.max(np.abs(got - want) / np.abs(want)))
            ok = err <= NATIVE_MEAN_STD_RTOL
        else:
            check(got.shape == want.shape and got.dtype == want.dtype == np.float32,
                  f"native {case}: {got.shape} {got.dtype} against {want.shape} {want.dtype}")
            err = float(np.max(np.abs(got - want)))
            ok = err == 0 if name in ("extract_patch", "masked_fill") else err <= NATIVE_ATOL
        ops[case] = {"shape": list(args[0].shape), "err": err, "ok": bool(ok),
                     "ms": host_ms(lambda: fn(*args)), "plain_ms": host_ms(lambda: plain(*args))}
        ops[case]["speedup"] = ops[case]["plain_ms"] / ops[case]["ms"]
    rec["ops"] = ops
    del ct, body

    sample, shipped = native_val_sample(dataset, swap_plain=False)
    plain_sample, plain = native_val_sample(dataset, swap_plain=True)
    rec["val_sample"] = {"shape": list(sample["A"].shape), "shipped": shipped, "plain": plain,
                         "normalise_share": shipped["normalise_ms"] / 1e3 / shipped["sample_s"],
                         "plain_normalise_share":
                             plain["normalise_ms"] / 1e3 / plain["sample_s"]}
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    for case, op in ops.items():
        check(op["ok"], f"native {case} against its plain version: {op['err']}")
    check(sum(shipped["native_calls"].values()) > 0,
          f"the BRaTS validation sample never reached the native library: {shipped}")
    check(sum(plain["native_calls"].values()) == 0,
          f"the plain validation sample reached the native library: {plain}")
    for key in ("A", "B"):
        got, want = sample[key], plain_sample[key]
        check(got.shape == want.shape == (*REVGAN_VOLUME[1:], 1) and np.isfinite(got).all(),
              f"the validation sample's {key}: {got.shape}")
        err = float(np.max(np.abs(got - want)))
        check(err <= NATIVE_ATOL, f"the validation sample's {key} against the plain ops: {err}")
    return rec


def brats_batches(conf, n=None):
    """`BRATS_BATCHES` training samples (n, seed) of the config's dataset
    (the project twin's `BratsDataset` over the NIfTI root; the first `n`
    only, given `n`) as batches of
    1, drawn once per run for a given dataset: sample `i` after seeding
    Python's `random` (domain B's scan) and the patch sampler's generator
    (the patch pair) from (`seed`, `i`); with the mean seconds a sample
    takes (two scans read and gunzipped, a patch pair cut and z-scored)."""
    import random
    import numpy as np
    from ganslate_tpu_torch.utils.io import import_attr
    n, seed = (n or BRATS_BATCHES[0]), BRATS_BATCHES[1]
    d = conf.train.dataset
    key = (d._target_, d.root, tuple(d.patch_size), d.source_sequence, d.target_sequence, n)
    if key in _BRATS_BATCHES:
        return _BRATS_BATCHES[key]
    dataset = import_attr(d._target_)(conf)
    batches = []
    t0 = time.perf_counter()
    for i in range(n):
        random.seed(seed * 1000 + i)
        dataset.patch_sampler.rng = np.random.default_rng([seed, i])
        batches.append({k: v[None] for k, v in dataset[i % len(dataset)].items()})
    _BRATS_BATCHES[key] = batches, (time.perf_counter() - t0) / n
    return _BRATS_BATCHES[key]


def revgan_raw(out_dir, memory_saving=True, mixed_precision=True):
    """The BRaTS RevGAN experiment as a raw config tree, field for field
    (its project, by the directory's absolute path), with the run's cut loop
    lengths and frequencies and the datasets' roots on the NIfTI root
    (`REVGAN_LEFT_OUT`)."""
    warm, timed, log_freq, ckpt_freq, val_freq = REVGAN_RUN
    n_iters = warm + timed
    train_dataset, val_dataset = brats_datasets()
    return {
        "project": str(BRATS_PROJECT),
        "train": {
            "output_dir": str(out_dir), "cuda": True,
            "n_iters": n_iters - n_iters // 2, "n_iters_decay": n_iters // 2,
            "batch_size": 1, "mixed_precision": mixed_precision, "seed": SEED + 3,
            "logging": {"freq": log_freq},
            "checkpointing": {"freq": ckpt_freq},
            "dataset": train_dataset,
            "gan": {
                "_target_": "ganslate.nn.gans.unpaired.RevGAN",
                "generator": {"_target_": "ganslate.nn.generators.Piresnet3D",
                              "use_memory_saving": memory_saving, "use_inverse": True,
                              "in_out_channels": {"AB": [1, 1]},
                              "depth": REVGAN_NETS["depth"]},
                "discriminator": {"_target_": "ganslate.nn.discriminators.PatchGAN3D",
                                  "n_layers": REVGAN_NETS["n_layers_D"],
                                  "in_channels": {"B": 1}},
                "optimizer": {"lr_D": 0.0002, "lr_G": 0.0004, "lambda_AB": 5.0,
                              "lambda_BA": 5.0, "lambda_identity": 0, "proportion_ssim": 0},
            },
        },
        "val": {"freq": val_freq, "dataset": val_dataset,
                "sliding_window": {"window_size": "${train.dataset.patch_size}"}},
    }


def revgan_conf(out_dir, **kwargs):
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    return init_config(Conf.create(revgan_raw(out_dir, **kwargs)), Config)


def grads_of(model):
    return {f"{name}.{k}": p.grad for name, net in model.networks.items()
            for k, p in net.named_parameters()}


def net_rel_l2(grads, ref):
    """Relative L2 distance of each network's whole gradient (its tensors
    concatenated; inert biases, which have none, left out)."""
    import torch
    out = {}
    for name in sorted({k.split(".")[0] for k in ref}):
        keys = [k for k in ref if k.split(".")[0] == name and ref[k] is not None]
        a = torch.cat([grads[k].float().flatten() for k in keys])
        b = torch.cat([ref[k].float().flatten() for k in keys])
        out[name] = float((a - b).norm() / b.norm())
    return out


def fresh_step(conf, batch, norms=None, inspect=None):
    """Losses, gradients and norm launches of one train step of a fresh
    model of `conf` (its state and generator, hence its dropout masks or
    patch ids, made from the seed) on `batch`, inside `norms` where given
    (a context that may swap the norms); then `inspect(model)`, where
    given."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    from ganslate_tpu_torch.utils.builders import build_gan
    model = build_gan(conf)
    model.setup(batch)
    model.set_input(batch)
    inorm.reset_launches()
    with norms or contextlib.nullcontext():
        model.optimize_parameters()
    torch.cuda.synchronize()
    out = ({k: float(v) for k, v in model.losses.items()}, grads_of(model),
           dict(inorm.LAUNCHES))
    if inspect:
        inspect(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def revgan_one_step(out_dir, batch, memory_saving, mixed_precision, norms=None,
                    inspect=None):
    """`fresh_step` of the RevGAN config, with or without memory saving."""
    return fresh_step(revgan_conf(out_dir, memory_saving=memory_saving,
                                  mixed_precision=mixed_precision), batch, norms, inspect)


def revgan_grad_checks(out_dir, batch):
    """One step with memory saving against one with stored activations, and
    one against the plain norms, from the same state and batch: fp32 (TF32
    off, cuDNN deterministic) and bf16. Returns the phase's launches."""
    import torch
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    # Deterministic kernels where PyTorch has them (the pads' backward is an
    # `index_add_`, with atomics otherwise); a warning where it has none.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        losses_a, grads_a, launches_a = revgan_one_step(
            out_dir, batch, True, False,
            inspect=lambda model: revgan_recompute_check(model, batch))
        losses_b, grads_b, launches_b = revgan_one_step(out_dir, batch, False, False)
        losses_p, grads_p, launches_p = revgan_one_step(out_dir, batch, True, False,
                                                        plain_norms())
        # The scale of the gap: the stored run repeated; stored activations
        # with the plain forward, without and with one-ulp noise on every
        # norm output.
        _, repeat, launches_r = revgan_one_step(out_dir, batch, False, False)
        plain_fwd = revgan_one_step(out_dir, batch, False, False, plain_forward())[1]
        one_ulp = revgan_one_step(out_dir, batch, False, False,
                                  plain_forward(ulp_noise=True))[1]
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved[:3]
        torch.use_deterministic_algorithms(saved[3], warn_only=saved[4])
    keys = [k for k, g in grads_b.items() if g is not None]
    inert = [k for k, g in grads_b.items() if g is None]
    tensor_err = {k: rel_l2(grads_a[k], grads_b[k]) for k in keys}
    plain_err = {k: rel_l2(grads_a[k], grads_p[k]) for k in keys}
    rec = {"phase": "revgan_grad_check", "dtype": "float32",
           "losses": losses_a, "losses_stored": losses_b, "losses_plain_norms": losses_p,
           "grad_rel_l2_vs_stored_by_network": net_rel_l2(grads_a, grads_b),
           "grad_rel_l2_vs_stored_worst_tensor": max(tensor_err.items(), key=lambda kv: kv[1]),
           "grad_tol": REVGAN_FP32_GRAD_MAX,
           "grad_rel_l2_stored_repeat_by_network": net_rel_l2(repeat, grads_b),
           "grad_rel_l2_one_ulp_output_noise_by_network": net_rel_l2(one_ulp, plain_fwd),
           "grad_rel_l2_vs_plain_norms_by_network": net_rel_l2(grads_a, grads_p),
           "grad_rel_l2_vs_plain_norms_worst": sorted(plain_err.items(),
                                                      key=lambda kv: -kv[1])[:5],
           "plain_norms_grad_tol": TRAIN_FP32_GRAD_MAX,
           "loss_rel_err_vs_plain_norms": {k: abs(losses_a[k] - losses_p[k]) / abs(losses_p[k])
                                           for k in losses_p},
           "n_grads": len(keys), "n_inert_biases": len(inert),
           "launches": {"memory_saving": launches_a, "stored": launches_b,
                        "plain_norms": launches_p}}
    emit(rec)
    check(all(grads_a[k] is None and grads_p[k] is None for k in inert), rec)
    check(max(rec["grad_rel_l2_vs_stored_by_network"].values()) <= REVGAN_FP32_GRAD_MAX, rec)
    check(max(plain_err.values()) <= TRAIN_FP32_GRAD_MAX, rec)
    check(max(rec["loss_rel_err_vs_plain_norms"].values()) <= TRAIN_FP32_LOSS_RTOL, rec)
    check(all(abs(losses_a[k] - losses_b[k]) <= 1e-5 * abs(losses_b[k]) for k in losses_b), rec)
    check(sum(launches_p.values()) == 0, "the plain-norm step launched a kernel")
    check(launches_a == revgan_launches(True)
          and launches_b == revgan_launches(False), rec)

    # bf16: each run against the fp32 stored-activation gradient.
    _, grads_a16, l_a16 = revgan_one_step(out_dir, batch, True, True)
    _, grads_b16, l_b16 = revgan_one_step(out_dir, batch, False, True)
    saving = {k: rel_l2(grads_a16[k], grads_b[k]) for k in keys}
    stored = {k: rel_l2(grads_b16[k], grads_b[k]) for k in keys}
    ratio = statistics.median(saving[k] / stored[k] for k in keys)
    rec = {"phase": "revgan_grad_check", "dtype": "bfloat16",
           "grad_rel_l2_saving_vs_stored_by_network": net_rel_l2(grads_a16, grads_b16),
           "grad_vs_fp32_saving_by_network": net_rel_l2(grads_a16, grads_b),
           "grad_vs_fp32_stored_by_network": net_rel_l2(grads_b16, grads_b),
           "grad_vs_fp32_saving_max": max(saving.values()),
           "grad_vs_fp32_stored_max": max(stored.values()),
           "grad_vs_fp32_median_ratio": ratio, "grad_ratio_tol": TRAIN_BF16_GRAD_RATIO}
    emit(rec)
    check(ratio <= TRAIN_BF16_GRAD_RATIO, rec)
    check(rec["grad_vs_fp32_saving_max"] <= TRAIN_BF16_GRAD_RATIO
          * rec["grad_vs_fp32_stored_max"], rec)
    return [launches_a, launches_b, launches_r, l_a16, l_b16]


def revgan_recompute_check(model, batch):
    """On the card, at the core's slab, in the model's compute dtype (after a
    step: its updated state): the backward's rerun of a coupling
    block (`InvertibleSequence.rerun`, with a graph, on leaf copies of the
    block's tensors) gives the first pass's output (no graph) bit for bit
    at the same input; and the chain's input rebuilt by its inverse, as the
    backward rebuilds it block by block, against the first pass's input."""
    import torch
    from ganslate_tpu_torch.nn import invertible
    net = model._serving_network("G")
    x = torch.as_tensor(batch["A"]).to(model.device, model.compute_dtype)
    with torch.no_grad():
        h = net.down_ab(x.permute(0, 4, 1, 2, 3))
        core = net.core
        h1, h2 = h.chunk(2, dim=1)
        first = invertible.coupling_forward(core.blocks[0]["F"], core.blocks[0]["G"],
                                            [h1, h2])
        rebuilt = core.chain(core.chain(h), inverse=True)
    names, tensors = core.block_tensors()
    rerun = core.rerun(0, names, tensors, [True] * len(tensors), h1, h2)[0]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b.detach()) for a, b in zip(first, rerun))
    err = (rebuilt.float() - h.float()).abs()
    rec = {"phase": "revgan_recompute", "dtype": str(model.compute_dtype).split(".")[1],
           "core_input": list(h.shape), "rerun_equals_first_pass": same,
           "rebuilt_input_max_abs_err": float(err.max()),
           "rebuilt_input_mean_abs_err": float(err.mean()),
           "core_input_max_abs": float(h.abs().max())}
    emit(rec)
    check(same, f"the backward's rerun of a coupling block differs from its first pass: {rec}")
    return rec


def revgan_family(chain, kernel):
    """`family`, with the couplings' recompute (rebuilding and rerunning the
    blocks) and layout copies (the first norm of a coupling chain copies
    its channel half, a view) as families of their own."""
    if "coupling_recompute" in chain:
        return "coupling_recompute"
    ops = [n for n in chain if n.startswith("aten::")]
    if ops and ops[0] in ("aten::copy_", "aten::clone") and "aten::contiguous" in ops \
            and not any(n.startswith("autograd::engine::") for n in chain):
        return "layout_copies"
    return family(chain, kernel)


REVGAN_RANGES = ("coupling_recompute", "losses", "metrics", "pool")


def revgan_profile(model, batches):
    return profile_steps(model, batches, REVGAN_PROFILED_STEPS, revgan_family, REVGAN_RANGES)


def profile_steps(model, batches, n_steps, family_fn, ranges):
    """Device time of `n_steps` train steps by family (`family_fn`), and the
    device's idle share; `ranges` are the host ranges that mark families.
    The norm kernels, launched through ctypes, are read from the device
    events by name (the profiler links them to no host op)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    label_step(model)
    model.set_input(batches[0])
    model.optimize_parameters()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            model.set_input(batches[i % len(batches)])
            model.optimize_parameters()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device = [ev for ev in events if "CUDA" in str(getattr(ev, "device_type", ""))
              and not getattr(ev, "is_user_annotation", False) and ev.name not in ranges]
    busy = sum(ev.device_time_total for ev in device) / 1e3
    norms = [ev for ev in device if "inorm" in ev.name]
    fams = {"norm_kernels": sum(ev.device_time_total for ev in norms) / 1e3}
    top = {}
    for ev in events:
        if not getattr(ev, "kernels", None):
            continue
        chain, parent = [], ev
        while parent is not None:
            chain.append(parent.name)
            parent = parent.cpu_parent
        for k in ev.kernels:
            if "inorm" in k.name.lower():
                continue            # counted from the device events above
            fam = family_fn(chain, k.name)
            fams[fam] = fams.get(fam, 0.0) + k.duration / 1e3
            node = next((n.split(": ", 1)[1] for n in chain
                         if n.startswith("autograd::engine::evaluate_function: ")), chain[0])
            key = (fam, node, k.name[:70])
            top[key] = top.get(key, 0.0) + k.duration / 1e3
    per_step = {k: v / n_steps for k, v in sorted(fams.items(), key=lambda kv: -kv[1])}
    return {"steps": n_steps, "wall_ms": wall_ms,
            "device_busy_ms_per_step": busy / n_steps if busy else "not measured",
            "device_idle_share": (1 - busy / wall_ms) if busy else "not measured",
            "device_ms_per_step_by_family": per_step,
            "device_ms_unattributed_per_step": (busy - sum(fams.values())) / n_steps
            if busy else "not measured",
            "norm_kernel_launches_seen": len(norms),
            "top": [[f, n, k, ms / n_steps] for (f, n, k), ms in
                    sorted(top.items(), key=lambda kv: -kv[1])[:25]]}


def revgan_conv_flops(model):
    """Conv FLOPs (`conv_flops`) of one Piresnet3D pass, of its core alone
    and of one PatchGAN3D pass at batch 1, and of a train step: 4 G passes
    forward and backward (the backward counted as twice the forward: data
    and weight gradients), 2 D passes with input gradients in the G step, 4
    D passes (2 Ds, real and fake) with a full backward in the D step; and
    the memory-saving backward's recompute, 4 uses of the core rebuilt and
    rerun."""
    import torch
    g, d = model.networks["G"], model.networks["D_B"]
    flc = g.core.blocks[0]["F"].conv.weight.shape[0] * 2
    x = torch.zeros((1, 1, *REVGAN_PATCH), device=model.device)
    core_x = torch.zeros((1, flc, *(s // 2 for s in REVGAN_PATCH)), device=model.device)
    g_pass = sum(conv_flops(g, x).values())
    core = sum(conv_flops(g.core, core_x).values())
    d_pass = sum(conv_flops(d, x).values())
    return {"g_pass": g_pass, "core_pass": core, "d_pass": d_pass,
            "step_first_pass_and_backward": 4 * 3 * g_pass + 2 * 2 * d_pass + 4 * 3 * d_pass,
            "step_recompute": 4 * 2 * core}


def model_steps(model, batches, label, steps=REVGAN_MODEL_STEPS):
    """Timed model-level train steps (CUDA events around each, after
    warm-up; `steps` is (warm, timed)), peak memory over them, and their
    norm launches."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    warm, timed = steps
    steps, launches, losses = [], [], []
    for i in range(warm + timed):
        if i == warm:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        model.set_input(batches[i % len(batches)])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        inorm.reset_launches()
        start.record()
        model.optimize_parameters()
        end.record()
        launches.append(dict(inorm.LAUNCHES))
        losses.append(model.losses)
        steps.append((start, end))
    torch.cuda.synchronize()
    step_ms = [s.elapsed_time(e) for s, e in steps[warm:]]
    peak = torch.cuda.max_memory_allocated()
    return {"config": label, "step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
            "peak_memory_bytes": peak, "peak_memory_gib": peak / 2 ** 30,
            "launches_per_step": launches[-1],
            "losses_finite": all(math.isfinite(float(v)) for s in losses for v in s.values())}, \
        launches


def trainer_run(root, raw, label, run, want, unit, k=1, **extra):
    """Phase `label`'s Trainer run: `init_engine("train")` from `raw` (a
    raw config tree, through `engine`; or `init_engine`'s arguments, a YAML
    and its overrides) through `run()`, its iterations timed (`instrument_trainer`), its
    validation metrics kept and its norm launches counted from 0. `run` is
    (warm-up iterations, timed iterations, logging.freq, checkpointing.freq,
    val.freq), `want` the launches the run must make, `unit` what a batch
    holds ("images" or "patches"); `extra` joins the record (a `cuts`
    entry is completed with the run's loop lengths and frequencies). With
    `k` > 1 the config runs `train.steps_per_dispatch` k: the records are
    the chunks', each ending at an iteration that k divides (k divides the
    warm-up and the run), and an iteration's time is its chunk's over k.
    Emits the `<label>_run` record and checks the iterations (the chunk
    boundaries), finite losses at every log, the checkpoints, a validation
    inside the timed span with finite metrics, and the launches. Returns the
    record and the trained model, its instrumentation removed."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    from ganslate_tpu_torch.engines.utils import init_engine
    warm, timed, log_freq, ckpt_freq, val_freq = run
    n_iters = warm + timed
    check(warm % k == 0 and n_iters % k == 0, f"chunks of {k} do not divide the run {run}")
    t_build = time.perf_counter()
    if isinstance(raw, dict):
        trainer, entry = engine("train", raw, root)
    else:
        trainer, entry = init_engine("train", raw), "init_engine"
    build_s = time.perf_counter() - t_build
    conf = trainer.conf
    out_dir = Path(conf.train.output_dir).resolve()
    n_params = {name: sum(p.numel() for p in net.parameters())
                for name, net in trainer.model.networks.items()}
    records = instrument_trainer(trainer)
    val_metrics = {}
    tracker = trainer.validator.tracker
    log_samples = tracker.log_samples

    def keep_metrics(*args, **kwargs):
        for m in tracker.metrics:
            for name, values in m.items():
                val_metrics.setdefault(name, []).extend(values)
        return log_samples(*args, **kwargs)

    tracker.log_samples = keep_metrics
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    inorm.reset_launches()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = dict(inorm.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    check(int(conf.train.steps_per_dispatch or 1) == k, "the config's steps_per_dispatch")
    ends = list(range(k, n_iters + 1, k))         # the iterations that end a chunk
    check(sorted(records) == ends, f"iterations run: {sorted(records)}")
    starts = [records[i]["t0"] for i in ends] + [t_end]
    for j, i in enumerate(ends):
        records[i]["ms"] = (starts[j + 1] - starts[j]) * 1e3
    timed_iters = [i for i in ends if i > warm]
    plain = [records[i]["ms"] for i in timed_iters if records[i]["plain"]]
    logged = [i for i in ends if records[i]["log"]]
    finite = all(math.isfinite(v) for i in logged for v in records[i]["losses"].values())
    ckpts = sorted(int(p.stem) for p in (out_dir / "checkpoints").glob("*.pth"))
    if "cuts" in extra:
        extra["cuts"] = {**extra["cuts"], "to": {
            "n_iters": conf.train.n_iters, "n_iters_decay": conf.train.n_iters_decay,
            "logging.freq": log_freq, "checkpointing.freq": ckpt_freq, "val.freq": val_freq,
            **extra["cuts"].get("to", {})}}
    timed_wall = starts[-1] - starts[ends.index(timed_iters[0])]
    rec = {"phase": f"{label}_run", "entry": entry, **extra, "parameters": n_params,
           "build_s": build_s, "run_s": t_end - t0, "iterations": n_iters,
           "steps_per_dispatch": k, "timed_iterations": [warm + 1, n_iters],
           "timed_wall_s": timed_wall, f"{unit}_per_s": timed / timed_wall,
           "plain_iteration_ms": {"median": statistics.median(plain) / k, "n": len(plain),
                                  **_ms_stats([p / 1e3 / k for p in plain])},
           "log_iteration_ms": {i: records[i]["ms"] for i in timed_iters if records[i]["log"]},
           "checkpoint_iteration_ms": {i: records[i]["ms"] for i in timed_iters
                                       if records[i]["checkpoint"]},
           "validation_iteration_ms": {i: records[i]["ms"] for i in timed_iters
                                       if records[i]["validation"]},
           "plain_host_ranges_ms": {r: statistics.fmean(records[i]["ranges"].get(r, 0.0)
                                                        for i in timed_iters
                                                        if records[i]["plain"]) * 1e3
                                    for r in TRAINER_RANGES},
           "t_data_ms": _ms_stats([records[i]["t_data"] for i in timed_iters]),
           "peak_memory_bytes": peak, "peak_memory_gib": peak / 2 ** 30,
           "losses_at_logs": {i: records[i]["losses"] for i in logged},
           "validation_metrics": {k: statistics.fmean(v) for k, v in val_metrics.items()},
           "checkpoints": ckpts, "launches": launches, "launches_expected": want}
    emit(rec)
    check(finite and logged, f"a logged loss is not finite: {rec['losses_at_logs']}")
    check(ckpts == [i for i in range(1, n_iters + 1) if i % ckpt_freq == 0]
          and any(warm < c for c in ckpts), rec)
    check(any(records[i]["validation"] for i in timed_iters), rec)
    check(val_metrics and all(math.isfinite(x) for v in val_metrics.values() for x in v),
          f"validation metrics: {val_metrics}")
    check(launches == want, f"norm launches {launches}, expected {want}")

    model = trainer.model
    # The instrumentation's wrappers.
    del model.set_input, model.set_input_multi, model.optimize_parameters
    tracker.log_samples = log_samples
    del trainer
    gc.collect()
    return rec, model


def revgan_train_run(root, batches):
    """Run (a): the memory-saving config from `init_engine("train")` through
    `run()` (`trainer_run`); then model-level steps and the profile on its
    model. Returns the run's norm launches, its last checkpoint, its output
    directory, the model-level record and the profile."""
    import numpy as np
    import torch
    warm, timed, _, _, val_freq = REVGAN_RUN
    out_dir = root / "revgan"
    windows = sw_windows(REVGAN_VOLUME[1:], REVGAN_PATCH)
    val_runs = (warm + timed) // val_freq
    want = {k: (warm + timed) * v + val_runs * 2 * windows * piresnet_launches()[k]
            for k, v in revgan_launches(True).items()}
    rec, model = trainer_run(root, revgan_raw(out_dir), "revgan", REVGAN_RUN, want, "patches",
                             dataset="synthetic BRaTS NIfTI scans, the project twin",
                             cuts={"from": REVGAN_YAML_LENGTHS, "left_out": REVGAN_LEFT_OUT},
                             validation_windows_per_volume=windows)
    check("cycle_SSIM" in rec["validation_metrics"], rec["validation_metrics"])
    device_batches = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(model.device)
                       for k, v in b.items()} for b in batches]
    steps, step_launches = model_steps(model, device_batches, "memory_saving")
    steps["plain_iteration_over_step"] = rec["plain_iteration_ms"]["median"] \
        / steps["median_step_ms"]
    recompute = revgan_recompute_check(model, batches[0])
    flops = revgan_conv_flops(model)
    profile = revgan_profile(model, device_batches)
    del model, device_batches
    gc.collect()
    torch.cuda.empty_cache()
    return (rec["launches"], rec["checkpoints"][-1], out_dir, steps, step_launches, recompute,
            flops, profile)


def sw_windows(spatial, roi, overlap=0.25):
    from ganslate_tpu_torch.utils.sliding_window_inferer import _scan_interval, dense_patch_slices
    return len(dense_patch_slices(spatial, roi, _scan_interval(spatial, roi, overlap)))


def revgan_stored_steps(out_dir, batches):
    """Run (b): the same config with `use_memory_saving: false`, model-level
    steps (the price of the saving: step time and peak memory)."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.utils.builders import build_gan
    model = build_gan(revgan_conf(out_dir, memory_saving=False))
    model.setup(batches[0])
    device_batches = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(model.device)
                       for k, v in b.items()} for b in batches]
    steps, launches = model_steps(model, device_batches, "stored_activations")
    del model, device_batches
    gc.collect()
    torch.cuda.empty_cache()
    return steps, launches


def revgan_serve(root, out_dir, load_iter):
    """Run (c): `init_engine("infer")` (not a deployment) from run (a)'s
    last checkpoint: `run()` over the validation volume through the sliding
    window; then `infer` AB and BA on it, with the kernels and with the
    plain norms. Returns the main path's launches (`run()` and the two
    kernel `infer`s)."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    raw = revgan_raw(out_dir)
    raw["infer"] = {"checkpointing": {"load_iter": load_iter}, "is_deployment": False,
                    "dataset": dict(raw["val"]["dataset"]),
                    "sliding_window": {"window_size": list(REVGAN_PATCH)}}
    inferer, entry = engine("infer", raw, root)
    outputs = []
    save = inferer.save_generated_tensor

    def keep(generated_tensor, **kwargs):
        outputs.append(np.array(generated_tensor))
        return save(generated_tensor=generated_tensor, **kwargs)

    inferer.save_generated_tensor = keep
    inorm.reset_launches()
    t0 = time.perf_counter()
    inferer.run()
    run_s = time.perf_counter() - t0
    launches = [dict(inorm.LAUNCHES)]
    out = np.concatenate(outputs)
    shape = (1, *REVGAN_VOLUME[1:], 1)
    windows = sw_windows(REVGAN_VOLUME[1:], REVGAN_PATCH)
    rec = {"phase": "revgan_infer_run", "entry": entry, "load_iter": load_iter,
           "shape": list(out.shape), "dtype": str(out.dtype), "run_s": run_s,
           "out_min": float(out.min()), "out_max": float(out.max()),
           "out_std": float(out.std()), "launches": launches[0]}
    emit(rec)
    check(out.shape == shape and bool(np.isfinite(out).all())
          and -1 <= rec["out_min"] <= rec["out_max"] <= 1 and rec["out_std"] > 1e-3, rec)
    check(launches[0] == {k: windows * v for k, v in piresnet_launches().items()}, rec)

    x = inferer.data_loader.dataset[0]["A"][None]
    outs = {}
    for direction in ("AB", "BA"):
        inorm.reset_launches()
        t0 = time.perf_counter()
        y = inferer.infer(x, direction=direction)
        latency_ms = (time.perf_counter() - t0) * 1e3
        launches.append(dict(inorm.LAUNCHES))
        with plain_norms():
            inorm.reset_launches()
            ref = inferer.infer(x, direction=direction)
            check(sum(inorm.LAUNCHES.values()) == 0, "the plain run launched a kernel")
        err = (y.float() - ref.float()).abs()
        rec = {"phase": "revgan_serve", "direction": direction, "latency_ms": latency_ms,
               "windows": windows, "launches": launches[-1],
               "max_abs_err_vs_plain": float(err.max()),
               "mean_abs_err_vs_plain": float(err.mean()),
               "tol_max": SW_BF16_MAX, "tol_mean": SW_BF16_MEAN}
        sw_output_check(rec, y, shape)
        emit(rec)
        check(launches[-1] == launches[0], rec)
        check(rec["max_abs_err_vs_plain"] <= SW_BF16_MAX, rec)
        check(rec["mean_abs_err_vs_plain"] <= SW_BF16_MEAN, rec)
        outs[direction] = y.float()
        del ref, err
    ab_ba = float((outs["AB"] - outs["BA"]).abs().max())
    emit({"phase": "revgan_serve_directions", "max_abs_ab_minus_ba": ab_ba})
    check(ab_ba > 1e-3, "infer BA gave AB's output: the inverse did not run")
    del inferer, outs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def revgan_phase(root):
    """Phase 8; returns the norm launches of its main path (run (a) and the
    serving from its checkpoint)."""
    import torch
    t0 = time.perf_counter()
    allocated = torch.cuda.memory_allocated()
    conf = revgan_conf(root / "revgan_data")
    batches, sample_s = brats_batches(conf)
    emit({"phase": "revgan_data", "seconds": time.perf_counter() - t0,
          "dataset": conf.train.dataset._target_, "root": conf.train.dataset.root,
          "sample_s": sample_s, "patch": list(REVGAN_PATCH),
          "batch_shapes": {k: list(v.shape) for k, v in batches[0].items()}})
    launches, load_iter, out_dir, steps_a, launches_a, recompute, flops, profile = \
        revgan_train_run(root, batches)
    totals = dict(launches)
    for step in revgan_serve(root, out_dir, load_iter):
        for k, v in step.items():
            totals[k] += v
    other = [*launches_a]
    steps_b, launches_b = revgan_stored_steps(root / "revgan_stored", batches)
    other += launches_b
    check(all(s == revgan_launches(True) for s in launches_a)
          and all(s == revgan_launches(False) for s in launches_b),
          f"launches per step: {launches_a}, {launches_b}")
    check(steps_a["losses_finite"] and steps_b["losses_finite"], "a non-finite loss")

    fam = profile["device_ms_per_step_by_family"]
    conv_ms = sum(fam.get(f, 0.0) for f in ("conv_forward", "conv_dgrad", "conv_wgrad",
                                            "conv_backward_other"))
    rec = {"phase": "revgan_summary", "memory_saving": steps_a, "stored_activations": steps_b,
           "peak_saving_bytes": steps_b["peak_memory_bytes"] - steps_a["peak_memory_bytes"],
           "step_ms_cost_of_saving": steps_a["median_step_ms"] - steps_b["median_step_ms"],
           "conv_gflop": {k: v / 1e9 for k, v in flops.items()},
           "conv_tflop_per_s": flops["step_first_pass_and_backward"] / (conv_ms * 1e-3) / 1e12
           if conv_ms else "not measured",
           "recompute_tflop_per_s_with_its_pads_and_adds":
               flops["step_recompute"] / (fam["coupling_recompute"] * 1e-3) / 1e12
               if fam.get("coupling_recompute") else "not measured",
           "profile": profile, "recompute": recompute,
           "launches_main_path": totals}
    emit(rec)
    check(steps_a["peak_memory_bytes"] < steps_b["peak_memory_bytes"],
          f"memory saving saved no memory: {steps_a['peak_memory_bytes']} against "
          f"{steps_b['peak_memory_bytes']} bytes")
    check(profile["device_busy_ms_per_step"] != "not measured"
          and fam.get("norm_kernels", 0) > 0 and fam.get("coupling_recompute", 0) > 0,
          "the profile saw no norm kernel or no recompute")
    other += revgan_grad_checks(root / "revgan_check", batches[0])
    left = torch.cuda.memory_allocated() - allocated
    emit({"phase": "revgan_phase", "seconds": time.perf_counter() - t0,
          "launches_main_path": totals,
          "launches_whole_phase": {k: totals[k] + sum(s[k] for s in other) for k in totals},
          "device_bytes_left_allocated": left})
    check(left < 2 ** 28, f"the revgan phase left {left} bytes allocated on the device")
    return totals



# ------------------------------------------------------------- phase 9


def pix2pix_images(seed, n, kind):
    """`n` uint8 (256, 512, 3) images from `seed`: label maps (A: blocks of
    16 x 16 pixels in colours of a 20-colour palette, as Cityscapes' label
    renderings) or photos (B: a smooth random field plus noise)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    h, w = PIX2PIX_SIZE
    if kind == "labels":
        palette = rng.integers(0, 256, (20, 3))
        cells = rng.integers(0, 20, (n, h // 16, w // 16))
        img = palette[np.repeat(np.repeat(cells, 16, axis=1), 16, axis=2)]
    else:
        low = rng.uniform(0, 255, (n, h // 16, w // 16, 3))
        img = np.repeat(np.repeat(low, 16, axis=1), 16, axis=2) + rng.normal(0, 8, (n, h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def write_pix2pix_data(root):
    """`train/{A,B}` and `val/{A,B}`: aligned label/photo pairs of (256, 512)
    PNGs, written by the port's own writer."""
    from ganslate_tpu_torch.utils.trackers.utils import save_image
    for split, n, seed in (("train", PIX2PIX_TRAIN_PAIRS, SEED + 50),
                           ("val", PIX2PIX_VAL_PAIRS, SEED + 52)):
        for domain, kind in (("A", "labels"), ("B", "photos")):
            folder = root / split / domain
            folder.mkdir(parents=True)
            for i, img in enumerate(pix2pix_images(seed, n, kind)):
                save_image(img / 255.0, folder / f"{i:04d}.png")


def pix2pix_raw(out_dir, data_root, load_iter=None, mixed_precision=True):
    """The Cityscapes Pix2Pix experiment as a raw config tree, field for
    field, with the run's cuts (`PIX2PIX_LEFT_OUT`, `PIX2PIX_RUN`); test and
    infer sections over the validation folder serve its checkpoint."""
    warm, timed, log_freq, ckpt_freq, val_freq = PIX2PIX_RUN
    n_iters = warm + timed

    def dataset(split, preprocess, load_size):
        return {"_target_": "ganslate.data.PairedImageDataset", "root": str(data_root / split),
                "num_workers": 8, "image_channels": 3, "preprocess": preprocess,
                "load_size": load_size, "final_size": list(PIX2PIX_SIZE)}

    val = dataset("val", ["resize"], list(PIX2PIX_SIZE))
    return {
        "project": str(Path(__file__).resolve().parent / "projects" / "cityscapes_label2photo"),
        "train": {
            "output_dir": str(out_dir), "cuda": True,
            "n_iters": n_iters - n_iters // 2, "n_iters_decay": n_iters // 2,
            "batch_size": 1, "mixed_precision": mixed_precision, "seed": SEED + 5,
            "logging": {"freq": log_freq},
            "checkpointing": {"freq": ckpt_freq},
            "dataset": dataset("train", ["resize", "random_crop", "random_flip"], [286, 572]),
            "gan": {
                "_target_": "ganslate.nn.gans.paired.Pix2PixConditionalGAN",
                "generator": {"_target_": "ganslate.nn.generators.Unet2D",
                              "in_out_channels": {"AB": [3, 3]}, "num_downs": 7,
                              "ngf": 128, "use_dropout": True},
                "discriminator": {"_target_": "ganslate.nn.discriminators.PatchGAN2D",
                                  "n_layers": 4, "in_channels": {"B": 6}},
                "optimizer": {"lr_D": 0.0001, "lr_G": 0.0002, "lambda_pix2pix": 30.0},
            },
            "metrics": {"discriminator_evolution": True},
        },
        "val": {"freq": val_freq, "dataset": val, "metrics": {"cycle_metrics": False}},
        "test": {"checkpointing": {"load_iter": load_iter}, "dataset": dict(val)},
        "infer": {"checkpointing": {"load_iter": load_iter}, "is_deployment": False,
                  "dataset": dict(val)},
    }


def pix2pix_conf(out_dir, data_root, **kwargs):
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    return init_config(Conf.create(pix2pix_raw(out_dir, data_root, **kwargs)), Config)


def pix2pix_batches(conf, n, seed):
    """`n` training samples of the config's dataset as host batches of 1,
    drawn as the loader draws them (a generator per sample)."""
    import numpy as np
    from ganslate_tpu_torch.data import PairedImageDataset
    dataset = PairedImageDataset(conf)
    return [{k: v[None] for k, v in dataset.__getitem__(
        i % len(dataset), rng=np.random.default_rng([seed, i])).items()} for i in range(n)]


def pix2pix_family(chain, kernel):
    """`revgan_family`, with dropout (its range, and its `where` backward)
    and the skip and conditional concats as families of their own."""
    if "dropout" in chain:
        return "dropout"
    node = next((n.split(": ", 1)[1] for n in chain
                 if n.startswith("autograd::engine::evaluate_function: ")), "")
    if node.startswith("WhereBackward"):
        return "dropout"
    if node.startswith("CatBackward"):
        return "concat"
    ops = [n for n in chain if n.startswith("aten::")]
    if not node and "aten::cat" in ops:
        return "concat"
    return revgan_family(chain, kernel)


PIX2PIX_RANGES = ("dropout", "losses", "metrics", "pool")


def label_dropout(model):
    """Mark the G's dropout calls with a `dropout` profiler range."""
    drop = model.networks["G"].dropout
    drop.forward = Labelled(drop.forward, "dropout")


def pix2pix_conv_flops(model):
    """Conv FLOPs (`conv_flops`) of one G and one D forward at batch 1, and
    of a train step: G forward and backward (the backward counted as twice
    the forward: data and weight gradients), D forward and its data
    gradient in the G step, and D at batch 2 (real and fake) forward and
    backward in the D step."""
    import torch
    h, w = PIX2PIX_SIZE
    g = sum(conv_flops(model.networks["G"], torch.zeros((1, 3, h, w),
                                                        device=model.device)).values())
    d = sum(conv_flops(model.networks["D"], torch.zeros((1, 6, h, w),
                                                        device=model.device)).values())
    return {"g_forward": g, "d_forward": d, "step": 3 * g + 2 * d + 3 * 2 * d}


def pix2pix_dropout_check(model, batch):
    """On the trained model, in bf16: a G forward with dropout from one
    generator state gives fake_B bit for bit twice; the next state gives
    another; without a generator (serving) dropout is off."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    x = batch["A"]
    inorm.reset_launches()
    with torch.no_grad():
        params = model.compute_params(["G"])
        state = model.rng.get_state()
        a = model.apply("G", x, params, model.rng)
        model.rng.set_state(state)
        b = model.apply("G", x, params, model.rng)
        c = model.apply("G", x, params, model.rng)
        off = model.apply("G", x, params)
    torch.cuda.synchronize()
    rec = {"phase": "pix2pix_dropout", "same_state_bit_equal": bool(torch.equal(a, b)),
           "next_state_max_abs_diff": float((a.float() - c.float()).abs().max()),
           "no_generator_max_abs_diff": float((a.float() - off.float()).abs().max()),
           "launches": dict(inorm.LAUNCHES)}
    emit(rec)
    check(rec["same_state_bit_equal"] and rec["next_state_max_abs_diff"] > 0
          and rec["no_generator_max_abs_diff"] > 0, rec)
    check(rec["launches"] == {k: 4 * v for k, v in PIX2PIX_G_LAUNCHES.items()}, rec)
    return rec


def pix2pix_train_run(root, data_root, batches):
    """The Cityscapes config from `init_engine("train")` through `run()`
    (`trainer_run`); then model-level steps, the dropout check, conv FLOPs
    and the profile on its model. Returns the run's norm launches, its last
    checkpoint and output directory, and the records."""
    import numpy as np
    import torch
    warm, timed, _, _, val_freq = PIX2PIX_RUN
    n_iters = warm + timed
    out_dir = root / "pix2pix"
    raw = pix2pix_raw(out_dir, data_root)
    val_runs = n_iters // val_freq
    want = {k: n_iters * PIX2PIX_LAUNCHES[k] + val_runs * PIX2PIX_VAL_PAIRS
            * PIX2PIX_G_LAUNCHES[k] for k in PIX2PIX_LAUNCHES}
    rec, model = trainer_run(
        root, raw, "pix2pix", PIX2PIX_RUN, want, "images",
        dataset="synthetic paired PNG folders",
        num_workers=raw["train"]["dataset"]["num_workers"],
        cuts={"from": PIX2PIX_YAML_LENGTHS, "left_out": PIX2PIX_LEFT_OUT,
              "to": {"val.dataset.load_size": list(PIX2PIX_SIZE)}})
    check(rec["parameters"] == PIX2PIX_PARAMS, rec["parameters"])
    check(all(sorted(v) == ["D", "G", "pix2pix"] for v in rec["losses_at_logs"].values()),
          rec["losses_at_logs"])
    check(not any(k.startswith("cycle") for k in rec["validation_metrics"]),
          rec["validation_metrics"])
    device_batches = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(model.device)
                       for k, v in b.items()} for b in batches]
    steps, step_launches = model_steps(model, device_batches, "cityscapes",
                                       PIX2PIX_MODEL_STEPS)
    steps["plain_iteration_over_step"] = rec["plain_iteration_ms"]["median"] \
        / steps["median_step_ms"]
    steps["images_per_s"] = 1e3 / steps["median_step_ms"]
    check(steps["losses_finite"] and all(s == PIX2PIX_LAUNCHES for s in step_launches),
          f"model-level steps: {steps}, launches {step_launches}")
    dropout = pix2pix_dropout_check(model, device_batches[0])
    flops = pix2pix_conv_flops(model)
    label_dropout(model)
    profile = profile_steps(model, device_batches, PIX2PIX_PROFILED_STEPS, pix2pix_family,
                            PIX2PIX_RANGES)
    del model, device_batches
    gc.collect()
    torch.cuda.empty_cache()
    return rec["launches"], rec["checkpoints"][-1], out_dir, rec, steps, dropout, flops, profile


def pix2pix_loader_check(root, data_root, threaded):
    """The Cityscapes config's Trainer again with `num_workers: 0` (each
    batch decoded and transformed in its iteration) and no log,
    checkpoint or validation inside: the host time of a plain iteration's
    loader wait and step, beside the threaded run's (`threaded`, its
    `pix2pix_run` record). Returns the run's norm launches."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    warm, timed = PIX2PIX_SYNC_RUN
    n_iters = warm + timed
    raw = pix2pix_raw(root / "pix2pix_sync", data_root)
    raw["train"]["dataset"]["num_workers"] = 0
    raw["train"].update(n_iters=n_iters, n_iters_decay=0, logging={"freq": 10 ** 6},
                        checkpointing={"freq": 10 ** 6})
    raw["val"]["freq"] = 10 ** 6
    trainer, _ = engine("train", raw, root)
    records = instrument_trainer(trainer)
    inorm.reset_launches()
    trainer.run()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = dict(inorm.LAUNCHES)
    starts = [records[i]["t0"] for i in range(1, n_iters + 1)] + [t_end]
    timed_iters = range(warm + 1, n_iters + 1)
    plain = [(starts[i] - starts[i - 1]) * 1e3 for i in timed_iters]
    rec = {"phase": "pix2pix_loader_check", "num_workers": 0, "iterations": n_iters,
           "plain_iteration_ms": {"median": statistics.median(plain),
                                  **_ms_stats([p / 1e3 for p in plain])},
           "plain_host_ranges_ms": {r: statistics.fmean(records[i]["ranges"].get(r, 0.0)
                                                        for i in timed_iters) * 1e3
                                    for r in TRAINER_RANGES},
           "threaded": {"num_workers": threaded["num_workers"],
                        "plain_iteration_ms": threaded["plain_iteration_ms"]["median"],
                        "plain_host_ranges_ms": threaded["plain_host_ranges_ms"]},
           "launches": launches}
    emit(rec)
    check(launches == {k: n_iters * v for k, v in PIX2PIX_LAUNCHES.items()}, rec)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def kernel_vs_plain_steps(label, conf_of, batch, launches_per_step, n_inert,
                          bf16_controls=False, cancelling=()):
    """One step with the kernel norms against one with the plain norms from
    the same state, batch and draws (`fresh_step` of `conf_of(mixed_
    precision)`): fp32 (TF32 off, deterministic algorithms where PyTorch has
    them) losses within `TRAIN_FP32_LOSS_RTOL`, every gradient within
    `TRAIN_FP32_GRAD_MAX` relative L2, with the train phase's controls (the
    kernels' run repeated; one-ulp noise on every plain norm output); the
    `n_inert` inert biases without a gradient; bf16, each run against the
    fp32 plain gradient (`TRAIN_BF16_GRAD_RATIO`). With `bf16_controls`, two
    more correct plain forwards that round in another order
    (`plain_reordered`) run in bf16 too, and the kernels' worst tensor and
    each network are held against the farthest of the correct plain
    forwards: a gradient that is a sum of ~10^6 terms cancelling to a small
    value (a 1-channel output conv's bias) lands anywhere in a wide range
    for any one-ulp change of the bf16 forward. `cancelling` names (by
    suffix) the tensors whose gradient is zero in exact arithmetic, so that
    both runs give rounding noise with no relative error to speak of (an
    attention block's key bias shifts every energy of a query by the same
    amount, which the softmax cancels; a separable down conv's first
    factor's bias, which reaches the norm as a per-channel constant): they
    are held apart, each below
    `CANCELLING_GRAD_MAX` of its network's gradient norm in both fp32 runs.
    Emits `<label>_grad_check` records; returns the launches of its runs."""
    import torch
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        losses, grads, launches = fresh_step(conf_of(False), batch)
        ref_losses, ref_grads, ref_launches = fresh_step(conf_of(False), batch, plain_norms())
        _, repeat, launches_r = fresh_step(conf_of(False), batch)
        plain_fwd = fresh_step(conf_of(False), batch, plain_forward())[1]
        one_ulp = fresh_step(conf_of(False), batch, plain_forward(ulp_noise=True))[1]
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved[:3]
        torch.use_deterministic_algorithms(saved[3], warn_only=saved[4])
    cancel = [k for k, g in ref_grads.items() if g is not None and cancelling
              and k.endswith(tuple(cancelling))]
    keys = [k for k, g in ref_grads.items() if g is not None and k not in cancel]
    inert = [k for k, g in ref_grads.items() if g is None]
    err = {k: rel_l2(grads[k], ref_grads[k]) for k in keys}

    def net_norm(g, name):
        return float(torch.cat([v.float().flatten() for k, v in g.items()
                                if v is not None and k.split(".")[0] == name]).norm())

    noise = {k: max(float(g[k].float().norm()) / net_norm(g, k.split(".")[0])
                    for g in (grads, ref_grads)) for k in cancel}
    loss_err = {k: abs(losses[k] - ref_losses[k]) / abs(ref_losses[k]) for k in ref_losses}
    rec = {"phase": f"{label}_grad_check", "dtype": "float32", "losses": losses,
           "losses_plain_norms": ref_losses, "loss_rel_err_vs_plain": loss_err,
           "loss_rtol": TRAIN_FP32_LOSS_RTOL,
           "grad_rel_l2_by_network": net_rel_l2(grads, ref_grads),
           "grad_rel_l2_worst": sorted(err.items(), key=lambda kv: -kv[1])[:5],
           "grad_rel_l2_median": statistics.median(err.values()), "grad_tol": TRAIN_FP32_GRAD_MAX,
           "grad_rel_l2_kernel_repeat_by_network": net_rel_l2(repeat, grads),
           "grad_rel_l2_backward_vs_autograd_by_network": net_rel_l2(plain_fwd, ref_grads),
           "grad_rel_l2_one_ulp_output_noise_by_network": net_rel_l2(one_ulp, plain_fwd),
           "n_grads": len(keys), "n_inert_biases": len(inert),
           "cancelling_grad_over_network": noise, "cancelling_tol": CANCELLING_GRAD_MAX,
           "launches": launches, "launches_plain_norms": ref_launches}
    emit(rec)
    check(all(v <= CANCELLING_GRAD_MAX for v in noise.values()), rec)
    check(all(grads[k] is None for k in inert), rec)
    check(len(inert) == n_inert, f"inert biases: {inert}")
    check(max(err.values()) <= TRAIN_FP32_GRAD_MAX, rec)
    check(max(loss_err.values()) <= TRAIN_FP32_LOSS_RTOL, rec)
    check(launches == launches_per_step and sum(ref_launches.values()) == 0, rec)

    losses16, grads16, l16 = fresh_step(conf_of(True), batch)
    ref16_losses, ref16, l16p = fresh_step(conf_of(True), batch, plain_norms())
    kernel = {k: rel_l2(grads16[k], ref_grads[k]) for k in keys}
    plain = {k: rel_l2(ref16[k], ref_grads[k]) for k in keys}
    ratio = statistics.median(kernel[k] / plain[k] for k in keys)
    loss_err16 = {k: abs(losses16[k] - ref16_losses[k]) / abs(ref16_losses[k])
                  for k in ref16_losses}
    controls = {}
    if bf16_controls:
        for kind in ("reversed", "float64"):
            grads_c = fresh_step(conf_of(True), batch, plain_reordered(kind))[1]
            err_c = {k: rel_l2(grads_c[k], ref_grads[k]) for k in keys}
            controls[kind] = {"worst": max(err_c.items(), key=lambda kv: kv[1]),
                              "by_network": net_rel_l2(grads_c, ref_grads)}
    rec = {"phase": f"{label}_grad_check", "dtype": "bfloat16", "losses": losses16,
           "loss_rel_err_vs_plain": loss_err16, "loss_rtol": TRAIN_BF16_LOSS_RTOL,
           "grad_vs_fp32_kernel_by_network": net_rel_l2(grads16, ref_grads),
           "grad_vs_fp32_plain_by_network": net_rel_l2(ref16, ref_grads),
           "grad_vs_fp32_kernel_max": max(kernel.values()),
           "grad_vs_fp32_plain_max": max(plain.values()),
           "grad_vs_fp32_median_ratio": ratio, "grad_ratio_tol": TRAIN_BF16_GRAD_RATIO,
           "grad_vs_fp32_kernel_worst": max(kernel.items(), key=lambda kv: kv[1]),
           "grad_vs_fp32_plain_worst": max(plain.items(), key=lambda kv: kv[1]),
           "plain_controls": controls, "launches": l16}
    emit(rec)
    check(max(loss_err16.values()) <= TRAIN_BF16_LOSS_RTOL, rec)
    check(ratio <= TRAIN_BF16_GRAD_RATIO, rec)
    worst_plain = max([rec["grad_vs_fp32_plain_max"]]
                      + [c["worst"][1] for c in controls.values()])
    check(rec["grad_vs_fp32_kernel_max"] <= TRAIN_BF16_GRAD_RATIO * worst_plain, rec)
    for net, dist in rec["grad_vs_fp32_kernel_by_network"].items():
        if controls:
            farthest = max([rec["grad_vs_fp32_plain_by_network"][net]]
                           + [c["by_network"][net] for c in controls.values()])
            check(dist <= TRAIN_BF16_GRAD_RATIO * farthest, rec)
    check(l16 == launches_per_step and sum(l16p.values()) == 0, rec)
    return [launches, launches_r, l16]


def pix2pix_serve(root, data_root, out_dir, load_iter):
    """From the run's last checkpoint: the `Tester` and `Inferer.run()` over
    the validation folder, then a deployment `Inferer`'s `infer` against the
    plain norms. Returns the main path's launches."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    from ganslate_tpu_torch.engines.inferer import Inferer
    from ganslate_tpu_torch.ops import instance_norm as inorm
    raw = pix2pix_raw(out_dir, data_root, load_iter=load_iter)
    shape = (PIX2PIX_VAL_PAIRS, *PIX2PIX_SIZE, 3)
    want = {k: PIX2PIX_VAL_PAIRS * v for k, v in PIX2PIX_G_LAUNCHES.items()}
    launches = []

    inorm.reset_launches()
    tester, entry = engine("test", raw, root)
    metrics = {}
    log_samples = tester.tracker.log_samples

    def keep_metrics(*args, **kwargs):
        for m in tester.tracker.metrics:
            for name, values in m.items():
                metrics.setdefault(name, []).extend(values)
        return log_samples(*args, **kwargs)

    tester.tracker.log_samples = keep_metrics
    t0 = time.perf_counter()
    tester.run()
    launches.append(dict(inorm.LAUNCHES))
    rec = {"phase": "pix2pix_test", "entry": entry, "load_iter": load_iter,
           "run_s": time.perf_counter() - t0,
           "metrics_mean": {k: statistics.fmean(v) for k, v in metrics.items()},
           "launches": launches[-1]}
    emit(rec)
    check(metrics and all(len(v) == PIX2PIX_VAL_PAIRS and all(math.isfinite(x) for x in v)
                          for v in metrics.values()), rec)
    check(launches[-1] == want, rec)
    del tester
    gc.collect()

    inorm.reset_launches()
    inferer, entry = engine("infer", raw, root)
    outputs = []
    save = inferer.save_generated_tensor

    def keep(generated_tensor, **kwargs):
        outputs.append(np.array(generated_tensor))
        return save(generated_tensor=generated_tensor, **kwargs)

    inferer.save_generated_tensor = keep
    t0 = time.perf_counter()
    inferer.run()
    launches.append(dict(inorm.LAUNCHES))
    out = np.concatenate(outputs)
    rec = {"phase": "pix2pix_infer_run", "entry": entry, "run_s": time.perf_counter() - t0,
           "shape": list(out.shape), "dtype": str(out.dtype), "out_min": float(out.min()),
           "out_max": float(out.max()), "out_std": float(out.std()), "launches": launches[-1]}
    emit(rec)
    check(out.shape == shape and out.dtype == np.float32 and bool(np.isfinite(out).all())
          and -1 <= rec["out_min"] <= rec["out_max"] <= 1 and rec["out_std"] > 1e-3, rec)
    check(launches[-1] == want, rec)
    x = inferer.data_loader.dataset[0]["A"][None]
    del inferer
    gc.collect()

    raw["infer"] = {"is_deployment": True, "wire_dtype": "bfloat16",
                    "checkpointing": {"load_iter": load_iter}}
    deployed = Inferer(init_config(Conf.create(raw), Config))
    inorm.reset_launches()
    t0 = time.perf_counter()
    y = deployed.infer(x)
    latency_ms = (time.perf_counter() - t0) * 1e3
    launches.append(dict(inorm.LAUNCHES))
    with plain_norms():
        inorm.reset_launches()
        ref = deployed.infer(x)
        check(sum(inorm.LAUNCHES.values()) == 0, "the plain run launched a kernel")
    err = (y.float() - ref.float()).abs()
    rec = {"phase": "pix2pix_serve", "latency_ms_first_call": latency_ms,
           "max_abs_err_vs_plain": float(err.max()), "mean_abs_err_vs_plain": float(err.mean()),
           "tol_max": SLICE_BF16_MAX, "tol_mean": SLICE_BF16_MEAN, "launches": launches[-1]}
    sw_output_check(rec, y, (1, *PIX2PIX_SIZE, 3))
    emit(rec)
    check(launches[-1] == PIX2PIX_G_LAUNCHES, rec)
    check(rec["max_abs_err_vs_plain"] <= SLICE_BF16_MAX, rec)
    check(rec["mean_abs_err_vs_plain"] <= SLICE_BF16_MEAN, rec)
    del deployed
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def hx4_patches(n, seed):
    """`n` batches of 1 of HX4-shaped patches from `seed`: A two smooth
    random fields of (32, 128, 128) (the FDG-PET and CT channels), B one,
    in [-1, 1]."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    rng = np.random.default_rng(seed)

    def fields(c):
        coarse = rng.normal(size=(1, c, *(d // 8 for d in HX4_PATCH))).astype(np.float32)
        f = F.interpolate(torch.from_numpy(coarse), size=HX4_PATCH, mode="trilinear",
                          align_corners=False)
        return torch.tanh(f).permute(0, 2, 3, 4, 1).contiguous().numpy()

    return [{"A": fields(2), "B": fields(1)} for _ in range(n)]


def hx4_phase(out_dir):
    """The HX4 PET Pix2Pix's networks at full width, model-level: timed
    bf16 steps through `build_gan` -> `setup` -> `optimize_parameters`
    (step ms, peak memory, finite losses, the norm launches of every step),
    then one G forward against the plain norms. Returns the launches of its
    steps and its forward."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    from ganslate_tpu_torch.utils.builders import build_gan
    from ganslate_tpu_torch.utils.testing import make_pix2pix_conf
    t0 = time.perf_counter()
    conf = make_pix2pix_conf(str(out_dir), seed=1, **HX4_NETS)
    batches = hx4_patches(2, SEED + 60)
    model = build_gan(conf)
    model.setup(batches[0])
    n_params = {name: sum(p.numel() for p in net.parameters())
                for name, net in model.networks.items()}
    device_batches = [{k: torch.from_numpy(v).to(model.device) for k, v in b.items()}
                      for b in batches]
    steps, launches = model_steps(model, device_batches, "hx4", HX4_STEPS)
    x = device_batches[0]["A"]
    inorm.reset_launches()
    y = model.infer(x)
    launches.append(dict(inorm.LAUNCHES))
    with plain_norms():
        inorm.reset_launches()
        ref = model.infer(x)
        check(sum(inorm.LAUNCHES.values()) == 0, "the plain run launched a kernel")
    err = (y - ref).abs()
    rec = {"phase": "hx4_steps", "parameters": n_params, "patch": list(HX4_PATCH), **steps,
           "images_per_s": 1e3 / steps["median_step_ms"],
           "forward_max_abs_err_vs_plain": float(err.max()),
           "forward_mean_abs_err_vs_plain": float(err.mean()),
           "tol_max": SW_BF16_MAX, "tol_mean": SW_BF16_MEAN, "forward_launches": launches[-1],
           "seconds": time.perf_counter() - t0}
    emit(rec)
    check(n_params == HX4_PARAMS, n_params)
    check(steps["losses_finite"] and all(s == HX4_LAUNCHES for s in launches[:-1]), rec)
    check(launches[-1] == HX4_G_LAUNCHES, rec)
    check(tuple(y.shape) == (1, *HX4_PATCH, 1) and bool(torch.isfinite(y).all()), rec)
    check(rec["forward_max_abs_err_vs_plain"] <= SW_BF16_MAX
          and rec["forward_mean_abs_err_vs_plain"] <= SW_BF16_MEAN, rec)
    del model, device_batches, y, ref
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def pix2pix_phase(root):
    """Phase 9; returns the norm launches of its main path (the Trainer run,
    the serving from its checkpoint and the HX4 steps)."""
    import importlib.util
    import torch
    t0 = time.perf_counter()
    allocated = torch.cuda.memory_allocated()
    check(importlib.util.find_spec("PIL") is not None,
          "the pix2pix phase reads PNG folders through Pillow")
    data_root = root / "pix2pix_data"
    write_pix2pix_data(data_root)
    batches = pix2pix_batches(pix2pix_conf(root / "pix2pix_conf", data_root), 4, SEED + 53)
    emit({"phase": "pix2pix_data", "seconds": time.perf_counter() - t0,
          "train_pairs": PIX2PIX_TRAIN_PAIRS, "val_pairs": PIX2PIX_VAL_PAIRS,
          "batch_shapes": {k: list(v.shape) for k, v in batches[0].items()}})
    launches, load_iter, out_dir, run, steps, dropout, flops, profile = \
        pix2pix_train_run(root, data_root, batches)
    totals = dict(launches)
    for step in pix2pix_serve(root, data_root, out_dir, load_iter):
        for k, v in step.items():
            totals[k] += v
    other = [pix2pix_loader_check(root, data_root, run)]
    # Inert biases: the convs before a norm, one for each norm of G and D.
    other += kernel_vs_plain_steps(
        "pix2pix", lambda mp: pix2pix_conf(root / "pix2pix_check", data_root, mixed_precision=mp),
        batches[0], PIX2PIX_LAUNCHES,
        sum(PIX2PIX_G_LAUNCHES.values()) + sum(PIX2PIX_D_LAUNCHES.values()))
    hx4 = hx4_phase(root / "hx4")
    for step in hx4:
        for k, v in step.items():
            totals[k] += v

    fam = profile["device_ms_per_step_by_family"]
    conv_ms = sum(fam.get(f, 0.0) for f in ("conv_forward", "conv_dgrad", "conv_wgrad",
                                            "conv_backward_other"))
    left = torch.cuda.memory_allocated() - allocated
    rec = {"phase": "pix2pix_summary", "seconds": time.perf_counter() - t0,
           "images_per_s_trainer": run["images_per_s"], "model_steps": steps,
           "conv_gflop": {k: v / 1e9 for k, v in flops.items()},
           "conv_tflop_per_s": flops["step"] / (conv_ms * 1e-3) / 1e12
           if conv_ms else "not measured",
           "profile": profile, "dropout": dropout, "launches_main_path": totals,
           "launches_whole_phase": {k: totals[k] + sum(s[k] for s in other) for k in totals},
           "device_bytes_left_allocated": left}
    emit(rec)
    check(profile["device_busy_ms_per_step"] != "not measured"
          and fam.get("norm_kernels", 0) > 0 and fam.get("dropout", 0) > 0,
          "the profile saw no norm kernel or no dropout")
    check(left < 2 ** 28, f"the pix2pix phase left {left} bytes allocated on the device")
    return totals


# ------------------------------------------------------------ phase 10


def cut_norm_launches(g, taps, d):
    """Norm launches of `g` generator passes, `taps` tap passes and `d`
    discriminator passes of the BRaTS CUT."""
    return {k: g * CUT_G_LAUNCHES[k] + taps * CUT_TAP_LAUNCHES[k] + d * CUT_D_LAUNCHES[k]
            for k in CUT_G_LAUNCHES}


def cut_raw(out_dir, mixed_precision=True, load_iter=None, run=None):
    """The BRaTS CUT experiment as a raw config tree, field for field, with
    the run's cut loop lengths and frequencies (`run`: iterations,
    logging.freq, checkpointing.freq, val.freq; `CUT_RUN`'s by default), a
    seed and the datasets' roots on the NIfTI root (`CUT_LEFT_OUT`); an
    infer section over the validation volume serves checkpoint
    `load_iter`."""
    if run is None:
        warm, timed, *freqs = CUT_RUN
        run = (warm + timed, *freqs)
    n_iters, log_freq, ckpt_freq, val_freq = run
    train_dataset, val_dataset = brats_datasets()
    raw = {
        "project": str(BRATS_PROJECT),
        "train": {
            "output_dir": str(out_dir), "cuda": True,
            "n_iters": n_iters - n_iters // 2, "n_iters_decay": n_iters // 2,
            "batch_size": 1, "mixed_precision": mixed_precision, "seed": SEED + 70,
            "logging": {"freq": log_freq},
            "checkpointing": {"freq": ckpt_freq},
            "dataset": train_dataset,
            "gan": {
                "_target_": "ganslate.nn.gans.unpaired.CUT",
                "nce_layers": [0, 1, 2, 3],
                "generator": {"_target_": "ganslate.nn.generators.Vnet3D",
                              "use_memory_saving": False, "use_inverse": False,
                              "in_out_channels": {"AB": [1, 1]},
                              "down_blocks": [2, 2, 3], "up_blocks": [3, 3, 3]},
                "discriminator": {"_target_": "ganslate.nn.discriminators.PatchGAN3D",
                                  "n_layers": 2, "in_channels": {"B": 1}},
                "optimizer": {"lr_D": 0.0002, "lr_G": 0.0004},
            },
        },
        "val": {"freq": val_freq, "dataset": val_dataset,
                "sliding_window": {"window_size": "${train.dataset.patch_size}"},
                "metrics": {"cycle_metrics": False}},
    }
    if load_iter is not None:
        raw["infer"] = {"checkpointing": {"load_iter": load_iter}, "is_deployment": False,
                        "dataset": dict(val_dataset),
                        "sliding_window": {"window_size": list(REVGAN_PATCH)}}
    return raw


def cut_conf(out_dir, **kwargs):
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    return init_config(Conf.create(cut_raw(out_dir, **kwargs)), Config)


def logged_values(log, head):
    """{iteration: {name: value}} of the lines that follow the `head` lines
    of a training log (`(iter:` for the losses, `(Val at iter` for the
    validation metrics)."""
    import re
    found = re.findall(re.escape(head) + r" (\d+)\D[^\n]*\n([^\n]*)", log)
    return {int(i): {k: float(v) for k, v in re.findall(r"(\S+): (\S+)", line)}
            for i, line in found}


def cut_cli_run(root):
    """Run (a): `python -m ganslate_tpu_torch train config=<yaml>` in a
    subprocess, then `infer config=<yaml>` from its last checkpoint; the
    YAML written by the port's `Conf.to_yaml`. Checks the exit codes, the
    losses at every log, the validation metrics and the checkpoint's
    networks."""
    import os
    import torch
    n_iters, log_freq, ckpt_freq, val_freq = CUT_CLI_RUN
    out_dir = root / "cut_cli"
    conf = cut_conf(out_dir, run=CUT_CLI_RUN, load_iter=n_iters)
    path = root / "cut_cli.yaml"
    path.write_text(conf.to_yaml())
    here = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(here)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    records = {}
    for command in ("train", "infer"):
        argv = [sys.executable, "-m", "ganslate_tpu_torch", command, f"config={path}"]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=here, env=env, capture_output=True, text=True,
                              timeout=600)
        records[command] = {"argv": argv[1:], "returncode": proc.returncode,
                            "seconds": time.perf_counter() - t0}
        if proc.returncode:
            emit({"phase": "cut_cli", **records, "stderr_tail": proc.stderr[-4000:]})
            raise AssertionError(f"`{' '.join(argv[1:4])}` exited {proc.returncode}")
    log = (out_dir / "train_log.txt").read_text()
    losses = logged_values(log, "(iter:")
    metrics = logged_values(log, "(Val at iter")
    checkpoint = torch.load(out_dir / "checkpoints" / f"{n_iters}.pth", map_location="cpu",
                            weights_only=True)
    infer_log = (out_dir / "infer_log.txt").read_text()
    rec = {"phase": "cut_cli", **records, "yaml": path.name, "iterations": n_iters,
           "cuts": {"from": CUT_YAML_LENGTHS, "left_out": CUT_LEFT_OUT,
                    "to": {"n_iters": conf.train.n_iters, "n_iters_decay":
                           conf.train.n_iters_decay, "logging.freq": log_freq,
                           "checkpointing.freq": ckpt_freq, "val.freq": val_freq}},
           "losses_at_logs": losses, "validation_metrics": metrics,
           "checkpoint_keys": sorted(checkpoint),
           "inference_done": "Inference started." in infer_log}
    emit(rec)
    check(sorted(losses) == list(range(log_freq, n_iters + 1, log_freq))
          and all(sorted(v) == ["D", "G", "NCE", "NCE_idt"] for v in losses.values())
          and all(math.isfinite(x) for v in losses.values() for x in v.values()),
          f"the logged losses: {losses}")
    check(sorted(metrics) == list(range(val_freq, n_iters + 1, val_freq))
          and all(v and all(math.isfinite(x) for x in v.values()) for v in metrics.values()),
          f"the validation metrics: {metrics}")
    check({"G", "D", "mlp", "optimizer_mlp"} <= set(checkpoint), rec["checkpoint_keys"])
    check(rec["inference_done"], "the infer command did not run the Inferer")
    return rec


def cut_family(chain, kernel):
    """`pix2pix_family`, with the NCE work as a family of its own: the patch
    draws, gathers, MLP and loss (host ranges `nce`) and their backward
    nodes (linear layers, the batched product, log-softmax, the diagonal's
    fill, the gathers' scatter, the MLP's ReLU and the L2 normalisation,
    which the V-Net and PatchGAN3D do not use)."""
    if "nce" in chain:
        return "nce"
    node = next((n.split(": ", 1)[1] for n in chain
                 if n.startswith("autograd::engine::evaluate_function: ")), "")
    if node.startswith(CUT_NCE_BACKWARD):
        return "nce"
    return pix2pix_family(chain, kernel)


def label_nce(model):
    """Mark the NCE work of `model`'s train step with `nce` ranges."""
    from ganslate_tpu_torch.nn.gans.unpaired import cut
    for name in ("draw_patch_ids", "select_patches"):
        setattr(cut, name, Labelled(getattr(cut, name), "nce"))
    mlp = model.networks["mlp"]
    mlp.forward = Labelled(mlp.forward, "nce")
    model.criterion_nce = Labelled(model.criterion_nce, "nce")


@contextlib.contextmanager
def unlabelled_nce():
    from ganslate_tpu_torch.nn.gans.unpaired import cut
    saved = cut.draw_patch_ids, cut.select_patches
    try:
        yield
    finally:
        cut.draw_patch_ids, cut.select_patches = saved


def cut_conv_flops(model):
    """Conv FLOPs (`conv_flops`) of one Vnet3D pass, of its tap pass and of
    one PatchGAN3D pass at batch 1, and of a train step: 2 G passes
    (fake_B, idt_B) and 2 tap passes (the targets) forward and backward (the
    backward counted as twice the forward), 2 tap passes forward only (the
    sources, without a graph), D on fake_B with its data gradient in the G
    step, and D at batch 2 (real and fake) forward and backward."""
    import torch
    g, d = model.networks["G"], model.networks["D"]
    x = torch.zeros((1, 1, *REVGAN_PATCH), device=model.device)
    g_pass = sum(conv_flops(g, x).values())
    tap = sum(conv_flops(g, x, extract_features=list(model.nce_layers)).values())
    d_pass = sum(conv_flops(d, x).values())
    return {"g_pass": g_pass, "tap_pass": tap, "d_pass": d_pass,
            "step": 2 * 3 * g_pass + 2 * 3 * tap + 2 * tap + 2 * d_pass + 2 * 3 * d_pass}


def cut_train_run(root, batches):
    """Run (b): the same experiment from `init_engine("train")` through
    `run()` in this process (`trainer_run`); then model-level steps, conv
    FLOPs and the profile on its model. Returns the run's norm launches,
    its last checkpoint and output directory, and the records."""
    import numpy as np
    import torch
    warm, timed, _, _, val_freq = CUT_RUN
    n_iters = warm + timed
    out_dir = root / "cut"
    windows = sw_windows(REVGAN_VOLUME[1:], REVGAN_PATCH)
    want = {k: n_iters * CUT_LAUNCHES[k] + n_iters // val_freq * windows * CUT_G_LAUNCHES[k]
            for k in CUT_LAUNCHES}
    rec, model = trainer_run(root, cut_raw(out_dir), "cut", CUT_RUN, want, "patches",
                             dataset="synthetic BRaTS NIfTI scans, the project twin",
                             cuts={"from": CUT_YAML_LENGTHS, "left_out": CUT_LEFT_OUT},
                             validation_windows_per_volume=windows)
    check(rec["parameters"] == CUT_PARAMS, rec["parameters"])
    check(all(sorted(v) == ["D", "G", "NCE", "NCE_idt"] for v in rec["losses_at_logs"].values()),
          rec["losses_at_logs"])
    check(not any(k.startswith("cycle") for k in rec["validation_metrics"]),
          rec["validation_metrics"])
    device_batches = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(model.device)
                       for k, v in b.items()} for b in batches]
    steps, step_launches = model_steps(model, device_batches, "brats_cut", CUT_MODEL_STEPS)
    steps["plain_iteration_over_step"] = rec["plain_iteration_ms"]["median"] \
        / steps["median_step_ms"]
    steps["patches_per_s"] = 1e3 / steps["median_step_ms"]
    check(steps["losses_finite"] and all(s == CUT_LAUNCHES for s in step_launches),
          f"model-level steps: {steps}, launches {step_launches}")
    flops = cut_conv_flops(model)
    with unlabelled_nce():
        label_nce(model)
        profile = profile_steps(model, device_batches, CUT_PROFILED_STEPS, cut_family,
                                PIX2PIX_RANGES + ("nce",))
    del model, device_batches
    gc.collect()
    torch.cuda.empty_cache()
    return (rec["launches"], rec["checkpoints"][-1], out_dir, rec, steps, step_launches, flops,
            profile)


def cut_serve(root, out_dir, load_iter):
    """Run (d): `init_engine("infer")` (not a deployment) from run (b)'s
    last checkpoint: `run()` over the validation volume through the sliding
    window, then `infer` AB on it, with the kernels and with the plain
    norms; `infer` BA raises. Returns the main path's launches."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    raw = cut_raw(out_dir, load_iter=load_iter)
    inferer, entry = engine("infer", raw, root)
    check(list(inferer.model.networks) == ["G"], list(inferer.model.networks))
    outputs = []
    save = inferer.save_generated_tensor

    def keep(generated_tensor, **kwargs):
        outputs.append(np.array(generated_tensor))
        return save(generated_tensor=generated_tensor, **kwargs)

    inferer.save_generated_tensor = keep
    windows = sw_windows(REVGAN_VOLUME[1:], REVGAN_PATCH)
    want = {k: windows * v for k, v in CUT_G_LAUNCHES.items()}
    inorm.reset_launches()
    t0 = time.perf_counter()
    inferer.run()
    run_s = time.perf_counter() - t0
    launches = [dict(inorm.LAUNCHES)]
    out = np.concatenate(outputs)
    shape = (1, *REVGAN_VOLUME[1:], 1)
    rec = {"phase": "cut_infer_run", "entry": entry, "load_iter": load_iter,
           "shape": list(out.shape), "dtype": str(out.dtype), "run_s": run_s,
           "out_min": float(out.min()), "out_max": float(out.max()),
           "out_std": float(out.std()), "launches": launches[0]}
    emit(rec)
    check(out.shape == shape and bool(np.isfinite(out).all())
          and -1 <= rec["out_min"] <= rec["out_max"] <= 1 and rec["out_std"] > 1e-3, rec)
    check(launches[0] == want, rec)

    x = inferer.data_loader.dataset[0]["A"][None]
    inorm.reset_launches()
    t0 = time.perf_counter()
    y = inferer.infer(x)
    latency_ms = (time.perf_counter() - t0) * 1e3
    launches.append(dict(inorm.LAUNCHES))
    with plain_norms():
        inorm.reset_launches()
        ref = inferer.infer(x)
        check(sum(inorm.LAUNCHES.values()) == 0, "the plain run launched a kernel")
    err = (y.float() - ref.float()).abs()
    rec = {"phase": "cut_serve", "direction": "AB", "latency_ms": latency_ms,
           "windows": windows, "launches": launches[-1],
           "max_abs_err_vs_plain": float(err.max()), "mean_abs_err_vs_plain": float(err.mean()),
           "tol_max": SW_BF16_MAX, "tol_mean": SW_BF16_MEAN}
    sw_output_check(rec, y, shape)
    try:
        inferer.model.infer(torch.from_numpy(x), direction="BA")
        rec["ba_raises"] = False
    except ValueError as e:
        rec["ba_raises"] = str(e)
    emit(rec)
    check(launches[-1] == want, rec)
    check(rec["max_abs_err_vs_plain"] <= SW_BF16_MAX, rec)
    check(rec["mean_abs_err_vs_plain"] <= SW_BF16_MEAN, rec)
    check(rec["ba_raises"], "infer BA of a CUT did not raise")
    del inferer, y, ref, err
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def cut2d_launches(idt):
    """Norm launches of one 2D CUT step at 256x256: G passes (fake_B, and
    idt_B under identity NCE) of 19 one-pass and 4 split norms; tap passes
    up to tap 16 (the stem and down0 norms split, down1's and 7 residual
    blocks' one-pass), 2 for NCE and 2 more for identity NCE; PatchGAN2D's
    3 one-pass norms in the D step (real and fake in one forward) and on
    fake_B in the G step."""
    g, taps = (2, 4) if idt else (1, 2)
    return {"onepass": 19 * g + 15 * taps + 3 * 2, "split": 4 * g + 2 * taps}


def cut2d_phase(out_dir):
    """(e) The 2D CUT and FastCUT at the CUT paper's width, model-level:
    timed bf16 steps through `build_gan` -> `setup` ->
    `optimize_parameters` (step ms, peak memory, finite losses, the norm
    launches of every step, the flips drawn), and one tap call at index 8
    (down1's norm before its ReLU) with the kernels' launches recorded.
    Returns the launches of its steps and tap calls."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.nn.gans.unpaired import cut
    from ganslate_tpu_torch.ops import instance_norm as inorm
    from ganslate_tpu_torch.utils.builders import build_gan
    from ganslate_tpu_torch.utils.testing import make_cut_conf
    rng = np.random.default_rng(SEED + 80)
    batches = [{k: rng.uniform(-1, 1, (1, CUT2D_SIZE, CUT2D_SIZE, 3)).astype(np.float32)
                for k in ("A", "B")} for _ in range(2)]
    all_launches, records = [], {}
    for label, kw in CUT2D_CONFIGS.items():
        t0 = time.perf_counter()
        conf = make_cut_conf(str(out_dir / label), patch=(CUT2D_SIZE, CUT2D_SIZE), seed=2,
                             **CUT2D_NETS, **kw)
        model = build_gan(conf)
        model.setup(batches[0])
        n_params = {name: sum(p.numel() for p in net.parameters())
                    for name, net in model.networks.items()}
        device_batches = [{k: torch.from_numpy(v).to(model.device) for k, v in b.items()}
                          for b in batches]
        flips = []
        draw_flip = cut.draw_flip

        def record_flip(generator):
            flips.append(draw_flip(generator))
            return flips[-1]

        cut.draw_flip = record_flip
        try:
            steps, launches = model_steps(model, device_batches, label, CUT2D_STEPS)
        finally:
            cut.draw_flip = draw_flip
        idt = kw["lambda_nce_idt"] > 0
        rec = {"phase": "cut2d_steps", "parameters": n_params, "size": CUT2D_SIZE, **steps,
               "images_per_s": 1e3 / steps["median_step_ms"],
               "nce_layers": list(model.nce_layers),
               "mlp_channels": list(model.feature_channels()),
               "flips": [bool(f) for f in flips], "launches_expected": cut2d_launches(idt),
               "seconds": time.perf_counter() - t0}
        if label == "cut":
            calls = []
            kernels = dict(inorm.KERNELS)

            def recording(name):
                def launch(x, eps, activation, negative_slope):
                    calls.append([name, list(x.shape), activation])
                    return kernels[name](x, eps, activation, negative_slope)
                return launch

            inorm.KERNELS.update({name: recording(name) for name in kernels})
            inorm.reset_launches()
            try:
                with torch.no_grad():
                    tap = model.apply("G", device_batches[0]["A"], model.compute_params(["G"]),
                                      extract_features=[8])[0]
                torch.cuda.synchronize()
            finally:
                inorm.KERNELS.update(kernels)
            launches.append(dict(inorm.LAUNCHES))
            rec["tap8"] = {"shape": list(tap.shape), "dtype": str(tap.dtype),
                           "min": float(tap.min()), "kernel_calls": calls,
                           "launches": launches[-1]}
            # The stem's, down0's and down1's norms, each before its ReLU.
            width = CUT2D_SIZE // 4
            check(len(calls) == 3 and all(c[2] == "none" for c in calls)
                  and calls[-1][1] == [1, width, width, 4 * CUT2D_NETS["generator"]["ngf"]]
                  and float(tap.min()) < 0, rec["tap8"])
        emit(rec)
        check(n_params["G"] == CUT2D_PARAMS["G"] and n_params["D"] == CUT2D_PARAMS["D"],
              n_params)
        check(steps["losses_finite"]
              and all(s == cut2d_launches(idt) for s in launches[:sum(CUT2D_STEPS)]), rec)
        check(not kw["use_equivariance_flip"] or (any(rec["flips"]) and not all(rec["flips"])),
              f"the flip was not both taken and not taken: {rec['flips']}")
        records[label] = rec
        all_launches += launches
        del model, device_batches
        gc.collect()
        torch.cuda.empty_cache()
    return all_launches, records


def cut_phase(root):
    """Phase 10; returns the norm launches of its main path (the measured
    Trainer run and the serving from its checkpoint) and of the 2D CUT's
    (its steps and tap call)."""
    import torch
    t0 = time.perf_counter()
    allocated = torch.cuda.memory_allocated()
    batches = brats_batches(cut_conf(root / "cut_data"))[0]
    cli = cut_cli_run(root)
    launches, load_iter, out_dir, run, steps, step_launches, flops, profile = \
        cut_train_run(root, batches)
    totals = dict(launches)
    for step in cut_serve(root, out_dir, load_iter):
        for k, v in step.items():
            totals[k] += v
    other = list(step_launches)
    # Inert biases: the convs before a norm, one for each norm of G and D.
    other += kernel_vs_plain_steps(
        "cut", lambda mp: cut_conf(root / "cut_check", mixed_precision=mp), batches[0],
        CUT_LAUNCHES, sum(CUT_G_LAUNCHES.values()) + sum(CUT_D_LAUNCHES.values()))
    launches_2d, records_2d = cut2d_phase(root / "cut2d")
    totals_2d = {k: sum(s[k] for s in launches_2d) for k in totals}

    fam = profile["device_ms_per_step_by_family"]
    conv_ms = sum(fam.get(f, 0.0) for f in ("conv_forward", "conv_dgrad", "conv_wgrad",
                                            "conv_backward_other"))
    left = torch.cuda.memory_allocated() - allocated
    rec = {"phase": "cut_summary", "seconds": time.perf_counter() - t0,
           "cli_seconds": {k: cli[k]["seconds"] for k in ("train", "infer")},
           "patches_per_s_trainer": run["patches_per_s"], "model_steps": steps,
           "conv_gflop": {k: v / 1e9 for k, v in flops.items()},
           "conv_tflop_per_s": flops["step"] / (conv_ms * 1e-3) / 1e12
           if conv_ms else "not measured",
           "profile": profile, "launches_main_path": totals,
           "launches_whole_phase": {k: totals[k] + sum(s[k] for s in other) for k in totals},
           "launches_cut2d": totals_2d,
           "cut2d_median_step_ms": {k: r["median_step_ms"] for k, r in records_2d.items()},
           "device_bytes_left_allocated": left}
    emit(rec)
    check(profile["device_busy_ms_per_step"] != "not measured"
          and fam.get("norm_kernels", 0) > 0 and fam.get("nce", 0) > 0,
          "the profile saw no norm kernel or no NCE work")
    check(left < 2 ** 28, f"the cut phase left {left} bytes allocated on the device")
    return totals, totals_2d


# ------------------------------------------------------------ phase 11


def brats_cyclegan_args(yaml_name, run, mixed_precision=None):
    """`init_engine`'s arguments for the BRaTS experiment `yaml_name`: the
    YAML and only this phase's overrides (the datasets' roots on the NIfTI
    root, the loop lengths and frequencies of `run`, a seed, `logging.wandb`
    off); with `mixed_precision`, that too (the kernel-vs-plain step's
    fp32 run)."""
    warm, timed, log_freq, ckpt_freq, val_freq = run
    n_iters = warm + timed
    args = [f"config={BRATS_PROJECT / 'experiments' / yaml_name}",
            f"train.dataset.root={brats_root('train')}", f"val.dataset.root={brats_root('val')}",
            f"train.n_iters={n_iters - n_iters // 2}", f"train.n_iters_decay={n_iters // 2}",
            f"train.logging.freq={log_freq}", f"train.checkpointing.freq={ckpt_freq}",
            f"val.freq={val_freq}", f"train.seed={SEED + 90}", "train.logging.wandb=null"]
    if mixed_precision is not None:
        args.append(f"train.mixed_precision={str(mixed_precision).lower()}")
    return args


def brats_cyclegan_conf(yaml_name, mixed_precision=None):
    from ganslate_tpu_torch.utils.builders import build_conf
    return build_conf(brats_cyclegan_args(yaml_name, BRATS_CYCLEGAN_RUN, mixed_precision))


@contextlib.contextmanager
def experiment_workdir(root):
    """Run inside `root/work`, where `projects` links to this checkout's
    `projects/`: the experiment YAMLs' relative `project:` names the repo's
    project directory (which the port's config loader swaps for its twin),
    and their relative `output_dir` lands in the temporary tree."""
    work = root / "work"
    work.mkdir(parents=True, exist_ok=True)
    link = work / "projects"
    if not link.exists():
        link.symlink_to(HERE / "projects", target_is_directory=True)
    with contextlib.chdir(work):
        yield work


def brats_cyclegan_family(chain, kernel):
    """`revgan_family`, with PReLU (its forward and its backward node) as a
    family of its own."""
    if any("prelu" in n.lower() for n in chain):
        return "prelu"
    return revgan_family(chain, kernel)


def brats_cyclegan_conv_flops(model):
    """Conv FLOPs (`conv_flops`) of one Vnet3D pass and one PatchGAN3D pass
    at batch 1, and of a train step: 4 G passes forward and backward (the
    backward counted as twice the forward), 2 D passes with input gradients
    in the G step, and 2 Ds on real and fake with a full backward in the D
    step."""
    import torch
    x = torch.zeros((1, 1, *REVGAN_PATCH), device=model.device)
    g_pass = sum(conv_flops(model.networks["G_AB"], x).values())
    d_pass = sum(conv_flops(model.networks["D_B"], x).values())
    return {"g_pass": g_pass, "d_pass": d_pass,
            "step": 4 * 3 * g_pass + 2 * 2 * d_pass + 4 * 3 * d_pass}


def brats_val_source(conf):
    """The validation scan's source sequence, (1, 155, 240, 240, 1), read
    by the config's validation dataset (the project twin's
    `BratsValTestDataset`)."""
    import copy
    from ganslate_tpu_torch.utils.io import import_attr
    val_conf = copy.deepcopy(conf)
    val_conf.mode = "val"
    return import_attr(conf.val.dataset._target_)(val_conf)[0]["A"][None]


def brats_cyclegan_serve(out_dir, load_iter, x):
    """The checkpoint's `G_AB` served by a deployment `Inferer` through the
    sliding window (`make_vnet_conf`: windows of (32, 176, 176), 28 a call,
    overlap 0.25, gaussian, bf16) on the validation scan's source `x`, with
    the kernels and with the plain norms. Returns the kernel request's
    launches."""
    import torch
    from ganslate_tpu_torch.engines.inferer import Inferer
    from ganslate_tpu_torch.ops import instance_norm as inorm
    from ganslate_tpu_torch.utils.testing import make_vnet_conf
    inferer = Inferer(make_vnet_conf(str(out_dir), load_iter=load_iter))
    check(list(inferer.model.networks) == ["G_AB"], list(inferer.model.networks))
    inferer.infer(x)                            # warm
    inorm.reset_launches()
    t0 = time.perf_counter()
    y = inferer.infer(x)
    latency_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(inorm.LAUNCHES)
    with plain_norms():
        inorm.reset_launches()
        ref = inferer.infer(x)
        check(sum(inorm.LAUNCHES.values()) == 0, "the plain run launched a kernel")
    err = (y.float() - ref.float()).abs()
    rec = {"phase": "brats_cyclegan_serve", "load_iter": load_iter, "latency_ms": latency_ms,
           "windows": sw_windows(REVGAN_VOLUME[1:], REVGAN_PATCH), "launches": launches,
           "max_abs_err_vs_plain": float(err.max()), "mean_abs_err_vs_plain": float(err.mean()),
           "tol_max": SW_BF16_MAX, "tol_mean": SW_BF16_MEAN}
    sw_output_check(rec, y, x.shape)
    emit(rec)
    check(launches == CUT_G_LAUNCHES, rec)
    check(rec["max_abs_err_vs_plain"] <= SW_BF16_MAX, rec)
    check(rec["mean_abs_err_vs_plain"] <= SW_BF16_MEAN, rec)
    del inferer, y, ref, err
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def brats_cyclegan_s2d_check(batch):
    """One step of `cyclegan_s2d.yaml` against one of `cyclegan.yaml` from
    the same seed and batch (deterministic algorithms, bf16 as the YAMLs
    set): `use_s2d_exec` runs the plain computation, so the losses and
    gradients are the same bits. Returns the launches of both steps."""
    import torch
    saved = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        conf = brats_cyclegan_conf("cyclegan.yaml")
        conf_s2d = brats_cyclegan_conf("cyclegan_s2d.yaml")
        check(conf_s2d.train.gan.generator.use_s2d_exec
              and not conf.train.gan.generator.use_s2d_exec,
              "the s2d YAML does not set use_s2d_exec")
        losses, grads, launches = fresh_step(conf, batch)
        losses_s2d, grads_s2d, launches_s2d = fresh_step(conf_s2d, batch)
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])
    diff = {k: float((grads[k].float() - grads_s2d[k].float()).abs().max())
            for k in grads if grads[k] is not None}
    rec = {"phase": "brats_cyclegan_s2d_check", "losses": losses, "losses_s2d": losses_s2d,
           "grad_max_abs_diff": max(diff.values()), "launches": launches,
           "launches_s2d": launches_s2d}
    emit(rec)
    check(losses == losses_s2d, rec)
    check(rec["grad_max_abs_diff"] == 0.0, rec)
    check(launches == launches_s2d == BRATS_CYCLEGAN_LAUNCHES, rec)
    return [launches, launches_s2d]


def brats_cyclegan_phase(root):
    """Phase 11; returns the norm launches of its main path (the Trainer run
    from `cyclegan.yaml` and the serving of its checkpoint's G_AB)."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    allocated = torch.cuda.memory_allocated()
    warm, timed, _, _, val_freq = BRATS_CYCLEGAN_RUN
    n_iters = warm + timed
    windows = sw_windows(REVGAN_VOLUME[1:], REVGAN_PATCH)
    cuts = {"from": BRATS_CYCLEGAN_YAML_LENGTHS,
            "left_out": {**REVGAN_LEFT_OUT,
                         "train.seed": "unset in the YAML (drawn) -> the script's seed",
                         "train.logging.wandb": "unset in the YAML; set off explicitly"}}
    with experiment_workdir(root):
        conf = brats_cyclegan_conf("cyclegan.yaml")
        batches, sample_s = brats_batches(conf)
        emit({"phase": "brats_cyclegan_data", "dataset": conf.train.dataset._target_,
              "num_workers": conf.train.dataset.num_workers, "sample_s": sample_s,
              "batch_shapes": {k: list(v.shape) for k, v in batches[0].items()}})
        args = brats_cyclegan_args("cyclegan.yaml", BRATS_CYCLEGAN_RUN)
        want = {k: n_iters * BRATS_CYCLEGAN_LAUNCHES[k]
                + n_iters // val_freq * 2 * windows * CUT_G_LAUNCHES[k]
                for k in BRATS_CYCLEGAN_LAUNCHES}
        rec, model = trainer_run(root, args, "brats_cyclegan", BRATS_CYCLEGAN_RUN, want,
                                 "patches", yaml=args[0].split("=", 1)[1],
                                 overrides=args[1:], cuts=cuts,
                                 dataset="synthetic BRaTS NIfTI scans, the project twin",
                                 validation_windows_per_volume=windows)
        out_dir = Path(model.conf.train.output_dir).resolve()
        check(rec["parameters"] == BRATS_CYCLEGAN_PARAMS, rec["parameters"])
        check("cycle_SSIM" in rec["validation_metrics"], rec["validation_metrics"])
        device_batches = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(model.device)
                           for k, v in b.items()} for b in batches]
        steps, step_launches = model_steps(model, device_batches, "brats_cyclegan",
                                           BRATS_CYCLEGAN_MODEL_STEPS)
        steps["plain_iteration_over_step"] = rec["plain_iteration_ms"]["median"] \
            / steps["median_step_ms"]
        steps["patches_per_s"] = 1e3 / steps["median_step_ms"]
        check(steps["losses_finite"]
              and all(s == BRATS_CYCLEGAN_LAUNCHES for s in step_launches),
              f"model-level steps: {steps}, launches {step_launches}")
        flops = brats_cyclegan_conv_flops(model)
        profile = profile_steps(model, device_batches, BRATS_CYCLEGAN_PROFILED_STEPS,
                                brats_cyclegan_family, ("losses", "metrics", "pool"))
        del model, device_batches
        gc.collect()
        torch.cuda.empty_cache()

        totals = dict(rec["launches"])
        x = brats_val_source(conf)
        for k, v in brats_cyclegan_serve(out_dir, rec["checkpoints"][-1], x).items():
            totals[k] += v
        other = list(step_launches)
        other += kernel_vs_plain_steps(
            "brats_cyclegan", lambda mp: brats_cyclegan_conf("cyclegan.yaml", mp), batches[0],
            BRATS_CYCLEGAN_LAUNCHES, BRATS_CYCLEGAN_INERT, bf16_controls=True)
        other += brats_cyclegan_s2d_check(batches[0])
        warm2, timed2, _, _, val_freq2 = BRATS_CYCLEGAN_S2D_RUN
        n2 = warm2 + timed2
        want2 = {k: n2 * BRATS_CYCLEGAN_LAUNCHES[k]
                 + n2 // val_freq2 * 2 * windows * CUT_G_LAUNCHES[k]
                 for k in BRATS_CYCLEGAN_LAUNCHES}
        args2 = brats_cyclegan_args("cyclegan_s2d.yaml", BRATS_CYCLEGAN_S2D_RUN)
        rec2, model2 = trainer_run(root, args2, "brats_cyclegan_s2d", BRATS_CYCLEGAN_S2D_RUN,
                                   want2, "patches", yaml=args2[0].split("=", 1)[1],
                                   overrides=args2[1:], cuts=cuts)
        check(model2.networks["G_AB"].use_s2d_exec, "the s2d run's G does not set use_s2d_exec")
        other.append(rec2["launches"])
        del model2
        gc.collect()
        torch.cuda.empty_cache()

    fam = profile["device_ms_per_step_by_family"]
    conv_ms = sum(fam.get(f, 0.0) for f in ("conv_forward", "conv_dgrad", "conv_wgrad",
                                            "conv_backward_other"))
    groups = {"convs": conv_ms, "norm_kernels": fam.get("norm_kernels", 0.0),
              "norm_backward_plain": fam.get("norm_backward_plain", 0.0),
              "prelu": fam.get("prelu", 0.0)}
    busy = profile["device_busy_ms_per_step"]
    if busy != "not measured":
        groups["rest"] = busy - sum(groups.values())
    wait = rec["plain_host_ranges_ms"].get("loader_wait", 0.0)
    left = torch.cuda.memory_allocated() - allocated
    summary = {"phase": "brats_cyclegan_summary", "seconds": time.perf_counter() - t0,
               "patches_per_s_trainer": rec["patches_per_s"],
               "plain_iteration_ms": rec["plain_iteration_ms"]["median"],
               "model_step_ms": steps["median_step_ms"],
               "plain_iteration_over_step": steps["plain_iteration_over_step"],
               "peak_memory_gib_trainer": rec["peak_memory_gib"],
               "peak_memory_gib_model_steps": steps["peak_memory_gib"],
               "t_data_ms": rec["t_data_ms"], "loader_wait_ms_plain_mean": wait,
               "loader_wait_share_of_plain_iteration": wait / rec["plain_iteration_ms"]["median"],
               "sample_s_one_thread": sample_s,
               "loader_patches_per_s_bound": conf.train.dataset.num_workers / sample_s,
               "device_busy_ms_per_step": busy,
               "device_idle_share": profile["device_idle_share"],
               "device_ms_per_step_by_group": groups,
               "conv_gflop": {k: v / 1e9 for k, v in flops.items()},
               "conv_tflop_per_s": flops["step"] / (conv_ms * 1e-3) / 1e12
               if conv_ms else "not measured",
               "profile": profile, "s2d_patches_per_s_trainer": rec2["patches_per_s"],
               "launches_main_path": totals,
               "launches_whole_phase": {k: totals[k] + sum(s[k] for s in other)
                                        for k in totals},
               "device_bytes_left_allocated": left}
    emit(summary)
    check(profile["device_busy_ms_per_step"] != "not measured"
          and fam.get("norm_kernels", 0) > 0 and fam.get("prelu", 0) > 0,
          "the profile saw no norm kernel or no PReLU")
    check(totals["onepass"] > 0 and totals["split"] > 0,
          f"the brats_cyclegan phase's launches: {totals}")
    check(left < 2 ** 28, f"the brats_cyclegan phase left {left} bytes allocated on the device")
    return totals


# ------------------------------------------------------------ phase 15


# The zoo phase: the BRaTS YAMLs copied into the run's working directory
# with their network sections replaced (no experiment YAML of the repo uses
# these networks; users reach them through their `_target_`s), at the
# widths of the networks' own config classes. The runs: (warm-up
# iterations, timed iterations, logging.freq, checkpointing.freq,
# val.freq), multiples of ZOO_K for the chunked run.
ZOO_NETS = {
    "revgan.yaml": {
        "generator": {"_target_": "ganslate.nn.generators.SelfAttentionVnet3D",
                      "in_out_channels": {"AB": [1, 1]}},
        "discriminator": {"_target_": "ganslate.nn.discriminators.SelfAttentionPatchGAN3D",
                          "n_layers": 2, "in_channels": {"B": 1}}},
    "cyclegan.yaml": {
        "generator": {"is_separable": True},        # merged into the YAML's Vnet3D
        "discriminator": {"_target_": "ganslate.nn.discriminators.MultiScalePatchGAN3D",
                          "scales": 2, "n_layers": 2, "in_channels": {"B": 1}}},
}
ZOO_K = 2
ZOO_RUN = (2, 4, 6, 6, 6)
ZOO_MODEL_STEPS = (2, 4)
ZOO_PROFILED_STEPS = 2
ZOO_CHUNK_STEPS = 2                     # fp32 steps of k = 2 against k = 1, bit for bit
ZOO_PARAMS = {"revgan.yaml": {"G": 24_335_492, "D_B": 2_745_251, "D_A": 2_745_251},
              "cyclegan.yaml": {"G_AB": 2_046_355, "G_BA": 2_046_355, "D_B": 5_284_738,
                                "D_A": 5_284_738}}
# SelfAttentionBlock on the card (fp32, TF32 off) against its CPU forward,
# of max|out|: the softmax and both products in fp32 on both sides.
ZOO_ATTENTION_REL = 1e-4
# (channels, spatial) of the attention blocks of this path at the patch: the
# V-Net's levels 2 and 3, the PatchGAN3D's attn1 and attn2.
ZOO_ATTENTION_SHAPES = ((128, (4, 22, 22)), (256, (2, 11, 11)), (128, (5, 29, 29)),
                        (256, (4, 28, 28)))
ZOO_FAMILY_GROUPS = ("attention_qkv", "attention_products", "attention_softmax",
                     "coupling_recompute")
# The separable V-Net's k5 convs alone at the patch, levels 0 and 1 (bf16,
# channels_last_3d): (channels, spatial).
ZOO_SEPARABLE_SHAPES = ((16, (32, 176, 176)), (32, (16, 88, 88)))


def zoo_yaml(work, yaml_name):
    """Copy the BRaTS experiment `yaml_name` into `work` with its network
    sections replaced by `ZOO_NETS` (a section without a `_target_` is
    merged into the YAML's); returns the copy's path."""
    import yaml
    raw = yaml.safe_load((BRATS_PROJECT / "experiments" / yaml_name).read_text())
    gan = raw["train"]["gan"]
    for role, node in ZOO_NETS[yaml_name].items():
        gan[role] = dict(node) if "_target_" in node else {**gan[role], **node}
    path = work / f"zoo_{yaml_name}"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def zoo_args(path, run, k=1, out=None, mixed_precision=None):
    """`init_engine`'s arguments for the copied YAML at `path`: the overrides
    of `brats_cyclegan_args` (roots, loop lengths and frequencies, a seed,
    wandb off), `train.steps_per_dispatch` and, for a second run, its output
    directory."""
    args = brats_cyclegan_args(path.name, run, mixed_precision)
    args[0] = f"config={path}"
    if k > 1:
        args.append(f"train.steps_per_dispatch={k}")
    if out is not None:
        args.append(f"train.output_dir={out}")
    return args


def zoo_conf(path, mixed_precision=None):
    from ganslate_tpu_torch.utils.builders import build_conf
    return build_conf(zoo_args(path, ZOO_RUN, mixed_precision=mixed_precision))


def zoo_family(chain, kernel):
    """`brats_cyclegan_family`, with the attention blocks' work as families:
    the q/k/v GEMM (`aten::linear`/`addmm` and their backward), the two
    products (`bmm`) and the softmax with its backward."""
    names = " ".join(chain).lower()
    if "softmax" in names:
        return "attention_softmax"
    if "bmm" in names:
        return "attention_products"
    if "addmm" in names or "aten::linear" in names or "mmbackward" in names:
        return "attention_qkv"
    return brats_cyclegan_family(chain, kernel)


def zoo_passes(model, batch):
    """Norm launches of one G pass (AB, and BA where the G inverts) at the
    patch through `infer`, and of one D pass through `apply` (centre crops:
    no generator)."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    x = torch.from_numpy(batch["A"]).to(model.device)
    out = {}
    for direction in ("AB", "BA"):
        if direction == "BA" and "G" not in model.networks:
            continue
        inorm.reset_launches()
        model.infer(x, direction=direction)
        out[f"G_{direction}"] = dict(inorm.LAUNCHES)
    inorm.reset_launches()
    with torch.no_grad():
        model.apply("D_B", x, model.compute_params(["D_B"]))
    out["D"] = dict(inorm.LAUNCHES)
    return out


@contextlib.contextmanager
def zoo_gamma(value):
    """Every `SelfAttentionBlock` built inside starts with `gamma = value`:
    at its zero init the block is the identity and its q/k/v convs get
    exactly zero gradients, which a step against the plain norms cannot
    compare."""
    import torch
    from ganslate_tpu_torch.nn.attention import SelfAttentionBlock
    init = SelfAttentionBlock.__init__

    def with_gamma(self, *args, **kwargs):
        init(self, *args, **kwargs)
        with torch.no_grad():
            self.gamma.fill_(value)

    SelfAttentionBlock.__init__ = with_gamma
    try:
        yield
    finally:
        SelfAttentionBlock.__init__ = init


def zoo_n_inert(model):
    """Biases that cancel in the following norm (`bias_inert`): the step
    gives them no gradient."""
    from ganslate_tpu_torch.nn.layers import Conv, ConvTranspose
    return sum(1 for net in model.networks.values() for m in net.modules()
               if isinstance(m, (Conv, ConvTranspose)) and m.bias is not None and m.bias_inert)


def zoo_attention_check(device="cuda"):
    """`SelfAttentionBlock` on the card (fp32, TF32 off) with gamma 0.5 and
    query and key kernels wide enough for a peaked softmax, at this path's
    attention shapes, against its CPU forward on the same input; with the
    block's forward time on the card."""
    import torch
    from ganslate_tpu_torch.nn.attention import SelfAttentionBlock
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    recs = []
    try:
        for i, (c, spatial) in enumerate(ZOO_ATTENTION_SHAPES):
            g = torch.Generator().manual_seed(SEED + 120 + i)
            block = SelfAttentionBlock(c, 3, generator=g)
            with torch.no_grad():
                block.gamma.fill_(0.5)
                for conv in (block.query, block.key):
                    conv.weight.normal_(0.0, 1.0 / math.sqrt(c), generator=g)
            x = torch.randn((1, c, *spatial), generator=g).to(
                memory_format=torch.channels_last_3d)
            with torch.no_grad():
                want = block(x)
                card = block.to(device)
                xc = x.to(device)
                got = card(xc).cpu()
                ms, _ = time_ms(lambda: card(xc), iters=10, reps=3)
            err = float((got - want).abs().max() / want.abs().max())
            recs.append({"channels": c, "spatial": list(spatial),
                         "positions": math.prod(spatial), "rel_err": err, "forward_ms": ms})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    rec = {"phase": "zoo_attention_check", "tol_rel": ZOO_ATTENTION_REL, "blocks": recs}
    emit(rec)
    check(all(r["rel_err"] <= ZOO_ATTENTION_REL for r in recs), rec)


def zoo_chunk_check(path, batches):
    """`ZOO_CHUNK_STEPS` fp32 steps of the self-attention RevGAN from one seed
    (deterministic algorithms, TF32 off): k = 2 chunks through
    `set_input_multi` against single steps, every parameter bit for bit and
    each chunk's logged losses the mean of the two steps'."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.nn.gans.base import _chunk_mean
    from ganslate_tpu_torch.utils.builders import build_gan
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    steps = [batches[i % len(batches)] for i in range(ZOO_CHUNK_STEPS)]
    try:
        runs = []
        for k in (1, ZOO_K):
            model = build_gan(zoo_conf(path, mixed_precision=False))
            model.setup(steps[0])
            logs = []
            t0 = time.perf_counter()
            for i in range(0, len(steps), k):
                if k == 1:
                    model.set_input(steps[i])
                else:
                    model.set_input_multi(steps[i:i + k])
                model.optimize_parameters()
                logs.append(dict(model.losses))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            runs.append((model, logs, seconds))
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved[:3]
        torch.use_deterministic_algorithms(saved[3], warn_only=saved[4])
    (single, logs1, s1), (chunked, logs2, s2) = runs
    differing = [f"{name}.{key}" for name, net in single.networks.items()
                 for (key, p), (_, q) in zip(net.named_parameters(),
                                             chunked.networks[name].named_parameters())
                 if not torch.equal(p, q)]
    means_equal = all(
        torch.equal(_chunk_mean(logs1[j * ZOO_K:(j + 1) * ZOO_K])[name], logs2[j][name])
        for j in range(len(logs2)) for name in logs2[j])
    rec = {"phase": "zoo_chunk_check", "steps": ZOO_CHUNK_STEPS, "k": ZOO_K,
           "dtype": "float32", "deterministic": True,
           "n_parameters": sum(1 for net in single.networks.values()
                               for _ in net.parameters()),
           "parameters_differing": differing[:10], "n_differing": len(differing),
           "chunk_means_equal": means_equal,
           "losses_single": [{k: float(v) for k, v in d.items()} for d in logs1],
           "losses_chunked": [{k: float(v) for k, v in d.items()} for d in logs2],
           "seconds_single": s1, "seconds_chunked": s2}
    emit(rec)
    check(not differing and means_equal, rec)
    del single, chunked, runs
    gc.collect()
    torch.cuda.empty_cache()


def zoo_serve(path, out_dir, load_iter, x, windows):
    """Both directions of the RevGAN's checkpoint through a deployment
    `Inferer` (`init_engine("infer")` from the copied YAML with the infer
    section a user adds to serve it: deployment, the checkpoint's
    iteration, windows of the training patch): the validation scan's source
    through the sliding window, AB and BA, each against the plain norms.
    Returns the kernel requests' launches and latencies."""
    import torch
    from ganslate_tpu_torch.engines.utils import init_engine
    from ganslate_tpu_torch.ops import instance_norm as inorm
    import yaml
    raw = yaml.safe_load(path.read_text())
    raw["infer"] = {"is_deployment": True, "checkpointing": {"load_iter": load_iter},
                    "sliding_window": {"window_size": list(REVGAN_PATCH)}}
    serving = path.with_name(f"{path.stem}_infer.yaml")
    serving.write_text(yaml.safe_dump(raw, sort_keys=False))
    inferer = init_engine("infer", [f"config={serving}", f"train.output_dir={out_dir}"])
    check(list(inferer.model.networks) == ["G"], list(inferer.model.networks))
    launches, outs, latency = [], {}, {}
    for direction in ("AB", "BA"):
        inferer.infer(x, direction=direction)           # warm
        inorm.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = inferer.infer(x, direction=direction)
        latency_ms = (time.perf_counter() - t0) * 1e3
        launches.append(dict(inorm.LAUNCHES))
        with plain_norms():
            inorm.reset_launches()
            ref = inferer.infer(x, direction=direction)
            check(sum(inorm.LAUNCHES.values()) == 0, "the plain run launched a kernel")
        err = (y.float() - ref.float()).abs()
        rec = {"phase": "zoo_serve", "direction": direction, "load_iter": load_iter,
               "latency_ms": latency_ms, "windows": windows, "launches": launches[-1],
               "max_abs_err_vs_plain": float(err.max()),
               "mean_abs_err_vs_plain": float(err.mean()),
               "tol_max": SW_BF16_MAX, "tol_mean": SW_BF16_MEAN}
        sw_output_check(rec, y, x.shape)
        emit(rec)
        check(rec["max_abs_err_vs_plain"] <= SW_BF16_MAX, rec)
        check(rec["mean_abs_err_vs_plain"] <= SW_BF16_MEAN, rec)
        check(launches[-1]["onepass"] > 0 and launches[-1]["split"] > 0, rec)
        outs[direction] = y.float()
        latency[direction] = latency_ms
    ab_ba = float((outs["AB"] - outs["BA"]).abs().max())
    emit({"phase": "zoo_serve_directions", "max_abs_ab_minus_ba": ab_ba})
    check(ab_ba > 1e-3, "infer BA gave AB's output: the inverse did not run")
    del inferer, outs
    gc.collect()
    torch.cuda.empty_cache()
    return launches, latency


def zoo_model(root, path, label, k=1, extra_runs=()):
    """One model of the zoo phase: its norm launches a step and a pass
    (`fresh_step`, `zoo_passes`), the Trainer from the copied YAML at
    `steps_per_dispatch` k (`trainer_run`), then on its model: model-level
    steps, conv FLOPs, a profile by family (`zoo_family`). `extra_runs`
    are (label, k) of further Trainer runs of the same config into their
    own output directories. Returns a dict of the run record (`rec`), the
    model-level steps and their launches, the profile, the FLOPs, the
    launches of a step and of the passes, the inert biases, the extra
    runs' records and the batches."""
    import numpy as np
    import torch
    run = ZOO_RUN
    warm, timed, _, _, val_freq = run
    n_iters = warm + timed
    windows = sw_windows(REVGAN_VOLUME[1:], REVGAN_PATCH)
    conf = zoo_conf(path)
    batches, sample_s = brats_batches(conf)
    passes, inert = {}, []

    def inspect(model):
        passes.update(zoo_passes(model, batches[0]))
        inert.append(zoo_n_inert(model))

    _, _, step_launches = fresh_step(conf, batches[0], inspect=inspect)
    g = passes["G_AB"]
    check(all(passes.get(f"G_{d}", g) == g for d in ("AB", "BA")), passes)
    want = {kind: n_iters * step_launches[kind] + n_iters // val_freq * 2 * windows * g[kind]
            for kind in step_launches}
    cuts = {"from": BRATS_CYCLEGAN_YAML_LENGTHS,
            "left_out": {**REVGAN_LEFT_OUT,
                         "train.gan.generator, train.gan.discriminator":
                             f"replaced in a copy of {path.name[4:]}: {ZOO_NETS[path.name[4:]]}",
                         "train.seed": "unset in the YAML (drawn) -> the script's seed",
                         "train.logging.wandb": "unset in the YAML; set off explicitly"}}
    others = []
    for other_label, other_k in extra_runs:
        args = zoo_args(path, run, other_k, out=root / other_label)
        rec_o, model_o = trainer_run(root, args, other_label, run, want, "patches", k=other_k,
                                     yaml=str(path), overrides=args[1:], cuts=cuts)
        others.append(rec_o)
        del model_o
        gc.collect()
        torch.cuda.empty_cache()
    args = zoo_args(path, run, k)
    rec, model = trainer_run(root, args, label, run, want, "patches", k=k, yaml=str(path),
                             overrides=args[1:], cuts=cuts,
                             dataset="synthetic BRaTS NIfTI scans, the project twin",
                             validation_windows_per_volume=windows,
                             launches_per_step=step_launches, launches_per_pass=passes,
                             sample_s_one_thread=sample_s)
    check(rec["parameters"] == ZOO_PARAMS[path.name[4:]], rec["parameters"])
    check("cycle_SSIM" in rec["validation_metrics"], rec["validation_metrics"])
    device_batches = [{key: torch.from_numpy(np.ascontiguousarray(v)).to(model.device)
                       for key, v in b.items()} for b in batches]
    steps, launches = model_steps(model, device_batches, label, ZOO_MODEL_STEPS)
    steps["plain_iteration_over_step"] = rec["plain_iteration_ms"]["median"] \
        / steps["median_step_ms"]
    steps["patches_per_s"] = 1e3 / steps["median_step_ms"]
    check(steps["losses_finite"] and all(s == step_launches for s in launches),
          f"model-level steps: {steps}, launches {launches}")
    x = torch.zeros((1, 1, *REVGAN_PATCH), device=model.device)
    g_name = "G" if "G" in model.networks else "G_AB"
    flops = {"g_pass": sum(conv_flops(model.networks[g_name], x).values()),
             "d_pass": sum(conv_flops(model.networks["D_B"], x).values())}
    flops["step"] = 4 * 3 * flops["g_pass"] + 2 * 2 * flops["d_pass"] + 4 * 3 * flops["d_pass"]
    profile = profile_steps(model, device_batches, ZOO_PROFILED_STEPS, zoo_family,
                            ("coupling_recompute", "losses", "metrics", "pool"))
    del model, device_batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"rec": rec, "steps": steps, "step_launches_each": launches, "profile": profile,
            "flops": flops, "step_launches": step_launches, "passes": passes,
            "n_inert": inert[0], "others": others, "batches": batches}


def zoo_separable_probe(bf16_peak, device="cuda"):
    """The separable V-Net's k5 conv alone (`SeparableConv3d`: (1, 5, 5) then
    (5, 1, 1), padding 2, C -> C, bf16, channels_last_3d) against the dense
    k5 conv it replaces, at `ZOO_SEPARABLE_SHAPES`: device time, FLOPs
    (2 x output elements x input channels x taps; 25 + 5 taps against
    125), TFLOP/s and share of the bf16 peak."""
    import torch
    import torch.nn.functional as F
    from ganslate_tpu_torch.nn.separable import SeparableConv3d
    out = []
    for c, spatial in ZOO_SEPARABLE_SHAPES:
        g = torch.Generator().manual_seed(SEED + 130 + c)
        sep = SeparableConv3d(c, c, 5, padding=2, generator=g).to(
            device=device, dtype=torch.bfloat16, memory_format=torch.channels_last_3d)
        w = torch.randn((c, c, 5, 5, 5), generator=g).mul_(0.02).to(
            device=device, dtype=torch.bfloat16, memory_format=torch.channels_last_3d)
        x = torch.randn((1, c, *spatial), generator=g).to(
            device=device, dtype=torch.bfloat16, memory_format=torch.channels_last_3d)
        elements = math.prod(spatial) * c
        rec = {"channels": c, "spatial": list(spatial)}
        for name, fn, taps in (("separable", lambda: sep(x), 30),
                               ("dense", lambda: F.conv3d(x, w, padding=2), 125)):
            with torch.inference_mode():
                ms, _ = time_ms(fn, iters=10, reps=3)
            flop = 2 * elements * c * taps
            rec[name] = {"ms": ms, "gflop": flop / 1e9, "tflop_per_s": flop / ms / 1e9,
                         "share_of_bf16_peak": flop / ms * 1e3 / bf16_peak}
        out.append(rec)
        del sep, w, x
    emit({"phase": "zoo_separable_probe", "convs": out})
    return out


def zoo_summary(label, t0, rec, steps, profile, flops, bf16_peak, extra):
    import torch
    fam = profile["device_ms_per_step_by_family"]
    conv_ms = sum(fam.get(f, 0.0) for f in ("conv_forward", "conv_dgrad", "conv_wgrad",
                                            "conv_backward_other"))
    groups = {"convs": conv_ms, "norm_kernels": fam.get("norm_kernels", 0.0),
              "norm_backward_plain": fam.get("norm_backward_plain", 0.0),
              "prelu": fam.get("prelu", 0.0),
              **{f: fam.get(f, 0.0) for f in ZOO_FAMILY_GROUPS}}
    busy = profile["device_busy_ms_per_step"]
    if busy != "not measured":
        groups["rest"] = busy - sum(groups.values())
    tflops = flops["step"] / (conv_ms * 1e-3) / 1e12 if conv_ms else "not measured"
    summary = {"phase": f"{label}_summary", "seconds": time.perf_counter() - t0,
               "patches_per_s_trainer": rec["patches_per_s"],
               "plain_iteration_ms": rec["plain_iteration_ms"]["median"],
               "model_step_ms": steps["median_step_ms"],
               "peak_memory_gib_trainer": rec["peak_memory_gib"],
               "peak_memory_gib_model_steps": steps["peak_memory_gib"],
               "device_busy_ms_per_step": busy,
               "device_idle_share": profile["device_idle_share"],
               "device_ms_per_step_by_group": groups,
               "conv_gflop": {k: v / 1e9 for k, v in flops.items()},
               "conv_tflop_per_s": tflops,
               "conv_share_of_bf16_peak": tflops / (bf16_peak / 1e12)
               if conv_ms else "not measured",
               "profile": profile, **extra}
    emit(summary)
    check(busy != "not measured" and fam.get("norm_kernels", 0) > 0,
          f"the {label} profile saw no norm kernel")
    torch.cuda.empty_cache()
    return summary


def zoo_phase(root, bf16_peak):
    """Phase 15; returns the norm launches of its main path (both Trainer
    runs at the YAMLs' settings and the RevGAN's serving from its
    checkpoint)."""
    import torch
    allocated = torch.cuda.memory_allocated()
    zoo_attention_check()
    with experiment_workdir(root) as work:
        # (a) The self-attention V-Net RevGAN, in chunks of ZOO_K; the same
        # run at k = 1 first, into its own output directory.
        t0 = time.perf_counter()
        path_a = zoo_yaml(work, "revgan.yaml")
        a = zoo_model(root, path_a, "zoo_revgan", k=ZOO_K,
                      extra_runs=(("zoo_revgan_k1", 1),))
        fam = a["profile"]["device_ms_per_step_by_family"]
        check(fam.get("attention_products", 0) > 0 and fam.get("attention_softmax", 0) > 0,
              "the RevGAN profile saw no attention product or softmax")
        totals = dict(a["rec"]["launches"])
        conf_a = zoo_conf(path_a)
        served, latency = zoo_serve(path_a, Path(conf_a.train.output_dir).resolve(),
                                    a["rec"]["checkpoints"][-1], brats_val_source(conf_a),
                                    sw_windows(REVGAN_VOLUME[1:], REVGAN_PATCH))
        for launches in served:
            for kind, v in launches.items():
                totals[kind] += v
        zoo_chunk_check(path_a, a["batches"])
        other = [a["others"][0]["launches"], *a["step_launches_each"]]
        with zoo_gamma(0.5):
            other += kernel_vs_plain_steps("zoo_revgan", lambda mp: zoo_conf(path_a, mp),
                                           a["batches"][0], a["step_launches"], a["n_inert"],
                                           bf16_controls=True, cancelling=("key.bias",))
        chunked = a["rec"]["plain_iteration_ms"]["median"]
        unchunked = a["others"][0]["plain_iteration_ms"]["median"]
        zoo_summary("zoo_revgan", t0, a["rec"], a["steps"], a["profile"], a["flops"],
                    bf16_peak, {
                        "steps_per_dispatch": ZOO_K,
                        "plain_iteration_ms_chunked": chunked,
                        "plain_iteration_ms_unchunked": unchunked,
                        "chunked_over_unchunked": chunked / unchunked,
                        "patches_per_s_trainer_unchunked": a["others"][0]["patches_per_s"],
                        "serve_latency_ms": latency,
                        "launches_per_step": a["step_launches"],
                        "launches_per_pass": a["passes"]})

        # (b) The separable V-Net CycleGAN against the multi-scale PatchGAN3D.
        t0 = time.perf_counter()
        path_b = zoo_yaml(work, "cyclegan.yaml")
        b = zoo_model(root, path_b, "zoo_cyclegan")
        for kind, v in b["rec"]["launches"].items():
            totals[kind] += v
        other += b["step_launches_each"]
        # A down conv's first factor has no padding after it: its bias
        # reaches the norm as a constant and cancels there too.
        other += kernel_vs_plain_steps("zoo_cyclegan", lambda mp: zoo_conf(path_b, mp),
                                       b["batches"][0], b["step_launches"], b["n_inert"],
                                       bf16_controls=True,
                                       cancelling=("down_conv_ab.conv.depthwise.bias",))
        zoo_summary("zoo_cyclegan", t0, b["rec"], b["steps"], b["profile"], b["flops"],
                    bf16_peak, {"separable_convs": zoo_separable_probe(bf16_peak),
                                "launches_per_step": b["step_launches"],
                                "launches_per_pass": b["passes"]})
    left = torch.cuda.memory_allocated() - allocated
    emit({"phase": "zoo_launches", "launches_main_path": totals,
          "launches_whole_phase": {k: totals[k] + sum(s[k] for s in other) for k in totals},
          "device_bytes_left_allocated": left})
    check(totals["onepass"] > 0 and totals["split"] > 0, f"the zoo phase's launches: {totals}")
    check(left < 2 ** 28, f"the zoo phase left {left} bytes allocated on the device")
    return totals


# ------------------------------------------------------- phases 12 and 13


# The hx4 and cleargrasp phases: the HX4 PET and ClearGrasp experiments
# loaded from their YAMLs by `init_engine("train", ["config=<yaml>", ...])`
# with only the overrides of `project_args` (the datasets' roots, the loop
# lengths, the logging, checkpoint and validation frequencies, a seed and
# `logging.wandb` off), on files that each phase writes with
# `utils/synthetic_data` into its temporary root. Runs: (warm-up
# iterations, timed iterations, logging.freq, checkpointing.freq,
# val.freq): one checkpoint and one validation inside the timed span.
HX4_PROJECT = HERE / "projects" / "maastro_hx4_pet_translation"
CLEARGRASP_PROJECT = HERE / "projects" / "cleargrasp_depth_estimation"
# Synthetic HX4 patients: the clinical in-plane 512^2 cut to 256^2; larger
# than one (32, 128, 128) window in every axis, so that the sliding window
# blends several; 3 for training, 1 for validation.
HX4_VOLUME = (48, 256, 256)
HX4_PATIENTS = (3, 1)
HX4_YAML_LENGTHS = {"n_iters": 30000, "n_iters_decay": 30000, "logging.freq": 50,
                    "checkpointing.freq": 1000, "val.freq": 1000}
HX4_BALANCED_RUN = (3, 10, 5, 10, 10)
HX4_PIX2PIX_RUN = (2, 6, 4, 8, 8)
HX4_MODEL_STEPS = (2, 5)
HX4_PROFILED_STEPS = 3
# Norm launches of an HX4CycleGANBalanced step: 4 Unet3D passes (fake_B,
# rec_A, fake_A, rec_B) of `HX4_G_LAUNCHES`; PatchGAN3D on the 1-channel
# fakes in the G step and, in the D step, each D on real and fake as one
# forward, of `HX4_D_LAUNCHES`. A validation runs G_AB over every window
# (the YAML has no cycle metrics).
HX4_BALANCED_LAUNCHES = {k: 4 * HX4_G_LAUNCHES[k] + 4 * HX4_D_LAUNCHES[k]
                         for k in HX4_G_LAUNCHES}
HX4_BALANCED_PARAMS = {"G_AB": 24_659_329, "G_BA": 24_659_329, "D_B": 11_047_873,
                       "D_A": 11_047_873}
# Inert biases: the conv before each norm of both Gs and both Ds.
HX4_BALANCED_INERT = 2 * sum(HX4_G_LAUNCHES.values()) + 2 * sum(HX4_D_LAUNCHES.values())
# The validation's six metrics (the balanced YAML's `val.metrics`), and the
# masked ones of the Pix2Pix YAML's validation (`supply_masks: true`).
HX4_VAL_METRICS = ("mse", "mae", "psnr", "ssim", "nmi", "histogram_chi2")
HX4_MASKED_METRICS = tuple(f"{m}_{label}" for m in ("mse", "mae", "psnr", "ssim", "nmse")
                           for label in ("BODY", "GTV"))
HX4_LEFT_OUT = {
    "train.dataset.root, val.dataset.root": "synthetic HX4 patients (NRRD volumes of (48, 256, "
                                            "256) and SUVmean_aorta_HX4.csv) that the port's "
                                            "medio wrote: no HX4 data in the repo",
    "train.logging.wandb": "the YAML names a wandb project; set off (the wandb package would "
                           "contact its server)"}
# Synthetic ClearGrasp samples: RGB JPEGs and EXR normal and depth maps of
# 960x540 (half of the 1920x1080 captures), which the datasets resize to
# the YAMLs' 512x256; 4 for training, 1 for validation.
CLEARGRASP_SOURCE_WH = (960, 540)
CLEARGRASP_SIZE = (256, 512)
CLEARGRASP_SAMPLES = (4, 1)
CLEARGRASP_YAML_LENGTHS = {"n_iters": 40000, "n_iters_decay": 40000, "logging.freq": 50,
                           "checkpointing.freq": 2000, "val.freq": 2000}
CLEARGRASP_BALANCED_RUN = (3, 10, 5, 10, 10)
CLEARGRASP_PIX2PIX_RUN = (2, 6, 4, 8, 8)
# Norm launches: a Resnet2D pass at 256x512 (23 norms, every slab over the
# one-pass limit); a PatchGAN2D pass (3 layers: down1 split, down2 and the
# penultimate one-pass); the 7-level Unet2D at ngf 64 (the Cityscapes
# G's forms: `PIX2PIX_G_LAUNCHES`). A CycleGANMultiModalV3 step: 4 G passes,
# 2 D passes in the G step, each D on real and fake as one forward in the
# D step; a Pix2Pix step: G, D in the G step, D at batch 2 in the D step.
# A validation runs G_AB once per image.
CLEARGRASP_G_LAUNCHES = {"onepass": 0, "split": 23}
CLEARGRASP_D_LAUNCHES = {"onepass": 2, "split": 1}
CLEARGRASP_BALANCED_LAUNCHES = {k: 4 * CLEARGRASP_G_LAUNCHES[k] + 4 * CLEARGRASP_D_LAUNCHES[k]
                                for k in CLEARGRASP_G_LAUNCHES}
CLEARGRASP_PIX2PIX_LAUNCHES = {k: PIX2PIX_G_LAUNCHES[k] + 2 * CLEARGRASP_D_LAUNCHES[k]
                               for k in PIX2PIX_G_LAUNCHES}
CLEARGRASP_BALANCED_PARAMS = {"G_AB": 11_381_313, "G_BA": 11_381_315, "D_B": 2_762_689,
                              "D_A": 2_764_737}
CLEARGRASP_PIX2PIX_PARAMS = {"G": 41_824_641, "D": 2_768_833}
CLEARGRASP_BALANCED_INERT = 2 * sum(CLEARGRASP_G_LAUNCHES.values()) \
    + 2 * sum(CLEARGRASP_D_LAUNCHES.values())
CLEARGRASP_LEFT_OUT = {
    "train.dataset.root, val.dataset.root": "synthetic ClearGrasp samples (RGB JPEGs, EXR "
                                            "normal and depth maps of 960x540) from the seed: "
                                            "no ClearGrasp data in the repo",
    "train.logging.wandb": "unset in the YAML; set off explicitly",
    "train.seed": "unset in the YAML (drawn) -> the script's seed, so that a run repeats"}
PROJECT_FAMILY_GROUPS = ("conv_forward", "conv_dgrad", "conv_wgrad", "conv_backward_other")
# The slabs (N, *spatial, C) of the two phases that no earlier phase checks,
# with their activations, checked and timed in bf16 by the kernels phase:
# the HX4 Unet3D's down1 and down2 levels; PatchGAN3D's three in the G step
# (batch 1) and the D step (batch 2); Resnet2D at 256x512 (its residual
# blocks' second norm has no activation); PatchGAN2D at 256x512 at batch 1
# and 2; the 7-level Unet2D at ngf 64, the levels whose widths differ from
# the Cityscapes G's.
PROJECT_SLABS = (
    ((1, 8, 32, 32, 128), "none"), ((1, 4, 16, 16, 256), "none"),
    *(((n, *s), "leaky_relu") for n in (1, 2)
      for s in ((8, 32, 32, 128), (4, 16, 16, 256), (3, 15, 15, 512))),
    ((1, 256, 512, 64), "relu"), ((1, 128, 256, 128), "relu"), ((1, 64, 128, 256), "relu"),
    ((1, 64, 128, 256), "none"),
    *(((n, *s), "leaky_relu") for n in (1, 2)
      for s in ((64, 128, 128), (32, 64, 256), (31, 63, 512))),
    ((1, 64, 128, 128), "none"), ((1, 32, 64, 256), "none"), ((1, 128, 256, 64), "none"))


def project_args(project, yaml_name, run, data_root, mixed_precision=None):
    """`init_engine`'s arguments for `project`'s experiment `yaml_name`: the
    YAML and only the phase's overrides (the datasets' roots under
    `data_root`, the loop lengths and frequencies of `run`, a seed,
    `logging.wandb` off); with `mixed_precision`, that too (the kernel-vs-
    plain step's fp32 run)."""
    warm, timed, log_freq, ckpt_freq, val_freq = run
    n_iters = warm + timed
    args = [f"config={project / 'experiments' / yaml_name}",
            f"train.dataset.root={data_root / 'train'}", f"val.dataset.root={data_root / 'val'}",
            f"train.n_iters={n_iters - n_iters // 2}", f"train.n_iters_decay={n_iters // 2}",
            f"train.logging.freq={log_freq}", f"train.checkpointing.freq={ckpt_freq}",
            f"val.freq={val_freq}", f"train.seed={SEED + 110}", "train.logging.wandb=null"]
    if mixed_precision is not None:
        args.append(f"train.mixed_precision={str(mixed_precision).lower()}")
    return args


def project_batches(conf, n, seed):
    """`n` training samples of the config's dataset (a project twin's) as
    batches of 1, sample `i` after seeding Python's `random` and the global
    `np.random` from (`seed`, `i`); with the mean seconds a sample takes on
    one thread."""
    import random
    import numpy as np
    from ganslate_tpu_torch.utils.io import import_attr
    dataset = import_attr(conf.train.dataset._target_)(conf)
    batches = []
    t0 = time.perf_counter()
    for i in range(n):
        random.seed(seed * 1000 + i)
        np.random.seed(seed * 1000 + i)
        batches.append({k: v[None] for k, v in dataset[i % len(dataset)].items()})
    return batches, (time.perf_counter() - t0) / n


def padded_channels_check(label, model, channels):
    """The zero-padded channels (`channels`, a slice) of the last step's
    fakes and reconstructions are exactly 0, and the generated ones not."""
    import torch
    rec = {"phase": f"{label}_padded_channels", "channels": [channels.start, channels.stop]}
    for key in ("fake_B", "rec_A", "fake_A", "rec_B"):
        v = model.visuals[key]
        rec[key] = {"shape": list(v.shape), "padded_max_abs": float(v[..., channels].abs().max())}
        keep = torch.ones(v.shape[-1], dtype=torch.bool)
        keep[channels] = False
        rec[key]["generated_std"] = float(v[..., keep].float().std())
    emit(rec)
    check(all(rec[k]["padded_max_abs"] == 0 and rec[k]["generated_std"] > 0
              for k in ("fake_B", "rec_A", "fake_A", "rec_B")), rec)


def project_tester(root, args, load_iter, sliding_window):
    """The Tester of the trained run's checkpoint `load_iter` (`args` are the
    run's `init_engine` arguments): the YAML has no test section, so it is
    the validation's, written with the run's overrides into a YAML of
    `root`."""
    from ganslate_tpu_torch.engines.utils import init_engine
    from ganslate_tpu_torch.utils.builders import build_conf
    raw = build_conf(args).to_container(resolve=False)
    raw["test"] = {"dataset": raw["val"]["dataset"], "checkpointing": {"load_iter": load_iter}}
    if sliding_window:
        raw["test"]["sliding_window"] = raw["val"]["sliding_window"]
    raw.pop("mode", None)
    path = root / f"{Path(args[0].split('=', 1)[1]).stem}_test.yaml"
    from ganslate_tpu_torch.configs.omega import Conf
    path.write_text(Conf.create(raw).to_yaml())
    return init_engine("test", [f"config={path}"])


def project_serve(label, tester, x, out_channels, want_launches, zero_channels, tol):
    """`tester.infer(x)` (the checkpoint's G_AB, through the sliding window
    where the YAML has one) with the kernels and with the plain norms: an
    output of `out_channels` whose padded channels (`zero_channels`) are
    exactly 0 and the others finite and in [-1, 1], within `tol` (max,
    mean) of the plain norms. Returns the kernel request's launches."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    tester.infer(x)                             # warm
    inorm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = tester.infer(x)
    latency_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(inorm.LAUNCHES)
    with plain_norms():
        inorm.reset_launches()
        ref = tester.infer(x)
        check(sum(inorm.LAUNCHES.values()) == 0, "the plain run launched a kernel")
    err = (y.float() - ref.float()).abs()
    keep = torch.ones(y.shape[-1], dtype=torch.bool)
    keep[zero_channels] = False
    rec = {"phase": f"{label}_serve", "input_shape": list(x.shape), "latency_ms": latency_ms,
           "launches": launches, "padded_max_abs": float(y[..., zero_channels].abs().max()),
           "max_abs_err_vs_plain": float(err.max()), "mean_abs_err_vs_plain": float(err.mean()),
           "tol_max": tol[0], "tol_mean": tol[1]}
    sw_output_check(rec, y[..., keep], (*x.shape[:-1], int(keep.sum())))
    emit(rec)
    check(rec["padded_max_abs"] == 0 and y.shape[-1] == out_channels, rec)
    check(launches == want_launches, rec)
    check(rec["max_abs_err_vs_plain"] <= tol[0] and rec["mean_abs_err_vs_plain"] <= tol[1], rec)
    return launches


def project_summary(label, t0, rec, steps, sample_s, num_workers, profile, extra):
    """The `<label>_summary` record: samples/s, the plain iteration against
    the model-level step with t_data and the loader wait, the loader's bound
    from one sample's time, peak memory, the profile's busy time by group
    (convs, norm kernels, the plain norm backward, the rest) and idle share,
    and the validation's seconds."""
    fam = profile["device_ms_per_step_by_family"]
    groups = {"convs": sum(fam.get(f, 0.0) for f in PROJECT_FAMILY_GROUPS),
              "norm_kernels": fam.get("norm_kernels", 0.0),
              "norm_backward_plain": fam.get("norm_backward_plain", 0.0)}
    busy = profile["device_busy_ms_per_step"]
    if busy != "not measured":
        groups["rest"] = busy - sum(groups.values())
    wait = rec["plain_host_ranges_ms"].get("loader_wait", 0.0)
    plain = rec["plain_iteration_ms"]["median"]
    summary = {"phase": f"{label}_summary", "seconds": time.perf_counter() - t0,
               "samples_per_s_trainer": rec["patches_per_s"], "plain_iteration_ms": plain,
               "model_step_ms": steps["median_step_ms"],
               "plain_iteration_over_step": plain / steps["median_step_ms"],
               "t_data_ms": rec["t_data_ms"], "loader_wait_ms_plain_mean": wait,
               "loader_wait_share_of_plain_iteration": wait / plain,
               "sample_s_one_thread": sample_s,
               "loader_samples_per_s_bound": num_workers / sample_s,
               "peak_memory_gib_trainer": rec["peak_memory_gib"],
               "peak_memory_gib_model_steps": steps["peak_memory_gib"],
               "device_busy_ms_per_step": busy, "device_idle_share": profile["device_idle_share"],
               "device_ms_per_step_by_group": groups,
               "validation_s": {i: ms / 1e3 for i, ms in rec["validation_iteration_ms"].items()},
               "profile": profile, **extra}
    emit(summary)
    check(busy != "not measured" and groups["norm_kernels"] > 0,
          f"the {label} profile saw no norm kernel")
    return summary


def project_run(root, label, project, yaml_name, run, data_root, want, params, left_out,
                dataset, **extra):
    """`trainer_run` of `project`'s `yaml_name` with `project_args`, from
    `root/work` (`experiment_workdir`); checks the networks' parameter
    counts. Returns the record, the model and the arguments."""
    args = project_args(project, yaml_name, run, data_root)
    cuts = {"from": HX4_YAML_LENGTHS if project == HX4_PROJECT else CLEARGRASP_YAML_LENGTHS,
            "left_out": left_out}
    rec, model = trainer_run(root, args, label, run, want, "patches",
                             yaml=args[0].split("=", 1)[1], overrides=args[1:], cuts=cuts,
                             dataset=dataset, **extra)
    check(rec["parameters"] == params, rec["parameters"])
    return rec, model, args


def hx4_project_phase(root):
    """Phase 12; returns the norm launches of its main path (the Trainer runs
    of `cyclegan_balanced.yaml` and `pix2pix.yaml` and the serving of the
    balanced run's G_AB)."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.utils import medio
    from ganslate_tpu_torch.utils.builders import build_conf
    from ganslate_tpu_torch.utils.synthetic_data import HX4_FILES, write_hx4_root
    t0 = time.perf_counter()
    allocated = torch.cuda.memory_allocated()
    data_root = root / "hx4_data"
    write_hx4_root(data_root, HX4_VOLUME, *HX4_PATIENTS, seed=SEED + 70)
    sizes = [p.stat().st_size for p in data_root.rglob("*.nrrd")]
    emit({"phase": "hx4_data", "seconds": time.perf_counter() - t0, "volume": list(HX4_VOLUME),
          "patients": list(HX4_PATIENTS), "files_per_patient": list(HX4_FILES),
          "nrrd_files": len(sizes), "nrrd_mib": sum(sizes) / 2 ** 20})
    windows = sw_windows(HX4_VOLUME, HX4_PATCH)
    totals = {k: 0 for k in HX4_G_LAUNCHES}
    other = []
    with experiment_workdir(root):
        # (a) The balanced CycleGAN.
        args = project_args(HX4_PROJECT, "cyclegan_balanced.yaml", HX4_BALANCED_RUN, data_root)
        conf = build_conf(args)
        batches, sample_s = project_batches(conf, 4, SEED + 71)
        emit({"phase": "hx4_batches", "dataset": conf.train.dataset._target_,
              "num_workers": conf.train.dataset.num_workers, "sample_s": sample_s,
              "batch_shapes": {k: list(v.shape) for k, v in batches[0].items()}})
        check(batches[0]["A"].shape == batches[0]["B"].shape == (1, *HX4_PATCH, 2),
              "HX4 balanced batches")
        warm, timed, _, _, val_freq = HX4_BALANCED_RUN
        n_iters = warm + timed
        want = {k: n_iters * HX4_BALANCED_LAUNCHES[k]
                + n_iters // val_freq * windows * HX4_G_LAUNCHES[k] for k in totals}
        rec, model, args = project_run(
            root, "hx4_balanced", HX4_PROJECT, "cyclegan_balanced.yaml", HX4_BALANCED_RUN,
            data_root, want, HX4_BALANCED_PARAMS, HX4_LEFT_OUT,
            "synthetic HX4 NRRD patients, the project twin",
            validation_windows_per_volume=windows)
        check(all(m in rec["validation_metrics"] for m in HX4_VAL_METRICS),
              rec["validation_metrics"])
        out_dir = Path(model.conf.train.output_dir).resolve()
        saved = sorted((out_dir / "val" / "saved").rglob("*.nrrd"))
        image = medio.load(saved[-1])
        emit({"phase": "hx4_balanced_saved", "files": [str(p.relative_to(out_dir))
                                                       for p in saved],
              "shape": list(image.array.shape), "dtype": str(image.array.dtype),
              "origin": list(image.origin), "max_suv": float(image.array.max())})
        check(image.array.shape == HX4_VOLUME and np.isfinite(image.array).all(), saved)
        for k in totals:
            totals[k] += rec["launches"][k]
        device_batches = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(model.device)
                           for k, v in b.items()} for b in batches]
        steps, step_launches = model_steps(model, device_batches, "hx4_balanced",
                                           HX4_MODEL_STEPS)
        check(steps["losses_finite"]
              and all(s == HX4_BALANCED_LAUNCHES for s in step_launches), steps)
        padded_channels_check("hx4_balanced", model, slice(1, 2))
        profile = profile_steps(model, device_batches, HX4_PROFILED_STEPS, pix2pix_family,
                                PIX2PIX_RANGES)
        other += step_launches
        del model, device_batches
        gc.collect()
        torch.cuda.empty_cache()

        # The checkpoint's G_AB served by the Tester through the sliding
        # window, on the validation patient's [FDG-PET, pCT].
        tester = project_tester(root, args, rec["checkpoints"][-1], sliding_window=True)
        x = tester.data_loaders[None].dataset[0]["A"][None]
        served = project_serve("hx4_balanced", tester, x, 2,
                               {k: windows * v for k, v in HX4_G_LAUNCHES.items()}, slice(1, 2),
                               (SW_BF16_MAX, SW_BF16_MEAN))
        for k in totals:
            totals[k] += served[k]
        del tester
        gc.collect()
        torch.cuda.empty_cache()

        other += kernel_vs_plain_steps(
            "hx4_balanced",
            lambda mp: build_conf(project_args(HX4_PROJECT, "cyclegan_balanced.yaml",
                                               HX4_BALANCED_RUN, data_root, mp)),
            batches[0], HX4_BALANCED_LAUNCHES, HX4_BALANCED_INERT, bf16_controls=True)

        # (b) The Pix2Pix, validated with the BODY and GTV masks.
        warm2, timed2, _, _, val_freq2 = HX4_PIX2PIX_RUN
        n2 = warm2 + timed2
        want2 = {k: n2 * HX4_LAUNCHES[k] + n2 // val_freq2 * windows * HX4_G_LAUNCHES[k]
                 for k in totals}
        rec2, model2, _ = project_run(
            root, "hx4_pix2pix", HX4_PROJECT, "pix2pix.yaml", HX4_PIX2PIX_RUN, data_root, want2,
            HX4_PARAMS, HX4_LEFT_OUT, "synthetic HX4 NRRD patients, the project twin",
            validation_windows_per_volume=windows)
        check(all(m in rec2["validation_metrics"] for m in HX4_MASKED_METRICS),
              rec2["validation_metrics"])
        for k in totals:
            totals[k] += rec2["launches"][k]
        del model2
        gc.collect()
        torch.cuda.empty_cache()

    left = torch.cuda.memory_allocated() - allocated
    project_summary("hx4", t0, rec, steps, sample_s, conf.train.dataset.num_workers, profile, {
        "pix2pix_samples_per_s_trainer": rec2["patches_per_s"],
        "pix2pix_peak_memory_gib": rec2["peak_memory_gib"],
        "pix2pix_validation_s": {i: ms / 1e3 for i, ms in
                                 rec2["validation_iteration_ms"].items()},
        "launches_main_path": totals,
        "launches_whole_phase": {k: totals[k] + sum(s[k] for s in other) for k in totals},
        "device_bytes_left_allocated": left})
    check(totals["onepass"] > 0 and totals["split"] > 0, f"the hx4 phase's launches: {totals}")
    check(left < 2 ** 28, f"the hx4 phase left {left} bytes allocated on the device")
    return totals


def exr_codec():
    """Can this cv2 write and read back a float32 EXR? (OpenCV reads the
    `OPENCV_IO_ENABLE_OPENEXR` switch, which `main` sets, at its import.)"""
    import cv2
    import numpy as np
    with tempfile.TemporaryDirectory() as tmp:
        a = np.linspace(-1, 1, 48, dtype=np.float32).reshape(4, 4, 3)
        try:
            ok = cv2.imwrite(f"{tmp}/probe.exr", a)
        except cv2.error:
            return False
        b = cv2.imread(f"{tmp}/probe.exr", cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        return bool(ok) and b is not None and bool(np.array_equal(a, b))


def cleargrasp_project_phase(root):
    """Phase 13; returns the norm launches of its main path (the Trainer runs
    of `cyclegan_balanced.yaml` and `pix2pix_new.yaml` and the serving of
    the balanced run's G_AB)."""
    import cv2
    import numpy as np
    import torch
    from ganslate_tpu_torch.utils.builders import build_conf
    from ganslate_tpu_torch.utils.synthetic_data import write_cleargrasp_root
    t0 = time.perf_counter()
    allocated = torch.cuda.memory_allocated()
    exr = exr_codec()
    emit({"phase": "cleargrasp_exr", "exr": exr, "cv2": cv2.__version__})
    check(exr, "this cv2 has no EXR codec: the ClearGrasp maps and `save` need one")
    data_root = root / "cleargrasp_data"
    write_cleargrasp_root(data_root, CLEARGRASP_SOURCE_WH, *CLEARGRASP_SAMPLES, exr=True,
                          seed=SEED + 80)
    emit({"phase": "cleargrasp_data", "seconds": time.perf_counter() - t0,
          "source_wh": list(CLEARGRASP_SOURCE_WH), "samples": list(CLEARGRASP_SAMPLES),
          "exr": exr})
    totals = {k: 0 for k in CLEARGRASP_G_LAUNCHES}
    other = []
    with experiment_workdir(root):
        # (a) The multimodal CycleGAN.
        args = project_args(CLEARGRASP_PROJECT, "cyclegan_balanced.yaml",
                            CLEARGRASP_BALANCED_RUN, data_root)
        conf = build_conf(args)
        batches, sample_s = project_batches(conf, 4, SEED + 81)
        emit({"phase": "cleargrasp_batches", "dataset": conf.train.dataset._target_,
              "num_workers": conf.train.dataset.num_workers, "sample_s": sample_s,
              "batch_shapes": {k: list(v.shape) for k, v in batches[0].items()}})
        check(batches[0]["A"].shape == (1, *CLEARGRASP_SIZE, 6)
              and batches[0]["B"].shape == (1, *CLEARGRASP_SIZE, 4), "ClearGrasp batches")
        warm, timed, _, _, val_freq = CLEARGRASP_BALANCED_RUN
        n_iters = warm + timed
        n_val = CLEARGRASP_SAMPLES[1]
        want = {k: n_iters * CLEARGRASP_BALANCED_LAUNCHES[k]
                + n_iters // val_freq * n_val * CLEARGRASP_G_LAUNCHES[k] for k in totals}
        rec, model, args = project_run(
            root, "cleargrasp_balanced", CLEARGRASP_PROJECT, "cyclegan_balanced.yaml",
            CLEARGRASP_BALANCED_RUN, data_root, want, CLEARGRASP_BALANCED_PARAMS,
            CLEARGRASP_LEFT_OUT, "synthetic ClearGrasp image folders, the project twin")
        out_dir = Path(model.conf.train.output_dir).resolve()
        saved = sorted((out_dir / "val" / "saved").rglob("*.exr"))
        depth = cv2.imread(str(saved[-1]), cv2.IMREAD_ANYDEPTH)
        emit({"phase": "cleargrasp_balanced_saved",
              "files": [str(p.relative_to(out_dir)) for p in saved],
              "shape": list(depth.shape), "dtype": str(depth.dtype),
              "depth_m": [float(depth.min()), float(depth.max())]})
        check(depth.shape == CLEARGRASP_SIZE and depth.dtype == np.float32
              and np.isfinite(depth).all(), saved)
        for k in totals:
            totals[k] += rec["launches"][k]
        device_batches = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(model.device)
                           for k, v in b.items()} for b in batches]
        steps, step_launches = model_steps(model, device_batches, "cleargrasp_balanced",
                                           HX4_MODEL_STEPS)
        check(steps["losses_finite"]
              and all(s == CLEARGRASP_BALANCED_LAUNCHES for s in step_launches), steps)
        padded_channels_check("cleargrasp_balanced", model, slice(0, 3))
        profile = profile_steps(model, device_batches, HX4_PROFILED_STEPS, revgan_family,
                                REVGAN_RANGES)
        other += step_launches
        del model, device_batches
        gc.collect()
        torch.cuda.empty_cache()

        # The checkpoint's G_AB served by the Tester on the validation
        # sample's [RGB, normal map].
        tester = project_tester(root, args, rec["checkpoints"][-1], sliding_window=False)
        x = tester.data_loaders[None].dataset[0]["A"][None]
        served = project_serve("cleargrasp_balanced", tester, x, 4, CLEARGRASP_G_LAUNCHES,
                               slice(0, 3), (SLICE_BF16_MAX, SLICE_BF16_MEAN))
        for k in totals:
            totals[k] += served[k]
        del tester
        gc.collect()
        torch.cuda.empty_cache()

        other += kernel_vs_plain_steps(
            "cleargrasp_balanced",
            lambda mp: build_conf(project_args(CLEARGRASP_PROJECT, "cyclegan_balanced.yaml",
                                               CLEARGRASP_BALANCED_RUN, data_root, mp)),
            batches[0], CLEARGRASP_BALANCED_LAUNCHES, CLEARGRASP_BALANCED_INERT,
            bf16_controls=True)

        # (b) The Pix2Pix.
        warm2, timed2, _, _, val_freq2 = CLEARGRASP_PIX2PIX_RUN
        n2 = warm2 + timed2
        want2 = {k: n2 * CLEARGRASP_PIX2PIX_LAUNCHES[k]
                 + n2 // val_freq2 * n_val * PIX2PIX_G_LAUNCHES[k] for k in totals}
        rec2, model2, _ = project_run(
            root, "cleargrasp_pix2pix", CLEARGRASP_PROJECT, "pix2pix_new.yaml",
            CLEARGRASP_PIX2PIX_RUN, data_root, want2, CLEARGRASP_PIX2PIX_PARAMS,
            CLEARGRASP_LEFT_OUT, "synthetic ClearGrasp image folders, the project twin")
        for k in totals:
            totals[k] += rec2["launches"][k]
        del model2
        gc.collect()
        torch.cuda.empty_cache()

    left = torch.cuda.memory_allocated() - allocated
    project_summary("cleargrasp", t0, rec, steps, sample_s, conf.train.dataset.num_workers,
                    profile, {
                        "exr": exr, "pix2pix_samples_per_s_trainer": rec2["patches_per_s"],
                        "pix2pix_peak_memory_gib": rec2["peak_memory_gib"],
                        "pix2pix_validation_s": {i: ms / 1e3 for i, ms in
                                                 rec2["validation_iteration_ms"].items()},
                        "launches_main_path": totals,
                        "launches_whole_phase": {k: totals[k] + sum(s[k] for s in other)
                                                 for k in totals},
                        "device_bytes_left_allocated": left})
    check(totals["onepass"] > 0 and totals["split"] > 0,
          f"the cleargrasp phase's launches: {totals}")
    check(left < 2 ** 28, f"the cleargrasp phase left {left} bytes allocated on the device")
    return totals


# ------------------------------------------------------------------ main


# ------------------------------------------------------------- phase 14

FID_SEED = SEED + 60
FID_BATCH = 32                  # Inception images a batch (the slicewise chunk)
FID_IMPORT_ITER = 40            # the imported checkpoint's iteration (its file name)
FID_VOLUME = (155, 240, 240)    # one BRaTS-shaped volume, slicewise
FID_FEATURE_REL = 1e-4          # card vs CPU features, of max|feature|
FID_SAME_REL = 1e-6             # |FID(real, real)| < this x FID(real, real + 0.5)
# Images a side for FID(real, real): more than the 2048 features, so that
# the covariance has full rank (with fewer, the clipped square roots of its
# zero eigenvalues leave ~1e-5 of FID(real, shifted) in FID(real, real)).
FID_SAMPLES = 66 * FID_BATCH
FID_SAMPLE_SIZE = 64


def fid_weights(root):
    """A seeded port InceptionV3 with random batch-norm statistics (as the
    JAX package's tests draw them), saved as a torchvision-layout `.pth`,
    and its `.npz` written by `python -m ganslate_tpu_torch
    convert-fid-weights` in a subprocess; the `.npz` read back bit for bit."""
    import torch
    from ganslate_tpu_torch.nn.inception import InceptionV3, load_inception_npz
    net = InceptionV3(generator=torch.Generator().manual_seed(FID_SEED))
    g = torch.Generator().manual_seed(FID_SEED + 1)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            buf.copy_(torch.randn(buf.shape, generator=g) * 0.1 if name.endswith("mean")
                      else torch.rand(buf.shape, generator=g) + 0.5)
    state_dict = net.state_dict()
    pth, npz = root / "inception_v3.pth", root / "inception_v3.npz"
    torch.save(state_dict, pth)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(HERE)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    argv = [sys.executable, "-m", "ganslate_tpu_torch", "convert-fid-weights", str(pth), str(npz)]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    loaded = load_inception_npz(npz) if proc.returncode == 0 else {}
    same = sorted(loaded) == sorted(state_dict) and all(
        torch.equal(loaded[k], v) for k, v in state_dict.items())
    rec = {"phase": "fid_weights", "argv": argv[1:], "returncode": proc.returncode,
           "seconds": seconds, "parameters": sum(p.numel() for p in net.parameters()),
           "tensors": len(state_dict), "npz_bit_exact": same}
    emit(rec)
    check(proc.returncode == 0, proc.stderr[-4000:])
    check(same and rec["parameters"] == 23_834_568, rec)
    return state_dict, npz


def fid_import(root, data_root, kind):
    """An original-layout `.pth` of the horse2zebra CycleGAN's four networks
    (seeded, with the Resnet2D alias), through `python -m ganslate_tpu_torch
    import-torch-checkpoint` (in this process); every imported tensor
    checked bit for bit. Returns the YAML's path."""
    import torch
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    from ganslate_tpu_torch.utils.builders import build_gan
    from ganslate_tpu_torch.utils.cli.interface import interface
    from ganslate_tpu_torch.utils.synthetic_data import write_original_checkpoint
    out_dir = root / "fid_out"
    conf = init_config(Conf.create(trainer_raw(out_dir, data_root, kind, 1,
                                               load_iter=FID_IMPORT_ITER)), Config)
    config = root / "fid_test.yaml"
    config.write_text(conf.to_yaml())
    model = build_gan(conf)
    model.init_networks()
    original = root / f"{FID_IMPORT_ITER}.pth"
    source = write_original_checkpoint(original, model.networks, seed=FID_SEED + 2)
    del model
    t0 = time.perf_counter()
    interface.main(["import-torch-checkpoint", str(original), f"config={config}"],
                   standalone_mode=False)
    seconds = time.perf_counter() - t0
    written = torch.load(out_dir / "checkpoints" / f"{FID_IMPORT_ITER}.pth",
                         map_location="cpu", weights_only=True)
    exact = {name: [torch.equal(a, b) for a, b in zip(
        written[name].values(), [v for k, v in source[name].items() if k.startswith("p")])]
        for name in source}
    rec = {"phase": "fid_import", "seconds": seconds, "networks": sorted(written),
           "tensors": {k: len(v) for k, v in exact.items()},
           "aliases_dropped": sum(k.startswith("alias.") for sd in source.values() for k in sd),
           "bit_exact": {k: all(v) for k, v in exact.items()}}
    emit(rec)
    check(sorted(written) == ["D_A", "D_B", "G_AB", "G_BA"], rec)
    check(all(len(written[k]) == len(v) and all(v) for k, v in exact.items()), rec)
    return config


def fid_tester_runs(config, npz):
    """`python -m ganslate_tpu_torch test config=<yaml> test.metrics.fid=true
    test.metrics.fid_weights=<npz>` in this process, its norm launches
    counted; the same test without FID, and with the plain norms. Returns
    the launches, the FID-enabled run's record and a Tester for more."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.engines.utils import init_engine
    from ganslate_tpu_torch.ops import instance_norm as inorm
    from ganslate_tpu_torch.utils.cli.interface import interface
    from ganslate_tpu_torch.utils.trackers.validation_testing import ValTestTracker
    fid_args = ["test.metrics.fid=true", f"test.metrics.fid_weights={npz}"]
    seen = {"fake_B": [], "set_metrics": []}
    add_sample, log_samples = ValTestTracker.add_sample, ValTestTracker.log_samples

    def keep_sample(self, visuals, metrics):
        seen["fake_B"].append(np.array(visuals["fake_B"]))
        return add_sample(self, visuals, metrics)

    def keep_set_metrics(self, *args, set_metrics=None, **kwargs):
        seen["set_metrics"].append(set_metrics)
        return log_samples(self, *args, set_metrics=set_metrics, **kwargs)

    ValTestTracker.add_sample, ValTestTracker.log_samples = keep_sample, keep_set_metrics
    try:
        torch.cuda.synchronize()
        inorm.reset_launches()
        t0 = time.perf_counter()
        interface.main(["test", f"config={config}", *fid_args], standalone_mode=False)
        torch.cuda.synchronize()
        fid_s = time.perf_counter() - t0
        launches = dict(inorm.LAUNCHES)
        out = np.concatenate(seen["fake_B"])
        fid_logged = seen["set_metrics"][-1]

        seen["fake_B"].clear()
        t0 = time.perf_counter()
        init_engine("test", [f"config={config}"]).run()
        torch.cuda.synchronize()
        no_fid_s = time.perf_counter() - t0
        seen["fake_B"].clear()
        with plain_norms():
            inorm.reset_launches()
            init_engine("test", [f"config={config}"]).run()
            check(sum(inorm.LAUNCHES.values()) == 0, "the plain run launched a kernel")
        ref = np.concatenate(seen["fake_B"])
    finally:
        ValTestTracker.add_sample, ValTestTracker.log_samples = add_sample, log_samples
    err = np.abs(out - ref)
    rec = {"phase": "fid_test", "entry": "python -m ganslate_tpu_torch test (in process)",
           "images": len(out), "fid": fid_logged and fid_logged.get("fid"),
           "test_s_with_fid": fid_s, "test_s_without_fid": no_fid_s,
           "max_abs_err_vs_plain": float(err.max()), "mean_abs_err_vs_plain": float(err.mean()),
           "tol": {"max": SLICE_BF16_MAX, "mean": SLICE_BF16_MEAN}, "launches": launches}
    emit(rec)
    check(out.shape == (TRAINER_TEST_IMAGES, SIZE, SIZE, 3) and bool(np.isfinite(out).all()),
          rec)
    check(rec["fid"] is not None and math.isfinite(rec["fid"]) and rec["fid"] >= 0, rec)
    check(rec["max_abs_err_vs_plain"] <= SLICE_BF16_MAX, rec)
    check(rec["mean_abs_err_vs_plain"] <= SLICE_BF16_MEAN, rec)
    check(launches == {k: TRAINER_TEST_IMAGES * v for k, v in G_LAUNCHES.items()}, rec)
    tester = init_engine("test", [f"config={config}", *fid_args])
    return launches, tester


def inception_conv_flops(net, x):
    """FLOPs of the convolutions of one Inception forward on x (NCHW)."""
    import torch
    total = [0]

    def hook(module, inputs, output):
        total[0] += 2 * output.numel() * module.weight[0].numel()

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.inference_mode():
            net.features(x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def fid_inception_checks(state_dict, flops_peak):
    """Inception on the card (fp32, TF32 off) against its CPU forward on the
    same weights; FID(real, real) against FID(real, real + 0.5) over
    FID_SAMPLES images; with TF32 on, the differences only; then device
    times at batch FID_BATCH (CUDA events), the resize's share, features/s,
    peak memory and the host's Frechet solve's seconds (2048^2 `eigh`)."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.nn import inception
    from ganslate_tpu_torch.utils.metrics.fid import fid_from_features

    real = trainer_images(FID_SEED + 3, FID_BATCH, SIZE).astype(np.float32) / 127.5 - 1
    card = inception.fid_feature_fn(state_dict, device="cuda")
    cpu = inception.fid_feature_fn(state_dict, device="cpu")
    f_card, f_cpu = card(real[:4]), cpu(real[:4])
    feat_err = float(np.abs(f_card - f_cpu).max() / np.abs(f_cpu).max())

    def features(fn, x):
        return np.concatenate([fn(x[i:i + FID_BATCH]) for i in range(0, len(x), FID_BATCH)])

    sample = trainer_images(FID_SEED + 4, FID_SAMPLES, FID_SAMPLE_SIZE) \
        .astype(np.float32) / 127.5 - 1
    shifted = np.clip(sample + 0.5, -1, 1)
    f_real, f_shifted = features(card, sample), features(card, shifted)
    same = fid_from_features(f_real, f_real)
    t0 = time.perf_counter()
    diff = fid_from_features(f_real, f_shifted)
    compute_s = time.perf_counter() - t0

    # The same feature function with TF32 on, which the port does not use.
    cudnn = torch.backends.cudnn
    net = inception.inception_from_weights(state_dict, "cuda")

    def tf32(batch):
        x = torch.from_numpy(batch).cuda().permute(0, 3, 1, 2)
        with torch.inference_mode(), cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                                                 deterministic=cudnn.deterministic,
                                                 allow_tf32=True):
            return net.features(inception.fid_resize(x, inception.FID_IMAGE_SIZE)).cpu().numpy()

    f_tf32_real, f_tf32_shifted = features(tf32, sample), features(tf32, shifted)
    tf32_feat = float(np.abs(f_tf32_real - f_real).max() / np.abs(f_real).max())
    fid_tf32 = fid_from_features(f_tf32_real, f_tf32_shifted)

    # Device times at batch FID_BATCH: the resize from 256x256, the forward
    # at 299x299, and the whole feature function (copies included).
    x256 = torch.from_numpy(real).cuda().permute(0, 3, 1, 2).contiguous()
    x299 = inception.fid_resize(x256, inception.FID_IMAGE_SIZE)
    flops = inception_conv_flops(net, x299)
    times = {}
    for label, allow in (("fp32", False), ("tf32", True)):
        with torch.inference_mode(), cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                                                 deterministic=cudnn.deterministic,
                                                 allow_tf32=allow):
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            times[f"forward_ms_{label}"], _ = time_ms(lambda: net.features(x299), iters=5)
            times[f"peak_bytes_{label}"] = torch.cuda.max_memory_allocated() - base
    with torch.inference_mode():
        times["resize_ms"], _ = time_ms(
            lambda: inception.fid_resize(x256, inception.FID_IMAGE_SIZE), iters=5)
    t0 = time.perf_counter()
    for _ in range(5):
        card(real)
    feature_fn_s = (time.perf_counter() - t0) / 5
    fwd = times["forward_ms_fp32"]
    rec = {"phase": "fid_inception", "batch": FID_BATCH, "input": [SIZE, SIZE],
           "resize_to": inception.FID_IMAGE_SIZE,
           "feature_rel_err_vs_cpu": feat_err, "feature_tol": FID_FEATURE_REL,
           "feature_max_abs": float(np.abs(f_cpu).max()),
           "fid_samples": FID_SAMPLES, "fid_sample_size": FID_SAMPLE_SIZE,
           "fid_same": same, "fid_shifted": diff, "same_tol_rel": FID_SAME_REL,
           "fid_compute_s": compute_s,
           "tf32": {"feature_rel_diff": tf32_feat, "fid_shifted": fid_tf32,
                    "fid_rel_shift": (fid_tf32 - diff) / diff},
           **times, "conv_flops": flops,
           "conv_tflops_fp32": flops / (fwd * 1e-3) / 1e12,
           "fp32_bound_ms": flops / flops_peak * 1e3,
           "resize_share": times["resize_ms"] / (times["resize_ms"] + fwd),
           "features_per_s": FID_BATCH / (fwd * 1e-3),
           "feature_fn_s": feature_fn_s, "feature_fn_per_s": FID_BATCH / feature_fn_s}
    emit(rec)
    check(feat_err <= FID_FEATURE_REL, rec)
    check(math.isfinite(diff) and abs(same) < FID_SAME_REL * diff, rec)


def fid_slicewise(tester):
    """One BRaTS-shaped volume (1, 155, 240, 240, 1) through the Tester's
    FID hook, slice by slice in chunks of FID_BATCH, both sides."""
    import numpy as np
    import torch
    vol = next(brats_volumes(FID_SEED + 4, 1, (1, *FID_VOLUME)))
    real = (vol / vol.max() * 2 - 1).astype(np.float32)[..., None]      # (1, D, H, W, 1)
    fake = np.clip(real + np.random.default_rng(FID_SEED + 5).normal(
        0, 0.05, real.shape).astype(np.float32), -1, 1)
    tester.visuals = {"real_B": real, "fake_B": fake}
    chunks = []
    feature_fn = tester.fid.feature_fn
    tester.fid.feature_fn = lambda b: chunks.append(len(b)) or feature_fn(b)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tester._update_fid()
    update_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    value = tester.fid.compute()
    compute_s = time.perf_counter() - t0
    rec = {"phase": "fid_slicewise", "volume": list(real.shape), "chunks": chunks,
           "samples": tester.fid.num_samples("real"), "fid": value,
           "update_s": update_s, "compute_s": compute_s,
           "peak_bytes": torch.cuda.max_memory_allocated() - base}
    emit(rec)
    want = [FID_BATCH] * (FID_VOLUME[0] // FID_BATCH) + [FID_VOLUME[0] % FID_BATCH]
    check(chunks == want * 2 and rec["samples"] == FID_VOLUME[0], rec)
    check(math.isfinite(value) and value >= 0, rec)
    tester.fid.reset()


def fid_phase(root, flops_peak):
    """Phase 14; returns the norm launches of its test run."""
    import importlib.util
    import torch
    t0 = time.perf_counter()
    kind = "image_folder" if importlib.util.find_spec("PIL") else "synthetic_no_pillow"
    data_root = root / "data"
    write_trainer_data(data_root, kind, splits=("test",))
    state_dict, npz = fid_weights(root)
    config = fid_import(root, data_root, kind)
    launches, tester = fid_tester_runs(config, npz)
    fid_slicewise(tester)
    del tester
    gc.collect()
    torch.cuda.empty_cache()
    fid_inception_checks(state_dict, flops_peak)
    emit({"phase": "fid_summary", "seconds": time.perf_counter() - t0, "launches": launches})
    return launches


# ------------------------------------------------------------- phase 16


# Data parallelism across processes, on the one card: (a) the horse2zebra
# experiment from its YAML through `python -m torch.distributed.run
# --nproc_per_node 1 chip_smoke.py --distributed-child train-cli ...`, one
# NCCL rank, which calls the port's command line (`interface.main(["train",
# ...])`, what `-m ganslate_tpu_torch train` runs) under deterministic
# algorithms, against the same child without torchrun; (b)-(d) model-level
# runs on 2 gloo ranks (NCCL refuses two ranks on one device) against one
# process at the global batch. Every child has `DIST_CHILD_TIMEOUT` seconds,
# then its process group is killed.
DIST_CHILD_TIMEOUT = 420
DIST_CHILD_SCRIPT = HERE / "chip_smoke.py"
H2Z_YAML = HERE / "projects" / "horse2zebra" / "experiments" / "default.yaml"
CITYSCAPES_YAML = HERE / "projects" / "cityscapes_label2photo" / "experiments" / "pix2pix.yaml"
# (a): iterations, logging and checkpoint frequency; the profiled iteration.
DIST_CLI_RUN = (4, 2, 2)
DIST_PROFILED_ITER = 3
DIST_LEFT_OUT = {"train.logging.wandb": "the wandb package would contact its server",
                 "val.metrics.fid": "no Inception weights in the repo",
                 "train.mixed_precision": "fp32, so that the runs compare bit for bit"}
# (b), (c): fp32 steps at a global batch of 2 (1 a rank).
DIST_STEPS = {"cyclegan": 3, "pix2pix": 2}
DIST_LOSS_RTOL = 1e-5
# Adam's first update, lr g / (|g| + eps), takes the sign of a gradient
# component that rounding decides, and the next steps follow it: the losses
# of the later steps and each weight tensor after the last are also read
# against the one-ulp control, the 1-rank run with plain norms repeated
# with one-ulp noise on every norm output (instance and batch). A loss, or a
# tensor, passes within `DIST_CONTROL_RATIO` times its own gap in the
# control where that exceeds the bound. (A bias that starts at zero differs
# by as much as its updates do: 16% relative L2 in the full-width
# CycleGAN's control on an H100; a large conv weight's gap stays far below
# the bound, which then holds it.)
DIST_CONTROL_RATIO = 3
# (c): batch norm (the pix2pix paper's norm) in place of the YAML's default
# instance norm, so that the statistics span the ranks.
DIST_PIX2PIX_NORM = "batch"
DIST_PIX2PIX_SIZE = (256, 512)
# (d): the sliding_window phase's request split over 2 ranks; fp32 within
# 1e-5 of max|out| (the two runs sum the windows in another order), bf16
# within the phase's bound against the plain norms. A check of the library
# path, `SlidingWindowInferer(distributed=True)`, called on the Inferer's
# generator with the same volume on every rank: no entry point turns the
# split on, since the engines' loaders give each rank its own samples.
DIST_SW_PATH = ("library: the Inferer's SlidingWindowInferer with distributed=True set on it; "
                "the engines keep it off (their loaders split the samples)")
DIST_SW_FP32_REL = 1e-5


def h2z_args(out_dir, data_root, extra=()):
    """`init_engine`'s arguments for the horse2zebra YAML with only (a)'s
    overrides: the roots, the loop lengths and frequencies, a seed, and
    `DIST_LEFT_OUT`."""
    n_iters, log_freq, ckpt_freq = DIST_CLI_RUN
    return [f"config={H2Z_YAML}", f"train.output_dir={out_dir}",
            f"train.dataset.root={data_root / 'train'}", f"val.dataset.root={data_root / 'test'}",
            f"infer.dataset.root={data_root / 'test'}",
            f"train.n_iters={n_iters - n_iters // 2}", f"train.n_iters_decay={n_iters // 2}",
            f"train.logging.freq={log_freq}", f"train.checkpointing.freq={ckpt_freq}",
            f"val.freq={10 * n_iters}", f"train.seed={SEED + 70}", "train.logging.wandb=null",
            "val.metrics.fid=false", "train.mixed_precision=false", *extra]


def dist_cyclegan_args(out_dir):
    """(b): the horse2zebra YAML at a global batch of 2 in fp32."""
    return [f"config={H2Z_YAML}", f"train.output_dir={out_dir}", "train.batch_size=2",
            "train.mixed_precision=false", f"train.seed={SEED + 71}", "train.logging.wandb=null",
            "val.metrics.fid=false"]


def dist_pix2pix_args(out_dir):
    """(c): the Cityscapes Pix2Pix YAML at a global batch of 2 in fp32, with
    batch norm (`DIST_PIX2PIX_NORM`) and the validation size that its
    U-Net takes."""
    return [f"config={CITYSCAPES_YAML}", f"train.output_dir={out_dir}", "train.batch_size=2",
            "train.mixed_precision=false", f"train.seed={SEED + 72}", "train.logging.wandb=null",
            "val.dataset.load_size=[256,512]", f"train.gan.norm_type={DIST_PIX2PIX_NORM}"]


def dist_launch(task, out_dir, work, nproc=None, timeout=DIST_CHILD_TIMEOUT):
    """`chip_smoke.py --distributed-child task out_dir` in its own process
    group: under `torch.distributed.run --standalone --nproc_per_node
    nproc`, or alone when `nproc` is None. Waits at most
    `timeout` seconds, then kills the group; kills whatever of it is
    left either way. Returns each rank's results and the wall seconds."""
    return dist_launch_together([(task, out_dir, nproc)], work, timeout)[0]


def dist_launch_together(launches, work, timeout=DIST_CHILD_TIMEOUT):
    """`dist_launch` of each `(task, out_dir, nproc)` of `launches`, all
    started at once and waited on together (at most `timeout` seconds from
    the start); returns `(results, seconds)` of each, in order."""
    import signal
    import torch
    t0 = time.perf_counter()
    started = [_dist_start(task, out_dir, work, nproc) for task, out_dir, nproc in launches]
    rcs, seconds = [], []
    for proc in started:
        try:
            rcs.append(proc.wait(timeout=max(t0 + timeout - time.perf_counter(), 0.1)))
        except subprocess.TimeoutExpired:
            rcs.append("timeout")
        seconds.append(time.perf_counter() - t0)
    for proc in started:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    out = []
    for (task, out_dir, nproc), rc, secs in zip(launches, rcs, seconds):
        if rc != 0:
            log_path = out_dir / f"{task}_{nproc or 0}.log"
            emit({"phase": "distributed_child", "task": task, "nproc": nproc, "returncode": rc,
                  "seconds": secs, "log_tail": log_path.read_text()[-6000:]})
            raise AssertionError(f"the {task} child (nproc {nproc}) ended with {rc}")
        out.append(([torch.load(out_dir / f"{task}_rank{r}.pt", weights_only=False)
                     for r in range(nproc or 1)], secs))
    return out


def _dist_start(task, out_dir, work, nproc):
    """Start `dist_launch`'s command in its own session, its output in
    `out_dir/<task>_<nproc or 0>.log`."""
    out_dir.mkdir(parents=True, exist_ok=True)
    runner = [] if nproc is None else ["-m", "torch.distributed.run", "--standalone",
                                       f"--nproc_per_node={nproc}"]
    argv = [sys.executable, *runner, str(DIST_CHILD_SCRIPT), "--distributed-child", task,
            str(out_dir)]
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8", "OMP_NUM_THREADS": "4",
           "NCCL_SOCKET_IFNAME": "lo", "PYTHONPATH": os.pathsep.join(
               [str(HERE)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                              if p])}
    with open(out_dir / f"{task}_{nproc or 0}.log", "w") as log:
        return subprocess.Popen(argv, cwd=work, env=env, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)


def dist_child(task, out_dir):
    """A child of `dist_launch`: joins the process group (under torchrun),
    runs `task` and saves its results as `<task>_rank<r>.pt`."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    inorm.library()
    rank = int(os.environ.get("RANK", "0"))
    result = {"train-cli": dist_train_cli, "models": dist_models,
              "spatial": spatial_child}[task](out_dir)
    torch.save(result, out_dir / f"{task}_rank{rank}.pt")
    return 0


def dist_train_cli(out_dir):
    """(a) in a child: the port's `train` command on the horse2zebra YAML,
    with each iteration's losses read back, the process group's backend,
    and iteration `DIST_PROFILED_ITER` under `torch.profiler` (its NCCL
    kernels counted)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ganslate_tpu_torch.engines.trainer import Trainer
    from ganslate_tpu_torch.ops import instance_norm as inorm
    from ganslate_tpu_torch.utils import communication
    from ganslate_tpu_torch.utils.cli.interface import interface
    seen = {"losses": {}, "step_ms": {}}
    run_iteration = Trainer._run_iteration

    def recorded(self, batches):
        seen["backend"], seen["world"] = communication.backend(), communication.get_world_size()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if self.iter_idx == DIST_PROFILED_ITER:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run_iteration(self, batches)
                torch.cuda.synchronize()
            nccl = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                    and "nccl" in e.name.lower()]
            seen["nccl_kernels"] = len(nccl)
            seen["nccl_kernel_names"] = {n: sum(e.name == n for e in nccl)
                                         for n in sorted({e.name for e in nccl})}
            seen["nccl_device_ms"] = sum(e.device_time_total for e in nccl) / 1e3
        else:
            run_iteration(self, batches)
        torch.cuda.synchronize()
        seen["step_ms"][self.iter_idx] = (time.perf_counter() - t0) * 1e3
        seen["losses"][self.iter_idx] = {k: float(v) for k, v in self.model.losses.items()}

    Trainer._run_iteration = recorded
    inorm.reset_launches()
    data_root = Path(os.environ["GANSLATE_DIST_DATA"])
    interface.main(["train", *h2z_args(out_dir / "run", data_root)], standalone_mode=False)
    torch.cuda.synchronize()
    return {**seen, "launches": dict(inorm.LAUNCHES)}


def dist_model_steps(model, batches, n_steps):
    """`n_steps` fp32 steps of `model` on this rank's share of each global
    batch: per step the losses reduced over the ranks, the host time of the
    step (synchronised) and of its gradient all-reduces (each synchronised
    around); the averaged gradients of step 1 and the parameters before
    and after, on the host."""
    import torch
    from ganslate_tpu_torch.nn.gans import base
    from ganslate_tpu_torch.utils import communication
    rank, world = communication.get_rank(), communication.get_world_size()
    average = base.average_gradients
    spent = []

    def timed_average(params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        average(params)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)

    def host(grads=False):
        """Every parameter (or its gradient, where it has one) on the host."""
        return {f"{name}.{k}": (p.grad if grads else p).detach().float().cpu().clone()
                for name, net in model.networks.items() for k, p in net.named_parameters()
                if not grads or p.grad is not None}

    initial = host()
    losses, step_ms, allreduce_ms, grads = [], [], [], None
    base.average_gradients = timed_average
    try:
        for i, batch in enumerate(batches[:n_steps]):
            n = len(batch["A"]) // world
            model.set_input({k: v[rank * n:(rank + 1) * n] for k, v in batch.items()})
            spent.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.optimize_parameters(sync=True)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            allreduce_ms.append(sum(spent) * 1e3)
            losses.append(communication.reduce({k: float(v) for k, v in model.losses.items()}))
            if i == 0:
                grads = host(grads=True)
    finally:
        base.average_gradients = average
    return {"losses": losses, "step_ms": step_ms, "allreduce_ms": allreduce_ms,
            "grads": grads, "initial": initial, "params": host(),
            "backend": communication.backend(), "world": world}


@contextlib.contextmanager
def batch_norm_ulp_noise():
    """`plain_forward(ulp_noise=True)`'s noise on every batch-norm output."""
    import torch
    from ganslate_tpu_torch.nn import layers
    forward = layers.BatchNorm.forward
    gens = {}

    def noisy(self, x):
        y = forward(self, x)
        if y.device not in gens:
            gens[y.device] = torch.Generator(device=y.device).manual_seed(SEED + 11)
        sign = torch.randint(-1, 2, y.shape, generator=gens[y.device], device=y.device)
        return y * (1 + sign * 2.0 ** -23)

    layers.BatchNorm.forward = noisy
    try:
        yield
    finally:
        layers.BatchNorm.forward = forward


@contextlib.contextmanager
def norm_ulp_noise():
    with plain_forward(ulp_noise=True), batch_norm_ulp_noise():
        yield


def dist_one_ulp_control(conf, batches, n_steps):
    """The gap that one-ulp noise on every norm output makes (plain norms,
    with and without the noise, each from a fresh model of the seed): the
    gradients of step 1, the losses of each step and the weights after the
    last, as (b) and (c) measure the ranks' gap."""
    import torch
    from ganslate_tpu_torch.utils.builders import build_gan
    runs = {}
    for label, norms in (("plain", plain_forward), ("noisy", norm_ulp_noise)):
        model = build_gan(conf)
        model.setup(batches[0])
        with norms():
            runs[label] = dist_model_steps(model, batches, n_steps)
        del model
        torch.cuda.empty_cache()
    plain, noisy = runs["plain"], runs["noisy"]
    weights = {k: rel_l2(noisy["params"][k], w) for k, w in plain["params"].items()}
    return {"grad_rel_l2_max": max(rel_l2(noisy["grads"][k], g)
                                   for k, g in plain["grads"].items()),
            "loss_rel_err_by_step": [max(abs(x[k] - y[k]) / abs(y[k]) for k in y)
                                     for x, y in zip(noisy["losses"], plain["losses"])],
            "weight_rel_l2_max": max(weights.values()), "weight_rel_l2": weights}


def dist_batches(shape, n, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [{k: rng.uniform(-1, 1, shape).astype(np.float32) for k in ("A", "B")}
            for _ in range(n)]


def dist_models(out_dir):
    """(b)-(d) in a child: the full-width CycleGAN and Pix2Pix steps at a
    global batch of 2 and the BRaTS sliding-window request, on this rank's
    share; without a process group, at the global batch, with the one-ulp
    control of (b)."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.engines.inferer import Inferer
    from ganslate_tpu_torch.ops import instance_norm as inorm
    from ganslate_tpu_torch.utils import communication
    from ganslate_tpu_torch.utils.builders import build_conf, build_G, build_gan
    from ganslate_tpu_torch.utils.testing import make_vnet_conf
    communication.init_distributed(cuda=True)
    rank = communication.get_rank()
    out, launches = {}, {}

    for name, args, shape in (
            ("cyclegan", dist_cyclegan_args(out_dir / "cyclegan"), (2, SIZE, SIZE, 3)),
            ("pix2pix", dist_pix2pix_args(out_dir / "pix2pix"), (2, *DIST_PIX2PIX_SIZE, 3))):
        t0 = time.perf_counter()
        conf = build_conf(args)
        batches = dist_batches(shape, DIST_STEPS[name], SEED + 73)
        world = communication.get_world_size()
        model = build_gan(conf)
        n = 2 // world
        model.setup({k: v[rank * n:(rank + 1) * n] for k, v in batches[0].items()})
        inorm.reset_launches()
        out[name] = dist_model_steps(model, batches, DIST_STEPS[name])
        launches[name] = dict(inorm.LAUNCHES)
        out[name]["n_params"] = sum(p.numel() for net in model.networks.values()
                                    for p in net.parameters())
        del model
        torch.cuda.empty_cache()
        if not communication.is_distributed():
            out[name]["control"] = dist_one_ulp_control(conf, batches, DIST_STEPS[name])
        out[name]["seconds"] = time.perf_counter() - t0

    x = np.random.default_rng(SEED + 20).uniform(-1, 1, SW_VOLUMES).astype(np.float32)
    sw_dir = out_dir / "sliding_window"
    if rank == 0:
        g = build_G(make_vnet_conf(str(sw_dir), load_iter=1), "AB",
                    torch.Generator().manual_seed(SEED))
        (sw_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
        torch.save({"G_AB": g.state_dict()}, sw_dir / "checkpoints" / "1.pth")
        del g
    communication.synchronize()
    for dtype, kwargs in (("bfloat16", {}),
                          ("float32", {"mixed_precision": False, "wire_dtype": "float32"})):
        t0 = time.perf_counter()
        inferer = Inferer(make_vnet_conf(str(sw_dir), load_iter=1, **kwargs))
        inferer.sliding_window_inferer.distributed = True       # DIST_SW_PATH
        inorm.reset_launches()
        seconds = []
        for _ in range(2):                  # the first call is cold
            communication.synchronize()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            y = inferer.infer(x)
            seconds.append(time.perf_counter() - t1)
        launches[f"sliding_window_{dtype}"] = dict(inorm.LAUNCHES)
        out[f"sliding_window_{dtype}"] = {"seconds": seconds, "y": y if rank == 0 else None,
                                          "task_seconds": time.perf_counter() - t0}
        del inferer
        torch.cuda.empty_cache()
    out["launches"] = launches
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["backend"] = communication.backend()
    communication.destroy_distributed()
    return out


def dist_cli_check(root, data_root, work):
    """(a): the `train` command under torchrun on one NCCL rank against the
    same child without torchrun: the losses of every iteration and every
    tensor of the last checkpoint bit for bit, NCCL kernels in the
    profiled iteration. Returns the torchrun run's norm launches."""
    import torch
    # The two children run at once: deterministic algorithms, so sharing the
    # card moves their times, not their numbers.
    labels = (("plain", None), ("torchrun", 1))
    launched = dist_launch_together([("train-cli", root / f"cli_{label}", nproc)
                                     for label, nproc in labels], work)
    runs = {label: {**results[0], "seconds": seconds}
            for (label, _), (results, seconds) in zip(labels, launched)}
    n_iters = DIST_CLI_RUN[0]
    ckpts = {label: torch.load(root / f"cli_{label}" / "run" / "checkpoints" / f"{n_iters}.pth",
                               map_location="cpu", weights_only=True) for label in runs}
    networks = ("G_AB", "G_BA", "D_B", "D_A")
    unequal = [f"{name}.{k}" for name in networks for k, v in ckpts["plain"][name].items()
               if not torch.equal(v, ckpts["torchrun"][name][k])]
    plain, ranked = runs["plain"], runs["torchrun"]
    rec = {"phase": "distributed_nccl", "yaml": str(H2Z_YAML.relative_to(HERE)),
           "entry": "torchrun --standalone --nproc_per_node 1 -> interface.main(['train', ...])",
           "backend": ranked.get("backend"), "world": ranked.get("world"),
           "plain_backend": plain.get("backend") or "none (no process group)",
           "iterations": n_iters, "cuts": DIST_LEFT_OUT,
           "losses_bit_equal": plain["losses"] == ranked["losses"],
           "checkpoint_tensors_unequal": unequal,
           "nccl_kernels_in_profiled_step": ranked.get("nccl_kernels"),
           "nccl_kernel_names": ranked.get("nccl_kernel_names"),
           "nccl_device_ms": ranked.get("nccl_device_ms"),
           "step_ms": {"plain": plain["step_ms"], "torchrun": ranked["step_ms"]},
           "child_seconds": {"plain": plain["seconds"], "torchrun": ranked["seconds"]},
           "launches": ranked["launches"], "losses": ranked["losses"]}
    emit(rec)
    check(rec["backend"] == "nccl" and rec["world"] == 1, rec)
    check(sorted(ranked["losses"]) == list(range(1, n_iters + 1)), rec)
    check(all(math.isfinite(v) for s in ranked["losses"].values() for v in s.values()), rec)
    check(rec["losses_bit_equal"] and not unequal, rec)
    check((rec["nccl_kernels_in_profiled_step"] or 0) > 0, "no NCCL kernel in the profile")
    check(plain["launches"] == ranked["launches"], rec)
    return ranked["launches"]


def dist_models_check(root, work):
    """(b)-(d): the 2-rank gloo child against the 1-rank child. Returns the
    2-rank run's norm launches."""
    import torch
    # The 1-rank reference runs beside the 2 ranks: its numbers are its own,
    # and all three processes' times share the card and the host.
    ((ref,), ref_seconds), (ranks, seconds) = dist_launch_together(
        [("models", root / "models_1", None), ("models", root / "models_2", 2)], work)
    got = ranks[0]
    caveat = ("2 ranks share one card with the 1-rank reference running beside them: a check "
              "of the arithmetic, not a scaling figure; the gloo all-reduce goes through host "
              "memory")
    check([r["backend"] for r in ranks] == ["gloo", "gloo"] and ref["backend"] == "", ranks[0]
          ["backend"])
    for name in ("cyclegan", "pix2pix"):
        a, b = got[name], ref[name]
        control = dict(b["control"])
        control_weights = control.pop("weight_rel_l2")
        loss_err = [max(abs(x[k] - y[k]) / abs(y[k]) for k in y)
                    for x, y in zip(a["losses"], b["losses"])]
        loss_tol = [DIST_LOSS_RTOL] + [max(DIST_LOSS_RTOL, DIST_CONTROL_RATIO * c)
                                       for c in control["loss_rel_err_by_step"][1:]]
        grad_err = {k: rel_l2(a["grads"][k], g) for k, g in b["grads"].items()}
        weight_err = {k: rel_l2(a["params"][k], w) for k, w in b["params"].items()}
        weight_tol = {k: max(TRAIN_FP32_GRAD_MAX, DIST_CONTROL_RATIO * control_weights[k])
                      for k in weight_err}
        weight_ratio = {k: e / weight_tol[k] for k, e in weight_err.items()}
        closest = max(weight_ratio, key=weight_ratio.get)
        update_err = {k: rel_l2(a["params"][k] - a["initial"][k], w - b["initial"][k])
                      for k, w in b["params"].items() if not torch.equal(w, b["initial"][k])}
        replica_equal = all(torch.equal(ranks[1][name]["params"][k], v)
                            for k, v in a["params"].items())
        worst = max(grad_err, key=grad_err.get)
        worst_weight = max(weight_err, key=weight_err.get)
        rec = {"phase": f"distributed_{name}", "backend": "gloo", "ranks": 2,
               "global_batch": 2, "steps": len(a["losses"]), "dtype": "float32",
               "params": a["n_params"], "losses": a["losses"], "loss_rel_err_by_step": loss_err,
               "loss_tol_by_step": loss_tol, "grad_rel_l2_max": grad_err[worst],
               "grad_rel_l2_worst": worst,
               "grad_rel_l2_median": statistics.median(grad_err.values()),
               "grad_tol": TRAIN_FP32_GRAD_MAX, "weight_rel_l2_max": weight_err[worst_weight],
               "weight_rel_l2_worst": worst_weight, "weight_tol": weight_tol[worst_weight],
               "weight_control_rel_l2": control_weights[worst_weight],
               "weight_err_over_tol_max": weight_ratio[closest],
               "weight_err_over_tol_worst": closest,
               "weight_tol_of_worst_ratio": weight_tol[closest],
               "weights_over_tol": sorted(k for k, r in weight_ratio.items() if r > 1),
               "weight_tols_above_bound": sum(t > TRAIN_FP32_GRAD_MAX
                                              for t in weight_tol.values()),
               "weight_tensors": len(weight_tol),
               "update_rel_l2_max": max(update_err.values()),
               "update_rel_l2_median": statistics.median(update_err.values()),
               "one_ulp_control": control, "replicas_bit_equal": replica_equal,
               "step_ms_2_ranks": a["step_ms"], "allreduce_ms_2_ranks": a["allreduce_ms"],
               "step_ms_1_rank": b["step_ms"], "timing_caveat": caveat,
               "task_seconds": {"1_rank": b["seconds"], "2_ranks": a["seconds"]},
               "launches": got["launches"][name]}
        if name == "pix2pix":
            rec["norm"] = DIST_PIX2PIX_NORM
        emit(rec)
        check(len(loss_err) == DIST_STEPS[name]
              and all(e <= t for e, t in zip(loss_err, loss_tol)), rec)
        check(grad_err[worst] <= TRAIN_FP32_GRAD_MAX, rec)
        check(not rec["weights_over_tol"] and replica_equal, rec)
    for dtype in ("bfloat16", "float32"):
        y, want = (r[f"sliding_window_{dtype}"]["y"] for r in (got, ref))
        err = (y.float() - want.float()).abs()
        rec = {"phase": "distributed_sliding_window", "backend": "gloo",
               "ranks": 2, "volumes": list(SW_VOLUMES), "path": DIST_SW_PATH,
               "max_abs_err_vs_1_rank": float(err.max()),
               "mean_abs_err_vs_1_rank": float(err.mean()),
               "max_abs_out": float(want.float().abs().max()),
               "seconds_2_ranks": got[f"sliding_window_{dtype}"]["seconds"],
               "seconds_1_rank": ref[f"sliding_window_{dtype}"]["seconds"],
               "task_seconds": {"1_rank": ref[f"sliding_window_{dtype}"]["task_seconds"],
                                "2_ranks": got[f"sliding_window_{dtype}"]["task_seconds"]},
               "timing_caveat": caveat, "launches_rank0": got["launches"][
                   f"sliding_window_{dtype}"]}
        sw_output_check(rec, y, SW_VOLUMES)
        if dtype == "float32":
            rec["tol_max"] = DIST_SW_FP32_REL * rec["max_abs_out"]
            emit(rec)
            check(rec["max_abs_err_vs_1_rank"] <= rec["tol_max"], rec)
        else:
            rec.update(tol_max=SW_BF16_MAX, tol_mean=SW_BF16_MEAN)
            emit(rec)
            check(rec["max_abs_err_vs_1_rank"] <= SW_BF16_MAX
                  and rec["mean_abs_err_vs_1_rank"] <= SW_BF16_MEAN, rec)
    emit({"phase": "distributed_models", "child_seconds": {"1_rank": ref_seconds,
                                                           "2_ranks": seconds},
          "peak_memory_bytes": {"1_rank": ref["peak_memory_bytes"],
                                "2_ranks": [r["peak_memory_bytes"] for r in ranks]}})
    totals = {}
    for r in ranks:
        for counts in r["launches"].values():
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
    return totals


def distributed_phase(root):
    """Phase 16; returns the norm launches of its torchrun children."""
    import importlib.util
    from ganslate_tpu_torch.ops import instance_norm as inorm
    t0 = time.perf_counter()
    check(importlib.util.find_spec("PIL") is not None, "the horse2zebra YAML reads PNGs: Pillow")
    data_root = root / "data"
    write_trainer_data(data_root, "image_folder")
    os.environ["GANSLATE_DIST_DATA"] = str(data_root)
    with experiment_workdir(root) as work:
        cli = dist_cli_check(root, data_root, work)
        models = dist_models_check(root, work)
    totals = {k: cli.get(k, 0) + models.get(k, 0) for k in inorm.LAUNCHES}
    emit({"phase": "distributed_summary", "seconds": time.perf_counter() - t0,
          "launches": totals})
    return totals


# ------------------------------------------------------------ phase 17


# The spatial phase: spatial sharding across processes, 2 gloo ranks on the
# one card (NCCL refuses two ranks on one device), against one process.
# (b)'s run: (warm-up iterations, timed iterations, logging.freq,
# checkpointing.freq, val.freq); the last timed iteration times its halo
# exchanges and collectives (each between device synchronisations), the
# others not.
SPATIAL_RANKS = 2
SPATIAL_RUN = (1, 3, 1, 100, 100)
SPATIAL_SLAB = (1, 16, 176, 176, 16)            # (a): one shard of a level-0 slab
SPATIAL_VOLUME = (1, 64, 176, 176, 1)           # (c)
SPATIAL_HALO = 16                               # (c), method 'halo'
SPATIAL_MEMORY_MAX = 0.65                       # per rank, of the 1-process peak
SPATIAL_LEFT_OUT = {"train.logging.wandb": "the wandb package would contact its server",
                    "train.seed": "unset in the YAML (drawn) -> the script's seed"}


def spatial_args(out_dir, sharded, mixed_precision=None):
    """`cyclegan.yaml` with phase 11's overrides for `SPATIAL_RUN`, its own
    output directory and, sharded, `train.spatial_mesh`."""
    return [*brats_cyclegan_args("cyclegan.yaml", SPATIAL_RUN, mixed_precision),
            f"train.output_dir={out_dir}",
            *([f"train.spatial_mesh={SPATIAL_RANKS}"] if sharded else [])]


def spatial_stats_check(bandwidth):
    """(a), first half: the stats kernel's (mean, M2) mode on one shard's
    slab against `partial_stats_reference` on the same input; the library
    time is `torch.var_mean` over the same axes (the same statistics, the
    variance for M2 / count)."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    recs = []
    axes = tuple(range(1, len(SPATIAL_SLAB) - 1))
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device="cuda").manual_seed(SEED + 100)
        x = (torch.randn(SPATIAL_SLAB, generator=g, device="cuda") * 2 + 1).to(dtype)
        x = x.contiguous()
        mean, m2 = inorm.split_partial_stats(x)
        want_mean, want_m2 = inorm.partial_stats_reference(x)
        ms, host_bound = time_ms(lambda: inorm.split_partial_stats(x))
        plain_ms, _ = time_ms(lambda: inorm.partial_stats_reference(x))
        library_ms, library_host_bound = time_ms(
            lambda: torch.var_mean(x, dim=axes, correction=0))
        rec = {"phase": "spatial_stats_m2", "shape": list(SPATIAL_SLAB), "dtype": str(dtype),
               "mean_max_abs_err": float((mean - want_mean).abs().max()),
               "m2_max_rel_err": float(((m2 - want_m2).abs() / want_m2.abs()).max()),
               "tol_rel": STAT_RTOL, "ms": ms, "host_bound": host_bound, "plain_ms": plain_ms,
               "library_ms": library_ms, "library": "torch.var_mean(x, dim, correction=0)",
               "library_host_bound": library_host_bound,
               "bound_ms": x.numel() * x.element_size() / bandwidth * 1e3}
        emit(rec)
        check(rec["mean_max_abs_err"] <= STAT_RTOL * float(want_m2.div(
            math.prod(SPATIAL_SLAB[1:-1])).sqrt().max()) and rec["m2_max_rel_err"] <= STAT_RTOL,
            rec)
        recs.append(rec)
    return recs


def spatial_norm_check():
    """(a), second half, on 2 ranks: the sharded norm (+ leaky ReLU) of
    this rank's slab, and its folded statistics, against the plain version
    (`instance_norm_reference`) on the whole tensor, and its time (two
    ranks sharing the card)."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    from ganslate_tpu_torch.parallel import spatial
    scope = spatial.make_scope(0)
    n = SPATIAL_SLAB[1]
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device="cuda").manual_seed(SEED + 101)
        shape = (1, n * scope.size, *SPATIAL_SLAB[2:])
        x = (torch.randn(shape, generator=g, device="cuda") * 2 + 1).to(dtype)
        want, want_mean, want_rstd = inorm.instance_norm_reference(x, 1e-5, "leaky_relu", 0.2)
        slab = x.narrow(1, scope.index * n, n).contiguous()

        def sharded():
            return inorm.sharded_instance_norm_forward(slab, 1e-5, "leaky_relu", 0.2, scope)

        got, mean, rstd = sharded()
        want = want.narrow(1, scope.index * n, n)
        err = (got.float() - want.float()).abs()
        tol = TOL["bfloat16" if dtype == torch.bfloat16 else "float32"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            sharded()
        torch.cuda.synchronize()
        out[str(dtype)] = {
            "max_abs_err": float(err.max()),
            "over_tol": int((err > tol["atol"] + tol["rtol"] * want.float().abs()).sum()),
            "mean_rel_err": float(((mean - want_mean).abs()
                                   / want_rstd.reciprocal()).max()),
            "rstd_rel_err": float(((rstd - want_rstd).abs() / want_rstd).max()),
            "ms_2_ranks_sharing_the_card": (time.perf_counter() - t0) * 1e2,
            "tol": tol}
    return out


def spatial_fp32_step(out_dir, sharded):
    """(b)'s step 1 in fp32, model-level, from the seed's weights: the
    losses (the spatial group's sums) and every gradient; in one process,
    also the same step with plain norms with and without one-ulp noise
    (`dist_one_ulp_control`'s control)."""
    import torch
    from ganslate_tpu_torch.utils.builders import build_conf, build_gan
    conf = build_conf(spatial_args(out_dir / "fp32", sharded, mixed_precision=False))
    batch = brats_batches(conf, n=1)[0][0]

    def step(norms):
        model = build_gan(conf)
        model.setup(batch)
        with norms():
            model.set_input(batch)
            model.optimize_parameters(sync=True)
        run = {"losses": {k: float(v) for k, v in model.losses.items()},
               "grads": {f"{name}.{k}": p.grad.detach().float().cpu().clone()
                         for name, net in model.networks.items()
                         for k, p in net.named_parameters() if p.grad is not None}}
        del model
        gc.collect()
        torch.cuda.empty_cache()
        return run

    runs = {"kernel": step(contextlib.nullcontext)}
    if not sharded:
        runs["plain"] = step(plain_forward)
        runs["noisy"] = step(norm_ulp_noise)
    return runs


def spatial_infer(out_dir, sharded):
    """(c): the volume through the deployment `Inferer` of a BRaTS Vnet3D
    (seeded weights, rank 0's checkpoint) with `infer.spatial_sharding`;
    sharded, by each method, else the direct forward. Two requests each
    (the first is cold): outputs, seconds, norm launches."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.engines.inferer import Inferer
    from ganslate_tpu_torch.ops import instance_norm as inorm
    from ganslate_tpu_torch.parallel import spatial
    from ganslate_tpu_torch.utils import communication
    from ganslate_tpu_torch.utils.builders import build_G
    from ganslate_tpu_torch.utils.testing import make_vnet_conf
    x = np.random.default_rng(SEED + 102).uniform(-1, 1, SPATIAL_VOLUME).astype(np.float32)
    ckpt_dir = out_dir / "infer"
    if communication.is_main_process():
        g = build_G(make_vnet_conf(str(ckpt_dir), load_iter=1), "AB",
                    torch.Generator().manual_seed(SEED))
        (ckpt_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
        torch.save({"G_AB": g.state_dict()}, ckpt_dir / "checkpoints" / "1.pth")
        del g
    communication.synchronize()
    runs = (("gspmd", "bfloat16"), ("gspmd", "float32"), ("halo", "bfloat16")) if sharded \
        else (("direct", "bfloat16"), ("direct", "float32"))
    out = {}
    for method, dtype in runs:
        fp32 = {"mixed_precision": False, "wire_dtype": "float32"} if dtype == "float32" else {}
        sharding = {"method": "gspmd" if method == "direct" else method, "dim": 0,
                    "halo": SPATIAL_HALO}
        inferer = Inferer(make_vnet_conf(str(ckpt_dir), load_iter=1, spatial_sharding=sharding,
                                         **fp32))
        inorm.reset_launches()
        spatial.reset_counts()
        seconds = []
        for _ in range(2):
            communication.synchronize()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = inferer.infer(x)
            seconds.append(time.perf_counter() - t0)
        out[f"{method}_{dtype}"] = {"y": y, "seconds": seconds,
                                    "launches": dict(inorm.LAUNCHES),
                                    "exchanges": dict(spatial.COUNTS)}
        del inferer
        gc.collect()
        torch.cuda.empty_cache()
    return out


def spatial_train_cli(out_dir, sharded):
    """(b): the port's `train` command on `cyclegan.yaml` (bf16, the
    YAML's), sharded with `train.spatial_mesh`: per iteration the losses,
    the host time of the iteration (synchronised), the exchanges and each
    network's gathers; the last iteration's halo and collective seconds;
    the run's norm launches and peak device memory."""
    import torch
    from ganslate_tpu_torch.engines.trainer import Trainer
    from ganslate_tpu_torch.ops import instance_norm as inorm
    from ganslate_tpu_torch.parallel import spatial
    from ganslate_tpu_torch.utils import communication
    from ganslate_tpu_torch.utils.cli.interface import interface
    n_iters = SPATIAL_RUN[0] + SPATIAL_RUN[1]
    seen = {"losses": {}, "step_ms": {}, "exchanges": {}, "gathers": {}, "seconds": {}}
    gathers, started, hooked = {}, {}, []
    run_iteration = Trainer._run_iteration

    def hook(model):
        for name, net in model.networks.items():
            def pre(mod, args, name=name):
                started[name] = spatial.COUNTS["gather"]

            def post(mod, args, result, name=name):
                gathers[name] = gathers.get(name, 0) + spatial.COUNTS["gather"] - started[name]
            net.register_forward_pre_hook(pre)
            net.register_forward_hook(post)
        hooked.append(True)

    def recorded(self, batches):
        if not hooked:
            hook(self.model)
        seen["layout"] = (communication.get_data_size(), communication.get_spatial_size())
        spatial.TIMED = sharded and self.iter_idx == n_iters
        spatial.reset_counts()
        gathers.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            run_iteration(self, batches)
            torch.cuda.synchronize()
        finally:
            spatial.TIMED = False
        i = self.iter_idx
        seen["step_ms"][i] = (time.perf_counter() - t0) * 1e3
        seen["losses"][i] = {k: float(v) for k, v in self.model.losses.items()}
        seen["exchanges"][i] = dict(spatial.COUNTS)
        seen["seconds"][i] = dict(spatial.SECONDS)
        seen["gathers"][i] = dict(gathers)

    Trainer._run_iteration = recorded
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    inorm.reset_launches()
    t0 = time.perf_counter()
    try:
        interface.main(["train", *spatial_args(out_dir / "run", sharded)],
                       standalone_mode=False)
    finally:
        Trainer._run_iteration = run_iteration
    torch.cuda.synchronize()
    return {**seen, "launches": dict(inorm.LAUNCHES), "seconds_run": time.perf_counter() - t0,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "allocated_before_bytes": before}


# (d): every family that the CycleGAN's sharding did not cover, model-level
# at the widths of its own phase (the BRaTS RevGAN with memory saving, the
# Cityscapes Pix2Pix, the BRaTS CUT, the zoo's two BRaTS configs, the HX4
# and ClearGrasp balanced CycleGANs), on one synthetic batch of the phase's
# patch or image size: (spatial extents, channels of A and B).
SPATIAL_ZOO = {"revgan": (REVGAN_PATCH, (1, 1)), "pix2pix": (PIX2PIX_SIZE, (3, 3)),
               "cut": (REVGAN_PATCH, (1, 1)), "sa_vnet_revgan": (REVGAN_PATCH, (1, 1)),
               "separable_vnet_multiscale": (REVGAN_PATCH, (1, 1)),
               "hx4": (HX4_PATCH, (2, 2)), "cleargrasp": (CLEARGRASP_SIZE, (6, 4))}
# bf16 steps of each: a warm-up and the timed step (step ms, peak memory,
# exchanges); the sharded fp32 step times its halo exchanges and
# collectives (each between device synchronisations).
SPATIAL_ZOO_BF16_STEPS = 2
SPATIAL_CHILD_TIMEOUT = 780


def spatial_zoo_conf(name, out_dir, mixed_precision):
    """Family `name`'s config at the widths of its own phase."""
    from ganslate_tpu_torch.utils.builders import build_conf
    if name == "revgan":
        conf = revgan_conf(out_dir, mixed_precision=mixed_precision)
    elif name == "pix2pix":
        conf = pix2pix_conf(out_dir, out_dir, mixed_precision=mixed_precision)
    elif name == "cut":
        conf = cut_conf(out_dir, mixed_precision=mixed_precision)
    elif name in ("sa_vnet_revgan", "separable_vnet_multiscale"):
        from ganslate_tpu_torch.utils import communication
        yaml_name = "revgan.yaml" if name == "sa_vnet_revgan" else "cyclegan.yaml"
        # Each process its own copy of the YAML: the children run at once.
        yaml_dir = out_dir / f"yaml_rank{communication.get_rank()}"
        yaml_dir.mkdir(parents=True, exist_ok=True)
        conf = zoo_conf(zoo_yaml(yaml_dir, yaml_name), mixed_precision)
    else:
        project, run = ((HX4_PROJECT, HX4_BALANCED_RUN) if name == "hx4"
                        else (CLEARGRASP_PROJECT, CLEARGRASP_BALANCED_RUN))
        conf = build_conf(project_args(project, "cyclegan_balanced.yaml", run, out_dir,
                                       mixed_precision))
    conf.train.output_dir = str(out_dir)
    return conf


def spatial_zoo_family(name, out_dir, sharded):
    """(d) for family `name` in a child: its bf16 steps (step ms, peak
    memory, exchanges by network and by declared site, norm launches) and
    its fp32 step 1 (losses, gradients; sharded, its halo and collective
    seconds), from the seed's weights; in one process, also the fp32 step
    under one-ulp noise on every norm output (the control)."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    from ganslate_tpu_torch.parallel import spatial
    from ganslate_tpu_torch.utils.builders import build_gan
    shape, channels = SPATIAL_ZOO[name]
    rng = np.random.default_rng(SEED + 120)
    batch = {k: rng.uniform(-1, 1, (1, *shape, c)).astype(np.float32)
             for k, c in zip(("A", "B"), channels)}

    def model_of(mixed_precision):
        conf = spatial_zoo_conf(name, out_dir / name, mixed_precision)
        if sharded:
            conf.train.spatial_mesh = SPATIAL_RANKS
        model = build_gan(conf)
        model.setup(batch)
        return model

    out = {"launches": []}
    model = model_of(True)
    if name == "sa_vnet_revgan":
        out["attention_energy_bytes"] = attention_energy_bytes(
            model.conf, shape, SPATIAL_RANKS if sharded else 1)
    for i in range(SPATIAL_ZOO_BF16_STEPS):
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        spatial.reset_counts()
        inorm.reset_launches()
        t0 = time.perf_counter()
        model.set_input(batch)
        model.optimize_parameters(sync=True)
        ms = (time.perf_counter() - t0) * 1e3
        out["launches"].append(dict(inorm.LAUNCHES))
        if i == 1:
            out.update(step_ms=ms, peak_memory_bytes=torch.cuda.max_memory_allocated(),
                       counts=dict(spatial.COUNTS), sites=dict(spatial.SITES),
                       by_network={k or "losses": v for k, v in spatial.BY_NETWORK.items()},
                       bf16_losses={k: float(v) for k, v in model.losses.items()},
                       sharded=model._sharded)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    def fp32_step(norms):
        model = model_of(False)
        spatial.reset_counts()
        spatial.TIMED = sharded
        try:
            with norms():
                model.set_input(batch)
                model.optimize_parameters(sync=True)
        finally:
            spatial.TIMED = False
        run = {"losses": {k: float(v) for k, v in model.losses.items()},
               "seconds": dict(spatial.SECONDS),
               "grads": {f"{net_name}.{k}": p.grad.detach().float().cpu().clone()
                         for net_name, net in model.networks.items()
                         for k, p in net.named_parameters() if p.grad is not None}}
        del model
        gc.collect()
        torch.cuda.empty_cache()
        return run

    out["fp32"] = fp32_step(contextlib.nullcontext)
    if not sharded:
        out["fp32_control"] = fp32_step(norm_ulp_noise)
    return out


def spatial_child(out_dir):
    """(a)'s second half, (b), (c) and (d) in a child: on 2 ranks, sharded;
    in one process, the references. The `train` command comes last: it
    tears down the process group."""
    import torch
    from ganslate_tpu_torch.utils import communication
    _BRATS_ROOT[:] = [Path(os.environ["GANSLATE_SPATIAL_BRATS"])]
    communication.init_distributed(cuda=True)
    sharded = communication.get_world_size() > 1
    out = {"backend": communication.backend(), "world": communication.get_world_size()}
    if sharded:
        communication.init_groups(SPATIAL_RANKS)
        out["norm"] = spatial_norm_check()
    t0 = time.perf_counter()
    out["fp32"] = spatial_fp32_step(out_dir, sharded)
    out["fp32_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["infer"] = spatial_infer(out_dir, sharded)
    out["infer_seconds"] = time.perf_counter() - t0
    out["zoo"], out["zoo_seconds"] = {}, {}
    for name in SPATIAL_ZOO:
        t0 = time.perf_counter()
        out["zoo"][name] = spatial_zoo_family(name, out_dir / "zoo", sharded)
        out["zoo_seconds"][name] = time.perf_counter() - t0
    out["train"] = spatial_train_cli(out_dir, sharded)
    out["peak_memory_bytes_child"] = torch.cuda.max_memory_allocated()
    return out


def attention_energy_bytes(conf, shape, ranks):
    """The fp32 (S_local x S) energies of each self-attention block of the
    SA V-Net and SA PatchGAN3D of `conf` at spatial `shape` on `ranks`
    spatial ranks, in bytes a rank (batch 1): the one activation of the
    path that sharding does not divide by the ranks (computed from the
    levels' extents, not measured)."""
    gen = conf.train.gan.generator
    # The V-Net gathers its levels from the first whose slab is thinner than
    # its cores' halo (`VnetGenerator._bottom`): their attention is whole.
    rows, bottom = shape[0] // ranks, len(gen.down_blocks)
    for i in range(len(gen.down_blocks)):
        if rows % 2 or rows // 2 < 2:
            bottom = i
            break
        rows //= 2
    out = {}
    for i, on in enumerate(gen.enable_attention_block):
        if on:
            s = math.prod(d // 2 ** (i + 1) for d in shape)
            out[f"G.attns_{i}"] = 4 * (s // ranks if i < bottom else s) * s
    extents = list(shape)
    d_conf = conf.train.gan.discriminator
    for k, stride in ((4, 3),) + ((4, 2),) * (d_conf.n_layers - 1):
        extents = [(e + 2 - k) // stride + 1 for e in extents]
    s = math.prod(extents)
    # attn1 runs on slabs where the stem's stride divides the slab, else replicated.
    local = s // ranks if (shape[0] // ranks) % 3 == 0 else s
    out["D.attn1"] = 4 * local * s
    extents = [e - 1 for e in extents]
    s = math.prod(extents)
    out["D.attn2"] = 4 * s * s
    return out


def spatial_zoo_check(ranks, ref, caveat):
    """(d): each family's sharded fp32 step 1 against one process (losses
    1e-4 relative; each gradient tensor within `TRAIN_FP32_GRAD_MAX`
    relative L2, or 3 times the one-process control's gap where that is
    larger; a gradient that cancels, below `CANCELLING_GRAD_MAX` of its
    network's gradient norm, within that share of the norm), the peak
    memory a rank against one process (RevGAN's at most
    `SPATIAL_MEMORY_MAX`), the exchanges by network and by site."""
    import torch
    for name in SPATIAL_ZOO:
        got, want = ranks[0]["zoo"][name], ref["zoo"][name]
        fp32, ref32, control = got["fp32"], want["fp32"], want["fp32_control"]
        check(fp32["grads"].keys() == ref32["grads"].keys() == control["grads"].keys(),
              f"{name}: the sharded step's gradients are not the 1-process step's tensors")
        net_norm = {}
        for k, g in ref32["grads"].items():
            net = k.split(".")[0]
            net_norm[net] = net_norm.get(net, 0.0) + float(g.float().square().sum())
        over, tols_raised, cancelling, worst = [], 0, 0, (0.0, None)
        for k, g in ref32["grads"].items():
            scale = math.sqrt(net_norm[k.split(".")[0]])
            if float(g.norm()) < CANCELLING_GRAD_MAX * scale:
                cancelling += 1
                if float((fp32["grads"][k] - g).norm()) > CANCELLING_GRAD_MAX * scale:
                    over.append(k)
                continue
            tol = max(TRAIN_FP32_GRAD_MAX,
                      DIST_CONTROL_RATIO * rel_l2(control["grads"][k], g))
            tols_raised += tol > TRAIN_FP32_GRAD_MAX
            err = rel_l2(fp32["grads"][k], g)
            worst = max(worst, (err / tol, k))
            if err > tol:
                over.append(k)
        loss_err = {k: abs(fp32["losses"][k] - v) / max(abs(v), 1e-12)
                    for k, v in ref32["losses"].items()}
        peak = [r["zoo"][name]["peak_memory_bytes"] for r in ranks]
        replicas = all(torch.equal(r["zoo"][name]["fp32"]["grads"][k], v)
                       for r in ranks[1:] for k, v in fp32["grads"].items())
        rec = {"phase": "spatial_zoo", "family": name, "ranks": SPATIAL_RANKS,
               "shape": list(SPATIAL_ZOO[name][0]), "sharded": got["sharded"],
               "step_ms_2_ranks": got["step_ms"], "step_ms_1_process": want["step_ms"],
               "peak_memory_bytes_per_rank": peak,
               "peak_memory_bytes_1_process": want["peak_memory_bytes"],
               "peak_memory_share_per_rank": [p / want["peak_memory_bytes"] for p in peak],
               "fp32_step_halo_ms": fp32["seconds"]["halo"] * 1e3,
               "fp32_step_collective_ms": fp32["seconds"]["collective"] * 1e3,
               "exchanges_per_step": got["counts"], "exchanges_by_network": got["by_network"],
               "declared_sites": got["sites"],
               "launches_per_step_rank0": got["launches"][1],
               "launches_per_step_1_process": want["launches"][1],
               "fp32_loss_rel_err": loss_err, "fp32_grad_tensors": len(ref32["grads"]),
               "fp32_grad_err_over_tol_max": worst[0], "fp32_grad_err_over_tol_worst": worst[1],
               "fp32_grad_tols_above_bound": tols_raised, "fp32_grads_cancelling": cancelling,
               "fp32_grads_over_tol": over, "replicas_bit_equal": replicas,
               "bf16_losses_2_ranks": got["bf16_losses"],
               "bf16_losses_1_process": want["bf16_losses"], "timing_caveat": caveat}
        if name == "sa_vnet_revgan":
            rec["attention_energy_bytes_per_rank"] = got["attention_energy_bytes"]
            rec["attention_energy_bytes_1_process"] = want["attention_energy_bytes"]
        emit(rec)
        check(got["sharded"] and all(math.isfinite(v) for v in got["bf16_losses"].values()), rec)
        check(all(e <= TRAIN_FP32_LOSS_RTOL for e in loss_err.values()) and not over
              and replicas, rec)
        # Sharded norms take the split pair; a replicated section's whole
        # tensors either kernel.
        check(all(c["split"] > 0 for c in got["launches"]), rec)
        check(got["counts"]["halo"] > 0 and fp32["seconds"]["halo"] > 0, rec)
        if name == "revgan":
            check(all(p <= SPATIAL_MEMORY_MAX * want["peak_memory_bytes"] for p in peak), rec)


def spatial_phase(root, bandwidth):
    """Phase 17; returns the norm launches of its 2-rank children's main
    paths (the `train` command and the sharded requests)."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    t0 = time.perf_counter()
    stats = spatial_stats_check(bandwidth)
    os.environ["GANSLATE_SPATIAL_BRATS"] = str(_BRATS_ROOT[0])
    with experiment_workdir(root) as work:
        # The 1-process references run beside the 2 ranks: their numbers are
        # their own, and all three processes' times share the card and host.
        ((ref,), ref_seconds), (ranks, seconds) = dist_launch_together(
            [("spatial", root / "spatial_1", None),
             ("spatial", root / "spatial_2", SPATIAL_RANKS)], work, SPATIAL_CHILD_TIMEOUT)
    # One card: the ranks share it over gloo (NCCL refuses two ranks on one
    # device); with a card a rank, NCCL.
    backend = "nccl" if torch.cuda.device_count() >= SPATIAL_RANKS else "gloo"
    caveat = ("2 ranks share one card and exchange through host memory (gloo), and the 1-process "
              "references run beside them: a check of the arithmetic and of the memory per "
              "rank, not a scaling figure" if backend == "gloo" else
              "a card a rank (NCCL), the 1-process references beside them")
    check([r["backend"] for r in ranks] == [backend] * SPATIAL_RANKS and ref["world"] == 1,
          [r["backend"] for r in ranks])

    # (a), second half.
    for dtype, rec in ranks[0]["norm"].items():
        rec = {"phase": "spatial_sharded_norm", "dtype": dtype, "ranks": SPATIAL_RANKS,
               "whole": [1, SPATIAL_SLAB[1] * SPATIAL_RANKS, *SPATIAL_SLAB[2:]],
               **rec, "rank1": ranks[1]["norm"][dtype]}
        emit(rec)
        check(all(r["norm"][dtype]["over_tol"] == 0 and r["norm"][dtype]["mean_rel_err"]
                  <= STAT_RTOL and r["norm"][dtype]["rstd_rel_err"] <= STAT_RTOL
                  for r in ranks), rec)

    # (b), fp32 step 1 against one process, with its one-ulp control.
    got, want = ranks[0]["fp32"]["kernel"], ref["fp32"]["kernel"]
    plain, noisy = ref["fp32"]["plain"], ref["fp32"]["noisy"]
    control_loss = max(abs(noisy["losses"][k] - v) / abs(v) for k, v in plain["losses"].items())
    loss_tol = max(DIST_LOSS_RTOL, DIST_CONTROL_RATIO * control_loss)
    loss_err = {k: abs(got["losses"][k] - v) / abs(v) for k, v in want["losses"].items()}
    control = {k: rel_l2(noisy["grads"][k], g) for k, g in plain["grads"].items()}
    grad_tol = {k: max(TRAIN_FP32_GRAD_MAX, DIST_CONTROL_RATIO * c) for k, c in control.items()}
    check(got["grads"].keys() == want["grads"].keys() == control.keys(),
          "the sharded step's gradients are not the 1-process step's tensors")
    grad_err = {k: rel_l2(got["grads"][k], g) for k, g in want["grads"].items()}
    ratio = {k: e / grad_tol[k] for k, e in grad_err.items()}
    worst = max(grad_err, key=grad_err.get)
    closest = max(ratio, key=ratio.get)
    replicas = all(torch.equal(r["fp32"]["kernel"]["grads"][k], v)
                   for r in ranks[1:] for k, v in got["grads"].items())
    rec = {"phase": "spatial_fp32_step", "ranks": SPATIAL_RANKS, "dtype": "float32",
           "losses": got["losses"], "losses_1_process": want["losses"],
           "loss_rel_err": loss_err, "loss_tol": loss_tol, "loss_control_rel_err": control_loss,
           "grad_rel_l2_max": grad_err[worst], "grad_rel_l2_worst": worst,
           "grad_tol_of_worst": grad_tol[worst],
           "grad_rel_l2_median": statistics.median(grad_err.values()),
           "grad_err_over_tol_max": ratio[closest], "grad_err_over_tol_worst": closest,
           "grad_control_rel_l2_max": max(control.values()),
           "grad_tols_above_bound": sum(t > TRAIN_FP32_GRAD_MAX for t in grad_tol.values()),
           "grad_tensors": len(grad_tol), "replicas_bit_equal": replicas,
           "seconds": {"1_process": ref["fp32_seconds"], "2_ranks": ranks[0]["fp32_seconds"]}}
    emit(rec)
    check(all(e <= loss_tol for e in loss_err.values()), rec)
    check(ratio[closest] <= 1 and replicas, rec)

    # (b), the `train` command.
    n_iters = SPATIAL_RUN[0] + SPATIAL_RUN[1]
    train, train_ref = ranks[0]["train"], ref["train"]
    norms_per_iter = sum(BRATS_CYCLEGAN_LAUNCHES.values())
    untimed = list(range(SPATIAL_RUN[0] + 1, n_iters))
    peak = [r["train"]["peak_memory_bytes"] for r in ranks]
    g_gathers = {i: {k: v for k, v in g.items() if k.startswith("G")}
                 for i, g in train["gathers"].items()}
    seconds_timed = train["seconds"][n_iters]
    rec = {"phase": "spatial_train", "yaml": str((BRATS_PROJECT / "experiments" / "cyclegan.yaml")
                                                .relative_to(HERE)),
           "entry": f"torchrun --standalone --nproc_per_node {SPATIAL_RANKS} -> "
                    f"interface.main(['train', ..., 'train.spatial_mesh={SPATIAL_RANKS}'])",
           "layout_data_x_spatial": train["layout"], "iterations": n_iters,
           "patch": list(REVGAN_PATCH), "slab": [REVGAN_PATCH[0] // SPATIAL_RANKS,
                                                 *REVGAN_PATCH[1:]],
           "cuts": {"run": SPATIAL_RUN, "left_out": SPATIAL_LEFT_OUT},
           "losses": train["losses"], "losses_1_process": train_ref["losses"],
           "step_ms_2_ranks": train["step_ms"], "step_ms_1_process": train_ref["step_ms"],
           "step_ms_untimed_mean": {"2_ranks": statistics.mean(
               train["step_ms"][i] for i in untimed), "1_process": statistics.mean(
               train_ref["step_ms"][i] for i in untimed)},
           "timed_iteration": n_iters, "timed_iteration_ms": train["step_ms"][n_iters],
           "halo_ms_per_step": seconds_timed["halo"] * 1e3,
           "collective_ms_per_step": seconds_timed["collective"] * 1e3,
           "exchanges_per_step": train["exchanges"][n_iters],
           "gathers_by_network": train["gathers"][n_iters],
           "generator_gathers": g_gathers,
           "peak_memory_bytes_per_rank": peak,
           "peak_memory_bytes_1_process": train_ref["peak_memory_bytes"],
           "peak_memory_share_per_rank": [p / train_ref["peak_memory_bytes"] for p in peak],
           "memory_share_max": SPATIAL_MEMORY_MAX,
           "launches_per_rank": [r["train"]["launches"] for r in ranks],
           "launches_1_process": train_ref["launches"], "timing_caveat": caveat,
           "run_seconds": {"1_process": train_ref["seconds_run"],
                           "2_ranks": train["seconds_run"]}}
    emit(rec)
    check(sorted(train["losses"]) == list(range(1, n_iters + 1))
          and all(math.isfinite(v) for s in train["losses"].values() for v in s.values()), rec)
    check(all(r["train"]["losses"] == train["losses"] for r in ranks), "the ranks' losses differ")
    check(train["layout"] == (1, SPATIAL_RANKS), rec["layout_data_x_spatial"])
    check(all(v == 0 for g in g_gathers.values() for v in g.values())
          and all(g for g in g_gathers.values()), f"gathers on a generator: {g_gathers}")
    check(all(p <= SPATIAL_MEMORY_MAX * train_ref["peak_memory_bytes"] for p in peak), rec)
    check(train_ref["launches"]["split"] + train_ref["launches"]["onepass"]
          == n_iters * norms_per_iter, rec["launches_1_process"])
    check(all(r["train"]["launches"] == {"onepass": 0, "split": n_iters * norms_per_iter}
              for r in ranks), rec["launches_per_rank"])
    check(seconds_timed["halo"] > 0 and train["exchanges"][n_iters]["halo"] > 0, rec)

    # (c), inference.
    want = {dtype: ref["infer"][f"direct_{dtype}"]["y"] for dtype in ("bfloat16", "float32")}
    for key in ("gspmd_bfloat16", "gspmd_float32", "halo_bfloat16"):
        method, dtype = key.split("_")
        ys = [r["infer"][key]["y"] for r in ranks]
        y, ref_y = ys[0], want[dtype]
        err = (y.float() - ref_y.float()).abs()
        rec = {"phase": f"spatial_infer_{method}", "dtype": dtype, "ranks": SPATIAL_RANKS,
               "volume": list(SPATIAL_VOLUME), "entry": "Inferer.infer (infer.spatial_sharding)",
               "max_abs_err_vs_1_process": float(err.max()),
               "mean_abs_err_vs_1_process": float(err.mean()),
               "max_abs_out": float(ref_y.float().abs().max()),
               "ranks_equal": all(torch.equal(t, y) for t in ys[1:]),
               "seconds_2_ranks": ranks[0]["infer"][key]["seconds"],
               "seconds_1_process": ref["infer"][f"direct_{dtype}"]["seconds"],
               "exchanges_rank0": ranks[0]["infer"][key]["exchanges"],
               "launches_rank0": ranks[0]["infer"][key]["launches"],
               "launches_1_process": ref["infer"][f"direct_{dtype}"]["launches"],
               "timing_caveat": caveat}
        sw_output_check(rec, y, SPATIAL_VOLUME[:-1] + (1,))
        check(rec["ranks_equal"], rec)
        if method == "halo":
            boundary = SPATIAL_VOLUME[1] // SPATIAL_RANKS
            near = err[:, boundary - SPATIAL_HALO:boundary + SPATIAL_HALO]
            away = torch.cat([err[:, :boundary - SPATIAL_HALO],
                              err[:, boundary + SPATIAL_HALO:]], 1)
            rec.update(halo=SPATIAL_HALO, gap_near_boundary={"max": float(near.max()),
                                                             "mean": float(near.mean())},
                       gap_away={"max": float(away.max()), "mean": float(away.mean())},
                       note="per-shard norm statistics: reported, not bounded")
            emit(rec)
            continue
        check(rec["launches_rank0"]["onepass"] == 0 and rec["launches_rank0"]["split"] > 0,
              rec)
        if dtype == "float32":
            rec["tol_max"] = DIST_SW_FP32_REL * rec["max_abs_out"]
            emit(rec)
            check(rec["max_abs_err_vs_1_process"] <= rec["tol_max"], rec)
        else:
            rec.update(tol_max=SW_BF16_MAX, tol_mean=SW_BF16_MEAN)
            emit(rec)
            check(rec["max_abs_err_vs_1_process"] <= SW_BF16_MAX
                  and rec["mean_abs_err_vs_1_process"] <= SW_BF16_MEAN, rec)

    spatial_zoo_check(ranks, ref, caveat)

    totals = {k: 0 for k in inorm.LAUNCHES}
    for r in ranks:
        zoo_launches = [c for fam in r["zoo"].values() for c in fam["launches"]]
        for counts in [r["train"]["launches"]] + [v["launches"] for v in r["infer"].values()] \
                + zoo_launches:
            for k, v in counts.items():
                totals[k] += v
    emit({"phase": "spatial_summary", "backend": backend, "seconds": time.perf_counter() - t0,
          "child_seconds": {"1_process": ref_seconds, "2_ranks": seconds},
          "zoo_seconds": {"1_process": ref["zoo_seconds"], "2_ranks": ranks[0]["zoo_seconds"]},
          "stats_m2_ms": {r["dtype"]: r["ms"] for r in stats},
          "peak_memory_bytes_child": {"1_process": ref["peak_memory_bytes_child"],
                                      "2_ranks": [r["peak_memory_bytes_child"] for r in ranks]},
          "launches": totals})
    return totals


def main() -> int:
    # The user's switch for OpenCV's EXR codec, read when cv2 is imported.
    os.environ["OPENCV_IO_ENABLE_OPENEXR"] = "1"
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    emit(smi)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    bandwidth, flops, bf16_peak = card_peaks(smi)
    seconds = {}
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        seconds[name] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()

    from ganslate_tpu_torch.ops import build
    from ganslate_tpu_torch.ops import instance_norm as inorm
    t0 = time.perf_counter()
    lib_path = build.build(inorm.SOURCE)
    inorm.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib_path.name})
    log = lib_path.with_suffix(".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            emit("ptxas: " + line.strip())

    phase_done("build")
    summary = check_kernels(bandwidth, flops)
    phase_done("kernels")
    sweep_onepass_geometry(bandwidth)
    sweep_split_geometry(bandwidth)
    split_parts(bandwidth, summary)
    onepass_at_split_slab(bandwidth)
    phase_done("geometry_sweeps")

    with tempfile.TemporaryDirectory() as tmp:
        inferer, x16, totals = serve_slice(Path(tmp))
        profile_forward(inferer, x16)
        del inferer, x16
        torch.cuda.empty_cache()
        check_fp32_slice(Path(tmp))
    torch.cuda.empty_cache()
    phase_done("slice")

    with tempfile.TemporaryDirectory() as tmp:
        train_totals = train_phase(Path(tmp))
    torch.cuda.empty_cache()
    phase_done("train")

    with tempfile.TemporaryDirectory() as tmp:
        trainer_totals = trainer_phase(Path(tmp))
    torch.cuda.empty_cache()
    phase_done("trainer")

    with tempfile.TemporaryDirectory() as tmp:
        sw_totals = sliding_window_phase(Path(tmp), bf16_peak)
    phase_done("sliding_window")

    with contextlib.ExitStack() as stack:
        brats = Path(stack.enter_context(tempfile.TemporaryDirectory()))
        write_brats_root(brats)
        phase_done("brats_data")

        native_phase(smi)
        phase_done("native")

        with tempfile.TemporaryDirectory() as tmp:
            revgan_totals = revgan_phase(Path(tmp))
        torch.cuda.empty_cache()
        phase_done("revgan")

        with tempfile.TemporaryDirectory() as tmp:
            pix2pix_totals = pix2pix_phase(Path(tmp))
        torch.cuda.empty_cache()
        phase_done("pix2pix")

        with tempfile.TemporaryDirectory() as tmp:
            cut_totals, cut2d_totals = cut_phase(Path(tmp))
        torch.cuda.empty_cache()
        phase_done("cut")

        with tempfile.TemporaryDirectory() as tmp:
            brats_cyclegan_totals = brats_cyclegan_phase(Path(tmp))
        torch.cuda.empty_cache()
        phase_done("brats_cyclegan")

        with tempfile.TemporaryDirectory() as tmp:
            zoo_totals = zoo_phase(Path(tmp), bf16_peak)
        torch.cuda.empty_cache()
        phase_done("zoo")

        with tempfile.TemporaryDirectory() as tmp:
            spatial_totals = spatial_phase(Path(tmp), bandwidth)
        torch.cuda.empty_cache()
        phase_done("spatial")

    with tempfile.TemporaryDirectory() as tmp:
        hx4_totals = hx4_project_phase(Path(tmp))
    torch.cuda.empty_cache()
    phase_done("hx4")

    with tempfile.TemporaryDirectory() as tmp:
        cleargrasp_totals = cleargrasp_project_phase(Path(tmp))
    torch.cuda.empty_cache()
    phase_done("cleargrasp")

    with tempfile.TemporaryDirectory() as tmp:
        fid_totals = fid_phase(Path(tmp), flops)
    torch.cuda.empty_cache()
    phase_done("fid")

    with tempfile.TemporaryDirectory() as tmp:
        dist_totals = distributed_phase(Path(tmp))
    phase_done("distributed")
    emit({"phase": "phase_seconds", **seconds})
    # Every RevGAN slab takes the split form.
    check(revgan_totals["split"] > 0 and revgan_totals["onepass"] == 0,
          f"the revgan phase's launches: {revgan_totals}")

    kernels = []
    for name, replaces in (("onepass", "ganslate_tpu/ops/instance_norm.py:66"),
                           ("split", "ganslate_tpu/ops/instance_norm.py:105")):
        s = summary[name]
        by_path = {"slice": totals[name], "train": train_totals[name],
                   "trainer": trainer_totals[name], "sliding_window": sw_totals[name],
                   "revgan": revgan_totals[name], "pix2pix": pix2pix_totals[name],
                   "cut": cut_totals[name], "cut2d": cut2d_totals[name],
                   "brats_cyclegan": brats_cyclegan_totals[name], "hx4": hx4_totals[name],
                   "cleargrasp": cleargrasp_totals[name], "fid": fid_totals[name],
                   "zoo": zoo_totals[name], "distributed": dist_totals[name],
                   "spatial": spatial_totals[name]}
        check(totals[name] > 0, f"the served requests never launched {name}")
        check(train_totals[name] > 0, f"the train steps never launched {name}")
        check(trainer_totals[name] > 0, f"the trainer phase never launched {name}")
        check(sw_totals[name] > 0, f"the sliding-window requests never launched {name}")
        check(pix2pix_totals[name] > 0, f"the pix2pix phase never launched {name}")
        check(cut_totals[name] > 0, f"the cut phase never launched {name}")
        check(cut2d_totals[name] > 0, f"the 2D CUT steps never launched {name}")
        check(brats_cyclegan_totals[name] > 0,
              f"the brats_cyclegan phase never launched {name}")
        check(hx4_totals[name] > 0, f"the hx4 phase never launched {name}")
        check(cleargrasp_totals[name] > 0, f"the cleargrasp phase never launched {name}")
        check(fid_totals[name] > 0, f"the fid phase never launched {name}")
        check(zoo_totals[name] > 0, f"the zoo phase never launched {name}")
        check(dist_totals[name] > 0, f"the distributed phase never launched {name}")
        # The sharded slabs' norms take the split pair (the 'halo' requests'
        # per-shard norms either kernel).
        check(spatial_totals["split"] > 0, f"the spatial phase's launches: {spatial_totals}")
        totals[name] += sum(by_path[path] for path in by_path if path != "slice")
        kernels.append({"name": f"inorm_{name}", "route": "cuda",
                        "source": "ganslate_tpu_torch/csrc/instance_norm.cu",
                        "replaces": replaces, "launches": totals[name],
                        "launches_by_path": by_path, **s})
    emit(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--distributed-child"]:
        sys.exit(dist_child(sys.argv[2], Path(sys.argv[3])))
    sys.exit(main())
